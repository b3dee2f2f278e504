"""Whole-chunk G+D training in one kernel launch — the port of
``generative_models_tpu/ops/pallas_train.py`` for nsgan, mmgan, lsgan,
wgan, fgan, ragan, fishergan, wgangp, dragan, cgan, infogan and began
(``_make_kernel`` with ``_make_variant_hooks``, ``_gp_backward``, the
cgan label lanes, infogan's Q head, began's autoencoder critic and k_t
law, and ``_fused_chunk_call``, ``build_fused_many_steps``,
``fused_step_supported``, ``resolve_fused_step``). The single-model family's chunk kernels (vae,
birvae) are in ``ops/cuda_train_vae.py``; the policy here covers them and
:func:`build_fused_many_steps` hands them on.

:func:`gan_chunk` runs `steps` outer steps — ``d_steps`` critic updates
on fresh batches, then one G update against the post-update critic, the
optimizer (Adam or RMSprop) for D and then for G, wgan's clip of every
critic tensor after each critic update, fishergan's multiplier ``lam``
descending after each critic update, the gradient penalty's double
backward in each critic update (wgangp, dragan), began's k_t law after
each G update, one metrics row of 8 lanes a step — on pre-gathered
streams, and updates the 8 state tensors' planes in place (Adam:
parameters, ``mu``, ``nu``; RMSprop: parameters and ``nu``). With
``ema_decay > 0`` it also steps G's EMA plane (``state["g_ema"]``) after
every G update, ``ema <- d ema + (1 - d) p`` (``pallas_train.py:755-762``);
with ``dtype="bfloat16"`` every product takes bf16-rounded operands and
sums in float32 (``_make_dots``, ``:192-211``), in the kernel (libraries
built with ``-DGM_BF16=1``) and in the plain version (:func:`mm`).

The critic's head ``W2d [Hd, L]`` is one logit wide (L = 1) but for two
heads: infogan's holds the D head and the Q head side by side (L = 1 +
cat + 2 cont: the logit, the categorical logits, the means, the
log-variances; its z rows are G's code rows z ⊕ onehot(cat) ⊕ cont, from
which the MI targets are read), and began's critic is an autoencoder
(``W1d [X, Hd]``, ``W2d [Hd, X]``, a sigmoid on the reconstruction).
began's |.| is differentiated through ``sign`` (0 at 0) here and in the
kernel, as the TPU kernel does (``pallas_train.py:366-371, 439``); its
general step takes JAX autodiff's rule (``losses/began.py``), so the two
paths part only at an exact tie of a pixel and its reconstruction.

The penalty variants take a fourth stream, ``xtra``, as the TPU kernel
does: wgangp's per-row eps ``[rows, 1]`` (the kernel forms x_hat = eps x
+ (1 - eps) fake itself), dragan's perturbed real rows x_hat ``[rows,
X]`` (formed on the device before the launch). cgan's rows carry their
one-hot label: the x rows are ``X + n_cls`` wide (D's input width), the
z rows ``Z + n_cls`` (G's); G's output stays X wide and the kernel
appends the label to each fake row, so no selection matrix is needed.
On a CUDA tensor it launches the hand-written Hopper kernel
``csrc/gan_chunk.cu`` (one cooperative launch per call; one library per
critic hook, built at its first use) or raises; on a CPU tensor it runs
:func:`gan_chunk_plain`, the same hand-derived math in torch matmuls,
which is also the kernel's oracle on the card. ``launches`` counts the
kernel's launches.

The metrics lanes are the TPU kernel's: 0 ``d_loss`` (with the penalty
added), 1 and 2 the real and fake logit means (fishergan: ``ipm``,
``omega``; began: the energies L(x) and L(G(z)) of the critic; infogan:
lane 1 the critic's MI term, lane 2 zero), 3 ``g_loss``, 4 and 5 the
penalty ``gp`` and the mean input gradient norm (wgangp, dragan), 6
fishergan's ``constraint`` (began: the convergence measure M; infogan:
G's MI term), 7 the carried scalar after the step (fishergan's ``lam``
after its last critic update, began's k_t after the step's G update;
zero elsewhere).

The state planes are at their true widths (no 128-lane padding), so the
TPU kernel's padded-lane hazards (``pallas_train.py:92-102``) do not
arise. ``launches`` counts every launch of the kernel; ``ema_launches``
and ``bf16_launches`` those of the EMA and the bf16 kernels among them.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Dict, List, Optional, Tuple

import torch

from generative_models_tpu_torch.models.nets import infogan_head, onehot
from generative_models_tpu_torch.ops.cuda_mlp import round_bf16
from generative_models_tpu_torch.ops.penalty import aux_lanes
from generative_models_tpu_torch.train.optim import RMS_DECAY, RMS_EPS
from generative_models_tpu_torch.train.step import (
    batches_per_step,
    gather_streams,
    pick_sub,
    noise_lanes,
    stream_bytes_per_step,
)
from generative_models_tpu_torch.utils import spans

SOURCE = "generative_models_tpu_torch/csrc/gan_chunk.cu"
# variant -> the critic hook its kernel is compiled for (GM_HOOK in the
# source: one library a hook, an Adam and an RMSprop kernel in each)
# (gpw: wgan's critic with the penalty; gpb: bce's with the penalty;
# cond: bce's on label-carrying rows; info: bce's with the Q head; be:
# the autoencoder)
HOOKS: Dict[str, str] = {
    "nsgan": "bce", "mmgan": "bce", "lsgan": "ls", "wgan": "w", "fgan": "f",
    "ragan": "ra", "fishergan": "fi", "wgangp": "gpw", "dragan": "gpb",
    "cgan": "cond", "infogan": "info", "began": "be"}
HOOK_IDS = {"bce": 0, "ls": 1, "w": 2, "f": 3, "ra": 4, "fi": 5, "gpw": 6,
            "gpb": 7, "cond": 8, "info": 9, "be": 10}
FGAN_DIV_IDS = {"total_variation": 0, "kl": 1, "reverse_kl": 2, "pearson": 3,
                "squared_hellinger": 4, "jensen_shannon": 5, "gan": 6}
GAN_VARIANTS = tuple(HOOKS)
FUSED_VARIANTS = GAN_VARIANTS + ("vae", "birvae")
METRIC_LANES = 8
# infogan: the widest head the kernel keeps in one warp's lanes (4 a lane)
INFO_MAX_LANES = 128
# variant -> its carried scalar (the vstate key) that rides in and out
# through lane 7
CARRIED = {"fishergan": "lam", "began": "k"}
# resident blocks per SM of the cooperative grid (at most what fits: the
# chunk and phase kernels take 255 registers a thread, so one)
BLOCKS_PER_SM = 1
DTYPES = ("float32", "bfloat16")

launches = 0
ema_launches = 0
bf16_launches = 0


@dataclasses.dataclass(frozen=True)
class ChunkHyper:
    """The chunk's hyperparameters: the optimizer's, the critic's
    activation slope, and which critic and G losses it runs."""

    g_lr: float
    d_lr: float
    b1: float
    b2: float
    eps: float
    slope: float
    variant: str = "nsgan"
    optimizer: str = "adam"        # "adam" | "rmsprop"
    clip: float = 0.0              # wgan: |critic tensors| <= clip; 0 = off
    fgan_div: str = "jensen_shannon"
    fgan_ns: bool = False          # fgan: the non-saturating G loss
    fisher_rho: float = 0.0
    gp_lam: float = 0.0            # wgangp, dragan: the penalty's weight
    n_cls: int = 0                 # cgan: the label lanes of each row
    info_cat: int = 0              # infogan: the codes' lanes and weight
    info_cont: int = 0
    info_lam: float = 0.0
    began_gamma: float = 0.0       # began: the k_t law
    began_lambda_k: float = 0.0
    ema_decay: float = 0.0         # > 0: G's EMA plane after each G update
    dtype: str = "float32"         # "bfloat16": bf16 operands, f32 sums

    def __post_init__(self):
        if self.variant not in HOOKS:
            raise ValueError(f"gan_chunk covers {GAN_VARIANTS}, not "
                             f"{self.variant!r}")
        if self.optimizer not in ("adam", "rmsprop"):
            raise ValueError(f"unknown optimizer {self.optimizer!r}")
        if self.fgan_div not in FGAN_DIV_IDS:
            raise ValueError(f"unknown f-divergence {self.fgan_div!r}")
        if (self.variant == "cgan") != (self.n_cls > 0):
            raise ValueError("n_cls > 0 is cgan's, and cgan's only")
        if (self.variant == "infogan") != (self.info_cat > 0):
            raise ValueError("info_cat > 0 is infogan's, and infogan's only")
        if self.dtype not in DTYPES:
            raise ValueError(f"dtype must be one of {DTYPES}, got "
                             f"{self.dtype!r}")
        if not 0.0 <= self.ema_decay < 1.0:
            raise ValueError(f"ema_decay must be in [0, 1), got "
                             f"{self.ema_decay}")

    @classmethod
    def from_config(cls, cfg) -> "ChunkHyper":
        v = cfg.variant
        return cls(cfg.g_lr, cfg.d_lr, cfg.adam_b1, cfg.adam_b2,
                   cfg.adam_eps, cfg.leaky_slope, v, cfg.optimizer,
                   cfg.wgan_clip if v == "wgan" else 0.0,
                   cfg.fgan_divergence,
                   v == "fgan" and cfg.fgan_g_loss == "nonsaturating",
                   cfg.fisher_rho if v == "fishergan" else 0.0,
                   cfg.gp_lambda if v in ("wgangp", "dragan") else 0.0,
                   cfg.num_classes if v == "cgan" else 0,
                   cfg.info_cat_dim if v == "infogan" else 0,
                   cfg.info_cont_dim if v == "infogan" else 0,
                   cfg.info_lambda if v == "infogan" else 0.0,
                   cfg.began_gamma if v == "began" else 0.0,
                   cfg.began_lambda_k if v == "began" else 0.0,
                   cfg.ema_decay, compute_dtype(cfg))

    @property
    def adam(self) -> bool:
        return self.optimizer == "adam"

    @property
    def bf16(self) -> bool:
        return self.dtype == "bfloat16"

    def head_width(self, x: int) -> int:
        """The critic head's lanes L: infogan 1 + cat + 2 cont, began the
        image width `x`, else 1."""
        if self.variant == "infogan":
            return 1 + self.info_cat + 2 * self.info_cont
        return x if self.variant == "began" else 1


def compute_dtype(cfg) -> str:
    """The chunk kernels' product dtype for ``cfg.dtype``: "bfloat16",
    or "float32" (for "auto" too, as the Trainer resolves it)."""
    return "bfloat16" if cfg.dtype == "bfloat16" else "float32"


def mm(a, b, bf16: bool):
    """a @ b, with both operands rounded to bfloat16 when `bf16` (the
    reference's ``_make_dots`` cast, ``pallas_train.py:192-211``); the sum
    runs in the operands' dtype, float32, or float64 as the kernel's
    oracle."""
    if bf16:
        a, b = round_bf16(a), round_bf16(b)
    return a @ b


def _d_layers(d):
    """The critic as the kernel's two layers: infogan's trunk and its two
    heads side by side (new tensors), else its own layers."""
    return [d["trunk"][0], infogan_head(d)] if isinstance(d, dict) else d


def _d_params(like, layers):
    """The critic in `like`'s tree from the kernel's two layers (infogan:
    the head split back into the D and Q heads)."""
    if not isinstance(like, dict):
        return layers
    w, b = layers[1]["w"], layers[1]["b"]
    return {"trunk": [layers[0]],
            "d_head": {"w": w[:, :1].contiguous(), "b": b[:1].clone()},
            "q_head": {"w": w[:, 1:].contiguous(), "b": b[1:].clone()}}


def _g_flat(g) -> List[torch.Tensor]:
    return [l[k] for l in g for k in ("w", "b")]


def state_planes(state) -> Tuple[List[torch.Tensor],
                                 Optional[List[torch.Tensor]],
                                 List[torch.Tensor]]:
    """(params, mu, nu): 8 tensors each, in the kernel's order g_w1 g_b1
    g_w2 g_b2 d_w1 d_b1 d_w2 d_b2; `mu` is None for an RMSprop state.
    The state's own tensors, but infogan's critic head, which is packed
    (``models/nets.py::infogan_head``) into new ones."""
    def flat(g, d):
        return _g_flat(g) + [l[k] for l in _d_layers(d) for k in ("w", "b")]
    g_opt, d_opt = state["g_opt"], state["d_opt"]
    return (flat(state["g_params"], state["d_params"]),
            flat(g_opt["mu"], d_opt["mu"]) if "mu" in g_opt else None,
            flat(g_opt["nu"], d_opt["nu"]))


def ema_plane(state) -> Optional[List[torch.Tensor]]:
    """G's EMA plane (``state["g_ema"]``: g_w1 g_b1 g_w2 g_b2, the
    state's own tensors), None without one."""
    return _g_flat(state["g_ema"]) if "g_ema" in state else None


# ---------------------------------------------------------------------
# Plain version
# ---------------------------------------------------------------------

def _adam_(p, mu, nu, g, lr: float, t: float, hp) -> None:
    """The TPU kernel's in-place Adam (``pallas_train.py:602-619``), bias
    corrections as its ``_pow``: 1 - exp(t * log b) in float32."""
    m = hp.b1 * mu + (1.0 - hp.b1) * g
    v = hp.b2 * nu + ((1.0 - hp.b2) * g) * g
    mu.copy_(m)
    nu.copy_(v)
    tt = torch.tensor(t, dtype=torch.float32, device=p.device)
    bc1 = 1.0 - torch.exp(tt * float(math.log(hp.b1)))
    bc2 = 1.0 - torch.exp(tt * float(math.log(hp.b2)))
    p.copy_(p - (lr * (m / bc1)) / (torch.sqrt(v / bc2) + hp.eps))


def _rmsprop_(p, nu, g, lr: float) -> None:
    """The TPU kernel's in-place RMSprop, torch's rule: decay 0.99, eps
    outside the root, no bias correction."""
    v = RMS_DECAY * nu + ((1.0 - RMS_DECAY) * g) * g
    nu.copy_(v)
    p.copy_(p - (lr * g) / (torch.sqrt(v) + RMS_EPS))


def _softplus(u):
    return torch.clamp_min(u, 0.0) + torch.log1p(torch.exp(-torch.abs(u)))


_LOG2 = math.log(2.0)

# f-GAN: (g_f, g_f', f*, f*') of each divergence — the hand derivatives
# of losses/fgan.py (Nowozin Tables 2 and 6), as pallas_train.py:153-189.
_FGAN_TABLE = {
    "total_variation": (
        lambda v: 0.5 * torch.tanh(v),
        lambda v: 0.5 * (1.0 - torch.tanh(v) ** 2),
        lambda t: t,
        lambda t: torch.ones_like(t)),
    "kl": (
        lambda v: v,
        lambda v: torch.ones_like(v),
        lambda t: torch.exp(t - 1.0),
        lambda t: torch.exp(t - 1.0)),
    "reverse_kl": (
        lambda v: -torch.exp(-v),
        lambda v: torch.exp(-v),
        lambda t: -1.0 - torch.log(-t),
        lambda t: -1.0 / t),
    "pearson": (
        lambda v: v,
        lambda v: torch.ones_like(v),
        lambda t: 0.25 * t * t + t,
        lambda t: 0.5 * t + 1.0),
    "squared_hellinger": (
        lambda v: 1.0 - torch.exp(-v),
        lambda v: torch.exp(-v),
        lambda t: t / (1.0 - t),
        lambda t: 1.0 / (1.0 - t) ** 2),
    "jensen_shannon": (
        lambda v: _LOG2 - _softplus(-v),
        lambda v: torch.sigmoid(-v),
        lambda t: -torch.log(2.0 - torch.exp(t)),
        lambda t: torch.exp(t) / (2.0 - torch.exp(t))),
    "gan": (
        lambda v: -_softplus(-v),
        lambda v: torch.sigmoid(-v),
        lambda t: -torch.log(1.0 - torch.exp(t)),
        lambda t: torch.exp(t) / (1.0 - torch.exp(t))),
}


def _info_q(hp: ChunkHyper, o, zrow, inv_b: float):
    """infogan's MI part on a batch of head outputs o [B, L] with its code
    rows `zrow` (``q_grads_loss``, ``pallas_train.py:294-310``): (its
    gradient [B, L], zero on lane 0 and the log-variance lanes; the MI
    term, CE + the fixed-variance NLL). With bf16 operands the targets
    are the codes rounded to bf16, as the reference's product
    ``tq = mm(zrow, mselq)`` rounds them."""
    nc, nm = hp.info_cat, hp.info_cont
    t = zrow[:, zrow.shape[1] - nc - nm:]
    if hp.bf16:
        t = round_bf16(t)
    t_cat, t_mu = t[:, :nc], t[:, nc:]
    q, mu = o[:, 1:1 + nc], o[:, 1 + nc:1 + nc + nm]
    inv_bc = inv_b / max(nm, 1)
    logsm = torch.log_softmax(q, dim=1)
    mi = -(logsm * t_cat).sum() * inv_b + 0.5 * ((t_mu - mu) ** 2).sum() \
        * inv_bc
    g = torch.zeros_like(o)
    g[:, 1:1 + nc] = hp.info_lam * (torch.softmax(q, dim=1) - t_cat) * inv_b
    g[:, 1 + nc:1 + nc + nm] = hp.info_lam * (mu - t_mu) * inv_bc
    return g, mi


def _d_hook(hp: ChunkHyper, lr, lf, lam, inv_b: float, x=None, fake=None,
            zrow=None):
    """dL_D/dhead of the real and fake head outputs [B, L] and the
    critic's metrics (``_make_variant_hooks``' d_hook): returns (glr, glf,
    [d_loss, lane 1, lane 2], lane 6, lam after this update). `lam` is
    the carried scalar before the update (fishergan's multiplier, began's
    k_t); `x`, `fake` (began: the pixels the reconstructions are held to)
    and `zrow` (infogan: the fake rows' codes) as the hook reads them."""
    v = hp.variant
    zero = torch.zeros((), dtype=lr.dtype, device=lr.device)
    lanes12 = [lr.sum() * inv_b, lf.sum() * inv_b]
    aux6 = zero
    if v == "began":  # lr, lf: reconstruction logits [B, X]; d|.| = sign,
        # 0 at 0, the TPU kernel's (jnp.sign)
        inv_bx = inv_b / x.shape[1]
        rr, rf = torch.sigmoid(lr), torch.sigmoid(lf)
        l_real = (x - rr).abs().sum() * inv_bx
        l_fake = (fake - rf).abs().sum() * inv_bx
        glr = torch.sign(rr - x) * rr * (1.0 - rr) * inv_bx
        glf = -lam * (torch.sign(rf - fake) * rf * (1.0 - rf) * inv_bx)
        return glr, glf, [l_real - lam * l_fake, l_real, l_fake], aux6, lam
    if v == "infogan":  # bce on lane 0 plus the MI bound on Q's lanes
        gq, mi = _info_q(hp, lf, zrow, inv_b)
        glr = torch.zeros_like(lr)
        glr[:, :1] = (torch.sigmoid(lr[:, :1]) - 1.0) * inv_b
        glf = gq
        glf[:, :1] = torch.sigmoid(lf[:, :1]) * inv_b
        bce = (_softplus(-lr[:, 0]).sum() + _softplus(lf[:, 0]).sum()) * inv_b
        return glr, glf, [bce + hp.info_lam * mi, mi, zero], aux6, lam
    if v in ("nsgan", "mmgan", "dragan", "cgan"):
        glr = (torch.sigmoid(lr) - 1.0) * inv_b
        glf = torch.sigmoid(lf) * inv_b
        d_loss = (_softplus(-lr).sum() + _softplus(lf).sum()) * inv_b
    elif v == "lsgan":
        glr = (lr - 1.0) * inv_b
        glf = lf * inv_b
        d_loss = (0.5 * ((lr - 1.0) ** 2).sum() + 0.5 * (lf * lf).sum()) * inv_b
    elif v in ("wgan", "wgangp"):
        glr = torch.full_like(lr, -inv_b)
        glf = torch.full_like(lf, inv_b)
        d_loss = (lf - lr).sum() * inv_b
    elif v == "fgan":
        gf, gfp, fstar, fstarp = _FGAN_TABLE[hp.fgan_div]
        t_f = gf(lf)
        glr = -gfp(lr) * inv_b
        glf = fstarp(t_f) * gfp(lf) * inv_b
        d_loss = (-gf(lr).sum() + fstar(t_f).sum()) * inv_b
    elif v == "ragan":
        # the batch means couple every logit's gradient:
        # dL/dlr_k = (sig(dr_k) - 1)/B - mean(sig(df))/B
        # dL/dlf_k = (sig(df_k) - mean(sig(dr) - 1))/B
        dr = lr - lf.sum() * inv_b
        df = lf - lr.sum() * inv_b
        sdr, sdf = torch.sigmoid(dr), torch.sigmoid(df)
        a_ = (sdr - 1.0).sum() * inv_b
        b_ = sdf.sum() * inv_b
        glr = ((sdr - 1.0) - b_) * inv_b
        glf = (sdf - a_) * inv_b
        d_loss = (_softplus(-dr).sum() + _softplus(df).sum()) * inv_b
    else:  # fishergan: L_D = -(ipm + lam c - rho/2 c^2), c = 1 - omega
        ipm = (lr - lf).sum() * inv_b
        omega = 0.5 * (lr * lr + lf * lf).sum() * inv_b
        c = 1.0 - omega
        mu_f = lam - hp.fisher_rho * c
        glr = (-1.0 + mu_f * lr) * inv_b
        glf = (1.0 + mu_f * lf) * inv_b
        d_loss = -(ipm + lam * c - 0.5 * hp.fisher_rho * c * c)
        lanes12, aux6 = [ipm, omega], c
        lam = lam - hp.fisher_rho * c
    return glr, glf, [d_loss] + lanes12, aux6, lam


def _g_hook(hp: ChunkHyper, lf2, lr2, inv_b: float, fake2=None, zrow=None):
    """(dL_G/dhead [B, L], g_loss, lane 6, dx_extra) —
    ``_make_variant_hooks``' g_hook. `lr2` (ragan only): the post-update
    critic on the last real batch; `fake2` (began) G's output; `zrow`
    (infogan) its code rows. dx_extra: began's direct L1 path into the
    fake pixels (None elsewhere); lane 6: infogan's G MI term (None
    elsewhere)."""
    v = hp.variant
    if v == "began":  # lf2: reconstruction logits [B, X]
        rf2 = torch.sigmoid(lf2)
        s2 = torch.sign(fake2 - rf2) * (inv_b / fake2.shape[1])
        g_loss = (fake2 - rf2).abs().sum() * (inv_b / fake2.shape[1])
        return -s2 * rf2 * (1.0 - rf2), g_loss, None, s2
    if v == "infogan":
        gq2, mi2 = _info_q(hp, lf2, zrow, inv_b)
        gq2[:, :1] = (torch.sigmoid(lf2[:, :1]) - 1.0) * inv_b
        return (gq2, _softplus(-lf2[:, 0]).sum() * inv_b + hp.info_lam * mi2,
                mi2, None)
    if v in ("nsgan", "dragan", "cgan"):
        gl, g_loss = ((torch.sigmoid(lf2) - 1.0) * inv_b,
                      _softplus(-lf2).sum() * inv_b)
    elif v == "mmgan":
        gl, g_loss = -torch.sigmoid(lf2) * inv_b, -_softplus(lf2).sum() * inv_b
    elif v == "lsgan":
        gl, g_loss = (lf2 - 1.0) * inv_b, 0.5 * ((lf2 - 1.0) ** 2).sum() * inv_b
    elif v in ("wgan", "wgangp", "fishergan"):
        gl, g_loss = torch.full_like(lf2, -inv_b), -lf2.sum() * inv_b
    elif v == "fgan":
        gf, gfp, fstar, fstarp = _FGAN_TABLE[hp.fgan_div]
        t_f2 = gf(lf2)
        if hp.fgan_ns:
            gl, g_loss = -gfp(lf2) * inv_b, -t_f2.sum() * inv_b
        else:
            gl, g_loss = (-fstarp(t_f2) * gfp(lf2) * inv_b,
                          -fstar(t_f2).sum() * inv_b)
    else:
        # ragan: only lf2 depends on G:
        # dL_G/dlf2_k = (sig(df2_k) - 1)/B - mean(sig(dr2))/B
        dr2 = lr2 - lf2.sum() * inv_b
        df2 = lf2 - lr2.sum() * inv_b
        abar = torch.sigmoid(dr2).sum() * inv_b
        gl, g_loss = (((torch.sigmoid(df2) - 1.0) - abar) * inv_b,
                      (_softplus(-df2).sum() + _softplus(dr2).sum()) * inv_b)
    return gl, g_loss, None, None


class Tie(Exception):
    """Raised by :func:`_watch` when a probe's margin falls to its
    ``"stop_at"`` value: the data has a tie, and the run is cut short."""


def _watch(probe: Optional[dict], u) -> None:
    """Tie probe: keeps the smallest |pre-activation| of a hidden layer
    relative to that layer's root mean square, as a tensor under
    ``probe["margin"]``. A ReLU / LeakyReLU input within float32 rounding
    of zero takes the other branch in another arithmetic, so a check that
    holds two versions together wants data whose margin is well above
    that. With ``probe["stop_at"]`` set, raises :class:`Tie` as soon as
    the margin is at or below it."""
    if probe is None:
        return
    m = u.abs().min() / u.pow(2).mean().sqrt()
    probe["margin"] = torch.minimum(probe["margin"], m) \
        if "margin" in probe else m
    if "stop_at" in probe and float(probe["margin"]) <= probe["stop_at"]:
        raise Tie(float(probe["margin"]))


def _gp_backward(xh, w1d, b1d, w2d, *, lam: float, slope: float,
                 inv_b: float, watch, bf16: bool = False):
    """The gradient penalty's double backward, hand-derived as the TPU
    kernel's ``_gp_backward`` (``pallas_train.py:227-245``, math at
    ``:525-535``). With D(x) = w2d^T leaky(W1d^T x + b1d) + b2d the input
    gradient is g = (leaky'(hh) * w2d^T) W1d^T at hh = x_hat W1d + b1d;
    leaky' is piecewise constant, so its derivative is 0 almost
    everywhere, as autograd takes it through ``where``:
        n_i = sqrt(sum g_i^2 + 1e-12),  c_i = 2 lam (n_i - 1) / (B n_i)
        dW1d += (c * g)^T u,  u = leaky'(hh) * w2d^T
        dw2d += sum_i c_i leaky'(hh_i) * (g W1d)_i;  db1d, db2d get nothing
    With `bf16` each product's operands are rounded as the reference's
    are: w2d in u (its ``w2row = dotT_rhs(lane0, w2d)``) and each term
    c_i leaky'(hh_i) s_i of dw2d (``dotT_lhs(., lane0)``).
    Returns (dW1d part, dw2d part, gp, mean norm)."""
    rnd = round_bf16 if bf16 else (lambda t: t)
    hh = mm(xh, w1d, bf16) + b1d
    watch(hh)
    dph = torch.where(hh >= 0, 1.0, slope)
    u = dph * rnd(w2d.t())
    g = mm(u, w1d.t(), bf16)
    nrm = torch.sqrt((g * g).sum(1, keepdim=True) + 1e-12)
    gp = lam * ((nrm - 1.0) ** 2).sum() * inv_b
    c = (2.0 * lam * inv_b) * (nrm - 1.0) / nrm
    s_pen = mm(g, w1d, bf16)
    return (mm((g * c).t(), u, bf16), rnd(c * dph * s_pen).sum(0)[:, None],
            gp, nrm.sum() * inv_b)


def _watch_abs(probe: Optional[dict], v, logits) -> None:
    """began's |.| tie probe: the smallest |v - sigmoid(logits)| relative
    to its root mean square, where r (1 - r) > 1e-3, under
    ``probe["abs_margin"]``."""
    if probe is None:
        return
    r = torch.sigmoid(logits)
    d = (v - r)[r * (1.0 - r) > 1e-3]
    if d.numel() == 0:
        return
    m = d.abs().min() / (v - r).pow(2).mean().sqrt()
    probe["abs_margin"] = torch.minimum(probe["abs_margin"], m) \
        if "abs_margin" in probe else m


def _acts(hp: ChunkHyper, probe: Optional[dict]):
    """(leaky, relu, leaky') of the kernel, the first two watched for
    ties."""
    s = hp.slope

    def leaky(u):
        _watch(probe, u)
        return torch.where(u >= 0, u, s * u)

    def relu(u):
        _watch(probe, u)
        return torch.clamp_min(u, 0.0)

    return leaky, relu, lambda h: torch.where(h >= 0, 1.0, s)


def critic_grads(hp: ChunkHyper, p, x, z, xt, lam, inv_b: float,
                 probe: Optional[dict] = None):
    """One critic update's gradients by the kernel's hand-derived math
    (phases A-F): G's fake from the z rows `z`, the critic on the rows
    `x` and on the fake (cgan: with x's label lanes), the hook, the
    backward, and for a penalty hook its double backward at x_hat from
    `xt` (wgangp's eps rows, dragan's x_hat rows); with ``hp.dtype``
    "bfloat16" every product's operands rounded (:func:`mm`), infogan's
    MI targets too (:func:`_info_q`). `p` holds the 8
    parameters (:func:`state_planes` order); `lam` the carried scalar
    before the update. Returns ([dW1d, db1d, dW2d, db2d], [d_loss (with
    the penalty), lane 1, lane 2], [gp, mean norm] (zeros without a
    penalty), lane 6, lam after the update)."""
    w1g, b1g, w2g, b2g, w1d, b1d, w2d, b2d = p
    leaky, relu, dleaky = _acts(hp, probe)
    bf = hp.bf16
    x_g = w2g.shape[1]        # G's output width; D's input is x_g + n_cls
    hgd = relu(mm(z, w1g, bf) + b1g)
    fake = torch.sigmoid(mm(hgd, w2g, bf) + b2g)
    # cgan: D sees the fake with its row's label, the x row's
    fake_d = torch.cat([fake, x[:, x_g:]], 1) if hp.n_cls else fake
    hr = leaky(mm(x, w1d, bf) + b1d)
    lr = mm(hr, w2d, bf) + b2d
    hf = leaky(mm(fake_d, w1d, bf) + b1d)
    lf = mm(hf, w2d, bf) + b2d
    if hp.variant == "began":
        _watch_abs(probe, x, lr)
        _watch_abs(probe, fake, lf)
    glr, glf, row, aux6, lam = _d_hook(hp, lr, lf, lam, inv_b, x=x,
                                       fake=fake_d, zrow=z)
    dw2 = mm(hr.t(), glr, bf) + mm(hf.t(), glf, bf)
    db2 = (glr + glf).sum(0)
    dhr = mm(glr, w2d.t(), bf) * dleaky(hr)
    dhf = mm(glf, w2d.t(), bf) * dleaky(hf)
    dw1 = mm(x.t(), dhr, bf) + mm(fake_d.t(), dhf, bf)
    db1 = (dhr + dhf).sum(0)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    pen = [zero, zero]
    if hp.gp_lam:
        xh = xt if hp.variant == "dragan" else xt * x + (1.0 - xt) * fake
        dw1_p, dw2_p, gp, gnorm = _gp_backward(
            xh, w1d, b1d, w2d, lam=hp.gp_lam, slope=hp.slope, inv_b=inv_b,
            watch=lambda u: _watch(probe, u), bf16=bf)
        dw1 = dw1 + dw1_p
        dw2 = dw2 + dw2_p
        row = [row[0] + gp] + row[1:]
        pen = [gp, gnorm]
    return [dw1, db1, dw2, db2], row, pen, aux6, lam


def g_grads(hp: ChunkHyper, p, z, inv_b: float, x_last=None,
            probe: Optional[dict] = None):
    """One G update's gradients through the critic in `p` by the
    kernel's hand-derived math (phases G1-G6) from the z rows `z` (cgan:
    ending in their label lanes; infogan: code rows). `x_last` (ragan
    only) is the last critic batch, which its G loss reads. Returns
    ([dW1g, db1g, dW2g, db2g], g_loss, lane 6 (infogan's G MI term; None
    elsewhere))."""
    w1g, b1g, w2g, b2g, w1d, b1d, w2d, b2d = p
    leaky, relu, dleaky = _acts(hp, probe)
    bf = hp.bf16
    x_g = w2g.shape[1]
    z_g = z.shape[1] - hp.n_cls
    hg = relu(mm(z, w1g, bf) + b1g)
    fake2 = torch.sigmoid(mm(hg, w2g, bf) + b2g)
    fake2_d = torch.cat([fake2, z[:, z_g:]], 1) if hp.n_cls else fake2
    hf2 = leaky(mm(fake2_d, w1d, bf) + b1d)
    lf2 = mm(hf2, w2d, bf) + b2d
    lr2 = None
    if hp.variant == "ragan":  # the post-update critic on the last x
        lr2 = mm(leaky(mm(x_last, w1d, bf) + b1d), w2d, bf) + b2d
    if hp.variant == "began":
        _watch_abs(probe, fake2, lf2)
    gl, g_loss, g6, dx_extra = _g_hook(hp, lf2, lr2, inv_b, fake2=fake2,
                                       zrow=z)
    dh2 = mm(gl, w2d.t(), bf) * dleaky(hf2)
    dx = mm(dh2, w1d[:x_g].t(), bf)  # the label lanes carry nothing to G
    if dx_extra is not None:  # began: the direct L1 path into fake2
        dx = dx + dx_extra
    gu2 = (dx * fake2) * (1.0 - fake2)
    dw2g = mm(hg.t(), gu2, bf)
    db2g = gu2.sum(0)
    dhg = mm(gu2, w2g.t(), bf) * (hg > 0).to(z.dtype)
    dw1g = mm(z.t(), dhg, bf)
    db1g = dhg.sum(0)
    return [dw1g, db1g, dw2g, db2g], g_loss, g6


def ema_(ema, p, decay: float) -> None:
    """ema <- decay ema + (1 - decay) p in place, each product rounded
    on its own (the reference kernels' order; 1 - decay rounded once
    from double, as there)."""
    ema.copy_(ema * decay + p * (1.0 - decay))


def gan_chunk_plain(xs, zd, zg, p, mu, nu, *, steps: int, ds: int,
                    batch: int, t_g: int, t_d: int, hp: ChunkHyper,
                    lam=0.0, xtra=None, ema=None,
                    probe: Optional[dict] = None) -> torch.Tensor:
    """The kernel's function in plain PyTorch, in the dtype of its
    inputs (float32, or float64 as the kernel's oracle). Updates `p`,
    `mu`, `nu` (lists of 8 tensors, :func:`state_planes` order; `mu`
    None with RMSprop) and, with ``hp.ema_decay > 0``, G's EMA plane
    `ema` (4 tensors) in place and returns the metrics rows [steps, 8]
    (lanes: see the module docstring). `lam` is fishergan's multiplier
    before the chunk; after it, it is lane 7 of the last row. `xtra` is
    the penalty variants' stream (see :func:`gan_chunk`). With a `probe`
    dict, records the tie margin (:func:`_watch`), x_hat's pre-activation
    too; for began also the smallest |pixel - reconstruction| relative to
    the layer's root mean square over the pixels where r (1 - r) > 1e-3
    (a |.| tie: sign flips there), under ``probe["abs_margin"]``."""
    inv_b = 1.0 / batch
    began = hp.variant == "began"
    lam = torch.as_tensor(lam, dtype=xs.dtype, device=xs.device)

    def update(q, g, lr, t):
        if hp.adam:
            _adam_(p[q], mu[q], nu[q], g, lr, t, hp)
        else:
            _rmsprop_(p[q], nu[q], g, lr)
        if q >= 4 and hp.clip > 0.0:  # wgan: every critic tensor
            p[q].clamp_(-hp.clip, hp.clip)

    metrics = torch.zeros((steps, METRIC_LANES), dtype=torch.float32,
                          device=xs.device)
    zero = torch.zeros((), dtype=xs.dtype, device=xs.device)
    for k in range(steps):
        for i in range(ds):
            r0 = (k * ds + i) * batch
            x = xs[r0:r0 + batch]
            xt = None if xtra is None else xtra[r0:r0 + batch]
            grads, row, pen, aux6, lam = critic_grads(
                hp, p, x, zd[r0:r0 + batch], xt, lam, inv_b, probe)
            for q, g in zip(range(4, 8), grads):
                update(q, g, hp.d_lr, float(t_d + k * ds + i + 1))
        grads, g_loss, g6 = g_grads(hp, p, zg[k * batch:(k + 1) * batch],
                                    inv_b, x_last=x, probe=probe)
        for q, g in zip(range(4), grads):
            update(q, g, hp.g_lr, float(t_g + k + 1))
        if hp.ema_decay > 0.0:  # G's EMA plane, after the G update
            for q in range(4):
                ema_(ema[q], p[q], hp.ema_decay)
        if g6 is not None:  # infogan: G's MI term
            aux6 = g6
        if began:  # the k_t law, with the last critic update's L(x)
            bal = hp.began_gamma * row[1] - g_loss
            lam = torch.clamp(lam + hp.began_lambda_k * bal, 0.0, 1.0)
            aux6 = row[1] + bal.abs()
        metrics[k] = torch.stack(row + [g_loss] + pen + [
            aux6, lam if hp.variant in CARRIED else zero])
    return metrics


# ---------------------------------------------------------------------
# The kernel
# ---------------------------------------------------------------------

class _Hyper(ctypes.Structure):
    """``GanChunkHyper`` of csrc/gan_chunk.cu, field for field."""
    _fields_ = ([(n, ctypes.c_int) for n in (
        "steps", "ds", "B", "Z", "H", "X", "Hd", "t_g", "t_d", "rmsprop",
        "alt", "div", "n_cls", "Xd", "L", "n_cat", "n_cont", "ema")] + [
            (n, ctypes.c_float) for n in (
                "g_lr", "d_lr", "b1", "b2", "omb1", "omb2", "eps", "log_b1",
                "log_b2", "slope", "inv_b", "clip", "rho", "gp_lam",
                "info_lam", "gamma", "lambda_k", "ema_d", "ema_omd")])


def bind(lib) -> None:
    """The C interface of a library built from csrc/gan_chunk.cu."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.gm_gan_chunk.argtypes = [p, p, p, p, ctypes.POINTER(p), p, p, p,
                                 ctypes.POINTER(_Hyper), i, p]
    lib.gm_gan_chunk.restype = i
    lib.gm_gan_chunk_scratch_floats.argtypes = [i] * 7
    lib.gm_gan_chunk_scratch_floats.restype = ctypes.c_longlong
    lib.gm_gan_chunk_grid.argtypes = [i, i, i]
    lib.gm_gan_chunk_grid.restype = i
    lib.gm_gan_chunk_blocks_per_sm.argtypes = [i, i]
    lib.gm_gan_chunk_blocks_per_sm.restype = i
    lib.gm_gan_chunk_smem_bytes.argtypes = []
    lib.gm_gan_chunk_smem_bytes.restype = i
    lib.gm_gan_chunk_tile_class.argtypes = [i] * 4
    lib.gm_gan_chunk_tile_class.restype = i
    lib.gm_gan_chunk_hook.argtypes = []
    lib.gm_gan_chunk_hook.restype = i
    lib.gm_gan_chunk_bf16.argtypes = []
    lib.gm_gan_chunk_bf16.restype = i


def lib_name(kind: str, hook: str, bf16: bool) -> str:
    """A library's name: `kind` ("gan_chunk", "gan_phase") and hook, and
    "_bf16" for a build whose products take bf16 operands."""
    return f"{kind}_{hook}" + ("_bf16" if bf16 else "")


def lib_flags(hook: str, bf16: bool, phase: bool = False) -> tuple:
    """The nvcc flags of a build of csrc/gan_chunk.cu."""
    return ((f"-DGM_HOOK={HOOK_IDS[hook]}",) + (("-DGM_PHASE=1",) if phase
                                                 else ())
            + (("-DGM_BF16=1",) if bf16 else ()))


@functools.cache
def _lib(hook: str, bf16: bool = False):
    from generative_models_tpu_torch.ops.build import build_library
    lib = build_library(lib_name("gan_chunk", hook, bf16), ["gan_chunk.cu"],
                        headers=["chunk_common.cuh"],
                        flags=lib_flags(hook, bf16))
    bind(lib)
    if (lib.gm_gan_chunk_hook(), lib.gm_gan_chunk_bf16()) != (
            HOOK_IDS[hook], int(bf16)):
        raise RuntimeError(f"gan_chunk: the library built for hook {hook!r} "
                           f"(bf16 {bf16}) reports hook "
                           f"{lib.gm_gan_chunk_hook()}, bf16 "
                           f"{lib.gm_gan_chunk_bf16()}")
    return lib


def build(hook: Optional[str] = None, bf16: bool = False) -> None:
    """Compile (or load) the kernel's library for `hook` (see
    :data:`HOOKS`; its bf16 build with `bf16`) now instead of at first
    use; every hook's when None."""
    for h in ([hook] if hook else HOOK_IDS):
        _lib(h, bf16)


def hyper_struct(hp: ChunkHyper, *, steps, ds, batch, z, h, x, hd, t_g,
                 t_d, ema: bool = False) -> _Hyper:
    """`hp` and the chunk's sizes and counts as the kernel takes them; `z`
    is G's input width and `x` its output width (cgan: D's input is x +
    n_cls wide); `ema`: the launch steps G's EMA plane (the phase kernels
    take none)."""
    return _Hyper(
        steps=steps, ds=ds, B=batch, Z=z, H=h, X=x, Hd=hd, t_g=t_g, t_d=t_d,
        n_cls=hp.n_cls, Xd=x + hp.n_cls, gp_lam=hp.gp_lam,
        L=hp.head_width(x), n_cat=hp.info_cat, n_cont=hp.info_cont,
        info_lam=hp.info_lam, gamma=hp.began_gamma,
        lambda_k=hp.began_lambda_k,
        rmsprop=int(not hp.adam), ema=int(ema), ema_d=hp.ema_decay,
        ema_omd=1.0 - hp.ema_decay,
        alt=int(hp.variant == "mmgan" or (hp.variant == "fgan"
                                          and hp.fgan_ns)),
        div=FGAN_DIV_IDS[hp.fgan_div], g_lr=hp.g_lr, d_lr=hp.d_lr, b1=hp.b1,
        b2=hp.b2, omb1=1.0 - hp.b1, omb2=1.0 - hp.b2, eps=hp.eps,
        log_b1=math.log(hp.b1), log_b2=math.log(hp.b2), slope=hp.slope,
        inv_b=1.0 / batch, clip=hp.clip, rho=hp.fisher_rho)


def _check(xs, zd, zg, xtra, p, mu, nu, ema, steps, ds, batch, hp):
    planes = [("p", p), ("nu", nu)] + ([("mu", mu)] if hp.adam else [])
    if not hp.adam and mu is not None:
        raise ValueError("gan_chunk: an RMSprop state has no mu plane")
    if (ema is None) != (hp.ema_decay == 0.0):
        raise ValueError("gan_chunk takes G's EMA plane (4 tensors) exactly "
                         "when hp.ema_decay > 0")
    if any(pl is None or len(pl) != 8 for _, pl in planes):
        raise ValueError("gan_chunk takes 8 tensors a state plane "
                         "(parameters, nu, and with Adam mu)")
    if ema is not None:
        if len(ema) != 4:
            raise ValueError("gan_chunk: the EMA plane holds G's 4 tensors")
        planes.append(("ema", list(ema)))
    z, h = p[0].shape
    x = p[2].shape[1]
    xd, hd = p[4].shape
    codes = hp.n_cls + hp.info_cat + hp.info_cont
    if xd != x + hp.n_cls or z <= codes:
        raise ValueError(f"gan_chunk: D's input ({xd}) must be G's output "
                         f"({x}) plus the {hp.n_cls} label lanes, and G's "
                         f"input ({z}) wider than its {codes} label or code "
                         f"lanes")
    nl = hp.head_width(x)
    if hp.variant == "infogan" and nl > INFO_MAX_LANES:
        raise ValueError(f"gan_chunk: infogan's head is {nl} lanes, the "
                         f"kernel keeps at most {INFO_MAX_LANES}")
    want = [(z, h), (h,), (h, x), (x,), (xd, hd), (hd,), (hd, nl), (nl,)]
    for name, pl in planes:
        for q, t in enumerate(pl):
            if tuple(t.shape) != want[q]:
                raise ValueError(f"gan_chunk: {name}{q} must be {want[q]}, "
                                 f"got {tuple(t.shape)}")
    rows = steps * ds * batch
    lanes = aux_lanes(hp.variant, x)
    if (xtra is None) != (lanes == 0):
        raise ValueError(f"gan_chunk: {hp.variant} takes "
                         + (f"an xtra stream [rows, {lanes}]" if lanes
                            else "no xtra stream"))
    streams = [("xs", xs, (rows, xd)), ("zd", zd, (rows, z)),
               ("zg", zg, (steps * batch, z))]
    if lanes:
        streams.append(("xtra", xtra, (rows, lanes)))
    for name, t, shape in streams:
        if tuple(t.shape) != shape:
            raise ValueError(f"gan_chunk: {name} must be {shape}, got "
                             f"{tuple(t.shape)}")
    for t in [t for _, t, _ in streams] + [t for _, pl in planes for t in pl]:
        if t.dtype != torch.float32 or t.device != xs.device:
            raise TypeError(f"gan_chunk takes float32 tensors on one device; "
                            f"got {t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError("gan_chunk takes contiguous tensors")


def gan_chunk(xs, zd, zg, p, mu, nu, *, steps: int, ds: int, batch: int,
              t_g: int, t_d: int, hp: ChunkHyper, lam=0.0,
              xtra=None, ema=None) -> torch.Tensor:
    """Run `steps` outer steps on the streams ``xs [steps*ds*B, Xd]``,
    ``zd [steps*ds*B, Z]``, ``zg [steps*B, Z]`` (cgan: Xd = X + n_cls and
    each x, zd and zg row ends in its one-hot label; the zg rows carry
    the labels of the step's last critic batch; else Xd = X) and, for
    wgangp and dragan, ``xtra [steps*ds*B, 1]`` (eps) or ``[..., X]``
    (x_hat); infogan's zd and zg rows are G's code rows [., Z] (z ⊕
    onehot(cat) ⊕ cont) and its W2d [Hd, L] the D and Q heads side by
    side; began's critic is W1d [X, Hd], W2d [Hd, X]. `t_g`/`t_d` are the
    Adam counts before the chunk (unused with RMSprop, whose `mu` is
    None); `lam` (a float or a 0-dim tensor) is the carried scalar before
    the chunk (fishergan's multiplier, began's k_t). `ema` is G's EMA
    plane (g_w1 g_b1 g_w2 g_b2), given exactly when ``hp.ema_decay > 0``;
    ``hp.dtype`` "bfloat16" takes the library whose products round their
    operands to bf16. Updates the state planes in place and returns the
    metrics rows [steps, 8]; lane 7 of the last row is `lam` after the
    chunk. CPU tensors run :func:`gan_chunk_plain`; CUDA tensors launch
    the kernel on the current stream or raise."""
    global launches, ema_launches, bf16_launches
    _check(xs, zd, zg, xtra, p, mu, nu, ema, steps, ds, batch, hp)
    if xs.device.type == "cpu":
        return gan_chunk_plain(xs, zd, zg, p, mu, nu, steps=steps, ds=ds,
                               batch=batch, t_g=t_g, t_d=t_d, hp=hp, lam=lam,
                               xtra=xtra, ema=ema)
    if xs.device.type != "cuda":
        raise ValueError(f"gan_chunk runs on cuda or cpu tensors, not "
                         f"{xs.device}")
    z, h = p[0].shape
    x = p[2].shape[1]
    hd = p[4].shape[1]
    use_ema = ema is not None
    lib = _lib(HOOKS[hp.variant], hp.bf16)
    with torch.cuda.device(xs.device):
        metrics = torch.zeros((steps, METRIC_LANES), dtype=torch.float32,
                              device=xs.device)
        # a host scalar reaches the card by a copy that waits on the stream
        with spans.span("chunk.lam.wait"):
            lam_buf = torch.as_tensor(lam, dtype=torch.float32,
                                      device=xs.device).reshape(1).clone()
        scratch = torch.empty(
            lib.gm_gan_chunk_scratch_floats(batch, z, h, x, hd,
                                            x + hp.n_cls, hp.head_width(x)),
            dtype=torch.float32, device=xs.device)
        grid = lib.gm_gan_chunk_grid(BLOCKS_PER_SM, int(not hp.adam),
                                     int(use_ema))
        if grid < 1:
            raise RuntimeError("gan_chunk: the occupancy query failed")
        ptrs = [t.data_ptr() for t in p]
        ptrs += [t.data_ptr() for t in mu] if hp.adam else [None] * 8
        ptrs += [t.data_ptr() for t in nu]
        ptrs += [t.data_ptr() for t in ema] if use_ema else [None] * 4
        state = (ctypes.c_void_p * 28)(*ptrs)
        hyper = hyper_struct(hp, steps=steps, ds=ds, batch=batch, z=z, h=h,
                             x=x, hd=hd, t_g=t_g, t_d=t_d, ema=use_ema)
        stream = torch.cuda.current_stream(xs.device).cuda_stream
        rc = lib.gm_gan_chunk(
            xs.data_ptr(), zd.data_ptr(), zg.data_ptr(),
            None if xtra is None else xtra.data_ptr(), state,
            scratch.data_ptr(), metrics.data_ptr(), lam_buf.data_ptr(),
            ctypes.byref(hyper), grid, stream)
    if rc != 0:
        raise RuntimeError(f"gan_chunk kernel launch failed: CUDA error {rc}")
    launches += 1
    ema_launches += int(use_ema)
    bf16_launches += int(hp.bf16)
    return metrics


# ---------------------------------------------------------------------
# The trainer-facing builder and its policy
# ---------------------------------------------------------------------

def fused_step_supported(spec, cfg) -> Tuple[bool, str]:
    """(ok, reason): the chunk kernels cover nsgan, mmgan, lsgan, wgan,
    fgan, ragan, fishergan, wgangp, dragan, cgan, infogan (the fixed
    variance, a head of at most 128 lanes) and began (the default
    activations, Adam or RMSprop, any d_steps), vae
    (the Bernoulli decoder) and birvae (mse or bce), both with Adam, on
    the MLP stacks, in float32 or with bf16 operands, with or without the
    EMA plane; everything else keeps the general step."""
    v = cfg.variant
    if v not in FUSED_VARIANTS:  # the reference's exclusions
        return False, (f"the chunk kernel covers {FUSED_VARIANTS} only; "
                       f"{v} keeps the general step, as in the reference "
                       f"(pallas_train.py:1387-1400)")
    if cfg.arch != "mlp":
        return False, "the chunk kernel covers the mlp stacks only"
    if v in ("vae", "birvae") and cfg.optimizer != "adam":
        return False, f"the {v} chunk kernel is adam-only"
    if v == "vae":
        if cfg.vae_recon != "bce":
            return False, ("the vae chunk kernel covers the Bernoulli (bce) "
                           "decoder")
    elif v != "birvae" and (cfg.g_hidden_act != "relu"
                            or cfg.d_hidden_act != "leaky_relu"):
        return False, ("the chunk kernel hand-derives the default "
                       "activations (G relu / D leaky_relu)")
    if v == "infogan":
        if not cfg.info_cont_fixed_var:
            return False, ("the infogan chunk kernel hand-derives the fixed-"
                           "variance Gaussian NLL (the default); the learned-"
                           "variance head keeps the general step")
        if 1 + cfg.info_cat_dim + 2 * cfg.info_cont_dim > INFO_MAX_LANES:
            return False, (f"the infogan chunk kernel's head is at most "
                           f"{INFO_MAX_LANES} lanes")
    if cfg.spectral_projection:
        return False, "the chunk kernel excludes the spectral projection hook"
    if cfg.dp > 1 or cfg.tp > 1:
        return False, "the chunk kernel is single-device"
    return True, ""


def resolve_fused_step(spec, cfg, device) -> bool:
    """``Config.fused_step`` ("auto" | bool) as a choice: True forces the
    chunk (the kernel on CUDA, its plain version on the CPU); False the
    general step; "auto" the general step on the CPU, as the reference
    keeps the XLA step off the TPU, and on CUDA, where
    :func:`fused_step_supported` says yes, the measured policy's verdict
    (``ops/fused_policy.py::resolve_auto``: a cached A/B of both paths on
    this card, or with measurement off or failed the kernel)."""
    if cfg.fused_step is True:
        return True
    if cfg.fused_step != "auto":
        return False
    if (torch.device(device).type != "cuda"
            or not fused_step_supported(spec, cfg)[0]):
        return False
    from generative_models_tpu_torch.ops import fused_policy
    return fused_policy.resolve_auto(spec, cfg, device)


def _with_planes(state, p, mu, nu, ema, g_updates: int, d_updates: int):
    """The params, optimizer states and G EMA (`ema`, None without one)
    of `state`'s trees holding the chunk's planes (:func:`state_planes`
    order; infogan's head split back into its two heads), the Adam counts
    advanced by the updates."""
    def trees(plane):
        layers = [{"w": plane[i], "b": plane[i + 1]}
                  for i in range(0, len(plane), 2)]
        return layers[:2], _d_params(state["d_params"], layers[2:])

    out = dict(zip(("g_params", "d_params"), trees(p)))
    if ema is not None:
        out["g_ema"] = [{"w": ema[0], "b": ema[1]},
                        {"w": ema[2], "b": ema[3]}]
    opts = {"g_opt": {}, "d_opt": {}}
    for slot, plane in (("mu", mu), ("nu", nu)):
        if slot in state["g_opt"]:
            opts["g_opt"][slot], opts["d_opt"][slot] = trees(plane)
    if "count" in state["g_opt"]:
        opts["g_opt"]["count"] = state["g_opt"]["count"] + g_updates
        opts["d_opt"]["count"] = state["d_opt"]["count"] + d_updates
    return dict(out, **opts)


def named_metrics(variant: str, m: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The metrics rows [steps, 8] under the reference's names for
    `variant` (``pallas_train.py:1268-1333``)."""
    out = {"d_loss": m[:, 0], "g_loss": m[:, 3]}
    if variant == "wgan":
        out["w_estimate"] = -m[:, 0]
    elif variant == "wgangp":  # d_loss = w + gp, w_estimate = -w
        out.update(w_estimate=m[:, 1] - m[:, 2], gp=m[:, 4],
                   grad_norm=m[:, 5])
    elif variant == "dragan":
        out.update(gp=m[:, 4], grad_norm=m[:, 5])
    elif variant == "fgan":
        out["f_bound"] = -m[:, 0]
    elif variant == "fishergan":
        out.update(ipm=m[:, 1], omega=m[:, 2], constraint=m[:, 6],
                   vstate_lam=m[:, 7])
    elif variant == "began":
        out.update(began_l_real=m[:, 1], began_l_fake_d=m[:, 2],
                   began_l_fake_g=m[:, 3], vstate_m=m[:, 6],
                   vstate_k=m[:, 7])
    elif variant == "infogan":
        out.update(mi_loss=m[:, 1], g_mi_loss=m[:, 6])
    elif variant != "ragan":
        out.update(d_real=m[:, 1], d_fake=m[:, 2])
    return out


def build_fused_many_steps(spec, cfg, steps_per_epoch: int):
    """The chunk kernel's counterpart of ``train.step.build_many_steps``,
    with the same contract and the same gather and sub-chunking, so both
    see the same batches and noise: ``many_steps(state, images, labels,
    perm_stack, rel_offsets, noise) -> (state, metrics)``. The caller's
    state is not modified (the kernel updates copies in place).
    fishergan's multiplier is seeded from ``state["vstate"]["lam"]``,
    carried from one sub-chunk to the next on the device, and returned
    in the new state's ``vstate``; began's k_t likewise (``vstate["k"]``,
    with ``vstate["m"]`` from the last step's lane 6). infogan's `noise`
    gives code rows (``train/step.py::draw_z``), which are its zd and zg
    streams as they are. wgangp's `noise` gives a third tensor,
    eps ``[n, d_steps, B, 1]``, which goes to the kernel as the ``xtra``
    stream; dragan's gives u ``[n, d_steps, B, X]``, from which x_hat =
    x + scale * std(x) * u is formed here on the device, per critic batch
    (the TPU path forms it in XLA, ``pallas_train.py:1050-1070``). cgan's
    gathered labels become one-hot lanes on the x and zd rows, and the
    last critic batch's on the zg rows. For a single-model spec (vae, birvae)
    this is ``ops/cuda_train_vae.py``'s function, whose `noise` gives
    ``eps [n, B, latent]``."""
    if not spec.adversarial:
        from generative_models_tpu_torch.ops import cuda_train_vae
        return cuda_train_vae.build_fused_single_many_steps(
            spec, cfg, steps_per_epoch)
    ok, reason = fused_step_supported(spec, cfg)
    if not ok:
        raise ValueError(f"fused_step unsupported here: {reason}")
    ds = max(cfg.d_steps, 1)
    b = cfg.batch_size
    rows_per_step = batches_per_step(spec, cfg) * b
    rows_per_epoch = steps_per_epoch * rows_per_step
    hp = ChunkHyper.from_config(cfg)
    carried = CARRIED.get(cfg.variant)
    lanes = aux_lanes(cfg.variant, cfg.image_dim)

    def many_steps(state, images, labels, perm_stack, rel_offsets, noise):
        steps = rel_offsets.shape[0]
        sub = pick_sub(steps, stream_bytes_per_step(cfg))
        g_opt, d_opt = state["g_opt"], state["d_opt"]
        # copies of the planes, for the kernel to update in place
        p, mu, nu, ema = [None if pl is None else [t.clone() for t in pl]
                          for pl in (*state_planes(state), ema_plane(state))]
        with spans.span("chunk.count.wait"):  # the counts live on the card
            t_g, t_d = ((int(g_opt["count"]), int(d_opt["count"]))
                        if hp.adam else (0, 0))
        lam = state["vstate"][carried] if carried else 0.0
        rows = []
        for k0 in range(0, steps, sub):
            with spans.span("chunk.gather"):
                xs, ys = gather_streams(images, labels, perm_stack,
                                        rel_offsets[k0:k0 + sub],
                                        rows_per_step, rows_per_epoch)
            with spans.span("chunk.noise"):
                drawn = noise(k0, sub)
            xs = xs.reshape(sub * rows_per_step, -1)
            zd = drawn[0].reshape(sub * rows_per_step, -1)
            zg = drawn[1].reshape(sub * b, -1)
            xtra = None
            if lanes:
                aux = drawn[2].reshape(sub * ds, b, lanes)
                if cfg.variant == "dragan":  # x_hat, per critic batch
                    xb = xs.reshape(sub * ds, b, -1)
                    std = xb.std(dim=(1, 2), correction=0, keepdim=True)
                    xtra = (xb + cfg.dragan_noise_scale * std * aux).reshape(
                        sub * rows_per_step, -1)
                else:
                    xtra = aux.reshape(sub * rows_per_step, 1)
            if hp.n_cls:  # the label lanes; G's from the last critic batch
                oh = onehot(ys.reshape(-1), hp.n_cls)
                xs = torch.cat([xs, oh], 1)
                zd = torch.cat([zd, oh], 1)
                zg = torch.cat([zg, oh.reshape(sub, ds, b, -1)[:, -1]
                                .reshape(sub * b, -1)], 1)
            with spans.span("chunk.kernel"):
                rows.append(gan_chunk(
                    xs.contiguous(), zd.contiguous(), zg.contiguous(), p, mu,
                    nu, steps=sub, ds=ds, batch=b, t_g=t_g + k0,
                    t_d=t_d + k0 * ds, hp=hp, lam=lam,
                    xtra=None if xtra is None else xtra.contiguous(),
                    ema=ema))
            if carried:  # the scalar rides out through lane 7
                lam = rows[-1][-1, 7]
        new = dict(state, step=state["step"] + steps,
                   **_with_planes(state, p, mu, nu, ema, steps, steps * ds))
        if carried == "lam":
            new["vstate"] = {"lam": lam.clone()}
        elif carried == "k":
            new["vstate"] = {"k": lam.clone(), "m": rows[-1][-1, 6].clone()}
        return new, named_metrics(cfg.variant, torch.cat(rows))

    return many_steps
