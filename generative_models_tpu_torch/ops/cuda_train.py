"""Whole-chunk G+D training in one kernel launch — the port of
``generative_models_tpu/ops/pallas_train.py`` for nsgan, mmgan, lsgan,
wgan, fgan, ragan and fishergan (``_make_kernel`` with
``_make_variant_hooks`` and ``_fused_chunk_call``,
``build_fused_many_steps``, ``fused_step_supported``,
``resolve_fused_step``). The single-model family's chunk kernels (vae,
birvae) are in ``ops/cuda_train_vae.py``; the policy here covers them and
:func:`build_fused_many_steps` hands them on.

:func:`gan_chunk` runs `steps` outer steps — ``d_steps`` critic updates
on fresh batches, then one G update against the post-update critic, the
optimizer (Adam or RMSprop) for D and then for G, wgan's clip of every
critic tensor after each critic update, fishergan's multiplier ``lam``
descending after each critic update, one metrics row of 8 lanes a step —
on pre-gathered streams, and updates the 8 state tensors' planes in
place (Adam: parameters, ``mu``, ``nu``; RMSprop: parameters and ``nu``).
On a CUDA tensor it launches the hand-written Hopper kernel
``csrc/gan_chunk.cu`` (one cooperative launch per call; one library per
critic hook, built at its first use) or raises; on a CPU tensor it runs
:func:`gan_chunk_plain`, the same hand-derived math in torch matmuls,
which is also the kernel's oracle on the card. ``launches`` counts the
kernel's launches.

The metrics lanes are the TPU kernel's: 0 ``d_loss``, 1 and 2 the real
and fake logit means (fishergan: ``ipm``, ``omega``), 3 ``g_loss``, 6
fishergan's ``constraint``, 7 ``lam`` after the step's last critic
update (zero elsewhere); lanes 4 and 5 belong to the gradient-penalty
variants and stay zero.

The state planes are at their true widths (no 128-lane padding), so the
TPU kernel's padded-lane hazards (``pallas_train.py:92-102``) do not
arise. The gradient-penalty variants (wgangp, dragan), cgan, began and
infogan, the G-EMA plane and the bf16 path are not ported yet
(ROADMAP.md Queue 2 item 6): :func:`fused_step_supported` refuses them
with that reason.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Dict, List, Optional, Tuple

import torch

from generative_models_tpu_torch.train.optim import RMS_DECAY, RMS_EPS
from generative_models_tpu_torch.train.step import (
    batches_per_step,
    gather_streams,
    pick_sub,
    stream_bytes_per_step,
)

SOURCE = "generative_models_tpu_torch/csrc/gan_chunk.cu"
# variant -> the critic hook its kernel is compiled for (GM_HOOK in the
# source: one library a hook, an Adam and an RMSprop kernel in each)
HOOKS: Dict[str, str] = {
    "nsgan": "bce", "mmgan": "bce", "lsgan": "ls", "wgan": "w", "fgan": "f",
    "ragan": "ra", "fishergan": "fi"}
HOOK_IDS = {"bce": 0, "ls": 1, "w": 2, "f": 3, "ra": 4, "fi": 5}
FGAN_DIV_IDS = {"total_variation": 0, "kl": 1, "reverse_kl": 2, "pearson": 3,
                "squared_hellinger": 4, "jensen_shannon": 5, "gan": 6}
GAN_VARIANTS = tuple(HOOKS)
FUSED_VARIANTS = GAN_VARIANTS + ("vae", "birvae")
METRIC_LANES = 8
# resident blocks per SM of the cooperative grid (at most what fits)
BLOCKS_PER_SM = 2
_QUEUED = "ROADMAP.md Queue 2 item 6"

launches = 0


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

    def __post_init__(self):
        if self.variant not in HOOKS:
            raise ValueError(f"gan_chunk covers {GAN_VARIANTS}, not "
                             f"{self.variant!r}")
        if self.optimizer not in ("adam", "rmsprop"):
            raise ValueError(f"unknown optimizer {self.optimizer!r}")
        if self.fgan_div not in FGAN_DIV_IDS:
            raise ValueError(f"unknown f-divergence {self.fgan_div!r}")

    @classmethod
    def from_config(cls, cfg) -> "ChunkHyper":
        v = cfg.variant
        return cls(cfg.g_lr, cfg.d_lr, cfg.adam_b1, cfg.adam_b2,
                   cfg.adam_eps, cfg.leaky_slope, v, cfg.optimizer,
                   cfg.wgan_clip if v == "wgan" else 0.0,
                   cfg.fgan_divergence,
                   v == "fgan" and cfg.fgan_g_loss == "nonsaturating",
                   cfg.fisher_rho if v == "fishergan" else 0.0)

    @property
    def adam(self) -> bool:
        return self.optimizer == "adam"


def state_planes(state) -> Tuple[List[torch.Tensor],
                                 Optional[List[torch.Tensor]],
                                 List[torch.Tensor]]:
    """(params, mu, nu): 8 tensors each, in the kernel's order g_w1 g_b1
    g_w2 g_b2 d_w1 d_b1 d_w2 d_b2; `mu` is None for an RMSprop state."""
    def flat(g, d):
        return [l[k] for l in list(g) + list(d) for k in ("w", "b")]
    g_opt, d_opt = state["g_opt"], state["d_opt"]
    return (flat(state["g_params"], state["d_params"]),
            flat(g_opt["mu"], d_opt["mu"]) if "mu" in g_opt else None,
            flat(g_opt["nu"], d_opt["nu"]))


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


def _d_hook(hp: ChunkHyper, lr, lf, lam, inv_b: float):
    """dL_D/dlogit of the real and fake logits [B, 1] and the critic's
    metrics (``_make_variant_hooks``' d_hook): returns (glr, glf,
    [d_loss, lane 1, lane 2], lane 6, lam after this update). `lam` is
    fishergan's multiplier before the update."""
    v = hp.variant
    zero = torch.zeros((), dtype=lr.dtype, device=lr.device)
    lanes12 = [lr.sum() * inv_b, lf.sum() * inv_b]
    aux6 = zero
    if v in ("nsgan", "mmgan"):
        glr = (torch.sigmoid(lr) - 1.0) * inv_b
        glf = torch.sigmoid(lf) * inv_b
        d_loss = (_softplus(-lr).sum() + _softplus(lf).sum()) * inv_b
    elif v == "lsgan":
        glr = (lr - 1.0) * inv_b
        glf = lf * inv_b
        d_loss = (0.5 * ((lr - 1.0) ** 2).sum() + 0.5 * (lf * lf).sum()) * inv_b
    elif v == "wgan":
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


def _g_hook(hp: ChunkHyper, lf2, lr2, inv_b: float):
    """(dL_G/dlf2 [B, 1], g_loss) — ``_make_variant_hooks``' g_hook.
    `lr2` (ragan only): the post-update critic on the last real batch."""
    v = hp.variant
    if v == "nsgan":
        return ((torch.sigmoid(lf2) - 1.0) * inv_b,
                _softplus(-lf2).sum() * inv_b)
    if v == "mmgan":
        return -torch.sigmoid(lf2) * inv_b, -_softplus(lf2).sum() * inv_b
    if v == "lsgan":
        return (lf2 - 1.0) * inv_b, 0.5 * ((lf2 - 1.0) ** 2).sum() * inv_b
    if v in ("wgan", "fishergan"):
        return torch.full_like(lf2, -inv_b), -lf2.sum() * inv_b
    if v == "fgan":
        gf, gfp, fstar, fstarp = _FGAN_TABLE[hp.fgan_div]
        t_f2 = gf(lf2)
        if hp.fgan_ns:
            return -gfp(lf2) * inv_b, -t_f2.sum() * inv_b
        return (-fstarp(t_f2) * gfp(lf2) * inv_b,
                -fstar(t_f2).sum() * inv_b)
    # ragan: only lf2 depends on G:
    # dL_G/dlf2_k = (sig(df2_k) - 1)/B - mean(sig(dr2))/B
    dr2 = lr2 - lf2.sum() * inv_b
    df2 = lf2 - lr2.sum() * inv_b
    abar = torch.sigmoid(dr2).sum() * inv_b
    return (((torch.sigmoid(df2) - 1.0) - abar) * inv_b,
            (_softplus(-df2).sum() + _softplus(dr2).sum()) * inv_b)


def _watch(probe: Optional[dict], u) -> None:
    """Tie probe: keeps the smallest |pre-activation| of a hidden layer
    relative to that layer's root mean square, as a tensor under
    ``probe["margin"]``. A ReLU / LeakyReLU input within float32 rounding
    of zero takes the other branch in another arithmetic, so a check that
    holds two versions together wants data whose margin is well above
    that."""
    if probe is None:
        return
    m = u.abs().min() / u.pow(2).mean().sqrt()
    probe["margin"] = torch.minimum(probe["margin"], m) \
        if "margin" in probe else m


def gan_chunk_plain(xs, zd, zg, p, mu, nu, *, steps: int, ds: int,
                    batch: int, t_g: int, t_d: int, hp: ChunkHyper,
                    lam=0.0, probe: Optional[dict] = None) -> torch.Tensor:
    """The kernel's function in plain PyTorch, in the dtype of its
    inputs (float32, or float64 as the kernel's oracle). Updates `p`,
    `mu`, `nu` (lists of 8 tensors, :func:`state_planes` order; `mu`
    None with RMSprop) in place and returns the metrics rows [steps, 8]
    (lanes: see the module docstring). `lam` is fishergan's multiplier
    before the chunk; after it, it is lane 7 of the last row. With a
    `probe` dict, records the tie margin (:func:`_watch`)."""
    w1g, b1g, w2g, b2g, w1d, b1d, w2d, b2d = p
    inv_b = 1.0 / batch
    s = hp.slope
    lam = torch.as_tensor(lam, dtype=xs.dtype, device=xs.device)

    def leaky(u):
        _watch(probe, u)
        return torch.where(u >= 0, u, s * u)

    def relu(u):
        _watch(probe, u)
        return torch.clamp_min(u, 0.0)

    def dleaky(h):
        return torch.where(h >= 0, 1.0, s)

    def update(q, g, lr, t):
        if hp.adam:
            _adam_(p[q], mu[q], nu[q], g, lr, t, hp)
        else:
            _rmsprop_(p[q], nu[q], g, lr)
        if q >= 4 and hp.clip > 0.0:  # wgan: every critic tensor
            p[q].clamp_(-hp.clip, hp.clip)

    def d_update(x, z, td, lam):
        hgd = relu(z @ w1g + b1g)
        fake = torch.sigmoid(hgd @ w2g + b2g)
        hr = leaky(x @ w1d + b1d)
        lr = hr @ w2d + b2d
        hf = leaky(fake @ w1d + b1d)
        lf = hf @ w2d + b2d
        glr, glf, row, aux6, lam = _d_hook(hp, lr, lf, lam, inv_b)
        dw2 = hr.t() @ glr + hf.t() @ glf
        db2 = (glr + glf).sum(0)
        dhr = (glr * w2d.t()) * dleaky(hr)
        dhf = (glf * w2d.t()) * dleaky(hf)
        dw1 = x.t() @ dhr + fake.t() @ dhf
        db1 = (dhr + dhf).sum(0)
        for q, g in zip(range(4, 8), (dw1, db1, dw2, db2)):
            update(q, g, hp.d_lr, td)
        return row, aux6, lam

    metrics = torch.zeros((steps, METRIC_LANES), dtype=torch.float32,
                          device=xs.device)
    zero = torch.zeros((), dtype=xs.dtype, device=xs.device)
    for k in range(steps):
        for i in range(ds):
            r0 = (k * ds + i) * batch
            x = xs[r0:r0 + batch]
            row, aux6, lam = d_update(x, zd[r0:r0 + batch],
                                      float(t_d + k * ds + i + 1), lam)
        z = zg[k * batch:(k + 1) * batch]
        hg = relu(z @ w1g + b1g)
        fake2 = torch.sigmoid(hg @ w2g + b2g)
        hf2 = leaky(fake2 @ w1d + b1d)
        lf2 = hf2 @ w2d + b2d
        lr2 = None
        if hp.variant == "ragan":  # the post-update critic on the last x
            lr2 = leaky(x @ w1d + b1d) @ w2d + b2d
        gl, g_loss = _g_hook(hp, lf2, lr2, inv_b)
        dh2 = (gl * w2d.t()) * dleaky(hf2)
        dx = dh2 @ w1d.t()
        gu2 = (dx * fake2) * (1.0 - fake2)
        dw2g = hg.t() @ gu2
        db2g = gu2.sum(0)
        dhg = (gu2 @ w2g.t()) * (hg > 0).to(xs.dtype)
        dw1g = z.t() @ dhg
        db1g = dhg.sum(0)
        for q, g in zip(range(4), (dw1g, db1g, dw2g, db2g)):
            update(q, g, hp.g_lr, float(t_g + k + 1))
        metrics[k] = torch.stack(row + [g_loss, zero, zero, aux6,
                                        lam if hp.variant == "fishergan"
                                        else zero])
    return metrics


# ---------------------------------------------------------------------
# The kernel
# ---------------------------------------------------------------------

class _Hyper(ctypes.Structure):
    """``GanChunkHyper`` of csrc/gan_chunk.cu, field for field."""
    _fields_ = ([(n, ctypes.c_int) for n in (
        "steps", "ds", "B", "Z", "H", "X", "Hd", "t_g", "t_d", "rmsprop",
        "alt", "div")] + [(n, ctypes.c_float) for n in (
            "g_lr", "d_lr", "b1", "b2", "omb1", "omb2", "eps", "log_b1",
            "log_b2", "slope", "inv_b", "clip", "rho")])


def bind(lib) -> None:
    """The C interface of a library built from csrc/gan_chunk.cu."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.gm_gan_chunk.argtypes = [p, p, p, ctypes.POINTER(p), p, p, p,
                                 ctypes.POINTER(_Hyper), i, p]
    lib.gm_gan_chunk.restype = i
    lib.gm_gan_chunk_scratch_floats.argtypes = [i] * 5
    lib.gm_gan_chunk_scratch_floats.restype = ctypes.c_longlong
    lib.gm_gan_chunk_grid.argtypes = [i, i]
    lib.gm_gan_chunk_grid.restype = i
    lib.gm_gan_chunk_hook.argtypes = []
    lib.gm_gan_chunk_hook.restype = i


@functools.cache
def _lib(hook: str):
    from generative_models_tpu_torch.ops.build import build_library
    lib = build_library(f"gan_chunk_{hook}", ["gan_chunk.cu"],
                        headers=["chunk_common.cuh"],
                        flags=(f"-DGM_HOOK={HOOK_IDS[hook]}",))
    bind(lib)
    if lib.gm_gan_chunk_hook() != HOOK_IDS[hook]:
        raise RuntimeError(f"gan_chunk: the library built for hook {hook!r} "
                           f"reports hook {lib.gm_gan_chunk_hook()}")
    return lib


def build(hook: Optional[str] = None) -> None:
    """Compile (or load) the kernel's library for `hook` (see
    :data:`HOOKS`) now instead of at first use; every hook's when None."""
    for h in ([hook] if hook else HOOK_IDS):
        _lib(h)


def hyper_struct(hp: ChunkHyper, *, steps, ds, batch, z, h, x, hd, t_g,
                 t_d) -> _Hyper:
    """`hp` and the chunk's sizes and counts as the kernel takes them."""
    return _Hyper(
        steps=steps, ds=ds, B=batch, Z=z, H=h, X=x, Hd=hd, t_g=t_g, t_d=t_d,
        rmsprop=int(not hp.adam),
        alt=int(hp.variant == "mmgan" or (hp.variant == "fgan"
                                          and hp.fgan_ns)),
        div=FGAN_DIV_IDS[hp.fgan_div], g_lr=hp.g_lr, d_lr=hp.d_lr, b1=hp.b1,
        b2=hp.b2, omb1=1.0 - hp.b1, omb2=1.0 - hp.b2, eps=hp.eps,
        log_b1=math.log(hp.b1), log_b2=math.log(hp.b2), slope=hp.slope,
        inv_b=1.0 / batch, clip=hp.clip, rho=hp.fisher_rho)


def _check(xs, zd, zg, p, mu, nu, steps, ds, batch, hp):
    planes = [("p", p), ("nu", nu)] + ([("mu", mu)] if hp.adam else [])
    if not hp.adam and mu is not None:
        raise ValueError("gan_chunk: an RMSprop state has no mu plane")
    if any(pl is None or len(pl) != 8 for _, pl in planes):
        raise ValueError("gan_chunk takes 8 tensors a state plane "
                         "(parameters, nu, and with Adam mu)")
    z, h = p[0].shape
    x, hd = p[4].shape
    want = [(z, h), (h,), (h, x), (x,), (x, hd), (hd,), (hd, 1), (1,)]
    for name, pl in planes:
        for q, t in enumerate(pl):
            if tuple(t.shape) != want[q]:
                raise ValueError(f"gan_chunk: {name}{q} must be {want[q]}, "
                                 f"got {tuple(t.shape)}")
    rows = steps * ds * batch
    for name, t, shape in (("xs", xs, (rows, x)), ("zd", zd, (rows, z)),
                           ("zg", zg, (steps * batch, z))):
        if tuple(t.shape) != shape:
            raise ValueError(f"gan_chunk: {name} must be {shape}, got "
                             f"{tuple(t.shape)}")
    for t in [xs, zd, zg] + [t for _, pl in planes for t in pl]:
        if t.dtype != torch.float32 or t.device != xs.device:
            raise TypeError(f"gan_chunk takes float32 tensors on one device; "
                            f"got {t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError("gan_chunk takes contiguous tensors")


def gan_chunk(xs, zd, zg, p, mu, nu, *, steps: int, ds: int, batch: int,
              t_g: int, t_d: int, hp: ChunkHyper, lam=0.0) -> torch.Tensor:
    """Run `steps` outer steps on the streams ``xs [steps*ds*B, X]``,
    ``zd [steps*ds*B, Z]``, ``zg [steps*B, Z]``; `t_g`/`t_d` are the Adam
    counts before the chunk (unused with RMSprop, whose `mu` is None);
    `lam` (a float or a 0-dim tensor) is fishergan's multiplier before
    the chunk. Updates the state planes in place and returns the metrics
    rows [steps, 8]; lane 7 of the last row is `lam` after the chunk. CPU
    tensors run :func:`gan_chunk_plain`; CUDA tensors launch the kernel
    on the current stream or raise."""
    global launches
    _check(xs, zd, zg, p, mu, nu, steps, ds, batch, hp)
    if xs.device.type == "cpu":
        return gan_chunk_plain(xs, zd, zg, p, mu, nu, steps=steps, ds=ds,
                               batch=batch, t_g=t_g, t_d=t_d, hp=hp, lam=lam)
    if xs.device.type != "cuda":
        raise ValueError(f"gan_chunk runs on cuda or cpu tensors, not "
                         f"{xs.device}")
    z, h = p[0].shape
    x, hd = p[4].shape
    lib = _lib(HOOKS[hp.variant])
    with torch.cuda.device(xs.device):
        metrics = torch.zeros((steps, METRIC_LANES), dtype=torch.float32,
                              device=xs.device)
        lam_buf = torch.as_tensor(lam, dtype=torch.float32,
                                  device=xs.device).reshape(1).clone()
        scratch = torch.empty(
            lib.gm_gan_chunk_scratch_floats(batch, z, h, x, hd),
            dtype=torch.float32, device=xs.device)
        grid = lib.gm_gan_chunk_grid(BLOCKS_PER_SM, int(not hp.adam))
        if grid < 1:
            raise RuntimeError("gan_chunk: the occupancy query failed")
        ptrs = [t.data_ptr() for t in p]
        ptrs += [t.data_ptr() for t in mu] if hp.adam else [None] * 8
        ptrs += [t.data_ptr() for t in nu]
        state = (ctypes.c_void_p * 24)(*ptrs)
        hyper = hyper_struct(hp, steps=steps, ds=ds, batch=batch, z=z, h=h,
                             x=x, hd=hd, t_g=t_g, t_d=t_d)
        stream = torch.cuda.current_stream(xs.device).cuda_stream
        rc = lib.gm_gan_chunk(
            xs.data_ptr(), zd.data_ptr(), zg.data_ptr(), state,
            scratch.data_ptr(), metrics.data_ptr(), lam_buf.data_ptr(),
            ctypes.byref(hyper), grid, stream)
    if rc != 0:
        raise RuntimeError(f"gan_chunk kernel launch failed: CUDA error {rc}")
    launches += 1
    return metrics


# ---------------------------------------------------------------------
# The trainer-facing builder and its policy
# ---------------------------------------------------------------------

def fused_step_supported(spec, cfg) -> Tuple[bool, str]:
    """(ok, reason): the chunk kernels cover nsgan, mmgan, lsgan, wgan,
    fgan, ragan and fishergan (the default activations, Adam or RMSprop,
    any d_steps), vae (the Bernoulli decoder) and birvae (mse or bce),
    both with Adam, on the MLP stacks in float32 with no EMA; everything
    else keeps the general step."""
    v = cfg.variant
    if v not in FUSED_VARIANTS:
        return False, (f"the chunk kernel covers {FUSED_VARIANTS} only so "
                       f"far; {v} is queued ({_QUEUED})")
    if cfg.arch != "mlp":
        return False, "the chunk kernel covers the mlp stacks only"
    if v in ("vae", "birvae") and cfg.optimizer != "adam":
        return False, f"the {v} chunk kernel is adam-only"
    if cfg.dtype == "bfloat16":  # "auto" is float32 in the port
        return False, (f"the chunk kernel's bf16 path is not ported yet "
                       f"({_QUEUED})")
    if v == "vae":
        if cfg.vae_recon != "bce":
            return False, ("the vae chunk kernel covers the Bernoulli (bce) "
                           "decoder")
    elif v != "birvae" and (cfg.g_hidden_act != "relu"
                            or cfg.d_hidden_act != "leaky_relu"):
        return False, ("the chunk kernel hand-derives the default "
                       "activations (G relu / D leaky_relu)")
    if cfg.ema_decay > 0:
        return False, (f"the chunk kernel's EMA plane is not ported yet "
                       f"({_QUEUED})")
    if cfg.spectral_projection:
        return False, "the chunk kernel excludes the spectral projection hook"
    if cfg.dp > 1 or cfg.tp > 1:
        return False, "the chunk kernel is single-device"
    return True, ""


def resolve_fused_step(spec, cfg, device) -> bool:
    """``Config.fused_step`` ("auto" | bool) as a choice: True forces the
    chunk (the kernel on CUDA, its plain version on the CPU); False the
    general step; "auto" the kernel only on a CUDA device where
    :func:`fused_step_supported` says yes — the general step otherwise
    and always on the CPU, as the reference keeps the XLA step off the
    TPU. The reference's list of variants measured to win on a TPU is
    not carried over: no measured policy picks between the two paths on
    this card yet (ROADMAP.md Queue 1 item 13)."""
    if cfg.fused_step is True:
        return True
    if cfg.fused_step != "auto":
        return False
    return (torch.device(device).type == "cuda"
            and fused_step_supported(spec, cfg)[0])


def _clone(params):
    return [{k: v.clone() for k, v in l.items()} for l in params]


def _clone_opt(opt, updates: int):
    """A copy of an optimizer state for the kernel to update in place,
    its count (Adam's) advanced by the chunk's updates."""
    new = {k: _clone(opt[k]) for k in ("mu", "nu") if k in opt}
    if "count" in opt:
        new["count"] = opt["count"] + updates
    return new


def named_metrics(variant: str, m: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The metrics rows [steps, 8] under the reference's names for
    `variant` (``pallas_train.py:1268-1333``)."""
    out = {"d_loss": m[:, 0], "g_loss": m[:, 3]}
    if variant == "wgan":
        out["w_estimate"] = -m[:, 0]
    elif variant == "fgan":
        out["f_bound"] = -m[:, 0]
    elif variant == "fishergan":
        out.update(ipm=m[:, 1], omega=m[:, 2], constraint=m[:, 6],
                   vstate_lam=m[:, 7])
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
    in the new state's ``vstate``. For a single-model spec (vae, birvae)
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
    fisher = cfg.variant == "fishergan"

    def many_steps(state, images, labels, perm_stack, rel_offsets, noise):
        steps = rel_offsets.shape[0]
        sub = pick_sub(steps, stream_bytes_per_step(cfg))
        g_opt, d_opt = state["g_opt"], state["d_opt"]
        new = dict(state, g_params=_clone(state["g_params"]),
                   d_params=_clone(state["d_params"]),
                   g_opt=_clone_opt(g_opt, steps),
                   d_opt=_clone_opt(d_opt, steps * ds),
                   step=state["step"] + steps)
        p, mu, nu = state_planes(new)
        t_g, t_d = ((int(g_opt["count"]), int(d_opt["count"])) if hp.adam
                    else (0, 0))
        lam = state["vstate"]["lam"] if fisher else 0.0
        rows = []
        for k0 in range(0, steps, sub):
            xs, _ = gather_streams(images, labels, perm_stack,
                                   rel_offsets[k0:k0 + sub], rows_per_step,
                                   rows_per_epoch)
            z_d, z_g = noise(k0, sub)
            rows.append(gan_chunk(
                xs.reshape(sub * rows_per_step, -1).contiguous(),
                z_d.reshape(sub * rows_per_step, -1).contiguous(),
                z_g.reshape(sub * b, -1).contiguous(), p, mu, nu,
                steps=sub, ds=ds, batch=b, t_g=t_g + k0, t_d=t_d + k0 * ds,
                hp=hp, lam=lam))
            if fisher:  # the multiplier rides out through lane 7
                lam = rows[-1][-1, 7]
        if fisher:
            new["vstate"] = {"lam": lam.clone()}
        return new, named_metrics(cfg.variant, torch.cat(rows))

    return many_steps
