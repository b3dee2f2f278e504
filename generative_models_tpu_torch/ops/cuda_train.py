"""Whole-chunk G+D training in one kernel launch — the port of
``generative_models_tpu/ops/pallas_train.py`` for nsgan and mmgan
(``_make_kernel`` with ``_fused_chunk_call``, ``build_fused_many_steps``,
``fused_step_supported``, ``resolve_fused_step``). The single-model
family's chunk kernels (vae, birvae) are in ``ops/cuda_train_vae.py``;
the policy here covers them and :func:`build_fused_many_steps` hands
them on.

:func:`gan_chunk` runs `steps` outer steps — ``d_steps`` critic updates
on fresh batches, then one G update against the post-update critic, Adam
for D and then for G, one metrics row a step — on pre-gathered streams,
and updates the 8 state tensors' parameter, ``mu`` and ``nu`` planes in
place. On a CUDA tensor it launches the hand-written Hopper kernel
``csrc/gan_chunk.cu`` (one cooperative launch per call) or raises; on a
CPU tensor it runs :func:`gan_chunk_plain`, the same hand-derived math
in torch matmuls, which is also the kernel's oracle on the card.
``launches`` counts the kernel's launches.

The state planes are at their true widths (no 128-lane padding), so the
TPU kernel's padded-lane hazards (``pallas_train.py:92-102``) do not
arise. The chunk's other variants, its G-EMA plane and its bf16 path
are not ported yet (ROADMAP.md Queue 2 item 6): :func:`fused_step_supported`
refuses them with that reason.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import List, Tuple

import torch

from generative_models_tpu_torch.train.step import (
    batches_per_step,
    gather_streams,
    pick_sub,
    stream_bytes_per_step,
)

SOURCE = "generative_models_tpu_torch/csrc/gan_chunk.cu"
FUSED_VARIANTS = ("nsgan", "mmgan", "vae", "birvae")
# resident blocks per SM of the cooperative grid (at most what fits)
BLOCKS_PER_SM = 2
_QUEUED = "ROADMAP.md Queue 2 item 6"

launches = 0


@dataclasses.dataclass(frozen=True)
class ChunkHyper:
    """The chunk's hyperparameters (Adam and the G head)."""

    g_lr: float
    d_lr: float
    b1: float
    b2: float
    eps: float
    slope: float
    mmgan: bool

    @classmethod
    def from_config(cls, cfg) -> "ChunkHyper":
        return cls(cfg.g_lr, cfg.d_lr, cfg.adam_b1, cfg.adam_b2,
                   cfg.adam_eps, cfg.leaky_slope, cfg.variant == "mmgan")


def state_planes(state) -> Tuple[List[torch.Tensor], List[torch.Tensor],
                                 List[torch.Tensor]]:
    """(params, mu, nu): 8 tensors each, in the kernel's order g_w1 g_b1
    g_w2 g_b2 d_w1 d_b1 d_w2 d_b2."""
    def flat(g, d):
        return [l[k] for l in list(g) + list(d) for k in ("w", "b")]
    return (flat(state["g_params"], state["d_params"]),
            flat(state["g_opt"]["mu"], state["d_opt"]["mu"]),
            flat(state["g_opt"]["nu"], state["d_opt"]["nu"]))


# ---------------------------------------------------------------------
# Plain version
# ---------------------------------------------------------------------

def _adam_(p, mu, nu, g, lr: float, t: float, hp: ChunkHyper) -> None:
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


def _softplus(u):
    return torch.clamp_min(u, 0.0) + torch.log1p(torch.exp(-torch.abs(u)))


def gan_chunk_plain(xs, zd, zg, p, mu, nu, *, steps: int, ds: int,
                    batch: int, t_g: int, t_d: int,
                    hp: ChunkHyper) -> torch.Tensor:
    """The kernel's function in plain PyTorch. Updates `p`, `mu`, `nu`
    (lists of 8 tensors, :func:`state_planes` order) in place and returns
    the metrics rows [steps, 4]: d_loss, d_real, d_fake, g_loss."""
    w1g, b1g, w2g, b2g, w1d, b1d, w2d, b2d = p
    inv_b = 1.0 / batch
    s = hp.slope

    def leaky(u):
        return torch.where(u >= 0, u, s * u)

    def dleaky(h):
        return torch.where(h >= 0, 1.0, s)

    def d_update(x, z, td):
        hgd = torch.clamp_min(z @ w1g + b1g, 0.0)
        fake = torch.sigmoid(hgd @ w2g + b2g)
        hr = leaky(x @ w1d + b1d)
        lr = hr @ w2d + b2d
        hf = leaky(fake @ w1d + b1d)
        lf = hf @ w2d + b2d
        glr = (torch.sigmoid(lr) - 1.0) * inv_b
        glf = torch.sigmoid(lf) * inv_b
        row = [(_softplus(-lr).sum() + _softplus(lf).sum()) * inv_b,
               lr.sum() * inv_b, lf.sum() * inv_b]
        dw2 = hr.t() @ glr + hf.t() @ glf
        db2 = (glr + glf).sum(0)
        dhr = (glr * w2d.t()) * dleaky(hr)
        dhf = (glf * w2d.t()) * dleaky(hf)
        dw1 = x.t() @ dhr + fake.t() @ dhf
        db1 = (dhr + dhf).sum(0)
        for q, g in zip(range(4, 8), (dw1, db1, dw2, db2)):
            _adam_(p[q], mu[q], nu[q], g, hp.d_lr, td, hp)
        return row

    metrics = torch.zeros((steps, 4), dtype=torch.float32, device=xs.device)
    for k in range(steps):
        for i in range(ds):
            r0 = (k * ds + i) * batch
            row = d_update(xs[r0:r0 + batch], zd[r0:r0 + batch],
                           float(t_d + k * ds + i + 1))
        z = zg[k * batch:(k + 1) * batch]
        hg = torch.clamp_min(z @ w1g + b1g, 0.0)
        fake2 = torch.sigmoid(hg @ w2g + b2g)
        hf2 = leaky(fake2 @ w1d + b1d)
        lf2 = hf2 @ w2d + b2d
        if hp.mmgan:
            gl = -torch.sigmoid(lf2) * inv_b
            g_loss = -_softplus(lf2).sum() * inv_b
        else:
            gl = (torch.sigmoid(lf2) - 1.0) * inv_b
            g_loss = _softplus(-lf2).sum() * inv_b
        dh2 = (gl * w2d.t()) * dleaky(hf2)
        dx = dh2 @ w1d.t()
        gu2 = (dx * fake2) * (1.0 - fake2)
        dw2g = hg.t() @ gu2
        db2g = gu2.sum(0)
        dhg = (gu2 @ w2g.t()) * (hg > 0).to(torch.float32)
        dw1g = z.t() @ dhg
        db1g = dhg.sum(0)
        for q, g in zip(range(4), (dw1g, db1g, dw2g, db2g)):
            _adam_(p[q], mu[q], nu[q], g, hp.g_lr, float(t_g + k + 1), hp)
        metrics[k] = torch.stack(row + [g_loss])
    return metrics


# ---------------------------------------------------------------------
# The kernel
# ---------------------------------------------------------------------

@functools.cache
def _lib():
    from generative_models_tpu_torch.ops.build import build_library
    lib = build_library("gan_chunk", ["gan_chunk.cu"],
                        headers=["chunk_common.cuh"])
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.gm_gan_chunk.argtypes = ([p, p, p, ctypes.POINTER(p), p, p]
                                 + [i] * 9 + [f] * 11 + [i, i, p])
    lib.gm_gan_chunk.restype = i
    lib.gm_gan_chunk_scratch_floats.argtypes = [i] * 5
    lib.gm_gan_chunk_scratch_floats.restype = ctypes.c_longlong
    lib.gm_gan_chunk_grid.argtypes = [i]
    lib.gm_gan_chunk_grid.restype = i
    return lib


def build() -> None:
    """Compile (or load) the kernel's library now instead of at first use."""
    _lib()


def _check(xs, zd, zg, p, mu, nu, steps, ds, batch):
    if len(p) != 8 or len(mu) != 8 or len(nu) != 8:
        raise ValueError("gan_chunk takes 8 parameter, mu and nu tensors")
    z, h = p[0].shape
    x, hd = p[4].shape
    want = [(z, h), (h,), (h, x), (x,), (x, hd), (hd,), (hd, 1), (1,)]
    for name, t in ([(f"p{q}", t) for q, t in enumerate(p)]
                    + [(f"mu{q}", t) for q, t in enumerate(mu)]
                    + [(f"nu{q}", t) for q, t in enumerate(nu)]):
        if tuple(t.shape) != want[int(name[-1])]:
            raise ValueError(f"gan_chunk: {name} must be "
                             f"{want[int(name[-1])]}, got {tuple(t.shape)}")
    rows = steps * ds * batch
    for name, t, shape in (("xs", xs, (rows, x)), ("zd", zd, (rows, z)),
                           ("zg", zg, (steps * batch, z))):
        if tuple(t.shape) != shape:
            raise ValueError(f"gan_chunk: {name} must be {shape}, got "
                             f"{tuple(t.shape)}")
    for t in [xs, zd, zg, *p, *mu, *nu]:
        if t.dtype != torch.float32 or t.device != xs.device:
            raise TypeError(f"gan_chunk takes float32 tensors on one device; "
                            f"got {t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError("gan_chunk takes contiguous tensors")


def gan_chunk(xs, zd, zg, p, mu, nu, *, steps: int, ds: int, batch: int,
              t_g: int, t_d: int, hp: ChunkHyper) -> torch.Tensor:
    """Run `steps` outer steps on the streams ``xs [steps*ds*B, X]``,
    ``zd [steps*ds*B, Z]``, ``zg [steps*B, Z]``; `t_g`/`t_d` are the Adam
    counts before the chunk. Updates the state planes in place and returns
    the metrics rows [steps, 4]. CPU tensors run :func:`gan_chunk_plain`;
    CUDA tensors launch the kernel on the current stream or raise."""
    global launches
    _check(xs, zd, zg, p, mu, nu, steps, ds, batch)
    if xs.device.type == "cpu":
        return gan_chunk_plain(xs, zd, zg, p, mu, nu, steps=steps, ds=ds,
                               batch=batch, t_g=t_g, t_d=t_d, hp=hp)
    if xs.device.type != "cuda":
        raise ValueError(f"gan_chunk runs on cuda or cpu tensors, not "
                         f"{xs.device}")
    z, h = p[0].shape
    x, hd = p[4].shape
    lib = _lib()
    metrics = torch.empty((steps, 4), dtype=torch.float32, device=xs.device)
    with torch.cuda.device(xs.device):
        scratch = torch.empty(
            lib.gm_gan_chunk_scratch_floats(batch, z, h, x, hd),
            dtype=torch.float32, device=xs.device)
        grid = lib.gm_gan_chunk_grid(BLOCKS_PER_SM)
        if grid < 1:
            raise RuntimeError("gan_chunk: the occupancy query failed")
        state = (ctypes.c_void_p * 24)(*[t.data_ptr() for t in p + mu + nu])
        stream = torch.cuda.current_stream(xs.device).cuda_stream
        rc = lib.gm_gan_chunk(
            xs.data_ptr(), zd.data_ptr(), zg.data_ptr(), state,
            scratch.data_ptr(), metrics.data_ptr(), steps, ds, batch, z, h, x,
            hd, t_g, t_d, hp.g_lr, hp.d_lr, hp.b1, hp.b2, 1.0 - hp.b1,
            1.0 - hp.b2, hp.eps, math.log(hp.b1), math.log(hp.b2), hp.slope,
            1.0 / batch, int(hp.mmgan), grid, stream)
    if rc != 0:
        raise RuntimeError(f"gan_chunk kernel launch failed: CUDA error {rc}")
    launches += 1
    return metrics


# ---------------------------------------------------------------------
# The trainer-facing builder and its policy
# ---------------------------------------------------------------------

def fused_step_supported(spec, cfg) -> Tuple[bool, str]:
    """(ok, reason): the chunk kernels cover nsgan and mmgan (the default
    activations, any d_steps), vae (the Bernoulli decoder) and birvae
    (mse or bce), on the MLP stacks with Adam, float32 and no EMA;
    everything else keeps the general step."""
    if cfg.variant not in FUSED_VARIANTS:
        return False, (f"the chunk kernel covers {FUSED_VARIANTS} only so "
                       f"far; {cfg.variant} is queued ({_QUEUED})")
    if cfg.arch != "mlp":
        return False, "the chunk kernel covers the mlp stacks only"
    if cfg.optimizer != "adam":
        return False, f"the chunk kernel is adam-only so far ({_QUEUED})"
    if cfg.dtype == "bfloat16":  # "auto" is float32 in the port
        return False, (f"the chunk kernel's bf16 path is not ported yet "
                       f"({_QUEUED})")
    if cfg.variant == "vae":
        if cfg.vae_recon != "bce":
            return False, ("the vae chunk kernel covers the Bernoulli (bce) "
                           "decoder")
    elif cfg.variant != "birvae" and (cfg.g_hidden_act != "relu"
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
    TPU. No measured policy picks between them yet (ROADMAP.md Queue 1
    item 13)."""
    if cfg.fused_step is True:
        return True
    if cfg.fused_step != "auto":
        return False
    return (torch.device(device).type == "cuda"
            and fused_step_supported(spec, cfg)[0])


def _clone(params):
    return [{k: v.clone() for k, v in l.items()} for l in params]


def build_fused_many_steps(spec, cfg, steps_per_epoch: int):
    """The chunk kernel's counterpart of ``train.step.build_many_steps``,
    with the same contract and the same gather and sub-chunking, so both
    see the same batches and noise: ``many_steps(state, images, labels,
    perm_stack, rel_offsets, noise) -> (state, metrics)``. The caller's
    state is not modified (the kernel updates copies in place). For a
    single-model spec (vae, birvae) this is ``ops/cuda_train_vae.py``'s
    function, whose `noise` gives ``eps [n, B, latent]``."""
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

    def many_steps(state, images, labels, perm_stack, rel_offsets, noise):
        steps = rel_offsets.shape[0]
        sub = pick_sub(steps, stream_bytes_per_step(cfg))
        g_opt, d_opt = state["g_opt"], state["d_opt"]
        new = dict(state, g_params=_clone(state["g_params"]),
                   d_params=_clone(state["d_params"]),
                   g_opt={"count": g_opt["count"] + steps,
                          "mu": _clone(g_opt["mu"]),
                          "nu": _clone(g_opt["nu"])},
                   d_opt={"count": d_opt["count"] + steps * ds,
                          "mu": _clone(d_opt["mu"]),
                          "nu": _clone(d_opt["nu"])},
                   step=state["step"] + steps)
        p, mu, nu = state_planes(new)
        t_g, t_d = int(g_opt["count"]), int(d_opt["count"])
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
                hp=hp))
        m = torch.cat(rows)
        return new, {"d_loss": m[:, 0], "d_real": m[:, 1],
                     "d_fake": m[:, 2], "g_loss": m[:, 3]}

    return many_steps
