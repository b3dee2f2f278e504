"""Whole-chunk VAE and BIR-VAE training in one kernel launch — the port
of ``generative_models_tpu/ops/pallas_train.py``'s single-model family
(``_make_vae_kernel`` with ``_fused_vae_chunk_call``,
``_make_birvae_kernel`` with ``_fused_birvae_chunk_call``,
``build_fused_vae_many_steps``, ``build_fused_birvae_many_steps``).

:func:`vae_chunk` and :func:`birvae_chunk` run `steps` training steps —
encoder, sampling with streamed noise, decoder, the hand-derived
backward, Adam on every tensor, one metrics row a step — on pre-gathered
streams, and update the state tensors' parameter, ``mu`` and ``nu``
planes in place. On a CUDA tensor each launches the hand-written Hopper
kernel ``csrc/vae_chunk.cu`` (one source, the BIR-VAE a compile-time
variant; one cooperative launch per call) or raises; on a CPU tensor it
runs :func:`vae_chunk_plain` / :func:`birvae_chunk_plain`, the same
hand-derived math in torch matmuls, which is also the kernel's oracle on
the card. ``launches`` and ``birvae_launches`` count the launches.

State planes are at their true widths, so the TPU kernels' row, column
and bias-row masks have no counterpart. The EMA plane and the bf16 path
are not ported yet (ROADMAP.md Queue 2 item 6):
``ops/cuda_train.py::fused_step_supported`` refuses them.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import List, Optional

import torch

from generative_models_tpu_torch.ops.cuda_train import (
    BLOCKS_PER_SM,
    _adam_,
    _softplus,
    _watch,
    fused_step_supported,
)
from generative_models_tpu_torch.train.step import (
    gather_streams,
    pick_sub,
    stream_bytes_per_step,
)
from generative_models_tpu_torch.utils.tree import tree_map

SOURCE = "generative_models_tpu_torch/csrc/vae_chunk.cu"
BN_EPS = 1e-5
METRIC_KEYS = {"vae": ("loss", "recon_loss", "kl_loss"),
               "birvae": ("loss", "recon_loss", "latent_power")}

launches = 0
birvae_launches = 0


@dataclasses.dataclass(frozen=True)
class VaeHyper:
    """The chunk's hyperparameters: Adam, the reconstruction loss and the
    BIR-VAE's channel noise."""

    lr: float
    b1: float
    b2: float
    eps: float
    recon: str = "bce"       # "bce" | "mse" (the VAE chunk: bce only)
    sigma_n: float = 0.0     # BIR-VAE only

    @classmethod
    def from_config(cls, cfg) -> "VaeHyper":
        from generative_models_tpu_torch.losses.birvae import noise_sigma
        return cls(cfg.g_lr, cfg.adam_b1, cfg.adam_b2, cfg.adam_eps,
                   cfg.vae_recon,
                   noise_sigma(cfg) if cfg.variant == "birvae" else 0.0)


def tree_planes(tree) -> List[torch.Tensor]:
    """A parameter tree's tensors in the kernel's order: VAE tr_w tr_b
    mu_w mu_b lv_w lv_b d1_w d1_b d2_w d2_b; BIR-VAE the same without the
    lv head."""
    if "encoder" in tree:
        enc = tree["encoder"]
        layers = [*enc["trunk"], enc["mu"], enc["logvar"], *tree["decoder"]]
        want = 5
    else:
        layers = [*tree["enc_trunk"], tree["enc_mu"], *tree["decoder"]]
        want = 4
    if len(layers) != want:
        raise ValueError("the chunk kernel takes a one-layer trunk and a "
                         "two-layer decoder")
    return [l[k] for l in layers for k in ("w", "b")]


def state_planes(state):
    """(params, mu, nu) of a single-model train state, kernel order."""
    return (tree_planes(state["params"]), tree_planes(state["opt"]["mu"]),
            tree_planes(state["opt"]["nu"]))


# ---------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------

def _recon(lg, x, inv_b: float, recon: str):
    """(mean summed reconstruction loss, its gradient in the logits)."""
    if recon == "bce":
        return ((_softplus(lg) - lg * x).sum() * inv_b,
                (torch.sigmoid(lg) - x) * inv_b)
    out = torch.sigmoid(lg)
    return (((out - x) * (out - x)).sum() * inv_b,
            ((2.0 * (out - x)) * out) * (1.0 - out) * inv_b)


def _decoder_backward(z, hd, glg, w_d1, w_d2):
    """dW2, db2, dW1, db1 and dz from the logits' gradient."""
    dw2 = hd.t() @ glg
    db2 = glg.sum(0)
    dhd = (glg @ w_d2.t()) * (hd > 0).to(hd.dtype)
    return dw2, db2, z.t() @ dhd, dhd.sum(0), dhd @ w_d1.t()


def _relu(u, probe):
    _watch(probe, u)
    return torch.clamp_min(u, 0.0)


def vae_chunk_plain(xs, eps_n, p, mu, nu, *, steps: int, batch: int, t: int,
                    hp: VaeHyper, probe: Optional[dict] = None) -> torch.Tensor:
    """The VAE kernel's function in plain PyTorch. Updates `p`, `mu`,
    `nu` (lists of 10 tensors, :func:`tree_planes` order) in place and
    returns the metrics rows [steps, 3]: loss, recon_loss, kl_loss. With
    a `probe` dict, records the tie margin of the two ReLU layers
    (``ops/cuda_train.py::_watch``)."""
    w_tr, b_tr, w_mu, b_mu, w_lv, b_lv, w_d1, b_d1, w_d2, b_d2 = p
    inv_b = 1.0 / batch
    metrics = torch.zeros((steps, 3), dtype=torch.float32, device=xs.device)
    for k in range(steps):
        x = xs[k * batch:(k + 1) * batch]
        ep = eps_n[k * batch:(k + 1) * batch]
        henc = _relu(x @ w_tr + b_tr, probe)
        m = henc @ w_mu + b_mu
        lv = henc @ w_lv + b_lv
        z = m + torch.exp(0.5 * lv) * ep
        hd = _relu(z @ w_d1 + b_d1, probe)
        lg = hd @ w_d2 + b_d2
        recon, glg = _recon(lg, x, inv_b, "bce")
        kl = -0.5 * (1.0 + lv - m * m - torch.exp(lv)).sum() * inv_b
        dw2, db2, dw1, db1, dz = _decoder_backward(z, hd, glg, w_d1, w_d2)
        g_mu = dz + m * inv_b
        g_lv = (dz * 0.5) * (z - m) + (0.5 * (torch.exp(lv) - 1.0)) * inv_b
        dhe = (g_mu @ w_mu.t() + g_lv @ w_lv.t()) * (henc > 0).to(henc.dtype)
        grads = (x.t() @ dhe, dhe.sum(0), henc.t() @ g_mu, g_mu.sum(0),
                 henc.t() @ g_lv, g_lv.sum(0), dw1, db1, dw2, db2)
        for q, g in enumerate(grads):
            _adam_(p[q], mu[q], nu[q], g, hp.lr, float(t + k + 1), hp)
        metrics[k] = torch.stack([recon + kl, recon, kl])
    return metrics


def birvae_chunk_plain(xs, eps_n, p, mu, nu, *, steps: int, batch: int,
                       t: int, hp: VaeHyper,
                       probe: Optional[dict] = None) -> torch.Tensor:
    """The BIR-VAE kernel's function in plain PyTorch. Updates `p`, `mu`,
    `nu` (lists of 8 tensors) in place and returns the metrics rows
    [steps, 3]: loss, recon_loss (the same), latent_power. The batch
    normalisation's backward is hand-derived:
    ``dmu = r (g - mean_B(g) - mu_hat mean_B(g mu_hat))``. `probe`: as
    :func:`vae_chunk_plain`."""
    w_tr, b_tr, w_mu, b_mu, w_d1, b_d1, w_d2, b_d2 = p
    inv_b = 1.0 / batch
    metrics = torch.zeros((steps, 3), dtype=torch.float32, device=xs.device)
    for k in range(steps):
        x = xs[k * batch:(k + 1) * batch]
        ep = eps_n[k * batch:(k + 1) * batch]
        henc = _relu(x @ w_tr + b_tr, probe)
        m = henc @ w_mu + b_mu
        mean = m.sum(0, keepdim=True) * inv_b
        var = torch.clamp_min((m * m).sum(0, keepdim=True) * inv_b
                              - mean * mean, 0.0)
        r = torch.rsqrt(var + BN_EPS)
        mu_hat = (m - mean) * r
        z = mu_hat + hp.sigma_n * ep
        hd = _relu(z @ w_d1 + b_d1, probe)
        lg = hd @ w_d2 + b_d2
        loss, glg = _recon(lg, x, inv_b, hp.recon)
        power = (mu_hat * mu_hat).sum() * inv_b / m.shape[1]
        dw2, db2, dw1, db1, dz = _decoder_backward(z, hd, glg, w_d1, w_d2)
        mg = dz.sum(0, keepdim=True) * inv_b
        mgy = (dz * mu_hat).sum(0, keepdim=True) * inv_b
        g_mu = r * (dz - mg - mu_hat * mgy)
        dhe = (g_mu @ w_mu.t()) * (henc > 0).to(henc.dtype)
        grads = (x.t() @ dhe, dhe.sum(0), henc.t() @ g_mu, g_mu.sum(0),
                 dw1, db1, dw2, db2)
        for q, g in enumerate(grads):
            _adam_(p[q], mu[q], nu[q], g, hp.lr, float(t + k + 1), hp)
        metrics[k] = torch.stack([loss, loss, power])
    return metrics


# ---------------------------------------------------------------------
# The kernel
# ---------------------------------------------------------------------

@functools.cache
def _lib():
    from generative_models_tpu_torch.ops.build import build_library
    lib = build_library("vae_chunk", ["vae_chunk.cu"],
                        headers=["chunk_common.cuh"])
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.gm_vae_chunk.argtypes = ([p, p, ctypes.POINTER(p), p, p]
                                 + [i] * 6 + [f] * 10 + [i, i, i, p])
    lib.gm_vae_chunk.restype = i
    lib.gm_vae_chunk_scratch_floats.argtypes = [i] * 4
    lib.gm_vae_chunk_scratch_floats.restype = ctypes.c_longlong
    lib.gm_vae_chunk_grid.argtypes = [i, i]
    lib.gm_vae_chunk_grid.restype = i
    return lib


def build() -> None:
    """Compile (or load) the kernel's library now instead of at first use."""
    _lib()


def _check(name, xs, eps_n, p, mu, nu, steps, batch, birvae):
    n = 8 if birvae else 10
    if len(p) != n or len(mu) != n or len(nu) != n:
        raise ValueError(f"{name} takes {n} parameter, mu and nu tensors")
    x, h = p[0].shape
    l = p[2].shape[1]
    heads = [(h, l), (l,)] * (1 if birvae else 2)
    want = [(x, h), (h,), *heads, (l, h), (h,), (h, x), (x,)]
    for plane, ts in (("p", p), ("mu", mu), ("nu", nu)):
        for q, t in enumerate(ts):
            if tuple(t.shape) != want[q]:
                raise ValueError(f"{name}: {plane}{q} must be {want[q]}, got "
                                 f"{tuple(t.shape)}")
    for label, t, shape in (("xs", xs, (steps * batch, x)),
                            ("eps_n", eps_n, (steps * batch, l))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: {label} must be {shape}, got "
                             f"{tuple(t.shape)}")
    for t in [xs, eps_n, *p, *mu, *nu]:
        if t.dtype != torch.float32 or t.device != xs.device:
            raise TypeError(f"{name} takes float32 tensors on one device; "
                            f"got {t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} takes contiguous tensors")
    return x, h, l


def _launch(xs, eps_n, p, mu, nu, steps, batch, t, hp, dims, birvae):
    x, h, l = dims
    lib = _lib()
    metrics = torch.empty((steps, 3), dtype=torch.float32, device=xs.device)

    def ptrs(ts):  # the BIR-VAE has no lv head: its two slots stay null
        v = [q.data_ptr() for q in ts]
        return v[:4] + [None, None] + v[4:] if birvae else v

    with torch.cuda.device(xs.device):
        scratch = torch.empty(lib.gm_vae_chunk_scratch_floats(batch, x, h, l),
                              dtype=torch.float32, device=xs.device)
        grid = lib.gm_vae_chunk_grid(BLOCKS_PER_SM, int(birvae))
        if grid < 1:
            raise RuntimeError("vae_chunk: the occupancy query failed")
        state = (ctypes.c_void_p * 30)(*(ptrs(p) + ptrs(mu) + ptrs(nu)))
        stream = torch.cuda.current_stream(xs.device).cuda_stream
        rc = lib.gm_vae_chunk(
            xs.data_ptr(), eps_n.data_ptr(), state, scratch.data_ptr(),
            metrics.data_ptr(), steps, batch, x, h, l, t, hp.lr, hp.b1, hp.b2,
            1.0 - hp.b1, 1.0 - hp.b2, hp.eps, math.log(hp.b1),
            math.log(hp.b2), 1.0 / batch, hp.sigma_n, int(hp.recon == "mse"),
            int(birvae), grid, stream)
    if rc != 0:
        raise RuntimeError(f"vae_chunk kernel launch failed: CUDA error {rc}")
    return metrics


def vae_chunk(xs, eps_n, p, mu, nu, *, steps: int, batch: int, t: int,
              hp: VaeHyper) -> torch.Tensor:
    """Run `steps` VAE steps on the streams ``xs [steps*B, X]`` and
    ``eps_n [steps*B, L]``; `t` is the Adam count before the chunk.
    Updates the state planes in place and returns the metrics rows
    [steps, 3]. CPU tensors run :func:`vae_chunk_plain`; CUDA tensors
    launch the kernel on the current stream or raise."""
    global launches
    if hp.recon != "bce":
        raise ValueError("vae_chunk covers the Bernoulli (bce) decoder only")
    dims = _check("vae_chunk", xs, eps_n, p, mu, nu, steps, batch, False)
    if xs.device.type == "cpu":
        return vae_chunk_plain(xs, eps_n, p, mu, nu, steps=steps, batch=batch,
                               t=t, hp=hp)
    if xs.device.type != "cuda":
        raise ValueError(f"vae_chunk runs on cuda or cpu tensors, not "
                         f"{xs.device}")
    metrics = _launch(xs, eps_n, p, mu, nu, steps, batch, t, hp, dims, False)
    launches += 1
    return metrics


def birvae_chunk(xs, eps_n, p, mu, nu, *, steps: int, batch: int, t: int,
                 hp: VaeHyper) -> torch.Tensor:
    """As :func:`vae_chunk` for the BIR-VAE (8 state tensors, ``hp.recon``
    "mse" or "bce", channel noise ``hp.sigma_n``)."""
    global birvae_launches
    if hp.recon not in ("bce", "mse"):
        raise ValueError(f"birvae_chunk: recon must be bce|mse, got "
                         f"{hp.recon!r}")
    dims = _check("birvae_chunk", xs, eps_n, p, mu, nu, steps, batch, True)
    if xs.device.type == "cpu":
        return birvae_chunk_plain(xs, eps_n, p, mu, nu, steps=steps,
                                  batch=batch, t=t, hp=hp)
    if xs.device.type != "cuda":
        raise ValueError(f"birvae_chunk runs on cuda or cpu tensors, not "
                         f"{xs.device}")
    metrics = _launch(xs, eps_n, p, mu, nu, steps, batch, t, hp, dims, True)
    birvae_launches += 1
    return metrics


# ---------------------------------------------------------------------
# What the trainer calls
# ---------------------------------------------------------------------

def build_fused_single_many_steps(spec, cfg, steps_per_epoch: int):
    """The single-model chunks' counterpart of
    ``train.step.build_many_steps``, with the same contract, gather and
    sub-chunking: ``many_steps(state, images, labels, perm_stack,
    rel_offsets, noise) -> (state, metrics)`` with ``noise(k0, n) -> eps
    [n, B, latent]``. The caller's state is not modified (the kernel
    updates copies in place)."""
    variant = cfg.variant
    if variant not in METRIC_KEYS:
        raise ValueError(f"no single-model chunk kernel for {variant!r}")
    ok, reason = fused_step_supported(spec, cfg)
    if not ok:
        raise ValueError(f"fused_step unsupported here: {reason}")
    chunk = vae_chunk if variant == "vae" else birvae_chunk
    keys = METRIC_KEYS[variant]
    b = cfg.batch_size
    rows_per_epoch = steps_per_epoch * b
    hp = VaeHyper.from_config(cfg)

    def many_steps(state, images, labels, perm_stack, rel_offsets, noise):
        steps = rel_offsets.shape[0]
        sub = pick_sub(steps, stream_bytes_per_step(cfg, spec))
        opt = state["opt"]
        clone = lambda tree: tree_map(torch.clone, tree)
        new = dict(state, params=clone(state["params"]),
                   opt={"count": opt["count"] + steps, "mu": clone(opt["mu"]),
                        "nu": clone(opt["nu"])},
                   step=state["step"] + steps)
        p, mu, nu = state_planes(new)
        t = int(opt["count"])
        rows = []
        for k0 in range(0, steps, sub):
            xs, _ = gather_streams(images, labels, perm_stack,
                                   rel_offsets[k0:k0 + sub], b, rows_per_epoch)
            eps_n = noise(k0, sub)
            rows.append(chunk(
                xs.reshape(sub * b, -1).contiguous(),
                eps_n.reshape(sub * b, -1).contiguous(), p, mu, nu,
                steps=sub, batch=b, t=t + k0, hp=hp))
        m = torch.cat(rows)
        return new, {key: m[:, i] for i, key in enumerate(keys)}

    return many_steps


def build_fused_vae_many_steps(spec, cfg, steps_per_epoch: int):
    """:func:`build_fused_single_many_steps` for the vae variant."""
    if cfg.variant != "vae":
        raise ValueError(f"build_fused_vae_many_steps trains vae, not {cfg.variant}")
    return build_fused_single_many_steps(spec, cfg, steps_per_epoch)


def build_fused_birvae_many_steps(spec, cfg, steps_per_epoch: int):
    """:func:`build_fused_single_many_steps` for the birvae variant."""
    if cfg.variant != "birvae":
        raise ValueError(f"build_fused_birvae_many_steps trains birvae, not {cfg.variant}")
    return build_fused_single_many_steps(spec, cfg, steps_per_epoch)
