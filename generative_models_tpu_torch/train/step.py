"""The train step and the multi-step chunk — the port of
``generative_models_tpu/train/step.py``: the adversarial step and the
single-model step (the VAE family).

One step runs ``d_steps`` critic updates, each on a fresh batch, then one
G update on the LAST critic batch against the post-update critic (the
reference order). The step takes its noise explicitly (``z_d [d_steps,
B, z]``, ``z_g [B, z]``): torch cannot reproduce JAX's threefry draws, so
tests hand the same noise to both packages, and the Trainer draws it from
its own generators. Inside a critic update the G forward builds no graph
(JAX differentiates ``d_params`` only there); the G update differentiates
``g_params`` only. On the card every MLP forward and backward goes
through the whole-MLP kernels (``ops/cuda_mlp.py::MLPFunction``): at
d_steps 1 a step launches the forward kernel 5 times and the backward
kernel 4 times.

A single-model step (:func:`build_single_step`) takes one batch and one
noise tensor ``eps [B, latent]``, differentiates ``spec.loss`` over the
whole parameter tree, applies the optimizer at ``g_lr`` and updates the
EMA. Given a ``torch.Generator`` in place of the noise tensor, the loss
draws its own noise from it: on the card that is how the VAE's sampling
kernel (``ops/cuda_reparam.py``) runs in training, and a VAE step then
launches the forward kernel 4 times, the backward kernel 4 times and
the sampling kernel once.

:func:`build_many_steps` is the chunk: a Python loop over the chunk's
steps that gathers each step's batches from the epoch-permutation stack
exactly as the reference's ``gather`` does. The chunk kernel's builder
(``ops/cuda_train.py::build_fused_many_steps``) shares its contract,
its gather and its sub-chunking, so the two paths see the same batches
and the same noise.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple, Union

import numpy as np
import torch

from generative_models_tpu_torch.data.mnist import INV_255
from generative_models_tpu_torch.train.optim import apply_opt, init_opt
from generative_models_tpu_torch.utils.tree import (
    tree_leaves,
    tree_map,
    tree_unflatten,
)

State = Dict[str, object]
# noise(k0, n) for steps k0 .. k0+n-1 of a chunk. Adversarial: (z_d [n,
# d_steps, B, z], z_g [n, B, z]). Single model: eps [n, B, latent], or a
# torch.Generator from which each step's loss draws its own noise.
Noise = Callable[[int, int], Union[Tuple[torch.Tensor, torch.Tensor],
                                   torch.Tensor, torch.Generator]]

# Cap on the bytes of the gathered batch and noise streams one chunk
# holds at once (the reference's _STREAM_BYTES_BUDGET): a longer chunk
# runs as sub-chunks, the largest divisor of its length that fits.
STREAM_BYTES_BUDGET = int(1.5 * 2 ** 30)


def pick_sub(steps: int, per_step_bytes: int) -> int:
    """Largest divisor of `steps` whose stream footprint fits the budget."""
    cap = max(1, STREAM_BYTES_BUDGET // max(per_step_bytes, 1))
    if steps <= cap:
        return steps
    for s in range(cap, 0, -1):
        if steps % s == 0:
            return s
    return 1


def stream_bytes_per_step(cfg, spec=None) -> int:
    """float32 bytes of one step's streams. Adversarial: d_steps batches
    of images and of critic noise, one batch of G noise. Single model
    (`spec` not adversarial): one batch of images and of latent noise."""
    b = cfg.batch_size
    if spec is not None and not spec.adversarial:
        return 4 * b * (cfg.image_dim + cfg.latent_dim)
    ds = max(cfg.d_steps, 1)
    return 4 * (ds * b * (cfg.image_dim + cfg.z_dim) + b * cfg.z_dim)


# ------------------------------------------------------------------
# State construction
# ------------------------------------------------------------------

def init_adversarial_state(spec, cfg, gen: torch.Generator,
                           device="cpu") -> State:
    """G and D drawn from `gen` (G first), fresh optimizer states, step 0
    and the two ``rng`` words (uint32) that seed the run's noise
    (:func:`noise_generator`). The variant's carried scalars (``vstate``:
    0-dim float32 tensors) live on `device` too. The EMA of G starts at
    G."""
    g_params = spec.init_g(gen, cfg, device=device)
    d_params = spec.init_d(gen, cfg, device=device)
    st: State = {
        "g_params": g_params,
        "d_params": d_params,
        "g_opt": init_opt(cfg, g_params),
        "d_opt": init_opt(cfg, d_params),
        "vstate": {k: v.to(device)
                   for k, v in spec.init_vstate(cfg).items()},
        "step": 0,
        "rng": _rng_words(cfg),
    }
    if cfg.ema_decay > 0:
        st["g_ema"] = [dict(l) for l in g_params]
    return st


def _rng_words(cfg) -> np.ndarray:
    return np.array([cfg.seed % 2 ** 32, 0x5EED], dtype=np.uint32)


def init_single_state(spec, cfg, gen: torch.Generator, device="cpu") -> State:
    """The model drawn from `gen`, a fresh optimizer state at ``g_lr``,
    step 0 and the two ``rng`` words; the EMA starts at the params."""
    params = spec.init_params(gen, cfg, device=device)
    st: State = {
        "params": params,
        "opt": init_opt(cfg, params),
        "step": 0,
        "rng": _rng_words(cfg),
    }
    if cfg.ema_decay > 0:
        st["ema"] = tree_map(lambda t: t, params)
    return st


def init_state(spec, cfg, gen: torch.Generator, device="cpu") -> State:
    if spec.adversarial:
        return init_adversarial_state(spec, cfg, gen, device)
    return init_single_state(spec, cfg, gen, device)


def batches_per_step(spec, cfg) -> int:
    """Epoch-permutation batches consumed per outer step: d_steps fresh
    critic batches (the G update reuses the last one)."""
    return max(cfg.d_steps, 1) if spec.adversarial else 1


def decode_images(x: torch.Tensor) -> torch.Tensor:
    """Post-gather decode of uint8-resident images: a float32 MULTIPLY by
    ``INV_255``, the same op as the host's ``to_flat_float``, so uint8
    storage trains bit-identically to float32 storage. Float inputs pass
    through unchanged."""
    if x.dtype == torch.uint8:
        return x.to(torch.float32) * torch.tensor(INV_255, device=x.device)
    return x


def noise_generator(rng_words, first_step: int, device) -> torch.Generator:
    """The generator of a sub-chunk's noise: seeded from the state's two
    ``rng`` words and the global step the sub-chunk starts at, so a run
    resumed from a checkpoint draws the noise the uninterrupted run drew."""
    w = [int(v) for v in np.asarray(rng_words, dtype=np.uint32)]
    seed = ((w[0] << 32) | w[1]) ^ ((first_step * 0x9E3779B97F4A7C15)
                                    % 2 ** 64)
    return torch.Generator(device=device).manual_seed(seed % 2 ** 63)


# ------------------------------------------------------------------
# The step
# ------------------------------------------------------------------

def _flat(params):
    return [l[k] for l in params for k in ("w", "b")]


def _unflat(flat):
    return [{"w": flat[i], "b": flat[i + 1]} for i in range(0, len(flat), 2)]


def _leaves_requiring_grad(params):
    return _unflat([t.detach().requires_grad_(True) for t in _flat(params)])


def _ema_update(ema, params, decay: float):
    """ema <- decay * ema + (1 - decay) * params, leafwise (float32)."""
    d = torch.tensor(decay, dtype=torch.float32,
                     device=tree_leaves(params)[0].device)
    return tree_map(lambda e, p: e * d + p * (1.0 - d), ema, params)


def build_adversarial_step(spec, cfg):
    """Returns ``train_step(state, d_batches, z_d, z_g) -> (state,
    metrics)``; `d_batches` holds tensors with leading dims [d_steps, B]."""
    d_steps = max(cfg.d_steps, 1)

    def d_update(d_params, d_opt, vstate, g_params, batch, z):
        dp = _leaves_requiring_grad(d_params)
        loss, metrics = spec.d_loss(dp, g_params, batch, None, vstate, cfg,
                                    z=z)
        grads = _unflat(list(torch.autograd.grad(loss, _flat(dp))))
        d_params, d_opt = apply_opt(cfg, d_params, grads, d_opt, cfg.d_lr)
        d_params = spec.d_post(d_params, cfg)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return d_params, d_opt, spec.d_state_update(vstate, metrics, cfg), \
            metrics

    def train_step(state: State, d_batches, z_d, z_g) -> Tuple[State, Dict]:
        g_params = state["g_params"]
        d_params, d_opt, vstate = (state["d_params"], state["d_opt"],
                                   state["vstate"])
        for i in range(d_steps):
            batch = {k: v[i] for k, v in d_batches.items()}
            d_params, d_opt, vstate, d_metrics = d_update(
                d_params, d_opt, vstate, g_params, batch, z_d[i])

        g_batch = {k: v[-1] for k, v in d_batches.items()}
        gp = _leaves_requiring_grad(g_params)
        g_loss, g_metrics = spec.g_loss(gp, d_params, g_batch, None, vstate,
                                        cfg, z=z_g)
        grads = _unflat(list(torch.autograd.grad(g_loss, _flat(gp))))
        new_g, g_opt = apply_opt(cfg, g_params, grads, state["g_opt"],
                                 cfg.g_lr)
        g_metrics = {k: v.detach() for k, v in g_metrics.items()}
        vstate = spec.step_state_update(vstate, d_metrics, g_metrics, cfg)

        new_state = dict(state, g_params=new_g, d_params=d_params,
                         g_opt=g_opt, d_opt=d_opt, vstate=vstate,
                         step=state["step"] + 1)
        if cfg.ema_decay > 0:
            new_state["g_ema"] = _ema_update(state["g_ema"], new_g,
                                             cfg.ema_decay)
        metrics = {**d_metrics, **g_metrics}
        for k, v in vstate.items():
            metrics[f"vstate_{k}"] = v
        return new_state, metrics

    return train_step


def build_single_step(spec, cfg):
    """Returns ``train_step(state, batches, noise) -> (state, metrics)``;
    `batches` holds tensors with leading dims [1, B] (uniform with the
    adversarial layout); `noise` is ``eps [B, latent]`` or a
    ``torch.Generator`` the loss draws from."""

    def train_step(state: State, batches, noise) -> Tuple[State, Dict]:
        batch = {k: v[0] for k, v in batches.items()}
        params = state["params"]
        leaves = [t.detach().requires_grad_(True)
                  for t in tree_leaves(params)]
        p = tree_unflatten(params, leaves)
        if isinstance(noise, torch.Generator):
            loss, metrics = spec.loss(p, batch, noise, cfg)
        else:
            loss, metrics = spec.loss(p, batch, None, cfg, eps=noise)
        grads = tree_unflatten(params, list(torch.autograd.grad(loss, leaves)))
        new_p, opt = apply_opt(cfg, params, grads, state["opt"], cfg.g_lr)
        new_state = dict(state, params=new_p, opt=opt, step=state["step"] + 1)
        if cfg.ema_decay > 0:
            new_state["ema"] = _ema_update(state["ema"], new_p, cfg.ema_decay)
        return new_state, {k: v.detach() for k, v in metrics.items()}

    return train_step


def build_step(spec, cfg):
    if spec.adversarial:
        return build_adversarial_step(spec, cfg)
    return build_single_step(spec, cfg)


# ------------------------------------------------------------------
# The chunk: many steps over minibatch offsets
# ------------------------------------------------------------------

def gather_streams(images, labels, perm_stack, rel_offsets, rows_per_step,
                   rows_per_epoch):
    """Every step's rows of a (sub-)chunk, as the reference's ``gather``:
    step k reads ``perm_stack[e, r : r + rows_per_step]`` with
    ``e, r = divmod(rel_offsets[k], rows_per_epoch)``. Returns decoded
    images [n, rows_per_step, D] and labels [n, rows_per_step]."""
    rel = rel_offsets.to(perm_stack.device, torch.int64)
    e = torch.div(rel, rows_per_epoch, rounding_mode="floor")
    r = rel - e * rows_per_epoch
    cols = r[:, None] + torch.arange(rows_per_step, device=rel.device)
    idx = perm_stack[e[:, None], cols].reshape(-1).to(images.device)
    n = rel.shape[0]
    x = decode_images(images.index_select(0, idx))
    return (x.reshape(n, rows_per_step, -1),
            labels.index_select(0, idx).reshape(n, rows_per_step))


def build_many_steps(spec, cfg, steps_per_epoch: int):
    """Returns ``many_steps(state, images, labels, perm_stack,
    rel_offsets, noise) -> (state, metrics)`` running
    ``len(rel_offsets)`` outer steps; metrics map to [steps] tensors.

    - `perm_stack` [E, N]: one epoch permutation per row, for the epochs
      the chunk touches (shuffle without replacement, tail dropped);
    - `rel_offsets[k]`: rows consumed before step k, relative to the
      first epoch of `perm_stack`;
    - `noise`: see :data:`Noise`; called once per sub-chunk.
    """
    train_step = build_step(spec, cfg)
    nb = batches_per_step(spec, cfg)
    bsz = cfg.batch_size
    rows_per_step = nb * bsz
    rows_per_epoch = steps_per_epoch * rows_per_step

    def many_steps(state, images, labels, perm_stack, rel_offsets,
                   noise: Noise):
        steps = rel_offsets.shape[0]
        sub = pick_sub(steps, stream_bytes_per_step(cfg, spec))
        hist: Dict[str, list] = {}
        for k0 in range(0, steps, sub):
            xs, ys = gather_streams(images, labels, perm_stack,
                                    rel_offsets[k0:k0 + sub], rows_per_step,
                                    rows_per_epoch)
            drawn = noise(k0, sub)
            for k in range(sub):
                batches = {"image": xs[k].reshape(nb, bsz, -1),
                           "label": ys[k].reshape(nb, bsz)}
                if spec.adversarial:
                    state, m = train_step(state, batches, drawn[0][k],
                                          drawn[1][k])
                elif isinstance(drawn, torch.Generator):
                    state, m = train_step(state, batches, drawn)
                else:
                    state, m = train_step(state, batches, drawn[k])
                for key, v in m.items():
                    hist.setdefault(key, []).append(v)
        return state, {k: torch.stack(v) for k, v in hist.items()}

    return many_steps
