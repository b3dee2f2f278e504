"""The train step and the multi-step chunk — the port of
``generative_models_tpu/train/step.py``: the adversarial step and the
single-model step (the VAE family).

One step runs ``d_steps`` critic updates, each on a fresh batch, then one
G update on the LAST critic batch against the post-update critic (the
reference order). The step takes its noise explicitly (``z_d [d_steps,
B, z]``, ``z_g [B, z]``, and for a gradient-penalty head the penalty's
draw ``aux_d [d_steps, B, 1]`` (wgangp's eps) or ``[d_steps, B, X]``
(dragan's u)); infogan's z rows are its code rows, z ⊕ onehot(cat) ⊕
cont (``losses/infogan.py``): torch cannot reproduce JAX's threefry
draws, so tests hand the same noise to both packages, and the Trainer
draws it from its own generators, on a fixed grid of blocks
(:func:`grid_noise`) so that each step's noise is a function of the
run's ``rng`` words and the global step alone. Inside a critic update
the G forward builds no graph (JAX
differentiates ``d_params`` only there); the G update differentiates
``g_params`` only. On the card every MLP forward and backward goes
through the whole-MLP kernels (``ops/cuda_mlp.py::MLPFunction``): at
d_steps 1 a step launches the forward kernel 5 times and the backward
kernel 4 times. The one exception is the penalty's critic pass, which
must be twice differentiable and runs as plain torch ops
(``ops/penalty.py``), once per critic update.

A single-model step (:func:`build_single_step`) takes one batch and one
noise tensor ``eps [B, lanes]`` (``spec.draw_noise``'s: the VAE family's
``[B, latent]``; DDPM's and flow's ``[B, image_dim + 2]``, the noise, t
and the label-drop uniform), differentiates ``spec.loss`` over the
whole parameter tree, applies the optimizer at ``g_lr`` and updates the
EMA. Given a ``torch.Generator`` in place of the noise tensor (one a
step, seeded from the run's ``rng`` words and the global step), the loss
draws its own noise from it: on the card that is how the VAE's sampling
kernel (``ops/cuda_reparam.py``) runs in training, and a VAE step then
launches the forward kernel 4 times, the backward kernel 4 times and
the sampling kernel once; a DDPM or flow step launches each MLP kernel
8 times on the MLP net and 7 on the UNet (its dense layers; its
convolutions are cuDNN's).

:func:`build_many_steps` is the chunk: a Python loop over the chunk's
steps that gathers each step's batches from the epoch-permutation stack
exactly as the reference's ``gather`` does. The chunk kernel's builder
(``ops/cuda_train.py::build_fused_many_steps``) shares its contract,
its gather and its sub-chunking, so the two paths see the same batches
and the same noise.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, List, Tuple, Union

import numpy as np
import torch

from generative_models_tpu_torch.data.mnist import INV_255
from generative_models_tpu_torch.ops.penalty import aux_lanes
from generative_models_tpu_torch.ops.spectral import (
    amortized_sn,
    init_sn_vectors,
    project_spectral,
    project_spectral_amortized,
)
from generative_models_tpu_torch.train.optim import apply_opt, init_opt
from generative_models_tpu_torch.utils import spans
from generative_models_tpu_torch.utils.tree import (
    tree_leaves,
    tree_map,
    tree_unflatten,
)

State = Dict[str, object]
# noise(k0, n) for steps k0 .. k0+n-1 of a chunk. Adversarial: (z_d [n,
# d_steps, B, z], z_g [n, B, z]), and for a gradient-penalty head a third
# tensor, the penalty's draw aux_d [n, d_steps, B, lanes] (ops/penalty.py
# aux_lanes).
# Single model: eps [n, B, lanes] (``spec.draw_noise``: the VAE family's
# latent noise; diffusion's noise, t and label-drop uniform), or a list of
# n torch.Generators, one a step, from which that step's loss draws its
# own noise.
Noise = Callable[[int, int], Union[Tuple[torch.Tensor, ...], torch.Tensor,
                                   List[torch.Generator]]]

# Steps of noise a block of the noise grid holds (grid_noise).
NOISE_BLOCK = 64

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
    """float32 bytes of one step's streams as the chunk kernel takes them.
    Adversarial: d_steps batches of images and of critic noise, one batch
    of G noise (cgan: each row with its one-hot label; infogan: with its
    codes), and a penalty head's draw per critic batch. Single model
    (`spec` not adversarial): one batch of images (reflow's pair rows
    twice as wide) and of the step's noise (``spec.step_lanes``)."""
    b = cfg.batch_size
    if spec is not None and not spec.adversarial:
        x = cfg.image_dim * (2 if cfg.flow_reflow else 1)
        return 4 * b * (x + spec.step_lanes(cfg))
    ds = max(cfg.d_steps, 1)
    n_cls = cfg.num_classes if cfg.variant == "cgan" else 0
    zin = noise_lanes(cfg) + n_cls
    lanes = aux_lanes(cfg.variant, cfg.image_dim)
    return 4 * (ds * b * (cfg.image_dim + n_cls + zin + lanes) + b * zin)


# ------------------------------------------------------------------
# State construction
# ------------------------------------------------------------------

def init_adversarial_state(spec, cfg, gen: torch.Generator,
                           device="cpu") -> State:
    """G and D drawn from `gen` (G first), fresh optimizer states, step 0
    and the two ``rng`` words (uint32) that seed the run's noise
    (:func:`noise_generator`). The variant's carried scalars (``vstate``:
    0-dim float32 tensors) live on `device` too. The EMA of G starts at
    G. With the amortized spectral projection the state also carries
    ``sn_v`` (``ops/spectral.py::init_sn_vectors`` at the init critic)."""
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
        st["g_ema"] = tree_map(lambda t: t, g_params)
    if amortized_sn(cfg):
        # the carried power-iteration vectors (ops/spectral.py), burned in
        # at the init weights
        st["sn_v"] = init_sn_vectors(d_params, cfg.sn_iters)
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


def _mix64(x: int) -> int:
    """splitmix64's finaliser: every output bit depends on every input bit."""
    x = (x + 0x9E3779B97F4A7C15) % 2 ** 64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) % 2 ** 64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) % 2 ** 64
    return x ^ (x >> 31)


def noise_generator(rng_words, index: int, device) -> torch.Generator:
    """A generator seeded from the state's two ``rng`` words and `index`
    (a block of the noise grid, or a step). The seed is mixed so that its
    low 32 bits, all the CPU generator keeps, depend on both words and the
    index."""
    w = [int(v) for v in np.asarray(rng_words, dtype=np.uint32)]
    seed = _mix64(((w[0] << 32) | w[1]) ^ _mix64(index % 2 ** 64))
    seed ^= seed >> 32
    return torch.Generator(device=device).manual_seed(seed % 2 ** 63)


def grid_noise(rng_words, first_step: int, n: int, device, draw,
               shard: Tuple[int, int] = (0, 1)):
    """The noise of global steps first_step .. first_step+n-1 on a fixed
    grid: block j holds steps j*NOISE_BLOCK .. (j+1)*NOISE_BLOCK-1 and is
    drawn whole by ``draw(gen, NOISE_BLOCK)`` (a tensor, or a tuple of
    tensors, each with a leading dim of one row a step) from
    ``noise_generator(rng_words, j)``; the blocks that overlap the steps
    are drawn and the steps sliced out. So a step's noise depends on
    (rng, step) alone, not on where its chunk or sub-chunk starts: a run
    split into two ``train`` calls, or resumed at any step, draws the
    numbers the uninterrupted run drew. Under data parallelism `shard`
    is (rank, world): each tensor's batch dim (the second to last) is
    the global batch, and the rank keeps its rows rank*b .. rank*b+b-1
    (b = batch / world), so a rank's noise is a function of (rng, step,
    rank), and the ranks together draw the single-device run's noise."""
    s = NOISE_BLOCK
    j0, j1 = first_step // s, (first_step + n - 1) // s
    blocks = [draw(noise_generator(rng_words, j, device), s)
              for j in range(j0, j1 + 1)]
    lo = first_step - j0 * s
    rank, world = shard

    def cut(parts):
        t = torch.cat(parts)[lo:lo + n]
        if world == 1:
            return t
        b = t.shape[-2] // world
        return t.narrow(-2, rank * b, b).contiguous()
    if isinstance(blocks[0], torch.Tensor):
        return cut(blocks)
    return tuple(cut(parts) for parts in zip(*blocks))


def chunk_noise(spec, cfg, rng_words, first_step: int, n: int, device,
                fused: bool, shard: Tuple[int, int] = (0, 1)):
    """Noise of `n` steps from global step `first_step`, on the noise
    grid (:func:`grid_noise`: a block of NOISE_BLOCK steps drawn whole
    from one generator seeded by the ``rng`` words and the block's
    index). A block's adversarial streams, in this order: z_d [S,
    d_steps, B, z] (infogan: code rows, z then the cat indices then
    cont); for a gradient-penalty head the penalty's uniform draw aux_d
    [S, d_steps, B, lanes] (wgangp's eps, 1 lane; dragan's u, image_dim);
    then z_g [S, B, z] (infogan: code rows). A single model's:
    ``spec.draw_noise``'s rows [S, B, lanes] (the VAE family's eps;
    DDPM's and flow's noise, t and label-drop uniform); for its general
    step (not `fused`) on the card, one generator a step instead, seeded
    from the ``rng`` words and the step, from which that step's loss
    draws (the VAE's in its sampling kernel). `shard` is (rank, world) of
    a data group."""
    dev = torch.device(device)
    if not spec.adversarial:
        if dev.type == "cuda" and not fused:
            # (indices past every grid block: no seed is shared; a
            # rank's own generator a step)
            return [noise_generator(
                rng_words, ~((first_step + k) * shard[1] + shard[0]), dev)
                for k in range(n)]
        return grid_noise(
            rng_words, first_step, n, dev,
            lambda gen, s: spec.draw_noise(gen, (s, cfg.batch_size), cfg,
                                           dev), shard)
    ds, b = max(cfg.d_steps, 1), cfg.batch_size
    lanes = aux_lanes(cfg.variant, cfg.image_dim)

    def draw(gen, s):
        z_d = draw_z(gen, (s, ds, b), cfg, dev)
        aux_d = (torch.rand((s, ds, b, lanes), generator=gen,
                            device=dev) if lanes else None)
        z_g = draw_z(gen, (s, b), cfg, dev)
        return (z_d, z_g) if aux_d is None else (z_d, z_g, aux_d)
    return grid_noise(rng_words, first_step, n, dev, draw, shard)


def noise_lanes(cfg) -> int:
    """Lanes of a z row: z_dim, and infogan's codes after it."""
    if cfg.variant == "infogan":
        return cfg.z_dim + cfg.info_cat_dim + cfg.info_cont_dim
    return cfg.z_dim


def draw_z(gen: torch.Generator, lead, cfg, device) -> torch.Tensor:
    """z rows [*lead, noise_lanes(cfg)] from `gen`: N(0, I), or infogan's
    code rows (``losses/infogan.py::draw_codes``)."""
    if cfg.variant == "infogan":
        from generative_models_tpu_torch.losses.infogan import draw_codes
        return draw_codes(gen, lead, cfg, device)
    return torch.randn(tuple(lead) + (cfg.z_dim,), generator=gen,
                       device=gen.device).to(device)


# ------------------------------------------------------------------
# The step
# ------------------------------------------------------------------

def _leaves_requiring_grad(params):
    return tree_unflatten(params, [t.detach().requires_grad_(True)
                                   for t in tree_leaves(params)])


def _grads(loss, params):
    return tree_unflatten(params, list(torch.autograd.grad(
        loss, tree_leaves(params))))


def _ema_update(ema, params, decay: float):
    """ema <- decay * ema + (1 - decay) * params, leafwise (float32)."""
    d = torch.tensor(decay, dtype=torch.float32,
                     device=tree_leaves(params)[0].device)
    return tree_map(lambda e, p: e * d + p * (1.0 - d), ema, params)


def reduce_mean(group, grads, metrics):
    """(grads, metrics) averaged over the data group's ranks — a tree of
    gradients and a dict of 0-dim metrics, in ONE all-reduce of a flat
    buffer — or as they are without a group."""
    metrics = {k: v.detach() for k, v in metrics.items()}
    if group is None:
        return grads, metrics
    leaves = tree_leaves(grads)
    keys = list(metrics)
    flat = torch.cat([t.reshape(-1) for t in leaves]
                     + [metrics[k].reshape(1).to(leaves[0].dtype)
                        for k in keys])
    group.all_reduce_mean_(flat)
    parts = flat.split([t.numel() for t in leaves] + [1] * len(keys))
    grads = tree_unflatten(grads, [p.view(t.shape)
                                   for p, t in zip(parts, leaves)])
    return grads, {k: p.reshape(()) for k, p in zip(keys,
                                                    parts[len(leaves):])}


def autograd_grads(spec, cfg, group=None):
    """The general step's gradient source for
    :func:`build_adversarial_step`: ``(d_grads, g_grads)`` with
    ``d_grads(d_params, g_params, batch, z, aux, vstate)`` and
    ``g_grads(g_params, d_params, batch, z, vstate)``, each returning
    (a gradient tree, a dict of 0-dim metrics): autograd through the
    variant's loss, then with a data group (``parallel/mesh.py``; the
    reference's `axis_name`) the local gradients and metrics averaged
    over the ranks (:func:`reduce_mean`); a batch-coupled loss then takes
    its statistics over the global batch."""
    d_loss_fn, g_loss_fn = spec.d_loss, spec.g_loss
    if spec.batch_coupled and group is not None:
        d_loss_fn = functools.partial(d_loss_fn, group=group)
        g_loss_fn = functools.partial(g_loss_fn, group=group)

    def d_grads(d_params, g_params, batch, z, aux, vstate):
        dp = _leaves_requiring_grad(d_params)
        extra = {} if aux is None else {"aux": aux}
        loss, metrics = d_loss_fn(dp, g_params, batch, None, vstate, cfg,
                                  z=z, **extra)
        return reduce_mean(group, _grads(loss, dp), metrics)

    def g_grads(g_params, d_params, batch, z, vstate):
        gp = _leaves_requiring_grad(g_params)
        loss, metrics = g_loss_fn(gp, d_params, batch, None, vstate, cfg,
                                  z=z)
        return reduce_mean(group, _grads(loss, gp), metrics)

    return d_grads, g_grads


def build_adversarial_step(spec, cfg, group=None, grads=None):
    """Returns ``train_step(state, d_batches, z_d, z_g, aux_d=None) ->
    (state, metrics)``; `d_batches` holds tensors with leading dims
    [d_steps, B]; `aux_d` is a penalty head's draw [d_steps, B, lanes].
    With a data group the batches and noise are the rank's shard.
    `grads` is where each update's gradients come from: a pair as
    :func:`autograd_grads` returns (its default), or the phase kernels'
    (``ops/cuda_dp.py::phase_grads``). The optimizer, ``spec.d_post``,
    the state hooks and the EMA are the same for every source.

    With ``cfg.spectral_projection`` the critic is projected after each
    update, as the reference composes it (``ops/spectral.py``):
    ``sn_mode="fresh"`` after ``spec.d_post``, ``"amortized"`` after the
    state hook, refining the carried ``state["sn_v"]``, which the new
    state holds. Under a data group every rank computes the same vectors
    from the same parameters; under tp each from the whole weights
    (``parallel/tp.py::on_whole_weights``)."""
    d_steps = max(cfg.d_steps, 1)
    d_grads, g_grads = grads or autograd_grads(spec, cfg, group)
    carried = amortized_sn(cfg)
    fresh, amortized = project_spectral, project_spectral_amortized
    if cfg.tp > 1:  # each rank holds slices: project the whole weights
        from generative_models_tpu_torch.parallel.tp import on_whole_weights
        fresh, amortized = map(on_whole_weights, (fresh, amortized))
    d_post = spec.d_post
    if cfg.spectral_projection and not carried:
        def d_post(p, c, _base=spec.d_post):
            return fresh(_base(p, c), c.sn_target, c.sn_iters)

    def train_step(state: State, d_batches, z_d, z_g,
                   aux_d=None) -> Tuple[State, Dict]:
        g_params = state["g_params"]
        d_params, d_opt, vstate = (state["d_params"], state["d_opt"],
                                   state["vstate"])
        sn_v = state["sn_v"] if carried else None
        for i in range(d_steps):
            batch = {k: v[i] for k, v in d_batches.items()}
            grads_d, d_metrics = d_grads(
                d_params, g_params, batch, z_d[i],
                None if aux_d is None else aux_d[i], vstate)
            d_params, d_opt = apply_opt(cfg, d_params, grads_d, d_opt,
                                        cfg.d_lr)
            d_params = d_post(d_params, cfg)
            vstate = spec.d_state_update(vstate, d_metrics, cfg)
            if carried:
                d_params, sn_v = amortized(d_params, sn_v, cfg.sn_target)

        g_batch = {k: v[-1] for k, v in d_batches.items()}
        grads_g, g_metrics = g_grads(g_params, d_params, g_batch, z_g,
                                     vstate)
        new_g, g_opt = apply_opt(cfg, g_params, grads_g, state["g_opt"],
                                 cfg.g_lr)
        vstate = spec.step_state_update(vstate, d_metrics, g_metrics, cfg)

        new_state = dict(state, g_params=new_g, d_params=d_params,
                         g_opt=g_opt, d_opt=d_opt, vstate=vstate,
                         step=state["step"] + 1)
        if cfg.ema_decay > 0:
            new_state["g_ema"] = _ema_update(state["g_ema"], new_g,
                                             cfg.ema_decay)
        if carried:
            new_state["sn_v"] = sn_v
        metrics = {**d_metrics, **g_metrics}
        for k, v in vstate.items():
            metrics[f"vstate_{k}"] = v
        return new_state, metrics

    return train_step


def build_single_step(spec, cfg, group=None):
    """Returns ``train_step(state, batches, noise) -> (state, metrics)``;
    `batches` holds tensors with leading dims [1, B] (uniform with the
    adversarial layout); `noise` is ``eps [B, latent]`` or a
    ``torch.Generator`` the loss draws from. `group`: as
    :func:`build_adversarial_step`'s."""
    loss_fn = spec.loss
    if spec.batch_coupled and group is not None:
        loss_fn = functools.partial(loss_fn, group=group)

    def train_step(state: State, batches, noise) -> Tuple[State, Dict]:
        batch = {k: v[0] for k, v in batches.items()}
        params = state["params"]
        leaves = [t.detach().requires_grad_(True)
                  for t in tree_leaves(params)]
        p = tree_unflatten(params, leaves)
        if isinstance(noise, torch.Generator):
            loss, metrics = loss_fn(p, batch, noise, cfg)
        else:
            loss, metrics = loss_fn(p, batch, None, cfg, eps=noise)
        # a leaf the loss leaves out (vqprior's frozen tokenizer) gets a
        # zero gradient, as the reference's stop_gradient gives it
        grads, metrics = reduce_mean(group, tree_unflatten(
            params, list(torch.autograd.grad(
                loss, leaves, allow_unused=True, materialize_grads=True))),
            metrics)
        new_p, opt = apply_opt(cfg, params, grads, state["opt"], cfg.g_lr)
        new_state = dict(state, params=new_p, opt=opt, step=state["step"] + 1)
        if cfg.ema_decay > 0:
            new_state["ema"] = _ema_update(state["ema"], new_p, cfg.ema_decay)
        return new_state, metrics

    return train_step


def build_step(spec, cfg, group=None):
    if spec.adversarial:
        return build_adversarial_step(spec, cfg, group)
    return build_single_step(spec, cfg, group)


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
            with spans.span("chunk.gather"):
                xs, ys = gather_streams(images, labels, perm_stack,
                                        rel_offsets[k0:k0 + sub],
                                        rows_per_step, rows_per_epoch)
            with spans.span("chunk.noise"):
                drawn = noise(k0, sub)
            for k in range(sub):
                batches = {"image": xs[k].reshape(nb, bsz, -1),
                           "label": ys[k].reshape(nb, bsz)}
                if spec.adversarial:
                    state, m = train_step(state, batches,
                                          *[d[k] for d in drawn])
                else:
                    state, m = train_step(state, batches, drawn[k])
                for key, v in m.items():
                    hist.setdefault(key, []).append(v)
        return state, {k: torch.stack(v) for k, v in hist.items()}

    return many_steps
