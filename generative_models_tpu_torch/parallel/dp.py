"""Data parallelism over the data group — the port of
``generative_models_tpu/parallel/dp.py``.

Every rank holds the whole state and the whole dataset, gathers only ITS
rows of every minibatch (the rank-offset slice of the epoch
permutation, :func:`make_gather_local`), computes local gradients, and
averages them over the ranks before the optimizer, which then runs
identically on every rank (:func:`build_shard_map_many_steps`,
``train/step.py::build_step`` with a group). ``cfg.batch_size`` is the
GLOBAL batch and must divide by the world.

The reference has two implementations, ``dp_impl="jit"`` (XLA inserts
the all-reduce into one global computation) and ``"shard_map"`` (the
explicit collective). torch has no compiler that inserts a collective,
so both values of ``dp_impl`` take the explicit-collective step here;
the two are the same function in the reference (its tests hold them
equal), and a test holds them equal here.
"""

from __future__ import annotations

import torch

from generative_models_tpu_torch.train import step as step_lib


def make_gather_local(cfg, nb: int, steps_per_epoch: int, world: int,
                      rank: int):
    """Returns ``gather_local(images, labels, perm_stack, rel_offsets) ->
    (x [n, nb, b, D], y [n, nb, b])``: each of the chunk's n steps reads,
    for minibatch j, ``perm[r + j*B + rank*b + (0..b)]`` with ``e, r =
    divmod(rel_offsets[k], rows_per_epoch)`` and perm = perm_stack[e]
    (B the global batch, b = B / world), the reference's indices."""
    local_b = cfg.batch_size // world
    rows_per_epoch = steps_per_epoch * nb * cfg.batch_size

    def gather_local(images, labels, perm_stack, rel_offsets):
        rel = rel_offsets.to(perm_stack.device, torch.int64)
        e = torch.div(rel, rows_per_epoch, rounding_mode="floor")
        r = rel - e * rows_per_epoch
        cols = (r[:, None, None] + rank * local_b
                + torch.arange(nb, device=rel.device)[:, None]
                * cfg.batch_size
                + torch.arange(local_b, device=rel.device))
        idx = perm_stack[e[:, None, None], cols].reshape(-1).to(
            images.device)
        n = rel.shape[0]
        x = step_lib.decode_images(images.index_select(0, idx))
        return (x.reshape(n, nb, local_b, -1),
                labels.index_select(0, idx).reshape(n, nb, local_b))

    return gather_local


def check_divisible(cfg, world: int) -> int:
    """The local batch b = B / world; raises when B does not divide."""
    if cfg.batch_size % world != 0:
        raise ValueError(f"global batch {cfg.batch_size} not divisible by "
                         f"the data group's world {world}")
    return cfg.batch_size // world


def build_shard_map_many_steps(spec, cfg, steps_per_epoch: int, group,
                               train_step=None):
    """The explicit-collective twin of ``train.step.build_many_steps``:
    ``many_steps(state, images, labels, perm_stack, rel_offsets, noise) ->
    (state, metrics)``, with `noise` giving this rank's shard of each
    step's noise (``train/step.py::grid_noise`` with ``shard``). Each
    update's gradients and metrics are averaged over `group`'s ranks in
    one all-reduce (a batch-coupled loss adds its statistics' own).
    `train_step` (default: the general step with `group`) is the step it
    drives; the phase kernels' path passes its own
    (``ops/cuda_dp.py::build_fused_dp_many_steps``)."""
    check_divisible(cfg, group.world)
    nb = step_lib.batches_per_step(spec, cfg)
    train_step = train_step or step_lib.build_step(spec, cfg, group)
    gather_local = make_gather_local(cfg, nb, steps_per_epoch, group.world,
                                     group.rank)
    per_step = step_lib.stream_bytes_per_step(cfg, spec) // group.world

    def many_steps(state, images, labels, perm_stack, rel_offsets, noise):
        steps = rel_offsets.shape[0]
        sub = step_lib.pick_sub(steps, per_step)
        hist = {}
        for k0 in range(0, steps, sub):
            xs, ys = gather_local(images, labels, perm_stack,
                                  rel_offsets[k0:k0 + sub])
            drawn = noise(k0, sub)
            for k in range(sub):
                batches = {"image": xs[k], "label": ys[k]}
                if spec.adversarial:
                    state, m = train_step(state, batches,
                                          *[d[k] for d in drawn])
                else:
                    state, m = train_step(state, batches, drawn[k])
                for key, v in m.items():
                    hist.setdefault(key, []).append(v)
        return state, {k: torch.stack(v) for k, v in hist.items()}

    return many_steps
