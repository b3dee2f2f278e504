"""Pipeline parallelism over the causal-transformer prior's blocks — the
port of ``generative_models_tpu/parallel/pp.py``.

The prior (``models/ar_prior.py``) is a stack of ``vq_prior_layers``
identical pre-LN blocks. A ``dp x pp`` grid on the "pipe" axis
(``parallel/mesh.py::make_grid``) cuts it into ``pp`` contiguous stages:
stage s holds blocks s*k .. (s+1)*k-1 (k = layers / pp), stacked along a
leading layer axis (:func:`stack_blocks`), and the rows of every batch
are split over the data axis. The embeddings, ``ln_f`` and the head are
replicated: stage 0 embeds, the last stage takes the logits.

The schedule is GPipe's synchronous fill-drain (Huang et al. 2019),
written out (:func:`pp_loss_and_grads`): every microbatch's forward in
order, each stage receiving its input from the stage before and sending
its output on (a hop, the reference's ``ppermute``); then every
microbatch's backward in reverse order, each stage receiving the
gradient of its output from the stage after, differentiating its blocks
(autograd within the stage only) and sending the gradient of its input
back. Blocking sends and receives are never left to autograd to order.
The reference's ``n_micro + n_stages - 1`` ticks are the same schedule:
stage s runs microbatch t - s at tick t, and a hop waits for the stage
before it. Then one sum over the pipe group makes every stage's copy of
the replicated leaves' gradients equal (stage 0 holds the embeddings',
the last stage the head's and ``ln_f``'s) and one mean over the data
group averages everything. Every block's arithmetic is
``ar_prior.block_apply``'s, so each rank's dense products run on the MLP
kernels on the card (one launch of each a linear).

A hop of a CUDA tensor over gloo (ranks sharing one card) goes through
host memory explicitly: the tensor is copied to the host, sent, received
into a host buffer and copied to the card. gloo's own send of a CUDA
tensor ends its process on an H100 (``gloo::IoException``: writev, Bad
address; ``parallel/runs.py::hop_probe``). NCCL sends the card's tensor
itself. ``hops`` counts the sends.
"""

from __future__ import annotations

from typing import Any, Optional

import torch
import torch.distributed as dist

from generative_models_tpu_torch.losses.vqprior import _shift, prior_ce
from generative_models_tpu_torch.models import ar_prior
from generative_models_tpu_torch.parallel.mesh import make_grid
from generative_models_tpu_torch.train.optim import apply_opt, init_opt
from generative_models_tpu_torch.utils.tree import (
    tree_leaves,
    tree_map,
    tree_unflatten,
)

PIPE_AXIS = "pipe"

hops = 0


def make_grid_pp(dp: int, pp: int, world):
    """The ``dp x pp`` grid on the "pipe" axis (the reference's
    ``make_mesh_pp``) from `world`, a group of every rank."""
    return make_grid(dp, pp, PIPE_AXIS, world)


def stack_blocks(blocks) -> Any:
    """[layers] list of block trees -> one tree with a leading layer axis
    a leaf."""
    return tree_map(lambda *xs: torch.stack(xs), *blocks)


def unstack_blocks(stacked, n_layers: int):
    """Inverse of :func:`stack_blocks` (checkpoint interchange with the
    list-of-blocks layout the rest of the repo uses)."""
    return [tree_map(lambda x: x[i], stacked) for i in range(n_layers)]


def _check(cfg, grid, b: int, n_micro: int) -> None:
    """The reference's three divisibility refusals."""
    if cfg.vq_prior_layers % grid.n:
        raise ValueError(
            f"vq_prior_layers={cfg.vq_prior_layers} must divide into "
            f"pipe={grid.n} equal stages")
    if b % n_micro:
        raise ValueError(f"batch {b} not divisible by n_micro={n_micro}")
    if (b // n_micro) % grid.dp:
        raise ValueError(
            f"microbatch {b // n_micro} not divisible by data={grid.dp}")


def _rows(b: int, n_micro: int, grid):
    """This data rank's rows of each microbatch: microbatch m is rows
    m*mb .. (m+1)*mb-1 (mb = B / n_micro), split over the data axis, as
    the reference shards its microbatched activations."""
    mb = b // n_micro
    lb = mb // grid.dp
    d = grid.data.rank
    return [slice(m * mb + d * lb, m * mb + (d + 1) * lb)
            for m in range(n_micro)]


def _stage_blocks(params, cfg, grid):
    """This stage's stacked blocks from `params` holding the whole stack
    (a list, or stacked) or already the stage's."""
    blocks = params["blocks"]
    if isinstance(blocks, list):
        blocks = stack_blocks(blocks)
    k = cfg.vq_prior_layers // grid.n
    if tree_leaves(blocks)[0].shape[0] == k:
        return blocks
    s = grid.second.rank
    return tree_map(lambda t: t[s * k:(s + 1) * k], blocks)


def _stage(blocks, x, cfg):
    for i in range(tree_leaves(blocks)[0].shape[0]):
        x = ar_prior.block_apply(tree_map(lambda t: t[i], blocks), x, cfg)
    return x


def _send(t, grid, stage: int) -> None:
    global hops
    t = t.detach().contiguous()
    if grid.second.backend == "gloo" and t.is_cuda:
        t = t.cpu()
    dist.send(t, grid.second_rank_of(stage), group=grid.second.pg)
    hops += 1


def _recv(shape, grid, stage: int):
    dev = grid.device
    host = grid.second.backend == "gloo" and dev.type == "cuda"
    buf = torch.empty(shape, dtype=torch.float32,
                      device="cpu" if host else dev)
    dist.recv(buf, grid.second_rank_of(stage), group=grid.second.pg)
    return buf.to(dev) if host else buf


def _shape(rows, tokens, cfg):
    return (rows.stop - rows.start, tokens.shape[1], cfg.vq_prior_width)


def prior_apply_pp(params, tokens_in, cfg, grid, n_micro: int, y=None):
    """Pipeline-parallel twin of ``ar_prior.prior_apply``: next-token
    logits [B, L, K] for SHIFTED input tokens [B, L] (the whole batch, on
    every rank), whole on every rank of the grid. `params`: the prior's
    tree, its blocks a list, stacked, or this stage's stacked slice."""
    b = tokens_in.shape[0]
    _check(cfg, grid, b, n_micro)
    s, last = grid.second.rank, grid.n - 1
    blocks = _stage_blocks(params, cfg, grid)
    outs = []
    for rows in _rows(b, n_micro, grid):
        if s == 0:
            x = ar_prior.embed_tokens(params, tokens_in[rows], cfg,
                                      None if y is None else y[rows])
        else:
            x = _recv(_shape(rows, tokens_in, cfg), grid, s - 1)
        h = _stage(blocks, x, cfg)
        if s < last:
            _send(h, grid, s + 1)
        else:
            outs.append(ar_prior.final_logits(params, h))
    lb = (b // n_micro) // grid.dp
    k = cfg.vq_codebook_size
    mine = (torch.stack(outs) if s == last else torch.empty(
        (n_micro, lb, tokens_in.shape[1], k), device=tokens_in.device))
    dist.broadcast(mine, grid.second_rank_of(last), group=grid.second.pg)
    parts = [torch.empty_like(mine) for _ in range(grid.dp)]
    dist.all_gather(parts, mine, group=grid.data.pg)
    # [data, micro, rows] -> the batch's order: micro, then data, then rows
    return torch.stack(parts, 1).reshape(b, tokens_in.shape[1], k)


def prior_ce_pp(params, tokens, cfg, grid, n_micro: int, y=None):
    """Teacher-forced next-token cross-entropy of the prior over token
    grids [B, L] with the forward pipelined (the two-stage objective:
    the tokenizer frozen, the prior trained): ``losses/vqprior.py``'s
    ``_shift`` and ``prior_ce``."""
    logits = prior_apply_pp(params, _shift(tokens, cfg), cfg, grid, n_micro,
                            y)
    return prior_ce(logits, tokens)


def pp_loss_and_grads(params, tokens, cfg, grid, n_micro: int, y=None):
    """(loss, grads) of the prior's CE over token grids [B, L] (the whole
    batch, on every rank) under the explicit fill-drain schedule (module
    docstring). `params`: this stage's tree (blocks stacked, the stage's
    slice; the replicated leaves whole). The loss and gradients are the
    single device's, equal on every rank."""
    b = tokens.shape[0]
    _check(cfg, grid, b, n_micro)
    s, last = grid.second.rank, grid.n - 1
    leaves = [t.detach().requires_grad_(True) for t in tree_leaves(params)]
    p = tree_unflatten(params, leaves)
    tin = _shift(tokens, cfg)
    xs, hs, losses = [], [], []
    for rows in _rows(b, n_micro, grid):
        if s == 0:
            x = ar_prior.embed_tokens(p, tin[rows], cfg,
                                      None if y is None else y[rows])
        else:
            x = _recv(_shape(rows, tokens, cfg), grid,
                      s - 1).requires_grad_(True)
        h = _stage(p["blocks"], x, cfg)
        xs.append(x)
        hs.append(h)
        if s < last:
            _send(h, grid, s + 1)
        else:  # this rank's mean over its rows, one microbatch's share
            losses.append(prior_ce(ar_prior.final_logits(p, h),
                                   tokens[rows]) / n_micro)
    for m in reversed(range(n_micro)):
        if s == last:
            torch.autograd.backward(losses[m])
        else:
            g = _recv(tuple(hs[m].shape), grid, s + 1)
            torch.autograd.backward(hs[m], g)
        if s > 0:
            _send(xs[m].grad, grid, s - 1)
    grads = tree_unflatten(params, [
        t.grad if t.grad is not None else torch.zeros_like(t)
        for t in leaves])
    loss = (torch.stack(losses).sum().detach() if s == last
            else torch.zeros((), device=tokens.device))
    # the replicated leaves' gradients and the loss summed over the
    # stages, then everything averaged over the data group
    rep = [k for k in grads if k != "blocks"]
    rep_leaves = tree_leaves({k: grads[k] for k in rep}) + [loss]
    flat = torch.cat([t.reshape(-1) for t in rep_leaves])
    grid.second.all_reduce_sum_(flat)
    blk = tree_leaves(grads["blocks"])
    flat = grid.data.all_reduce_mean_(
        torch.cat([t.reshape(-1) for t in blk] + [flat]))
    parts = list(flat.split([t.numel() for t in blk + rep_leaves]))
    loss = parts.pop().reshape(())
    grads = dict(grads, blocks=tree_unflatten(
        grads["blocks"], [q.view(t.shape) for q, t in zip(parts, blk)]))
    rest = tree_unflatten({k: grads[k] for k in rep},
                          [q.view(t.shape) for q, t in
                           zip(parts[len(blk):], rep_leaves[:-1])])
    return loss, dict(grads, **rest)


def gather_params(params, grid):
    """The whole prior tree (blocks a list) from this stage's tree: the
    stacked blocks gathered over the pipe group (a collective)."""
    def whole(t):
        parts = [torch.empty_like(t) for _ in range(grid.n)]
        dist.all_gather(parts, t.contiguous(), group=grid.second.pg)
        return torch.cat(parts)
    out = dict(params)
    stacked = tree_map(whole, params["blocks"])
    out["blocks"] = unstack_blocks(stacked, tree_leaves(stacked)[0].shape[0])
    return out


def build_pp_prior_step(cfg, grid, n_micro: int, lr: Optional[float] = None):
    """The pipeline-parallel training step of the prior (two-stage
    protocol), with ``train/optim.py``'s optimizer from cfg at ``g_lr``
    (or `lr`), so a pipelined trajectory follows the Trainer's rule.
    Returns ``prepare(params, tokens, y) -> (step, params, opt_state,
    tokens, y)``: this stage's params (its blocks stacked, the replicated
    leaves whole) and optimizer state on the grid's device, and
    ``step(params, opt_state, tokens, y) -> (params, opt_state, loss)``."""
    rate = cfg.g_lr if lr is None else lr

    def step(params, opt_state, tokens, y):
        loss, grads = pp_loss_and_grads(params, tokens, cfg, grid, n_micro, y)
        params, opt_state = apply_opt(cfg, params, grads, opt_state, rate)
        return params, opt_state, loss

    def prepare(params, tokens, y):
        dev = grid.device
        local = {k: tree_map(lambda t: t.to(dev), v)
                 for k, v in params.items() if k != "blocks"}
        local["blocks"] = tree_map(lambda t: t.to(dev).contiguous(),
                                   _stage_blocks(params, cfg, grid))
        tokens = tokens.to(dev)
        if y is not None:
            y = y.to(dev)
        return step, local, init_opt(cfg, local), tokens, y

    return prepare
