"""Rank functions for ``parallel/mesh.py::run_ranks``: what a rank of a
data-parallel run does when the caller wants its result back (the CLI's
``--dp`` has its own, ``cli.py::_train_rank``). They live in the package
so that a spawned rank imports nothing but the package, and they return
numpy, which pickles across processes.

- :func:`many_steps_rank`: the DP chunk functions (the general DP step or
  the phase kernels) over streams the caller gives, the global batch's
  noise included (each rank slices its rows), so a caller can hold the
  ranks' result against a single-device run on the same numbers;
- :func:`trainer_rank`: ``Trainer(..., group=group).train(steps)`` on the
  synthetic digits, with the launch and all-reduce counts of each run;
- :func:`grid_steps_rank`: :func:`many_steps_rank`'s cases on grids of
  their own (``dp x tp`` on the "model" axis, or a data group of dp),
  built inside one group of every rank, each rank returning the whole
  state (a tp state gathered over the model group);
- :func:`tp_trainer_rank`: :func:`trainer_rank` for a tp grid, with the
  model group's all-reduces and ``sample(n)`` from the tp state;
- :func:`pp_rank`: pipeline-parallel prior cases (``parallel/pp.py``):
  logits, the loss and its gradients, and steps;
- :func:`tp_checkpoint_rank`: a tp Trainer that trains, saves, and loads
  its checkpoint back into a fresh grid;
- :func:`sequence`: several of these in one start of the ranks.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from generative_models_tpu_torch.utils.checkpoint import (
    _to_numpy,
    params_from_numpy,
    state_leaves,
)


def state_numpy(state) -> Dict[str, np.ndarray]:
    """A train state's leaves as numpy, by their JAX key paths."""
    return {p: _to_numpy(p, v) for p, v in state_leaves(state)}


def _shard(a: np.ndarray, group) -> np.ndarray:
    """The rank's rows of a global batch on the second-to-last dim."""
    b = a.shape[-2] // group.world
    return a[..., group.rank * b:(group.rank + 1) * b, :]


def init_state(cfg, device):
    """The state a case starts from: drawn from ``cfg.seed`` on the CPU
    and moved to `device`, as the Trainer draws it."""
    from generative_models_tpu_torch.losses.registry import get_variant
    from generative_models_tpu_torch.train import step as step_lib
    return step_lib.init_state(get_variant(cfg.variant), cfg,
                               torch.Generator().manual_seed(cfg.seed),
                               device)


def many_steps_rank(group, cases: List[Dict[str, Any]]) -> List[Dict]:
    """For each case — ``cfg`` (a port Config), ``path`` ("general": the
    general DP step; "fused": the phase kernels), ``steps_per_epoch``, and
    numpy ``images``, ``labels``, ``perm`` [E, N], ``rel`` [steps] and
    ``noise`` (a tuple of arrays whose leading dim is the step and whose
    second-to-last is the global batch; a single model's: one array,
    eps) — runs the chunk on the rank from
    :func:`init_state` and returns {"state", "metrics"} as numpy."""
    from generative_models_tpu_torch.losses.registry import get_variant
    from generative_models_tpu_torch.ops import cuda_dp
    from generative_models_tpu_torch.parallel import dp
    dev = group.device
    out = []
    for case in cases:
        cfg = case["cfg"]
        spec = get_variant(cfg.variant)
        build = (cuda_dp.build_fused_dp_many_steps if case["path"] == "fused"
                 else dp.build_shard_map_many_steps)
        fn = build(spec, cfg, case["steps_per_epoch"], group)
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        noise = tuple(t(_shard(a, group)) for a in case["noise"])
        if spec.adversarial:
            draw = lambda k0, n: tuple(a[k0:k0 + n] for a in noise)
        else:  # a single model's noise is one tensor, eps
            draw = lambda k0, n: noise[0][k0:k0 + n]
        state, m = fn(init_state(cfg, dev), t(case["images"]),
                      t(case["labels"]), t(case["perm"]), t(case["rel"]),
                      draw)
        out.append({"state": state_numpy(state),
                    "metrics": {k: v.cpu().numpy() for k, v in m.items()}})
    return out


def trainer_rank(group, runs, n_train: int = 2000, data_seed: int = 0,
                 reduce_floats: int = 0) -> Dict[str, Any]:
    """For each (config, steps) of `runs`, ``Trainer(config=cfg,
    group=group).train(steps)`` on `n_train` rows of the synthetic
    digits. Returns {"runs": a run each, the state and history as numpy,
    the phase kernels' and the chunk kernel's launches and the
    all-reduces during ``train``, and its steps per second on the host's
    clock (the data's upload excluded); "all_reduce_ms": with
    `reduce_floats` > 0, the mean time of one all-reduce of that many
    float32 on the rank's device, host clock to completion}."""
    from generative_models_tpu_torch.data.mnist import synthetic_mnist
    from generative_models_tpu_torch.ops import cuda_dp, cuda_train
    from generative_models_tpu_torch.parallel import mesh
    from generative_models_tpu_torch.train.trainer import Trainer
    data = synthetic_mnist(n_train=n_train, n_test=200, seed=data_seed)
    out = []
    for cfg, steps in runs:
        t = Trainer(config=cfg, group=group, data=data)
        t._load_data()
        group.barrier()
        count = lambda: (cuda_dp.d_launches, cuda_dp.g_launches,
                         cuda_train.launches, mesh.all_reduces)
        before = count()
        t0 = time.perf_counter()
        hist = t.train(steps=steps)
        if group.device.type == "cuda":
            torch.cuda.synchronize(group.device)
        wall = time.perf_counter() - t0
        counts = dict(zip(("d_phase", "g_phase", "gan_chunk", "all_reduce"),
                          (a - b for a, b in zip(count(), before))))
        out.append({"state": state_numpy(t.state), "history": hist,
                    "launches": counts, "steps_per_s": steps / wall})
    reduce_ms = None
    if reduce_floats:
        buf = torch.zeros(reduce_floats, device=group.device)
        sync = ((lambda: torch.cuda.synchronize(group.device))
                if group.device.type == "cuda" else (lambda: None))
        for _ in range(3):
            group.all_reduce_mean_(buf)
        sync()
        group.barrier()
        t0 = time.perf_counter()
        for _ in range(20):
            group.all_reduce_mean_(buf)
        sync()
        reduce_ms = (time.perf_counter() - t0) / 20 * 1e3
    return {"runs": out, "all_reduce_ms": reduce_ms}


def _grid(world, grids, dp, n, axis):
    """The (dp, n, axis) grid of `world`, made once (every rank makes
    every grid, in the order the cases first name them)."""
    from generative_models_tpu_torch.parallel.mesh import make_grid
    key = (dp, n, axis)
    if key not in grids:
        grids[key] = make_grid(dp, n, axis, world)
    return grids[key]


def _counts():
    from generative_models_tpu_torch.ops import (
        cuda_linear,
        cuda_mlp,
        cuda_reparam,
        cuda_train,
        penalty,
    )
    from generative_models_tpu_torch.parallel import mesh, tp
    return {"mlp_fwd": cuda_mlp.launches, "mlp_bwd": cuda_mlp.bwd_launches,
            "linear_cuda": cuda_linear.launches,
            "reparam": cuda_reparam.launches,
            "reparam_bwd": cuda_reparam.bwd_launches,
            "gan_chunk": cuda_train.launches,
            "plain_passes": penalty.plain_passes,
            "data_all_reduce": mesh.all_reduces,
            "model_all_reduce": tp.all_reduces,
            "model_all_gather": tp.all_gathers}


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _since(before):
    return {k: v - before[k] for k, v in _counts().items()}


def grid_steps_rank(world, cases: List[Dict[str, Any]]) -> List[Dict]:
    """For each case of :func:`many_steps_rank`'s form with ``grid`` =
    (dp, tp): the general DP step over the grid's data group, from
    :func:`init_state` sharded over its model group when tp > 1
    (``parallel/tp.py``). Returns, on the grid's ranks, {"state" (whole),
    "metrics", "counts": the kernels' launches and the collectives}; None
    on a rank outside the case's grid."""
    from generative_models_tpu_torch.losses.registry import get_variant
    from generative_models_tpu_torch.parallel import dp, tp
    grids, out = {}, []
    for case in cases:
        cfg = case["cfg"]
        d, n = case["grid"]
        grid = _grid(world, grids, d, n, tp.MODEL_AXIS)
        if grid is None:
            out.append(None)
            continue
        spec = get_variant(cfg.variant)
        dev = grid.device
        state = init_state(cfg, dev)
        if n > 1:
            state, roles = tp.shard_state(spec, cfg, state, grid.second)
        fn = dp.build_shard_map_many_steps(spec, cfg, case["steps_per_epoch"],
                                           grid.data)
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        noise = tuple(t(_shard(a, grid.data)) for a in case["noise"])
        if spec.adversarial:
            draw = lambda k0, k: tuple(a[k0:k0 + k] for a in noise)
        else:
            draw = lambda k0, k: noise[0][k0:k0 + k]
        before = _counts()
        state, m = fn(state, t(case["images"]), t(case["labels"]),
                      t(case["perm"]), t(case["rel"]), draw)
        counts = _since(before)
        if n > 1:
            state = {k: tp.gather_tree(v, roles[k], grid.second)
                     for k, v in state.items()}
        out.append({"state": state_numpy(state), "counts": counts,
                    "metrics": {k: v.cpu().numpy() for k, v in m.items()}})
    return out


def tp_trainer_rank(grid, runs, n_train: int = 2000, data_seed: int = 0,
                    sample_n: int = 0, reduce_floats: int = 0,
                    timed_steps: int = 0) -> Dict[str, Any]:
    """For each (config, steps) of `runs`, ``Trainer(config=cfg,
    group=grid).train(steps)`` on `n_train` rows of the synthetic digits:
    {"runs": a run each, the whole state (gathered) and history as numpy,
    the launches and collectives during ``train``, its steps per second on
    the host's clock (the data's upload excluded; with `timed_steps` > 0,
    those of a second ``train(timed_steps)`` after the first, and the
    whole state after it, "final_state"), and with
    `sample_n` > 0 ``sample(sample_n)`` from the tp state;
    "all_reduce_ms": with `reduce_floats` > 0, the mean time of one
    all-reduce of that many float32 over the model group, host clock to
    completion}."""
    from generative_models_tpu_torch.data.mnist import synthetic_mnist
    from generative_models_tpu_torch.train.trainer import Trainer
    data = synthetic_mnist(n_train=n_train, n_test=200, seed=data_seed)
    out = []
    for cfg, steps in runs:
        t = Trainer(config=cfg, group=grid, data=data)
        t._load_data()
        grid.barrier()
        before = _counts()
        t0 = time.perf_counter()
        hist = t.train(steps=steps)
        _sync(grid.device)
        wall = time.perf_counter() - t0
        counts = _since(before)
        run = {"state": state_numpy(t.whole_state()), "history": hist,
               "launches": counts, "steps_per_s": steps / wall}
        if sample_n:
            run["sample"] = t.sample(sample_n)
        if timed_steps:
            grid.barrier()
            t.train(steps=timed_steps)
            run["steps_per_s"] = timed_steps / t.wall_time
            run["final_state"] = state_numpy(t.whole_state())
        out.append(run)
    reduce_ms = None
    if reduce_floats:
        buf = torch.zeros(reduce_floats, device=grid.device)
        for _ in range(3):
            grid.second.all_reduce_sum_(buf)
        _sync(grid.device)
        grid.barrier()
        t0 = time.perf_counter()
        for _ in range(20):
            grid.second.all_reduce_sum_(buf)
        _sync(grid.device)
        reduce_ms = (time.perf_counter() - t0) / 20 * 1e3
    return {"runs": out, "all_reduce_ms": reduce_ms}


def pp_rank(world, cases: List[Dict[str, Any]]) -> List[Dict]:
    """For each case — ``cfg`` (vqprior), ``grid`` = (dp, stages),
    ``n_micro``, numpy ``params`` (the prior's tree, blocks as a list),
    ``tokens`` [B, L], ``y`` (labels or None), ``steps`` and optionally
    ``timed`` — on the grid's ranks: {"logits": ``prior_apply_pp``,
    "loss" and "grads" (the whole tree, the blocks gathered over the pipe
    group): the pipelined CE's, "losses" and "params": after `steps` of
    ``build_pp_prior_step``, "counts" during them, "steps_per_s" (of
    `timed` more steps when given)}; None outside the grid."""
    from generative_models_tpu_torch.parallel import pp
    grids, out = {}, []
    for case in cases:
        cfg = case["cfg"]
        d, s = case["grid"]
        grid = _grid(world, grids, d, s, pp.PIPE_AXIS)
        if grid is None:
            out.append(None)
            continue
        dev = grid.device
        params = params_from_numpy(case["params"], dev)
        tokens = torch.from_numpy(case["tokens"]).to(dev)
        y = (None if case["y"] is None
             else torch.from_numpy(case["y"]).to(dev))
        n_micro = case["n_micro"]
        res = {}
        with torch.no_grad():
            res["logits"] = pp.prior_apply_pp(params, pp._shift(tokens, cfg),
                                              cfg, grid, n_micro, y)
        prepare = pp.build_pp_prior_step(cfg, grid, n_micro)
        step, p, opt, tok, yy = prepare(params, tokens, y)
        loss, grads = pp.pp_loss_and_grads(p, tok, cfg, grid, n_micro, yy)
        res["loss"], res["grads"] = loss, pp.gather_params(grads, grid)
        _sync(dev)
        before, hops = _counts(), pp.hops
        t0 = time.perf_counter()
        losses = []
        for _ in range(case["steps"]):
            p, opt, loss = step(p, opt, tok, yy)
            losses.append(loss)
        _sync(dev)
        res["steps_per_s"] = case["steps"] / (time.perf_counter() - t0)
        res["counts"] = dict(_since(before), hops=pp.hops - hops)
        if case.get("timed"):  # steps/s of `timed` more steps, warm
            t0 = time.perf_counter()
            q, o = p, opt
            for _ in range(case["timed"]):
                q, o, _ = step(q, o, tok, yy)
            _sync(dev)
            res["steps_per_s"] = case["timed"] / (time.perf_counter() - t0)
        res["losses"] = torch.stack(losses) if losses else torch.zeros(0)
        res["params"] = pp.gather_params(p, grid)
        out.append(_numpy_tree(res))
    return out


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_numpy_tree(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return tree


def tp_checkpoint_rank(world, cfg, dims, steps: int, path: str,
                       sample_n: int, n_train: int = 512) -> Optional[Dict]:
    """``Trainer(config=cfg, group=grid)`` on the (dp, tp) grid `dims` of
    `world`: train `steps`, ``sample(sample_n)``, ``save_model(path)``,
    then a fresh grid Trainer's ``load_model(path)``. Returns {"sample",
    "state": the trained state, "loaded": the loaded one (both whole)};
    None outside the grid."""
    from generative_models_tpu_torch.data.mnist import synthetic_mnist
    from generative_models_tpu_torch.parallel import tp
    from generative_models_tpu_torch.parallel.mesh import make_grid
    from generative_models_tpu_torch.train.trainer import Trainer
    grid = make_grid(*dims, tp.MODEL_AXIS, world)
    if grid is None:
        return None
    data = synthetic_mnist(n_train=n_train, n_test=64, seed=0)
    t = Trainer(config=cfg, group=grid, data=data)
    t.train(steps=steps, sample_every=-1)
    out = {"sample": t.sample(sample_n)}
    t.save_model(path)
    out["state"] = state_numpy(t.whole_state())
    t2 = Trainer(config=cfg, group=grid, data=data)
    t2.load_model(path)
    out["loaded"] = state_numpy(t2.whole_state())
    return out


def hop_probe(world, timeout_s: float = 20.0) -> Optional[str]:
    """Whether a point-to-point send of a tensor on the ranks' device
    works in `world`'s backend (gloo and CUDA tensors: ``parallel/pp.py``
    stages its hops through the host either way): rank 0 sends four
    floats to rank 1 under a tag of its own, each side waiting at most
    `timeout_s`. Returns None when rank 1 received them, else the error
    (on each rank its own). The backend may end the process instead of
    raising, so run it in ranks of its own."""
    import datetime

    import torch.distributed as dist
    t = torch.arange(4.0, device=world.device)
    try:
        if world.rank == 0:
            work = dist.isend(t, 1, group=world.pg, tag=91)
        elif world.rank == 1:
            t = torch.zeros(4, device=world.device)
            work = dist.irecv(t, 0, group=world.pg, tag=91)
        else:
            return None
        work.wait(datetime.timedelta(seconds=timeout_s))
        _sync(world.device)
    except Exception as e:  # the backend's refusal, or the wait's timeout
        return f"{type(e).__name__}: {e}"
    if world.rank == 1 and t.cpu().tolist() != [0.0, 1.0, 2.0, 3.0]:
        return f"received {t.cpu().tolist()}"
    return None


def sequence(world, calls):
    """``[fn(world, *args) for fn, args in calls]`` in one start of the
    ranks: every rank makes the same calls in the same order."""
    return [fn(world, *args) for fn, args in calls]
