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
  synthetic digits, with the launch and all-reduce counts of each run.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List

import numpy as np
import torch

from generative_models_tpu_torch.utils.checkpoint import _to_numpy, state_leaves


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
