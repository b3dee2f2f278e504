"""How far tp 2 and the single device drift apart, with and without the
spectral projection: nsgan at config.py's widths, general steps at
Adam eps 1e-3 (``chip_smoke.py``'s 4l setting), on two ranks over gloo
against one device from the same seed and draws. For each case (no
projection, ``sn_mode`` "amortized", "fresh") it prints the state's max
abs difference after `--steps` and after `--more` steps beyond, and the
three leaves that differ most.

    python3 generative_models_tpu_torch/tools/tp_drift.py --device cpu

Two ranks and the single device each run every case; on the CPU at B 100
this takes under a minute (``--threads`` caps each rank's threads). With
``--device cuda`` (run from the repository root) it builds the MLP
kernels first and the ranks share the card.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CASES = (("no projection", {}),
         ("amortized", {"spectral_projection": True}),
         ("fresh", {"spectral_projection": True, "sn_mode": "fresh"}))


def _cfg(kw, tp, batch_size):
    from generative_models_tpu_torch.config import variant_config
    return variant_config("nsgan", **dict(
        batch_size=batch_size, dtype="float32", fused_step=False,
        sample_every=10 ** 9, adam_eps=1e-3, tp=tp, **kw))


def _diff(got, want):
    d = {k: float(np.abs(got[k] - want[k]).max(initial=0.0))
         for k in want if k != "['rng']"}
    return max(d.values()), sorted(d.items(), key=lambda kv: -kv[1])[:3]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--more", type=int, default=40)
    ap.add_argument("--batch-size", type=int, default=100)
    ap.add_argument("--threads", type=int, default=2)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from generative_models_tpu_torch.data.mnist import synthetic_mnist
    from generative_models_tpu_torch.parallel.mesh import run_ranks
    from generative_models_tpu_torch.parallel.runs import (
        state_numpy,
        tp_trainer_rank,
    )
    from generative_models_tpu_torch.train.trainer import Trainer
    if args.device == "cuda":  # the MLP kernels, before the ranks start
        from generative_models_tpu_torch.ops import cuda_mlp
        cuda_mlp.build()
        cuda_mlp.build_bwd()
    runs = [(_cfg(kw, 2, args.batch_size), args.steps) for _, kw in CASES]
    ranks = run_ranks(tp_trainer_rank, 2, args.device,
                      args=(runs, 2000, 0, 0, 0, args.more),
                      ranks_share_card=args.device == "cuda",
                      threads=args.threads if args.device == "cpu" else 0,
                      timeout=1800, grid=(1, 2, "model"))
    data = synthetic_mnist(n_train=2000, n_test=200, seed=0)
    for i, (name, kw) in enumerate(CASES):
        t = Trainer(config=_cfg(kw, 1, args.batch_size), device=args.device,
                    data=data)
        t.train(steps=args.steps)
        early = state_numpy(t.state)
        t.train(steps=args.more)
        late = state_numpy(t.state)
        run = ranks[0]["runs"][i]
        for n, got, want in ((args.steps, run["state"], early),
                             (args.steps + args.more, run["final_state"],
                              late)):
            err, worst = _diff(got, want)
            print(f"{name:13s} after {n:3d} steps: state max abs diff "
                  f"{err:.3e}; most: "
                  + ", ".join(f"{k} {v:.3e}" for k, v in worst))
    return 0


if __name__ == "__main__":
    sys.exit(main())
