"""Phases 5j, 4m and 4n of ``chip_smoke.py`` alone, in a process of its
own, on the card: the conv stacks' bf16 crossover table (5j), the
measured fused-step policy (4m: the A/B of nsgan, vae and wgangp at
B 100 and nsgan at B 1024, the cache, the CLI following the verdict, a
failed measurement not cached), and ``--profile`` and the directory
checkpoint backend through the CLI (4n).

    python3 generative_models_tpu_torch/tools/policy_smoke.py
    python3 generative_models_tpu_torch/tools/policy_smoke.py \
        --crossover-window 3 --crossover-only

Run from the repository root (it imports ``chip_smoke.py`` there); it
builds the MLP and sampling kernels and the chunk libraries these phases
launch (nsgan's and wgangp's hooks, the VAE's), all at once, and exits
non-zero if a check fails (~4 min). ``--crossover-window S`` times 5j in
runs of S seconds each instead of the smoke's 10 steps (the table
config.py's ``CONV_BF16_CROSSOVER_BATCH`` comes from: ~6 min at 3 s);
``--crossover-only`` runs 5j alone, building the MLP and sampling
kernels only.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--crossover-window", type=float, default=0.0,
                    help="seconds of each 5j run (0: the smoke's 10 steps)")
    ap.add_argument("--crossover-only", action="store_true",
                    help="run 5j alone")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    import chip_smoke as smoke
    from generative_models_tpu_torch.ops import build as build_mod
    from generative_models_tpu_torch.ops import (
        cuda_mlp, cuda_reparam, cuda_train, cuda_train_vae)
    if not torch.cuda.is_available():
        print("policy_smoke: no CUDA device", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    card = smoke.nvidia_smi_line()
    print(f"card: {card}; torch {torch.__version__}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.manual_seed(0)
    os.makedirs(smoke.OUT_DIR, exist_ok=True)
    os.environ["GMTPU_FUSED_AB"] = "0"
    os.environ["GMTPU_POLICY_CACHE"] = os.path.join(smoke.OUT_DIR,
                                                    "fused_auto.json")
    chunks = ([functools.partial(cuda_train.build, cuda_train.HOOKS[v], False)
               for v in ("nsgan", "wgangp")]
              + [functools.partial(cuda_train_vae.build, False)])
    smoke.build_all([cuda_mlp.build, cuda_mlp.build_bwd, cuda_reparam.build]
                    + ([] if args.crossover_only else chunks),
                    build_mod.BUILD_DIR)
    print(f"  builds: {time.perf_counter() - t0:.1f} s")
    mods = (cuda_mlp, cuda_train, cuda_reparam, cuda_train_vae)
    crossover = smoke.time_conv_crossover(torch, card, args.crossover_window)
    if args.crossover_only:
        print(json.dumps({"conv_bf16_crossover": crossover, "card": card},
                         default=str))
        print(f"policy_smoke: passed in {time.perf_counter() - t0:.1f} s")
        return 0
    paths, policy = smoke.drive_policy(mods, torch, card)
    more, profile_ckpt = smoke.drive_profile_ckpt(mods, torch, card)
    paths.update(more)
    print(json.dumps({"conv_bf16_crossover": crossover,
                      "fused_policy": policy,
                      "profile_and_ckpt_dir": profile_ckpt,
                      "launches": paths, "card": card}, default=str))
    print(f"policy_smoke: passed in {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
