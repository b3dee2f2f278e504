"""Phases 4j and 5h of ``chip_smoke.py`` alone, in a process of their
own, on the card: the diffusion family's checks at full width, then its
general steps' steps/s with a step's device split and idle share, and
its served images/s. Deep in the whole smoke the host is slower and
``torch.profiler`` loses kernel events (``chip_smoke.device_ms_by_name``
then keeps no device time); a fresh process reads both afresh.

    python3 generative_models_tpu_torch/tools/diffusion_smoke.py

Run from the repository root (it imports ``chip_smoke.py`` there); it
builds the MLP kernels first and exits non-zero if a check fails.
"""

from __future__ import annotations

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main() -> int:
    sys.path.insert(0, ROOT)
    import torch

    import chip_smoke as smoke
    from generative_models_tpu_torch.ops import build as build_mod
    from generative_models_tpu_torch.ops import (
        cuda_mlp, cuda_reparam, cuda_train, cuda_train_vae)
    if not torch.cuda.is_available():
        print("diffusion_smoke: no CUDA device", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    card = smoke.nvidia_smi_line()
    print(f"card: {card}; torch {torch.__version__}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.manual_seed(0)
    smoke.build_all([cuda_mlp.build, cuda_mlp.build_bwd],
                    build_mod.BUILD_DIR)
    mods = (cuda_mlp, cuda_train, cuda_reparam, cuda_train_vae)
    _, lines, errs = smoke.drive_diffusion(mods, torch)
    rows = smoke.time_diffusion(mods, torch, card)
    print(json.dumps({"diffusion_checks": errs, "diffusion_runs": lines,
                      "diffusion_times": rows, "card": card}))
    print(f"diffusion_smoke: passed in {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
