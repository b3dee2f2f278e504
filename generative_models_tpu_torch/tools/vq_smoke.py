"""Phases 4k and 5i of ``chip_smoke.py`` alone, in a process of their
own, on the card: the VQ family's checks at full width (nets, the TF32
check, samplers, CLI runs with launch counts, ``--vq-from``, bf16,
serving and export), then its general steps' steps/s with a step's
device split and idle share, and the prior's served images/s.

    python3 generative_models_tpu_torch/tools/vq_smoke.py [--kernels]

``--kernels`` first holds the MLP kernels against their plain versions
at every shape (phases 3a and 3b, the VQ family's among them). Run from
the repository root (it imports ``chip_smoke.py`` there); it builds the
MLP kernels first and exits non-zero if a check fails.
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
    from generative_models_tpu_torch.ops.cuda_linear import linear_cuda
    if not torch.cuda.is_available():
        print("vq_smoke: no CUDA device", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    card = smoke.nvidia_smi_line()
    print(f"card: {card}; torch {torch.__version__}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.manual_seed(0)
    smoke.build_all([cuda_mlp.build, cuda_mlp.build_bwd],
                    build_mod.BUILD_DIR)
    if "--kernels" in sys.argv[1:]:
        smoke.check_fwd(cuda_mlp, linear_cuda, torch)
        smoke.check_bwd(cuda_mlp, torch)
    mods = (cuda_mlp, cuda_train, cuda_reparam, cuda_train_vae)
    _, lines, errs = smoke.drive_vq(mods, torch)
    rows = smoke.time_vq(mods, torch, card)
    print(json.dumps({"vq_checks": errs, "vq_runs": lines,
                      "vq_times": rows, "card": card}))
    print(f"vq_smoke: passed in {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
