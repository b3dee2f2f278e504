"""Phase 4l of ``chip_smoke.py`` alone, in a process of its own, on the
card: tensor and pipeline parallelism on two ranks sharing the card over
gloo, each against the single device, and ``--multihost`` at world 1 over
NCCL; then whether gloo sends a CUDA tensor point to point
(``chip_smoke.py::probe_gloo_hop``); with ``--dp``, also 4f's world-1
NCCL runs of the diffusion and VQ families against the single device.

    python3 generative_models_tpu_torch/tools/parallel_smoke.py [--dp]

Run from the repository root (it imports ``chip_smoke.py`` there); it
builds the MLP and sampling kernels first and exits non-zero if a check
fails.
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
        print("parallel_smoke: no CUDA device", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    card = smoke.nvidia_smi_line()
    print(f"card: {card}; torch {torch.__version__}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.manual_seed(0)
    smoke.build_all([cuda_mlp.build, cuda_mlp.build_bwd, cuda_reparam.build],
                    build_mod.BUILD_DIR)
    os.makedirs(smoke.OUT_DIR, exist_ok=True)
    mods = (cuda_mlp, cuda_train, cuda_reparam, cuda_train_vae)
    paths, lines = smoke.drive_parallel(mods, torch, card)
    lines["gloo_cuda_send"] = smoke.probe_gloo_hop(card)
    if "--dp" in sys.argv[1:]:
        from generative_models_tpu_torch.parallel import mesh
        store = os.path.join(smoke.OUT_DIR, "parallel_smoke_store")
        if os.path.exists(store):
            os.remove(store)
        group = mesh.init_data_group(1, 0, "cuda", store_path=store)
        try:
            data = smoke.synthetic_split(2000, seed=5)
            for variant in smoke.DP_FAMILIES:
                paths[f"dp1_general_{variant}"] = smoke.drive_dp_family(
                    variant, mods, torch, group, data)
        finally:
            mesh.close_data_group()
    print(json.dumps({"parallel_runs": lines, "launches": paths,
                      "card": card}, default=str))
    print(f"parallel_smoke: passed in {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
