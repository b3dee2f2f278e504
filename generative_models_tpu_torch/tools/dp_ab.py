"""Times the data-parallel routes in a group of one rank of whichever
checkout is first on the import path, to compare two versions of them on
one card in one session.

    PYTHONPATH=<checkout A> python3 <this file> A
    PYTHONPATH=<checkout B> python3 <this file> B

Run the file by its path (not with ``-m``), so that the package comes
from ``PYTHONPATH``. In a group of one rank over NCCL it trains nsgan at
full width (global batch 100, float32) through ``Trainer(fused_step=True,
group=...)`` (the phase kernels) and ``fused_step=False`` (the general DP
step): 200 steps to warm up, then five runs of 200 steps, each printed as
steps/s on the host clock to the last step's completion (no sample
images and no evaluation fall inside them); then the mean time of one
all-reduce of nsgan's D-phase buffer (CUDA events over 50 calls) and
the card's nvidia-smi line. Alternate the checkouts (A B B A, and again
B A A B: the host-bound rates drift by tens of percent within a call)
within one sitting; compare nothing across sittings. Needs a CUDA card
and nvcc.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile

# nsgan's D-phase buffer: dW1d, db1d, dW2d, db2d and the metrics row
REDUCE_FLOATS = 784 * 400 + 400 + 400 + 1 + 8


def main(argv) -> int:
    import torch

    from generative_models_tpu_torch.config import variant_config
    from generative_models_tpu_torch.data.mnist import synthetic_mnist
    from generative_models_tpu_torch.parallel import mesh
    from generative_models_tpu_torch.train.trainer import Trainer
    tag = argv[0]
    store = os.path.join(tempfile.mkdtemp(prefix="dp_ab_"), "store")
    group = mesh.init_data_group(1, 0, "cuda", store_path=store)
    data = synthetic_mnist(n_train=2000, n_test=200, seed=5)
    try:
        for fused in (True, False):
            cfg = variant_config("nsgan", batch_size=100, dtype="float32",
                                 fused_step=fused, sample_every=10 ** 9,
                                 out_dir=tempfile.mkdtemp(prefix="dp_ab_"))
            t = Trainer(config=cfg, group=group, data=data)
            t.train(steps=200)
            rates = []
            for _ in range(5):
                t.train(steps=200)
                rates.append(200 / t.wall_time)
            print(f"DPAB {tag} {'fused' if fused else 'general'} steps/s: "
                  + " ".join(f"{r:.1f}" for r in rates), flush=True)
        flat = torch.zeros(REDUCE_FLOATS, device="cuda")
        for _ in range(3):
            group.all_reduce_mean_(flat)
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(50):
            group.all_reduce_mean_(flat)
        e1.record()
        e1.synchronize()
        print(f"DPAB {tag} all_reduce_ms: {e0.elapsed_time(e1) / 50:.4f}")
    finally:
        mesh.close_data_group()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
