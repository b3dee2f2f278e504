"""Times the GAN chunk kernel of whichever checkout is first on the
import path, to compare two versions of it on one card in one session.

    PYTHONPATH=<checkout A> python3 <this file> A nsgan
    PYTHONPATH=<checkout B> python3 <this file> B nsgan ragan wgan:rmsprop

Run the file by its path (not with ``-m``), so that the package comes
from ``PYTHONPATH`` and the same script times both: it speaks the
interface of every version of ``ops/cuda_train.py`` so far (the first,
nsgan and mmgan only, took a boolean where later ones take the variant).
Each argument after the tag is ``variant[:optimizer]``; wgan runs at
d_steps 5 with the clip. For each it builds that version's kernel, runs a
1000-step chunk at full width (B = 100) three times to warm up and prints
five CUDA-event timings in ms, then that build's ptxas lines on registers
and spills. Alternate the checkouts (A B B A) within one session; compare
nothing across sessions, and expect a few percent between allocations of
the same binary. Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import glob
import os
import sys


def main(argv) -> int:
    import numpy as np
    import torch

    from generative_models_tpu_torch.ops import build, cuda_train as ct
    tag, specs = argv[0], argv[1:] or ["nsgan"]
    b, steps = 100, 1000
    for spec in specs:
        variant, _, optimizer = spec.partition(":")
        optimizer = optimizer or "adam"
        ds = 5 if variant == "wgan" else 1
        if hasattr(ct, "HOOKS"):
            hp = ct.ChunkHyper(2e-4, 2e-4, 0.5, 0.999, 1e-8, 0.2, variant,
                               optimizer, 0.01 if variant == "wgan" else 0.0,
                               fisher_rho=1e-6)
        elif (variant, optimizer) == ("nsgan", "adam"):
            hp = ct.ChunkHyper(2e-4, 2e-4, 0.5, 0.999, 1e-8, 0.2, False)
        else:
            print(f"AB {tag} {spec}: not in this version")
            continue
        rng = np.random.default_rng(6)
        p = []
        for i, o in ((128, 400), (400, 784), (784, 400), (400, 1)):
            bound = 1.0 / np.sqrt(i)
            p += [rng.uniform(-bound, bound, (i, o)).astype(np.float32),
                  rng.uniform(-bound, bound, (o,)).astype(np.float32)]
        mu = [rng.normal(0, 1e-3, a.shape).astype(np.float32) for a in p]
        nu = [rng.uniform(0, 1e-5, a.shape).astype(np.float32) for a in p]
        planes = [[torch.from_numpy(a).cuda() for a in pl]
                  for pl in (p, mu, nu)]
        if optimizer != "adam":
            planes[1] = None
        xs = torch.rand(steps * ds * b, 784, device="cuda")
        zd = torch.randn(steps * ds * b, 128, device="cuda")
        zg = torch.randn(steps * b, 128, device="cuda")
        run = lambda: ct.gan_chunk(xs, zd, zg, *planes, steps=steps, ds=ds,
                                   batch=b, t_g=0, t_d=0, hp=hp)
        for _ in range(3):
            run()
        torch.cuda.synchronize()
        times = []
        for _ in range(5):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            run()
            e1.record()
            e1.synchronize()
            times.append(e0.elapsed_time(e1))
        print(f"AB {tag} {spec}: " + " ".join(f"{t:.2f}" for t in times),
              flush=True)
    for log in sorted(glob.glob(os.path.join(build.BUILD_DIR,
                                             "*gan_chunk*.log"))):
        with open(log) as f:
            for line in f:
                if "registers" in line or "bytes spill" in line:
                    print(f"  {tag} {os.path.basename(log)[:20]} "
                          f"{line.strip()[:110]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
