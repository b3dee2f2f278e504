"""Times the VAE sampling kernel (``ops/cuda_reparam.py``: the forward
``reparam_fwd`` and ``ReparamFunction.backward``) of whichever checkout is
first on the import path, to compare two versions of them on one card in
one sitting.

    PYTHONPATH=<checkout> python3 <this file> TAG

Run the file by its path (not with ``-m``), so that the package comes
from ``PYTHONPATH``; it speaks only the interface every version of
``ops/cuda_reparam.py`` has (``reparam_fwd``, ``reparam_and_kl_plain``,
``ReparamFunction``). At [100, 20] (the VAE's training batch), [8192, 20]
and [64, 200] it prints one line ``RP TAG fwd|bwd [B, L] ...`` a
direction with

- ``call_ms``: CUDA events around 200 back-to-back calls, over 200;
- ``host_us``: the host's clock around the same 200 enqueues, over 200
  (checks, allocations, the binding, the launch or the torch ops);
- ``device_ms``: the card's time a call with the host out of the way
  (``tools/phase_trace.py::queued_ms``: 50 calls queued behind a spin
  kernel), every kernel the call launches included;
- ``err``: the largest error against the plain rule on the same inputs
  (the forward: z by max abs error, against the reproduced Philox noise;
  the backward: dmu and dlogvar by max abs error over max |ref|).

The backward is called as autograd calls it, on a context that holds the
saved (mu, logvar, z). Alternate the checkouts (A B B A) in one command:

    git archive <commit> generative_models_tpu_torch | tar -x -C build/parent
    for t in A B B A; do d=$([ $t = A ] && echo build/parent || echo .)
      PYTHONPATH=$d python3 generative_models_tpu_torch/tools/reparam_ab.py \
        $t; done

Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import subprocess
import sys
import time
import types

SHAPES = ((100, 20), (8192, 20), (64, 200))


def timed(torch, fn, n: int = 200):
    """(call_ms, host_us) of `fn` over `n` back-to-back calls."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    host_us = (time.perf_counter() - t0) / n * 1e6
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / n, host_us


def measure(tag: str):
    import torch

    from generative_models_tpu_torch.ops import cuda_reparam as cr
    from generative_models_tpu_torch.tools.phase_trace import queued_ms
    g = torch.Generator().manual_seed(0)
    for b, l in SHAPES:
        mu = torch.randn(b, l, generator=g).cuda()
        lv = (torch.randn(b, l, generator=g) * 0.3).cuda()
        dz = torch.randn(b, l, generator=g).cuda()
        dkl = torch.randn(b, generator=g).cuda()
        seed = torch.tensor([b * 7919 + 1, l * 104729 + 3], device="cuda")
        z, _ = cr.reparam_fwd(mu, lv, seed, 5)
        z_ref, _ = cr.reparam_and_kl_plain(mu, lv, seed, 5)
        ctx = types.SimpleNamespace(saved_tensors=(mu, lv, z))
        dmu, dlv = cr.ReparamFunction.backward(ctx, dz, dkl)[:2]
        dmu_ref = dz + dkl[:, None] * mu
        dlv_ref = (dz * 0.5 * (z - mu)
                   - dkl[:, None] * 0.5 * (1.0 - torch.exp(lv)))
        errs = {"fwd": float((z - z_ref).abs().max()),
                "bwd": max(float((a - r).abs().max() / r.abs().max())
                           for a, r in ((dmu, dmu_ref), (dlv, dlv_ref)))}
        calls = {"fwd": lambda: cr.reparam_fwd(mu, lv, seed, 5),
                 "bwd": lambda: cr.ReparamFunction.backward(ctx, dz, dkl)}
        for d, fn in calls.items():
            call_ms, host_us = timed(torch, fn)
            dev = queued_ms(torch, fn)
            print(f"RP {tag} {d} [{b}, {l}] call_ms {call_ms:.5f} host_us "
                  f"{host_us:.2f} device_ms {dev:.5f} err {errs[d]:.3e}",
                  flush=True)


def main(argv) -> int:
    measure(argv[0] if argv else "X")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
