#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA card and nvcc. It
imports nothing of JAX. Phases:

1. the card's name and power limit (nvidia-smi); TF32 off for float32
   matmuls and convolutions, so the plain versions run in true float32;
2. builds every kernel of the serving path from ``csrc/`` (nvcc,
   sm_90a) and prints the build time and the ptxas report;
3. holds the whole-MLP forward kernel against its plain PyTorch version
   on the card, outputs and every hidden, at the serving shapes (nsgan
   G 128->400->784 at B 64/1024/8192), the critic's shape, a 3-layer
   tanh stack and ragged batches, in float32 and bf16 operands;
4. drives the port's serving path: writes a full-width nsgan checkpoint
   in the JAX package's npz layout (random weights from a seed), runs
   ``cli.main([... "--sample-only"])`` and then ``Trainer.sample`` at
   n = 8192 with fixed noise; each is run with the launch counts set to
   0 just before it and read just after, and the samples are held
   against the plain version;
5. times the kernel, its plain version and one library yardstick
   (addmm + relu + addmm + sigmoid) with CUDA events at B 64/1024/8192,
   and reads the kernel's own device time per launch from
   torch.profiler (the CUDA-event time also holds the wrapper's host
   cost where that exceeds the kernel's);
6. prints the ``{"kernels": [...]}`` line, the nvidia-smi line, and last
   ``{"ok": true, "device": {...}}``.

Any failed check raises, and the script exits non-zero. Without a CUDA
device, or without the package beside it, it exits non-zero and prints
no result.
"""

from __future__ import annotations

import contextlib
import glob
import io
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(HERE, "chiprun_out", "chip_smoke")

# Published H100 SXM peaks (NVIDIA data sheet, dense, at 700 W).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12

# Kernel vs plain version on the card. float32: only the order of the
# K <= 784 products in each sum differs (a few float32 ulps of values
# of order 1). bf16 operands: both sides round the same operands, but a
# hidden that lands within that sum-order error of a bf16 rounding tie
# rounds the other way, one bf16 ulp (<= 2^-6 for |h| < 4) times
# |W| <= 1/sqrt(K) in the next layer.
TOL = {"float32": 1e-4, "bfloat16": 5e-3}

G_DIMS = [128, 400, 784]
G_ACTS = ("relu", "sigmoid")
SERVING_BATCHES = (64, 1024, 8192)


def nvidia_smi_line() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return r.stdout.strip().splitlines()[0]


def make_stack(rng, dims, device):
    import torch
    ws, bs = [], []
    for k, n in zip(dims[:-1], dims[1:]):
        bound = 1.0 / np.sqrt(k)
        ws.append(torch.from_numpy(
            rng.uniform(-bound, bound, (k, n)).astype(np.float32)).to(device))
        bs.append(torch.from_numpy(
            rng.uniform(-bound, bound, (n,)).astype(np.float32)).to(device))
    return ws, bs


def check_kernel_vs_plain(cuda_mlp, torch):
    """Phase 3: raises at the first output or hidden out of tolerance."""
    rng = np.random.default_rng(0)
    cases = [("G", G_DIMS, G_ACTS, b) for b in SERVING_BATCHES + (1, 37, 1000)]
    cases += [("D", [784, 400, 1], ("leaky_relu", "none"), b)
              for b in (100, 1000)]
    cases += [("tanh3", [784, 96, 48, 24], ("tanh",) * 3, b) for b in (37, 8192)]
    for name, dims, acts, b in cases:
        ws, bs = make_stack(rng, dims, "cuda")
        x = torch.from_numpy(
            rng.standard_normal((b, dims[0])).astype(np.float32)).cuda()
        for cdt in (None, torch.bfloat16):
            key = "bfloat16" if cdt is not None else "float32"
            out, hid = cuda_mlp.mlp_fwd(x, ws, bs, acts, 0.2, cdt)
            ref, ref_hid = cuda_mlp.mlp_fwd_plain(x, ws, bs, acts, 0.2, cdt)
            torch.cuda.synchronize()
            err = max(float((a - r).abs().max())
                      for a, r in zip([out] + hid, [ref] + ref_hid))
            ok = err <= TOL[key] and all(
                bool(torch.isfinite(a).all()) for a in [out] + hid)
            print(f"  {name:5s} {dims} {acts} B={b:5d} {key:8s} "
                  f"max_abs_err={err:.3e} tol={TOL[key]:.0e} "
                  f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(
                    f"kernel disagrees with its plain version: {name} "
                    f"{dims} B={b} {key}: {err} > {TOL[key]}")


def write_jax_layout_checkpoint(path: str, seed: int) -> None:
    """A full-width nsgan checkpoint in the JAX package's npz layout
    (leaf_NNNNN arrays + __meta__ key paths): G and D params and step,
    random weights with torch-default init bounds."""
    rng = np.random.default_rng(seed)
    leaves = []
    for key, dims in (("d_params", [784, 400, 1]), ("g_params", G_DIMS)):
        for i, (k, n) in enumerate(zip(dims[:-1], dims[1:])):
            bound = 1.0 / np.sqrt(k)
            leaves.append((f"['{key}'][{i}]['b']", rng.uniform(
                -bound, bound, (n,)).astype(np.float32)))
            leaves.append((f"['{key}'][{i}]['w']", rng.uniform(
                -bound, bound, (k, n)).astype(np.float32)))
    leaves.append(("['step']", np.array(1234, dtype=np.int32)))
    flat = {f"leaf_{i:05d}": a for i, (_, a) in enumerate(leaves)}
    meta = json.dumps([{"path": p, "shape": list(a.shape), "dtype": str(a.dtype)}
                       for p, a in leaves])
    np.savez(path, **flat, __meta__=np.array(meta))


def drive_main_path(cuda_mlp, torch):
    """Phase 4. Returns (launches on the main path, max error vs plain)."""
    from generative_models_tpu_torch import cli
    from generative_models_tpu_torch.train.trainer import Trainer

    os.makedirs(OUT_DIR, exist_ok=True)
    ckpt = os.path.join(OUT_DIR, "nsgan_full.npz")
    write_jax_layout_checkpoint(ckpt, seed=0)

    buf = io.StringIO()
    cuda_mlp.launches = 0
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["--variant", "nsgan", "--ckpt", ckpt, "--sample-only",
                       "--out-dir", OUT_DIR])
    cli_launches = cuda_mlp.launches
    print(buf.getvalue().strip())
    line = json.loads(buf.getvalue().strip().splitlines()[-1])
    if rc != 0 or line["step"] != 1234 or not os.path.getsize(line["samples"]):
        raise AssertionError(f"--sample-only failed: rc={rc} {line}")
    if cli_launches < 1:
        raise AssertionError("--sample-only did not launch mlp_fwd")
    print(f"  cli --sample-only: rc={rc} mlp_fwd launches={cli_launches}")

    t = Trainer("nsgan")  # the card, by default
    t.load_model(ckpt)
    z = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (8192, 128)).astype(np.float32)).cuda()
    cuda_mlp.launches = 0
    imgs = t.sample(z=z)
    sample_launches = cuda_mlp.launches
    g = t.generator_params
    ref, _ = cuda_mlp.mlp_fwd_plain(z, [l["w"] for l in g],
                                    [l["b"] for l in g], G_ACTS, 0.2)
    err = float(np.abs(imgs - ref.cpu().numpy()).max())
    ok = (imgs.shape == (8192, 784) and np.isfinite(imgs).all()
          and imgs.min() >= 0.0 and imgs.max() <= 1.0
          and err <= TOL["float32"] and sample_launches >= 1)
    print(f"  Trainer.sample(n=8192): shape={imgs.shape} "
          f"range=[{imgs.min():.4f}, {imgs.max():.4f}] launches="
          f"{sample_launches} max_abs_err_vs_plain={err:.3e} "
          f"tol={TOL['float32']:.0e} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("Trainer.sample failed its checks")
    return cli_launches + sample_launches, err


def time_ms(torch, fn, iters: int) -> float:
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / iters


def kernel_device_ms(torch, fn, iters: int = 20):
    """Device time per launch of mlp_fwd_kernel from torch.profiler, or
    None when the profiler records no device time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "device_time_total", 0.0)
             for e in prof.key_averages() if "mlp_fwd_kernel" in e.key)
    return us / iters / 1e3 if us > 0 else None


def bound(dims, b):
    """(bound_ms, bound_by): each input read once, each output written
    once; the FMAs at the float32 (non-tensor-core) peak."""
    mats = sum(k * n for k, n in zip(dims[:-1], dims[1:]))
    nbytes = 4 * (b * dims[0] + mats + sum(dims[1:]) + b * sum(dims[1:]))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2.0 * b * mats / FP32_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops else "operations")


def time_serving(cuda_mlp, torch, card):
    """Phase 5: per serving batch, kernel / plain / library times."""
    rng = np.random.default_rng(2)
    ws, bs = make_stack(rng, G_DIMS, "cuda")
    rows = []
    for b in SERVING_BATCHES:
        z = torch.from_numpy(
            rng.standard_normal((b, G_DIMS[0])).astype(np.float32)).cuda()
        iters = 50 if b >= 8192 else 200
        k_ms = time_ms(torch, lambda: cuda_mlp.mlp_fwd(z, ws, bs, G_ACTS), iters)
        p_ms = time_ms(torch, lambda: cuda_mlp.mlp_fwd_plain(z, ws, bs, G_ACTS),
                       iters)
        l_ms = time_ms(torch, lambda: torch.sigmoid(torch.addmm(
            bs[1], torch.relu(torch.addmm(bs[0], z, ws[0])), ws[1])), iters)
        d_ms = kernel_device_ms(
            torch, lambda: cuda_mlp.mlp_fwd(z, ws, bs, G_ACTS))
        b_ms, b_by = bound(G_DIMS, b)
        rows.append({"batch": b, "ms": k_ms, "device_ms": d_ms,
                     "plain_ms": p_ms,
                     "library_ms": l_ms, "bound_ms": b_ms, "bound_by": b_by,
                     "images_per_s": b / k_ms * 1e3})
        print(f"  B={b:5d} kernel {k_ms:.4f} ms ({b / k_ms * 1e3:.0f} img/s)  "
              f"device {'not measured' if d_ms is None else f'{d_ms:.4f} ms'}"
              f"  plain {p_ms:.4f} ms  library {l_ms:.4f} ms  bound {b_ms:.4f} "
              f"ms ({b_by})  [{card}]")
    return rows


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(HERE, "generative_models_tpu_torch")):
        print("chip_smoke: the generative_models_tpu_torch package is not "
              "beside this script", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from generative_models_tpu_torch.ops import build as build_mod
    from generative_models_tpu_torch.ops import cuda_mlp

    card = nvidia_smi_line()
    print(f"[1] card: {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"    allow_tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}")

    t0 = time.perf_counter()
    cuda_mlp.build()
    print(f"[2] built mlp_fwd in {time.perf_counter() - t0:.2f} s")
    for log in glob.glob(os.path.join(build_mod.BUILD_DIR, "libmlp_fwd-*.log")):
        with open(log) as f:
            print("    " + f.read().strip().replace("\n", "\n    "))

    print("[3] kernel vs plain version on the card")
    check_kernel_vs_plain(cuda_mlp, torch)

    print("[4] serving path: cli --sample-only, Trainer.sample")
    launches, err = drive_main_path(cuda_mlp, torch)

    print("[5] times (CUDA events, warm L2)")
    rows = time_serving(cuda_mlp, torch, card)
    main_row = rows[-1]  # B = 8192, the largest serving batch

    print(json.dumps({"kernels": [{
        "name": "mlp_fwd", "route": "cuda", "source": cuda_mlp.SOURCE,
        "replaces": "generative_models_tpu/ops/pallas_mlp.py:82",
        "launches": launches, "max_abs_err": err,
        "ms": main_row["ms"], "kernel_ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"], "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"], "batch": main_row["batch"],
        "per_batch": rows}]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
