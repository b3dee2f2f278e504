"""Where the chunk kernels' time goes, phase by phase, on the card.

    python3 -m generative_models_tpu_torch.tools.chunk_phases

Builds instrumented copies of ``csrc/gan_chunk.cu`` (one per critic
hook it times) and ``csrc/vae_chunk.cu`` into
``build/torch_kernels/probe/`` — block 0 reads the global timer after
every grid barrier — runs an 8-step chunk of nsgan (d_steps 1), of wgan
(d_steps 5, RMSprop, clip: its five critic updates are phases A0..F0 to
A4..F4), of ragan (DE and G23 split in two: the logits, then the
gradients; G1 with 2B rows), of fishergan (DE split), of the VAE and of
the BIR-VAE (mse) at full width (B = 100) and prints the mean device
time of each phase over steps 1-6,
then the cost of a bare grid barrier at 1, 2 and 3 blocks a SM, and the
latency of a dependent load from L2 (a pointer chase over 16 MB) with
``ld.global.cg`` and with an ordinary load. The shipped kernels are not
changed; the timer reads cost a few nanoseconds a barrier. Needs a CUDA
card and nvcc.
"""

from __future__ import annotations

import ctypes
import math
import os
import subprocess

G_PHASES = ["G1", "G23", "G4", "G5", "G6"]
RA_G_PHASES = ["G1 (2B rows)", "G2 logits", "G3 grads", "G4", "G5", "G6"]
D_PHASES = ["A", "B", "C", "DE", "F"]
COUPLED_D_PHASES = ["A", "B", "C", "DE logits", "DE grads", "F"]
# (name, hook, d_steps, ChunkHyper fields, the phases of one step)
GAN_CASES = [
    ("nsgan", 1, {}, D_PHASES + G_PHASES),
    ("wgan", 5, dict(optimizer="rmsprop", clip=0.01, g_lr=5e-5, d_lr=5e-5),
     [f"{p}{i}" for i in range(5) for p in D_PHASES] + G_PHASES),
    ("ragan", 1, {}, COUPLED_D_PHASES + RA_G_PHASES),
    ("fishergan", 1, dict(fisher_rho=1e-6), COUPLED_D_PHASES + G_PHASES),
]
# the phases of csrc/vae_chunk.cu, as its header numbers them
VAE_PHASES = ["1 henc", "2 mu,lv", "3 z", "4 hd", "5 lg", "6 dhd",
              "7 dW2,dz", "8 dW1,g", "9 dhe", "9b dhe+,dWmu", "10 dWlv,dWtr"]
BIRVAE_PHASES = ["1 henc", "2 mu", "3 moments,z", "4 hd", "5 lg", "6 dhd",
                 "7 dW2,dz", "8 dW1,g", "9 dhe", "10 dWmu,dWtr"]

_READ = r'''
extern "C" int probe_read(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_ts, sizeof(g_ts));
}
'''

_PROBE = r'''
__global__ void barrier_only(int n, float* sink) {
  cg::grid_group grid = cg::this_grid();
  float v = 0.0f;
  for (int i = 0; i < n; ++i) { v += 1.0f; grid.sync(); }
  if (threadIdx.x == 0 && blockIdx.x == 0) sink[0] = v;
}
__global__ void chase(const int* nxt, int n, int* out, int cg) {
  int i = 0;
  if (cg) { for (int s = 0; s < n; ++s) i = __ldcg(nxt + i); }
  else { for (int s = 0; s < n; ++s) i = nxt[i]; }
  out[0] = i;
}
extern "C" float probe_chase(const int* nxt, int n, int* out, int cg) {
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  chase<<<1, 1>>>(nxt, 100, out, cg);
  cudaEventRecord(e0);
  chase<<<1, 1>>>(nxt, n, out, cg);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms = 0.0f;
  cudaEventElapsedTime(&ms, e0, e1);
  return ms;
}
extern "C" float probe_barrier(int blocks, int n, float* sink) {
  void* args[] = {&n, &sink};
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  cudaEventRecord(e0);
  cudaLaunchCooperativeKernel((const void*)barrier_only, dim3(blocks),
                              dim3(256), args, 0, 0);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms = 0.0f;
  cudaEventElapsedTime(&ms, e0, e1);
  return ms;
}
'''


def instrumented_source(src: str) -> str:
    """The kernel with a global-timer read after every grid barrier."""
    src = src.replace(
        "namespace cg = cooperative_groups;",
        "namespace cg = cooperative_groups;\n"
        "__device__ unsigned long long g_ts[256];\n")
    src = src.replace("  for (int k = 0; k < a.steps; ++k) {",
                      "  int ph = 0;\n  for (int k = 0; k < a.steps; ++k) {",
                      1)
    src = src.replace(
        "grid.sync();",
        "grid.sync(); if (blockIdx.x == 0 && threadIdx.x == 0) {"
        " unsigned long long t; asm volatile(\"mov.u64 %0, %%globaltimer;\""
        " : \"=l\"(t)); if (ph < 256) g_ts[ph] = t; ph++; }")
    return src


def _build(build, name: str, probe: str = "", flags=(),
           tag: str = "") -> ctypes.CDLL:
    """Compile an instrumented copy of csrc/<name>.cu and load it."""
    out_dir = os.path.join(build.BUILD_DIR, "probe")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(build.CSRC_DIR, f"{name}.cu")) as f:
        src = instrumented_source(f.read())
    cu = os.path.join(out_dir, f"{name}{tag}_phases.cu")
    so = os.path.join(out_dir, f"lib{name}{tag}_phases.so")
    with open(cu, "w") as f:
        f.write(src + _READ + probe)
    subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, *flags, "-I",
                    build.CSRC_DIR, "-o", so, cu],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(so)
    lib.probe_read.argtypes = [ctypes.c_void_p]
    return lib


def _report(np, lib, name, grid, steps, phases):
    ts = (ctypes.c_ulonglong * 256)()
    lib.probe_read(ts)
    n = len(phases)
    t = np.array(ts[:n * steps], dtype=np.float64)
    # t[j] ends phase j % n of step j // n; steps 1..6 are read
    d = (t[n:n * (steps - 1)] - t[n - 1:n * (steps - 1) - 1]).reshape(
        steps - 2, n)
    print(f"{name}: grid {grid} blocks; per step {d.sum(1).mean() / 1e3:.1f} "
          f"us: " + ", ".join(f"{p} {v / 1e3:.1f}"
                              for p, v in zip(phases, d.mean(0))))


def gan_phases(np, torch, build) -> ctypes.CDLL:
    """Times each case of GAN_CASES; returns nsgan's library (it carries
    the barrier and load probes)."""
    from generative_models_tpu_torch.ops import cuda_train as ct
    b, steps, z, h, x = 100, 8, 128, 400, 784
    first = None
    for variant, ds, kw, phases in GAN_CASES:
        hook = ct.HOOKS[variant]
        lib = _build(build, "gan_chunk", _PROBE if first is None else "",
                     flags=(f"-DGM_HOOK={ct.HOOK_IDS[hook]}",), tag=f"_{hook}")
        first = first or lib
        ct.bind(lib)
        hp = ct.ChunkHyper(**{**dict(g_lr=2e-4, d_lr=2e-4, b1=0.5, b2=0.999,
                                     eps=1e-8, slope=0.2, variant=variant),
                              **kw})
        torch.manual_seed(0)
        shapes = ((z, h), (h,), (h, x), (x,), (x, h), (h,), (h, 1), (1,))
        params = [torch.randn(*sh, device="cuda") * 0.05 for sh in shapes]
        if hp.clip > 0:
            params = params[:4] + [t.clamp(-hp.clip, hp.clip)
                                   for t in params[4:]]
        mu = [torch.zeros_like(t) for t in params]
        nu = [torch.zeros_like(t) for t in params]
        xs = torch.rand(steps * ds * b, x, device="cuda")
        zd = torch.randn(steps * ds * b, z, device="cuda")
        zg = torch.randn(steps * b, z, device="cuda")
        scratch = torch.empty(lib.gm_gan_chunk_scratch_floats(b, z, h, x, h),
                              device="cuda")
        metrics = torch.zeros(steps, ct.METRIC_LANES, device="cuda")
        lam = torch.zeros(1, device="cuda")
        ptrs = ([t.data_ptr() for t in params]
                + ([t.data_ptr() for t in mu] if hp.adam else [None] * 8)
                + [t.data_ptr() for t in nu])
        state = (ctypes.c_void_p * 24)(*ptrs)
        grid = lib.gm_gan_chunk_grid(2, int(not hp.adam))
        hyper = ct.hyper_struct(hp, steps=steps, ds=ds, batch=b, z=z, h=h,
                                x=x, hd=h, t_g=0, t_d=0)
        for _ in range(2):  # the second run is the one read
            rc = lib.gm_gan_chunk(
                xs.data_ptr(), zd.data_ptr(), zg.data_ptr(), state,
                scratch.data_ptr(), metrics.data_ptr(), lam.data_ptr(),
                ctypes.byref(hyper), grid, None)
            torch.cuda.synchronize()
            if rc != 0:
                raise RuntimeError(f"launch failed: CUDA error {rc}")
        _report(np, lib, f"gan_chunk {variant} (d_steps {ds}, "
                f"{hp.optimizer})", grid, steps, phases)
    return first


def vae_phases(np, torch, build) -> None:
    lib = _build(build, "vae_chunk")
    p, i, fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.gm_vae_chunk.argtypes = ([p, p, ctypes.POINTER(p), p, p]
                                 + [i] * 6 + [fl] * 10 + [i, i, i, p])
    lib.gm_vae_chunk_scratch_floats.argtypes = [i] * 4
    lib.gm_vae_chunk_scratch_floats.restype = ctypes.c_longlong
    lib.gm_vae_chunk_grid.argtypes = [i, i]
    b, steps, x, h, l = 100, 8, 784, 400, 20
    for birvae, phases in ((0, VAE_PHASES), (1, BIRVAE_PHASES)):
        torch.manual_seed(0)
        shapes = ((x, h), (h,), (h, l), (l,), (h, l), (l,), (l, h), (h,),
                  (h, x), (x,))
        params = [torch.randn(*s, device="cuda") * 0.05 for s in shapes]
        slots = [torch.zeros_like(t) for t in params + params]
        ptrs = [t.data_ptr() for t in params + slots]
        if birvae:  # no lv head: its slots stay null
            ptrs = [None if q % 10 in (4, 5) else v
                    for q, v in enumerate(ptrs)]
        xs = torch.rand(steps * b, x, device="cuda")
        es = torch.randn(steps * b, l, device="cuda")
        scratch = torch.empty(lib.gm_vae_chunk_scratch_floats(b, x, h, l),
                              device="cuda")
        metrics = torch.empty(steps, 3, device="cuda")
        state = (ctypes.c_void_p * 30)(*ptrs)
        grid = lib.gm_vae_chunk_grid(2, birvae)
        for _ in range(2):  # the second run is the one read
            rc = lib.gm_vae_chunk(
                xs.data_ptr(), es.data_ptr(), state, scratch.data_ptr(),
                metrics.data_ptr(), steps, b, x, h, l, 0, 1e-3, 0.9, 0.999,
                1.0 - 0.9, 1.0 - 0.999, 1e-8, math.log(0.9), math.log(0.999),
                1.0 / b, 0.1, birvae, birvae, grid, None)
            torch.cuda.synchronize()
            if rc != 0:
                raise RuntimeError(f"launch failed: CUDA error {rc}")
        _report(np, lib, "birvae_chunk mse" if birvae else "vae_chunk bce",
                grid, steps, phases)


def main() -> int:
    import numpy as np
    import torch

    from generative_models_tpu_torch.ops import build

    lib = gan_phases(np, torch, build)
    vae_phases(np, torch, build)
    p, i, fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.probe_barrier.argtypes = [i, i, p]
    lib.probe_barrier.restype = fl
    lib.probe_chase.argtypes = [p, i, p, i]
    lib.probe_chase.restype = fl
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    sink = torch.zeros(1, device="cuda")
    for per_sm in (1, 2, 3):
        lib.probe_barrier(per_sm * sms, 100, sink.data_ptr())
        ms = lib.probe_barrier(per_sm * sms, 10000, sink.data_ptr())
        print(f"bare grid barrier, {per_sm * sms} blocks: "
              f"{ms / 10000 * 1e3:.3f} us")
    nxt = torch.from_numpy(np.random.default_rng(0).permutation(
        1 << 22).astype(np.int32)).cuda()
    out = torch.zeros(1, dtype=torch.int32, device="cuda")
    for cg, name in ((1, "ld.global.cg"), (0, "ordinary load")):
        ms = lib.probe_chase(nxt.data_ptr(), 20000, out.data_ptr(), cg)
        print(f"dependent load from L2, {name}: {ms / 20000 * 1e6:.0f} ns")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
