"""Where the data-parallel phase kernels' time goes, and what a call
costs, on the card: the D phase and G phase kernels of
``ops/cuda_dp.py`` (one critic update's gradients, one G update's) of
whichever checkout is first on the import path.

    PYTHONPATH=<checkout> python3 <this file> TAG [--trace] [SPEC ...]

Run the file by its path (not with ``-m``), so that the package comes
from ``PYTHONPATH`` and the same script measures two versions: it drives
only the interface every version of ``ops/cuda_dp.py`` has
(``d_phase``, ``g_phase``, ``_lib``, ``bind``). A SPEC is
``variant[:b][:bf16]`` (default: nsgan, wgangp, infogan and began at b
100 and 50, float32 and bf16). For each it prints one line ``PT TAG
spec mode ...`` a kernel with

- ``call_ms``: CUDA events around 200 back-to-back calls, over 200 (what
  the DP step pays a call when the card is the bottleneck);
- ``host_us``: the host's clock around the same 200 enqueues, over 200
  (what a call costs the host: allocations, the binding, the launch);
- without ``--trace``: ``device_ms``, the card's time a call with the
  host out of the way (:func:`queued_ms`: 50 calls queued behind a spin
  kernel, CUDA events around them; every kernel a call launches, the
  parent's memset and copy too);
- with ``--trace``, the library is an instrumented copy (built into
  ``build/torch_kernels/probe/``) in which block 0 reads the global
  timer at the kernel's entry and after every grid barrier (a version
  with ``PHASE_MARK()`` in its source: at each of them, and at
  ``PHASE_END()`` after a last barrier), and the line lists ``device_us``
  (entry to the last mark, the mean of 20 launches) and the µs of each
  phase. The marks cost a few nanoseconds each.

Without ``--trace`` the shipped libraries are timed. Alternate the
checkouts (A B B A) on one card in one command and compare nothing
across commands:

    git archive <commit> generative_models_tpu_torch | tar -x -C build/parent
    for t in A B B A; do d=$([ $t = A ] && echo build/parent || echo .)
      PYTHONPATH=$d python3 generative_models_tpu_torch/tools/phase_trace.py \
        $t; done

Needs a CUDA card and nvcc; every library a run needs is built first,
one nvcc each, all started together.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import functools
import hashlib
import os
import subprocess
import sys
import time

DEFAULT_SPECS = [f"{v}:{b}{t}" for v in ("nsgan", "wgangp", "infogan",
                                         "began")
                 for b in (100, 50) for t in ("", ":bf16")]
# hyperparameters beside the defaults (the registry's)
EXTRA = {"wgangp": dict(gp_lam=10.0), "dragan": dict(gp_lam=10.0),
         "cgan": dict(n_cls=10), "fgan": dict(fgan_div="jensen_shannon"),
         "infogan": dict(info_cat=10, info_cont=2, info_lam=1.0),
         "began": dict(began_gamma=0.75, began_lambda_k=1e-3)}
# the phases of a version without PHASE_MARK (a grid barrier after each),
# by hook
OLD_D = {"gpw": ["A", "B (+x_hat)", "C (+hh)", "DE (+g)", "N (norms, s)",
                 "F"],
         "gpb": ["A (+hh)", "B", "C (+g)", "DE (+norms, s)", "F"],
         "be": ["A", "B", "C", "R rec", "E dh", "F"]}
OLD_G = {"be": ["hg", "fake2", "G1", "G2 rf2", "G3 dh2", "G4", "G5", "G6"]}

_STAMP = ("{ if (blockIdx.x == 0 && threadIdx.x == 0) { unsigned long long "
          "t_; asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t_)); "
          "const int i_ = g_pn; if (i_ < 64) g_ts[i_] = t_; g_pn = i_ + 1; "
          "} }")
_HEAD = ("__device__ unsigned long long g_ts[64];\n__device__ int g_pn;\n")
_READ = r'''
extern "C" int probe_reset() {
  const int z = 0;
  return (int)cudaMemcpyToSymbol(g_pn, &z, sizeof(int));
}
extern "C" int probe_read(unsigned long long* out, int* n) {
  cudaMemcpyFromSymbol(n, g_pn, sizeof(int));
  return (int)cudaMemcpyFromSymbol(out, g_ts, sizeof(g_ts));
}
'''


def instrumented_source(src: str) -> str:
    """The phase library's source with the timer reads in: at every
    PHASE_MARK() where the source has them, else at the kernel's entry
    (after its copy of the arguments) and after every grid barrier."""
    if "PHASE_MARK" in src:
        return (_HEAD + f"#define PHASE_MARK() {_STAMP}\n"
                "#define PHASE_END() { grid.sync(); PHASE_MARK(); }\n" + src)
    src = src.replace("namespace cg = cooperative_groups;",
                      "namespace cg = cooperative_groups;\n" + _HEAD, 1)
    src = src.replace("  copy_args(sa, a);",
                      "  copy_args(sa, a);\n" + _STAMP, 1)
    return src.replace("grid.sync();", "grid.sync(); " + _STAMP)


@functools.cache
def _probe_lib(hook: str, bf16: bool) -> ctypes.CDLL:
    from generative_models_tpu_torch.ops import build, cuda_train
    out = os.path.join(build.BUILD_DIR, "probe")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(build.CSRC_DIR, "gan_chunk.cu")) as f:
        src = instrumented_source(f.read())
    flags = cuda_train.lib_flags(hook, bf16, phase=True)
    with open(os.path.join(build.CSRC_DIR, "chunk_common.cuh")) as f:
        header = f.read()
    # a file of its own a source, header and flags (a loaded path is not
    # reloaded)
    digest = hashlib.sha256(
        (src + header + " ".join(flags)).encode()).hexdigest()
    tag = f"gan_phase_{hook}" + ("_bf16" if bf16 else "") + f"-{digest[:12]}"
    cu = os.path.join(out, f"{tag}_trace.cu")
    so = os.path.join(out, f"lib{tag}_trace.so")
    with open(cu, "w") as f:
        f.write(src + _READ)
    r = subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, *flags, "-I",
                        build.CSRC_DIR, "-o", so, cu],
                       capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"nvcc failed on {cu}:\n{r.stdout}{r.stderr}")
    lib = ctypes.CDLL(so)
    lib.probe_read.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    return lib


def parse(spec: str):
    variant, *opts = spec.split(":")
    b = next((int(o) for o in opts if o.isdigit()), 100)
    return variant, b, "bf16" in opts


def case(torch, ct, variant: str, b: int, bf16: bool):
    """The phase kernels' inputs at full width (z 128, 400, 784), drawn
    on the card from seed 0: (hp, g, d, x, zd, zg, xtra, lam)."""
    hp = ct.ChunkHyper(**{**dict(g_lr=2e-4, d_lr=2e-4, b1=0.5, b2=0.999,
                                 eps=1e-8, slope=0.2, variant=variant,
                                 dtype="bfloat16" if bf16 else "float32"),
                          **EXTRA.get(variant, {})})
    torch.manual_seed(0)
    z, h, x = 128, 400, 784
    zi = z + hp.n_cls + hp.info_cat + hp.info_cont
    xd, l = x + hp.n_cls, hp.head_width(x)
    shapes = ((zi, h), (h,), (h, x), (x,), (xd, h), (h,), (h, l), (l,))
    p = [torch.randn(*s, device="cuda") * 0.05 for s in shapes]
    lanes = {"wgangp": 1, "dragan": x}.get(variant, 0)
    xt = torch.rand(b, lanes, device="cuda") if lanes else None
    lam = (torch.tensor(0.05, device="cuda") if variant == "began"
           else 0.0)
    return (hp, p[:4], p[4:], torch.rand(b, xd, device="cuda"),
            torch.randn(b, zi, device="cuda"),
            torch.randn(b, zi, device="cuda"), xt, lam)


def phase_names(lib, hook: str, mode: str, n: int):
    fn = getattr(lib, "gm_gan_phase_names", None)
    if fn is not None:
        fn.restype = ctypes.c_char_p
        fn.argtypes = [ctypes.c_int]
        names = fn(1 if mode == "d" else 2).decode().split(";")
    elif mode == "d":
        names = OLD_D.get(hook, ["A", "B", "C", "DE", "F"])
    else:
        names = OLD_G.get(hook, ["hg", "fake2", "G1", "G23", "G4", "G5",
                                 "G6"])
    return names if len(names) == n else [f"p{i}" for i in range(n)]


def measure(specs, trace: bool = False):
    """The rows of `specs`: {"spec", "mode", "call_ms", "host_us"} and
    with `trace` "device_us" and "phases" [(name, us)]. The traced
    libraries stand in for the shipped ones only inside this call."""
    import numpy as np
    import torch

    from generative_models_tpu_torch.ops import cuda_dp, cuda_train as ct
    need = sorted({(ct.HOOKS[v], bf16) for v, _, bf16 in map(parse, specs)})
    with concurrent.futures.ThreadPoolExecutor(len(need)) as ex:
        libs = dict(zip(need, ex.map(
            lambda k: (_probe_lib if trace else cuda_dp._lib)(*k), need)))
    shipped = cuda_dp._lib
    plans = getattr(cuda_dp, "_plans", {})  # a version's launch plans
    rows = []
    try:
        if trace:
            for lib in libs.values():
                cuda_dp.bind(lib)
            cuda_dp._lib = lambda hook, bf16=False: libs[(hook, bool(bf16))]
            plans.clear()
        for spec in specs:
            variant, b, bf16 = parse(spec)
            hook = ct.HOOKS[variant]
            hp, g, d, x, zd, zg, xt, lam = case(torch, ct, variant, b, bf16)
            calls = {"d": lambda: cuda_dp.d_phase(x, zd, xt, g, d, lam, hp),
                     "g": lambda: cuda_dp.g_phase(zg, g, d, hp)}
            for mode, fn in calls.items():
                for _ in range(5):
                    fn()
                torch.cuda.synchronize()
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                n = 200
                e0.record()
                t0 = time.perf_counter()
                for _ in range(n):
                    fn()
                host_us = (time.perf_counter() - t0) / n * 1e6
                e1.record()
                e1.synchronize()
                row = {"spec": spec, "mode": mode,
                       "call_ms": e0.elapsed_time(e1) / n, "host_us": host_us}
                if not trace:
                    row["device_ms"] = queued_ms(torch, fn)
                if trace:
                    lib = libs[(hook, bf16)]
                    ts = (ctypes.c_ulonglong * 64)()
                    cnt = ctypes.c_int()
                    runs = []
                    for _ in range(20):
                        lib.probe_reset()
                        fn()
                        torch.cuda.synchronize()
                        lib.probe_read(ts, ctypes.byref(cnt))
                        runs.append(np.diff(np.array(ts[:cnt.value],
                                                     dtype=np.float64)))
                    dt = np.mean(runs, 0) / 1e3
                    row["device_us"] = float(dt.sum())
                    row["phases"] = list(zip(
                        phase_names(lib, hook, mode, len(dt)),
                        (float(v) for v in dt)))
                rows.append(row)
    finally:
        cuda_dp._lib = shipped
        plans.clear()
    return rows


def queued_ms(torch, fn, n: int = 50, cycles: int = 40_000_000) -> float:
    """The card's ms a call of `fn` with the host out of the way: n calls
    enqueued behind a spin kernel (``torch.cuda._sleep``, ~20 ms at the
    H100's clock) that outlasts their enqueueing, CUDA events around
    them, over n. The time holds every kernel a call launches and the
    gaps between launches on the card. Raises unless the spin was still
    running when the last call had been enqueued (the host would then be
    in the time), after a longer spin each of three tries."""
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    for _ in range(3):
        torch.cuda._sleep(cycles)
        e0.record()
        for _ in range(n):
            fn()
        e1.record()
        queued = not e0.query()
        e1.synchronize()
        if queued:
            return e0.elapsed_time(e1) / n
        cycles *= 4
    raise RuntimeError(f"queued_ms: {n} calls took longer to enqueue than "
                       f"a spin of {cycles // 4} cycles")


def line(tag: str, row) -> str:
    out = (f"PT {tag} {row['spec']} {row['mode']} call_ms "
           f"{row['call_ms']:.4f} host_us {row['host_us']:.1f}")
    if "device_ms" in row:
        out += f" device_ms {row['device_ms']:.4f}"
    if "phases" in row:
        out += (f" device_us {row['device_us']:.2f} phases "
                + ", ".join(f"{p} {v:.2f}" for p, v in row["phases"]))
    return out


def main(argv) -> int:
    tag, *rest = argv
    specs = [s for s in rest if not s.startswith("--")] or DEFAULT_SPECS
    for row in measure(specs, "--trace" in rest):
        print(line(tag, row), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
