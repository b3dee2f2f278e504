"""Times the whole-MLP forward and backward kernels of whichever checkout
is first on the import path, to compare two versions of them on one card
in one sitting.

    PYTHONPATH=<checkout A> python3 <this file> A
    PYTHONPATH=<checkout B> python3 <this file> B
    PYTHONPATH=<checkout B> python3 <this file> B --sweep [--only=fwd:G:8192,...]

Run the file by its path (not with ``-m``), so that the package comes
from ``PYTHONPATH``. At every shape that ``chip_smoke.py`` phase 5a
times (nsgan G 128->400->784 at B 64, 100, 1024 and 8192, D 784->400->1
at B 100, the one-layer 784->400 leaky_relu at B 100 and 8192; the
backward at G B 100, D B 100 and G B 8192; float32, and bf16 operands at
G B 100 and 8192) it prints five medians of CUDA-event timings in ms a
call (each over 20-200 calls, after a warm-up) and the device time of
each kernel by name from ``torch.profiler`` (the backward's passes apart),
then the card's nvidia-smi line. It speaks the interface every version of
``ops/cuda_mlp.py`` shares (``mlp_fwd``, ``mlp_bwd``). Alternate the
checkouts (A B B A) on one card in one sitting; compare nothing across
machines or sittings.

``--sweep`` (versions with launch plans only) runs every candidate plan
of each shape once against the plain version, then times it as a CUDA
graph of 20 calls (device time without the host's enqueue), and prints
the planner's choice and every plan, fastest first (``--only`` limits it
to the listed ``kind:name:B`` shapes). Then, in versions with the GEMM
route, it times every one-layer shape of ``ONE_LAYER`` at each batch of
``GEMM_BATCHES`` on the chain's planned launch and on every GEMM tile
(each checked against the plain version first), prints the planner's
tile, the fastest tile and the chain, and the crossover: the least
batch from which the planner's GEMM beats the chain at every shape and
every larger batch, the measurement behind ``GEMM_MIN_ROWS``. Needs a
CUDA card and nvcc.
"""

from __future__ import annotations

import dataclasses
import statistics
import subprocess
import sys

G = ([128, 400, 784], ("relu", "sigmoid"))
D = ([784, 400, 1], ("leaky_relu", "none"))
LIN = ([784, 400], ("leaky_relu",))
FWD_SHAPES = [("G", G, 64), ("G", G, 100), ("G", G, 1024), ("G", G, 8192),
              ("D", D, 100), ("lin", LIN, 100), ("lin", LIN, 8192)]
BWD_SHAPES = [("G", G, 100), ("D", D, 100), ("G", G, 8192)]
BF16_SHAPES = [("G", G, 100), ("G", G, 8192)]
# one-layer calls the GEMM route may take: the diffusion net's six
# widths (skip, in, the time MLP, its projections, mid, out), the
# one-layer 784->400 leaky_relu, the VQ prior's qkv, fc1, fc2 and head
ONE_LAYER = [("skip", [784, 784], "none"), ("in", [784, 400], "none"),
             ("time", [128, 128], "none"), ("tproj", [128, 400], "none"),
             ("mid", [400, 400], "none"), ("out", [400, 784], "none"),
             ("lin", [784, 400], "leaky_relu"), ("qkv", [128, 384], "none"),
             ("fc1", [128, 512], "none"), ("fc2", [512, 128], "none"),
             ("head", [128, 64], "none")]
GEMM_BATCHES = (256, 384, 512, 768, 1024, 1600, 2048, 3072, 4096, 8192,
                10000)


def stack(torch, dims, b, seed):
    g = torch.Generator(device="cpu").manual_seed(seed)
    ws = [((torch.rand(k, n, generator=g) * 2 - 1) / k ** 0.5).cuda()
          for k, n in zip(dims[:-1], dims[1:])]
    bs = [((torch.rand(n, generator=g) * 2 - 1) / 20).cuda() for n in dims[1:]]
    x = torch.randn(b, dims[0], generator=g).cuda()
    return x, ws, bs


def event_ms(torch, fn, iters):
    for _ in range(3):
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


def device_ms_by_kernel(torch, fn, iters=20):
    """{kernel name: device ms a call} of the kernels whose names hold
    "mlp_", from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", 0.0)
        if "mlp_" in e.key and t > 0:
            name = e.key.split("(")[0].split("<")[0].replace("void ", "")
            out[name] = out.get(name, 0.0) + t / iters / 1e3
    return out


def graph_ms(torch, fn, calls=20, replays=5):
    """Device ms a call of `fn` replayed as a CUDA graph of `calls`."""
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        fn()
    torch.cuda.current_stream().wait_stream(s)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(replays):
        graph.replay()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / (calls * replays)


def ab(tag, torch, m):
    cases = [("fwd", name, spec, b, None) for name, spec, b in FWD_SHAPES]
    cases += [("bwd", name, spec, b, None) for name, spec, b in BWD_SHAPES]
    cases += [(kind, name, spec, b, torch.bfloat16)
              for kind in ("fwd", "bwd") for name, spec, b in BF16_SHAPES]
    for kind, name, (dims, acts), b, cdt in cases:
        x, ws, bs = stack(torch, dims, b, 7)
        if kind == "fwd":
            def fn():
                return m.mlp_fwd(x, ws, bs, acts, 0.2, cdt)
        else:
            out, hid = m.mlp_fwd(x, ws, bs, acts, 0.2, cdt)
            dy = torch.randn_like(out)

            def fn():
                return m.mlp_bwd(x, hid, out, dy, ws, acts, 0.2, cdt)
        iters = 20 if b >= 8192 else 200
        runs = sorted(event_ms(torch, fn, iters) for _ in range(5))
        dev = device_ms_by_kernel(torch, fn)
        key = "bf16" if cdt is not None else "f32"
        print(f"MLPAB {tag} {kind} {name} B={b} {key} ms: "
              + " ".join(f"{r:.4f}" for r in runs)
              + f" median {statistics.median(runs):.4f} device "
              + " ".join(f"{k}={v:.4f}" for k, v in sorted(dev.items()))
              + f" total={sum(dev.values()):.4f}", flush=True)


def sweep(tag, torch, m, only=None):
    sm = torch.cuda.get_device_properties(0).multi_processor_count
    for kind in ("fwd", "bwd"):
        shapes = FWD_SHAPES if kind == "fwd" else BWD_SHAPES
        for name, (dims, acts), b in shapes:
            if only and f"{kind}:{name}:{b}" not in only:
                continue
            x, ws, bs = stack(torch, dims, b, 8)
            out, hid = m.mlp_fwd_plain(x, ws, bs, acts)
            dy = torch.randn_like(out)
            if kind == "fwd":
                chosen = m.fwd_plan(b, dims, sm)
                plans = list(m.chain_candidates(b, dims, False))
                ref = [out] + hid

                def run(p):
                    o, h = m.launch_fwd(x, ws, bs, acts, 0.2, None, p)
                    return [o] + h
            else:
                chosen = m.bwd_plan(b, dims, sm)
                plans = [dataclasses.replace(chosen, rows=p)
                         for p in m.chain_candidates(b, dims[::-1], True)]
                for s in (1, 2, 3, 4, 5, 6, 8, 10, 12, 16):
                    p = m.bwd_plan(b, dims, sm, slices=s)
                    if p.slices == s and s != chosen.slices:
                        plans.append(p)
                dws, dbs, dx = m.mlp_bwd_plain(x, hid, out, dy, ws, acts)
                ref = dws + dbs + [dx]

                def run(p):
                    a, c, d = m.launch_bwd(x, hid, out, dy, ws, acts, 0.2,
                                           None, p)
                    return a + c + [d]
            rows = []
            for p in plans:
                got = run(p)
                torch.cuda.synchronize()
                err = max(float((a - r).abs().max())
                          / max(float(r.abs().max()), 1e-30)
                          for a, r in zip(got, ref))
                ms = graph_ms(torch, lambda: run(p))
                rows.append((ms, err, p))
            rows.sort(key=lambda r: r[0])
            worst = max(r[1] for r in rows)
            pick = next(r for r in rows if r[2] == chosen)
            print(f"SWEEP {tag} {kind} {name} B={b}: {len(rows)} plans, "
                  f"worst err/max|ref| {worst:.3e}; chosen {pick[0]:.4f} ms "
                  f"(rank {rows.index(pick) + 1}) {chosen}", flush=True)
            for ms, err, p in rows:
                print(f"SWEEP {tag}   {ms:.4f} ms err {err:.1e} {p}",
                      flush=True)


def gemm_sweep(tag, torch, m):
    """The GEMM route against the chain at every ONE_LAYER shape and
    GEMM_BATCHES batch (see the module's docstring)."""
    sm = torch.cuda.get_device_properties(0).multi_processor_count
    wins = {}  # batch -> the planner's GEMM beat the chain at every shape
    for name, dims, act in ONE_LAYER:
        for b in GEMM_BATCHES:
            x, ws, bs = stack(torch, dims, b, 9)
            ref, _ = m.mlp_fwd_plain(x, ws, bs, (act,))
            chain = m.fwd_plan(b, dims, sm)
            c_ms = graph_ms(torch, lambda: m.launch_fwd(
                x, ws, bs, (act,), 0.2, None, chain))
            pick = m.gemm_plan(b, dims[1], sm)
            rows = []
            for bm, bn in m.GEMM_TILES:
                p = m.GemmPlan(bm, bn, -(-b // bm), -(-dims[1] // bn),
                               m.gemm_smem_bytes(bm, bn))
                got = m.launch_gemm(x, ws[0], bs[0], act, 0.2, p)
                torch.cuda.synchronize()
                err = float((got - ref).abs().max())
                if not err <= 1e-4:
                    raise AssertionError(f"GEMM {p} at {name} B={b}: "
                                         f"max abs err {err}")
                ms = graph_ms(torch, lambda: m.launch_gemm(
                    x, ws[0], bs[0], act, 0.2, p))
                rows.append((ms, p))
            rows.sort(key=lambda r: r[0])
            p_ms = next(ms for ms, p in rows if p == pick)
            wins[b] = wins.get(b, True) and p_ms < c_ms
            print(f"GEMM {tag} {name} {dims} B={b}: chain {c_ms:.4f} ms; "
                  f"planner {pick.bm}x{pick.bn} {p_ms:.4f} ms "
                  f"(x{c_ms / p_ms:.2f}); fastest "
                  + " ".join(f"{p.bm}x{p.bn}={ms:.4f}" for ms, p in rows),
                  flush=True)
    cross = None
    for b in sorted(wins, reverse=True):
        if not wins[b]:
            break
        cross = b
    print(f"GEMM {tag} crossover: the planner's GEMM beats the chain at "
          f"every shape from B={cross} (batches {sorted(wins)}; "
          f"GEMM_MIN_ROWS {m.GEMM_MIN_ROWS})", flush=True)


def main(argv) -> int:
    import torch

    from generative_models_tpu_torch.ops import cuda_mlp as m
    torch.backends.cuda.matmul.allow_tf32 = False
    tag = argv[0]
    if "--sweep" in argv:
        only = [a.split("=", 1)[1].split(",") for a in argv
                if a.startswith("--only=")]
        sweep(tag, torch, m, only[0] if only else None)
        if hasattr(m, "launch_gemm"):
            gemm_sweep(tag, torch, m)
    else:
        ab(tag, torch, m)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
