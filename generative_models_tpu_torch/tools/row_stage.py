"""Would a row stage make the data-parallel phase kernels faster? A probe
on the card.

    PYTHONPATH=. python3 generative_models_tpu_torch/tools/row_stage.py [b ...]

A row stage runs a phase kernel's row-local chain in one stage with no
grid barrier inside it: a thread-block cluster owns a tile of rows,
keeps its activations on chip and streams W through a cp.async ring.
That is the scheme of ``csrc/mlp_chain.cuh``, on which the whole-MLP
kernels run, and nsgan's chains are MLP stacks:

- D (one critic update): the fake rows zd -> hgd -> fake -> hf -> logit,
  the stack [Z, H, X, Hd, 1] (relu, sigmoid, leaky_relu, none), and the
  real rows x -> hr -> logit, [X, Hd, 1]; what is left is dh = dlogit
  w2d leaky'(h) a row, elementwise, then the weight gradients (phase F);
- G (one G update): the same forward stack on zg, then back from the
  logit's gradient through W2d, W1d and W2g to dhg: pass 1 of the MLP
  backward (``mlp_bwd_rows``) over that stack; then dW2g and dW1g.

For nsgan at each b (default 100 and 50, float32, full width) this runs
``mlp_fwd`` on both D stacks and on G's, and ``mlp_bwd`` on G's, with
every candidate launch plan (``ops/cuda_mlp.py::chain_candidates``),
each checked against its plain version (relative error at most 1e-4)
and timed as a CUDA graph of 20 calls (device time, no host), and
prints the fastest plans (``RS`` lines; the backward's pass 1 apart,
from ``torch.profiler`` with its event count checked). Beside them it
prints the phase kernel's own trace at the same b
(``tools/phase_trace.py --trace``: µs a phase, block 0's global timer)
and the phases the row stage would replace. Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import dataclasses
import subprocess
import sys

Z, H, X, HD = 128, 400, 784, 400
FAKE = ([Z, H, X, HD, 1], ("relu", "sigmoid", "leaky_relu", "none"))
REAL = ([X, HD, 1], ("leaky_relu", "none"))
# the phases of gan_phase_kernel that a row stage takes over
D_ROW_PHASES = ("A", "B", "C", "DE")
G_ROW_PHASES = ("hg", "fake2", "G1", "G23", "G4")


def rel_err(got, ref) -> float:
    return max(float((a - r).abs().max()) / max(float(r.abs().max()), 1e-30)
               for a, r in zip(got, ref))


def best_fwd(torch, m, graph_ms, x, ws, bs, acts):
    """(ms, plan, n plans) of the fastest forward plan, every plan checked
    against the plain version."""
    out, hid = m.mlp_fwd_plain(x, ws, bs, acts)
    ref = [out] + hid
    rows = []
    for p in m.chain_candidates(x.shape[0], [x.shape[1]] + [w.shape[1]
                                                            for w in ws],
                                False):
        o, h = m.launch_fwd(x, ws, bs, acts, 0.2, None, p)
        err = rel_err([o] + h, ref)
        if err > 1e-4:
            raise AssertionError(f"mlp_fwd plan {p}: err {err:.2e}")
        rows.append((graph_ms(torch, lambda: m.launch_fwd(
            x, ws, bs, acts, 0.2, None, p)), p))
    rows.sort(key=lambda r: r[0])
    return rows[0][0], rows[0][1], len(rows)


def best_bwd(torch, m, graph_ms, x, ws, bs, acts):
    """(ms of the whole backward, ms of its pass 1, plan, n plans) of the
    backward plan whose whole time is least."""
    out, hid = m.mlp_fwd_plain(x, ws, bs, acts)
    dy = torch.randn_like(out)
    dims = [x.shape[1]] + [w.shape[1] for w in ws]
    dws, dbs, dx = m.mlp_bwd_plain(x, hid, out, dy, ws, acts)
    chosen = m.bwd_plan(x.shape[0], dims, torch.cuda.get_device_properties(
        0).multi_processor_count)
    rows = []
    for r in m.chain_candidates(x.shape[0], dims[::-1], True):
        p = dataclasses.replace(chosen, rows=r)
        a, c, d = m.launch_bwd(x, hid, out, dy, ws, acts, 0.2, None, p)
        err = rel_err(a + c + [d], dws + dbs + [dx])
        if err > 1e-4:
            raise AssertionError(f"mlp_bwd plan {p}: err {err:.2e}")
        rows.append((graph_ms(torch, lambda: m.launch_bwd(
            x, hid, out, dy, ws, acts, 0.2, None, p)), p))
    rows.sort(key=lambda r: r[0])
    ms, p = rows[0]
    pass1 = profiled_ms(torch, lambda: m.launch_bwd(
        x, hid, out, dy, ws, acts, 0.2, None, p), "mlp_bwd_rows")
    return ms, pass1, p, len(rows)


def profiled_ms(torch, fn, name, iters=20, tries=3):
    """Device ms a call of the kernels named `name`, from torch.profiler,
    from the first of `tries` profiles that saw exactly one such kernel a
    call (the profiler can lose a kernel's events); raises if none did."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        ts = [e.time_range.elapsed_us() for e in prof.events()
              if e.device_type == DeviceType.CUDA and name in e.name]
        if len(ts) == iters:
            return sum(ts) / iters / 1e3
    raise RuntimeError(f"profiled_ms: {len(ts)} events of {name} over "
                       f"{iters} calls, {tries} times")


def main(argv) -> int:
    import torch

    from generative_models_tpu_torch.ops import cuda_mlp as m
    from generative_models_tpu_torch.tools import phase_trace
    from generative_models_tpu_torch.tools.mlp_ab import graph_ms
    torch.backends.cuda.matmul.allow_tf32 = False
    batches = [int(a) for a in argv] or [100, 50]
    trace = {(r["spec"], r["mode"]): r for r in phase_trace.measure(
        [f"nsgan:{b}" for b in batches], trace=True)}
    g = torch.Generator(device="cpu").manual_seed(3)

    def rand(*shape, scale=0.05):
        return (torch.randn(*shape, generator=g) * scale).cuda()

    wg1, wg2, wd1, wd2 = rand(Z, H), rand(H, X), rand(X, HD), rand(HD, 1)
    bg1, bg2, bd1, bd2 = rand(H), rand(X), rand(HD), rand(1)
    for b in batches:
        zd, x = rand(b, Z, scale=1.0), torch.rand(b, X, generator=g).cuda()
        fake_ms, fake_p, nf = best_fwd(torch, m, graph_ms, zd,
                                       [wg1, wg2, wd1, wd2],
                                       [bg1, bg2, bd1, bd2], FAKE[1])
        real_ms, real_p, nr = best_fwd(torch, m, graph_ms, x, [wd1, wd2],
                                       [bd1, bd2], REAL[1])
        bwd_ms, pass1_ms, bwd_p, nb = best_bwd(
            torch, m, graph_ms, zd, [wg1, wg2, wd1, wd2],
            [bg1, bg2, bd1, bd2], FAKE[1])
        print(f"RS b={b} D fake rows {FAKE[0]}: {fake_ms:.4f} ms "
              f"(best of {nf} plans: {fake_p})", flush=True)
        print(f"RS b={b} D real rows {REAL[0]}: {real_ms:.4f} ms "
              f"(best of {nr}: {real_p})", flush=True)
        print(f"RS b={b} G back {FAKE[0][::-1]}: pass 1 {pass1_ms:.4f} ms "
              f"(the whole backward {bwd_ms:.4f}; best of {nb}: "
              f"{bwd_p.rows})", flush=True)
        for mode, names, row_ms in (
                ("d", D_ROW_PHASES, (max(fake_ms, real_ms),
                                     fake_ms + real_ms)),
                ("g", G_ROW_PHASES, (fake_ms + pass1_ms,) * 2)):
            t = trace[(f"nsgan:{b}", mode)]
            ph = dict(t["phases"])
            took = sum(v for k, v in ph.items() if k in names)
            print(f"RS b={b} {mode.upper()} phase kernel "
                  f"{t['device_us']:.2f} us (" + ", ".join(
                      f"{k} {v:.2f}" for k, v in t["phases"]) + f"); "
                  f"{'+'.join(names)} {took:.2f} us against the row stage's "
                  f"chains {row_ms[0] * 1e3:.2f}"
                  + (f"-{row_ms[1] * 1e3:.2f}" if row_ms[1] != row_ms[0]
                     else "") + " us", flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
