"""The yardstick of the benchmark's roofline and MFU metrics: the
published peaks of one NVIDIA H100 SXM and the operations and bytes of
the work a cell asks for.

These are frozen copies of functions of ``chip_smoke.py`` at the
repository's root, taken when the benchmark was defined; each names the
function it froze. The copies live here so that a change to the program,
or to its smoke test, cannot move the yardstick the benchmark holds it
to. Times are in seconds here (the originals give milliseconds).
"""

from __future__ import annotations

# Published H100 SXM peaks (NVIDIA data sheet, dense, at 700 W);
# chip_smoke.py's FP32_FLOP_PER_S, BF16_FLOP_PER_S, HBM_BYTES_PER_S.
FP32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12   # dense bf16 on the tensor cores
HBM_BYTES_PER_S = 3.35e12


def bound_of(flops, nbytes, peak=FP32_FLOP_PER_S):
    """(s, "bytes" or "operations"): the larger of the bytes at the HBM
    rate and the FLOPs at `peak`, the least time the card could take.
    Frozen from ``chip_smoke.py::bound_of``."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / peak
    return max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops else "operations")


def fwd_bytes(dims, b):
    """A forward's bytes: x, W and b read once, every h written once.
    Frozen from ``chip_smoke.py::fwd_bytes``."""
    mats = sum(k * n for k, n in zip(dims[:-1], dims[1:]))
    return 4 * (b * dims[0] + mats + sum(dims[1:]) + b * sum(dims[1:]))


def fwd_bound(dims, b):
    """An MLP forward over `b` rows through the widths `dims`: each input
    read once, each output written once; the FMAs at the float32
    (non-tensor-core) peak. Frozen from ``chip_smoke.py::fwd_bound``."""
    mats = sum(k * n for k, n in zip(dims[:-1], dims[1:]))
    return bound_of(2.0 * b * mats, fwd_bytes(dims, b))


def phase_flops(b, z=128, h=400, x=784, hd=400, gp=False, n_cls=0, codes=0,
                l=1):
    """(one critic update's FLOPs, one G update's). Frozen from
    ``chip_smoke.py::phase_flops``."""
    zi, xd = z + n_cls + codes, x + n_cls
    g_fwd = 2 * b * (zi * h + h * x)
    d_pass = 2 * b * (xd * hd + hd * l)
    dh = (2 * b * hd * l) if l > 1 else 0  # a pass's dh = gl W2d^T
    d_update = (g_fwd + 2 * d_pass + 2 * (2 * b) * (xd * hd + hd * l)
                + 2 * dh + (4 * 2 * b * x * hd if gp else 0))
    g_update = (g_fwd + d_pass + dh + 2 * b * hd * x + 2 * b * x * h
                + 2 * b * h * x + 2 * b * zi * h)
    return d_update, g_update


def chunk_flops_per_step(b, ds=1, z=128, h=400, x=784, hd=400, ragan=False,
                         gp=False, n_cls=0, codes=0, l=1):
    """The FLOPs of one G+D training step: `ds` critic updates and one G
    update (658.3 MFLOP for nsgan at B 100). Frozen from
    ``chip_smoke.py::chunk_flops_per_step``."""
    d_update, g_update = phase_flops(b, z, h, x, hd, gp, n_cls, codes, l)
    d_pass = 2 * b * ((x + n_cls) * hd + hd * l)
    return ds * d_update + g_update + (d_pass if ragan else 0)


def chunk_bound(steps, b, z=128, h=400, x=784, hd=400, ds=1, ragan=False,
                planes=3, lanes=0, n_cls=0, codes=0, l=1, ema=False,
                bf16=False):
    """(s, bound) of a chunk of `steps` training steps: the streams read
    once, the state (params, mu, nu; RMSprop two planes; with `ema` G's
    EMA plane too) read and written once, the metrics rows written; the
    FLOPs at the float32 peak, or the bf16 tensor-core peak with `bf16`
    (nsgan at B 100: 9.826 us a step, operations). Frozen from
    ``chip_smoke.py::chunk_bound``."""
    zi, xd = z + n_cls + codes, x + n_cls
    g_params = zi * h + h + h * x + x
    params = g_params + xd * hd + hd + hd * l + l
    nbytes = 4 * (steps * b * (ds * (xd + zi + lanes) + zi)
                  + 2 * planes * params + (2 * g_params if ema else 0)
                  + steps * 8)
    return bound_of(steps * chunk_flops_per_step(
        b, ds, z, h, x, hd, ragan=ragan, gp=lanes > 0, n_cls=n_cls,
        codes=codes, l=l), nbytes,
        BF16_FLOP_PER_S if bf16 else FP32_FLOP_PER_S)
