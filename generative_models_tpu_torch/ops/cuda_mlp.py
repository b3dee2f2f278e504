"""Whole-MLP forward in one kernel launch — the port of
``generative_models_tpu/ops/pallas_mlp.py::_make_kernel`` / ``_fwd_call``.

:func:`mlp_fwd` runs a stack of ``act(h @ W + b)`` layers and returns
``(out, hiddens)``, every tensor float32. On a CUDA tensor it launches
the hand-written Hopper kernel ``csrc/mlp_fwd.cu`` (built with nvcc at
first use, see ``ops/build.py``) or raises; on a CPU tensor it runs
:func:`mlp_fwd_plain`, the same function in plain PyTorch. There is no
other path and no fallback from the kernel to the plain version.

``launches`` counts the kernel's launches, so a run can show that its
main path went through the kernel.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Sequence, Tuple

import torch

from generative_models_tpu_torch.ops.activations import apply_act

ACT_CODES = {"none": 0, "relu": 1, "leaky_relu": 2, "sigmoid": 3, "tanh": 4}
SUPPORTED_ACTS = tuple(ACT_CODES)
MAX_LAYERS = 8                 # MLP_MAX_LAYERS in csrc/mlp_fwd.cu
MAX_SMEM_BYTES = 232448        # per block on Hopper, opted in
SOURCE = "generative_models_tpu_torch/csrc/mlp_fwd.cu"

launches = 0


def acts_tuple(n: int, hidden_act: str, out_act: str) -> Tuple[str, ...]:
    """Per-layer activations: ``hidden_act`` on every layer but the last."""
    return tuple([hidden_act] * (n - 1) + [out_act])


def round_bf16(t: torch.Tensor) -> torch.Tensor:
    """Round float32 to the nearest bfloat16 and back to float32."""
    return t.to(torch.bfloat16).to(torch.float32)


def mlp_fwd_plain(x, ws: Sequence[torch.Tensor], bs: Sequence[torch.Tensor],
                  acts: Sequence[str], slope: float = 0.2,
                  compute_dtype=None) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """The kernel's function in plain PyTorch. With ``compute_dtype ==
    torch.bfloat16`` both matmul operands are rounded to bfloat16 and
    the product is taken in float32 (bf16 products are exact in float32,
    so this is bf16 operands with float32 accumulation)."""
    bf16 = compute_dtype == torch.bfloat16
    h = x
    outs = []
    for w, b, act in zip(ws, bs, acts):
        lhs, rhs = (round_bf16(h), round_bf16(w)) if bf16 else (h, w)
        h = apply_act(torch.matmul(lhs, rhs) + b, act, slope)
        outs.append(h)
    return outs[-1], outs[:-1]


def _check(x, ws, bs, acts, compute_dtype):
    if compute_dtype not in (None, torch.float32, torch.bfloat16):
        raise ValueError(f"compute_dtype must be None, float32 or bfloat16, "
                         f"got {compute_dtype}")
    n = len(ws)
    if not 1 <= n <= MAX_LAYERS or len(bs) != n or len(acts) != n:
        raise ValueError(
            f"mlp_fwd takes 1..{MAX_LAYERS} layers with one bias and one "
            f"activation each; got {n} weights, {len(bs)} biases, "
            f"{len(acts)} activations")
    bad = [a for a in acts if a not in ACT_CODES]
    if bad:
        raise ValueError(
            f"mlp_fwd supports activations {SUPPORTED_ACTS}, got {bad}")
    if x.dim() != 2:
        raise ValueError(f"x must be [B, K0], got shape {tuple(x.shape)}")
    k = x.shape[1]
    for i, (w, b) in enumerate(zip(ws, bs)):
        if w.dim() != 2 or w.shape[0] != k or tuple(b.shape) != (w.shape[1],):
            raise ValueError(
                f"layer {i}: expected W [{k}, N] and b [N], got W "
                f"{tuple(w.shape)} and b {tuple(b.shape)}")
        k = w.shape[1]
    for name, t in [("x", x)] + [(f"W{i}", w) for i, w in enumerate(ws)] + [
            (f"b{i}", b) for i, b in enumerate(bs)]:
        if t.dtype != torch.float32:
            raise TypeError(f"mlp_fwd takes float32 tensors; {name} is {t.dtype}")
        if t.device != x.device:
            raise ValueError(
                f"{name} is on {t.device} but x is on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


@functools.cache
def _lib():
    from generative_models_tpu_torch.ops.build import build_library
    lib = build_library("mlp_fwd", ["mlp_fwd.cu"])
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.gm_mlp_fwd.argtypes = [p, i, i, ctypes.POINTER(i), ctypes.POINTER(p),
                               ctypes.POINTER(p), ctypes.POINTER(p),
                               ctypes.POINTER(i), ctypes.c_float, i, i, p]
    lib.gm_mlp_fwd.restype = i
    return lib


def build() -> None:
    """Compile (or load) the kernel's library now instead of at first use."""
    _lib()


def smem_bytes(dims: Sequence[int], tile_rows: int) -> int:
    """Shared memory a launch needs: two alternating input tiles, sized by
    the widest even-layer and odd-layer inputs (rounded up to 4 floats).
    The same formula as gm_mlp_fwd in csrc/mlp_fwd.cu."""
    r4 = [-(-d // 4) * 4 for d in dims[:-1]]
    return tile_rows * (max(r4[0::2]) + max(r4[1::2], default=0)) * 4


def tile_rows_for(batch: int, dims: Sequence[int], sm_count: int) -> int:
    """Rows per block: 32 when the batch fills every SM with 32-row tiles,
    else 16 (twice the blocks at small batches). Raises when even a
    16-row tile does not fit in shared memory."""
    for t in ((32, 16) if batch >= 32 * sm_count else (16,)):
        if smem_bytes(dims, t) <= MAX_SMEM_BYTES:
            return t
    raise ValueError(
        f"mlp_fwd: layer widths {list(dims)} need "
        f"{smem_bytes(dims, 16)} bytes of shared memory for a 16-row tile; "
        f"a block has {MAX_SMEM_BYTES}")


def mlp_fwd(x, ws: Sequence[torch.Tensor], bs: Sequence[torch.Tensor],
            acts: Sequence[str], slope: float = 0.2,
            compute_dtype=None) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """Whole-MLP forward: returns ``(out, [h_1, ..., h_{n-1}])``.

    CPU tensors run :func:`mlp_fwd_plain`; CUDA tensors launch the
    kernel on the current stream (no synchronisation) or raise."""
    global launches
    _check(x, ws, bs, acts, compute_dtype)
    if x.device.type == "cpu":
        return mlp_fwd_plain(x, ws, bs, acts, slope, compute_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"mlp_fwd runs on cuda or cpu tensors, not {x.device}")
    n = len(ws)
    dims = [x.shape[1]] + [w.shape[1] for w in ws]
    batch = x.shape[0]
    outs = [torch.empty((batch, d), device=x.device, dtype=torch.float32)
            for d in dims[1:]]
    if batch == 0:
        return outs[-1], outs[:-1]
    sm_count = torch.cuda.get_device_properties(x.device).multi_processor_count
    tile_rows = tile_rows_for(batch, dims, sm_count)
    lib = _lib()
    c_dims = (ctypes.c_int * (n + 1))(*dims)
    c_ws = (ctypes.c_void_p * n)(*[w.data_ptr() for w in ws])
    c_bs = (ctypes.c_void_p * n)(*[b.data_ptr() for b in bs])
    c_outs = (ctypes.c_void_p * n)(*[o.data_ptr() for o in outs])
    c_acts = (ctypes.c_int * n)(*[ACT_CODES[a] for a in acts])
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.gm_mlp_fwd(x.data_ptr(), batch, n, c_dims, c_ws, c_bs, c_outs,
                            c_acts, float(slope),
                            int(compute_dtype == torch.bfloat16), tile_rows,
                            stream)
    if rc != 0:
        raise RuntimeError(f"mlp_fwd kernel launch failed: CUDA error {rc}")
    launches += 1
    return outs[-1], outs[:-1]
