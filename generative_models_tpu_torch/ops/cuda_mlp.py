"""Whole-MLP forward and backward kernels — the port of
``generative_models_tpu/ops/pallas_mlp.py`` (``_make_kernel``/``_fwd_call``,
``_make_bwd_kernel``/``_bwd_call`` and the ``mlp_pallas`` custom VJP).

- :func:`mlp_fwd` runs a stack of ``act(h @ W + b)`` layers and returns
  ``(out, hiddens)``, every tensor float32 (``csrc/mlp_fwd.cu``).
- :func:`mlp_bwd` returns every dW, db and dx of the stack from the
  forward's saved activations (``csrc/mlp_bwd.cu``).
- :class:`MLPFunction` is the ``torch.autograd.Function`` that joins
  them, the counterpart of ``mlp_pallas.defvjp``: training on the card
  goes through it (``models/mlp.py::mlp_apply``).

On a CUDA tensor each wrapper launches its hand-written Hopper kernel
(built with nvcc at first use, see ``ops/build.py``) or raises; on a CPU
tensor it runs its plain PyTorch version (:func:`mlp_fwd_plain`,
:func:`mlp_bwd_plain`). There is no other path and no fallback from a
kernel to its plain version. A kernel's outputs carry no autograd graph,
so :func:`mlp_fwd` refuses a CUDA input that requires grad while grad
mode is on: such a call must go through :class:`MLPFunction`.

``launches`` and ``bwd_launches`` count the kernels' launches, so a run
can show that its main path went through them.
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
BWD_SOURCE = "generative_models_tpu_torch/csrc/mlp_bwd.cu"

launches = 0
bwd_launches = 0


def acts_tuple(n: int, hidden_act: str, out_act: str) -> Tuple[str, ...]:
    """Per-layer activations: ``hidden_act`` on every layer but the last."""
    return tuple([hidden_act] * (n - 1) + [out_act])


def round_bf16(t: torch.Tensor) -> torch.Tensor:
    """Round to the nearest bfloat16 and back to `t`'s dtype (float32, or
    float64 in an oracle)."""
    return t.to(torch.bfloat16).to(t.dtype)


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
    """Validates a stack's inputs; ``bs=None`` checks the weights only."""
    if compute_dtype not in (None, torch.float32, torch.bfloat16):
        raise ValueError(f"compute_dtype must be None, float32 or bfloat16, "
                         f"got {compute_dtype}")
    n = len(ws)
    nb = n if bs is None else len(bs)
    if not 1 <= n <= MAX_LAYERS or nb != n or len(acts) != n:
        raise ValueError(
            f"mlp_fwd takes 1..{MAX_LAYERS} layers with one bias and one "
            f"activation each; got {n} weights, {nb} biases, "
            f"{len(acts)} activations")
    bad = [a for a in acts if a not in ACT_CODES]
    if bad:
        raise ValueError(
            f"mlp_fwd supports activations {SUPPORTED_ACTS}, got {bad}")
    if x.dim() != 2:
        raise ValueError(f"x must be [B, K0], got shape {tuple(x.shape)}")
    k = x.shape[1]
    for i, w in enumerate(ws):
        b_ok = bs is None or tuple(bs[i].shape) == (w.shape[-1],)
        if w.dim() != 2 or w.shape[0] != k or not b_ok:
            raise ValueError(
                f"layer {i}: expected W [{k}, N] and b [N], got W "
                f"{tuple(w.shape)} and b "
                f"{None if bs is None else tuple(bs[i].shape)}")
        k = w.shape[1]
    for name, t in [("x", x)] + [(f"W{i}", w) for i, w in enumerate(ws)] + [
            (f"b{i}", b) for i, b in enumerate(bs or [])]:
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
    kernel on the current stream (no synchronisation) or raise. A
    non-CPU input that requires grad under grad mode raises: the
    kernel's outputs would carry no graph (use :class:`MLPFunction`)."""
    global launches
    _check(x, ws, bs, acts, compute_dtype)
    if x.device.type == "cpu":
        return mlp_fwd_plain(x, ws, bs, acts, slope, compute_dtype)
    _refuse_untracked_grad("mlp_fwd", [x, *ws, *bs])
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


def _refuse_untracked_grad(name: str, tensors) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: an input requires grad, but the kernel's outputs carry "
            "no autograd graph; call MLPFunction.apply (or "
            "models.mlp.mlp_apply) to train through the kernels")


# ---------------------------------------------------------------------
# Backward: every dW, db and dx in one C entry (csrc/mlp_bwd.cu)
# ---------------------------------------------------------------------

def act_deriv_from_out(y, act: str, slope: float = 0.2):
    """act'(pre-activation) through the activation's output y, as the
    reference's ``_act_deriv_from_out``."""
    if act == "none":
        return torch.ones_like(y)
    if act == "relu":
        return (y > 0).to(y.dtype)
    if act == "leaky_relu":
        return torch.where(y >= 0, 1.0, slope).to(y.dtype)
    if act == "sigmoid":
        return y * (1.0 - y)
    if act == "tanh":
        return 1.0 - y * y
    raise ValueError(f"unsupported activation {act!r}")


def mlp_bwd_plain(x, hiddens, out, dy, ws, acts: Sequence[str],
                  slope: float = 0.2, compute_dtype=None):
    """The backward kernel's function in plain PyTorch (the twin of the
    reference's ``_vjp_bwd_xla``, with the kernel's bf16 operand
    rounding): returns ``(dws, dbs, dx)``."""
    rnd = round_bf16 if compute_dtype == torch.bfloat16 else (lambda t: t)
    n = len(ws)
    inputs = [x] + list(hiddens)
    g = dy * act_deriv_from_out(out, acts[-1], slope)
    dws, dbs = [None] * n, [None] * n
    for i in range(n - 1, -1, -1):
        dws[i] = torch.matmul(rnd(inputs[i]).t(), rnd(g))
        dbs[i] = torch.sum(g, dim=0)
        g = torch.matmul(rnd(g), rnd(ws[i]).t())
        if i > 0:
            g = g * act_deriv_from_out(inputs[i], acts[i - 1], slope)
    return dws, dbs, g


@functools.cache
def _bwd_lib():
    from generative_models_tpu_torch.ops.build import build_library
    lib = build_library("mlp_bwd", ["mlp_bwd.cu"])
    p, i = ctypes.c_void_p, ctypes.c_int
    pp = ctypes.POINTER(p)
    lib.gm_mlp_bwd.argtypes = [p, i, i, ctypes.POINTER(i), pp, pp, p, p, pp,
                               pp, pp, p, ctypes.POINTER(i), ctypes.c_float,
                               i, i, p]
    lib.gm_mlp_bwd.restype = i
    return lib


def build_bwd() -> None:
    """Compile (or load) the backward kernel's library now."""
    _bwd_lib()


def mlp_bwd(x, hiddens, out, dy, ws, acts: Sequence[str], slope: float = 0.2,
            compute_dtype=None):
    """Whole-MLP backward: ``(dws, dbs, dx)`` from the forward's input
    `x`, its `hiddens` and `out`, the output cotangent `dy` and the
    weights. CPU tensors run :func:`mlp_bwd_plain`; CUDA tensors launch
    the kernel on the current stream or raise."""
    global bwd_launches
    n = len(ws)
    _check(x, ws, None, acts, compute_dtype)
    batch = x.shape[0]
    dims = [x.shape[1]] + [w.shape[1] for w in ws]
    if len(hiddens) != n - 1:
        raise ValueError(f"mlp_bwd: {n} layers need {n - 1} hiddens, got "
                         f"{len(hiddens)}")
    for name, t, width in ([(f"h{i + 1}", h, dims[i + 1])
                            for i, h in enumerate(hiddens)]
                           + [("out", out, dims[-1]), ("dy", dy, dims[-1])]):
        if tuple(t.shape) != (batch, width):
            raise ValueError(f"mlp_bwd: {name} must be [{batch}, {width}], "
                             f"got {tuple(t.shape)}")
        if t.dtype != torch.float32 or t.device != x.device:
            raise TypeError(f"mlp_bwd: {name} must be float32 on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"mlp_bwd: {name} must be contiguous")
    if x.device.type == "cpu":
        return mlp_bwd_plain(x, hiddens, out, dy, ws, acts, slope,
                             compute_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"mlp_bwd runs on cuda or cpu tensors, not {x.device}")

    def empty(*shape):
        return torch.empty(shape, device=x.device, dtype=torch.float32)

    dws = [empty(*w.shape) for w in ws]
    dbs = [empty(w.shape[1]) for w in ws]
    dx = empty(batch, dims[0])
    if batch == 0:
        return [d.zero_() for d in dws], [d.zero_() for d in dbs], dx
    gs = [empty(batch, d) for d in dims[1:]]
    sm_count = torch.cuda.get_device_properties(x.device).multi_processor_count
    tile_rows = bwd_tile_rows_for(batch, dims, sm_count)

    def ptrs(ts):
        return (ctypes.c_void_p * max(len(ts), 1))(*[t.data_ptr() for t in ts])

    lib = _bwd_lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.gm_mlp_bwd(
            x.data_ptr(), batch, n, (ctypes.c_int * (n + 1))(*dims), ptrs(ws),
            ptrs(hiddens), out.data_ptr(), dy.data_ptr(), ptrs(gs), ptrs(dws),
            ptrs(dbs), dx.data_ptr(), (ctypes.c_int * n)(
                *[ACT_CODES[a] for a in acts]), float(slope),
            int(compute_dtype == torch.bfloat16), tile_rows, stream)
    if rc != 0:
        raise RuntimeError(f"mlp_bwd kernel launch failed: CUDA error {rc}")
    bwd_launches += 1
    return dws, dbs, dx


def bwd_smem_bytes(dims: Sequence[int], tile_rows: int) -> int:
    """Shared memory of the backward's row pass: two alternating g
    tiles, sized by the widest g_{n-1}, g_{n-3}, ... and g_{n-2}, ...
    (rounded up to 4 floats). The same formula as gm_mlp_bwd."""
    r4 = [-(-d // 4) * 4 for d in dims[1:]][::-1]
    return tile_rows * (max(r4[0::2]) + max(r4[1::2], default=0)) * 4


def bwd_tile_rows_for(batch: int, dims: Sequence[int], sm_count: int) -> int:
    for t in ((32, 16) if batch >= 32 * sm_count else (16,)):
        if bwd_smem_bytes(dims, t) <= MAX_SMEM_BYTES:
            return t
    raise ValueError(
        f"mlp_bwd: layer widths {list(dims)} need "
        f"{bwd_smem_bytes(dims, 16)} bytes of shared memory for a 16-row "
        f"tile; a block has {MAX_SMEM_BYTES}")


class MLPFunction(torch.autograd.Function):
    """``mlp_fwd`` forward with ``mlp_bwd`` backward — the counterpart of
    ``mlp_pallas.defvjp(_vjp_fwd, _vjp_bwd)``. The forward saves x, the
    hiddens, the output and the weights as residuals.

    ``MLPFunction.apply(x, acts, slope, compute_dtype, w0, b0, w1, b1, ...)``
    returns the stack's output. Not twice differentiable: a backward
    taken with ``create_graph=True`` (a gradient penalty's) raises,
    instead of handing back a gradient with no graph; the penalty's critic
    pass takes the plain path (``ops/penalty.py``)."""

    @staticmethod
    def forward(ctx, x, acts, slope, compute_dtype, *wb):
        ws, bs = list(wb[0::2]), list(wb[1::2])
        out, hid = mlp_fwd(x, ws, bs, acts, slope, compute_dtype)
        ctx.save_for_backward(x, out, *hid, *ws)
        ctx.meta = (tuple(acts), slope, compute_dtype, len(ws))
        return out

    @staticmethod
    def backward(ctx, dy):
        if torch.is_grad_enabled():  # create_graph=True: a double backward
            raise RuntimeError(
                "MLPFunction is not twice differentiable (its backward is "
                "the mlp_bwd kernel): take a double backward, such as a "
                "gradient penalty's, through models/mlp.py::mlp_apply_plain "
                "(ops/penalty.py)")
        acts, slope, compute_dtype, n = ctx.meta
        x, out, *rest = ctx.saved_tensors
        hid, ws = rest[:n - 1], rest[n - 1:]
        dws, dbs, dx = mlp_bwd(x, hid, out, dy.contiguous(), ws, acts, slope,
                               compute_dtype)
        grads = []
        for dw, db in zip(dws, dbs):
            grads += [dw, db]
        return (dx, None, None, None, *grads)
