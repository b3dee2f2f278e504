"""Whole-MLP forward and backward kernels — the port of
``generative_models_tpu/ops/pallas_mlp.py`` (``_make_kernel``/``_fwd_call``,
``_make_bwd_kernel``/``_bwd_call`` and the ``mlp_pallas`` custom VJP).

- :func:`mlp_fwd` runs a stack of ``act(h @ W + b)`` layers and returns
  ``(out, hiddens)``, every tensor float32 (``csrc/mlp_fwd.cu``): on the
  row chain, or, for one layer of float32 products at
  ``GEMM_MIN_ROWS`` rows or more, on the tiled GEMM route.
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

Each launch follows a plan, a pure function of the batch, the widths and
the SM count (:func:`fwd_plan`, :func:`bwd_plan`, :func:`gemm_plan`;
chosen at the call, cached, never at import): the chain kernels' item
rows, tile rows, cluster size, W chunk depth and whether the input
streams from device memory, and for the backward its dW slices and
scratch; the GEMM route's output tile. The C entries recompute the
shared bytes and refuse a plan they cannot run.

``launches`` and ``bwd_launches`` count the kernels' launches, so a run
can show that its main path went through them; ``gemm_launches`` counts
the forward launches that took the GEMM route (each also in
``launches``).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
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
gemm_launches = 0


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
    lib = build_library("mlp_fwd", ["mlp_fwd.cu"], ["mlp_chain.cuh"])
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.gm_mlp_fwd.argtypes = [p, i, i, ctypes.POINTER(i), ctypes.POINTER(p),
                               ctypes.POINTER(p), ctypes.POINTER(p),
                               ctypes.POINTER(i), ctypes.c_float, i,
                               ctypes.POINTER(i), p]
    lib.gm_mlp_fwd.restype = i
    lib.gm_mlp_gemm.argtypes = [p, i, i, i, p, p, p, i, ctypes.c_float,
                                ctypes.POINTER(i), p]
    lib.gm_mlp_gemm.restype = i
    return lib


def build() -> None:
    """Compile (or load) the kernel's library now instead of at first use."""
    _lib()


# ---------------------------------------------------------------------
# Launch plans (pure functions of the shapes and the SM count)
# ---------------------------------------------------------------------

CHAIN_WARPS = 8                # CH_WARPS in csrc/mlp_chain.cuh
CHAIN_STAGES = 4               # CH_STAGES: W chunks in the ring
ITEM_ROWS = (1, 4, 8)          # TR: the kernels' instantiations
CLUSTER_SIZES = (1, 2, 4, 8)   # portable cluster sizes
CHUNK_DEPTHS = (16, 32, 64)
# Tried only when no depth of CHUNK_DEPTHS fits: the backward's
# transposed W chunk (4 Gc x (KC + 4) floats a ring slot) of a layer
# thousands of columns wide, such as the conv stacks' 6272-wide inputs,
# fits four slots only 8 deep. Every stack that plans at CHUNK_DEPTHS
# keeps that plan.
WIDE_CHUNK_DEPTHS = (8,)
TILE_ROWS = (4, 8, 16, 24, 32, 48, 64, 80, 96, 128)
DW_TILE = (64, 128)            # DW_TK x DW_TN in csrc/mlp_bwd.cu
DW_CHUNK_ROWS = 32             # DW_RC
SLICE_MIN_ROWS = 512           # fewest rows a slice of pass 2 takes


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def tile_stride(width: int) -> int:
    """Row stride (floats) of an input tile in shared memory: rounded up
    to 4 floats, plus 4 when a multiple of 16 (tile_stride in
    mlp_chain.cuh)."""
    s = _cdiv(width, 4) * 4
    return s + 4 if s % 16 == 0 else s


def column_groups(width: int, cluster: int, rank: int) -> Tuple[int, int]:
    """The groups of 4 output columns [g0, g1) that cluster rank `rank`
    computes in a layer `width` wide (rank_groups in mlp_chain.cuh)."""
    g = _cdiv(width, 4)
    return rank * g // cluster, (rank + 1) * g // cluster


def warp_shape(row_groups: int, pairs: int) -> Tuple[int, int, int, int]:
    """(lr, lc, wr, wc): lanes lr x lc over (row groups x column pairs),
    warps wr x wc over a CTA's items (warp_shape in mlp_chain.cuh)."""
    lr = 4 if row_groups >= 4 else (2 if row_groups >= 2 else 1)
    lc = 32 // lr
    return lr, lc, _cdiv(row_groups, lr), _cdiv(pairs, lc)


def chain_smem_bytes(widths: Sequence[int], tr: int, row_groups: int,
                     cluster: int, kc: int, bwd: bool, stream: bool = False):
    """Shared bytes of a chain CTA (chain_plan in mlp_chain.cuh): two
    alternating input tiles and the W ring (backward: at least two tiles
    of the first input's stride, dy's and out's); `stream`: the ring alone,
    each slot a W chunk and an A chunk; None when some layer's items
    (row groups x column pairs) need more warps than a CTA has."""
    n = len(widths) - 1
    gc = 0
    for i in range(n):
        gmax = _cdiv(_cdiv(widths[i + 1], 4), cluster)
        _, _, wr, wc = warp_shape(row_groups, _cdiv(gmax, 2))
        if wr * wc > CHAIN_WARPS:
            return None
        gc = max(gc, gmax)
    gc = _cdiv(gc, 2) * 2
    sa = max(tile_stride(widths[i]) for i in range(0, n, 2))
    sb = max((tile_stride(widths[i]) for i in range(1, n, 2)), default=0)
    stage = 4 * gc * (kc + 4) if bwd else kc * 4 * gc
    tm = tr * row_groups
    if stream:  # a ring slot holds the W chunk and the A chunk
        return 4 * CHAIN_STAGES * (stage + tm * (kc + 4))
    rest = tm * sb + CHAIN_STAGES * stage
    if bwd:  # out's tile is staged over buffer B and the ring
        rest = max(rest, tm * sa)
    return 4 * (tm * sa + rest)


@dataclasses.dataclass(frozen=True)
class FwdPlan:
    """A chain launch: items of `tr` rows, `row_groups` of them a tile
    (tile_rows = tr x row_groups), a cluster of `cluster` CTAs a tile, W
    in chunks `kc` deep, `smem_bytes` a CTA, `grid` CTAs; `stream`: each
    layer's input streams from device memory beside W instead of staying
    in shared memory (a cluster barrier between layers)."""
    tr: int
    row_groups: int
    cluster: int
    kc: int
    smem_bytes: int
    grid: int
    stream: bool = False

    @property
    def tile_rows(self) -> int:
        return self.tr * self.row_groups

    def c_args(self) -> List[int]:
        return [self.tr, self.row_groups, self.cluster, self.kc,
                self.smem_bytes, int(self.stream)]


def chain_candidates(batch: int, widths: Sequence[int], bwd: bool,
                     depths: Sequence[int] = CHUNK_DEPTHS):
    """Every chain plan that fits: each item height, tile (no larger than
    the smallest listed tile that holds the batch), cluster size and
    chunk depth of `depths` whose CTA fits in shared memory."""
    for tr in ITEM_ROWS:
        for prev, tm in zip((0,) + TILE_ROWS, TILE_ROWS):
            if prev >= batch:  # a smaller tile already holds the batch
                break
            if tm % tr:
                continue
            rg = tm // tr
            for c in CLUSTER_SIZES:
                for kc in depths:
                    for stream in (False, True):
                        smem = chain_smem_bytes(widths, tr, rg, c, kc, bwd,
                                                stream)
                        if smem is not None and smem <= MAX_SMEM_BYTES:
                            yield FwdPlan(tr, rg, c, kc, smem,
                                          _cdiv(batch, tm) * c, stream)


def preferred_plans(batch: int, sm_count: int):
    """(tr, tile_rows, cluster, kc, stream) in the order the chip sweeps
    of every candidate favoured them (PERF.md; ``tools/mlp_ab.py
    --sweep``): up to 256 rows, one row an item, 8 or 16 rows a tile,
    clusters of 8, W in 64-deep chunks (fewer steps of the ring) and the
    hidden tile on chip (latency: about one wave of CTAs); up to 2048, 4-row items, about one CTA an SM in clusters of 2,
    the input streamed; beyond, 8-row items in 64-row tiles (32 where a
    layer is too wide for the CTA's warps), clusters of 2, streamed."""
    if batch <= 256:
        return [(1, 8 * _cdiv(batch, 128), 8, 64, False)]
    if batch <= 2048:
        return [(4, _cdiv(_cdiv(2 * batch, sm_count), 4) * 4, 2, 32, True)]
    return [(8, 64, 2, 32, True), (8, 32, 2, 32, True)]


@functools.lru_cache(maxsize=256)
def _chain_plan(batch: int, widths: Tuple[int, ...], sm_count: int,
                bwd: bool) -> FwdPlan:
    for tr, tm, c, kc, stream in preferred_plans(batch, sm_count):
        smem = chain_smem_bytes(widths, tr, tm // tr, c, kc, bwd, stream)
        if smem is not None and smem <= MAX_SMEM_BYTES:
            return FwdPlan(tr, tm // tr, c, kc, smem, _cdiv(batch, tm) * c,
                           stream)
    # a stack too wide for the preferred shape: the fitting plan of the
    # preferred item height nearest one CTA an SM, at the listed chunk
    # depths, else at the wide ones
    tr0 = preferred_plans(batch, sm_count)[0][0]
    for depths in (CHUNK_DEPTHS, WIDE_CHUNK_DEPTHS):
        best = min(chain_candidates(batch, widths, bwd, depths), default=None,
                   key=lambda p: (p.tr != tr0,
                                  abs(math.log(p.grid / sm_count)),
                                  p.cluster, p.smem_bytes))
        if best is not None:
            return best
    raise ValueError(
        f"mlp_{'bwd' if bwd else 'fwd'}: layer widths {list(widths)} "
        f"fit no plan: the smallest tile needs "
        f"{chain_smem_bytes(widths, 1, 1, CLUSTER_SIZES[-1], WIDE_CHUNK_DEPTHS[0], bwd, True)}"
        f" bytes of shared memory; a block has {MAX_SMEM_BYTES}")


def fwd_plan(batch: int, dims: Sequence[int], sm_count: int) -> FwdPlan:
    """The forward's launch plan for a batch of `batch` rows through a
    stack `dims` wide on a card of `sm_count` SMs: the first of
    :func:`preferred_plans` that fits, else the nearest fitting
    candidate. Raises ValueError when none fits."""
    return _chain_plan(int(batch), tuple(int(d) for d in dims),
                       int(sm_count), False)


# ---------------------------------------------------------------------
# The GEMM route: one layer at thousands of rows (gm_mlp_gemm)
# ---------------------------------------------------------------------

# Fewest rows a one-layer call of float32 products needs to take the
# GEMM route. In three runs of tools/mlp_ab.py --sweep on the H100
# (PERF.md) the GEMM beat the chain's plans at every one-layer shape from
# 768 rows on (by 4-65%) but 128 -> 128, which tied (0.98-1.02x) up to
# 2048 rows and won from 3072; under 768 the chain won the 128-deep
# layers, under 384 all of them.
GEMM_MIN_ROWS = 768
# (BM, BN) output tiles the kernel is instantiated at (gemm_kernel in
# csrc/mlp_fwd.cu); a thread computes 8 x 8 of a tile
GEMM_TILES = ((64, 128), (128, 112), (128, 128))
GEMM_DEPTH = 16    # GM_BK: depth of a ring slot
GEMM_STAGES = 4    # GM_STAGES: ring slots
GEMM_REGS = 168    # registers a thread at most (gemm_min_blocks)


@dataclasses.dataclass(frozen=True)
class GemmPlan:
    """A GEMM launch: output tiles of `bm` x `bn`, `row_tiles` x
    `col_tiles` of them, one CTA of bm x bn / 64 threads each, tile t
    at row tile t // col_tiles and column tile t % col_tiles."""
    bm: int
    bn: int
    row_tiles: int
    col_tiles: int
    smem_bytes: int

    @property
    def grid(self) -> int:
        return self.row_tiles * self.col_tiles

    @property
    def threads(self) -> int:
        return self.bm * self.bn // 64

    def c_args(self) -> List[int]:
        return [self.bm, self.bn, self.smem_bytes]


def gemm_smem_bytes(bm: int, bn: int) -> int:
    """Shared bytes of a GEMM CTA: the ring of x's and W's slots (x's
    four k-quad planes padded by 8 floats each)."""
    return 4 * GEMM_STAGES * (GEMM_DEPTH * (bm + bn) + 2 * GEMM_DEPTH)


def takes_gemm(n_layers: int, batch: int, compute_dtype) -> bool:
    """Whether a forward call takes the GEMM route: one layer, at least
    GEMM_MIN_ROWS rows, float32 products (bf16 operands stay on the
    chain)."""
    return (n_layers == 1 and batch >= GEMM_MIN_ROWS
            and compute_dtype != torch.bfloat16)


def gemm_resident(bm: int, bn: int) -> int:
    """CTAs of a bm x bn tile an SM holds at once, by registers (64K an
    SM, GEMM_REGS a thread): 3 of 64 x 128, 1 of the 128-row tiles."""
    return max(1, 65536 // (GEMM_REGS * bm * bn // 64))


def _sm_rate(warps: int) -> float:
    """An SM's FMA rate with `warps` resident, relative to 12 (three 64 x
    128 CTAs): fitted to tools/mlp_ab.py --sweep on the H100, where one
    4-warp CTA ran at 0.76 of it and one 7- or 8-warp CTA at 0.83."""
    return min(1.0, 0.64 + 0.03 * warps)


@functools.lru_cache(maxsize=256)
def _gemm_plan(batch: int, width: int, sm_count: int) -> GemmPlan:
    def cost(tile):
        # the fullest SM's time: its tiles in rounds of the resident
        # CTAs (padded columns counted as work), each round's work at
        # the rate of its warps; ties: the first listed
        bm, bn = tile
        per_sm = _cdiv(_cdiv(batch, bm) * _cdiv(width, bn), sm_count)
        resident, warps = gemm_resident(bm, bn), bm * bn // 64 // 32
        full, rest = divmod(per_sm, resident)
        t = full * resident * bm * bn / _sm_rate(resident * warps)
        if rest:
            t += rest * bm * bn / _sm_rate(rest * warps)
        return t
    bm, bn = min(GEMM_TILES, key=cost)
    return GemmPlan(bm, bn, _cdiv(batch, bm), _cdiv(width, bn),
                    gemm_smem_bytes(bm, bn))


def gemm_plan(batch: int, width: int, sm_count: int) -> GemmPlan:
    """The GEMM route's plan for `batch` rows of a layer `width` wide on
    a card of `sm_count` SMs: the tile of GEMM_TILES that leaves the
    fullest SM the least time by its rounds of resident CTAs."""
    return _gemm_plan(int(batch), int(width), int(sm_count))


@dataclasses.dataclass(frozen=True)
class BwdPlan:
    """The backward's launches: pass 1's chain (`rows`, over the widths
    in reverse), pass 2's `slices` slices of `slice_rows` rows
    (`slice_ranges`, in order) and `dw_grid` blocks (tiles, slices), and
    the `scratch_floats` of partials that pass 3 sums (0 with one
    slice)."""
    rows: FwdPlan
    slices: int
    slice_rows: int
    slice_ranges: Tuple[Tuple[int, int], ...]
    scratch_floats: int
    dw_grid: Tuple[int, int]

    def c_args(self) -> List[int]:
        return self.rows.c_args() + [self.slices, self.slice_rows,
                                     self.scratch_floats]


def dw_tiles(dims: Sequence[int]) -> int:
    """Pass 2's tiles: every dW_l cut in DW_TILE tiles."""
    tk, tn = DW_TILE
    return sum(_cdiv(k, tk) * _cdiv(n, tn) for k, n in zip(dims[:-1], dims[1:]))


def scratch_floats(dims: Sequence[int], slices: int) -> int:
    """Floats of the partials [S, K, N] and [S, N] of every layer, each
    rounded up to 4 (scratch_floats in csrc/mlp_bwd.cu); 0 with one
    slice."""
    if slices == 1:
        return 0
    return sum(_cdiv(slices * (k * n + n), 4) * 4
               for k, n in zip(dims[:-1], dims[1:]))


def bwd_plan(batch: int, dims: Sequence[int], sm_count: int, *,
             slices=None) -> BwdPlan:
    """The backward's launch plan: pass 1 as :func:`fwd_plan` plans the
    chain over the reversed widths (its W chunks transposed); pass 2
    splits the batch into slices so that tiles x slices make about eight
    blocks an SM (the sweeps' best at G B 8192: 16 slices), each slice at
    least SLICE_MIN_ROWS rows (one slice at small
    batches: two launches), slices of equal rows (whole DW_CHUNK_ROWS chunks) but the ragged last.
    `slices` asks for a slice count instead (a check or a timing tool;
    it may come out smaller, as whole DW_CHUNK_ROWS chunks allow). Raises
    ValueError when pass 1 fits no plan."""
    dims = tuple(int(d) for d in dims)
    batch = int(batch)
    rows = _chain_plan(batch, dims[::-1], int(sm_count), True)
    tiles = dw_tiles(dims)
    if slices is None:
        slices = max(1, min(_cdiv(8 * sm_count, tiles),
                            batch // SLICE_MIN_ROWS))
    slice_rows = _cdiv(_cdiv(batch, slices), DW_CHUNK_ROWS) * DW_CHUNK_ROWS
    slices = _cdiv(batch, slice_rows)
    ranges = tuple((s * slice_rows, min(batch, (s + 1) * slice_rows))
                   for s in range(slices))
    return BwdPlan(rows, slices, slice_rows, ranges,
                   scratch_floats(dims, slices), (tiles, slices))


def mlp_fwd(x, ws: Sequence[torch.Tensor], bs: Sequence[torch.Tensor],
            acts: Sequence[str], slope: float = 0.2,
            compute_dtype=None) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """Whole-MLP forward: returns ``(out, [h_1, ..., h_{n-1}])``.

    CPU tensors run :func:`mlp_fwd_plain`; CUDA tensors launch the
    kernel on the current stream (no synchronisation) or raise: the
    GEMM route where :func:`takes_gemm` says so, else the chain. A
    non-CPU input that requires grad under grad mode raises: the
    kernel's outputs would carry no graph (use :class:`MLPFunction`)."""
    _check(x, ws, bs, acts, compute_dtype)
    if x.device.type == "cpu":
        return mlp_fwd_plain(x, ws, bs, acts, slope, compute_dtype)
    _refuse_untracked_grad("mlp_fwd", [x, *ws, *bs])
    if x.device.type != "cuda":
        raise ValueError(f"mlp_fwd runs on cuda or cpu tensors, not {x.device}")
    dims = [x.shape[1]] + [w.shape[1] for w in ws]
    batch = x.shape[0]
    if batch == 0:
        outs = [torch.empty((0, d), device=x.device, dtype=torch.float32)
                for d in dims[1:]]
        return outs[-1], outs[:-1]
    if takes_gemm(len(ws), batch, compute_dtype):
        plan = gemm_plan(batch, dims[1], _sm_count(x.device))
        return launch_gemm(x, ws[0], bs[0], acts[0], slope, plan), []
    return launch_fwd(x, ws, bs, acts, slope, compute_dtype,
                      fwd_plan(batch, dims, _sm_count(x.device)))


def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def launch_fwd(x, ws, bs, acts, slope, compute_dtype, plan: FwdPlan):
    """Launches the forward kernel with `plan` on CUDA tensors already
    checked by :func:`mlp_fwd` (a timing tool passes plans of its own);
    raises if the launch fails."""
    global launches
    n = len(ws)
    dims = [x.shape[1]] + [w.shape[1] for w in ws]
    batch = x.shape[0]
    outs = [torch.empty((batch, d), device=x.device, dtype=torch.float32)
            for d in dims[1:]]
    lib = _lib()
    c_dims = (ctypes.c_int * (n + 1))(*dims)
    c_ws = (ctypes.c_void_p * n)(*[w.data_ptr() for w in ws])
    c_bs = (ctypes.c_void_p * n)(*[b.data_ptr() for b in bs])
    c_outs = (ctypes.c_void_p * n)(*[o.data_ptr() for o in outs])
    c_acts = (ctypes.c_int * n)(*[ACT_CODES[a] for a in acts])
    c_plan = (ctypes.c_int * 6)(*plan.c_args())
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.gm_mlp_fwd(x.data_ptr(), batch, n, c_dims, c_ws, c_bs, c_outs,
                            c_acts, float(slope),
                            int(compute_dtype == torch.bfloat16), c_plan,
                            stream)
    if rc != 0:
        raise RuntimeError(f"mlp_fwd kernel launch failed: CUDA error {rc} "
                           f"(plan {plan})")
    launches += 1
    return outs[-1], outs[:-1]


def launch_gemm(x, w, b, act, slope, plan: GemmPlan):
    """Launches the GEMM route with `plan` on CUDA tensors already
    checked by :func:`mlp_fwd` (a timing tool passes plans of its own):
    returns ``act(x @ w + b)``; raises if the launch fails."""
    global launches, gemm_launches
    batch, k = x.shape
    n = w.shape[1]
    out = torch.empty((batch, n), device=x.device, dtype=torch.float32)
    lib = _lib()
    c_plan = (ctypes.c_int * 3)(*plan.c_args())
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.gm_mlp_gemm(x.data_ptr(), batch, k, n, w.data_ptr(),
                             b.data_ptr(), out.data_ptr(), ACT_CODES[act],
                             float(slope), c_plan, stream)
    if rc != 0:
        raise RuntimeError(f"mlp_fwd GEMM launch failed: CUDA error {rc} "
                           f"(plan {plan})")
    launches += 1
    gemm_launches += 1
    return out


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
    lib = build_library("mlp_bwd", ["mlp_bwd.cu"], ["mlp_chain.cuh"])
    p, i = ctypes.c_void_p, ctypes.c_int
    pp = ctypes.POINTER(p)
    lib.gm_mlp_bwd.argtypes = [p, i, i, ctypes.POINTER(i), pp, pp, p, p, pp,
                               pp, pp, p, ctypes.POINTER(i), ctypes.c_float,
                               i, ctypes.POINTER(i), p, p]
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

    if batch == 0:
        def zeros(*shape):
            return torch.zeros(shape, device=x.device, dtype=torch.float32)
        return ([zeros(*w.shape) for w in ws], [zeros(w.shape[1]) for w in ws],
                zeros(0, dims[0]))
    return launch_bwd(x, hiddens, out, dy, ws, acts, slope, compute_dtype,
                      bwd_plan(batch, dims, _sm_count(x.device)))


def launch_bwd(x, hiddens, out, dy, ws, acts, slope, compute_dtype,
               plan: BwdPlan):
    """Launches the backward's passes with `plan` on CUDA tensors already
    checked by :func:`mlp_bwd`; raises if a launch fails."""
    global bwd_launches
    n = len(ws)
    batch = x.shape[0]
    dims = [x.shape[1]] + [w.shape[1] for w in ws]

    def empty(*shape):
        return torch.empty(shape, device=x.device, dtype=torch.float32)

    dws = [empty(*w.shape) for w in ws]
    dbs = [empty(w.shape[1]) for w in ws]
    dx = empty(batch, dims[0])
    gs = [empty(batch, d) for d in dims[1:]]
    scratch = empty(plan.scratch_floats) if plan.scratch_floats else None

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
            int(compute_dtype == torch.bfloat16),
            (ctypes.c_int * 9)(*plan.c_args()),
            None if scratch is None else scratch.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"mlp_bwd kernel launch failed: CUDA error {rc} "
                           f"(plan {plan})")
    bwd_launches += 1
    return dws, dbs, dx


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
