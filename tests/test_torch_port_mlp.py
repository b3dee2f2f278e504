"""The PyTorch port's MLP forward against the JAX package.

The same numpy inputs (seeded) go through the JAX side — the Pallas
whole-MLP kernel in interpret mode (``_run_fwd``) and the per-layer XLA
path — and through the port on the CPU, where ``mlp_fwd`` runs its
plain version. Tolerances:
- float32: rtol=1e-5, atol=1e-6 (only the summation order differs);
- bf16 operands: atol=2e-2 (bf16 rounds at other places in the two
  frameworks).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generative_models_tpu.models.mlp import mlp_apply_xla
from generative_models_tpu.ops.linear import linear_xla
from generative_models_tpu.ops.pallas_mlp import _run_fwd
from generative_models_tpu_torch.ops import ACTIVATIONS, cuda_mlp
from generative_models_tpu_torch.ops.cuda_linear import linear_cuda
from generative_models_tpu_torch.ops.linear import fused_linear, linear_plain
from generative_models_tpu_torch.models.mlp import mlp_apply

TOL = {"float32": dict(rtol=1e-5, atol=1e-6),
       "bfloat16": dict(rtol=0.0, atol=2e-2)}

# (name, dims, hidden_act, out_act, batch): G and D at full and tiny
# width, every kernel activation, ragged batches, one and three layers.
CASES = [
    ("g_full", [128, 400, 784], "relu", "sigmoid", 37),
    ("d_full", [784, 400, 1], "leaky_relu", "none", 16),
    ("g_tiny", [8, 32, 784], "relu", "sigmoid", 5),
    ("d_tiny", [784, 32, 1], "leaky_relu", "none", 1),
    ("tanh3", [48, 24, 16, 8], "tanh", "tanh", 9),
    ("sigmoid_none", [20, 12, 6], "sigmoid", "none", 3),
    ("one_layer", [128, 256], "relu", "relu", 8),
]
IDS = [c[0] for c in CASES]


def _inputs(dims, b, seed=0):
    rng = np.random.default_rng(seed)
    layers = []
    for k, n in zip(dims[:-1], dims[1:]):
        bound = 1.0 / np.sqrt(k)
        layers.append({
            "w": rng.uniform(-bound, bound, (k, n)).astype(np.float32),
            "b": rng.uniform(-bound, bound, (n,)).astype(np.float32)})
    x = rng.standard_normal((b, dims[0])).astype(np.float32)
    return layers, x


def _jax(layers):
    return [{k: jnp.asarray(v) for k, v in l.items()} for l in layers]


def _torch(layers):
    return [{k: torch.from_numpy(v) for k, v in l.items()} for l in layers]


def _dtypes(name):
    return (jnp.bfloat16, torch.bfloat16) if name == "bfloat16" else (None, None)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_mlp_fwd_plain_matches_pallas_fwd(case, dtype):
    """(out, hiddens) of the port against the TPU kernel (interpret)."""
    _, dims, hidden_act, out_act, b = case
    layers, x = _inputs(dims, b)
    jdt, tdt = _dtypes(dtype)
    j_out, j_hid = _run_fwd(_jax(layers), jnp.asarray(x), hidden_act,
                            out_act, 0.2, jdt, True)
    tl = _torch(layers)
    acts = cuda_mlp.acts_tuple(len(tl), hidden_act, out_act)
    t_out, t_hid = cuda_mlp.mlp_fwd(torch.from_numpy(x),
                                    [l["w"] for l in tl],
                                    [l["b"] for l in tl], acts, 0.2, tdt)
    assert len(t_hid) == len(j_hid) == len(dims) - 2
    for got, want in zip([t_out] + t_hid, [j_out] + list(j_hid)):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_mlp_apply_matches_xla(case, dtype):
    _, dims, hidden_act, out_act, b = case
    layers, x = _inputs(dims, b, seed=1)
    jdt, tdt = _dtypes(dtype)
    want = mlp_apply_xla(_jax(layers), jnp.asarray(x), hidden_act, out_act,
                         0.2, jdt)
    got = mlp_apply(_torch(layers), torch.from_numpy(x), hidden_act, out_act,
                    0.2, tdt)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, dtype=np.float32),
                               **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", sorted(ACTIVATIONS))
def test_fused_linear_matches_linear_xla(act, dtype):
    (layer,), x = _inputs([40, 24], 7, seed=2)
    x = 3.0 * x  # reach both tails of the activations
    jdt, tdt = _dtypes(dtype)
    want = linear_xla(jnp.asarray(x), jnp.asarray(layer["w"]),
                      jnp.asarray(layer["b"]), act, 0.2, jdt)
    got = fused_linear(torch.from_numpy(x), torch.from_numpy(layer["w"]),
                       torch.from_numpy(layer["b"]), act, 0.2, tdt)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, dtype=np.float32),
                               **TOL[dtype])


@pytest.mark.parametrize("act", cuda_mlp.SUPPORTED_ACTS)
def test_linear_cuda_on_cpu_is_linear_plain(act):
    (layer,), x = _inputs([33, 17], 5, seed=3)
    args = (torch.from_numpy(x), torch.from_numpy(layer["w"]),
            torch.from_numpy(layer["b"]))
    np.testing.assert_allclose(linear_cuda(*args, act=act).numpy(),
                               linear_plain(*args, act=act).numpy(),
                               rtol=1e-6, atol=1e-7)


def _good():
    layers, x = _inputs([12, 8, 4], 3)
    tl = _torch(layers)
    return (torch.from_numpy(x), [l["w"] for l in tl], [l["b"] for l in tl],
            ("relu", "sigmoid"))


@pytest.mark.parametrize("bad,exc", [
    (lambda x, ws, bs, a: (x.double(), ws, bs, a), TypeError),
    (lambda x, ws, bs, a: (x[:, :5], ws, bs, a), ValueError),
    (lambda x, ws, bs, a: (x, ws, bs, ("relu", "softplus")), ValueError),
    (lambda x, ws, bs, a: (x, ws, bs[:1], a), ValueError),
    (lambda x, ws, bs, a: (x.t().contiguous().t(), ws, bs, a), ValueError),
    (lambda x, ws, bs, a: (x, [ws[0], ws[1].t()], bs, a), ValueError),
], ids=["dtype", "width", "act", "nbias", "noncontig", "wshape"])
def test_mlp_fwd_rejects_bad_inputs(bad, exc):
    with pytest.raises(exc):
        cuda_mlp.mlp_fwd(*bad(*_good()))


def test_mlp_fwd_rejects_too_many_layers():
    layers, x = _inputs([4] * (cuda_mlp.MAX_LAYERS + 2), 2)
    tl = _torch(layers)
    with pytest.raises(ValueError, match="layers"):
        cuda_mlp.mlp_fwd(torch.from_numpy(x), [l["w"] for l in tl],
                         [l["b"] for l in tl],
                         ("tanh",) * (cuda_mlp.MAX_LAYERS + 1))


# The MLP stacks the 14 served variants build (nets.py): G and D,
# cgan's and infogan's wider inputs, infogan's 15-lane head, began's
# autoencoder critic, the VAE family's encoder trunk, heads and decoder.
SERVED_STACKS = {
    "g": [128, 400, 784], "d": [784, 400, 1], "cgan_g": [138, 400, 784],
    "cgan_d": [794, 400, 1], "infogan_g": [140, 400, 784],
    "infogan_d": [784, 400, 15], "began_d": [784, 400, 784],
    "vae_trunk": [784, 400], "vae_head": [400, 20],
    "vae_dec": [20, 400, 784],
    # the quality scorer's classifier and its feature layer
    "clf": [784, 128, 10], "clf_feat": [784, 128],
}
PLAN_BATCHES = (1, 37, 64, 100, 1024, 8192)
PLAN_CASES = [(name, b) for name in SERVED_STACKS for b in PLAN_BATCHES] + [
    ("clf", 256), ("clf_feat", 256)]   # the classifier's training batch
# the scorer's forward at the 10,000 test images
FWD_PLAN_CASES = PLAN_CASES + [("clf", 10000), ("clf_feat", 10000)]


def chain_items(widths, plan, bwd):
    """Every (layer, rank, row group, column) a chain plan's threads
    compute, by the kernel's own index arithmetic (mlp_chain.cuh), as a
    list: a column covered twice shows up twice."""
    got = []
    for i, o in enumerate(widths[1:]):
        for rank in range(plan.cluster):
            g0, g1 = cuda_mlp.column_groups(o, plan.cluster, rank)
            ng = g1 - g0
            h = (ng + 1) // 2
            lr, lc, wr_n, wc_n = cuda_mlp.warp_shape(plan.row_groups, h)
            for tid in range(8 * 32):
                warp, lane = divmod(tid, 32)
                wr = warp // max(wc_n, 1)
                rg = wr * lr + lane // lc
                cp = (warp - wr * wc_n) * lc + lane % lc
                if not (warp < wr_n * wc_n and rg < plan.row_groups
                        and cp < h):
                    continue
                if bwd:
                    cols = [4 * g0 + cp + h * c for c in range(8)
                            if cp + h * c < 4 * ng]
                else:
                    cols = [4 * (g0 + grp) + c for grp in (cp, cp + h)
                            if grp < ng for c in range(4)]
                got += [(i, rg, col) for col in cols]
    return got


def check_chain_plan(widths, batch, plan, bwd):
    assert plan.tr in cuda_mlp.ITEM_ROWS
    assert plan.cluster in cuda_mlp.CLUSTER_SIZES
    assert plan.cluster <= 8  # the portable cluster size
    assert plan.kc in cuda_mlp.CHUNK_DEPTHS + cuda_mlp.WIDE_CHUNK_DEPTHS
    assert plan.smem_bytes == cuda_mlp.chain_smem_bytes(
        widths, plan.tr, plan.row_groups, plan.cluster, plan.kc, bwd,
        plan.stream)
    assert plan.smem_bytes <= cuda_mlp.MAX_SMEM_BYTES
    tiles = -(-batch // plan.tile_rows)
    assert plan.grid == tiles * plan.cluster
    # the row tiles cover [0, B): the last tile holds the last row, and
    # no tile starts past it
    assert (tiles - 1) * plan.tile_rows < batch <= tiles * plan.tile_rows
    # every column of every layer (padded to groups of 4), and every row
    # group, exactly once
    got = chain_items(widths, plan, bwd)
    want = [(i, rg, col) for i, o in enumerate(widths[1:])
            for rg in range(plan.row_groups)
            for col in range(-(-o // 4) * 4)]
    assert sorted(got) == sorted(want)


@pytest.mark.parametrize("name,batch", FWD_PLAN_CASES,
                         ids=[f"{n}-B{b}" for n, b in FWD_PLAN_CASES])
def test_fwd_plan_fits_and_covers(name, batch):
    """fwd_plan for every served stack and batch: shared bytes within the
    limit, a cluster size the card takes, tiles covering every row and
    column exactly once."""
    dims = SERVED_STACKS[name]
    plan = cuda_mlp.fwd_plan(batch, dims, 132)
    check_chain_plan(dims, batch, plan, bwd=False)
    assert plan == cuda_mlp.fwd_plan(batch, tuple(dims), 132)  # pure


def test_fwd_plan_raises_when_nothing_fits():
    with pytest.raises(ValueError, match="shared memory"):
        cuda_mlp.fwd_plan(8192, [128, 30000, 784], 132)


# ---------------------------------------------------------------------
# The GEMM route: one layer of float32 products at GEMM_MIN_ROWS rows or
# more (csrc/mlp_fwd.cu gm_mlp_gemm)
# ---------------------------------------------------------------------

GEMM_ROWS = (10000, cuda_mlp.GEMM_MIN_ROWS + 1, 10001)


def gemm_thread_cells(bm, bn, tid):
    """(rows, columns) of a tile that thread `tid` computes, by the
    kernel's own index arithmetic (csrc/mlp_fwd.cu): rows tr*4 + i and
    bm/2 + tr*4 + i, columns tc*4 + j and bn/2 + tc*4 + j (i, j < 4)."""
    tc, tr = tid % (bn // 8), tid // (bn // 8)
    rows = [h * (bm // 2) + tr * 4 + i for h in (0, 1) for i in range(4)]
    cols = [h * (bn // 2) + tc * 4 + j for h in (0, 1) for j in range(4)]
    return rows, cols
GEMM_CASES = [(b, n) for b in GEMM_ROWS for n in (128, 400, 784)]


@pytest.mark.parametrize("batch,width", GEMM_CASES,
                         ids=[f"B{b}-N{n}" for b, n in GEMM_CASES])
def test_gemm_plan_covers_every_cell_once(batch, width):
    """The GEMM plan's tiles cover [0, batch) x [0, width) exactly once,
    and inside a tile the threads' 8 x 8 cells (the kernel's index
    arithmetic) cover the bm x bn tile exactly once; an instantiated
    tile within the shared-memory limit."""
    plan = cuda_mlp.gemm_plan(batch, width, 132)
    assert (plan.bm, plan.bn) in cuda_mlp.GEMM_TILES
    assert plan.smem_bytes == cuda_mlp.gemm_smem_bytes(plan.bm, plan.bn)
    assert plan.smem_bytes <= cuda_mlp.MAX_SMEM_BYTES
    assert plan.threads % 32 == 0 and plan.threads <= 1024
    assert plan.grid == plan.row_tiles * plan.col_tiles
    # tile t is (t // col_tiles, t % col_tiles): every pair once
    pairs = {divmod(t, plan.col_tiles) for t in range(plan.grid)}
    assert pairs == {(r, c) for r in range(plan.row_tiles)
                     for c in range(plan.col_tiles)}
    rows = [r * plan.bm + i for r in range(plan.row_tiles)
            for i in range(plan.bm) if r * plan.bm + i < batch]
    cols = [c * plan.bn + j for c in range(plan.col_tiles)
            for j in range(plan.bn) if c * plan.bn + j < width]
    assert rows == list(range(batch)) and cols == list(range(width))
    cells = []
    for tid in range(plan.threads):
        r, c = gemm_thread_cells(plan.bm, plan.bn, tid)
        cells += [(i, j) for i in r for j in c]
    assert sorted(cells) == [(i, j) for i in range(plan.bm)
                             for j in range(plan.bn)]
    assert plan == cuda_mlp.gemm_plan(batch, width, 132)  # pure


@pytest.mark.parametrize("width", [400, 784])
def test_gemm_plan_wastes_few_columns(width):
    """Columns padded to the last tile: at most 112 (a 128-wide tile over
    400 or 784 leaves 16 columns in its last; 28% of 400, 14% of 784),
    at any batch the route takes. The planner counts the padding as
    work: the 128-wide tile wins where it does because the sweep's 64 x
    128 CTAs, three an SM, outrun fitted widths (PERF.md)."""
    for b in range(cuda_mlp.GEMM_MIN_ROWS, 60000, 97):
        p = cuda_mlp.gemm_plan(b, width, 132)
        assert p.col_tiles * p.bn - width <= 112
        assert (p.col_tiles - 1) * p.bn < width


@pytest.mark.parametrize("batch,width,tile", [
    (10000, 128, (64, 128)), (10000, 400, (64, 128)),
    (10000, 784, (64, 128)), (8192, 400, (128, 112)),
    (8192, 784, (64, 128)), (4096, 784, (128, 112)),
    (2048, 400, (64, 128))])
def test_gemm_plan_picks_the_sweeps_tile(batch, width, tile):
    """At shapes tools/mlp_ab.py --sweep timed on the H100, the planner's
    tile is the fastest of GEMM_TILES there: three resident 64 x 128
    CTAs an SM at 10,000 rows (the generation cell's eight launches),
    one 128 x 112 where that fills the SMs in fewer rounds."""
    p = cuda_mlp.gemm_plan(batch, width, 132)
    assert (p.bm, p.bn) == tile
    assert cuda_mlp.gemm_resident(64, 128) == 3
    assert cuda_mlp.gemm_resident(128, 112) == 1


@pytest.mark.parametrize("n_layers,batch,cdt,want", [
    (1, cuda_mlp.GEMM_MIN_ROWS, None, True),
    (1, 10000, None, True),
    (1, 10000, torch.float32, True),
    (1, cuda_mlp.GEMM_MIN_ROWS - 1, None, False),
    (1, 10000, torch.bfloat16, False),
    (2, 10000, None, False),
    (3, 8192, None, False),
], ids=["one-at-threshold", "one-10000", "one-float32", "one-under",
        "one-bf16", "two-layers", "three-layers"])
def test_takes_gemm(n_layers, batch, cdt, want):
    """One layer, float32 products, at least GEMM_MIN_ROWS rows: the GEMM
    route; any stack, bf16 operands or fewer rows: the chain."""
    assert cuda_mlp.takes_gemm(n_layers, batch, cdt) is want


# (dims, batch) -> (tr, row_groups, cluster, kc, smem bytes, grid, stream):
# the chain's plans as they were before the GEMM route, for calls that
# stay on the chain (stacks, few rows, and the chain's own plan of a
# layer, which bf16 operands take at any batch)
CHAIN_PLANS = {
    ((128, 400, 784), 8192): (8, 4, 2, 32, 219136, 512, True),
    ((128, 400, 784), 100): (1, 8, 8, 64, 123648, 104, False),
    ((128, 400, 784), 64): (1, 8, 8, 64, 123648, 64, False),
    ((784, 400, 1), 100): (1, 8, 8, 64, 95488, 104, False),
    ((784, 400), 1024): (4, 4, 2, 32, 111616, 128, True),
    ((784, 400), 10000): (8, 8, 2, 32, 139264, 314, True),
    ((784, 784), 10000): (8, 4, 2, 32, 219136, 626, True),
    ((128, 128), 1600): (4, 7, 2, 32, 48896, 116, True),
    ((784, 128, 10), 10000): (8, 8, 2, 32, 69632, 314, True),
}
PREFERRED = {64: [(1, 8, 8, 64, False)], 256: [(1, 16, 8, 64, False)],
             1024: [(4, 16, 2, 32, True)], 2048: [(4, 32, 2, 32, True)],
             10000: [(8, 64, 2, 32, True), (8, 32, 2, 32, True)]}


@pytest.mark.parametrize("dims,batch", list(CHAIN_PLANS),
                         ids=[f"{'-'.join(map(str, d))}-B{b}"
                              for d, b in CHAIN_PLANS])
def test_chain_plans_are_unchanged(dims, batch):
    p = cuda_mlp.fwd_plan(batch, dims, 132)
    assert (p.tr, p.row_groups, p.cluster, p.kc, p.smem_bytes, p.grid,
            p.stream) == CHAIN_PLANS[(dims, batch)]
    for b, want in PREFERRED.items():
        assert cuda_mlp.preferred_plans(b, 132) == want


def _fake_launch(monkeypatch):
    """A library whose C entries queue nothing and return 0, and a
    device context that takes the meta device: the wrappers' own work
    (outputs, counters) runs on the CPU."""
    import contextlib
    import types
    calls = []

    class Lib:
        def gm_mlp_fwd(self, *args):
            calls.append("chain")
            return 0

        def gm_mlp_gemm(self, *args):
            calls.append(("gemm", args[1:4], tuple(args[9][:3])))
            return 0
    monkeypatch.setattr(cuda_mlp, "_lib", lambda: Lib())
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(cuda_mlp, "launches", 0)
    monkeypatch.setattr(cuda_mlp, "gemm_launches", 0)
    return calls


def test_a_gemm_launch_counts_in_both_counters(monkeypatch):
    """A launch on the GEMM route bumps ``launches`` and ``gemm_launches``
    by one each and hands the C entry the shape and the plan; a chain
    launch bumps ``launches`` only."""
    calls = _fake_launch(monkeypatch)
    b, k, n = 10000, 784, 400
    x, w, bias = (torch.ones(s, device="meta") for s in ((b, k), (k, n), n))
    plan = cuda_mlp.gemm_plan(b, n, 132)
    out = cuda_mlp.launch_gemm(x, w, bias, "relu", 0.2, plan)
    assert out.shape == (b, n) and out.device.type == "meta"
    assert (cuda_mlp.launches, cuda_mlp.gemm_launches) == (1, 1)
    assert calls == [("gemm", (b, k, n), (64, 128, plan.smem_bytes))]
    cuda_mlp.launch_fwd(x, [w], [bias], ("relu",), 0.2, None,
                        cuda_mlp.fwd_plan(b, [k, n], 132))
    assert (cuda_mlp.launches, cuda_mlp.gemm_launches) == (2, 1)
    assert calls[-1] == "chain"
