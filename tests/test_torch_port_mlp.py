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
