"""The port's MLP backward (kernel #3's plain version and the CPU autograd
path) against the JAX package's.

The same numpy weights, input and output cotangent go through JAX's
``mlp_pallas`` VJP (its backward kernel in interpret mode), its XLA twin
``_vjp_bwd_xla``, and on the port's side through ``mlp_bwd_plain``,
``torch.autograd.grad`` of ``mlp_apply`` (the per-layer CPU path) and of
``MLPFunction`` (the card's path, which on the CPU runs the plain
versions). Tolerances: float32 rtol 1e-5 / atol 1e-6 (summation order);
bf16 operands atol 2e-2 (bf16 rounds at other places in the two
frameworks). The atol is taken relative to each gradient's largest
magnitude (when that exceeds 1): dW sums B rows of g, and each g is
itself a sum of up to 784 products, so a few float32 ulps of the largest
terms land on small elements.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generative_models_tpu.ops.pallas_mlp import (
    _vjp_bwd_xla, _vjp_fwd, mlp_pallas,
)
from generative_models_tpu_torch.models.mlp import mlp_apply
from generative_models_tpu_torch.ops import cuda_mlp
from generative_models_tpu_torch.ops.cuda_linear import linear_cuda
from tests.test_torch_port_mlp import (
    PLAN_CASES, SERVED_STACKS, check_chain_plan,
)

TOL = {"float32": dict(rtol=1e-5, atol=1e-6),
       "bfloat16": dict(rtol=0.0, atol=2e-2)}

CASES = [
    ("g_tiny", [8, 32, 784], "relu", "sigmoid", 16),
    ("d_tiny", [784, 32, 1], "leaky_relu", "none", 16),
    ("g_full_ragged", [128, 400, 784], "relu", "sigmoid", 37),
    ("tanh3", [48, 24, 16, 8], "tanh", "tanh", 9),
]
IDS = [c[0] for c in CASES]


def _close(got, want, dtype):
    tol = dict(TOL[dtype])
    tol["atol"] *= max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, **tol)


def _inputs(dims, b, seed=0):
    rng = np.random.default_rng(seed)
    layers = []
    for k, n in zip(dims[:-1], dims[1:]):
        bound = 1.0 / np.sqrt(k)
        layers.append({
            "w": rng.uniform(-bound, bound, (k, n)).astype(np.float32),
            "b": rng.uniform(-bound, bound, (n,)).astype(np.float32)})
    x = rng.standard_normal((b, dims[0])).astype(np.float32)
    dy = rng.standard_normal((b, dims[-1])).astype(np.float32)
    return layers, x, dy


def _flat_grads(dlayers, dx):
    return [np.asarray(a) for l in dlayers for a in (l["w"], l["b"])] + [
        np.asarray(dx)]


def _jax_grads(layers, x, dy, h, o, cdt):
    jl = [{k: jnp.asarray(v) for k, v in l.items()} for l in layers]
    _, vjp = jax.vjp(lambda ls, xx: mlp_pallas(ls, xx, h, o, 0.2, cdt),
                     jl, jnp.asarray(x))
    dlayers, dx = vjp(jnp.asarray(dy))
    return _flat_grads(dlayers, dx)


def _torch_layers(layers, grad=False):
    return [{k: torch.from_numpy(v.copy()).requires_grad_(grad)
             for k, v in l.items()} for l in layers]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_mlp_bwd_plain_matches_pallas_vjp(case, dtype):
    _, dims, h, o, b = case
    layers, x, dy = _inputs(dims, b)
    want = _jax_grads(layers, x, dy, h, o, dtype)
    tl = _torch_layers(layers)
    ws, bs = [l["w"] for l in tl], [l["b"] for l in tl]
    acts = cuda_mlp.acts_tuple(len(tl), h, o)
    tdt = torch.bfloat16 if dtype == "bfloat16" else None
    xt = torch.from_numpy(x)
    out, hid = cuda_mlp.mlp_fwd(xt, ws, bs, acts, 0.2, tdt)
    dws, dbs, dx = cuda_mlp.mlp_bwd(xt, hid, out, torch.from_numpy(dy), ws,
                                    acts, 0.2, tdt)
    got = [t.numpy() for pair in zip(dws, dbs) for t in pair] + [dx.numpy()]
    for g, w in zip(got, want):
        _close(g, w, dtype)
    assert cuda_mlp.bwd_launches == 0


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_mlp_bwd_plain_matches_xla_twin(case):
    _, dims, h, o, b = case
    layers, x, dy = _inputs(dims, b, seed=1)
    jl = [{k: jnp.asarray(v) for k, v in l.items()} for l in layers]
    _, res = _vjp_fwd(jl, jnp.asarray(x), h, o, 0.2, "float32")
    want = _flat_grads(*_vjp_bwd_xla(h, o, 0.2, "float32", res,
                                     jnp.asarray(dy)))
    tl = _torch_layers(layers)
    ws, bs = [l["w"] for l in tl], [l["b"] for l in tl]
    acts = cuda_mlp.acts_tuple(len(tl), h, o)
    out, hid = cuda_mlp.mlp_fwd_plain(torch.from_numpy(x), ws, bs, acts)
    dws, dbs, dx = cuda_mlp.mlp_bwd_plain(torch.from_numpy(x), hid, out,
                                          torch.from_numpy(dy), ws, acts)
    got = [t.numpy() for pair in zip(dws, dbs) for t in pair] + [dx.numpy()]
    for g, w in zip(got, want):
        _close(g, w, "float32")


@pytest.mark.parametrize("path", ["mlp_apply", "MLPFunction"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_autograd_matches_pallas_vjp(case, dtype, path):
    """torch.autograd.grad through the port's forward equals JAX's VJP:
    the CPU's per-layer path, and MLPFunction (the card's path)."""
    _, dims, h, o, b = case
    layers, x, dy = _inputs(dims, b, seed=2)
    want = _jax_grads(layers, x, dy, h, o, dtype)
    tl = _torch_layers(layers, grad=True)
    xt = torch.from_numpy(x).requires_grad_(True)
    tdt = torch.bfloat16 if dtype == "bfloat16" else None
    if path == "mlp_apply":
        out = mlp_apply(tl, xt, h, o, 0.2, tdt)
    else:
        out = cuda_mlp.MLPFunction.apply(
            xt, cuda_mlp.acts_tuple(len(tl), h, o), 0.2, tdt,
            *[t for l in tl for t in (l["w"], l["b"])])
    leaves = [t for l in tl for t in (l["w"], l["b"])] + [xt]
    got = torch.autograd.grad(out, leaves, torch.from_numpy(dy))
    for g, w in zip(got, want):
        _close(g.numpy(), w, dtype)


def test_linear_cuda_trains_through_mlp_function():
    """The one-layer wrapper is differentiable: its grads are the
    backward's (kernel #2 on the card)."""
    layers, x, dy = _inputs([33, 17], 5, seed=3)
    (l,) = _torch_layers(layers, grad=True)
    xt = torch.from_numpy(x).requires_grad_(True)
    out = linear_cuda(xt, l["w"], l["b"], act="leaky_relu")
    got = torch.autograd.grad(out, [l["w"], l["b"], xt], torch.from_numpy(dy))
    want = _jax_grads(layers, x, dy, "leaky_relu", "leaky_relu", "float32")
    for g, w in zip(got, want):
        _close(g.numpy(), w, "float32")


def test_mlp_bwd_rejects_bad_inputs():
    layers, x, dy = _inputs([12, 8, 4], 3)
    tl = _torch_layers(layers)
    ws = [l["w"] for l in tl]
    xt = torch.from_numpy(x)
    out, hid = cuda_mlp.mlp_fwd(xt, ws, [l["b"] for l in tl],
                                ("relu", "sigmoid"))
    with pytest.raises(ValueError, match="hiddens"):
        cuda_mlp.mlp_bwd(xt, [], out, torch.from_numpy(dy), ws,
                         ("relu", "sigmoid"))
    with pytest.raises(ValueError, match="dy must be"):
        cuda_mlp.mlp_bwd(xt, hid, out, torch.from_numpy(dy[:, :3].copy()),
                         ws, ("relu", "sigmoid"))


@pytest.mark.parametrize("name,batch", PLAN_CASES,
                         ids=[f"{n}-B{b}" for n, b in PLAN_CASES])
def test_bwd_plan(name, batch):
    """bwd_plan for every served stack and batch: pass 1's chain over the
    reversed widths fits and covers every row and column once; the
    slices partition [0, B) in order, equal but the last, in whole
    DW_CHUNK_ROWS chunks; one slice (two launches) up to 2 x SLICE_MIN_ROWS
    rows; the scratch holds [S, K, N] and [S, N] of every layer."""
    dims = SERVED_STACKS[name]
    plan = cuda_mlp.bwd_plan(batch, dims, 132)
    check_chain_plan(dims[::-1], batch, plan.rows, bwd=True)
    rngs = plan.slice_ranges
    assert len(rngs) == plan.slices >= 1
    assert rngs[0][0] == 0 and rngs[-1][1] == batch
    assert all(a[1] == b[0] for a, b in zip(rngs, rngs[1:]))
    assert all(r1 - r0 == plan.slice_rows for r0, r1 in rngs[:-1])
    assert 0 < rngs[-1][1] - rngs[-1][0] <= plan.slice_rows
    assert plan.slice_rows % cuda_mlp.DW_CHUNK_ROWS == 0
    if batch < 2 * cuda_mlp.SLICE_MIN_ROWS:
        assert plan.slices == 1
    else:
        assert all(r1 - r0 >= cuda_mlp.SLICE_MIN_ROWS // 2 for r0, r1 in rngs)
    tk, tn = cuda_mlp.DW_TILE
    tiles = sum(-(-k // tk) * -(-n // tn) for k, n in zip(dims[:-1], dims[1:]))
    assert plan.dw_grid == (tiles, plan.slices)
    want = 0 if plan.slices == 1 else sum(
        -(-plan.slices * (k * n + n) // 4) * 4
        for k, n in zip(dims[:-1], dims[1:]))
    assert plan.scratch_floats == want
    assert plan.c_args() == plan.rows.c_args() + [
        plan.slices, plan.slice_rows, plan.scratch_floats]


def test_bwd_plan_fills_the_card_at_large_batches():
    """At G B 8192 the dW tiles times the slices fill at least two waves
    of a 132-SM card; at a training batch one slice."""
    big = cuda_mlp.bwd_plan(8192, [128, 400, 784], 132)
    assert big.dw_grid[0] * big.slices >= 2 * 132
    assert cuda_mlp.bwd_plan(100, [128, 400, 784], 132).slices == 1


def test_bwd_plan_raises_when_nothing_fits():
    with pytest.raises(ValueError, match="shared memory"):
        cuda_mlp.bwd_plan(8192, [128, 30000, 784], 132)
