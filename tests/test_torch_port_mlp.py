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


@pytest.mark.parametrize("batch,want", [(64, 16), (1024, 16), (8192, 32)])
def test_tile_rows_for_serving_batches(batch, want):
    """32-row tiles only once they fill every SM of a 132-SM card, and
    the shared-memory request stays under the per-block limit."""
    dims = [128, 400, 784]
    t = cuda_mlp.tile_rows_for(batch, dims, 132)
    assert t == want
    assert cuda_mlp.smem_bytes(dims, t) == t * (128 + 400) * 4


def test_tile_rows_for_raises_when_tile_does_not_fit():
    with pytest.raises(ValueError, match="shared memory"):
        cuda_mlp.tile_rows_for(8192, [4000, 4000, 10], 132)
