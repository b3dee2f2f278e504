"""The port's VQ primitives (``ops/vq.py``), tokenizers
(``models/vq_net.py``) and vqvae (``losses/vqvae.py``) against the JAX
package's on the CPU, and the whole-MLP kernels' launch plans at every
shape the VQ family gives them.

Both sides get the same weights (the JAX init's, every leaf shifted by
seeded numpy noise, carried with ``params_from_numpy``) and the same
data. Tolerances, each stated where it is used, are the diffusion tests'
(``tests/test_torch_port_ddpm.py``):

- ``NET_TOL`` (rtol 1e-4, atol 1e-5): the nets' outputs and gradients,
  sums in other orders;
- ``TOL`` (rtol 2e-4, atol 2e-5): losses, metrics and a few Adam steps.

The tie rule. The nearest-code search is an argmin: a best and a
second-best distance within float32 rounding of each other pick another
code in another summation order, which changes the decoder's input by a
whole codebook row. So every case that quantizes takes the first data
seed whose smallest relative gap (``ops/vq.py::code_margin``, on the
port's side) clears ``VQ_MARGIN``, fixed before measuring (100 times
the few 1e-7 of a float32 distance's rounding), and asserts it.

Sizes: hidden 32, L 4, D 8, K 16, conv_channels 12 (at 4 a GroupNorm
group holds one channel, whose conv bias then has an exactly zero
gradient Adam turns into noise, ``test_torch_port_conv_trajectory.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generative_models_tpu.losses import vqvae as jvqvae
from generative_models_tpu.losses.registry import get_variant as jax_variant
from generative_models_tpu.models import vq_net as jnet
from generative_models_tpu.ops import vq as jvq
from generative_models_tpu.train import step as jstep
from generative_models_tpu_torch.config import variant_config
from generative_models_tpu_torch.losses import vqvae as pvqvae
from generative_models_tpu_torch.losses.registry import get_variant
from generative_models_tpu_torch.models import vq_net as pnet
from generative_models_tpu_torch.ops import cuda_mlp
from generative_models_tpu_torch.ops import vq as pvq
from generative_models_tpu_torch.train import step as step_lib
from generative_models_tpu_torch.utils.tree import (
    tree_leaves,
    tree_leaves_with_path,
    tree_unflatten,
)
from tests.conftest import TINY, tiny_cfg
from tests.test_torch_port_ddpm import assert_tree, to_port
from tests.test_torch_port_mlp import check_chain_plan

NET_TOL = dict(rtol=1e-4, atol=1e-5)
TOL = dict(rtol=2e-4, atol=2e-5)
VQ_MARGIN = 1e-5
SMALL = dict(vae_hidden_dim=32, vq_tokens=4, vq_code_dim=8,
             vq_codebook_size=16, vq_prior_width=32, vq_prior_layers=2,
             vq_prior_heads=2, conv_channels=12, batch_size=8)
B = 8


def cfgs(variant="vqvae", **kw):
    """(JAX config, port config) of one setting."""
    merged = dict(SMALL, **kw)
    return tiny_cfg(variant, **merged), variant_config(variant, **dict(
        TINY, **merged))


def shifted(tree, seed, shift):
    """A JAX parameter tree as numpy, every leaf shifted by N(0, shift^2)
    noise (so zero-initialised layers pass gradients)."""
    rng = np.random.default_rng(seed + 100)
    return jax.tree.map(lambda a: np.asarray(a) + shift * rng.standard_normal(
        a.shape).astype(np.float32), tree)


def batch_of(seed, b=B):
    rng = np.random.default_rng(seed)
    return (rng.random((b, 784), dtype=np.float32),
            rng.integers(0, 10, b).astype(np.int32))


def tie_free(margin_of, first=0, tries=50):
    """The tie rule: (the first seed from `first` whose margin_of(seed)
    clears VQ_MARGIN, that margin)."""
    for seed in range(first, first + tries):
        m = margin_of(seed)
        if m > VQ_MARGIN:
            return seed, m
    raise AssertionError(f"no seed of {tries} clears the tie margin")


def vqvae_margin(params, x, cfg):
    """The code margin of images x through a port vqvae tree."""
    with torch.no_grad():
        z = pnet.encoder_apply(params["encoder"], torch.as_tensor(x), cfg)
        return pvq.code_margin(z, params["codebook"])


def grads_of(val, tree):
    leaves = tree_leaves(tree)
    return tree_unflatten(tree, list(torch.autograd.grad(val, leaves)))


def with_grad(tree):
    return tree_unflatten(tree, [t.requires_grad_(True)
                                 for t in tree_leaves(tree)])


# --------------------------------------------------------------------
# ops/vq.py
# --------------------------------------------------------------------

def test_vq_ops_match_jax():
    """code_distances, quantize (indices equal, the tie margin asserted),
    lookup (exact), straight_through (forward z + (z_q - z), backward
    identity) and perplexity."""
    def draw(seed):
        rng = np.random.default_rng(seed)
        return (rng.standard_normal((6, 5, 8)).astype(np.float32),
                (rng.standard_normal((16, 8)) / np.sqrt(8)).astype(
                    np.float32))
    seed, margin = tie_free(lambda s: pvq.code_margin(
        *map(torch.from_numpy, draw(s))))
    z, book = draw(seed)
    zt, bt = torch.from_numpy(z), torch.from_numpy(book)
    np.testing.assert_allclose(
        pvq.code_distances(zt, bt).numpy(),
        np.asarray(jvq.code_distances(jnp.asarray(z), jnp.asarray(book))),
        **NET_TOL)
    j_idx, j_zq = jvq.quantize(jnp.asarray(z), jnp.asarray(book))
    idx, zq = pvq.quantize(zt, bt)
    assert margin > VQ_MARGIN
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
    np.testing.assert_array_equal(zq.numpy(), np.asarray(j_zq))
    np.testing.assert_array_equal(zq.numpy(), book[idx.numpy()])
    np.testing.assert_allclose(
        float(pvq.perplexity(idx, 16)),
        float(jvq.perplexity(j_idx, 16)), **TOL)
    zz = zt.clone().requires_grad_(True)
    st = pvq.straight_through(zz, zq)
    np.testing.assert_array_equal(st.detach().numpy(), np.asarray(
        jvq.straight_through(jnp.asarray(z), j_zq)))
    r = torch.randn(st.shape, generator=torch.Generator().manual_seed(1))
    (g,) = torch.autograd.grad((st * r).sum(), zz)
    assert torch.equal(g, r)


def test_argmin_keeps_the_first_index_on_ties():
    """Rows at equal distance from two codes take the lower index, as
    jnp.argmin does; the uniform and collapsed perplexities are K and 1."""
    book = np.array([[1.0, 0.0], [0.0, 1.0], [1.0, 0.0], [0.0, 1.0]],
                    np.float32)
    z = np.array([[[2.0, 0.0], [0.0, 3.0], [1.0, 1.0]]], np.float32)
    idx, _ = pvq.quantize(torch.from_numpy(z), torch.from_numpy(book))
    j_idx, _ = jvq.quantize(jnp.asarray(z), jnp.asarray(book))
    assert idx.tolist() == [[0, 1, 0]] == np.asarray(j_idx).tolist()
    assert float(pvq.perplexity(torch.arange(4), 4)) == pytest.approx(4.0)
    assert float(pvq.perplexity(torch.zeros(9, dtype=torch.long), 4)) == \
        pytest.approx(1.0)


# --------------------------------------------------------------------
# models/vq_net.py
# --------------------------------------------------------------------

def test_init_trees_match_jax():
    """The port's vqvae tree has the reference's leaf paths and shapes on
    both archs, and the codebook's scale is N(0, 1)/sqrt(D)."""
    for arch in ("mlp", "conv"):
        jcfg, cfg = cfgs(arch=arch)
        jp = jvqvae.init_params(jax.random.PRNGKey(0), jcfg)
        pp = pvqvae.init_params(torch.Generator().manual_seed(0), cfg)
        assert {p: tuple(t.shape) for p, t in tree_leaves_with_path(pp)} == {
            p: a.shape for p, a in tree_leaves_with_path(
                jax.tree.map(np.asarray, jp))}
    assert pnet.num_tokens(cfg) == jnet.num_tokens(jcfg) == 49
    big = variant_config("vqvae", vq_codebook_size=4096, vq_code_dim=16)
    book = pvqvae.init_params(torch.Generator().manual_seed(0), big)[
        "codebook"]
    assert float(book.std()) == pytest.approx(0.25, rel=0.02)


@pytest.mark.parametrize("arch", ["mlp", "conv"])
def test_tokenizers_match_jax(arch):
    """encoder_apply [B, L, D] and decoder_apply (logits and images), and
    every gradient of sum(out * r) through both, against the reference."""
    jcfg, cfg = cfgs(arch=arch)
    jp = shifted(jvqvae.init_params(jax.random.PRNGKey(1), jcfg), 1, 0.02)
    x, _ = batch_of(2)
    l = pnet.num_tokens(cfg)
    rng = np.random.default_rng(3)
    zq = rng.standard_normal((B, l, 8)).astype(np.float32)
    r_enc = rng.standard_normal((B, l, 8)).astype(np.float32)
    r_dec = rng.standard_normal((B, 784)).astype(np.float32)

    def jf(p, xx, zz):
        z = jnet.encoder_apply(p["encoder"], xx, jcfg)
        out = jnet.decoder_apply(p["decoder"], zz, jcfg, logits=True)
        return jnp.sum(z * r_enc) + jnp.sum(out * r_dec), (z, out)
    (_, (j_z, j_out)), (j_gp, j_gz) = jax.jit(jax.value_and_grad(
        jf, argnums=(0, 2), has_aux=True))(
        jax.tree.map(jnp.asarray, jp), jnp.asarray(x), jnp.asarray(zq))
    pp = with_grad(to_port(jp))
    zt = torch.from_numpy(zq).requires_grad_(True)
    z = pnet.encoder_apply(pp["encoder"], torch.from_numpy(x), cfg)
    out = pnet.decoder_apply(pp["decoder"], zt, cfg, logits=True)
    assert tuple(z.shape) == (B, l, 8) and tuple(out.shape) == (B, 784)
    np.testing.assert_allclose(z.detach().numpy(), np.asarray(j_z), **NET_TOL)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out),
                               **NET_TOL)
    img = pnet.decoder_apply(pp["decoder"], zt, cfg)
    np.testing.assert_allclose(img.detach().numpy(), np.asarray(
        jnet.decoder_apply(jax.tree.map(jnp.asarray, jp)["decoder"],
                           jnp.asarray(zq), jcfg)), **NET_TOL)
    val = (z * torch.from_numpy(r_enc)).sum() + (
        out * torch.from_numpy(r_dec)).sum()
    leaves = tree_leaves(pp["encoder"]) + tree_leaves(pp["decoder"])
    g = torch.autograd.grad(val, leaves + [zt])
    n_enc = len(tree_leaves(pp["encoder"]))
    assert_tree(tree_unflatten(pp["encoder"], list(g[:n_enc])),
                j_gp["encoder"], f"{arch} encoder grad", NET_TOL)
    assert_tree(tree_unflatten(pp["decoder"], list(g[n_enc:-1])),
                j_gp["decoder"], f"{arch} decoder grad", NET_TOL)
    np.testing.assert_allclose(g[-1].numpy(), np.asarray(j_gz), **NET_TOL)


# --------------------------------------------------------------------
# losses/vqvae.py
# --------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["mlp", "conv"])
def test_vqvae_loss_metrics_and_gradients_match_jax(arch):
    jcfg, cfg = cfgs(arch=arch)
    jp = shifted(jvqvae.init_params(jax.random.PRNGKey(4), jcfg), 4, 0.02)
    pp = with_grad(to_port(jp))
    seed, margin = tie_free(lambda s: vqvae_margin(pp, batch_of(s)[0], cfg),
                            first=5)
    x, y = batch_of(seed)
    assert margin > VQ_MARGIN
    (j_val, j_m), j_g = jax.jit(jax.value_and_grad(
        lambda p: jvqvae.loss(p, {"image": jnp.asarray(x)}, None, jcfg),
        has_aux=True))(jax.tree.map(jnp.asarray, jp))
    val, m = pvqvae.loss(pp, {"image": torch.from_numpy(x),
                              "label": torch.from_numpy(y)}, None, cfg)
    assert sorted(m) == sorted(j_m) == ["commit_loss", "loss", "perplexity",
                                        "recon_loss", "vq_loss"]
    for k in m:
        np.testing.assert_allclose(float(m[k]), float(j_m[k]), err_msg=k,
                                   **TOL)
    assert_tree(grads_of(val, pp), j_g, f"{arch} loss grad", NET_TOL)


def test_vqvae_serving_functions_match_jax():
    """encode_tokens, decode_tokens, reconstruct, and sample given the
    reference's uniform token draw (jax.random.randint), as z."""
    jcfg, cfg = cfgs()
    jp = shifted(jvqvae.init_params(jax.random.PRNGKey(6), jcfg), 6, 0.02)
    pp = to_port(jp)
    seed, margin = tie_free(lambda s: vqvae_margin(pp, batch_of(s)[0], cfg),
                            first=7)
    x, _ = batch_of(seed)
    assert margin > VQ_MARGIN
    jpp = jax.tree.map(jnp.asarray, jp)
    tokens = pvqvae.encode_tokens(pp, torch.from_numpy(x), cfg)
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(
        jvqvae.encode_tokens(jpp, jnp.asarray(x), jcfg)))
    np.testing.assert_allclose(
        pvqvae.reconstruct(pp, torch.from_numpy(x), None, cfg).numpy(),
        np.asarray(jvqvae.reconstruct(jpp, jnp.asarray(x), None, jcfg)),
        **NET_TOL)
    rng = jax.random.PRNGKey(8)
    want = np.asarray(jvqvae.sample(jpp, rng, 5, jcfg))
    idx = np.asarray(jax.random.randint(rng, (5, 4), 0, 16))
    got = pvqvae.sample(pp, None, 5, cfg, z=torch.from_numpy(idx))
    np.testing.assert_allclose(got.numpy(), want, **NET_TOL)
    gen = torch.Generator().manual_seed(0)
    drawn = pvqvae.sample(pp, gen, 3, cfg)
    assert tuple(drawn.shape) == (3, 784)
    assert 0.0 <= float(drawn.min()) and float(drawn.max()) <= 1.0


def test_tokens_of_normal_are_uniform():
    """The exported sampler's map from normal draws to tokens: every
    token in [0, K), each about equally often."""
    z = torch.randn(200_000, generator=torch.Generator().manual_seed(0))
    t = pvqvae.tokens_of_normal(z, 16)
    counts = torch.bincount(t, minlength=16).float() / z.numel()
    assert t.min() >= 0 and t.max() <= 15
    assert float((counts - 1 / 16).abs().max()) < 3e-3


def export_round_trip(tmp_path, variant, kw, params):
    """Export `variant`'s sampler (SMALL widths and `kw`, `params`, n 3)
    and load it with torch alone on the CPU: the artifact repeats bit for
    bit per seed, differs across seeds, and equals Trainer.sample given
    export.sampler_draws of the seed. Returns those draws (seed 123)."""
    from generative_models_tpu_torch.train.trainer import Trainer
    from generative_models_tpu_torch.utils import export
    t = Trainer(variant, device="cpu", **SMALL, **kw, sample_n=3)
    t.state["params"] = params
    path = export.save_sampler(str(tmp_path / "s.pt2"), t.spec, t.cfg,
                               t.generator_params, 3)
    fn = export.load_sampler(path, device="cpu")
    draws = export.sampler_draws(t.spec, t.cfg, torch.tensor(123), 3)
    a = fn(123)
    assert torch.equal(a, fn(123)) and tuple(a.shape) == (3, 784)
    np.testing.assert_allclose(a.numpy(), t.sample(n=3, **draws), rtol=0,
                               atol=1e-6)
    assert not torch.equal(a, fn(124))
    return export.sampler_draws(t.spec, t.cfg, torch.tensor(123), 3)


def test_exported_vqvae_sampler_equals_trainer_sample(tmp_path):
    """vqvae's artifact: its z is the Philox normals of width L mapped to
    uniform integer tokens."""
    jcfg, cfg = cfgs()
    params = to_port(shifted(jvqvae.init_params(jax.random.PRNGKey(13),
                                                jcfg), 13, 0.02))
    draws = export_round_trip(tmp_path, "vqvae", {}, params)
    assert draws["z"].dtype == torch.int64 and draws["z"].shape == (3, 4)
    assert pnet.num_tokens(cfg) == 4


def test_code_margin_reads_the_gap():
    """code_margin: the smallest (second - best) distance over the scale
    of the distances' terms; 0 at an exact tie."""
    book = torch.tensor([[1.0, 0.0], [0.0, 1.0]])
    z = torch.tensor([[2.0, 0.0], [1.0, 1.0]])
    assert pvq.code_margin(z, book) == 0.0
    m = pvq.code_margin(z[:1], book)
    assert m == pytest.approx((5.0 - 1.0) / (1.0 + 4.0))


STEPS = 3


@pytest.mark.parametrize("arch", ["mlp", "conv"])
def test_vqvae_general_steps_match_jax(arch):
    """STEPS single-model steps from the same state and batches (the
    step draws no noise: its noise rows are [B, 0]); the losses and
    metrics, the params and the Adam slots within TOL; the tie margin
    held at every step's state."""
    jcfg, cfg = cfgs(arch=arch)
    jspec, spec = jax_variant("vqvae"), get_variant("vqvae")
    assert spec.step_lanes(cfg) == 0
    state = jstep.init_state(jspec, jcfg, jax.random.PRNGKey(0))
    state["params"] = jax.tree.map(jnp.asarray, shifted(
        state["params"], 9, 0.02))
    state["opt"] = jstep.make_tx(jcfg, jcfg.g_lr).init(state["params"])
    pst = step_lib.init_state(spec, cfg, torch.Generator().manual_seed(0))
    pst["params"] = to_port(state["params"])
    train = step_lib.build_step(spec, cfg)

    def run(first):
        st, out = pst, []
        for k in range(STEPS):
            x, y = batch_of(first + k)
            m = vqvae_margin(st["params"], x, cfg)
            st, pm = train(st, {"image": torch.from_numpy(x)[None],
                                "label": torch.from_numpy(y)[None]},
                           torch.zeros(B, 0))
            out.append((x, y, pm, m))
        return st, out
    first, _ = tie_free(lambda s: min(m for *_, m in run(s)[1]), first=20)
    pst, out = run(first)
    j_train = jax.jit(jstep.build_step(jspec, jcfg))
    for x, y, pm, margin in out:
        assert margin > VQ_MARGIN
        state, jm = j_train(state, {"image": jnp.asarray(x)[None],
                                    "label": jnp.asarray(y)[None]})
        for k in ("loss", "recon_loss", "vq_loss", "perplexity"):
            np.testing.assert_allclose(float(pm[k]), float(jm[k]), err_msg=k,
                                       **TOL)
    assert_tree(pst["params"], state["params"], "params", TOL)
    assert_tree(pst["opt"]["mu"], state["opt"][0].mu, "mu", TOL)
    assert_tree(pst["opt"]["nu"], state["opt"][0].nu, "nu", TOL)
    assert int(pst["opt"]["count"]) == int(state["opt"][0].count) == STEPS


def test_fused_step_refuses_the_vq_family(tiny_data):
    """The chunk kernels refuse vqvae and vqprior, as the reference's
    (pallas_train.py:1394-1400), so "auto" takes the general step on the
    card, and fused_step=True raises."""
    from generative_models_tpu_torch.ops import cuda_train
    from generative_models_tpu_torch.train.trainer import Trainer
    for v in ("vqvae", "vqprior"):
        spec, cfg = get_variant(v), variant_config(v)
        ok, reason = cuda_train.fused_step_supported(spec, cfg)
        assert not ok and "pallas_train.py:1387-1400" in reason
        assert not cuda_train.resolve_fused_step(spec, cfg, "cuda")
        with pytest.raises(ValueError, match="fused_step unsupported"):
            Trainer(v, device="cpu", fused_step=True, **SMALL)


# --------------------------------------------------------------------
# Launch plans of the whole-MLP kernels on this path (132 SMs)
# --------------------------------------------------------------------

# the prior's five linears at config.py's width 128 (qkv, proj, fc1, fc2,
# head to K 64), at the rows they run: n a decode step (64, 1024, 8192),
# B * L in training (100 * 16, 100 * 49), n * L in "full" decoding
# (64 * 16, 1024 * 49 = 50,176), and B 100
PRIOR_LAYERS = {"qkv": [128, 384], "proj": [128, 128], "fc1": [128, 512],
                "fc2": [512, 128], "head": [128, 64]}
PRIOR_ROWS = (64, 100, 1024, 1600, 4900, 8192, 50176)
# the MLP tokenizer's stacks at L 16, D 16, hidden 400: B 100 in
# training, n 8192 served
TOKENIZER_STACKS = {"encoder": [784, 400, 256], "decoder": [256, 400, 784]}
PLAN_CASES = ([(n, r) for n in PRIOR_LAYERS for r in PRIOR_ROWS]
              + [(n, b) for n in TOKENIZER_STACKS for b in (100, 8192)])


@pytest.mark.parametrize("name,rows", PLAN_CASES,
                         ids=[f"{n}-B{r}" for n, r in PLAN_CASES])
def test_vq_dense_layers_plan_both_ways(name, rows):
    dims = {**PRIOR_LAYERS, **TOKENIZER_STACKS}[name]
    fwd = cuda_mlp.fwd_plan(rows, dims, 132)
    check_chain_plan(dims, rows, fwd, bwd=False)
    bwd = cuda_mlp.bwd_plan(rows, dims, 132)
    check_chain_plan(dims[::-1], rows, bwd.rows, bwd=True)
    assert bwd.dw_grid == (cuda_mlp.dw_tiles(dims), bwd.slices)
