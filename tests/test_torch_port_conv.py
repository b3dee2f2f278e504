"""The port's conv stacks (``generative_models_tpu_torch/models/conv.py``)
against the JAX package's ``models/conv.py``: the same weights (drawn by
the JAX init, carried with ``utils/checkpoint.py::params_from_numpy``)
and the same numpy-seeded inputs through both.

- Layers: the stride-2 conv and transposed conv, GroupNorm (at 12
  channels it takes 6 groups, the fallback) and every stack's forward at
  ``conv_channels`` 4 and 12 agree to rtol 2e-5 / atol 2e-5 in float32,
  the tolerance of ``tests/test_torch_oracle_conv.py``.
- The plain critic's input gradient and the penalty-style second
  derivative with respect to every critic leaf agree to rtol 2e-5 / atol
  1e-6 (one double backward at 4 channels).
- bfloat16 (``dtype="bfloat16"``): the stacks agree to atol 1e-2 / rtol
  1e-2. The two sides round differently on purpose: the port's dense
  layers round both operands to bf16 (the kernels' rule), where the
  reference's XLA path keeps W in float32 when its input is already bf16.
- The conv functions' own derivatives (``_Conv``, ``_ConvT``,
  ``_ConvW``: each the others' adjoint) pass ``gradcheck`` and
  ``gradgradcheck`` in float64, and every convolution of a forward, a
  backward and a double backward runs inside ``_strict`` (on the card:
  cuDNN's TF32 off, its deterministic algorithms).
- Init: HWIO kernels within U(+-1/sqrt(kh kw cin)) filling the range;
  began's decoder is norm-free; the flatten order is NHWC.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generative_models_tpu.config import variant_config as jax_variant_config
from generative_models_tpu.models import conv as jconv
from generative_models_tpu_torch.config import variant_config
from generative_models_tpu_torch.models import conv
from generative_models_tpu_torch.utils.checkpoint import params_from_numpy
from generative_models_tpu_torch.utils.tree import (
    tree_leaves,
    tree_leaves_with_path,
)

TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=2e-5, atol=1e-6)
BF16_TOL = dict(rtol=1e-2, atol=1e-2)
B = 4
SIZES = dict(z_dim=8, hidden_dim=16, vae_hidden_dim=16, latent_dim=4,
             began_ae_hidden=16, info_cat_dim=3, info_cont_dim=2,
             num_classes=10)


def _cfgs(channels, variant="nsgan", **kw):
    kw = dict(SIZES, arch="conv", conv_channels=channels, **kw)
    return jax_variant_config(variant, **kw), variant_config(variant, **kw)


def _port(tree):
    return params_from_numpy(jax.tree.map(lambda a: np.array(a), tree))


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _assert_close(mine, theirs, **tol):
    mine = mine if isinstance(mine, (tuple, list)) else (mine,)
    theirs = theirs if isinstance(theirs, (tuple, list)) else (theirs,)
    assert len(mine) == len(theirs)
    for a, b in zip(mine, theirs):
        a = a.detach().float().numpy()
        b = np.asarray(jnp.asarray(b, jnp.float32))
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, **tol)


@pytest.mark.parametrize("channels", [4, 12])
def test_conv_and_transposed_conv_layers_match_jax(channels):
    rng = np.random.default_rng(channels)
    layer = jconv.conv_init(jax.random.PRNGKey(0), 4, 4, 3, channels)
    up = jconv.conv_init(jax.random.PRNGKey(1), 4, 4, channels, 3)
    x = rng.standard_normal((B, 28, 28, 3)).astype(np.float32)
    h = rng.standard_normal((B, 7, 7, channels)).astype(np.float32)

    want = jconv.conv_apply(layer, jnp.asarray(x), stride=2,
                            act="leaky_relu", slope=0.3)
    got = conv.conv_apply(_port(layer), _nchw(x), act="leaky_relu",
                          slope=0.3)
    assert got.shape == (B, channels, 14, 14)
    _assert_close(got.permute(0, 2, 3, 1), want, **TOL)

    want = jconv.convt_apply(up, jnp.asarray(h), stride=2, act="tanh")
    got = conv.convt_apply(_port(up), _nchw(h), act="tanh")
    assert got.shape == (B, 3, 14, 14)
    _assert_close(got.permute(0, 2, 3, 1), want, **TOL)


@pytest.mark.parametrize("channels,groups", [(12, 6), (8, 8), (24, 8),
                                             (5, 5), (3, 3)])
def test_groupnorm_matches_jax(channels, groups):
    """12 channels take 6 groups (8 does not divide 12): the fallback."""
    rng = np.random.default_rng(channels)
    assert conv.gn_groups(channels) == groups
    params = {"scale": rng.standard_normal(channels).astype(np.float32),
              "bias": rng.standard_normal(channels).astype(np.float32)}
    x = (3.0 * rng.standard_normal((B, 7, 7, channels)) + 1.5).astype(
        np.float32)
    want = jconv.gn_apply(jax.tree.map(jnp.asarray, params), jnp.asarray(x))
    got = conv.gn_apply(params_from_numpy(params), _nchw(x))
    _assert_close(got.permute(0, 2, 3, 1), want, **TOL)


def _stack_cases(jcfg, cfg, rng):
    """(name, JAX params, JAX output, port output fn) of every stack."""
    z = rng.standard_normal((B, jcfg.z_dim)).astype(np.float32)
    zl = rng.standard_normal((B, jcfg.latent_dim)).astype(np.float32)
    x = rng.random((B, 784), dtype=np.float32)
    y = rng.integers(0, 10, B).astype(np.int32)
    k = jax.random.split(jax.random.PRNGKey(7), 7)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    g = jconv.generator_init(k[0], jcfg)
    d = jconv.discriminator_init(k[1], jcfg)
    cd = jconv.cond_discriminator_init(k[2], jcfg)
    enc = jconv.encoder_init(k[3], jcfg)
    dec = jconv.decoder_init(k[4], jcfg)
    bd = jconv.began_d_init(k[5], jcfg)
    info = jconv.infogan_d_init(k[6], jcfg)
    return [
        ("generator", g, jconv.generator_apply(g, jnp.asarray(z), jcfg),
         lambda p: conv.generator_apply(p, torch.from_numpy(z), cfg)),
        ("discriminator", d, jconv.discriminator_apply(d, jx, jcfg),
         lambda p: conv.discriminator_apply(p, tx, cfg)),
        ("discriminator_plain", d, jconv.discriminator_apply(d, jx, jcfg),
         lambda p: conv.discriminator_apply_plain(p, tx, cfg)),
        ("cond_discriminator", cd,
         jconv.cond_discriminator_apply(cd, jx, jnp.asarray(y), jcfg),
         lambda p: conv.cond_discriminator_apply(p, tx, torch.from_numpy(y),
                                                 cfg)),
        ("encoder", enc, jconv.encoder_apply(enc, jx, jcfg),
         lambda p: conv.encoder_apply(p, tx, cfg)),
        ("decoder_logits", dec,
         jconv.decoder_apply(dec, jnp.asarray(zl), jcfg, logits=True),
         lambda p: conv.decoder_apply(p, torch.from_numpy(zl), cfg,
                                      logits=True)),
        ("decoder", dec, jconv.decoder_apply(dec, jnp.asarray(zl), jcfg),
         lambda p: conv.decoder_apply(p, torch.from_numpy(zl), cfg)),
        ("began_d", bd, jconv.began_d_apply(bd, jx, jcfg),
         lambda p: conv.began_d_apply(p, tx, cfg)),
        ("infogan_d", info, jconv.infogan_d_apply(info, jx, jcfg),
         lambda p: conv.infogan_d_apply(p, tx, cfg)),
    ]


@pytest.mark.parametrize("channels", [4, 12])
def test_every_stack_matches_jax(channels):
    jcfg, cfg = _cfgs(channels)
    for name, jp, want, fn in _stack_cases(jcfg, cfg,
                                           np.random.default_rng(channels)):
        got = fn(_port(jp))
        try:
            _assert_close(got, want, **TOL)
        except AssertionError as e:
            raise AssertionError(f"{name}: {e}") from None


def test_every_stack_matches_jax_in_bfloat16():
    jcfg, cfg = _cfgs(4, dtype="bfloat16")
    for name, jp, want, fn in _stack_cases(jcfg, cfg,
                                           np.random.default_rng(5)):
        got = fn(_port(jp))
        for t in (got if isinstance(got, tuple) else (got,)):
            assert t.dtype == torch.float32, name
        try:
            _assert_close(got, want, **BF16_TOL)
        except AssertionError as e:
            raise AssertionError(f"{name}: {e}") from None


def test_plain_critic_input_and_second_order_gradients_match_jax():
    """dD/dx of the plain critic, and d/dparams of a penalty on it."""
    jcfg, cfg = _cfgs(4, "wgangp")
    rng = np.random.default_rng(3)
    jd = jconv.discriminator_init(jax.random.PRNGKey(2), jcfg)
    x = rng.random((B, 784), dtype=np.float32)

    def jpen(p):
        g = jax.grad(lambda xx: jnp.sum(jconv.discriminator_apply(
            p, xx, jcfg)))(jnp.asarray(x))
        return jnp.mean((jnp.sqrt(jnp.sum(g * g, -1) + 1e-12) - 1.0) ** 2), g
    (jp, jg), jgrads = jax.value_and_grad(jpen, has_aux=True)(jd)

    d = _port(jd)
    leaves = [t.requires_grad_(True) for t in tree_leaves(d)]
    xt = torch.from_numpy(x).requires_grad_(True)
    g, = torch.autograd.grad(conv.discriminator_apply_plain(d, xt, cfg).sum(),
                             xt, create_graph=True)
    pen = torch.mean((torch.sqrt(torch.sum(g * g, -1) + 1e-12) - 1.0) ** 2)
    _assert_close(g, jg, **GRAD_TOL)
    _assert_close(pen, jp, **GRAD_TOL)
    # a leaf the penalty does not reach (fc's bias) has gradient 0, as
    # JAX gives it
    grads = [torch.zeros_like(t) if gr is None else gr for t, gr in zip(
        leaves, torch.autograd.grad(pen, leaves, allow_unused=True))]
    _assert_close(grads, jax.tree_util.tree_leaves(jgrads), **GRAD_TOL)
    paths = [p for p, _ in tree_leaves_with_path(d)]
    assert all(float(t.abs().max()) > 0 for p, t in zip(paths, grads)
               if p.endswith("['w']")), paths


def test_conv_functions_are_adjoints_to_every_order():
    """gradcheck and gradgradcheck of the three conv functions (float64),
    at the smallest shapes a 4x4 stride-2 kernel takes, on one thread:
    they make thousands of tiny calls, which a thread pool shared with
    other test workers slows by two orders of magnitude."""
    rng = np.random.default_rng(0)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape)).requires_grad_()
    u, w = t(1, 2, 4, 4), t(3, 2, 4, 4)
    v = t(1, 3, 2, 2)
    cases = [
        (conv._Conv.apply, (u, w)),
        (lambda a, b: conv._ConvT.apply(a, b, (4, 4)), (v, w)),
        (lambda a, b: conv._ConvW.apply(a, b, 4), (u, v)),
    ]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for fn, args in cases:
            assert torch.autograd.gradcheck(fn, args)
            assert torch.autograd.gradgradcheck(fn, args)
    finally:
        torch.set_num_threads(threads)
    # and they are torch's own convolution
    np.testing.assert_allclose(
        conv._Conv.apply(u, w).detach(),
        torch.nn.functional.conv2d(u, w, stride=2, padding=1).detach(),
        rtol=1e-12, atol=1e-12)
    # the adjoint of a conv of a 6x6 or a 7x7 input (both 3x3 out): the
    # second takes an output padding of 1
    h = t(2, 3, 3, 3)
    for hw in ((6, 6), (7, 7)):
        assert conv._ConvT.apply(h, w, hw).shape == (2, 2) + hw


def test_every_convolution_runs_strict(monkeypatch):
    """Each convolution of a forward, its backward and a double backward
    runs inside ``_strict``; for a CUDA tensor ``_strict`` turns cuDNN's
    TF32 off and its deterministic algorithms on, and restores both
    flags after; for a CPU tensor it leaves them."""
    cudnn = torch.backends.cudnn
    prev = cudnn.allow_tf32, cudnn.deterministic
    try:
        cudnn.allow_tf32, cudnn.deterministic = True, False
        with conv._strict(types.SimpleNamespace(is_cuda=True)):
            assert (cudnn.allow_tf32, cudnn.deterministic) == (False, True)
        assert (cudnn.allow_tf32, cudnn.deterministic) == (True, False)
        with conv._strict(torch.zeros(1)):
            assert (cudnn.allow_tf32, cudnn.deterministic) == (True, False)
    finally:
        cudnn.allow_tf32, cudnn.deterministic = prev

    depth = {"n": 0}
    calls = []
    real = conv._strict

    class Counting:
        def __init__(self, t):
            self.cm = real(t)

        def __enter__(self):
            depth["n"] += 1
            return self.cm.__enter__()

        def __exit__(self, *exc):
            depth["n"] -= 1
            return self.cm.__exit__(*exc)

    def watch(name, fn):
        def run(*a, **k):
            calls.append((name, depth["n"]))
            return fn(*a, **k)
        return run

    monkeypatch.setattr(conv, "_strict", Counting)
    F = torch.nn.functional
    monkeypatch.setattr(conv.F, "conv2d", watch("conv2d", F.conv2d))
    monkeypatch.setattr(conv.F, "conv_transpose2d",
                        watch("conv_transpose2d", F.conv_transpose2d))
    monkeypatch.setattr(torch.nn.grad, "conv2d_weight",
                        watch("conv2d_weight", torch.nn.grad.conv2d_weight))
    _, cfg = _cfgs(4, "wgangp")
    gen = torch.Generator().manual_seed(0)
    d = conv.discriminator_init(gen, cfg)
    g = conv.generator_init(gen, cfg)
    leaves = [t.requires_grad_(True) for t in tree_leaves(d) + tree_leaves(g)]
    x = conv.generator_apply(g, torch.randn(B, cfg.z_dim), cfg)
    x.retain_grad()
    gx, = torch.autograd.grad(conv.discriminator_apply_plain(d, x, cfg).sum(),
                              x, create_graph=True)
    torch.autograd.grad((gx * gx).sum(), leaves, allow_unused=True)
    assert {n for n, _ in calls} == {"conv2d", "conv_transpose2d",
                                     "conv2d_weight"}
    assert all(level == 1 for _, level in calls), calls


def test_init_bounds_layout_and_norm_free_decoder():
    gen = torch.Generator().manual_seed(0)
    layer = conv.conv_init(gen, 4, 4, 3, 16)
    bound = 1.0 / (4 * 4 * 3) ** 0.5
    assert layer["w"].shape == (4, 4, 3, 16) and layer["b"].shape == (16,)
    for t in layer.values():
        assert float(t.abs().max()) <= bound
    assert float(layer["w"].abs().max()) > 0.8 * bound
    _, cfg = _cfgs(4, "began")
    g = conv.generator_init(gen, cfg)
    assert sorted(g) == ["fc", "gn0", "gn1", "up1", "up2"]
    # the transposed kernels take the input-fan rule too: cin = 2C, C
    assert float(g["up1"]["w"].abs().max()) <= 1 / (16 * 8) ** 0.5
    assert g["up2"]["w"].shape == (4, 4, 4, 1)
    d = conv.began_d_init(gen, cfg)
    assert sorted(d["dec"]) == ["fc", "up1", "up2"]
    assert conv.trunk_out_dim(cfg) == 7 * 7 * 8
    # the shapes are the reference's, leaf for leaf
    jshapes = [a.shape for a in jax.tree_util.tree_leaves(
        jconv.began_d_init(jax.random.PRNGKey(0), jax_variant_config(
            "began", **dict(SIZES, arch="conv", conv_channels=4))))]
    assert [tuple(t.shape) for t in tree_leaves(d)] == jshapes


def test_flatten_order_is_nhwc():
    x = torch.arange(2 * 3 * 4 * 5, dtype=torch.float32).reshape(2, 3, 4, 5)
    want = x.permute(0, 2, 3, 1).reshape(2, -1)
    assert torch.equal(conv._flat(x), want)
    rows = torch.arange(2 * 784 * 3, dtype=torch.float32).reshape(2, -1)
    img = conv._img(rows, 3)
    assert img.shape == (2, 3, 28, 28)
    assert torch.equal(conv._flat(img), rows)
    # pixel (h, w) channel c of a flat row is element (h * 28 + w) * 3 + c
    assert float(img[1, 2, 5, 7]) == float(rows[1, (5 * 28 + 7) * 3 + 2])
