"""The minimax, least-squares, Wasserstein, f-divergence, relativistic and
Fisher heads (nsgan, mmgan, lsgan, wgan, fgan, ragan, fishergan) on the
conv stacks against the JAX package's: the loss, every metric and every
gradient leaf of D and of G agree to rtol 2e-5 / atol 1e-6.

``check_head``, shared with ``test_torch_port_conv_heads_b.py``, holds
one variant's losses and gradients on the conv stacks, the JAX
package's against the port's, from the same weights (the JAX init's,
carried with ``params_from_numpy``), batch and noise. The JAX heads' draws are
patched to return the numpy noise (``compute_noise``; infogan's
``_sample_codes``; wgangp's ``interpolate`` and dragan's
``perturb_real`` with the numpy eps or u); the VAE family's eps is drawn
by ``jax.random.normal`` from the key the JAX loss is given and handed
to the port as ``eps=``. The size is ``tests/conftest.py::tiny_cfg``'s
with ``conv_channels`` 4 and latent 4, as ``tests/test_conv.py`` runs
the heads. fishergan's multiplier and began's k_t start at 0.3, so that
the terms they weigh are held too.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generative_models_tpu.losses.registry import get_variant as jax_variant
from generative_models_tpu_torch.config import variant_config
from generative_models_tpu_torch.losses.infogan import code_rows
from generative_models_tpu_torch.losses.registry import get_variant
from generative_models_tpu_torch.ops import penalty
from generative_models_tpu_torch.utils.checkpoint import params_from_numpy
from generative_models_tpu_torch.utils.tree import tree_leaves
from tests.conftest import TINY, tiny_cfg

# one float32 forward and backward (and the penalty's second one) through
# convs of at most 16 x 8 products a sum and dense layers of 392
HEAD_TOL = dict(rtol=2e-5, atol=1e-6)
# the VAE family's loss sums 784 pixels' BCE (~550): the tolerance of
# tests/test_torch_port_vae.py for its losses and gradients (a bias
# gradient of order 1e-6 there is a cancelling sum)
VAE_TOL = dict(rtol=2e-4, atol=2e-5)
CONV_TINY = dict(arch="conv", conv_channels=4, latent_dim=4)
VSTATE = {"fishergan": {"lam": 0.3}, "began": {"k": 0.3}}


def cfgs(variant):
    return (tiny_cfg(variant, **CONV_TINY),
            variant_config(variant, **dict(TINY, **CONV_TINY)))


def port(tree):
    return params_from_numpy(jax.tree.map(lambda a: np.array(a), tree))


def _jmod(variant):
    name = "minimax" if variant in ("nsgan", "mmgan") else variant
    return importlib.import_module(f"generative_models_tpu.losses.{name}")


def _vstates(spec, jspec, cfg, jcfg, variant):
    jvs = dict(jspec.init_vstate(jcfg))
    vs = dict(spec.init_vstate(cfg))
    for k, v in VSTATE.get(variant, {}).items():
        jvs[k] = jnp.float32(v)
        vs[k] = torch.tensor(v, dtype=torch.float32)
    assert sorted(jvs) == sorted(vs)
    return jvs, vs


def _assert_grads(mine, theirs, what, tol=HEAD_TOL):
    theirs = jax.tree_util.tree_leaves(theirs)
    assert len(mine) == len(theirs), what
    for i, (a, b) in enumerate(zip(mine, theirs)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                   err_msg=f"{what} leaf {i}", **tol)


def _assert_metrics(loss, metrics, jloss, jmetrics, what, tol=HEAD_TOL):
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               err_msg=what, **tol)
    assert sorted(metrics) == sorted(jmetrics), what
    for k in jmetrics:
        np.testing.assert_allclose(float(metrics[k].detach()),
                                   float(jmetrics[k]), err_msg=f"{what} {k}",
                                   **tol)


def _grads(loss, tree):
    leaves = tree_leaves(tree)
    got = torch.autograd.grad(loss, leaves, allow_unused=True)
    return [torch.zeros_like(t) if g is None else g
            for t, g in zip(leaves, got)]


def params_requiring(tree):
    from generative_models_tpu_torch.utils.tree import tree_map
    return tree_map(lambda t: t.detach().clone().requires_grad_(True), tree)


def check_head(monkeypatch, variant, seed):
    """Loss, metrics and every gradient leaf of `variant` on the conv
    stacks against the JAX head's."""
    jcfg, cfg = cfgs(variant)
    jspec, spec = jax_variant(variant), get_variant(variant)
    rng = np.random.default_rng(seed)
    b = jcfg.batch_size
    x = rng.random((b, 784), dtype=np.float32)
    y = rng.integers(0, jcfg.num_classes, b).astype(np.int32)
    jbatch = {"image": jnp.asarray(x), "label": jnp.asarray(y)}
    batch = {"image": torch.from_numpy(x), "label": torch.from_numpy(y)}
    key = jax.random.PRNGKey(seed)
    if not spec.adversarial:
        jp = jspec.init_params(jax.random.PRNGKey(1), jcfg)
        eps = np.array(jax.random.normal(key, (b, jcfg.latent_dim),
                                         jnp.float32))
        (jl, jm), jg = jax.value_and_grad(
            lambda p: jspec.loss(p, jbatch, key, jcfg), has_aux=True)(jp)
        p = params_requiring(port(jp))
        loss, m = spec.loss(p, batch, None, cfg, eps=torch.from_numpy(eps))
        _assert_metrics(loss, m, jl, jm, variant, VAE_TOL)
        _assert_grads(_grads(loss, p), jg, variant, VAE_TOL)
        return
    jg_p = jspec.init_g(jax.random.PRNGKey(1), jcfg)
    jd_p = jspec.init_d(jax.random.PRNGKey(2), jcfg)
    z = rng.standard_normal((b, jcfg.z_dim)).astype(np.float32)
    mod = _jmod(variant)
    if variant == "infogan":
        cat = rng.integers(0, jcfg.info_cat_dim, b).astype(np.int32)
        cont = rng.uniform(-1, 1, (b, jcfg.info_cont_dim)).astype(np.float32)
        monkeypatch.setattr(mod, "_sample_codes", lambda k, n, c: (
            jnp.asarray(z), jnp.asarray(cat),
            jax.nn.one_hot(jnp.asarray(cat), c.info_cat_dim),
            jnp.asarray(cont)))
        zt = code_rows(torch.from_numpy(z), torch.from_numpy(cat).long(),
                       torch.from_numpy(cont), cfg)
    else:
        monkeypatch.setattr(mod, "compute_noise",
                            lambda k, n, zd: jnp.asarray(z))
        zt = torch.from_numpy(z)
    lanes = penalty.aux_lanes(variant, 784)
    extra = {}
    if lanes:
        aux = rng.random((b, lanes), dtype=np.float32)
        ja = jnp.asarray(aux)
        if variant == "wgangp":
            monkeypatch.setattr(mod, "interpolate", lambda k, real, fake:
                                ja * real + (1.0 - ja) * fake)
        else:
            monkeypatch.setattr(mod, "perturb_real", lambda k, real, scale:
                                real + scale * jnp.std(real) * ja)
        extra["aux"] = torch.from_numpy(aux)
    jvs, vs = _vstates(spec, jspec, cfg, jcfg, variant)
    (jdl, jdm), jdg = jax.value_and_grad(
        lambda d: jspec.d_loss(d, jg_p, jbatch, key, jvs, jcfg),
        has_aux=True)(jd_p)
    (jgl, jgm), jgg = jax.value_and_grad(
        lambda g: jspec.g_loss(g, jd_p, jbatch, key, jvs, jcfg),
        has_aux=True)(jg_p)
    d = params_requiring(port(jd_p))
    g = port(jg_p)
    dl, dm = spec.d_loss(d, g, batch, None, vs, cfg, z=zt, **extra)
    _assert_metrics(dl, dm, jdl, jdm, f"{variant} d_loss")
    _assert_grads(_grads(dl, d), jdg, f"{variant} d grads")
    g = params_requiring(port(jg_p))
    gl, gm = spec.g_loss(g, port(jd_p), batch, None, vs, cfg, z=zt)
    _assert_metrics(gl, gm, jgl, jgm, f"{variant} g_loss")
    _assert_grads(_grads(gl, g), jgg, f"{variant} g grads")
    if lanes:
        assert float(dm["gp"]) > 0.0

VARIANTS = ("nsgan", "mmgan", "lsgan", "wgan", "fgan", "ragan", "fishergan")


@pytest.mark.parametrize("variant", VARIANTS)
def test_conv_head_matches_jax(monkeypatch, variant):
    check_head(monkeypatch, variant, seed=VARIANTS.index(variant) + 1)
