"""Five general train steps of nsgan, wgangp, lsgan and vae on the conv
stacks, the port's ``train/step.py::build_step`` against the JAX
package's ``jax.jit(build_step)``: the same initial weights (the JAX
init's, carried with ``params_from_numpy``), batches and per-step noise
(the JAX step's key chain replayed on the host and each key looked up in
a table of the numpy noise, as ``tests/test_torch_port_gp.py`` does;
the VAE's eps drawn from the keys themselves, as
``tests/test_torch_port_vae.py`` does).

- nsgan: alternating D and G updates through the conv critic and G.
- wgangp: its registry defaults (Adam 1e-4, betas 0.5/0.9, d_steps 5);
  every critic update differentiates the penalty through the conv
  critic twice.
- lsgan: the conv override turns the amortized spectral projection on
  (``sn_target`` 1.0): the carried vectors ``sn_v`` of the HWIO kernels
  (read as ``[kh kw cin, cout]``) start where JAX's start and end where
  JAX's end.
- vae: one model, the conv encoder and decoder.

Every step's losses and metrics, the final params, the Adam slots (and
``sn_v``) agree to rtol 2e-4 / atol 2e-5, the tolerance of the port's
other short general-step tests (``tests/test_torch_port_gp.py``): five
Adam steps turn float32 differences in near-zero gradients into steps
of a visible part of lr.

The stacks run at ``conv_channels`` 12: G's second GroupNorm then takes
6 groups of 2 channels (the fallback) and its first 8 groups of 3. At 4
channels every group holds one channel, so the bias of the conv before
it has a gradient of exactly zero, and Adam normalises the two
packages' different rounding residues of that zero into steps of order
lr (4e-5 to 1.2e-3 apart after five steps, seen).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generative_models_tpu.losses.registry import get_variant as jax_variant
from generative_models_tpu.train import step as jstep
from generative_models_tpu_torch.config import variant_config
from generative_models_tpu_torch.losses.registry import get_variant
from generative_models_tpu_torch.ops import penalty
from generative_models_tpu_torch.ops.spectral import init_sn_vectors
from generative_models_tpu_torch.train import step as step_lib
from generative_models_tpu_torch.utils.checkpoint import params_from_numpy
from generative_models_tpu_torch.utils.tree import (
    tree_leaves,
    tree_leaves_with_path,
)
from tests.conftest import TINY, tiny_cfg

STEPS = 5
TOL = dict(rtol=2e-4, atol=2e-5)
CONV_TINY = dict(arch="conv", conv_channels=12, latent_dim=4)


def _port(tree):
    return params_from_numpy(jax.tree.map(lambda a: np.array(a), tree))


def _assert_tree(mine, theirs, what):
    theirs = dict(tree_leaves_with_path(jax.tree.map(np.asarray, theirs)))
    got = tree_leaves_with_path(mine)
    assert sorted(p for p, _ in got) == sorted(theirs), what
    for path, t in got:
        np.testing.assert_allclose(t.numpy(), theirs[path],
                                   err_msg=f"{what}{path}", **TOL)


def _assert_hist(p_hist, j_hist):
    assert set(p_hist[0]) == set(j_hist[0])
    for key in j_hist[0]:
        np.testing.assert_allclose([h[key] for h in p_hist],
                                   [h[key] for h in j_hist], err_msg=key,
                                   **TOL)


def _jmod(variant):
    name = "minimax" if variant == "nsgan" else variant
    return importlib.import_module(f"generative_models_tpu.losses.{name}")


@pytest.mark.parametrize("variant", ["nsgan", "wgangp", "lsgan"])
def test_adversarial_conv_steps_match_jax(monkeypatch, variant):
    jcfg = tiny_cfg(variant, **CONV_TINY)
    cfg = variant_config(variant, **dict(TINY, **CONV_TINY))
    jspec, spec = jax_variant(variant), get_variant(variant)
    ds, b, zd = jcfg.d_steps, jcfg.batch_size, jcfg.z_dim
    lanes = penalty.aux_lanes(variant, 784)
    assert cfg.spectral_projection == (variant == "lsgan")
    rng = np.random.default_rng(7)
    xs = rng.random((STEPS, ds, b, 784), dtype=np.float32)
    z_d = rng.standard_normal((STEPS, ds, b, zd)).astype(np.float32)
    z_g = rng.standard_normal((STEPS, b, zd)).astype(np.float32)
    aux = rng.random((STEPS, ds, b, max(lanes, 1)), dtype=np.float32)

    state = jstep.init_state(jspec, jcfg, jax.random.PRNGKey(0))
    z_keys, z_rows, aux_keys, aux_rows = [], [], [], []
    chain = state["rng"]
    for k in range(STEPS):
        chain, d_key, g_key = jax.random.split(chain, 3)
        for i, dk in enumerate(jax.random.split(d_key, ds)):
            if lanes:
                dk, ak = jax.random.split(dk)
                aux_keys.append(ak)
                aux_rows.append(aux[k, i])
            z_keys.append(dk)
            z_rows.append(z_d[k, i])
        z_keys.append(g_key)
        z_rows.append(z_g[k])

    def lookup(keys, rows):
        keys, rows = jnp.stack(keys), jnp.asarray(np.stack(rows))
        return lambda key: rows[jnp.argmax(jnp.all(keys == key[None],
                                                   axis=1))]
    mod = _jmod(variant)
    z_of = lookup(z_keys, z_rows)
    monkeypatch.setattr(mod, "compute_noise", lambda key, n, z: z_of(key))
    if lanes:
        aux_of = lookup(aux_keys, aux_rows)
        monkeypatch.setattr(mod, "interpolate", lambda key, real, fake:
                            aux_of(key) * real + (1.0 - aux_of(key)) * fake)

    pst = step_lib.init_state(spec, cfg, torch.Generator().manual_seed(0))
    pst["g_params"] = _port(state["g_params"])
    pst["d_params"] = _port(state["d_params"])
    if variant == "lsgan":  # the port's burn-in at the same weights
        pst["sn_v"] = init_sn_vectors(pst["d_params"], cfg.sn_iters)
        _assert_tree(pst["sn_v"], state["sn_v"], "sn_v at init")
    jax_train = jax.jit(jstep.build_step(jspec, jcfg))
    train = step_lib.build_step(spec, cfg)
    j_hist, p_hist = [], []
    for k in range(STEPS):
        state, m = jax_train(state, {"image": jnp.asarray(xs[k]),
                                     "label": jnp.zeros((ds, b), jnp.int32)})
        j_hist.append({n: float(v) for n, v in m.items()})
        extra = [torch.from_numpy(aux[k])] if lanes else []
        pst, m = train(pst, {"image": torch.from_numpy(xs[k]),
                             "label": torch.zeros((ds, b), dtype=torch.int32)},
                       torch.from_numpy(z_d[k]), torch.from_numpy(z_g[k]),
                       *extra)
        p_hist.append({n: float(v) for n, v in m.items()})

    _assert_hist(p_hist, j_hist)
    assert pst["step"] == int(state["step"]) == STEPS
    for side in ("g_params", "d_params"):
        _assert_tree(pst[side], state[side], side)
    for side in ("g_opt", "d_opt"):
        jopt = state[side][0]
        assert int(pst[side]["count"]) == int(jopt.count)
        _assert_tree(pst[side]["mu"], jopt.mu, f"{side}.mu")
        _assert_tree(pst[side]["nu"], jopt.nu, f"{side}.nu")
    if variant == "lsgan":
        _assert_tree(pst["sn_v"], state["sn_v"], "sn_v")
    # the conv trees: HWIO kernels, GroupNorm leaves, the dense layers
    assert tuple(pst["g_params"]["up1"]["w"].shape) == (4, 4, 24, 12)
    assert sorted(pst["d_params"]) == ["fc", "trunk"]


def test_vae_conv_steps_match_jax():
    jcfg = tiny_cfg("vae", **CONV_TINY)
    cfg = variant_config("vae", **dict(TINY, **CONV_TINY))
    jspec, spec = jax_variant("vae"), get_variant("vae")
    b, lat = jcfg.batch_size, jcfg.latent_dim
    rng = np.random.default_rng(8)
    xs = rng.random((STEPS, 1, b, 784), dtype=np.float32)
    state = jstep.init_state(jspec, jcfg, jax.random.PRNGKey(0))
    eps, chain = [], state["rng"]
    for _ in range(STEPS):
        chain, key = jax.random.split(chain)
        eps.append(np.array(jax.random.normal(key, (b, lat), jnp.float32)))
    pst = step_lib.init_state(spec, cfg, torch.Generator().manual_seed(0))
    pst["params"] = _port(state["params"])
    jax_train = jax.jit(jstep.build_step(jspec, jcfg))
    train = step_lib.build_step(spec, cfg)
    j_hist, p_hist = [], []
    for k in range(STEPS):
        state, m = jax_train(state, {"image": jnp.asarray(xs[k]),
                                     "label": jnp.zeros((1, b), jnp.int32)})
        j_hist.append({n: float(v) for n, v in m.items()})
        pst, m = train(pst, {"image": torch.from_numpy(xs[k]),
                             "label": torch.zeros((1, b), dtype=torch.int32)},
                       torch.from_numpy(eps[k]))
        p_hist.append({n: float(v) for n, v in m.items()})
    _assert_hist(p_hist, j_hist)
    _assert_tree(pst["params"], state["params"], "params")
    jopt = state["opt"][0]
    assert int(pst["opt"]["count"]) == int(jopt.count) == STEPS
    _assert_tree(pst["opt"]["mu"], jopt.mu, "opt.mu")
    _assert_tree(pst["opt"]["nu"], jopt.nu, "opt.nu")
    assert len(tree_leaves(pst["params"])) == 20
