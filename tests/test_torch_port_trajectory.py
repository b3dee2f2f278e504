"""Same-input TRAJECTORY parity of the port's general train step against
the JAX package's, in the style of tests/test_trajectory_parity.py: the
same initial weights, the same fixed minibatch sequence and the same
per-step noise on both sides, 50 steps, and every step's losses must
agree — nsgan (alternating D and G updates) and vae (one model).

The JAX step draws its noise from its key chain; the test replays the
chain on the host (``train/step.py:158-159``, ``:234``) and either looks
each key up in a table of the numpy noise (nsgan, whose heads call
``compute_noise``) or draws ``jax.random.normal`` from the key itself and
hands it to the port (vae). Every step's losses agree to rtol 2e-3 /
atol 2e-4, the tolerance of tests/test_trajectory_parity.py for 50 steps
of accumulated float32 differences, the first five steps to rtol 1e-5,
and the final params to rtol 2e-3 / atol 2e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from generative_models_tpu.config import variant_config as jax_variant_config
from generative_models_tpu.losses import minimax as jminimax
from generative_models_tpu.losses.registry import get_variant as jax_variant
from generative_models_tpu.train import step as jstep
from generative_models_tpu.train.optim import make_tx
from generative_models_tpu_torch.config import variant_config
from generative_models_tpu_torch.losses.registry import get_variant
from generative_models_tpu_torch.train import step as step_lib
from generative_models_tpu_torch.utils.tree import (
    tree_leaves_with_path,
    tree_map,
)

B, ZD, H, XD, LD, STEPS = 32, 16, 48, 784, 8, 50
TOL = dict(rtol=2e-3, atol=2e-4)


def _layer(rng, i, o):
    b = 1 / np.sqrt(i)
    return {"w": rng.uniform(-b, b, size=(i, o)).astype(np.float32),
            "b": rng.uniform(-b, b, size=(o,)).astype(np.float32)}


def _to_torch(tree):
    return tree_map(lambda a: torch.from_numpy(a.copy()), tree)


def _assert_params(mine, theirs):
    theirs = dict(tree_leaves_with_path(jax.tree.map(np.asarray, theirs)))
    for path, t in tree_leaves_with_path(mine):
        np.testing.assert_allclose(t.numpy(), theirs[path], err_msg=path,
                                   **TOL)


def _assert_losses(p_hist, j_hist):
    assert set(p_hist[0]) == set(j_hist[0])
    for key in j_hist[0]:
        mine = [h[key] for h in p_hist]
        theirs = [h[key] for h in j_hist]
        np.testing.assert_allclose(mine, theirs, err_msg=key, **TOL)
        np.testing.assert_allclose(mine[:5], theirs[:5], err_msg=key,
                                   rtol=1e-5, atol=1e-6)


def test_nsgan_50_step_trajectory_matches_jax(monkeypatch):
    rng = np.random.default_rng(0)
    g_w = [_layer(rng, ZD, H), _layer(rng, H, XD)]
    d_w = [_layer(rng, XD, H), _layer(rng, H, 1)]
    xs = rng.random((STEPS, 1, B, XD), dtype=np.float32)
    z_d = rng.normal(size=(STEPS, 1, B, ZD)).astype(np.float32)
    z_g = rng.normal(size=(STEPS, B, ZD)).astype(np.float32)
    kw = dict(batch_size=B, z_dim=ZD, hidden_dim=H)

    jcfg, jspec = jax_variant_config("nsgan", **kw), jax_variant("nsgan")
    state = jstep.init_state(jspec, jcfg, jax.random.PRNGKey(0))
    keys, chain = [], state["rng"]
    for _ in range(STEPS):
        chain, d_key, g_key = jax.random.split(chain, 3)
        keys += list(jax.random.split(d_key, 1)) + [g_key]
    keys = jnp.stack(keys)
    table = jnp.asarray(np.concatenate(
        [np.concatenate([z_d[k], z_g[k][None]]) for k in range(STEPS)]))
    monkeypatch.setattr(
        jminimax, "compute_noise", lambda key, n, z_dim: table[jnp.argmax(
            jnp.all(keys == key[None], axis=1))])
    state["g_params"] = jax.tree.map(jnp.asarray, g_w)
    state["d_params"] = jax.tree.map(jnp.asarray, d_w)
    state["g_opt"] = make_tx(jcfg, jcfg.g_lr).init(state["g_params"])
    state["d_opt"] = make_tx(jcfg, jcfg.d_lr).init(state["d_params"])
    jax_train = jax.jit(jstep.build_step(jspec, jcfg))
    j_hist = []
    for k in range(STEPS):
        state, m = jax_train(state, {"image": jnp.asarray(xs[k]),
                                     "label": jnp.zeros((1, B), jnp.int32)})
        j_hist.append({n: float(v) for n, v in m.items()})

    cfg, spec = variant_config("nsgan", **kw), get_variant("nsgan")
    pst = step_lib.init_state(spec, cfg, torch.Generator().manual_seed(0))
    pst["g_params"], pst["d_params"] = _to_torch(g_w), _to_torch(d_w)
    train = step_lib.build_step(spec, cfg)
    p_hist = []
    for k in range(STEPS):
        pst, m = train(pst, {"image": torch.from_numpy(xs[k]),
                             "label": torch.zeros((1, B), dtype=torch.int32)},
                       torch.from_numpy(z_d[k]), torch.from_numpy(z_g[k]))
        p_hist.append({n: float(v) for n, v in m.items()})

    _assert_losses(p_hist, j_hist)
    for side in ("g_params", "d_params"):
        _assert_params(pst[side], state[side])
    assert pst["step"] == int(state["step"]) == STEPS


def test_vae_50_step_trajectory_matches_jax():
    rng = np.random.default_rng(1)
    w = {"encoder": {"trunk": [_layer(rng, XD, H)], "mu": _layer(rng, H, LD),
                     "logvar": _layer(rng, H, LD)},
         "decoder": [_layer(rng, LD, H), _layer(rng, H, XD)]}
    xs = rng.random((STEPS, 1, B, XD), dtype=np.float32)
    kw = dict(batch_size=B, vae_hidden_dim=H, latent_dim=LD)

    jcfg, jspec = jax_variant_config("vae", **kw), jax_variant("vae")
    state = jstep.init_state(jspec, jcfg, jax.random.PRNGKey(0))
    state["params"] = jax.tree.map(jnp.asarray, w)
    state["opt"] = make_tx(jcfg, jcfg.g_lr).init(state["params"])
    eps, chain = [], state["rng"]
    for _ in range(STEPS):
        chain, key = jax.random.split(chain)
        eps.append(np.array(jax.random.normal(key, (B, LD), jnp.float32)))
    jax_train = jax.jit(jstep.build_step(jspec, jcfg))
    j_hist = []
    for k in range(STEPS):
        state, m = jax_train(state, {"image": jnp.asarray(xs[k]),
                                     "label": jnp.zeros((1, B), jnp.int32)})
        j_hist.append({n: float(v) for n, v in m.items()})

    cfg, spec = variant_config("vae", **kw), get_variant("vae")
    pst = step_lib.init_state(spec, cfg, torch.Generator().manual_seed(0))
    pst["params"] = _to_torch(w)
    train = step_lib.build_step(spec, cfg)
    p_hist = []
    for k in range(STEPS):
        pst, m = train(pst, {"image": torch.from_numpy(xs[k]),
                             "label": torch.zeros((1, B), dtype=torch.int32)},
                       torch.from_numpy(eps[k]))
        p_hist.append({n: float(v) for n, v in m.items()})

    _assert_losses(p_hist, j_hist)
    _assert_params(pst["params"], state["params"])
    assert int(pst["opt"]["count"]) == int(state["opt"][0].count) == STEPS
