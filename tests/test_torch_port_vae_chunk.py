"""The port's VAE and BIR-VAE chunk training (kernels #6 and #7) against
the JAX package.

``build_fused_many_steps`` of the port — on the CPU the kernels' plain
versions ``vae_chunk_plain`` / ``birvae_chunk_plain``, which are also the
kernels' oracles on the card — runs the same 8 steps as the JAX
package's ``build_fused_many_steps(..., interpret=True)`` (the TPU chunk
kernels under the interpreter) from the same numpy weights, images and
permutations, across an epoch boundary. The JAX chunk function draws each
step's eps from the state's key chain (``pallas_train.py:1702-1718``);
the test replays that chain and hands the port the same stream. Params,
Adam slots and the metrics rows agree to rtol 2e-4 / atol 2e-5, the
tolerance of tests/test_fused_step.py; the BIR-VAE pins ``adam_eps=1e-3``
for the reason that file gives (its ``enc_mu`` bias gradient cancels to
rounding residue, which the default eps would let Adam normalise into
drift of order lr). The port's chunk function is held to its own general
step at the same tolerance, and under a small stream budget to itself.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generative_models_tpu.config import variant_config as jax_variant_config
from generative_models_tpu.losses.registry import get_variant as jax_variant
from generative_models_tpu.ops.pallas_train import (
    build_fused_many_steps as jax_fused_many_steps,
)
from generative_models_tpu.train import step as jstep
from generative_models_tpu.train.optim import make_tx
from generative_models_tpu_torch.config import variant_config
from generative_models_tpu_torch.losses.registry import get_variant
from generative_models_tpu_torch.ops import cuda_train, cuda_train_vae
from generative_models_tpu_torch.train import step as step_lib
from generative_models_tpu_torch.utils.tree import (
    tree_leaves_with_path,
    tree_map,
)

TOL = dict(rtol=2e-4, atol=2e-5)
STEPS, B, X, H, L = 8, 16, 784, 32, 8
N_ROWS = 4 * B
CASES = [("vae", "bce"), ("birvae", "mse"), ("birvae", "bce")]


def _kw(variant, recon):
    kw = dict(batch_size=B, vae_hidden_dim=H, latent_dim=L, vae_recon=recon)
    if variant == "birvae":
        kw["adam_eps"] = 1e-3
    return kw


def _layer(rng, i, o):
    bound = 1.0 / np.sqrt(i)
    return {"w": rng.uniform(-bound, bound, (i, o)).astype(np.float32),
            "b": rng.uniform(-bound, bound, (o,)).astype(np.float32)}


def _weights(rng, variant):
    dec = [_layer(rng, L, H), _layer(rng, H, X)]
    if variant == "vae":
        return {"encoder": {"trunk": [_layer(rng, X, H)],
                            "mu": _layer(rng, H, L),
                            "logvar": _layer(rng, H, L)}, "decoder": dec}
    return {"enc_trunk": [_layer(rng, X, H)], "enc_mu": _layer(rng, H, L),
            "decoder": dec}


def _setup(variant, recon, seed=3):
    """The port's state, data and noise, and what the JAX side needs."""
    rng = np.random.default_rng(seed)
    w = _weights(rng, variant)
    images = rng.random((N_ROWS, X), dtype=np.float32)
    labels = rng.integers(0, 10, N_ROWS).astype(np.int32)
    perm = np.stack([rng.permutation(N_ROWS) for _ in range(3)]).astype(
        np.int32)
    cfg = variant_config(variant, **_kw(variant, recon))
    spec = get_variant(variant)
    state = step_lib.init_state(spec, cfg, torch.Generator().manual_seed(0))
    state["params"] = tree_map(lambda a: torch.from_numpy(a.copy()), w)
    args = (torch.from_numpy(images), torch.from_numpy(labels),
            torch.from_numpy(perm).long(), torch.arange(STEPS) * B)
    return cfg, spec, state, args, (w, images, labels, perm)


def _stream(eps):
    return lambda k0, n: eps[k0:k0 + n]


def _assert_tree(mine, theirs):
    theirs = dict(tree_leaves_with_path(jax.tree.map(np.asarray, theirs)))
    for path, t in tree_leaves_with_path(mine):
        np.testing.assert_allclose(t.numpy(), theirs[path], err_msg=path,
                                   **TOL)


@pytest.mark.parametrize("variant,recon", CASES)
def test_chunk_plain_matches_the_tpu_chunk_kernel(variant, recon):
    cfg, spec, state, args, (w, images, labels, perm) = _setup(variant, recon)
    jcfg = jax_variant_config(variant, **_kw(variant, recon))
    jspec = jax_variant(variant)
    jstate = jstep.init_state(jspec, jcfg, jax.random.PRNGKey(7))
    jstate["params"] = jax.tree.map(jnp.asarray, w)
    jstate["opt"] = make_tx(jcfg, jcfg.g_lr).init(jstate["params"])
    # the eps stream the JAX chunk function draws: one key a step off the chain
    eps, chain = [], jstate["rng"]
    for _ in range(STEPS):
        chain, key = jax.random.split(chain)
        eps.append(np.array(jax.random.normal(key, (B, L))))
    eps = torch.from_numpy(np.stack(eps))

    many = jax_fused_many_steps(jspec, jcfg, N_ROWS // B, interpret=True)
    js, jm = many(jstate, jnp.asarray(images), jnp.asarray(labels),
                  jnp.asarray(perm), jnp.arange(STEPS, dtype=jnp.int32) * B)

    s, m = cuda_train.build_fused_many_steps(spec, cfg, N_ROWS // B)(
        state, *args, _stream(eps))
    assert cuda_train_vae.launches == cuda_train_vae.birvae_launches == 0
    assert sorted(m) == sorted(jm)
    for k in jm:
        np.testing.assert_allclose(m[k].numpy(), np.asarray(jm[k]),
                                   err_msg=k, **TOL)
    _assert_tree(s["params"], js["params"])
    jopt = js["opt"][0]
    assert int(s["opt"]["count"]) == int(jopt.count) == STEPS
    _assert_tree(s["opt"]["mu"], jopt.mu)
    _assert_tree(s["opt"]["nu"], jopt.nu)
    assert s["step"] == int(js["step"]) == STEPS
    np.testing.assert_array_equal(np.asarray(js["rng"]), np.asarray(chain))


@pytest.mark.parametrize("variant,recon", CASES)
def test_fused_many_steps_matches_general_step(variant, recon):
    cfg, spec, state, args, _ = _setup(variant, recon, seed=5)
    eps = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (STEPS, B, L)).astype(np.float32))
    s_gen, m_gen = step_lib.build_many_steps(spec, cfg, N_ROWS // B)(
        state, *args, _stream(eps))
    build = (cuda_train_vae.build_fused_vae_many_steps if variant == "vae"
               else cuda_train_vae.build_fused_birvae_many_steps)
    s_f, m_f = build(spec, cfg, N_ROWS // B)(state, *args, _stream(eps))
    assert set(m_f) == set(m_gen) == set(cuda_train_vae.METRIC_KEYS[variant])
    for k in m_gen:
        np.testing.assert_allclose(m_f[k].numpy(), m_gen[k].numpy(),
                                   err_msg=k, **TOL)
    for tree_f, tree_g in ((s_f["params"], s_gen["params"]),
                           (s_f["opt"]["mu"], s_gen["opt"]["mu"]),
                           (s_f["opt"]["nu"], s_gen["opt"]["nu"])):
        for (path, a), (_, b) in zip(tree_leaves_with_path(tree_f),
                                     tree_leaves_with_path(tree_g)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), err_msg=path,
                                       **TOL)
    assert int(s_f["opt"]["count"]) == int(s_gen["opt"]["count"]) == STEPS
    assert s_f["step"] == s_gen["step"] == STEPS
    # the caller's state is left as it was
    assert int(state["opt"]["count"]) == 0 and state["step"] == 0


def test_sub_chunks_cover_the_chunk(monkeypatch):
    cfg, spec, state, args, _ = _setup("vae", "bce", seed=8)
    eps = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (STEPS, B, L)).astype(np.float32))
    many = cuda_train.build_fused_many_steps(spec, cfg, N_ROWS // B)
    whole_state, whole = many(state, *args, _stream(eps))
    calls = []
    real = cuda_train_vae.vae_chunk
    monkeypatch.setattr(cuda_train_vae, "vae_chunk",
                        lambda *a, **k: calls.append((k["steps"], k["t"]))
                        or real(*a, **k))
    monkeypatch.setattr(step_lib, "STREAM_BYTES_BUDGET",
                        2 * step_lib.stream_bytes_per_step(cfg, spec))
    many = cuda_train.build_fused_many_steps(spec, cfg, N_ROWS // B)
    split_state, split = many(state, *args, _stream(eps))
    assert calls == [(2, 0), (2, 2), (2, 4), (2, 6)]
    for k in whole:
        np.testing.assert_array_equal(split[k].numpy(), whole[k].numpy())
    assert torch.equal(split_state["params"]["decoder"][1]["w"],
                       whole_state["params"]["decoder"][1]["w"])


def test_chunk_wrappers_check_their_inputs():
    cfg, spec, state, args, _ = _setup("vae", "bce")
    p, mu, nu = cuda_train_vae.state_planes(state)
    hp = cuda_train_vae.VaeHyper.from_config(cfg)
    xs, eps = torch.rand(2 * B, X), torch.randn(2 * B, L)
    kw = dict(steps=2, batch=B, t=0, hp=hp)
    with pytest.raises(ValueError, match="10 parameter"):
        cuda_train_vae.vae_chunk(xs, eps, p[:8], mu[:8], nu[:8], **kw)
    with pytest.raises(ValueError, match="8 parameter"):
        cuda_train_vae.birvae_chunk(xs, eps, p, mu, nu, **kw)
    with pytest.raises(ValueError, match="eps_n must be"):
        cuda_train_vae.vae_chunk(xs, eps[:B], p, mu, nu, **kw)
    with pytest.raises(TypeError, match="float32"):
        cuda_train_vae.vae_chunk(xs.double(), eps, p, mu, nu, **kw)
    with pytest.raises(ValueError, match="bce"):
        cuda_train_vae.vae_chunk(
            xs, eps, p, mu, nu, steps=2, batch=B, t=0,
            hp=cuda_train_vae.VaeHyper(2e-4, 0.5, 0.999, 1e-8, "mse"))
    m = cuda_train_vae.vae_chunk(xs, eps, [t.clone() for t in p], mu, nu,
                                 **kw)
    assert m.shape == (2, 3) and bool(torch.isfinite(m).all())
    np.testing.assert_allclose(float(m[0, 0]), float(m[0, 1] + m[0, 2]),
                               rtol=1e-6)


@pytest.mark.parametrize("overrides,supported", [
    ({"variant": "vae"}, True),
    ({"variant": "birvae"}, True),
    ({"variant": "birvae", "vae_recon": "bce"}, True),
    ({"variant": "vae", "g_hidden_act": "tanh"}, True),
    ({"variant": "vae", "vae_recon": "mse"}, False),
    ({"variant": "vae", "optimizer": "rmsprop"}, False),
    ({"variant": "birvae", "optimizer": "rmsprop"}, False),
    ({"variant": "vae", "ema_decay": 0.5}, True),
    ({"variant": "birvae", "dtype": "bfloat16"}, True),
])
def test_fused_step_supported_for_the_vae_family(overrides, supported):
    """The same verdicts as the reference's ``fused_step_supported``
    (``pallas_train.py:1405-1412``), the EMA plane and bf16 included."""
    from generative_models_tpu.ops.pallas_train import (
        fused_step_supported as jax_supported,
    )
    overrides = dict(overrides)
    variant = overrides.pop("variant")
    cfg = variant_config(variant, **overrides)
    ok, reason = cuda_train.fused_step_supported(get_variant(variant), cfg)
    assert ok == supported
    if "ema_decay" in overrides or "dtype" in overrides:
        assert reason == ""
    jok, _ = jax_supported(jax_variant(variant),
                           jax_variant_config(variant, **overrides))
    assert jok == supported
    assert cuda_train.resolve_fused_step(None, cfg, "cuda") == supported
    assert not cuda_train.resolve_fused_step(None, cfg, "cpu")
