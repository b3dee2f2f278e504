"""The port's VAE family against the JAX package: encoder and decoder,
the VAE and BIR-VAE losses with every gradient, and 20 steps of the
single-model train step.

Both sides get the same numpy weights and batches (image 784, hidden 32,
latent 8, batch 16). The JAX losses draw eps inside from their key
(``ops/reparam.py:19``, ``losses/birvae.py:56``), so the test draws
``jax.random.normal(key, shape)`` itself and hands it to the port as
``eps=``; for the step it replays the step's key chain
(``train/step.py:234``). Networks agree to rtol 1e-5 / atol 1e-5; losses,
metrics, gradients, and 20 steps of params, Adam slots and EMA to rtol
2e-4 / atol 2e-5 (sums of up to 784 float32 products in another order,
through Adam's division by sqrt(v)). The BIR-VAE steps pin
``adam_eps=1e-3``: its ``enc_mu`` bias gradient is zero in exact
arithmetic (the batch normalisation removes a uniform shift), and at the
default eps Adam normalises the rounding residue of that cancellation
into drift of order lr on both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generative_models_tpu.config import variant_config as jax_variant_config
from generative_models_tpu.losses.registry import get_variant as jax_variant
from generative_models_tpu.models import nets as jnets
from generative_models_tpu.train import step as jstep
from generative_models_tpu.train.optim import make_tx
from generative_models_tpu_torch.config import variant_config
from generative_models_tpu_torch.losses import birvae, vae
from generative_models_tpu_torch.losses.common import global_moments_axis0
from generative_models_tpu_torch.losses.registry import get_variant
from generative_models_tpu_torch.models import nets
from generative_models_tpu_torch.train import step as step_lib
from generative_models_tpu_torch.utils.tree import (
    tree_leaves_with_path,
    tree_map,
)

TOL = dict(rtol=2e-4, atol=2e-5)
NET_TOL = dict(rtol=1e-5, atol=1e-5)
B, X, H, L = 16, 784, 32, 8
KW = dict(batch_size=B, vae_hidden_dim=H, latent_dim=L)


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


def _to_torch(tree):
    return tree_map(lambda a: torch.from_numpy(a.copy()), tree)


def _to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _assert_trees(mine, theirs, zero=(), **tol):
    """Leaf by leaf; a path in `zero` is zero in exact arithmetic and is
    held to |g| <= 1e-4 on both sides instead (rounding residue)."""
    theirs = dict(tree_leaves_with_path(jax.tree.map(np.asarray, theirs)))
    mine = tree_leaves_with_path(mine)
    assert [p for p, _ in mine] == list(theirs)
    for path, t in mine:
        if path in zero:
            assert float(t.abs().max()) <= 1e-4, path
            assert float(np.abs(theirs[path]).max()) <= 1e-4, path
            continue
        np.testing.assert_allclose(t.detach().numpy(), theirs[path],
                                   err_msg=path, **tol)


def test_encoder_and_decoder_match_jax():
    rng = np.random.default_rng(0)
    w = _weights(rng, "vae")
    x = rng.random((B, X), dtype=np.float32)
    z = rng.standard_normal((B, L)).astype(np.float32)
    cfg, jcfg = variant_config("vae", **KW), jax_variant_config("vae", **KW)
    tw, jw = _to_torch(w), _to_jax(w)
    mu, lv = nets.encoder_apply(tw["encoder"], torch.from_numpy(x), cfg)
    jmu, jlv = jnets.encoder_apply(jw["encoder"], jnp.asarray(x), jcfg)
    np.testing.assert_allclose(mu.numpy(), np.asarray(jmu), **NET_TOL)
    np.testing.assert_allclose(lv.numpy(), np.asarray(jlv), **NET_TOL)
    for logits in (False, True):
        out = nets.decoder_apply(tw["decoder"], torch.from_numpy(z), cfg,
                                 logits=logits)
        jout = jnets.decoder_apply(jw["decoder"], jnp.asarray(z), jcfg,
                                   logits=logits)
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), **NET_TOL)
    assert float(out.min()) < 0.0          # logits, not probabilities


@pytest.mark.parametrize("variant", ["vae", "birvae"])
def test_init_params_have_the_jax_tree(variant):
    cfg = variant_config(variant, **KW)
    spec = get_variant(variant)
    p = spec.init_params(torch.Generator().manual_seed(0), cfg)
    jp = jax_variant(variant).init_params(
        jax.random.PRNGKey(0), jax_variant_config(variant, **KW))
    mine = [(path, tuple(t.shape)) for path, t in tree_leaves_with_path(p)]
    theirs = [(jax.tree_util.keystr(path), tuple(a.shape))
              for path, a in jax.tree_util.tree_leaves_with_path(jp)]
    assert mine == theirs
    # torch.nn.Linear's default bounds, as the reference's init
    w = p["decoder"][1]["w"]
    assert float(w.abs().max()) <= 1.0 / np.sqrt(H)
    again = spec.init_params(torch.Generator().manual_seed(0), cfg)
    assert torch.equal(again["decoder"][0]["b"], p["decoder"][0]["b"])
    assert not spec.adversarial
    assert spec.batch_coupled == (variant == "birvae")


@pytest.mark.parametrize("variant,recon", [("vae", "bce"), ("vae", "mse"),
                                           ("birvae", "mse"),
                                           ("birvae", "bce")])
def test_loss_metrics_and_gradients_match_jax(variant, recon):
    rng = np.random.default_rng(1)
    w = _weights(rng, variant)
    x = rng.random((B, X), dtype=np.float32)
    kw = dict(KW, vae_recon=recon)
    cfg, jcfg = variant_config(variant, **kw), jax_variant_config(variant, **kw)
    key = jax.random.PRNGKey(5)
    eps = np.array(jax.random.normal(key, (B, L), jnp.float32))

    jloss = jax_variant(variant).loss
    (jtotal, jm), jg = jax.value_and_grad(jloss, has_aux=True)(
        _to_jax(w), {"image": jnp.asarray(x)}, key, jcfg)

    tw = tree_map(lambda t: t.requires_grad_(True), _to_torch(w))
    total, m = get_variant(variant).loss(
        tw, {"image": torch.from_numpy(x)}, None, cfg,
        eps=torch.from_numpy(eps))
    total.backward()
    np.testing.assert_allclose(float(total.detach()), float(jtotal), **TOL)
    assert sorted(m) == sorted(jm)
    for k in jm:
        np.testing.assert_allclose(float(m[k]), float(jm[k]), err_msg=k,
                                   **TOL)
    # the BIR-VAE's normalisation removes a uniform latent shift: the mean
    # head's bias gradient is a sum that cancels to rounding residue
    zero = ("['enc_mu']['b']",) if variant == "birvae" else ()
    _assert_trees(tree_map(lambda t: t.grad, tw), jg, zero=zero, **TOL)


def test_birvae_pieces_match_jax():
    from generative_models_tpu.losses import birvae as jbirvae
    from generative_models_tpu.losses.common import (
        global_moments_axis0 as jax_moments,
    )
    cfg = variant_config("birvae", **KW)
    jcfg = jax_variant_config("birvae", **KW)
    assert birvae.noise_sigma(cfg) == jbirvae.noise_sigma(jcfg)
    assert cfg.birvae_bits == 12.0 and cfg.vae_recon == "mse"
    rng = np.random.default_rng(2)
    a = rng.standard_normal((B, L)).astype(np.float32)
    a[:, 0] = 3.0                                   # a constant column
    for eps in (0.0, 1e-3):
        m, v = global_moments_axis0(torch.from_numpy(a), eps=eps)
        jm, jv = jax_moments(jnp.asarray(a), eps=eps)
        np.testing.assert_allclose(m.numpy(), np.asarray(jm), **NET_TOL)
        np.testing.assert_allclose(v.numpy(), np.asarray(jv), **NET_TOL)
        assert float(v.min()) >= eps
    with pytest.raises(TypeError, match="DataGroup"):
        global_moments_axis0(torch.from_numpy(a), group="dp")
    w = _weights(rng, "birvae")
    x = rng.random((B, X), dtype=np.float32)
    np.testing.assert_allclose(
        birvae.encode(_to_torch(w), torch.from_numpy(x), cfg).numpy(),
        np.asarray(jbirvae.encode(_to_jax(w), jnp.asarray(x), jcfg)),
        **NET_TOL)


def test_sample_and_reconstruct_match_jax():
    from generative_models_tpu.losses import vae as jvae
    rng = np.random.default_rng(3)
    w = _weights(rng, "vae")
    cfg, jcfg = variant_config("vae", **KW), jax_variant_config("vae", **KW)
    key = jax.random.PRNGKey(9)
    z = np.array(jax.random.normal(key, (5, L)))
    out = vae.sample(_to_torch(w), None, 5, cfg, z=torch.from_numpy(z))
    np.testing.assert_allclose(
        out.numpy(), np.asarray(jvae.sample(_to_jax(w), key, 5, jcfg)),
        **NET_TOL)
    x = rng.random((B, X), dtype=np.float32)
    eps = np.array(jax.random.normal(key, (B, L), jnp.float32))
    rec = vae.reconstruct(_to_torch(w), torch.from_numpy(x), None, cfg,
                          eps=torch.from_numpy(eps))
    np.testing.assert_allclose(
        rec.numpy(),
        np.asarray(jvae.reconstruct(_to_jax(w), jnp.asarray(x), key, jcfg)),
        **NET_TOL)
    # without eps the noise comes from the generator, through the kernel's
    # plain version on the CPU
    gen = torch.Generator().manual_seed(0)
    r1 = vae.reconstruct(_to_torch(w), torch.from_numpy(x), gen, cfg)
    r2 = vae.sample(_to_torch(w), gen, 7, cfg)
    assert r1.shape == (B, X) and r2.shape == (7, X)
    assert 0.0 <= float(r1.min()) and float(r1.max()) <= 1.0


@pytest.mark.parametrize("variant,recon,ema", [
    ("vae", "bce", 0.0), ("vae", "bce", 0.9), ("vae", "mse", 0.0),
    ("birvae", "mse", 0.0), ("birvae", "bce", 0.9)])
def test_single_step_matches_jax(variant, recon, ema):
    steps = 20
    kw = dict(KW, vae_recon=recon, ema_decay=ema)
    if variant == "birvae":
        kw["adam_eps"] = 1e-3
    rng = np.random.default_rng(4)
    w = _weights(rng, variant)
    xs = rng.random((steps, 1, B, X), dtype=np.float32)

    jcfg = jax_variant_config(variant, **kw)
    jspec = jax_variant(variant)
    state = jstep.init_state(jspec, jcfg, jax.random.PRNGKey(0))
    state["params"] = _to_jax(w)
    state["opt"] = make_tx(jcfg, jcfg.g_lr).init(state["params"])
    if ema:
        state["ema"] = state["params"]
    # the keys the step will draw eps from, in order
    eps, chain = [], state["rng"]
    for _ in range(steps):
        chain, key = jax.random.split(chain)
        eps.append(np.array(jax.random.normal(key, (B, L), jnp.float32)))
    jax_train = jax.jit(jstep.build_step(jspec, jcfg))
    j_hist = []
    for k in range(steps):
        state, m = jax_train(state, {"image": jnp.asarray(xs[k]),
                                     "label": jnp.zeros((1, B), jnp.int32)})
        j_hist.append({n: float(v) for n, v in m.items()})

    cfg = variant_config(variant, **kw)
    spec = get_variant(variant)
    pst = step_lib.init_state(spec, cfg, torch.Generator().manual_seed(0))
    pst["params"] = _to_torch(w)
    if ema:
        pst["ema"] = _to_torch(w)
    train = step_lib.build_step(spec, cfg)
    p_hist = []
    for k in range(steps):
        pst, m = train(pst, {"image": torch.from_numpy(xs[k]),
                             "label": torch.zeros((1, B), dtype=torch.int32)},
                       torch.from_numpy(eps[k]))
        p_hist.append({n: float(v) for n, v in m.items()})

    assert pst["step"] == int(state["step"]) == steps
    assert set(p_hist[0]) == set(j_hist[0])
    for key in j_hist[0]:
        np.testing.assert_allclose([h[key] for h in p_hist],
                                   [h[key] for h in j_hist], err_msg=key,
                                   **TOL)
    _assert_trees(pst["params"], state["params"], **TOL)
    if ema:
        _assert_trees(pst["ema"], state["ema"], **TOL)
    jopt = state["opt"][0]
    assert int(pst["opt"]["count"]) == int(jopt.count) == steps
    _assert_trees(pst["opt"]["mu"], jopt.mu, **TOL)
    _assert_trees(pst["opt"]["nu"], jopt.nu, **TOL)


def test_single_state_layout_and_generator_noise():
    cfg = variant_config("vae", ema_decay=0.5, **KW)
    spec = get_variant("vae")
    st = step_lib.init_state(spec, cfg, torch.Generator().manual_seed(0))
    assert sorted(st) == ["ema", "opt", "params", "rng", "step"]
    assert st["rng"].dtype == np.uint32 and st["rng"].shape == (2,)
    assert int(st["opt"]["count"]) == 0 and st["step"] == 0
    assert st["ema"]["decoder"][1]["w"] is st["params"]["decoder"][1]["w"]
    assert step_lib.batches_per_step(spec, cfg) == 1
    assert step_lib.stream_bytes_per_step(cfg, spec) == 4 * B * (X + L)
    # a generator in place of eps: the loss draws its own noise
    rng = np.random.default_rng(5)
    batches = {"image": torch.from_numpy(rng.random((1, B, X), np.float32)),
               "label": torch.zeros((1, B), dtype=torch.int32)}
    train = step_lib.build_step(spec, cfg)
    a, ma = train(st, batches, torch.Generator().manual_seed(3))
    b, mb = train(st, batches, torch.Generator().manual_seed(3))
    c, mc = train(st, batches, torch.Generator().manual_seed(4))
    assert float(ma["loss"]) == float(mb["loss"]) != float(mc["loss"])
    assert a["step"] == 1 and int(a["opt"]["count"]) == 1
    assert not torch.equal(a["ema"]["decoder"][0]["w"],
                           a["params"]["decoder"][0]["w"])
