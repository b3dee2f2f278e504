"""The port's lsgan, wgan, fgan, ragan and fishergan heads and their
general train step against the JAX package's.

Heads: the same numpy weights, batch and noise go through
``generative_models_tpu.losses.<v>`` (``jax.value_and_grad``; its
``compute_noise`` patched to return the numpy noise) and the port's head
(torch autograd, ``z=``): the loss, every metric and every gradient leaf
of the critic and of the generator agree to rtol 2e-5 / atol 1e-6 (one
float32 forward and backward at hidden 32: a few ulps of sums of up to
48 terms). fgan runs all 7 divergences x both G losses, with weights at
the init scale (kl and pearson grow as exp(v)); fishergan runs at a
non-zero multiplier and its ``d_state_update`` is compared; wgan's
``d_post`` clips every critic tensor, biases too.

General step: 20 steps of ``build_adversarial_step`` on both sides from
the same weights, batches and noise (the JAX step's key chain replayed
on the host and looked up in a table, as tests/test_torch_port_step.py
does). wgan runs at its registry defaults (RMSprop, d_steps 5, clip
0.01); fishergan's multiplier is followed step by step through
``vstate_lam``. Losses, params and optimizer slots agree to rtol 2e-4 /
atol 2e-5, the tolerance of tests/test_torch_port_step.py. ragan and
fishergan run at ``adam_eps = 1e-3``: the bias gradient of their
critic's head cancels exactly in mathematics, and at the default eps
Adam turns each side's rounding residue into steps of order lr
(tests/test_fused_step.py:58-67).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generative_models_tpu.config import variant_config as jax_variant_config
from generative_models_tpu.losses.registry import get_variant as jax_variant
from generative_models_tpu.train import step as jstep
from generative_models_tpu.train.optim import make_tx
from generative_models_tpu_torch.config import FGAN_DIVERGENCES, variant_config
from generative_models_tpu_torch.losses import fgan as pfgan
from generative_models_tpu_torch.losses.registry import (
    available_variants,
    get_variant,
)
from generative_models_tpu_torch.train import step as step_lib

HEAD_TOL = dict(rtol=2e-5, atol=1e-6)
TOL = dict(rtol=2e-4, atol=2e-5)
B, Z, H, X = 8, 8, 32, 48
FIVE = ("lsgan", "wgan", "fgan", "ragan", "fishergan")


def _weights(rng, z=Z, h=H, x=X):
    out = []
    for dims in ((z, h, x), (x, h, 1)):
        layers = []
        for i, o in zip(dims[:-1], dims[1:]):
            bound = 1.0 / np.sqrt(i)
            layers.append({
                "w": rng.uniform(-bound, bound, (i, o)).astype(np.float32),
                "b": rng.uniform(-bound, bound, (o,)).astype(np.float32)})
        out.append(layers)
    return out


def _to_t(layers):
    return [{k: torch.from_numpy(v.copy()) for k, v in l.items()}
            for l in layers]


def _jmod(variant):
    return importlib.import_module(f"generative_models_tpu.losses.{variant}")


HEAD_CASES = [("lsgan", {}), ("wgan", {}), ("ragan", {}), ("fishergan", {})]
HEAD_CASES += [("fgan", {"fgan_divergence": d, "fgan_g_loss": g})
               for d in FGAN_DIVERGENCES
               for g in ("saturating", "nonsaturating")]


@pytest.mark.parametrize(
    "variant,kw", HEAD_CASES,
    ids=[v + "".join(f"-{x}" for x in kw.values()) for v, kw in HEAD_CASES])
def test_head_matches_jax(monkeypatch, variant, kw):
    kw = dict(kw, batch_size=B, z_dim=Z, hidden_dim=H, image_dim=X,
              fisher_rho=0.05)
    rng = np.random.default_rng(21)
    g_w, d_w = _weights(rng)
    x = rng.random((B, X), dtype=np.float32)
    z = rng.standard_normal((B, Z)).astype(np.float32)
    lam = 0.3

    jcfg, jspec = jax_variant_config(variant, **kw), jax_variant(variant)
    monkeypatch.setattr(_jmod(variant), "compute_noise",
                        lambda key, n, z_dim: jnp.asarray(z))
    jg, jd = jax.tree.map(jnp.asarray, g_w), jax.tree.map(jnp.asarray, d_w)
    jvs = {"lam": jnp.float32(lam)} if variant == "fishergan" else {}
    jbatch = {"image": jnp.asarray(x)}
    key = jax.random.PRNGKey(0)
    (jdl, jdm), jdg = jax.value_and_grad(
        lambda dp: jspec.d_loss(dp, jg, jbatch, key, jvs, jcfg),
        has_aux=True)(jd)
    (jgl, jgm), jgg = jax.value_and_grad(
        lambda gp: jspec.g_loss(gp, jd, jbatch, key, jvs, jcfg),
        has_aux=True)(jg)

    cfg, spec = variant_config(variant, **kw), get_variant(variant)
    assert spec.batch_coupled == jspec.batch_coupled
    vs = {"lam": torch.tensor(lam)} if variant == "fishergan" else {}
    batch = {"image": torch.from_numpy(x)}
    zt = torch.from_numpy(z)

    def grads(loss_fn, mine, other):
        leaves = [t.requires_grad_(True) for l in mine for t in
                  (l["w"], l["b"])]
        loss, metrics = loss_fn(mine, other, batch, None, vs, cfg, z=zt)
        return loss, metrics, torch.autograd.grad(loss, leaves)

    dl, dm, dg = grads(spec.d_loss, _to_t(d_w), _to_t(g_w))
    gl, gm, gg = grads(spec.g_loss, _to_t(g_w), _to_t(d_w))

    for mine, theirs in ((dl, jdl), (gl, jgl)):
        np.testing.assert_allclose(float(mine.detach()), float(theirs),
                                   **HEAD_TOL)
    for mine, theirs in ((dm, jdm), (gm, jgm)):
        assert set(mine) == set(theirs)
        for k in theirs:
            np.testing.assert_allclose(float(mine[k].detach()), float(theirs[k]),
                                       err_msg=k, **HEAD_TOL)
    for mine, theirs in ((dg, jdg), (gg, jgg)):
        flat = [np.asarray(l[k]) for l in theirs for k in ("w", "b")]
        assert len(mine) == len(flat)
        for a, b in zip(mine, flat):
            np.testing.assert_allclose(a.numpy(), b, **HEAD_TOL)

    # the hooks around the losses
    np.testing.assert_equal(spec.init_vstate(cfg).keys(),
                            jspec.init_vstate(jcfg).keys())
    if variant == "fishergan":
        new = spec.d_state_update(vs, {k: v.detach() for k, v in dm.items()},
                                  cfg)
        jnew = jspec.d_state_update(jvs, jdm, jcfg)
        assert new["lam"].shape == () and new["lam"].dtype == torch.float32
        assert abs(float(new["lam"]) - lam) > 1e-3
        np.testing.assert_allclose(float(new["lam"]), float(jnew["lam"]),
                                   **HEAD_TOL)
    if variant == "wgan":
        big = [{k: 10.0 * v for k, v in l.items()} for l in d_w]
        clipped = spec.d_post(_to_t(big), cfg)
        jclipped = jspec.d_post(jax.tree.map(jnp.asarray, big), jcfg)
        for a, b in zip(clipped, jclipped):
            for k in ("w", "b"):
                assert float(a[k].abs().max()) == np.float32(cfg.wgan_clip)
                np.testing.assert_array_equal(a[k].numpy(), np.asarray(b[k]))
    else:
        p = _to_t(d_w)
        assert spec.d_post(p, cfg) is p


def test_registry_and_divergences_are_the_reference_s():
    from generative_models_tpu.losses.fgan import DIVERGENCES
    assert set(FIVE) <= set(available_variants())
    assert sorted(pfgan.DIVERGENCES) == sorted(DIVERGENCES) == sorted(
        FGAN_DIVERGENCES)
    with pytest.raises(ValueError, match="unknown f-divergence"):
        pfgan.get_divergence("chi")
    with pytest.raises(ValueError, match="unknown f-divergence"):
        variant_config("fgan", fgan_divergence="chi")
    for v in ("began", "infogan"):  # the last two heads, ported since
        assert get_variant(v).name == v


def test_global_mean_refuses_a_mesh_axis():
    from generative_models_tpu_torch.losses.common import global_mean
    a = torch.arange(6.0).reshape(2, 3)
    assert float(global_mean(a)) == 2.5
    with pytest.raises(TypeError, match="DataGroup"):
        global_mean(a, group="dp")


def _key_chain(rng, steps, ds):
    """Every key the JAX step draws noise from, in draw order."""
    keys = []
    for _ in range(steps):
        rng, d_key, g_key = jax.random.split(rng, 3)
        keys += list(jax.random.split(d_key, ds)) + [g_key]
    return jnp.stack(keys)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


STEP_CASES = {
    "lsgan": {},
    "wgan": {},  # registry defaults: RMSprop, lr 5e-5, d_steps 5, clip 0.01
    "fgan": {"fgan_divergence": "pearson"},
    "ragan": {"adam_eps": 1e-3},
    "fishergan": {"adam_eps": 1e-3, "fisher_rho": 1e-2},
}


@pytest.mark.parametrize("variant", FIVE)
def test_general_step_matches_jax(monkeypatch, variant):
    steps = 20
    kw = dict(STEP_CASES[variant], batch_size=B, z_dim=Z, hidden_dim=H,
              image_dim=X)
    jcfg, jspec = jax_variant_config(variant, **kw), jax_variant(variant)
    ds = jcfg.d_steps
    assert ds == (5 if variant == "wgan" else 1)
    rng = np.random.default_rng(11)
    g_w, d_w = _weights(rng)
    xs = rng.random((steps, ds, B, X), dtype=np.float32)
    z_d = rng.standard_normal((steps, ds, B, Z)).astype(np.float32)
    z_g = rng.standard_normal((steps, B, Z)).astype(np.float32)

    state = jstep.init_state(jspec, jcfg, jax.random.PRNGKey(0))
    keys = _key_chain(state["rng"], steps, ds)
    table = jnp.asarray(np.concatenate(
        [np.concatenate([z_d[k], z_g[k][None]]) for k in range(steps)]))
    monkeypatch.setattr(
        _jmod(variant), "compute_noise",
        lambda key, n, z_dim: table[jnp.argmax(
            jnp.all(keys == key[None], axis=1))])
    state["g_params"] = jax.tree.map(jnp.asarray, g_w)
    state["d_params"] = jax.tree.map(jnp.asarray, d_w)
    state["g_opt"] = make_tx(jcfg, jcfg.g_lr).init(state["g_params"])
    state["d_opt"] = make_tx(jcfg, jcfg.d_lr).init(state["d_params"])
    jax_train = jax.jit(jstep.build_step(jspec, jcfg))
    j_hist = []
    for k in range(steps):
        state, m = jax_train(state, {"image": jnp.asarray(xs[k]),
                                     "label": jnp.zeros((ds, B), jnp.int32)})
        j_hist.append({n: float(v) for n, v in m.items()})

    cfg, spec = variant_config(variant, **kw), get_variant(variant)
    pst = step_lib.init_adversarial_state(spec, cfg,
                                          torch.Generator().manual_seed(0))
    pst["g_params"], pst["d_params"] = _to_t(g_w), _to_t(d_w)
    train = step_lib.build_adversarial_step(spec, cfg)
    p_hist = []
    for k in range(steps):
        pst, m = train(pst, {"image": torch.from_numpy(xs[k]),
                             "label": torch.zeros((ds, B), dtype=torch.int32)},
                       torch.from_numpy(z_d[k]), torch.from_numpy(z_g[k]))
        p_hist.append({n: float(v) for n, v in m.items()})

    assert pst["step"] == int(state["step"]) == steps
    assert set(p_hist[0]) == set(j_hist[0])
    for key in j_hist[0]:
        np.testing.assert_allclose([h[key] for h in p_hist],
                                   [h[key] for h in j_hist], err_msg=key,
                                   **TOL)
    for side in ("g_params", "d_params"):
        for mine, theirs in zip(pst[side], _np(state[side])):
            for k in ("w", "b"):
                np.testing.assert_allclose(mine[k].numpy(), theirs[k], **TOL)
    rms = cfg.optimizer == "rmsprop"
    assert rms == (variant == "wgan")
    for side in ("g_opt", "d_opt"):
        jopt = _np(state[side][0])
        assert set(pst[side]) == ({"nu"} if rms else {"count", "mu", "nu"})
        if not rms:
            assert int(pst[side]["count"]) == int(jopt.count)
        for slot in set(pst[side]) - {"count"}:
            for mine, theirs in zip(pst[side][slot], getattr(jopt, slot)):
                for k in ("w", "b"):
                    np.testing.assert_allclose(mine[k].numpy(), theirs[k],
                                               **TOL)
    if variant == "wgan":
        for l in pst["d_params"]:
            assert all(float(t.abs().max()) <= cfg.wgan_clip
                       for t in l.values())
    if variant == "fishergan":
        lams = [h["vstate_lam"] for h in p_hist]
        assert len(set(lams)) == steps and lams[-1] != 0.0
        assert pst["vstate"]["lam"].shape == ()
        np.testing.assert_allclose(float(pst["vstate"]["lam"]),
                                   float(state["vstate"]["lam"]), **TOL)
    else:
        assert pst["vstate"] == {}


@pytest.mark.parametrize("variant,fwd,bwd", [("wgan", 17, 12),
                                             ("ragan", 6, 4),
                                             ("fishergan", 5, 4)])
def test_step_launch_counts_are_those_of_the_card(monkeypatch, variant, fwd,
                                                  bwd):
    """The general step's MLP calls (counted through MLPFunction on the
    CPU). A critic update is 3 forwards (G, D on x, D on the fake) and 2
    backwards; the G update 2 and 2. wgan at d_steps 5: 5 * 3 + 2 and
    5 * 2 + 2. ragan's G loss also runs D on the real batch: one more
    forward, and no backward since nothing it reads there is
    differentiated."""
    from generative_models_tpu_torch.models import mlp as mlp_mod
    from generative_models_tpu_torch.ops import cuda_mlp
    calls = {"fwd": 0, "bwd": 0}
    real_fwd, real_bwd = cuda_mlp.mlp_fwd, cuda_mlp.mlp_bwd

    def count_fwd(*a, **k):
        calls["fwd"] += 1
        return real_fwd(*a, **k)

    def count_bwd(*a, **k):
        calls["bwd"] += 1
        return real_bwd(*a, **k)
    monkeypatch.setattr(cuda_mlp, "mlp_fwd", count_fwd)
    monkeypatch.setattr(cuda_mlp, "mlp_bwd", count_bwd)
    # route the CPU through the card's path: MLPFunction for every stack
    monkeypatch.setattr(mlp_mod, "mlp_apply_plain",
                        lambda layers, x, h, o, s, c: cuda_mlp.MLPFunction.apply(
                            x, cuda_mlp.acts_tuple(len(layers), h, o), s, c,
                            *[t for l in layers for t in (l["w"], l["b"])]))
    cfg = variant_config(variant, batch_size=B, z_dim=Z, hidden_dim=H,
                         image_dim=X)
    spec = get_variant(variant)
    ds = cfg.d_steps
    st = step_lib.init_adversarial_state(spec, cfg,
                                         torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    step = step_lib.build_adversarial_step(spec, cfg)
    step(st, {"image": torch.from_numpy(rng.random((ds, B, X), np.float32)),
              "label": torch.zeros((ds, B), dtype=torch.int32)},
         torch.from_numpy(rng.standard_normal((ds, B, Z)).astype(np.float32)),
         torch.from_numpy(rng.standard_normal((B, Z)).astype(np.float32)))
    assert calls == {"fwd": fwd, "bwd": bwd}
