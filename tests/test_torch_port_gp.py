"""The port's gradient penalty and its wgangp, dragan and cgan heads and
general train step against the JAX package's.

Penalty: ``ops/penalty.py::gradient_penalty`` on the port's plain critic
(``discriminator_apply_plain``) against the JAX ``gradient_penalty`` on
the same weights and x_hat: the penalty, the mean norm and the penalty's
gradient with respect to every critic leaf (the double backward) agree
to rtol 2e-5 / atol 1e-6. The kernels' autograd function refuses a
double backward, which is why the penalty's pass is the plain one.

Heads: the same numpy weights, batch, labels and noise go through the
JAX head (``jax.value_and_grad``; its ``compute_noise`` patched to return
the numpy z, and ``interpolate`` / ``perturb_real`` to use the numpy eps
or u, the JAX std kept) and the port's head (torch autograd, ``z=`` and
``aux=``): the loss, every metric and every gradient leaf of the critic
and of the generator agree to rtol 2e-5 / atol 1e-6 (one float32 forward
and backward, and the penalty's second one, at hidden 32). dragan's
perturbation is held to ``jnp.std`` (ddof 0), which torch's default,
unbiased std would miss by far more than the tolerance.

General step: 20 steps of ``build_adversarial_step`` on both sides from
the same weights, batches, labels and noise (the JAX step's key chain
replayed on the host and looked up in a table), wgangp at its registry
defaults (Adam 1e-4, betas 0.5/0.9, d_steps 5): losses, params and
optimizer slots agree to rtol 2e-4 / atol 2e-5, as in
tests/test_torch_port_heads.py.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generative_models_tpu.config import variant_config as jax_variant_config
from generative_models_tpu.losses.registry import get_variant as jax_variant
from generative_models_tpu.models import nets as jnets
from generative_models_tpu.ops import penalty as jpenalty
from generative_models_tpu.train import step as jstep
from generative_models_tpu.train.optim import make_tx
from generative_models_tpu_torch.config import variant_config
from generative_models_tpu_torch.losses.registry import get_variant
from generative_models_tpu_torch.models import nets
from generative_models_tpu_torch.ops import cuda_mlp, penalty
from generative_models_tpu_torch.train import step as step_lib

HEAD_TOL = dict(rtol=2e-5, atol=1e-6)
TOL = dict(rtol=2e-4, atol=2e-5)
B, Z, H, X, N_CLS = 8, 8, 32, 48, 3
THREE = ("wgangp", "dragan", "cgan")


def _weights(rng, n_cls=0):
    out = []
    for dims in ((Z + n_cls, H, X), (X + n_cls, H, 1)):
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


def _cfgs(variant, **kw):
    kw = dict(kw, batch_size=B, z_dim=Z, hidden_dim=H, image_dim=X)
    if variant == "cgan":
        kw["num_classes"] = N_CLS
    return jax_variant_config(variant, **kw), variant_config(variant, **kw)


def _leaf_grads(loss, layers):
    """d loss / d every leaf; a leaf the loss does not reach (the
    penalty's: the biases, through leaky' alone) has gradient 0, as JAX
    gives it."""
    leaves = [t for l in layers for t in (l["w"], l["b"])]
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return [torch.zeros_like(t) if g is None else g
            for t, g in zip(leaves, grads)]


def _assert_leaves(mine, theirs, **tol):
    flat = [np.asarray(l[k]) for l in theirs for k in ("w", "b")]
    assert len(mine) == len(flat)
    for a, b in zip(mine, flat):
        np.testing.assert_allclose(a.detach().numpy(), b, **tol)


def test_gradient_penalty_and_its_double_backward_match_jax():
    rng = np.random.default_rng(2)
    _, d_w = _weights(rng)
    xh = rng.random((B, X), dtype=np.float32)
    jcfg, cfg = _cfgs("wgangp")
    lam = 10.0

    def jfn(dp):
        gp, norm = jpenalty.gradient_penalty(
            lambda p, xx: jnets.discriminator_apply(p, xx, jcfg), dp,
            jnp.asarray(xh), lam)
        return gp, norm
    (jgp, jnorm), jgrads = jax.value_and_grad(jfn, has_aux=True)(
        jax.tree.map(jnp.asarray, d_w))

    before = penalty.plain_passes
    dp = [{k: v.requires_grad_(True) for k, v in l.items()}
          for l in _to_t(d_w)]
    gp, norm = penalty.gradient_penalty(
        lambda p, xx: nets.discriminator_apply_plain(p, xx, cfg), dp,
        torch.from_numpy(xh), lam)
    assert penalty.plain_passes == before + 1
    np.testing.assert_allclose(float(gp.detach()), float(jgp), **HEAD_TOL)
    np.testing.assert_allclose(float(norm.detach()), float(jnorm),
                               **HEAD_TOL)
    assert float(gp.detach()) > 0.1  # far from its minimum here
    _assert_leaves(_leaf_grads(gp, dp), jgrads, **HEAD_TOL)


def test_gradient_penalty_takes_its_graph_under_no_grad():
    """evaluate() runs under torch.no_grad: the penalty still forms its
    input gradient."""
    rng = np.random.default_rng(3)
    _, d_w = _weights(rng)
    _, cfg = _cfgs("dragan")
    xh = torch.from_numpy(rng.random((B, X), dtype=np.float32))
    fn = lambda p, xx: nets.discriminator_apply_plain(p, xx, cfg)
    want = penalty.gradient_penalty(fn, _to_t(d_w), xh, 10.0)
    with torch.no_grad():
        got = penalty.gradient_penalty(fn, _to_t(d_w), xh, 10.0)
    for a, b in zip(got, want):
        assert float(a) == float(b)


def test_mlp_function_refuses_a_double_backward():
    """The kernels' autograd function (``MLPFunction``) is once
    differentiable: a penalty taken through it raises."""
    rng = np.random.default_rng(4)
    _, d_w = _weights(rng)
    d = _to_t(d_w)
    flat = [t.requires_grad_(True) for l in d for t in (l["w"], l["b"])]
    x = torch.from_numpy(rng.random((B, X), dtype=np.float32))
    x.requires_grad_(True)
    out = cuda_mlp.MLPFunction.apply(
        x, cuda_mlp.acts_tuple(2, "leaky_relu", "none"), 0.2, None, *flat)
    with pytest.raises(RuntimeError, match="not twice differentiable"):
        torch.autograd.grad(out.sum(), x, create_graph=True)
    g, = torch.autograd.grad(out.sum(), x)  # a first backward runs
    assert g.shape == x.shape and not g.requires_grad
    # the plain critic's double backward runs
    _, cfg = _cfgs("wgangp")
    gp, _ = penalty.gradient_penalty(
        lambda p, xx: nets.discriminator_apply_plain(p, xx, cfg), d,
        x.detach(), 10.0)
    assert all(t is not None for t in _leaf_grads(gp, d))


def test_dragan_perturbation_is_jnp_std():
    rng = np.random.default_rng(5)
    x = rng.random((B, X), dtype=np.float32)
    u = rng.random((B, X), dtype=np.float32)
    got = penalty.perturb_real(torch.from_numpy(x), 0.5, torch.from_numpy(u))
    want = jnp.asarray(x) + 0.5 * jnp.std(jnp.asarray(x)) * jnp.asarray(u)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)
    unbiased = torch.from_numpy(x) + 0.5 * torch.std(
        torch.from_numpy(x)) * torch.from_numpy(u)
    assert np.abs(unbiased.numpy() - np.asarray(want)).max() > 1e-5


def _patch_draws(monkeypatch, variant, z_of, aux_of):
    """Point the JAX head's draws at the numpy noise: `z_of(key)` and
    `aux_of(key)` map a JAX key to the row of noise drawn from it."""
    mod = _jmod(variant)
    monkeypatch.setattr(mod, "compute_noise",
                        lambda key, n, z_dim: z_of(key))
    if variant == "wgangp":
        monkeypatch.setattr(
            mod, "interpolate",
            lambda key, real, fake: aux_of(key) * real
            + (1.0 - aux_of(key)) * fake)
    elif variant == "dragan":
        monkeypatch.setattr(
            mod, "perturb_real",
            lambda key, real, scale: real + scale * jnp.std(real)
            * aux_of(key))


@pytest.mark.parametrize("variant", THREE)
def test_head_matches_jax(monkeypatch, variant):
    rng = np.random.default_rng(21)
    n_cls = N_CLS if variant == "cgan" else 0
    g_w, d_w = _weights(rng, n_cls)
    x = rng.random((B, X), dtype=np.float32)
    y = rng.integers(0, N_CLS, B).astype(np.int32)
    z = rng.standard_normal((B, Z)).astype(np.float32)
    lanes = {"wgangp": 1, "dragan": X}.get(variant, 0)
    aux = rng.random((B, max(lanes, 1)), dtype=np.float32)

    jcfg, cfg = _cfgs(variant)
    jspec, spec = jax_variant(variant), get_variant(variant)
    assert spec.needs_second_order == jspec.needs_second_order == (lanes > 0)
    assert penalty.aux_lanes(variant, X) == lanes
    _patch_draws(monkeypatch, variant, lambda key: jnp.asarray(z),
                 lambda key: jnp.asarray(aux))
    jg, jd = jax.tree.map(jnp.asarray, g_w), jax.tree.map(jnp.asarray, d_w)
    jbatch = {"image": jnp.asarray(x), "label": jnp.asarray(y)}
    key = jax.random.PRNGKey(0)
    (jdl, jdm), jdg = jax.value_and_grad(
        lambda dp: jspec.d_loss(dp, jg, jbatch, key, {}, jcfg),
        has_aux=True)(jd)
    (jgl, jgm), jgg = jax.value_and_grad(
        lambda gp: jspec.g_loss(gp, jd, jbatch, key, {}, jcfg),
        has_aux=True)(jg)

    batch = {"image": torch.from_numpy(x), "label": torch.from_numpy(y)}
    zt, extra = torch.from_numpy(z), (
        {"aux": torch.from_numpy(aux)} if lanes else {})

    def run(loss_fn, mine, other, **kw):
        leaves = [t.requires_grad_(True) for l in mine for t in
                  (l["w"], l["b"])]
        loss, metrics = loss_fn(mine, other, batch, None, {}, cfg, z=zt, **kw)
        return loss, metrics, torch.autograd.grad(loss, leaves)

    dl, dm, dg = run(spec.d_loss, _to_t(d_w), _to_t(g_w), **extra)
    gl, gm, gg = run(spec.g_loss, _to_t(g_w), _to_t(d_w))
    for mine, theirs in ((dl, jdl), (gl, jgl)):
        np.testing.assert_allclose(float(mine.detach()), float(theirs),
                                   **HEAD_TOL)
    for mine, theirs in ((dm, jdm), (gm, jgm)):
        assert set(mine) == set(theirs)
        for k in theirs:
            np.testing.assert_allclose(float(mine[k].detach()),
                                       float(theirs[k]), err_msg=k,
                                       **HEAD_TOL)
    _assert_leaves(dg, jdg, **HEAD_TOL)
    _assert_leaves(gg, jgg, **HEAD_TOL)
    if lanes:
        assert float(dm["gp"]) > 0.0 and float(dm["grad_norm"]) > 0.0


def test_cgan_sampling_cycles_the_classes():
    rng = np.random.default_rng(6)
    g_w, _ = _weights(rng, N_CLS)
    jcfg, cfg = _cfgs("cgan")
    z = rng.standard_normal((7, Z)).astype(np.float32)
    spec = get_variant("cgan")
    got = spec.sample(_to_t(g_w), None, 7, cfg, z=torch.from_numpy(z))
    want = jnets.cond_generator_apply(
        jax.tree.map(jnp.asarray, g_w), jnp.asarray(z),
        jnp.arange(7) % N_CLS, jcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **HEAD_TOL)
    from generative_models_tpu_torch.losses.cgan import sample_class
    one = sample_class(_to_t(g_w), None, 7, 2, cfg, z=torch.from_numpy(z))
    want = jnets.cond_generator_apply(
        jax.tree.map(jnp.asarray, g_w), jnp.asarray(z),
        jnp.full((7,), 2), jcfg)
    np.testing.assert_allclose(one.numpy(), np.asarray(want), **HEAD_TOL)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("variant", THREE)
def test_general_step_matches_jax(monkeypatch, variant):
    steps = 20
    jcfg, cfg = _cfgs(variant)
    jspec, spec = jax_variant(variant), get_variant(variant)
    ds = jcfg.d_steps
    assert ds == (5 if variant == "wgangp" else 1)
    lanes = penalty.aux_lanes(variant, X)
    n_cls = N_CLS if variant == "cgan" else 0
    rng = np.random.default_rng(11)
    g_w, d_w = _weights(rng, n_cls)
    xs = rng.random((steps, ds, B, X), dtype=np.float32)
    ys = rng.integers(0, N_CLS, (steps, ds, B)).astype(np.int32)
    z_d = rng.standard_normal((steps, ds, B, Z)).astype(np.float32)
    z_g = rng.standard_normal((steps, B, Z)).astype(np.float32)
    aux = rng.random((steps, ds, B, max(lanes, 1)), dtype=np.float32)

    state = jstep.init_state(jspec, jcfg, jax.random.PRNGKey(0))
    # every key the JAX step draws from, in draw order; a penalty head
    # splits each critic key into its z key and its penalty key
    z_keys, z_rows, aux_keys, aux_rows = [], [], [], []
    rng_k = state["rng"]
    for k in range(steps):
        rng_k, d_key, g_key = jax.random.split(rng_k, 3)
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
    _patch_draws(monkeypatch, variant, lookup(z_keys, z_rows),
                 lookup(aux_keys, aux_rows) if lanes else None)
    state["g_params"] = jax.tree.map(jnp.asarray, g_w)
    state["d_params"] = jax.tree.map(jnp.asarray, d_w)
    state["g_opt"] = make_tx(jcfg, jcfg.g_lr).init(state["g_params"])
    state["d_opt"] = make_tx(jcfg, jcfg.d_lr).init(state["d_params"])
    jax_train = jax.jit(jstep.build_step(jspec, jcfg))
    j_hist = []
    for k in range(steps):
        state, m = jax_train(state, {"image": jnp.asarray(xs[k]),
                                     "label": jnp.asarray(ys[k])})
        j_hist.append({n: float(v) for n, v in m.items()})

    pst = step_lib.init_adversarial_state(spec, cfg,
                                          torch.Generator().manual_seed(0))
    pst["g_params"], pst["d_params"] = _to_t(g_w), _to_t(d_w)
    train = step_lib.build_adversarial_step(spec, cfg)
    p_hist = []
    for k in range(steps):
        extra = [torch.from_numpy(aux[k])] if lanes else []
        pst, m = train(pst, {"image": torch.from_numpy(xs[k]),
                             "label": torch.from_numpy(ys[k])},
                       torch.from_numpy(z_d[k]), torch.from_numpy(z_g[k]),
                       *extra)
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
    for side in ("g_opt", "d_opt"):
        jopt = _np(state[side][0])
        assert int(pst[side]["count"]) == int(jopt.count)
        for slot in ("mu", "nu"):
            for mine, theirs in zip(pst[side][slot], getattr(jopt, slot)):
                for k in ("w", "b"):
                    np.testing.assert_allclose(mine[k].numpy(), theirs[k],
                                               **TOL)
    assert pst["vstate"] == {}


@pytest.mark.parametrize("variant,passes", [("wgangp", 5), ("dragan", 1),
                                            ("cgan", 0)])
def test_step_launch_counts_are_those_of_the_card(monkeypatch, variant,
                                                  passes):
    """The general step's MLP calls, counted through MLPFunction on the
    CPU, as on the card: a critic update is 3 forwards and 2 backwards,
    the G update 2 and 2 (wgangp at d_steps 5: 17 and 12), and the
    penalty's critic pass is the plain one, once a critic update."""
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
    # the kernels run (the penalty's pass keeps the plain path)
    monkeypatch.setattr(nets, "mlp_apply",
                        lambda layers, x, hidden_act, out_act, slope,
                        compute_dtype: cuda_mlp.MLPFunction.apply(
                            x, cuda_mlp.acts_tuple(len(layers), hidden_act,
                                                   out_act),
                            slope, compute_dtype,
                            *[t for l in layers for t in (l["w"], l["b"])]))
    _, cfg = _cfgs(variant)
    spec = get_variant(variant)
    ds = cfg.d_steps
    st = step_lib.init_adversarial_state(spec, cfg,
                                         torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    lanes = penalty.aux_lanes(variant, X)
    extra = [torch.from_numpy(rng.random((ds, B, lanes), np.float32))] \
        if lanes else []
    before = penalty.plain_passes
    step = step_lib.build_adversarial_step(spec, cfg)
    step(st, {"image": torch.from_numpy(rng.random((ds, B, X), np.float32)),
              "label": torch.from_numpy(rng.integers(0, N_CLS, (ds, B)))},
         torch.from_numpy(rng.standard_normal((ds, B, Z)).astype(np.float32)),
         torch.from_numpy(rng.standard_normal((B, Z)).astype(np.float32)),
         *extra)
    fwd, bwd = (17, 12) if variant == "wgangp" else (5, 4)
    assert calls == {"fwd": fwd, "bwd": bwd}
    assert penalty.plain_passes - before == passes
