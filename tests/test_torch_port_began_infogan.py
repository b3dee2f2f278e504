"""The port's began and infogan heads, nets and general train step against
the JAX package's, and their checkpoints both ways.

The same numpy weights, batches and noise go to both packages. began's
JAX head draws its z through ``compute_noise`` and infogan's its codes
through ``_sample_codes``; both are patched to return the numpy draws
(looked up by key for the trajectories, the JAX step's key chain replayed
on the host), while the port takes them explicitly (``z=``; infogan's as
code rows z ⊕ onehot(cat) ⊕ cont, ``losses/infogan.py::code_rows``).

Heads: the loss, every metric and every gradient leaf of the critic (the
autoencoder; infogan's dict of trunk, D head and Q head) and of G agree to
rtol 2e-5 / atol 1e-6 (one float32 forward and backward at hidden 16),
infogan with both NLL forms. began's ``step_state_update`` (k_t and M) to
the same tolerance. General step: 4 steps of ``build_adversarial_step``
from the same weights, batches and noise: losses, params and optimizer
slots agree to rtol 2e-4 / atol 2e-5, as in tests/test_torch_port_gp.py.

began's |.| at an exact tie of a pixel and its reconstruction where
r (1 - r) = 1/4: the port's general step takes JAX autodiff's derivative
(+1, where ``torch.abs`` gives 0), its chunk plain version the TPU
kernel's ``sign`` (0); each is held against its own reference.

Checkpoints: a port checkpoint restores into the JAX Trainer leaf by leaf
(began's ``['vstate']['k']`` and ``['m']``, infogan's
``['d_params']['d_head'|'q_head'|'trunk']``), and a JAX one into the port.
"""

import importlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generative_models_tpu.config import variant_config as jax_variant_config
from generative_models_tpu.losses.registry import get_variant as jax_variant
from generative_models_tpu.models import nets as jnets
from generative_models_tpu.ops.pallas_mlp import _ru
from generative_models_tpu.ops.pallas_train import _fused_chunk_call
from generative_models_tpu.train import step as jstep
from generative_models_tpu.train.optim import make_tx
from generative_models_tpu.train.trainer import Trainer as JaxTrainer
from generative_models_tpu_torch.config import variant_config
from generative_models_tpu_torch.losses import began as began_mod
from generative_models_tpu_torch.losses.infogan import code_rows
from generative_models_tpu_torch.losses.registry import get_variant
from generative_models_tpu_torch.models import nets
from generative_models_tpu_torch.ops import cuda_mlp, cuda_train
from generative_models_tpu_torch.train import step as step_lib
from generative_models_tpu_torch.train.trainer import Trainer
from generative_models_tpu_torch.utils.tree import tree_leaves

HEAD_TOL = dict(rtol=2e-5, atol=1e-6)
TOL = dict(rtol=2e-4, atol=2e-5)
B, Z, H, X, HD = 8, 8, 16, 24, 12
CAT, CONT = 4, 2
QO = CAT + 2 * CONT
TWO = ("began", "infogan")


def _layer(rng, i, o):
    bound = 1.0 / np.sqrt(i)
    return {"w": rng.uniform(-bound, bound, (i, o)).astype(np.float32),
            "b": rng.uniform(-bound, bound, (o,)).astype(np.float32)}


def _weights(rng, variant):
    """(G, D) as numpy trees: began's critic the autoencoder X -> HD -> X,
    infogan's the reference's dict (keys as the JAX init makes them)."""
    if variant == "infogan":
        g = [_layer(rng, Z + CAT + CONT, H), _layer(rng, H, X)]
        return g, {"trunk": [_layer(rng, X, H)], "d_head": _layer(rng, H, 1),
                   "q_head": _layer(rng, H, QO)}
    return [_layer(rng, Z, H), _layer(rng, H, X)], \
        [_layer(rng, X, HD), _layer(rng, HD, X)]


def _to_t(tree):
    if isinstance(tree, dict):
        return {k: _to_t(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_t(v) for v in tree]
    return torch.from_numpy(np.array(tree, copy=True))


def _cfgs(variant, **kw):
    kw = dict(kw, batch_size=B, z_dim=Z, hidden_dim=H, image_dim=X,
              began_ae_hidden=HD, info_cat_dim=CAT, info_cont_dim=CONT)
    return jax_variant_config(variant, **kw), variant_config(variant, **kw)


def _codes(rng, lead):
    """(z, cat, cont) drawn with numpy."""
    return (rng.standard_normal(lead + (Z,)).astype(np.float32),
            rng.integers(0, CAT, lead).astype(np.int32),
            rng.uniform(-1, 1, lead + (CONT,)).astype(np.float32))


def _rows(z, cat, cont):
    """The port's infogan z rows."""
    cfg = variant_config("infogan", z_dim=Z, info_cat_dim=CAT,
                         info_cont_dim=CONT)
    return code_rows(torch.from_numpy(z), torch.from_numpy(cat).long(),
                     torch.from_numpy(cont), cfg)


def _patch_jax_draws(monkeypatch, variant, lookup):
    """Point the JAX head's draws at numpy: `lookup(key)` gives began's z
    or infogan's (z, cat, cont) of that key."""
    mod = importlib.import_module(f"generative_models_tpu.losses.{variant}")
    if variant == "began":
        monkeypatch.setattr(mod, "compute_noise",
                            lambda key, n, z_dim: lookup(key))
    else:
        def codes(key, n, cfg):
            z, cat, cont = lookup(key)
            return z, cat, jax.nn.one_hot(cat, cfg.info_cat_dim), cont
        monkeypatch.setattr(mod, "_sample_codes", codes)


def _assert_trees(mine, theirs, **tol):
    a, b = tree_leaves(mine), jax.tree_util.tree_leaves(theirs)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_allclose(x.detach().numpy(), np.asarray(y), **tol)


@pytest.mark.parametrize("variant", TWO)
def test_nets_match_jax(variant):
    rng = np.random.default_rng(1)
    g_w, d_w = _weights(rng, variant)
    jcfg, cfg = _cfgs(variant)
    x = rng.random((B, X), dtype=np.float32)
    if variant == "began":
        got = nets.began_d_apply(_to_t(d_w), torch.from_numpy(x), cfg)
        want = jnets.began_d_apply(jax.tree.map(jnp.asarray, d_w),
                                   jnp.asarray(x), jcfg)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **HEAD_TOL)
        assert got.shape == (B, X) and float(got.min()) > 0.0
        return
    for a, b in zip(nets.infogan_d_apply(_to_t(d_w), torch.from_numpy(x), cfg),
                    jnets.infogan_d_apply(jax.tree.map(jnp.asarray, d_w),
                                          jnp.asarray(x), jcfg)):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **HEAD_TOL)
    z, cat, cont = _codes(rng, (B,))
    oh = np.eye(CAT, dtype=np.float32)[cat]
    got = nets.infogan_g_apply(_to_t(g_w), torch.from_numpy(z),
                               torch.from_numpy(oh), torch.from_numpy(cont), cfg)
    want = jnets.infogan_g_apply(jax.tree.map(jnp.asarray, g_w),
                                 jnp.asarray(z), jnp.asarray(oh),
                                 jnp.asarray(cont), jcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **HEAD_TOL)
    # the init: the reference's layout and draw shapes
    d = nets.infogan_d_init(torch.Generator().manual_seed(0), cfg)
    assert sorted(d) == ["d_head", "q_head", "trunk"]
    assert tuple(d["q_head"]["w"].shape) == (H, QO)
    assert tuple(nets.infogan_g_init(torch.Generator(), cfg)[0]["w"].shape) \
        == (Z + CAT + CONT, H)


@pytest.mark.parametrize("variant,fixed_var", [("began", True),
                                               ("infogan", True),
                                               ("infogan", False)])
def test_head_matches_jax(monkeypatch, variant, fixed_var):
    rng = np.random.default_rng(21)
    g_w, d_w = _weights(rng, variant)
    x = rng.random((B, X), dtype=np.float32)
    jcfg, cfg = _cfgs(variant, info_cont_fixed_var=fixed_var)
    jspec, spec = jax_variant(variant), get_variant(variant)
    if variant == "began":
        z = rng.standard_normal((B, Z)).astype(np.float32)
        _patch_jax_draws(monkeypatch, variant, lambda key: jnp.asarray(z))
        zt = torch.from_numpy(z)
        jvs = {"k": jnp.float32(0.3), "m": jnp.float32(0.0)}
        vs = {"k": torch.tensor(0.3), "m": torch.tensor(0.0)}
    else:
        codes = _codes(rng, (B,))
        _patch_jax_draws(monkeypatch, variant,
                         lambda key: tuple(map(jnp.asarray, codes)))
        zt = _rows(*codes)
        jvs, vs = {}, {}
    jg, jd = jax.tree.map(jnp.asarray, g_w), jax.tree.map(jnp.asarray, d_w)
    jbatch = {"image": jnp.asarray(x), "label": jnp.zeros((B,), jnp.int32)}
    key = jax.random.PRNGKey(0)
    (jdl, jdm), jdg = jax.value_and_grad(
        lambda dp: jspec.d_loss(dp, jg, jbatch, key, jvs, jcfg),
        has_aux=True)(jd)
    (jgl, jgm), jgg = jax.value_and_grad(
        lambda gp: jspec.g_loss(gp, jd, jbatch, key, jvs, jcfg),
        has_aux=True)(jg)

    batch = {"image": torch.from_numpy(x), "label": torch.zeros(B)}

    def run(loss_fn, mine, other):
        leaves = [t.requires_grad_(True) for t in tree_leaves(mine)]
        loss, metrics = loss_fn(mine, other, batch, None, vs, cfg, z=zt)
        return loss, metrics, torch.autograd.grad(loss, leaves)

    dl, dm, dg = run(spec.d_loss, _to_t(d_w), _to_t(g_w))
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
    _assert_trees(list(dg), jdg, **HEAD_TOL)
    _assert_trees(list(gg), jgg, **HEAD_TOL)
    if variant == "infogan":
        assert float(dm["mi_loss"].detach()) > 0.0
        assert float(gm["g_mi_loss"].detach()) > 0.0


def test_began_step_state_update_matches_jax():
    jcfg, cfg = _cfgs("began")
    jspec, spec = jax_variant("began"), get_variant("began")
    for k0, l_real, l_fake in ((0.2, 0.31, 0.12), (0.0005, 0.1, 0.9),
                               (0.9995, 0.8, 0.01)):
        want = jspec.step_state_update(
            {"k": jnp.float32(k0), "m": jnp.float32(0.0)},
            {"began_l_real": jnp.float32(l_real)},
            {"began_l_fake_g": jnp.float32(l_fake)}, jcfg)
        got = spec.step_state_update(
            {"k": torch.tensor(k0), "m": torch.tensor(0.0)},
            {"began_l_real": torch.tensor(l_real)},
            {"began_l_fake_g": torch.tensor(l_fake)}, cfg)
        for key in ("k", "m"):
            np.testing.assert_allclose(float(got[key]), float(want[key]),
                                       **HEAD_TOL)
        assert 0.0 <= float(got["k"]) <= 1.0
    init = spec.init_vstate(cfg)
    assert set(init) == {"k", "m"} and float(init["k"]) == cfg.began_k0


def test_infogan_sampling_cycles_the_classes():
    rng = np.random.default_rng(6)
    g_w, _ = _weights(rng, "infogan")
    jcfg, cfg = _cfgs("infogan")
    z = rng.standard_normal((7, Z)).astype(np.float32)
    got = get_variant("infogan").sample(_to_t(g_w), None, 7, cfg,
                                        z=torch.from_numpy(z))
    want = jnets.infogan_g_apply(
        jax.tree.map(jnp.asarray, g_w), jnp.asarray(z),
        jax.nn.one_hot(jnp.arange(7) % CAT, CAT), jnp.zeros((7, CONT)), jcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **HEAD_TOL)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("variant", TWO)
def test_general_step_matches_jax(monkeypatch, variant):
    steps = 4
    jcfg, cfg = _cfgs(variant)
    jspec, spec = jax_variant(variant), get_variant(variant)
    assert jcfg.d_steps == 1
    rng = np.random.default_rng(11)
    g_w, d_w = _weights(rng, variant)
    xs = rng.random((steps, 1, B, X), dtype=np.float32)
    ys = np.zeros((steps, 1, B), np.int32)
    if variant == "began":
        z_d = rng.standard_normal((steps, 1, B, Z)).astype(np.float32)
        z_g = rng.standard_normal((steps, B, Z)).astype(np.float32)
        draw_d = [(z_d[k, 0],) for k in range(steps)]
        draw_g = [(z_g[k],) for k in range(steps)]
    else:
        draw_d = [_codes(rng, (B,)) for _ in range(steps)]
        draw_g = [_codes(rng, (B,)) for _ in range(steps)]

    state = jstep.init_state(jspec, jcfg, jax.random.PRNGKey(0))
    # every key the JAX step draws from, in draw order (infogan's loss
    # splits its key and draws its codes from the first half)
    keys, rows = [], []
    rng_k = state["rng"]
    for k in range(steps):
        rng_k, d_key, g_key = jax.random.split(rng_k, 3)
        for key, draw in ((jax.random.split(d_key, 1)[0], draw_d[k]),
                          (g_key, draw_g[k])):
            keys.append(jax.random.split(key)[0] if variant == "infogan"
                        else key)
            rows.append(draw)
    kt = jnp.stack(keys)
    tables = [jnp.asarray(np.stack([r[i] for r in rows]))
              for i in range(len(rows[0]))]

    def lookup(key):
        i = jnp.argmax(jnp.all(kt == key[None], axis=1))
        out = tuple(t[i] for t in tables)
        return out[0] if variant == "began" else out
    _patch_jax_draws(monkeypatch, variant, lookup)
    state["g_params"] = jax.tree.map(jnp.asarray, g_w)
    state["d_params"] = jax.tree.map(jnp.asarray, d_w)
    state["g_opt"] = make_tx(jcfg, jcfg.g_lr).init(state["g_params"])
    state["d_opt"] = make_tx(jcfg, jcfg.d_lr).init(state["d_params"])
    if variant == "began":  # a k_t above 0, so the fake term trains too
        state["vstate"] = {"k": jnp.float32(0.3), "m": jnp.float32(0.0)}
    jax_train = jax.jit(jstep.build_step(jspec, jcfg))
    j_hist = []
    for k in range(steps):
        state, m = jax_train(state, {"image": jnp.asarray(xs[k]),
                                     "label": jnp.asarray(ys[k])})
        j_hist.append({n: float(v) for n, v in m.items()})

    pst = step_lib.init_adversarial_state(spec, cfg,
                                          torch.Generator().manual_seed(0))
    pst["g_params"], pst["d_params"] = _to_t(g_w), _to_t(d_w)
    if variant == "began":
        pst["vstate"] = {"k": torch.tensor(0.3), "m": torch.tensor(0.0)}
    train = step_lib.build_adversarial_step(spec, cfg)
    p_hist = []
    for k in range(steps):
        if variant == "began":
            zd, zg = torch.from_numpy(z_d[k]), torch.from_numpy(z_g[k])
        else:
            zd, zg = _rows(*draw_d[k])[None], _rows(*draw_g[k])
        pst, m = train(pst, {"image": torch.from_numpy(xs[k]),
                             "label": torch.from_numpy(ys[k])}, zd, zg)
        p_hist.append({n: float(v) for n, v in m.items()})

    assert pst["step"] == int(state["step"]) == steps
    assert set(p_hist[0]) == set(j_hist[0])
    for key in j_hist[0]:
        np.testing.assert_allclose([h[key] for h in p_hist],
                                   [h[key] for h in j_hist], err_msg=key,
                                   **TOL)
    for side in ("g_params", "d_params"):
        _assert_trees(pst[side], _np(state[side]), **TOL)
    for side in ("g_opt", "d_opt"):
        jopt = _np(state[side][0])
        assert int(pst[side]["count"]) == int(jopt.count)
        for slot in ("mu", "nu"):
            _assert_trees(pst[side][slot], getattr(jopt, slot), **TOL)
    if variant == "began":
        for key in ("k", "m"):
            np.testing.assert_allclose(float(pst["vstate"][key]),
                                       float(state["vstate"][key]), **TOL)
        assert float(pst["vstate"]["k"]) != 0.3


def _tie_case():
    """A began critic whose reconstruction is exactly 1/2 everywhere (W2d
    and b2d zero) and a real batch whose pixel column TIE is exactly 1/2
    in every row: an exact tie of |x - r| at r (1 - r) = 1/4."""
    rng = np.random.default_rng(3)
    g_w, d_w = _weights(rng, "began")
    d_w[1]["w"][:] = 0.0
    d_w[1]["b"][:] = 0.0
    x = rng.random((B, X), dtype=np.float32) * 0.4
    x[:, 5] = 0.5
    return g_w, d_w, x, 5


def test_began_abs_at_a_tie_general_step_takes_jax_autodiffs_rule(
        monkeypatch):
    g_w, d_w, x, tie = _tie_case()
    jcfg, cfg = _cfgs("began")
    z = np.random.default_rng(4).standard_normal((B, Z)).astype(np.float32)
    _patch_jax_draws(monkeypatch, "began", lambda key: jnp.asarray(z))
    vs0 = {"k": jnp.float32(0.0), "m": jnp.float32(0.0)}
    jgrad = jax.grad(lambda dp: jax_variant("began").d_loss(
        dp, jax.tree.map(jnp.asarray, g_w),
        {"image": jnp.asarray(x)}, jax.random.PRNGKey(0), vs0, jcfg)[0])(
            jax.tree.map(jnp.asarray, d_w))
    d = _to_t(d_w)
    leaves = [t.requires_grad_(True) for t in tree_leaves(d)]
    loss, _ = get_variant("began").d_loss(
        d, _to_t(g_w), {"image": torch.from_numpy(x)}, None,
        {"k": torch.tensor(0.0), "m": torch.tensor(0.0)}, cfg,
        z=torch.from_numpy(z))
    grads = torch.autograd.grad(loss, leaves)
    _assert_trees(list(grads), jgrad, **HEAD_TOL)
    # the tie's own column: -r (1 - r) / X from the B tied pixels, as JAX
    # differentiates |.| (+1 at 0); torch.abs would give 0 there
    db2 = grads[2]  # ['d_params'][1]['b']
    assert float(db2[tie]) == pytest.approx(-0.25 / X, rel=1e-6)
    assert float(jgrad[1]["b"][tie]) == pytest.approx(-0.25 / X, rel=1e-6)
    r = torch.full((B, X), 0.5, requires_grad=True)
    torch.abs(torch.from_numpy(x) - r).mean().backward()
    assert float(r.grad[:, tie].sum()) == 0.0
    assert began_mod.abs_jax(torch.tensor(-0.0, requires_grad=True)).grad_fn


def test_began_abs_at_a_tie_chunk_takes_the_tpu_kernels_sign():
    """One chunk step on the tie data: the plain version and the TPU
    kernel (interpret mode) both leave the tied column's b2d where it was
    (sign(0) = 0: no gradient, and Adam from zero slots moves nothing),
    while the general step (JAX's rule) moves it by ~lr."""
    g_w, d_w, x, tie = _tie_case()
    _, cfg = _cfgs("began")
    hp = cuda_train.ChunkHyper.from_config(cfg)
    rng = np.random.default_rng(5)
    zd = rng.standard_normal((B, Z)).astype(np.float32)
    zg = rng.standard_normal((B, Z)).astype(np.float32)
    flat = [a for l in g_w + d_w for a in (l["w"], l["b"])]
    p = [torch.from_numpy(a.copy()) for a in flat]
    mu = [torch.zeros_like(t) for t in p]
    nu = [torch.zeros_like(t) for t in p]
    m = cuda_train.gan_chunk_plain(
        torch.from_numpy(x), torch.from_numpy(zd), torch.from_numpy(zg), p, mu,
        nu, steps=1, ds=1, batch=B, t_g=0, t_d=0, hp=hp, lam=0.0)
    assert float(p[7][tie]) == 0.0 and float(mu[7][tie]) == 0.0
    assert float(p[7][0]) != 0.0   # the untied columns moved
    new, jm = _jax_began_chunk(cfg, flat, x, zd, zg)
    for q in range(8):
        np.testing.assert_allclose(p[q].numpy(), new[q], err_msg=str(q),
                                   **TOL)
    np.testing.assert_allclose(m.numpy(), jm, **TOL)
    assert new[7][tie] == 0.0
    # the general step, on the same step: JAX's rule moves it
    st = step_lib.init_adversarial_state(get_variant("began"), cfg,
                                         torch.Generator().manual_seed(0))
    st["g_params"], st["d_params"] = _to_t(g_w), _to_t(d_w)
    st, _ = step_lib.build_adversarial_step(get_variant("began"), cfg)(
        st, {"image": torch.from_numpy(x)[None],
             "label": torch.zeros(1, B)}, torch.from_numpy(zd)[None],
        torch.from_numpy(zg))
    assert float(st["d_params"][1]["b"][tie]) == pytest.approx(cfg.d_lr,
                                                               rel=1e-3)


def _jax_began_chunk(cfg, flat, x, zd, zg):
    """One step of the TPU chunk kernel in interpret mode on began's
    state (zero optimizer slots, k_t 0)."""
    bp = _ru(B, 8)
    kz, kh, kx, khd = _ru(Z, 128), _ru(H, 128), _ru(X, 128), _ru(HD, 128)
    shapes = [(kz, kh), kh, (kh, kx), kx, (kx, khd), khd, (khd, kx), kx]

    def pack(q):
        a = flat[q]
        if isinstance(shapes[q], tuple):
            r, c = shapes[q]
            one = np.pad(a, ((0, r - a.shape[0]), (0, c - a.shape[1])))
        else:
            one = np.pad(a[None, :], ((0, 7), (0, shapes[q] - a.shape[0])))
        return jnp.stack([one, np.zeros_like(one), np.zeros_like(one)])

    def pad(a, lanes):
        return jnp.asarray(np.pad(a, ((0, bp - B), (0, lanes - a.shape[1]))))

    new, m = _fused_chunk_call(
        pad(x, kx), pad(zd, kz), pad(zg, kz), jnp.zeros((8, 128), jnp.float32),
        tuple(pack(q) for q in range(8)), jnp.zeros((1, 2), jnp.int32),
        jnp.zeros((1, 2), jnp.float32), steps=1, ds=1, b=B, dims=(Z, H, X),
        x_true=X, g_lr=cfg.g_lr, d_lr=cfg.d_lr, b1=cfg.adam_b1,
        b2=cfg.adam_b2, eps=cfg.adam_eps, slope=cfg.leaky_slope,
        variant="began", optimizer="adam", clip=0.0, dtype="float32",
        gp_lam=0.0, n_cls=0, fgan_div="", fgan_ns=False, fisher_rho=0.0,
        dh_true=HD, began_gamma=cfg.began_gamma,
        began_lambda_k=cfg.began_lambda_k, interpret=True)
    out = []
    for q, t in enumerate(new):
        a = flat[q]
        t = np.asarray(t)[0]
        out.append(t[:a.shape[0], :a.shape[1]] if a.ndim == 2
                   else t[0, :a.shape[0]])
    return out, np.asarray(m)[:, :8]


@pytest.mark.parametrize("variant", TWO)
def test_general_step_launch_counts_are_those_of_the_card(monkeypatch,
                                                          variant):
    """Counted through MLPFunction on the CPU, as on the card: a critic
    update 3 forwards and 2 backwards, the G update 2 and 2 (infogan's
    trunk and both heads run as one stack; its MI term reads the fake's
    pass of the D loss)."""
    calls = {"fwd": 0, "bwd": 0}
    real_fwd, real_bwd = cuda_mlp.mlp_fwd, cuda_mlp.mlp_bwd

    def count(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped
    monkeypatch.setattr(cuda_mlp, "mlp_fwd", count("fwd", real_fwd))
    monkeypatch.setattr(cuda_mlp, "mlp_bwd", count("bwd", real_bwd))
    monkeypatch.setattr(nets, "mlp_apply",
                        lambda layers, x, hidden_act, out_act, slope,
                        compute_dtype: cuda_mlp.MLPFunction.apply(
                            x, cuda_mlp.acts_tuple(len(layers), hidden_act,
                                                   out_act),
                            slope, compute_dtype,
                            *[t for l in layers for t in (l["w"], l["b"])]))
    _, cfg = _cfgs(variant)
    spec = get_variant(variant)
    st = step_lib.init_adversarial_state(spec, cfg,
                                         torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    zd = step_lib.draw_z(gen, (1, B), cfg, "cpu")
    zg = step_lib.draw_z(gen, (B,), cfg, "cpu")
    st, m = step_lib.build_adversarial_step(spec, cfg)(
        st, {"image": torch.rand(1, B, X), "label": torch.zeros(1, B)}, zd, zg)
    assert calls == {"fwd": 5, "bwd": 4}
    assert all(bool(torch.isfinite(v)) for v in m.values())


KW = dict(batch_size=16, hidden_dim=32, z_dim=8, began_ae_hidden=24,
          scan_steps=4, sample_n=16, seed=0)


def _params_close(port_tree, jax_tree, **tol):
    _assert_trees(port_tree, _np(jax_tree), **tol)


@pytest.mark.parametrize("variant", TWO)
def test_port_checkpoint_restores_into_jax(tiny_data, tmp_path, variant):
    t = Trainer(variant, device="cpu", data=tiny_data, fused_step=False, **KW)
    t.train(steps=5)
    path = t.save_model(str(tmp_path / "port"))
    jt = JaxTrainer(variant, data=tiny_data, **KW)
    jt.load_model(path)          # restore_state checks every leaf's path
    leaves = jax.tree_util.tree_leaves_with_path(jt.state)
    with np.load(path) as zf:
        meta = json.loads(str(zf["__meta__"]))
        paths = [m["path"] for m in meta]
        assert paths == [jax.tree_util.keystr(p) for p, _ in leaves]
        for i, (_, leaf) in enumerate(leaves):
            np.testing.assert_array_equal(np.asarray(leaf), zf[f"leaf_{i:05d}"])
    if variant == "began":
        assert "['vstate']['k']" in paths and "['vstate']['m']" in paths
        assert float(jt.state["vstate"]["k"]) == float(t.state["vstate"]["k"])
    else:
        assert "['d_params']['q_head']['w']" in paths
        assert "['d_params']['trunk'][0]['w']" in paths
    for side in ("g_params", "d_params"):
        _params_close(t.state[side], jt.state[side], rtol=0, atol=0)
    jt.train(steps=2)            # and the JAX Trainer trains on from it
    assert int(jt.state["step"]) == 7


@pytest.mark.parametrize("variant", TWO)
def test_jax_checkpoint_restores_into_the_port(tiny_data, tmp_path, variant):
    jt = JaxTrainer(variant, data=tiny_data, **KW)
    jt.train(steps=4)
    path = jt.save_model(str(tmp_path / "jax"))
    t = Trainer(variant, device="cpu", data=tiny_data, **KW)
    t.load_model(path)
    assert t.state["step"] == 4
    for side in ("g_params", "d_params"):
        _params_close(t.state[side], jt.state[side], rtol=0, atol=0)
    for side in ("g_opt", "d_opt"):
        assert int(t.state[side]["count"]) == int(jt.state[side][0].count)
        _params_close(t.state[side]["mu"], jt.state[side][0].mu, rtol=0,
                      atol=0)
    if variant == "began":
        for key in ("k", "m"):
            assert float(t.state["vstate"][key]) == float(
                jt.state["vstate"][key])
    h = t.train(steps=2)         # and the port trains on from it
    assert all(np.isfinite(v).all() for v in h.values())
    assert t.state["step"] == 6
