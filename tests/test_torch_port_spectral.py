"""The port's spectral projection of the critic (``ops/spectral.py``)
against the JAX package's (``generative_models_tpu/ops/spectral.py``),
on the CPU, from the same numpy weights.

- ``spectral_sigma``: float32, rtol 1e-5 (power iteration on both sides,
  the same start and order; the matvecs' sums differ in order only);
- ``project_spectral`` for every weight shape of nsgan's and infogan's
  critic (infogan: the reference's ``{"trunk", "d_head", "q_head"}``
  dict), the biases untouched;
- ``init_sn_vectors`` and ``project_spectral_amortized`` over several
  calls, the weights moved between them as training moves them;
- the general step (``train/step.py::build_adversarial_step``) in both
  ``sn_mode``s for nsgan, began (``sn_target`` 2.0), lsgan and ragan:
  several steps from the same weights, batches and noise on both sides
  (the JAX step's key chain replayed on the host, as
  tests/test_torch_port_heads.py does), at the step tests' tolerance
  (rtol 2e-4, atol 2e-5), ``sn_v`` included; D's sigma ends at or below
  the target;
- ``fused_step`` "auto" and True with the projection resolve or raise as
  the reference's do;
- checkpoints: an amortized state's saved leaf paths are a JAX state's,
  and save -> restore -> train equals the uninterrupted run.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generative_models_tpu.config import variant_config as jax_variant_config
from generative_models_tpu.losses.registry import get_variant as jax_variant
from generative_models_tpu.ops import spectral as jsn
from generative_models_tpu.ops.pallas_train import (
    fused_step_supported as jax_fused_supported,
)
from generative_models_tpu.train import step as jstep
from generative_models_tpu.train.optim import make_tx
from generative_models_tpu_torch.config import variant_config
from generative_models_tpu_torch.losses.registry import get_variant
from generative_models_tpu_torch.ops import cuda_dp, cuda_train
from generative_models_tpu_torch.ops import spectral as psn
from generative_models_tpu_torch.train import step as step_lib
from generative_models_tpu_torch.train.trainer import Trainer
from generative_models_tpu_torch.utils import checkpoint as ckpt
from generative_models_tpu_torch.utils.tree import (
    tree_leaves,
    tree_leaves_with_path,
)

SIGMA_TOL = dict(rtol=1e-5)
# trees of weights (~0.1) and unit vectors: rtol 1e-5, and an absolute
# floor of a few float32 ulps of that scale for the elements near 0
TREE_TOL = dict(rtol=1e-5, atol=1e-7)
TOL = dict(rtol=2e-4, atol=2e-5)
B, Z, H, X, HD = 8, 8, 32, 48, 24
CAT, CONT = 4, 2


def _layer(rng, i, o, scale=1.0):
    bound = scale / np.sqrt(i)
    return {"w": rng.uniform(-bound, bound, (i, o)).astype(np.float32),
            "b": rng.uniform(-bound, bound, (o,)).astype(np.float32)}


def _critic(rng, variant, scale=3.0):
    """A critic tree as numpy, its weights `scale` times the init bound so
    that sigma starts above the targets."""
    if variant == "infogan":
        return {"trunk": [_layer(rng, X, H, scale)],
                "d_head": _layer(rng, H, 1, scale),
                "q_head": _layer(rng, H, 1 + CAT + 2 * CONT, scale)}
    if variant == "began":
        return [_layer(rng, X, HD, scale), _layer(rng, HD, X, scale)]
    return [_layer(rng, X, H, scale), _layer(rng, H, 1, scale)]


def _to_t(tree):
    if isinstance(tree, dict):
        return {k: _to_t(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_t(v) for v in tree]
    return torch.from_numpy(np.array(tree, copy=True))


def _assert_trees(mine, theirs, **tol):
    a = tree_leaves_with_path(mine)
    b = jax.tree_util.tree_leaves_with_path(theirs)
    assert [p for p, _ in a] == [jax.tree_util.keystr(p) for p, _ in b]
    for (p, x), (_, y) in zip(a, b):
        np.testing.assert_allclose(np.asarray(x), np.asarray(y), err_msg=p,
                                   **tol)


@pytest.mark.parametrize("shape,iters", [((48, 32), 10), ((32, 1), 10),
                                         ((32, 9), 50), ((3, 3, 4, 8), 10),
                                         ((784, 400), 10)])
def test_spectral_sigma_matches_jax(shape, iters):
    w = np.random.default_rng(3).standard_normal(shape).astype(np.float32)
    got = float(psn.spectral_sigma(torch.from_numpy(w), iters))
    want = float(jsn.spectral_sigma(jnp.asarray(w), iters))
    np.testing.assert_allclose(got, want, **SIGMA_TOL)
    svd = np.linalg.svd(w.reshape(-1, shape[-1]), compute_uv=False)[0]
    assert got <= svd * (1 + 1e-5)  # power iteration approaches from below


@pytest.mark.parametrize("variant", ["nsgan", "infogan"])
@pytest.mark.parametrize("target", [1.0, 2.0])
def test_project_spectral_matches_jax(variant, target):
    d = _critic(np.random.default_rng(5), variant)
    got = psn.project_spectral(_to_t(d), target, 10)
    want = jsn.project_spectral(jax.tree.map(jnp.asarray, d), target, 10)
    _assert_trees(got, want, **TREE_TOL)
    for p, leaf in tree_leaves_with_path(got):
        orig = dict(tree_leaves_with_path(_to_t(d)))[p]
        if p.endswith("['b']"):
            assert torch.equal(leaf, orig)
        else:  # projected onto the ball (the estimate the rule uses)
            assert float(psn.spectral_sigma(leaf)) <= target * (1 + 1e-5)


@pytest.mark.parametrize("variant", ["nsgan", "infogan"])
def test_amortized_vectors_match_jax_over_several_calls(variant):
    rng = np.random.default_rng(7)
    d = _critic(rng, variant)
    pd, jd = _to_t(d), jax.tree.map(jnp.asarray, d)
    pv, jv = psn.init_sn_vectors(pd, 10), jsn.init_sn_vectors(jd, 10)
    _assert_trees(pv, jv, **TREE_TOL)
    for call in range(5):
        # the weights move between calls, as a critic update moves them
        step = jax.tree.map(
            lambda a: (0.05 * rng.standard_normal(a.shape)).astype(
                np.float32), d)
        pd = _add(pd, step)
        jd = jax.tree.map(lambda a, s: a + jnp.asarray(s), jd, step)
        pd, pv = psn.project_spectral_amortized(pd, pv, 1.0)
        jd, jv = jsn.project_spectral_amortized(jd, jv, 1.0)
        _assert_trees(pd, jd, **TREE_TOL)
        _assert_trees(pv, jv, **TREE_TOL)
    shapes = dict(tree_leaves_with_path(pd))
    for p, v in tree_leaves_with_path(pv):
        want = (0,) if p.endswith("['b']") else (shapes[p].shape[-1],)
        assert tuple(v.shape) == want and v.dtype == torch.float32, p


def _add(tree, step):
    if isinstance(tree, dict):
        return {k: _add(tree[k], step[k]) for k in tree}
    if isinstance(tree, list):
        return [_add(t, s) for t, s in zip(tree, step)]
    return tree + torch.from_numpy(step)


def _jmod(variant):
    return importlib.import_module(f"generative_models_tpu.losses.{variant}")


# (variant, config beside the widths): began at the registry's conv
# override target 2.0; ragan at adam_eps 1e-3 (its head's bias gradient
# cancels exactly; see tests/test_torch_port_heads.py)
STEP_CASES = [("nsgan", {}), ("began", {"sn_target": 2.0}),
              ("lsgan", {}), ("ragan", {"adam_eps": 1e-3})]


@pytest.mark.parametrize("mode", ["amortized", "fresh"])
@pytest.mark.parametrize("variant,extra", STEP_CASES,
                         ids=[v for v, _ in STEP_CASES])
def test_general_step_with_projection_matches_jax(monkeypatch, variant,
                                                  extra, mode):
    steps = 5
    kw = dict(extra, batch_size=B, z_dim=Z, hidden_dim=H, image_dim=X,
              began_ae_hidden=HD, spectral_projection=True, sn_mode=mode)
    jcfg, jspec = jax_variant_config(variant, **kw), jax_variant(variant)
    cfg, spec = variant_config(variant, **kw), get_variant(variant)
    assert jcfg.d_steps == cfg.d_steps == 1
    rng = np.random.default_rng(13)
    g_w = [_layer(rng, Z, H), _layer(rng, H, X)]
    d_w = _critic(rng, variant)
    xs = rng.random((steps, 1, B, X), dtype=np.float32)
    z_d = rng.standard_normal((steps, 1, B, Z)).astype(np.float32)
    z_g = rng.standard_normal((steps, B, Z)).astype(np.float32)

    state = jstep.init_state(jspec, jcfg, jax.random.PRNGKey(0))
    keys, rows = [], []
    rng_k = state["rng"]
    for k in range(steps):
        rng_k, d_key, g_key = jax.random.split(rng_k, 3)
        keys += [jax.random.split(d_key, 1)[0], g_key]
        rows += [z_d[k, 0], z_g[k]]
    kt, table = jnp.stack(keys), jnp.asarray(np.stack(rows))
    monkeypatch.setattr(
        _jmod("minimax" if variant == "nsgan" else variant), "compute_noise",
        lambda key, n, z_dim: table[jnp.argmax(jnp.all(kt == key[None],
                                                       axis=1))])
    state["g_params"] = jax.tree.map(jnp.asarray, g_w)
    state["d_params"] = jax.tree.map(jnp.asarray, d_w)
    state["g_opt"] = make_tx(jcfg, jcfg.g_lr).init(state["g_params"])
    state["d_opt"] = make_tx(jcfg, jcfg.d_lr).init(state["d_params"])
    if mode == "amortized":
        state["sn_v"] = jsn.init_sn_vectors(state["d_params"], jcfg.sn_iters)
    if variant == "began":
        state["vstate"] = {"k": jnp.float32(0.3), "m": jnp.float32(0.0)}
    jax_train = jax.jit(jstep.build_step(jspec, jcfg))
    j_hist = []
    for k in range(steps):
        state, m = jax_train(state, {"image": jnp.asarray(xs[k]),
                                     "label": jnp.zeros((1, B), jnp.int32)})
        j_hist.append({n: float(v) for n, v in m.items()})

    pst = step_lib.init_adversarial_state(spec, cfg,
                                          torch.Generator().manual_seed(0))
    assert ("sn_v" in pst) == (mode == "amortized")
    pst["g_params"], pst["d_params"] = _to_t(g_w), _to_t(d_w)
    if mode == "amortized":  # burned in at these weights, as JAX's
        pst["sn_v"] = psn.init_sn_vectors(pst["d_params"], cfg.sn_iters)
    if variant == "began":
        pst["vstate"] = {"k": torch.tensor(0.3), "m": torch.tensor(0.0)}
    train = step_lib.build_adversarial_step(spec, cfg)
    p_hist = []
    for k in range(steps):
        before = pst
        pst, m = train(pst, {"image": torch.from_numpy(xs[k]),
                             "label": torch.zeros((1, B), dtype=torch.int32)},
                       torch.from_numpy(z_d[k]), torch.from_numpy(z_g[k]))
        p_hist.append({n: float(v) for n, v in m.items()})

    assert set(p_hist[0]) == set(j_hist[0])
    for key in j_hist[0]:
        np.testing.assert_allclose([h[key] for h in p_hist],
                                   [h[key] for h in j_hist], err_msg=key,
                                   **TOL)
    for side in ("g_params", "d_params") + (("sn_v",) if mode == "amortized"
                                            else ()):
        _assert_trees(pst[side], jax.tree.map(np.asarray, state[side]),
                      **TOL)
    # D's sigma ends at or below the target, by the estimate the last
    # projection applied (fresh: sn_iters iterations from the start, which
    # a scale leaves as they were; amortized: u from the vector carried
    # into the last step, |W^T u|), and the weights were projected (each
    # began above it)
    for p, w in tree_leaves_with_path(pst["d_params"]):
        if not p.endswith("['w']"):
            continue
        m2 = w.reshape(-1, w.shape[-1])
        if mode == "fresh":
            est = psn.spectral_sigma(w, cfg.sn_iters)
        else:
            u = m2 @ dict(tree_leaves_with_path(before["sn_v"]))[p]
            est = torch.linalg.vector_norm(m2.T @ (
                u / torch.linalg.vector_norm(u)))
        assert float(est) <= cfg.sn_target * (1 + 1e-5), p
        orig = dict(tree_leaves_with_path(_to_t(d_w)))[p]
        assert float(psn.spectral_sigma(orig, 50)) > cfg.sn_target, p


def test_fused_step_with_projection_resolves_as_the_reference():
    """The chunk kernels and the phase kernels refuse the projection, as
    pallas_train.py and pallas_dp.py do: "auto" takes the general step
    (which projects), True raises."""
    kw = dict(batch_size=B, z_dim=Z, hidden_dim=H, spectral_projection=True)
    for variant in ("nsgan", "lsgan"):
        cfg, spec = variant_config(variant, **kw), get_variant(variant)
        ok, reason = cuda_train.fused_step_supported(spec, cfg)
        jok, jreason = jax_fused_supported(
            jax_variant(variant), jax_variant_config(variant, **kw))
        assert (ok, jok) == (False, False)
        assert "spectral projection" in reason and "spectral" in jreason
        assert cuda_train.resolve_fused_step(spec, cfg, "cuda") is False
        assert cuda_train.resolve_fused_step(
            spec, cfg.replace(fused_step=False), "cuda") is False
        dp_ok, dp_reason = cuda_dp.fused_dp_supported(spec, cfg)
        assert not dp_ok and "spectral projection" in dp_reason
        with pytest.raises(ValueError, match="spectral projection"):
            Trainer(config=cfg.replace(fused_step=True), device="cpu")
        t = Trainer(config=cfg, device="cpu")  # "auto": the general step
        assert "sn_v" in t.state


def _jax_state_paths(variant, kw):
    jcfg = jax_variant_config(variant, **kw)
    st = jstep.init_state(jax_variant(variant), jcfg, jax.random.PRNGKey(0))
    return [jax.tree_util.keystr(p)
            for p, _ in jax.tree_util.tree_leaves_with_path(st)], st


@pytest.mark.parametrize("variant", ["nsgan", "infogan", "began"])
def test_amortized_state_leaf_paths_are_the_reference_s(variant):
    kw = dict(batch_size=B, z_dim=Z, hidden_dim=H, began_ae_hidden=HD,
              spectral_projection=True)
    cfg = variant_config(variant, **kw)
    st = step_lib.init_state(get_variant(variant), cfg,
                             torch.Generator().manual_seed(0))
    mine = ckpt.state_leaves(st)
    paths, jst = _jax_state_paths(variant, kw)
    assert [p for p, _ in mine] == paths
    jshapes = {jax.tree_util.keystr(p): np.asarray(
        jax.random.key_data(v) if jnp.issubdtype(v.dtype,
                                                 jax.dtypes.prng_key)
        else v).shape for p, v in jax.tree_util.tree_leaves_with_path(jst)}
    for p, v in mine:
        if p.startswith("['sn_v']"):
            assert tuple(v.shape) == jshapes[p], p
            assert v.dtype == torch.float32


def test_save_restore_step_equals_the_uninterrupted_run(tmp_path,
                                                        tiny_data):
    kw = dict(batch_size=16, z_dim=8, hidden_dim=32, scan_steps=3,
              spectral_projection=True, sample_every=10 ** 9,
              out_dir=str(tmp_path))
    whole = Trainer("lsgan", device="cpu", data=tiny_data, **kw)
    whole.train(steps=6)
    first = Trainer("lsgan", device="cpu", data=tiny_data, **kw)
    first.train(steps=3)
    path = first.save_model(str(tmp_path / "ck.npz"))
    leaves = ckpt.read_leaves(path)
    assert any(p.startswith("['sn_v']") for p in leaves)
    resumed = Trainer("lsgan", device="cpu", data=tiny_data, **kw)
    resumed.load_model(path)
    for (p, a), (_, b) in zip(tree_leaves_with_path(resumed.state["sn_v"]),
                              tree_leaves_with_path(first.state["sn_v"])):
        assert torch.equal(a, b), p
    resumed.train(steps=3)
    assert resumed.state["step"] == whole.state["step"] == 6
    got = dict(ckpt.state_leaves(resumed.state))
    for p, want in ckpt.state_leaves(whole.state):
        if p != "['rng']":
            np.testing.assert_array_equal(np.asarray(got[p]),
                                          np.asarray(want), err_msg=p)
    # a file without the vectors: burned in afresh at the loaded critic
    bare = {k: v for k, v in resumed.state.items() if k != "sn_v"}
    path2 = ckpt.save_state(str(tmp_path / "bare.npz"), bare)
    again = Trainer("lsgan", device="cpu", data=tiny_data, **kw)
    again.load_model(path2)
    for a, b in zip(tree_leaves(again.state["sn_v"]),
                    tree_leaves(psn.init_sn_vectors(
                        resumed.state["d_params"], 10))):
        assert torch.equal(a, b)
