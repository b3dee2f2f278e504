"""The port's DDPM (``losses/ddpm.py``, ``models/ddpm_net.py``) against
the JAX package's on the CPU, and the MLP kernels' route for activations
they do not hold (``ops/linear.py``, ``models/mlp.py``).

Both sides get the same weights (the JAX init's, every leaf shifted by
seeded numpy noise so that the zero-initialised ``out``, ``skip`` and
``head`` layers pass gradients, carried with ``params_from_numpy``) and
the same draws (JAX's own, made with ``jax.random`` here and handed to
the port: the loss's t, eps and label-drop uniforms as
``losses/ddpm.py::pack_draws`` rows, the sampler's initial x and chain
noise).

Tolerances, each stated where it is used:

- ``EMB_TOL`` (atol 5e-5): the sinusoid's argument t * f reaches 1000 at
  T 1000, where one float32 ulp of f (exp on either side) is 6e-5 of
  the argument.
- ``NET_TOL`` (rtol 1e-4, atol 1e-5): the nets' outputs and gradients,
  sums in other orders and the embedding above, at T 20.
- ``TOL`` (rtol 2e-4, atol 2e-5): losses, a few Adam steps and sampler
  chains, the port's general-step tolerance (``test_torch_port_gp.py``).
- The schedules: ``alphas_bar`` within 2e-6 relative (float32 products
  of other roundings of the betas and cosines); the strided timesteps
  exactly.

``conv_channels`` is 16: at 8 each GroupNorm group holds one channel and
the conv bias before it has an exactly zero gradient, which Adam turns
into noise (``test_torch_port_conv_trajectory.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generative_models_tpu.losses import ddpm as jddpm
from generative_models_tpu.losses.registry import get_variant as jax_variant
from generative_models_tpu.models import ddpm_net as jnet
from generative_models_tpu.train import step as jstep
from generative_models_tpu_torch.config import variant_config
from generative_models_tpu_torch.losses import ddpm as pddpm
from generative_models_tpu_torch.losses.registry import get_variant
from generative_models_tpu_torch.models import ddpm_net as pnet
from generative_models_tpu_torch.train import step as step_lib
from generative_models_tpu_torch.utils.checkpoint import params_from_numpy
from generative_models_tpu_torch.utils.tree import (
    tree_leaves,
    tree_leaves_with_path,
)
from tests.conftest import TINY, tiny_cfg

EMB_TOL = dict(rtol=0, atol=5e-5)
NET_TOL = dict(rtol=1e-4, atol=1e-5)
TOL = dict(rtol=2e-4, atol=2e-5)
SMALL = dict(hidden_dim=32, ddpm_time_dim=16, ddpm_timesteps=20,
             ddpm_sample_steps=0, conv_channels=16, batch_size=8)
B = 8


def cfgs(variant="ddpm", **kw):
    """(JAX config, port config) of one setting."""
    merged = dict(SMALL, **kw)
    return tiny_cfg(variant, **merged), variant_config(variant, **dict(
        TINY, **merged))


def jax_params(jcfg, seed=0, shift=0.05):
    """The JAX init's tree, every leaf shifted by N(0, shift^2) noise."""
    p = jnet.net_init(jax.random.PRNGKey(seed), jcfg)
    rng = np.random.default_rng(seed + 100)
    return jax.tree.map(lambda a: np.asarray(a) + shift * rng.standard_normal(
        a.shape).astype(np.float32), p)


def to_port(tree):
    return params_from_numpy(jax.tree.map(lambda a: np.array(a), tree))


def assert_tree(mine, theirs, what, tol):
    """Leaf by leaf within `tol`, its atol taken relative to the leaf's
    max |reference| where that exceeds 1 (a gradient summed over a batch
    of conv outputs is of order 10, and its entries near 0 are
    differences of such sums)."""
    theirs = dict(tree_leaves_with_path(jax.tree.map(np.asarray, theirs)))
    got = tree_leaves_with_path(mine)
    assert sorted(p for p, _ in got) == sorted(theirs), what
    for path, t in got:
        ref = theirs[path]
        scale = max(1.0, float(np.abs(ref).max())) if ref.size else 1.0
        np.testing.assert_allclose(t.detach().numpy(), ref,
                                   err_msg=f"{what}{path}",
                                   rtol=tol["rtol"], atol=tol["atol"] * scale)


def jax_draws(key, cfg, b, t_draw="int"):
    """The draws of the reference's loss from `key`: (t, eps, drop u)."""
    t_key, e_key, d_key = jax.random.split(key, 3)
    if t_draw == "int":
        t = jax.random.randint(t_key, (b,), 0, cfg.ddpm_timesteps)
    else:
        t = jax.random.uniform(t_key, (b,))
    eps = jax.random.normal(e_key, (b, cfg.image_dim), jnp.float32)
    u = jax.random.uniform(d_key, (b,))
    return np.asarray(t), np.asarray(eps), np.asarray(u)


def packed(t, eps, u):
    return pddpm.pack_draws(*(torch.from_numpy(np.array(a, np.float32))
                              for a in (t, eps, u)))


def batch_of(seed, b=B, width=784):
    rng = np.random.default_rng(seed)
    x = rng.random((b, width), dtype=np.float32)
    y = rng.integers(0, 10, b).astype(np.int32)
    return x, y


# --------------------------------------------------------------------
# Repair: activations the MLP kernels do not hold
# --------------------------------------------------------------------

@pytest.mark.parametrize("act", ["silu", "gelu", "softplus", "elu"])
def test_stack_with_another_activation_splits_into_kernel_products(
        monkeypatch, act):
    """A stack holding an activation outside SUPPORTED_ACTS runs one
    MLPFunction call a layer: that layer's with act "none" and the
    activation after it, the sigmoid head fused; the result and its
    gradients equal the plain version's (on CPU tensors MLPFunction runs
    the kernels' plain versions). fused_linear routes one such layer
    alike, and a name outside ACTIVATIONS raises before any call."""
    from generative_models_tpu_torch.models import mlp
    from generative_models_tpu_torch.ops import linear
    calls = []
    real = mlp.MLPFunction.apply

    def spy(x, acts, *rest):
        calls.append(acts)
        return real(x, acts, *rest)
    monkeypatch.setattr(mlp.MLPFunction, "apply", spy)
    gen = torch.Generator().manual_seed(3)
    layers = mlp.mlp_init(gen, [12, 20, 16, 9])
    x = torch.randn(5, 12, generator=gen)
    want_p = [{k: v.clone().requires_grad_(True) for k, v in l.items()}
              for l in layers]
    got_p = [{k: v.clone().requires_grad_(True) for k, v in l.items()}
             for l in layers]
    want = mlp.mlp_apply_plain(want_p, x, act, "sigmoid")
    got = mlp.mlp_apply_split(got_p, x, (act, act, "sigmoid"))
    assert calls == [("none",), ("none",), ("sigmoid",)]
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(),
                               rtol=1e-6, atol=1e-7)
    r = torch.randn(want.shape, generator=gen)
    gw = torch.autograd.grad((want * r).sum(), tree_leaves(want_p))
    gg = torch.autograd.grad((got * r).sum(), tree_leaves(got_p))
    for a, b in zip(gg, gw):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-6)
    # one layer through fused_linear's card route: a meta tensor is not
    # a CPU one, and the kernel wrapper is a spy that computes on the CPU
    seen = []
    w, b = layers[0]["w"], layers[0]["b"]

    def kernel(xx, ww, bb, act="none", slope=0.2, compute_dtype=None):
        seen.append(act)
        return linear.linear_plain(x, ww, bb, act)
    monkeypatch.setattr(linear, "linear_cuda", kernel)
    y = linear.fused_linear(x.to("meta"), w, b, act=act)
    assert seen == ["none"]
    np.testing.assert_allclose(y.numpy(), linear.linear_plain(
        x, w, b, act).numpy(), rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError, match="unknown activation"):
        linear.fused_linear(x.to("meta"), w, b, act="swish")
    with pytest.raises(ValueError, match="unknown activation"):
        mlp.mlp_apply_split(layers, x, ("swish", "none", "none"))
    assert seen == ["none"]


def test_stack_of_kernel_activations_stays_one_launch(monkeypatch):
    """A stack of the kernels' own activations keeps its single
    MLPFunction call on the card route (mlp_apply with a non-CPU tensor),
    and a silu one takes one call a layer."""
    from generative_models_tpu_torch.models import mlp
    calls = []
    monkeypatch.setattr(mlp.MLPFunction, "apply",
                        lambda x, acts, *rest: calls.append(acts) or x)
    layers = mlp.mlp_init(torch.Generator().manual_seed(0), [4, 4, 4])
    x = torch.empty(2, 4, device="meta")
    mlp.mlp_apply(layers, x, "relu", "sigmoid")
    assert calls == [("relu", "sigmoid")]
    calls.clear()
    monkeypatch.setattr(mlp, "apply_act", lambda x, act, slope=0.2: x)
    mlp.mlp_apply(layers, x, "silu", "sigmoid")
    assert calls == [("none",), ("sigmoid",)]


# --------------------------------------------------------------------
# Nets
# --------------------------------------------------------------------

@pytest.mark.parametrize("dim", [16, 17, 128])
def test_timestep_embedding_matches_jax(dim):
    t = np.array([0, 1, 7, 499, 500, 999], np.int32)
    want = np.asarray(jnet.timestep_embedding(jnp.asarray(t), dim))
    got = pnet.timestep_embedding(torch.from_numpy(t), dim).numpy()
    assert got.shape == want.shape == (6, dim)
    np.testing.assert_allclose(got, want, **EMB_TOL)
    tf = np.array([0.0, 0.25, 0.7071], np.float32) * 1000.0
    np.testing.assert_allclose(
        pnet.timestep_embedding(torch.from_numpy(tf), dim).numpy(),
        np.asarray(jnet.timestep_embedding(jnp.asarray(tf), dim)),
        **EMB_TOL)


@pytest.mark.parametrize("arch,cond", [("mlp", False), ("mlp", True),
                                       ("conv", True)])
def test_net_forward_and_gradients_match_jax(arch, cond):
    jcfg, cfg = cfgs(arch=arch, ddpm_cond=cond)
    jp = jax_params(jcfg, seed=1)
    x, y = batch_of(2)
    x = 2.0 * x - 1.0
    t = np.random.default_rng(3).integers(0, 20, B).astype(np.int32)
    yy = np.where(np.arange(B) % 3 == 0, 10, y).astype(np.int32)
    r = np.random.default_rng(4).standard_normal((B, 784)).astype(np.float32)

    def jf(p, xx):
        out = jnet.net_apply(p, xx, jnp.asarray(t), jcfg,
                             jnp.asarray(yy) if cond else None)
        return jnp.sum(out * r), out
    (_, j_out), (j_gp, j_gx) = jax.jit(jax.value_and_grad(
        jf, argnums=(0, 1), has_aux=True))(jax.tree.map(jnp.asarray, jp),
                                           jnp.asarray(x))
    pp = to_port(jp)
    leaves = [v.requires_grad_(True) for v in tree_leaves(pp)]
    xt = torch.from_numpy(x).requires_grad_(True)
    out = pnet.net_apply(pp, xt, torch.from_numpy(t), cfg,
                         torch.from_numpy(yy) if cond else None)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out),
                               **NET_TOL)
    grads = torch.autograd.grad((out * torch.from_numpy(r)).sum(),
                                leaves + [xt])
    g_tree = [g for g in grads[:-1]]
    from generative_models_tpu_torch.utils.tree import tree_unflatten
    assert_tree(tree_unflatten(pp, g_tree), j_gp, f"{arch} grad", NET_TOL)
    np.testing.assert_allclose(grads[-1].numpy(), np.asarray(j_gx),
                               **NET_TOL)


def test_init_tree_and_zero_heads():
    """The port's init builds the reference's tree (leaf paths and
    shapes), out/skip/head at zero, the null-token table N(0, 1)."""
    for arch in ("mlp", "conv"):
        jcfg, cfg = cfgs(arch=arch, ddpm_cond=True)
        jp = jnet.net_init(jax.random.PRNGKey(0), jcfg)
        pp = pnet.net_init(torch.Generator().manual_seed(0), cfg)
        want = {p: a.shape for p, a in tree_leaves_with_path(
            jax.tree.map(np.asarray, jp))}
        assert {p: tuple(t.shape) for p, t in tree_leaves_with_path(pp)} \
            == want
        zero = ["['out']", "['skip']"] if arch == "mlp" else ["['head']"]
        for p, t in tree_leaves_with_path(pp):
            if any(p.startswith(z) for z in zero):
                assert not bool(t.any()), p
        assert pp["time"]["label"].shape == (11, 16)


# --------------------------------------------------------------------
# Schedules
# --------------------------------------------------------------------

@pytest.mark.parametrize("schedule", ["linear", "cosine"])
@pytest.mark.parametrize("t_count", [20, 1000])
def test_alphas_bar_matches_jax(schedule, t_count):
    jcfg, cfg = cfgs(ddpm_timesteps=t_count, ddpm_schedule=schedule)
    want = np.asarray(jddpm.alphas_bar(jcfg))
    got = pddpm.alphas_bar(cfg)
    assert got.dtype == np.float32 and got.shape == (t_count,)
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=0)


# S at T 1000 where torch.linspace's rounding differs from JAX's: a
# one-off sweep of S = 1..1000 found 172, and these are its first, its
# last and a spread between, 999 among them. FMA_SIDE: S where the plain
# float32 formula, without XLA's fused multiply-add from 355 entries on,
# would round some half-integer entry the other way.
TORCH_DIFFERS = (15, 19, 29, 37, 55, 99, 127, 181, 253, 343, 421, 499, 501,
                 649, 757, 859, 961, 997, 999)
FMA_SIDE = (355, 363, 367, 541, 703, 815)


@pytest.mark.parametrize("s_count", (1, 2, 3, 50, 354, 1000) + TORCH_DIFFERS
                         + FMA_SIDE)
def test_strided_timesteps_are_the_references(s_count):
    jcfg, cfg = cfgs(ddpm_timesteps=1000, ddpm_sample_steps=s_count)
    j_ts, j_ab, j_prev = (np.asarray(a) for a in
                          jddpm._sample_schedule(jcfg))
    ts, ab, prev = pddpm.sample_schedule(cfg)
    np.testing.assert_array_equal(ts, j_ts)
    np.testing.assert_allclose(ab, j_ab, rtol=2e-6)
    np.testing.assert_allclose(prev, j_prev, rtol=2e-6)
    if s_count in TORCH_DIFFERS:  # the trap the port avoids
        naive = torch.round(torch.linspace(999.0, 0.0, s_count)).long()
        assert not np.array_equal(naive.numpy(), j_ts)


# --------------------------------------------------------------------
# Loss and sampler
# --------------------------------------------------------------------

@pytest.mark.parametrize("arch,cond", [("mlp", False), ("mlp", True)])
def test_loss_and_gradients_match_jax_with_the_same_draws(arch, cond):
    jcfg, cfg = cfgs(arch=arch, ddpm_cond=cond, ddpm_label_drop=0.4)
    jp = jax_params(jcfg, seed=5)
    x, y = batch_of(6)
    key = jax.random.PRNGKey(7)
    batch = {"image": jnp.asarray(x), "label": jnp.asarray(y)}
    (j_val, _), j_g = jax.jit(jax.value_and_grad(
        lambda p, b, k: jddpm.loss(p, b, k, jcfg), has_aux=True))(
        jax.tree.map(jnp.asarray, jp), batch, key)
    pp = to_port(jp)
    leaves = [v.requires_grad_(True) for v in tree_leaves(pp)]
    val, m = pddpm.loss(pp, {"image": torch.from_numpy(x),
                             "label": torch.from_numpy(y)}, None, cfg,
                        eps=packed(*jax_draws(key, jcfg, B)))
    np.testing.assert_allclose(val.item(), float(j_val), **TOL)
    assert m["loss"].item() == val.item()
    from generative_models_tpu_torch.utils.tree import tree_unflatten
    g = torch.autograd.grad(val, leaves)
    assert_tree(tree_unflatten(pp, list(g)), j_g, "loss grad", NET_TOL)


def jax_chain_draws(rng, n, cfg, steps):
    init_key, chain_key = jax.random.split(rng)
    x = np.asarray(jax.random.normal(init_key, (n, cfg.image_dim)))
    zs = [np.asarray(jax.random.normal(jax.random.fold_in(chain_key, i),
                                       (n, cfg.image_dim)))
          for i in range(steps)]
    return torch.from_numpy(x.copy()), lambda i: torch.from_numpy(
        zs[i].copy())


@pytest.mark.parametrize("eta,s_count,cond,guidance", [
    (1.0, 0, False, 0.0), (0.0, 7, False, 0.0), (1.0, 5, True, 0.0),
    (1.0, 0, True, 1.5), (0.0, 6, True, 0.7)])
def test_sampler_matches_jax_with_the_same_draws(eta, s_count, cond,
                                                 guidance):
    kw = dict(ddpm_eta=eta, ddpm_sample_steps=s_count, ddpm_cond=cond,
              ddpm_guidance=guidance)
    jcfg, cfg = cfgs(**kw)
    jp = jax_params(jcfg, seed=8, shift=0.02)
    n = 6
    rng = jax.random.PRNGKey(9)
    want = np.asarray(jddpm.sample(jax.tree.map(jnp.asarray, jp), rng, n,
                                   jcfg))
    z, chain = jax_chain_draws(rng, n, jcfg, s_count or 20)
    got = pddpm.sample(to_port(jp), None, n, cfg, z=z, chain=chain).numpy()
    assert got.shape == (n, 784)
    np.testing.assert_allclose(got, want, **TOL)
    if cond:  # one class
        want = np.asarray(jddpm.sample_class(
            jax.tree.map(jnp.asarray, jp), rng, n, 3, jcfg))
        got = pddpm.sample_class(to_port(jp), None, n, 3, cfg, z=z,
                                 chain=chain).numpy()
        np.testing.assert_allclose(got, want, **TOL)


def test_guided_sampling_makes_one_double_width_call_a_step(monkeypatch):
    jcfg, cfg = cfgs(ddpm_cond=True, ddpm_guidance=1.0, ddpm_sample_steps=4)
    rows = []
    real = pnet.net_apply
    monkeypatch.setattr(pnet, "net_apply", lambda p, x, *a: rows.append(
        x.shape[0]) or real(p, x, *a))
    pp = pnet.net_init(torch.Generator().manual_seed(0), cfg)
    pddpm.sample(pp, torch.Generator().manual_seed(1), 5, cfg)
    assert rows == [10] * 4


# --------------------------------------------------------------------
# Steps, checkpoints, serving
# --------------------------------------------------------------------

STEPS = 3


@pytest.mark.parametrize("arch", ["mlp", "conv"])
def test_general_steps_match_jax(arch):
    """STEPS single-model steps from the same state, batches and draws
    (the JAX step's key chain replayed: rng, key = split(rng)); the
    losses, the params, the Adam slots and the EMA within TOL."""
    jcfg, cfg = cfgs(arch=arch, ddpm_cond=True)
    jspec, spec = jax_variant("ddpm"), get_variant("ddpm")
    state = jstep.init_state(jspec, jcfg, jax.random.PRNGKey(0))
    state["params"] = jax.tree.map(jnp.asarray, jax_params(jcfg, seed=11,
                                                           shift=0.02))
    state["ema"] = state["params"]
    state["opt"] = jstep.make_tx(jcfg, jcfg.g_lr).init(state["params"])
    pst = step_lib.init_state(spec, cfg, torch.Generator().manual_seed(0))
    pst["params"] = to_port(state["params"])
    pst["ema"] = to_port(state["params"])
    j_train = jax.jit(jstep.build_step(jspec, jcfg))
    train = step_lib.build_step(spec, cfg)
    chain = state["rng"]
    for k in range(STEPS):
        x, y = batch_of(20 + k)
        chain, key = jax.random.split(chain)
        state, jm = j_train(state, {"image": jnp.asarray(x)[None],
                                    "label": jnp.asarray(y)[None]})
        pst, pm = train(pst, {"image": torch.from_numpy(x)[None],
                              "label": torch.from_numpy(y)[None]},
                        packed(*jax_draws(key, jcfg, B)))
        np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]),
                                   **TOL)
    assert_tree(pst["params"], state["params"], "params", TOL)
    assert_tree(pst["ema"], state["ema"], "ema", TOL)
    assert_tree(pst["opt"]["mu"], state["opt"][0].mu, "mu", TOL)


def test_trainer_noise_and_fused_step(tiny_data):
    """The CPU grid draws [S, B, image_dim + 2] rows (t an integer in
    [0, T), u in [0, 1)); fused_step=True raises with the reference's
    exclusion; a run split in two equals the uninterrupted run."""
    from generative_models_tpu_torch.train.trainer import Trainer
    kw = dict(SMALL, scan_steps=4)
    t = Trainer("ddpm", device="cpu", data=tiny_data, **kw)
    t._load_data()
    rows = t._noise(0, 3)
    assert rows.shape == (3, 8, 786)
    tt = rows[..., 784]
    assert bool((tt == tt.round()).all()) and 0 <= float(tt.min()) \
        and float(tt.max()) < 20
    assert 0 <= float(rows[..., 785].min()) < float(rows[..., 785].max()) < 1
    with pytest.raises(ValueError, match="pallas_train.py:1387"):
        Trainer("ddpm", device="cpu", fused_step=True, **kw)
    a = Trainer("ddpm", device="cpu", data=tiny_data, **kw)
    ha = a.train(steps=6)
    b = Trainer("ddpm", device="cpu", data=tiny_data, **kw)
    hb = b.train(steps=2)["loss"] + b.train(steps=4)["loss"]
    assert list(ha["loss"]) == list(hb)
    for u, v in zip(tree_leaves(a.state), tree_leaves(b.state)):
        if torch.is_tensor(u):
            assert torch.equal(u, v)


@pytest.mark.parametrize("arch", ["conv"])
def test_jax_checkpoint_restores_and_samples(tmp_path, tiny_data, arch):
    """A JAX-trained ddpm checkpoint (params, Adam slots, EMA, rng)
    loads into the port; the port's Trainer.sample from its EMA, given
    JAX's draws, matches the JAX Trainer's sample; --sample-only writes
    the grid from the file."""
    from generative_models_tpu.train.trainer import Trainer as JaxTrainer
    from generative_models_tpu_torch import cli
    from generative_models_tpu_torch.train.trainer import Trainer
    kw = dict(SMALL, scan_steps=2, ddpm_sample_steps=5, arch=arch,
              sample_n=4)
    jt = JaxTrainer(config=tiny_cfg("ddpm", **kw), data=tiny_data)
    jt.train(steps=2)
    path = str(tmp_path / "j.npz")
    jt.save_model(path)
    t = Trainer("ddpm", device="cpu", **kw)
    t.load_model(path)
    assert t.state["step"] == 2
    assert_tree(t.state["ema"], jt.state["ema"], "ema", dict(rtol=0, atol=0))
    assert_tree(t.state["opt"]["nu"], jt.state["opt"][0].nu, "nu",
                dict(rtol=0, atol=0))
    rng = jax.random.PRNGKey(5)
    want = np.asarray(jddpm.sample(jt.generator_params, rng, 4, jt.cfg))
    z, chain = jax_chain_draws(rng, 4, jt.cfg, 5)
    np.testing.assert_allclose(t.sample(z=z, chain=chain), want, **TOL)
    rc = cli.main(["--variant", "ddpm", "--device", "cpu", "--ckpt", path,
                   "--sample-only", "--out-dir", str(tmp_path),
                   *[f"--{k.replace('_', '-')}={v}" for k, v in kw.items()]])
    assert rc == 0


def test_port_checkpoint_restores_into_jax(tmp_path, tiny_data):
    from generative_models_tpu.train.trainer import Trainer as JaxTrainer
    from generative_models_tpu_torch.train.trainer import Trainer
    kw = dict(SMALL, scan_steps=2, ddpm_cond=True)
    t = Trainer("ddpm", device="cpu", data=tiny_data, **kw)
    t.train(steps=2)
    path = t.save_model(str(tmp_path / "p.npz"))
    jt = JaxTrainer(config=tiny_cfg("ddpm", **kw), data=tiny_data)
    jt.load_model(path)
    assert int(jt.state["step"]) == 2
    assert_tree(t.state["params"], jt.state["params"], "params",
                dict(rtol=0, atol=0))
    assert_tree(t.state["ema"], jt.state["ema"], "ema", dict(rtol=0, atol=0))


def test_exported_sampler_equals_trainer_sample(tmp_path):
    """The artifact maps a seed to Trainer.sample given the same Philox
    draws: the initial x at offset 0 and step i's noise at i + 1."""
    from generative_models_tpu_torch.train.trainer import Trainer
    from generative_models_tpu_torch.utils import export
    kw = dict(SMALL, ddpm_sample_steps=4, sample_n=3, ddpm_cond=True,
              ddpm_guidance=0.5)
    t = Trainer("ddpm", device="cpu", **kw)
    t.state["ema"] = to_port(jax_params(tiny_cfg("ddpm", **kw), seed=2,
                                        shift=0.02))
    path = export.save_sampler(str(tmp_path / "d.pt2"), t.spec, t.cfg,
                               t.generator_params, 3)
    assert export.noise_width(t.spec, t.cfg) == 784
    fn = export.load_sampler(path, device="cpu")
    seed = torch.tensor(123)
    want = t.sample(z=export.sampler_noise(seed, 3, 784),
                    chain=export.sampler_chain(seed, 3, 784))
    a = fn(123)
    assert torch.equal(a, fn(123))
    np.testing.assert_allclose(a.numpy(), want, rtol=0, atol=1e-6)
