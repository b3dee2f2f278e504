"""The port's general train step against the JAX package's.

20 steps of ``train/step.py::build_adversarial_step`` on both sides from
the same numpy weights, batches and noise at a small width, and one step
at the flagship width (z 128, hidden 400, B 100). JAX draws its noise through
``compute_noise(rng, ...)``; the test replays the step's key chain on the
host and patches ``compute_noise`` to look each key up in a numpy table,
so the critic scan and the G step read the same z the port is handed.
Losses, params, Adam slots and counts agree to rtol 2e-4 / atol 2e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generative_models_tpu.config import variant_config as jax_variant_config
from generative_models_tpu.losses import minimax as jminimax
from generative_models_tpu.losses.registry import get_variant as jax_variant
from generative_models_tpu.train import step as jstep
from generative_models_tpu.train.optim import make_tx
from generative_models_tpu_torch.config import variant_config
from generative_models_tpu_torch.losses.registry import get_variant
from generative_models_tpu_torch.train import step as step_lib

TOL = dict(rtol=2e-4, atol=2e-5)
STEPS, B, Z, H, X = 20, 16, 8, 32, 784
WIDTHS = {"small": (STEPS, B, Z, H), "full": (1, 100, 128, 400)}


def _weights(rng, Z=Z, H=H):
    out = []
    for dims in ((Z, H, X), (X, H, 1)):
        layers = []
        for i, o in zip(dims[:-1], dims[1:]):
            bound = 1.0 / np.sqrt(i)
            layers.append({
                "w": rng.uniform(-bound, bound, (i, o)).astype(np.float32),
                "b": rng.uniform(-bound, bound, (o,)).astype(np.float32)})
        out.append(layers)
    return out


def _key_chain(rng, steps, ds):
    """Every key the JAX step draws noise from, in draw order."""
    keys = []
    for _ in range(steps):
        rng, d_key, g_key = jax.random.split(rng, 3)
        keys += list(jax.random.split(d_key, ds)) + [g_key]
    return jnp.stack(keys)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("variant,ds,ema,width", [
    ("nsgan", 1, 0.0, "small"), ("mmgan", 1, 0.0, "small"),
    ("nsgan", 2, 0.0, "small"), ("mmgan", 2, 0.0, "small"),
    ("nsgan", 1, 0.9, "small"), ("nsgan", 1, 0.0, "full")])
def test_general_step_matches_jax(monkeypatch, variant, ds, ema, width):
    STEPS, B, Z, H = WIDTHS[width]
    kw = dict(batch_size=B, z_dim=Z, hidden_dim=H, d_steps=ds,
              ema_decay=ema)
    rng = np.random.default_rng(11)
    g_w, d_w = _weights(rng, Z, H)
    xs = rng.random((STEPS, ds, B, X), dtype=np.float32)
    z_d = rng.standard_normal((STEPS, ds, B, Z)).astype(np.float32)
    z_g = rng.standard_normal((STEPS, B, Z)).astype(np.float32)

    # JAX: the step's keys index a table of the numpy noise
    jcfg = jax_variant_config(variant, **kw)
    jspec = jax_variant(variant)
    state = jstep.init_state(jspec, jcfg, jax.random.PRNGKey(0))
    keys = _key_chain(state["rng"], STEPS, ds)
    table = jnp.asarray(np.concatenate(
        [np.concatenate([z_d[k], z_g[k][None]]) for k in range(STEPS)]))

    def table_noise(key, n, z_dim):
        hit = jnp.all(keys == key[None], axis=1)
        return table[jnp.argmax(hit)]
    monkeypatch.setattr(jminimax, "compute_noise", table_noise)

    state["g_params"] = jax.tree.map(jnp.asarray, g_w)
    state["d_params"] = jax.tree.map(jnp.asarray, d_w)
    state["g_opt"] = make_tx(jcfg, jcfg.g_lr).init(state["g_params"])
    state["d_opt"] = make_tx(jcfg, jcfg.d_lr).init(state["d_params"])
    if ema:
        state["g_ema"] = state["g_params"]
    jax_train = jax.jit(jstep.build_step(jspec, jcfg))
    j_hist = []
    for k in range(STEPS):
        state, m = jax_train(state, {"image": jnp.asarray(xs[k]),
                                     "label": jnp.zeros((ds, B), jnp.int32)})
        j_hist.append({n: float(v) for n, v in m.items()})

    # port: the same weights, batches and noise, handed in
    cfg = variant_config(variant, **kw)
    spec = get_variant(variant)
    pst = step_lib.init_adversarial_state(spec, cfg,
                                          torch.Generator().manual_seed(0))
    to_t = lambda layers: [{k: torch.from_numpy(v.copy()) for k, v in l.items()}
                           for l in layers]
    pst["g_params"], pst["d_params"] = to_t(g_w), to_t(d_w)
    if ema:
        pst["g_ema"] = to_t(g_w)
    train = step_lib.build_adversarial_step(spec, cfg)
    p_hist = []
    for k in range(STEPS):
        pst, m = train(pst, {"image": torch.from_numpy(xs[k]),
                             "label": torch.zeros((ds, B), dtype=torch.int32)},
                       torch.from_numpy(z_d[k]), torch.from_numpy(z_g[k]))
        p_hist.append({n: float(v) for n, v in m.items()})

    assert pst["step"] == int(state["step"]) == STEPS
    assert set(p_hist[0]) == set(j_hist[0])
    for key in j_hist[0]:
        np.testing.assert_allclose([h[key] for h in p_hist],
                                   [h[key] for h in j_hist], **TOL)
    sides = ["g_params", "d_params"] + (["g_ema"] if ema else [])
    for side in sides:
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


def test_step_launch_counts_are_those_of_the_card(monkeypatch):
    """The general step's MLP calls: 5 forwards and 4 backwards a step at
    d_steps 1 (counted through MLPFunction on the CPU)."""
    from generative_models_tpu_torch.models import mlp as mlp_mod
    from generative_models_tpu_torch.ops import cuda_mlp
    calls = {"fwd": 0, "bwd": 0}
    real_fwd, real_bwd = cuda_mlp.mlp_fwd, cuda_mlp.mlp_bwd

    def fwd(*a, **k):
        calls["fwd"] += 1
        return real_fwd(*a, **k)

    def bwd(*a, **k):
        calls["bwd"] += 1
        return real_bwd(*a, **k)
    monkeypatch.setattr(cuda_mlp, "mlp_fwd", fwd)
    monkeypatch.setattr(cuda_mlp, "mlp_bwd", bwd)
    # route the CPU through the card's path: MLPFunction for every stack
    monkeypatch.setattr(mlp_mod, "mlp_apply_plain",
                        lambda layers, x, h, o, s, c: cuda_mlp.MLPFunction.apply(
                            x, cuda_mlp.acts_tuple(len(layers), h, o), s, c,
                            *[t for l in layers for t in (l["w"], l["b"])]))
    cfg = variant_config("nsgan", batch_size=B, z_dim=Z, hidden_dim=H)
    spec = get_variant("nsgan")
    st = step_lib.init_adversarial_state(spec, cfg,
                                         torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    step = step_lib.build_adversarial_step(spec, cfg)
    step(st, {"image": torch.from_numpy(rng.random((1, B, X), np.float32)),
              "label": torch.zeros((1, B), dtype=torch.int32)},
         torch.from_numpy(rng.standard_normal((1, B, Z)).astype(np.float32)),
         torch.from_numpy(rng.standard_normal((B, Z)).astype(np.float32)))
    assert calls == {"fwd": 5, "bwd": 4}


def test_init_state_layout():
    cfg = variant_config("nsgan", batch_size=B, z_dim=Z, hidden_dim=H,
                         ema_decay=0.5)
    st = step_lib.init_adversarial_state(get_variant("nsgan"), cfg,
                                         torch.Generator().manual_seed(0))
    assert sorted(st) == ["d_opt", "d_params", "g_ema", "g_opt", "g_params",
                          "rng", "step", "vstate"]
    assert st["rng"].dtype == np.uint32 and st["rng"].shape == (2,)
    assert int(st["g_opt"]["count"]) == 0 and st["step"] == 0
    assert st["g_ema"][1]["w"] is st["g_params"][1]["w"]
    jcfg = jax_variant_config("nsgan", d_steps=3)
    assert step_lib.batches_per_step(get_variant("nsgan"),
                                     cfg.replace(d_steps=3)) == 3
    assert jstep.batches_per_step(jax_variant("nsgan"), jcfg) == 3
