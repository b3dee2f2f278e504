"""The port's flow matching (``losses/flow.py``) against the JAX package's
on the CPU: the loss and its gradients with the same draws (JAX's t, x0
and label-drop uniforms handed over as ``losses/ddpm.py::pack_draws``
rows), the ODE through ``integrate`` from the same x0 (Euler, Heun,
guided), the samplers, a few general steps from the same state and
draws, and the export. Weights, tolerances (``NET_TOL``, ``TOL``) and
sizes are ``tests/test_torch_port_ddpm.py``'s, whose helpers this file
uses; an ODE of S steps compounds the net's float32 differences S times,
so the chains are held at ``TOL``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generative_models_tpu.losses import flow as jflow
from generative_models_tpu.losses.registry import get_variant as jax_variant
from generative_models_tpu.train import step as jstep
from generative_models_tpu_torch.losses import flow as pflow
from generative_models_tpu_torch.losses.registry import get_variant
from generative_models_tpu_torch.train import step as step_lib
from generative_models_tpu_torch.utils.tree import (
    tree_leaves,
    tree_unflatten,
)
from tests.conftest import tiny_cfg
from tests.test_torch_port_ddpm import (
    B,
    NET_TOL,
    SMALL,
    TOL,
    assert_tree,
    batch_of,
    cfgs,
    jax_draws,
    jax_params,
    packed,
    to_port,
)


def test_registry_and_constants():
    assert get_variant("flow").name == "flow" and pflow.T_EMB_SCALE == \
        jflow.T_EMB_SCALE
    _, cfg = cfgs("flow")
    assert cfg.ema_decay == 0.999 and cfg.flow_sample_steps == 8


@pytest.mark.parametrize("arch,cond", [("mlp", False), ("mlp", True),
                                       ("conv", False)])
def test_loss_and_gradients_match_jax_with_the_same_draws(arch, cond):
    jcfg, cfg = cfgs("flow", arch=arch, ddpm_cond=cond, ddpm_label_drop=0.4)
    jp = jax_params(jcfg, seed=21)
    x, y = batch_of(22)
    key = jax.random.PRNGKey(23)
    (j_val, _), j_g = jax.jit(jax.value_and_grad(
        lambda p, b, k: jflow.loss(p, b, k, jcfg), has_aux=True))(
        jax.tree.map(jnp.asarray, jp),
        {"image": jnp.asarray(x), "label": jnp.asarray(y)}, key)
    pp = to_port(jp)
    leaves = [v.requires_grad_(True) for v in tree_leaves(pp)]
    val, _ = pflow.loss(pp, {"image": torch.from_numpy(x),
                             "label": torch.from_numpy(y)}, None, cfg,
                        eps=packed(*jax_draws(key, jcfg, B, "uniform")))
    np.testing.assert_allclose(val.item(), float(j_val), **TOL)
    g = torch.autograd.grad(val, leaves)
    assert_tree(tree_unflatten(pp, list(g)), j_g, "flow grad", NET_TOL)


@pytest.mark.parametrize("solver,steps,guided", [
    ("euler", 8, False), ("heun", 5, False), ("euler", 4, True),
    ("heun", 3, True)])
def test_integrate_matches_jax_from_the_same_x0(solver, steps, guided):
    kw = dict(flow_solver=solver, flow_sample_steps=steps)
    if guided:
        kw.update(ddpm_cond=True, ddpm_guidance=0.8)
    jcfg, cfg = cfgs("flow", **kw)
    jp = jax_params(jcfg, seed=24, shift=0.02)
    n = 5
    x0 = np.random.default_rng(25).standard_normal((n, 784)).astype(
        np.float32)
    y = y2 = None
    ty = ty2 = None
    if guided:
        y = jnp.arange(n) % 10
        y2 = jnp.concatenate([y, jnp.full((n,), 10, jnp.int32)])
        ty = torch.arange(n) % 10
        ty2 = torch.cat([ty, torch.full((n,), 10)])
    want = np.asarray(jflow._integrate(jax.tree.map(jnp.asarray, jp),
                                       jnp.asarray(x0), jcfg, y, y2))
    got = pflow.integrate(to_port(jp), torch.from_numpy(x0), cfg, ty, ty2)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("cond", [False, True])
def test_sampler_matches_jax_with_the_same_x0(cond):
    kw = dict(ddpm_cond=cond, flow_solver="heun", flow_sample_steps=4)
    jcfg, cfg = cfgs("flow", **kw)
    jp = jax_params(jcfg, seed=26, shift=0.02)
    rng = jax.random.PRNGKey(27)
    n = 6
    want = np.asarray(jflow.sample(jax.tree.map(jnp.asarray, jp), rng, n,
                                   jcfg))
    x0 = torch.from_numpy(np.array(jax.random.normal(rng, (n, 784))))
    got = pflow.sample(to_port(jp), None, n, cfg, z=x0).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    if cond:
        want = np.asarray(jflow.sample_class(jax.tree.map(jnp.asarray, jp),
                                             rng, n, 7, jcfg))
        got = pflow.sample_class(to_port(jp), None, n, 7, cfg, z=x0)
        np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_heun_makes_two_evaluations_a_step(monkeypatch):
    from generative_models_tpu_torch.models import ddpm_net
    _, cfg = cfgs("flow", flow_solver="heun", flow_sample_steps=3,
                  ddpm_cond=True, ddpm_guidance=0.5)
    rows = []
    real = ddpm_net.net_apply
    monkeypatch.setattr(ddpm_net, "net_apply", lambda p, x, *a: rows.append(
        x.shape[0]) or real(p, x, *a))
    pp = ddpm_net.net_init(torch.Generator().manual_seed(0), cfg)
    pflow.sample(pp, torch.Generator().manual_seed(1), 4, cfg)
    assert rows == [8] * 6


@pytest.mark.parametrize("arch", ["mlp"])
def test_general_steps_match_jax(arch):
    jcfg, cfg = cfgs("flow", arch=arch)
    jspec, spec = jax_variant("flow"), get_variant("flow")
    state = jstep.init_state(jspec, jcfg, jax.random.PRNGKey(0))
    state["params"] = jax.tree.map(jnp.asarray, jax_params(jcfg, seed=28,
                                                           shift=0.02))
    state["ema"] = state["params"]
    state["opt"] = jstep.make_tx(jcfg, jcfg.g_lr).init(state["params"])
    pst = step_lib.init_state(spec, cfg, torch.Generator().manual_seed(0))
    pst["params"] = to_port(state["params"])
    pst["ema"] = to_port(state["params"])
    j_train = jax.jit(jstep.build_step(jspec, jcfg))
    train = step_lib.build_step(spec, cfg)
    chain = state["rng"]
    for k in range(3):
        x, y = batch_of(30 + k)
        chain, key = jax.random.split(chain)
        state, jm = j_train(state, {"image": jnp.asarray(x)[None],
                                    "label": jnp.asarray(y)[None]})
        pst, pm = train(pst, {"image": torch.from_numpy(x)[None],
                              "label": torch.from_numpy(y)[None]},
                        packed(*jax_draws(key, jcfg, B, "uniform")))
        np.testing.assert_allclose(pm["loss"].item(), float(jm["loss"]),
                                   **TOL)
    assert_tree(pst["params"], state["params"], "params", TOL)
    assert_tree(pst["ema"], state["ema"], "ema", TOL)


def test_trainer_cli_and_export(tmp_path, tiny_data, capsys):
    """The CLI trains flow on the CPU, saves, serves --sample-only and
    exports; the artifact equals Trainer.sample given the same Philox
    initial x."""
    import json
    from generative_models_tpu_torch import cli
    from generative_models_tpu_torch.train.trainer import Trainer
    from generative_models_tpu_torch.utils import export
    ck, art = str(tmp_path / "f.npz"), str(tmp_path / "f.pt2")
    flags = ["--variant", "flow", "--device", "cpu", "--dataset",
             "synthetic", "--out-dir", str(tmp_path), "--hidden-dim", "32",
             "--ddpm-time-dim", "16", "--batch-size", "8", "--steps", "4",
             "--scan-steps", "2", "--flow-sample-steps", "3",
             "--sample-n", "4", "--echo-every", "0"]
    assert cli.main(flags + ["--ckpt", ck, "--export-sampler", art]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    line = json.loads([l for l in out if l.startswith("{")][-1])
    assert line["steps"] == 4 and set(line["eval"]) == {"loss"}
    assert out[-2] == f"saved: {ck}" and out[-1] == f"exported: {art}"
    assert cli.main(flags + ["--ckpt", ck, "--sample-only"]) == 0
    t = Trainer("flow", device="cpu", **dict(
        SMALL, flow_sample_steps=3, sample_n=4))
    t.load_model(ck)
    assert t.state["step"] == 4
    seed = torch.tensor(77)
    want = t.sample(z=export.sampler_noise(seed, 4, 784))
    got = export.load_sampler(art, device="cpu")(77)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_jax_checkpoint_restores_into_the_port(tmp_path, tiny_data):
    from generative_models_tpu.train.trainer import Trainer as JaxTrainer
    from generative_models_tpu_torch.train.trainer import Trainer
    kw = dict(SMALL, scan_steps=2, flow_sample_steps=3)
    jt = JaxTrainer(config=tiny_cfg("flow", **kw), data=tiny_data)
    jt.train(steps=2)
    path = str(tmp_path / "jf.npz")
    jt.save_model(path)
    t = Trainer("flow", device="cpu", **kw)
    t.load_model(path)
    assert_tree(t.state["params"], jt.state["params"], "params",
                dict(rtol=0, atol=0))
    rng = jax.random.PRNGKey(3)
    want = np.asarray(jflow.sample(jt.generator_params, rng, 3, jt.cfg))
    x0 = np.array(jax.random.normal(rng, (3, 784)))
    np.testing.assert_allclose(t.sample(z=x0), want, **TOL)
