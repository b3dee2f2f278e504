"""The port's reflow (``train/reflow.py``, ``losses/flow.py``'s reflow
branch and ``generate_pairs``, the CLI's ``--reflow-from``) against the
JAX package's on the CPU. Sizes, weights and tolerances are
``tests/test_torch_port_ddpm.py``'s: the reflow loss and its gradients
on the same paired rows and draws (``NET_TOL``/``TOL``), the teacher's
couplings from the same x0 (``TOL``: an ODE of S steps), the Trainer's
width check, the teacher's EMA preferred, the student's fresh optimizer
and EMA, and a short ``--reflow-from`` run.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generative_models_tpu.losses import flow as jflow
from generative_models_tpu_torch.losses import flow as pflow
from generative_models_tpu_torch.train import reflow
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
    cfgs,
    jax_draws,
    jax_params,
    packed,
    to_port,
)


def test_reflow_loss_reads_the_paired_x0():
    jcfg, cfg = cfgs("flow", flow_reflow=True)
    jp = jax_params(jcfg, seed=41)
    rng = np.random.default_rng(42)
    rows = np.concatenate([rng.random((B, 784)), rng.standard_normal(
        (B, 784))], axis=1).astype(np.float32)
    key = jax.random.PRNGKey(43)
    (j_val, _), j_g = jax.jit(jax.value_and_grad(
        lambda p, b, k: jflow.loss(p, b, k, jcfg), has_aux=True))(
        jax.tree.map(jnp.asarray, jp), {"image": jnp.asarray(rows)}, key)
    pp = to_port(jp)
    leaves = [v.requires_grad_(True) for v in tree_leaves(pp)]
    val, _ = pflow.loss(pp, {"image": torch.from_numpy(rows)}, None, cfg,
                        eps=packed(*jax_draws(key, jcfg, B, "uniform")))
    np.testing.assert_allclose(val.item(), float(j_val), **TOL)
    g = torch.autograd.grad(val, leaves)
    assert_tree(tree_unflatten(pp, list(g)), j_g, "reflow grad", NET_TOL)


def test_generate_pairs_match_jax_from_the_same_x0():
    """Two chunks of 4 rows for n 7: the reference's key chain (key, sub =
    split(key) a chunk; x0 = normal(sub)) replayed, its x0 handed over."""
    jcfg, cfg = cfgs("flow", flow_solver="heun", flow_sample_steps=3)
    jp = jax_params(jcfg, seed=44, shift=0.02)
    key = jax.random.PRNGKey(45)
    want = np.asarray(jflow.generate_pairs(jax.tree.map(jnp.asarray, jp),
                                           key, 7, jcfg, batch_size=4))
    x0 = []
    for _ in range(2):
        key, sub = jax.random.split(key)
        x0.append(np.asarray(jax.random.normal(sub, (4, 784))))
    x0 = torch.from_numpy(np.concatenate(x0)[:7].copy())
    got = pflow.generate_pairs(to_port(jp), None, 7, cfg, batch_size=4,
                               x0=x0)
    assert got.shape == (7, 1568)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_trainer_refuses_unpaired_rows(tiny_data):
    from generative_models_tpu_torch.train.trainer import Trainer
    t = Trainer("flow", device="cpu", data=tiny_data, flow_reflow=True,
                **SMALL)
    with pytest.raises(ValueError, match="pair rows of width 2\\*image_dim"):
        t.train(steps=1)


def test_teacher_prefers_ema_and_student_starts_fresh(tmp_path, tiny_data):
    """A JAX-written flow checkpoint with an EMA: the teacher's params are
    its EMA; without one, its params. init_student copies them, zeroes
    Adam and resets the EMA to the params."""
    from generative_models_tpu.train.trainer import Trainer as JaxTrainer
    from generative_models_tpu_torch.train.trainer import Trainer
    kw = dict(SMALL, scan_steps=2)
    for decay in (0.9, 0.0):
        jt = JaxTrainer(config=tiny_cfg("flow", **kw, ema_decay=decay),
                        data=tiny_data)
        jt.train(steps=3)
        path = str(tmp_path / f"t{decay}.npz")
        jt.save_model(path)
        _, cfg = cfgs("flow", flow_reflow=True)
        teacher = reflow.load_teacher_params(path, cfg, device="cpu")
        want = jt.state["ema"] if decay else jt.state["params"]
        assert_tree(teacher, want, "teacher", dict(rtol=0, atol=0))
        if decay:
            assert not np.array_equal(np.asarray(jt.state["ema"]["in"]["w"]),
                                      np.asarray(jt.state["params"]["in"]["w"]))
    student = Trainer("flow", device="cpu", **dict(SMALL, flow_reflow=True))
    reflow.init_student(student, teacher)
    assert_tree(student.state["params"], jt.state["params"], "student",
                dict(rtol=0, atol=0))
    assert_tree(student.state["ema"], jt.state["params"], "ema",
                dict(rtol=0, atol=0))
    assert int(student.state["opt"]["count"]) == 0
    assert not any(bool(t.any()) for t in tree_leaves(
        student.state["opt"]["mu"]))


def test_build_reflow_data_shapes_and_splits():
    _, cfg = cfgs("flow", flow_sample_steps=2)
    from generative_models_tpu_torch.models import ddpm_net
    teacher = ddpm_net.net_init(torch.Generator().manual_seed(0), cfg)
    data = reflow.build_reflow_data(teacher, cfg, n_train=10, n_test=6,
                                    gen_steps=2, gen_solver="euler",
                                    batch_size=4)
    assert data["x_train"].shape == (10, 1568) and data["x_test"].shape == (
        6, 1568)
    assert data["x_train"].dtype == np.float32
    assert not np.array_equal(data["x_train"][:6], data["x_test"])
    assert (data["y_train"] == 0).all() and data["y_test"].dtype == np.int32
    x1 = data["x_train"][:, :784]
    assert 0.0 <= x1.min() and x1.max() <= 1.0


def test_cli_reflow_from_trains_the_student(tmp_path, capsys):
    """A flow teacher's checkpoint, then --reflow-from with 64 pairs: the
    run prints the reflow line, trains on the couplings and serves 1-step
    samples; --sample-only with --reflow-from is a usage error, and a
    variant other than flow raises as the reference's does."""
    from generative_models_tpu_torch import cli
    ck = str(tmp_path / "teacher.npz")
    base = ["--device", "cpu", "--dataset", "synthetic", "--out-dir",
            str(tmp_path), "--hidden-dim", "32", "--ddpm-time-dim", "16",
            "--batch-size", "8", "--scan-steps", "2", "--sample-n", "4",
            "--echo-every", "0"]
    assert cli.main(["--variant", "flow", "--steps", "2", "--ckpt", ck,
                     "--flow-sample-steps", "2", *base]) == 0
    capsys.readouterr()
    assert cli.main(["--variant", "flow", "--steps", "3", "--reflow-from",
                     ck, "--reflow-pairs", "64", "--reflow-gen-steps", "2",
                     "--flow-sample-steps", "1", *base]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert out[0] == f"reflow: 64 teacher couplings from {ck} (heun S=2)"
    line = json.loads([l for l in out if l.startswith("{")][-1])
    assert line["steps"] == 3 and np.isfinite(line["eval"]["loss"])
    with pytest.raises(SystemExit) as e:
        cli.main(["--variant", "flow", "--reflow-from", ck, "--sample-only",
                  *base])
    assert e.value.code == 2
    with pytest.raises(ValueError, match="flow_reflow applies to the flow"):
        cli.main(["--variant", "ddpm", "--steps", "1", "--reflow-from", ck,
                  *base])
