"""The port's Trainer, checkpoints and CLI training run on the CPU,
against the JAX package's.

- ``fused_step=True`` (the chunk's plain version) and ``False`` (the
  general step) train the same trajectory;
- a run that crosses an epoch and a chunk boundary keeps the JAX
  Trainer's step count, metric keys, val events and epoch samples;
- save -> load -> continue equals an uninterrupted run (resuming at a
  chunk boundary of that run: each chunk's noise is seeded by the step it
  starts at);
- checkpoints cross between the packages with every leaf equal;
- ``cli.main([... "--device", "cpu"])`` prints the JAX CLI's JSON keys,
  writes its artifacts and resumes;
- the same for the later heads: wgan (an RMSprop state: optax's
  ``ScaleByRmsState``, ``nu`` alone, no count) and fishergan (the carried
  multiplier ``vstate.lam``) cross between the packages both ways, leaf
  for leaf, and each package trains on from the other's checkpoint; a
  resumed run, on the chunk path and on the general step, equals the
  uninterrupted one, multiplier included.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from conftest import TINY
from generative_models_tpu.train.trainer import Trainer as JaxTrainer
from generative_models_tpu_torch import cli
from generative_models_tpu_torch.train.trainer import Trainer

TOL = dict(rtol=2e-4, atol=2e-5)
KW = {**TINY, "scan_steps": 4}


def _params(state, side):
    return [{k: np.asarray(v) for k, v in l.items()} for l in state[side]]


def _assert_params(a, b, **tol):
    for side in ("g_params", "d_params"):
        for la, lb in zip(_params(a, side), _params(b, side)):
            for k in ("w", "b"):
                np.testing.assert_allclose(la[k], lb[k], **(tol or TOL))


def test_fused_and_general_trainers_train_the_same_trajectory(tiny_data):
    runs = {}
    for fused in (True, False):
        t = Trainer("nsgan", device="cpu", data=tiny_data, fused_step=fused,
                    **KW)
        hist = t.train(steps=10)
        runs[fused] = (t, hist)
    (tf, hf), (tg, hg) = runs[True], runs[False]
    assert set(hf) == set(hg) == {"d_loss", "d_real", "d_fake", "g_loss"}
    for k in hf:
        np.testing.assert_allclose(hf[k], hg[k], **TOL)
    _assert_params(tf.state, tg.state)
    assert tf.state["step"] == tg.state["step"] == 10
    assert int(tf.state["d_opt"]["count"]) == int(tg.state["d_opt"]["count"])


def test_epoch_and_chunk_boundaries_match_jax(tiny_data, tmp_path):
    """512 rows, val 64 carved: 28 steps an epoch at B 16; 40 steps in
    chunks of 16 cross an epoch and two chunk boundaries."""
    kw = dict(KW, scan_steps=16, val_size=64, sample_every=0)
    jt = JaxTrainer("nsgan", data=tiny_data, out_dir=str(tmp_path / "jax"),
                    **kw)
    jh = jt.train(steps=40)
    t = Trainer("nsgan", device="cpu", data=tiny_data,
                out_dir=str(tmp_path / "port"), **kw)
    h = t.train(steps=40)
    assert t.steps_per_epoch == jt.steps_per_epoch == 28
    assert sorted(h) == sorted(jh)
    for k in h:
        assert len(h[k]) == len(jh[k])
    assert t.state["step"] == int(jt.state["step"]) == 40
    assert t.steps_done == jt.steps_done == 40
    for side in ("jax", "port"):
        assert os.path.getsize(tmp_path / side / "nsgan" / "epoch001.png")
    ev, jev = t.evaluate("val"), jt.evaluate("val")
    assert sorted(ev) == sorted(jev)
    assert all(np.isfinite(v) for v in ev.values())


def test_resume_continues_the_uninterrupted_run(tiny_data, tmp_path):
    whole = Trainer("nsgan", device="cpu", data=tiny_data, **KW)
    wh = whole.train(steps=12)
    first = Trainer("nsgan", device="cpu", data=tiny_data, **KW)
    h1 = first.train(steps=8)
    path = first.save_model(str(tmp_path / "ck"))
    second = Trainer("nsgan", device="cpu", data=tiny_data, **KW)
    second.load_model(path)
    assert second.state["step"] == 8
    h2 = second.train(steps=4)
    for k in wh:
        np.testing.assert_array_equal(h1[k] + h2[k], wh[k])
    _assert_params(second.state, whole.state, rtol=0, atol=0)
    for side in ("g_opt", "d_opt"):
        assert int(second.state[side]["count"]) == \
            int(whole.state[side]["count"])


@pytest.mark.parametrize("ema", [0.0, 0.5])
def test_port_checkpoint_restores_into_jax(tiny_data, tmp_path, ema):
    t = Trainer("nsgan", device="cpu", data=tiny_data, ema_decay=ema,
                fused_step=False, **KW)
    t.train(steps=5)
    path = t.save_model(str(tmp_path / "port"))
    jt = JaxTrainer("nsgan", data=tiny_data, ema_decay=ema, **KW)
    jt.load_model(path)          # restore_state checks every leaf's path
    leaves = jax.tree_util.tree_leaves_with_path(jt.state)
    with np.load(path) as z:
        meta = json.loads(str(z["__meta__"]))
        assert [m["path"] for m in meta] == [
            jax.tree_util.keystr(p) for p, _ in leaves]
        for i, (_, leaf) in enumerate(leaves):
            np.testing.assert_array_equal(np.asarray(leaf), z[f"leaf_{i:05d}"])
    assert int(jt.state["step"]) == 5
    _assert_params(jt.state, t.state, rtol=0, atol=0)
    if ema:
        for a, b in zip(_params(jt.state, "g_ema"), _params(t.state, "g_ema")):
            np.testing.assert_array_equal(a["w"], b["w"])


def test_jax_checkpoint_restores_the_optimizer_into_the_port(tiny_data,
                                                             tmp_path):
    jt = JaxTrainer("nsgan", data=tiny_data, **KW)
    jt.train(steps=6)
    path = jt.save_model(str(tmp_path / "jax"))
    t = Trainer("nsgan", device="cpu", data=tiny_data, **KW)
    t.load_model(path)
    assert t.state["step"] == 6
    np.testing.assert_array_equal(t.state["rng"], np.asarray(jt.state["rng"]))
    for side in ("g_opt", "d_opt"):
        jopt = jt.state[side][0]
        assert int(t.state[side]["count"]) == int(jopt.count) == 6
        for slot in ("mu", "nu"):
            for mine, theirs in zip(t.state[side][slot],
                                    getattr(jopt, slot)):
                for k in ("w", "b"):
                    np.testing.assert_array_equal(mine[k].numpy(),
                                                  np.asarray(theirs[k]))
    t.train(steps=4)              # resumes from the restored slots
    assert int(t.state["g_opt"]["count"]) == 10


def test_rmsprop_checkpoint_into_an_adam_config_raises(tiny_data, tmp_path):
    jt = JaxTrainer("nsgan", data=tiny_data, optimizer="rmsprop", **KW)
    path = jt.save_model(str(tmp_path / "rms"))
    t = Trainer("nsgan", device="cpu", data=tiny_data, **KW)
    with pytest.raises(ValueError, match="optimizer='adam'"):
        t.load_model(path)


def test_train_with_new_learning_rates_rebuilds_the_optimizers(tiny_data):
    t = Trainer("nsgan", device="cpu", data=tiny_data, **KW)
    t.train(steps=4)
    g0 = t.state["g_params"][0]["w"].clone()
    t.train(steps=4, G_lr=1e-3, D_lr=1e-3)
    assert t.cfg.g_lr == t.cfg.d_lr == 1e-3
    assert int(t.state["g_opt"]["count"]) == 4   # fresh slots, 4 steps
    assert t.state["step"] == 8
    assert not torch.equal(g0, t.state["g_params"][0]["w"])


def test_unsupported_fused_step_is_refused():
    with pytest.raises(ValueError, match="Queue 2 item 6"):
        Trainer("nsgan", device="cpu", fused_step=True, ema_decay=0.5)


def test_cli_training_run(tiny_data, tmp_path, capsys):
    flags = ["--variant", "nsgan", "--device", "cpu", "--dataset",
             "synthetic", "--batch-size", "16", "--hidden-dim", "32",
             "--z-dim", "8", "--scan-steps", "5", "--echo-every", "0",
             "--out-dir", str(tmp_path), "--ckpt", str(tmp_path / "ck")]
    assert cli.main(flags + ["--steps", "10"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    line = json.loads(out[-2])
    assert sorted(line) == ["eval", "steps", "steps_per_sec", "variant",
                            "wall_s"]
    assert line["variant"] == "nsgan" and line["steps"] == 10
    assert sorted(line["eval"]) == ["d_fake", "d_loss", "d_real", "g_loss"]
    assert out[-1] == f"saved: {tmp_path / 'ck.npz'}"
    run = tmp_path / "nsgan"
    with open(run / "metrics.jsonl") as f:
        recs = [json.loads(l) for l in f]
    assert [r["step"] for r in recs] == list(range(10))
    assert os.path.getsize(run / "final.png")
    assert (run / "loss.png").exists() or (run / "loss.csv").exists()

    assert cli.main(flags + ["--steps", "5", "--resume"]) == 0
    out = capsys.readouterr().out
    assert f"resumed from {tmp_path / 'ck'} at step 10" in out
    jt = JaxTrainer("nsgan", batch_size=16, hidden_dim=32, z_dim=8,
                    data=tiny_data)
    jt.load_model(str(tmp_path / "ck"))
    assert int(jt.state["step"]) == 15


HEADS_KW = {"wgan": {}, "fishergan": {"fisher_rho": 1e-2},
            "ragan": {}, "lsgan": {}, "fgan": {"fgan_divergence": "kl"}}


@pytest.mark.parametrize("variant", ["lsgan", "wgan", "fgan", "ragan",
                                     "fishergan"])
def test_later_heads_fused_and_general_trainers_agree(tiny_data, variant):
    """Trainer(fused_step=True) (the chunk's plain version on the CPU) and
    the general step train the same trajectory; metric keys are the
    reference's. ragan and fishergan at adam_eps 1e-3 (their critic's
    bias gradient is rounding residue)."""
    kw = dict(KW, **HEADS_KW[variant])
    if variant in ("ragan", "fishergan"):
        kw["adam_eps"] = 1e-3
    runs = {}
    for fused in (True, False):
        t = Trainer(variant, device="cpu", data=tiny_data, fused_step=fused,
                    **kw)
        runs[fused] = (t, t.train(steps=8))
    (tf, hf), (tg, hg) = runs[True], runs[False]
    jt = JaxTrainer(variant, data=tiny_data, **kw)
    jh = jt.train(steps=4)
    assert set(hf) == set(hg) == set(jh)
    for k in hf:
        np.testing.assert_allclose(hf[k], hg[k], err_msg=k, **TOL)
    _assert_params(tf.state, tg.state)
    assert sorted(tf.evaluate("test")) == sorted(jt.evaluate("test"))
    if variant == "fishergan":
        np.testing.assert_allclose(float(tf.state["vstate"]["lam"]),
                                   float(tg.state["vstate"]["lam"]), **TOL)
        assert hf["vstate_lam"][-1] == float(tf.state["vstate"]["lam"])


@pytest.mark.parametrize("variant,fused", [("wgan", False), ("wgan", True),
                                           ("fishergan", True),
                                           ("fishergan", False)])
def test_later_heads_resume_continues_the_uninterrupted_run(tiny_data,
                                                            tmp_path,
                                                            variant, fused):
    kw = dict(KW, fused_step=fused, **HEADS_KW[variant])
    whole = Trainer(variant, device="cpu", data=tiny_data, **kw)
    wh = whole.train(steps=12)
    first = Trainer(variant, device="cpu", data=tiny_data, **kw)
    h1 = first.train(steps=8)
    path = first.save_model(str(tmp_path / "ck"))
    second = Trainer(variant, device="cpu", data=tiny_data, **kw)
    second.load_model(path)
    assert second.state["step"] == 8
    if variant == "fishergan":
        assert float(second.state["vstate"]["lam"]) == \
            float(first.state["vstate"]["lam"]) != 0.0
    else:
        assert "count" not in second.state["d_opt"]
        assert "mu" not in second.state["d_opt"]
    h2 = second.train(steps=4)
    for k in wh:
        np.testing.assert_array_equal(h1[k] + h2[k], wh[k])
    _assert_params(second.state, whole.state, rtol=0, atol=0)
    for a, b in zip(second.state["d_opt"]["nu"], whole.state["d_opt"]["nu"]):
        assert torch.equal(a["w"], b["w"])


@pytest.mark.parametrize("variant", ["wgan", "fishergan"])
def test_later_heads_port_checkpoint_restores_into_jax(tiny_data, tmp_path,
                                                       variant):
    kw = dict(KW, **HEADS_KW[variant])
    t = Trainer(variant, device="cpu", data=tiny_data, fused_step=False, **kw)
    t.train(steps=5)
    path = t.save_model(str(tmp_path / "port"))
    jt = JaxTrainer(variant, data=tiny_data, **kw)
    jt.load_model(path)          # restore_state checks every leaf's path
    leaves = jax.tree_util.tree_leaves_with_path(jt.state)
    with np.load(path) as z:
        meta = json.loads(str(z["__meta__"]))
        assert [m["path"] for m in meta] == [
            jax.tree_util.keystr(p) for p, _ in leaves]
        for i, (_, leaf) in enumerate(leaves):
            np.testing.assert_array_equal(np.asarray(leaf), z[f"leaf_{i:05d}"])
    paths = [m["path"] for m in meta]
    if variant == "wgan":
        assert "['d_opt'][0].nu[0]['w']" in paths
        assert not any(".count" in p or ".mu" in p for p in paths)
    else:
        assert "['vstate']['lam']" in paths
        assert float(jt.state["vstate"]["lam"]) == \
            float(t.state["vstate"]["lam"]) != 0.0
    assert int(jt.state["step"]) == 5
    _assert_params(jt.state, t.state, rtol=0, atol=0)
    jh = jt.train(steps=4)        # the JAX Trainer trains on from it
    assert int(jt.state["step"]) == 9
    assert all(np.isfinite(v).all() for v in jh.values())


@pytest.mark.parametrize("variant", ["wgan", "fishergan"])
def test_later_heads_jax_checkpoint_restores_into_the_port(tiny_data,
                                                           tmp_path, variant):
    kw = dict(KW, **HEADS_KW[variant])
    jt = JaxTrainer(variant, data=tiny_data, **kw)
    jt.train(steps=6)
    path = jt.save_model(str(tmp_path / "jax"))
    t = Trainer(variant, device="cpu", data=tiny_data, **kw)
    t.load_model(path)
    assert t.state["step"] == 6
    np.testing.assert_array_equal(t.state["rng"], np.asarray(jt.state["rng"]))
    _assert_params(t.state, jt.state, rtol=0, atol=0)
    for side in ("g_opt", "d_opt"):
        jopt = jt.state[side][0]
        slots = ("nu",) if variant == "wgan" else ("mu", "nu")
        assert set(t.state[side]) == set(slots) | (
            set() if variant == "wgan" else {"count"})
        for slot in slots:
            for mine, theirs in zip(t.state[side][slot], getattr(jopt, slot)):
                for k in ("w", "b"):
                    np.testing.assert_array_equal(mine[k].numpy(),
                                                  np.asarray(theirs[k]))
    if variant == "fishergan":
        lam = t.state["vstate"]["lam"]
        assert lam.shape == () and lam.dtype == torch.float32
        assert float(lam) == float(jt.state["vstate"]["lam"]) != 0.0
    h = t.train(steps=4)          # the port trains on from the slots
    assert t.state["step"] == 10
    assert all(np.isfinite(v).all() for v in h.values())
    if variant == "wgan":
        assert all(float(v.abs().max()) <= t.cfg.wgan_clip
                   for l in t.state["d_params"] for v in l.values())


def test_fishergan_checkpoint_with_a_misshapen_multiplier_raises(tiny_data,
                                                                 tmp_path):
    t = Trainer("fishergan", device="cpu", data=tiny_data, **KW)
    t.state["vstate"] = {"lam": torch.zeros(2)}
    path = t.save_model(str(tmp_path / "bad"))
    t2 = Trainer("fishergan", device="cpu", data=tiny_data, **KW)
    with pytest.raises(ValueError, match="vstate"):
        t2.load_model(path)


@pytest.mark.parametrize("variant", ["wgan", "fishergan"])
def test_later_heads_cli_training_run(tiny_data, tmp_path, capsys, variant):
    flags = ["--variant", variant, "--device", "cpu", "--dataset",
             "synthetic", "--batch-size", "16", "--hidden-dim", "32",
             "--z-dim", "8", "--scan-steps", "3", "--echo-every", "0",
             "--fused-step", "--out-dir", str(tmp_path),
             "--ckpt", str(tmp_path / "ck")]
    assert cli.main(flags + ["--steps", "6"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    line = json.loads(out[-2])
    want = {"wgan": ["d_loss", "g_loss", "w_estimate"],
            "fishergan": ["constraint", "d_loss", "g_loss", "ipm", "omega"]}
    assert line["variant"] == variant and line["steps"] == 6
    assert sorted(line["eval"]) == want[variant]
    with open(tmp_path / variant / "metrics.jsonl") as f:
        recs = [json.loads(l) for l in f]
    assert [r["step"] for r in recs] == list(range(6))
    if variant == "fishergan":
        assert all("vstate_lam" in r for r in recs)
    assert cli.main(flags + ["--steps", "3", "--resume"]) == 0
    assert f"resumed from {tmp_path / 'ck'} at step 6" in \
        capsys.readouterr().out
    assert cli.main(["--variant", variant, "--device", "cpu", "--hidden-dim",
                     "32", "--z-dim", "8", "--ckpt", str(tmp_path / "ck"),
                     "--sample-only", "--out-dir", str(tmp_path)]) == 0
    served = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert served["step"] == 9 and os.path.getsize(served["samples"])
