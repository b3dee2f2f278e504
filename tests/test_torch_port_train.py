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
  writes its artifacts and resumes.
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
