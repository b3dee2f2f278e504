"""The port's Trainer, checkpoints and CLI for the VAE family on the CPU,
against the JAX package's.

- ``fused_step=True`` (the chunk kernels' plain versions) and ``False``
  (the general step) train the same trajectory (rtol 2e-4 / atol 2e-5;
  the BIR-VAE at ``adam_eps=1e-3``, see tests/test_torch_port_vae.py);
- a checkpoint of 20 trained steps restores into the JAX ``Trainer`` with
  every leaf at the JAX key path and equal bit for bit, and a JAX
  checkpoint restores into the port with its optimizer slots, with and
  without an EMA;
- ``evaluate`` and ``sample`` give the reference's keys and shapes;
- ``cli.main([... "--device", "cpu"])`` trains, prints the JAX CLI's JSON
  keys, saves, samples from the checkpoint (``--sample-only``) and
  resumes; a run resumed at a chunk boundary equals the uninterrupted run
  bit for bit.
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
from generative_models_tpu_torch.utils.tree import tree_leaves_with_path

TOL = dict(rtol=2e-4, atol=2e-5)
KW = {**TINY, "scan_steps": 4}
KEYS = {"vae": ["kl_loss", "loss", "recon_loss"],
        "birvae": ["latent_power", "loss", "recon_loss"]}


def _extra(variant):
    return {"adam_eps": 1e-3} if variant == "birvae" else {}


def _leaves(tree):
    return [(p, np.asarray(t)) for p, t in tree_leaves_with_path(tree)]


@pytest.mark.parametrize("variant", ["vae", "birvae"])
def test_fused_and_general_trainers_train_the_same_trajectory(tiny_data,
                                                              variant):
    runs = {}
    for fused in (True, False):
        t = Trainer(variant, device="cpu", data=tiny_data, fused_step=fused,
                    **KW, **_extra(variant))
        runs[fused] = (t, t.train(steps=10))
    (tf, hf), (tg, hg) = runs[True], runs[False]
    assert sorted(hf) == sorted(hg) == KEYS[variant]
    for k in hf:
        assert len(hf[k]) == 10
        np.testing.assert_allclose(hf[k], hg[k], **TOL)
    for (p, a), (_, b) in zip(_leaves(tf.state["params"]),
                              _leaves(tg.state["params"])):
        np.testing.assert_allclose(a, b, err_msg=p, **TOL)
    assert tf.state["step"] == tg.state["step"] == 10
    assert int(tf.state["opt"]["count"]) == int(tg.state["opt"]["count"]) == 10


@pytest.mark.parametrize("variant,ema", [("vae", 0.0), ("vae", 0.5),
                                         ("birvae", 0.0), ("birvae", 0.5)])
def test_port_checkpoint_restores_into_jax(tiny_data, tmp_path, variant, ema):
    t = Trainer(variant, device="cpu", data=tiny_data, ema_decay=ema, **KW)
    t.train(steps=20)
    path = t.save_model(str(tmp_path / "port"))
    jt = JaxTrainer(variant, data=tiny_data, ema_decay=ema, **KW)
    jt.load_model(path)          # restore_state checks every leaf's path
    leaves = jax.tree_util.tree_leaves_with_path(jt.state)
    with np.load(path) as z:
        meta = json.loads(str(z["__meta__"]))
        assert [m["path"] for m in meta] == [
            jax.tree_util.keystr(p) for p, _ in leaves]
        for i, (_, leaf) in enumerate(leaves):
            np.testing.assert_array_equal(np.asarray(leaf), z[f"leaf_{i:05d}"])
    assert int(jt.state["step"]) == 20
    assert int(jt.state["opt"][0].count) == 20
    sides = ["params"] + (["ema"] if ema else [])
    for side in sides:
        mine = _leaves(t.state[side])
        theirs = jax.tree_util.tree_leaves_with_path(jt.state[side])
        assert [p for p, _ in mine] == [jax.tree_util.keystr(p)
                                        for p, _ in theirs]
        for (_, a), (_, b) in zip(mine, theirs):
            np.testing.assert_array_equal(a, np.asarray(b))
    jm = jt.evaluate("test")
    pm = t.evaluate("test")
    assert sorted(jm) == sorted(pm) == KEYS[variant]
    assert all(np.isfinite(v) for v in pm.values())
    if variant == "birvae":   # no sampled noise in this metric
        np.testing.assert_allclose(pm["latent_power"], jm["latent_power"],
                                   rtol=1e-4)


@pytest.mark.parametrize("variant,ema", [("vae", 0.5), ("birvae", 0.0)])
def test_jax_checkpoint_restores_into_the_port(tiny_data, tmp_path, variant,
                                               ema):
    jt = JaxTrainer(variant, data=tiny_data, ema_decay=ema, **KW)
    jt.train(steps=6)
    path = jt.save_model(str(tmp_path / "jax"))
    t = Trainer(variant, device="cpu", data=tiny_data, ema_decay=ema, **KW)
    t.load_model(path)
    assert t.state["step"] == 6
    np.testing.assert_array_equal(t.state["rng"], np.asarray(jt.state["rng"]))
    jopt = jt.state["opt"][0]
    assert int(t.state["opt"]["count"]) == int(jopt.count) == 6
    pairs = [(t.state["params"], jt.state["params"]),
             (t.state["opt"]["mu"], jopt.mu), (t.state["opt"]["nu"], jopt.nu)]
    if ema:
        pairs.append((t.state["ema"], jt.state["ema"]))
    for mine, theirs in pairs:
        for (_, a), b in zip(_leaves(mine), jax.tree.leaves(theirs)):
            np.testing.assert_array_equal(a, np.asarray(b))
    params = t.generator_params
    assert params is (t.state["ema"] if ema else t.state["params"])
    assert t.raw_generator_params is t.state["params"]
    # the decoder serves the reference's samples from the same latents
    z = np.random.default_rng(0).standard_normal((5, KW["latent_dim"]))
    from generative_models_tpu.models import nets as jnets
    want = jnets.decoder_apply(jt.generator_params["decoder"],
                               jax.numpy.asarray(z, jax.numpy.float32), jt.cfg)
    np.testing.assert_allclose(t.sample(z=z), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    assert t.sample(3).shape == (3, 784)
    t.train(steps=4)              # resumes from the restored slots
    assert int(t.state["opt"]["count"]) == 10 and t.state["step"] == 10


def test_wrong_variant_checkpoint_raises(tiny_data, tmp_path):
    t = Trainer("vae", device="cpu", data=tiny_data, **KW)
    path = t.save_model(str(tmp_path / "vae"))
    with pytest.raises(ValueError, match="variant/config mismatch"):
        Trainer("birvae", device="cpu", data=tiny_data, **KW).load_model(path)
    with pytest.raises(ValueError, match="variant/config mismatch"):
        Trainer("nsgan", device="cpu", data=tiny_data, **KW).load_model(path)
    with pytest.raises(ValueError, match="variant/config mismatch"):
        Trainer("vae", device="cpu", data=tiny_data, ema_decay=0.5,
                **KW).load_model(path)


@pytest.mark.parametrize("variant", ["vae", "birvae"])
def test_resume_continues_the_uninterrupted_run(tiny_data, tmp_path, variant):
    whole = Trainer(variant, device="cpu", data=tiny_data, **KW)
    wh = whole.train(steps=12)
    first = Trainer(variant, device="cpu", data=tiny_data, **KW)
    h1 = first.train(steps=8)
    path = first.save_model(str(tmp_path / "ck"))
    second = Trainer(variant, device="cpu", data=tiny_data, **KW)
    second.load_model(path)
    assert second.state["step"] == 8
    h2 = second.train(steps=4)
    for k in wh:
        np.testing.assert_array_equal(h1[k] + h2[k], wh[k])
    for (_, a), (_, b) in zip(_leaves(second.state["params"]),
                              _leaves(whole.state["params"])):
        np.testing.assert_array_equal(a, b)


def test_train_with_a_new_learning_rate_rebuilds_the_optimizer(tiny_data):
    t = Trainer("vae", device="cpu", data=tiny_data, **KW)
    t.train(steps=4)
    t.train(steps=4, G_lr=1e-3)
    assert t.cfg.g_lr == 1e-3
    assert int(t.state["opt"]["count"]) == 4 and t.state["step"] == 8


def test_unsupported_fused_step_is_refused():
    with pytest.raises(ValueError, match="adam-only"):
        Trainer("vae", device="cpu", fused_step=True, ema_decay=0.5,
                optimizer="rmsprop")
    with pytest.raises(ValueError, match="bce"):
        Trainer("vae", device="cpu", fused_step=True, vae_recon="mse")


@pytest.mark.parametrize("variant", ["vae", "birvae"])
def test_cli_training_sampling_and_resume(tiny_data, tmp_path, capsys,
                                          variant):
    flags = ["--variant", variant, "--device", "cpu", "--dataset",
             "synthetic", "--batch-size", "16", "--vae-hidden-dim", "32",
             "--latent-dim", "4", "--scan-steps", "5", "--echo-every", "0",
             "--out-dir", str(tmp_path), "--ckpt", str(tmp_path / "ck")]
    assert cli.main(flags + ["--steps", "10"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    line = json.loads(out[-2])
    assert sorted(line) == ["eval", "steps", "steps_per_sec", "variant",
                            "wall_s"]
    assert line["variant"] == variant and line["steps"] == 10
    assert sorted(line["eval"]) == KEYS[variant]
    assert out[-1] == f"saved: {tmp_path / 'ck.npz'}"
    run = tmp_path / variant
    with open(run / "metrics.jsonl") as f:
        recs = [json.loads(l) for l in f]
    assert [r["step"] for r in recs] == list(range(10))
    assert sorted(set(recs[0]) - {"step", "ts"}) == KEYS[variant]
    assert os.path.getsize(run / "final.png")
    assert (run / "loss.png").exists() or (run / "loss.csv").exists()

    assert cli.main(flags + ["--sample-only"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["variant"] == variant and line["step"] == 10
    assert os.path.getsize(line["samples"])

    assert cli.main(flags + ["--steps", "5", "--resume"]) == 0
    out = capsys.readouterr().out
    assert f"resumed from {tmp_path / 'ck'} at step 10" in out
    jt = JaxTrainer(variant, batch_size=16, vae_hidden_dim=32, latent_dim=4,
                    data=tiny_data)
    jt.load_model(str(tmp_path / "ck"))
    assert int(jt.state["step"]) == 15
    assert int(jt.state["opt"][0].count) == 15
