"""The PyTorch port's serving path against the JAX package.

A JAX ``Trainer`` is built (nothing is trained) at the suite's tiny
sizes and at full width, and saved with ``save_model``. The port loads
that checkpoint on the CPU and samples from injected noise; the samples
must equal JAX's ``nets.generator_apply`` on the same weights and noise
(float32: rtol=1e-5, atol=1e-6; bf16 operands: atol=2e-2).
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import TINY
from generative_models_tpu.losses import common as jcommon
from generative_models_tpu.models import nets as jnets
from generative_models_tpu.train.trainer import Trainer as JaxTrainer
from generative_models_tpu.utils.viz import save_image_grid as jax_grid
from generative_models_tpu_torch import cli
from generative_models_tpu_torch.config import variant_config
from generative_models_tpu_torch.losses import common
from generative_models_tpu_torch.losses.registry import get_variant
from generative_models_tpu_torch.train.trainer import Trainer
from generative_models_tpu_torch.utils.checkpoint import (
    load_jax_checkpoint,
    params_from_numpy,
)
from generative_models_tpu_torch.utils.viz import save_image_grid

F32 = dict(rtol=1e-5, atol=1e-6)
WIDTHS = {"tiny": {}, "full": {"z_dim": 128, "hidden_dim": 400}}


def _overrides(width, **kw):
    return {**TINY, **WIDTHS[width], **kw}


def _save_jax(data, path, variant="nsgan", step=7, **overrides):
    """Build a JAX trainer, stamp a step, make the EMA differ from the
    live weights (so a test can tell which one was read), and save."""
    t = JaxTrainer(variant, data=data, **overrides)
    st = dict(t.state, step=jnp.int32(step))
    if "g_ema" in st:
        st["g_ema"] = jax.tree.map(lambda a: 0.5 * a, st["g_ema"])
    t.state = st
    return t, t.save_model(str(path))


def _port_cfg(jax_cfg):
    kw = dataclasses.asdict(jax_cfg)
    return variant_config(kw.pop("variant"), **kw)


def _z(n, z_dim, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (n, z_dim)).astype(np.float32)


@pytest.mark.parametrize("ema", [0.0, 0.5], ids=["g_params", "g_ema"])
@pytest.mark.parametrize("width", ["tiny", "full"])
def test_loaded_checkpoint_samples_match_jax(tiny_data, tmp_path, width, ema):
    jt, path = _save_jax(tiny_data, tmp_path / "ck.npz",
                         **_overrides(width, ema_decay=ema))
    t = Trainer(config=_port_cfg(jt.cfg), device="cpu")
    t.load_model(path)
    z = _z(37, jt.cfg.z_dim)
    want = np.asarray(jnets.generator_apply(jt.generator_params, z, jt.cfg))
    got = t.sample(z=z)
    assert got.shape == (37, 784) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, **F32)
    assert t.state["step"] == 7
    raw = [{k: np.asarray(v) for k, v in l.items()}
           for l in t.raw_generator_params]
    for mine, theirs in zip(raw, jt.raw_generator_params):
        np.testing.assert_array_equal(mine["w"], np.asarray(theirs["w"]))
        np.testing.assert_array_equal(mine["b"], np.asarray(theirs["b"]))


def test_bf16_samples_match_jax(tiny_data, tmp_path):
    jt, path = _save_jax(tiny_data, tmp_path / "ck.npz",
                         **_overrides("full", dtype="bfloat16"))
    t = Trainer(config=_port_cfg(jt.cfg), device="cpu")
    t.load_model(path)
    z = _z(16, 128, seed=1)
    want = np.asarray(jnets.generator_apply(jt.generator_params, z, jt.cfg))
    np.testing.assert_allclose(t.sample(z=z), want, rtol=0.0, atol=2e-2)


@pytest.mark.parametrize("variant", ["nsgan", "mmgan"])
def test_losses_match_jax(tiny_data, tmp_path, variant):
    """Forward d/g losses with the same weights, batch and noise."""
    jt, path = _save_jax(tiny_data, tmp_path / "ck.npz", variant=variant,
                         **_overrides("tiny"))
    t = Trainer(config=_port_cfg(jt.cfg), device="cpu")
    t.load_model(path)
    x = np.asarray(tiny_data["x_train"][:16], np.float32).reshape(16, -1) / 255
    z = _z(16, jt.cfg.z_dim, seed=2)
    g, d = jt.state["g_params"], jt.state["d_params"]
    l_real = jnets.discriminator_apply(d, x, jt.cfg)
    l_fake = jnets.discriminator_apply(
        d, jnets.generator_apply(g, z, jt.cfg), jt.cfg)
    want_d = (jcommon.bce_logits_mean(l_real, jnp.ones_like(l_real))
              + jcommon.bce_logits_mean(l_fake, jnp.zeros_like(l_fake)))
    want_g = (jcommon.bce_logits_mean(l_fake, jnp.ones_like(l_fake))
              if variant == "nsgan" else
              -jcommon.bce_logits_mean(l_fake, jnp.zeros_like(l_fake)))
    spec = get_variant(variant)
    batch = {"image": torch.from_numpy(x)}
    zt = torch.from_numpy(z)
    got_d, metrics = spec.d_loss(t.state["d_params"], t.state["g_params"],
                                 batch, None, {}, t.cfg, z=zt)
    got_g, _ = spec.g_loss(t.state["g_params"], t.state["d_params"], batch,
                           None, {}, t.cfg, z=zt)
    np.testing.assert_allclose(float(got_d), float(want_d), **F32)
    np.testing.assert_allclose(float(got_g), float(want_g), **F32)
    np.testing.assert_allclose(float(metrics["d_real"]),
                               float(jnp.mean(l_real)), **F32)


def test_bce_logits_matches_jax_at_extreme_logits():
    logits = np.array([-80.0, -5.0, -1e-3, 0.0, 2.5, 90.0], np.float32)
    for target in (0.0, 1.0):
        t = np.full_like(logits, target)
        np.testing.assert_allclose(
            common.bce_logits(torch.from_numpy(logits),
                              torch.from_numpy(t)).numpy(),
            np.asarray(jcommon.bce_logits(logits, t)), **F32)


def test_compute_noise_is_seeded_and_shaped():
    a = common.compute_noise(torch.Generator().manual_seed(3), 5, 7)
    b = common.compute_noise(torch.Generator().manual_seed(3), 5, 7)
    assert a.shape == (5, 7) and a.dtype == torch.float32
    assert torch.equal(a, b)


def test_checkpoint_of_other_width_raises(tiny_data, tmp_path):
    jt, path = _save_jax(tiny_data, tmp_path / "ck.npz", **_overrides("tiny"))
    t = Trainer(config=_port_cfg(jt.cfg).replace(hidden_dim=48), device="cpu")
    with pytest.raises(ValueError, match="refusing to silently"):
        t.load_model(path)


@pytest.mark.parametrize("saved,wanted", [(0.0, 0.5), (0.5, 0.0)],
                         ids=["ema_missing", "ema_unexpected"])
def test_checkpoint_ema_mismatch_raises(tiny_data, tmp_path, saved, wanted):
    jt, path = _save_jax(tiny_data, tmp_path / "ck.npz",
                         **_overrides("tiny", ema_decay=saved))
    cfg = _port_cfg(jt.cfg).replace(ema_decay=wanted)
    with pytest.raises(ValueError, match="mismatch"):
        load_jax_checkpoint(path, cfg)


def test_non_checkpoint_npz_raises(tmp_path):
    path = str(tmp_path / "plain.npz")
    np.savez(path, a=np.zeros(3))
    with pytest.raises(ValueError, match="__meta__"):
        load_jax_checkpoint(path, variant_config("nsgan"))


def test_params_from_numpy_round_trips():
    tree = {"g_params": [{"w": np.arange(6, dtype=np.float32).reshape(2, 3),
                          "b": np.ones(3, np.float32)}],
            "step": 4}
    out = params_from_numpy(tree)
    assert out["step"] == 4
    w = out["g_params"][0]["w"]
    assert isinstance(w, torch.Tensor) and w.dtype == torch.float32
    np.testing.assert_array_equal(w.numpy(), tree["g_params"][0]["w"])
    np.testing.assert_array_equal(out["g_params"][0]["b"].numpy(),
                                  tree["g_params"][0]["b"])


def test_cli_sample_only_writes_png(tiny_data, tmp_path, capsys):
    jt, path = _save_jax(tiny_data, tmp_path / "ck.npz", **_overrides("tiny"))
    flags = ["--z-dim", str(jt.cfg.z_dim), "--hidden-dim",
             str(jt.cfg.hidden_dim), "--sample-n", "16"]
    rc = cli.main(["--variant", "nsgan", "--ckpt", path, "--sample-only",
                   "--device", "cpu", "--out-dir", str(tmp_path), *flags])
    assert rc == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == {"variant": "nsgan", "step": 7, "samples": os.path.join(
        str(tmp_path), "nsgan", "samples_step000007.png")}
    with open(line["samples"], "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"


@pytest.mark.parametrize("flags,named", [
    (["--reflow-from", "t.npz"], "--reflow-from"),
    (["--vq-from", "v.npz"], "--vq-from"),
    (["--tp", "2", "--fused-step"], "--fused-step"),
], ids=["flags1---reflow-from", "flags2---vq-from", "flags3---fused-step"])
def test_cli_unported_paths_are_usage_errors(flags, named, capsys):
    """Every flag is ported now. --reflow-from and --vq-from: with --sample-only (appended below) each is the
    reference's usage error, which names it too; --tp trains, but not on
    the chunk kernels (--fused-step), which assume whole parameters."""
    argv = ["--variant", "nsgan", "--device", "cpu", *flags]
    if named != "--fused-step":
        argv.append("--sample-only")
    with pytest.raises(SystemExit) as e:
        cli.main(argv)
    assert e.value.code == 2
    assert named in capsys.readouterr().err


def test_cli_profile_writes_a_trace_of_training(tmp_path, capsys):
    """--profile is ported (no flag is refused any more): the run writes
    a Chrome trace of its training, which json reads, holding the step's
    ops (the MLP's products) and the Trainer's spans as ``gmt.`` ranges,
    and prints its path before the run's line; the reference wraps the
    same span in a jax.profiler trace."""
    assert cli._NOT_PORTED == {}
    rc = cli.main(["--variant", "nsgan", "--device", "cpu", "--steps", "3",
                   "--batch-size", "16", "--hidden-dim", "32", "--z-dim",
                   "8", "--dataset", "synthetic", "--echo-every", "0",
                   "--profile", "--out-dir", str(tmp_path)])
    assert rc == 0
    lines = capsys.readouterr().out.strip().splitlines()
    path = os.path.join(str(tmp_path), "nsgan", "trace", "rank0.pt.trace.json")
    assert f"trace: {path}" in lines
    assert json.loads(lines[-1])["steps"] == 3
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "aten::mm" in names or "aten::addmm" in names
    # the Trainer's phases ride in the trace as ranges, and stop with it
    assert "gmt.trainer.chunk" in names and "gmt.trainer.launch" in names
    # and each phase's host time is printed after the trace's path
    got = [ln for ln in lines if ln.startswith("spans: ")]
    assert len(got) == 1 and lines.index(got[0]) > lines.index(
        f"trace: {path}")
    phases = json.loads(got[0][len("spans: "):])
    assert phases["trainer.chunk"]["n"] == 1
    for v in phases.values():
        assert 0 <= v["self_ms"] <= v["total_ms"] and v["max_ms"] > 0
    from generative_models_tpu_torch.utils import spans
    assert not spans.on()


def test_cli_profile_settles_the_policy_before_the_trace(tmp_path,
                                                         monkeypatch, capsys):
    """With measurement on, --profile's trace starts after the fused-step
    A/B: "auto" is settled (the policy measured once, the profiler off)
    before training is traced, as the reference settles it when its
    Trainer is built. On the CPU "auto" never asks the policy, so the
    test routes it there as a card does."""
    import torch

    from generative_models_tpu_torch.ops import cuda_train, fused_policy
    seen = []

    def fake_measure(spec, cfg, device):
        seen.append(torch._C._autograd._profiler_enabled())
        return {"fused": 1.0, "general": 2.0, "ab_steps": 4}

    monkeypatch.setenv("GMTPU_FUSED_AB", "1")
    monkeypatch.setenv("GMTPU_POLICY_CACHE", str(tmp_path / "policy.json"))
    monkeypatch.setattr(fused_policy, "_measure_pair", fake_measure)
    monkeypatch.setattr(cuda_train, "resolve_fused_step",
                        lambda spec, cfg, device: fused_policy.resolve_auto(
                            spec, cfg, device))
    rc = cli.main(["--variant", "nsgan", "--device", "cpu", "--steps", "3",
                   "--batch-size", "16", "--hidden-dim", "32", "--z-dim",
                   "8", "--dataset", "synthetic", "--echo-every", "0",
                   "--profile", "--out-dir", str(tmp_path)])
    assert rc == 0
    assert seen == [False]
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])[
        "steps"] == 3


def test_cli_sample_only_without_checkpoint_fails(tmp_path):
    assert cli.main(["--sample-only", "--device", "cpu", "--ckpt",
                     str(tmp_path / "missing.npz")]) == 2


def test_sample_grid_png_is_byte_identical_to_jax(tmp_path):
    imgs = np.random.default_rng(4).uniform(-0.1, 1.1, (11, 784))
    a = save_image_grid(str(tmp_path / "port.png"), imgs)
    b = jax_grid(str(tmp_path / "jax.png"), imgs)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()


@pytest.mark.parametrize("variant", ["vqvae", "flow", "ddpm", "vqprior"])
def test_unported_variants_name_their_roadmap_item(variant):
    """Every variant is ported now: ddpm and flow build their
    time-conditioned net (the reference's tree) with the variant's EMA,
    vqvae its encoder, decoder and codebook, vqprior the prior beside a
    whole vqvae."""
    t = Trainer(variant, device="cpu")
    if variant in ("ddpm", "flow"):
        assert sorted(t.state["params"]) == ["in", "mid", "out", "skip", "t1",
                                             "t2", "time"]
        assert sorted(t.state["ema"]) == sorted(t.state["params"])
        return
    vq = t.state["params"] if variant == "vqvae" else t.state["params"][
        "vqvae"]
    assert sorted(vq) == ["codebook", "decoder", "encoder"]
    assert tuple(vq["codebook"].shape) == (64, 16)
    if variant == "vqprior":
        assert sorted(t.state["params"]) == ["prior", "vqvae"]
        assert sorted(t.state["params"]["prior"]) == [
            "blocks", "head", "ln_f", "pos", "tok"]


def test_conv_arch_is_not_ported():
    """The conv stacks are ported now (models/conv.py), so the Trainer
    builds them; what stays unported on them is tensor parallelism, which
    the config refuses, as the reference's does."""
    t = Trainer("nsgan", device="cpu", arch="conv")
    assert sorted(t.state["g_params"]) == ["fc", "gn0", "gn1", "up1", "up2"]
    assert sorted(t.state["d_params"]) == ["fc", "trunk"]
    with pytest.raises(ValueError, match="conv"):
        Trainer("nsgan", device="cpu", arch="conv", tp=2)
