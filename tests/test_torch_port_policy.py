"""The port's measured "auto" policies against the JAX package's:
``ops/fused_policy.py`` (``fused_step="auto"``) and
``config.py::resolve_dtype`` (``dtype="auto"``).

The policy's cases are those of ``tests/test_fused_step.py``'s
``test_resolve_auto_measured_policy`` and
``test_resolve_auto_refingerprint_and_ttl``, on the port's
``resolve_auto`` with ``_measure_pair`` faked; the port's static rule
(the chunk kernel wherever it covers the config) takes the place of the
reference's list of TPU winners. ``policy_key`` is the reference's
string for every variant, and ``resolve_dtype(cfg, "cpu")`` the
reference's. ``_measure_pair`` itself runs on the CPU through the chunk's
plain version at the suite's tiny widths.
"""

import numpy as np
import pytest
import torch

from conftest import TINY
from generative_models_tpu.config import resolve_dtype as jax_resolve_dtype
from generative_models_tpu.config import variant_config as jax_config
from generative_models_tpu.ops import fused_policy as jax_fp
from generative_models_tpu_torch import config as port_config
from generative_models_tpu_torch.config import (
    VARIANTS,
    resolve_dtype,
    variant_config,
)
from generative_models_tpu_torch.losses.registry import get_variant
from generative_models_tpu_torch.ops import cuda_train
from generative_models_tpu_torch.ops import fused_policy as fp
from generative_models_tpu_torch.parallel.runs import state_numpy
from generative_models_tpu_torch.train.trainer import Trainer

KW = {k: TINY[k] for k in ("batch_size", "hidden_dim", "z_dim", "latent_dim",
                            "vae_hidden_dim", "began_ae_hidden", "seed")}


def _rates(fused, general):
    return lambda s, c, d: {"fused": fused, "general": general}


@pytest.fixture
def measuring(monkeypatch, tmp_path):
    monkeypatch.setenv("GMTPU_POLICY_CACHE", str(tmp_path / "p.json"))
    monkeypatch.setenv("GMTPU_FUSED_AB", "1")
    monkeypatch.setenv("GMTPU_HOST_FP", "card-a")


def test_resolve_auto_measured_policy(monkeypatch, measuring):
    """A slow kernel flips the verdict to the general step; the cache
    sticks; a new shape re-measures; a tie (within 1%) goes to the
    general step; a failed measurement returns the static rule (the
    kernel) and is not cached; with measurement off, the static rule."""
    spec, cfg = get_variant("nsgan"), variant_config("nsgan")
    monkeypatch.setattr(fp, "_measure_pair", _rates(50.0, 100.0))
    assert fp.resolve_auto(spec, cfg) is False
    monkeypatch.setattr(fp, "_measure_pair", _rates(300.0, 100.0))
    assert fp.resolve_auto(spec, cfg) is False       # the cache holds
    assert fp.resolve_auto(spec, variant_config("nsgan", batch_size=256))
    monkeypatch.setattr(fp, "_measure_pair", _rates(100.5, 100.0))
    assert fp.resolve_auto(
        spec, variant_config("nsgan", batch_size=128)) is False

    def boom(s, c, d):
        raise RuntimeError("kernel exploded")
    monkeypatch.setattr(fp, "_measure_pair", boom)
    cfg64 = variant_config("nsgan", batch_size=64)
    assert fp.resolve_auto(spec, cfg64) is True      # the kernel, not cached
    key = f"{fp.host_tag()}::{fp.policy_key(cfg64)}"
    assert key not in fp._load_cache()
    # a config the kernel does not cover keeps the general step unmeasured
    assert fp.resolve_auto(get_variant("ddpm"),
                           variant_config("ddpm", batch_size=64)) is False
    monkeypatch.setattr(fp, "_measure_pair", _rates(50.0, 100.0))
    assert fp.resolve_auto(spec, cfg64) is False     # measured now
    entry = fp._load_cache()[key]
    assert entry["use_fused"] is False
    assert entry["fused_steps_per_sec"] == 50.0
    assert entry["general_steps_per_sec"] == 100.0

    monkeypatch.setenv("GMTPU_FUSED_AB", "0")
    assert fp.resolve_auto(spec, variant_config("nsgan", batch_size=32))
    assert fp.resolve_auto(get_variant("fgan"), variant_config("fgan"))
    assert fp.resolve_auto(spec, variant_config(
        "nsgan", spectral_projection=True)) is False


def test_resolve_auto_refingerprint_and_ttl(monkeypatch, measuring):
    """Another card (its UUID, here GMTPU_HOST_FP) re-measures and keeps
    the first card's verdict beside its own; an entry past the TTL, or
    without a timestamp, re-measures."""
    spec, cfg = get_variant("nsgan"), variant_config("nsgan")
    monkeypatch.setattr(fp, "_measure_pair", _rates(50.0, 100.0))
    assert fp.resolve_auto(spec, cfg) is False
    monkeypatch.setattr(fp, "_measure_pair", _rates(300.0, 100.0))
    assert fp.resolve_auto(spec, cfg) is False
    monkeypatch.setenv("GMTPU_HOST_FP", "card-b")
    assert fp.resolve_auto(spec, cfg) is True
    monkeypatch.setenv("GMTPU_HOST_FP", "card-a")
    monkeypatch.setattr(fp, "_measure_pair", _rates(999.0, 100.0))
    assert fp.resolve_auto(spec, cfg) is False

    monkeypatch.setenv("GMTPU_POLICY_TTL_S", "3600")
    key = f"{fp.host_tag()}::{fp.policy_key(cfg)}"
    entry = fp._load_cache()[key]
    entry["measured_at"] -= 7200
    fp._store(key, entry)
    assert fp.resolve_auto(spec, cfg) is True
    entry = fp._load_cache()[key]
    del entry["measured_at"]
    entry["use_fused"] = False
    fp._store(key, entry)
    assert fp.resolve_auto(spec, cfg) is True


def test_host_tag_names_the_host_the_card_and_its_uuid(monkeypatch):
    monkeypatch.delenv("GMTPU_HOST_FP", raising=False)
    tag = fp.host_tag()
    parts = tag.split("|")
    assert len(parts) == 3
    if not torch.cuda.is_available():
        assert parts[1:] == ["unknown", "nodev"]
    monkeypatch.setenv("GMTPU_HOST_FP", "uuid-x")
    assert fp.host_tag().endswith("|uuid-x")


def test_resolve_fused_step_follows_the_verdict_on_cuda_only(monkeypatch,
                                                             measuring):
    """"auto" asks the policy on CUDA only where the kernel covers the
    config; the CPU keeps the general step unmeasured; True and False
    keep their meaning."""
    spec, cfg = get_variant("nsgan"), variant_config("nsgan")
    calls = []

    def slow(s, c, d):
        calls.append(str(d))
        return {"fused": 50.0, "general": 100.0}
    monkeypatch.setattr(fp, "_measure_pair", slow)
    assert cuda_train.resolve_fused_step(spec, cfg, "cpu") is False
    assert calls == []
    assert cuda_train.resolve_fused_step(spec, cfg, "cuda") is False
    assert calls == ["cuda"]
    assert cuda_train.resolve_fused_step(
        spec, cfg.replace(fused_step=True), "cpu") is True
    assert cuda_train.resolve_fused_step(
        spec, cfg.replace(fused_step=False), "cuda") is False
    assert cuda_train.resolve_fused_step(
        get_variant("vae"), variant_config("vae", arch="conv"),
        "cuda") is False
    assert calls == ["cuda"]


@pytest.mark.parametrize("variant", VARIANTS)
def test_policy_key_equals_the_reference(variant):
    """The same string on both sides, at the defaults and at the suite's
    tiny widths with an EMA."""
    for kw in ({}, dict(KW, ema_decay=0.999, d_steps=2)):
        assert fp.policy_key(variant_config(variant, **kw)) == \
            jax_fp.policy_key(jax_config(variant, **kw))


def test_policy_key_covers_shape_fields():
    assert fp.policy_key(variant_config("began")) != \
        fp.policy_key(variant_config("began", began_ae_hidden=128))
    assert fp.policy_key(variant_config("infogan")) != \
        fp.policy_key(variant_config("infogan", info_cat_dim=4))
    assert fp.policy_key(variant_config("infogan")) != \
        fp.policy_key(variant_config("infogan", info_cont_dim=0))


BATCHES = (64, 100, 128, 256, 512, 1024, 2048, 4096, 8192)


@pytest.mark.parametrize("arch", ["mlp", "conv"])
def test_resolve_dtype_on_the_cpu_equals_the_reference(arch):
    for b in BATCHES:
        for dtype in ("auto", "float32", "bfloat16"):
            cfg = variant_config("nsgan", arch=arch, batch_size=b,
                                 dtype=dtype)
            jcfg = jax_config("nsgan", arch=arch, batch_size=b, dtype=dtype)
            assert resolve_dtype(cfg, "cpu") == jax_resolve_dtype(jcfg, "cpu")


@pytest.mark.parametrize("crossover", [None, 512])
def test_resolve_dtype_on_the_card_follows_the_crossover(monkeypatch,
                                                         crossover):
    """bf16 for the conv stacks at batches from the card's crossover on;
    the MLP stacks and explicit dtypes never change."""
    monkeypatch.setattr(port_config, "CONV_BF16_CROSSOVER_BATCH", crossover)
    for b in BATCHES:
        want = ("bfloat16" if crossover is not None and b >= crossover
                else "float32")
        conv = variant_config("vae", arch="conv", batch_size=b)
        assert resolve_dtype(conv, "cuda") == want
        assert resolve_dtype(variant_config("vae", batch_size=b),
                             "cuda") == "float32"
        assert resolve_dtype(conv.replace(dtype="float32"),
                             "cuda") == "float32"


def test_the_constant_is_a_batch_or_none():
    c = port_config.CONV_BF16_CROSSOVER_BATCH
    assert c is None or (isinstance(c, int) and c > 0)


def test_trainer_resolves_auto_dtype_on_its_device(monkeypatch):
    """The CPU Trainer trains float32 past any crossover."""
    monkeypatch.setattr(port_config, "CONV_BF16_CROSSOVER_BATCH", 16)
    t = Trainer(config=variant_config("nsgan", arch="conv", conv_channels=4,
                                      **KW), device="cpu")
    assert t.cfg.dtype == "float32"


@pytest.mark.parametrize("variant", ["nsgan", "wgangp", "vae"])
def test_measure_pair_runs_both_arms_on_the_cpu(monkeypatch, variant):
    """Both arms (the chunk's plain version and the general step) run 4
    steps at the tiny widths and report steps/s; the caller's Trainer
    state is untouched."""
    monkeypatch.setenv("GMTPU_FUSED_AB_STEPS", "4")
    cfg = variant_config(variant, **KW)
    t = Trainer(config=cfg, device="cpu")
    before = state_numpy(t.state)
    rates = fp._measure_pair(t.spec, t.cfg, "cpu")
    assert rates["ab_steps"] == 4
    assert rates["fused"] > 0 and rates["general"] > 0
    after = state_numpy(t.state)
    for k in before:
        np.testing.assert_array_equal(after[k], before[k], err_msg=k)
