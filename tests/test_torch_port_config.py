"""The PyTorch port's Config against the JAX package's: the same fields,
defaults, per-variant overrides, validation and CLI flags."""

import dataclasses

import pytest

from generative_models_tpu import cli as jax_cli
from generative_models_tpu import config as jcfg
from generative_models_tpu_torch import cli
from generative_models_tpu_torch import config as tcfg


def test_fields_defaults_and_annotations_match():
    def fields(mod):
        return [(f.name, f.default, str(f.type))
                for f in dataclasses.fields(mod.Config)]
    assert fields(tcfg) == fields(jcfg)
    assert tcfg.VARIANTS == jcfg.VARIANTS


@pytest.mark.parametrize("arch", ["mlp", "conv"])
@pytest.mark.parametrize("variant", jcfg.VARIANTS)
def test_variant_config_matches_jax(variant, arch):
    assert (dataclasses.asdict(tcfg.variant_config(variant, arch=arch))
            == dataclasses.asdict(jcfg.variant_config(variant, arch=arch)))


def test_flow_guidance_default_matches_jax():
    kw = dict(ddpm_cond=True)
    assert (tcfg.variant_config("flow", **kw).ddpm_guidance
            == jcfg.variant_config("flow", **kw).ddpm_guidance == 0.3)


@pytest.mark.parametrize("variant,overrides", [
    ("nsgan", {"arch": "resnet"}),
    ("nsgan", {"dtype": "float16"}),
    ("nsgan", {"ema_decay": 1.0}),
    ("vae", {"spectral_projection": True}),
    ("nsgan", {"flow_reflow": True}),
    ("ddpm", {"ddpm_guidance": 1.0}),
    ("vqprior", {"vq_prior_width": 130}),
    ("fgan", {"fgan_divergence": "wasserstein"}),
    ("nsgan", {"fused_step": "sometimes"}),
])
def test_validation_errors_match_jax(variant, overrides):
    with pytest.raises(ValueError):
        jcfg.variant_config(variant, **overrides)
    with pytest.raises(ValueError):
        tcfg.variant_config(variant, **overrides)


def test_fgan_divergence_names_match_jax():
    from generative_models_tpu.losses.fgan import DIVERGENCES
    assert sorted(tcfg.FGAN_DIVERGENCES) == sorted(DIVERGENCES)


def test_cli_config_flags_match_jax():
    def config_flags(parser):
        names = {f.name for f in dataclasses.fields(jcfg.Config)}
        return {a.option_strings[0]: type(a).__name__ + str(a.type)
                for a in parser._actions if a.dest in names}
    assert (config_flags(cli.build_parser())
            == config_flags(jax_cli.build_parser()))
