"""The gradient-penalty, conditional, BEGAN, InfoGAN and VAE-family heads
(wgangp, dragan, cgan, began, infogan, vae, birvae) on the conv stacks
against the JAX package's: the loss, every metric and every gradient
leaf agree to rtol 2e-5 / atol 1e-6, the VAE family's to rtol 2e-4 /
atol 2e-5 (``tests/test_torch_port_conv_heads_a.py`` says why, and how
the noise is shared); wgangp's and dragan's penalty runs its double
backward through the conv critic."""

import pytest

from tests.test_torch_port_conv_heads_a import check_head

VARIANTS = ("wgangp", "dragan", "cgan", "began", "infogan", "vae", "birvae")


@pytest.mark.parametrize("variant", VARIANTS)
def test_conv_head_matches_jax(monkeypatch, variant):
    check_head(monkeypatch, variant, seed=VARIANTS.index(variant) + 11)
