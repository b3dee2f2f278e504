"""CGAN — conditional GAN (Mirza & Osindero 2014) — the port of
``generative_models_tpu/losses/cgan.py``. The one-hot label y is
concatenated to G's input (z ⊕ y) and to D's (x ⊕ y); the losses are
NS-GAN's. The G update takes the labels of the last critic batch (the
train step hands it that batch). Sampling cycles the classes
(``arange(n) % num_classes``), so a grid shows one column per digit;
:func:`sample_class` draws one class.
"""

from __future__ import annotations

import torch

from generative_models_tpu_torch.losses.base import AdversarialSpec
from generative_models_tpu_torch.losses.common import bce_logits_mean
from generative_models_tpu_torch.losses.minimax import _noise
from generative_models_tpu_torch.models import nets


def _d_loss(d_params, g_params, batch, gen, vstate, cfg, z=None):
    x, y = batch["image"], batch["label"]
    z = _noise(gen, x.shape[0], cfg, g_params, z)
    fake = nets.cond_generator_apply(g_params, z, y, cfg)
    l_real = nets.cond_discriminator_apply(d_params, x, y, cfg)
    l_fake = nets.cond_discriminator_apply(d_params, fake, y, cfg)
    loss = bce_logits_mean(l_real, torch.ones_like(l_real)) + \
        bce_logits_mean(l_fake, torch.zeros_like(l_fake))
    return loss, {"d_loss": loss, "d_real": torch.mean(l_real),
                  "d_fake": torch.mean(l_fake)}


def _g_loss(g_params, d_params, batch, gen, vstate, cfg, z=None):
    y = batch["label"]
    z = _noise(gen, y.shape[0], cfg, g_params, z)
    fake = nets.cond_generator_apply(g_params, z, y, cfg)
    l_fake = nets.cond_discriminator_apply(d_params, fake, y, cfg)
    loss = bce_logits_mean(l_fake, torch.ones_like(l_fake))
    return loss, {"g_loss": loss}


def _sample(g_params, gen, n, cfg, z=None):
    """Class-cycled samples: row i has label i % num_classes."""
    z = _noise(gen, n, cfg, g_params, z)
    y = torch.arange(n, device=z.device) % cfg.num_classes
    return nets.cond_generator_apply(g_params, z, y, cfg)


def sample_class(g_params, gen, n, label, cfg, z=None):
    z = _noise(gen, n, cfg, g_params, z)
    y = torch.full((n,), label, dtype=torch.int64, device=z.device)
    return nets.cond_generator_apply(g_params, z, y, cfg)


CGAN = AdversarialSpec(
    name="cgan",
    init_g=nets.cond_generator_init,
    init_d=nets.cond_discriminator_init,
    d_loss=_d_loss,
    g_loss=_g_loss,
    sample=_sample,
)
