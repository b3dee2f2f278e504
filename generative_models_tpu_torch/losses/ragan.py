"""RaGAN — relativistic average GAN (Jolicoeur-Martineau 2018), RaSGAN
form — the port of ``generative_models_tpu/losses/ragan.py``. With critic
logits C(.):

    D~(x)    = C(x)    - E_fake[C(G(z))]
    D~(G(z)) = C(G(z)) - E_real[C(x)]

    L_D = BCE(D~(x), 1)    + BCE(D~(G(z)), 0)
    L_G = BCE(D~(G(z)), 1) + BCE(D~(x), 0)

L_G touches REAL data: the train step hands the G update the last critic
batch.
"""

from __future__ import annotations

import torch

from generative_models_tpu_torch.losses.base import AdversarialSpec
from generative_models_tpu_torch.losses.common import (
    bce_logits_mean,
    global_mean,
)
from generative_models_tpu_torch.losses.minimax import _noise, _sample
from generative_models_tpu_torch.models import nets


def _rel_logits(d_params, g_params, batch, gen, cfg, z, group=None):
    x = batch["image"]
    z = _noise(gen, x.shape[0], cfg, g_params, z)
    fake = nets.generator_apply(g_params, z, cfg)
    c_real = nets.discriminator_apply(d_params, x, cfg)
    c_fake = nets.discriminator_apply(d_params, fake, cfg)
    d_real = c_real - global_mean(c_fake, group)
    d_fake = c_fake - global_mean(c_real, group)
    return d_real, d_fake


def _d_loss(d_params, g_params, batch, gen, vstate, cfg, z=None,
            group=None):
    d_real, d_fake = _rel_logits(d_params, g_params, batch, gen, cfg, z,
                                 group)
    loss = bce_logits_mean(d_real, torch.ones_like(d_real)) + \
        bce_logits_mean(d_fake, torch.zeros_like(d_fake))
    return loss, {"d_loss": loss}


def _g_loss(g_params, d_params, batch, gen, vstate, cfg, z=None,
            group=None):
    d_real, d_fake = _rel_logits(d_params, g_params, batch, gen, cfg, z,
                                 group)
    loss = bce_logits_mean(d_fake, torch.ones_like(d_fake)) + \
        bce_logits_mean(d_real, torch.zeros_like(d_real))
    return loss, {"g_loss": loss}


RAGAN = AdversarialSpec(
    name="ragan",
    init_g=nets.generator_init,
    init_d=nets.discriminator_init,
    d_loss=_d_loss,
    g_loss=_g_loss,
    sample=_sample,
    batch_coupled=True,
)
