"""LSGAN — least-squares GAN (Mao et al. 2017) — the port of
``generative_models_tpu/losses/lsgan.py``. Labels (a, b, c) = (0, 1, 1):

    L_D = 1/2 E_x[(D(x) - 1)^2] + 1/2 E_z[D(G(z))^2]
    L_G = 1/2 E_z[(D(G(z)) - 1)^2]

The D head is linear: the raw critic output is used directly.
"""

from __future__ import annotations

import torch

from generative_models_tpu_torch.losses.base import AdversarialSpec
from generative_models_tpu_torch.losses.minimax import _noise, _sample
from generative_models_tpu_torch.models import nets


def _d_loss(d_params, g_params, batch, gen, vstate, cfg, z=None):
    x = batch["image"]
    z = _noise(gen, x.shape[0], cfg, g_params, z)
    fake = nets.generator_apply(g_params, z, cfg)
    d_real = nets.discriminator_apply(d_params, x, cfg)
    d_fake = nets.discriminator_apply(d_params, fake, cfg)
    loss = 0.5 * torch.mean((d_real - 1.0) ** 2) + 0.5 * torch.mean(d_fake ** 2)
    return loss, {"d_loss": loss, "d_real": torch.mean(d_real),
                  "d_fake": torch.mean(d_fake)}


def _g_loss(g_params, d_params, batch, gen, vstate, cfg, z=None):
    z = _noise(gen, batch["image"].shape[0], cfg, g_params, z)
    fake = nets.generator_apply(g_params, z, cfg)
    d_fake = nets.discriminator_apply(d_params, fake, cfg)
    loss = 0.5 * torch.mean((d_fake - 1.0) ** 2)
    return loss, {"g_loss": loss}


LSGAN = AdversarialSpec(
    name="lsgan",
    init_g=nets.generator_init,
    init_d=nets.discriminator_init,
    d_loss=_d_loss,
    g_loss=_g_loss,
    sample=_sample,
)
