"""MM-GAN and NS-GAN (Goodfellow et al. 2014) — the port of
``generative_models_tpu/losses/minimax.py``. The train step
(``train/step.py``) differentiates these losses with torch autograd; the
chunk kernel (``ops/cuda_train.py``) hand-derives the same gradients.

Shared D objective:      L_D = BCE(D(x), 1) + BCE(D(G(z)), 0)   (logits)
MM-GAN G (saturating):   L_G = -BCE(D(G(z)), 0)
NS-GAN G (heuristic):    L_G =  BCE(D(G(z)), 1)
"""

from __future__ import annotations

import torch

from generative_models_tpu_torch.losses.base import AdversarialSpec
from generative_models_tpu_torch.losses.common import bce_logits_mean, compute_noise
from generative_models_tpu_torch.models import nets
from generative_models_tpu_torch.utils.tree import tree_device


def _noise(gen, n, cfg, params, z):
    if z is not None:
        return z
    return compute_noise(gen, n, cfg.z_dim, device=tree_device(params))


def _d_loss(d_params, g_params, batch, gen, vstate, cfg, z=None):
    x = batch["image"]
    z = _noise(gen, x.shape[0], cfg, g_params, z)
    fake = nets.generator_apply(g_params, z, cfg)
    l_real = nets.discriminator_apply(d_params, x, cfg)
    l_fake = nets.discriminator_apply(d_params, fake, cfg)
    loss = bce_logits_mean(l_real, torch.ones_like(l_real)) + \
        bce_logits_mean(l_fake, torch.zeros_like(l_fake))
    return loss, {"d_loss": loss, "d_real": torch.mean(l_real),
                  "d_fake": torch.mean(l_fake)}


def _g_loss_ns(g_params, d_params, batch, gen, vstate, cfg, z=None):
    z = _noise(gen, batch["image"].shape[0], cfg, g_params, z)
    l_fake = nets.discriminator_apply(
        d_params, nets.generator_apply(g_params, z, cfg), cfg)
    loss = bce_logits_mean(l_fake, torch.ones_like(l_fake))
    return loss, {"g_loss": loss}


def _g_loss_mm(g_params, d_params, batch, gen, vstate, cfg, z=None):
    z = _noise(gen, batch["image"].shape[0], cfg, g_params, z)
    l_fake = nets.discriminator_apply(
        d_params, nets.generator_apply(g_params, z, cfg), cfg)
    # log(1 - sigmoid(l)) = -softplus(l) = -BCE(l, 0)
    loss = -bce_logits_mean(l_fake, torch.zeros_like(l_fake))
    return loss, {"g_loss": loss}


def _sample(g_params, gen, n, cfg, z=None):
    return nets.generator_apply(g_params, _noise(gen, n, cfg, g_params, z), cfg)


NSGAN = AdversarialSpec(
    name="nsgan",
    init_g=nets.generator_init,
    init_d=nets.discriminator_init,
    d_loss=_d_loss,
    g_loss=_g_loss_ns,
    sample=_sample,
)

MMGAN = AdversarialSpec(
    name="mmgan",
    init_g=nets.generator_init,
    init_d=nets.discriminator_init,
    d_loss=_d_loss,
    g_loss=_g_loss_mm,
    sample=_sample,
)
