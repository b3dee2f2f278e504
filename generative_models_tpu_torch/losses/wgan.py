"""WGAN — Wasserstein GAN with weight clipping (Arjovsky et al. 2017) —
the port of ``generative_models_tpu/losses/wgan.py``. Critic (linear
head):

    L_D = E_z[D(G(z))] - E_x[D(x)]        (minimize)
    L_G = -E_z[D(G(z))]                    (minimize)

After EVERY critic update all critic tensors, biases too, are clipped to
[-c, c] with c = ``cfg.wgan_clip``: the spec's ``d_post`` hook, which the
train step applies right after the critic's optimizer. The registry
defaults are the paper's: RMSprop at 5e-5 and d_steps 5.
"""

from __future__ import annotations

import torch

from generative_models_tpu_torch.losses.base import AdversarialSpec
from generative_models_tpu_torch.losses.minimax import _noise, _sample
from generative_models_tpu_torch.models import nets
from generative_models_tpu_torch.utils.tree import tree_map


def _d_loss(d_params, g_params, batch, gen, vstate, cfg, z=None):
    x = batch["image"]
    z = _noise(gen, x.shape[0], cfg, g_params, z)
    fake = nets.generator_apply(g_params, z, cfg)
    d_real = nets.discriminator_apply(d_params, x, cfg)
    d_fake = nets.discriminator_apply(d_params, fake, cfg)
    loss = torch.mean(d_fake) - torch.mean(d_real)
    # the negative critic loss estimates the Wasserstein distance
    return loss, {"d_loss": loss, "w_estimate": -loss}


def _g_loss(g_params, d_params, batch, gen, vstate, cfg, z=None):
    z = _noise(gen, batch["image"].shape[0], cfg, g_params, z)
    fake = nets.generator_apply(g_params, z, cfg)
    loss = -torch.mean(nets.discriminator_apply(d_params, fake, cfg))
    return loss, {"g_loss": loss}


def _clip(d_params, cfg):
    c = cfg.wgan_clip
    return tree_map(lambda p: torch.clamp(p, -c, c), d_params)


WGAN = AdversarialSpec(
    name="wgan",
    init_g=nets.generator_init,
    init_d=nets.discriminator_init,
    d_loss=_d_loss,
    g_loss=_g_loss,
    d_post=_clip,
    sample=_sample,
)
