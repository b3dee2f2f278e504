"""WGAN-GP — Wasserstein GAN with gradient penalty (Gulrajani et al.
2017) — the port of ``generative_models_tpu/losses/wgangp.py``. No
weight clipping; instead

    L_D = E[D(G(z))] - E[D(x)] + lam * E[(||grad_{x_hat} D(x_hat)|| - 1)^2]
    x_hat = eps*x + (1-eps)*G(z),  eps ~ U(0,1) per sample,  lam = 10

The fake in x_hat is detached (the reference's ``stop_gradient``). The
penalty's critic pass is the twice-differentiable plain one
(``ops/penalty.py``). ``aux=`` is the penalty's draw ``eps [B, 1]``;
without it the head draws it from `gen` after z. Adam(1e-4, betas=(0.5,
0.9)), d_steps 5 (registry defaults).
"""

from __future__ import annotations

import torch

from generative_models_tpu_torch.losses.base import AdversarialSpec
from generative_models_tpu_torch.losses.minimax import _noise, _sample
from generative_models_tpu_torch.models import nets
from generative_models_tpu_torch.ops.penalty import (
    aux_draw,
    gradient_penalty,
    interpolate,
)


def _d_loss(d_params, g_params, batch, gen, vstate, cfg, z=None, aux=None):
    x = batch["image"]
    z = _noise(gen, x.shape[0], cfg, g_params, z)
    if aux is None:
        aux = aux_draw(gen, x.shape[0], cfg, x.device)
    fake = nets.generator_apply(g_params, z, cfg)
    d_real = nets.discriminator_apply(d_params, x, cfg)
    d_fake = nets.discriminator_apply(d_params, fake, cfg)
    x_hat = interpolate(x, fake.detach(), aux)
    gp, grad_norm = gradient_penalty(
        lambda p, xx: nets.discriminator_apply_plain(p, xx, cfg), d_params,
        x_hat, cfg.gp_lambda)
    w = torch.mean(d_fake) - torch.mean(d_real)
    loss = w + gp
    return loss, {"d_loss": loss, "w_estimate": -w, "gp": gp,
                  "grad_norm": grad_norm}


def _g_loss(g_params, d_params, batch, gen, vstate, cfg, z=None):
    z = _noise(gen, batch["image"].shape[0], cfg, g_params, z)
    fake = nets.generator_apply(g_params, z, cfg)
    loss = -torch.mean(nets.discriminator_apply(d_params, fake, cfg))
    return loss, {"g_loss": loss}


WGANGP = AdversarialSpec(
    name="wgangp",
    init_g=nets.generator_init,
    init_d=nets.discriminator_init,
    d_loss=_d_loss,
    g_loss=_g_loss,
    sample=_sample,
    needs_second_order=True,
)
