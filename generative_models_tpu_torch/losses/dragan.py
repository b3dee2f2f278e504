"""DRAGAN — Deep Regret Analytic GAN (Kodali et al. 2017) — the port of
``generative_models_tpu/losses/dragan.py``. NS-GAN losses plus a
gradient penalty around PERTURBED REAL data only:

    x_hat = x + 0.5 * std(x) * U(0,1)     (std over the whole batch, ddof 0)
    L_D += lam * E[(||grad_{x_hat} D(x_hat)|| - 1)^2],  lam = 10

The penalty's critic pass is the twice-differentiable plain one
(``ops/penalty.py``). ``aux=`` is the penalty's draw ``u [B, X]``;
without it the head draws it from `gen` after z. d_steps 1.
"""

from __future__ import annotations

import torch

from generative_models_tpu_torch.losses.base import AdversarialSpec
from generative_models_tpu_torch.losses.common import bce_logits_mean
from generative_models_tpu_torch.losses.minimax import _g_loss_ns, _noise, _sample
from generative_models_tpu_torch.models import nets
from generative_models_tpu_torch.ops.penalty import (
    aux_draw,
    gradient_penalty,
    perturb_real,
)


def _d_loss(d_params, g_params, batch, gen, vstate, cfg, z=None, aux=None):
    x = batch["image"]
    z = _noise(gen, x.shape[0], cfg, g_params, z)
    if aux is None:
        aux = aux_draw(gen, x.shape[0], cfg, x.device)
    fake = nets.generator_apply(g_params, z, cfg)
    l_real = nets.discriminator_apply(d_params, x, cfg)
    l_fake = nets.discriminator_apply(d_params, fake, cfg)
    bce = bce_logits_mean(l_real, torch.ones_like(l_real)) + \
        bce_logits_mean(l_fake, torch.zeros_like(l_fake))
    x_hat = perturb_real(x, cfg.dragan_noise_scale, aux)
    gp, grad_norm = gradient_penalty(
        lambda p, xx: nets.discriminator_apply_plain(p, xx, cfg), d_params,
        x_hat, cfg.gp_lambda)
    loss = bce + gp
    return loss, {"d_loss": loss, "gp": gp, "grad_norm": grad_norm}


DRAGAN = AdversarialSpec(
    name="dragan",
    init_g=nets.generator_init,
    init_d=nets.discriminator_init,
    d_loss=_d_loss,
    g_loss=_g_loss_ns,
    sample=_sample,
    needs_second_order=True,
)
