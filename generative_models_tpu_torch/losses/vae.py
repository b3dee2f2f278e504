"""VAE (Kingma & Welling 2013) — the port of
``generative_models_tpu/losses/vae.py``. Gaussian encoder q(z|x) =
N(mu(x), sigma^2(x)), reparameterisation z = mu + sigma * eps, Bernoulli
decoder.

    loss = BCE(recon, x, summed over pixels) + KL(q || N(0, I))

averaged over the batch. One optimizer, no G/D alternation. The general
step (``train/step.py``) differentiates this loss with torch autograd;
the chunk kernel (``ops/cuda_train_vae.py``) hand-derives the same
gradients.
"""

from __future__ import annotations

import torch

from generative_models_tpu_torch.losses.base import SingleModelSpec
from generative_models_tpu_torch.losses.common import bce_logits, compute_noise
from generative_models_tpu_torch.models import nets
from generative_models_tpu_torch.ops.reparam import reparam_and_kl
from generative_models_tpu_torch.utils.tree import tree_device


def init_params(gen, cfg, device="cpu"):
    """Encoder first, then decoder, from one generator."""
    return {"encoder": nets.encoder_init(gen, cfg, device),
            "decoder": nets.decoder_init(gen, cfg, device)}


def _bce_sum_logits(logits, x):
    """Per-sample sum over pixels of BCE(sigmoid(logits), x), stable."""
    return torch.sum(bce_logits(logits, x), dim=-1)


def loss(params, batch, gen, cfg, eps=None):
    x = batch["image"]
    mu, logvar = nets.encoder_apply(params["encoder"], x, cfg)
    z, kl = reparam_and_kl(mu, logvar, gen, eps=eps)
    if cfg.vae_recon == "bce":
        logits = nets.decoder_apply(params["decoder"], z, cfg, logits=True)
        recon = _bce_sum_logits(logits, x)
    else:
        out = nets.decoder_apply(params["decoder"], z, cfg)
        recon = torch.sum((out - x) ** 2, dim=-1)
    recon_mean = torch.mean(recon)
    kl_mean = torch.mean(kl)
    total = recon_mean + kl_mean
    return total, {"loss": total, "recon_loss": recon_mean,
                   "kl_loss": kl_mean}


def sample(params, gen, n, cfg, z=None):
    if z is None:
        z = compute_noise(gen, n, cfg.latent_dim,
                          device=tree_device(params["decoder"]))
    return nets.decoder_apply(params["decoder"], z, cfg)


@torch.no_grad()
def reconstruct(params, x, gen, cfg, eps=None):
    """Encode -> sample z -> decode (the reconstruction view)."""
    mu, logvar = nets.encoder_apply(params["encoder"], x, cfg)
    z, _ = reparam_and_kl(mu, logvar, gen, eps=eps)
    return nets.decoder_apply(params["decoder"], z, cfg)


VAE = SingleModelSpec(
    name="vae",
    init_params=init_params,
    loss=loss,
    sample=sample,
)
