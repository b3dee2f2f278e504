"""BIR-VAE — Bounded-Information-Rate VAE (Braithwaite & Kleijn 2018),
the port of ``generative_models_tpu/losses/birvae.py``. Against the
plain VAE:

- the encoder outputs a MEAN only; the channel noise has a FIXED
  variance chosen from a target information rate I (bits):
  sigma^2 = 4^(-I / latent_dim);
- latents are batch-normalised to zero mean and unit power per dim so
  the rate bound holds (no learned scale or shift);
- no KL term: the reconstruction likelihood is maximised through the
  fixed channel, and sampling uses the unit Gaussian prior.
"""

from __future__ import annotations

import torch

from generative_models_tpu_torch.losses.base import SingleModelSpec
from generative_models_tpu_torch.losses.common import (
    bce_logits,
    compute_noise,
    global_moments_axis0,
)
from generative_models_tpu_torch.models import nets
from generative_models_tpu_torch.models.mlp import linear_init, mlp_apply, mlp_init
from generative_models_tpu_torch.utils.tree import tree_device

BN_EPS = 1e-5


def init_params(gen, cfg, device="cpu"):
    """Trunk, mean head, decoder, drawn in that order from one generator."""
    return {
        "enc_trunk": mlp_init(gen, [cfg.image_dim, cfg.vae_hidden_dim],
                              device),
        "enc_mu": linear_init(gen, cfg.vae_hidden_dim, cfg.latent_dim,
                              device),
        "decoder": nets.decoder_init(gen, cfg, device),
    }


def encode(params, x, cfg):
    h = mlp_apply(params["enc_trunk"], x, hidden_act="relu", out_act="relu")
    return mlp_apply([params["enc_mu"]], h, out_act="none")


def noise_sigma(cfg) -> float:
    return float(4.0 ** (-cfg.birvae_bits / cfg.latent_dim)) ** 0.5


def loss(params, batch, gen, cfg, eps=None, group=None):
    x = batch["image"]
    mu = encode(params, x, cfg)
    mean, var = global_moments_axis0(mu, group)
    mu_hat = (mu - mean) * torch.rsqrt(var + BN_EPS)
    if eps is None:
        eps = torch.randn(mu_hat.shape, generator=gen, device=gen.device,
                          dtype=torch.float32).to(mu_hat.device)
    z = mu_hat + noise_sigma(cfg) * eps
    if cfg.vae_recon == "bce":
        logits = nets.decoder_apply(params["decoder"], z, cfg, logits=True)
        recon = torch.sum(bce_logits(logits, x), dim=-1)
    else:
        out = nets.decoder_apply(params["decoder"], z, cfg)
        recon = torch.sum((out - x) ** 2, dim=-1)
    total = torch.mean(recon)
    return total, {"loss": total, "recon_loss": total,
                   "latent_power": torch.mean(mu_hat ** 2)}


def sample(params, gen, n, cfg, z=None):
    if z is None:
        z = compute_noise(gen, n, cfg.latent_dim,
                          device=tree_device(params["decoder"]))
    return nets.decoder_apply(params["decoder"], z, cfg)


BIRVAE = SingleModelSpec(
    name="birvae",
    init_params=init_params,
    loss=loss,
    sample=sample,
    batch_coupled=True,
)
