"""VQ-VAE (van den Oord, Vinyals & Kavukcuoglu 2017) — the port of
``generative_models_tpu/losses/vqvae.py``. The encoder maps an image to
L code vectors (``models/vq_net.py``), each snapped to its nearest row
of a learned K x D codebook (``ops/vq.py``), and the decoder
reconstructs from them. Per sample, then averaged over the batch:

    L = BCE(decode(z_q), x)          summed over pixels
      + || sg(z_e) - z_q ||^2        the codebook term
      + beta * || z_e - sg(z_q) ||^2 commitment (beta = vq_beta)

the vq terms summed over the L x D grid; gradients reach the encoder
through the straight-through estimator. The step draws no noise
(``step_lanes`` 0).

:func:`sample` decodes uniform random token grids (VQ-VAE alone models
p(x | tokens); ``vqprior`` adds p(tokens)). Its tokens come in as `z`:
integer indices [n, L] (a test hands over the reference's
``jax.random.randint`` draws; the exported sampler maps its Philox
normal draws to them, :func:`tokens_of_normal`), else they are drawn
from the generator.
"""

from __future__ import annotations

import numpy as np
import torch

from generative_models_tpu_torch.losses.base import SingleModelSpec
from generative_models_tpu_torch.losses.common import bce_logits
from generative_models_tpu_torch.models import vq_net
from generative_models_tpu_torch.ops import vq
from generative_models_tpu_torch.utils.tree import tree_device


def init_params(gen, cfg, device="cpu"):
    """Encoder, decoder, then the codebook N(0, 1)/sqrt(D): rows of about
    unit norm, the scale of the encoder's outputs at init."""
    d = cfg.vq_code_dim
    enc = vq_net.encoder_init(gen, cfg, device)
    dec = vq_net.decoder_init(gen, cfg, device)
    book = torch.randn((cfg.vq_codebook_size, d), generator=gen,
                       device=gen.device) / float(np.sqrt(np.float32(d)))
    return {"encoder": enc, "decoder": dec, "codebook": book.to(device)}


def _terms(params, x, cfg):
    """(recon, codebook, commit, idx): the batch means of the three terms
    and the token indices [B, L]. Shared with ``losses/vqprior.py``."""
    z = vq_net.encoder_apply(params["encoder"], x, cfg)        # [B, L, D]
    idx, z_q = vq.quantize(z, params["codebook"])
    logits = vq_net.decoder_apply(params["decoder"],
                                  vq.straight_through(z, z_q), cfg,
                                  logits=True)
    recon = torch.mean(torch.sum(bce_logits(logits, x), dim=-1))
    codebook = torch.mean(torch.sum((z.detach() - z_q) ** 2, dim=(1, 2)))
    commit = torch.mean(torch.sum((z - z_q.detach()) ** 2, dim=(1, 2)))
    return recon, codebook, commit, idx


def loss(params, batch, gen, cfg, eps=None):
    recon, codebook, commit, idx = _terms(params, batch["image"], cfg)
    total = recon + codebook + cfg.vq_beta * commit
    return total, {"loss": total, "recon_loss": recon, "vq_loss": codebook,
                   "commit_loss": commit,
                   "perplexity": vq.perplexity(idx, cfg.vq_codebook_size)}


def encode_tokens(params, x, cfg):
    """Token indices [B, L] of images x [B, 784]."""
    z = vq_net.encoder_apply(params["encoder"], x, cfg)
    return vq.quantize(z, params["codebook"])[0]


def decode_tokens(params, idx, cfg):
    """Images [B, 784] in [0, 1] from token indices [B, L]."""
    return vq_net.decoder_apply(params["decoder"],
                                vq.lookup(idx, params["codebook"]), cfg)


def uniform_of_normal(z):
    """Phi(z): standard-normal draws to uniform ones in [0, 1]."""
    return 0.5 * torch.erfc(-z * float(np.float32(0.5 ** 0.5)))


def tokens_of_normal(z, k: int):
    """Uniform tokens in [0, k) from standard-normal draws z."""
    return torch.clamp(torch.floor(uniform_of_normal(z) * k), 0, k - 1).long()


def sample(params, gen, n, cfg, z=None):
    """n images [n, 784] decoded from uniform token grids: `z` the tokens
    [n, L], else drawn from `gen`."""
    if z is None:
        z = torch.randint(0, cfg.vq_codebook_size,
                          (n, vq_net.num_tokens(cfg)), generator=gen,
                          device=gen.device).to(tree_device(params))
    return decode_tokens(params, z, cfg)


@torch.no_grad()
def reconstruct(params, x, gen, cfg):
    """Encode, quantize, decode (deterministic; `gen` for the interface)."""
    return decode_tokens(params, encode_tokens(params, x, cfg), cfg)


def no_lanes(cfg) -> int:
    return 0


def no_draws(gen, lead, cfg, device):
    return torch.zeros(tuple(lead) + (0,), device=device)


def token_lanes(cfg) -> int:
    return vq_net.num_tokens(cfg)


def noise_of_normal(z, cfg):
    return tokens_of_normal(z, cfg.vq_codebook_size)


VQVAE = SingleModelSpec(
    name="vqvae",
    init_params=init_params,
    loss=loss,
    sample=sample,
    step_lanes=no_lanes,
    draw_noise=no_draws,
    sample_lanes=token_lanes,
    noise_of_normal=noise_of_normal,
)
