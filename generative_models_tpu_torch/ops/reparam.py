"""VAE sampling path: reparameterisation and the closed-form Gaussian KL
— the port of ``generative_models_tpu/ops/reparam.py`` (the plain
formulas and the dispatch).

With explicit noise (``eps=``, as tests and cross-checks pass it) the
plain formulas run. Without it the noise is drawn inside the sampling
kernel (``ops/cuda_reparam.py``): two seed words come from the caller's
``torch.Generator`` and key the kernel's counter-based generator — on a
CUDA tensor the kernel, on a CPU tensor its plain version. The reference
takes its kernel only under ``use_pallas``; the port, as for the MLP
kernels, takes it for every CUDA tensor.
"""

from __future__ import annotations

import torch

from generative_models_tpu_torch.ops.cuda_reparam import ReparamFunction


def reparameterize_plain(mu, logvar, eps):
    return mu + torch.exp(0.5 * logvar) * eps


def kl_gaussian_plain(mu, logvar):
    """KL(N(mu, sigma^2) || N(0, I)) summed over latent dims:
    -1/2 sum(1 + logvar - mu^2 - exp(logvar)). Shape [B]."""
    return -0.5 * torch.sum(1.0 + logvar - mu ** 2 - torch.exp(logvar),
                            dim=-1)


def reparam_and_kl(mu, logvar, gen: torch.Generator = None, *, eps=None):
    """``(z [B, L], kl [B])``, differentiable in mu and logvar. Pass
    either `eps` (the noise itself) or `gen` (the generator that seeds
    the kernel's noise)."""
    if eps is not None:
        return reparameterize_plain(mu, logvar, eps), kl_gaussian_plain(
            mu, logvar)
    if gen is None:
        raise ValueError("reparam_and_kl needs a generator or explicit eps")
    seed = torch.randint(0, 2 ** 32, (2,), dtype=torch.int64, generator=gen,
                         device=gen.device).to(mu.device)
    return ReparamFunction.apply(mu.contiguous(), logvar.contiguous(), seed, 0)
