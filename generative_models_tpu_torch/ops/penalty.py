"""Gradient-penalty primitives (WGAN-GP, DRAGAN) — the port of
``generative_models_tpu/ops/penalty.py``.

The penalty differentiates the critic's input gradient again, with
respect to the critic's parameters: ``torch.autograd.grad(d.sum(),
x_hat, create_graph=True)``, then backward through the result. Because
the critic is per-sample, the gradient of ``sum(D(x_hat))`` with respect
to ``x_hat`` is the batch of per-sample input gradients.

The kernels' autograd function (``ops/cuda_mlp.py::MLPFunction``) has a
backward that is not itself differentiable, so the critic pass inside
the penalty must be the plain one (``models/nets.py::
discriminator_apply_plain``, per-layer torch ops on any device). This
is the reference's rule, narrowed: the JAX Trainer keeps a spec with
``needs_second_order`` off its Pallas kernels for the whole step
(``generative_models_tpu/train/trainer.py:85``); the port does so only
for this one pass, and every other forward and backward of the step
still launches the kernels. :data:`plain_passes` counts the penalty's
critic passes, beside the kernels' launch counts.

The uniform draws are taken explicitly (``eps [B, 1]``, ``u [B, X]``):
torch cannot replay JAX's threefry draws, so the caller passes them.
"""

from __future__ import annotations

import torch

plain_passes = 0


def input_gradients(d_apply, d_params, x):
    """Per-sample gradients dD/dx, shape = x.shape, with a graph so that
    they can be differentiated again (also under ``torch.no_grad``).

    d_apply: (params, x[B, D]) -> scores [B]."""
    global plain_passes
    with torch.enable_grad():
        if not x.requires_grad:
            x = x.detach().requires_grad_(True)
        plain_passes += 1
        d = d_apply(d_params, x)
        return torch.autograd.grad(d.sum(), x, create_graph=True)[0]


def gradient_penalty(d_apply, d_params, x_hat, lam: float,
                     eps: float = 1e-12):
    """lam * E[(||dD/dx_hat||_2 - 1)^2]. Returns (penalty, mean_norm).

    The eps inside the sqrt keeps the norm differentiable at 0."""
    g = input_gradients(d_apply, d_params, x_hat)
    norms = torch.sqrt(torch.sum(g * g, dim=-1) + eps)
    return lam * torch.mean((norms - 1.0) ** 2), torch.mean(norms)


def interpolate(real, fake, eps):
    """WGAN-GP x_hat = eps*real + (1-eps)*fake, `eps` [B, 1] ~ U(0, 1)
    per sample."""
    return eps * real + (1.0 - eps) * fake


def aux_lanes(variant: str, image_dim: int) -> int:
    """Lanes a sample of a penalty head's draw has: wgangp's eps 1,
    dragan's u ``image_dim``; 0 for a head without a penalty."""
    return {"wgangp": 1, "dragan": image_dim}.get(variant, 0)


def aux_draw(gen, n: int, cfg, device):
    """The penalty's uniform draw [n, lanes] from `gen`."""
    return torch.rand((n, aux_lanes(cfg.variant, cfg.image_dim)),
                      generator=gen, device=gen.device).to(device)


def perturb_real(real, scale: float, u):
    """DRAGAN x_hat = x + scale * std(x) * u, `u` ~ U(0, 1) elementwise;
    std is the population std over every element (ddof 0, as
    ``jnp.std``)."""
    return real + scale * torch.std(real, correction=0) * u
