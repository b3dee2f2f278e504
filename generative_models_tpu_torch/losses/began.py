"""BEGAN — Boundary Equilibrium GAN (Berthelot et al. 2017) — the port of
``generative_models_tpu/losses/began.py``. The critic is an autoencoder;
a sample's energy is its pixel-mean L1 reconstruction error:

    L(v) = mean_pixels |v - AE(v)|
    L_D = L(x) - k_t * L(G(z))
    L_G = L(G(z))
    k_{t+1} = clip(k_t + lambda_k * (gamma * L(x) - L(G(z))), 0, 1)
    M = L(x) + |gamma * L(x) - L(G(z))|      (convergence measure)

``vstate`` holds ``k`` and ``m`` as 0-dim float32 tensors; the train step
calls :func:`_step_state_update` after each G update with that step's
energies (the last critic update's L(x)).

|.| takes JAX autodiff's derivative: +1 at 0, at +0.0 and -0.0 alike
(``jax.grad(jnp.abs)(0.0)`` is 1.0), where ``torch.abs``'s backward gives
0; so the general step matches the JAX package's at an exact tie. The
chunk kernel follows the TPU kernel instead, which takes ``sign`` (0 at
0): see ``ops/cuda_train.py``.
"""

from __future__ import annotations

import torch

from generative_models_tpu_torch.losses.base import AdversarialSpec
from generative_models_tpu_torch.losses.minimax import _noise, _sample
from generative_models_tpu_torch.models import nets


def abs_jax(d):
    """|d| whose derivative is +1 at d = 0 (and at -0.0), as JAX's."""
    return torch.where(d >= 0, d, -d)


def _energy(d_params, v, cfg):
    """Per-sample L1 reconstruction error, pixel-mean."""
    recon = nets.began_d_apply(d_params, v, cfg)
    return torch.mean(abs_jax(v - recon), dim=-1)


def _d_loss(d_params, g_params, batch, gen, vstate, cfg, z=None):
    x = batch["image"]
    z = _noise(gen, x.shape[0], cfg, g_params, z)
    fake = nets.generator_apply(g_params, z, cfg)
    l_real = torch.mean(_energy(d_params, x, cfg))
    l_fake = torch.mean(_energy(d_params, fake, cfg))
    loss = l_real - vstate["k"] * l_fake
    return loss, {"d_loss": loss, "began_l_real": l_real,
                  "began_l_fake_d": l_fake}


def _g_loss(g_params, d_params, batch, gen, vstate, cfg, z=None):
    z = _noise(gen, batch["image"].shape[0], cfg, g_params, z)
    fake = nets.generator_apply(g_params, z, cfg)
    loss = torch.mean(_energy(d_params, fake, cfg))
    return loss, {"g_loss": loss, "began_l_fake_g": loss}


def _step_state_update(vstate, d_metrics, g_metrics, cfg):
    l_real = d_metrics["began_l_real"]
    l_fake = g_metrics["began_l_fake_g"]
    balance = cfg.began_gamma * l_real - l_fake
    k = torch.clamp(vstate["k"] + cfg.began_lambda_k * balance, 0.0, 1.0)
    return {"k": k, "m": l_real + torch.abs(balance)}


def _init_vstate(cfg):
    return {"k": torch.tensor(cfg.began_k0, dtype=torch.float32),
            "m": torch.tensor(0.0, dtype=torch.float32)}


BEGAN = AdversarialSpec(
    name="began",
    init_g=nets.generator_init,
    init_d=nets.began_d_init,
    d_loss=_d_loss,
    g_loss=_g_loss,
    step_state_update=_step_state_update,
    init_vstate=_init_vstate,
    sample=_sample,
)
