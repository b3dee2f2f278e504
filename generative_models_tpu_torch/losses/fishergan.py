"""Fisher GAN (Mroueh & Sercu 2017) — the port of
``generative_models_tpu/losses/fishergan.py``. An IPM objective with a
variance constraint enforced by an augmented Lagrangian:

    E(f)    = E_x[f(x)] - E_z[f(G(z))]
    Omega   = 1/2 E_x[f(x)^2] + 1/2 E_z[f(G(z))^2]       (target: 1)
    L(f, lam) = E(f) + lam*(1 - Omega) - rho/2*(1 - Omega)^2

Critic: gradient ASCENT on L (d_loss = -L, lam held constant).
Multiplier: gradient DESCENT, a state update outside autograd, after
every critic update and with that update's constraint value:
    lam <- lam - rho * (1 - Omega)
Generator: minimizes the IPM, g_loss = -E_z[f(G(z))]. ``vstate`` holds
``lam`` as a 0-dim float32 tensor on the state's device.
"""

from __future__ import annotations

import torch

from generative_models_tpu_torch.losses.base import AdversarialSpec
from generative_models_tpu_torch.losses.common import global_mean
from generative_models_tpu_torch.losses.minimax import _noise, _sample
from generative_models_tpu_torch.models import nets


def _d_loss(d_params, g_params, batch, gen, vstate, cfg, z=None,
            axis_name=None):
    x = batch["image"]
    z = _noise(gen, x.shape[0], cfg, g_params, z)
    fake = nets.generator_apply(g_params, z, cfg)
    f_real = nets.discriminator_apply(d_params, x, cfg)
    f_fake = nets.discriminator_apply(d_params, fake, cfg)
    ipm = global_mean(f_real, axis_name) - global_mean(f_fake, axis_name)
    omega = 0.5 * global_mean(f_real ** 2, axis_name) + \
        0.5 * global_mean(f_fake ** 2, axis_name)
    constraint = 1.0 - omega
    lam = vstate["lam"]
    lagrangian = ipm + lam * constraint - 0.5 * cfg.fisher_rho * constraint ** 2
    loss = -lagrangian
    return loss, {"d_loss": loss, "ipm": ipm, "omega": omega,
                  "constraint": constraint}


def _d_state_update(vstate, d_metrics, cfg):
    return {"lam": vstate["lam"] - cfg.fisher_rho * d_metrics["constraint"]}


def _g_loss(g_params, d_params, batch, gen, vstate, cfg, z=None,
            axis_name=None):
    z = _noise(gen, batch["image"].shape[0], cfg, g_params, z)
    fake = nets.generator_apply(g_params, z, cfg)
    loss = -global_mean(nets.discriminator_apply(d_params, fake, cfg),
                        axis_name)
    return loss, {"g_loss": loss}


def _init_vstate(cfg):
    return {"lam": torch.zeros((), dtype=torch.float32)}


FISHERGAN = AdversarialSpec(
    name="fishergan",
    init_g=nets.generator_init,
    init_d=nets.discriminator_init,
    d_loss=_d_loss,
    g_loss=_g_loss,
    d_state_update=_d_state_update,
    init_vstate=_init_vstate,
    sample=_sample,
    batch_coupled=True,
)
