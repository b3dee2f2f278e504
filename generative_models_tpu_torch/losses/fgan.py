"""f-GAN — variational f-divergence minimization (Nowozin et al. 2016) —
the port of ``generative_models_tpu/losses/fgan.py``. The bound

    F(G, V) = E_x[ g_f(V(x)) ] - E_z[ f*( g_f(V(G(z))) ) ]

is maximized over the critic V (L_D = -F) and minimized over G. Each
divergence is an (output activation g_f, Fenchel conjugate f*) pair from
the paper's Tables 2 and 6, chosen by ``cfg.fgan_divergence``.

G objective: ``cfg.fgan_g_loss="saturating"`` (the default) minimizes F,
L_G = -E_z[f*(g_f(V(G(z))))]; ``"nonsaturating"`` is Nowozin §3.2's
alternative L_G = -E_z[g_f(V(G(z)))].
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict

import torch
import torch.nn.functional as F

from generative_models_tpu_torch.losses.base import AdversarialSpec
from generative_models_tpu_torch.losses.minimax import _noise, _sample
from generative_models_tpu_torch.models import nets


@dataclasses.dataclass(frozen=True)
class Divergence:
    """g_f maps the raw critic output v into the domain of f*; conjugate
    is f*(t). Fenchel-Young: f(u) >= u*t - f*(t)."""
    name: str
    g_f: Callable
    conjugate: Callable


_LOG2 = math.log(2.0)

DIVERGENCES: Dict[str, Divergence] = {d.name: d for d in [
    Divergence("total_variation",
               g_f=lambda v: 0.5 * torch.tanh(v),
               conjugate=lambda t: t),
    Divergence("kl",
               g_f=lambda v: v,
               conjugate=lambda t: torch.exp(t - 1.0)),
    Divergence("reverse_kl",
               g_f=lambda v: -torch.exp(-v),
               conjugate=lambda t: -1.0 - torch.log(-t)),
    Divergence("pearson",
               g_f=lambda v: v,
               conjugate=lambda t: 0.25 * t * t + t),
    Divergence("squared_hellinger",
               g_f=lambda v: 1.0 - torch.exp(-v),
               conjugate=lambda t: t / (1.0 - t)),
    Divergence("jensen_shannon",
               g_f=lambda v: _LOG2 - F.softplus(-v),
               conjugate=lambda t: -torch.log(2.0 - torch.exp(t))),
    Divergence("gan",
               g_f=lambda v: -F.softplus(-v),
               conjugate=lambda t: -torch.log(1.0 - torch.exp(t))),
]}


def get_divergence(name: str) -> Divergence:
    try:
        return DIVERGENCES[name]
    except KeyError:
        raise ValueError(
            f"unknown f-divergence {name!r}; known: {sorted(DIVERGENCES)}")


def _d_loss(d_params, g_params, batch, gen, vstate, cfg, z=None):
    div = get_divergence(cfg.fgan_divergence)
    x = batch["image"]
    z = _noise(gen, x.shape[0], cfg, g_params, z)
    fake = nets.generator_apply(g_params, z, cfg)
    t_real = div.g_f(nets.discriminator_apply(d_params, x, cfg))
    t_fake = div.g_f(nets.discriminator_apply(d_params, fake, cfg))
    bound = torch.mean(t_real) - torch.mean(div.conjugate(t_fake))
    loss = -bound
    return loss, {"d_loss": loss, "f_bound": bound}


def _g_loss(g_params, d_params, batch, gen, vstate, cfg, z=None):
    div = get_divergence(cfg.fgan_divergence)
    z = _noise(gen, batch["image"].shape[0], cfg, g_params, z)
    fake = nets.generator_apply(g_params, z, cfg)
    t_fake = div.g_f(nets.discriminator_apply(d_params, fake, cfg))
    if cfg.fgan_g_loss == "nonsaturating":
        loss = -torch.mean(t_fake)
    else:
        loss = -torch.mean(div.conjugate(t_fake))
    return loss, {"g_loss": loss}


FGAN = AdversarialSpec(
    name="fgan",
    init_g=nets.generator_init,
    init_d=nets.discriminator_init,
    d_loss=_d_loss,
    g_loss=_g_loss,
    sample=_sample,
)
