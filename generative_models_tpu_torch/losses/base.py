"""Loss-head spec types — the port of ``generative_models_tpu/losses/base.py``.

A variant is a declarative spec of functions. The port's signatures take
a ``torch.Generator`` where the reference takes a JAX key, and an
optional explicit noise tensor (``z`` for the adversarial heads, ``eps``
for a single model's loss): tests hand the same noise to both packages,
since the two generators draw different numbers.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import torch

Params = Any
Batch = Dict[str, Any]
Metrics = Dict[str, Any]
VState = Dict[str, Any]


def _identity_post(d_params, cfg):
    return d_params


def _identity_dstate(vstate, d_metrics, cfg):
    return vstate


def _identity_step_state(vstate, d_metrics, g_metrics, cfg):
    return vstate


def _empty_vstate(cfg) -> VState:
    return {}


def _latent_lanes(cfg) -> int:
    return cfg.latent_dim


def _draw_latent(gen, lead, cfg, device):
    return torch.randn(tuple(lead) + (cfg.latent_dim,), generator=gen,
                       device=gen.device).to(device)


@dataclasses.dataclass(frozen=True)
class AdversarialSpec:
    name: str
    init_g: Callable  # (gen, cfg, device=) -> g_params
    init_d: Callable  # (gen, cfg, device=) -> d_params
    # (d_params, g_params, batch, gen, vstate, cfg, z=None) -> (loss, metrics)
    d_loss: Callable
    # (g_params, d_params, batch, gen, vstate, cfg, z=None) -> (loss, metrics)
    g_loss: Callable
    sample: Callable  # (g_params, gen, n, cfg, z=None) -> [n, image_dim] in [0,1]
    d_post: Callable = _identity_post
    d_state_update: Callable = _identity_dstate
    step_state_update: Callable = _identity_step_state
    init_vstate: Callable = _empty_vstate
    adversarial: bool = True
    # gradient-penalty objectives need grad-of-grad (reference: they pin
    # the non-kernel op path)
    needs_second_order: bool = False
    # losses that couple samples through batch statistics
    batch_coupled: bool = False


@dataclasses.dataclass(frozen=True)
class SingleModelSpec:
    name: str
    init_params: Callable  # (gen, cfg, device=) -> params
    # (params, batch, gen, cfg, eps=None) -> (loss, metrics)
    loss: Callable
    sample: Callable       # (params, gen, n, cfg, z=None) -> [n, image_dim]
    adversarial: bool = False
    batch_coupled: bool = False
    # a step's noise: draw_noise(gen, lead, cfg, device) -> [*lead,
    # step_lanes(cfg)], the `eps` the loss takes (VAE family: N(0, I) of
    # latent_dim; diffusion: the noise, t and the label-drop uniform)
    step_lanes: Callable = _latent_lanes
    draw_noise: Callable = _draw_latent
    # the width of sample's z
    sample_lanes: Callable = _latent_lanes
    # sample also takes `chain`: step i -> that step's noise [n,
    # sample_lanes(cfg)] (DDPM's reverse chain; vqprior's Gumbel draws)
    chain_noise: bool = False
    # noise_of_normal(draws, cfg): standard-normal draws [n,
    # sample_lanes(cfg)] -> the noise sample takes as z and from chain
    # (vqvae's tokens, vqprior's Gumbel draws); None: they are that noise.
    # The exported sampler draws normals (utils/export.py)
    noise_of_normal: Optional[Callable] = None
