"""Variant registry: name -> loss-head spec — the port of
``generative_models_tpu/losses/registry.py``: all 18 of the reference's
variants. A variant listed in ``_NOT_PORTED`` would raise and name the
ROADMAP.md item that ports it.
"""

from __future__ import annotations

import importlib
from typing import Dict, Tuple

# name -> (module, attribute)
_SPECS: Dict[str, Tuple[str, str]] = {
    "mmgan": ("generative_models_tpu_torch.losses.minimax", "MMGAN"),
    "nsgan": ("generative_models_tpu_torch.losses.minimax", "NSGAN"),
    "lsgan": ("generative_models_tpu_torch.losses.lsgan", "LSGAN"),
    "wgan": ("generative_models_tpu_torch.losses.wgan", "WGAN"),
    "fgan": ("generative_models_tpu_torch.losses.fgan", "FGAN"),
    "ragan": ("generative_models_tpu_torch.losses.ragan", "RAGAN"),
    "fishergan": ("generative_models_tpu_torch.losses.fishergan",
                  "FISHERGAN"),
    "wgangp": ("generative_models_tpu_torch.losses.wgangp", "WGANGP"),
    "dragan": ("generative_models_tpu_torch.losses.dragan", "DRAGAN"),
    "cgan": ("generative_models_tpu_torch.losses.cgan", "CGAN"),
    "began": ("generative_models_tpu_torch.losses.began", "BEGAN"),
    "infogan": ("generative_models_tpu_torch.losses.infogan", "INFOGAN"),
    "vae": ("generative_models_tpu_torch.losses.vae", "VAE"),
    "birvae": ("generative_models_tpu_torch.losses.birvae", "BIRVAE"),
    "ddpm": ("generative_models_tpu_torch.losses.ddpm", "DDPM"),
    "flow": ("generative_models_tpu_torch.losses.flow", "FLOW"),
    "vqvae": ("generative_models_tpu_torch.losses.vqvae", "VQVAE"),
    "vqprior": ("generative_models_tpu_torch.losses.vqprior", "VQPRIOR"),
}

# name -> the ROADMAP.md item that ports it (every variant is ported)
_NOT_PORTED: Dict[str, str] = {}


def available_variants():
    return sorted(_SPECS)


def get_variant(name: str):
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"variant {name!r} is not yet ported to "
            f"generative_models_tpu_torch (ROADMAP.md {_NOT_PORTED[name]})")
    try:
        module, attr = _SPECS[name]
    except KeyError:
        raise ValueError(
            f"unknown variant {name!r}; available: {available_variants()}")
    return getattr(importlib.import_module(module), attr)
