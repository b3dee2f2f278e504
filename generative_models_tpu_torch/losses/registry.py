"""Variant registry: name -> loss-head spec — the port of
``generative_models_tpu/losses/registry.py``. Only the variants whose
heads are ported register; every other reference variant raises and
names the ROADMAP.md item that ports it.
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
    "vae": ("generative_models_tpu_torch.losses.vae", "VAE"),
    "birvae": ("generative_models_tpu_torch.losses.birvae", "BIRVAE"),
}

_ADVERSARIAL = "Queue 1 item 6, the other adversarial heads"
_NOT_PORTED: Dict[str, str] = {
    **{v: _ADVERSARIAL for v in ("wgangp", "dragan", "cgan", "began",
                                 "infogan")},
    "ddpm": "Queue 1 item 9, the diffusion family",
    "flow": "Queue 1 item 9, the diffusion family",
    "vqvae": "Queue 1 item 10, the VQ family",
    "vqprior": "Queue 1 item 10, the VQ family",
}


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
