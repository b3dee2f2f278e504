"""Activation registry — torch twin of ``generative_models_tpu/ops/activations.py``.

Same names and the same functions; ``slope`` is read by leaky_relu only.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

ACTIVATIONS = {
    "none": lambda x, slope: x,
    "relu": lambda x, slope: torch.clamp_min(x, 0.0),
    "leaky_relu": lambda x, slope: torch.where(x >= 0, x, slope * x),
    "sigmoid": lambda x, slope: torch.sigmoid(x),
    "tanh": lambda x, slope: torch.tanh(x),
    "softplus": lambda x, slope: F.softplus(x),
    "elu": lambda x, slope: F.elu(x),
    "silu": lambda x, slope: x * torch.sigmoid(x),
    "gelu": lambda x, slope: F.gelu(x, approximate="tanh"),
}


def apply_act(x, act: str, slope: float = 0.2):
    try:
        fn = ACTIVATIONS[act]
    except KeyError:
        raise ValueError(
            f"unknown activation {act!r}; known: {sorted(ACTIVATIONS)}")
    return fn(x, slope)
