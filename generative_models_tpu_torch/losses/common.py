"""Shared numerics for the loss heads — the port of
``generative_models_tpu/losses/common.py``.

D is a logit head and the BCE is the logit-stable form:
    BCE(sigmoid(l), t) = max(l, 0) - t*l + log1p(exp(-|l|))
"""

from __future__ import annotations

import torch


def bce_logits(logits, targets):
    """Elementwise binary cross-entropy on logits (stable)."""
    return (torch.clamp_min(logits, 0.0) - logits * targets
            + torch.log1p(torch.exp(-torch.abs(logits))))


def bce_logits_mean(logits, targets):
    return torch.mean(bce_logits(logits, targets))


def compute_noise(gen: torch.Generator, n: int, z_dim: int, device=None):
    """z ~ N(0, I), drawn from `gen` on its own device and moved to
    `device` (default: the generator's device)."""
    z = torch.randn((n, z_dim), generator=gen, device=gen.device,
                    dtype=torch.float32)
    return z if device is None else z.to(device)
