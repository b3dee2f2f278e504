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


def _refuse_axis(what: str, axis_name) -> None:
    if axis_name is not None:
        raise NotImplementedError(
            f"{what} over a mesh axis are not ported to "
            "generative_models_tpu_torch yet (ROADMAP.md Queue 1 item 12, "
            "parallelism)")


def global_mean(x, axis_name=None):
    """Scalar mean of x over all samples of the batch. `axis_name` (the
    reference's mesh axis, over which a data-parallel shard's mean is
    averaged) is refused until the port has a parallel path."""
    _refuse_axis("means", axis_name)
    return torch.mean(x)


def global_moments_axis0(x, axis_name=None, eps: float = 0.0):
    """(mean, var) of x per feature (axis 0 = batch), each [1, F]. The
    variance is E[x^2] - E[x]^2 clamped at `eps`, as the reference takes
    it. `axis_name` (the reference's mesh axis for data-parallel
    moments) is refused until the port has a parallel path (ROADMAP.md
    Queue 1 item 12)."""
    _refuse_axis("moments", axis_name)
    m = torch.mean(x, dim=0, keepdim=True)
    m2 = torch.mean(x * x, dim=0, keepdim=True)
    return m, torch.clamp_min(m2 - m * m, eps)
