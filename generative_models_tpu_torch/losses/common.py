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


def global_mean(x, group=None):
    """Scalar mean of x over all samples of the global batch: under data
    parallelism (`group`, ``parallel/mesh.py::DataGroup``, in place of
    the reference's mesh axis) each rank's mean of its shard is averaged
    over the ranks, differentiably; equal shard sizes make that the exact
    global mean."""
    from generative_models_tpu_torch.parallel.mesh import all_reduce_mean
    return all_reduce_mean(torch.mean(x), group)


def global_moments_axis0(x, group=None, eps: float = 0.0):
    """(mean, var) of x per feature (axis 0 = batch), each [1, F], over
    the global batch (`group`: as :func:`global_mean`). The variance is
    E[x^2] - E[x]^2 clamped at `eps`, as the reference takes it, so it
    needs one all-reduce of the two moments."""
    from generative_models_tpu_torch.parallel.mesh import all_reduce_mean
    m = torch.mean(x, dim=0, keepdim=True)
    m2 = torch.mean(x * x, dim=0, keepdim=True)
    if group is not None:
        m, m2 = all_reduce_mean(torch.cat([m, m2]), group).split(1)
    return m, torch.clamp_min(m2 - m * m, eps)
