"""Optimizers — the port of ``generative_models_tpu/train/optim.py``
(``make_tx``'s two rules), as plain functions on any nested tree of
parameter tensors (``utils/tree.py``): the adversarial variants' lists
of ``{"w", "b"}`` layers and the VAE family's nested dicts alike.

- Adam in optax's convention: the count is incremented first, then
  ``m̂ / (√v̂ + eps)`` with ``m̂ = m / (1 - b1^t)``, ``v̂ = v / (1 - b2^t)``.
  State ``{"count": int32 [], "mu": [...], "nu": [...]}``.
- RMSprop as torch has it (decay 0.99, eps 1e-8, no momentum, not
  centred) with eps OUTSIDE the square root: ``g / (√ν + eps)``. optax's
  default eps-inside form is another rule. State ``{"nu": [...]}``.

The state dicts mirror optax's ``ScaleByAdamState`` / ``ScaleByRmsState``
fields, so a checkpoint maps onto them leaf for leaf
(``utils/checkpoint.py``). Updates return new tensors; nothing is
modified in place.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch

from generative_models_tpu_torch.utils.tree import (
    tree_leaves,
    tree_map,
    tree_unflatten,
)

RMS_DECAY = 0.99
RMS_EPS = 1e-8

Params = Any  # a nested dict/list tree of tensors


def _zeros_like(params: Params) -> Params:
    return tree_map(torch.zeros_like, params)


def init_opt(cfg, params: Params) -> dict:
    """A fresh optimizer state for ``cfg.optimizer`` ("adam" | "rmsprop")."""
    if cfg.optimizer == "adam":
        dev = tree_leaves(params)[0].device
        return {"count": torch.zeros((), dtype=torch.int32, device=dev),
                "mu": _zeros_like(params), "nu": _zeros_like(params)}
    if cfg.optimizer == "rmsprop":
        return {"nu": _zeros_like(params)}
    raise ValueError(f"unknown optimizer {cfg.optimizer!r}")


def adam_update(params: Params, grads: Params, state: dict, lr: float,
                b1: float, b2: float, eps: float) -> Tuple[Params, dict]:
    count = state["count"] + 1
    t = count.to(torch.float32)
    bc1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                       device=t.device), t)
    bc2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                       device=t.device), t)
    new_p, new_mu, new_nu = [], [], []
    for p, g, m, v in zip(*map(tree_leaves, (params, grads, state["mu"],
                                             state["nu"]))):
        lm = (1.0 - b1) * g + b1 * m
        lv = (1.0 - b2) * (g * g) + b2 * v
        upd = (lm / bc1) / (torch.sqrt(lv / bc2) + eps)
        new_p.append(p + (-lr) * upd)
        new_mu.append(lm)
        new_nu.append(lv)
    return tree_unflatten(params, new_p), {
        "count": count, "mu": tree_unflatten(params, new_mu),
        "nu": tree_unflatten(params, new_nu)}


def rmsprop_update(params: Params, grads: Params, state: dict,
                   lr: float) -> Tuple[Params, dict]:
    new_p, new_nu = [], []
    for p, g, v in zip(*map(tree_leaves, (params, grads, state["nu"]))):
        lv = (1.0 - RMS_DECAY) * (g * g) + RMS_DECAY * v
        upd = (1.0 / (torch.sqrt(lv) + RMS_EPS)) * g
        new_p.append(p + (-lr) * upd)
        new_nu.append(lv)
    return tree_unflatten(params, new_p), {
        "nu": tree_unflatten(params, new_nu)}


def apply_opt(cfg, params: Params, grads: Params, state: dict,
              lr: float) -> Tuple[Params, dict]:
    """One optimizer step of ``cfg.optimizer`` at learning rate `lr`."""
    if cfg.optimizer == "adam":
        return adam_update(params, grads, state, lr, cfg.adam_b1,
                           cfg.adam_b2, cfg.adam_eps)
    if cfg.optimizer == "rmsprop":
        return rmsprop_update(params, grads, state, lr)
    raise ValueError(f"unknown optimizer {cfg.optimizer!r}")
