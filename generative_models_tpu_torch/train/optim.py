"""Optimizers — the port of ``generative_models_tpu/train/optim.py``
(``make_tx``'s two rules), as plain functions on parameter lists of
``{"w", "b"}`` tensors.

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

from typing import Dict, List, Tuple

import torch

RMS_DECAY = 0.99
RMS_EPS = 1e-8

Params = List[Dict[str, torch.Tensor]]


def _zeros_like(params: Params) -> Params:
    return [{k: torch.zeros_like(v) for k, v in l.items()} for l in params]


def init_opt(cfg, params: Params) -> dict:
    """A fresh optimizer state for ``cfg.optimizer`` ("adam" | "rmsprop")."""
    if cfg.optimizer == "adam":
        dev = params[0]["w"].device
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
    for p, g, m, v in zip(params, grads, state["mu"], state["nu"]):
        lp, lm, lv = {}, {}, {}
        for k in p:
            lm[k] = (1.0 - b1) * g[k] + b1 * m[k]
            lv[k] = (1.0 - b2) * (g[k] * g[k]) + b2 * v[k]
            upd = (lm[k] / bc1) / (torch.sqrt(lv[k] / bc2) + eps)
            lp[k] = p[k] + (-lr) * upd
        new_p.append(lp)
        new_mu.append(lm)
        new_nu.append(lv)
    return new_p, {"count": count, "mu": new_mu, "nu": new_nu}


def rmsprop_update(params: Params, grads: Params, state: dict,
                   lr: float) -> Tuple[Params, dict]:
    new_p, new_nu = [], []
    for p, g, v in zip(params, grads, state["nu"]):
        lp, lv = {}, {}
        for k in p:
            lv[k] = (1.0 - RMS_DECAY) * (g[k] * g[k]) + RMS_DECAY * v[k]
            upd = (1.0 / (torch.sqrt(lv[k]) + RMS_EPS)) * g[k]
            lp[k] = p[k] + (-lr) * upd
        new_p.append(lp)
        new_nu.append(lv)
    return new_p, {"nu": new_nu}


def apply_opt(cfg, params: Params, grads: Params, state: dict,
              lr: float) -> Tuple[Params, dict]:
    """One optimizer step of ``cfg.optimizer`` at learning rate `lr`."""
    if cfg.optimizer == "adam":
        return adam_update(params, grads, state, lr, cfg.adam_b1,
                           cfg.adam_b2, cfg.adam_eps)
    if cfg.optimizer == "rmsprop":
        return rmsprop_update(params, grads, state, lr)
    raise ValueError(f"unknown optimizer {cfg.optimizer!r}")
