"""Sample-quality scoring — the port of
``generative_models_tpu/utils/quality.py``.

A small MLP classifier (784 -> 128 ReLU -> 10, ``models/mlp.py``: on the
card its forward and backward run through the whole-MLP kernels) is
trained on the real train split, and generated samples are scored with
Inception-Score-style statistics under it:

- ``confidence``: mean max class probability (sharpness),
- ``class_entropy``: entropy of the MEAN predicted class distribution
  (diversity; ln(10) ~ 2.303 is uniform),
- ``is_score``: exp(E_x[KL(p(y|x) || p(y))]), the IS formula with the
  zoo classifier standing in for Inception.

:func:`fid_score` is the Fréchet distance in the classifier's hidden
feature space, computed in float64 with numpy as the reference does.

The classifier trains with Adam in optax's convention at 1e-3
(``train/optim.py``) on softmax cross-entropy, its initial weights and
batch indices drawn from an explicit ``torch.Generator``. Every function
runs on the device of the parameters it is given; ``train_classifier``
on `device`, the card unless the caller asks for the CPU.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from generative_models_tpu_torch.models.mlp import mlp_apply, mlp_init
from generative_models_tpu_torch.train.optim import adam_update
from generative_models_tpu_torch.utils.tree import (
    tree_leaves,
    tree_map,
    tree_unflatten,
)

LR = 1e-3
B1, B2, EPS = 0.9, 0.999, 1e-8   # optax.adam's defaults


def _as_tensor(x, device, dtype=torch.float32) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor)
                           else x, dtype=dtype, device=device)


def _device(params) -> torch.device:
    return params[0]["w"].device


def _logits(params, x) -> torch.Tensor:
    return mlp_apply(params, x, hidden_act="relu", out_act="none")


def classifier_loss(params, xb, yb) -> torch.Tensor:
    """Mean softmax cross-entropy of the classifier's logits against the
    integer labels `yb`."""
    return F.cross_entropy(_logits(params, xb), yb)


def classifier_step(params, opt, xb, yb):
    """One Adam step of the classifier on the batch (xb, yb): returns
    ``(params, opt, loss)``."""
    leaves = [t.detach().requires_grad_(True) for t in tree_leaves(params)]
    live = tree_unflatten(params, leaves)
    loss = classifier_loss(live, xb, yb)
    grads = tree_unflatten(params, list(torch.autograd.grad(loss, leaves)))
    params, opt = adam_update(tree_unflatten(params, [t.detach()
                                                      for t in leaves]),
                              grads, opt, LR, B1, B2, EPS)
    return params, opt, loss.detach()


def train_classifier(x_train, y_train, gen: torch.Generator = None,
                     steps: int = 500, batch: int = 256, hidden: int = 128,
                     num_classes: int = 10, device="cuda") -> List[dict]:
    """Classifier params (a 784 -> hidden -> num_classes MLP, the layer
    list of ``models/mlp.py``) after `steps` Adam steps on batches of
    `batch` rows drawn with replacement. `gen` (a CPU generator; default
    seeded 0) draws the initial weights, then every step's indices."""
    gen = torch.Generator().manual_seed(0) if gen is None else gen
    dev = torch.device(device)
    xs = _as_tensor(x_train, dev)
    ys = _as_tensor(y_train, dev, torch.int64)
    params = mlp_init(gen, [xs.shape[-1], hidden, num_classes], dev)
    idx = torch.randint(0, xs.shape[0], (steps, batch), generator=gen).to(dev)
    opt = {"count": torch.zeros((), dtype=torch.int32, device=dev),
           "mu": tree_map(torch.zeros_like, params),
           "nu": tree_map(torch.zeros_like, params)}
    for i in range(steps):
        params, opt, _ = classifier_step(params, opt, xs[idx[i]], ys[idx[i]])
    return params


@torch.no_grad()
def classifier_accuracy(params, x, y) -> float:
    dev = _device(params)
    pred = torch.argmax(_logits(params, _as_tensor(x, dev)), dim=-1)
    return float(torch.mean((pred == _as_tensor(y, dev, torch.int64))
                            .to(torch.float32)))


@torch.no_grad()
def _features(params, x) -> torch.Tensor:
    """Penultimate-layer (hidden) activations of the classifier, the
    feature space of :func:`fid_score`."""
    return mlp_apply(params[:-1], _as_tensor(x, _device(params)),
                     hidden_act="relu", out_act="relu")


def fid_score(params, real, fake, eps: float = 1e-6) -> float:
    """Fréchet distance between real and generated samples in the
    classifier's hidden feature space:

        ||mu_r - mu_f||^2 + tr(C_r + C_f - 2 (C_r C_f)^{1/2})

    in float64, the square root's trace through the eigenvalues of the
    symmetric C_r^{1/2} C_f C_r^{1/2} (negative ones from rounding
    clamped). Lower is better; 0 = matched feature statistics."""
    fr = _features(params, real).cpu().numpy().astype(np.float64)
    ff = _features(params, fake).cpu().numpy().astype(np.float64)
    mu_r, mu_f = fr.mean(0), ff.mean(0)
    c_r = np.cov(fr, rowvar=False) + eps * np.eye(fr.shape[1])
    c_f = np.cov(ff, rowvar=False) + eps * np.eye(ff.shape[1])
    w_r, v_r = np.linalg.eigh(c_r)
    sq_r = (v_r * np.sqrt(np.clip(w_r, 0, None))) @ v_r.T
    w = np.linalg.eigvalsh(sq_r @ c_f @ sq_r)
    tr_sqrt = np.sum(np.sqrt(np.clip(w, 0, None)))
    d2 = float(np.sum((mu_r - mu_f) ** 2)
               + np.trace(c_r) + np.trace(c_f) - 2.0 * tr_sqrt)
    return max(d2, 0.0)


@torch.no_grad()
def score_samples(params, samples) -> Dict[str, float]:
    p = torch.softmax(_logits(params, _as_tensor(samples, _device(params))),
                      dim=-1)
    p_mean = torch.mean(p, dim=0)
    eps = 1e-10
    kl = torch.sum(p * (torch.log(p + eps) - torch.log(p_mean + eps)), dim=-1)
    return {
        "confidence": float(torch.mean(torch.max(p, dim=-1).values)),
        "class_entropy": float(-torch.sum(p_mean * torch.log(p_mean + eps))),
        "is_score": float(torch.exp(torch.mean(kl))),
    }
