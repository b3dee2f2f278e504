"""Vector-quantization primitives (van den Oord, Vinyals & Kavukcuoglu
2017, §3.1-3.2) — the port of ``generative_models_tpu/ops/vq.py``.

- Nearest-code search as one product: argmin_k ||z - e_k||^2 =
  argmin_k (||e_k||^2 - 2 z·e_k), the ||z||^2 term dropped
  (:func:`code_distances`); ``argmin`` keeps the first index on ties, as
  ``jnp.argmin`` does.
- Codebook lookup as ``one_hot(idx) @ E`` (:func:`lookup`): exact in
  float32, and its backward is the product ``one_hot^T @ g``.
- The straight-through estimator ``z + (z_q - z).detach()``.

The reference has no kernel for any of these: its products are XLA's.
Here they are cuBLAS's, through ``ops/matmul.py::matmul``, which keeps
them in IEEE float32 on the card whatever the global TF32 flag says.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from generative_models_tpu_torch.ops.matmul import matmul


def code_distances(z, codebook):
    """||e_k||^2 - 2 z·e_k [..., K] for z [..., D] and codebook [K, D]
    (squared distances shifted by the argmin-invariant ||z||^2)."""
    e_sq = torch.sum(codebook ** 2, dim=-1)
    cross = matmul(z.reshape(-1, z.shape[-1]), codebook.t())
    return e_sq - 2.0 * cross.reshape(*z.shape[:-1], codebook.shape[0])


def lookup(idx, codebook):
    """Codebook rows at integer indices idx [...] -> [..., D]."""
    oh = F.one_hot(idx.reshape(-1).long(), codebook.shape[0]).to(
        codebook.dtype)
    return matmul(oh, codebook).reshape(*idx.shape, codebook.shape[1])


def quantize(z, codebook):
    """(indices [...], z_q [..., D]): each row of z snapped to its nearest
    code. Not differentiated through: pair with :func:`straight_through`."""
    with torch.no_grad():
        idx = torch.argmin(code_distances(z, codebook), dim=-1)
    return idx, lookup(idx, codebook)


def straight_through(z, z_q):
    """Forward value z_q, backward identity to z (Oord 2017 §3.2)."""
    return z + (z_q - z).detach()


def perplexity(idx, codebook_size: int):
    """exp(entropy) of the code histogram over all of idx: codebook_size
    at uniform usage, 1 at total collapse."""
    oh = F.one_hot(idx.reshape(-1).long(), codebook_size).to(torch.float32)
    p = torch.mean(oh, dim=0)
    return torch.exp(-torch.sum(p * torch.log(p + 1e-10)))


def code_margin(z, codebook) -> float:
    """The nearest-code search's smallest relative gap: over the rows of
    z, min (d_2nd - d_best) / max_k (||e_k||^2 + 2 |z·e_k|), the distances
    :func:`code_distances` computes. A gap within float32 rounding of 0
    picks another code on another device or summation order: a jump of
    the function, not an error of either. Tests and the chip smoke take
    data whose margin clears a bound fixed before measuring."""
    with torch.no_grad():
        e_sq = torch.sum(codebook ** 2, dim=-1)
        cross = (z.reshape(-1, z.shape[-1]) @ codebook.t())
        d = e_sq - 2.0 * cross
        two = torch.topk(d, 2, dim=-1, largest=False).values
        scale = (e_sq + 2.0 * cross.abs()).max(dim=-1).values
        return float(((two[:, 1] - two[:, 0]) / scale).min())
