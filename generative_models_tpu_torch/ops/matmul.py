"""Float32 matrix products in IEEE float32 on the card, whatever torch's
global TF32 flag says — the products the VQ family leaves to XLA in the
reference (the nearest-code distances, the one-hot codebook lookup and
the prior's attention: ``ops/vq.py``, ``models/ar_prior.py``).

torch lets cuBLAS round float32 operands to TF32 when
``torch.backends.cuda.matmul.allow_tf32`` is True. An argmin over TF32
distances is another function than the reference's, so :func:`matmul`
runs its product, and each product of its backward at any order, with
the flag off (:func:`strict_matmuls`), as ``models/conv.py::strict_convs``
holds cuDNN's convolutions. On the CPU the flag means nothing and the
products run as they are.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def strict_matmuls():
    """cuBLAS's float32 products in IEEE float32 while the block runs."""
    flags = torch.backends.cuda.matmul
    prev = flags.allow_tf32
    flags.allow_tf32 = False
    try:
        yield
    finally:
        flags.allow_tf32 = prev


def _strict(t: torch.Tensor):
    return strict_matmuls() if t.is_cuda else contextlib.nullcontext()


class _MatMul(torch.autograd.Function):
    """a @ b (batch dims equal, or none); its backward is two more of
    itself, g @ b^T and a^T @ g, so no order of differentiation leaves
    the product to the global flag."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        with _strict(a):
            return torch.matmul(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        da = (_MatMul.apply(g, b.transpose(-1, -2))
              if ctx.needs_input_grad[0] else None)
        db = (_MatMul.apply(a.transpose(-1, -2), g)
              if ctx.needs_input_grad[1] else None)
        return da, db


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` of two tensors with the same leading (batch) dims, in
    IEEE float32 on the card, differentiable to any order."""
    if a.shape[:-2] != b.shape[:-2]:
        raise ValueError(f"matmul takes equal batch dims, got {tuple(a.shape)}"
                         f" @ {tuple(b.shape)}")
    return _MatMul.apply(a, b)
