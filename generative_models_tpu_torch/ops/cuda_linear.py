"""One fused ``act(x @ W + b)`` through the whole-MLP kernels with one
layer — the port of ``generative_models_tpu/ops/pallas_linear.py``.
It goes through :class:`MLPFunction`, so it trains on the card: the
backward kernel gives dW, db and dx."""

from __future__ import annotations

from generative_models_tpu_torch.ops.cuda_mlp import MLPFunction


def linear_cuda(x, w, b, act: str = "none", slope: float = 0.2,
                compute_dtype=None):
    return MLPFunction.apply(x, (act,), slope, compute_dtype, w, b)
