"""One fused ``act(x @ W + b)`` through the whole-MLP kernel with one
layer — the port of ``generative_models_tpu/ops/pallas_linear.py``."""

from __future__ import annotations

from generative_models_tpu_torch.ops.cuda_mlp import mlp_fwd


def linear_cuda(x, w, b, act: str = "none", slope: float = 0.2,
                compute_dtype=None):
    out, _ = mlp_fwd(x, [w], [b], (act,), slope, compute_dtype)
    return out
