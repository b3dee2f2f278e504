"""One fused ``act(x @ W + b)`` through the whole-MLP kernels with one
layer — the port of ``generative_models_tpu/ops/pallas_linear.py``.
It goes through :class:`MLPFunction`, so it trains on the card: the
backward kernel gives dW, db and dx. ``launches`` counts its forward
launches (each also counted by ``cuda_mlp.launches``)."""

from __future__ import annotations

from generative_models_tpu_torch.ops.cuda_mlp import MLPFunction


launches = 0


def linear_cuda(x, w, b, act: str = "none", slope: float = 0.2,
                compute_dtype=None):
    global launches
    out = MLPFunction.apply(x, (act,), slope, compute_dtype, w, b)
    if x.device.type == "cuda":
        launches += 1
    return out
