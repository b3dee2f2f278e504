"""Fused linear (+bias +activation) — the port of
``generative_models_tpu/ops/linear.py``.

- :func:`linear_plain` — ``x @ w + b`` then the activation, in plain
  PyTorch (the twin of the reference's ``linear_xla``).
- :func:`fused_linear` — the tensor's device picks the path: a CPU
  tensor goes to :func:`linear_plain`, any other to the hand-written
  kernel (``ops/cuda_linear.py``), which runs on CUDA or raises. The reference's global
  ``set_backend`` switch has no counterpart.

The kernel holds the activations of ``ops/cuda_mlp.py::SUPPORTED_ACTS``
(its backward derives act' from the layer's output, which ``silu`` and
``gelu`` do not allow). Any other activation of ``ACTIVATIONS``
(``silu``, ``gelu``, ``softplus``, ``elu``) runs the product on the
kernel with act ``"none"`` and then :func:`apply_act`, so the product
stays on the kernel; the reference computes the same function by
another route, giving the whole layer to XLA
(``ops/pallas_mlp.py::mlp_apply_pallas``). A name outside
``ACTIVATIONS`` raises before any launch.
"""

from __future__ import annotations

import torch

from generative_models_tpu_torch.ops.activations import ACTIVATIONS, apply_act
from generative_models_tpu_torch.ops.cuda_linear import linear_cuda
from generative_models_tpu_torch.ops.cuda_mlp import SUPPORTED_ACTS, round_bf16
from generative_models_tpu_torch.utils import spans


def linear_plain(x, w, b, act: str = "none", slope: float = 0.2,
                 compute_dtype=None):
    """y = act(x @ w + b), accumulated in float32. With
    ``compute_dtype=torch.bfloat16`` both operands are rounded to bf16
    first, as the reference's ``linear_xla`` casts them."""
    if compute_dtype == torch.bfloat16:
        x, w = round_bf16(x), round_bf16(w)
    return apply_act(torch.matmul(x, w) + b, act, slope)


def fused_linear(x, w, b, act: str = "none", slope: float = 0.2,
                 compute_dtype=None):
    if x.device.type == "cpu":
        return linear_plain(x, w, b, act=act, slope=slope,
                            compute_dtype=compute_dtype)
    with spans.span("linear.launch"):
        if act in SUPPORTED_ACTS:
            return linear_cuda(x, w, b, act=act, slope=slope,
                               compute_dtype=compute_dtype)
        if act not in ACTIVATIONS:
            apply_act(x, act)  # raises, naming the known activations
        return apply_act(linear_cuda(x, w, b, act="none",
                                     compute_dtype=compute_dtype), act, slope)
