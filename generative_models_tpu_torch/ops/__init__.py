"""Fused ops: the activation registry, the fused linear and the
hand-written CUDA kernels with their plain PyTorch versions."""

from generative_models_tpu_torch.ops.activations import ACTIVATIONS, apply_act
from generative_models_tpu_torch.ops.linear import fused_linear, linear_plain

__all__ = ["ACTIVATIONS", "apply_act", "fused_linear", "linear_plain"]
