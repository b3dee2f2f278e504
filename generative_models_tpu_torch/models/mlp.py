"""MLP building blocks — the port of ``generative_models_tpu/models/mlp.py``.

Parameters are plain lists of ``{"w": [in, out], "b": [out]}`` tensor
dicts, the reference's layout, so a JAX checkpoint's leaves map onto
them one to one. Initialisation is torch.nn.Linear's default: W and b
~ U(-1/sqrt(fan_in), +1/sqrt(fan_in)), drawn from an explicit
``torch.Generator`` (the draws differ from JAX's; the distribution is
the same).
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from generative_models_tpu_torch.ops.activations import ACTIVATIONS, apply_act
from generative_models_tpu_torch.ops.cuda_mlp import (
    SUPPORTED_ACTS,
    MLPFunction,
    acts_tuple,
)
from generative_models_tpu_torch.ops.linear import linear_plain
from generative_models_tpu_torch.parallel import tp


def linear_init(gen: torch.Generator, in_dim: int, out_dim: int,
                device="cpu") -> dict:
    """One linear layer, torch-default init, drawn on the generator's
    device and moved to `device`. W stored [in, out]."""
    bound = 1.0 / (in_dim ** 0.5)

    def u(*shape):
        t = torch.rand(shape, generator=gen, device=gen.device,
                       dtype=torch.float32)
        return (t * (2 * bound) - bound).to(device)

    return {"w": u(in_dim, out_dim), "b": u(out_dim)}


def mlp_init(gen: torch.Generator, dims: Sequence[int],
             device="cpu") -> List[dict]:
    """Stack of linears: dims = [in, h1, ..., out]."""
    return [linear_init(gen, dims[i], dims[i + 1], device)
            for i in range(len(dims) - 1)]


def mlp_apply_plain(layers: List[dict], x, hidden_act: str = "relu",
                    out_act: str = "none", slope: float = 0.2,
                    compute_dtype=None):
    """Per-layer torch ops on any device (the twin of the reference's
    ``mlp_apply_xla``): twice differentiable, which the kernels are not.
    On the card only the gradient penalty's critic pass takes it
    (``ops/penalty.py``). A stack holding layers marked for tensor
    parallelism takes their Megatron forms (``parallel/tp.py``)."""
    if any(tp.is_marked(l) for l in layers):
        return tp.stack_apply(layers, x, acts_tuple(len(layers), hidden_act,
                                                    out_act),
                              slope, compute_dtype, plain=True)
    n = len(layers)
    for i, layer in enumerate(layers):
        act = out_act if i == n - 1 else hidden_act
        x = linear_plain(x, layer["w"], layer["b"], act=act, slope=slope,
                         compute_dtype=compute_dtype)
    return x


def mlp_apply(layers: List[dict], x, hidden_act: str = "relu",
              out_act: str = "none", slope: float = 0.2,
              compute_dtype=None):
    """Forward through the stack. A CPU tensor takes the per-layer plain
    path (torch autograd differentiates it); any other runs the whole
    stack through :class:`MLPFunction`: one launch of the forward kernel,
    and one of the backward kernel when a gradient is taken
    (ops/cuda_mlp.py), or raises. A stack holding an activation the
    kernels do not (:func:`mlp_apply_split`), or a layer marked for tensor
    parallelism (``parallel/tp.py::stack_apply``), takes one launch a
    layer."""
    if any(tp.is_marked(l) for l in layers):
        return tp.stack_apply(layers, x, acts_tuple(len(layers), hidden_act,
                                                    out_act),
                              slope, compute_dtype)
    if x.device.type == "cpu":
        return mlp_apply_plain(layers, x, hidden_act, out_act, slope,
                               compute_dtype)
    acts = acts_tuple(len(layers), hidden_act, out_act)
    if not all(a in SUPPORTED_ACTS for a in acts):
        return mlp_apply_split(layers, x, acts, slope, compute_dtype)
    flat = [t for l in layers for t in (l["w"], l["b"])]
    return MLPFunction.apply(x, acts, slope, compute_dtype, *flat)


def mlp_apply_split(layers: List[dict], x, acts, slope: float = 0.2,
                    compute_dtype=None):
    """The stack one layer a launch through :class:`MLPFunction`: a layer
    whose activation the kernels hold fuses it; any other activation of
    ``ACTIVATIONS`` follows the layer's product (act ``"none"``) as torch
    ops (:func:`apply_act`), which autograd differentiates. The reference
    gives such a stack to XLA whole (``mlp_apply_pallas``); here every
    product stays on the kernels. A name outside ``ACTIVATIONS`` raises
    before any launch."""
    for a in acts:
        if a not in ACTIVATIONS:
            apply_act(x, a)  # raises, naming the known activations
    for layer, act in zip(layers, acts):
        fused = act if act in SUPPORTED_ACTS else "none"
        x = MLPFunction.apply(x, (fused,), slope, compute_dtype, layer["w"],
                              layer["b"])
        if fused != act:
            x = apply_act(x, act, slope)
    return x
