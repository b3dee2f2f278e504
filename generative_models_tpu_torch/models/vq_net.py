"""Encoder and decoder stacks of the VQ-VAE family (Oord et al. 2017) —
the port of ``generative_models_tpu/models/vq_net.py``, dispatched on
``Config.arch``. Both map images to a grid of :func:`num_tokens` code
vectors of ``vq_code_dim`` each, quantized against the codebook
(``ops/vq.py``), and back.

- ``"mlp"``: image_dim -> vae_hidden_dim (ReLU) -> L*D, reshaped [B, L,
  D]; the decoder mirrors it with a sigmoid (or logits) head. Each stack
  is one ``models/mlp.py::mlp_apply``: on the card one launch of the
  whole-MLP forward kernel and, under a gradient, one of the backward
  kernel (rows 1 and 3 of PERF.md's table).
- ``"conv"``: two stride-2 4x4 convs (28 -> 7, ``cfg.d_hidden_act``) and
  a 1x1 head to D channels, a 7x7 = 49 token grid in NHWC order
  (``reshape(b, 7, 7, D)`` on the way back); the decoder is a 1x1 conv
  D -> 2C, GroupNorm, ReLU, then two stride-2 transposed convs with
  GroupNorm and ReLU between. The convolutions are cuDNN's under
  ``models/conv.py::strict_convs``, kernels HWIO as in the reference.

``dtype="bfloat16"`` rounds every product's operands to bf16 (``_cdt``);
the codes come out in float32.
"""

from __future__ import annotations

import torch

from generative_models_tpu_torch.models.conv import (
    _f32,
    _flat,
    _img,
    conv_apply,
    conv_init,
    convt_apply,
    gn_apply,
    gn_init,
)
from generative_models_tpu_torch.models.mlp import mlp_apply, mlp_init
from generative_models_tpu_torch.ops.activations import apply_act


def num_tokens(cfg) -> int:
    """L: the conv stack's 7x7 grid, or ``vq_tokens`` on the MLP stack."""
    return 49 if cfg.arch == "conv" else cfg.vq_tokens


def _cdt(cfg):
    return torch.bfloat16 if cfg.dtype == "bfloat16" else None


# --------------------------------------------------------------------
# Encoder: images [B, 784] -> pre-quantization codes [B, L, D]
# --------------------------------------------------------------------

def encoder_init(gen: torch.Generator, cfg, device="cpu"):
    d = cfg.vq_code_dim
    if cfg.arch == "conv":
        c = cfg.conv_channels
        return {"c1": conv_init(gen, 4, 4, 1, c, device),
                "c2": conv_init(gen, 4, 4, c, 2 * c, device),
                "head": conv_init(gen, 1, 1, 2 * c, d, device)}
    return {"trunk": mlp_init(
        gen, [cfg.image_dim, cfg.vae_hidden_dim, num_tokens(cfg) * d],
        device)}


def encoder_apply(params, x, cfg):
    b, d = x.shape[0], cfg.vq_code_dim
    cdt = _cdt(cfg)
    if cfg.arch == "conv":
        h = conv_apply(params["c1"], _img(x), stride=2, act=cfg.d_hidden_act,
                       slope=cfg.leaky_slope, compute_dtype=cdt)   # 14, C
        h = conv_apply(params["c2"], h, stride=2, act=cfg.d_hidden_act,
                       slope=cfg.leaky_slope, compute_dtype=cdt)   # 7, 2C
        h = conv_apply(params["head"], h, stride=1, compute_dtype=cdt)
        return _f32(_flat(h)).reshape(b, 49, d)                    # NHWC
    h = mlp_apply(params["trunk"], x, hidden_act="relu", out_act="none",
                  compute_dtype=cdt)
    return _f32(h).reshape(b, num_tokens(cfg), d)


# --------------------------------------------------------------------
# Decoder: quantized codes [B, L, D] -> image logits [B, 784]
# --------------------------------------------------------------------

def decoder_init(gen: torch.Generator, cfg, device="cpu"):
    d = cfg.vq_code_dim
    if cfg.arch == "conv":
        c = cfg.conv_channels
        return {"in": conv_init(gen, 1, 1, d, 2 * c, device),
                "gn0": gn_init(2 * c, device),
                "up1": conv_init(gen, 4, 4, 2 * c, c, device),
                "gn1": gn_init(c, device),
                "up2": conv_init(gen, 4, 4, c, 1, device)}
    return {"trunk": mlp_init(
        gen, [num_tokens(cfg) * d, cfg.vae_hidden_dim, cfg.image_dim],
        device)}


def decoder_apply(params, z_q, cfg, logits: bool = False):
    """Bernoulli decoder over pixels: images in [0, 1], or with
    ``logits=True`` the pre-sigmoid logits (for a stable BCE)."""
    b = z_q.shape[0]
    out_act = "none" if logits else "sigmoid"
    cdt = _cdt(cfg)
    if cfg.arch == "conv":
        h = z_q.reshape(b, 7, 7, cfg.vq_code_dim).permute(0, 3, 1, 2)
        h = _f32(conv_apply(params["in"], h, stride=1, compute_dtype=cdt))
        h = apply_act(gn_apply(params["gn0"], h), "relu")
        h = convt_apply(params["up1"], h, stride=2, compute_dtype=cdt)
        h = apply_act(gn_apply(params["gn1"], _f32(h)), "relu")
        h = convt_apply(params["up2"], h, stride=2, act=out_act,
                        compute_dtype=cdt)
        return _f32(_flat(h)).reshape(b, cfg.image_dim)
    out = mlp_apply(params["trunk"], z_q.reshape(b, -1), hidden_act="relu",
                    out_act=out_act, compute_dtype=cdt)
    return _f32(out)
