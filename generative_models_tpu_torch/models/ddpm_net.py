"""Time-conditioned networks of the diffusion family — the port of
``generative_models_tpu/models/ddpm_net.py``: ``net_apply(params, x, t,
cfg, y=None) -> [B, image_dim]`` (DDPM's eps, flow matching's velocity)
for rows x [B, image_dim] in [-1, 1] at timesteps t [B] (integers for
DDPM, ``t * T_EMB_SCALE`` for flow), dispatched on ``Config.arch``:

- ``"mlp"``: two hidden layers of ``hidden_dim``, the projected timestep
  embedding added before each SiLU, plus a full-rank linear skip from
  the input to the output. ``out`` and ``skip`` start at zero, so the
  untrained net predicts 0.
- ``"conv"``: a compact UNet (28 -> 14 -> 7 -> 14 -> 28) of
  ``models/conv.py``'s convolutions and GroupNorm: 3x3 stride-1 blocks
  conv -> GroupNorm -> + time bias -> SiLU, stride-2 4x4 down and up
  samples, the skips joined on the channel axis. The port runs NCHW, so
  the reference's NHWC concat on the last axis is a concat on axis 1 and
  the time bias broadcasts as ``tb[:, :, None, None]``; the flat rows
  keep the (h, w, c) order (``conv._img``, ``conv._flat``). The head
  conv is zero-initialised.

With ``cfg.ddpm_cond`` the timestep embedding adds a learned label
embedding ``[num_classes + 1, ddpm_time_dim]`` drawn N(0, 1); the last
row is the null token of classifier-free guidance (y None selects it).

Every dense layer goes through ``ops/linear.py::fused_linear``: on the
card the whole-MLP kernels (rows 1-3 of PERF.md's table), eight launches
a forward of the MLP net (the time MLP's two layers, ``in``, ``t1``,
``mid``, ``t2``, ``out``, ``skip``) and seven of the UNet's (the time
MLP's two, five blocks' time biases); the time MLP's first layer is a
SiLU one, so its product runs on the kernel with act ``"none"`` and the
SiLU follows. The convolutions are cuDNN's, as the reference leaves them
to XLA. Parameters keep the reference's tree (``['time']['l'][0]['w']``,
``['time']['label']``, ``['d1']['conv']['w']`` HWIO ...), so a JAX
checkpoint's leaves map onto them one to one; initialisation draws from
an explicit ``torch.Generator`` as ``models/mlp.py`` does.
"""

from __future__ import annotations

import math

import numpy as np
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
from generative_models_tpu_torch.models.mlp import linear_init
from generative_models_tpu_torch.ops.activations import apply_act
from generative_models_tpu_torch.ops.linear import fused_linear
from generative_models_tpu_torch.parallel import tp

# float32 log(10000), the reference's jnp.log(10000.0)
_LOG_1E4 = float(np.float32(math.log(10000.0)))


def _cdt(cfg):
    return torch.bfloat16 if cfg.dtype == "bfloat16" else None


def _dense(layer, x, act, compute_dtype):
    """One dense layer: ``fused_linear``, or a shard under tensor
    parallelism in its Megatron form (``parallel/tp.py``)."""
    if tp.is_marked(layer):
        return tp.layer_apply(layer, x, act, compute_dtype=compute_dtype)
    return fused_linear(x, layer["w"], layer["b"], act=act,
                        compute_dtype=compute_dtype)


def _zero_linear(in_dim: int, out_dim: int, device="cpu") -> dict:
    return {"w": torch.zeros((in_dim, out_dim), device=device),
            "b": torch.zeros((out_dim,), device=device)}


def _zero_conv(kh: int, kw: int, cin: int, cout: int, device="cpu") -> dict:
    return {"w": torch.zeros((kh, kw, cin, cout), device=device),
            "b": torch.zeros((cout,), device=device)}


def timestep_embedding(t, dim: int):
    """Sinusoidal embedding of timesteps t [B] -> [B, dim], float32:
    geometric frequencies over half the width, sin || cos, and one zero
    column when `dim` is odd."""
    half = dim // 2
    ar = torch.arange(half, dtype=torch.float32, device=t.device)
    freqs = torch.exp(-_LOG_1E4 * ar / max(half - 1, 1))
    args = t.to(torch.float32)[:, None] * freqs[None, :]
    emb = torch.cat([torch.sin(args), torch.cos(args)], dim=-1)
    if dim % 2:
        emb = torch.nn.functional.pad(emb, (0, 1))
    return emb


def _time_mlp_init(gen: torch.Generator, cfg, device="cpu") -> dict:
    td = cfg.ddpm_time_dim
    p = {"l": [linear_init(gen, td, td, device),
               linear_init(gen, td, td, device)]}
    if cfg.ddpm_cond:
        # num_classes labels and the null token, N(0, 1) as nn.Embedding
        p["label"] = torch.randn((cfg.num_classes + 1, td), generator=gen,
                                 device=gen.device).to(device)
    return p


def _time_mlp_apply(params, t, cfg, y=None):
    cd = _cdt(cfg)
    emb = timestep_embedding(t, cfg.ddpm_time_dim)
    if cfg.ddpm_cond:
        if y is None:  # unconditional use of a conditional net
            y = torch.full(t.shape, cfg.num_classes, dtype=torch.int64,
                           device=t.device)
        emb = emb + params["label"][y.long()]
    lay = params["l"]
    emb = _dense(lay[0], emb, "silu", cd)
    return _dense(lay[1], emb, "none", cd)


# --------------------------------------------------------------------
# MLP stack
# --------------------------------------------------------------------

def mlp_init(gen: torch.Generator, cfg, device="cpu") -> dict:
    """Drawn in the reference's order: time, in, t1, mid, t2; out and
    skip zero."""
    h, td = cfg.hidden_dim, cfg.ddpm_time_dim
    return {
        "time": _time_mlp_init(gen, cfg, device),
        "in": linear_init(gen, cfg.image_dim, h, device),
        "t1": linear_init(gen, td, h, device),
        "mid": linear_init(gen, h, h, device),
        "t2": linear_init(gen, td, h, device),
        "out": _zero_linear(h, cfg.image_dim, device),
        "skip": _zero_linear(cfg.image_dim, cfg.image_dim, device),
    }


def mlp_apply(params, x, t, cfg, y=None):
    cd = _cdt(cfg)

    def lin(name, a):
        return _dense(params[name], a, "none", cd)
    emb = _time_mlp_apply(params["time"], t, cfg, y)
    h = apply_act(lin("in", x) + lin("t1", emb), "silu")
    h = apply_act(lin("mid", h) + lin("t2", emb), "silu")
    return _f32(lin("out", h) + lin("skip", x))


# --------------------------------------------------------------------
# Conv UNet stack
# --------------------------------------------------------------------

def _block_init(gen: torch.Generator, cin: int, cout: int, td: int,
                device="cpu") -> dict:
    return {"conv": conv_init(gen, 3, 3, cin, cout, device),
            "gn": gn_init(cout, device),
            "t": linear_init(gen, td, cout, device)}


def _block_apply(params, h, emb, cfg):
    """conv 3x3 -> GroupNorm -> + time bias -> SiLU (the time bias takes
    no compute dtype, as in the reference)."""
    h = conv_apply(params["conv"], h, stride=1, compute_dtype=_cdt(cfg))
    h = gn_apply(params["gn"], _f32(h))
    tb = fused_linear(emb, params["t"]["w"], params["t"]["b"], act="none")
    return apply_act(h + tb[:, :, None, None], "silu")


def conv_unet_init(gen: torch.Generator, cfg, device="cpu") -> dict:
    c, td = cfg.conv_channels, cfg.ddpm_time_dim
    return {
        "time": _time_mlp_init(gen, cfg, device),
        "stem": conv_init(gen, 3, 3, 1, c, device),
        "d1": _block_init(gen, c, c, td, device),             # 28, C
        "down1": conv_init(gen, 4, 4, c, 2 * c, device),      # -> 14, 2C
        "d2": _block_init(gen, 2 * c, 2 * c, td, device),
        "down2": conv_init(gen, 4, 4, 2 * c, 2 * c, device),  # -> 7, 2C
        "mid": _block_init(gen, 2 * c, 2 * c, td, device),
        "up1": conv_init(gen, 4, 4, 2 * c, 2 * c, device),    # -> 14, 2C
        "u1": _block_init(gen, 4 * c, c, td, device),         # + d2's skip
        "up2": conv_init(gen, 4, 4, c, c, device),            # -> 28, C
        "u2": _block_init(gen, 2 * c, c, td, device),         # + d1's skip
        "head_gn": gn_init(c, device),
        "head": _zero_conv(3, 3, c, 1, device),
    }


def conv_unet_apply(params, x, t, cfg, y=None):
    cd = _cdt(cfg)
    emb = _time_mlp_apply(params["time"], t, cfg, y)
    h = _f32(conv_apply(params["stem"], _img(x), stride=1,
                        compute_dtype=cd))
    s1 = _block_apply(params["d1"], h, emb, cfg)              # 28, C
    h = _f32(conv_apply(params["down1"], s1, stride=2, compute_dtype=cd))
    s2 = _block_apply(params["d2"], h, emb, cfg)              # 14, 2C
    h = _f32(conv_apply(params["down2"], s2, stride=2, compute_dtype=cd))
    h = _block_apply(params["mid"], h, emb, cfg)              # 7, 2C
    h = _f32(convt_apply(params["up1"], h, stride=2, compute_dtype=cd))
    h = _block_apply(params["u1"], torch.cat([h, s2], dim=1), emb, cfg)
    h = _f32(convt_apply(params["up2"], h, stride=2, compute_dtype=cd))
    h = _block_apply(params["u2"], torch.cat([h, s1], dim=1), emb, cfg)
    h = apply_act(gn_apply(params["head_gn"], h), "silu")
    out = conv_apply(params["head"], h, stride=1)
    return _flat(_f32(out))


# --------------------------------------------------------------------
# Arch dispatch (as models/nets.py)
# --------------------------------------------------------------------

def net_init(gen: torch.Generator, cfg, device="cpu") -> dict:
    if cfg.arch == "conv":
        return conv_unet_init(gen, cfg, device)
    return mlp_init(gen, cfg, device)


def net_apply(params, x, t, cfg, y=None):
    """[B, image_dim] for rows x [B, image_dim] at timesteps t [B]; y [B]
    integer labels with ``cfg.ddpm_cond`` (None or num_classes: the null
    token)."""
    if cfg.arch == "conv":
        return conv_unet_apply(params, x, t, cfg, y)
    return mlp_apply(params, x, t, cfg, y)
