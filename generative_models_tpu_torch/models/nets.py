"""The shared network stacks — the port of
``generative_models_tpu/models/nets.py``, MLP generator and
discriminator only. The generator returns images in [0, 1] (sigmoid
head); the discriminator returns logits [B].
"""

from __future__ import annotations

import torch

from generative_models_tpu_torch.config import Config
from generative_models_tpu_torch.models.mlp import mlp_apply, mlp_init


def _cdt(cfg: Config):
    return torch.bfloat16 if cfg.dtype == "bfloat16" else None


def _mlp_only(cfg: Config) -> None:
    if cfg.arch != "mlp":
        raise NotImplementedError(
            f"arch={cfg.arch!r} is not ported to generative_models_tpu_torch "
            "yet (ROADMAP.md Queue 1: conv stacks and spectral projection)")


# --------------------------------------------------------------------
# Generator: z [B, z_dim] -> images [B, 784] in [0, 1] (sigmoid head)
# --------------------------------------------------------------------

def generator_init(gen: torch.Generator, cfg: Config, in_dim=None,
                   device="cpu"):
    _mlp_only(cfg)
    in_dim = cfg.z_dim if in_dim is None else in_dim
    return mlp_init(gen, [in_dim, cfg.hidden_dim, cfg.image_dim], device)


def generator_apply(params, z, cfg: Config):
    _mlp_only(cfg)
    x = mlp_apply(params, z, hidden_act=cfg.g_hidden_act, out_act="sigmoid",
                  slope=cfg.leaky_slope, compute_dtype=_cdt(cfg))
    return x.float()


# --------------------------------------------------------------------
# Discriminator / critic: images [B, 784] -> logits [B]
# --------------------------------------------------------------------

def discriminator_init(gen: torch.Generator, cfg: Config, in_dim=None,
                       device="cpu"):
    _mlp_only(cfg)
    in_dim = cfg.image_dim if in_dim is None else in_dim
    return mlp_init(gen, [in_dim, cfg.hidden_dim, 1], device)


def discriminator_apply(params, x, cfg: Config):
    _mlp_only(cfg)
    out = mlp_apply(params, x, hidden_act=cfg.d_hidden_act, out_act="none",
                    slope=cfg.leaky_slope, compute_dtype=_cdt(cfg))
    return out.float()[..., 0]
