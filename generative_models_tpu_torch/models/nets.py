"""The shared network stacks — the port of
``generative_models_tpu/models/nets.py``: generator and discriminator,
their conditional forms (cgan: a one-hot label concatenated to the
input), began's autoencoder critic, infogan's
critic with its Q head and its code-taking generator, and the VAE
family's encoder and decoder. The generator returns images in [0, 1]
(sigmoid head); the discriminator returns logits [B]; began's critic
returns reconstructions in [0, 1]; infogan's returns (d logit, Q's
categorical logits, means, log-variances); the encoder returns (mu,
logvar); the decoder returns images, or pre-sigmoid logits with
``logits=True``.

Every init and apply dispatches on ``Config.arch``, as the reference's
do: ``"mlp"`` takes the MLP stacks below, ``"conv"`` the DCGAN-style
stacks of ``models/conv.py`` behind the same flat signatures, so every
loss head runs on either.
"""

from __future__ import annotations

import torch

from generative_models_tpu_torch.config import Config
from generative_models_tpu_torch.models import conv
from generative_models_tpu_torch.models.mlp import (
    linear_init,
    mlp_apply,
    mlp_apply_plain,
    mlp_init,
)


def _cdt(cfg: Config):
    return torch.bfloat16 if cfg.dtype == "bfloat16" else None


def _conv(cfg: Config) -> bool:
    return cfg.arch == "conv"


# --------------------------------------------------------------------
# Generator: z [B, z_dim] -> images [B, 784] in [0, 1] (sigmoid head)
# --------------------------------------------------------------------

def generator_init(gen: torch.Generator, cfg: Config, in_dim=None,
                   device="cpu"):
    if _conv(cfg):
        return conv.generator_init(gen, cfg, in_dim, device=device)
    in_dim = cfg.z_dim if in_dim is None else in_dim
    return mlp_init(gen, [in_dim, cfg.hidden_dim, cfg.image_dim], device)


def generator_apply(params, z, cfg: Config):
    if _conv(cfg):
        return conv.generator_apply(params, z, cfg)
    x = mlp_apply(params, z, hidden_act=cfg.g_hidden_act, out_act="sigmoid",
                  slope=cfg.leaky_slope, compute_dtype=_cdt(cfg))
    return x.float()


# --------------------------------------------------------------------
# Discriminator / critic: images [B, 784] -> logits [B]
# --------------------------------------------------------------------

def discriminator_init(gen: torch.Generator, cfg: Config, in_dim=None,
                       device="cpu"):
    if _conv(cfg):
        return conv.discriminator_init(gen, cfg, device=device)
    in_dim = cfg.image_dim if in_dim is None else in_dim
    return mlp_init(gen, [in_dim, cfg.hidden_dim, 1], device)


def discriminator_apply(params, x, cfg: Config):
    if _conv(cfg):
        return conv.discriminator_apply(params, x, cfg)
    out = mlp_apply(params, x, hidden_act=cfg.d_hidden_act, out_act="none",
                    slope=cfg.leaky_slope, compute_dtype=_cdt(cfg))
    return out.float()[..., 0]


def discriminator_apply_plain(params, x, cfg: Config):
    """The critic through per-layer torch ops on any device: twice
    differentiable, for the gradient penalty's pass (``ops/penalty.py``);
    every other critic pass runs the kernels."""
    if _conv(cfg):
        return conv.discriminator_apply_plain(params, x, cfg)
    out = mlp_apply_plain(params, x, hidden_act=cfg.d_hidden_act,
                          out_act="none", slope=cfg.leaky_slope,
                          compute_dtype=_cdt(cfg))
    return out.float()[..., 0]


# --------------------------------------------------------------------
# Conditional variants (cgan): concat one-hot label to the input
# --------------------------------------------------------------------

def onehot(labels, num_classes: int):
    return torch.nn.functional.one_hot(labels.long(), num_classes).to(
        torch.float32)


def cond_generator_init(gen: torch.Generator, cfg: Config, device="cpu"):
    return generator_init(gen, cfg, in_dim=cfg.z_dim + cfg.num_classes,
                          device=device)


def cond_generator_apply(params, z, labels, cfg: Config):
    zy = torch.cat([z, onehot(labels, cfg.num_classes)], dim=-1)
    return generator_apply(params, zy, cfg)


def cond_discriminator_init(gen: torch.Generator, cfg: Config, device="cpu"):
    if _conv(cfg):
        return conv.cond_discriminator_init(gen, cfg, device=device)
    return discriminator_init(gen, cfg,
                              in_dim=cfg.image_dim + cfg.num_classes,
                              device=device)


def cond_discriminator_apply(params, x, labels, cfg: Config):
    if _conv(cfg):
        return conv.cond_discriminator_apply(params, x, labels, cfg)
    xy = torch.cat([x, onehot(labels, cfg.num_classes)], dim=-1)
    return discriminator_apply(params, xy, cfg)


# --------------------------------------------------------------------
# BEGAN autoencoder critic: images -> h -> images (Berthelot 2017)
# --------------------------------------------------------------------

def began_d_init(gen: torch.Generator, cfg: Config, device="cpu"):
    if _conv(cfg):
        return conv.began_d_init(gen, cfg, device=device)
    return mlp_init(gen, [cfg.image_dim, cfg.began_ae_hidden, cfg.image_dim],
                    device)


def began_d_apply(params, x, cfg: Config):
    """The autoencoder's reconstruction of x, in [0, 1]."""
    if _conv(cfg):
        return conv.began_d_apply(params, x, cfg)
    out = mlp_apply(params, x, hidden_act=cfg.d_hidden_act, out_act="sigmoid",
                    slope=cfg.leaky_slope, compute_dtype=_cdt(cfg))
    return out.float()


# --------------------------------------------------------------------
# InfoGAN critic: a shared trunk, the D head (one logit) and the Q head
# (categorical logits, continuous means and log-variances); Chen 2016
# --------------------------------------------------------------------

def infogan_d_init(gen: torch.Generator, cfg: Config, device="cpu"):
    """``{"trunk": [layer], "d_head": layer, "q_head": layer}``, the
    reference's layout, drawn in that order from `gen` (conv: ``{"trunk",
    "fc", "d_head", "q_head"}``)."""
    if _conv(cfg):
        return conv.infogan_d_init(gen, cfg, device=device)
    q_out = cfg.info_cat_dim + 2 * cfg.info_cont_dim
    return {
        "trunk": mlp_init(gen, [cfg.image_dim, cfg.hidden_dim], device),
        "d_head": linear_init(gen, cfg.hidden_dim, 1, device),
        "q_head": linear_init(gen, cfg.hidden_dim, q_out, device),
    }


def infogan_head(params) -> dict:
    """The D head and the Q head side by side as one layer [hidden, 1 +
    q_out]: lane 0 the D logit, then Q's lanes (the chunk kernel's head);
    under tensor parallelism both heads are rows, and so is the pair."""
    head = {"w": torch.cat([params["d_head"]["w"], params["q_head"]["w"]], 1),
            "b": torch.cat([params["d_head"]["b"], params["q_head"]["b"]])}
    d_head = params["d_head"]
    return d_head.remake(head) if hasattr(d_head, "remake") else head


def infogan_d_apply(params, x, cfg: Config):
    """(d_logit [B], q_cat_logits [B, cat], q_mu [B, cont], q_logvar [B,
    cont]). The trunk and both heads run as one two-layer stack (one
    launch of each MLP kernel on the card), the heads' weights side by
    side (:func:`infogan_head`)."""
    if _conv(cfg):
        return conv.infogan_d_apply(params, x, cfg)
    out = mlp_apply([params["trunk"][0], infogan_head(params)], x,
                    hidden_act=cfg.d_hidden_act, out_act="none",
                    slope=cfg.leaky_slope, compute_dtype=_cdt(cfg)).float()
    cat, cont = cfg.info_cat_dim, cfg.info_cont_dim
    return (out[..., 0], out[..., 1:1 + cat], out[..., 1 + cat:1 + cat + cont],
            out[..., 1 + cat + cont:])


def infogan_g_init(gen: torch.Generator, cfg: Config, device="cpu"):
    return generator_init(
        gen, cfg, in_dim=cfg.z_dim + cfg.info_cat_dim + cfg.info_cont_dim,
        device=device)


def infogan_g_apply(params, z, c_cat_onehot, c_cont, cfg: Config):
    return generator_apply(params, torch.cat([z, c_cat_onehot, c_cont], -1),
                           cfg)


# --------------------------------------------------------------------
# VAE encoder / decoder (Kingma & Welling 2013 MNIST MLP setup)
# --------------------------------------------------------------------

def encoder_init(gen: torch.Generator, cfg: Config, device="cpu"):
    """Trunk, mu head and logvar head, drawn in that order from `gen`."""
    if _conv(cfg):
        return conv.encoder_init(gen, cfg, device=device)
    return {
        "trunk": mlp_init(gen, [cfg.image_dim, cfg.vae_hidden_dim], device),
        "mu": linear_init(gen, cfg.vae_hidden_dim, cfg.latent_dim, device),
        "logvar": linear_init(gen, cfg.vae_hidden_dim, cfg.latent_dim,
                              device),
    }


def encoder_apply(params, x, cfg: Config):
    if _conv(cfg):
        return conv.encoder_apply(params, x, cfg)
    h = mlp_apply(params["trunk"], x, hidden_act="relu", out_act="relu",
                  compute_dtype=_cdt(cfg))
    mu = mlp_apply([params["mu"]], h, out_act="none", compute_dtype=_cdt(cfg))
    logvar = mlp_apply([params["logvar"]], h, out_act="none",
                       compute_dtype=_cdt(cfg))
    return mu.float(), logvar.float()


def decoder_init(gen: torch.Generator, cfg: Config, device="cpu"):
    if _conv(cfg):
        return conv.decoder_init(gen, cfg, device=device)
    return mlp_init(gen, [cfg.latent_dim, cfg.vae_hidden_dim, cfg.image_dim],
                    device)


def decoder_apply(params, z, cfg: Config, logits: bool = False):
    """Bernoulli decoder. ``logits=True`` returns pre-sigmoid logits for
    the numerically stable BCE."""
    if _conv(cfg):
        return conv.decoder_apply(params, z, cfg, logits=logits)
    x = mlp_apply(params, z, hidden_act="relu",
                  out_act="none" if logits else "sigmoid",
                  compute_dtype=_cdt(cfg))
    return x.float()
