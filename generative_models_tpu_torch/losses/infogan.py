"""InfoGAN (Chen et al. 2016) — the port of
``generative_models_tpu/losses/infogan.py``. G's input is a code row,
z ⊕ onehot(c_cat) ⊕ c_cont, with c_cat ~ Cat(info_cat_dim) and c_cont ~
U(-1, 1)^info_cont_dim. The Q head shares D's trunk
(``models/nets.py::infogan_d_*``), and the variational MI lower bound

    L_I = CE(q_cat(G(z, c)), c_cat) + GaussNLL(c_cont; q_mu, q_var)

is added (weight ``info_lambda``) to both the critic's loss (Q's params
live in ``d_params``) and G's.

The codes are passed in explicitly, as every port head takes its noise:
``z=`` is the batch's code rows ``[B, z_dim + cat + cont]``
(:func:`code_rows` builds them from z, the cat indices and the cont
values; :func:`draw_codes` draws them from a generator). torch cannot
replay JAX's ``randint`` / ``uniform`` on threefry keys, so tests hand
the same codes to both packages. The critic's MI term reads the fake's
head outputs of its D loss (the reference evaluates the critic on the
fake twice; the function and its gradient are the same).
"""

from __future__ import annotations

import torch

from generative_models_tpu_torch.losses.base import AdversarialSpec
from generative_models_tpu_torch.losses.common import (
    bce_logits_mean,
    compute_noise,
)
from generative_models_tpu_torch.models import nets
from generative_models_tpu_torch.utils.tree import tree_device


def code_lanes(cfg) -> int:
    return cfg.info_cat_dim + cfg.info_cont_dim


def code_rows(z, cat, cont, cfg):
    """G's input rows z ⊕ onehot(cat) ⊕ cont; `cat` holds class indices."""
    return torch.cat([z, nets.onehot(cat, cfg.info_cat_dim).to(z.device),
                      cont], -1)


def draw_codes(gen: torch.Generator, lead, cfg, device):
    """Code rows [*lead, z_dim + cat + cont] from `gen`, in this order: z
    ~ N(0, I), the cat indices ~ U{0..cat-1}, cont ~ U(-1, 1)."""
    lead = tuple(lead)
    z = torch.randn(lead + (cfg.z_dim,), generator=gen, device=gen.device)
    cat = torch.randint(0, cfg.info_cat_dim, lead, generator=gen,
                        device=gen.device)
    cont = torch.rand(lead + (cfg.info_cont_dim,), generator=gen,
                      device=gen.device) * 2.0 - 1.0
    return code_rows(z, cat, cont, cfg).to(device)


def split_codes(rows, cfg):
    """(z, onehot(cat), cont) of code rows."""
    z, c = cfg.z_dim, cfg.info_cat_dim
    return rows[..., :z], rows[..., z:z + c], rows[..., z + c:]


def _rows(gen, n, cfg, g_params, z):
    if z is not None:
        return z
    return draw_codes(gen, (n,), cfg, tree_device(g_params))


def _mi_lower_bound(q_cat, q_mu, q_logvar, rows, cfg):
    _, onehot, cont = split_codes(rows, cfg)
    ce = -torch.mean(torch.sum(torch.log_softmax(q_cat, dim=-1) * onehot,
                               dim=-1))
    if cfg.info_cont_dim == 0:
        return ce
    if cfg.info_cont_fixed_var:  # fixed unit variance: NLL ~ (c - mu)^2 / 2
        return ce + torch.mean(0.5 * (cont - q_mu) ** 2)
    return ce + torch.mean(0.5 * (q_logvar + (cont - q_mu) ** 2
                                  / torch.exp(q_logvar)))


def _d_loss(d_params, g_params, batch, gen, vstate, cfg, z=None):
    x = batch["image"]
    rows = _rows(gen, x.shape[0], cfg, g_params, z)
    fake = nets.generator_apply(g_params, rows, cfg)
    l_real = nets.infogan_d_apply(d_params, x, cfg)[0]
    l_fake, q_cat, q_mu, q_logvar = nets.infogan_d_apply(d_params, fake, cfg)
    bce = bce_logits_mean(l_real, torch.ones_like(l_real)) + \
        bce_logits_mean(l_fake, torch.zeros_like(l_fake))
    mi = _mi_lower_bound(q_cat, q_mu, q_logvar, rows, cfg)
    loss = bce + cfg.info_lambda * mi
    return loss, {"d_loss": loss, "mi_loss": mi}


def _g_loss(g_params, d_params, batch, gen, vstate, cfg, z=None):
    rows = _rows(gen, batch["image"].shape[0], cfg, g_params, z)
    fake = nets.generator_apply(g_params, rows, cfg)
    l_fake, q_cat, q_mu, q_logvar = nets.infogan_d_apply(d_params, fake, cfg)
    mi = _mi_lower_bound(q_cat, q_mu, q_logvar, rows, cfg)
    loss = bce_logits_mean(l_fake, torch.ones_like(l_fake)) + \
        cfg.info_lambda * mi
    return loss, {"g_loss": loss, "g_mi_loss": mi}


def _sample(g_params, gen, n, cfg, z=None):
    """The class-cycled grid: row i has class i % info_cat_dim and cont 0;
    `z` [n, z_dim] (drawn from `gen` when None)."""
    dev = tree_device(g_params)
    if z is None:
        z = compute_noise(gen, n, cfg.z_dim, device=dev)
    cat = torch.arange(n, device=z.device) % cfg.info_cat_dim
    cont = torch.zeros((n, cfg.info_cont_dim), device=z.device)
    return nets.generator_apply(g_params, code_rows(z, cat, cont, cfg), cfg)


INFOGAN = AdversarialSpec(
    name="infogan",
    init_g=nets.infogan_g_init,
    init_d=nets.infogan_d_init,
    d_loss=_d_loss,
    g_loss=_g_loss,
    sample=_sample,
)
