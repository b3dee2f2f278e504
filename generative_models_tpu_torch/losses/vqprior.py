"""VQ-VAE + autoregressive latent prior (Oord et al. 2017 §3.3; the prior
is the causal transformer of ``models/ar_prior.py``) — the port of
``generative_models_tpu/losses/vqprior.py``. The parameters are
``{"prior": ..., "vqvae": ...}``.

Two training modes, by ``Config.vq_freeze_tokenizer``:

- False (the default): joint. L = L_vqvae + CE(prior(shift(tokens)),
  tokens), the token targets carrying no gradient, so the CE trains the
  prior alone and the tokenizer its own Oord loss.
- True: two-stage. ``params["vqvae"]`` is detached everywhere and the
  loss is the CE alone: the subtree's gradients are zeros (the general
  step materialises them) and Adam leaves it and its moments bit-exact.
  The CLI's ``--vq-from CKPT`` loads a trained vqvae into it and sets the
  flag (``train/vq.py``).

Sampling draws token i as ``argmax(logits_i / T + g_i)`` (T =
``vq_prior_temp``), the reference's ``jax.random.categorical``, with g_i
[n, K] standard Gumbel draws: the chain, step i -> g_i, given
(``chain_noise``; a test hands over ``jax.random.gumbel(fold_in(rng,
i), (n, K))``, the exported sampler maps its Philox normal draws,
:func:`gumbel_of_normal`) or drawn from the generator. Two decodes, by
``Config.vq_decode``: ``"cache"`` (the default, the reference's choice)
runs one position a step against the K/V caches
(``ar_prior.prior_apply_step``), ``"full"`` re-runs the whole shifted
buffer each step. The grid decodes through the carried vqvae.
"""

from __future__ import annotations

import numpy as np
import torch

from generative_models_tpu_torch.losses import vqvae as vqvae_mod
from generative_models_tpu_torch.losses.base import SingleModelSpec
from generative_models_tpu_torch.models import ar_prior
from generative_models_tpu_torch.models.vq_net import num_tokens
from generative_models_tpu_torch.ops import vq
from generative_models_tpu_torch.utils.tree import tree_device, tree_map

# the float32 bounds of a uniform draw the Gumbel map takes: JAX's
# uniform(minval=tiny, maxval=1) and the largest float32 below 1
_U_MIN = float(np.finfo(np.float32).tiny)
_U_MAX = 1.0 - 2.0 ** -24


def init_params(gen, cfg, device="cpu"):
    return {"prior": ar_prior.prior_init(gen, cfg, device),
            "vqvae": vqvae_mod.init_params(gen, cfg, device)}


def _shift(tokens, cfg):
    """[BOS, t_0, .., t_{L-2}] (BOS = K)."""
    bos = torch.full((tokens.shape[0], 1), cfg.vq_codebook_size,
                     dtype=tokens.dtype, device=tokens.device)
    return torch.cat([bos, tokens[:, :-1]], dim=1)


def prior_ce(logits, tokens):
    """Teacher-forced next-token cross-entropy, the mean over batch and
    positions."""
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.mean(torch.gather(logp, -1, tokens[..., None].long()))


def loss(params, batch, gen, cfg, eps=None):
    x = batch["image"]
    vparams = params["vqvae"]
    if cfg.vq_freeze_tokenizer:
        vparams = tree_map(torch.Tensor.detach, vparams)
    recon, codebook, commit, idx = vqvae_mod._terms(vparams, x, cfg)
    y = batch["label"].long() if cfg.ddpm_cond else None
    logits = ar_prior.prior_apply(params["prior"], _shift(idx, cfg), cfg, y)
    ce = prior_ce(logits, idx)
    if cfg.vq_freeze_tokenizer:
        total = ce   # the vqvae terms are constants (frozen subtree)
    else:
        total = recon + codebook + cfg.vq_beta * commit + ce
    return total, {"loss": total, "prior_loss": ce, "recon_loss": recon,
                   "vq_loss": codebook,
                   "perplexity": vq.perplexity(idx, cfg.vq_codebook_size)}


def gumbel_of_uniform(u):
    """Standard Gumbel draws -log(-log(u)) of uniforms u, clamped into
    [tiny, 1) as the reference's draw is."""
    return -torch.log(-torch.log(torch.clamp(u, _U_MIN, _U_MAX)))


def gumbel_of_normal(z, cfg=None):
    """Standard Gumbel draws from standard-normal ones (through Phi)."""
    return gumbel_of_uniform(vqvae_mod.uniform_of_normal(z))


def _draw_gumbel(gen, n, cfg, device):
    def chain(i):
        u = torch.rand((n, cfg.vq_codebook_size), generator=gen,
                       device=gen.device)
        return gumbel_of_uniform(u).to(device)
    return chain


def _scores(logits, g, inv_t: float):
    """logits / T + g, the argument of the reference's categorical."""
    return logits * inv_t + g


def sample_tokens(prior_params, gen, n, cfg, y=None, chain=None):
    """A token grid [n, L] by ancestral sampling (see the module note),
    `chain` step i -> its Gumbel draws [n, K], else drawn from `gen`;
    with ``ddpm_cond`` the labels y [n] condition every step."""
    dev = tree_device(prior_params)
    l, k = num_tokens(cfg), cfg.vq_codebook_size
    inv_t = 1.0 / cfg.vq_prior_temp
    if chain is None:
        chain = _draw_gumbel(gen, n, cfg, dev)
    buf = torch.zeros((n, l), dtype=torch.int64, device=dev)
    if cfg.vq_decode == "cache":
        kv = ar_prior.init_kv_cache(n, cfg, dev)
        prev = torch.full((n,), k, dtype=torch.int64, device=dev)   # BOS
        for i in range(l):
            logits = ar_prior.prior_apply_step(prior_params, prev, i, kv,
                                               cfg, y)
            prev = torch.argmax(_scores(logits, chain(i), inv_t), dim=-1)
            buf[:, i] = prev
        return buf
    for i in range(l):
        logits = ar_prior.prior_apply(prior_params, _shift(buf, cfg), cfg, y)
        buf[:, i] = torch.argmax(_scores(logits[:, i], chain(i), inv_t),
                                 dim=-1)
    return buf


def sample_margin(prior_params, tokens, cfg, chain, y=None) -> float:
    """The sampler's smallest relative gap over the steps of a grid it
    drew: min over rows and positions i of (top1 - top2) / max |s| of s
    = logits_i / T + g_i, the logits taken teacher-forced on `tokens`
    (equal to the sampler's by causality). A gap within rounding of 0
    draws another token on another device: tests and the chip smoke hold
    trajectories only where it clears a bound fixed before measuring."""
    with torch.no_grad():
        logits = ar_prior.prior_apply(prior_params, _shift(tokens, cfg), cfg,
                                      y)
        worst = float("inf")
        for i in range(tokens.shape[1]):
            s = _scores(logits[:, i], chain(i).to(logits), 1.0 /
                        cfg.vq_prior_temp)
            two = torch.topk(s, 2, dim=-1).values
            rel = (two[:, 0] - two[:, 1]) / s.abs().max(dim=-1).values
            worst = min(worst, float(rel.min()))
        return worst


def sample_labels(n, cfg, device):
    """One column per digit with ``ddpm_cond`` (the cgan grid), else None."""
    if not cfg.ddpm_cond:
        return None
    return torch.arange(n, device=device) % cfg.num_classes


def sample(params, gen, n, cfg, z=None, chain=None):
    """n images [n, 784]: a token grid from the prior, decoded through the
    carried vqvae. `z` is not used (the draws are the chain's)."""
    y = sample_labels(n, cfg, tree_device(params["prior"]))
    tokens = sample_tokens(params["prior"], gen, n, cfg, y, chain)
    return vqvae_mod.decode_tokens(params["vqvae"], tokens, cfg)


def sample_class(params, gen, n, label, cfg, z=None, chain=None):
    """n images of class `label` (with ``ddpm_cond``)."""
    y = torch.full((n,), label, dtype=torch.int64,
                   device=tree_device(params["prior"]))
    tokens = sample_tokens(params["prior"], gen, n, cfg, y, chain)
    return vqvae_mod.decode_tokens(params["vqvae"], tokens, cfg)


def codebook_lanes(cfg) -> int:
    return cfg.vq_codebook_size


VQPRIOR = SingleModelSpec(
    name="vqprior",
    init_params=init_params,
    loss=loss,
    sample=sample,
    step_lanes=vqvae_mod.no_lanes,
    draw_noise=vqvae_mod.no_draws,
    sample_lanes=codebook_lanes,
    chain_noise=True,
    noise_of_normal=gumbel_of_normal,
)
