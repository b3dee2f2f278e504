"""Causal-transformer prior over VQ-VAE token grids — the port of
``generative_models_tpu/models/ar_prior.py``. A pre-LN GPT block
(Radford et al. 2019):

    x = tok[token] + pos (+ label[y] with cfg.ddpm_cond)     [B, L, W]
    repeat vq_prior_layers times:
        x = x + proj(causal_mha(LN(x)))
        x = x + fc2(gelu(fc1(LN(x))))
    logits = LN(x) @ head                                    [B, L, K]

Input tokens are shifted, [BOS, t_0, .., t_{L-2}] with BOS = K, so
logits[:, i] predicts t_i from the tokens before it. The head starts at
zero: the untrained prior is uniform and its cross-entropy log K.

- Every linear is ``ops/linear.py::fused_linear`` on ``[B·L, W]`` rows:
  on the card the whole-MLP kernels (rows 2 and 3 of PERF.md's table),
  one forward and one backward launch a linear, 4 a block and 1 for the
  head. fc1's GELU (the tanh form, ``jax.nn.gelu``'s default) follows
  its product, which runs on the kernel with act ``"none"``.
- Attention is plain torch ops in the reference's arithmetic (scores /
  sqrt(hd), masked to -1e30, softmax, the product with V), its two
  products through ``ops/matmul.py::matmul`` (IEEE float32 on the card).
  ``scaled_dot_product_attention`` would pick fused algorithms by shape
  and not compute this function step for step.
- The embeddings are ``ops/vq.py::lookup``'s one-hot products, as the
  codebook's: exact forward, and a backward that sums in a fixed order
  (an index's scatter-add does not, on either device).
- The prior stays float32 (no ``compute_dtype``), as in the reference.

:func:`init_kv_cache` and :func:`prior_apply_step` are the serving
twin: one position a call against per-layer K/V caches written in place.
Parameters keep the reference's tree (``['blocks'][0]['qkv']['w']``,
``['tok']``, ``['label']`` ...) and its init: embeddings N(0, 1),
linears ``models/mlp.py::linear_init``, drawn from a ``torch.Generator``.
"""

from __future__ import annotations

import numpy as np
import torch

from generative_models_tpu_torch.models.mlp import linear_init
from generative_models_tpu_torch.models.vq_net import num_tokens
from generative_models_tpu_torch.ops.linear import fused_linear
from generative_models_tpu_torch.ops.matmul import matmul
from generative_models_tpu_torch.ops.vq import lookup
from generative_models_tpu_torch.parallel import tp

LN_EPS = 1e-5
MASKED = -1e30   # the reference's fill for positions past the causal row


def _ln_init(width: int, device="cpu"):
    return {"scale": torch.ones(width, device=device),
            "bias": torch.zeros(width, device=device)}


def _ln_apply(params, x):
    mean = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mean) ** 2, dim=-1, keepdim=True)
    xn = (x - mean) * torch.rsqrt(var + LN_EPS)
    return xn * params["scale"] + params["bias"]


def _lin1(layer, x, act: str = "none"):
    if tp.is_marked(layer):  # a shard under tensor parallelism
        return tp.layer_apply(layer, x, act=act)
    return fused_linear(x, layer["w"], layer["b"], act=act)


def _lin(layer, x3, act: str = "none"):
    """fused_linear over the last axis of a [B, L, .] tensor."""
    b, l, _ = x3.shape
    return _lin1(layer, x3.reshape(b * l, -1), act).reshape(b, l, -1)


def _scale(hd: int) -> float:
    """sqrt(hd) in float32, the reference's jnp.sqrt(jnp.float32(hd))."""
    return float(np.sqrt(np.float32(hd)))


def _block_init(gen, cfg, device="cpu"):
    w = cfg.vq_prior_width
    return {"ln1": _ln_init(w, device),
            "qkv": linear_init(gen, w, 3 * w, device),
            "proj": linear_init(gen, w, w, device),
            "ln2": _ln_init(w, device),
            "fc1": linear_init(gen, w, 4 * w, device),
            "fc2": linear_init(gen, 4 * w, w, device)}


def _heads(t, nh: int):
    """[B, L, W] -> [B, H, L, hd]."""
    b, l, w = t.shape
    return t.reshape(b, l, nh, w // nh).transpose(1, 2)


def _attn(params, x, cfg):
    """Causal multi-head self-attention over [B, L, W]. Under tensor
    parallelism qkv's output may hold this rank's heads alone (q, k and v
    of each, ``parallel/tp.py``'s "col_heads"): the heads follow qkv's
    width, and proj takes the rows of those heads."""
    b, l, w = x.shape
    qkv = _lin(params["qkv"], x)
    wl = qkv.shape[-1] // 3
    nh = cfg.vq_prior_heads * wl // w
    q, k, v = (_heads(t, nh) for t in qkv.split(wl, -1))
    scores = matmul(q, k.transpose(-1, -2)) / _scale(wl // nh)
    causal = torch.ones((l, l), dtype=torch.bool, device=x.device).tril()
    scores = scores.masked_fill(~causal, MASKED)
    o = matmul(torch.softmax(scores, dim=-1), v)
    return _lin(params["proj"], o.transpose(1, 2).reshape(b, l, wl))


def prior_init(gen: torch.Generator, cfg, device="cpu"):
    """{"tok" [K+1, W] (BOS = K), "pos" [L, W], "blocks", "ln_f", "head"
    (zeros), and "label" [num_classes, W] with ``ddpm_cond``}."""
    w, k = cfg.vq_prior_width, cfg.vq_codebook_size

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=gen.device).to(device)

    p = {"tok": normal(k + 1, w), "pos": normal(num_tokens(cfg), w),
         "blocks": [_block_init(gen, cfg, device)
                    for _ in range(cfg.vq_prior_layers)],
         "ln_f": _ln_init(w, device),
         "head": {"w": torch.zeros((w, k), device=device),
                  "b": torch.zeros(k, device=device)}}
    if cfg.ddpm_cond:
        p["label"] = normal(cfg.num_classes, w)
    return p


def block_apply(blk, x, cfg):
    """One pre-LN GPT block."""
    x = x + _attn(blk, _ln_apply(blk["ln1"], x), cfg)
    h = _lin(blk["fc1"], _ln_apply(blk["ln2"], x), act="gelu")
    return x + _lin(blk["fc2"], h)


def embed_tokens(params, tokens_in, cfg, y=None):
    """tok[tokens_in] + pos (+ label[y] at every position with
    ``ddpm_cond`` and labels), the rows taken by one-hot products."""
    x = lookup(tokens_in, params["tok"]) + params["pos"][None]
    if cfg.ddpm_cond and y is not None:
        x = x + lookup(y, params["label"])[:, None]
    return x


def final_logits(params, x):
    """The final LayerNorm and the head."""
    return _lin(params["head"], _ln_apply(params["ln_f"], x))


def prior_apply(params, tokens_in, cfg, y=None):
    """Next-token logits [B, L, K] for shifted input tokens [B, L] (ints
    in [0, K]); logits[:, i] depends on tokens_in[:, :i + 1] alone."""
    x = embed_tokens(params, tokens_in, cfg, y)
    for blk in params["blocks"]:
        x = block_apply(blk, x, cfg)
    return final_logits(params, x)


# --------------------------------------------------------------------
# Incremental (KV-cache) decoding: the serving twin
# --------------------------------------------------------------------

def init_kv_cache(n: int, cfg, device="cpu"):
    """Per-layer key and value caches [n, H, L, hd], zeros."""
    nh = cfg.vq_prior_heads
    shape = (n, nh, num_tokens(cfg), cfg.vq_prior_width // nh)
    return [{"k": torch.zeros(shape, device=device),
             "v": torch.zeros(shape, device=device)}
            for _ in range(cfg.vq_prior_layers)]


def prior_apply_step(params, tok_i, i: int, kv, cfg, y=None):
    """Logits [B, K] of position i from its input token tok_i [B] and the
    caches of positions < i; writes position i's keys and values into
    `kv` in place (detached: the cache carries no gradient).
    :func:`prior_apply`'s arithmetic restricted to row i: the attention
    row spans the whole cache, positions past i masked."""
    b = tok_i.shape[0]
    nh, w = cfg.vq_prior_heads, cfg.vq_prior_width
    hd = w // nh
    l = kv[0]["k"].shape[2]
    x = lookup(tok_i, params["tok"]) + params["pos"][i]
    if cfg.ddpm_cond and y is not None:
        x = x + lookup(y, params["label"])
    past = torch.arange(l, device=x.device) > i
    for blk, cache in zip(params["blocks"], kv):
        q, k, v = _lin1(blk["qkv"], _ln_apply(blk["ln1"], x)).split(w, -1)
        cache["k"][:, :, i] = k.detach().reshape(b, nh, hd)
        cache["v"][:, :, i] = v.detach().reshape(b, nh, hd)
        scores = matmul(q.reshape(b, nh, 1, hd),
                        cache["k"].transpose(-1, -2)) / _scale(hd)
        att = torch.softmax(scores.masked_fill(past, MASKED), dim=-1)
        o = matmul(att, cache["v"]).reshape(b, w)
        x = x + _lin1(blk["proj"], o)
        h = _lin1(blk["fc1"], _ln_apply(blk["ln2"], x), act="gelu")
        x = x + _lin1(blk["fc2"], h)
    return _lin1(params["head"], _ln_apply(params["ln_f"], x))
