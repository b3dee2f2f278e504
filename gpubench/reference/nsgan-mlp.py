"""Plain reference of ``nsgan-mlp``: the non-saturating GAN (Goodfellow et
al. 2014, arXiv:1406.2661) on the MLP sizes of the upstream
shayneobrien/generative-models GAN, trained with Adam.

    G(z) = sigmoid(relu(z W1g + b1g) W2g + b2g)          z ~ N(0, I)
    D(x) = leaky_relu(x W1d + b1d, slope) W2d + b2d      (a logit)
    L_D  = mean softplus(-D(x)) + mean softplus(D(G(z_d)))
    L_G  = mean softplus(-D(G(z_g)))                     (non-saturating)

A step makes ``d_steps`` critic updates, each on a fresh batch and its
own z_d, then one G update with z_g against the updated critic; Adam
(Kingma & Ba 2015) updates each side with its own count. Weights are
``[in, out]``, as the checkpoint holds them. Autograd in float32 with
TF32 off; the rows and the noise follow ``order.py``.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from harness import roofline
from reference import order
from reference.float32 import strict

G_KEYS = [f"['g_params'][{i}]['{k}']" for i in (0, 1) for k in ("w", "b")]
D_KEYS = [f"['d_params'][{i}]['{k}']" for i in (0, 1) for k in ("w", "b")]


def leaves(c: dict) -> List[Tuple[str, tuple, float]]:
    """(path, shape, init bound) of every weight: U(-1/sqrt(fan_in),
    1/sqrt(fan_in)), biases too."""
    z, h, x = c["z_dim"], c["hidden_dim"], c["image_dim"]
    out = []
    for side, dims in (("g_params", (z, h, x)), ("d_params", (x, h, 1))):
        for i in (0, 1):
            k, n = dims[i], dims[i + 1]
            b = 1.0 / math.sqrt(k)
            out += [(f"['{side}'][{i}]['w']", (k, n), b),
                    (f"['{side}'][{i}]['b']", (n,), b)]
    return out


def generator(p, z):
    w1, b1, w2, b2 = (p[k] for k in G_KEYS)
    return torch.sigmoid(F.relu(z @ w1 + b1) @ w2 + b2)


def critic(p, x, slope):
    w1, b1, w2, b2 = (p[k] for k in D_KEYS)
    return F.leaky_relu(x @ w1 + b1, slope) @ w2 + b2


def _adam(p, g, m, v, t, lr, c):
    b1, b2, eps = c["adam_b1"], c["adam_b2"], c["adam_eps"]
    m.mul_(b1).add_((1.0 - b1) * g)
    v.mul_(b2).add_((1.0 - b2) * g * g)
    mh = m / (1.0 - b1 ** t)
    vh = v / (1.0 - b2 ** t)
    return p - lr * mh / (torch.sqrt(vh) + eps)


def margin(p, x, z_d, z_g) -> float:
    """The least |pre-activation| of a step's hidden units: D's on the
    real rows `x` and on G's rows from `z_d`, G's own from `z_d` and
    `z_g`, and D's on G's rows from `z_g`. Near 0, rounding picks the
    (Leaky)ReLU's slope, and two correct sums can take different ones."""
    w1g, b1g = p[G_KEYS[0]], p[G_KEYS[1]]
    w1d, b1d = p[D_KEYS[0]], p[D_KEYS[1]]
    us = [x @ w1d + b1d, z_d @ w1g + b1g, z_g @ w1g + b1g,
          generator(p, z_d) @ w1d + b1d, generator(p, z_g) @ w1d + b1d]
    return min(float(u.abs().min()) for u in us)


def train(params: Dict[str, torch.Tensor], images: torch.Tensor, seed: int,
          words, steps: int, c: dict, batch: int, first_step: int = 0,
          opt=None, margins=None):
    """`steps` training steps from `params` (path -> tensor) at global
    step `first_step`, on the split `images` [rows, X] of the run
    seeded `seed` with the checkpoint's ``rng`` `words`, from Adam's
    state `opt` (``{"mu": {path: t}, "nu": {path: t}, "count": {"d": n,
    "g": n}}``; fresh where None). Returns (each step's (d_loss, g_loss)
    as floats, the first step's gradients as the optimizers get them by
    path, the parameters after, Adam's state after). Each step's
    :func:`margin`, before its updates, is appended to `margins` when
    given."""
    dev = images.device
    ds, slope = max(c["d_steps"], 1), c["leaky_slope"]
    p = {k: v.detach().clone().float() for k, v in params.items()}
    if opt is None:
        m = {k: torch.zeros_like(v) for k, v in p.items()}
        v2 = {k: torch.zeros_like(v) for k, v in p.items()}
        t_d = t_g = 0
    else:
        m = {k: opt["mu"][k].detach().clone().float() for k in p}
        v2 = {k: opt["nu"][k].detach().clone().float() for k in p}
        t_d, t_g = opt["count"]["d"], opt["count"]["g"]
    losses, first = [], {}
    with strict():
        for s in range(first_step, first_step + steps):
            idx = order.step_rows(seed, s, batch, ds, images.shape[0], dev)
            z_d, z_g = order.gan_noise(words, s, ds, batch, c["z_dim"], dev)
            if margins is not None:
                with torch.no_grad():
                    margins.append(margin(p, images[idx[0]], z_d[0], z_g))
            for i in range(ds):
                d = {k: p[k].requires_grad_(True) for k in D_KEYS}
                with torch.no_grad():
                    fake = generator(p, z_d[i])
                d_loss = (F.softplus(-critic(d, images[idx[i]], slope)).mean()
                          + F.softplus(critic(d, fake, slope)).mean())
                grads = torch.autograd.grad(d_loss, [d[k] for k in D_KEYS])
                t_d += 1
                for k, g in zip(D_KEYS, grads):
                    if s == first_step and i == 0:
                        first[k] = g.detach().clone()
                    p[k] = _adam(p[k].detach(), g, m[k], v2[k], t_d,
                                 c["d_lr"], c)
            gp = {k: p[k].requires_grad_(True) for k in G_KEYS}
            dd = {k: p[k].detach() for k in D_KEYS}
            g_loss = F.softplus(-critic(dd, generator(gp, z_g), slope)).mean()
            grads = torch.autograd.grad(g_loss, [gp[k] for k in G_KEYS])
            t_g += 1
            for k, g in zip(G_KEYS, grads):
                if s == first_step:
                    first[k] = g.detach().clone()
                p[k] = _adam(p[k].detach(), g, m[k], v2[k], t_g, c["g_lr"], c)
            losses.append((float(d_loss.detach()), float(g_loss.detach())))
    return (losses, first, {k: t.detach() for k, t in p.items()},
            {"mu": m, "nu": v2, "count": {"d": t_d, "g": t_g}})


def flops_per_step(c: dict, batch: int) -> float:
    """The FLOPs one training step requires (``roofline``'s frozen
    ``chunk_flops_per_step``)."""
    return roofline.chunk_flops_per_step(
        batch, max(c["d_steps"], 1), c["z_dim"], c["hidden_dim"],
        c["image_dim"], c["hidden_dim"])


def chunk_bound_s(c: dict, batch: int, steps: int) -> float:
    """The least time a chunk of `steps` training steps could take on
    the card (``roofline``'s frozen ``chunk_bound``)."""
    return roofline.chunk_bound(
        steps, batch, c["z_dim"], c["hidden_dim"], c["image_dim"],
        c["hidden_dim"], max(c["d_steps"], 1),
        bf16=c.get("dtype") == "bfloat16")[0]
