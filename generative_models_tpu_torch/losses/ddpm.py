"""DDPM (Ho, Jain & Abbeel 2020) — the port of
``generative_models_tpu/losses/ddpm.py``. One model, one optimizer (the
``SingleModelSpec`` slot of the VAE family).

Training, the "simple" objective:

    t ~ U{0..T-1},  eps ~ N(0, I),  x_t = sqrt(abar_t) x_0 + sqrt(1 - abar_t) eps
    L = mean || eps_theta(x_t, t) - eps ||^2

with pixels mapped [0, 1] -> [-1, 1]. With ``cfg.ddpm_cond`` the label is
replaced by the null token with probability ``ddpm_label_drop``
(classifier-free guidance's label dropout).

A step's draws ride in one row a sample, ``[noise (image_dim) | t |
u]`` (:func:`pack_draws`): the noise, the timestep (an integer held as a
float) and the label-drop uniform. The loss takes them explicitly
(``eps=``), as the VAE's takes its eps, or draws them from the generator
it is given (:func:`draw_noise`), so the train step's noise contract is
unchanged: a [B, image_dim + 2] tensor a step on the CPU grid, one
generator a step on the card.

Sampling (Ho's Algorithm 2, generalised per DDIM) runs over an evenly
strided descending subsequence of S <= T timesteps (``ddpm_sample_steps``,
0 the full chain). The subsequence is the reference's: it rounds
``jnp.linspace(T - 1, 0, S)`` in float32, half to even, which
:func:`linspace_f32` computes the way XLA does; an entry whose exact
value is a half-integer (499.5 at T 1000, S 999) goes to whichever side
float32 rounding puts it, and ``torch.linspace`` rounds 172 of the 1000
S at T 1000 to other timesteps (at S 999 it gives 499 where JAX gives
500). Its per-step constants are float32 as in the reference's scan. The sampler
takes its initial x (``z``) and each step's noise (``chain``: step i ->
[n, image_dim]) explicitly, or draws them from the generator; with
guidance it makes one 2n-row net call a step.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from generative_models_tpu_torch.losses.base import SingleModelSpec
from generative_models_tpu_torch.models import ddpm_net
from generative_models_tpu_torch.utils import spans
from generative_models_tpu_torch.utils.tree import tree_device


# How the reference's ``jnp.linspace`` rounds (XLA's CPU code, JAX 0.9):
# step = i * (1 / div) (a division by a constant becomes a multiply by its
# reciprocal), out = start * (1 - step) + stop * step in float32; from
# LINSPACE_FMA_MIN entries on, a LINSPACE_LANES-wide loop computes
# 1 - i * (1 / div) as one fused multiply-add, the last div % LANES
# entries without. A one-off sweep of every S at T 20, 50, 100 and 1000
# found this rule to give JAX's rounded timesteps at every entry.
LINSPACE_FMA_MIN = 355
LINSPACE_LANES = 16


def linspace_f32(start: float, stop: float, num: int) -> np.ndarray:
    """``jnp.linspace(start, stop, num)`` in float32 as the reference
    computes it (see LINSPACE_FMA_MIN), `stop` itself last."""
    start, stop = np.float32(start), np.float32(stop)
    if num == 1:
        return np.array([start], np.float32)
    div = num - 1
    r = np.float32(1) / np.float32(div)
    i = np.arange(div, dtype=np.float32)
    step = i * r
    one_minus = np.float32(1) - step
    if num >= LINSPACE_FMA_MIN:
        cut = div // LINSPACE_LANES * LINSPACE_LANES
        # fma(-i, r, 1): the product and the difference are exact in
        # float64 (i < 2^11, r 24 bits), so one rounding to float32
        one_minus[:cut] = (1.0 - i[:cut].astype(np.float64)
                           * np.float64(r)).astype(np.float32)
    out = start * one_minus + stop * step
    return np.concatenate([out, [stop]]).astype(np.float32)


def alphas_bar(cfg) -> np.ndarray:
    """abar_t = prod_{s <= t} alpha_s, t = 0..T-1, float32 [T], a running
    product in order. "linear": betas linearly spaced beta_start..beta_end;
    "cosine": f(t) = cos^2((t/T + s)/(1 + s) pi/2), s = 0.008, through
    per-step alphas clipped to at least 1 - 0.999."""
    return _alphas_bar(cfg.ddpm_timesteps, cfg.ddpm_schedule,
                       cfg.ddpm_beta_start, cfg.ddpm_beta_end).copy()


@functools.lru_cache(maxsize=8)
def _alphas_bar(t_count, schedule, beta_start, beta_end) -> np.ndarray:
    if schedule == "cosine":
        s = 0.008
        grid = np.arange(t_count + 1, dtype=np.float32) / np.float32(t_count)
        f = np.cos((grid + np.float32(s)) / np.float32(1.0 + s)
                   * np.float32(np.pi / 2.0)) ** 2
        abar_grid = f / f[0]
        alphas = np.clip(abar_grid[1:] / abar_grid[:-1],
                         np.float32(1.0 - 0.999), np.float32(1.0))
    else:
        betas = linspace_f32(beta_start, beta_end, t_count)
        alphas = np.float32(1) - betas
    return np.cumprod(alphas.astype(np.float32), dtype=np.float32)


@functools.lru_cache(maxsize=8)
def _alphas_bar_on(t_count, schedule, beta_start, beta_end, device):
    return torch.from_numpy(_alphas_bar(t_count, schedule, beta_start,
                                        beta_end).copy()).to(device)


def init_params(gen, cfg, device="cpu"):
    return ddpm_net.net_init(gen, cfg, device)


def step_lanes(cfg) -> int:
    """Width of a step's draws a sample: the noise, t and u."""
    return cfg.image_dim + 2


def pack_draws(t, noise, u) -> torch.Tensor:
    """One row a sample, [noise | t | u]: t [B] the timesteps (DDPM's
    integers, flow's uniforms), noise [B, image_dim], u [B] the
    label-drop uniforms."""
    return torch.cat([noise, t.to(noise.dtype)[:, None],
                      u.to(noise.dtype)[:, None]], dim=-1)


def unpack_draws(rows, cfg):
    """(t [B], noise [B, image_dim], u [B]) of :func:`pack_draws` rows."""
    d = cfg.image_dim
    return rows[:, d], rows[:, :d], rows[:, d + 1]


def draw_t(gen, lead, cfg) -> torch.Tensor:
    return torch.randint(0, cfg.ddpm_timesteps, tuple(lead), generator=gen,
                         device=gen.device).to(torch.float32)


def draw_rows(gen, lead, cfg, device, t_of):
    """A step's draws [*lead, image_dim + 2] from `gen`: the noise, then
    t (`t_of(gen, lead, cfg)`), then the label-drop uniforms."""
    noise = torch.randn(tuple(lead) + (cfg.image_dim,), generator=gen,
                        device=gen.device)
    t = t_of(gen, lead, cfg)
    u = torch.rand(tuple(lead), generator=gen, device=gen.device)
    return torch.cat([noise, t[..., None], u[..., None]], dim=-1).to(device)


def draw_noise(gen, lead, cfg, device):
    return draw_rows(gen, lead, cfg, device, draw_t)


def drop_labels(labels, u, cfg):
    """Labels with the null token (num_classes) where u < ddpm_label_drop,
    or None without ``ddpm_cond``."""
    if not cfg.ddpm_cond:
        return None
    return torch.where(u < cfg.ddpm_label_drop,
                       torch.full_like(labels.long(), cfg.num_classes),
                       labels.long())


def loss(params, batch, gen, cfg, eps=None):
    x0 = 2.0 * batch["image"] - 1.0            # [0, 1] -> [-1, 1]
    if eps is None:
        eps = draw_noise(gen, (x0.shape[0],), cfg, x0.device)
    t, noise, u = unpack_draws(eps, cfg)
    t = t.long()
    abar = _alphas_bar_on(cfg.ddpm_timesteps, cfg.ddpm_schedule,
                          cfg.ddpm_beta_start, cfg.ddpm_beta_end,
                          x0.device)[t][:, None]
    xt = torch.sqrt(abar) * x0 + torch.sqrt(1.0 - abar) * noise
    y = drop_labels(batch.get("label"), u, cfg)
    pred = ddpm_net.net_apply(params, xt, t, cfg, y)
    val = torch.mean((pred - noise) ** 2)
    return val, {"loss": val}


def sample_schedule(cfg):
    """The reverse chain's per-step constants, noisiest step first, as
    numpy: (t [S] int64, abar_t [S], abar_prev [S]) float32, abar_prev of
    the last (t -> data) step 1."""
    t_count = cfg.ddpm_timesteps
    s_count = cfg.ddpm_sample_steps or t_count
    ts = np.round(linspace_f32(t_count - 1, 0.0, s_count)).astype(np.int64)
    ab_t = alphas_bar(cfg)[ts]
    ab_prev = np.concatenate([ab_t[1:], np.ones(1, np.float32)])
    return ts, ab_t, ab_prev


def _step_coefs(ab, abp, eta):
    """float32 scalars of one reverse step, in the reference's order:
    (sqrt(1 - ab), sqrt(ab), sqrt(abp), dir_coef, sigma)."""
    one = np.float32(1)
    sigma = (np.float32(eta) * np.sqrt((one - abp) / (one - ab))
             * np.sqrt(np.maximum(one - ab / abp, np.float32(0))))
    dir_coef = np.sqrt(np.maximum(one - abp - sigma * sigma, np.float32(0)))
    return tuple(float(np.float32(v)) for v in (
        np.sqrt(one - ab), np.sqrt(ab), np.sqrt(abp), dir_coef, sigma))


def draw_initial(gen, n, cfg, device):
    return torch.randn((n, cfg.image_dim), generator=gen,
                       device=gen.device).to(device)


def guided_labels(y, n, cfg):
    """[y | null tokens] for one 2n-row guided call, or None when the
    sampler is not guided."""
    if not (cfg.ddpm_cond and cfg.ddpm_guidance > 0.0 and y is not None):
        return None
    return torch.cat([y.long(), torch.full((n,), cfg.num_classes,
                                           dtype=torch.int64,
                                           device=y.device)])


def guided_apply(params, x, t_row, cfg, y, y2):
    """The net at one step (t_row: the step's timestep, a float): with
    `y2` the conditional and null-token predictions as ONE 2n-row call,
    mixed (1 + w) cond - w null."""
    n = x.shape[0]
    if y2 is not None:
        w = float(cfg.ddpm_guidance)
        t = torch.full((2 * n,), t_row, dtype=torch.float32, device=x.device)
        e2 = ddpm_net.net_apply(params, torch.cat([x, x]), t, cfg, y2)
        return (1.0 + w) * e2[:n] - w * e2[n:]
    t = torch.full((n,), t_row, dtype=torch.float32, device=x.device)
    return ddpm_net.net_apply(params, x, t, cfg, y)


def _sample_with_labels(params, gen, n, cfg, y, z=None, chain=None):
    dev = tree_device(params)
    ts, ab_t, ab_prev = sample_schedule(cfg)
    x = draw_initial(gen, n, cfg, dev) if z is None else z
    if chain is None:
        def chain(i):
            return torch.randn((n, cfg.image_dim), generator=gen,
                               device=gen.device).to(dev)
    y2 = guided_labels(y, n, cfg)
    for i in range(len(ts)):
        with spans.span("sampler.step", i):
            eps = guided_apply(params, x, float(ts[i]), cfg, y, y2)
            c_n, c_t, c_p, c_dir, sigma = _step_coefs(ab_t[i], ab_prev[i],
                                                      cfg.ddpm_eta)
            x0_hat = torch.clamp((x - c_n * eps) / c_t, -1.0, 1.0)
            x = c_p * x0_hat + c_dir * eps
            if cfg.ddpm_eta > 0:  # sigma is 0 at eta 0: no draw
                x = x + sigma * chain(i)
    return torch.clamp((x + 1.0) * 0.5, 0.0, 1.0)   # [-1, 1] -> [0, 1]


def sample_labels(n, cfg, device):
    """One column per digit with ``ddpm_cond`` (the cgan grid), else None."""
    if not cfg.ddpm_cond:
        return None
    return torch.arange(n, device=device) % cfg.num_classes


def sample(params, gen, n, cfg, z=None, chain=None):
    """n images [n, image_dim] in [0, 1]; `z` the initial x [n, image_dim]
    and `chain` step i -> its noise [n, image_dim], else drawn from
    `gen`."""
    return _sample_with_labels(params, gen, n, cfg,
                               sample_labels(n, cfg, tree_device(params)),
                               z, chain)


def sample_class(params, gen, n, label, cfg, z=None, chain=None):
    """All-one-class conditional sampling."""
    y = torch.full((n,), label, dtype=torch.int64,
                   device=tree_device(params))
    return _sample_with_labels(params, gen, n, cfg, y, z, chain)


def image_lanes(cfg) -> int:
    return cfg.image_dim


DDPM = SingleModelSpec(
    name="ddpm",
    init_params=init_params,
    loss=loss,
    sample=sample,
    step_lanes=step_lanes,
    draw_noise=draw_noise,
    sample_lanes=image_lanes,
    chain_noise=True,
)
