"""Flow matching / rectified flow (Lipman et al. 2023; Liu, Gong & Liu
2022) — the port of ``generative_models_tpu/losses/flow.py``.

Training regresses the velocity of the straight path from noise to data:

    t ~ U[0, 1),  x0 ~ N(0, I),  x1 = data in [-1, 1]
    x_t = (1 - t) x0 + t x1,  L = mean || v_theta(x_t, t) - (x1 - x0) ||^2

on the DDPM family's nets (``models/ddpm_net.py``), t fed to the
embedding as ``t * T_EMB_SCALE``. With ``cfg.flow_reflow`` (2-rectified
flow) the batch rows are teacher couplings ``[x1_hat in [0, 1] | x0]``,
2 * image_dim wide (``train/reflow.py``), and x0 comes from them.
Conditioning and guidance reuse the DDPM fields. A step's draws are
DDPM's row (``losses/ddpm.py::pack_draws``) with t a uniform in [0, 1).

Sampling integrates dx/dt = v_theta(x, t) from t 0 (noise) to 1 over
``flow_sample_steps`` uniform steps: Euler, or Heun (two evaluations a
step); guided, one 2n-row net call an evaluation. Its initial x is ``z``
when given. :func:`generate_pairs` makes reflow's couplings, a host loop
over fixed-width chunks.
"""

from __future__ import annotations

import numpy as np
import torch

from generative_models_tpu_torch.losses import ddpm
from generative_models_tpu_torch.losses.base import SingleModelSpec
from generative_models_tpu_torch.models import ddpm_net
from generative_models_tpu_torch.utils.tree import tree_device

# continuous t in [0, 1] -> the frequency range integer DDPM timesteps
# cover; a constant, as in the reference
T_EMB_SCALE = 1000.0


def init_params(gen, cfg, device="cpu"):
    return ddpm_net.net_init(gen, cfg, device)


def draw_t(gen, lead, cfg) -> torch.Tensor:
    return torch.rand(tuple(lead), generator=gen, device=gen.device)


def draw_noise(gen, lead, cfg, device):
    return ddpm.draw_rows(gen, lead, cfg, device, draw_t)


def loss(params, batch, gen, cfg, eps=None):
    img = batch["image"]
    if eps is None:
        eps = draw_noise(gen, (img.shape[0],), cfg, img.device)
    t, noise, u = ddpm.unpack_draws(eps, cfg)
    if cfg.flow_reflow:
        d = cfg.image_dim   # teacher couplings [x1_hat | x0]
        x1 = 2.0 * img[:, :d] - 1.0
        x0 = img[:, d:]
    else:
        x1 = 2.0 * img - 1.0                  # [0, 1] -> [-1, 1]
        x0 = noise
    xt = (1.0 - t)[:, None] * x0 + t[:, None] * x1
    target = x1 - x0
    y = ddpm.drop_labels(batch.get("label"), u, cfg)
    pred = ddpm_net.net_apply(params, xt, t * T_EMB_SCALE, cfg, y)
    val = torch.mean((pred - target) ** 2)
    return val, {"loss": val}


def _velocity(params, x, t, cfg, y, y2):
    """v_theta at the float32 time t (the guided pair as one 2n-row
    call)."""
    return ddpm.guided_apply(params, x, float(np.float32(t)
                                              * np.float32(T_EMB_SCALE)),
                             cfg, y, y2)


def integrate(params, x0, cfg, y=None, y2=None):
    """x(1) in model scale [-1, 1] from x(0) = x0 over flow_sample_steps
    uniform steps of ``cfg.flow_solver``; the times are the reference's
    float32 ``arange(S) * dt``."""
    s_count = cfg.flow_sample_steps
    dt = 1.0 / s_count
    ts = np.arange(s_count, dtype=np.float32) * np.float32(dt)
    x = x0
    for t in ts:
        v1 = _velocity(params, x, t, cfg, y, y2)
        if cfg.flow_solver == "heun":
            v2 = _velocity(params, x + dt * v1, t + np.float32(dt), cfg, y,
                           y2)
            x = x + dt * 0.5 * (v1 + v2)
        else:
            x = x + dt * v1
    return x


def _sample_with_labels(params, gen, n, cfg, y, z=None):
    x0 = ddpm.draw_initial(gen, n, cfg, tree_device(params)) if z is None \
        else z
    x = integrate(params, x0, cfg, y, ddpm.guided_labels(y, n, cfg))
    return torch.clamp((x + 1.0) * 0.5, 0.0, 1.0)   # [-1, 1] -> [0, 1]


def sample(params, gen, n, cfg, z=None):
    """n images [n, image_dim] in [0, 1] from the initial x `z` [n,
    image_dim], else drawn from `gen`."""
    return _sample_with_labels(params, gen, n, cfg,
                               ddpm.sample_labels(n, cfg, tree_device(params)),
                               z)


def sample_class(params, gen, n, label, cfg, z=None):
    """All-one-class conditional sampling."""
    y = torch.full((n,), label, dtype=torch.int64,
                   device=tree_device(params))
    return _sample_with_labels(params, gen, n, cfg, y, z)


@torch.no_grad()
def generate_pairs(params, gen, n, cfg, batch_size=2048, x0=None):
    """Teacher couplings for reflow, [n, 2 * image_dim] rows [x1_hat in
    [0, 1] | x0]: each chunk of `batch_size` rows draws x0 from the prior
    (`x0` [n, image_dim] when given instead), integrates the teacher's ODE
    unconditionally and clips x1_hat as :func:`sample` does."""
    dev = tree_device(params)
    bs = min(batch_size, n)
    chunks = []
    for c in range(-(-n // bs)):
        a = (ddpm.draw_initial(gen, bs, cfg, dev) if x0 is None
             else x0[c * bs:(c + 1) * bs].to(dev))
        x1 = torch.clamp((integrate(params, a, cfg) + 1.0) * 0.5, 0.0, 1.0)
        chunks.append(torch.cat([x1, a], dim=1))
    return torch.cat(chunks)[:n]


FLOW = SingleModelSpec(
    name="flow",
    init_params=init_params,
    loss=loss,
    sample=sample,
    step_lanes=ddpm.step_lanes,
    draw_noise=draw_noise,
    sample_lanes=ddpm.image_lanes,
)
