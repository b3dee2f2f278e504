"""Plain reference of ``ddpm-mlp``: DDPM (Ho, Jain & Abbeel 2020,
arXiv:2006.11239) sampled over S evenly strided timesteps with DDIM's
update at eta (Song, Meng & Ermon, arXiv:2010.02502), with the repo's
MLP noise predictor.

Schedule: T steps, betas linear from ``beta_start`` to ``beta_end``,
abar_t = prod_{s <= t} (1 - beta_s) (computed in float64, used as float32
scalars); the S timesteps are round(linspace(T - 1, 0, S)).

Net, eps(x, t) with x [n, X] in [-1, 1]:

    e   = [sin(t f), cos(t f)],  f_j = exp(-log(10000) j / (td/2 - 1))
    e   = silu(e W0 + b0) W1 + b1                    (the time MLP)
    h   = silu(x Win + bin + e Wt1 + bt1)
    h   = silu(h Wmid + bmid + e Wt2 + bt2)
    eps = h Wout + bout + x Wskip + bskip

Reverse step from t to the next timestep (abar_prev = 1 after the last):

    x0  = clamp((x - sqrt(1 - abar) eps) / sqrt(abar), -1, 1)
    sig = eta sqrt((1 - abar_prev) / (1 - abar)) sqrt(1 - abar / abar_prev)
    x   = sqrt(abar_prev) x0 + sqrt(1 - abar_prev - sig^2) eps + sig z

and the image is clamp((x + 1) / 2, 0, 1). Every step's t is the same
for all rows, so the time path runs once a step on one row. Float32,
TF32 off; with ``tf32=True`` the products run in TF32 instead (the
control).
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from reference.float32 import strict, tf32_round

LAYERS = ("in", "t1", "mid", "t2", "out", "skip")


def _shapes(c: dict) -> Dict[str, Tuple[int, int]]:
    x, h, td = c["image_dim"], c["hidden_dim"], c["ddpm_time_dim"]
    return {"time0": (td, td), "time1": (td, td), "in": (x, h),
            "t1": (td, h), "mid": (h, h), "t2": (td, h), "out": (h, x),
            "skip": (x, x)}


def _path(tree: str, layer: str, k: str) -> str:
    if layer.startswith("time"):
        return f"['{tree}']['time']['l'][{layer[4]}]['{k}']"
    return f"['{tree}']['{layer}']['{k}']"


def leaves(c: dict) -> List[Tuple[str, tuple, float]]:
    """(path, shape, init bound) of the live weights and of their EMA,
    each drawn on its own: U(-1/sqrt(fan_in), 1/sqrt(fan_in)), every leaf
    (``out`` and ``skip`` too, which the program's own init zeroes)."""
    out = []
    for tree in ("params", "ema"):
        for layer, (k, n) in _shapes(c).items():
            b = 1.0 / math.sqrt(k)
            out += [(_path(tree, layer, "w"), (k, n), b),
                    (_path(tree, layer, "b"), (n,), b)]
    return out


def served(weights: Dict[str, torch.Tensor], c: dict):
    """The weights sampling reads, by layer: the EMA with
    ``ema_decay`` > 0, else the live ones."""
    tree = "ema" if c.get("ema_decay", 0.0) > 0 else "params"
    return {layer: (weights[_path(tree, layer, "w")],
                    weights[_path(tree, layer, "b")]) for layer in _shapes(c)}


def schedule(c: dict, steps: int):
    """(t [S] ints, abar_t [S], abar_prev [S]) float64, noisiest first."""
    t_count = c["ddpm_timesteps"]
    betas = np.linspace(c["ddpm_beta_start"], c["ddpm_beta_end"], t_count)
    abar = np.cumprod(1.0 - betas)
    ts = np.round(np.linspace(t_count - 1, 0, steps)).astype(np.int64)
    ab = abar[ts]
    return ts, ab, np.concatenate([ab[1:], [1.0]])


def _mm(a, b, tf32):
    if tf32 and a.device.type == "cpu":  # no TF32 on the CPU: round
        a, b = tf32_round(a), tf32_round(b)
    return a @ b


def net(p, x, t: int, c: dict, tf32: bool = False) -> torch.Tensor:
    half = c["ddpm_time_dim"] // 2
    f = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=x.device) / (half - 1))
    arg = (torch.tensor(float(t), device=x.device) * f)[None, :]
    e = torch.cat([torch.sin(arg), torch.cos(arg)], 1)

    def lin(name, a):
        w, b = p[name]
        return _mm(a, w, tf32) + b
    e = lin("time1", F.silu(lin("time0", e)))
    h = F.silu(lin("in", x) + lin("t1", e))
    h = F.silu(lin("mid", h) + lin("t2", e))
    return lin("out", h) + lin("skip", x)


def sample(weights: Dict[str, torch.Tensor], z: torch.Tensor, chain,
           c: dict, steps: int, tf32: bool = False) -> torch.Tensor:
    """Images [n, X] in [0, 1] from the initial x `z` [n, X] and the
    reverse steps' noise ``chain(k)`` [n, X], through `steps` strided
    steps, with the weights sampling reads."""
    p = {k: (w.float(), b.float()) for k, (w, b) in served(weights,
                                                           c).items()}
    ts, ab, abp = schedule(c, steps)
    eta = c["ddpm_eta"]
    x = z.float()
    with strict(tf32), torch.no_grad():
        for k in range(len(ts)):
            eps = net(p, x, int(ts[k]), c, tf32)
            sig = eta * math.sqrt((1 - abp[k]) / (1 - ab[k])) * math.sqrt(
                max(1 - ab[k] / abp[k], 0.0))
            x0 = torch.clamp((x - math.sqrt(1 - ab[k]) * eps)
                             / math.sqrt(ab[k]), -1.0, 1.0)
            x = (math.sqrt(abp[k]) * x0
                 + math.sqrt(max(1 - abp[k] - sig * sig, 0.0)) * eps)
            if eta > 0:
                x = x + sig * chain(k)
    return torch.clamp((x + 1.0) * 0.5, 0.0, 1.0)


def flops_per_image(c: dict, n: int, steps: int) -> float:
    """The FLOPs one image of a request of `n` requires over `steps`
    reverse steps: the row layers (``in``, ``mid``, ``out``, ``skip``) at
    every step, and the time path (the time MLP, ``t1``, ``t2``), which
    every row of a step shares, once a step."""
    x, h, td = c["image_dim"], c["hidden_dim"], c["ddpm_time_dim"]
    rows = 2.0 * (x * h + h * h + h * x + x * x)
    time = 2.0 * (2 * td * td + 2 * td * h)
    return steps * (rows + time / n)
