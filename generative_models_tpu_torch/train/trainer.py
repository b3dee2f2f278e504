"""The Trainer — the port of ``generative_models_tpu/train/trainer.py``,
serving part only: build G and D from ``cfg.seed``, load a checkpoint
written by the JAX package, and sample. Training, evaluation and saving
belong to the training slice (ROADMAP.md Queue 1).

The Trainer runs on the device it is given, ``"cuda"`` by default, and
raises when that device is missing; the CPU runs only when asked for
(``device="cpu"``), and then every kernel's plain version runs.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from generative_models_tpu_torch.config import Config, variant_config
from generative_models_tpu_torch.losses.registry import get_variant
from generative_models_tpu_torch.utils.checkpoint import (
    load_jax_checkpoint,
    params_from_numpy,
)
from generative_models_tpu_torch.utils.viz import save_image_grid


def resolve_device(device) -> torch.device:
    """`device` as a torch.device; raises if it names CUDA and none is
    present (no silent move to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but no CUDA device is present; "
            "pass device='cpu' to run the plain versions on the CPU")
    return dev


class Trainer:
    """One trainer, every ported variant (serving part).

    >>> t = Trainer("nsgan")                 # on the card
    >>> t.load_model("runs/n.npz")           # a JAX package checkpoint
    >>> t.generate_images("samples")
    """

    def __init__(self, variant: str = "nsgan",
                 config: Optional[Config] = None, device="cuda",
                 **overrides):
        cfg = config if config is not None else variant_config(
            variant, **overrides)
        if cfg.dtype == "auto":
            # no bf16 crossover has been measured on the card: float32
            cfg = cfg.replace(dtype="float32")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.spec = get_variant(cfg.variant)
        # init draws on the CPU so the weights do not depend on the device
        init_gen = torch.Generator().manual_seed(cfg.seed)
        g_params = self.spec.init_g(init_gen, cfg, device=self.device)
        self.state = {
            "g_params": g_params,
            "d_params": self.spec.init_d(init_gen, cfg, device=self.device),
            "step": 0,
        }
        if cfg.ema_decay > 0:
            self.state["g_ema"] = [dict(l) for l in g_params]
        self._sample_gen = torch.Generator(device=self.device).manual_seed(
            cfg.seed + 1)

    @property
    def generator_params(self):
        """The sampling-side params: the EMA of G when
        ``cfg.ema_decay > 0``, else G (reference ``trainer.py:524-534``)."""
        key = "g_ema" if self.cfg.ema_decay > 0 else "g_params"
        return self.state[key]

    @property
    def raw_generator_params(self):
        """The live (non-EMA) generator params."""
        return self.state["g_params"]

    @torch.no_grad()
    def sample(self, n: Optional[int] = None, z=None) -> np.ndarray:
        """n samples [n, image_dim] in [0, 1] from the generator prior, or
        from the given noise `z` [n, z_dim] (numpy or tensor)."""
        if z is not None:
            z = torch.as_tensor(z, dtype=torch.float32,
                                device=self.device).contiguous()
            n = z.shape[0]
        n = n or self.cfg.sample_n
        out = self.spec.sample(self.generator_params, self._sample_gen, n,
                               self.cfg, z=z)
        return out.cpu().numpy()

    def generate_images(self, tag: str = "samples", n: Optional[int] = None,
                        out_dir: Optional[str] = None) -> str:
        """Reference's `generate_images`: a PNG sample grid."""
        imgs = self.sample(n)
        out_dir = out_dir or os.path.join(self.cfg.out_dir, self.cfg.variant)
        return save_image_grid(os.path.join(out_dir, f"{tag}.png"), imgs)

    def load_model(self, path: str) -> None:
        """Load a checkpoint written by the JAX package's ``save_model``
        (npz layout); raises on any shape/dtype/config mismatch."""
        if self.cfg.ckpt_backend != "npz":
            raise NotImplementedError(
                f"ckpt_backend={self.cfg.ckpt_backend!r}: the port reads "
                "the npz layout only")
        self.state = params_from_numpy(load_jax_checkpoint(path, self.cfg),
                                       self.device)
