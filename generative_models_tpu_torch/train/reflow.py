"""Reflow / 2-rectified flow (Liu, Gong & Liu 2022 §3.2) — the port of
``generative_models_tpu/train/reflow.py``: distil a trained flow model
into one whose ODE is straight enough for 1-2 step sampling, by training
the same objective on the teacher's own couplings.

1. :func:`load_teacher_params` — a flow checkpoint's sampling params (the
   EMA when the file holds one), from either package's npz layout.
2. :func:`build_reflow_data` — the teacher's ODE from prior draws (Heun
   at 50 steps by default), rows ``[x1_hat in [0, 1] | x0]`` of width
   2 * image_dim in the Trainer's data-dict form, labels zero.
3. The student trains with ``Config.flow_reflow``: the flow loss reads x0
   from the batch.
4. :func:`init_student` — the student starts at the teacher's weights with
   a fresh optimizer and its EMA reset to the params.

CLI: ``python -m generative_models_tpu_torch --variant flow --reflow-from
runs/teacher.npz --steps 20000`` (``--reflow-fresh-init`` skips 4).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from generative_models_tpu_torch.config import Config
from generative_models_tpu_torch.train.optim import init_opt
from generative_models_tpu_torch.utils.tree import tree_map


def load_teacher_params(path: str, cfg: Config, device="cuda"):
    """A flow checkpoint's sampling params on `device`: its EMA when it
    has one, else its params. `cfg` describes the teacher's net; whether
    the file holds an EMA is read from the file."""
    from generative_models_tpu_torch.utils.checkpoint import (
        load_jax_checkpoint,
        params_from_numpy,
        read_leaves,
    )
    has_ema = any(p.startswith("['ema']") for p in read_leaves(path))
    tcfg = cfg.replace(variant="flow", flow_reflow=False,
                       ema_decay=(cfg.ema_decay or 0.999) if has_ema else 0.0)
    loaded = load_jax_checkpoint(path, tcfg)
    return params_from_numpy(loaded.get("ema", loaded["params"]), device)


def build_reflow_data(teacher_params, cfg: Config, n_train: int = 60000,
                      n_test: int = 2048, seed: Optional[int] = None,
                      gen_steps: int = 50, gen_solver: str = "heun",
                      batch_size: int = 2048) -> Dict[str, np.ndarray]:
    """Teacher couplings as the Trainer's data dict: ``x_train`` [n_train,
    2 * image_dim] and ``x_test`` [n_test, ...] float32 (the test split
    from its own draws, so ``evaluate("test")`` reads unseen pairs), the
    labels int32 zeros. The ODE runs at (`gen_steps`, `gen_solver`),
    whatever the student's serving steps; the draws come from generators
    seeded by (`seed`, the split) on the teacher's device."""
    from generative_models_tpu_torch.losses.flow import generate_pairs
    from generative_models_tpu_torch.utils.tree import tree_device
    gen_cfg = cfg.replace(flow_sample_steps=gen_steps, flow_solver=gen_solver,
                          flow_reflow=False)
    seed = cfg.seed if seed is None else seed
    dev = tree_device(teacher_params)

    def split(role, n):
        gen = torch.Generator(device=dev).manual_seed(
            (seed % 2 ** 31) * 2 + role)
        return generate_pairs(teacher_params, gen, n, gen_cfg,
                              batch_size=batch_size).cpu().numpy()
    return {"x_train": split(0, n_train),
            "y_train": np.zeros((n_train,), np.int32),
            "x_test": split(1, n_test),
            "y_test": np.zeros((n_test,), np.int32)}


def init_student(trainer, teacher_params) -> None:
    """Start the student at the teacher's weights (copied onto its device)
    with a fresh optimizer, and its EMA, if it keeps one, at the same
    weights."""
    st = dict(trainer.state)
    st["params"] = tree_map(lambda t: t.detach().to(trainer.device,
                                                    copy=True),
                            teacher_params)
    st["opt"] = init_opt(trainer.cfg, st["params"])
    if "ema" in st:
        st["ema"] = tree_map(lambda t: t.clone(), st["params"])
    trainer.state = st
