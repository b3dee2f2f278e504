"""Two-stage VQ training (Oord et al. 2017 §3.3) — the port of
``generative_models_tpu/train/vq.py``:

  1. stage 1: ``python -m generative_models_tpu_torch --variant vqvae
     --ckpt runs/vq.npz``
  2. the prior: ``python -m generative_models_tpu_torch --variant vqprior
     --vq-from runs/vq.npz --steps ...``

``--vq-from`` (``cli.py``) loads the vqvae checkpoint of either package
(:func:`load_vqvae_params`) into the prior run's ``params["vqvae"]``
(:func:`init_prior_with_vqvae`) and sets ``Config.vq_freeze_tokenizer``:
the loss detaches the subtree, so it and its Adam moments stay bit-exact.
"""

from __future__ import annotations

from generative_models_tpu_torch.config import Config
from generative_models_tpu_torch.utils.tree import tree_map


def load_vqvae_params(path: str, cfg: Config, device="cuda"):
    """A vqvae checkpoint's params on `device`: its EMA when the file
    holds one, else its params. `cfg` describes the tokenizer (arch and
    the vq_* widths); the prior's fields are not read."""
    from generative_models_tpu_torch.utils.checkpoint import (
        load_jax_checkpoint,
        params_from_numpy,
        read_leaves,
    )
    has_ema = any(p.startswith("['ema']") for p in read_leaves(path))
    vcfg = cfg.replace(variant="vqvae", vq_freeze_tokenizer=False,
                       ema_decay=(cfg.ema_decay or 0.999) if has_ema else 0.0)
    loaded = load_jax_checkpoint(path, vcfg)
    return params_from_numpy(loaded.get("ema", loaded["params"]), device)


def init_prior_with_vqvae(trainer, vq_params) -> None:
    """Overwrite the prior run's ``params["vqvae"]`` (and its EMA's) with
    the trained stage-1 weights, copied onto the Trainer's device. The
    optimizer state stays: its slots are zeros of the same shapes, and
    the frozen subtree's zero gradients keep them so."""
    st = dict(trainer.state)
    vq = tree_map(lambda t: t.detach().to(trainer.device, copy=True),
                  vq_params)
    st["params"] = dict(st["params"], vqvae=vq)
    if "ema" in st:
        st["ema"] = dict(st["ema"], vqvae=tree_map(lambda t: t.clone(), vq))
    trainer.state = st
