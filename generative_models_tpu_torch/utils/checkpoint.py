"""Loading the JAX package's checkpoints into the port.

The reference (``generative_models_tpu/utils/checkpoint.py``) saves the
whole train state as an ``.npz`` of ``leaf_00000, leaf_00001, ...`` plus
a ``__meta__`` JSON list giving each leaf's tree path (e.g.
``['g_params'][0]['w']``), shape and dtype. This module reads that
layout with numpy alone — no JAX — and holds every leaf the port uses
to the shape and dtype the config implies, raising on any mismatch, as
the reference's ``restore_state`` does. :func:`params_from_numpy` then
carries the weights onto a device as torch tensors.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Tuple

import numpy as np
import torch

from generative_models_tpu_torch.config import Config

_META_KEY = "__meta__"


def npz_path(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def exists(path: str) -> bool:
    return os.path.exists(npz_path(path))


def _flatten(tree, prefix: str = "") -> Dict[str, Any]:
    """Leaves by JAX key path string (``jax.tree_util.keystr``)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}['{k}']"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}[{i}]"))
        return out
    return {prefix: tree}


def _unflatten(template, leaves: Dict[str, Any], prefix: str = ""):
    if isinstance(template, dict):
        return {k: _unflatten(v, leaves, f"{prefix}['{k}']")
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return [_unflatten(v, leaves, f"{prefix}[{i}]")
                for i, v in enumerate(template)]
    return leaves[prefix]


def param_template(cfg: Config) -> Dict[str, Any]:
    """The param subtrees a serving state holds, as meta tensors (shapes
    only): g_params, d_params, and g_ema when cfg.ema_decay > 0."""
    from generative_models_tpu_torch.losses.registry import get_variant
    spec = get_variant(cfg.variant)
    gen = torch.Generator()  # the draws are discarded; shapes are read
    g = spec.init_g(gen, cfg, device="meta")
    tmpl = {"g_params": g, "d_params": spec.init_d(gen, cfg, device="meta")}
    if cfg.ema_decay > 0:
        tmpl["g_ema"] = g
    return tmpl


def read_leaves(path: str) -> Dict[str, np.ndarray]:
    """Every leaf of a reference ``.npz`` checkpoint, by tree path."""
    with np.load(npz_path(path)) as d:
        if _META_KEY not in d.files:
            raise ValueError(
                f"{path}: no {_META_KEY} entry — not a checkpoint in the "
                "JAX package's npz layout")
        meta = json.loads(str(d[_META_KEY]))
        n_leaves = len(d.files) - 1
        if len(meta) != n_leaves:
            raise ValueError(
                f"{path}: {_META_KEY} lists {len(meta)} leaves, the archive "
                f"holds {n_leaves}")
        leaves = {}
        for i, m in enumerate(meta):
            a = d[f"leaf_{i:05d}"]
            if list(a.shape) != m["shape"] or str(a.dtype) != m["dtype"]:
                raise ValueError(
                    f"{path}: leaf {i} ({m['path']!r}) is {a.shape} "
                    f"{a.dtype} but {_META_KEY} says {m['shape']} "
                    f"{m['dtype']}")
            leaves[m["path"]] = a
    return leaves


def load_jax_checkpoint(path: str, cfg: Config) -> Dict[str, Any]:
    """The serving state of a reference checkpoint as numpy arrays:
    ``{"g_params", "d_params", ["g_ema",] "step"}``, each param subtree a
    list of ``{"w", "b"}``. Raises if any leaf is missing, has another
    shape or dtype than `cfg` implies, or if a param subtree holds extra
    leaves (another depth, or an EMA the config does not expect)."""
    leaves = read_leaves(path)
    tmpl = param_template(cfg)
    want: Dict[str, Tuple[Tuple[int, ...], np.dtype]] = {
        p: (tuple(t.shape), np.dtype("float32"))
        for p, t in _flatten(tmpl).items()}
    want["['step']"] = ((), np.dtype("int32"))
    for p, (shape, dtype) in want.items():
        if p not in leaves:
            raise ValueError(
                f"{path}: no leaf {p!r} — variant/config mismatch "
                f"(variant={cfg.variant!r}, ema_decay={cfg.ema_decay})")
        a = leaves[p]
        if a.shape != shape or a.dtype != dtype:
            raise ValueError(
                f"{path}: leaf {p!r} is {a.shape} {a.dtype}, the config "
                f"expects {shape} {dtype} — refusing to silently "
                "reshape/recast")
    subtrees = ("['g_params']", "['d_params']", "['g_ema']")
    extra = sorted(p for p in leaves
                   if p.startswith(subtrees) and p not in want)
    if extra:
        raise ValueError(
            f"{path}: leaves {extra[:4]} are not in the config's model — "
            f"variant/config mismatch (ema_decay={cfg.ema_decay})")
    out = _unflatten(tmpl, leaves)
    out["step"] = int(leaves["['step']"])
    return out


def params_from_numpy(tree, device="cpu"):
    """Map every numpy array of a nested dict/list tree to a torch tensor
    of the same dtype on `device`; other leaves pass through unchanged."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_numpy(v, device) for v in tree]
    if isinstance(tree, np.ndarray):
        return torch.as_tensor(tree, device=device)
    return tree
