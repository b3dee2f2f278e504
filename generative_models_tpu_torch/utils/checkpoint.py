"""Checkpoints in the JAX package's npz layout, read and written with
numpy alone — no JAX.

The reference (``generative_models_tpu/utils/checkpoint.py``) saves the
whole train state as an ``.npz`` of ``leaf_00000, leaf_00001, ...`` plus
a ``__meta__`` JSON list giving each leaf's tree path as
``jax.tree_util.keystr`` prints it, its shape and dtype, in the order of
``jax.tree_util.tree_flatten`` (dict keys sorted). For nsgan with Adam
and an EMA the leaves are ``['d_opt'][0].count``,
``['d_opt'][0].mu[i]['b'|'w']``, ``['d_opt'][0].nu[...]``,
``['d_params'][...]``, ``['g_ema'][...]``, ``['g_opt'][0]...``,
``['g_params'][...]``, ``['rng']`` (uint32 [2]) and ``['step']`` (int32).
With RMSprop (wgan) an optimizer state is optax's ``ScaleByRmsState``,
``['d_opt'][0].nu[...]`` alone, no count; fishergan adds its carried
multiplier ``['vstate']['lam']`` (float32 scalar), began its ``['vstate']['k']``
and ``['vstate']['m']``; began's critic is an autoencoder
(``['d_params'][0]['w']`` [image_dim, began_ae_hidden], ``[1]['w']``
[began_ae_hidden, image_dim]), and infogan's a dict,
``['d_params']['d_head']['b']`` ... ``['d_params']['q_head']['w']``,
``['d_params']['trunk'][0]['w']`` (keys sorted), with G taking z_dim +
cat + cont lanes. cgan's stacks take
the one-hot label as further input lanes: ``['g_params'][0]['w']`` is
[z_dim + num_classes, hidden], ``['d_params'][0]['w']`` [image_dim +
num_classes, hidden]; the shapes come from the variant's own init, so
both directions hold them.
A single-model state (vae, birvae) holds ``['ema']`` (with an EMA),
``['opt'][0].count``, ``['opt'][0].mu['decoder'][1]['b']`` ...,
``['params']['encoder']['trunk'][0]['w']`` ..., ``['rng']``, ``['step']``.
With the amortized spectral projection (``Config.spectral_projection``,
``sn_mode="amortized"``) an adversarial state also holds the carried
vectors ``['sn_v']``, a tree shaped as ``['d_params']``: a weight's leaf
``['sn_v'][0]['w']`` is its vector [shape[-1]], every other leaf
(``['sn_v'][0]['b']``) an empty float32 [0], as the reference's
``init_sn_vectors`` builds them.

:func:`save_state` writes the port's state in exactly that layout, so a
port checkpoint restores into the JAX package's ``Trainer.load_model``;
:func:`load_jax_checkpoint` reads either package's checkpoints and holds
every leaf the port uses to the shape and dtype the config implies,
raising on any mismatch, as the reference's ``restore_state`` does. The
optimizer slots and counts are restored when the file has them. In the
port, ``['rng']`` holds the two words that seed its noise generators
(``train/step.py::noise_generator``); a JAX checkpoint's key words seed
them the same way. :func:`params_from_numpy` carries arrays onto a
device as torch tensors.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from generative_models_tpu_torch.config import Config
from generative_models_tpu_torch.losses.registry import get_variant
from generative_models_tpu_torch.ops.spectral import (
    amortized_sn,
    init_sn_vectors,
)
from generative_models_tpu_torch.utils.tree import (
    tree_leaves_with_path,
    tree_unflatten,
)

_META_KEY = "__meta__"
_PARAM_KEYS = ("g_params", "d_params", "g_ema", "params", "ema")
# trees of the state that are not parameters: the variant's carried
# scalars and the spectral projection's carried vectors
_TREE_KEYS = ("vstate", "sn_v")
_OPT_KEYS = ("g_opt", "d_opt", "opt")


def npz_path(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def exists(path: str, backend: str = "npz") -> bool:
    """Whether a checkpoint of `backend` is at `path`: the ``.npz`` file,
    or for the directory backend ("orbax") a directory, as the
    reference's ``exists``."""
    if backend == "npz":
        return os.path.exists(npz_path(path))
    return os.path.isdir(os.path.abspath(path))


def save(path: str, state: Dict[str, Any], backend: str = "npz",
         write: bool = True) -> str:
    """Save the whole train state with ``Config.ckpt_backend``'s backend:
    the npz layout (:func:`save_state`) or the directory backend
    (``utils/dcp_ckpt.py``). Returns the path written."""
    if backend == "npz":
        return save_state(path, state, write)
    if backend == "orbax":
        from generative_models_tpu_torch.utils import dcp_ckpt
        return dcp_ckpt.save_state(path, state, write)
    raise ValueError(f"unknown ckpt backend {backend!r}")


def restore(path: str, template: Dict[str, Any],
            cfg: Config) -> Dict[str, Any]:
    """The checkpoint at `path`, read with ``cfg.ckpt_backend``'s backend
    (the one place a load chooses it, as the reference's ``restore``):
    an npz of either package through :func:`load_jax_checkpoint` (the
    leaves the file has, held to `cfg`), or a directory of this one's
    through ``utils/dcp_ckpt.py`` (the whole state in `template`'s
    structure, held to its shapes and dtypes). Leaves are numpy arrays,
    ``rng`` uint32, ``step`` an int."""
    if cfg.ckpt_backend == "npz":
        return load_jax_checkpoint(path, cfg)
    if cfg.ckpt_backend == "orbax":
        from generative_models_tpu_torch.utils import dcp_ckpt
        return dcp_ckpt.restore_state(path, template)
    raise ValueError(f"unknown ckpt backend {cfg.ckpt_backend!r}")


def param_template(cfg: Config) -> Dict[str, Any]:
    """The param subtrees a state holds, as meta tensors (shapes only):
    g_params and d_params (and g_ema when cfg.ema_decay > 0) for an
    adversarial variant, params (and ema) for a single model."""
    spec = get_variant(cfg.variant)
    gen = torch.Generator()  # the draws are discarded; shapes are read
    if not spec.adversarial:
        params = spec.init_params(gen, cfg, device="meta")
        return {"params": params, **({"ema": params} if cfg.ema_decay > 0
                                     else {})}
    g = spec.init_g(gen, cfg, device="meta")
    tmpl = {"g_params": g, "d_params": spec.init_d(gen, cfg, device="meta")}
    if cfg.ema_decay > 0:
        tmpl["g_ema"] = g
    return tmpl


def _opt_pairs(tmpl) -> List[Tuple[str, str]]:
    """(optimizer state key, the param subtree it follows)."""
    if "params" in tmpl:
        return [("opt", "params")]
    return [("g_opt", "g_params"), ("d_opt", "d_params")]


def _opt_leaves(prefix: str, opt: Dict[str, Any]) -> List[Tuple[str, Any]]:
    """An optax chain state's leaves: its first element carries the slots
    (ScaleByAdamState: count, mu, nu; ScaleByRmsState: nu), the rest are
    empty."""
    p = f"{prefix}[0]"
    out = [(f"{p}.count", opt["count"])] if "count" in opt else []
    for slot in ("mu", "nu"):
        if slot in opt:
            out += tree_leaves_with_path(opt[slot], f"{p}.{slot}")
    return out


def state_leaves(state: Dict[str, Any]) -> List[Tuple[str, Any]]:
    """Every leaf of a port train state by JAX key path, in
    ``jax.tree_util.tree_flatten`` order."""
    out: List[Tuple[str, Any]] = []
    for key in sorted(state):
        v = state[key]
        if key in _OPT_KEYS:
            out += _opt_leaves(f"['{key}']", v)
        elif key in _PARAM_KEYS or key in _TREE_KEYS:
            out += tree_leaves_with_path(v, f"['{key}']")
        else:
            out.append((f"['{key}']", v))
    return out


def state_from_leaves(template: Dict[str, Any],
                      leaves: Dict[str, Any]) -> Dict[str, Any]:
    """The inverse of :func:`state_leaves`: `template`'s structure (plain
    dicts and lists) holding ``leaves[path]`` at each leaf."""
    def subtree(like, prefix):
        return tree_unflatten(like, [leaves[p] for p, _ in
                                     tree_leaves_with_path(like, prefix)])
    out: Dict[str, Any] = {}
    for key, v in template.items():
        if key in _OPT_KEYS:
            p0 = f"['{key}'][0]"
            out[key] = {slot: leaves[f"{p0}.count"] if slot == "count"
                        else subtree(sub, f"{p0}.{slot}")
                        for slot, sub in v.items()}
        elif key in _PARAM_KEYS or key in _TREE_KEYS:
            out[key] = subtree(v, f"['{key}']")
        else:
            out[key] = leaves[f"['{key}']"]
    return out


def _to_numpy(key: str, v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    if key == "['rng']":
        return np.asarray(v, dtype=np.uint32)
    if key == "['step']" or key.endswith(".count"):
        return np.asarray(v, dtype=np.int32)
    return np.asarray(v)


def save_state(path: str, state: Dict[str, Any], write: bool = True) -> str:
    """Save a port train state as an ``.npz`` in the JAX package's layout
    (same leaf paths, shapes, dtypes and order). Returns the path. A
    data-parallel rank other than 0 passes ``write=False``: the ranks'
    states are identical and rank 0 alone writes the file."""
    path = npz_path(path)
    if not write:
        return path
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    leaves = [(p, _to_numpy(p, v)) for p, v in state_leaves(state)]
    flat = {f"leaf_{i:05d}": a for i, (_, a) in enumerate(leaves)}
    meta = json.dumps([{"path": p, "shape": list(a.shape),
                        "dtype": str(a.dtype)} for p, a in leaves])
    np.savez(path, **flat, **{_META_KEY: np.array(meta)})
    return path


def read_leaves(path: str) -> Dict[str, np.ndarray]:
    """Every leaf of an npz checkpoint in the JAX layout, by tree path."""
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


def _opt_template(cfg: Config, params) -> Dict[str, Any]:
    """The optimizer state ``cfg.optimizer`` keeps, shapes only."""
    if cfg.optimizer == "adam":
        return {"count": torch.empty((), dtype=torch.int32, device="meta"),
                "mu": params, "nu": params}
    return {"nu": params}


def _check_leaves(path, leaves, want, what):
    for p, (shape, dtype) in want.items():
        if p not in leaves:
            raise ValueError(f"{path}: no leaf {p!r} — {what}")
        a = leaves[p]
        if a.shape != shape or a.dtype != dtype:
            raise ValueError(
                f"{path}: leaf {p!r} is {a.shape} {a.dtype}, the config "
                f"expects {shape} {dtype} — refusing to silently "
                "reshape/recast")


def _want(leaf_list) -> Dict[str, Tuple[Tuple[int, ...], np.dtype]]:
    return {p: (tuple(t.shape), np.dtype("int32" if p.endswith(".count")
                                         else "float32"))
            for p, t in leaf_list}


def load_jax_checkpoint(path: str, cfg: Config) -> Dict[str, Any]:
    """The train state of a checkpoint as numpy arrays: ``{"g_params",
    "d_params", ["g_ema",] "step"}`` (a single model: ``{"params",
    ["ema",] "step"}``), each param subtree in the variant's own tree
    shape, plus the optimizer states ``"g_opt"``/``"d_opt"`` (``"opt"``),
    each ``{"count", "mu", "nu"}`` (Adam) or ``{"nu"}`` (RMSprop), the
    variant's carried scalars ``"vstate"`` (fishergan: ``{"lam"}``; began:
    ``{"k", "m"}``) and
    ``"rng"`` when the file has them, and the spectral projection's
    carried vectors ``"sn_v"`` when the file has them and `cfg` carries
    them (amortized mode). Raises if
    a param leaf is missing, if any leaf has another shape or dtype than
    `cfg` implies, if the optimizer slots are partial or of another
    optimizer, or if a param subtree holds extra leaves (another depth,
    or an EMA the config does not expect)."""
    leaves = read_leaves(path)
    tmpl = param_template(cfg)
    mismatch = (f"variant/config mismatch (variant={cfg.variant!r}, "
                f"ema_decay={cfg.ema_decay})")
    want = _want([lf for k in sorted(tmpl)
                  for lf in tree_leaves_with_path(tmpl[k], f"['{k}']")])
    want["['step']"] = ((), np.dtype("int32"))
    _check_leaves(path, leaves, want, mismatch)
    subtrees = tuple(f"['{k}']" for k in _PARAM_KEYS)
    extra = sorted(p for p in leaves
                   if p.startswith(subtrees) and p not in want)
    if extra:
        raise ValueError(
            f"{path}: leaves {extra[:4]} are not in the config's model — "
            f"variant/config mismatch (ema_decay={cfg.ema_decay})")
    def subtree(like, prefix):
        return tree_unflatten(like, [leaves[p] for p, _ in
                                     tree_leaves_with_path(like, prefix)])

    out: Dict[str, Any] = {k: subtree(v, f"['{k}']") for k, v in tmpl.items()}
    out["step"] = int(leaves["['step']"])
    for side, params in _opt_pairs(tmpl):
        found = sorted(p for p in leaves if p.startswith(f"['{side}']"))
        if not found:
            continue
        want_opt = _want(_opt_leaves(f"['{side}']",
                                     _opt_template(cfg, tmpl[params])))
        if sorted(want_opt) != found:
            raise ValueError(
                f"{path}: the {side} leaves are not those of "
                f"optimizer={cfg.optimizer!r} — {mismatch}")
        _check_leaves(path, leaves, want_opt, mismatch)
        p0 = f"['{side}'][0]"
        opt: Dict[str, Any] = {}
        if f"{p0}.count" in leaves:
            opt["count"] = leaves[f"{p0}.count"]
        for slot in ("mu", "nu"):
            if any(p.startswith(f"{p0}.{slot}") for p in found):
                opt[slot] = subtree(tmpl[params], f"{p0}.{slot}")
        out[side] = opt
    vstate = get_variant(cfg.variant).init_vstate(cfg) \
        if "g_params" in tmpl else {}
    if vstate and any(p.startswith("['vstate']") for p in leaves):
        # the variant's carried scalars (fishergan: lam), all or none
        want_vs = _want(tree_leaves_with_path(vstate, "['vstate']"))
        _check_leaves(path, leaves, want_vs, mismatch)
        out["vstate"] = subtree(vstate, "['vstate']")
    if ("g_params" in tmpl and amortized_sn(cfg)
            and any(p.startswith("['sn_v']") for p in leaves)):
        sn = init_sn_vectors(tmpl["d_params"], 0)  # shapes only
        want_sn = _want(tree_leaves_with_path(sn, "['sn_v']"))
        _check_leaves(path, leaves, want_sn, mismatch)
        out["sn_v"] = subtree(sn, "['sn_v']")
    if "['rng']" in leaves:
        rng = leaves["['rng']"]
        if rng.shape != (2,) or rng.dtype != np.uint32:
            raise ValueError(f"{path}: leaf ['rng'] is {rng.shape} "
                             f"{rng.dtype}; the port reads two uint32 words")
        out["rng"] = rng
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
