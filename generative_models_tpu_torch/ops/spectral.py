"""Spectral weight projection of the critic — the port of
``generative_models_tpu/ops/spectral.py`` (``Config.spectral_projection``).

After each critic update every weight matrix W (dict key ``"w"``, ndim
>= 2, read as ``[-1, shape[-1]]``) is scaled by ``1 / max(1, sigma(W) /
target)``: projected onto the ball of spectral norm ``sn_target``. sigma
comes from power iteration with the reference's deterministic start
``v = 1/sqrt(n)`` (``n = shape[-1]``), its iteration order (``u = m v``,
normalised; ``v = m^T u``, normalised) and its ``_EPS`` inside each
norm. Two estimators (``Config.sn_mode``):

- ``"fresh"``: :func:`project_spectral`, ``sn_iters`` iterations from
  the start every step, a pure function of the weights;
- ``"amortized"`` (the default): one right-singular vector v a weight,
  carried in the train state as ``state["sn_v"]`` (a tree shaped as the
  critic's parameters; every leaf that is not a weight holds an empty
  placeholder, so a checkpoint's leaves line up with the reference's),
  burned in for ``sn_iters`` iterations at the init weights
  (:func:`init_sn_vectors`) and refined by ONE matvec pair a critic
  update (:func:`project_spectral_amortized`).

The reference has no Pallas kernel here: these are plain tensor ops (a
few matvecs a weight), which run on whatever device holds the weights.
Trees are the port's lists and dicts of tensors, walked in the order of
``utils/tree.py`` (dict keys sorted, as ``jax.tree_util`` walks them),
so infogan's ``{"trunk", "d_head", "q_head"}`` critic is handled leaf for
leaf as the reference handles it.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch

_EPS = 1e-12


def amortized_sn(cfg) -> bool:
    """Whether `cfg` projects with carried vectors (``state["sn_v"]``):
    the spectral projection in its default ``sn_mode``."""
    return bool(cfg.spectral_projection) and cfg.sn_mode == "amortized"


def _start(n: int, like: torch.Tensor) -> torch.Tensor:
    """The deterministic start 1/sqrt(n), taken in float32 as the
    reference's ``1.0 / jnp.sqrt(jnp.float32(n))``."""
    r = 1.0 / torch.sqrt(torch.tensor(float(n), dtype=torch.float32))
    return torch.full((n,), float(r), dtype=like.dtype, device=like.device)


def _matrix(w: torch.Tensor) -> torch.Tensor:
    return w.reshape(-1, w.shape[-1])


def _power(m: torch.Tensor, v: torch.Tensor, iters: int) -> torch.Tensor:
    for _ in range(iters):
        u = m @ v
        u = u / (torch.linalg.vector_norm(u) + _EPS)
        v = m.T @ u
        v = v / (torch.linalg.vector_norm(v) + _EPS)
    return v


@torch.no_grad()
def spectral_sigma(w: torch.Tensor, iters: int = 10) -> torch.Tensor:
    """Top singular value of ``w`` read as ``[-1, shape[-1]]`` by `iters`
    power iterations from the deterministic start (a 0-dim tensor)."""
    m = _matrix(w)
    v = _power(m, _start(m.shape[1], m), iters)
    return torch.linalg.vector_norm(m @ v)


def _is_weight(key, leaf) -> bool:
    return key == "w" and isinstance(leaf, torch.Tensor) and leaf.ndim >= 2


def _visit(fn, tree: Any, *rest: Any, key=None):
    """`fn(key, leaf, *rest_leaves)` leafwise, `key` the dict key the leaf
    sits under (None in a list), the trees' structure kept."""
    if isinstance(tree, dict):
        return {k: _visit(fn, tree[k], *[r[k] for r in rest], key=k)
                for k in tree}
    if isinstance(tree, (list, tuple)):
        return [_visit(fn, v, *[r[i] for r in rest])
                for i, v in enumerate(tree)]
    return fn(key, tree, *rest)


def _scale(w: torch.Tensor, sigma: torch.Tensor, target: float):
    return w * (1.0 / torch.clamp(sigma / target, min=1.0))


@torch.no_grad()
def project_spectral(params: Any, target: float = 1.0,
                     iters: int = 10) -> Any:
    """``sn_mode="fresh"``: every weight leaf of a critic tree projected
    onto the ball sigma <= `target` (`iters` fresh-start iterations);
    biases pass through unchanged."""
    def visit(key, leaf):
        if not _is_weight(key, leaf):
            return leaf
        return _scale(leaf, spectral_sigma(leaf, iters), target)

    return _visit(visit, params)


@torch.no_grad()
def init_sn_vectors(params: Any, iters: int = 10) -> Any:
    """The carried vectors of :func:`project_spectral_amortized`: for
    each weight leaf v [shape[-1]] burned in with `iters` iterations from
    the deterministic start at the weight's current value; every other
    leaf an empty float32 placeholder [0]."""
    def visit(key, leaf):
        if not _is_weight(key, leaf):
            return torch.zeros((0,), dtype=torch.float32,
                               device=leaf.device)
        m = _matrix(leaf)
        return _power(m, _start(m.shape[1], m), iters)

    return _visit(visit, params)


@torch.no_grad()
def project_spectral_amortized(params: Any, vs: Any,
                               target: float = 1.0) -> Tuple[Any, Any]:
    """One amortized step: for each weight leaf, u = norm(m v), v_raw =
    m^T u, sigma = |v_raw| (the estimate), the weight scaled onto the
    ball sigma <= `target` and v' = v_raw / sigma. Returns (params',
    vs'); the other leaves pass through."""
    pairs = _visit(
        lambda key, leaf, v: _amortized_leaf(leaf, v, target)
        if _is_weight(key, leaf) else (leaf, v), params, vs)
    return _split(pairs, 0), _split(pairs, 1)


def _amortized_leaf(w, v, target):
    m = _matrix(w)
    u = m @ v
    u = u / (torch.linalg.vector_norm(u) + _EPS)
    v_raw = m.T @ u
    sigma = torch.linalg.vector_norm(v_raw)
    return _scale(w, sigma, target), v_raw / (sigma + _EPS)


def _split(tree, i):
    if isinstance(tree, dict):
        return {k: _split(v, i) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_split(v, i) for v in tree]
    return tree[i]  # a (param, v) pair
