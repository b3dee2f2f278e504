"""Nested parameter trees: dicts and lists of tensors.

The adversarial variants keep a list of ``{"w", "b"}`` layers; the VAE
family nests them (``{"encoder": {"trunk": [layer], "mu": layer, ...},
"decoder": [layer, layer]}``). These helpers walk any such tree in the
order ``jax.tree_util.tree_flatten`` uses (dict keys sorted, lists in
order), so the optimizer, the EMA, the step and the checkpoint treat
every variant alike and a checkpoint's leaves line up with the JAX
package's.
"""

from __future__ import annotations

from typing import Any, Callable, List, Tuple


def _like(t: dict, d: dict) -> dict:
    """`d` as a dict of `t`'s kind: a layer marked for tensor parallelism
    (``parallel/tp.py::TPLayer``) keeps its mark."""
    remake = getattr(t, "remake", None)
    return remake(d) if remake is not None else d


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """`fn` applied leafwise over trees of one structure."""
    if isinstance(tree, dict):
        return _like(tree, {k: tree_map(fn, tree[k], *[r[k] for r in rest])
                            for k in tree})
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *[r[i] for r in rest])
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_leaves_with_path(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """(key path, leaf) pairs; the path as ``jax.tree_util.keystr`` prints
    it (``['encoder']['trunk'][0]['w']``)."""
    if isinstance(tree, dict):
        return [lf for k in sorted(tree)
                for lf in tree_leaves_with_path(tree[k], f"{prefix}['{k}']")]
    if isinstance(tree, (list, tuple)):
        return [lf for i, v in enumerate(tree)
                for lf in tree_leaves_with_path(v, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def tree_leaves(tree: Any) -> list:
    return [v for _, v in tree_leaves_with_path(tree)]


def tree_device(tree: Any):
    """The device of a tree's first leaf (every leaf of a parameter tree
    lies on one device): a list of layers or a conv stack's dict alike."""
    return tree_leaves(tree)[0].device


def tree_unflatten(like: Any, leaves) -> Any:
    """A tree of `like`'s structure holding `leaves` (in
    :func:`tree_leaves` order)."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return _like(t, {k: built[k] for k in t})
        if isinstance(t, (list, tuple)):
            return [build(v) for v in t]
        return next(it)

    return build(like)
