"""Tensor (model) parallelism over a ``data x model`` grid — the port of
``generative_models_tpu/parallel/tp.py``.

The sharding rule is the reference's, leaf for leaf (:func:`params_roles`,
:func:`state_roles`): alternating Megatron column/row pairs guarded by
divisibility (Shoeybi 2019), a trunk that ends column-parallel feeding
row-parallel heads (the VAE encoder, infogan's critic), the transformer
prior's qkv and fc1 as columns and proj and fc2 as rows, and every other
leaf replicated (named single layers, embeddings, codebooks, LayerNorms,
conv kernels; the optimizer's count, ``vstate``, ``step``, ``rng``). A
role is "col" (W [in, out] split on out, b on its one axis), "row" (W
split on in, b whole) or None (whole); two kinds of column refine "col"
for the layout: "col_heads" (the prior's qkv when the heads divide by
tp: each rank holds q, k and v of heads r*H/tp .. (r+1)*H/tp, so it
attends over whole heads of its own; a checkpoint keeps the reference's
column order) and "col_gather" (a column whose consumer is not its row
partner: its output is gathered back to the whole width).

torch has no SPMD partitioner, so the collectives are written out, as
Megatron's pair of autograd functions over the model group:

- a column layer takes its whole input through *f* (identity forward,
  all-reduce of the partial input gradients backward) and runs its shard
  ``W[:, cols]``, ``b[cols]`` and the activation on the MLP kernels; its
  output is sharded;
- a row layer runs ``h_shard @ W[rows, :]`` on the kernels with act
  "none" and no bias, then *g* (all-reduce forward, identity backward),
  then the bias and the activation, once.

Each function's backward applies the other (:class:`_Copy`,
:class:`_Reduce`), so a backward taken with ``create_graph=True`` (the
gradient penalty's, ``ops/penalty.py``) is itself differentiable through
the collectives. A state's layers are marked (:class:`TPLayer`) and
``models/mlp.py`` routes a marked layer here, on the kernels or (the
penalty's pass) the plain per-layer ops; every dense product of a rank
stays a kernel's, one launch a layer. ``all_reduces`` and
``all_gathers`` count the model group's collectives.

Every rank of a data slice computes the same replicated values from the
same inputs, so each replicated leaf's gradient is equal on the slice's
model ranks before the data group averages it (``train/step.py::
reduce_mean``), and the Trainer's step is the data-parallel chunk over
the grid's data group (:func:`build_tp_many_steps`).
"""

from __future__ import annotations

from typing import Any, List, Tuple

import torch
import torch.distributed as dist

from generative_models_tpu_torch.ops.activations import apply_act
from generative_models_tpu_torch.ops.linear import fused_linear, linear_plain

MODEL_AXIS = "model"
COLUMNS = ("col", "col_heads", "col_gather")

# the model group's collectives (the tensors each moves)
all_reduces = 0
all_gathers = 0


class TPLayer(dict):
    """A layer ``{"w", "b"}`` holding this rank's shard, with its role
    ("col", "col_heads", "col_gather" or "row") and the model group.
    ``utils/tree.py`` keeps the mark through every map of a tree (the
    optimizer, the EMA, a detach)."""

    def __init__(self, d, role: str, group):
        super().__init__(d)
        self.role = role
        self.group = group

    def remake(self, d) -> "TPLayer":
        return TPLayer(d, self.role, self.group)


def is_marked(layer) -> bool:
    return isinstance(layer, TPLayer)


# ---------------------------------------------------------------------
# The rule (the reference's _layer_spec .. state_pspecs)
# ---------------------------------------------------------------------

def _layer_role(in_ok: bool, out_ok: bool, parallel_in: bool,
                allow_col: bool) -> Tuple[dict, bool]:
    """Roles of one linear layer's {"w", "b"} given the divisibility of its
    dims and whether its input arrives feature-sharded, and whether its
    OUTPUT is feature-sharded."""
    if parallel_in and in_ok:
        return {"w": "row", "b": None}, False
    if allow_col and out_ok:
        return {"w": "col", "b": "col"}, True
    return {"w": None, "b": None}, False


def _list_roles(layers: List[dict], tp: int, parallel_in: bool,
                final_col_ok: bool) -> Tuple[List[dict], bool]:
    """Alternating roles for a list of linear layers; ``final_col_ok``
    lets a trunk end column-parallel (its heads are rows)."""
    roles = []
    for i, layer in enumerate(layers):
        in_d, out_d = layer["w"].shape
        last = i == len(layers) - 1
        role, parallel_in = _layer_role(
            in_d % tp == 0, out_d % tp == 0, parallel_in,
            allow_col=(not last) or final_col_ok)
        roles.append(role)
    return roles, parallel_in


_BLOCK_KEYS = frozenset({"ln1", "qkv", "proj", "ln2", "fc1", "fc2"})
_BLOCK_ROLE = {"qkv": "col", "fc1": "col", "proj": "row", "fc2": "row"}


def _is_layer(x) -> bool:
    return isinstance(x, dict) and "w" in x


def _block_roles(blk: dict, tp: int, heads: int) -> dict:
    """One transformer block: qkv and fc1 columns, proj and fc2 rows,
    the LayerNorms replicated; the whole block replicated unless the
    width divides by tp. qkv is "col_heads" when the heads divide by tp,
    else "col_gather" (attention then runs over every head on each rank
    and proj takes its rows of the whole input)."""
    ok = blk["qkv"]["w"].shape[0] % tp == 0
    out = {}
    for k, v in blk.items():
        role = _BLOCK_ROLE.get(k)
        if role == "col" and ok:
            col = ("col" if k != "qkv" else
                   "col_heads" if heads and heads % tp == 0 else "col_gather")
            out[k] = {"w": col, "b": "col_heads" if col == "col_heads"
                      else "col"}
        elif role == "row" and ok:
            out[k] = {"w": "row", "b": None}
        elif role:
            out[k] = {"w": None, "b": None}
        else:
            out[k] = params_roles(v, tp, heads)
    return out


def params_roles(params: Any, tp: int, heads: int = 0) -> Any:
    """The role tree matching a parameter tree (the reference's
    ``params_pspecs``): bare layer lists, single layers, {"trunk": [...],
    <head>: layer} dicts and any nesting of them, the prior's blocks, and
    raw tensors (replicated). `heads`: the prior's head count
    (``cfg.vq_prior_heads``), which picks qkv's layout."""
    if isinstance(params, torch.Tensor):
        return None
    if isinstance(params, list):
        if params and all(_is_layer(x) for x in params):
            return _list_roles(params, tp, False, final_col_ok=False)[0]
        return [params_roles(v, tp, heads) for v in params]
    if isinstance(params, dict) and "w" in params:
        if params["w"].dim() != 2:
            return {k: None for k in params}  # a conv kernel's layer
        return _layer_role(params["w"].shape[0] % tp == 0,
                           params["w"].shape[1] % tp == 0,
                           False, allow_col=False)[0]
    if isinstance(params, dict) and _BLOCK_KEYS <= params.keys():
        return _block_roles(params, tp, heads)
    if isinstance(params, dict):
        out = {}
        sharded_h = consumed = False
        if "trunk" in params:
            out["trunk"], sharded_h = _list_roles(params["trunk"], tp, False,
                                                  final_col_ok=True)
        for k, v in params.items():
            if k == "trunk":
                continue
            if isinstance(v, list) and v and all(_is_layer(x) for x in v):
                out[k], _ = _list_roles(v, tp, sharded_h, final_col_ok=False)
                consumed |= out[k][0]["w"] == "row"
            elif _is_layer(v) and v["w"].dim() == 2:
                out[k] = _layer_role(v["w"].shape[0] % tp == 0,
                                     v["w"].shape[1] % tp == 0,
                                     sharded_h, allow_col=False)[0]
                consumed |= out[k]["w"] == "row"
            else:
                out[k] = params_roles(v, tp, heads)
        if sharded_h and not consumed:  # no row head takes the trunk's
            out["trunk"][-1]["w"] = "col_gather"  # sharded features
        return {k: out[k] for k in params}
    raise TypeError(f"unrecognized param tree: {type(params)}")


def _replicated(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _replicated(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_replicated(v) for v in tree]
    return None


def param_pairs(spec) -> List[Tuple[str, str]]:
    """(param subtree, the optimizer state that follows it) of a state."""
    if spec.adversarial:
        return [("g_params", "g_opt"), ("d_params", "d_opt")]
    return [("params", "opt")]


def state_roles(spec, cfg, state) -> dict:
    """The role tree of a whole train state (the reference's
    ``state_pspecs``): the params by :func:`params_roles`, each optimizer
    slot (Adam's mu and nu, RMSprop's nu) as its params, the count
    replicated; the EMA as the params it follows; the rest replicated."""
    out = {k: _replicated(v) for k, v in state.items()}
    for pk, ok in param_pairs(spec):
        roles = params_roles(state[pk], cfg.tp, cfg.vq_prior_heads)
        out[pk] = roles
        out[ok] = {slot: roles if slot in ("mu", "nu") else None
                   for slot in state[ok]}
    for ema, pk in (("g_ema", "g_params"), ("ema", "params")):
        if ema in state:
            out[ema] = out[pk]
    return out


def public_role(role):
    """A role as the reference's specs name it: every column "col"."""
    return "col" if role in COLUMNS else role


# ---------------------------------------------------------------------
# Shards of a tree and the whole tree back
# ---------------------------------------------------------------------

def _index(role: str, n: int, tp: int, r: int) -> torch.Tensor:
    """Rank r's indices along the split axis (n whole): contiguous, or
    for "col_heads" q's, k's and v's columns of its heads."""
    if role == "col_heads":
        w = n // 3
        k = w // tp
        return torch.cat([torch.arange(j * w + r * k, j * w + (r + 1) * k)
                          for j in range(3)])
    k = n // tp
    return torch.arange(r * k, (r + 1) * k)


def _dim(role: str, t: torch.Tensor) -> int:
    return 0 if role == "row" else t.dim() - 1


def _take(t, role, group):
    if role is None:
        return t
    d = _dim(role, t)
    idx = _index(role, t.shape[d], group.world, group.rank).to(t.device)
    return t.index_select(d, idx).contiguous()


def _whole(t, role, group):
    """The whole tensor from every rank's shard (one all-gather)."""
    global all_gathers
    if role is None:
        return t
    parts = [torch.empty_like(t) for _ in range(group.world)]
    dist.all_gather(parts, t.contiguous(), group=group.pg)
    all_gathers += 1
    d = _dim(role, t)
    n = t.shape[d] * group.world
    idx = torch.cat([_index(role, n, group.world, r)
                     for r in range(group.world)]).to(t.device)
    shape = list(t.shape)
    shape[d] = n
    return torch.empty(shape, dtype=t.dtype, device=t.device).index_copy_(
        d, idx, torch.cat(parts, d))


def _walk(tree, roles, leaf):
    """`tree` rebuilt as plain dicts and lists, `leaf(t, role)` at each
    leaf; a subtree whose roles are None passes through."""
    if roles is None:
        return tree
    if isinstance(tree, dict):
        return {k: _walk(tree[k], roles[k], leaf) for k in tree}
    if isinstance(tree, (list, tuple)):
        return [_walk(v, r, leaf) for v, r in zip(tree, roles)]
    return leaf(tree, roles)


def mark(tree, roles, group):
    """`tree` with every sharded layer a :class:`TPLayer`."""
    if roles is None:
        return tree
    if isinstance(tree, dict):
        out = {k: mark(tree[k], roles[k], group) for k in tree}
        if "w" in tree and roles.get("w") is not None:
            return TPLayer(out, roles["w"], group)
        return out
    if isinstance(tree, (list, tuple)):
        return [mark(v, r, group) for v, r in zip(tree, roles)]
    return tree


_MARKED = ("g_params", "d_params", "g_ema", "params", "ema")


def shard_state(spec, cfg, state, group) -> Tuple[dict, dict]:
    """(this rank's state, the role tree): each sharded leaf's slice of
    the whole `state` (equal on every rank), its optimizer slots sliced
    alike, the param subtrees marked for the apply paths."""
    roles = state_roles(spec, cfg, state)
    local = {k: _walk(v, roles[k], lambda t, r: _take(t, r, group))
             for k, v in state.items()}
    for k in _MARKED:
        if k in local:
            local[k] = mark(local[k], roles[k], group)
    return local, roles


def gather_tree(tree, roles, group):
    """The whole tree (plain dicts and lists) from every rank's shards:
    a collective, called by every rank of the model group."""
    return _walk(tree, roles, lambda t, r: _whole(t, r, group))


# ---------------------------------------------------------------------
# Megatron's f and g, and a gather for a column without its row partner
# ---------------------------------------------------------------------

def _reduce(t, group):
    global all_reduces
    t = t.contiguous().clone()
    group.all_reduce_sum_(t)
    all_reduces += 1
    return t


class _Copy(torch.autograd.Function):
    """f: identity forward; backward the all-reduce of the ranks' partial
    gradients (as :class:`_Reduce`, so differentiable again)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        return _Reduce.apply(g, ctx.group), None


class _Reduce(torch.autograd.Function):
    """g: the all-reduce (sum) forward; identity backward (as
    :class:`_Copy`)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _Copy.apply(g, ctx.group), None


class _Gather(torch.autograd.Function):
    """The ranks' column shards side by side, whole on every rank;
    backward this rank's columns (as :class:`_Split`)."""

    @staticmethod
    def forward(ctx, x, group):
        global all_gathers
        ctx.group = group
        parts = [torch.empty_like(x) for _ in range(group.world)]
        dist.all_gather(parts, x.contiguous(), group=group.pg)
        all_gathers += 1
        return torch.cat(parts, -1)

    @staticmethod
    def backward(ctx, g):
        return _Split.apply(g, ctx.group), None


class _Split(torch.autograd.Function):
    """This rank's columns of a whole tensor; backward the gather."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        k = x.shape[-1] // group.world
        return x.narrow(-1, group.rank * k, k).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _Gather.apply(g, ctx.group), None


def layer_apply(layer: TPLayer, x, act: str = "none", slope: float = 0.2,
                compute_dtype=None, plain: bool = False):
    """One marked layer's Megatron form: ``fused_linear`` on the kernels,
    or with `plain` the per-layer ``linear_plain`` (twice
    differentiable). A row layer given the whole input (after a
    "col_gather" column) takes its rows of it."""
    lin = linear_plain if plain else fused_linear
    g = layer.group
    if layer.role in COLUMNS:
        y = lin(_Copy.apply(x, g), layer["w"], layer["b"], act=act,
                slope=slope, compute_dtype=compute_dtype)
        return _Gather.apply(y, g) if layer.role == "col_gather" else y
    k = layer["w"].shape[0]
    if x.shape[-1] != k:
        x = _Copy.apply(x, g).narrow(-1, g.rank * k, k).contiguous()
    y = lin(x, layer["w"], torch.zeros_like(layer["b"]), act="none",
            compute_dtype=compute_dtype)
    return apply_act(_Reduce.apply(y, g) + layer["b"], act, slope)


def stack_apply(layers, x, acts, slope: float = 0.2, compute_dtype=None,
                plain: bool = False):
    """A stack holding marked layers, one layer (one launch of each MLP
    kernel on the card) at a time; an unmarked layer of it runs whole."""
    lin = linear_plain if plain else fused_linear
    for layer, act in zip(layers, acts):
        if is_marked(layer):
            x = layer_apply(layer, x, act, slope, compute_dtype, plain)
        else:
            x = lin(x, layer["w"], layer["b"], act=act, slope=slope,
                    compute_dtype=compute_dtype)
    return x


# ---------------------------------------------------------------------
# What runs under tp, and the step
# ---------------------------------------------------------------------

def unsupported(spec, cfg):
    """Why `cfg` cannot train under tp > 1 (None when it can)."""
    if cfg.arch != "mlp":
        return "tp>1 shards the MLP stacks; the conv stacks have no rule"
    if cfg.fused_step is True:
        return ("fused_step=True with tensor parallelism is unsupported: the "
                "chunk and phase kernels assume whole parameters")
    return None


def _gather_weights(tree):
    """`tree` with each marked layer's weight gathered whole (one
    all-gather a weight); every other leaf as it is."""
    if is_marked(tree):
        return dict(tree, w=_whole(tree["w"], tree.role, tree.group))
    if isinstance(tree, dict):
        return {k: _gather_weights(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_gather_weights(v) for v in tree]
    return tree


def _slice_weights(like, tree):
    """`tree` (shaped as :func:`_gather_weights` left `like`) with each of
    `like`'s marked layers' whole weight cut back to this rank's slice and
    the mark restored."""
    if is_marked(like):
        return like.remake(dict(tree, w=_take(tree["w"], like.role,
                                              like.group)))
    if isinstance(like, dict):
        return {k: _slice_weights(like[k], tree[k]) for k in like}
    if isinstance(like, (list, tuple)):
        return [_slice_weights(a, b) for a, b in zip(like, tree)]
    return tree


def on_whole_weights(fn):
    """``fn(params, *rest)``, which returns new params or a tuple whose
    first item they are, run on the whole weight matrices of a tp
    critic: each sharded weight gathered over the model group, `fn` on
    the whole tree on every model rank (identical inputs, so identical
    results), then each rank keeps its slice. The spectral projection
    (``ops/spectral.py``) reads only the weights ("w"), so it computes
    the single device's function; what `fn` returns beside the params
    (the carried ``sn_v``) stays whole, replicated as ``state_roles``
    has it."""
    def run(params, *rest):
        out = fn(_gather_weights(params), *rest)
        if isinstance(out, tuple):
            return (_slice_weights(params, out[0]),) + tuple(out[1:])
        return _slice_weights(params, out)
    return run


def build_tp_many_steps(spec, cfg, steps_per_epoch: int, grid):
    """The chunk of a tp state: the data-parallel chunk over the grid's
    data group (``parallel/dp.py``), whose step differentiates the marked
    layers through the collectives of this module."""
    from generative_models_tpu_torch.parallel import dp
    return dp.build_shard_map_many_steps(spec, cfg, steps_per_epoch,
                                         grid.data)
