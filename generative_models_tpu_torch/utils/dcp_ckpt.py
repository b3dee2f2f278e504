"""The directory checkpoint backend (``Config.ckpt_backend="orbax"``) —
the port's counterpart of ``generative_models_tpu/utils/orbax_ckpt.py``.

The reference writes the whole train state as an orbax directory; the
port writes it with ``torch.distributed.checkpoint`` (DCP), torch's own
directory checkpoint (a ``.metadata`` file and the data files beside it).
Both round-trip the full state: params, both optimizer states, the
variant's carried scalars, the spectral projection's ``sn_v``, ``step``
and the ``rng`` words. The layout is DCP's, not orbax's: a directory of
one package does not load into the other (the npz layout,
``utils/checkpoint.py``, is the format both read).

Every leaf is stored under its JAX key path (``utils/checkpoint.py::
state_leaves``), as a tensor on the CPU: ``step`` as a 0-dim int64,
``rng`` as int64 words (the uint32 values; converted back explicitly on
load). A load reads the metadata first and raises on a missing or extra
leaf or any shape or dtype other than the template's, since DCP itself
casts what it loads into the template's dtype. Save and load run with
``no_dist=True``: under a process group one rank writes the whole state,
and DCP would otherwise enter collectives on every rank.
"""

from __future__ import annotations

import os
import warnings
from typing import Any, Dict

import numpy as np
import torch

_INT_KEYS = ("['rng']", "['step']")


def _flat(state: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    from generative_models_tpu_torch.utils.checkpoint import state_leaves
    out = {}
    for p, v in state_leaves(state):
        if p in _INT_KEYS:
            out[p] = torch.as_tensor(np.asarray(v, dtype=np.int64))
        else:
            out[p] = torch.as_tensor(v).detach().cpu().clone()
    return out


def save_state(path: str, state: Dict[str, Any], write: bool = True) -> str:
    """Write `state` as a DCP directory at `path` (replacing one there);
    a rank other than the writer passes ``write=False``."""
    import torch.distributed.checkpoint as dcp
    path = os.path.abspath(path)
    if not write:
        return path
    os.makedirs(path, exist_ok=True)
    with warnings.catch_warnings():  # no process group; a replaced one
        warnings.filterwarnings(
            "ignore", message=".*(single process|existing checkpoint).*")
        dcp.save(_flat(state), no_dist=True,
                 storage_writer=dcp.FileSystemWriter(path, overwrite=True))
    return path


def restore_state(path: str, template: Dict[str, Any]) -> Dict[str, Any]:
    """The state at `path` in `template`'s structure: every leaf a numpy
    array (``rng`` uint32, ``step`` an int). Raises on any leaf missing,
    extra, or of another shape or dtype than `template`'s."""
    import torch.distributed.checkpoint as dcp

    from generative_models_tpu_torch.utils.checkpoint import (
        state_from_leaves,
    )
    path = os.path.abspath(path)
    want = {p: torch.empty(t.shape, dtype=t.dtype)
            for p, t in _flat(template).items()}
    meta = dcp.FileSystemReader(path).read_metadata().state_dict_metadata
    if sorted(meta) != sorted(want):
        raise ValueError(
            f"{path}: leaves {sorted(set(meta) ^ set(want))[:4]} are in one "
            "of the checkpoint and the template only — variant/config "
            "mismatch")
    for p, t in want.items():
        m = meta[p]
        if tuple(m.size) != tuple(t.shape) or m.properties.dtype != t.dtype:
            raise ValueError(
                f"{path}: leaf {p!r} is {tuple(m.size)} {m.properties.dtype}, "
                f"the template's {tuple(t.shape)} {t.dtype} — refusing to "
                "silently reshape/recast")
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*single process.*")
        dcp.load(want, no_dist=True,
                 storage_reader=dcp.FileSystemReader(path))
    leaves = {p: t.numpy() for p, t in want.items()}
    leaves["['rng']"] = leaves["['rng']"].astype(np.uint32)
    leaves["['step']"] = int(leaves["['step']"])
    return state_from_leaves(template, leaves)
