"""Multi-process initialisation — the ``--multihost`` CLI path, the port
of ``generative_models_tpu/parallel/multihost.py``.

The reference joins ``jax.distributed`` from ``JAX_COORDINATOR_ADDRESS``,
``JAX_NUM_PROCESSES`` and ``JAX_PROCESS_ID`` (or a TPU pod's own
environment) and builds its meshes from the global device list. Those
variables mean nothing to torch. Here each process is one rank, started
by the caller (``torchrun`` or any launcher that sets the variables):

- ``RANK`` and ``WORLD_SIZE``: this process's rank and the number of
  ranks;
- ``MASTER_ADDR`` and ``MASTER_PORT``: the rendezvous (``env://``);
- ``LOCAL_RANK``: the card of this process on its host (default 0 at
  world 1, else ``RANK``); a card that is not present raises.

The ranks form a ``dp x tp`` grid (``parallel/mesh.py::make_grid``) over
NCCL, one card a rank, or over gloo with ``device="cpu"``.
"""

from __future__ import annotations

import os
from typing import List

from generative_models_tpu_torch.parallel import mesh


def multihost_ranks() -> List[int]:
    """The global rank list grids are built from (the reference's
    ``multihost_devices``): one rank a process."""
    return list(range(int(os.environ["WORLD_SIZE"])))


def init_multihost(dp: int = 1, tp: int = 1, device="cuda") -> mesh.Grid:
    """Joins the group from the environment (module docstring) and returns
    this rank's place in the ``dp x tp`` grid on the "model" axis. Raises
    ValueError when dp * tp is not ``WORLD_SIZE``, and RuntimeError when
    the card ``LOCAL_RANK`` names is missing."""
    world = int(os.environ["WORLD_SIZE"])
    rank = int(os.environ["RANK"])
    if dp * tp != world:
        raise ValueError(f"--multihost: the grid --dp {dp} x --tp {tp} has "
                         f"{dp * tp} ranks but WORLD_SIZE is {world}")
    card = int(os.environ.get("LOCAL_RANK", rank))
    group = mesh.init_data_group(world, rank, device, card=card)
    return mesh.make_grid(dp, tp, "model", group)


def is_multiprocess(group) -> bool:
    """True when `group` (a data group or a grid) spans more than one
    process: the reference's test for feeding global arrays."""
    return group is not None and group.world > 1
