"""The data group and the rank grid — the port's stand-ins for the
reference's meshes (``generative_models_tpu/parallel/mesh.py``).

- A data group (:class:`DataGroup`): `world` ranks, one process each,
  every rank holding the whole model and ``batch_size / world`` rows of
  each batch, joined by a ``torch.distributed`` process group.
- A grid (:class:`Grid`, :func:`make_grid`; the reference's
  ``make_mesh_2axis``): ``dp x n`` ranks on two axes, ``"data"`` and a
  second one (``"model"`` for tensor parallelism, ``parallel/tp.py``;
  ``"pipe"`` for pipeline parallelism, ``parallel/pp.py``). Rank r sits at
  (data r // n, second r % n), as the reference's row-major reshape of
  its devices places them; each column of the grid is a data group and
  each row a group of the second axis.

Backend rule (the one place it is decided, :func:`pick_backend`):

- ``nccl`` when every rank has a card of its own;
- ``gloo`` when the ranks are on the CPU;
- ``gloo`` when the caller places several ranks on one card (NCCL refuses
  two ranks on one device); gloo then reduces the CUDA tensors itself,
  through host memory.

Nothing here moves a rank to the CPU on its own: a rank asked for a card
that is not there raises.

The reference's ``lax.pmean`` inside a loss differentiates as a mean of
the cotangents over the mesh (its transpose); :func:`all_reduce_mean` has
that backward, so a batch-coupled loss (``losses/common.py``) trains the
global-batch objective, as a single device would.
"""

from __future__ import annotations

import dataclasses
import faulthandler
import os
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional

import torch
import torch.distributed as dist

# every all-reduce a group makes (the tensors it averages), for the
# launch counts of the data-parallel paths
all_reduces = 0


@dataclasses.dataclass
class DataGroup:
    """One rank's view of the data group."""

    world: int
    rank: int
    device: torch.device
    backend: str
    pg: Any  # the torch.distributed process group

    def all_reduce_mean_(self, t: torch.Tensor) -> torch.Tensor:
        """Averages `t` over the ranks, in place: one collective of the
        group's backend, at world 1 too, so a group of one rank runs the
        path a larger one runs."""
        global all_reduces
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.pg)
        all_reduces += 1
        if self.world > 1:
            t.div_(self.world)
        return t

    def all_reduce_sum_(self, t: torch.Tensor) -> torch.Tensor:
        """Sums `t` over the ranks, in place (uncounted: the callers
        count their own)."""
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.pg)
        return t

    def barrier(self) -> None:
        if self.world > 1:
            dist.barrier(group=self.pg)


@dataclasses.dataclass
class Grid:
    """One rank's place in a ``dp x n`` grid: its global `rank`, the
    `data` group of its column (world dp, rank r // n) and the `second`
    group of its row (world n, rank r % n) on the axis `axis`, and `pg`,
    the group of the whole grid."""

    dp: int
    n: int
    axis: str
    rank: int
    data: DataGroup
    second: DataGroup
    pg: Any

    @property
    def device(self) -> torch.device:
        return self.data.device

    @property
    def world(self) -> int:
        return self.dp * self.n

    def second_rank_of(self, i: int) -> int:
        """The global rank of rank `i` of this rank's row."""
        return (self.rank // self.n) * self.n + i

    def barrier(self) -> None:
        if self.world > 1:
            dist.barrier(group=self.pg)


def grid_ranks(dp: int, n: int) -> List[List[int]]:
    """The grid's global ranks, one row of n a data index."""
    return [[d * n + c for c in range(n)] for d in range(dp)]


def make_grid(dp: int, n: int, axis: str, world: DataGroup) -> Optional[Grid]:
    """The ``dp x n`` grid on ranks 0 .. dp*n-1 of `world` (a group of
    every rank of the process group, at least dp*n of them). Every rank
    of `world` must call it with the same arguments, in the same order
    as its other calls: ``dist.new_group`` is collective over the whole
    process group, and a rank that skips one hangs the others
    (:func:`run_ranks` turns that into a failure). Returns None on the
    ranks outside the grid."""
    if dp < 1 or n < 1 or dp * n > world.world:
        raise ValueError(f"a {dp} x {n} grid ({axis}) needs dp*{axis} = "
                         f"{dp * n} ranks but the group has {world.world}")
    rows = grid_ranks(dp, n)
    cols = [[row[c] for row in rows] for c in range(n)]
    groups = {}
    for members in cols + rows:
        pg = (world.pg if len(members) == world.world
              else dist.new_group(members, backend=world.backend))
        groups[tuple(members)] = pg
    all_ranks = list(range(dp * n))
    grid_pg = (world.pg if dp * n == world.world
               else dist.new_group(all_ranks, backend=world.backend))
    r = world.rank
    if r >= dp * n:
        return None
    d, c = divmod(r, n)

    def group(members, index):
        return DataGroup(world=len(members), rank=index, device=world.device,
                         backend=world.backend, pg=groups[tuple(members)])
    return Grid(dp=dp, n=n, axis=axis, rank=r, data=group(cols[c], d),
                second=group(rows[d], c), pg=grid_pg)


class _AllReduceMean(torch.autograd.Function):
    """The mean over the ranks, whose backward is the mean of the ranks'
    cotangents (the transpose of ``lax.pmean``)."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return group.all_reduce_mean_(t.detach().clone())

    @staticmethod
    def backward(ctx, g):
        return ctx.group.all_reduce_mean_(g.contiguous().clone()), None


def all_reduce_mean(t: torch.Tensor, group: Optional[DataGroup]):
    """`t` averaged over the group's ranks, differentiably; `t` itself
    without a group."""
    if group is None:
        return t
    if not isinstance(group, DataGroup):
        raise TypeError(f"a global statistic takes a parallel/mesh.py "
                        f"DataGroup, not {group!r} (the reference's mesh "
                        f"axis name has no counterpart in torch)")
    return _AllReduceMean.apply(t, group)


def pick_backend(world: int, device, ranks_share_card: bool = False) -> str:
    """The backend rule of this module's docstring."""
    if torch.device(device).type != "cuda":
        return "gloo"
    return "gloo" if ranks_share_card and world > 1 else "nccl"


def rank_device(device, rank: int, ranks_share_card: bool,
                card: Optional[int] = None) -> torch.device:
    """The device rank `rank` runs on: the CPU, card `card` (by default
    card `rank`), or (ranks sharing a card) the card `device` names.
    Raises when that card is not present."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    index = ((dev.index or 0) if ranks_share_card
             else rank if card is None else card)
    if not torch.cuda.is_available() or index >= torch.cuda.device_count():
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        raise RuntimeError(f"rank {rank} needs cuda:{index} but {have} CUDA "
                           f"device(s) are present")
    return torch.device("cuda", index)


def init_data_group(world: Optional[int] = None, rank: Optional[int] = None,
                    device="cuda", store_path: Optional[str] = None,
                    ranks_share_card: bool = False,
                    card: Optional[int] = None) -> DataGroup:
    """Joins (or, at world 1, forms) the data group. Without `world` and
    `rank` they come from ``WORLD_SIZE`` and ``RANK``, and the rendezvous
    from ``MASTER_ADDR``/``MASTER_PORT`` (``env://``); with `store_path`
    from a ``FileStore`` at that path. `card`: the card of this rank when
    it is not card `rank` (``LOCAL_RANK``'s, ``parallel/multihost.py``)."""
    if world is None:
        world = int(os.environ["WORLD_SIZE"])
    if rank is None:
        rank = int(os.environ["RANK"])
    dev = rank_device(device, rank, ranks_share_card, card)
    backend = pick_backend(world, dev, ranks_share_card)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        if store_path is not None:
            store = dist.FileStore(store_path, world)
            dist.init_process_group(backend, store=store, world_size=world,
                                    rank=rank)
        else:
            dist.init_process_group(backend, init_method="env://",
                                    world_size=world, rank=rank)
    return DataGroup(world=world, rank=rank, device=dev, backend=backend,
                     pg=dist.group.WORLD)


def close_data_group() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def _rank_main(rank, world, device, store_path, ranks_share_card, threads,
               grid, timeout, fn, args, results):
    try:
        if threads:
            torch.set_num_threads(threads)
        # a rank still running at the timeout prints where it is (a hung
        # collective, a group one rank skipped) before run_ranks stops it
        faulthandler.dump_traceback_later(timeout, exit=False)
        group = init_data_group(world, rank, device, store_path=store_path,
                                ranks_share_card=ranks_share_card)
        try:
            if grid is not None:
                group = make_grid(*grid, group)
            out = fn(group, *args)
            group.barrier()
        finally:
            faulthandler.cancel_dump_traceback_later()
            close_data_group()
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))


def run_ranks(fn: Callable, world: int, device="cuda", args=(),
              ranks_share_card: bool = False, threads: int = 0,
              timeout: float = 600.0, grid=None) -> List[Any]:
    """Starts `world` ranks (``torch.multiprocessing``, start method
    ``spawn``), each running ``fn(group, *args)`` in a group of its own
    process, and returns their results by rank; with `grid` = (dp, n,
    axis), dp*n = world, each runs ``fn(make_grid(dp, n, axis, group),
    *args)`` instead. `fn` and its results must pickle: a function of this
    package, not of a test module, so no rank imports a test. On the CPU,
    `threads` > 0 caps each rank's torch threads. Raises with the rank's
    traceback when one fails, and when a rank gives no result within
    `timeout` seconds (a rank still running then has printed its stack
    to standard error); every rank is stopped before it returns."""
    import queue

    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="gm_ranks_")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, args=(
        r, world, device, os.path.join(tmp, "store"), ranks_share_card,
        threads, grid, timeout, fn, args, results), daemon=True)
        for r in range(world)]
    try:
        for p in procs:
            p.start()
        got, errors = {}, []
        deadline = time.monotonic() + timeout
        while len(got) + len(errors) < world:
            try:
                rank, ok, out = results.get(timeout=1.0)
            except queue.Empty:
                # a rank that died (a signal, os._exit) puts no result
                dead = [r for r, p in enumerate(procs) if r not in got
                        and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(
                        f"rank {dead[0]} exited with code "
                        f"{procs[dead[0]].exitcode} and no result")
                if time.monotonic() > deadline:
                    raise RuntimeError(
                        f"a rank gave no result in {timeout} s (ranks "
                        f"{sorted(got)} returned; the others' stacks are on "
                        "standard error)")
                continue
            if ok:
                got[rank] = out
            else:
                errors.append(f"rank {rank}:\n{out}")
                break
        if errors:
            raise RuntimeError("a rank failed: " + "\n".join(errors))
        return [got[r] for r in range(world)]
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.terminate()
                p.join()
        shutil.rmtree(tmp, ignore_errors=True)
