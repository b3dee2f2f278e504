"""The chunk kernels' product plan (ops/chunk_plan.py, the rule and the
index arithmetic of csrc/chunk_common.cuh) at the flagship widths, the CPU
tests' small widths and ragged ones: every output element of every job of
every phase has one owner, every stage of a tile one depth group (taken in
order, summed in group order), and the shared memory fits two blocks an
SM. The card runs the same rule (chip_smoke.py holds the two equal)."""

import os
import re

import numpy as np
import pytest

from generative_models_tpu_torch.ops import build, chunk_plan as cp
from generative_models_tpu_torch.ops.cuda_dp import DP_HOOKS
from generative_models_tpu_torch.ops.cuda_train import HOOK_IDS

# (name, widths): B, G's input, G's hidden, G's output, D's hidden, and
# the label lanes; infogan's head 1 + cat + 2 cont, began's X
WIDTHS = {
    "flagship": dict(b=100, z=128, h=400, x=784, hd=400, n_cls=10, cat=10,
                     cont=2),
    "cpu": dict(b=8, z=8, h=16, x=24, hd=12, n_cls=3, cat=3, cont=1),
    "ragged": dict(b=37, z=70, h=203, x=389, hd=211, n_cls=10, cat=10,
                   cont=2),
}
VAE_WIDTHS = {"flagship": dict(b=100, x=784, h=400, l=20),
              "cpu": dict(b=16, x=784, h=32, l=8),
              "ragged": dict(b=37, x=389, h=203, l=13)}
# one block on each of an H100's 132 SMs; a grid too small to spare
# blocks for the row and column work
GRIDS = (132, 3)


def hook_phases(hook, w, mode="chunk"):
    z = w["z"] + (w["n_cls"] if hook == "cond" else 0) + (
        w["cat"] + w["cont"] if hook == "info" else 0)
    l = {"info": 1 + w["cat"] + 2 * w["cont"], "be": w["x"]}.get(hook, 1)
    ds = 5 if hook in ("w", "gpw") else 1
    return cp.gan_phase_jobs(hook, b=w["b"], z=z, h=w["h"], x=w["x"],
                             hd=w["hd"], l=l,
                             n_cls=w["n_cls"] if hook == "cond" else 0, ds=ds,
                             mode=mode)


def check_phases(phases, grid):
    for name, jobs, first in phases:
        assert 1 <= len(jobs) <= cp.MAXJ, name
        nb = grid - (first if first < grid else 0)
        plan, total = cp.phase_plan(jobs, nb)
        owner = cp.tile_blocks(total, nb)
        assert sorted(set(owner)) == sorted(set(owner) & set(range(nb)))
        assert len(owner) == total
        for (c, tiles_n, start), (m, n, k) in zip(plan, jobs):
            tm, tn, ks, _ = cp.CLASSES[c]
            tiles = -(-m // tm) * tiles_n
            count = np.zeros((m, n), np.int32)
            for tile in range(tiles):
                m0, n0 = (tile // tiles_n) * tm, (tile % tiles_n) * tn
                assert m0 < m and n0 < n, (name, tile)
                count[m0:m0 + tm, n0:n0 + tn] += 1
            assert (count == 1).all(), (name, m, n, k, c)
            # the depth: each stage to one group, in order; the groups'
            # partials summed in group order 0..KS-1
            stages = [cp.group_stages(k, ks, g) for g in range(ks)]
            flat = sorted(s for g in stages for s in g)
            assert flat == list(range(-(-k // cp.SK))), (name, k)
            assert all(g == sorted(g) for g in stages)
        assert total == plan[-1][2] + -(-jobs[-1][0] // cp.CLASSES[
            plan[-1][0]][0]) * plan[-1][1]


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("widths", sorted(WIDTHS))
@pytest.mark.parametrize("hook", sorted(HOOK_IDS))
def test_gan_chunk_plan_covers_every_output_once(hook, widths, grid):
    w = WIDTHS[widths]
    check_phases(hook_phases(hook, w), grid)
    if hook in DP_HOOKS:  # the phase kernels: one critic or G update
        for mode in ("d", "g"):
            check_phases(hook_phases(hook, w, mode), grid)


# the data-parallel phase kernels at a rank's rows: the flagship's b 100
# (world 1) and 50 (world 2), a ragged b, and the CPU tests' widths
DP_WIDTHS = {"b100": WIDTHS["flagship"],
             "b50": dict(WIDTHS["flagship"], b=50),
             "ragged": dict(WIDTHS["ragged"], b=61),
             "cpu": WIDTHS["cpu"]}


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("widths", sorted(DP_WIDTHS))
@pytest.mark.parametrize("mode", ("d", "g"))
@pytest.mark.parametrize("hook", DP_HOOKS)
def test_phase_kernels_write_every_output_float_once(hook, mode, widths,
                                                     grid):
    """Every float of a phase kernel's flat buffer (its four gradients,
    the 8 metrics lanes) has exactly one writer on a grid the plan
    accepts (dp_min_grid blocks or more), so the wrapper's buffer needs
    no memset: a product job's tiles own its elements once (the engine's
    plan on the blocks the phase leaves it), a column sum's block owns
    its columns, the metrics warp's block every lane. On a smaller grid
    some float has no writer, which is why the plan refuses it."""
    w = DP_WIDTHS[widths]
    phases = {name: (jobs, first)
              for name, jobs, first in hook_phases(hook, w, mode)}
    z = w["z"] + (w["n_cls"] if hook == "cond" else 0) + (
        w["cat"] + w["cont"] if hook == "info" else 0)
    l = {"info": 1 + w["cat"] + 2 * w["cont"], "be": w["x"]}.get(hook, 1)
    parts = cp.dp_flat_writers(hook, mode, b=w["b"], z=z, h=w["h"],
                               x=w["x"], hd=w["hd"], l=l,
                               n_cls=w["n_cls"] if hook == "cond" else 0)
    cols_of = {}  # (phase, cols) -> the columns its blocks finish
    once = []
    for name, shape, writer in parts:
        count = np.zeros(shape, np.int32).reshape(-1)
        if writer[0] == "tile":
            jobs, first = phases[writer[1]]
            m, n, _ = jobs[writer[2]]
            assert (m, n) == shape, (name, jobs)
            nb = grid - (first if first < grid else 0)
            plan, _ = cp.phase_plan(jobs, nb)
            c, tiles_n, _ = plan[writer[2]]
            tm, tn = cp.CLASSES[c][:2]
            grid_ = count.reshape(shape)
            for tile in range(-(-m // tm) * tiles_n):
                m0, n0 = (tile // tiles_n) * tm, (tile % tiles_n) * tn
                for mm, nn in (e for t in cp.finish_map(c).values()
                               for e in t):
                    if m0 + mm < m and n0 + nn < n:
                        grid_[m0 + mm, n0 + nn] += 1
        elif writer[0] == "cols":
            _, phase, c0, cols = writer
            done = cols_of.setdefault((phase, cols), [
                blk * 64 + lane + half * 32
                for blk in range(min(cp.col_blocks(cols), grid))
                for lane in range(32) for half in (0, 1)
                if blk * 64 + lane + half * 32 < cols])
            for v in done:
                if 0 <= v - c0 < count.size:
                    count[v - c0] += 1
        else:  # the one metrics warp: clear_lanes, then its lanes
            blk = writer[2] if writer[2] >= 0 else grid - 1
            count += blk < grid
        assert (count <= 1).all(), (hook, mode, name)
        once.append(bool((count == 1).all()))
    least = cp.dp_min_grid(mode, x=w["x"], h=w["h"], hd=w["hd"], l=l)
    assert all(once) == (grid >= least), (hook, mode, once, least)


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("widths", sorted(VAE_WIDTHS))
@pytest.mark.parametrize("birvae", (False, True))
def test_vae_chunk_plan_covers_every_output_once(birvae, widths, grid):
    check_phases(cp.vae_phase_jobs(birvae, **VAE_WIDTHS[widths]), grid)


@pytest.mark.parametrize("cls", range(len(cp.CLASSES)))
def test_tile_maps_cover_each_element_once(cls):
    tm, tn, ks, _ = cp.CLASSES[cls]
    gt_n = cp.CT // ks
    for tr in (tm, tn):
        for dc in (True, False):  # either shared-memory layout
            copies = cp.operand_copy_map(tr, gt_n, dc)
            flat = [e for gt in copies for e in copies[gt]]
            assert sorted(flat) == [(i, j) for i in range(tr)
                                    for j in range(cp.SK)]
    for bf16 in (False, True):
        for ad in (False, True):
            for bd in (False, True):
                cells = cp.warp_tile_map(cls, bf16, ad, bd)
                flat = [e for gt in cells for e in cells[gt]]
                assert sorted(flat) == [(i, j) for i in range(tm)
                                        for j in range(tn)]
                assert all(len(v) == 16 for v in cells.values())
    done = cp.finish_map(cls)
    flat = [e for tid in done for e in done[tid]]
    assert sorted(flat) == [(i, j) for i in range(tm) for j in range(tn)]


def test_layouts_follow_the_contiguous_index():
    # A = x [B, X] (k contiguous), B = W [X, H] (n contiguous)
    assert cp.layouts(1, 400, 1) == (True, False)
    # A = xin^T (m contiguous), B = W1d^T (k contiguous)
    assert cp.layouts(794, 1, 400) == (False, True)
    # a one-column B ([K, 1], both strides 1) keeps rows of depth
    assert cp.layouts(1, 1, 1) == (True, False)


def test_shared_memory_fits_a_block_and_matches_the_source():
    per_block = cp.SMEM_BYTES + cp.STATIC_SMEM_BYTES
    assert per_block <= cp.BLOCK_SMEM_MAX
    assert per_block + cp.SM_RESERVED <= cp.SM_SMEM
    with open(os.path.join(build.CSRC_DIR, "chunk_common.cuh")) as f:
        src = f.read()
    tiles = dict(re.findall(r"using (T\d) = Tile<([\d, ]+)>;", src))
    assert [tuple(int(v) for v in tiles[t].split(","))
            for t in ("T1", "T2", "T4", "T8")] == list(cp.CLASSES)
    for name, value in (("CT", cp.CT), ("SK", cp.SK), ("MAXJ", cp.MAXJ)):
        assert re.search(rf"#define {name} {value}\b", src), name
    # the row scratch of the row phases lies inside the rings
    warp_smem = int(re.search(r"#define WARP_SMEM (\d+)", src).group(1))
    assert cp.WARPS * warp_smem <= cp.RING_FLOATS


def test_flagship_phases_take_one_round():
    """The plan's aim at the flagship widths on an H100's 132 blocks (one
    an SM): every product phase of nsgan and of the VAE in one round over
    the blocks its row and column work leaves."""
    w = WIDTHS["flagship"]
    for name, jobs, first in (hook_phases("bce", w) + cp.vae_phase_jobs(
            False, **VAE_WIDTHS["flagship"])):
        nb = 132 - first
        _, total = cp.phase_plan(jobs, nb)
        assert total <= nb, name


def test_tile_class_prefers_deep_groups_for_short_deep_jobs():
    # B = 100 rows, K = 784: the 16x32 tiles with eight depth groups
    assert cp.tile_class(100, 400, 784, 132) == 3
    # a weight gradient, K = 2B = 200, on 118 blocks: the 64x64 tiles
    assert cp.tile_class(784, 400, 200, 118) == 0
    # a one-tile job takes the largest class on a tie of costs
    assert cp.tile_class(8, 8, 16, 132) == 0
