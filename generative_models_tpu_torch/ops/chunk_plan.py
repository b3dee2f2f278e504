"""The chunk kernels' product plan, as ``csrc/chunk_common.cuh`` makes it.

The whole-chunk kernels (``csrc/gan_chunk.cu``, ``csrc/vae_chunk.cu``)
run each phase's products through one engine: a job is cut into output
tiles of one of three classes, the tiles go to the phase's blocks in a
snake order, the block's 8 warps form depth groups that take the job's
16-deep stages in turn, and each tile's group partials are summed in group
order. The engine picks a job's class on the card at run time; this
module is that rule (:func:`tile_class`, :func:`phase_plan`) and the
engine's index arithmetic (:func:`operand_copy_map`, :func:`layouts`,
:func:`warp_tile_map`, :func:`finish_map`, :func:`tile_blocks`,
:func:`group_stages`), written
out in Python so that a CPU test can check that every output element has
one owner, that the shared memory fits, and that the depth split sums in
one order. :func:`gan_phase_jobs` and :func:`vae_phase_jobs` list every
phase's jobs (M, N, K) and the blocks it leaves to row or column work, as
the kernels build them; :func:`dp_flat_writers` says which job or column
sum writes each float of a data-parallel phase kernel's output. Nothing
here runs on the card.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

SK = 16          # depth of a stage
CT = 256         # threads a block
WARPS = CT // 32
MAXJ = 4         # product jobs a phase
# (TM, TN, KS, NS): tile rows and columns, depth groups, stages a ring;
# class ids 0 (T1), 1 (T2), 2 (T4), 3 (T8), in the engine's order
CLASSES = ((64, 64, 1, 4), (32, 64, 2, 4), (16, 64, 4, 3), (16, 32, 8, 3))
# the shared memory a block may take, and an SM holds (H100)
BLOCK_SMEM_MAX = 232448
SM_SMEM = 233472
SM_RESERVED = 1024           # a block's share the runtime keeps
STATIC_SMEM_BYTES = 2048     # the phase table and the arguments, at most


LDK = SK + 4     # a depth-contiguous row in shared memory


def stage_floats(cls: int) -> Tuple[int, int]:
    """(A's, B's) floats of one stage: either layout fits."""
    tm, tn = CLASSES[cls][:2]
    return (max(SK * (tm + 4), tm * LDK), max(SK * (tn + 4), tn * LDK))


def ring_floats(cls: int) -> int:
    ks, ns = CLASSES[cls][2:]
    return ks * ns * sum(stage_floats(cls))


RING_FLOATS = max(ring_floats(c) for c in range(len(CLASSES)))
RED_FLOATS = max(ks * tm * tn for tm, tn, ks, _ in CLASSES)
SMEM_BYTES = (RING_FLOATS + RED_FLOATS) * 4


def tile_class(m: int, n: int, k: int, nb: int) -> int:
    """The class of an m x n x k job given nb blocks: the least rounds x
    (stages a group + 2), the larger tile on a tie (chunk_common.cuh)."""
    st = -(-k // SK)
    best, best_cost = 0, None
    for c, (tm, tn, ks, _) in enumerate(CLASSES):
        tiles = -(-m // tm) * -(-n // tn)
        cost = -(-tiles // nb) * (-(-st // ks) + 2)
        if best_cost is None or cost < best_cost:
            best, best_cost = c, cost
    return best


def phase_plan(jobs: Sequence[Tuple[int, int, int]], nb: int):
    """run_gemms' table for `jobs` [(M, N, K)] on nb tile blocks: per job
    (class, tiles across N, its first tile), and the phase's tile count.
    A job's class takes its share of the blocks by M N K."""
    work = float(sum(m * n * k for m, n, k in jobs))
    plan, t = [], 0
    for m, n, k in jobs:
        # (in double precision, as the engine: every product exact)
        share = int(nb * float(m * n * k) / work) if work > 0 else nb
        c = tile_class(m, n, k, max(share, 1))
        tm, tn = CLASSES[c][:2]
        tiles_n = -(-n // tn)
        plan.append((c, tiles_n, t))
        t += -(-m // tm) * tiles_n
    return plan, t


def tile_blocks(total: int, nb: int) -> List[int]:
    """The block (of nb) each of a phase's `total` tiles goes to: round r
    to blocks 0.. when r is even, back from the last when odd."""
    out = []
    for t in range(total):
        r, pos = divmod(t, nb)
        out.append(nb - 1 - pos if r & 1 else pos)
    return out


def group_stages(k: int, ks: int, grp: int) -> List[int]:
    """The stages of a k-deep job that depth group grp takes, in order."""
    return list(range(grp, -(-k // SK), ks))


def operand_copy_map(tr: int, gt_n: int, depth_contiguous: bool):
    """load_operand's 16-byte vectors of one operand's stage, for each of
    a depth group's gt_n threads: {gt: [(row, depth) of each float]} (row
    along A's m or B's n, 0..tr-1; depth 0..SK-1)."""
    out = {}
    for gt in range(gt_n):
        cells = []
        for q in range(tr * SK // 4 // gt_n):
            v = gt + q * gt_n
            if depth_contiguous:
                rr, kv = v >> 2, (v & 3) * 4
                cells += [(rr, kv + e) for e in range(4)]
            else:
                kk, rv = divmod(v, tr // 4)
                cells += [(rv * 4 + e, kk) for e in range(4)]
        out[gt] = cells
    return out


def layouts(a_cs: int, b_rs: int, b_cs: int) -> Tuple[bool, bool]:
    """(A, B) depth-contiguous in shared memory: A when its k is
    contiguous (a.cs == 1), B when its k is and its n is not."""
    return a_cs == 1, b_rs == 1 and b_cs != 1


def warp_tile_map(cls: int, bf16: bool, ad: bool = False, bd: bool = False):
    """The (row, column) of the tile each accumulator of each thread of
    one depth group holds: {gt: [16 (mm, nn)]} (mma_stage, store_partial:
    float32 FMAs 4x4 a lane, rows and columns by the layouts ad, bd; bf16
    four m16n8k16 blocks)."""
    tm, tn, ks, _ = CLASSES[cls]
    wn_n = tn // 32
    out = {}
    for gt in range(CT // ks):
        gw, lane = divmod(gt, 32)
        wm, wn = divmod(gw, wn_n)
        cells = []
        if not bf16:
            rg, cg = divmod(lane, 8)
            for i in range(4):
                for j in range(4):
                    cells.append((wm * 16 + (rg + 4 * i if ad else 4 * rg + i),
                                  wn * 32 + (cg + 8 * j if bd else 4 * cg + j)))
        else:
            g, t = divmod(lane, 4)
            for nb in range(4):
                for i in range(4):
                    cells.append((wm * 16 + g + (8 if i >= 2 else 0),
                                  wn * 32 + nb * 8 + 2 * t + (i & 1)))
        out[gt] = cells
    return out


def finish_map(cls: int):
    """The tile elements each thread of the block sums and finishes:
    {tid: [(mm, nn)]}."""
    tm, tn = CLASSES[cls][:2]
    return {tid: [divmod(tid + e * CT, tn) for e in range(tm * tn // CT)]
            for tid in range(CT)}


def row_blocks(rows: int) -> int:
    return -(-rows // WARPS)


def col_blocks(cols: int) -> int:
    return -(-cols // 64)


# The GAN chunk kernel's hooks (ops/cuda_train.py::HOOK_IDS)
GP_HOOKS = ("gpw", "gpb")


def gan_phase_jobs(hook: str, *, b: int, z: int, h: int, x: int, hd: int,
                   l: int = 1, n_cls: int = 0, ds: int = 1,
                   mode: str = "chunk") -> List[Tuple[str, list, int]]:
    """Every product phase of one outer step of gan_chunk_kernel for
    `hook`, in order: (name, [(M, N, K)], the blocks before the tiles).
    mode "chunk", "d" (one critic update) or "g" (one G update: the
    phase kernel, whose G5 takes dW2g and db2g beside dhg)."""
    xd = x + n_cls
    gp = hook in GP_HOOKS
    out = []
    if mode == "g":
        out += [("hg", [(b, h, z)], 0), ("fake2", [(b, x, h)], 0)]
    for i in range(0 if mode == "g" else ds):
        g0 = mode == "chunk" and i == 0
        # the phase kernel ("d") runs hr beside hf in C, but for the
        # penalty hooks (in A as the chunk)
        hr_in_c = mode == "d" and not gp
        if hook == "gpb":
            a = [(b, h, z), (b, hd, x), (b, hd, x)] + ([(b, h, z)] if g0 else [])
        else:
            a = [(b, h, z)] + ([] if hr_in_c else [(b, hd, xd)]) + (
                [(b, h, z)] if g0 else [])
        out.append((f"A{i}", a, 0))
        out.append((f"B{i}", [(b, x, h)] + ([(b, x, h)] if g0 else []), 0))
        c = [(b, hd, xd)] + ([(b, hd, xd)] if hr_in_c else [])
        if hook == "gpw":
            c.append((b, hd, x))
        elif hook == "gpb":
            c.append((b, x, hd))
        out.append((f"C{i}", c, 0))
        if hook == "gpw":
            out.append((f"DE{i}", [(b, x, hd)], row_blocks(2 * b)))
            out.append((f"N{i}", [(b, hd, x)], row_blocks(b)))
        elif hook == "gpb":
            out.append((f"DE{i}", [(b, hd, x)], row_blocks(3 * b)))
        elif hook == "be":
            out.append((f"R{i}", [(2 * b, x, hd)], 0))
            out.append((f"E{i}", [(2 * b, hd, x)], row_blocks(2 * b)))
        if hook in ("info", "be"):
            out.append((f"F{i}", [(xd, hd, 2 * b), (hd, l, 2 * b)],
                        col_blocks(hd + l) + 1))
        else:
            out.append((f"F{i}", [(xd, hd, (3 if gp else 2) * b)],
                        col_blocks(hd + 1) + 1))
    if mode == "d":
        return out
    out.append(("G1", [((2 if hook == "ra" else 1) * b, hd, xd)], 0))
    if hook == "be":
        out.append(("G2", [(b, x, hd)], 0))
        out.append(("G3", [(b, hd, x)], row_blocks(b)))
    out.append(("G4", [(b, x, hd)], 0))
    if mode == "g":  # the phase kernel: dW2g and db2g beside dhg
        out.append(("G5", [(b, h, x), (h, x, b)], col_blocks(x)))
        out.append(("G6", [(z, h, b)], col_blocks(h)))
        return out
    out.append(("G5", [(b, h, x)], 0))
    out.append(("G6", [(h, x, b), (z, h, b)], col_blocks(x + h)))
    return out


LANES = 8  # floats of a metrics row


def dp_flat_writers(hook: str, mode: str, *, b: int, z: int, h: int, x: int,
                    hd: int, l: int = 1, n_cls: int = 0):
    """Who writes each float of a phase kernel's flat buffer
    (``ops/cuda_dp.py``'s layout: the mode's four gradients, then the
    metrics row), as ``gan_phase_kernel`` writes them: [(tensor, shape,
    writer)], the writer ("tile", phase, job): that job of the phase's
    product epilogue writes element (m, n) of the [M, N] tensor; ("cols",
    phase, c0, cols): col_sums column c0 + v writes element v of the
    tensor (flattened), block c of the grid taking columns 64 c .. 64 c +
    63; ("warp", phase, block): the metrics warp of that block (-1: the
    grid's last), every lane."""
    xd = x + n_cls
    if mode == "d":
        if hook in ("info", "be"):  # F: dW2d a product, the bias sums
            return [("dW1d", (xd, hd), ("tile", "F0", 0)),
                    ("db1d", (hd,), ("cols", "F0", 0, hd + l)),
                    ("dW2d", (hd, l), ("tile", "F0", 1)),
                    ("db2d", (l,), ("cols", "F0", hd, hd + l)),
                    ("metrics", (LANES,), ("warp", "F0",
                                           col_blocks(hd + l)))]
        return [("dW1d", (xd, hd), ("tile", "F0", 0)),
                ("db1d", (hd,), ("cols", "F0", 0, hd + 1)),
                ("dW2d", (hd, 1), ("cols", "F0", 0, hd + 1)),
                ("db2d", (1,), ("cols", "F0", hd, hd + 1)),
                ("metrics", (LANES,), ("warp", "F0", col_blocks(hd + 1)))]
    return [("dW1g", (z, h), ("tile", "G6", 0)),
            ("db1g", (h,), ("cols", "G6", 0, h)),
            ("dW2g", (h, x), ("tile", "G5", 1)),
            ("db2g", (x,), ("cols", "G5", 0, x)),
            ("metrics", (LANES,), ("warp", "G4", -1))]


def dp_min_grid(mode: str, *, x: int, h: int, hd: int, l: int = 1) -> int:
    """The fewest blocks a phase kernel's grid may have
    (``gm_gan_phase_min_grid``, whose plan refuses a smaller grid): a
    block for every column sum's 64 columns, and in D the metrics block
    after them."""
    if mode == "d":
        return col_blocks(hd + l) + 1
    return max(col_blocks(x), col_blocks(h))


def vae_phase_jobs(birvae: bool, *, b: int, x: int, h: int,
                   l: int) -> List[Tuple[str, list, int]]:
    """Every product phase of one step of vae_chunk_kernel, as
    gan_phase_jobs lists them."""
    out = [("1", [(b, h, x)], 0),
           ("2", [(b, l, h)] + ([] if birvae else [(b, l, h)]), 0),
           ("4", [(b, h, l)], 0), ("5", [(b, x, h)], 0), ("6", [(b, h, x)], 0),
           ("7", [(h, x, b), (b, l, h)], col_blocks(x) + 1),
           ("8", [(l, h, b)], col_blocks(h)), ("9", [(b, h, l)], 0)]
    if not birvae:
        out.append(("9b", [(b, h, l), (h, l, b)], col_blocks(l)))
    out.append(("10", [(x, h, b), (h, l, b)], col_blocks(h) + col_blocks(l)))
    return out
