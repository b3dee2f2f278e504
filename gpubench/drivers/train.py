"""Traffic driver ``train``: a training run through ``Trainer.train``, as a
user's run makes it.

Parameters of a traffic file that names it: ``batch_size`` (rows a
critic batch), ``resume_steps`` (the plain reference's steps that make
the state the run resumes from), ``warm_chunks`` (chunks of
``scan_steps`` steps run before the window; all but the first, which
allocates the chunk's streams, are timed and size the window),
``trace_chunks`` (chunks in a profiled slice of a traced run).

Set-up builds one Trainer from the configuration's ``trainer`` settings,
the run's seed and a synthetic split of the configuration's ``data``
shape, and resumes it from a checkpoint through ``Trainer.load_model``
(the path users take): weights drawn from the seed, trained by the
plain reference for ``resume_steps`` steps with Adam from scratch, and
written with both Adams' moments and counts, the ``rng`` words and the
``step`` that follows. That step is two before the first step that opens
an epoch and a noise block at once (``check_start``: 4798 at B 100 over
60,000 rows, where epoch 8 and block 75 open at step 4800), so the
checked steps read a later epoch's permutation, from deep in one noise
block into the next, with Adam's moments of a run under way. The same
object is driven through three checked steps with the window's own
call: ``train(steps=1)``, then ``train(steps=2)``, which crosses both
boundaries, on rows that all differ. It then warms the chunk's shapes,
and the window is ONE call, ``train(steps=N)``, N a whole number of
chunks sized from the warm-up's rate to fill the window; the rate is N
over that call's wall time, which ends in the Trainer's own
``torch.cuda.synchronize``.

The check, once the window has closed and the program is freed: the
reference follows the three checked steps from the same checkpoint,
rows and noise, and four numbers are compared:

- ``loss_gap``: the first checked step's d_loss, the gap relative to
  the reference's;
- ``d_grad_gap``, ``g_grad_gap``: the critic's and the generator's
  gradients of the first checked step as their optimizers got them,
  worked out from the program's Adam state after it ((mu - b1 mu0) /
  (1 - b1)), each by its worst leaf
  (``harness/compare.py::worst_leaf_gap``);
- ``change_gap``: the parameters' change over the three steps, by the
  median leaf, over the leaves the reference's first gradient moves
  (``compare.moving_leaves``).

The later steps' losses, the worst leaf's change and each checked
step's least |pre-activation| (``margin``: near 0, rounding picks the
(Leaky)ReLU's slope) are kept as ``detail`` beside the numbers, for the
readings, and not limited. The
window's chunks are single launches of 1000 steps (the streams' budget
holds them whole), and only the first three steps of a launch are
followed: a GAN's state drifts by rounding past them.
"""

from __future__ import annotations

import math
import os
import time

import numpy as np
import torch

from harness import compare, draw, trace
from reference import order
from generative_models_tpu_torch.config import variant_config
from generative_models_tpu_torch.ops import cuda_train
from generative_models_tpu_torch.train.trainer import Trainer
from generative_models_tpu_torch.utils.checkpoint import state_leaves

CHECK_STEPS = 3


def check_start(rows: int, batch: int, d_steps: int) -> int:
    """The first checked step: two before the first step that opens an
    epoch (``rows // (d_steps * batch)`` steps each) and a block of
    ``order.NOISE_BLOCK`` steps at once."""
    per_epoch = rows // (max(d_steps, 1) * batch)
    return math.lcm(per_epoch, order.NOISE_BLOCK) - 2


def opt_leaves(opt) -> dict:
    """Adam's state ``{"mu", "nu", "count"}`` as the checkpoint's leaves:
    ``['d_opt'][0].mu[0]['w']`` for ``['d_params'][0]['w']``, and
    ``['d_opt'][0].count`` int32."""
    out = {}
    for side in ("d", "g"):
        src, dst = f"['{side}_params']", f"['{side}_opt'][0]"
        for slot in ("mu", "nu"):
            out.update({k.replace(src, f"{dst}.{slot}"): v
                        for k, v in opt[slot].items() if k.startswith(src)})
        out[f"{dst}.count"] = np.asarray(opt["count"][side], np.int32)
    return out


class Session:
    """One run of a training cell on `device`. `overrides` replace
    settings of the configuration's ``trainer`` and ``data`` (the CPU
    tests' small sizes; the control's precision)."""

    def __init__(self, cell, seed: int, device, tmp: str, overrides=None):
        self.cell, self.seed, self.dev, self.tmp = cell, seed, device, tmp
        over = dict(overrides or {})
        self.data_shape = dict(cell.config["data"])
        for k in list(over):
            if k in self.data_shape:
                self.data_shape[k] = over.pop(k)
        self.traffic = cell.traffic
        self.conf = dict(cell.config["trainer"],
                         batch_size=cell.traffic["batch_size"])
        self.conf.update(over)
        self.attempted = self.failed = 0

    # -- set-up ---------------------------------------------------------
    def setup(self, seconds: float) -> None:
        c, dev, seed = self.conf, self.dev, self.seed
        ref = self.cell.reference
        shape = self.data_shape
        self.data = draw.split(seed, shape["train_rows"], shape["test_rows"],
                               c["image_dim"], shape["classes"], dev)
        self.words = draw.rng_words(seed)
        self.first = check_start(shape["train_rows"], c["batch_size"],
                                 c["d_steps"])
        # the resume point: the plain reference's steps from drawn weights
        x = torch.from_numpy(self.data["x_train"]).to(dev)
        _, _, self.w0, self.opt0 = ref.train(
            draw.weights(ref.leaves(c), seed, dev), x, seed, self.words,
            self.traffic["resume_steps"], c, c["batch_size"],
            self.first - self.traffic["resume_steps"])
        del x
        ckpt = draw.write_checkpoint(
            os.path.join(self.tmp, "resume.npz"),
            {**self.w0, **opt_leaves(self.opt0)}, self.words, self.first)
        cfg = variant_config(self.cell.config["variant"], seed=seed,
                             out_dir=os.path.join(self.tmp, "runs"), **c)
        self.trainer = t = Trainer(config=cfg, device=dev, data=self.data)
        t.load_model(ckpt)
        # the checked steps, through the window's own call and feed
        h1 = t.train(steps=1)
        b1, mu0 = c["adam_b1"], self.opt0["mu"]
        self.grads = {}
        for p, v in state_leaves(t.state):
            if ".mu" in p:
                k = p.replace("_opt'][0].mu", "_params']")
                self.grads[k] = (v.detach() - b1 * mu0[k]) / (1.0 - b1)
        h2 = t.train(steps=CHECK_STEPS - 1)
        self.losses = [(h["d_loss"][i], h["g_loss"][i])
                       for h, n in ((h1, 1), (h2, CHECK_STEPS - 1))
                       for i in range(n)]
        self.after = {p: v.detach().clone() for p, v in state_leaves(t.state)
                      if p in self.w0}
        # warm the chunk's shapes; its rate sizes the window
        scan = t.cfg.scan_steps
        t.train(steps=scan)
        timed = (self.traffic["warm_chunks"] - 1) * scan
        t0 = time.perf_counter()
        t.train(steps=timed)
        rate = timed / (time.perf_counter() - t0)
        self.window_steps = max(1, round(rate * seconds / scan)) * scan

    # -- the window -----------------------------------------------------
    def window(self, seconds: float) -> dict:
        n = self.window_steps
        self.attempted = n
        t0 = time.perf_counter()
        self.trainer.train(steps=n)
        dt = time.perf_counter() - t0
        return {"train_steps_per_s": n / dt}

    # -- the traced slice -----------------------------------------------
    def trace(self):
        if torch.device(self.dev).type != "cuda":
            return None  # a device trace is the card's alone
        t = self.trainer
        steps = self.traffic["trace_chunks"] * t.cfg.scan_steps
        return trace.profile(
            lambda: t.train(steps=steps), "train",
            {"gan_chunk": lambda: cuda_train.launches},
            {"gan_chunk_kernel": "gan_chunk"})

    def free_program(self) -> None:
        del self.trainer

    # -- the check ------------------------------------------------------
    def check(self) -> dict:
        ref, c = self.cell.reference, self.conf
        x = torch.from_numpy(self.data["x_train"]).to(self.dev)
        margins = []
        losses, first, after, _ = ref.train(
            self.w0, x, self.seed, self.words, CHECK_STEPS, c,
            c["batch_size"], self.first, self.opt0, margins)
        prog_change = {k: self.after[k] - self.w0[k] for k in self.w0}
        ref_change = {k: after[k] - self.w0[k] for k in self.w0}
        moving = compare.moving_leaves(first)
        side = {s: [k for k in first if k.startswith(f"['{s}_params']")]
                for s in ("d", "g")}
        self.detail = {
            "step_losses": [[compare.rel_gap(p, r) for p, r in zip(pl, rl)]
                            for pl, rl in zip(self.losses, losses)],
            "worst_change": compare.worst_leaf_gap(prog_change, ref_change,
                                                   moving),
            "g_grad_leaves": compare.leaf_gaps(self.grads, first, side["g"]),
            "margins": margins}
        return {
            "loss_gap": compare.rel_gap(self.losses[0][0], losses[0][0]),
            "d_grad_gap": compare.worst_leaf_gap(self.grads, first, side["d"]),
            "g_grad_gap": compare.worst_leaf_gap(self.grads, first, side["g"]),
            "change_gap": compare.median_leaf_gap(prog_change, ref_change,
                                                  moving),
        }
