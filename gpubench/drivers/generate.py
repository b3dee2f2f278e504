"""Traffic driver ``generate``: batch generation through
``Trainer.sample``, as an evaluation draws its samples.

Parameters of a traffic file that names it: ``n`` (images a request),
``sample_steps`` (reverse steps a request, the configuration's
``ddpm_sample_steps``), ``warm_requests`` (requests before the window),
``check_requests`` (finished requests the check draws),
``trace_requests`` (requests in the profiled slice of a traced run).

One client in a closed loop: it calls ``Trainer.sample(z=..., chain=...)``
and, when the images are back on the host as numpy, calls again, until
the window is over; the request that is running then counts whole. Each
request's initial x and its steps' noise are drawn for it on the device
(``harness/draw.py::RequestNoise``, by the seed and the request's
index); the program draws the steps' noise through the ``chain`` it is
given, inside the call, as it would draw its own. A request's latency
runs from the call to its return.

Metrics: ``gen_images_per_s``, all images over the window's whole time
to the last request's end; ``gen_p95_ms``, the 95th percentile of all
the window's latencies.

The check, once the window has closed and the program is freed: a
sample of the finished requests drawn from the seed (reservoir
sampling), each run again by the reference from the same weights and
draws; ``image_gap`` is the widest gap of any pixel of them. A sampled
request's images are copied into buffers made before the window, and
every answer is dropped when the next request starts, so the host's
allocator sees the same pattern whatever the seed draws (keeping the
program's own arrays made some seeds' requests pay fresh pages: p95
122 ms against 132).
"""

from __future__ import annotations

import os
import random
import time

import numpy as np
import torch

from harness import compare, draw, trace
from generative_models_tpu_torch.config import variant_config
from generative_models_tpu_torch.ops import cuda_mlp
from generative_models_tpu_torch.train.trainer import Trainer


class Session:
    """One run of a generation cell on `device`; `overrides` replace
    settings of the configuration's ``trainer`` (the CPU tests' small
    sizes) and of the traffic (``n``)."""

    def __init__(self, cell, seed: int, device, tmp: str, overrides=None):
        self.cell, self.seed, self.dev, self.tmp = cell, seed, device, tmp
        over = dict(overrides or {})
        self.traffic = dict(cell.traffic)
        for k in list(over):
            if k in self.traffic:
                self.traffic[k] = over.pop(k)
        self.conf = dict(cell.config["trainer"],
                         ddpm_sample_steps=self.traffic["sample_steps"])
        self.conf.update(over)
        self.n = self.traffic["n"]
        self.noise = draw.RequestNoise(seed, self.n, self.conf["image_dim"],
                                       device)
        self.attempted = self.failed = 0

    def setup(self, seconds: float) -> None:
        c = self.conf
        self.w = draw.weights(self.cell.reference.leaves(c), self.seed,
                              self.dev)
        ckpt = draw.write_checkpoint(os.path.join(self.tmp, "weights.npz"),
                                     self.w, draw.rng_words(self.seed))
        cfg = variant_config(self.cell.config["variant"], seed=self.seed,
                             out_dir=os.path.join(self.tmp, "runs"), **c)
        self.trainer = Trainer(config=cfg, device=self.dev)
        self.trainer.load_model(ckpt)
        for i in range(self.traffic["warm_requests"]):
            self.request(("warm", i))
        # touched now, so that no copy into them faults a page in the window
        self.kept = np.full((self.traffic["check_requests"], self.n,
                             c["image_dim"]), 0.0, np.float32)

    def request(self, r) -> np.ndarray:
        out = self.trainer.sample(z=self.noise.initial(r),
                                  chain=self.noise.chain(r))
        if out.shape != (self.n, self.conf["image_dim"]):
            raise RuntimeError(f"request {r}: images of shape {out.shape}")
        return out

    def window(self, seconds: float) -> dict:
        keep = len(self.kept)
        pick = random.Random(draw.sub_seed(self.seed, "check"))
        self.kept_ids, lat = [], []
        t0 = time.perf_counter()
        end = t0 + seconds
        r = 0
        while time.perf_counter() < end:
            a = time.perf_counter()
            out = self.request(r)
            lat.append(time.perf_counter() - a)
            # reservoir sampling of `keep` requests from those finished
            j = r if r < keep else pick.randrange(r + 1)
            if j < keep:
                np.copyto(self.kept[j], out)
                if j == len(self.kept_ids):
                    self.kept_ids.append(r)
                else:
                    self.kept_ids[j] = r
            del out
            r += 1
        t1 = time.perf_counter()
        self.attempted = r
        return {"gen_images_per_s": r * self.n / (t1 - t0),
                "gen_p95_ms": float(np.percentile(lat, 95)) * 1e3}

    def trace(self):
        if torch.device(self.dev).type != "cuda":
            return None  # a device trace is the card's alone
        k = self.traffic["trace_requests"]

        def requests():
            for i in range(k):
                with trace.span("request"):
                    self.request(("trace", i))
        return trace.profile(requests, "requests",
                             {"mlp_fwd": lambda: cuda_mlp.launches},
                             {"mlp_fwd_kernel": "mlp_fwd"})

    def free_program(self) -> None:
        del self.trainer

    def check(self) -> dict:
        ref, c = self.cell.reference, self.conf
        gap = 0.0
        for r, out in zip(self.kept_ids, self.kept):
            want = ref.sample(self.w, self.noise.initial(r),
                              self.noise.chain(r), c, c["ddpm_sample_steps"])
            gap = max(gap, compare.max_abs_gap(
                torch.from_numpy(out).to(want.device), want))
        return {"image_gap": gap}
