"""What a run draws from its ``--seed``: the weights, the training split
and each request's noise, on the device in a few large calls; and the
checkpoint file in the JAX package's npz layout through which the
weights reach the program (``Trainer.load_model``) and the reference
alike."""

from __future__ import annotations

import hashlib
import json
import math
import os
from typing import Dict, Iterable, Tuple

import numpy as np
import torch


def sub_seed(seed: int, *tags) -> int:
    """A 63-bit seed for one purpose of a run (``tags``), so that the
    weights, the data and the noise draw from streams of their own."""
    h = hashlib.sha256(repr((int(seed),) + tuple(tags)).encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def generator(seed: int, *tags, device="cpu") -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, *tags))


def weights(leaves: Iterable[Tuple[str, tuple, float]], seed: int,
            device) -> Dict[str, torch.Tensor]:
    """Each leaf ``(path, shape, bound)`` drawn U(-bound, bound) float32
    on `device` from one ``torch.rand`` call; every leaf, biases too, is
    nonzero."""
    leaves = list(leaves)
    sizes = [math.prod(shape) for _, shape, _ in leaves]
    u = torch.rand(sum(sizes), generator=generator(seed, "weights",
                                                   device=device),
                   device=device)
    out, off = {}, 0
    for (path, shape, bound), n in zip(leaves, sizes):
        out[path] = (u[off:off + n].view(shape) * 2.0 - 1.0) * bound
        off += n
    return out


def rng_words(seed: int) -> np.ndarray:
    """The checkpoint's two ``rng`` words, from which the program seeds
    its training noise."""
    s = sub_seed(seed, "rng")
    return np.array([s & 0xFFFFFFFF, (s >> 32) & 0xFFFFFFFF], np.uint32)


def write_checkpoint(path: str, leaves: Dict[str, object],
                     rng: np.ndarray, step: int = 0) -> str:
    """An npz in the JAX package's checkpoint layout: ``leaf_00000`` ...
    in the order of the sorted tree paths, with ``__meta__`` listing each
    leaf's path, shape and dtype; ``['rng']`` uint32 [2] and ``['step']``
    int32. A leaf is a tensor or a numpy array (an optimizer's count)."""
    arrays = {p: t.detach().cpu().numpy() if torch.is_tensor(t)
              else np.asarray(t) for p, t in leaves.items()}
    arrays["['rng']"] = np.asarray(rng, np.uint32)
    arrays["['step']"] = np.asarray(step, np.int32)
    paths = sorted(arrays)
    meta = json.dumps([{"path": p, "shape": list(arrays[p].shape),
                        "dtype": str(arrays[p].dtype)} for p in paths])
    flat = {f"leaf_{i:05d}": arrays[p] for i, p in enumerate(paths)}
    np.savez(path, **flat, __meta__=np.array(meta))
    return path


def split(seed: int, rows: int, test_rows: int, dim: int, classes: int,
          device) -> Dict[str, np.ndarray]:
    """A synthetic split of MNIST's shape: `rows` training and
    `test_rows` test rows of `dim` float32 pixels in [0, 1) with integer
    labels, drawn on `device` and handed over as numpy arrays, the form
    ``Trainer(data=...)`` takes."""
    g = generator(seed, "data", device=device)
    x = torch.rand((rows + test_rows, dim), generator=g, device=device)
    y = torch.randint(0, classes, (rows + test_rows,), generator=g,
                      device=device, dtype=torch.int32)
    x, y = x.cpu().numpy(), y.cpu().numpy()
    return {"x_train": x[:rows], "y_train": y[:rows],
            "x_test": x[rows:], "y_test": y[rows:]}


class RequestNoise:
    """Request r's initial x and reverse-step noise, each [n, dim] and
    N(0, 1), from a generator reseeded by (seed, r, i): i = 0 the
    initial x, i = k + 1 step k's noise. A draw depends on (seed, r, i)
    alone, so the reference draws the same numbers in any order."""

    def __init__(self, seed: int, n: int, dim: int, device):
        self.seed, self.n, self.dim, self.device = seed, n, dim, device
        self.gen = torch.Generator(device=device)

    def draw(self, r, i) -> torch.Tensor:
        self.gen.manual_seed(sub_seed(self.seed, "request", r, i))
        return torch.randn((self.n, self.dim), generator=self.gen,
                           device=self.device)

    def initial(self, r) -> torch.Tensor:
        return self.draw(r, 0)

    def chain(self, r):
        """Step k -> its noise, as ``Trainer.sample(chain=...)`` takes it."""
        return lambda k: self.draw(r, k + 1)
