"""The order in which ``Trainer.train`` reads the training rows and the
noise it draws, worked out again from the run's seed and the
checkpoint's ``rng`` words.

A frozen copy of the program's arithmetic, so that the reference follows
the same steps without calling the program:

- epoch e's row permutation is ``torch.randperm(rows)`` from a
  ``torch.Generator`` on the device seeded by ``(seed mod 2^31) * 2^32 +
  e`` (``train/trainer.py::Trainer._perm_window``,
  ``data/pipeline.py::make_perm``);
- step s reads ``d_steps * B`` consecutive entries of its epoch's
  permutation, from ``s * d_steps * B`` rows into the run, each epoch
  holding ``rows // (d_steps * B)`` whole steps
  (``train/step.py::gather_streams``);
- step s's noise is drawn with the rest of its block of 64 steps from a
  generator seeded by the ``rng`` words and the block's index, z_d
  ``[64, d_steps, B, z]`` first, then z_g ``[64, B, z]``
  (``train/step.py::_mix64``, ``noise_generator``, ``grid_noise``,
  ``chunk_noise``, ``draw_z``).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

NOISE_BLOCK = 64


def epoch_perm(seed: int, epoch: int, rows: int, device) -> torch.Tensor:
    g = torch.Generator(device=device).manual_seed(
        (seed % 2 ** 31) * 2 ** 32 + epoch)
    return torch.randperm(rows, generator=g, device=device)


def step_rows(seed: int, step: int, batch: int, d_steps: int, rows: int,
              device) -> torch.Tensor:
    """The row indices step `step` reads, [d_steps, batch]."""
    per_step = d_steps * batch
    per_epoch = (rows // per_step) * per_step
    e, r = divmod(step * per_step, per_epoch)
    return epoch_perm(seed, e, rows, device)[r:r + per_step].reshape(
        d_steps, batch)


def _mix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) % 2 ** 64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) % 2 ** 64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) % 2 ** 64
    return x ^ (x >> 31)


def noise_generator(words, index: int, device) -> torch.Generator:
    w = [int(v) for v in np.asarray(words, dtype=np.uint32)]
    seed = _mix64(((w[0] << 32) | w[1]) ^ _mix64(index % 2 ** 64))
    seed ^= seed >> 32
    return torch.Generator(device=device).manual_seed(seed % 2 ** 63)


def gan_noise(words, step: int, d_steps: int, batch: int, z: int,
              device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(z_d [d_steps, batch, z], z_g [batch, z]) of step `step`."""
    block, k = divmod(step, NOISE_BLOCK)
    g = noise_generator(words, block, device)
    z_d = torch.randn((NOISE_BLOCK, d_steps, batch, z), generator=g,
                      device=device)
    z_g = torch.randn((NOISE_BLOCK, batch, z), generator=g, device=device)
    return z_d[k], z_g[k]
