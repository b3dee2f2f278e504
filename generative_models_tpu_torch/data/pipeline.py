"""Device-resident data pipeline — the port of
``generative_models_tpu/data/pipeline.py``.

The whole split is a tensor on the device for the run's lifetime and a
minibatch is a gather on the device: :func:`make_perm` draws a
full-epoch permutation from an explicit ``torch.Generator``, and
:func:`gather_batch` slices a window of it and gathers the rows. The
trainer's hot path gathers whole chunks at once (``train/step.py``);
these are the single-batch forms.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch


@dataclasses.dataclass
class DeviceData:
    """One split, resident on a device: images [N, D], labels [N]."""

    images: torch.Tensor
    labels: torch.Tensor

    @property
    def n(self) -> int:
        return self.images.shape[0]


def make_perm(gen: torch.Generator, n: int) -> torch.Tensor:
    """A full-epoch row permutation (int64), drawn on the generator's
    device."""
    return torch.randperm(n, generator=gen, device=gen.device)


def gather_batch(data: DeviceData, perm: torch.Tensor, start: int,
                 batch_size: int) -> Dict[str, torch.Tensor]:
    """Rows ``perm[start : start + batch_size]`` as a batch dict."""
    idx = perm[start:start + batch_size].to(data.images.device)
    return {"image": data.images.index_select(0, idx),
            "label": data.labels.index_select(0, idx)}
