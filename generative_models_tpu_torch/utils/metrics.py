"""JSONL metrics stream — the port of
``generative_models_tpu/utils/metrics.py`` (the same records: one per
step with ``step``, ``ts`` and every metric, plus standalone events).

Metrics are fetched from the device after each chunk, not per step, and
written on the host. Under data parallelism the Trainer gives rank 0
alone a path and an echo (the ranks' metrics are averaged, so equal);
the others keep the history only.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional

import numpy as np


class MetricsLogger:
    def __init__(self, path: Optional[str] = None, echo_every: int = 0):
        self.path = path
        self.echo_every = echo_every
        self._fh = None
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._fh = open(path, "a", buffering=1)
        self.history: Dict[str, list] = {}

    def log_chunk(self, first_step: int, stacked: Dict[str, Any],
                  extra: Optional[Dict[str, Any]] = None):
        """`stacked`: dict of [K]-shaped arrays for steps
        first_step..first_step+K-1."""
        arrays = {k: np.asarray(v) for k, v in stacked.items()}
        k_len = len(next(iter(arrays.values()))) if arrays else 0
        now = time.time()
        for i in range(k_len):
            rec: Dict[str, Any] = {"step": first_step + i, "ts": now}
            for k, v in arrays.items():
                rec[k] = float(v[i])
                self.history.setdefault(k, []).append(float(v[i]))
            if extra:
                rec.update(extra)
            if self._fh:
                self._fh.write(json.dumps(rec) + "\n")
            if self.echo_every and (first_step + i) % self.echo_every == 0:
                shown = {k: round(rec[k], 4) for k in arrays}
                print(f"step {first_step + i}: {shown}")

    def log_event(self, record: Dict[str, Any]):
        """One standalone JSONL record (e.g. per-epoch val metrics)."""
        rec = {"ts": time.time(), **record}
        for k, v in record.items():
            if isinstance(v, (int, float)):
                self.history.setdefault(k, []).append(float(v))
        if self._fh:
            self._fh.write(json.dumps(rec) + "\n")

    def close(self):
        if self._fh:
            self._fh.close()
            self._fh = None
