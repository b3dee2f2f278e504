"""One run of one cell: set-up, the measured window, the traced slice,
the check against the reference, and the result line."""

from __future__ import annotations

import dataclasses
import json
import math
import shutil
import subprocess
import sys
import tempfile
import time
from typing import Optional

import torch

from harness import compare


@dataclasses.dataclass
class Readings:
    """What a per-layer metric's reader reads: the cell, the settings the
    run used, its end-to-end values and its traced slice (None off the
    card)."""

    cell: object
    conf: dict
    traffic: dict
    values: dict
    trace: Optional[object]


def power_limit_w() -> Optional[float]:
    """The card's power limit, as ``nvidia-smi`` reads it (None where it
    cannot)."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                            "--format=csv,noheader,nounits", "-i", "0"],
                           capture_output=True, text=True, timeout=30)
        return float(r.stdout.split()[0])
    except Exception:
        return None


def run_cell(cell, seed: int, seconds: float, traced: bool, device,
             t_start: float, overrides=None, prepare=None) -> dict:
    """The result of one run of `cell`: ``{"correct", "attempted",
    "failed", "metrics", "device"[, "breakdown"], "checks"}``.
    `t_start` is the process's start on ``time.perf_counter``'s clock;
    `prepare(s)`, when given, is called on the traffic driver's Session
    before its set-up (the control's and the tests' hook)."""
    cuda = torch.device(device).type == "cuda"
    tmp = tempfile.mkdtemp(prefix="gpubench-")
    try:
        s = cell.driver.Session(cell, seed, device, tmp, overrides)
        if prepare is not None:
            prepare(s)
        s.setup(seconds)
        setup_s = time.perf_counter() - t_start
        values = s.window(seconds)
        summary = s.trace() if traced else None
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        s.free_program()
        if cuda:
            torch.cuda.empty_cache()
        numbers = s.check()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    values["setup_s"] = setup_s
    if traced:
        r = Readings(cell, s.conf, s.traffic, values, summary)
        metrics = {}
        for m in cell.per_layer:
            v = cell.readers[m["name"]].read(r)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    dev = {"platform": "gpu" if cuda else torch.device(device).type,
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell.chips if cuda else 0,
           "memory_peak_bytes": peak}
    if summary is not None:
        dev.update(busy_s=summary.busy_s, window_s=summary.window_s)
    if cuda:
        dev["power_limit_w"] = power_limit_w()
    out = {"correct": s.failed == 0 and compare.judge(numbers, cell.limits),
           "attempted": s.attempted, "failed": s.failed,
           "metrics": metrics, "device": dev}
    if summary is not None:
        out["breakdown"] = {"device_ops": summary.device_ops(),
                            "idle_gaps": summary.idle_gaps}
    out["checks"] = {k: {"value": v, "limit": cell.limits.get(k)}
                     for k, v in numbers.items()}
    return out


def print_result(out: dict) -> None:
    """The numbers compared, each beside its limit, as the last lines on
    standard error; then the result, the last line on standard output."""
    print(f"correct {out['correct']}", file=sys.stderr)
    for k, c in out["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(_strict(out)), flush=True)


def _strict(v):
    """`v` with every number that JSON cannot hold (inf, nan) as a
    string."""
    if isinstance(v, dict):
        return {k: _strict(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_strict(x) for x in v]
    if isinstance(v, float) and not math.isfinite(v):
        return str(v)
    return v
