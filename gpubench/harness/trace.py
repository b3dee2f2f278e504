"""The device trace of a traced run: slices of the cell's own work under
``torch.profiler``, reduced to what the per-layer metrics and the
``breakdown`` read.

The metrics' slice records the device's activity alone, so that the
profiler adds as little host work as it can to what it measures (a
slice that also records the host's operations read the training cell's
idle share on an H100 at 13-18% where it was ~8% untraced). From it:

- ``window_s``: the slice's length on the host clock, from before its
  first launch to after a ``torch.cuda.synchronize``;
- ``busy_s``: the union of the intervals in which a kernel, a copy or a
  set ran on the device;
- ``kernels``: each device operation's name (a kernel's name without its
  template arguments and signature), its event count and its seconds.

A second slice of the same work records the host's operations too, in
a harness span (``record_function``; the work inside it may open spans
of its own, a request), and gives ``idle_gaps``: the device's idle time
inside the span, by what the host was doing then: the innermost harness
span and the innermost host operation in flight at the gap's middle
(none: Python between operations), summed by that label, the longest
first. Only the ``breakdown`` reads it.

The profiler has lost kernel events in steps of many kernels, so the
rule of ``chip_smoke.py::device_ms_by_name`` is kept (a frozen copy):
each watched kernel must show a positive whole multiple of the launches
the program's own counter recorded in the slice; else the slice is
profiled again, and after ``tries`` the summary says it is not complete,
and the readers that need whole counts read nothing.
"""

from __future__ import annotations

import bisect
import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

SPAN_PREFIX = "gpubench:"


@dataclasses.dataclass
class Summary:
    window_s: float
    busy_s: float
    kernels: Dict[str, List[float]]       # name -> [events, seconds]
    idle_gaps: List[Tuple[str, float]]
    launched: Dict[str, int]               # counter -> launches in the slice
    complete: bool                         # every watched count held

    def device_ops(self, top: int = 10) -> List[Tuple[str, float]]:
        ops = sorted(self.kernels.items(), key=lambda kv: -kv[1][1])
        return [(name, secs) for name, (_, secs) in ops[:top]]

    def kernel(self, name: str) -> Optional[Tuple[int, float]]:
        """(events, seconds) of the kernel `name`, or None when it did
        not run or its events were not all kept."""
        if not self.complete or name not in self.kernels:
            return None
        n, s = self.kernels[name]
        return int(n), s


def short_name(name: str) -> str:
    """A device operation's name without ``void``, template arguments
    and signature."""
    name = name.replace("(anonymous namespace)::", "").replace("void ", "")
    return name.split("(")[0].split("<")[0].strip() or "(unnamed)"


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _innermost(events, starts, t, reach: int = 20000):
    """Of `events` (sorted by start, `starts` their starts), the one
    holding `t` that started last, which of nested events is the
    innermost; None when none of the `reach` events that started last
    before `t` holds it."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - reach, -1), -1):
        if events[j][1] >= t:
            return events[j]
    return None


def _device_ops(prof):
    """(intervals, kernels) of the device's operations in a profile:
    each (start, end) in microseconds, and name -> [events, seconds]."""
    from torch.autograd import DeviceType
    dev, kernels = [], {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA or e.name.startswith(SPAN_PREFIX):
            continue  # a span's mirror on the device's timeline: no work
        t0, t1 = e.time_range.start, e.time_range.end
        dev.append((t0, t1))
        k = kernels.setdefault(short_name(e.name), [0, 0.0])
        k[0] += 1
        k[1] += (t1 - t0) / 1e6
    return dev, kernels


def summarize(prof, window_s: float, counts: Dict[str, int],
              watch: Dict[str, str]) -> Summary:
    """The summary of a finished profile of the device alone, whose slice
    lasted `window_s` on the host clock; `counts` are the program's
    launch counters' increments over the slice, `watch` maps a kernel
    name to the counter that counts its launches."""
    dev, kernels = _device_ops(prof)
    busy_us = sum(e - s for s, e in _union(dev))
    complete = all(
        counts.get(ctr, 0) > 0 and kernels.get(k, [0])[0] > 0
        and kernels[k][0] % counts[ctr] == 0 for k, ctr in watch.items())
    return Summary(window_s=window_s, busy_s=busy_us / 1e6, kernels=kernels,
                   idle_gaps=[], launched=dict(counts), complete=complete)


def idle_gaps(prof, span: str) -> List[Tuple[str, float]]:
    """The device's idle time inside the harness span `span` of a profile
    of the host and the device, by what the host was doing (see the
    module's docstring), the ten longest."""
    from torch.autograd import DeviceType
    dev, _ = _device_ops(prof)
    host, spans = [], []
    outer = None
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            continue
        t0, t1 = e.time_range.start, e.time_range.end
        if e.name.startswith(SPAN_PREFIX):
            spans.append((t0, t1, e.name[len(SPAN_PREFIX):]))
            if e.name == SPAN_PREFIX + span:
                outer = (t0, t1)
        else:
            host.append((t0, t1, e.name))
    if outer is None:
        raise RuntimeError(f"the profile holds no span {span!r}")
    w0, w1 = outer
    busy = _union([(max(s, w0), min(e, w1)) for s, e in dev
                   if e > w0 and s < w1])
    gaps, t = [], w0
    for s, e in busy + [[w1, w1]]:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    host.sort()
    spans.sort()
    hs, ss = [h[0] for h in host], [s[0] for s in spans]
    idle: Dict[str, float] = {}
    for g0, g1 in gaps:
        mid = 0.5 * (g0 + g1)
        sp = _innermost(spans, ss, mid)
        op = _innermost(host, hs, mid)
        label = f"{sp[2] if sp else 'outside'}/{op[2] if op else 'python'}"
        idle[label] = idle.get(label, 0.0) + (g1 - g0) / 1e6
    return sorted(idle.items(), key=lambda kv: -kv[1])[:10]


def profile(fn: Callable[[], None], span: str,
            counters: Dict[str, Callable[[], int]],
            watch: Dict[str, str], tries: int = 4) -> Summary:
    """Runs `fn` under ``torch.profiler`` recording the device alone and
    summarizes it, profiling again, up to `tries` slices in all, while a
    watched kernel's events are not a whole multiple of its counter's
    launches; then runs `fn` once more recording the host too, in the
    harness span `span`, for the idle gaps. `counters` name the
    program's launch counters (a callable reading each)."""
    import torch
    from torch.profiler import ProfilerActivity, record_function
    out = None
    for _ in range(tries):
        before = {k: f() for k, f in counters.items()}
        with torch.profiler.profile(
                activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            window_s = time.perf_counter() - t0
        counts = {k: f() - before[k] for k, f in counters.items()}
        out = summarize(prof, window_s, counts, watch)
        if out.complete:
            break
    with torch.profiler.profile(activities=[
            ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(SPAN_PREFIX + span):
            fn()
            torch.cuda.synchronize()
    out.idle_gaps = idle_gaps(prof, span)
    return out


def span(name: str):
    """A harness span inside a profiled slice (a request)."""
    from torch.profiler import record_function
    return record_function(SPAN_PREFIX + name)
