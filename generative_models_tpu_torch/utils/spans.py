"""Spans and counters of the port's own phases: what the host does in
``Trainer.train``, the chunk functions, ``Trainer.sample`` and the
sampler, and where it waits on the card.

- :func:`span` ``(name, at=None, n=None)`` is a context manager recording
  the span's name, its start and end on ``time.perf_counter_ns``, the
  span open when it started (its parent), its request (the id a
  ``trainer.chunk`` or ``trainer.sample`` span takes when no request is
  open, which every span inside it shares), and two plain values: `at`,
  the step or index it starts at, and `n`, how many it covers.
- :func:`count` ``(name, n=1)`` adds to a named counter.
- A span whose name ends in ``.wait`` is the host blocked on the card,
  and is never host work; :func:`wait` makes one around a synchronize,
  so that the blocking copy after it is timed apart from the wait for
  the work queued before it.
- :func:`syncs` ``(name, device)`` counts, as the counter `name`, the
  calls inside it that synchronize the host with the card: torch's own
  count of them (its sync debug mode), whatever spans mark them.

Tracing is on after :func:`enable` and while a ``torch.profiler``
profile records (``torch.autograd.profiler._is_profiler_enabled``), so
every profiled run gets the synchronizes of :func:`wait`. Off,
:func:`span` and :func:`syncs` return one shared no-op context and read
no clock, and :func:`count` and :func:`wait` do nothing: a call site
costs one global check and allocates nothing. On, the spans are kept in
a ring of the newest :data:`RING`, and per name the count, total, self
and longest nanoseconds (self: the duration less the time its children
cover; the CLI's ``--profile`` prints them). ``enable(ranges=True)``
also enters each span as a ``record_function`` range named
``gmt.<name>`` in the running profile, on the profiler's own clock
beside the ops and kernels (the CLI's ``--profile``); under a profiler
the program did not start the ranges stay off, since a range leaves
events of its own in that profile.

Each thread keeps its own stack of open spans; the ring, aggregates and
counters are the process's.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time
import warnings
from typing import Dict, List, Optional, Tuple

import torch
from torch.autograd import profiler as _autograd_profiler

RING = 1 << 16  # spans kept, the newest
REQUEST_ROOTS = ("trainer.chunk", "trainer.sample")
RANGE_PREFIX = "gmt."
WAIT_SUFFIX = ".wait"
# torch's warning at a synchronizing call under its sync debug mode, and
# its note that the mode is a prototype
SYNC_WARNING = "called a synchronizing CUDA operation"
SYNC_MODE_NOTE = "Synchronization debug mode"

Span = collections.namedtuple(
    "Span", "id name start_ns end_ns parent request at n")

_NOOP = contextlib.nullcontext()
_enabled = False
_ranges = False
_local = threading.local()
_ring: collections.deque = collections.deque(maxlen=RING)
_aggregates: Dict[str, List[int]] = {}  # name -> [count, total, self, max]
_counters: Dict[str, int] = {}
_span_ids = itertools.count(1)
_request_ids = itertools.count(1)


def enable(ranges: bool = False) -> None:
    """Tracing on until :func:`disable`; with `ranges`, each span also a
    ``gmt.<name>`` range of the running profile."""
    global _enabled, _ranges
    _enabled, _ranges = True, ranges


def disable() -> None:
    """Tracing on again only while a profiler records, and no ranges."""
    global _enabled, _ranges
    _enabled = _ranges = False


def on() -> bool:
    return _enabled or _autograd_profiler._is_profiler_enabled


def reset() -> None:
    """Forget the spans, aggregates and counters recorded so far, and
    number spans and requests from 1 again."""
    global _span_ids, _request_ids
    _ring.clear()
    _aggregates.clear()
    _counters.clear()
    _span_ids, _request_ids = itertools.count(1), itertools.count(1)


def _stack() -> list:
    s = getattr(_local, "stack", None)
    if s is None:
        s = _local.stack = []
    return s


class _Span:
    __slots__ = ("name", "at", "n", "id", "parent", "request", "start",
                 "child_ns", "range")

    def __init__(self, name: str, at, n):
        self.name, self.at, self.n = name, at, n

    def __enter__(self):
        stack = _stack()
        top = stack[-1] if stack else None
        self.id = next(_span_ids)
        if top is not None and top.request is not None:
            self.request = top.request
        elif self.name in REQUEST_ROOTS:
            self.request = next(_request_ids)
        else:
            self.request = None
        self.parent = None if top is None else top.id
        self.child_ns = 0
        self.range = None
        if _ranges and _autograd_profiler._is_profiler_enabled:
            self.range = _autograd_profiler.record_function(
                RANGE_PREFIX + self.name)
            self.range.__enter__()
        stack.append(self)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        if self.range is not None:
            self.range.__exit__(*exc)
        stack = _stack()
        stack.pop()
        dur = end - self.start
        if stack:
            stack[-1].child_ns += dur
        a = _aggregates.setdefault(self.name, [0, 0, 0, 0])
        a[0] += 1
        a[1] += dur
        a[2] += dur - self.child_ns
        a[3] = max(a[3], dur)
        _ring.append(Span(self.id, self.name, self.start, end, self.parent,
                          self.request, self.at, self.n))
        return False


def span(name: str, at=None, n=None):
    """A span `name` (starting at `at`, covering `n`) while tracing is
    on; else the shared no-op context."""
    if not (_enabled or _autograd_profiler._is_profiler_enabled):
        return _NOOP
    return _Span(name, at, n)


def count(name: str, n: int = 1) -> None:
    """Adds `n` to the counter `name` while tracing is on."""
    if _enabled or _autograd_profiler._is_profiler_enabled:
        _counters[name] = _counters.get(name, 0) + n


def wait(name: str, device) -> None:
    """While tracing is on and `device` is a CUDA device, a span `name`
    (ending in ``.wait``) around a synchronize of its current stream,
    which :func:`syncs` leaves out (it is tracing's own); nothing
    otherwise (off, the blocking call that follows waits itself)."""
    if not (_enabled or _autograd_profiler._is_profiler_enabled):
        return
    dev = torch.device(device)
    if dev.type == "cuda":
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode(0)
        try:
            with _Span(name, None, None):
                torch.cuda.current_stream(dev).synchronize()
        finally:
            torch.cuda.set_sync_debug_mode(mode)


class _Syncs:
    """Torch's sync debug mode on inside it, its warnings counted into the
    counter `name`; any other warning shown again on the way out."""

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.mode = torch.cuda.get_sync_debug_mode()
        self.caught = warnings.catch_warnings(record=True)
        self.got = self.caught.__enter__()
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        return self

    def __exit__(self, *exc):
        torch.cuda.set_sync_debug_mode(self.mode)
        self.caught.__exit__(*exc)
        found = 0
        for w in self.got:
            msg = str(w.message)
            if SYNC_WARNING in msg:
                found += 1
            elif SYNC_MODE_NOTE not in msg:
                warnings.warn_explicit(w.message, w.category, w.filename,
                                       w.lineno)
        count(self.name, found)
        return False


def syncs(name: str, device):
    """While tracing is on and `device` is a CUDA device, a context that
    adds to the counter `name` the calls inside it that synchronize the
    host with the card, as torch's sync debug mode finds them (a copy
    to the host, ``.item()``, a copy from pageable memory, a stream
    synchronize); else the shared no-op context."""
    if not (_enabled or _autograd_profiler._is_profiler_enabled):
        return _NOOP
    if torch.device(device).type != "cuda":
        return _NOOP
    return _Syncs(name)


def snapshot() -> dict:
    """``{"spans": [Span, ...] (oldest first, by end), "aggregates":
    {name: {"count", "total_ns", "self_ns", "max_ns"}}, "counters":
    {name: n}}``."""
    aggs = {k: dict(zip(("count", "total_ns", "self_ns", "max_ns"), v))
            for k, v in _aggregates.items()}
    return {"spans": list(_ring), "aggregates": aggs,
            "counters": dict(_counters)}


def requests(snap: dict, root: str) -> List[Tuple[Span, List[Span]]]:
    """The requests of `snap` opened by a span named `root`, in the order
    they were opened: (that span, every span of the request, it too). A
    request whose opening span the ring no longer holds is left out."""
    first: Dict[int, Span] = {}
    members: Dict[int, List[Span]] = {}
    for s in snap["spans"]:
        if s.request is None:
            continue
        members.setdefault(s.request, []).append(s)
        if s.request not in first or s.id < first[s.request].id:
            first[s.request] = s
    return [(first[r], members[r]) for r in sorted(members)
            if first[r].name == root]


def wait_ns(members: List[Span]) -> int:
    """The time that `members`' ``.wait`` spans cover, each counted once
    (a wait inside another wait is inside its time)."""
    by_id = {s.id: s for s in members}
    total = 0
    for s in members:
        if not s.name.endswith(WAIT_SUFFIX):
            continue
        p: Optional[Span] = by_id.get(s.parent)
        while p is not None and not p.name.endswith(WAIT_SUFFIX):
            p = by_id.get(p.parent)
        if p is None:
            total += s.end_ns - s.start_ns
    return total
