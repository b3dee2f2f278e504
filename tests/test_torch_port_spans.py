"""The port's spans and counters (``utils/spans.py``): off they cost one
check and record nothing; on (``enable`` or a recording profiler) they
keep parents, self time and request ids; ``enable(ranges=True)`` puts
each span into the profile as a ``gmt.`` range; the Trainer, the chunk
functions and the sampler open their spans; and the benchmark's four
span readers (``gpubench/metrics``) read them."""

import os
import sys
import types

import numpy as np
import pytest
import torch

from conftest import TINY
from generative_models_tpu_torch.ops import linear
from generative_models_tpu_torch.train.trainer import Trainer
from generative_models_tpu_torch.utils import spans

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
METRICS = os.path.join(ROOT, "gpubench", "metrics")
KW = {**TINY, "scan_steps": 8}


@pytest.fixture(autouse=True)
def fresh_spans():
    spans.disable()
    spans.reset()
    yield
    spans.disable()
    spans.reset()


def _nsgan(tiny_data, tmp_path, **kw):
    return Trainer("nsgan", device="cpu", data=tiny_data,
                   out_dir=str(tmp_path), **{**KW, **kw})


def _clock_calls_from_spans(monkeypatch):
    """A list that grows by one at each ``time.perf_counter_ns`` call
    made from ``utils/spans.py``."""
    calls = []
    real = spans.time.perf_counter_ns

    def counted():
        if sys._getframe(1).f_globals.get("__name__") == spans.__name__:
            calls.append(1)
        return real()
    monkeypatch.setattr(spans.time, "perf_counter_ns", counted)
    return calls


def test_off_a_span_is_the_shared_noop_and_reads_no_clock(tiny_data,
                                                          tmp_path,
                                                          monkeypatch):
    calls = _clock_calls_from_spans(monkeypatch)
    assert spans.span("trainer.chunk", 0, 8) is spans.span("x")
    assert spans.syncs("chunk.syncs", "cuda") is spans.span("x")
    assert not spans.on()
    t = _nsgan(tiny_data, tmp_path, fused_step=True)
    t.train(steps=32)  # crosses an epoch: grid, PNG and fetch too
    t.sample(4)
    spans.count("chunk.syncs", 10)
    spans.wait("fetch.wait", "cuda")
    snap = spans.snapshot()
    assert calls == []
    assert snap["spans"] == [] and snap["aggregates"] == {}
    assert snap["counters"] == {}
    spans.enable()
    t.train(steps=8)
    assert calls  # the same counter sees the clock once tracing is on


def test_nested_spans_keep_parents_self_time_and_requests(monkeypatch):
    ticks = iter(range(0, 10_000, 10))
    monkeypatch.setattr(spans.time, "perf_counter_ns", lambda: next(ticks))
    spans.enable()
    with spans.span("outside"):
        pass
    with spans.span("trainer.chunk", 5, 2) as chunk:
        with spans.span("trainer.launch"):
            with spans.span("chunk.count.wait"):
                pass
        with spans.span("trainer.images"):
            with spans.span("trainer.sample"):  # inside the chunk's request
                with spans.span("sample.wait"):
                    with spans.span("inner.wait"):
                        pass
    with spans.span("trainer.sample"):
        pass
    spans.count("chunk.syncs", 7)
    spans.count("chunk.syncs")
    snap = spans.snapshot()
    by = {s.id: s for s in snap["spans"]}
    names = {s.name: s for s in snap["spans"]}
    assert names["outside"].request is None and names["outside"].parent is None
    assert chunk.request == 1
    assert (names["trainer.chunk"].at, names["trainer.chunk"].n) == (5, 2)
    assert (names["outside"].at, names["outside"].n) == (None, None)
    for n in ("trainer.launch", "chunk.count.wait", "trainer.images",
              "sample.wait", "inner.wait"):
        assert names[n].request == 1
    assert by[names["chunk.count.wait"].parent].name == "trainer.launch"
    assert by[names["trainer.launch"].parent].name == "trainer.chunk"
    samples = [s for s in snap["spans"] if s.name == "trainer.sample"]
    assert [s.request for s in samples] == [1, 2]
    # every enter and exit reads the clock once: 10 ns a tick
    dur = {s.name: s.end_ns - s.start_ns for s in snap["spans"]}
    assert dur["chunk.count.wait"] == 10 and dur["trainer.launch"] == 30
    agg = snap["aggregates"]
    assert agg["trainer.chunk"]["count"] == 1
    assert agg["trainer.chunk"]["self_ns"] == (
        dur["trainer.chunk"] - dur["trainer.launch"] - dur["trainer.images"])
    assert agg["trainer.sample"]["count"] == 2
    assert agg["trainer.sample"]["max_ns"] == max(s.end_ns - s.start_ns
                                                  for s in samples)
    assert snap["counters"] == {"chunk.syncs": 8}
    assert set(snap) == {"spans", "aggregates", "counters"}
    (root, members), = spans.requests(snap, "trainer.chunk")
    assert root.name == "trainer.chunk" and len(members) == 7
    # the nested wait counts inside the outer one's time
    assert spans.wait_ns(members) == (dur["chunk.count.wait"]
                                      + dur["sample.wait"])
    assert [r.name for r, _ in spans.requests(snap, "trainer.sample")] == [
        "trainer.sample"]
    spans.disable()
    assert spans.span("x") is spans.span("y")
    spans.count("chunk.syncs")
    assert spans.snapshot()["counters"] == {"chunk.syncs": 8}


def test_off_a_site_allocates_nothing():
    """Off, a site with its values gets the shared no-op back, and no
    entry point takes ``*args`` or ``**kwargs``, for which every call
    would build a tuple or a dict, tracing on or off."""
    import inspect
    for fn in (spans.span, spans.count, spans.wait, spans.syncs):
        kinds = {p.kind for p in inspect.signature(fn).parameters.values()}
        assert not kinds & {inspect.Parameter.VAR_POSITIONAL,
                            inspect.Parameter.VAR_KEYWORD}, fn
    assert spans.span("sampler.step", 7) is spans._NOOP
    assert spans.span("trainer.chunk", 1000, 1000) is spans._NOOP
    assert spans.syncs("chunk.syncs", "cuda") is spans._NOOP
    assert spans.wait("fetch.wait", "cuda") is None


def test_syncs_counts_the_sync_warnings_and_shows_the_rest(monkeypatch):
    """Inside :func:`spans.syncs` torch's sync debug mode is on; each of
    its warnings adds one to the counter, its prototype note is dropped,
    any other warning is shown again, and the mode is put back (the
    card's own mode faked here: the CPU's torch has none)."""
    import warnings
    modes = [0]
    monkeypatch.setattr(spans.torch.cuda, "get_sync_debug_mode",
                        lambda: modes[-1])
    monkeypatch.setattr(spans.torch.cuda, "set_sync_debug_mode",
                        modes.append)
    spans.enable()
    assert spans.syncs("chunk.syncs", "cpu") is spans._NOOP
    for _ in range(2):
        with pytest.warns(RuntimeWarning, match="the program's own"):
            with spans.syncs("chunk.syncs", "cuda"):
                assert modes[-1] == "warn"
                warnings.warn(spans.SYNC_MODE_NOTE + " is a prototype")
                for _ in range(3):
                    warnings.warn(spans.SYNC_WARNING + " (Triggered)")
                warnings.warn("the program's own", RuntimeWarning)
        assert modes[-1] == 0
    assert spans.snapshot()["counters"] == {"chunk.syncs": 6}


def _prof_events(prof, prefix):
    return [e for e in prof.events() if e.name.startswith(prefix)]


@pytest.mark.parametrize("ranges", [False, True])
def test_a_recording_profiler_turns_spans_on_ranges_only_when_asked(ranges):
    from torch.profiler import ProfilerActivity
    a = torch.ones(8, 8)
    if ranges:
        spans.enable(ranges=True)
    with torch.profiler.profile(activities=[ProfilerActivity.CPU]) as prof:
        assert spans.on()
        with spans.span("trainer.chunk"):
            torch.mm(a, a)
    spans.disable()
    assert not spans.on()
    assert [s.name for s in spans.snapshot()["spans"]] == ["trainer.chunk"]
    gmt = _prof_events(prof, spans.RANGE_PREFIX)
    if not ranges:
        assert gmt == []
        return
    assert [e.name for e in gmt] == ["gmt.trainer.chunk"]
    mm = _prof_events(prof, "aten::mm")
    assert mm
    for e in mm:
        assert gmt[0].time_range.start <= e.time_range.start
        assert e.time_range.end <= gmt[0].time_range.end


@pytest.mark.parametrize("fused", [True, False])
def test_train_opens_one_chunk_span_a_chunk_and_waits_inside_them(
        tiny_data, tmp_path, fused):
    t = _nsgan(tiny_data, tmp_path, fused_step=fused, val_size=64)
    spans.enable()
    t.train(steps=32)  # 4 chunks; epoch 1 (28 steps) ends in the last
    snap = spans.snapshot()
    chunks = spans.requests(snap, "trainer.chunk")
    assert [(r.at, r.n) for r, _ in chunks] == [
        (f, 8) for f in (0, 8, 16, 24)]
    agg = snap["aggregates"]
    assert agg["trainer.chunk"]["count"] == 4
    for name in ("trainer.perm", "trainer.launch", "chunk.gather",
                 "chunk.noise"):
        assert agg[name]["count"] == 4, name
    assert agg.get("chunk.kernel", {}).get("count", 0) == (4 if fused else 0)
    assert agg.get("chunk.count.wait", {}).get("count", 0) == (
        4 if fused else 0)
    for name in ("trainer.fetch", "trainer.log", "trainer.eval",
                 "trainer.images", "images.png", "trainer.sample",
                 "sample.copy"):
        assert agg[name]["count"] == 1, name
    roots = {r.request for r, _ in chunks}
    waits = [s for s in snap["spans"] if s.name.endswith(spans.WAIT_SUFFIX)]
    assert all(s.request in roots for s in waits)
    # the grid's sample runs inside the last chunk's request
    last = chunks[-1][1]
    assert {"trainer.images", "trainer.sample", "sample.copy",
            "trainer.eval"} <= {s.name for s in last}
    assert t.history["d_loss"] and len(t.history["d_loss"]) == 32


def test_ddpm_sample_gives_a_span_a_reverse_step_and_one_copy(tmp_path):
    t = Trainer("ddpm", device="cpu", out_dir=str(tmp_path), **TINY)
    spans.enable()
    out = t.sample(4)
    snap = spans.snapshot()
    (root, members), = spans.requests(snap, "trainer.sample")
    steps = [s for s in members if s.name == "sampler.step"]
    assert [s.at for s in steps] == list(range(TINY["ddpm_sample_steps"]))
    assert [s.name for s in members].count("sample.copy") == 1
    assert snap["counters"] == {}  # the CPU's sample counts no syncs
    assert out.shape == (4, 784)


def test_fused_linear_opens_a_launch_span_on_its_kernel_route(monkeypatch):
    """The kernel's route (any device but the CPU's) opens
    ``linear.launch`` once a call, the activation outside the kernel's
    set included; the CPU route opens none."""
    seen = []

    def fake_kernel(x, w, b, act="none", slope=0.2, compute_dtype=None):
        seen.append((act, [s.name for s in spans._stack()]))
        return x @ w + b
    monkeypatch.setattr(linear, "linear_cuda", fake_kernel)
    spans.enable()
    x, w, b = (torch.ones(s, device="meta") for s in ((2, 3), (3, 4), 4))
    linear.fused_linear(x, w, b, act="relu")
    linear.fused_linear(x, w, b, act="silu")
    linear.fused_linear(torch.ones(2, 3), torch.ones(3, 4), torch.ones(4))
    assert seen == [("relu", ["linear.launch"]), ("none", ["linear.launch"])]
    assert spans.snapshot()["aggregates"]["linear.launch"]["count"] == 2


def _reader(name):
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "gpubench_cells_for_spans",
        os.path.join(ROOT, "gpubench", "harness", "cells.py"))
    cells = sys.modules.setdefault(spec.name,
                                   importlib.util.module_from_spec(spec))
    spec.loader.exec_module(cells)
    return cells.load_module(os.path.join(METRICS, name + ".py"))


def _readings(traffic, trace=True):
    return types.SimpleNamespace(trace=object() if trace else None,
                                 traffic=traffic, values={}, conf={})


def test_the_train_readers_read_the_chunk_spans(tiny_data, tmp_path):
    host = _reader("trainer_host_ms.train")
    waits = _reader("host_waits.train")
    r = _readings({"trace_chunks": 2})
    assert host.read(r) is None and waits.read(r) is None  # no spans yet
    t = _nsgan(tiny_data, tmp_path, fused_step=True)
    spans.enable()
    t.train(steps=48)  # three slices of two chunks
    spans.disable()
    ms = host.read(r)
    assert isinstance(ms, float) and ms > 0
    chunk_ms = [(c.end_ns - c.start_ns) / 1e6 for c, _ in spans.requests(
        spans.snapshot(), "trainer.chunk")]
    assert len(chunk_ms) == 6 and ms <= max(chunk_ms)
    assert waits.read(r) is None  # the CPU's chunks count no syncs
    spans.enable()
    spans.count("chunk.syncs", 0)
    assert waits.read(r) == 0.0
    spans.count("chunk.syncs", 51)
    assert waits.read(r) == 8.5  # over the six chunks
    assert host.read(_readings({"trace_chunks": 2}, trace=False)) is None
    assert waits.read(_readings({"trace_chunks": 2}, trace=False)) is None
    assert host.read(_readings({"trace_chunks": 7})) is None


def test_the_gen_readers_read_the_request_spans(monkeypatch, tmp_path):
    copy = _reader("copy_ms.gen")
    launch = _reader("linear_host_us.gen")
    r = _readings({"trace_requests": 2})
    assert copy.read(r) is None and launch.read(r) is None
    t = Trainer("ddpm", device="cpu", out_dir=str(tmp_path), **TINY)
    monkeypatch.setattr(linear, "linear_cuda",
                        lambda x, w, b, act="none", slope=0.2,
                        compute_dtype=None: x @ w + b)
    meta = [torch.ones(2, 3, device="meta"), torch.ones(3, 4, device="meta"),
            torch.ones(4, device="meta")]
    spans.enable()
    for _ in range(4):
        t.sample(4)
    assert copy.read(r) > 0 and launch.read(r) is None  # the CPU route
    for _ in range(2):
        with spans.span("trainer.sample"):
            for _ in range(8):
                linear.fused_linear(*meta)
    us = launch.read(r)
    assert isinstance(us, float) and us > 0
    assert copy.read(_readings({"trace_requests": 2}, trace=False)) is None
    assert np.isfinite(copy.read(r))
