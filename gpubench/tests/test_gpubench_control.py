"""Whole runs of each cell at a small size on the CPU, the look for a card
skipped: a sound run comes out correct, and the control and every fault
planted underneath the timed path come out not correct. Also the result
line's keys, and the refusal to run without a card.

The limits are the cells' own (``limits/<cell>.json``), set from the
card's readings at the cells' sizes; the small sizes here read below the
program's and above the control's and the faults' readings there."""

import json
import os
import subprocess
import sys
import time

import pytest

from harness import cells, faults, runner, trace

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
SEED = 2 ** 31 + 77
TRAIN = "nsgan-mlp.train-b100"
GEN = "ddpm-mlp.gen-n10000-s50"
SMALL = {
    # the chunk kernel's plain version on the CPU (fused_step "auto" takes
    # the general step there)
    TRAIN: dict(z_dim=8, hidden_dim=32, batch_size=16, scan_steps=20,
                fused_step=True, train_rows=640, test_rows=64),
    GEN: dict(hidden_dim=32, ddpm_time_dim=16, n=32),
}
KEYS = {"correct", "attempted", "failed", "metrics", "device"}


def run(name, overrides=None, prepare=None, traced=False, seed=SEED):
    cell = cells.resolve(name, ROOT)
    return runner.run_cell(cell, seed, 0.3, traced, "cpu",
                           time.perf_counter(),
                           {**SMALL[name], **(overrides or {})}, prepare)


@pytest.mark.parametrize("name", [TRAIN, GEN])
def test_a_sound_run_is_correct(name):
    out = run(name)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert list(out)[-1] == "checks" and set(out) == KEYS | {"checks"}
    cell = cells.resolve(name, ROOT)
    assert set(out["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert all(m["value"] > 0 for m in out["metrics"].values())
    assert set(out["checks"]) == set(cell.limits)


@pytest.mark.parametrize("name", [TRAIN, GEN])
def test_the_control_is_not_correct(name):
    over, prepare = faults.control(cells.resolve(name, ROOT))
    out = run(name, over, prepare)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("name,fault", [
    (n, f) for n, d in ((TRAIN, "train"), (GEN, "generate"))
    for f in faults.FAULTS[d]])
def test_a_planted_fault_is_not_correct(name, fault):
    driver = "train" if name == TRAIN else "generate"
    with faults.FAULTS[driver][fault]():
        out = run(name)
    assert not out["correct"], out["checks"]


def test_a_traced_line_adds_the_breakdown_and_the_device_times(monkeypatch):
    fake = trace.Summary(window_s=0.5, busy_s=0.4,
                         kernels={"gan_chunk_kernel": [3, 0.39],
                                  "Memset (Device)": [3, 0.01]},
                         idle_gaps=[("train/cudaStreamSynchronize", 0.1)],
                         launched={"gan_chunk": 3}, complete=True)
    cell = cells.resolve(TRAIN, ROOT)
    monkeypatch.setattr(cell.driver.Session, "trace", lambda self: fake)
    out = runner.run_cell(cell, SEED, 0.3, True, "cpu", time.perf_counter(),
                          SMALL[TRAIN])
    assert set(out) == KEYS | {"breakdown", "checks"}
    assert list(out)[-1] == "checks"
    assert out["device"]["busy_s"] == 0.4 and out["device"]["window_s"] == 0.5
    assert out["breakdown"]["device_ops"][0] == ("gan_chunk_kernel", 0.39)
    assert set(out["metrics"]) == {m["name"] for m in cell.per_layer}
    idle = out["metrics"]["device_idle.train"]["value"]
    assert idle == pytest.approx(20.0)
    roof = out["metrics"]["chunk_roofline.train"]["value"]
    bound = cell.reference.chunk_bound_s(
        {**cell.config["trainer"], **SMALL[TRAIN]}, 16, 20)
    assert roof == pytest.approx(100 * 3 * bound / 0.39)


def test_lost_events_leave_the_kernel_metrics_silent():
    s = trace.Summary(window_s=1.0, busy_s=0.5,
                      kernels={"mlp_fwd_kernel": [799, 0.4]}, idle_gaps=[],
                      launched={"mlp_fwd": 800}, complete=False)
    cell = cells.resolve(GEN, ROOT)
    r = runner.Readings(cell, dict(cell.config["trainer"]), cell.traffic,
                        {"gen_images_per_s": 1.0}, s)
    assert cell.readers["mlp_fwd_roofline.gen"].read(r) is None
    assert cell.readers["device_idle.gen"].read(r) is None


class _Event:
    def __init__(self, name, t0, t1, cuda):
        from torch.autograd import DeviceType
        self.name = name
        self.device_type = DeviceType.CUDA if cuda else DeviceType.CPU
        self.time_range = type("R", (), {"start": t0, "end": t1})


class _Profile:
    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


def test_the_device_slice_and_the_labelled_slice_read_apart():
    """The metrics' slice holds the device's operations alone (a span's
    mirror on the device does no work); the labelled slice puts each idle
    gap on the span and host operation in flight at its middle."""
    dev = [_Event("void gan_chunk_kernel<true>(Args)", 0, 400, True),
           _Event("gan_chunk_kernel", 350, 500, True),
           _Event("Memset (Device)", 700, 800, True),
           _Event(trace.SPAN_PREFIX + "train", 0, 1000, True)]
    s = trace.summarize(_Profile(dev), 1e-3, {"gan_chunk": 2},
                        {"gan_chunk_kernel": "gan_chunk"})
    assert s.complete and s.window_s == 1e-3
    assert s.busy_s == pytest.approx(600e-6)
    assert s.kernels == {"gan_chunk_kernel": [2, pytest.approx(550e-6)],
                         "Memset": [1, pytest.approx(100e-6)]}
    lost = trace.summarize(_Profile(dev), 1e-3, {"gan_chunk": 3},
                           {"gan_chunk_kernel": "gan_chunk"})
    assert not lost.complete
    host = [_Event(trace.SPAN_PREFIX + "train", -50, 1000, False),
            _Event(trace.SPAN_PREFIX + "request", 500, 700, False),
            _Event("aten::copy_", 550, 690, False)]
    gaps = dict(trace.idle_gaps(_Profile(dev + host), "train"))
    assert gaps == {"train/python": pytest.approx(250e-6),
                    "request/aten::copy_": pytest.approx(200e-6)}


def test_the_printed_line_is_last_and_strict_json(capsys):
    out = run(GEN)
    out["checks"]["image_gap"]["value"] = float("inf")
    runner.print_result(out)
    std = capsys.readouterr()
    line = json.loads(std.out.strip().splitlines()[-1])
    assert line["checks"]["image_gap"]["value"] == "inf"
    assert std.err.strip().splitlines()[-1].startswith("check image_gap")


def test_no_card_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    r = subprocess.run([sys.executable, "gpubench/run.py", "--workload", GEN,
                        "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
                       cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and r.stdout.strip() == ""


@pytest.mark.card
@pytest.mark.parametrize("name", [TRAIN, GEN])
def test_on_the_card_the_control_fails_at_the_cells_size(cuda_card, name):
    """The control at the cell's own size on three seeds (the readings of
    ``control.py``), and one sound run."""
    cell = cells.resolve(name, ROOT)
    over, prepare = faults.control(cell)
    for seed in (SEED, SEED + 1, SEED + 2):
        out = runner.run_cell(cell, seed, 2.0, False, "cuda",
                              time.perf_counter(), over, prepare)
        assert not out["correct"], out["checks"]
    out = runner.run_cell(cell, SEED + 3, 2.0, False, "cuda",
                          time.perf_counter())
    assert out["correct"], out["checks"]
