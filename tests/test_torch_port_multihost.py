"""``--multihost`` in the port (``parallel/multihost.py``): two OS
processes, each started with ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` and
``MASTER_PORT``, join one gloo group through the CLI with ``--device
cpu`` and train nsgan at TINY widths: ``--dp 2``, and ``--dp 1 --tp 2``
(both grids at once, on two ports). As ``tests/test_multihost.py`` holds
the reference: both processes of a run exit 0, print the same final
``eval`` and write equal ``metrics.jsonl`` streams (each under its own
``--out-dir``); and the tp run's losses follow the dp run's (the same
model, the collectives differ) by the reference's tolerance.
"""

import json
import os
import socket
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = ("import sys; from generative_models_tpu_torch.cli import main; "
          "sys.exit(main(sys.argv[1:]))")
FLAGS = ["--variant", "nsgan", "--multihost", "--device", "cpu",
         "--dataset", "synthetic", "--steps", "8", "--batch-size", "16",
         "--hidden-dim", "32", "--z-dim", "8", "--scan-steps", "4",
         "--sample-every", "-1", "--seed", "0", "--echo-every", "0"]
GRIDS = {"dp2": ["--dp", "2"], "tp2": ["--dp", "1", "--tp", "2"]}


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{grid: [(returncode, output, out_dir) of rank 0, of rank 1]}."""
    tmp = tmp_path_factory.mktemp("multihost")
    procs = {}
    for name, grid in GRIDS.items():
        port = _free_port()
        for rank in range(2):
            env = dict(os.environ, RANK=str(rank), WORLD_SIZE="2",
                       MASTER_ADDR="localhost", MASTER_PORT=str(port),
                       OMP_NUM_THREADS="1")
            out_dir = tmp / f"{name}_p{rank}"
            procs.setdefault(name, []).append((subprocess.Popen(
                [sys.executable, "-c", WORKER, *FLAGS, *grid,
                 "--out-dir", str(out_dir)], cwd=REPO, env=env,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT), out_dir))
    out = {}
    try:
        for name, ps in procs.items():
            out[name] = [(p.wait(timeout=300),
                          p.stdout.read().decode(errors="replace"), d)
                         for p, d in ps]
    finally:
        for ps in procs.values():
            for p, _ in ps:
                if p.poll() is None:
                    p.kill()
    return out


def _final(text):
    lines = [l for l in text.splitlines()
             if l.startswith("{") and "steps_per_sec" in l]
    assert lines, text[-3000:]
    return json.loads(lines[-1])


def _stream(out_dir):
    with open(out_dir / "nsgan" / "metrics.jsonl") as f:
        return [json.loads(l) for l in f]


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_two_processes_agree(runs, grid):
    (rc0, out0, d0), (rc1, out1, d1) = runs[grid]
    assert rc0 == 0, out0[-4000:]
    assert rc1 == 0, out1[-4000:]
    f0, f1 = _final(out0), _final(out1)
    assert f0["steps"] == f1["steps"] == 8
    assert f0["eval"] == f1["eval"]
    s0, s1 = _stream(d0), _stream(d1)
    assert [r["step"] for r in s0] == list(range(8))
    drop = lambda rows: [{k: v for k, v in r.items() if k != "ts"}
                         for r in rows]  # the wall clock's stamp
    assert drop(s0) == drop(s1)


def test_tp_run_follows_the_dp_run(runs):
    dp = _stream(runs["dp2"][0][2])
    tp = _stream(runs["tp2"][0][2])
    for a, b in zip(tp, dp):
        for k in ("d_loss", "g_loss"):
            assert abs(a[k] - b[k]) <= 2e-4 * max(1.0, abs(b[k])), (k, a, b)


def test_grid_must_fill_the_world(monkeypatch, capsys):
    from generative_models_tpu_torch import cli
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(SystemExit) as e:
        cli.main(["--variant", "nsgan", "--multihost", "--device", "cpu",
                  "--dp", "1"])
    assert e.value.code == 2
    assert ("the grid --dp 1 x --tp 1 has 1 ranks but WORLD_SIZE is 2"
            in capsys.readouterr().err)


def test_local_rank_past_the_cards_raises(monkeypatch):
    from generative_models_tpu_torch.parallel import multihost
    import torch
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("LOCAL_RANK", str(have))
    with pytest.raises(RuntimeError, match=f"needs cuda:{have} but {have}"):
        multihost.init_multihost(1, 1, "cuda")
