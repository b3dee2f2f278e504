"""The CLI's ``--debug-nans`` on the CPU at tiny widths: a finite run
passes and leaves autograd's anomaly mode as it was; a NaN planted in a
checkpoint's G weight raises ``FloatingPointError`` at the first step
after the resume, through the general step (anomaly mode stops the
backward; the error names the chunk's steps) and through the chunk's
plain version (``--fused-step``: the chunk's metrics name the step);
without the flag the same run ends with non-finite losses and rc 0."""

import contextlib
import io
import json
import shutil

import numpy as np
import pytest
import torch

from generative_models_tpu_torch import cli

BASE = ["--variant", "nsgan", "--device", "cpu", "--dataset", "synthetic",
        "--batch-size", "16", "--hidden-dim", "32", "--z-dim", "8",
        "--echo-every", "0", "--scan-steps", "2"]


def _cli(tmp_path, *extra):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(BASE + ["--out-dir", str(tmp_path / "runs"), *extra])
    return rc, buf.getvalue().splitlines()


@pytest.fixture(scope="module")
def nan_leaves(tmp_path_factory):
    d = tmp_path_factory.mktemp("nan")
    rc, _ = _cli(d, "--steps", "3", "--ckpt", str(d / "ck"))
    assert rc == 0
    leaves = dict(np.load(d / "ck.npz"))
    meta = json.loads(str(leaves["__meta__"]))
    i = next(i for i, m in enumerate(meta)
             if m["path"] == "['g_params'][0]['w']")
    leaves[f"leaf_{i:05d}"][0, 0] = np.nan
    np.savez(d / "nan.npz", **leaves)
    return str(d / "nan.npz")


@pytest.fixture
def nan_ckpt(nan_leaves, tmp_path):
    """A test's own copy (a run that ends saves over its --ckpt)."""
    shutil.copy(nan_leaves, tmp_path / "nan.npz")
    return str(tmp_path / "nan")


def test_a_finite_run_passes_and_restores_anomaly_mode(tmp_path):
    rc, out = _cli(tmp_path, "--steps", "4", "--debug-nans")
    assert rc == 0
    assert all(np.isfinite(v) for v in json.loads(out[-1])["eval"].values())
    assert not torch.is_anomaly_enabled()


@pytest.mark.parametrize("fused,match", [
    (False, r"in the backward of a step of steps 3-4"),
    (True, r"metric 'd_loss' is not finite at step 3")])
def test_a_planted_nan_raises_at_its_step(nan_ckpt, tmp_path, fused, match):
    with pytest.raises(FloatingPointError, match=match):
        _cli(tmp_path, "--steps", "4", "--ckpt", nan_ckpt,
             "--resume", "--debug-nans", *(["--fused-step"] if fused else []))
    assert not torch.is_anomaly_enabled()


def test_without_the_flag_the_nan_run_ends(nan_ckpt, tmp_path):
    rc, out = _cli(tmp_path, "--steps", "2", "--ckpt", nan_ckpt, "--resume",
                   "--fused-step")
    line = json.loads(next(l for l in out if l.startswith('{"variant"')))
    assert rc == 0 and not np.isfinite(line["eval"]["d_loss"])
