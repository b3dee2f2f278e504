"""The port's sampler export (``utils/export.py``) and the CLI's
``--export-sampler`` and ``--score-samples``, on the CPU at tiny widths.

For nsgan, vae and cgan the artifact (a ``torch.export`` program) is
deterministic per seed (bitwise), another seed gives other images, and
it matches the port's sampler given the same Philox z
(``sampler_noise``) within 1e-6 (the same float32 ops on the CPU, which
the exported graph may regroup). A fresh process that imports torch and
nothing of either package loads the three artifacts and reproduces them
bit for bit. The CLI prints the reference's quality keys and exports
after the checkpoint; ``--sample-only --export-sampler`` exports from a
loaded checkpoint.
"""

import contextlib
import io
import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from generative_models_tpu_torch import cli
from generative_models_tpu_torch.train.trainer import Trainer
from generative_models_tpu_torch.utils import export

TINY = dict(batch_size=16, hidden_dim=32, z_dim=8, latent_dim=4,
            dataset="synthetic")
VARIANTS = ("nsgan", "vae", "cgan")
N = 12


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    out = {}
    d = tmp_path_factory.mktemp("samplers")
    for v in VARIANTS:
        t = Trainer(v, device="cpu", seed=5, **TINY)
        path = export.save_sampler(str(d / f"{v}.pt2"), t.spec, t.cfg,
                                   t.generator_params, N)
        out[v] = (t, path)
    return out


@pytest.mark.parametrize("variant", VARIANTS)
def test_artifact_is_deterministic_and_matches_the_sampler(artifacts,
                                                           variant):
    t, path = artifacts[variant]
    fn = export.load_sampler(path, device="cpu")
    a, b, c = fn(3), fn(3), fn(4)
    assert a.shape == (N, 784) and a.dtype == torch.float32
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert float(a.min()) >= 0.0 and float(a.max()) <= 1.0
    for seed in (3, 2 ** 40 + 7):
        z = export.sampler_noise(torch.tensor(seed), N,
                                 export.noise_width(t.spec, t.cfg))
        np.testing.assert_allclose(fn(seed).numpy(), t.sample(z=z),
                                   rtol=0, atol=1e-6)


def test_noise_is_the_kernels_philox():
    from generative_models_tpu_torch.ops.cuda_reparam import (
        philox_normal_plain,
    )
    z = export.sampler_noise(torch.tensor(5 + (9 << 32)), 7, 3)
    assert torch.equal(z, philox_normal_plain((5, 9), 0, (7, 3)))


def test_cgan_artifact_cycles_the_classes(artifacts):
    t, path = artifacts["cgan"]
    z = export.sampler_noise(torch.tensor(3), N, t.cfg.z_dim)
    from generative_models_tpu_torch.losses.cgan import sample_class
    out = export.load_sampler(path, device="cpu")(3)
    for i in (0, 1, 11):
        one = sample_class(t.generator_params, None, 1, i % t.cfg.num_classes,
                           t.cfg, z=z[i:i + 1])
        np.testing.assert_allclose(out[i].numpy(), one[0].numpy(), rtol=0,
                                   atol=1e-6)


def test_a_torch_only_process_loads_the_artifacts(artifacts, tmp_path):
    want = {v: export.load_sampler(p, device="cpu")(11).numpy()
            for v, (_, p) in artifacts.items()}
    code = (
        "import sys, numpy as np, torch\n"
        "out = {}\n"
        "for v, p in zip(sys.argv[1::2], sys.argv[2::2]):\n"
        "    ep = torch.export.load(p)\n"
        "    out[v] = ep.module()(torch.tensor(11)).numpy()\n"
        "bad = [m for m in sys.modules if m.startswith('generative_models')]\n"
        "assert not bad, bad\n"
        f"np.savez({str(tmp_path / 'got.npz')!r}, **out)\n")
    args = [a for v, (_, p) in artifacts.items() for a in (v, p)]
    r = subprocess.run([sys.executable, "-c", code, *args], cwd=str(tmp_path),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    got = np.load(tmp_path / "got.npz")
    for v in VARIANTS:
        np.testing.assert_array_equal(got[v], want[v])


def _cli(tmp_path, *extra):
    argv = ["--device", "cpu", "--dataset", "synthetic", "--batch-size",
            "16", "--hidden-dim", "32", "--z-dim", "8", "--echo-every", "0",
            "--sample-n", "16", "--out-dir", str(tmp_path / "runs"), *extra]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    return rc, buf.getvalue().splitlines()


def test_cli_scores_and_exports_after_the_checkpoint(tmp_path):
    ck, art = str(tmp_path / "ck"), str(tmp_path / "g.pt2")
    rc, out = _cli(tmp_path, "--variant", "nsgan", "--steps", "3", "--ckpt",
                   ck, "--score-samples", "--export-sampler", art)
    assert rc == 0
    score = json.loads(out[1])
    assert sorted(score) == sorted(["classifier_test_acc", "confidence",
                                    "class_entropy", "is_score", "fid"])
    assert all(np.isfinite(v) for v in score.values())
    assert out[2] == f"saved: {ck}.npz" and out[3] == f"exported: {art}"
    t = Trainer("nsgan", device="cpu", **dict(TINY, z_dim=8, sample_n=16))
    t.load_model(ck)
    z = export.sampler_noise(torch.tensor(1), 16, 8)
    np.testing.assert_allclose(
        export.load_sampler(art, device="cpu")(1).numpy(), t.sample(z=z),
        rtol=0, atol=1e-6)
    # --sample-only exports from the loaded checkpoint
    art2 = str(tmp_path / "g2.pt2")
    rc, out = _cli(tmp_path, "--variant", "nsgan", "--ckpt", ck,
                   "--sample-only", "--export-sampler", art2)
    line = json.loads(out[-1])
    assert rc == 0 and line["sampler"] == art2 and line["step"] == 3
    assert torch.equal(export.load_sampler(art2, device="cpu")(1),
                       export.load_sampler(art, device="cpu")(1))
