"""The directory checkpoint backend (``ckpt_backend="orbax"``,
``utils/dcp_ckpt.py``) and the backend dispatch of
``utils/checkpoint.py``: the ports of ``tests/test_resume_semantics.py``'s
checkpoint cases, which the JAX package runs on both of its backends.

- vae: 5 steps, save, load into a fresh Trainer, 5 more equal steps 5-9
  of an uninterrupted 10-step run (rtol 1e-6, the reference's);
- began: the whole state (its k_t and M, both optimizers, step and the
  uint32 rng words) round-trips bit for bit, dtypes included;
- a mismatched config is refused, naming a leaf, on both backends;
- the CLI: ``--ckpt-backend orbax --ckpt DIR`` then ``--resume`` prints
  ``resumed from DIR at step N`` and ends at the uninterrupted run's
  state, bit for bit.
"""

import json
import os

import numpy as np
import pytest

from conftest import TINY
from generative_models_tpu_torch import cli
from generative_models_tpu_torch.config import variant_config
from generative_models_tpu_torch.data.mnist import synthetic_mnist
from generative_models_tpu_torch.ops.spectral import init_sn_vectors
from generative_models_tpu_torch.parallel.runs import state_numpy
from generative_models_tpu_torch.train.trainer import Trainer
from generative_models_tpu_torch.utils import checkpoint as ckpt
from generative_models_tpu_torch.utils.tree import tree_leaves

KW = {k: TINY[k] for k in ("batch_size", "hidden_dim", "z_dim", "latent_dim",
                            "vae_hidden_dim", "began_ae_hidden", "scan_steps",
                            "sample_n", "seed")}
BACKENDS = ["npz", "orbax"]
TINY_FLAGS = ["--device", "cpu", "--dataset", "synthetic", "--batch-size",
              "16", "--hidden-dim", "32", "--z-dim", "8", "--echo-every",
              "0", "--sample-every", "1000000"]


@pytest.fixture(scope="module")
def data():
    return synthetic_mnist(n_train=256, n_test=64, seed=0)


def _trainer(variant, backend, data, **kw):
    return Trainer(config=variant_config(variant, **dict(
        KW, ckpt_backend=backend, **kw)), device="cpu", data=data)


@pytest.mark.parametrize("backend", BACKENDS)
def test_checkpoint_resume_continues_trajectory(data, tmp_path, backend):
    h1 = _trainer("vae", backend, data).train(steps=10)
    t2 = _trainer("vae", backend, data)
    t2.train(steps=5)
    ck = str(tmp_path / "ck")
    saved = t2.save_model(ck)
    assert ckpt.exists(ck, backend)
    assert os.path.isdir(saved) == (backend == "orbax")
    t3 = _trainer("vae", backend, data)
    t3.load_model(ck)
    assert t3.state["step"] == 5
    h3 = t3.train(steps=5)
    np.testing.assert_allclose(h1["loss"][5:], h3["loss"], rtol=1e-6)


@pytest.mark.parametrize("backend", BACKENDS)
def test_checkpoint_roundtrip_adversarial_state(data, tmp_path, backend):
    """began's whole state, bit for bit and dtype for dtype: the rng
    words stay uint32 and the step an int (DCP keeps them as int64)."""
    t = _trainer("began", backend, data)
    t.train(steps=6)
    ck = str(tmp_path / "ck2")
    t.save_model(ck)
    t2 = _trainer("began", backend, data)
    t2.load_model(ck)
    assert t2.state["rng"].dtype == np.uint32
    assert isinstance(t2.state["step"], int) and t2.state["step"] == 6
    a, b = state_numpy(t.state), state_numpy(t2.state)
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("backend", BACKENDS)
def test_restore_rejects_another_config(data, tmp_path, backend):
    """``restore`` is the Trainer's loader on both backends. Another width
    is refused with the leaf named (DCP would cast silently). A state
    with the spectral projection's sn_v: the directory must hold them,
    an npz of either package may lack them, and ``load_model`` then
    burns them in afresh at the loaded critic."""
    t = _trainer("nsgan", backend, data)
    ck = str(tmp_path / "ck3")
    t.save_model(ck)
    wide = _trainer("nsgan", backend, data, hidden_dim=48)
    with pytest.raises(ValueError, match="d_opt|d_params|g_opt|g_params"):
        ckpt.restore(ck, wide.state, wide.cfg)
    sn = _trainer("nsgan", backend, data, spectral_projection=True)
    if backend == "orbax":
        with pytest.raises(ValueError, match="sn_v|mismatch"):
            ckpt.restore(ck, sn.state, sn.cfg)
        return
    assert "sn_v" not in ckpt.restore(ck, sn.state, sn.cfg)
    sn.load_model(ck)
    want = init_sn_vectors(sn.state["d_params"], sn.cfg.sn_iters)
    for a, b in zip(tree_leaves(sn.state["sn_v"]), tree_leaves(want)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_restore_of_both_backends_is_the_same_state(data, tmp_path):
    """``restore`` gives one state from either backend's files, in the
    template's structure (the npz through the Trainer's own
    ``load_jax_checkpoint``), the spectral projection's sn_v included."""
    t = _trainer("nsgan", "npz", data, spectral_projection=True)
    t.train(steps=3)
    a = ckpt.restore(ckpt.save(str(tmp_path / "a"), t.state, "npz"),
                     t.state, t.cfg)
    b = ckpt.restore(ckpt.save(str(tmp_path / "b"), t.state, "orbax"),
                     t.state, t.cfg.replace(ckpt_backend="orbax"))
    la, lb = dict(ckpt.state_leaves(a)), dict(ckpt.state_leaves(b))
    assert set(la) == set(lb) == set(dict(ckpt.state_leaves(t.state)))
    for k in la:
        np.testing.assert_array_equal(np.asarray(la[k]), np.asarray(lb[k]))
    assert a["step"] == b["step"] == 3
    assert b["rng"].dtype == np.uint32


def test_unknown_backend_is_refused(tmp_path):
    with pytest.raises(ValueError, match="unknown ckpt backend"):
        ckpt.save(str(tmp_path / "x"), {}, "tar")
    assert not ckpt.exists(str(tmp_path / "nothing"), "orbax")


def test_cli_dir_backend_resumes_bit_for_bit(tmp_path, capsys):
    """4 steps saved to a directory, then --resume 4 more: the resumed
    line names the step, and the end state is the 8-step run's."""
    ck = str(tmp_path / "ckdir")
    flags = TINY_FLAGS + ["--variant", "nsgan", "--ckpt-backend", "orbax"]
    assert cli.main(flags + ["--steps", "4", "--ckpt", ck, "--out-dir",
                             str(tmp_path / "a")]) == 0
    assert os.path.isdir(ck)
    assert cli.main(flags + ["--steps", "4", "--ckpt", ck, "--resume",
                             "--out-dir", str(tmp_path / "a")]) == 0
    whole = str(tmp_path / "whole")
    assert cli.main(flags + ["--steps", "8", "--ckpt", whole, "--out-dir",
                             str(tmp_path / "b")]) == 0
    out = capsys.readouterr().out.splitlines()
    assert f"resumed from {ck} at step 4" in out
    assert json.loads(out[-2])["steps"] == 8
    cfg = variant_config("nsgan", **dict(KW, ckpt_backend="orbax"))
    a = ckpt.restore(ck, Trainer(config=cfg, device="cpu").state, cfg)
    b = ckpt.restore(whole, Trainer(config=cfg, device="cpu").state, cfg)
    assert a["step"] == b["step"] == 8
    la, lb = dict(ckpt.state_leaves(a)), dict(ckpt.state_leaves(b))
    for k in la:
        np.testing.assert_array_equal(np.asarray(la[k]), np.asarray(lb[k]),
                                      err_msg=k)
