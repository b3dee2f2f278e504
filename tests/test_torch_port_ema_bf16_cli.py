"""The port's CLI and Trainer with ``--ema-decay`` and ``--dtype
bfloat16`` against the JAX package's Trainer.

- ``cli.main([... "--device", "cpu", "--fused-step", "--ema-decay",
  "0.999", "--dtype", "bfloat16"])`` trains nsgan and vae through the
  chunk's plain version, writes the JAX CLI's records, and its checkpoint
  (EMA plane included) restores into the JAX Trainer of the same
  configuration, which trains on from it;
- the step function that command runs (the port Trainer's fused
  ``_many_steps``) and the JAX Trainer's own (the TPU chunk kernel in
  interpret mode), from the JAX Trainer's state, data, permutations and
  noise, with the float32 EMA plane at 0.999: the metrics, parameters
  and EMA leaves of three steps agree at rtol 2e-4 / atol 2e-5.
"""

import json

import jax
import numpy as np
import pytest
import torch

from generative_models_tpu.train.trainer import Trainer as JaxTrainer
from generative_models_tpu_torch import cli
from generative_models_tpu_torch.train.trainer import Trainer
from generative_models_tpu_torch.utils.tree import tree_leaves_with_path
from tests.test_torch_port_ema_bf16 import TOL

DIMS = {"nsgan": {"hidden_dim": 32, "z_dim": 8},
        "vae": {"vae_hidden_dim": 32, "latent_dim": 8}}
EMA_KEY = {"nsgan": ("g_ema", "g_params"), "vae": ("ema", "params")}


@pytest.mark.parametrize("variant", ["nsgan", "vae"])
def test_cli_with_ema_and_bf16_against_the_jax_trainer(tmp_path, capsys,
                                                       variant):
    """``--ema-decay 0.999 --dtype bfloat16 --fused-step`` trains through
    the chunk's plain version; the checkpoint holds the EMA plane in the
    reference's leaf paths, the JAX Trainer of the same configuration
    restores every leaf and trains on, and both report the same metric
    and evaluation keys."""
    dims = (["--hidden-dim", "32", "--z-dim", "8"] if variant == "nsgan"
            else ["--vae-hidden-dim", "32", "--latent-dim", "8"])
    flags = ["--variant", variant, "--device", "cpu", "--dataset",
             "synthetic", "--batch-size", "16", *dims, "--scan-steps", "3",
             "--echo-every", "0", "--fused-step", "--ema-decay", "0.999",
             "--dtype", "bfloat16", "--out-dir", str(tmp_path),
             "--ckpt", str(tmp_path / "ck")]
    assert cli.main(flags + ["--steps", "6"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-2])
    assert line["variant"] == variant and line["steps"] == 6
    with open(tmp_path / variant / "metrics.jsonl") as f:
        recs = [json.loads(l) for l in f]
    assert [r["step"] for r in recs] == list(range(6))
    kw = dict(batch_size=16, ema_decay=0.999, dtype="bfloat16",
              **({"hidden_dim": 32, "z_dim": 8} if variant == "nsgan"
                 else {"vae_hidden_dim": 32, "latent_dim": 8}))
    t = Trainer(variant, device="cpu", **kw)
    t.load_model(str(tmp_path / "ck"))
    ema_key = "g_ema" if variant == "nsgan" else "ema"
    ema = dict(tree_leaves_with_path(t.state[ema_key]))
    live = dict(tree_leaves_with_path(
        t.state["g_params" if variant == "nsgan" else "params"]))
    assert set(ema) == set(live)
    # 6 steps at d = 0.999 from ema = params: the EMA lags the params
    assert any(not torch.equal(ema[k], live[k]) for k in ema)
    jt = JaxTrainer(variant, **kw)
    ckpt = str(tmp_path / "ck")
    jt.load_model(ckpt if ckpt.endswith(".npz") else ckpt + ".npz")
    for path, mine in ema.items():
        np.testing.assert_array_equal(
            mine.numpy(), np.asarray(dict(tree_leaves_with_path(
                jax.tree.map(np.asarray, jt.state[ema_key])))[path]))
    jh = jt.train(steps=2)
    assert all(np.isfinite(np.asarray(v)).all() for v in jh.values())
    assert set(jh) == set(recs[0]) - {"step", "ts"}
    assert sorted(t.evaluate("test")) == sorted(jt.evaluate("test"))


def _jax_noise(variant, jt, steps):
    """The noise the JAX Trainer's fused step draws from its state's rng
    (``build_fused_many_steps``' chain), in the port's noise layout:
    nsgan (z_d [S, 1, B, z], z_g [S, B, z]), vae eps [S, B, latent]."""
    cfg, chain = jt.cfg, jt.state["rng"]
    b = cfg.batch_size
    if variant == "vae":
        eps = []
        for _ in range(steps):
            chain, key = jax.random.split(chain)
            eps.append(np.asarray(jax.random.normal(key, (b,
                                                          cfg.latent_dim))))
        return torch.from_numpy(np.stack(eps))
    zd, zg = [], []
    for _ in range(steps):
        chain, d_key, g_key = jax.random.split(chain, 3)
        zd.append(np.asarray(jax.random.normal(jax.random.split(d_key, 1)[0],
                                               (b, cfg.z_dim))))
        zg.append(np.asarray(jax.random.normal(g_key, (b, cfg.z_dim))))
    return (torch.from_numpy(np.stack(zd))[:, None],
            torch.from_numpy(np.stack(zg)))


@pytest.mark.parametrize("variant", ["nsgan", "vae"])
def test_fused_steps_with_ema_match_the_jax_trainer(tmp_path, variant):
    """Three steps of the port Trainer's fused step function (what the
    CLI's ``--fused-step --ema-decay 0.999`` runs) against the JAX
    Trainer's, from the JAX Trainer's state, batches and noise."""
    steps = 3
    kw = dict(batch_size=16, ema_decay=0.999, fused_step=True,
              scan_steps=steps, **DIMS[variant])
    jt = JaxTrainer(variant, **kw)
    ck = jt.save_model(str(tmp_path / "jax0"))
    t = Trainer(variant, device="cpu", **kw)
    t.load_model(ck)
    t._load_data()  # as train() does first; it builds _many_steps
    assert t._fused
    np.testing.assert_array_equal(t.x_train.numpy(), np.asarray(jt.x_train))
    win = (steps * jt.rows_per_step - 1) // jt.rows_per_epoch + 2
    perm = jt._perm_window_fn(win)(np.int32(0))
    rel = jt._rel_fn(steps)(np.int32(0))
    noise = _jax_noise(variant, jt, steps)
    js, jm = jt._many_steps(jt.state, jt.x_train, jt.y_train, perm, rel)
    s, m = t._many_steps(
        t.state, t.x_train, t.y_train,
        torch.from_numpy(np.array(perm)).long(),
        torch.from_numpy(np.array(rel)).long(),
        lambda k0, n: (noise[k0:k0 + n] if variant == "vae"
                       else tuple(a[k0:k0 + n] for a in noise)))
    assert set(m) == set(jm)
    for k in m:
        np.testing.assert_allclose(m[k].numpy(), np.asarray(jm[k]),
                                   err_msg=k, **TOL)
    for key in EMA_KEY[variant]:
        ref = dict(tree_leaves_with_path(jax.tree.map(np.asarray, js[key])))
        for path, mine in tree_leaves_with_path(s[key]):
            np.testing.assert_allclose(mine.numpy(), ref[path],
                                       err_msg=key + path, **TOL)
    ema, live = (dict(tree_leaves_with_path(s[k])) for k in EMA_KEY[variant])
    assert any(not torch.equal(ema[k], live[k]) for k in ema)
