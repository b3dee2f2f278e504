"""Tensor parallelism in the port (``parallel/tp.py``) without a spawn of
ranks (but the CLI's): the sharding rule, the layouts, the refusals, and
``--tp`` through the CLI, at the TINY widths of ``tests/conftest.py``
(the training against the single device and the JAX package:
``tests/test_torch_port_tp.py``).

- The rule: for every variant's state (the EMA included) the port gives
  each leaf the role the JAX package's ``state_pspecs`` gives it
  (``P(None, "model")`` and ``P("model")`` col, ``P("model", None)`` row,
  anything else replicated), at tp 2 and 4; a prior whose width does not
  divide replicates its blocks; qkv's shard holds whole heads.
- The refusals: a grid against ``cfg.tp`` both ways, a pipe grid, the
  chunk kernels, the spectral projection, conv; and the CLI's ``--tp``.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from generative_models_tpu_torch import cli
from generative_models_tpu_torch.config import VARIANTS, variant_config
from generative_models_tpu_torch.losses.registry import get_variant
from generative_models_tpu_torch.parallel import mesh, tp
from generative_models_tpu_torch.parallel.runs import init_state
from generative_models_tpu_torch.train.trainer import Trainer
from generative_models_tpu_torch.utils.checkpoint import state_leaves
from tests.conftest import TINY

KW = {k: TINY[k] for k in ("batch_size", "hidden_dim", "z_dim", "latent_dim",
                            "vae_hidden_dim", "began_ae_hidden", "seed",
                            "ddpm_timesteps", "ddpm_time_dim")}
# tests/test_tp.py's VQ sizes
TINY_VQ = dict(vq_prior_width=32, vq_prior_layers=1, vq_tokens=4,
               vq_codebook_size=16, vq_code_dim=4)
VQ_KW = {"vqprior": TINY_VQ,
         "vqvae": {k: v for k, v in TINY_VQ.items()
                   if not k.startswith("vq_prior")}}
TP_VARIANTS = tuple(sorted(VARIANTS))


def _kw(variant):
    return dict(KW, **VQ_KW.get(variant, {}))


def _jax_role(p):
    return {(None, "model"): "col", ("model", None): "row",
            ("model",): "col"}.get(tuple(p))


@pytest.mark.parametrize("tp_size", [2, 4])
@pytest.mark.parametrize("variant", TP_VARIANTS)
def test_rule_equals_jax_state_pspecs(variant, tp_size):
    from generative_models_tpu.config import variant_config as jax_config
    from generative_models_tpu.losses.registry import get_variant as jspec_of
    from generative_models_tpu.parallel.tp import state_pspecs
    from generative_models_tpu.train import step as jstep
    kw = dict(_kw(variant), tp=tp_size, ema_decay=0.9)
    jcfg, cfg = jax_config(variant, **kw), variant_config(variant, **kw)
    jst = jstep.init_state(jspec_of(variant), jcfg, jax.random.PRNGKey(0))
    flat, _ = jax.tree_util.tree_flatten_with_path(
        state_pspecs(jspec_of(variant), jcfg, jst),
        is_leaf=lambda x: isinstance(x, P))
    want = {jax.tree_util.keystr(k): _jax_role(p) for k, p in flat}
    roles = tp.state_roles(get_variant(variant), cfg, init_state(cfg, "cpu"))
    got = {k: tp.public_role(r) for k, r in state_leaves(roles)}
    assert got == want
    assert any(got.values())  # something is sharded


def test_prior_width_indivisible_replicates():
    """tests/test_tp.py's case: width 30 at tp 4 replicates the block."""
    cfg = variant_config("vqprior", vq_prior_width=30, vq_prior_heads=2,
                         vq_prior_layers=1, vq_tokens=4, vq_codebook_size=16,
                         vq_code_dim=4)
    st = init_state(cfg, "cpu")
    blk = tp.params_roles(st["params"], 4, 2)["prior"]["blocks"][0]
    assert blk["qkv"]["w"] is None and blk["fc2"]["w"] is None


@pytest.mark.parametrize("heads,role", [(4, "col_heads"), (2, "col_heads"),
                                        (1, "col_gather")])
def test_qkv_shards_hold_whole_heads(heads, role):
    """At tp 2, qkv's shard holds q, k and v of the rank's heads when the
    heads divide (else it is contiguous and gathered), and the shards
    gather back to the reference's column order."""
    cfg = variant_config("vqprior", **dict(TINY_VQ, vq_prior_heads=heads,
                                           tp=2))
    st = init_state(cfg, "cpu")
    roles = tp.params_roles(st["params"], 2, heads)
    assert roles["prior"]["blocks"][0]["qkv"]["w"] == role
    w = st["params"]["prior"]["blocks"][0]["qkv"]["w"]
    shards = [tp._take(w, role, mesh.DataGroup(2, r, w.device, "gloo", None))
              for r in range(2)]
    width = w.shape[0]
    if role == "col_heads":
        k = width // 2
        for r, s in enumerate(shards):
            for j in range(3):  # q, k, v of heads r*H/2 ..
                assert torch.equal(s[:, j * k:(j + 1) * k],
                                   w[:, j * width + r * k:
                                     j * width + (r + 1) * k])
    idx = torch.cat([tp._index(role, 3 * width, 2, r) for r in range(2)])
    whole = torch.empty_like(w).index_copy_(1, idx, torch.cat(shards, 1))
    assert torch.equal(whole, w)


def _fake_grid(n, axis="model", dp=1):
    dev = torch.device("cpu")
    return mesh.Grid(dp=dp, n=n, axis=axis, rank=0,
                     data=mesh.DataGroup(dp, 0, dev, "gloo", None),
                     second=mesh.DataGroup(n, 0, dev, "gloo", None), pg=None)


@pytest.mark.parametrize("kw,grid,match", [
    ({"tp": 2}, None, "axis size 1"),
    ({"tp": 1}, (2, "model"), "axis size 2"),
    ({"tp": 4}, (2, "model"), "axis size 2"),
    ({"tp": 1}, (2, "pipe"), "build_pp_prior_step"),
    ({"tp": 2, "fused_step": True}, (2, "model"), "assume whole parameters"),
])
def test_tp_refusals(kw, grid, match):
    cfg = variant_config("nsgan", **dict(KW, **kw))
    group = (mesh.DataGroup(1, 0, torch.device("cpu"), "gloo", None)
             if grid is None else _fake_grid(*grid))
    with pytest.raises(ValueError, match=match):
        Trainer(config=cfg, group=group)


@pytest.mark.parametrize("mode", ["amortized", "fresh"])
def test_tp_takes_the_spectral_projection(mode):
    """The spectral projection runs under tp (parallel/tp.py::
    on_whole_weights): nothing refuses it, and each rank holds the whole
    carried vectors (amortized) beside its slices of the critic."""
    from generative_models_tpu_torch.parallel import tp
    cfg = variant_config("nsgan", **dict(KW, tp=2, spectral_projection=True,
                                         sn_mode=mode))
    assert tp.unsupported(get_variant("nsgan"), cfg) is None
    t = Trainer(config=cfg, group=_fake_grid(2, "model"))
    w0 = t.state["d_params"][0]["w"]
    assert w0.shape == (cfg.image_dim, cfg.hidden_dim // 2)
    if mode == "amortized":
        assert t.state["sn_v"][0]["w"].shape == (cfg.hidden_dim,)
    else:
        assert "sn_v" not in t.state


def test_tp_with_conv_is_refused_by_the_config():
    with pytest.raises(ValueError, match="conv stacks have no sharding"):
        variant_config("nsgan", arch="conv", tp=2)


def test_cli_tp_with_fused_step_is_a_usage_error(capsys):
    with pytest.raises(SystemExit) as e:
        cli.main(["--variant", "nsgan", "--tp", "2", "--fused-step",
                  "--device", "cpu"])
    assert e.value.code == 2
    assert "--fused-step with --tp > 1" in capsys.readouterr().err


def test_cli_tp_on_cuda_needs_a_card_a_rank(capsys):
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    n = have + 2
    with pytest.raises(SystemExit) as e:
        cli.main(["--variant", "nsgan", "--dp", "2", "--tp", str(n)])
    assert e.value.code == 2
    assert (f"--dp 2 --tp {n} needs {2 * n} CUDA devices, one a rank, but "
            f"only {have}" in capsys.readouterr().err)


def test_cli_vqprior_tp2_trains_on_the_cpu(tmp_path, capsys):
    flags = ["--variant", "vqprior", "--tp", "2", "--device", "cpu",
             "--dataset", "synthetic", "--batch-size", "16",
             "--vae-hidden-dim", "32", "--vq-tokens", "4", "--vq-code-dim",
             "4", "--vq-codebook-size", "16", "--vq-prior-width", "32",
             "--vq-prior-heads", "2", "--vq-prior-layers", "1",
             "--scan-steps", "3", "--steps", "6", "--echo-every", "0",
             "--out-dir", str(tmp_path), "--ckpt", str(tmp_path / "ck.npz")]
    assert cli.main(flags) == 0
    out = capsys.readouterr().out.strip().splitlines()
    line = json.loads(next(l for l in out if l.startswith("{")))
    assert line["variant"] == "vqprior" and line["steps"] == 6
    assert all(np.isfinite(v) for v in line["eval"].values())
    assert out[-1] == f"saved: {tmp_path / 'ck.npz'}"
    assert os.path.exists(tmp_path / "vqprior" / "final.png")


def test_cli_tp2_profile_and_dir_checkpoint_on_the_cpu(tmp_path, capsys):
    """--profile under two ranks sharing a run directory writes one trace
    a rank; --ckpt-backend orbax saves the whole state from rank 0 with no
    collective (DCP's no_dist; a fresh grid loads it in
    test_torch_port_tp.py's spawn, and the CLI resumes from a directory in
    test_torch_port_ckpt_dir.py)."""
    ck = str(tmp_path / "ck_dir")
    flags = ["--variant", "nsgan", "--tp", "2", "--device", "cpu",
             "--dataset", "synthetic", "--batch-size", "16", "--hidden-dim",
             "32", "--z-dim", "8", "--scan-steps", "2", "--steps", "2",
             "--echo-every", "0", "--out-dir", str(tmp_path),
             "--ckpt-backend", "orbax", "--ckpt", ck]
    assert cli.main(flags + ["--profile"]) == 0
    for r in range(2):
        trace = tmp_path / "nsgan" / "trace" / f"rank{r}.pt.trace.json"
        with open(trace) as f:
            assert json.load(f)["traceEvents"]
    out = capsys.readouterr().out.splitlines()
    assert out[-1] == f"saved: {os.path.abspath(ck)}"
    assert os.path.isfile(os.path.join(ck, ".metadata"))
