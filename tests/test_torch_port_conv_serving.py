"""The conv stacks through the port's checkpoints, serving, export, DP
step, Trainer and the repairs they needed, on the CPU at tiny widths.

- Checkpoints: a conv state's leaves take the reference's npz paths and
  HWIO shapes (``['g_params']['up1']['w']`` [4, 4, 2C, C],
  ``['g_params']['gn0']['scale']``, lsgan's ``['sn_v']...``); a JAX
  Trainer's conv checkpoint loads into the port (its G then maps the
  same z to the JAX G's images within 2e-5) and the port's loads back
  into the JAX Trainer leaf for leaf; ``--sample-only`` serves it.
- Export: the conv samplers (nsgan, cgan, vae) export, reload with
  ``load_sampler(device="cpu")`` and match ``Trainer.sample`` given the
  same Philox z within 1e-6; ``load_sampler`` without a card raises
  unless the CPU is asked for.
- Trainer: ``fused_step=True`` with conv raises with the chunk kernels'
  reason, "auto" takes the general step; the EMA is a conv tree; a run
  split in two at a checkpoint equals the uninterrupted run.
- The general step's MLP calls, routed through ``MLPFunction`` on the
  CPU as on the card: a conv nsgan step 5 forwards and 4 backwards,
  wgangp 17 and 12 (the penalty's critic pass the plain one), vae 4 and
  4; each is one ``linear_cuda``-shaped dense layer.
- The losses find their device through ``utils/tree.py::tree_device``
  (conv trees are dicts).
- DP: nsgan and vae on the conv stacks (12 channels) at world 2 (gloo
  ranks) equal the single-device run (GroupNorm is per sample), rtol
  2e-4 / atol 2e-5.
"""

import contextlib
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generative_models_tpu.models import nets as jnets
from generative_models_tpu.train.trainer import Trainer as JaxTrainer
from generative_models_tpu_torch import cli
from generative_models_tpu_torch.config import variant_config
from generative_models_tpu_torch.data.mnist import synthetic_mnist
from generative_models_tpu_torch.losses import infogan, minimax
from generative_models_tpu_torch.losses.registry import get_variant
from generative_models_tpu_torch.models import conv, nets
from generative_models_tpu_torch.ops import cuda_mlp, penalty
from generative_models_tpu_torch.parallel import mesh
from generative_models_tpu_torch.parallel.runs import (
    init_state,
    many_steps_rank,
    state_numpy,
)
from generative_models_tpu_torch.train import step as step_lib
from generative_models_tpu_torch.train.trainer import Trainer
from generative_models_tpu_torch.utils import export
from generative_models_tpu_torch.utils.checkpoint import (
    param_template,
    read_leaves,
    state_leaves,
)
from generative_models_tpu_torch.utils.tree import (
    tree_device,
    tree_leaves,
    tree_leaves_with_path,
)
from tests.conftest import TINY, tiny_cfg

TOL = dict(rtol=2e-4, atol=2e-5)
CONV_TINY = dict(arch="conv", conv_channels=4, latent_dim=4)
KW = dict(TINY, **CONV_TINY)


def _cfg(variant, **kw):
    return variant_config(variant, **dict(KW, **kw))


def test_conv_state_leaves_take_the_reference_paths():
    tmpl = param_template(_cfg("nsgan", ema_decay=0.9))
    shapes = {p: tuple(t.shape) for k in sorted(tmpl)
              for p, t in tree_leaves_with_path(tmpl[k], f"['{k}']")}
    assert shapes["['g_params']['up1']['w']"] == (4, 4, 8, 4)
    assert shapes["['g_params']['up2']['w']"] == (4, 4, 4, 1)
    assert shapes["['g_params']['gn0']['scale']"] == (8,)
    assert shapes["['g_params']['fc']['w']"] == (8, 7 * 7 * 8)
    assert shapes["['d_params']['trunk']['c1']['w']"] == (4, 4, 1, 4)
    assert shapes["['d_params']['fc']['w']"] == (7 * 7 * 8, 1)
    assert shapes["['g_ema']['gn1']['bias']"] == (4,)
    assert all(t.device.type == "meta" for k in tmpl
               for t in tree_leaves(tmpl[k]))
    cfg = _cfg("lsgan")
    assert cfg.spectral_projection and cfg.sn_target == 1.0
    st = init_state(cfg, "cpu")
    sn = dict(state_leaves(st))
    assert tuple(sn["['sn_v']['trunk']['c2']['w']"].shape) == (8,)
    assert tuple(sn["['sn_v']['trunk']['c2']['b']"].shape) == (0,)
    assert tuple(sn["['sn_v']['fc']['w']"].shape) == (1,)


def test_jax_conv_checkpoint_loads_serves_and_goes_back(tmp_path,
                                                        tiny_data):
    jcfg = tiny_cfg("nsgan", **CONV_TINY, out_dir=str(tmp_path))
    jt = JaxTrainer(config=jcfg, data=tiny_data)
    jpath = jt.save_model(str(tmp_path / "jax_conv"))
    t = Trainer("nsgan", device="cpu", **KW)
    t.load_model(jpath)
    z = np.random.default_rng(0).standard_normal((5, jcfg.z_dim)).astype(
        np.float32)
    want = np.asarray(jnets.generator_apply(jt.state["g_params"],
                                            jnp.asarray(z), jcfg))
    np.testing.assert_allclose(t.sample(z=z), want, rtol=2e-5, atol=2e-5)
    # the port's checkpoint loads into the JAX Trainer, leaf for leaf
    path = t.save_model(str(tmp_path / "port_conv"))
    jt2 = JaxTrainer(config=jcfg.replace(seed=9), data=tiny_data)
    jt2.load_model(path)
    for side in ("g_params", "d_params"):
        for a, b in zip(jax.tree_util.tree_leaves(jt2.state[side]),
                        jax.tree_util.tree_leaves(jt.state[side])):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert "['g_params']['gn0']['scale']" in read_leaves(path)
    # --sample-only serves the JAX checkpoint
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["--variant", "nsgan", "--arch", "conv", "--device",
                       "cpu", "--conv-channels", "4", "--z-dim",
                       str(jcfg.z_dim), "--ckpt", jpath, "--sample-only",
                       "--out-dir", str(tmp_path)])
    line = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert rc == 0 and line["step"] == 0 and line["samples"].endswith(".png")


@pytest.mark.parametrize("variant", ["nsgan", "cgan", "vae"])
def test_conv_sampler_exports_and_reloads(tmp_path, variant):
    t = Trainer(variant, device="cpu", **dict(KW, seed=5))
    path = str(tmp_path / f"{variant}.pt2")
    export.save_sampler(path, t.spec, t.cfg, t.generator_params, 6)
    fn = export.load_sampler(path, device="cpu")
    a = fn(3)
    assert torch.equal(a, fn(3)) and tuple(a.shape) == (6, 784)
    z = export.sampler_noise(torch.tensor(3), 6,
                             export.noise_width(t.spec, t.cfg))
    np.testing.assert_allclose(a.numpy(), t.sample(z=z), rtol=0, atol=1e-6)
    assert not torch.equal(a, fn(4))


def test_load_sampler_defaults_to_the_card(tmp_path, monkeypatch):
    t = Trainer("nsgan", device="cpu", **KW)
    path = export.save_sampler(str(tmp_path / "g.pt2"), t.spec, t.cfg,
                               t.generator_params, 2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        export.load_sampler(path)
    assert tuple(export.load_sampler(path, device="cpu")(0).shape) == (2, 784)


def test_fused_step_refuses_conv_and_auto_takes_the_general_step():
    with pytest.raises(ValueError, match="mlp stacks only"):
        Trainer("nsgan", device="cpu", fused_step=True, **KW)
    t = Trainer("nsgan", device="cpu", **KW)  # fused_step "auto"
    t._load_data()
    assert t._fused is False and t.cfg.dtype == "float32"
    from generative_models_tpu_torch.ops import cuda_dp, cuda_train
    for v in ("nsgan", "vae", "infogan"):
        spec, cfg = get_variant(v), _cfg(v)
        assert not cuda_train.resolve_fused_step(spec, cfg, "cuda")
        assert not cuda_dp.fused_dp_supported(spec, cfg)[0]


def test_trainer_conv_resume_equals_one_run_and_keeps_a_conv_ema(tmp_path):
    kw = dict(KW, dataset="synthetic", ema_decay=0.9, scan_steps=3)
    data = synthetic_mnist(n_train=512, n_test=64)
    one = Trainer("nsgan", device="cpu", data=data, **kw)
    one.train(steps=6)
    a = Trainer("nsgan", device="cpu", data=data, **kw)
    a.train(steps=3)
    path = a.save_model(str(tmp_path / "half"))
    b = Trainer("nsgan", device="cpu", data=data, **kw)
    b.load_model(path)
    b.train(steps=3)
    assert sorted(b.state["g_ema"]) == ["fc", "gn0", "gn1", "up1", "up2"]
    for (p, x), (_, y) in zip(state_leaves(one.state), state_leaves(b.state)):
        if isinstance(x, torch.Tensor):
            np.testing.assert_allclose(x.numpy(), y.numpy(), err_msg=p,
                                       rtol=1e-6, atol=1e-7)
    ev = b.evaluate("test", max_batches=2)
    assert all(np.isfinite(v) for v in ev.values())


@pytest.mark.parametrize("variant,fwd,bwd,passes", [
    ("nsgan", 5, 4, 0), ("wgangp", 17, 12, 5), ("vae", 4, 4, 0)])
def test_conv_general_step_launch_counts(monkeypatch, variant, fwd, bwd,
                                         passes):
    """Every dense layer routed through MLPFunction on the CPU, as the
    card runs it, counting the forward and backward launches."""
    calls = {"fwd": 0, "bwd": 0}
    real_fwd, real_bwd = cuda_mlp.mlp_fwd, cuda_mlp.mlp_bwd

    def count(kind, fn):
        def run(*a, **k):
            calls[kind] += 1
            return fn(*a, **k)
        return run
    monkeypatch.setattr(cuda_mlp, "mlp_fwd", count("fwd", real_fwd))
    monkeypatch.setattr(cuda_mlp, "mlp_bwd", count("bwd", real_bwd))
    monkeypatch.setattr(conv, "fused_linear", lambda x, w, b, act="none",
                        slope=0.2, compute_dtype=None:
                        cuda_mlp.MLPFunction.apply(x, (act,), slope,
                                                   compute_dtype, w, b))
    cfg, spec = _cfg(variant), get_variant(variant)
    st = init_state(cfg, "cpu")
    step = step_lib.build_step(spec, cfg)
    rng = np.random.default_rng(0)
    ds = step_lib.batches_per_step(spec, cfg)
    b = cfg.batch_size
    batches = {"image": torch.from_numpy(rng.random((ds, b, 784),
                                                    dtype=np.float32)),
               "label": torch.zeros((ds, b), dtype=torch.int64)}
    before = penalty.plain_passes
    if spec.adversarial:
        lanes = penalty.aux_lanes(variant, 784)
        extra = [torch.rand(ds, b, lanes)] if lanes else []
        st, m = step(st, batches, torch.randn(ds, b, cfg.z_dim),
                     torch.randn(b, cfg.z_dim), *extra)
    else:
        st, m = step(st, batches, torch.randn(b, cfg.latent_dim))
    assert calls == {"fwd": fwd, "bwd": bwd}
    assert penalty.plain_passes - before == passes
    assert all(np.isfinite(float(v)) for v in m.values())


def test_losses_find_the_device_of_a_conv_tree():
    cfg = _cfg("nsgan")
    g = nets.generator_init(torch.Generator().manual_seed(0), cfg)
    assert isinstance(g, dict) and tree_device(g) == torch.device("cpu")
    gen = torch.Generator().manual_seed(1)
    assert tuple(minimax._noise(gen, 3, cfg, g, None).shape) == (3, 8)
    assert tuple(get_variant("nsgan").sample(g, gen, 3, cfg).shape) == (3, 784)
    icfg = _cfg("infogan")
    ig = nets.infogan_g_init(gen, icfg)
    assert tuple(infogan._rows(gen, 3, icfg, ig, None).shape) == (
        3, icfg.z_dim + icfg.info_cat_dim + icfg.info_cont_dim)
    assert tuple(infogan._sample(ig, gen, 4, icfg).shape) == (4, 784)
    for v in ("vae", "birvae"):
        p = get_variant(v).init_params(gen, _cfg(v))
        assert tuple(get_variant(v).sample(p, gen, 2, _cfg(v)).shape) == (
            2, 784)


STEPS, N = 4, 128


def _case(variant):
    # 12 channels: at 4 each GroupNorm group holds one channel, the bias
    # of the conv before it has an exactly zero gradient, and Adam turns
    # the different rounding residues of one device's sum and two
    # shards' into steps of order lr (test_torch_port_conv_trajectory.py)
    cfg = _cfg(variant, conv_channels=12)
    spec = get_variant(variant)
    ds = step_lib.batches_per_step(spec, cfg)
    b = cfg.batch_size
    rng = np.random.default_rng(2)
    if spec.adversarial:
        noise = (rng.standard_normal((STEPS, ds, b, cfg.z_dim))
                 .astype(np.float32),
                 rng.standard_normal((STEPS, b, cfg.z_dim))
                 .astype(np.float32))
    else:
        noise = (rng.standard_normal((STEPS, b, cfg.latent_dim))
                 .astype(np.float32),)
    return dict(cfg=cfg, path="general", steps_per_epoch=N // (ds * b),
                images=rng.random((N, 784), dtype=np.float32),
                labels=rng.integers(0, 10, N).astype(np.int64),
                perm=np.stack([rng.permutation(N) for _ in range(2)]),
                rel=np.arange(STEPS) * ds * b, noise=noise)


def test_conv_dp_equals_single_device():
    cases = [_case("nsgan"), _case("vae")]
    res = mesh.run_ranks(many_steps_rank, 2, "cpu", args=(cases,),
                         threads=2)
    for i, case in enumerate(cases):
        cfg = case["cfg"]
        spec = get_variant(cfg.variant)
        t = torch.from_numpy
        noise = tuple(t(a) for a in case["noise"])
        draw = ((lambda k0, n: tuple(a[k0:k0 + n] for a in noise))
                if spec.adversarial else (lambda k0, n: noise[0][k0:k0 + n]))
        st, m = step_lib.build_many_steps(spec, cfg, case["steps_per_epoch"])(
            init_state(cfg, "cpu"), t(case["images"]), t(case["labels"]),
            t(case["perm"]), t(case["rel"]), draw)
        single = state_numpy(st)
        for rank in res:
            got = rank[i]["state"]
            assert set(got) == set(single)
            for k, v in single.items():
                if k != "['rng']":
                    np.testing.assert_allclose(got[k], v, err_msg=k, **TOL)
            for k, v in m.items():
                np.testing.assert_allclose(rank[i]["metrics"][k], v.numpy(),
                                           err_msg=k, **TOL)
