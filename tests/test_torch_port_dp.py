"""Data-parallel training in the port: the general DP step
(``parallel/dp.py``) and the phase kernels' path (``ops/cuda_dp.py``,
their plain versions on the CPU) at world 2, in spawned gloo ranks
(``parallel/mesh.py::run_ranks``), at the TINY widths of
``tests/conftest.py``.

One spawn runs every case over the same streams (images, an epoch
permutation, the global batch's noise, each rank slicing its rows):

- the general DP step equals the port's single-device step (the ranks
  together see the single-device batch and noise) and the JAX package's
  shard_map DP on a 2-device CPU mesh, whose noise is pinned to the same
  numbers through a table of its per-device keys (rtol 2e-4, atol 2e-5);
- ragan, fishergan and birvae, whose losses couple the batch, equal the
  single-device step with their statistics all-reduced, by the
  reference's two tolerances (``tests/test_parallel.py``);
- with the spectral projection on (nsgan amortized, lsgan fresh) the
  general DP step equals the single-device step, ``sn_v`` included;
- the fused DP path equals the general DP step for every variant of
  ``FUSED_DP_VARIANTS``, the EMA included; ``dp_impl`` "jit" and
  "shard_map" are one path.

A second spawn runs the CLI's ``--dp 2 --device cpu``.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generative_models_tpu_torch import cli
from generative_models_tpu_torch.config import variant_config
from generative_models_tpu_torch.losses.registry import get_variant
from generative_models_tpu_torch.ops import cuda_dp
from generative_models_tpu_torch.ops.penalty import aux_lanes
from generative_models_tpu_torch.parallel import dp, mesh
from generative_models_tpu_torch.parallel.runs import (
    init_state,
    many_steps_rank,
    state_numpy,
)
from generative_models_tpu_torch.train import step as step_lib
from generative_models_tpu_torch.train.trainer import Trainer
from tests.conftest import TINY

TOL = dict(rtol=2e-4, atol=2e-5)
WORLD, STEPS, N = 2, 6, 256
KW = {k: TINY[k] for k in ("batch_size", "hidden_dim", "z_dim",
                            "began_ae_hidden", "latent_dim",
                            "vae_hidden_dim", "seed")}
# each fused variant's configuration beside KW (nsgan: 2 critic updates
# a step and the EMA of G)
FUSED_KW = {"nsgan": {"d_steps": 2, "ema_decay": 0.9}}
COUPLED = ("ragan", "fishergan", "birvae")
# The coupled cases run at adam_eps 1e-3, as chip_smoke.py's chunk checks
# run ragan, fishergan and the BIR-VAE (COUPLED_ADAM_EPS) and for its
# reason: a bias gradient of each cancels in exact arithmetic (ragan's
# and fishergan's critic head: the IPM's +1/B and -1/B a row; BIR-VAE's
# mean head: the batch norm removes a shift), and at eps 1e-8 Adam's first
# step turns the rounding residue of that sum, which differs with the
# order of the sum (one device's, or two shards' and an all-reduce), into
# a step of order lr. At 1e-3 the three agree with the single device to
# ~1e-6 over the six steps.
COUPLED_KW = {"adam_eps": 1e-3}
# the spectral projection on the critic: (variant, sn_mode)
SPECTRAL = (("nsgan", "amortized"), ("lsgan", "fresh"))


def _case(variant, path, **kw):
    cfg = variant_config(variant, **dict(KW, **kw))
    spec = get_variant(variant)
    ds = step_lib.batches_per_step(spec, cfg)
    b = cfg.batch_size
    rng = np.random.default_rng(1)
    gen = torch.Generator().manual_seed(3)
    if spec.adversarial:
        noise = (step_lib.draw_z(gen, (STEPS, ds, b), cfg, "cpu").numpy(),
                 step_lib.draw_z(gen, (STEPS, b), cfg, "cpu").numpy())
        lanes = aux_lanes(variant, cfg.image_dim)
        if lanes:
            noise += (rng.random((STEPS, ds, b, lanes), dtype=np.float32),)
    else:
        noise = (rng.standard_normal((STEPS, b, cfg.latent_dim))
                 .astype(np.float32),)
    return dict(cfg=cfg, path=path, steps_per_epoch=N // (ds * b),
                images=rng.random((N, cfg.image_dim), dtype=np.float32),
                labels=rng.integers(0, 10, N).astype(np.int64),
                perm=np.stack([rng.permutation(N) for _ in range(3)]),
                rel=np.arange(STEPS) * ds * b, noise=noise)


def _cases():
    out = {("nsgan", "general", "jax"): _case("nsgan", "general"),
           ("nsgan", "shard_map", "jax"): _case("nsgan", "general",
                                                dp_impl="shard_map")}
    for v in cuda_dp.FUSED_DP_VARIANTS:
        for path in ("general", "fused"):
            out[(v, path, "fused")] = _case(v, path, **FUSED_KW.get(v, {}))
    for v in COUPLED:
        out[(v, "general", "coupled")] = _case(v, "general", **COUPLED_KW)
    for v, mode in SPECTRAL:
        out[(v, "general", mode)] = _case(v, "general",
                                          spectral_projection=True,
                                          sn_mode=mode)
    return out


@pytest.fixture(scope="module")
def world2():
    """{case key: (case, [rank 0's result, rank 1's])}: one spawn."""
    cases = _cases()
    res = mesh.run_ranks(many_steps_rank, WORLD, "cpu",
                         args=(list(cases.values()),), threads=2)
    return {k: (c, [r[i] for r in res]) for i, (k, c) in
            enumerate(cases.items())}


def _single(case):
    """The port's single-device chunk on the same streams."""
    cfg = case["cfg"]
    spec = get_variant(cfg.variant)
    t = torch.from_numpy
    noise = tuple(t(a) for a in case["noise"])
    draw = ((lambda k0, n: tuple(a[k0:k0 + n] for a in noise))
            if spec.adversarial else (lambda k0, n: noise[0][k0:k0 + n]))
    st, m = step_lib.build_many_steps(spec, cfg, case["steps_per_epoch"])(
        init_state(cfg, "cpu"), t(case["images"]), t(case["labels"]),
        t(case["perm"]), t(case["rel"]), draw)
    return state_numpy(st), {k: v.numpy() for k, v in m.items()}


def _close(got, want, what, **tol):
    assert set(got) == set(want), what
    for k in want:
        if k == "['rng']":
            continue
        np.testing.assert_allclose(got[k], want[k], err_msg=f"{what} {k}",
                                   **(tol or TOL))


def _ranks_agree(res):
    for k in res[0]["state"]:
        np.testing.assert_array_equal(res[0]["state"][k], res[1]["state"][k])


def _jax_shard_map(case, monkeypatch):
    """The reference's shard_map DP on a 2-device CPU mesh from the same
    weights, batches and noise: compute_noise looks each per-device key
    (fold_in(key, rank)) up in a table of the global noise's rows."""
    from generative_models_tpu.config import variant_config as jax_config
    from generative_models_tpu.losses import minimax as jminimax
    from generative_models_tpu.losses.registry import get_variant as jspec_of
    from generative_models_tpu.parallel.dp import (
        build_shard_map_many_steps as jax_build,
    )
    from generative_models_tpu.parallel.mesh import make_mesh
    from generative_models_tpu.train import step as jstep
    from generative_models_tpu.train.optim import make_tx
    cfg = case["cfg"]
    jcfg = jax_config("nsgan", **{k: getattr(cfg, k) for k in (
        "batch_size", "hidden_dim", "z_dim", "seed", "d_steps",
        "ema_decay")})
    jspec = jspec_of("nsgan")
    st = jstep.init_state(jspec, jcfg, jax.random.PRNGKey(0))
    port = init_state(cfg, "cpu")
    to_j = lambda layers: [{k: jnp.asarray(v.numpy()) for k, v in l.items()}
                           for l in layers]
    st["g_params"], st["d_params"] = to_j(port["g_params"]), to_j(
        port["d_params"])
    st["g_opt"] = make_tx(jcfg, jcfg.g_lr).init(st["g_params"])
    st["d_opt"] = make_tx(jcfg, jcfg.d_lr).init(st["d_params"])
    if cfg.ema_decay > 0:
        st["g_ema"] = st["g_params"]
    z_d, z_g = case["noise"]
    ds, b = z_d.shape[1], cfg.batch_size // WORLD
    keys, rows = [], []
    rng = st["rng"]
    for k in range(STEPS):
        rng, d_key, g_key = jax.random.split(rng, 3)
        for i, dk in enumerate(jax.random.split(d_key, ds)):
            for r in range(WORLD):
                keys.append(jax.random.fold_in(dk, r))
                rows.append(z_d[k, i, r * b:(r + 1) * b])
        for r in range(WORLD):
            keys.append(jax.random.fold_in(g_key, r))
            rows.append(z_g[k, r * b:(r + 1) * b])
    keys, table = jnp.stack(keys), jnp.asarray(np.stack(rows))

    def table_noise(key, n, z_dim):
        return table[jnp.argmax(jnp.all(keys == key[None], axis=1))]
    monkeypatch.setattr(jminimax, "compute_noise", table_noise)
    mesh_ = make_mesh(devices=jax.devices("cpu")[:WORLD])
    fn = jax_build(jspec, jcfg, case["steps_per_epoch"], mesh_)
    st, m = fn(st, jnp.asarray(case["images"]),
               jnp.asarray(case["labels"].astype(np.int32)),
               jnp.asarray(case["perm"].astype(np.int32)),
               jnp.asarray(case["rel"].astype(np.int32)))
    return st, {k: np.asarray(v) for k, v in m.items()}


def test_general_dp_equals_single_device_and_jax_shard_map(world2,
                                                           monkeypatch):
    case, res = world2[("nsgan", "general", "jax")]
    _ranks_agree(res)
    s1, m1 = _single(case)
    _close(res[0]["state"], s1, "DP vs single-device state")
    _close(res[0]["metrics"], m1, "DP vs single-device metrics")
    jst, jm = _jax_shard_map(case, monkeypatch)
    _close(res[0]["metrics"], jm, "DP vs JAX shard_map metrics")
    for side in ("g_params", "d_params"):
        for i, layer in enumerate(jst[side]):
            for k in ("w", "b"):
                np.testing.assert_allclose(
                    res[0]["state"][f"['{side}'][{i}]['{k}']"],
                    np.asarray(layer[k]), err_msg=f"{side} {i} {k}", **TOL)


@pytest.mark.parametrize("variant", COUPLED)
def test_batch_coupled_dp_equals_single_device(world2, variant):
    """The statistics all-reduced inside the loss, differentiably (the
    factor of the backward is the reference's pmean transpose): the
    objective is the single device's. Step 0 tight, later steps within
    the reference's looser bar for rounding drift (test_parallel.py)."""
    case, res = world2[(variant, "general", "coupled")]
    _ranks_agree(res)
    _, m1 = _single(case)
    keys = ("loss",) if variant == "birvae" else ("d_loss", "g_loss")
    for k in keys:
        np.testing.assert_allclose(res[0]["metrics"][k][0], m1[k][0],
                                   rtol=2e-4, atol=1e-5, err_msg=k)
        np.testing.assert_allclose(res[0]["metrics"][k], m1[k], rtol=5e-3,
                                   atol=5e-4, err_msg=k)


@pytest.mark.parametrize("variant,mode", SPECTRAL)
def test_general_dp_with_projection_equals_single_device(world2, variant,
                                                         mode):
    """Every rank projects its critic from the same averaged update, and
    (amortized) carries the same vectors: the single device's run."""
    case, res = world2[(variant, "general", mode)]
    _ranks_agree(res)
    assert any(k.startswith("['sn_v']") for k in res[0]["state"]) == (
        mode == "amortized")
    s1, m1 = _single(case)
    _close(res[0]["state"], s1, f"{variant} {mode} DP vs single state")
    _close(res[0]["metrics"], m1, f"{variant} {mode} DP vs single metrics")


@pytest.mark.parametrize("variant", cuda_dp.FUSED_DP_VARIANTS)
def test_fused_dp_equals_general_dp(world2, variant):
    (_, general), (case, fused) = (world2[(variant, "general", "fused")],
                                   world2[(variant, "fused", "fused")])
    _ranks_agree(fused)
    _close(fused[0]["state"], general[0]["state"], f"{variant} state")
    _close(fused[0]["metrics"], general[0]["metrics"], f"{variant} metrics")
    if case["cfg"].ema_decay > 0:
        assert any(k.startswith("['g_ema']") for k in fused[0]["state"])


def test_dp_impl_values_are_one_path(world2):
    (_, a), (_, b) = (world2[("nsgan", "general", "jax")],
                      world2[("nsgan", "shard_map", "jax")])
    for k in a[0]["state"]:
        np.testing.assert_array_equal(a[0]["state"][k], b[0]["state"][k])


def test_grid_noise_shards_are_the_single_device_rows():
    """A rank's noise is its rows of the single-device draw, so it is a
    function of (rng, step, rank) and a split run equals the whole."""
    cfg = variant_config("wgangp", **KW)
    rng = step_lib._rng_words(cfg)
    b = cfg.batch_size

    def draw(gen, s):
        return (torch.randn((s, 5, b, 8), generator=gen),
                torch.randn((s, b, 8), generator=gen))
    whole = step_lib.grid_noise(rng, 60, 10, "cpu", draw)
    for r in range(WORLD):
        part = step_lib.grid_noise(rng, 60, 10, "cpu", draw, (r, WORLD))
        split = [step_lib.grid_noise(rng, 60 + k0, n, "cpu", draw, (r, WORLD))
                 for k0, n in ((0, 4), (4, 6))]
        sl = slice(r * b // WORLD, (r + 1) * b // WORLD)
        for w, p, s0, s1 in zip(whole, part, *split):
            assert torch.equal(p, w[..., sl, :])
            assert torch.equal(torch.cat([s0, s1]), p)


def _fake_group(world=WORLD):
    return mesh.DataGroup(world=world, rank=0, device=torch.device("cpu"),
                          backend="gloo", pg=None)


@pytest.mark.parametrize("variant,kw,match", [
    ("ragan", {"fused_step": True}, "global-batch statistics"),
    ("fishergan", {"fused_step": True}, "global-batch statistics"),
    ("vae", {"fused_step": True}, "single-model"),
    ("birvae", {"fused_step": True}, "single-model"),
    ("nsgan", {"batch_size": 15}, "not divisible"),
])
def test_dp_refusals(variant, kw, match):
    cfg = variant_config(variant, **dict(KW, **kw))
    with pytest.raises(ValueError, match=match):
        Trainer(config=cfg, group=_fake_group())
    if "batch_size" in kw:
        with pytest.raises(ValueError, match=match):
            dp.build_shard_map_many_steps(get_variant(variant), cfg, 4,
                                          _fake_group())
    if kw.get("fused_step"):
        ok, reason = cuda_dp.fused_dp_supported(get_variant(variant), cfg)
        assert not ok and match in reason


def test_global_statistics_take_a_group_not_an_axis_name():
    from generative_models_tpu_torch.losses.common import global_mean
    with pytest.raises(TypeError, match="DataGroup"):
        global_mean(torch.ones(3), "data")


def test_cli_dp2_on_the_cpu_trains_and_rank0_writes(tmp_path, capsys,
                                                    tiny_data):
    from generative_models_tpu.train.trainer import Trainer as JaxTrainer
    ck = tmp_path / "ck.npz"
    flags = ["--variant", "nsgan", "--dp", "2", "--device", "cpu",
             "--dataset", "synthetic", "--batch-size", "16", "--hidden-dim",
             "32", "--z-dim", "8", "--scan-steps", "3", "--echo-every", "0",
             "--fused-step", "--out-dir", str(tmp_path), "--ckpt", str(ck),
             "--steps", "6"]
    assert cli.main(flags) == 0
    out = capsys.readouterr().out.strip().splitlines()
    finals = [l for l in out if l.startswith("{")]
    assert len(finals) == 1
    line = json.loads(finals[0])
    assert line["variant"] == "nsgan" and line["steps"] == 6
    assert out[-1] == f"saved: {ck}"
    assert sorted(os.listdir(tmp_path / "nsgan")) == sorted(
        ["final.png", "metrics.jsonl"] + [f for f in os.listdir(
            tmp_path / "nsgan") if f.startswith("loss.")])
    with open(tmp_path / "nsgan" / "metrics.jsonl") as f:
        recs = [json.loads(l) for l in f]
    assert [r["step"] for r in recs] == list(range(6))  # one rank's
    jt = JaxTrainer("nsgan", batch_size=16, hidden_dim=32, z_dim=8,
                    data=tiny_data)
    jt.load_model(str(ck))
    assert int(jt.state["step"]) == 6
    pt = Trainer("nsgan", device="cpu", batch_size=16, hidden_dim=32,
                 z_dim=8)
    pt.load_model(str(ck))
    assert pt.state["step"] == 6
    np.testing.assert_allclose(pt.state["g_params"][1]["w"].numpy(),
                               np.asarray(jt.state["g_params"][1]["w"]))


def test_cli_dp_on_cuda_needs_a_card_a_rank(capsys):
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    n = max(have + 1, 2)
    with pytest.raises(SystemExit) as e:
        cli.main(["--variant", "nsgan", "--dp", str(n)])
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert f"--dp {n} needs {n} CUDA devices, one a rank, but only {have}" in err


def test_a_group_of_one_runs_every_collective_it_counts(tmp_path,
                                                        monkeypatch):
    """At world 1 each counted all-reduce (in place, and the
    differentiable mean both ways) is a call of the backend's
    collective, as a larger group makes it."""
    calls = []
    real = mesh.dist.all_reduce

    def spy(t, **kw):
        calls.append(t.numel())
        return real(t, **kw)
    monkeypatch.setattr(mesh.dist, "all_reduce", spy)
    group = mesh.init_data_group(1, 0, "cpu",
                                 store_path=str(tmp_path / "store"))
    try:
        assert group.backend == "gloo"
        before = mesh.all_reduces
        t = torch.arange(4.0)
        group.all_reduce_mean_(t)
        x = torch.ones(3, requires_grad=True)
        mesh.all_reduce_mean(x * 2.0, group).sum().backward()
        assert calls == [4, 3, 3] and mesh.all_reduces - before == 3
        assert torch.equal(t, torch.arange(4.0))
        assert torch.equal(x.grad, torch.full((3,), 2.0))
    finally:
        mesh.close_data_group()
