"""Tensor parallelism in the port (``parallel/tp.py``) on ``dp x tp`` grids
of gloo ranks (``parallel/mesh.py::make_grid``), at the TINY widths of
``tests/conftest.py``.

One spawn of 4 ranks runs every variant at dp 2 x tp 2 for 8 steps from
the same streams (images, an epoch permutation, the global batch's noise,
each data rank slicing its rows), and ddpm, flow, vqvae and vqprior
data-parallel at world 2. Each is held against the port's single-device
step by the reference's tolerances (``tests/test_tp.py``: rtol 2e-4, atol
1e-5; wgan atol 5e-4; wgangp rtol 5e-4); nsgan, wgangp and vqprior also
against the JAX package's tp chunk (``build_tp_many_steps`` on a 2 x 2
CPU mesh), its noise pinned to the same numbers through a table of its
keys. The spectral projection runs under tp in the same spawn (nsgan
amortized, wgan fresh), against the single device, and nsgan's against
the JAX package's tp chunk with ``spectral_projection=True``. The same
spawn saves a checkpoint under tp and loads it back into a fresh grid.

The rule against the JAX package's, the refusals and the CLI's ``--tp``:
``tests/test_torch_port_tp_rules.py``.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generative_models_tpu_torch.config import VARIANTS, variant_config
from generative_models_tpu_torch.losses.registry import get_variant
from generative_models_tpu_torch.ops.penalty import aux_lanes
from generative_models_tpu_torch.parallel import mesh, runs
from generative_models_tpu_torch.parallel.runs import init_state, state_numpy
from generative_models_tpu_torch.train import step as step_lib
from generative_models_tpu_torch.train.trainer import Trainer
from tests.conftest import TINY

STEPS, N = 8, 256
KW = {k: TINY[k] for k in ("batch_size", "hidden_dim", "z_dim", "latent_dim",
                            "vae_hidden_dim", "began_ae_hidden", "seed",
                            "ddpm_timesteps", "ddpm_time_dim")}
# tests/test_tp.py's VQ sizes
TINY_VQ = dict(vq_prior_width=32, vq_prior_layers=1, vq_tokens=4,
               vq_codebook_size=16, vq_code_dim=4)
VQ_KW = {"vqprior": TINY_VQ,
         "vqvae": {k: v for k, v in TINY_VQ.items()
                   if not k.startswith("vq_prior")}}
# the batch-coupled heads at adam_eps 1e-3, and held as
# tests/test_torch_port_dp.py holds them under DP (a bias gradient of
# each cancels in exact arithmetic)
COUPLED = ("ragan", "fishergan", "birvae")
TP_VARIANTS = tuple(sorted(VARIANTS))
DP_VARIANTS = ("ddpm", "flow", "vqvae", "vqprior")
JAX_CASES = ("nsgan", "wgangp", "vqprior")
# the spectral projection under tp: each critic weight gathered whole
# over the model group and projected on every model rank
SN_CASES = {"nsgan": dict(spectral_projection=True),
            "wgan": dict(spectral_projection=True, sn_mode="fresh")}
# a diagnostic of code usage: under DP each data rank's, averaged (the
# reference's shard_map DP too); the reference's tp chunk takes it over
# the global batch
PER_SHARD_METRICS = ("perplexity",)


def _kw(variant):
    kw = dict(KW, **VQ_KW.get(variant, {}))
    if variant in COUPLED:
        kw["adam_eps"] = 1e-3
    return kw


def _tol(variant):
    if variant == "wgan":
        return dict(rtol=2e-4, atol=5e-4)
    if variant == "wgangp":
        return dict(rtol=5e-4, atol=1e-5)
    return dict(rtol=2e-4, atol=1e-5)


def _case(variant, grid, **kw):
    kw = dict(_kw(variant), **kw)
    cfg = variant_config(variant, **kw)
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
        noise = (spec.draw_noise(gen, (STEPS, b), cfg, "cpu").numpy(),)
    return dict(cfg=cfg, kw=kw, grid=grid, steps_per_epoch=N // (ds * b),
                images=rng.random((N, cfg.image_dim), dtype=np.float32),
                labels=rng.integers(0, 10, N).astype(np.int64),
                perm=np.stack([rng.permutation(N) for _ in range(3)]),
                rel=np.arange(STEPS) * ds * b, noise=noise)


def _cases():
    out = {("tp", v): _case(v, (2, 2), tp=2, dp=2) for v in TP_VARIANTS}
    for v, kw in SN_CASES.items():
        out[("tp_sn", v)] = _case(v, (2, 2), tp=2, dp=2, **kw)
    for v in DP_VARIANTS:
        out[("dp", v)] = _case(v, (2, 1), dp=2)
    return out


@pytest.fixture(scope="module")
def grid4(tmp_path_factory):
    """{case key: (case, [each rank's result])} and the checkpoint run:
    one spawn of 4 gloo ranks."""
    cases = _cases()
    ck_dir = tmp_path_factory.mktemp("tp_ckpt")
    path = str(ck_dir / "ck.npz")
    ck_cfg = variant_config("nsgan", **dict(KW, tp=2, dp=2,
                                            sample_every=10 ** 6))
    # the directory backend, with the carried sn_v in the state
    dir_cfg = ck_cfg.replace(ckpt_backend="orbax", spectral_projection=True)
    dir_path = str(ck_dir / "ck_dir")
    res = mesh.run_ranks(runs.sequence, 4, "cpu", args=([
        (runs.grid_steps_rank, (list(cases.values()),)),
        (runs.tp_checkpoint_rank, (ck_cfg, (2, 2), 4, path, 16)),
        (runs.tp_checkpoint_rank, (dir_cfg, (2, 2), 4, dir_path, 16)),
    ],), threads=1, timeout=500)
    steps = {k: (c, [r[0][i] for r in res])
             for i, (k, c) in enumerate(cases.items())}
    return (steps, (ck_cfg, path, [r[1] for r in res]),
            (dir_cfg, dir_path, [r[2] for r in res]))


def _single(case):
    """The port's single-device chunk on the same streams."""
    cfg = case["cfg"].replace(dp=1, tp=1)
    spec = get_variant(cfg.variant)
    t = torch.from_numpy
    noise = tuple(t(a) for a in case["noise"])
    draw = ((lambda k0, n: tuple(a[k0:k0 + n] for a in noise))
            if spec.adversarial else (lambda k0, n: noise[0][k0:k0 + n]))
    st, m = step_lib.build_many_steps(spec, cfg, case["steps_per_epoch"])(
        init_state(cfg, "cpu"), t(case["images"]), t(case["labels"]),
        t(case["perm"]), t(case["rel"]), draw)
    return state_numpy(st), {k: v.numpy() for k, v in m.items()}


def _close_state(got, want, what, **tol):
    assert set(got) == set(want), what
    for k in want:
        if k != "['rng']":
            np.testing.assert_allclose(got[k], want[k], err_msg=f"{what} {k}",
                                       **tol)


def _ranks_agree(res):
    ranks = [r for r in res if r is not None]
    for r in ranks[1:]:
        for k in ranks[0]["state"]:
            np.testing.assert_array_equal(ranks[0]["state"][k], r["state"][k])


def _hold(variant, got, s1, m1):
    tol = _tol(variant)
    if variant in COUPLED:  # tests/test_torch_port_dp.py's rule
        keys = ("loss",) if variant == "birvae" else ("d_loss", "g_loss")
        for k in keys:
            np.testing.assert_allclose(got["metrics"][k][0], m1[k][0],
                                       rtol=2e-4, atol=1e-5, err_msg=k)
            np.testing.assert_allclose(got["metrics"][k], m1[k], rtol=5e-3,
                                       atol=5e-4, err_msg=k)
        return
    _close_state(got["state"], s1, f"{variant} state", **tol)
    for k in m1:
        if k not in PER_SHARD_METRICS:
            np.testing.assert_allclose(got["metrics"][k], m1[k],
                                       err_msg=f"{variant} {k}", **tol)


@pytest.mark.parametrize("variant", TP_VARIANTS)
def test_tp_equals_single_device(grid4, variant):
    """dp 2 x tp 2 trains the single device's model: every rank ends
    with the same whole state."""
    case, res = grid4[0][("tp", variant)]
    _ranks_agree(res)
    s1, m1 = _single(case)
    _hold(variant, res[0], s1, m1)


def test_tp_counts_model_group_collectives(grid4):
    """nsgan's step: the row layers' g forward (G and D in the critic
    update's three passes, G and D in the G update's) and f's backward
    into G's output: 6 model all-reduces, and the data group's two."""
    _, res = grid4[0][("tp", "nsgan")]
    c = res[0]["counts"]
    assert c["model_all_reduce"] == 6 * STEPS
    assert c["data_all_reduce"] == 2 * STEPS
    assert c["model_all_gather"] == 0


@pytest.mark.parametrize("variant", sorted(SN_CASES))
def test_tp_spectral_projection_equals_single_device(grid4, variant):
    """The spectral projection under dp 2 x tp 2 (nsgan amortized, wgan
    fresh): every rank ends with the same whole state, the single
    device's; each critic update gathers each of D's two weights once
    (wgan: 5 updates a step); D's largest sigma (SVD) ends within the
    target."""
    case, res = grid4[0][("tp_sn", variant)]
    _ranks_agree(res)
    s1, m1 = _single(case)
    _hold(variant, res[0], s1, m1)
    d_updates = max(case["cfg"].d_steps, 1) * STEPS
    assert res[0]["counts"]["model_all_gather"] == 2 * d_updates
    if case["cfg"].sn_mode == "amortized":
        assert "['sn_v'][0]['w']" in res[0]["state"]
    for k in ("['d_params'][0]['w']", "['d_params'][1]['w']"):
        sigma = torch.linalg.svdvals(
            torch.from_numpy(res[0]["state"][k]).double())[0]
        assert float(sigma) <= case["cfg"].sn_target * (1 + 1e-4), k


@pytest.mark.parametrize("variant", DP_VARIANTS)
def test_dp_diffusion_and_vq_equal_single_device(grid4, variant):
    case, res = grid4[0][("dp", variant)]
    assert res[2] is None and res[3] is None  # outside the 2 x 1 grid
    _ranks_agree(res)
    s1, m1 = _single(case)
    _hold(variant, res[0], s1, m1)


def _to_jax(tree):
    if isinstance(tree, dict):
        return {k: _to_jax(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_jax(v) for v in tree]
    return jnp.asarray(tree.numpy())


def _jax_tp(case, monkeypatch):
    """The reference's tp chunk on a 2 x 2 CPU mesh from the port's
    weights, on the same batches and noise: each JAX key the step draws
    from is looked up in a table of the global noise's rows."""
    from generative_models_tpu.config import variant_config as jax_config
    from generative_models_tpu.losses.registry import get_variant as jspec_of
    from generative_models_tpu.parallel.tp import (
        build_tp_many_steps,
        make_mesh_2d,
        shard_state,
    )
    from generative_models_tpu.train import step as jstep
    from generative_models_tpu.train.optim import make_tx
    variant = case["cfg"].variant
    jcfg = jax_config(variant, **dict(case["kw"], use_pallas=False))
    jspec = jspec_of(variant)
    st = jstep.init_state(jspec, jcfg, jax.random.PRNGKey(0))
    port = init_state(case["cfg"], "cpu")
    if jspec.adversarial:
        st["g_params"] = _to_jax(port["g_params"])
        st["d_params"] = _to_jax(port["d_params"])
        st["g_opt"] = make_tx(jcfg, jcfg.g_lr).init(st["g_params"])
        st["d_opt"] = make_tx(jcfg, jcfg.d_lr).init(st["d_params"])
        if "sn_v" in port:
            st["sn_v"] = _to_jax(port["sn_v"])
        mod = importlib.import_module("generative_models_tpu.losses."
                                      + {"nsgan": "minimax"}.get(variant,
                                                                 variant))
        z_d, z_g = case["noise"][:2]
        ds, lanes = z_d.shape[1], aux_lanes(variant, jcfg.image_dim)
        keys, rows, akeys, arows = [], [], [], []
        rng = st["rng"]
        for k in range(STEPS):
            rng, d_key, g_key = jax.random.split(rng, 3)
            for i, dk in enumerate(jax.random.split(d_key, ds)):
                if lanes:
                    dk, ak = jax.random.split(dk)
                    akeys.append(ak)
                    arows.append(case["noise"][2][k, i])
                keys.append(dk)
                rows.append(z_d[k, i])
            keys.append(g_key)
            rows.append(z_g[k])

        def lookup(ks, rs):
            ks, rs = jnp.stack(ks), jnp.asarray(np.stack(rs))
            return lambda key: rs[jnp.argmax(jnp.all(ks == key[None], 1))]
        z_of = lookup(keys, rows)
        monkeypatch.setattr(mod, "compute_noise", lambda key, n, z: z_of(key))
        if lanes:
            a_of = lookup(akeys, arows)
            monkeypatch.setattr(mod, "interpolate", lambda key, real, fake:
                                a_of(key) * real + (1.0 - a_of(key)) * fake)
    else:
        st["params"] = _to_jax(port["params"])
        st["opt"] = make_tx(jcfg, jcfg.g_lr).init(st["params"])
    mesh_ = make_mesh_2d(2, 2, devices=jax.devices("cpu")[:4])
    st, shardings = shard_state(jspec, jcfg, st, mesh_)
    fn = build_tp_many_steps(jspec, jcfg, case["steps_per_epoch"], mesh_,
                             shardings)
    st, m = fn(st, jnp.asarray(case["images"]),
               jnp.asarray(case["labels"].astype(np.int32)),
               jnp.asarray(case["perm"].astype(np.int32)),
               jnp.asarray(case["rel"].astype(np.int32)))
    flat, _ = jax.tree_util.tree_flatten_with_path(st)
    return ({jax.tree_util.keystr(k): np.asarray(v) for k, v in flat},
            {k: np.asarray(v) for k, v in m.items()})


@pytest.mark.parametrize("variant", JAX_CASES)
def test_tp_equals_jax_tp_chunk(grid4, variant, monkeypatch):
    _hold_jax(*grid4[0][("tp", variant)], monkeypatch)


def test_tp_spectral_projection_equals_jax_tp_chunk(grid4, monkeypatch):
    """nsgan with the amortized projection under dp 2 x tp 2 against the
    JAX package's tp chunk with ``spectral_projection=True``."""
    _hold_jax(*grid4[0][("tp_sn", "nsgan")], monkeypatch)


def _hold_jax(case, res, monkeypatch):
    variant = case["cfg"].variant
    jst, jm = _jax_tp(case, monkeypatch)
    tol = _tol(variant)
    got = res[0]["state"]
    shared = [k for k in got if k in jst and k not in ("['rng']", "['step']")]
    assert len(shared) >= len(got) - 3
    for k in shared:
        np.testing.assert_allclose(got[k], jst[k], err_msg=k, **tol)
    for k in jm:
        if k not in PER_SHARD_METRICS:
            np.testing.assert_allclose(res[0]["metrics"][k], jm[k],
                                       err_msg=k, **tol)


def test_tp_checkpoint_loads_bit_for_bit_both_ways(grid4):
    """A checkpoint saved under tp is the whole tree in the JAX package's
    layout: the single-device Trainer loads it bit for bit, and so does a
    fresh grid; sampling from the tp state equals the single device's
    sampling from the loaded file."""
    _hold_checkpoint(*grid4[1])


def test_tp_dir_checkpoint_loads_bit_for_bit_both_ways(grid4):
    """The directory backend (``ckpt_backend="orbax"``, DCP's layout)
    under tp, the spectral projection's carried sn_v in the state: as
    the npz checkpoint above."""
    cfg, path, res = grid4[2]
    assert "['sn_v'][0]['w']" in res[0]["state"]
    _hold_checkpoint(cfg, path, res)


def _hold_checkpoint(cfg, path, res):
    r0 = res[0]
    for r in res[1:]:
        for k in r0["state"]:
            np.testing.assert_array_equal(r["state"][k], r0["state"][k])
    for k in r0["state"]:
        np.testing.assert_array_equal(r0["loaded"][k], r0["state"][k])
    t = Trainer(config=cfg.replace(dp=1, tp=1), device="cpu")
    t.load_model(path)
    st = state_numpy(t.state)
    assert set(st) == set(r0["state"])
    for k in st:
        np.testing.assert_array_equal(st[k], r0["state"][k], err_msg=k)
    np.testing.assert_array_equal(t.sample(16), r0["sample"])
