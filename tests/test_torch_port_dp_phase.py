"""The data-parallel phase functions of the port against the JAX
package's phase kernels.

``ops/cuda_dp.py::d_phase_plain`` / ``g_phase_plain`` (the CPU path and
the card kernels' oracle) against ``ops/pallas_dp.py``'s
``_make_d_phase_kernel`` / ``_make_g_phase_kernel`` run by
``pl.pallas_call(..., interpret=True)`` on the reference's padded inputs,
for every variant of ``FUSED_DP_VARIANTS``, at the TINY widths of
``tests/conftest.py`` and the reference's own bar (rtol 2e-4, atol 2e-5,
``tests/test_fused_dp.py``); the packing of the state into the kernels'
tensors and flat buffers and back; and the rank-offset gather against
the reference's indices.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from generative_models_tpu.ops import pallas_dp as jdp
from generative_models_tpu.ops.pallas_mlp import _pad2, _ru
from generative_models_tpu_torch.config import variant_config
from generative_models_tpu_torch.ops import cuda_dp
from generative_models_tpu_torch.ops.cuda_train import ChunkHyper
from generative_models_tpu_torch.parallel.dp import make_gather_local
from generative_models_tpu_torch.parallel.runs import init_state
from tests.conftest import TINY

RTOL, ATOL = 2e-4, 2e-5
KW = {k: TINY[k] for k in ("batch_size", "hidden_dim", "z_dim",
                            "began_ae_hidden", "seed")}


def _case(variant, b, seed):
    """A port config, G and D as the kernels take them, and one phase's
    local rows (numpy), drawn from `seed`: x (cgan: with its label lanes),
    zd and zg (infogan: code rows; cgan: with the labels), xtra."""
    cfg = variant_config(variant, **KW)
    st = init_state(cfg, "cpu")
    g = [t.numpy().copy() for t in cuda_dp.pack_g(st["g_params"])]
    d = [t.numpy().copy() for t in cuda_dp.pack_d(st["d_params"])]
    rng = np.random.default_rng(seed)
    x = rng.random((b, cfg.image_dim), dtype=np.float32)
    zw = cfg.z_dim
    if variant == "infogan":
        codes = [np.eye(cfg.info_cat_dim, dtype=np.float32)[
            rng.integers(0, cfg.info_cat_dim, b)],
            rng.uniform(-1, 1, (b, cfg.info_cont_dim)).astype(np.float32)]
        zd = np.concatenate([rng.standard_normal((b, zw), np.float32)]
                            + codes, 1)
        zg = zd[::-1].copy()
    else:
        zd = rng.standard_normal((b, zw), np.float32)
        zg = rng.standard_normal((b, zw), np.float32)
    if variant == "cgan":
        oh = np.eye(cfg.num_classes, dtype=np.float32)[
            rng.integers(0, cfg.num_classes, b)]
        x, zd, zg = (np.concatenate([a, oh], 1) for a in (x, zd, zg))
    xtra = None
    if variant == "wgangp":
        xtra = rng.random((b, 1), dtype=np.float32)
    elif variant == "dragan":
        u = rng.random((b, cfg.image_dim), dtype=np.float32)
        xtra = x + np.float32(cfg.dragan_noise_scale) * x.std() * u
    return cfg, g, d, x, zd, zg, xtra


def _jax_phases(cfg, b, g, d, x, zd, zg, xtra, k, dtype="float32"):
    """The reference's two phase kernels in interpret mode on padded
    inputs, as build_fused_dp_many_steps calls them (products in
    `dtype`): the D phase's (dW1d, db1d, dW2d, db2d) and G's (dW1g, ...)
    at true widths, and each metrics row's lanes 0..7."""
    v = cfg.variant
    bp = _ru(max(b, 8), 8)
    n_cls = cfg.num_classes if v == "cgan" else 0
    info = v == "infogan"
    qc, qn = (cfg.info_cat_dim, cfg.info_cont_dim) if info else (0, 0)
    zin, xin = cfg.z_dim + n_cls + qc + qn, cfg.image_dim + n_cls
    kz, kh, kx = _ru(zin, 128), _ru(cfg.hidden_dim, 128), _ru(xin, 128)
    began = v == "began"
    khd = _ru(d[0].shape[1], 128)
    kl = kx if began else 128
    lanes = kx if v == "dragan" else 128
    args = (b, bp, kz, kh, kx, kl, khd, cfg.image_dim, zin, cfg.leaky_slope,
            v, dtype)
    head = dict(fgan_div=cfg.fgan_divergence if v == "fgan" else "",
                fgan_ns=v == "fgan" and cfg.fgan_g_loss == "nonsaturating",
                q_cat=qc, q_cont=qn, info_lam=cfg.info_lambda if info else 0.0)
    dk = jdp._make_d_phase_kernel(
        *args, gp_lam=cfg.gp_lambda if xtra is not None else 0.0,
        n_cls=n_cls, **head)
    gk = jdp._make_g_phase_kernel(*args, n_cls=n_cls, **head)
    pw = lambda a, r, c: _pad2(jnp.asarray(a), r, c)
    pb = lambda a, c: _pad2(jnp.asarray(a)[None, :], 8, c)
    g_pl = (pw(g[0], kz, kh), pb(g[1], kh), pw(g[2], kh, kx), pb(g[3], kx))
    d_pl = (pw(d[0], kx, khd), pb(d[1], khd), pw(d[2], khd, kl),
            pb(d[3], kl))
    vs = jnp.asarray([[k, 0.0]], jnp.float32)
    xt = (jnp.zeros((8, lanes), jnp.float32) if xtra is None
          else pw(xtra, bp, lanes))
    smem = pl.BlockSpec(memory_space=pltpu.SMEM)
    f32 = jnp.float32
    shp = lambda *s: jax.ShapeDtypeStruct(s, f32)
    d_out = pl.pallas_call(
        dk, in_specs=[pl.BlockSpec()] * 11 + [smem],
        out_shape=(shp(kx, khd), shp(8, khd), shp(khd, kl), shp(8, kl),
                   shp(1, 128)), interpret=True,
    )(pw(x, bp, kx), pw(zd, bp, kz), xt, *g_pl, *d_pl, vs)
    g_out = pl.pallas_call(
        gk, in_specs=[pl.BlockSpec()] * 9 + [smem],
        out_shape=(shp(kz, kh), shp(8, kh), shp(kh, kx), shp(8, kx),
                   shp(1, 128)), interpret=True,
    )(pw(zg, bp, kz), *g_pl, *d_pl, vs)

    def cut(outs, like):
        o = [np.asarray(t) for t in outs]
        return ([o[0][:like[0].shape[0], :like[0].shape[1]],
                 o[1][0, :like[1].shape[0]],
                 o[2][:like[2].shape[0], :like[2].shape[1]],
                 o[3][0, :like[3].shape[0]]], o[4][0, :8])
    return cut(d_out, d), cut(g_out, g)


def _split(flat, like):
    sizes = [a.size for a in like]
    parts = np.split(flat.numpy(), np.cumsum(sizes))
    return [p.reshape(a.shape) for p, a in zip(parts, like)], parts[-1]


@pytest.mark.parametrize("variant,b", [(v, 16) for v in
                                       cuda_dp.FUSED_DP_VARIANTS]
                         + [("nsgan", 5), ("wgangp", 8)])
def test_phase_functions_match_the_jax_phase_kernels(variant, b):
    cfg, g, d, x, zd, zg, xtra, = _case(variant, b, seed=3)
    k = 0.3 if variant == "began" else 0.0
    (jd, jdm), (jg, jgm) = _jax_phases(cfg, b, g, d, x, zd, zg, xtra, k)
    hp = ChunkHyper.from_config(cfg)
    t = lambda a: None if a is None else torch.from_numpy(np.ascontiguousarray(a))
    gt, dt = [t(a) for a in g], [t(a) for a in d]
    got_d = cuda_dp.d_phase(t(x), t(zd), t(xtra), gt, dt,
                            torch.tensor(k), hp)
    got_g = cuda_dp.g_phase(t(zg), gt, dt, hp)
    pd, pdm = _split(got_d, d)
    pg, pgm = _split(got_g, g)
    for name, mine, ref in zip(("dW1d", "db1d", "dW2d", "db2d", "dW1g",
                                "db1g", "dW2g", "db2g"), pd + pg, jd + jg):
        np.testing.assert_allclose(mine, ref, rtol=RTOL, atol=ATOL,
                                   err_msg=f"{variant} {name}")
    np.testing.assert_allclose(pdm, jdm, rtol=RTOL, atol=ATOL,
                               err_msg=f"{variant} D metrics")
    np.testing.assert_allclose(pgm, jgm, rtol=RTOL, atol=ATOL,
                               err_msg=f"{variant} G metrics")
    assert pdm[0] != 0 and pgm[3] != 0  # the lanes were written
    if variant in ("wgangp", "dragan"):
        assert pdm[4] > 0 and pdm[5] > 0


def test_phase_lanes_carry_the_reference_names():
    """The lanes' names are the port's general step's metric keys (those
    of the reference's d_named / g_named, pallas_dp.py:439-461)."""
    m = torch.arange(8.0)
    for v in cuda_dp.FUSED_DP_VARIANTS:
        assert float(cuda_dp.d_named(v, m)["d_loss"]) == 0.0
        assert float(cuda_dp.g_named(v, m)["g_loss"]) == 3.0
    assert set(cuda_dp.d_named("wgangp", m)) == {"d_loss", "w_estimate", "gp",
                                                 "grad_norm"}
    assert float(cuda_dp.d_named("wgangp", m)["w_estimate"]) == -1.0
    assert float(cuda_dp.g_named("infogan", m)["g_mi_loss"]) == 6.0
    assert set(cuda_dp.d_named("began", m)) == {"d_loss", "began_l_real",
                                                "began_l_fake_d"}


@pytest.mark.parametrize("variant", ["nsgan", "cgan", "infogan", "began"])
def test_pack_unpack_round_trips(variant):
    cfg = variant_config(variant, **KW)
    st = init_state(cfg, "cpu")
    for params, pack, unpack in ((st["g_params"], cuda_dp.pack_g,
                                  cuda_dp.unpack_g),
                                 (st["d_params"], cuda_dp.pack_d,
                                  cuda_dp.unpack_d)):
        packed = pack(params)
        assert len(packed) == 4
        flat = torch.cat([t.reshape(-1) for t in packed]
                         + [torch.arange(8.0)])
        back = unpack(flat, params)
        from generative_models_tpu_torch.utils.tree import (
            tree_leaves_with_path)
        want = dict(tree_leaves_with_path(params, ""))
        got = dict(tree_leaves_with_path(back, ""))
        assert set(got) == set(want)
        for key in want:
            assert torch.equal(got[key], want[key]), (variant, key)
        assert torch.equal(cuda_dp.metrics_of(flat), torch.arange(8.0))
    if variant == "infogan":  # the D and Q heads share one W2d
        w2 = cuda_dp.pack_d(st["d_params"])[2]
        assert w2.shape == (cfg.hidden_dim,
                            1 + cfg.info_cat_dim + 2 * cfg.info_cont_dim)


@pytest.mark.parametrize("nb", [1, 3])
def test_gather_local_is_the_reference_s_indices(nb):
    from jax.sharding import PartitionSpec as P

    from generative_models_tpu.parallel.dp import (
        _shard_map,
        make_gather_local as jax_gather,
    )
    from generative_models_tpu.parallel.mesh import DATA_AXIS, make_mesh
    from tests.conftest import tiny_cfg
    world, n, spe = 2, 480, 4
    cfg = variant_config("nsgan", **KW)
    jcfg = tiny_cfg("nsgan")
    rng = np.random.default_rng(0)
    perm = np.stack([rng.permutation(n) for _ in range(5)]).astype(np.int32)
    rel = (np.arange(9) * nb * cfg.batch_size + 5 * cfg.batch_size).astype(
        np.int32)
    images = np.arange(n, dtype=np.float32)[:, None]
    labels = np.arange(n, dtype=np.int32)
    mesh = make_mesh(devices=jax.devices("cpu")[:world])
    jg = jax_gather(jcfg, nb, spe, world)

    def body(perm, rel):
        return jax.vmap(lambda r: jg(jnp.asarray(images),
                                     jnp.asarray(labels), perm, r)["label"])(
            rel)
    ref = np.asarray(_shard_map(body, mesh, in_specs=(P(), P()),
                                out_specs=P(None, None, DATA_AXIS))(
        jnp.asarray(perm), jnp.asarray(rel)))
    b = cfg.batch_size // world
    for rank in range(world):
        x, y = make_gather_local(cfg, nb, spe, world, rank)(
            torch.from_numpy(images), torch.from_numpy(labels).long(),
            torch.from_numpy(perm).long(), torch.from_numpy(rel).long())
        want = ref[:, :, rank * b:(rank + 1) * b]
        np.testing.assert_array_equal(y.numpy(), want)
        np.testing.assert_array_equal(x[..., 0].numpy(), want)
