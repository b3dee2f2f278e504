"""The port's chunk training (kernel #5, nsgan/mmgan) against the JAX
package.

``gan_chunk_plain`` — the CPU path of ``fused_step=True`` and the
kernel's oracle on the card — runs the same 8 steps as the TPU kernel
``_fused_chunk_call(..., interpret=True)``, fed the same numpy-made
streams (padded on the JAX side as ``build_fused_many_steps`` pads them)
and the same packed state. Params, mu, nu and the metrics rows (all 8
lanes) agree to rtol 2e-4 / atol 2e-5, the tolerance of
tests/test_fused_step.py. The other variants' cases are in
tests/test_torch_port_heads_chunk.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generative_models_tpu.ops.pallas_mlp import _ru
from generative_models_tpu.ops.pallas_train import _fused_chunk_call
from generative_models_tpu_torch.config import variant_config
from generative_models_tpu_torch.losses.registry import get_variant
from generative_models_tpu_torch.ops import cuda_train
from generative_models_tpu_torch.train import step as step_lib

TOL = dict(rtol=2e-4, atol=2e-5)
STEPS = 8


def _linear(rng, i, o):
    bound = 1.0 / np.sqrt(i)
    return (rng.uniform(-bound, bound, (i, o)).astype(np.float32),
            rng.uniform(-bound, bound, (o,)).astype(np.float32))


def _state(rng, z, h, x):
    """Params and non-zero Adam slots (as after some training) for the 8
    tensors in the kernel's order, plus the two Adam counts."""
    p = []
    for i, o in ((z, h), (h, x), (x, h), (h, 1)):
        w, b = _linear(rng, i, o)
        p += [w, b]
    mu = [rng.normal(0, 1e-3, a.shape).astype(np.float32) for a in p]
    nu = [rng.uniform(0, 1e-5, a.shape).astype(np.float32) for a in p]
    return p, mu, nu, 5, 7


def _streams(rng, steps, ds, b, z, x):
    return (rng.random((steps * ds * b, x), dtype=np.float32),
            rng.standard_normal((steps * ds * b, z)).astype(np.float32),
            rng.standard_normal((steps * b, z)).astype(np.float32))


def _jax_chunk(cfg, p, mu, nu, t_g, t_d, xs, zd, zg, steps, ds):
    b, z, h, x = cfg.batch_size, cfg.z_dim, cfg.hidden_dim, cfg.image_dim
    bp = _ru(max(b, 8), 8)
    kz, kh, kx = _ru(z, 128), _ru(h, 128), _ru(x, 128)
    shapes = [(kz, kh), kh, (kh, kx), kx, (kx, kh), kh, (kh, 128), 128]

    def pack(q):
        planes = [a[q] for a in (p, mu, nu)]
        if isinstance(shapes[q], tuple):
            r, c = shapes[q]
            return jnp.stack([jnp.pad(a, ((0, r - a.shape[0]),
                                          (0, c - a.shape[1])))
                              for a in planes])
        return jnp.stack([jnp.pad(a[None, :], ((0, 7),
                                               (0, shapes[q] - a.shape[0])))
                          for a in planes])

    def pad_rows(a, groups, lanes):
        a = a.reshape(groups, b, -1)
        a = np.pad(a, ((0, 0), (0, bp - b), (0, lanes - a.shape[-1])))
        return jnp.asarray(a.reshape(groups * bp, lanes))

    new, m = _fused_chunk_call(
        pad_rows(xs, steps * ds, kx), pad_rows(zd, steps * ds, kz),
        pad_rows(zg, steps, kz), jnp.zeros((8, 128), jnp.float32),
        tuple(pack(q) for q in range(8)),
        jnp.array([[t_g, t_d]], jnp.int32), jnp.zeros((1, 2), jnp.float32),
        steps=steps, ds=ds, b=b, dims=(z, h, x), x_true=x, g_lr=cfg.g_lr,
        d_lr=cfg.d_lr, b1=cfg.adam_b1, b2=cfg.adam_b2, eps=cfg.adam_eps,
        slope=cfg.leaky_slope, variant=cfg.variant, optimizer="adam",
        clip=0.0, dtype="float32", gp_lam=0.0, n_cls=0, fgan_div="",
        fgan_ns=False, fisher_rho=0.0, interpret=True)
    out = []
    for q, t in enumerate(new):
        t = np.asarray(t)
        if isinstance(shapes[q], tuple):
            out.append(t[:, :p[q].shape[0], :p[q].shape[1]])
        else:
            out.append(t[:, 0, :p[q].shape[0]])
    return out, np.asarray(m)[:, :8]


@pytest.mark.parametrize("variant,ds", [("nsgan", 1), ("mmgan", 1),
                                        ("nsgan", 2)])
def test_gan_chunk_plain_matches_pallas_chunk(variant, ds):
    cfg = variant_config(variant, batch_size=16, hidden_dim=32, z_dim=8,
                         d_steps=ds)
    rng = np.random.default_rng(3)
    p, mu, nu, t_g, t_d = _state(rng, 8, 32, 784)
    xs, zd, zg = _streams(rng, STEPS, ds, 16, 8, 784)
    want, want_m = _jax_chunk(cfg, p, mu, nu, t_g, t_d, xs, zd, zg, STEPS, ds)

    tp, tmu, tnu = ([torch.from_numpy(a.copy()) for a in planes]
                    for planes in (p, mu, nu))
    got_m = cuda_train.gan_chunk(
        torch.from_numpy(xs), torch.from_numpy(zd), torch.from_numpy(zg),
        tp, tmu, tnu, steps=STEPS, ds=ds, batch=16, t_g=t_g, t_d=t_d,
        hp=cuda_train.ChunkHyper.from_config(cfg))
    assert cuda_train.launches == 0
    np.testing.assert_allclose(got_m.numpy(), want_m, **TOL)
    for q in range(8):
        for plane, t in enumerate((tp, tmu, tnu)):
            np.testing.assert_allclose(t[q].numpy(), want[q][plane], **TOL)


def _data(rng, n_rows):
    return {"image": torch.from_numpy(
        rng.integers(0, 256, (n_rows, 784), dtype=np.uint8)),
        "label": torch.from_numpy(rng.integers(0, 10, n_rows))}


def _noise(rng, steps, ds, b, z):
    zd = torch.from_numpy(
        rng.standard_normal((steps, ds, b, z)).astype(np.float32))
    zg = torch.from_numpy(rng.standard_normal((steps, b, z)).astype(np.float32))
    return lambda k0, n: (zd[k0:k0 + n], zg[k0:k0 + n])


@pytest.mark.parametrize("variant,ds", [("nsgan", 1), ("mmgan", 2)])
def test_fused_many_steps_matches_general_step(variant, ds):
    """The chunk builder and the general step (torch autograd through the
    plain MLP path, optax-convention Adam) train the same trajectory from
    the same state, batches (across an epoch boundary) and noise."""
    cfg = variant_config(variant, batch_size=16, hidden_dim=32, z_dim=8,
                         d_steps=ds)
    spec = get_variant(variant)
    rng = np.random.default_rng(5)
    state = step_lib.init_adversarial_state(
        spec, cfg, torch.Generator().manual_seed(0))
    rows_per_step = 16 * ds
    data = _data(rng, rows_per_step * 4)
    perm = torch.stack([torch.from_numpy(rng.permutation(rows_per_step * 4))
                        for _ in range(3)])
    rel = torch.arange(STEPS) * rows_per_step
    noise = _noise(rng, STEPS, ds, 16, 8)
    args = (data["image"], data["label"], perm, rel, noise)

    s_gen, m_gen = step_lib.build_many_steps(spec, cfg, 4)(state, *args)
    s_f, m_f = cuda_train.build_fused_many_steps(spec, cfg, 4)(state, *args)
    assert set(m_f) == set(m_gen) == {"d_loss", "d_real", "d_fake", "g_loss"}
    for k in m_gen:
        np.testing.assert_allclose(m_f[k].numpy(), m_gen[k].numpy(), **TOL)
    for side in ("g_params", "d_params"):
        for a, b in zip(s_f[side], s_gen[side]):
            for key in ("w", "b"):
                np.testing.assert_allclose(a[key].numpy(), b[key].numpy(),
                                           **TOL)
    for side in ("g_opt", "d_opt"):
        assert int(s_f[side]["count"]) == int(s_gen[side]["count"])
        for slot in ("mu", "nu"):
            for a, b in zip(s_f[side][slot], s_gen[side][slot]):
                for key in ("w", "b"):
                    np.testing.assert_allclose(a[key].numpy(),
                                               b[key].numpy(), **TOL)
    assert s_f["step"] == s_gen["step"] == STEPS
    # the caller's state is left as it was
    assert int(state["g_opt"]["count"]) == 0 and state["step"] == 0


def test_sub_chunks_cover_the_chunk(monkeypatch):
    """Under a small stream budget the chunk runs as sub-chunks (one
    gan_chunk call each) and gives the same result as one call."""
    cfg = variant_config("nsgan", batch_size=16, hidden_dim=32, z_dim=8)
    spec = get_variant("nsgan")
    rng = np.random.default_rng(6)
    state = step_lib.init_adversarial_state(
        spec, cfg, torch.Generator().manual_seed(1))
    data = _data(rng, 64)
    perm = torch.stack([torch.from_numpy(rng.permutation(64))
                        for _ in range(3)])
    args = (data["image"], data["label"], perm, torch.arange(6) * 16,
            _noise(rng, 6, 1, 16, 8))
    many = cuda_train.build_fused_many_steps(spec, cfg, 4)
    whole_state, whole = many(state, *args)
    calls = []
    real = cuda_train.gan_chunk
    monkeypatch.setattr(cuda_train, "gan_chunk",
                        lambda *a, **k: calls.append(k["steps"]) or real(*a, **k))
    monkeypatch.setattr(step_lib, "STREAM_BYTES_BUDGET",
                        2 * step_lib.stream_bytes_per_step(cfg))
    split_state, split = many(state, *args)
    assert calls == [2, 2, 2]
    for k in whole:
        np.testing.assert_array_equal(split[k].numpy(), whole[k].numpy())
    assert torch.equal(split_state["g_params"][1]["w"],
                       whole_state["g_params"][1]["w"])


def test_pick_sub_matches_jax():
    from generative_models_tpu.ops.pallas_train import _pick_sub
    for steps, per in ((1000, 416_000), (16000, 416_000), (7, 10 ** 9),
                       (12, 2 ** 29)):
        assert step_lib.pick_sub(steps, per) == _pick_sub(steps, per)


@pytest.mark.parametrize("overrides,supported", [
    ({}, True), ({"variant": "mmgan"}, True), ({"d_steps": 3}, True),
    ({"variant": "wgan"}, True), ({"ema_decay": 0.5}, False),
    ({"dtype": "bfloat16"}, False), ({"optimizer": "rmsprop"}, True),
    ({"g_hidden_act": "tanh"}, False), ({"arch": "conv"}, False),
    ({"variant": "lsgan"}, True), ({"variant": "fgan"}, True),
    ({"variant": "ragan"}, True), ({"variant": "fishergan"}, True),
    ({"variant": "wgan", "optimizer": "adam", "d_steps": 2}, True),
    ({"variant": "fishergan", "optimizer": "rmsprop"}, True),
    ({"variant": "wgangp"}, False), ({"variant": "dragan"}, False),
    ({"variant": "cgan"}, False), ({"variant": "began"}, False),
    ({"variant": "infogan"}, False),
    ({"variant": "ragan", "ema_decay": 0.5}, False),
    ({"variant": "wgan", "dtype": "bfloat16"}, False),
    ({"variant": "vae", "optimizer": "rmsprop"}, False),
])
def test_fused_step_supported(overrides, supported):
    variant = overrides.pop("variant", "nsgan")
    cfg = variant_config(variant, **overrides)
    ok, reason = cuda_train.fused_step_supported(None, cfg)
    assert ok == supported
    if not supported and (variant in ("wgangp", "dragan", "cgan", "began",
                                      "infogan")
                          or "ema_decay" in overrides or "dtype" in overrides):
        assert "ROADMAP.md Queue 2 item 6" in reason


def test_resolve_fused_step():
    cfg = variant_config("nsgan")
    assert cuda_train.resolve_fused_step(None, cfg, "cuda")
    assert not cuda_train.resolve_fused_step(None, cfg, "cpu")
    assert cuda_train.resolve_fused_step(None, cfg.replace(fused_step=True),
                                         "cpu")
    assert not cuda_train.resolve_fused_step(
        None, cfg.replace(fused_step=False), "cuda")
    assert not cuda_train.resolve_fused_step(
        None, cfg.replace(ema_decay=0.5), "cuda")
    # "auto" takes the chunk kernel wherever it is supported: no list of
    # variants measured on another device is carried over
    for v in ("lsgan", "wgan", "fgan", "ragan", "fishergan"):
        assert cuda_train.resolve_fused_step(None, variant_config(v), "cuda")
        assert not cuda_train.resolve_fused_step(None, variant_config(v),
                                                 "cpu")
    for v in ("wgangp", "dragan", "cgan", "began", "infogan"):
        assert not cuda_train.resolve_fused_step(None, variant_config(v),
                                                 "cuda")
