"""The port's chunk training for lsgan, wgan, fgan, ragan and fishergan
against the JAX package.

``gan_chunk_plain`` — the CPU path of ``fused_step=True`` and the
kernel's oracle on the card — runs the same steps as the TPU kernel
``_fused_chunk_call(..., interpret=True)``, fed the same numpy-made
streams (padded on the JAX side as ``build_fused_many_steps`` pads them)
and the same packed state: two planes with RMSprop, three with Adam,
fishergan's multiplier in through ``vs0`` and out through metrics lane 7.
Params, optimizer slots and all 8 metrics lanes agree to rtol 2e-4 /
atol 2e-5, the tolerance of tests/test_fused_step.py. ragan and
fishergan run at ``adam_eps = 1e-3``: the bias gradient of their critic's
head cancels exactly in mathematics, and at the default eps Adam turns
the rounding residue of that sum into steps of order lr on either side
(tests/test_fused_step.py:58-67).

``build_fused_many_steps`` against the port's general step (autograd
through the loss heads, ``train/optim.py``) from one state, batches and
noise, per variant, under a stream budget that forces sub-chunks, so
fishergan's multiplier is carried from one ``gan_chunk`` call to the
next: same tolerance, and the metric keys are the reference's.
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
B, Z, H, X = 8, 8, 16, 24


def _linear(rng, i, o):
    bound = 1.0 / np.sqrt(i)
    return (rng.uniform(-bound, bound, (i, o)).astype(np.float32),
            rng.uniform(-bound, bound, (o,)).astype(np.float32))


def _state(rng, adam):
    """Params and non-zero optimizer slots (as after some training) for
    the 8 tensors in the kernel's order."""
    p = []
    for i, o in ((Z, H), (H, X), (X, H), (H, 1)):
        w, b = _linear(rng, i, o)
        p += [w, b]
    mu = [rng.normal(0, 1e-3, a.shape).astype(np.float32) for a in p]
    nu = [rng.uniform(0, 1e-5, a.shape).astype(np.float32) for a in p]
    return p, (mu if adam else None), nu


def _streams(rng, steps, ds):
    return (rng.random((steps * ds * B, X), dtype=np.float32),
            rng.standard_normal((steps * ds * B, Z)).astype(np.float32),
            rng.standard_normal((steps * B, Z)).astype(np.float32))


def _jax_chunk(cfg, planes, t_g, t_d, lam, xs, zd, zg, steps, ds):
    bp = _ru(max(B, 8), 8)
    kz, kh, kx = _ru(Z, 128), _ru(H, 128), _ru(X, 128)
    shapes = [(kz, kh), kh, (kh, kx), kx, (kx, kh), kh, (kh, 128), 128]

    def pack(q):
        ps = [pl[q] for pl in planes]
        if isinstance(shapes[q], tuple):
            r, c = shapes[q]
            return jnp.stack([jnp.pad(a, ((0, r - a.shape[0]),
                                          (0, c - a.shape[1]))) for a in ps])
        return jnp.stack([jnp.pad(a[None, :], ((0, 7),
                                               (0, shapes[q] - a.shape[0])))
                          for a in ps])

    def pad_rows(a, groups, lanes):
        a = a.reshape(groups, B, -1)
        a = np.pad(a, ((0, 0), (0, bp - B), (0, lanes - a.shape[-1])))
        return jnp.asarray(a.reshape(groups * bp, lanes))

    v = cfg.variant
    new, m = _fused_chunk_call(
        pad_rows(xs, steps * ds, kx), pad_rows(zd, steps * ds, kz),
        pad_rows(zg, steps, kz), jnp.zeros((8, 128), jnp.float32),
        tuple(pack(q) for q in range(8)),
        jnp.array([[t_g, t_d]], jnp.int32),
        jnp.array([[lam, 0.0]], jnp.float32),
        steps=steps, ds=ds, b=B, dims=(Z, H, X), x_true=X, g_lr=cfg.g_lr,
        d_lr=cfg.d_lr, b1=cfg.adam_b1, b2=cfg.adam_b2, eps=cfg.adam_eps,
        slope=cfg.leaky_slope, variant=v, optimizer=cfg.optimizer,
        clip=cfg.wgan_clip if v == "wgan" else 0.0, dtype="float32",
        gp_lam=0.0, n_cls=0,
        fgan_div=cfg.fgan_divergence if v == "fgan" else "",
        fgan_ns=v == "fgan" and cfg.fgan_g_loss == "nonsaturating",
        fisher_rho=cfg.fisher_rho if v == "fishergan" else 0.0,
        interpret=True)
    out = []
    for q, t in enumerate(new):
        t = np.asarray(t)
        a = planes[0][q]
        out.append(t[:, :a.shape[0], :a.shape[1]] if a.ndim == 2
                   else t[:, 0, :a.shape[0]])
    return out, np.asarray(m)[:, :8]


CHUNK_CASES = [
    ("lsgan", 1, {}),
    ("wgan", 2, {}),                              # RMSprop and the clip
    ("wgan", 1, {"optimizer": "adam"}),           # Adam and the clip
    ("fgan", 1, {}),                              # jensen_shannon
    ("fgan", 1, {"fgan_divergence": "kl", "fgan_g_loss": "nonsaturating"}),
    ("fgan", 1, {"fgan_divergence": "total_variation"}),
    ("fgan", 1, {"fgan_divergence": "reverse_kl"}),
    ("fgan", 1, {"fgan_divergence": "pearson"}),
    ("fgan", 1, {"fgan_divergence": "squared_hellinger"}),
    ("fgan", 1, {"fgan_divergence": "gan"}),
    ("ragan", 1, {"adam_eps": 1e-3}),
    ("ragan", 2, {"adam_eps": 1e-3}),
    ("fishergan", 1, {"adam_eps": 1e-3, "fisher_rho": 1e-2}),
    ("fishergan", 2, {"adam_eps": 1e-3, "fisher_rho": 1e-2}),
    ("nsgan", 1, {"optimizer": "rmsprop"}),
]


@pytest.mark.parametrize("variant,ds,kw", CHUNK_CASES,
                         ids=lambda v: "-".join(map(str, v.values()))
                         if isinstance(v, dict) else str(v))
def test_gan_chunk_plain_matches_pallas_chunk(variant, ds, kw):
    steps = 4
    cfg = variant_config(variant, batch_size=B, hidden_dim=H, z_dim=Z,
                         image_dim=X, **{"d_steps": ds, **kw})
    adam = cfg.optimizer == "adam"
    rng = np.random.default_rng(3)
    p, mu, nu = _state(rng, adam)
    if variant == "wgan":  # a critic as the clip leaves it
        p = p[:4] + [np.clip(a, -cfg.wgan_clip, cfg.wgan_clip) for a in p[4:]]
    xs, zd, zg = _streams(rng, steps, ds)
    lam0 = 0.25 if variant == "fishergan" else 0.0
    planes = [p, mu, nu] if adam else [p, nu]
    want, want_m = _jax_chunk(cfg, planes, 5, 7, lam0, xs, zd, zg, steps, ds)

    tp, tmu, tnu = ([torch.from_numpy(a.copy()) for a in pl]
                    if pl is not None else None for pl in (p, mu, nu))
    got_m = cuda_train.gan_chunk(
        torch.from_numpy(xs), torch.from_numpy(zd), torch.from_numpy(zg),
        tp, tmu, tnu, steps=steps, ds=ds, batch=B, t_g=5, t_d=7,
        hp=cuda_train.ChunkHyper.from_config(cfg), lam=lam0)
    assert cuda_train.launches == 0
    assert got_m.shape == (steps, 8)
    np.testing.assert_allclose(got_m.numpy(), want_m, **TOL)
    if variant == "fishergan":
        assert abs(float(got_m[-1, 7]) - lam0) > 1e-4  # lam moved
    got = [tp, tmu, tnu] if adam else [tp, tnu]
    for q in range(8):
        for plane, t in enumerate(got):
            np.testing.assert_allclose(t[q].numpy(), want[q][plane], **TOL)
    if variant == "wgan":
        assert all(float(t.abs().max()) <= cfg.wgan_clip for t in tp[4:])


def _data(rng, n_rows):
    return {"image": torch.from_numpy(
        rng.integers(0, 256, (n_rows, X), dtype=np.uint8)),
        "label": torch.from_numpy(rng.integers(0, 10, n_rows))}


def _noise(rng, steps, ds):
    zd = torch.from_numpy(
        rng.standard_normal((steps, ds, B, Z)).astype(np.float32))
    zg = torch.from_numpy(rng.standard_normal((steps, B, Z)).astype(np.float32))
    return lambda k0, n: (zd[k0:k0 + n], zg[k0:k0 + n])


METRIC_KEYS = {
    "lsgan": {"d_loss", "d_real", "d_fake", "g_loss"},
    "wgan": {"d_loss", "w_estimate", "g_loss"},
    "fgan": {"d_loss", "f_bound", "g_loss"},
    "ragan": {"d_loss", "g_loss"},
    "fishergan": {"d_loss", "ipm", "omega", "g_loss", "constraint",
                  "vstate_lam"},
}


@pytest.mark.parametrize("variant,ds,kw", [
    ("lsgan", 1, {}), ("wgan", 5, {}),
    ("fgan", 1, {"fgan_divergence": "pearson"}),
    ("ragan", 2, {"adam_eps": 1e-3}),
    ("fishergan", 2, {"adam_eps": 1e-3, "fisher_rho": 1e-2})],
    ids=["lsgan", "wgan", "fgan", "ragan", "fishergan"])
def test_fused_many_steps_matches_general_step(monkeypatch, variant, ds, kw):
    steps = 6
    cfg = variant_config(variant, batch_size=B, hidden_dim=H, z_dim=Z,
                         image_dim=X, **{"d_steps": ds, **kw})
    spec = get_variant(variant)
    rng = np.random.default_rng(5)
    state = step_lib.init_adversarial_state(
        spec, cfg, torch.Generator().manual_seed(0))
    if variant == "fishergan":
        state["vstate"] = {"lam": torch.tensor(0.25)}
    rows_per_step = B * ds
    data = _data(rng, rows_per_step * 4)
    perm = torch.stack([torch.from_numpy(rng.permutation(rows_per_step * 4))
                        for _ in range(3)])
    rel = torch.arange(steps) * rows_per_step
    args = (data["image"], data["label"], perm, rel, _noise(rng, steps, ds))

    s_gen, m_gen = step_lib.build_many_steps(spec, cfg, 4)(state, *args)
    calls = []
    real = cuda_train.gan_chunk
    monkeypatch.setattr(
        cuda_train, "gan_chunk",
        lambda *a, **k: calls.append(float(k["lam"])) or real(*a, **k))
    monkeypatch.setattr(step_lib, "STREAM_BYTES_BUDGET",
                        2 * step_lib.stream_bytes_per_step(cfg))
    s_f, m_f = cuda_train.build_fused_many_steps(spec, cfg, 4)(state, *args)
    assert len(calls) == 3  # three sub-chunks of two steps
    assert set(m_f) == set(m_gen) == METRIC_KEYS[variant]
    for k in m_gen:
        np.testing.assert_allclose(m_f[k].numpy(), m_gen[k].numpy(), **TOL)
    for side in ("g_params", "d_params"):
        for a, b in zip(s_f[side], s_gen[side]):
            for key in ("w", "b"):
                np.testing.assert_allclose(a[key].numpy(), b[key].numpy(),
                                           **TOL)
    for side in ("g_opt", "d_opt"):
        assert set(s_f[side]) == set(s_gen[side])
        if "count" in s_gen[side]:
            assert int(s_f[side]["count"]) == int(s_gen[side]["count"])
        for slot in set(s_gen[side]) - {"count"}:
            for a, b in zip(s_f[side][slot], s_gen[side][slot]):
                for key in ("w", "b"):
                    np.testing.assert_allclose(a[key].numpy(),
                                               b[key].numpy(), **TOL)
    assert s_f["step"] == s_gen["step"] == steps
    if variant == "fishergan":
        # each sub-chunk was seeded with the multiplier the last one left
        assert calls[0] == 0.25 and calls[1] != calls[0] != calls[2]
        np.testing.assert_allclose(calls[1:], m_f["vstate_lam"].numpy()[1:-1:2],
                                   rtol=1e-6)
        np.testing.assert_allclose(float(s_f["vstate"]["lam"]),
                                   float(s_gen["vstate"]["lam"]), **TOL)
        assert float(state["vstate"]["lam"]) == 0.25  # caller's state kept
    else:
        assert s_f["vstate"] == {} and calls == [0.0] * 3
    if variant == "wgan":
        assert "mu" not in s_f["d_opt"] and "count" not in s_f["g_opt"]
        for l in s_f["d_params"]:
            assert all(float(t.abs().max()) <= cfg.wgan_clip
                       for t in l.values())
