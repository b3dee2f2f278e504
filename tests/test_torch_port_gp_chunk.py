"""The port's chunk training for wgangp, dragan and cgan against the JAX
package, and cgan's checkpoints both ways.

``gan_chunk_plain`` — the CPU path of ``fused_step=True`` and the
kernel's oracle on the card — runs the same steps as the TPU kernel
``_fused_chunk_call(..., interpret=True)``, fed the same numpy-made
streams: for wgangp the ``xtra`` stream's eps in lane 0, for dragan the
perturbed real rows x_hat, for cgan the x and z rows with their one-hot
labels (the G rows with the last critic batch's), padded on the JAX side
as ``build_fused_many_steps`` pads them. Params, optimizer slots and
metrics lanes 0-5 (lanes 4 and 5: the penalty and the mean input
gradient norm) agree to rtol 2e-4 / atol 2e-5 over 4 steps, the tolerance
of tests/test_torch_port_heads_chunk.py.

``build_fused_many_steps`` against the port's general step (autograd
through the loss heads and the plain double backward) from one state,
batches, labels and noise, under a stream budget that forces sub-chunks:
same tolerance, and the metric keys are the reference's.

A cgan checkpoint (G in z + 10 lanes, D in 784 + 10) written by the port
restores into the JAX Trainer, leaf by leaf, and one written by the JAX
Trainer into the port; each trains on from it.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generative_models_tpu.ops.pallas_mlp import _ru
from generative_models_tpu.ops.pallas_train import _fused_chunk_call
from generative_models_tpu.train.trainer import Trainer as JaxTrainer
from generative_models_tpu_torch import cli
from generative_models_tpu_torch.config import variant_config
from generative_models_tpu_torch.losses.registry import get_variant
from generative_models_tpu_torch.ops import cuda_train
from generative_models_tpu_torch.train import step as step_lib
from generative_models_tpu_torch.train.trainer import Trainer

TOL = dict(rtol=2e-4, atol=2e-5)
B, Z, H, X, N_CLS = 8, 8, 16, 24, 3


def _cfg(variant, **kw):
    if variant == "cgan":
        kw["num_classes"] = N_CLS
    return variant_config(variant, batch_size=B, hidden_dim=H, z_dim=Z,
                          image_dim=X, **kw)


def _state(rng, n_cls):
    """Params and non-zero Adam slots (as after some training) for the 8
    tensors in the kernel's order."""
    p = []
    for i, o in ((Z + n_cls, H), (H, X), (X + n_cls, H), (H, 1)):
        bound = 1.0 / np.sqrt(i)
        p += [rng.uniform(-bound, bound, (i, o)).astype(np.float32),
              rng.uniform(-bound, bound, (o,)).astype(np.float32)]
    mu = [rng.normal(0, 1e-3, a.shape).astype(np.float32) for a in p]
    nu = [rng.uniform(0, 1e-5, a.shape).astype(np.float32) for a in p]
    return p, mu, nu


def _streams(rng, variant, steps, ds, n_cls):
    rows = steps * ds * B
    xs = rng.random((rows, X), dtype=np.float32)
    zd = rng.standard_normal((rows, Z)).astype(np.float32)
    zg = rng.standard_normal((steps * B, Z)).astype(np.float32)
    xtra = None
    if variant == "wgangp":
        xtra = rng.random((rows, 1), dtype=np.float32)
    elif variant == "dragan":
        xb = xs.reshape(steps * ds, B, X)
        u = rng.random(xb.shape, dtype=np.float32)
        xtra = (xb + np.float32(0.5) * xb.std(axis=(1, 2), keepdims=True)
                * u).reshape(rows, X).astype(np.float32)
    if n_cls:
        y = np.eye(n_cls, dtype=np.float32)[rng.integers(0, n_cls, rows)]
        xs = np.concatenate([xs, y], 1)
        zd = np.concatenate([zd, y], 1)
        zg = np.concatenate(
            [zg, y.reshape(steps, ds, B, n_cls)[:, -1].reshape(-1, n_cls)], 1)
    return xs, zd, zg, xtra


def _jax_chunk(cfg, planes, t_g, t_d, xs, zd, zg, xtra, steps, ds, n_cls):
    bp = _ru(max(B, 8), 8)
    zin, xin = Z + n_cls, X + n_cls
    kz, kh, kx = _ru(zin, 128), _ru(H, 128), _ru(xin, 128)
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
    if xtra is None:
        jx = jnp.zeros((8, 128), jnp.float32)
    else:
        jx = pad_rows(xtra, steps * ds, 128 if v == "wgangp" else kx)
    new, m = _fused_chunk_call(
        pad_rows(xs, steps * ds, kx), pad_rows(zd, steps * ds, kz),
        pad_rows(zg, steps, kz), jx, tuple(pack(q) for q in range(8)),
        jnp.array([[t_g, t_d]], jnp.int32), jnp.zeros((1, 2), jnp.float32),
        steps=steps, ds=ds, b=B, dims=(zin, H, xin), x_true=X, g_lr=cfg.g_lr,
        d_lr=cfg.d_lr, b1=cfg.adam_b1, b2=cfg.adam_b2, eps=cfg.adam_eps,
        slope=cfg.leaky_slope, variant=v, optimizer=cfg.optimizer, clip=0.0,
        dtype="float32",
        gp_lam=cfg.gp_lambda if v in ("wgangp", "dragan") else 0.0,
        n_cls=n_cls, fgan_div="", fgan_ns=False, fisher_rho=0.0,
        interpret=True)
    out = []
    for q, t in enumerate(new):
        t = np.asarray(t)
        a = planes[0][q]
        out.append(t[:, :a.shape[0], :a.shape[1]] if a.ndim == 2
                   else t[:, 0, :a.shape[0]])
    return out, np.asarray(m)[:, :8]


@pytest.mark.parametrize("variant,ds", [("wgangp", 2), ("dragan", 1),
                                        ("cgan", 1)])
def test_gan_chunk_plain_matches_pallas_chunk(variant, ds):
    steps = 4
    cfg = _cfg(variant, d_steps=ds)
    hp = cuda_train.ChunkHyper.from_config(cfg)
    n_cls = hp.n_cls
    assert n_cls == (N_CLS if variant == "cgan" else 0)
    assert hp.gp_lam == (10.0 if variant != "cgan" else 0.0)
    rng = np.random.default_rng(3)
    p, mu, nu = _state(rng, n_cls)
    xs, zd, zg, xtra = _streams(rng, variant, steps, ds, n_cls)
    want, want_m = _jax_chunk(cfg, [p, mu, nu], 5, 7, xs, zd, zg, xtra,
                              steps, ds, n_cls)

    tp, tmu, tnu = ([torch.from_numpy(a.copy()) for a in pl]
                    for pl in (p, mu, nu))
    got_m = cuda_train.gan_chunk(
        torch.from_numpy(xs), torch.from_numpy(zd), torch.from_numpy(zg),
        tp, tmu, tnu, steps=steps, ds=ds, batch=B, t_g=5, t_d=7, hp=hp,
        xtra=None if xtra is None else torch.from_numpy(xtra))
    assert cuda_train.launches == 0
    assert got_m.shape == (steps, 8)
    np.testing.assert_allclose(got_m.numpy(), want_m, **TOL)
    if variant != "cgan":  # the penalty's lanes are live
        assert (got_m[:, 4] > 0).all() and (got_m[:, 5] > 0).all()
    for q in range(8):
        for plane, t in enumerate((tp, tmu, tnu)):
            np.testing.assert_allclose(t[q].numpy(), want[q][plane], **TOL)


def test_gan_chunk_checks_the_new_streams():
    cfg = _cfg("cgan")
    hp = cuda_train.ChunkHyper.from_config(cfg)
    rng = np.random.default_rng(1)
    p, mu, nu = ([torch.from_numpy(a) for a in pl] for pl in _state(rng, N_CLS))
    xs, zd, zg, _ = (torch.from_numpy(a) if a is not None else None
                     for a in _streams(rng, "cgan", 1, 1, N_CLS))
    kw = dict(steps=1, ds=1, batch=B, t_g=0, t_d=0, hp=hp)
    with pytest.raises(ValueError, match="xs must be"):
        cuda_train.gan_chunk(xs[:, :X].contiguous(), zd, zg, p, mu, nu, **kw)
    with pytest.raises(ValueError, match="no xtra stream"):
        cuda_train.gan_chunk(xs, zd, zg, p, mu, nu, xtra=xs, **kw)
    whp = cuda_train.ChunkHyper.from_config(_cfg("wgangp"))
    q, m2, n2 = ([torch.from_numpy(a) for a in pl] for pl in _state(rng, 0))
    with pytest.raises(ValueError, match=r"an xtra stream \[rows, 1\]"):
        cuda_train.gan_chunk(xs[:, :X].contiguous(), zd[:, :Z].contiguous(),
                             zg[:, :Z].contiguous(), q, m2, n2,
                             **dict(kw, hp=whp))
    with pytest.raises(ValueError, match="cgan's"):
        cuda_train.ChunkHyper(1e-3, 1e-3, 0.5, 0.999, 1e-8, 0.2, "nsgan",
                              n_cls=3)


def _data(rng, n_rows):
    return {"image": torch.from_numpy(
        rng.integers(0, 256, (n_rows, X), dtype=np.uint8)),
        "label": torch.from_numpy(rng.integers(0, N_CLS, n_rows))}


@pytest.mark.parametrize("variant,ds", [("wgangp", 5), ("dragan", 1),
                                        ("cgan", 2)])
def test_fused_many_steps_matches_general_step(monkeypatch, variant, ds):
    steps = 6
    cfg = _cfg(variant, d_steps=ds)
    spec = get_variant(variant)
    rng = np.random.default_rng(5)
    state = step_lib.init_adversarial_state(
        spec, cfg, torch.Generator().manual_seed(0))
    rows_per_step = B * ds
    data = _data(rng, rows_per_step * 4)
    perm = torch.stack([torch.from_numpy(rng.permutation(rows_per_step * 4))
                        for _ in range(3)])
    rel = torch.arange(steps) * rows_per_step
    drawn = [torch.from_numpy(rng.standard_normal(
        (steps, ds, B, Z)).astype(np.float32)),
        torch.from_numpy(rng.standard_normal((steps, B, Z)).astype(np.float32))]
    lanes = {"wgangp": 1, "dragan": X}.get(variant, 0)
    if lanes:
        drawn.append(torch.from_numpy(rng.random((steps, ds, B, lanes),
                                                 dtype=np.float32)))
    noise = lambda k0, n: tuple(t[k0:k0 + n] for t in drawn)
    args = (data["image"], data["label"], perm, rel, noise)

    s_gen, m_gen = step_lib.build_many_steps(spec, cfg, 4)(state, *args)
    calls = []
    real = cuda_train.gan_chunk
    monkeypatch.setattr(
        cuda_train, "gan_chunk",
        lambda *a, **k: calls.append(k["xtra"]) or real(*a, **k))
    monkeypatch.setattr(step_lib, "STREAM_BYTES_BUDGET",
                        2 * step_lib.stream_bytes_per_step(cfg))
    s_f, m_f = cuda_train.build_fused_many_steps(spec, cfg, 4)(state, *args)
    assert len(calls) == 3  # three sub-chunks of two steps
    assert all((c is None) == (lanes == 0) for c in calls)
    keys = {"wgangp": {"d_loss", "w_estimate", "gp", "grad_norm", "g_loss"},
            "dragan": {"d_loss", "gp", "grad_norm", "g_loss"},
            "cgan": {"d_loss", "d_real", "d_fake", "g_loss"}}[variant]
    assert set(m_f) == set(m_gen) == keys
    for k in m_gen:
        np.testing.assert_allclose(m_f[k].numpy(), m_gen[k].numpy(),
                                   err_msg=k, **TOL)
    for side in ("g_params", "d_params", "g_opt", "d_opt"):
        a, b = s_f[side], s_gen[side]
        for slot in (("params",) if side.endswith("params")
                     else ("mu", "nu")):
            la = a if slot == "params" else a[slot]
            lb = b if slot == "params" else b[slot]
            for x, y in zip(la, lb):
                for key in ("w", "b"):
                    np.testing.assert_allclose(x[key].numpy(),
                                               y[key].numpy(), **TOL)
    assert int(s_f["d_opt"]["count"]) == int(s_gen["d_opt"]["count"])
    assert s_f["step"] == s_gen["step"] == steps
    if variant == "cgan":  # the label lanes: G 8 + 3 in, D 24 + 3 in
        assert tuple(s_f["g_params"][0]["w"].shape) == (Z + N_CLS, H)
        assert tuple(s_f["d_params"][0]["w"].shape) == (X + N_CLS, H)


KW = dict(batch_size=16, hidden_dim=32, z_dim=8, scan_steps=4)


def _assert_params(port_state, jax_state):
    for side in ("g_params", "d_params"):
        for mine, theirs in zip(port_state[side],
                                jax.tree.map(np.asarray, jax_state[side])):
            for k in ("w", "b"):
                np.testing.assert_array_equal(np.asarray(mine[k]), theirs[k])


def test_cgan_port_checkpoint_restores_into_jax(tiny_data, tmp_path):
    t = Trainer("cgan", device="cpu", data=tiny_data, fused_step=False, **KW)
    t.train(steps=5)
    path = t.save_model(str(tmp_path / "port"))
    jt = JaxTrainer("cgan", data=tiny_data, **KW)
    jt.load_model(path)          # restore_state checks every leaf's path
    leaves = jax.tree_util.tree_leaves_with_path(jt.state)
    with np.load(path) as z:
        meta = json.loads(str(z["__meta__"]))
        assert [m["path"] for m in meta] == [
            jax.tree_util.keystr(p) for p, _ in leaves]
        for i, (_, leaf) in enumerate(leaves):
            np.testing.assert_array_equal(np.asarray(leaf), z[f"leaf_{i:05d}"])
    shapes = {m["path"]: m["shape"] for m in meta}
    assert shapes["['g_params'][0]['w']"] == [8 + 10, 32]
    assert shapes["['d_params'][0]['w']"] == [784 + 10, 32]
    assert int(jt.state["step"]) == 5
    _assert_params(t.state, jt.state)
    jh = jt.train(steps=4)        # the JAX Trainer trains on from it
    assert int(jt.state["step"]) == 9
    assert all(np.isfinite(v).all() for v in jh.values())


def test_cgan_jax_checkpoint_restores_into_the_port(tiny_data, tmp_path):
    jt = JaxTrainer("cgan", data=tiny_data, **KW)
    jt.train(steps=6)
    path = jt.save_model(str(tmp_path / "jax"))
    t = Trainer("cgan", device="cpu", data=tiny_data, **KW)
    t.load_model(path)
    assert t.state["step"] == 6
    np.testing.assert_array_equal(t.state["rng"], np.asarray(jt.state["rng"]))
    _assert_params(t.state, jt.state)
    for side in ("g_opt", "d_opt"):
        jopt = jt.state[side][0]
        assert int(t.state[side]["count"]) == int(jopt.count)
        for slot in ("mu", "nu"):
            for mine, theirs in zip(t.state[side][slot], getattr(jopt, slot)):
                for k in ("w", "b"):
                    np.testing.assert_array_equal(mine[k].numpy(),
                                                  np.asarray(theirs[k]))
    h = t.train(steps=4)          # the port trains on from the slots
    assert t.state["step"] == 10
    assert all(np.isfinite(v).all() for v in h.values())
    # a cgan checkpoint does not load into an nsgan config (no label lanes)
    with pytest.raises(ValueError, match="expects"):
        Trainer("nsgan", device="cpu", data=tiny_data, **KW).load_model(path)


@pytest.mark.parametrize("variant", ["wgangp", "dragan", "cgan"])
def test_fused_and_general_trainers_agree_and_keys_are_jax_s(tiny_data,
                                                             variant):
    """Trainer(fused_step=True) (the chunk's plain version on the CPU) and
    the general step train the same trajectory from the Trainer's own
    noise (the penalty's draw after z_d, before z_g); the metric and
    evaluation keys are the reference's."""
    runs = {}
    for fused in (True, False):
        t = Trainer(variant, device="cpu", data=tiny_data, fused_step=fused,
                    **KW)
        runs[fused] = (t, t.train(steps=8))
    (tf, hf), (tg, hg) = runs[True], runs[False]
    jt = JaxTrainer(variant, data=tiny_data, **KW)
    jh = jt.train(steps=4)
    assert set(hf) == set(hg) == set(jh)
    for k in hf:
        np.testing.assert_allclose(hf[k], hg[k], err_msg=k, **TOL)
    for side in ("g_params", "d_params"):
        for a, b in zip(tf.state[side], tg.state[side]):
            for k in ("w", "b"):
                np.testing.assert_allclose(a[k].numpy(), b[k].numpy(), **TOL)
    assert sorted(tf.evaluate("test")) == sorted(jt.evaluate("test"))


@pytest.mark.parametrize("variant", ["wgangp", "cgan"])
def test_cli_training_sampling_and_resume(tiny_data, tmp_path, capsys,
                                          variant):
    flags = ["--variant", variant, "--device", "cpu", "--dataset",
             "synthetic", "--batch-size", "16", "--hidden-dim", "32",
             "--z-dim", "8", "--scan-steps", "3", "--echo-every", "0",
             "--fused-step", "--out-dir", str(tmp_path),
             "--ckpt", str(tmp_path / "ck")]
    assert cli.main(flags + ["--steps", "6"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    line = json.loads(out[-2])
    want = {"wgangp": ["d_loss", "g_loss", "gp", "grad_norm", "w_estimate"],
            "cgan": ["d_fake", "d_loss", "d_real", "g_loss"]}
    assert line["variant"] == variant and line["steps"] == 6
    assert sorted(line["eval"]) == want[variant]
    with open(tmp_path / variant / "metrics.jsonl") as f:
        recs = [json.loads(l) for l in f]
    assert [r["step"] for r in recs] == list(range(6))
    if variant == "wgangp":
        assert all(r["gp"] > 0 and r["grad_norm"] > 0 for r in recs)
    assert cli.main(flags + ["--steps", "3", "--resume"]) == 0
    assert f"resumed from {tmp_path / 'ck'} at step 6" in \
        capsys.readouterr().out
    assert cli.main(["--variant", variant, "--device", "cpu", "--hidden-dim",
                     "32", "--z-dim", "8", "--ckpt", str(tmp_path / "ck"),
                     "--sample-only", "--out-dir", str(tmp_path)]) == 0
    served = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert served["step"] == 9 and (tmp_path / variant).exists()
