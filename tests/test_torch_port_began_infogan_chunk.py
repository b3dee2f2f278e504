"""The port's chunk training for began and infogan against the JAX
package, the port's chunk path against its general step, the CLI, and
the noise grid (a step's noise a function of the run's rng words and the
global step alone).

``gan_chunk_plain`` — the CPU path of ``fused_step=True`` and the
kernel's oracle on the card — runs the same steps as the TPU kernel
``_fused_chunk_call(..., interpret=True)``, fed the same numpy-made
streams: infogan's z rows carry its codes (z ⊕ onehot(cat) ⊕ cont, padded
as ``build_fused_many_steps`` pads them) and its head is the D and Q
heads side by side; began's critic is the autoencoder and its k_t rides
in and out. Params, optimizer slots and metrics lanes 0-7 (began: the
energies, M and k_t; infogan: both MI terms) agree to rtol 2e-4 / atol
2e-5 over 4 steps, the tolerance of tests/test_torch_port_gp_chunk.py.
began's state puts G's output near 0.88 and its reconstructions near
0.12, so that no pixel ties with its reconstruction (|.| is
differentiated through its sign here, through JAX's rule in the general
step; tests/test_torch_port_began_infogan.py holds the tie itself).

``build_fused_many_steps`` against the port's general step from one
state, batches and noise, under a stream budget that forces sub-chunks:
same tolerance, and the metric keys are the reference's.

The noise grid (``train/step.py::grid_noise``): ``train(12)`` equals
``train(6)`` then ``train(6)`` bit for bit at ``scan_steps`` 4 with
sub-chunks of 2, and a run resumed from a checkpoint written at step 6
(mid-chunk) equals the uninterrupted run, on the chunk path and on the
general step.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generative_models_tpu.ops.pallas_mlp import _ru
from generative_models_tpu.ops.pallas_train import _fused_chunk_call
from generative_models_tpu_torch import cli
from generative_models_tpu_torch.config import variant_config
from generative_models_tpu_torch.losses.registry import get_variant
from generative_models_tpu_torch.ops import cuda_train
from generative_models_tpu_torch.train import step as step_lib
from generative_models_tpu_torch.train.trainer import Trainer
from generative_models_tpu_torch.utils.tree import tree_leaves

TOL = dict(rtol=2e-4, atol=2e-5)
B, Z, H, X, HD = 8, 8, 16, 24, 12
CAT, CONT = 4, 2
TWO = ("began", "infogan")


def _cfg(variant, **kw):
    return variant_config(variant, batch_size=B, hidden_dim=H, z_dim=Z,
                          image_dim=X, began_ae_hidden=HD, info_cat_dim=CAT,
                          info_cont_dim=CONT, **kw)


def _state(rng, variant):
    """Params and non-zero Adam slots (as after some training) for the 8
    tensors in the kernel's order; began's output biases shifted (module
    docstring)."""
    info = variant == "infogan"
    zin = Z + (CAT + CONT if info else 0)
    hd, out = (H, 1 + CAT + 2 * CONT) if info else (HD, X)
    p = []
    for i, o in ((zin, H), (H, X), (X, hd), (hd, out)):
        bound = 1.0 / np.sqrt(i)
        p += [rng.uniform(-bound, bound, (i, o)).astype(np.float32),
              rng.uniform(-bound, bound, (o,)).astype(np.float32)]
    if not info:
        p[3] += np.float32(2.0)
        p[7] -= np.float32(2.0)
    mu = [rng.normal(0, 1e-3, a.shape).astype(np.float32) for a in p]
    nu = [rng.uniform(0, 1e-5, a.shape).astype(np.float32) for a in p]
    return p, mu, nu


def _z_rows(rng, n, variant):
    z = rng.standard_normal((n, Z)).astype(np.float32)
    if variant != "infogan":
        return z
    return np.concatenate([
        z, np.eye(CAT, dtype=np.float32)[rng.integers(0, CAT, n)],
        rng.uniform(-1, 1, (n, CONT)).astype(np.float32)], 1)


def _jax_chunk(cfg, planes, t_g, t_d, xs, zd, zg, steps, k0):
    v = cfg.variant
    info = v == "infogan"
    bp = _ru(max(B, 8), 8)
    zin = Z + (CAT + CONT if info else 0)
    kz, kh, kx = _ru(zin, 128), _ru(H, 128), _ru(X, 128)
    khd = _ru(HD, 128) if v == "began" else kh
    kl = kx if v == "began" else 128
    shapes = [(kz, kh), kh, (kh, kx), kx, (kx, khd), khd, (khd, kl), kl]

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

    new, m = _fused_chunk_call(
        pad_rows(xs, steps, kx), pad_rows(zd, steps, kz),
        pad_rows(zg, steps, kz), jnp.zeros((8, 128), jnp.float32),
        tuple(pack(q) for q in range(8)), jnp.array([[t_g, t_d]], jnp.int32),
        jnp.array([[k0, 0.0]], jnp.float32), steps=steps, ds=1, b=B,
        dims=(zin, H, X), x_true=X, g_lr=cfg.g_lr, d_lr=cfg.d_lr,
        b1=cfg.adam_b1, b2=cfg.adam_b2, eps=cfg.adam_eps,
        slope=cfg.leaky_slope, variant=v, optimizer=cfg.optimizer, clip=0.0,
        dtype="float32", gp_lam=0.0, n_cls=0, fgan_div="", fgan_ns=False,
        fisher_rho=0.0, dh_true=HD if v == "began" else 0,
        began_gamma=cfg.began_gamma if v == "began" else 0.0,
        began_lambda_k=cfg.began_lambda_k if v == "began" else 0.0,
        q_cat=CAT if info else 0, q_cont=CONT if info else 0,
        info_lam=cfg.info_lambda if info else 0.0, interpret=True)
    out = []
    for q, t in enumerate(new):
        t = np.asarray(t)
        a = planes[0][q]
        out.append(t[:, :a.shape[0], :a.shape[1]] if a.ndim == 2
                   else t[:, 0, :a.shape[0]])
    return out, np.asarray(m)[:, :8]


@pytest.mark.parametrize("variant", TWO)
def test_gan_chunk_plain_matches_pallas_chunk(variant):
    steps = 4
    cfg = _cfg(variant)
    hp = cuda_train.ChunkHyper.from_config(cfg)
    rng = np.random.default_rng(0)
    p, mu, nu = _state(rng, variant)
    xs = rng.random((steps * B, X), dtype=np.float32)
    zd = _z_rows(rng, steps * B, variant)
    zg = _z_rows(rng, steps * B, variant)
    k0 = 0.3 if variant == "began" else 0.0
    planes = [[torch.from_numpy(a.copy()) for a in pl] for pl in (p, mu, nu)]
    m = cuda_train.gan_chunk_plain(
        torch.from_numpy(xs), torch.from_numpy(zd), torch.from_numpy(zg),
        *planes, steps=steps, ds=1, batch=B, t_g=3, t_d=5, hp=hp, lam=k0)
    new, jm = _jax_chunk(cfg, (p, mu, nu), 3, 5, xs, zd, zg, steps, k0)
    np.testing.assert_allclose(m.numpy(), jm, **TOL)
    for q in range(8):
        for i in range(3):
            np.testing.assert_allclose(planes[i][q].numpy(), new[q][i],
                                       err_msg=f"plane {i} tensor {q}", **TOL)
    if variant == "began":  # k_t moved; M and k_t in lanes 6 and 7
        assert float(m[-1, 7]) != k0 and bool((m[:, 6] > 0).all())
    else:
        assert bool((m[:, 1] > 0).all() and (m[:, 6] > 0).all())
        assert float(m[:, 2].abs().max()) == 0.0


def _data(rng, n_rows):
    return {"image": torch.from_numpy(rng.random((n_rows, X),
                                                 dtype=np.float32)),
            "label": torch.zeros(n_rows, dtype=torch.int64)}


@pytest.mark.parametrize("variant", TWO)
def test_fused_many_steps_matches_general_step(monkeypatch, variant):
    steps = 6
    cfg = _cfg(variant)
    spec = get_variant(variant)
    # a budget of two steps' streams: sub-chunks of 2
    monkeypatch.setattr(step_lib, "STREAM_BYTES_BUDGET",
                        2 * step_lib.stream_bytes_per_step(cfg))
    assert step_lib.pick_sub(steps, step_lib.stream_bytes_per_step(cfg)) == 2
    rng = np.random.default_rng(1)
    data = _data(rng, 64)
    state = step_lib.init_adversarial_state(spec, cfg,
                                            torch.Generator().manual_seed(0))
    if variant == "began":
        state["vstate"] = {"k": torch.tensor(0.3), "m": torch.tensor(0.0)}
    perm = torch.stack([torch.randperm(64) for _ in range(2)])
    rel = torch.arange(steps) * B
    gen = torch.Generator().manual_seed(2)
    z_d = step_lib.draw_z(gen, (steps, 1, B), cfg, "cpu")
    z_g = step_lib.draw_z(gen, (steps, B), cfg, "cpu")
    noise = lambda k0, n: (z_d[k0:k0 + n], z_g[k0:k0 + n])
    args = (data["image"], data["label"], perm, rel, noise)
    s_f, m_f = cuda_train.build_fused_many_steps(spec, cfg, 8)(state, *args)
    s_g, m_g = step_lib.build_many_steps(spec, cfg, 8)(state, *args)
    assert set(m_f) == set(m_g)
    for k in m_g:
        np.testing.assert_allclose(m_f[k].numpy(), m_g[k].numpy(),
                                   err_msg=k, **TOL)
    for side in ("g_params", "d_params", "g_opt", "d_opt"):
        for a, b in zip(tree_leaves(s_f[side]), tree_leaves(s_g[side])):
            np.testing.assert_allclose(a.numpy(), b.numpy(), err_msg=side,
                                       **TOL)
    assert type(s_f["d_params"]) is type(state["d_params"])
    for key, v in s_g["vstate"].items():
        np.testing.assert_allclose(float(s_f["vstate"][key]), float(v), **TOL)
    assert s_f["step"] == s_g["step"] == steps


KW = dict(batch_size=16, hidden_dim=32, z_dim=8, began_ae_hidden=24,
          latent_dim=4, vae_hidden_dim=32, scan_steps=4, sample_n=16,
          seed=0, sample_every=0)


def _budget_of_two_steps(monkeypatch, variant):
    cfg = variant_config(variant, **KW)
    spec = get_variant(variant)
    monkeypatch.setattr(step_lib, "STREAM_BYTES_BUDGET",
                        2 * step_lib.stream_bytes_per_step(cfg, spec))


def _assert_runs_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                      err_msg=k)


def _assert_states_equal(s, t):
    for key in ("g_params", "d_params", "params", "vstate"):
        if key in t:
            for a, b in zip(tree_leaves(s[key]), tree_leaves(t[key])):
                np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize("variant,fused", [
    ("nsgan", True), ("nsgan", False), ("infogan", True), ("infogan", False),
    ("dragan", True), ("vae", False), ("vae", True)])
def test_split_training_draws_the_uninterrupted_noise(monkeypatch, tiny_data,
                                                      variant, fused):
    """train(12) against train(6) + train(6) at scan_steps 4, sub-chunks
    of 2: the second call starts mid-chunk, bit for bit the same run."""
    _budget_of_two_steps(monkeypatch, variant)
    whole = Trainer(variant, device="cpu", data=tiny_data, fused_step=fused,
                    **KW)
    wh = whole.train(steps=12)
    split = Trainer(variant, device="cpu", data=tiny_data, fused_step=fused,
                    **KW)
    h1 = split.train(steps=6)
    h2 = split.train(steps=6)
    _assert_runs_equal({k: list(h1[k]) + list(h2[k]) for k in h1}, wh)
    _assert_states_equal(split.state, whole.state)


@pytest.mark.parametrize("variant,fused", [("began", True), ("began", False),
                                           ("nsgan", True)])
def test_mid_chunk_resume_continues_the_uninterrupted_run(
        monkeypatch, tiny_data, tmp_path, variant, fused):
    _budget_of_two_steps(monkeypatch, variant)
    whole = Trainer(variant, device="cpu", data=tiny_data, fused_step=fused,
                    **KW)
    wh = whole.train(steps=12)
    first = Trainer(variant, device="cpu", data=tiny_data, fused_step=fused,
                    **KW)
    h1 = first.train(steps=6)
    path = first.save_model(str(tmp_path / "ck"))
    second = Trainer(variant, device="cpu", data=tiny_data, fused_step=fused,
                     **KW)
    second.load_model(path)
    assert second.state["step"] == 6
    h2 = second.train(steps=6)
    _assert_runs_equal({k: list(h1[k]) + list(h2[k]) for k in h1}, wh)
    _assert_states_equal(second.state, whole.state)
    if variant == "began":
        assert float(second.state["vstate"]["k"]) == float(
            whole.state["vstate"]["k"]) != 0.0


def test_noise_grid_slices_blocks_by_global_step():
    rng_words = np.array([7, 0x5EED], np.uint32)
    draw = lambda gen, s: torch.randn((s, 3), generator=gen)
    n = step_lib.NOISE_BLOCK
    whole = step_lib.grid_noise(rng_words, 0, 2 * n + 5, "cpu", draw)
    for first, count in ((0, 1), (n - 2, 5), (n, n), (2 * n + 1, 4)):
        part = step_lib.grid_noise(rng_words, first, count, "cpu", draw)
        assert torch.equal(part, whole[first:first + count])
    other = step_lib.grid_noise(np.array([8, 0x5EED], np.uint32), 0, 4, "cpu",
                                draw)
    assert not torch.equal(other, whole[:4])


@pytest.mark.parametrize("variant", TWO)
def test_cli_training_resume_and_sampling(tmp_path, capsys, variant):
    ck = str(tmp_path / "ck")
    base = ["--variant", variant, "--device", "cpu", "--dataset",
            "synthetic", "--batch-size", "16",
            "--hidden-dim", "32", "--z-dim", "8", "--began-ae-hidden", "24",
            "--scan-steps", "4", "--echo-every", "0", "--out-dir",
            str(tmp_path), "--ckpt", ck, "--fused-step"]
    assert cli.main(base + ["--steps", "6"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-2])
    assert line["steps"] == 6 and line["variant"] == variant
    assert all(np.isfinite(v) for v in line["eval"].values())
    want = ({"d_loss", "began_l_real", "began_l_fake_d", "g_loss",
             "began_l_fake_g"} if variant == "began"
            else {"d_loss", "mi_loss", "g_loss", "g_mi_loss"})
    assert set(line["eval"]) == want
    with open(tmp_path / variant / "metrics.jsonl") as f:
        recs = [json.loads(l) for l in f]
    assert len(recs) == 6
    if variant == "began":
        assert all(0.0 <= r["vstate_k"] <= 1.0 and "vstate_m" in r
                   for r in recs)
    else:
        assert all(r["g_mi_loss"] > 0 for r in recs)
    assert cli.main(base + ["--steps", "2", "--resume"]) == 0
    out = capsys.readouterr().out
    assert "resumed from" in out and "at step 6" in out
    assert cli.main(base + ["--sample-only"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["step"] == 8 and line["variant"] == variant
    assert (tmp_path / variant / "samples_step000008.png").stat().st_size
