"""Each plain reference against the port's plain path at a small size on
the CPU, from the same weights and draws, and the frozen yardstick
against the figures it was frozen at. The tests import the port; the
references may not."""

import os

import numpy as np
import pytest
import torch

from harness import cells, draw, roofline

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NSGAN = cells.load_module(os.path.join(BENCH, "reference", "nsgan-mlp.py"))
DDPM = cells.load_module(os.path.join(BENCH, "reference", "ddpm-mlp.py"))
from reference import order  # noqa: E402

SEED = 2 ** 31 + 4099
GAN = dict(z_dim=8, hidden_dim=24, image_dim=784, leaky_slope=0.2,
           g_hidden_act="relu", d_hidden_act="leaky_relu", optimizer="adam",
           g_lr=2e-4, d_lr=2e-4, adam_b1=0.9, adam_b2=0.999, adam_eps=1e-8,
           d_steps=1, dtype="float32", batch_size=16, scan_steps=5)
TRAIN_DRIVER = cells.load_module(os.path.join(BENCH, "drivers", "train.py"))
# 320 rows in batches of 16: epochs of 20 steps; epoch 16 and noise
# block 5 open together at step 320
LATE = TRAIN_DRIVER.check_start(320, 16, 1)


def test_the_checked_steps_cross_an_epoch_and_a_noise_block():
    assert TRAIN_DRIVER.check_start(60_000, 100, 1) == 4798
    assert LATE == 318
    for rows, b in ((60_000, 100), (320, 16), (60_000, 1024)):
        s = TRAIN_DRIVER.check_start(rows, b, 1) + 2
        assert s % (rows // b) == 0 and s % order.NOISE_BLOCK == 0


def _gan_trainer(tmp_path, fused, c=GAN, rows=320, step=0):
    from generative_models_tpu_torch.config import variant_config
    from generative_models_tpu_torch.train.trainer import Trainer
    data = draw.split(SEED, rows, 32, c["image_dim"], 10, "cpu")
    w = draw.weights(NSGAN.leaves(c), SEED, "cpu")
    words = draw.rng_words(SEED)
    ck = draw.write_checkpoint(str(tmp_path / "w.npz"), w, words, step)
    cfg = variant_config("nsgan", seed=SEED, fused_step=fused,
                         out_dir=str(tmp_path / "runs"), **c)
    t = Trainer(config=cfg, device="cpu", data=data)
    t.load_model(ck)
    return t, w, words, data


def test_order_is_the_trainers_rows_and_noise(tmp_path):
    from generative_models_tpu_torch.train import step as step_lib
    c = dict(GAN, batch_size=16)
    t, _, words, _ = _gan_trainer(tmp_path, True, c, rows=100)
    t._load_data()
    n = t.x_train.shape[0]
    perm = t._perm_window(0, 3)
    for s in (0, 5, 6, 13):  # 6 steps an epoch: 6 and 13 cross epochs
        want = perm.reshape(-1)[(s // 6) * n + (s % 6) * 16:][:16]
        got = order.step_rows(SEED, s, 16, 1, n, "cpu")
        assert torch.equal(got[0], want), s
    for s in (0, 63, 64, 130):
        z_d, z_g = step_lib.chunk_noise(t.spec, t.cfg, words, s, 1, "cpu",
                                        True)
        r_d, r_g = order.gan_noise(words, s, 1, 16, c["z_dim"], "cpu")
        assert torch.equal(z_d[0], r_d) and torch.equal(z_g[0], r_g)


@pytest.mark.parametrize("first_step", [0, LATE])
@pytest.mark.parametrize("fused", [True, False], ids=["chunk", "general"])
def test_nsgan_reference_follows_the_ports_plain_steps(tmp_path, fused,
                                                       first_step):
    t, w, words, data = _gan_trainer(tmp_path, fused, step=first_step)
    hist = t.train(steps=1)
    h2 = t.train(steps=2)  # from LATE: across the epoch and the block
    hist = {k: list(hist[k]) + list(h2[k]) for k in ("d_loss", "g_loss")}
    x = torch.from_numpy(data["x_train"])
    losses, first, after, _ = NSGAN.train(w, x, SEED, words, 3, GAN, 16,
                                       first_step)
    for k in ("d_loss", "g_loss"):
        np.testing.assert_allclose(hist[k], [l[k == "g_loss"]
                                             for l in losses], rtol=2e-5)
    from generative_models_tpu_torch.utils.checkpoint import state_leaves
    got = dict(state_leaves(t.state))
    for k, v in after.items():
        torch.testing.assert_close(got[k], v, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("first_step", [0, LATE])
def test_nsgan_reference_gradients_are_the_ports(tmp_path, first_step):
    t, w, words, data = _gan_trainer(tmp_path, True, step=first_step)
    t.train(steps=1)
    from generative_models_tpu_torch.utils.checkpoint import state_leaves
    mu = {p.replace("_opt'][0].mu", "_params']"): v
          for p, v in state_leaves(t.state) if ".mu" in p}
    _, first, _, _ = NSGAN.train(w, torch.from_numpy(data["x_train"]), SEED,
                              words, 1, GAN, 16, first_step)
    assert set(mu) == set(first)
    for k, g in first.items():
        torch.testing.assert_close(mu[k] / (1 - GAN["adam_b1"]), g,
                                   rtol=1e-4, atol=1e-7)


DIFF = dict(image_dim=784, hidden_dim=32, ddpm_time_dim=16,
            ddpm_timesteps=1000, ddpm_beta_start=1e-4, ddpm_beta_end=0.02,
            ddpm_schedule="linear", ddpm_eta=1.0, ddpm_cond=False,
            ema_decay=0.999, dtype="float32", arch="mlp")


@pytest.mark.parametrize("steps", [50, 20, 1000])
def test_ddpm_schedule_is_the_ports(steps):
    from generative_models_tpu_torch.config import variant_config
    from generative_models_tpu_torch.losses import ddpm
    ts, ab, abp = DDPM.schedule(DIFF, steps)
    pts, pab, pabp = ddpm.sample_schedule(variant_config(
        "ddpm", ddpm_sample_steps=steps))
    assert np.array_equal(ts, pts)
    np.testing.assert_allclose(ab, pab, rtol=2e-6)
    np.testing.assert_allclose(abp, pabp, rtol=2e-6)


@pytest.mark.parametrize("eta", [1.0, 0.0])
def test_ddpm_reference_samples_the_ports_images(tmp_path, eta):
    from generative_models_tpu_torch.config import variant_config
    from generative_models_tpu_torch.train.trainer import Trainer
    c = dict(DIFF, ddpm_eta=eta)
    w = draw.weights(DDPM.leaves(c), SEED, "cpu")
    ck = draw.write_checkpoint(str(tmp_path / "w.npz"), w,
                               draw.rng_words(SEED))
    t = Trainer(config=variant_config("ddpm", seed=SEED, ddpm_sample_steps=50,
                                      **c), device="cpu")
    t.load_model(ck)
    noise = draw.RequestNoise(SEED, 40, 784, "cpu")
    got = t.sample(z=noise.initial(3), chain=noise.chain(3))
    want = DDPM.sample(w, noise.initial(3), noise.chain(3), c, 50)
    assert float((torch.from_numpy(got) - want).abs().max()) < 2e-5
    # the EMA is what sampling reads: the live weights give other images
    live = {k.replace("['params']", "['ema']"): v for k, v in w.items()
            if k.startswith("['params']")}
    other = DDPM.sample({**w, **live}, noise.initial(3), noise.chain(3), c,
                        50)
    assert float((other - want).abs().max()) > 1e-2


def test_the_frozen_yardstick_reads_its_figures():
    assert roofline.chunk_flops_per_step(100) == 658_320_000
    t, what = roofline.chunk_bound(1000, 100)
    assert what == "operations" and abs(t / 1000 - 9.826e-6) < 1e-9
    c = dict(DIFF, hidden_dim=400, ddpm_time_dim=128)
    rows = 2 * (784 * 400 + 400 * 400 + 400 * 784 + 784 * 784)
    assert rows == 2_803_712  # 2.80 MFLOP a row a step
    assert DDPM.flops_per_image(c, 10_000, 50) == pytest.approx(
        50 * (rows + 270_336 / 10_000))
    assert NSGAN.flops_per_step(dict(GAN, z_dim=128, hidden_dim=400),
                                100) == 658_320_000


def test_the_control_rounds_as_tf32():
    from reference.float32 import tf32_round
    x = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -11 + 2 ** -20,
                      -3.0 - 2 ** -12], dtype=torch.float32)
    want = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -10, -3.0])
    assert torch.equal(tf32_round(x), want)
