"""The port's data path against the JAX package's: the synthetic digits,
the loaders, the uint8 decode and the epoch-permutation gather are
bit-identical."""

import gzip
import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generative_models_tpu.data import mnist as jmnist
from generative_models_tpu.data import pipeline as jpipe
from generative_models_tpu.train.step import decode_images as jax_decode
from generative_models_tpu.train.trainer import Trainer as JaxTrainer
from generative_models_tpu_torch.config import variant_config
from generative_models_tpu_torch.data import mnist, pipeline
from generative_models_tpu_torch.train import step as step_lib
from generative_models_tpu_torch.train.trainer import Trainer


@pytest.mark.parametrize("seed,n_train,n_test", [(0, 300, 50), (7, 1001, 13)])
def test_synthetic_mnist_is_bit_identical(seed, n_train, n_test):
    mine = mnist.synthetic_mnist(n_train, n_test, seed=seed)
    theirs = jmnist.synthetic_mnist(n_train, n_test, seed=seed)
    assert sorted(mine) == sorted(theirs)
    for k in mine:
        assert mine[k].dtype == theirs[k].dtype
        np.testing.assert_array_equal(mine[k], theirs[k])


def _write_idx(path, arr):
    with gzip.open(path, "wb") as f:
        f.write(struct.pack(">HBB", 0, 0x08, arr.ndim))
        f.write(struct.pack(f">{arr.ndim}I", *arr.shape))
        f.write(arr.astype(np.uint8).tobytes())


@pytest.mark.parametrize("layout", ["npz", "idx"])
def test_load_mnist_reads_the_same_files(tmp_path, layout):
    d = jmnist.synthetic_mnist(40, 10, seed=3)
    if layout == "npz":
        np.savez(tmp_path / "mnist.npz", **d)
    else:
        raw = tmp_path / "MNIST" / "raw"
        raw.mkdir(parents=True)
        for key, base in mnist._IDX_NAMES.items():
            _write_idx(str(raw / (base + ".gz")), d[key])
    mine = mnist.load_mnist(str(tmp_path))
    theirs = jmnist.load_mnist(str(tmp_path))
    for k in ("x_train", "y_train", "x_test", "y_test"):
        np.testing.assert_array_equal(mine[k], theirs[k])


def test_load_dataset_falls_back_loudly(tmp_path):
    cfg = variant_config("nsgan", data_dir=str(tmp_path), seed=2)
    with pytest.raises(FileNotFoundError):
        mnist.load_mnist(str(tmp_path))
    with pytest.warns(UserWarning, match="synthetic"):
        got = mnist.load_mnist(str(tmp_path), allow_synthetic=True,
                               synthetic_sizes=(20, 10), seed=2)
    np.testing.assert_array_equal(
        got["x_train"], jmnist.synthetic_mnist(20, 10, seed=2)["x_train"])
    assert mnist.load_dataset(cfg.replace(dataset="synthetic"))[
        "x_train"].shape == (60000, 28, 28)
    with pytest.raises(ValueError, match="unknown dataset"):
        mnist.load_dataset(cfg.replace(dataset="cifar"))


def test_to_flat_float_and_decodes_are_bit_identical():
    d = jmnist.synthetic_mnist(64, 16, seed=1)
    d["x_val"] = d["x_test"][:4].astype(np.float64) / 300.0  # float: as is
    d["y_val"] = d["y_test"][:4]
    mine, theirs = mnist.to_flat_float(d), jmnist.to_flat_float(d)
    assert sorted(mine) == sorted(theirs)
    for k in mine:
        assert mine[k].dtype == theirs[k].dtype
        np.testing.assert_array_equal(mine[k], theirs[k])
    assert mnist.INV_255 == jmnist.INV_255
    u8 = d["x_train"].reshape(64, -1)
    dev = step_lib.decode_images(torch.from_numpy(u8)).numpy()
    np.testing.assert_array_equal(dev, np.asarray(jax_decode(jnp.asarray(u8))))
    np.testing.assert_array_equal(dev, mine["x_train"])
    np.testing.assert_array_equal(Trainer._decode_host(u8),
                                  JaxTrainer._decode_host(u8))
    f32 = mine["x_train"]
    np.testing.assert_array_equal(
        step_lib.decode_images(torch.from_numpy(f32)).numpy(), f32)


def test_gather_batch_matches_jax():
    rng = np.random.default_rng(0)
    images = rng.random((50, 784), dtype=np.float32)
    labels = rng.integers(0, 10, 50).astype(np.int32)
    perm = rng.permutation(50)
    mine = pipeline.gather_batch(
        pipeline.DeviceData(torch.from_numpy(images),
                            torch.from_numpy(labels)),
        torch.from_numpy(perm), 12, 16)
    theirs = jpipe.gather_batch(
        jpipe.DeviceData(jnp.asarray(images), jnp.asarray(labels)),
        jnp.asarray(perm), 12, 16)
    np.testing.assert_array_equal(mine["image"].numpy(), theirs["image"])
    np.testing.assert_array_equal(mine["label"].numpy(), theirs["label"])


def test_make_perm_is_a_seeded_permutation():
    a = pipeline.make_perm(torch.Generator().manual_seed(4), 97)
    b = pipeline.make_perm(torch.Generator().manual_seed(4), 97)
    assert torch.equal(a, b)
    assert sorted(a.tolist()) == list(range(97))


def test_chunk_gather_walks_the_permutation_stack_as_jax():
    """gather_streams reads step k's rows at perm_stack[e, r:r+rows] with
    (e, r) = divmod(rel_offsets[k], rows_per_epoch), across an epoch
    boundary, as train/step.py's gather; uint8 rows are decoded."""
    rng = np.random.default_rng(1)
    n, b, ds, spe = 70, 8, 2, 4            # 64 rows an epoch, 6 dropped
    rows_per_step, rows_per_epoch = b * ds, b * ds * spe
    images = rng.integers(0, 256, (n, 784)).astype(np.uint8)
    labels = rng.integers(0, 10, n).astype(np.int32)
    stack = np.stack([rng.permutation(n) for _ in range(3)])
    rel = np.arange(2, 9) * rows_per_step   # steps 2..8: crosses an epoch
    x, y = step_lib.gather_streams(
        torch.from_numpy(images), torch.from_numpy(labels),
        torch.from_numpy(stack), torch.from_numpy(rel), rows_per_step,
        rows_per_epoch)
    assert x.shape == (7, rows_per_step, 784) and x.dtype == torch.float32
    data = jpipe.DeviceData(jnp.asarray(images), jnp.asarray(labels))
    for k, off in enumerate(rel):
        e, r = divmod(int(off), rows_per_epoch)
        want = jpipe.gather_batch(data, jnp.asarray(stack[e]), r,
                                  rows_per_step)
        np.testing.assert_array_equal(
            x[k].numpy(), np.asarray(jax_decode(want["image"])))
        np.testing.assert_array_equal(y[k].numpy(), want["label"])
