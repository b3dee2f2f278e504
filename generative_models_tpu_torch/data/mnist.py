"""MNIST loaders with the hermetic procedural fallback — the port of
``generative_models_tpu/data/mnist.py`` (numpy only, so the port keeps
its own copy: it imports nothing of the JAX package).

Search order, as in the reference: ``<data_dir>/mnist.npz``, the keras
cache ``~/.keras/datasets/mnist.npz``, the torchvision/IDX layout under
``<data_dir>``, then the deterministic seven-segment stand-in
(:func:`synthetic_mnist`), loudly warned about. Every loader returns
``{"x_train": uint8 [N,28,28], "y_train", "x_test", "y_test"}``;
:func:`to_flat_float` gives the trainer's float32 [N, 784] in [0, 1].
:func:`synthetic_mnist` is bit-identical to the reference's for the same
seed and sizes (tests/test_torch_port_data.py).
"""

from __future__ import annotations

import gzip
import os
import struct
import warnings
from typing import Dict, Tuple

import numpy as np

# Seven-segment layout on the 28x28 canvas (thickness 3):
#        --a--
#       f     b
#        --g--
#       e     c
#        --d--
_SEGMENTS: Dict[str, Tuple[slice, slice]] = {
    "a": (slice(4, 7), slice(9, 20)),
    "b": (slice(5, 15), slice(18, 21)),
    "c": (slice(14, 24), slice(18, 21)),
    "d": (slice(22, 25), slice(9, 20)),
    "e": (slice(14, 24), slice(8, 11)),
    "f": (slice(5, 15), slice(8, 11)),
    "g": (slice(13, 16), slice(9, 20)),
}

_DIGIT_SEGS = {
    0: "abcdef", 1: "bc", 2: "abged", 3: "abgcd", 4: "fgbc",
    5: "afgcd", 6: "afgedc", 7: "abc", 8: "abcdefg", 9: "abcfgd",
}

_MAX_SHIFT = 3


def _glyphs() -> np.ndarray:
    """The ten base glyphs, float32 [10, 28, 28] in {0, 1}."""
    g = np.zeros((10, 28, 28), dtype=np.float32)
    for d, segs in _DIGIT_SEGS.items():
        for s in segs:
            rs, cs = _SEGMENTS[s]
            g[d, rs, cs] = 1.0
    return g


def _shift_bank(glyphs: np.ndarray) -> np.ndarray:
    """Every integer translation of every glyph: [10, 2S+1, 2S+1, 28, 28]."""
    k = 2 * _MAX_SHIFT + 1
    bank = np.empty((10, k, k, 28, 28), dtype=np.float32)
    for iy, dy in enumerate(range(-_MAX_SHIFT, _MAX_SHIFT + 1)):
        for ix, dx in enumerate(range(-_MAX_SHIFT, _MAX_SHIFT + 1)):
            bank[:, iy, ix] = np.roll(
                np.roll(glyphs, dy, axis=1), dx, axis=2)
    return bank


def _render_split(n: int, rng: np.random.Generator,
                  bank: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    # exactly class-balanced labels; the draws are in the reference's
    # order, so the same seed gives the same bytes
    reps = -(-n // 10)
    y = rng.permutation(np.tile(np.arange(10, dtype=np.int64), reps))[:n]
    dy = rng.integers(0, 2 * _MAX_SHIFT + 1, size=n)
    dx = rng.integers(0, 2 * _MAX_SHIFT + 1, size=n)
    imgs = bank[y, dy, dx]
    amp = rng.uniform(0.65, 1.0, size=(n, 1, 1)).astype(np.float32)
    bg = rng.uniform(0.0, 0.35, size=(n, 1, 1)).astype(np.float32)
    noise = rng.normal(0.0, 0.08, size=imgs.shape).astype(np.float32)
    x = np.clip(imgs * amp * (1.0 - bg) + bg + noise, 0.0, 1.0)
    return np.round(x * 255.0).astype(np.uint8), y


def synthetic_mnist(n_train: int = 60000, n_test: int = 10000,
                    seed: int = 0) -> Dict[str, np.ndarray]:
    """Deterministic procedural digit dataset (the no-network fallback)."""
    rng = np.random.default_rng(seed)
    bank = _shift_bank(_glyphs())
    x_train, y_train = _render_split(n_train, rng, bank)
    x_test, y_test = _render_split(n_test, rng, bank)
    return {"x_train": x_train, "y_train": y_train,
            "x_test": x_test, "y_test": y_test}


def _read_idx(path: str) -> np.ndarray:
    """Parse one IDX (MNIST raw) file, gzipped or not."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        _, dtype_code, ndim = struct.unpack(">HBB", f.read(4))
        if dtype_code != 0x08:  # uint8, the only type MNIST uses
            raise ValueError(f"{path}: unsupported IDX dtype {dtype_code:#x}")
        dims = struct.unpack(f">{ndim}I", f.read(4 * ndim))
        return np.frombuffer(f.read(), dtype=np.uint8).reshape(dims)


_IDX_NAMES = {
    "x_train": "train-images-idx3-ubyte",
    "y_train": "train-labels-idx1-ubyte",
    "x_test": "t10k-images-idx3-ubyte",
    "y_test": "t10k-labels-idx1-ubyte",
}
_SPLITS = ("x_train", "y_train", "x_test", "y_test")


def _try_npz(path: str):
    if not os.path.isfile(path):
        return None
    with np.load(path) as z:
        if set(_SPLITS) <= set(z.files):
            return {k: z[k] for k in _SPLITS}
    return None


def _try_idx(root: str):
    for sub in (os.path.join(root, "MNIST", "raw"), root):
        out = {}
        for key, base in _IDX_NAMES.items():
            for name in (base, base + ".gz"):
                p = os.path.join(sub, name)
                if os.path.isfile(p):
                    out[key] = _read_idx(p)
                    break
        if len(out) == 4:
            return out
    return None


def load_mnist(data_dir: str = "data", allow_synthetic: bool = False,
               synthetic_sizes: Tuple[int, int] = (60000, 10000),
               seed: int = 0) -> Dict[str, np.ndarray]:
    """Load MNIST from disk; optionally fall back to the procedural
    stand-in, with a warning."""
    for npz in (os.path.join(data_dir, "mnist.npz"),
                os.path.expanduser("~/.keras/datasets/mnist.npz")):
        found = _try_npz(npz)
        if found is not None:
            return found
    found = _try_idx(data_dir)
    if found is not None:
        return found
    if not allow_synthetic:
        raise FileNotFoundError(
            f"MNIST not found under {data_dir!r} (tried mnist.npz, keras "
            f"cache, IDX layouts) and allow_synthetic=False")
    warnings.warn(
        "MNIST not found on disk and no network egress: using the "
        "deterministic procedural seven-segment stand-in "
        "(synthetic_mnist). Drop mnist.npz or IDX files into "
        f"{data_dir!r} to train on real MNIST.", stacklevel=2)
    return synthetic_mnist(*synthetic_sizes, seed=seed)


def load_dataset(cfg) -> Dict[str, np.ndarray]:
    """Config-driven entry point used by the Trainer."""
    if cfg.dataset == "synthetic":
        return synthetic_mnist(seed=cfg.seed)
    if cfg.dataset != "mnist":
        raise ValueError(f"unknown dataset {cfg.dataset!r}")
    return load_mnist(cfg.data_dir, allow_synthetic=True, seed=cfg.seed)


# u8 -> [0, 1] float32 as a MULTIPLY by this constant, on the host and
# on the device alike, so uint8-resident storage decodes bit-identically
# to host-converted float storage (a divide differs by 1 ulp).
INV_255 = np.float32(1.0 / 255.0)


def to_flat_float(data: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Trainer-form arrays: images float32 [N, 784] in [0, 1], labels
    int32. Integer pixels are scaled by dtype (0-255); float pixels are
    taken as already in model scale. Extra splits (x_val/y_val) pass
    through with the same treatment."""
    out: Dict[str, np.ndarray] = {}
    for k, v in data.items():
        v = np.asarray(v)
        if k.startswith("x"):
            if np.issubdtype(v.dtype, np.integer):
                x = v.astype(np.float32) * INV_255
            else:
                x = v.astype(np.float32)
            out[k] = x.reshape(x.shape[0], -1)
        else:
            out[k] = v.astype(np.int32)
    return out
