"""Sample grids and loss plots — the port of
``generative_models_tpu/utils/viz.py``: ``save_image_grid`` with its
stdlib-only PNG encoder, and ``plot_losses`` (matplotlib when present,
else a CSV)."""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np


def _write_png_gray(path: str, img: np.ndarray) -> None:
    """img: [H, W] uint8."""
    h, w = img.shape
    raw = b"".join(b"\x00" + img[i].tobytes() for i in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data +
                struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0)  # 8-bit grayscale
    png = (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
           + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(png)


def save_image_grid(path: str, images, nrow: int = 8, pad: int = 2,
                    image_hw=(28, 28)) -> str:
    """images: [N, H*W] or [N, H, W], values in [0, 1]. Arranges them into
    a grid like torchvision.utils.make_grid and writes a PNG."""
    x = np.asarray(images, dtype=np.float32)
    n = x.shape[0]
    h, w = image_hw
    x = x.reshape(n, h, w)
    ncol = nrow
    nrows = (n + ncol - 1) // ncol
    grid = np.zeros((nrows * (h + pad) + pad, ncol * (w + pad) + pad),
                    dtype=np.float32)
    for i in range(n):
        r, c = divmod(i, ncol)
        r0 = pad + r * (h + pad)
        c0 = pad + c * (w + pad)
        grid[r0:r0 + h, c0:c0 + w] = x[i]
    img = (np.clip(grid, 0.0, 1.0) * 255).astype(np.uint8)
    _write_png_gray(path, img)
    return path


def plot_losses(path: str, history: dict, keys=None) -> str:
    """Loss curves (the reference's ``viz_loss``). Uses matplotlib when it
    is installed, else writes a CSV next to `path` and returns that."""
    keys = keys or [k for k in history
                    if k == "loss" or k.endswith("_loss")]
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        csv_path = os.path.splitext(path)[0] + ".csv"
        os.makedirs(os.path.dirname(csv_path) or ".", exist_ok=True)
        with open(csv_path, "w") as f:
            f.write(",".join(keys) + "\n")
            for row in zip(*(history[k] for k in keys)):
                f.write(",".join(str(v) for v in row) + "\n")
        return csv_path
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig, ax = plt.subplots(figsize=(7, 4))
    for k in keys:
        ax.plot(history[k], label=k, linewidth=1)
    ax.set_xlabel("step")
    ax.set_ylabel("loss")
    ax.legend()
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path
