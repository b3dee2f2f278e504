"""The port's GIF writer (``utils/gif.py``) against the JAX package's
``utils/gif.py``: the same bytes for the same frames (LZW payloads that
fill and reset the 12-bit table, frames of several shapes, the delay and
hold arguments), the PNG reader on the port's own sample grids, and
``pngs_to_gif`` over the port's grids, byte for byte."""

import numpy as np
import pytest

from generative_models_tpu.utils import gif as ref
from generative_models_tpu_torch.utils import gif as port
from generative_models_tpu_torch.utils.viz import save_image_grid


@pytest.mark.parametrize("payload", [
    b"",
    b"aaaaabbbbbccccc" * 10,
    bytes(np.tile(np.arange(256, dtype=np.uint8), 30)),
    bytes((np.random.default_rng(0).random(30000) * 255).astype(np.uint8)),
])
def test_lzw_same_bytes(payload):
    assert port._lzw_encode(payload) == ref._lzw_encode(payload)


@pytest.mark.parametrize("shape,n,delay", [((50, 70), 4, 12), ((1, 1), 1, 20),
                                           ((242, 242), 3, 5)])
def test_write_gif_gray_same_bytes(tmp_path, shape, n, delay):
    rng = np.random.default_rng(1)
    frames = [(rng.random(shape) * 255).astype(np.uint8) for _ in range(n)]
    a = ref.write_gif_gray(str(tmp_path / "ref.gif"), frames, delay_cs=delay,
                           hold_last_cs=90)
    b = port.write_gif_gray(str(tmp_path / "port.gif"), frames,
                            delay_cs=delay, hold_last_cs=90)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()


def test_pngs_to_gif_same_bytes_over_the_ports_grids(tmp_path):
    rng = np.random.default_rng(2)
    pngs = [save_image_grid(str(tmp_path / f"epoch{i:03d}.png"),
                            rng.random((16, 784)).astype(np.float32))
            for i in range(3)]
    img = port.read_png_gray(pngs[0])
    assert img.dtype == np.uint8 and img.shape == (62, 242)
    np.testing.assert_array_equal(img, ref.read_png_gray(pngs[0]))
    a = ref.pngs_to_gif(pngs, str(tmp_path / "ref.gif"), delay_cs=15)
    b = port.pngs_to_gif(pngs, str(tmp_path / "sub" / "port.gif"),
                         delay_cs=15)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
    with pytest.raises(ValueError, match="no frames"):
        port.pngs_to_gif([], str(tmp_path / "none.gif"))
