"""Animated training GIFs — the port of
``generative_models_tpu/utils/gif.py``, stdlib and numpy only.

The per-epoch sample grids are grayscale PNGs written by
``utils/viz.py``; :func:`read_png_gray` reads that format back (filter 0
on every row, one zlib stream) and :func:`pngs_to_gif` stitches such
frames into a looping GIF89a with the hand-rolled LZW encoder
:func:`_lzw_encode`. For the same frames it writes the same bytes as the
reference.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import List, Sequence

import numpy as np


def read_png_gray(path: str) -> np.ndarray:
    """Read an 8-bit grayscale PNG written by utils/viz.py::_write_png_gray
    (filter 0 on every row, single zlib stream)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG")
    pos = 8
    w = h = None
    idat = b""
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        if tag == b"IHDR":
            w, h, depth, color = struct.unpack(">IIBB", body[:10])
            if depth != 8 or color != 0:
                raise ValueError(f"{path}: not 8-bit grayscale")
        elif tag == b"IDAT":
            idat += body
        pos += 12 + length
    raw = zlib.decompress(idat)
    rows = np.frombuffer(raw, np.uint8).reshape(h, w + 1)
    if np.any(rows[:, 0] != 0):
        raise ValueError(f"{path}: unsupported PNG row filter")
    return rows[:, 1:].copy()


def _lzw_encode(data: bytes, min_code_size: int = 8) -> bytes:
    """GIF-flavor LZW: variable code width starting min+1 bits,
    clear/reset when the 12-bit table fills, LSB-first bit packing."""
    clear = 1 << min_code_size
    end = clear + 1
    out = bytearray()
    acc = 0
    nbits = 0

    def fresh():
        return ({bytes([i]): i for i in range(clear)}, end + 1,
                min_code_size + 1, 1 << (min_code_size + 1))

    table, next_code, code_size, limit = fresh()

    def emit(code, width):
        nonlocal acc, nbits
        acc |= code << nbits
        nbits += width
        while nbits >= 8:
            out.append(acc & 0xFF)
            acc >>= 8
            nbits -= 8

    emit(clear, code_size)
    w = b""
    for byte in data:
        wc = w + bytes([byte])
        if wc in table:
            w = wc
            continue
        emit(table[w], code_size)
        if next_code == 4096:  # 12-bit table full: reset
            emit(clear, code_size)
            table, next_code, code_size, limit = fresh()
        else:
            table[wc] = next_code
            next_code += 1
            # width grows once a code == limit exists (decoders lag one
            # entry, so this is exactly when they grow too)
            if next_code == limit + 1 and code_size < 12:
                code_size += 1
                limit <<= 1
        w = bytes([byte])
    if w:
        emit(table[w], code_size)
    emit(end, code_size)
    if nbits:
        out.append(acc & 0xFF)
    return bytes(out)


def _blocks(payload: bytes) -> bytes:
    """GIF data sub-blocks: <=255-byte chunks, zero terminator."""
    out = bytearray()
    for i in range(0, len(payload), 255):
        chunk = payload[i:i + 255]
        out.append(len(chunk))
        out += chunk
    out.append(0)
    return bytes(out)


def write_gif_gray(path: str, frames: Sequence[np.ndarray],
                   delay_cs: int = 20, loop: int = 0,
                   hold_last_cs: int = 150) -> str:
    """frames: list of [H, W] uint8 (all same shape). delay in
    centiseconds; loop=0 means forever; the final frame holds longer so
    the converged samples register before the loop restarts."""
    frames = [np.asarray(f, np.uint8) for f in frames]
    h, w = frames[0].shape
    buf = bytearray()
    buf += b"GIF89a"
    buf += struct.pack("<HHBBB", w, h, 0xF7, 0, 0)  # global 256-color table
    buf += bytes(v for g in range(256) for v in (g, g, g))
    # NETSCAPE looping extension
    buf += b"\x21\xFF\x0BNETSCAPE2.0\x03\x01" + struct.pack("<H", loop) + b"\x00"
    for i, fr in enumerate(frames):
        if fr.shape != (h, w):
            raise ValueError("all frames must share one shape")
        d = hold_last_cs if i == len(frames) - 1 else delay_cs
        buf += b"\x21\xF9\x04\x00" + struct.pack("<H", d) + b"\x00\x00"
        buf += b"\x2C" + struct.pack("<HHHHB", 0, 0, w, h, 0)
        buf += bytes([8]) + _blocks(_lzw_encode(fr.tobytes(), 8))
    buf += b"\x3B"
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(bytes(buf))
    return path


def pngs_to_gif(png_paths: List[str], out_path: str,
                delay_cs: int = 20) -> str:
    """Stitch per-epoch grid PNGs (our own format) into a training GIF."""
    if not png_paths:
        raise ValueError("no frames")
    return write_gif_gray(out_path, [read_png_gray(p) for p in png_paths],
                          delay_cs=delay_cs)
