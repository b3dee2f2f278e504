"""Float32 as stated: a context in which PyTorch's products on the card
run in IEEE float32, TF32 off (or, for the control, on)."""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def strict(tf32: bool = False):
    """cuBLAS and cuDNN products in float32 (`tf32` True: in TF32, the
    precision below float32 that the control computes in); the flags as
    they were afterwards."""
    m, c = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """`t` rounded to TF32's 10 mantissa bits, to the nearest (ties
    away): the operand rounding of a TF32 product, for a device that has
    no TF32 (the CPU)."""
    bits = t.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)
