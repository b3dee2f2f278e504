"""The fused VAE sampling kernel — the port of
``generative_models_tpu/ops/pallas_reparam.py`` (``_reparam_kernel`` with
``_fwd_impl``, and the custom VJP's ``_vjp_bwd``).

One pass over ``mu`` and ``logvar`` [B, L] draws eps ~ N(0, 1) inside
the kernel, writes ``z = mu + exp(logvar / 2) * eps`` and the row sums
``kl = -1/2 sum(1 + logvar - mu^2 - exp(logvar))``, and stores no eps.

The TPU kernel reads its chip's hardware generator. Here the noise is
Philox4x32-10, a counter-based generator written out in the kernel
(``csrc/reparam.cu``) and, with torch integer ops, in
:func:`philox_normal_plain`: key = the call's two seed words, counter =
(row, column pair, offset low, offset high). Each counter gives four
words and so two normals (columns 2g and 2g + 1): two uniforms by the
[1, 2) mantissa trick, then Box-Muller with ``log1p(-u1)``, as the TPU
kernel. The same (seed, offset) gives the same eps in both, so the
kernel's z is held against the plain version element by element.

:func:`reparam_fwd` launches the kernel on a CUDA tensor or raises, and
runs :func:`reparam_and_kl_plain` on a CPU tensor. :class:`ReparamFunction`
adds the reference's analytic backward (``pallas_reparam.py:115-121``):
:func:`reparam_bwd` launches the backward kernel on CUDA tensors and
runs :func:`reparam_bwd_plain` on CPU tensors. Both kernels take the
launch plan of :func:`launch_plan`, cached per shape and device.
``launches`` and ``bwd_launches`` count the two kernels' launches.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Tuple

import torch

SOURCE = "generative_models_tpu_torch/csrc/reparam.cu"

launches = 0
bwd_launches = 0

_M0, _M1 = 0xD2511F53, 0xCD9E8D57   # Philox4x32 multipliers
_W0, _W1 = 0x9E3779B9, 0xBB67AE85   # Philox key increments (Weyl)
_MASK = 0xFFFFFFFF
_TWO_PI = 2.0 * math.pi


# ---------------------------------------------------------------------
# Plain version
# ---------------------------------------------------------------------

def _mulhilo(m: int, a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(high, low) 32-bit words of m * a, for a 32-bit constant m and
    32-bit values held in int64. The product is taken in 16-bit halves
    of a, so no int64 intermediate overflows."""
    lo16 = m * (a & 0xFFFF)
    hi16 = m * (a >> 16)
    low = (lo16 + ((hi16 & 0xFFFF) << 16)) & _MASK
    high = (hi16 + (lo16 >> 16)) >> 16
    return high, low


def _philox4x32(c0, c1, c2, c3, k0, k1):
    """Ten rounds of Philox4x32 on int64 tensors holding 32-bit words."""
    for r in range(10):
        if r:
            k0 = (k0 + _W0) & _MASK
            k1 = (k1 + _W1) & _MASK
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def _uniform(bits: torch.Tensor) -> torch.Tensor:
    """32-bit words -> U[0, 1): the top 23 bits as the mantissa of a
    float32 in [1, 2), minus 1."""
    one_to_two = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return one_to_two - 1.0


def _box_muller(u1, u2):
    # 1 - u1 in (0, 1] keeps the log finite
    return torch.sqrt(-2.0 * torch.log1p(-u1)) * torch.cos(_TWO_PI * u2)


def _seed_words(seed, device) -> torch.Tensor:
    s = torch.as_tensor(seed, dtype=torch.int64, device=device)
    if s.shape != (2,):
        raise ValueError(f"seed must hold two words, got shape {tuple(s.shape)}")
    return s & _MASK


def philox_normal_plain(seed, offset: int, shape, device="cpu") -> torch.Tensor:
    """The eps [B, L] the kernel draws for (`seed`, `offset`): `seed` two
    32-bit words (ints or an int64 tensor [2]), `offset` the call's
    64-bit counter offset."""
    return philox_normal_steps(seed, offset, 1, shape, device)[0]


def philox_normal_steps(seed, offset: int, steps: int, shape,
                        device="cpu") -> torch.Tensor:
    """[steps, B, L]: step k's rows are the eps :func:`philox_normal_plain`
    draws at counter offset `offset` + k (the counter of an element:
    its row, its column pair and the offset's two words), all steps in
    one call."""
    b, l = shape
    s = _seed_words(seed, device)
    groups = (l + 1) // 2
    full = (steps, b, groups)
    row = torch.arange(b, dtype=torch.int64, device=device)[None, :, None]
    grp = torch.arange(groups, dtype=torch.int64, device=device)[None, None]
    offs = [(int(offset) + k) % 2 ** 64 for k in range(steps)]
    c2 = torch.tensor([o & _MASK for o in offs], dtype=torch.int64,
                      device=device)[:, None, None]
    c3 = torch.tensor([o >> 32 for o in offs], dtype=torch.int64,
                      device=device)[:, None, None]
    w0, w1, w2, w3 = _philox4x32(row.expand(full), grp.expand(full),
                                 c2.expand(full), c3.expand(full),
                                 s[0].expand(full), s[1].expand(full))
    even = _box_muller(_uniform(w0), _uniform(w1))
    odd = _box_muller(_uniform(w2), _uniform(w3))
    return torch.stack([even, odd], dim=-1).reshape(
        steps, b, 2 * groups)[:, :, :l]


def reparam_and_kl_plain(mu, logvar, seed, offset: int = 0):
    """The kernel's function in plain PyTorch: ``(z [B, L], kl [B])``."""
    eps = philox_normal_plain(seed, offset, tuple(mu.shape), mu.device)
    z = mu + torch.exp(0.5 * logvar) * eps
    kl = -0.5 * torch.sum(1.0 + logvar - mu * mu - torch.exp(logvar), dim=-1)
    return z, kl


def reparam_bwd_plain(mu, logvar, z, dz, dkl):
    """The backward kernel's function in plain PyTorch, the reference's
    ``_vjp_bwd``: ``(dmu, dlogvar)`` from the residuals (mu, logvar, z)
    and the cotangents dz [B, L], dkl [B]."""
    dmu = dz + dkl[:, None] * mu
    dlogvar = dz * 0.5 * (z - mu) - dkl[:, None] * 0.5 * (
        1.0 - torch.exp(logvar))
    return dmu, dlogvar


# ---------------------------------------------------------------------
# The kernels
# ---------------------------------------------------------------------

MAX_THREADS = 256   # csrc/reparam.cu RP_MAX_THREADS


def launch_plan(b: int, l: int, sms: int) -> Tuple[int, int, int]:
    """``(rows, threads, blocks)`` of both kernels at [b, l] on a card of
    `sms` SMs: a thread a column pair, a block `rows` whole rows. At most
    b // sms rows a block, so that the grid reaches every SM (b < sms:
    a block a row), and at most as many as fit one pass of MAX_THREADS
    threads; a row of more pairs than that is a block of its own, whose
    threads loop over it. `threads` is the block's pairs rounded up to
    whole warps."""
    g = (l + 1) // 2
    if g >= MAX_THREADS:
        return 1, MAX_THREADS, b
    rows = max(1, min(MAX_THREADS // g, b // sms))
    return rows, -(-rows * g // 32) * 32, -(-b // rows)


_plans = {}   # (b, l, device index) -> launch_plan(...)


def _plan(b: int, l: int, dev: torch.device) -> Tuple[int, int, int]:
    key = (b, l, dev.index)
    plan = _plans.get(key)
    if plan is None:
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        plan = _plans[key] = launch_plan(b, l, sms)
    return plan


@functools.cache
def _lib():
    from generative_models_tpu_torch.ops.build import build_library
    lib = build_library("reparam", ["reparam.cu"])
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.gm_reparam.argtypes = [p, p, p, p, p, i, i, i, i, i,
                               ctypes.c_ulonglong, p]
    lib.gm_reparam.restype = i
    lib.gm_reparam_bwd.argtypes = [p, p, ctypes.c_longlong, p, p, p, p, p,
                                   i, i, i, i, i, p]
    lib.gm_reparam_bwd.restype = i
    return lib


def build() -> None:
    """Compile (or load) the kernels' library now instead of at first use."""
    _lib()


def _check(what: str, *named) -> None:
    dev = named[0][1].device
    for name, t in named:
        if t.dtype != torch.float32 or t.device != dev:
            raise TypeError(f"{what} takes float32 tensors on one device; "
                            f"{name} is {t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on cuda or cpu tensors, not {dev}")


def _run(entry, dev: torch.device, *args) -> None:
    """Call a launch entry on the current stream of `dev`; raises on a
    refused launch."""
    stream = torch.cuda.current_stream(dev).cuda_stream
    if dev.index == torch.cuda.current_device():
        rc = entry(*args, stream)
    else:
        with torch.cuda.device(dev):
            rc = entry(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{entry.__name__} kernel launch failed: CUDA "
                           f"error {rc}")


def _aligned(*ts) -> bool:
    return all(t.data_ptr() % 8 == 0 for t in ts)


def reparam_fwd(mu, logvar, seed, offset: int = 0):
    """``(z, kl)`` for float32 ``mu``, ``logvar`` [B, L] with the noise of
    (`seed`, `offset`); `seed` is two 32-bit words, ints or an int64
    tensor [2] (on the inputs' device the kernel reads it where it lies;
    it takes the low 32 bits of each word). CPU tensors run
    :func:`reparam_and_kl_plain`; CUDA tensors launch the kernel on the
    current stream or raise."""
    global launches
    if mu.dim() != 2 or mu.shape != logvar.shape:
        raise ValueError(f"mu and logvar must be [B, L] alike, got "
                         f"{tuple(mu.shape)} and {tuple(logvar.shape)}")
    _check("reparam", ("mu", mu), ("logvar", logvar))
    if mu.device.type == "cpu":
        return reparam_and_kl_plain(mu, logvar, seed, offset)
    dev = mu.device
    b, l = mu.shape
    z = torch.empty_like(mu)
    kl = torch.empty((b,), dtype=torch.float32, device=dev)
    if b == 0:
        return z, kl
    if not (isinstance(seed, torch.Tensor) and seed.device == dev
            and seed.dtype == torch.int64 and seed.shape == (2,)
            and seed.is_contiguous()):
        seed = _seed_words(seed, dev)   # a host value: one copy
    rows, threads, _ = _plan(b, l, dev)
    _run(_lib().gm_reparam, dev, mu.data_ptr(), logvar.data_ptr(),
         seed.data_ptr(), z.data_ptr(), kl.data_ptr(), b, l, rows, threads,
         int(l % 2 == 0 and _aligned(mu, logvar)), int(offset) % 2 ** 64)
    launches += 1
    return z, kl


def reparam_bwd(mu, logvar, z, dz, dkl):
    """``(dmu, dlogvar)``: :func:`reparam_bwd_plain`'s function, run by it
    on CPU tensors and by the backward kernel on CUDA tensors (the
    current stream) or raises. `dkl` [B] may have any stride (a mean's
    cotangent is one value expanded)."""
    global bwd_launches
    if dz.shape != mu.shape or dkl.shape != mu.shape[:1]:
        raise ValueError(f"reparam backward: dz {tuple(dz.shape)} and dkl "
                         f"{tuple(dkl.shape)} do not fit mu "
                         f"{tuple(mu.shape)}")
    dz = dz.contiguous()
    _check("reparam backward", ("mu", mu), ("logvar", logvar), ("z", z),
           ("dz", dz))
    if dkl.dtype != torch.float32 or dkl.device != mu.device:
        raise TypeError(f"reparam backward: dkl is {dkl.dtype} on "
                        f"{dkl.device}")
    if mu.device.type == "cpu":
        return reparam_bwd_plain(mu, logvar, z, dz, dkl)
    dev = mu.device
    b, l = mu.shape
    dmu = torch.empty_like(mu)
    dlv = torch.empty_like(mu)
    if b == 0:
        return dmu, dlv
    rows, threads, _ = _plan(b, l, dev)
    _run(_lib().gm_reparam_bwd, dev, dz.data_ptr(), dkl.data_ptr(),
         dkl.stride(0), mu.data_ptr(), logvar.data_ptr(), z.data_ptr(),
         dmu.data_ptr(), dlv.data_ptr(), b, l, rows, threads,
         int(l % 2 == 0 and _aligned(dz, mu, logvar, z)))
    bwd_launches += 1
    return dmu, dlv


class ReparamFunction(torch.autograd.Function):
    """:func:`reparam_fwd` with the reference's analytic backward
    (:func:`reparam_bwd`), eps frozen by the residuals (mu, logvar, z):

        dz/dmu = 1            dz/dlogvar = (z - mu) / 2
        dkl/dmu = mu          dkl/dlogvar = -(1 - exp(logvar)) / 2

    ``ReparamFunction.apply(mu, logvar, seed, offset) -> (z, kl)``."""

    @staticmethod
    def forward(ctx, mu, logvar, seed, offset):
        z, kl = reparam_fwd(mu, logvar, seed, offset)
        ctx.save_for_backward(mu, logvar, z)
        return z, kl

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dz, dkl):
        mu, logvar, z = ctx.saved_tensors
        return (*reparam_bwd(mu, logvar, z, dz, dkl), None, None)
