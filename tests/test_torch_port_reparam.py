"""The port's VAE sampling path (kernel #4) against the JAX package.

- the plain formulas against ``reparameterize_xla`` / ``kl_gaussian_xla``
  on the same numpy inputs and noise: rtol 1e-5 / atol 1e-6 (one exp and
  a 20-term sum in float32 on both sides);
- the analytic backward of ``ReparamFunction`` against the reference's
  ``_vjp_bwd`` on the same residuals and cotangents: rtol 1e-5 / atol
  1e-6, and against torch autograd through the plain formulas with the
  reproduced eps;
- the KL of the kernel's plain version against the TPU kernel
  ``reparam_and_kl_pallas`` run under ``InterpretParams`` on the CPU, as
  tests/test_kernels.py runs it: rtol 1e-5 / atol 1e-5 (the TPU kernel
  draws other noise — none at all under the interpreter — so the port's
  z is held by the statistics of the eps it implies);
- ``philox_normal_plain``: the Philox4x32-10 known-answer vectors, the
  moments of 10^6 draws (|mean| < 5e-3, |var - 1| < 5e-3, both about
  five standard errors), reproducibility, and distinct seeds and offsets
  giving distinct streams.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generative_models_tpu.ops.pallas_reparam import (
    _vjp_bwd,
    reparam_and_kl_pallas,
)
from generative_models_tpu.ops.reparam import (
    kl_gaussian_xla,
    reparameterize_xla,
)
from generative_models_tpu_torch.ops import cuda_reparam
from generative_models_tpu_torch.ops.reparam import (
    kl_gaussian_plain,
    reparam_and_kl,
    reparameterize_plain,
)

TOL = dict(rtol=1e-5, atol=1e-6)


def _inputs(seed, b, l):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, l)).astype(np.float32),
            (rng.normal(size=(b, l)) * 0.3).astype(np.float32))


@pytest.mark.parametrize("b,l", [(16, 8), (100, 20), (37, 5)])
def test_plain_formulas_match_jax(b, l):
    mu, lv = _inputs(0, b, l)
    key = jax.random.PRNGKey(3)
    eps = np.array(jax.random.normal(key, (b, l), jnp.float32))
    z = reparameterize_plain(torch.from_numpy(mu), torch.from_numpy(lv),
                             torch.from_numpy(eps))
    kl = kl_gaussian_plain(torch.from_numpy(mu), torch.from_numpy(lv))
    np.testing.assert_allclose(
        z.numpy(), np.asarray(reparameterize_xla(jnp.asarray(mu),
                                                 jnp.asarray(lv), key)), **TOL)
    np.testing.assert_allclose(
        kl.numpy(), np.asarray(kl_gaussian_xla(jnp.asarray(mu),
                                               jnp.asarray(lv))), **TOL)
    z2, kl2 = reparam_and_kl(torch.from_numpy(mu), torch.from_numpy(lv),
                             eps=torch.from_numpy(eps))
    assert torch.equal(z2, z) and torch.equal(kl2, kl)


def test_backward_matches_the_reference_vjp():
    mu, lv = _inputs(1, 16, 8)
    rng = np.random.default_rng(2)
    dz = rng.normal(size=(16, 8)).astype(np.float32)
    dkl = rng.normal(size=(16,)).astype(np.float32)
    tm = torch.from_numpy(mu).requires_grad_(True)
    tl = torch.from_numpy(lv).requires_grad_(True)
    z, kl = cuda_reparam.ReparamFunction.apply(tm, tl, (5, 6), 0)
    gm, gl = torch.autograd.grad([z, kl], [tm, tl],
                                 [torch.from_numpy(dz), torch.from_numpy(dkl)])
    jm, jl, _ = _vjp_bwd((jnp.asarray(mu), jnp.asarray(lv),
                          jnp.asarray(z.detach().numpy())),
                         (jnp.asarray(dz), jnp.asarray(dkl)))
    np.testing.assert_allclose(gm.numpy(), np.asarray(jm), **TOL)
    np.testing.assert_allclose(gl.numpy(), np.asarray(jl), **TOL)

    # and torch autograd through the plain formulas with the same eps
    eps = cuda_reparam.philox_normal_plain((5, 6), 0, (16, 8))
    pm = torch.from_numpy(mu).requires_grad_(True)
    pl = torch.from_numpy(lv).requires_grad_(True)
    z2, kl2 = reparam_and_kl(pm, pl, eps=eps)
    np.testing.assert_allclose(z2.detach().numpy(), z.detach().numpy(), **TOL)
    am, al = torch.autograd.grad([z2, kl2], [pm, pl],
                                 [torch.from_numpy(dz), torch.from_numpy(dkl)])
    np.testing.assert_allclose(gm.numpy(), am.numpy(), **TOL)
    np.testing.assert_allclose(gl.numpy(), al.numpy(), **TOL)


def test_kl_matches_the_tpu_kernel_in_interpret_mode():
    mu, lv = _inputs(0, 50, 20)
    jz, jkl = reparam_and_kl_pallas(jnp.asarray(mu), jnp.asarray(lv),
                                    jax.random.PRNGKey(0))
    z, kl = reparam_and_kl(torch.from_numpy(mu), torch.from_numpy(lv),
                           torch.Generator().manual_seed(0))
    assert z.shape == (50, 20) and kl.shape == (50,)
    assert cuda_reparam.launches == 0
    np.testing.assert_allclose(kl.numpy(), np.asarray(jkl), rtol=1e-5,
                               atol=1e-5)
    assert jz.shape == (50, 20)
    # eps recovered from z is N(0, 1): 1000 draws, about four standard errors
    eps = (z.numpy() - mu) / np.exp(0.5 * lv)
    assert abs(eps.mean()) < 0.12 and abs(eps.var() - 1.0) < 0.2


def _philox_ref(ctr, key):
    """Philox4x32-10 in Python integers (Salmon et al. 2011)."""
    c, k = list(ctr), list(key)
    for r in range(10):
        if r:
            k = [(k[0] + 0x9E3779B9) & 0xFFFFFFFF,
                 (k[1] + 0xBB67AE85) & 0xFFFFFFFF]
        p0, p1 = 0xD2511F53 * c[0], 0xCD9E8D57 * c[2]
        c = [(p1 >> 32) ^ c[1] ^ k[0], p1 & 0xFFFFFFFF,
             (p0 >> 32) ^ c[3] ^ k[1], p0 & 0xFFFFFFFF]
    return c


def test_philox_known_answers():
    """The Random123 distribution's known-answer vectors for
    philox4x32-10, and the tensor rounds against Python integers."""
    assert _philox_ref([0, 0, 0, 0], [0, 0]) == [
        0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8]
    assert _philox_ref([0xFFFFFFFF] * 4, [0xFFFFFFFF] * 2) == [
        0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD]
    assert _philox_ref([0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344],
                       [0xA4093822, 0x299F31D0]) == [
        0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1]
    rng = np.random.default_rng(0)
    words = rng.integers(0, 2 ** 32, size=(6, 5), dtype=np.int64)
    words[:, 0] = 0xFFFFFFFF          # the carries of the widest products
    got = cuda_reparam._philox4x32(*[torch.from_numpy(w.copy())
                                     for w in words])
    for j in range(5):
        want = _philox_ref([int(words[i, j]) for i in range(4)],
                           [int(words[4, j]), int(words[5, j])])
        assert [int(g[j]) for g in got] == want


def test_philox_normal_moments_and_streams():
    eps = cuda_reparam.philox_normal_plain((123, 456), 0, (50000, 20))
    assert eps.shape == (50000, 20) and eps.dtype == torch.float32
    assert bool(torch.isfinite(eps).all())
    assert abs(float(eps.mean())) < 5e-3
    assert abs(float(eps.var()) - 1.0) < 5e-3
    # columns 2g and 2g + 1 come from one counter: no correlation
    assert abs(float((eps[:, 0] * eps[:, 1]).mean())) < 0.02
    again = cuda_reparam.philox_normal_plain(
        torch.tensor([123, 456]), 0, (50000, 20))
    assert torch.equal(eps, again)
    # a row's noise does not depend on the batch; an odd L is a prefix
    small = cuda_reparam.philox_normal_plain((123, 456), 0, (7, 19))
    assert torch.equal(small, eps[:7, :19])
    for seed, offset in (((123, 457), 0), ((124, 456), 0), ((123, 456), 1),
                         ((123, 456), 2 ** 32)):
        other = cuda_reparam.philox_normal_plain(seed, offset, (64, 20))
        assert not torch.equal(other, eps[:64])
        assert float((other - eps[:64]).abs().mean()) > 0.5


def test_generator_seeds_the_noise():
    mu, lv = (torch.from_numpy(a) for a in _inputs(4, 16, 8))
    a, _ = reparam_and_kl(mu, lv, torch.Generator().manual_seed(1))
    b, _ = reparam_and_kl(mu, lv, torch.Generator().manual_seed(1))
    c, _ = reparam_and_kl(mu, lv, torch.Generator().manual_seed(2))
    assert torch.equal(a, b) and not torch.equal(a, c)
    gen = torch.Generator().manual_seed(1)
    d, _ = reparam_and_kl(mu, lv, gen)
    e, _ = reparam_and_kl(mu, lv, gen)     # the generator moved on
    assert torch.equal(d, a) and not torch.equal(e, d)
    with pytest.raises(ValueError, match="generator or explicit eps"):
        reparam_and_kl(mu, lv)


def test_wrapper_checks_its_inputs():
    mu, lv = (torch.from_numpy(a) for a in _inputs(5, 4, 6))
    with pytest.raises(ValueError, match=r"\[B, L\] alike"):
        cuda_reparam.reparam_fwd(mu, lv[:, :5], (1, 2))
    with pytest.raises(TypeError, match="float32"):
        cuda_reparam.reparam_fwd(mu.double(), lv.double(), (1, 2))
    with pytest.raises(ValueError, match="contiguous"):
        cuda_reparam.reparam_fwd(mu.t(), lv.t(), (1, 2))
    with pytest.raises(ValueError, match="two words"):
        cuda_reparam.reparam_fwd(mu, lv, (1, 2, 3))
    meta = torch.empty(4, 6, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        cuda_reparam.reparam_fwd(meta, meta, (1, 2))


@pytest.mark.parametrize("b,l,expanded", [(16, 8, False), (37, 5, True),
                                          (100, 20, True), (3, 1, False)])
def test_plain_backward_matches_the_reference_vjp(b, l, expanded):
    """``reparam_bwd_plain`` (the backward kernel's plain version, which
    ``ReparamFunction.backward`` runs on CPU tensors) against
    ``_vjp_bwd`` on the same residuals and cotangents, dkl also as a
    mean's expanded cotangent (stride 0): rtol 1e-5 / atol 1e-6."""
    mu, lv = _inputs(6, b, l)
    rng = np.random.default_rng(7)
    z = (mu + np.exp(0.5 * lv) * rng.normal(size=(b, l))).astype(np.float32)
    dz = rng.normal(size=(b, l)).astype(np.float32)
    dkl = (np.full((b,), 0.37, np.float32) if expanded
           else rng.normal(size=(b,)).astype(np.float32))
    t_dkl = (torch.tensor([0.37]).expand(b) if expanded
             else torch.from_numpy(dkl))
    jm, jl, _ = _vjp_bwd(tuple(map(jnp.asarray, (mu, lv, z))),
                         (jnp.asarray(dz), jnp.asarray(dkl)))
    args = [torch.from_numpy(a) for a in (mu, lv, z, dz)] + [t_dkl]
    for dmu, dlv in (cuda_reparam.reparam_bwd_plain(*args),
                     cuda_reparam.reparam_bwd(*args)):
        np.testing.assert_allclose(dmu.numpy(), np.asarray(jm), **TOL)
        np.testing.assert_allclose(dlv.numpy(), np.asarray(jl), **TOL)
    assert cuda_reparam.bwd_launches == 0
    with pytest.raises(ValueError, match="do not fit"):
        cuda_reparam.reparam_bwd(*args[:3], args[3][:1], args[4])


@pytest.mark.parametrize("sms", [132, 7, 1])
def test_launch_plan_covers_each_pair_once(sms):
    """Both kernels' index arithmetic (csrc/reparam.cu) under
    ``launch_plan``: every row in one block, every pair of a block once,
    whole warps of at most MAX_THREADS threads, a block of several rows
    holding all their pairs in one pass (its KL slots), and at least
    min(B, SMs) blocks."""
    for b in (1, 2, 37, 100, 131, 133, 1000, 8192):
        for l in (1, 2, 7, 19, 20, 200, 511, 512, 513, 1200):
            rows, threads, blocks = cuda_reparam.launch_plan(b, l, sms)
            g = (l + 1) // 2
            assert 32 <= threads <= cuda_reparam.MAX_THREADS
            assert threads % 32 == 0
            assert rows == 1 or rows * g <= threads
            assert blocks == -(-b // rows) >= min(b, sms)
            seen = np.zeros((b, g), np.int64)
            for blk in {0, blocks - 1}:
                row0 = blk * rows
                here = min(rows, b - row0)
                for tid in range(threads):
                    for p in range(tid, here * g, threads):
                        seen[row0 + p // g, p % g] += 1
            assert seen[:rows].max() == 1 and seen[:rows].min() == 1
            assert seen[row0:].min() == 1 and seen[row0:].max() == 1
