"""The data-parallel phase functions' bf16 path (TPU kernels #8, #9)
against the JAX package.

``ops/cuda_dp.py::d_phase_plain`` / ``g_phase_plain`` at
``dtype="bfloat16"`` (the CPU path and the bf16 phase kernels' oracle on
the card) against ``ops/pallas_dp.py``'s ``_make_d_phase_kernel`` /
``_make_g_phase_kernel`` in interpret mode at ``dtype="bfloat16"``, on
tests/test_torch_port_dp_phase.py's inputs, for every variant of
``FUSED_DP_VARIANTS``: every element of the eight gradients and of the
metrics rows held by the bf16 rule (tests/test_torch_port_ema_bf16.py);
the float32 phase breaks it; and with any one product of a phase left
unrounded the port breaks it too, but for the products in UNSEEN (21-27
sites, 0-6 of them unseen).
"""

import functools

import numpy as np
import pytest
import torch

from generative_models_tpu_torch.ops import cuda_dp
from generative_models_tpu_torch.ops.cuda_train import ChunkHyper
from tests.test_torch_port_dp_phase import _case, _jax_phases, _split
from tests.test_torch_port_ema_bf16 import bf16_ratio, unseen_sites

NAMES = ("dW1d", "db1d", "dW2d", "db2d", "dW1g", "db1g", "dW2g", "db2g")
B = 16
# The products whose rounding the rule cannot see, by source line of the
# port's plain version (as tests/test_torch_port_bf16_chunk.py::UNSEEN;
# here the first layer's products are 784 deep and carry most of every
# element's rounding effect).
LR, DW2 = ("lr = mm(hr, w2d, bf) + b2d",
           "dw2 = mm(hr.t(), glr, bf) + mm(hf.t(), glf, bf)")
HH = "hh = mm(xh, w1d, bf16) + b1d"
UNSEEN = {
    "nsgan": {LR}, "mmgan": {LR}, "wgan": {LR}, "fgan": {LR},
    "lsgan": {LR, DW2, "dhf = mm(glf, w2d.t(), bf) * dleaky(hf)",
              "dw1 = mm(x.t(), dhr, bf) + mm(fake_d.t(), dhf, bf)",
              "hgd = relu(mm(z, w1g, bf) + b1g)",
              "lf2 = mm(hf2, w2d, bf) + b2d"},
    "cgan": {"hf2 = leaky(mm(fake2_d, w1d, bf) + b1d)"},
    "dragan": {LR, DW2, HH}, "wgangp": {LR, DW2, HH},
    "infogan": {LR, DW2}, "began": set(),
}


def _inputs(variant):
    cfg, g, d, x, zd, zg, xtra = _case(variant, B, seed=3)
    return cfg, g, d, x, zd, zg, xtra, 0.3 if variant == "began" else 0.0


@functools.lru_cache(maxsize=None)
def jax_phases(variant, dtype):
    """The reference's D and G phase kernels in interpret mode: the eight
    gradients (D's, then G's) and the two metrics rows."""
    cfg, g, d, x, zd, zg, xtra, k = _inputs(variant)
    (jd, jdm), (jg, jgm) = _jax_phases(cfg, B, g, d, x, zd, zg, xtra, k,
                                       dtype=dtype)
    return jd + jg, (jdm, jgm)


def port_phases(variant, dtype):
    cfg, g, d, x, zd, zg, xtra, k = _inputs(variant)
    hp = ChunkHyper.from_config(cfg.replace(dtype=dtype))
    assert hp.bf16 == (dtype == "bfloat16")
    t = lambda a: None if a is None else torch.from_numpy(
        np.ascontiguousarray(a))
    gt, dt = [t(a) for a in g], [t(a) for a in d]
    pd, pdm = _split(cuda_dp.d_phase(t(x), t(zd), t(xtra), gt, dt,
                                     torch.tensor(k), hp), d)
    pg, pgm = _split(cuda_dp.g_phase(t(zg), gt, dt, hp), g)
    assert cuda_dp.d_launches == cuda_dp.g_launches == 0
    return pd + pg, (pdm, pgm)


def _ratios(variant, port):
    (got, gm), (ref, rm), (ref32, rm32) = (
        port, jax_phases(variant, "bfloat16"), jax_phases(variant, "float32"))
    out = {n: bf16_ratio(a, r, r32) for n, a, r, r32 in zip(NAMES, got, ref,
                                                             ref32)}
    for mode, a, r, r32 in zip("dg", gm, rm, rm32):
        for j in range(8):
            out[f"{mode} metrics lane {j}"] = bf16_ratio(a[j], r[j], r32[j])
    return out


@pytest.mark.parametrize("variant", cuda_dp.FUSED_DP_VARIANTS)
def test_phase_functions_bf16_match_the_jax_phase_kernels(variant):
    worst = max(_ratios(variant, port_phases(variant, "bfloat16")).items(),
                key=lambda kv: kv[1])
    assert worst[1] <= 1.0, worst
    # and it is not the float32 phase
    assert max(_ratios(variant, port_phases(variant, "float32")).values()) \
        > 1.0


@pytest.mark.parametrize("variant", cuda_dp.FUSED_DP_VARIANTS)
def test_phase_functions_bf16_leave_no_product_unrounded(variant):
    n, unseen = unseen_sites(lambda: port_phases(variant, "bfloat16"),
                             lambda out: _ratios(variant, out))
    assert n >= 16  # forward and backward products of both phases
    assert set(unseen) == UNSEEN[variant], unseen
