"""The GAN chunk's bf16 path (TPU kernel #5, ``_make_dots``) against the
JAX package.

``gan_chunk_plain`` at ``dtype="bfloat16"`` (the CPU path of
``fused_step=True`` and the bf16 kernels' oracle on the card) against
``_fused_chunk_call`` in interpret mode, from the same numpy-made state
and streams, for nsgan, wgangp, infogan, began and cgan:

- one step, every element of each state tensor's change and of the
  metrics held by the bf16 rule (tests/test_torch_port_ema_bf16.py:
  BF16_RATIO of what the rounding does to it, plus the float32 floor);
- the rule has teeth: with any one product of the step left unrounded
  (or infogan's MI targets, or one of the penalty's rounded terms) the
  port breaks it, but for the products listed in UNSEEN (21-45 sites a
  step, 0-5 of them unseen);
- the port's bf16 chunk tracks its float32 chunk over 12 steps at the
  reference's own bf16 bound (``tests/test_fused_step.py``: rtol 0.12 /
  atol 0.05), and with the EMA plane as well holds the rule against the
  TPU kernel over 2 steps.
"""

import numpy as np
import pytest

from tests.test_torch_port_ema_bf16 import (
    GAN,
    chunk_ratios,
    jax_chunk,
    port_chunk,
    unseen_sites,
)

BF16_RUN_TOL = dict(rtol=0.12, atol=0.05)
# The products whose rounding the rule cannot see, by source line of the
# port's plain version: each carries less than BF16_RATIO of the rounding
# effect of every element it reaches, beside the deeper products whose
# rounding reaches the same elements (G's logits lf2 = hf2 W2d and its
# output product, wgangp's critic logits, whose gradient is the constant
# 1/B, the penalty's pre-activation hh, which reaches only the
# activation's slope), or only elements that the rule's FLIP_SHARE sets
# aside.
LR, LF, LF2 = ("lr = mm(hr, w2d, bf) + b2d", "lf = mm(hf, w2d, bf) + b2d",
               "lf2 = mm(hf2, w2d, bf) + b2d")
DW2 = "dw2 = mm(hr.t(), glr, bf) + mm(hf.t(), glf, bf)"
HH = "hh = mm(xh, w1d, bf16) + b1d"
UNSEEN = {
    "nsgan": {LF2},
    "wgangp": {LR, LF, DW2, HH,
               "fake = torch.sigmoid(mm(hgd, w2g, bf) + b2g)"},
    "infogan": set(),
    "began": set(),
    "cgan": {LF2, "fake2 = torch.sigmoid(mm(hg, w2g, bf) + b2g)"},
}


def _ratios(variant, steps=1, ema_decay=0.0, port=None):
    args = (variant, "adam", steps, ema_decay)
    return chunk_ratios(port or port_chunk(*args, "bfloat16"),
                        jax_chunk(*args, "bfloat16"),
                        jax_chunk(*args, "float32"))


@pytest.mark.parametrize("variant", GAN)
def test_gan_chunk_bf16_one_step_matches_pallas_chunk(variant):
    worst = max(_ratios(variant).items(), key=lambda kv: kv[1])
    assert worst[1] <= 1.0, worst
    # the bf16 path rounds: the float32 step breaks the rule
    f32 = port_chunk(variant, "adam", 1, 0.0, "float32")
    assert max(_ratios(variant, port=f32).values()) > 1.0


@pytest.mark.parametrize("variant", GAN)
def test_gan_chunk_bf16_leaves_no_product_unrounded(variant):
    n, unseen = unseen_sites(
        lambda: port_chunk(variant, "adam", 1, 0.0, "bfloat16"),
        lambda out: _ratios(variant, port=out))
    assert n >= 16  # forward and backward products of both updates
    assert set(unseen) == UNSEEN[variant], unseen


@pytest.mark.parametrize("variant", GAN)
def test_gan_chunk_bf16_tracks_float32_over_a_run(variant):
    runs = {dt: port_chunk(variant, "adam", 12, 0.0, dt, seed=5)[1]
            for dt in ("float32", "bfloat16")}
    assert np.isfinite(runs["bfloat16"]).all()
    np.testing.assert_allclose(runs["bfloat16"], runs["float32"],
                               **BF16_RUN_TOL)
    worst = max(_ratios(variant, 2, 0.9).items(), key=lambda kv: kv[1])
    assert worst[1] <= 1.0, worst
