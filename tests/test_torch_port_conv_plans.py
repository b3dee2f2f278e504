"""Launch plans of the whole-MLP kernels (``ops/cuda_mlp.py``) for the
conv stacks' dense layers, and the MLP stacks' plans held fixed.

The conv stacks' dense layers are 7*7*2C = 6272 wide at the default
``conv_channels`` 64: the generator's and decoder's ``fc`` output it,
the critics' and encoders' ``fc`` take it as input. The backward's
pass 1 runs the chain over the reversed widths, so a 6272-wide input
becomes a 6272-wide output whose transposed W chunk fills a ring slot;
it fits only at the wide chunk depth (``WIDE_CHUNK_DEPTHS``). Every
such layer, and each stack the conv nets run as one (infogan's ``fc``
with its heads), plans in both directions at B 64, 100, 1024 and 8192,
its tiles covering every row and column once (``check_chain_plan``).

``MLP_PLANS`` is the table of every served MLP stack's forward and
backward plan at a 132-SM card before the wide depth was added: (fwd
tr, row groups, cluster, kc, streamed; bwd pass 1 tr, row groups,
cluster, kc, streamed; bwd slices). The planner must give exactly
these, so the MLP path's launches do not move. A pure-Python test.
"""

import pytest

from generative_models_tpu_torch.ops import cuda_mlp
from tests.test_torch_port_mlp import SERVED_STACKS, check_chain_plan

C2 = 7 * 7 * 2 * 64     # the conv trunk's flat width at conv_channels 64
CONV_STACKS = {
    "g_fc": [128, C2], "cgan_g_fc": [138, C2], "infogan_g_fc": [140, C2],
    "dec_fc": [20, C2], "began_dec_fc": [400, C2],
    "d_fc": [C2, 1], "enc_fc": [C2, 400], "began_enc_fc": [C2, 400],
    "infogan_d": [C2, 400, 15], "narrow_fc": [C2, 64],
}
CONV_BATCHES = (64, 100, 1024, 8192)
CONV_CASES = [(n, b) for n in CONV_STACKS for b in CONV_BATCHES]

MLP_PLANS = {
    ("g", 1): (1, 8, 8, 64, 0, 1, 8, 8, 64, 0, 1),
    ("g", 37): (1, 8, 8, 64, 0, 1, 8, 8, 64, 0, 1),
    ("g", 64): (1, 8, 8, 64, 0, 1, 8, 8, 64, 0, 1),
    ("g", 100): (1, 8, 8, 64, 0, 1, 8, 8, 64, 0, 1),
    ("g", 256): (1, 16, 8, 64, 0, 1, 16, 8, 64, 0, 1),
    ("g", 1024): (4, 4, 2, 32, 1, 4, 4, 2, 32, 1, 2),
    ("g", 8192): (8, 4, 2, 32, 1, 8, 8, 2, 32, 1, 16),
    ("g", 10000): (8, 4, 2, 32, 1, 8, 8, 2, 32, 1, 19),
    ("d", 1): (1, 8, 8, 64, 0, 1, 8, 8, 64, 0, 1),
    ("d", 37): (1, 8, 8, 64, 0, 1, 8, 8, 64, 0, 1),
    ("d", 64): (1, 8, 8, 64, 0, 1, 8, 8, 64, 0, 1),
    ("d", 100): (1, 8, 8, 64, 0, 1, 8, 8, 64, 0, 1),
    ("d", 256): (1, 16, 8, 64, 0, 1, 16, 8, 64, 0, 1),
    ("d", 1024): (4, 4, 2, 32, 1, 4, 4, 2, 16, 1, 2),
    ("d", 8192): (8, 8, 2, 32, 1, 8, 4, 2, 16, 1, 16),
    ("d", 10000): (8, 8, 2, 32, 1, 8, 4, 2, 16, 1, 18),
    ("cgan_g", 1): (1, 8, 8, 64, 0, 1, 8, 8, 64, 0, 1),
    ("cgan_g", 37): (1, 8, 8, 64, 0, 1, 8, 8, 64, 0, 1),
    ("cgan_g", 64): (1, 8, 8, 64, 0, 1, 8, 8, 64, 0, 1),
    ("cgan_g", 100): (1, 8, 8, 64, 0, 1, 8, 8, 64, 0, 1),
    ("cgan_g", 256): (1, 16, 8, 64, 0, 1, 16, 8, 64, 0, 1),
    ("cgan_g", 1024): (4, 4, 2, 32, 1, 4, 4, 2, 32, 1, 2),
    ("cgan_g", 8192): (8, 4, 2, 32, 1, 8, 8, 2, 32, 1, 16),
    ("cgan_g", 10000): (8, 4, 2, 32, 1, 8, 8, 2, 32, 1, 18),
    ("cgan_d", 1): (1, 8, 8, 64, 0, 1, 8, 8, 64, 0, 1),
    ("cgan_d", 37): (1, 8, 8, 64, 0, 1, 8, 8, 64, 0, 1),
    ("cgan_d", 64): (1, 8, 8, 64, 0, 1, 8, 8, 64, 0, 1),
    ("cgan_d", 100): (1, 8, 8, 64, 0, 1, 8, 8, 64, 0, 1),
    ("cgan_d", 256): (1, 16, 8, 64, 0, 1, 16, 8, 64, 0, 1),
    ("cgan_d", 1024): (4, 4, 2, 32, 1, 4, 4, 2, 16, 1, 2),
    ("cgan_d", 8192): (8, 8, 2, 32, 1, 8, 4, 2, 16, 1, 16),
    ("cgan_d", 10000): (8, 8, 2, 32, 1, 8, 4, 2, 16, 1, 18),
    ("infogan_g", 1): (1, 8, 8, 64, 0, 1, 8, 8, 64, 0, 1),
    ("infogan_g", 37): (1, 8, 8, 64, 0, 1, 8, 8, 64, 0, 1),
    ("infogan_g", 64): (1, 8, 8, 64, 0, 1, 8, 8, 64, 0, 1),
    ("infogan_g", 100): (1, 8, 8, 64, 0, 1, 8, 8, 64, 0, 1),
    ("infogan_g", 256): (1, 16, 8, 64, 0, 1, 16, 8, 64, 0, 1),
    ("infogan_g", 1024): (4, 4, 2, 32, 1, 4, 4, 2, 32, 1, 2),
    ("infogan_g", 8192): (8, 4, 2, 32, 1, 8, 8, 2, 32, 1, 16),
    ("infogan_g", 10000): (8, 4, 2, 32, 1, 8, 8, 2, 32, 1, 18),
    ("infogan_d", 1): (1, 8, 8, 64, 0, 1, 8, 8, 64, 0, 1),
    ("infogan_d", 37): (1, 8, 8, 64, 0, 1, 8, 8, 64, 0, 1),
    ("infogan_d", 64): (1, 8, 8, 64, 0, 1, 8, 8, 64, 0, 1),
    ("infogan_d", 100): (1, 8, 8, 64, 0, 1, 8, 8, 64, 0, 1),
    ("infogan_d", 256): (1, 16, 8, 64, 0, 1, 16, 8, 64, 0, 1),
    ("infogan_d", 1024): (4, 4, 2, 32, 1, 4, 4, 2, 16, 1, 2),
    ("infogan_d", 8192): (8, 8, 2, 32, 1, 8, 4, 2, 16, 1, 16),
    ("infogan_d", 10000): (8, 8, 2, 32, 1, 8, 4, 2, 16, 1, 18),
    ("began_d", 1): (1, 8, 8, 64, 0, 1, 8, 8, 64, 0, 1),
    ("began_d", 37): (1, 8, 8, 64, 0, 1, 8, 8, 64, 0, 1),
    ("began_d", 64): (1, 8, 8, 64, 0, 1, 8, 8, 64, 0, 1),
    ("began_d", 100): (1, 8, 8, 64, 0, 1, 8, 8, 64, 0, 1),
    ("began_d", 256): (1, 16, 8, 64, 0, 1, 16, 8, 64, 0, 1),
    ("began_d", 1024): (4, 4, 2, 32, 1, 4, 4, 2, 16, 1, 2),
    ("began_d", 8192): (8, 4, 2, 32, 1, 8, 4, 2, 16, 1, 11),
    ("began_d", 10000): (8, 4, 2, 32, 1, 8, 4, 2, 16, 1, 11),
    ("vae_trunk", 1): (1, 8, 8, 64, 0, 1, 8, 8, 64, 0, 1),
    ("vae_trunk", 37): (1, 8, 8, 64, 0, 1, 8, 8, 64, 0, 1),
    ("vae_trunk", 64): (1, 8, 8, 64, 0, 1, 8, 8, 64, 0, 1),
    ("vae_trunk", 100): (1, 8, 8, 64, 0, 1, 8, 8, 64, 0, 1),
    ("vae_trunk", 256): (1, 16, 8, 64, 0, 1, 16, 8, 64, 0, 1),
    ("vae_trunk", 1024): (4, 4, 2, 32, 1, 4, 4, 2, 16, 1, 2),
    ("vae_trunk", 8192): (8, 8, 2, 32, 1, 8, 4, 2, 16, 1, 16),
    ("vae_trunk", 10000): (8, 8, 2, 32, 1, 8, 4, 2, 16, 1, 19),
    ("vae_head", 1): (1, 8, 8, 64, 0, 1, 8, 8, 64, 0, 1),
    ("vae_head", 37): (1, 8, 8, 64, 0, 1, 8, 8, 64, 0, 1),
    ("vae_head", 64): (1, 8, 8, 64, 0, 1, 8, 8, 64, 0, 1),
    ("vae_head", 100): (1, 8, 8, 64, 0, 1, 8, 8, 64, 0, 1),
    ("vae_head", 256): (1, 16, 8, 64, 0, 1, 16, 8, 64, 0, 1),
    ("vae_head", 1024): (4, 4, 2, 32, 1, 4, 4, 2, 32, 1, 2),
    ("vae_head", 8192): (8, 8, 2, 32, 1, 8, 8, 2, 32, 1, 16),
    ("vae_head", 10000): (8, 8, 2, 32, 1, 8, 8, 2, 32, 1, 19),
    ("vae_dec", 1): (1, 8, 8, 64, 0, 1, 8, 8, 64, 0, 1),
    ("vae_dec", 37): (1, 8, 8, 64, 0, 1, 8, 8, 64, 0, 1),
    ("vae_dec", 64): (1, 8, 8, 64, 0, 1, 8, 8, 64, 0, 1),
    ("vae_dec", 100): (1, 8, 8, 64, 0, 1, 8, 8, 64, 0, 1),
    ("vae_dec", 256): (1, 16, 8, 64, 0, 1, 16, 8, 64, 0, 1),
    ("vae_dec", 1024): (4, 4, 2, 32, 1, 4, 4, 2, 32, 1, 2),
    ("vae_dec", 8192): (8, 4, 2, 32, 1, 8, 8, 2, 32, 1, 16),
    ("vae_dec", 10000): (8, 4, 2, 32, 1, 8, 8, 2, 32, 1, 19),
    ("clf", 1): (1, 8, 8, 64, 0, 1, 8, 8, 64, 0, 1),
    ("clf", 37): (1, 8, 8, 64, 0, 1, 8, 8, 64, 0, 1),
    ("clf", 64): (1, 8, 8, 64, 0, 1, 8, 8, 64, 0, 1),
    ("clf", 100): (1, 8, 8, 64, 0, 1, 8, 8, 64, 0, 1),
    ("clf", 256): (1, 16, 8, 64, 0, 1, 16, 8, 64, 0, 1),
    ("clf", 1024): (4, 4, 2, 32, 1, 4, 4, 2, 16, 1, 2),
    ("clf", 8192): (8, 8, 2, 32, 1, 8, 4, 2, 16, 1, 16),
    ("clf", 10000): (8, 8, 2, 32, 1, 8, 4, 2, 16, 1, 19),
    ("clf_feat", 1): (1, 8, 8, 64, 0, 1, 8, 8, 64, 0, 1),
    ("clf_feat", 37): (1, 8, 8, 64, 0, 1, 8, 8, 64, 0, 1),
    ("clf_feat", 64): (1, 8, 8, 64, 0, 1, 8, 8, 64, 0, 1),
    ("clf_feat", 100): (1, 8, 8, 64, 0, 1, 8, 8, 64, 0, 1),
    ("clf_feat", 256): (1, 16, 8, 64, 0, 1, 16, 8, 64, 0, 1),
    ("clf_feat", 1024): (4, 4, 2, 32, 1, 4, 4, 2, 16, 1, 2),
    ("clf_feat", 8192): (8, 8, 2, 32, 1, 8, 4, 2, 16, 1, 16),
    ("clf_feat", 10000): (8, 8, 2, 32, 1, 8, 4, 2, 16, 1, 19),
}


@pytest.mark.parametrize("name,batch", CONV_CASES,
                         ids=[f"{n}-B{b}" for n, b in CONV_CASES])
def test_conv_dense_layers_plan_both_ways(name, batch):
    dims = CONV_STACKS[name]
    fwd = cuda_mlp.fwd_plan(batch, dims, 132)
    check_chain_plan(dims, batch, fwd, bwd=False)
    bwd = cuda_mlp.bwd_plan(batch, dims, 132)
    check_chain_plan(dims[::-1], batch, bwd.rows, bwd=True)
    assert bwd.dw_grid == (cuda_mlp.dw_tiles(dims), bwd.slices)
    if dims[0] == C2:  # the transposed chunk of a 6272-wide input
        assert bwd.rows.kc in cuda_mlp.WIDE_CHUNK_DEPTHS
        for kc in cuda_mlp.CHUNK_DEPTHS:
            assert all(p.kc != kc for p in cuda_mlp.chain_candidates(
                batch, dims[::-1], True, (kc,)))


@pytest.mark.parametrize("name", sorted(SERVED_STACKS))
def test_mlp_stack_plans_are_unchanged(name):
    dims = SERVED_STACKS[name]
    for (n, batch), want in MLP_PLANS.items():
        if n != name:
            continue
        f = cuda_mlp.fwd_plan(batch, dims, 132)
        k = cuda_mlp.bwd_plan(batch, dims, 132)
        r = k.rows
        got = (f.tr, f.row_groups, f.cluster, f.kc, int(f.stream),
               r.tr, r.row_groups, r.cluster, r.kc, int(r.stream), k.slices)
        assert got == want, (name, batch)


def test_a_layer_too_wide_for_any_depth_still_raises():
    with pytest.raises(ValueError, match="fit no plan"):
        cuda_mlp.bwd_plan(100, [60000, 1], 132)
