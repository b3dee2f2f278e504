"""Pipeline parallelism in the port (``parallel/pp.py``): the prior's
blocks cut into stages over a ``dp x pp`` grid of gloo ranks, at the sizes
of ``tests/test_pp.py`` (4 layers, width 32, 4 heads, K 16, B 8).

One spawn of 4 ranks runs (dp, stages, n_micro) = (2, 2, 2), (1, 4, 4)
and (1, 2, 4), and (2, 2, 2) with class labels: ``prior_apply_pp``'s
logits, the explicit fill-drain schedule's CE and gradients
(``pp_loss_and_grads``) and one step of ``build_pp_prior_step``. Each
is held against the port's single device, and (2, 2, 2) with and
without labels also against the JAX package's ``prior_apply_pp``,
``jax.grad`` of its ``prior_ce_pp`` and its ``build_pp_prior_step`` on a
CPU mesh of the same shape (rtol 1e-5, atol 1e-6, ``tests/test_pp.py:83``). The head starts random instead of zero, so the
blocks' first gradients are not zero. The divisibility refusals and the
stack/unstack round trip need no spawn.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generative_models_tpu_torch.config import variant_config
from generative_models_tpu_torch.losses.vqprior import _shift, prior_ce
from generative_models_tpu_torch.models import ar_prior
from generative_models_tpu_torch.parallel import mesh, pp, runs
from generative_models_tpu_torch.train.optim import apply_opt, init_opt
from generative_models_tpu_torch.utils.tree import (
    tree_leaves,
    tree_leaves_with_path,
    tree_unflatten,
)

TOL = dict(rtol=1e-5, atol=1e-6)
SIZES = dict(vq_prior_layers=4, vq_prior_width=32, vq_prior_heads=4,
             vq_codebook_size=16)
B, STEPS = 8, 1
SPLITS = [((2, 2), 2, False), ((1, 4), 4, False), ((1, 2), 4, False),
          ((2, 2), 2, True)]
# the splits also held against the JAX package's pipeline (each of its
# splits computes one function; these two cover data x pipe and labels)
JAX_SPLITS = (0, 3)


def _cfg(**kw):
    return variant_config("vqprior", **dict(SIZES, **kw))


def _params(cfg):
    p = ar_prior.prior_init(torch.Generator().manual_seed(0), cfg)
    g = torch.Generator().manual_seed(1)
    p["head"]["w"] = 0.1 * torch.randn(p["head"]["w"].shape, generator=g)
    return p


def _case(grid, n_micro, cond):
    cfg = _cfg(ddpm_cond=cond)
    rng = np.random.default_rng(0)
    return dict(cfg=cfg, grid=grid, n_micro=n_micro,
                params=runs._numpy_tree(_params(cfg)),
                tokens=rng.integers(0, 16, (B, cfg.vq_tokens)).astype(np.int64),
                y=(np.arange(B) % 10).astype(np.int64) if cond else None,
                steps=STEPS)


@pytest.fixture(scope="module")
def pp4():
    cases = [_case(*s) for s in SPLITS]
    res = mesh.run_ranks(runs.pp_rank, 4, "cpu", args=(cases,), threads=1,
                         timeout=300)
    return cases, res


def _single(case):
    """The port's prior on one device: logits, CE gradients, steps."""
    cfg = case["cfg"]
    p = _params(cfg)
    tok = torch.from_numpy(case["tokens"])
    y = None if case["y"] is None else torch.from_numpy(case["y"])

    def ce_grads(p):
        leaves = [t.detach().requires_grad_(True) for t in tree_leaves(p)]
        q = tree_unflatten(p, leaves)
        loss = prior_ce(ar_prior.prior_apply(q, _shift(tok, cfg), cfg, y),
                        tok)
        return loss.detach(), tree_unflatten(p, list(
            torch.autograd.grad(loss, leaves)))
    out = {"logits": ar_prior.prior_apply(p, _shift(tok, cfg), cfg, y)}
    out["loss"], out["grads"] = ce_grads(p)
    opt, losses = init_opt(cfg, p), []
    for _ in range(STEPS):
        loss, g = ce_grads(p)
        p, opt = apply_opt(cfg, p, g, opt, cfg.g_lr)
        losses.append(loss)
    out["losses"], out["params"] = torch.stack(losses), p
    return runs._numpy_tree(out)


def _jax(case):
    """The JAX package's pipeline on a CPU mesh of the case's shape."""
    from generative_models_tpu.config import variant_config as jax_config
    from generative_models_tpu.parallel import pp as jpp
    cfg = jax_config("vqprior", **dict(SIZES, ddpm_cond=case["y"] is not None))
    to_j = lambda tree: jax.tree.map(jnp.asarray, tree)
    params = to_j(case["params"])
    tokens = jnp.asarray(case["tokens"].astype(np.int32))
    y = None if case["y"] is None else jnp.asarray(case["y"].astype(np.int32))
    mesh_ = jpp.make_mesh_pp(*case["grid"], devices=jax.devices("cpu"))
    n = case["n_micro"]
    from generative_models_tpu.losses.vqprior import _shift as jshift
    out = {"logits": jax.jit(lambda p: jpp.prior_apply_pp(
        p, jshift(tokens, cfg), cfg, mesh_, n, y))(params)}
    out["loss"], out["grads"] = jax.jit(jax.value_and_grad(
        lambda p: jpp.prior_ce_pp(p, tokens, cfg, mesh_, n, y)))(params)
    jitted, p, opt, tok, yy = jpp.build_pp_prior_step(cfg, mesh_, n)(
        params, tokens, y)
    losses = []
    for _ in range(STEPS):
        p, opt, loss = jitted(p, opt, tok, yy)
        losses.append(loss)
    p = dict(p, blocks=jpp.unstack_blocks(p["blocks"], cfg.vq_prior_layers))
    out["losses"], out["params"] = jnp.stack(losses), p
    return jax.tree.map(np.asarray, out)


def _leaves(tree):
    return dict(tree_leaves_with_path(tree))


def _hold(got, want, what):
    np.testing.assert_allclose(got["logits"], want["logits"],
                               err_msg=f"{what} logits", **TOL)
    np.testing.assert_allclose(got["loss"], want["loss"],
                               err_msg=f"{what} loss", **TOL)
    np.testing.assert_allclose(got["losses"], want["losses"],
                               err_msg=f"{what} losses", **TOL)
    for part in ("grads", "params"):
        g, w = _leaves(got[part]), _leaves(want[part])
        assert set(g) == set(w), what
        for k in w:
            a, b = g[k], w[k]
            if part == "params" and k.endswith("['qkv']['b']"):
                # k's bias shifts every score of a query alike, which the
                # softmax ignores: its gradient is zero in exact arithmetic
                # (held above), and Adam's first step turns the rounding
                # residue of either sum into a step of order lr. q's and
                # v's biases are held.
                width = a.shape[-1] // 3
                keep = np.r_[0:width, 2 * width:3 * width]
                a, b = a[..., keep], b[..., keep]
            np.testing.assert_allclose(a, b, err_msg=f"{what} {part} {k}",
                                       **TOL)


@pytest.mark.parametrize("split", range(len(SPLITS)))
def test_pp_equals_jax_and_single_device(pp4, split):
    cases, res = pp4
    case = cases[split]
    ranks = [r[split] for r in res if r[split] is not None]
    assert len(ranks) == case["grid"][0] * case["grid"][1]
    for r in ranks[1:]:  # every rank holds the same results
        for part in ("logits", "loss", "grads", "losses", "params"):
            for k, v in _leaves(ranks[0][part]).items():
                np.testing.assert_array_equal(_leaves(r[part])[k], v,
                                              err_msg=f"{part} {k}")
    got = ranks[0]
    assert np.abs(_leaves(got["grads"])["['blocks'][0]['qkv']['w']"]).max() > 0
    if split in JAX_SPLITS:
        _hold(got, _jax(case),
              f"{case['grid']} n_micro={case['n_micro']} vs JAX")
    _hold(got, _single(case), f"{case['grid']} vs the single device")


def test_pp_hops_and_stage_launches(pp4):
    """A step of (1, 4, 4): each of the 4 microbatches crosses 3 stage
    boundaries forward and 3 backward, one send each; no model-group
    all-reduce, one data mean a step."""
    cases, res = pp4
    counts = [r[1]["counts"] for r in res]
    assert sum(c["hops"] for c in counts) == STEPS * 4 * 3 * 2
    assert [c["hops"] for c in counts] == [STEPS * 4, STEPS * 8, STEPS * 8,
                                           STEPS * 4]
    assert all(c["model_all_reduce"] == 0 for c in counts)
    assert all(c["data_all_reduce"] == STEPS for c in counts)


def _fake_grid(dp, n):
    dev = torch.device("cpu")
    return mesh.Grid(dp=dp, n=n, axis=pp.PIPE_AXIS, rank=0,
                     data=mesh.DataGroup(dp, 0, dev, "gloo", None),
                     second=mesh.DataGroup(n, 0, dev, "gloo", None), pg=None)


@pytest.mark.parametrize("layers,grid,n_micro,match", [
    (3, (1, 2), 2, "equal stages"),
    (4, (1, 4), 3, "n_micro"),
    (4, (4, 2), 4, "data"),
])
def test_pp_refusals(layers, grid, n_micro, match):
    """tests/test_pp.py's three refusals, with their messages."""
    cfg = _cfg(vq_prior_layers=layers)
    p = _params(cfg)
    tok = torch.zeros((B, cfg.vq_tokens), dtype=torch.int64)
    with pytest.raises(ValueError, match=match):
        pp.prior_apply_pp(p, tok, cfg, _fake_grid(*grid), n_micro)
    with pytest.raises(ValueError, match=match):
        pp.pp_loss_and_grads(p, tok, cfg, _fake_grid(*grid), n_micro)


def test_pp_stack_roundtrip():
    cfg = _cfg()
    blocks = _params(cfg)["blocks"]
    stacked = pp.stack_blocks(blocks)
    assert stacked["qkv"]["w"].shape == (4, 32, 96)
    back = pp.unstack_blocks(stacked, cfg.vq_prior_layers)
    for a, b in zip(tree_leaves(blocks), tree_leaves(back)):
        assert torch.equal(a, b)
