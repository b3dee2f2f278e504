"""The VAE family's EMA plane and bf16 path (TPU kernels #6, #7) against
the JAX package.

``build_fused_many_steps`` of the port (on the CPU the kernels' plain
versions, also their oracles on the card) and of the JAX package (the TPU
chunk kernels in interpret mode) run from the same weights, EMA plane,
images, permutations and eps (the JAX chunk function's own draws,
replayed), as tests/test_torch_port_vae_chunk.py runs them:

- vae and birvae with the EMA plane of every tensor at ``ema_decay``
  0.9, 4 steps, held at rtol 2e-4 / atol 2e-5 (elementwise float32);
- vae and birvae at ``dtype="bfloat16"``, one step, held by the bf16
  rule (tests/test_torch_port_ema_bf16.py), which the float32 step
  breaks, and which the port breaks with any one product of the step
  left unrounded, but for those in UNSEEN.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generative_models_tpu.config import variant_config as jax_variant_config
from generative_models_tpu.losses.registry import get_variant as jax_variant
from generative_models_tpu.ops.pallas_train import (
    build_fused_many_steps as jax_fused_many_steps,
)
from generative_models_tpu.train import step as jstep
from generative_models_tpu.train.optim import make_tx
from generative_models_tpu_torch.config import variant_config
from generative_models_tpu_torch.losses.registry import get_variant
from generative_models_tpu_torch.ops import cuda_train, cuda_train_vae
from generative_models_tpu_torch.train import step as step_lib
from generative_models_tpu_torch.utils.tree import (
    tree_leaves_with_path,
    tree_map,
)
from tests.test_torch_port_ema_bf16 import TOL, bf16_ratio, unseen_sites


# ---------------------------------------------------------------------
# The VAE family
# ---------------------------------------------------------------------

VB, VX, VH, VL, STEPS = 8, 48, 32, 8, 4
N_ROWS = 4 * VB


def _vae_kw(variant, **kw):
    kw = dict(batch_size=VB, image_dim=VX, vae_hidden_dim=VH, latent_dim=VL,
              vae_recon="bce", **kw)
    if variant == "birvae":
        kw["adam_eps"] = 1e-3  # tests/test_torch_port_vae_chunk.py's reason
    return kw


def _layer(rng, i, o):
    bound = 1.0 / np.sqrt(i)
    return {"w": rng.uniform(-bound, bound, (i, o)).astype(np.float32),
            "b": rng.uniform(-bound, bound, (o,)).astype(np.float32)}


def _vae_weights(rng, variant):
    dec = [_layer(rng, VL, VH), _layer(rng, VH, VX)]
    if variant == "vae":
        return {"encoder": {"trunk": [_layer(rng, VX, VH)],
                            "mu": _layer(rng, VH, VL),
                            "logvar": _layer(rng, VH, VL)}, "decoder": dec}
    return {"enc_trunk": [_layer(rng, VX, VH)], "enc_mu": _layer(rng, VH, VL),
            "decoder": dec}


def _vae_case(variant, **kw):
    """The weights, EMA plane, images, labels and permutations of a VAE
    check (numpy, from one seed), and the port's and the JAX package's
    configurations."""
    rng = np.random.default_rng(3)
    w = _vae_weights(rng, variant)
    ema = jax.tree.map(lambda a: (a * np.float32(0.9)).astype(np.float32), w)
    images = rng.random((N_ROWS, VX), dtype=np.float32)
    labels = rng.integers(0, 10, N_ROWS).astype(np.int32)
    perm = np.stack([rng.permutation(N_ROWS) for _ in range(3)]).astype(
        np.int32)
    return (w, ema, images, labels, perm,
            variant_config(variant, **_vae_kw(variant, **kw)),
            jax_variant_config(variant, **_vae_kw(variant, **kw)))


@functools.lru_cache(maxsize=None)
def _jax_vae(variant, steps, ema_decay=0.0, dtype="float32"):
    """The JAX package's chunk function (the TPU kernel in interpret mode)
    from _vae_case's state: (the state with numpy leaves, the metrics;
    the eps it drew, per step). Cached: a file's checks read one run
    several times."""
    w, ema, images, labels, perm, _, jcfg = _vae_case(
        variant, ema_decay=ema_decay, dtype=dtype)
    jspec = jax_variant(variant)
    jstate = jstep.init_state(jspec, jcfg, jax.random.PRNGKey(7))
    jstate["params"] = jax.tree.map(jnp.asarray, w)
    jstate["opt"] = make_tx(jcfg, jcfg.g_lr).init(jstate["params"])
    if ema_decay:
        jstate["ema"] = jax.tree.map(jnp.asarray, ema)
    eps, chain = [], jstate["rng"]  # the JAX chunk function's draws
    for _ in range(steps):
        chain, key = jax.random.split(chain)
        eps.append(np.array(jax.random.normal(key, (VB, VL))))
    many = jax_fused_many_steps(jspec, jcfg, N_ROWS // VB, interpret=True)
    js, jm = many(jstate, jnp.asarray(images), jnp.asarray(labels),
                  jnp.asarray(perm), jnp.arange(steps, dtype=jnp.int32) * VB)
    return (jax.tree.map(np.asarray, js), jax.tree.map(np.asarray, jm),
            np.stack(eps))


def _port_vae(variant, steps, ema_decay=0.0, dtype="float32"):
    """The port's chunk function (the kernels' plain version on the CPU)
    from the same state, data and eps: (state, metrics)."""
    w, ema, images, labels, perm, cfg, _ = _vae_case(
        variant, ema_decay=ema_decay, dtype=dtype)
    eps = torch.from_numpy(_jax_vae(variant, steps, ema_decay, dtype)[2])
    spec = get_variant(variant)
    state = step_lib.init_state(spec, cfg, torch.Generator().manual_seed(0))
    state["params"] = tree_map(lambda a: torch.from_numpy(a.copy()), w)
    if cfg.ema_decay:
        state["ema"] = tree_map(lambda a: torch.from_numpy(a.copy()), ema)
    s, m = cuda_train.build_fused_many_steps(spec, cfg, N_ROWS // VB)(
        state, torch.from_numpy(images), torch.from_numpy(labels),
        torch.from_numpy(perm).long(), torch.arange(steps) * VB,
        lambda k0, n: eps[k0:k0 + n])
    assert cuda_train_vae.launches == cuda_train_vae.birvae_launches == 0
    return s, m


def _vae_both(variant, steps, **kw):
    """The port's chunk function and the JAX package's from the same
    weights, EMA plane, data and eps: ((port state, metrics), (JAX state,
    metrics))."""
    js, jm, _ = _jax_vae(variant, steps, **kw)
    return _port_vae(variant, steps, **kw), (js, jm)


def _tree_pairs(mine, theirs):
    theirs = dict(tree_leaves_with_path(theirs))
    return [(path, t.numpy(), theirs[path])
            for path, t in tree_leaves_with_path(mine)]


def _slots(js):
    return {slot: getattr(js["opt"][0], slot) for slot in ("mu", "nu")}


@pytest.mark.parametrize("variant", ["vae", "birvae"])
def test_vae_family_ema_matches_pallas_chunk(variant):
    (s, m), (js, jm) = _vae_both(variant, STEPS, ema_decay=0.9)
    for k in m:
        np.testing.assert_allclose(m[k].numpy(), jm[k], err_msg=k, **TOL)
    for key in ("params", "ema"):
        for path, mine, ref in _tree_pairs(s[key], js[key]):
            np.testing.assert_allclose(mine, ref, err_msg=key + path, **TOL)
    for slot, ref_tree in _slots(js).items():
        for path, mine, ref in _tree_pairs(s["opt"][slot], ref_tree):
            np.testing.assert_allclose(mine, ref, err_msg=slot + path, **TOL)
    assert not torch.equal(s["ema"]["decoder"][0]["w"],
                           s["params"]["decoder"][0]["w"])


# the BIR-VAE's mean-head bias: its gradient is zero in exact arithmetic
# (the batch normalisation removes a uniform shift), so its slots and its
# step hold rounding residue (~1e-8, ~1e-16, ~1e-9), held by TOL's atol
# as the float32 checks hold them
RESIDUE = {"birvae": "['enc_mu']['b']"}
# The products whose rounding the rule cannot see (as
# tests/test_torch_port_bf16_chunk.py::UNSEEN).
UNSEEN = {"vae": set(), "birvae": set()}


def _vae_ratios(variant, port):
    """bf16_ratio of every metric, parameter and slot of one bf16 step
    against the reference's bf16 and float32 steps."""
    (s, m) = port
    js, jm, _ = _jax_vae(variant, 1, dtype="bfloat16")
    js32, jm32, _ = _jax_vae(variant, 1)
    out = {k: bf16_ratio(m[k].numpy(), jm[k], jm32[k]) for k in m}
    w = dict(tree_leaves_with_path(_vae_case(variant)[0]))
    trees = [("params", s["params"], js["params"], js32["params"], w)]
    trees += [(slot, s["opt"][slot], ref, _slots(js32)[slot], None)
              for slot, ref in _slots(js).items()]  # slots start at 0
    for key, mine_tree, ref_tree, ref32_tree, before in trees:
        ref32 = dict(tree_leaves_with_path(ref32_tree))
        for path, mine, ref in _tree_pairs(mine_tree, ref_tree):
            if path == RESIDUE.get(variant):
                ok = np.allclose(mine, ref, atol=TOL["atol"], rtol=0)
                out[key + path] = 0.0 if ok else np.inf
            else:
                out[key + path] = bf16_ratio(
                    mine, ref, ref32[path], 0.0 if before is None
                    else before[path])
    return out


@pytest.mark.parametrize("variant", ["vae", "birvae"])
def test_vae_family_bf16_one_step_matches_pallas_chunk(variant):
    ratios = _vae_ratios(variant, _port_vae(variant, 1, dtype="bfloat16"))
    worst = max(ratios.items(), key=lambda kv: kv[1])
    assert worst[1] <= 1.0, worst
    # the float32 step breaks the rule: the bf16 path rounds
    assert max(_vae_ratios(variant, _port_vae(variant, 1)).values()) > 1.0


@pytest.mark.parametrize("variant", ["vae", "birvae"])
def test_vae_family_bf16_leaves_no_product_unrounded(variant):
    """With any one product of the step left unrounded the port breaks the
    bf16 rule (tests/test_torch_port_bf16_chunk.py's planted check)."""
    n, unseen = unseen_sites(lambda: _port_vae(variant, 1, dtype="bfloat16"),
                             lambda out: _vae_ratios(variant, out))
    assert n >= 10
    assert set(unseen) == UNSEEN[variant], unseen
