"""The port's optimizers against optax via the JAX package's ``make_tx``:
20 steps of Adam (optax convention) and RMSprop (eps outside the sqrt)
on the same params and gradient sequence agree to rtol 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from generative_models_tpu.config import variant_config as jax_variant_config
from generative_models_tpu.train.optim import make_tx
from generative_models_tpu_torch.config import variant_config
from generative_models_tpu_torch.train import optim

STEPS = 20


def _params(rng):
    return [{"w": rng.normal(0, 0.1, (6, 5)).astype(np.float32),
             "b": rng.normal(0, 0.1, (5,)).astype(np.float32)},
            {"w": rng.normal(0, 0.1, (5, 1)).astype(np.float32),
             "b": rng.normal(0, 0.1, (1,)).astype(np.float32)}]


@pytest.mark.parametrize("variant,opt,lr", [
    ("nsgan", "adam", 2e-4), ("wgangp", "adam", 1e-4),
    ("nsgan", "rmsprop", 5e-5)])
def test_optimizer_matches_optax(variant, opt, lr):
    jcfg = jax_variant_config(variant, optimizer=opt)
    cfg = variant_config(variant, optimizer=opt)
    rng = np.random.default_rng(0)
    p0 = _params(rng)
    grads = [[{k: rng.normal(0, 1e-2 * (1 + s), v.shape).astype(np.float32)
               for k, v in l.items()} for l in p0] for s in range(STEPS)]

    tx = make_tx(jcfg, lr)
    jp = jax.tree.map(jnp.asarray, p0)
    js = tx.init(jp)
    tp = [{k: torch.from_numpy(v.copy()) for k, v in l.items()} for l in p0]
    ts = optim.init_opt(cfg, tp)
    for g in grads:
        upd, js = tx.update(jax.tree.map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, upd)
        tp, ts = optim.apply_opt(
            cfg, tp, [{k: torch.from_numpy(v) for k, v in l.items()}
                      for l in g], ts, lr)
    for mine, theirs in zip(tp, jp):
        for k in ("w", "b"):
            np.testing.assert_allclose(mine[k].numpy(), np.asarray(theirs[k]),
                                       rtol=1e-6, atol=1e-9)
    slots = ("mu", "nu") if opt == "adam" else ("nu",)
    for slot in slots:
        for mine, theirs in zip(ts[slot], getattr(js[0], slot)):
            for k in ("w", "b"):
                np.testing.assert_allclose(mine[k].numpy(),
                                           np.asarray(theirs[k]),
                                           rtol=1e-6, atol=1e-12)
    if opt == "adam":
        assert int(ts["count"]) == int(js[0].count) == STEPS
        assert ts["count"].dtype == torch.int32
    else:
        assert sorted(ts) == ["nu"]


def test_unknown_optimizer_raises():
    cfg = variant_config("nsgan")
    object.__setattr__(cfg, "optimizer", "sgd")
    with pytest.raises(ValueError, match="unknown optimizer"):
        optim.init_opt(cfg, [])
