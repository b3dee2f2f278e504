"""The port's causal-transformer prior (``models/ar_prior.py``), vqprior
(``losses/vqprior.py``), two-stage training (``train/vq.py``,
``--vq-from``), checkpoints and the exported samplers against the JAX
package's on the CPU, and the MLP kernels' launches on the VQ paths.

Weights, data and tolerances as ``tests/test_torch_port_vq.py``:
``NET_TOL`` (rtol 1e-4, atol 1e-5) for nets and gradients, ``TOL`` (rtol
2e-4, atol 2e-5) for losses, metrics, Adam steps and decoded images.
The tie rule of that file holds every case that quantizes (the code
margin) and every sampler run: token i is ``argmax(logits_i / T +
g_i)``, the reference's ``jax.random.categorical`` with g_i its Gumbel
draws, handed over here; a run is held only where the smallest relative
gap between the best and second-best score (``losses/vqprior.py::
sample_margin``) clears ``VQ_MARGIN``. The frozen tokenizer and its
Adam moments are held bit for bit.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generative_models_tpu.losses import vqprior as jvqprior
from generative_models_tpu.losses.registry import get_variant as jax_variant
from generative_models_tpu.models import ar_prior as jprior
from generative_models_tpu.train import step as jstep
from generative_models_tpu_torch.losses import vqprior as pvqprior
from generative_models_tpu_torch.losses.registry import get_variant
from generative_models_tpu_torch.models import ar_prior as pprior
from generative_models_tpu_torch.models import vq_net as pnet
from generative_models_tpu_torch.train import step as step_lib
from generative_models_tpu_torch.utils.tree import (
    tree_leaves,
    tree_leaves_with_path,
    tree_unflatten,
)
from tests.conftest import tiny_cfg
from tests.test_torch_port_ddpm import assert_tree, to_port
from tests.test_torch_port_vq import (
    SMALL,
    VQ_MARGIN,
    B,
    batch_of,
    cfgs,
    export_round_trip,
    grads_of,
    shifted,
    tie_free,
    vqvae_margin,
    with_grad,
)

NET_TOL = dict(rtol=1e-4, atol=1e-5)
TOL = dict(rtol=2e-4, atol=2e-5)
EXACT = dict(rtol=0, atol=0)
K, L = 16, 4


def jax_vqprior(jcfg, seed, shift=0.05):
    """vqprior's JAX tree (prior and vqvae), shifted (the head off 0)."""
    return shifted(jvqprior.init_params(jax.random.PRNGKey(seed), jcfg),
                   seed, shift)


def tokens_in(seed, b=B, l=L):
    """Shifted input tokens [b, l] in [0, K] (BOS = K first) and labels."""
    rng = np.random.default_rng(seed)
    t = rng.integers(0, K, (b, l))
    t[:, 0] = K
    return t.astype(np.int32), rng.integers(0, 10, b).astype(np.int32)


# --------------------------------------------------------------------
# The prior
# --------------------------------------------------------------------

@pytest.mark.parametrize("cond", [False, True])
def test_prior_matches_jax(cond):
    """prior_apply's logits and every gradient of sum(logits * r)."""
    jcfg, cfg = cfgs("vqprior", ddpm_cond=cond)
    jp = jax_vqprior(jcfg, 1)["prior"]
    tin, y = tokens_in(2)
    r = np.random.default_rng(3).standard_normal((B, L, K)).astype(
        np.float32)
    yy = jnp.asarray(y) if cond else None

    def jf(p):
        out = jprior.prior_apply(p, jnp.asarray(tin), jcfg, yy)
        return jnp.sum(out * r), out
    (_, j_out), j_g = jax.jit(jax.value_and_grad(jf, has_aux=True))(
        jax.tree.map(jnp.asarray, jp))
    pp = with_grad(to_port(jp))
    out = pprior.prior_apply(pp, torch.from_numpy(tin), cfg,
                             torch.from_numpy(y) if cond else None)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out),
                               **NET_TOL)
    assert_tree(grads_of((out * torch.from_numpy(r)).sum(), pp), j_g,
                f"prior cond={cond} grad", NET_TOL)


def test_prior_init_is_causal_and_starts_at_log_k():
    """The zero head gives uniform logits (CE log K); logits at i depend on
    tokens_in[:, :i + 1] alone; the tree is the reference's."""
    jcfg, cfg = cfgs("vqprior", ddpm_cond=True)
    p = pprior.prior_init(torch.Generator().manual_seed(0), cfg)
    jp = jprior.prior_init(jax.random.PRNGKey(0), jcfg)
    assert {q: tuple(t.shape) for q, t in tree_leaves_with_path(p)} == {
        q: a.shape for q, a in tree_leaves_with_path(
            jax.tree.map(np.asarray, jp))}
    tin, _ = tokens_in(4)
    logits = pprior.prior_apply(p, torch.from_numpy(tin), cfg)
    ce = pvqprior.prior_ce(logits, torch.from_numpy(tin[:, 1:]).repeat(1, 2)[
        :, :L])
    assert float(ce) == pytest.approx(np.log(K), abs=1e-6)
    p = to_port(jax_vqprior(jcfg, 5)["prior"])
    base = pprior.prior_apply(p, torch.from_numpy(tin), cfg)
    for j in range(1, L):
        moved = tin.copy()
        moved[:, j] = (moved[:, j] + 1) % K
        out = pprior.prior_apply(p, torch.from_numpy(moved), cfg)
        assert torch.equal(out[:, :j], base[:, :j])
        assert not torch.allclose(out[:, j], base[:, j])


@pytest.mark.parametrize("cond", [False, True])
def test_prior_apply_step_matches_prior_apply(cond):
    """The KV-cache twin, position by position, against the port's full
    form and the reference's step."""
    jcfg, cfg = cfgs("vqprior", ddpm_cond=cond)
    jp = jax_vqprior(jcfg, 6)["prior"]
    p = to_port(jp)
    tin, y = tokens_in(7)
    yt = torch.from_numpy(y) if cond else None
    full = pprior.prior_apply(p, torch.from_numpy(tin), cfg, yt)
    kv = pprior.init_kv_cache(B, cfg)
    j_kv = jprior.init_kv_cache(B, jcfg)
    jpp = jax.tree.map(jnp.asarray, jp)
    for i in range(L):
        step = pprior.prior_apply_step(p, torch.from_numpy(tin[:, i]), i, kv,
                                       cfg, yt)
        j_step, j_kv = jprior.prior_apply_step(
            jpp, jnp.asarray(tin[:, i]), i, j_kv, jcfg,
            jnp.asarray(y) if cond else None)
        np.testing.assert_allclose(step.numpy(), full[:, i].numpy(),
                                   **NET_TOL)
        np.testing.assert_allclose(step.numpy(), np.asarray(j_step),
                                   **NET_TOL)
    for mine, theirs in zip(kv, j_kv):
        for name in ("k", "v"):
            np.testing.assert_allclose(mine[name].numpy(),
                                       np.asarray(theirs[name]), **NET_TOL)


def jax_gumbel_chain(rng, n, k=K):
    """Step i -> the reference's Gumbel draws of step i."""
    return lambda i: torch.from_numpy(np.array(jax.random.gumbel(
        jax.random.fold_in(rng, i), (n, k))))


@pytest.mark.parametrize("decode,cond", [("cache", False), ("full", False),
                                         ("cache", True), ("full", True)])
def test_sample_tokens_match_jax_with_its_gumbel_draws(decode, cond):
    """Both decodes draw the reference's tokens from its Gumbel chain
    (the tie rule on the draws' key), and sample / sample_class its
    images."""
    jcfg, cfg = cfgs("vqprior", ddpm_cond=cond, vq_decode=decode,
                     vq_prior_temp=0.8)
    jp = jax_vqprior(jcfg, 8, shift=0.2)
    pp = to_port(jp)
    jpp = jax.tree.map(jnp.asarray, jp)
    n = 6
    y = torch.arange(n) % 10 if cond else None

    def margin(seed):
        chain = jax_gumbel_chain(jax.random.PRNGKey(seed), n)
        toks = pvqprior.sample_tokens(pp["prior"], None, n, cfg, y, chain)
        return pvqprior.sample_margin(pp["prior"], toks, cfg, chain, y)
    seed, m = tie_free(margin, first=9)
    assert m > VQ_MARGIN
    rng = jax.random.PRNGKey(seed)
    chain = jax_gumbel_chain(rng, n)
    want = np.asarray(jvqprior.sample_tokens(
        jpp["prior"], rng, n, jcfg, None if y is None else jnp.asarray(y)))
    got = pvqprior.sample_tokens(pp["prior"], None, n, cfg, y, chain)
    np.testing.assert_array_equal(got.numpy(), want)
    other = cfg.replace(vq_decode="full" if decode == "cache" else "cache")
    assert torch.equal(pvqprior.sample_tokens(pp["prior"], None, n, other, y,
                                              chain), got)
    np.testing.assert_allclose(
        pvqprior.sample(pp, None, n, cfg, chain=chain).numpy(),
        np.asarray(jvqprior.sample(jpp, rng, n, jcfg)), **TOL)
    if cond:
        yc = torch.full((n,), 3)
        toks = pvqprior.sample_tokens(pp["prior"], None, n, cfg, yc, chain)
        assert pvqprior.sample_margin(pp["prior"], toks, cfg, chain,
                                      yc) > VQ_MARGIN
        np.testing.assert_allclose(
            pvqprior.sample_class(pp, None, n, 3, cfg, chain=chain).numpy(),
            np.asarray(jvqprior.sample_class(jpp, rng, n, 3, jcfg)), **TOL)


def test_gumbel_maps_and_the_generator_draw():
    """gumbel_of_normal gives standard Gumbel draws (mean Euler's gamma,
    variance pi^2 / 6) bounded as the reference's; without a chain the
    sampler draws its own, repeatably for one generator seed."""
    z = torch.randn(400_000, generator=torch.Generator().manual_seed(0))
    g = pvqprior.gumbel_of_normal(z)
    assert bool(torch.isfinite(g).all())
    assert float(g.mean()) == pytest.approx(0.5772, abs=1e-2)
    assert float(g.var()) == pytest.approx(np.pi ** 2 / 6, abs=3e-2)
    edge = pvqprior.gumbel_of_uniform(torch.tensor([0.0, 1.0]))
    assert bool(torch.isfinite(edge).all())
    _, cfg = cfgs("vqprior")
    p = pvqprior.init_params(torch.Generator().manual_seed(0), cfg)
    a, b = (pvqprior.sample_tokens(p["prior"],
                                   torch.Generator().manual_seed(3), 5, cfg)
            for _ in range(2))
    assert torch.equal(a, b) and a.shape == (5, L)
    assert 0 <= int(a.min()) and int(a.max()) < K


# --------------------------------------------------------------------
# The loss and the general step
# --------------------------------------------------------------------

@pytest.mark.parametrize("arch,frozen,cond", [
    ("mlp", False, False), ("mlp", True, False), ("mlp", False, True),
    ("conv", False, False)])
def test_vqprior_loss_and_gradients_match_jax(arch, frozen, cond):
    jcfg, cfg = cfgs("vqprior", arch=arch, vq_freeze_tokenizer=frozen,
                     ddpm_cond=cond)
    jp = jax_vqprior(jcfg, 10, shift=0.02)
    pp = with_grad(to_port(jp))
    seed, margin = tie_free(
        lambda s: vqvae_margin(pp["vqvae"], batch_of(s)[0], cfg), first=11)
    assert margin > VQ_MARGIN
    x, y = batch_of(seed)
    batch = {"image": jnp.asarray(x), "label": jnp.asarray(y)}
    (j_val, j_m), j_g = jax.jit(jax.value_and_grad(
        lambda p: jvqprior.loss(p, batch, None, jcfg), has_aux=True))(
        jax.tree.map(jnp.asarray, jp))
    val, m = pvqprior.loss(pp, {"image": torch.from_numpy(x),
                                "label": torch.from_numpy(y)}, None, cfg)
    assert sorted(m) == sorted(j_m)
    for k in m:
        np.testing.assert_allclose(float(m[k]), float(j_m[k]), err_msg=k,
                                   **TOL)
    leaves = tree_leaves(pp)
    g = torch.autograd.grad(val, leaves, allow_unused=True,
                            materialize_grads=True)
    assert_tree(tree_unflatten(pp, list(g)), j_g, "vqprior grad", NET_TOL)
    if frozen:
        assert all(not bool(t.any()) for t in
                   tree_leaves(tree_unflatten(pp, list(g))["vqvae"]))


STEPS = 3


@pytest.mark.parametrize("frozen", [False, True])
def test_vqprior_general_steps_match_jax(frozen):
    """STEPS general steps from one state and the same batches: losses,
    params and Adam slots within TOL of the reference; with the frozen
    tokenizer its subtree and its Adam moments bit-exact, as the
    reference's are."""
    jcfg, cfg = cfgs("vqprior", vq_freeze_tokenizer=frozen, ddpm_cond=True)
    jspec, spec = jax_variant("vqprior"), get_variant("vqprior")
    state = jstep.init_state(jspec, jcfg, jax.random.PRNGKey(0))
    state["params"] = jax.tree.map(jnp.asarray, jax_vqprior(jcfg, 12, 0.02))
    state["opt"] = jstep.make_tx(jcfg, jcfg.g_lr).init(state["params"])
    pst = step_lib.init_state(spec, cfg, torch.Generator().manual_seed(0))
    pst["params"] = to_port(state["params"])
    vq0 = [t.clone() for t in tree_leaves(pst["params"]["vqvae"])]
    train = step_lib.build_step(spec, cfg)

    def run(first):
        st, out = pst, []
        for k in range(STEPS):
            x, y = batch_of(first + k)
            m = vqvae_margin(st["params"]["vqvae"], x, cfg)
            st, pm = train(st, {"image": torch.from_numpy(x)[None],
                                "label": torch.from_numpy(y)[None]},
                           torch.zeros(B, 0))
            out.append((x, y, pm, m))
        return st, out
    first, _ = tie_free(lambda s: min(m for *_, m in run(s)[1]), first=30)
    pst, out = run(first)
    j_train = jax.jit(jstep.build_step(jspec, jcfg))
    for x, y, pm, margin in out:
        assert margin > VQ_MARGIN
        state, jm = j_train(state, {"image": jnp.asarray(x)[None],
                                    "label": jnp.asarray(y)[None]})
        for k in ("loss", "prior_loss", "recon_loss", "vq_loss"):
            np.testing.assert_allclose(float(pm[k]), float(jm[k]), err_msg=k,
                                       **TOL)
    assert_tree(pst["params"], state["params"], "params", TOL)
    assert_tree(pst["opt"]["mu"], state["opt"][0].mu, "mu", TOL)
    assert_tree(pst["opt"]["nu"], state["opt"][0].nu, "nu", TOL)
    if frozen:
        for a, b in zip(tree_leaves(pst["params"]["vqvae"]), vq0):
            assert torch.equal(a, b)
        for slot in ("mu", "nu"):
            assert all(not bool(t.any()) for t in
                       tree_leaves(pst["opt"][slot]["vqvae"]))
        assert_tree(pst["params"]["vqvae"], state["params"]["vqvae"],
                    "frozen vqvae", EXACT)


# --------------------------------------------------------------------
# Launches of the MLP kernels on the VQ paths
# --------------------------------------------------------------------

def count_launches(monkeypatch):
    """Spies on the tokenizer's stacks and the prior's linears: each call
    is one forward launch on the card, and one backward launch when its
    output takes part in a gradient (requires grad)."""
    calls = []

    def spy(real):
        def f(*a, **kw):
            out = real(*a, **kw)
            calls.append(out.requires_grad)
            return out
        return f
    monkeypatch.setattr(pnet, "mlp_apply", spy(pnet.mlp_apply))
    monkeypatch.setattr(pprior, "fused_linear", spy(pprior.fused_linear))
    return calls


# (variant, overrides) -> (forward, backward) launches of one loss
LOSS_LAUNCHES = {
    ("vqvae", "mlp", False): (2, 2),
    ("vqvae", "conv", False): (0, 0),
    ("vqprior", "mlp", False): (11, 11),   # 2 tokenizer + 9 prior
    ("vqprior", "mlp", True): (11, 9),     # the frozen tokenizer's none
    ("vqprior", "conv", False): (9, 9),
}


@pytest.mark.parametrize("key", sorted(LOSS_LAUNCHES))
def test_loss_launch_counts(monkeypatch, key):
    variant, arch, frozen = key
    kw = {"vq_freeze_tokenizer": True} if frozen else {}
    _, cfg = cfgs(variant, arch=arch, **kw)
    spec = get_variant(variant)
    params = with_grad(spec.init_params(torch.Generator().manual_seed(0),
                                        cfg))
    calls = count_launches(monkeypatch)
    x, y = batch_of(0)
    val, _ = spec.loss(params, {"image": torch.from_numpy(x),
                                "label": torch.from_numpy(y)}, None, cfg)
    assert (len(calls), sum(calls)) == LOSS_LAUNCHES[key]


@pytest.mark.parametrize("variant,decode", [("vqvae", "cache"),
                                            ("vqprior", "cache"),
                                            ("vqprior", "full")])
def test_sampler_launch_counts(monkeypatch, variant, decode):
    """Serving the MLP arch: 9 prior launches a position (4 a block, 2
    blocks, the head) in either decode, then 1 decoder launch."""
    _, cfg = cfgs(variant, vq_decode=decode)
    spec = get_variant(variant)
    params = spec.init_params(torch.Generator().manual_seed(0), cfg)
    calls = count_launches(monkeypatch)
    with torch.no_grad():
        out = spec.sample(params, torch.Generator().manual_seed(1), 5, cfg)
    assert out.shape == (5, 784)
    want = 1 if variant == "vqvae" else 9 * L + 1
    assert (len(calls), sum(calls)) == (want, 0)


# --------------------------------------------------------------------
# Checkpoints, --vq-from, export
# --------------------------------------------------------------------

def small_flags(**kw):
    merged = dict(SMALL, sample_n=4, scan_steps=2, **kw)
    return [f"--{k.replace('_', '-')}={v}" for k, v in merged.items()]


def test_vq_from_a_jax_checkpoint_trains_a_frozen_prior(tmp_path, tiny_data,
                                                        capsys):
    """A vqvae checkpoint written by the JAX package: --vq-from loads it
    into the prior run's tokenizer, which the run's checkpoint holds bit
    for bit with zero Adam moments; the prior's leaves moved. With
    --sample-only it is the reference's usage error (rc 2)."""
    from generative_models_tpu.train.trainer import Trainer as JaxTrainer
    from generative_models_tpu_torch import cli
    from generative_models_tpu_torch.utils.checkpoint import read_leaves
    jt = JaxTrainer(config=tiny_cfg("vqvae", **SMALL, scan_steps=2),
                    data=tiny_data)
    jt.train(steps=2)
    src = str(tmp_path / "stage1.npz")
    jt.save_model(src)
    out = str(tmp_path / "prior.npz")
    rc = cli.main(["--variant", "vqprior", "--device", "cpu", "--dataset",
                   "synthetic", "--vq-from", src, "--ckpt", out, "--steps",
                   "3", "--echo-every", "0", "--out-dir", str(tmp_path),
                   *small_flags()])
    assert rc == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == f"vqprior: frozen tokenizer from {src}"
    assert json.loads([l for l in lines if l.startswith("{")][0])[
        "steps"] == 3
    stage1, trained = read_leaves(src), read_leaves(out)
    vq_paths = [p for p in trained if p.startswith("['params']['vqvae']")]
    assert len(vq_paths) == 9   # two layers each way, the codebook
    for p in vq_paths:
        np.testing.assert_array_equal(
            trained[p], stage1[p.replace("['vqvae']", "")])
        for slot in ("mu", "nu"):
            q = p.replace("['params']", f"['opt'][0].{slot}")
            assert not trained[q].any()
    assert not np.array_equal(trained["['params']['prior']['tok']"],
                              trained["['opt'][0].mu['prior']['tok']"] * 0)
    with pytest.raises(SystemExit) as e:
        cli.main(["--variant", "vqprior", "--device", "cpu", "--vq-from",
                  src, "--ckpt", out, "--sample-only"])
    assert e.value.code == 2
    assert "--vq-from" in capsys.readouterr().err


def test_checkpoints_cross_both_ways(tmp_path, tiny_data):
    """A JAX vqprior checkpoint (params, Adam slots, rng) loads into the
    port leaf for leaf; a port one loads into the JAX Trainer."""
    from generative_models_tpu.train.trainer import Trainer as JaxTrainer
    from generative_models_tpu_torch.train.trainer import Trainer
    kw = dict(SMALL, scan_steps=2, ddpm_cond=True)
    jt = JaxTrainer(config=tiny_cfg("vqprior", **kw), data=tiny_data)
    jt.train(steps=2)
    path = str(tmp_path / "j.npz")
    jt.save_model(path)
    t = Trainer("vqprior", device="cpu", data=tiny_data, **kw)
    t.load_model(path)
    assert t.state["step"] == 2
    assert_tree(t.state["params"], jt.state["params"], "params", EXACT)
    assert_tree(t.state["opt"]["nu"], jt.state["opt"][0].nu, "nu", EXACT)
    t.train(steps=2)
    back = t.save_model(str(tmp_path / "p.npz"))
    jt2 = JaxTrainer(config=tiny_cfg("vqprior", **kw), data=tiny_data)
    jt2.load_model(back)
    assert int(jt2.state["step"]) == 4
    assert_tree(t.state["params"], jt2.state["params"], "params", EXACT)
    assert_tree(t.state["opt"]["mu"], jt2.state["opt"][0].mu, "mu", EXACT)


def test_exported_sampler_equals_trainer_sample(tmp_path):
    """vqprior's artifact (conditional): its chain is the Philox normals
    at offsets 1..L, of width K, each mapped to Gumbel draws; it maps a
    seed to Trainer.sample given those draws, bit for bit per seed (vqvae's
    case: tests/test_torch_port_vq.py)."""
    from generative_models_tpu_torch.utils import export
    jcfg, _ = cfgs("vqprior", ddpm_cond=True)
    draws = export_round_trip(tmp_path, "vqprior", {"ddpm_cond": True},
                              to_port(jax_vqprior(jcfg, 13, 0.1)))
    assert draws["chain"](0).shape == (3, K)
    chain = export.sampler_chain(torch.tensor(123), 3, K)
    assert torch.equal(draws["chain"](1), pvqprior.gumbel_of_normal(
        chain(1)))
