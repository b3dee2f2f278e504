"""The last pieces of the GAN chunk kernel (TPU kernel #5) against the
JAX package: the G EMA plane, and what every bf16 check of the port
shares.

The port's plain versions — the CPU path of ``fused_step=True`` and the
kernels' oracles on the card — run the same steps as the TPU kernels in
interpret mode, fed the same numpy-made state and streams. Here the GAN
chunk (``gan_chunk_plain`` against ``_fused_chunk_call``) steps the G EMA
plane at ``ema_decay`` 0.9 for nsgan, wgangp, infogan, began and cgan
under Adam and RMSprop. The EMA is elementwise float32 after each G
update, so these cases are held as the other chunk tests are: rtol 2e-4
/ atol 2e-5 on every plane, the EMA plane too, and the metrics.

The bf16 rule (``bf16_ratio``) and the planted check (``planted``) are
defined here and used by tests/test_torch_port_bf16_chunk.py,
tests/test_torch_port_bf16_phase.py and
tests/test_torch_port_ema_bf16_vae.py.
"""

import contextlib
import functools
import traceback

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generative_models_tpu.ops.pallas_mlp import _ru
from generative_models_tpu.ops.pallas_train import _fused_chunk_call
from generative_models_tpu_torch.config import variant_config
from generative_models_tpu_torch.ops import cuda_train, cuda_train_vae
from generative_models_tpu_torch.ops.cuda_mlp import round_bf16
from generative_models_tpu_torch.ops.cuda_train import ChunkHyper

TOL = dict(rtol=2e-4, atol=2e-5)
# The bf16 rule. Both sides round the same float32 values to bf16, so
# they part only where an operand that each side computed (a hidden unit,
# a gradient element: float32 sums in another order, a few ulps = 2^-22
# of the value apart) lies that close to a bf16 rounding boundary: one
# element in ~2^15 takes the other bf16 neighbour, 2^-8 of itself away.
# Such a flip moves one term of the K-term sums it enters by 2^-8 of that
# term, while the rounding of all K terms' operands moves a sum by
# ~sqrt(K / 3) 2^-9 of a term: at K = 32-48, 0.5-0.6 of the rounding's own
# effect on it. So each element of a metric, of a gradient and of a state
# tensor's change in the step (the state itself is mostly what it was
# before) is held to BF16_RATIO of what the rounding does to it (the
# reference's bf16 result against its float32 result) plus the float32
# floor: F32_RTOL of the element, and F32_ULPS of the value it is stored
# in and of the tensor's largest element (a sum's float32 error scales
# with its terms, not with what is left of them). An element whose own
# rounding effect is small by cancellation can take a flip's whole step,
# so the rule sets aside each tensor's FLIP_SHARE worst elements (none of
# a tensor with fewer than 32): a flip moves a few, an operand left
# unrounded every element its product reaches.
BF16_RATIO = 0.5
F32_RTOL = 1e-5
F32_ULPS = 2.0 ** -22
FLIP_SHARE = 1.0 / 32
B, Z, H, X, HD = 8, 16, 32, 48, 24
N_CLS, CAT, CONT = 3, 4, 2
GAN = ("nsgan", "wgangp", "infogan", "began", "cgan")


def _cfg(variant, **kw):
    if variant == "cgan":
        kw["num_classes"] = N_CLS
    return variant_config(variant, batch_size=B, hidden_dim=H, z_dim=Z,
                          image_dim=X, began_ae_hidden=HD, info_cat_dim=CAT,
                          info_cont_dim=CONT, **kw)


def _widths(variant):
    """(G's input, D's input, D's hidden, D's head) of the chunk."""
    n_cls = N_CLS if variant == "cgan" else 0
    codes = CAT + CONT if variant == "infogan" else 0
    head = {"infogan": 1 + CAT + 2 * CONT, "began": X}.get(variant, 1)
    return Z + n_cls + codes, X + n_cls, HD if variant == "began" else H, head


def _state(rng, variant, adam):
    """Params, optimizer slots as after some training (mu None with
    RMSprop) and an EMA plane apart from G's params; began's output
    biases shifted as in tests/test_torch_port_began_infogan_chunk.py."""
    zin, xin, hd, head = _widths(variant)
    p = []
    for i, o in ((zin, H), (H, X), (xin, hd), (hd, head)):
        bound = 1.0 / np.sqrt(i)
        p += [rng.uniform(-bound, bound, (i, o)).astype(np.float32),
              rng.uniform(-bound, bound, (o,)).astype(np.float32)]
    if variant == "began":
        p[3] += np.float32(2.0)
        p[7] -= np.float32(2.0)
    mu = [rng.normal(0, 1e-3, a.shape).astype(np.float32) for a in p]
    nu = [rng.uniform(0, 1e-5, a.shape).astype(np.float32) for a in p]
    ema = [(a + rng.normal(0, 1e-2, a.shape)).astype(np.float32)
           for a in p[:4]]
    return p, (mu if adam else None), nu, ema


def _z_rows(rng, n, variant):
    z = rng.standard_normal((n, Z)).astype(np.float32)
    if variant != "infogan":
        return z
    return np.concatenate([
        z, np.eye(CAT, dtype=np.float32)[rng.integers(0, CAT, n)],
        rng.uniform(-1, 1, (n, CONT)).astype(np.float32)], 1)


def _streams(rng, variant, steps, ds):
    rows = steps * ds * B
    xs = rng.random((rows, X), dtype=np.float32)
    zd = _z_rows(rng, rows, variant)
    zg = _z_rows(rng, steps * B, variant)
    xtra = rng.random((rows, 1), dtype=np.float32) \
        if variant == "wgangp" else None
    if variant == "cgan":
        y = np.eye(N_CLS, dtype=np.float32)[rng.integers(0, N_CLS, rows)]
        xs = np.concatenate([xs, y], 1)
        zd = np.concatenate([zd, y], 1)
        zg = np.concatenate(
            [zg, y.reshape(steps, ds, B, N_CLS)[:, -1].reshape(-1, N_CLS)], 1)
    return xs, zd, zg, xtra


def _jax_chunk(cfg, planes, ema, t_g, t_d, lam, streams, steps, ds, dtype):
    """The TPU chunk kernel in interpret mode on the padded state (G's
    tensors with the EMA plane last, as build_fused_many_steps packs
    them). Returns each tensor's planes at true widths and the metrics
    lanes 0..7."""
    v = cfg.variant
    zin, xin, hd, head = _widths(v)
    xs, zd, zg, xtra = streams
    bp = _ru(max(B, 8), 8)
    kz, kh, kx = _ru(zin, 128), _ru(H, 128), _ru(xin, 128)
    khd = _ru(hd, 128)
    kl = kx if v == "began" else 128
    shapes = [(kz, kh), kh, (kh, kx), kx, (kx, khd), khd, (khd, kl), kl]

    def pack(q):
        ps = [pl[q] for pl in planes] + ([ema[q]] if ema and q < 4 else [])
        if isinstance(shapes[q], tuple):
            r, c = shapes[q]
            return jnp.stack([jnp.pad(a, ((0, r - a.shape[0]),
                                          (0, c - a.shape[1]))) for a in ps])
        return jnp.stack([jnp.pad(a[None, :], ((0, 7),
                                               (0, shapes[q] - a.shape[0])))
                          for a in ps])

    def pad_rows(a, groups, lanes):
        a = a.reshape(groups, B, -1)
        a = np.pad(a, ((0, 0), (0, bp - B), (0, lanes - a.shape[-1])))
        return jnp.asarray(a.reshape(groups * bp, lanes))

    jx = (jnp.zeros((8, 128), jnp.float32) if xtra is None
          else pad_rows(xtra, steps * ds, 128))
    info = v == "infogan"
    new, m = _fused_chunk_call(
        pad_rows(xs, steps * ds, kx), pad_rows(zd, steps * ds, kz),
        pad_rows(zg, steps, kz), jx, tuple(pack(q) for q in range(8)),
        jnp.array([[t_g, t_d]], jnp.int32), jnp.array([[lam, 0.0]],
                                                      jnp.float32),
        steps=steps, ds=ds, b=B, dims=(zin, H, xin), x_true=X,
        g_lr=cfg.g_lr, d_lr=cfg.d_lr, b1=cfg.adam_b1, b2=cfg.adam_b2,
        eps=cfg.adam_eps, slope=cfg.leaky_slope, variant=v,
        optimizer=cfg.optimizer, clip=0.0, dtype=dtype,
        gp_lam=cfg.gp_lambda if v == "wgangp" else 0.0,
        n_cls=N_CLS if v == "cgan" else 0, fgan_div="", fgan_ns=False,
        fisher_rho=0.0, dh_true=HD if v == "began" else 0,
        began_gamma=cfg.began_gamma if v == "began" else 0.0,
        began_lambda_k=cfg.began_lambda_k if v == "began" else 0.0,
        q_cat=CAT if info else 0, q_cont=CONT if info else 0,
        info_lam=cfg.info_lambda if info else 0.0,
        ema_decay=cfg.ema_decay, interpret=True)
    out = []
    for q, t in enumerate(new):
        t = np.asarray(t)
        a = planes[0][q]
        out.append(t[:, :a.shape[0], :a.shape[1]] if a.ndim == 2
                   else t[:, 0, :a.shape[0]])
    return out, np.asarray(m)[:, :8]




def _chunk_case(variant, optimizer, steps, ema_decay, dtype, seed):
    """A chunk check's configuration, its ChunkHyper, and the state
    (params, slots with mu None under RMSprop, the EMA plane or None),
    streams and carried scalar drawn from `seed`; wgangp at d_steps 2."""
    ds = 2 if variant == "wgangp" else 1
    cfg = _cfg(variant, d_steps=ds, optimizer=optimizer, ema_decay=ema_decay,
               dtype=dtype)
    hp = ChunkHyper.from_config(cfg)
    assert (hp.ema_decay, hp.dtype) == (ema_decay, dtype)
    rng = np.random.default_rng(seed)
    p, mu, nu, ema = _state(rng, variant, optimizer == "adam")
    streams = _streams(rng, variant, steps, ds)
    lam = 0.3 if variant == "began" else 0.0
    return cfg, hp, ds, (p, mu, nu, ema if ema_decay else None), streams, lam


def _per_tensor(p, mu, nu, ema):
    """Per state tensor, its planes in the reference's order: p, mu (Adam),
    nu, and for G's tensors the EMA plane."""
    return [[pl[q] for pl in (p, mu, nu) if pl is not None]
            + ([ema[q]] if ema is not None and q < 4 else [])
            for q in range(8)]


@functools.lru_cache(maxsize=None)
def jax_chunk(variant, optimizer, steps, ema_decay, dtype, seed=3):
    """The TPU chunk kernel in interpret mode from _chunk_case's state:
    (per tensor its planes, as _per_tensor orders them; the metrics).
    Cached: the checks of a file read one run several times."""
    cfg, _, ds, (p, mu, nu, ema), streams, lam = _chunk_case(
        variant, optimizer, steps, ema_decay, dtype, seed)
    planes = [pl for pl in (p, mu, nu) if pl is not None]
    return _jax_chunk(cfg, planes, ema, 5, 7, lam, streams, steps, ds, dtype)


def port_chunk(variant, optimizer, steps, ema_decay, dtype, seed=3):
    """The port's chunk function (on CPU tensors its plain version) from
    the same state: (per tensor its planes after, the metrics, per tensor
    its planes before)."""
    _, hp, ds, (p, mu, nu, ema), streams, lam = _chunk_case(
        variant, optimizer, steps, ema_decay, dtype, seed)
    t = lambda a: None if a is None else torch.from_numpy(a.copy())
    tp, tmu, tnu, tema = ([t(a) for a in pl] if pl is not None else None
                          for pl in (p, mu, nu, ema))
    xs, zd, zg, xtra = streams
    m = cuda_train.gan_chunk(t(xs), t(zd), t(zg), tp, tmu, tnu, steps=steps,
                             ds=ds, batch=B, t_g=5, t_d=7, hp=hp, lam=lam,
                             xtra=t(xtra), ema=tema)
    assert cuda_train.launches == 0
    after = [[a.numpy() for a in planes]
             for planes in _per_tensor(tp, tmu, tnu, tema)]
    return after, m.numpy(), _per_tensor(p, mu, nu, ema)


@pytest.mark.parametrize("variant,optimizer",
                         [(v, o) for v in GAN for o in ("adam", "rmsprop")])
def test_gan_chunk_ema_matches_pallas_chunk(variant, optimizer):
    got, m, _ = port_chunk(variant, optimizer, 3, 0.9, "float32")
    want, want_m = jax_chunk(variant, optimizer, 3, 0.9, "float32")
    np.testing.assert_allclose(m, want_m, err_msg="metrics", **TOL)
    for q in range(8):
        assert len(got[q]) == len(want[q])  # the critic has no EMA plane
        for i, pl in enumerate(got[q]):
            np.testing.assert_allclose(pl, want[q][i],
                                       err_msg=f"tensor {q} plane {i}", **TOL)
    for q in range(4):  # the EMA plane: G's tensors' last plane
        assert not np.array_equal(got[q][-1], got[q][0])


# ---------------------------------------------------------------------
# What the bf16 checks share
# ---------------------------------------------------------------------

def bf16_ratio(got, ref, ref32, before=0.0):
    """The bf16 rule on one tensor: each element's |got - ref| over
    BF16_RATIO |ref - ref32| plus the float32 floor, on the change from
    `before` (a gradient, a metric: 0), and the largest of these once the
    FLIP_SHARE worst are set aside. The rule holds where this is at most
    1."""
    got, ref, ref32 = (np.asarray(a, np.float64) for a in (got, ref, ref32))
    before = np.asarray(before, np.float64)
    g, r, r32 = got - before, ref - before, ref32 - before
    lim = (BF16_RATIO * np.abs(r - r32) + F32_RTOL * np.abs(r)
           + F32_ULPS * (np.abs(ref) + np.abs(r).max()))
    ratio = np.sort((np.abs(g - r) / np.maximum(lim, 1e-30)).ravel())
    return float(ratio[-1 - int(ratio.size * FLIP_SHARE)])


def chunk_ratios(port, ref, ref32):
    """bf16_ratio of each state plane and of the metrics of a chunk run:
    `port` as port_chunk returns it, `ref` and `ref32` as jax_chunk."""
    (got, m, before), (want, want_m), (want32, want32_m) = port, ref, ref32
    out = {f"metrics lane {j}": bf16_ratio(m[:, j], want_m[:, j],
                                           want32_m[:, j]) for j in range(8)}
    for q in range(8):
        for i, a in enumerate(got[q]):
            out[f"tensor {q} plane {i}"] = bf16_ratio(
                a, want[q][i], want32[q][i], before[q][i])
    return out


@contextlib.contextmanager
def planted(skip):
    """The port's plain versions with the `skip`-th bf16 product of a run
    (or rounding of an operand outside a product: infogan's MI targets,
    the penalty's terms) left unrounded. Yields the list of those sites
    the run passes, each its caller's source line."""
    sites = []

    def hit():
        sites.append(traceback.extract_stack()[-3].line.strip())
        return len(sites) - 1 == skip

    def mm(a, b, bf16):
        if bf16 and not hit():
            a, b = round_bf16(a), round_bf16(b)
        return a @ b

    def rnd(t):
        return t if hit() else round_bf16(t)

    saved = cuda_train.mm, cuda_train_vae.mm, cuda_train.round_bf16
    cuda_train.mm = cuda_train_vae.mm = mm
    cuda_train.round_bf16 = rnd
    try:
        yield sites
    finally:
        cuda_train.mm, cuda_train_vae.mm, cuda_train.round_bf16 = saved


def unseen_sites(run, ratios):
    """Runs `run()` once for each bf16 product (and rounding outside a
    product) it passes, with that one left unrounded, and returns (the
    number of sites, the source lines of those whose planted run the bf16
    rule still holds: every value of `ratios(run())` at most 1)."""
    with planted(-1) as sites:
        run()
    unseen = []
    for k in range(len(sites)):
        with planted(k) as s:
            out = run()
        if max(ratios(out).values()) <= 1.0:
            unseen.append(s[k])
    return len(sites), unseen
