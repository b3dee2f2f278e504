"""Data-parallel GAN training through per-phase gradient kernels — the
port of ``generative_models_tpu/ops/pallas_dp.py``.

Data parallelism cannot keep the chunk kernel's state resident: every D
and G update must consume the gradient averaged over all ranks, so the
step breaks at each gradient boundary for a collective. Per step, at
d_steps ds:

- ds times :func:`d_phase`: one kernel launch computes one critic
  update's gradients on the rank's local rows (G forward, the critic on
  real and fake, the hook's dL/dlogit, the penalty's double backward,
  the full backward) and its metrics row, into ONE flat buffer; one
  all-reduce averages it over the ranks; the port's optimizer
  (``train/optim.py``), ``spec.d_post`` (wgan's clip) and
  ``spec.d_state_update`` run on every rank alike;
- once :func:`g_phase`: the G update's gradients through the post-update
  critic, one all-reduce, the optimizer, ``spec.step_state_update``
  (began's k_t law), then the EMA of G.

The step around the launches is the general step's
(``train/step.py::build_adversarial_step`` with :func:`phase_grads` as
its gradient source), driven by ``parallel/dp.py``'s chunk loop. So a
step makes ds + 1 phase launches and ds + 1 all-reduces. The
kernels are ``gan_phase_kernel<M_D>`` and ``<M_G>`` of
``csrc/gan_chunk.cu`` built with ``-DGM_PHASE=1``: a body of each mode's
own on the chunk's product engine, whose epilogues write the gradient
where the chunk steps the optimizer; one library a critic hook
(:data:`DP_HOOKS`, nine), both phase kernels in each, built at first
use; with ``dtype="bfloat16"`` a second library a hook, built with
``-DGM_BF16=1``, whose products take bf16 operands as the reference's
phase kernels do (``pallas_dp.py:128, 214``). A launch goes through a
plan (:class:`_Plan`, cached per mode, hyperparameters, shapes, device
and stream: the C side's arguments but the call's pointers, its
scratch, its grid), so a call allocates its flat buffer from the
caching allocator, fills in pointers and launches: no memset (the
kernels write every float of it), no occupancy query, began's k read
through the caller's tensor. As the reference notes of its own path
(``pallas_dp.py:26-40``), the all-reduce and the optimizer outside the
kernels still set much of a step's pace at these sizes.

On a CUDA tensor :func:`d_phase` / :func:`g_phase` launch the kernel or
raise; on a CPU tensor they run :func:`d_phase_plain` /
:func:`g_phase_plain` (the chunk's plain math, ``ops/cuda_train.py::
critic_grads`` and ``g_grads``, in the inputs' dtype, bf16 operands per
``hp.dtype``), which are also the kernels' oracle on the card.
``d_launches`` and ``g_launches`` count the kernels' launches,
``d_bf16_launches`` and ``g_bf16_launches`` those of the bf16 kernels
among them.

The flat buffer of a phase holds the gradients at their true widths, in
the order W1, b1, W2, b2 (infogan's critic head: the D and Q heads side
by side, as the reference packs them at ``pallas_dp.py:360-384``), then
the metrics row of 8 lanes, the reference's: D phase lanes 0 d_loss
(with the penalty), 1 and 2 the real and fake logit means (began: the
energies; infogan: lane 1 the MI term), 4 and 5 the penalty and the mean
input-gradient norm, 7 the carried k it read (began); G phase lane 3
g_loss, lane 6 infogan's G MI term.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, Optional, Tuple

import torch

from generative_models_tpu_torch.models.nets import infogan_head, onehot
from generative_models_tpu_torch.ops import cuda_train
from generative_models_tpu_torch.ops.cuda_train import (
    BLOCKS_PER_SM,
    HOOK_IDS,
    HOOKS,
    METRIC_LANES,
    ChunkHyper,
)
from generative_models_tpu_torch.ops.penalty import aux_lanes
from generative_models_tpu_torch.train.step import build_adversarial_step

SOURCE = cuda_train.SOURCE  # built with -DGM_PHASE=1
# the reference's order (pallas_train.FUSED_VARIANTS without the
# batch-coupled members and the single models)
FUSED_DP_VARIANTS = ("nsgan", "mmgan", "lsgan", "wgan", "cgan", "dragan",
                     "wgangp", "fgan", "began", "infogan")
DP_HOOKS = tuple(dict.fromkeys(HOOKS[v] for v in FUSED_DP_VARIANTS))
M_D, M_G = 1, 2

d_launches = 0
g_launches = 0
d_bf16_launches = 0
g_bf16_launches = 0


def fused_dp_supported(spec, cfg) -> Tuple[bool, str]:
    """(ok, reason) for the phase kernels' path (``fused_step=True`` with
    a data group), with the reference's reasons for the variants it
    leaves out. The kernel constraints are the chunk kernel's
    (``cuda_train.fused_step_supported``) but for three that do not
    apply: the world (each rank runs its own launches), the optimizer
    and the EMA (both run after the all-reduce, outside the kernels; so
    wgangp trains with RMSprop here too). ``dtype="bfloat16"`` takes the
    bf16 phase libraries."""
    v = cfg.variant
    if v not in FUSED_DP_VARIANTS:
        if v in ("ragan", "fishergan"):
            return False, (f"{v} couples gradients through global-batch "
                           "statistics; the general DP step all-reduces "
                           "them (losses/base.py batch_coupled)")
        if v in ("vae", "birvae"):
            return False, (f"{v} is single-model; its general DP step is "
                           "already one region")
        return False, f"fused DP covers {FUSED_DP_VARIANTS} only"
    return cuda_train.fused_step_supported(spec, cfg.replace(
        dp=1, tp=1, ema_decay=0.0, optimizer="adam"))


# ---------------------------------------------------------------------
# Packing: the state's trees <-> the kernels' tensors and flat buffers
# ---------------------------------------------------------------------

def pack_g(g_params) -> List[torch.Tensor]:
    """G as the kernels take it: W1g, b1g, W2g, b2g (the state's own
    tensors)."""
    return [l[k] for l in g_params for k in ("w", "b")]


def pack_d(d_params) -> List[torch.Tensor]:
    """The critic as the kernels take it: W1d, b1d, W2d, b2d; infogan's
    D and Q heads side by side in one W2d, b2d (new tensors)."""
    if isinstance(d_params, dict):
        head = infogan_head(d_params)
        return [d_params["trunk"][0]["w"], d_params["trunk"][0]["b"],
                head["w"], head["b"]]
    return [l[k] for l in d_params for k in ("w", "b")]


def _sizes(tensors) -> List[int]:
    return [t.numel() for t in tensors]


def unpack_g(flat: torch.Tensor, g_params):
    """The G gradients in `g_params`' tree: views of the flat buffer."""
    like = pack_g(g_params)
    parts = flat.split(_sizes(like) + [METRIC_LANES])
    t = [p.view(l.shape) for p, l in zip(parts, like)]
    return [{"w": t[0], "b": t[1]}, {"w": t[2], "b": t[3]}]


def unpack_d(flat: torch.Tensor, d_params):
    """The critic gradients in `d_params`' tree (infogan: the head split
    back into d_head and q_head)."""
    like = pack_d(d_params)
    parts = flat.split(_sizes(like) + [METRIC_LANES])
    t = [p.view(l.shape) for p, l in zip(parts, like)]
    if isinstance(d_params, dict):
        return {"trunk": [{"w": t[0], "b": t[1]}],
                "d_head": {"w": t[2][:, :1], "b": t[3][:1]},
                "q_head": {"w": t[2][:, 1:], "b": t[3][1:]}}
    return [{"w": t[0], "b": t[1]}, {"w": t[2], "b": t[3]}]


def metrics_of(flat: torch.Tensor) -> torch.Tensor:
    """A phase buffer's metrics row (its last 8 lanes)."""
    return flat[-METRIC_LANES:]


def d_named(variant: str, m) -> Dict[str, torch.Tensor]:
    """The D phase's lanes by the reference's names
    (``pallas_dp.py:439-454``)."""
    if variant == "wgan":
        return {"d_loss": m[0], "w_estimate": -m[0]}
    if variant == "wgangp":
        return {"d_loss": m[0], "w_estimate": m[1] - m[2], "gp": m[4],
                "grad_norm": m[5]}
    if variant == "dragan":
        return {"d_loss": m[0], "gp": m[4], "grad_norm": m[5]}
    if variant == "fgan":
        return {"d_loss": m[0], "f_bound": -m[0]}
    if variant == "began":
        return {"d_loss": m[0], "began_l_real": m[1], "began_l_fake_d": m[2]}
    if variant == "infogan":
        return {"d_loss": m[0], "mi_loss": m[1]}
    return {"d_loss": m[0], "d_real": m[1], "d_fake": m[2]}


def g_named(variant: str, m) -> Dict[str, torch.Tensor]:
    """The G phase's lanes by the reference's names
    (``pallas_dp.py:456-461``)."""
    if variant == "began":
        return {"g_loss": m[3], "began_l_fake_g": m[3]}
    if variant == "infogan":
        return {"g_loss": m[3], "g_mi_loss": m[6]}
    return {"g_loss": m[3]}


# ---------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------

def d_phase_plain(x, zd, xtra, g, d, lam, hp: ChunkHyper,
                  probe: Optional[dict] = None) -> torch.Tensor:
    """The D phase kernel's function in plain PyTorch, in the inputs'
    dtype (float32, or float64 as the kernel's oracle): the flat buffer
    [dW1d, db1d, dW2d, db2d, metrics row]. `probe`: the tie probe of
    ``cuda_train.gan_chunk_plain``."""
    lam = torch.as_tensor(lam, dtype=x.dtype, device=x.device)
    grads, row, pen, aux6, _ = cuda_train.critic_grads(
        hp, list(g) + list(d), x, zd, xtra, lam, 1.0 / x.shape[0], probe)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    m = torch.stack(row + [zero] + pen + [aux6, lam])
    return torch.cat([t.reshape(-1) for t in grads] + [m])


def g_phase_plain(zg, g, d, hp: ChunkHyper,
                  probe: Optional[dict] = None) -> torch.Tensor:
    """The G phase kernel's function in plain PyTorch: the flat buffer
    [dW1g, db1g, dW2g, db2g, metrics row]. No carried scalar enters it:
    began's k_t law runs after the all-reduce."""
    grads, g_loss, g6 = cuda_train.g_grads(hp, list(g) + list(d), zg,
                                           1.0 / zg.shape[0], probe=probe)
    zero = torch.zeros((), dtype=zg.dtype, device=zg.device)
    m = torch.stack([zero, zero, zero, g_loss, zero, zero,
                     zero if g6 is None else g6, zero])
    return torch.cat([t.reshape(-1) for t in grads] + [m])


# ---------------------------------------------------------------------
# The kernels
# ---------------------------------------------------------------------

def bind(lib) -> None:
    """The C interface of a library built from csrc/gan_chunk.cu with
    -DGM_PHASE=1."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.gm_gan_phase_plan.argtypes = [i, ctypes.POINTER(cuda_train._Hyper),
                                      p, i]
    lib.gm_gan_phase_plan.restype = p
    lib.gm_gan_phase_plan_floats.argtypes = [p]
    lib.gm_gan_phase_plan_floats.restype = ctypes.c_longlong
    lib.gm_gan_phase_run.argtypes = [p] * 15 + [ctypes.c_float, p]
    lib.gm_gan_phase_run.restype = i
    lib.gm_gan_phase_scratch_floats.argtypes = [i] * 6
    lib.gm_gan_phase_scratch_floats.restype = ctypes.c_longlong
    lib.gm_gan_phase_min_grid.argtypes = [i] * 5
    lib.gm_gan_phase_min_grid.restype = i
    lib.gm_gan_phase_blocks_per_sm.argtypes = [i]
    lib.gm_gan_phase_blocks_per_sm.restype = i
    lib.gm_gan_phase_smem_bytes.argtypes = []
    lib.gm_gan_phase_smem_bytes.restype = i
    lib.gm_gan_phase_hook.argtypes = []
    lib.gm_gan_phase_hook.restype = i
    lib.gm_gan_phase_bf16.argtypes = []
    lib.gm_gan_phase_bf16.restype = i


@functools.cache
def _lib(hook: str, bf16: bool = False):
    from generative_models_tpu_torch.ops.build import build_library
    lib = build_library(cuda_train.lib_name("gan_phase", hook, bf16),
                        ["gan_chunk.cu"], headers=["chunk_common.cuh"],
                        flags=cuda_train.lib_flags(hook, bf16, phase=True))
    bind(lib)
    if (lib.gm_gan_phase_hook(), lib.gm_gan_phase_bf16()) != (
            HOOK_IDS[hook], int(bf16)):
        raise RuntimeError(f"gan_phase: the library built for hook {hook!r} "
                           f"(bf16 {bf16}) reports hook "
                           f"{lib.gm_gan_phase_hook()}, bf16 "
                           f"{lib.gm_gan_phase_bf16()}")
    return lib


def build(hook: Optional[str] = None, bf16: bool = False) -> None:
    """Compile (or load) the phase library for `hook` (its bf16 build with
    `bf16`) now instead of at first use; every hook of :data:`DP_HOOKS`
    when None."""
    for h in ([hook] if hook else DP_HOOKS):
        _lib(h, bf16)


def _covers(hp) -> None:
    if hp.variant not in FUSED_DP_VARIANTS:
        raise ValueError(f"the phase kernels cover {FUSED_DP_VARIANTS}, "
                         f"not {hp.variant!r}")


def _check(hp, rows: Dict[str, Tuple[torch.Tensor, tuple]], g, d):
    z, h = g[0].shape
    x = g[2].shape[1]
    xd, hd = d[0].shape
    nl = hp.head_width(x)
    want = [(z, h), (h,), (h, x), (x,), (xd, hd), (hd,), (hd, nl), (nl,)]
    if xd != x + hp.n_cls:
        raise ValueError(f"gan_phase: D's input ({xd}) must be G's output "
                         f"({x}) plus the {hp.n_cls} label lanes")
    for q, t in enumerate(list(g) + list(d)):
        if tuple(t.shape) != want[q]:
            raise ValueError(f"gan_phase: parameter {q} must be {want[q]}, "
                             f"got {tuple(t.shape)}")
    for name, (t, shape) in rows.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"gan_phase: {name} must be {shape}, got "
                             f"{tuple(t.shape)}")


def _check_tensors(tensors, dev) -> None:
    """What every call checks: float32, contiguous, on the parameters'
    device (the shapes are the plan's key)."""
    for t in tensors:
        if t.dtype != torch.float32 or t.device != dev:
            raise TypeError(f"gan_phase takes float32 tensors on one device; "
                            f"got {t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError("gan_phase takes contiguous tensors")


class _Plan:
    """A launch plan of one phase kernel (csrc/gan_chunk.cu
    gm_gan_phase_plan): the C plan, the scratch it cuts (kept for its
    life), the floats of its flat buffer and the library's run entry."""


    def __init__(self, mode: int, hp: ChunkHyper, b: int, g, d):
        z, h = g[0].shape
        x = g[2].shape[1]
        hd = d[0].shape[1]
        dev = g[0].device
        lib = _lib(HOOKS[hp.variant], hp.bf16)
        self.scratch = torch.empty(lib.gm_gan_phase_scratch_floats(
            b, h, x, hd, x + hp.n_cls, hp.head_width(x)),
            dtype=torch.float32, device=dev)
        hyper = cuda_train.hyper_struct(hp, steps=1, ds=1, batch=b, z=z, h=h,
                                        x=x, hd=hd, t_g=0, t_d=0)
        with torch.cuda.device(dev):
            self.handle = lib.gm_gan_phase_plan(
                mode, ctypes.byref(hyper), self.scratch.data_ptr(),
                BLOCKS_PER_SM)
        if not self.handle:
            raise RuntimeError("gan_phase: no launch plan at these sizes "
                               "(the occupancy query failed, the sizes do "
                               "not fit the hook or the grid is below "
                               "gm_gan_phase_min_grid)")
        self.floats = lib.gm_gan_phase_plan_floats(self.handle)
        self.run = lib.gm_gan_phase_run


# (mode, hp, the tensors' shapes, device, stream) -> _Plan: a plan's
# scratch serves one stream, on which its launches run in order
_plans: Dict[tuple, _Plan] = {}


def _launch(mode: int, hp: ChunkHyper, rows, shapes, g, d,
            lam) -> torch.Tensor:
    """One launch: the plan of these sizes (built, and the sizes checked
    against `shapes` (:func:`_check`), at the first call of each), a flat
    buffer from the caching allocator, the call's pointers. `rows` are x,
    zd, zg, xtra (None where the mode takes none); `lam` began's k, a
    0-dim float32 tensor on the device (read through its pointer) or a
    number (passed by value)."""
    params = list(g) + list(d)
    dev = params[0].device
    given = [t for t in rows if t is not None]
    _check_tensors(params + given, dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    key = (mode, hp, dev.index, stream,
           tuple(tuple(t.shape) for t in params + given))
    plan = _plans.get(key)
    if plan is None:
        _check(hp, shapes, g, d)
        plan = _plans[key] = _Plan(mode, hp, given[0].shape[0], g, d)
    flat = torch.empty(plan.floats, dtype=torch.float32, device=dev)
    if isinstance(lam, torch.Tensor) and lam.device == dev:
        if lam.dtype != torch.float32 or lam.numel() != 1:
            raise TypeError("gan_phase: the carried scalar is one float32")
        lam_ptr, lam_v = lam.data_ptr(), 0.0
    else:
        lam_ptr, lam_v = None, float(lam)
    ptr = lambda t: None if t is None else t.data_ptr()
    args = ([plan.handle] + [ptr(t) for t in rows]
            + [t.data_ptr() for t in params]
            + [flat.data_ptr(), lam_ptr, lam_v, stream])
    if dev.index == torch.cuda.current_device():
        rc = plan.run(*args)
    else:
        with torch.cuda.device(dev):
            rc = plan.run(*args)
    if rc != 0:
        raise RuntimeError(f"gan_phase kernel launch failed: CUDA error {rc}")
    return flat


def _device_of(t) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"gan_phase runs on cuda or cpu tensors, not "
                         f"{t.device}")
    return t.device.type


def d_phase(x, zd, xtra, g, d, lam, hp: ChunkHyper) -> torch.Tensor:
    """One critic update's gradients and metrics on the local rows x
    [b, Xd] (cgan: X + n_cls, each row ending in its one-hot label), zd
    [b, Z] (cgan: ending in the label; infogan: code rows) and, for
    wgangp and dragan, xtra [b, 1] (eps) or [b, X] (x_hat); `g` and `d`
    the parameters as :func:`pack_g` and :func:`pack_d` give them; `lam`
    began's k (a float or a 0-dim tensor). Returns the flat buffer (see
    the module docstring). CPU tensors run :func:`d_phase_plain`; CUDA
    tensors launch the kernel on the current stream or raise."""
    global d_launches, d_bf16_launches
    _covers(hp)
    b = x.shape[0]
    lanes = aux_lanes(hp.variant, g[2].shape[1])
    if (xtra is None) != (lanes == 0):
        raise ValueError(f"gan_phase: {hp.variant} takes "
                         + (f"an xtra stream [b, {lanes}]" if lanes
                            else "no xtra stream"))
    rows = {"x": (x, (b, d[0].shape[0])), "zd": (zd, (b, g[0].shape[0]))}
    if lanes:
        rows["xtra"] = (xtra, (b, lanes))
    if _device_of(x) == "cpu":
        _check(hp, rows, g, d)
        _check_tensors(list(g) + list(d) + [t for t, _ in rows.values()],
                       x.device)
        return d_phase_plain(x, zd, xtra, g, d, lam, hp)
    flat = _launch(M_D, hp, (x, zd, None, xtra), rows, g, d, lam)
    d_launches += 1
    d_bf16_launches += int(hp.bf16)
    return flat


def g_phase(zg, g, d, hp: ChunkHyper) -> torch.Tensor:
    """The G update's gradients through the critic `d` and its metrics
    on the local z rows zg [b, Z] (cgan: ending in the labels of the
    step's last critic batch; infogan: code rows). Returns the flat
    buffer; CPU tensors run :func:`g_phase_plain`, CUDA tensors launch
    the kernel or raise."""
    global g_launches, g_bf16_launches
    _covers(hp)
    b = zg.shape[0]
    rows = {"zg": (zg, (b, g[0].shape[0]))}
    if _device_of(zg) == "cpu":
        _check(hp, rows, g, d)
        _check_tensors(list(g) + list(d) + [zg], zg.device)
        return g_phase_plain(zg, g, d, hp)
    flat = _launch(M_G, hp, (None, None, zg, None), rows, g, d, 0.0)
    g_launches += 1
    g_bf16_launches += int(hp.bf16)
    return flat


# ---------------------------------------------------------------------
# The many-steps function the Trainer calls
# ---------------------------------------------------------------------

def phase_grads(spec, cfg, group):
    """The phase kernels' gradient source for ``train/step.py::
    build_adversarial_step`` (the pair ``autograd_grads`` returns there):
    each update is one :func:`d_phase` or :func:`g_phase` launch on the
    rank's rows, then one all-reduce of its flat buffer over `group`.
    dragan's x_hat = x + scale * std(x) * u is formed here from the
    rank's rows (std over its shard, as the reference's per-device draw);
    cgan's labels become one-hot lanes on the x and zd rows, and the
    last critic batch's on the zg rows; began's k is read from vstate."""
    variant = cfg.variant
    hp = ChunkHyper.from_config(cfg)
    lanes = aux_lanes(variant, cfg.image_dim)

    def with_labels(rows, y):
        if not hp.n_cls:
            return rows
        return torch.cat([rows, onehot(y, hp.n_cls)], 1).contiguous()

    def d_grads(d_params, g_params, batch, z, aux, vstate):
        x, y = batch["image"], batch["label"]
        xt = None
        if lanes:
            xt = aux
            if variant == "dragan":  # x_hat on the rank's rows
                xt = x + cfg.dragan_noise_scale * x.std(correction=0) * xt
            xt = xt.contiguous()
        lam = vstate["k"] if variant == "began" else 0.0
        buf = d_phase(with_labels(x, y), with_labels(z, y), xt,
                      pack_g(g_params), pack_d(d_params), lam, hp)
        group.all_reduce_mean_(buf)
        return unpack_d(buf, d_params), d_named(variant, metrics_of(buf))

    def g_grads(g_params, d_params, batch, z, vstate):
        buf = g_phase(with_labels(z, batch["label"]), pack_g(g_params),
                      pack_d(d_params), hp)
        group.all_reduce_mean_(buf)
        return unpack_g(buf, g_params), g_named(variant, metrics_of(buf))

    return d_grads, g_grads


def build_fused_dp_many_steps(spec, cfg, steps_per_epoch: int, group):
    """``parallel/dp.py::build_shard_map_many_steps`` — its contract, its
    gather, its noise — driving the general step with the phase kernels'
    gradients (:func:`phase_grads`): the optimizer, the variant's hooks
    and the EMA are the general step's, so the two paths train alike up
    to the kernels' rounding."""
    from generative_models_tpu_torch.parallel.dp import (
        build_shard_map_many_steps,
    )
    ok, reason = fused_dp_supported(spec, cfg)
    if not ok:
        raise ValueError(f"fused_step with DP unsupported: {reason}")
    train_step = build_adversarial_step(spec, cfg, group,
                                        grads=phase_grads(spec, cfg, group))
    return build_shard_map_many_steps(spec, cfg, steps_per_epoch, group,
                                      train_step)
