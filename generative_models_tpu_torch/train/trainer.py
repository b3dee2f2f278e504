"""The Trainer — the port of ``generative_models_tpu/train/trainer.py``
for every variant (nsgan, mmgan, lsgan, wgan, fgan, ragan,
fishergan, wgangp, dragan, cgan, began, infogan, vae, birvae, ddpm,
flow, vqvae, vqprior): build the model
from ``cfg.seed`` (G and D, or a single model's parameter tree; the MLP
stacks, or with ``arch="conv"`` the conv stacks), train, evaluate,
sample, save and load checkpoints in the JAX package's layout.

The Trainer runs on the device it is given, ``"cuda"`` by default, and
raises when that device is missing; the CPU runs only when asked for
(``device="cpu"``), and then every kernel's plain version runs.

Training mirrors the reference: the train split is resident on the
device, each epoch's row permutation is a function of ``cfg.seed`` and
the epoch (so a resumed run replays the same order), and
``Config.scan_steps`` steps run per chunk. ``Config.fused_step`` picks
how a chunk runs (``ops/cuda_train.py::resolve_fused_step``): a
whole-chunk kernel (``"auto"`` on CUDA: the measured policy's verdict,
``ops/fused_policy.py``) or the general step (``train/step.py``), whose
MLPs run through the forward and backward kernels on the card. Both see
the same batches and the same noise: a step's noise is a function of
the state's two ``rng`` words and its global step alone (drawn on a
fixed grid of blocks, ``train/step.py::grid_noise``), so a run split
into two ``train`` calls, or resumed from a checkpoint at any step,
trains on the numbers of the uninterrupted run. One exception: a single model's general step on the
card hands each step a generator seeded from the ``rng`` words and the
step, from which the loss draws its own noise — for the VAE inside the
sampling kernel (``ops/cuda_reparam.py``).

Given a data group (``parallel/mesh.py::DataGroup``; the reference's
mesh), the Trainer is one rank of a data-parallel run, on the group's
device, with ``cfg.batch_size`` the global batch (it must divide by the
world): ``fused_step=True`` takes the phase kernels
(``ops/cuda_dp.py``), ``"auto"`` and False the general DP step
(``parallel/dp.py``), as the reference's "auto" keeps the XLA step
whenever a mesh is present. Each rank draws its rows of the global
batch's noise (``grid_noise``'s ``shard``). Rank 0 alone writes
``metrics.jsonl``, images, the loss plot and checkpoints; every rank can
load.

Given a ``dp x tp`` grid (``parallel/mesh.py::Grid`` on the "model"
axis; the reference's 2-D mesh) with ``cfg.tp`` = tp > 1, the Trainer is
one rank of a tensor-parallel run: its state holds its shard of each
sharded leaf (``parallel/tp.py``), the step is the general DP step over
the grid's data group, and the noise comes from the data rank, so the
model ranks of a data slice draw the same numbers. A grid whose model
axis does not match ``cfg.tp``, in either direction, is refused, and so
are the chunk and phase kernels (``fused_step=True``). ``sample``,
``generator_params``, ``save_model``, ``load_model`` and ``evaluate``
work from the shards, collectively: every rank of the grid calls them
together (the first four gather the whole parameters over the model
group; ``evaluate`` runs the sharded layers' collectives).
"""

from __future__ import annotations

import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from generative_models_tpu_torch.config import (
    Config,
    resolve_dtype,
    variant_config,
)
from generative_models_tpu_torch.data.mnist import (
    INV_255,
    load_dataset,
    to_flat_float,
)
from generative_models_tpu_torch.data.pipeline import make_perm
from generative_models_tpu_torch.losses.registry import get_variant
from generative_models_tpu_torch.ops import cuda_dp, cuda_train
from generative_models_tpu_torch.ops.penalty import aux_draw, aux_lanes
from generative_models_tpu_torch.ops.spectral import init_sn_vectors
from generative_models_tpu_torch.parallel import dp, tp
from generative_models_tpu_torch.parallel.mesh import Grid
from generative_models_tpu_torch.train import step as step_lib
from generative_models_tpu_torch.train.optim import init_opt
from generative_models_tpu_torch.utils import checkpoint as ckpt
from generative_models_tpu_torch.utils import spans
from generative_models_tpu_torch.utils.metrics import MetricsLogger
from generative_models_tpu_torch.utils.tree import tree_leaves_with_path
from generative_models_tpu_torch.utils.viz import plot_losses, save_image_grid


def resolve_device(device) -> torch.device:
    """`device` as a torch.device; raises if it names CUDA and none is
    present (no silent move to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but no CUDA device is present; "
            "pass device='cpu' to run the plain versions on the CPU")
    return dev


class Trainer:
    """One trainer, every ported variant.

    >>> t = Trainer("nsgan")                 # on the card
    >>> t.train(steps=2000)
    >>> t.generate_images("samples")
    >>> t.save_model("runs/n.npz")           # the JAX package's layout
    """

    def __init__(self, variant: str = "nsgan",
                 config: Optional[Config] = None, device="cuda",
                 data: Optional[Dict[str, np.ndarray]] = None,
                 group=None, debug_nans: bool = False,
                 log_every_rank: bool = False, **overrides):
        cfg = config if config is not None else variant_config(
            variant, **overrides)
        self.grid = group if isinstance(group, Grid) else None
        self.group = group = group.data if self.grid else group
        # every chunk's metrics and the state checked for finite values
        # (the CLI's --debug-nans, which also turns on anomaly mode)
        self.debug_nans = debug_nans
        # every rank writes metrics.jsonl, images and the loss plot (the
        # CLI's --multihost: each process its own); rank 0 alone saves
        self.log_every_rank = log_every_rank
        self.device = resolve_device(device if group is None
                                     else group.device)
        # "auto": bf16 operands for the conv stacks at or past the card's
        # measured batch crossover, float32 otherwise and on the CPU
        self.cfg = cfg = cfg.replace(
            dtype=resolve_dtype(cfg, self.device.type))
        self.spec = get_variant(cfg.variant)
        self.tp = self._model_group(cfg)
        if group is None and cfg.dp > 1:
            raise ValueError(f"dp={cfg.dp} needs a data group of {cfg.dp} "
                             "ranks (parallel/mesh.py::run_ranks; the CLI's "
                             "--dp starts them)")
        if group is not None:
            if cfg.dp > 1 and cfg.dp != group.world:
                raise ValueError(f"dp={cfg.dp} but the data group has "
                                 f"{group.world} ranks")
            dp.check_divisible(cfg, group.world)
            if cfg.fused_step is True:
                ok, reason = cuda_dp.fused_dp_supported(self.spec, cfg)
                if not ok:
                    raise ValueError(
                        f"fused_step with DP unsupported: {reason}")
        elif cfg.fused_step is True:
            ok, reason = cuda_train.fused_step_supported(self.spec, cfg)
            if not ok:
                raise ValueError(f"fused_step unsupported here: {reason}")
        if self.tp is not None:
            reason = tp.unsupported(self.spec, cfg)
            if reason:
                raise ValueError(reason)
        # the split is loaded at the first call that needs it, so serving
        # (load_model + sample) reads no dataset
        self._raw = data
        self.x_train = None
        # init draws on the CPU so the weights do not depend on the device
        self.state = step_lib.init_state(
            self.spec, cfg, torch.Generator().manual_seed(cfg.seed),
            self.device)
        self._shard()
        self._sample_gen = torch.Generator(device=self.device).manual_seed(
            cfg.seed + 1)

    def _model_group(self, cfg):
        """The grid's model group under tp > 1 (None without one); raises
        when the grid's model axis and ``cfg.tp`` differ, either way."""
        grid = self.grid
        axis = grid.n if grid is not None and grid.axis == tp.MODEL_AXIS else 1
        if grid is not None and grid.axis != tp.MODEL_AXIS and grid.n > 1:
            raise ValueError(
                f"the Trainer takes a data group or a 'model' grid, not a "
                f"{grid.axis!r} one (pipeline parallelism trains the prior "
                "through parallel/pp.py::build_pp_prior_step)")
        if (cfg.tp > 1 or axis > 1) and axis != cfg.tp:
            raise ValueError(
                f"Config.tp={cfg.tp} but the rank grid's '{tp.MODEL_AXIS}' "
                f"axis size {axis}; build it with parallel/mesh.py::make_grid"
                f"(dp, tp, '{tp.MODEL_AXIS}') and a matching cfg")
        return grid.second if axis > 1 else None

    def _shard(self) -> None:
        """Under tp, keep this rank's shard of the (whole, equal on every
        rank) state, and the roles to gather it back."""
        if self.tp is not None:
            self.state, self._roles = tp.shard_state(self.spec, self.cfg,
                                                     self.state, self.tp)

    def whole_state(self):
        """The whole train state: the state itself, or under tp gathered
        over the model group (a collective: every rank calls it)."""
        if self.tp is None:
            return self.state
        return {k: tp.gather_tree(v, self._roles[k], self.tp)
                for k, v in self.state.items()}

    def unshard(self) -> None:
        """Under tp, gather the whole state on every rank (a collective)
        and go on as a data-parallel rank holding it: sampling, scoring
        and export then run on one rank alone. A no-op otherwise."""
        if self.tp is None:
            return
        self.state = self.whole_state()
        self.tp = None
        if self.x_train is not None:
            self._build_fns()

    def _barrier(self) -> None:
        if self.grid is not None:
            self.grid.barrier()
        elif self.group is not None:
            self.group.barrier()

    # --------------------------------------------------------------
    def _load_data(self) -> None:
        if self.x_train is not None:
            return
        cfg = self.cfg
        raw = self._raw if self._raw is not None else load_dataset(cfg)
        arrs = to_flat_float(raw)
        self.x_test, self.y_test = arrs["x_test"], arrs["y_test"]
        x_tr, y_tr = arrs["x_train"], arrs["y_train"]
        # val rows are carved off the END of train before any shuffling
        keep = slice(None)
        if "x_val" in arrs:
            self.x_val, self.y_val = arrs["x_val"], arrs["y_val"]
        elif cfg.val_size > 0:
            v = cfg.val_size
            if v >= x_tr.shape[0]:
                raise ValueError(f"val_size={v} >= train rows {x_tr.shape[0]}")
            self.x_val, self.y_val = x_tr[-v:], y_tr[-v:]
            keep = slice(None, -v)
        else:
            self.x_val = self.y_val = None
        if cfg.data_storage == "uint8":
            # raw bytes resident; the step decodes after the gather
            rx = np.asarray(raw["x_train"])
            if rx.dtype != np.uint8:
                raise ValueError(
                    "data_storage='uint8' requires uint8 source images; "
                    f"got {rx.dtype}")
            x_dev = rx.reshape(rx.shape[0], -1)[keep]
        else:
            x_dev = x_tr[keep]
        self.x_train = torch.from_numpy(np.ascontiguousarray(x_dev)).to(
            self.device)
        self.y_train = torch.from_numpy(np.ascontiguousarray(
            y_tr[keep])).to(self.device)
        if cfg.flow_reflow and self.x_train.shape[1] != 2 * cfg.image_dim:
            # fail here, not mis-slice in the loss: reflow rows are
            # teacher couplings [x1_hat | x0] (train/reflow.py)
            raise ValueError(
                "flow_reflow needs pair rows of width 2*image_dim="
                f"{2 * cfg.image_dim}, got {self.x_train.shape[1]} (build "
                "the dataset with train/reflow.py or --reflow-from)")
        self._build_fns()

    def _build_fns(self) -> None:
        cfg = self.cfg
        self.rows_per_step = (step_lib.batches_per_step(self.spec, cfg)
                              * cfg.batch_size)
        self.steps_per_epoch = self.x_train.shape[0] // self.rows_per_step
        if self.steps_per_epoch < 1:
            raise ValueError("dataset smaller than one training step")
        self.rows_per_epoch = self.steps_per_epoch * self.rows_per_step
        if self.tp is not None:
            self._fused = False
            self._many_steps = tp.build_tp_many_steps(
                self.spec, cfg, self.steps_per_epoch, self.grid)
            return
        if self.group is not None:
            self._fused = cfg.fused_step is True
            self._many_steps = (
                cuda_dp.build_fused_dp_many_steps if self._fused
                else dp.build_shard_map_many_steps)(
                    self.spec, cfg, self.steps_per_epoch, self.group)
            return
        self._fused = cuda_train.resolve_fused_step(self.spec, cfg,
                                                    self.device)
        if self._fused:
            self._many_steps = cuda_train.build_fused_many_steps(
                self.spec, cfg, self.steps_per_epoch)
        else:
            self._many_steps = step_lib.build_many_steps(
                self.spec, cfg, self.steps_per_epoch)

    def _rebuild_optimizers(self) -> None:
        """Fresh optimizer states at the current cfg's learning rates,
        keeping params, step and rng — the reference's ``.train(lr)``."""
        st = dict(self.state)
        if self.spec.adversarial:
            st["g_opt"] = init_opt(self.cfg, st["g_params"])
            st["d_opt"] = init_opt(self.cfg, st["d_params"])
        else:
            st["opt"] = init_opt(self.cfg, st["params"])
        self.state = st
        self._build_fns()

    def _perm_window(self, e0: int, win: int) -> torch.Tensor:
        """Epochs e0..e0+win-1's row permutations [win, N]; epoch e's is
        drawn from a generator seeded by (cfg.seed, e) alone."""
        n = self.x_train.shape[0]
        return torch.stack([make_perm(torch.Generator(
            device=self.device).manual_seed(
                (self.cfg.seed % 2 ** 31) * 2 ** 32 + e), n)
            for e in range(e0, e0 + win)])

    def _noise(self, first_step: int, n: int):
        """Noise of `n` steps from global step `first_step`
        (``train/step.py::chunk_noise``), from the state's ``rng`` words;
        a data rank's rows of the global batch's."""
        g = self.group
        return step_lib.chunk_noise(
            self.spec, self.cfg, self.state["rng"], first_step, n,
            self.device, self._fused,
            (0, 1) if g is None else (g.rank, g.world))

    # --------------------------------------------------------------
    def train(self, num_epochs: Optional[int] = None,
              G_lr: Optional[float] = None, D_lr: Optional[float] = None,
              D_steps: Optional[int] = None,
              steps: Optional[int] = None,
              log_path: Optional[str] = None,
              echo_every: int = 0,
              sample_every: Optional[int] = None,
              ckpt_path: Optional[str] = None) -> Dict[str, list]:
        """Train. Reference-compatible: ``.train(num_epochs, G_lr, D_lr,
        D_steps)``; or pass ``steps=`` for a step budget. Returns the loss
        history dict."""
        self._load_data()
        cfg = self.cfg
        rebuild = {}
        if G_lr is not None:
            rebuild["g_lr"] = G_lr
        if D_lr is not None:
            rebuild["d_lr"] = D_lr
        if D_steps is not None:
            rebuild["d_steps"] = D_steps
        if rebuild:
            self.cfg = cfg = cfg.replace(**rebuild)
            self._rebuild_optimizers()

        if steps is None:
            epochs = num_epochs if num_epochs is not None else (
                cfg.epochs if cfg.epochs else None)
            total = (epochs * self.steps_per_epoch if epochs else cfg.steps)
        else:
            total = steps

        logger = MetricsLogger(log_path if self.logs else None,
                               echo_every=echo_every if self.logs else 0)
        sample_every = (cfg.sample_every if sample_every is None
                        else sample_every)
        # data order continues from the restored global step on resume
        base_step = int(self.state["step"])
        done = 0
        last_sampled = 0
        last_ckpt = 0
        t0 = time.perf_counter()
        win = (cfg.scan_steps * self.rows_per_step - 1
               ) // self.rows_per_epoch + 2
        # metric fetches are deferred so the host does not wait on the
        # device each chunk; fetched now only when the host needs them
        pending: list = []

        def log_pending():
            with spans.span("trainer.fetch"):
                spans.wait("fetch.wait", self.device)
                got = [(start, {k: v.cpu().numpy() for k, v in st.items()})
                       for start, st in pending]
            pending.clear()
            with spans.span("trainer.log"):
                for start, m in got:
                    logger.log_chunk(start, m)

        while done < total:
            chunk = min(cfg.scan_steps, total - done)
            first = base_step + done
            with spans.span("trainer.chunk", first, chunk), spans.syncs(
                    "chunk.syncs", self.device):
                with spans.span("trainer.perm"):
                    start_row = first * self.rows_per_step
                    e0 = start_row // self.rows_per_epoch
                    perm_stack = self._perm_window(e0, win)
                    rel = (start_row - e0 * self.rows_per_epoch
                           ) + torch.arange(chunk, device=self.device
                                            ) * self.rows_per_step
                try:
                    with spans.span("trainer.launch"):
                        self.state, stacked = self._many_steps(
                            self.state, self.x_train, self.y_train,
                            perm_stack, rel,
                            lambda k0, n, first=first: self._noise(
                                first + k0, n))
                except RuntimeError as e:
                    if not (self.debug_nans and "nan" in str(e).lower()):
                        raise
                    raise FloatingPointError(
                        f"--debug-nans: a non-finite value in the backward "
                        f"of a step of steps {first}-{first + chunk - 1}: "
                        f"{e}") from e
                if self.debug_nans:
                    with spans.span("trainer.nans"):
                        spans.wait("nans.wait", self.device)
                        self._check_finite(first, chunk, stacked)
                prev_epochs = first // self.steps_per_epoch
                done += chunk
                cur_epochs = (base_step + done) // self.steps_per_epoch
                epoch_work = cur_epochs > prev_epochs and (
                    self.x_val is not None or sample_every == 0)
                pending.append((done - chunk, stacked))
                if echo_every or epoch_work or (
                        sample_every > 0
                        and done - last_sampled >= sample_every):
                    log_pending()
                if cur_epochs > prev_epochs and self.x_val is not None:
                    with spans.span("trainer.eval"):
                        vm = self.evaluate("val")
                        logger.log_event({"epoch": cur_epochs, **{
                            f"val_{k}": v for k, v in vm.items()}})
                if sample_every == 0 and cur_epochs > prev_epochs:
                    with spans.span("trainer.images"):
                        self.generate_images(tag=f"epoch{cur_epochs:03d}")
                elif sample_every > 0 and done - last_sampled >= sample_every:
                    with spans.span("trainer.images"):
                        self.generate_images(tag=f"step{done:06d}")
                    last_sampled = done
                if (ckpt_path and cfg.ckpt_every > 0
                        and done - last_ckpt >= cfg.ckpt_every):
                    with spans.span("trainer.ckpt"):
                        spans.wait("ckpt.wait", self.device)
                        self.save_model(ckpt_path)
                    last_ckpt = done
        # train time runs to the last step's completion on the device
        if self.device.type == "cuda":
            with spans.span("trainer.sync.wait"):
                torch.cuda.synchronize(self.device)
        self.wall_time = time.perf_counter() - t0
        if pending:
            log_pending()
        self.steps_done = total
        logger.close()
        self.history = logger.history
        return logger.history

    def _check_finite(self, first: int, chunk: int, stacked) -> None:
        """Raise FloatingPointError naming the first step of the chunk
        (global steps first..first+chunk-1) whose metrics are not
        finite, or the chunk's last step if only the state is not."""
        bad = {k: int(torch.nonzero(~torch.isfinite(v.reshape(chunk, -1))
                                    .all(dim=1))[0])
               for k, v in stacked.items()
               if not bool(torch.isfinite(v).all())}
        if bad:
            k = min(bad, key=bad.get)
            raise FloatingPointError(
                f"--debug-nans: metric {k!r} is not finite at step "
                f"{first + bad[k]}")
        for path, t in tree_leaves_with_path(self.state):
            if (isinstance(t, torch.Tensor) and t.is_floating_point()
                    and not bool(torch.isfinite(t).all())):
                raise FloatingPointError(
                    f"--debug-nans: state {path} is not finite after step "
                    f"{first + chunk - 1}")

    # --------------------------------------------------------------
    @torch.no_grad()
    def evaluate(self, split: str = "test",
                 max_batches: Optional[int] = None) -> Dict[str, float]:
        """Loss metrics on a held-out split, no parameter updates: the
        batch-averaged metrics of the D and G losses, each batch's d and g
        losses sharing one noise draw (as the reference's one key), or of
        a single model's loss."""
        self._load_data()
        cfg = self.cfg
        if split == "test":
            xs, ys = self.x_test, self.y_test
        elif split == "val":
            if self.x_val is None:
                raise ValueError(
                    "no validation split: set Config.val_size > 0 or pass "
                    "explicit x_val/y_val data")
            xs, ys = self.x_val, self.y_val
        elif split == "train":
            xs, ys = self.x_train.cpu().numpy(), self.y_train.cpu().numpy()
        else:
            raise ValueError(f"unknown split {split!r}")
        nb = xs.shape[0] // cfg.batch_size
        if max_batches:
            nb = min(nb, max_batches)
        if nb < 1:
            raise ValueError("split smaller than one batch")
        rows = nb * cfg.batch_size
        x = torch.from_numpy(self._decode_host(np.asarray(xs[:rows]))).to(
            self.device)
        y = torch.from_numpy(np.asarray(ys[:rows])).to(self.device)
        st = self.state
        sums: Dict[str, float] = {}
        for i in range(nb):
            sl = slice(i * cfg.batch_size, (i + 1) * cfg.batch_size)
            batch = {"image": x[sl], "label": y[sl]}
            if self.spec.adversarial:
                z = step_lib.draw_z(self._sample_gen, (cfg.batch_size,),
                                    cfg, self.device)
                extra = {}
                if aux_lanes(cfg.variant, cfg.image_dim):
                    extra["aux"] = aux_draw(self._sample_gen, cfg.batch_size,
                                            cfg, self.device)
                _, d_m = self.spec.d_loss(st["d_params"], st["g_params"],
                                          batch, None, st["vstate"], cfg, z=z,
                                          **extra)
                _, g_m = self.spec.g_loss(st["g_params"], st["d_params"],
                                          batch, None, st["vstate"], cfg, z=z)
                m = {**d_m, **g_m}
            else:
                _, m = self.spec.loss(st["params"], batch, self._sample_gen,
                                      cfg)
            spans.wait("eval.wait", self.device)
            for k, v in m.items():
                sums[k] = sums.get(k, 0.0) + float(v)
        return {k: v / nb for k, v in sums.items()}

    @staticmethod
    def _decode_host(xs: np.ndarray) -> np.ndarray:
        """Host-side twin of ``train/step.py::decode_images`` (the same
        INV_255 multiply) for uint8 arrays; float arrays pass through."""
        if xs.dtype == np.uint8:
            return xs.astype(np.float32) * INV_255
        return xs

    def train_split_f32(self):
        """The resident train split as host float32 arrays (decoded if
        uint8-resident)."""
        self._load_data()
        return (self._decode_host(self.x_train.cpu().numpy()),
                self.y_train.cpu().numpy())

    # --------------------------------------------------------------
    @property
    def generator_params(self):
        """The sampling-side params — G for an adversarial variant, the
        whole model for the VAE family — or their EMA when
        ``cfg.ema_decay > 0`` (reference ``trainer.py:524-534``)."""
        if self.cfg.ema_decay > 0:
            return self._whole("g_ema" if self.spec.adversarial else "ema")
        return self.raw_generator_params

    @property
    def raw_generator_params(self):
        """The live (non-EMA) sampling-side params."""
        return self._whole("g_params" if self.spec.adversarial else "params")

    def _whole(self, key):
        """The state's subtree `key`, whole (under tp gathered over the
        model group: a collective)."""
        if self.tp is None:
            return self.state[key]
        return tp.gather_tree(self.state[key], self._roles[key], self.tp)

    @torch.no_grad()
    def sample(self, n: Optional[int] = None, z=None,
               chain=None) -> np.ndarray:
        """n samples [n, image_dim] in [0, 1] from the generator prior, or
        from the given noise `z` [n, z_dim] (numpy or tensor; [n,
        latent_dim] for the VAE family; DDPM's and flow's initial x [n,
        image_dim]; vqvae's integer tokens [n, L]). DDPM also takes
        `chain`, step i -> that reverse step's noise [n, image_dim], and
        vqprior step i's Gumbel draws [n, K] (n then from `n`); either is
        drawn from the Trainer's sampling generator when not given."""
        with spans.span("trainer.sample"):
            if z is not None:
                z = torch.as_tensor(z, device=self.device)
                z = (z.to(torch.float32) if z.is_floating_point()
                     else z.long()).contiguous()
                n = z.shape[0]
            n = n or self.cfg.sample_n
            extra = {"chain": chain} if getattr(self.spec, "chain_noise",
                                                False) else {}
            out = self.spec.sample(self.generator_params, self._sample_gen,
                                   n, self.cfg, z=z, **extra)
            spans.wait("sample.wait", self.device)
            with spans.span("sample.copy"):
                host = out.cpu().numpy()
        return host

    @property
    def writes(self) -> bool:
        """Whether this Trainer writes checkpoints: rank 0 of a data group
        or grid, or a Trainer without one."""
        if self.grid is not None:
            return self.grid.rank == 0
        return self.group is None or self.group.rank == 0

    @property
    def logs(self) -> bool:
        """Whether this Trainer writes metrics.jsonl, images and the loss
        plot: the rank that writes, or every rank with log_every_rank."""
        return self.writes or self.log_every_rank

    def generate_images(self, tag: str = "samples", n: Optional[int] = None,
                        out_dir: Optional[str] = None) -> str:
        """Reference's `generate_images`: a PNG sample grid (written by
        rank 0 only; every rank returns its path)."""
        imgs = self.sample(n)
        out_dir = out_dir or os.path.join(self.cfg.out_dir, self.cfg.variant)
        path = os.path.join(out_dir, f"{tag}.png")
        if not self.logs:
            return path
        with spans.span("images.png"):
            return save_image_grid(path, imgs)

    def viz_loss(self, path: Optional[str] = None) -> str:
        """Reference's loss-curve plot (a CSV without matplotlib; rank 0
        only)."""
        path = path or os.path.join(self.cfg.out_dir, self.cfg.variant,
                                    "loss.png")
        if not self.logs:
            return path
        return plot_losses(path, getattr(self, "history", {}))

    # --------------------------------------------------------------
    def save_model(self, path: str) -> str:
        """Checkpoint the full train state (params, optimizer states, the
        variant's carried scalars, step, rng) with ``cfg.ckpt_backend``'s
        backend: the JAX package's npz layout, or a directory
        (``utils/dcp_ckpt.py``). Under a grid the writing rank saves the
        whole state."""
        out = ckpt.save(path, self.whole_state(), self.cfg.ckpt_backend,
                        write=self.writes)
        self._barrier()  # the checkpoint is whole before any rank reads it
        return out

    def load_model(self, path: str) -> None:
        """Load a checkpoint of ``cfg.ckpt_backend``'s backend: an npz
        written by either package's ``save_model``, or a directory written
        by this one's; raises on any shape/dtype/config mismatch. The
        optimizer slots, counts, carried scalars (fishergan's ``lam``, began's
        ``k`` and ``m``), the spectral projection's carried vectors
        (``sn_v``) and rng words are restored when the file has them (a
        directory has them all), so training resumes where it
        stopped."""
        st = dict(self.whole_state())
        loaded = ckpt.restore(path, st, self.cfg)
        for key, v in loaded.items():
            if key == "rng":
                st["rng"] = np.asarray(v, dtype=np.uint32)
            elif key == "step":
                st["step"] = int(v)
            else:
                st[key] = ckpt.params_from_numpy(v, self.device)
        if "sn_v" in st and "sn_v" not in loaded:
            # a file without the carried vectors: burned in afresh at the
            # loaded critic, as init_sn_vectors does at the init weights
            st["sn_v"] = init_sn_vectors(st["d_params"], self.cfg.sn_iters)
        self.state = st
        self._shard()  # under tp each rank takes its slice
