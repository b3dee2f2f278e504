"""The Trainer — the port of ``generative_models_tpu/train/trainer.py``
for the ported variants (nsgan, mmgan, lsgan, wgan, fgan, ragan,
fishergan, vae, birvae): build the model
from ``cfg.seed`` (G and D, or a single model's parameter tree), train,
evaluate, sample, save and load checkpoints in the JAX package's layout.

The Trainer runs on the device it is given, ``"cuda"`` by default, and
raises when that device is missing; the CPU runs only when asked for
(``device="cpu"``), and then every kernel's plain version runs.

Training mirrors the reference: the train split is resident on the
device, each epoch's row permutation is a function of ``cfg.seed`` and
the epoch (so a resumed run replays the same order), and
``Config.scan_steps`` steps run per chunk. ``Config.fused_step`` picks
how a chunk runs (``ops/cuda_train.py::resolve_fused_step``): a
whole-chunk kernel (``"auto"`` on CUDA for every ported variant) or
the general step (``train/step.py``), whose MLPs run through the forward
and backward kernels on the card. Both see the same batches and the
same noise: each sub-chunk's noise comes from a generator seeded
by the state's two ``rng`` words and the global step it starts at. One
exception: a single model's general step on the card hands that
generator to the loss, which draws its own noise from it — for the VAE
inside the sampling kernel (``ops/cuda_reparam.py``).
"""

from __future__ import annotations

import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from generative_models_tpu_torch.config import Config, variant_config
from generative_models_tpu_torch.data.mnist import (
    INV_255,
    load_dataset,
    to_flat_float,
)
from generative_models_tpu_torch.data.pipeline import make_perm
from generative_models_tpu_torch.losses.registry import get_variant
from generative_models_tpu_torch.ops import cuda_train
from generative_models_tpu_torch.train import step as step_lib
from generative_models_tpu_torch.train.optim import init_opt
from generative_models_tpu_torch.utils.checkpoint import (
    load_jax_checkpoint,
    params_from_numpy,
    save_state,
)
from generative_models_tpu_torch.utils.metrics import MetricsLogger
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
                 **overrides):
        cfg = config if config is not None else variant_config(
            variant, **overrides)
        if cfg.dtype == "auto":
            # no bf16 crossover has been measured on the card: float32
            cfg = cfg.replace(dtype="float32")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.spec = get_variant(cfg.variant)
        if cfg.fused_step is True:
            ok, reason = cuda_train.fused_step_supported(self.spec, cfg)
            if not ok:
                raise ValueError(f"fused_step unsupported here: {reason}")
        # the split is loaded at the first call that needs it, so serving
        # (load_model + sample) reads no dataset
        self._raw = data
        self.x_train = None
        # init draws on the CPU so the weights do not depend on the device
        self.state = step_lib.init_state(
            self.spec, cfg, torch.Generator().manual_seed(cfg.seed),
            self.device)
        self._sample_gen = torch.Generator(device=self.device).manual_seed(
            cfg.seed + 1)

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
        self._build_fns()

    def _build_fns(self) -> None:
        cfg = self.cfg
        self.rows_per_step = (step_lib.batches_per_step(self.spec, cfg)
                              * cfg.batch_size)
        self.steps_per_epoch = self.x_train.shape[0] // self.rows_per_step
        if self.steps_per_epoch < 1:
            raise ValueError("dataset smaller than one training step")
        self.rows_per_epoch = self.steps_per_epoch * self.rows_per_step
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
        """Noise of `n` steps from global step `first_step`: z_d [n,
        d_steps, B, z] then z_g [n, B, z]; for a single model eps [n, B,
        latent] — or, for its general step on the card, the generator
        itself, from which each step's loss draws (the VAE's in its
        sampling kernel)."""
        cfg = self.cfg
        gen = step_lib.noise_generator(self.state["rng"], first_step,
                                       self.device)
        if not self.spec.adversarial:
            if self.device.type == "cuda" and not self._fused:
                return gen
            return torch.randn((n, cfg.batch_size, cfg.latent_dim),
                               generator=gen, device=self.device)
        ds, b, z = max(cfg.d_steps, 1), cfg.batch_size, cfg.z_dim
        z_d = torch.randn((n, ds, b, z), generator=gen, device=self.device)
        z_g = torch.randn((n, b, z), generator=gen, device=self.device)
        return z_d, z_g

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

        logger = MetricsLogger(log_path, echo_every=echo_every)
        sample_every = (cfg.sample_every if sample_every is None
                        else sample_every)
        # data order continues from the restored global step on resume
        base_step = int(self.state["step"])
        done = 0
        last_sampled = 0
        last_ckpt = 0
        t0 = time.time()
        win = (cfg.scan_steps * self.rows_per_step - 1
               ) // self.rows_per_epoch + 2
        # metric fetches are deferred so the host does not wait on the
        # device each chunk; fetched now only when the host needs them
        pending: list = []

        def fetch(stacked):
            return {k: v.cpu().numpy() for k, v in stacked.items()}

        while done < total:
            chunk = min(cfg.scan_steps, total - done)
            first = base_step + done
            start_row = first * self.rows_per_step
            e0 = start_row // self.rows_per_epoch
            perm_stack = self._perm_window(e0, win)
            rel = (start_row - e0 * self.rows_per_epoch) + torch.arange(
                chunk, device=self.device) * self.rows_per_step
            self.state, stacked = self._many_steps(
                self.state, self.x_train, self.y_train, perm_stack, rel,
                lambda k0, n, first=first: self._noise(first + k0, n))
            prev_epochs = first // self.steps_per_epoch
            done += chunk
            cur_epochs = (base_step + done) // self.steps_per_epoch
            epoch_work = cur_epochs > prev_epochs and (
                self.x_val is not None or sample_every == 0)
            if echo_every or epoch_work or (
                    sample_every > 0 and done - last_sampled >= sample_every):
                for start, st in pending:
                    logger.log_chunk(start, fetch(st))
                pending.clear()
                logger.log_chunk(done - chunk, fetch(stacked))
            else:
                pending.append((done - chunk, stacked))
            if cur_epochs > prev_epochs and self.x_val is not None:
                vm = self.evaluate("val")
                logger.log_event({"epoch": cur_epochs,
                                  **{f"val_{k}": v for k, v in vm.items()}})
            if sample_every == 0 and cur_epochs > prev_epochs:
                self.generate_images(tag=f"epoch{cur_epochs:03d}")
            elif sample_every > 0 and done - last_sampled >= sample_every:
                self.generate_images(tag=f"step{done:06d}")
                last_sampled = done
            if (ckpt_path and cfg.ckpt_every > 0
                    and done - last_ckpt >= cfg.ckpt_every):
                self.save_model(ckpt_path)
                last_ckpt = done
        # train time runs to the last step's completion on the device
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.wall_time = time.time() - t0
        for start, st in pending:
            logger.log_chunk(start, fetch(st))
        self.steps_done = total
        logger.close()
        self.history = logger.history
        return logger.history

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
                z = torch.randn((cfg.batch_size, cfg.z_dim),
                                generator=self._sample_gen,
                                device=self.device)
                _, d_m = self.spec.d_loss(st["d_params"], st["g_params"],
                                          batch, None, st["vstate"], cfg, z=z)
                _, g_m = self.spec.g_loss(st["g_params"], st["d_params"],
                                          batch, None, st["vstate"], cfg, z=z)
                m = {**d_m, **g_m}
            else:
                _, m = self.spec.loss(st["params"], batch, self._sample_gen,
                                      cfg)
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
            return self.state["g_ema" if self.spec.adversarial else "ema"]
        return self.raw_generator_params

    @property
    def raw_generator_params(self):
        """The live (non-EMA) sampling-side params."""
        return self.state["g_params" if self.spec.adversarial else "params"]

    @torch.no_grad()
    def sample(self, n: Optional[int] = None, z=None) -> np.ndarray:
        """n samples [n, image_dim] in [0, 1] from the generator prior, or
        from the given noise `z` [n, z_dim] (numpy or tensor; [n,
        latent_dim] for the VAE family)."""
        if z is not None:
            z = torch.as_tensor(z, dtype=torch.float32,
                                device=self.device).contiguous()
            n = z.shape[0]
        n = n or self.cfg.sample_n
        out = self.spec.sample(self.generator_params, self._sample_gen, n,
                               self.cfg, z=z)
        return out.cpu().numpy()

    def generate_images(self, tag: str = "samples", n: Optional[int] = None,
                        out_dir: Optional[str] = None) -> str:
        """Reference's `generate_images`: a PNG sample grid."""
        imgs = self.sample(n)
        out_dir = out_dir or os.path.join(self.cfg.out_dir, self.cfg.variant)
        return save_image_grid(os.path.join(out_dir, f"{tag}.png"), imgs)

    def viz_loss(self, path: Optional[str] = None) -> str:
        """Reference's loss-curve plot (a CSV without matplotlib)."""
        path = path or os.path.join(self.cfg.out_dir, self.cfg.variant,
                                    "loss.png")
        return plot_losses(path, getattr(self, "history", {}))

    # --------------------------------------------------------------
    def _npz_only(self) -> None:
        if self.cfg.ckpt_backend != "npz":
            raise NotImplementedError(
                f"ckpt_backend={self.cfg.ckpt_backend!r}: the port reads "
                "and writes the npz layout only")

    def save_model(self, path: str) -> str:
        """Checkpoint the full train state (params, optimizer states, the
        variant's carried scalars, step, rng) in the JAX package's npz
        layout."""
        self._npz_only()
        return save_state(path, self.state)

    def load_model(self, path: str) -> None:
        """Load a checkpoint written by either package's ``save_model``
        (npz layout); raises on any shape/dtype/config mismatch. The
        optimizer slots, counts, carried scalars (fishergan's ``lam``) and
        rng words are restored when the file has them, so training resumes
        where it stopped."""
        self._npz_only()
        loaded = load_jax_checkpoint(path, self.cfg)
        st = dict(self.state)
        for key, v in loaded.items():
            if key == "rng":
                st["rng"] = np.asarray(v, dtype=np.uint32)
            elif key == "step":
                st["step"] = int(v)
            else:
                st[key] = params_from_numpy(v, self.device)
        self.state = st
