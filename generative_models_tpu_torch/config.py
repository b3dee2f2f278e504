"""Central configuration for every variant — the PyTorch port's copy of
``generative_models_tpu/config.py``.

Field names, defaults, per-variant overrides and validation are the
reference's, so ``dataclasses.asdict(variant_config(v))`` is equal on
both sides for every variant (tests/test_torch_port_config.py). The
reference's comments record why each default was chosen and what it
measured on its own hardware; those measurements do not describe this
port and are not repeated here. Fields whose code path is not ported yet
are kept so that a config (and a checkpoint made with it) means the same
thing in both packages.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

# Names of the f-GAN divergences, the keys of
# ``losses/fgan.py::DIVERGENCES`` (kept here so that listing them imports
# no torch).
FGAN_DIVERGENCES: Tuple[str, ...] = (
    "total_variation", "kl", "reverse_kl", "pearson", "squared_hellinger",
    "jensen_shannon", "gan")


@dataclasses.dataclass
class Config:
    """Hyperparameters shared by every variant, with per-variant overrides."""

    variant: str = "nsgan"

    # --- data ---------------------------------------------------------
    batch_size: int = 100
    image_dim: int = 784           # 28x28 MNIST, flattened
    num_classes: int = 10
    dataset: str = "mnist"         # "mnist" | "synthetic"
    data_dir: str = "data"
    val_size: int = 0
    data_storage: str = "float32"  # "float32" | "uint8"

    # --- model --------------------------------------------------------
    arch: str = "mlp"              # "mlp" | "conv"
    conv_channels: int = 64
    z_dim: int = 128
    hidden_dim: int = 400
    g_hidden_act: str = "relu"
    d_hidden_act: str = "leaky_relu"
    leaky_slope: float = 0.2

    # VAE family
    latent_dim: int = 20
    vae_hidden_dim: int = 400

    # --- optimization ---------------------------------------------------
    g_lr: float = 2e-4
    d_lr: float = 2e-4
    optimizer: str = "adam"        # "adam" | "rmsprop"
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    adam_eps: float = 1e-8
    d_steps: int = 1               # critic steps per generator step

    # --- variant-specific mechanisms ------------------------------------
    # EMA of the generator weights, used for sampling when > 0.
    ema_decay: float = 0.0
    spectral_projection: bool = False
    sn_target: float = 1.0
    sn_iters: int = 10
    sn_mode: str = "amortized"     # "amortized" | "fresh"
    wgan_clip: float = 0.01
    gp_lambda: float = 10.0
    dragan_noise_scale: float = 0.5
    began_gamma: float = 0.75
    began_lambda_k: float = 1e-3
    began_k0: float = 0.0
    began_ae_hidden: int = 400
    fisher_rho: float = 1e-6
    info_cat_dim: int = 10
    info_cont_dim: int = 2
    info_lambda: float = 1.0
    info_cont_fixed_var: bool = True
    fgan_divergence: str = "jensen_shannon"
    fgan_g_loss: str = "saturating"  # "saturating" | "nonsaturating"
    birvae_bits: float = 12.0
    vae_recon: str = "bce"         # "bce" | "mse"

    # DDPM
    ddpm_timesteps: int = 1000
    ddpm_beta_start: float = 1e-4
    ddpm_beta_end: float = 0.02
    ddpm_schedule: str = "linear"  # "linear" | "cosine"
    ddpm_time_dim: int = 128
    ddpm_sample_steps: int = 0     # 0 = full chain
    ddpm_eta: float = 1.0
    ddpm_cond: bool = False
    ddpm_label_drop: float = 0.1
    ddpm_guidance: float = 0.0
    # flow matching (shares ddpm_cond / ddpm_label_drop / ddpm_guidance)
    flow_sample_steps: int = 50
    flow_solver: str = "euler"     # "euler" | "heun"
    flow_reflow: bool = False

    # VQ-VAE family
    vq_codebook_size: int = 64
    vq_code_dim: int = 16
    vq_tokens: int = 16
    vq_beta: float = 0.25
    vq_prior_width: int = 128
    vq_prior_layers: int = 2
    vq_prior_heads: int = 4
    vq_prior_temp: float = 1.0
    vq_decode: str = "cache"       # "full" | "cache"
    vq_freeze_tokenizer: bool = False

    # --- numerics / performance ----------------------------------------
    # Activation compute dtype; params stay f32. "auto" resolves by
    # resolve_dtype (the Trainer, on its device's type).
    dtype: str = "auto"            # "auto" | "float32" | "bfloat16"
    prng_impl: str = "threefry"
    use_pallas: bool = False
    fused_step: "bool | str" = "auto"
    pallas_max_batch: int = 0
    donate_buffers: bool = False
    scan_steps: int = 1000

    # --- parallelism ----------------------------------------------------
    dp: int = 1
    dp_impl: str = "jit"           # "jit" | "shard_map"
    tp: int = 1

    # --- run / io -------------------------------------------------------
    seed: int = 42
    steps: int = 2000
    epochs: Optional[int] = None   # if set, overrides steps
    sample_every: int = 0
    sample_n: int = 64
    out_dir: str = "runs"
    ckpt_every: int = 0
    ckpt_backend: str = "npz"      # "npz" | "orbax"
    resume: bool = False
    profile: bool = False

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)

    def __post_init__(self):
        if self.arch not in ("mlp", "conv"):
            raise ValueError(f"arch must be mlp|conv, got {self.arch!r}")
        if self.arch == "conv" and self.tp > 1:
            raise ValueError(
                "tp>1 shards the MLP stacks Megatron-style; the conv "
                "stacks have no sharding rules — use arch='mlp' with tp, "
                "or dp for conv")
        if self.arch == "conv" and self.conv_channels < 1:
            raise ValueError(
                f"conv_channels must be >= 1, got {self.conv_channels}")
        if self.dtype not in ("auto", "float32", "bfloat16"):
            raise ValueError(
                f"dtype must be auto|float32|bfloat16, got {self.dtype!r}")
        if self.optimizer not in ("adam", "rmsprop"):
            raise ValueError(
                f"optimizer must be adam|rmsprop, got {self.optimizer!r}")
        if self.vae_recon not in ("bce", "mse"):
            raise ValueError(
                f"vae_recon must be bce|mse, got {self.vae_recon!r}")
        if not 0.0 <= self.ema_decay < 1.0:
            raise ValueError(
                f"ema_decay must be in [0, 1), got {self.ema_decay}")
        if self.data_storage not in ("float32", "uint8"):
            raise ValueError(
                f"data_storage must be float32|uint8, got "
                f"{self.data_storage!r}")
        if self.ckpt_backend not in ("npz", "orbax"):
            raise ValueError(
                f"ckpt_backend must be npz|orbax, got {self.ckpt_backend!r}")
        if self.tp < 1 or self.dp < 1:
            raise ValueError(
                f"dp/tp must be >= 1, got dp={self.dp} tp={self.tp}")
        if self.prng_impl not in ("threefry", "rbg", "unsafe_rbg"):
            raise ValueError(
                f"prng_impl must be threefry|rbg|unsafe_rbg, got "
                f"{self.prng_impl!r}")
        if self.fused_step not in (True, False, "auto"):
            raise ValueError(
                f"fused_step must be True|False|'auto', got "
                f"{self.fused_step!r}")
        if self.fgan_g_loss not in ("saturating", "nonsaturating"):
            raise ValueError(
                f"fgan_g_loss must be saturating|nonsaturating, got "
                f"{self.fgan_g_loss!r}")
        if self.spectral_projection and self.d_steps == 0:
            raise ValueError(
                "spectral_projection constrains the critic through the "
                "d_post hook; the single-model variants (vae/birvae, "
                "d_steps=0) have no critic — the flag would be a silent "
                "no-op")
        if self.sn_mode not in ("amortized", "fresh"):
            raise ValueError(
                f"sn_mode must be amortized|fresh, got {self.sn_mode!r}")
        if self.ddpm_schedule not in ("linear", "cosine"):
            raise ValueError(
                f"ddpm_schedule must be 'linear' or 'cosine', got "
                f"{self.ddpm_schedule!r}")
        if self.ddpm_sample_steps < 0 or (
                self.ddpm_sample_steps > self.ddpm_timesteps):
            raise ValueError(
                f"ddpm_sample_steps must be in [0, ddpm_timesteps="
                f"{self.ddpm_timesteps}], got {self.ddpm_sample_steps}")
        if not 0.0 <= self.ddpm_eta <= 1.0:
            raise ValueError(
                f"ddpm_eta must be in [0, 1], got {self.ddpm_eta}")
        if not 0.0 <= self.ddpm_label_drop <= 1.0:
            raise ValueError(
                f"ddpm_label_drop must be in [0, 1], got "
                f"{self.ddpm_label_drop}")
        if self.ddpm_guidance < 0.0:
            raise ValueError(
                f"ddpm_guidance must be >= 0, got {self.ddpm_guidance}")
        if self.flow_sample_steps < 1:
            raise ValueError(
                f"flow_sample_steps must be >= 1, got "
                f"{self.flow_sample_steps}")
        if self.flow_solver not in ("euler", "heun"):
            raise ValueError(
                f"flow_solver must be 'euler' or 'heun', got "
                f"{self.flow_solver!r}")
        if self.ddpm_guidance > 0.0 and not self.ddpm_cond:
            raise ValueError(
                "ddpm_guidance requires ddpm_cond=True (guidance mixes "
                "the conditional and null-token predictions)")
        if self.ddpm_guidance > 0.0 and self.ddpm_label_drop <= 0.0:
            raise ValueError(
                "ddpm_guidance > 0 requires ddpm_label_drop > 0: with "
                "label dropout disabled the null token is never trained, "
                "so guided extrapolation would mix a random-init null "
                "branch into every sample")
        if self.flow_reflow:
            if self.variant != "flow":
                raise ValueError(
                    "flow_reflow applies to the flow variant only, got "
                    f"variant={self.variant!r}")
            if self.ddpm_cond:
                raise ValueError(
                    "flow_reflow is unconditional: the teacher coupling "
                    "is drawn from the prior, not per label")
            if self.data_storage == "uint8":
                raise ValueError(
                    "flow_reflow stores raw-float noise columns; "
                    "data_storage='uint8' cannot represent them")
        if self.vq_codebook_size < 2 or self.vq_code_dim < 1 or (
                self.vq_tokens < 1):
            raise ValueError(
                "vq_codebook_size >= 2, vq_code_dim >= 1, vq_tokens >= 1 "
                f"required; got K={self.vq_codebook_size} "
                f"D={self.vq_code_dim} L={self.vq_tokens}")
        if self.vq_prior_width % self.vq_prior_heads:
            raise ValueError(
                f"vq_prior_width ({self.vq_prior_width}) must divide "
                f"evenly into vq_prior_heads ({self.vq_prior_heads})")
        if self.vq_prior_temp <= 0.0:
            raise ValueError(
                f"vq_prior_temp must be > 0, got {self.vq_prior_temp}")
        if self.vq_freeze_tokenizer and self.variant != "vqprior":
            raise ValueError(
                "vq_freeze_tokenizer applies to the vqprior variant "
                f"only, got variant={self.variant!r}")
        if self.vq_decode not in ("full", "cache"):
            raise ValueError(
                f"vq_decode must be 'full' or 'cache', got "
                f"{self.vq_decode!r}")
        if self.variant == "vqprior" and self.ddpm_guidance > 0.0:
            raise ValueError(
                "the AR prior is plain-conditional (ddpm_cond): it has "
                "no guidance extrapolation — ddpm_guidance applies to "
                "the ddpm/flow samplers only")
        if self.variant == "fgan":
            # fail at construction, not in the first step
            from generative_models_tpu_torch.losses.fgan import get_divergence
            get_divergence(self.fgan_divergence)


# Per-variant overrides (the reference's table, unchanged).
VARIANT_OVERRIDES: Dict[str, Dict[str, Any]] = {
    "vae": {"d_steps": 0},
    "birvae": {"d_steps": 0, "vae_recon": "mse"},
    "mmgan": {"adam_b1": 0.5},
    "nsgan": {"adam_b1": 0.5},
    "lsgan": {"adam_b1": 0.5},
    "cgan": {"adam_b1": 0.5},
    "ragan": {"adam_b1": 0.5},
    "infogan": {"adam_b1": 0.5, "g_lr": 1e-3},
    "fgan": {"adam_b1": 0.5},
    "began": {"began_gamma": 0.75, "adam_b1": 0.5},
    "wgan": {"optimizer": "rmsprop", "g_lr": 5e-5, "d_lr": 5e-5,
             "d_steps": 5},
    "wgangp": {"g_lr": 1e-4, "d_lr": 1e-4, "adam_b1": 0.5, "adam_b2": 0.9,
               "d_steps": 5},
    "dragan": {"adam_b1": 0.5},
    "fishergan": {"adam_b1": 0.5},
    "ddpm": {"d_steps": 0, "ema_decay": 0.999},
    "flow": {"d_steps": 0, "ema_decay": 0.999},
    "vqvae": {"d_steps": 0},
    "vqprior": {"d_steps": 0},
}

VARIANTS: Tuple[str, ...] = tuple(VARIANT_OVERRIDES)

# Applied when the user selects arch="conv" for that variant (between
# the variant row and user overrides, so an explicit flag still wins).
CONV_VARIANT_OVERRIDES: Dict[str, Dict[str, Any]] = {
    "began": {"spectral_projection": True, "sn_target": 2.0},
    "ragan": {"spectral_projection": True, "sn_target": 1.0},
    "lsgan": {"spectral_projection": True, "sn_target": 1.0},
    "ddpm": {"ddpm_schedule": "cosine"},
}

# The batch from which the conv stacks' general step runs at least 1.01x
# faster with bf16 operands than in float32 on the card, for nsgan and
# vae at it and at every larger batch measured (None: at no batch).
# Measured by tools/policy_smoke.py --crossover-window 3 (chip_smoke.py
# phase 5j in runs of 3 s: general steps, A B B A twice, each arm's
# median run, host clock; the rule fixed before the table was read) on
# an NVIDIA H100 80GB HBM3 at 700.00 W; bf16/float32 steps/s at B 100,
# 256, 512, 1024, 2048: nsgan 0.873, 1.017, 1.024, 1.699, 1.639; vae
# 0.925, 0.872, 1.072, 1.544, 1.533. At 512 the gain is small (nsgan's
# bf16 runs spread 47-57 steps/s); from 1024 on it is 1.5x and more.
# The reference's 512 is a TPU's, measured apart from this one.
CONV_BF16_CROSSOVER_BATCH: Optional[int] = 512


def resolve_dtype(cfg: "Config", platform: str) -> str:
    """The dtype ``Config.dtype="auto"`` stands for on `platform` (a
    torch device type, "cuda" or "cpu"): float32 for the MLP stacks at
    every batch and for everything on the CPU; bf16 operands for the
    conv stacks on the card at batches from
    :data:`CONV_BF16_CROSSOVER_BATCH` on, as the reference's
    ``resolve_dtype`` does on a TPU with its own crossover."""
    if cfg.dtype != "auto":
        return cfg.dtype
    if (platform == "cuda" and cfg.arch == "conv"
            and CONV_BF16_CROSSOVER_BATCH is not None
            and cfg.batch_size >= CONV_BF16_CROSSOVER_BATCH):
        return "bfloat16"
    return "float32"


# Conditional flow's guidance default (applied only with label dropout;
# an explicit ddpm_guidance always wins).
FLOW_GUIDANCE_DEFAULT = 0.3


def variant_config(variant: str, **overrides) -> Config:
    """Config for `variant` with its registry defaults applied, then
    arch-conditional defaults (CONV_VARIANT_OVERRIDES), then user
    overrides on top."""
    if variant not in VARIANT_OVERRIDES:
        raise ValueError(
            f"unknown variant {variant!r}; known: {sorted(VARIANT_OVERRIDES)}")
    kw: Dict[str, Any] = {"variant": variant}
    kw.update(VARIANT_OVERRIDES[variant])
    if overrides.get("arch") == "conv":
        kw.update(CONV_VARIANT_OVERRIDES.get(variant, {}))
    kw.update(overrides)
    cfg = Config(**kw)
    if (variant == "flow" and cfg.ddpm_cond and cfg.ddpm_label_drop > 0
            and "ddpm_guidance" not in overrides):
        cfg = cfg.replace(ddpm_guidance=FLOW_GUIDANCE_DEFAULT)
    return cfg
