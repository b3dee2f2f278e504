"""Serving export — the port of ``generative_models_tpu/utils/export.py``:
a trained sampler as one self-contained ``torch.export`` program (the
counterpart of the reference's StableHLO artifact).

The artifact maps an int64 seed (a 0-dim tensor) to images [n,
image_dim] in [0, 1], with the generator's (or its EMA's) parameters
baked in as buffers. Its noise is drawn inside it from the seed by the
port's Philox4x32-10 in torch integer ops
(``ops/cuda_reparam.py::philox_normal_plain``, key = the seed's low and
high 32-bit words, offset 0: :func:`sampler_noise`), so its output is
bit-stable for each seed on a device; DDPM's reverse chain draws step i's
noise at offset i + 1 (:func:`sampler_chain`). The program traces the
configured number of steps (``ddpm_sample_steps``, 0 the full chain, or
``flow_sample_steps``) as a straight line of net calls. cgan's, infogan's
and conditional diffusion's samplers keep their class-cycled grid. The program is traced through the plain path on
the CPU (a ctypes kernel cannot be traced, as the reference forces XLA
for its export), so it holds only aten ops and loads in a process that
imports torch alone:

    save_sampler("sampler.pt2", spec, cfg, params, n=64)
    # elsewhere, torch only:
    ep = torch.export.load("sampler.pt2")
    images = ep.module()(torch.tensor(seed))        # on the CPU
    from torch.export.passes import move_to_device_pass
    ep = move_to_device_pass(ep, "cuda")
    images = ep.module()(torch.tensor(seed, device="cuda"))

The devices the program names (its buffers, each ``arange``) are the
CPU's; ``move_to_device_pass`` rewrites them, as :func:`load_sampler`
does for ``device=``. A conv sampler's program holds plain convolution
ops, which on the card follow cuDNN's global flags (TF32 and
nondeterministic algorithms allowed by default), and its float32 matmuls
follow the TF32 flag: :func:`load_sampler` runs it under
``models/conv.py::strict_convs`` and ``ops/matmul.py::strict_matmuls``,
as the port's modules run. vqvae's artifact maps its normal draws to
uniform tokens, vqprior's to the Gumbel draws of its L decode steps
(offsets i + 1, traced as a straight line; ``spec.noise_of_normal``).
"""

from __future__ import annotations

import io
import os

import torch

from generative_models_tpu_torch.models.conv import strict_convs
from generative_models_tpu_torch.ops.cuda_reparam import (
    philox_normal_plain,
    philox_normal_steps,
)
from generative_models_tpu_torch.ops.matmul import strict_matmuls
from generative_models_tpu_torch.utils.tree import (
    tree_leaves,
    tree_map,
    tree_unflatten,
)

_MASK = 0xFFFFFFFF
# steps of DDPM chain noise one Philox call draws (sampler_chain)
CHAIN_BLOCK = 50


def noise_width(spec, cfg) -> int:
    """The width of the noise a variant's ``sample`` takes: ``z_dim`` for
    an adversarial variant, ``latent_dim`` for the VAE family,
    ``image_dim`` for ddpm and flow (their initial x), L for vqvae (its
    tokens), K for vqprior (its chain's Gumbel draws; its z is unused)."""
    return cfg.z_dim if spec.adversarial else spec.sample_lanes(cfg)


def _words(seed: torch.Tensor) -> torch.Tensor:
    return torch.stack([seed & _MASK, (seed >> 32) & _MASK])


def sampler_noise(seed: torch.Tensor, n: int, width: int) -> torch.Tensor:
    """The artifact's noise [n, width] for an int64 0-dim `seed` (on the
    device the noise is wanted on)."""
    return philox_normal_plain(_words(seed), 0, (n, width),
                               device=seed.device)


def sampler_chain(seed: torch.Tensor, n: int, width: int):
    """A chain sampler's per-step noise in the artifact (DDPM's; vqprior's
    before its Gumbel map): step i -> [n, width], the
    seed's Philox words at counter offset i + 1 (offset 0 is
    :func:`sampler_noise`'s), drawn CHAIN_BLOCK steps to a Philox call
    (a call a step would make a long chain's program many times larger
    and slower to trace). Steps are asked for in order."""
    words = _words(seed)
    block = {}

    def chain(i: int) -> torch.Tensor:
        j = i // CHAIN_BLOCK
        if j not in block:
            block.clear()
            block[j] = philox_normal_steps(words, 1 + j * CHAIN_BLOCK,
                                           CHAIN_BLOCK, (n, width),
                                           device=seed.device)
        return block[j][i % CHAIN_BLOCK]
    return chain


def sampler_draws(spec, cfg, seed: torch.Tensor, n: int) -> dict:
    """The noise the artifact hands ``spec.sample`` for `seed`, as its
    keyword arguments: ``z`` (:func:`sampler_noise`) and, for a chain
    sampler, ``chain`` (:func:`sampler_chain`), each mapped by
    ``spec.noise_of_normal`` where the variant has one (vqvae's tokens,
    vqprior's Gumbel draws). ``Trainer.sample(**sampler_draws(...))``
    gives the artifact's images."""
    width = noise_width(spec, cfg)
    of_normal = getattr(spec, "noise_of_normal", None)
    z = sampler_noise(seed, n, width)
    if of_normal is not None:
        z = of_normal(z, cfg)
    if not getattr(spec, "chain_noise", False):
        return {"z": z}
    normal = sampler_chain(seed, n, width)
    if of_normal is None:
        return {"z": z, "chain": normal}

    def chain(i: int) -> torch.Tensor:
        return of_normal(normal(i), cfg)
    return {"z": z, "chain": chain}


class _Sampler(torch.nn.Module):
    """seed -> spec.sample(params, z=sampler_noise(seed)), the parameters
    held as buffers."""

    def __init__(self, spec, cfg, params, n: int):
        super().__init__()
        self.spec, self.cfg, self.n = spec, cfg, n
        self.like = tree_map(lambda t: None, params)   # the structure
        self.count = 0
        for t in tree_leaves(params):
            self.register_buffer(f"p{self.count}",
                                 t.detach().to("cpu", copy=True))
            self.count += 1

    def forward(self, seed: torch.Tensor) -> torch.Tensor:
        params = tree_unflatten(self.like, [getattr(self, f"p{i}")
                                            for i in range(self.count)])
        return self.spec.sample(params, None, self.n, self.cfg,
                                **sampler_draws(self.spec, self.cfg, seed,
                                                self.n))


def export_sampler(spec, cfg, params, n: int) -> bytes:
    """Serialize ``seed -> [n, image_dim] images in [0, 1]`` with `params`
    (the sampling-side tree) baked in, traced on the CPU through the
    plain path."""
    ep = torch.export.export(_Sampler(spec, cfg, params, n),
                             (torch.tensor(0, dtype=torch.int64),))
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    return buf.getvalue()


def save_sampler(path: str, spec, cfg, params, n: int) -> str:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(export_sampler(spec, cfg, params, n))
    return path


def load_sampler(path: str, device="cuda"):
    """``fn(seed: int) -> images`` (a tensor on `device`), with torch
    alone. The card by default, raising when there is none; the CPU only
    when asked for (``device="cpu"``)."""
    from torch.export.passes import move_to_device_pass
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but no CUDA device is present; "
            "pass device='cpu' to load the sampler on the CPU")
    ep = torch.export.load(path)
    if dev.type != "cpu":
        ep = move_to_device_pass(ep, dev)
    module = ep.module()

    def fn(seed: int) -> torch.Tensor:
        # its convs and float32 products IEEE, its convs repeatable
        with strict_convs(), strict_matmuls():
            return module(torch.tensor(seed, dtype=torch.int64, device=dev))
    return fn
