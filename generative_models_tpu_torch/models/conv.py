"""The convolutional (DCGAN-style) stacks, ``Config.arch="conv"`` — the
port of ``generative_models_tpu/models/conv.py``.

The stacks keep the MLP stacks' flat interface: generators and decoders
take flat latent rows and return flat 784-pixel images in [0, 1];
critics take flat 784-pixel rows. Every loss head, the gradient penalty,
sampling, checkpoints and the DP step therefore run on either stack.

- Generator / decoder: a dense ``z -> 7*7*2C``, then two stride-2 4x4
  transposed convs (7 -> 14 -> 28), GroupNorm and ReLU before each, a
  sigmoid head (began's critic decoder has no GroupNorm).
- Critic / encoder trunk: two stride-2 4x4 convs (28 -> 14 -> 7) with
  ``cfg.d_hidden_act``, no normalisation, flattened to ``7*7*2C``.
- Parameters keep the reference's layout: kernels HWIO ``[kh, kw, cin,
  cout]``, so checkpoints, optimizer slots and the spectral projection
  (which reads ``[kh*kw*cin, cout]``) are those of the JAX package. The
  convs run NCHW: :func:`conv_apply` takes ``w.permute(3, 2, 0, 1)``;
  :func:`convt_apply` takes the kernel flipped in both spatial axes,
  ``w.flip(0, 1).permute(2, 3, 0, 1)`` (``lax.conv_transpose`` with
  ``transpose_kernel=False``); both take the reference's ``stride`` and
  SAME padding (:func:`same_pad`, :func:`same_pad_transpose`): the DCGAN
  stacks' 4x4 kernels at stride 2 pad 1, as do the diffusion UNet's 3x3
  kernels at stride 1 (``models/ddpm_net.py``). Flattening is NHWC ``(h, w, c)`` order on both sides
  (:func:`_img`, :func:`_flat`, the generator's ``[B, 7, 7, 2C]``).
- Init: every kernel, transposed ones too, ``U(+-1/sqrt(kh*kw*cin))``,
  drawn from an explicit ``torch.Generator`` as ``models/mlp.py`` draws.
- The dense layers go through ``ops/linear.py::fused_linear`` (on the
  card the whole-MLP kernels, ``MLPFunction``; on the CPU the plain
  version); infogan's ``fc`` and its two heads run as one two-layer
  stack. :func:`discriminator_apply_plain` takes ``linear_plain`` on any
  device: the gradient penalty differentiates the critic twice.
- The convolutions and GroupNorm are cuDNN's, as the reference leaves
  them to XLA (it has no Pallas kernel for them). A convolution on the
  card, forward or backward, at any order, runs with cuDNN's TF32 off
  and its deterministic algorithms (:func:`strict_convs`): by default
  cuDNN would round float32 operands to TF32, and its transposed
  convolution would not repeat bit for bit.
- ``dtype="bfloat16"``: a conv casts its input and kernel to bf16, its
  output stays bf16 and the bias is added in bf16; the dense layers
  round their operands to bf16 and sum in float32.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from generative_models_tpu_torch.models.mlp import linear_init, mlp_apply
from generative_models_tpu_torch.ops.activations import apply_act
from generative_models_tpu_torch.ops.linear import fused_linear, linear_plain

GN_EPS = 1e-5
GN_GROUPS = 8
STRIDE, PAD = 2, 1     # the DCGAN stacks': SAME at a 4x4 kernel, stride 2


def _cdt(cfg):
    return torch.bfloat16 if cfg.dtype == "bfloat16" else None


def _f32(t):
    """A stack's output in float32 (the reference's astype), a float64
    oracle's left in float64."""
    return t if t.dtype == torch.float64 else t.float()


# --------------------------------------------------------------------
# Convolutions in IEEE float32, deterministic, differentiable to any order
# --------------------------------------------------------------------

@contextlib.contextmanager
def strict_convs():
    """cuDNN's convolutions in IEEE float32 and deterministic while the
    block runs. By default torch lets cuDNN round float32 operands to
    TF32 (``torch.backends.cudnn.allow_tf32``) and pick algorithms whose
    sums run in no fixed order (``torch.backends.cudnn.deterministic``)."""
    cudnn = torch.backends.cudnn
    prev = cudnn.allow_tf32, cudnn.deterministic
    cudnn.allow_tf32, cudnn.deterministic = False, True
    try:
        yield
    finally:
        cudnn.allow_tf32, cudnn.deterministic = prev


def _strict(t: torch.Tensor):
    """:func:`strict_convs` for a CUDA tensor `t`, else nothing."""
    return strict_convs() if t.is_cuda else contextlib.nullcontext()


# The three functions below are the conv C(u, w) at a stride and a
# symmetric padding (weights OIHW), its adjoint in u, C^T(v, w), and its
# adjoint in w, W(u, v), each the others' derivative: every backward runs
# one of them again at the same stride, padding and kernel size, under
# _strict, so no backward of any order leaves cuDNN's settings to the
# global flags at the time autograd runs it. The stride and padding
# default to the DCGAN stacks' (2 and 1).

class _Conv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, u, w, stride=STRIDE, pad=PAD):
        ctx.save_for_backward(u, w)
        ctx.sp = (stride, pad)
        with _strict(u):
            return F.conv2d(u, w, stride=stride, padding=pad)

    @staticmethod
    def backward(ctx, g):
        u, w = ctx.saved_tensors
        s, p = ctx.sp
        du = (_ConvT.apply(g, w, tuple(u.shape[-2:]), s, p)
              if ctx.needs_input_grad[0] else None)
        dw = (_ConvW.apply(u, g, w.shape[-1], s, p)
              if ctx.needs_input_grad[1] else None)
        return du, dw, None, None


class _ConvT(torch.autograd.Function):
    @staticmethod
    def forward(ctx, v, w, hw, stride=STRIDE, pad=PAD):
        ctx.save_for_backward(v, w)
        ctx.sp = (stride, pad)
        k = w.shape[-1]
        extra = tuple(n - ((m - 1) * stride - 2 * pad + k)
                      for n, m in zip(hw, v.shape[-2:]))
        with _strict(v):
            return F.conv_transpose2d(v, w, stride=stride, padding=pad,
                                      output_padding=extra)

    @staticmethod
    def backward(ctx, g):
        v, w = ctx.saved_tensors
        s, p = ctx.sp
        dv = _Conv.apply(g, w, s, p) if ctx.needs_input_grad[0] else None
        dw = (_ConvW.apply(g, v, w.shape[-1], s, p)
              if ctx.needs_input_grad[1] else None)
        return dv, dw, None, None, None


class _ConvW(torch.autograd.Function):
    @staticmethod
    def forward(ctx, u, v, k, stride=STRIDE, pad=PAD):
        ctx.save_for_backward(u, v)
        ctx.sp = (stride, pad)
        with _strict(u):
            return torch.nn.grad.conv2d_weight(
                u, (v.shape[1], u.shape[1], k, k), v, stride=stride,
                padding=pad)

    @staticmethod
    def backward(ctx, gw):
        u, v = ctx.saved_tensors
        s, p = ctx.sp
        du = (_ConvT.apply(v, gw, tuple(u.shape[-2:]), s, p)
              if ctx.needs_input_grad[0] else None)
        dv = _Conv.apply(u, gw, s, p) if ctx.needs_input_grad[1] else None
        return du, dv, None, None, None


def same_pad(n: int, k: int, stride: int) -> int:
    """The padding each side of an input `n` wide that SAME padding gives a
    k-wide kernel at `stride` (the output ceil(n / stride) wide); raises
    when SAME would pad one side more than the other."""
    total = max((-(-n // stride) - 1) * stride + k - n, 0)
    if total % 2:
        raise ValueError(f"SAME padding of a {k}-wide kernel at stride "
                         f"{stride} on {n} pixels is asymmetric")
    return total // 2


def same_pad_transpose(k: int, stride: int) -> int:
    """The padding of ``conv_transpose2d`` that computes
    ``lax.conv_transpose(padding="SAME")``: lax pads the dilated input by
    (a, b), a = k - 1 when stride > k - 1, else ceil((k + stride - 2) / 2),
    b = k + stride - 2 - a; torch pads k - 1 - pad on each side and
    b - a more on the far side through the output padding."""
    total = k + stride - 2
    a = k - 1 if stride > k - 1 else -(-total // 2)
    if not 0 <= total - 2 * a < stride:
        raise ValueError(f"SAME transposed conv of a {k}-wide kernel at "
                         f"stride {stride} has no torch padding")
    return k - 1 - a


# --------------------------------------------------------------------
# Layer primitives
# --------------------------------------------------------------------

def conv_init(gen: torch.Generator, kh: int, kw: int, cin: int, cout: int,
              device="cpu") -> dict:
    """One conv (or transposed-conv) kernel: W [kh, kw, cin, cout] (HWIO)
    and b [cout], both U(+-1/sqrt(kh*kw*cin)), W drawn first."""
    bound = 1.0 / float(kh * kw * cin) ** 0.5

    def u(*shape):
        t = torch.rand(shape, generator=gen, device=gen.device,
                       dtype=torch.float32)
        return (t * (2 * bound) - bound).to(device)

    return {"w": u(kh, kw, cin, cout), "b": u(cout)}


def _cast(x, w, compute_dtype):
    if compute_dtype is not None:
        return x.to(compute_dtype), w.to(compute_dtype)
    return x, w


def _bias_act(y, b, act, slope):
    """y + b in y's dtype (NCHW: b along the channels), then `act`."""
    return apply_act(y + b.to(y.dtype)[:, None, None], act, slope)


def conv_apply(layer, x, stride: int = STRIDE, act: str = "none",
               slope: float = 0.2, compute_dtype=None):
    """act(conv(x, W, stride, SAME) + b) of NCHW `x` (stride 2 halves H
    and W, the DCGAN stacks'; stride 1 keeps them, the UNet's 3x3 convs)."""
    x, w = _cast(x, layer["w"], compute_dtype)
    pad = same_pad(x.shape[-2], w.shape[0], stride)
    return _bias_act(_Conv.apply(x, w.permute(3, 2, 0, 1), stride, pad),
                     layer["b"], act, slope)


def convt_apply(layer, x, stride: int = STRIDE, act: str = "none",
                slope: float = 0.2, compute_dtype=None):
    """act(conv_transpose(x, W, stride, SAME) + b) of NCHW `x`, H and W
    times `stride` (stride 2: the DCGAN upsample block)."""
    x, w = _cast(x, layer["w"], compute_dtype)
    hw = (stride * x.shape[-2], stride * x.shape[-1])
    y = _ConvT.apply(x, w.flip(0, 1).permute(2, 3, 0, 1), hw, stride,
                     same_pad_transpose(w.shape[0], stride))
    return _bias_act(y, layer["b"], act, slope)


def gn_init(channels: int, device="cpu") -> dict:
    return {"scale": torch.ones(channels, device=device),
            "bias": torch.zeros(channels, device=device)}


def gn_groups(channels: int, groups: int = GN_GROUPS) -> int:
    """min(groups, channels), lowered until it divides the channels."""
    g = min(groups, channels)
    while channels % g:
        g -= 1
    return g


def gn_apply(params, x, groups: int = GN_GROUPS):
    """GroupNorm of NCHW `x` per sample (biased variance, eps inside the
    rsqrt), then the per-channel scale and bias in float32, as the
    reference promotes a bf16 input there."""
    y = F.group_norm(x, gn_groups(x.shape[1], groups), eps=GN_EPS)
    return (_f32(y) * params["scale"][:, None, None]
            + params["bias"][:, None, None])


def _img(x, channels: int = 1):
    """[B, 784*channels] flat (h, w, c) rows -> [B, channels, 28, 28]."""
    return x.reshape(x.shape[0], 28, 28, channels).permute(0, 3, 1, 2)


def _flat(x):
    """NCHW -> [B, H*W*C] rows in (h, w, c) order."""
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


# --------------------------------------------------------------------
# Generator / decoder: latent [B, in_dim] -> images [B, 784] in [0, 1]
# --------------------------------------------------------------------

def generator_init(gen: torch.Generator, cfg, in_dim=None, norm: bool = True,
                   device="cpu") -> dict:
    """``{"fc", "up1", "up2"}`` drawn in that order, and ``"gn0"``,
    ``"gn1"`` unless `norm` is False (began's critic decoder)."""
    in_dim = cfg.z_dim if in_dim is None else in_dim
    c = cfg.conv_channels
    params = {
        "fc": linear_init(gen, in_dim, 7 * 7 * 2 * c, device),
        "up1": conv_init(gen, 4, 4, 2 * c, c, device),
        "up2": conv_init(gen, 4, 4, c, 1, device),
    }
    if norm:
        params["gn0"] = gn_init(2 * c, device)
        params["gn1"] = gn_init(c, device)
    return params


def generator_apply(params, z, cfg, out_act: str = "sigmoid"):
    """Images [B, 784] (`out_act` "none": the pre-sigmoid logits). The
    hidden activation is ReLU whatever ``cfg.g_hidden_act`` says, as in
    the reference."""
    cdt = _cdt(cfg)
    c = cfg.conv_channels
    h = fused_linear(z, params["fc"]["w"], params["fc"]["b"], act="none",
                     compute_dtype=cdt)
    h = h.reshape(h.shape[0], 7, 7, 2 * c).permute(0, 3, 1, 2)
    h = apply_act(gn_apply(params["gn0"], h) if "gn0" in params else h,
                  "relu")
    h = convt_apply(params["up1"], h, compute_dtype=cdt)
    h = apply_act(gn_apply(params["gn1"], h) if "gn1" in params else h,
                  "relu")
    h = convt_apply(params["up2"], h, act=out_act, compute_dtype=cdt)
    return _f32(_flat(h))


# --------------------------------------------------------------------
# Critic trunk + discriminator: images [B, 784] -> logits [B]
# --------------------------------------------------------------------

def trunk_init(gen: torch.Generator, cfg, in_ch: int = 1,
               device="cpu") -> dict:
    c = cfg.conv_channels
    return {"c1": conv_init(gen, 4, 4, in_ch, c, device),
            "c2": conv_init(gen, 4, 4, c, 2 * c, device)}


def trunk_apply(params, x4d, cfg):
    """NCHW [B, in_ch, 28, 28] -> float32 rows [B, 7*7*2C], (h, w, c)
    order."""
    cdt = _cdt(cfg)
    h = conv_apply(params["c1"], x4d, act=cfg.d_hidden_act,
                   slope=cfg.leaky_slope, compute_dtype=cdt)
    h = conv_apply(params["c2"], h, act=cfg.d_hidden_act,
                   slope=cfg.leaky_slope, compute_dtype=cdt)
    return _f32(_flat(h))


def trunk_out_dim(cfg) -> int:
    return 7 * 7 * 2 * cfg.conv_channels


def discriminator_init(gen: torch.Generator, cfg, in_ch: int = 1,
                       device="cpu") -> dict:
    return {"trunk": trunk_init(gen, cfg, in_ch, device),
            "fc": linear_init(gen, trunk_out_dim(cfg), 1, device)}


def _critic(params, x4d, cfg, linear):
    h = trunk_apply(params["trunk"], x4d, cfg)
    return linear(h, params["fc"]["w"], params["fc"]["b"], act="none",
                  compute_dtype=_cdt(cfg))[..., 0]


def discriminator_apply(params, x, cfg):
    return _critic(params, _img(x), cfg, fused_linear)


def discriminator_apply_plain(params, x, cfg):
    """The critic with its dense layer in plain torch ops on any device:
    twice differentiable, for the gradient penalty's pass
    (``ops/penalty.py``)."""
    return _critic(params, _img(x), cfg, linear_plain)


# --------------------------------------------------------------------
# Conditional (cgan): the label as 10 one-hot maps after the image
# channel on D's input; concatenated to z on G
# --------------------------------------------------------------------

def cond_discriminator_init(gen: torch.Generator, cfg, device="cpu") -> dict:
    return discriminator_init(gen, cfg, 1 + cfg.num_classes, device)


def cond_discriminator_apply(params, x, labels, cfg):
    b = x.shape[0]
    y = F.one_hot(labels.long(), cfg.num_classes).to(torch.float32)
    y_maps = y[:, :, None, None].expand(b, cfg.num_classes, 28, 28)
    return _critic(params, torch.cat([_img(x), y_maps], dim=1), cfg,
                   fused_linear)


# --------------------------------------------------------------------
# VAE encoder: conv trunk -> dense (ReLU) -> (mu, logvar)
# --------------------------------------------------------------------

def encoder_init(gen: torch.Generator, cfg, device="cpu") -> dict:
    return {
        "trunk": trunk_init(gen, cfg, device=device),
        "fc": linear_init(gen, trunk_out_dim(cfg), cfg.vae_hidden_dim,
                          device),
        "mu": linear_init(gen, cfg.vae_hidden_dim, cfg.latent_dim, device),
        "logvar": linear_init(gen, cfg.vae_hidden_dim, cfg.latent_dim,
                              device),
    }


def encoder_apply(params, x, cfg):
    cdt = _cdt(cfg)
    h = trunk_apply(params["trunk"], _img(x), cfg)
    h = fused_linear(h, params["fc"]["w"], params["fc"]["b"], act="relu",
                     compute_dtype=cdt)
    mu = fused_linear(h, params["mu"]["w"], params["mu"]["b"],
                      compute_dtype=cdt)
    logvar = fused_linear(h, params["logvar"]["w"], params["logvar"]["b"],
                          compute_dtype=cdt)
    return mu, logvar


def decoder_init(gen: torch.Generator, cfg, device="cpu") -> dict:
    return generator_init(gen, cfg, in_dim=cfg.latent_dim, device=device)


def decoder_apply(params, z, cfg, logits: bool = False):
    return generator_apply(params, z, cfg,
                           out_act="none" if logits else "sigmoid")


# --------------------------------------------------------------------
# began's autoencoder critic: conv encoder -> bottleneck -> conv decoder
# --------------------------------------------------------------------

def began_d_init(gen: torch.Generator, cfg, device="cpu") -> dict:
    return {
        "enc_trunk": trunk_init(gen, cfg, device=device),
        "enc_fc": linear_init(gen, trunk_out_dim(cfg), cfg.began_ae_hidden,
                              device),
        # norm-free, as the paper's autoencoder
        "dec": generator_init(gen, cfg, in_dim=cfg.began_ae_hidden,
                              norm=False, device=device),
    }


def began_d_apply(params, x, cfg):
    """The reconstruction of x in [0, 1]. The bottleneck takes
    ``cfg.d_hidden_act`` at fused_linear's default slope 0.2, as the
    reference passes no slope there."""
    h = trunk_apply(params["enc_trunk"], _img(x), cfg)
    h = fused_linear(h, params["enc_fc"]["w"], params["enc_fc"]["b"],
                     act=cfg.d_hidden_act, compute_dtype=_cdt(cfg))
    return generator_apply(params["dec"], h, cfg)


# --------------------------------------------------------------------
# infogan: conv trunk + dense feature layer, the D head and the Q head
# --------------------------------------------------------------------

def infogan_d_init(gen: torch.Generator, cfg, device="cpu") -> dict:
    q_out = cfg.info_cat_dim + 2 * cfg.info_cont_dim
    return {
        "trunk": trunk_init(gen, cfg, device=device),
        "fc": linear_init(gen, trunk_out_dim(cfg), cfg.hidden_dim, device),
        "d_head": linear_init(gen, cfg.hidden_dim, 1, device),
        "q_head": linear_init(gen, cfg.hidden_dim, q_out, device),
    }


def infogan_d_apply(params, x, cfg):
    """(d_logit [B], q_cat_logits, q_mu, q_logvar). ``fc`` and the two
    heads side by side run as one two-layer stack (one launch of each
    MLP kernel on the card)."""
    from generative_models_tpu_torch.models.nets import infogan_head
    h = trunk_apply(params["trunk"], _img(x), cfg)
    out = mlp_apply([params["fc"], infogan_head(params)], h,
                    hidden_act=cfg.d_hidden_act, out_act="none",
                    slope=cfg.leaky_slope, compute_dtype=_cdt(cfg))
    cat, cont = cfg.info_cat_dim, cfg.info_cont_dim
    return (out[..., 0], out[..., 1:1 + cat],
            out[..., 1 + cat:1 + cat + cont], out[..., 1 + cat + cont:])
