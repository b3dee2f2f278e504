"""Runs that must come out not correct: the control of each driver, and
faults planted in the program underneath the timed path.

- The control: the nearest precision below the configuration's. Training
  runs the program's own bf16 path (``dtype="bfloat16"``: the chunk
  kernel with bf16 operands); generation puts the reference in the
  program's place, its products in TF32.
- ``state_unchanged`` (training): every chunk returns the state it was
  given, its metrics computed.
- ``half_batch`` (training): each batch's second half replaced by its
  first, rows and noise, so the mean runs over half the batch; (generation)
  the sampler draws the first half of the rows and returns them twice.
- ``step_unchanged`` (generation): the middle reverse step leaves x as it
  found it.
- ``answer_altered`` (generation): one image of each answer replaced by
  another where the sampler produces it.

The chip's readings of these set the upper ends of the limits
(``control.py``); the CPU tests hold each to ``correct`` false.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def _patched(module, name, make):
    real = getattr(module, name)
    setattr(module, name, make(real))
    try:
        yield
    finally:
        setattr(module, name, real)


def _halves(t, batch):
    v = t.view(-1, batch, t.shape[-1])
    h = batch // 2
    v[:, h:2 * h] = v[:, :h]
    return t


def state_unchanged():
    from generative_models_tpu_torch.ops import cuda_train

    def make(real):
        def chunk(xs, zd, zg, p, mu, nu, **kw):
            clone = (lambda pl: None if pl is None
                     else [t.clone() for t in pl])
            if kw.get("ema") is not None:
                kw["ema"] = clone(kw["ema"])
            return real(xs, zd, zg, clone(p), clone(mu), clone(nu), **kw)
        return chunk
    return _patched(cuda_train, "gan_chunk", make)


def half_batch_train():
    from generative_models_tpu_torch.ops import cuda_train

    def make(real):
        def chunk(xs, zd, zg, p, mu, nu, *, batch, **kw):
            return real(_halves(xs.clone(), batch), _halves(zd.clone(), batch),
                        _halves(zg.clone(), batch), p, mu, nu, batch=batch,
                        **kw)
        return chunk
    return _patched(cuda_train, "gan_chunk", make)


def step_unchanged():
    from generative_models_tpu_torch.losses import ddpm

    def make(real):
        def schedule(cfg):
            ts, ab, abp = real(cfg)
            # the middle step goes from abar_k to abar_k: its x0 and eps
            # give back the x it was given (where the clamp leaves x0),
            # and the next step starts from it at the next abar
            k = len(ts) // 2
            abp = abp.copy()
            abp[k] = ab[k]
            return ts, ab, abp
        return schedule
    return _patched(ddpm, "sample_schedule", make)


def answer_altered():
    from generative_models_tpu_torch.losses import ddpm

    def make(real):
        def sample(*a, **kw):
            out = real(*a, **kw)
            out[0] = out[1]
            return out
        return sample
    return _patched(ddpm, "_sample_with_labels", make)


def half_batch_gen():
    from generative_models_tpu_torch.losses import ddpm

    def make(real):
        def sample(params, gen, n, cfg, y, z=None, chain=None):
            h = n // 2
            out = real(params, gen, h, cfg, y, z[:h],
                       lambda i: chain(i)[:h])
            return torch.cat([out, out])
        return sample
    return _patched(ddpm, "_sample_with_labels", make)


FAULTS = {
    "train": {"state_unchanged": state_unchanged,
              "half_batch": half_batch_train},
    "generate": {"step_unchanged": step_unchanged,
                 "answer_altered": answer_altered,
                 "half_batch": half_batch_gen},
}


def control(cell):
    """(overrides, prepare) of the cell's control run (see the module's
    docstring)."""
    if cell.traffic["driver"] == "train":
        return {"dtype": "bfloat16", "fused_step": True}, None

    def prepare(s):
        ref = cell.reference

        def request(r):
            return ref.sample(s.w, s.noise.initial(r), s.noise.chain(r),
                              s.conf, s.conf["ddpm_sample_steps"],
                              tf32=True).cpu().numpy()
        s.request = request
    return {}, prepare
