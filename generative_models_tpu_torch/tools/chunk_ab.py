"""Times the GAN chunk kernel of whichever checkout is first on the
import path, to compare two versions of it on one card in one session.

    PYTHONPATH=<checkout A> python3 <this file> A nsgan
    PYTHONPATH=<checkout B> python3 <this file> B nsgan ragan wgan:rmsprop vae
    PYTHONPATH=<checkout B> python3 <this file> B nsgan:adam:ema nsgan:bf16

Run the file by its path (not with ``-m``), so that the package comes
from ``PYTHONPATH`` and the same script times both: it speaks the
interface of every version of ``ops/cuda_train.py`` so far (the first,
nsgan and mmgan only, took a boolean where later ones take the variant).
Each argument after the tag is ``variant[:optimizer][:ema][:bf16]``
(``ema``: the EMA kernel at decay 0.999; ``bf16``: the bf16 library;
``vae`` and ``birvae`` time the VAE family's chunk kernel); wgan runs at
d_steps 5 with the clip, wgangp at d_steps 5 with the penalty's eps
stream (dragan: x_hat rows); cgan with its label lanes; infogan with its
codes on G's input and a
15-lane head, began with its 784-400-784 autoencoder critic (versions
without their hooks print "not in this version"). It first builds every
library the specs need, one nvcc each, all started together; then for
each spec it runs a 1000-step chunk at full width (B = 100) three times
to warm up and prints five CUDA-event timings in ms, then the builds'
ptxas lines on registers and spills. Alternate the checkouts (A B B A)
on one card in one command; compare nothing across commands, and expect
a few percent between allocations of the same binary. Needs a CUDA card and
nvcc. A whole A B B A comparison in one command:

    git archive <commit> generative_models_tpu_torch | tar -x -C build/parent
    for t in A B B A; do d=$([ $t = A ] && echo build/parent || echo .)
      PYTHONPATH=$d python3 generative_models_tpu_torch/tools/chunk_ab.py \
        $t nsgan nsgan:adam:ema nsgan:bf16 vae; done
"""

from __future__ import annotations

import glob
import os
import sys


def main(argv) -> int:
    import numpy as np
    import torch

    from generative_models_tpu_torch.ops import build, cuda_train as ct
    tag, specs = argv[0], argv[1:] or ["nsgan"]
    prebuild(ct, specs)
    b, steps = 100, 1000
    for spec in specs:
        variant, *opts = spec.split(":")
        optimizer = next((o for o in opts if o in ("adam", "rmsprop")),
                         "adam")
        new = {"ema_decay": 0.999} if "ema" in opts else {}
        if "bf16" in opts:
            new["dtype"] = "bfloat16"
        if new and "ema_decay" not in getattr(ct.ChunkHyper,
                                              "__dataclass_fields__", {}):
            print(f"AB {tag} {spec}: not in this version")
            continue
        if variant in ("vae", "birvae"):
            time_vae(tag, spec, variant, new, np, torch)
            continue
        ds = 5 if variant in ("wgan", "wgangp") else 1
        extra = {"infogan": dict(info_cat=10, info_cont=2, info_lam=1.0),
                 "began": dict(began_gamma=0.75, began_lambda_k=1e-3),
                 "cgan": dict(n_cls=10), "wgangp": dict(gp_lam=10.0),
                 "dragan": dict(gp_lam=10.0)}
        # the penalty's stream: wgangp's eps, dragan's x_hat rows
        lanes = {"wgangp": 1, "dragan": 784}.get(variant, 0)
        if hasattr(ct, "HOOKS") and variant in ct.HOOKS:
            hp = ct.ChunkHyper(2e-4, 2e-4, 0.5, 0.999, 1e-8, 0.2, variant,
                               optimizer, 0.01 if variant == "wgan" else 0.0,
                               fisher_rho=1e-6, **extra.get(variant, {}),
                               **new)
        elif (variant, optimizer) == ("nsgan", "adam"):
            hp = ct.ChunkHyper(2e-4, 2e-4, 0.5, 0.999, 1e-8, 0.2, False)
        else:
            print(f"AB {tag} {spec}: not in this version")
            continue
        rng = np.random.default_rng(6)
        # cgan's 10 label lanes on G's and D's inputs, infogan's 12 codes
        z = {"infogan": 140, "cgan": 138}.get(variant, 128)
        xd = 794 if variant == "cgan" else 784
        out = {"infogan": 15, "began": 784}.get(variant, 1)
        p = []
        for i, o in ((z, 400), (400, 784), (xd, 400), (400, out)):
            bound = 1.0 / np.sqrt(i)
            p += [rng.uniform(-bound, bound, (i, o)).astype(np.float32),
                  rng.uniform(-bound, bound, (o,)).astype(np.float32)]
        mu = [rng.normal(0, 1e-3, a.shape).astype(np.float32) for a in p]
        nu = [rng.uniform(0, 1e-5, a.shape).astype(np.float32) for a in p]
        planes = [[torch.from_numpy(a).cuda() for a in pl]
                  for pl in (p, mu, nu)]
        if optimizer != "adam":
            planes[1] = None
        xs = torch.rand(steps * ds * b, xd, device="cuda")
        zd = torch.randn(steps * ds * b, z, device="cuda")
        zg = torch.randn(steps * b, z, device="cuda")
        more = ({"xtra": torch.rand(steps * ds * b, lanes, device="cuda")}
                if lanes else {})
        if new.get("ema_decay"):
            more["ema"] = [t.clone() for t in planes[0][:4]]
        run = lambda: ct.gan_chunk(xs, zd, zg, *planes, steps=steps, ds=ds,
                                   batch=b, t_g=0, t_d=0, hp=hp, **more)
        report(tag, spec, run, torch)
    for log in sorted(glob.glob(os.path.join(build.BUILD_DIR,
                                             "*_chunk*.log"))):
        with open(log) as f:
            for line in f:
                if "registers" in line or "bytes spill" in line:
                    print(f"  {tag} {os.path.basename(log)[:20]} "
                          f"{line.strip()[:110]}")
    return 0


def prebuild(ct, specs):
    """Every library the specs time, one nvcc each, all at once (versions
    since the bf16 libraries; older ones build at first use)."""
    import concurrent.futures
    from generative_models_tpu_torch.ops import cuda_train_vae as ctv
    if "bf16" not in getattr(ct.ChunkHyper, "__dataclass_fields__", {}) and \
            not hasattr(ct, "compute_dtype"):
        return
    builds = set()
    for spec in specs:
        variant, *opts = spec.split(":")
        bf16 = "bf16" in opts
        if variant in ("vae", "birvae"):
            builds.add(("vae", bf16))
        elif variant in getattr(ct, "HOOKS", {}):
            builds.add((ct.HOOKS[variant], bf16))

    def one(b):
        hook, bf16 = b
        if hook == "vae":
            ctv.build(bf16)
        else:
            ct.build(hook, bf16)

    with concurrent.futures.ThreadPoolExecutor(max(len(builds), 1)) as ex:
        list(ex.map(one, sorted(builds)))


def report(tag, spec, run, torch):
    """Three warm-up runs, then five CUDA-event timings in ms."""
    for _ in range(3):
        run()
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        run()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    print(f"AB {tag} {spec}: " + " ".join(f"{t:.2f}" for t in times),
          flush=True)


def time_vae(tag, spec, variant, new, np, torch):
    """The VAE (bce) or BIR-VAE (mse) chunk kernel, 1000 steps at full
    width (784-400-20), B = 100; `new` the EMA and bf16 fields."""
    from generative_models_tpu_torch.ops import cuda_train_vae as ctv
    birvae = variant == "birvae"
    b, steps, x, h, l = 100, 1000, 784, 400, 20
    hp = ctv.VaeHyper(1e-3, 0.9, 0.999, 1e-8, "mse" if birvae else "bce",
                      0.1 if birvae else 0.0, **new)
    rng = np.random.default_rng(6)
    dims = [(x, h), (h, l)] + ([] if birvae else [(h, l)]) + [(l, h), (h, x)]
    p = []
    for i, o in dims:
        bound = 1.0 / np.sqrt(i)
        p += [rng.uniform(-bound, bound, (i, o)).astype(np.float32),
              rng.uniform(-bound, bound, (o,)).astype(np.float32)]
    planes = [[torch.from_numpy(a).cuda() for a in p]]
    planes += [[torch.zeros_like(t) for t in planes[0]] for _ in range(2)]
    more = ({"ema": [t.clone() for t in planes[0]]}
            if new.get("ema_decay") else {})
    xs = torch.rand(steps * b, x, device="cuda")
    es = torch.randn(steps * b, l, device="cuda")
    chunk = ctv.birvae_chunk if birvae else ctv.vae_chunk
    report(tag, spec, lambda: chunk(xs, es, *planes, steps=steps, batch=b,
                                    t=0, hp=hp, **more), torch)


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
