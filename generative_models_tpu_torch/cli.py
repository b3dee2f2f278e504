"""CLI — ``python -m generative_models_tpu_torch --variant nsgan --steps
2000`` (or ``mmgan``, ``lsgan``, ``wgan``, ``fgan``, ``ragan``,
``fishergan``, ``vae``, ``birvae``): the port of
``generative_models_tpu/cli.py``.

Every Config field is a flag, as in the reference. A training run trains
(``--ckpt`` with ``--resume`` restores first), appends per-step records to
``<out_dir>/<variant>/metrics.jsonl``, prints the reference's final JSON
line ``{"variant", "steps", "wall_s", "steps_per_sec", "eval"}`` (``eval``
holds the variant's metrics: ``d_loss``, ``g_loss`` and the head's own
(``w_estimate``, ``f_bound``, ``ipm`` ...) for a GAN, ``loss``,
``recon_loss`` and ``kl_loss`` or ``latent_power`` for the VAE family), writes
``final.png`` and the loss plot, and with ``--ckpt`` saves and prints
``saved: <path>``. ``--sample-only`` loads a checkpoint written by either
package and writes a sample grid, printing ``{"variant", "step",
"samples"}``. The flags whose paths are not ported yet exit with a usage
error that names them. ``--device`` defaults to ``cuda``; ``cpu`` runs the
kernels' plain versions.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

from generative_models_tpu_torch.config import Config, VARIANTS, variant_config

# flag -> the ROADMAP.md item that ports its path
_NOT_PORTED = {
    "export_sampler": "Queue 1 item 11, quality scoring and outputs",
    "score_samples": "Queue 1 item 11, quality scoring and outputs",
    "reflow_from": "Queue 1 item 9, the diffusion family",
    "vq_from": "Queue 1 item 10, the VQ family",
    "multihost": "Queue 1 item 12, parallelism",
    "profile": "Queue 1 item 5, the GPU bench",
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="generative_models_tpu_torch",
        description="PyTorch/CUDA port of the generative-model zoo")
    p.add_argument("--variant", default="nsgan", choices=sorted(VARIANTS))
    # Every Config field becomes a flag; variant overrides apply first,
    # explicit flags win. The flag type comes from the field annotation.
    for f in dataclasses.fields(Config):
        if f.name == "variant":
            continue
        arg = "--" + f.name.replace("_", "-")
        ann = str(f.type)
        if "bool" in ann or isinstance(f.default, bool):
            p.add_argument(arg, dest=f.name, default=None,
                           action=argparse.BooleanOptionalAction)
        else:
            typ = int if "int" in ann else float if "float" in ann else str
            p.add_argument(arg, dest=f.name, default=None, type=typ)
    p.add_argument("--ckpt", default=None,
                   help="checkpoint path in the JAX package's npz layout "
                        "(save at end; with --resume, restore first)")
    p.add_argument("--sample-only", action="store_true",
                   help="no training: load --ckpt and write a sample grid")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; 'cpu' runs the "
                        "kernels' plain versions)")
    p.add_argument("--echo-every", type=int, default=100)
    p.add_argument("--export-sampler", default=None, metavar="PATH")
    p.add_argument("--score-samples", action="store_true")
    p.add_argument("--reflow-from", default=None, metavar="CKPT")
    p.add_argument("--vq-from", default=None, metavar="CKPT")
    p.add_argument("--multihost", action="store_true")
    return p


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    for name, item in _NOT_PORTED.items():
        if getattr(args, name):
            parser.error(f"--{name.replace('_', '-')} is not ported to "
                         f"generative_models_tpu_torch yet (ROADMAP.md {item})")
    overrides = {
        f.name: getattr(args, f.name)
        for f in dataclasses.fields(Config)
        if f.name != "variant" and getattr(args, f.name, None) is not None
    }
    cfg = variant_config(args.variant, **overrides)

    if not args.sample_only and (cfg.dp > 1 or cfg.tp > 1):
        parser.error("data- and tensor-parallel training (--dp/--tp > 1) "
                     "is not ported to generative_models_tpu_torch yet "
                     "(ROADMAP.md Queue 1 item 12, parallelism)")

    from generative_models_tpu_torch.train.trainer import Trainer
    from generative_models_tpu_torch.utils.checkpoint import exists
    t = Trainer(config=cfg, device=args.device)
    if args.sample_only:
        if not args.ckpt or not exists(args.ckpt):
            print("--sample-only needs an existing --ckpt", file=sys.stderr)
            return 2
        t.load_model(args.ckpt)
        step = t.state["step"]
        path = t.generate_images(tag=f"samples_step{step:06d}")
        print(json.dumps({"variant": cfg.variant, "step": step,
                          "samples": path}))
        return 0
    if args.ckpt and cfg.resume and exists(args.ckpt):
        t.load_model(args.ckpt)
        print(f"resumed from {args.ckpt} at step {t.state['step']}")

    run_dir = os.path.join(cfg.out_dir, cfg.variant)
    os.makedirs(run_dir, exist_ok=True)
    t.train(num_epochs=cfg.epochs,
            steps=None if cfg.epochs else cfg.steps,
            log_path=os.path.join(run_dir, "metrics.jsonl"),
            echo_every=args.echo_every,
            ckpt_path=args.ckpt)  # periodic when cfg.ckpt_every > 0
    sps = t.steps_done / t.wall_time
    eval_metrics = t.evaluate("test", max_batches=10)
    print(json.dumps({
        "variant": cfg.variant,
        "steps": t.steps_done,
        "wall_s": round(t.wall_time, 3),
        "steps_per_sec": round(sps, 2),
        "eval": {k: round(v, 4) for k, v in eval_metrics.items()},
    }))
    t.generate_images(tag="final")
    t.viz_loss()
    if args.ckpt:
        print("saved:", t.save_model(args.ckpt))
    return 0


if __name__ == "__main__":
    sys.exit(main())
