"""CLI — ``python -m generative_models_tpu_torch --variant nsgan --ckpt
runs/n.npz --sample-only``: the port of ``generative_models_tpu/cli.py``,
serving path only.

Every Config field is a flag, as in the reference. ``--sample-only``
loads a checkpoint written by the JAX package and writes a sample grid,
printing ``{"variant", "step", "samples"}``. Training and the flags whose
paths are not ported yet exit with a usage error that names them.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

from generative_models_tpu_torch.config import Config, VARIANTS, variant_config

# flag -> the ROADMAP.md item that ports its path
_NOT_PORTED = {
    "export_sampler": "Queue 1 item 11, quality scoring and outputs",
    "score_samples": "Queue 1 item 11, quality scoring and outputs",
    "reflow_from": "Queue 1 item 9, the diffusion family",
    "vq_from": "Queue 1 item 10, the VQ family",
    "multihost": "Queue 1 item 12, parallelism",
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="generative_models_tpu_torch",
        description="PyTorch/CUDA port of the generative-model zoo "
                    "(serving path)")
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
                   help="checkpoint written by the JAX package (npz layout)")
    p.add_argument("--sample-only", action="store_true",
                   help="no training: load --ckpt and write a sample grid")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; 'cpu' runs the "
                        "kernels' plain versions)")
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
    if not args.sample_only:
        parser.error("training is not ported to generative_models_tpu_torch "
                     "yet (ROADMAP.md Queue 1 items 2-4); only --sample-only "
                     "runs")
    overrides = {
        f.name: getattr(args, f.name)
        for f in dataclasses.fields(Config)
        if f.name != "variant" and getattr(args, f.name, None) is not None
    }
    cfg = variant_config(args.variant, **overrides)

    from generative_models_tpu_torch.train.trainer import Trainer
    from generative_models_tpu_torch.utils.checkpoint import exists
    if not args.ckpt or not exists(args.ckpt):
        print("--sample-only needs an existing --ckpt", file=sys.stderr)
        return 2
    t = Trainer(config=cfg, device=args.device)
    t.load_model(args.ckpt)
    step = t.state["step"]
    path = t.generate_images(tag=f"samples_step{step:06d}")
    print(json.dumps({"variant": cfg.variant, "step": step, "samples": path}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
