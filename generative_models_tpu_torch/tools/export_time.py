"""Seconds ``utils/export.py::export_sampler`` takes to trace and
serialise a full-width sampler (config.py's defaults) on the host:

    python3 -m generative_models_tpu_torch.tools.export_time \
        ddpm flow ddpm:ddpm_sample_steps=50 flow:arch=conv

Each spec is ``variant[:field=value,...]``; the weights are a fresh
init's (export time does not depend on them). Prints one JSON line a
spec: the variant, its overrides, the net calls traced, the seconds and
the artifact's bytes.
"""

from __future__ import annotations

import json
import sys
import time


def parse(spec: str):
    variant, _, rest = spec.partition(":")
    kw = {}
    for item in filter(None, rest.split(",")):
        key, _, value = item.partition("=")
        kw[key] = int(value) if value.lstrip("-").isdigit() else value
    return variant, kw


def main(argv) -> int:
    from generative_models_tpu_torch.train.trainer import Trainer
    from generative_models_tpu_torch.utils import export
    for spec in argv or ["ddpm", "flow"]:
        variant, kw = parse(spec)
        t = Trainer(variant, device="cpu", **kw)
        cfg = t.cfg
        calls = (cfg.ddpm_sample_steps or cfg.ddpm_timesteps
                 if variant == "ddpm" else cfg.flow_sample_steps
                 * (2 if cfg.flow_solver == "heun" else 1))
        t0 = time.perf_counter()
        art = export.export_sampler(t.spec, cfg, t.generator_params,
                                    cfg.sample_n)
        print(json.dumps({"variant": variant, "overrides": kw,
                          "net_calls": calls, "sample_n": cfg.sample_n,
                          "seconds": time.perf_counter() - t0,
                          "bytes": len(art)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
