"""The readings that set the limits of a cell's check, on the card at the
cell's own size, in one process (the libraries build once):

    python3 gpubench/control.py --workload <cell> --seeds 11,12,... \
        [--modes program,control,<fault>,...] [--seconds 3]

``program``: the program as the configuration states it (the lower
reading is the largest of its numbers over the seeds); ``control``: the
nearest precision below (``harness/faults.py``); each fault of the
cell's driver: a run with that fault planted underneath the timed path.
Each run is a whole run of the cell (set-up, a short window at the
cell's load, the check) with its numbers printed as one JSON line
``{"mode", "seed", "correct", "checks", "detail"}`` (``detail``: what the
driver read beside the numbers it limits); the last line gives each
mode's least and largest reading of each number.
"""

import argparse
import contextlib
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--modes", default="program,control")
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    sys.path[:0] = [HERE, ROOT]
    import run
    run.set_environment()
    import torch
    from harness import cells, faults, runner
    cell = cells.resolve(args.workload, ROOT)
    if not torch.cuda.is_available():
        print("control.py: no CUDA card", file=sys.stderr)
        return 3
    table = {}
    for mode in args.modes.split(","):
        over, prep = {}, None
        planted = contextlib.nullcontext
        if mode == "control":
            over, prep = faults.control(cell)
        elif mode != "program":
            planted = faults.FAULTS[cell.traffic["driver"]][mode]
        for seed in (int(s) for s in args.seeds.split(",")):
            t0 = time.perf_counter()
            seen = []

            def keep(s, prep=prep):
                seen.append(s)
                if prep is not None:
                    prep(s)
            with planted():
                out = runner.run_cell(cell, seed, args.seconds, False, "cuda",
                                      t0, over, keep)
            checks = {k: c["value"] for k, c in out["checks"].items()}
            print(json.dumps({"mode": mode, "seed": seed,
                              "correct": out["correct"], "checks": checks,
                              "detail": getattr(seen[0], "detail", None),
                              "seconds": time.perf_counter() - t0}),
                  flush=True)
            for k, v in checks.items():
                lo, hi = table.setdefault(mode, {}).get(k, (v, v))
                table[mode][k] = (min(lo, v), max(hi, v))
    print(json.dumps({"readings": table,
                      "device": torch.cuda.get_device_name(0),
                      "power_limit_w": runner.power_limit_w()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
