"""The benchmark of ``generative_models_tpu_torch``, the PyTorch and CUDA
port, on NVIDIA GPUs.

    python3 gpubench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. It finds the cell in ``BENCHMARK.json`` and
its files by name (``harness/cells.py``), makes the cell's inputs and
weights from the seed, warms up the cell's shapes, measures for
``--seconds``, checks what the timed path produced against the plain
reference, and prints one JSON line last on standard output:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics; with ``--trace 1`` its per-layer metrics, from a
profiled slice after the window), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared beside its
limit, which also end standard error.

It exits with another code than 0, printing no result, where no CUDA
card is present or fewer than the cell asks for, and where ``jax``,
``jaxlib``, ``flax`` or the JAX package is loaded once the window has
closed. The program's build and kernel caches are kept at fixed paths
under ``build/`` inside the checkout, so that only a checkout's first run
builds and compiles.
"""

import time

T_START = time.perf_counter()  # the process's start, for setup_s

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CACHE = os.path.join(ROOT, "build", "gpubench")
# compared by whole top-level names: generative_models_tpu_torch passes
FORBIDDEN = ("jax", "jaxlib", "flax", "generative_models_tpu")


def set_environment() -> None:
    """Caches at fixed paths inside the checkout, and no JAX loaded by a
    library on its own."""
    os.environ["GMTPU_POLICY_CACHE"] = os.path.join(CACHE, "fused_auto.json")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(CACHE, "nv_compute")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    os.makedirs(CACHE, exist_ok=True)


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    set_environment()
    sys.path[:0] = [HERE, ROOT]
    import torch
    from harness import cells, runner
    cell = cells.resolve(args.workload, ROOT)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"gpubench: {args.workload} needs {cell.chips} CUDA card(s); "
              f"torch sees {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    out = runner.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                          "cuda", T_START)
    bad = forbidden_modules()
    if bad:
        print(f"gpubench: the run loaded {bad}, which the port must not use",
              file=sys.stderr)
        return 4
    runner.print_result(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
