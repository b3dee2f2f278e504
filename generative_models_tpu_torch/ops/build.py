"""Builds the port's CUDA sources into shared libraries, at first use.

Each library is compiled with ``nvcc`` for Hopper (``sm_90a``) from the
sources under ``generative_models_tpu_torch/csrc/`` into
``build/torch_kernels/`` at the repository root, and loaded with
``ctypes``. The sources expose a plain C interface, so no PyTorch header
is compiled and a build takes seconds. A library is named after a hash
of its sources and flags, so an edited source builds anew and an
unchanged one is reused. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(PKG_DIR), "build", "torch_kernels")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def find_nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME:
        path = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(path):
            return path
    path = shutil.which("nvcc")
    if path is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME or put nvcc on PATH): the "
            "port's CUDA kernels are compiled at first use")
    return path


def build_library(name: str, sources, headers=(), flags=()) -> ctypes.CDLL:
    """Compile `sources` (file names under csrc/) into lib<name>-<hash>.so
    unless it exists, and load it; `headers` are the csrc/ files the
    sources include, hashed with them; `flags` are further nvcc flags
    (a source built more than once, a ``-D`` each). Writes the compiler's output (the
    ptxas register and shared-memory report) beside the library."""
    paths = [os.path.join(CSRC_DIR, s) for s in sources]
    h = hashlib.sha256(" ".join(NVCC_FLAGS + tuple(flags)).encode())
    for p in paths + [os.path.join(CSRC_DIR, s) for s in headers]:
        with open(p, "rb") as f:
            h.update(f.read())
    os.makedirs(BUILD_DIR, exist_ok=True)
    lib = os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")
    if not os.path.exists(lib):
        tmp = f"{lib}.{os.getpid()}.tmp"
        cmd = [find_nvcc(), *NVCC_FLAGS, *flags, "-I", CSRC_DIR, "-o", tmp,
               *paths]
        r = subprocess.run(cmd, capture_output=True, text=True)
        with open(lib[:-3] + ".log", "w") as f:
            f.write(" ".join(cmd) + "\n" + r.stdout + r.stderr)
        if r.returncode != 0:
            raise RuntimeError(
                f"nvcc failed building {name} (rc {r.returncode}):\n"
                f"{r.stdout}{r.stderr}")
        os.replace(tmp, lib)  # atomic: a concurrent build loads a whole file
    return ctypes.CDLL(lib)
