"""Rules the PyTorch port keeps: it never loads JAX or the JAX package,
its entry points run on the card unless asked for the CPU, and its
kernel modules build nothing until a CUDA tensor reaches them."""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from generative_models_tpu_torch.ops import build, cuda_mlp
from generative_models_tpu_torch.train import trainer as trainer_mod

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "generative_models_tpu_torch")


def _port_sources():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, dirs, files in os.walk(PORT):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return out


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import importlib, pkgutil, sys\n"
        "import generative_models_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'generative_models_tpu'"
        " or m.startswith('generative_models_tpu.')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr


def test_no_source_line_imports_jax():
    pat = re.compile(r"^\s*(import|from)\s+(jax|generative_models_tpu)\b",
                     re.M)
    hits = []
    for path in _port_sources():
        with open(path) as f:
            hits += [f"{path}: {m.group(0)}" for m in pat.finditer(f.read())]
    assert not hits


def test_trainer_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trainer_mod.Trainer("nsgan")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trainer_mod.resolve_device("cuda:0")
    assert trainer_mod.resolve_device("cpu") == torch.device("cpu")


def test_cli_defaults_to_cuda_and_raises_without_it(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from generative_models_tpu_torch import cli
    path = tmp_path / "ck.npz"
    path.write_bytes(b"")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--variant", "nsgan", "--ckpt", str(path),
                  "--sample-only"])


def test_kernel_module_imports_and_runs_on_cpu_without_building():
    code = (
        "import sys, torch\n"
        "from generative_models_tpu_torch.ops import cuda_mlp\n"
        "x = torch.ones(3, 4); w = torch.ones(4, 2); b = torch.zeros(2)\n"
        "out, hid = cuda_mlp.mlp_fwd(x, [w], [b], ('relu',))\n"
        "assert out.shape == (3, 2) and hid == []\n"
        "assert cuda_mlp.launches == 0\n"
        "assert 'generative_models_tpu_torch.ops.build' not in sys.modules\n"
        "assert cuda_mlp._lib.cache_info().currsize == 0\n"
        "print('ok')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr


def test_wrapper_refuses_devices_it_has_no_path_for():
    x = torch.empty(3, 4, device="meta")
    w = torch.empty(4, 2, device="meta")
    b = torch.empty(2, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        cuda_mlp.mlp_fwd(x, [w], [b], ("relu",))


def test_cpu_calls_do_not_count_as_launches():
    before = cuda_mlp.launches
    x = torch.from_numpy(np.ones((2, 3), np.float32))
    cuda_mlp.mlp_fwd(x, [torch.ones(3, 5)], [torch.ones(5)], ("tanh",))
    assert cuda_mlp.launches == before


def test_build_without_nvcc_raises(monkeypatch):
    import torch.utils.cpp_extension as ext
    monkeypatch.setattr(ext, "CUDA_HOME", None)
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.find_nvcc()


def test_build_targets_hopper_into_the_ignored_build_dir():
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    assert build.BUILD_DIR == os.path.join(REPO, "build", "torch_kernels")
    assert os.path.exists(os.path.join(build.CSRC_DIR, "mlp_fwd.cu"))


def test_training_kernel_modules_import_and_run_on_cpu_without_building():
    code = (
        "import sys, torch\n"
        "from generative_models_tpu_torch.ops import cuda_mlp, cuda_train\n"
        "x = torch.ones(3, 4); w = torch.ones(4, 2); b = torch.zeros(2)\n"
        "out, hid = cuda_mlp.mlp_fwd(x, [w], [b], ('relu',))\n"
        "dws, dbs, dx = cuda_mlp.mlp_bwd(x, hid, out, torch.ones(3, 2), [w],"
        " ('relu',))\n"
        "assert dx.shape == (3, 4) and dws[0].shape == (4, 2)\n"
        "p = [torch.zeros(s) for s in ((2, 3), (3,), (3, 5), (5,), (5, 3),"
        " (3,), (3, 1), (1,))]\n"
        "mu = [torch.zeros_like(t) for t in p]\n"
        "nu = [torch.zeros_like(t) for t in p]\n"
        "hp = cuda_train.ChunkHyper(1e-3, 1e-3, 0.5, 0.999, 1e-8, 0.2, 'nsgan')\n"
        "m = cuda_train.gan_chunk(torch.rand(4, 5), torch.randn(4, 2),"
        " torch.randn(4, 2), p, mu, nu, steps=2, ds=1, batch=2, t_g=0,"
        " t_d=0, hp=hp)\n"
        "assert m.shape == (2, 8) and bool(torch.isfinite(m).all())\n"
        "assert cuda_mlp.bwd_launches == 0 and cuda_train.launches == 0\n"
        "assert 'generative_models_tpu_torch.ops.build' not in sys.modules\n"
        "assert cuda_mlp._bwd_lib.cache_info().currsize == 0\n"
        "assert cuda_train._lib.cache_info().currsize == 0\n"
        "print('ok')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr


def test_kernel_forward_refuses_inputs_that_need_a_graph():
    """Off the CPU, mlp_fwd's outputs carry no autograd graph: an input
    that requires grad under grad mode raises (a meta tensor stands in
    for a CUDA one); MLPFunction is the path that trains."""
    x = torch.empty(3, 4, device="meta", requires_grad=True)
    w = torch.empty(4, 2, device="meta")
    b = torch.empty(2, device="meta")
    with pytest.raises(RuntimeError, match="MLPFunction"):
        cuda_mlp.mlp_fwd(x, [w], [b], ("relu",))
    with pytest.raises(RuntimeError, match="MLPFunction"):
        cuda_mlp.mlp_fwd(x.detach(), [w.requires_grad_(True)], [b],
                         ("relu",))
    with torch.no_grad(), pytest.raises(ValueError, match="cuda or cpu"):
        cuda_mlp.mlp_fwd(x, [w], [b], ("relu",))


def test_training_wrappers_refuse_devices_they_have_no_path_for():
    from generative_models_tpu_torch.ops import cuda_train
    meta = lambda *s: torch.empty(s, device="meta")
    x, w = meta(3, 4), meta(4, 2)
    with pytest.raises(ValueError, match="cuda or cpu"):
        cuda_mlp.mlp_bwd(x, [], meta(3, 2), meta(3, 2), [w], ("relu",))
    p = [meta(*s) for s in ((2, 3), (3,), (3, 5), (5,), (5, 3), (3,),
                            (3, 1), (1,))]
    hp = cuda_train.ChunkHyper(1e-3, 1e-3, 0.5, 0.999, 1e-8, 0.2, "nsgan")
    with pytest.raises(ValueError, match="cuda or cpu"):
        cuda_train.gan_chunk(meta(4, 5), meta(4, 2), meta(4, 2), p, p, p,
                             steps=2, ds=1, batch=2, t_g=0, t_d=0, hp=hp)


def test_fused_step_auto_trains_the_general_step_on_cpu(monkeypatch,
                                                        tiny_data):
    from generative_models_tpu_torch.ops import cuda_train

    def no_chunk(*a, **k):
        raise AssertionError("the chunk ran on the CPU under 'auto'")
    monkeypatch.setattr(cuda_train, "gan_chunk", no_chunk)
    t = trainer_mod.Trainer("nsgan", device="cpu", data=tiny_data,
                            batch_size=16, hidden_dim=32, z_dim=8,
                            scan_steps=2)
    assert t.cfg.fused_step == "auto"
    t.train(steps=2)
    assert t.state["step"] == 2


def test_training_sources_ship_with_the_package():
    for src in ("mlp_bwd.cu", "gan_chunk.cu", "reparam.cu", "vae_chunk.cu",
                "chunk_common.cuh"):
        assert os.path.exists(os.path.join(build.CSRC_DIR, src))
    with open(os.path.join(REPO, "pyproject.toml")) as f:
        assert "csrc/*.cuh" in f.read()
    for src in ("gan_chunk.cu", "vae_chunk.cu"):   # the header they share
        with open(os.path.join(build.CSRC_DIR, src)) as f:
            assert '#include "chunk_common.cuh"' in f.read()


def test_vae_kernel_modules_import_and_run_on_cpu_without_building():
    code = (
        "import sys, torch\n"
        "from generative_models_tpu_torch.ops import cuda_reparam,"
        " cuda_train_vae\n"
        "from generative_models_tpu_torch.ops.reparam import reparam_and_kl\n"
        "mu = torch.zeros(3, 5); lv = torch.zeros(3, 5)\n"
        "z, kl = cuda_reparam.reparam_fwd(mu, lv, (1, 2))\n"
        "assert z.shape == (3, 5) and kl.shape == (3,)\n"
        "z, kl = reparam_and_kl(mu, lv, torch.Generator().manual_seed(0))\n"
        "assert bool(torch.isfinite(z).all()) and float(kl.abs().max()) == 0\n"
        "hp = cuda_train_vae.VaeHyper(1e-3, 0.5, 0.999, 1e-8)\n"
        "shapes = ((5, 3), (3,), (3, 2), (2,), (3, 2), (2,), (2, 3), (3,),"
        " (3, 5), (5,))\n"
        "for fn, idx in ((cuda_train_vae.vae_chunk, range(10)),"
        " (cuda_train_vae.birvae_chunk, (0, 1, 2, 3, 6, 7, 8, 9))):\n"
        "    p = [torch.full(shapes[i], 0.1) for i in idx]\n"
        "    mu_ = [torch.zeros_like(t) for t in p]\n"
        "    nu_ = [torch.zeros_like(t) for t in p]\n"
        "    m = fn(torch.rand(4, 5), torch.randn(4, 2), p, mu_, nu_,"
        " steps=2, batch=2, t=0, hp=hp)\n"
        "    assert m.shape == (2, 3) and bool(torch.isfinite(m).all())\n"
        "assert cuda_reparam.launches == 0\n"
        "assert cuda_train_vae.launches == 0\n"
        "assert cuda_train_vae.birvae_launches == 0\n"
        "assert 'generative_models_tpu_torch.ops.build' not in sys.modules\n"
        "assert cuda_reparam._lib.cache_info().currsize == 0\n"
        "assert cuda_train_vae._lib.cache_info().currsize == 0\n"
        "print('ok')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr


def test_vae_wrappers_refuse_devices_they_have_no_path_for():
    from generative_models_tpu_torch.ops import cuda_reparam, cuda_train_vae
    meta = lambda *s: torch.empty(s, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        cuda_reparam.reparam_fwd(meta(3, 5), meta(3, 5), (1, 2))
    shapes = ((5, 3), (3,), (3, 2), (2,), (3, 2), (2,), (2, 3), (3,), (3, 5),
              (5,))
    hp = cuda_train_vae.VaeHyper(1e-3, 0.5, 0.999, 1e-8)
    p = [meta(*s) for s in shapes]
    with pytest.raises(ValueError, match="cuda or cpu"):
        cuda_train_vae.vae_chunk(meta(4, 5), meta(4, 2), p, p, p, steps=2,
                                 batch=2, t=0, hp=hp)
    q = p[:4] + p[6:]
    with pytest.raises(ValueError, match="cuda or cpu"):
        cuda_train_vae.birvae_chunk(meta(4, 5), meta(4, 2), q, q, q, steps=2,
                                    batch=2, t=0, hp=hp)


@pytest.mark.parametrize("variant", ["vae", "birvae"])
def test_vae_trainer_defaults_to_cuda_and_auto_is_the_general_step_on_cpu(
        monkeypatch, tiny_data, variant):
    from generative_models_tpu_torch.ops import cuda_train_vae
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trainer_mod.Trainer(variant)

    def no_chunk(*a, **k):
        raise AssertionError("the chunk ran on the CPU under 'auto'")
    monkeypatch.setattr(cuda_train_vae, "vae_chunk", no_chunk)
    monkeypatch.setattr(cuda_train_vae, "birvae_chunk", no_chunk)
    t = trainer_mod.Trainer(variant, device="cpu", data=tiny_data,
                            batch_size=16, vae_hidden_dim=32, latent_dim=4,
                            scan_steps=2)
    assert t.cfg.fused_step == "auto"
    t.train(steps=2)
    assert t.state["step"] == 2


@pytest.mark.parametrize("variant,optimizer", [
    ("lsgan", "adam"), ("wgan", "rmsprop"), ("fgan", "adam"),
    ("ragan", "adam"), ("fishergan", "adam"), ("ragan", "rmsprop")])
def test_new_chunk_variants_run_on_cpu_without_building(variant, optimizer):
    """A CPU tensor takes the plain version: no launch is counted and no
    library is built or loaded, for every hook and both optimizers."""
    from generative_models_tpu_torch.ops import cuda_train
    p = [torch.full(s, 0.01) for s in ((2, 3), (3,), (3, 5), (5,), (5, 3),
                                       (3,), (3, 1), (1,))]
    mu = [torch.zeros_like(t) for t in p] if optimizer == "adam" else None
    nu = [torch.zeros_like(t) for t in p]
    hp = cuda_train.ChunkHyper(1e-3, 1e-3, 0.5, 0.999, 1e-8, 0.2, variant,
                               optimizer, 0.01 if variant == "wgan" else 0.0,
                               fisher_rho=1e-2)
    before = cuda_train.launches
    m = cuda_train.gan_chunk(torch.rand(4, 5), torch.randn(4, 2),
                             torch.randn(4, 2), p, mu, nu, steps=2, ds=1,
                             batch=2, t_g=0, t_d=0, hp=hp, lam=0.5)
    assert m.shape == (2, 8) and bool(torch.isfinite(m).all())
    assert cuda_train.launches == before
    assert cuda_train._lib.cache_info().currsize == 0
    assert (float(m[-1, 7]) != 0.0) == (variant == "fishergan")


def test_chunk_hooks_cover_the_ported_variants_and_refuse_the_rest():
    from generative_models_tpu_torch.ops import cuda_train
    assert set(cuda_train.HOOKS) == {"nsgan", "mmgan", "lsgan", "wgan",
                                     "fgan", "ragan", "fishergan"}
    assert set(cuda_train.HOOKS.values()) == set(cuda_train.HOOK_IDS)
    assert sorted(cuda_train.HOOK_IDS.values()) == list(range(6))
    with open(os.path.join(build.CSRC_DIR, "gan_chunk.cu")) as f:
        src = f.read()
    assert "GM_HOOK" in src and "--use_fast_math" not in " ".join(
        build.NVCC_FLAGS)
    for bad in ("wgangp", "began"):
        with pytest.raises(ValueError, match="gan_chunk covers"):
            cuda_train.ChunkHyper(1e-3, 1e-3, 0.5, 0.999, 1e-8, 0.2, bad)
    with pytest.raises(ValueError, match="unknown optimizer"):
        cuda_train.ChunkHyper(1e-3, 1e-3, 0.5, 0.999, 1e-8, 0.2, "wgan",
                              "sgd")


def test_rmsprop_chunk_state_has_no_mu_plane():
    from generative_models_tpu_torch.ops import cuda_train
    meta = lambda *s: torch.empty(s, device="meta")
    p = [meta(*s) for s in ((2, 3), (3,), (3, 5), (5,), (5, 3), (3,),
                            (3, 1), (1,))]
    hp = cuda_train.ChunkHyper(1e-3, 1e-3, 0.5, 0.999, 1e-8, 0.2, "wgan",
                               "rmsprop", 0.01)
    kw = dict(steps=2, ds=1, batch=2, t_g=0, t_d=0, hp=hp)
    with pytest.raises(ValueError, match="no mu plane"):
        cuda_train.gan_chunk(meta(4, 5), meta(4, 2), meta(4, 2), p, p, p, **kw)
    with pytest.raises(ValueError, match="cuda or cpu"):  # never the plain
        cuda_train.gan_chunk(meta(4, 5), meta(4, 2), meta(4, 2), p, None, p,
                             **kw)


def test_building_a_hook_library_without_nvcc_raises(monkeypatch):
    import torch.utils.cpp_extension as ext
    from generative_models_tpu_torch.ops import cuda_train
    monkeypatch.setattr(ext, "CUDA_HOME", None)
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setattr(build, "BUILD_DIR", os.path.join(
        build.BUILD_DIR, "never_built"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_train.build("ra")
    cuda_train._lib.cache_clear()
