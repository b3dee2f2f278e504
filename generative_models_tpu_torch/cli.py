"""CLI — ``python -m generative_models_tpu_torch --variant nsgan --steps
2000`` (or ``mmgan``, ``lsgan``, ``wgan``, ``fgan``, ``ragan``,
``fishergan``, ``wgangp``, ``dragan``, ``cgan``, ``began``, ``infogan``,
``vae``, ``birvae``, ``ddpm``, ``flow``, ``vqvae``, ``vqprior``; any of
them on the MLP stacks, the default, or with ``--arch conv`` on the conv
stacks of ``models/conv.py`` (ddpm and flow: the UNet of
``models/ddpm_net.py``; the VQ family: ``models/vq_net.py``), which
train through the general step): the port of
``generative_models_tpu/cli.py``. ``--reflow-from CKPT`` (flow only)
trains a 2-rectified flow on couplings of the teacher's ODE
(``train/reflow.py``; ``--reflow-pairs``, ``--reflow-gen-steps``,
``--reflow-gen-solver``, ``--reflow-fresh-init``), and ``--vq-from
CKPT`` (vqprior only) trains the prior on a frozen vqvae tokenizer
(``train/vq.py``), as the reference's.

Every Config field is a flag, as in the reference. A training run trains
(``--ckpt`` with ``--resume`` restores first), appends per-step records to
``<out_dir>/<variant>/metrics.jsonl``, prints the reference's final JSON
line ``{"variant", "steps", "wall_s", "steps_per_sec", "eval"}`` (``eval``
holds the variant's metrics: ``d_loss``, ``g_loss`` and the head's own
(``w_estimate``, ``f_bound``, ``ipm``, ``gp``, ``grad_norm`` ...) for a
GAN, ``loss``,
``recon_loss`` and ``kl_loss`` or ``latent_power`` for the VAE family), writes
``final.png`` and the loss plot, and with ``--ckpt`` saves and prints
``saved: <path>``. ``--dp N`` trains data-parallel: N ranks
(``parallel/mesh.py::run_ranks``), one a card over NCCL, or with
``--device cpu`` N gloo ranks on the CPU; ``--batch-size`` stays the
global batch, ``--fused-step`` takes the phase kernels
(``ops/cuda_dp.py``) and ``--dp-impl`` either value the general DP step
(``parallel/dp.py``); rank 0 alone writes and prints. ``--tp N`` (with
``--dp M``, default 1) trains tensor-parallel: M x N ranks on a grid
(``parallel/mesh.py::make_grid``, ``parallel/tp.py``), one a card, each
holding its shard of every sharded layer; ``--fused-step`` is refused
with it. ``--multihost`` joins a group whose ranks the caller started,
one process each, from ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
``MASTER_PORT`` and ``LOCAL_RANK`` (``parallel/multihost.py``); the
grid dp x tp must have ``WORLD_SIZE`` ranks, every process prints its
lines and writes its metrics and images under its ``--out-dir``, and
rank 0 saves. ``--sample-only`` loads a checkpoint written by either
package and writes a sample grid (cgan's cycles the classes: row i has
label i % num_classes), printing ``{"variant", "step", "samples"}``.
``--score-samples`` trains the quality scorer's classifier on the train
split after training (``utils/quality.py``) and prints the reference's
line ``{"classifier_test_acc", "confidence", "class_entropy",
"is_score", "fid"}``; ``--export-sampler PATH`` writes the sampler as a
``torch.export`` program after the checkpoint (``utils/export.py``; with
``--sample-only``, from the loaded one); ``--debug-nans`` turns on
autograd's anomaly mode and checks every chunk's metrics and the state
for finite values, raising ``FloatingPointError`` at the first step that
is not. The flags whose paths are not ported yet exit with a usage
error that names them (none is left). ``--profile`` traces training with
``torch.profiler`` (the host, and the card's kernels on CUDA) and writes
a Chrome trace, ``<out_dir>/<variant>/trace/rank<r>.pt.trace.json``, one
a rank, printing ``trace: <path>``, which holds the Trainer's phases as
``gmt.<span>`` ranges (``utils/spans.py``), and ``spans: <json>``, each
phase's count and total, self and longest host ms; ``--ckpt-backend orbax``
saves and resumes a directory checkpoint (``utils/dcp_ckpt.py``).
``--device`` defaults to ``cuda``; ``cpu`` runs the kernels' plain
versions.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys

from generative_models_tpu_torch.config import Config, VARIANTS, variant_config

# flag -> the ROADMAP.md item that ports its path (every flag is ported)
_NOT_PORTED: dict = {}


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
                   help="checkpoint path: the JAX package's npz layout, or "
                        "with --ckpt-backend orbax a directory (save at end; "
                        "with --resume, restore first)")
    p.add_argument("--sample-only", action="store_true",
                   help="no training: load --ckpt and write a sample grid")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; 'cpu' runs the "
                        "kernels' plain versions)")
    p.add_argument("--echo-every", type=int, default=100)
    p.add_argument("--debug-nans", action="store_true",
                   help="autograd's anomaly mode, and every chunk's metrics "
                        "and the state checked for finite values: raise "
                        "FloatingPointError at the first step that is not")
    p.add_argument("--score-samples", action="store_true",
                   help="train a held-out classifier and report IS-style "
                        "sample-quality scores and FID at the end")
    p.add_argument("--export-sampler", default=None, metavar="PATH",
                   help="after training (or from --ckpt with "
                        "--sample-only), save the sampler as a torch.export "
                        "program: seed -> [sample_n, 784] images, the "
                        "parameters baked in, loadable with torch alone")
    p.add_argument("--reflow-from", default=None, metavar="CKPT",
                   help="flow only: reflow / 2-rectified flow. Load a "
                        "trained flow checkpoint as the teacher, generate "
                        "(noise, sample) couplings from its ODE and train "
                        "this run on them (sets --flow-reflow; the student "
                        "starts at the teacher's weights unless "
                        "--reflow-fresh-init)")
    p.add_argument("--reflow-pairs", type=int, default=60000,
                   help="teacher couplings for the train split (plus 2048 "
                        "held-out test pairs)")
    p.add_argument("--reflow-fresh-init", action="store_true",
                   help="random-init the student instead of starting from "
                        "the teacher's weights")
    p.add_argument("--reflow-gen-steps", type=int, default=50,
                   help="teacher ODE steps when generating couplings")
    p.add_argument("--reflow-gen-solver", default="heun",
                   choices=("euler", "heun"),
                   help="teacher ODE solver when generating couplings")
    p.add_argument("--vq-from", default=None, metavar="CKPT",
                   help="vqprior only: two-stage training. Load a trained "
                        "vqvae checkpoint into the prior run's tokenizer and "
                        "freeze it (sets --vq-freeze-tokenizer); only the "
                        "prior trains")
    p.add_argument("--multihost", action="store_true",
                   help="join a group of processes the caller started, one "
                        "a rank, from RANK, WORLD_SIZE, MASTER_ADDR, "
                        "MASTER_PORT and LOCAL_RANK; --dp x --tp must be "
                        "WORLD_SIZE")
    return p


def _config(args) -> Config:
    overrides = {
        f.name: getattr(args, f.name)
        for f in dataclasses.fields(Config)
        if f.name != "variant" and getattr(args, f.name, None) is not None
    }
    return variant_config(args.variant, **overrides)


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    for name, item in _NOT_PORTED.items():
        if getattr(args, name):
            parser.error(f"--{name.replace('_', '-')} is not ported to "
                         f"generative_models_tpu_torch yet (ROADMAP.md {item})")
    if args.reflow_from and args.sample_only:
        parser.error("--sample-only samples a trained model: pass the "
                     "student's --ckpt, not --reflow-from")
    if args.vq_from and args.sample_only:
        parser.error("--sample-only samples a trained model: pass the "
                     "prior run's --ckpt, not --vq-from")
    cfg = _config(args)
    if args.sample_only:  # serving runs on one device
        cfg = cfg.replace(dp=1, tp=1)
    if cfg.tp > 1 and cfg.fused_step is True:
        parser.error("--fused-step with --tp > 1: the chunk and phase kernels "
                     "assume whole parameters (the general step shards them)")
    if args.multihost:
        return _run_multihost(args, cfg, parser)
    world = cfg.dp * cfg.tp
    if world > 1:
        import torch

        from generative_models_tpu_torch.parallel.mesh import run_ranks
        if torch.device(args.device).type == "cuda":
            have = (torch.cuda.device_count() if torch.cuda.is_available()
                    else 0)
            if have < world:
                what = (f"--dp {cfg.dp}" if cfg.tp == 1
                        else f"--dp {cfg.dp} --tp {cfg.tp}")
                parser.error(f"{what} needs {world} CUDA devices, one "
                             f"a rank, but only {have} are present "
                             "(--device cpu runs the ranks on the CPU)")
        argv = sys.argv[1:] if argv is None else list(argv)
        lines = run_ranks(_train_rank, world, args.device, args=(argv,),
                          grid=(cfg.dp, cfg.tp, "model"))
        for line in lines[0]:  # rank 0's
            print(line)
        return 0
    return _run(args, cfg, print)


def _run_multihost(args, cfg, parser) -> int:
    """``--multihost``: this process is one rank of a dp x tp grid whose
    other ranks the caller started; it prints its own lines."""
    from generative_models_tpu_torch.parallel import mesh, multihost
    try:
        grid = multihost.init_multihost(cfg.dp, cfg.tp, args.device)
    except ValueError as e:
        parser.error(str(e))
    try:
        rc = _run(args, cfg, print, grid, log_every_rank=True)
        grid.barrier()
        return rc
    finally:
        mesh.close_data_group()


def _train_rank(grid, argv) -> list:
    """One rank of ``--dp M --tp N``: trains in `grid` and returns the
    lines rank 0 prints (the other ranks print nothing)."""
    args = build_parser().parse_args(argv)
    out: list = []
    _run(args, _config(args), out.append if grid.rank == 0
         else (lambda line: None), grid)
    return out


def _run(args, cfg, say, group=None, log_every_rank=False) -> int:
    if not args.debug_nans:
        return _run_body(args, cfg, say, group, log_every_rank)
    import torch
    with torch.autograd.detect_anomaly():
        return _run_body(args, cfg, say, group, log_every_rank)


def _run_body(args, cfg, say, group, log_every_rank=False) -> int:
    from generative_models_tpu_torch.train.trainer import Trainer
    from generative_models_tpu_torch.utils import spans
    from generative_models_tpu_torch.utils.checkpoint import exists
    data = teacher = None
    if args.reflow_from:
        from generative_models_tpu_torch.train import reflow
        cfg = cfg.replace(flow_reflow=True)  # validates variant == flow
        device = args.device if group is None else group.device
        teacher = reflow.load_teacher_params(args.reflow_from, cfg, device)
        data = reflow.build_reflow_data(
            teacher, cfg, n_train=args.reflow_pairs,
            gen_steps=args.reflow_gen_steps,
            gen_solver=args.reflow_gen_solver)
        say(f"reflow: {args.reflow_pairs} teacher couplings from "
            f"{args.reflow_from} ({args.reflow_gen_solver} "
            f"S={args.reflow_gen_steps})")
    vq_params = None
    if args.vq_from:
        from generative_models_tpu_torch.train import vq
        cfg = cfg.replace(vq_freeze_tokenizer=True)  # vqprior only
        vq_params = vq.load_vqvae_params(
            args.vq_from, cfg, args.device if group is None else group.device)
        say(f"vqprior: frozen tokenizer from {args.vq_from}")
    t = Trainer(config=cfg, device=args.device, group=group,
                debug_nans=args.debug_nans, data=data,
                log_every_rank=log_every_rank)
    if teacher is not None and not args.reflow_fresh_init:
        reflow.init_student(t, teacher)
    if vq_params is not None:
        vq.init_prior_with_vqvae(t, vq_params)
    if args.sample_only:
        if not args.ckpt or not exists(args.ckpt, cfg.ckpt_backend):
            print("--sample-only needs an existing --ckpt", file=sys.stderr)
            return 2
        t.load_model(args.ckpt)
        step = t.state["step"]
        path = t.generate_images(tag=f"samples_step{step:06d}")
        out = {"variant": cfg.variant, "step": step, "samples": path}
        if args.export_sampler and t.writes:
            out["sampler"] = _export_sampler(t, args.export_sampler)
        say(json.dumps(out))
        return 0
    if args.ckpt and cfg.resume and exists(args.ckpt, cfg.ckpt_backend):
        t.load_model(args.ckpt)
        say(f"resumed from {args.ckpt} at step {t.state['step']}")

    run_dir = os.path.join(cfg.out_dir, cfg.variant)
    if t.logs:
        os.makedirs(run_dir, exist_ok=True)
    # the data and the step functions first: building them settles
    # fused_step="auto", whose A/B (ops/fused_policy.py) the trace must
    # not hold; the reference settles it when its Trainer is built
    t._load_data()
    prof = _profiler(t) if cfg.profile else contextlib.nullcontext()
    if cfg.profile:  # the Trainer's phases as ranges over its kernels
        spans.reset()
        spans.enable(ranges=True)
    with prof:  # around training only, as the reference's trace
        t.train(num_epochs=cfg.epochs,
                steps=None if cfg.epochs else cfg.steps,
                log_path=os.path.join(run_dir, "metrics.jsonl"),
                echo_every=args.echo_every,
                ckpt_path=args.ckpt)  # periodic when cfg.ckpt_every > 0
    if cfg.profile:
        rank = 0 if group is None else group.rank
        path = os.path.join(run_dir, "trace", f"rank{rank}.pt.trace.json")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        prof.export_chrome_trace(path)
        spans.disable()
        say(f"trace: {path}")
        say("spans: " + json.dumps({  # each phase's host time, in ms
            k: {"n": v["count"], **{f"{t}_ms": round(v[f"{t}_ns"] / 1e6, 3)
                                    for t in ("total", "self", "max")}}
            for k, v in spans.snapshot()["aggregates"].items()}))
    sps = t.steps_done / t.wall_time
    eval_metrics = t.evaluate("test", max_batches=10)
    say(json.dumps({
        "variant": cfg.variant,
        "steps": t.steps_done,
        "wall_s": round(t.wall_time, 3),
        "steps_per_sec": round(sps, 2),
        "eval": {k: round(v, 4) for k, v in eval_metrics.items()},
    }))
    t.generate_images(tag="final")
    t.viz_loss()
    # scoring and export on one rank need no collective: a tp state is
    # gathered whole on every rank first
    t.unshard()
    if args.score_samples and t.writes:
        say(json.dumps(_score(t)))
    # the checkpoint first: a failed export must not cost the run
    if args.ckpt:
        say(f"saved: {t.save_model(args.ckpt)}")
    if args.export_sampler and t.writes:
        say(f"exported: {_export_sampler(t, args.export_sampler)}")
    return 0


def _profiler(t):
    """``--profile``: torch.profiler over the host and, on the card, the
    device (the reference's ``jax.profiler`` trace of training)."""
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU]
    if t.device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def _score(t) -> dict:
    """The reference's quality line: a classifier trained on the train
    split (decoded to float32), scored on the test split, and the scores
    of 1024 samples, FID against the first 1024 test images."""
    from generative_models_tpu_torch.utils.quality import (
        classifier_accuracy,
        fid_score,
        score_samples,
        train_classifier,
    )
    xs, ys = t.train_split_f32()
    clf = train_classifier(xs, ys, device=t.device)
    acc = classifier_accuracy(clf, t.x_test, t.y_test)
    samples = t.sample(1024)
    scores = score_samples(clf, samples)
    scores["fid"] = fid_score(clf, t.x_test[:1024], samples)
    return {"classifier_test_acc": round(acc, 4),
            **{k: round(v, 4) for k, v in scores.items()}}


def _export_sampler(t, path: str) -> str:
    from generative_models_tpu_torch.utils.export import save_sampler
    return save_sampler(path, t.spec, t.cfg, t.generator_params,
                        t.cfg.sample_n)


if __name__ == "__main__":
    sys.exit(main())
