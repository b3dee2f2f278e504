#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA card and nvcc. It
imports nothing of JAX. Phases:

1. the card's name and power limit (nvidia-smi); TF32 off for float32
   matmuls and convolutions, so the plain versions run in true float32;
2. builds every kernel of the serving and training paths from ``csrc/``
   (five sources — mlp_fwd, mlp_bwd, gan_chunk, reparam, vae_chunk;
   gan_chunk once per critic hook, eleven libraries, and once per
   data-parallel hook with -DGM_PHASE=1, nine ``gan_phase`` libraries,
   each of these and vae_chunk also with -DGM_BF16=1 (bf16 operands):
   45 libraries, one nvcc each, in this process before any rank starts;
   sm_90a): mlp_fwd, mlp_bwd and reparam first; then the other 42 and
   5e's instrumented phase libraries, all started together at niceness
   BUILD_NICE, while 3a, 3b, 4i, 4j and 4k, which need only the first
   three, run (the timing phases, 5, run after every build has ended;
   4i-4k's CLI steps/s are read beside the builds); prints the build
   time and the
   ptxas reports; it fails if any kernel spills registers; then a line a
   chunk or phase library: its largest register count, spill bytes, the
   dynamic shared bytes a block and the blocks an SM the occupancy query
   grants each kernel; and the product engine's tile rule on the card
   against ops/chunk_plan.py's for every flagship job (the chunk's, and
   the phase kernels' at b = 100 and 50);
3. holds each kernel against its plain PyTorch version on the card:
   - the whole-MLP forward at the serving shapes (nsgan G 128->400->784
     at B 1/37/64/100/1000/1024/8192), the critic's shape, a 3-layer tanh
     stack, and the one-layer ``linear_cuda`` (784->400 leaky_relu at
     B 100/8192), the quality scorer's classifier 784->128->10 and its
     feature layer 784->128 at B 256/1024/10000, in float32 and bf16
     operands; then G at B 100 and D at
     a ragged B 37 under one launch plan of every cluster size and item
     height (``ops/cuda_mlp.py::chain_candidates``); the GEMM route
     (one layer of float32 products at ``GEMM_MIN_ROWS`` rows or more):
     the diffusion net's eight launches of a reverse step at n 10,000,
     784->400 at a ragged GEMM_MIN_ROWS + 1 and 10,001, 400->784 at
     10,001 under each act code, narrow and odd widths (37->130,
     6272->1, 128->10), and x and W off 16-byte alignment; each case's
     route (GEMM or chain) held to ``cuda_mlp.takes_gemm``;
   - the whole-MLP backward (every dW, db and dx): G at B 1/37/100/8192,
     D at B 100, the tanh stack, the classifier at B 256; G at B 100 under one pass-1 plan of every
     cluster size and item height, G at B 8192 in 1, 3 and 7 slices and at
     B 1000 in 2 and 3 (a ragged last slice); float32 and bf16; and G at
     B 8192 twice, bitwise equal (the slices' sums run in a fixed order);
   - the chunk kernel: 8 steps at full width, B 100, from the same state
     and streams, against the plain version in float64, for nsgan and
     mmgan at d_steps 1, nsgan at 2, lsgan, wgan (d_steps 5, RMSprop,
     clip), fgan (jensen_shannon; kl with the non-saturating G loss;
     total_variation), ragan and fishergan (multiplier in and out),
     wgangp (d_steps 5, betas 0.5/0.9, the penalty), dragan (the penalty
     at streamed x_hat rows), cgan (10 label lanes), infogan (the 15-lane
     D + Q head, codes on the z rows, both MI lanes) and began (the
     784-400-784 autoencoder critic, k_t in and out, M); the data of
     every such check is the first seed whose smallest hidden
     pre-activation (the penalty's x_hat layer too; began's |pixel -
     reconstruction| as well) is clear of a tie (TIE_MARGIN);
   - a cross-check: 20 steps of the chunk kernel and 20 of the general
     step (which runs the forward and backward kernels) from one state,
     for nsgan and each of lsgan, wgan, fgan, ragan, fishergan, wgangp,
     dragan, cgan, infogan, began; and wgangp, ragan and fishergan at the
     default Adam eps, each path against a float64 run of the chunk's
     plain version over the same 20 steps;
   - the sampling kernel ``reparam`` at [100, 20], [8192, 20], a ragged
     [37, 20] and a wide [64, 200]: z element by element against the
     plain version's reproduced eps, the row KL, z and kl bitwise equal
     across two calls; the backward kernel ``reparam_bwd`` against the
     plain rule (dkl as given and expanded from one value), and through
     autograd; the moments of 1.3 million draws, and distinct offsets
     giving distinct noise;
   - the VAE and BIR-VAE (mse and bce) chunk kernels: 8 steps at full
     width (784-400-20), B 100, against their plain versions in float64;
     and 20 steps of each against the general step from one state with
     the same eps;
   - the data-parallel phase kernels (3h): each of the nine hooks' D and
     G phase against its plain version in float64 at b = 100 and 50 (a
     rank's rows at world 1 and 2), each gradient tensor by its max abs
     error over its max |ref|, the metrics lanes (every one of the 8,
     which the kernels write themselves) by abs error, data by the tie
     rule; began's D phase with k passed by pointer and by value, the
     same bits;
   - the product engine (3j) at widths ragged for every tile class
     (nsgan B 37, 70->203->389, 389->211->1; the VAE 389-203-13, B 37): 8
     steps against the float64 plain versions by CHUNK_TOL and
     VAE_CHUNK_TOL; and (3k) nsgan, wgangp, infogan and the VAE, float32
     and bf16, 8 steps twice from one state: every plane and the metrics
     bitwise equal;
   - the EMA and bf16 kernels (3i): every hook's Adam and RMSprop EMA
     chunk kernels, 8 steps at ema_decay 0.999, and the VAE and BIR-VAE EMA kernels, held as 3c
     and 3f hold theirs with the EMA plane as one more state plane; every
     hook's bf16 chunk kernel with and without the EMA plane, the VAE
     and BIR-VAE bf16 kernels (one step) and every hook's bf16 D and G
     phase kernel (b = 100), each against a float64 plain version with
     the same bf16 operand rounding, by BF16_RATIO;
4. drives the port's main paths, each with the launch counts set to 0
   just before it and read just after:
   - serving: a full-width nsgan checkpoint in the JAX package's npz
     layout (random weights from a seed), ``cli.main([... "--sample-only"])``
     and ``Trainer.sample`` at n = 8192 held against the plain version;
   - training through the CLI (``fused_step="auto"``, the chunk kernel):
     nsgan, lsgan, wgan (RMSprop, d_steps 5, clip 0.01), fgan, ragan,
     fishergan, wgangp (d_steps 5), dragan, cgan, began, infogan, vae and
     birvae, CLI_STEPS (200) steps each in chunks of 100 at full width on
     the 60,000-row synthetic split, 2 launches of the chunk kernel each,
     losses finite (and for the VAE family falling: the mean of the last
     50 below the mean of the first 50), wgan's critic inside the clip
     at the end, fishergan's ``vstate_lam``, began's ``vstate_k`` (in [0,
     1]) and ``vstate_m``, infogan's ``g_mi_loss`` and the penalty's
     ``gp`` and ``grad_norm`` in ``metrics.jsonl``, ``final.png`` and
     ``metrics.jsonl`` written; then nsgan and vae again with
     ``--ema-decay 0.999 --dtype bfloat16`` (2 launches of the EMA and
     bf16 kernel each, the checkpoint's EMA plane apart from the
     parameters);
   - training through the general step (``fused_step=False``): nsgan 100
     steps, 5 forward and 4 backward launches a step; wgan 30 steps, 17
     and 12; wgangp 30 steps, 17 and 12 and 5 plain critic passes of the
     penalty (``ops/penalty.py``: no kernel is twice differentiable);
     ragan 50 steps, 6 and 4; began and infogan 50 steps, 5 and 4; vae
     50 steps, 4 forward, 4 backward, 1 ``reparam`` and 1
     ``reparam_bwd`` launch a step;
     birvae 50 steps, 3 forward and 3 backward; then the CLI's nsgan with
     ``--spectral-projection`` in both ``--sn-mode``s (SN_STEPS steps):
     ``fused_step="auto"`` takes the general step (no chunk launch), D's
     largest singular value ends at most sn_target (SN_SIGMA_TOL), the
     amortized run's checkpoint holds ``sn_v``;
   - quality scoring and the sampler export (4h): the CLI's nsgan and
     vae runs again with ``--score-samples --export-sampler`` and a grid
     every 500 steps: the scorer's MLP launches counted apart (500
     training steps of the classifier, its accuracy on the 10,000 test
     images > 0.9, the scores and FID finite); the artifact loaded on the
     card and on the CPU, bit for bit per seed and against
     ``Trainer.sample`` with the same Philox z; a GIF of the run's grids;
   - ``--sample-only`` from full-width wgan, cgan, began and infogan
     checkpoints in the JAX layout (cgan: G 138->400->784, D
     794->400->1; began: D 784->400->784; infogan: G 140->400->784, D's
     trunk and two heads; cgan's and infogan's grids cycle the classes,
     held against the plain version);
   - serving the VAE: ``--sample-only`` from a full-width vae checkpoint
     in the JAX layout and ``Trainer.sample`` at n = 8192 against plain;
   - data-parallel training (4f): a group of one rank over NCCL on the
     card, ``Trainer(fused_step=True, group)`` (the phase kernels: d_steps
     + 1 launches a step, no chunk launch) against ``fused_step=False``
     (the general DP step) for nsgan and wgangp, 20 steps from one seed,
     held like the cross-check, with d_steps + 1 NCCL all-reduces a
     step (each one runs, at world 1 too);
     and nsgan at dtype bfloat16 through the bf16 phase kernels, held to
     the float32 fused run by the reference's bf16 bound (BF16_RUN_TOL);
     and the general DP step of ddpm, flow, vqvae and vqprior
     (DP_FAMILY_STEPS each) against the single device's general step;
     then (4g) two ranks sharing the card over gloo, b = 50 a rank, the
     same pair on nsgan, the two ranks' states equal;
   - the conv stacks (4i, ``models/conv.py``) at full width, conv_channels
     64, with ``torch.backends.cudnn.allow_tf32`` at torch's default
     (True): one conv and its gradients against float64 (the module keeps
     float32 convs off TF32 itself; cuDNN called directly beside it);
     every stack's forward and backward on the card (dense layers through
     the MLP kernels, the 6272-wide inputs' backward at the wide chunk
     depth) against the CPU's plain path, data by the tie rule (CONV_TOL);
     the nsgan and vae conv steps twice from one state, bitwise equal; the
     CLI's ``--arch conv`` runs of nsgan, wgangp, lsgan and vae (CONV_STEPS
     steps each, the general step, launch counts worked out beforehand,
     CONV_LAUNCHES, no chunk launch); ``--sample-only --export-sampler``
     from a JAX-layout conv checkpoint (one G launch; the artifact on the
     card bitwise per seed and against ``Trainer.sample``); 20 bf16 steps
     of the conv nsgan and vae;
   - the diffusion family (4j, ``models/ddpm_net.py``, ``losses/ddpm.py``,
     ``losses/flow.py``, ``train/reflow.py``) at config.py's defaults:
     the ddpm MLP net and UNet (conditional) at B 100, forward and every
     gradient on the card against the CPU (DIFF_TOL), 8 and 7 launches a
     forward and a backward (DIFF_LAUNCHES), and one SiLU layer against
     its plain version; nsgan with a SiLU G (the route for activations
     the kernels do not hold: gradients against the CPU, 7 and 5
     launches a step); the CLI's ddpm and flow runs on both nets and a
     guided conditional ddpm run (DIFF_STEPS general steps, launch
     counts worked out beforehand, no chunk launch, losses falling, the
     checkpoint's EMA apart from its params) and 20 bf16 ddpm steps;
     every sampler of DIFF_SAMPLERS (DDPM's full chain, S 50 at eta 0,
     flow's Euler 50 and Heun 16, guided: one 2n-row call a step) on the
     card against the CPU from the same initial x and chain noise
     (SAMPLER_TOL); ``--sample-only --export-sampler`` from JAX-layout
     ddpm and flow checkpoints at EXPORT_S steps (the artifact bitwise per seed and
     against ``Trainer.sample`` with the same Philox draws); and
     ``--reflow-from`` the flow run's checkpoint (REFLOW_PAIRS pairs by
     Heun 50, a student run, 1-step sampling);
   - the VQ family (4k, ``models/vq_net.py``, ``models/ar_prior.py``,
     ``losses/vqvae.py``, ``losses/vqprior.py``, ``train/vq.py``) at
     config.py's defaults (K 64, D 16, L 16, the prior 128 wide, 2
     layers, 4 heads, conv_channels 64): each loss (vqvae and vqprior on
     both archs, conditional, the frozen tokenizer) at B 100, its metrics,
     tokens and every gradient on the card against the CPU (VQ_NET_TOL),
     data by the tie rule (the code margin VQ_TIE_MARGIN, the ReLUs'
     TIE_MARGIN), the launches worked out beforehand (VQ_LOSS_LAUNCHES:
     vqprior's joint mlp step 11 / 11); with the global TF32 flag on, the
     distances and attention products against float64 (VQ_F32_TOL) and a
     vqprior loss bitwise as with it off; the prior's samplers ("cache"
     and "full", mlp and conv) at n 64 against the CPU from one Gumbel
     chain (tokens equal, the chain by the tie rule); the CLI's vqvae,
     vqprior (joint, ``--vq-from`` the vqvae run's checkpoint with the
     tokenizer bit for bit in the final checkpoint, conv, conditional)
     runs of VQ_STEPS general steps (launches, no chunk launch, losses
     falling, the prior's CE below log K, perplexity above 1), 20 bf16
     vqvae steps, and ``--sample-only --export-sampler`` from JAX-layout
     vqvae and vqprior checkpoints (the artifact bitwise per seed and
     against ``Trainer.sample`` with its Philox draws);
   - parallelism (4l, ``parallel/``; beside the builds, on the first
     three libraries alone): tensor parallelism on two ranks sharing the
     card over gloo (a 1 x 2 grid on the "model" axis): nsgan, vae,
     wgangp and vqprior at config.py's widths, B 100, TP_STEPS general
     steps each (wgangp 4, as tests/test_tp.py), and nsgan with the
     spectral projection in both sn_modes (D's weights gathered whole
     and projected, their largest sigma within sn_target after the run;
     the model group's all-gathers counted), held against a
     single-device run on the card from the
     same seed and draws by tests/test_tp.py's tolerances (TP_TOL), the
     MLP kernels' launches, the penalty's plain passes and the model and
     data groups' all-reduces a step worked out beforehand (TP_PER_STEP;
     no chunk launch), and ``Trainer.sample(64)`` from the tp state
     against the single device's; pipeline parallelism on
     two ranks sharing the card (1 x 2 on "pipe"): the prior at full
     width, n_micro PP_MICRO, PP_STEPS steps of ``build_pp_prior_step``
     against as many single-device prior steps on the card (the CE and
     every leaf, PP_TOL), the stages' launches counted; and ``--multihost``
     at WORLD_SIZE 1 over NCCL (nsgan, MULTIHOST_STEPS steps, its final
     line and metrics.jsonl); host-clock steps/s of each beside the single
     device's, and the model group's all-reduce time;
   - the measured fused-step policy (4m, ``ops/fused_policy.py``; every
     other phase runs with GMTPU_FUSED_AB=0, the static rule, so its
     launch counts hold): the A/B of nsgan, vae and wgangp at B 100 and
     nsgan at B 1024 (POLICY_AB_STEPS steps a rep), both arms' steps/s
     and the verdict, the second call from the cache (no launch), the
     CLI's "auto" run launching the verdict's arm, and a failed
     measurement taking the kernel and cached nowhere;
   - ``--profile`` and the directory checkpoint backend (4n): the CLI's
     traces of nsgan on the chunk kernel and on the general step hold
     the chunk, forward and backward kernels' events (their sizes
     printed, the files removed), and ``--ckpt-backend orbax`` saves a
     directory, resumes from it and ends at the uninterrupted run's
     state bit for bit;
5. times, with CUDA events, each kernel beside its plain version, its
   bound and one library call (5a: the MLP kernels at the serving and the
   general step's shapes, float32 and bf16 beside autocast, each with its
   device time from torch.profiler, the backward's kernels apart, and the
   library's device time summed over its kernels), (5c) ``reparam`` and
   ``reparam_bwd`` at [100, 20], [8192, 20] and [64, 200] with their
   device ms (``queued_ms``) and host us a call, and steps/s of each chunk kernel (nsgan,
   lsgan, wgan, fgan, ragan, fishergan, wgangp, dragan, cgan, infogan,
   began, vae, birvae), the general step and a library step loop (addmm
   + autograd + ``torch.optim.Adam`` or ``RMSprop`` with
   ``foreach=True``, which the port never calls: every one of them);
   each hook's phase kernels at b = 100 and 50 beside their float32
   plain versions, their bounds and one ``autograd.grad`` call of the
   hook's loss (held first against the float64 plain version), and steps/s of both DP routes at world 1 and on two ranks sharing the
   card, with the all-reduce's time; (5f) the EMA and bf16 chunk
   kernels of 5e's traced hooks (TRACE_VARIANTS) and of the VAE family
   and the bf16 phase kernels of those hooks the same way; every phase kernel's row has the host µs a call
   beside its CUDA-event and device times (the device time: calls
   queued behind a spin kernel, ``tools/phase_trace.py::queued_ms``),
   and in 5e the phase kernels of nsgan, wgangp, infogan and began are
   traced phase by phase (``tools/phase_trace.py``, an instrumented
   copy; float32 at b = 100 and 50, bf16 at b = 100), each trace holding
   its kernel's device time to 0.9-1.5x of it (their library yardsticks with an EMA step or
   under autocast, bf16 bounds at the tensor cores' dense peak; each
   bf16 phase's yardstick held to its function by LIBRARY_BF16_TOL, which
   the same yardstick with a wrong loss term must exceed); (5a) also the
  conv stacks' dense layers (G's 128->6272, the critic's 6272->1, the
  encoder's 6272->400, infogan's 6272->400->15) and the diffusion nets'
  (DIFF_DENSE, also held in 3a/3b at B 100, 200 and 2048), the MLP
  net's widths at n 10,000 and its eight launches of a reverse step
  there (DIFF_STEP, the GEMM route), (5g) the conv
  nsgan and vae general steps: steps/s, and a step's device time split
  into cuDNN's convolutions, the hand-written kernels and the rest; (5h)
  the same for ddpm and flow on both nets, and their served images/s at
  n 64 and 1024 (DDPM at S 1000 and 50, flow at S 1, 16 and 50; the
  UNet's DDPM S 1000 at n 64 alone); (5i)
  the same for vqvae and vqprior on both archs, the prior's served
  images/s at n 64 and 1024 in both decodes, and (5a) the prior's five
  linears at 1600 rows (VQ_DENSE, also held in 3a at 64-50,176 rows and
  3b at 1600 and 4900, with the MLP tokenizer's stacks); (5j) the conv
  nsgan and vae general steps in float32 and bf16 at
  B 100-2048, A B B A twice (each arm's best run), the table of steps/s
  and the bf16 crossover it gives beside config.py's
  CONV_BF16_CROSSOVER_BATCH;
6. prints the ``{"kernels": [...]}`` line, the nvidia-smi line, and last
   ``{"ok": true, "device": {...}}``.

Any failed check raises, and the script exits non-zero. Without a CUDA
device, or without the package beside it, it exits non-zero and prints
no result.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import functools
import glob
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(HERE, "chiprun_out", "chip_smoke")

# Published H100 SXM peaks (NVIDIA data sheet, dense, at 700 W).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12  # dense bf16 on the tensor cores
# the EMA kernels' decay (ddpm's and flow's default, config.py)
EMA_DECAY = 0.999

# Kernel vs plain version on the card, fixed before measuring.
# Forward, max abs error. float32: only the order of the K <= 784
# products in each sum differs (a few float32 ulps of values of order
# 1). bf16 operands: both sides round the same operands, but a hidden
# that lands within that sum-order error of a bf16 rounding tie rounds
# the other way, one bf16 ulp (<= 2^-6 for |h| < 4) times |W| <= 1/sqrt(K)
# in the next layer.
TOL = {"float32": 1e-4, "bfloat16": 5e-3}
# Backward, max abs error over max |reference| of each dW, db and dx.
# float32: dW sums up to 8192 rows of products, each g a sum of up to
# 784, in another order than cuBLAS. bf16: a g within that error of a
# rounding tie rounds to the other bf16 neighbour (2^-8 relative) in one
# of the products of a sum.
BWD_TOL = {"float32": 1e-5, "bfloat16": 5e-3}
# Chunk kernel vs its plain version over 8 steps, the plain version run
# in float64 on the same float32 inputs: metrics max abs error, and each
# state tensor's (params, mu, nu) max abs error over its max |ref|. The
# reference is float64 because the float32 plain version is no nearer
# the exact result than the kernel: Adam divides each element's gradient
# by its own sqrt(v-hat), and the bias and near-zero gradients of D are
# sums that nearly cancel, so float32 rounding in either moves them by
# a visible part of lr (this phase prints the float32 plain version's
# distance from float64 beside the kernel's).
CHUNK_TOL = {"metrics": 1e-4, "state": 1e-3}
# ragan and fishergan run these checks at adam_eps = 1e-3, as the BIR-VAE
# does below and for its reason: the bias gradient of their critic's head
# cancels in exact arithmetic (ragan: sum(glr + glf) = 0 identically), and
# at the default eps Adam normalises the rounding residue of that sum into
# steps of order lr, in the kernel and in any float32 version alike. For
# ragan that bias's mu and nu slots hold nothing but the residue (mu decays
# from its start of ~1e-3 to ~4e-6 in 8 steps; the residue of a float32
# sum of 200 terms of 1/B is ~1e-8), so these two one-element slots are
# held by absolute error, every other tensor as CHUNK_TOL's.
# The BIR-VAE's mean-head bias is the same case (see VAE_CHUNK_TOL): with
# data chosen by the tie rule instead of by hand, its mu slot's error
# relative to its own decayed max (~4e-4) reads 2e-4 to 1.6e-3, the
# float32 plain version's 2e-4 to 1.4e-3; a float32 sum of 100 gradient
# rows of order 0.5 leaves ~1e-6, a tenth of which enters mu each step.
COUPLED_ADAM_EPS = 1e-3
# wgangp's cross-check (below) runs at it too: 100 critic updates of Adam
# at beta2 0.9 turn the two float32 versions' rounding differences in its
# small critic gradients into steps of order lr (at the default eps: the
# mu plane 1.002e-2 apart in relative L2, mu.d_b1 the worst element at
# 7.7e-2 of its max), while each version holds its float64 plain version
# to ~1e-6 over 8 steps (phase 3c). infogan's too: from a fresh state its
# D logit's bias gradient nearly cancels (mean sig(lr) - 1 + mean sig(lf)
# ~ 0), and at the default eps the general step's mu plane read 2.8e-2
# from a float64 run after 20 steps in a CPU run of this phase (the
# chunk's plain version 3.6e-7; G's lr is 1e-3), 1.8e-2 even at a G lr of
# 2e-4, and 4.2e-3 at 1e-3 (see F64_CASES).
RESIDUE_SLOTS = {"ragan": ("mu.d_b2", "nu.d_b2"),
                 "birvae": ("mu.mu_b", "nu.mu_b")}
RESIDUE_ABS_TOL = {"ragan": 2e-7, "birvae": 5e-6}
# fishergan's multiplier after the chunk, kernel vs float64 plain.
LAM_TOL = 1e-6
# Tie rule of every 8-step chunk check. A hidden pre-activation within
# float32 rounding of zero is positive in one version and not in the
# other, which switches that sample's whole contribution to the unit's
# gradients on or off (ReLU) or scales it by the slope (LeakyReLU): a jump
# of the function itself, not an error of either version. A pre-activation
# is a float32 sum of up to 784 products, good to a few 1e-7 of the
# layer's root mean square. So each check draws its data with numpy from
# TIE_FIRST_SEED, the float64 plain version reports the smallest
# |pre-activation| / rms(layer) over the 8 steps, and the check takes the
# first seed whose value is above TIE_MARGIN, printing that seed and the
# ones it passed over. With ~2e6 to 5e6 pre-activations a case, one seed
# in four (d_steps 1) to one in eighty (d_steps 5) qualifies.
TIE_MARGIN = 1e-6
# wgangp's case holds the most pre-activations (8 steps x 5 critic updates
# x 4 hidden layers, x_hat's too: ~7 million), and at 1e-6 not one seed of
# 2000 cleared the rule; half of it is still over twice the few 1e-7 of a
# float32 sum's rounding.
TIE_MARGIN_OF = {"wgangp": 5e-7}
TIE_FIRST_SEED = 10
TIE_MAX_SEEDS = 2000
# Chunk kernel vs the general step over 20 steps, both float32 (the
# general step takes its gradients through autograd and Adam in optax's
# order): metrics max abs error, and the worst state plane's relative L2
# distance (params, mu or nu, its 8 tensors together) — for the reason
# above, a few elements may differ by up to 2 lr, so the planes are held
# by their norm; the residue slots (RESIDUE_SLOTS) by absolute error, as
# in the 8-step checks (with them in the norm, the BIR-VAE mse case read
# 1.29e-2 once its draws changed: nu.mu_b at 0.86 of its own max). Each
# case draws from a seed of its own.
CROSS_TOL = {"metrics": 2e-3, "state": 1e-2}

# reparam kernel vs its plain version (the same Philox words, so the same
# eps up to the last bits of logf/cosf/sqrtf/expf on the card against
# torch's): z max abs error at |mu| ~ 1, sigma ~ 1, |eps| <= 5.7 (a few
# float32 ulps of values below 8, and one fused multiply-add where torch
# rounds twice); the row KL and the analytic backward by max abs error
# over max |reference| (20- or 200-term float32 sums in another order).
REPARAM_TOL = {"z": 2e-5, "kl": 1e-5, "grad": 1e-5}
# eps from 65536 x 20 draws: |mean| and |var - 1| about five standard
# errors (0.87e-3 and 1.2e-3 at 1.3 million draws).
REPARAM_MOMENTS = 5e-3
# VAE / BIR-VAE chunk kernels vs their plain versions in float64 over 8
# steps: the metrics by max abs error over max |reference| (a loss of
# order 550 is a float32 sum of 78,400 pixels: a few ulps, 6e-5 each, of
# the total), each state tensor as CHUNK_TOL's. The BIR-VAE runs at
# adam_eps = 1e-3: the bias gradient of its mean head is zero in exact
# arithmetic (the batch normalisation removes a uniform shift), and at
# the default eps Adam normalises the rounding residue of that sum into
# steps of order lr, in the kernel and in any float32 version alike. Even
# so that bias's mu slot is the worst tensor of every BIR-VAE case (2e-4
# to 9e-4 of its max over data seeds 8-15, the float32 plain version
# 2e-4 to 1.4e-3): it holds nothing but that residue, and is held by its
# absolute error (RESIDUE_SLOTS).
# The data follows the tie rule above (a tie was seen at numpy seeds 9
# and 14 of an earlier data recipe: one hidden unit's column ~1e-2 of max
# off after its step, every other tensor ~1e-7).
VAE_CHUNK_TOL = {"metrics": 2e-5, "state": 1e-3}
BIRVAE_ADAM_EPS = 1e-3

# the penalty's weight and cgan's classes (the registry defaults)
GP_LAM, N_CLS = 10.0, 10
# infogan's codes and MI weight, began's k_t law and autoencoder hidden
# width (the registry defaults)
INFO_CAT, INFO_CONT, INFO_LAM = 10, 2, 1.0
INFO_L = 1 + INFO_CAT + 2 * INFO_CONT
BEGAN_GAMMA, BEGAN_LK, BEGAN_HD = 0.75, 1e-3, 400
# began's k_t before the 8-step check: above 0, so that the fake rows'
# gradient (-k times theirs) is held too. |.| is differentiated through
# its sign, so a pixel within rounding of its reconstruction flips its
# term's sign in one version and not the other; with G's output and the
# autoencoder's both near 0.5 (random weights) about 25 of the 1.9
# million |fake - AE(fake)| a case holds fall within 5e-7. So the check
# shifts G's output bias up and the autoencoder's down by BEGAN_SHIFT
# (fakes ~0.88, reconstructions ~0.12, r (1 - r) ~ 0.1, far from
# saturated), takes 0/1 pixels for x, and holds |v - r| to the tie rule.
# The cross-check (phase 3d) takes the same shift and 0/1 pixels: from a
# fresh state (G's output and the reconstructions both near 0.5) its two
# float32 paths read 1.6e-2 apart on the card (mu.g_w2 0.26 of its max).
BEGAN_K0 = 0.3
BEGAN_SHIFT = 2.0
PENALTY_LANES = {"wgangp": 1, "dragan": 784}
DRAGAN_SCALE = 0.5

G_DIMS = [128, 400, 784]
G_ACTS = ("relu", "sigmoid")
D_DIMS = [784, 400, 1]
D_ACTS = ("leaky_relu", "none")
SERVING_BATCHES = (64, 1024, 8192)
TRAIN_B = 100
VAE_X, VAE_H, VAE_L = 784, 400, 20
VAE_CASES = (("vae", "bce"), ("birvae", "mse"), ("birvae", "bce"))
# the quality scorer's classifier (utils/quality.py) and its feature
# layer: trained at B 256, scored on 1024 samples and the 10,000 test
# images
CLF_STACKS = (("clf", [784, 128, 10], ("relu", "none")),
              ("clf_feat", [784, 128], ("relu",)))
CLF_BATCHES = (256, 1024, 10000)
# The conv stacks' dense layers at conv_channels 64 (models/conv.py), 7 x
# 7 x 2C = 6272 wide: G's and the decoder's fc out to it, the critic's,
# the encoder's and infogan's in from it (the backward's transposed W
# chunk of such an input is planned at cuda_mlp.WIDE_CHUNK_DEPTHS).
CONV_W = 7 * 7 * 2 * 64
CONV_DENSE = (("conv_g_fc", [128, CONV_W], ("none",)),
              ("conv_dec_fc", [20, CONV_W], ("none",)),
              ("conv_d_fc", [CONV_W, 1], ("none",)),
              ("conv_enc_fc", [CONV_W, 400], ("relu",)),
              ("conv_info", [CONV_W, 400, 15], ("leaky_relu", "none")))
# The diffusion nets' dense layers at config.py's defaults
# (models/ddpm_net.py), each one linear_cuda call with act "none" (the
# time MLP's SiLU follows its product): the MLP net's skip 784 -> 784,
# in 784 -> 400, the time MLP 128 -> 128, its projections 128 -> 400,
# mid 400 -> 400 and out 400 -> 784; the UNet's time biases 128 -> 64
# and 128 -> 128. B 100 in training; 2n rows in guided sampling (n 100:
# 200); B 2048 in reflow's generate_pairs.
DIFF_DENSE = (("diff_skip", [784, 784]), ("diff_in", [784, 400]),
              ("diff_time", [128, 128]), ("diff_tproj", [128, 400]),
              ("diff_mid", [400, 400]), ("diff_out", [400, 784]),
              ("diff_unet_t", [128, 64]))
DIFF_BATCHES = (TRAIN_B, 2 * TRAIN_B, 2048)
# The MLP net's eight launches of a reverse step, in order
# (models/ddpm_net.py::mlp_apply): the time MLP's two, in, t1, mid, t2,
# out, skip; each at n rows when sampling n images (an FID draw: n
# 10,000, the benchmark's generation cell), the GEMM route's main path.
DIFF_STEP = (("time0", [128, 128]), ("time1", [128, 128]),
             ("in", [784, 400]), ("t1", [128, 400]), ("mid", [400, 400]),
             ("t2", [128, 400]), ("out", [400, 784]), ("skip", [784, 784]))
DIFF_GEN_N = 10000
# The VQ family's dense layers at config.py's defaults
# (models/ar_prior.py, models/vq_net.py): the prior's five linears, 128
# wide (act "none": fc1's GELU follows its product), each one linear_cuda
# call, at B * L = 1600 rows in training (4900 on conv), n a decode step
# (64, 1024, 8192) and n * L in "full" decoding (up to 1024 * 49 =
# 50,176); the MLP tokenizer's encoder and decoder, one launch a stack,
# at B 100 and n 8192.
VQ_DENSE = (("vqp_qkv", [128, 384]), ("vqp_proj", [128, 128]),
            ("vqp_fc1", [128, 512]), ("vqp_fc2", [512, 128]),
            ("vqp_head", [128, 64]))
VQ_ROWS = (64, 1600, 4900, 8192, 50176)
VQ_TRAIN_ROWS = 1600
VQ_STACKS = (("vq_enc", [784, 400, 256], ("relu", "none")),
             ("vq_dec", [256, 400, 784], ("relu", "none")))


def nvidia_smi_line() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return r.stdout.strip().splitlines()[0]


def make_stack(rng, dims, device):
    import torch
    ws, bs = [], []
    for k, n in zip(dims[:-1], dims[1:]):
        bound = 1.0 / np.sqrt(k)
        ws.append(torch.from_numpy(
            rng.uniform(-bound, bound, (k, n)).astype(np.float32)).to(device))
        bs.append(torch.from_numpy(
            rng.uniform(-bound, bound, (n,)).astype(np.float32)).to(device))
    return ws, bs


# the niceness of the builds that run beside the paths (start_builds):
# their nvcc processes inherit it, so the paths' one Python thread keeps
# its core among them
BUILD_NICE = 10


def start_builds(mods, nice: int = 0):
    """Phase 2: one nvcc per library, all started together in threads of
    their own (each thread, and so its nvcc, at `nice`); build_all waits
    for them."""
    def at_nice(fn):
        def run():
            if nice > os.getpriority(os.PRIO_PROCESS, 0):  # only lowered
                os.setpriority(os.PRIO_PROCESS, 0, nice)  # this thread's
            return fn()
        return run
    ex = concurrent.futures.ThreadPoolExecutor(len(mods))
    return ex, [ex.submit(at_nice(fn)) for fn in mods], time.perf_counter()


_SHOWN_LOGS = set()  # the build reports build_all has printed


def build_all(mods, build_dir, started=None):
    """Phase 2: the libraries of `mods` (`started`: as start_builds
    returned them, else started here), waited for; then each new build
    report, failing if any kernel spills registers."""
    ex, futures, t0 = started or start_builds(mods)
    with ex:
        for f in futures:
            f.result()
    print(f"[2] built {len(futures)} libraries (of mlp_fwd, mlp_bwd, "
          f"reparam; gan_chunk and gan_phase, two a hook each, float32 and "
          f"bf16; vae_chunk, float32 and bf16; 5e's instrumented phase "
          f"libraries) in {time.perf_counter() - t0:.2f} s from their start")
    spills, chunk_kernels = [], 0
    for log in sorted(glob.glob(os.path.join(build_dir, "*.log"))):
        if log in _SHOWN_LOGS:
            continue
        _SHOWN_LOGS.add(log)
        with open(log) as f:
            text = f.read().strip()
        print("    " + text.replace("\n", "\n    "))
        lines = [l for l in text.splitlines() if "bytes spill" in l]
        name = os.path.basename(log).split("-")[0][3:]
        trained = "chunk" in name or "phase" in name
        chunk_kernels += len(lines) if trained else 0
        spills += [f"{name}: {l.strip()}" for l in lines
                   if "0 bytes spill stores, 0 bytes spill loads" not in l]
    print(f"    ptxas: {chunk_kernels} chunk and phase kernel instantiations; "
          f"kernels with register spills: {spills or 'none'}")
    if spills:  # mlp_fwd, mlp_bwd, reparam, chunk and phase kernels alike
        raise AssertionError(f"a kernel spills registers: {spills}")


def forced_plans(cuda_mlp, widths, b, bwd):
    """One fitting chain plan per cluster size and per item height at
    (widths, b), the first of each that chain_candidates lists."""
    seen, plans = set(), []
    for p in cuda_mlp.chain_candidates(b, widths, bwd):
        keys = {("cluster", p.cluster), ("tr", p.tr)} - seen
        if keys:
            seen |= keys
            plans.append(p)
    return plans


def check_fwd(cuda_mlp, linear_cuda, torch):
    """Phase 3a: raises at the first output or hidden out of tolerance.
    The planner's choice at each case; then, at G B 100 and a ragged D
    B 37, one plan of every cluster size and item height."""
    rng = np.random.default_rng(0)
    cases = [("G", G_DIMS, G_ACTS, b)
             for b in SERVING_BATCHES + (1, 37, TRAIN_B, 1000)]
    cases += [("D", D_DIMS, D_ACTS, b) for b in (TRAIN_B, 1000)]
    cases += [("tanh3", [784, 96, 48, 24], ("tanh",) * 3, b) for b in (37, 8192)]
    cases += [("lin", [784, 400], ("leaky_relu",), b) for b in (TRAIN_B, 8192)]
    cases += [(name, dims, acts, b) for name, dims, acts in CLF_STACKS
              for b in CLF_BATCHES]
    cases += [(name, dims, acts, b) for name, dims, acts in CONV_DENSE
              for b in (TRAIN_B, 1000)]
    cases += [("conv_g_fc",) + CONV_DENSE[0][1:] + (8192,)]
    cases += [(name, dims, ("none",), b) for name, dims in DIFF_DENSE
              for b in DIFF_BATCHES]
    cases += [(name, dims, ("none",), b) for name, dims in VQ_DENSE
              for b in VQ_ROWS]
    cases += [(name, dims, acts, b) for name, dims, acts in VQ_STACKS
              for b in (TRAIN_B, 8192)]
    cases += [(f"{name}:{p.tr}x{p.row_groups}/c{p.cluster}", dims, acts, b, p)
              for name, dims, acts, b in (("G", G_DIMS, G_ACTS, TRAIN_B),
                                          ("D", D_DIMS, D_ACTS, 37))
              for p in forced_plans(cuda_mlp, dims, b, False)]
    # the GEMM route, at TOL too: each output is one float32 sum of the K
    # products in k order, the plain version's in cuBLAS's order
    cases += [(f"diff_{name}", dims, ("none",), DIFF_GEN_N)
              for name, dims in DIFF_STEP]
    cases += [("gemm_ragged", [784, 400], ("none",), b)
              for b in (cuda_mlp.GEMM_MIN_ROWS + 1, DIFF_GEN_N + 1)]
    cases += [(f"gemm_{act}", [400, 784], (act,), DIFF_GEN_N + 1)
              for act in cuda_mlp.SUPPORTED_ACTS]
    cases += [("gemm_narrow", dims, ("relu",), b)
              for dims, b in (([37, 130], 5003), ([6272, 1], 4096),
                              ([128, 10], 3001))]
    cases += [("gemm_unaligned", [401, 403], ("tanh",), 3333)]
    worst = 0.0
    for name, dims, acts, b, *plan in cases:
        ws, bs = make_stack(rng, dims, "cuda")
        x = torch.from_numpy(
            rng.standard_normal((b, dims[0])).astype(np.float32)).cuda()
        if name == "gemm_unaligned":  # x and W 4 bytes past 16-byte alignment
            x = torch.cat([x.new_zeros(1), x.flatten()])[1:].view(x.shape)
            ws = [torch.cat([w.new_zeros(1), w.flatten()])[1:].view(w.shape)
                  for w in ws]
        for cdt in (None, torch.bfloat16):
            key = "bfloat16" if cdt is not None else "float32"
            gemm0 = cuda_mlp.gemm_launches
            if name == "lin" or name.startswith(("diff_", "vqp_")):  # row 2
                out, hid = linear_cuda(x, ws[0], bs[0], acts[0], 0.2, cdt), []
            elif plan:
                out, hid = cuda_mlp.launch_fwd(x, ws, bs, acts, 0.2, cdt,
                                               plan[0])
            else:
                out, hid = cuda_mlp.mlp_fwd(x, ws, bs, acts, 0.2, cdt)
            gemm = cuda_mlp.gemm_launches - gemm0
            ref, ref_hid = cuda_mlp.mlp_fwd_plain(x, ws, bs, acts, 0.2, cdt)
            torch.cuda.synchronize()
            err = max(float((a - r).abs().max())
                      for a, r in zip([out] + hid, [ref] + ref_hid))
            ok = err <= TOL[key] and all(
                bool(torch.isfinite(a).all()) for a in [out] + hid)
            route = "gemm" if gemm else "chain"
            print(f"  fwd {name:14s} {dims} {acts} B={b:5d} {key:8s} "
                  f"{route:5s} max_abs_err={err:.3e} tol={TOL[key]:.0e} "
                  f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(
                    f"mlp_fwd disagrees with its plain version: {name} "
                    f"{dims} B={b} {key}: {err} > {TOL[key]}")
            want = int(not plan and cuda_mlp.takes_gemm(len(ws), b, cdt))
            if gemm != want:
                raise AssertionError(
                    f"mlp_fwd {name} {dims} B={b} {key}: {gemm} GEMM "
                    f"launches, {want} expected")
            if key == "float32":
                worst = max(worst, err)
    return worst


def check_bwd(cuda_mlp, torch):
    """Phase 3b: every dW, db and dx against mlp_bwd_plain: the planner's
    choice at each case; G B 100 under one pass-1 plan of every cluster
    size and item height; G B 8192 at 1, 3 and 7 slices and B 1000 at 2
    and 3 (a ragged last slice). Then G B 8192 twice, bitwise equal."""
    rng = np.random.default_rng(1)
    sm = torch.cuda.get_device_properties(0).multi_processor_count
    cases = [("G", G_DIMS, G_ACTS, b, None) for b in (TRAIN_B, 8192, 37, 1)]
    cases += [("D", D_DIMS, D_ACTS, TRAIN_B, None),
              ("tanh3", [784, 96, 48, 24], ("tanh",) * 3, 37, None),
              ("clf",) + CLF_STACKS[0][1:] + (CLF_BATCHES[0], None)]
    # the conv stacks' dense layers; a 6272-wide input's pass 1 at the
    # wide chunk depth
    cases += [(name, dims, acts, TRAIN_B, None)
              for name, dims, acts in CONV_DENSE]
    cases += [("conv_enc_fc",) + CONV_DENSE[3][1:] + (8192, None),
              ("conv_d_fc",) + CONV_DENSE[2][1:] + (1000, None)]
    cases += [(name, dims, ("none",), TRAIN_B, None)
              for name, dims in DIFF_DENSE]
    cases += [(name, dims, ("none",), b, None) for name, dims in VQ_DENSE
              for b in (VQ_TRAIN_ROWS, 4900)]
    cases += [(name, dims, acts, TRAIN_B, None)
              for name, dims, acts in VQ_STACKS]
    base = cuda_mlp.bwd_plan(TRAIN_B, G_DIMS, sm)
    cases += [(f"G:{p.tr}x{p.row_groups}/c{p.cluster}", G_DIMS, G_ACTS,
               TRAIN_B, dataclasses.replace(base, rows=p))
              for p in forced_plans(cuda_mlp, G_DIMS[::-1], TRAIN_B, True)]
    cases += [(f"G:S{s}", G_DIMS, G_ACTS, b,
               cuda_mlp.bwd_plan(b, G_DIMS, sm, slices=s))
              for b, ss in ((8192, (1, 3, 7)), (1000, (2, 3))) for s in ss]
    worst = 0.0
    flat = lambda r: list(r[0]) + list(r[1]) + [r[2]]
    for name, dims, acts, b, plan in cases:
        ws, bs = make_stack(rng, dims, "cuda")
        x = torch.from_numpy(
            rng.standard_normal((b, dims[0])).astype(np.float32)).cuda()
        for cdt in (None, torch.bfloat16):
            key = "bfloat16" if cdt is not None else "float32"
            out, hid = cuda_mlp.mlp_fwd(x, ws, bs, acts, 0.2, cdt)
            dy = torch.from_numpy(rng.standard_normal(
                tuple(out.shape)).astype(np.float32)).cuda()
            if plan is None:
                got = cuda_mlp.mlp_bwd(x, hid, out, dy, ws, acts, 0.2, cdt)
            else:
                got = cuda_mlp.launch_bwd(x, hid, out, dy, ws, acts, 0.2, cdt,
                                          plan)
            ref = cuda_mlp.mlp_bwd_plain(x, hid, out, dy, ws, acts, 0.2, cdt)
            torch.cuda.synchronize()
            rel = max(float((a - r).abs().max())
                      / max(float(r.abs().max()), 1e-30)
                      for a, r in zip(flat(got), flat(ref)))
            ok = rel <= BWD_TOL[key] and all(
                bool(torch.isfinite(a).all()) for a in flat(got))
            slices = "" if plan is None else f" S={plan.slices}"
            if plan is None and dims[0] == CONV_W:
                slices = (f" kc={cuda_mlp.bwd_plan(b, dims, sm).rows.kc}")
            print(f"  bwd {name:14s} {dims} B={b:5d}{slices} {key:8s} "
                  f"max_err/max|ref|={rel:.3e} tol={BWD_TOL[key]:.0e} "
                  f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(
                    f"mlp_bwd disagrees with its plain version: {name} "
                    f"{dims} B={b} {key}: {rel} > {BWD_TOL[key]}")
            if key == "float32":
                worst = max(worst, rel)
    # the split-K sums run in a fixed order: the same inputs give the same
    # bits
    ws, bs = make_stack(rng, G_DIMS, "cuda")
    x = torch.from_numpy(
        rng.standard_normal((8192, G_DIMS[0])).astype(np.float32)).cuda()
    out, hid = cuda_mlp.mlp_fwd(x, ws, bs, G_ACTS)
    dy = torch.randn_like(out)
    runs = [flat(cuda_mlp.mlp_bwd(x, hid, out, dy, ws, G_ACTS))
            for _ in range(2)]
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(*runs))
    print(f"  bwd G B= 8192 twice ({cuda_mlp.bwd_plan(8192, G_DIMS, sm).slices}"
          f" slices): bitwise equal {same}")
    if not same:
        raise AssertionError("mlp_bwd at G B 8192 gave different bits on "
                             "the same inputs")
    return worst


def chunk_state(rng, torch, z=128, h=400, x=784, n_cls=0, codes=0, hd=400,
                out=1):
    """Params and non-zero Adam slots for the 8 chunk tensors (as after
    some training), as numpy planes; cgan's G takes z + n_cls lanes and
    its D x + n_cls; infogan's G takes z + its `codes` lanes and its
    critic's head is `out` (INFO_L) wide; began's critic is x -> hd -> x
    (`out` = x)."""
    p = []
    for i, o in ((z + n_cls + codes, h), (h, x), (x + n_cls, hd), (hd, out)):
        bound = 1.0 / np.sqrt(i)
        p += [rng.uniform(-bound, bound, (i, o)).astype(np.float32),
              rng.uniform(-bound, bound, (o,)).astype(np.float32)]
    mu = [rng.normal(0, 1e-3, a.shape).astype(np.float32) for a in p]
    nu = [rng.uniform(0, 1e-5, a.shape).astype(np.float32) for a in p]
    return p, mu, nu


PLANE_NAMES = [f"{pl}.{t}" for pl in ("p", "mu", "nu") for t in (
    "g_w1", "g_b1", "g_w2", "g_b2", "d_w1", "d_b1", "d_w2", "d_b2")]


VAE_TENSORS = ("tr_w", "tr_b", "mu_w", "mu_b", "lv_w", "lv_b", "d1_w", "d1_b",
               "d2_w", "d2_b")


def vae_plane_names(birvae):
    ts = [t for t in VAE_TENSORS if not (birvae and t.startswith("lv"))]
    return [f"{pl}.{t}" for pl in ("p", "mu", "nu") for t in ts]


def state_err(a_planes, r_planes, names=PLANE_NAMES):
    """(worst relative L2 distance of a plane — params, mu or nu, its
    tensors together —, the tensor with the largest max abs error over
    its max |ref|, and that ratio)."""
    l2 = max(float(sum(float((a - r).pow(2).sum()) for a, r in zip(la, lr))
                   ** 0.5 / max(sum(float(r.pow(2).sum()) for r in lr)
                                ** 0.5, 1e-30))
             for la, lr in zip(a_planes, r_planes))
    pairs = [(a.double(), r.double()) for la, lr in zip(a_planes, r_planes)
             for a, r in zip(la, lr)]
    mx = [float((a - r).abs().max()) / max(float(r.abs().max()), 1e-30)
          for a, r in pairs]
    worst = int(np.argmax(mx))
    return l2, names[worst], mx[worst]


def cross_state_err(variant, got, ref, names):
    """state_err of two states' planes with the variant's residue slots
    (RESIDUE_SLOTS) held apart, as phase 3c holds them: (worst plane's
    relative L2 without them, the worst other tensor, its max error over
    its max |ref|, the residue slots' largest absolute error)."""
    residue = RESIDUE_SLOTS.get(variant, ())
    it = iter(names)
    keep_a, keep_r, kept, r_err = [], [], [], 0.0
    for la, lr in zip(got, ref):
        keep_a.append([])
        keep_r.append([])
        for a, r in zip(la, lr):
            name = next(it)
            if name in residue:
                r_err = max(r_err, float((a.double() - r.double()).abs().max()))
            else:
                keep_a[-1].append(a)
                keep_r[-1].append(r)
                kept.append(name)
    return state_err(keep_a, keep_r, kept) + (r_err,)


def tie_free_case(what, make, run_ref, margin_at=TIE_MARGIN):
    """The tie rule (TIE_MARGIN): `make(seed)` draws a case's data with
    numpy, `run_ref(case, probe)` runs the float64 plain version on it,
    leaving the smallest relative pre-activation under probe["margin"]
    (and stopping at the first one at or below the margin), and for began
    the smallest relative |pixel - reconstruction| where r (1 - r) >
    1e-3 under probe["abs_margin"] (the same margin). Returns (the
    first case from TIE_FIRST_SEED that clears the margin, what run_ref
    returned for it)."""
    from generative_models_tpu_torch.ops.cuda_train import Tie
    passed = []
    for seed in range(TIE_FIRST_SEED, TIE_FIRST_SEED + TIE_MAX_SEEDS):
        case = make(seed)
        probe = {"stop_at": margin_at}
        try:
            ref = run_ref(case, probe)
        except Tie:
            ref = None
        # began: |pixel - reconstruction| by the same rule (sign flips)
        margin = min(float(probe["margin"]),
                     float(probe.get("abs_margin", math.inf)))
        if margin > margin_at:
            over = ", ".join(f"{sd} ({m:.1e})" for sd, m in passed[-6:])
            print(f"  {what}: data seed {seed}, smallest |pre-activation| / "
                  f"rms = {margin:.2e} > {margin_at:.0e}; passed over "
                  f"{len(passed)} seed(s) from {TIE_FIRST_SEED}"
                  + (f", the last: {over}" if passed else ""))
            return case, ref
        passed.append((seed, margin))
    raise AssertionError(f"{what}: no seed of {TIE_MAX_SEEDS} clears the tie "
                         f"margin {margin_at}")


# (variant, d_steps, ChunkHyper fields beside the defaults, lam before)
CHUNK_CASES = (
    ("nsgan", 1, {}, 0.0), ("mmgan", 1, {}, 0.0), ("nsgan", 2, {}, 0.0),
    ("lsgan", 1, {}, 0.0),
    ("wgan", 5, dict(optimizer="rmsprop", clip=0.01, g_lr=5e-5, d_lr=5e-5),
     0.0),
    ("fgan", 1, dict(fgan_div="jensen_shannon"), 0.0),
    ("fgan", 1, dict(fgan_div="kl", fgan_ns=True), 0.0),
    ("fgan", 1, dict(fgan_div="total_variation"), 0.0),
    ("ragan", 1, dict(eps=COUPLED_ADAM_EPS), 0.0),
    ("fishergan", 1, dict(eps=COUPLED_ADAM_EPS, fisher_rho=1e-2), 0.3),
    ("wgangp", 5, dict(g_lr=1e-4, d_lr=1e-4, b2=0.9, gp_lam=GP_LAM), 0.0),
    ("dragan", 1, dict(gp_lam=GP_LAM), 0.0),
    ("cgan", 1, dict(n_cls=N_CLS), 0.0),
    ("infogan", 1, dict(g_lr=1e-3, info_cat=INFO_CAT, info_cont=INFO_CONT,
                        info_lam=INFO_LAM), 0.0),
    ("began", 1, dict(began_gamma=BEGAN_GAMMA, began_lambda_k=BEGAN_LK),
     BEGAN_K0),
    # the RMSprop kernels of three hooks (wgangp's since ROADMAP Queue 2
    # item 6(e); d_steps 2, so that the tie rule finds data)
    ("wgangp", 2, dict(optimizer="rmsprop", g_lr=1e-4, d_lr=1e-4,
                       gp_lam=GP_LAM), 0.0),
    ("infogan", 1, dict(optimizer="rmsprop", g_lr=1e-3, info_cat=INFO_CAT,
                        info_cont=INFO_CONT, info_lam=INFO_LAM), 0.0),
    ("began", 1, dict(optimizer="rmsprop", began_gamma=BEGAN_GAMMA,
                      began_lambda_k=BEGAN_LK), BEGAN_K0),
)


def chunk_dims(hp):
    """chunk_state's keywords for a case's hyperparameters."""
    if hp.variant == "infogan":
        return dict(n_cls=0, codes=INFO_CAT + INFO_CONT, out=INFO_L)
    if hp.variant == "began":
        return dict(n_cls=0, hd=BEGAN_HD, out=784)
    return dict(n_cls=hp.n_cls)


def code_rows_np(rng, n):
    """infogan's z rows as numpy: z ⊕ onehot(cat) ⊕ cont."""
    return np.concatenate([
        rng.standard_normal((n, 128), dtype=np.float32),
        np.eye(INFO_CAT, dtype=np.float32)[rng.integers(0, INFO_CAT, n)],
        rng.uniform(-1, 1, (n, INFO_CONT)).astype(np.float32)], 1)


def chunk_streams(rng, torch, variant, steps, ds, n_cls=0):
    """A chunk's streams on the card, drawn with numpy: xs [rows, 784 (+
    labels)], zd [rows, 128 (+ labels)], zg [steps*B, 128 (+ the labels
    of each step's last critic batch)] and the penalty's xtra (wgangp:
    eps [rows, 1]; dragan: x_hat = x + 0.5 std(x) u per critic batch;
    else None); infogan's zd and zg rows are its code rows; began's x
    pixels are 0 or 1, as MNIST's nearly are (a real pixel then never
    ties with its reconstruction)."""
    rows = steps * ds * TRAIN_B
    cuda = lambda a: torch.from_numpy(a).cuda()
    xs = rng.random((rows, 784), dtype=np.float32)
    if variant == "began":
        xs = (xs < 0.25).astype(np.float32)
    if variant == "infogan":
        zd, zg = code_rows_np(rng, rows), code_rows_np(rng, steps * TRAIN_B)
    else:
        zd = rng.standard_normal((rows, 128), dtype=np.float32)
        zg = rng.standard_normal((steps * TRAIN_B, 128), dtype=np.float32)
    xtra = None
    if variant in PENALTY_LANES:
        u = rng.random((rows, PENALTY_LANES[variant]), dtype=np.float32)
        if variant == "dragan":
            xb = xs.reshape(steps * ds, TRAIN_B, 784)
            std = xb.std(axis=(1, 2), keepdims=True, dtype=np.float64)
            u = (xb + np.float32(DRAGAN_SCALE) * std.astype(np.float32)
                 * u.reshape(xb.shape)).reshape(rows, 784)
        xtra = cuda(np.ascontiguousarray(u))
    if n_cls:
        y = np.eye(n_cls, dtype=np.float32)[rng.integers(0, n_cls, rows)]
        xs = np.concatenate([xs, y], 1)
        zd = np.concatenate([zd, y], 1)
        yg = y.reshape(steps, ds, TRAIN_B, n_cls)[:, -1].reshape(-1, n_cls)
        zg = np.concatenate([zg, yg], 1)
    return cuda(xs), cuda(zd), cuda(zg), xtra


def chunk_hyper(cuda_train, variant, **kw):
    base = dict(g_lr=2e-4, d_lr=2e-4, b1=0.5, b2=0.999, eps=1e-8, slope=0.2,
                variant=variant)
    base.update(kw)
    return cuda_train.ChunkHyper(**base)


def held_state_err(variant, got, ref, names):
    """state_err over every tensor but the variant's residue slots, and
    the largest absolute error of those slots: (rel L2, worst tensor, its
    max error over its max |ref|, residue abs error)."""
    residue = RESIDUE_SLOTS.get(variant, ())
    flat = lambda pl: [t for part in pl if part is not None for t in part]
    a, r = flat(got), flat(ref)
    keep = [i for i, n in enumerate(names) if n not in residue]
    l2, name, err = state_err([[a[i] for i in keep]], [[r[i] for i in keep]],
                              [names[i] for i in keep])
    r_err = max([float((a[i].double() - r[i].double()).abs().max())
                 for i, n in enumerate(names) if n in residue] or [0.0])
    return l2, name, err, r_err


def bf16_shift(p, biases, readers):
    """BF16_HIDDEN_SHIFT on the hidden `biases` (indices into the numpy
    planes p), the column means out of the `readers` weights."""
    for q in biases:
        p[q] = p[q] + np.float32(BF16_HIDDEN_SHIFT)
    for q in readers:
        p[q] = (p[q] - p[q].mean(0, keepdims=True)).astype(np.float32)


def chunk_case(torch, hp, steps, ds, seed, ema=False):
    """A chunk check's data from `seed`: ((p, mu, nu, G's EMA plane or
    None) as numpy, then chunk_streams' xs, zd, zg, xtra); began's output
    biases shifted (BEGAN_SHIFT), wgan's critic clipped."""
    variant = hp.variant
    rng = np.random.default_rng(seed)
    p, mu, nu = chunk_state(rng, torch, **chunk_dims(hp))
    if variant == "began":  # fakes near 0.88, reconstructions near 0.12:
        # no |v - r| near 0, r (1 - r) ~ 0.1 (BEGAN_SHIFT)
        p[3] = p[3] + np.float32(BEGAN_SHIFT)
        p[7] = p[7] - np.float32(BEGAN_SHIFT)
    if hp.bf16:  # hidden pre-activations away from 0 (BF16_HIDDEN_SHIFT)
        bf16_shift(p, (1, 5), (2, 6))
    if hp.clip > 0:  # a critic as the clip leaves it
        p = p[:4] + [np.clip(a, -hp.clip, hp.clip) for a in p[4:]]
    streams = chunk_streams(rng, torch, variant, steps, ds, hp.n_cls)
    # an EMA plane apart from G's parameters, as after some training
    e = ([(a + rng.normal(0, 1e-2, a.shape)).astype(np.float32)
          for a in p[:4]] if ema else None)
    return ((p, mu, nu, e),) + streams


def chunk_planes(torch, hp, state, dt):
    """chunk_case's numpy state on the card in `dt`: [p, mu (None with
    RMSprop), nu, ema (or None)]."""
    out = [None if pl is None else
           [torch.from_numpy(a.copy()).to("cuda", dt) for a in pl]
           for pl in state]
    if not hp.adam:
        out[1] = None
    return out


EMA_NAMES = [f"ema.{t}" for t in ("g_w1", "g_b1", "g_w2", "g_b2")]


def check_chunk(cuda_train, torch, cases=CHUNK_CASES, ema_decay=0.0):
    """Phase 3c (and 3i, the EMA kernels, with `ema_decay`: G's EMA plane
    held as a state plane): 8 steps of the chunk kernel vs gan_chunk_plain
    in float64, per case. Returns the worst metrics error."""
    worst = 0.0
    steps = 8
    for variant, ds, kw, lam0 in cases:
        hp = chunk_hyper(cuda_train, variant, ema_decay=ema_decay, **kw)
        kws = dict(steps=steps, ds=ds, batch=TRAIN_B, t_g=3, t_d=5, hp=hp,
                   lam=lam0)
        tag = f"chunk {variant} d_steps={ds} " + " ".join(
            f"{k}={v}" for k, v in kw.items()) + (
            f" ema_decay={ema_decay}" if ema_decay else "")
        make = lambda seed: chunk_case(torch, hp, steps, ds, seed,
                                       ema_decay > 0)
        planes = functools.partial(chunk_planes, torch, hp)

        def run_ref(case, probe):
            state, xs, zd, zg, xtra = case
            ref = planes(state, torch.float64)
            m_ref = cuda_train.gan_chunk_plain(
                xs.double(), zd.double(), zg.double(), *ref[:3], ema=ref[3],
                probe=probe, xtra=None if xtra is None else xtra.double(),
                **kws)
            return ref, m_ref

        (state, xs, zd, zg, xtra), (ref, m_ref) = tie_free_case(
            tag, make, run_ref, TIE_MARGIN_OF.get(variant, TIE_MARGIN))
        got, f32 = planes(state, torch.float32), planes(state, torch.float32)
        m = cuda_train.gan_chunk(xs, zd, zg, *got[:3], ema=got[3], xtra=xtra,
                                 **kws)
        cuda_train.gan_chunk_plain(xs, zd, zg, *f32[:3], ema=f32[3],
                                   xtra=xtra, **kws)
        torch.cuda.synchronize()
        m_err = float((m - m_ref).abs().max())
        residue = RESIDUE_SLOTS.get(variant, ())
        r_tol = RESIDUE_ABS_TOL.get(variant, 0.0)
        names = [n for n in PLANE_NAMES if hp.adam or not n.startswith("mu.")]
        names += EMA_NAMES if ema_decay else []
        s_l2, s_name, s_err, r_err = held_state_err(variant, got, ref, names)
        _, f32_name, f32_err, _ = held_state_err(variant, f32, ref, names)
        lam_err = abs(float(m[-1, 7]) - float(m_ref[-1, 7]))
        ok = (m_err <= CHUNK_TOL["metrics"] and s_err <= CHUNK_TOL["state"]
              and r_err <= r_tol and lam_err <= LAM_TOL
              and bool(torch.isfinite(m).all()))
        if variant == "fishergan":  # the multiplier moved, and came out
            ok = ok and abs(float(m[-1, 7]) - lam0) > 1e-3
        if variant == "began":  # k_t moved and came out; M in lane 6
            ok = ok and float(m[-1, 7]) != lam0 and bool((m[:, 6] > 0).all())
        if variant == "infogan":  # both MI terms, lane 2 zero
            ok = ok and bool((m[:, 1] > 0).all() and (m[:, 6] > 0).all()
                             and (m[:, 2] == 0).all())
        if hp.clip > 0:
            ok = ok and all(float(t.abs().max()) <= hp.clip
                            for t in got[0][4:])
        pen = ""
        if hp.gp_lam:  # the penalty's lanes: gp, mean norm
            ok = ok and bool((m[:, 4] > 0).all() and (m[:, 5] > 0).all())
            pen = (f" gp {float(m[-1, 4]):.4f} (ref {float(m_ref[-1, 4]):.4f})"
                   f" grad_norm {float(m[-1, 5]):.4f} (ref "
                   f"{float(m_ref[-1, 5]):.4f})")
        print(f"  {tag} steps={steps} B={TRAIN_B} vs plain(float64): "
              f"metrics_max_abs_err={m_err:.3e} (tol "
              f"{CHUNK_TOL['metrics']:.0e}) state max_err/max={s_err:.3e} "
              f"({s_name}; tol {CHUNK_TOL['state']:.0e}) rel L2={s_l2:.3e}"
              + (f" residue slots {residue} abs err {r_err:.2e} (tol "
                 f"{r_tol:.0e})" if residue else "")
              + (f" lam {lam0} -> {float(m[-1, 7]):.6f} (ref "
                 f"{float(m_ref[-1, 7]):.6f})" if variant in ("fishergan",
                                                               "began")
                 else "")
              + (f" M {float(m[-1, 6]):.6f} (ref {float(m_ref[-1, 6]):.6f})"
                 if variant == "began" else "")
              + (f" mi {float(m[-1, 1]):.6f} (ref {float(m_ref[-1, 1]):.6f})"
                 f" g_mi {float(m[-1, 6]):.6f} (ref "
                 f"{float(m_ref[-1, 6]):.6f})" if variant == "infogan"
                 else "") + pen
              + f" {'ok' if ok else 'FAIL'}; plain(float32) vs "
              f"plain(float64): max_err/max={f32_err:.3e} ({f32_name})")
        if not ok:
            raise AssertionError(f"gan_chunk disagrees with its plain "
                                 f"version: {tag}")
        worst = max(worst, m_err)
    return worst


def synthetic_split(n, seed):
    """A small split of the synthetic digits as the trainer takes it."""
    from generative_models_tpu_torch.data.mnist import synthetic_mnist
    return synthetic_mnist(n_train=n, n_test=200, seed=seed)


# the cross-check's and the main paths' configurations beside the
# registry defaults
CROSS_CASES = (("nsgan", {}), ("lsgan", {}), ("wgan", {}), ("fgan", {}),
               ("ragan", {"adam_eps": COUPLED_ADAM_EPS}),
               ("fishergan", {"adam_eps": COUPLED_ADAM_EPS,
                              "fisher_rho": 1e-2}),
               ("wgangp", {"adam_eps": COUPLED_ADAM_EPS}), ("dragan", {}),
               ("cgan", {}), ("began", {}))
# The same three at the default eps (1e-8), where the two float32 paths
# drift apart by more than CROSS_TOL (see COUPLED_ADAM_EPS): each path,
# kernel and general step, is held to a float64 run of the chunk's plain
# version over the same 20 steps, streams and noise instead, by the same
# limits. infogan too (at COUPLED_ADAM_EPS): the two float32 paths read
# 1.08e-2 apart on the card; a CPU run of this phase saw its general
# step's mu plane jump away from the float64 run at steps 5, 7, 8, 15 and
# 19 (from 1e-6 to 4.5e-3 relative L2), a hidden unit flipping at each,
# while the chunk's plain version stayed within 3.5e-7 of it.
F64_CASES = (("wgangp", {}), ("ragan", {}),
             ("fishergan", {"fisher_rho": 1e-2}),
             ("infogan", {"adam_eps": COUPLED_ADAM_EPS}))


@contextlib.contextmanager
def chunk_in_float64(cuda_train, torch):
    """Within it, build_fused_many_steps's kernel call runs the plain version
    in float64 on float64 copies of the streams and planes (one sub-chunk
    a chunk here), rounding the planes back to float32 at its end."""
    kernel = cuda_train.gan_chunk

    def plain64(xs, zd, zg, p, mu, nu, *, xtra=None, lam=0.0, **kw):
        pl64 = [None if pl is None else [t.double() for t in pl]
                for pl in (p, mu, nu)]
        m = cuda_train.gan_chunk_plain(
            xs.double(), zd.double(), zg.double(), *pl64, lam=lam,
            xtra=None if xtra is None else xtra.double(), **kw)
        for pl, pl_ref in zip((p, mu, nu), pl64):
            for t, r in zip(pl or [], pl_ref or []):
                t.copy_(r)
        return m
    cuda_train.gan_chunk = plain64
    try:
        yield
    finally:
        cuda_train.gan_chunk = kernel


def cross_check(cuda_train, step_lib, torch):
    """Phase 3d: 20 steps of the chunk kernel vs 20 of the general step
    (mlp_fwd/mlp_bwd + the optimizer's torch ops) from one state, batches
    and noise, per variant (wgan at its registry defaults: RMSprop,
    d_steps 5, clip); and, for F64_CASES at the default eps, each of the
    two against a float64 run of the chunk's plain version."""
    from generative_models_tpu_torch.config import variant_config
    from generative_models_tpu_torch.losses.registry import get_variant
    data = synthetic_split(2000, seed=3)
    images = torch.from_numpy(data["x_train"].reshape(2000, -1)).cuda()
    labels = torch.from_numpy(data["y_train"]).cuda()
    cases = [(v, kw, False) for v, kw in CROSS_CASES] + [
        (v, kw, True) for v, kw in F64_CASES]
    for n, (variant, kw, f64) in enumerate(cases):
        cfg = variant_config(variant, batch_size=TRAIN_B, dtype="float32",
                             **kw)
        spec = get_variant(variant)
        ds = max(cfg.d_steps, 1)
        state = step_lib.init_adversarial_state(
            spec, cfg, torch.Generator().manual_seed(0), "cuda")
        if variant == "fishergan":
            state["vstate"] = {"lam": torch.tensor(0.3, device="cuda")}
        x_all = images
        if variant == "began":  # a k_t above 0: the fake term trains too;
            # no pixel near its reconstruction (BEGAN_SHIFT): 0/1 pixels,
            # fakes near 0.88, reconstructions near 0.12
            state["vstate"] = {"k": torch.tensor(BEGAN_K0, device="cuda"),
                               "m": torch.tensor(0.0, device="cuda")}
            state["g_params"][1]["b"] = state["g_params"][1]["b"] + BEGAN_SHIFT
            state["d_params"][1]["b"] = state["d_params"][1]["b"] - BEGAN_SHIFT
            x_all = (images > 0.5).float()
        per_epoch = 2000 // (TRAIN_B * ds)
        rel = torch.arange(20, device="cuda") * TRAIN_B * ds

        torch.manual_seed(n)  # each case's draws whatever ran before it
        perm = torch.stack([torch.randperm(2000, device="cuda")
                            for _ in range(20 // per_epoch + 2)])
        if variant == "infogan":  # code rows
            gen = torch.Generator(device="cuda").manual_seed(n)
            zd = step_lib.draw_z(gen, (20, ds, TRAIN_B), cfg, "cuda")
            zg = step_lib.draw_z(gen, (20, TRAIN_B), cfg, "cuda")
        else:
            zd = torch.randn(20, ds, TRAIN_B, 128, device="cuda")
            zg = torch.randn(20, TRAIN_B, 128, device="cuda")
        drawn = [zd, zg]
        if variant in PENALTY_LANES:  # the penalty's draw
            drawn.append(torch.rand(20, ds, TRAIN_B, PENALTY_LANES[variant],
                                    device="cuda"))
        noise = lambda k0, n: tuple(t[k0:k0 + n] for t in drawn)
        args = (x_all, labels, perm, rel, noise)
        s_f, m_f = cuda_train.build_fused_many_steps(spec, cfg, per_epoch)(
            state, *args)
        s_g, m_g = step_lib.build_many_steps(spec, cfg, per_epoch)(
            state, *args)
        pairs = [("chunk kernel", "general step", s_f, m_f, s_g, m_g)]
        if f64:
            with chunk_in_float64(cuda_train, torch):
                s_64, m_64 = cuda_train.build_fused_many_steps(
                    spec, cfg, per_epoch)(state, *args)
            pairs = [(what, "plain(float64)", s, m, s_64, m_64)
                     for what, s, m in (("chunk kernel", s_f, m_f),
                                        ("general step", s_g, m_g))]
        torch.cuda.synchronize()
        if set(m_f) != set(m_g):
            raise AssertionError(f"{variant}: metric keys {sorted(m_f)} vs "
                                 f"{sorted(m_g)}")
        for what, ref_name, s_a, m_a, s_r, m_r in pairs:
            check_cross_pair(cuda_train, variant, cfg, ds, what, ref_name,
                             s_a, m_a, s_r, m_r)


def check_cross_pair(cuda_train, variant, cfg, ds, what, ref_name, s_a, m_a,
                     s_r, m_r):
    """One cross-check comparison: `what`'s 20-step state and metrics
    against the reference's, by CROSS_TOL and the residue slots."""
    m_err = max(float((m_a[k] - m_r[k]).abs().max()) for k in m_r)
    some = lambda pl: [p for p in pl if p is not None]
    names = [n for n in PLANE_NAMES
             if cfg.optimizer == "adam" or not n.startswith("mu.")]
    s_err, s_name, s_max, r_err = cross_state_err(
        variant, some(cuda_train.state_planes(s_a)),
        some(cuda_train.state_planes(s_r)), names)
    ok = (m_err <= CROSS_TOL["metrics"] and s_err <= CROSS_TOL["state"]
          and r_err <= RESIDUE_ABS_TOL.get(variant, 0.0))
    lam = "" if variant not in RESIDUE_SLOTS else (
        f" residue slots abs err {r_err:.2e}")
    for key, start in (("lam", 0.3), ("k", BEGAN_K0)):
        if key in s_r["vstate"]:  # the carried scalar moved, alike
            la, lr = float(s_a["vstate"][key]), float(s_r["vstate"][key])
            ok = ok and abs(la - lr) <= CROSS_TOL["metrics"] and la != start
            lam = f" {key} {start} -> {la:.6f} / {lr:.6f}"
    print(f"  {variant} {what} vs {ref_name}, 20 steps (d_steps {ds}, "
          f"{cfg.optimizer}, adam_eps {cfg.adam_eps:g}): metrics_max_abs_err="
          f"{m_err:.3e} (tol {CROSS_TOL['metrics']:.0e}) state rel L2="
          f"{s_err:.3e} (tol {CROSS_TOL['state']:.0e}; worst element "
          f"{s_name} {s_max:.3e} of its max){lam} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"the {variant} {what} and the {ref_name} "
                             f"disagree")


def check_reparam(cuda_reparam, torch):
    """Phase 3e: the sampling kernel against its plain version (the same
    seed and offset reproduce the kernel's eps) and the backward kernel
    against the plain rule (dkl as given and as a mean's expanded
    cotangent), at the four shapes; the backward through autograd; the
    forward's z and kl bitwise equal across two calls; the moments of its
    noise. Returns (the worst z error, the worst backward error)."""
    rng = np.random.default_rng(7)
    worst, worst_bwd = 0.0, 0.0
    rel = lambda a, r: float((a - r).abs().max()) / float(r.abs().max())
    for b, l in ((TRAIN_B, VAE_L), (8192, VAE_L), (37, VAE_L), (64, 200)):
        mu = torch.from_numpy(rng.normal(size=(b, l)).astype(np.float32)).cuda()
        lv = torch.from_numpy(
            (rng.normal(size=(b, l)) * 0.3).astype(np.float32)).cuda()
        seed = torch.tensor([b * 7919 + 1, l * 104729 + 3], device="cuda")
        offset = b + (l << 33)
        z, kl = cuda_reparam.reparam_fwd(mu, lv, seed, offset)
        z2, kl2 = cuda_reparam.reparam_fwd(mu, lv, seed, offset)
        z_ref, kl_ref = cuda_reparam.reparam_and_kl_plain(mu, lv, seed, offset)
        dz = torch.from_numpy(rng.normal(size=(b, l)).astype(np.float32)).cuda()
        dkl = torch.from_numpy(rng.normal(size=(b,)).astype(np.float32)).cuda()
        # the backward kernel against the plain rule; dkl also stride 0
        b_err = max(rel(a, r) for d in (dkl, dkl[:1].expand(b))
                    for a, r in zip(cuda_reparam.reparam_bwd(mu, lv, z, dz, d),
                                    cuda_reparam.reparam_bwd_plain(
                                        mu, lv, z, dz, d)))
        # and through autograd
        gm, gl = mu.clone().requires_grad_(True), lv.clone().requires_grad_(True)
        zz, kk = cuda_reparam.ReparamFunction.apply(gm, gl, seed, offset)
        dmu, dlv = torch.autograd.grad([zz, kk], [gm, gl], [dz, dkl])
        g_err = max(rel(a, r) for a, r in zip(
            (dmu, dlv), cuda_reparam.reparam_bwd_plain(mu, lv, z_ref, dz, dkl)))
        torch.cuda.synchronize()
        z_err = float((z - z_ref).abs().max())
        kl_err = rel(kl, kl_ref)
        repeat = torch.equal(z, z2) and torch.equal(kl, kl2)
        ok = (z_err <= REPARAM_TOL["z"] and kl_err <= REPARAM_TOL["kl"]
              and max(b_err, g_err) <= REPARAM_TOL["grad"]
              and torch.equal(zz, z) and repeat
              and bool(torch.isfinite(z).all()))
        print(f"  reparam [{b}, {l}] vs plain (reproduced eps): "
              f"z_max_abs_err={z_err:.3e} (tol {REPARAM_TOL['z']:.0e}) "
              f"kl max_err/max={kl_err:.3e} (tol {REPARAM_TOL['kl']:.0e}); "
              f"two calls bitwise equal {repeat}; reparam_bwd vs the plain "
              f"rule max_err/max={b_err:.3e}, through autograd {g_err:.3e} "
              f"(tol {REPARAM_TOL['grad']:.0e}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"reparam disagrees with its plain version "
                                 f"at [{b}, {l}]")
        worst = max(worst, z_err)
        worst_bwd = max(worst_bwd, b_err, g_err)
    # mu = 0, logvar = 0: z is eps itself
    zero = torch.zeros(65536, VAE_L, device="cuda")
    seed = torch.tensor([2024, 10], device="cuda")
    e0, kl0 = cuda_reparam.reparam_fwd(zero, zero, seed, 0)
    e0b, _ = cuda_reparam.reparam_fwd(zero, zero, seed, 0)
    e1, _ = cuda_reparam.reparam_fwd(zero, zero, seed, 1)
    e2, _ = cuda_reparam.reparam_fwd(zero, zero, seed + 1, 0)
    torch.cuda.synchronize()
    mean, var = float(e0.mean()), float(e0.var())
    ok = (abs(mean) <= REPARAM_MOMENTS and abs(var - 1.0) <= REPARAM_MOMENTS
          and torch.equal(e0, e0b) and not torch.equal(e0, e1)
          and not torch.equal(e0, e2)
          and float((e0 - e1).abs().mean()) > 0.5
          and float((e0 - e2).abs().mean()) > 0.5
          and float(kl0.abs().max()) == 0.0
          and bool(torch.isfinite(e0).all()))
    print(f"  reparam eps over {e0.numel()} draws: mean={mean:.3e} "
          f"var={var:.5f} max|eps|={float(e0.abs().max()):.3f} (tol "
          f"{REPARAM_MOMENTS:.0e}); same offset equal, other offset or seed "
          f"distinct {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the reparam kernel's noise failed its checks")
    return worst, worst_bwd


def vae_state(rng, birvae):
    """Params and non-zero Adam slots of the VAE family's chunk tensors
    at full width, as numpy planes in the kernel's order."""
    x, h, l = VAE_X, VAE_H, VAE_L
    dims = [(x, h), (h, l)] + ([] if birvae else [(h, l)]) + [(l, h), (h, x)]
    p = []
    for i, o in dims:
        bound = 1.0 / np.sqrt(i)
        p += [rng.uniform(-bound, bound, (i, o)).astype(np.float32),
              rng.uniform(-bound, bound, (o,)).astype(np.float32)]
    mu = [rng.normal(0, 1e-3, a.shape).astype(np.float32) for a in p]
    nu = [rng.uniform(0, 1e-5, a.shape).astype(np.float32) for a in p]
    return p, mu, nu


def vae_hyper(ctv, variant, recon, **kw):
    from generative_models_tpu_torch.config import variant_config
    if variant == "birvae":
        kw["adam_eps"] = BIRVAE_ADAM_EPS
    return ctv.VaeHyper.from_config(
        variant_config(variant, vae_recon=recon, **kw))


def vae_case(torch, birvae, steps, seed, ema=False, bf16=False):
    """A VAE-family check's data from `seed`: ((p, mu, nu, the EMA plane or
    None) as numpy, xs, eps on the card); with `bf16` the trunk's and the
    decoder's hidden biases shifted (BF16_HIDDEN_SHIFT)."""
    rng = np.random.default_rng(seed)
    p, mu, nu = vae_state(rng, birvae)
    if bf16:  # the trunk's and the decoder's hidden biases; the heads
        # and the output read them
        bf16_shift(p, (1, 5) if birvae else (1, 7),
                   (2, 6) if birvae else (2, 4, 8))
    xs = torch.from_numpy(rng.random((steps * TRAIN_B, VAE_X),
                                     dtype=np.float32)).cuda()
    es = torch.from_numpy(rng.standard_normal((steps * TRAIN_B, VAE_L),
                                              dtype=np.float32)).cuda()
    e = ([(a + rng.normal(0, 1e-2, a.shape)).astype(np.float32) for a in p]
         if ema else None)
    return (p, mu, nu, e), xs, es


def vae_planes(torch, state, dt):
    return [None if pl is None else
            [torch.from_numpy(a.copy()).to("cuda", dt) for a in pl]
            for pl in state]


def check_vae_chunk(ctv, torch, cases=VAE_CASES, ema_decay=0.0):
    """Phase 3f (and 3i, the EMA kernels, with `ema_decay`: the EMA plane
    held as a state plane): 8 steps of the VAE / BIR-VAE chunk kernels vs
    their plain versions in float64. Returns {variant: worst metrics
    error}."""
    worst = {"vae": 0.0, "birvae": 0.0}
    steps = 8
    for variant, recon in cases:
        birvae = variant == "birvae"
        hp = vae_hyper(ctv, variant, recon, ema_decay=ema_decay)
        kw = dict(steps=steps, batch=TRAIN_B, t=3, hp=hp)
        kernel = ctv.birvae_chunk if birvae else ctv.vae_chunk
        plain = ctv.birvae_chunk_plain if birvae else ctv.vae_chunk_plain
        make = lambda seed: vae_case(torch, birvae, steps, seed,
                                     ema_decay > 0)
        planes = functools.partial(vae_planes, torch)

        def run_ref(case, probe):
            state, xs, es = case
            ref = planes(state, torch.float64)
            return ref, plain(xs.double(), es.double(), *ref[:3], ema=ref[3],
                              probe=probe, **kw)

        (state, xs, es), (ref, m_ref) = tie_free_case(
            f"chunk {variant} {recon}"
            + (f" ema_decay={ema_decay}" if ema_decay else ""), make, run_ref)
        got, f32 = planes(state, torch.float32), planes(state, torch.float32)
        m = kernel(xs, es, *got[:3], ema=got[3], **kw)
        plain(xs, es, *f32[:3], ema=f32[3], **kw)
        torch.cuda.synchronize()
        names = vae_plane_names(birvae)
        if ema_decay:
            names += [n.replace("p.", "ema.", 1) for n in names
                      if n.startswith("p.")]
        m_err = float((m - m_ref).abs().max()) / float(m_ref.abs().max())
        s_l2, s_name, s_err, r_err = held_state_err(variant, got, ref, names)
        _, f32_name, f32_err, f32_r = held_state_err(variant, f32, ref, names)
        r_tol = RESIDUE_ABS_TOL.get(variant, 0.0)
        ok = (m_err <= VAE_CHUNK_TOL["metrics"]
              and s_err <= VAE_CHUNK_TOL["state"] and r_err <= r_tol
              and bool(torch.isfinite(m).all()))
        print(f"  chunk {variant} {recon} adam_eps={hp.eps:g} "
              f"ema_decay={hp.ema_decay:g} steps={steps} "
              f"B={TRAIN_B} vs plain(float64): metrics max_err/max="
              f"{m_err:.3e} (tol {VAE_CHUNK_TOL['metrics']:.0e}; loss "
              f"{float(m_ref[0, 0]):.3f} -> {float(m_ref[-1, 0]):.3f}) state "
              f"max_err/max={s_err:.3e} ({s_name}; tol "
              f"{VAE_CHUNK_TOL['state']:.0e}) rel L2={s_l2:.3e}"
              + (f" residue slots {RESIDUE_SLOTS[variant]} abs err "
                 f"{r_err:.2e} (tol {r_tol:.0e}; plain(float32) {f32_r:.2e})"
                 if birvae else "")
              + f" {'ok' if ok else 'FAIL'}; plain(float32) vs "
              f"plain(float64): max_err/max={f32_err:.3e} ({f32_name})")
        if not ok:
            raise AssertionError(
                f"{variant}_chunk ({recon}) disagrees with its plain version "
                f"(worst tensor {s_name})")
        worst[variant] = max(worst[variant], m_err)
    return worst


def cross_check_vae(cuda_train, ctv, step_lib, torch):
    """Phase 3g: 20 steps of each VAE-family chunk kernel vs 20 of the
    general step (mlp_fwd/mlp_bwd + autograd + Adam) from one state,
    batches and eps (handed to both as tensors)."""
    from generative_models_tpu_torch.config import variant_config
    from generative_models_tpu_torch.losses.registry import get_variant
    data = synthetic_split(1000, seed=3)
    images = torch.from_numpy(data["x_train"].reshape(1000, -1)).cuda()
    labels = torch.from_numpy(data["y_train"]).cuda()
    torch.manual_seed(0)  # its draws whatever ran before it
    perm = torch.stack([torch.randperm(1000, device="cuda") for _ in range(4)])
    rel = torch.arange(20, device="cuda") * TRAIN_B
    eps = torch.randn(20, TRAIN_B, VAE_L, device="cuda")
    noise = lambda k0, n: eps[k0:k0 + n]
    for variant, recon in VAE_CASES:
        kw = {"adam_eps": BIRVAE_ADAM_EPS} if variant == "birvae" else {}
        cfg = variant_config(variant, batch_size=TRAIN_B, dtype="float32",
                             vae_recon=recon, **kw)
        spec = get_variant(variant)
        state = step_lib.init_state(spec, cfg,
                                    torch.Generator().manual_seed(0), "cuda")
        args = (images, labels, perm, rel, noise)
        s_f, m_f = cuda_train.build_fused_many_steps(spec, cfg, 10)(
            state, *args)
        s_g, m_g = step_lib.build_many_steps(spec, cfg, 10)(state, *args)
        torch.cuda.synchronize()
        m_err = max(float((m_f[k] - m_g[k]).abs().max())
                    / float(m_g[k].abs().max()) for k in m_g)
        s_err, s_name, s_max, r_err = cross_state_err(
            variant, ctv.state_planes(s_f), ctv.state_planes(s_g),
            vae_plane_names(variant == "birvae"))
        ok = (m_err <= CROSS_TOL["metrics"] and s_err <= CROSS_TOL["state"]
              and r_err <= RESIDUE_ABS_TOL.get(variant, 0.0))
        print(f"  {variant} {recon} chunk kernel vs general step, 20 steps: "
              f"metrics max_err/max={m_err:.3e} (tol "
              f"{CROSS_TOL['metrics']:.0e}) state rel L2={s_err:.3e} (tol "
              f"{CROSS_TOL['state']:.0e}; worst element {s_name} "
              f"{s_max:.3e} of its max)"
              + (f" residue slots {RESIDUE_SLOTS[variant]} abs err "
                 f"{r_err:.2e} (tol {RESIDUE_ABS_TOL[variant]:.0e})"
                 if variant in RESIDUE_SLOTS else "")
              + f" {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"the {variant} chunk kernel and the "
                                 f"general step disagree")


def write_layout_checkpoint(path: str, seed: int, leaves_shapes,
                            step: int) -> None:
    """A checkpoint in the JAX package's npz layout from (key path, shape,
    fan-in) triples (listed in jax.tree_util's order: dict keys sorted),
    random weights drawn in that order with torch-default init bounds
    (1/sqrt of the fan-in), and `step`."""
    rng = np.random.default_rng(seed)
    leaves = []
    for path_, shape, fan_in in leaves_shapes:
        bound = 1.0 / np.sqrt(fan_in)
        leaves.append((path_, rng.uniform(-bound, bound, shape).astype(
            np.float32)))
    leaves.append(("['step']", np.array(step, dtype=np.int32)))
    flat = {f"leaf_{i:05d}": a for i, (_, a) in enumerate(leaves)}
    meta = json.dumps([{"path": p, "shape": list(a.shape), "dtype": str(a.dtype)}
                       for p, a in leaves])
    np.savez(path, **flat, __meta__=np.array(meta))


def layer_leaves(prefix, k, n):
    return [(f"{prefix}['b']", (n,), k), (f"{prefix}['w']", (k, n), k)]


def write_jax_layout_checkpoint(path: str, seed: int, n_cls: int = 0) -> None:
    """A full-width G + D checkpoint (nsgan's, and wgan's: the same
    stacks, no carried scalar; cgan's with `n_cls` label lanes on both
    inputs) in the JAX package's npz layout: G and D params and step."""
    g_dims = [G_DIMS[0] + n_cls] + G_DIMS[1:]
    d_dims = [D_DIMS[0] + n_cls] + D_DIMS[1:]
    write_layout_checkpoint(path, seed, [
        lf for key, dims in (("d_params", d_dims), ("g_params", g_dims))
        for i, (k, n) in enumerate(zip(dims[:-1], dims[1:]))
        for lf in layer_leaves(f"['{key}'][{i}]", k, n)], 1234)


def reset(*mods):
    from generative_models_tpu_torch.ops import cuda_linear, penalty
    penalty.plain_passes = 0
    cuda_linear.launches = 0
    for m in mods:
        for name in ("launches", "bwd_launches", "birvae_launches",
                     "ema_launches", "bf16_launches"):
            if hasattr(m, name):
                setattr(m, name, 0)


def drive_serving(cuda_mlp, cuda_train, torch):
    """Phase 4a. Returns (mlp_fwd launches, max error vs plain)."""
    from generative_models_tpu_torch import cli
    from generative_models_tpu_torch.train.trainer import Trainer

    ckpt = os.path.join(OUT_DIR, "nsgan_full.npz")
    write_jax_layout_checkpoint(ckpt, seed=0)

    buf = io.StringIO()
    reset(cuda_mlp, cuda_train)
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["--variant", "nsgan", "--ckpt", ckpt, "--sample-only",
                       "--out-dir", OUT_DIR])
    cli_launches = cuda_mlp.launches
    print("  " + buf.getvalue().strip())
    line = json.loads(buf.getvalue().strip().splitlines()[-1])
    if rc != 0 or line["step"] != 1234 or not os.path.getsize(line["samples"]):
        raise AssertionError(f"--sample-only failed: rc={rc} {line}")
    if cli_launches < 1:
        raise AssertionError("--sample-only did not launch mlp_fwd")
    print(f"  cli --sample-only: rc={rc} mlp_fwd launches={cli_launches}")

    t = Trainer("nsgan")  # the card, by default
    t.load_model(ckpt)
    z = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (8192, 128)).astype(np.float32)).cuda()
    reset(cuda_mlp, cuda_train)
    imgs = t.sample(z=z)
    sample_launches = cuda_mlp.launches
    g = t.generator_params
    ref, _ = cuda_mlp.mlp_fwd_plain(z, [l["w"] for l in g],
                                    [l["b"] for l in g], G_ACTS, 0.2)
    err = float(np.abs(imgs - ref.cpu().numpy()).max())
    ok = (imgs.shape == (8192, 784) and np.isfinite(imgs).all()
          and imgs.min() >= 0.0 and imgs.max() <= 1.0
          and err <= TOL["float32"] and sample_launches >= 1)
    print(f"  Trainer.sample(n=8192): shape={imgs.shape} "
          f"range=[{imgs.min():.4f}, {imgs.max():.4f}] launches="
          f"{sample_launches} max_abs_err_vs_plain={err:.3e} "
          f"tol={TOL['float32']:.0e} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("Trainer.sample failed its checks")
    return cli_launches + sample_launches, err


def drive_wgan_sample_only(mods):
    """Phase 4e: --sample-only from a full-width wgan checkpoint in the
    JAX layout (params and step alone). Returns the mlp_fwd launches."""
    from generative_models_tpu_torch import cli
    ckpt = os.path.join(OUT_DIR, "wgan_full.npz")
    write_jax_layout_checkpoint(ckpt, seed=2)
    buf = io.StringIO()
    reset(*mods)
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["--variant", "wgan", "--ckpt", ckpt, "--sample-only",
                       "--out-dir", OUT_DIR])
    launches = mods[0].launches
    line = json.loads(buf.getvalue().strip().splitlines()[-1])
    ok = (rc == 0 and line["variant"] == "wgan" and line["step"] == 1234
          and launches >= 1 and os.path.getsize(line["samples"]) > 0)
    print(f"  wgan cli --sample-only: rc={rc} {line} mlp_fwd launches="
          f"{launches} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("wgan --sample-only failed")
    return launches


def drive_cgan_sample_only(mods, torch):
    """Phase 4f: --sample-only from a full-width cgan checkpoint in the
    JAX layout (G 138->400->784), and Trainer.sample(n=100) against the
    plain G on z and the class-cycled labels. Returns (mlp_fwd launches,
    max error vs plain)."""
    from generative_models_tpu_torch import cli
    from generative_models_tpu_torch.train.trainer import Trainer
    cuda_mlp = mods[0]
    ckpt = os.path.join(OUT_DIR, "cgan_full.npz")
    write_jax_layout_checkpoint(ckpt, seed=3, n_cls=N_CLS)
    buf = io.StringIO()
    reset(*mods)
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["--variant", "cgan", "--ckpt", ckpt, "--sample-only",
                       "--out-dir", OUT_DIR])
    cli_launches = cuda_mlp.launches
    line = json.loads(buf.getvalue().strip().splitlines()[-1])
    t = Trainer("cgan")
    t.load_model(ckpt)
    z = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (TRAIN_B, 128)).astype(np.float32)).cuda()
    reset(*mods)
    imgs = t.sample(z=z)
    sample_launches = cuda_mlp.launches
    labels = torch.arange(TRAIN_B, device="cuda") % N_CLS
    zy = torch.cat([z, torch.nn.functional.one_hot(labels, N_CLS).float()], 1)
    g = t.generator_params
    ref, _ = cuda_mlp.mlp_fwd_plain(zy, [l["w"] for l in g],
                                    [l["b"] for l in g], G_ACTS, 0.2)
    err = float(np.abs(imgs - ref.cpu().numpy()).max())
    ok = (rc == 0 and line["variant"] == "cgan" and line["step"] == 1234
          and cli_launches >= 1 and os.path.getsize(line["samples"]) > 0
          and imgs.shape == (TRAIN_B, 784) and np.isfinite(imgs).all()
          and err <= TOL["float32"] and sample_launches >= 1)
    print(f"  cgan cli --sample-only: rc={rc} {line} mlp_fwd launches="
          f"{cli_launches}; Trainer('cgan').sample(z) with labels i % "
          f"{N_CLS}: launches={sample_launches} max_abs_err_vs_plain="
          f"{err:.3e} tol={TOL['float32']:.0e} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("cgan --sample-only failed its checks")
    return cli_launches + sample_launches, err


def drive_began_infogan_sample_only(mods, torch):
    """Phase 4g: --sample-only from full-width began (D 784->400->784) and
    infogan (G 140->400->784; D trunk 784->400, d_head 400->1, q_head
    400->14) checkpoints in the JAX layout; infogan's Trainer.sample(z)
    grid (class i % 10, cont 0) against the plain G on those code rows.
    Returns ({variant: mlp_fwd launches}, max error vs plain)."""
    from generative_models_tpu_torch import cli
    from generative_models_tpu_torch.train.trainer import Trainer
    cuda_mlp = mods[0]
    g = lambda zin: (layer_leaves("['g_params'][0]", zin, 400)
                     + layer_leaves("['g_params'][1]", 400, 784))
    shapes = {
        "began": (layer_leaves("['d_params'][0]", 784, BEGAN_HD)
                  + layer_leaves("['d_params'][1]", BEGAN_HD, 784) + g(128)),
        "infogan": (layer_leaves("['d_params']['d_head']", 400, 1)
                    + layer_leaves("['d_params']['q_head']", 400, INFO_L - 1)
                    + layer_leaves("['d_params']['trunk'][0]", 784, 400)
                    + g(128 + INFO_CAT + INFO_CONT))}
    launches, err = {}, 0.0
    for n, variant in enumerate(("began", "infogan")):
        ckpt = os.path.join(OUT_DIR, f"{variant}_full.npz")
        write_layout_checkpoint(ckpt, 5 + n, shapes[variant], 1234)
        buf = io.StringIO()
        reset(*mods)
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["--variant", variant, "--ckpt", ckpt,
                           "--sample-only", "--out-dir", OUT_DIR])
        launches[variant] = cuda_mlp.launches
        line = json.loads(buf.getvalue().strip().splitlines()[-1])
        ok = (rc == 0 and line["variant"] == variant and line["step"] == 1234
              and launches[variant] >= 1
              and os.path.getsize(line["samples"]) > 0)
        if variant == "infogan":
            t = Trainer("infogan")
            t.load_model(ckpt)
            z = torch.from_numpy(np.random.default_rng(8).standard_normal(
                (TRAIN_B, 128)).astype(np.float32)).cuda()
            reset(*mods)
            imgs = t.sample(z=z)
            launches[variant] += cuda_mlp.launches
            cat = torch.arange(TRAIN_B, device="cuda") % INFO_CAT
            zc = torch.cat([z, torch.nn.functional.one_hot(cat, INFO_CAT)
                            .float(), torch.zeros(TRAIN_B, INFO_CONT,
                                                  device="cuda")], 1)
            gp = t.generator_params
            ref, _ = cuda_mlp.mlp_fwd_plain(zc, [l["w"] for l in gp],
                                            [l["b"] for l in gp], G_ACTS, 0.2)
            err = float(np.abs(imgs - ref.cpu().numpy()).max())
            ok = (ok and imgs.shape == (TRAIN_B, 784)
                  and np.isfinite(imgs).all() and err <= TOL["float32"])
        print(f"  {variant} cli --sample-only: rc={rc} {line} mlp_fwd "
              f"launches={launches[variant]}"
              + (f"; Trainer('infogan').sample(z), class i % {INFO_CAT}, "
                 f"cont 0: max_abs_err_vs_plain={err:.3e} tol="
                 f"{TOL['float32']:.0e}" if variant == "infogan" else "")
              + f" {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{variant} --sample-only failed its checks")
    return launches, err


def launch_counts(mods):
    """Each wrapper's launches; the EMA and bf16 keys count the launches
    of those kernels among the chunk kernels' (the GAN chunk's; the VAE
    family's, vae and birvae together)."""
    from generative_models_tpu_torch.ops import cuda_linear
    cuda_mlp, cuda_train, cuda_reparam, ctv = mods
    return {"gan_chunk": cuda_train.launches, "mlp_fwd": cuda_mlp.launches,
            "linear_cuda": cuda_linear.launches,
            "mlp_bwd": cuda_mlp.bwd_launches, "reparam": cuda_reparam.launches,
            "reparam_bwd": cuda_reparam.bwd_launches,
            "vae_chunk": ctv.launches, "birvae_chunk": ctv.birvae_launches,
            "gan_chunk_ema": cuda_train.ema_launches,
            "gan_chunk_bf16": cuda_train.bf16_launches,
            "vae_family_ema": ctv.ema_launches,
            "vae_family_bf16": ctv.bf16_launches}


# the keys of the CLI's final `eval` dict; a metrics.jsonl record holds
# them too, and fishergan's also the carried multiplier
LOSS_KEYS = {"nsgan": ("d_loss", "d_real", "d_fake", "g_loss"),
             "wgangp": ("d_loss", "w_estimate", "gp", "grad_norm", "g_loss"),
             "dragan": ("d_loss", "gp", "grad_norm", "g_loss"),
             "cgan": ("d_loss", "d_real", "d_fake", "g_loss"),
             "lsgan": ("d_loss", "d_real", "d_fake", "g_loss"),
             "wgan": ("d_loss", "w_estimate", "g_loss"),
             "fgan": ("d_loss", "f_bound", "g_loss"),
             "ragan": ("d_loss", "g_loss"),
             "fishergan": ("d_loss", "ipm", "omega", "constraint", "g_loss"),
             "began": ("d_loss", "began_l_real", "began_l_fake_d", "g_loss",
                       "began_l_fake_g"),
             "infogan": ("d_loss", "mi_loss", "g_loss", "g_mi_loss"),
             "vae": ("loss", "recon_loss", "kl_loss"),
             "birvae": ("loss", "recon_loss", "latent_power")}
RECORD_KEYS = dict(LOSS_KEYS, fishergan=LOSS_KEYS["fishergan"]
                   + ("vstate_lam",),
                   began=LOSS_KEYS["began"] + ("vstate_k", "vstate_m"))
CLI_GAN = ("nsgan", "lsgan", "wgan", "fgan", "ragan", "fishergan", "wgangp",
           "dragan", "cgan", "began", "infogan")
CLI_VARIANTS = CLI_GAN + ("vae", "birvae")


# the CLI's runs with the EMA plane and bf16 operands (phase 4b)
EMA_BF16_FLAGS = ("--ema-decay", str(EMA_DECAY), "--dtype", "bfloat16")
CLI_EMA_BF16 = ("nsgan", "vae")


# Phase 4b's depth: CLI_STEPS steps in chunks of CLI_CHUNK, so two
# launches of the chunk kernel a run; the VAE family's loss falls over it
# (the last CLI_WINDOW steps' mean below the first CLI_WINDOW's). It was
# 1000 steps in chunks of 500 until the smoke neared its time limit; the
# chunk kernels' long runs are timed in 5b and 5f.
CLI_STEPS, CLI_CHUNK, CLI_WINDOW = 200, 100, 50


def drive_training_cli(variant, mods, torch, flags=()):
    """Phase 4b: the CLI's training run of `variant`, fused_step auto ->
    its chunk kernel, CLI_STEPS steps in chunks of CLI_CHUNK; with EMA_BF16_FLAGS
    the EMA and bf16 kernel's (its launches counted as such, the
    checkpoint's EMA plane finite and apart from the parameters).
    Returns (launch counts, the run's JSON line)."""
    from generative_models_tpu_torch import cli
    run_dir = os.path.join(OUT_DIR, "train_ema_bf16" if flags else "train")
    buf = io.StringIO()
    reset(*mods)
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["--variant", variant, "--dataset", "synthetic",
                       "--steps", str(CLI_STEPS), "--scan-steps",
                       str(CLI_CHUNK), "--echo-every", str(CLI_CHUNK),
                       "--out-dir", run_dir,
                       "--ckpt", os.path.join(run_dir, f"{variant}_trained"),
                       *flags])
    counts = launch_counts(mods)
    out = buf.getvalue().strip()
    print("  " + out.replace("\n", "\n  "))
    line = json.loads([l for l in out.splitlines() if l.startswith("{")][-1])
    vdir = os.path.join(run_dir, variant)
    with open(os.path.join(vdir, "metrics.jsonl")) as f:
        recs = [json.loads(l) for l in f]
    keys = LOSS_KEYS[variant]
    finite = all(math.isfinite(r[k]) for r in recs
                 for k in RECORD_KEYS[variant])
    gan = variant not in ("vae", "birvae")
    chunk = "gan_chunk" if gan else f"{variant}_chunk"
    others = [k for k in ("gan_chunk", "vae_chunk", "birvae_chunk")
              if k != chunk]
    new = 2 if flags else 0  # the EMA and bf16 kernels' launches
    fam = "gan_chunk" if gan else "vae_family"
    ok = (rc == 0 and line["steps"] == CLI_STEPS and len(recs) == CLI_STEPS
          and finite and counts[chunk] == 2
          and all(counts[k] == 0 for k in others)
          and counts[f"{fam}_ema"] == counts[f"{fam}_bf16"] == new
          and sorted(line["eval"]) == sorted(keys)
          and all(math.isfinite(v) for v in line["eval"].values())
          and os.path.getsize(os.path.join(vdir, "final.png")) > 0
          and any(os.path.exists(os.path.join(vdir, f"loss.{e}"))
                  for e in ("png", "csv")))
    falling = ""
    if variant == "wgan":  # the critic ends inside the clip, biases too
        from generative_models_tpu_torch.utils.checkpoint import read_leaves
        leaves = read_leaves(os.path.join(run_dir, "wgan_trained"))
        d_max = max(float(np.abs(a).max()) for k, a in leaves.items()
                    if k.startswith("['d_params']"))
        ok = ok and d_max <= 0.01 and "['d_opt'][0].count" not in leaves
        falling = f" max|D| = {d_max:.6f} (clip 0.01)"
    if variant == "fishergan":  # the multiplier moves and is recorded
        lams = [r["vstate_lam"] for r in recs]
        ok = ok and lams[-1] != lams[0] != 0.0
        falling = f" vstate_lam {lams[0]:.3e} -> {lams[-1]:.3e}"
    if variant == "began":  # k_t in [0, 1] and M recorded every step
        ks = [r["vstate_k"] for r in recs]
        ok = ok and all(0.0 <= v <= 1.0 for v in ks)
        falling = (f" vstate_k {ks[0]:.3e} -> {ks[-1]:.3e} vstate_m "
                   f"{recs[0]['vstate_m']:.4f} -> {recs[-1]['vstate_m']:.4f}")
    if variant == "infogan":  # G's MI term recorded every step
        ok = ok and all(r["g_mi_loss"] > 0.0 for r in recs)
        falling = (f" mi_loss {recs[0]['mi_loss']:.4f} -> "
                   f"{recs[-1]['mi_loss']:.4f} g_mi_loss "
                   f"{recs[0]['g_mi_loss']:.4f} -> {recs[-1]['g_mi_loss']:.4f}")
    if variant in PENALTY_LANES:  # the penalty is recorded every step
        gps = [r["gp"] for r in recs]
        ok = ok and all(v > 0.0 for v in gps)
        falling = (f" gp {gps[0]:.4f} -> {gps[-1]:.4f} grad_norm "
                   f"{recs[0]['grad_norm']:.4f} -> {recs[-1]['grad_norm']:.4f}")
    if flags:  # the EMA plane went through the checkpoint
        from generative_models_tpu_torch.utils.checkpoint import read_leaves
        leaves = read_leaves(os.path.join(run_dir, f"{variant}_trained"))
        key = "['g_ema']" if gan else "['ema']"
        ema = {k[len(key):]: a for k, a in leaves.items() if k.startswith(key)}
        pre = "['g_params']" if gan else "['params']"
        live = {k[len(pre):]: a for k, a in leaves.items()
                if k.startswith(pre)}
        ok = ok and set(ema) == set(live) and all(
            np.isfinite(a).all() for a in ema.values()) and any(
            not np.array_equal(ema[k], live[k]) for k in ema)
        falling += (f" EMA plane {len(ema)} tensors, max |ema - p| "
                    f"{max(float(np.abs(ema[k] - live[k]).max()) for k in ema):.3e}"
                    if set(ema) == set(live) and ema else " no EMA plane")
    if not gan:  # a GAN's losses do not fall; a VAE's must
        first = float(np.mean([r["loss"] for r in recs[:CLI_WINDOW]]))
        last = float(np.mean([r["loss"] for r in recs[-CLI_WINDOW:]]))
        ok = ok and last < first
        falling += (f" loss first{CLI_WINDOW}={first:.3f} "
                    f"last{CLI_WINDOW}={last:.3f}")
    print(f"  cli training {variant} {' '.join(flags)}: rc={rc} "
          f"steps={line['steps']} records="
          f"{len(recs)} finite={finite}{falling} launches={counts} "
          f"{'ok' if ok else 'FAIL'}")
    os.remove(os.path.join(run_dir, f"{variant}_trained.npz"))  # 8 MB each
    if not ok:
        raise AssertionError(f"the CLI training run of {variant} failed its "
                             f"checks")
    return counts, line


# Phase 4h: the CLI's run of nsgan and of vae (as in 4b) again with
# --score-samples --export-sampler and a sample grid every
# SCORE_SAMPLE_EVERY steps. The scorer (cli.py::_score) launches the MLP
# kernels CLF_LAUNCHES times: CLF_STEPS training steps of one forward and
# one backward launch (784->128->10 at B 256), the accuracy on the 10,000
# test images, t.sample(1024), the scores of those samples and FID's two
# feature passes (784->128 at B 1024 and 1024 test images): one forward
# each. The accuracy must exceed 0.9 (the reference test's bar on these
# digits) and every score must be finite. The artifact, loaded on the card
# and on the CPU, repeats bit for bit for a seed and matches
# Trainer.sample given the same Philox z within TOL["float32"] (the card's
# forward kernel against aten ops, and the CPU's transcendentals in the
# noise). The run's grids make a GIF.
SCORE_SAMPLE_EVERY = 500
CLF_STEPS = 500
CLF_LAUNCHES = {"mlp_fwd": CLF_STEPS + 5, "mlp_bwd": CLF_STEPS}
SCORE_VARIANTS = ("nsgan", "vae")
EXPORT_SEED = 20261017


def drive_score_export(variant, mods, torch):
    """Phase 4h. Returns (the run's launch counts with the scorer's MLP
    launches apart as clf_mlp_fwd and clf_mlp_bwd, the quality line)."""
    from generative_models_tpu_torch import cli
    from generative_models_tpu_torch.train.trainer import Trainer
    from generative_models_tpu_torch.utils import export, gif
    cuda_mlp = mods[0]
    run_dir = os.path.join(OUT_DIR, "score")
    ckpt = os.path.join(run_dir, f"{variant}_trained")
    art = os.path.join(run_dir, f"{variant}_sampler.pt2")
    clf = {}
    score = cli._score

    def counted(t):
        before = cuda_mlp.launches, cuda_mlp.bwd_launches
        out = score(t)
        clf["mlp_fwd"] = cuda_mlp.launches - before[0]
        clf["mlp_bwd"] = cuda_mlp.bwd_launches - before[1]
        return out

    buf = io.StringIO()
    reset(*mods)
    cli._score = counted
    try:
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["--variant", variant, "--dataset", "synthetic",
                           "--steps", "1000", "--scan-steps", "500",
                           "--echo-every", "500", "--out-dir", run_dir,
                           "--sample-every", str(SCORE_SAMPLE_EVERY),
                           "--ckpt", ckpt, "--score-samples",
                           "--export-sampler", art])
    finally:
        cli._score = score
    counts = launch_counts(mods)
    out = buf.getvalue().strip().splitlines()
    print("  " + "\n  ".join(out))
    line = json.loads(next(l for l in out
                           if l.startswith('{"classifier_test_acc"')))
    chunk = "gan_chunk" if variant == "nsgan" else "vae_chunk"
    ok = (rc == 0 and counts[chunk] == 2 and clf == CLF_LAUNCHES
          and line["classifier_test_acc"] > 0.9
          and all(math.isfinite(v) for v in line.values())
          and out[-2] == f"saved: {ckpt}.npz" and out[-1] == f"exported: {art}")
    print(f"  cli {variant} --score-samples --export-sampler: rc={rc} "
          f"{line}; the scorer's MLP launches {clf} (expect {CLF_LAUNCHES}) "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"the scoring and export run of {variant} "
                             f"failed its checks")
    t = Trainer(variant, dataset="synthetic")
    t.load_model(ckpt)
    n = t.cfg.sample_n
    z = export.sampler_noise(torch.tensor(EXPORT_SEED, device="cuda"), n,
                             export.noise_width(t.spec, t.cfg))
    ref = t.sample(z=z)
    errs, same = {}, {}
    for dev in ("cuda", "cpu"):
        fn = export.load_sampler(art, dev)
        a, b = fn(EXPORT_SEED), fn(EXPORT_SEED)
        same[dev] = (torch.equal(a, b) and a.shape == (n, 784)
                     and a.device.type == dev)
        errs[dev] = float(np.abs(a.cpu().numpy() - ref).max())
    other = export.load_sampler(art, "cuda")(EXPORT_SEED + 1)
    vdir = os.path.join(run_dir, variant)
    pngs = sorted(glob.glob(os.path.join(vdir, "step*.png"))) + [
        os.path.join(vdir, "final.png")]
    path = gif.pngs_to_gif(pngs, os.path.join(vdir, "training.gif"))
    with open(path, "rb") as f:
        data = f.read()
    frames = data.count(b"\x21\xF9\x04")
    ok = (all(same.values()) and max(errs.values()) <= TOL["float32"]
          and not np.array_equal(other.cpu().numpy(), ref)
          and data[:6] == b"GIF89a" and frames == len(pngs) == 3)
    print(f"  {variant} sampler artifact ({os.path.getsize(art)} bytes), "
          f"seed {EXPORT_SEED}: repeats bit for bit {same}; vs Trainer.sample "
          f"with the same Philox z max_abs_err {errs} (tol "
          f"{TOL['float32']:.0e}); another seed other images; GIF of "
          f"{frames} frames from {[os.path.basename(p) for p in pngs]}, "
          f"{len(data)} bytes {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"the {variant} sampler artifact or GIF failed")
    os.remove(ckpt + ".npz")
    counts.update({f"clf_{k}": v for k, v in clf.items()})
    return counts, line


# launches a step of the general step: (mlp_fwd, mlp_bwd, reparam,
# reparam_bwd)
# A critic update runs 3 forwards (G, D on x, D on the fake) and 2
# backwards, the G update 2 and 2: 5 and 4 at d_steps 1, 5 * 3 + 2 = 17
# and 5 * 2 + 2 = 12 for wgan at d_steps 5; ragan's G loss also runs D on
# the real batch, one more forward and no backward.
# wgangp launches as wgan, and its penalty's critic pass (twice
# differentiable, so plain torch ops: ops/penalty.py) runs once a critic
# update: PENALTY_PASSES a step.
# began's critic (the autoencoder) and infogan's (trunk and both heads as
# one stack; its MI term reads the fake's pass of the D loss) launch as
# nsgan's.
GENERAL_LAUNCHES = {"nsgan": (5, 4, 0, 0), "wgan": (17, 12, 0, 0),
                    "wgangp": (17, 12, 0, 0), "ragan": (6, 4, 0, 0),
                    "began": (5, 4, 0, 0), "infogan": (5, 4, 0, 0),
                    "vae": (4, 4, 1, 1), "birvae": (3, 3, 0, 0)}
PENALTY_PASSES = {"wgangp": 5}
# (halved from nsgan 200, wgan and wgangp 60, the rest 100 when the smoke
# neared its time limit)
GENERAL_STEPS = (("nsgan", 100), ("wgan", 30), ("wgangp", 30), ("ragan", 50),
                 ("began", 50), ("infogan", 50), ("vae", 50),
                 ("birvae", 50))


def drive_training_general(variant, steps, mods, torch):
    """Phase 4c: Trainer(fused_step=False).train(steps). Returns (launch
    counts, steps/s on the host's clock)."""
    from generative_models_tpu_torch.train.trainer import Trainer
    t = Trainer(variant, fused_step=False, dataset="synthetic",
                out_dir=os.path.join(OUT_DIR, "general"))
    t._load_data()  # the split's upload is set-up, not the path
    from generative_models_tpu_torch.ops import penalty
    reset(*mods)
    hist = t.train(steps=steps)
    counts = launch_counts(mods)
    passes = penalty.plain_passes
    finite = all(math.isfinite(v) for vs in hist.values() for v in vs)
    fwd, bwd, rep, rep_bwd = GENERAL_LAUNCHES[variant]
    want = {"gan_chunk": 0, "mlp_fwd": fwd * steps, "mlp_bwd": bwd * steps,
            "linear_cuda": 0,
            "reparam": rep * steps, "reparam_bwd": rep_bwd * steps,
            "vae_chunk": 0, "birvae_chunk": 0,
            "gan_chunk_ema": 0, "gan_chunk_bf16": 0, "vae_family_ema": 0,
            "vae_family_bf16": 0}
    pen = PENALTY_PASSES.get(variant, 0)
    ok = (counts == want and finite and passes == pen * steps
          and all(len(v) == steps for v in hist.values()))
    sps = steps / t.wall_time
    print(f"  Trainer({variant!r}, fused_step=False).train(steps={steps}): "
          f"launches={counts} (expect {fwd} fwd + {bwd} bwd + {rep} reparam "
          f"+ {rep_bwd} reparam_bwd a step); the penalty's plain critic "
          f"passes {passes} (expect {pen} a step) finite={finite} "
          f"{sps:.1f} steps/s "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"the general step's {variant} run failed")
    return counts, sps


# Phase 4c's spectral runs: the CLI with --spectral-projection trains
# nsgan through the general step (the chunk kernels refuse the
# projection, as the reference's do), SN_STEPS steps in each sn_mode. D's
# largest singular value (SVD, float64) must end at most sn_target (1 +
# SN_SIGMA_TOL): the fresh estimate is exact at the target after each
# projection (a scale leaves power iteration's vectors as they were) and
# lies below the true sigma by the iteration's error; the amortized one
# trails the weights by one critic update (a CPU run at full width read
# 1 + 3.5e-6 after 40 steps, the fresh form 1 + 8e-8).
SN_STEPS, SN_SIGMA_TOL = 60, 1e-4


def drive_spectral_cli(mods, torch):
    """Phase 4c: ``--spectral-projection`` (nsgan, fused_step auto) in both
    sn_modes: no chunk launch, the general step's MLP kernels, D's sigma
    at most sn_target, the amortized vectors in the checkpoint. Returns
    the launch counts of the two runs."""
    from generative_models_tpu_torch import cli
    from generative_models_tpu_torch.utils.checkpoint import read_leaves
    run_dir = os.path.join(OUT_DIR, "spectral")
    reset(*mods)
    for mode in ("amortized", "fresh"):
        ck = os.path.join(run_dir, f"nsgan_{mode}")
        buf = io.StringIO()
        before = launch_counts(mods)
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["--variant", "nsgan", "--dataset", "synthetic",
                           "--steps", str(SN_STEPS), "--scan-steps", "30",
                           "--echo-every", "0", "--spectral-projection",
                           "--sn-mode", mode, "--out-dir", run_dir,
                           "--ckpt", ck])
        counts = {k: v - before[k] for k, v in launch_counts(mods).items()}
        leaves = read_leaves(ck)
        sigmas = [float(torch.linalg.svdvals(torch.from_numpy(a).double())[0])
                  for k, a in sorted(leaves.items())
                  if k.startswith("['d_params']") and a.ndim == 2]
        sn = {k: a.shape for k, a in leaves.items() if k.startswith("['sn_v']")}
        ok = (rc == 0 and counts["gan_chunk"] == 0
              and counts["mlp_fwd"] >= 5 * SN_STEPS  # (+ eval, samples)
              and counts["mlp_bwd"] == 4 * SN_STEPS
              and all(sg <= 1.0 * (1 + SN_SIGMA_TOL) for sg in sigmas)
              and len(sigmas) == 2
              and (sn == {"['sn_v'][0]['b']": (0,), "['sn_v'][0]['w']": (400,),
                          "['sn_v'][1]['b']": (0,), "['sn_v'][1]['w']": (1,)}
                   if mode == "amortized" else not sn))
        print(f"  cli nsgan --spectral-projection --sn-mode {mode} "
              f"({SN_STEPS} steps): rc={rc} launches gan_chunk="
              f"{counts['gan_chunk']} mlp_fwd={counts['mlp_fwd']} mlp_bwd="
              f"{counts['mlp_bwd']}; D's sigma (SVD) "
              + ", ".join(f"{sg:.7f}" for sg in sigmas)
              + f" (sn_target 1.0, tol {SN_SIGMA_TOL:.0e}); sn_v leaves "
              f"{len(sn)} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"the spectral projection's {mode} CLI run "
                                 "failed its checks")
    return launch_counts(mods)


def write_vae_checkpoint(path: str, seed: int) -> None:
    """A full-width vae checkpoint in the JAX package's npz layout (key
    paths as jax.tree_util.keystr prints them, dict keys sorted)."""
    x, h, l = VAE_X, VAE_H, VAE_L
    write_layout_checkpoint(path, seed, (
        layer_leaves("['params']['decoder'][0]", l, h)
        + layer_leaves("['params']['decoder'][1]", h, x)
        + layer_leaves("['params']['encoder']['logvar']", h, l)
        + layer_leaves("['params']['encoder']['mu']", h, l)
        + layer_leaves("['params']['encoder']['trunk'][0]", x, h)), 4321)


def drive_vae_serving(mods, torch):
    """Phase 4d: --sample-only from a vae checkpoint in the JAX layout and
    Trainer.sample(8192) against the plain decoder. Returns (mlp_fwd
    launches, max error vs plain)."""
    from generative_models_tpu_torch import cli
    from generative_models_tpu_torch.train.trainer import Trainer
    cuda_mlp = mods[0]
    ckpt = os.path.join(OUT_DIR, "vae_full.npz")
    write_vae_checkpoint(ckpt, seed=1)
    buf = io.StringIO()
    reset(*mods)
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["--variant", "vae", "--ckpt", ckpt, "--sample-only",
                       "--out-dir", OUT_DIR])
    cli_launches = cuda_mlp.launches
    print("  " + buf.getvalue().strip())
    line = json.loads(buf.getvalue().strip().splitlines()[-1])
    if (rc != 0 or line["step"] != 4321 or cli_launches < 1
            or not os.path.getsize(line["samples"])):
        raise AssertionError(f"vae --sample-only failed: rc={rc} {line} "
                             f"launches={cli_launches}")
    t = Trainer("vae")
    t.load_model(ckpt)
    z = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (8192, VAE_L)).astype(np.float32)).cuda()
    reset(*mods)
    imgs = t.sample(z=z)
    sample_launches = cuda_mlp.launches
    dec = t.generator_params["decoder"]
    ref, _ = cuda_mlp.mlp_fwd_plain(z, [l["w"] for l in dec],
                                    [l["b"] for l in dec], G_ACTS, 0.2)
    err = float(np.abs(imgs - ref.cpu().numpy()).max())
    ok = (imgs.shape == (8192, VAE_X) and np.isfinite(imgs).all()
          and imgs.min() >= 0.0 and imgs.max() <= 1.0
          and err <= TOL["float32"] and sample_launches >= 1)
    print(f"  vae cli --sample-only: rc={rc} mlp_fwd launches={cli_launches}; "
          f"Trainer('vae').sample(n=8192): shape={imgs.shape} launches="
          f"{sample_launches} max_abs_err_vs_plain={err:.3e} "
          f"tol={TOL['float32']:.0e} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the vae Trainer.sample failed its checks")
    return cli_launches + sample_launches, err


# Phase 4i: the conv stacks (models/conv.py) at full width, conv_channels
# 64, B 100, with torch.backends.cudnn.allow_tf32 at torch's default
# (True) for the whole phase: the conv module keeps its float32
# convolutions off TF32 itself.
# Card against CPU, the same weights and inputs: each output, and each
# gradient of sum(out * r) (every parameter leaf and the input), by max
# abs error over max |CPU|. Both sides are float32 with sums in other
# orders (a conv output sums up to 2048 products, a dense one 6272, a
# kernel's gradient up to 100 x 28 x 28 = 78,400): a few 1e-6. TF32
# rounds each operand to 11 significant bits (2^-11 = 4.9e-4 relative).
CONV_TOL = 5e-5
# One conv (the trunk's c2: 64 -> 128 channels, 14 x 14 -> 7 x 7, B 100,
# sums of 1024 products), its input and kernel gradients too, against
# float64 on the CPU, by max abs error over max |reference|.
CONV_LAYER_TOL = 1e-5
CONV_CLI = ("nsgan", "wgangp", "lsgan", "vae")
CONV_STEPS = 50   # (200, then 100, until the smoke neared its time limit)
# The CLI's conv runs (the general step: fused_step "auto" refuses conv)
# launch, a training step: (mlp_fwd, mlp_bwd, reparam, reparam_bwd); a
# batch of evaluate's 10 (mlp_fwd, reparam); and one G forward a sample
# grid (the final one, and one when the run crosses an epoch of the
# 60,000-row split). Every dense layer of the conv stacks is one
# linear_cuda call, so linear_cuda counts what mlp_fwd counts. wgangp
# adds the penalty's plain critic pass: 5 a step, 1 an eval batch.
CONV_LAUNCHES = {"nsgan": ((5, 4, 0, 0), (5, 0)),
                 "lsgan": ((5, 4, 0, 0), (5, 0)),
                 "wgangp": ((17, 12, 0, 0), (5, 0)),
                 "vae": ((4, 4, 1, 1), (4, 1))}
EVAL_BATCHES = 10


def conv_stack_cases(cfg_of, torch):
    """(name, params on the CPU, fn(params, inputs) -> outputs,
    inputs(seed) on the CPU) of every conv stack at full width, B
    TRAIN_B."""
    from generative_models_tpu_torch.models import conv
    gen = torch.Generator().manual_seed(13)
    nc, wg, bi, vae = (cfg_of("nsgan"), cfg_of("wgangp"), cfg_of("began"),
                       cfg_of("vae"))
    info, cg = cfg_of("infogan"), cfg_of("cgan")

    def draw(kind):
        def inputs(seed):
            rng = np.random.default_rng(seed)
            shape = {"x": (TRAIN_B, 784), "z": (TRAIN_B, nc.z_dim),
                     "zl": (TRAIN_B, vae.latent_dim)}[kind[0]]
            a = (rng.random(shape) if kind[0] == "x"
                 else rng.standard_normal(shape))
            out = [torch.from_numpy(a.astype(np.float32))]
            if len(kind) > 1:  # cgan's labels
                out.append(torch.from_numpy(rng.integers(0, 10, TRAIN_B)))
            return out
        return inputs
    return [
        ("generator", conv.generator_init(gen, nc),
         lambda p, a: conv.generator_apply(p, a[0], nc), draw(["z"])),
        ("discriminator", conv.discriminator_init(gen, nc),
         lambda p, a: conv.discriminator_apply(p, a[0], nc), draw(["x"])),
        ("discriminator_plain", conv.discriminator_init(gen, wg),
         lambda p, a: conv.discriminator_apply_plain(p, a[0], wg),
         draw(["x"])),
        ("cond_discriminator", conv.cond_discriminator_init(gen, cg),
         lambda p, a: conv.cond_discriminator_apply(p, a[0], a[1], cg),
         draw(["x", "y"])),
        ("encoder", conv.encoder_init(gen, vae),
         lambda p, a: conv.encoder_apply(p, a[0], vae), draw(["x"])),
        ("decoder_logits", conv.decoder_init(gen, vae),
         lambda p, a: conv.decoder_apply(p, a[0], vae, logits=True),
         draw(["zl"])),
        ("began_d", conv.began_d_init(gen, bi),
         lambda p, a: conv.began_d_apply(p, a[0], bi), draw(["x"])),
        ("infogan_d", conv.infogan_d_init(gen, info),
         lambda p, a: conv.infogan_d_apply(p, a[0], info), draw(["x"])),
    ]


def conv_margin(fn, params, inputs, torch):
    """The tie rule's measure for a conv stack: the smallest |pre-
    activation| / rms of any ReLU or LeakyReLU (the conv layers', the
    GroupNorms' and the dense layers') in a float64 forward on the CPU.
    A pre-activation within float32 rounding of 0 takes the other side of
    the kink on the card than on the CPU, a jump of the function (one
    such ReLU after the VAE decoder's second GroupNorm moved up1's kernel
    gradient by 1e-2 of its max), not an error of either."""
    from generative_models_tpu_torch.models import conv
    from generative_models_tpu_torch.ops import linear
    from generative_models_tpu_torch.utils.tree import tree_map
    seen = [math.inf]
    real = conv.apply_act

    def probe(x, act, slope=0.2):
        if act in ("relu", "leaky_relu"):
            rms = float(x.pow(2).mean().sqrt())
            seen.append(float(x.abs().min()) / max(rms, 1e-300))
        return real(x, act, slope)
    conv.apply_act = linear.apply_act = probe
    try:
        with torch.no_grad():
            fn(tree_map(lambda t: t.double(), params),
               [u.double() if u.is_floating_point() else u for u in inputs])
    finally:
        conv.apply_act = linear.apply_act = real
    return min(seen)


def check_conv_stacks(mods, torch):
    """Phase 4i: every conv stack's forward and backward on the card (its
    dense layers through the MLP kernels) against the CPU's plain path,
    the same weights and inputs; the inputs drawn from the first seed from
    TIE_FIRST_SEED that clears the tie rule (conv_margin > TIE_MARGIN).
    Returns the worst relative error."""
    from generative_models_tpu_torch.config import variant_config
    from generative_models_tpu_torch.utils.tree import tree_leaves, tree_map
    worst = 0.0
    for name, params, fn, draw in conv_stack_cases(
            lambda v: variant_config(v, arch="conv"), torch):
        passed = []
        for seed in range(TIE_FIRST_SEED, TIE_FIRST_SEED + TIE_MAX_SEEDS):
            margin = conv_margin(fn, params, draw(seed), torch)
            if margin > TIE_MARGIN:
                break
            passed.append(seed)
        else:
            raise AssertionError(f"conv {name}: no seed clears the tie rule")
        inputs = draw(seed)
        outs, grads, n = {}, {}, {}
        for dev in ("cuda", "cpu"):
            rng = np.random.default_rng(32)  # the same cotangents
            p = tree_map(lambda a: a.to(dev).requires_grad_(True), params)
            a = [u.to(dev) for u in inputs]
            a = [u.requires_grad_(True) if u.is_floating_point() else u
                 for u in a]
            reset(*mods)
            out = fn(p, a)
            out = out if isinstance(out, tuple) else (out,)
            r = [torch.from_numpy(rng.standard_normal(tuple(o.shape))
                                  .astype(np.float32)).to(dev) for o in out]
            leaves = tree_leaves(p) + [u for u in a if u.requires_grad]
            g = torch.autograd.grad(sum((o * ri).sum()
                                        for o, ri in zip(out, r)), leaves)
            if dev == "cuda":
                torch.cuda.synchronize()
            n[dev] = (mods[0].launches, mods[0].bwd_launches)
            outs[dev] = [o.detach().cpu() for o in out]
            grads[dev] = [u.cpu() for u in g]

        def rel(a, b):
            return float((a - b).abs().max()) / max(float(b.abs().max()),
                                                    1e-30)
        f_err = max(rel(a, b) for a, b in zip(outs["cuda"], outs["cpu"]))
        b_err = max(rel(a, b) for a, b in zip(grads["cuda"], grads["cpu"]))
        finite = all(bool(torch.isfinite(u).all())
                     for u in outs["cuda"] + grads["cuda"])
        # the plain critic (the penalty's pass) launches no kernel
        launched = min(n["cuda"]) >= 1 if name != "discriminator_plain" \
            else n["cuda"] == (0, 0)
        ok = (finite and f_err <= CONV_TOL and b_err <= CONV_TOL
              and launched and n["cpu"] == (0, 0))
        print(f"  conv {name:20s} C=64 B={TRAIN_B} (data seed {seed}, "
              f"margin {margin:.1e}, passed over {len(passed)}): "
              f"forward max_err/max|cpu| "
              f"{f_err:.3e}, backward ({len(grads['cuda'])} gradients) "
              f"{b_err:.3e} tol {CONV_TOL:.0e}; (mlp_fwd, mlp_bwd) launches "
              f"card {n['cuda']} cpu {n['cpu']} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"the conv stack {name} on the card "
                                 f"disagrees with the CPU")
        worst = max(worst, f_err, b_err)
    return worst


def check_conv_tf32(torch):
    """Phase 4i: with allow_tf32 True, the conv module's float32 conv and
    its input and kernel gradients against float64; cuDNN called directly
    under the same flag, beside it (printed, not held: cuDNN chooses
    whether to use TF32)."""
    from generative_models_tpu_torch.models import conv
    F = torch.nn.functional
    assert torch.backends.cudnn.allow_tf32
    rng = np.random.default_rng(33)
    x64 = torch.from_numpy(rng.standard_normal((TRAIN_B, 64, 14, 14)))
    w64 = torch.from_numpy(rng.standard_normal((128, 64, 4, 4)) / 32.0)
    r64 = torch.from_numpy(rng.standard_normal((TRAIN_B, 128, 7, 7)))

    def run(f, dev, dt):
        x = x64.to(dev, dt).requires_grad_(True)
        w = w64.to(dev, dt).requires_grad_(True)
        y = f(x, w)
        gx, gw = torch.autograd.grad((y * r64.to(dev, dt)).sum(), (x, w))
        return [t.detach().double().cpu() for t in (y, gx, gw)]

    ref = run(lambda x, w: F.conv2d(x, w, stride=2, padding=1), "cpu",
              torch.float64)
    mine = run(conv._Conv.apply, "cuda", torch.float32)
    raw = run(lambda x, w: F.conv2d(x, w, stride=2, padding=1), "cuda",
              torch.float32)

    def errs(got):
        return [float((a - b).abs().max() / b.abs().max())
                for a, b in zip(got, ref)]
    e_mine, e_raw = errs(mine), errs(raw)
    ok = max(e_mine) <= CONV_LAYER_TOL
    print(f"  conv c2 64->128 B={TRAIN_B}, allow_tf32=True: the module's "
          f"(y, dx, dW) max_err/max|float64| "
          + ", ".join(f"{e:.2e}" for e in e_mine)
          + f" (tol {CONV_LAYER_TOL:.0e}); cuDNN called directly "
          + ", ".join(f"{e:.2e}" for e in e_raw)
          + f" {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the conv module's float32 conv is not IEEE "
                             "float32 under allow_tf32=True")
    return max(e_mine), max(e_raw)


def write_conv_checkpoint(path: str, seed: int) -> None:
    """A full-width conv nsgan checkpoint (conv_channels 64, z 128) in the
    JAX package's npz layout: HWIO kernels, GroupNorm scale and bias,
    the dense layers [in, out]; keys sorted as jax.tree_util lists them."""
    c = 64

    def kern(prefix, cin, cout):
        return [(f"{prefix}['b']", (cout,), 16 * cin),
                (f"{prefix}['w']", (4, 4, cin, cout), 16 * cin)]
    write_layout_checkpoint(path, seed, [
        *layer_leaves("['d_params']['fc']", CONV_W, 1),
        *kern("['d_params']['trunk']['c1']", 1, c),
        *kern("['d_params']['trunk']['c2']", c, 2 * c),
        *layer_leaves("['g_params']['fc']", 128, CONV_W),
        ("['g_params']['gn0']['bias']", (2 * c,), 1e4),
        ("['g_params']['gn0']['scale']", (2 * c,), 1.0),
        ("['g_params']['gn1']['bias']", (c,), 1e4),
        ("['g_params']['gn1']['scale']", (c,), 1.0),
        *kern("['g_params']['up1']", 2 * c, c),
        *kern("['g_params']['up2']", c, 1)], 4321)


def drive_conv_cli(variant, mods, torch):
    """Phase 4i: the CLI's conv run of `variant`, CONV_STEPS steps in one
    chunk. Returns (launch counts, the run's JSON line)."""
    from generative_models_tpu_torch import cli
    from generative_models_tpu_torch.ops import penalty
    run_dir = os.path.join(OUT_DIR, "conv")
    buf = io.StringIO()
    reset(*mods)
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["--variant", variant, "--arch", "conv",
                       "--dataset", "synthetic", "--steps", str(CONV_STEPS),
                       "--echo-every", "100", "--out-dir", run_dir,
                       "--dtype", "float32"])
    torch.cuda.synchronize()
    counts = launch_counts(mods)
    passes = penalty.plain_passes
    out = buf.getvalue().strip()
    print("  " + out.replace("\n", "\n  "))
    line = json.loads([l for l in out.splitlines() if l.startswith("{")][-1])
    with open(os.path.join(run_dir, variant, "metrics.jsonl")) as f:
        recs = [json.loads(l) for l in f]
    finite = all(math.isfinite(r[k]) for r in recs for k in LOSS_KEYS[variant])
    (fwd, bwd, rep, rep_bwd), (e_fwd, e_rep) = CONV_LAUNCHES[variant]
    from generative_models_tpu_torch.config import variant_config
    rows = max(variant_config(variant, arch="conv").d_steps, 1) * TRAIN_B
    grids = 1 + int(CONV_STEPS * rows >= 60000)
    n_fwd = fwd * CONV_STEPS + e_fwd * EVAL_BATCHES + grids
    want = {"mlp_fwd": n_fwd, "linear_cuda": n_fwd,
            "mlp_bwd": bwd * CONV_STEPS,
            "reparam": rep * CONV_STEPS + e_rep * EVAL_BATCHES,
            "reparam_bwd": rep_bwd * CONV_STEPS, "gan_chunk": 0,
            "vae_chunk": 0, "birvae_chunk": 0}
    pen = (5 * CONV_STEPS + EVAL_BATCHES) if variant == "wgangp" else 0
    got = {k: counts[k] for k in want}
    ok = (rc == 0 and got == want and passes == pen and finite
          and len(recs) == CONV_STEPS and line["steps"] == CONV_STEPS
          and all(math.isfinite(v) for v in line["eval"].values()))
    print(f"  cli --arch conv {variant}: rc={rc} {line['steps_per_sec']} "
          f"steps/s records={len(recs)} finite={finite} launches={got} "
          f"(expect {want}) penalty passes {passes} (expect {pen}) "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"the conv CLI run of {variant} failed its "
                             "checks")
    return counts, line


def drive_conv_serving(mods, torch):
    """Phase 4i: ``--arch conv --sample-only --export-sampler`` from a
    JAX-layout conv nsgan checkpoint: one G launch; the artifact on the
    card repeats bit for bit and matches Trainer.sample given the same
    Philox z within TOL["float32"]. Returns (launch counts, error)."""
    from generative_models_tpu_torch import cli
    from generative_models_tpu_torch.train.trainer import Trainer
    from generative_models_tpu_torch.utils import export
    run_dir = os.path.join(OUT_DIR, "conv_serving")
    os.makedirs(run_dir, exist_ok=True)
    ck = os.path.join(run_dir, "jax_layout_conv_nsgan.npz")
    art = os.path.join(run_dir, "conv_sampler.pt2")
    write_conv_checkpoint(ck, 41)
    buf = io.StringIO()
    reset(*mods)
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["--variant", "nsgan", "--arch", "conv", "--ckpt", ck,
                       "--sample-only", "--export-sampler", art,
                       "--out-dir", run_dir, "--dtype", "float32"])
    torch.cuda.synchronize()
    counts = launch_counts(mods)
    line = json.loads(buf.getvalue().strip().splitlines()[-1])
    fn = export.load_sampler(art, "cuda")
    a, b2 = fn(EXPORT_SEED), fn(EXPORT_SEED)
    t = Trainer("nsgan", arch="conv", dtype="float32")
    t.load_model(ck)
    z = export.sampler_noise(torch.tensor(EXPORT_SEED, device="cuda"),
                             t.cfg.sample_n, t.cfg.z_dim)
    want = torch.from_numpy(t.sample(z=z)).cuda()
    err = float((a - want).abs().max())
    ok = (rc == 0 and line["step"] == 4321 and line["sampler"] == art
          and counts["mlp_fwd"] == counts["linear_cuda"] == 1
          and torch.equal(a, b2) and tuple(a.shape) == (64, 784)
          and err <= TOL["float32"] and bool(torch.isfinite(a).all()))
    print(f"  cli --arch conv --sample-only --export-sampler from a JAX-layout "
          f"conv checkpoint: rc={rc} {line} launches mlp_fwd="
          f"{counts['mlp_fwd']} linear_cuda={counts['linear_cuda']}; the "
          f"artifact on the card bitwise repeat {torch.equal(a, b2)}, vs "
          f"Trainer.sample max_abs_err={err:.3e} tol {TOL['float32']:.0e} "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("conv serving failed its checks")
    return counts, err


def check_conv_repeat(torch):
    """Phase 4i: a conv general step (nsgan; vae with its noise from a
    generator) twice from one state gives the same bits: the conv
    module's cuDNN calls are deterministic (models/conv.py::strict_convs),
    the MLP kernels' sums run in a fixed order."""
    from generative_models_tpu_torch.config import variant_config
    from generative_models_tpu_torch.losses.registry import get_variant
    from generative_models_tpu_torch.train import step as step_lib
    from generative_models_tpu_torch.utils.tree import tree_leaves
    rng = np.random.default_rng(34)
    for variant in ("nsgan", "vae"):
        cfg, spec = variant_config(variant, arch="conv"), get_variant(variant)
        st = step_lib.init_state(spec, cfg, torch.Generator().manual_seed(5),
                                 "cuda")
        train_step = step_lib.build_step(spec, cfg)
        x = torch.from_numpy(rng.random((1, TRAIN_B, 784)).astype(
            np.float32)).cuda()
        batches = {"image": x, "label": torch.zeros(1, TRAIN_B).cuda()}
        z = [torch.from_numpy(rng.standard_normal(s_).astype(np.float32))
             .cuda() for s_ in ((1, TRAIN_B, cfg.z_dim), (TRAIN_B, cfg.z_dim))]

        def once():
            args = z if spec.adversarial else [
                torch.Generator(device="cuda").manual_seed(9)]
            new, m = train_step(st, batches, *args)
            return [t for t in tree_leaves(new) if torch.is_tensor(t)] + [
                v for v in m.values()]
        a, b = once(), once()
        torch.cuda.synchronize()
        same = len(a) == len(b) and all(torch.equal(u, v)
                                        for u, v in zip(a, b))
        print(f"  conv general step {variant} twice from one state: "
              f"{len(a)} tensors bitwise equal {same} "
              f"{'ok' if same else 'FAIL'}")
        if not same:
            raise AssertionError(f"the conv {variant} step did not repeat "
                                 "bit for bit")


def drive_conv_bf16(mods, torch):
    """Phase 4i: 20 steps of the conv nsgan and vae general steps with
    dtype bfloat16 (bf16 convs on cuDNN, the MLP kernels' bf16 operands):
    finite, 5 / 4 and 4 / 4 MLP launches a step."""
    from generative_models_tpu_torch.train.trainer import Trainer
    steps, paths = 20, {}
    for variant, (fwd, bwd) in (("nsgan", (5, 4)), ("vae", (4, 4))):
        t = Trainer(variant, arch="conv", dtype="bfloat16", fused_step=False,
                    dataset="synthetic",
                    out_dir=os.path.join(OUT_DIR, "conv_bf16"))
        t._load_data()
        reset(*mods)
        hist = t.train(steps=steps)
        counts = launch_counts(mods)
        finite = all(math.isfinite(v) for vs in hist.values() for v in vs)
        ok = (finite and counts["mlp_fwd"] == fwd * steps
              and counts["mlp_bwd"] == bwd * steps and counts["gan_chunk"] == 0)
        print(f"  conv {variant} dtype bfloat16, {steps} general steps: "
              f"finite={finite} mlp_fwd={counts['mlp_fwd']} mlp_bwd="
              f"{counts['mlp_bwd']} (expect {fwd} and {bwd} a step) "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"the bf16 conv {variant} run failed")
        paths[f"general_conv_{variant}_bf16"] = counts
    return paths


def drive_conv(mods, torch):
    """Phase 4i, under torch's default allow_tf32 (restored after)."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        print(f"[4i] the conv stacks at full width (cudnn.allow_tf32 "
              f"{torch.backends.cudnn.allow_tf32})")
        layer_err = check_conv_tf32(torch)
        stack_err = check_conv_stacks(mods, torch)
        check_conv_repeat(torch)
        paths, lines = {}, {}
        for variant in CONV_CLI:
            paths[f"cli_conv_{variant}"], lines[variant] = drive_conv_cli(
                variant, mods, torch)
        paths["serving_conv_nsgan"], serve_err = drive_conv_serving(
            mods, torch)
        paths.update(drive_conv_bf16(mods, torch))
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    return paths, lines, {"stacks_vs_cpu": stack_err,
                          "c2_vs_float64": layer_err[0],
                          "c2_cudnn_direct_vs_float64": layer_err[1],
                          "serving": serve_err}


# Phase 4j: the diffusion family (models/ddpm_net.py, losses/ddpm.py,
# losses/flow.py, train/reflow.py) at full width, config.py's defaults:
# the MLP net (hidden 400, time dim 128, the 784 -> 784 skip) and the
# UNet (conv_channels 64), B 100, T 1000, EMA 0.999, flow's 50 Euler
# steps. Every dense layer is one fused_linear call, so one launch of
# the forward kernel (and one linear_cuda count) a net forward, and one
# of the backward kernel a net backward: DIFF_LAUNCHES[arch] a forward.
# A training step is one forward and one backward (the general step:
# fused_step "auto" refuses ddpm and flow, as the reference's chunk
# does); an evaluate batch is one forward; a sample of S steps is S
# forwards (Heun: 2S), guided or not (one 2n-row call a step).
DIFF_LAUNCHES = {"mlp": 8, "conv": 7}
# < 600, the steps of one epoch of the 60,000 rows (200 until the smoke
# neared its time limit; the loss's first and last 50 steps still apart)
DIFF_STEPS = 100
DIFF_SAMPLE_N = 64     # config.py's sample_n: the final grid
# Card against CPU, the same weights and inputs, by max abs error over
# max |CPU| (outputs and every gradient): both float32, sums in other
# orders (CONV_TOL's few 1e-6), and the timestep embedding: its
# frequencies come from expf on the card and exp on the CPU, an ulp
# (6e-8) apart at most, which moves sin(t f) by up to t ulp(f) = 6e-5
# at t 999 before the time MLP (two 128-wide layers) and the per-layer
# time projections spread it. 1e-3 holds that with room and stays far
# below a wrong product (order 1).
DIFF_TOL = 1e-3
# A sampler's images in [0, 1], card against CPU from the same initial x
# and chain noise: each step adds the net's difference (DIFF_TOL of its
# output) times the step's eps coefficient, and the x0 clip and the
# chain's contraction keep it from growing; over S steps at most
# S * DIFF_TOL * max coef in the worst case, in practice a few of them.
SAMPLER_TOL = 5e-3
SAMPLER_N = 16
# (variant, arch, flags, S) of the samplers held card against CPU: DDPM's
# full chain (T 1000, eta 1) on the MLP net, S 50 at eta 0 on both nets,
# flow's Euler 50 on both, Heun 16, and guided conditional sampling
# (one 2n-row call a step).
DIFF_SAMPLERS = (
    ("ddpm", "mlp", {}, 1000),
    ("ddpm", "mlp", {"ddpm_sample_steps": 50, "ddpm_eta": 0.0}, 50),
    ("ddpm", "conv", {"ddpm_sample_steps": 50, "ddpm_eta": 0.0}, 50),
    ("flow", "mlp", {}, 50),
    ("flow", "conv", {}, 50),
    ("flow", "mlp", {"flow_solver": "heun", "flow_sample_steps": 16}, 32),
    ("ddpm", "mlp", {"ddpm_sample_steps": 50, "ddpm_cond": True,
                     "ddpm_guidance": 1.0}, 50),
    ("flow", "mlp", {"ddpm_cond": True, "ddpm_guidance": 1.0}, 50))
DIFF_CLI = (("ddpm", "mlp", ()), ("ddpm", "conv", ()), ("flow", "mlp", ()),
            ("flow", "conv", ()),
            ("ddpm", "mlp", ("--ddpm-cond", "--ddpm-guidance", "1.0")))
REFLOW_PAIRS = 4096    # two chunks of 2048, and one of test pairs
# the exported diffusion samplers' steps (the export traces each as a
# straight line of net calls; 50 until the smoke neared its time limit)
EXPORT_S = 20
REFLOW_STEPS = 100
DIFF_BF16_STEPS = 20


def diffusion_cfg(variant, arch, **kw):
    from generative_models_tpu_torch.config import variant_config
    return variant_config(variant, arch=arch, **kw)


def grid_evals(cfg) -> int:
    """Net forwards of one sample call."""
    if cfg.variant == "ddpm":
        return cfg.ddpm_sample_steps or cfg.ddpm_timesteps
    return cfg.flow_sample_steps * (2 if cfg.flow_solver == "heun" else 1)


def write_model_checkpoint(path: str, seed: int, cfg) -> None:
    """A full-width single-model checkpoint (ddpm, flow, vqvae, vqprior)
    in the JAX package's npz layout (params and EMA when the config
    keeps one, every leaf the port's param_template lists, keys sorted):
    dense and conv weights U(+-1/sqrt fan-in) with their biases, the
    label table, embeddings, the codebook and GroupNorm and LayerNorm
    scales U(-1, 1), their biases U(+-0.01); the zero-initialised out,
    skip and head drawn too, so the net's output is not zero."""
    from generative_models_tpu_torch.utils.checkpoint import param_template
    from generative_models_tpu_torch.utils.tree import tree_leaves_with_path
    tmpl = param_template(cfg)
    leaves = []
    for key in sorted(tmpl):
        for p, t in tree_leaves_with_path(tmpl[key], f"['{key}']"):
            shape = tuple(t.shape)
            if p.endswith("['w']"):
                fan = int(np.prod(shape[:-1]))
            elif p.endswith("['b']"):
                w = dict(tree_leaves_with_path(tmpl[key], f"['{key}']"))[
                    p[:-5] + "['w']"]
                fan = int(np.prod(tuple(w.shape)[:-1]))
            elif p.endswith("['bias']"):
                fan = 1e4
            else:  # the label table, GroupNorm scales
                fan = 1.0
            leaves.append((p, shape, fan))
    write_layout_checkpoint(path, seed, leaves, 777)


def check_diffusion_nets(mods, torch):
    """Phase 4j: the ddpm MLP net and the UNet (conditional, so the label
    table is in the graph) at B 100, forward and every gradient of sum(out
    * r) on the card against the CPU's plain path, the same weights (a
    JAX-layout checkpoint's) and inputs, data by the tie rule; the
    launches, DIFF_LAUNCHES a forward and a backward; and one SiLU layer
    (fused_linear 128 -> 128, the time MLP's first) against its plain
    version on the card. Returns the worst relative error."""
    from generative_models_tpu_torch.models import ddpm_net
    from generative_models_tpu_torch.ops.linear import fused_linear, linear_plain
    from generative_models_tpu_torch.train.trainer import Trainer
    from generative_models_tpu_torch.utils.tree import tree_leaves, tree_map
    worst = 0.0
    run_dir = os.path.join(OUT_DIR, "diffusion_nets")
    os.makedirs(run_dir, exist_ok=True)
    for arch in ("mlp", "conv"):
        cfg = diffusion_cfg("ddpm", arch, ddpm_cond=True)
        ck = os.path.join(run_dir, f"ddpm_{arch}.npz")
        write_model_checkpoint(ck, 51, cfg)
        t = Trainer(config=cfg, device="cpu")
        t.load_model(ck)
        os.remove(ck)
        params = t.state["params"]

        def draw(seed):
            rng = np.random.default_rng(seed)
            return [torch.from_numpy((2 * rng.random((TRAIN_B, 784)) - 1)
                                     .astype(np.float32)),
                    torch.from_numpy(rng.integers(0, 1000, TRAIN_B)),
                    torch.from_numpy(rng.integers(0, 11, TRAIN_B))]

        def fn(p, a):
            return ddpm_net.net_apply(p, a[0], a[1], cfg, a[2])
        # the tie rule (conv_margin): the nets' activations are SiLU, which
        # has no kink, so the first seed clears it (margin inf)
        for seed in range(TIE_FIRST_SEED, TIE_FIRST_SEED + TIE_MAX_SEEDS):
            margin = conv_margin(fn, params, draw(seed), torch)
            if margin > TIE_MARGIN:
                break
        inputs = draw(seed)
        outs, grads, n = {}, {}, {}
        for dev in ("cuda", "cpu"):
            rng = np.random.default_rng(52)
            p = tree_map(lambda a: a.to(dev).requires_grad_(True), params)
            a = [u.to(dev) for u in inputs]
            a[0].requires_grad_(True)
            reset(*mods)
            out = fn(p, a)
            r = torch.from_numpy(rng.standard_normal(tuple(out.shape))
                                 .astype(np.float32)).to(dev)
            g = torch.autograd.grad((out * r).sum(), tree_leaves(p) + [a[0]])
            if dev == "cuda":
                torch.cuda.synchronize()
            n[dev] = (mods[0].launches, mods[0].bwd_launches)
            outs[dev] = out.detach().cpu()
            grads[dev] = [u.cpu() for u in g]

        def rel(a, b):
            return float((a - b).abs().max()) / max(float(b.abs().max()),
                                                    1e-30)
        f_err = rel(outs["cuda"], outs["cpu"])
        b_err = max(rel(a, b) for a, b in zip(grads["cuda"], grads["cpu"]))
        want = (DIFF_LAUNCHES[arch],) * 2
        finite = all(bool(torch.isfinite(u).all())
                     for u in [outs["cuda"]] + grads["cuda"])
        ok = (finite and f_err <= DIFF_TOL and b_err <= DIFF_TOL
              and n["cuda"] == want and n["cpu"] == (0, 0))
        print(f"  ddpm net {arch:4s} B={TRAIN_B} (data seed {seed}, margin "
              f"{margin:.1e}): forward max_err/max|cpu| {f_err:.3e}, "
              f"backward ({len(grads['cuda'])} gradients) {b_err:.3e} tol "
              f"{DIFF_TOL:.0e}; (mlp_fwd, mlp_bwd) launches card {n['cuda']}"
              f" (expect {want}) cpu {n['cpu']} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"the ddpm {arch} net on the card disagrees "
                                 "with the CPU")
        worst = max(worst, f_err, b_err)
    # the SiLU layer: the product on the kernel (act "none"), then SiLU
    rng = np.random.default_rng(53)
    ws, bs = make_stack(rng, [128, 128], "cuda")
    x = torch.from_numpy(rng.standard_normal((TRAIN_B, 128)).astype(
        np.float32)).cuda()
    reset(*mods)
    got = fused_linear(x, ws[0], bs[0], act="silu")
    want = linear_plain(x, ws[0], bs[0], act="silu")
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    ok = err <= TOL["float32"] and mods[0].launches == 1
    print(f"  fused_linear 128->128 silu B={TRAIN_B}: max_abs_err vs plain "
          f"{err:.3e} tol {TOL['float32']:.0e}, mlp_fwd launches "
          f"{mods[0].launches} (expect 1) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the silu layer disagrees with its plain version")
    return max(worst, err)


def drive_diffusion_cli(variant, arch, flags, mods, torch):
    """Phase 4j: the CLI's run of `variant` on `arch`, DIFF_STEPS steps
    (the general step), with --ckpt. Returns (launch counts, the JSON
    line, the checkpoint's path)."""
    from generative_models_tpu_torch import cli
    from generative_models_tpu_torch.utils.checkpoint import read_leaves
    tag = f"{variant}_{arch}" + ("_cond" if flags else "")
    run_dir = os.path.join(OUT_DIR, "diffusion", tag)
    ck = os.path.join(run_dir, "ck.npz")
    buf = io.StringIO()
    reset(*mods)
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["--variant", variant, "--arch", arch, "--dataset",
                       "synthetic", "--steps", str(DIFF_STEPS),
                       "--echo-every", "100", "--out-dir", run_dir,
                       "--ckpt", ck, "--dtype", "float32", *flags])
    torch.cuda.synchronize()
    counts = launch_counts(mods)
    out = buf.getvalue().strip()
    print("  " + out.replace("\n", "\n  "))
    line = json.loads([l for l in out.splitlines() if l.startswith("{")][-1])
    with open(os.path.join(run_dir, variant, "metrics.jsonl")) as f:
        losses = [json.loads(l)["loss"] for l in f]
    finite = all(math.isfinite(v) for v in losses)
    falling = np.mean(losses[-50:]) < np.mean(losses[:50])
    cfg = diffusion_cfg(variant, arch)
    f = DIFF_LAUNCHES[arch]
    n_fwd = f * (DIFF_STEPS + EVAL_BATCHES + grid_evals(cfg))
    want = {"mlp_fwd": n_fwd, "linear_cuda": n_fwd,
            "mlp_bwd": f * DIFF_STEPS, "reparam": 0, "reparam_bwd": 0,
            "gan_chunk": 0, "vae_chunk": 0, "birvae_chunk": 0}
    got = {k: counts[k] for k in want}
    leaves = read_leaves(ck)
    ema_apart = any(not np.array_equal(a, leaves[p.replace("['ema']",
                                                            "['params']")])
                    for p, a in leaves.items() if p.startswith("['ema']"))
    if (variant, arch, flags) != ("flow", "mlp", ()):  # reflow's teacher
        os.remove(ck)  # OUT_DIR stays small: checked files go
    ok = (rc == 0 and got == want and finite and falling
          and len(losses) == DIFF_STEPS and ema_apart
          and math.isfinite(line["eval"]["loss"]))
    print(f"  cli {variant} --arch {arch} {' '.join(flags)}: rc={rc} "
          f"{line['steps_per_sec']} steps/s, loss first 50 "
          f"{np.mean(losses[:50]):.4f} last 50 {np.mean(losses[-50:]):.4f}, "
          f"launches={got} (expect {want}), the checkpoint's EMA apart from "
          f"its params {ema_apart} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"the CLI run of {variant} --arch {arch} failed "
                             "its checks")
    return counts, line, ck


def drive_diffusion_bf16(mods, torch):
    """Phase 4j: DIFF_BF16_STEPS general steps of the MLP ddpm with dtype
    bfloat16: finite, 8 and 8 launches a step."""
    from generative_models_tpu_torch.train.trainer import Trainer
    t = Trainer("ddpm", dtype="bfloat16", dataset="synthetic",
                out_dir=os.path.join(OUT_DIR, "diffusion_bf16"))
    t._load_data()
    reset(*mods)
    hist = t.train(steps=DIFF_BF16_STEPS)
    counts = launch_counts(mods)
    f = DIFF_LAUNCHES["mlp"] * DIFF_BF16_STEPS
    finite = all(math.isfinite(v) for v in hist["loss"])
    ok = finite and counts["mlp_fwd"] == f and counts["mlp_bwd"] == f
    print(f"  ddpm dtype bfloat16, {DIFF_BF16_STEPS} general steps: finite="
          f"{finite} mlp_fwd={counts['mlp_fwd']} mlp_bwd={counts['mlp_bwd']} "
          f"(expect {f} each) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the bf16 ddpm run failed")
    return counts


def sampler_pair(variant, arch, kw, ck_dir, torch):
    """(card Trainer, CPU Trainer) loaded from one JAX-layout checkpoint."""
    from generative_models_tpu_torch.train.trainer import Trainer
    cfg = diffusion_cfg(variant, arch, **kw)
    tag = f"{variant}_{arch}" + ("_cond" if cfg.ddpm_cond else "")
    ck = os.path.join(ck_dir, f"{tag}.npz")
    if not os.path.exists(ck):
        write_model_checkpoint(ck, 61 + len(tag), cfg)
    pair = []
    for dev in ("cuda", "cpu"):
        t = Trainer(config=cfg, device=dev)
        t.load_model(ck)
        pair.append(t)
    return pair


def check_diffusion_samplers(mods, torch):
    """Phase 4j: each sampler of DIFF_SAMPLERS on the card against the
    CPU's from the same initial x and chain noise (numpy draws), by max
    abs error (SAMPLER_TOL), with its launches: DIFF_LAUNCHES a net call,
    S calls. Returns {name: (error, launches)}."""
    ck_dir = os.path.join(OUT_DIR, "diffusion_serving")
    os.makedirs(ck_dir, exist_ok=True)
    out = {}
    n = SAMPLER_N
    for variant, arch, kw, evals in DIFF_SAMPLERS:
        t_gpu, t_cpu = sampler_pair(variant, arch, kw, ck_dir, torch)
        z = np.random.default_rng(71).standard_normal((n, 784)).astype(
            np.float32)

        def chain_on(dev):
            return lambda i: torch.from_numpy(np.random.default_rng(
                (72, i)).standard_normal((n, 784)).astype(np.float32)).to(dev)
        extra = {"chain": chain_on} if variant == "ddpm" else {}
        imgs = {}
        for t, dev in ((t_gpu, "cuda"), (t_cpu, "cpu")):
            reset(*mods)
            e = {"chain": chain_on(dev)} if extra else {}
            imgs[dev] = t.sample(z=z, **e)
            if dev == "cuda":
                launched = mods[0].launches
        err = float(np.abs(imgs["cuda"] - imgs["cpu"]).max())
        want = DIFF_LAUNCHES[arch] * evals
        ok = (err <= SAMPLER_TOL and launched == want
              and np.isfinite(imgs["cuda"]).all())
        name = f"{variant}_{arch}_" + "_".join(
            f"{k}{v}" for k, v in sorted(kw.items())) + f"_evals{evals}"
        print(f"  sampler {name}: n={n} card vs cpu max_abs_err {err:.3e} "
              f"tol {SAMPLER_TOL:.0e}; mlp_fwd launches {launched} (expect "
              f"{want}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"the sampler {name} on the card disagrees "
                                 "with the CPU's")
        out[name] = (err, launched)
    for name in os.listdir(ck_dir):  # OUT_DIR stays small
        if name.endswith(".npz"):
            os.remove(os.path.join(ck_dir, name))
    return out


def drive_diffusion_serving(variant, arch, kw, flags, mods, torch):
    """Phase 4j: ``--sample-only --export-sampler`` from a JAX-layout
    checkpoint: the grid's launches (DIFF_LAUNCHES x S); the artifact on
    the card bitwise per seed, and against Trainer.sample given the same
    Philox draws (the initial x, and DDPM's chain at offsets 1..S) by
    SAMPLER_TOL. Returns (launch counts, error, export seconds)."""
    from generative_models_tpu_torch import cli
    from generative_models_tpu_torch.train.trainer import Trainer
    from generative_models_tpu_torch.utils import export
    run_dir = os.path.join(OUT_DIR, "diffusion_serving")
    os.makedirs(run_dir, exist_ok=True)
    cfg = diffusion_cfg(variant, arch, **kw)
    ck = os.path.join(run_dir, f"jax_layout_{variant}_{arch}.npz")
    art = os.path.join(run_dir, f"{variant}_{arch}.pt2")
    write_model_checkpoint(ck, 81, cfg)
    buf = io.StringIO()
    reset(*mods)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["--variant", variant, "--arch", arch, "--ckpt", ck,
                       "--sample-only", "--export-sampler", art,
                       "--out-dir", run_dir, "--dtype", "float32", *flags])
    wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    counts = launch_counts(mods)
    line = json.loads(buf.getvalue().strip().splitlines()[-1])
    fn = export.load_sampler(art, "cuda")
    a, b2 = fn(EXPORT_SEED), fn(EXPORT_SEED)
    t = Trainer(config=cfg)
    t.load_model(ck)
    seed = torch.tensor(EXPORT_SEED, device="cuda")
    n = cfg.sample_n
    extra = ({"chain": export.sampler_chain(seed, n, 784)}
             if variant == "ddpm" else {})
    want_img = torch.from_numpy(t.sample(
        z=export.sampler_noise(seed, n, 784), **extra)).cuda()
    err = float((a - want_img).abs().max())
    f = DIFF_LAUNCHES[arch] * grid_evals(cfg)
    ok = (rc == 0 and line["step"] == 777 and line["sampler"] == art
          and counts["mlp_fwd"] == counts["linear_cuda"] == f
          and torch.equal(a, b2) and tuple(a.shape) == (n, 784)
          and err <= SAMPLER_TOL and bool(torch.isfinite(a).all()))
    print(f"  cli {variant} --arch {arch} --sample-only --export-sampler "
          f"{' '.join(flags)} from a JAX-layout checkpoint: rc={rc} "
          f"{wall:.1f} s (grid and export) launches mlp_fwd="
          f"{counts['mlp_fwd']} (expect {f}); the artifact on the card "
          f"bitwise repeat {torch.equal(a, b2)}, vs Trainer.sample "
          f"max_abs_err={err:.3e} tol {SAMPLER_TOL:.0e} "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{variant} serving failed its checks")
    for path in (ck, art):  # OUT_DIR stays small: checked files go
        os.remove(path)
    return counts, err, wall


def drive_reflow(teacher_ck, mods, torch):
    """Phase 4j: --reflow-from the flow MLP run's checkpoint with
    REFLOW_PAIRS pairs (Heun 50), REFLOW_STEPS student steps and 1-step
    sampling; the teacher's ODE at B 2048 (three chunks: two of train
    pairs, one of test pairs, 100 net calls each), the student's steps,
    evaluate and the 1-step grid, all counted. Returns (counts, line)."""
    from generative_models_tpu_torch import cli
    run_dir = os.path.join(OUT_DIR, "diffusion", "reflow")
    buf = io.StringIO()
    reset(*mods)
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["--variant", "flow", "--dataset", "synthetic",
                       "--steps", str(REFLOW_STEPS), "--echo-every", "50",
                       "--out-dir", run_dir, "--reflow-from", teacher_ck,
                       "--reflow-pairs", str(REFLOW_PAIRS),
                       "--flow-sample-steps", "1"])
    torch.cuda.synchronize()
    counts = launch_counts(mods)
    out = buf.getvalue().strip()
    print("  " + out.replace("\n", "\n  "))
    line = json.loads([l for l in out.splitlines() if l.startswith("{")][-1])
    f = DIFF_LAUNCHES["mlp"]
    chunks = REFLOW_PAIRS // 2048 + 1
    # the final 1-step grid, and one when the run crosses an epoch of the
    # REFLOW_PAIRS rows (sample_every 0)
    grids = 1 + int(REFLOW_STEPS * TRAIN_B >= REFLOW_PAIRS)
    want_fwd = f * (chunks * 2 * 50 + REFLOW_STEPS + EVAL_BATCHES + grids)
    os.remove(teacher_ck)  # OUT_DIR stays small: checked files go
    ok = (rc == 0 and out.splitlines()[0].startswith(
        f"reflow: {REFLOW_PAIRS} teacher couplings")
          and counts["mlp_fwd"] == want_fwd
          and counts["mlp_bwd"] == f * REFLOW_STEPS
          and math.isfinite(line["eval"]["loss"]))
    print(f"  cli flow --reflow-from: rc={rc} mlp_fwd={counts['mlp_fwd']} "
          f"(expect {want_fwd}) mlp_bwd={counts['mlp_bwd']} (expect "
          f"{f * REFLOW_STEPS}) eval {line['eval']} "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the reflow run failed its checks")
    return counts, line


# The repair of the MLP kernels' route (ops/linear.py, models/mlp.py):
# nsgan with --g-hidden-act silu. fused_step "auto" keeps the general
# step (the chunk kernel hand-derives G's ReLU), and G's stack, which
# holds a SiLU, runs a launch a layer: a G forward 2 launches (the SiLU
# layer's product with act "none", then the sigmoid layer), a G backward
# 2. nsgan's general step at d_steps 1 is 5 forward and 4 backward
# launches with G in one; two G forwards (the critic's update and G's)
# and one G backward a step make it 7 and 5.
SILU_LAUNCHES = (7, 5)
SILU_STEPS = 100


def check_silu_nsgan(mods, torch):
    """Phase 4j: one critic update's and one G update's gradients of
    nsgan with a SiLU G on the card against the CPU's (same params,
    batch and z; max abs error over max |CPU| of each gradient, by
    DIFF_TOL); then SILU_STEPS steps of Trainer.train on the card:
    SILU_LAUNCHES a step, no chunk launch, finite. Returns (counts,
    error)."""
    from generative_models_tpu_torch.config import variant_config
    from generative_models_tpu_torch.losses.registry import get_variant
    from generative_models_tpu_torch.ops import cuda_train
    from generative_models_tpu_torch.train import step as step_lib
    from generative_models_tpu_torch.train.trainer import Trainer
    from generative_models_tpu_torch.utils.tree import tree_leaves, tree_map
    cfg = variant_config("nsgan", g_hidden_act="silu")
    spec = get_variant("nsgan")
    assert not cuda_train.resolve_fused_step(spec, cfg, "cuda")
    st = step_lib.init_state(spec, cfg, torch.Generator().manual_seed(91))
    rng = np.random.default_rng(92)
    x = torch.from_numpy(rng.random((TRAIN_B, 784)).astype(np.float32))
    z = torch.from_numpy(rng.standard_normal((TRAIN_B, 128)).astype(
        np.float32))
    grads = {}
    for dev in ("cuda", "cpu"):
        d_grads, g_grads = step_lib.autograd_grads(spec, cfg)
        g = tree_map(lambda t: t.to(dev), st["g_params"])
        d = tree_map(lambda t: t.to(dev), st["d_params"])
        batch = {"image": x.to(dev), "label": torch.zeros(TRAIN_B).to(dev)}
        gd, _ = d_grads(d, g, batch, z.to(dev), None, {})
        gg, _ = g_grads(g, d, batch, z.to(dev), {})
        grads[dev] = [t.cpu() for t in tree_leaves(gd) + tree_leaves(gg)]
    err = max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
              for a, b in zip(grads["cuda"], grads["cpu"]))
    t = Trainer("nsgan", g_hidden_act="silu", dataset="synthetic",
                out_dir=os.path.join(OUT_DIR, "silu"))
    t._load_data()
    reset(*mods)
    hist = t.train(steps=SILU_STEPS)
    counts = launch_counts(mods)
    finite = all(math.isfinite(v) for vs in hist.values() for v in vs)
    want = (SILU_LAUNCHES[0] * SILU_STEPS, SILU_LAUNCHES[1] * SILU_STEPS)
    got = (counts["mlp_fwd"], counts["mlp_bwd"])
    ok = (err <= DIFF_TOL and finite and got == want
          and counts["gan_chunk"] == 0)
    print(f"  nsgan --g-hidden-act silu: gradients card vs cpu max_err/"
          f"max|cpu| {err:.3e} tol {DIFF_TOL:.0e}; {SILU_STEPS} general steps "
          f"(mlp_fwd, mlp_bwd) {got} (expect {want}), gan_chunk "
          f"{counts['gan_chunk']}, finite={finite} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("nsgan with a SiLU G failed its checks")
    return counts, err


def drive_diffusion(mods, torch):
    """Phase 4j. Returns (paths, CLI lines, errors)."""
    print("[4j] the diffusion family at full width")
    t0 = time.perf_counter()
    errs = {"nets_vs_cpu": check_diffusion_nets(mods, torch)}
    print(f"  (nets checked at {time.perf_counter() - t0:.1f} s)")
    paths, lines, cks = {}, {}, {}
    paths["general_nsgan_silu"], errs["nsgan_silu_vs_cpu"] = \
        check_silu_nsgan(mods, torch)
    for variant, arch, flags in DIFF_CLI:
        key = f"cli_{variant}_{arch}" + ("_cond" if flags else "")
        paths[key], lines[key], cks[key] = drive_diffusion_cli(
            variant, arch, flags, mods, torch)
    paths["general_ddpm_bf16"] = drive_diffusion_bf16(mods, torch)
    print(f"  (CLI and bf16 runs done at {time.perf_counter() - t0:.1f} s)")
    errs["samplers_vs_cpu"] = check_diffusion_samplers(mods, torch)
    print(f"  (samplers checked at {time.perf_counter() - t0:.1f} s)")
    paths["serving_ddpm"], errs["serving_ddpm"], lines["export_ddpm_s"] = \
        drive_diffusion_serving("ddpm", "mlp", {"ddpm_sample_steps": EXPORT_S},
                                ("--ddpm-sample-steps", str(EXPORT_S)), mods,
                                torch)
    paths["serving_flow"], errs["serving_flow"], lines["export_flow_s"] = \
        drive_diffusion_serving("flow", "mlp", {"flow_sample_steps": EXPORT_S},
                                ("--flow-sample-steps", str(EXPORT_S)), mods,
                                torch)
    paths["cli_flow_reflow"], lines["reflow"] = drive_reflow(
        cks["cli_flow_mlp"], mods, torch)
    print(f"  phase 4j took {time.perf_counter() - t0:.1f} s")
    return paths, lines, errs


# Phase 5h: the diffusion general steps and samplers' times. Steps/s of
# the four general steps (ddpm and flow on each net) on the host's clock
# over DIFF_TIME_STEPS steps after a warm-up, with one step's device time
# split as 5g splits the conv steps (the hand-written kernels, cuDNN's
# convolutions, the rest) and the idle share; served images/s of
# Trainer.sample at n 64 and 1024 (CUDA events around one call after a
# warm-up call), DDPM at S 1000 and 50, flow at S 1, 16 and 50 (Euler);
# the UNet's DDPM S 1000 at n 64 alone (its n 1024 took 21 s; cut with
# DIFF_TIME_STEPS 100 -> 50 when 4l came).
DIFF_TIME_STEPS = 50
DIFF_SERVE_N = (64, 1024)
DIFF_SERVE = (("ddpm", {}), ("ddpm", {"ddpm_sample_steps": 50}),
              ("flow", {"flow_sample_steps": 1}),
              ("flow", {"flow_sample_steps": 16}), ("flow", {}))


def time_diffusion(mods, torch, card):
    """Phase 5h. Returns {"training": {name: row}, "serving": [rows]}."""
    from generative_models_tpu_torch.train import step as step_lib
    from generative_models_tpu_torch.train.trainer import Trainer
    print("[5h] the diffusion family's times")
    training = {}
    for variant in ("ddpm", "flow"):
        for arch in ("mlp", "conv"):
            t = Trainer(variant, arch=arch, dataset="synthetic",
                        dtype="float32",
                        out_dir=os.path.join(OUT_DIR, "diffusion_timing"))
            t._load_data()
            t.train(steps=20)  # warm-up
            t.train(steps=DIFF_TIME_STEPS)
            sps = DIFF_TIME_STEPS / t.wall_time
            train_step = step_lib.build_step(t.spec, t.cfg)
            x = t.x_train[:TRAIN_B].reshape(1, TRAIN_B, -1)
            batches = {"image": x, "label": t.y_train[:TRAIN_B].reshape(1, -1)}
            st = t.state
            gen = torch.Generator(device="cuda").manual_seed(3)
            by_name, total = device_ms_by_name(
                torch, lambda: train_step(st, batches, gen),
                iters=CONV_PROFILE_STEPS, tries=6)
            split = None
            if by_name is not None:
                split = {}
                for name, ms in by_name.items():
                    cls = conv_kernel_class(name)
                    split[cls] = split.get(cls, 0.0) + ms
            step_ms = 1e3 / sps
            row = {"steps_per_s": sps, "step_ms": step_ms,
                   "device_ms_per_step": total, "device_split_ms": split,
                   "idle_share": (None if total is None
                                  else max(0.0, 1 - total / step_ms))}
            training[f"{variant}_{arch}"] = row
            print(f"  general step {variant} --arch {arch} B={TRAIN_B}: "
                  f"{sps:.2f} steps/s ({step_ms:.3f} ms a step); device "
                  + ("not measured" if total is None else
                     f"{total:.4f} ms a step (idle share "
                     f"{row['idle_share']:.3f}): " + ", ".join(
                         f"{k} {v:.4f}" for k, v in sorted(split.items())))
                  + f"  [{card}]")
    serving = []
    for arch in ("mlp", "conv"):
        for variant, kw in DIFF_SERVE:
            t = Trainer(variant, arch=arch, **kw)
            for n in DIFF_SERVE_N:
                evals = grid_evals(t.cfg)
                if arch == "conv" and evals >= 1000 and n > DIFF_SERVE_N[0]:
                    continue
                if evals < 1000:
                    t.sample(n)  # warm-up
                torch.cuda.synchronize()
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                t.sample(n)
                e1.record()
                torch.cuda.synchronize()
                ms = e0.elapsed_time(e1)
                row = {"variant": variant, "arch": arch, "steps": evals,
                       "n": n, "ms": ms, "images_per_s": n / ms * 1e3}
                serving.append(row)
                print(f"  serve {variant} --arch {arch} S={evals:4d} n={n:4d}: "
                      f"{ms:.1f} ms, {row['images_per_s']:.1f} images/s  "
                      f"[{card}]")
    return {"training": training, "serving": serving}


# Phase 4k: the VQ family (models/vq_net.py, models/ar_prior.py,
# losses/vqvae.py, losses/vqprior.py, train/vq.py) at config.py's
# defaults: K 64, D 16, L 16 (49 on conv), hidden 400, the prior 128
# wide, 2 layers, 4 heads, conv_channels 64, B 100. The launches of the
# MLP kernels, worked out from the code before any run: the MLP
# tokenizer's encoder and decoder are one whole-stack launch each
# (forward, and backward under a gradient); the prior's linears one
# linear_cuda launch each, 4 a block and the head: 9 a pass, each also
# counted by mlp_fwd; the conv tokenizer's convs are cuDNN's. So a loss
# (the general step: the chunk kernels refuse the VQ family, as the
# reference's do) launches (mlp_fwd, mlp_bwd):
VQ_LOSS_LAUNCHES = {("vqvae", "mlp", False): (2, 2),
                    ("vqvae", "conv", False): (0, 0),
                    ("vqprior", "mlp", False): (11, 11),
                    ("vqprior", "mlp", True): (11, 9),   # frozen tokenizer
                    ("vqprior", "conv", False): (9, 9)}
PRIOR_PASS = 9
VQ_STEPS = 100         # < 600, the steps of one epoch of the 60,000 rows
VQ_BF16_STEPS = 20
VQ_K = 64
VQ_SAMPLE_N = 64       # config.py's sample_n: the final grid
# The tie rule of the nearest-code search and of the sampler's Gumbel
# argmax: a best and a second-best score within rounding of each other
# pick another code or token on the card than on the CPU, a jump of the
# function, not an error of either. A case's data (or chain) is the
# first numpy seed from TIE_FIRST_SEED whose smallest relative gap
# (ops/vq.py::code_margin; losses/vqprior.py::sample_margin), read from
# the plain version, clears VQ_TIE_MARGIN; its ReLUs clear TIE_MARGIN as
# 4i's do (conv_margin). The card's logits and distances sit a few 1e-7
# of their scale from the CPU's; the margin is 10-100 times that.
VQ_TIE_MARGIN = 1e-5
# Card against CPU, the same weights and data: the loss, its metrics and
# every gradient, by max abs error over max |CPU| (floats summed in other
# orders: the kernels' rows 1-3 and cuDNN's convs, a few 1e-6, as 4i's
# CONV_TOL; the prior's 1600-row attention and LayerNorms). A wrong
# product is off by order 1.
VQ_NET_TOL = 1e-4
# IEEE float32 products against float64 with the global TF32 flag on:
# distances of 16-wide rows, attention products of 32-wide heads, by max
# abs error over max |float64| (a few float32 ulps); TF32 rounds each
# operand to 11 significant bits (4.9e-4).
VQ_F32_TOL = 1e-5
VQ_SAMPLERS = (("mlp", "cache"), ("mlp", "full"), ("conv", "cache"))


def vq_cfg(variant, arch="mlp", **kw):
    from generative_models_tpu_torch.config import variant_config
    return variant_config(variant, arch=arch, **kw)


def vq_margins(loss_fn, params, inputs, torch):
    """(the smallest |pre-activation| / rms of any ReLU or LeakyReLU, as
    conv_margin reads it, and the smallest code margin) of a float64 run
    of loss_fn on the CPU."""
    from generative_models_tpu_torch.models import conv, vq_net
    from generative_models_tpu_torch.ops import linear, vq
    from generative_models_tpu_torch.utils.tree import tree_map
    relu, codes = [math.inf], [math.inf]
    real_act, real_quantize = conv.apply_act, vq.quantize

    def act(x, a, slope=0.2):
        if a in ("relu", "leaky_relu"):
            rms = float(x.pow(2).mean().sqrt())
            relu.append(float(x.abs().min()) / max(rms, 1e-300))
        return real_act(x, a, slope)

    def quantize(z, book):
        codes.append(vq.code_margin(z, book))
        return real_quantize(z, book)
    conv.apply_act = linear.apply_act = vq_net.apply_act = act
    vq.quantize = quantize
    try:
        with torch.no_grad():
            loss_fn(tree_map(lambda t: t.double(), params),
                    [u.double() if u.is_floating_point() else u
                     for u in inputs])
    finally:
        conv.apply_act = linear.apply_act = vq_net.apply_act = real_act
        vq.quantize = real_quantize
    return min(relu), min(codes)


def vq_loss_case(variant, arch, kw, torch, seed):
    """(Trainer on the CPU holding a JAX-layout checkpoint's weights, the
    data seed by the tie rule, (relu, code) margins)."""
    from generative_models_tpu_torch.train.trainer import Trainer
    cfg = vq_cfg(variant, arch, **kw)
    run_dir = os.path.join(OUT_DIR, "vq_nets")
    os.makedirs(run_dir, exist_ok=True)
    ck = os.path.join(run_dir, f"{variant}_{arch}.npz")
    write_model_checkpoint(ck, seed, cfg)
    t = Trainer(config=cfg, device="cpu")
    t.load_model(ck)
    os.remove(ck)
    params = t.state["params"]

    def draw(s):
        rng = np.random.default_rng(s)
        return [torch.from_numpy(rng.random((TRAIN_B, 784),
                                            dtype=np.float32)),
                torch.from_numpy(rng.integers(0, 10, TRAIN_B))]

    def loss_fn(p, a):
        return t.spec.loss(p, {"image": a[0], "label": a[1]}, None, cfg)[0]
    passed = []
    for s in range(TIE_FIRST_SEED, TIE_FIRST_SEED + TIE_MAX_SEEDS):
        relu, code = vq_margins(loss_fn, params, draw(s), torch)
        if relu > TIE_MARGIN and code > VQ_TIE_MARGIN:
            return t, draw(s), s, (relu, code), len(passed)
        passed.append(s)
    raise AssertionError(f"{variant} {arch}: no seed clears the tie rule")


def check_vq_nets(mods, torch):
    """Phase 4k: each VQ loss (vqvae and vqprior, both archs, the prior
    conditional on conv, the frozen tokenizer) at B 100 on the card
    against the CPU: the loss, its metrics, the token indices (equal) and
    every gradient (VQ_NET_TOL), data by the tie rule; the launches,
    VQ_LOSS_LAUNCHES. Returns the worst relative error."""
    from generative_models_tpu_torch.losses import vqvae
    from generative_models_tpu_torch.utils.tree import tree_leaves, tree_map
    cases = (("vqvae", "mlp", {}), ("vqvae", "conv", {}),
             ("vqprior", "mlp", {}),
             ("vqprior", "conv", {"ddpm_cond": True}),
             ("vqprior", "mlp", {"vq_freeze_tokenizer": True}))
    worst = 0.0
    for i, (variant, arch, kw) in enumerate(cases):
        t, inputs, seed, margins, skipped = vq_loss_case(
            variant, arch, kw, torch, 101 + i)
        cfg, spec = t.cfg, t.spec
        out = {}
        for dev in ("cuda", "cpu"):
            p = tree_map(lambda a: a.to(dev).requires_grad_(True),
                         t.state["params"])
            a = [u.to(dev) for u in inputs]
            reset(*mods)
            val, m = spec.loss(p, {"image": a[0], "label": a[1]}, None, cfg)
            g = torch.autograd.grad(val, tree_leaves(p), allow_unused=True,
                                    materialize_grads=True)
            if dev == "cuda":
                torch.cuda.synchronize()
            n = (mods[0].launches, mods[0].bwd_launches)
            vq_params = p if variant == "vqvae" else p["vqvae"]
            with torch.no_grad():
                idx = vqvae.encode_tokens(vq_params, a[0], cfg)
            out[dev] = (n, {k: float(v) for k, v in m.items()},
                        [u.detach().cpu() for u in g], idx.cpu())
        (n_gpu, m_gpu, g_gpu, i_gpu), (n_cpu, m_cpu, g_cpu, i_cpu) = (
            out["cuda"], out["cpu"])
        m_err = max(abs(m_gpu[k] - m_cpu[k]) / max(abs(m_cpu[k]), 1.0)
                    for k in m_cpu)
        g_err = max(float((a - b).abs().max()) / max(float(b.abs().max()),
                                                     1e-30)
                    for a, b in zip(g_gpu, g_cpu))
        frozen = bool(kw.get("vq_freeze_tokenizer"))
        want = VQ_LOSS_LAUNCHES[(variant, arch, frozen)]
        finite = all(bool(torch.isfinite(u).all()) for u in g_gpu)
        ok = (finite and m_err <= VQ_NET_TOL and g_err <= VQ_NET_TOL
              and torch.equal(i_gpu, i_cpu) and n_gpu == want
              and n_cpu == (0, 0))
        tag = f"{variant} {arch}" + "".join(f" {k}" for k in kw)
        print(f"  {tag:34s} B={TRAIN_B} (data seed {seed}, passed over "
              f"{skipped}; margins relu {margins[0]:.1e} code "
              f"{margins[1]:.1e}): metrics max_err/max(|cpu|, 1) "
              f"{m_err:.3e}, {len(g_gpu)} gradients max_err/max|cpu| "
              f"{g_err:.3e} tol {VQ_NET_TOL:.0e}; tokens equal "
              f"{torch.equal(i_gpu, i_cpu)}; (mlp_fwd, mlp_bwd) card {n_gpu} "
              f"(expect {want}) cpu {n_cpu}; perplexity "
              f"{m_gpu['perplexity']:.3f} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"the {tag} loss on the card disagrees with "
                                 "the CPU")
        worst = max(worst, m_err, g_err)
    return worst


def check_vq_tf32(mods, torch):
    """Phase 4k: with torch.backends.cuda.matmul.allow_tf32 forced on,
    the nearest-code distances ([1600, 16] against 64 codes) and the
    attention's two products with their gradients ([100, 4, 16, 32]
    heads) against float64 (VQ_F32_TOL; cuBLAS called directly beside
    them), and one vqprior loss with its gradients bitwise equal to the
    same with the flag off. Returns the worst relative error."""
    from generative_models_tpu_torch.losses import vqprior
    from generative_models_tpu_torch.ops import vq
    from generative_models_tpu_torch.ops.matmul import matmul
    from generative_models_tpu_torch.utils.tree import tree_leaves, tree_map
    gen = torch.Generator(device="cuda").manual_seed(5)
    z = torch.randn(1600, 16, device="cuda", generator=gen)
    book = torch.randn(64, 16, device="cuda", generator=gen)
    q, k = (torch.randn(100, 4, 16, 32, device="cuda", generator=gen)
            for _ in range(2))
    r = torch.randn(100, 4, 16, 16, device="cuda", generator=gen)

    def rel(a, b):
        return float((a.double() - b).abs().max()) / float(b.abs().max())
    cfg = vq_cfg("vqprior")
    params = vqprior.init_params(torch.Generator().manual_seed(6), cfg,
                                 "cuda")
    params["prior"]["head"]["w"].normal_(0.0, 0.1, generator=gen)
    x = torch.rand(TRAIN_B, 784, device="cuda", generator=gen)
    batch = {"image": x, "label": torch.zeros(TRAIN_B, device="cuda")}

    def loss_and_grads():
        p = tree_map(lambda a: a.detach().requires_grad_(True), params)
        val, _ = vqprior.loss(p, batch, None, cfg)
        return [val] + list(torch.autograd.grad(val, tree_leaves(p)))
    flags = torch.backends.cuda.matmul
    prev = flags.allow_tf32
    try:
        flags.allow_tf32 = False
        off = loss_and_grads()
        flags.allow_tf32 = True
        d = vq.code_distances(z, book)
        d_ref = vq.code_distances(z.double(), book.double())
        d_raw = (book * book).sum(-1) - 2.0 * (z @ book.t())
        qq, kk = (t.clone().requires_grad_(True) for t in (q, k))
        s = matmul(qq, kk.transpose(-1, -2))
        gq, gk = torch.autograd.grad((s * r).sum(), (qq, kk))
        q64, k64 = (t.double().requires_grad_(True) for t in (q, k))
        s64 = q64 @ k64.transpose(-1, -2)
        gq64, gk64 = torch.autograd.grad((s64 * r.double()).sum(), (q64, k64))
        s_raw = q @ k.transpose(-1, -2)
        on = loss_and_grads()
        torch.cuda.synchronize()
        on_flag = flags.allow_tf32
    finally:
        flags.allow_tf32 = prev
    errs = {"distances": rel(d, d_ref), "scores": rel(s, s64),
            "d_q": rel(gq, gq64), "d_k": rel(gk, gk64)}
    raw = {"distances": rel(d_raw, d_ref), "scores": rel(s_raw, s64)}
    same = all(torch.equal(a, b) for a, b in zip(on, off))
    ok = on_flag and max(errs.values()) <= VQ_F32_TOL and same
    print(f"  allow_tf32=True: IEEE products vs float64 "
          + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
          + f" tol {VQ_F32_TOL:.0e} (cuBLAS called directly: "
          + ", ".join(f"{k} {v:.2e}" for k, v in raw.items())
          + f"); a vqprior loss and its {len(on) - 1} gradients bitwise equal "
          f"with the flag on and off: {same} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("a VQ product ran off IEEE float32 under the "
                             "global TF32 flag")
    return max(errs.values())


def vq_chain(seed, n, torch, device):
    """Step i -> Gumbel draws [n, VQ_K] from numpy seed (seed, i)."""
    from generative_models_tpu_torch.losses.vqprior import gumbel_of_uniform
    return lambda i: gumbel_of_uniform(torch.from_numpy(
        np.random.default_rng((seed, i)).random((n, VQ_K), dtype=np.float32))
        ).to(device)


def check_vq_samplers(mods, torch):
    """Phase 4k: the prior's samplers (VQ_SAMPLERS) at n VQ_SAMPLE_N on
    the card against the CPU from the same Gumbel chain, the chain's seed
    by the tie rule (sample_margin on the CPU's tokens): the tokens equal
    (and "cache" equal to "full"), the decoded images within
    TOL["float32"], PRIOR_PASS launches a position and the decoder's one.
    Returns {name: (error, launches)}."""
    from generative_models_tpu_torch.losses import vqprior
    from generative_models_tpu_torch.models.vq_net import num_tokens
    from generative_models_tpu_torch.train.trainer import Trainer
    ck_dir = os.path.join(OUT_DIR, "vq_serving")
    os.makedirs(ck_dir, exist_ok=True)
    n, out, tokens = VQ_SAMPLE_N, {}, {}
    for arch, decode in VQ_SAMPLERS:
        cfg = vq_cfg("vqprior", arch, vq_decode=decode)
        ck = os.path.join(ck_dir, f"vqprior_{arch}.npz")
        if not os.path.exists(ck):
            write_model_checkpoint(ck, 111 + len(arch), cfg)
        pair = {}
        for dev in ("cuda", "cpu"):
            pair[dev] = Trainer(config=cfg, device=dev)
            pair[dev].load_model(ck)
        prior_cpu = pair["cpu"].generator_params["prior"]
        for seed in range(TIE_FIRST_SEED, TIE_FIRST_SEED + TIE_MAX_SEEDS):
            chain = vq_chain(seed, n, torch, "cpu")
            toks = vqprior.sample_tokens(prior_cpu, None, n, cfg, None, chain)
            margin = vqprior.sample_margin(prior_cpu, toks, cfg, chain)
            if margin > VQ_TIE_MARGIN:
                break
        imgs, toks = {}, {}
        for dev, t in pair.items():
            reset(*mods)
            imgs[dev] = t.sample(n=n, chain=vq_chain(seed, n, torch, dev))
            if dev == "cuda":
                torch.cuda.synchronize()
                launched = (mods[0].launches, mods[0].bwd_launches)
            toks[dev] = vqprior.sample_tokens(
                t.generator_params["prior"], None, n, cfg, None,
                vq_chain(seed, n, torch, dev)).cpu()
        l = num_tokens(cfg)
        want = (PRIOR_PASS * l + (1 if arch == "mlp" else 0), 0)
        err = float(np.abs(imgs["cuda"] - imgs["cpu"]).max())
        tokens[(arch, decode)] = toks["cuda"]
        same = torch.equal(toks["cuda"], toks["cpu"]) and (
            decode == "cache" or torch.equal(toks["cuda"],
                                             tokens[(arch, "cache")]))
        ok = (same and err <= TOL["float32"] and launched == want
              and np.isfinite(imgs["cuda"]).all())
        name = f"vqprior_{arch}_{decode}"
        print(f"  sampler {name}: n={n} L={l} (chain seed {seed}, margin "
              f"{margin:.1e}) tokens card = cpu" + (" = cache" if decode ==
                                                    "full" else "")
              + f" {same}; images max_abs_err {err:.3e} tol "
              f"{TOL['float32']:.0e}; (mlp_fwd, mlp_bwd) {launched} (expect "
              f"{want}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"the sampler {name} on the card disagrees "
                                 "with the CPU's")
        out[name] = (err, launched[0])
    for name in os.listdir(ck_dir):  # OUT_DIR stays small
        if name.endswith(".npz"):
            os.remove(os.path.join(ck_dir, name))
    return out


def vq_run_launches(variant, arch, frozen, steps):
    """(mlp_fwd, mlp_bwd, linear_cuda) of a CLI run: `steps` training
    steps, evaluate's EVAL_BATCHES losses, and the final grid of
    VQ_SAMPLE_N (the prior's PRIOR_PASS a position, then the decoder)."""
    from generative_models_tpu_torch.models.vq_net import num_tokens
    f, b = VQ_LOSS_LAUNCHES[(variant, arch, frozen)]
    tok = 1 if arch == "mlp" else 0
    prior = PRIOR_PASS if variant == "vqprior" else 0
    grid = prior * num_tokens(vq_cfg(variant, arch)) + tok
    lin = prior * (steps + EVAL_BATCHES) + grid - tok
    return {"mlp_fwd": f * (steps + EVAL_BATCHES) + grid,
            "mlp_bwd": b * steps, "linear_cuda": lin}


def drive_vq_cli(variant, arch, flags, mods, torch, keep=False):
    """Phase 4k: the CLI's run of `variant` on `arch` (VQ_STEPS general
    steps) with --ckpt: launches (vq_run_launches), no chunk launch, the
    loss falling (the last 50 steps' mean below the first 50's), the
    prior's CE below log K at the end, perplexity above 1, every record
    finite; with --vq-from the tokenizer bit for bit the source's params
    in the run's checkpoint, its Adam moments zero. Returns (counts,
    line, checkpoint path, kept when `keep`)."""
    from generative_models_tpu_torch import cli
    from generative_models_tpu_torch.utils.checkpoint import read_leaves
    tag = f"{variant}_{arch}" + "".join(
        f.strip("-").replace("-", "_") for f in flags if f.startswith("--"))
    run_dir = os.path.join(OUT_DIR, "vq", tag)
    ck = os.path.join(run_dir, "ck.npz")
    buf = io.StringIO()
    t0 = time.perf_counter()
    reset(*mods)
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["--variant", variant, "--arch", arch, "--dataset",
                       "synthetic", "--steps", str(VQ_STEPS),
                       "--echo-every", "100", "--out-dir", run_dir,
                       "--ckpt", ck, "--dtype", "float32", *flags])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts(mods)
    out = buf.getvalue().strip()
    print("  " + out.replace("\n", "\n  "))
    line = json.loads([l for l in out.splitlines() if l.startswith("{")][-1])
    with open(os.path.join(run_dir, variant, "metrics.jsonl")) as f:
        recs = [json.loads(l) for l in f]
    finite = all(math.isfinite(v) for r in recs for k, v in r.items()
                 if k != "step")
    losses = [r["loss"] for r in recs]
    first, last = np.mean(losses[:50]), np.mean(losses[-50:])
    frozen = "--vq-from" in flags
    want = vq_run_launches(variant, arch, frozen, VQ_STEPS)
    want.update(reparam=0, reparam_bwd=0, gan_chunk=0, vae_chunk=0,
                birvae_chunk=0)
    got = {k: counts[k] for k in want}
    ok = (rc == 0 and got == want and finite and last < first
          and len(recs) == VQ_STEPS and recs[-1]["perplexity"] > 1.0
          and all(math.isfinite(v) for v in line["eval"].values()))
    more = ""
    if variant == "vqprior":
        ce = float(np.mean([r["prior_loss"] for r in recs[-50:]]))
        ok = ok and ce < math.log(VQ_K)
        more = f", prior CE last 50 {ce:.4f} (log K {math.log(VQ_K):.4f})"
    if frozen:
        src = read_leaves(flags[flags.index("--vq-from") + 1])
        leaves = read_leaves(ck)
        vq_keys = [p for p in leaves if p.startswith("['params']['vqvae']")]
        exact = bool(vq_keys) and all(
            np.array_equal(leaves[p], src[p.replace("['vqvae']", "")])
            for p in vq_keys)
        moments = all(not leaves[p.replace("['params']", f"['opt'][0].{s}")]
                      .any() for p in vq_keys for s in ("mu", "nu"))
        ok = ok and exact and moments and out.startswith(
            "vqprior: frozen tokenizer from")
        more += (f", the tokenizer's {len(vq_keys)} leaves bit for bit the "
                 f"source's {exact}, their Adam moments zero {moments}")
    if not keep:
        os.remove(ck)  # OUT_DIR stays small: checked files go
    print(f"  cli {variant} --arch {arch} {' '.join(flags)}: rc={rc} "
          f"{wall:.1f} s, {line['steps_per_sec']} steps/s, loss first 50 "
          f"{first:.4f} last 50 {last:.4f}, perplexity "
          f"{recs[-1]['perplexity']:.3f}{more}, launches={got} (expect "
          f"{want}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"the CLI run of {variant} --arch {arch} "
                             f"{' '.join(flags)} failed its checks")
    return counts, line, ck


def drive_vq_bf16(mods, torch):
    """Phase 4k: VQ_BF16_STEPS general steps of the MLP vqvae at dtype
    bfloat16: finite, 2 and 2 launches a step."""
    from generative_models_tpu_torch.train.trainer import Trainer
    t = Trainer("vqvae", dtype="bfloat16", dataset="synthetic",
                out_dir=os.path.join(OUT_DIR, "vq_bf16"))
    t._load_data()
    reset(*mods)
    hist = t.train(steps=VQ_BF16_STEPS)
    counts = launch_counts(mods)
    f = 2 * VQ_BF16_STEPS
    finite = all(math.isfinite(v) for vs in hist.values() for v in vs)
    ok = finite and counts["mlp_fwd"] == f and counts["mlp_bwd"] == f
    print(f"  vqvae dtype bfloat16, {VQ_BF16_STEPS} general steps: finite="
          f"{finite} loss {hist['loss'][0]:.3f} -> {hist['loss'][-1]:.3f} "
          f"mlp_fwd={counts['mlp_fwd']} mlp_bwd={counts['mlp_bwd']} (expect "
          f"{f} each) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the bf16 vqvae run failed")
    return counts


def drive_vq_serving(variant, mods, torch):
    """Phase 4k: ``--sample-only --export-sampler`` from a JAX-layout
    checkpoint (the MLP arch): the grid's launches (vqvae: the decoder's
    one; vqprior: PRIOR_PASS a position, then the decoder); the artifact
    on the card bitwise per seed and against Trainer.sample given the
    same Philox draws (``utils/export.py::sampler_draws``) within
    TOL["float32"], vqprior's seed by the tie rule. Returns (launch
    counts, error, seconds)."""
    from generative_models_tpu_torch import cli
    from generative_models_tpu_torch.losses import vqprior
    from generative_models_tpu_torch.train.trainer import Trainer
    from generative_models_tpu_torch.utils import export
    run_dir = os.path.join(OUT_DIR, "vq_serving")
    os.makedirs(run_dir, exist_ok=True)
    cfg = vq_cfg(variant)
    ck = os.path.join(run_dir, f"jax_layout_{variant}.npz")
    art = os.path.join(run_dir, f"{variant}.pt2")
    write_model_checkpoint(ck, 121, cfg)
    buf = io.StringIO()
    reset(*mods)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["--variant", variant, "--ckpt", ck, "--sample-only",
                       "--export-sampler", art, "--out-dir", run_dir])
    wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    counts = launch_counts(mods)
    line = json.loads(buf.getvalue().strip().splitlines()[-1])
    t = Trainer(config=cfg)
    t.load_model(ck)
    n = cfg.sample_n
    seed = EXPORT_SEED
    if variant == "vqprior":
        prior = t.generator_params["prior"]
        for seed in range(TIE_FIRST_SEED, TIE_FIRST_SEED + TIE_MAX_SEEDS):
            draws = export.sampler_draws(
                t.spec, cfg, torch.tensor(seed, device="cuda"), n)
            toks = vqprior.sample_tokens(prior, None, n, cfg, None,
                                         draws["chain"])
            again = export.sampler_draws(
                t.spec, cfg, torch.tensor(seed, device="cuda"), n)["chain"]
            if vqprior.sample_margin(prior, toks, cfg, again) > VQ_TIE_MARGIN:
                break
    fn = export.load_sampler(art, "cuda")
    a, b2 = fn(seed), fn(seed)
    want_img = torch.from_numpy(t.sample(n=n, **export.sampler_draws(
        t.spec, cfg, torch.tensor(seed, device="cuda"), n))).cuda()
    err = float((a - want_img).abs().max())
    f = 1 + (PRIOR_PASS * cfg.vq_tokens if variant == "vqprior" else 0)
    ok = (rc == 0 and line["step"] == 777 and line["sampler"] == art
          and counts["mlp_fwd"] == f and counts["linear_cuda"] == f - 1
          and torch.equal(a, b2) and tuple(a.shape) == (n, 784)
          and err <= TOL["float32"] and bool(torch.isfinite(a).all()))
    print(f"  cli {variant} --sample-only --export-sampler from a JAX-layout "
          f"checkpoint: rc={rc} {wall:.1f} s (grid and export) launches "
          f"mlp_fwd={counts['mlp_fwd']} linear_cuda={counts['linear_cuda']} "
          f"(expect {f}, {f - 1}); the artifact on the card (seed {seed}) "
          f"bitwise repeat {torch.equal(a, b2)}, vs Trainer.sample "
          f"max_abs_err={err:.3e} tol {TOL['float32']:.0e} "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{variant} serving failed its checks")
    for path in (ck, art):  # OUT_DIR stays small: checked files go
        os.remove(path)
    return counts, err, wall


def drive_vq(mods, torch):
    """Phase 4k. Returns (paths, CLI lines, errors)."""
    print("[4k] the VQ family at full width")
    t0 = time.perf_counter()
    errs = {"nets_vs_cpu": check_vq_nets(mods, torch),
            "tf32_vs_float64": check_vq_tf32(mods, torch)}
    print(f"  (nets checked at {time.perf_counter() - t0:.1f} s)")
    errs["samplers_vs_cpu"] = check_vq_samplers(mods, torch)
    print(f"  (samplers checked at {time.perf_counter() - t0:.1f} s)")
    paths, lines = {}, {}
    paths["cli_vqvae_mlp"], lines["cli_vqvae_mlp"], vq_ck = drive_vq_cli(
        "vqvae", "mlp", (), mods, torch, keep=True)
    for variant, arch, flags in (
            ("vqprior", "mlp", ()), ("vqprior", "mlp", ("--vq-from", vq_ck)),
            ("vqprior", "conv", ()), ("vqprior", "mlp", ("--ddpm-cond",))):
        key = f"cli_{variant}_{arch}" + ("_vq_from" if "--vq-from" in flags
                                         else "_cond" if flags else "")
        paths[key], lines[key], _ = drive_vq_cli(variant, arch, flags, mods,
                                                 torch)
    os.remove(vq_ck)
    paths["general_vqvae_bf16"] = drive_vq_bf16(mods, torch)
    print(f"  (CLI and bf16 runs done at {time.perf_counter() - t0:.1f} s)")
    for variant in ("vqvae", "vqprior"):
        paths[f"serving_{variant}"], errs[f"serving_{variant}"], \
            lines[f"export_{variant}_s"] = drive_vq_serving(variant, mods,
                                                            torch)
    print(f"  phase 4k took {time.perf_counter() - t0:.1f} s")
    return paths, lines, errs


# Phase 5i: the VQ family's times. Steps/s of the vqvae and vqprior
# general steps on both archs (the host's clock, VQ_TIME_STEPS steps after
# a warm-up), a step's device time split as 5g splits the conv steps
# (rows 1-3, cuDNN's convolutions, the rest) and the idle share; the
# prior's served images/s at n 64 and 1024 in both decodes, on both
# archs (CUDA events around one Trainer.sample call after a warm-up).
VQ_TIME_STEPS = 50   # (100 until 4l came)
VQ_SERVE_N = (64, 1024)


def time_vq(mods, torch, card):
    """Phase 5i. Returns {"training": {name: row}, "serving": [rows]}."""
    from generative_models_tpu_torch.train import step as step_lib
    from generative_models_tpu_torch.train.trainer import Trainer
    print("[5i] the VQ family's times")
    training = {}
    for variant in ("vqvae", "vqprior"):
        for arch in ("mlp", "conv"):
            t = Trainer(variant, arch=arch, dataset="synthetic",
                        dtype="float32",
                        out_dir=os.path.join(OUT_DIR, "vq_timing"))
            t._load_data()
            t.train(steps=20)  # warm-up
            t.train(steps=VQ_TIME_STEPS)
            sps = VQ_TIME_STEPS / t.wall_time
            train_step = step_lib.build_step(t.spec, t.cfg)
            x = t.x_train[:TRAIN_B].reshape(1, TRAIN_B, -1)
            batches = {"image": x, "label": t.y_train[:TRAIN_B].reshape(1, -1)}
            st = t.state
            gen = torch.Generator(device="cuda").manual_seed(3)
            # each class's count held (a vqprior step runs ~650 kernels;
            # cuBLAS switched a product's algorithm between two steps)
            by_name, total = device_ms_by_name(
                torch, lambda: train_step(st, batches, gen),
                iters=CONV_PROFILE_STEPS, tries=10,
                classes=conv_kernel_class)
            split = None
            if by_name is not None:
                split = {}
                for name, ms in by_name.items():
                    cls = conv_kernel_class(name)
                    split[cls] = split.get(cls, 0.0) + ms
            step_ms = 1e3 / sps
            row = {"steps_per_s": sps, "step_ms": step_ms,
                   "device_ms_per_step": total, "device_split_ms": split,
                   "idle_share": (None if total is None
                                  else max(0.0, 1 - total / step_ms))}
            training[f"{variant}_{arch}"] = row
            print(f"  general step {variant} --arch {arch} B={TRAIN_B}: "
                  f"{sps:.2f} steps/s ({step_ms:.3f} ms a step); device "
                  + ("not measured" if total is None else
                     f"{total:.4f} ms a step (idle share "
                     f"{row['idle_share']:.3f}): " + ", ".join(
                         f"{k} {v:.4f}" for k, v in sorted(split.items())))
                  + f"  [{card}]")
    serving = []
    for arch in ("mlp", "conv"):
        for decode in ("cache", "full"):
            t = Trainer("vqprior", arch=arch, vq_decode=decode)
            for n in VQ_SERVE_N:
                t.sample(n)  # warm-up
                torch.cuda.synchronize()
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                t.sample(n)
                e1.record()
                torch.cuda.synchronize()
                ms = e0.elapsed_time(e1)
                row = {"arch": arch, "decode": decode, "n": n, "ms": ms,
                       "images_per_s": n / ms * 1e3}
                serving.append(row)
                print(f"  serve vqprior --arch {arch} {decode:5s} n={n:4d}: "
                      f"{ms:.1f} ms, {row['images_per_s']:.1f} images/s  "
                      f"[{card}]")
    return {"training": training, "serving": serving}


def time_ms(torch, fn, iters: int) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / iters


def bound_of(flops, nbytes, peak=FP32_FLOP_PER_S):
    """(ms, "bytes" or "operations"): the larger of the bytes at the HBM
    rate and the FLOPs at `peak` (float32 FMA; bf16 work: BF16_FLOP_PER_S,
    the tensor cores' dense rate, the least time the card could take)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops else "operations")


def fwd_bytes(dims, b):
    """The forward's bytes: x, W and b read once, every h written once."""
    mats = sum(k * n for k, n in zip(dims[:-1], dims[1:]))
    return 4 * (b * dims[0] + mats + sum(dims[1:]) + b * sum(dims[1:]))


def fwd_bound(dims, b):
    """Each input read once, each output written once; the FMAs at the
    float32 (non-tensor-core) peak."""
    mats = sum(k * n for k, n in zip(dims[:-1], dims[1:]))
    return bound_of(2.0 * b * mats, fwd_bytes(dims, b))


def bwd_bytes(dims, b):
    """The backward's bytes: x, the hiddens, out, dy and W read once, dW,
    db and dx written once."""
    mats = sum(k * n for k, n in zip(dims[:-1], dims[1:]))
    return 4 * (b * dims[0] + b * sum(dims[1:]) + b * dims[-1]
                + 2 * mats + sum(dims[1:]) + b * dims[0])


def bwd_bound(dims, b):
    """dW and the next g (or dx) of every layer: 4·B·ΣK·N FLOP; the
    bytes of bwd_bytes."""
    mats = sum(k * n for k, n in zip(dims[:-1], dims[1:]))
    return bound_of(4.0 * b * mats, bwd_bytes(dims, b))


def phase_flops(b=TRAIN_B, z=128, h=400, x=784, hd=400, gp=False, n_cls=0,
                codes=0, l=1):
    """(one critic update's FLOPs, one G update's): see
    chunk_flops_per_step."""
    zi, xd = z + n_cls + codes, x + n_cls
    g_fwd = 2 * b * (zi * h + h * x)
    d_pass = 2 * b * (xd * hd + hd * l)
    dh = (2 * b * hd * l) if l > 1 else 0  # a pass's dh = gl W2d^T
    d_update = (g_fwd + 2 * d_pass + 2 * (2 * b) * (xd * hd + hd * l)
                + 2 * dh + (4 * 2 * b * x * hd if gp else 0))
    g_update = (g_fwd + d_pass + dh + 2 * b * hd * x + 2 * b * x * h
                + 2 * b * h * x + 2 * b * zi * h)
    return d_update, g_update


def chunk_flops_per_step(b=TRAIN_B, ds=1, z=128, h=400, x=784, hd=400,
                         ragan=False, gp=False, n_cls=0, codes=0, l=1):
    """d_steps critic updates and one G update; ragan's G update runs the
    critic on the real batch too (one more forward pass of D); the
    penalty (wgangp, dragan) adds four products of 2 B X Hd to each
    critic update (hh, g, s and its part of dW1d); cgan's G and D take
    n_cls more input lanes (G's output and dx stay X wide), infogan's G
    its `codes` lanes. A critic head `l` lanes wide (infogan 15, began's
    autoencoder X) costs 2 B Hd l a pass, and its gradient's row of dh
    (dh = gl W2d^T) 2 B Hd l more in each update, which a one-logit head's
    row warps make negligible."""
    d_update, g_update = phase_flops(b, z, h, x, hd, gp, n_cls, codes, l)
    d_pass = 2 * b * ((x + n_cls) * hd + hd * l)
    return ds * d_update + g_update + (d_pass if ragan else 0)


def chunk_bound(steps, b=TRAIN_B, z=128, h=400, x=784, hd=400, ds=1,
                ragan=False, planes=3, lanes=0, n_cls=0, codes=0, l=1,
                ema=False, bf16=False):
    """The streams read once (the penalty's `lanes` a critic row too), the
    state (params, mu, nu; RMSprop: two planes; with `ema` G's EMA plane
    too) read and written once, the metrics rows written; the FLOPs at
    the float32 peak, or at the bf16 tensor-core peak with `bf16`."""
    zi, xd = z + n_cls + codes, x + n_cls
    g_params = zi * h + h + h * x + x
    params = g_params + xd * hd + hd + hd * l + l
    nbytes = 4 * (steps * b * (ds * (xd + zi + lanes) + zi)
                  + 2 * planes * params + (2 * g_params if ema else 0)
                  + steps * 8)
    return bound_of(steps * chunk_flops_per_step(
        b, ds, z, h, x, hd, ragan=ragan, gp=lanes > 0, n_cls=n_cls,
        codes=codes, l=l), nbytes,
        BF16_FLOP_PER_S if bf16 else FP32_FLOP_PER_S)


def chunk_shape_kw(variant):
    """chunk_flops_per_step's and chunk_bound's shape keywords."""
    if variant == "infogan":
        return dict(codes=INFO_CAT + INFO_CONT, l=INFO_L)
    if variant == "began":
        return dict(hd=BEGAN_HD, l=784)
    return {}


def device_ms_by_name(torch, fn, iters: int = 20, tries: int = 3,
                      classes=None):
    """{kernel name: device ms a call} of every kernel `fn` launches, and
    their sum, from torch.profiler: the events that ran on the card
    (an operator's entry, which holds its kernels' time too, is left
    out). Every name must show a whole multiple of `iters` events (the
    profiler has been seen to lose a kernel's events and so under-read
    it): else it profiles again, and after `tries` returns (None, None)
    and says so, so that no lost events become a device time.
    `classes` (name -> class) holds each class's count to the rule
    instead: cuBLAS and cuDNN may run a product under one algorithm's
    kernel in one call and another's in the next."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        out, count = {}, {}
        for e in prof.events():
            if e.device_type != DeviceType.CUDA:
                continue
            name = e.name.split("(")[0].split("<")[0].replace("void ", "")
            out[name] = (out.get(name, 0.0)
                         + e.time_range.elapsed_us() / iters / 1e3)
            count[name] = count.get(name, 0) + 1
        held = count
        if classes is not None:
            held = {}
            for name, n in count.items():
                held[classes(name)] = held.get(classes(name), 0) + n
        if out and all(c % iters == 0 for c in held.values()):
            return out, sum(out.values())
    print(f"    (torch.profiler: events a kernel over {iters} calls "
          f"{count}; no device time kept)")
    return None, None


def library_mlp(torch, ws, bs, acts, x):
    """The library's forward: addmm and the activation, layer by layer
    (the yardstick the port never calls)."""
    h = x
    for w, b, act in zip(ws, bs, acts):
        h = torch.addmm(b, h, w)
        h = (torch.relu(h) if act == "relu" else torch.sigmoid(h)
             if act == "sigmoid" else torch.nn.functional.leaky_relu(h, 0.2)
             if act == "leaky_relu" else h)
    return h


def time_kernels(cuda_mlp, linear_cuda, cuda_train, torch, card):
    """Phase 5a: per-kernel times beside plain, library and bound: CUDA
    events a call, and device time from torch.profiler (the backward's
    kernels apart, the library's kernels summed). bf16 rows: the
    kernels with bf16 operands beside the library under torch.autocast,
    bounds at the bf16 dense peak."""
    rng = np.random.default_rng(4)
    rows = {"mlp_fwd": [], "linear": [], "mlp_bwd": []}
    bf16 = torch.bfloat16

    def autocast(cdt):
        return (torch.autocast("cuda", dtype=bf16) if cdt is not None
                else contextlib.nullcontext())

    def bound(kind, dims, b, cdt):
        mats = sum(k * n for k, n in zip(dims[:-1], dims[1:]))
        flops = (2.0 if kind == "fwd" else 4.0) * b * mats
        nbytes = (fwd_bytes if kind == "fwd" else bwd_bytes)(dims, b)
        return bound_of(flops, nbytes, FP32_FLOP_PER_S if cdt is None
                        else BF16_FLOP_PER_S)

    fwd_cases = [("G", G_DIMS, G_ACTS, b, None)
                 for b in SERVING_BATCHES[:1] + (TRAIN_B,) + SERVING_BATCHES[1:]]
    fwd_cases += [("D", D_DIMS, D_ACTS, TRAIN_B, None)]
    fwd_cases += [("G", G_DIMS, G_ACTS, b, bf16) for b in (TRAIN_B, 8192)]
    fwd_cases += [(name, dims, acts, TRAIN_B, None)
                  for name, dims, acts in CONV_DENSE]
    fwd_cases += [(name, dims, ("none",), TRAIN_B, None)
                  for name, dims in DIFF_DENSE]
    fwd_cases += [(name, dims, ("none",), VQ_TRAIN_ROWS, None)
                  for name, dims in VQ_DENSE]
    # the GEMM route's main path: the MLP net's six widths at n 10,000
    fwd_cases += [(f"diff_{name}", dims, ("none",), DIFF_GEN_N, None)
                  for name, dims in DIFF_STEP[1:]]
    for name, dims, acts, b, cdt in fwd_cases:
        ws, bs = make_stack(rng, dims, "cuda")
        z = torch.randn(b, dims[0], device="cuda")
        iters = 50 if b >= 8192 else 200
        kern = lambda: cuda_mlp.mlp_fwd(z, ws, bs, acts, 0.2, cdt)
        k_ms = time_ms(torch, kern, iters)
        p_ms = time_ms(torch, lambda: cuda_mlp.mlp_fwd_plain(
            z, ws, bs, acts, 0.2, cdt), iters)

        def lib():
            with autocast(cdt):
                return library_mlp(torch, ws, bs, acts, z)
        l_ms = time_ms(torch, lib, iters)
        _, d_ms = device_ms_by_name(torch, kern)
        _, ld_ms = device_ms_by_name(torch, lib)
        b_ms, b_by = bound("fwd", dims, b, cdt)
        rows["mlp_fwd"].append({
            "shape": f"{name} B={b}" + (" bf16" if cdt else ""),
            "ms": k_ms, "device_ms": d_ms, "plain_ms": p_ms,
            "library_ms": l_ms, "library_device_ms": ld_ms,
            "bound_ms": b_ms, "bound_by": b_by,
            "images_per_s": b / k_ms * 1e3})
    # the one-layer wrapper: 784 -> 400 (leaky), and the conv critic's
    # and encoder's fc
    for dims, act, b in (([784, 400], "leaky_relu", TRAIN_B),
                         ([784, 400], "leaky_relu", 8192),
                         ([CONV_W, 1], "none", TRAIN_B),
                         ([CONV_W, 400], "relu", TRAIN_B)):
        lw, lb = make_stack(rng, dims, "cuda")
        x = torch.randn(b, dims[0], device="cuda")
        kern = lambda: linear_cuda(x, lw[0], lb[0], act)
        k_ms = time_ms(torch, kern, 200)
        p_ms = time_ms(torch, lambda: cuda_mlp.mlp_fwd_plain(
            x, lw, lb, (act,)), 200)
        lib = lambda: library_mlp(torch, lw, lb, (act,), x)
        l_ms = time_ms(torch, lib, 200)
        _, d_ms = device_ms_by_name(torch, kern)
        _, ld_ms = device_ms_by_name(torch, lib)
        b_ms, b_by = fwd_bound(dims, b)
        rows["linear"].append({
            "shape": f"{dims[0]}->{dims[1]} {act} B={b}", "ms": k_ms,
            "device_ms": d_ms,
            "plain_ms": p_ms, "library_ms": l_ms, "library_device_ms": ld_ms,
            "bound_ms": b_ms, "bound_by": b_by})
    # a reverse step's eight launches at n 10,000, one after another
    step = [make_stack(rng, dims, "cuda") for _, dims in DIFF_STEP]
    xs = [torch.randn(DIFF_GEN_N, dims[0], device="cuda")
          for _, dims in DIFF_STEP]

    def kern():
        for x, (lw, lb) in zip(xs, step):
            linear_cuda(x, lw[0], lb[0], "none")

    def plain():
        for x, (lw, lb) in zip(xs, step):
            cuda_mlp.mlp_fwd_plain(x, lw, lb, ("none",))

    def lib():
        for x, (lw, lb) in zip(xs, step):
            library_mlp(torch, lw, lb, ("none",), x)
    _, d_ms = device_ms_by_name(torch, kern)
    _, ld_ms = device_ms_by_name(torch, lib)
    rows["linear"].append({
        "shape": f"diff step (8) n={DIFF_GEN_N}",
        "ms": time_ms(torch, kern, 50), "device_ms": d_ms,
        "plain_ms": time_ms(torch, plain, 50),
        "library_ms": time_ms(torch, lib, 50), "library_device_ms": ld_ms,
        "bound_ms": sum(fwd_bound(dims, DIFF_GEN_N)[0]
                        for _, dims in DIFF_STEP), "bound_by": "operations"})
    for name, dims, acts, b, cdt in (("G", G_DIMS, G_ACTS, TRAIN_B, None),
                                     ("D", D_DIMS, D_ACTS, TRAIN_B, None),
                                     ("G", G_DIMS, G_ACTS, 8192, None),
                                     ("G", G_DIMS, G_ACTS, TRAIN_B, bf16),
                                     ("G", G_DIMS, G_ACTS, 8192, bf16)) + tuple(
            (name, dims, acts, TRAIN_B, None)
            for name, dims, acts in CONV_DENSE) + tuple(
            (name, dims, ("none",), TRAIN_B, None)
            for name, dims in DIFF_DENSE) + tuple(
            (name, dims, ("none",), VQ_TRAIN_ROWS, None)
            for name, dims in VQ_DENSE):
        w, bias = make_stack(rng, dims, "cuda")
        x = torch.randn(b, dims[0], device="cuda")
        out, hid = cuda_mlp.mlp_fwd(x, w, bias, acts, 0.2, cdt)
        dy = torch.randn_like(out)
        iters = 50 if b >= 8192 else 200
        kern = lambda: cuda_mlp.mlp_bwd(x, hid, out, dy, w, acts, 0.2, cdt)
        k_ms = time_ms(torch, kern, iters)
        p_ms = time_ms(torch, lambda: cuda_mlp.mlp_bwd_plain(
            x, hid, out, dy, w, acts, 0.2, cdt), iters)
        # the library: autograd through the addmm stack (backward only)
        lw2 = [t.clone().requires_grad_(True) for t in w]
        lb2 = [t.clone().requires_grad_(True) for t in bias]
        xg = x.clone().requires_grad_(True)
        with autocast(cdt):
            h = library_mlp(torch, lw2, lb2, acts, xg)
        leaves = lw2 + lb2 + [xg]
        dyl = dy.to(h.dtype)
        lib = lambda: torch.autograd.grad(h, leaves, dyl, retain_graph=True)
        l_ms = time_ms(torch, lib, iters)
        by_kernel, d_ms = device_ms_by_name(torch, kern)
        _, ld_ms = device_ms_by_name(torch, lib)
        b_ms, b_by = bound("bwd", dims, b, cdt)
        rows["mlp_bwd"].append({
            "shape": f"{name} B={b}" + (" bf16" if cdt else ""),
            "ms": k_ms, "device_ms": d_ms, "device_ms_by_kernel": by_kernel,
            "plain_ms": p_ms, "library_ms": l_ms, "library_device_ms": ld_ms,
            "bound_ms": b_ms, "bound_by": b_by})
    for key, rs in rows.items():
        for r in rs:
            dev, ldev = r.get("device_ms"), r.get("library_device_ms")
            parts = r.get("device_ms_by_kernel")
            print(f"  {key:8s} {r['shape']:22s} kernel {r['ms']:.4f} ms"
                  + (f" (device {dev:.4f}" if dev else " (device -")
                  + ("".join(f", {k} {v:.4f}" for k, v in sorted(parts.items()))
                     if parts else "") + ")"
                  + f"  plain {r['plain_ms']:.4f}  library "
                  f"{r['library_ms']:.4f}"
                  + (f" (device {ldev:.4f})" if ldev else "")
                  + f"  bound {r['bound_ms']:.4f} ({r['bound_by']})  [{card}]")
    return rows


# Phase 5g: the conv general steps at full width (nsgan, vae): steps/s
# on the host's clock over CONV_TIME_STEPS steps of Trainer.train after
# a warm-up; and one step's kernels' device time from torch.profiler,
# split by kernel name into cuDNN's convolutions (with their layout
# transforms), the hand-written kernels (MLP rows 1-3, the sampling
# kernel row 4) and the rest (GroupNorm, activations, the optimizer, the
# losses), beside the step's time on the host's clock (the idle share).
# The profiler loses events over longer runs (device_ms_by_name's
# whole-multiple rule), so it profiles CONV_PROFILE_STEPS steps at a
# time. (Steps cannot be queued behind a spin kernel, as queued_ms does:
# the optimizer's scalar tensors made on the card synchronise the host
# with it several times a step.)
CONV_TIME_STEPS = 100   # (200 until 4l came)
CONV_PROFILE_STEPS = 2
# (cuBLAS's gemms, named sm80_xmma_gemm_..._cublas, are "rest": the VQ
# family's distances, lookups and attention products run there; the
# cuDNN class took them until PR 15)
CONV_CLASSES = (("hand-written", ("mlp_", "reparam")),
                ("rest", ("cublas", "splitkreduce")),
                ("cudnn_convs", ("conv", "cudnn", "xmma", "implicit_gemm",
                                 "fprop", "dgrad", "wgrad", "nchw", "nhwc")))


def conv_kernel_class(name: str) -> str:
    n = name.lower()
    for cls, keys in CONV_CLASSES:
        if any(k in n for k in keys):
            return cls
    return "rest"


def time_conv_training(mods, torch, card):
    """Phase 5g. Returns {variant: row}."""
    from generative_models_tpu_torch.train import step as step_lib
    from generative_models_tpu_torch.train.trainer import Trainer
    rows = {}
    for variant in ("nsgan", "vae"):
        t = Trainer(variant, arch="conv", fused_step=False,
                    dataset="synthetic", dtype="float32",
                    out_dir=os.path.join(OUT_DIR, "conv_timing"))
        t._load_data()
        t.train(steps=20)  # warm-up
        t.train(steps=CONV_TIME_STEPS)
        sps = CONV_TIME_STEPS / t.wall_time
        cfg, spec = t.cfg, t.spec
        train_step = step_lib.build_step(spec, cfg)
        x = t.x_train[:TRAIN_B].reshape(1, TRAIN_B, -1)
        batches = {"image": x, "label": t.y_train[:TRAIN_B].reshape(1, -1)}
        st = t.state
        if spec.adversarial:
            noise = t._noise(0, 1)
            args = [n[0] for n in noise]
        else:
            gen = torch.Generator(device="cuda").manual_seed(3)
            args = [gen]
        by_name, total = device_ms_by_name(
            torch, lambda: train_step(st, batches, *args),
            iters=CONV_PROFILE_STEPS, tries=6)
        split = None
        if by_name is not None:
            split = {}
            for name, ms in by_name.items():
                cls = conv_kernel_class(name)
                split[cls] = split.get(cls, 0.0) + ms
        step_ms = 1e3 / sps
        rows[variant] = {"steps_per_s": sps, "step_ms": step_ms,
                         "device_ms_per_step": total,
                         "device_split_ms": split,
                         "device_kernels_ms": by_name,
                         "idle_share": (None if total is None
                                        else max(0.0, 1 - total / step_ms))}
        print(f"  conv general step {variant} B={TRAIN_B} C=64: {sps:.2f} "
              f"steps/s ({step_ms:.3f} ms a step); device "
              + ("not measured" if total is None else
                 f"{total:.4f} ms a step (idle share "
                 f"{rows[variant]['idle_share']:.3f}): " + ", ".join(
                     f"{k} {v:.4f}" for k, v in sorted(split.items())))
              + f"  [{card}]")
    return rows


def library_step_loop(torch, steps, variant="nsgan", bf16=False, ema=False,
                      rmsprop=False):
    """The yardstick step the port never calls, at full width with
    torch.addmm + autograd + a foreach optimizer: nsgan (Adam), ragan
    (Adam, the relativistic losses), wgan (RMSprop, 5 critic updates a
    step, each followed by the clamp), wgangp (Adam at betas 0.5/0.9, 5
    critic updates a step, the penalty through autograd.grad with
    create_graph), dragan (the penalty at the perturbed real batch), cgan
    (10 label lanes on G's and D's inputs), lsgan, fgan (jensen_shannon)
    and fishergan (the IPM with the multiplier), began (the autoencoder's
    L1 energies and the k_t law) or infogan (the 15-lane head, the codes
    on G's input, the MI bound in both losses); with `bf16` the step
    runs under torch.autocast (bf16 matmuls), with `ema` G's EMA is
    stepped after each G update (torch._foreach_lerp_), with `rmsprop`
    RMSprop for both networks whatever the variant. Returns steps/s
    (CUDA events)."""
    F = torch.nn.functional
    rng = np.random.default_rng(5)
    n_cls = N_CLS if variant == "cgan" else 0
    codes = INFO_CAT + INFO_CONT if variant == "infogan" else 0
    d_dims = {"began": [784, BEGAN_HD, 784],
              "infogan": [784, 400, INFO_L]}.get(variant, D_DIMS)
    gw, gb = make_stack(rng, [G_DIMS[0] + n_cls + codes] + G_DIMS[1:], "cuda")
    dw, db = make_stack(rng, [d_dims[0] + n_cls] + d_dims[1:], "cuda")
    gp = [t.requires_grad_(True) for t in gw + gb]
    dp = [t.requires_grad_(True) for t in dw + db]
    ds = 5 if variant in ("wgan", "wgangp") else 1
    if variant == "wgan" or rmsprop:
        lr = 5e-5 if variant == "wgan" else 1e-4
        g_opt = torch.optim.RMSprop(gp, lr=lr, alpha=0.99, foreach=True)
        d_opt = torch.optim.RMSprop(dp, lr=lr, alpha=0.99, foreach=True)
    else:
        lr, b2 = (1e-4, 0.9) if variant == "wgangp" else (2e-4, 0.999)
        g_opt = torch.optim.Adam(gp, lr=lr, betas=(0.5, b2), foreach=True)
        d_opt = torch.optim.Adam(dp, lr=lr, betas=(0.5, b2), foreach=True)
    xs = torch.rand(steps, ds, TRAIN_B, 784, device="cuda")
    zs = torch.randn(steps, ds + 1, TRAIN_B, 128, device="cuda")
    us = torch.rand(steps, ds, TRAIN_B, PENALTY_LANES.get(variant, 1),
                    device="cuda")
    ys = F.one_hot(torch.randint(0, max(n_cls, 1), (steps, TRAIN_B),
                                 device="cuda"), max(n_cls, 1)).float()
    cs = torch.cat([F.one_hot(torch.randint(0, INFO_CAT, (steps, ds + 1,
                                                          TRAIN_B),
                                            device="cuda"), INFO_CAT).float(),
                    torch.rand(steps, ds + 1, TRAIN_B, INFO_CONT,
                               device="cuda") * 2 - 1], -1)
    k_t = torch.zeros((), device="cuda")
    g_ema = [t.detach().clone() for t in gp]
    ones = torch.ones(TRAIN_B, device="cuda")
    zeros = torch.zeros(TRAIN_B, device="cuda")
    bce = F.binary_cross_entropy_with_logits

    def G(z):
        return torch.sigmoid(torch.addmm(gb[1], torch.relu(
            torch.addmm(gb[0], z, gw[0])), gw[1]))

    def D(x):
        out = torch.addmm(db[1], F.leaky_relu(
            torch.addmm(db[0], x, dw[0]), 0.2), dw[1])
        if variant == "began":  # the reconstruction
            return torch.sigmoid(out)
        return out if variant == "infogan" else out[:, 0]

    def with_labels(a, k):
        return torch.cat([a, ys[k]], 1) if n_cls else a

    def with_codes(z, k, i):
        return torch.cat([z, cs[k, i]], 1) if codes else z

    def mi(q, c):
        """infogan's CE + fixed-variance NLL of head outputs q."""
        return (-(F.log_softmax(q[:, 1:1 + INFO_CAT], 1)
                  * c[:, :INFO_CAT]).sum(1).mean()
                + 0.5 * ((c[:, INFO_CAT:] - q[:, 1 + INFO_CAT:1 + INFO_CAT
                                                + INFO_CONT]) ** 2).mean())

    def energy(v):
        return (v - D(v)).abs().mean()

    def penalty(xh):
        xh = xh.detach().requires_grad_(True)
        g, = torch.autograd.grad(D(xh).sum(), xh, create_graph=True)
        n = torch.sqrt(g.pow(2).sum(1) + 1e-12)
        return GP_LAM * ((n - 1.0) ** 2).mean()

    def losses(lr, lf):
        """(d_loss, g_loss) of the variant from real and fake logits."""
        if variant in ("wgan", "wgangp"):
            return lf.mean() - lr.mean(), -lf.mean()
        if variant == "lsgan":
            return (0.5 * ((lr - 1.0) ** 2).mean() + 0.5 * (lf ** 2).mean(),
                    0.5 * ((lf - 1.0) ** 2).mean())
        if variant == "fgan":  # jensen_shannon: g_f = log 2 - softplus(-v)
            t_f = math.log(2.0) - F.softplus(-lf)
            f_star = -torch.log(2.0 - torch.exp(t_f))
            return ((F.softplus(-lr) - math.log(2.0)).mean() + f_star.mean(),
                    -f_star.mean())
        if variant == "fishergan":  # lam held at 0 (rho 1e-6 here)
            omega = 0.5 * (lr ** 2).mean() + 0.5 * (lf ** 2).mean()
            c = 1.0 - omega
            return -(lr.mean() - lf.mean() - 0.5e-6 * c * c), -lf.mean()
        if variant == "ragan":
            dr, df = lr - lf.mean(), lf - lr.mean()
            return bce(dr, ones) + bce(df, zeros), \
                bce(df, ones) + bce(dr, zeros)
        return bce(lr, ones) + bce(lf, zeros), bce(lf, ones)

    def step(k):
        with torch.autocast("cuda", dtype=torch.bfloat16, enabled=bf16):
            bare_step(k)
        if ema:
            with torch.no_grad():
                torch._foreach_lerp_(g_ema, gp, 1.0 - EMA_DECAY)

    def bare_step(k):
        nonlocal k_t
        for i in range(ds):
            x = xs[k, i]
            with torch.no_grad():
                fake = G(with_codes(with_labels(zs[k, i], k), k, i))
            if variant == "began":
                l_real = energy(x)
                d_loss = l_real - k_t * energy(fake)
            elif variant == "infogan":
                qf = D(fake)
                d_loss = (bce(D(x)[:, 0], ones) + bce(qf[:, 0], zeros)
                          + INFO_LAM * mi(qf, cs[k, i]))
            else:
                d_loss, _ = losses(D(with_labels(x, k)),
                                   D(with_labels(fake, k)))
            if variant == "wgangp":
                e = us[k, i]
                d_loss = d_loss + penalty(e * x + (1.0 - e) * fake)
            elif variant == "dragan":
                d_loss = d_loss + penalty(
                    x + DRAGAN_SCALE * x.std(correction=0) * us[k, i])
            d_opt.zero_grad(set_to_none=True)
            d_loss.backward()
            d_opt.step()
            if variant == "wgan":
                with torch.no_grad():
                    torch._foreach_clamp_min_(dp, -0.01)
                    torch._foreach_clamp_max_(dp, 0.01)
        if variant == "began":
            g_loss = energy(G(zs[k, ds]))
            with torch.no_grad():  # the k_t law
                k_t = torch.clamp(k_t + BEGAN_LK * (
                    BEGAN_GAMMA * l_real - g_loss), 0.0, 1.0)
        elif variant == "infogan":
            qf = D(G(with_codes(zs[k, ds], k, ds)))
            g_loss = bce(qf[:, 0], ones) + INFO_LAM * mi(qf, cs[k, ds])
        else:
            lf = D(with_labels(G(with_labels(zs[k, ds], k)), k))
            with torch.no_grad():
                lr = D(xs[k, ds - 1]) if variant == "ragan" else lf
            _, g_loss = losses(lr, lf)
        g_opt.zero_grad(set_to_none=True)
        g_loss.backward()
        g_opt.step()

    for k in range(5):
        step(k)
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for k in range(steps):
        step(k)
    e1.record()
    e1.synchronize()
    return steps / e0.elapsed_time(e1) * 1e3


# phase 5b's cases: (variant, d_steps, ChunkHyper fields, library loop?)
TIMED_CASES = (
    ("nsgan", 1, {}, True), ("lsgan", 1, {}, True),
    ("wgan", 5, dict(optimizer="rmsprop", clip=0.01, g_lr=5e-5, d_lr=5e-5),
     True),
    ("fgan", 1, {}, True), ("ragan", 1, {}, True),
    ("fishergan", 1, dict(fisher_rho=1e-6), True),
    ("wgangp", 5, dict(g_lr=1e-4, d_lr=1e-4, b2=0.9, gp_lam=GP_LAM), True),
    ("wgangp", 5, dict(optimizer="rmsprop", g_lr=1e-4, d_lr=1e-4,
                       gp_lam=GP_LAM), True),
    ("dragan", 1, dict(gp_lam=GP_LAM), True),
    ("cgan", 1, dict(n_cls=N_CLS), True),
    ("infogan", 1, dict(g_lr=1e-3, info_cat=INFO_CAT, info_cont=INFO_CONT,
                        info_lam=INFO_LAM), True),
    ("began", 1, dict(began_gamma=BEGAN_GAMMA, began_lambda_k=BEGAN_LK),
     True))


def time_training(cuda_train, torch, card, general_sps, ema_decay=0.0,
                  dtype="float32", cases=None):
    """Phase 5b: steps/s of the chunk kernel on a 1000-step chunk per
    variant, beside the plain version, the bound, and (nsgan, wgan,
    ragan) the general step (phase 4c) and the library step loop; with
    `ema_decay` or `dtype` the EMA or bf16 kernels (phase 5f; the library
    loop likewise with its EMA or under autocast, the bf16 bound at the
    tensor cores' peak). `cases`: the TIMED_CASES to time (all by
    default). Returns {variant: row}."""
    rng = np.random.default_rng(6)
    steps = 1000
    out = {}
    for variant, ds, kw, with_lib in cases or TIMED_CASES:
        hp = chunk_hyper(cuda_train, variant, ema_decay=ema_decay,
                         dtype=dtype, **kw)
        p, mu, nu = chunk_state(rng, torch, **chunk_dims(hp))
        planes = [[torch.from_numpy(a.copy()).cuda() for a in pl]
                  for pl in (p, mu, nu)]
        if not hp.adam:
            planes[1] = None
        ema = ([t.clone() for t in planes[0][:4]] if ema_decay else None)
        rows, lanes = steps * ds * TRAIN_B, PENALTY_LANES.get(variant, 0)
        # (the label lanes' values do not change the work; infogan's
        # codes are one-hot and uniform, as its stream's)
        zw = p[0].shape[0]
        xs = torch.rand(rows, 784 + hp.n_cls, device="cuda")
        if variant == "infogan":
            zd = torch.from_numpy(code_rows_np(rng, rows)).cuda()
            zg = torch.from_numpy(code_rows_np(rng, steps * TRAIN_B)).cuda()
        else:
            zd = torch.randn(rows, zw, device="cuda")
            zg = torch.randn(steps * TRAIN_B, zw, device="cuda")
        xtra = torch.rand(rows, lanes, device="cuda") if lanes else None
        kws = dict(ds=ds, batch=TRAIN_B, t_g=0, t_d=0, hp=hp, ema=ema)

        def rows_of(n_steps):
            n = n_steps * ds * TRAIN_B
            return (xs[:n], zd[:n], zg[:n_steps * TRAIN_B]), dict(
                xtra=None if xtra is None else xtra[:n], steps=n_steps, **kws)

        a10, k10 = rows_of(10)
        cuda_train.gan_chunk(*a10, *planes, **k10)
        a_all, k_all = rows_of(steps)
        k_ms = time_ms(torch, lambda: cuda_train.gan_chunk(
            *a_all, *planes, **k_all), 3)
        # (5f, the EMA and bf16 kernels: shorter plain and library runs,
        # to keep the whole script within its time limit; halved again
        # when 4l came: 20 -> 10 plain steps, 100 -> 50 and 30 -> 15
        # library steps, and 5b's library loops 200 -> 100 and 60 -> 30)
        new = ema is not None or hp.bf16
        p_steps = (10 if new else 50) if ds == 1 else (10 if new else 20)
        a_p, k_p = rows_of(p_steps)
        p_ms = time_ms(torch, lambda: cuda_train.gan_chunk_plain(
            *a_p, *planes, **k_p), 2) * steps / p_steps
        lib_steps = (50 if new else 100) if ds == 1 else (15 if new else 30)
        lib_sps = (library_step_loop(torch, lib_steps, variant, bf16=hp.bf16,
                                     ema=ema is not None, rmsprop=not hp.adam)
                   if with_lib else None)
        b_ms, b_by = chunk_bound(steps, ds=ds, ragan=variant == "ragan",
                                 planes=3 if hp.adam else 2, lanes=lanes,
                                 n_cls=hp.n_cls, ema=ema is not None,
                                 bf16=hp.bf16, **chunk_shape_kw(variant))
        row = {"steps": steps, "d_steps": ds, "optimizer": hp.optimizer,
               "ema_decay": hp.ema_decay, "dtype": hp.dtype,
               "ms": k_ms, "plain_ms": p_ms,
               "library_ms": steps / lib_sps * 1e3 if lib_sps else None,
               "bound_ms": b_ms, "bound_by": b_by,
               "mflop_per_step": chunk_flops_per_step(
                   ds=ds, ragan=variant == "ragan", gp=lanes > 0,
                   n_cls=hp.n_cls, **chunk_shape_kw(variant)) / 1e6,
               "steps_per_s": steps / k_ms * 1e3,
               "plain_steps_per_s": steps / p_ms * 1e3,
               "general_step_steps_per_s": general_sps.get(variant),
               "library_steps_per_s": lib_sps,
               "bound_steps_per_s": steps / b_ms * 1e3}
        gen = general_sps.get(variant)
        print(f"  {variant} (d_steps {ds}, {hp.optimizer}, {hp.dtype}"
              + (f", ema {hp.ema_decay}" if ema is not None else "")
              + f") steps/s at full "
              f"width, B={TRAIN_B}: chunk kernel {row['steps_per_s']:.1f} "
              f"({k_ms:.3f} ms per 1000-step chunk)"
              + (f", general step {gen:.1f}" if gen else "")
              + (f", library step loop {lib_sps:.1f}" if lib_sps else "")
              + f", chunk plain {row['plain_steps_per_s']:.1f}, bound "
              f"{row['bound_steps_per_s']:.1f} ({b_by}, "
              f"{row['mflop_per_step']:.1f} MFLOP a step)  [{card}]")
        # (a second case of a variant, wgangp's RMSprop: by its optimizer)
        out[variant if variant not in out else
            f"{variant}:{hp.optimizer}"] = row
    return out


def vae_flops_per_step(birvae, b=TRAIN_B, x=VAE_X, h=VAE_H, l=VAE_L):
    """Forward 2 B W, the dW products 2 B W, and the dx products of every
    layer but the trunk (its dx is never formed)."""
    w = x * h + (1 if birvae else 2) * h * l + l * h + h * x
    return 2 * b * w + 2 * b * w + 2 * b * (w - x * h)


def vae_chunk_bound(steps, birvae, b=TRAIN_B, x=VAE_X, h=VAE_H, l=VAE_L,
                    ema=False, bf16=False):
    """The streams (x, eps) read once, the state (params, mu, nu; with
    `ema` the EMA plane too) read and written once, the metrics rows
    written; the FLOPs at the float32 peak, or the bf16 tensor-core peak
    with `bf16`."""
    heads = 1 if birvae else 2
    params = x * h + h + heads * (h * l + l) + l * h + h + h * x + x
    nbytes = 4 * (steps * b * (x + l) + 2 * (4 if ema else 3) * params
                  + steps * 3)
    return bound_of(steps * vae_flops_per_step(birvae, b, x, h, l), nbytes,
                    BF16_FLOP_PER_S if bf16 else FP32_FLOP_PER_S)


def time_reparam(cuda_reparam, torch, card):
    """Phase 5c: the sampling kernel and its backward kernel at [100, 20],
    [8192, 20] and [64, 200], each beside its plain version, one library
    call and its bound: ms (CUDA events over 200 back-to-back calls), the
    host's us a call, and the device ms a call with the host out of the
    way (tools/phase_trace.py::queued_ms), the library's too. The library:
    torch.randn and the four-op formula; for the backward
    autograd.grad through that formula's graph. Bounds: mu and logvar
    read, z and kl written; dz, mu, logvar, z and dkl read, dmu and
    dlogvar written. Returns (forward rows, backward rows)."""
    from generative_models_tpu_torch.tools import phase_trace
    rows = {"fwd": [], "bwd": []}
    for b, l in ((TRAIN_B, VAE_L), (8192, VAE_L), (64, 200)):
        mu = torch.randn(b, l, device="cuda")
        lv = torch.randn(b, l, device="cuda") * 0.3
        dz = torch.randn(b, l, device="cuda")
        dkl = torch.randn(b, device="cuda")
        seed = torch.tensor([11, 13], device="cuda")
        z, _ = cuda_reparam.reparam_fwd(mu, lv, seed, 5)

        def library():
            z = mu + torch.exp(0.5 * lv) * torch.randn_like(mu)
            return z, -0.5 * torch.sum(1.0 + lv - mu * mu - torch.exp(lv), -1)

        lm, ll = mu.clone().requires_grad_(True), lv.clone().requires_grad_(True)
        lz = lm + torch.exp(0.5 * ll) * torch.randn_like(mu)
        lk = -0.5 * torch.sum(1.0 + ll - lm * lm - torch.exp(ll), -1)
        calls = {
            "fwd": (lambda: cuda_reparam.reparam_fwd(mu, lv, seed, 5),
                    lambda: cuda_reparam.reparam_and_kl_plain(mu, lv, seed, 5),
                    library, 4 * (3 * b * l + b)),
            "bwd": (lambda: cuda_reparam.reparam_bwd(mu, lv, z, dz, dkl),
                    lambda: cuda_reparam.reparam_bwd_plain(mu, lv, z, dz, dkl),
                    lambda: torch.autograd.grad([lz, lk], [lm, ll], [dz, dkl],
                                                retain_graph=True),
                    4 * (6 * b * l + b))}
        for d, (kern, plain, lib, nbytes) in calls.items():
            b_ms, b_by = bound_of(0.0, nbytes)
            row = {"shape": f"[{b}, {l}]", "ms": time_ms(torch, kern, 200),
                   "host_us": host_us(torch, kern, 200),
                   "device_ms": phase_trace.queued_ms(torch, kern),
                   "plain_ms": time_ms(torch, plain, 50),
                   "library_ms": time_ms(torch, lib, 200),
                   "library_device_ms": phase_trace.queued_ms(torch, lib),
                   "bound_ms": b_ms, "bound_by": b_by}
            rows[d].append(row)
            print(f"  reparam{'_bwd' if d == 'bwd' else ''} {row['shape']:11s}"
                  f" kernel {row['ms']:.4f} ms (device {row['device_ms']:.5f},"
                  f" host {row['host_us']:.1f} us)  plain {row['plain_ms']:.4f}"
                  f"  library {row['library_ms']:.4f} (device "
                  f"{row['library_device_ms']:.5f})  bound {b_ms:.6f} ({b_by})"
                  f"  [{card}]")
    return rows["fwd"], rows["bwd"]


def library_vae_step_loop(torch, steps, birvae, recon, bf16=False,
                          ema=False):
    """The yardstick step the port never calls: the VAE (or BIR-VAE) at
    full width with torch.addmm + autograd + torch.optim.Adam(foreach=True)
    (with `bf16` under torch.autocast; with `ema` every tensor's EMA after
    each update, torch._foreach_lerp_). Returns steps/s (CUDA events)."""
    F = torch.nn.functional
    rng = np.random.default_rng(9)
    x, h, l = VAE_X, VAE_H, VAE_L
    (w_tr,), (b_tr,) = make_stack(rng, [x, h], "cuda")
    (w_mu,), (b_mu,) = make_stack(rng, [h, l], "cuda")
    (w_lv,), (b_lv,) = make_stack(rng, [h, l], "cuda")
    dw, db = make_stack(rng, [l, h, x], "cuda")
    params = [w_tr, b_tr, w_mu, b_mu] + ([] if birvae else [w_lv, b_lv]) \
        + dw + db
    params = [t.requires_grad_(True) for t in params]
    opt = torch.optim.Adam(params, lr=1e-3, betas=(0.9, 0.999), foreach=True)
    xs = torch.rand(steps, TRAIN_B, x, device="cuda")
    es = torch.randn(steps, TRAIN_B, l, device="cuda")
    shadow = [t.detach().clone() for t in params]

    def step(k):
        with torch.autocast("cuda", dtype=torch.bfloat16, enabled=bf16):
            bare_step(k)
        if ema:
            with torch.no_grad():
                torch._foreach_lerp_(shadow, params, 1.0 - EMA_DECAY)

    def bare_step(k):
        henc = torch.relu(torch.addmm(b_tr, xs[k], w_tr))
        m = torch.addmm(b_mu, henc, w_mu)
        if birvae:
            mean = m.mean(0, keepdim=True)
            var = torch.clamp_min((m * m).mean(0, keepdim=True) - mean * mean,
                                  0.0)
            z = (m - mean) * torch.rsqrt(var + 1e-5) + 0.1 * es[k]
            extra = 0.0
        else:
            lv = torch.addmm(b_lv, henc, w_lv)
            z = m + torch.exp(0.5 * lv) * es[k]
            extra = -0.5 * torch.sum(1.0 + lv - m * m - torch.exp(lv)) / TRAIN_B
        lg = torch.addmm(db[1], torch.relu(torch.addmm(db[0], z, dw[0])), dw[1])
        if recon == "bce":
            rec = F.binary_cross_entropy_with_logits(lg, xs[k], reduction="sum")
        else:
            rec = ((torch.sigmoid(lg) - xs[k]) ** 2).sum()
        loss = rec / TRAIN_B + extra
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()

    for k in range(5):
        step(k)
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for k in range(steps):
        step(k)
    e1.record()
    e1.synchronize()
    return steps / e0.elapsed_time(e1) * 1e3


def time_vae_training(ctv, torch, card, general_sps, ema_decay=0.0,
                      dtype="float32"):
    """Phase 5d: steps/s of the VAE and BIR-VAE chunk kernels on a
    1000-step chunk, beside the general step (phase 4c), a library step
    loop, the plain version and the bound; with `ema_decay` or `dtype`
    the EMA or bf16 kernels (phase 5f). Returns {variant: row}."""
    from generative_models_tpu_torch.config import variant_config
    rng = np.random.default_rng(10)
    steps = 1000
    out = {}
    for variant, recon in (("vae", "bce"), ("birvae", "mse")):
        birvae = variant == "birvae"
        p, mu, nu = vae_state(rng, birvae)
        planes = [[torch.from_numpy(a.copy()).cuda() for a in pl]
                  for pl in (p, mu, nu)]
        xs = torch.rand(steps * TRAIN_B, VAE_X, device="cuda")
        es = torch.randn(steps * TRAIN_B, VAE_L, device="cuda")
        hp = ctv.VaeHyper.from_config(variant_config(
            variant, vae_recon=recon, ema_decay=ema_decay, dtype=dtype))
        kernel = ctv.birvae_chunk if birvae else ctv.vae_chunk
        plain = ctv.birvae_chunk_plain if birvae else ctv.vae_chunk_plain
        ema = [t.clone() for t in planes[0]] if ema_decay else None
        kw = dict(batch=TRAIN_B, t=0, hp=hp, ema=ema)
        kernel(xs[:10 * TRAIN_B], es[:10 * TRAIN_B], *planes, steps=10, **kw)
        k_ms = time_ms(torch, lambda: kernel(xs, es, *planes, steps=steps,
                                             **kw), 3)
        p_steps = 50
        p_ms = time_ms(torch, lambda: plain(
            xs[:p_steps * TRAIN_B], es[:p_steps * TRAIN_B], *planes,
            steps=p_steps, **kw), 2) * steps / p_steps
        lib_sps = library_vae_step_loop(torch, 200, birvae, recon,
                                        bf16=hp.bf16, ema=ema is not None)
        b_ms, b_by = vae_chunk_bound(steps, birvae, ema=ema is not None,
                                     bf16=hp.bf16)
        row = {"steps": steps, "recon": recon, "ema_decay": hp.ema_decay,
               "dtype": hp.dtype, "ms": k_ms, "plain_ms": p_ms,
               "library_ms": steps / lib_sps * 1e3, "bound_ms": b_ms,
               "bound_by": b_by, "steps_per_s": steps / k_ms * 1e3,
               "plain_steps_per_s": steps / p_ms * 1e3,
               "general_step_steps_per_s": general_sps[variant],
               "library_steps_per_s": lib_sps,
               "bound_steps_per_s": steps / b_ms * 1e3}
        print(f"  {variant} ({recon}, {hp.dtype}"
              + (f", ema {hp.ema_decay}" if ema is not None else "")
              + f") steps/s at full width, B={TRAIN_B}: "
              f"chunk kernel {row['steps_per_s']:.1f} ({k_ms:.3f} ms per "
              f"1000-step chunk), general step {general_sps[variant]:.1f}, "
              f"library step loop {lib_sps:.1f}, chunk plain "
              f"{row['plain_steps_per_s']:.1f}, bound "
              f"{row['bound_steps_per_s']:.1f} ({b_by})  [{card}]")
        out[variant] = row
    return out


# ---------------------------------------------------------------------
# Data-parallel training: the phase kernels (ops/cuda_dp.py)
# ---------------------------------------------------------------------

# Phase kernel vs its plain version in float64 on the same float32
# inputs, one update's gradients: each gradient tensor by max abs error
# over its max |ref|, the metrics lanes by max abs error. No optimizer
# sits between them (as in the chunk checks, whose 1e-3 covers Adam's
# division by sqrt(v-hat)), so a gradient is a float32 sum of up to 2B
# (penalty: 3B) products of float32 sums of up to 784: a few 1e-7 of the
# tensor's max, far inside 1e-4. wgan's db2d is 0 in exact arithmetic
# (-1/B and +1/B a row): it is held by its absolute error instead.
PHASE_TOL = {"grad": 1e-4, "metrics": 1e-4, "zero": 1e-6}
PHASE_BATCHES = (TRAIN_B, TRAIN_B // 2)
# phase 5e's library versions against the float64 plain version: a check
# that they compute the phase's function (a wrong loss term is off by
# O(1)), float32 rounding and sign ties well inside it
LIBRARY_TOL = 1e-3
# one variant a critic hook of the nine phase libraries
PHASE_CASES = (("nsgan", {}), ("lsgan", {}), ("wgan", {}),
               ("fgan", dict(fgan_div="jensen_shannon")),
               ("wgangp", dict(gp_lam=GP_LAM)), ("dragan", dict(gp_lam=GP_LAM)),
               ("cgan", dict(n_cls=N_CLS)),
               ("infogan", dict(info_cat=INFO_CAT, info_cont=INFO_CONT,
                                info_lam=INFO_LAM)),
               ("began", dict(began_gamma=BEGAN_GAMMA,
                              began_lambda_k=BEGAN_LK)))
PHASE_NAMES = {"d": ("d_w1", "d_b1", "d_w2", "d_b2"),
               "g": ("g_w1", "g_b1", "g_w2", "g_b2")}
# the DP training runs: steps held against the general DP step, and the
# steps of the timed runs
DP_CHECK_STEPS, DP_TIMED_STEPS = 20, 100   # (timed 200 until 4l came)
DP_CASES = (("nsgan", {}), ("wgangp", {"adam_eps": COUPLED_ADAM_EPS}))
# nsgan's D phase buffer: dW1d, db1d, dW2d, db2d and the metrics row
DP_REDUCE_FLOATS = 784 * 400 + 400 + 400 + 1 + 8
# the diffusion and VQ families' world-1 DP runs (4f)
DP_FAMILIES = ("ddpm", "flow", "vqvae", "vqprior")
DP_FAMILY_STEPS = 10

# Phase 4l. Tensor parallelism at tp 2 against the single device, by
# tests/test_tp.py's tolerances and, for wgangp, its length too: 4 steps
# at rtol 5e-4 (its test_tp_second_order_and_sampling). Over 20 steps (100
# critic updates of Adam at beta2 0.9) the two paths' rounding grows to
# 4.5e-4 in the state even in a CPU rehearsal of this phase, where they
# differ only in the order of the row layers' sums. Every case runs at
# COUPLED_ADAM_EPS: at the default eps Adam's first step moves each
# element by about lr whatever the size of its gradient, so an element
# whose gradient nearly cancels (a sum of the other order on each path)
# steps +lr on one path and -lr on the other: nsgan's tp-2 state read
# 3.2e-4 (1.6 lr) from the single device's after 20 steps on an H100 at
# the default eps, its losses within 2.8e-4. TP_TIMED_STEPS more steps of
# each, warm, give the steps/s; the projected cases read D's sigma after
# them, SN_STEPS steps in all, as 4c does (the amortized estimate trails
# the weights: 1.0548 after 20 steps, 1 + 2e-6 after 60 on an H100),
# while the state is held against the single device after TP_STEPS. After
# 60 steps the fresh case reads 2.1e-4 from the single device on an H100,
# the amortized 9.6e-6, tp 2 without the projection 4.5e-8; on the CPU the
# run without the projection drifts (7.0e-5) and the fresh one does not:
# the drift sits in D's first-layer Adam moments, where gradients nearly
# cancel, on whichever path the two sum orders tip (tools/tp_drift.py).
TP_STEPS = 20
TP_TIMED_STEPS = SN_STEPS - TP_STEPS
TP_TOL = dict(rtol=2e-4, atol=1e-5)
TP_EPS = {"adam_eps": COUPLED_ADAM_EPS}
# The spectral projection under tp (nsgan_sn_*: both sn_modes) gathers
# each of D's two weights whole after each critic update
# (parallel/tp.py::on_whole_weights) and projects them on both ranks.
TP_SN = dict(TP_EPS, spectral_projection=True)
TP_CASES = (("nsgan", "nsgan", TP_EPS, TP_TOL, TP_STEPS),
            ("vae", "vae", TP_EPS, TP_TOL, TP_STEPS),
            ("wgangp", "wgangp", TP_EPS, dict(rtol=5e-4, atol=1e-5), 4),
            ("vqprior", "vqprior", TP_EPS, TP_TOL, TP_STEPS),
            ("nsgan_sn_amortized", "nsgan", TP_SN, TP_TOL, TP_STEPS),
            ("nsgan_sn_fresh", "nsgan", dict(TP_SN, sn_mode="fresh"), TP_TOL,
             TP_STEPS))
# A step's launches and collectives under tp 2, worked out beforehand:
# every sharded stack runs one launch of each MLP kernel a layer
# (``parallel/tp.py``), every layer's forward is a linear_cuda call. nsgan:
# the critic update's D(real), G(z) and D(fake), the G update's G and D,
# two layers each (10 forwards), the backward of the four D and G passes
# with a gradient (8); a row layer's g in each of the five passes, and f's
# backward into G's output (6 model all-reduces); the data group's mean a
# update (2). vae: the encoder's trunk, mu and logvar, the decoder's two
# layers (5 / 5), the sampling kernel once each way; g of mu, logvar and
# the decoder's row, f's backward into the decoder's input (4). wgangp
# (d_steps 5): 6 forwards a critic update and 4 for G (34), 4 backwards a
# critic update and 4 for G (24); the penalty's critic pass is the plain
# one (5 a step), with its g forward and f backward, and its double
# backward's f and g (28 model all-reduces in all). vqprior (joint, two
# blocks): the tokenizer's encoder and decoder, two layers each, four
# linears a block and the head (13 / 13); g of the two tokenizer rows and
# of proj and fc2 a block (6), f's backward into the decoder's input and
# into qkv and fc1 a block (5). No case but the projected ones gathers;
# those add two all-gathers a critic update (D's two weights) to nsgan's
# counts.
TP_PER_STEP = {
    "nsgan": dict(mlp_fwd=10, linear_cuda=10, mlp_bwd=8, reparam=0,
                  reparam_bwd=0, plain_passes=0, model_all_reduce=6,
                  data_all_reduce=2, model_all_gather=0),
    "vae": dict(mlp_fwd=5, linear_cuda=5, mlp_bwd=5, reparam=1,
                reparam_bwd=1, plain_passes=0, model_all_reduce=4,
                data_all_reduce=1, model_all_gather=0),
    "wgangp": dict(mlp_fwd=34, linear_cuda=34, mlp_bwd=24, reparam=0,
                   reparam_bwd=0, plain_passes=5, model_all_reduce=28,
                   data_all_reduce=6, model_all_gather=0),
    "vqprior": dict(mlp_fwd=13, linear_cuda=13, mlp_bwd=13, reparam=0,
                    reparam_bwd=0, plain_passes=0, model_all_reduce=11,
                    data_all_reduce=1, model_all_gather=0)}
for _mode in ("amortized", "fresh"):
    TP_PER_STEP[f"nsgan_sn_{_mode}"] = dict(TP_PER_STEP["nsgan"],
                                            model_all_gather=2)
# nsgan G's row output: the model group's all-reduce timed in 4l
TP_REDUCE_FLOATS = TRAIN_B * 784
# pipeline parallelism: the prior at full width, B 100 in 4 microbatches;
# the CE and every leaf after PP_STEPS Adam steps against the single
# device's, at TP_EPS for tp's reason (at the default eps a leaf read
# 1.37e-5 apart after 5 steps on an H100). k's bias in qkv is held
# apart: its gradient is zero in exact
# arithmetic (the softmax ignores a shift shared by every key of a query),
# so Adam turns either path's rounding residue into steps of up to lr
# each, and it is held to PP_STEPS * 2 * lr in absolute value.
PP_MICRO, PP_STEPS, PP_TIMED_STEPS = 4, 5, 10
PP_TOL = dict(rtol=1e-4, atol=1e-5)
PP_CE_TOL = dict(rtol=1e-5, atol=1e-6)
# a stage's launches a step: its block's four linears for each of the 4
# microbatches, each way; the last stage adds the head's
PP_PER_STEP = ({"linear_cuda": 16, "mlp_bwd": 16},
               {"linear_cuda": 20, "mlp_bwd": 20})
MULTIHOST_STEPS = 100


def phase_split(flat, like):
    """A phase's flat buffer as its four gradient tensors and its
    metrics row."""
    parts = flat.split([t.numel() for t in like] + [8])
    return [q.view(t.shape) for q, t in zip(parts, like)], parts[4]


def phase_case(cuda_train, torch, variant, hp, b, seed):
    """A phase check's data from `seed`: the 8 parameters on the card
    (chunk_state's draw; began shifted as its chunk check) and b rows of
    each stream (chunk_streams' draw at one step)."""
    rng = np.random.default_rng(seed)
    p = chunk_state(rng, torch, **chunk_dims(hp))[0]
    if variant == "began":
        p[3] = p[3] + np.float32(BEGAN_SHIFT)
        p[7] = p[7] - np.float32(BEGAN_SHIFT)
    if hp.bf16:  # hidden pre-activations away from 0 (BF16_HIDDEN_SHIFT)
        bf16_shift(p, (1, 5), (2, 6))
    xs, zd, zg, xtra = chunk_streams(rng, torch, variant, 1, 1, hp.n_cls)
    cut = lambda t: None if t is None else t[:b].contiguous()
    return ([torch.from_numpy(a).cuda() for a in p], cut(xs), cut(zd),
            cut(zg), cut(xtra))


def check_phases(cuda_dp, cuda_train, torch):
    """Phase 3h: each hook's D and G phase kernels against their plain
    versions in float64, at b = 100 and 50 (a rank's rows at world 1 and
    2). Returns the worst metrics error."""
    worst = 0.0
    for variant, kw in PHASE_CASES:
        hp = chunk_hyper(cuda_train, variant, **kw)
        lam = BEGAN_K0 if variant == "began" else 0.0
        for b in PHASE_BATCHES:
            tag = f"gan_phase {variant} ({cuda_train.HOOKS[variant]}) b={b}"

            def run_ref(case, probe):
                p, x, zd, zg, xt = case
                p64 = [t.double() for t in p]
                return (cuda_dp.d_phase_plain(
                    x.double(), zd.double(),
                    None if xt is None else xt.double(), p64[:4], p64[4:],
                    lam, hp, probe),
                    cuda_dp.g_phase_plain(zg.double(), p64[:4], p64[4:], hp,
                                          probe))

            case, (d_ref, g_ref) = tie_free_case(
                tag, lambda seed: phase_case(cuda_train, torch, variant, hp,
                                             b, seed),
                run_ref, TIE_MARGIN_OF.get(variant, TIE_MARGIN))
            p, x, zd, zg, xt = case
            got = {"d": cuda_dp.d_phase(x, zd, xt, p[:4], p[4:], lam, hp),
                   "g": cuda_dp.g_phase(zg, p[:4], p[4:], hp)}
            torch.cuda.synchronize()
            if variant == "began":  # k through its pointer: the same bits
                k_dev = torch.tensor(lam, dtype=torch.float32, device="cuda")
                if not torch.equal(cuda_dp.d_phase(x, zd, xt, p[:4], p[4:],
                                                   k_dev, hp), got["d"]):
                    raise AssertionError(f"{tag}: k by pointer and by value "
                                         "differ")
            ok, errs, m_err = True, [], 0.0
            for mode, ref, like in (("d", d_ref, p[4:]), ("g", g_ref, p[:4])):
                gs, m = phase_split(got[mode], like)
                rs, mr = phase_split(ref, like)
                m_err = max(m_err, float((m.double() - mr).abs().max()))
                for name, a, r in zip(PHASE_NAMES[mode], gs, rs):
                    top = float(r.abs().max())
                    e = float((a.double() - r).abs().max())
                    if top < PHASE_TOL["zero"]:  # 0 in exact arithmetic
                        ok = ok and e <= PHASE_TOL["zero"]
                        errs.append((f"{name} (abs)", e))
                    else:
                        ok = ok and e / top <= PHASE_TOL["grad"]
                        errs.append((name, e / top))
            ok = ok and m_err <= PHASE_TOL["metrics"] and all(
                bool(torch.isfinite(t).all()) for t in got.values())
            name, err = max(errs, key=lambda ne: ne[1])
            print(f"  {tag} vs plain(float64): grads max_err/max={err:.3e} "
                  f"({name}; tol {PHASE_TOL['grad']:.0e}) metrics "
                  f"max_abs_err={m_err:.3e} (tol {PHASE_TOL['metrics']:.0e})"
                  f" {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"gan_phase disagrees with its plain "
                                     f"version: {tag}")
            worst = max(worst, m_err)
    return worst


# ---------------------------------------------------------------------
# Phase 3i: the EMA plane and the bf16 path of the chunk and phase
# kernels (ROADMAP Queue 2 item 6)
# ---------------------------------------------------------------------

# The bf16 kernels (one step of every hook's chunk at d_steps 1, every
# hook's D and G phase at b = 100, one step of the VAE and the BIR-VAE)
# against their plain versions in float64 with the same bf16 rounding of
# every product's operands. The two round the same values, but where an
# operand the kernel computed in float32 lies within its float32 error
# of a bf16 rounding boundary (one in ~2^15) the kernel's sits one bf16
# step (2^-8 of itself) away: a sparse error. So each tensor is held by
# its distance (L2, over the reference's norm) from the bf16 oracle
# against the bf16 oracle's own distance from the float32 oracle (what
# the rounding does to that tensor, ~1e-3): at most BF16_RATIO of it,
# plus BF16_FLOOR for tensors the rounding leaves nearly alone; the
# metrics likewise by max abs error. The float32 plain version on the
# CPU, held to the same oracle on this data (data seeds from 10, 30, 50
# and 70), read at most 0.39 of the rounding's effect, on G's first
# layer's Adam slot (mu.g_w1) after the critic's update: the updated
# critic's weights differ from the oracle's by float32 rounding, and each
# weight that lands on the other side of a bf16 boundary moves G's whole
# gradient a little, all of it in the same way; every other tensor, and
# every phase kernel's gradient, read at most 0.11. So a product that
# skipped its rounding shows here where it carries more than half of a
# tensor's rounding effect; the CPU tests hold every product against the
# reference's at small widths, where flips are rare.
# A flipped operand moves the pre-activations it enters by ~2^-8 of one
# term, 1e-4 to 1e-3 of their rms: far more than the tie rule's 1e-6, so
# a hidden unit near 0 would take the other side of its ReLU or
# LeakyReLU in one version only (a jump of the function, which by that
# estimate would hit one check in three to five). So the bf16
# checks shift every hidden layer's bias up by BF16_HIDDEN_SHIFT (the
# pre-activations sit near +3 with an rms of ~0.3, no unit near its kink)
# and take the column means out of the weights that read those layers
# (W2g, W2d, and the VAE's heads and output), so that what the next
# layer sees is the unshifted part: G's output, the logits, began's
# reconstructions (still near 0.12 against fakes near 0.88: no |.| tie)
# and the VAE's latents keep the scale of the float32 checks, and what a
# flip does stays a small smooth error. The kinks themselves are held by
# the float32 checks, whose code the bf16 builds share (wgan's critic is
# clipped to 0.01 and keeps its kinks: its check stands on the tie rule).
# One step at d_steps 1. Each limit is the float32 check's own floor
# (CHUNK_TOL's, PHASE_TOL's, VAE_CHUNK_TOL's metrics limits; BF16_FLOOR
# for a tensor's relative L2) plus BF16_RATIO of the rounding's effect.
# Residue slots and tensors that are 0 in exact arithmetic keep their
# absolute limits (RESIDUE_ABS_TOL, PHASE_TOL["zero"]); with every trunk
# unit active the BIR-VAE's trunk bias gradient is one too: sum_r dhe_r
# = (sum_r g_mu_r) W_mu^T, and sum_r g_mu_r = 0 after the normalisation.
BF16_RATIO = 0.5
BF16_FLOOR = 1e-5
BF16_HIDDEN_SHIFT = 3.0
BF16_RESIDUE = {"birvae": RESIDUE_SLOTS["birvae"] + ("mu.tr_b", "nu.tr_b")}
# their absolute limit: the trunk bias's residue is a float32 sum over
# 100 rows of dhe, each a sum of 20 products (the float32 plain version
# read 2.5e-5 in its mu slot on the CPU, where mu_b's reads 7e-7)
BF16_RESIDUE_ABS_TOL = {"birvae": 1e-4}
# wgan and wgangp take their kernels' d_steps 5 loop in phase 3c; the
# hook's code is the same at d_steps 1, which keeps the bf16 check to
# one update of each network (see above)
BF16_CASES = tuple((v, 1, kw, lam) for v, _, kw, lam in CHUNK_CASES)
# the reference's bf16-vs-float32 bound on a trajectory
# (tests/test_fused_step.py::test_fused_bf16_matmuls_run_and_track_f32)
BF16_RUN_TOL = {"rtol": 0.12, "atol": 0.05}
# library_phases under autocast keeps its activations in bf16 too, a
# rounding the kernels do not make (2^-8 of each value, and more where a
# gradient is a difference of such values). On phase 5f's data (seed 7)
# the nine hooks' yardsticks read 0.012-0.035 (D) and 0.016-0.084 (G,
# infogan's the most) against the float64 plain version on an H100. The
# limit sits above those, and below what the same yardstick reads with
# its head term weighted LIBRARY_PLANTED_W (a wrong loss term): 0.16-0.25
# by the float32 arithmetic (0.25 where the head is the whole loss;
# began's D and infogan's least), which each run reads again and holds
# above the limit.
LIBRARY_BF16_TOL = 0.12
LIBRARY_PLANTED_W = 1.25


def one_per_hook(cuda_train, cases):
    """The first case of each critic hook in `cases`."""
    seen, out = set(), []
    for case in cases:
        hook = cuda_train.HOOKS[case[0]]
        if hook not in seen:
            seen.add(hook)
            out.append(case)
    return tuple(out)


def ema_cases(cuda_train):
    """Phase 3i's EMA cases: every hook's Adam and RMSprop EMA kernels,
    each CHUNK_CASES' first case of that hook and optimizer, or, where it
    has none, the hook's first case with the other optimizer; at most 2
    critic updates a step (the G EMA plane steps once a G update whatever
    d_steps is, and 3c holds d_steps 5; fewer updates keep the tie rule's
    search short)."""
    opt = lambda case: case[2].get("optimizer", "adam")
    cases = []
    for first in one_per_hook(cuda_train, CHUNK_CASES):
        hook = cuda_train.HOOKS[first[0]]
        for o in ("adam", "rmsprop"):
            v, ds, kw, lam = next(
                (c for c in CHUNK_CASES if opt(c) == o
                 and cuda_train.HOOKS[c[0]] == hook),
                (first[0], first[1], dict(first[2], optimizer=o), first[3]))
            cases.append((v, min(ds, 2), kw, lam))
    return tuple(cases)


def bf16_rule(got, ref, ref32, names, residue=(), r_tol=0.0):
    """Phase 3i's bf16 rule over flat lists of tensors (see BF16_RATIO):
    (ok, the worst (name, error, rounding distance) by error over its
    limit)."""
    ok, worst, rows = True, -1.0, None
    for n, a, r, r32 in zip(names, got, ref, ref32):
        a, r, r32 = a.double(), r.double(), r32.double()
        if n in residue or float(r.abs().max()) < PHASE_TOL["zero"]:
            e = float((a - r).abs().max())
            lim = r_tol if n in residue else PHASE_TOL["zero"]
            d = 0.0
        else:
            nr = float(r.norm())
            e, d = float((a - r).norm()) / nr, float((r - r32).norm()) / nr
            lim = BF16_RATIO * d + BF16_FLOOR
        ok = ok and e <= lim
        if e / lim > worst:
            worst, rows = e / lim, (n, e, d)
    return ok, rows


def metrics_rule(m, m_ref, m_ref32, floor):
    """The metrics' max abs error against BF16_RATIO of the rounding's own
    max abs effect, plus the float32 check's `floor`: (ok, error,
    distance)."""
    e = float((m.double() - m_ref.double()).abs().max())
    d = float((m_ref.double() - m_ref32.double()).abs().max())
    return e <= BF16_RATIO * d + floor, e, d


def check_chunk_bf16(cuda_train, torch, ema_decay=0.0):
    """Phase 3i: one step of every hook's bf16 chunk kernel (with
    `ema_decay` its EMA kernel, G's EMA plane held as a state plane)
    against gan_chunk_plain in float64 with the same bf16 rounding
    (BF16_RATIO). Returns the worst metrics error."""
    worst = 0.0
    for variant, ds, kw, lam0 in one_per_hook(cuda_train, BF16_CASES):
        hp = chunk_hyper(cuda_train, variant, dtype="bfloat16",
                         ema_decay=ema_decay, **kw)
        hp32 = dataclasses.replace(hp, dtype="float32")
        kws = dict(steps=1, ds=ds, batch=TRAIN_B, t_g=3, t_d=5, lam=lam0)
        tag = (f"bf16 chunk {variant} ({cuda_train.HOOKS[variant]}, "
               f"{hp.optimizer}{', ema' if ema_decay else ''})")
        planes = functools.partial(chunk_planes, torch, hp)

        def run_ref(case, probe, h=hp):
            state, xs, zd, zg, xtra = case
            ref = planes(state, torch.float64)
            m_ref = cuda_train.gan_chunk_plain(
                xs.double(), zd.double(), zg.double(), *ref[:3], ema=ref[3],
                hp=h, probe=probe,
                xtra=None if xtra is None else xtra.double(), **kws)
            return ref, m_ref

        case, (ref, m_ref) = tie_free_case(
            tag, lambda seed: chunk_case(torch, hp, 1, ds, seed,
                                         ema_decay > 0), run_ref,
            TIE_MARGIN_OF.get(variant, TIE_MARGIN))
        state, xs, zd, zg, xtra = case
        ref32, m_ref32 = run_ref(case, None, hp32)
        got = planes(state, torch.float32)
        m = cuda_train.gan_chunk(xs, zd, zg, *got[:3], ema=got[3], xtra=xtra,
                                 hp=hp, **kws)
        torch.cuda.synchronize()
        flat = lambda pl: [t for part in pl if part is not None
                           for t in part]
        names = [n for n in PLANE_NAMES if hp.adam or not n.startswith("mu.")]
        names += EMA_NAMES if ema_decay else []
        ok, (name, e, d) = bf16_rule(
            flat(got), flat(ref), flat(ref32), names,
            RESIDUE_SLOTS.get(variant, ()), RESIDUE_ABS_TOL.get(variant, 0.0))
        m_ok, m_err, m_d = metrics_rule(m, m_ref, m_ref32,
                                        CHUNK_TOL["metrics"])
        ok = ok and m_ok and bool(torch.isfinite(m).all())
        print(f"  {tag} 1 step B={TRAIN_B} vs plain(float64, bf16 "
              f"operands): metrics max_abs_err={m_err:.3e} (the rounding "
              f"moves them {m_d:.3e}) worst tensor {name}: rel L2 err "
              f"{e:.3e} (the rounding moves it {d:.3e}; limit "
              f"{BF16_RATIO} of that + {BF16_FLOOR:.0e}) "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"the bf16 gan_chunk disagrees with its "
                                 f"plain version: {tag}")
        worst = max(worst, m_err)
    return worst


def check_vae_bf16(ctv, torch):
    """Phase 3i: one step of the bf16 VAE and BIR-VAE chunk kernels against
    their plain versions in float64 with the same bf16 rounding
    (BF16_RATIO). Returns {variant: worst metrics error}."""
    worst = {}
    for variant, recon in (("vae", "bce"), ("birvae", "mse")):
        birvae = variant == "birvae"
        hp = vae_hyper(ctv, variant, recon, dtype="bfloat16")
        hp32 = dataclasses.replace(hp, dtype="float32")
        kw = dict(steps=1, batch=TRAIN_B, t=3)
        kernel = ctv.birvae_chunk if birvae else ctv.vae_chunk
        plain = ctv.birvae_chunk_plain if birvae else ctv.vae_chunk_plain
        planes = functools.partial(vae_planes, torch)

        def run_ref(case, probe, h=hp):
            state, xs, es = case
            ref = planes(state, torch.float64)
            return ref, plain(xs.double(), es.double(), *ref[:3], hp=h,
                              probe=probe, **kw)

        case, (ref, m_ref) = tie_free_case(
            f"bf16 chunk {variant} {recon}",
            lambda seed: vae_case(torch, birvae, 1, seed, bf16=True), run_ref)
        state, xs, es = case
        ref32, m_ref32 = run_ref(case, None, hp32)
        got = planes(state, torch.float32)
        m = kernel(xs, es, *got[:3], hp=hp, **kw)
        torch.cuda.synchronize()
        flat = lambda pl: [t for part in pl[:3] for t in part]
        ok, (name, e, d) = bf16_rule(
            flat(got), flat(ref), flat(ref32), vae_plane_names(birvae),
            BF16_RESIDUE.get(variant, ()), BF16_RESIDUE_ABS_TOL.get(variant, 0.0))
        m_ok, m_err, m_d = metrics_rule(
            m, m_ref, m_ref32,
            VAE_CHUNK_TOL["metrics"] * float(m_ref.abs().max()))
        ok = ok and m_ok and bool(torch.isfinite(m).all())
        print(f"  bf16 chunk {variant} {recon} 1 step B={TRAIN_B} vs "
              f"plain(float64, bf16 operands): metrics max_abs_err="
              f"{m_err:.3e} (the rounding moves them {m_d:.3e}) worst tensor "
              f"{name}: rel L2 err {e:.3e} (the rounding moves it {d:.3e}) "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"the bf16 {variant}_chunk disagrees with "
                                 f"its plain version")
        worst[variant] = m_err
    return worst


def check_phases_bf16(cuda_dp, cuda_train, torch):
    """Phase 3i: each hook's bf16 D and G phase kernels at b = 100 against
    their plain versions in float64 with the same bf16 rounding
    (BF16_RATIO). Returns the worst metrics error."""
    worst = 0.0
    for variant, kw in PHASE_CASES:
        hp = chunk_hyper(cuda_train, variant, dtype="bfloat16", **kw)
        hp32 = dataclasses.replace(hp, dtype="float32")
        lam = BEGAN_K0 if variant == "began" else 0.0
        tag = f"bf16 gan_phase {variant} ({cuda_train.HOOKS[variant]})"

        def run_ref(case, probe, h=hp):
            p, x, zd, zg, xt = case
            p64 = [t.double() for t in p]
            return (cuda_dp.d_phase_plain(
                x.double(), zd.double(), None if xt is None else xt.double(),
                p64[:4], p64[4:], lam, h, probe),
                cuda_dp.g_phase_plain(zg.double(), p64[:4], p64[4:], h,
                                      probe))

        case, refs = tie_free_case(
            tag, lambda seed: phase_case(cuda_train, torch, variant, hp,
                                         TRAIN_B, seed),
            run_ref, TIE_MARGIN_OF.get(variant, TIE_MARGIN))
        refs32 = run_ref(case, None, hp32)
        p, x, zd, zg, xt = case
        got = (cuda_dp.d_phase(x, zd, xt, p[:4], p[4:], lam, hp),
               cuda_dp.g_phase(zg, p[:4], p[4:], hp))
        torch.cuda.synchronize()
        ok, report = True, []
        for mode, flat, ref, ref32, like in zip(
                "dg", got, refs, refs32, (p[4:], p[:4])):
            gs, m = phase_split(flat, like)
            rs, mr = phase_split(ref, like)
            r32, mr32 = phase_split(ref32, like)
            g_ok, (name, e, d) = bf16_rule(gs, rs, r32, PHASE_NAMES[mode])
            m_ok, m_err, m_d = metrics_rule(m, mr, mr32,
                                            PHASE_TOL["metrics"])
            ok = ok and g_ok and m_ok and bool(torch.isfinite(flat).all())
            worst = max(worst, m_err)
            report.append(f"{mode}: {name} rel L2 err {e:.3e} (rounding "
                          f"{d:.3e}), metrics {m_err:.3e} ({m_d:.3e})")
        print(f"  {tag} b={TRAIN_B} vs plain(float64, bf16 operands): "
              + "; ".join(report) + f" {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"the bf16 gan_phase disagrees with its "
                                 f"plain version: {tag}")
    return worst


def dp_counts(cuda_dp, cuda_train, mesh):
    return {"d_phase": cuda_dp.d_launches, "g_phase": cuda_dp.g_launches,
            "d_phase_bf16": cuda_dp.d_bf16_launches,
            "g_phase_bf16": cuda_dp.g_bf16_launches,
            "gan_chunk": cuda_train.launches, "all_reduce": mesh.all_reduces}


def dp_cfg(variant, kw, fused):
    """A DP run's configuration: no sample images at the epoch ends (an
    epoch of the 2000-row split is 20 steps), so the timed runs time the
    steps alone."""
    from generative_models_tpu_torch.config import variant_config
    return variant_config(variant, **{
        "batch_size": TRAIN_B, "dtype": "float32", "fused_step": fused,
        "sample_every": 10 ** 9, **kw})


def check_dp_pair(variant, cfg, what, s_f, h_f, s_g, h_g):
    """The fused DP path's state and metrics after DP_CHECK_STEPS steps
    against the general DP step's, as the cross-check holds the chunk
    (CROSS_TOL; states as numpy by key path)."""
    import torch
    m_err = max(float(np.abs(np.asarray(h_f[k]) - np.asarray(h_g[k])).max())
                for k in h_g)
    names = [n for n in PLANE_NAMES
             if cfg.optimizer == "adam" or not n.startswith("mu.")]

    def planes(st):
        keys = [k for k in st if k.startswith(("['g_params']", "['d_params']",
                                               "['g_opt']", "['d_opt']"))
                and not k.endswith(".count")]
        return [torch.from_numpy(st[k]) for k in keys]
    a, r = planes(s_f), planes(s_g)
    l2 = float(sum(float((x - y).double().pow(2).sum()) for x, y in zip(a, r))
               ** 0.5 / sum(float(y.double().pow(2).sum()) for y in r) ** 0.5)
    ok = (m_err <= CROSS_TOL["metrics"] and l2 <= CROSS_TOL["state"]
          and set(h_f) == set(h_g))
    print(f"  {variant} {what}: fused DP vs general DP step, "
          f"{DP_CHECK_STEPS} steps: metrics_max_abs_err={m_err:.3e} (tol "
          f"{CROSS_TOL['metrics']:.0e}) state rel L2={l2:.3e} (tol "
          f"{CROSS_TOL['state']:.0e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{variant} {what}: the fused DP path and the "
                             f"general DP step disagree")


def drive_dp_world1(cuda_dp, cuda_train, mods, torch, card):
    """Phase 4f: a data group of one rank over NCCL on the card:
    Trainer(fused_step=True, group) against Trainer(fused_step=False,
    group) for DP_CASES, DP_CHECK_STEPS steps each from one seed, with
    the launch counts of each run; then DP_TIMED_STEPS more of each
    (nsgan) for steps/s. Returns ({path: counts}, {route: steps/s})."""
    from generative_models_tpu_torch.parallel import mesh
    from generative_models_tpu_torch.parallel.runs import state_numpy
    from generative_models_tpu_torch.train.trainer import Trainer
    store = os.path.join(OUT_DIR, "dp_world1_store")
    if os.path.exists(store):
        os.remove(store)
    group = mesh.init_data_group(1, 0, "cuda", store_path=store)
    if group.backend != "nccl":
        raise AssertionError(f"world 1 on the card took {group.backend}")
    data = synthetic_split(2000, seed=5)
    paths, sps = {}, {}
    try:
        for variant, kw in DP_CASES:
            ds = max(dp_cfg(variant, kw, True).d_steps, 1)
            runs = {}
            for fused in (True, False):
                t = Trainer(config=dp_cfg(variant, kw, fused), group=group,
                            data=data)
                t._load_data()
                reset(*mods)
                cuda_dp.d_launches = cuda_dp.g_launches = 0
                cuda_dp.d_bf16_launches = cuda_dp.g_bf16_launches = 0
                mesh.all_reduces = 0
                t.train(steps=DP_CHECK_STEPS)
                torch.cuda.synchronize()
                counts = dict(launch_counts(mods),
                              **dp_counts(cuda_dp, cuda_train, mesh))
                name = f"dp1_{'fused' if fused else 'general'}_{variant}"
                paths[name] = counts
                runs[fused] = (t, state_numpy(t.state), t.history)
                n = DP_CHECK_STEPS
                want = ({"d_phase": ds * n, "g_phase": n, "gan_chunk": 0}
                        if fused else {"d_phase": 0, "g_phase": 0,
                                       "gan_chunk": 0})
                got = {k: counts[k] for k in want}
                ok = got == want and counts["all_reduce"] == (ds + 1) * n
                print(f"  {name}: Trainer(fused_step={fused}, group of 1, "
                      f"nccl).train({n}): launches={counts} (expect {want}, "
                      f"{ds + 1} all-reduces a step) {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(f"{name}: wrong launch counts")
            check_dp_pair(variant, runs[True][0].cfg,
                          "world 1 (nccl)", runs[True][1], runs[True][2],
                          runs[False][1], runs[False][2])
            if variant == "nsgan":
                for fused in (True, False):
                    t = runs[fused][0]
                    t.train(steps=DP_TIMED_STEPS)
                    sps[f"world1_{'fused' if fused else 'general'}"] = (
                        DP_TIMED_STEPS / t.wall_time)
                paths["dp1_fused_nsgan_bf16"], sps["world1_fused_bf16"] = \
                    drive_dp_bf16(cuda_dp, cuda_train, mods, torch, group,
                                  data, runs[True][2])
        for variant in DP_FAMILIES:
            paths[f"dp1_general_{variant}"] = drive_dp_family(
                variant, mods, torch, group, data)
        flat = torch.zeros(DP_REDUCE_FLOATS, device="cuda")
        sps["world1_all_reduce_ms"] = time_ms(
            torch, lambda: group.all_reduce_mean_(flat), 50)
    finally:
        mesh.close_data_group()
    print(f"  world 1 (nccl) nsgan steps/s: fused DP "
          f"{sps['world1_fused']:.1f}, general DP step "
          f"{sps['world1_general']:.1f}; all-reduce of the D phase's buffer "
          f"{sps['world1_all_reduce_ms']:.4f} ms  [{card}]")
    return paths, sps


def tp_cfg(variant, kw, tp_size):
    """A 4l run's configuration: config.py's widths, B 100, the general
    step, no sample images during the run."""
    from generative_models_tpu_torch.config import variant_config
    return variant_config(variant, **{
        "batch_size": TRAIN_B, "dtype": "float32", "fused_step": False,
        "sample_every": 10 ** 9, "tp": tp_size, **kw})


def hold_states(got, want, tol, skip=()):
    """(max abs diff, every leaf within `tol`) of two states as numpy by
    key path; `skip`: keys left out (the rng words)."""
    keys = [k for k in want if k not in skip]
    err = max(float(np.abs(np.asarray(got[k]) - np.asarray(want[k])).max(
        initial=0.0)) for k in keys)  # (sn_v's bias leaves are empty)
    return err, set(got) == set(want) and all(
        np.allclose(got[k], want[k], **tol) for k in keys)


def drive_tp(mods, torch, card):
    """Phase 4l, tensor parallelism: TP_CASES on two ranks sharing the
    card over gloo (a 1 x 2 grid on "model"), TP_STEPS steps each, against
    single-device runs on the card from the same seed and draws. Returns
    ({path: counts}, {name: steps/s and ms})."""
    from generative_models_tpu_torch.parallel.mesh import run_ranks
    from generative_models_tpu_torch.parallel.runs import (
        state_numpy,
        tp_trainer_rank,
    )
    from generative_models_tpu_torch.train.trainer import Trainer
    runs = [(tp_cfg(v, kw, 2), n) for _, v, kw, _, n in TP_CASES]
    t0 = time.perf_counter()
    ranks = run_ranks(tp_trainer_rank, 2, "cuda",
                      args=(runs, 2000, 0, VQ_SAMPLE_N, TP_REDUCE_FLOATS,
                            TP_TIMED_STEPS),
                      ranks_share_card=True, timeout=600,
                      grid=(1, 2, "model"))
    print(f"  tp: two ranks on the card (gloo), 1 x 2 grid: "
          f"{time.perf_counter() - t0:.1f} s with the ranks' start")
    data = synthetic_split(2000, seed=0)
    paths, sps = {}, {"tp_all_reduce_ms": max(r["all_reduce_ms"]
                                              for r in ranks)}
    for i, (name, variant, kw, tol, steps) in enumerate(TP_CASES):
        r0, r1 = ranks[0]["runs"][i], ranks[1]["runs"][i]
        if not all(np.array_equal(r0["state"][k], r1["state"][k])
                   for k in r0["state"]):
            raise AssertionError(f"tp {name}: the two ranks' states differ")
        t = Trainer(config=tp_cfg(variant, kw, 1), device="cuda", data=data)
        t._load_data()
        reset(*mods)
        t.train(steps=steps)
        torch.cuda.synchronize()
        single = state_numpy(t.state)
        hist = t.history
        sample = t.sample(VQ_SAMPLE_N)
        t.train(steps=TP_TIMED_STEPS)
        sps[f"single_{name}"] = TP_TIMED_STEPS / t.wall_time
        sps[f"tp2_{name}"] = min(r0["steps_per_s"], r1["steps_per_s"])
        err, close = hold_states(r0["state"], single, tol, ("['rng']",))
        # read, not held: how far the two paths drift apart over the timed
        # steps too, each case beside tp 2 without the projection
        late = steps + TP_TIMED_STEPS
        sps[f"state_diff_{name}_{late}"] = hold_states(
            r0["final_state"], state_numpy(t.state), tol, ("['rng']",))[0]
        print(f"  tp2_{name} vs the single device after {late} steps (read, "
              f"not held): state max abs diff "
              f"{sps[f'state_diff_{name}_{late}']:.3e}  [{card}]")
        h_err = {k: float(np.abs(np.asarray(r0["history"][k])
                                 - np.asarray(hist[k])).max())
                 for k in hist}
        h_ok = all(np.allclose(np.asarray(r0["history"][k]),
                               np.asarray(hist[k]), **tol) for k in hist)
        s_err = float(np.abs(r0["sample"] - sample).max())
        s_ok = np.allclose(r0["sample"], sample, **tol)
        want = {k: v * steps for k, v in TP_PER_STEP[name].items()}
        for rank, r in enumerate((r0, r1)):
            got = {k: r["launches"][k] for k in want}
            ok = got == want and r["launches"]["gan_chunk"] == 0
            print(f"  tp2_{name} rank {rank}: Trainer(group=1 x 2 grid)"
                  f".train({steps}): {r['launches']} (expect {want}, no "
                  f"chunk launch); {TP_TIMED_STEPS} more: "
                  f"{r['steps_per_s']:.2f} steps/s {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"tp2_{name}: wrong counts")
        paths[f"tp2_{name}"] = {k: r0["launches"][k] for k in
                                ("mlp_fwd", "mlp_bwd", "linear_cuda",
                                 "reparam", "reparam_bwd", "gan_chunk")}
        ok = close and h_ok and s_ok
        if kw.get("spectral_projection"):
            target = t.cfg.sn_target * (1 + SN_SIGMA_TOL)
            sig = [float(torch.linalg.svdvals(
                torch.from_numpy(r0["final_state"][k]).double())[0])
                for k in ("['d_params'][0]['w']", "['d_params'][1]['w']")]
            sig_ok = max(sig) <= target
            ok = ok and sig_ok
            print(f"  tp2_{name}: D's largest sigma (SVD) after "
                  f"{TP_STEPS + TP_TIMED_STEPS} steps "
                  f"{[f'{x:.6f}' for x in sig]} (<= {target:.6f}) "
                  f"{'ok' if sig_ok else 'FAIL'}; steps/s against tp 2 "
                  f"without the projection: {sps[f'tp2_{name}']:.2f} vs "
                  f"{sps['tp2_nsgan']:.2f}  [{card}]")
        print(f"  tp2_{name} vs the single device on the card: state max "
              f"abs diff {err:.3e} {'ok' if close else 'FAIL'}, history max "
              f"abs diff {h_err} {'ok' if h_ok else 'FAIL'}, "
              f"sample({VQ_SAMPLE_N}) max abs diff {s_err:.3e} (tol rtol "
              f"{tol['rtol']:.0e} atol {tol['atol']:.0e}); steps/s tp 2 "
              f"{sps[f'tp2_{name}']:.2f}, single device "
              f"{sps[f'single_{name}']:.2f}  [{card}] "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"tp2_{name} disagrees with the single "
                                 f"device")
    print(f"  tp: the model group's all-reduce of {TP_REDUCE_FLOATS} floats "
          f"(gloo, CUDA tensors, two ranks on one card) "
          f"{sps['tp_all_reduce_ms']:.4f} ms  [{card}]")
    return paths, sps


def pp_single(torch, params, tokens, steps, timed):
    """The prior's single-device Adam steps on the card: (losses, params)
    after `steps` as numpy, and the steps/s of `timed` more (host clock,
    warm)."""
    from generative_models_tpu_torch.losses.vqprior import _shift, prior_ce
    from generative_models_tpu_torch.models import ar_prior
    from generative_models_tpu_torch.parallel.runs import _numpy_tree
    from generative_models_tpu_torch.train.optim import apply_opt, init_opt
    from generative_models_tpu_torch.utils.tree import (
        tree_leaves,
        tree_unflatten,
    )
    cfg = tp_cfg("vqprior", TP_EPS, 1)

    def step(params, opt):
        leaves = [t.detach().requires_grad_(True)
                  for t in tree_leaves(params)]
        q = tree_unflatten(params, leaves)
        loss = prior_ce(ar_prior.prior_apply(q, _shift(tokens, cfg), cfg),
                        tokens)
        grads = tree_unflatten(params, list(torch.autograd.grad(loss,
                                                                leaves)))
        params, opt = apply_opt(cfg, params, grads, opt, cfg.g_lr)
        return params, opt, loss.detach()
    opt, losses = init_opt(cfg, params), []
    for _ in range(steps):
        params, opt, loss = step(params, opt)
        losses.append(loss)
    out = _numpy_tree({"losses": torch.stack(losses), "params": params})
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(timed):
        params, opt, _ = step(params, opt)
    torch.cuda.synchronize()
    return out, timed / (time.perf_counter() - t0)


def drive_pp(mods, torch, card):
    """Phase 4l, pipeline parallelism: the prior at full width on two
    ranks sharing the card (1 x 2 on "pipe"), PP_STEPS steps of
    ``build_pp_prior_step`` with n_micro PP_MICRO, against PP_STEPS
    single-device steps on the card. Returns ({path: counts}, {what:
    numbers})."""
    from generative_models_tpu_torch.models import ar_prior
    from generative_models_tpu_torch.parallel import runs
    from generative_models_tpu_torch.parallel.mesh import run_ranks
    from generative_models_tpu_torch.utils.tree import tree_leaves_with_path
    cfg = tp_cfg("vqprior", TP_EPS, 1)
    params = ar_prior.prior_init(torch.Generator().manual_seed(0), cfg)
    tokens = np.random.default_rng(0).integers(
        0, cfg.vq_codebook_size, (TRAIN_B, cfg.vq_tokens)).astype(np.int64)
    case = dict(cfg=cfg, grid=(1, 2), n_micro=PP_MICRO, tokens=tokens,
                params=runs._numpy_tree(params), y=None, steps=PP_STEPS,
                timed=PP_TIMED_STEPS)
    t0 = time.perf_counter()
    got = [r[0] for r in run_ranks(runs.pp_rank, 2, "cuda", args=([case],),
                                   ranks_share_card=True, timeout=600)]
    print(f"  pp: two ranks on the card (gloo), 1 x 2 grid: "
          f"{time.perf_counter() - t0:.1f} s with the ranks' start")
    single, single_sps = pp_single(
        torch, {k: v for k, v in ar_prior.prior_init(
            torch.Generator().manual_seed(0), cfg, "cuda").items()},
        torch.from_numpy(tokens).cuda(), PP_STEPS, PP_TIMED_STEPS)
    r0 = got[0]
    ce_err = float(np.abs(r0["losses"] - single["losses"]).max())
    ok = np.allclose(r0["losses"], single["losses"], **PP_CE_TOL)
    want = dict(tree_leaves_with_path(single["params"]))
    have = dict(tree_leaves_with_path(r0["params"]))
    err = k_err = 0.0
    for k, w in want.items():
        a, b = have[k], w
        if k.endswith("['qkv']['b']"):
            width = a.shape[-1] // 3
            k_err = max(k_err, float(np.abs(a[width:2 * width]
                                            - b[width:2 * width]).max()))
            keep = np.r_[0:width, 2 * width:3 * width]
            a, b = a[keep], b[keep]
        err = max(err, float(np.abs(a - b).max()))
        ok = ok and np.allclose(a, b, **PP_TOL)
    k_bound = PP_STEPS * 2 * cfg.g_lr
    ok = ok and set(have) == set(want) and k_err <= k_bound
    for rank, r in enumerate(got):
        w = {k: v * PP_STEPS for k, v in PP_PER_STEP[rank].items()}
        c = {k: r["counts"][k] for k in w}
        c_ok = c == w and r["counts"]["mlp_fwd"] == w["linear_cuda"]
        print(f"  pp2 stage {rank}: {PP_STEPS} steps of build_pp_prior_step: "
              f"{r['counts']} (expect {w}); {PP_TIMED_STEPS} more: "
              f"{r['steps_per_s']:.2f} steps/s "
              f"{'ok' if c_ok else 'FAIL'}")
        if not c_ok:
            raise AssertionError(f"pp2 stage {rank}: wrong counts")
    sps = min(r["steps_per_s"] for r in got)
    print(f"  pp2 vs the single device on the card, {PP_STEPS} steps: CE max "
          f"abs diff {ce_err:.3e} (tol rtol {PP_CE_TOL['rtol']:.0e} atol "
          f"{PP_CE_TOL['atol']:.0e}), leaves {err:.3e} (rtol "
          f"{PP_TOL['rtol']:.0e} atol {PP_TOL['atol']:.0e}), k's bias "
          f"{k_err:.3e} (<= {k_bound:.1e}); steps/s pp 2 {sps:.2f}, single "
          f"device {single_sps:.2f}  [{card}] {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("pp2 disagrees with the single device")
    paths = {f"pp2_stage{rank}": {k: r["counts"][k] for k in
                                  ("mlp_fwd", "mlp_bwd", "linear_cuda")}
             for rank, r in enumerate(got)}
    return paths, {"pp2_steps_per_s": sps, "single_steps_per_s": single_sps,
                   "ce_err": ce_err, "leaf_err": err}


def probe_gloo_hop(card) -> str:
    """Whether gloo itself sends a CUDA tensor point to point between two
    ranks sharing the card (``parallel/pp.py``'s hops go through host
    memory either way; a rank's crash is an answer). Run by
    ``tools/parallel_smoke.py``: on an H100 the sender's process ends
    in every run so far, so the smoke spends no spawn on it."""
    from generative_models_tpu_torch.parallel import runs
    from generative_models_tpu_torch.parallel.mesh import run_ranks
    try:
        probes = run_ranks(runs.hop_probe, 2, "cuda", ranks_share_card=True,
                           timeout=60)
        probe = "works" if probes == [None, None] else f"fails: {probes}"
    except RuntimeError as e:  # the rank's own last line
        probe = f"fails: {str(e).strip().splitlines()[-1]}"
    print(f"  gloo send/recv of a CUDA tensor, two ranks on the card: "
          f"{probe}  [{card}]")
    return probe


def drive_multihost(mods, torch):
    """Phase 4l, ``--multihost``: ``cli.main`` at WORLD_SIZE 1 over NCCL
    (RANK 0, LOCAL_RANK 0, a rendezvous on localhost), nsgan
    MULTIHOST_STEPS steps: rc 0, its final line, and metrics.jsonl with a
    record a step. Returns (launch counts, the final line)."""
    import contextlib
    import io
    import shutil
    import socket
    from generative_models_tpu_torch import cli
    from generative_models_tpu_torch.parallel import mesh
    sock = socket.socket()
    sock.bind(("localhost", 0))
    port = sock.getsockname()[1]
    sock.close()
    env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
           "MASTER_ADDR": "localhost", "MASTER_PORT": str(port)}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    out_dir = os.path.join(OUT_DIR, "multihost")
    reset(*mods)
    mesh.all_reduces = 0
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["--variant", "nsgan", "--multihost", "--device",
                           "cuda", "--dataset",
                           "synthetic", "--steps", str(MULTIHOST_STEPS),
                           "--batch-size", str(TRAIN_B), "--echo-every", "0",
                           "--sample-every", "-1", "--out-dir", out_dir])
        torch.cuda.synchronize()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    counts = dict(launch_counts(mods), all_reduce=mesh.all_reduces)
    lines = buf.getvalue().strip().splitlines()
    final = json.loads(next(l for l in reversed(lines)
                            if l.startswith("{") and "steps_per_sec" in l))
    with open(os.path.join(out_dir, "nsgan", "metrics.jsonl")) as f:
        recs = [json.loads(l) for l in f]
    shutil.rmtree(out_dir, ignore_errors=True)
    ok = (rc == 0 and final["steps"] == MULTIHOST_STEPS
          and [r["step"] for r in recs] == list(range(MULTIHOST_STEPS))
          and all(np.isfinite(v) for v in final["eval"].values())
          and counts["gan_chunk"] == 0
          and counts["mlp_fwd"] >= 5 * MULTIHOST_STEPS
          and counts["all_reduce"] >= 2 * MULTIHOST_STEPS)
    print(f"  multihost_nsgan: cli.main([... --multihost]) at WORLD_SIZE 1 "
          f"(nccl): rc {rc}, {final}, {len(recs)} metrics.jsonl records, "
          f"launches {counts} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("--multihost at world 1 failed its checks")
    return counts, final


def drive_parallel(mods, torch, card):
    """Phase 4l: tensor and pipeline parallelism on two ranks sharing the
    card, and ``--multihost`` at WORLD_SIZE 1. Returns ({path: counts},
    {what: numbers})."""
    print("[4l] parallelism: tp and pp on two ranks sharing the card "
          "(gloo), --multihost at world 1 (nccl)")
    t0 = time.perf_counter()
    paths, tp_sps = drive_tp(mods, torch, card)
    pp_paths, pp_line = drive_pp(mods, torch, card)
    paths.update(pp_paths)
    paths["multihost_nsgan"], mh_line = drive_multihost(mods, torch)
    print(f"  phase 4l took {time.perf_counter() - t0:.1f} s")
    return paths, {"tp": tp_sps, "pp": pp_line, "multihost": mh_line}


def drive_dp_family(variant, mods, torch, group, data):
    """Phase 4f, the diffusion and VQ families: the general DP step in the
    group of one rank, DP_FAMILY_STEPS steps, against the single device's
    general step from the same seed (the same draws: a rank's generator a
    step, from the data rank), by TP_TOL; the MLP kernels launched, one
    all-reduce a step. Returns the DP run's launch counts."""
    from generative_models_tpu_torch.parallel import mesh
    from generative_models_tpu_torch.parallel.runs import state_numpy
    from generative_models_tpu_torch.train.trainer import Trainer
    cfg = dp_cfg(variant, {}, False)
    runs = {}
    for name, grp in (("dp", group), ("single", None)):
        t = Trainer(config=cfg, device="cuda", group=grp, data=data)
        t._load_data()
        reset(*mods)
        mesh.all_reduces = 0
        t.train(steps=DP_FAMILY_STEPS)
        torch.cuda.synchronize()
        runs[name] = (state_numpy(t.state), t.history,
                      dict(launch_counts(mods), all_reduce=mesh.all_reduces))
    (s_dp, h_dp, counts), (s_1, h_1, c_1) = runs["dp"], runs["single"]
    err = max(float(np.abs(s_dp[k] - s_1[k]).max()) for k in s_1
              if k != "['rng']")
    close = all(np.allclose(s_dp[k], s_1[k], **TP_TOL) for k in s_1
                if k != "['rng']") and all(
        np.allclose(np.asarray(h_dp[k]), np.asarray(h_1[k]), **TP_TOL)
        for k in h_1)
    n = DP_FAMILY_STEPS
    ok = (close and counts["all_reduce"] == n and counts["gan_chunk"] == 0
          and counts["mlp_fwd"] == c_1["mlp_fwd"] > 0
          and counts["mlp_bwd"] == c_1["mlp_bwd"] > 0)
    print(f"  dp1_general_{variant}: Trainer(group of 1, nccl).train({n}) vs "
          f"the single device: state max abs diff {err:.3e} (tol rtol "
          f"{TP_TOL['rtol']:.0e} atol {TP_TOL['atol']:.0e}); launches "
          f"{counts} (single device {c_1['mlp_fwd']} / {c_1['mlp_bwd']}, "
          f"{n} all-reduces) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"dp1_general_{variant} failed its checks")
    return counts


def drive_dp_bf16(cuda_dp, cuda_train, mods, torch, group, data, hist32):
    """Phase 4f, bf16: Trainer(fused_step=True, dtype="bfloat16", group)
    on nsgan, DP_CHECK_STEPS steps from the float32 fused run's seed
    through the bf16 phase libraries (every phase launch counted as bf16),
    its metrics held to the float32 run's (`hist32`) by the reference's
    own bf16 bound (BF16_RUN_TOL); then DP_TIMED_STEPS more for steps/s.
    Returns (launch counts, steps/s)."""
    from generative_models_tpu_torch.parallel import mesh
    from generative_models_tpu_torch.train.trainer import Trainer
    t = Trainer(config=dp_cfg("nsgan", {"dtype": "bfloat16"}, True),
                group=group, data=data)
    t._load_data()
    reset(*mods)
    cuda_dp.d_launches = cuda_dp.g_launches = 0
    cuda_dp.d_bf16_launches = cuda_dp.g_bf16_launches = 0
    mesh.all_reduces = 0
    n = DP_CHECK_STEPS
    t.train(steps=n)
    torch.cuda.synchronize()
    counts = dict(launch_counts(mods), **dp_counts(cuda_dp, cuda_train, mesh))
    want = {"d_phase": n, "g_phase": n, "d_phase_bf16": n, "g_phase_bf16": n,
            "gan_chunk": 0}
    errs = {k: float(np.abs(np.asarray(t.history[k]) - np.asarray(v)).max())
            for k, v in hist32.items()}
    close = all(np.allclose(np.asarray(t.history[k]), np.asarray(v),
                            **BF16_RUN_TOL) for k, v in hist32.items())
    finite = all(np.isfinite(np.asarray(v)).all()
                 for v in t.history.values())
    ok = ({k: counts[k] for k in want} == want
          and counts["all_reduce"] == 2 * n and close and finite)
    print(f"  dp1_fused_nsgan_bf16: Trainer(fused_step=True, dtype=bfloat16, "
          f"group of 1, nccl).train({n}): launches={counts} (expect {want}) "
          f"vs the float32 fused DP run: max abs diff {errs} (the "
          f"reference's bf16 bound rtol {BF16_RUN_TOL['rtol']} atol "
          f"{BF16_RUN_TOL['atol']}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the bf16 fused DP run failed its checks")
    t.train(steps=DP_TIMED_STEPS)
    return counts, DP_TIMED_STEPS / t.wall_time


def drive_dp_shared_card(card):
    """Phase 4g: two ranks sharing the card over gloo (NCCL refuses two
    ranks on one device), b = 50 a rank: the fused DP path against the
    general DP step on nsgan, DP_CHECK_STEPS steps, then DP_TIMED_STEPS
    of each for steps/s. Each rank counts its own launches. Returns
    ({path: counts}, {route: steps/s})."""
    from generative_models_tpu_torch.parallel.mesh import run_ranks
    from generative_models_tpu_torch.parallel.runs import trainer_rank
    runs = [(dp_cfg("nsgan", {}, f), n) for n in (DP_CHECK_STEPS,
                                                   DP_TIMED_STEPS)
            for f in (True, False)]
    t0 = time.perf_counter()
    ranks = run_ranks(trainer_rank, 2, "cuda",
                      args=(runs, 2000, 0, DP_REDUCE_FLOATS),
                      ranks_share_card=True, timeout=300)
    reduce_ms = max(r["all_reduce_ms"] for r in ranks)
    ranks = [r["runs"] for r in ranks]
    print(f"  two ranks on the card (gloo), b={TRAIN_B // 2} a rank: "
          f"{time.perf_counter() - t0:.1f} s with the ranks' start")
    paths, sps = {}, {}
    for rank, res in enumerate(ranks):
        for (cfg, n), r in zip(runs, res):
            fused = cfg.fused_step is True
            want = ({"d_phase": n, "g_phase": n, "gan_chunk": 0} if fused
                    else {"d_phase": 0, "g_phase": 0, "gan_chunk": 0})
            got = {k: r["launches"][k] for k in want}
            ok = got == want and r["launches"]["all_reduce"] == 2 * n
            name = f"dp2_{'fused' if fused else 'general'}_nsgan_{n}"
            print(f"  rank {rank} {name}: launches={r['launches']} (expect "
                  f"{want}, 2 all-reduces a step) "
                  f"{r['steps_per_s']:.1f} steps/s {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"{name} rank {rank}: wrong counts")
            if rank == 0:
                paths[name] = r["launches"]
                if n == DP_TIMED_STEPS:
                    sps[f"shared2_{'fused' if fused else 'general'}"] = \
                        r["steps_per_s"]
    f, g = ranks[0][0], ranks[0][1]
    if not all(np.array_equal(f["state"][k], ranks[1][0]["state"][k])
               for k in f["state"]):
        raise AssertionError("the two ranks' fused DP states differ")
    check_dp_pair("nsgan", runs[0][0], "2 ranks on one card (gloo)",
                  f["state"], f["history"], g["state"], g["history"])
    sps["shared2_all_reduce_ms"] = reduce_ms
    print(f"  two ranks on one card nsgan steps/s: fused DP "
          f"{sps['shared2_fused']:.1f}, general DP step "
          f"{sps['shared2_general']:.1f}; all-reduce of the D phase's "
          f"buffer (gloo, CUDA tensors) {reduce_ms:.4f} ms  [{card}]")
    return paths, sps


def phase_bound(mode, b, variant, hp):
    """The bound of one phase launch: its FLOPs (phase_flops) at the
    float32 peak (bf16 operands: the bf16 tensor-core peak), or its bytes
    (the 8 parameters and its streams read, its gradients and metrics
    row written) at the HBM rate."""
    peak = BF16_FLOP_PER_S if hp.bf16 else FP32_FLOP_PER_S
    kw = chunk_shape_kw(variant)
    d_f, g_f = phase_flops(b, gp=hp.gp_lam > 0, n_cls=hp.n_cls, **kw)
    zi = 128 + hp.n_cls + kw.get("codes", 0)
    xd, hd, l = 784 + hp.n_cls, kw.get("hd", 400), kw.get("l", 1)
    g_n = zi * 400 + 400 + 400 * 784 + 784
    d_n = xd * hd + hd + hd * l + l
    if mode == "d":
        lanes = PENALTY_LANES.get(variant, 0)
        nbytes = 4 * (g_n + d_n + b * (xd + zi + lanes) + d_n + 8)
        return bound_of(d_f, nbytes, peak)
    return bound_of(g_f, 4 * (g_n + d_n + b * zi + g_n + 8), peak)


def time_phases(cuda_dp, cuda_train, torch, card, dtype="float32",
                variants=None):
    """Phase 5e: each hook's phase kernels at b = 100 and 50 beside their
    float32 plain versions on the card, their bounds, and the library's
    same gradients (library_phases), which are first held against the
    float64 plain version (LIBRARY_TOL); with `dtype` "bfloat16" (phase
    5f) the bf16 kernels at b = 100, the library under autocast
    (LIBRARY_BF16_TOL), the bound at the tensor cores' peak. `variants`:
    the hooks' variants to time (every one by default)."""
    from generative_models_tpu_torch.tools import phase_trace
    rows = []
    bf16 = dtype == "bfloat16"
    for variant, kw in PHASE_CASES:
        if variants and variant not in variants:
            continue
        hp = chunk_hyper(cuda_train, variant, dtype=dtype, **kw)
        lam = BEGAN_K0 if variant == "began" else 0.0
        for b in (TRAIN_B,) if bf16 else PHASE_BATCHES:
            # (the float32 checks' data: BF16_HIDDEN_SHIFT serves a check,
            # and its hidden layers near +3 make the library's bf16
            # activations cancel in wgan's dW2d = sum (hr - hf) / B)
            p, x, zd, zg, xt = phase_case(
                cuda_train, torch, variant,
                dataclasses.replace(hp, dtype="float32"), b, seed=7)
            g, d = p[:4], p[4:]
            calls = {"d": (lambda: cuda_dp.d_phase(x, zd, xt, g, d, lam, hp),
                           lambda: cuda_dp.d_phase_plain(x, zd, xt, g, d, lam,
                                                         hp)),
                     "g": (lambda: cuda_dp.g_phase(zg, g, d, hp),
                           lambda: cuda_dp.g_phase_plain(zg, g, d, hp))}
            lib, planted = (
                library_phases(torch, cuda_train, hp, x, zd, zg, xt, g, d,
                               lam, w) for w in (1.0, LIBRARY_PLANTED_W))
            if bf16:
                lib, planted = ({m: functools.partial(under_autocast, torch,
                                                      fn)
                                 for m, fn in fns.items()}
                                for fns in (lib, planted))
            p64 = [t.double() for t in p]
            ref = {"d": cuda_dp.d_phase_plain(
                x.double(), zd.double(), None if xt is None else xt.double(),
                p64[:4], p64[4:], lam, hp),
                "g": cuda_dp.g_phase_plain(zg.double(), p64[:4], p64[4:], hp)}
            for mode, (kern, plain) in calls.items():
                like = d if mode == "d" else g
                l_err = library_err(torch, lib[mode](), ref[mode], like)
                p_err = library_err(torch, planted[mode](), ref[mode], like)
                lim = LIBRARY_BF16_TOL if bf16 else LIBRARY_TOL
                if not l_err <= lim < p_err:
                    raise AssertionError(
                        f"library_phases {variant} {mode} b={b}: err "
                        f"{l_err:.3e}, with a wrong loss term {p_err:.3e}: "
                        f"the limit {lim} does not part them")
                b_ms, b_by = phase_bound(mode, b, variant, hp)
                row = {"kernel": f"gan_phase_{mode}" + ("_bf16" if bf16
                                                         else ""),
                       "variant": variant,
                       "hook": cuda_train.HOOKS[variant], "b": b,
                       "ms": time_ms(torch, kern, 50),
                       "host_us": host_us(torch, kern, 50),
                       "device_ms": phase_trace.queued_ms(torch, kern),
                       "plain_ms": time_ms(torch, plain, 10),
                       "library_ms": time_ms(torch, lib[mode], 50),
                       "library_err": l_err, "library_planted_err": p_err,
                       "bound_ms": b_ms, "bound_by": b_by}
                rows.append(row)
                dev = row["device_ms"]
                print(f"  {row['kernel']} {variant:7s} b={b:3d} kernel "
                      f"{row['ms']:.4f} ms"
                      + (f" (device {dev:.4f})" if dev else "")
                      + f" host {row['host_us']:.1f} us a call"
                      + f"  plain {row['plain_ms']:.4f}"
                      + f"  library {row['library_ms']:.4f} (err {l_err:.1e};"
                      + f" wrong loss {p_err:.1e})"
                      + f"  bound {b_ms:.5f} ({b_by})  [{card}]")
    return rows


def host_us(torch, fn, iters: int) -> float:
    """The host's clock around `iters` enqueues of fn, over `iters`, in
    us: what a call costs the host (the card may still be working)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    us = (time.perf_counter() - t0) / iters * 1e6
    torch.cuda.synchronize()
    return us


# the phase kernels traced phase by phase (tools/phase_trace.py) in 5e
# (float32, b 100 and 50) and 5f (bf16, b 100)
TRACE_VARIANTS = ("nsgan", "wgangp", "infogan", "began")


def trace_phases(card):
    """Phase 5e/5f: the phase kernels' µs a phase (an instrumented copy:
    block 0 reads the global timer at each phase's end), with the call's
    CUDA-event and host times beside: float32 at b = 100 and 50, bf16 at
    b = 100 (the instrumented libraries built at once). Returns the rows
    of each dtype."""
    from generative_models_tpu_torch.tools import phase_trace
    specs = ([f"{v}:{b}" for v in TRACE_VARIANTS for b in PHASE_BATCHES]
             + [f"{v}:{TRAIN_B}:bf16" for v in TRACE_VARIANTS])
    rows = phase_trace.measure(specs, trace=True)
    for row in rows:
        print("  " + phase_trace.line("trace", row) + f"  [{card}]")
    return ([r for r in rows if not r["spec"].endswith("bf16")],
            [r for r in rows if r["spec"].endswith("bf16")])


def check_phase_device(rows, trace_rows, card):
    """Phase 5e/5f: each phase kernel's device ms a call (queued behind a
    spin, time_phases) against the instrumented copy's trace of the same
    spec (entry to the last mark, trace_phases): within 0.9-1.5x of it
    (the call adds its launch and the kernel's entry and exit), or a
    device time is wrong and the phase fails."""
    for t in trace_rows:
        variant, b, _ = t["spec"].split(":") + [""] * (3 - len(
            t["spec"].split(":")))
        kernel = f"gan_phase_{t['mode']}" + ("_bf16" if "bf16" in t["spec"]
                                              else "")
        row = next(r for r in rows if r["kernel"] == kernel
                   and r["variant"] == variant and r["b"] == int(b))
        ratio = row["device_ms"] * 1e3 / t["device_us"]
        print(f"  {kernel} {variant:7s} b={b:3s} device {row['device_ms']:.4f}"
              f" ms, trace {t['device_us'] / 1e3:.4f} ms: {ratio:.3f}x  "
              f"[{card}]")
        if not 0.9 <= ratio <= 1.5:
            raise AssertionError(f"{kernel} {variant} b={b}: device "
                                 f"{row['device_ms']:.4f} ms against a "
                                 f"trace of {t['device_us'] / 1e3:.4f} ms")


def under_autocast(torch, fn):
    """fn() under torch.autocast to bf16: phase 5f's library yardstick."""
    with torch.autocast("cuda", dtype=torch.bfloat16):
        return fn()


def library_phases(torch, cuda_train, hp, x, zd, zg, xt, g, d, lam, w=1.0):
    """Each hook's two phases as one library call each: addmm forwards
    and torch.autograd.grad of the hook's loss (the penalty's input
    gradient through autograd.grad with create_graph, as
    ops/penalty.py builds it); the port never calls these. `w` weights
    the hook's head term (began: the real rows' energy, and G's), 1 in
    the loss: LIBRARY_PLANTED_W plants a wrong loss. Returns {"d": fn,
    "g": fn}, each giving the four gradients."""
    F = torch.nn.functional
    sp = F.softplus
    v = hp.variant
    nc, nm = hp.info_cat, hp.info_cont
    gf, _, fstar, _ = cuda_train._FGAN_TABLE[hp.fgan_div]

    def G(p, z):
        return torch.sigmoid(torch.addmm(p[3], torch.relu(
            torch.addmm(p[1], z, p[0])), p[2]))

    def D(p, u):
        return torch.addmm(p[3], F.leaky_relu(torch.addmm(p[1], u, p[0]),
                                              hp.slope), p[2])

    def labelled(fake, rows):  # cgan: the fake beside its rows' labels
        if not hp.n_cls:
            return fake
        return torch.cat([fake, rows[:, rows.shape[1] - hp.n_cls:]], 1)

    def mi(o, z):  # infogan: CE + the fixed-variance NLL of the codes
        t = z[:, z.shape[1] - nc - nm:]
        return (-(F.log_softmax(o[:, 1:1 + nc], 1) * t[:, :nc]).sum(1).mean()
                + 0.5 * ((t[:, nc:] - o[:, 1 + nc:1 + nc + nm]) ** 2).mean())

    def energy(p, u):  # began: the autoencoder's L1 energy
        return (u - torch.sigmoid(D(p, u))).abs().mean()

    def d_head(lr, lf):
        if v == "lsgan":
            return 0.5 * ((lr - 1.0) ** 2).mean() + 0.5 * (lf ** 2).mean()
        if v in ("wgan", "wgangp"):
            return lf.mean() - lr.mean()
        if v == "fgan":
            return -gf(lr).mean() + fstar(gf(lf)).mean()
        return sp(-lr).mean() + sp(lf).mean()

    def g_head(lf):
        if v == "lsgan":
            return 0.5 * ((lf - 1.0) ** 2).mean()
        if v in ("wgan", "wgangp"):
            return -lf.mean()
        if v == "fgan":
            return -(gf(lf) if hp.fgan_ns else fstar(gf(lf))).mean()
        if v == "mmgan":
            return -sp(lf).mean()
        return sp(-lf).mean()

    def d_grads():
        dd = [t.detach().requires_grad_(True) for t in d]
        with torch.no_grad():
            fake = G(g, zd)
        if v == "began":
            return torch.autograd.grad(
                w * energy(dd, x) - lam * energy(dd, fake), dd)
        lr, lf = D(dd, x), D(dd, labelled(fake, x))
        if v == "infogan":
            loss = (w * (sp(-lr[:, 0]).mean() + sp(lf[:, 0]).mean())
                    + hp.info_lam * mi(lf, zd))
        else:
            loss = w * d_head(lr[:, 0], lf[:, 0])
        if hp.gp_lam:
            xh = xt if v == "dragan" else xt * x + (1.0 - xt) * fake
            xh = xh.detach().requires_grad_(True)
            gx, = torch.autograd.grad(D(dd, xh).sum(), xh, create_graph=True)
            n = torch.sqrt(gx.pow(2).sum(1) + 1e-12)
            loss = loss + hp.gp_lam * ((n - 1.0) ** 2).mean()
        return torch.autograd.grad(loss, dd)

    def g_grads():
        gg = [t.detach().requires_grad_(True) for t in g]
        fake = G(gg, zg)
        if v == "began":
            return torch.autograd.grad(w * energy(d, fake), gg)
        lf = D(d, labelled(fake, zg))
        if v == "infogan":
            loss = w * sp(-lf[:, 0]).mean() + hp.info_lam * mi(lf, zg)
        else:
            loss = w * g_head(lf[:, 0])
        return torch.autograd.grad(loss, gg)
    return {"d": d_grads, "g": g_grads}


def library_err(torch, lib_grads, plain_flat, like):
    """The library's gradients against the plain version's (float64):
    max abs error over max |ref|, the worst of the four tensors."""
    ref, _ = phase_split(plain_flat, like)
    return max(float((a.double() - r).abs().max())
               / max(float(r.abs().max()), PHASE_TOL["zero"])
               for a, r in zip(lib_grads, ref))


# Phase 3j: the product engine (csrc/chunk_common.cuh) at widths ragged
# for every tile class: rows, columns and depth none a multiple of 16
# (the tiles are 16 or 32 rows, 32 or 64 columns, 16-deep stages). nsgan
# and the VAE over 8 steps against their plain versions in float64, held
# by CHUNK_TOL and VAE_CHUNK_TOL, the data by the tie rule.
RAGGED_GAN = dict(b=37, z=70, h=203, x=389, hd=211)
RAGGED_VAE = dict(b=37, x=389, h=203, l=13)
# Phase 3k: the chunk kernels twice from one state give the same bits in
# every plane and in the metrics (every sum has a fixed order).
REPEAT_CASES = (("nsgan", 1, {}), ("wgangp", 5, dict(b2=0.9, gp_lam=GP_LAM)),
                ("infogan", 1, dict(info_cat=INFO_CAT, info_cont=INFO_CONT,
                                    info_lam=INFO_LAM)), ("vae", 1, {}))


def check_chunk_ragged(cuda_train, ctv, torch):
    """Phase 3j. Returns the worst metrics error (GAN: absolute; VAE:
    over max |ref|)."""
    steps, w, v = 8, RAGGED_GAN, RAGGED_VAE
    hp = chunk_hyper(cuda_train, "nsgan")
    kws = dict(steps=steps, ds=1, batch=w["b"], t_g=3, t_d=5, hp=hp)
    cuda = lambda a: torch.from_numpy(a).cuda()

    def make(seed):
        rng = np.random.default_rng(seed)
        state = chunk_state(rng, torch, z=w["z"], h=w["h"], x=w["x"],
                            hd=w["hd"]) + (None,)
        rows = steps * w["b"]
        return (state, cuda(rng.random((rows, w["x"]), dtype=np.float32)),
                cuda(rng.standard_normal((rows, w["z"]), dtype=np.float32)),
                cuda(rng.standard_normal((rows, w["z"]), dtype=np.float32)))

    planes = functools.partial(chunk_planes, torch, hp)

    def run_ref(case, probe):
        state, xs, zd, zg = case
        ref = planes(state, torch.float64)
        return ref, cuda_train.gan_chunk_plain(
            xs.double(), zd.double(), zg.double(), *ref[:3], probe=probe,
            **kws)

    tag = "chunk nsgan ragged " + " ".join(f"{k}={n}" for k, n in w.items())
    (state, xs, zd, zg), (ref, m_ref) = tie_free_case(tag, make, run_ref)
    got = planes(state, torch.float32)
    m = cuda_train.gan_chunk(xs, zd, zg, *got[:3], **kws)
    torch.cuda.synchronize()
    g_err = float((m - m_ref).abs().max())
    s_l2, s_name, s_err, _ = held_state_err("nsgan", got, ref, PLANE_NAMES)
    ok = (g_err <= CHUNK_TOL["metrics"] and s_err <= CHUNK_TOL["state"]
          and bool(torch.isfinite(m).all()))
    print(f"  {tag} steps={steps} vs plain(float64): metrics_max_abs_err="
          f"{g_err:.3e} (tol {CHUNK_TOL['metrics']:.0e}) state max_err/max="
          f"{s_err:.3e} ({s_name}; tol {CHUNK_TOL['state']:.0e}) rel L2="
          f"{s_l2:.3e} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"gan_chunk disagrees with its plain version: "
                             f"{tag}")

    vhp = vae_hyper(ctv, "vae", "bce")
    vkw = dict(steps=steps, batch=v["b"], t=3, hp=vhp)
    dims = [(v["x"], v["h"]), (v["h"], v["l"]), (v["h"], v["l"]),
            (v["l"], v["h"]), (v["h"], v["x"])]

    def make_vae(seed):
        rng = np.random.default_rng(seed)
        p = []
        for i, o in dims:
            bound = 1.0 / np.sqrt(i)
            p += [rng.uniform(-bound, bound, (i, o)).astype(np.float32),
                  rng.uniform(-bound, bound, (o,)).astype(np.float32)]
        mu = [rng.normal(0, 1e-3, a.shape).astype(np.float32) for a in p]
        nu = [rng.uniform(0, 1e-5, a.shape).astype(np.float32) for a in p]
        rows = steps * v["b"]
        return ((p, mu, nu, None),
                cuda(rng.random((rows, v["x"]), dtype=np.float32)),
                cuda(rng.standard_normal((rows, v["l"]), dtype=np.float32)))

    vplanes = functools.partial(vae_planes, torch)

    def run_vae_ref(case, probe):
        state, xs, es = case
        ref = vplanes(state, torch.float64)
        return ref, ctv.vae_chunk_plain(xs.double(), es.double(), *ref[:3],
                                        probe=probe, **vkw)

    vtag = "chunk vae bce ragged " + " ".join(f"{k}={n}" for k, n in v.items())
    (state, xs, es), (ref, m_ref) = tie_free_case(vtag, make_vae, run_vae_ref)
    got = vplanes(state, torch.float32)
    m = ctv.vae_chunk(xs, es, *got[:3], **vkw)
    torch.cuda.synchronize()
    v_err = float((m - m_ref).abs().max()) / float(m_ref.abs().max())
    s_l2, s_name, s_err, _ = held_state_err("vae", got, ref,
                                            vae_plane_names(False))
    ok = (v_err <= VAE_CHUNK_TOL["metrics"]
          and s_err <= VAE_CHUNK_TOL["state"] and bool(torch.isfinite(m).all()))
    print(f"  {vtag} steps={steps} vs plain(float64): metrics max_err/max="
          f"{v_err:.3e} (tol {VAE_CHUNK_TOL['metrics']:.0e}) state "
          f"max_err/max={s_err:.3e} ({s_name}; tol "
          f"{VAE_CHUNK_TOL['state']:.0e}) rel L2={s_l2:.3e} "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"vae_chunk disagrees with its plain version: "
                             f"{vtag}")
    return max(g_err, v_err)


def check_chunk_repeat(cuda_train, ctv, torch):
    """Phase 3k: each REPEAT_CASES kernel, float32 and bf16, run twice
    for 8 steps from one state: every plane and the metrics bitwise
    equal."""
    steps = 8
    for variant, ds, kw in REPEAT_CASES:
        for dtype in ("float32", "bfloat16"):
            if variant == "vae":
                hp = vae_hyper(ctv, "vae", "bce", dtype=dtype)
                state, xs, es = vae_case(torch, False, steps, 3,
                                         bf16=hp.bf16)

                def run(pl):
                    return ctv.vae_chunk(xs, es, *pl[:3], steps=steps,
                                         batch=TRAIN_B, t=3, hp=hp)
                planes = functools.partial(vae_planes, torch)
            else:
                hp = chunk_hyper(cuda_train, variant, dtype=dtype, **kw)
                state, xs, zd, zg, xtra = chunk_case(torch, hp, steps, ds, 3)

                def run(pl):
                    return cuda_train.gan_chunk(
                        xs, zd, zg, *pl[:3], steps=steps, ds=ds,
                        batch=TRAIN_B, t_g=3, t_d=5, hp=hp, xtra=xtra)
                planes = functools.partial(chunk_planes, torch, hp)
            a, b = planes(state, torch.float32), planes(state, torch.float32)
            m_a, m_b = run(a), run(b)
            torch.cuda.synchronize()
            flat = lambda pl: [t for part in pl[:3] if part for t in part]
            same = torch.equal(m_a, m_b) and all(
                torch.equal(x, y) for x, y in zip(flat(a), flat(b)))
            print(f"  repeat {variant} d_steps={ds} {dtype}: 8 steps twice "
                  f"from one state, {len(flat(a))} tensors and the metrics "
                  f"bitwise equal: {same}")
            if not same:
                raise AssertionError(f"the {variant} {dtype} chunk kernel "
                                     f"does not repeat bit for bit")


def chunk_libraries(cuda_train, cuda_dp, ctv, build_dir):
    """Phase 2's line a chunk library: its kernels' largest register
    count and spill bytes (ptxas), the dynamic shared bytes a block and
    the blocks an SM the occupancy query grants each kernel; and the
    engine's tile rule on the card against ops/chunk_plan.py's."""
    from generative_models_tpu_torch.ops import chunk_plan
    libs = {}
    for log in sorted(glob.glob(os.path.join(build_dir, "*.log"))):
        name = os.path.basename(log).split("-")[0][3:]
        if "chunk" not in name and "phase" not in name:
            continue
        with open(log) as f:
            text = f.read()
        regs = [int(n) for n in re.findall(r"Used (\d+) registers", text)]
        spill = [int(a) + int(b) for a, b in re.findall(
            r"(\d+) bytes spill stores, (\d+) bytes spill loads", text)]
        libs[name] = (max(regs or [0]), sum(spill))
    granted = {}
    for hook in cuda_train.HOOK_IDS:
        for bf16 in (False, True):
            lib = cuda_train._lib(hook, bf16)
            name = cuda_train.lib_name("gan_chunk", hook, bf16)
            granted[name] = (lib.gm_gan_chunk_smem_bytes(), [
                lib.gm_gan_chunk_blocks_per_sm(r, e)
                for r in (0, 1) for e in (0, 1)])
    for hook in cuda_dp.DP_HOOKS:
        for bf16 in (False, True):
            lib = cuda_dp._lib(hook, bf16)
            name = cuda_train.lib_name("gan_phase", hook, bf16)
            granted[name] = (lib.gm_gan_phase_smem_bytes(), [
                lib.gm_gan_phase_blocks_per_sm(m) for m in (1, 2)])
    for bf16 in (False, True):
        lib = ctv._lib(bf16)
        granted["vae_chunk" + ("_bf16" if bf16 else "")] = (
            lib.gm_vae_chunk_smem_bytes(), [
                lib.gm_vae_chunk_blocks_per_sm(b, e)
                for b in (0, 1) for e in (0, 1)])
    for name, (smem, occ) in granted.items():
        regs, spill = libs.get(name, (None, None))
        print(f"    {name}: {regs} registers (the most of its kernels), "
              f"{spill} spill bytes, {smem} dynamic shared bytes a block, "
              f"blocks an SM granted {occ}")
    lib = cuda_train._lib("bce")
    sms = torch_sms()
    jobs = set()
    for hook in cuda_train.HOOK_IDS:
        for mode in ("chunk",) + (("d", "g") if hook in cuda_dp.DP_HOOKS
                                  else ()):
            for b in (TRAIN_B,) if mode == "chunk" else PHASE_BATCHES:
                for phase in chunk_plan.gan_phase_jobs(
                        hook, b=b, z=128, h=400, x=784, hd=400,
                        l=INFO_L if hook == "info" else 784 if hook == "be"
                        else 1, mode=mode):
                    jobs.update(phase[1])
    for phase in chunk_plan.vae_phase_jobs(False, b=TRAIN_B, x=VAE_X, h=VAE_H,
                                           l=VAE_L):
        jobs.update(phase[1])
    wrong = [(m, n, k, nb) for m, n, k in sorted(jobs)
             for nb in (1, 37, sms, 2 * sms)
             if lib.gm_gan_chunk_tile_class(m, n, k, nb)
             != chunk_plan.tile_class(m, n, k, nb)]
    print(f"    tile classes of {len(jobs)} flagship jobs (the chunk's, and "
          f"the phase kernels' at b {PHASE_BATCHES}) at 4 block counts: "
          f"the card's rule and ops/chunk_plan.py's agree: {not wrong}")
    if wrong:
        raise AssertionError(f"the tile rule differs from chunk_plan's: "
                             f"{wrong[:5]}")
    least = {(hook, m, dims): (
        cuda_dp._lib(hook).gm_gan_phase_min_grid(
            1 if m == "d" else 2, *dims, l),
        chunk_plan.dp_min_grid(m, x=dims[0], h=dims[1], hd=dims[2], l=l))
        for hook in cuda_dp.DP_HOOKS for m in ("d", "g")
        for dims in ((784, 400, 400), (389, 203, 211))
        for l in ((INFO_L if hook == "info" else dims[0] if hook == "be"
                   else 1),)}
    wrong = {k: v for k, v in least.items() if v[0] != v[1]}
    print(f"    the phase kernels' least grid ({len(least)} hooks, modes "
          f"and widths): the card's and ops/chunk_plan.py's agree: "
          f"{not wrong}; flagship D {least[('bce', 'd', (784, 400, 400))][0]}"
          f", G {least[('bce', 'g', (784, 400, 400))][0]} blocks, the grid "
          f"{sms}")
    if wrong or max(v[0] for v in least.values()) > sms:
        raise AssertionError(f"the phase kernels' least grid: {wrong} "
                             f"(the grid {sms})")
    return granted


# Phase 4m: the measured fused-step policy (ops/fused_policy.py). Each
# case's A/B runs POLICY_AB_STEPS steps a rep (3 reps an arm, the best
# taken, after a warm-up chunk) at the training shapes; the CLI then
# trains POLICY_CLI_STEPS steps of nsgan at B 100 with "auto" and the
# cached verdict. A second resolve must read the cache: no launch, under
# POLICY_CACHED_S seconds.
POLICY_AB_STEPS = 64
POLICY_CASES = (("nsgan", TRAIN_B), ("vae", TRAIN_B), ("wgangp", TRAIN_B),
                ("nsgan", 1024))
POLICY_CLI_STEPS = 100
POLICY_CACHED_S = 1.0


def policy_cfg(variant, b):
    """A 4m case's configuration as the Trainer resolves it (dtype
    float32), so its policy key is the CLI run's."""
    from generative_models_tpu_torch.config import variant_config
    return variant_config(variant, batch_size=b, dtype="float32")


def drive_policy(mods, torch, card):
    """Phase 4m: ``resolve_fused_step`` with measurement on for
    POLICY_CASES (both arms' steps/s and the verdict), the second call
    from the cache, the CLI's run following the cached verdict (its
    launches show the arm), and a failed measurement cached nowhere.
    Returns ({path: counts}, {case: numbers})."""
    from generative_models_tpu_torch import cli
    from generative_models_tpu_torch.losses.registry import get_variant
    from generative_models_tpu_torch.ops import cuda_train
    from generative_models_tpu_torch.ops import fused_policy as fp
    print(f"[4m] the measured fused-step policy ({POLICY_AB_STEPS} A/B steps "
          f"a rep)")
    cache = os.path.join(OUT_DIR, "policy_4m.json")
    if os.path.exists(cache):
        os.remove(cache)
    saved = {k: os.environ.get(k) for k in ("GMTPU_FUSED_AB",
                                            "GMTPU_FUSED_AB_STEPS",
                                            "GMTPU_POLICY_CACHE")}
    os.environ.update(GMTPU_FUSED_AB="1", GMTPU_POLICY_CACHE=cache,
                      GMTPU_FUSED_AB_STEPS=str(POLICY_AB_STEPS))
    lines, paths = {}, {}
    try:
        for variant, b in POLICY_CASES:
            cfg, spec = policy_cfg(variant, b), get_variant(variant)
            key = f"{fp.host_tag('cuda')}::{fp.policy_key(cfg)}"
            t0 = time.perf_counter()
            verdict = cuda_train.resolve_fused_step(spec, cfg, "cuda")
            first_s = time.perf_counter() - t0
            entry = fp._load_cache().get(key)
            reset(*mods)
            t0 = time.perf_counter()
            again = cuda_train.resolve_fused_step(spec, cfg, "cuda")
            cached_s = time.perf_counter() - t0
            quiet = not any(launch_counts(mods).values())
            ok = (entry is not None and entry["use_fused"] == verdict
                  and again == verdict and quiet
                  and cached_s < POLICY_CACHED_S)
            name = f"{variant}_b{b}"
            lines[name] = {"verdict": "fused" if verdict else "general",
                           **(entry or {}), "first_s": first_s,
                           "cached_s": cached_s}
            print(f"  {name}: fused {entry and entry['fused_steps_per_sec']} "
                  f"steps/s, general {entry and entry['general_steps_per_sec']}"
                  f" steps/s -> {lines[name]['verdict']} (A/B {first_s:.2f} s; "
                  f"second call {cached_s * 1e3:.2f} ms from the cache, no "
                  f"launch: {quiet})  [{card}] {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"4m {name}: the policy did not measure "
                                     "and cache its verdict")
        # the CLI follows the cached verdict for nsgan at B 100
        verdict = lines[f"nsgan_b{TRAIN_B}"]["verdict"]
        run_dir = os.path.join(OUT_DIR, "policy_cli")
        buf = io.StringIO()
        reset(*mods)
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["--variant", "nsgan", "--dataset", "synthetic",
                           "--steps", str(POLICY_CLI_STEPS), "--echo-every",
                           "0", "--out-dir", run_dir])
        torch.cuda.synchronize()
        counts = launch_counts(mods)
        paths["cli_nsgan_auto_measured"] = counts
        if verdict == "fused":
            ok = counts["gan_chunk"] == 1 and counts["mlp_bwd"] == 0
        else:
            ok = (counts["gan_chunk"] == 0
                  and counts["mlp_bwd"] == 4 * POLICY_CLI_STEPS)
        print(f"  cli nsgan, fused_step auto, the cached verdict {verdict}: "
              f"rc={rc} launches {counts} {'ok' if ok and rc == 0 else 'FAIL'}")
        if not (ok and rc == 0):
            raise AssertionError("4m: the CLI did not take the verdict's arm")
        # a failed measurement: the static rule (the kernel), not cached
        real = fp._measure_pair

        def boom(spec, cfg, device):
            raise RuntimeError("a measurement that fails")
        fp._measure_pair = boom
        try:
            cfg = policy_cfg("nsgan", 2 * TRAIN_B)
            got = cuda_train.resolve_fused_step(get_variant("nsgan"), cfg,
                                                "cuda")
        finally:
            fp._measure_pair = real
        key = f"{fp.host_tag('cuda')}::{fp.policy_key(cfg)}"
        ok = got is True and key not in fp._load_cache()
        print(f"  a failed measurement (nsgan B {2 * TRAIN_B}): the kernel "
              f"({got}), no cache entry {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("4m: a failed measurement was cached or "
                                 "left the kernel")
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return paths, lines


# Phase 4n: --profile and the directory checkpoint backend through the
# CLI. PROFILE_STEPS steps on the chunk kernel, PROFILE_GENERAL_STEPS on
# the general step (its MLP kernels); the trace files are read, sized and
# removed. The directory run: CKPT_DIR_STEPS steps saved, as many again
# resumed, against 2 * CKPT_DIR_STEPS uninterrupted, every leaf bit for
# bit; chunks of CKPT_DIR_STEPS on both, so only the checkpoint differs.
PROFILE_STEPS, PROFILE_GENERAL_STEPS = 100, 20
PROFILE_KERNELS = {"gan_chunk": ("gan_chunk_kernel",),
                   "mlp_fwd": ("mlp_fwd_kernel",),
                   "mlp_bwd": ("mlp_bwd_rows", "mlp_bwd_dw")}
CKPT_DIR_STEPS = 100


def run_cli(argv):
    """``cli.main(argv)``'s return code and printed lines."""
    from generative_models_tpu_torch import cli
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    return rc, buf.getvalue().strip().splitlines()


def drive_profile(mods, torch, card):
    """Phase 4n, ``--profile``: the chunk kernel's run and a general-step
    run each write a Chrome trace that json reads; the chunk kernel's
    events and the MLP kernels' are in them (present, not counted:
    torch.profiler loses events). Returns ({path: counts}, line)."""
    paths, line = {}, {}
    found = {}
    for tag, steps, flags in (("fused", PROFILE_STEPS, ()),
                              ("general", PROFILE_GENERAL_STEPS,
                               ("--no-fused-step",))):
        run_dir = os.path.join(OUT_DIR, f"profile_{tag}")
        reset(*mods)
        t0 = time.perf_counter()
        rc, out = run_cli(["--variant", "nsgan", "--dataset", "synthetic",
                             "--steps", str(steps), "--echo-every", "0",
                             "--out-dir", run_dir, "--profile", *flags])
        wall = time.perf_counter() - t0
        torch.cuda.synchronize()
        paths[f"cli_nsgan_profile_{tag}"] = launch_counts(mods)
        trace = next(l[len("trace: "):] for l in out
                     if l.startswith("trace: "))
        size = os.path.getsize(trace)
        with open(trace) as f:
            events = json.load(f)["traceEvents"]
        names = {e.get("name", "") for e in events
                 if e.get("cat") == "kernel"}
        for kernel, marks in PROFILE_KERNELS.items():
            if any(m in n for n in names for m in marks):
                found.setdefault(kernel, tag)
        os.remove(trace)
        sps = json.loads(out[-1])["steps_per_sec"]
        line[tag] = {"steps": steps, "trace_bytes": size,
                     "events": len(events), "kernel_names": len(names),
                     "steps_per_sec": sps, "wall_s": wall}
        print(f"  --profile nsgan {tag} ({steps} steps): rc={rc}, trace "
              f"{size} bytes, {len(events)} events, {len(names)} kernel "
              f"names; {sps} steps/s under the profiler  [{card}]")
        if rc != 0:
            raise AssertionError(f"4n: --profile {tag} failed")
    ok = sorted(found) == sorted(PROFILE_KERNELS)
    print(f"  --profile: kernels seen in the traces {found} "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("4n: a kernel is missing from the traces")
    return paths, line


def drive_ckpt_dir(mods, torch, card):
    """Phase 4n, ``--ckpt-backend orbax``: save a directory, resume from
    it, and end at the uninterrupted run's state bit for bit. Returns
    ({path: counts}, line)."""
    from generative_models_tpu_torch.config import variant_config
    from generative_models_tpu_torch.train.trainer import Trainer
    from generative_models_tpu_torch.utils import checkpoint as ckpt
    run_dir = os.path.join(OUT_DIR, "ckpt_dir")
    split, whole = (os.path.join(run_dir, n) for n in ("split", "whole"))
    base = ["--variant", "nsgan", "--dataset", "synthetic", "--echo-every",
            "0", "--out-dir", run_dir, "--ckpt-backend", "orbax",
            "--scan-steps", str(CKPT_DIR_STEPS)]
    reset(*mods)
    rc1, _ = run_cli(base + ["--steps", str(CKPT_DIR_STEPS), "--ckpt",
                               split])
    rc2, out = run_cli(base + ["--steps", str(CKPT_DIR_STEPS), "--ckpt",
                                 split, "--resume"])
    counts = launch_counts(mods)
    rc3, _ = run_cli(base + ["--steps", str(2 * CKPT_DIR_STEPS), "--ckpt",
                               whole])
    resumed = f"resumed from {split} at step {CKPT_DIR_STEPS}" in out
    cfg = variant_config("nsgan", ckpt_backend="orbax", dtype="float32")
    tmpl = Trainer(config=cfg, device="cuda").state
    a = dict(ckpt.state_leaves(ckpt.restore(split, tmpl, cfg)))
    b = dict(ckpt.state_leaves(ckpt.restore(whole, tmpl, cfg)))
    same = set(a) == set(b) and all(
        np.array_equal(np.asarray(a[k]), np.asarray(b[k])) for k in a)
    size = sum(os.path.getsize(os.path.join(split, f))
               for f in os.listdir(split))
    ok = (rc1 == rc2 == rc3 == 0 and resumed and same
          and a["['step']"] == 2 * CKPT_DIR_STEPS
          and counts["gan_chunk"] == 2)
    print(f"  --ckpt-backend orbax: {CKPT_DIR_STEPS} steps saved to a "
          f"directory ({size} bytes), resumed ({resumed}) for "
          f"{CKPT_DIR_STEPS} more; {len(a)} leaves equal to the "
          f"{2 * CKPT_DIR_STEPS}-step run's bit for bit: {same}; chunk "
          f"launches {counts['gan_chunk']} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("4n: the directory checkpoint did not resume "
                             "bit for bit")
    for d in (split, whole):
        shutil.rmtree(d)
    return {"cli_nsgan_ckpt_dir": counts}, {"dir_bytes": size,
                                            "leaves": len(a)}


def drive_profile_ckpt(mods, torch, card):
    """Phase 4n: ``--profile`` and the directory checkpoint backend."""
    print("[4n] --profile and --ckpt-backend orbax through the CLI")
    paths, prof = drive_profile(mods, torch, card)
    more, ck = drive_ckpt_dir(mods, torch, card)
    paths.update(more)
    return paths, {"profile": prof, "ckpt_dir": ck}


# Phase 5j: the conv stacks' bf16 crossover. The conv nsgan and vae
# general steps at each of CROSSOVER_BATCHES, float32 and bf16 operands,
# CROSSOVER_WARM steps each, then A B B A A B B A runs (host clock to a
# synchronize); an arm's steps/s is the median of its four runs'. Here
# each run is CROSSOVER_STEPS steps, a smoke of the table; config.py's
# constant comes from the same table with windows of several seconds
# (tools/policy_smoke.py --crossover-window), where a run is as many
# steps as fill the window at the arm's rate over an untimed first run.
# The crossover is the least batch from which bf16 runs at least
# CROSSOVER_MARGIN times float32's steps/s for both variants at it and
# every larger batch (None: at no batch), config.py's
# CONV_BF16_CROSSOVER_BATCH.
CROSSOVER_BATCHES = (100, 256, 512, 1024, 2048)
CROSSOVER_WARM, CROSSOVER_STEPS = 5, 10
CROSSOVER_ORDER = ("float32", "bfloat16", "bfloat16", "float32") * 2
CROSSOVER_MARGIN = 1.01


def crossover_of(table):
    """The crossover batch of 5j's {variant: {b: ratio}} table."""
    best = None
    for b in sorted(CROSSOVER_BATCHES, reverse=True):
        if all(r[b] >= CROSSOVER_MARGIN for r in table.values()):
            best = b
        else:
            break
    return best


def time_conv_crossover(torch, card, window_s=0.0):
    """Phase 5j: steps/s of the conv general steps in float32 and bf16 at
    CROSSOVER_BATCHES, runs of CROSSOVER_STEPS steps or, with `window_s`
    > 0, of that many seconds; prints the table and the crossover it gives
    beside config.py's. Returns the rows."""
    from generative_models_tpu_torch import config
    from generative_models_tpu_torch.train.trainer import Trainer
    print(f"[5j] the conv stacks' bf16 crossover (general steps, A B B A "
          f"twice, median; runs of "
          f"{f'{window_s:g} s' if window_s else f'{CROSSOVER_STEPS} steps'})")
    data = synthetic_split(4 * max(CROSSOVER_BATCHES), seed=7)
    rows, ratios = [], {}
    for variant in ("nsgan", "vae"):
        for b in CROSSOVER_BATCHES:
            ts = {dt: Trainer(variant, arch="conv", fused_step=False,
                              batch_size=b, dtype=dt, data=data,
                              sample_every=10 ** 9,
                              out_dir=os.path.join(OUT_DIR, "crossover"))
                  for dt in ("float32", "bfloat16")}
            for t in ts.values():
                t.train(steps=CROSSOVER_WARM)
            n = dict.fromkeys(ts, CROSSOVER_STEPS)
            if window_s:
                for dt, t in ts.items():
                    t.train(steps=CROSSOVER_STEPS)
                    n[dt] = max(CROSSOVER_STEPS, math.ceil(
                        window_s * CROSSOVER_STEPS / t.wall_time))
            runs = {dt: [] for dt in ts}
            for dt in CROSSOVER_ORDER:
                ts[dt].train(steps=n[dt])
                runs[dt].append(n[dt] / ts[dt].wall_time)
            sps = {dt: float(np.median(r)) for dt, r in runs.items()}
            ratio = sps["bfloat16"] / sps["float32"]
            ratios.setdefault(variant, {})[b] = ratio
            rows.append({"variant": variant, "b": b, "run_steps": n,
                         "float32_steps_per_s": sps["float32"],
                         "bf16_steps_per_s": sps["bfloat16"],
                         "ratio": ratio, "runs": runs})
            print(f"  conv {variant} B={b:5d}: float32 {sps['float32']:9.3f} "
                  f"steps/s, bf16 {sps['bfloat16']:9.3f} steps/s, bf16/f32 "
                  f"{ratio:.4f} (runs of {n['float32']} / {n['bfloat16']} "
                  f"steps; float32 runs "
                  f"{[round(x, 3) for x in runs['float32']]}, bf16 "
                  f"{[round(x, 3) for x in runs['bfloat16']]})  [{card}]")
            del ts
            torch.cuda.empty_cache()
    found = crossover_of(ratios)
    print(f"  the crossover this table gives: {found}; config.py's "
          f"CONV_BF16_CROSSOVER_BATCH: {config.CONV_BF16_CROSSOVER_BATCH} "
          f"({'agree' if found == config.CONV_BF16_CROSSOVER_BATCH else 'differ'})")
    return {"rows": rows, "crossover": found, "window_s": window_s,
            "config": config.CONV_BF16_CROSSOVER_BATCH}


def torch_sms():
    import torch
    return torch.cuda.get_device_properties(0).multi_processor_count


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(HERE, "generative_models_tpu_torch")):
        print("chip_smoke: the generative_models_tpu_torch package is not "
              "beside this script", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from generative_models_tpu_torch.ops import build as build_mod
    from generative_models_tpu_torch.ops import (
        cuda_dp, cuda_mlp, cuda_reparam, cuda_train, cuda_train_vae as ctv)
    from generative_models_tpu_torch.ops.cuda_linear import linear_cuda
    from generative_models_tpu_torch.train import step as step_lib

    os.makedirs(OUT_DIR, exist_ok=True)
    # fused_step "auto" takes the chunk kernel wherever it covers a config
    # (the static rule) in every phase but 4m, whose measured verdicts
    # would otherwise change the launch counts worked out beforehand; no
    # earlier run's verdict is read
    os.environ["GMTPU_FUSED_AB"] = "0"
    os.environ["GMTPU_POLICY_CACHE"] = os.path.join(OUT_DIR,
                                                    "fused_auto.json")
    t_start = time.perf_counter()
    t_mark = [t_start]

    def mark(phase):
        """Print a phase's seconds and the run's so far."""
        now = time.perf_counter()
        print(f"  (phase {phase}: {now - t_mark[0]:.1f} s; "
              f"{now - t_start:.1f} s so far)")
        t_mark[0] = now
    card = nvidia_smi_line()
    print(f"[1] card: {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.manual_seed(0)  # every unnamed draw below, on the card too
    print(f"    allow_tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}")

    # The MLP and sampling kernels first; then the 42 chunk and phase
    # libraries and 5e's instrumented phase libraries build in the
    # background while the paths that need only the first three run (3a,
    # 3b, 4i, 4j, 4k): the builds keep the host's cores busy, those paths
    # one core and the card. No rank starts and no timing phase runs
    # until every build has ended.
    from generative_models_tpu_torch.tools import phase_trace
    build_all([cuda_mlp.build, cuda_mlp.build_bwd, cuda_reparam.build],
              build_mod.BUILD_DIR)
    rest = ([functools.partial(ctv.build, bf16) for bf16 in (False, True)]
            + [functools.partial(cuda_train.build, hook, bf16)
               for hook in cuda_train.HOOK_IDS for bf16 in (False, True)]
            + [functools.partial(cuda_dp.build, hook, bf16)
               for hook in cuda_dp.DP_HOOKS for bf16 in (False, True)])
    traced = sorted({(cuda_train.HOOKS[v], bf16) for v in TRACE_VARIANTS
                     for bf16 in (False, True)})
    started = start_builds(rest + [functools.partial(phase_trace._probe_lib,
                                                     *k) for k in traced],
                           BUILD_NICE)
    mark("2 (mlp_fwd, mlp_bwd, reparam)")
    mods = (cuda_mlp, cuda_train, cuda_reparam, ctv)

    print(f"[3] kernels vs their plain versions on the card ({len(rest)} "
          f"libraries and {len(traced)} instrumented ones building)")
    fwd_err = check_fwd(cuda_mlp, linear_cuda, torch)
    bwd_err = check_bwd(cuda_mlp, torch)
    mark("3a-3b")
    paths = {}  # path name -> launch counts of that path's run
    conv_paths, conv_lines, conv_err = drive_conv(mods, torch)
    paths.update(conv_paths)
    mark("4i")
    diff_paths, diff_lines, diff_err = drive_diffusion(mods, torch)
    paths.update(diff_paths)
    mark("4j")
    vq_paths, vq_lines, vq_err = drive_vq(mods, torch)
    paths.update(vq_paths)
    mark("4k")
    par_paths, par_lines = drive_parallel(mods, torch, card)
    paths.update(par_paths)
    mark("4l")
    build_all(rest, build_mod.BUILD_DIR, started)
    granted = chunk_libraries(cuda_train, cuda_dp, ctv, build_mod.BUILD_DIR)
    mark("2 (the rest, waited for)")
    chunk_err = check_chunk(cuda_train, torch)
    cross_check(cuda_train, step_lib, torch)
    reparam_err, reparam_bwd_err = check_reparam(cuda_reparam, torch)
    vae_err = check_vae_chunk(ctv, torch)
    cross_check_vae(cuda_train, ctv, step_lib, torch)
    phase_err = check_phases(cuda_dp, cuda_train, torch)
    print("[3i] the EMA and bf16 kernels vs their plain versions")
    ema_err = check_chunk(cuda_train, torch, ema_cases(cuda_train), EMA_DECAY)
    vae_ema_err = check_vae_chunk(ctv, torch, (("vae", "bce"),
                                               ("birvae", "mse")), EMA_DECAY)
    bf16_err = max(check_chunk_bf16(cuda_train, torch),
                   check_chunk_bf16(cuda_train, torch, EMA_DECAY))
    vae_bf16_err = check_vae_bf16(ctv, torch)
    phase_bf16_err = check_phases_bf16(cuda_dp, cuda_train, torch)
    print("[3j] the product engine at ragged widths; [3k] bitwise repeats")
    ragged_err = check_chunk_ragged(cuda_train, ctv, torch)
    check_chunk_repeat(cuda_train, ctv, torch)
    mark("3")

    print("[4] main paths (launch counts set to 0 before each, read after)")
    serve_fwd, serve_err = drive_serving(cuda_mlp, cuda_train, torch)
    paths["serving_nsgan"] = {"mlp_fwd": serve_fwd}
    mark("4a")
    cli_lines, general_sps = {}, {}
    for variant in CLI_VARIANTS:
        paths[f"cli_{variant}"], cli_lines[variant] = drive_training_cli(
            variant, mods, torch)
    for variant in CLI_EMA_BF16:  # the EMA plane and bf16 operands
        paths[f"cli_{variant}_ema_bf16"], cli_lines[f"{variant}_ema_bf16"] = \
            drive_training_cli(variant, mods, torch, EMA_BF16_FLAGS)
    mark("4b")
    for variant, steps in GENERAL_STEPS:
        paths[f"general_{variant}"], general_sps[variant] = \
            drive_training_general(variant, steps, mods, torch)
    paths["cli_nsgan_spectral"] = drive_spectral_cli(mods, torch)
    mark("4c")
    score_lines = {}
    for variant in SCORE_VARIANTS:
        paths[f"score_{variant}"], score_lines[variant] = drive_score_export(
            variant, mods, torch)
    vae_serve_fwd, vae_serve_err = drive_vae_serving(mods, torch)
    paths["serving_vae"] = {"mlp_fwd": vae_serve_fwd}
    paths["serving_wgan"] = {"mlp_fwd": drive_wgan_sample_only(mods)}
    cgan_fwd, cgan_err = drive_cgan_sample_only(mods, torch)
    paths["serving_cgan"] = {"mlp_fwd": cgan_fwd}
    bi_fwd, info_err = drive_began_infogan_sample_only(mods, torch)
    for variant, n in bi_fwd.items():
        paths[f"serving_{variant}"] = {"mlp_fwd": n}
    for variant in CLI_GAN:  # every GAN variant went through it
        if paths[f"cli_{variant}"]["gan_chunk"] != 2:
            raise AssertionError(f"cli_{variant} did not launch gan_chunk "
                                 f"twice")
    dp_paths, dp_sps = drive_dp_world1(cuda_dp, cuda_train, mods, torch, card)
    paths.update(dp_paths)
    dp_paths, shared_sps = drive_dp_shared_card(card)
    mark("4d-4h: scoring, serving, DP")
    paths.update(dp_paths)
    dp_sps.update(shared_sps)
    policy_paths, policy_lines = drive_policy(mods, torch, card)
    paths.update(policy_paths)
    mark("4m")
    pc_paths, pc_lines = drive_profile_ckpt(mods, torch, card)
    paths.update(pc_paths)
    mark("4n")

    def by_path(kernel):
        return {name: c[kernel] for name, c in paths.items()
                if c.get(kernel, 0)}

    for kernel in ("mlp_fwd", "mlp_bwd", "linear_cuda", "gan_chunk",
                   "reparam", "reparam_bwd", "clf_mlp_fwd", "clf_mlp_bwd", "vae_chunk",
                   "birvae_chunk", "d_phase", "g_phase", "gan_chunk_ema",
                   "gan_chunk_bf16", "vae_family_ema", "vae_family_bf16",
                   "d_phase_bf16", "g_phase_bf16"):
        if not by_path(kernel):
            raise AssertionError(f"no main path launched {kernel}")

    print("[5] times (CUDA events, warm L2)")
    rows = time_kernels(cuda_mlp, linear_cuda, cuda_train, torch, card)
    mark("5a")
    train_rows = time_training(cuda_train, torch, card, general_sps)
    train_row = train_rows["nsgan"]
    reparam_rows, reparam_bwd_rows = time_reparam(cuda_reparam, torch, card)
    vae_rows = time_vae_training(ctv, torch, card, general_sps)
    phase_rows = time_phases(cuda_dp, cuda_train, torch, card)
    phase_main = {m: next(r for r in phase_rows if r["kernel"] ==
                          f"gan_phase_{m}" and r["variant"] == "nsgan"
                          and r["b"] == TRAIN_B) for m in "dg"}
    phase_trace_rows, phase_bf16_trace = trace_phases(card)
    check_phase_device(phase_rows, phase_trace_rows, card)
    mark("5b-5e")
    print("[5f] the EMA and bf16 kernels' times")
    # (the hooks 5e traces; every hook's EMA and bf16 times until 4l came:
    # PERF.md §5)
    traced = [c for c in TIMED_CASES if c[0] in TRACE_VARIANTS]
    ema_rows = time_training(cuda_train, torch, card, {}, ema_decay=EMA_DECAY,
                             cases=traced)
    bf16_rows = time_training(cuda_train, torch, card, {}, dtype="bfloat16",
                              cases=traced)
    vae_ema_rows = time_vae_training(ctv, torch, card, general_sps,
                                     ema_decay=EMA_DECAY)
    vae_bf16_rows = time_vae_training(ctv, torch, card, general_sps,
                                      dtype="bfloat16")
    phase_bf16_rows = time_phases(cuda_dp, cuda_train, torch, card,
                                  dtype="bfloat16", variants=TRACE_VARIANTS)
    check_phase_device(phase_bf16_rows, phase_bf16_trace, card)
    phase_bf16_main = {m: next(r for r in phase_bf16_rows if r["kernel"] ==
                               f"gan_phase_{m}_bf16"
                               and r["variant"] == "nsgan") for m in "dg"}
    print("[5g] the conv general steps")
    conv_rows = time_conv_training(mods, torch, card)
    mark("5f-5g")
    # (after the builds: beside them the host's cores are the builds', and
    # a conv general step there ran 2.9-8.5 steps/s against 55-85 alone)
    crossover = time_conv_crossover(torch, card)
    mark("5j")
    diff_rows = time_diffusion(mods, torch, card)
    mark("5h")
    vq_rows = time_vq(mods, torch, card)
    mark("5i")

    fwd_main = next(r for r in rows["mlp_fwd"]  # the largest serving batch
                    if r["shape"] == "G B=8192")
    bwd_main = rows["mlp_bwd"][0]    # G at B = 100, the training batch
    rep_main = reparam_rows[0]       # [100, 20], the training batch
    rep_bwd_main = reparam_bwd_rows[0]

    def entry(name, source, replaces, err, row, shape, counted=None, **more):
        launched = by_path(counted or name)
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": sum(launched.values()),
                "launches_by_path": launched, "max_abs_err": err,
                "ms": row["ms"], "plain_ms": row["plain_ms"],
                "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
                "library_ms": row["library_ms"], "shape": shape, **more}

    chunk_shape = f"1000 steps, B={TRAIN_B}, full width"
    print(json.dumps({"kernels": [
        entry("mlp_fwd", cuda_mlp.SOURCE,
              "generative_models_tpu/ops/pallas_mlp.py:82",
              max(fwd_err, serve_err, vae_serve_err, cgan_err, info_err),
              fwd_main,
              fwd_main["shape"], per_shape=rows["mlp_fwd"],
              linear_cuda=rows["linear"], quality_runs=score_lines,
              linear_cuda_launches=by_path("linear_cuda"),
              conv_checks=conv_err, conv_cli_runs=conv_lines,
              conv_training=conv_rows, diffusion_checks=diff_err,
              diffusion_runs=diff_lines, diffusion_times=diff_rows,
              vq_checks=vq_err, vq_runs=vq_lines, vq_times=vq_rows,
              parallel_runs=par_lines, conv_bf16_crossover=crossover,
              profile_and_ckpt_dir=pc_lines),
        entry("mlp_bwd", cuda_mlp.BWD_SOURCE,
              "generative_models_tpu/ops/pallas_mlp.py:239", bwd_err, bwd_main,
              bwd_main["shape"], max_abs_err_is="relative to max|ref|",
              per_shape=rows["mlp_bwd"]),
        entry("gan_chunk", cuda_train.SOURCE,
              "generative_models_tpu/ops/pallas_train.py:487", chunk_err,
              train_row, chunk_shape + ", nsgan (the other variants: "
              "per_variant)", per_variant=train_rows,
              fused_policy=policy_lines,
              cli_runs={v: cli_lines[v] for v in CLI_GAN}),
        entry("reparam", cuda_reparam.SOURCE,
              "generative_models_tpu/ops/pallas_reparam.py:41", reparam_err,
              rep_main, rep_main["shape"], per_shape=reparam_rows,
              device_ms=rep_main["device_ms"], host_us=rep_main["host_us"]),
        entry("reparam_bwd", cuda_reparam.SOURCE,
              "generative_models_tpu/ops/pallas_reparam.py:115",
              reparam_bwd_err, rep_bwd_main, rep_bwd_main["shape"],
              max_abs_err_is="relative to max|ref|",
              per_shape=reparam_bwd_rows, device_ms=rep_bwd_main["device_ms"],
              host_us=rep_bwd_main["host_us"]),
        entry("vae_chunk", ctv.SOURCE,
              "generative_models_tpu/ops/pallas_train.py:1442", vae_err["vae"],
              vae_rows["vae"], chunk_shape,
              max_abs_err_is="metrics, relative to max|ref|",
              training=vae_rows["vae"], cli_run=cli_lines["vae"]),
        entry("birvae_chunk", ctv.SOURCE,
              "generative_models_tpu/ops/pallas_train.py:1816",
              vae_err["birvae"], vae_rows["birvae"], chunk_shape,
              max_abs_err_is="metrics, relative to max|ref|",
              training=vae_rows["birvae"], cli_run=cli_lines["birvae"]),
    ] + [entry(f"gan_phase_{m}", cuda_dp.SOURCE + " (-DGM_PHASE=1)",
               "generative_models_tpu/ops/pallas_dp.py:"
               + ("107" if m == "d" else "195"), phase_err, phase_main[m],
               f"nsgan b={TRAIN_B} (world 1), full width", counted=f"{m}_phase",
               per_hook=[r for r in phase_rows
                         if r["kernel"] == f"gan_phase_{m}"],
               phase_trace=[r for r in phase_trace_rows if r["mode"] == m],
               dp_steps_per_s=dp_sps) for m in "dg"]
        + [
        entry("gan_chunk_ema", cuda_train.SOURCE,
              "generative_models_tpu/ops/pallas_train.py:755", ema_err,
              ema_rows["nsgan"], chunk_shape + f", nsgan, ema_decay "
              f"{EMA_DECAY} (the other hooks: per_variant)",
              per_variant=ema_rows,
              cli_run=cli_lines["nsgan_ema_bf16"]),
        entry("gan_chunk_bf16", cuda_train.SOURCE + " (-DGM_BF16=1)",
              "generative_models_tpu/ops/pallas_train.py:192", bf16_err,
              bf16_rows["nsgan"], chunk_shape + ", nsgan, bf16 operands "
              "(the other hooks: per_variant)", per_variant=bf16_rows,
              cli_run=cli_lines["nsgan_ema_bf16"]),
        entry("vae_chunk_ema", ctv.SOURCE,
              "generative_models_tpu/ops/pallas_train.py:1522",
              max(vae_ema_err.values()), vae_ema_rows["vae"],
              chunk_shape + f", ema_decay {EMA_DECAY} (birvae: per_variant)",
              counted="vae_family_ema", per_variant=vae_ema_rows,
              max_abs_err_is="metrics, relative to max|ref|",
              cli_run=cli_lines["vae_ema_bf16"]),
        entry("vae_chunk_bf16", ctv.SOURCE + " (-DGM_BF16=1)",
              "generative_models_tpu/ops/pallas_train.py:1497",
              max(vae_bf16_err.values()), vae_bf16_rows["vae"],
              chunk_shape + ", bf16 operands (birvae: per_variant)",
              counted="vae_family_bf16", per_variant=vae_bf16_rows,
              cli_run=cli_lines["vae_ema_bf16"]),
    ] + [entry(f"gan_phase_{m}_bf16",
               cuda_dp.SOURCE + " (-DGM_PHASE=1 -DGM_BF16=1)",
               "generative_models_tpu/ops/pallas_dp.py:"
               + ("128" if m == "d" else "214"), phase_bf16_err,
               phase_bf16_main[m], f"nsgan b={TRAIN_B} (world 1), full "
               "width, bf16 operands", counted=f"{m}_phase_bf16",
               per_hook=[r for r in phase_bf16_rows
                         if r["kernel"] == f"gan_phase_{m}_bf16"],
               phase_trace=[r for r in phase_bf16_trace if r["mode"] == m])
         for m in "dg"]}))
    print(f"chip_smoke: all phases passed in "
          f"{time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
