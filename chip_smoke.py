#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``bsi_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's kernels from the sources in this checkout, holds each one
against its plain PyTorch version at the main paths' shapes, checks the
full-width CIFAR-10 VDM-UNet and DiT-L/2 on the card against the same
weights on the CPU (the UNet's output and train-loss gradients, the DiT's
output, its decodes along a CPU sampling trajectory and its train-loss
gradients), then runs the four main paths -- UNet BSI sampling at k=128,
batch 64, bf16; the train step of the JAX package's UNet train bench
(``scripts/bench_train.py``) at batch 128, bf16; DiT-L/2 BSI sampling at
k=128, batch 64, bf16, as the JAX package's ``bench.py`` serves it; and the
DiT-L/2 train step of ``bench.py``'s ``dit-train`` row at batch 64, bf16,
dropout 0.05, bf16 Adam moments -- then the same UNet on 16x16 images (its
output, gradients and eval-step bpd card vs CPU first): sampling through
``make_sample_fn`` at k=128, batch 64, bf16; the train step at batch 128,
bf16, dropout 0.1; and the ELBO eval step (``make_eval_step``) on the EMA
parameters, f32, batch 64 -- and checks that each went through its kernels
and through no other. Last, the gelu UNet with ``downsampling_attention``
(an attention in every residual block) at 32x32 and 16x16: its launches of
K1 and K5f in one forward, its f32 output card vs CPU and the bf16 b64
forward's time. The bf16 dropout forwards (K2, K6f, K5f) also run a probe
whose output reads their keep masks out, bit for bit (``[mask.probe]``),
and the library's backwards (the yardsticks of K3, K6b, K5b, K4b and K7b)
are timed last, from a profile of their kernels (``[library.bwd]``).
Before those, the port's trainer runs end to end through its entry point
(``python -m bsi_torch.train``'s ``main``) on the CIFAR-10 recipe at full
width, f32, on synthetic 32x32 images: a fit of 6 steps with its
validations, plots, checkpoints and test pass (``[trainer.fit]``), a run
resumed from its checkpoint held bit for bit to a straight one
(``[trainer.resume]``), gradient accumulation (``[trainer.accum]``) and a
run on the CPU, asked for (``[trainer.cpu]``); then the eval suite on the
fit's ``ckpt_best``: FID's InceptionV3 (random weights of pt_inception's
shapes) on the card in f32 against f64 on the CPU (``[inception.check]``),
its time for 512 images against its bound and one 2048-d Frechet distance's
host time (``[inception.time]``), ``compute_fid_stats`` (``[fid.stats]``),
and the scripts of ``python -m bsi_torch.scripts`` in this process --
``eval_fid`` (``[eval.fid]``), ``eval_elbo`` (``[eval.elbo]``),
``generate_samples``, ``generate_sample_history``, ``sample_h_alpha`` and
``render_samples`` (``[eval.samples]``), and ``eval_overrides``, the
trainer's validation FID (``[trainer.fid]``) -- each with the exact
launches of K1 and K7f; then the ImageNet recipes
through the same entry point at full width, f32, on shards in the official
format written from a seed: DiT-L/2 (``experiment=imagenet32``) at the
recipe's batch 512 as 8 micro-batches of 64, with BSI (a sanity
validation, 2 steps, a validation, the plots, checkpoints and the test
pass, ``[imagenet32.fit]``), VDM and BFN at batch 256 as 4x64
(``[imagenet32.vdm]``, ``[imagenet32.bfn]``), and DiT-L/4 (``experiment=imagenet64``) from the
lazy ``.npy`` row source, its batches held to the preloaded rows
(``[imagenet64.fit]``), each with the exact launches of K2, K3, K4f and K4b.
VDM and BFN on DiT-L/2 are also held card vs CPU (``[baselines.check]``),
and K2, K3, K4f and K4b to their twins at the recipes' f32 shapes
(``[k2.check]``, ``[k3.check]``, ``[k4.check]``). The parallel layouts
(``bsi_torch/parallel/``): K2, K3, K4f and K4b at the local shapes that
tensor and sequence parallelism over 2 and 4 ranks give them, each rank's
call against the slice of the full call (``[parallel.shards]``); the entry
point in a process of its own over NCCL at one rank with FSDP on the
imagenet32 recipe, bit for bit against the same run without a process
group, its profile showing NCCL's all-gather and reduce-scatter, its
checkpoint restored here without a group (``[parallel.launch]``); and two
ranks on the one card over gloo on a 2-block DiT-L/2, TP 2 with SP, and TP 2
with and without SP at dropout 0.05, each against one process
(``[parallel.gloo2]``). The pipeline (``bsi_torch/parallel/pipeline.py``):
the DiT's kernels at its microbatches' shapes (``[pipeline.shapes]``);
two stages of DiT-L/2 at full width and depth on the one card over gloo,
4 microbatches, against one process with dropout off and on, and with
remat against the same process without it, a dropout seed repeated bit for
bit (``[pipeline.gloo2]``); the entry point on the
imagenet32 recipe over two stages, against ``[parallel.launch]``'s run
without a group, its checkpoint restored in one process
(``[pipeline.launch]``). ``chip_smoke.py --child ...`` is how the script
starts those processes. After ``[dit.train]``, ``bench.py``'s
``dit-train`` rows with ``remat=True``: b64 (``[dit.remat]``) and the
optimizer batch 512 as 16x32 (``[dit.b512]``). The bench rows (``[sample]``,
``[train]``, ``[dit.sample]``, ``[dit.train]``, ``[dit.remat]``,
``[dit.b512]``, and ``[unet16.train]``) are timed by the port's bench
(``bsi_torch/bench.py::bench_sampling``,
``bsi_torch/scripts/bench_train.py::run``) on the models of
``profile_sampling.build_model``, cut to fewer steps; ``[bench]`` prints
their combined record as ``python -m bsi_torch.bench`` prints its last
line. Last, the kill-and-requeue soak (``python -m
bsi_torch.scripts.soak_test``, ``[soak]``) and ``bench_parallel`` under
``torchrun`` at ``--dp 1`` with and without FSDP (``[bench.parallel]``), each
in processes of their own. After K1's check, K8f, the f32 3x3
convolution (``bsi_torch/ops/conv3x3.py``): FFMA and no tensor-core
instruction in its SASS, held to f64 ``F.conv2d`` and bit for bit between
two launches at the UNet's three shapes and odd ones, timed at the UNet's
three beside its FFMA bound, cuDNN's default (FFT at TF32 off) and cuDNN's
autotuned best, the dispatch at ``encode``'s 21 channels, and the routes one
f32 UNet forward takes (``[ops.conv3x3]``); every f32 UNet path below gates
K8f's launches, 135 a forward, and every bf16 one none.
Prints one line per phase, a JSON line
with every kernel's numbers, the card's name and power limit, and last
``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero;
without a CUDA device it exits 1 before printing a result.
"""

from __future__ import annotations

import collections
import concurrent.futures
import functools
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

SEED = 0
# H100 SXM peaks (NVIDIA data sheet, dense): the bound of each kernel is the
# larger of its bytes over HBM bandwidth and its operations over the peak
# rate of their type.
HBM_BYTES_PER_S = 3.35e12
BF16_TENSOR_FLOPS = 989e12
F32_FLOPS = 67e12

# The full-width CIFAR-10 VDM-UNet (``profile_sampling.UNET``, built by
# ``profile_sampling.build_model``) and its bench rows (bsi_torch/bench.py):
# sampling at K_STEPS, batch BATCH; the train bench (bench_train.py) at batch
# TRAIN_BATCH, TRAIN_STEPS timed steps after a warm-up. The shapes the
# kernels are held at; main() checks them against the bench's.
DATA_SHAPE = (32, 32, 3)
BATCH = 64
K_STEPS = 128
TRAIN_BATCH = 128
TRAIN_STEPS = 10
# One UNet forward: 34 GroupNorm+SiLU at 128 channels (32 down, centre in
# and out) and 32 at 256 (the up blocks' concatenated input); one attention.
K7_PER_FORWARD = 66
K1_PER_FORWARD = 1
# K8f once a 3x3 convolution of an f32 forward: 2 in each of the 66 residual
# blocks, the attention's qkv and out, and encode (its 21 Fourier channels
# zero-padded to 32); none in bf16.
CONV3X3_PER_FORWARD = 2 * 66 + 2 + 1
# A train step: one forward and one backward; K7b once per K7f, and K1's
# backward at S=1024 is the plain VJP, as in the JAX package.
K7B_PER_STEP = 66
# K7b's f32 operations per element: x*x and two sums for the statistics;
# subtract and scale (xhat); the affine (2); the sigmoid (negate, exp, add,
# divide); silu' and the product with g (5); two sums and dz*xhat (3);
# dz*gamma; dx's subtract, multiply-subtract and scale (4).
K7B_OPS_PER_ELEM = 24

# DiT-L/2 at 32x32 as bench.py serves it (``profile_sampling.DIT_L2``, the
# imagenet32 recipe's model): 256 tokens, dim 1024, depth 24, 16 heads of
# 64, Fourier features 6..8. One forward: K2 once and K4f twice per block
# (before the attention and before the MLP).
K2_PER_FORWARD = 24
K4F_PER_FORWARD = 48
# K4f's f32 operations per element: the sum, x - mean, its square and sum,
# the product with rstd, with (scale + 1), and the shift.
K4F_OPS_PER_ELEM = 7
# K4b's: the statistics (sum, x - mean, square, sum), the product with rstd,
# g's sum (dshift), g * n and its sum (dscale), dn = g * (1 + scale), its sum,
# dn * n and its sum, and dx's subtract, multiply-subtract and scale.
K4B_OPS_PER_ELEM = 15
# The DiT train step (bench.py's dit-train row, without remat): batch 64,
# dropout 0.05 on the attention probabilities and before each MLP; 1 warm-up
# step, then TRAIN_STEPS timed ones. Per step: K2 and K3 once per block, K4f
# and K4b twice.
DIT_TRAIN_BATCH = 64
DIT_DROPOUT = 0.05
K3_PER_STEP = 24
K4B_PER_STEP = 48
# The same UNet on 16x16 images (the shape of Downsampled ImageNet 16x16,
# bsi_tpu/data/imagenet.py): its attention runs over S = 256 pixels, where
# the JAX package runs its whole-sequence kernels: K5f once a forward, K5b
# once a train step, and no K1. The ELBO eval step runs the f32 model twice
# (reconstruction and measurement), on EVAL_BATCH images.
DATA16 = (16, 16, 3)
K5F_PER_FORWARD = 1
K5B_PER_STEP = 1
EVAL_BATCH = 64
EVAL_STEPS = 5
K5_RATE = 0.1


# The trainer path: the port's entry point (python -m bsi_torch.train) on the
# CIFAR-10 recipe at its full width and precision (f32, TF32 off), fed
# synthetic 32x32x3 images since no dataset can be fetched. Cut: 6 steps
# (the recipe: 1e7), validation every 3 (1e5) over one eval batch of 512 a
# split (the synthetic val split's 128 images padded to 512, and 512 of its
# train images), the seed the recipe's sweep names.
TRAINER_RECIPE = ["experiment=cifar10-vdm", "data=synthetic", "data.data_shape=[32,32,3]",
                  "seed=1947925778702538666", "trainer.log_every_n_steps=1", "trainer.limit_eval_batches=1"]
TRAINER_STEPS = 6
TRAINER_VAL_EVERY = 3
TRAINER_BATCH = 128
TRAINER_EVAL_BATCH = 512
# The eval suite's f32 UNet batches beside TRAINER_BATCH (its eval batch):
# generate_sample_history's samples, and eval_elbo's flat forward of its 2
# reconstruction (or measurement) samples of one eval batch.
EVAL_BATCH = 128
EVAL_HISTORY_N = 16
EVAL_ELBO_SAMPLES = 2
EVAL_SUITE_BATCHES = (EVAL_HISTORY_N, EVAL_ELBO_SAMPLES * EVAL_BATCH)

# The ImageNet recipes through the same entry point: experiment=imagenet32
# (DiT-L/2, patch 2 on 32x32) for each task of its sweep, and
# experiment=imagenet64 (DiT-L/4, patch 4 on 64x64, preload: no), at full
# width, f32, TF32 off, the recipes' batch 512 as IMAGENET_ACCUM
# micro-batches of 64 (one card), on shards in the official format written
# from SEED: (train images, val images, train shards). Both give 256 tokens,
# so every DiT kernel runs at the same shapes. Cut: 2 steps (the recipes:
# 1e6), one validation after them over one eval batch a split (every 1e5);
# VDM and BFN at batch 256 (4x64) with eval batch 128, imagenet64 without
# plots.
IMAGENET_SHARDS = {32: (20_000, 1_024, 2), 64: (4_000, 512, 1)}
IMAGENET_ACCUM = 8
IMAGENET_MICRO = 64
IMAGENET_STEPS = 2
IMAGENET_EVAL_BATCH = 512
IMAGENET_K = 50  # configs/task/algorithm/*.yaml: the plots' sampling steps
PLOTS_K_CUT = 8  # the plots of [trainer.fit] and [imagenet32.fit], .vdm and .bfn


# The parallel layouts (bsi_torch/parallel/). The card's machine has one GPU,
# and NCCL refuses two ranks on one device, so: [parallel.launch] runs the
# entry point over NCCL at one rank (WORLD_SIZE=1, the torchrun variables of
# bsi_torch/utils/launcher.py) with FSDP, on the imagenet32 recipe at full
# width, f32, against the same run without a process group, bit for bit;
# [parallel.gloo2] runs two ranks on the one card over gloo on a 2-block
# DiT-L/2 under GLOO2_CASES' layouts, each against one process (with dropout
# on, through the kernels' seed cut and the SP mask cut); [parallel.shards]
# holds the DiT's kernels at the local shapes TP and SP give them against
# the full calls. Cut of [parallel.launch]: batch 64 (not 8x64), 2 steps, one
# validation over one eval batch of 64 a split, no plots, no test pass.
PARALLEL_TP = (2, 4)
PARALLEL_BATCH = 64
PARALLEL_STEPS = 2
GLOO2_BATCH = 8
GLOO2_DEPTH = 2
# [parallel.gloo2]'s layouts, each against one process: (name, SP, dropout)
GLOO2_CASES = (("tp_sp", True, None), ("tp_dropout", False, DIT_DROPOUT), ("tp_sp_dropout", True, DIT_DROPOUT))
# The pipeline (bsi_torch/parallel/pipeline.py) on the one card: two ranks over
# gloo, PIPE_STAGES stages of DiT-L/2's 24 blocks at full width and depth,
# PIPE_MICRO microbatches. [pipeline.gloo2]: PIPE_STEPS train steps of a
# global batch of PIPE_BATCH, f32, against the same steps in one process (the
# parent's), without dropout and at DIT_DROPOUT under two dropout seeds, and
# with remat at DIT_DROPOUT;
# [pipeline.launch]: the entry point on the imagenet32 recipe as
# [parallel.launch] runs it (batch PARALLEL_BATCH, PARALLEL_STEPS steps, one
# validation, no plots, a checkpoint), against [parallel.launch]'s run without
# a group, the checkpoint then restored in one process.
PIPE_STAGES = 2
PIPE_MICRO = 4
PIPE_BATCH = 16
PIPE_STEPS = 2
PIPE_SEEDS = (SEED + 21, SEED + 22)
PIPE_LR = 1e-4
DIT_TOKENS = 256  # DiT-L/2 on 32x32: 16x16 patches
# [pipeline.gloo2]'s cases: (name, dropout, dropout seed, remat); the first two
# are held to one process, the third must repeat the second bit for bit, the
# fourth differ from it; the fifth, with remat, is held to the second's one
# process (PIPE_REFS: the one-process run a case is held to; those runs
# have no remat)
PIPE_CASES = (("off", None, PIPE_SEEDS[0], False), ("dropout", DIT_DROPOUT, PIPE_SEEDS[0], False),
              ("dropout_again", DIT_DROPOUT, PIPE_SEEDS[0], False),
              ("dropout_seed2", DIT_DROPOUT, PIPE_SEEDS[1], False), ("remat", DIT_DROPOUT, PIPE_SEEDS[0], True))
PIPE_REFS = {"off": "off", "dropout": "dropout", "remat": "dropout"}
# [dit.remat] and [dit.b512]: bench.py's dit-train and dit-train-b512 rows
# (remat, the latter the imagenet32 recipe's optimizer batch 512 as 16
# micro-batches of 32), cut to REMAT_STEPS and B512_STEPS timed steps after
# a warm-up.
REMAT_STEPS = 3
B512_STEPS = 2
# [soak]: python -m bsi_torch.scripts.soak_test at the CIFAR-10 recipe's
# widths, cut: batch SOAK_BATCH (128), SOAK_STEPS steps (50,000) killed at
# SOAK_STEPS / 2, 4,096 synthetic train images (50,000). A run logs a rate
# window every 10 steps, and the soak compares the two runs' medians past
# the first two. The steps are host-paced at batches 32 to 128 (146 to 250
# ms), and a window's rate swings by ~10 % on the card's shared host: with
# five windows a run the medians parted by 14.9 % and 18.0 % of the 15 %
# allowed in two of six runs (PERF.md). Fifteen a run steady the medians.
SOAK_STEPS = 320
SOAK_BATCH = 64
SOAK_N_TRAIN = 4096
# [bench.parallel]: torchrun --nproc_per_node 1 -m bsi_torch.scripts.bench_parallel
# --dp 1, with and without --fsdp, cut to BENCH_PARALLEL_STEPS steps (40).
BENCH_PARALLEL_STEPS = 8
COUNTER_NAMES = ("flash_attention", "flash_attention_dropout", "flash_attention_bwd", "groupnorm_silu_fwd",
                 "groupnorm_silu_bwd", "flash_attention_fused", "flash_attention_packed", "layernorm_modulate_fwd",
                 "flash_attention_fused_bwd", "flash_attention_packed_bwd", "layernorm_modulate_bwd", "conv3x3")


def launch_counters() -> dict:
    """Every kernel wrapper by the name its JSON entry carries."""
    from bsi_torch.ops import conv3x3 as cv
    from bsi_torch.ops import flash_attention as fa
    from bsi_torch.ops import flash_attention_packed as fap
    from bsi_torch.ops import groupnorm_silu as gn
    from bsi_torch.ops import ln_modulate as lm

    wrappers = (fa.flash_attention_cuda, fa.flash_attention_dropout_cuda, fa.flash_attention_bwd_cuda,
                gn.groupnorm_silu_cuda, gn.groupnorm_silu_bwd_cuda, fap.flash_attention_fused_cuda,
                fap.flash_attention_packed_cuda, lm.layernorm_modulate_cuda, fap.flash_attention_fused_bwd_cuda,
                fap.flash_attention_packed_bwd_cuda, lm.layernorm_modulate_bwd_cuda, cv.conv3x3_cuda)
    return dict(zip(COUNTER_NAMES, wrappers))


def child_train(out_json: str, overrides: list[str]) -> int:
    """``--child train``: ``python -m bsi_torch.train``'s ``main`` in this
    process (f32 with TF32 off, cuDNN deterministic, as [trainer.resume]),
    joined to the process group its environment describes, if any; writes
    the kernels' launches, the peak memory and the group's backend."""
    import torch
    import torch.distributed as dist

    from bsi_torch.train.__main__ import main as train_main

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    rc = train_main(overrides)
    counts = {name: w.launches for name, w in launch_counters().items()}
    result = {"rc": rc, "launches": counts, "peak_bytes": torch.cuda.max_memory_allocated(),
              "backend": dist.get_backend() if dist.is_initialized() else None,
              "world": dist.get_world_size() if dist.is_initialized() else None}
    Path(out_json).write_text(json.dumps(result))
    if dist.is_initialized():
        dist.destroy_process_group()
    return rc


def child_gloo2(rank: int, store: str, out_json: str) -> int:
    """``--child gloo2``: one of two ranks on cuda:0 over gloo. It probes
    the four collectives on CUDA tensors, then runs GLOO2_BATCH x 2 steps of
    a 2-block DiT-L/2 (f32, TF32 off) under each of GLOO2_CASES' layouts
    and the same steps in one process (no collective), and writes each
    case's metrics, the largest distance of a leaf and the layout run's
    launches. With dropout on the data size is 1, so the attention's seeds
    (K2, K3) and the blocks' nn.Dropout masks are one process's."""
    import torch
    import torch.distributed as dist

    from bsi_torch import BSI
    from bsi_torch.models import DenoisingDiT
    from bsi_torch.nn import FourierFeatures
    from bsi_torch.parallel import StateLayout, make_mesh, token_stream_sharding
    from bsi_torch.profile_sampling import DIT_L2
    from bsi_torch.train import EMAConfig, TrainState, make_optimizer, make_train_step, module_apply

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=2)
    probe = {}
    for name, fn in (("all_reduce", lambda: dist.all_reduce(torch.ones(4, device=dev))),
                     ("all_gather_into_tensor", lambda: dist.all_gather_into_tensor(
                         torch.empty(8, device=dev), torch.ones(4, device=dev))),
                     ("reduce_scatter_tensor", lambda: dist.reduce_scatter_tensor(
                         torch.empty(4, device=dev), torch.ones(8, device=dev))),
                     ("broadcast", lambda: dist.broadcast(torch.ones(4, device=dev), 0))):
        fn()
        probe[name] = "ok"
    mesh = make_mesh(model_parallelism=2)
    lr = 1e-4

    def run(layout, sp, dropout):
        torch.manual_seed(SEED)
        model = DenoisingDiT(fourier_features=FourierFeatures(6, 8), device=dev, dropout=dropout,
                             **{**DIT_L2, "depth": GLOO2_DEPTH})
        with torch.no_grad():
            for name, p in model.named_parameters():
                if ".ada_out." in name:  # adaLN-Zero: at init every block is the identity
                    p.normal_(0.0, 0.02)
        full = dict(model.named_parameters())
        if layout:
            if sp:
                model.set_token_sharding(token_stream_sharding(mesh))
            else:
                model.set_layout(mesh)
            layout = StateLayout.build(mesh, full, tensor=True)
            params = {n: layout.local(n, p.detach()).requires_grad_() for n, p in full.items()}
        else:
            layout, params = None, full
        tx = make_optimizer(lr)
        state = TrainState.create(params=params, opt_state=tx.init(params),
                                  generator=torch.Generator(device=dev).manual_seed(SEED + 11))
        step = make_train_step(BSI(data_shape=DIT_L2["data_shape"], lambda_0=1e-2, alpha_M=1e6, alpha_R=2e6),
                               module_apply(model), tx, EMAConfig(), layout=layout)
        batch = torch.randint(0, 256, (GLOO2_BATCH,) + DIT_L2["data_shape"],
                              generator=torch.Generator(device=dev).manual_seed(SEED + 12), device=dev)
        batch = batch / 255.0 * 2.0 - 1.0
        counters = launch_counters()
        for w in counters.values():
            w.launches = 0
        metrics = []
        for _ in range(PARALLEL_STEPS):
            state, m = step(state, batch)
            metrics.append({k: float(v) for k, v in m.items()})
        torch.cuda.synchronize()
        after = {n: (layout.full(n, p.detach()) if layout else p.detach()).clone() for n, p in state.params.items()}
        return metrics, after, {name: w.launches for name, w in counters.items()}, \
            sum(p.numel() for p in state.params.values())

    bases = {dropout: run(False, False, dropout)[:2] for dropout in dict.fromkeys(c[2] for c in GLOO2_CASES)}
    cases = {}
    for case, sp, dropout in GLOO2_CASES:
        base, base_params = bases[dropout]
        tp, tp_params, launches, local_numel = run(True, sp, dropout)
        # each leaf's root-mean-square distance over the largest move Adam could
        # have made (lr a step); the key bias has no gradient (softmax ignores a
        # shift shared by every key): its k columns are rounding noise on both
        # sides, so it is left to Adam's bound alone
        worst, worst_name = 0.0, None
        for name, want in base_params.items():
            diff = (tp_params[name] - want).double()
            if name.endswith("attn.to_qkv.bias"):
                diff = diff.reshape(8, 3, 128)[:, [0, 2]]  # (group, q|k|v, 2 heads of 64)
            rms = float(diff.square().mean().sqrt()) / (lr * PARALLEL_STEPS)
            if rms > worst:
                worst, worst_name = rms, name
        cases[case] = {"base": base, "layout": tp, "launches": launches, "worst_rms_over_lr_sum": worst,
                       "worst_leaf": worst_name, "local_numel": local_numel,
                       "full_numel": sum(p.numel() for p in base_params.values())}
    Path(out_json).write_text(json.dumps({"probe": probe, "cases": cases}))
    dist.barrier()
    dist.destroy_process_group()
    return 0


def pipe_steps(dev, mesh, dropout, dropout_seed, remat=False):
    """PIPE_STEPS train steps of DiT-L/2 (full width and depth, ``ada_out``
    filled, f32, ``scan_blocks``, ``remat``) on a global batch of PIPE_BATCH: pipelined
    over ``mesh``'s stages in PIPE_MICRO microbatches, or in one process
    where ``mesh`` is None. Returns (metrics, the parameters this rank holds
    after, the launches of the steps, peak bytes, ms of each step)."""
    import torch

    from bsi_torch import BSI
    from bsi_torch.models import DenoisingDiT
    from bsi_torch.nn import FourierFeatures
    from bsi_torch.parallel import StateLayout, make_pipeline_apply
    from bsi_torch.profile_sampling import DIT_L2
    from bsi_torch.train import EMAConfig, TrainState, make_optimizer, make_train_step, module_apply

    torch.manual_seed(SEED)
    model = DenoisingDiT(fourier_features=FourierFeatures(6, 8), device=dev, dropout=dropout, scan_blocks=True,
                         remat=remat, **DIT_L2)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if ".ada_out." in name:  # adaLN-Zero: at init every block is the identity
                p.normal_(0.0, 0.02)
    full = dict(model.named_parameters())
    if mesh is None:
        layout, apply, params = None, module_apply(model), full
    else:
        model.set_layout(mesh)
        layout = StateLayout.build(mesh, full, tensor=True)
        apply = make_pipeline_apply(model, mesh, PIPE_MICRO)
        params = {n: layout.local(n, p.detach()).requires_grad_() for n, p in full.items() if layout.holds(n)}
        del full
        model.keep_blocks(apply.pipeline.lo, apply.pipeline.hi)
    tx = make_optimizer(PIPE_LR)
    state = TrainState.create(params=params, opt_state=tx.init(params),
                              generator=torch.Generator(device=dev).manual_seed(SEED + 11), dropout_seed=dropout_seed)
    step = make_train_step(BSI(data_shape=DIT_L2["data_shape"], lambda_0=1e-2, alpha_M=1e6, alpha_R=2e6),
                           apply, tx, EMAConfig(), layout=layout)
    batch = torch.randint(0, 256, (PIPE_BATCH,) + DIT_L2["data_shape"],
                          generator=torch.Generator(device=dev).manual_seed(SEED + 12), device=dev) / 255.0 * 2.0 - 1.0
    if layout is not None:
        rows = PIPE_BATCH // mesh.data_size
        batch = batch[mesh.data_rank * rows:(mesh.data_rank + 1) * rows]
    counters = launch_counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for w in counters.values():
        w.launches = 0
    metrics, ms = [], []
    for _ in range(PIPE_STEPS):
        t0 = time.perf_counter()
        state, m = step(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
        ms.append((time.perf_counter() - t0) * 1e3)
    launches = {name: w.launches for name, w in counters.items()}
    return (metrics, {n: p.detach() for n, p in state.params.items()}, launches, torch.cuda.max_memory_allocated(),
            ms)


def worst_leaf(got: dict, want: dict, lr_steps: float) -> tuple[float, str]:
    """The largest root-mean-square distance of a leaf of ``got`` to
    ``want``'s over the largest move Adam could have made (``lr_steps``, lr
    summed over the steps), and its name. The key bias has no gradient
    (softmax ignores a shift shared by every key): its k columns are
    rounding noise on both sides, left to Adam's bound alone."""
    worst, name_of = 0.0, None
    for name, g in got.items():
        diff = (g - want[name].to(g.device)).double()
        if name.endswith("attn.to_qkv.bias"):
            diff = diff.reshape(8, 3, 128)[:, [0, 2]]  # (group, q|k|v, 2 heads of 64)
        rms = float(diff.square().mean().sqrt()) / lr_steps
        if rms > worst:
            worst, name_of = rms, name
    return worst, name_of


def child_pipe2(rank: int, store: str, ref_dir: str, out_json: str) -> int:
    """``--child pipe2``: one of two pipeline stages on cuda:0 over gloo. It
    checks the point-to-point transfers on CUDA tensors (through host
    memory), then runs pipe_steps under PIPE_CASES and writes each case's
    metrics, launches, peak memory and step times, and the worst leaf
    against the parent's one-process run (``ref_dir/<case>.pt``)."""
    import torch
    import torch.distributed as dist

    from bsi_torch.parallel import collectives as C
    from bsi_torch.parallel import make_mesh

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=2)
    mine = torch.arange(6, dtype=torch.float32, device=dev).reshape(2, 3) + rank
    if rank == 0:
        C.send_to(mine, 1, None)
        got = C.recv_from((2, 3), torch.float32, dev, 1, None)
    else:
        got = C.recv_from((2, 3), torch.float32, dev, 0, None)
        C.send_to(mine, 0, None)
    bf = torch.full((3,), float(rank), dtype=torch.bfloat16, device=dev)
    C.broadcast_from(bf, 1, None)
    probe = {"send_recv": bool(torch.equal(got, mine - rank + (1 - rank))) and got.device == dev,
             "broadcast_bf16": bool((bf == 1).all())}
    # what a transfer costs: a microbatch's tokens (f32 [PIPE_BATCH / PIPE_MICRO,
    # 256, 1024]) from stage 0 to stage 1, and the output's broadcast, each
    # through host memory; the median of 10, the card synchronised around each
    tokens = (DIT_TOKENS, 1024)
    x = torch.ones((PIPE_BATCH // PIPE_MICRO,) + tokens, device=dev)
    out = torch.ones((PIPE_BATCH,) + tokens, device=dev)
    times = {"send_recv_ms": [], "broadcast_ms": []}
    for _ in range(10):
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if rank == 0:
            C.send_to(x, 1, None)
        else:
            C.recv_from(x.shape, x.dtype, dev, 0, None)
        torch.cuda.synchronize()
        times["send_recv_ms"].append((time.perf_counter() - t0) * 1e3)
        dist.barrier()
        t0 = time.perf_counter()
        C.broadcast_from(out, 1, None)
        torch.cuda.synchronize()
        times["broadcast_ms"].append((time.perf_counter() - t0) * 1e3)
    probe.update({key: statistics.median(v) for key, v in times.items()},
                 transfer_mib=x.numel() * 4 / 2**20, broadcast_mib=out.numel() * 4 / 2**20)
    del x, out
    mesh = make_mesh(pipeline_parallelism=PIPE_STAGES)
    cases, kept = {}, None
    for case, dropout, seed, remat in PIPE_CASES:
        metrics, params, launches, peak, ms = pipe_steps(dev, mesh, dropout, seed, remat)
        entry = {"metrics": metrics, "launches": launches, "peak_bytes": peak, "ms": ms,
                 "finite": all(math.isfinite(v) for m in metrics for v in m.values()), "held": len(params),
                 "stage": mesh.pipe_rank}
        if case in PIPE_REFS:
            want = torch.load(Path(ref_dir) / f"{PIPE_REFS[case]}.pt", mmap=True, weights_only=True)
            entry["worst_rms_over_lr_sum"], entry["worst_leaf"] = worst_leaf(params, want, PIPE_LR * PIPE_STEPS)
            del want
        if case == "dropout":
            kept = {n: p.clone() for n, p in params.items()}
        elif case == "dropout_again":
            entry["params_equal_to_dropout"] = all(torch.equal(params[n], kept[n]) for n in kept)
            kept = None
        cases[case] = entry
        del params
        torch.cuda.empty_cache()
    Path(out_json).write_text(json.dumps({"probe": probe, "cases": cases}))
    dist.barrier()
    dist.destroy_process_group()
    return 0


def child_pipe_train(rank: int, store: str, out_json: str, overrides: list[str]) -> int:
    """``--child pipe_train``: one of two ranks on cuda:0 joined to gloo,
    then ``python -m bsi_torch.train``'s ``main`` (which keeps the group) as
    ``--child train`` runs it."""
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=2)
    return child_train(out_json, overrides)


def parallel_shards(entries: dict, randn, dev, gen, flush) -> None:
    """``[parallel.shards]``: DiT-L/2's kernels at the local shapes of tensor
    and sequence parallelism over tp ranks. A rank's K2 and K3 run on its
    columns of the grouped qkv buffer, [B, S, 3*1024/tp] with 16/tp heads
    and those heads' seeds; its K4f and K4b on its S/tp tokens, the model
    group summing K4b's dshift and dscale. Each rank's call runs here, in
    turn, against the slice of the full call: K2 the full output's heads,
    bit for bit (with dropout at 0.05, so the keep masks too: one flipped
    bit moves an output); K3 the full dqkv's columns (1e-5 of the largest
    element in f32, 2e-2 in bf16, as ``[k3.check]``); K4f and K4b's dx the
    full call's rows, bit for bit (a row is one warp's in either plan); the
    sum over ranks of dshift and dscale, in the call's dtype as the
    all-reduce sums them, within 1e-5 of the full call's largest element in
    f32 (the cluster of an image's CTAs sums its rows in another order than
    the full call) and 2^-7, one bf16 ulp at 1, in bf16 (each rank's partial
    is rounded, then their sum). The sum without the last rank's partial,
    what a reduction that lost a rank gives, must read above the gate. One
    rank's calls are timed beside the full ones and written into
    ``entries[...]["tp_local"]`` with their bounds."""
    import torch

    from bsi_torch.ops import flash_attention_packed as fap
    from bsi_torch.ops import ln_modulate as lm
    from bsi_torch.profile_sampling import DIT_L2

    dim, heads = DIT_L2["dim"], DIT_L2["heads"]
    b, seq, d = BATCH, (DATA_SHAPE[0] // DIT_L2["patch_size"]) ** 2, dim // heads
    rate = DIT_DROPOUT
    for dtype in (torch.bfloat16, torch.float32):
        peak = BF16_TENSOR_FLOPS if dtype == torch.bfloat16 else F32_FLOPS
        es = torch.finfo(dtype).bits // 8
        qkv = randn(b, seq, 3 * heads * d, dtype=dtype)
        g = randn(b, seq, heads * d, dtype=dtype)
        seeds = fap.draw_seeds(b, heads, dev, gen)
        out, lse = fap.flash_attention_fused_cuda(qkv, heads, seeds, rate, with_lse=True)
        dqkv = fap.flash_attention_fused_bwd_cuda(qkv, g, heads, seeds, rate, out=out, lse=lse)
        x = randn(b, seq, dim, dtype=dtype) * 2.0 + 0.5
        gx = randn(b, seq, dim, dtype=dtype)
        mod = randn(b, 6 * dim, dtype=dtype)
        shift, scale = mod[:, :dim], mod[:, dim:2 * dim]
        y = lm.layernorm_modulate_cuda(x, shift, scale)
        dx, dshift, dscale = lm.layernorm_modulate_bwd_cuda(x, scale, gx)
        k3_tol = (2e-2 if dtype == torch.bfloat16 else 1e-5) * dqkv.abs().max().item()
        cond_tol = 2**-7 if dtype == torch.bfloat16 else 1e-5
        full_ms = {
            "k2": time_ms(lambda: fap.flash_attention_fused_cuda(qkv, heads, seeds, rate), flush=flush),
            "k3": time_ms(lambda: fap.flash_attention_fused_bwd_cuda(qkv, g, heads, seeds, rate, out=out, lse=lse),
                          flush=flush),
            "k4f": time_ms(lambda: lm.layernorm_modulate_cuda(x, shift, scale), flush=flush),
            "k4b": time_ms(lambda: lm.layernorm_modulate_bwd_cuda(x, scale, gx), flush=flush)}
        for tp in PARALLEL_TP:
            h, rows = heads // tp, seq // tp
            cols = lambda r, width: slice(r * width // tp, (r + 1) * width // tp)
            parts = []
            for r in range(tp):
                qkv_r = qkv[..., cols(r, 3 * heads * d)].contiguous()
                seeds_r = seeds[:, cols(r, heads)].contiguous()
                out_r, lse_r = fap.flash_attention_fused_cuda(qkv_r, h, seeds_r, rate, with_lse=True)
                dqkv_r = fap.flash_attention_fused_bwd_cuda(qkv_r, g[..., cols(r, heads * d)].contiguous(), h,
                                                            seeds_r, rate, out=out_r, lse=lse_r)
                x_r = x[:, cols(r, seq)].contiguous()
                y_r = lm.layernorm_modulate_cuda(x_r, shift, scale)
                gx_r = gx[:, cols(r, seq)].contiguous()
                dx_r, dshift_r, dscale_r = lm.layernorm_modulate_bwd_cuda(x_r, scale, gx_r)
                parts.append(dict(
                    k2=torch.equal(out_r, out[..., cols(r, heads * d)]),
                    k3=(dqkv_r.float() - dqkv[..., cols(r, 3 * heads * d)].float()).abs().max().item(),
                    k4f=torch.equal(y_r, y[:, cols(r, seq)]), k4b_dx=torch.equal(dx_r, dx[:, cols(r, seq)]),
                    dshift=dshift_r, dscale=dscale_r))
            def rel(key, full, ranks):
                total = ranks[0][key]
                for part in ranks[1:]:  # in rank order, as the all-reduce adds
                    total = total + part[key]
                return (total.float() - full.float()).abs().max().item() / full.float().abs().max().item()

            k2_equal, k4f_equal, dx_equal = (all(p[key] for p in parts) for key in ("k2", "k4f", "k4b_dx"))
            k3_err = max(p["k3"] for p in parts)
            cond_err = max(rel("dshift", dshift, parts), rel("dscale", dscale, parts))
            cond_lost = min(rel("dshift", dshift, parts[:-1]), rel("dscale", dscale, parts[:-1]))
            if not (k2_equal and k4f_equal and dx_equal) or k3_err > k3_tol or not cond_err <= cond_tol < cond_lost:
                raise AssertionError(f"parallel.shards tp={tp} {dtype}: K2 equal {k2_equal}, K3 err {k3_err:.3e} "
                                     f"(tol {k3_tol:.3e}), K4f equal {k4f_equal}, K4b dx equal {dx_equal}, "
                                     f"dshift/dscale rel err {cond_err:.3e} (tol {cond_tol}; a lost rank reads "
                                     f"{cond_lost:.3e})")
            # rank 0's calls, timed, with their bounds (as the full calls')
            qkv_0, seeds_0, g_0 = qkv[..., cols(0, 3 * heads * d)].contiguous(), seeds[:, :h].contiguous(), \
                g[..., cols(0, heads * d)].contiguous()
            out_0, lse_0 = fap.flash_attention_fused_cuda(qkv_0, h, seeds_0, rate, with_lse=True)
            x_0, gx_0 = x[:, :rows].contiguous(), gx[:, :rows].contiguous()
            local = {
                "k2": dict(shape=list(qkv_0.shape), heads=h, ms=time_ms(
                    lambda: fap.flash_attention_fused_cuda(qkv_0, h, seeds_0, rate), flush=flush),
                    **bound(4 * b * seq * h * d * es + seeds_0.numel() * 4, 4 * b * h * seq * seq * d, peak)),
                "k3": dict(shape=list(qkv_0.shape), heads=h, ms=time_ms(
                    lambda: fap.flash_attention_fused_bwd_cuda(qkv_0, g_0, h, seeds_0, rate, out=out_0, lse=lse_0),
                    flush=flush),
                    **bound(7 * b * seq * h * d * es + seeds_0.numel() * 4, 10 * b * h * seq * seq * d, peak)),
                "k4f": dict(shape=list(x_0.shape), ms=time_ms(lambda: lm.layernorm_modulate_cuda(x_0, shift, scale),
                                                               flush=flush),
                            **bound(2 * x_0.numel() * es + 2 * b * dim * es, K4F_OPS_PER_ELEM * x_0.numel(), F32_FLOPS)),
                "k4b": dict(shape=list(x_0.shape), ms=time_ms(lambda: lm.layernorm_modulate_bwd_cuda(x_0, scale, gx_0),
                                                               flush=flush),
                            **bound(3 * x_0.numel() * es + 3 * b * dim * es, K4B_OPS_PER_ELEM * x_0.numel(), F32_FLOPS)),
            }
            tag = f"tp{tp}_{'bf16' if dtype == torch.bfloat16 else 'f32'}"
            for key, entry in entries.items():
                entry.setdefault("tp_local", {})[tag] = {**local[key], "full_ms": full_ms[key]}
            phase("parallel.shards", tp=tp, dtype=str(dtype), batch=b, rate=rate, k2_heads_bit_for_bit=k2_equal,
                  k3_max_abs_err=f"{k3_err:.3e}", k3_tol=f"{k3_tol:.3e}", k4f_rows_bit_for_bit=k4f_equal,
                  k4b_dx_rows_bit_for_bit=dx_equal, k4b_cond_sum_rel_err=f"{cond_err:.3e}", cond_tol=cond_tol,
                  k4b_cond_lost_rank_rel_err=f"{cond_lost:.3e}",
                  **{f"{key}_ms": f"{local[key]['ms']:.4f}" for key in local},
                  **{f"{key}_full_ms": f"{full_ms[key]:.4f}" for key in local},
                  **{f"{key}_bound_ms": f"{local[key]['bound_ms']:.4f}" for key in local})


def nccl_events(trace: Path) -> dict:
    """The device-side events of a Chrome trace whose names carry
    ``nccl``, by name: the collectives' ranges and kernels."""
    events = json.loads(trace.read_text()).get("traceEvents", [])
    found: dict = {}
    for e in events:
        name = str(e.get("name", ""))
        if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_user_annotation") and "nccl" in name.lower():
            found[name] = found.get(name, 0) + 1
    return found


def run_trainer(args: list[str], log: Path) -> tuple[Path, list[dict]]:
    """``python -m bsi_torch.train`` in this process, its console to ``log``
    (the tail printed if it fails); returns its run directory and its
    metrics.jsonl records."""
    import contextlib

    from bsi_torch.train.__main__ import main as train_main

    log.parent.mkdir(parents=True, exist_ok=True)
    with open(log, "w") as out, contextlib.redirect_stdout(out):
        try:
            rc = train_main(args)
        except BaseException:
            out.flush()
            print(log.read_text()[-4000:], file=sys.stderr)
            raise
    if rc != 0:
        raise AssertionError(f"python -m bsi_torch.train {' '.join(args)} exited {rc}")
    (run_dir,) = [p.parent for p in log.parent.glob("**/metrics.jsonl")]
    return run_dir, [json.loads(line) for line in (run_dir / "metrics.jsonl").read_text().splitlines()]


def metric(records: list[dict], key: str) -> list:
    return [r[key] for r in records if key in r]


def phase(name: str, **fields) -> None:
    print(f"[{name}] " + " ".join(f"{k}={v}" for k, v in fields.items()), flush=True)


def time_ms(fn, *, reps: int = 30, flush=None) -> float:
    """Median milliseconds of ``fn()`` over ``reps`` runs, each between two
    CUDA events, after one warm-up; ``flush()`` runs untimed before each."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(n_bytes: float, ops: float, peak_ops: float) -> dict:
    """The least time the card could take: the larger of the bytes over HBM
    bandwidth and the operations over the peak of their type."""
    by_bytes, by_ops = n_bytes / HBM_BYTES_PER_S, ops / peak_ops
    return dict(bound_ms=max(by_bytes, by_ops) * 1e3, bound_by="bytes" if by_bytes >= by_ops else "operations")


def check_close(name: str, got, want, atol: float, rtol: float = 0.0) -> float:
    """Max abs error of ``got`` against ``want``; raises where it exceeds
    ``atol + rtol * |want|``."""
    diff = (got.float() - want.float()).abs()
    excess = (diff - atol - rtol * want.float().abs()).max().item()
    if not excess <= 0:
        raise AssertionError(f"{name}: max abs err {diff.max().item()} exceeds atol {atol} + rtol {rtol}")
    return diff.max().item()


def check_bwd(name: str, got, want, dtype, parts=("dx", "dgamma", "dbeta")) -> list[float]:
    """A norm's backward (K7b, K4b) against the plain VJP: dx within 1e-5
    (f32) or 2e-2 plus one bf16 ulp (bf16, as the forwards); the per-channel
    gradients (dgamma and dbeta, dshift and dscale), sums over the rows of an
    image, within 1e-4 of their largest element (f32 sums in another order),
    plus one ulp in bf16, where they are rounded to bf16."""
    import torch

    ulp = 2**-7 if dtype == torch.bfloat16 else 0.0
    errs = []
    for part, a, b in zip(parts, got, want):
        if a.dtype != b.dtype or a.shape != b.shape:
            raise AssertionError(f"{name} {part}: {a.dtype} {tuple(a.shape)} vs {b.dtype} {tuple(b.shape)}")
        atol = (2e-2 if dtype == torch.bfloat16 else 1e-5) if part == "dx" else 1e-4 * b.abs().max().item()
        errs.append(check_close(f"{name} {part}", a, b, atol, ulp))
    return errs


def check_attn_bwd(name: str, got, want, dtype, floor: float = 0.0) -> float:
    """An attention gradient (K3, K6b) against the plain backward: bf16
    within 2e-2 of its largest element (P and dS rounded to bf16 at other
    points than the plain version's, the outputs rounded to bf16), f32
    within 1e-5 of it (exact f32 products summed in another order), plus
    `floor`. Returns the max abs error."""
    import torch

    tol = (2e-2 if dtype == torch.bfloat16 else 1e-5) * want.float().abs().max().item() + floor
    if got.dtype != want.dtype or got.shape != want.shape:
        raise AssertionError(f"{name}: {got.dtype} {tuple(got.shape)} vs {want.dtype} {tuple(want.shape)}")
    return check_close(name, got, want, tol)


def s1_floor(seq: int, dv_want, dtype) -> float:
    """The tolerance dQ and dK take beside their own at S = 1, where they
    vanish (a softmax over one key is constant): the Hopper backward takes
    delta from the forward's output rounded to bf16 and dP from the
    products, two roundings of the terms that cancel, whose scale is dV's.
    So 2e-2 (bf16) or 1e-5 (f32) of dV's largest element; 0 at S > 1."""
    import torch

    if seq != 1:
        return 0.0
    return (2e-2 if dtype == torch.bfloat16 else 1e-5) * dv_want.float().abs().max().item()


def cuda_kernel_names(fn) -> list[str]:
    """The names of the CUDA kernels ``fn()`` launches, from a profile."""
    import torch

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted({evt.key for evt in prof.key_averages() if evt.device_type == torch.autograd.DeviceType.CUDA})


def library_bwd_ms(backward, mark, reps: int = 30) -> tuple[float, list[str], int]:
    """The device time of ``backward()`` from a profile: the median over the
    calls of the summed device time of the CUDA kernels one call launches
    (``torch.profiler``), after three warm-up calls. ``mark()`` (an in-place
    bitwise not, which no backward launches) runs before each of ``reps``
    calls and after the last: it flushes the L2 and its kernel, found in the
    same trace, separates the calls. The host's gaps between the kernels
    are not counted, so the number is the kernels' own time, steady from run
    to run where one ``autograd.grad`` call between CUDA events is not.

    Every call counted must launch the same kernels as every other: a call
    that lost a kernel, or two calls merged where a mark was lost, fail
    that. The tracer may drop the first events of a trace, and with them
    whole calls: a trace is taken again, up to three times, until all
    ``reps`` calls are separated; failing that, the trace that separated
    most is taken if that is at least half. Returns ms, the kernels' names
    and the number of calls the median is over."""
    import torch

    for _ in range(3):
        backward()
    torch.cuda.synchronize()
    best = None
    for _ in range(3):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                mark()
                backward()
            mark()
            torch.cuda.synchronize()
        kernels = sorted((evt for evt in prof.events() if evt.device_type == torch.autograd.DeviceType.CUDA),
                         key=lambda evt: evt.time_range.start)
        # mark()'s kernel by name, else as the one kernel launched reps + 1 times
        counts = collections.Counter(evt.name for evt in kernels)
        separators = {name for name in counts if "bitwise_not" in name} or {
            name for name, n in counts.items() if n == reps + 1}
        per_call, launched = [], []
        for evt in kernels:
            if evt.name in separators:
                per_call.append(0.0)
                launched.append(collections.Counter())
            elif per_call:
                per_call[-1] += evt.time_range.elapsed_us() / 1e3
                launched[-1][evt.name] += 1
        per_call, launched = per_call[:-1], launched[:-1]  # what follows the last mark is nothing
        if per_call and all(calls == launched[0] for calls in launched) and launched[0]:
            if len(per_call) == reps:
                return statistics.median(per_call), sorted(launched[0]), reps
            if best is None or len(per_call) > len(best[2]):
                best = statistics.median(per_call), sorted(launched[0]), per_call
    if best is not None and 2 * len(best[2]) >= reps:
        return best[0], best[1], len(best[2])
    raise AssertionError(f"backward profile: {len(per_call)} calls of {reps} separated, times {per_call}, "
                         f"kernels a call {[dict(calls) for calls in launched]}")


def ptxas_report(log: str) -> dict:
    """Registers and spill bytes of each kernel from ``nvcc -Xptxas -v``."""
    import re

    report, name = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            report[name] = {}
        elif name is not None:
            for key, pattern in (("registers", r"Used (\d+) registers"),
                                 ("spill_store_bytes", r"(\d+) bytes spill stores"),
                                 ("spill_load_bytes", r"(\d+) bytes spill loads")):
                found = re.search(pattern, line)
                if found:
                    report[name][key] = int(found.group(1))
    return report


def sass_instructions(library: Path, wanted: tuple[str, ...]) -> dict:
    """For each kernel in ``library``, how many of its SASS instructions
    start with each opcode of ``wanted`` (``cuobjdump -sass``)."""
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(library)], capture_output=True, text=True, check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            counts[name] = dict.fromkeys(wanted, 0)
        elif name is not None and "*/" in line:
            words = line.split("*/", 1)[1].split()
            if words:
                opcode = words[1] if words[0].startswith("@") and len(words) > 1 else words[0]
                for op in wanted:
                    if opcode.startswith(op):
                        counts[name][op] += 1
    return counts


def card_vs_cpu_grads(what: str, models, algo, x, t, eps):
    """The mean train-loss gradients of ``models`` (a CPU model, then its
    copy on the card) on the same draws, each of the card's leaves within
    1e-3 of the CPU's leaf's norm. Returns the CPU's gradients by name, the
    worst relative error, its leaf, whether the card's are finite, and the
    two losses (CPU, card)."""
    import torch

    grads, losses = [], []
    for model in models:
        device = next(model.parameters()).device
        named = dict(model.named_parameters())
        loss = algo._train_loss_on(model, x.to(device), t.to(device), eps.to(device)).mean()
        losses.append(loss.item())
        grads.append(dict(zip(named, (g.cpu() for g in torch.autograd.grad(loss, list(named.values()))))))
    worst, worst_name = 0.0, None
    for name, want in grads[0].items():
        rel = ((grads[1][name] - want).norm() / want.norm()).item()
        if not rel <= 1e-3:
            raise AssertionError(f"{what} {name}: card vs CPU {rel:.3e} of its norm, limit 1e-3")
        if rel > worst:
            worst, worst_name = rel, name
    return grads[0], worst, worst_name, all(bool(torch.isfinite(g).all()) for g in grads[1].values()), losses


def bench_fields(record: dict) -> dict:
    """A bench record's rate, its share of the card's peak (where the card
    is in ``profile_sampling.PEAK_FLOPS``) and the card, as a phase prints them."""
    mfu = record.get("mfu")
    return dict(tflop_per_s=f"{record['tflops_per_sec']:.1f}", mfu=f"{mfu:.4f}" if mfu is not None else None,
                device=repr(record["device"]), power_limit=repr(record["power_limit"]))


def check_train(record: dict) -> None:
    """A train bench's last loss is positive (``bench_train.run`` has held
    it and the gradient norm finite, and the moments to their dtypes)."""
    if not record["final_loss"] > 0:
        raise AssertionError(f"{record['metric']}: final loss {record['final_loss']}")


def predicted_train_peak_gib(batch: int, pixels: int, dim: int, levels: int) -> float:
    """Activations autograd keeps for one bf16 train step, from the shapes:
    per residual block its input (GroupNorm and skip), the GroupNorm output
    (conv1's input), conv1's output (FiLM's product), FiLM's output (SiLU's
    input), the dropout mask (1 byte) and output (conv2's input); plus the
    plain attention backward's f32 logits and probabilities and bf16
    probabilities at S=pixels, alive at once."""
    per_row = lambda c_in: 2 * c_in * 2 + 3 * dim * 2 + dim
    blocks = (levels + 2) * per_row(dim) + levels * per_row(2 * dim)
    attention = batch * pixels * pixels * (4 + 4 + 2)
    return (batch * pixels * blocks + attention) / 2**30


# [ops.conv3x3]: K8f against f64 F.conv2d at (batch, Cin, Cout, H, W): the
# UNet's three 3x3 shapes at the sample cell's batch, then batch 1, a
# border-heavy 8x8 and tiles the pixels and Cout leave ragged; timed at the
# first three.
CONV3X3_SHAPES = ((128, 128, 128, 32, 32), (128, 256, 128, 32, 32), (128, 128, 384, 32, 32),
                  (1, 128, 128, 32, 32), (16, 128, 128, 8, 8), (3, 48, 132, 5, 7))
CONV3X3_TIMED = 3


def conv3x3_phase(dev, randn, flush) -> dict:
    """[ops.conv3x3]: K8f's build (FFMA, no tensor-core instruction in its
    SASS), parity with f64 ``F.conv2d`` and two launches bit for bit at
    ``CONV3X3_SHAPES``, its time at the UNet's three shapes beside its FFMA
    bound, cuDNN's default (FFT at TF32 off) and cuDNN's autotuned best
    (``cudnn.benchmark``, set here alone), and the routes of one f32 UNet
    forward, encode's padded 21 channels included. Returns the kernel's
    entry of the ``kernels`` line (128 -> 128)."""
    import torch
    from torch.nn import functional as F

    from bsi_torch.nn import Conv
    from bsi_torch.ops import _build
    from bsi_torch.ops import conv3x3 as cv
    from bsi_torch.profile_sampling import build_model
    from bsi_torch.utils import profiling

    library, _, _ = _build.build(cv.SOURCE)
    sass = sass_instructions(library, ("FFMA", "HMMA", "HGMMA", "IMMA"))
    if not sass or not all(c["FFMA"] and not (c["HMMA"] or c["HGMMA"] or c["IMMA"]) for c in sass.values()):
        raise AssertionError(f"{cv.SOURCE}: a kernel without FFMA or with a tensor-core instruction: {sass}")
    phase("ops.conv3x3", sass=sass)
    entry = None
    for i, (b, cin, cout, h, w) in enumerate(CONV3X3_SHAPES):
        x = randn(b, cin, h, w).to(memory_format=torch.channels_last)
        weight, bias = randn(cout, cin, 3, 3) / (9 * cin) ** 0.5, randn(cout)
        got, again = cv.conv3x3_cuda(x, weight, bias), cv.conv3x3_cuda(x, weight, bias)
        want = F.conv2d(x.double(), weight.double(), bias.double(), padding=1)
        torch.cuda.synchronize()
        # f32 sums of 9 Cin products of size ~1 / sqrt(9 Cin) into outputs up to
        # ~5, rounded at each of up to 2,304 steps: ~1e-5 at the worst of 16 M
        # outputs; TF32 products would miss by ~5e-4 typically
        err = check_close(f"K8f {(b, cin, cout, h, w)}", got, want, 5e-5)
        if not torch.equal(got, again):
            raise AssertionError(f"K8f {(b, cin, cout, h, w)}: two launches differ")
        fields = dict(shape=[b, cin, cout, h, w], max_abs_err=f"{err:.3e}", atol=5e-5, repeat="bit for bit")
        if i < CONV3X3_TIMED:
            ops = 2 * b * h * w * cin * cout * 9
            kernel_ms = time_ms(lambda: cv.conv3x3_cuda(x, weight, bias), flush=flush)
            cudnn = lambda: F.conv2d(x, weight, bias, padding=1)
            cudnn_ms = time_ms(cudnn, flush=flush)
            cudnn_kernels = cuda_kernel_names(cudnn)
            torch.backends.cudnn.benchmark = True
            try:
                tuned_ms = time_ms(cudnn, flush=flush)
                tuned_kernels = cuda_kernel_names(cudnn)
            finally:
                torch.backends.cudnn.benchmark = False
            timed = dict(ms=kernel_ms, library_ms=cudnn_ms, library_autotuned_ms=tuned_ms,
                         **bound(x.numel() * 4 + b * h * w * cout * 4 + weight.numel() * 4, ops, F32_FLOPS))
            fields.update(timed, share_of_bound=f"{timed['bound_ms'] / kernel_ms:.3f}",
                          tflops=f"{ops / kernel_ms / 1e9:.1f}", cudnn_kernels=cudnn_kernels,
                          cudnn_autotuned_kernels=tuned_kernels)
            if kernel_ms >= cudnn_ms:
                raise AssertionError(f"K8f {(b, cin, cout, h, w)}: {kernel_ms:.4f} ms, not faster than cuDNN's "
                                     f"default {cudnn_ms:.4f} ms")
            if i == 0:
                entry = dict(name="conv3x3", route="cuda", source="bsi_torch/ops/csrc/conv3x3.cu", replaces=None,
                             shape=[b, cin, cout, h, w], dtype="float32", max_abs_err=err, **timed)
        phase("ops.conv3x3", **fields)
        del x, weight, bias, got, again, want
    # the dispatch at encode's shape: 21 channels, zero-padded to 32
    x = randn(128, 21, 32, 32).to(memory_format=torch.channels_last)
    weight, bias = randn(128, 21, 3, 3) / (9 * 21) ** 0.5, randn(128)
    err = check_close("K8f at encode's (128, 21, 128, 32, 32)", cv.conv3x3(x, weight, bias),
                      F.conv2d(x.double(), weight.double(), bias.double(), padding=1), 5e-5)
    phase("ops.conv3x3", shape=[128, 21, 128, 32, 32], route="conv3x3, Cin padded to 32", max_abs_err=f"{err:.3e}",
          atol=5e-5)
    del x, weight, bias
    # the routes of one f32 forward of the full-width UNet
    unet = build_model("unet", dev, dtype=None)
    n_convs = sum(isinstance(m, Conv) and m.kernel_size == (3, 3) for m in unet.modules())
    if n_convs != CONV3X3_PER_FORWARD:
        raise AssertionError(f"the UNet has {n_convs} 3x3 convolutions, not {CONV3X3_PER_FORWARD}")
    mu = randn(BATCH, *DATA_SHAPE)
    profiling.clear()
    with torch.no_grad(), torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]):
        unet(mu, torch.full((BATCH,), 0.5, device=dev))
        torch.cuda.synchronize()
    routes = {key: n for key, n in profiling.counters().items() if key.startswith("ops.K8f.")}
    profiling.clear()
    if routes != {"ops.K8f.kernel": CONV3X3_PER_FORWARD}:
        raise AssertionError(f"one f32 UNet forward: K8f routes {routes}, want {CONV3X3_PER_FORWARD} kernel")
    phase("ops.conv3x3", unet_forward_routes=routes)
    del unet, mu
    return entry


def main() -> int:
    import torch

    script_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    if sys.argv[1:2] == ["--child"]:
        # a process that [parallel.launch] or [parallel.gloo2] starts
        kind, args = sys.argv[2], sys.argv[3:]
        if kind == "train":
            return child_train(args[0], args[1:])
        if kind == "pipe2":
            return child_pipe2(int(args[0]), args[1], args[2], args[3])
        if kind == "pipe_train":
            return child_pipe_train(int(args[0]), args[1], args[2], args[3:])
        return child_gloo2(int(args[0]), args[1], args[2])
    import numpy as np
    from torch.nn import functional as F

    from bsi_torch import BFN, VDM, Discretization, bench
    from bsi_torch.data import ImageNetDataModule, NpyRowSource
    from bsi_torch.data.imagenet import write_synthetic_shards
    from bsi_torch.ops import _build
    from bsi_torch.ops import conv3x3 as cv
    from bsi_torch.ops import flash_attention as fa
    from bsi_torch.ops import flash_attention_packed as fap
    from bsi_torch.ops import groupnorm_silu as gn
    from bsi_torch.ops import ln_modulate as lm
    from bsi_torch.ops.dropout_mask import keep_probe, keep_probe_bwd, keep_probe_bwd_counts, keep_probe_counts
    from bsi_torch.profile_sampling import DIT_L2, UNET, build_algo, build_model, count_flops
    from bsi_torch.scripts import bench_train
    from bsi_torch.train import TrainState, make_eval_step, make_sample_fn, module_apply

    dev = torch.device("cuda")
    # The shapes the kernels are held at are the bench rows' (module constants).
    want_rows = dict(batch=BATCH, k=K_STEPS, train_batch=TRAIN_BATCH, dit_train_batch=DIT_TRAIN_BATCH,
                     dit_dropout=DIT_DROPOUT)
    rows = dict(batch=bench.BATCH, k=bench.K_STEPS, train_batch=bench_train.BATCH["unet"],
                dit_train_batch=bench_train.BATCH["dit"], dit_dropout=bench_train.DROPOUT["dit"])
    if rows != want_rows:
        raise AssertionError(f"chip_smoke.py's shapes {want_rows} are not the bench's {rows}")
    # The UNet with downsampling_attention (gelu: flax cannot build it with
    # silu): an attention tail on each of the 66 residual blocks plus the
    # centre's, all over the image's pixels.
    tail_attentions = 2 * UNET["levels"] + 2 + 1
    # its f32 forward's K8f launches: two 3x3 convolutions a residual block and
    # an attention, and encode
    tail_convs = 2 * (2 * UNET["levels"] + 2) + 2 * tail_attentions + 1
    b512_micro = bench.TRAIN_ROWS["dit-train-b512"]["batch"] // bench.TRAIN_ROWS["dit-train-b512"]["accum"]
    # f32 results are compared against the CPU and the plain versions: no TF32.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    # ---------------------------------------------------------------- card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    sm_clock = lambda: subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader"],
                                      capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    phase("card", nvidia_smi=repr(smi), torch=torch.__version__, cuda=torch.version.cuda,
          device=repr(torch.cuda.get_device_name(0)), count=torch.cuda.device_count(), sm_clock=repr(sm_clock()))

    # Every kernel's launch counter, by the name its JSON entry carries.
    counters = {
        "flash_attention": fa.flash_attention_cuda,
        "flash_attention_dropout": fa.flash_attention_dropout_cuda,
        "flash_attention_bwd": fa.flash_attention_bwd_cuda,
        "groupnorm_silu_fwd": gn.groupnorm_silu_cuda,
        "groupnorm_silu_bwd": gn.groupnorm_silu_bwd_cuda,
        "flash_attention_fused": fap.flash_attention_fused_cuda,
        "flash_attention_packed": fap.flash_attention_packed_cuda,
        "layernorm_modulate_fwd": lm.layernorm_modulate_cuda,
        "flash_attention_fused_bwd": fap.flash_attention_fused_bwd_cuda,
        "flash_attention_packed_bwd": fap.flash_attention_packed_bwd_cuda,
        "layernorm_modulate_bwd": lm.layernorm_modulate_bwd_cuda,
        "conv3x3": cv.conv3x3_cuda,
    }

    def reset_counts():
        for wrapper in counters.values():
            wrapper.launches = 0
        gn.groupnorm_silu_bwd_cuda.g_copies = 0

    def read_counts() -> dict:
        return {name: wrapper.launches for name, wrapper in counters.items()}

    def expect_counts(what: str, **want) -> dict:
        """The counts, which must be ``want`` for the kernels named and 0 for
        every other; and no gradient K7b was given may have been copied to
        a contiguous one first (``g_copies``)."""
        got = read_counts()
        want = {name: want.get(name, 0) for name in counters}
        if got != want:
            raise AssertionError(f"kernel launches in {what}: {got}, want {want}")
        if gn.groupnorm_silu_bwd_cuda.g_copies:
            raise AssertionError(f"{what}: K7b copied {gn.groupnorm_silu_bwd_cuda.g_copies} strided gradients")
        return got

    # --------------------------------------------------------------- build
    # nvcc builds K1, K5f, K5b, K2/K6f, K3/K6b, K7f/K7b, K4b and K8f, one
    # process each, while Triton compiles K4f on its first launch.
    start = time.perf_counter()
    sources = (fa.SOURCE, fa.DROPOUT_SOURCE, fa.BWD_SOURCE, fap.SOURCE, fap.BWD_SOURCE, gn.SOURCE, lm.SOURCE,
               cv.SOURCE)
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        nvcc = {src: pool.submit(_build.build, src) for src in sources}
        x = torch.randn(2, 64, 64, device=dev)
        x4 = torch.randn(2, 8, 1024, device=dev)
        lm.layernorm_modulate_cuda(x4, x[:, 0, :1].expand(2, 1024), x[:, 1, :1].expand(2, 1024))
        torch.cuda.synchronize()
        triton_k4f_s = time.perf_counter() - start
        built = {src: future.result() for src, future in nvcc.items()}
    phase("build", k1_nvcc_s=f"{built[fa.SOURCE][1]:.2f}", k5f_nvcc_s=f"{built[fa.DROPOUT_SOURCE][1]:.2f}",
          k5b_nvcc_s=f"{built[fa.BWD_SOURCE][1]:.2f}", k2_nvcc_s=f"{built[fap.SOURCE][1]:.2f}",
          k3_nvcc_s=f"{built[fap.BWD_SOURCE][1]:.2f}", k7_nvcc_s=f"{built[gn.SOURCE][1]:.2f}",
          k4b_nvcc_s=f"{built[lm.SOURCE][1]:.2f}", k8f_nvcc_s=f"{built[cv.SOURCE][1]:.2f}",
          k4f_triton_first_launch_s=f"{triton_k4f_s:.2f}",
          total_s=f"{time.perf_counter() - start:.2f}", libraries=[path.name for path, _, _ in built.values()])
    for source, (_, _, log) in built.items():
        for kernel, info in ptxas_report(log).items():
            phase("build.ptxas", source=source, kernel=kernel, **info)
    # K1's, K5f's, K2's and K6f's bf16 bodies at head_dim 64 and 128, and
    # K5b's, K3's and K6b's, must be the Hopper design: wgmma (SASS HGMMA)
    # fed by TMA loads (UTMALDG); K7f and K7b, in both dtypes, TMA loads.
    for source in (fa.SOURCE, fa.DROPOUT_SOURCE, fap.SOURCE, fa.BWD_SOURCE, fap.BWD_SOURCE):
        sass = sass_instructions(built[source][0], ("HGMMA", "UTMALDG"))
        hopper = {name: counts for name, counts in sass.items() if "bf16_sm90" in name}
        if not hopper or not all(counts["HGMMA"] and counts["UTMALDG"] for counts in hopper.values()):
            raise AssertionError(f"{source}: no bf16 kernel with HGMMA and UTMALDG in its SASS: {sass}")
        phase("build.sass", source=source, **{name: counts for name, counts in hopper.items()})
    sass = sass_instructions(built[gn.SOURCE][0], ("UTMALDG", "UTMASTG"))
    k7_sass = {name: counts for name, counts in sass.items() if "gn_silu" in name}
    if len(k7_sass) != 4 or not all(counts["UTMALDG"] for counts in k7_sass.values()):
        raise AssertionError(f"{gn.SOURCE}: not four K7 kernels with UTMALDG in their SASS: {sass}")
    phase("build.sass", source=gn.SOURCE, **k7_sass)
    # K4b's TMA bodies load by TMA, the one DiT-L/2's bf16 rows take (its
    # lane vectors in the template's name) first of all.
    sass = sass_instructions(built[lm.SOURCE][0], ("UTMALDG",))
    k4b_sass = {name: counts for name, counts in sass.items() if "ln_mod_bwd_tma" in name}
    main_plan = lm.plan(BATCH, (DATA_SHAPE[0] // DIT_L2["patch_size"]) ** 2, DIT_L2["dim"], torch.bfloat16)
    main_body = [name for name in k4b_sass if "nv_bfloat16" in name and f"Li{main_plan.lane_vectors}E" in name]
    if len(main_body) != 1 or not all(counts["UTMALDG"] for counts in k4b_sass.values()):
        raise AssertionError(f"{lm.SOURCE}: no TMA body for DiT-L/2's rows, or one without UTMALDG: {sass}")
    phase("build.sass", source=lm.SOURCE, main_body=main_body[0], **k4b_sass)
    # Triton's compiled K4f carries its register and spill counts (the ptxas
    # report of the CUDA route); older Triton may lack the fields.
    compiled = lm.layernorm_modulate_cuda.compiled
    phase("build.triton", kernel="k4f", registers=getattr(compiled, "n_regs", "unknown"),
          spills=getattr(compiled, "n_spills", "unknown"), shared_bytes=getattr(compiled, "shared", "unknown"))

    gen = torch.Generator(device=dev).manual_seed(SEED)
    randn = lambda *shape, dtype=torch.float32: torch.randn(
        *shape, generator=gen, device=dev, dtype=torch.float32).to(dtype)
    # Evicts the 50 MB L2 between timed runs, so every kernel reads its
    # inputs from HBM, as its bound assumes.
    scrub = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    flush = lambda: scrub.zero_()
    kernels = []
    # The library's backwards, timed from a profile after the main paths:
    # (label, the kernel's dict that takes library_ms, a maker of the
    # backward call).
    library_backwards = []
    # The redesigned backwards' own device time, from a profile as the
    # library's (label, the dict that takes device_ms, the call); the inputs
    # stay alive until then.
    device_times = []

    # ------------------------------------------------------ K1 vs its twin
    for shape, dtype, atol in [
        ((BATCH, 1, 1024, 128), torch.bfloat16, 2e-2),
        ((BATCH, 1, 1024, 128), torch.float32, 1e-5),
        # the trainer's f32 shapes: a train step's and a validation's
        ((TRAINER_BATCH, 1, 1024, 128), torch.float32, 1e-5),
        ((TRAINER_EVAL_BATCH, 1, 1024, 128), torch.float32, 1e-5),
        # the eval suite's
        *(((batch, 1, 1024, 128), torch.float32, 1e-5) for batch in EVAL_SUITE_BATCHES),
        ((3, 2, 200, 64), torch.bfloat16, 2e-2),
        ((3, 2, 200, 64), torch.float32, 1e-5),
        ((2, 2, 384, 256), torch.bfloat16, 2e-2),
        ((2, 2, 384, 256), torch.float32, 1e-5),
        ((2, 1, 1, 128), torch.bfloat16, 2e-2),
        ((2, 1, 1, 128), torch.float32, 1e-5),
        ((2, 2, 63, 128), torch.bfloat16, 2e-2),
        ((2, 2, 63, 128), torch.float32, 1e-5),
        ((2, 1, 1000, 128), torch.bfloat16, 2e-2),
        ((2, 1, 1000, 128), torch.float32, 1e-5),
    ]:
        q, k, v = (randn(*shape, dtype=dtype) for _ in range(3))
        got = fa.flash_attention_cuda(q, k, v)
        want = fa._fwd_math(q, k, v, fa._scale(q))
        torch.cuda.synchronize()
        err = check_close(f"K1 {shape} {dtype}", got, want, atol)
        phase("k1.check", shape=shape, dtype=str(dtype), max_abs_err=f"{err:.3e}", atol=atol)
    b, h, s, d = BATCH, 1, 1024, 128
    q, k, v = (randn(b, h, s, d, dtype=torch.bfloat16) for _ in range(3))
    err = check_close("K1 main", fa.flash_attention_cuda(q, k, v), fa._fwd_math(q, k, v, fa._scale(q)), 2e-2)
    k1 = dict(
        name="flash_attention", route="cuda", source="bsi_torch/ops/csrc/flash_attention.cu",
        device_code="bsi_torch/ops/csrc/bh_attention_fwd_sm90.cuh",
        replaces="bsi_tpu/ops/flash_attention.py:232", shape=[b, h, s, d], dtype="bfloat16",
        max_abs_err=err,
        ms=time_ms(lambda: fa.flash_attention_cuda(q, k, v), flush=flush),
        plain_ms=time_ms(lambda: fa._fwd_math(q, k, v, fa._scale(q)).to(q.dtype), flush=flush),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(q, k, v), flush=flush),
        **bound(4 * b * h * s * d * q.element_size(), 4 * b * h * s * s * d, BF16_TENSOR_FLOPS),
    )
    phase("k1.time", **{key: k1[key] for key in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")})
    kernels.append(k1)

    # ------------------------------------------- K8f vs f64 F.conv2d, cuDNN
    kernels.append(conv3x3_phase(dev, randn, flush))

    # ------------------------------------------------------- K7f, K7b plans
    # The plan each of K7f's and K7b's shapes takes (csrc/groupnorm_silu.cu:
    # a slab of 128 bytes of every row, split across a cluster), with how
    # many of its clusters the card holds at once: the 32x32 UNet (1,024
    # rows: b64 sampling, b128 training), the 16x16 (256 rows, with the f32
    # eval step) and a UNet on 64x64 images (4,096 rows).
    bf16, f32 = torch.bfloat16, torch.float32
    for shape, dtype, backward in (((BATCH, 1024, 128), bf16, False), ((BATCH, 1024, 256), bf16, False),
                                   ((BATCH, 256, 128), bf16, False), ((BATCH, 256, 256), bf16, False),
                                   ((EVAL_BATCH, 256, 128), f32, False), ((EVAL_BATCH, 256, 256), f32, False),
                                   ((BATCH, 4096, 128), bf16, False), ((TRAIN_BATCH, 1024, 128), bf16, True),
                                   ((TRAIN_BATCH, 1024, 256), bf16, True), ((TRAIN_BATCH, 256, 128), bf16, True),
                                   ((TRAIN_BATCH, 256, 256), bf16, True), ((BATCH, 4096, 128), bf16, True)):
        plan = gn.plan(*shape, 32, dtype, backward)
        phase("k7.plan", kernel="k7b" if backward else "k7f", shape=shape, dtype=str(dtype), width=plan.width,
              chunk_rows=plan.chunk_rows, chunks=plan.chunks, cluster=plan.cluster,
              ctas=plan.slabs * plan.cluster, smem_bytes=plan.smem_bytes,
              clusters_held=gn.max_active_clusters(plan, dtype, backward))

    # ------------------------------------------------------ K7 vs its twin
    # bf16: both sides round z to bf16 before the SiLU and the product after it;
    # f32 statistics summed in another order can move either rounding by one
    # bf16 ulp (2^-7 relative at most), beside 2e-2 absolute. At 1,024 rows
    # (32x32), 256 (16x16) and 4,096 (64x64); two launches the same bits.
    k7_times, k7_inputs = {}, {}
    for rows in (1024, 256, 4096):
        for c in (128, 256):
            for dtype, atol, rtol in ((bf16, 2e-2, 2**-7), (f32, 1e-5, 0.0)):
                x = randn(BATCH, rows, c, dtype=dtype)
                gamma = (1.0 + 0.1 * randn(c)).to(dtype)
                beta = (0.1 * randn(c)).to(dtype)
                got = gn.groupnorm_silu_cuda(x, gamma, beta, 32)
                want = gn._reference_math(x, gamma, beta, 32)
                torch.cuda.synchronize()
                err = check_close(f"K7 {(BATCH, rows, c)} {dtype}", got, want, atol, rtol)
                if not torch.equal(gn.groupnorm_silu_cuda(x, gamma, beta, 32), got):
                    raise AssertionError(f"K7 {(BATCH, rows, c)} {dtype}: two launches differ")
                phase("k7.check", shape=(BATCH, rows, c), dtype=str(dtype), max_abs_err=f"{err:.3e}",
                      atol=atol, rtol=rtol, two_launches_bit_for_bit=True)
                del got, want
                # times at the 32x32 sampling shapes, bf16, and the 16x16
                # ones: sampling bf16, the eval step f32
                if rows == 4096 or (rows == 1024 and dtype != bf16):
                    continue
                x_nchw = x.permute(0, 2, 1).contiguous()
                elems = x.numel()
                # per element: x*x, two sums, x - mean, one FMA for the
                # affine, negate, exp, add, divide, the final product: 11 f32
                # operations
                k7_times[rows, c, dtype] = dict(
                    shape=[BATCH, rows, c], dtype=str(dtype).split(".")[1], max_abs_err=err,
                    ms=time_ms(lambda: gn.groupnorm_silu_cuda(x, gamma, beta, 32), flush=flush),
                    plain_ms=time_ms(lambda: gn._reference_math(x, gamma, beta, 32), flush=flush),
                    library_ms=time_ms(
                        lambda: F.silu(F.group_norm(x_nchw, 32, gamma, beta, 1e-6)), flush=flush),
                    **bound(2 * elems * x.element_size() + 2 * c * x.element_size(), 11 * elems, F32_FLOPS),
                )
                phase("k7.time", shape=(BATCH, rows, c), dtype=str(dtype), **{
                    key: k7_times[rows, c, dtype][key]
                    for key in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")})
                if rows == 1024:
                    k7_inputs[c] = x, gamma, beta
    # the trainer's f32 shapes (a train step's forward and a validation's)
    # and the eval suite's
    for batch in (TRAINER_BATCH, TRAINER_EVAL_BATCH, *EVAL_SUITE_BATCHES):
        for c in (128, 256):
            x = randn(batch, 1024, c)
            gamma, beta = 1.0 + 0.1 * randn(c), 0.1 * randn(c)
            got = gn.groupnorm_silu_cuda(x, gamma, beta, 32)
            want = gn._reference_math(x, gamma, beta, 32)
            torch.cuda.synchronize()
            err = check_close(f"K7 {(batch, 1024, c)} f32", got, want, 1e-5)
            phase("k7.check", shape=(batch, 1024, c), dtype=str(f32), max_abs_err=f"{err:.3e}", atol=1e-5,
                  rtol=0.0, path="trainer" if batch in (TRAINER_BATCH, TRAINER_EVAL_BATCH) else "eval suite")
            del x, got, want
    k7 = dict(name="groupnorm_silu_fwd", route="cuda", source="bsi_torch/ops/csrc/groupnorm_silu.cu",
              device_code="bsi_torch/ops/csrc/tma_sm90.cuh", replaces="bsi_tpu/ops/groupnorm_silu.py:133",
              **k7_times[1024, 256, bf16], at_c128=k7_times[1024, 128, bf16],
              at_16x16={f"c{c}_{str(dtype).split('.')[1]}": k7_times[256, c, dtype] for c in (128, 256)
                        for dtype in (bf16, f32)})
    kernels.append(k7)
    for c, entry in ((256, k7), (128, k7["at_c128"])):
        device_times.append((f"k7f at C={c}", entry,
                             functools.partial(gn.groupnorm_silu_cuda, *k7_inputs[c], 32)))

    # ----------------------------------------------------- K7b vs its twin
    # At the train steps' shapes, [128, rows, C] at 1,024 and 256 rows, and
    # [16, 4096, C]; gamma and beta in x's dtype; two launches the same bits.
    k7b_times = {}
    for rows, batch in ((1024, TRAIN_BATCH), (256, TRAIN_BATCH), (4096, TRAIN_BATCH // 8)):
        for c in (128, 256):
            for dtype in (bf16, f32):
                x = randn(batch, rows, c, dtype=dtype)
                g = randn(batch, rows, c, dtype=dtype)
                gamma = (1.0 + 0.1 * randn(c)).to(dtype)
                beta = (0.1 * randn(c)).to(dtype)
                got = gn.groupnorm_silu_bwd_cuda(x, gamma, beta, g, 32)
                want = gn._bwd_math(x, gamma, beta, g, 32)
                torch.cuda.synchronize()
                errs = check_bwd(f"K7b {(batch, rows, c)} {dtype}", got, want, dtype)
                if not all(map(torch.equal, gn.groupnorm_silu_bwd_cuda(x, gamma, beta, g, 32), got)):
                    raise AssertionError(f"K7b {(batch, rows, c)} {dtype}: two launches differ")
                phase("k7b.check", shape=(batch, rows, c), dtype=str(dtype),
                      max_abs_err_dx=f"{errs[0]:.3e}", max_abs_err_dgamma=f"{errs[1]:.3e}",
                      max_abs_err_dbeta=f"{errs[2]:.3e}", two_launches_bit_for_bit=True)
                del got, want
                if rows == 4096 or dtype != bf16:
                    continue
                elems = x.numel()
                k7b_times[rows, c] = dict(
                    shape=[batch, rows, c], dtype="bfloat16", max_abs_err=errs[0],
                    ms=time_ms(lambda: gn.groupnorm_silu_bwd_cuda(x, gamma, beta, g, 32), flush=flush),
                    plain_ms=time_ms(lambda: gn._bwd_math(x, gamma, beta, g, 32), flush=flush),
                    library="autograd through group_norm + silu on channels-first [B, C, L], graph kept",
                    **bound(3 * elems * x.element_size() + 4 * c * x.element_size(), K7B_OPS_PER_ELEM * elems,
                            F32_FLOPS),
                )
                phase("k7b.time", shape=(batch, rows, c), **{
                    key: k7b_times[rows, c][key] for key in ("ms", "plain_ms", "bound_ms", "bound_by")})
                if rows == 1024:
                    k7_inputs[c] = x, gamma, beta, g
    k7b = dict(name="groupnorm_silu_bwd", route="cuda", source="bsi_torch/ops/csrc/groupnorm_silu.cu",
               device_code="bsi_torch/ops/csrc/tma_sm90.cuh", replaces="bsi_tpu/ops/groupnorm_silu.py:149",
               **k7b_times[1024, 256], at_c128=k7b_times[1024, 128],
               at_16x16={f"c{c}": k7b_times[256, c] for c in (128, 256)})
    kernels.append(k7b)
    # the kernel with the wrapper's sum over the batch, as a step calls it
    for c, entry in ((256, k7b), (128, k7b["at_c128"])):
        device_times.append((f"k7b at C={c}", entry,
                             functools.partial(gn.groupnorm_silu_bwd_cuda, *k7_inputs[c], 32)))

    def norm_library_bwd(rows, c):
        def make():
            x_lib = randn(TRAIN_BATCH, c, rows, dtype=torch.bfloat16).requires_grad_()
            g_lib = randn(TRAIN_BATCH, c, rows, dtype=torch.bfloat16)
            gamma_lib = (1.0 + 0.1 * randn(c)).to(torch.bfloat16).requires_grad_()
            beta_lib = (0.1 * randn(c)).to(torch.bfloat16).requires_grad_()
            out_lib = F.silu(F.group_norm(x_lib, 32, gamma_lib, beta_lib, 1e-6))
            return lambda: torch.autograd.grad(out_lib, (x_lib, gamma_lib, beta_lib), g_lib, retain_graph=True)
        return make

    for rows, c, entry in ((1024, 256, k7b), (1024, 128, k7b["at_c128"]), (256, 128, k7b["at_16x16"]["c128"]),
                           (256, 256, k7b["at_16x16"]["c256"])):
        library_backwards.append((f"k7b at {(TRAIN_BATCH, rows, c)}", entry, norm_library_bwd(rows, c)))

    # ------------------------------------------------ K2, K6f vs their twin
    # bf16: the kernel's online softmax rounds unnormalised probabilities to
    # bf16 where the plain version rounds normalised ones, and the output is
    # rounded to bf16: 2e-2. f32: exact f32 products, sums in another order.
    dim, heads = DIT_L2["dim"], DIT_L2["heads"]
    b, seq, d = BATCH, (DATA_SHAPE[0] // DIT_L2["patch_size"]) ** 2, dim // heads
    for (cb, cs, ch, cd), dtype, atol in [
        ((b, seq, heads, d), torch.bfloat16, 2e-2),
        ((b, seq, heads, d), torch.float32, 1e-5),
        ((2, 128, 4, 64), torch.float32, 1e-5),
        ((2, 128, 2, 128), torch.bfloat16, 2e-2),
        ((2, 128, 2, 128), torch.float32, 1e-5),
    ]:
        qkv = randn(cb, cs, 3 * ch * cd, dtype=dtype)
        err = check_close(f"K2 {(cb, cs, ch, cd)} {dtype}", fap.flash_attention_fused_cuda(qkv, ch),
                          fap._fused_fwd_math(qkv, ch), atol)
        phase("k2.check", shape=(cb, cs, 3 * ch * cd), heads=ch, dtype=str(dtype), max_abs_err=f"{err:.3e}",
              atol=atol)
        q, k, v = qkv.chunk(3, dim=-1)
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        err = check_close(f"K6f {(cb, cs, ch, cd)} {dtype}", fap.flash_attention_packed_cuda(q, k, v, ch),
                          fap._packed_heads_math(q, k, v, ch), atol)
        phase("k6f.check", shape=(cb, cs, ch * cd), heads=ch, dtype=str(dtype), max_abs_err=f"{err:.3e}",
              atol=atol)
    # Ragged lengths (one row, under a tile, past a tile) at head_dim 64
    # (head pairs; one head a group at an odd head count) and 128, rate 0
    # and 0.05, the same tolerances: the tensor maps zero-fill rows past S
    # inside each batch row, keys past S are masked in the last tile.
    for cb, cs, ch, cd in ((2, 1, 4, 64), (2, 63, 4, 64), (3, 200, 4, 64), (1, 1000, 2, 64), (2, 200, 3, 64),
                           (2, 1, 2, 128), (2, 63, 2, 128), (3, 200, 2, 128), (1, 1000, 2, 128)):
        for dtype, atol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-5)):
            errs = {}
            for rate in (0.0, DIT_DROPOUT):
                qkv = randn(cb, cs, 3 * ch * cd, dtype=dtype)
                sd = fap.draw_seeds(cb, ch, dev, gen) if rate else None
                kp = fap._philox_keep_mask(sd, cs, 1.0 - rate) if rate else None
                errs[f"k2_rate_{rate}"] = check_close(
                    f"K2 {(cb, cs, ch, cd)} {dtype} rate {rate}", fap.flash_attention_fused_cuda(qkv, ch, sd, rate),
                    fap._fused_fwd_math(qkv, ch, kp, 1.0 - rate), atol)
                q, k, v = (t.contiguous() for t in qkv.chunk(3, dim=-1))
                errs[f"k6f_rate_{rate}"] = check_close(
                    f"K6f {(cb, cs, ch, cd)} {dtype} rate {rate}", fap.flash_attention_packed_cuda(q, k, v, ch, sd, rate),
                    fap._packed_heads_math(q, k, v, ch, kp, 1.0 - rate), atol)
            phase("k2.ragged.check", batch=cb, seq=cs, heads=ch, head_dim=cd, dtype=str(dtype), atol=atol,
                  **{key: f"{err:.3e}" for key, err in errs.items()})
    qkv = randn(b, seq, 3 * heads * d, dtype=torch.bfloat16)
    # The library's attention on [B, H, S, D] q, k, v made contiguous
    # beforehand: the split copy K2 does without is not in its time.
    q4, k4, v4 = (t.contiguous() for t in fap.split_qkv_grouped(qkv, heads))
    attn_flops = 4 * b * heads * seq * seq * d
    attn_bytes = 4 * b * seq * heads * d * qkv.element_size()  # q, k, v read, out written
    library_attn_ms = time_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4), flush=flush)
    k2 = dict(
        name="flash_attention_fused", route="cuda", source="bsi_torch/ops/csrc/flash_attention_packed.cu",
        device_code="bsi_torch/ops/csrc/bh_attention_fwd_sm90.cuh",
        replaces="bsi_tpu/ops/flash_attention_packed.py:327", shape=list(qkv.shape), heads=heads,
        dtype="bfloat16",
        max_abs_err=check_close("K2 main", fap.flash_attention_fused_cuda(qkv, heads),
                                fap._fused_fwd_math(qkv, heads), 2e-2),
        ms=time_ms(lambda: fap.flash_attention_fused_cuda(qkv, heads), flush=flush),
        ms_with_lse=time_ms(lambda: fap.flash_attention_fused_cuda(qkv, heads, with_lse=True), flush=flush),
        plain_ms=time_ms(lambda: fap._fused_fwd_math(qkv, heads), flush=flush),
        library_ms=library_attn_ms, library="scaled_dot_product_attention, split copy not counted",
        **bound(attn_bytes, attn_flops, BF16_TENSOR_FLOPS),
    )
    phase("k2.time", **{key: k2[key] for key in ("ms", "ms_with_lse", "plain_ms", "library_ms", "bound_ms",
                                                 "bound_by")})
    kernels.append(k2)
    q, k, v = (t.contiguous() for t in qkv.chunk(3, dim=-1))
    k6f = dict(
        name="flash_attention_packed", route="cuda", source="bsi_torch/ops/csrc/flash_attention_packed.cu",
        device_code="bsi_torch/ops/csrc/bh_attention_fwd_sm90.cuh",
        replaces="bsi_tpu/ops/flash_attention_packed.py:428", shape=list(q.shape), heads=heads,
        dtype="bfloat16",
        max_abs_err=check_close("K6f main", fap.flash_attention_packed_cuda(q, k, v, heads),
                                fap._packed_heads_math(q, k, v, heads), 2e-2),
        ms=time_ms(lambda: fap.flash_attention_packed_cuda(q, k, v, heads), flush=flush),
        ms_with_lse=time_ms(lambda: fap.flash_attention_packed_cuda(q, k, v, heads, with_lse=True), flush=flush),
        plain_ms=time_ms(lambda: fap._packed_heads_math(q, k, v, heads), flush=flush),
        library_ms=library_attn_ms, library="scaled_dot_product_attention, split copy not counted",
        **bound(attn_bytes, attn_flops, BF16_TENSOR_FLOPS),
    )
    phase("k6f.time", **{key: k6f[key] for key in ("ms", "ms_with_lse", "plain_ms", "library_ms", "bound_ms",
                                                   "bound_by")})
    kernels.append(k6f)

    # ------------------------------------ K2 with dropout, K3, K6b vs twins
    # The mask first: the plain twin's kept fraction over the B*H*S^2 draws
    # against keep_prob.
    keep_prob = 1.0 - DIT_DROPOUT
    seeds = fap.draw_seeds(b, heads, dev, gen)
    keeps = fap._philox_keep_mask(seeds, seq, keep_prob)
    kept = keeps.double().mean().item()
    sigma = math.sqrt(keep_prob * (1.0 - keep_prob) / keeps.numel())
    if not abs(kept - keep_prob) <= 6 * sigma:
        raise AssertionError(f"kept fraction {kept} is not within 6 sigma ({6 * sigma:.3e}) of {keep_prob}")
    # f32 at 1e-5 also shows that K2's in-kernel masks agree with the twin's:
    # one differing keep bit moves an output by about p * v / keep_prob, ~4e-3.
    for dtype, atol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-5)):
        qkv = randn(b, seq, 3 * heads * d, dtype=dtype)
        err = check_close(f"K2 dropout {dtype}", fap.flash_attention_fused_cuda(qkv, heads, seeds, DIT_DROPOUT),
                          fap._fused_fwd_math(qkv, heads, keeps, keep_prob), atol)
        q, k, v = (t.contiguous() for t in qkv.chunk(3, dim=-1))
        err6 = check_close(f"K6f dropout {dtype}", fap.flash_attention_packed_cuda(q, k, v, heads, seeds, DIT_DROPOUT),
                           fap._packed_heads_math(q, k, v, heads, keeps, keep_prob), atol)
        phase("k2.dropout", shape=tuple(qkv.shape), heads=heads, dtype=str(dtype), rate=DIT_DROPOUT,
              max_abs_err=f"{err:.3e}", k6f_max_abs_err=f"{err6:.3e}", atol=atol, draws=keeps.numel(),
              kept_fraction=f"{kept:.7f}", six_sigma=f"{6 * sigma:.2e}")
    # The bf16 keep masks, bit for bit: keep_probe's inputs (q = 0, v[key]
    # the one-hot of column key mod D) make each output element the count of
    # kept keys key = c mod D over S keep_prob, so one flipped keep bit moves
    # it by 1 / (S keep_prob), 4.1e-3 (K2, K6f: S = 256) or 3.9e-3 (K5f at
    # rate 0.1), and bf16 rounding by < 1e-4: within 1e-3 of the plain
    # version on the Philox twin's mask and of the counts, at the main
    # paths' shapes.
    for rate in (DIT_DROPOUT, 0.1):
        keep_p = 1.0 - rate
        errs = {}
        for name, (pb, ph, ps, pd) in (("k2", (b, heads, seq, d)), ("k6f", (b, heads, seq, d)),
                                       ("k5f", (BATCH, 1, DATA16[0] * DATA16[1], UNET["dim"]))):
            q, k, v = keep_probe(pb, ph, ps, pd, torch.bfloat16, dev, gen)
            sd = fap.draw_seeds(pb, ph, dev, gen)
            kp = fap._philox_keep_mask(sd, ps, keep_p)
            if name == "k2":
                got = fap._split_heads(fap.flash_attention_fused_cuda(fap.merge_qkv_grouped(q, k, v), ph, sd, rate), ph)
            elif name == "k6f":
                got = fap._split_heads(fap.flash_attention_packed_cuda(
                    *(fap._merge_heads(t).contiguous() for t in (q, k, v)), ph, sd, rate), ph)
            else:
                got = fa.flash_attention_dropout_cuda(q, k, v, sd.reshape(-1), rate)
            want = fa._fwd_math(q, k, v, fa._scale(q), kp, keep_p)
            counts = keep_probe_counts(kp, pd, keep_p)
            errs[name] = check_close(f"{name} keep mask probe rate {rate}", got, want, 1e-3)
            errs[f"{name}_vs_counts"] = check_close(f"{name} keep mask probe rate {rate} vs counts", got, counts, 1e-3)
            del q, k, v, kp, got, want, counts
        phase("mask.probe", rate=rate, dtype="bfloat16", atol=1e-3, one_bit_moves=f"{1 / (seq * keep_p):.2e}",
              bit_for_bit=True, **{key: f"{err:.3e}" for key, err in errs.items()})
    # The backward keep masks, bit for bit: keep_probe_bwd's inputs (q = 0, k
    # the one-hot of key mod D, v ones, dO the one-hot of query mod D) make
    # dV count the kept queries of each key (read back by the key-major dkv
    # kernel) and dQ the kept keys of each query (drawn by the query-major
    # dq kernel). One flipped bit moves dV by 1 / (S keep_prob) >= 3.9e-3 and
    # dQ by scale / (S keep_prob) >= 3.8e-4 here; bf16 rounding moves them by
    # < 5e-5: dV within 1e-3, dQ within 1e-4 of the plain version on the
    # Philox twin's mask and of the counts, at the main paths' shapes.
    for rate in (DIT_DROPOUT, 0.1):
        keep_p = 1.0 - rate
        errs = {}
        for name, (pb, ph, ps, pd) in (("k3", (b, heads, seq, d)), ("k6b", (b, heads, seq, d)),
                                       ("k5b", (TRAIN_BATCH, 1, DATA16[0] * DATA16[1], UNET["dim"]))):
            q, k, v, do4 = keep_probe_bwd(pb, ph, ps, pd, torch.bfloat16, dev)
            sd = fap.draw_seeds(pb, ph, dev, gen)
            kp = fap._philox_keep_mask(sd, ps, keep_p)
            if name == "k3":
                dqkv = fap.flash_attention_fused_bwd_cuda(fap.merge_qkv_grouped(q, k, v), fap._merge_heads(do4), ph,
                                                          sd, rate)
                got = fap.split_qkv_grouped(dqkv, ph)
            elif name == "k6b":
                got = [fap._split_heads(t, ph) for t in fap.flash_attention_packed_bwd_cuda(
                    *(fap._merge_heads(t).contiguous() for t in (q, k, v, do4)), ph, sd, rate)]
            else:
                got = fa.flash_attention_bwd_cuda(q, k, v, do4, sd.reshape(-1), rate)
            want = fa._bwd_math(q, k, v, do4, fa._scale(q), kp, keep_p)
            counts = keep_probe_bwd_counts(kp, pd, keep_p, fa._scale(q))
            for part, tol, g_part, w_part, c_part in (("dq", 1e-4, got[0], want[0], counts[0]),
                                                      ("dv", 1e-3, got[2], want[2], counts[1])):
                errs[f"{name}_{part}"] = check_close(f"{name} bwd keep mask probe {part} rate {rate}", g_part, w_part, tol)
                errs[f"{name}_{part}_vs_counts"] = check_close(
                    f"{name} bwd keep mask probe {part} rate {rate} vs counts", g_part, c_part, tol)
            del q, k, v, do4, kp, got, want, counts
        phase("bwd.probe", rate=rate, dtype="bfloat16", atol_dq=1e-4, atol_dv=1e-3,
              dq_one_bit_moves=f"{d ** -0.5 / (seq * keep_p):.2e}",
              dv_one_bit_moves=f"{1 / (seq * keep_p):.2e}", bit_for_bit=True,
              **{key: f"{err:.3e}" for key, err in errs.items()})
    # K3 and K6b against the plain backward with the same mask, rate 0 and
    # 0.05, bf16 and f32: at DiT-L/2's shape, at head_dim 128 and 256, and at
    # ragged lengths (one row, under a tile, past a tile, three tiles). bf16
    # at head_dim 64 and 128 runs the Hopper body from K2's (K6f's) output
    # and statistics: given, as the train step gives them, and not given,
    # when the wrapper launches the forward for them. The two must be the
    # same bits, as must two launches, and K3's dqkv must be K6b's dq|dk|dv
    # interleaved. The statistics against the plain version's (f32 logits
    # from the same inputs, sums in another order): within 1e-4.
    for cb, cs, ch, cd in ((b, seq, heads, d), (2, 256, 2, 128), (4, 256, 4, 256), (2, 1, 4, 64), (2, 63, 4, 64),
                           (3, 200, 4, 64), (2, 384, 4, 64), (2, 1, 2, 128), (2, 63, 2, 128), (3, 200, 2, 128),
                           (2, 384, 2, 128), (2, 200, 2, 256)):
        for rate in (0.0, DIT_DROPOUT):
            for dtype in (torch.bfloat16, torch.float32):
                qkv = randn(cb, cs, 3 * ch * cd, dtype=dtype)
                g_out = randn(cb, cs, ch * cd, dtype=dtype)
                sd = fap.draw_seeds(cb, ch, dev, gen) if rate else None
                kp = fap._philox_keep_mask(sd, cs, 1.0 - rate) if rate else None
                what = f"{(cb, cs, ch, cd)} rate {rate} {dtype}"
                errs = {}
                want3 = fap._fused_bwd_math(qkv, g_out, ch, kp, 1.0 - rate)
                floor = s1_floor(cs, fap.split_qkv_grouped(want3, ch)[2], dtype)
                out, lse = fap.flash_attention_fused_cuda(qkv, ch, sd, rate, with_lse=True)
                if lse is not None:
                    errs["lse"] = check_close(f"K2 statistics {what}", lse, fap._fused_lse_math(qkv, ch), 1e-4)
                dqkv = fap.flash_attention_fused_bwd_cuda(qkv, g_out, ch, sd, rate, out=out, lse=lse)
                errs["k3"] = check_attn_bwd(f"K3 {what}", dqkv, want3, dtype, floor)
                if not (torch.equal(fap.flash_attention_fused_bwd_cuda(qkv, g_out, ch, sd, rate), dqkv) and torch.equal(
                        fap.flash_attention_fused_bwd_cuda(qkv, g_out, ch, sd, rate, out=out, lse=lse), dqkv)):
                    raise AssertionError(f"K3 {what}: launches with and without the statistics differ")
                q, k, v = (fap._merge_heads(t).contiguous() for t in fap.split_qkv_grouped(qkv, ch))
                out6, lse6 = fap.flash_attention_packed_cuda(q, k, v, ch, sd, rate, with_lse=True)
                grads = fap.flash_attention_packed_bwd_cuda(q, k, v, g_out, ch, sd, rate, out=out6, lse=lse6)
                errs["k6b"] = max(check_attn_bwd(f"K6b {part} {what}", a, w, dtype, floor) for part, a, w in zip(
                    "qkv", grads, fap._packed_heads_bwd_math(q, k, v, g_out, ch, kp, 1.0 - rate)))
                if not all(map(torch.equal, grads, fap.flash_attention_packed_bwd_cuda(q, k, v, g_out, ch, sd, rate))):
                    raise AssertionError(f"K6b {what}: launches with and without the statistics differ")
                if not torch.equal(dqkv, fap.merge_qkv_grouped(*(fap._split_heads(t, ch) for t in grads))):
                    raise AssertionError(f"K3 {what} is not K6b's gradients interleaved")
                phase("k3.check", shape=(cb, cs, 3 * ch * cd), heads=ch, head_dim=cd, dtype=str(dtype), rate=rate,
                      route="sm90" if lse is not None else "older",
                      tol=repr("2e-2 (bf16) or 1e-5 (f32) of the largest element (at S = 1 of dV's); lse 1e-4"),
                      **{key: f"{err:.3e}" for key, err in errs.items()}, with_and_without_stats_bit_for_bit=True,
                      two_launches_bit_for_bit=True, k3_is_k6b_interleaved_bit_for_bit=True)
                del qkv, g_out, out, lse, dqkv, q, k, v, out6, lse6, grads, kp, want3
    # Times at the train step's shapes, bf16, rate 0.05 (the train step's);
    # the plain versions draw their mask with the Philox twin inside the time.
    qkv = randn(b, seq, 3 * heads * d, dtype=torch.bfloat16)
    g_out = randn(b, seq, heads * d, dtype=torch.bfloat16)
    q4, k4, v4 = (t.contiguous() for t in fap.split_qkv_grouped(qkv, heads))
    plain_keeps = lambda: fap._philox_keep_mask(seeds, seq, keep_prob)
    k2["at_rate_0_05"] = dict(
        max_abs_err=check_close("K2 dropout main", fap.flash_attention_fused_cuda(qkv, heads, seeds, DIT_DROPOUT),
                                fap._fused_fwd_math(qkv, heads, keeps, keep_prob), 2e-2),
        ms=time_ms(lambda: fap.flash_attention_fused_cuda(qkv, heads, seeds, DIT_DROPOUT), flush=flush),
        plain_ms=time_ms(lambda: fap._fused_fwd_math(qkv, heads, plain_keeps(), keep_prob), reps=5, flush=flush),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4, dropout_p=DIT_DROPOUT), flush=flush),
        library="scaled_dot_product_attention with dropout_p 0.05, split copy not counted",
        **bound(attn_bytes + seeds.numel() * 4, attn_flops, BF16_TENSOR_FLOPS),
    )
    # Philox4x32-10 calls worked out from the shape (one per 4 keep bits; the
    # backward draws the mask once, in its dq kernel), printed beside the
    # bound and not added to it.
    philox_fwd = b * heads * seq * seq // 4
    phase("k2.time", rate=DIT_DROPOUT, philox_calls_from_shape=philox_fwd, **{
        key: k2["at_rate_0_05"][key] for key in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")})
    # The library's backward: SDPA's on [B, H, S, D], graph kept, timed from
    # a profile at the end (library_backwards).
    def sdpa_library_bwd(shape, dropout_p):
        def make():
            leaves = [randn(*shape, dtype=torch.bfloat16).requires_grad_() for _ in range(3)]
            grad = randn(*shape, dtype=torch.bfloat16)
            out = F.scaled_dot_product_attention(*leaves, dropout_p=dropout_p)
            return lambda: torch.autograd.grad(out, leaves, grad, retain_graph=True)
        return make

    # bytes: q, k, v and dO read once, dq, dk, dv written once; products
    # 10*B*H*S^2*D (Q K^T, dO V^T, dV, dQ, dK). The forward's output and
    # statistics, which the kernels read, are not needed for the function
    # and not counted. `ms` is the time with them given, as the train step
    # calls the kernel; `ms_standalone` without, the forward launched first.
    bwd_bytes = 7 * b * seq * heads * d * qkv.element_size() + seeds.numel() * 4
    bwd_flops = 10 * b * heads * seq * seq * d
    stats = fap.flash_attention_fused_cuda(qkv, heads, seeds, DIT_DROPOUT, with_lse=True)
    stats0 = fap.flash_attention_fused_cuda(qkv, heads, with_lse=True)
    k3 = dict(
        name="flash_attention_fused_bwd", route="cuda", source="bsi_torch/ops/csrc/flash_attention_packed_bwd.cu",
        device_code="bsi_torch/ops/csrc/bh_attention_bwd_sm90.cuh",
        replaces="bsi_tpu/ops/flash_attention_packed.py:377", shape=list(qkv.shape), heads=heads,
        dtype="bfloat16", rate=DIT_DROPOUT,
        max_abs_err=check_attn_bwd("K3 main", fap.flash_attention_fused_bwd_cuda(
            qkv, g_out, heads, seeds, DIT_DROPOUT, out=stats[0], lse=stats[1]),
            fap._fused_bwd_math(qkv, g_out, heads, keeps, keep_prob), torch.bfloat16),
        ms=time_ms(lambda: fap.flash_attention_fused_bwd_cuda(qkv, g_out, heads, seeds, DIT_DROPOUT, out=stats[0],
                                                              lse=stats[1]), flush=flush),
        ms_standalone=time_ms(lambda: fap.flash_attention_fused_bwd_cuda(qkv, g_out, heads, seeds, DIT_DROPOUT),
                              flush=flush),
        plain_ms=time_ms(lambda: fap._fused_bwd_math(qkv, g_out, heads, plain_keeps(), keep_prob), reps=5,
                         flush=flush),
        library="scaled_dot_product_attention backward, dropout_p 0.05, [B, H, S, D]",
        at_rate_0=dict(
            ms=time_ms(lambda: fap.flash_attention_fused_bwd_cuda(qkv, g_out, heads, out=stats0[0], lse=stats0[1]),
                       flush=flush),
            ms_standalone=time_ms(lambda: fap.flash_attention_fused_bwd_cuda(qkv, g_out, heads), flush=flush),
            library="scaled_dot_product_attention backward, dropout_p 0",
            **bound(bwd_bytes - seeds.numel() * 4, bwd_flops, BF16_TENSOR_FLOPS)),
        **bound(bwd_bytes, bwd_flops, BF16_TENSOR_FLOPS),
    )
    phase("k3.time", **{key: k3[key] for key in ("ms", "ms_standalone", "plain_ms", "bound_ms", "bound_by")},
          ms_at_rate_0=k3["at_rate_0"]["ms"], ms_standalone_at_rate_0=k3["at_rate_0"]["ms_standalone"],
          philox_calls_from_shape=philox_fwd)
    kernels.append(k3)
    library_backwards.append(("k3", k3, sdpa_library_bwd((b, heads, seq, d), DIT_DROPOUT)))
    library_backwards.append(("k3 at rate 0", k3["at_rate_0"], sdpa_library_bwd((b, heads, seq, d), 0.0)))
    # The kernels' own device time, from a profile as the library's is taken.
    k3_call = functools.partial(fap.flash_attention_fused_bwd_cuda, qkv, g_out, heads)
    device_times.append(("k3", k3, functools.partial(k3_call, seeds, DIT_DROPOUT, out=stats[0], lse=stats[1])))
    device_times.append(("k3 at rate 0", k3["at_rate_0"], functools.partial(k3_call, out=stats0[0], lse=stats0[1])))
    q, k, v = (fap._merge_heads(t).contiguous() for t in (q4, k4, v4))
    stats6 = fap.flash_attention_packed_cuda(q, k, v, heads, seeds, DIT_DROPOUT, with_lse=True)
    k6b = dict(
        name="flash_attention_packed_bwd", route="cuda", source="bsi_torch/ops/csrc/flash_attention_packed_bwd.cu",
        device_code="bsi_torch/ops/csrc/bh_attention_bwd_sm90.cuh",
        replaces="bsi_tpu/ops/flash_attention_packed.py:462", shape=list(q.shape), heads=heads,
        dtype="bfloat16", rate=DIT_DROPOUT,
        max_abs_err=max(check_attn_bwd("K6b main", a, w, torch.bfloat16) for a, w in zip(
            fap.flash_attention_packed_bwd_cuda(q, k, v, g_out, heads, seeds, DIT_DROPOUT, out=stats6[0],
                                                lse=stats6[1]),
            fap._packed_heads_bwd_math(q, k, v, g_out, heads, keeps, keep_prob))),
        ms=time_ms(lambda: fap.flash_attention_packed_bwd_cuda(q, k, v, g_out, heads, seeds, DIT_DROPOUT,
                                                               out=stats6[0], lse=stats6[1]), flush=flush),
        ms_standalone=time_ms(lambda: fap.flash_attention_packed_bwd_cuda(q, k, v, g_out, heads, seeds, DIT_DROPOUT),
                              flush=flush),
        plain_ms=time_ms(lambda: fap._packed_heads_bwd_math(q, k, v, g_out, heads, plain_keeps(), keep_prob),
                         reps=5, flush=flush),
        library="scaled_dot_product_attention backward, dropout_p 0.05, [B, H, S, D]",
        **bound(bwd_bytes, bwd_flops, BF16_TENSOR_FLOPS),
    )
    phase("k6b.time", **{key: k6b[key] for key in ("ms", "ms_standalone", "plain_ms", "bound_ms", "bound_by")},
          philox_calls_from_shape=philox_fwd)
    kernels.append(k6b)
    library_backwards.append(("k6b", k6b, sdpa_library_bwd((b, heads, seq, d), DIT_DROPOUT)))
    device_times.append(("k6b", k6b, functools.partial(fap.flash_attention_packed_bwd_cuda, q, k, v, g_out, heads,
                                                       seeds, DIT_DROPOUT, out=stats6[0], lse=stats6[1])))
    del qkv, q4, k4, v4, g_out, keeps, seeds

    # ------------------------------------------------------ K4f vs its twin
    # shift and scale are column slices of one adaLN output [B, 6 D], as the
    # DiT block passes them. bf16: f32 statistics summed in another order can
    # move the final rounding by one bf16 ulp (2^-7 relative), beside 2e-2.
    for dtype, atol, rtol in ((torch.bfloat16, 2e-2, 2**-7), (torch.float32, 1e-5, 0.0)):
        x = randn(b, seq, dim, dtype=dtype) * 2.0 + 0.5
        mod = randn(b, 6 * dim, dtype=dtype)
        shift, scale = mod[:, :dim], mod[:, dim:2 * dim]
        err = check_close(f"K4f {dtype}", lm.layernorm_modulate_cuda(x, shift, scale),
                          lm._reference_math(x, shift, scale), atol, rtol)
        phase("k4f.check", shape=(b, seq, dim), dtype=str(dtype), shift_stride=shift.stride(),
              max_abs_err=f"{err:.3e}", atol=atol, rtol=rtol)
    x = randn(b, seq, dim, dtype=torch.bfloat16)
    mod = randn(b, 6 * dim, dtype=torch.bfloat16)
    shift, scale = mod[:, :dim], mod[:, dim:2 * dim]
    k4f = dict(
        name="layernorm_modulate_fwd", route="triton", source="bsi_torch/ops/ln_modulate.py",
        replaces="bsi_tpu/ops/ln_modulate.py:95", shape=[b, seq, dim], dtype="bfloat16",
        max_abs_err=check_close("K4f main", lm.layernorm_modulate_cuda(x, shift, scale),
                                lm._reference_math(x, shift, scale), 2e-2, 2**-7),
        ms=time_ms(lambda: lm.layernorm_modulate_cuda(x, shift, scale), flush=flush),
        plain_ms=time_ms(lambda: lm._reference_math(x, shift, scale), flush=flush),
        library_ms=time_ms(lambda: shift[:, None, :] + (scale[:, None, :] + 1.0) * F.layer_norm(
            x, (dim,), eps=1e-6), flush=flush),
        library="layer_norm, then the modulate expression",
        **bound(2 * x.numel() * x.element_size() + 2 * b * dim * x.element_size(),
                K4F_OPS_PER_ELEM * x.numel(), F32_FLOPS),
    )
    phase("k4f.time", **{key: k4f[key] for key in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")})
    kernels.append(k4f)

    # ------------------------------------------------------ K4b vs its twin
    # The plan of each shape K4b checks (csrc/ln_modulate.cu: an image's
    # rows in tiles of 7 through a TMA ring, one warp a row, a cluster of
    # CTAs an image; the plain body for rows TMA cannot take), with how many
    # of its clusters the card holds at once.
    k4b_shapes = (((b, seq, dim), torch.bfloat16), ((b, seq, dim), torch.float32),
                  ((2, 300, 256), torch.bfloat16), ((2, 5, 100), torch.bfloat16))
    for shape, dtype in k4b_shapes:
        plan = lm.plan(*shape, dtype)
        phase("k4b.plan", shape=shape, dtype=str(dtype), tma=plan.tma, lane_vectors=plan.lane_vectors,
              rows=plan.rows, tiles=plan.tiles, stages=plan.stages, cluster=plan.cluster,
              ctas=shape[0] * plan.cluster, smem_bytes=plan.smem_bytes,
              clusters_held=lm.max_active_clusters(plan, shape[2], dtype))
    # scale is a column slice of the adaLN output, as the DiT block passes it;
    # two launches the same bits at DiT-L/2's shape and at ragged ones (300
    # rows, not a whole number of tiles; 200-byte rows, the plain body).
    for shape, dtype in k4b_shapes:
        x = randn(*shape, dtype=dtype) * 2.0 + 0.5
        g_out = randn(*shape, dtype=dtype)
        mod = randn(shape[0], 6 * shape[2], dtype=dtype)
        scale = mod[:, shape[2]:2 * shape[2]]
        got = lm.layernorm_modulate_bwd_cuda(x, scale, g_out)
        want = lm._bwd_math(x, scale, g_out)
        torch.cuda.synchronize()
        errs = check_bwd(f"K4b {shape} {dtype}", got, want, dtype, parts=("dx", "dshift", "dscale"))
        if not all(map(torch.equal, lm.layernorm_modulate_bwd_cuda(x, scale, g_out), got)):
            raise AssertionError(f"K4b {shape} {dtype}: two launches differ")
        phase("k4b.check", shape=shape, dtype=str(dtype), scale_stride=scale.stride(),
              max_abs_err_dx=f"{errs[0]:.3e}", max_abs_err_dshift=f"{errs[1]:.3e}",
              max_abs_err_dscale=f"{errs[2]:.3e}", two_launches_bit_for_bit=True)
    x = randn(b, seq, dim, dtype=torch.bfloat16)
    g_out = randn(b, seq, dim, dtype=torch.bfloat16)
    mod = randn(b, 6 * dim, dtype=torch.bfloat16)
    shift, scale = mod[:, :dim], mod[:, dim:2 * dim]
    k4b = dict(
        name="layernorm_modulate_bwd", route="cuda", source="bsi_torch/ops/csrc/ln_modulate.cu",
        device_code="bsi_torch/ops/csrc/tma_sm90.cuh", replaces="bsi_tpu/ops/ln_modulate.py:110",
        shape=[b, seq, dim], dtype="bfloat16",
        max_abs_err=check_bwd("K4b main", lm.layernorm_modulate_bwd_cuda(x, scale, g_out),
                              lm._bwd_math(x, scale, g_out), torch.bfloat16, parts=("dx", "dshift", "dscale"))[0],
        ms=time_ms(lambda: lm.layernorm_modulate_bwd_cuda(x, scale, g_out), flush=flush),
        plain_ms=time_ms(lambda: lm._bwd_math(x, scale, g_out), flush=flush),
        library="autograd through layer_norm and the modulate expression, graph kept",
        **bound(3 * x.numel() * x.element_size() + 3 * b * dim * x.element_size(),
                K4B_OPS_PER_ELEM * x.numel(), F32_FLOPS),
    )
    phase("k4b.time", **{key: k4b[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by")})
    kernels.append(k4b)
    # the kernel alone, one launch a call
    device_times.append(("k4b", k4b, functools.partial(lm.layernorm_modulate_bwd_cuda, x, scale, g_out)))
    del mod, shift, scale, g_out

    # -------------------------- K2, K3, K4f, K4b at the ImageNet recipes' shapes
    # The trainer runs DiT-L/2 (and DiT-L/4: the same 256 tokens) in f32: a
    # train micro-batch of 64 (K2 at rate 0.05, K3, K4f, K4b), validation
    # batches of 512 (128 where cut) and the plots' 64, 16 and 120 (K2 at
    # rate 0, K4f). K2
    # and K4f within 1e-5 of their twins, the masks pinned by the Philox
    # twin; K3 within 1e-5 of its largest element; K4b as [k4b.check] (dx
    # 1e-5, dshift and dscale 1e-4 of their largest element).
    f32 = torch.float32
    for cb, rate in ((IMAGENET_MICRO, DIT_DROPOUT), (IMAGENET_MICRO, 0.0), (IMAGENET_EVAL_BATCH, 0.0), (128, 0.0),
                     (120, 0.0), (16, 0.0)):
        qkv = randn(cb, seq, 3 * heads * d)
        sd = fap.draw_seeds(cb, heads, dev, gen) if rate else None
        kp = fap._philox_keep_mask(sd, seq, 1.0 - rate) if rate else None
        err = check_close(f"K2 f32 {cb} rate {rate}", fap.flash_attention_fused_cuda(qkv, heads, sd, rate),
                          fap._fused_fwd_math(qkv, heads, kp, 1.0 - rate), 1e-5)
        phase("k2.check", recipe="imagenet32", shape=(cb, seq, 3 * heads * d), heads=heads, dtype="float32",
              rate=rate, max_abs_err=f"{err:.3e}", atol=1e-5)
        del qkv, kp
    qkv = randn(IMAGENET_MICRO, seq, 3 * heads * d)
    g_out = randn(IMAGENET_MICRO, seq, heads * d)
    sd = fap.draw_seeds(IMAGENET_MICRO, heads, dev, gen)
    kp = fap._philox_keep_mask(sd, seq, keep_prob)
    want3 = fap._fused_bwd_math(qkv, g_out, heads, kp, keep_prob)
    err = check_attn_bwd("K3 f32 trainer", fap.flash_attention_fused_bwd_cuda(qkv, g_out, heads, sd, DIT_DROPOUT),
                         want3, f32)
    phase("k3.check", recipe="imagenet32", shape=tuple(qkv.shape), heads=heads, dtype="float32", rate=DIT_DROPOUT,
          max_abs_err=f"{err:.3e}", atol=f"{1e-5 * want3.abs().max().item():.3e}", tol="1e-5 of the largest element")
    del qkv, g_out, kp, want3
    for cb in (IMAGENET_MICRO, IMAGENET_EVAL_BATCH, 128, 120, 16):
        x4 = randn(cb, seq, dim) * 2.0 + 0.5
        mod4 = randn(cb, 6 * dim)
        shift4, scale4 = mod4[:, :dim], mod4[:, dim:2 * dim]
        errs = {"k4f": check_close(f"K4f f32 {cb}", lm.layernorm_modulate_cuda(x4, shift4, scale4),
                                   lm._reference_math(x4, shift4, scale4), 1e-5)}
        if cb == IMAGENET_MICRO:
            g4 = randn(cb, seq, dim)
            errs.update(zip(("k4b_dx", "k4b_dshift", "k4b_dscale"), check_bwd(
                f"K4b f32 {cb}", lm.layernorm_modulate_bwd_cuda(x4, scale4, g4), lm._bwd_math(x4, scale4, g4), f32,
                parts=("dx", "dshift", "dscale"))))
            del g4
        phase("k4.check", recipe="imagenet32", shape=(cb, seq, dim), dtype="float32",
              **{key: f"{err:.3e}" for key, err in errs.items()},
              tol="k4f, k4b dx 1e-5; k4b dshift, dscale 1e-4 of the largest element")
        del x4, mod4, shift4, scale4

    # ------------- K2, K3, K4f, K4b at the pipeline's and the b512 row's shapes
    # The pipeline runs the kernels on microbatches: [pipeline.gloo2] on
    # PIPE_BATCH / PIPE_MICRO rows, [pipeline.launch] on PARALLEL_BATCH /
    # PIPE_MICRO (f32, K2 and K3 at rate 0.05 in training, K2 at 0 in
    # validation); [dit.b512] on micro-batches of b512_micro in bf16. Each
    # against its twin with the tolerances above.
    for cb, dtype in ((PIPE_BATCH // PIPE_MICRO, f32), (PARALLEL_BATCH // PIPE_MICRO, f32),
                      (b512_micro, torch.bfloat16)):
        bf16 = dtype == torch.bfloat16
        errs = {}
        for rate in (DIT_DROPOUT, 0.0):
            qkv = randn(cb, seq, 3 * heads * d, dtype=dtype)
            sd = fap.draw_seeds(cb, heads, dev, gen) if rate else None
            kp = fap._philox_keep_mask(sd, seq, 1.0 - rate) if rate else None
            errs[f"k2_rate_{rate}"] = check_close(f"K2 {dtype} {cb} rate {rate}",
                                                  fap.flash_attention_fused_cuda(qkv, heads, sd, rate),
                                                  fap._fused_fwd_math(qkv, heads, kp, 1.0 - rate),
                                                  2e-2 if bf16 else 1e-5)
            if rate:
                g_out = randn(cb, seq, heads * d, dtype=dtype)
                errs["k3"] = check_attn_bwd(f"K3 {dtype} {cb}", fap.flash_attention_fused_bwd_cuda(
                    qkv, g_out, heads, sd, rate), fap._fused_bwd_math(qkv, g_out, heads, kp, 1.0 - rate), dtype)
                del g_out
            del qkv, kp
        x4 = randn(cb, seq, dim, dtype=dtype) * 2.0 + 0.5
        mod4 = randn(cb, 6 * dim, dtype=dtype)
        shift4, scale4 = mod4[:, :dim], mod4[:, dim:2 * dim]
        g4 = randn(cb, seq, dim, dtype=dtype)
        errs["k4f"] = check_close(f"K4f {dtype} {cb}", lm.layernorm_modulate_cuda(x4, shift4, scale4),
                                  lm._reference_math(x4, shift4, scale4), *((2e-2, 2**-7) if bf16 else (1e-5, 0.0)))
        errs.update(zip(("k4b_dx", "k4b_dshift", "k4b_dscale"), check_bwd(
            f"K4b {dtype} {cb}", lm.layernorm_modulate_bwd_cuda(x4, scale4, g4), lm._bwd_math(x4, scale4, g4), dtype,
            parts=("dx", "dshift", "dscale"))))
        phase("pipeline.shapes", path="[dit.b512]" if bf16 else "[pipeline.gloo2]" if cb == PIPE_BATCH // PIPE_MICRO
              else "[pipeline.launch]", rows=cb, seq=seq, dtype=str(dtype),
              **{key: f"{err:.3e}" for key, err in errs.items()},
              tol="as [k2.check], [k3.check], [k4f.check], [k4b.check] for the dtype")
        del x4, mod4, shift4, scale4, g4

    # [parallel.shards]: the DiT's kernels at the local shapes of TP and SP
    parallel_shards(dict(k2=k2, k3=k3, k4f=k4f, k4b=k4b), randn, dev, gen, flush)

    def ln_library_bwd(b=b, seq=seq, dim=dim):
        x_lib = randn(b, seq, dim, dtype=torch.bfloat16).requires_grad_()
        g_lib = randn(b, seq, dim, dtype=torch.bfloat16)
        mod_lib = randn(b, 6 * dim, dtype=torch.bfloat16)
        shift_lib, scale_lib = (t.clone().requires_grad_() for t in (mod_lib[:, :dim], mod_lib[:, dim:2 * dim]))
        out_lib = shift_lib[:, None, :] + (scale_lib[:, None, :] + 1.0) * F.layer_norm(x_lib, (dim,), eps=1e-6)
        return lambda: torch.autograd.grad(out_lib, (x_lib, shift_lib, scale_lib), g_lib, retain_graph=True)

    library_backwards.append(("k4b", k4b, ln_library_bwd))

    # ---------------------------------------------- K5f, K5b vs their twins
    # [B, H, S, D] at the 16x16 UNet's shapes (one head of 128 over S = 256
    # pixels: sampling b64 bf16, training b128 bf16, eval b64 f32), then other
    # head dims and lengths, each at rate 0 and 0.1. bf16 within 2e-2 (the
    # forward, as K2's) or 2e-2 of the largest element (the gradients, as
    # K3's); f32 within 1e-5, which at rate 0.1 pins the in-kernel keep masks
    # to the Philox twin of the flat [B*H] seeds. K5b as K3 (above): bf16 at
    # head_dim 64 and 128 from K5f's output and statistics, given and not
    # given, the same bits either way and from two launches.
    s16, d16 = DATA16[0] * DATA16[1], UNET["dim"]
    for (cb, ch, cs, cd), dtype in [
        ((BATCH, 1, s16, d16), torch.bfloat16),
        ((TRAIN_BATCH, 1, s16, d16), torch.bfloat16),
        ((EVAL_BATCH, 1, s16, d16), torch.float32),
        ((4, 2, 128, 64), torch.bfloat16),
        ((4, 2, 128, 64), torch.float32),
        ((2, 2, 384, 256), torch.bfloat16),
        ((2, 2, 384, 256), torch.float32),
        ((2, 2, 512, 128), torch.float32),
        ((3, 1, 200, 128), torch.bfloat16),
        ((3, 1, 200, 128), torch.float32),
        ((2, 1, 1, 128), torch.bfloat16),
        ((2, 1, 1, 128), torch.float32),
        ((2, 2, 63, 64), torch.bfloat16),
        ((2, 2, 63, 64), torch.float32),
        ((2, 1, 384, 128), torch.bfloat16),
        ((3, 2, 200, 64), torch.bfloat16),
    ]:
        for rate in (0.0, K5_RATE):
            q, k, v, g_out = (randn(cb, ch, cs, cd, dtype=dtype) for _ in range(4))
            sd = fap.draw_seeds(cb, ch, dev, gen).reshape(-1) if rate else None
            keep = fa._keep(q, sd, rate)
            atol = 2e-2 if dtype == torch.bfloat16 else 1e-5
            err = check_close(f"K5f {(cb, ch, cs, cd)} {dtype} rate {rate}",
                              fa.flash_attention_dropout_cuda(q, k, v, sd, rate),
                              fa._fwd_math(q, k, v, fa._scale(q), keep, 1.0 - rate), atol)
            phase("k5f.check", shape=(cb, ch, cs, cd), dtype=str(dtype), rate=rate, max_abs_err=f"{err:.3e}",
                  atol=atol)
            want = fa._bwd_math(q, k, v, g_out, fa._scale(q), keep, 1.0 - rate)
            out, lse = fa.flash_attention_dropout_cuda(q, k, v, sd, rate, with_lse=True)
            grads = fa.flash_attention_bwd_cuda(q, k, v, g_out, sd, rate, out=out, lse=lse)
            floor = s1_floor(cs, want[2], dtype)
            errs = [check_attn_bwd(f"K5b d{part} {(cb, ch, cs, cd)} {dtype} rate {rate}", got, w.to(dtype), dtype,
                                   floor)
                    for part, got, w in zip("qkv", grads, want)]
            for again in (fa.flash_attention_bwd_cuda(q, k, v, g_out, sd, rate),
                          fa.flash_attention_bwd_cuda(q, k, v, g_out, sd, rate, out=out, lse=lse)):
                if not all(map(torch.equal, again, grads)):
                    raise AssertionError(f"K5b {(cb, ch, cs, cd)} {dtype} rate {rate}: launches differ")
            lse_err = "none written"
            if lse is not None:
                lse_err = f"{check_close('K5f statistics', lse, fa._lse_math(q, k, fa._scale(q)), 1e-4):.3e}"
            phase("k5b.check", shape=(cb, ch, cs, cd), dtype=str(dtype), rate=rate,
                  route="sm90" if lse is not None else "older", max_abs_err_dq=f"{errs[0]:.3e}",
                  max_abs_err_dk=f"{errs[1]:.3e}", max_abs_err_dv=f"{errs[2]:.3e}", lse_max_abs_err=lse_err,
                  tol=repr(f"{atol} of the largest element (at S = 1 of dV's); lse 1e-4"),
                  with_and_without_stats_bit_for_bit=True,
                  two_launches_bit_for_bit=True)
            del q, k, v, g_out, keep, want, out, lse, grads
    # Times: K5f at the sampling shape, bf16, rate 0 (and 0.1, and f32 at the
    # eval shape); K5b at the train shape, bf16, rate 0 (and 0.1). The plain
    # versions with dropout draw their mask with the Philox twin in the time.
    attn16_flops = lambda n: 4 * n * s16 * s16 * d16
    attn16_bytes = lambda n, size: 4 * n * s16 * d16 * size  # q, k, v read, out written
    q, k, v = (randn(BATCH, 1, s16, d16, dtype=torch.bfloat16) for _ in range(3))
    sd = fap.draw_seeds(BATCH, 1, dev, gen).reshape(-1)
    keep = fa._keep(q, sd, K5_RATE)
    k5f = dict(
        name="flash_attention_dropout", route="cuda", source="bsi_torch/ops/csrc/flash_attention_dropout.cu",
        device_code="bsi_torch/ops/csrc/bh_attention_fwd_sm90.cuh",
        replaces="bsi_tpu/ops/flash_attention.py:273", shape=[BATCH, 1, s16, d16], dtype="bfloat16", rate=0.0,
        max_abs_err=check_close("K5f main", fa.flash_attention_dropout_cuda(q, k, v),
                                fa._fwd_math(q, k, v, fa._scale(q)), 2e-2),
        ms=time_ms(lambda: fa.flash_attention_dropout_cuda(q, k, v), flush=flush),
        ms_with_lse=time_ms(lambda: fa.flash_attention_dropout_cuda(q, k, v, with_lse=True), flush=flush),
        plain_ms=time_ms(lambda: fa._fwd_math(q, k, v, fa._scale(q)).to(q.dtype), flush=flush),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(q, k, v), flush=flush),
        library="scaled_dot_product_attention",
        **bound(attn16_bytes(BATCH, 2), attn16_flops(BATCH), BF16_TENSOR_FLOPS),
    )
    k5f["at_rate_0_1"] = dict(
        max_abs_err=check_close("K5f dropout main", fa.flash_attention_dropout_cuda(q, k, v, sd, K5_RATE),
                                fa._fwd_math(q, k, v, fa._scale(q), keep, 1.0 - K5_RATE), 2e-2),
        ms=time_ms(lambda: fa.flash_attention_dropout_cuda(q, k, v, sd, K5_RATE), flush=flush),
        plain_ms=time_ms(lambda: fa._fwd_math(q, k, v, fa._scale(q), fa._keep(q, sd, K5_RATE), 1.0 - K5_RATE).to(
            q.dtype), reps=5, flush=flush),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(q, k, v, dropout_p=K5_RATE), flush=flush),
        library="scaled_dot_product_attention, dropout_p 0.1",
        **bound(attn16_bytes(BATCH, 2) + sd.numel() * 4, attn16_flops(BATCH), BF16_TENSOR_FLOPS),
    )
    q32, k32, v32 = (randn(EVAL_BATCH, 1, s16, d16) for _ in range(3))
    sdpa32 = F.scaled_dot_product_attention(q32, k32, v32)
    sdpa32_err = (sdpa32 - fa._fwd_math(q32, k32, v32, fa._scale(q32))).abs().max().item()
    k5f["at_f32_eval_shape"] = dict(
        shape=[EVAL_BATCH, 1, s16, d16],
        library_max_abs_err=sdpa32_err, library_within_1e_5=sdpa32_err <= 1e-5,
        max_abs_err=check_close("K5f f32 main", fa.flash_attention_dropout_cuda(q32, k32, v32),
                                fa._fwd_math(q32, k32, v32, fa._scale(q32)), 1e-5),
        ms=time_ms(lambda: fa.flash_attention_dropout_cuda(q32, k32, v32), flush=flush),
        plain_ms=time_ms(lambda: fa._fwd_math(q32, k32, v32, fa._scale(q32)), flush=flush),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(q32, k32, v32), flush=flush),
        library="scaled_dot_product_attention, f32, TF32 off",
        **bound(attn16_bytes(EVAL_BATCH, 4), attn16_flops(EVAL_BATCH), F32_FLOPS),
    )
    phase("k5f.time", **{key: k5f[key] for key in ("ms", "ms_with_lse", "plain_ms", "library_ms", "bound_ms",
                                                   "bound_by")},
          rate_0_1={key: k5f["at_rate_0_1"][key] for key in ("ms", "plain_ms", "library_ms", "bound_ms")},
          f32_eval_shape={key: k5f["at_f32_eval_shape"][key] for key in ("ms", "plain_ms", "library_ms", "bound_ms",
                                                                         "bound_by", "library_max_abs_err")})
    kernels.append(k5f)
    del q, k, v, q32, k32, v32, keep
    q, k, v, g_out = (randn(TRAIN_BATCH, 1, s16, d16, dtype=torch.bfloat16) for _ in range(4))
    sd = fap.draw_seeds(TRAIN_BATCH, 1, dev, gen).reshape(-1)
    # bytes: q, k, v and dO read once, dq, dk, dv written once; products
    # 10*B*H*S^2*D (Q K^T, dO V^T, dV, dQ, dK)
    k5b_bytes = 7 * TRAIN_BATCH * s16 * d16 * 2
    k5b_flops = 10 * TRAIN_BATCH * s16 * s16 * d16
    stats = fa.flash_attention_dropout_cuda(q, k, v, with_lse=True)
    stats1 = fa.flash_attention_dropout_cuda(q, k, v, sd, K5_RATE, with_lse=True)
    k5b = dict(
        name="flash_attention_bwd", route="cuda", source="bsi_torch/ops/csrc/flash_attention_bwd.cu",
        device_code="bsi_torch/ops/csrc/bh_attention_bwd_sm90.cuh",
        replaces="bsi_tpu/ops/flash_attention.py:311", shape=[TRAIN_BATCH, 1, s16, d16], dtype="bfloat16", rate=0.0,
        max_abs_err=max(check_attn_bwd(f"K5b main d{part}", got, w.to(torch.bfloat16), torch.bfloat16)
                        for part, got, w in zip("qkv", fa.flash_attention_bwd_cuda(q, k, v, g_out, out=stats[0],
                                                                                   lse=stats[1]),
                                                fa._bwd_math(q, k, v, g_out, fa._scale(q)))),
        ms=time_ms(lambda: fa.flash_attention_bwd_cuda(q, k, v, g_out, out=stats[0], lse=stats[1]), flush=flush),
        ms_standalone=time_ms(lambda: fa.flash_attention_bwd_cuda(q, k, v, g_out), flush=flush),
        plain_ms=time_ms(lambda: fa._bwd_math(q, k, v, g_out, fa._scale(q)), flush=flush),
        library="scaled_dot_product_attention backward",
        at_rate_0_1=dict(
            ms=time_ms(lambda: fa.flash_attention_bwd_cuda(q, k, v, g_out, sd, K5_RATE, out=stats1[0], lse=stats1[1]),
                       flush=flush),
            ms_standalone=time_ms(lambda: fa.flash_attention_bwd_cuda(q, k, v, g_out, sd, K5_RATE), flush=flush),
            **bound(k5b_bytes + sd.numel() * 4, k5b_flops, BF16_TENSOR_FLOPS)),
        **bound(k5b_bytes, k5b_flops, BF16_TENSOR_FLOPS),
    )
    phase("k5b.time", **{key: k5b[key] for key in ("ms", "ms_standalone", "plain_ms", "bound_ms", "bound_by")},
          ms_at_rate_0_1=k5b["at_rate_0_1"]["ms"], ms_standalone_at_rate_0_1=k5b["at_rate_0_1"]["ms_standalone"])
    kernels.append(k5b)
    library_backwards.append(("k5b", k5b, sdpa_library_bwd((TRAIN_BATCH, 1, s16, d16), 0.0)))
    k5b_call = functools.partial(fa.flash_attention_bwd_cuda, q, k, v, g_out)
    device_times.append(("k5b", k5b, functools.partial(k5b_call, out=stats[0], lse=stats[1])))
    device_times.append(("k5b at rate 0.1", k5b["at_rate_0_1"], functools.partial(
        k5b_call, sd, K5_RATE, out=stats1[0], lse=stats1[1])))

    # --------------------------------------- whole model, card against CPU
    model_cpu = build_model("unet", "cpu", dtype=None, seed=SEED)
    weights = model_cpu.state_dict()
    model_f32 = build_model("unet", dev, dtype=None)
    model_f32.load_state_dict(weights)
    cpu_gen = torch.Generator().manual_seed(SEED)
    mu = torch.randn((2,) + DATA_SHAPE, generator=cpu_gen)
    t = torch.rand(2, generator=cpu_gen)
    with torch.inference_mode():
        ref = model_cpu(mu, t)
        out = model_f32(mu.to(dev), t.to(dev)).cpu()
    scale = ref.abs().max().item()
    # f32 on both sides, TF32 off: the two differ only in the order of sums in
    # the 168 convolutions (cuDNN's against the CPU's), the attention and the
    # norms, compounded through 66 residual blocks.
    model_tol = 1e-4 * max(1.0, scale)
    err = check_close("UNet f32 card vs CPU", out, ref, model_tol)
    phase("model.check", batch=2, dtype="float32", max_abs_err=f"{err:.3e}", atol=f"{model_tol:.3e}",
          output_max_abs=f"{scale:.3e}", finite=bool(torch.isfinite(out).all()))

    algo = build_algo(K_STEPS)
    # The sampler, card against CPU, k=4 on the same noise. At random weights
    # the Fourier features (frequencies up to 2 pi 2^8) make the UNet so
    # sensitive to its input that two free-running samplers part by orders of
    # magnitude more than one forward's error. So: (a) the card decodes every
    # state of the CPU's trajectory as the CPU did, and (b) the update loop
    # itself agrees on a closed-form model.
    eps = torch.randn((5, 2) + DATA_SHAPE, generator=cpu_gen)
    t4 = torch.linspace(0.0, 1.0, 5)
    closed_form = lambda m, tt: torch.tanh(m) * tt[:, None, None, None]
    with torch.inference_mode():
        _, (mus, x_hats, _) = algo._sample_loop(
            model_cpu, eps[0], lambda i: eps[i + 1], t4, with_history=True)
        decode_err = max(
            check_close(f"sampler decode step {i}",
                        algo._predict_x(model_f32, mus[i].to(dev), t4[i].expand(2).to(dev)).cpu(),
                        x_hats[i], model_tol)
            for i in range(4)
        )
        loop_cpu, _ = algo._sample_loop(closed_form, eps[0], lambda i: eps[i + 1], t4)
        loop_dev, _ = algo._sample_loop(
            closed_form, eps[0].to(dev), lambda i: eps[i + 1].to(dev), t4.to(dev))
    loop_err = check_close("sampler loop card vs CPU", loop_dev.cpu(), loop_cpu, 1e-5, 1e-5)
    phase("sampler.check", k=4, batch=2, dtype="float32", decode_max_abs_err=f"{decode_err:.3e}",
          decode_atol=f"{model_tol:.3e}", loop_max_abs_err=f"{loop_err:.3e}", loop_tol="1e-5+1e-5*|x|")

    # ------------------------------- train-loss gradients, card against CPU
    # One f32 gradient of the mean train loss at batch 2, dropout off (eval
    # mode), the same weights and draws on both sides. Each leaf is held to
    # 1e-3 of its own norm: the forward agrees to ~1e-6 of its scale (above);
    # a weight's gradient sums ~2,000 pixel terms of random sign, so its
    # norm is ~45x below the sum of the terms' sizes, and the backward's
    # order of sums (cuDNN's against the CPU's) adds its own 1e-6.
    algo_train = build_algo(50)
    x_small = torch.rand((2,) + DATA_SHAPE, generator=cpu_gen) * 2.0 - 1.0
    t_small, eps_small = algo_train.train_noise(cpu_gen, x_small)
    grads, worst, worst_name, finite, _ = card_vs_cpu_grads(
        "train gradient", (model_cpu, model_f32), algo_train, x_small, t_small, eps_small)
    phase("train.check", batch=2, dtype="float32", leaves=len(grads), worst_rel_err=f"{worst:.3e}",
          worst_leaf=worst_name, tol="1e-3 of each leaf's norm", finite=finite)
    del model_f32, grads

    # ------------------------------------------------ main path: sampling
    # bench.py's unet-sampling row through its own timing function: a warm-up
    # run, then 3 timed ones, each run's launches gated between them.
    del scrub, q, k, v, x, x_nchw
    model = build_model("unet", dev)
    model.load_state_dict(weights)
    runs = []

    def gate(what: str, **want):
        return lambda samples: runs.append(expect_counts(what, **want))

    sample_rec = bench.bench_sampling(model, algo, batch=BATCH, seed=SEED + 1, before_run=reset_counts,
                                      after_run=gate("a UNet sampling run",
                                                     flash_attention=K1_PER_FORWARD * (K_STEPS + 1),
                                                     groupnorm_silu_fwd=K7_PER_FORWARD * (K_STEPS + 1)))
    launches = runs[-1]
    phase("sample", k=K_STEPS, batch=BATCH, dtype="bfloat16", run_s=sample_rec["run_s"],
          samples_per_s=f"{sample_rec['value']:.3f}", peak_mem_gib=f"{sample_rec['peak_mem_gib']:.3f}",
          launches=launches, finite=True, shape=(BATCH,) + DATA_SHAPE, **bench_fields(sample_rec))
    path_launches = {"unet_sample": launches}
    bench_rows = {"unet-sampling": sample_rec}
    del model

    # ---------------------------------------------- main path: train step
    # bench.py's unet-train row (bench_train.run) cut to TRAIN_STEPS steps.
    predicted_gib = predicted_train_peak_gib(TRAIN_BATCH, 1024, UNET["dim"], UNET["levels"])
    train_rec = bench_train.run(**{**bench.TRAIN_ROWS["unet-train"], "steps": TRAIN_STEPS}, device=dev,
                                seed=SEED + 2, window=reset_counts)
    train_launches = expect_counts(
        f"{TRAIN_STEPS} UNet train steps", flash_attention=K1_PER_FORWARD * TRAIN_STEPS,
        groupnorm_silu_fwd=K7_PER_FORWARD * TRAIN_STEPS, groupnorm_silu_bwd=K7B_PER_STEP * TRAIN_STEPS)
    check_train(train_rec)
    phase("train", batch=TRAIN_BATCH, dtype="bfloat16", dropout=bench_train.DROPOUT["unet"], steps=TRAIN_STEPS,
          step=train_rec["step"], ms_per_step=f"{train_rec['step_ms']:.3f}",
          examples_per_s=f"{train_rec['value']:.3f}", tflop_per_step=f"{train_rec['tflop_per_step']:.3f}",
          mfu=f"{train_rec['mfu']:.4f}", peak_mem_gib=f"{train_rec['peak_mem_gib']:.3f}",
          predicted_peak_gib=f"{predicted_gib:.3f}", final_loss=f"{train_rec['final_loss']:.6g}",
          grad_norm=f"{train_rec['grad_norm']:.6g}",
          launches_per_step={name: n // TRAIN_STEPS for name, n in train_launches.items() if n})
    path_launches["unet_train"] = train_launches
    bench_rows["unet-train"] = train_rec
    gc.collect()
    torch.cuda.empty_cache()

    # ---------------------------------------- DiT-L/2, card against CPU
    # adaLN-Zero: at init every gate is 0 and every block the identity, so a
    # check there passes whatever K2 and the MLP compute. The weights get
    # ada_out filled with normals of std 0.02 first.
    dit_cpu = build_model("dit", "cpu", dtype=None, seed=SEED)
    dit_weights = dit_cpu.state_dict()
    dit_f32 = build_model("dit", dev, dtype=None)
    dit_f32.load_state_dict(dit_weights)
    mu = torch.randn((2,) + DATA_SHAPE, generator=cpu_gen)
    t = torch.rand(2, generator=cpu_gen)
    reset_counts()
    with torch.inference_mode():
        ref = dit_cpu(mu, t)
        out = dit_f32(mu.to(dev), t.to(dev)).cpu()
    expect_counts("one f32 DiT forward", flash_attention_fused=K2_PER_FORWARD,
                  layernorm_modulate_fwd=K4F_PER_FORWARD)
    scale = ref.abs().max().item()
    # f32 on both sides, TF32 off: the two differ in the order of sums in 146
    # matmuls, 24 attentions and 49 norms.
    dit_tol = 1e-4 * max(1.0, scale)
    err = check_close("DiT-L/2 f32 card vs CPU", out, ref, dit_tol)
    phase("dit.model.check", batch=2, dtype="float32", max_abs_err=f"{err:.3e}", atol=f"{dit_tol:.3e}",
          output_max_abs=f"{scale:.3e}", finite=bool(torch.isfinite(out).all()))
    # The sampler: the card decodes each state of a k=2 CPU trajectory as the
    # CPU did (free-running samplers part through the Fourier features).
    eps = torch.randn((3, 2) + DATA_SHAPE, generator=cpu_gen)
    t2 = torch.linspace(0.0, 1.0, 3)
    with torch.inference_mode():
        _, (mus, x_hats, _) = algo._sample_loop(dit_cpu, eps[0], lambda i: eps[i + 1], t2, with_history=True)
        decode_err = max(
            check_close(f"DiT sampler decode step {i}",
                        algo._predict_x(dit_f32, mus[i].to(dev), t2[i].expand(2).to(dev)).cpu(),
                        x_hats[i], dit_tol)
            for i in range(2)
        )
    phase("dit.sampler.check", k=2, batch=2, dtype="float32", decode_max_abs_err=f"{decode_err:.3e}",
          decode_atol=f"{dit_tol:.3e}")
    # The train-loss gradient at batch 2, f32, dropout off (the card's keep
    # masks and the CPU's cannot match), the same weights and draws on both
    # sides, through K2, K3, K4f and K4b on the card. Each leaf within 1e-3
    # of its norm, as [train.check].
    x_small = torch.rand((2,) + DATA_SHAPE, generator=cpu_gen) * 2.0 - 1.0
    t_small, eps_small = algo_train.train_noise(cpu_gen, x_small)
    reset_counts()
    grads, worst, worst_name, finite, _ = card_vs_cpu_grads(
        "DiT train gradient", (dit_cpu, dit_f32), algo_train, x_small, t_small, eps_small)
    expect_counts("one f32 DiT-L/2 train-loss gradient", flash_attention_fused=K2_PER_FORWARD,
                  layernorm_modulate_fwd=K4F_PER_FORWARD, flash_attention_fused_bwd=K3_PER_STEP,
                  layernorm_modulate_bwd=K4B_PER_STEP)
    qkv_grad = grads["dit.block_0.attn.to_qkv.weight"].abs().max().item()
    phase("dit.train.check", batch=2, dtype="float32", dropout=None, leaves=len(grads),
          worst_rel_err=f"{worst:.3e}", worst_leaf=worst_name, tol="1e-3 of each leaf's norm",
          block0_qkv_grad_max=f"{qkv_grad:.3e}", finite=finite)
    if not qkv_grad > 0:
        raise AssertionError("the attention's gradient is zero: adaLN-Zero hides the backward")
    # The baselines of the imagenet32 recipe's sweep (configs/task/algorithm/
    # {vdm,bfn}.yaml, 8-bit discretization) on the same DiT-L/2 weights and
    # draws, card vs CPU, f32, batch 2: the train loss within 1e-4 of its
    # scale, its gradients within 1e-3 of each leaf's norm (through K2, K3,
    # K4f and K4b on the card), and the ELBO's bpd within 1e-4 (VDM's
    # reconstruction does not call the model: one forward; BFN's two).
    baselines = {"vdm": VDM(DATA_SHAPE, snr_min=6.73794699909e-3, snr_max=597195.613793, k=50,
                            discretization=Discretization.image_8bit()),
                 "bfn": BFN(DATA_SHAPE, sigma_1=1e-3, k=50, discretization=Discretization.image_8bit())}
    for name, baseline in baselines.items():
        t_b, eps_b = baseline.train_noise(cpu_gen, x_small)
        reset_counts()
        grads, worst, worst_name, finite, (loss_cpu, loss_card) = card_vs_cpu_grads(
            f"{name} train gradient", (dit_cpu, dit_f32), baseline, x_small, t_b, eps_b)
        expect_counts(f"one f32 DiT-L/2 {name} train-loss gradient", flash_attention_fused=K2_PER_FORWARD,
                      layernorm_modulate_fwd=K4F_PER_FORWARD, flash_attention_fused_bwd=K3_PER_STEP,
                      layernorm_modulate_bwd=K4B_PER_STEP)
        loss_err = abs(loss_card - loss_cpu)
        if not loss_err <= 1e-4 * max(abs(loss_cpu), 1e-30):
            raise AssertionError(f"{name} train loss card vs CPU: {loss_card} vs {loss_cpu}")
        draws = baseline.elbo_noise(cpu_gen, x_small)
        forwards = 1 if name == "vdm" else 2
        reset_counts()
        with torch.inference_mode():
            bpds = [baseline._elbo_on(model, x_small.to(device), *(d.to(device) for d in draws))[1].cpu()
                    for model, device in ((dit_cpu, "cpu"), (dit_f32, dev))]
        expect_counts(f"one f32 DiT-L/2 {name} ELBO", flash_attention_fused=forwards * K2_PER_FORWARD,
                      layernorm_modulate_fwd=forwards * K4F_PER_FORWARD)
        bpd_err = check_close(f"{name} ELBO bpd card vs CPU", bpds[1], bpds[0], 0.0, 1e-4)
        phase("baselines.check", algorithm=name, model="DiT-L/2", batch=2, dtype="float32",
              loss_cpu=f"{loss_cpu:.9g}", loss_card=f"{loss_card:.9g}", loss_abs_err=f"{loss_err:.3e}",
              leaves=len(grads), worst_rel_err=f"{worst:.3e}", worst_leaf=worst_name,
              bpd_cpu=[f"{x:.6f}" for x in bpds[0].tolist()], bpd_abs_err=f"{bpd_err:.3e}",
              tol="loss 1e-4 of its scale; each leaf 1e-3 of its norm; bpd 1e-4 relative",
              elbo_forwards=forwards, finite=finite and bool(torch.isfinite(bpds[1]).all()))
    del dit_cpu, dit_f32, grads

    # -------------------------------------------- main path: DiT sampling
    # bench.py's dit-sampling row, timed as [sample].
    dit = build_model("dit", dev)
    dit.load_state_dict(dit_weights)
    del dit_weights
    runs.clear()
    dit_sample_rec = bench.bench_sampling(dit, algo, batch=BATCH, seed=SEED + 4, before_run=reset_counts,
                                          after_run=gate("a DiT sampling run",
                                                         flash_attention_fused=K2_PER_FORWARD * (K_STEPS + 1),
                                                         layernorm_modulate_fwd=K4F_PER_FORWARD * (K_STEPS + 1)))
    launches = runs[-1]
    dit_flops = dit_sample_rec["tflop_per_run"] * 1e12 / (K_STEPS + 1)
    phase("dit.sample", k=K_STEPS, batch=BATCH, dtype="bfloat16", run_s=dit_sample_rec["run_s"],
          samples_per_s=f"{dit_sample_rec['value']:.3f}", peak_mem_gib=f"{dit_sample_rec['peak_mem_gib']:.3f}",
          tflop_per_forward=f"{dit_flops / 1e12:.3f}", gflop_per_example=f"{dit_flops / BATCH / 1e9:.1f}",
          launches={name: n for name, n in launches.items() if n}, finite=True, shape=(BATCH,) + DATA_SHAPE,
          **bench_fields(dit_sample_rec))
    path_launches["dit_sample"] = launches
    bench_rows["dit-sampling"] = dit_sample_rec
    del dit

    # -------------------------------------------- main path: DiT training
    # bench.py's dit-train row (bench_train.run: DiT-L/2, batch 64, bf16
    # compute on f32 parameters, dropout 0.05, AdamW 5e-4 with bf16 moments,
    # warmup 100, cosine to 1e6, clip 1.0, EMA after 1000; ada_out filled)
    # without remat: the activations fit the card without it.
    dit_rec = bench_train.run(**{**bench.TRAIN_ROWS["dit-train"], "steps": TRAIN_STEPS, "remat": False}, device=dev,
                              seed=SEED + 5, window=reset_counts)
    train_launches = expect_counts(
        f"{TRAIN_STEPS} DiT-L/2 train steps", flash_attention_fused=K2_PER_FORWARD * TRAIN_STEPS,
        flash_attention_fused_bwd=K3_PER_STEP * TRAIN_STEPS, layernorm_modulate_fwd=K4F_PER_FORWARD * TRAIN_STEPS,
        layernorm_modulate_bwd=K4B_PER_STEP * TRAIN_STEPS)
    check_train(dit_rec)
    phase("dit.train", batch=DIT_TRAIN_BATCH, dtype="bfloat16", dropout=DIT_DROPOUT, moments=dit_rec["mu_dtype"],
          steps=TRAIN_STEPS, step=dit_rec["step"], ms_per_step=f"{dit_rec['step_ms']:.3f}",
          examples_per_s=f"{dit_rec['value']:.3f}", tflop_per_step=f"{dit_rec['tflop_per_step']:.3f}",
          mfu=f"{dit_rec['mfu']:.4f}", peak_mem_gib=f"{dit_rec['peak_mem_gib']:.3f}",
          final_loss=f"{dit_rec['final_loss']:.6g}", grad_norm=f"{dit_rec['grad_norm']:.6g}",
          launches_per_step={name: n // TRAIN_STEPS for name, n in train_launches.items() if n})
    path_launches["dit_train"] = train_launches
    gc.collect()
    torch.cuda.empty_cache()

    # -------------- [dit.remat], [dit.b512]: bench.py's dit-train and b512 rows
    # With remat each block recomputes its forward in the backward (K2 and
    # K4f twice a micro-batch, K3 and K4b once), from the RNG state it
    # started from.
    for label, row, steps in (("dit.remat", "dit-train", REMAT_STEPS), ("dit.b512", "dit-train-b512", B512_STEPS)):
        rec = bench_train.run(**{**bench.TRAIN_ROWS[row], "steps": steps}, device=dev, seed=SEED + 5,
                              window=reset_counts)
        accum = rec["accum"]
        rows = bench.TRAIN_ROWS[row].get("batch", DIT_TRAIN_BATCH) // accum
        n = steps * accum
        got = expect_counts(f"{label}: {steps} steps of {accum}x{rows} with remat",
                            flash_attention_fused=2 * K2_PER_FORWARD * n,
                            layernorm_modulate_fwd=2 * K4F_PER_FORWARD * n,
                            flash_attention_fused_bwd=K3_PER_STEP * n, layernorm_modulate_bwd=K4B_PER_STEP * n)
        check_train(rec)
        fields = {}
        if accum == 1:
            fields = dict(ms_per_step_without_remat=f"{dit_rec['step_ms']:.3f}",
                          peak_mem_gib_without_remat=f"{dit_rec['peak_mem_gib']:.3f}")
        phase(label, batch=f"{accum * rows}" + (f" as {accum}x{rows}" if accum > 1 else ""), dtype="bfloat16",
              dropout=DIT_DROPOUT, moments=rec["mu_dtype"], remat=rec["remat"], steps=steps,
              ms_per_step=f"{rec['step_ms']:.3f}", examples_per_s=f"{rec['value']:.3f}",
              peak_mem_gib=f"{rec['peak_mem_gib']:.3f}", **fields, final_loss=f"{rec['final_loss']:.6g}",
              grad_norm=f"{rec['grad_norm']:.6g}", mfu=f"{rec['mfu']:.4f}",
              launches_per_step={name: v // steps for name, v in got.items() if v})
        path_launches[label.replace(".", "_")] = got
        bench_rows[row] = rec
        gc.collect()
        torch.cuda.empty_cache()
    bench_rows = {label: bench.finish(label, rec) for label, rec in bench_rows.items()}

    # --------------------------------- the 16x16 UNet, card against CPU
    # The same full-width UNet on 16x16 images, f32, TF32 off, batch 2: its
    # output within 1e-4 of the output's scale (as [model.check]), its
    # train-loss gradients within 1e-3 of each leaf's norm (as
    # [train.check]), dropout off, through K5f, K5b, K7f and K7b on the card;
    # and the eval step's bpd on the same draws, within 1e-4 of its size.
    unet16_cpu = build_model("unet", "cpu", dtype=None, seed=SEED + 7, image_size=DATA16[0])
    weights16 = unet16_cpu.state_dict()
    unet16_f32 = build_model("unet", dev, dtype=None, image_size=DATA16[0])
    unet16_f32.load_state_dict(weights16)
    mu = torch.randn((2,) + DATA16, generator=cpu_gen)
    t = torch.rand(2, generator=cpu_gen)
    reset_counts()
    with torch.inference_mode():
        ref = unet16_cpu(mu, t)
        out = unet16_f32(mu.to(dev), t.to(dev)).cpu()
    expect_counts("one f32 16x16 UNet forward", flash_attention_dropout=K5F_PER_FORWARD,
                  groupnorm_silu_fwd=K7_PER_FORWARD, conv3x3=CONV3X3_PER_FORWARD)
    scale = ref.abs().max().item()
    tol16 = 1e-4 * max(1.0, scale)
    err = check_close("16x16 UNet f32 card vs CPU", out, ref, tol16)
    phase("unet16.model.check", batch=2, dtype="float32", max_abs_err=f"{err:.3e}", atol=f"{tol16:.3e}",
          output_max_abs=f"{scale:.3e}", finite=bool(torch.isfinite(out).all()))
    algo16_train = build_algo(50, DATA16[0])
    x_small = torch.rand((2,) + DATA16, generator=cpu_gen) * 2.0 - 1.0
    t_small, eps_small = algo16_train.train_noise(cpu_gen, x_small)
    reset_counts()
    grads, worst, worst_name, finite, _ = card_vs_cpu_grads(
        "16x16 train gradient", (unet16_cpu, unet16_f32), algo16_train, x_small, t_small, eps_small)
    expect_counts("one f32 16x16 UNet train-loss gradient", flash_attention_dropout=K5F_PER_FORWARD,
                  flash_attention_bwd=K5B_PER_STEP, groupnorm_silu_fwd=K7_PER_FORWARD,
                  groupnorm_silu_bwd=K7B_PER_STEP, conv3x3=CONV3X3_PER_FORWARD)
    phase("unet16.train.check", batch=2, dtype="float32", leaves=len(grads), worst_rel_err=f"{worst:.3e}",
          worst_leaf=worst_name, tol="1e-3 of each leaf's norm", finite=finite)
    algo16 = build_algo(K_STEPS, DATA16[0])
    draws = algo16.elbo_noise(cpu_gen, x_small)
    reset_counts()
    evals = []
    for model_e, device in ((unet16_cpu, "cpu"), (unet16_f32, dev)):
        params_e = {name: p.detach() for name, p in model_e.named_parameters()}
        state_e = TrainState.create(params=params_e, opt_state=None, generator=torch.Generator())
        step_e = make_eval_step(algo16, module_apply(model_e, train=False),
                                noise=lambda batch: [draw.to(batch.device) for draw in draws])
        evals.append({key: val.item() for key, val in step_e(state_e, x_small.to(device),
                                                           torch.ones(2, device=device)).items()})
    expect_counts("one f32 16x16 eval step", flash_attention_dropout=2 * K5F_PER_FORWARD,
                  groupnorm_silu_fwd=2 * K7_PER_FORWARD, conv3x3=2 * CONV3X3_PER_FORWARD)
    bpd_err = abs(evals[1]["bpd_sum"] - evals[0]["bpd_sum"])
    if not bpd_err <= 1e-4 * abs(evals[0]["bpd_sum"]):
        raise AssertionError(f"16x16 eval bpd card vs CPU: {evals[1]['bpd_sum']} vs {evals[0]['bpd_sum']}")
    phase("unet16.eval.check", batch=2, dtype="float32", bpd_sum_cpu=f"{evals[0]['bpd_sum']:.6f}",
          bpd_sum_card=f"{evals[1]['bpd_sum']:.6f}", abs_err=f"{bpd_err:.3e}", tol="1e-4 of the bpd sum",
          finite=all(math.isfinite(val) for val in evals[1].values()))
    del unet16_cpu, unet16_f32, grads, model_e, params_e, state_e, step_e

    # ------------------------------- main path: 16x16 sampling, make_sample_fn
    # The state's EMA parameters (the weights) through a bf16 model in eval
    # mode, k=128, batch 64.
    unet16 = build_model("unet", dev, image_size=DATA16[0])
    unet16.load_state_dict(weights16)
    state16 = TrainState.create(params={name: p.detach() for name, p in unet16.named_parameters()}, opt_state=None,
                                generator=torch.Generator(device=dev).manual_seed(SEED + 8))
    sample16 = make_sample_fn(algo16, module_apply(unet16, train=False))
    sample_gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    sample16(state16, sample_gen, BATCH)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    secs = []
    for _ in range(3):
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        samples = sample16(state16, sample_gen, BATCH)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        launches = expect_counts("a 16x16 UNet sampling run",
                                 flash_attention_dropout=K5F_PER_FORWARD * (K_STEPS + 1),
                                 groupnorm_silu_fwd=K7_PER_FORWARD * (K_STEPS + 1))
        if samples.shape != (BATCH,) + DATA16 or not torch.isfinite(samples).all():
            raise AssertionError(f"bad 16x16 samples: shape {tuple(samples.shape)}, "
                                 f"finite {bool(torch.isfinite(samples).all())}")
    peak = torch.cuda.max_memory_allocated()
    phase("unet16.sample", k=K_STEPS, batch=BATCH, dtype="bfloat16", run_s=secs,
          samples_per_s=f"{BATCH / statistics.median(secs):.3f}", peak_mem_gib=f"{peak / 2**30:.3f}",
          launches={name: n for name, n in launches.items() if n}, finite=True, shape=tuple(samples.shape))
    path_launches["unet16_sample"] = launches
    del samples, sample16, unet16

    # ---------------------------------------------- main path: 16x16 training
    # The UNet train bench (bench_train.run) on 16x16 images: batch 128, bf16
    # on f32 parameters, dropout 0.1 (in the residual blocks; the attention
    # has none), AdamW 2e-4, warmup 100, cosine to 1e6, clip 1.0, EMA after
    # 1000.
    rec16 = bench_train.run(**{**bench.TRAIN_ROWS["unet-train"], "steps": TRAIN_STEPS}, device=dev, seed=SEED + 10,
                            image_size=DATA16[0], window=reset_counts)
    train_launches = expect_counts(
        f"{TRAIN_STEPS} 16x16 UNet train steps", flash_attention_dropout=K5F_PER_FORWARD * TRAIN_STEPS,
        flash_attention_bwd=K5B_PER_STEP * TRAIN_STEPS, groupnorm_silu_fwd=K7_PER_FORWARD * TRAIN_STEPS,
        groupnorm_silu_bwd=K7B_PER_STEP * TRAIN_STEPS)
    check_train(rec16)
    phase("unet16.train", batch=TRAIN_BATCH, dtype="bfloat16", dropout=bench_train.DROPOUT["unet"],
          steps=TRAIN_STEPS, step=rec16["step"], ms_per_step=f"{rec16['step_ms']:.3f}",
          examples_per_s=f"{rec16['value']:.3f}", tflop_per_step=f"{rec16['tflop_per_step']:.3f}",
          mfu=f"{rec16['mfu']:.4f}", peak_mem_gib=f"{rec16['peak_mem_gib']:.3f}",
          final_loss=f"{rec16['final_loss']:.6g}", grad_norm=f"{rec16['grad_norm']:.6g}",
          launches_per_step={name: n // TRAIN_STEPS for name, n in train_launches.items() if n})
    path_launches["unet16_train"] = train_launches
    gc.collect()
    torch.cuda.empty_cache()

    # -------------------------------------------- main path: 16x16 ELBO eval
    # make_eval_step on the EMA parameters through the f32 model (TF32 off),
    # n_recon = n_measure = 1, batch 64 with its last 8 images masked out.
    eval16 = build_model("unet", dev, dtype=None, image_size=DATA16[0])
    eval_step16 = make_eval_step(algo16, module_apply(eval16, train=False))
    data_gen = torch.Generator(device=dev).manual_seed(SEED + 10)
    batch = torch.randint(0, 256, (EVAL_BATCH,) + DATA16, generator=data_gen, device=dev) / 255.0 * 2.0 - 1.0
    mask = (torch.arange(EVAL_BATCH, device=dev) < EVAL_BATCH - 8).float()
    eval_gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    with torch.no_grad():
        eval_flops = 2 * sum(count_flops(eval16, lambda: eval16(
            batch, torch.full((EVAL_BATCH,), 0.5, device=dev))).values())
    eval_step16(state16, batch, mask, eval_gen)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    eval_secs = []
    for _ in range(EVAL_STEPS):
        t0 = time.perf_counter()
        sums = eval_step16(state16, batch, mask, eval_gen)
        torch.cuda.synchronize()
        eval_secs.append(time.perf_counter() - t0)
    eval_launches = expect_counts(
        f"{EVAL_STEPS} 16x16 eval steps", flash_attention_dropout=2 * K5F_PER_FORWARD * EVAL_STEPS,
        groupnorm_silu_fwd=2 * K7_PER_FORWARD * EVAL_STEPS, conv3x3=2 * CONV3X3_PER_FORWARD * EVAL_STEPS)
    bpd = sums["bpd_sum"].item() / sums["count"].item()
    if not (math.isfinite(bpd) and bpd > 0 and sums["count"].item() == EVAL_BATCH - 8):
        raise AssertionError(f"bad 16x16 eval metrics: {({key: val.item() for key, val in sums.items()})}")
    peak = torch.cuda.max_memory_allocated()
    eval_ms = statistics.median(eval_secs) * 1e3
    phase("unet16.eval", batch=EVAL_BATCH, dtype="float32", masked_out=8, steps=EVAL_STEPS,
          ms_per_step_runs=[f"{x * 1e3:.3f}" for x in eval_secs], ms_per_step=f"{eval_ms:.3f}",
          examples_per_s=f"{EVAL_BATCH / eval_ms * 1e3:.3f}", tflop_per_step=f"{eval_flops / 1e12:.3f}",
          f32_tflop_per_s=f"{eval_flops / eval_ms / 1e9:.2f}", bpd=f"{bpd:.6g}", peak_mem_gib=f"{peak / 2**30:.3f}",
          launches_per_step={name: n // EVAL_STEPS for name, n in eval_launches.items() if n})
    path_launches["unet16_eval"] = eval_launches
    del eval16, eval_step16, state16, batch

    # ---------------------- the UNet with an attention in every residual block
    # downsampling_attention on the full-width UNet, gelu: tail_attentions
    # attentions a forward over the image's pixels, K1 at 32x32 (S = 1024) and
    # K5f at 16x16 (S = 256), and no K7f (a gelu block's norms are plain). f32
    # card vs CPU at batch 2, TF32 off, within 1e-4 of the output's scale (as
    # [model.check]); the bf16 forward at batch 64, wall ms, median of 3 after
    # a warm-up.
    for shape, kernel in ((DATA_SHAPE, "flash_attention"), (DATA16, "flash_attention_dropout")):
        tail_kw = dict(image_size=shape[0], actfn="gelu", downsampling_attention=True)
        tail_cpu = build_model("unet", "cpu", dtype=None, seed=SEED + 12, **tail_kw)
        tail_f32 = build_model("unet", dev, dtype=None, **tail_kw)
        tail_f32.load_state_dict(tail_cpu.state_dict())
        mu = torch.randn((2,) + shape, generator=cpu_gen)
        t = torch.rand(2, generator=cpu_gen)
        what = f"one {shape[0]}x{shape[1]} UNet forward with attention tails"
        reset_counts()
        with torch.inference_mode():
            ref = tail_cpu(mu, t)
            out = tail_f32(mu.to(dev), t.to(dev)).cpu()
        counts = expect_counts(f"{what}, f32", **{kernel: tail_attentions}, conv3x3=tail_convs)
        scale = ref.abs().max().item()
        tail_tol = 1e-4 * max(1.0, scale)
        err = check_close(f"{what}: f32 card vs CPU", out, ref, tail_tol)
        tail_bf16 = build_model("unet", dev, **tail_kw)
        tail_bf16.load_state_dict(tail_cpu.state_dict())
        del tail_cpu, tail_f32
        mu64 = torch.randn((BATCH,) + shape, device=dev)
        t64 = torch.rand(BATCH, device=dev)
        secs = []
        with torch.inference_mode():
            tail_bf16(mu64, t64)  # warm-up
            for _ in range(3):
                reset_counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out64 = tail_bf16(mu64, t64)
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
                expect_counts(f"{what}, bf16 batch {BATCH}", **{kernel: tail_attentions})
        if out64.shape != (BATCH,) + shape or not torch.isfinite(out64).all():
            raise AssertionError(f"{what}: bad bf16 output {tuple(out64.shape)}, "
                                 f"finite {bool(torch.isfinite(out64).all())}")
        phase("unet.attn_tail", image=shape, actfn="gelu", attentions=tail_attentions,
              launches_per_forward={name: n for name, n in counts.items() if n}, f32_batch=2,
              f32_max_abs_err=f"{err:.3e}", atol=f"{tail_tol:.3e}", output_max_abs=f"{scale:.3e}",
              bf16_batch=BATCH, bf16_forward_ms=f"{statistics.median(secs) * 1e3:.3f}",
              bf16_forward_ms_runs=[f"{x * 1e3:.3f}" for x in secs], finite=True)
        del tail_bf16, mu64, out64

    # ------------------------------------------------ the trainer, end to end
    # python -m bsi_torch.train on the CIFAR-10 recipe (TRAINER_RECIPE): every
    # UNet forward there is f32 at 32x32, K1 once, K7f 66 times and K8f 135;
    # a train step's backward runs K7b 66 times (K1's backward at S = 1024 is the
    # plain VJP). fit: a sanity validation, 6 steps, validations after steps
    # 3 and 6, the plots at each (sampling of 64 at k = PLOTS_K_CUT, the
    # recipe's 50; filmstrips of 16, denoisings of 8), then the recipe's test
    # pass on ckpt_best (with its plots).
    import tempfile

    trainer_root = Path(tempfile.mkdtemp(prefix="bsi_torch_trainer_"))
    fit_args = TRAINER_RECIPE + [f"run_root={trainer_root / 'fit'}", f"trainer.max_steps={TRAINER_STEPS}",
                                 f"trainer.val_check_interval={TRAINER_VAL_EVERY}", "trainer.num_sanity_val_steps=1",
                                 "trainer.plots=yes", f"task.algorithm.k={PLOTS_K_CUT}"]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    run_dir, records = run_trainer(fit_args, trainer_root / "fit" / "console.log")
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    fit_peak = torch.cuda.max_memory_allocated()
    fit_counts = read_counts()
    k1, k7f, k7b, k8f = (fit_counts[name] for name in ("flash_attention", "groupnorm_silu_fwd", "groupnorm_silu_bwd",
                                                      "conv3x3"))
    others = {name: n for name, n in fit_counts.items()
              if n and name not in ("flash_attention", "groupnorm_silu_fwd", "groupnorm_silu_bwd", "conv3x3")}
    if not (k1 > 0 and k7f == K7_PER_FORWARD * k1 and k7b == K7B_PER_STEP * TRAINER_STEPS
            and k8f == CONV3X3_PER_FORWARD * k1) or others:
        raise AssertionError(f"trainer.fit launches: {fit_counts}")
    rates = metric(records, "train/steps_per_sec")
    losses = metric(records, "train/loss")
    val_bpd = metric(records, "val/bpd")
    numbers = losses + val_bpd + metric(records, "train/bpd") + metric(records, "test/bpd")
    if len(rates) != TRAINER_STEPS or len(val_bpd) != 3 or not all(math.isfinite(x) for x in numbers):
        raise AssertionError(f"trainer.fit metrics: rates {rates}, losses {losses}, val/bpd {val_bpd}")
    # the test pass plots at the step of ckpt_best, 3 or 6
    kinds = ("samples", "histories", "denoisings")
    pngs = sorted(str(p.relative_to(run_dir)) for p in run_dir.glob("plots/*/*.png"))
    want_pngs = {f"plots/step_{step}/val_{kind}.png" for step in (3, 6) for kind in kinds}
    tests = [p for p in pngs if p not in want_pngs]
    if not want_pngs <= set(pngs) or sorted(p.rsplit("/", 1)[1] for p in tests) != sorted(
            f"test_{kind}.png" for kind in kinds):
        raise AssertionError(f"trainer.fit plots: {pngs}")
    ckpt_bytes = {}
    for tag in ("last", "best"):
        ckpt = run_dir / f"ckpt_{tag}"
        meta = json.loads((ckpt / "meta.json").read_text())
        if not (ckpt / "state.pt").is_file() or meta["extra"]["best_bpd"] != min(val_bpd[1:]):
            raise AssertionError(f"trainer.fit ckpt_{tag}: {meta['extra']}")
        ckpt_bytes[tag] = (ckpt / "state.pt").stat().st_size
    # 6 batches of 128 from 512 images: the second epoch, at 256
    last_cursor = json.loads((run_dir / "ckpt_last" / "meta.json").read_text())["data_state"]["stream"]
    if (last_cursor["epoch"], last_cursor["pos"]) != (1, 256):
        raise AssertionError(f"trainer.fit data cursor in ckpt_last: {last_cursor}")
    step_ms = [1e3 / r for r in rates]
    phase("trainer.fit", recipe="cifar10-vdm", entry="bsi_torch.train.__main__.main", model="UNet dim 128, 32 "
          "levels, 1 head, dropout 0.1", dtype="float32", tf32=False, batch=TRAINER_BATCH,
          eval_batch=TRAINER_EVAL_BATCH,
          optimizer="AdamW 2e-4 (0.9, 0.99) wd 1e-2, warmup 1000, clip 1.0", dropout_prng_impl="rbg (ignored)",
          cut=f"data synthetic 32x32x3 (512 train, 128 val); {TRAINER_STEPS} steps; validation every "
              f"{TRAINER_VAL_EVERY} over 1 eval batch a split; plots at k={PLOTS_K_CUT} (50)",
          fit_wall_s=f"{fit_s:.3f}",
          steps_per_s=[f"{r:.3f}" for r in rates], ms_per_step_median_2_6=f"{statistics.median(step_ms[1:]):.3f}",
          loss=[f"{x:.6g}" for x in losses], val_bpd=[f"{x:.6g}" for x in val_bpd],
          validate_s=[f"{x:.3f}" for x in metric(records, "time/val_s")],
          test_s=[f"{x:.3f}" for x in metric(records, "time/test_s")],
          plots_s=[f"{x:.3f}" for x in metric(records, "time/PlotsCallback_s")],
          ckpt_bytes=ckpt_bytes, ckpt_copy_s=[f"{x:.3f}" for x in metric(records, "time/ckpt_last_copy_s")],
          ckpt_write_s=[f"{x:.3f}" for x in metric(records, "time/ckpt_last_write_s")],
          ckpt_best_write_s=[f"{x:.3f}" for x in metric(records, "time/ckpt_best_write_s")],
          peak_mem_gib=f"{fit_peak / 2**30:.3f}", launches={"k1": k1, "k7f": k7f, "k7b": k7b, "k8f": k8f}, pngs=len(pngs))
    path_launches["trainer_fit"] = fit_counts
    # the eval suite's phases read the fit's best checkpoint
    fit_ckpt = run_dir / "ckpt_best"

    # resume: 3 steps, then from their ckpt_last to step 6, against 6 straight
    # steps; bit for bit. cuDNN's deterministic algorithms (its convolutions'
    # backward); the rest of the step is deterministic as it stands: cuBLAS
    # on one stream, K1, K7f and K7b (no atomics), the dropout masks a
    # function of (seed, step), the optimizer's foreach passes. Cut: eval
    # batches of 128 (the recipe's 512 would take ~8 s a validation), no
    # plots, no sanity validation, no test pass.
    torch.backends.cudnn.deterministic = True
    resume_args = TRAINER_RECIPE + [f"trainer.val_check_interval={TRAINER_VAL_EVERY}", "trainer.plots=no",
                                    "trainer.num_sanity_val_steps=0", "eval_testset=no", "data.eval_batch_size=128"]
    t0 = time.perf_counter()
    reset_counts()
    straight_dir, straight = run_trainer(resume_args + [f"run_root={trainer_root / 'straight'}",
                                                        f"trainer.max_steps={TRAINER_STEPS}"],
                                         trainer_root / "straight" / "console.log")
    path_launches["trainer_resume"] = read_counts()
    first_dir, _ = run_trainer(resume_args + [f"run_root={trainer_root / 'first'}", "trainer.max_steps=3"],
                               trainer_root / "first" / "console.log")
    resumed_dir, resumed = run_trainer(resume_args + [f"run_root={trainer_root / 'resumed'}",
                                                      f"trainer.max_steps={TRAINER_STEPS}",
                                                      f"from_ckpt={first_dir / 'ckpt_last'}"],
                                       trainer_root / "resumed" / "console.log")
    resume_s = time.perf_counter() - t0
    torch.backends.cudnn.deterministic = False
    a = torch.load(straight_dir / "ckpt_last" / "state.pt", weights_only=True)
    b = torch.load(resumed_dir / "ckpt_last" / "state.pt", weights_only=True)
    differing = [f"{part}.{name}" for part in ("params", "ema_params") for name in a[part]
                 if not torch.equal(a[part][name], b[part][name])]
    differing += [f"opt_state.{m}.{name}" for m in ("mu", "nu") for name in a["opt_state"][m]
                  if not torch.equal(a["opt_state"][m][name], b["opt_state"][m][name])]
    meta_a, meta_b = (json.loads((d / "ckpt_last" / "meta.json").read_text()) for d in (straight_dir, resumed_dir))
    same = {"step": a["step"] == b["step"] == TRAINER_STEPS,
            "count": a["opt_state"]["count"] == b["opt_state"]["count"] == TRAINER_STEPS,
            "generator": torch.equal(a["generator"], b["generator"]),
            "data_cursor": meta_a["data_state"] == meta_b["data_state"],
            "best_bpd": meta_a["extra"]["best_bpd"] == meta_b["extra"]["best_bpd"]}
    n_tensors = 2 * len(a["params"]) + 2 * len(a["opt_state"]["mu"])
    phase("trainer.resume", runs="6 straight; 3, then resumed from ckpt_last to 6", cudnn_deterministic=True,
          cut="eval batch 128, no plots, no sanity validation, no test pass",
          compared=f"{n_tensors} tensors (params, EMA, mu, nu)", bit_equal=not differing, **same,
          val_bpd_straight=[f"{x:.9g}" for x in metric(straight, "val/bpd")],
          val_bpd_resumed=[f"{x:.9g}" for x in metric(resumed, "val/bpd")], wall_s=f"{resume_s:.3f}")
    if differing or not all(same.values()):
        raise AssertionError(f"trainer.resume: {len(differing)} tensors differ ({differing[:5]}), {same}")
    del a, b

    # accumulation: trainer.accumulate_grad_batches=2, two steps of 2 x 64;
    # each micro-batch runs a forward (K1 once) and a backward (K7b 66
    # times); cut as the resume runs
    accum_args = TRAINER_RECIPE + [f"run_root={trainer_root / 'accum'}", "trainer.max_steps=2",
                                   "trainer.accumulate_grad_batches=2", "trainer.plots=no",
                                   "trainer.num_sanity_val_steps=0", "eval_testset=no", "data.eval_batch_size=128"]
    gc.collect()
    reset_counts()
    t0 = time.perf_counter()
    _, accum = run_trainer(accum_args, trainer_root / "accum" / "console.log")
    accum_s = time.perf_counter() - t0
    # the one validation after step 2: two splits, two forwards each
    accum_counts = expect_counts("trainer.accum", flash_attention=2 * 2 + 4,
                                 groupnorm_silu_fwd=K7_PER_FORWARD * (2 * 2 + 4),
                                 groupnorm_silu_bwd=K7B_PER_STEP * 2 * 2, conv3x3=CONV3X3_PER_FORWARD * (2 * 2 + 4))
    accum_loss = metric(accum, "train/loss")
    if len(accum_loss) != 2 or not all(math.isfinite(x) for x in accum_loss):
        raise AssertionError(f"trainer.accum losses {accum_loss}")
    phase("trainer.accum", accumulate_grad_batches=2, micro_batch=64, steps=2, cut="eval batch 128, no plots",
          loss=[f"{x:.6g}" for x in accum_loss],
          k1_per_step_in_train=2, launches={k: n for k, n in accum_counts.items() if n}, wall_s=f"{accum_s:.3f}",
          steps_per_s=[f"{x:.3f}" for x in metric(accum, "train/steps_per_sec")])
    path_launches["trainer_accum"] = accum_counts

    # the CPU, asked for: mode=debug (2 steps, validation after each) at a
    # narrow width; no kernel may launch
    cpu_args = ["mode=debug", "data=synthetic", "data.data_shape=[8,8,3]", "data.batch_size=8",
                "task.model.dim=32", "task.model.levels=2", "seed=3", "+trainer.device=cpu",
                f"run_root={trainer_root / 'cpu'}"]
    reset_counts()
    t0 = time.perf_counter()
    cpu_dir, cpu = run_trainer(cpu_args, trainer_root / "cpu" / "console.log")
    cpu_s = time.perf_counter() - t0
    path_launches["trainer_cpu"] = expect_counts("trainer.cpu")
    cpu_state = torch.load(cpu_dir / "ckpt_last" / "state.pt", weights_only=True)
    cpu_bpd = metric(cpu, "val/bpd")
    if not cpu_bpd or not all(math.isfinite(x) for x in cpu_bpd) or cpu_state["step"] != 2:
        raise AssertionError(f"trainer.cpu: val/bpd {cpu_bpd}, step {cpu_state['step']}")
    phase("trainer.cpu", overrides="mode=debug +trainer.device=cpu", width="UNet dim 32, 2 levels, 8x8x3",
          steps=cpu_state["step"], val_bpd=[f"{x:.6g}" for x in cpu_bpd], kernel_launches=0,
          wall_s=f"{cpu_s:.3f}", note="fit, resume and accum above ran on the card by default")
    import shutil

    # ------------------------------------------------ the eval suite, end to end
    # bsi_torch.metrics (FID's InceptionV3 and statistics) and the eight
    # scripts of python -m bsi_torch.scripts, called in this process (the
    # kernels stay built), on the fit's ckpt_best: the CIFAR-10 recipe's UNet
    # at full width, f32, TF32 off. Every UNet forward runs K1 once, K7f 66
    # times and K8f 135, and no other kernel; the Inception none. Inception weights:
    # random, of pt_inception's shapes, fan-in-scaled convolutions and
    # non-trivial BatchNorm statistics, drawn from SEED into a .pth that
    # BSI_TPU_INCEPTION_WEIGHTS names. Cuts: eval batch 128 (the recipe's
    # 512) for the ELBO, samples, h_alpha and the trainer's FID; the
    # trainer's FID samples at k=8 (the recipe's 50).
    from bsi_torch import metrics as fidm
    from bsi_torch.metrics import inception
    from bsi_torch.core import get_schedule
    from bsi_torch.scripts import (compute_fid_stats, eval_elbo, eval_fid, eval_overrides, generate_sample_history,
                                   generate_samples, render_samples, sample_h_alpha)
    from bsi_torch.scripts._common import load_trainer
    from bsi_torch.tasks.plots import read_png

    eval_root = Path(tempfile.mkdtemp(prefix="bsi_torch_eval_"))
    suite_start = time.perf_counter()
    incep_rng = np.random.default_rng(SEED)
    incep_params = {}
    for name, cin, cout, (kh, kw) in inception._conv_specs():
        incep_params[f"{name}.conv.weight"] = torch.from_numpy(
            incep_rng.normal(0, (cin * kh * kw) ** -0.5, size=(cout, cin, kh, kw)).astype(np.float32))
        for key, draw in (("weight", lambda: incep_rng.uniform(0.5, 1.5, cout)),
                          ("bias", lambda: incep_rng.normal(0, 0.2, cout)),
                          ("running_mean", lambda: incep_rng.normal(0, 0.1, cout)),
                          ("running_var", lambda: incep_rng.uniform(0.5, 1.5, cout))):
            incep_params[f"{name}.bn.{key}"] = torch.from_numpy(draw().astype(np.float32))
    weights = eval_root / "pt_inception-random.pth"
    torch.save(incep_params, weights)
    os.environ["BSI_TPU_INCEPTION_WEIGHTS"] = str(weights)
    if fidm.default_weights_path() != weights:
        raise AssertionError(f"default_weights_path() is {fidm.default_weights_path()}, not {weights}")

    # [inception.check]: the embed on the card in f32 against the same
    # network in f64 on the CPU, on 8 uint8 images of 32x32, within 1e-4 of
    # the features' max abs; called with TF32 on, which it turns off for the
    # call and restores after
    t0 = time.perf_counter()
    imgs8 = torch.from_numpy(incep_rng.integers(0, 256, size=(8, 32, 32, 3), dtype=np.uint8))
    embed = fidm.make_embed_fn(fidm.load_params(weights))
    reset_counts()
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    feats8 = embed(imgs8)
    restored = torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    expect_counts("inception.check")
    ref8 = fidm.inception_features(fidm.load_params(weights), imgs8.double() / 255.0)
    scale = ref8.abs().max().item()
    if feats8.shape != (8, 2048) or feats8.dtype != torch.float32 or feats8.device.type != "cuda" or not restored:
        raise AssertionError(f"inception.check: {tuple(feats8.shape)} {feats8.dtype} on {feats8.device}, "
                             f"TF32 flags restored {restored}")
    err = check_close("inception.check: f32 card vs f64 CPU", feats8.cpu().double(), ref8, 1e-4 * scale)
    phase("inception.check", weights="random, pt_inception shapes, seed 0", images="8 uint8 32x32",
          max_abs_err=f"{err:.3e}", atol=f"{1e-4 * scale:.3e}", features_max_abs=f"{scale:.3e}",
          tf32_in_embed=False, tf32_flags_restored=restored, s=f"{time.perf_counter() - t0:.2f}")

    # [inception.time]: 512 images as FIDScore embeds them (blocks of 256),
    # one warm-up; the bound counts the convolutions' multiply-adds at
    # 299x299 from their output shapes (hooks on one forward), 2 operations
    # each, over the f32 peak
    macs = []
    counter = inception.build_network(fidm.load_params(weights), device=dev)
    hooks = [m.register_forward_hook(lambda m, i, o: macs.append(o[0].numel() * m.in_channels
                                                                 * m.kernel_size[0] * m.kernel_size[1]))
             for m in counter.modules() if isinstance(m, torch.nn.Conv2d)]
    with torch.inference_mode():
        counter(torch.zeros(1, 32, 32, 3, device=dev))
    for hook in hooks:
        hook.remove()
    del counter
    n_convs, macs_per_image = len(macs), sum(macs)
    bound_ms_per_image = 2 * macs_per_image / F32_FLOPS * 1e3
    imgs512 = torch.from_numpy(incep_rng.integers(0, 256, size=(512, 32, 32, 3), dtype=np.uint8))
    reset_counts()
    embed(imgs512[:256])
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    blocks = [embed(imgs512[i:i + 256]) for i in range(0, 512, 256)]
    torch.cuda.synchronize()
    embed_s = time.perf_counter() - t0
    incep_peak = torch.cuda.max_memory_allocated()
    expect_counts("inception.time")
    halves = [fidm.FeatureStats(2048) for _ in blocks]
    for stats, block in zip(halves, blocks):
        stats.update(block)
    t0 = time.perf_counter()
    fd = fidm.fid_from_stats(*halves)
    fd_s = time.perf_counter() - t0
    if not math.isfinite(fd):
        raise AssertionError(f"inception.time: frechet distance {fd}")
    ms_per_image = embed_s / 512 * 1e3
    phase("inception.time", images=512, block=256, dtype="float32", tf32=False, wall_s=f"{embed_s:.4f}",
          ms_per_image=f"{ms_per_image:.4f}", images_per_s=f"{512 / embed_s:.1f}",
          peak_mem_gib=f"{incep_peak / 2**30:.3f}", convs=n_convs, gmacs_per_image=f"{macs_per_image / 1e9:.4f}",
          gflop_per_image=f"{2 * macs_per_image / 1e9:.3f}", bound_ms_per_image=f"{bound_ms_per_image:.4f}",
          bound_by="operations", tflops=f"{2 * macs_per_image * 512 / embed_s / 1e12:.2f}",
          share_of_bound=f"{bound_ms_per_image / ms_per_image:.3f}",
          frechet_2048_host_s=f"{fd_s:.3f}", frechet_value=f"{fd:.6g}", host_cpus=os.cpu_count())
    del blocks, imgs512, embed

    # [fid.stats]: compute_fid_stats for synthetic 32x32 train (its val
    # split included), val and test into a temp root
    stats_root = eval_root / "stats"
    t0 = time.perf_counter()
    reset_counts()
    want_n = {"train": 512 + 128, "val": 128, "test": 128}
    for split in want_n:
        compute_fid_stats.main(["synthetic", split, "--out-root", str(stats_root), "data.data_shape=[32,32,3]"])
    expect_counts("fid.stats")
    for split, n in want_n.items():
        with np.load(fidm.fid_stats_path(stats_root, "synthetic", split)) as z:
            if sorted(z.files) != ["cov_sum", "n", "sum"] or int(z["n"]) != n or z["cov_sum"].shape != (2048, 2048):
                raise AssertionError(f"fid.stats {split}: keys {z.files}, n {z['n']}")
    phase("fid.stats", dataset="synthetic 32x32x3 (seed 0)", n=want_n, s=f"{time.perf_counter() - t0:.2f}")

    def script(label: str, fn, argv: list[str], forwards: int) -> tuple[float, dict]:
        """One script's main in this process; its K1 launches must be
        ``forwards``, K7f's 66 times that, K8f's 135 times, every other
        kernel none."""
        reset_counts()
        t0 = time.perf_counter()
        if fn(argv) != 0:
            raise AssertionError(f"{label}: exit code not 0")
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = expect_counts(label, flash_attention=forwards, groupnorm_silu_fwd=K7_PER_FORWARD * forwards,
                               conv3x3=CONV3X3_PER_FORWARD * forwards)
        path_launches[label.replace(".", "_").replace("-", "_")] = counts
        return secs, counts

    # [eval.fid]: the sweep k = 4, 8 of 128 samples in one batch of 128:
    # (4 + 1) + (8 + 1) sampling forwards
    fid_json = eval_root / "fid.json"
    secs, _ = script("eval.fid", eval_fid.main, ["-c", str(fit_ckpt), "-o", str(fid_json), "-k", "4", "8", "-n", "128",
                                                  "--batch-size", "128", "--fid-stats-root", str(stats_root)], 14)
    fids = json.loads(fid_json.read_text())["fid"]
    if set(fids) != {"4", "8"} or not all(math.isfinite(v) for by in fids.values() for v in by.values()) or \
            any(set(by) != {"train", "test"} for by in fids.values()):
        raise AssertionError(f"eval.fid: {fids}")
    phase("eval.fid", k=[4, 8], n=128, batch=128, schedule="linear", fid={k: {s: f"{v:.6g}" for s, v in by.items()}
          for k, by in fids.items()}, launches={"k1": 14, "k7f": 14 * K7_PER_FORWARD}, s=f"{secs:.2f}")

    # [eval.sampler]: eval_fid's sampling loop alone, without its set-up,
    # Inception or distances: the same checkpoint's sampler, EVAL_BATCH
    # samples at k=8 (9 forwards), twice after [eval.fid]'s warm calls, each
    # timed between synchronisations; a paper FID's sampling cost follows
    # from its ms an image-forward
    trainer, _, _ = load_trainer(str(fit_ckpt))
    sample_t = get_schedule("linear", 8, trainer.algorithm, device=trainer.device)
    generator = torch.Generator(device=trainer.device).manual_seed(SEED)
    reset_counts()
    sampler_s = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        drawn = trainer.sample_fn(trainer.state, generator, EVAL_BATCH, t=sample_t)
        torch.cuda.synchronize()
        sampler_s.append(time.perf_counter() - t0)
        if drawn.shape[0] != EVAL_BATCH or not bool(torch.isfinite(drawn).all()):
            raise AssertionError(f"eval.sampler: {tuple(drawn.shape)}, finite {bool(torch.isfinite(drawn).all())}")
    path_launches["eval_sampler"] = expect_counts("eval.sampler", flash_attention=2 * 9,
                                                  groupnorm_silu_fwd=2 * 9 * K7_PER_FORWARD,
                                                  conv3x3=2 * 9 * CONV3X3_PER_FORWARD)
    phase("eval.sampler", n=EVAL_BATCH, k=8, forwards=9, dtype="float32", tf32=False,
          s=[f"{x:.4f}" for x in sampler_s], ms_per_image_forward=[f"{x / (9 * EVAL_BATCH) * 1e3:.4f}" for x in sampler_s],
          launches={"k1": 2 * 9, "k7f": 2 * 9 * K7_PER_FORWARD, "k8f": 2 * 9 * CONV3X3_PER_FORWARD})
    del trainer, drawn

    # [eval.elbo]: k = inf and 10 over the test split's 128 images, one
    # batch (the recipe's eval batch 512 cut to 128), 2 reconstruction and 2
    # measurement samples: each ELBO one flat forward of 256 for its
    # reconstruction and one for its measurement
    elbo_json = eval_root / "elbo.json"
    secs, _ = script("eval.elbo", eval_elbo.main, ["-c", str(fit_ckpt), "-o", str(elbo_json), "-k", "inf", "10",
                                                    "--split", "test", "-r", str(EVAL_ELBO_SAMPLES), "-m",
                                                    str(EVAL_ELBO_SAMPLES), f"data.eval_batch_size={EVAL_BATCH}"], 4)
    elbo = json.loads(elbo_json.read_text())
    stderr = {k: math.sqrt(v) for k, v in elbo["bpd_mean_vars"].items() if v > 0}
    if set(elbo["bpd_means"]) != {"inf", "10"} or set(stderr) != {"inf", "10"} or \
            not all(math.isfinite(x) for x in list(elbo["bpd_means"].values()) + list(stderr.values())):
        raise AssertionError(f"eval.elbo: {elbo}")
    phase("eval.elbo", k=["inf", 10], split="test", n=128, r=2, m=2,
          bpd={k: f"{v:.6g}" for k, v in elbo["bpd_means"].items()},
          stderr={k: f"{v:.4g}" for k, v in stderr.items()}, launches={"k1": 4, "k7f": 4 * K7_PER_FORWARD},
          s=f"{secs:.2f}")

    # [eval.samples]: generate_samples (128 at k=8 in one batch: 9 forwards,
    # with the embeddings and the FID against train and test),
    # generate_sample_history (16 at k=8: 9), sample_h_alpha (8 lambdas over
    # the test split's one batch: 8) and render_samples
    samples_npz, hist_npz, h_alpha_npz, grid_png = (eval_root / n for n in ("samples.npz", "hist.npz",
                                                                          "h_alpha.npz", "grid.png"))
    s_samples, _ = script("eval.samples", generate_samples.main,
                          ["-c", str(fit_ckpt), "-o", str(samples_npz), "-n", "128", "-k", "8", "--fid-stats-root",
                           str(stats_root), "data.eval_batch_size=128"], 9)
    s_hist, _ = script("eval.history", generate_sample_history.main,
                       ["-c", str(fit_ckpt), "-o", str(hist_npz), "-n", str(EVAL_HISTORY_N), "-k", "8"], 9)
    s_h_alpha, _ = script("eval.h_alpha", sample_h_alpha.main,
                          ["-c", str(fit_ckpt), "-o", str(h_alpha_npz), "-n", "8", "data.eval_batch_size=128"], 8)
    reset_counts()
    render_samples.main([str(samples_npz), str(grid_png)])
    expect_counts("render_samples")
    with np.load(samples_npz) as z:
        got = {k: (tuple(z[k].shape), str(z[k].dtype)) for k in z.files}
        sample_fids = {k: float(z[k]) for k in ("fid_train", "fid_test")}
        finite = bool(np.isfinite(z["samples"]).all())
    want = {"samples": ((128, 32, 32, 3), "float32"), "k": ((), "int64"), "schedule": ((), "<U6"),
            "ema": ((), "bool"), "embedding_sum": ((2048,), "float64"),
            "embedding_cov_sum": ((2048, 2048), "float64"), "embedding_n": ((), "int64"),
            "fid_train": ((), "float64"), "fid_test": ((), "float64")}
    if got != want or not finite or not all(math.isfinite(v) for v in sample_fids.values()):
        raise AssertionError(f"generate_samples: {got}, finite {finite}, {sample_fids}")
    with np.load(hist_npz) as z:
        got = {k: (tuple(z[k].shape), str(z[k].dtype)) for k in z.files}
    want = {"mus": ((9, 16, 32, 32, 3), "uint8"), "x_hats": ((9, 16, 32, 32, 3), "uint8"),
            "ys": ((8, 16, 32, 32, 3), "uint8")}
    if got != want:
        raise AssertionError(f"generate_sample_history: {got}")
    with np.load(h_alpha_npz) as z:
        errs, lambdas = z["squared_error_samples_bpd"], z["lambda"]
        if sorted(z.files) != ["ckpt", "lambda", "squared_error_samples_bpd"] or errs.shape != (8, 128) or \
                lambdas.shape != (8,) or not np.isfinite(errs).all():
            raise AssertionError(f"sample_h_alpha: {z.files}, {errs.shape}")
    png = read_png(grid_png).shape
    if png != (16 * 32, 8 * 32, 3):
        raise AssertionError(f"render_samples: PNG of {png}")
    phase("eval.samples", generate_samples=f"128 at k=8, {s_samples:.2f} s", fid={k: f"{v:.6g}" for k, v in
          sample_fids.items()}, generate_sample_history=f"16 at k=8, {s_hist:.2f} s",
          sample_h_alpha=f"8 lambdas x 128, {s_h_alpha:.2f} s",
          h_alpha_bits=[f"{x:.4g}" for x in errs.mean(axis=1)], render_samples=f"PNG {png}",
          launches={"k1": [9, 9, 8], "k7f": [9 * K7_PER_FORWARD, 9 * K7_PER_FORWARD, 8 * K7_PER_FORWARD]})

    # [trainer.fid]: the test pass with validation FID through build_task
    # (eval_overrides): per split (test, and the train subset) one eval batch
    # of 128, its eval step (2 forwards) and 128 samples at k=8 (9)
    metrics_json = eval_root / "metrics.json"
    secs, _ = script("trainer.fid", eval_overrides.main,
                     ["-c", str(fit_ckpt), "-o", str(metrics_json), f"trainer.fid_stats_root={stats_root}",
                      "trainer.plots=no", "task.algorithm.k=8", "data.eval_batch_size=128"], 2 * (2 + 9))
    test_metrics = json.loads(metrics_json.read_text())
    if not all(math.isfinite(test_metrics.get(k, math.nan)) for k in ("test/fid-2048", "train/fid-2048", "test/bpd")):
        raise AssertionError(f"trainer.fid: {test_metrics}")
    phase("trainer.fid", entry="bsi_torch.scripts.eval_overrides", fid={k: f"{v:.6g}" for k, v in
          test_metrics.items() if "/fid-" in k}, test_bpd=f"{test_metrics['test/bpd']:.6g}",
          cut="k=8 (the recipe's 50); eval batch 128 (512)", launches={"k1": 22, "k7f": 22 * K7_PER_FORWARD},
          s=f"{secs:.2f}")
    shutil.rmtree(eval_root, ignore_errors=True)
    del os.environ["BSI_TPU_INCEPTION_WEIGHTS"]
    phase("eval.suite", s=f"{time.perf_counter() - suite_start:.1f}")

    shutil.rmtree(trainer_root, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()

    # ------------------------------------------ the ImageNet recipes, end to end
    # (IMAGENET_*). A train micro-batch runs K2 24 times at rate 0.05, K3 24,
    # K4f and K4b 48; each model forward of an eval step or of the plots K2 24
    # times at rate 0 and K4f 48. An ELBO eval step runs the model twice for
    # BSI and BFN (reconstruction, measurement) and once for VDM (its
    # reconstruction reads z_0 without the model); the plots k times each
    # for the k=50 sampling of 64 and the filmstrips of 16, plus a final
    # decode each for BSI and BFN, and once for the 120 denoisings.
    imagenet_root = Path(tempfile.mkdtemp(prefix="bsi_torch_imagenet_"))
    t0 = time.perf_counter()
    for n, (n_train, n_val, n_shards) in IMAGENET_SHARDS.items():
        write_synthetic_shards(imagenet_root / f"data{n}", n, n_train, n_val, seed=SEED, n_shards=n_shards)
    phase("imagenet.shards", **{f"imagenet{n}": f"{c[0]} train in {c[2]} shards, {c[1]} val"
                                for n, c in IMAGENET_SHARDS.items()}, seed=SEED, write_s=f"{time.perf_counter() - t0:.3f}")
    def imagenet_fit(label: str, n: int, task: str, *extra: str, sanity: bool, test: bool, plots: bool,
                     eval_batch: int, accum: int = IMAGENET_ACCUM,
                     k: int = IMAGENET_K) -> tuple[Path, list[dict], dict]:
        """One recipe run through ``main``, its launches checked exactly, its
        losses and bpd finite, its PNGs and checkpoints present; prints its
        phase line and returns (run dir, metrics records, fields). ``k``:
        the sampling steps of the plots (the recipe's IMAGENET_K)."""
        run_root = imagenet_root / label
        args = [f"experiment=imagenet{n}", f"task={task}", f"data.root={imagenet_root / f'data{n}'}",
                f"data.batch_size={accum * IMAGENET_MICRO}", f"data.eval_batch_size={eval_batch}",
                f"trainer.accumulate_grad_batches={accum}",
                f"trainer.max_steps={IMAGENET_STEPS}", f"trainer.val_check_interval={IMAGENET_STEPS}",
                "trainer.log_every_n_steps=1", "trainer.limit_eval_batches=1",
                f"trainer.num_sanity_val_steps={int(sanity)}", f"trainer.plots={'yes' if plots else 'no'}",
                f"eval_testset={'yes' if test else 'no'}", f"run_root={run_root}", f"task.algorithm.k={k}", *extra]
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        run_dir, records = run_trainer(args, run_root / "console.log")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        # one eval batch a split, two splits a validation
        micro_steps = IMAGENET_STEPS * accum
        validations = 1 + int(sanity) + int(test)
        eval_forwards = (1 if task == "vdm" else 2) * 2 * validations
        plot_forwards = (2 * (k + (task != "vdm")) + 1) * (1 + int(test)) if plots else 0
        forwards = micro_steps + eval_forwards + plot_forwards
        counts = expect_counts(label, flash_attention_fused=K2_PER_FORWARD * forwards,
                               layernorm_modulate_fwd=K4F_PER_FORWARD * forwards,
                               flash_attention_fused_bwd=K3_PER_STEP * micro_steps,
                               layernorm_modulate_bwd=K4B_PER_STEP * micro_steps)
        rates, losses = metric(records, "train/steps_per_sec"), metric(records, "train/loss")
        val_bpd = metric(records, "val/bpd")
        bpds = val_bpd + metric(records, "train/bpd") + metric(records, "test/bpd")
        if len(rates) != IMAGENET_STEPS or len(losses) != IMAGENET_STEPS or len(val_bpd) != 1 + int(sanity) or \
                len(bpds) != 2 * validations or not all(math.isfinite(x) for x in losses + bpds):
            raise AssertionError(f"{label} metrics: rates {rates}, losses {losses}, bpd {bpds}")
        pngs = sorted(str(p.relative_to(run_dir)) for p in run_dir.glob("plots/*/*.png"))
        want_pngs = sorted(f"plots/step_{IMAGENET_STEPS}/{stage}_{kind}.png" for stage in ("val", "test")[:1 + int(test)]
                           for kind in ("samples", "histories", "denoisings")) if plots else []
        if pngs != want_pngs:
            raise AssertionError(f"{label} plots: {pngs}, want {want_pngs}")
        ckpt_bytes = {}
        for tag in ("last", "best"):
            meta = json.loads((run_dir / f"ckpt_{tag}" / "meta.json").read_text())
            if meta["extra"]["best_bpd"] != val_bpd[-1]:
                raise AssertionError(f"{label} ckpt_{tag}: {meta['extra']}")
            ckpt_bytes[tag] = (run_dir / f"ckpt_{tag}" / "state.pt").stat().st_size
        secs = lambda key: [f"{x:.3f}" for x in metric(records, key)]
        fields = dict(
            recipe=f"imagenet{n}", task=task, model=f"DiT-L/{2 if n == 32 else 4}, dim 1024, depth 24, 16 heads of 64, "
            "dropout 0.05", dtype="float32", tf32=False, batch=f"{accum * IMAGENET_MICRO} as {accum}x{IMAGENET_MICRO}",
            eval_batch=eval_batch, wall_s=f"{wall:.3f}", steps_per_s=[f"{r:.4f}" for r in rates],
            ms_per_step=[f"{1e3 / r:.1f}" for r in rates], loss=[f"{x:.6g}" for x in losses],
            val_bpd=[f"{x:.6g}" for x in val_bpd], train_bpd=[f"{x:.6g}" for x in metric(records, "train/bpd")],
            test_bpd=[f"{x:.6g}" for x in metric(records, "test/bpd")], validate_s=secs("time/val_s"),
            test_s=secs("time/test_s"), plots_s=secs("time/PlotsCallback_s"), ckpt_bytes=ckpt_bytes,
            ckpt_copy_s=secs("time/ckpt_last_copy_s") + secs("time/ckpt_best_copy_s"),
            ckpt_write_s=secs("time/ckpt_last_write_s") + secs("time/ckpt_best_write_s"),
            peak_mem_gib=f"{peak / 2**30:.3f}", launches={k: v for k, v in counts.items() if v}, pngs=len(pngs))
        path_launches[label.replace(".", "_")] = counts
        return run_dir, records, fields

    # imagenet32, task=bsi: the recipe as a user runs it (a sanity validation,
    # the plots, ckpt_last/ckpt_best, the test pass on ckpt_best with its
    # plots), the sweep's first seed; the plots sampled at k=PLOTS_K_CUT (the
    # soak's and bench_parallel's phases took the time)
    sweep_seed = "seed=9551795317880672191"
    run_dir, _, fields = imagenet_fit("imagenet32.fit", 32, "bsi", sweep_seed, sanity=True, test=True, plots=True,
                                      eval_batch=IMAGENET_EVAL_BATCH, k=PLOTS_K_CUT)
    phase("imagenet32.fit", **fields, cut=f"shards from seed {SEED} ({IMAGENET_SHARDS[32][0]} train); "
          f"{IMAGENET_STEPS} steps; 1 eval batch a split; plots at k={PLOTS_K_CUT} ({IMAGENET_K})")
    shutil.rmtree(run_dir, ignore_errors=True)
    # VDM and BFN, cut to keep the new phases near 3 minutes: batch 256 as
    # 4x64 (the kernels' shapes stay the micro-batch's), eval batch 128, the
    # plots sampled at k=PLOTS_K_CUT (the pipeline's phases took the time)
    for task in ("vdm", "bfn"):
        run_dir, _, fields = imagenet_fit(f"imagenet32.{task}", 32, task, sweep_seed, sanity=False, test=False,
                                          plots=True, eval_batch=128, accum=4, k=PLOTS_K_CUT)
        phase(f"imagenet32.{task}", **fields, cut=f"as imagenet32.fit; batch 256 as 4x64, eval batch 128; no sanity "
                                                  f"validation, no test pass; plots at k={PLOTS_K_CUT} "
                                                  f"({IMAGENET_K})")
        shutil.rmtree(run_dir, ignore_errors=True)

    # imagenet64 (preload: no): the batches the trainer gathered through the
    # .npy row source, against the same rows read with preload=yes
    gathered, sources = [], []
    train_batches = ImageNetDataModule.train_batches

    def recording(self, *args, **kwargs):
        sources.append(type(self._train))
        for batch in train_batches(self, *args, **kwargs):
            gathered.append(batch.copy())
            yield batch

    ImageNetDataModule.train_batches = recording
    try:
        run_dir, _, fields = imagenet_fit("imagenet64.fit", 64, "bsi", "seed=16075619163396078907", sanity=False,
                                          test=False, plots=False, eval_batch=128)
    finally:
        ImageNetDataModule.train_batches = train_batches
    config = json.loads((run_dir / "config.json").read_text())
    eager = ImageNetDataModule(**{k: v for k, v in config["data"].items() if k not in ("_target_", "name", "preload")},
                               preload=True, seed=config["seed"])
    want = eager.train_batches()
    same = [bool(np.array_equal(batch, next(want))) for batch in gathered]
    if sources != [NpyRowSource] or len(gathered) != IMAGENET_STEPS or not all(same):
        raise AssertionError(f"imagenet64.fit batches: sources {sources}, {len(gathered)} batches, equal {same}")
    phase("imagenet64.fit", **fields, preload=False, source="NpyRowSource",
          batches_equal_to_preload_yes=f"{sum(same)} of {len(same)}",
          cut=f"shards from seed {SEED} ({IMAGENET_SHARDS[64][0]} train); {IMAGENET_STEPS} steps; 1 eval batch of "
              "128 a split; no sanity validation, no plots, no test pass")
    del gathered, eager, want
    gc.collect()
    torch.cuda.empty_cache()

    # ------------------------------------- [parallel.launch]: the entry point over NCCL
    # python -m bsi_torch.train's main in a process of its own (chip_smoke.py
    # --child train), twice: with the torchrun variables of one node and one
    # GPU (bsi_torch/utils/launcher.py::torchrun_env) and without any. FSDP
    # on, imagenet32 (DiT-L/2, BSI) at full width, f32; a profile of the
    # second step (trainer.profile_steps); the checkpoint then restored here,
    # without a process group.
    from bsi_torch.scripts._common import load_trainer
    from bsi_torch.train import load_checkpoint_config
    from bsi_torch.utils.launcher import torchrun_env

    import socket

    def child(label: str, env: dict) -> tuple[dict, Path, list[dict], float]:
        run_root = imagenet_root / label
        run_root.mkdir(parents=True, exist_ok=True)
        out = run_root / "child.json"
        args = ["experiment=imagenet32", "task=bsi", sweep_seed, f"data.root={imagenet_root / 'data32'}",
                f"data.batch_size={PARALLEL_BATCH}", f"data.eval_batch_size={PARALLEL_BATCH}",
                "trainer.accumulate_grad_batches=1", f"trainer.max_steps={PARALLEL_STEPS}",
                f"trainer.val_check_interval={PARALLEL_STEPS}", "trainer.log_every_n_steps=1",
                "trainer.limit_eval_batches=1", "trainer.num_sanity_val_steps=0", "trainer.plots=no",
                "eval_testset=no", "trainer.fsdp=yes", "trainer.profile_steps=1",
                f"run_root={run_root}"]
        environ = {k: v for k, v in os.environ.items() if k not in torchrun_env()}
        t0 = time.perf_counter()
        with open(run_root / "console.log", "w") as log:
            proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--child", "train", str(out), *args],
                                  env={**environ, **env}, stdout=log, stderr=subprocess.STDOUT, timeout=900)
        wall = time.perf_counter() - t0
        if proc.returncode != 0:
            print((run_root / "console.log").read_text()[-4000:], file=sys.stderr)
            raise AssertionError(f"parallel.launch {label}: the child exited {proc.returncode}")
        (run_dir,) = [q.parent for q in run_root.glob("**/metrics.jsonl")]
        records = [json.loads(line) for line in (run_dir / "metrics.jsonl").read_text().splitlines()]
        return json.loads(out.read_text()), run_dir, records, wall

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    nccl, nccl_dir, nccl_records, nccl_wall = child("parallel_nccl", torchrun_env(master_port=port))
    alone, alone_dir, alone_records, alone_wall = child("parallel_alone", {})
    # launches: the train steps run K2 and K3 once a block, K4f and K4b twice;
    # the validation's two splits two forwards each (BSI)
    forwards = PARALLEL_STEPS + 2 * 2
    want_launches = {name: 0 for name in COUNTER_NAMES}
    want_launches.update(flash_attention_fused=K2_PER_FORWARD * forwards,
                         layernorm_modulate_fwd=K4F_PER_FORWARD * forwards, flash_attention_fused_bwd=K3_PER_STEP * PARALLEL_STEPS,
                         layernorm_modulate_bwd=K4B_PER_STEP * PARALLEL_STEPS)
    for label, got in (("nccl", nccl), ("alone", alone)):
        if got["launches"] != want_launches:
            raise AssertionError(f"parallel.launch {label} launches {got['launches']}, want {want_launches}")
    if nccl["backend"] != "nccl" or nccl["world"] != 1 or alone["backend"] is not None:
        raise AssertionError(f"parallel.launch backends: {nccl['backend']} x {nccl['world']}, {alone['backend']}")
    collectives = nccl_events(nccl_dir / "profile" / "trace.json")
    if not (any("all_gather" in n for n in collectives) and any("reduce_scatter" in n for n in collectives)):
        raise AssertionError(f"parallel.launch: the profile shows no NCCL all-gather and reduce-scatter: {collectives}")
    in_alone = nccl_events(alone_dir / "profile" / "trace.json")
    series = lambda records, key: [r[key] for r in records if key in r]
    same_metrics = {key: series(nccl_records, key) == series(alone_records, key) and len(series(alone_records, key))
                    for key in ("train/loss", "train/grad_norm", "val/bpd", "train/bpd")}
    a = torch.load(nccl_dir / "ckpt_last" / "state.pt", weights_only=True)
    c = torch.load(alone_dir / "ckpt_last" / "state.pt", weights_only=True)
    differing = [f"{part}.{name}" for part in ("params", "ema_params") for name in c[part]
                 if not torch.equal(a[part][name], c[part][name])]
    differing += [f"opt_state.{m}.{name}" for m in ("mu", "nu") for name in c["opt_state"][m]
                  if not torch.equal(a["opt_state"][m][name], c["opt_state"][m][name])]
    n_tensors = 2 * len(c["params"]) + 2 * len(c["opt_state"]["mu"])
    del a
    if differing or not all(same_metrics.values()):
        raise AssertionError(f"parallel.launch: {len(differing)} of {n_tensors} tensors differ ({differing[:5]}), "
                             f"metrics equal {same_metrics}")
    # the checkpoint of the NCCL run restored here, without a process group
    gc.collect()
    torch.cuda.empty_cache()
    restored, _, _ = load_trainer(str(nccl_dir / "ckpt_last"), run_dir=imagenet_root / "parallel_restore")
    restore_equal = restored.layout is None and restored.state.step == PARALLEL_STEPS and all(
        torch.equal(p.detach().cpu(), c["params"][name]) for name, p in restored.state.params.items())
    fsdp_in_config = load_checkpoint_config(nccl_dir / "ckpt_last")["trainer"]["fsdp"]
    alone_names = set(c["params"])
    del restored, c
    gc.collect()
    torch.cuda.empty_cache()
    if not restore_equal or not fsdp_in_config:
        raise AssertionError(f"parallel.launch: restore without a group: equal {restore_equal}, fsdp {fsdp_in_config}")
    rates = {label: series(records, "train/steps_per_sec") for label, records in (("nccl", nccl_records),
                                                                                     ("alone", alone_records))}
    phase("parallel.launch", entry="bsi_torch.train.__main__.main in a process of its own", recipe="imagenet32",
          task="bsi", model="DiT-L/2, dim 1024, depth 24, 16 heads of 64, dropout 0.05", dtype="float32", tf32=False,
          layout="fsdp, WORLD_SIZE=1", backend=nccl["backend"], batch=PARALLEL_BATCH, steps=PARALLEL_STEPS,
          cut=f"batch {PARALLEL_BATCH} (not 8x64), {PARALLEL_STEPS} steps, one validation over one eval batch of "
              f"{PARALLEL_BATCH} a split, no plots, no test pass",
          nccl_device_events=collectives, nccl_device_events_without_group=in_alone,
          bit_equal_to_no_group=not differing, compared=f"{n_tensors} tensors (params, EMA, mu, nu)",
          **{f"{key.replace('/', '_')}_equal": bool(v) for key, v in same_metrics.items()},
          loss=[f"{x:.9g}" for x in series(nccl_records, "train/loss")],
          grad_norm=[f"{x:.9g}" for x in series(nccl_records, "train/grad_norm")],
          ms_per_step={label: [f"{1e3 / r:.1f}" for r in rs] for label, rs in rates.items()},
          peak_mem_gib={"nccl": f"{nccl['peak_bytes'] / 2**30:.3f}", "alone": f"{alone['peak_bytes'] / 2**30:.3f}"},
          wall_s={"nccl": f"{nccl_wall:.1f}", "alone": f"{alone_wall:.1f}"}, restored_without_group=restore_equal,
          launches={k: v for k, v in nccl["launches"].items() if v})
    path_launches["parallel_launch"] = nccl["launches"]
    # the two runs' four checkpoints (7.7 GB each) leave the disk: the card's
    # machine holds the disk's high-water mark to 45 GiB
    for label in ("parallel_nccl", "parallel_alone"):
        shutil.rmtree(imagenet_root / label, ignore_errors=True)

    # --------------------------- [parallel.gloo2]: two ranks on the one card, gloo
    store = imagenet_root / "gloo2_store"
    outs = [imagenet_root / f"gloo2_rank{r}.json" for r in range(2)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--child", "gloo2", str(r), str(store),
                               str(outs[r])], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    try:
        logs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    gloo2_wall = time.perf_counter() - t0
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            print(log[-4000:], file=sys.stderr)
            raise AssertionError(f"parallel.gloo2: rank {r} exited {p.returncode}")
    ranks = [json.loads(o.read_text()) for o in outs]
    g0, g1 = ranks
    gloo2_launches = {name: 0 for name in COUNTER_NAMES}
    gloo2_launches.update(flash_attention_fused=GLOO2_DEPTH * PARALLEL_STEPS,
                          flash_attention_fused_bwd=GLOO2_DEPTH * PARALLEL_STEPS,
                          layernorm_modulate_fwd=2 * GLOO2_DEPTH * PARALLEL_STEPS,
                          layernorm_modulate_bwd=2 * GLOO2_DEPTH * PARALLEL_STEPS)
    if not all(v == "ok" for v in g0["probe"].values()):
        raise AssertionError(f"parallel.gloo2: collectives {g0['probe']}")
    for case, sp, dropout in GLOO2_CASES:
        c0, c1 = g0["cases"][case], g1["cases"][case]
        rel = lambda key: max(abs(t[key] - o[key]) / abs(o[key]) for t, o in zip(c0["layout"], c0["base"]))
        ok = (c0["layout"] == c1["layout"] and c0["launches"] == c1["launches"] == gloo2_launches
              and rel("train/loss") <= 1e-5 and rel("train/grad_norm") <= 1e-5
              and c0["worst_rms_over_lr_sum"] <= 1e-3)
        phase("parallel.gloo2", case=case, ranks=2, device="cuda:0 (both)", backend="gloo",
              layout="tp 2 + sp" if sp else "tp 2", model=f"DiT-L/2 cut to depth {GLOO2_DEPTH}",
              dropout=dropout or "off", dtype="float32", tf32=False, batch=GLOO2_BATCH, steps=PARALLEL_STEPS,
              collectives=g0["probe"], loss_rel_err=f"{rel('train/loss'):.3e}",
              grad_norm_rel_err=f"{rel('train/grad_norm'):.3e}", tol="1e-5; leaves' RMS 1e-3 of Adam's largest move",
              worst_leaf_rms_over_lr_sum=f"{c0['worst_rms_over_lr_sum']:.3e}", worst_leaf=c0["worst_leaf"],
              ranks_equal=c0["layout"] == c1["layout"], local_numel=c0["local_numel"],
              full_numel=c0["full_numel"], launches_per_rank={k: v for k, v in c0["launches"].items() if v},
              wall_s=f"{gloo2_wall:.1f}")
        if not ok:
            raise AssertionError(f"parallel.gloo2 {case}: {[r['cases'][case] for r in ranks]}")
    path_launches["parallel_gloo2"] = g0["cases"]["tp_sp"]["launches"]

    # ------------------------- [pipeline.gloo2]: two pipeline stages on the one card
    # The one-process runs first, here; their final parameters go to disk for
    # the stages to hold theirs to.
    pipe_dir = imagenet_root / "pipeline"
    pipe_dir.mkdir()
    pipe_refs = {}
    for case, dropout, seed, _ in PIPE_CASES[:2]:
        metrics, params, launches, peak, ms = pipe_steps(dev, None, dropout, seed)
        torch.save({n: p.cpu() for n, p in params.items()}, pipe_dir / f"{case}.pt")
        pipe_refs[case] = {"metrics": metrics, "peak_bytes": peak, "ms": ms}
        del params
        gc.collect()
        torch.cuda.empty_cache()
    outs = [pipe_dir / f"rank{r}.json" for r in range(PIPE_STAGES)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--child", "pipe2", str(r),
                               str(pipe_dir / "store"), str(pipe_dir), str(outs[r])], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(PIPE_STAGES)]
    try:
        logs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    pipe_wall = time.perf_counter() - t0
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            print(log[-4000:], file=sys.stderr)
            raise AssertionError(f"pipeline.gloo2: rank {r} exited {p.returncode}")
    stages = [json.loads(o.read_text()) for o in outs]
    per_stage = DIT_L2["depth"] // PIPE_STAGES * PIPE_MICRO * PIPE_STEPS
    pipe_launches = {name: 0 for name in COUNTER_NAMES}
    pipe_launches.update(flash_attention_fused=per_stage, flash_attention_fused_bwd=per_stage,
                         layernorm_modulate_fwd=2 * per_stage, layernorm_modulate_bwd=2 * per_stage)
    if not all(st["probe"]["send_recv"] and st["probe"]["broadcast_bf16"] for st in stages):
        raise AssertionError(f"pipeline.gloo2: transfers {[st['probe'] for st in stages]}")
    rel = lambda got, want, key: max(abs(g[key] - w[key]) / abs(w[key]) for g, w in zip(got, want))
    for case, dropout, seed, remat in PIPE_CASES:
        c0, c1 = (st["cases"][case] for st in stages)
        # remat runs each block's forward again in the backward: K2 and K4f twice
        want_launches = dict(pipe_launches, flash_attention_fused=2 * per_stage,
                             layernorm_modulate_fwd=4 * per_stage) if remat else pipe_launches
        ok = (c0["metrics"] == c1["metrics"] and c0["launches"] == c1["launches"] == want_launches
              and c0["finite"] and c1["finite"])
        fields = {}
        if case in PIPE_REFS:
            want = pipe_refs[PIPE_REFS[case]]["metrics"]
            fields = dict(loss_rel_err=f"{rel(c0['metrics'], want, 'train/loss'):.3e}",
                          grad_norm_rel_err=f"{rel(c0['metrics'], want, 'train/grad_norm'):.3e}",
                          worst_leaf_rms_over_lr_sum=[f"{c['worst_rms_over_lr_sum']:.3e}" for c in (c0, c1)],
                          worst_leaf=[c["worst_leaf"] for c in (c0, c1)],
                          held_to=f"one process, {PIPE_REFS[case]}, no remat",
                          one_process_peak_gib=f"{pipe_refs[PIPE_REFS[case]]['peak_bytes'] / 2**30:.3f}",
                          one_process_ms_per_step=[f"{x:.1f}" for x in pipe_refs[PIPE_REFS[case]]["ms"]],
                          tol="1e-5; leaves' RMS 1e-3 of Adam's largest move")
            ok = ok and (rel(c0["metrics"], want, "train/loss") <= 1e-5
                         and rel(c0["metrics"], want, "train/grad_norm") <= 1e-5
                         and max(c0["worst_rms_over_lr_sum"], c1["worst_rms_over_lr_sum"]) <= 1e-3)
        if case == "dropout_again":
            fields["bit_equal_to_dropout"] = (c0["metrics"] == stages[0]["cases"]["dropout"]["metrics"]
                                              and c0["params_equal_to_dropout"] and c1["params_equal_to_dropout"])
            ok = ok and fields["bit_equal_to_dropout"]
        if case == "dropout_seed2":
            fields["differs_from_seed1"] = c0["metrics"] != stages[0]["cases"]["dropout"]["metrics"]
            ok = ok and fields["differs_from_seed1"]
        phase("pipeline.gloo2", case=case, ranks=PIPE_STAGES, device="cuda:0 (both)", backend="gloo",
              model="DiT-L/2, dim 1024, depth 24 (12 blocks a stage), 16 heads of 64", dropout=dropout or "off",
              remat=remat,
              dropout_seed=seed, dtype="float32", tf32=False, batch=PIPE_BATCH, microbatches=PIPE_MICRO,
              steps=PIPE_STEPS, transfers_by_rank=[st["probe"] for st in stages], loss=[f"{m['train/loss']:.9g}" for m in c0["metrics"]],
              ranks_equal=c0["metrics"] == c1["metrics"], held_leaves=[c0["held"], c1["held"]],
              peak_gib=[f"{c['peak_bytes'] / 2**30:.3f}" for c in (c0, c1)],
              ms_per_step=[[f"{x:.1f}" for x in c["ms"]] for c in (c0, c1)], **fields,
              launches_per_rank={k: v for k, v in c0["launches"].items() if v}, wall_s=f"{pipe_wall:.1f}")
        if not ok:
            raise AssertionError(f"pipeline.gloo2 {case}: {[st['cases'][case] for st in stages]} "
                                 f"against {pipe_refs.get(PIPE_REFS.get(case))}")
    path_launches["pipeline_gloo2"] = stages[0]["cases"]["off"]["launches"]
    shutil.rmtree(pipe_dir, ignore_errors=True)

    # ---------------- [pipeline.launch]: the entry point over two pipeline stages
    # python -m bsi_torch.train's main in two processes on cuda:0, each joined
    # to gloo first (chip_smoke.py --child pipe_train): [parallel.launch]'s
    # run without FSDP and the profile, at trainer.pipeline_parallelism=2,
    # pp_microbatches=4; held to [parallel.launch]'s run without a group, then
    # its checkpoint restored here in one process.
    launch_root = imagenet_root / "pipeline_launch"
    launch_root.mkdir()
    args = ["experiment=imagenet32", "task=bsi", sweep_seed, f"data.root={imagenet_root / 'data32'}",
            f"data.batch_size={PARALLEL_BATCH}", f"data.eval_batch_size={PARALLEL_BATCH}",
            "trainer.accumulate_grad_batches=1", f"trainer.max_steps={PARALLEL_STEPS}",
            f"trainer.val_check_interval={PARALLEL_STEPS}", "trainer.log_every_n_steps=1",
            "trainer.limit_eval_batches=1", "trainer.num_sanity_val_steps=0", "trainer.plots=no",
            "eval_testset=no", f"trainer.pipeline_parallelism={PIPE_STAGES}", f"trainer.pp_microbatches={PIPE_MICRO}",
            f"run_root={launch_root}"]
    outs = [launch_root / f"rank{r}.json" for r in range(PIPE_STAGES)]
    environ = {k: v for k, v in os.environ.items() if k not in torchrun_env()}
    t0 = time.perf_counter()
    logs = [open(launch_root / f"console{r}.log", "w") for r in range(PIPE_STAGES)]
    procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--child", "pipe_train", str(r),
                               str(launch_root / "store"), str(outs[r]), *args], env=environ, stdout=logs[r],
                              stderr=subprocess.STDOUT) for r in range(PIPE_STAGES)]
    try:
        for p in procs:
            p.wait(timeout=900)
    finally:
        for p, log in zip(procs, logs):
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    launch_wall = time.perf_counter() - t0
    for r, p in enumerate(procs):
        if p.returncode != 0:
            print((launch_root / f"console{r}.log").read_text()[-4000:], file=sys.stderr)
            raise AssertionError(f"pipeline.launch: rank {r} exited {p.returncode}")
    ranks = [json.loads(o.read_text()) for o in outs]
    forwards = PARALLEL_STEPS + 2 * 2
    per_stage = DIT_L2["depth"] // PIPE_STAGES * PIPE_MICRO
    want_launches = {name: 0 for name in COUNTER_NAMES}
    want_launches.update(flash_attention_fused=per_stage * forwards, layernorm_modulate_fwd=2 * per_stage * forwards,
                         flash_attention_fused_bwd=per_stage * PARALLEL_STEPS,
                         layernorm_modulate_bwd=2 * per_stage * PARALLEL_STEPS)
    for r, got in enumerate(ranks):
        if got["rc"] != 0 or got["launches"] != want_launches or got["backend"] != "gloo" or got["world"] != 2:
            raise AssertionError(f"pipeline.launch rank {r}: {got}, want launches {want_launches}")
    (pipe_run,) = [q.parent for q in launch_root.glob("**/metrics.jsonl")]
    pipe_records = [json.loads(line) for line in (pipe_run / "metrics.jsonl").read_text().splitlines()]
    rels = {}
    for key in ("train/loss", "train/grad_norm", "val/bpd", "train/bpd"):
        got, want = series(pipe_records, key), series(alone_records, key)
        rels[key] = max(abs(g - w) / abs(w) for g, w in zip(got, want)) if got and len(got) == len(want) else None
    if not all(v is not None and v <= 1e-5 for v in rels.values()):
        raise AssertionError(f"pipeline.launch against the run without a group: {rels}")
    # the checkpoint (rank 0's, gathered over the pipe) restored in one process
    gc.collect()
    torch.cuda.empty_cache()
    saved = torch.load(pipe_run / "ckpt_last" / "state.pt", mmap=True, weights_only=True)
    restored, _, _ = load_trainer(str(pipe_run / "ckpt_last"), [f"trainer.pipeline_parallelism=1"],
                                  run_dir=imagenet_root / "pipeline_restore")
    restore_equal = (restored.layout is None and restored.state.step == PARALLEL_STEPS
                     and set(saved["params"]) == alone_names == set(restored.state.params)
                     and all(torch.equal(t.detach().cpu(), saved[part][name])
                             for part, named in (("params", restored.state.params),
                                                 ("ema_params", restored.state.ema_params))
                             for name, t in named.items())
                     and all(torch.equal(t.cpu(), saved["opt_state"][m][name])
                             for m, named in (("mu", restored.state.opt_state.mu), ("nu", restored.state.opt_state.nu))
                             for name, t in named.items()))
    pipe_config = load_checkpoint_config(pipe_run / "ckpt_last")["trainer"]
    del restored, saved
    gc.collect()
    torch.cuda.empty_cache()
    if not restore_equal or pipe_config["pipeline_parallelism"] != PIPE_STAGES:
        raise AssertionError(f"pipeline.launch: restore in one process: equal {restore_equal}, config {pipe_config}")
    phase("pipeline.launch", entry="bsi_torch.train.__main__.main in two processes on cuda:0 over gloo",
          recipe="imagenet32", task="bsi", model="DiT-L/2, dim 1024, depth 24, 16 heads of 64, dropout 0.05",
          dtype="float32", tf32=False, layout=f"pipeline_parallelism={PIPE_STAGES}, pp_microbatches={PIPE_MICRO}",
          batch=PARALLEL_BATCH, steps=PARALLEL_STEPS,
          cut=f"as [parallel.launch]: batch {PARALLEL_BATCH}, {PARALLEL_STEPS} steps, one validation over one eval "
              f"batch a split, no plots, no test pass",
          **{f"{key.replace('/', '_')}_rel_err_vs_no_group": f"{v:.3e}" for key, v in rels.items()}, tol="1e-5",
          loss=[f"{x:.9g}" for x in series(pipe_records, "train/loss")],
          ms_per_step=[f"{1e3 / r:.1f}" for r in series(pipe_records, "train/steps_per_sec")],
          ms_per_step_no_group=[f"{1e3 / r:.1f}" for r in series(alone_records, "train/steps_per_sec")],
          peak_mem_gib=[f"{got['peak_bytes'] / 2**30:.3f}" for got in ranks],
          peak_mem_gib_no_group=f"{alone['peak_bytes'] / 2**30:.3f}", wall_s=f"{launch_wall:.1f}",
          restored_in_one_process_bit_for_bit=restore_equal, launches_per_rank={k: v for k, v in
                                                                                ranks[0]["launches"].items() if v})
    path_launches["pipeline_launch"] = ranks[0]["launches"]
    shutil.rmtree(imagenet_root, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()

    # ------------------------------ [soak]: python -m bsi_torch.scripts.soak_test
    # The kill-and-requeue soak in a process of its own, which starts
    # python -m bsi_torch.train twice (SOAK_* above): every assertion of the
    # soak, the steps/s drift check included, each run with at least 15
    # rate windows.
    soak_root = Path(tempfile.mkdtemp(prefix="bsi_torch_soak_"))
    repo = Path(__file__).resolve().parent
    t0 = time.perf_counter()
    soak = subprocess.run([sys.executable, "-m", "bsi_torch.scripts.soak_test", "--max-steps", str(SOAK_STEPS),
                           "--kill-at", str(SOAK_STEPS // 2), "--batch", str(SOAK_BATCH), "--n-train",
                           str(SOAK_N_TRAIN), "--root", str(soak_root / "root"), "--out", str(soak_root / "soak.json")],
                          cwd=repo, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, timeout=600)
    soak_s = time.perf_counter() - t0
    if soak.returncode != 0:
        print(soak.stdout[-4000:], file=sys.stderr)
        raise AssertionError(f"soak_test exited {soak.returncode}")
    timeline = json.loads((soak_root / "soak.json").read_text())
    rates = timeline["steps_per_sec"]
    if not (rates["run1_windows"] >= 15 and rates["run2_windows"] >= 15 and "drift" in rates):
        raise AssertionError(f"soak: the drift check did not run: {rates}")
    events = {e["event"]: e for e in timeline["events"]}
    phase("soak", entry="python -m bsi_torch.scripts.soak_test", model="UNet dim 128, 32 levels, dropout 0.1, "
          "pos_emb_mult 4", dtype="float32", batch=SOAK_BATCH, max_steps=SOAK_STEPS, kill_at=SOAK_STEPS // 2,
          cut=f"batch {SOAK_BATCH} (128), {SOAK_STEPS} steps (50,000), kill at {SOAK_STEPS // 2} (25,000), "
              f"{SOAK_N_TRAIN} train images (50,000)",
          events=[(e["event"], e["t"]) for e in timeline["events"]],
          interrupt_step=events["interrupt_ckpt_verified"]["step"],
          cursor=events["interrupt_ckpt_verified"]["cursor_examples"],
          final_cursor=events["continuation_verified"]["cursor_examples"],
          run1_median_steps_per_s=f"{rates['run1_median']:.4f}", run2_median_steps_per_s=f"{rates['run2_median']:.4f}",
          drift=f"{rates['drift']:.4f}", windows=(rates["run1_windows"], rates["run2_windows"]), wall_s=f"{soak_s:.1f}")
    shutil.rmtree(soak_root, ignore_errors=True)

    # --------------- [bench.parallel]: torchrun -m bsi_torch.scripts.bench_parallel
    # --dp 1 over NCCL at one rank, DiT-L/2 (BENCH_PARALLEL_STEPS steps), with
    # and without FSDP, beside [dit.train]'s examples/s.
    for fsdp in (False, True):
        t0 = time.perf_counter()
        launched = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "1",
                                   "-m", "bsi_torch.scripts.bench_parallel", "--dp", "1", "--steps",
                                   str(BENCH_PARALLEL_STEPS)] + (["--fsdp"] if fsdp else []),
                                  cwd=repo, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, timeout=600)
        if launched.returncode != 0:
            print(launched.stdout[-4000:], launched.stderr[-4000:], file=sys.stderr)
            raise AssertionError(f"bench_parallel exited {launched.returncode}")
        record = json.loads(launched.stdout.strip().splitlines()[-1])
        if not (math.isfinite(record["value"]) and record["value"] > 0
                and record["device"] == torch.cuda.get_device_name(0)):
            raise AssertionError(f"bench_parallel: {record}")
        phase("bench.parallel", fsdp=fsdp, record=json.dumps(record), steps=BENCH_PARALLEL_STEPS,
              dit_train_examples_per_s=f"{dit_rec['value']:.3f}", call_s=f"{time.perf_counter() - t0:.1f}")

    # Each kernel's launches on the main path that runs it (K6f, K6b: none does).
    for entry in kernels:
        entry["launches_by_path"] = {path: counts[entry["name"]] for path, counts in path_launches.items()}
        entry["launches"] = max(entry["launches_by_path"].values())

    # The library's backwards, each the median of its kernels' summed device
    # time from a profile (library_bwd_ms), the L2 flushed between calls by
    # an in-place bitwise not, whose kernel no backward launches. After
    # every timed path, so that none runs after the profiler.
    scrub = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    for label, entry, make in library_backwards:
        entry["library_ms"], entry["library_kernels"], entry["library_calls"] = library_bwd_ms(
            make(), scrub.bitwise_not_)
        phase("library.bwd", kernel=repr(label), library_ms=entry["library_ms"],
              calls=f"{entry['library_calls']} of 30", kernels=entry["library_kernels"])
    for label, entry, call in device_times:
        entry["device_ms"], entry["device_kernels"], entry["device_calls"] = library_bwd_ms(call, scrub.bitwise_not_)
        if label == "k4b" and len(entry["device_kernels"]) != 1:
            raise AssertionError(f"K4b launched {entry['device_kernels']} a call, not one kernel")
        phase("kernel.device", kernel=repr(label), device_ms=entry["device_ms"],
              calls=f"{entry['device_calls']} of 30", kernels=entry["device_kernels"])
    del scrub, library_backwards, device_times
    # Which SDPA kernel serves K5f's f32 yardstick, profiled last so that no
    # timed path runs after the profiler.
    q32, k32, v32 = (randn(EVAL_BATCH, 1, s16, d16) for _ in range(3))
    k5f["at_f32_eval_shape"]["library_kernels"] = cuda_kernel_names(
        lambda: F.scaled_dot_product_attention(q32, k32, v32))
    phase("k5f.library_f32", kernels=k5f["at_f32_eval_shape"]["library_kernels"],
          max_abs_err_vs_fwd_math=f"{k5f['at_f32_eval_shape']['library_max_abs_err']:.3e}",
          within_1e_5=k5f["at_f32_eval_shape"]["library_within_1e_5"])
    # The bench's combined record (bsi_torch/bench.py) from this run's rows,
    # cut as the phases say.
    print("[bench] " + json.dumps(bench.combine(bench_rows)), flush=True)
    phase("card.end", sm_clock=repr(sm_clock()), script_s=f"{time.perf_counter() - script_start:.1f}")
    print(json.dumps({"kernels": kernels}))
    print(f"card: {smi}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
