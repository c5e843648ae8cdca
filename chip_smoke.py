#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port, on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It builds the CUDA GDN kernels (``nvcc``) and the C++ arithmetic coder
(``make``) from the sources in the checkout, then runs these phases:

1. the card (``nvidia-smi`` name and power limit) and the versions;
2. every kernel variant against its plain PyTorch version at the main
   paths' shapes (serving, a 4 x 512 x 768 batch: rows 98,304 at H/4 and
   24,576 at H/8 for GDN/IGDN in fp32 and bf16, 6,144 at H/16 for
   GDN/IGDN in fp32 and GDN+quantise; the bench's batch of 24: rows
   589,824 and 147,456 for all four, 36,864 for IGDN in fp32; training, a
   10 x 256 x 256 batch: rows 40,960, 10,240 and 2,560 for GDN/IGDN in
   fp32; one of two shards of the serving batch, or the tooling's two images:
   rows 49,152, 12,288 and 3,072; the tooling's 16 x 16 probe latent: rows
   4,096, 1,024 and 256 for IGDN in fp32), and at ragged row counts; the
   stacked fp32 kernel (the gamma ladder's GDN sites, one launch for all
   its models) at 7 x 40,960, 7 x 10,240 and 7 x 2,560 rows, one model
   at the same rows (a one-model training step, and a sharded ladder's
   block of one model at 1 x 2,560) and a ragged 7 x 40,997, each
   model of it equal to the single-model kernel on the same rows bit for
   bit; then the gradient of the fp32 kernel's ``GdnFunction`` (the
   kernel forward, the gradient kernel backward) against autograd through
   the plain version, and the gradient kernel (``gdn_backward``) against
   its plain twin at every training site's rows, one model and the
   seven-model ladder, each gradient within 1e-4 of its largest entry,
   two calls equal bit for bit, timed replayed and eager beside the twin
   and three times the forward's bound; then Adam's kernel
   (``csrc/adam.cu``) at each training path's leaves (one model's 19 and
   23, the seven-model ladder's 23 stacked with three rates apart, the
   hyperprior's and the joint prior's one vector at their constant rate)
   against its plain twin,
   every output equal bit for bit, one launch a step, timed replayed and
   eager beside the twin and its bytes bound;
3. serving: ``PipelinedCompressor`` (bf16w+, then fp32) over the 24
   synthetic Kodak-shaped images on the trained learned-bin-width model
   and its statistics at multiplier 1, true bitstreams, verified;
   then the decoder's precision mixes at multipliers 1, 4 and 10 (the
   gate table) and the device's own time per batch; fails if bf16w+'s
   worst image is more than 0.05 dB below fp32 at any of the three;
   then three fp32 decodes of the same symbols, which must be equal (the
   transposed convs as forward convs into their output phases), and the
   fp32 decode's ms a batch of 4 and of 24 in that form and as
   ``conv_transpose2d``;
4. the fixed-bin-width ``roundtrip_batched`` (fused GDN+quantise);
5. training at full width, both architectures (learned and fixed bin
   widths), on synthetic 256 x 256 crops at batch 10: a fresh state, one
   density pre-fit epoch, three epochs of 12 ``train_step``s, the pre-fit
   and the epochs each the replays of one captured step
   (``train/epoch_graph.py``; the pre-fit's GDN launches counted at its
   capture, two steps' encodes); fails unless
   the density loss falls over the pre-fit, the rate-distortion loss of
   ``evaluation`` (same noise) falls over the steps, the projections
   hold, the gradient of the loss through the kernels agrees with the
   gradient through plain GDN, and one ``train_step`` launches the
   expected kernels (the stacked kernel at one model's rows: one model
   trains as a stack of one). Then the graphed epoch against the eager loop from
   one state: one step within 1e-4 of each leaf's largest entry (per-batch
   noise, and a generator where a graph's draws equal the eager ones,
   which is checked first), one of two graphed epochs of 12 steps within
   the spread of five eager epochs (measured and printed), the returned
   state untouched by the next epoch, no GDN launch counted at a replay;
   ms per step graphed and eager, the device's busy share in the graphed
   epoch, the captures' seconds and graph pools; the same for the
   pre-fit epoch (``fit_epoch``, 12 batches in order; a density fit, which
   amplifies no rounding, holds its 12 steps to the one-step bound, the
   spread printed beside it). Then: checkpoint saved
   and loaded back equal, a
   params artifact, ``collect_stats`` on held-out crops, and a few
   images served through ``PipelinedCompressor`` with those statistics,
   verified. Prints ms per ``train_step`` and per phase, steps/s, the
   GDN kernels' share and the device's busy share;
6. the gamma ladder at full width: ``cli/train_ladder`` trains the seven
   models of ``GAMMAS_DEFAULT`` on shared batches of 10 synthetic
   256 x 256 crops (part 0: one pre-fit epoch and one epoch of 12 ladder
   steps; part 1 resumed from part 0's seven checkpoints), one program
   over the seven models a step. Fails unless every model's density loss
   falls over the pre-fit and its rate-distortion loss over the steps,
   the models differ from each other, the bin widths stay put, a ladder
   ``train_step`` launches the stacked kernel 6 + 3 times (one launch a
   GDN site for all seven models), one stacked step is within the JAX
   package's bounds of seven single-model steps on the same batch and
   noise (each parameter within 5e-4, more than 99.5 % of a leaf within
   2e-6, the density table within rtol 5e-4 / atol 1e-4, the grids
   equal) and three within Adam's bound, part 0 refuses to be retrained
   and part 1 resumes at part 0's step. Prints ms per ladder
   ``train_step`` beside seven single-model steps, ladder-steps/s, the
   device's busy share and the kernels of a step in a profiler trace
   (cuDNN, GDN, the rest), and every conv site's fprop / dgrad / wgrad
   grouped over the models against seven convs on channel slices. Then
   the ladder's graphed epoch and graphed pre-fit against their eager
   loops, as in phase 5 (the pre-fit: 3 stacked launches a step, counted
   at its capture);
7. the rate-distortion study on the committed trained models and the 24
   images of ``synthetic_kodak(seed=14)``, through ``eval/rd_sweep``: the
   one-model-per-gamma family (entropy rates) and both multiplier
   families (true coded rates from the arithmetic coder). Fails unless
   every image's PSNR is within 0.05 dB, every point's mean rate within
   1 % (every image's within 2 %) and 99 % of the dead-map counts equal
   to the committed curves under ``results/eae/kodak_rd/``, a second call
   comes from the cache without a launch, the launches are 396 + 396 and
   the Bjontegaard savings against the committed JPEG2000 curve are
   within 0.5 points of the committed ones. ``cli/reconstruct_kodak`` is
   driven too over the same cache where PIL is there: ``main`` with
   matplotlib, else its ``compute`` half (printed either way);
7b. the rest of serving and the bench: "bf16w" and "int8" through
   ``PipelinedCompressor`` (verified; both are expected to miss the gate,
   printed either way); ``fast_decode_fixed_bw`` at tails 0 and 3 against
   the fp32 decode (tail 3 within 1e-3 of the pixel range, tail 0 no
   image more than 0.5 dB under it); three "bf16w+" decodes of the same
   latents equal with ``torch.backends.cudnn.deterministic`` False at
   every conv, and tconv_4's ms a batch of 4 and of 24 in the engine's
   phase form beside ``conv_transpose2d`` with cuDNN's default and
   deterministic algorithms; ``fast_roundtrip_scan`` eager against its CUDA graph
   (equal bit for bit, ms per K-batch program both ways);
   ``stream_roundtrip`` against ``roundtrip_batched`` (equal); the gate
   table through the scan path (fails unless the scan path's "bf16w+"
   mix is inside 0.05 dB at multipliers 1, 4 and 10); the serving bench
   in-process with 3 repeats, its JSON on a line of its own; the roofline
   report for "bf16w+" and fp32 against measured matmul ceilings;
7c. the gate on two more image sets (``synthetic_kodak`` seeds 15 and 16)
   through the scan path and the pipeline: fails unless both serving
   "bf16w+" mixes hold -0.05 dB on every image at multipliers 1, 4 and 10;
9. the distributed layer (run, as 10 to 12, before phase 8, which reports
   their kernels):
   (a) a world of one over NCCL: ``initialize``, ``make_global_mesh(1)``,
   ``global_state`` and 6 sharded ``train_step``s of both architectures at
   batch 10 of 256 x 256 from the trained weights, each held against the
   unsharded step from the same state with the same noise (the gradients
   within 1e-5 of each tensor's largest entry, the density table within
   2.6e-6, the bin widths within 1.1e-6, weights as the ladder's check),
   with ms per sharded and per unsharded step; (b) the height-sharded
   round trip of 4 images of 512 x 768 on a two-shard one-process mesh of
   the card, both trained architectures, against the unsharded one
   (largest gap under 5e-2 of a pixel level, quantised symbols equal);
   (c) ``PipelinedCompressor`` (fp32 and "bf16w+") and ``stream_roundtrip``
   over a two-shard data mesh on the 24 images: bit counts equal to the
   mesh-less path; (d) a ladder step of the seven models spread over a
   seven-shard mesh against the unsharded ladder step, then the sharded
   ladder's graphed epoch (one captured step a block, replayed on the
   block's device, block after block) against the blocks' eager loops in
   that order, as in phase 5; (e) ``cli/benchmark
   scaling`` and ``dryrun_multichip(2)``. Then every kernel against its
   plain version at each row count these paths launched it at;
10. the SVHN side at full width (3072-300-200, the VAE 3072-300-25) on
   ``synthetic_svhn(2000)`` at batch 250, where no GDN kernel runs: one
   ``training_fct`` and one ``training_eae_bw`` from one state and one
   ``eps``, card against the port's CPU run (each weight within 1e-6 +
   1e-5 |w|; density samples in another linear piece counted); the overfit
   harness (the objective must fall); ``cli/train_svhn`` for 3 epochs (the
   checkpoint loads back equal) and ``cli/reconstruct_svhn`` on it (the
   rate must not rise with the multiplier); ``cli/compare_entropy_approximations``
   at 20,000 samples card against CPU (within 1e-3 bits an entry), then at
   200,000 with its time; one VAE step card against CPU and ``cli/train_vae``
   train (-VLB must fall), reconstruct and generate; ms per alternation, per
   reference epoch of 800 batches and per VAE step, and the kernels' time
   in a profiler trace of each. Every step of these paths is the replays
   of a captured graph: the overfit harness and ``cli/train_svhn`` make two
   captures (pre-fit, alternation), ``cli/train_vae`` one (its checkpoint
   loads back at the expected step), the study one for its 8 fits; the
   study at 200,000 samples graphed against its fits run eagerly. Then
   the dense alternation, the dense pre-fit, the VAE step and the study's
   fit graphed against their eager loops, as in phase 5;
11. the latent-analysis tooling on both trained models, from full
   checkpoints in a temporary root, on ``synthetic_kodak(seed=14)``:
   ``cli/latent_analysis fit`` (finite positive scales, latents within
   rtol 1e-5 / atol 1e-4 of the CPU encode), the activation probe at
   (2, 2) and (8, 8) (translation covariant within one level), ``mask_maps``
   (against the CPU's decode), ``visualize_model``'s arrays, and
   ``import_reference_variables`` on a reference-named dict (decodes equal
   to the loaded model), with the GDN launches of each path; the
   image-writing command lines only where PIL and matplotlib import
   (printed either way). Then every kernel against its plain version at
   each row count these paths launched it at;
12. the campaign scripts at full width (128 maps, 256 x 256 crops at
   batch 10, the seven ladder gammas and the learned-bin-width model,
   the 24 images of ``synthetic_kodak(seed=14)``), in a temporary root,
   cut in counts only (40 training, 10 validation and 20 extra crops, 1
   epoch a part, 2 parts): (a) ``scripts/rd_campaign`` with
   ``--ladder_vmap``: ``main`` where matplotlib imports, else its stages
   in ``main``'s order with the study's compute half; fails unless all 8
   models finish part 2 at a later step than part 1, the statistics
   markers carry their exports' steps, the three families come out
   finite, the learned model's coded rate does not rise with the
   multiplier, a second call trains and launches nothing, and a third
   call after one ``model_2.json`` is marked interrupted retrains that
   model alone; seconds per stage, the training stage through graphed
   epochs (one capture a part, and one for part 0's pre-fit), the ladder's
   parts one stacked program a step; (b) ``scripts/stability_study``:
   ``average_gamma_params`` over (a)'s parts equal bit for bit to the
   float64 mean of the loaded checkpoints cast to float32, then the
   evaluation of the committed ``results/eae_avg/`` models held against
   ``results/eae/kodak_rd_stability/`` with phase 7's gates and the
   "vs JPEG2000" savings within 0.5 points; (c) one more part through
   ``scripts/resilient_campaign`` in fresh processes on the card (cool-down
   0), resuming at part 2's step; (d) the port's side of
   ``eval/reference_parity`` on both trained models (2 images of 64 x
   64), the TF graph replaced by a CPU stand-in: ``max_abs_delta_db`` at
   most 0.05. Then every kernel against its plain version at each row
   count these paths launched it at;
13. the scale hyperprior (``train/hyperprior.py``) at the paper's batch of
   8 crops of 256 x 256: the fp32 GDN and IGDN kernels at its sites' rows
   (131,072, 32,768 and 8,192) with a gamma that is not symmetric, against
   their plain versions (the transposed gamma must miss that tolerance
   100 times over) and timed, ``GdnFunction``'s gradients against
   autograd through the plain version and the gradient kernel against its
   twin, timed; then a graphed epoch of 3 batches from a fresh state: its
   capture launches 3 ``gdn_f32`` + 3 ``igdn_f32`` a step at those rows and
   as many ``*_backward``, and marks ``step, forward, entropy, synthesis,
   backward, optimizer, step_end``, a replay counts none, and one eager
   ``train_step`` launches 3 + 3 and 3 + 3 backwards;
14. Minnen et al.'s joint prior (``models/minnen2018.py``) at the same
   batch: the fp32 GDN and IGDN kernels at 192 channels at its sites' rows
   with a gamma that is not symmetric, against their plain versions (the
   transposed gamma missing by 100 times) and timed against their bound,
   the 192-channel gradient kernel against its twin, timed; then a graphed
   epoch of 3 batches from a fresh state: its capture launches 3
   ``gdn_f32_192`` + 3 ``igdn_f32_192`` a step at those rows, as many
   ``*_192_backward`` and twice as many ``gdn_backward_reduce_192``, no
   128-channel kernel, one Adam launch a step, and marks ``step, forward,
   entropy, context, synthesis, backward, optimizer, step_end``; a replay
   counts none, and one eager ``train_step`` launches a step's, from which
   the kernels line's 192-channel entries (``"channels": 192``) take their
   launches;
8. kernel times, bounds and launch counts: one ``{"kernels": [...]}`` line;
10. the result line ``{"ok": true, "device": {...}}``, last.

Launch counts are set to 0 just before each path and read just after.
Every GDN site differentiated on a path counts a ``*_backward`` launch
of the gradient kernel's tile pass and, as gamma and beta require grad
there, a ``gdn_backward_reduce`` launch of its reduction, so a training
step's counts show no backward in plain PyTorch. The kernels line's
``*_backward`` entries carry ``max_abs_err`` as every entry does (the
largest of the three gradients'), beside it ``max_gap_to_largest``, and
the reduction's launches and the two kernels' times apart where the
profiler's trace held every launch (``reduce_ms``, ``tile_pass_ms``;
null where it did not).
A wrapper counts where Python calls it, so a CUDA graph counts at its
warm-up batch and its capture and not at a replay: the expectations say
which numbers are per capture (a graphed training epoch: its warm-up
step and its capture, two steps' launches a capture). Adam's kernel
counts apart (``adam_kernel.LAUNCHES``, per ``(leaves, models)``): one
launch a training step in phases 5, 6, 9 (one a shard of the ladder over
seven shards), 12 and 13, two a capture, none a replay; the kernels line
ends with its entries, one a ``(leaves, models)`` of each training path,
their launches as that path's run counted them.
Any failure exits non-zero; so does a machine without a card. Imports
nothing of JAX.
"""

import collections
import contextlib
import glob
import hashlib
import importlib.util
import io
import itertools
import json
import os
import pickle
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from unittest import mock

import numpy
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
LEARNED = os.path.join(REPO, "results", "eae", "learning_bw", "0dot5_10000")
FIXED = os.path.join(REPO, "results", "eae", "fixed_bw", "1_10000")
PACKAGE = os.path.join(REPO, "autoencoder_based_image_compression_tpu_torch")
RESULTS_ROOT = os.path.join(REPO, "results", "eae")
COMMITTED_RD = os.path.join(RESULTS_ROOT, "kodak_rd")
KERNEL_SOURCE = "autoencoder_based_image_compression_tpu_torch/csrc/gdn.cu"
ADAM_SOURCE = "autoencoder_based_image_compression_tpu_torch/csrc/adam.cu"
TPU_KERNELS = "autoencoder_based_image_compression_tpu/ops/pallas/gdn_kernel.py"
# The GDN launches of one batch on each serving path: (variant, shape).
_ALL_BF16 = (("gdn_bf16", "H/4"), ("gdn_bf16", "H/8"), ("igdn_bf16", "H/8"),
             ("igdn_bf16", "H/4"))
GDN_SITES = {
    "bf16w+": (("gdn_f32", "H/4"), ("gdn_f32", "H/8"), ("igdn_f32", "H/8"),
               ("igdn_bf16", "H/4")),
    "fp32": (("gdn_f32", "H/4"), ("gdn_f32", "H/8"), ("igdn_f32", "H/8"),
             ("igdn_f32", "H/4")),
    "bf16w": _ALL_BF16, "int8": _ALL_BF16,
}
BF16_ULP = 2.0 ** -7
# Published peaks of one H100 SXM (NVIDIA data sheet, dense, at 700 W).
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
(BATCH, HEIGHT, WIDTH) = (4, 512, 768)
# The serving bench runs the 24 images as one batch, K = 8 batches a program.
(BENCH_BATCH, SCAN_BATCHES) = (24, 8)
# Timed launches walk round this many bytes of inputs and outputs at least
# (the L2 cache holds 50 MB), and the ragged check adds these rows to H/4.
TIMING_FOOTPRINT_BYTES = 128 << 20
RAGGED_EXTRA = 37
# Training: the reference's batch of 10 crops of 256 x 256.
(TRAIN_BATCH, TRAIN_CROP) = (10, 256)
TRAIN_GAMMA = 10000.0
DEVICE = "cuda"
(TRAIN_IMAGES, TRAIN_EPOCHS, EXTRA_IMAGES, SERVED_IMAGES) = (120, 3, 20, 4)
# The SVHN side at full width (3072-300-200, the VAE 3072-300-25): 2,000
# synthetic digits at batch 250; the reference trains 800 batches an epoch.
(SVHN_DIGITS, SVHN_BATCH, SVHN_EPOCHS, SVHN_REFERENCE_BATCHES) = (2000, 250, 3, 800)
(SVHN_GAMMA, ENTROPY_SAMPLES, ENTROPY_GAP_BITS) = (5.0, 20000, 1e-3)
# The tooling: a 16 x 16 probe latent (256 x 256 pixels), 4 images for the
# Laplace fit and the masking, 2 for visualize_model (the rows of a shard).
(PROBE_PIXELS, TOOL_IMAGES, VIEW_IMAGES) = (256 * 256, 4, BATCH // 2)
PROBE_SHIFT = 96  # pixels between the probe's positions (2, 2) and (8, 8)
# The campaign scripts (phase 12) at full width, cut in counts only:
# training, validation and extra crops, 1 epoch a part, 2 parts; the
# ladder model whose last part a third call retrains; the averaged models
# and the committed stability study; a part in a fresh process may take
# this long; the parity harness's 2 images of 64 x 64.
(CAMPAIGN_COUNTS, CAMPAIGN_PARTS, CAMPAIGN_RETRAINED) = ((40, 10, 20), 2, 72000.0)
CAMPAIGN_EXTRA_ARGS = []  # e.g. ["--smoke"] for a rehearsal on the CPU
AVG_ROOT = os.path.join(REPO, "results", "eae_avg")
COMMITTED_STABILITY = os.path.join(RESULTS_ROOT, "kodak_rd_stability")
RESILIENT_TIMEOUT_S = 600
(STATS_BATCH, PARITY_IMAGES, PARITY_PIXELS) = (20, 2, 64)
# The scale hyperprior (phase 13): the paper's batch of 8 crops of 256 x
# 256, a graphed epoch of 3 batches; its GDN kernels at the three sites'
# rows with a gamma that is not symmetric, held to the plain version at
# fp32's tolerance, which the same gamma transposed must miss by at least
# TRANSPOSED_MISS times.
(HYPERPRIOR_BATCH, HYPERPRIOR_STEPS, TRANSPOSED_MISS) = (8, 3, 100.0)
ROWS = {"H/4": BATCH * HEIGHT * WIDTH // 16, "H/8": BATCH * HEIGHT * WIDTH // 64,
        "H/16": BATCH * HEIGHT * WIDTH // 256,
        # One of two shards of the serving batch: a height band or a data block.
        "S/4": BATCH * HEIGHT * WIDTH // 32, "S/8": BATCH * HEIGHT * WIDTH // 128,
        "S/16": BATCH * HEIGHT * WIDTH // 512,
        "B/4": BENCH_BATCH * HEIGHT * WIDTH // 16, "B/8": BENCH_BATCH * HEIGHT * WIDTH // 64,
        "B/16": BENCH_BATCH * HEIGHT * WIDTH // 256,
        "T/4": TRAIN_BATCH * TRAIN_CROP ** 2 // 16, "T/8": TRAIN_BATCH * TRAIN_CROP ** 2 // 64,
        "T/16": TRAIN_BATCH * TRAIN_CROP ** 2 // 256,
        # The activation probe decodes one 16 x 16 latent (256 x 256 pixels).
        "A/4": PROBE_PIXELS // 16, "A/8": PROBE_PIXELS // 64, "A/16": PROBE_PIXELS // 256,
        # collect_stats encodes a batch of 20 crops; the parity harness 2 small images.
        "E/4": STATS_BATCH * TRAIN_CROP ** 2 // 16, "E/8": STATS_BATCH * TRAIN_CROP ** 2 // 64,
        "E/16": STATS_BATCH * TRAIN_CROP ** 2 // 256,
        "P/4": PARITY_IMAGES * PARITY_PIXELS ** 2 // 16,
        "P/8": PARITY_IMAGES * PARITY_PIXELS ** 2 // 64,
        "P/16": PARITY_IMAGES * PARITY_PIXELS ** 2 // 256,
        # The scale hyperprior's training batch: GDN sites at H/2, H/4, H/8.
        "R/2": HYPERPRIOR_BATCH * TRAIN_CROP ** 2 // 4,
        "R/4": HYPERPRIOR_BATCH * TRAIN_CROP ** 2 // 16,
        "R/8": HYPERPRIOR_BATCH * TRAIN_CROP ** 2 // 64}
TRAIN_SHAPES = ("T/4", "T/8", "T/16")
SERVE_SHAPES = ("H/4", "H/8", "H/16")
BENCH_SHAPES = ("B/4", "B/8")
SHARD_SHAPES = ("S/4", "S/8", "S/16")
PROBE_SHAPES = ("A/4", "A/8", "A/16")
STATS_SHAPES = ("E/4", "E/8", "E/16")
PARITY_SHAPES = ("P/4", "P/8", "P/16")
HYPERPRIOR_SHAPES = ("R/2", "R/4", "R/8")
# The kernels line's shapes of a training path and of an RD study.
STACKED_ENTRIES = {"gdn_f32_stacked": TRAIN_SHAPES, "igdn_f32_stacked": TRAIN_SHAPES}
TRAINING_ENTRIES = {"gdn_f32": TRAIN_SHAPES, "igdn_f32": TRAIN_SHAPES, **STACKED_ENTRIES}
# A training path differentiates every site: the gradient kernel's entries.
TRAINING_ENTRIES.update({name + "_backward": shapes for (name, shapes) in TRAINING_ENTRIES.items()})
STUDY_ENTRIES = {"gdn_f32": SERVE_SHAPES, "igdn_f32": SERVE_SHAPES}
# The distributed layer: sharded steps held against unsharded ones, the
# height-sharded round trip's gate, and the two image sets of the gate's
# wider probe.
(DIST_STEPS, SPATIAL_GAP, GATE_SEEDS) = (6, 5e-2, (15, 16))
# The ladder: one epoch of 12 shared batches a part; the single-model
# comparison runs 3 steps; the RD study's gates against the committed curves.
(LADDER_IMAGES, LADDER_COMPARED_STEPS) = (120, 3)
# The graphed epoch (train/epoch_graph.py): its first call per capture
# counts the GDN launches of two steps (the warm-up step and the
# capture), a replay none; GRAPHED_EPOCHS epochs of GRAPHED_STEPS steps are
# held against the spread of EAGER_EPOCHS eager ones, one step to
# ONE_STEP_GAP of each leaf's largest entry (the bound of the JAX package's
# scan test).
(GRAPH_PREP_STEPS, GRAPHED_STEPS, ONE_STEP_GAP) = (2, 12, 1e-4)
(EAGER_EPOCHS, GRAPHED_EPOCHS) = (5, 2)
RD_IMAGES_TAG = "6c3a64d647"
# The all-bf16 fixed-bin-width fast decode: no image further under the
# fp32 decode of the same symbols than this.
FIXED_BW_TAIL0_DB = 0.5
(RD_PSNR_DB, RD_MEAN_RATE, RD_IMAGE_RATE, RD_DEADS_EQUAL, RD_BJONTEGAARD_POINTS) = (
    0.05, 0.01, 0.02, 0.99, 0.5)
# The GDN launches of a training batch's encode and decode: (variant,
# shape); the fixed-bin-width architecture adds GDN_3 and IGDN_4 at the
# bottleneck. One train_step encodes once (its density phase and RD loss
# share the latents) and decodes once; the data-parallel sharded step
# encodes once more, in its RD loss.
ENCODE_SITES = {
    True: (("gdn_f32", "T/4"), ("gdn_f32", "T/8")),
    False: (("gdn_f32", "T/4"), ("gdn_f32", "T/8"), ("gdn_f32", "T/16")),
}
DECODE_SITES = {
    True: (("igdn_f32", "T/8"), ("igdn_f32", "T/4")),
    False: (("igdn_f32", "T/16"), ("igdn_f32", "T/8"), ("igdn_f32", "T/4")),
}
TRAIN_SITES = {learn: ENCODE_SITES[learn] + DECODE_SITES[learn] for learn in (True, False)}
SHARDED_TRAIN_SITES = {learn: ENCODE_SITES[learn] + TRAIN_SITES[learn]
                       for learn in (True, False)}
# The stacked fp32 kernel (a ladder step's three GDN and three IGDN
# sites, one launch each for every model): its single-model variant and
# inverse; the ladder's models.
STACKED_VARIANTS = {"gdn_f32_stacked": ("gdn_f32", False),
                    "igdn_f32_stacked": ("igdn_f32", True)}
STACKED_MODELS = 7
# One model trains as a stack of one (train/step.py): a training step's
# GDN sites launch the stacked kernel at (rows, 1).
ONE_MODEL = {single: name for (name, (single, _)) in STACKED_VARIANTS.items()}


def one_model_sites(sites):
    """The stacked kernel's ``(variant, shape)`` of a one-model training
    step's GDN ``sites``."""
    return tuple((ONE_MODEL[name], f"{shape} x1") for (name, shape) in sites)


# Its timed shapes: a ladder step's rows for the seven models, and one
# model's (a one-model step's, and a sharded ladder's block of one).
STACKED_SHAPES = TRAIN_SHAPES + tuple(f"{shape} x1" for shape in TRAIN_SHAPES)
# The gradient kernel (``gdn_backward``, the backward of ``GdnFunction`` and
# ``GdnStackedFunction``; its tile pass counted once a call as
# ``<forward>_backward``, its reduction as ``REDUCE``): the forward variant
# each differentiates. It replaces no TPU kernel.
BACKWARD_VARIANTS = {name + "_backward": name
                     for name in ("gdn_f32", "igdn_f32", "gdn_f32_stacked", "igdn_f32_stacked",
                                  "gdn_f32_192", "igdn_f32_192")}
REDUCE = "gdn_backward_reduce"
# The fp32 GDN of one model at 192 channels (Minnen et al.'s model), counted
# under its own names: the 128-channel variant whose TPU kernel it ports.
WIDE_VARIANTS = {"gdn_f32_192": "gdn_f32", "igdn_f32_192": "igdn_f32"}
# The gradient kernel's two kernels, as a device trace names them, and the
# calls a trace of them holds.
(BACKWARD_KERNELS, TRACED_CALLS) = (("gdn_bwd_f32_kernel", "gdn_bwd_reduce_kernel"), 10)


def backward_of(counts):
    """The backward launches of forward launches that all require grad:
    a tile pass each and, as gamma and beta require grad too, a reduction
    each."""
    launches = {name + "_backward": n for (name, n) in counts.items()}
    return {**launches, REDUCE: sum(launches.values())}


# Kernel variants: dtype, inverse, quantise, trained (gamma, beta) site,
# the shapes of the main path, and the Pallas body each replaces.
VARIANTS = {
    "gdn_f32": (torch.float32, False, False, (LEARNED, 1),
                SERVE_SHAPES + TRAIN_SHAPES + BENCH_SHAPES + SHARD_SHAPES + STATS_SHAPES
                + PARITY_SHAPES, 26),
    "igdn_f32": (torch.float32, True, False, (LEARNED, 6),
                 SERVE_SHAPES + TRAIN_SHAPES + BENCH_SHAPES + ("B/16",) + SHARD_SHAPES
                 + PROBE_SHAPES + PARITY_SHAPES, 26),
    "gdn_bf16": (torch.bfloat16, False, False, (LEARNED, 1), ("H/4", "H/8") + BENCH_SHAPES, 26),
    "igdn_bf16": (torch.bfloat16, True, False, (LEARNED, 6),
                  ("H/4", "H/8") + BENCH_SHAPES + ("S/4",), 26),
    "gdn_quantize_f32": (torch.float32, False, True, (FIXED, 3), ("H/16", "S/16"), 44),
}


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def build_all():
    """Builds the kernels and the coder from the checkout's sources,
    both at once (nvcc and make in parallel)."""
    from autoencoder_based_image_compression_tpu_torch.coding import native
    from autoencoder_based_image_compression_tpu_torch.ops.kernels import gdn_kernel

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=2) as pool:
        futures = [pool.submit(gdn_kernel.load_library), pool.submit(native.load_library)]
        for future in futures:
            future.result()
    print(f"built {KERNEL_SOURCE}, {ADAM_SOURCE} and the coder in "
          f"{time.perf_counter() - t0:.1f} s")
    # ptxas report: kernel (template arguments as mangled: Li<C>E, Li<RM>E,
    # then Lb<inverse>E, Lb<quantise>E), registers, spills.
    with open(gdn_kernel.BUILD_LOG) as log:
        report = log.read()
    for entry in report.split("Compiling entry function '")[1:]:
        kernel = re.search(r"gdn_(?:bwd_)?(?:f32|bf16|reduce)_kernelI\w+?E(?=Ev)"
                           r"|adam_f32_kernel|aeic_mark_\w+", entry)
        facts = [line.split(":")[-1].strip() for line in entry.splitlines()
                 if "Used" in line or "spill" in line]
        print(f"  ptxas {kernel.group(0) if kernel else '?'}: " + "; ".join(facts))


def _median_ms(run, launches, repeats):
    """Median over ``repeats`` of the device time of ``run()`` per launch."""
    times = []
    for _ in range(repeats):
        (start, end) = (torch.cuda.Event(enable_timing=True),
                        torch.cuda.Event(enable_timing=True))
        start.record()
        run()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return float(numpy.median(times))


def time_ms(fn, inputs, launches=24, repeats=7):
    """Device time of one ``fn(x)`` in ms: ``(graph, eager)``.

    ``graph`` replays a captured CUDA graph of ``launches`` calls, so no
    host work (Python, ctypes, the allocator) sits between the kernels;
    ``eager`` times the same calls made from Python back to back. Both
    are the median of ``repeats``. The calls walk round ``inputs``
    (copies of one matrix, more than the L2 cache holds together with
    their outputs) and every output of a pass stays alive, so each launch
    finds its operands in device memory, not in the cache.
    """
    def run():
        return [fn(inputs[i % len(inputs)]) for i in range(launches)]

    for _ in range(2):  # first use sets the kernels' attributes: not capturable
        run()
    torch.cuda.synchronize()
    eager = _median_ms(run, launches, repeats)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outputs = run()
    graph.replay()
    torch.cuda.synchronize()
    replayed = _median_ms(graph.replay, launches, repeats)
    del outputs, graph
    return (replayed, eager)


def bound(rows, dtype, quantize, models=1, channels=128):
    """Least time on the card (ms) for the kernel's work and what sets it:
    each input read once and the output written once at the HBM rate, or
    the 2 * rows * C^2 flops of the pool at the peak rate of their type
    (``rows`` a model, ``models`` models for the stacked kernel, C the
    ``channels``)."""
    c = channels
    nbytes = 2 * rows * models * c * (4 if dtype == torch.float32 else 2)
    nbytes += models * (c * c + c + (c if quantize else 0)) * 4
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = 2.0 * rows * models * c * c / PEAK_FLOPS[dtype]
    return (1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def kernel_inputs(name, rows, seed):
    (dtype, _, quantize, (exp_dir, index), _, _) = VARIANTS[name]
    with numpy.load(os.path.join(exp_dir, "params_trained.npz")) as data:
        gamma = data[f"param:gamma_{index}"].astype(numpy.float32)
        beta = data[f"param:beta_{index}"].astype(numpy.float32)
        bin_widths = data["bin_widths"].astype(numpy.float32)
    rng = numpy.random.default_rng(seed)
    x = (4.0 * rng.normal(size=(rows, 128))).astype(numpy.float32)
    cuda = lambda a: torch.from_numpy(a).cuda()  # noqa: E731
    args = [cuda(x).to(dtype), cuda(gamma), cuda(beta)]
    if quantize:
        args.append(cuda(bin_widths))
    return args


def check_kernel(name, rows, got, expected, bin_widths):
    """Holds a kernel's result against its plain version's at the
    variant's tolerance; returns ``(max_abs, max_rel, tolerance, detail)``."""
    (dtype, _, quantize, _, _, _) = VARIANTS[name]
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name} at {rows} rows: non-finite output")
    diff = (got.float() - expected.float()).abs()
    max_abs = float(diff.max())
    max_rel = float((diff / expected.float().abs().clamp_min(1e-30)).max())
    if quantize:
        flips = got != expected
        flip_share = float(flips.float().mean())
        bw = bin_widths.expand_as(got)
        if flip_share > 1e-4 or not torch.allclose(diff[flips], bw[flips], rtol=1e-6):
            raise AssertionError(f"{name}: {flip_share} of the elements off by a bin")
        return (max_abs, max_rel, "identical except ties (<= 1e-4, one bin each)",
                f"tie flips {int(flips.sum())} of {flips.numel()}")
    if dtype == torch.float32:
        torch.testing.assert_close(got, expected, rtol=1e-5, atol=1e-6)
        return (max_abs, max_rel, "rtol 1e-5, atol 1e-6", "")
    if not bool((diff <= BF16_ULP * expected.float().abs()).all()):
        raise AssertionError(f"{name} at {rows} rows: more than 1 bf16 ulp off")
    return (max_abs, max_rel, "1 bf16 ulp (rtol 2^-7)", "")


def phase_kernels():
    """Each variant against its plain version; returns errors and times."""
    from autoencoder_based_image_compression_tpu_torch.ops.kernels import gdn_kernel as gk

    results = {}
    for (seed, (name, (dtype, inverse, quantize, _, shapes, _))) in enumerate(VARIANTS.items()):
        kernel = gk.gdn_quantize_2d if quantize else gk.gdn_2d
        plain = gk.gdn_quantize_2d_plain if quantize else gk.gdn_2d_plain
        # Ragged row counts first (the last tile is masked; also at the
        # H/16 rows where the variant runs there), then the main paths'
        # shapes, which are also timed.
        ragged = {"ragged": ROWS["H/4"] + RAGGED_EXTRA}
        if "H/16" in shapes:
            ragged["ragged H/16"] = ROWS["H/16"] + RAGGED_EXTRA
        if "B/4" in shapes:
            ragged["ragged B/4"] = ROWS["B/4"] + RAGGED_EXTRA
        if "S/4" in shapes:
            ragged["ragged S/4"] = ROWS["S/4"] + RAGGED_EXTRA
        for shape in tuple(ragged) + shapes:
            rows = ragged.get(shape) or ROWS[shape]
            (x, *params) = kernel_inputs(name, rows, seed)
            got = kernel(x, *params, inverse=inverse)
            expected = plain(x, *params, inverse=inverse)
            torch.cuda.synchronize()
            (max_abs, max_rel, tolerance, detail) = check_kernel(
                name, rows, got, expected, params[-1])
            head = (f"  {name:17s} rows {rows:6d} ({shape:11s}): max abs err {max_abs:.3e}, "
                    f"max rel err {max_rel:.3e} [{tolerance}] {detail}")
            if shape in ragged:
                print(head)
                continue
            del got, expected
            nbytes = 2 * x.numel() * x.element_size()
            inputs = [x] + [x.clone() for _ in range(TIMING_FOOTPRINT_BYTES // nbytes)]
            (ms, ms_eager) = time_ms(lambda t: kernel(t, *params, inverse=inverse), inputs)
            (plain_ms, _) = time_ms(lambda t: plain(t, *params, inverse=inverse), inputs)
            (bound_ms, bound_by) = bound(rows, dtype, quantize)
            results[(name, shape)] = dict(max_abs_err=max_abs, ms=ms, ms_eager=ms_eager,
                                          plain_ms=plain_ms, bound_ms=bound_ms,
                                          bound_by=bound_by)
            print(f"{head}; tile {gk.tile_rows(rows) if dtype == torch.float32 else 16}; "
                  f"kernel {ms:.4f} ms replayed, {ms_eager:.4f} ms eager, "
                  f"plain {plain_ms:.4f} ms, bound {1e3 * bound_ms:.2f} us ({bound_by}), "
                  f"share of bound {100 * bound_ms / ms:.0f} %")
    return results


def stacked_inputs(name, rows, models, seed):
    """``(x, gamma, beta)`` of the stacked kernel: ``models`` models of
    ``rows`` rows, each model with the trained site's gamma and beta
    scaled by its own factor, so that a model reading another's
    parameters shows."""
    (single, _) = STACKED_VARIANTS[name]
    (_, inverse, _, (exp_dir, index), _, _) = VARIANTS[single]
    with numpy.load(os.path.join(exp_dir, "params_trained.npz")) as data:
        gamma = data[f"param:gamma_{index}"].astype(numpy.float32)
        beta = data[f"param:beta_{index}"].astype(numpy.float32)
    scales = (1.0 + 0.25 * numpy.arange(models, dtype=numpy.float32))
    rng = numpy.random.default_rng(seed)
    x = (4.0 * rng.normal(size=(rows, models, 128))).astype(numpy.float32)
    cuda = lambda a: torch.from_numpy(numpy.ascontiguousarray(a)).cuda()  # noqa: E731
    return (cuda(x), cuda(scales[:, None, None] * gamma[None]), cuda(scales[:, None] * beta[None]))


def check_stacked(name, rows, models, seed):
    """The stacked kernel against its plain twin (fp32 tolerance) and
    models 0 and M - 1 of it against the single-model kernel on the same
    rows, bit for bit. Returns ``(inputs, max_abs_err)``."""
    from autoencoder_based_image_compression_tpu_torch.ops.kernels import gdn_kernel as gk

    (_, inverse) = STACKED_VARIANTS[name]
    (x, gamma, beta) = stacked_inputs(name, rows, models, seed)
    got = gk.gdn_stacked_2d(x, gamma, beta, inverse=inverse)
    expected = gk.gdn_stacked_2d_plain(x, gamma, beta, inverse=inverse)
    torch.cuda.synchronize()
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name} at {models} x {rows} rows: non-finite output")
    torch.testing.assert_close(got, expected, rtol=1e-5, atol=1e-6)
    for m in sorted({0, models - 1}):
        single = gk.gdn_2d(x[:, m].contiguous(), gamma[m], beta[m], inverse=inverse)
        if not torch.equal(got[:, m], single):
            raise AssertionError(f"{name} at {models} x {rows} rows: model {m} is not the "
                                 "single-model kernel's result bit for bit")
    return ((x, gamma, beta), float((got - expected).abs().max()))


def phase_stacked_kernels():
    """The stacked fp32 kernel (the ladder's six GDN sites) at a ladder
    step's rows, seven models, and a ragged count; returns errors and
    times as :func:`phase_kernels` does."""
    from autoencoder_based_image_compression_tpu_torch.ops.kernels import gdn_kernel as gk

    results = {}
    for (seed, name) in enumerate(STACKED_VARIANTS):
        inverse = STACKED_VARIANTS[name][1]
        for shape in ("ragged",) + STACKED_SHAPES:
            rows = ROWS["T/4"] + RAGGED_EXTRA if shape == "ragged" else ROWS[shape.split()[0]]
            models = 1 if shape.endswith("x1") else STACKED_MODELS
            ((x, gamma, beta), max_abs) = check_stacked(name, rows, models, 70 + seed)
            head = (f"  {name:17s} rows {models} x {rows:6d} ({shape:7s}): max abs err "
                    f"{max_abs:.3e} [rtol 1e-5, atol 1e-6]; models "
                    f"{sorted({0, models - 1})} equal to {STACKED_VARIANTS[name][0]} bit for bit")
            if shape == "ragged":
                print(head)
                continue
            nbytes = 2 * x.numel() * x.element_size()
            inputs = [x] + [x.clone() for _ in range(TIMING_FOOTPRINT_BYTES // nbytes)]
            (ms, ms_eager) = time_ms(
                lambda t: gk.gdn_stacked_2d(t, gamma, beta, inverse=inverse), inputs)
            (plain_ms, _) = time_ms(
                lambda t: gk.gdn_stacked_2d_plain(t, gamma, beta, inverse=inverse), inputs)
            (bound_ms, bound_by) = bound(rows, torch.float32, False, models)
            results[(name, shape)] = dict(max_abs_err=max_abs, ms=ms, ms_eager=ms_eager,
                                          plain_ms=plain_ms, bound_ms=bound_ms,
                                          bound_by=bound_by)
            tile = gk.tile_rows(rows, max(1, gk.H100_SMS // models))
            print(f"{head}; tile {tile}; kernel {ms:.4f} ms replayed, {ms_eager:.4f} ms eager, "
                  f"plain {plain_ms:.4f} ms, bound {1e3 * bound_ms:.2f} us ({bound_by}), "
                  f"share of bound {100 * bound_ms / ms:.0f} %")
    return results


def load_model(exp_dir):
    from autoencoder_based_image_compression_tpu_torch.eval import workload

    return workload.load_model(exp_dir)


def expect_launches(path, counts, expected):
    """Every GDN site of the path went through the kernels, and only those."""
    got = {name: n for (name, n) in counts.items() if n}
    print(f"  launches on the {path} path: {got}")
    if got != expected:
        raise AssertionError(f"{path}: launches {got}, expected {expected}")


# Adam's launches on each path as expect_adam read them: {path: {(leaves,
# models): launches}}. The kernels line's adam_f32 entries read theirs here.
ADAM_LAUNCHES = {}


def expect_adam(path, expected):
    """Adam's kernel launched as ``expected`` says on the path since the
    last ``adam_kernel.reset_launch_counts()``: ``{(leaves, models):
    launches}``, empty where no Adam step ran (or only replays). Records
    the counts in :data:`ADAM_LAUNCHES`."""
    from autoencoder_based_image_compression_tpu_torch.ops.kernels import adam_kernel as ak

    got = dict(ak.LAUNCH_SHAPES)
    print(f"  adam_f32 launches on the {path} path: {ak.LAUNCHES['adam_f32']} at (leaves, "
          f"models) {got}")
    if got != expected or ak.LAUNCHES["adam_f32"] != sum(expected.values()):
        raise AssertionError(f"{path}: adam_f32 launches {got}, expected {expected}")
    ADAM_LAUNCHES[path] = got


def phase_serving(kernel_results):
    from autoencoder_based_image_compression_tpu_torch.data.synthetic import synthetic_kodak
    from autoencoder_based_image_compression_tpu_torch.engine import quantized as engine
    from autoencoder_based_image_compression_tpu_torch.eval import gate_probe
    from autoencoder_based_image_compression_tpu_torch.eval.gate_probe import GATE_DB
    from autoencoder_based_image_compression_tpu_torch.models import conv_eae
    from autoencoder_based_image_compression_tpu_torch.ops.kernels import gdn_kernel as gk
    from autoencoder_based_image_compression_tpu_torch.ops.metrics import psnr_2d
    from autoencoder_based_image_compression_tpu_torch.parallel.inference import (
        PipelinedCompressor,
    )

    (params, bin_widths, map_mean, probabilities, idx_exc) = load_model(LEARNED)
    images = synthetic_kodak(seed=0)
    nb_batches = -(-images.shape[0] // BATCH)
    # Small-input reference: the fp32 transforms with the kernels on the
    # card against the same transforms on the CPU (plain GDN).
    small = torch.from_numpy(images[:1, :64, :96].astype(numpy.float32))
    params_gpu = {k: v.cuda() for (k, v) in params.items()}
    y_gpu = conv_eae.encode(params_gpu, small.cuda(), True).cpu()
    y_cpu = conv_eae.encode(params, small, True)
    torch.testing.assert_close(y_gpu, y_cpu, rtol=1e-4, atol=1e-3)
    print(f"  small-input fp32 latents, card vs CPU: max abs diff "
          f"{float((y_gpu - y_cpu).abs().max()):.3e}")

    runs = {}
    for fast_path in ("bf16w+", None):
        compressor = PipelinedCompressor(params, bin_widths, True, probabilities, map_mean,
                                         idx_map_exception=idx_exc, batch_size=BATCH,
                                         fast_path=fast_path, verify=True, reconstruct=True)
        compressor(images[:BATCH])  # warm-up: cuDNN plans, pinned buffers
        torch.cuda.synchronize()
        gk.reset_launch_counts()
        (recs, bits) = compressor(images)
        torch.cuda.synchronize()
        launches = dict(gk.LAUNCHES)
        tag = fast_path or "fp32"
        if recs.shape != images.shape or recs.dtype != numpy.uint8:
            raise AssertionError(f"{tag}: reconstructions {recs.shape} {recs.dtype}")
        if not numpy.all(bits > 0):
            raise AssertionError(f"{tag}: empty bitstream")
        if compressor.peak_in_flight > compressor.max_in_flight:
            raise AssertionError(f"{tag}: window exceeded")
        psnrs = numpy.array([psnr_2d(images[i, :, :, 0], recs[i, :, :, 0])
                             for i in range(images.shape[0])])
        timing = compressor.last_timing
        print(f"  serving {tag}: {bits.sum() / images[..., 0].size:.4f} bpp, "
              f"PSNR mean {psnrs.mean():.4f} dB (min {psnrs.min():.4f}), "
              f"{images[..., 0].size / timing['wall'] / 1e6:.3f} Mpix/s end to end, "
              f"last_timing {json.dumps(timing)}, peak_in_flight {compressor.peak_in_flight}")
        runs[tag] = (psnrs, bits, launches)
        device_times(compressor, images[:BATCH], timing["coder"] / nb_batches, kernel_results,
                     GDN_SITES[tag])
    expect_launches("serving bf16w+", runs["bf16w+"][2],
                    {"gdn_f32": 2 * nb_batches, "igdn_f32": nb_batches,
                     "igdn_bf16": nb_batches})
    expect_launches("serving fp32", runs["fp32"][2],
                    {"gdn_f32": 2 * nb_batches, "igdn_f32": 2 * nb_batches})
    deltas = runs["bf16w+"][0] - runs["fp32"][0]
    rate_gap = abs(int(runs["bf16w+"][1].sum()) - int(runs["fp32"][1].sum()))
    print(f"  bf16w+ vs fp32 through the pipeline at x1: worst-image PSNR delta "
          f"{deltas.min():+.4f} dB (gate -{GATE_DB} dB), max |delta| "
          f"{numpy.abs(deltas).max():.4f} dB, "
          f"total bits differ by {rate_gap / int(runs['fp32'][1].sum()):.3e}")
    if deltas.min() < -GATE_DB:
        raise AssertionError(f"bf16w+ misses the {GATE_DB} dB gate: {deltas.min():+.4f} dB")
    table = gate_probe.gate_table(params, bin_widths, map_mean, images, through="pipeline",
                                  batch_size=BATCH, device=DEVICE)
    # The row of the mix that PipelinedCompressor serves with.
    label = gate_probe.mix_label("pipeline", "bf16", dict(
        fp32_enc_tail=engine.BF16WPLUS_ENC_TAIL, fp32_tail=engine.BF16WPLUS_DEC_TAIL,
        fp32_head=engine.BF16WPLUS_DEC_HEAD, exact_latents=engine.BF16WPLUS_DEC_EXACT_LATENTS))
    if not gate_probe.holds_gate(table[label]):
        raise AssertionError(f"bf16w+ ({label}) misses the {GATE_DB} dB gate: {table[label]}")
    print(f"  bf16w+ ({label}) holds the {GATE_DB} dB gate at x1, x4 and x10")
    check_fp32_decode(params_gpu, bin_widths, images)
    return ({"serving bf16w+": runs["bf16w+"][2], "serving fp32": runs["fp32"][2]},
            table, runs["fp32"][0])


def check_fp32_decode(params_gpu, bin_widths, images):
    """The fp32 parity decode repeats its bits: two decodes of the same
    symbols (a batch of the served images) are equal. Then its ms a batch
    of 4 and of 24 with the transposed convs in their phase form (what
    ``decode`` runs without grad) and as ``conv_transpose2d``."""
    from autoencoder_based_image_compression_tpu_torch.eval import ladder_probe
    from autoencoder_based_image_compression_tpu_torch.models import conv_eae
    from autoencoder_based_image_compression_tpu_torch.ops.quantization import quantize_per_map

    with torch.no_grad():
        batch = torch.from_numpy(images[:BATCH].astype(numpy.float32)).cuda()
        latents = quantize_per_map(conv_eae.encode(params_gpu, batch, True),
                                   torch.from_numpy(bin_widths).cuda())
        decodes = [conv_eae.decode(params_gpu, latents, True) for _ in range(3)]
    torch.cuda.synchronize()
    if not all(torch.equal(decodes[0], other) for other in decodes[1:]):
        raise AssertionError("two fp32 decodes of the same symbols differ")
    print(f"  fp32 decode of the same symbols, three times ({BATCH} images): equal bit for bit "
          f"(torch.backends.cudnn.deterministic {torch.backends.cudnn.deterministic})")
    for batch_size in (BATCH, BENCH_BATCH):
        times = ladder_probe.decode_times(params_gpu, batch_size, HEIGHT, WIDTH)
        print(f"  fp32 decode, batch of {batch_size}: " + "; ".join(
            f"{form} {ms:.4f} ms ({'repeats its bits' if equal else 'does not repeat its bits'})"
            for (form, (ms, equal)) in times.items()))


def device_times(compressor, batch_uint8, coder_s, kernel_results, sites, repeats=5):
    """Device time of one batch's encode and decode (CUDA events round
    each, median of ``repeats``), GDN's share of it (the kernels' replayed
    times at the path's ``sites``) and the coder's host time per batch."""
    batch = torch.from_numpy(batch_uint8).cuda()
    (sym16, _, _) = compressor.encode_symbols(batch)
    compressor.decode_symbols(sym16)
    torch.cuda.synchronize()
    encode_ms = _median_ms(lambda: compressor.encode_symbols(batch), 1, repeats)
    decode_ms = _median_ms(lambda: compressor.decode_symbols(sym16), 1, repeats)
    gdn_ms = sum(kernel_results[site]["ms"] for site in sites)
    device_ms = encode_ms + decode_ms
    print(f"  device time per batch, {compressor.fast_path or 'fp32'}: encode "
          f"{encode_ms:.4f} ms, decode {decode_ms:.4f} ms, GDN kernels {gdn_ms:.4f} ms "
          f"({100 * gdn_ms / device_ms:.1f} % of {device_ms:.4f} ms); coder on the host "
          f"{1e3 * coder_s:.3f} ms per batch ({1e3 * coder_s / device_ms:.1f}x the device)")


def phase_fixed_bw():
    from autoencoder_based_image_compression_tpu_torch.data.synthetic import synthetic_kodak
    from autoencoder_based_image_compression_tpu_torch.models import conv_eae
    from autoencoder_based_image_compression_tpu_torch.ops.kernels import gdn_kernel as gk
    from autoencoder_based_image_compression_tpu_torch.ops.metrics import psnr_2d
    from autoencoder_based_image_compression_tpu_torch.ops.quantization import (
        cast_bt601,
        quantize_per_map,
    )
    from autoencoder_based_image_compression_tpu_torch.parallel.inference import (
        roundtrip_batched,
    )

    (params, bin_widths, _, _, _) = load_model(FIXED)
    images = synthetic_kodak(seed=0)[:8]
    gk.reset_launch_counts()
    recs = roundtrip_batched(params, images, bin_widths, False, batch_size=BATCH)
    torch.cuda.synchronize()
    launches = dict(gk.LAUNCHES)
    nb_batches = -(-images.shape[0] // BATCH)
    expect_launches("fixed-bw roundtrip", launches,
                    {"gdn_f32": 2 * nb_batches, "gdn_quantize_f32": nb_batches,
                     "igdn_f32": 3 * nb_batches})
    if recs.shape != images.shape or not numpy.all(numpy.isfinite(recs)):
        raise AssertionError(f"fixed-bw reconstructions {recs.shape}, finite "
                             f"{numpy.isfinite(recs).all()}")
    recs_u8 = cast_bt601(recs)
    psnrs = numpy.array([psnr_2d(images[i, :, :, 0], recs_u8[i, :, :, 0])
                         for i in range(images.shape[0])])
    # Reference on the card: GDN_3 and the quantiser as two steps.
    params_gpu = {k: v.cuda() for (k, v) in params.items()}
    batch = torch.from_numpy(images[:BATCH].astype(numpy.float32)).cuda()
    quantized = quantize_per_map(conv_eae.encode(params_gpu, batch, False),
                                 torch.from_numpy(bin_widths).cuda())
    unfused = conv_eae.decode(params_gpu, quantized, False).cpu().numpy()
    mse = float(numpy.mean((unfused.astype(numpy.float64) - recs[:BATCH]) ** 2))
    rec_psnr = 99.0 if mse == 0.0 else 10.0 * numpy.log10(255.0 ** 2 / mse)
    print(f"  fixed-bw roundtrip: PSNR vs originals mean {psnrs.mean():.4f} dB "
          f"(min {psnrs.min():.4f}); fused vs unfused reconstructions {rec_psnr:.2f} dB")
    if rec_psnr < 60.0 or psnrs.min() < 20.0:
        raise AssertionError("fixed-bw roundtrip disagrees with its unfused reference")
    return {"fixed-bw roundtrip": launches}


def phase_serving_variants(kernel_results, pipeline_table, psnrs_fp32):
    """The rest of serving at full width: the "bf16w" and "int8" variants,
    the fixed-bin-width fast decode, the K-batch round trip eager and as
    a CUDA graph, the streaming batcher, the gate through the scan path,
    the serving bench and the roofline report. Returns each path's
    launch counts."""
    from autoencoder_based_image_compression_tpu_torch.data.synthetic import synthetic_kodak
    from autoencoder_based_image_compression_tpu_torch.engine import quantized as engine
    from autoencoder_based_image_compression_tpu_torch.eval import (
        gate_probe,
        roofline,
        serving_bench,
    )
    from autoencoder_based_image_compression_tpu_torch.models import conv_eae
    from autoencoder_based_image_compression_tpu_torch.ops.kernels import gdn_kernel as gk
    from autoencoder_based_image_compression_tpu_torch.ops.metrics import psnr_2d
    from autoencoder_based_image_compression_tpu_torch.ops.quantization import cast_bt601
    from autoencoder_based_image_compression_tpu_torch.parallel.continuous_batching import (
        ContinuousBatcher,
        stream_roundtrip,
    )
    from autoencoder_based_image_compression_tpu_torch.parallel.inference import (
        PipelinedCompressor,
        make_codec_fns,
        roundtrip_batched,
    )
    from autoencoder_based_image_compression_tpu_torch.utils.device import deterministic_cudnn

    (params, bin_widths, map_mean, probabilities, idx_exc) = load_model(LEARNED)
    images = synthetic_kodak(seed=0)
    nb_batches = -(-images.shape[0] // BATCH)
    paths = {}

    def image_psnrs(recs_u8, originals=images):
        return numpy.array([psnr_2d(originals[i, :, :, 0], recs_u8[i, :, :, 0])
                            for i in range(recs_u8.shape[0])])

    # --- "bf16w" and "int8" through the pipeline, true bitstreams, verified.
    for (fast_path, label) in (("bf16w", "bf16w (the reference's mix as it is)"),
                               ("int8", "int8")):
        compressor = PipelinedCompressor(params, bin_widths, True, probabilities, map_mean,
                                         idx_map_exception=idx_exc, batch_size=BATCH,
                                         fast_path=fast_path, verify=True, reconstruct=True,
                                         device=DEVICE)
        compressor(images[:BATCH])  # warm-up: cuDNN plans, pinned buffers
        torch.cuda.synchronize()
        gk.reset_launch_counts()
        (recs, bits) = compressor(images)
        torch.cuda.synchronize()
        paths[f"serving {fast_path}"] = dict(gk.LAUNCHES)
        if recs.shape != images.shape or recs.dtype != numpy.uint8 or not numpy.all(bits > 0):
            raise AssertionError(f"{fast_path}: reconstructions {recs.shape} {recs.dtype}")
        psnrs = image_psnrs(recs)
        timing = compressor.last_timing
        row = pipeline_table[label]
        print(f"  serving {fast_path}: {bits.sum() / images[..., 0].size:.4f} bpp, PSNR mean "
              f"{psnrs.mean():.4f} dB (min {psnrs.min():.4f}), worst image against fp32 "
              f"through the pipeline {(psnrs - psnrs_fp32).min():+.4f} dB, "
              f"{images[..., 0].size / timing['wall'] / 1e6:.3f} Mpix/s end to end, "
              f"last_timing {json.dumps(timing)}; gate row "
              + "; ".join(f"x{m:g} {d:+.4f}" for (m, d) in row.items())
              + (": holds" if gate_probe.holds_gate(row) else ": misses")
              + f" the {gate_probe.GATE_DB} dB gate (a miss is expected of this variant)")
        expect_launches(f"serving {fast_path}", paths[f"serving {fast_path}"],
                        {"gdn_bf16": 2 * nb_batches, "igdn_bf16": 2 * nb_batches})
        device_times(compressor, images[:BATCH], timing["coder"] / nb_batches, kernel_results,
                     GDN_SITES[fast_path])

    # --- the fixed-bin-width fast decode against the fp32 decode.
    (fixed, fixed_bw, _, _, _) = load_model(FIXED)
    fixed = {name: value.cuda() for (name, value) in fixed.items()}
    bw_fixed = torch.from_numpy(fixed_bw).cuda()
    for (batch_size, path) in ((BATCH, "fixed-bw fast decode"),
                               (BENCH_BATCH, "fixed-bw fast decode, batch of 24")):
        served = images[:2 * batch_size] if batch_size == BATCH else images
        batches = [torch.from_numpy(served[i:i + batch_size].astype(numpy.float32)).cuda()
                   for i in range(0, served.shape[0], batch_size)]
        symbols = [torch.round(conv_eae.encode(fixed, batch, False) / bw_fixed)
                   for batch in batches]
        reference = [conv_eae.decode(fixed, sym * bw_fixed, False) for sym in symbols]
        psnrs_reference = image_psnrs(
            numpy.concatenate([cast_bt601(rec).cpu().numpy() for rec in reference]), served)
        for fp32_tail in ((0, 3) if batch_size == BATCH else (0,)):
            qparams = engine.bf16_weight_params(fixed, fp32_tail=fp32_tail)
            gk.reset_launch_counts()
            got = [engine.fast_decode_fixed_bw(qparams, sym, bw_fixed, fp32_tail=fp32_tail)
                   for sym in symbols]
            torch.cuda.synchronize()
            launches = dict(gk.LAUNCHES)
            gap = max(float((a - b).abs().max()) for (a, b) in zip(got, reference))
            psnrs = image_psnrs(
                numpy.concatenate([cast_bt601(rec).cpu().numpy() for rec in got]), served)
            print(f"  fast_decode_fixed_bw, tail {fp32_tail}, batch {batch_size}: largest pixel "
                  f"gap against the fp32 decode {gap:.3e}; worst image's PSNR delta "
                  f"{(psnrs - psnrs_reference).min():+.4f} dB (mean PSNR {psnrs.mean():.4f} dB)")
            if fp32_tail == 3:
                # All fp32 on both sides: 1e-3 of the pixel range.
                if not gap <= 1e-3 * 255.0:
                    raise AssertionError(f"fast_decode_fixed_bw at tail 3: gap {gap}")
                expect_launches("fixed-bw fast decode, tail 3", launches,
                                {"igdn_f32": 3 * len(batches)})
            else:
                # Every image within 0.5 dB under the fp32 decode of the
                # same symbols (this card's runs read +0.0007 dB for the
                # worst): a stage in the wrong dtype or place falls out.
                if not (psnrs - psnrs_reference).min() >= -FIXED_BW_TAIL0_DB:
                    raise AssertionError(
                        f"fast_decode_fixed_bw at tail 0: PSNR deltas against the fp32 decode "
                        f"{psnrs - psnrs_reference} [{-FIXED_BW_TAIL0_DB} dB]")
                paths[path] = launches
                expect_launches(path, launches, {"igdn_f32": len(batches),
                                                 "igdn_bf16": 2 * len(batches)})

    # --- the serving decode repeats its bits with cuDNN's flag never set
    # (its first transposed conv is a forward conv into the output
    # phases), and what tconv_4 costs in that form.
    device_params = {name: value.cuda() for (name, value) in params.items()}
    bw = torch.from_numpy(bin_widths).cuda()
    qparams = engine.bf16_weight_params(device_params)
    (_, qfolded, knobs) = engine.scan_variant(device_params, bw, "bf16w+")
    flags = []

    def recording(conv):
        def call(*args, **kwargs):
            flags.append(torch.backends.cudnn.deterministic)
            return conv(*args, **kwargs)
        return call

    for batch_size in (BATCH, BENCH_BATCH):
        batch = torch.from_numpy(images[:batch_size].astype(numpy.float32)).cuda()
        y = conv_eae.encode(device_params, batch, True)
        quantized = bw * torch.round(y / bw)
        with mock.patch.object(engine.F, "conv2d", recording(engine.F.conv2d)), \
                mock.patch.object(engine.F, "conv_transpose2d",
                                  recording(engine.F.conv_transpose2d)):
            decodes = [engine.fast_decode(qparams, quantized, fp32_head=True,
                                          exact_latents=True) for _ in range(3)]
        if any(flags) or not flags:
            raise AssertionError(f"cudnn.deterministic at the decode's convs: {flags}")
        if not all(torch.equal(decodes[0], other) for other in decodes[1:]):
            raise AssertionError("two bf16w+ decodes of the same latents differ")
        # tconv_4 of both serving mixes: the pipeline's (bf16 kernel, fp32
        # result, the dequantised latent unrounded) and the scan path's
        # (the folded fp32 kernel on integer symbols).
        said = []
        for (mix, x, w5, dtype) in (
                ("pipeline", quantized, qparams["weights_4"], torch.bfloat16),
                ("scan", torch.round(y / bw), qfolded["weights_4"], torch.float32)):
            copies = TIMING_FOOTPRINT_BYTES // (2 * x.numel() * x.element_size())
            inputs = [x] + [x.clone() for _ in range(copies)]
            (ms, ms_eager) = time_ms(lambda t: engine._tconv4_phases(
                t, w5, dtype=dtype, round_input=False), inputs)

            def transposed(t):  # the engine's form before: conv_transpose2d and the crop
                return engine._tconv_bf16(t, w5, 2, dtype=dtype, round_input=False)
            (default_ms, _) = time_ms(transposed, inputs)
            with deterministic_cudnn():
                (pinned_ms, _) = time_ms(transposed, inputs)
            said.append(f"{mix} {ms:.4f} ms replayed ({ms_eager:.4f} eager) against "
                        f"conv_transpose2d {default_ms:.4f} ms with cuDNN's default, "
                        f"{pinned_ms:.4f} ms deterministic")
        print(f"  batch of {batch_size}: three bf16w+ decodes of the same latents equal bit "
              f"for bit, torch.backends.cudnn.deterministic False at all {len(flags)} convs; "
              f"tconv_4 a batch: " + "; ".join(said))
        flags.clear()

    # --- the K-batch round trip: eager against its CUDA graph.
    (qparams, qfolded, knobs) = engine.scan_variant(device_params, bw, "bf16w+")
    if torch.backends.cudnn.deterministic:
        raise AssertionError("cudnn.deterministic is set before the scan's capture")
    for batch_size in (BATCH, BENCH_BATCH):
        stack = torch.from_numpy(serving_bench.distinct_stack(
            images[:batch_size].astype(numpy.float32), SCAN_BATCHES)).cuda()
        engine.fast_roundtrip_scan(qparams, qfolded, stack[:1], bw, **knobs)  # warm-up
        gk.reset_launch_counts()
        eager = engine.fast_roundtrip_scan(qparams, qfolded, stack, bw, **knobs)
        torch.cuda.synchronize()
        per_batch = {"gdn_f32": 2, "igdn_f32": 1, "igdn_bf16": 1}
        path = f"scan bf16w+, batch of {batch_size}"
        paths[path] = dict(gk.LAUNCHES)
        expect_launches(f"{path}, eager", paths[path],
                        {name: n * SCAN_BATCHES for (name, n) in per_batch.items()})
        gk.reset_launch_counts()
        captured = engine.fast_roundtrip_scan(qparams, qfolded, stack, bw, graph=True, **knobs)
        # Per capture: one warm-up batch and the K captured batches.
        expect_launches(f"{path}, the graph's capture", dict(gk.LAUNCHES),
                        {name: n * (SCAN_BATCHES + 1) for (name, n) in per_batch.items()})
        gk.reset_launch_counts()
        replayed = engine.fast_roundtrip_scan(qparams, qfolded, stack, bw, graph=True, **knobs)
        torch.cuda.synchronize()
        expect_launches(f"{path}, a replay (no Python call, so no count)", dict(gk.LAUNCHES), {})
        for (name, got) in (("captured", captured), ("replayed", replayed)):
            if not (torch.equal(got[0], eager[0]) and torch.equal(got[1], eager[1])):
                raise AssertionError(f"{path}: the {name} graph differs from the eager loop")
        if not bool(torch.isfinite(eager[0]).all()) or eager[0].shape != stack.shape:
            raise AssertionError(f"{path}: reconstructions {eager[0].shape}")
        eager_ms = _median_ms(lambda: engine.fast_roundtrip_scan(
            qparams, qfolded, stack, bw, **knobs), 1, 7)
        graph_ms = _median_ms(lambda: engine.fast_roundtrip_scan(
            qparams, qfolded, stack, bw, graph=True, **knobs), 1, 7)
        mpix = SCAN_BATCHES * batch_size * HEIGHT * WIDTH / 1e3
        print(f"  fast_roundtrip_scan bf16w+, {SCAN_BATCHES} batches of {batch_size}: graph and "
              f"eager equal bit for bit; {eager_ms:.3f} ms eager ({mpix / eager_ms:.1f} Mpix/s), "
              f"{graph_ms:.3f} ms replayed with its copies in and out "
              f"({mpix / graph_ms:.1f} Mpix/s): eager / graph {eager_ms / graph_ms:.3f}")
        del eager, captured, replayed, stack
        engine.clear_scan_graphs()

    # --- the streaming batcher against the batched round trip.
    # Both run the fp32 transforms, whose transposed convs do not repeat
    # their bits under cuDNN's default: held to the deterministic
    # algorithms the two are equal, which is what the batcher can add.
    gk.reset_launch_counts()
    with deterministic_cudnn():
        streamed = stream_roundtrip(params, bin_widths, images, BATCH, learn_bin_widths=True,
                                    device=DEVICE)
        paths["stream roundtrip"] = dict(gk.LAUNCHES)
        batched = roundtrip_batched(params, images, bin_widths, True, batch_size=BATCH,
                                    device=DEVICE)
    expect_launches("stream roundtrip", paths["stream roundtrip"],
                    {"gdn_f32": 2 * nb_batches, "igdn_f32": 2 * nb_batches})
    default = roundtrip_batched(params, images, bin_widths, True, batch_size=BATCH,
                                device=DEVICE)
    if streamed.shape != batched.shape or not numpy.array_equal(streamed, batched):
        raise AssertionError("stream_roundtrip differs from roundtrip_batched")
    print(f"  stream_roundtrip equals roundtrip_batched on {images.shape[0]} images (cuDNN's "
          f"deterministic algorithms; its default moves the fp32 reconstructions by "
          f"{float(numpy.abs(default - batched).max()):.3e} of a pixel level at most)")
    # Four producer threads into one batcher: PyTorch's current stream
    # belongs to a thread, so the batcher is given the stream to queue on.
    stream = torch.cuda.Stream()
    seen = set()
    (encode_fn, decode_fn, put) = make_codec_fns(True, device=DEVICE)

    def batch_fn(batch):
        seen.add(torch.cuda.current_stream().cuda_stream)
        return decode_fn(device_params, encode_fn(device_params, put(batch)), bw)

    batcher = ContinuousBatcher(batch_fn, BATCH, max_in_flight=2, stream=stream)
    threads = [threading.Thread(target=lambda k=k: [
        batcher.submit(i, images[i].astype(numpy.float32)) for i in range(k, images.shape[0], 4)])
        for k in range(4)]
    for thread in threads:
        thread.start()
    for thread in threads:
        thread.join(timeout=120)
    results = batcher.flush()
    threaded = numpy.stack([results[i] for i in range(images.shape[0])])
    gap = float(numpy.abs(threaded - batched).max())
    print(f"  ContinuousBatcher, 4 producer threads on one stream: {len(results)} images, "
          f"streams seen {len(seen)}, largest pixel gap against roundtrip_batched {gap:.3e} "
          f"[1e-3 of the pixel range: other batch neighbours, cuDNN's default algorithms]")
    if any(thread.is_alive() for thread in threads) or seen != {stream.cuda_stream} \
            or not gap <= 1e-3 * 255.0:
        raise AssertionError("the threaded batcher lost an image, left its stream or disagrees")

    # --- the gate through the scan path.
    table = gate_probe.gate_table(params, bin_widths, map_mean, images, through="scan",
                                  batch_size=BATCH, device=DEVICE)
    label = gate_probe.mix_label("scan", "bf16", engine.BF16WPLUS_SCAN_MIX)
    if not gate_probe.holds_gate(table[label]):
        raise AssertionError(f"the scan path's bf16w+ ({label}) misses the "
                             f"{gate_probe.GATE_DB} dB gate: {table[label]}")
    cheapest = next(row for (row, (store, _)) in gate_probe.GATE_MIXES["scan"].items()
                    if store == "bf16" and gate_probe.holds_gate(table[row]))
    print(f"  the scan path's bf16w+ ({label}) holds the {gate_probe.GATE_DB} dB gate at x1, "
          f"x4 and x10; the cheapest row that holds it: {cheapest}")

    # --- the serving bench, in-process, and the roofline report.
    gk.reset_launch_counts()
    result = serving_bench.run(device=DEVICE, repeats=3)
    paths["serving bench"] = dict(gk.LAUNCHES)
    print(f"  launches in the serving bench (a graph counts at its capture only): "
          f"{paths['serving bench']}")
    print("  serving bench (3 repeats):")
    print(json.dumps(result))
    if not (result["gate_pass_worst_0p05db"]["bf16w+"] and result["headline_path"] == "bf16w+"
            and result["value"] > 0.0 and result["weights"] == "trained"):
        raise AssertionError("the serving bench's headline is not the gated bf16w+")
    report = roofline.roofline_report(params, images, bin_widths, repeats=3,
                                      weight_mode="bf16w+", device=DEVICE)
    print(f"  roofline, 24 images as one batch, 4 in flight: {report['flops_per_pixel']:.0f} "
          f"FLOP a pixel; fp32 path {report['mpix_per_s_parity']:.1f} Mpix/s = "
          f"{report['achieved_flops_per_s_parity'] / 1e12:.2f} TFLOP/s, "
          f"{100 * report['tensor_core_utilization_parity']:.1f} % of the measured true-fp32 "
          f"matmul ceiling of {report['peak_flops_per_s_parity'] / 1e12:.1f} TFLOP/s; bf16w+ "
          f"{report['mpix_per_s_fast']:.1f} Mpix/s = "
          f"{report['achieved_flops_per_s_fast'] / 1e12:.2f} TFLOP/s, "
          f"{100 * report['tensor_core_utilization_fast']:.1f} % of the measured bf16 ceiling "
          f"of {report['peak_flops_per_s_fast'] / 1e12:.1f} TFLOP/s; PSNR between the paths "
          f"{report['psnr_fast_vs_parity_db']:.2f} dB")
    if not all(numpy.isfinite(value) for value in report.values()
               if isinstance(value, float)):
        raise AssertionError(f"roofline report {report}")
    return paths


def _gap_to_max(got, expected):
    """Largest absolute difference, as a share of the largest entry."""
    return float((got - expected).abs().max() / expected.abs().max().clamp_min(1e-30))


def backward_inputs(name, rows, models, seed):
    """``(x, gamma, beta, grad_out)`` of the gradient kernel, in its
    stacked layout (one model a stack of one): the forward variant's
    inputs (:func:`kernel_inputs`, :func:`stacked_inputs`) and a seeded
    ``grad_out``."""
    forward = BACKWARD_VARIANTS[name]
    if forward in STACKED_VARIANTS:
        (x, gamma, beta) = stacked_inputs(forward, rows, models, seed)
    else:
        (x, gamma, beta) = kernel_inputs(forward, rows, seed)
        (x, gamma, beta) = (x.unsqueeze(1), gamma.unsqueeze(0), beta.unsqueeze(0))
    grad_out = torch.randn(x.shape, device=DEVICE,
                           generator=torch.Generator(DEVICE).manual_seed(seed))
    return (x, gamma, beta, grad_out)


def check_backward(name, x, gamma, beta, grad_out):
    """The gradient kernel against its plain twin, each gradient within
    1e-4 of its largest entry (fp32 sums over 128 channels, or over the
    rows for gamma and beta, in another order), and a second call equal
    to the first bit for bit. Returns the three gaps and the largest
    absolute difference of the three gradients."""
    from autoencoder_based_image_compression_tpu_torch.ops.kernels import gdn_kernel as gk

    (inverse, stacked) = (name.startswith("igdn"), "stacked" in name)
    got = gk.gdn_backward(x, gamma, beta, grad_out, inverse, stacked=stacked)
    again = gk.gdn_backward(x, gamma, beta, grad_out, inverse, stacked=stacked)
    expected = gk.gdn_backward_plain(x, gamma, beta, grad_out, inverse)
    torch.cuda.synchronize()
    gaps = [_gap_to_max(a, b) for (a, b) in zip(got, expected)]
    if not all(bool(torch.isfinite(g).all()) for g in got) or not all(g <= 1e-4 for g in gaps):
        raise AssertionError(f"{name} at {tuple(x.shape[:2])} rows: gradient gaps {gaps}")
    if not all(torch.equal(a, b) for (a, b) in zip(got, again)):
        raise AssertionError(f"{name} at {tuple(x.shape[:2])} rows: two calls differ")
    return (gaps, max(float((a - b).abs().max()) for (a, b) in zip(got, expected)))


def kernel_launch_ms(run, steps, names):
    """Device time of each kernel of ``names`` in a profiler trace of
    ``steps`` calls of ``run``, from the trace's own kernel intervals:
    ``{name: (ms a launch, launches in the trace)}``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run()  # the profiler's own start-up stays out of the trace
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as trace:
        for _ in range(steps):
            run()
        torch.cuda.synchronize()
    found = collections.defaultdict(list)
    for event in trace.events():
        if event.device_type == DeviceType.CUDA:
            for name in names:
                if name in event.name:
                    found[name].append(event.time_range.elapsed_us())
    return {name: (1e-3 * sum(us) / len(us), len(us)) for (name, us) in found.items()}


def time_backward(name, x, gamma, beta, grad_out):
    """The gradient kernel's and its plain twin's times as :func:`time_ms`
    gives them, and the bound: three times :func:`bound`'s, the three
    contractions of the forward's one. Then the tile pass and the
    reduction apart, ms a launch from a profiler trace of eager calls: the
    split only where the trace holds every launch of the calls, and then
    its sum within 70-110 % of the replayed time (the device's own time a
    call; the eager time adds the host's launches at small sites), or it
    raises."""
    from autoencoder_based_image_compression_tpu_torch.ops.kernels import gdn_kernel as gk

    (inverse, stacked) = (name.startswith("igdn"), "stacked" in name)
    nbytes = 3 * x.numel() * x.element_size()
    pairs = [(x, grad_out)] + [(x.clone(), grad_out.clone())
                               for _ in range(TIMING_FOOTPRINT_BYTES // nbytes)]
    call = lambda p: gk.gdn_backward(p[0], gamma, beta, p[1], inverse, stacked=stacked)  # noqa: E731
    (ms, ms_eager) = time_ms(call, pairs)
    (plain_ms, _) = time_ms(
        lambda p: gk.gdn_backward_plain(p[0], gamma, beta, p[1], inverse), pairs)
    (bound_ms, bound_by) = bound(x.shape[0], torch.float32, False, x.shape[1], x.shape[2])
    traced = kernel_launch_ms(lambda: call((x, grad_out)), TRACED_CALLS, BACKWARD_KERNELS)
    launches = {kernel: traced.get(kernel, (None, 0))[1] for kernel in BACKWARD_KERNELS}
    split = None
    if all(n == TRACED_CALLS for n in launches.values()):
        split = {kernel: traced[kernel][0] for kernel in BACKWARD_KERNELS}
        if not 0.7 <= sum(split.values()) / ms <= 1.1:
            raise AssertionError(f"{name} at {tuple(x.shape[:2])} rows: the traced split "
                                 f"{split} sums to {sum(split.values()):.4f} ms, the replayed "
                                 f"call takes {ms:.4f} ms")
    return dict(ms=ms, ms_eager=ms_eager, plain_ms=plain_ms, bound_ms=3 * bound_ms,
                bound_by=bound_by, split=split, traced_launches=launches)


def backward_line(name, rows, models, gaps, result):
    from autoencoder_based_image_compression_tpu_torch.ops.kernels import gdn_kernel as gk

    tile = gk.tile_rows(rows, max(1, gk.H100_SMS // models),
                        gk.BACKWARD_TILES[192 if "_192" in name else 128])
    if result["split"] is None:
        traced = (f"split not measured: the trace holds {result['traced_launches']} launches "
                  f"of {TRACED_CALLS} calls")
    else:
        traced = ", ".join(f"{kernel} {ms:.4f} ms" for (kernel, ms) in result["split"].items())
        traced += f", their sum {100 * sum(result['split'].values()) / result['ms']:.0f} % of replayed"
    return (f"  {name:25s} rows {models} x {rows:6d}: gap / largest entry grad_x {gaps[0]:.3e}, "
            f"grad_gamma {gaps[1]:.3e}, grad_beta {gaps[2]:.3e} [1e-4], two calls equal; tile "
            f"{tile}; kernel {result['ms']:.4f} ms replayed, {result['ms_eager']:.4f} ms eager, "
            f"plain {result['plain_ms']:.4f} ms, bound {1e3 * result['bound_ms']:.2f} us "
            f"({result['bound_by']}), share of bound "
            f"{100 * result['bound_ms'] / result['ms']:.0f} % (traced, ms a launch: {traced})")


def phase_gradient(kernel_results):
    """``GdnFunction`` (kernel forward, the gradient kernel backward)
    against autograd through the plain version, same inputs on the card,
    at the H/4 rows of a training batch; each gradient within 1e-4 of its
    largest entry. Then the gradient kernel against its plain twin at
    every training site's rows, one model and the seven-model ladder (and
    a sharded ladder's block of one), timed into ``kernel_results``
    beside the twin and the bound, with its launches a call."""
    from autoencoder_based_image_compression_tpu_torch.ops.kernels import gdn_kernel as gk

    rows = ROWS["T/4"]
    for (seed, name) in enumerate(("gdn_f32", "igdn_f32")):
        inverse = VARIANTS[name][1]
        (x, gamma, beta) = kernel_inputs(name, rows, 20 + seed)
        upstream = torch.randn(x.shape, device=DEVICE,
                               generator=torch.Generator(DEVICE).manual_seed(seed))
        grads = {}
        gk.reset_launch_counts()
        for (label, fn) in (("kernel", gk.gdn_2d), ("plain", gk.gdn_2d_plain)):
            leaves = [t.clone().requires_grad_(True) for t in (x, gamma, beta)]
            out = fn(*leaves, inverse=inverse)
            if not out.requires_grad:
                raise AssertionError(f"{name}: the {label} result came back detached")
            grads[label] = torch.autograd.grad(out, leaves, upstream)
        torch.cuda.synchronize()
        launches = {variant: n for (variant, n) in gk.LAUNCHES.items() if n}
        if launches != {name: 1, **backward_of({name: 1})}:
            raise AssertionError(f"{name}: launches {launches} in the gradient check")
        gaps = [_gap_to_max(got, expected)
                for (got, expected) in zip(grads["kernel"], grads["plain"])]
        print(f"  {name} gradient at {rows} rows, kernel forward and backward vs autograd "
              f"through plain: gap / largest entry grad_x {gaps[0]:.3e}, grad_gamma "
              f"{gaps[1]:.3e}, grad_beta {gaps[2]:.3e} [1e-4]; launches {launches}")
        if not all(gap <= 1e-4 for gap in gaps):
            raise AssertionError(f"{name}: gradient gaps {gaps}")
        # What is never differentiated raises instead of detaching.
        leaves = [t.clone().requires_grad_(True) for t in (x, gamma, beta)]
        for (call, error) in (
                (lambda: gk.gdn_2d(leaves[0].to(torch.bfloat16), gamma, beta), TypeError),
                (lambda: gk.gdn_quantize_2d(leaves[0], gamma, beta, beta), RuntimeError)):
            try:
                call()
            except error:
                continue
            raise AssertionError(f"{name}: an undifferentiable call with grad did not raise")

    for (seed, name) in enumerate(BACKWARD_VARIANTS):
        if BACKWARD_VARIANTS[name] in WIDE_VARIANTS:
            continue  # 192 channels: phase 14, at its model's sites
        stacked = BACKWARD_VARIANTS[name] in STACKED_VARIANTS
        for shape in ("ragged",) + (STACKED_SHAPES if stacked else TRAIN_SHAPES):
            rows = ROWS["T/8"] + RAGGED_EXTRA if shape == "ragged" else ROWS[shape.split()[0]]
            models = STACKED_MODELS if stacked and not shape.endswith("x1") else 1
            (x, gamma, beta, grad_out) = backward_inputs(name, rows, models, 90 + seed)
            (gaps, max_abs) = check_backward(name, x, gamma, beta, grad_out)
            if shape == "ragged":
                print(f"  {name:25s} rows {models} x {rows:6d} (ragged): gap / largest entry "
                      f"{max(gaps):.3e} [1e-4], two calls equal")
                continue
            result = time_backward(name, x, gamma, beta, grad_out)
            kernel_results[(name, shape)] = dict(max_gap=max(gaps), max_abs_err=max_abs, **result)
            print(backward_line(name, rows, models, gaps, result))
            del x, grad_out


def adam_cases():
    """``{path: (leaves, lr, correction_1, correction_2)}`` of one Adam
    step on the card, as each training path's step hands them to
    ``adam_kernel.adam_leaves``: one model's 19 (learned bin widths) and 23
    (fixed) leaves with a leading axis of 1, the seven-model ladder's 23
    stacked leaves with counts on both sides of the models' rate
    boundaries (three rates apart), the hyperprior's and the joint prior's
    one vector at their constant rate. Gradients and moments drawn at a
    trained model's scale."""
    from autoencoder_based_image_compression_tpu_torch import constants as csts
    from autoencoder_based_image_compression_tpu_torch.cli.train_ladder import GAMMAS_DEFAULT
    from autoencoder_based_image_compression_tpu_torch.models import minnen2018
    from autoencoder_based_image_compression_tpu_torch.models.conv_eae import (
        init_conv_eae_params,
    )
    from autoencoder_based_image_compression_tpu_torch.train import hyperprior as hp
    from autoencoder_based_image_compression_tpu_torch.train.state import (
        ADAM_B1,
        ADAM_B2,
        ladder_boundaries,
        learning_rate,
    )

    generator = torch.Generator(DEVICE).manual_seed(90)

    def leaves(shapes):
        def draw(shape, scale):
            return scale * torch.randn(shape, device=DEVICE, generator=generator)
        return [(draw(shape, 0.05), draw(shape, 1e-3), draw(shape, 1e-4), draw(shape, 1e-7).abs())
                for shape in shapes]

    def step(shapes, count, gammas=None):
        count_inc = (count + 1).to(torch.float32)
        lr = (hp.LR if gammas is None
              else learning_rate(ladder_boundaries(gammas, DEVICE), count))
        return (leaves(shapes), lr, 1.0 - ADAM_B1 ** count_inc, 1.0 - ADAM_B2 ** count_inc)

    def shapes(learn_bin_widths, models):
        params = init_conv_eae_params(torch.Generator().manual_seed(0), learn_bin_widths)
        return [(models,) + tuple(value.shape) for value in params.values()]

    ladder_counts = [(0, 5, first - 1, first, second - 1, second, second + 7)[m]
                     for (m, (first, second)) in enumerate(csts.lr_boundaries(gamma)
                                                           for gamma in GAMMAS_DEFAULT)]
    one = torch.tensor([3], dtype=torch.int32, device=DEVICE)
    return {
        "training, learned bin widths": step(shapes(True, 1), one, [TRAIN_GAMMA]),
        "training, fixed bin widths": step(shapes(False, 1), one, [TRAIN_GAMMA]),
        "ladder training": step(shapes(False, STACKED_MODELS),
                                torch.tensor(ladder_counts, dtype=torch.int32, device=DEVICE),
                                GAMMAS_DEFAULT),
        "hyperprior training": step([(hp.SIZE,)], torch.tensor(4, dtype=torch.int32,
                                                               device=DEVICE)),
        "joint prior training": step([(hp.size_of(minnen2018),)],
                                     torch.tensor(4, dtype=torch.int32, device=DEVICE)),
    }


def phase_adam():
    """Adam's kernel (``csrc/adam.cu``) at each training path's leaves:
    every output equal to its plain twin's (``adam_leaves_plain``, the
    per-leaf chain) bit for bit, one launch counted at ``(leaves,
    models)``, two calls equal; timed replayed in a CUDA graph and eager
    beside the twin and its bound, 28 bytes an element (read p, g, mu, nu;
    write p, mu, nu) over the HBM rate. Returns the times, ``{(leaves,
    models): result}`` and ``{case: result}``."""
    from autoencoder_based_image_compression_tpu_torch.ops.kernels import adam_kernel as ak

    results = {}
    for (path, (leaves, *values)) in adam_cases().items():
        models = next((v.shape[0] for v in values if torch.is_tensor(v) and v.dim()), 1)
        ak.reset_launch_counts()
        got = ak.adam_leaves(leaves, *values)
        torch.cuda.synchronize()
        expect_adam(f"Adam's kernel, {path}", {(len(leaves), models): 1})
        again = ak.adam_leaves(leaves, *values)
        plain = ak.adam_leaves_plain(leaves, *values)
        torch.cuda.synchronize()
        for (index, (outputs, outputs_again, expected)) in enumerate(zip(got, again, plain)):
            for (name, a, b, c) in zip(("p", "mu", "nu"), outputs, outputs_again, expected):
                if not (torch.equal(a, c) and torch.equal(a, b)):
                    raise AssertionError(f"adam_f32, {path}: leaf {index}'s {name} is not the "
                                         "plain chain's bit for bit, or two calls differ")
        del got, again, plain
        elements = sum(leaf[0].numel() for leaf in leaves)
        copies = TIMING_FOOTPRINT_BYTES // (28 * elements)
        inputs = [leaves] + [[tuple(t.clone() for t in leaf) for leaf in leaves]
                             for _ in range(copies)]
        (ms, ms_eager) = time_ms(lambda leaf_set: ak.adam_leaves(leaf_set, *values), inputs)
        (plain_ms, _) = time_ms(lambda leaf_set: ak.adam_leaves_plain(leaf_set, *values), inputs)
        del inputs
        bound_ms = 1e3 * 28 * elements / PEAK_BYTES_PER_S
        print(f"  adam_f32 {path}: {len(leaves)} leaves x {models} models, {elements} elements, "
              f"every output equal to the plain chain's bit for bit; kernel {ms:.4f} ms "
              f"replayed, {ms_eager:.4f} ms eager, plain chain {plain_ms:.4f} ms, bound "
              f"{1e3 * bound_ms:.2f} us (bytes), share of bound {100 * bound_ms / ms:.0f} %")
        results[path] = {"ms": ms, "ms_eager": ms_eager, "plain_ms": plain_ms,
                         "bound_ms": bound_ms, "elements": elements}
        # The first case of a (leaves, models) speaks for it on a path not
        # in ADAM_CASE_OF (the hyperprior's one vector, not the joint prior's).
        results.setdefault((len(leaves), models), results[path])
    return results


# The paths whose Adam launch has the (leaves, models) of another path's
# and other elements: phase 2's case timed at theirs.
ADAM_CASE_OF = {"one joint prior train_step": "joint prior training"}


def adam_entries(paths, adam_results):
    """The kernels line's ``adam_f32`` entries: one for each ``(leaves,
    models)`` that Adam's kernel launched at on each of ``paths``, with
    its launches there as :func:`expect_adam` read them after the path's
    run, and phase 2's times at those leaves (or at the case
    :data:`ADAM_CASE_OF` names)."""
    entries = []
    for path in paths:
        launched = ADAM_LAUNCHES.get(path)
        if not launched:
            raise AssertionError(f"adam_f32 never launched on the {path} path")
        for ((leaves, models), launches) in launched.items():
            result = adam_results[ADAM_CASE_OF.get(path, (leaves, models))]
            entries.append({
                "name": "adam_f32", "route": "cuda", "source": ADAM_SOURCE, "replaces": None,
                "launches": launches, "max_abs_err": 0.0, "ms": result["ms"],
                "ms_eager": result["ms_eager"], "plain_ms": result["plain_ms"],
                "bound_ms": result["bound_ms"], "bound_by": "bytes", "library_ms": None,
                "path": path, "leaves": leaves, "models": models,
                "elements": result["elements"]})
    return entries


def asymmetric_gdn_inputs(rows, seed, channels=128):
    """``(x, gamma, beta)`` on the card at ``channels``: ``x`` as
    :func:`kernel_inputs` draws it, ``gamma`` in the kernel's ``[k][c]``
    layout with ``0.1`` on its diagonal and ``U(0, 0.02)`` off it, each
    entry drawn on its own (far from symmetric, as a learned one is),
    ``beta`` in ``[1, 1.5)``."""
    generator = torch.Generator(DEVICE).manual_seed(seed)
    x = 4.0 * torch.randn((rows, channels), device=DEVICE, generator=generator)
    gamma = 0.02 * torch.rand((channels, channels), device=DEVICE, generator=generator)
    gamma.diagonal().fill_(0.1)
    beta = 1.0 + 0.5 * torch.rand((channels,), device=DEVICE, generator=generator)
    return (x, gamma, beta)


def phase_hyperprior(kernel_results):
    """The scale hyperprior's GDN sites and its graphed training step.

    At each site's rows (131,072, 32,768 and 8,192 at a batch of 8 crops of
    256 x 256), with a gamma that is not symmetric: the fp32 GDN and IGDN
    kernels against their plain versions at fp32's tolerance (the plain
    version on the transposed gamma must miss it by
    :data:`TRANSPOSED_MISS` times, so the check sees an index the wrong
    way round), timed against their bound into ``kernel_results``; then
    ``GdnFunction``'s gradients against autograd through the plain
    version, within 1e-4 of each gradient's largest entry (as
    :func:`phase_gradient`), and the gradient kernel against its plain
    twin there, timed beside it and its bound. Then a fresh state trains
    through a graphed epoch of :data:`HYPERPRIOR_STEPS` batches: its
    capture counts the warm-up step's and the capture's launches, 3 + 3
    a step at those rows and as many backwards, and marks every phase; a
    replay counts none; one eager ``train_step`` launches 3 + 3 and 3 + 3
    backwards. Returns the path's launches."""
    from autoencoder_based_image_compression_tpu_torch.ops.kernels import adam_kernel as ak
    from autoencoder_based_image_compression_tpu_torch.ops.kernels import gdn_kernel as gk
    from autoencoder_based_image_compression_tpu_torch.train import epoch_graph
    from autoencoder_based_image_compression_tpu_torch.train import hyperprior as hp

    for (seed, name) in enumerate(("gdn_f32", "igdn_f32")):
        inverse = VARIANTS[name][1]
        for shape in HYPERPRIOR_SHAPES:
            rows = ROWS[shape]
            (x, gamma, beta) = asymmetric_gdn_inputs(rows, 60 + seed)
            got = gk.gdn_2d(x, gamma, beta, inverse=inverse)
            expected = gk.gdn_2d_plain(x, gamma, beta, inverse=inverse)
            transposed = gk.gdn_2d_plain(x, gamma.t().contiguous(), beta, inverse=inverse)
            torch.cuda.synchronize()
            (max_abs, max_rel, tolerance, _) = check_kernel(name, rows, got, expected, None)
            # How far past fp32's tolerance (rtol 1e-5, atol 1e-6) the
            # transposed gamma lands, at its worst element.
            miss = float(((transposed - expected).abs() / (1e-6 + 1e-5 * expected.abs())).max())
            if miss < TRANSPOSED_MISS:
                raise AssertionError(f"{name} at {rows} rows: the transposed gamma lands only "
                                     f"{miss:.1f} times the tolerance away")
            del got, expected, transposed
            nbytes = 2 * x.numel() * x.element_size()
            inputs = [x] + [x.clone() for _ in range(TIMING_FOOTPRINT_BYTES // nbytes)]
            (ms, ms_eager) = time_ms(lambda t: gk.gdn_2d(t, gamma, beta, inverse=inverse),
                                     inputs)
            (plain_ms, _) = time_ms(lambda t: gk.gdn_2d_plain(t, gamma, beta, inverse=inverse),
                                    inputs)
            del inputs
            (bound_ms, bound_by) = bound(rows, torch.float32, False)
            kernel_results[(name, shape)] = dict(max_abs_err=max_abs, ms=ms, ms_eager=ms_eager,
                                                 plain_ms=plain_ms, bound_ms=bound_ms,
                                                 bound_by=bound_by)
            upstream = torch.randn(x.shape, device=DEVICE,
                                   generator=torch.Generator(DEVICE).manual_seed(70 + seed))
            grads = {}
            for (label, fn) in (("kernel", gk.gdn_2d), ("plain", gk.gdn_2d_plain)):
                leaves = [t.clone().requires_grad_(True) for t in (x, gamma, beta)]
                grads[label] = torch.autograd.grad(fn(*leaves, inverse=inverse), leaves,
                                                   upstream)
            gaps = [_gap_to_max(got, expected)
                    for (got, expected) in zip(grads["kernel"], grads["plain"])]
            print(f"  {name:8s} gamma not symmetric, rows {rows:6d} ({shape}): max abs err "
                  f"{max_abs:.3e}, max rel err {max_rel:.3e} [{tolerance}], the transposed "
                  f"gamma {miss:.3e} times the tolerance away; tile {gk.tile_rows(rows)}; "
                  f"kernel {ms:.4f} ms replayed, {ms_eager:.4f} ms eager, plain "
                  f"{plain_ms:.4f} ms, bound {1e3 * bound_ms:.2f} us ({bound_by}), share of "
                  f"bound {100 * bound_ms / ms:.0f} %; gradient gap / largest entry grad_x "
                  f"{gaps[0]:.3e}, grad_gamma {gaps[1]:.3e}, grad_beta {gaps[2]:.3e} [1e-4]")
            if not all(gap <= 1e-4 for gap in gaps):
                raise AssertionError(f"{name} at {rows} rows: gradient gaps {gaps}")
            backward = name + "_backward"
            operands = (x.unsqueeze(1), gamma.unsqueeze(0), beta.unsqueeze(0),
                        upstream.unsqueeze(1))
            (gaps, max_abs) = check_backward(backward, *operands)
            result = time_backward(backward, *operands)
            kernel_results[(backward, shape)] = dict(max_gap=max(gaps), max_abs_err=max_abs,
                                                     **result)
            print(backward_line(backward, rows, 1, gaps, result))
            del grads, upstream, x, operands

    fns = hp.make_hyperprior_step_fns()
    generator = torch.Generator(DEVICE).manual_seed(80)
    state = hp.init_hyperprior_state(generator, DEVICE)
    dataset = torch.randint(0, 256, (HYPERPRIOR_STEPS * HYPERPRIOR_BATCH, TRAIN_CROP,
                                     TRAIN_CROP, 3), dtype=torch.uint8, device=DEVICE,
                            generator=generator)
    rows = numpy.arange(HYPERPRIOR_STEPS * HYPERPRIOR_BATCH).reshape(HYPERPRIOR_STEPS,
                                                                     HYPERPRIOR_BATCH)
    noise = torch.Generator(DEVICE).manual_seed(81)
    per_step = {"gdn_f32": 3, "igdn_f32": 3}
    per_step.update(backward_of(per_step))
    site_rows = {ROWS[shape]: GRAPH_PREP_STEPS for shape in HYPERPRIOR_SHAPES}
    captures = len(epoch_graph.CAPTURES)
    gk.reset_launch_counts()
    ak.reset_launch_counts()
    state = fns["train_epoch"](state, dataset, rows, noise)
    torch.cuda.synchronize()
    expect_launches("hyperprior graphed epoch, its capture", dict(gk.LAUNCHES),
                    {name: GRAPH_PREP_STEPS * n for (name, n) in per_step.items()})
    # Adam: one launch a step over the one vector.
    expect_adam("hyperprior graphed epoch, its capture", {(1, 1): GRAPH_PREP_STEPS})
    for name in per_step:
        seen = {n: count for ((variant, n), count) in gk.LAUNCH_ROWS.items() if variant == name}
        print(f"  {name} rows in the capture: {seen}")
        # The reduction of a GDN and of an IGDN site at the same rows.
        if seen != ({(n, 1): 2 * count for (n, count) in site_rows.items()} if name == REDUCE
                    else site_rows):
            raise AssertionError(f"hyperprior capture: {name} at rows {seen}, "
                                 f"expected {site_rows}")
    marks = epoch_graph.CAPTURES[captures]["marks"]
    expected_marks = (("step", "forward", "entropy", "synthesis", "backward")
                      + ("gdn_backward_begin", "gdn_backward_end") * 6
                      + ("optimizer", "step_end"))
    if tuple(marks) != expected_marks:
        raise AssertionError(f"hyperprior capture marks {marks}")
    gk.reset_launch_counts()
    ak.reset_launch_counts()
    state = fns["train_epoch"](state, dataset, rows, noise)
    torch.cuda.synchronize()
    expect_launches("hyperprior graphed epoch, a replay (no Python call, so no count)",
                    dict(gk.LAUNCHES), {})
    expect_adam("hyperprior graphed epoch, a replay", {})
    steps = 2 * HYPERPRIOR_STEPS
    if int(state.step) != steps or not bool(torch.isfinite(state.params["all"]).all()):
        raise AssertionError(f"hyperprior: step {int(state.step)}, expected {steps}, "
                             "or parameters not finite")
    gk.reset_launch_counts()
    ak.reset_launch_counts()
    batch = dataset[torch.as_tensor(rows[0], device=DEVICE)]
    fns["train_step"](state, batch, noise)
    torch.cuda.synchronize()
    launches = dict(gk.LAUNCHES)
    expect_launches("one hyperprior train_step", launches, per_step)
    expect_adam("one hyperprior train_step", {(1, 1): 1})
    phases = fns["train_epoch"].phase_ms()
    print("  hyperprior graphed step, ms by phase: " + ", ".join(
        f"{name} {ms:.3f}" for (name, ms) in phases.items()))
    return {"hyperprior training": launches}


def phase_minnen2018(kernel_results):
    """Minnen et al.'s joint prior: the GDN kernels at 192 channels and its
    graphed training step.

    At each site's rows (131,072, 32,768 and 8,192 at a batch of 8 crops of
    256 x 256), with a gamma that is not symmetric: the 192-channel fp32
    GDN and IGDN kernels against their plain versions at fp32's tolerance
    (rtol 1e-5, atol 1e-6; the plain version on the transposed gamma must
    miss it by :data:`TRANSPOSED_MISS` times), timed against their bound
    (``2 * rows * 192^2`` FLOPs) into ``kernel_results``; the gradient
    kernel against its plain twin there (:func:`check_backward`), timed
    beside it and three times the bound. Then a fresh state of the model
    trains through a graphed epoch of :data:`HYPERPRIOR_STEPS` batches: its
    capture counts the warm-up step's and the capture's launches, 3 + 3 a
    step at 192 channels and at those rows, as many backwards and twice as
    many reductions, no 128-channel launch, one Adam launch a step over
    the one vector, and marks every phase (``context`` among them); a
    replay counts none; one eager ``train_step`` launches a step's. Returns
    the path's launches, from which the kernels line's 192-channel entries
    are built."""
    from autoencoder_based_image_compression_tpu_torch.models import minnen2018
    from autoencoder_based_image_compression_tpu_torch.ops.kernels import adam_kernel as ak
    from autoencoder_based_image_compression_tpu_torch.ops.kernels import gdn_kernel as gk
    from autoencoder_based_image_compression_tpu_torch.train import epoch_graph
    from autoencoder_based_image_compression_tpu_torch.train import hyperprior as hp

    for (seed, name) in enumerate(("gdn_f32_192", "igdn_f32_192")):
        inverse = name.startswith("igdn")
        for shape in HYPERPRIOR_SHAPES:
            rows = ROWS[shape]
            (x, gamma, beta) = asymmetric_gdn_inputs(rows, 160 + seed, channels=192)
            got = gk.gdn_2d(x, gamma, beta, inverse=inverse)
            expected = gk.gdn_2d_plain(x, gamma, beta, inverse=inverse)
            transposed = gk.gdn_2d_plain(x, gamma.t().contiguous(), beta, inverse=inverse)
            torch.cuda.synchronize()
            torch.testing.assert_close(got, expected, rtol=1e-5, atol=1e-6)
            diff = (got - expected).abs()
            max_abs = float(diff.max())
            max_rel = float((diff / expected.abs().clamp_min(1e-30)).max())
            miss = float(((transposed - expected).abs() / (1e-6 + 1e-5 * expected.abs())).max())
            if miss < TRANSPOSED_MISS:
                raise AssertionError(f"{name} at {rows} rows: the transposed gamma lands only "
                                     f"{miss:.1f} times the tolerance away")
            del got, expected, transposed
            nbytes = 2 * x.numel() * x.element_size()
            inputs = [x] + [x.clone() for _ in range(TIMING_FOOTPRINT_BYTES // nbytes)]
            (ms, ms_eager) = time_ms(lambda t: gk.gdn_2d(t, gamma, beta, inverse=inverse),
                                     inputs)
            (plain_ms, _) = time_ms(lambda t: gk.gdn_2d_plain(t, gamma, beta, inverse=inverse),
                                    inputs)
            del inputs
            (bound_ms, bound_by) = bound(rows, torch.float32, False, channels=192)
            kernel_results[(name, shape)] = dict(max_abs_err=max_abs, ms=ms, ms_eager=ms_eager,
                                                 plain_ms=plain_ms, bound_ms=bound_ms,
                                                 bound_by=bound_by)
            print(f"  {name:12s} gamma not symmetric, rows {rows:6d} ({shape}): max abs err "
                  f"{max_abs:.3e}, max rel err {max_rel:.3e} [rtol 1e-5, atol 1e-6], the "
                  f"transposed gamma {miss:.3e} times the tolerance away; tile "
                  f"{gk.tile_rows(rows, heights=gk.FORWARD_TILES[192])}; kernel {ms:.4f} ms "
                  f"replayed, {ms_eager:.4f} ms eager, plain {plain_ms:.4f} ms, bound "
                  f"{1e3 * bound_ms:.2f} us ({bound_by}), share of bound "
                  f"{100 * bound_ms / ms:.0f} %")
            upstream = torch.randn(x.shape, device=DEVICE,
                                   generator=torch.Generator(DEVICE).manual_seed(170 + seed))
            backward = name + "_backward"
            operands = (x.unsqueeze(1), gamma.unsqueeze(0), beta.unsqueeze(0),
                        upstream.unsqueeze(1))
            (gaps, max_abs) = check_backward(backward, *operands)
            result = time_backward(backward, *operands)
            kernel_results[(backward, shape)] = dict(max_gap=max(gaps), max_abs_err=max_abs,
                                                     **result)
            print(backward_line(backward, rows, 1, gaps, result))
            del upstream, x, operands

    fns = hp.make_hyperprior_step_fns(hp.MODELS["minnen2018"][2], minnen2018)
    generator = torch.Generator(DEVICE).manual_seed(180)
    state = hp.init_hyperprior_state(generator, DEVICE, minnen2018)
    dataset = torch.randint(0, 256, (HYPERPRIOR_STEPS * HYPERPRIOR_BATCH, TRAIN_CROP,
                                     TRAIN_CROP, 3), dtype=torch.uint8, device=DEVICE,
                            generator=generator)
    rows = numpy.arange(HYPERPRIOR_STEPS * HYPERPRIOR_BATCH).reshape(HYPERPRIOR_STEPS,
                                                                     HYPERPRIOR_BATCH)
    noise = torch.Generator(DEVICE).manual_seed(181)
    per_step = {"gdn_f32_192": 3, "igdn_f32_192": 3, "gdn_f32_192_backward": 3,
                "igdn_f32_192_backward": 3, "gdn_backward_reduce_192": 6}
    site_rows = {ROWS[shape]: GRAPH_PREP_STEPS for shape in HYPERPRIOR_SHAPES}
    captures = len(epoch_graph.CAPTURES)
    gk.reset_launch_counts()
    ak.reset_launch_counts()
    state = fns["train_epoch"](state, dataset, rows, noise)
    torch.cuda.synchronize()
    expect_launches("joint prior graphed epoch, its capture", dict(gk.LAUNCHES),
                    {name: GRAPH_PREP_STEPS * n for (name, n) in per_step.items()})
    expect_adam("joint prior graphed epoch, its capture", {(1, 1): GRAPH_PREP_STEPS})
    for name in per_step:
        seen = {n: count for ((variant, n), count) in gk.LAUNCH_ROWS.items() if variant == name}
        print(f"  {name} rows in the capture: {seen}")
        if seen != ({(n, 1): 2 * count for (n, count) in site_rows.items()}
                    if name == "gdn_backward_reduce_192" else site_rows):
            raise AssertionError(f"joint prior capture: {name} at rows {seen}, "
                                 f"expected {site_rows}")
    marks = epoch_graph.CAPTURES[captures]["marks"]
    expected_marks = (("step", "forward", "entropy", "context", "synthesis", "backward")
                      + ("gdn_backward_begin", "gdn_backward_end") * 6
                      + ("optimizer", "step_end"))
    if tuple(marks) != expected_marks:
        raise AssertionError(f"joint prior capture marks {marks}")
    gk.reset_launch_counts()
    ak.reset_launch_counts()
    state = fns["train_epoch"](state, dataset, rows, noise)
    torch.cuda.synchronize()
    expect_launches("joint prior graphed epoch, a replay (no Python call, so no count)",
                    dict(gk.LAUNCHES), {})
    expect_adam("joint prior graphed epoch, a replay", {})
    steps = 2 * HYPERPRIOR_STEPS
    if int(state.step) != steps or not bool(torch.isfinite(state.params["all"]).all()):
        raise AssertionError(f"joint prior: step {int(state.step)}, expected {steps}, "
                             "or parameters not finite")
    gk.reset_launch_counts()
    ak.reset_launch_counts()
    batch = dataset[torch.as_tensor(rows[0], device=DEVICE)]
    fns["train_step"](state, batch, noise)
    torch.cuda.synchronize()
    launches = dict(gk.LAUNCHES)
    expect_launches("one joint prior train_step", launches, per_step)
    expect_adam("one joint prior train_step", {(1, 1): 1})
    phases = fns["train_epoch"].phase_ms()
    print("  joint prior graphed step, ms by phase: " + ", ".join(
        f"{name} {ms:.3f}" for (name, ms) in phases.items()))
    return {"joint prior training": launches}


def kernel_entries(on_path, path_launches, kernel_results):
    """The kernels line's entries: each ``(name, path, shape)`` of
    ``on_path`` with its launches on that path and its times."""
    kernels = []
    for (name, path, shape) in on_path:
        launches = path_launches[path][name]
        if launches <= 0:
            raise AssertionError(f"{name} never launched on the {path} path")
        result = kernel_results[(name, shape)]
        forward = BACKWARD_VARIANTS.get(name, name)
        stacked = forward in STACKED_VARIANTS
        single = STACKED_VARIANTS[forward][0] if stacked else WIDE_VARIANTS.get(forward, forward)
        # The gradient kernel replaces no TPU kernel. Its max_abs_err is the
        # largest of its three gradients'; beside it the largest gap of a
        # gradient over that gradient's largest entry. Its launches are the
        # tile pass's; on a training path each of them asks for grad_gamma
        # and grad_beta, so each runs one reduction (REDUCE, counted apart
        # and held to that by the path's expectations), timed apart where
        # the profiler's trace held every launch.
        backward = ({"max_gap_to_largest": result["max_gap"], "reduce_launches": launches,
                     "reduce_ms": (result["split"] or {}).get(BACKWARD_KERNELS[1]),
                     "tile_pass_ms": (result["split"] or {}).get(BACKWARD_KERNELS[0])}
                    if name in BACKWARD_VARIANTS else {})
        kernels.append({
            "name": name, "route": "cuda", "source": KERNEL_SOURCE,
            "replaces": (None if name in BACKWARD_VARIANTS
                         else f"{TPU_KERNELS}:{VARIANTS[single][5]}"), "launches": launches,
            "max_abs_err": result["max_abs_err"], **backward, "ms": result["ms"],
            "ms_eager": result["ms_eager"], "plain_ms": result["plain_ms"],
            "bound_ms": result["bound_ms"], "bound_by": result["bound_by"], "library_ms": None,
            "path": path, "rows": ROWS[shape.split()[0]],
            "models": (1 if shape.endswith("x1") else STACKED_MODELS) if stacked else 1,
            "channels": 192 if forward in WIDE_VARIANTS else 128})
    return kernels


# The hyperprior's entries of the kernels line (phase 13).
HYPERPRIOR_ON_PATH = [(name, "hyperprior training", shape)
                      for name in ("gdn_f32", "igdn_f32", "gdn_f32_backward", "igdn_f32_backward")
                      for shape in HYPERPRIOR_SHAPES]
# The joint prior's 192-channel entries (phase 14), their launches from
# the path's own run.
JOINT_ON_PATH = [(name, "joint prior training", shape)
                 for name in ("gdn_f32_192", "igdn_f32_192", "gdn_f32_192_backward",
                              "igdn_f32_192_backward")
                 for shape in HYPERPRIOR_SHAPES]


def _uniform_noise(shape, seed):
    generator = torch.Generator(DEVICE).manual_seed(seed)
    return torch.rand(shape, device=DEVICE, generator=generator) - 0.5


def check_projections(state, learn_bin_widths, ppi, max_itvs):
    from autoencoder_based_image_compression_tpu_torch import constants as csts
    from autoencoder_based_image_compression_tpu_torch.ops import density as dens

    # The floors as the float32 values the projections clamp to.
    (floor_gdn, min_bw, max_bw) = (numpy.float32(csts.MIN_GAMMA_BETA),
                                   numpy.float32(csts.MIN_BW), numpy.float32(csts.MAX_BW))
    for i in ((1, 2, 5, 6) if learn_bin_widths else (1, 2, 3, 4, 5, 6)):
        (gamma, beta) = (state.params[f"gamma_{i}"], state.params[f"beta_{i}"])
        if not (torch.equal(gamma, gamma.t()) and float(gamma.min()) >= floor_gdn
                and float(beta.min()) >= floor_gdn):
            raise AssertionError(f"GDN projection {i} does not hold")
    (low, high) = (float(state.bin_widths.min()), float(state.bin_widths.max()))
    if not (min_bw <= low and high <= max_bw):
        raise AssertionError(f"bin widths [{low}, {high}] outside [0.8, 4.0]")
    mask = dens.active_mask(state.density.nb_itvs_per_side, ppi, max_itvs)
    floor = numpy.float32(csts.LOW_PROJECTION)
    parameters = state.density.parameters
    if not (bool((parameters[:, mask == 0] == floor).all()) and float(parameters.min()) >= floor):
        raise AssertionError("density projection does not hold")
    for leaf in (*state.params.values(), parameters, state.bin_widths):
        if leaf.requires_grad or not bool(torch.isfinite(leaf).all()):
            raise AssertionError("a state leaf is not finite or still carries a graph")


def check_rd_gradient(state, batch, noise, learn_bin_widths, ppi, max_itvs):
    """The gradient of the rate-distortion loss through the kernels
    against the same through plain GDN (the stacked wrapper of
    ``conv_eae``, which one model's step runs as a stack of one, swapped
    for the plain version), same state, batch and noise. Each parameter's
    gradient within 1e-4 of its largest entry."""
    from autoencoder_based_image_compression_tpu_torch.models import conv_eae
    from autoencoder_based_image_compression_tpu_torch.ops.kernels import gdn_kernel as gk
    from autoencoder_based_image_compression_tpu_torch.train import step

    def plain_nhwc(x, gamma, beta, inverse=False):
        stacked = x.reshape(-1, gamma.shape[0], gamma.shape[-1])
        return gk.gdn_stacked_2d_plain(stacked, gamma, beta, inverse).reshape(x.shape)

    args = (state, batch, noise, TRAIN_GAMMA, learn_bin_widths, ppi, max_itvs)
    gk.reset_launch_counts()
    (grads, grads_bw, loss) = step.rd_gradients(*args)
    launched = sum(gk.LAUNCHES.values())
    with mock.patch.object(conv_eae, "gdn_stacked_nhwc", plain_nhwc):
        (plain, plain_bw, plain_loss) = step.rd_gradients(*args)
    if launched == 0 or sum(gk.LAUNCHES.values()) != launched:
        raise AssertionError("the kernel run did not launch, or the plain run did")
    gaps = {name: _gap_to_max(grads[name], plain[name]) for name in grads}
    if learn_bin_widths:
        gaps["bin_widths"] = _gap_to_max(grads_bw, plain_bw)
    worst = max(gaps, key=gaps.get)
    print(f"  rate-distortion gradient through the kernels vs plain GDN: loss {float(loss):.6e} "
          f"vs {float(plain_loss):.6e}; largest gap / largest entry {gaps[worst]:.3e} "
          f"({worst}) [1e-4]")
    if not gaps[worst] <= 1e-4:
        raise AssertionError(f"rate-distortion gradient disagrees: {gaps}")


def traced_device_ms(run, steps, top=6):
    """Device time of one call of ``run`` from a profiler trace of
    ``steps`` calls: the time the device is busy, the union of the
    kernels' intervals (the kernels' own durations summed where the
    trace has no intervals; the two agree where kernels do not overlap),
    and the ``top`` kernels by time as ``(name, ms a call, launches a
    call)``. ``(None, [])`` when the trace holds no device time. The
    profiler slows the host, so the wall time under it is not reported."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from autoencoder_based_image_compression_tpu_torch.eval.ladder_probe import busy_us

    run()  # the profiler's own start-up stays out of the trace
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as trace:
        for _ in range(steps):
            run()
        torch.cuda.synchronize()
    kernels = [(event.key, getattr(event, "self_device_time_total",
                                   getattr(event, "self_cuda_time_total", 0)), event.count)
               for event in trace.key_averages() if event.device_type == DeviceType.CUDA]
    total_us = busy_us(trace) or sum(us for (_, us, _) in kernels)
    if total_us <= 0:
        return (None, [])
    kernels.sort(key=lambda row: -row[1])
    return (1e-3 * total_us / steps,
            [(name[:60], 1e-3 * us / steps, count / steps) for (name, us, count) in kernels[:top]])


def state_gap(got, expected):
    """Largest gap of two training states, leaf by leaf as a share of the
    leaf's largest entry (+1e-6): the measure of the JAX package's scan
    test (``tests/test_train_epoch_scan.py``)."""
    from autoencoder_based_image_compression_tpu_torch.train.state import state_leaves

    return max(float((a.double() - b.double()).abs().max() / (b.double().abs().max() + 1e-6))
               for (a, b) in zip(state_leaves(got), state_leaves(expected)))


def state_spread(got, expected):
    """Largest gap of two training states, leaf by leaf as a share of the
    leaf's norm, ``||a - b|| / (||b|| + 1e-6)``: after a few steps two
    runs differ in entries that Adam moved by its whole learning rate
    either way on a near-zero gradient (cuDNN's and the density
    scatter's atomics change its sign from run to run), rare entries
    that the share of the largest entry reads one at a time."""
    from autoencoder_based_image_compression_tpu_torch.train.state import state_leaves

    return max(float((a.double() - b.double()).norm() / (b.double().norm() + 1e-6))
               for (a, b) in zip(state_leaves(got), state_leaves(expected)))


def philox_draws_equal():
    """Whether the replays of a captured graph draw, from a generator
    registered with it, the numbers that the same calls made eagerly draw
    from the same generator state (two replays of two draws of a
    training batch's latent shape, against four eager draws)."""
    shape = (TRAIN_BATCH, TRAIN_CROP // 16, TRAIN_CROP // 16, 128)
    generator = torch.Generator(DEVICE).manual_seed(7)
    graph = torch.cuda.CUDAGraph()
    graph.register_generator_state(generator)
    with torch.cuda.graph(graph):
        drawn = torch.stack([torch.rand(shape, device=DEVICE, generator=generator)
                             for _ in range(2)])
    replayed = []
    for _ in range(2):
        graph.replay()
        replayed.append(drawn.clone())
    generator.manual_seed(7)
    eager = [torch.stack([torch.rand(shape, device=DEVICE, generator=generator)
                          for _ in range(2)]) for _ in range(2)]
    return all(torch.equal(a, b) for (a, b) in zip(replayed, eager))


def hold_graphed_epoch(tag, fns, state, dataset, step_noise, draws_equal, eager_epoch=None,
                       view=None, one_step=None, name="train", rows=None):
    """``fns[name + "_epoch"]`` on the card (replays of a captured step,
    with ``train/epoch_graph.py``) against the eager loop
    (``epoch_graph.epoch_over_rows``) from one state, at full width: the
    ``train_epoch`` of ``fns["train_step"]`` (``name="train"``) or the
    pre-fit ``fit_epoch`` of ``fns["training_fct"]`` (``name="fit"``),
    over ``rows`` (by default ``GRAPHED_STEPS`` batches of a permutation
    of the set, at the training batch).

    One step, with per-batch noise (and with a generator where the
    graph's draws equal the eager ones): within ``ONE_STEP_GAP`` of each
    leaf's largest entry. ``GRAPHED_STEPS`` steps: cuDNN's and the
    density scatter's atomics make two eager epochs differ, so the
    spread of ``EAGER_EPOCHS`` eager epochs (the largest
    :func:`state_spread` of two) is measured, and one of
    ``GRAPHED_EPOCHS`` graphed epochs must lie within it of its nearest
    eager epoch (each run, eager or graphed, differs from the others by
    its own draw of the atomics' order, and a single graphed epoch against
    three eager ones fell outside on a right graph). A pre-fit
    (``name="fit"``) only fits a density by SGD, which amplifies nothing:
    its runs differ by the order of the density gradient's atomic sums
    alone, a few float32 roundings, and the graph's replays, which launch
    back to back, sum in another typical order than the eager loop, so a
    right graphed epoch may sit just outside the eager spread (it read
    7.2e-08 against 7.16e-08 of the table's norm, and 4.5e-07 against
    4.04e-07). Its ``GRAPHED_STEPS`` steps are held to ``ONE_STEP_GAP`` of
    each leaf's largest entry of the nearest eager epoch, the one-step
    bound; the spread is printed beside it. An epoch fed other noise is
    printed beside either for scale.
    Then: the state the first epoch returned does not move
    when the next epoch runs, a graphed epoch counts no GDN launch, and
    the ms per step graphed and eager, the kernels' time a step in a
    trace of the graphed epoch, the captures' seconds and memory.
    ``step_noise(i)`` is batch ``i``'s explicit step noise; ``None`` for
    a step that draws nothing (the entropy study's fit).
    ``eager_epoch(state, dataset, rows, noise)`` is the eager loop (by
    default ``epoch_over_rows`` of the step) and ``view`` turns a returned
    state into one of a single structure (a sharded ladder's ``fetch``).
    ``one_step(graphed, eager)``, where given, holds
    the one step instead of ``ONE_STEP_GAP`` (raising outside its bound)
    and returns its bound's name. Returns ``(graphed ms a step, eager ms
    a step)``."""
    from autoencoder_based_image_compression_tpu_torch.ops.kernels import adam_kernel as ak
    from autoencoder_based_image_compression_tpu_torch.ops.kernels import gdn_kernel as gk
    from autoencoder_based_image_compression_tpu_torch.train import epoch_graph
    from autoencoder_based_image_compression_tpu_torch.train.state import (
        clone_state,
        state_leaves,
    )

    if torch.backends.cudnn.deterministic:
        raise AssertionError("torch.backends.cudnn.deterministic is set before the capture")
    if rows is None:
        order = numpy.random.default_rng(30).permutation(dataset.shape[0])
        rows = order[:GRAPHED_STEPS * TRAIN_BATCH].reshape(GRAPHED_STEPS, TRAIN_BATCH)
    step = fns["train_step" if name == "train" else "training_fct"]
    epoch = fns[f"{name}_epoch"]
    if step_noise is None:
        forms = {"no noise": lambda nb: None}
    else:
        noises = [step_noise(i) for i in range(GRAPHED_STEPS)]
        shared = torch.Generator(DEVICE)
        forms = {"per-batch noise": lambda nb: noises[:nb],
                 "generator": lambda nb: shared.manual_seed(41)}
    captures = len(epoch_graph.CAPTURES)

    view = view or (lambda st: st)
    eager_epoch = eager_epoch or (lambda st, data, rows_, noise_: epoch_graph.epoch_over_rows(
        step, st, data, rows_, noise_))

    def eager(nb, noise):
        return view(eager_epoch(state, dataset, rows[:nb], noise(nb)))

    for (form, noise) in forms.items():
        graphed = view(epoch(state, dataset, rows[:1], noise(1)))
        expected = eager(1, noise)
        (gap, spread) = (state_gap(graphed, expected), state_gap(eager(1, noise), expected))
        held = form != "generator" or draws_equal
        bound = (f"{ONE_STEP_GAP:g}" if one_step is None or not held
                 else one_step(graphed, expected))
        print(f"  one graphed step against one eager step, {tag}, {form}: largest gap "
              f"{gap:.3e} of a leaf's largest entry (eager against eager {spread:.3e}) "
              + (f"[{bound}]" if held else
                 "[not held: the graph's draws differ from the eager ones]"))
        if held and one_step is None and not gap <= ONE_STEP_GAP:
            raise AssertionError(f"{tag}: one graphed step is {gap} off the eager step")
    form = ("no noise" if step_noise is None else "generator" if draws_equal
            else "per-batch noise")
    noise = forms[form]
    eagers = [eager(GRAPHED_STEPS, noise) for _ in range(EAGER_EPOCHS)]
    returned = [epoch(state, dataset, rows, noise(GRAPHED_STEPS))
                for _ in range(GRAPHED_EPOCHS)]
    graphs = [view(graphed) for graphed in returned]
    spread = max(state_spread(a, b) for (a, b) in itertools.combinations(eagers, 2))
    nearest = [min(state_spread(graphed, e) for e in eagers) for graphed in graphs]
    nearest_gap = [min(state_gap(graphed, e) for e in eagers) for graphed in graphs]
    among = state_spread(graphs[0], graphs[1])
    finite = all(bool(torch.isfinite(leaf.double()).all())
                 for g in graphs for leaf in state_leaves(g))
    if step_noise is None:
        other = "none (the step draws nothing)"
    else:
        other = view(eager_epoch(state, dataset, rows, [step_noise(GRAPHED_STEPS + i)
                                                        for i in range(GRAPHED_STEPS)]))
        other = f"{min(state_spread(other, e) for e in eagers):.3e}"
    print(f"  {GRAPHED_EPOCHS} graphed epochs of {GRAPHED_STEPS} steps against "
          f"{EAGER_EPOCHS} eager epochs, {tag}, {form}: gap to the nearest eager epoch "
          + " and ".join(f"{gap:.3e}" for gap in nearest) + " of a leaf's norm ("
          + " and ".join(f"{gap:.3e}" for gap in nearest_gap) + " of its largest entry); eager "
          f"against eager up to {spread:.3e}, graphed against graphed {among:.3e} "
          + ("[one graphed epoch within that spread]" if name == "train" else
             f"[a density fit: one graphed epoch within {ONE_STEP_GAP:g} of each leaf's largest "
             "entry]") + f"; an epoch fed other noise {other}")
    steps_equal = all(torch.equal(g.step, eagers[0].step.to(g.step.device)) for g in graphs
                      if hasattr(g, "step"))
    held = (min(nearest) <= spread if name == "train" else min(nearest_gap) <= ONE_STEP_GAP)
    if not (held and finite and steps_equal):
        raise AssertionError(f"{tag}: the graphed epochs are {nearest} off the eager epochs "
                             f"(spread {spread}), finite {finite}, steps equal {steps_equal}")
    kept = clone_state(graphs[0])
    epoch(returned[0], dataset, rows, noise(GRAPHED_STEPS))
    if not all(torch.equal(a, b) for (a, b) in zip(state_leaves(view(returned[0])),
                                                    state_leaves(kept))):
        raise AssertionError(f"{tag}: the next graphed epoch moved the state returned before")
    torch.cuda.synchronize()
    gk.reset_launch_counts()
    ak.reset_launch_counts()
    epoch(state, dataset, rows, noise(GRAPHED_STEPS))
    torch.cuda.synchronize()
    expect_launches(f"graphed epoch ({GRAPHED_STEPS} replays, no capture), {tag}",
                    dict(gk.LAUNCHES), {})
    expect_adam(f"graphed epoch ({GRAPHED_STEPS} replays, no capture), {tag}", {})

    # Times: CUDA events round one epoch of GRAPHED_STEPS steps, median of 5.
    eager_ms = _median_ms(lambda: eager_epoch(state, dataset, rows, noise(GRAPHED_STEPS)),
                          GRAPHED_STEPS, 5)
    graphed_ms = _median_ms(lambda: epoch(state, dataset, rows, noise(GRAPHED_STEPS)),
                            GRAPHED_STEPS, 5)
    (traced_ms, _) = traced_device_ms(lambda: epoch(state, dataset, rows,
                                                    noise(GRAPHED_STEPS)), 2)
    made = epoch_graph.CAPTURES[captures:]
    print(f"  {tag}: {graphed_ms:.3f} ms a step graphed against {eager_ms:.3f} ms eager "
          f"(eager / graphed {eager_ms / graphed_ms:.2f}), epochs of {GRAPHED_STEPS} steps "
          "with their copies in and out; device busy in the graphed epoch "
          + ("not measured (the trace holds no device time)" if traced_ms is None else
             f"{100 * traced_ms / GRAPHED_STEPS / graphed_ms:.1f} % "
             f"({traced_ms / GRAPHED_STEPS:.3f} ms busy a step in a profiler trace)")
          + f"; {len(made)} captures: "
          + ", ".join(f"{c['nb_batches']} x {c['batch_size']} rows, {c['noise']}: warm-up "
                      f"{c['warmup_s']:.3f} s, capture {c['capture_s']:.3f} s, graph pool "
                      f"{c['pool_bytes'] / 2 ** 20:.0f} MiB" for c in made))
    return (graphed_ms, eager_ms)


def phase_training(kernel_results, learn_bin_widths, draws_equal):
    from autoencoder_based_image_compression_tpu_torch import constants as csts
    from autoencoder_based_image_compression_tpu_torch.cli import collect_stats
    from autoencoder_based_image_compression_tpu_torch.data.synthetic import (
        synthetic_luminance_stack,
    )
    from autoencoder_based_image_compression_tpu_torch.ops.kernels import adam_kernel as ak
    from autoencoder_based_image_compression_tpu_torch.ops.kernels import gdn_kernel as gk
    from autoencoder_based_image_compression_tpu_torch.ops.metrics import psnr_2d
    from autoencoder_based_image_compression_tpu_torch.parallel.inference import (
        PipelinedCompressor,
    )
    from autoencoder_based_image_compression_tpu_torch.train import checkpoint, loop
    from autoencoder_based_image_compression_tpu_torch.train.epoch_graph import rows_in_order
    from autoencoder_based_image_compression_tpu_torch.train.state import init_train_state
    from autoencoder_based_image_compression_tpu_torch.train.step import make_step_fns
    from autoencoder_based_image_compression_tpu_torch.utils.naming import experiment_suffix

    tag = "learned bin widths" if learn_bin_widths else "fixed bin widths"
    (ppi, max_itvs) = (csts.NB_POINTS_PER_INTERVAL, csts.MAX_ITVS_PER_SIDE)
    nb_batches = TRAIN_IMAGES // TRAIN_BATCH
    training = synthetic_luminance_stack(TRAIN_IMAGES, TRAIN_CROP, TRAIN_CROP, seed=10)
    state = init_train_state(torch.Generator().manual_seed(0), 1.0, learn_bin_widths,
                             device=DEVICE)
    fns = make_step_fns(TRAIN_GAMMA, learn_bin_widths)
    dataset = loop.device_resident_dataset(training, DEVICE)
    eval_batch = dataset[:TRAIN_BATCH]
    latent = (TRAIN_BATCH, TRAIN_CROP // 16, TRAIN_CROP // 16, csts.NB_MAPS_3)
    eval_noise = _uniform_noise(latent, 1)
    noise = torch.Generator(DEVICE).manual_seed(2)
    fns["train_step"](state, eval_batch, noise)  # warm-up: cuDNN plans; result dropped
    torch.cuda.synchronize()

    def indicators(state):
        full = loop.evaluate_full(state, eval_batch, fns, TRAIN_GAMMA, eval_noise)
        return (full["loss_density"], full["scaled_approx_entropy"] + full["rec_error"], full)

    # The steps launch the stacked kernel (a stack of one), the
    # evaluations the single-model one.
    per_step = {ONE_MODEL[name]: sum(1 for (variant, _) in TRAIN_SITES[learn_bin_widths]
                                     if variant == name) for name in ("gdn_f32", "igdn_f32")}
    gdn_encode = len(ENCODE_SITES[learn_bin_widths])
    (density_0, rd_0, _) = indicators(state)
    # The pre-fit epoch: the replays of one captured training_fct, which
    # encodes once a step (counted at its warm-up step and its capture).
    gk.reset_launch_counts()
    ak.reset_launch_counts()
    state = loop.preliminary_fitting(dataset, state, fns, TRAIN_BATCH, 1, noise)
    prefit_launches = dict(gk.LAUNCHES)
    expect_launches(f"pre-fit, {tag} ({nb_batches} batches, one capture)", prefit_launches,
                    {"gdn_f32_stacked": GRAPH_PREP_STEPS * gdn_encode})
    expect_adam(f"pre-fit, {tag}", {})
    gk.reset_launch_counts()
    (density_1, rd_1, _) = indicators(state)
    shuffle = numpy.random.default_rng(3)
    epoch_seconds = []
    for _ in range(TRAIN_EPOCHS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = loop.run_epoch_training(dataset, state, fns, TRAIN_BATCH, nb_batches, noise,
                                        permutation=shuffle.permutation(TRAIN_IMAGES))
        torch.cuda.synchronize()
        epoch_seconds.append(time.perf_counter() - t0)
    (density_2, rd_2, full) = indicators(state)
    launches = dict(gk.LAUNCHES)
    steps = TRAIN_EPOCHS * nb_batches
    sites = one_model_sites(TRAIN_SITES[learn_bin_widths])
    # Two evaluations encode and decode beside the steps' launches; the
    # epochs are replays of one captured step, counted at its warm-up
    # step and its capture.
    expect_launches(f"training, {tag}", launches, {
        "gdn_f32": 2 * gdn_encode, "igdn_f32": 2 * per_step["igdn_f32_stacked"],
        **{name: GRAPH_PREP_STEPS * n for (name, n) in per_step.items()},
        **backward_of({name: GRAPH_PREP_STEPS * n for (name, n) in per_step.items()})})
    # Adam: one launch a step over the model's leaves (a stack of one),
    # counted at the capture's two steps.
    adam_shape = (len(state.params), 1)
    expect_adam(f"training, {tag}", {adam_shape: GRAPH_PREP_STEPS})
    print(f"  training, {tag}: density loss {density_0:.6f} -> {density_1:.6f} over the "
          f"pre-fit ({nb_batches} steps); rate-distortion loss {rd_1:.6e} -> {rd_2:.6e} over "
          f"{steps} train_steps (before the pre-fit {rd_0:.6e}); rec error "
          f"{full['rec_error']:.6e}, mean approximate entropy {full['mean_approx_entropy']:.4f}, "
          f"mean entropy {full['mean_disc_entropy']:.4f}, grid "
          f"{int(state.density.nb_itvs_per_side)} intervals a side, step {int(state.step)}")
    if not density_1 < density_0:
        raise AssertionError(f"{tag}: the density loss did not fall over the pre-fit")
    if not rd_2 < rd_1:
        raise AssertionError(f"{tag}: the rate-distortion loss did not fall over the steps")
    if int(state.step) != steps or int(state.opt_eae.count) != steps:
        raise AssertionError(f"{tag}: step {int(state.step)}, expected {steps}")
    check_projections(state, learn_bin_widths, ppi, max_itvs)
    check_rd_gradient(state, eval_batch, eval_noise, learn_bin_widths, ppi, max_itvs)
    if torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 is on: the training path must run true fp32")

    gk.reset_launch_counts()
    ak.reset_launch_counts()
    fns["train_step"](state, eval_batch, noise)
    expect_launches(f"one train_step, {tag}", dict(gk.LAUNCHES),
                    {**per_step, **backward_of(per_step)})
    expect_adam(f"one train_step, {tag}", {adam_shape: 1})

    # Times: CUDA events round one call, median of 9.
    step_ms = _median_ms(lambda: fns["train_step"](state, eval_batch, noise), 1, 9)
    density_ms = _median_ms(lambda: fns["training_fct"](state, eval_batch, noise), 1, 9)
    eae_ms = _median_ms(lambda: fns["training_eae_bw"](state, eval_batch, noise), 1, 9)
    gdn_ms = sum(kernel_results[site]["ms"] for site in sites)
    epoch_s = float(numpy.median(epoch_seconds))
    (traced_ms, top_kernels) = traced_device_ms(
        lambda: fns["train_step"](state, eval_batch, noise), 10)
    print(f"  train_step, {tag}: {step_ms:.3f} ms (density phase {density_ms:.3f} ms, "
          f"autoencoder phase {eae_ms:.3f} ms); one epoch of {nb_batches} steps "
          f"{epoch_s:.4f} s = {nb_batches / epoch_s:.2f} steps/s, "
          f"{nb_batches * TRAIN_BATCH * TRAIN_CROP ** 2 / epoch_s / 1e6:.3f} Mpix/s; GDN forward "
          f"kernels {gdn_ms:.4f} ms ({100 * gdn_ms / step_ms:.1f} % of the step, "
          f"{len(sites)} launches); device busy share "
          + ("not measured (the trace holds no device time)" if traced_ms is None
             else f"{100 * traced_ms / step_ms:.1f} % ({traced_ms:.3f} ms of kernels a step in "
                  f"a profiler trace, against the step's {step_ms:.3f} ms)"))
    for (name, ms, count) in top_kernels:
        print(f"    {ms:.4f} ms a step, {count:.1f} launches: {name}")
    hold_graphed_epoch(tag, fns, state, dataset, lambda i: (
        _uniform_noise(latent, 60 + 2 * i), _uniform_noise(latent, 61 + 2 * i)), draws_equal)
    hold_graphed_epoch(f"pre-fit, {tag}", fns, state, dataset,
                       lambda i: _uniform_noise(latent, 90 + i), draws_equal, name="fit",
                       rows=rows_in_order(GRAPHED_STEPS, TRAIN_BATCH))

    with tempfile.TemporaryDirectory() as root:
        exp_dir = os.path.join(root, experiment_suffix(1.0, TRAIN_GAMMA, learn_bin_widths))
        path = os.path.join(exp_dir, "model_1")
        checkpoint.save_checkpoint(path, state)
        checkpoint.mark_checkpoint_complete(path)
        template = init_train_state(torch.Generator().manual_seed(9), 1.0, learn_bin_widths,
                                    device=DEVICE)
        loaded = checkpoint.load_checkpoint(path, template)
        (saved, back) = (checkpoint.state_to_jax(state), checkpoint.state_to_jax(loaded))
        if set(saved) != set(back) or not all(numpy.array_equal(saved[key], back[key])
                                              for key in saved):
            raise AssertionError(f"{tag}: the checkpoint did not load back equal")
        checkpoint.save_params_artifact(os.path.join(exp_dir, "params_trained.npz"),
                                        state.params, state.bin_widths, step=int(state.step))
        extra = os.path.join(root, "extra.npy")
        numpy.save(extra, synthetic_luminance_stack(EXTRA_IMAGES, TRAIN_CROP, TRAIN_CROP, 11))
        collect_stats.main(
            ["1.0", str(TRAIN_GAMMA), "1", "--from_params", "--path_to_extra_data", extra,
             "--results_root", root, "--device", DEVICE]
            + (["--learn_bin_widths"] if learn_bin_widths else []))
        stats_dir = os.path.join(exp_dir, "statistics")
        map_mean = numpy.load(os.path.join(stats_dir, "map_mean.npy"))
        probabilities = numpy.load(os.path.join(stats_dir, "binary_probabilities_1.npy"))
        with open(os.path.join(stats_dir, "idx_map_exception.pkl"), "rb") as file:
            idx_exc = pickle.load(file)
        (params_np, bin_widths) = checkpoint.load_params_artifact(
            os.path.join(exp_dir, "params_trained.npz"))
    images = synthetic_luminance_stack(SERVED_IMAGES, TRAIN_CROP, TRAIN_CROP, seed=12)
    compressor = PipelinedCompressor(
        checkpoint.params_from_jax(params_np), bin_widths, learn_bin_widths, probabilities,
        map_mean, idx_map_exception=idx_exc, batch_size=BATCH,
        fast_path="bf16w+" if learn_bin_widths else None, verify=True, reconstruct=True,
        device=DEVICE)
    (recs, bits) = compressor(images)
    if recs.shape != images.shape or recs.dtype != numpy.uint8 or not numpy.all(bits > 0):
        raise AssertionError(f"{tag}: served reconstructions {recs.shape} {recs.dtype}, bits "
                             f"{bits}")
    psnrs = [psnr_2d(images[i, :, :, 0], recs[i, :, :, 0]) for i in range(SERVED_IMAGES)]
    print(f"  trained {steps} steps, checkpointed, statistics on {EXTRA_IMAGES} held-out crops, "
          f"served {SERVED_IMAGES} images ({compressor.fast_path or 'fp32'}, verified): "
          f"{bits.sum() / images[..., 0].size:.4f} bpp, PSNR mean {numpy.mean(psnrs):.4f} dB")
    if not numpy.all(numpy.isfinite(psnrs)):
        raise AssertionError(f"{tag}: PSNR {psnrs}")
    return {f"training, {tag}": launches, f"pre-fit, {tag}": prefit_launches}


def _run_printing(main, args, keep=None):
    """``(main(args), what it printed)``, the printed lines shown indented
    (only those that start with one of ``keep``, when it is given)."""
    captured = io.StringIO()
    with contextlib.redirect_stdout(captured):
        result = main(args)
    printed = captured.getvalue()
    for line in printed.splitlines():
        if line.strip() and (keep is None or line.lstrip().startswith(keep)):
            print(f"    | {line}")
    return (result, printed)


def phase_ladder(draws_equal):
    """The gamma ladder at full width through ``cli/train_ladder``, held
    against the single-model step functions, and its graphed epoch
    against the eager loop. Returns the path's launch counts."""
    from autoencoder_based_image_compression_tpu_torch import constants as csts
    from autoencoder_based_image_compression_tpu_torch.cli import train_ladder
    from autoencoder_based_image_compression_tpu_torch.data.synthetic import (
        synthetic_luminance_stack,
    )
    from autoencoder_based_image_compression_tpu_torch.eval import ladder_probe
    from autoencoder_based_image_compression_tpu_torch.models import conv_eae
    from autoencoder_based_image_compression_tpu_torch.ops.kernels import adam_kernel as ak
    from autoencoder_based_image_compression_tpu_torch.ops.kernels import gdn_kernel as gk
    from autoencoder_based_image_compression_tpu_torch.train import checkpoint, ladder, loop
    from autoencoder_based_image_compression_tpu_torch.train.epoch_graph import rows_in_order
    from autoencoder_based_image_compression_tpu_torch.train.state import init_train_state
    from autoencoder_based_image_compression_tpu_torch.train.step import make_step_fns
    from autoencoder_based_image_compression_tpu_torch.utils.naming import experiment_suffix

    gammas = train_ladder.GAMMAS_DEFAULT
    nb_models = len(gammas)
    nb_batches = LADDER_IMAGES // TRAIN_BATCH
    seed = 0
    training = synthetic_luminance_stack(LADDER_IMAGES, TRAIN_CROP, TRAIN_CROP, seed=20)
    validation = synthetic_luminance_stack(TRAIN_BATCH, TRAIN_CROP, TRAIN_CROP, seed=21)
    dataset = loop.device_resident_dataset(training, DEVICE)
    eval_batch = dataset[:TRAIN_BATCH]
    latent = (TRAIN_BATCH, TRAIN_CROP // 16, TRAIN_CROP // 16, csts.NB_MAPS_3)
    eval_noise = _uniform_noise(latent, 1)
    fns = ladder.make_ladder_step_fns(gammas)
    single_fns = [make_step_fns(gamma, False) for gamma in gammas]

    def indicators(states):
        """Per model: (density loss, rate-distortion loss) on the
        evaluation batch with the evaluation noise."""
        rows = []
        for (k, gamma) in enumerate(gammas):
            full = loop.evaluate_full(ladder.ladder_slice_state(states, k, gamma), eval_batch,
                                      single_fns[k], gamma, eval_noise)
            rows.append((full["loss_density"],
                         full["scaled_approx_entropy"] + full["rec_error"]))
        return numpy.array(rows)

    # The CLI's own start and pre-fit, made again here from the same seeds,
    # so that the losses can be read before and after the pre-fit.
    start = ladder.init_ladder_state(torch.Generator().manual_seed(seed), gammas, 1.0,
                                     device=DEVICE)
    before = indicators(start)
    # The pre-fit: the replays of one captured stacked training_fct, which
    # encodes once a step (3 stacked GDN sites), counted at its warm-up
    # step and its capture.
    gk.reset_launch_counts()
    prefit = loop.preliminary_fitting(dataset, start, fns, TRAIN_BATCH, 1,
                                      torch.Generator(DEVICE).manual_seed(seed + 1))
    prefit_launches = dict(gk.LAUNCHES)
    expect_launches(f"ladder pre-fit ({nb_batches} batches, one capture)", prefit_launches,
                    {"gdn_f32_stacked": 3 * GRAPH_PREP_STEPS})
    fitted = indicators(prefit)
    # Adam: one launch a ladder step over the 23 stacked leaves of the seven models.
    adam_shape = (len(start.params), nb_models)

    gk.reset_launch_counts()
    ak.reset_launch_counts()
    with tempfile.TemporaryDirectory() as root:
        (path_training, path_validation) = (os.path.join(root, "training.npy"),
                                            os.path.join(root, "validation.npy"))
        numpy.save(path_training, training)
        numpy.save(path_validation, validation)
        results_root = os.path.join(root, "results")

        def cli_args(idx_training):
            return ["1.0", str(idx_training), "--nb_epochs_training", "1", "--batch_size",
                    str(TRAIN_BATCH), "--nb_eval_examples", str(TRAIN_BATCH),
                    "--path_to_training_data", path_training, "--path_to_validation_data",
                    path_validation, "--results_root", results_root, "--seed", str(seed),
                    "--device", DEVICE]

        def load_part(idx_model):
            template = init_train_state(torch.Generator().manual_seed(9), 1.0, False,
                                        device=DEVICE)
            paths = [os.path.join(results_root, experiment_suffix(1.0, gamma, False),
                                  f"model_{idx_model}") for gamma in gammas]
            for path in paths:
                if not checkpoint.checkpoint_part_complete(path):
                    raise AssertionError(f"{path} is not a finished part")
            return ladder.ladder_stack_states(
                [checkpoint.load_checkpoint(path, template) for path in paths])

        (_, printed) = _run_printing(train_ladder.main, cli_args(0))
        part_launches = dict(gk.LAUNCHES)
        expect_adam("ladder training (part 0, the epoch's capture)",
                    {adam_shape: GRAPH_PREP_STEPS})
        trained = load_part(1)
        try:
            train_ladder.main(cli_args(0))
        except RuntimeError as error:
            print(f"  part 0 again: refused ({error})")
        else:
            raise AssertionError("part 0 was retrained over its checkpoints")
        (_, printed_1) = _run_printing(train_ladder.main, cli_args(1))
        resumed = load_part(2)
    # Part 0, every GDN site one stacked launch for the seven models: the
    # pre-fit encodes once a step; each of the two evaluations (training
    # and validation portion) encodes and decodes once; a ladder step
    # encodes and decodes once, 3 GDN + 3 IGDN. The pre-fit's 12 steps and
    # the epoch's 12 are the replays of one captured step each (counted at
    # its warm-up and capture).
    expect_launches("ladder training (part 0)", part_launches, {
        "gdn_f32_stacked": 3 * (GRAPH_PREP_STEPS + 2 + GRAPH_PREP_STEPS),
        "igdn_f32_stacked": 3 * (2 + GRAPH_PREP_STEPS),
        **backward_of({"gdn_f32_stacked": 3 * GRAPH_PREP_STEPS,
                       "igdn_f32_stacked": 3 * GRAPH_PREP_STEPS})})
    epoch = re.search(r"\(([0-9.]+) ladder-steps/s, ([0-9.]+) model-Mpix/s aggregate\)", printed)
    if epoch is None or f"global step {nb_batches})" not in printed_1:
        raise AssertionError("the ladder CLI's epoch lines are not as expected")
    steps = [int(step) for step in resumed.step.tolist()]
    if trained.step.tolist() != [nb_batches] * nb_models or steps != [2 * nb_batches] * nb_models:
        raise AssertionError(f"ladder steps {trained.step.tolist()} then {steps}")

    after = indicators(trained)
    for (k, gamma) in enumerate(gammas):
        print(f"  gamma {gamma:>7.0f}: density loss {before[k, 0]:.4f} -> {fitted[k, 0]:.4f} over "
              f"the pre-fit ({nb_batches} steps); rate-distortion loss {fitted[k, 1]:.6e} -> "
              f"{after[k, 1]:.6e} over {nb_batches} ladder steps; grid "
              f"{int(trained.density.nb_itvs_per_side[k])}")
    if not (fitted[:, 0] < before[:, 0]).all():
        raise AssertionError("a model's density loss did not fall over the pre-fit")
    if not (after[:, 1] < fitted[:, 1]).all():
        raise AssertionError("a model's rate-distortion loss did not fall over the steps")
    for k in range(nb_models):
        for other in range(k + 1, nb_models):
            if torch.allclose(trained.params["weights_1"][k], trained.params["weights_1"][other]):
                raise AssertionError(f"ladder models {k} and {other} did not diverge")
    if not bool((trained.bin_widths == 1.0).all() and (resumed.bin_widths == 1.0).all()):
        raise AssertionError("a ladder step moved the bin widths")
    for k in range(nb_models):
        check_projections(ladder.ladder_slice_state(trained, k), False,
                          csts.NB_POINTS_PER_INTERVAL, csts.MAX_ITVS_PER_SIDE)

    noise = torch.Generator(DEVICE).manual_seed(2)
    gk.reset_launch_counts()
    ak.reset_launch_counts()
    fns["train_step"](trained, eval_batch, noise)
    expect_launches("one ladder train_step", dict(gk.LAUNCHES),
                    {"gdn_f32_stacked": 3, "igdn_f32_stacked": 3,
                     **backward_of({"gdn_f32_stacked": 3, "igdn_f32_stacked": 3})})
    expect_adam("one ladder train_step", {adam_shape: 1})

    # Model k of the stacked ladder against a single-model run from the
    # same start on the same batches and noise: one step at the JAX
    # package's bounds for its vmapped ladder against single models
    # (tests/test_ladder.py:67-80), then LADDER_COMPARED_STEPS steps at
    # Adam's bound.
    batches = [dataset[i * TRAIN_BATCH:(i + 1) * TRAIN_BATCH]
               for i in range(LADDER_COMPARED_STEPS)]
    noises = [[(_uniform_noise(latent, 100 + 20 * i + 2 * k),
                _uniform_noise(latent, 101 + 20 * i + 2 * k)) for k in range(nb_models)]
              for i in range(LADDER_COMPARED_STEPS)]
    stepped = [trained]
    for (batch, step_noise) in zip(batches, noises):
        stepped.append(fns["train_step"](stepped[-1], batch, step_noise))
    bound_gap = 2 * csts.LR_EAE * LADDER_COMPARED_STEPS * (1 + 1e-4)
    (worst_gap, outside, entries) = (0.0, 0, 0)
    (one_gap, one_share, one_density) = (0.0, 1.0, 0.0)
    for (k, gamma) in enumerate(gammas):
        singles_k = [ladder.ladder_slice_state(trained, k, gamma)]
        for (batch, step_noise) in zip(batches, noises):
            singles_k.append(single_fns[k]["train_step"](singles_k[-1], batch, step_noise[k]))
        for (name, expected) in singles_k[1].params.items():
            gap = (stepped[1].params[name][k] - expected).abs()
            one_gap = max(one_gap, float(gap.max()))
            one_share = min(one_share, float((gap <= 2e-6).double().mean()))
        (got_table, table) = (stepped[1].density.parameters[k], singles_k[1].density.parameters)
        one_density = max(one_density, float(((got_table - table).abs() - 5e-4 * table.abs())
                                             .max()))
        for (name, expected) in singles_k[-1].params.items():
            gap = (stepped[-1].params[name][k] - expected).abs()
            worst_gap = max(worst_gap, float(gap.max()))
            outside += int((gap > 1e-6 + 1e-5 * expected.abs()).sum())
            entries += gap.numel()
        for i in (1, -1):
            if int(stepped[i].density.nb_itvs_per_side[k]) != int(
                    singles_k[i].density.nb_itvs_per_side):
                raise AssertionError(f"ladder model {k}: another grid than the single-model run")
    print(f"  stacked ladder vs single-model train_steps, one step, {nb_models} models: largest "
          f"parameter gap {one_gap:.3e} [5e-4], least share of a leaf within 2e-6 "
          f"{one_share:.6f} [> 0.995], density table beyond rtol 5e-4 by {one_density:.3e} "
          f"[1e-4]; grids equal")
    print(f"  stacked ladder vs single-model runs, {LADDER_COMPARED_STEPS} steps: largest "
          f"parameter gap {worst_gap:.3e}; {outside} of {entries} entries outside rtol 1e-5 / "
          f"atol 1e-6 (Adam's bound {bound_gap:.1e})")
    if not (one_gap <= 5e-4 and one_share > 0.995 and one_density <= 1e-4):
        raise AssertionError("a stacked ladder step is outside the JAX bounds of its "
                             "single-model steps")
    # The density gradient's scatter-add sums in an order that varies from
    # run to run, so an entry whose gradient is near zero may move by the
    # learning rate either way; no more than that, and in few entries.
    if worst_gap > bound_gap or outside > 1e-4 * entries:
        raise AssertionError("a ladder model disagrees with its single-model run")

    # Times: CUDA events round one call, median of 7, against the loop of
    # the seven single-model steps.
    singles = [ladder.ladder_slice_state(trained, k, gamma) for (k, gamma) in enumerate(gammas)]
    ladder_ms = _median_ms(lambda: fns["train_step"](trained, eval_batch, noise), 1, 7)
    singles_ms = _median_ms(
        lambda: [single_fns[k]["train_step"](singles[k], eval_batch, noise)
                 for k in range(nb_models)], 1, 7)
    (split, top_kernels, busy_ms) = ladder_probe.kernel_split(
        lambda: fns["train_step"](trained, eval_batch, noise), 5)
    traced_ms = sum(split.values())
    print(f"  stacked ladder train_step ({nb_models} models): {ladder_ms:.3f} ms eager against "
          f"{singles_ms:.3f} ms for {nb_models} single-model train_steps; the CLI's epoch of "
          f"{nb_batches}: {epoch.group(1)} ladder-steps/s, {epoch.group(2)} model-Mpix/s "
          "aggregate; device busy share "
          + ("not measured (the trace holds no device time)" if busy_ms is None
             else f"{100 * busy_ms / ladder_ms:.1f} % ({busy_ms:.3f} ms busy a ladder step in a "
                  f"profiler trace; the kernels' durations sum to {traced_ms:.3f} ms, as they "
                  f"overlap: cuDNN {split['cuDNN']:.3f}, GDN {split['GDN']:.3f}, elementwise / "
                  f"reduce / the rest {split['other']:.3f})"))
    for (name, ms, count) in top_kernels[:8]:
        print(f"    {ms:.4f} ms a ladder step, {count:.1f} launches: {name}")
    print(f"  conv sites of a ladder step, grouped over the {nb_models} models against "
          f"{nb_models} convs on channel slices, ms fprop / dgrad / wgrad replayed from CUDA "
          f"graphs (separate at {sorted(conv_eae.SEPARATE_SITES)}):")
    for (site, forms) in ladder_probe.conv_site_times(nb_models, TRAIN_BATCH,
                                                      TRAIN_CROP).items():
        totals = {form: sum(t for t in times if t is not None) for (form, times) in forms.items()}
        print(f"    {site:8s} " + "; ".join(
            f"{form} " + " / ".join("-" if t is None else f"{t:.4f}" for t in times)
            + f" (sum {totals[form]:.4f})" for (form, times) in forms.items())
            + f" -> {'separate' if site in conv_eae.SEPARATE_SITES else 'grouped'}")
    hold_graphed_epoch(f"the ladder of {nb_models}", fns, trained, dataset, lambda i: [
        (_uniform_noise(latent, 200 + 20 * i + 2 * k), _uniform_noise(latent, 201 + 20 * i + 2 * k))
        for k in range(nb_models)], draws_equal)
    hold_graphed_epoch(f"the ladder's pre-fit ({nb_models} models)", fns, trained, dataset,
                       lambda i: [_uniform_noise(latent, 400 + 20 * i + k)
                                  for k in range(nb_models)], draws_equal, name="fit",
                       rows=rows_in_order(GRAPHED_STEPS, TRAIN_BATCH))
    return {"ladder training": part_launches, "ladder pre-fit": prefit_launches}


def _campaign_launches(args, one_model=False):
    """GDN / IGDN launches of the campaign's training stage: every part of
    the eight models, or (``one_model``) of one fixed model's last part.
    A part: the pre-fit (part 0 only) encodes once a step, each epoch's
    two evaluations encode and decode once, a step encodes once (its
    density and autoencoder phases share the latents) and decodes once,
    and the part's pre-fit and epochs replay one captured step each,
    counted at its warm-up and its capture; 3 sites a fixed-bin-width model, 2 for the
    learned one; those two steps' sites run their backward. The ladder's models share
    each launch of the stacked kernel; a model trained alone steps as a stack of one,
    on the stacked kernel too, and evaluates on the single-model kernel."""
    launches = collections.Counter()
    # (sites, the evaluations' variant, the steps' variant)
    models = ([(3, "", "_stacked")] if one_model else
              [(3, "_stacked", "_stacked"), (2, "", "_stacked")])
    parts = [args.nb_parts - 1] if one_model else range(args.nb_parts)
    for idx_part in parts:
        for (sites, evaluated, stepped) in models:
            for name in ("gdn_f32", "igdn_f32"):
                launches[name + evaluated] += sites * 2 * args.nb_epochs
                launches[name + stepped] += sites * GRAPH_PREP_STEPS
                launches[name + stepped + "_backward"] += sites * GRAPH_PREP_STEPS
                launches[REDUCE] += sites * GRAPH_PREP_STEPS
            if idx_part == 0:
                launches["gdn_f32" + stepped] += sites * GRAPH_PREP_STEPS
    return dict(launches)


def _campaign_adam(args, experiments, one_model=False):
    """Adam's launches of the campaign's training stage, ``{(leaves,
    models): launches}``: each part's epochs replay one captured step a
    model (the ladder's models one stacked step), counted at its warm-up
    and its capture; a pre-fit steps no Adam. ``one_model``: one fixed
    model's last part, trained alone as a stack of one."""
    from autoencoder_based_image_compression_tpu_torch.models.conv_eae import (
        init_conv_eae_params,
    )

    def leaves(learn_bin_widths):
        return len(init_conv_eae_params(torch.Generator().manual_seed(0), learn_bin_widths))

    if one_model:
        return {(leaves(False), 1): GRAPH_PREP_STEPS}
    ladder = sum(not learned for (_, _, learned) in experiments)
    return {(leaves(False), ladder): args.nb_parts * GRAPH_PREP_STEPS,
            (leaves(True), 1): args.nb_parts * GRAPH_PREP_STEPS}


def _study_launches(nb_images, families):
    """GDN / IGDN launches of an RD study at batch 4: each point encodes
    and decodes every batch once; ``families`` is ``[(sites, points)]``."""
    count = (nb_images // BATCH) * sum(sites * points for (sites, points) in families)
    return {"gdn_f32": count, "igdn_f32": count}


def _part_steps(results_root, idx_model, experiments):
    """``{suffix: step}`` of the finished ``model_<idx_model>`` of each
    experiment; raises for a part that is missing or not finished."""
    from autoencoder_based_image_compression_tpu_torch.train.checkpoint import (
        checkpoint_part_complete,
    )
    from autoencoder_based_image_compression_tpu_torch.utils.naming import experiment_suffix

    steps = {}
    for (bw_init, gamma, learn_bw) in experiments:
        suffix = experiment_suffix(bw_init, gamma, learn_bw)
        path = os.path.join(results_root, suffix, f"model_{idx_model}")
        if not (os.path.isfile(path + ".npz") and checkpoint_part_complete(path)):
            raise AssertionError(f"{path} is not a finished part")
        with open(path + ".json") as file:
            steps[suffix] = json.load(file)["step"]
    return steps


def _hold_committed(kind, label, got, committed_dir, name, worst):
    """A curve array against the committed array of the same name (phase
    7's gates); returns what was seen."""
    expected = numpy.load(os.path.join(committed_dir, name))
    if got.shape != expected.shape or not numpy.all(numpy.isfinite(got)):
        raise AssertionError(f"{label} {kind}: shape {got.shape}, expected {expected.shape}")
    if kind == "psnrs":
        gap = float(numpy.abs(got - expected).max())
        worst["psnr"] = max(worst["psnr"], gap)
        if gap > RD_PSNR_DB:
            raise AssertionError(f"{label}: an image's PSNR is {gap:.4f} dB off")
        return f"PSNR gap {gap:.3e} dB (worst image)"
    if kind == "rates":
        mean_gap = float(numpy.abs(got.mean(axis=1) / expected.mean(axis=1) - 1.0).max())
        image_gap = float(numpy.abs(got / expected - 1.0).max())
        worst["mean_rate"] = max(worst["mean_rate"], mean_gap)
        worst["image_rate"] = max(worst["image_rate"], image_gap)
        if mean_gap > RD_MEAN_RATE or image_gap > RD_IMAGE_RATE:
            raise AssertionError(f"{label}: rates off by {mean_gap:.3e} (a point's mean) and "
                                 f"{image_gap:.3e} (an image)")
        return f"rate gap {mean_gap:.3e} (a point's mean), {image_gap:.3e} (an image)"
    equal = float(numpy.mean(got == expected))
    worst["deads"] = min(worst["deads"], equal)
    if equal < RD_DEADS_EQUAL:
        raise AssertionError(f"{label}: only {equal:.4f} of the dead-map counts are equal")
    return f"dead-map counts equal in {100 * equal:.2f} %"


def phase_rd_study():
    """The rate-distortion study on the committed models, held against
    the committed curves. Returns the path's launch counts."""
    from autoencoder_based_image_compression_tpu_torch.cli import reconstruct_kodak
    from autoencoder_based_image_compression_tpu_torch.data.synthetic import synthetic_kodak
    from autoencoder_based_image_compression_tpu_torch.eval import rd_sweep
    from autoencoder_based_image_compression_tpu_torch.ops.kernels import gdn_kernel as gk
    from autoencoder_based_image_compression_tpu_torch.ops.metrics import (
        bjontegaard_fit_quality,
        compute_bjontegaard,
    )
    from autoencoder_based_image_compression_tpu_torch.utils.naming import (
        experiment_suffix,
        float_to_str,
    )

    images = synthetic_kodak(seed=14)[..., 0]
    tag = hashlib.sha1(images.tobytes()).hexdigest()[:10]
    if tag != RD_IMAGES_TAG:
        raise AssertionError(f"the image set hashes to {tag}, not {RD_IMAGES_TAG}")
    gammas = reconstruct_kodak.GAMMAS_VARY
    multipliers = reconstruct_kodak.MULTIPLIERS
    device = torch.device(DEVICE)

    def load(bw_init, gamma, learn_bw):
        model = reconstruct_kodak._load_state(RESULTS_ROOT, bw_init, gamma, learn_bw, 1, device)
        if model is None:
            raise AssertionError(f"no trained model for {bw_init}, {gamma}, {learn_bw}")
        return model

    # The transforms' share of the time: the sweep's two device calls,
    # which end with the result on the host.
    device_s = [0.0]

    def timed(fn):
        def call(*args):
            t0 = time.perf_counter()
            out = fn(*args)
            device_s[0] += time.perf_counter() - t0
            return out
        return call

    families = {}
    worst = {"psnr": 0.0, "mean_rate": 0.0, "image_rate": 0.0, "deads": 1.0}

    def hold(kind, label, got, path):
        """One curve array against the committed array of the same name."""
        return _hold_committed(kind, label, got, COMMITTED_RD, os.path.basename(path), worst)

    gk.reset_launch_counts()
    with tempfile.TemporaryDirectory() as cache_dir, \
            mock.patch.object(rd_sweep, "encode_mini_batches",
                              timed(rd_sweep.encode_mini_batches)), \
            mock.patch.object(rd_sweep, "decode_mini_batches",
                              timed(rd_sweep.decode_mini_batches)):
        def sweep(label, kinds, stem, run):
            """Runs one family, holds it against the committed arrays,
            then calls it again: from the cache, without a launch."""
            before = dict(gk.LAUNCHES)
            (t0, d0) = (time.perf_counter(), device_s[0])
            arrays = run()
            (seconds, transforms) = (time.perf_counter() - t0, device_s[0] - d0)
            launched = {name: gk.LAUNCHES[name] - before.get(name, 0) for name in gk.LAUNCHES
                        if gk.LAUNCHES[name] != before.get(name, 0)}
            said = [hold(kind, label, array, os.path.join(cache_dir, f"{kind}_{stem}.npy"))
                    for (kind, array) in zip(kinds, arrays)]
            again = run()
            if any(gk.LAUNCHES[name] != before.get(name, 0) + count
                   for (name, count) in launched.items()) or not all(
                       numpy.array_equal(a, b) for (a, b) in zip(arrays, again)):
                raise AssertionError(f"{label}: the second call did not come from the cache")
            print(f"  {label}: {arrays[0].shape[0]} points x {arrays[0].shape[1]} images in "
                  f"{seconds:.2f} s (device transforms with their transfers {transforms:.2f} s, "
                  f"host rates and PSNRs {seconds - transforms:.2f} s); launches {launched}; "
                  + "; ".join(said) + "; second call from the cache, no launch")
            families[label] = arrays

        models = {gamma: load(1.0, gamma, False) for gamma in gammas}
        vary_id = "g" + "-".join(
            f"{float_to_str(g)}s{reconstruct_kodak._step_key(models[g].step)}" for g in gammas)
        sweep("EAE one model per gamma", ("rates", "psnrs"), f"vary_gamma_{vary_id}",
              lambda: rd_sweep.vary_gamma_fix_bin_widths(
                  images, {g: models[g].params for g in gammas}, gammas, BATCH, cache_dir,
                  experiment_id=vary_id))
        for (learn_bw, bw_init, label) in ((True, 0.5, "EAE learned bin widths"),
                                           (False, 1.0, "EAE fixed bin widths")):
            model = models[10000.0] if not learn_bw else load(bw_init, 10000.0, True)
            stats_dir = os.path.join(RESULTS_ROOT, experiment_suffix(bw_init, 10000.0, learn_bw),
                                     "statistics")
            map_mean = numpy.load(os.path.join(stats_dir, "map_mean.npy"))
            with open(os.path.join(stats_dir, "idx_map_exception.pkl"), "rb") as file:
                idx_exception = pickle.load(file)
            probabilities = [numpy.load(os.path.join(
                stats_dir, f"binary_probabilities_{float_to_str(m)}.npy")) for m in multipliers]
            fix_id = (f"{float_to_str(bw_init)}_{float_to_str(10000.0)}"
                      f"_s{reconstruct_kodak._step_key(model.step)}"
                      f"_m{'-'.join(float_to_str(m) for m in multipliers)}_coded")
            sweep(label, ("rates", "psnrs", "deads"),
                  f"fix_gamma_{'learn' if learn_bw else 'fixed'}_{fix_id}",
                  lambda: rd_sweep.fix_gamma(
                      images, model.params, model.bin_widths, learn_bw, multipliers, BATCH,
                      cache_dir, map_mean, probabilities, idx_exception, experiment_id=fix_id))
        launches = dict(gk.LAUNCHES)
        # 3 GDN + 3 IGDN a batch for a fixed-bin-width model, 2 + 2 for the
        # learned one; 7 + 9 and 9 points.
        expect_launches("rd study", launches, _study_launches(
            images.shape[0], [(3, len(gammas) + len(multipliers)), (2, len(multipliers))]))

        # Bjontegaard against the committed JPEG2000 curve (images x points).
        stem = ("jpeg2000_pillow_600-400-300-220-160-120-80-64-48-32-24-16-12-8_"
                + RD_IMAGES_TAG)
        (rates_j2k, psnrs_j2k) = (numpy.load(os.path.join(COMMITTED_RD, f"{kind}_{stem}.npy"))
                                  for kind in ("rates", "psnrs"))
        with open(os.path.join(COMMITTED_RD, "dictionary_bjontegaard.pkl"), "rb") as file:
            committed = pickle.load(file)
        for (label, arrays) in families.items():
            curves = (rates_j2k.mean(axis=0), psnrs_j2k.mean(axis=0),
                      arrays[0].mean(axis=1), arrays[1].mean(axis=1))
            delta = compute_bjontegaard(*curves, warn=False)
            quality = bjontegaard_fit_quality(*curves)
            was = committed[f"{label} vs JPEG2000"]["delta_pct"]
            print(f"  Bjontegaard {label} vs JPEG2000: {delta:+.4f} % bitrate (committed "
                  f"{was:+.4f} %), fit reliable {quality['reliable']}, overlap "
                  f"{quality['overlap_db']:.2f} dB")
            if not abs(delta - was) <= RD_BJONTEGAARD_POINTS:
                raise AssertionError(f"Bjontegaard {label}: {delta:+.4f} against {was:+.4f}")
        print(f"  largest gaps against the committed curves: PSNR {worst['psnr']:.3e} dB "
              f"[{RD_PSNR_DB}], a point's mean rate {worst['mean_rate']:.3e} [{RD_MEAN_RATE}], an "
              f"image's rate {worst['image_rate']:.3e} [{RD_IMAGE_RATE}], dead-map counts equal "
              f"{100 * worst['deads']:.2f} % [{100 * RD_DEADS_EQUAL:.0f} %]")

        # The CLI itself, over the same cache directory: its main where
        # matplotlib draws the figures, else its compute half; the anchor
        # module needs PIL.
        found = {name: importlib.util.find_spec(name) is not None
                 for name in ("PIL", "matplotlib")}
        print(f"  plotting and anchor packages: {found}")
        if found["PIL"]:
            for kind in ("rates", "psnrs"):  # the committed anchor, as the CLI caches it
                numpy.save(os.path.join(cache_dir, f"{kind}_{stem}.npy"),
                           numpy.load(os.path.join(COMMITTED_RD, f"{kind}_{stem}.npy")))
            path_images = os.path.join(cache_dir, "kodak.npy")
            numpy.save(path_images, images)
            entry = reconstruct_kodak.main if found["matplotlib"] else reconstruct_kodak.compute
            (_, printed) = _run_printing(entry, [
                "--code_lossless", "--path_to_kodak", path_images, "--results_root",
                RESULTS_ROOT, "--cache_dir", cache_dir, "--jpeg2000_backend", "pillow",
                "--device", DEVICE])
            if dict(gk.LAUNCHES) != launches:
                raise AssertionError("reconstruct_kodak did not find the sweeps' cache")
            with open(os.path.join(cache_dir, "dictionary_bjontegaard.pkl"), "rb") as file:
                summaries = pickle.load(file)
            if "4 RD curves written" not in printed or set(summaries) != {
                    f"{label} vs JPEG2000" for label in families}:
                raise AssertionError(f"reconstruct_kodak wrote {sorted(summaries)}")
            for (key, summary) in summaries.items():
                if not abs(summary["delta_pct"] - committed[key]["delta_pct"]) \
                        <= RD_BJONTEGAARD_POINTS:
                    raise AssertionError(f"reconstruct_kodak, {key}: {summary['delta_pct']}")
            figures = ("rate_distortion.png", "nb_dead_learn_bw.png", "nb_dead_fixed_bw.png")
            for name in figures if found["matplotlib"] else ():
                if not os.path.getsize(os.path.join(cache_dir, name)) > 0:
                    raise AssertionError(f"reconstruct_kodak drew no {name}")
            print(f"  cli/reconstruct_kodak.{entry.__name__} over the sweeps' cache: no launch, "
                  "the same Bjontegaard keys and savings"
                  + ("" if found["matplotlib"] else "; its figures not drawn (no matplotlib)"))
        else:
            print("  cli/reconstruct_kodak not driven: it codes the JPEG2000 anchor with PIL")
    return {"rd study": launches}


def phase_gate_sets():
    """The serving "bf16w+" mixes on two more image sets, through the
    scan path and through the pipeline: the worst image's delta against
    the fp32 transforms at multipliers 1, 4 and 10, which must hold the
    gate. The next scan mix, should the current one miss, is measured
    beside it."""
    from autoencoder_based_image_compression_tpu_torch.data.synthetic import synthetic_kodak
    from autoencoder_based_image_compression_tpu_torch.engine import quantized as engine
    from autoencoder_based_image_compression_tpu_torch.eval import gate_probe

    (params, bin_widths, map_mean, _, _) = load_model(LEARNED)
    serving = {
        "scan": gate_probe.mix_label("scan", "bf16", engine.BF16WPLUS_SCAN_MIX),
        "pipeline": gate_probe.mix_label("pipeline", "bf16", dict(
            fp32_enc_tail=engine.BF16WPLUS_ENC_TAIL, fp32_tail=engine.BF16WPLUS_DEC_TAIL,
            fp32_head=engine.BF16WPLUS_DEC_HEAD,
            exact_latents=engine.BF16WPLUS_DEC_EXACT_LATENTS))}
    beside = {"scan": ("e: fp32 tconv_4, folded kernel left fp32",
                       "f: fp32 head + fp32 IGDN_6"), "pipeline": ()}
    missed = []
    for seed in GATE_SEEDS:
        images = synthetic_kodak(seed=seed)
        for (through, label) in serving.items():
            rows = tuple(dict.fromkeys((label,) + beside[through]))
            mixes = {row: gate_probe.GATE_MIXES[through][row] for row in rows}
            table = gate_probe.gate_table(params, bin_widths, map_mean, images, through=through,
                                          batch_size=BATCH, device=DEVICE, mixes=mixes,
                                          show=lambda line: None)
            for row in rows:
                print(f"  synthetic_kodak(seed={seed}), through the {through}, {row}: worst "
                      "image " + "; ".join(f"x{m:g} {d:+.4f}" for (m, d) in table[row].items())
                      + (" dB (serving mix)" if row == label else " dB"))
            if not gate_probe.holds_gate(table[label]):
                missed.append((seed, through, table[label]))
    if missed:
        raise AssertionError(f"a serving bf16w+ mix misses the {gate_probe.GATE_DB} dB gate: "
                             f"{missed}")


def _free_port():
    import socket

    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _trained_state(exp_dir, learn_bin_widths):
    from autoencoder_based_image_compression_tpu_torch.train.state import init_train_state

    (params, bin_widths, _, _, _) = load_model(exp_dir)
    state = init_train_state(torch.Generator().manual_seed(0), 1.0, learn_bin_widths,
                             device=DEVICE)
    return state._replace(params={k: v.cuda() for (k, v) in params.items()},
                          bin_widths=torch.from_numpy(bin_widths).cuda())


def _state_gaps(got, expected):
    """``(largest weight gap, weight entries outside rtol 1e-5 / atol
    1e-6, entries, density table gap, bin-width gap)``."""
    (worst, outside, entries) = (0.0, 0, 0)
    for (name, value) in expected.params.items():
        gap = (got.params[name] - value).abs()
        worst = max(worst, float(gap.max()))
        outside += int((gap > 1e-6 + 1e-5 * value.abs()).sum())
        entries += gap.numel()
    density = float((got.density.parameters - expected.density.parameters).abs().max())
    bw = float((got.bin_widths - expected.bin_widths).abs().max())
    return (worst, outside, entries, density, bw)


def _hold_state(label, got, expected, steps=1):
    from autoencoder_based_image_compression_tpu_torch import constants as csts

    (worst, outside, entries, density, bw) = _state_gaps(got, expected)
    bound = 2 * csts.LR_EAE * steps * (1 + 1e-4)
    if int(got.density.nb_itvs_per_side.max()) != int(expected.density.nb_itvs_per_side.max()) \
            or not torch.equal(got.step, expected.step):
        raise AssertionError(f"{label}: another grid or step than the unsharded run")
    # Adam's first update turns reduction-order noise on a near-zero
    # gradient into a sign, and the card's density scatter-add sums in a
    # varying order: a weight may move by two learning rates, in few entries.
    if worst > bound or outside > 1e-4 * entries or density > 2.6e-6 or bw > 1.1e-6:
        raise AssertionError(f"{label}: weights {worst} ({outside} of {entries} outside), "
                             f"density table {density}, bin widths {bw}")
    return (worst, outside, entries, density, bw)


def phase_distributed(card, draws_equal):
    """The distributed layer on the card; returns each path's launch
    counts and the (variant, rows) counts its kernels were launched at."""
    from autoencoder_based_image_compression_tpu_torch import dryrun
    from autoencoder_based_image_compression_tpu_torch.cli import benchmark, train_ladder
    from autoencoder_based_image_compression_tpu_torch.data.synthetic import (
        synthetic_kodak,
        synthetic_luminance_stack,
    )
    from autoencoder_based_image_compression_tpu_torch.ops.kernels import adam_kernel as ak
    from autoencoder_based_image_compression_tpu_torch.ops.kernels import gdn_kernel as gk
    from autoencoder_based_image_compression_tpu_torch.parallel import distributed
    from autoencoder_based_image_compression_tpu_torch.parallel import spatial as bands_mod
    from autoencoder_based_image_compression_tpu_torch.parallel.continuous_batching import (
        stream_roundtrip,
    )
    from autoencoder_based_image_compression_tpu_torch.parallel.inference import (
        PipelinedCompressor,
        _quantize,
        roundtrip_batched,
    )
    from autoencoder_based_image_compression_tpu_torch.parallel.mesh import make_mesh
    from autoencoder_based_image_compression_tpu_torch.parallel.sharding import split_batch
    from autoencoder_based_image_compression_tpu_torch.parallel.train_parallel import (
        make_sharded_step_fns,
    )
    from autoencoder_based_image_compression_tpu_torch.train import ladder
    from autoencoder_based_image_compression_tpu_torch.train.epoch_graph import epoch_over_rows
    from autoencoder_based_image_compression_tpu_torch.train.step import (
        make_step_fns,
        rd_gradients,
    )
    from autoencoder_based_image_compression_tpu_torch import constants as csts

    paths = {}
    rows_seen = collections.Counter()

    def record(path):
        paths[path] = {name: n for (name, n) in gk.LAUNCHES.items() if n}
        rows_seen.update(gk.LAUNCH_ROWS)

    # --- (a) a world of one over NCCL.
    latent = (TRAIN_BATCH, TRAIN_CROP // 16, TRAIN_CROP // 16, csts.NB_MAPS_3)
    crops = torch.from_numpy(synthetic_luminance_stack(
        DIST_STEPS * TRAIN_BATCH, TRAIN_CROP, TRAIN_CROP, seed=30)).cuda()
    distributed.initialize(f"127.0.0.1:{_free_port()}", 1, 0, device=DEVICE)
    try:
        backend = "nccl" if DEVICE == "cuda" else "gloo"
        if torch.distributed.get_backend() != backend:
            raise AssertionError(f"backend {torch.distributed.get_backend()}, not {backend}")
        mesh = distributed.make_global_mesh(1)
        for (learn_bin_widths, exp_dir) in ((True, LEARNED), (False, FIXED)):
            tag = "learned bin widths" if learn_bin_widths else "fixed bin widths"
            state = _trained_state(exp_dir, learn_bin_widths)
            single = make_step_fns(TRAIN_GAMMA, learn_bin_widths)
            fns = make_sharded_step_fns(TRAIN_GAMMA, learn_bin_widths, mesh,
                                        distributed.global_state(state, mesh))
            noises = [(_uniform_noise(latent, 300 + 2 * i), _uniform_noise(latent, 301 + 2 * i))
                      for i in range(DIST_STEPS)]
            batches = [crops[i * TRAIN_BATCH:(i + 1) * TRAIN_BATCH] for i in range(DIST_STEPS)]
            fns["train_step"](state, batches[0], noises[0])  # warm-up: cuDNN plans
            torch.cuda.synchronize()
            (gaps, grad_gap, launches) = ([], 0.0, collections.Counter())
            current = state
            for (batch, noise) in zip(batches, noises):
                sharded_batch = distributed.global_batch(batch, mesh)
                gk.reset_launch_counts()
                ak.reset_launch_counts()
                got = fns["train_step"](distributed.global_state(current, mesh), sharded_batch,
                                        noise)
                launches.update({k: v for (k, v) in gk.LAUNCHES.items() if v})
                # Adam: one launch a sharded step over the replicated leaves.
                expect_adam(f"one sharded train_step, {tag}", {(len(current.params), 1): 1})
                rows_seen.update(gk.LAUNCH_ROWS)
                (grads, grads_bw, loss) = fns["rd_gradients"](current, sharded_batch, noise[1])
                (plain, plain_bw, plain_loss) = rd_gradients(
                    current, batch, noise[1], TRAIN_GAMMA, learn_bin_widths,
                    csts.NB_POINTS_PER_INTERVAL, csts.MAX_ITVS_PER_SIDE)
                step_gaps = [_gap_to_max(grads[n], plain[n]) for n in plain]
                if learn_bin_widths:
                    step_gaps.append(_gap_to_max(grads_bw, plain_bw))
                step_gaps.append(abs(float(loss) - float(plain_loss)) / abs(float(plain_loss)))
                grad_gap = max(grad_gap, max(step_gaps))
                expected = single["train_step"](current, batch, noise)
                gaps.append(_hold_state(f"sharded step, {tag}", distributed.fetch_replicated(
                    got, mesh), distributed.fetch_replicated(expected, mesh)))
                current = expected
            if grad_gap > 1e-5:
                raise AssertionError(f"sharded gradients, {tag}: gap {grad_gap}")
            paths[f"distributed training, {tag}"] = dict(launches)
            per_step = {name: DIST_STEPS * sum(
                1 for (v, _) in SHARDED_TRAIN_SITES[learn_bin_widths] if v == name)
                for name in ("gdn_f32", "igdn_f32")}
            # The density phase encodes without grad; the RD loss's sites
            # each run their backward.
            per_step.update(backward_of({name: DIST_STEPS * sum(
                1 for (v, _) in TRAIN_SITES[learn_bin_widths] if v == name)
                for name in ("gdn_f32", "igdn_f32")}))
            expect_launches(f"distributed training, {tag}", dict(launches), per_step)
            sharded_state = distributed.global_state(current, mesh)
            sharded_batch = distributed.global_batch(batches[0], mesh)
            sharded_ms = _median_ms(lambda: fns["train_step"](sharded_state, sharded_batch,
                                                              noises[0]), 1, 7)
            plain_ms = _median_ms(lambda: single["train_step"](current, batches[0], noises[0]),
                                  1, 7)
            print(f"  world of one over {backend.upper()}, {tag}: {DIST_STEPS} sharded "
                  f"train_steps each against the unsharded step from the same state and noise: "
                  f"gradients and loss within {grad_gap:.3e} of the largest entry [1e-5]; "
                  f"largest weight gap {max(g[0] for g in gaps):.3e} "
                  f"({max(g[1] for g in gaps)} entries outside rtol 1e-5 / atol 1e-6), "
                  f"density table {max(g[3] for g in gaps):.3e} [2.6e-6], bin "
                  f"widths {max(g[4] for g in gaps):.3e} [1.1e-6]; {sharded_ms:.3f} ms a sharded "
                  f"step against {plain_ms:.3f} ms unsharded (CUDA events, median of 7) [{card}]")
    finally:
        distributed.shutdown()

    # --- (b) the height-sharded round trip, two bands an image on the card.
    images = synthetic_kodak(seed=0)[:BATCH]
    bands = make_mesh(2, devices=[DEVICE, DEVICE])
    for (exp_dir, learn_bin_widths, tag) in ((LEARNED, True, "learned"), (FIXED, False, "fixed")):
        (params, bin_widths, _, _, _) = load_model(exp_dir)
        roundtrip_batched(params, images, bin_widths, learn_bin_widths, BATCH, mesh=bands,
                          spatial=True)  # warm-up
        walls = {}
        for (name, kwargs) in (("unsharded", dict(device=DEVICE)),
                               ("sharded", dict(mesh=bands, spatial=True))):
            times = []
            for _ in range(3):
                gk.reset_launch_counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = roundtrip_batched(params, images, bin_widths, learn_bin_widths, BATCH,
                                        **kwargs)
                times.append(time.perf_counter() - t0)
            walls[name] = (float(numpy.median(times)), out)
            if name == "sharded":
                record(f"spatial roundtrip, {tag}")
        # Two bands of one batch: each band runs every GDN site once.
        expect_launches(f"spatial roundtrip, {tag}", paths[f"spatial roundtrip, {tag}"],
                        {"gdn_f32": 4, "igdn_f32": 4} if learn_bin_widths else
                        {"gdn_f32": 4, "gdn_quantize_f32": 2, "igdn_f32": 6})
        gap = float(numpy.abs(walls["sharded"][1] - walls["unsharded"][1]).max())
        params_gpu = {k: v.cuda() for (k, v) in params.items()}
        bw = torch.from_numpy(bin_widths).cuda()
        batch = torch.from_numpy(images.astype(numpy.float32)).cuda()
        whole = _quantize(params_gpu, batch, bw, learn_bin_widths)
        pieces = split_batch(batch, bands, spatial=True)
        banded = bands_mod.quantize_bands(params_gpu, dict(pieces.rows(0)), bw,
                                          learn_bin_widths, bands_mod.HaloExchange(bands, 0))
        flips = int((torch.cat([banded[0], banded[1]], dim=1) != whole).sum())
        print(f"  height-sharded round trip, {tag} bin widths, {BATCH} x {HEIGHT} x {WIDTH} in 2 "
              f"bands on one card: largest pixel gap against the unsharded round trip "
              f"{gap:.3e} [{SPATIAL_GAP}]; quantised symbols differing {flips} of {whole.numel()}; "
              f"wall {1e3 * walls['sharded'][0]:.2f} ms sharded, "
              f"{1e3 * walls['unsharded'][0]:.2f} ms unsharded (median of 3) [{card}]")
        if not gap < SPATIAL_GAP or flips:
            raise AssertionError(f"height-sharded round trip, {tag}: gap {gap}, flips {flips}")

    # --- (c) data-parallel serving over a two-shard mesh.
    images = synthetic_kodak(seed=0)
    blocks = make_mesh(1, devices=[DEVICE, DEVICE])
    (params, bin_widths, map_mean, probabilities, idx_exc) = load_model(LEARNED)
    for fast_path in (None, "bf16w+"):
        tag = fast_path or "fp32"
        got = {}
        for (name, mesh) in (("mesh-less", None), ("mesh", blocks)):
            compressor = PipelinedCompressor(params, bin_widths, True, probabilities, map_mean,
                                             idx_map_exception=idx_exc, mesh=mesh,
                                             batch_size=BATCH, fast_path=fast_path,
                                             device=DEVICE)
            compressor(images[:BATCH])  # warm-up
            gk.reset_launch_counts()
            got[name] = compressor(images)
            if mesh is not None:
                record(f"pipeline over a data mesh, {tag}")
        units = 2 * (-(-images.shape[0] // BATCH))  # two data blocks a batch
        path = f"pipeline over a data mesh, {tag}"
        expect_launches(path, paths[path],
                        {"gdn_f32": 2 * units, "igdn_f32": 2 * units} if fast_path is None else
                        {"gdn_f32": 2 * units, "igdn_f32": units, "igdn_bf16": units})
        (bits, bits_mesh) = (got["mesh-less"][1], got["mesh"][1])
        level_gap = int(numpy.abs(got["mesh"][0].astype(int) - got["mesh-less"][0]).max())
        print(f"  PipelinedCompressor {tag} over (data=2, model=1): bit counts "
              f"{'identical' if numpy.array_equal(bits, bits_mesh) else 'DIFFER'} on "
              f"{images.shape[0]} images ({int(bits.sum())} bits); reconstructions within "
              f"{level_gap} level(s) of the mesh-less path [{card}]")
        if not numpy.array_equal(bits, bits_mesh):
            raise AssertionError(f"pipeline over the mesh, {tag}: bit counts differ")
    gk.reset_launch_counts()
    streamed = stream_roundtrip(params, bin_widths, images, BATCH, mesh=blocks, device=DEVICE)
    record("stream roundtrip over a data mesh")
    units = 2 * (-(-images.shape[0] // BATCH))
    expect_launches("stream roundtrip over a data mesh", paths["stream roundtrip over a data mesh"],
                    {"gdn_f32": 2 * units, "igdn_f32": 2 * units})
    plain = stream_roundtrip(params, bin_widths, images, BATCH, device=DEVICE)
    gap = float(numpy.abs(streamed - plain).max())
    print(f"  stream_roundtrip over (data=2, model=1) against mesh-less: largest pixel gap "
          f"{gap:.3e} [1e-3 of the pixel range]")
    if not gap <= 1e-3 * 255.0:
        raise AssertionError(f"stream_roundtrip over the mesh: gap {gap}")

    # --- (d) the ladder spread over seven shards of the card.
    gammas = train_ladder.GAMMAS_DEFAULT
    states = ladder.init_ladder_state(torch.Generator().manual_seed(40), gammas, device=DEVICE)
    fns = ladder.make_ladder_step_fns(gammas)
    batch = crops[:TRAIN_BATCH]
    noises = [(_uniform_noise(latent, 400 + 2 * k), _uniform_noise(latent, 401 + 2 * k))
              for k in range(len(gammas))]
    fns["train_step"](states, batch, noises)  # warm-up
    plain = fns["train_step"](states, batch, noises)
    seven = make_mesh(1, devices=[DEVICE] * len(gammas))
    gk.reset_launch_counts()
    ak.reset_launch_counts()
    sharded = fns["train_step"](ladder.shard_ladder_state(states, seven), batch, noises)
    record("ladder over seven shards")
    # Adam: one launch a shard, each a stacked ladder of one model.
    expect_adam("ladder over seven shards", {(len(states.params), 1): len(gammas)})
    # Each shard is a stacked ladder of one model: its step's six GDN sites
    # (one encode, one decode) one stacked launch each.
    expect_launches("ladder over seven shards", paths["ladder over seven shards"],
                    {"gdn_f32_stacked": 3 * len(gammas), "igdn_f32_stacked": 3 * len(gammas),
                     **backward_of({"gdn_f32_stacked": 3 * len(gammas),
                                    "igdn_f32_stacked": 3 * len(gammas)})})
    (whole, plain_host) = (distributed.fetch_replicated(sharded),
                           distributed.fetch_replicated(plain))
    (worst, outside, entries) = (0.0, 0, 0)
    for k in range(len(gammas)):
        gaps = _hold_state(f"sharded ladder, model {k}", ladder.ladder_slice_state(whole, k),
                           ladder.ladder_slice_state(plain_host, k))
        (worst, outside, entries) = (max(worst, gaps[0]), outside + gaps[1], entries + gaps[2])
    print(f"  ladder step of {len(gammas)} models over {len(gammas)} shards of the card against "
          f"the unsharded ladder step: largest weight gap {worst:.3e}, {outside} of {entries} "
          f"entries outside rtol 1e-5 / atol 1e-6 [{card}]")
    # The sharded ladder's epoch: one graph a block on its device, the
    # blocks one after the other, against the same blocks' eager loops in
    # that order (a shared generator draws block after block). One step
    # is held model by model at Adam's bound, as the sharded step above:
    # with seven models two eager steps already part by a sign flip of
    # Adam's update (7.5e-04 of a leaf's largest entry in a run).
    block_steps = {i: ladder.make_ladder_step_fns(gammas[i:i + 1])["train_step"]
                   for i in range(len(gammas))}

    def eager_blocks(shards, data, rows, noise):
        return shards.map_blocks(lambda i, block: epoch_over_rows(
            block_steps[i], block, data, rows, noise if isinstance(noise, torch.Generator)
            else [batch_noise[i:i + 1] for batch_noise in noise]))

    epoch_crops = torch.from_numpy(synthetic_luminance_stack(
        GRAPHED_STEPS * TRAIN_BATCH, TRAIN_CROP, TRAIN_CROP, seed=31)).cuda()
    hold_graphed_epoch(f"the ladder over {len(gammas)} shards", fns,
                       ladder.shard_ladder_state(states, seven), epoch_crops, lambda i: [
                           (_uniform_noise(latent, 500 + 20 * i + 2 * k),
                            _uniform_noise(latent, 501 + 20 * i + 2 * k))
                           for k in range(len(gammas))], draws_equal,
                       eager_epoch=eager_blocks, view=distributed.fetch_replicated,
                       one_step=lambda got, expected: [_hold_state(
                           f"sharded graphed step, model {k}", ladder.ladder_slice_state(got, k),
                           ladder.ladder_slice_state(expected, k))
                           for k in range(len(gammas))] and "Adam's bound, model by model")

    # --- (e) the scaling report and the dry run.
    gk.reset_launch_counts()
    (_, printed) = _run_printing(benchmark.main, [
        "scaling", "--height", str(HEIGHT), "--width", str(WIDTH), "--per_device_batch",
        str(BATCH), "--device", DEVICE])
    report = json.loads(printed.strip().splitlines()[-1])
    if set(report["mpix_per_s"]) != {str(n) for n in range(1, torch.cuda.device_count() + 1)
                                     if n & (n - 1) == 0} or report["efficiency"]["1"] != 1.0:
        raise AssertionError(f"scaling report {report}")
    print(f"  cli/benchmark scaling on {torch.cuda.device_count()} card(s): "
          f"{report['mpix_per_s']['1']:.1f} Mpix/s on one (not a scaling figure) [{card}]")
    summary = dryrun.dryrun_multichip(2, device=DEVICE)
    rows_seen.update(gk.LAUNCH_ROWS)  # the report's and the dry run's row counts
    print(f"  dryrun_multichip(2) on a two-shard mesh of one card: passed; 256 x 384 height-"
          f"sharded against unsharded {summary['spatial_gap']:.3e} [{SPATIAL_GAP}]")
    return (paths, rows_seen)


def _svhn_state_gaps(got, expected):
    """``(largest weight gap, weight entries outside 1e-6 + 1e-5 |w|,
    entries)`` between two SVHN states' parameters (card against CPU)."""
    (worst, outside, entries) = (0.0, 0, 0)
    for (name, value) in expected.params.items():
        gap = (got.params[name].cpu() - value).abs()
        worst = max(worst, float(gap.max()))
        outside += int((gap > 1e-6 + 1e-5 * value.abs()).sum())
        entries += gap.numel()
    return (worst, outside, entries)


def phase_svhn(card, draws_equal):
    """The SVHN side at full width on the card: the dense EAE's two
    phases and the VAE's step held against the port's CPU run from one
    state and one noise, the overfit harness, ``cli/train_svhn`` then
    ``cli/reconstruct_svhn``, the entropy study, and ``cli/train_vae``,
    each step the replays of a captured graph (one capture a path); then
    the graphed dense alternation, dense pre-fit, VAE step and entropy
    fit against their eager loops (:func:`hold_graphed_epoch`), and the
    study graphed against eager. Its matmuls are ``torch.matmul`` in true
    fp32; no GDN kernel runs."""
    from autoencoder_based_image_compression_tpu_torch.cli import (
        compare_entropy_approximations,
        overfit_svhn,
        reconstruct_svhn,
        train_svhn,
        train_vae,
    )
    from autoencoder_based_image_compression_tpu_torch.data.svhn import (
        compute_preprocessing_stats,
        preprocess_svhn,
        synthetic_svhn,
    )
    from autoencoder_based_image_compression_tpu_torch.models import dense_eae, vae
    from autoencoder_based_image_compression_tpu_torch.ops import density as dens
    from autoencoder_based_image_compression_tpu_torch.ops.kernels import gdn_kernel as gk
    from autoencoder_based_image_compression_tpu_torch.train import checkpoint, epoch_graph
    from autoencoder_based_image_compression_tpu_torch.train.state import state_to
    from autoencoder_based_image_compression_tpu_torch.utils.naming import experiment_suffix

    def with_captures(run):
        """``(run(), the captures it made)``."""
        before = len(epoch_graph.CAPTURES)
        result = run()
        return (result, epoch_graph.CAPTURES[before:])

    digits_uint8 = synthetic_svhn(SVHN_DIGITS, seed=0)
    (mean, std) = compute_preprocessing_stats(digits_uint8)
    digits = torch.from_numpy(preprocess_svhn(digits_uint8, mean, std))
    (batch_cpu, batch) = (digits[:SVHN_BATCH], digits[:SVHN_BATCH].to(DEVICE))
    gk.reset_launch_counts()

    # --- (1) one alternation, card against CPU, from one state and one eps.
    fns = dense_eae.make_dense_step_fns(SVHN_GAMMA, True)
    state_cpu = dense_eae.init_dense_eae_state(torch.Generator().manual_seed(0), device="cpu")
    noise = torch.Generator().manual_seed(1)
    latent = (SVHN_BATCH, state_cpu.params["we_latent"].shape[1])
    for i in range(2):  # two alternations on the CPU: momentum and density not at rest
        eps = dense_eae.uniform_eps(noise, latent, "cpu")
        rows = digits[(i + 1) * SVHN_BATCH:(i + 2) * SVHN_BATCH]
        state_cpu = fns["training_eae_bw"](fns["training_fct"](state_cpu, rows, eps), rows, eps)
    state = state_to(state_cpu, DEVICE)
    eps = dense_eae.uniform_eps(noise, latent, "cpu")
    expected = fns["training_eae_bw"](fns["training_fct"](state_cpu, batch_cpu, eps),
                                      batch_cpu, eps)
    got = fns["training_eae_bw"](fns["training_fct"](state, batch, eps.to(DEVICE)), batch,
                                 eps.to(DEVICE))
    (worst, outside, entries) = _svhn_state_gaps(got, expected)
    density = float((got.density.parameters.cpu() - expected.density.parameters).abs().max())
    bw = abs(float(got.bin_width) - float(expected.bin_width))
    with torch.no_grad():
        pieces = [torch.floor(dense_eae.PPI * (dense_eae.encoder(s.params, b)[1].cpu()
                                               + float(s.bin_width) * eps))
                  for (s, b) in ((state, batch), (state_cpu, batch_cpu))]
    flips = int((pieces[0] != pieces[1]).sum())
    print(f"  dense EAE, one training_fct + training_eae_bw at {SVHN_BATCH} x 3072-300-200 from "
          f"one state and one eps, card against CPU: largest weight gap {worst:.3e} ({outside} "
          f"of {entries} entries outside 1e-6 + 1e-5 |w|), density table {density:.3e}, bin "
          f"width {bw:.3e}; {flips} of {pieces[0].numel()} density samples in another linear "
          "piece")
    if outside or bw > 1e-6 or density > 1e-4 * (1 + flips):
        raise AssertionError(f"dense EAE step on the card: weights {worst} ({outside} outside), "
                             f"density {density}, bin width {bw}")
    eps_card = eps.to(DEVICE)

    def alternation():
        return fns["training_eae_bw"](fns["training_fct"](state, batch, eps_card), batch,
                                      eps_card)

    alternation_ms = _median_ms(alternation, 1, 9)
    alternation_trace = traced_device_ms(alternation, 10, top=4)

    # --- (2) the overfit harness: 10 digits, 20 pre-fits, 200 alternations,
    # one replay of its captured alternation an epoch.
    ((objectives, _), made) = with_captures(lambda: _run_printing(overfit_svhn.main, [
        "--nb_examples", "10", "--nb_epochs", "200", "--learn_bin_width", "--device", DEVICE]))
    print(f"  overfit_svhn (10 digits, 20 pre-fits, 200 alternations): objective "
          + " -> ".join(f"{o:.4f}" for o in objectives) + f"; {len(made)} captures (pre-fit, "
          "alternation)")
    if not objectives[-1] < objectives[0]:
        raise AssertionError(f"overfit harness: the objective did not fall {objectives}")
    if len(made) != 2:
        raise AssertionError(f"overfit harness: {len(made)} captures, expected 2")

    with tempfile.TemporaryDirectory() as root:
        # --- (3) cli/train_svhn, then cli/reconstruct_svhn on its checkpoint.
        t0 = time.perf_counter()
        ((trained, _), made) = with_captures(lambda: _run_printing(train_svhn.main, [
            "1.0", str(SVHN_GAMMA), "--learn_bin_width", "--synthetic", "--nb_epochs_training",
            str(SVHN_EPOCHS), "--results_root", root, "--device", DEVICE]))
        train_s = time.perf_counter() - t0
        if len(made) != 2:
            raise AssertionError(f"train_svhn: {len(made)} captures, expected 2 (pre-fit, "
                                 "alternation)")
        exp_dir = os.path.join(root, experiment_suffix(1.0, SVHN_GAMMA, True))
        template = dense_eae.init_dense_eae_state(torch.Generator().manual_seed(5),
                                                  device=DEVICE)
        loaded = checkpoint.load_checkpoint(os.path.join(exp_dir, "model"), template)
        with numpy.load(os.path.join(exp_dir, "model.npz")) as data:
            saved = {key: data[key] for key in data.files}
        (back, kept) = (checkpoint.dense_state_to_jax(loaded),
                        checkpoint.dense_state_to_jax(trained))
        if not (set(back) == set(saved) == set(kept) and all(
                numpy.array_equal(back[k], saved[k]) and numpy.array_equal(kept[k], saved[k])
                for k in saved)):
            raise AssertionError("the train_svhn checkpoint did not load back equal")
        if int(loaded.step) != SVHN_EPOCHS * (SVHN_DIGITS // SVHN_BATCH):
            raise AssertionError(f"train_svhn: step {int(loaded.step)}")
        ((rates, psnrs), _) = _run_printing(reconstruct_svhn.main, [
            "1.0", str(SVHN_GAMMA), "--learn_bin_width", "--results_root", root, "--device",
            DEVICE])
        print(f"  cli/train_svhn, {SVHN_EPOCHS} epochs of {SVHN_DIGITS // SVHN_BATCH} batches on "
              f"the card, graphed (one capture for the pre-fit, one for the {SVHN_EPOCHS} "
              f"epochs): {train_s:.2f} s; checkpoint loads back equal to the trained state "
              f"(step {int(loaded.step)}); cli/reconstruct_svhn: rate falls from {rates[0]:.4f} "
              f"to {rates[-1]:.4f} bpp over the multipliers")
        if not (numpy.all(numpy.diff(rates) <= 1e-12) and numpy.all(numpy.isfinite(psnrs))):
            raise AssertionError(f"reconstruct_svhn: rates {rates}, PSNRs {psnrs}")

        # --- (5) the VAE: one step card against CPU, then cli/train_vae.
        step = vae.make_vae_step_fn(1.0)
        vae_cpu = vae.init_vae_state(torch.Generator().manual_seed(6), device="cpu")
        vae_cpu = step(vae_cpu, digits[SVHN_BATCH:2 * SVHN_BATCH],
                       torch.Generator().manual_seed(7))
        vae_card = state_to(vae_cpu, DEVICE)
        epsilon = torch.randn((SVHN_BATCH, 25), generator=torch.Generator().manual_seed(8))
        (worst_vae, outside_vae, entries_vae) = _svhn_state_gaps(
            step(vae_card, batch, epsilon.to(DEVICE)), step(vae_cpu, batch_cpu, epsilon))
        epsilon_card = epsilon.to(DEVICE)
        vae_ms = _median_ms(lambda: step(vae_card, batch, epsilon_card), 1, 9)
        vae_trace = traced_device_ms(lambda: step(vae_card, batch, epsilon_card), 10, top=4)
        print(f"  VAE, one step at {SVHN_BATCH} x 3072-300-25 from one state and one draw, card "
              f"against CPU: largest weight gap {worst_vae:.3e} ({outside_vae} of {entries_vae} "
              "entries outside 1e-6 + 1e-5 |w|)")
        if outside_vae:
            raise AssertionError(f"VAE step on the card: {outside_vae} weights outside")
        vae_root = os.path.join(root, "vae")
        common = ["--results_root", vae_root, "--device", DEVICE, "--path_to_training_data",
                  os.path.join(root, "missing.npy")]
        ((losses, _), made) = with_captures(lambda: _run_printing(
            train_vae.main, ["train", "--nb_epochs_training", str(SVHN_EPOCHS)] + common))
        saved_vae = checkpoint.load_checkpoint(os.path.join(vae_root, "model"), vae.init_vae_state(
            torch.Generator().manual_seed(5), device=DEVICE))
        (rec, _) = _run_printing(train_vae.main, ["reconstruct"] + common)
        (samples, _) = _run_printing(train_vae.main, ["generate"] + common)
        print(f"  cli/train_vae train ({SVHN_EPOCHS} epochs, graphed, {len(made)} capture): "
              "-VLB " + " -> ".join(f"{v:.2f}" for v in losses)
              + f"; the checkpoint loads back at step {int(saved_vae.step)}; reconstruct "
              f"{rec.shape} {rec.dtype}, generate {samples.shape} {samples.dtype} from it")
        if not (losses[-1] < losses[0] and rec.shape == (8, 3072) and samples.shape == (16, 3072)
                and len(made) == 1
                and int(saved_vae.step) == SVHN_EPOCHS * (SVHN_DIGITS // SVHN_BATCH)):
            raise AssertionError(f"train_vae: -VLB {losses}, {rec.shape}, {samples.shape}, "
                                 f"{len(made)} captures, step {int(saved_vae.step)}")

    # --- (4) the entropy study: card against CPU, then the default size.
    tables = {}
    for device in (DEVICE, "cpu"):
        captured = io.StringIO()
        with contextlib.redirect_stdout(captured):
            tables[device] = compare_entropy_approximations.main(
                ["--nb_samples", str(ENTROPY_SAMPLES), "--device", device])
    gap = max(abs(a - b) for key in tables["cpu"]
              for (a, b) in zip(tables[DEVICE][key], tables["cpu"][key]))
    print(f"  compare_entropy_approximations at {ENTROPY_SAMPLES} samples, card against CPU: "
          f"largest gap {gap:.3e} bits [{ENTROPY_GAP_BITS}]")
    if not gap <= ENTROPY_GAP_BITS:
        raise AssertionError(f"entropy study on the card: {gap} bits from the CPU")
    # At the default size: graphed (one capture for the 8 fits), then with
    # each fit's steps as the eager loop on the card.
    study_s = {}
    for form in ("graphed", "eager"):
        def eager_fit(step):
            return lambda *args: epoch_graph.epoch_over_rows(step, *args)

        with (mock.patch.object(compare_entropy_approximations, "epoch_fn", eager_fit)
              if form == "eager" else contextlib.nullcontext()):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            (_, made) = with_captures(lambda: _run_printing(compare_entropy_approximations.main,
                                                       ["--device", DEVICE]))
            study_s[form] = time.perf_counter() - t0
        if len(made) != (form == "graphed"):
            raise AssertionError(f"entropy study, {form}: {len(made)} captures")
    print(f"  compare_entropy_approximations at the default 200,000 samples on the card (8 fits "
          f"of 400 SGD steps): {study_s['graphed']:.2f} s graphed (one capture) against "
          f"{study_s['eager']:.2f} s eager")

    # --- (6) times.
    print(f"  SVHN alternation (training_fct + training_eae_bw, batch {SVHN_BATCH}): "
          f"{alternation_ms:.3f} ms (CUDA events, median of 9) = "
          f"{SVHN_REFERENCE_BATCHES * alternation_ms / 1e3:.3f} s for one reference epoch of "
          f"{SVHN_REFERENCE_BATCHES} batches; VAE step {vae_ms:.3f} ms [{card}]")
    for (label, wall_ms, (kernel_ms, top)) in (("SVHN alternation", alternation_ms,
                                                alternation_trace),
                                               ("VAE step", vae_ms, vae_trace)):
        if kernel_ms is None:
            print(f"  {label}: the profiler's trace holds no device time (not measured)")
            continue
        print(f"  {label}: {kernel_ms:.3f} ms of kernels a call in a profiler trace of 10, "
              f"device busy {100 * kernel_ms / wall_ms:.1f} % of the {wall_ms:.3f} ms; top: "
              + "; ".join(f"{name} {ms:.3f} ms x{n:g}" for (name, ms, n) in top))
    launched = {name: n for (name, n) in gk.LAUNCHES.items() if n}
    print(f"  GDN kernel launches on the SVHN side: {launched or 'none'} (dense models only)")
    if launched:
        raise AssertionError(f"the SVHN side launched GDN kernels: {launched}")

    # --- (7) each graphed step against its eager loop at full width, by
    # the rule of the training phases (each hold counts a replay's GDN
    # launches, none).
    dataset = digits.to(DEVICE)
    shuffle = numpy.random.default_rng(31)
    order = numpy.concatenate([shuffle.permutation(SVHN_DIGITS) for _ in range(2)])
    train_rows = order[:GRAPHED_STEPS * SVHN_BATCH].reshape(GRAPHED_STEPS, SVHN_BATCH)
    fit_rows = epoch_graph.rows_in_order(SVHN_DIGITS // SVHN_BATCH, SVHN_BATCH).repeat(2, 1)
    graphed = {"SVHN alternation": hold_graphed_epoch(
        "SVHN alternation", fns, state, dataset, lambda i: _uniform_noise(latent, 500 + i),
        draws_equal, rows=train_rows)}
    graphed["SVHN pre-fit"] = hold_graphed_epoch(
        "SVHN pre-fit", fns, state, dataset, lambda i: _uniform_noise(latent, 600 + i),
        draws_equal, name="fit", rows=fit_rows[:GRAPHED_STEPS])
    graphed["VAE step"] = hold_graphed_epoch(
        "VAE step", {"train_step": step, "train_epoch": vae.make_vae_epoch_fn(1.0)}, vae_card,
        dataset, lambda i: torch.randn((SVHN_BATCH, 25), device=DEVICE,
                                       generator=torch.Generator(DEVICE).manual_seed(700 + i)),
        draws_equal, rows=train_rows)
    rng = numpy.random.default_rng(32)
    samples = (rng.normal(0.0, 2.0, 200000) + rng.uniform(-0.5, 0.5, 200000)).astype(
        numpy.float32)
    samples = torch.from_numpy(samples).to(DEVICE)[None, :]
    (ppi, max_itvs) = (compare_entropy_approximations.PPI, compare_entropy_approximations.MAX_ITVS)
    table = dens.expand_table(dens.init_density_table(1, ppi, max_itvs, device=DEVICE),
                              samples.abs().max() + 0.5, ppi, max_itvs)
    fit_step = compare_entropy_approximations._fit_step
    graphed["entropy fit"] = hold_graphed_epoch(
        "entropy study's fit, 200,000 samples", {"training_fct": fit_step,
                                                 "fit_epoch": epoch_graph.epoch_fn(fit_step)},
        table, samples, None, draws_equal, name="fit",
        rows=torch.zeros((GRAPHED_STEPS, 1), dtype=torch.int64))
    for (label, (graphed_ms, eager_ms)) in graphed.items():
        print(f"  {label}: {graphed_ms:.3f} ms a step graphed, {eager_ms:.3f} ms eager [{card}]")
    reference_s = SVHN_REFERENCE_BATCHES * graphed["SVHN alternation"][0] / 1e3
    print(f"  SVHN alternation graphed: {reference_s:.3f} s for one reference epoch of "
          f"{SVHN_REFERENCE_BATCHES} batches")
    return {"svhn alternation ms": alternation_ms, "vae step ms": vae_ms}


def _reference_variables(exp_dir, state):
    """A reference-named variable dict (the TF checkpoint's names and
    layouts) of a committed params artifact and the state's live density."""
    from autoencoder_based_image_compression_tpu_torch import constants as csts
    from autoencoder_based_image_compression_tpu_torch.train.checkpoint import (
        load_params_artifact,
    )

    (params_np, bin_widths) = load_params_artifact(os.path.join(exp_dir, "params_trained.npz"))
    variables = {f"{'encoder' if int(name[-1]) <= 3 else 'decoder'}/{name}": value
                 for (name, value) in params_np.items()}
    (ppi, nb_itvs) = (csts.NB_POINTS_PER_INTERVAL, int(state.density.nb_itvs_per_side))
    center = ppi * csts.MAX_ITVS_PER_SIDE
    live = state.density.parameters.cpu().numpy()[:, center - ppi * nb_itvs:
                                                  center + ppi * nb_itvs + 1]
    variables.update({"piecewise_linear_function/bin_widths": bin_widths,
                      "piecewise_linear_function/parameters": live,
                      "piecewise_linear_function/nb_intervals_per_side": numpy.asarray(nb_itvs),
                      "decaying_lr/global_step": numpy.asarray(int(state.step))})
    return variables


def phase_tooling(card):
    """The latent-analysis tooling on both trained architectures, from
    full checkpoints written into a temporary results root. Returns each
    path's launch counts and the (variant, rows) counts its kernels were
    launched at."""
    from autoencoder_based_image_compression_tpu_torch.cli import latent_analysis, visualize_model
    from autoencoder_based_image_compression_tpu_torch.data.synthetic import synthetic_kodak
    from autoencoder_based_image_compression_tpu_torch.eval import analysis
    from autoencoder_based_image_compression_tpu_torch.models import conv_eae
    from autoencoder_based_image_compression_tpu_torch.ops.kernels import gdn_kernel as gk
    from autoencoder_based_image_compression_tpu_torch.train import checkpoint
    from autoencoder_based_image_compression_tpu_torch.train.loop import encode_mini_batches
    from autoencoder_based_image_compression_tpu_torch.utils.device import deterministic_cudnn
    from autoencoder_based_image_compression_tpu_torch.utils.import_reference import (
        import_reference_variables,
    )
    from autoencoder_based_image_compression_tpu_torch.utils.naming import experiment_suffix

    paths = {}
    rows_seen = collections.Counter()
    found = {name: importlib.util.find_spec(name) is not None for name in ("PIL", "matplotlib")}

    def record(path, expected):
        paths[path] = {name: n for (name, n) in gk.LAUNCHES.items() if n}
        rows_seen.update(gk.LAUNCH_ROWS)
        expect_launches(path, paths[path], expected)

    images = synthetic_kodak(seed=14)[:TOOL_IMAGES]
    with tempfile.TemporaryDirectory() as root:
        path_images = os.path.join(root, "kodak.npy")
        numpy.save(path_images, images[:, :, :, 0])
        for (exp_dir, learned, bin_width_init) in ((LEARNED, True, 0.5), (FIXED, False, 1.0)):
            tag = "learned" if learned else "fixed"
            sites = 2 if learned else 3  # GDN (or IGDN) sites of one encode (or decode)
            state = _trained_state(exp_dir, learned)
            checkpoint.save_checkpoint(os.path.join(
                root, experiment_suffix(bin_width_init, TRAIN_GAMMA, learned), "model_0"), state)
            args = ["0", "--results_root", root, "--device", DEVICE] + (
                ["--learn_bin_widths"] if learned else [])
            head = [str(bin_width_init), str(TRAIN_GAMMA)]
            out_dir = os.path.join(root, f"analysis_{tag}")

            # (1) latent_analysis fit, end to end; its latents against the CPU's.
            gk.reset_launch_counts()
            _run_printing(latent_analysis.main, ["fit"] + head + args + [
                "--path_to_kodak", path_images, "--out_dir", out_dir])
            record(f"latent_analysis fit, {tag}", {"gdn_f32": sites})
            scales = numpy.load(os.path.join(out_dir, "laplace_scales.npy"))
            if not (numpy.all(numpy.isfinite(scales)) and numpy.all(scales > 0)):
                raise AssertionError(f"latent_analysis fit, {tag}: scales {scales}")
            y = encode_mini_batches(images, state.params, learned, TOOL_IMAGES)
            y_cpu = encode_mini_batches(images, {k: v.cpu() for (k, v) in state.params.items()},
                                        learned, TOOL_IMAGES)
            torch.testing.assert_close(y, y_cpu, rtol=1e-5, atol=1e-4)
            print(f"  latent_analysis fit, {tag} bin widths, {TOOL_IMAGES} images of {HEIGHT} x "
                  f"{WIDTH}: Laplace scales in [{scales.min():.4f}, {scales.max():.4f}]; "
                  f"latents within {float(numpy.abs(y - y_cpu).max()):.3e} of the CPU encode "
                  "[rtol 1e-5, atol 1e-4]")

            # (2) the activation probe at (2, 2) and (8, 8).
            gk.reset_launch_counts()
            probes = latent_analysis.activation_probes(state.params, learned, 0, 8.0)
            record(f"activation probe, {tag}", {"igdn_f32": 2 * sites})
            (first, second) = (probes["pos0"].astype(int), probes["pos1"].astype(int))
            size = PROBE_PIXELS ** 0.5
            interior = slice(16, int(size) - PROBE_SHIFT)
            shifted = slice(16 + PROBE_SHIFT, int(size))
            gap = numpy.abs(second[shifted, shifted] - first[interior, interior])
            print(f"  activation probe, {tag}: {first.shape} uint8; the (8, 8) response equals "
                  f"the (2, 2) one shifted by {PROBE_SHIFT} pixels in all but "
                  f"{int((gap > 0).sum())} of {gap.size} interior pixels, largest gap "
                  f"{int(gap.max())} level [1 level, 1e-3 of the pixels]")
            if gap.max() > 1 or numpy.mean(gap > 0) > 1e-3:
                raise AssertionError(f"activation probe, {tag}: not translation covariant")

            # (3) mask_maps on the images' latents, against the CPU's decode.
            map_mean = numpy.mean(y, axis=(0, 1, 2))
            gk.reset_launch_counts()
            masked = analysis.mask_maps(y, state.params, learned, 0, map_mean)
            record(f"mask_maps, {tag}", {"igdn_f32": sites})
            # The CPU decodes the first image only (a full-width decode on the host is slow).
            masked_cpu = analysis.mask_maps(y[:1], {k: v.cpu() for (k, v) in
                                                    state.params.items()}, learned, 0, map_mean)
            gap = numpy.abs(masked[:1].astype(int) - masked_cpu)
            print(f"  mask_maps, {tag}: {masked.shape} uint8; first image: {int((gap > 0).sum())} "
                  f"of {gap.size} pixels off the CPU's decode, largest gap {int(gap.max())} "
                  "level [1 level, 1e-3 of the pixels]")
            if masked.shape != images.shape[:3] or gap.max() > 1 or numpy.mean(gap > 0) > 1e-3:
                raise AssertionError(f"mask_maps, {tag}: {masked.shape}, gap {gap.max()}")

            # (4) visualize_model's compute.
            gk.reset_launch_counts()
            arrays = visualize_model.model_arrays(state, images[:VIEW_IMAGES], learned, 4,
                                                  torch.Generator(DEVICE).manual_seed(1))
            record(f"visualize_model, {tag}", {"gdn_f32": sites})
            if not (arrays["y"].shape == (VIEW_IMAGES, HEIGHT // 16, WIDTH // 16, 128)
                    and numpy.all(numpy.isfinite(arrays["y_tilde"]))
                    and numpy.all(numpy.isfinite(arrays["areas"]))):
                raise AssertionError(f"visualize_model, {tag}: arrays not as expected")
            print(f"  visualize_model's arrays, {tag}: y {arrays['y'].shape}, areas under the "
                  f"live pdfs in [{arrays['areas'].min():.4f}, {arrays['areas'].max():.4f}] (the "
                  "params artifact holds no density: a fresh table)")

            # (5) the importer on a reference-named dict of the same model.
            imported = import_reference_variables(_reference_variables(exp_dir, state))
            latents = torch.from_numpy(numpy.random.default_rng(15).normal(
                0, 2, size=(1, 16, 16, 128)).astype(numpy.float32)).to(DEVICE)
            params = {k: v.to(DEVICE) for (k, v) in imported["params"].items()}
            same = set(params) == set(state.params) and all(
                torch.equal(params[k], state.params[k]) for k in params)
            # cuDNN's default transposed conv sums with atomics: compare two
            # decodes under its deterministic algorithms.
            with torch.no_grad(), deterministic_cudnn():
                direct = conv_eae.decode(state.params, latents, learned)
                gk.reset_launch_counts()
                decoded = conv_eae.decode(params, latents, learned)
                record(f"import_reference decode, {tag}", {"igdn_f32": sites})
            if imported["learn_bin_widths"] != learned or not same or not torch.equal(decoded,
                                                                                      direct):
                raise AssertionError(f"import_reference, {tag}: another model than the loaded one")
            print(f"  import_reference_variables, {tag}: the imported parameters equal the "
                  "loaded ones, and decode a 16 x 16 latent equal to them")

            # (6) the image-writing command lines, where their imports are.
            if found["PIL"]:
                for command in ("activate", "mask"):
                    _run_printing(latent_analysis.main, [command] + head + args + [
                        "--path_to_kodak", path_images, "--out_dir", out_dir])
                if found["matplotlib"]:
                    _run_printing(visualize_model.main, head + args + [
                        "--path_to_images", path_images, "--out_dir", out_dir])
            written = sorted(name for name in os.listdir(out_dir) if name.endswith(".png"))
            print(f"  image-writing command lines, {tag}: latent_analysis activate / mask "
                  + ("driven" if found["PIL"] else "not driven (no PIL)")
                  + ", visualize_model " + ("driven" if all(found.values()) else
                                            "not driven (no PIL or matplotlib)")
                  + f"; {len(written)} PNG files written [{card}]")
    return (paths, rows_seen)


def phase_campaign(card):
    """The campaign scripts at full width: (a) ``rd_campaign`` in a
    temporary root, called three times; (b) ``stability_study``'s average
    on (a)'s parts and its evaluation on the committed averaged models;
    (c) one more part through ``resilient_campaign``, in fresh processes;
    (d) the port's side of ``reference_parity``. Returns each in-process
    path's launch counts, the ``(variant, shape, path)`` entries of the
    kernels line, and the (variant, rows) counts the kernels were
    launched at."""
    from autoencoder_based_image_compression_tpu_torch.cli import reconstruct_kodak
    from autoencoder_based_image_compression_tpu_torch.codecs import jpeg2000
    from autoencoder_based_image_compression_tpu_torch.data.synthetic import (
        synthetic_kodak,
        synthetic_luminance_stack,
    )
    from autoencoder_based_image_compression_tpu_torch.eval import reference_parity
    from autoencoder_based_image_compression_tpu_torch.models import conv_eae
    from autoencoder_based_image_compression_tpu_torch.ops.kernels import adam_kernel as ak
    from autoencoder_based_image_compression_tpu_torch.ops.kernels import gdn_kernel as gk
    from autoencoder_based_image_compression_tpu_torch.ops.quantization import quantize_per_map
    from autoencoder_based_image_compression_tpu_torch.scripts import (
        rd_campaign,
        resilient_campaign,
        stability_study,
    )
    from autoencoder_based_image_compression_tpu_torch.train import checkpoint, epoch_graph
    from autoencoder_based_image_compression_tpu_torch.train.state import init_train_state
    from autoencoder_based_image_compression_tpu_torch.utils.naming import experiment_suffix

    paths = {}
    rows_seen = collections.Counter()
    on_path = []
    found = {name: importlib.util.find_spec(name) is not None for name in ("PIL", "matplotlib")}
    keep = ("[campaign]", "[resilient]", "Bjontegaard", "gamma ", "stability comparison",
            "Epoch wall-clock", "JPEG2000 anchor")

    def record(path, expected, shapes):
        """Reads the path's launches and holds them to ``expected``; the
        kernels line gets each launched variant at its ``shapes[variant]``."""
        expected = {name: n for (name, n) in expected.items() if n}
        paths[path] = {name: n for (name, n) in gk.LAUNCHES.items() if n}
        rows_seen.update(gk.LAUNCH_ROWS)
        expect_launches(path, paths[path], expected)
        on_path.extend((name, path, shape) for name in expected if name != REDUCE
                       for shape in shapes[name])

    def quiet(fn, *args):
        """``fn(*args)``, printing only the lines a reader of this run needs."""
        return _run_printing(lambda _: fn(*args), None, keep)[0]

    with tempfile.TemporaryDirectory() as root:
        results_root = os.path.join(root, "results")
        argv = ["--data_root", os.path.join(root, "data"), "--results_root", results_root,
                "--out", os.path.join(root, "rd"), "--nb_training", str(CAMPAIGN_COUNTS[0]),
                "--nb_validation", str(CAMPAIGN_COUNTS[1]), "--nb_extra",
                str(CAMPAIGN_COUNTS[2]), "--nb_epochs", "1", "--nb_parts",
                str(CAMPAIGN_PARTS), "--ladder_vmap", "--jpeg2000_backend", "pillow",
                "--device", DEVICE] + CAMPAIGN_EXTRA_ARGS
        args = rd_campaign.parse_args(argv)
        experiments = [rd_campaign.LEARNED] + [(1.0, g, False) for g in args.gammas_trained]
        nb_kodak = args.kodak_shape[0]
        # The JPEG2000 anchor of these images is committed (phase 7's): the
        # study reads it from its cache instead of coding 24 images on the host.
        os.makedirs(args.out)
        stem = ("jpeg2000_pillow_600-400-300-220-160-120-80-64-48-32-24-16-12-8_"
                + RD_IMAGES_TAG)
        for kind in ("rates", "psnrs"):
            shutil.copy(os.path.join(COMMITTED_RD, f"{kind}_{stem}.npy"), args.out)
        route = "main" if all(found.values()) else "stages"
        print(f"  (a) rd_campaign, {len(experiments)} models at 128 maps, "
              f"{args.nb_training} crops of {args.crop} x {args.crop} at batch "
              f"{args.batch_size}, {args.nb_parts} parts of {args.nb_epochs} epoch, "
              f"{nb_kodak} images of {args.kodak_shape[1]} x {args.kodak_shape[2]}; route: "
              + ("main(), as a user calls it" if route == "main" else
                 "the stages in main()'s order (no matplotlib to draw the figures)"))

        def campaign(label, training_expected, statistics_expected, evaluation_expected,
                     adam_expected):
            """One call of the campaign, its training's Adam launches held
            to ``adam_expected``; returns ``(part seconds, study)``."""
            stage_s = {}
            captured = len(epoch_graph.CAPTURES)
            ak.reset_launch_counts()
            if route == "main":
                gk.reset_launch_counts()
                t0 = time.perf_counter()
                (_, printed) = _run_printing(rd_campaign.main, argv, keep)
                stage_s["main"] = time.perf_counter() - t0
                expect_adam(label, adam_expected)
                expected = collections.Counter(training_expected)
                expected.update(statistics_expected)
                expected.update(evaluation_expected)
                record(label, expected, {"gdn_f32": TRAIN_SHAPES + STATS_SHAPES + SERVE_SHAPES,
                                         "igdn_f32": TRAIN_SHAPES + SERVE_SHAPES,
                                         **STACKED_ENTRIES,
                                         **{name: TRAIN_SHAPES for name in BACKWARD_VARIANTS}})
                # The parts' seconds as the campaign printed them (a ladder
                # model trained alone counts as its ladder part).
                part_s = {f"{'learned-bw' if name.startswith('learning') else 'ladder'} part "
                          f"{idx}": float(s) for (name, idx, s) in re.findall(
                              r"\[campaign\] (\S+): part (\d+)[^\n]* trained in ([0-9.]+) s",
                              printed)}
                gk.reset_launch_counts()
                study = quiet(rd_campaign.evaluate, args, rd_campaign.build_data(
                    args.data_root, args.nb_training, args.nb_validation, args.nb_extra,
                    args.crop, args.kodak_shape), False)
                if any(gk.LAUNCHES.values()):
                    raise AssertionError(f"{label}: the study was not read from the cache")
            else:
                t0 = time.perf_counter()
                data = rd_campaign.build_data(args.data_root, args.nb_training,
                                              args.nb_validation, args.nb_extra, args.crop,
                                              args.kodak_shape)
                stage_s["data"] = time.perf_counter() - t0
                gk.reset_launch_counts()
                t0 = time.perf_counter()
                part_s = quiet(rd_campaign.train_parts, args, data)
                stage_s["training"] = time.perf_counter() - t0
                record(f"{label}: training", training_expected, TRAINING_ENTRIES)
                expect_adam(label, adam_expected)
                gk.reset_launch_counts()
                t0 = time.perf_counter()
                for experiment in (rd_campaign.LEARNED, (1.0, 10000.0, False)):
                    quiet(rd_campaign.collect_stats, args.results_root, data, *experiment,
                          args.nb_parts, args.device)
                stage_s["statistics"] = time.perf_counter() - t0
                record(f"{label}: statistics", statistics_expected, {"gdn_f32": STATS_SHAPES})
                gk.reset_launch_counts()
                t0 = time.perf_counter()
                rd_campaign.export_params(args.results_root, args.gammas_trained,
                                          args.nb_parts, args.device)
                stage_s["exports"] = time.perf_counter() - t0
                record(f"{label}: exports", {}, {})
                gk.reset_launch_counts()
                t0 = time.perf_counter()
                study = quiet(rd_campaign.evaluate, args, data, False)
                stage_s["evaluation"] = time.perf_counter() - t0
                record(f"{label}: rd evaluation", evaluation_expected, STUDY_ENTRIES)
            made = epoch_graph.CAPTURES[captured:]
            print(f"  {label}: seconds per stage "
                  + ", ".join(f"{stage} {s:.2f}" for (stage, s) in stage_s.items())
                  + "; parts trained: " + (", ".join(f"{part} {s:.2f} s" for (part, s)
                                                      in part_s.items()) or "none")
                  + f"; their epochs graphed, {len(made)} captures, warm-up and capture "
                  f"{sum(c['warmup_s'] + c['capture_s'] for c in made):.2f} s in all")
            # One capture for a part's epochs, one more for part 0's pre-fit.
            expected_captures = len(part_s) + sum(key.endswith(" part 0") for key in part_s)
            if DEVICE == "cuda" and len(made) != expected_captures:
                raise AssertionError(f"{label}: {len(made)} captures for {len(part_s)} parts, "
                                     f"expected {expected_captures}")
            return (part_s, study)

        # First call: everything is trained, collected, exported and evaluated.
        full = _study_launches(nb_kodak, [(3, len(args.gammas_trained)),
                                          (3, len(reconstruct_kodak.MULTIPLIERS)),
                                          (2, len(reconstruct_kodak.MULTIPLIERS))])
        extra_batches = args.nb_extra // 20  # collect_stats' batch
        (part_s, study) = campaign("campaign", _campaign_launches(args),
                                   {"gdn_f32": 5 * extra_batches}, full,
                                   _campaign_adam(args, experiments))
        steps = [_part_steps(results_root, idx, experiments)
                 for idx in range(1, args.nb_parts + 1)]
        if not all(steps[-1][s] > steps[-2][s] for s in steps[-1]):
            raise AssertionError(f"model_{args.nb_parts} steps {steps[-1]} not above "
                                 f"model_{args.nb_parts - 1}'s {steps[-2]}")
        for experiment in (rd_campaign.LEARNED, (1.0, 10000.0, False)):
            exp_dir = os.path.join(results_root, experiment_suffix(*experiment))
            with open(os.path.join(exp_dir, "statistics", "stats_model_idx.json")) as file:
                marker = json.load(file)
            export = checkpoint.params_artifact_step(os.path.join(exp_dir,
                                                                  "params_trained.npz"))
            if marker != {"idx_model": args.nb_parts, "step": export}:
                raise AssertionError(f"{exp_dir}: marker {marker}, export at step {export}")
        families = study.families
        if set(families) != {"EAE one model per gamma", "EAE learned bin widths",
                             "EAE fixed bin widths"} or not all(
                                 numpy.all(numpy.isfinite(a)) for f in families.values()
                                 for a in f[:2]):
            raise AssertionError(f"the campaign's study: families {sorted(families)}")
        learned_rates = families["EAE learned bin widths"][0].mean(axis=1)
        if not numpy.all(numpy.diff(learned_rates) <= 0.0):
            raise AssertionError(f"the learned model's coded rate rises with the multiplier: "
                                 f"{learned_rates}")
        print(f"  campaign: model_{args.nb_parts} of all {len(experiments)} models finished, "
              f"steps {sorted(set(steps[-2].values()))} -> {sorted(set(steps[-1].values()))}; "
              "statistics markers at their exports' steps; learned-bw coded rate "
              + " >= ".join(f"{r:.4f}" for r in learned_rates) + " bpp over x"
              + ", x".join(f"{m:g}" for m in reconstruct_kodak.MULTIPLIERS)
              + "; PSNR ranges " + "; ".join(
                  f"{label} {f[1].mean(axis=1).min():.2f}-{f[1].mean(axis=1).max():.2f} dB"
                  for (label, f) in families.items())
              + "; Bjontegaard " + ", ".join(
                  f"{key} {value['delta_pct']:+.2f} %" for (key, value) in
                  study.summaries.items()))

        # Second call: nothing is trained, collected or coded again.
        none = {"gdn_f32": 0, "igdn_f32": 0}
        mtimes = {path: os.path.getmtime(path) for path in glob.glob(
            os.path.join(results_root, "*", "*", "model_*"))}
        (again_s, again) = campaign("campaign again", none, {}, none, {})
        if again_s or any(os.path.getmtime(path) != mtime for (path, mtime) in mtimes.items()):
            raise AssertionError(f"the second call trained {sorted(again_s)}")
        if not all(numpy.array_equal(a, b) for label in families
                   for (a, b) in zip(families[label], again.families[label])):
            raise AssertionError("the second call's curves differ from the first's")
        # Third call: one ladder model's last part rewritten as interrupted.
        retrained = os.path.join(results_root, experiment_suffix(1.0, CAMPAIGN_RETRAINED,
                                                                 False),
                                 f"model_{args.nb_parts}")
        with open(retrained + ".json") as file:
            meta = json.load(file)
        meta["part_complete"] = False
        with open(retrained + ".json", "w") as file:
            json.dump(meta, file)
        mtimes = {path: os.path.getmtime(path) for path in glob.glob(
            os.path.join(results_root, "*", "*", "model_*"))}
        (third_s, _) = campaign("campaign retraining one model",
                                _campaign_launches(args, one_model=True), {}, none,
                                _campaign_adam(args, experiments, one_model=True))
        moved = sorted(path for (path, mtime) in mtimes.items()
                       if not os.path.isfile(path) or os.path.getmtime(path) != mtime)
        if moved != [retrained + ".json", retrained + ".npz"] or list(third_s) != [
                f"ladder part {args.nb_parts - 1}"]:
            raise AssertionError(f"the third call retrained {third_s}, rewrote {moved}")
        _part_steps(results_root, args.nb_parts, experiments)
        print(f"  campaign, third call: only {os.path.relpath(retrained, results_root)} "
              "retrained (the ladder's mixed-resume fallback), the curves from the caches")

        # (b) stability_study: the average over (a)'s parts, bit for bit.
        print("  (b) stability_study")
        template = init_train_state(torch.Generator().manual_seed(0), 1.0, False,
                                    device=DEVICE)
        t0 = time.perf_counter()
        for gamma in stability_study.GAMMAS:
            exp_dir = os.path.join(results_root, experiment_suffix(1.0, gamma, False))
            (mean, _, last_step, used) = stability_study.average_gamma_params(
                exp_dir, gamma, args.nb_parts, DEVICE)
            loaded = [checkpoint.params_to_jax(checkpoint.load_checkpoint(
                os.path.join(exp_dir, f"model_{idx}"), template).params) for idx in used]
            for (name, value) in mean.items():
                expected = (sum(p[name].astype(numpy.float64) for p in loaded)
                            / len(loaded)).astype(numpy.float32)
                if value.dtype != numpy.float32 or value.tobytes() != expected.tobytes():
                    raise AssertionError(f"stability average, gamma {gamma}: {name} differs")
            if used != list(range(1, args.nb_parts + 1)) or last_step != steps[-1][
                    experiment_suffix(1.0, gamma, False)]:
                raise AssertionError(f"stability average, gamma {gamma}: parts {used}")
        average_s = time.perf_counter() - t0
        print(f"    average_gamma_params over parts 1-{args.nb_parts} of the seven gammas "
              f"equal, bit for bit, to the float32 cast of the float64 mean of the loaded "
              f"checkpoints ({average_s:.2f} s)")
        images = synthetic_kodak(seed=14)[..., 0]
        if hashlib.sha1(images.tobytes()).hexdigest()[:10] != RD_IMAGES_TAG:
            raise AssertionError("the Kodak-shaped set is not the committed studies' set")
        path_kodak = os.path.join(root, "kodak.npy")
        numpy.save(path_kodak, images)
        stability_args = stability_study.build_parser().parse_args([
            "--k", "3", "--avg_root", AVG_ROOT, "--study_dir", COMMITTED_RD, "--out",
            os.path.join(root, "stability"), "--path_to_kodak", path_kodak, "--hevc_encoder",
            "", "--device", DEVICE])
        stability_study.copy_anchor_caches(stability_args.study_dir, stability_args.out)
        gk.reset_launch_counts()
        t0 = time.perf_counter()
        # The anchor is the committed study's Pillow curve, whatever codecs
        # this machine has.
        with mock.patch.object(jpeg2000, "imagemagick_available", lambda: False):
            stable = quiet(stability_study.evaluate, stability_args, found["matplotlib"])
        evaluation_s = time.perf_counter() - t0
        record("stability evaluation", _study_launches(
            images.shape[0], [(3, len(stability_study.GAMMAS)),
                              (3, len(reconstruct_kodak.MULTIPLIERS))]), STUDY_ENTRIES)
        with open(os.path.join(COMMITTED_STABILITY, "stability_comparison.json")) as file:
            used_committed = json.load(file)["averaged_parts"]
        comparison = quiet(stability_study.write_comparison, 3, used_committed,
                           stability_args.study_dir, stability_args.out)
        worst = {"psnr": 0.0, "mean_rate": 0.0, "image_rate": 0.0, "deads": 1.0}
        said = []
        for name in sorted(os.listdir(stability_args.out)):
            if not name.endswith(".npy") or "_hevc_" in name or "_jpeg2000_" in name:
                continue
            kind = name.split("_", 1)[0]
            said.append(f"{name[:-4]}: " + _hold_committed(
                kind, name, numpy.load(os.path.join(stability_args.out, name)),
                COMMITTED_STABILITY, name, worst))
        if len(said) != 2 + 3:
            raise AssertionError(f"the stability study wrote {said}")
        with open(os.path.join(COMMITTED_STABILITY, "dictionary_bjontegaard.pkl"), "rb") as file:
            committed = pickle.load(file)
        with open(os.path.join(COMMITTED_RD, "dictionary_bjontegaard.pkl"), "rb") as file:
            committed_last = pickle.load(file)
        key_gamma = "EAE one model per gamma vs JPEG2000"
        pairs = [(f"pickle, {key}", stable.summaries[key]["delta_pct"],
                  committed[key]["delta_pct"]) for key in (key_gamma,
                                                           "EAE fixed bin widths vs JPEG2000")]
        pairs += [("comparison, k_checkpoint_average",
                   comparison["k_checkpoint_average"][key_gamma],
                   committed[key_gamma]["delta_pct"]),
                  ("comparison, last_checkpoint", comparison["last_checkpoint"][key_gamma],
                   committed_last[key_gamma]["delta_pct"])]
        if set(stable.summaries) != {key_gamma, "EAE fixed bin widths vs JPEG2000"}:
            raise AssertionError(f"the stability pickle holds {sorted(stable.summaries)}")
        for line in said:
            print(f"    {line}")
        for (what, got, was) in pairs:
            print(f"    {what}: {got:+.4f} % (committed {was:+.4f} %)")
            if not abs(got - was) <= RD_BJONTEGAARD_POINTS:
                raise AssertionError(f"stability {what}: {got} against {was}")
        print(f"    evaluation of the committed averaged models {evaluation_s:.2f} s; largest "
              f"gaps: PSNR {worst['psnr']:.3e} dB [{RD_PSNR_DB}], a point's mean rate "
              f"{worst['mean_rate']:.3e} [{RD_MEAN_RATE}], an image's rate "
              f"{worst['image_rate']:.3e} [{RD_IMAGE_RATE}], dead-map counts equal "
              f"{100 * worst['deads']:.2f} % [{100 * RD_DEADS_EQUAL:.0f} %]; the HEVC entries "
              "left out (no HM binary in the repository)")

        # (c) resilient_campaign: one more part, each in a fresh process.
        common = resilient_campaign.common_args(args.nb_epochs, args.batch_size,
                                                args.data_root, results_root, DEVICE)
        t0 = time.perf_counter()
        fresh_s = resilient_campaign.run_parts(args.nb_parts, args.nb_parts, common,
                                               results_root, RESILIENT_TIMEOUT_S, cooldown_s=0)
        resilient_s = time.perf_counter() - t0
        resumed = _part_steps(results_root, args.nb_parts + 1, experiments)
        nb_steps = args.nb_epochs * (args.nb_training // args.batch_size)
        if any(resumed[s] != steps[-1][s] + nb_steps for s in resumed) or sorted(fresh_s) != [
                f"ladder part {args.nb_parts}", f"learned-bw part {args.nb_parts}"]:
            raise AssertionError(f"resilient part: steps {resumed}, parts {fresh_s}")
        print(f"  (c) resilient_campaign, part {args.nb_parts} in fresh processes "
              f"({resilient_s:.2f} s in all): " + ", ".join(
                  f"{part} {s:.2f} s (in-process part {args.nb_parts - 1}: "
                  f"{part_s[part.rsplit(' ', 1)[0] + f' {args.nb_parts - 1}']:.2f} s)"
                  for (part, s) in fresh_s.items())
              + f"; model_{args.nb_parts + 1} of the {len(resumed)} models finished at step "
              f"{sorted(set(resumed.values()))}, {nb_steps} steps after model_{args.nb_parts}")

    # (d) reference_parity: the port's side on the card; the TF graph's
    # place is taken by the same fp32 round trip on the CPU.
    tensorflow = importlib.util.find_spec("tensorflow") is not None
    print(f"  (d) reference_parity: reference_available() {reference_parity.reference_available()}"
          f", tensorflow importable {tensorflow}; the TF graph is replaced by a stand-in (the "
          "port's fp32 round trip on the CPU); no number from the reference is claimed")

    def cpu_roundtrip(params_numpy, bin_widths, images_f32, learn_bin_widths):
        params = checkpoint.params_from_jax(params_numpy)
        with torch.no_grad():
            y = conv_eae.encode(params, torch.from_numpy(images_f32), learn_bin_widths)
            rec = conv_eae.decode(params, quantize_per_map(y, bin_widths), learn_bin_widths)
        return (y.numpy(), rec.numpy())

    parity_images = synthetic_luminance_stack(PARITY_IMAGES, PARITY_PIXELS, PARITY_PIXELS,
                                              seed=21)[..., 0]
    for (exp_dir, learned) in ((LEARNED, True), (FIXED, False)):
        tag = "learned" if learned else "fixed"
        sites = 2 if learned else 3
        (params_np, bin_widths) = checkpoint.load_params_artifact(
            os.path.join(exp_dir, "params_trained.npz"))
        with mock.patch.object(reference_parity, "reference_roundtrip_tf", cpu_roundtrip):
            gk.reset_launch_counts()
            report = reference_parity.measure_psnr_parity(
                checkpoint.params_from_jax(params_np), bin_widths, parity_images, learned,
                batch_size=PARITY_IMAGES, device=DEVICE)
            record(f"reference parity, {tag}", {"gdn_f32": sites, "igdn_f32": sites},
                   {"gdn_f32": PARITY_SHAPES[:sites], "igdn_f32": PARITY_SHAPES[:sites]})
        print(f"    {tag} bin widths, {PARITY_IMAGES} images of {PARITY_PIXELS} x "
              f"{PARITY_PIXELS}: PSNRs on the card " + ", ".join(
                  f"{p:.4f}" for p in report["psnrs_ours"]) + " dB, through the stand-in "
              + ", ".join(f"{p:.4f}" for p in report["psnrs_reference"])
              + f" dB; max_abs_delta_db {report['max_abs_delta_db']:.3e} [0.05], "
              f"cross PSNR {report['cross_psnr_db']:.2f} dB [{card}]")
        if not report["max_abs_delta_db"] <= 0.05:
            raise AssertionError(f"reference parity, {tag}: {report}")
    return (paths, on_path, rows_seen)


def check_seen_rows(rows_seen, phase="phase 9"):
    """Every kernel against its plain version at each row count ``phase``
    launched it at (untimed where phase 2 did not time that count); the
    gradient kernel against its twin as :func:`check_backward` holds it."""
    from autoencoder_based_image_compression_tpu_torch.ops.kernels import gdn_kernel as gk

    timed = {(name, ROWS[shape]) for (name, variant) in VARIANTS.items() for shape in variant[4]}
    timed |= {(name, (ROWS[shape.split()[0]], 1 if shape.endswith("x1") else STACKED_MODELS))
              for name in STACKED_VARIANTS for shape in STACKED_SHAPES}
    for (seed, ((name, rows), launches)) in enumerate(sorted(rows_seen.items())):
        if name == REDUCE:
            continue  # held with its tile pass, below
        if name in BACKWARD_VARIANTS:
            (per_model, models) = rows if isinstance(rows, tuple) else (rows, 1)
            (gaps, _) = check_backward(name, *backward_inputs(name, per_model, models, 50 + seed))
            print(f"  {name:25s} rows {models} x {per_model:6d}: {launches} launches in {phase}; "
                  f"gap / largest entry {max(gaps):.3e} [1e-4], two calls equal")
            continue
        if name in STACKED_VARIANTS:
            (per_model, models) = rows
            (_, max_abs) = check_stacked(name, per_model, models, 50 + seed)
            print(f"  {name:17s} rows {models} x {per_model:6d}: {launches} launches in {phase}; "
                  f"max abs err {max_abs:.3e} [rtol 1e-5, atol 1e-6], models equal to the "
                  "single-model kernel bit for bit"
                  + ("; timed in phase 2" if (name, rows) in timed else ""))
            continue
        (_, inverse, quantize, _, _, _) = VARIANTS[name]
        (x, *params) = kernel_inputs(name, rows, 50 + seed)
        kernel = gk.gdn_quantize_2d if quantize else gk.gdn_2d
        plain = gk.gdn_quantize_2d_plain if quantize else gk.gdn_2d_plain
        got = kernel(x, *params, inverse=inverse)
        expected = plain(x, *params, inverse=inverse)
        torch.cuda.synchronize()
        (max_abs, _, tolerance, detail) = check_kernel(name, rows, got, expected, params[-1])
        print(f"  {name:17s} rows {rows:6d}: {launches} launches in {phase}; "
              f"max abs err {max_abs:.3e} [{tolerance}] {detail}"
              + ("; timed in phase 2" if (name, rows) in timed else ""))


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs an "
              "NVIDIA GPU.", file=sys.stderr)
        return 1
    if not os.path.isdir(PACKAGE):
        print(f"chip_smoke: {PACKAGE} is missing; run this script from a checkout of the "
              "repository.", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    card = card_line()
    print("phase 1: card")
    print(f"  {card}")
    print(f"  python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    build_all()

    print("phase 2: kernels against their plain versions")
    kernel_results = phase_kernels()
    kernel_results.update(phase_stacked_kernels())
    phase_gradient(kernel_results)
    adam_results = phase_adam()
    print("phase 3: serving (PipelinedCompressor)")
    (path_launches, pipeline_table, psnrs_fp32) = phase_serving(kernel_results)
    print("phase 4: fixed-bin-width roundtrip_batched")
    path_launches.update(phase_fixed_bw())
    print("phase 5: training (pre-fit, graphed epochs, train_step, checkpoint, "
          "collect_stats, serve)")
    draws_equal = philox_draws_equal()
    print(f"  a CUDA graph's replays draw what eager calls draw from the same generator "
          f"state: {draws_equal}")
    for learn_bin_widths in (True, False):
        path_launches.update(phase_training(kernel_results, learn_bin_widths, draws_equal))
    print("phase 6: the gamma ladder (cli/train_ladder, seven models)")
    path_launches.update(phase_ladder(draws_equal))
    print("phase 7: the rate-distortion study (eval/rd_sweep on the committed models)")
    path_launches.update(phase_rd_study())

    print("phase 7b: the rest of serving (bf16w, int8, fixed-bw fast decode, scan graph, "
          "streaming) and the serving bench")
    path_launches.update(phase_serving_variants(kernel_results, pipeline_table, psnrs_fp32))
    print("phase 7c: the gate on two more image sets (scan path and pipeline)")
    phase_gate_sets()

    print(f"phase 9: the distributed layer [{card}]")
    (launches, rows_seen) = phase_distributed(card, draws_equal)
    path_launches.update(launches)
    print("  the kernels against their plain versions at the distributed paths' row counts:")
    check_seen_rows(rows_seen)

    print(f"phase 10: the SVHN side (dense EAE, VAE, entropy study) [{card}]")
    phase_svhn(card, draws_equal)
    print(f"phase 11: the latent-analysis tooling on both trained models [{card}]")
    (launches, rows_seen) = phase_tooling(card)
    path_launches.update(launches)
    print("  the kernels against their plain versions at the tooling paths' row counts:")
    check_seen_rows(rows_seen, "phase 11")
    print(f"phase 12: the campaign scripts at full width (rd_campaign, stability_study, "
          f"resilient_campaign, reference_parity) [{card}]")
    t0 = time.perf_counter()
    (launches, campaign_entries, rows_seen) = phase_campaign(card)
    path_launches.update(launches)
    print("  the kernels against their plain versions at the campaign paths' row counts:")
    check_seen_rows(rows_seen, "phase 12")
    print(f"  phase 12 took {time.perf_counter() - t0:.1f} s")

    print(f"phase 13: the scale hyperprior (GDN sites with a gamma not symmetric, the graphed "
          f"step) [{card}]")
    path_launches.update(phase_hyperprior(kernel_results))
    print(f"phase 14: Minnen et al.'s joint prior (GDN kernels at 192 channels, the graphed "
          f"step) [{card}]")
    path_launches.update(phase_minnen2018(kernel_results))

    print("phase 8: kernel times")
    # Each kernel of a path, with its launches on that path (the counts
    # are per variant: a variant's shapes on one path share them).
    on_path = [("gdn_f32", "serving bf16w+", "H/4"), ("igdn_bf16", "serving bf16w+", "H/4"),
               ("igdn_f32", "serving fp32", "H/4"),
               ("gdn_quantize_f32", "fixed-bw roundtrip", "H/16")]
    on_path += [("gdn_bf16", "serving bf16w", "H/4"), ("gdn_bf16", "serving bf16w", "H/8"),
                ("igdn_bf16", "serving bf16w", "H/8"), ("gdn_bf16", "serving int8", "H/4"),
                ("igdn_bf16", "serving int8", "H/8"),
                ("igdn_f32", "fixed-bw fast decode", "H/16"),
                ("igdn_f32", "fixed-bw fast decode, batch of 24", "B/16"),
                ("igdn_bf16", "fixed-bw fast decode, batch of 24", "B/8"),
                ("gdn_f32", "scan bf16w+, batch of 24", "B/4"),
                ("gdn_f32", "scan bf16w+, batch of 24", "B/8"),
                ("igdn_f32", "scan bf16w+, batch of 24", "B/8"),
                ("igdn_bf16", "scan bf16w+, batch of 24", "B/4"),
                # The bench runs every variant and the fp32 path at the batch of 24.
                ("gdn_bf16", "serving bench", "B/4"), ("gdn_bf16", "serving bench", "B/8"),
                ("igdn_bf16", "serving bench", "B/8"), ("igdn_f32", "serving bench", "B/4")]
    # One model's training steps launch the stacked kernel at its rows.
    on_path += [(name, "training, fixed bin widths", f"{shape} x1")
                for name in STACKED_VARIANTS for shape in TRAIN_SHAPES]
    on_path += [(name, "training, learned bin widths", "T/4 x1") for name in STACKED_VARIANTS]
    on_path += [(name, "ladder training", shape) for name in STACKED_VARIANTS
                for shape in TRAIN_SHAPES]
    # The gradient kernel on the training paths (phase 2 timed it there).
    on_path += [(name + "_backward", "training, fixed bin widths", f"{shape} x1")
                for name in STACKED_VARIANTS for shape in TRAIN_SHAPES]
    on_path += [(name + "_backward", "ladder training", shape) for name in STACKED_VARIANTS
                for shape in TRAIN_SHAPES]
    on_path += [(name + "_backward", "ladder over seven shards", "T/16 x1")
                for name in STACKED_VARIANTS]
    # The pre-fit epochs (phases 5, 6): the encoder's GDN sites, counted at
    # the capture of the replayed training_fct (a replay counts none).
    on_path += [("gdn_f32_stacked", "pre-fit, fixed bin widths", f"{shape} x1")
                for shape in TRAIN_SHAPES]
    on_path += [("gdn_f32_stacked", "pre-fit, learned bin widths", "T/4 x1")]
    on_path += [("gdn_f32_stacked", "ladder pre-fit", shape) for shape in TRAIN_SHAPES]
    on_path += [(name, "rd study", shape) for name in ("gdn_f32", "igdn_f32")
                for shape in SERVE_SHAPES]
    # The distributed layer (phase 9): a band or a data block is half a
    # serving batch; the sharded training and ladder steps keep a step's rows.
    on_path += [(name, "spatial roundtrip, learned", shape)
                for name in ("gdn_f32", "igdn_f32") for shape in ("S/4", "S/8")]
    on_path += [("gdn_quantize_f32", "spatial roundtrip, fixed", "S/16"),
                ("igdn_f32", "spatial roundtrip, fixed", "S/16"),
                ("igdn_bf16", "pipeline over a data mesh, bf16w+", "S/4"),
                ("gdn_f32", "pipeline over a data mesh, fp32", "S/4"),
                ("igdn_f32", "stream roundtrip over a data mesh", "S/4")]
    on_path += [(name, f"distributed training, {tag} bin widths", "T/4")
                for name in ("gdn_f32", "igdn_f32") for tag in ("learned", "fixed")]
    on_path += [(name, "ladder over seven shards", "T/16 x1") for name in STACKED_VARIANTS]
    # The tooling (phase 11): the Laplace fit and the masking at the serving
    # batch's rows, the activation probe and the importer's decode at a
    # 16 x 16 latent's, visualize_model at two images'.
    for tag in ("learned", "fixed"):
        on_path += [("gdn_f32", f"latent_analysis fit, {tag}", "H/4"),
                    ("igdn_f32", f"mask_maps, {tag}", "H/4"),
                    ("gdn_f32", f"visualize_model, {tag}", "S/4"),
                    ("gdn_f32", f"visualize_model, {tag}", "S/8")]
        on_path += [("igdn_f32", f"{path}, {tag}", shape) for shape in ("A/4", "A/8")
                    for path in ("activation probe", "import_reference decode")]
    on_path += [("igdn_f32", "activation probe, fixed", "A/16"),
                ("igdn_f32", "mask_maps, fixed", "H/16"),
                ("gdn_f32", "visualize_model, fixed", "S/16")]
    # The campaign scripts (phase 12): their training at a step's rows,
    # collect_stats at a batch of 20 crops, the RD studies at the serving
    # batch's, the parity harness at two 64 x 64 images'.
    on_path += campaign_entries
    on_path += HYPERPRIOR_ON_PATH + JOINT_ON_PATH
    # Adam's kernel on each training path, its launches as the path's run
    # counted them: one train_step (phases 5, 6, 13, 14), a sharded step and
    # the ladder over seven shards (phase 9), the campaign's training
    # (phase 12).
    adam_paths = [f"one train_step, {tag} bin widths" for tag in ("learned", "fixed")]
    adam_paths += ["one ladder train_step", "one hyperprior train_step",
                   "one joint prior train_step"]
    adam_paths += [f"one sharded train_step, {tag} bin widths" for tag in ("learned", "fixed")]
    adam_paths += ["ladder over seven shards", "campaign", "campaign retraining one model"]
    kernels = (kernel_entries(on_path, path_launches, kernel_results)
               + adam_entries(adam_paths, adam_results))
    print(f"  total {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
