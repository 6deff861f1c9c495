"""Drive the port's serving, training, RANSAC, held-out evaluation, bench,
gather-bench, long-run trainer, head, mapper-option, fp16 and data-parallel
paths on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases, each printed with its elapsed seconds; any failure raises (exit != 0).
The main paths (6-7d, 7g) read their batches from the dataset's iterators,
made on the card (``generator_kind`` must be ``device-torch``) and log each
batch's build time; the references (4-5c) give the card and the CPU the
host generator's batch:

1. device: a CUDA card must be present; prints its name and power limit;
2. build: compiles the eight CUDA kernels of ``snap_tpu_torch/csrc`` (one
   nvcc call per source, all started together, then one link; its seconds
   printed); prints the SASS instructions of B4's, B7's, K1's and K3's
   ranks stage's loops (``cuobjdump``; K1's in the flagship's layout and
   in B8's two of phase 7j, in bf16 and f16; K3's in the two weighted
   layouts: ``SASS_LOOPS``);
3. kernels: K1 (``lift_topk_fwd``), K2 (``patch_sample_2d``), K3
   (``lift_topk_bwd``) and K4 (``patch_sample_2d_bwd``) on seeded inputs at
   the flagship shapes and the training batch of 2, in bf16 and f16,
   against their plain PyTorch versions (K3's inputs hold single-view
   points and unselected ranks, and repeat a rank for exact score ties),
   with each launch's resources; in f16 K3 and K4 also with an infinite
   cotangent entry (the gradient non-finite at the plain version's
   non-finite entries alone, ``check_non_finite``); B4 (``pose_scoring``) on
   seeded inputs at the eval shape with transformed points on cell edges,
   borders and off the map, mask on and off; B7 (``pose_scoring_bwd``) at
   the training shape (batch 2, 10,001 poses, 4,652 points, 120 x 160) on
   the same kind of inputs, mask on and off, with invalid points, a run of
   2,000 identical poses (every pose of a point adds into the same four
   cells; alone, its sum is held to the closed form) and an example whose
   cotangent is all zero, held to its plain version bit for bit; B5
   (``slice_gather``) and B6 (``table_gather``) at the gather tool's
   shapes over all N points; B8 (K1 and K3 in the
   other statistics layouts, ``B8_SEEDED``: weighted with the max and min,
   unweighted with the variance, unweighted with the max and min and no
   variance, and the scan form's 20 ranks) forward and backward in f32,
   bf16 and f16 (the resources of each bf16 and f16 instantiation), on
   inputs of the same kinds (single-view points, points with no
   selected rank, repeated ranks for exact ties of every channel), the
   cotangents of the maxima zeroed at near ties (NEAR_TIE_RTOL); K3 timed
   on the flagship's seeded input and B8's in bf16, with its device ms by
   launch stage (``torch.profiler``);
4. serving reference: the tiny ``smoke_exhaustive`` localizer on the card
   (f32, TF32 off) against the same model on the CPU (the plain path);
5. training reference: ``smoke_train_exhaustive`` (f32, TF32 off), 2 steps
   on the card and on the CPU in lockstep, each step from the same weights,
   batch and (injected) draws, the CPU's max poolings made to pick the
   entries the card's picked (``MaxChoices``, ROADMAP C11); the loss and
   every parameter's gradient must agree at each step, leaf by leaf in the
   largest entry and in norm;
5b. RANSAC reference: the tiny ``smoke_eval_ransac`` localizer on the card
   (f32, TF32 off) against the CPU, with the CPU's pose samples injected:
   sampled and refinement scores within tolerance, ``best_index`` exact
   outside near ties, the refined pose within tolerance;
5c. RANSAC training reference: ``smoke_train_ransac`` as phase 5, 2 steps
   in lockstep, the CPU given the card's draws and pose samples and
   replaying its max choices (the score clip's relu included); the loss
   and every gradient leaf agree under the same tolerances, and B4 and B7
   launch at least once each card step;
5d. heads reference: as phase 5 (each card step's kernels checked), the
   tiny semantic head (``smoke_semantics``, its flips and modality
   dropout, trained whole: K1 and K3 each card step), the tiny occupancy
   head on a frozen street-view encoder (``stop_encoder_gradients`` and
   the freeze of ``train_occupancy``: K1 each card step, K2-K4 never; the
   frozen leaves' gradients 0 on both devices) and the tiny localizer with
   the semantic modality (K1-K4 each card step);
5e. the mapper options the flagship does not use, as phase 5 (K1-K4 each
   card step): the tiny aerial-only localizer (its map has no images; the
   query goes through a street-view mapper of its own) with ``bev_net``;
   query confidence on the aerial-only map, exhaustive and RANSAC (B4 and
   B7 each card step), the map's confidence head 0 on both devices and
   the query's not; the street-view column pooled ``'weighted'`` with the
   modalities fused ``'softmax'``; the column pooled by ``'mlp'``;
5f. the lift's other forms (A14, item 5; ``A145_FORMS``), as phase 5:
   the tiny localizer with the stream's max and min (K1-K4 each card
   step), the scan unweighted (K1-K4), and the gather form unweighted with
   the max and min, no variance and a depth MLP (K2 and K4 each card step,
   K1 and K3 never; the depth MLP takes a gradient);
5g. f16 with the dynamic loss scale: ``smoke_train_exhaustive`` with
   ``dtype_str='float16'`` as phase 5 (K1-K4 each card step), the
   is_finite flags and loss scales equal on both devices, under
   ``F16_TRAIN_TOL``; then one step on each from a loss scale of 2^30,
   which overflows f16 on both: skipped, no parameter moved, the scale
   halved; every card kernel call in f16 (``KernelDtypes``);
6. serving main path: ``snap_tpu_torch.evaluate`` on ``bench_full`` (R50,
   20 views of 180x240, 120x160x60 voxels, 64 rotations + refinement,
   bf16, random seeded weights), batch 1, 2 synthetic queries; K1 and K2
   must launch;
7. training main path: ``snap_tpu_torch.train`` on
   ``train_full1chip_exhaustive`` (the same model, batch 2, z jitter and
   modality dropout, Adam under warmup), 3 steps: finite loss and
   gradients, non-zero gradients on the street-view trunk, the proj MLP,
   the temperature and (on a step whose draws keep it) the aerial trunk,
   the parameters move once the learning rate is above 0, and every kernel
   launches each step (K1 >= 2, K2 >= 1, K3 >= 2, K4 >= 1); the trainer's
   eval and checkpoint at the stop step follow (their launches logged
   apart); each training phase has a workdir of its own under
   ``workdirs/``, removed after it;
7a. RANSAC training main path: ``snap_tpu_torch.train`` on
   ``train_full1chip_ransac`` (the same model with the in-FoV query points,
   clipped scores and 10,000 pose samples x 8 retries, batch 2), 3 steps,
   with phase 7's checks per step and its launches: K1 >= 2, K3 >= 2, B4
   >= 1, B7 >= 1, K2 and K4 never;
7b. RANSAC main path: ``snap_tpu_torch.evaluate`` on
   ``eval_full1chip_ransac`` (R50 street-view + aerial, 20 views of
   180x240, 0.2 m, top-k 4 lift, 20,000 pose samples x 8 retries, grid
   refinement, f32, random seeded weights) at batch 4: one warm batch, one
   timed; per batch B4 launches >= 2, K1 >= 2, K2 never, finite scores;
   the share of match-PDF categories an f32 prefix sum could not draw
   (ROADMAP C14);
7c. held-out main path: ``evaluator.run`` of the held-out protocol
   (``eval_full1chip_exhaustive``: the exhaustive localizer in f32 with
   dense refinement, TF32 off, batch 4) over zurich and oslo, 8 card-made
   examples a city, on a workdir under ``workdirs/`` that holds the
   flagship's config in the reference's keys and seeded weights as flat
   flax params: each dump's config is the protocol's, K1 and K2 launch at
   least twice a batch, the metrics are finite; a second run must read
   both dumps with no launch and give the same arrays; each city's summary
   line printed;
7d. the bench: ``snap_tpu_torch.bench`` at full width (``bench_full`` at
   batch 4, ``train_full1chip_exhaustive`` at batch 2; its JSON line
   printed), on card-made batches, every figure finite, K1-K4 launching;
7e. the gather bench: ``snap_tpu_torch.bench_gather`` at the tool's shapes
   (its JSON line printed), B5 and B6 launching;
7g. the trainer of a long run: ``train_full1chip_exhaustive`` (a
   checkpoint and a summary every 2 steps, an eval of 1 batch every 4, the
   last 2 checkpoints kept) stopped at step 2; the checkpoint restored into
   other weights equals the live state bit for bit (params, moments,
   count, step, seed), and one step from each on the resumed run's batch of
   step 3 agrees under phase 5's tolerances, in phase 5's f32 with TF32 off;
   in bf16 with ``cudnn.deterministic`` on the two steps give equal losses,
   logs and gradient leaves bit for bit (ROADMAP C20), the same pair with it
   off is logged (entries that differ, the worst leaf, and if any differ
   the step's device ms either way), and the pair again in a child process
   under ``torch.use_deterministic_algorithms(True)``
   (``CUBLAS_WORKSPACE_CONFIG=:4096:8`` set before CUDA starts), which
   raises on any op of the step torch knows to be nondeterministic, must
   give equal bits; a new ``train`` call resumes to
   step 10 (the data-seed fold logged), traced over steps 6-10
   (``torch.profiler``, its device-busy and idle split printed), K1 >= 2,
   K2 >= 1, K3 >= 2, K4 >= 1 and finite losses and gradients each step,
   summaries at 4, 6, 8, 10, evals at 4, 8, 10, checkpoints 8 and 10 left,
   ``progress.json``, its own peak memory within 0.5 GiB of the first
   chunk's (no second copy of the state); the
   held-out protocol (8 examples a city, as 7c) on that workdir reads step
   10; a continuation (``continue_step=12500``) warm-started from a seeded
   JAX-format export: after the lr-0 first step every mapper parameter is
   the export's and the rest the seeded init, bit for bit; and the smoke
   trainer's loss over 300 steps on the card: the last 50 steps' mean below
   the first 50's (each over its finite steps, at most 5 of 50 not);
7h. the heads at full width, warm-started from a seeded JAX-format export
   of the flagship run: ``train_semantics`` (the frozen R50 street-view +
   aerial mapper, 20 views of 180x240, 0.2 m, bf16, batch 1, a
   ``resnet_stage`` decoder of width 256 with 2 units) and
   ``train_occupancy`` (the frozen street-view encoder, 10,000 rays x 100
   samples read from the [1, 120, 160, 60, 128] volume), 3 steps each with
   the trainer's eval (1 batch) and checkpoint at the last: finite losses,
   K1 at least once a step and K2-K4 never, every adopted parameter the
   export's bit for bit after step 3 and every head parameter moved; then
   ``evaluator.run`` of ``eval_semantics`` on 2 examples of the semantic
   head's checkpoint (finite ``semantics/*`` and ``gt_counts/*``); then
   phase 7's path and checks on
   ``train_full1chip_exhaustive:modalities=streetview+aerial+semantic``,
   the semantic trunk's gradient on a step whose draws keep it; each run's
   step ms and own peak memory logged;
7i. the mapper options at full width (seeded weights, bf16, batch 2):
   ``train_full1chip_exhaustive:modalities=aerial`` (the aerial R50 map,
   the query's own 20-view street-view mapper at 180x240, 0.2 m), 3 steps
   with phase 7's checks (K1, K2, K3, K4 >= 1 a step; the query mapper's
   trunk takes a gradient), then ``evaluator.run`` of its workdir on 2
   batches of zurich (f32, dense refinement: K1 and K2 each batch, finite
   errors, step 3 read); the flagship with ``bev_net=1`` and
   ``add_confidence_query``, 3 steps with phase 7's checks and launches,
   the stage's units and the confidence head each taking a gradient; each
   run's step ms, own peak memory and the device ms of 2 more steps traced
   (``torch.profiler``) logged;
7j. the lift's other forms at full width (seeded weights, bf16, batch 2):
   ``train_full1chip_exhaustive`` with each form of ``A145_FORMS`` (the
   street-view encoder's keys merged in, as the reference's overrides set
   them), 3 steps with phase 7's checks: the stream with the max and min
   (stats 513 wide) and the scan unweighted (20 ranks a point) launch K1
   and K3 at least twice a step (map and query) and K2 and K4 at least
   once; the gather form with a depth MLP (128, 128) materializes the
   [2, 1,152,000, 4, 128] observations, launches no lift kernel, and its
   depth MLP takes a gradient; each run's step ms, own peak memory and
   the device ms of 2 more steps traced (``torch.profiler``) logged;
7k. f16 at full width: ``train_full1chip_exhaustive`` with
   ``dtype_str='float16'`` (seeded weights, batch 2), 12 steps: the loss
   scale's sequence follows flax's rule from 65536, some step by the 9th
   is finite, the finite steps' losses and gradients finite, the skipped
   steps' parameters unmoved, K1-K4 each step and every kernel call in
   f16; 2 more steps resumed from its checkpoint (the scale restored) and
   traced (device ms a step, idle share), its own peak memory; then
   ``evaluator.run`` of its workdir in f16 on 4 examples of zurich at
   batch 2 (the step read, finite errors, K1 and K2 each batch, in f16);
   two steps from its last checkpoint on one batch with
   ``cudnn.deterministic`` on: the entries whose bits differ and each
   step's (is_finite, loss scale) logged, not held;
7f. data on the card: the device generator (``data/device_synthetic.py``)
   makes the training batch (``train_full1chip_exhaustive``, batch 2) and
   the RANSAC eval batch (``eval_full1chip_ransac``, batch 4) on the card
   and on the CPU from the same draws, compared leaf by leaf (floats to
   1e-5, colors to 1e-4, at most 1e-3 of a leaf's elements off); the
   schema against the host generator's; ten builds of each timed (host
   clock and CUDA events) with their peak memory, the kernel launches and
   device time of one build (``torch.profiler``, after the main paths so
   that they run unprofiled as before), and three batches from the
   dataset's iterator, whose ``generator_kind`` must be ``device-torch``;
8. the kernels against their plain versions again, on the inputs the
   main paths gave them (the backward kernels' cotangents scaled by a power
   of two to a largest entry in [1, 2); K1 also on the RANSAC path's f32
   lift), and CUDA-event times of kernel, plain version and, where one
   PyTorch call computes the same function, that call (``F.grid_sample``
   and its input gradient for K2 and K4; ``F.embedding_bag`` and
   ``F.embedding`` for B5 and B6, from the bench); K1 also timed on the
   RANSAC path's f32 input, and B4 on both of its calls (sampled poses and
   the refinement lattice), each with its bound and B4's grid and waves;
   B4 and B7 on the RANSAC training run's own inputs (B7's cotangent
   scaled as the other backward kernels'), each with its bound, B7 bit for
   bit against its plain version (as captured and without the GT pose's
   cotangent) and ten calls on each input to the same bits; K3 and K4
   called ten times on each captured training input (the flagship's, 7j's
   and 7k's), every call's bits the first's (ROADMAP C20);
   K1, K2, K3, K4, B4 and their library calls timed again with the
   launches queued behind a spin of the card (the card's time alone,
   without the host's launch overhead); K3's selected ranks and K4's points
   by their sorts' bins (count, non-empty bins, the largest), and K2's,
   K3's and K4's device time by launch stage (``torch.profiler``); for
   every launch of each kernel on these inputs,
   its registers, shared memory and spills and the blocks per SM the card
   keeps resident at that launch's shape (``kernels.occupancy``); K1 and
   K2 also checked and timed on the held-out run's f32 inputs, behind a
   spin too, ``F.grid_sample`` in f32 beside K2; B8's K1 and K3 checked on
   every input phase 7j's stream and scan runs gave them (the plain versions
   ``PLAIN_LIFT_CHUNK`` points at a time) and timed on the largest beside
   their plain versions and bounds, K3 with its device ms by launch stage.
   Every K3 call timed takes its count of selected ranks counted
   beforehand, as the autograd function passes it (``lift_bwd_call``).
   K1-K4 in f16 on phase 7k's inputs (K1 and K2 its evaluation's, K3 and
   K4 its steps'), checked on every captured input and timed beside their
   plain versions, bounds and (K2, K4) ``F.grid_sample`` and its input
   gradient in f16;
9. the mesh's data axis over processes (``snap_tpu_torch/parallel``):
   (a) ``train_full1chip_exhaustive`` in f32 with TF32 off, global batch
   2, DP_STEPS steps from the weights of seed 0, first in this process,
   then on DP_RANKS ranks (child processes of this script with
   ``torchrun``'s environment) that share the one card over gloo, each
   building its block of 1 of every batch: each rank's losses against the
   one process's to phase 5's tolerance, each parameter leaf within twice
   the one-process steps' largest move of it, the ranks' parameters equal
   bit for bit after each step; the gradient leaves' errors (logged, not
   held: ``_child_dp_step`` says why), each rank's step ms, own peak memory
   and the all-reduce's bytes and ms logged; (b) one rank
   alone in an NCCL group: a flagship training step through ``train``
   (its all-reduces called through the group, K1-K4 launch) and an
   evaluation batch of ``eval_full1chip_exhaustive`` at batch 2 (its rows
   gathered through the group), finite errors. Every child's failure fails
   the run.

The line before the last is a JSON object with one entry per kernel (K1
and K2 launches from the serving run, K3 and K4 from the training run, B4
from the RANSAC run, B7 from the RANSAC training run, B5 and B6 from the
gather bench), one for B4 at the RANSAC training run's inputs
(``/train``, launches from that run) and two for K1 and K2 at the
held-out run's f32 inputs (``/heldout_f32``, launches from that run), and
B8's K1 and K3 at phase 7j's inputs (``/stream_minmax``,
``/scan_unweighted``, launches from those runs; K1's rows also give its
``registers``, ``local_bytes`` and ``blocks_per_sm``), and K1-K4 in f16
(``/f16``: K1 and K2 launches from phase 7k's evaluation, K3 and K4 from
its steps; each also gives ``spin_ms``); the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import logging
import math
import os
import pathlib
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from snap_tpu_torch import bench
from snap_tpu_torch import bench_gather
from snap_tpu_torch import configs
from snap_tpu_torch import convert
from snap_tpu_torch import evaluate
from snap_tpu_torch import evaluator
from snap_tpu_torch import train
from snap_tpu_torch.data import device_synthetic
from snap_tpu_torch.data import loader
from snap_tpu_torch.data import types as data_types
from snap_tpu_torch.models import bev_localizer
from snap_tpu_torch.models import bev_mapper
from snap_tpu_torch.models import pose_estimation
from snap_tpu_torch.models import pose_exhaustive_voting as pev
from snap_tpu_torch.models import resnet
from snap_tpu_torch.ops import gathers
from snap_tpu_torch.ops import kernels
from snap_tpu_torch.ops import view_scan
from snap_tpu_torch.parallel import mesh as parallel_mesh
from snap_tpu_torch.utils import geometry
from snap_tpu_torch.utils import grids
from snap_tpu_torch.train_lib import checkpoints
from snap_tpu_torch.train_lib import dynamic_scale
from snap_tpu_torch.train_lib import optimizers
from snap_tpu_torch.train_lib import trainer
from snap_tpu_torch.utils import prng

T0 = time.perf_counter()
# Each phase that trains gets a workdir of its own here, removed after it:
# with checkpoints on, a workdir left from an earlier run would resume.
WORKDIRS = pathlib.Path(__file__).resolve().parent / 'workdirs'
# The peak memory of each training main path's steps (phases 7, 7a).
TRAIN_PEAK = {}


def fresh_workdir(name: str) -> pathlib.Path:
  path = WORKDIRS / f'chip_smoke_{name}'
  shutil.rmtree(path, ignore_errors=True)
  return path

# Tolerances (atol, rtol), kernel against plain version: both accumulate in
# f32 and differ by summation order (the backward kernels sum in a fixed
# order of their own, the plain versions with index_add_), then by one
# rounding of the output dtype. The backward kernels are linear in the cotangent and are
# checked on cotangents scaled to a largest entry in [1, 2) (see
# unit_cotangent), so that atol stays far below the gradient it bounds.
TOLERANCES = {torch.bfloat16: (1e-3, 2.0**-7), torch.float16: (1e-3, 2.0**-10),
              torch.float32: (1e-4, 1e-5)}
# Training reference, card against CPU in f32 with TF32 off: cuDNN, cuFFT
# and the kernels sum in other orders than the CPU, and where two values
# of a max pooling (vertical or over modalities) are closer than that
# difference, the argmax, and with it the path of the gradient, flips. The
# loss to 1e-4 relative; each gradient leaf's largest error to 1e-2 of its
# largest entry (a first run measured 1.2e-3 on the street-view root conv
# at step 1; the CPU against JAX's grads, with no such flips, 3e-6:
# tests/test_torch_train.py), and its error's norm to 1e-2 of its norm, so
# that entries well below the largest (such as the score channels) are
# held too.
# The score max's gradient jumps where two selected ranks' scores meet: K3
# and its plain version round each score differently (~1e-7 relative), so
# where the two largest scores differ by less than that they can disagree
# on which is larger and pass g_m to different ranks (a first run at batch
# 2 met 41 such values in 2.3M points, all score channels; JAX's function
# has the same jump). The check zeroes g_m at points whose two largest
# selected scores differ by a non-zero amount within NEAR_TIE_RTOL of their
# size; exact ties (the seeded inputs repeat a rank) keep theirs.
# B8's max and min of each channel jump alike, and at 2.3M points x 128
# channels two ranks that read different taps also tie exactly by
# coincidence in f32 on one side and not on the other (a first run met 56
# of 18M d stack values off by up to 0.141 on the seeded inputs): their
# cotangent is zeroed where a selected rank that reads other taps than the
# extreme's lies within NEAR_TIE_RTOL of it, equal or not; repeated ranks'
# exact ties keep theirs.
NEAR_TIE_RTOL = 1e-4
# B8's backward in f32 (phase 3): a d stack entry sums ~300 tap-weighted
# contributions of up to ~2 (the max's and min's cotangents go whole to one
# rank, the mean's spread over the ranks), in K3's fixed order and in the
# plain version's index_add_ (atomic on the card, its order changing from
# run to run); two orders differ by up to ~2e-4 there. The tolerance of the
# backward kernels' f32 tests (tests/test_torch_kernels.py BWD_TOLERANCES,
# measured 7e-4 on their inputs).
B8_BWD_F32_TOL = (2e-3, 1e-5)
# B4 against its plain version (and the RANSAC reference, card against
# CPU): each (pose, point) term is computed alike, operation by operation,
# and the sum over the points (4,652 at the eval shape, of terms up to
# ~1.6e-3 there) runs in another order: (atol, rtol). The argmax over 20,000
# such sums can flip between two scores closer than that: best_index must
# match except where the other side's score at the chosen index is within
# the tolerance of its maximum (such cases are counted and printed).
POSE_SCORE_TOL = (1e-5, 1e-4)
# The RANSAC reference's card and CPU planes differ by summation order
# (cuDNN, cuBLAS) before the scores: scores to (atol, rtol), the refined
# pose to POSE_ATOL (m and rad).
RANSAC_SCORE_TOL = (1e-4, 1e-4)
POSE_ATOL = 1e-4
# The plain scorer's chunk of poses on the card: [B, chunk, N] temporaries.
PLAIN_POSE_CHUNK = 512
# f32 operations per (pose, valid point) of B4: the transform (4 mul, 4 add,
# 2 div), bounds (4 cmp), clamp and floor (2 sub, 4 min/max, 2 floor),
# upper and frac (2 min, 2 add, 2 sub), weights (2 sub), four taps (8 mul,
# 3 add) and the sum (1 add).
POSE_OPS_PER_PAIR = 42
# B7 per (pose, valid point): B4's first 30 (the transform, bounds, clamp,
# floor, upper, frac and weights), the four tap weights (4 mul), each
# times the cotangent (4 mul) and added into the point's map (4 add).
POSE_BWD_OPS_PER_PAIR = 42
# B7's seeded inputs hold a run of identical poses (example 0); alone, its
# taps' sums are R equal values v added in any order, which is one
# sequence of partial sums: the kernel must equal the plain version to the
# bit there and lie within R ulps of the closed form R v.
IDENTICAL_RUN = slice(6000, 8000)
TRAIN_LOSS_RTOL = 1e-4
TRAIN_GRAD_RTOL = 1e-2
TRAIN_GRAD_NORM_RTOL = 1e-2
# The training reference's replay of the card's max choices (MaxChoices)
# takes only near ties: at every output whose choice it changes, the CPU's
# own max and its value at the card's choice (for a relu, x and 0) must lie
# within CHOICE_GAP_RTOL of the site's largest magnitude, and a step may
# change at most MAX_FLIPS_PER_STEP outputs of one site (ten sound runs
# changed 0-4 relu outputs of 4.27M, 1-2 root-pool outputs and 6-24
# vertical-pooling ones a step). A fault that moves values further, or
# flips more, fails the check instead of being replayed.
CHOICE_GAP_RTOL = 1e-4
MAX_FLIPS_PER_STEP = 100
# The training reference in f16 (phase 5g): cuDNN's f16 convolutions on the
# card and oneDNN's on the CPU round at other places, 2^-11 relative each
# time. A first run measured the losses 9e-6 apart (relative), the worst
# gradient leaf 6.4e-3 of its largest entry and 4.6e-3 of its norm, and at
# most 303 flipped relu outputs of 4.27M a step, each within 5.1e-4 of a
# tie: the loss to 1e-3 relative, each leaf to 0.05 of its largest entry
# and of its norm, a replayed choice within two f16 roundings (2^-10) of a
# tie, and at most 2,000 flipped outputs a site a step. The is_finite flags
# and the loss scale's sequence are equal.
F16_TRAIN_TOL = dict(loss_rtol=1e-3, grad_rtol=0.05, grad_norm_rtol=0.05,
                     gap_rtol=2.0**-10, max_flips=2_000)

STREET_ROOT = 'bev_mapper.streetview_encoder.image_encoder.encoder.root_block.conv_root.weight'
PROJ_MLP = 'bev_mapper.streetview_encoder.proj_mlp.Dense_0.weight'
AERIAL_TRUNK = 'bev_mapper.aerial_encoder.encoder.'
SEMANTIC_TRUNK = 'bev_mapper.semantic_encoder.encoder.encoder.'
# The map's raster modalities: the row of the modality keep and the trunk.
RASTER_TRUNKS = {'aerial': (1, AERIAL_TRUNK), 'semantic': (2, SEMANTIC_TRUNK)}
THREE_MODALITIES = 'streetview+aerial+semantic'


def log(msg: str) -> None:
  print(f'[{time.perf_counter() - T0:7.1f}s] {msg}', flush=True)


def assert_close(name: str, got: torch.Tensor, want: torch.Tensor,
                 tol=None) -> float:
  atol, rtol = tol or TOLERANCES[want.dtype]
  got, want = got.float(), want.float()
  err = (got - want).abs()
  bad = err > atol + rtol * want.abs()
  if bad.any() or not torch.isfinite(got).all():
    raise AssertionError(
        f'{name}: {int(bad.sum())} of {got.numel()} values off, max abs err '
        f'{float(err.max()):.3g} (atol {atol}, rtol {rtol})')
  return float(err.max())


def plain_lift(args, kwargs, chunk: int = None):
  """K1's plain version, ``chunk`` points at a time (each point's stats are
  its own): its f32 transients for every rank at once would not fit at the
  scan form's K = 20."""
  stack, *per_point = args
  n = per_point[0].shape[1]
  parts = [view_scan.lift_topk_plain(
      stack, *(t[:, lo:lo + (chunk or n)] for t in per_point), **kwargs)
           for lo in range(0, n, chunk or n)]
  return (torch.cat([p[0] for p in parts], 1),
          torch.cat([p[1] for p in parts], 1))


def plain_lift_bwd(args, kwargs, chunk: int = None):
  """K3's plain version, ``chunk`` points at a time: the points'
  contributions to ``d stack`` summed in f32 (the plain version of an f32
  copy of the stack, the same f32 arithmetic), cast once. The wrapper's
  count of selected ranks, which the plain version does not take, is
  dropped from ``kwargs``."""
  kwargs = {k: v for k, v in kwargs.items() if k != 'selected'}
  stack, *per_point = args
  n = per_point[0].shape[1]
  if not chunk or chunk >= n:
    return view_scan.lift_topk_bwd_plain(*args, **kwargs)
  stack32 = stack.float()
  grad = sum(view_scan.lift_topk_bwd_plain(
      stack32, *(t[:, lo:lo + chunk] for t in per_point), **kwargs)
             for lo in range(0, n, chunk))
  return grad.to(stack.dtype)


def check_lift(args, kwargs, chunk: int = None) -> float:
  """K1 against its plain version on the same CUDA inputs; max abs error."""
  stats, valid = kernels.lift_topk_fwd(*args, **kwargs)
  stats_p, valid_p = plain_lift(args, kwargs, chunk)
  torch.cuda.synchronize()
  if not torch.equal(valid, valid_p):
    raise AssertionError('lift_topk_fwd: valid differs from the plain version')
  return assert_close('lift_topk_fwd stats', stats, stats_p)


def check_sample(args, kwargs) -> float:
  """K2 against its plain version on the same CUDA inputs; max abs error."""
  values, ok = kernels.patch_sample_2d(*args, **kwargs)
  values_p, ok_p = view_scan.patch_sample_2d_plain(*args, **kwargs)
  torch.cuda.synchronize()
  if not torch.equal(ok, ok_p):
    raise AssertionError('patch_sample_2d: valid differs from the plain one')
  return assert_close('patch_sample_2d values', values, values_p)


def unit_cotangent(g: torch.Tensor) -> torch.Tensor:
  """``g`` times the power of two that brings its largest entry into
  [1, 2): exact in f32 and bf16 alike."""
  peak = float(g.abs().max())
  if not 0 < peak < math.inf:
    raise AssertionError(f'cotangent with largest entry {peak}')
  return g * 2.0**-math.floor(math.log2(peak))


def assert_close_bwd(name: str, got: torch.Tensor, want: torch.Tensor,
                     tol=None) -> float:
  """``assert_close``, and the gradient must stand well above atol."""
  atol = (tol or TOLERANCES[want.dtype])[0]
  peak = float(want.abs().max())
  if not peak > 10 * atol:
    raise AssertionError(f'{name}: largest entry {peak:.3g} is within 10x '
                         f'of atol {atol}; the check would be vacuous')
  return assert_close(name, got, want, tol)


def lift_layout(stack: torch.Tensor, kwargs) -> str:
  """The statistics layout of a lift call, as the names of its row."""
  names = ['mean']
  if kwargs.get('use_variance', True):
    names.append('var')
  if kwargs.get('add_minmax', False):
    names += ['max', 'min']
  if stack.shape[-1] > kwargs['dim']:
    names.append('score_max')
  return f'[{", ".join(names)}]'


def without_near_ties(args, kwargs, chunk: int = 131_072):
  """``args`` with the cotangents of the lift's maxima zeroed where K3 and
  its plain version may route them to different ranks (see NEAR_TIE_RTOL),
  and the count of entries zeroed: g_m at points whose two largest
  selected scores differ by a non-zero amount within NEAR_TIE_RTOL of
  their size (weighted layouts); with ``add_minmax``, g_max (g_min) of a
  channel whose largest (smallest) selected value has another selected
  value of a rank that reads other taps within NEAR_TIE_RTOL of it, equal
  or not. Exact ties of repeated ranks keep theirs. The ranks are formed
  ``chunk`` points at a time."""
  stack, view_idx, p2d, select, depth, g_stats = args
  dim = kwargs['dim']
  weighted = stack.shape[-1] > dim
  add_minmax = kwargs.get('add_minmax', False)
  if not add_minmax and not (weighted and view_idx.shape[-1] >= 2):
    return args, 0
  lift_kw = {k: kwargs[k] for k in ('h', 'w', 'dim', 'depth_min_max')}
  at_max = dim * (1 + kwargs.get('use_variance', True))
  last = torch.tensor([kwargs['h'] - 1, kwargs['w'] - 1], dtype=p2d.dtype,
                      device=p2d.device)
  g_stats, zeroed = g_stats.clone(), 0
  for lo in range(0, view_idx.shape[1], chunk):
    part = slice(lo, lo + chunk)
    ranks = view_scan._lift_ranks(stack, view_idx[:, part], p2d[:, part],
                                  select[:, part], depth[:, part], **lift_kw)
    if weighted and len(ranks) >= 2:
      top = torch.stack([r.score for r in ranks], -1).topk(2, -1).values
      gap = top[..., 0] - top[..., 1]
      near = ((top[..., 1] > view_scan.NEG_INF / 2) & (gap > 0)
              & (gap <= NEAR_TIE_RTOL * top[..., 0].abs().clamp(min=1.0)))
      g_stats[:, part, -1] = torch.where(near, 0.0, g_stats[:, part, -1])
      zeroed += int(near.sum())
    if add_minmax:
      sel = select[:, part, :, None]
      f = torch.stack([r.f[..., :dim] for r in ranks], 2)  # [B, n, K, D]
      del ranks
      vi = view_idx[:, part]
      pts = torch.minimum(torch.clamp(p2d[:, part] - 0.5, min=0), last)
      # [B, n, K, K]: two ranks read the same taps with the same weights.
      same = (vi[..., :, None] == vi[..., None, :]) & (
          pts[..., :, None, :] == pts[..., None, :, :]).all(-1)
      for at, sign in ((at_max, 1.0), (at_max + dim, -1.0)):
        v = torch.where(sel, sign * f, -torch.inf)
        top, first = v.max(2)  # [B, n, D]: the extreme and a rank of it
        same_taps = torch.gather(
            same, 3, first[:, :, None, :].expand(-1, -1, v.shape[2], -1))
        near = ((top[:, :, None] - v <= NEAR_TIE_RTOL * top.abs().clamp(
            min=1.0)[:, :, None]) & ~same_taps).any(2)
        g = g_stats[:, part, at:at + dim]
        g_stats[:, part, at:at + dim] = torch.where(near, 0.0, g)
        zeroed += int(near.sum())
  return (*args[:-1], g_stats), zeroed


def check_lift_bwd(args, kwargs, chunk: int = None, tol=None) -> float:
  """K3 against its plain version; ``args`` end with ``g_stats``, which is
  scaled by ``unit_cotangent`` and freed of near ties first."""
  args = (*args[:-1], unit_cotangent(args[-1]))
  args, near = without_near_ties(args, kwargs)
  got = kernels.lift_topk_bwd(*args, **kwargs)
  want = plain_lift_bwd(args, kwargs, chunk)
  torch.cuda.synchronize()
  log(f'lift_topk_bwd at {tuple(args[0].shape)} '
      f'{lift_layout(args[0], kwargs)}: '
      f'{near} cotangent entries of maxima zeroed (near ties) of '
      f'{args[1].shape[0] * args[1].shape[1]} points')
  return assert_close_bwd('lift_topk_bwd d_stack', got, want, tol)


def check_sample_bwd(args, kwargs) -> float:
  """K4 against its plain version; ``args`` = (g_values, points), and
  ``g_values`` is scaled by ``unit_cotangent`` first."""
  args = (unit_cotangent(args[0]), *args[1:])
  got = kernels.patch_sample_2d_bwd(*args, **kwargs)
  want = view_scan.patch_sample_2d_bwd_plain(*args, **kwargs)
  torch.cuda.synchronize()
  if got[..., args[0].shape[-1]:].any():
    raise AssertionError('patch_sample_2d_bwd wrote the validity channel')
  return assert_close_bwd('patch_sample_2d_bwd d_padded', got, want)


def check_non_finite(lift_bwd, sample_bwd) -> dict:
  """K3 and K4 with an infinite entry in the cotangent (a mean channel of a
  point with a selected rank; a channel of a point): the gradient is
  non-finite at the plain version's non-finite entries and nowhere else
  (nothing clamps or masks it, so that a loss scale sees the overflow), and
  the finite entries agree. Returns the non-finite entries of each."""
  counts = {}
  (args, kw) = lift_bwd
  g = unit_cotangent(args[-1])
  point = int(args[3][0].any(-1).nonzero()[0])
  g[0, point, 3] = math.inf
  args, _ = without_near_ties((*args[:-1], g), kw)
  got = kernels.lift_topk_bwd(*args, **kw)
  want = plain_lift_bwd(args, kw)
  (g_values, points), skw = sample_bwd
  g_values = unit_cotangent(g_values)
  g_values[0, 7, 3] = math.inf
  got_s = kernels.patch_sample_2d_bwd(g_values, points, **skw)
  want_s = view_scan.patch_sample_2d_bwd_plain(g_values, points, **skw)
  torch.cuda.synchronize()
  for name, a, b in (('lift_topk_bwd', got, want),
                     ('patch_sample_2d_bwd', got_s, want_s)):
    fin = torch.isfinite(b)
    if fin.all() or not torch.equal(torch.isfinite(a), fin):
      raise AssertionError(f'{name}: non-finite entries {int((~fin).sum())} '
                           f'in the plain version, '
                           f'{int((~torch.isfinite(a)).sum())} in the '
                           f'kernel\'s, at other entries')
    assert_close(f'{name} (finite entries)', a[fin], b[fin])
    counts[name] = int((~fin).sum())
  return counts


def seeded_kernel_inputs(device: str, dtype: torch.dtype = torch.bfloat16):
  """K1-K4 inputs at the flagship shapes and the training batch of 2 in
  ``dtype``, from a seeded generator."""
  g = torch.Generator(device=device).manual_seed(0)
  b, v, h, w, c, dim, n, k = 2, 20, 45, 60, 160, 128, 1_152_000, 4
  stack = torch.randn((b, v * (h + 1), w + 1, c), generator=g, device=device
                      ).to(dtype)
  view_idx = torch.randint(0, v, (b, n, k), generator=g, device=device,
                           dtype=torch.int32)
  scale = torch.tensor([h, w], dtype=torch.float32, device=device)
  p2d = torch.rand((b, n, k, 2), generator=g, device=device) * (scale + 2) - 1
  select = torch.rand((b, n, k), generator=g, device=device) < 0.7
  select[:, :100_000] = False  # single-view points: one selected rank
  select[:, :100_000, 1] = True
  select[:, 100_000:150_000] = False  # invalid points
  depth = torch.rand((b, n, k), generator=g, device=device) * 40
  tie = slice(150_000, 200_000)  # exact score ties: rank 2 repeats rank 0
  for t in (view_idx, p2d, depth):
    t[:, tie, 2] = t[:, tie, 0]
  select[:, tie, 0] = select[:, tie, 2] = True
  lift_kw = dict(h=h, w=w, dim=dim, depth_min_max=(1.0, 32.0))
  lift = ((stack, view_idx, p2d, select, depth), lift_kw)
  g_stats = torch.randn((b, n, 2 * dim + 1), generator=g, device=device
                        ).to(dtype)
  lift_bwd = ((stack, view_idx, p2d, select, depth, g_stats), lift_kw)
  hq, wq, d, p = 120, 80, 32, 64 * 120 * 80
  plane = torch.randn((b, hq + 1, wq + 1, d + 1), generator=g, device=device)
  plane[..., d] = (plane[..., d] > -1.0).float()
  pts_scale = torch.tensor([hq, wq], dtype=torch.float32, device=device)
  points = torch.rand((b, p, 2), generator=g, device=device) * (
      pts_scale + 4) - 2
  sample = ((plane.to(dtype), points), dict(dim=d, has_valid=True))
  g_values = torch.randn((b, p, d), generator=g, device=device).to(dtype)
  sample_bwd = ((g_values, points), dict(plane_shape=tuple(plane.shape)))
  return lift, sample, lift_bwd, sample_bwd


# B8 on seeded inputs (phase 3): (name, weighted, use_variance, add_minmax,
# ranks, points an example); the scan form's K = 20 at a cut of the points.
B8_SEEDED = (
    ('weighted [mean, var, max, min, score_max]', True, True, True, 4,
     1_152_000),
    ('unweighted [mean, var]', False, True, False, 4, 1_152_000),
    ('unweighted [mean, max, min]', False, False, True, 4, 1_152_000),
    ('the scan form, K = 20, unweighted [mean, var]', False, True, False, 20,
     262_144),
)
# Points per call of the lift's plain versions on B8's inputs: at K = 20
# their f32 transients for every rank of every point would not fit at once.
PLAIN_LIFT_CHUNK = 262_144


def seeded_lift_inputs(device: str, dtype: torch.dtype, weighted: bool,
                       use_variance: bool, add_minmax: bool, ranks: int,
                       n: int):
  """K1/K3 inputs of a B8 layout at the flagship's image stack (20 views of
  45 x 60 pixels, 128 features, 32 score bins when weighted), batch 2, n
  points an example: n / 12 single-view points, n / 24 more with no
  selected rank, and n / 24 whose second half of ranks repeats the first,
  all selected (exact ties of every channel and score); the rest select
  ~3.5 ranks a point. Returns (args, g_stats, kwargs)."""
  g = torch.Generator(device=device).manual_seed(1)
  b, v, h, w, dim = 2, 20, 45, 60, 128
  c = dim + (32 if weighted else 0)
  stack = torch.randn((b, v * (h + 1), w + 1, c), generator=g,
                      device=device).to(dtype)
  view_idx = torch.randint(0, v, (b, n, ranks), generator=g, device=device,
                           dtype=torch.int32)
  scale = torch.tensor([h, w], dtype=torch.float32, device=device)
  p2d = torch.rand((b, n, ranks, 2), generator=g, device=device) * (
      scale + 2) - 1
  select = torch.rand((b, n, ranks), generator=g, device=device) < (
      min(0.7, 3.5 / ranks))
  single, invalid, tie = n // 12, n // 8, slice(n // 8, n // 6)
  select[:, :invalid] = False
  select[:, :single, 1] = True
  depth = torch.rand((b, n, ranks), generator=g, device=device) * 40
  half = ranks // 2
  for t in (view_idx, p2d, depth):
    t[:, tie, half:2 * half] = t[:, tie, :half]
  select[:, tie] = True
  width = kernels.stats_width(dim, weighted, use_variance, add_minmax)
  g_stats = torch.randn((b, n, width), generator=g, device=device).to(dtype)
  kwargs = dict(h=h, w=w, dim=dim, depth_min_max=(1.0, 32.0),
                use_variance=use_variance, add_minmax=add_minmax)
  return (stack, view_idx, p2d, select, depth), g_stats, kwargs


def b8_seeded() -> None:
  """Phase 3, B8: K1 and K3 in the layouts of B8_SEEDED against their plain
  versions, f32, bf16 and f16, forward and backward; the resources of the
  bf16 and f16 instantiations of each."""
  errs, times = {}, {}
  for name, weighted, use_variance, add_minmax, ranks, n in B8_SEEDED:
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
      args, g_stats, kw = seeded_lift_inputs('cuda', dtype, weighted,
                                             use_variance, add_minmax, ranks,
                                             n)
      errs[f'{name}, {str(dtype)[6:]}'] = (
          check_lift(args, kw, PLAIN_LIFT_CHUNK),
          check_lift_bwd((*args, g_stats), kw, PLAIN_LIFT_CHUNK,
                         B8_BWD_F32_TOL if dtype == torch.float32 else None))
      if dtype != torch.float32:
        kernels.lift_topk_fwd(*args, **kw)
        for kernel in ('lift_topk_fwd', 'lift_topk_bwd'):
          log_occupancy(kernel, f'phase 3 {name}, {str(dtype)[6:]}')
      if dtype != torch.float32:
        call = lift_bwd_call((*args, g_stats), kw)
        times[f'{name}, {str(dtype)[6:]}'] = dict(
            ms=time_ms(call), selected=int(args[3].sum()),
            stages=kernel_stages_ms(call, K3_STAGES))
      del args, g_stats
  log(f'B8 (K1, K3 in the other layouts) on seeded inputs, batch 2: max abs '
      f'err (forward, backward) {errs}; lift_topk_bwd in bf16 and f16, ms '
      f'per call and (device ms per call, launches kept) per stage {times}')


# Cycles the card spins (torch.cuda._sleep) before a run of time_ms(...,
# spin=True): ~4 ms at the H100's clocks, longer than the host takes to
# queue 20 launches of any wrapper, so that the events time the card's work
# back to back and not the host's launch overhead.
SPIN_CYCLES = 7_000_000


def time_ms(fn, iters: int = 20, spin: bool = False) -> float:
  """Mean CUDA-event time of ``fn()`` over ``iters`` launches, after warmup;
  with ``spin``, the launches queued behind a spin of the card."""
  fn()
  torch.cuda.synchronize()
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  if spin:
    torch.cuda._sleep(SPIN_CYCLES)
  start.record()
  for _ in range(iters):
    fn()
  end.record()
  torch.cuda.synchronize()
  return start.elapsed_time(end) / iters


def lift_bwd_bin_counts(view_idx: torch.Tensor, p2d: torch.Tensor,
                        select: torch.Tensor, *, views: int, h: int,
                        w: int) -> torch.Tensor:
  """K3's bins: the selected ranks whose lower tap (clamped as the lift
  clamps it) lies on each pixel of each view, ``[B, views, h, w]`` int64."""
  b = view_idx.shape[0]
  li = torch.clamp(p2d[..., 0] - 0.5, 0, h - 1).floor().long()
  lj = torch.clamp(p2d[..., 1] - 0.5, 0, w - 1).floor().long()
  example = torch.arange(b, device=p2d.device)[:, None, None]
  bins = ((example * views + view_idx.long()) * h + li) * w + lj
  counts = torch.bincount(bins[select], minlength=b * views * h * w)
  return counts.reshape(b, views, h, w)


def sample_bwd_bin_counts(points: torch.Tensor, plane_shape) -> torch.Tensor:
  """K4's bins: the points whose lower tap (clamped as K2 clamps it) lies on
  each cell of each example, ``[B, H, W]`` int64 for a plane of
  ``plane_shape`` = ``[B, H + 1, W + 1, C]``."""
  b, hp, wp, _ = plane_shape
  h, w = hp - 1, wp - 1
  li = torch.clamp(points[..., 0] - 0.5, 0, h - 1).floor().long()
  lj = torch.clamp(points[..., 1] - 0.5, 0, w - 1).floor().long()
  example = torch.arange(b, device=points.device)[:, None]
  bins = (example * h + li) * w + lj
  return torch.bincount(bins.reshape(-1), minlength=b * h * w).reshape(b, h, w)


def kernel_stages_ms(fn, names, iters: int = 5):
  """Device ms per call of each CUDA kernel named in ``names`` that ``fn``
  launches (each at most once a call), beside the launches of it that the
  trace kept, and of all the others together (``torch.profiler``, over
  ``iters`` calls after a warm one; each sum divided by ``iters``).
  ``complete`` is False where the trace kept no launch at all, or fewer
  than ``iters`` of a named kernel that it kept any of: late in a long
  process it has dropped some, and such a split is not to be read."""
  fn()
  torch.cuda.synchronize()
  with torch.profiler.profile(
      activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
    for _ in range(iters):
      fn()
    torch.cuda.synchronize()
  stages = {name: [0.0, 0] for name in names}
  other = 0.0
  for evt in prof.key_averages():
    us = evt.self_device_time_total
    if us <= 0:
      continue
    name = next((n for n in names if n in evt.key), None)
    if name is None:
      other += us / 1e3
    else:
      stages[name][0] += us / 1e3
      stages[name][1] += evt.count
  kept = [count for _, count in stages.values() if count]
  return {name: (ms / iters, count) for name, (ms, count) in stages.items()
          } | {'other': other / iters,
               'complete': bool(kept) and all(c == iters for c in kept)}


# K3's launch stages, as torch.profiler names them (the wide one first: the
# narrow one's name is in its name).
K3_STAGES = ('count_kernel', 'scan_kernel', 'keys_kernel',
             'order_bins_kernel', 'wide_ranks_kernel', 'ranks_kernel',
             'runs_kernel', 'fold_kernel')
K4_STAGES = ('bin_points_kernel', 'scan_kernel', 'keys_kernel',
             'order_bins_kernel', 'place_points_kernel', 'sum_runs_kernel',
             'fold_kernel')


def lift_bwd_call(args, kwargs):
  """K3 on ``args`` as the autograd function calls it: its count of
  selected ranks counted once here and passed, so that a timed call does
  not wait for the card."""
  kwargs = dict(kwargs, selected=int(args[3].sum()))
  return lambda: kernels.lift_topk_bwd(*args, **kwargs)


# Bounds: the larger of the bytes moved over the HBM rate and the f32
# operations over the f32 peak (bench_gather's H100 figures).
_nbytes = bench_gather.nbytes
_bound = bench_gather.bound


def lift_bound(args, kwargs, stats, valid):
  """(bound_ms, bound_by): bytes moved vs f32 operations this input needs;
  the unweighted layouts (no score bins) need no depth."""
  stack, _, _, select, _ = args
  c, dim = stack.shape[-1], kwargs['dim']
  var, minmax = kwargs.get('use_variance', True), kwargs.get('add_minmax',
                                                             False)
  nbytes = _nbytes(*(args if c > dim else args[:4]), stats, valid)
  # Per selected rank: 4-tap combine (8C), depth hat (4S), online-softmax
  # update (5D; 3D without the variance), the max and min (2D); per point:
  # the epilogue (2D for the mean, 3D more for the variance).
  ops = int(select.sum()) * (8 * c + 4 * (c - dim) + (3 + 2 * var) * dim
                             + 2 * minmax * dim) + (
      select.shape[0] * select.shape[1] * (2 + 3 * var) * dim)
  return _bound(nbytes, ops)


def lift_bwd_bound(args, kwargs, d_stack):
  """K3: its inputs read once, ``d stack`` written once; f32 operations."""
  stack, _, _, select, _, _ = args
  c, dim = stack.shape[-1], kwargs['dim']
  var, minmax = kwargs.get('use_variance', True), kwargs.get('add_minmax',
                                                             False)
  nbytes = _nbytes(*args, d_stack)
  # Per selected rank: the 4-tap combine of f and c (8C) and the depth hat
  # (4S), d f and u (8D; 3D without the variance), the max's and min's
  # shares (2D), d z and d c (2S), and w_tap * [d f, d c] added at 4 taps
  # (8C); per point: the (mean, E2) gradients (10D; 2D without the
  # variance). K3's recompute of the online-softmax update is a cost of its
  # design, not counted.
  s = c - dim
  ops = int(select.sum()) * (16 * c + 6 * s + (3 + 5 * var) * dim
                             + 2 * minmax * dim) + (
      select.shape[0] * select.shape[1] * (2 + 8 * var) * dim)
  return _bound(nbytes, ops)


def sample_bound(args, kwargs, values, valid):
  padded, points = args
  nbytes = _nbytes(padded, points, values, valid)
  ops = points.shape[0] * points.shape[1] * (8 * kwargs['dim'] + 40)
  return _bound(nbytes, ops)


def sample_bwd_bound(args, kwargs, d_padded):
  g_values, points = args
  nbytes = _nbytes(g_values, points, d_padded)
  ops = g_values.shape[0] * g_values.shape[1] * (8 * g_values.shape[2] + 30)
  return _bound(nbytes, ops)


def _grid_sample_args(padded: torch.Tensor, points: torch.Tensor):
  """The plane as ``[B, D, H, W]`` and ``(x, y)`` in [-1, 1] for grid_sample."""
  dim = padded.shape[-1] - 1
  plane = padded[:, :-1, :-1, :dim].permute(0, 3, 1, 2).contiguous()
  h, w = plane.shape[-2:]
  size = torch.tensor([h, w], dtype=torch.float32, device=points.device)
  # grid_sample takes the grid in the plane's dtype.
  norm = (points / size * 2 - 1).flip(-1)[:, None].to(plane.dtype)
  return plane, norm


def grid_sample_call(padded: torch.Tensor, points: torch.Tensor):
  """``F.grid_sample`` over the same plane and points (values only)."""
  plane, norm = _grid_sample_args(padded, points)
  return lambda: F.grid_sample(plane, norm, mode='bilinear',
                               padding_mode='border', align_corners=False)


def grid_sample_bwd_call(g_values: torch.Tensor, points: torch.Tensor,
                         plane_shape):
  """``grid_sampler_2d_backward``'s input gradient for the same cotangent."""
  b, hp, wp, c = plane_shape
  padded = torch.zeros(plane_shape, dtype=g_values.dtype,
                       device=g_values.device)
  plane, norm = _grid_sample_args(padded, points)
  grad_out = g_values.permute(0, 2, 1)[:, :, None].contiguous()
  return lambda: torch.ops.aten.grid_sampler_2d_backward(
      grad_out, plane, norm, 0, 1, False, [True, False])


def pose_scoring_bwd_library_call(args, kwargs):
  """``grid_sampler_2d_backward``'s input gradient for B7's function: per
  (example, point) a one-channel H x W map read bilinearly at the point's
  P transformed positions, border padding (the clamp of ``uv - 0.5`` and
  the zero-weight upper tap at the border are B4's), cotangent
  ``g * keep``. The grid and the cotangent are built here, outside the
  returned call."""
  g, angle, t, xy, valid_points, valid_map = args
  b, n, h, w = kwargs['sim_shape']
  cell = kwargs['cell_size']
  cos, sin = torch.cos(angle)[..., None], torch.sin(angle)[..., None]
  x, y = xy[:, None, :, 0], xy[:, None, :, 1]  # [B, 1, N]
  u = (t[..., 0, None] + cos * x - sin * y) / cell  # [B, P, N]
  v = (t[..., 1, None] + sin * x + cos * y) / cell
  keep = valid_points[:, None, :]
  if kwargs['mask_out_of_bounds']:
    keep = keep & pose_estimation._pose_taps(
        angle, t, xy, valid_map, h, w, cell, True)[1]
  grad_out = (g[..., None] * keep).permute(0, 2, 1).reshape(b * n, 1, 1, -1)
  # align_corners=False reads at ((x + 1) W - 1) / 2 = v - 0.5.
  grid = torch.stack((v * (2 / w) - 1, u * (2 / h) - 1), -1)
  grid = grid.permute(0, 2, 1, 3).reshape(b * n, 1, -1, 2).contiguous()
  del u, v, keep
  grad_out = grad_out.contiguous()
  plane = torch.zeros((b * n, 1, h, w), dtype=g.dtype, device=g.device)
  return lambda: torch.ops.aten.grid_sampler_2d_backward(
      grad_out, plane, grid, 0, 1, False, [True, False])[0]


class Capture:
  """Keeps the first inputs of each shape that a kernel wrapper is given."""

  def __init__(self, module, name: str, key_arg: int):
    self.module, self.name, self.key_arg = module, name, key_arg
    self.wrapped = getattr(module, name)
    self.calls = {}

  def __enter__(self):
    def capture(*args, **kwargs):
      kept = tuple(a.detach() if isinstance(a, torch.Tensor) else a
                   for a in args)
      self.calls.setdefault(tuple(args[self.key_arg].shape), (kept, kwargs))
      return self.wrapped(*args, **kwargs)
    setattr(self.module, self.name, capture)
    return self

  def __exit__(self, *exc):
    setattr(self.module, self.name, self.wrapped)

  def largest(self):
    return self.calls[max(self.calls, key=lambda s: math.prod(s))]


def serving_reference() -> None:
  """The tiny localizer on the card (kernels) against the CPU (plain), both
  on the host generator's batch."""
  ref = {dev: evaluate.evaluate('smoke_exhaustive', 2, dev, seed=0,
                                batch_size=2, on_device_generation=False
                                )['last_pred']
         for dev in ('cpu', 'cuda')}
  cpu_idx = ref['cpu']['best_volume_index']
  gpu_idx = ref['cuda']['best_volume_index'].cpu()
  if not torch.equal(cpu_idx, gpu_idx):
    raise AssertionError(f'best_volume_index cpu {cpu_idx} vs card {gpu_idx}')
  dt = (ref['cpu']['map_t_query'].t - ref['cuda']['map_t_query'].t.cpu())
  if float(dt.abs().max()) > 1e-3:
    raise AssertionError(f'refined translation differs by {dt}')
  log(f'serving reference (smoke_exhaustive, f32): best_volume_index '
      f'{cpu_idx.tolist()} equal on card and CPU')


class _PoolAt(torch.autograd.Function):
  """The 3x3, stride-2, padding-1 max pool of ``x [B, C, H, W]`` read at
  given argmax ``indices`` (as ``F.max_pool2d`` returns them): the input's
  values there, laid out as ``like`` (the pool's own output: the layers
  after it sum in an order that follows the layout), and ``max_pool2d``'s
  own backward with those indices."""

  @staticmethod
  def forward(ctx, x, indices, like):
    ctx.save_for_backward(x, indices)
    flat = x.reshape(*x.shape[:2], -1)
    values = flat.gather(2, indices.reshape(*indices.shape[:2], -1))
    return torch.empty_like(like).copy_(values.reshape(indices.shape))

  @staticmethod
  def backward(ctx, g):
    x, indices = ctx.saved_tensors
    return torch.ops.aten.max_pool2d_with_indices_backward(
        g, x, [3, 3], [2, 2], [1, 1], [1, 1], False, indices), None, None


def _tie_gap(gaps: torch.Tensor, flipped: torch.Tensor,
             values: torch.Tensor) -> float:
  """The largest of ``gaps`` where ``flipped``, relative to the largest
  finite magnitude of ``values``; 0 where nothing flipped."""
  if not bool(flipped.any()):
    return 0.0
  finite = values[torch.isfinite(values)].abs()
  scale = float(finite.max()) if finite.numel() else 0.0
  return float(gaps[flipped].max()) / max(scale, 1e-30)


def flips_per_site(flips, most: int = MAX_FLIPS_PER_STEP):
  """``MaxChoices.flips`` of one step summed per site: name -> [outputs
  flipped, outputs, largest gap]; raises where a site flipped more than
  ``most`` outputs."""
  per_site = {}
  for name, n, total, gap in flips:
    count = per_site.setdefault(name, [0, 0, 0.0])
    count[0] += n
    count[1] += total
    count[2] = max(count[2], gap)
  for name, (n, total, _) in per_site.items():
    if n > most:
      raise AssertionError(f'{name}: {n} of {total} max choices flipped in a '
                           f'step (limit {most})')
  return per_site


class MaxChoices:
  """Records which entries the maxima of a model pick, or makes another
  copy of the model pick recorded ones (ROADMAP C11).

  Sites: every ``VerticalPooling`` in max mode (the street-view volume's
  vertical pooling, the fusion of the map modalities), the 3x3 max pool of
  every ResNet root, and every ``F.relu`` (max(x, 0)). Recording keeps,
  per site call in order, the entries that reach the max: for
  ``VerticalPooling`` a mask over the pooled axis (``amax`` spreads its
  gradient over all of them), for the root pool the indices
  ``max_pool2d`` returns, for a relu the mask x > 0. Replaying recomputes
  each site's output from its own inputs at the recorded entries, so the
  values stay this model's and the gradient takes the recorded path;
  replaying a model's own choices leaves its outputs and gradients as they
  were (bit for bit). ``flips`` holds, per site call, the site's name, the
  outputs whose own choice differs from the recorded one and all its
  outputs, and the largest gap between this copy's own max and its value
  at a recorded choice, relative to the site's largest magnitude; a gap
  over ``gap_rtol`` (a choice that is no near tie) raises. A context
  manager: the hooks, and ``F.relu``'s stand-in, go on exit.
  """

  def __init__(self, model: torch.nn.Module, replay=None,
               gap_rtol: float = CHOICE_GAP_RTOL):
    self.calls, self.flips, self.replay = [], [], replay
    self.gap_rtol = gap_rtol
    self.sites = []  # the site of each recorded call
    self._stashed = {}
    self._handles = []
    for name, module in model.named_modules():
      if isinstance(module, bev_mapper.VerticalPooling) and (
          module.mode == 'max'):
        self._handles.append(
            module.register_forward_hook(self._pooling_hook(name)))
      elif isinstance(module, resnet.RootBlock):
        self._handles.append(module.conv_root.register_forward_hook(
            self._stash_hook(name)))
        self._handles.append(
            module.register_forward_hook(self._root_hook(name)))

  def __enter__(self):
    self._relu = F.relu
    F.relu = self._relu_site
    return self

  def __exit__(self, *exc):
    F.relu = self._relu
    for handle in self._handles:
      handle.remove()
    if exc[0] is None and self.replay is not None and (
        len(self.flips) != len(self.replay)):
      raise AssertionError(f'replayed {len(self.flips)} of '
                           f'{len(self.replay)} recorded max choices')

  def _choose(self, name: str, own: torch.Tensor, flips_of) -> torch.Tensor:
    if self.replay is None:
      self.calls.append(own)
      self.sites.append(name)
      return own
    recorded = self.replay[len(self.flips)].to(own.device)
    if recorded.shape != own.shape:
      raise AssertionError(f'{name}: recorded choice {tuple(recorded.shape)}'
                           f' against {tuple(own.shape)}')
    flips, total, gap = flips_of(own, recorded)
    self.flips.append((name, flips, total, gap))
    if not gap <= self.gap_rtol:
      raise AssertionError(
          f'{name}: a recorded max choice is {gap:.3g} of the site\'s '
          f'largest magnitude from a tie here (limit {self.gap_rtol})')
    return recorded

  def _pooling_hook(self, name: str):
    def hook(module, args, output):
      features, valid = args[0].features, args[0].valid
      has_data = valid.any(-1)
      guard = torch.where(has_data[..., None], valid, True)[..., None]
      masked = torch.where(guard, features, -torch.inf)
      values = masked.detach()
      top = values.amax(-2)
      own = values == top[..., None, :]

      def flips_of(a, b):
        flipped = (a != b).any(-2)
        picked = torch.where(b, values, torch.inf).amin(-2)
        return (int(flipped.sum()), a[..., 0, :].numel(),
                _tie_gap(top - picked, flipped, values))
      chosen = self._choose(name, own, flips_of)
      if self.replay is None:
        return None
      plane = torch.where(chosen, masked, -torch.inf).amax(-2)
      plane = torch.where(has_data[..., None], plane, 0)
      return type(output)(features=plane, valid=output.valid)
    return hook

  def _relu_site(self, x: torch.Tensor, inplace: bool = False):
    values = x.detach()
    own = values > 0
    chosen = self._choose('F.relu', own, lambda a, b: (
        int((a != b).sum()), a.numel(),
        _tie_gap(values.abs(), a != b, values)))
    if self.replay is None:
      return self._relu(x, inplace=inplace)
    return torch.where(chosen, x, 0)

  def _stash_hook(self, name: str):
    def hook(module, args, output):
      self._stashed[name] = output
    return hook

  def _root_hook(self, name: str):
    def hook(module, args, output):
      x = self._stashed.pop(name).permute(0, 3, 1, 2)
      with torch.no_grad():
        pooled, own = F.max_pool2d(x, 3, stride=2, padding=1,
                                   return_indices=True)
      values = x.detach()

      def flips_of(a, b):
        at = values.reshape(*values.shape[:2], -1).gather(
            2, b.reshape(*b.shape[:2], -1)).reshape(b.shape)
        return (int((a != b).sum()), a.numel(),
                _tie_gap(pooled - at, a != b, values))
      chosen = self._choose(name, own, flips_of)
      if self.replay is None:
        return None
      return _PoolAt.apply(x, chosen, pooled).permute(0, 2, 3, 1)
    return hook


def reference_batch(cfg: configs.Config, generator, step: int, device: str):
  """The host generator's training batch ``step`` of ``cfg`` (its mode) on
  ``device``, without the strings."""
  mode = data_types.DataMode(cfg.data.mode or 'pair_scene_view')
  bs = cfg.batch_size
  examples = loader.make_examples(generator, range(step * bs, (step + 1) * bs),
                                  cfg.data, mode)
  examples['batch_mask'] = np.ones(bs, np.float32)
  batch = loader.process_batch(examples, mode, device)
  batch.pop('_host')
  return batch


def training_reference(config_name: str = 'smoke_train_exhaustive',
                       cfg: configs.Config = None, least=(), never=(),
                       zero=(), nonzero=(), shift_free=(), tol=None):
  """2 steps of the tiny trainer ``config_name`` (or ``cfg``) on the card and
  on the CPU in lockstep: each step starts both from the CPU's weights, with
  the same batch and draws (the card's, injected on the CPU; on the RANSAC
  backend also its pose samples, which the two devices' f64 prefix sums may
  round to a neighbouring category), and the CPU's maxima pick the entries
  the card's picked (``MaxChoices``); the loss and every gradient leaf
  agree, and the frozen leaves' gradients are 0 on both. (Comparing after
  separate updates would not work: Adam's first update is ~lr * sign(g), so
  a gradient entry near 0 that differs in sign moves its weight by 2 lr.)
  On the RANSAC backend B4 and B7 launch each card step; each kernel of
  ``least`` launches on each card step, each of ``never`` on none. The
  parameters under each prefix of ``zero`` take a zero gradient on both
  devices, and some parameter under each of ``nonzero`` a non-zero one.
  Each bias of ``shift_free`` adds to every logit of a softmax, which does
  not see the shift: its gradient is 0 but for rounding, so on both
  devices it is held within ``TRAIN_GRAD_RTOL`` of its layer's weight's
  largest gradient entry instead of being compared. In f16 both devices
  train with the loss scale, whose is_finite flags and scales must be
  equal each step, under ``tol`` (F16_TRAIN_TOL).
  Returns per step the worst leaf error relative to its largest entry and
  to its norm, and the flips per max site."""
  cfg = cfg or configs.get_config(config_name)
  tol = tol or dict(loss_rtol=TRAIN_LOSS_RTOL, grad_rtol=TRAIN_GRAD_RTOL,
                    grad_norm_rtol=TRAIN_GRAD_NORM_RTOL,
                    gap_rtol=CHOICE_GAP_RTOL, max_flips=MAX_FLIPS_PER_STEP)
  ransac = getattr(cfg.model, 'pose_backend', None) == 'ransac'
  card_launches = []
  models = {dev: evaluate.build_model(cfg, dev, 0).train()
            for dev in ('cpu', 'cuda')}
  adam = optimizers.get_optimizer(cfg.train, models['cpu'])
  frozen = [n for n, f in zip(dict(models['cpu'].named_parameters()),
                              adam.frozen or []) if f]
  states = {dev: trainer.create_train_state(
      m, adam, seed=0, dynamic_scale=dynamic_scale.for_dtype(cfg.dtype_str))
            for dev, m in models.items()}
  generator = loader.make_generator(cfg.data, 0)
  worst, worst_norm, losses, flips = [0.0, 0.0], [0.0, 0.0], [], []
  scales = []
  worst_leaf = ['', '']
  for i in range(2):
    models['cuda'].load_state_dict(models['cpu'].state_dict())
    before = dict(kernels.LAUNCHES)
    with MaxChoices(models['cuda']) as on_card:
      card = trainer.train_step(states['cuda'],
                                reference_batch(cfg, generator, i, 'cuda'),
                                adam)
    launched = {k: v - before[k] for k, v in kernels.LAUNCHES.items()}
    card_launches.append(launched)
    samples = None
    if ransac:
      least = ('pose_scoring', 'pose_scoring_bwd')
      samples = geometry.Transform2D(angle=card.pose_samples.angle.cpu(),
                                     t=card.pose_samples.t.cpu())
    if (any(launched[k] < 1 for k in least)
        or any(launched[k] for k in never)):
      raise AssertionError(f'step {i}: card step launched {launched}')
    with MaxChoices(models['cpu'], replay=on_card.calls,
                    gap_rtol=tol['gap_rtol']) as replayed:
      cpu = trainer.train_step(states['cpu'],
                               reference_batch(cfg, generator, i, 'cpu'),
                               adam, draws=card.draws, pose_samples=samples)
    scale = [(o.logs['is_finite'], o.logs.get('loss_scale'))
             for o in (cpu, card)]
    scales.append(scale[1])
    if scale[0] != scale[1]:
      raise AssertionError(f'step {i}: (is_finite, loss_scale) cpu '
                           f'{scale[0]} vs card {scale[1]}')
    for name in frozen:
      for out in (cpu, card):
        if out.grads[name].abs().max() > 0:
          raise AssertionError(f'step {i}: frozen {name} has a gradient')
    for prefix in (*zero, *nonzero):
      names = [n for n in cpu.grads if n.startswith(prefix)]
      for out in (cpu, card):
        moved = bool(names) and max(
            float(out.grads[n].abs().max()) for n in names) > 0
        if not names or moved != (prefix in nonzero):
          raise AssertionError(f'step {i}: the gradient under {prefix} '
                               f'({len(names)} leaves) is '
                               f'{"non-zero" if moved else "zero"}')
    flips.append({name: f'{n} of {total}, gap {gap:.3g}' for name, (
        n, total, gap) in flips_per_site(replayed.flips,
                                         tol['max_flips']).items() if n})
    loss = [trainer.summarize([o.metrics])['loss/total'] for o in (cpu, card)]
    losses.append(loss)
    if not math.isclose(loss[0], loss[1], rel_tol=tol['loss_rtol']):
      raise AssertionError(f'step {i}: loss cpu {loss[0]} vs card {loss[1]}')
    for name in shift_free:
      weight = name[:-len('bias')] + 'weight'
      for out in (cpu, card):
        bound = tol['grad_rtol'] * float(out.grads[weight].abs().max())
        if not float(out.grads[name].abs().max()) <= bound:
          raise AssertionError(f'step {i}: {name} has a gradient '
                               f'{float(out.grads[name].abs().max()):.3g} '
                               f'over {bound:.3g}')
    for name, want in cpu.grads.items():
      if name in shift_free:
        continue
      got = card.grads[name].cpu()
      scale = float(want.abs().max())
      err = float((got - want).abs().max())
      norm = float(want.norm())
      err_norm = float((got - want).norm())
      if not err <= tol['grad_rtol'] * scale + 1e-7:
        raise AssertionError(f'step {i}: gradient of {name} off by {err:.3g} '
                             f'(largest entry {scale:.3g})')
      if not err_norm <= tol['grad_norm_rtol'] * norm + 1e-7:
        raise AssertionError(f'step {i}: gradient of {name} off by '
                             f'{err_norm:.3g} in norm (norm {norm:.3g})')
      if err / max(scale, 1e-30) > worst[i]:
        worst[i], worst_leaf[i] = err / max(scale, 1e-30), name
      worst_norm[i] = max(worst_norm[i], err_norm / max(norm, 1e-30))
  log(f'training reference ({config_name}, {cfg.dtype_str}): losses [cpu, '
      f'card] per step {losses}; (is_finite, loss_scale) per step, equal '
      f'on both {scales}; every gradient leaf within {worst} of '
      f'its largest entry (worst: {worst_leaf}) and within {worst_norm} of '
      f'its norm (per step); {len(frozen)} frozen leaves 0 on both; '
      f'zero gradient on both under {list(zero)}, non-zero under '
      f'{list(nonzero)}; '
      f'max choices the card flipped against the CPU\'s own, replayed on '
      f'the CPU (site: outputs over its calls, the largest gap from a tie '
      f'relative to the site\'s largest magnitude), per step {flips}; card '
      f'launches per step {card_launches}')
  return worst, worst_leaf, worst_norm, flips


def f16_overflow_reference(scale: float = 2.0**30) -> list:
  """Phase 5g: one f16 step of the tiny trainer on the card and on the CPU
  from the same weights, batch and draws, from a loss scale of ``scale``
  that overflows f16 in the backward: neither step is finite, neither
  moves a parameter, and both back the scale off to ``scale / 2``. Returns
  each device's (is_finite, loss_scale)."""
  cfg = dataclasses.replace(configs.smoke_train_exhaustive(),
                            dtype_str='float16')
  models = {dev: evaluate.build_model(cfg, dev, 0).train()
            for dev in ('cpu', 'cuda')}
  adam = optimizers.get_optimizer(cfg.train, models['cpu'])
  generator = loader.make_generator(cfg.data, 0)
  draws, seen = None, []
  for dev in ('cuda', 'cpu'):
    state = trainer.create_train_state(
        models[dev], adam, seed=0, dynamic_scale=dataclasses.replace(
            dynamic_scale.for_dtype(cfg.dtype_str), scale=scale))
    start = [p.detach().clone() for p in models[dev].parameters()]
    out = trainer.train_step(state, reference_batch(cfg, generator, 0, dev),
                             adam, draws=draws)
    draws = bev_mapper.TrainDraws(
        z_jitter=out.draws.z_jitter.cpu(),
        modality_keep=None if out.draws.modality_keep is None
        else out.draws.modality_keep.cpu())
    moved = any(not torch.equal(p, q) for p, q in zip(
        start, models[dev].parameters()))
    seen.append((out.logs['is_finite'], out.logs['loss_scale']))
    if seen[-1] != (0.0, scale / 2) or moved:
      raise AssertionError(f'{dev}: an f16 step from a loss scale of {scale} '
                           f'gave {out.logs}, params moved {moved}')
  return seen


def fft_contraction_bound(config: configs.Config):
  """X3, the FFT correlation's channel contraction (PyTorch's einsum, not
  a kernel of the port): its bound per example of ``config`` (bench_full:
  64 rotations of a [120, 80, 32] template on the [120, 160, 32] map). The
  template spectra of every rotation and the map's spectrum are read once
  and the products written once (complex64), 8 real operations per complex
  multiply-add."""
  grid_map = loader.map_grid(config.data).bev()
  grid_q = bev_localizer.build_query_frustum_grid(
      grid_map.cell_size, config.model.query_frustum_depth)[0]
  (h, w), (hq, wq) = grid_map.extent, grid_q.extent
  cells = pev._next_fast_len(h + 2 * (hq - 1)) * (
      pev._next_fast_len(w + 2 * (wq - 1)) // 2 + 1)
  dim, rot = config.model.bev_mapper.matching_dim, config.model.num_rotations
  nbytes = (rot + 1) * cells * dim * 8 + rot * cells * 8
  return _bound(nbytes, rot * cells * dim * 8)


# The device generator, card against CPU on the same draws: the CPU tests'
# tolerances (tests/test_torch_device_synthetic.py): floats to 1e-5, colors
# to 1e-4 (the card's and the CPU's cos differ by an ulp of phases up to
# ~6e4 rad at the horizon, where the fade leaves ~0 of the color), and a
# share of at most 1e-3 of the elements off (a boolean decided on its
# threshold: a ray grazing a box edge, a cell on a frustum's edge).
DATA_ATOL, DATA_IMAGE_ATOL, DATA_FLIP_SHARE = 1e-5, 1e-4, 1e-3
# The host generator's builds per batch on the card's machine (numpy;
# PERF.md section 5), logged beside the device generator's.
HOST_BUILD = {'train_full1chip_exhaustive': '4.7-5.7 s',
              'eval_full1chip_ransac': '13.5-14.7 s'}
DATA_BUILDS = 10


def leaves(tree, prefix=''):
  """``{path: tensor}`` of a batch (dicts and geometry dataclasses)."""
  if isinstance(tree, dict):
    return {k: v for key, value in tree.items() if key != '_host'
            for k, v in leaves(value, f'{prefix}/{key}').items()}
  if hasattr(tree, '__dataclass_fields__'):
    return {k: v for name in tree.__dataclass_fields__
            for k, v in leaves(getattr(tree, name), f'{prefix}/{name}').items()}
  return {prefix: tree}


def compare_batches(card, cpu):
  """Card against CPU, leaf by leaf; returns the largest error of the
  floats within tolerance and the elements off per leaf that has any."""
  worst, off = 0.0, {}
  got_leaves = leaves(card)
  for path, want in leaves(cpu).items():
    got = got_leaves[path].cpu()
    if (got.shape, got.dtype) != (want.shape, want.dtype):
      raise AssertionError(f'data {path}: {got.shape} {got.dtype} vs '
                           f'{want.shape} {want.dtype}')
    if want.dtype == torch.bool:
      bad = got != want
    else:
      err = (got.double() - want.double()).abs()
      if 'images' in path or 'rgb' in path:
        bad = err > DATA_IMAGE_ATOL
      else:
        bad = err > DATA_ATOL * (1 + want.double().abs())
      if (~bad).any():
        worst = max(worst, float(err[~bad].max()))
    if bad.any():
      off[path] = int(bad.sum())
      if float(bad.double().mean()) > DATA_FLIP_SHARE:
        raise AssertionError(f'data {path}: {off[path]} of {bad.numel()} '
                             'elements off between card and CPU')
  return worst, off


def data_on_card(smi: str):
  """The device generator on the card against the same draws on the CPU,
  its schema against the host generator's, and its build times: ten
  builds per config (host clock with the card's work, and CUDA events)
  and the peak memory above what was allocated before, then three batches
  from the dataset's iterator (built in this thread and stream, the host
  not waiting for the card)."""
  for name, split, bs in (('train_full1chip_exhaustive', 'train', 2),
                          ('eval_full1chip_ransac', 'eval', 4)):
    data = configs.get_config(name, batch_size=bs).data
    spec = loader.device_spec(data)
    mode = data_types.DataMode(data.mode)
    seed = loader.split_seed(data, split)
    draws = device_synthetic.draw_batch(spec, mode, seed, range(bs))
    make = lambda d, dev: device_synthetic.make_batch(  # noqa: E731
        spec, mode, device_synthetic.draws_to(d, dev))
    card, cpu = make(draws, 'cuda'), make(draws, 'cpu')
    torch.cuda.synchronize()
    worst, off = compare_batches(card, cpu)
    host = loader.process_batch(loader.make_examples(
        loader.split_generator(data, split), [0], data, mode), mode, 'cpu')
    schema = {k: (tuple(v.shape[1:]), v.dtype)
              for k, v in leaves(host).items()}
    if schema != {k: (tuple(v.shape[1:]), v.dtype)
                  for k, v in leaves(card).items()}:
      raise AssertionError(f'{name}: the device batch\'s schema is not the '
                           'host generator\'s')
    if set(host['_host']) != set(loader.host_strings(mode, seed, [0])):
      raise AssertionError(f'{name}: host strings differ')
    del card, cpu, host
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    wall, events = [], []
    for i in range(DATA_BUILDS):
      start = torch.cuda.Event(enable_timing=True)
      end = torch.cuda.Event(enable_timing=True)
      t0 = time.perf_counter()
      start.record()
      batch = make(device_synthetic.draw_batch(
          spec, mode, seed, range(i * bs, (i + 1) * bs)), 'cuda')
      end.record()
      end.synchronize()
      wall.append(1e3 * (time.perf_counter() - t0))
      events.append(start.elapsed_time(end))
      del batch
    peak = torch.cuda.max_memory_allocated() - base
    with torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
      make(device_synthetic.draw_batch(spec, mode, seed, range(bs)), 'cuda')
      torch.cuda.synchronize()
    kernel_events = [e for e in prof.key_averages()
                     if e.self_device_time_total > 0]
    launches = sum(e.count for e in kernel_events)
    device_ms = sum(e.self_device_time_total for e in kernel_events) / 1e3
    with loader.get_dataset(data, bs, device='cuda') as dataset:
      kind = dataset.meta_data['generator_kind']
      if kind != 'device-torch':
        raise AssertionError(f'{name}: generator_kind {kind}')
      it = dataset.train_iter if split == 'train' else dataset.valid_iter
      builds = []
      for _ in range(3):
        next(it)
        builds.append(it.last_build)
    log(f'data on the card ({name}, batch {bs}): card vs CPU on the same '
        f'draws, largest float error {worst:.3g}, elements off {off}; schema '
        f'= host path\'s; {DATA_BUILDS} builds: wall ms '
        f'{[round(x, 3) for x in wall]}, CUDA-event ms '
        f'{[round(x, 3) for x in events]}, peak memory '
        f'{peak / 2**30:.3f} GiB above the {base / 2**30:.2f} GiB allocated '
        f'before; one build {launches} kernel launches, {device_ms:.3f} ms '
        f'of device time (profiler); through the dataset\'s iterator '
        f'host ms {[round(b.wall_ms, 3) for b in builds]}, card ms '
        f'{[round(b.card_ms, 3) for b in builds]}; the host generator\'s build '
        f'{HOST_BUILD[name]} a batch (PERF.md section 5); {smi}')


def serving_main_path():
  """bench_full at batch 1 on 2 queries, bf16; returns launches, captures."""
  # The matmuls run in bf16; the f32 refinement conv of bf16 values is
  # exact in TF32.
  torch.backends.cudnn.allow_tf32 = True
  model = evaluate.build_model(configs.bench_full(), 'cuda', 0)
  with Capture(view_scan, 'lift_topk', 0) as lift, \
       Capture(view_scan, 'patch_sample_2d', 1) as sample:
    kernels.reset_launch_counts()
    result = evaluate.evaluate('bench_full', 2, 'cuda', seed=0, batch_size=1,
                               model=model)
    launches = dict(kernels.LAUNCHES)
  pred = result['last_pred']
  volume = pred['scores_pose_volume']
  if tuple(volume.shape[1:]) != (64, 239, 239):
    raise AssertionError(f'pose volume {tuple(volume.shape)}')
  if not (torch.isfinite(pred['map_t_query'].t).all()
          and torch.isfinite(pred['map_t_query'].angle).all()):
    raise AssertionError('non-finite pose')
  for kernel in ('lift_topk_fwd', 'patch_sample_2d'):
    if launches[kernel] == 0:
      raise AssertionError(f'{kernel} was not launched on the serving path')
  if result['generator_kind'] != 'device-torch':
    raise AssertionError(f'serving data from {result["generator_kind"]}')
  log(f'serving main path: launches {launches}, forward ms per query '
      f'(card, CUDA events) {result["forward_ms"]}, the whole loop '
      f'{1e3 * result["eval_seconds"]} ms, data {result["generator_kind"]}, '
      f'build ms per query (host) {result["build_ms"]}, (card) '
      f'{result["build_card_ms"]}, position '
      f'error {result["position_error_m"]} m (random weights); X3 (FFT '
      f'channel contraction) bound per query '
      f'{fft_contraction_bound(configs.bench_full())}')
  return launches, lift, sample


# Per training config of the main paths: the least launches of each kernel
# a step, the kernels that must not launch, and the kernels whose inputs
# phase 8 checks and times.
TRAIN_PATHS = {
    'train_full1chip_exhaustive': (
        {'lift_topk_fwd': 2, 'patch_sample_2d': 1, 'lift_topk_bwd': 2,
         'patch_sample_2d_bwd': 1}, (),
        ('lift_topk_bwd', 'patch_sample_2d_bwd')),
    'train_full1chip_ransac': (
        {'lift_topk_fwd': 2, 'lift_topk_bwd': 2, 'pose_scoring': 1,
         'pose_scoring_bwd': 1}, ('patch_sample_2d', 'patch_sample_2d_bwd'),
        ('pose_scoring', 'pose_scoring_bwd')),
    f'train_full1chip_exhaustive:modalities={THREE_MODALITIES}': (
        {'lift_topk_fwd': 2, 'patch_sample_2d': 1, 'lift_topk_bwd': 2,
         'patch_sample_2d_bwd': 1}, (), ()),
    # Phase 7i: the query's lift alone (the map has no street views).
    'train_full1chip_exhaustive:modalities=aerial': (
        {'lift_topk_fwd': 1, 'patch_sample_2d': 1, 'lift_topk_bwd': 1,
         'patch_sample_2d_bwd': 1}, (), ()),
    'train_full1chip_exhaustive:bev_net=1, add_confidence_query': (
        {'lift_topk_fwd': 2, 'patch_sample_2d': 1, 'lift_topk_bwd': 2,
         'patch_sample_2d_bwd': 1}, (), ()),
    # Phase 7j: the lift's other forms (A145_FORMS), on map and query; the
    # gather form launches no lift kernel.
    'train_full1chip_exhaustive, stream, [mean, var, max, min, score_max]': (
        {'lift_topk_fwd': 2, 'patch_sample_2d': 1, 'lift_topk_bwd': 2,
         'patch_sample_2d_bwd': 1}, (), ('lift_topk_fwd', 'lift_topk_bwd')),
    'train_full1chip_exhaustive, scan, unweighted [mean, var]': (
        {'lift_topk_fwd': 2, 'patch_sample_2d': 1, 'lift_topk_bwd': 2,
         'patch_sample_2d_bwd': 1}, (), ('lift_topk_fwd', 'lift_topk_bwd')),
    'train_full1chip_exhaustive, gather, depth MLP, unweighted '
    '[mean, max, min]': (
        {'patch_sample_2d': 1, 'patch_sample_2d_bwd': 1},
        ('lift_topk_fwd', 'lift_topk_bwd'), ()),
}


def training_main_path(smi: str, name: str = 'train_full1chip_exhaustive',
                       config: configs.Config = None, after=None,
                       traced_steps: int = 0, nonzero=()):
  """``name`` (a key of ``TRAIN_PATHS``; ``config`` when given, else the
  named config), batch 2, 3 steps; returns launches and the captured inputs
  of the config's kernels to check. Some parameter under each prefix of
  ``nonzero`` takes a non-zero gradient each step. ``after(workdir)`` runs
  on the run's workdir after its steps; ``traced_steps`` more steps then
  resume it under ``torch.profiler``, whose device ms a step are logged."""
  least, never, captured = TRAIN_PATHS[name]
  resident = torch.cuda.memory_allocated()  # earlier phases' tensors
  config = config or configs.get_config(name)
  model = evaluate.build_model(config, 'cuda', 0)
  params = dict(model.named_parameters())
  flat = lambda: torch.cat([p.detach().flatten() for p in params.values()])
  before = [flat()]
  # The street-view trunk is the query's own mapper's where it has one.
  street = ('bev_mapper_query.' if config.model.bev_mapper_query is not None
            else 'bev_mapper.')
  weighted = (config.model.bev_mapper_query or config.model.bev_mapper
              ).streetview_encoder.do_weighted_fusion
  street_leaves = [street + leaf[len('bev_mapper.'):]
                   for leaf in (STREET_ROOT, PROJ_MLP)[:1 + weighted]]
  map_modalities = [m for m in ('streetview', *RASTER_TRUNKS) if getattr(
      config.model.bev_mapper, f'{m}_encoder') is not None]
  rasters = [m for m in RASTER_TRUNKS if m in map_modalities]
  per_step, raster_checked = [], {m: [] for m in rasters}

  def check_step(step: int, out: trainer.StepOutput) -> None:
    counts = dict(kernels.LAUNCHES)
    prev = per_step[-1][0] if per_step else {k: 0 for k in counts}
    launched = {k: counts[k] - prev[k] for k in counts}
    loss = trainer.summarize([out.metrics])['loss/total']
    if not (math.isfinite(loss) and math.isfinite(out.logs['l2_grads'])
            and out.logs['is_finite'] == 1.0):
      raise AssertionError(f'step {step}: loss {loss}, logs {out.logs}')
    for leaf in (*street_leaves, 'temperature'):
      if not out.grads[leaf].abs().max() > 0:
        raise AssertionError(f'step {step}: no gradient reaches {leaf}')
    for prefix in nonzero:
      if not max((float(g.abs().max()) for n, g in out.grads.items()
                  if n.startswith(prefix)), default=0.0) > 0:
        raise AssertionError(f'step {step}: no gradient under {prefix}')
    keep = out.draws.modality_keep
    keep = (torch.ones(len(map_modalities), 2, dtype=torch.bool)
            if keep is None else keep.cpu())
    trunk_grads = {}
    for modality in rasters:
      row, trunk = map_modalities.index(modality), RASTER_TRUNKS[modality][1]
      trunk_grads[modality] = max(float(g.abs().max()) for n, g in
                                  out.grads.items() if n.startswith(trunk))
      if bool(keep[row].any()):
        if not trunk_grads[modality] > 0:
          raise AssertionError(f'step {step}: {modality} kept '
                               f'{keep[row].tolist()} but its trunk has no '
                               'gradient')
        raster_checked[modality].append(step)
    for kernel, fewest in least.items():
      if launched[kernel] < fewest:
        raise AssertionError(f'step {step}: {kernel} launched '
                             f'{launched[kernel]} times, expected >= {fewest}')
    for kernel in never:
      if launched[kernel]:
        raise AssertionError(f'step {step}: {kernel} launched '
                             f'{launched[kernel]} times on {name}')
    after = flat()
    moved = float((after - before[-1]).abs().max())
    lr = out.logs['learning_rate']
    if (lr > 0) != (moved > 0):
      raise AssertionError(f'step {step}: lr {lr} but params moved {moved}')
    before.append(after)
    per_step.append((counts, launched))
    proj_grad = (f'{float(out.grads[street_leaves[1]].abs().max()):.3g}'
                 if weighted else 'none (unweighted fusion)')
    log(f'train step {step} ({name}): loss {loss:.4f}, l2_grads '
        f'{out.logs["l2_grads"]:.4g}, lr {lr:.3g}, params moved {moved:.3g}, '
        f'draws: z jitter {out.draws.z_jitter.tolist()}, modality keep '
        f'{map_modalities} x example {keep.tolist()}; |grad| street root '
        f'{float(out.grads[street_leaves[0]].abs().max()):.3g}, proj '
        f'{proj_grad} (under '
        f'{street}), trunks '
        f'{trunk_grads}, temperature '
        f'{float(out.grads["temperature"]):.3g}; launches {launched}')

  workdir = fresh_workdir(name)
  torch.cuda.reset_peak_memory_stats()
  with contextlib.ExitStack() as stack:
    captures = [stack.enter_context(Capture(kernels, kernel, 0))
                for kernel in captured]
    kernels.reset_launch_counts()
    result = train.train(config, 3, 'cuda', seed=0, model=model,
                         on_step=check_step, workdir=workdir)
  # The steps' launches; the eval and checkpoint at the stop step follow.
  launches = per_step[-1][0]
  after_steps = {k: v - launches[k] for k, v in kernels.LAUNCHES.items()
                 if v - launches[k]}
  peak = torch.cuda.max_memory_allocated()
  # The path's own footprint: its peak less what earlier phases still hold.
  TRAIN_PEAK[name] = peak - resident
  if after is not None:
    after(workdir)
  device_ms = None
  if traced_steps:
    with torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA]) as prof:
      train.train(config, traced_steps, 'cuda', seed=0, model=model,
                  workdir=workdir)
    prof.export_chrome_trace(str(workdir / 'traced.json'))
    device_ms = trainer.step_device_ms(workdir / 'traced.json')
  shutil.rmtree(workdir)
  for modality, steps in raster_checked.items():
    if not steps:
      raise AssertionError(f'no step kept the {modality} modality')
  if result['generator_kind'] != 'device-torch':
    raise AssertionError(f'training data from {result["generator_kind"]}')
  ms = [1e3 * s for s in result['step_seconds']]
  log(f'training main path ({name}, batch 2, bf16): '
      f'launches {launches}; ms per step {ms} (steps 2-3: '
      f'{sum(ms[1:]) / len(ms[1:]):.1f} ms), with the wait for its batch '
      f'{[1e3 * s for s in result["wall_seconds"]]}, data '
      f'{result["generator_kind"]}, build ms per step (host) '
      f'{result["build_ms"]}, (card) {result["build_card_ms"]} (the '
      f'host generator\'s build {HOST_BUILD["train_full1chip_exhaustive"]}), '
      f'peak memory {peak / 2**30:.2f} GiB (of it '
      f'{TRAIN_PEAK[name] / 2**30:.2f} GiB its own, beside the earlier '
      f'phases\' tensors), raster trunks\' gradients checked on steps '
      f'{raster_checked}; the eval at the stop step launched '
      f'{after_steps}, its checkpoint {result["checkpoints"]}; device ms '
      f'a step of {traced_steps} more traced steps (resumed) {device_ms}; '
      f'{smi}')
  del model, params, before, result
  torch.cuda.empty_cache()
  return (launches, *captures)


def assert_close_scores(name: str, got: torch.Tensor, want: torch.Tensor,
                        tol) -> float:
  """Pose scores within (atol, rtol); returns the max abs error."""
  atol, rtol = tol
  err = (got - want).abs()
  bad = err > atol + rtol * want.abs()
  if bad.any() or not torch.isfinite(got).all():
    raise AssertionError(
        f'{name}: {int(bad.sum())} of {got.numel()} scores off, max abs err '
        f'{float(err.max()):.3g} (atol {atol}, rtol {rtol})')
  return float(err.max())


def argmax_agrees(name: str, got: torch.Tensor, want: torch.Tensor,
                  tol) -> int:
  """Per row, ``got``'s argmax is ``want``'s, or a near tie: ``want``'s
  score at ``got``'s argmax lies within ``tol`` of ``want``'s maximum.
  Returns the number of near ties."""
  atol, rtol = tol
  g_idx, w_idx = got.argmax(-1), want.argmax(-1)
  near = 0
  for row in range(got.shape[0]):
    if int(g_idx[row]) == int(w_idx[row]):
      continue
    top = float(want[row, w_idx[row]])
    chosen = float(want[row, g_idx[row]])
    if top - chosen > atol + rtol * abs(top):
      raise AssertionError(
          f'{name}: row {row} picks {int(g_idx[row])} (score {chosen}), '
          f'the reference {int(w_idx[row])} (score {top})')
    near += 1
  return near


def check_pose_scoring(args, kwargs):
  """B4 against its plain version: (max abs error, near ties of argmax)."""
  got = kernels.pose_scoring(*args, **kwargs)
  want = pose_estimation.pose_scoring_plain(*args, **kwargs,
                                            pose_chunk=PLAIN_POSE_CHUNK)
  torch.cuda.synchronize()
  err = assert_close_scores('pose_scoring', got, want, POSE_SCORE_TOL)
  return err, argmax_agrees('pose_scoring argmax', got, want, POSE_SCORE_TOL)


def seeded_pose_scoring_inputs(device: str, mask: bool, p: int = 20_001):
  """B4 at the eval shape, batch 2: 4,652 query points (meters, in the
  query frustum) on a 120 x 160 map of 0.2 m cells, ``p`` poses. 4,000 of
  the poses have angle 0 or pi / 2 and whole-cell translations, and 1,000
  of the points lie on whole or half cells, so that transformed points
  fall on cell centers (where floor and the upper tap jump) and on the
  map's border; translations reach a cell or more off the map; a tenth of
  the points are invalid."""
  g = torch.Generator(device=device).manual_seed(1)
  b, n, h, w, cell = 2, 4652, 120, 160, 0.2
  angle = (torch.rand((b, p), generator=g, device=device) * 2 - 1) * math.pi
  extent = torch.tensor([h * cell, w * cell], device=device)
  t = torch.rand((b, p, 2), generator=g, device=device) * (extent + 4) - 2
  angle[:, :2000] = 0.0
  angle[:, 2000:4000] = math.pi / 2
  t[:, :4000] = torch.randint(-5, w + 5, (b, 4000, 2), generator=g,
                              device=device).float() * cell
  xy = torch.rand((b, n, 2), generator=g, device=device) * torch.tensor(
      [24.0, 16.0], device=device) - torch.tensor([12.0, 0.0], device=device)
  xy[:, :1000] = torch.randint(-120, 121, (b, 1000, 2), generator=g,
                               device=device).float() * (cell / 2)
  sim = torch.rand((b, n, h, w), generator=g, device=device) * 1.6e-3
  valid_points = torch.rand((b, n), generator=g, device=device) < 0.9
  valid_map = torch.rand((b, h, w), generator=g, device=device) < 0.95
  return ((angle, t, sim, xy, valid_points, valid_map),
          dict(cell_size=cell, mask_out_of_bounds=mask))


def seeded_pose_scoring_bwd_inputs(device: str, mask: bool):
  """B7 at the training shape: ``seeded_pose_scoring_inputs`` at 10,001
  poses, the poses of ``IDENTICAL_RUN`` in example 0 all one pose, and a
  seeded N(0, 1) cotangent on example 0, 0 on example 1."""
  (angle, t, sim, xy, valid_points, valid_map), kw = (
      seeded_pose_scoring_inputs(device, mask, p=10_001))
  angle[0, IDENTICAL_RUN] = angle[0, IDENTICAL_RUN.start]
  t[0, IDENTICAL_RUN] = t[0, IDENTICAL_RUN.start]
  g = torch.randn(angle.shape, generator=torch.Generator(
      device=device).manual_seed(2), device=device)
  g[1] = 0.0
  return ((g, angle, t, xy, valid_points, valid_map),
          dict(kw, sim_shape=tuple(sim.shape)))


def check_pose_scoring_bwd(args, kwargs) -> float:
  """B7 against its plain version, bit for bit (both fold each cell's
  values in one order: runs of 32 poses, each in ascending pose then tap,
  then the runs); ``args`` = (g, angle, t, xy,
  valid_points, valid_map), and ``g`` is scaled by ``unit_cotangent``
  first. Where every entry of ``g`` of an example is 0, its gradient must
  be 0; elsewhere some entry must not be. Returns the largest absolute
  difference, 0."""
  args = (unit_cotangent(args[0]), *args[1:])
  got = kernels.pose_scoring_bwd(*args, **kwargs)
  want = pose_estimation.pose_scoring_bwd_plain(
      *args, **kwargs, pose_chunk=PLAIN_POSE_CHUNK)
  torch.cuda.synchronize()
  silent = ~args[0].any(-1)
  if got[silent].any():
    raise AssertionError('pose_scoring_bwd: an example whose cotangent is 0 '
                         'has a gradient')
  if not want[~silent].abs().max() > 0:
    raise AssertionError('pose_scoring_bwd: the plain version\'s gradient is '
                         '0; the check would be vacuous')
  if not torch.equal(got, want):
    differ = int((got.view(torch.int32) != want.view(torch.int32)).sum())
    raise AssertionError(
        f'pose_scoring_bwd d_sim: {differ} of {got.numel()} entries differ '
        f'from the plain version, by up to '
        f'{float((got - want).abs().max()):.3g}')
  return float((got - want).abs().max())


def check_pose_scoring_bwd_repeats(args, kwargs, calls: int = 10) -> int:
  """B7 called ``calls`` times on one input (``g`` scaled as in
  ``check_pose_scoring_bwd``): every call's bits must be the first's.
  Returns the number of calls."""
  args = (unit_cotangent(args[0]), *args[1:])
  first = kernels.pose_scoring_bwd(*args, **kwargs)
  for i in range(1, calls):
    if not torch.equal(kernels.pose_scoring_bwd(*args, **kwargs), first):
      raise AssertionError(f'pose_scoring_bwd: call {i + 1} of {calls} on '
                           f'one input differs from the first')
  return calls


# Calls of K3 and K4 on each captured input that must give the same bits
# (ROADMAP C20: both sum every entry in one order fixed by the inputs).
REPEAT_CALLS = 10


def check_repeats(fn, name: str, calls: int = REPEAT_CALLS) -> int:
  """``calls`` calls of ``fn`` (a kernel on one input): raises unless every
  output's bits are the first's. Returns the entries of the output."""
  first = fn()
  bits = {2: torch.int16, 4: torch.int32}[first.element_size()]
  for i in range(1, calls):
    differ = int((fn().view(bits) != first.view(bits)).sum())
    if differ:
      raise AssertionError(f'{name}: call {i + 1} of {calls} on one input '
                           f'differs from the first in {differ} of '
                           f'{first.numel()} entries')
  return first.numel()


def check_identical_run(args, kwargs) -> float:
  """B7 on the seeded inputs' run of R identical poses alone (g 1 there, 0
  elsewhere): each tap of a point adds R equal values, so the kernel must
  equal the plain version bit for bit, and lie within R ulps (relative
  R 2^-24) of the closed form R v, v the one pose's gradient. Returns the
  largest relative distance from the closed form."""
  g, angle, t = args[:3]
  run = torch.zeros_like(g)
  run[0, IDENTICAL_RUN] = 1.0
  got = kernels.pose_scoring_bwd(run, *args[1:], **kwargs)
  want = pose_estimation.pose_scoring_bwd_plain(
      run, *args[1:], **kwargs, pose_chunk=PLAIN_POSE_CHUNK)
  pose = IDENTICAL_RUN.start
  one = pose_estimation.pose_scoring_bwd_plain(
      torch.ones_like(g[:, :1]), angle[:, pose:pose + 1],
      t[:, pose:pose + 1], *args[3:], **kwargs)
  torch.cuda.synchronize()
  if not torch.equal(got, want):
    raise AssertionError('pose_scoring_bwd: the identical run differs from '
                         'the plain version')
  r = IDENTICAL_RUN.stop - IDENTICAL_RUN.start
  closed = one[0].double() * r
  if not closed.abs().max() > 0:
    raise AssertionError('the identical run reaches no cell')
  rel = float(((got[0].double() - closed).abs()
               / closed.abs().clamp(min=1e-30))[closed != 0].max())
  if not (rel <= r * 2.0**-24 and not got[0][closed == 0].any()
          and not got[1].any()):
    raise AssertionError(f'pose_scoring_bwd: the identical run is {rel:.3g} '
                         f'from its closed form (limit {r * 2.0**-24:.3g})')
  return rel


def check_gathers(device: str):
  """B5 and B6 at the gather tool's shapes, over all N: B5's max abs
  error (B6 must equal ``table[ids]``)."""
  inputs = bench_gather.make_inputs(bench_gather.N, seed=2, device=device)
  flat = bench_gather.flat_stack(inputs['stack'])
  rid = bench_gather.row_ids(inputs['row0'], inputs['col0'])
  w = bench_gather.W
  got = kernels.slice_gather(flat, rid, w=w)
  want = gathers.slice_gather_plain(flat, rid, w=w)
  rows = kernels.table_gather(inputs['table'], inputs['ids'])
  rows_want = gathers.table_gather_plain(inputs['table'], inputs['ids'])
  torch.cuda.synchronize()
  if got.shape[0] != bench_gather.N or rows.shape[0] != bench_gather.N:
    raise AssertionError('the gathers did not cover all N points')
  err = assert_close('slice_gather', got, want)
  if not torch.equal(rows, rows_want):
    raise AssertionError('table_gather differs from table[ids]')
  return err


def ransac_reference() -> None:
  """The tiny RANSAC localizer on the card against the CPU (f32, TF32 off),
  same weights and batch, the CPU's pose samples injected on the card."""
  cfg = configs.smoke_eval_ransac()
  models = {dev: evaluate.build_model(cfg, dev, 0)
            for dev in ('cpu', 'cuda')}
  examples = loader.make_pair_examples(
      loader.split_generator(cfg.data, 'eval'), range(cfg.batch_size),
      cfg.data)
  kernels.reset_launch_counts()
  with torch.inference_mode():
    cpu = models['cpu'](loader.pair_batch_to_torch(examples, 'cpu'),
                        generator=torch.Generator().manual_seed(0))
    samples = cpu['map_t_query_samples'][:, 1:]
    card = models['cuda'](loader.pair_batch_to_torch(examples, 'cuda'),
                          pose_samples=geometry.Transform2D(
                              angle=samples.angle.cuda(),
                              t=samples.t.cuda()))
  torch.cuda.synchronize()
  if kernels.LAUNCHES['pose_scoring'] < 2:
    raise AssertionError(f'RANSAC reference launches {kernels.LAUNCHES}')
  err = assert_close_scores('RANSAC reference scores_poses',
                            card['scores_poses'].cpu(), cpu['scores_poses'],
                            RANSAC_SCORE_TOL)
  near = argmax_agrees('RANSAC reference best_index',
                       card['scores_poses'][:, 1:].cpu(),
                       cpu['scores_poses'][:, 1:], RANSAC_SCORE_TOL)
  b = cpu['scores_poses'].shape[0]
  refine = [x['scores_grid_refine'].reshape(b, -1).cpu() for x in (card, cpu)]
  err_refine = assert_close_scores('RANSAC reference scores_grid_refine',
                                   *refine, RANSAC_SCORE_TOL)
  near_refine = argmax_agrees('RANSAC reference refinement argmax', *refine,
                              RANSAC_SCORE_TOL)
  same = ((card['best_index'].cpu() == cpu['best_index'])
          & (refine[0].argmax(-1) == refine[1].argmax(-1)))
  for key in ('map_t_query_ransac', 'map_t_query'):
    dt = (card[key].t.cpu() - cpu[key].t)[same].abs()
    da = (card[key].angle.cpu() - cpu[key].angle)[same].abs()
    if dt.numel() and max(float(dt.max()), float(da.max())) > POSE_ATOL:
      raise AssertionError(f'RANSAC reference {key} off by {dt}, {da}')
  log(f'RANSAC reference (smoke_eval_ransac, f32): scores max abs err '
      f'{err:.3g}, refinement {err_refine:.3g}; best_index '
      f'{cpu["best_index"].tolist()} (near ties {near}, refinement '
      f'{near_refine}); poses compared on {int(same.sum())} of {b}')


def f32_prefix_sum_blind_share(probs: torch.Tensor):
  """ROADMAP C14: of the categories of ``probs [M]`` with mass > 0, the
  share that an inverse-CDF draw on an f32 prefix sum can never pick (no
  width: the sum does not grow there), and their share of the mass. Two
  f32 prefix sums, on the host: the exact one rounded once to f32 (the
  best any f32 prefix sum can be), and a sequential f32 one (numpy)."""
  p = probs.float().cpu().numpy()
  live = p > 0
  total = p.sum(dtype=np.float64)
  shares = []
  for cdf in (np.cumsum(p, dtype=np.float64).astype(np.float32),
              np.cumsum(p, dtype=np.float32)):
    blind = live & ~(np.diff(cdf, prepend=np.float32(0)) > 0)
    shares.append((float(blind.sum() / max(live.sum(), 1)),
                   float(p[blind].sum(dtype=np.float64) / total)))
  return shares


def ransac_main_path(smi: str):
  """eval_full1chip_ransac at batch 4: a warm batch and a timed one;
  returns launches and the captured inputs of B4, K1 and the draws."""
  model = evaluate.build_model(configs.eval_full1chip_ransac(), 'cuda', 0)
  per_batch = []

  def check_batch(i: int, pred) -> None:
    counts = dict(kernels.LAUNCHES)
    prev = per_batch[-1] if per_batch else {k: 0 for k in counts}
    launched = {k: counts[k] - prev[k] for k in counts}
    if (launched['pose_scoring'] < 2 or launched['lift_topk_fwd'] < 2
        or launched['patch_sample_2d'] != 0):
      raise AssertionError(f'batch {i}: launches {launched}')
    for key in ('scores_poses', 'scores_grid_refine'):
      if not torch.isfinite(pred[key]).all():
        raise AssertionError(f'batch {i}: non-finite {key}')
    if tuple(pred['scores_poses'].shape) != (4, 20_001):
      raise AssertionError(f'scores_poses {tuple(pred["scores_poses"].shape)}')
    tfm = pred['map_t_query']
    if not (torch.isfinite(tfm.t).all() and torch.isfinite(tfm.angle).all()):
      raise AssertionError(f'batch {i}: non-finite pose')
    per_batch.append(counts)
    log(f'RANSAC batch {i}: launches {launched}, best_index '
        f'{pred["best_index"].tolist()}')

  torch.cuda.reset_peak_memory_stats()
  with Capture(kernels, 'pose_scoring', 0) as scoring, \
       Capture(view_scan, 'lift_topk', 0) as lift, \
       Capture(pose_estimation, 'sample_categorical', 0) as draws:
    kernels.reset_launch_counts()
    result = evaluate.evaluate('eval_full1chip_ransac', 8, 'cuda', seed=0,
                               batch_size=4, model=model,
                               on_batch=check_batch)
    launches = dict(kernels.LAUNCHES)
  peak = torch.cuda.max_memory_allocated()
  probs = draws.largest()[0][0]
  (blind, blind_mass), (seq, seq_mass) = f32_prefix_sum_blind_share(probs[0])
  if result['generator_kind'] != 'device-torch':
    raise AssertionError(f'RANSAC data from {result["generator_kind"]}')
  ms = result['forward_ms']
  log(f'RANSAC main path (eval_full1chip_ransac, batch 4, f32): launches '
      f'{launches}; forward ms per batch (card, CUDA events) {ms} (timed '
      f'batch: {ms[-1]:.1f} ms), the whole loop '
      f'{1e3 * result["eval_seconds"]} ms, '
      f'data {result["generator_kind"]}, build ms per batch (host) '
      f'{result["build_ms"]}, (card) {result["build_card_ms"]} (the '
      f'host generator\'s build {HOST_BUILD["eval_full1chip_ransac"]}), peak '
      f'memory {peak / 2**30:.2f} GiB, {len(result["results"]["pair_id"])} '
      f'rows of per-example metrics; recall_1m {result["recall_1m"]}, '
      f'recall_top1 {result["recall_top1"]}, sample recalls '
      f'{[result[k] for k in result if k.startswith("recall_samples")]} '
      f'(random weights); {smi}')
  log(f'C14: match PDF of example 0 has {probs.shape[1]} categories; of '
      f'those with mass > 0, the exact prefix sum rounded to f32 gives '
      f'{blind:.4%} (holding {blind_mass:.4%} of the mass) no width, a '
      f'sequential f32 prefix sum {seq:.4%} (holding {seq_mass:.4%})')
  del model, draws, probs
  torch.cuda.empty_cache()
  return launches, scoring, lift


# The held-out phase: two cities of the protocol, cut to 8 examples each.
HELDOUT_CITIES = ('zurich', 'oslo')
HELDOUT_EXAMPLES = 8
HELDOUT_BATCH = 4
HELDOUT_DIR = pathlib.Path(__file__).resolve().parent / 'workdirs' / (
    'heldout_seeded')


def heldout_eval_config(overwrite: bool) -> configs.EvalConfig:
  """``eval_localization.py:evaluation_size=8,batch_size=4`` over the two
  cities, on the workdir of ``write_heldout_workdir``."""
  ec = configs.eval_localization(evaluation_size=HELDOUT_EXAMPLES,
                                 batch_size=HELDOUT_BATCH)
  return dataclasses.replace(
      ec, workdir=str(HELDOUT_DIR), overwrite=overwrite,
      data=dataclasses.replace(ec.data, split=','.join(HELDOUT_CITIES)))


def write_heldout_workdir() -> None:
  """An experiment workdir of the flagship run with seeded weights: its
  config in the reference's keys (``config.json``) and the weights as flat
  flax params (``params.npz``, ~192 MB; removed after the phase)."""
  HELDOUT_DIR.mkdir(parents=True, exist_ok=True)
  (HELDOUT_DIR / evaluator.CONFIG_FILE).write_text(json.dumps(
      configs.to_reference(configs.train_full1chip_exhaustive())))
  model = evaluate.build_model(configs.eval_full1chip_exhaustive(), 'cpu',
                                   0)
  np.savez(HELDOUT_DIR / evaluator.PARAMS_FILE, **convert.flax_from_torch(
      dict(model.named_parameters()), model))


def heldout_main_path(smi: str):
  """``evaluator.run`` of the held-out protocol (``eval_full1chip_exhaustive``:
  R50 street-view + aerial, 20 views of 180x240, 0.2 m, top-k 4 lift, 64
  rotations + dense refinement, f32 with TF32 off, batch 4) over zurich and
  oslo, 8 card-made examples a city, seeded weights; then again, from the
  dumps. Returns the first run's launches and K1's and K2's inputs."""
  write_heldout_workdir()
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  torch.cuda.reset_peak_memory_stats()
  t0 = time.perf_counter()
  with Capture(view_scan, 'lift_topk', 0) as lift, \
       Capture(view_scan, 'patch_sample_2d', 1) as sample:
    kernels.reset_launch_counts()
    first = evaluator.run(heldout_eval_config(overwrite=True), device='cuda')
    launches = dict(kernels.LAUNCHES)
  seconds = time.perf_counter() - t0
  peak = torch.cuda.max_memory_allocated()
  batches = len(HELDOUT_CITIES) * -(-HELDOUT_EXAMPLES // HELDOUT_BATCH)
  for kernel in ('lift_topk_fwd', 'patch_sample_2d'):
    if launches[kernel] < 2 * batches:
      raise AssertionError(f'held-out run: {kernel} launched '
                           f'{launches[kernel]} times for {batches} batches')
  for city in HELDOUT_CITIES:
    results, record = first[city]
    want = configs.merge_eval_config(
        heldout_eval_config(overwrite=True),
        configs.train_full1chip_exhaustive(), f'{city}-synthetic_eval')
    if configs.from_reference(record) != want:
      raise AssertionError(f'{city}: the dump\'s config is not the protocol')
    if not (want.model.do_grid_refinement and want.dtype_str == 'float32'):
      raise AssertionError(f'{city}: not the held-out protocol')
    if record['data_generator_kind'] != 'device-torch':
      raise AssertionError(f'{city}: data from '
                           f'{record["data_generator_kind"]}')
    if record['cudnn_allow_tf32'] or record['matmul_allow_tf32']:
      raise AssertionError(f'{city}: ran with TF32 on')
    for key in ('error_max_meter', 'error_max_deg', 'pose_score_max', 'loss'):
      if results[key].shape != (HELDOUT_EXAMPLES,) or not np.isfinite(
          results[key]).all():
        raise AssertionError(f'{city}: {key} {results[key]}')
  kernels.reset_launch_counts()
  t1 = time.perf_counter()
  again = evaluator.run(heldout_eval_config(overwrite=False), device='cuda')
  cached_seconds = time.perf_counter() - t1
  if any(kernels.LAUNCHES.values()):
    raise AssertionError(f'the second run launched {dict(kernels.LAUNCHES)}')
  for city in HELDOUT_CITIES:
    for key, value in first[city][0].items():
      if not np.array_equal(again[city][0][key], value):
        raise AssertionError(f'{city}: the cached {key} differs')
  (HELDOUT_DIR / evaluator.PARAMS_FILE).unlink()
  for city in HELDOUT_CITIES:
    print(json.dumps(evaluate.city_summary(city, *first[city])), flush=True)
  log(f'held-out main path (eval_full1chip_exhaustive over '
      f'{HELDOUT_CITIES}, {HELDOUT_EXAMPLES} examples a city, batch '
      f'{HELDOUT_BATCH}, f32, TF32 off, random weights): launches '
      f'{launches}; the first run {seconds:.2f} s, peak memory '
      f'{peak / 2**30:.2f} GiB; the second run read both dumps in '
      f'{cached_seconds:.3f} s with no launch, every array equal; {smi}')
  torch.cuda.empty_cache()
  return launches, lift, sample


def bench_phase(smi: str) -> dict:
  """``snap_tpu_torch.bench`` at full width (prints its JSON line); under
  PyTorch's default TF32 settings, as its entry point runs."""
  was = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
  torch.backends.cudnn.allow_tf32 = True
  torch.backends.cuda.matmul.allow_tf32 = False
  kernels.reset_launch_counts()
  line = bench.main([])
  launches = dict(kernels.LAUNCHES)
  torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = was
  if line['generator_kind'] != {'eval': 'device-torch',
                                'train': 'device-torch'}:
    raise AssertionError(f'bench data from {line["generator_kind"]}')
  for key in ('localization_queries_per_sec', 'bev_maps_per_sec',
              'train_step_sec_full_scale', 'train_step_hbm_gb', 'train_loss'):
    if not (math.isfinite(line[key]) and line[key] > 0):
      raise AssertionError(f'bench {key} = {line[key]}')
  for kernel in ('lift_topk_fwd', 'patch_sample_2d', 'lift_topk_bwd',
                 'patch_sample_2d_bwd'):
    if launches[kernel] == 0:
      raise AssertionError(f'{kernel} was not launched by the bench')
  log(f'bench: launches {launches}; {smi}')
  torch.cuda.empty_cache()
  return line


def gather_bench_phase():
  """snap_tpu_torch.bench_gather at the tool's shapes (prints its line)."""
  kernels.reset_launch_counts()
  result = bench_gather.main([])
  launches = dict(kernels.LAUNCHES)
  by_name = {s['name']: s for s in result['strategies']}
  for name, kernel in (('pallas_slice', 'slice_gather'),
                       ('pallas_dyngather', 'table_gather')):
    if launches[kernel] == 0 or by_name[name]['launches'] == 0:
      raise AssertionError(f'{kernel} was not launched by the gather bench')
  if by_name['pallas_dyngather']['max_abs_err'] != 0.0:
    raise AssertionError('table_gather differs from table[ids]')
  if not by_name['pallas_slice']['max_abs_err'] <= 0.125:
    raise AssertionError(f'slice_gather off by '
                         f'{by_name["pallas_slice"]["max_abs_err"]}')
  return launches, by_name


# Phase 7g: the trainer of a long run, in chunks, at full width.
LOOP_CADENCE = dict(checkpoint_steps=2, log_summary_steps=2, log_eval_steps=4,
                    steps_per_eval=1, max_checkpoints_to_keep=2)
LOOP_FIRST_STOP, LOOP_STOP = 2, 10
# The resumed chunk's own peak memory against the first chunk's (GiB): the
# restore must not hold a second copy of the state. (Phase 7's is logged
# beside them; its absolute peak holds tensors earlier phases keep, and
# its own takes the workspaces a process allocates once.)
LOOP_PEAK_SLACK_GIB = 0.5
CONTINUE_STEP = 12_500
# The smoke run whose loss must fall: steps, the window of each mean, and
# the most steps of a window whose loss may be non-finite.
FALL_STEPS, FALL_WINDOW, FALL_NONFINITE = 300, 50, 5


def _with_train(config: configs.Config, **changes) -> configs.Config:
  return dataclasses.replace(config, train=dataclasses.replace(
      config.train, **changes))


class _Records(logging.Handler):
  def __init__(self):
    super().__init__(logging.INFO)
    self.messages = []

  def emit(self, record):
    self.messages.append(record.getMessage())


def _states_equal(a: trainer.TrainState, b: trainer.TrainState) -> None:
  """Bit for bit: params, the moments, the count, the step and the seed."""
  for (name, p), (_, q) in zip(a.model.named_parameters(),
                               b.model.named_parameters()):
    if not torch.equal(p, q):
      raise AssertionError(f'restored {name} differs from the saved one')
  for key in ('mu', 'nu'):
    for i, (x, y) in enumerate(zip(getattr(a.opt_state, key),
                                   getattr(b.opt_state, key))):
      if not torch.equal(x, y):
        raise AssertionError(f'restored {key}[{i}] differs')
  if (a.opt_state.count, a.global_step, a.seed) != (
      b.opt_state.count, b.global_step, b.seed):
    raise AssertionError('restored counters differ')


def _steps_agree(live: trainer.StepOutput, restored: trainer.StepOutput,
                 check: bool = True):
  """Phase 5's tolerances: the loss, and each gradient leaf by its largest
  entry and its norm (raises unless ``check`` is off). Returns the losses,
  the worst leaf's errors and its name."""
  loss = [trainer.summarize([o.metrics])['loss/total']
          for o in (live, restored)]
  if check and not math.isclose(loss[0], loss[1], rel_tol=TRAIN_LOSS_RTOL):
    raise AssertionError(f'step 3: loss live {loss[0]}, restored {loss[1]}')
  worst = worst_norm = 0.0
  worst_leaf = ''
  for name, want in live.grads.items():
    want, got = want.float(), restored.grads[name].float()
    scale, norm = float(want.abs().max()), float(want.norm())
    err, err_norm = float((got - want).abs().max()), float((got - want).norm())
    if not math.isfinite(scale) or (check and not (
        err <= TRAIN_GRAD_RTOL * scale + 1e-7
        and err_norm <= TRAIN_GRAD_NORM_RTOL * norm + 1e-7)):
      raise AssertionError(f'step 3: gradient of {name} off by {err:.3g} '
                           f'(largest {scale:.3g}), {err_norm:.3g} in norm')
    if err / max(scale, 1e-30) > worst:
      worst, worst_leaf = err / max(scale, 1e-30), name
    worst_norm = max(worst_norm, err_norm / max(norm, 1e-30))
  return loss, worst, worst_norm, worst_leaf


def _bits(t: torch.Tensor) -> torch.Tensor:
  """``t``'s bits as integers of its width (NaN equals itself, -0 is not
  +0)."""
  return t.view({2: torch.int16, 4: torch.int32}[t.element_size()])


def _steps_equal(name: str, a: trainer.StepOutput,
                 b: trainer.StepOutput) -> None:
  """Bit for bit: the loss's (sum, count), the logs and every gradient
  leaf; raises naming the leaves that differ."""
  loss = [tuple(float(t) for t in o.metrics['loss/total']) for o in (a, b)]
  differ = [n for n, g in a.grads.items()
            if not torch.equal(_bits(g), _bits(b.grads[n]))]
  if loss[0] != loss[1] or a.logs != b.logs or differ:
    raise AssertionError(f'{name}: losses {loss}, logs equal '
                         f'{a.logs == b.logs}, {len(differ)} gradient '
                         f'leaves differ ({differ[:5]})')


def _step_differences(a: trainer.StepOutput, b: trainer.StepOutput) -> dict:
  """The gradient entries whose bits differ between two steps, of all, and
  the leaf whose largest difference is the largest share of its largest
  entry."""
  entries = total = 0
  worst, worst_leaf = 0.0, None
  for name, g in a.grads.items():
    h = b.grads[name]
    entries += int((_bits(g) != _bits(h)).sum())
    total += g.numel()
    scale = float(g.abs().max())
    rel = float((g - h).abs().max()) / max(scale, 1e-30)
    if rel > worst:
      worst, worst_leaf = rel, name
  return {'entries': entries, 'of': total, 'worst': worst,
          'worst_leaf': worst_leaf}


def _in_f32(config: configs.Config, state: trainer.TrainState
            ) -> trainer.TrainState:
  """``state`` (its weights, moments, counters and transform) on a model
  that computes in f32."""
  model = evaluate.build_model(
      dataclasses.replace(config, dtype_str='float32'), 'cuda', 2)
  model.load_state_dict(state.model.state_dict())
  return dataclasses.replace(state, model=model)


def write_seeded_export(path: pathlib.Path, seed: int, step: int) -> None:
  """A JAX-format experiment workdir of the flagship run: its config in the
  reference's keys, weights drawn from ``seed`` as flat flax params, and
  the step they stand for (``checkpoint.json``)."""
  path.mkdir(parents=True, exist_ok=True)
  config = configs.train_full1chip_exhaustive()
  (path / evaluator.CONFIG_FILE).write_text(json.dumps(
      configs.to_reference(config)))
  model = evaluate.build_model(config, 'cpu', seed)
  np.savez(path / evaluator.PARAMS_FILE, **convert.flax_from_torch(
      dict(model.named_parameters()), model))
  (path / evaluator.CHECKPOINT_FILE).write_text(json.dumps({'step': step}))


# Child processes of this script (``--child <mode> <args>``): each prints
# its result as one JSON object on its last line of output.
CHILD = '--child'
CHILD_TIMEOUT_S = 300


def free_port() -> int:
  import socket  # pylint: disable=g-import-not-at-top
  with socket.socket() as sock:
    sock.bind(('localhost', 0))
    return sock.getsockname()[1]


def run_children(mode: str, args, world: int = 0, env=None) -> list:
  """``world`` ranks of ``mode`` (each with ``torchrun``'s environment: one
  host, ``LOCAL_WORLD_SIZE`` = ``world``), or one process outside any
  group (``world`` 0); ``env`` added to each. Raises unless every one
  exits 0 within ``CHILD_TIMEOUT_S``; returns each one's JSON result in
  rank order."""
  port = free_port()
  procs = []
  for rank in range(max(world, 1)):
    child_env = dict(os.environ, **(env or {}))
    if world:
      child_env.update(RANK=str(rank), WORLD_SIZE=str(world),
                       LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world),
                       MASTER_ADDR='localhost', MASTER_PORT=str(port))
    procs.append(subprocess.Popen(
        [sys.executable, str(pathlib.Path(__file__).resolve()), CHILD, mode,
         *map(str, args)], env=child_env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True))
  outputs, failed = [], []
  deadline = time.monotonic() + CHILD_TIMEOUT_S
  for rank, proc in enumerate(procs):
    try:
      text, _ = proc.communicate(timeout=max(deadline - time.monotonic(), 1))
    except subprocess.TimeoutExpired:
      for other in procs:
        other.kill()
      text, _ = proc.communicate()
      failed.append(f'rank {rank} timed out')
    if proc.returncode:
      failed.append(f'rank {rank} exited {proc.returncode}:\n'
                    f'{text[-3000:]}')
    outputs.append(text)
  if failed:
    for proc in procs:
      if proc.poll() is None:
        proc.kill()
    raise AssertionError(f'{mode}: ' + '\n'.join(failed))
  return [json.loads(text.strip().splitlines()[-1]) for text in outputs]


def deterministic_child(workdir: pathlib.Path) -> dict:
  """Phase 7g's bf16 pair again, in a child process under
  ``torch.use_deterministic_algorithms(True)`` (``CUBLAS_WORKSPACE_CONFIG``
  set before CUDA starts, as cuBLAS needs in that mode): torch raises on
  any op of the step it knows to be nondeterministic."""
  result, = run_children('deterministic_step', [workdir],
                         env={'CUBLAS_WORKSPACE_CONFIG': ':4096:8'})
  return result


def _child_deterministic_step(workdir: str) -> dict:
  torch.use_deterministic_algorithms(True)
  torch.backends.cudnn.deterministic = True
  config = _with_train(configs.train_full1chip_exhaustive(), **LOOP_CADENCE)
  states = []
  for seed in (0, 1):
    model = evaluate.build_model(config, 'cuda', seed)
    model.train()
    state = trainer.create_train_state(
        model, optimizers.get_optimizer(config.train, model), seed=seed)
    checkpoints.restore_checkpoint(workdir, state, LOOP_FIRST_STOP)
    states.append(state)
  data = dataclasses.replace(config.data, shuffle_seed=prng.resume_shuffle_seed(
      config.data.shuffle_seed, LOOP_FIRST_STOP))
  with loader.get_dataset(data, config.batch_size, device='cuda',
                          start_step=LOOP_FIRST_STOP) as dataset:
    batch = next(dataset.train_iter)
  batch.pop('_host')
  kernels.reset_launch_counts()
  a, b = [trainer.train_step(state, batch, state.tx) for state in states]
  _steps_equal('step 3 under torch.use_deterministic_algorithms', a, b)
  return {'deterministic_algorithms': torch.are_deterministic_algorithms_enabled(),
          'loss': trainer.summarize([a.metrics])['loss/total'],
          'equal_bits': True, 'launches': dict(kernels.LAUNCHES)}


def trainer_loop_phase(smi: str) -> dict:
  """Phase 7g: ``train_full1chip_exhaustive`` in two chunks (steps 1-2,
  then 3-10 resumed in a new ``train`` call, traced), the held-out
  protocol on what it wrote, a warm-started continuation, and the smoke
  run's falling loss. Returns the figures PERF.md records."""
  config = _with_train(configs.train_full1chip_exhaustive(), **LOOP_CADENCE)
  workdir = fresh_workdir('loop')
  least = TRAIN_PATHS['train_full1chip_exhaustive'][0]
  out = {}

  # 1. The first chunk: steps 1-2, checkpoint 2.
  resident = torch.cuda.memory_allocated()  # earlier phases' tensors
  torch.cuda.reset_peak_memory_stats()
  model = evaluate.build_model(config, 'cuda', 0)
  first = train.train(config, None, 'cuda', 0, workdir=str(workdir),
                      model=model, stop_at_step=LOOP_FIRST_STOP)
  first_footprint = torch.cuda.max_memory_allocated() - resident
  if (list(first['checkpoints']) != [2] or list(first['summaries']) != [2]
      or list(first['evals']) != [2]):
    raise AssertionError(f'first chunk: checkpoints {first["checkpoints"]}, '
                         f'summaries {list(first["summaries"])}, evals '
                         f'{list(first["evals"])}')
  live = first['state']
  out['save'] = first['checkpoints'][2]

  # 2. The checkpoint restored into a fresh model (other seeded weights)
  # equals the first chunk's live state, bit for bit; a step from each on
  # the resumed run's batch of step 3 agrees.
  restored_model = evaluate.build_model(config, 'cuda', 1)
  restored = trainer.create_train_state(
      restored_model, optimizers.get_optimizer(config.train, restored_model),
      seed=1)
  t0 = time.perf_counter()
  checkpoints.restore_checkpoint(workdir, restored)
  torch.cuda.synchronize()
  out['restore_seconds'] = time.perf_counter() - t0
  _states_equal(live, restored)
  data = dataclasses.replace(config.data, shuffle_seed=prng.resume_shuffle_seed(
      config.data.shuffle_seed, LOOP_FIRST_STOP))
  with loader.get_dataset(data, config.batch_size, device='cuda',
                          start_step=LOOP_FIRST_STOP) as dataset:
    batch = next(dataset.train_iter)
  batch.pop('_host')
  # Phase 5's tolerances, f32's with TF32 off, on both states' step in f32.
  tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
  torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = (
      False)
  live32, restored32 = _in_f32(config, live), _in_f32(config, restored)
  step3 = _steps_agree(trainer.train_step(live32, batch, live.tx),
                       trainer.train_step(restored32, batch, restored.tx))
  del live32, restored32
  torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
  # ROADMAP C20: in bf16, with cuDNN's deterministic algorithms, the two
  # steps give the same bits (K3, K4 and the FPN's upsampling sum in fixed
  # orders); then the same pair with cuDNN free to choose, logged.
  deterministic = torch.backends.cudnn.deterministic
  torch.backends.cudnn.deterministic = True
  _steps_equal('step 3 in bf16, cudnn.deterministic on',
               trainer.train_step(live, batch, live.tx),
               trainer.train_step(restored, batch, restored.tx))
  torch.backends.cudnn.deterministic = False
  free = _step_differences(trainer.train_step(live, batch, live.tx),
                           trainer.train_step(restored, batch, restored.tx))
  step_ms = {}
  if free['entries']:  # the step's device time either way
    for setting in (True, False):
      torch.backends.cudnn.deterministic = setting
      step_ms[setting] = kernel_stages_ms(
          lambda: trainer.train_step(live, batch, live.tx), (), iters=2)[
              'other']
  torch.backends.cudnn.deterministic = deterministic
  del model, live, restored, restored_model, first, batch, dataset
  torch.cuda.empty_cache()
  out['deterministic_child'] = deterministic_child(workdir)
  log(f'trainer loop, first chunk (train_full1chip_exhaustive, batch 2, '
      f'bf16, steps 1-2): checkpoint 2 saved in {out["save"]["seconds"]:.2f} '
      f's, {out["save"]["bytes"]} bytes; restored into other weights in '
      f'{out["restore_seconds"]:.2f} s, equal bit for bit; step 3 from the '
      f'live and the restored state in f32 (TF32 off): losses {step3[0]}, '
      f'worst gradient leaf {step3[1]:.3g} of its largest entry '
      f'({step3[3]}), {step3[2]:.3g} of its norm; in bf16 with '
      f'cudnn.deterministic on: equal bits (C20); step 4 with it off: '
      f'{free} (entries whose bits differ, of all, the worst leaf); step '
      f'device ms with it on / off {step_ms or "(not timed: equal)"}; under '
      f'torch.use_deterministic_algorithms in a child process: '
      f'{out["deterministic_child"]}; {smi}')

  # 3. The second chunk, resumed in a new call: steps 3-10, traced.
  per_step = []

  def check_step(step: int, step_out: trainer.StepOutput) -> None:
    counts = dict(kernels.LAUNCHES)
    prev = per_step[-1] if per_step else {k: 0 for k in counts}
    launched = {k: counts[k] - prev[k] for k in counts}
    per_step.append(counts)
    loss = trainer.summarize([step_out.metrics])['loss/total']
    finite = all(bool(torch.isfinite(g).all())
                 for g in step_out.grads.values())
    if not (math.isfinite(loss) and finite
            and step_out.logs['is_finite'] == 1.0):
      raise AssertionError(f'resumed step {step}: loss {loss}, finite '
                           f'gradients {finite}')
    for kernel, fewest in least.items():
      if launched[kernel] < fewest:
        raise AssertionError(f'resumed step {step}: {kernel} launched '
                             f'{launched[kernel]} times')

  records = _Records()
  logging.getLogger('snap_tpu_torch').addHandler(records)
  logging.getLogger('snap_tpu_torch').setLevel(logging.INFO)
  resident = torch.cuda.memory_allocated()  # earlier phases' tensors
  torch.cuda.reset_peak_memory_stats()
  kernels.reset_launch_counts()
  try:
    second = train.train(config, None, 'cuda', 0, workdir=str(workdir),
                         on_step=check_step, stop_at_step=LOOP_STOP)
  finally:
    logging.getLogger('snap_tpu_torch').removeHandler(records)
  peak = torch.cuda.max_memory_allocated()
  fold = f'Folding global_step {LOOP_FIRST_STOP} into dataset seed.'
  if fold not in records.messages or second['start_step'] != LOOP_FIRST_STOP:
    raise AssertionError(f'no resume from step {LOOP_FIRST_STOP}: start '
                         f'{second["start_step"]}')
  trace = second['trace']
  expected = {'summaries': [4, 6, 8, 10], 'evals': [4, 8, 10],
              'checkpoints': [4, 6, 8, 10]}
  for key, steps in expected.items():
    if sorted(second[key]) != steps:
      raise AssertionError(f'resumed run: {key} at {sorted(second[key])}')
  if checkpoints.all_steps(workdir) != [8, 10]:
    raise AssertionError(f'on disk: {checkpoints.all_steps(workdir)}')
  progress = json.loads((workdir / 'progress.json').read_text())
  if progress['step'] != LOOP_STOP:
    raise AssertionError(f'progress.json: {progress}')
  if trace is None or trace['steps'] != [6, 10] or not pathlib.Path(
      trace['path']).exists() or not trace['device_events']:
    raise AssertionError(f'trace: {trace}')
  for step, summary in second['summaries'].items():
    if not math.isfinite(summary['loss/total']):
      raise AssertionError(f'summary {step}: {summary}')
  footprint = peak - resident
  slack = (footprint - first_footprint) / 2**30
  ms = [1e3 * t for t in second['step_seconds']]
  out.update(step3=step3, cudnn_free=free, resumed_ms=ms, trace=trace,
             peak_gib=footprint / 2**30,
             checkpoints=second['checkpoints'],
             resumed_restore_seconds=second['restore_seconds'])
  log(f'trainer loop, the resumed call (steps 3-10, data seed '
      f'{second["shuffle_seed"]}) restored in '
      f'{second["restore_seconds"]:.2f} s, saved {second["checkpoints"]}, '
      f'kept {checkpoints.all_steps(workdir)}; summaries at '
      f'{sorted(second["summaries"])} (loss '
      f'{[round(v["loss/total"], 4) for v in second["summaries"].values()]},'
      f' steps/s {[v["steps_per_sec"] for v in second["summaries"].values()]}'
      f'), evals at {sorted(second["evals"])}; ms per step {ms} (steps 3-5 '
      f'before the trace, 6-10 traced); trace {trace}; peak '
      f'{peak / 2**30:.2f} GiB, of it {footprint / 2**30:.2f} GiB its own '
      f'({slack:+.3f} GiB from the first chunk\'s own '
      f'{first_footprint / 2**30:.2f}; phase 7\'s own '
      f'{TRAIN_PEAK["train_full1chip_exhaustive"] / 2**30:.2f}); '
      f'launches {dict(kernels.LAUNCHES)}; {smi}')
  if abs(slack) > LOOP_PEAK_SLACK_GIB:
    raise AssertionError(f'the resumed steps\' own peak '
                         f'{footprint / 2**30:.2f} GiB is {slack:+.2f} GiB '
                         'from the first chunk\'s')
  del second
  torch.cuda.empty_cache()

  # 4. The held-out protocol on the checkpoint the run wrote.
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  ec = dataclasses.replace(heldout_eval_config(overwrite=True),
                           workdir=str(workdir))
  kernels.reset_launch_counts()
  evaluated = evaluator.run(ec, device='cuda')
  for kernel in ('lift_topk_fwd', 'patch_sample_2d'):
    if kernels.LAUNCHES[kernel] == 0:
      raise AssertionError(f'the held-out run did not launch {kernel}')
  for city, (results, record) in evaluated.items():
    if record['eval_checkpoint_step'] != LOOP_STOP:
      raise AssertionError(f'{city}: evaluated step '
                           f'{record["eval_checkpoint_step"]}')
    if not np.isfinite(results['error_max_meter']).all():
      raise AssertionError(f'{city}: non-finite errors')
    print(json.dumps(evaluate.city_summary(city, results, record)),
          flush=True)
  log(f'held-out protocol on the trained checkpoint: step '
      f'{LOOP_STOP} of {workdir.name}, launches {dict(kernels.LAUNCHES)}')
  shutil.rmtree(workdir)

  # 5. The warm start of a continuation from a JAX-format export.
  export = fresh_workdir('export')
  write_seeded_export(export, seed=1, step=CONTINUE_STEP)
  with np.load(export / evaluator.PARAMS_FILE) as npz:
    exported = convert.params_from_flax(dict(npz))
  warm = _with_train(configs.get_config(
      f'train_full1chip_exhaustive:continue_step={CONTINUE_STEP},'
      f'pretrained_mapper={export}'), checkpoint=False)
  init = evaluate.build_model(warm, 'cpu', 0).state_dict()
  seen = {}

  def check_warm(step: int, step_out: trainer.StepOutput) -> None:
    if step:
      return
    seen['lr'] = step_out.logs['learning_rate']
    for name, p in seen['model'].named_parameters():
      want = exported[name] if name.startswith('bev_mapper.') else init[name]
      if not torch.equal(p.detach().cpu(), want):
        raise AssertionError(f'warm start: {name} is not the expected '
                             'weight after the lr-0 step')
    seen['checked'] = len(init)

  seen['model'] = evaluate.build_model(warm, 'cuda', 0)
  kernels.reset_launch_counts()
  warm_run = train.train(warm, None, 'cuda', 0, model=seen['model'],
                         workdir=str(fresh_workdir('warm')), stop_at_step=2,
                         on_step=check_warm)
  if seen.get('lr') != 0.0 or not seen.get('checked'):
    raise AssertionError(f'warm start: lr of step 0 {seen.get("lr")}')
  if warm_run['shuffle_seed'] != configs.SHUFFLE_SEED + CONTINUE_STEP:
    raise AssertionError(f'continuation data seed {warm_run["shuffle_seed"]}')
  log(f'warm start (continue_step={CONTINUE_STEP} from a seeded JAX-format '
      f'export): {seen["checked"]} parameters as expected after the lr-0 '
      f'step (the mapper the export\'s, the rest the seeded init); lr '
      f'{[l["learning_rate"] for l in warm_run["logs"]]}; losses '
      f'{[round(v["loss/total"], 4) for v in warm_run["summaries"].values()]}'
      f'; schedule of {warm.train.num_training_steps} steps; launches '
      f'{dict(kernels.LAUNCHES)}')
  del seen, init, exported, warm_run
  shutil.rmtree(export)
  shutil.rmtree(WORKDIRS / 'chip_smoke_warm')
  torch.cuda.empty_cache()

  # 6. The loss falls: the smoke trainer over FALL_STEPS steps.
  smoke = _with_train(configs.smoke_train_exhaustive(), checkpoint=False,
                      num_training_steps=FALL_STEPS, xprof=False,
                      log_summary_steps=FALL_WINDOW, log_eval_steps=FALL_STEPS)
  losses = []
  fall_dir = fresh_workdir('fall')
  train.train(smoke, None, 'cuda', 0, workdir=str(fall_dir),
              on_step=lambda step, o: losses.append(
                  trainer.summarize([o.metrics])['loss/total']))
  shutil.rmtree(fall_dir)
  # A step whose batch holds an example with a non-finite loss (its
  # gradients finite, the step taken) sums to NaN, as the reference's
  # reduce_metrics does (v * mask; ROADMAP C21): the means are over the
  # window's finite steps, nearly all of them.
  windows = [np.asarray(losses[:FALL_WINDOW]),
             np.asarray(losses[-FALL_WINDOW:])]
  finite = [w[np.isfinite(w)] for w in windows]
  skipped = [i for i, loss in enumerate(losses) if not math.isfinite(loss)]
  if min(len(f) for f in finite) < FALL_WINDOW - FALL_NONFINITE:
    raise AssertionError(f'smoke run: non-finite losses at steps {skipped}')
  head, tail = (float(f.mean()) for f in finite)
  if not tail < head:
    raise AssertionError(f'smoke loss did not fall: {head} -> {tail}')
  out['fall'] = (head, tail, skipped)
  log(f'loss falls (smoke_train_exhaustive, {FALL_STEPS} steps on the card): '
      f'mean of steps 1-{FALL_WINDOW} {head}, of the last {FALL_WINDOW} '
      f'{tail} (over their finite steps; the loss is not finite at steps '
      f'{skipped}, counted from 0)')
  return out


def heads_reference() -> None:
  """Phase 5d: the heads and the three-modality localizer, card against
  CPU as phase 5 (f32, TF32 off, lockstep, the card's draws injected): the
  semantic head with its flips and modality dropout, trained whole (K1 and
  K3 each card step); the occupancy head on a frozen street-view encoder,
  as ``train_occupancy`` freezes it (K1 each card step, K3 never); the
  localizer on street views, the aerial and the semantic rasters."""
  occupancy = configs.merge(configs.smoke_occupancy(), {
      'model': {'stop_encoder_gradients': True},
      'train': {'optimizer_configs': configs.OptimizerConfig(
          freeze_params_reg_exp=r'streetview_encoder/',
          allocate_frozen_state=False)}})
  lift = ('lift_topk_fwd', 'lift_topk_bwd')
  training_reference('smoke_semantics', least=lift)
  training_reference('smoke_occupancy, frozen street-view encoder',
                     occupancy, least=lift[:1],
                     never=('lift_topk_bwd', 'patch_sample_2d',
                            'patch_sample_2d_bwd'))
  training_reference(f'smoke_train_exhaustive:modalities={THREE_MODALITIES}',
                     least=tuple(TRAIN_PATHS['train_full1chip_exhaustive'][0]))


# Phase 5e / 7i: the mapper options the flagship does not use.
MAP_HEAD = 'bev_mapper.confidence_head.'
QUERY_HEAD = 'bev_mapper_query.confidence_head.'
EXHAUSTIVE_KERNELS = ('lift_topk_fwd', 'patch_sample_2d', 'lift_topk_bwd',
                      'patch_sample_2d_bwd')


def with_confidence(config: configs.Config) -> configs.Config:
  return configs.merge(config, {'model': {'add_confidence_query': True}})


def a14_reference() -> None:
  """Phase 5e: as phase 5 (f32, TF32 off, 2 steps in lockstep, the card's
  draws injected on the CPU, its max choices replayed), the tiny
  aerial-only localizer with its street-view query mapper and ``bev_net``;
  query confidence on each backend (on the aerial-only map, whose
  confidence head takes no gradient on either device, and the query's
  does); the street-view column pooled ``'weighted'`` with the modalities
  fused ``'softmax'``; the column pooled by ``'mlp'``."""
  aerial = 'smoke_train_exhaustive:modalities=aerial'
  heads = dict(zero=(MAP_HEAD,), nonzero=(QUERY_HEAD,))
  training_reference(f'{aerial},bev_net=1', least=EXHAUSTIVE_KERNELS,
                     nonzero=('bev_mapper.bev_net.',
                              'bev_mapper_query.streetview_encoder.'))
  training_reference(f'{aerial}, add_confidence_query',
                     with_confidence(configs.get_config(aerial)),
                     least=EXHAUSTIVE_KERNELS, **heads)
  training_reference(
      'smoke_train_ransac:modalities=aerial, add_confidence_query',
      with_confidence(configs.smoke_train_ransac(modalities='aerial')),
      **heads)
  smoke = configs.smoke_train_exhaustive()
  training_reference(
      'smoke_train_exhaustive, pooling weighted, fusion softmax',
      configs.merge(smoke, {'model': {'bev_mapper': {
          'pooling': configs.VerticalPoolingConfig('weighted'),
          'modality_fusion': configs.VerticalPoolingConfig('softmax')}}}),
      least=EXHAUSTIVE_KERNELS,
      # The fusion's head takes a gradient only on a step whose draws keep
      # both modalities of an example: its kernel is compared, not required
      # to move.
      nonzero=('bev_mapper.vertical_pooling.confidence_head.',),
      shift_free=('bev_mapper.modality_fusion.confidence_head.bias',))
  dim = smoke.model.bev_mapper.streetview_encoder.feature_dim
  training_reference(
      'smoke_train_exhaustive, pooling mlp',
      configs.merge(smoke, {'model': {'bev_mapper': {
          'pooling': configs.VerticalPoolingConfig(
              'mlp', configs.MLPConfig(layers=(2 * dim, dim)))}}}),
      least=EXHAUSTIVE_KERNELS,
      nonzero=('bev_mapper.vertical_pooling.fusion_mlp.',))


# Phase 7i: the aerial-only run's evaluation, 2 batches of zurich.
A14_EVAL_EXAMPLES, A14_EVAL_BATCH = 4, 2


def a14_main_path(smi: str) -> None:
  """Phase 7i, at full width on seeded weights in bf16, batch 2:
  ``train_full1chip_exhaustive:modalities=aerial`` (the aerial R50 map, the
  query through its own 20-view street-view mapper at 180x240, 0.2 m), 3
  steps, then ``evaluator.run`` of its workdir on 2 batches (f32, dense
  refinement); the flagship with ``bev_net=1`` and ``add_confidence_query``
  (map and query share its mapper, so one confidence head serves both), 3
  steps; each with phase 7's checks per step, its launches, 2 more steps
  traced for their device ms, and its own peak memory."""
  aerial = 'train_full1chip_exhaustive:modalities=aerial'

  def evaluate_workdir(workdir: pathlib.Path) -> None:
    ec = configs.eval_localization(evaluation_size=A14_EVAL_EXAMPLES,
                                   batch_size=A14_EVAL_BATCH)
    ec = dataclasses.replace(ec, workdir=str(workdir), data=dataclasses.replace(
        ec.data, split='zurich'))
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    (city, (results, record)), = evaluator.run(ec, device='cuda').items()
    seconds = time.perf_counter() - t0
    batches = A14_EVAL_EXAMPLES // A14_EVAL_BATCH
    if (kernels.LAUNCHES['lift_topk_fwd'] < batches
        or kernels.LAUNCHES['patch_sample_2d'] < batches):
      raise AssertionError(f'{aerial} eval launched {dict(kernels.LAUNCHES)}')
    if record['eval_checkpoint_step'] != 3:
      raise AssertionError(f'{aerial} eval read step '
                           f'{record["eval_checkpoint_step"]}')
    for key in ('error_max_meter', 'error_max_deg'):
      if results[key].shape != (A14_EVAL_EXAMPLES,) or not np.isfinite(
          results[key]).all():
        raise AssertionError(f'{aerial} eval: {key} {results[key]}')
    print(json.dumps(evaluate.city_summary(city, results, record)),
          flush=True)
    log(f'{aerial}: evaluator.run of its workdir on {city} '
        f'({A14_EVAL_EXAMPLES} examples at batch {A14_EVAL_BATCH}, f32, '
        f'dense refinement) of step 3: {seconds:.2f} s, launches '
        f'{dict(kernels.LAUNCHES)}; {smi}')

  training_main_path(smi, aerial, after=evaluate_workdir, traced_steps=2,
                     nonzero=('bev_mapper_query.streetview_encoder.',
                              'bev_mapper.aerial_encoder.'))
  name = 'train_full1chip_exhaustive:bev_net=1, add_confidence_query'
  config = with_confidence(configs.get_config(
      'train_full1chip_exhaustive:bev_net=1'))
  if config.model.bev_mapper.bev_net is None or (
      config.model.bev_mapper_query is not None):
    raise AssertionError(f'{name}: {config.model}')
  training_main_path(smi, name, config, traced_steps=2,
                     nonzero=('bev_mapper.bev_net.unit01.',
                              'bev_mapper.bev_net.unit02.', MAP_HEAD))


# Phase 5f / 7j / 8: the lift's other forms (A14, item 5), as the street-view
# encoder's keys of each run; the gather form's depth MLP is (D, D).
A145_FORMS = {
    'stream, [mean, var, max, min, score_max]': dict(fusion_add_minmax=True),
    'scan, unweighted [mean, var]': dict(pooling_impl='scan',
                                         do_weighted_fusion=False),
    'gather, depth MLP, unweighted [mean, max, min]': dict(
        pooling_impl='gather', do_weighted_fusion=False,
        fusion_use_variance=False, fusion_add_minmax=True),
}
DEPTH_MLP = 'bev_mapper.streetview_encoder.depth_mlp.'


def with_lift_form(config: configs.Config, form: str) -> configs.Config:
  """``config`` with the street-view encoder's keys of ``form``, as the
  reference's ``--config.model.bev_mapper.streetview_encoder.*``
  overrides set them."""
  keys = dict(A145_FORMS[form])
  if form.startswith('gather'):
    dim = config.model.bev_mapper.streetview_encoder.image_encoder.output_dim
    keys['depth_mlp'] = configs.MLPConfig(layers=(dim, dim))
  return configs.merge(config, {'model': {'bev_mapper': {
      'streetview_encoder': keys}}})


def a145_reference() -> None:
  """Phase 5f: as phase 5 (f32, TF32 off, 2 steps in lockstep, the card's
  draws injected on the CPU, its max choices replayed), the tiny localizer
  with each of the lift's other forms: the stream with the max and min
  (K1-K4 each card step), the scan unweighted (K1-K4), the gather form with
  a depth MLP (K2 and K4; K1 and K3 never; the depth MLP takes a
  gradient)."""
  smoke = configs.smoke_train_exhaustive()
  for form in A145_FORMS:
    gather = form.startswith('gather')
    training_reference(
        f'smoke_train_exhaustive, {form}', with_lift_form(smoke, form),
        least=EXHAUSTIVE_KERNELS[1::2] if gather else EXHAUSTIVE_KERNELS,
        never=EXHAUSTIVE_KERNELS[0::2] if gather else (),
        nonzero=(DEPTH_MLP,) if gather else ())


def a145_main_path(smi: str):
  """Phase 7j, at full width on seeded weights in bf16, batch 2:
  ``train_full1chip_exhaustive`` with each of the lift's other forms, 3
  steps with phase 7's checks per step and its launches (B8's K1 and K3 on
  map and query for the stream and the scan, none for the gather form,
  whose depth MLP takes a gradient), 2 more steps traced for their device
  ms, and its own peak memory. Returns per lifted form its launches and
  the captured inputs of K1 and K3."""
  runs = {}
  for form in A145_FORMS:
    name = f'train_full1chip_exhaustive, {form}'
    config = with_lift_form(configs.train_full1chip_exhaustive(), form)
    gather = form.startswith('gather')
    out = training_main_path(smi, name, config, traced_steps=2,
                             nonzero=(DEPTH_MLP,) if gather else ())
    if not gather:
      runs[form] = out
  return runs


# K1-K4 and, by position, the arguments whose dtype a call computes in: the
# stack, the plane, the backward's cotangent (the rest are f32, int32 or
# bool in every dtype).
KERNEL_DTYPE_ARGS = {'lift_topk_fwd': (0,), 'patch_sample_2d': (0,),
                     'lift_topk_bwd': (0, 5), 'patch_sample_2d_bwd': (0,)}


class KernelDtypes:
  """Counts the calls of each wrapper of KERNEL_DTYPE_ARGS by the dtypes
  of those arguments: a context manager, the wrappers restored on exit."""

  def __init__(self):
    self.seen = {name: {} for name in KERNEL_DTYPE_ARGS}
    self._wrapped = {}

  def __enter__(self):
    for name, at in KERNEL_DTYPE_ARGS.items():
      wrapped = self._wrapped[name] = getattr(kernels, name)

      def call(*args, _name=name, _at=at, _wrapped=wrapped, **kwargs):
        key = tuple(str(args[i].dtype)[6:] for i in _at)
        self.seen[_name][key] = self.seen[_name].get(key, 0) + 1
        return _wrapped(*args, **kwargs)
      setattr(kernels, name, call)
    return self

  def __exit__(self, *exc):
    for name, wrapped in self._wrapped.items():
      setattr(kernels, name, wrapped)

  def assert_only(self, dtype: torch.dtype, where: str,
                  names=tuple(KERNEL_DTYPE_ARGS)) -> dict:
    """Every call was in ``dtype`` and each wrapper of ``names`` was
    called; returns their counts."""
    want = str(dtype)[6:]
    for name, seen in self.seen.items():
      if (name in names and not seen) or set(seen) - {
          (want,) * len(KERNEL_DTYPE_ARGS[name])}:
        raise AssertionError(f'{where}: {name} called with {seen}, expected '
                             f'{want} calls only')
    return {name: sum(self.seen[name].values()) for name in names}


# Phase 7k: the flagship run in f16 with the loss scale.
F16_STEPS = 12
# The first finite step comes by this step at the latest: by then eight
# back-offs from 65536 reach the floor of 256.
F16_FINITE_BY = 9
F16_EVAL_EXAMPLES, F16_EVAL_BATCH = 4, 2


def checkpoint_pair(config: configs.Config, workdir: pathlib.Path) -> dict:
  """Two train steps, each from the latest checkpoint of ``workdir``
  restored into a model of other seeded weights, on the resumed run's
  first batch, with cuDNN's deterministic algorithms: the gradient entries
  whose bits differ, and each step's (is_finite, loss scale)."""
  states = []
  for seed in (1, 2):
    model = evaluate.build_model(config, 'cuda', seed)
    model.train()
    state = trainer.create_train_state(
        model, optimizers.get_optimizer(config.train, model), seed=seed,
        dynamic_scale=dynamic_scale.for_dtype(config.dtype_str))
    step = checkpoints.restore_checkpoint(workdir, state)
    states.append(state)
  data = dataclasses.replace(config.data, shuffle_seed=prng.resume_shuffle_seed(
      config.data.shuffle_seed, step))
  with loader.get_dataset(data, config.batch_size, device='cuda',
                          start_step=step) as dataset:
    batch = next(dataset.train_iter)
  batch.pop('_host')
  deterministic = torch.backends.cudnn.deterministic
  torch.backends.cudnn.deterministic = True
  a, b = [trainer.train_step(state, batch, state.tx) for state in states]
  torch.backends.cudnn.deterministic = deterministic
  return {'step': step, **_step_differences(a, b),
          'scales': [(o.logs['is_finite'], o.logs.get('loss_scale'))
                     for o in (a, b)]}


def f16_main_path(smi: str):
  """Phase 7k: ``train_full1chip_exhaustive`` with ``dtype_str='float16'``
  (seeded weights, batch 2), F16_STEPS steps: the loss scale's sequence
  by the flax rule from 65536, a finite step by F16_FINITE_BY, finite
  losses and gradients on the finite steps, unmoved parameters on the
  others, K1-K4 each step and every call in f16; 2 more steps (resumed,
  the scale restored) traced for their device ms and idle share; the
  run's own peak memory; then ``evaluator.run`` of its workdir in f16 on
  F16_EVAL_EXAMPLES examples of zurich at batch F16_EVAL_BATCH, finite
  errors, K1 and K2 each batch, all in f16. Returns the launches of the
  steps and of the evaluation, and the captured inputs of K1 and K2 (the
  evaluation's) and K3 and K4 (the steps')."""
  name = 'train_full1chip_exhaustive, float16'
  config = dataclasses.replace(configs.train_full1chip_exhaustive(),
                               dtype_str='float16')
  least = TRAIN_PATHS['train_full1chip_exhaustive'][0]
  resident = torch.cuda.memory_allocated()
  model = evaluate.build_model(config, 'cuda', 0)
  params = dict(model.named_parameters())
  flat = lambda: torch.cat([p.detach().flatten() for p in params.values()])
  before, per_step, steps = [flat()], [], []
  expected = dynamic_scale.for_dtype(config.dtype_str)

  def check_step(step: int, out: trainer.StepOutput) -> None:
    nonlocal expected
    counts = dict(kernels.LAUNCHES)
    prev = per_step[-1] if per_step else {k: 0 for k in counts}
    launched = {k: counts[k] - prev[k] for k in counts}
    per_step.append(counts)
    finite = out.logs['is_finite'] == 1.0
    expected = expected.update(finite)
    loss = trainer.summarize([out.metrics])['loss/total']
    if out.logs['loss_scale'] != expected.scale:
      raise AssertionError(f'step {step}: loss scale {out.logs} against the '
                           f'rule\'s {expected}')
    after = flat()
    moved = float((after - before[-1]).abs().max())
    before.append(after)
    if finite and not (math.isfinite(loss) and math.isfinite(
        out.logs['l2_grads'])):
      raise AssertionError(f'step {step}: finite step, loss {loss}, logs '
                           f'{out.logs}')
    if not finite and moved:
      raise AssertionError(f'step {step}: skipped, but params moved {moved}')
    if finite and out.logs['learning_rate'] > 0 and not moved > 0:
      raise AssertionError(f'step {step}: finite, lr > 0, params still')
    for kernel, fewest in least.items():
      if launched[kernel] < fewest:
        raise AssertionError(f'step {step}: {kernel} launched '
                             f'{launched[kernel]} times, expected >= {fewest}')
    steps.append((step, finite, out.logs['loss_scale'], loss,
                   out.logs['l2_grads'], moved))
    log(f'f16 train step {step}: is_finite {finite}, loss scale '
        f'{out.logs["loss_scale"]}, loss {loss:.4f}, l2_grads '
        f'{out.logs["l2_grads"]:.4g}, lr {out.logs["learning_rate"]:.3g}, '
        f'params moved {moved:.3g}; launches {launched}')

  workdir = fresh_workdir('f16')
  torch.cuda.reset_peak_memory_stats()
  with contextlib.ExitStack() as stack:
    captures = [stack.enter_context(Capture(kernels, kernel, 0))
                for kernel in ('lift_topk_bwd', 'patch_sample_2d_bwd')]
    dtypes = stack.enter_context(KernelDtypes())
    kernels.reset_launch_counts()
    result = train.train(config, F16_STEPS, 'cuda', seed=0, model=model,
                         on_step=check_step, workdir=workdir)
  calls = dtypes.assert_only(torch.float16, name)
  train_launches = dict(per_step[-1])
  peak = torch.cuda.max_memory_allocated() - resident
  finite = [s[1] for s in steps]
  if not any(finite[:F16_FINITE_BY]):
    raise AssertionError(f'{name}: no finite step in the first '
                         f'{F16_FINITE_BY}: {steps}')
  if result['generator_kind'] != 'device-torch':
    raise AssertionError(f'training data from {result["generator_kind"]}')
  with torch.profiler.profile(activities=[
      torch.profiler.ProfilerActivity.CPU,
      torch.profiler.ProfilerActivity.CUDA]) as prof:
    t0 = time.perf_counter()
    resumed = train.train(config, 2, 'cuda', seed=0, model=model,
                          workdir=workdir)
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0)
  prof.export_chrome_trace(str(workdir / 'traced.json'))
  device_ms = trainer.step_device_ms(workdir / 'traced.json')
  split = trainer.trace_split(workdir / 'traced.json', wall_ms)
  resumed_scales = [(l['is_finite'], l['loss_scale'])
                    for l in resumed['logs']]
  pair = checkpoint_pair(config, workdir)
  ms = [1e3 * t for t in result['step_seconds']]
  log(f'f16 training main path ({name}, batch 2): (step, is_finite, loss '
      f'scale, loss, l2_grads, params moved) {steps}; the scale follows '
      f'flax\'s rule from 65536; kernel calls, all f16, {calls}; launches '
      f'{train_launches}; ms per step {ms}; own peak memory '
      f'{peak / 2**30:.2f} GiB; 2 resumed steps (is_finite, loss scale) '
      f'{resumed_scales}, traced: device ms a step {device_ms}, the '
      f'steps\' wall ms {split["steps_ms"]:.1f}, idle share '
      f'{split["idle_share"]}; C20 in f16, two steps from its last '
      f'checkpoint on one batch with cudnn.deterministic on (logged, not '
      f'held): {pair}; {smi}')
  ec = configs.eval_localization(evaluation_size=F16_EVAL_EXAMPLES,
                                 batch_size=F16_EVAL_BATCH)
  ec = dataclasses.replace(ec, workdir=str(workdir), dtype_str='float16',
                           data=dataclasses.replace(ec.data, split='zurich'))
  with contextlib.ExitStack() as stack:
    serving = [stack.enter_context(Capture(kernels, kernel, 0))
               for kernel in ('lift_topk_fwd', 'patch_sample_2d')]
    dtypes = stack.enter_context(KernelDtypes())
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    (city, (results, record)), = evaluator.run(ec, device='cuda').items()
    seconds = time.perf_counter() - t0
  eval_launches = dict(kernels.LAUNCHES)
  calls = dtypes.assert_only(torch.float16, f'{name} eval',
                             ('lift_topk_fwd', 'patch_sample_2d'))
  batches = F16_EVAL_EXAMPLES // F16_EVAL_BATCH
  if (eval_launches['lift_topk_fwd'] < batches
      or eval_launches['patch_sample_2d'] < batches):
    raise AssertionError(f'{name} eval launched {eval_launches}')
  if (record['eval_checkpoint_step'] != F16_STEPS + 2
      or record['dtype_str'] != 'float16'):
    raise AssertionError(f'{name} eval: {record}')
  for key in ('error_max_meter', 'error_max_deg'):
    if results[key].shape != (F16_EVAL_EXAMPLES,) or not np.isfinite(
        results[key]).all():
      raise AssertionError(f'{name} eval: {key} {results[key]}')
  print(json.dumps(evaluate.city_summary(city, results, record)), flush=True)
  log(f'{name}: evaluator.run of its workdir on {city} '
      f'({F16_EVAL_EXAMPLES} examples at batch {F16_EVAL_BATCH}, f16, '
      f'dense refinement) of step {record["eval_checkpoint_step"]}: '
      f'{seconds:.2f} s, kernel calls, all f16, {calls}, launches '
      f'{eval_launches}; {smi}')
  shutil.rmtree(workdir)
  del model, params, before, result
  return (train_launches, eval_launches, *serving, *captures)


# Phase 7h: each head's steps from a seeded export, and the kernels a head
# step may launch (K1 for the frozen part's forward) and may not.
HEAD_STEPS = 3
HEAD_NEVER = ('patch_sample_2d', 'lift_topk_bwd', 'patch_sample_2d_bwd')
HEAD_EVAL_EXAMPLES = 2


def _head_run(smi: str, name: str, config: configs.Config,
              exported: dict, adopted: str, exported_prefix: str, head: str):
  """``config`` (a head warm-started from the seeded export), HEAD_STEPS
  steps and the trainer's eval and checkpoint at the last: finite losses,
  K1 at least once a step and none of HEAD_NEVER; after the last step every
  parameter under ``adopted`` is the export's (under ``exported_prefix``)
  bit for bit, and every one under ``head`` has moved. Returns the run's
  result and its workdir."""
  resident = torch.cuda.memory_allocated()  # earlier phases' tensors
  torch.cuda.reset_peak_memory_stats()
  model = evaluate.build_model(config, 'cuda', 0)
  params = dict(model.named_parameters())
  start = {n: p.detach().clone() for n, p in params.items()
           if n.startswith(head)}
  per_step = []

  def check_step(step: int, out: trainer.StepOutput) -> None:
    counts = dict(kernels.LAUNCHES)
    prev = per_step[-1] if per_step else {k: 0 for k in counts}
    launched = {k: counts[k] - prev[k] for k in counts}
    per_step.append(counts)
    loss = trainer.summarize([out.metrics])['loss/total']
    if not (math.isfinite(loss) and out.logs['is_finite'] == 1.0):
      raise AssertionError(f'{name} step {step}: loss {loss}, logs '
                           f'{out.logs}')
    if launched['lift_topk_fwd'] < 1 or any(launched[k] for k in HEAD_NEVER):
      raise AssertionError(f'{name} step {step}: launched {launched}')
    log(f'{name} step {step}: loss {loss:.4f}, l2_grads '
        f'{out.logs["l2_grads"]:.4g}, lr {out.logs["learning_rate"]:.3g}; '
        f'launches {launched}')

  workdir = fresh_workdir(name)
  kernels.reset_launch_counts()
  result = train.train(config, None, 'cuda', 0, model=model,
                       workdir=str(workdir), on_step=check_step,
                       stop_at_step=HEAD_STEPS)
  footprint = torch.cuda.max_memory_allocated() - resident
  adopted_names = [n for n in params if n.startswith(adopted)]
  if not adopted_names:
    raise AssertionError(f'{name}: no parameter under {adopted}')
  for n in adopted_names:
    want = exported[exported_prefix + n[len(adopted):]]
    if not torch.equal(params[n].detach().cpu(), want):
      raise AssertionError(f'{name}: {n} is not the export\'s after '
                           f'{HEAD_STEPS} steps')
  still = [n for n, p in start.items() if torch.equal(params[n].detach(), p)]
  if not start or still:
    raise AssertionError(f'{name}: head parameters that did not move: '
                         f'{still}')
  ms = [1e3 * t for t in result['step_seconds']]
  log(f'{name} ({config.batch_size} a step, {config.dtype_str}): '
      f'{len(adopted_names)} adopted parameters the export\'s, bit for bit, '
      f'after step {HEAD_STEPS}; {len(start)} head parameters moved; ms per '
      f'step {ms}, with the wait for its batch '
      f'{[1e3 * t for t in result["wall_seconds"]]}, build ms (host) '
      f'{result["build_ms"]}, (card) {result["build_card_ms"]}, data '
      f'{result["generator_kind"]}; the eval at step {HEAD_STEPS} '
      f'{result["eval_summary"]}, checkpoint {result["checkpoints"]}; own '
      f'peak memory {footprint / 2**30:.2f} GiB (the card\'s '
      f'{torch.cuda.max_memory_allocated() / 2**30:.2f}); {smi}')
  if result['generator_kind'] != 'device-torch':
    raise AssertionError(f'{name}: data from {result["generator_kind"]}')
  del model, params, start
  torch.cuda.empty_cache()
  return result, workdir


def heads_main_path(smi: str) -> None:
  """Phase 7h: the heads at full width on a seeded JAX-format export of
  the flagship run. ``train_semantics`` (R50 street-view + aerial mapper,
  20 views of 180x240, 0.2 m, bf16, batch 1, a ``resnet_stage`` decoder of
  width 256 with 2 units) and then ``evaluator.run`` of ``eval_semantics``
  on 2 examples; ``train_occupancy`` (10,000 rays x 100 samples into the
  [1, 120, 160, 60, 128] volume, batch 1) with an in-loop eval of 1 batch
  at eval batch 2; the localizer with the semantic modality (phase 7's
  path and checks, its semantic trunk's gradient)."""
  export = fresh_workdir('heads_export')
  write_seeded_export(export, seed=1, step=CONTINUE_STEP)
  with np.load(export / evaluator.PARAMS_FILE) as npz:
    exported = convert.params_from_flax(dict(npz))

  semantics = _with_train(configs.get_config(
      f'train_semantics:pretrained_mapper={export}'), steps_per_eval=1)
  _, workdir = _head_run(smi, 'train_semantics', semantics, exported,
                         'bev_mapper.', 'bev_mapper.', 'decoder.')
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  ec = dataclasses.replace(
      configs.eval_semantics(evaluation_size=HEAD_EVAL_EXAMPLES,
                             batch_size=HEAD_EVAL_EXAMPLES),
      workdir=str(workdir))
  kernels.reset_launch_counts()
  t0 = time.perf_counter()
  (city, (results, record)), = evaluator.run(ec, device='cuda').items()
  seconds = time.perf_counter() - t0
  if kernels.LAUNCHES['lift_topk_fwd'] < 1:
    raise AssertionError(f'eval_semantics launched {dict(kernels.LAUNCHES)}')
  if record['eval_checkpoint_step'] != HEAD_STEPS:
    raise AssertionError(f'eval_semantics read step '
                         f'{record["eval_checkpoint_step"]}')
  keys = [k for k in results if k.startswith(('semantics/', 'gt_counts/'))]
  if not any(k.startswith('gt_counts/') for k in keys):
    raise AssertionError(f'eval_semantics dump: {sorted(results)}')
  for key in keys:
    if results[key].shape != (HEAD_EVAL_EXAMPLES,) or not np.isfinite(
        results[key]).all():
      raise AssertionError(f'eval_semantics: {key} {results[key]}')
  print(json.dumps(evaluate.city_summary(city, results, record)), flush=True)
  log(f'eval_semantics on {city} ({HEAD_EVAL_EXAMPLES} examples, f32, TF32 '
      f'off) of step {HEAD_STEPS}: {len(keys)} finite semantics/ and '
      f'gt_counts/ columns; {seconds:.2f} s; launches '
      f'{dict(kernels.LAUNCHES)}; {smi}')
  shutil.rmtree(workdir)

  occupancy = _with_train(configs.get_config(
      f'train_occupancy:pretrained_mapper={export}'), steps_per_eval=1)
  result, workdir = _head_run(
      smi, 'train_occupancy', occupancy, exported, 'streetview_encoder.',
      'bev_mapper.streetview_encoder.', 'mlp_out.')
  if not math.isfinite(result['evals'][HEAD_STEPS]['loss/total']):
    raise AssertionError(f'train_occupancy eval: {result["evals"]}')
  shutil.rmtree(workdir)
  shutil.rmtree(export)
  del exported

  training_main_path(
      smi, f'train_full1chip_exhaustive:modalities={THREE_MODALITIES}')


def pose_scoring_bound(args, out):
  """B4: poses, points and valid points' maps read once, scores written;
  POSE_OPS_PER_PAIR f32 operations per (pose, valid point)."""
  angle, t, sim, xy, valid_points, valid_map = args
  cells = sim.shape[-2] * sim.shape[-1]
  valid = int(valid_points.sum())
  nbytes = _nbytes(angle, t, xy, valid_points, valid_map, out) + (
      valid * cells * sim.element_size())
  return _bound(nbytes, angle.shape[-1] * valid * POSE_OPS_PER_PAIR)


def pose_scoring_bwd_bound(args, out):
  """B7: the cotangent, poses, points and masks read once, ``d sim``
  written once; POSE_BWD_OPS_PER_PAIR f32 operations per (pose, valid
  point)."""
  g, angle, t, xy, valid_points, valid_map = args
  nbytes = _nbytes(g, angle, t, xy, valid_points, valid_map, out)
  return _bound(nbytes, angle.shape[-1] * int(valid_points.sum())
                * POSE_BWD_OPS_PER_PAIR)


def without_gt_pose(call):
  """A captured B7 call with the GT pose's cotangent (pose 0) set to 0.
  Beside the GT's, the loss's cotangent is a near-uniform softmax, about
  1e-4 of it a pose once ``unit_cotangent`` scales the GT's to 1; alone,
  the sampled poses' terms are scaled to stand well above atol."""
  (g, *rest), kwargs = call
  g = g.clone()
  g[:, 0] = 0
  return (g, *rest), kwargs


def ransac_training_rows(launches, scoring, scoring_bwd):
  """B7 and B4 on the RANSAC training run's own inputs: each checked
  against its plain version on every captured call (B7's cotangent scaled
  by ``unit_cotangent``, as captured and without the GT pose's), then
  timed on the largest, B7 beside ``grid_sampler_2d_backward``."""
  err_bwd = max(max(check_pose_scoring_bwd(*c),
                    check_pose_scoring_bwd(*without_gt_pose(c)))
                for c in scoring_bwd.calls.values())
  checks = {shape: check_pose_scoring(*c) for shape, c in scoring.calls.items()}
  log(f'pose_scoring_bwd on the RANSAC training run\'s inputs '
      f'{list(scoring_bwd.calls)}: max abs err {err_bwd:.3g}; pose_scoring '
      f'(max abs err, near ties of the argmax) per call {checks}')
  repeats = sum(check_pose_scoring_bwd_repeats(*c)
                for c in scoring_bwd.calls.values())
  log(f'pose_scoring_bwd: {repeats} calls on the RANSAC training run\'s '
      f'inputs, ten on each, give its first call\'s bits')
  args, kw = scoring_bwd.largest()
  args = (unit_cotangent(args[0]), *args[1:])
  out = kernels.pose_scoring_bwd(*args, **kw)
  log_occupancy('pose_scoring_bwd', 'the training input')
  library = pose_scoring_bwd_library_call(args, kw)
  diff = (library().reshape(out.shape) - out).abs()
  log(f'grid_sampler_2d_backward vs pose_scoring_bwd on the training '
      f'input: max abs diff {float(diff.max()):.3g}, largest entry '
      f'{float(out.abs().max()):.3g}')
  del diff
  rows = [report(
      'pose_scoring_bwd', 'snap_tpu_torch/csrc/pose_scoring_bwd.cu',
      launches['pose_scoring_bwd'], err_bwd,
      time_ms(lambda: kernels.pose_scoring_bwd(*args, **kw)),
      time_ms(lambda: pose_estimation.pose_scoring_bwd_plain(
          *args, **kw, pose_chunk=PLAIN_POSE_CHUNK), iters=2),
      pose_scoring_bwd_bound(args, out), time_ms(library),
      replaces='snap_tpu/models/pose_estimation.py:95')]
  spin = {'pose_scoring_bwd': time_ms(
      lambda: kernels.pose_scoring_bwd(*args, **kw), spin=True)}
  spin['grid_sampler_2d_backward'] = time_ms(library, spin=True)
  del out, library
  args, kw = scoring.largest()
  out = kernels.pose_scoring(*args, **kw)
  log_occupancy('pose_scoring', 'the training input')
  rows.append(report(
      'pose_scoring/train', 'snap_tpu_torch/csrc/pose_scoring.cu',
      launches['pose_scoring'], max(e for e, _ in checks.values()),
      time_ms(lambda: kernels.pose_scoring(*args, **kw)),
      time_ms(lambda: pose_estimation.pose_scoring_plain(
          *args, **kw, pose_chunk=PLAIN_POSE_CHUNK), iters=2),
      pose_scoring_bound(args, out), None,
      replaces='snap_tpu/models/pose_estimation.py:95'))
  spin['pose_scoring'] = time_ms(lambda: kernels.pose_scoring(*args, **kw),
                                 spin=True)
  valid = int(args[4].sum())
  log(f'RANSAC training inputs: {args[0].shape[-1]} poses x {valid} valid '
      f'points ({args[2].shape[1]} points, {args[2].shape[0]} examples); ms '
      f'per call queued behind a spin: {spin}')
  for row, calls in ((rows[0], scoring_bwd), (rows[1], scoring)):
    shape = max(calls.calls, key=lambda s: math.prod(s))
    log(f'{row["name"]} at {shape}: {row["ms"]:.4f} ms (plain '
        f'{row["plain_ms"]:.4f} ms, bound {row["bound_ms"]:.4f} ms by '
        f'{row["bound_by"]}, library {row["library_ms"]})')
  return rows


def new_kernel_rows(ransac_launches, bench_launches, scoring, bench):
  """Rows of B4 (checked and timed on the RANSAC path's own inputs) and of
  B5 and B6 (from the gather bench)."""
  checks = {shape: check_pose_scoring(*call)
            for shape, call in scoring.calls.items()}
  per_call = {}
  sms = torch.cuda.get_device_properties(0).multi_processor_count
  for shape, (args, kw) in scoring.calls.items():
    plan = kernels.pose_scoring_plan(*shape, args[2].shape[1], sms=sms)
    per_call[shape] = dict(
        ms=time_ms(lambda: kernels.pose_scoring(*args, **kw)),
        spin_ms=time_ms(lambda: kernels.pose_scoring(*args, **kw), spin=True),
        bound=pose_scoring_bound(args, kernels.pose_scoring(*args, **kw)),
        valid_points=int(args[4].sum()),
        grid=f'{plan["tiles"]} tiles x {plan["groups"]} groups of '
             f'{plan["group"]} points x {plan["examples"]} examples = '
             f'{plan["blocks"]} blocks, {plan["waves"]:.3f} waves of {sms}')
    log_occupancy('pose_scoring', f'{shape[1]} poses')
  log(f'pose_scoring on main-path inputs: (max abs err, near ties of the '
      f'argmax) per call {checks}; per call (poses = the second number) '
      f'{per_call}')
  args, kw = scoring.largest()
  out = kernels.pose_scoring(*args, **kw)
  rows = [report(
      'pose_scoring', 'snap_tpu_torch/csrc/pose_scoring.cu',
      ransac_launches['pose_scoring'], max(e for e, _ in checks.values()),
      time_ms(lambda: kernels.pose_scoring(*args, **kw)),
      time_ms(lambda: pose_estimation.pose_scoring_plain(
          *args, **kw, pose_chunk=PLAIN_POSE_CHUNK), iters=2),
      pose_scoring_bound(args, out), None,
      replaces='snap_tpu/models/pose_estimation.py:95')]
  for name, kernel, replaces in (
      ('pallas_slice', 'slice_gather', 'tools/bench_gather.py:84'),
      ('pallas_dyngather', 'table_gather', 'tools/bench_gather.py:124')):
    log_occupancy(kernel, 'the tool shape')  # the gather bench's last call
    row = bench[name]
    rows.append(report(
        kernel, f'snap_tpu_torch/csrc/{kernel}.cu', bench_launches[kernel],
        row['max_abs_err'], row['ms'], row['plain_ms'],
        (row['bound_ms'], row['bound_by']), row['library_ms'],
        replaces=replaces))
  shape = max(scoring.calls, key=lambda s: math.prod(s))
  for row, at in zip(rows, (shape, 'the tool shape', 'the tool shape')):
    log(f'{row["name"]} at {at}: {row["ms"]:.4f} ms (plain '
        f'{row["plain_ms"]:.4f} ms, bound {row["bound_ms"]:.4f} ms by '
        f'{row["bound_by"]}, library {row["library_ms"]})')
  return rows


def heldout_rows(launches, lift, sample):
  """K1 and K2 on the held-out run's own f32 inputs: checked against their
  plain versions on every captured input, then timed on the largest (and
  behind a spin), ``F.grid_sample`` in f32 beside K2."""
  errs = {'lift': max(check_lift(*c) for c in lift.calls.values()),
          'sample': max(check_sample(*c) for c in sample.calls.values())}
  log(f'kernels on the held-out run\'s f32 inputs (lift {list(lift.calls)}, '
      f'sample {list(sample.calls)}): max abs err {errs}')
  args, kw = lift.largest()
  out = kernels.lift_topk_fwd(*args, **kw)
  log_occupancy('lift_topk_fwd', 'the held-out f32 input')
  lift_row = report(
      'lift_topk_fwd/heldout_f32', 'snap_tpu_torch/csrc/lift_topk_fwd.cu',
      launches['lift_topk_fwd'], errs['lift'],
      time_ms(lambda: kernels.lift_topk_fwd(*args, **kw)),
      time_ms(lambda: view_scan.lift_topk_plain(*args, **kw), iters=2),
      lift_bound(args, kw, *out), None)
  del out
  spin = {'lift_topk_fwd': time_ms(lambda: kernels.lift_topk_fwd(*args, **kw),
                                   spin=True)}
  log(f'lift_topk_fwd at the held-out f32 input {tuple(args[0].shape)} '
      f'({int(args[3].sum())} selected ranks)')
  args, kw = sample.largest()
  out = kernels.patch_sample_2d(*args, **kw)
  log_occupancy('patch_sample_2d', 'the held-out f32 input')
  sample_row = report(
      'patch_sample_2d/heldout_f32', 'snap_tpu_torch/csrc/patch_sample_2d.cu',
      launches['patch_sample_2d'], errs['sample'],
      time_ms(lambda: kernels.patch_sample_2d(*args, **kw)),
      time_ms(lambda: view_scan.patch_sample_2d_plain(*args, **kw)),
      sample_bound(args, kw, *out), time_ms(grid_sample_call(*args)))
  spin['patch_sample_2d'] = time_ms(
      lambda: kernels.patch_sample_2d(*args, **kw), spin=True)
  spin['F.grid_sample'] = time_ms(grid_sample_call(*args), spin=True)
  log(f'held-out f32 inputs, ms per call queued behind a spin: {spin}')
  for row, calls in ((lift_row, lift), (sample_row, sample)):
    shape = max(calls.calls, key=lambda s: math.prod(s))
    log(f'{row["name"]} at {shape}: {row["ms"]:.4f} ms (plain '
        f'{row["plain_ms"]:.4f} ms, bound {row["bound_ms"]:.4f} ms by '
        f'{row["bound_by"]}, library {row["library_ms"]})')
  return [lift_row, sample_row]


@functools.lru_cache(maxsize=2)
def library_sass(library=None):
  """``cuobjdump -sass`` of a kernel library (this tree's by default; one
  call, ~10 s); None where the toolkit has no ``cuobjdump``."""
  tool = kernels._nvcc().replace('nvcc', 'cuobjdump')
  try:
    return subprocess.run([tool, '-sass',
                           str(library or kernels.library_path())],
                          capture_output=True, text=True, timeout=120,
                          check=True).stdout
  except (OSError, subprocess.SubprocessError):
    return None


def sass_loops(function: str, library=None):
  """The loops of the compiled kernel whose mangled name contains
  ``function`` (``cuobjdump -sass`` of ``library``, this tree's by
  default): per loop (a predicated backward branch; an unpredicated one
  returns from out-of-line code), its instructions and those outside the
  loops nested in it, largest first; None where the toolkit has no
  ``cuobjdump``."""
  sass = library_sass(library)
  if sass is None:
    return None
  body, labels, pending, inside = [], {}, [], False
  for line in sass.splitlines():
    if 'Function :' in line:
      inside = function in line
      continue
    if not inside:
      continue
    label = re.match(r'\s*(\.L_x_\d+):', line)
    if label:
      pending.append(label.group(1))
    found = re.match(r'\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;', line)
    if found:
      addr = int(found.group(1), 16)
      labels.update((name, addr) for name in pending)
      pending = []
      body.append((addr, found.group(2)))
  loops = []
  for addr, text in body:
    target = re.search(r'BRA\S* (?:`\((\.L_x_\d+)\)|0x([0-9a-f]+))', text)
    if target:
      to = labels.get(target.group(1)) if target.group(1) else int(
          target.group(2), 16)
      if to is not None and to < addr and text.startswith('@'):
        loops.append((to, addr))
  counts = []
  for start, end in loops:
    total = sum(start <= a <= end for a, _ in body)
    nested = sum(sum(s <= a <= e for a, _ in body) for s, e in loops
                 if start <= s and e <= end and (s, e) != (start, end))
    counts.append((total, total - nested))
  return sorted(counts, reverse=True)


# The kernels whose SASS loops phase 2 prints: (label, a part of the
# mangled name). K1 in the flagship's layout and B8's two of phase 7j, in
# bf16 and f16; K3's ranks stage (which forms each rank's score, ROADMAP
# C27) in the two weighted layouts of the main paths.
SASS_LOOPS = tuple(
    [('pose_scoring_kernel<false>', 'pose_scoring_kernelILb0E'),
     ('pose_scoring_bwd_kernel<false>', 'pose_scoring_bwd_kernelILb0E')]
    + [(f'lift_topk_fwd_kernel {t} {layout}',
        f'lift_topk_fwd_kernelI{mangled}Li1E{mode}')
       for t, mangled in (('bf16', '13__nv_bfloat16'), ('f16', '6__half'))
       for layout, mode in (('(the flagship)', 'Lb1E'),
                            ('[mean, var, max, min, score_max]', 'Lb0ELi7E'),
                            ('unweighted [mean, var]', 'Lb0ELi2E'))]
    + [(f'lift_topk_bwd ranks_kernel {t} {layout}',
        f'12ranks_kernelI{mangled}Li1ELi{mode}E')
       for t, mangled in (('bf16', '13__nv_bfloat16'), ('f16', '6__half'))
       for layout, mode in (('(the flagship)', 3),
                            ('[mean, var, max, min, score_max]', 7))])


def log_occupancy(kernel: str, at: str) -> None:
  """Logs each launch of ``kernel``'s last call: registers, shared and
  local memory (``cudaFuncGetAttributes``) and the blocks per SM the card
  keeps resident at the launch's block size and dynamic shared memory."""
  for o in kernels.occupancy(kernel):
    log(f'resources: {kernel} at {at}: {o["name"]}: {o["registers"]} '
        f'registers, {o["static_smem"]} B static + {o["dynamic_smem"]} B '
        f'dynamic shared memory, {o["local_bytes"]} B local memory (spills, '
        f'stack); {o["threads"]} threads, {o["blocks_per_sm"]} blocks per SM')


def report(name, source, launches, err, k_ms, p_ms, bound, lib_ms,
           replaces='tools/pallas_gather_probe.py:39'):
  return dict(name=name, route='cuda', source=source, replaces=replaces,
              launches=launches, max_abs_err=err, ms=k_ms, plain_ms=p_ms,
              bound_ms=bound[0], bound_by=bound[1], library_ms=lib_ms)


def b8_rows(runs):
  """Phase 8, B8: K1 and K3 of each lifted form of phase 7j checked on every
  input its run gave them (the plain versions PLAIN_LIFT_CHUNK points at a
  time), then timed on the largest with the plain version and the bound;
  one JSON row each, its launches those of its run, K1's with the
  registers, local bytes and blocks per SM of its launch."""
  rows = []
  for form, (launches, lift, lift_bwd) in runs.items():
    tag = form.split(',')[0] + ('_minmax' if 'max' in form else
                               '_unweighted')
    errs = (max(check_lift(*c, chunk=PLAIN_LIFT_CHUNK)
                for c in lift.calls.values()),
            max(check_lift_bwd(*c, chunk=PLAIN_LIFT_CHUNK)
                for c in lift_bwd.calls.values()))
    repeats = [check_repeats(lift_bwd_call(*c), f'lift_topk_bwd ({form})')
               for c in lift_bwd.calls.values()]
    log(f'lift_topk_bwd ({form}): {REPEAT_CALLS} calls on each captured '
        f'input give equal bits (entries of each output): {repeats}')
    args, kw = lift.largest()
    out = kernels.lift_topk_fwd(*args, **kw)
    log_occupancy('lift_topk_fwd', f'7j {form}')
    launch, = kernels.occupancy('lift_topk_fwd')
    fwd = report(
        f'lift_topk_fwd/{tag}', 'snap_tpu_torch/csrc/lift_topk_fwd.cu',
        launches['lift_topk_fwd'], errs[0],
        time_ms(lambda: kernels.lift_topk_fwd(*args, **kw)),
        time_ms(lambda: plain_lift(args, kw, PLAIN_LIFT_CHUNK), iters=1),
        lift_bound(args, kw, *out), None)
    fwd.update({k: launch[k] for k in ('registers', 'local_bytes',
                                       'blocks_per_sm')})
    selected = int(args[3].sum())
    del out
    args, kw = lift_bwd.largest()
    out = kernels.lift_topk_bwd(*args, **kw)
    log_occupancy('lift_topk_bwd', f'7j {form}')
    bwd = report(
        f'lift_topk_bwd/{tag}', 'snap_tpu_torch/csrc/lift_topk_bwd.cu',
        launches['lift_topk_bwd'], errs[1], time_ms(lift_bwd_call(args, kw)),
        time_ms(lambda: plain_lift_bwd(args, kw, PLAIN_LIFT_CHUNK), iters=1),
        lift_bwd_bound(args, kw, out), None)
    del out
    log(f'lift_topk_bwd/{tag} stages at 7j {form}, (device ms per call, '
        f'launches kept): '
        f'{kernel_stages_ms(lift_bwd_call(args, kw), K3_STAGES)}')
    lift.calls.clear()  # the next form's K3 scratch needs the room
    lift_bwd.calls.clear()
    for row in (fwd, bwd):
      log(f'{row["name"]} ({form}) at {tuple(args[0].shape)}, '
          f'{tuple(args[1].shape)} ranks, {selected} selected: '
          f'{row["ms"]:.4f} ms (plain {row["plain_ms"]:.4f} ms, bound '
          f'{row["bound_ms"]:.4f} ms by {row["bound_by"]}), max abs err '
          f'{row["max_abs_err"]:.3g}')
    rows += [fwd, bwd]
  return rows


def kernel_rows(serve_launches, train_launches, lift, sample, lift_bwd,
                sample_bwd, lift_f32):
  """Check each kernel on every captured input (K1 also on the RANSAC
  path's f32 lift), then time it on the largest: one JSON row per kernel."""
  errs = {
      'lift_topk_fwd': max(check_lift(*c) for c in (
          *lift.calls.values(), *lift_f32.calls.values())),
      'patch_sample_2d': max(check_sample(*c) for c in sample.calls.values()),
      'lift_topk_bwd': max(check_lift_bwd(*c)
                           for c in lift_bwd.calls.values()),
      'patch_sample_2d_bwd': max(check_sample_bwd(*c)
                                 for c in sample_bwd.calls.values()),
  }
  log(f'kernels on main-path inputs (lift {list(lift.calls)} bf16 and '
      f'{list(lift_f32.calls)} f32, sample {list(sample.calls)}, lift_bwd '
      f'{list(lift_bwd.calls)}, sample_bwd {list(sample_bwd.calls)}): max '
      f'abs err {errs}')
  # ROADMAP C20: ten calls on each captured training input, equal bits.
  repeats = {
      'lift_topk_bwd': [check_repeats(lift_bwd_call(*c), 'lift_topk_bwd')
                        for c in lift_bwd.calls.values()],
      'patch_sample_2d_bwd': [check_repeats(
          functools.partial(kernels.patch_sample_2d_bwd, *c[0], **c[1]),
          'patch_sample_2d_bwd') for c in sample_bwd.calls.values()]}
  log(f'{REPEAT_CALLS} calls on each captured training input give equal '
      f'bits (entries of each output): {repeats}')

  rows = []
  args, kw = lift.largest()
  out = kernels.lift_topk_fwd(*args, **kw)
  log_occupancy('lift_topk_fwd', 'the serving input')
  rows.append(report(
      'lift_topk_fwd', 'snap_tpu_torch/csrc/lift_topk_fwd.cu',
      serve_launches['lift_topk_fwd'], errs['lift_topk_fwd'],
      time_ms(lambda: kernels.lift_topk_fwd(*args, **kw)),
      time_ms(lambda: view_scan.lift_topk_plain(*args, **kw), iters=5),
      lift_bound(args, kw, *out), None))
  args, kw = sample.largest()
  out = kernels.patch_sample_2d(*args, **kw)
  log_occupancy('patch_sample_2d', 'the serving input')
  rows.append(report(
      'patch_sample_2d', 'snap_tpu_torch/csrc/patch_sample_2d.cu',
      serve_launches['patch_sample_2d'], errs['patch_sample_2d'],
      time_ms(lambda: kernels.patch_sample_2d(*args, **kw)),
      time_ms(lambda: view_scan.patch_sample_2d_plain(*args, **kw)),
      sample_bound(args, kw, *out), time_ms(grid_sample_call(*args))))
  args, kw = lift_bwd.largest()
  out = kernels.lift_topk_bwd(*args, **kw)
  log_occupancy('lift_topk_bwd', 'the training input')
  stack, view_idx, p2d, select = args[:4]
  bins = lift_bwd_bin_counts(
      view_idx, p2d, select, views=stack.shape[1] // (kw['h'] + 1),
      h=kw['h'], w=kw['w'])
  log(f'lift_topk_bwd at {tuple(stack.shape)}: {int(bins.sum())} selected '
      f'ranks in {int((bins > 0).sum())} of {bins.numel()} bins (example, '
      f'view, lower-tap pixel), the largest {int(bins.max())}')
  rows.append(report(
      'lift_topk_bwd', 'snap_tpu_torch/csrc/lift_topk_bwd.cu',
      train_launches['lift_topk_bwd'], errs['lift_topk_bwd'],
      time_ms(lift_bwd_call(args, kw)),
      time_ms(lambda: plain_lift_bwd(args, kw), iters=3),
      lift_bwd_bound(args, kw, out), None))
  args, kw = sample_bwd.largest()
  out = kernels.patch_sample_2d_bwd(*args, **kw)
  log_occupancy('patch_sample_2d_bwd', 'the training input')
  rows.append(report(
      'patch_sample_2d_bwd', 'snap_tpu_torch/csrc/patch_sample_2d_bwd.cu',
      train_launches['patch_sample_2d_bwd'], errs['patch_sample_2d_bwd'],
      time_ms(lambda: kernels.patch_sample_2d_bwd(*args, **kw)),
      time_ms(lambda: view_scan.patch_sample_2d_bwd_plain(*args, **kw)),
      sample_bwd_bound(args, kw, out),
      time_ms(grid_sample_bwd_call(*args, kw['plane_shape']))))
  args, kw = lift_f32.largest()
  out = kernels.lift_topk_fwd(*args, **kw)
  log_occupancy('lift_topk_fwd', 'the RANSAC input')
  log(f'lift_topk_fwd at the RANSAC path\'s f32 input {tuple(args[0].shape)}'
      f' ({int(args[3].sum())} selected ranks): '
      f'{time_ms(lambda: kernels.lift_topk_fwd(*args, **kw)):.4f} ms, spin '
      f'{time_ms(lambda: kernels.lift_topk_fwd(*args, **kw), spin=True):.4f}'
      f' ms (bound, bound by: {lift_bound(args, kw, *out)})')
  del out
  args, kw = lift.largest()
  queued = {'lift_topk_fwd': time_ms(
      lambda: kernels.lift_topk_fwd(*args, **kw), spin=True)}
  args, kw = sample.largest()
  queued.update({
      'patch_sample_2d': time_ms(lambda: kernels.patch_sample_2d(*args, **kw),
                                 spin=True),
      'F.grid_sample': time_ms(grid_sample_call(*args), spin=True)})
  stages = kernel_stages_ms(lambda: kernels.patch_sample_2d(*args, **kw),
                            ('pack_plane_kernel', 'patch_sample_2d_kernel'))
  log(f'patch_sample_2d stages at {tuple(args[1].shape)}, (device ms per '
      f'call, launches kept): {stages}')
  args, kw = lift_bwd.largest()
  queued['lift_topk_bwd'] = time_ms(lift_bwd_call(args, kw), spin=True)
  stages = kernel_stages_ms(lift_bwd_call(args, kw), K3_STAGES)
  log(f'lift_topk_bwd stages at {tuple(args[0].shape)}, (device ms per '
      f'call, launches kept): {stages}')
  args, kw = sample_bwd.largest()
  queued['patch_sample_2d_bwd'] = time_ms(
      lambda: kernels.patch_sample_2d_bwd(*args, **kw), spin=True)
  queued['grid_sampler_2d_backward'] = time_ms(
      grid_sample_bwd_call(*args, kw['plane_shape']), spin=True)
  bins = sample_bwd_bin_counts(args[1], kw['plane_shape'])
  log(f'patch_sample_2d_bwd at {tuple(args[1].shape)}: {int(bins.sum())} '
      f'points in {int((bins > 0).sum())} of {bins.numel()} bins (example, '
      f'lower-tap cell), the largest {int(bins.max())}, median of the '
      f'non-empty {int(bins[bins > 0].median())}')
  stages = kernel_stages_ms(lambda: kernels.patch_sample_2d_bwd(*args, **kw),
                            K4_STAGES)
  log(f'patch_sample_2d_bwd stages at {tuple(args[1].shape)}, (device ms '
      f'per call, launches kept; the memset in other): {stages}')
  log(f'ms per call with the launches queued behind a spin of the card '
      f'(host launch overhead hidden; the rows below are timed without): '
      f'{queued}')
  for row, calls in zip(rows, (lift, sample, lift_bwd, sample_bwd)):
    shape = max(calls.calls, key=lambda s: math.prod(s))
    log(f'{row["name"]} at {shape}: {row["ms"]:.4f} ms (plain '
        f'{row["plain_ms"]:.4f} ms, bound {row["bound_ms"]:.4f} ms by '
        f'{row["bound_by"]}, library {row["library_ms"]})')
  return rows


def f16_rows(train_launches, eval_launches, lift, sample, lift_bwd,
             sample_bwd):
  """Phase 8 in f16: K1 and K2 on phase 7k's evaluation inputs, K3 and K4
  on its training steps' (each checked on every captured input, then
  timed on the largest beside its plain version, its bound and
  ``F.grid_sample`` and its input gradient in f16 for K2 and K4): one JSON
  row each, named ``<kernel>/f16``."""
  rows = []
  for kernel, calls, launches, check, plain, bound, library in (
      ('lift_topk_fwd', lift, eval_launches, check_lift,
       lambda a, k: view_scan.lift_topk_plain(*a, **k),
       lambda a, k, out: lift_bound(a, k, *out), None),
      ('patch_sample_2d', sample, eval_launches, check_sample,
       lambda a, k: view_scan.patch_sample_2d_plain(*a, **k),
       lambda a, k, out: sample_bound(a, k, *out),
       lambda a, k: grid_sample_call(*a)),
      ('lift_topk_bwd', lift_bwd, train_launches, check_lift_bwd,
       lambda a, k: plain_lift_bwd(a, k), lift_bwd_bound, None),
      ('patch_sample_2d_bwd', sample_bwd, train_launches, check_sample_bwd,
       lambda a, k: view_scan.patch_sample_2d_bwd_plain(*a, **k),
       sample_bwd_bound,
       lambda a, k: grid_sample_bwd_call(*a, k['plane_shape']))):
    err = max(check(*c) for c in calls.calls.values())
    if kernel in ('lift_topk_bwd', 'patch_sample_2d_bwd'):
      repeats = [check_repeats(
          lift_bwd_call(*c) if kernel == 'lift_topk_bwd'
          else functools.partial(kernels.patch_sample_2d_bwd, *c[0], **c[1]),
          f'{kernel}/f16') for c in calls.calls.values()]
      log(f'{kernel}/f16: {REPEAT_CALLS} calls on each captured input give '
          f'equal bits (entries of each output): {repeats}')
    args, kw = calls.largest()
    if args[0].dtype != torch.float16:
      raise AssertionError(f'{kernel}: captured {args[0].dtype}')
    call = (lift_bwd_call(args, kw) if kernel == 'lift_topk_bwd'
            else functools.partial(getattr(kernels, kernel), *args, **kw))
    out = call()
    log_occupancy(kernel, 'phase 7k\'s f16 input')
    row = report(f'{kernel}/f16', f'snap_tpu_torch/csrc/{kernel}.cu',
                 launches[kernel], err, time_ms(call),
                 time_ms(lambda: plain(args, kw), iters=3),
                 bound(args, kw, out),
                 None if library is None else time_ms(library(args, kw)))
    row['spin_ms'] = time_ms(call, spin=True)
    log(f'{row["name"]} at {tuple(args[0].shape)} (inputs '
        f'{list(calls.calls)}): {row["ms"]:.4f} ms, spin '
        f'{row["spin_ms"]:.4f} ms (plain {row["plain_ms"]:.4f} ms, bound '
        f'{row["bound_ms"]:.4f} ms by {row["bound_by"]}, library '
        f'{row["library_ms"]}), max abs err {err:.3g}')
    rows.append(row)
    del out
  return rows


def main() -> int:
  # 1. Device.
  if not torch.cuda.is_available():
    print('chip_smoke: torch.cuda.is_available() is False; needs a CUDA card',
          file=sys.stderr)
    return 1
  smi = subprocess.run(
      ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
      capture_output=True, text=True, timeout=60, check=True).stdout.strip()
  smi = smi.splitlines()[torch.cuda.current_device()]
  name = torch.cuda.get_device_name(0)
  log(f'device: {name} ({smi}), torch {torch.__version__}, '
      f'CUDA {torch.version.cuda}')

  # 2. Build.
  t = time.perf_counter()
  kernels.load_library()
  log(f'build: {time.perf_counter() - t:.1f} s '
      f'({kernels.library_path().name})')
  log('SASS loops (instructions, of them outside nested loops), largest '
      'first: ' + '; '.join(f'{label} {sass_loops(name)}'
                            for label, name in SASS_LOOPS))

  # 3. Kernels against their plain versions on seeded flagship-shape inputs,
  # bf16 and f16.
  for dtype in (torch.bfloat16, torch.float16):
    lift, sample, lift_bwd, sample_bwd = seeded_kernel_inputs('cuda', dtype)
    log(f'kernels on seeded inputs, {str(dtype)[6:]}: max abs err '
        f'lift_topk_fwd {check_lift(*lift):.3g}, patch_sample_2d '
        f'{check_sample(*sample):.3g}, lift_topk_bwd '
        f'{check_lift_bwd(*lift_bwd):.3g}, patch_sample_2d_bwd '
        f'{check_sample_bwd(*sample_bwd):.3g}; lift_topk_bwd '
        f'{time_ms(lift_bwd_call(*lift_bwd)):.4f} ms per call, (device ms '
        f'per call, launches kept) per stage '
        f'{kernel_stages_ms(lift_bwd_call(*lift_bwd), K3_STAGES)}')
    for kernel in EXHAUSTIVE_KERNELS:
      log_occupancy(kernel, f'phase 3, {str(dtype)[6:]}')
    if dtype == torch.float16:
      log(f'an infinite cotangent entry, f16: the non-finite entries of the '
          f'gradient, the plain version\'s '
          f'{check_non_finite(lift_bwd, sample_bwd)}')
    del lift, sample, lift_bwd, sample_bwd
  b8_seeded()
  scoring = {mask: check_pose_scoring(*seeded_pose_scoring_inputs('cuda',
                                                                   mask))
             for mask in (False, True)}
  log(f'kernels on seeded inputs: pose_scoring (max abs err, near ties of '
      f'the argmax) without / with the mask {scoring[False]} / '
      f'{scoring[True]}; over all {bench_gather.N} points, slice_gather '
      f'{check_gathers("cuda")}, table_gather exact')
  scoring_bwd = {}
  for mask in (False, True):
    args, kw = seeded_pose_scoring_bwd_inputs('cuda', mask)
    scoring_bwd[mask] = (check_pose_scoring_bwd(args, kw),
                         check_identical_run(args, kw))
    del args
  log(f'kernels on seeded inputs: pose_scoring_bwd at the training shape '
      f'(max abs err; the identical run\'s distance from its closed form, '
      f'relative) without / with the mask {scoring_bwd[False]} / '
      f'{scoring_bwd[True]}')

  # 4-5c. References: the tiny localizer, trainer, RANSAC localizer and
  # RANSAC trainer, card against CPU.
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  serving_reference()
  training_reference()
  ransac_reference()
  training_reference('smoke_train_ransac')
  # 5d. The heads and the semantic modality, card against CPU.
  heads_reference()
  # 5e. The mapper options the flagship does not use, card against CPU.
  a14_reference()
  # 5f. The lift's other forms, card against CPU.
  a145_reference()
  # 5g. f16 with the loss scale, card against CPU; every card call in f16.
  with KernelDtypes() as dtypes:
    training_reference('smoke_train_exhaustive, float16', dataclasses.replace(
        configs.smoke_train_exhaustive(), dtype_str='float16'),
                       least=EXHAUSTIVE_KERNELS, tol=F16_TRAIN_TOL)
    overflow = f16_overflow_reference()
  log(f'f16 training reference: a step from a loss scale of 2^30, '
      f'(is_finite, loss_scale) on the card and the CPU {overflow}; card '
      f'kernel calls, all f16, '
      f'{dtypes.assert_only(torch.float16, "phase 5g")}')

  # 6-7e. Main paths, each with the launch counts reset just before it;
  # their batches made on the card by the dataset's iterators.
  serve_launches, lift, sample = serving_main_path()
  train_launches, lift_bwd, sample_bwd = training_main_path(smi)
  ransac_train_launches, scoring_train, scoring_bwd = training_main_path(
      smi, 'train_full1chip_ransac')
  torch.backends.cudnn.allow_tf32 = False  # the RANSAC config is f32
  ransac_launches, scoring, lift_f32 = ransac_main_path(smi)
  heldout_launches, heldout_lift, heldout_sample = heldout_main_path(smi)
  bench_phase(smi)
  bench_launches, gather_bench = gather_bench_phase()
  # 7g. The trainer of a long run: chunks, resume, eval, warm start.
  trainer_loop_phase(smi)
  # 7h. The heads on a frozen mapper, and the semantic modality.
  heads_main_path(smi)
  # 7i. The aerial-only map, bev_net and query confidence at full width.
  a14_main_path(smi)
  # 7j. The lift's other forms at full width.
  b8_runs = a145_main_path(smi)
  # 7k. The flagship run in f16 with the loss scale, and its workdir served.
  f16_runs = f16_main_path(smi)

  # 7f. The device generator on the card. After the main paths: its
  # profile of one build is this script's first, and later launches on
  # the host-bound paths would pay for it.
  data_on_card(smi)

  # 8. Kernels on the main paths' own inputs: check, then time. B8's first:
  # the scan's inputs and K3's scratch for its 20 ranks are the largest,
  # and go before the plain versions of the others run.
  with torch.no_grad():
    torch.cuda.empty_cache()
    log(f'phase 8: {torch.cuda.memory_allocated() / 2**30:.2f} GiB held '
        f'(the main paths\' captured inputs)')
    b8 = b8_rows(b8_runs)
    del b8_runs
    torch.cuda.empty_cache()
    rows = kernel_rows(serve_launches, train_launches, lift, sample,
                       lift_bwd, sample_bwd, lift_f32)
    rows += new_kernel_rows(ransac_launches, bench_launches, scoring,
                            gather_bench)
    rows += ransac_training_rows(ransac_train_launches, scoring_train,
                                 scoring_bwd)
    rows += heldout_rows(heldout_launches, heldout_lift, heldout_sample)
    rows += b8
    rows += f16_rows(*f16_runs)
    del f16_runs
  # Every K3 call of the run was given the count its count stage found.
  kernels.check_lift_counts(wait=True)
  # 9. The mesh's data axis over processes on the card, the captured
  # inputs let go first: its ranks share the card.
  del lift, sample, lift_bwd, sample_bwd, lift_f32, scoring, scoring_train
  del scoring_bwd, heldout_lift, heldout_sample, gather_bench
  data_axis_phase(smi)
  print(smi, flush=True)
  print(json.dumps({'kernels': rows}), flush=True)
  print(json.dumps({'ok': True, 'device': {
      'platform': 'gpu', 'kind': name, 'count': torch.cuda.device_count()}}),
        flush=True)
  return 0


# Phase 9: the mesh's data axis on the card. DP_RANKS gloo ranks share the
# one card (batch 1 a rank of the flagship's 2), DP_STEPS steps in f32 with
# TF32 off from one seeded state, against the one-process steps on the
# same global batches; then one rank alone in an NCCL group.
DP_RANKS, DP_STEPS = 2, 2


def _f32_flagship() -> configs.Config:
  return dataclasses.replace(configs.train_full1chip_exhaustive(),
                             dtype_str='float32')


def _flat_params(model) -> torch.Tensor:
  return torch.cat([p.detach().reshape(-1) for p in model.parameters()])


def _allreduce_ms(numel: int, device, iters: int = 5) -> float:
  """ms of one all-reduce (sum) of ``numel`` f32 over the group, the
  process group's own call, timed on the host around a synchronize."""
  import torch.distributed as dist  # pylint: disable=g-import-not-at-top
  buf = torch.ones(numel, device=device)
  dist.all_reduce(buf)
  torch.cuda.synchronize(device)
  t0 = time.perf_counter()
  for _ in range(iters):
    dist.all_reduce(buf)
  torch.cuda.synchronize(device)
  return 1e3 * (time.perf_counter() - t0) / iters


def _blockwise_grads(model, config: configs.Config, state, device,
                     world: int) -> torch.Tensor:
  """The gradient of the first step's loss (flat, on the host) taken as
  ``world`` ranks take it, in one process: each rank's block of the global
  batch built as the rank builds it, its rows of the global draws, its
  masked example losses summed over the global count, the blocks'
  gradients summed in rank order. Its forward runs each block at the
  ranks' batch size, so its cuDNN algorithms, and with them its near ties
  (C11), are theirs."""
  blocks = []
  for index in range(world):
    with loader.get_dataset(config.data, config.batch_size, device=device,
                            num_processes=world,
                            process_index=index) as dataset:
      blocks.append(next(dataset.train_iter))
    blocks[-1].pop('_host')
  draws = model.sample_draws(config.batch_size,
                             trainer.step_generator(state), device)
  count = sum(block['batch_mask'].sum() for block in blocks)
  params = list(model.parameters())
  total = None
  for index, block in enumerate(blocks):
    rows = parallel_mesh.block(config.batch_size, world, index)
    _, losses, _, _ = trainer.loss_and_metrics(
        model, block, True, draws=trainer.local_draws(draws, rows))
    loss = losses['total'][block['batch_mask'] > 0].sum() / count
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    flat = torch.cat([(torch.zeros_like(p) if g is None else g).reshape(-1)
                      for g, p in zip(grads, params)])
    total = flat if total is None else total + flat
  return total.cpu()


def _dp_steps(device, config: configs.Config, steps: int,
              control_world: int = 0):
  """``steps`` train steps of ``config`` from the weights of seed 0 on the
  dataset's card-made batches (this rank's blocks under a process group):
  per step the loss, the ms (host clock around a synchronize), the
  gradients (the global batch's) and the parameters after it (flat, on the
  host); the model's own peak memory; with ``control_world``, the first
  step's gradient taken block by block as that many ranks take it
  (``_blockwise_grads``)."""
  model = evaluate.build_model(config, device, 0)
  model.train()
  adam = optimizers.get_optimizer(config.train, model)
  state = trainer.create_train_state(model, adam, seed=0)
  out = {'params': [_flat_params(model).cpu()], 'loss': [], 'ms': [],
         'grads': []}
  if control_world:
    out['control'] = _blockwise_grads(model, config, state, device,
                                      control_world)
  torch.cuda.reset_peak_memory_stats(device)
  with loader.get_dataset(config.data, config.batch_size,
                          device=device) as dataset:
    for _ in range(steps):
      batch = next(dataset.train_iter)
      batch.pop('_host')
      torch.cuda.synchronize(device)
      t0 = time.perf_counter()
      step = trainer.train_step(state, batch, adam)
      torch.cuda.synchronize(device)
      out['ms'].append(1e3 * (time.perf_counter() - t0))
      out['loss'].append(trainer.summarize([step.metrics])['loss/total'])
      out['grads'].append(torch.cat([g.reshape(-1) for g in
                                     step.grads.values()]).cpu())
      out['params'].append(_flat_params(model).cpu())
  out['peak_gib'] = torch.cuda.max_memory_allocated(device) / 2**30
  out['names'] = [(n, p.numel()) for n, p in model.named_parameters()]
  return out


def _leaf_errors(got: torch.Tensor, want: torch.Tensor, names) -> dict:
  """Flat gradients ``got`` against ``want``, leaf by leaf: the worst error
  as a share of a leaf's norm and of its largest entry, and the leaves past
  phase 5's shares (TRAIN_GRAD_NORM_RTOL, TRAIN_GRAD_RTOL) with the first
  of them."""
  out = {'norm_share': 0.0, 'max_share': 0.0, 'past': 0, 'first_past': None}
  at = 0
  for name, numel in names:
    g, w = got[at:at + numel], want[at:at + numel]
    at += numel
    scale, norm = float(w.abs().max()), float(w.norm())
    err, err_norm = float((g - w).abs().max()), float((g - w).norm())
    out['max_share'] = max(out['max_share'], err / max(scale, 1e-30))
    out['norm_share'] = max(out['norm_share'], err_norm / max(norm, 1e-30))
    if (err > TRAIN_GRAD_RTOL * scale + 1e-7
        or err_norm > TRAIN_GRAD_NORM_RTOL * norm + 1e-7):
      out['past'] += 1
      out['first_past'] = out['first_past'] or name
  return out


def _child_dp_step(reference: str) -> dict:
  """A rank of phase 9 (a): its steps against the one-process ones in
  ``reference``: the loss to phase 5's tolerance; each parameter leaf
  within twice the largest move the one-process steps gave it (Adam moves
  an entry by at most about the lr a step, and where a gradient entry is
  near 0 rounding alone can turn its step around); its parameters against
  rank 0's bit for bit; and its first step's gradient leaves against the
  one process's taken block by block as the ranks take them
  (``_blockwise_grads``), to phase 5's shares of each leaf's largest entry
  and norm. Against the one-process step on the global batch the gradient
  leaves' errors are logged, not held: a rank's batch of 1 runs other cuDNN
  algorithms than the batch of 2, and with no ``MaxChoices`` replay
  between the two a near tie at a max pooling or a relu flips (ROADMAP
  C11) and moves some leaves by several % (a first run: 1.7% of a leaf's
  norm, 22% of its largest entry); the one process's own batch of 2
  against its blocks is logged beside it (``data_axis_phase``)."""
  import torch.distributed as dist  # pylint: disable=g-import-not-at-top
  process = parallel_mesh.init('cuda')
  if process.backend != 'gloo' or process.world != DP_RANKS:
    raise AssertionError(f'phase 9 (a): {process}')
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  try:
    ref = torch.load(reference, weights_only=False)
    got = _dp_steps(process.device, _f32_flagship(), DP_STEPS)
    worst = 0.0
    control = _leaf_errors(got['grads'][0], ref['control'], got['names'])
    if control['past']:
      raise AssertionError(f'step 0: gradients against the blockwise one: '
                           f'{control}')
    global_batch = [_leaf_errors(got['grads'][step], ref['grads'][step],
                                 got['names']) for step in range(DP_STEPS)]
    for step in range(DP_STEPS):
      if not math.isclose(got['loss'][step], ref['loss'][step],
                          rel_tol=TRAIN_LOSS_RTOL):
        raise AssertionError(f'step {step}: loss {got["loss"][step]}, one '
                             f'process {ref["loss"][step]}')
      mine = got['params'][step + 1].to(process.device)
      lead = mine.clone()
      dist.broadcast(lead, 0)
      if not torch.equal(_bits(mine), _bits(lead)):
        raise AssertionError(f'step {step}: rank {process.rank}\'s '
                             f'parameters differ from rank 0\'s')
      at = 0
      for name, numel in got['names']:
        leaf = slice(at, at + numel)
        want = ref['params'][step + 1][leaf]
        move = float((want - ref['params'][0][leaf]).abs().max())
        err = float((mine[leaf].cpu() - want).abs().max())
        if err > 2 * move + 1e-7:
          raise AssertionError(f'step {step}: {name} off by {err:.3g} (the '
                               f'one-process steps moved it {move:.3g})')
        worst = max(worst, err / max(move, 1e-30))
        at += numel
    numel = got['params'][0].numel()
    return {'rank': process.rank, 'device': str(process.device),
            'backend': process.backend, 'loss': got['loss'],
            'step_ms': got['ms'], 'peak_gib': got['peak_gib'],
            'worst_param_share_of_move': worst,
            'grads_vs_blockwise': control,
            'grads_vs_global_batch': global_batch,
            'allreduce_bytes': 4 * numel,
            'allreduce_ms': _allreduce_ms(numel, process.device)}
  finally:
    parallel_mesh.shutdown()


def _child_nccl_rank(workdir: str) -> dict:
  """Phase 9 (b): one rank alone in an NCCL group: a training step of the
  flagship (its gradients and metrics all-reduced through NCCL) and an
  evaluation batch of ``eval_full1chip_exhaustive`` (its rows gathered):
  each must call the group's collectives, counted at ``torch.distributed``
  (a group of one rank may run them without a kernel of NCCL's own)."""
  import torch.distributed as dist  # pylint: disable=g-import-not-at-top
  process = parallel_mesh.init('cuda')
  if process.backend != 'nccl':
    raise AssertionError(f'phase 9 (b): {process}')
  try:
    calls = {}
    for name in ('all_reduce', 'all_gather_object', 'barrier'):
      def counted(*args, _call=getattr(dist, name), _name=name, **kwargs):
        calls[_name] = calls.get(_name, 0) + 1
        return _call(*args, **kwargs)
      setattr(dist, name, counted)
    kernels.reset_launch_counts()
    result = train.train('train_full1chip_exhaustive', 1, str(
        process.device), workdir=workdir)
    train_calls = dict(calls)
    loss = result['logs'][0]
    train_launches = dict(kernels.LAUNCHES)
    if not (train_calls.get('all_reduce') and loss['is_finite']
            and all(train_launches[k] for k in EXHAUSTIVE_KERNELS)):
      raise AssertionError(f'phase 9 (b): collectives {train_calls}, logs '
                           f'{loss}, launches {train_launches}')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    calls.clear()
    served = evaluate.evaluate('eval_full1chip_exhaustive', num_queries=2,
                               device=str(process.device), batch_size=2)
    eval_calls = dict(calls)
    errors = served['position_error_m']
    if len(errors) != 2 or not all(math.isfinite(e) for e in errors) or (
        not eval_calls.get('all_gather_object')):
      raise AssertionError(f'phase 9 (b): eval errors {errors}, '
                           f'collectives {eval_calls}')
    numel = sum(p.numel() for p in result['state'].model.parameters())
    return {'rank': process.rank, 'backend': process.backend,
            'collectives': {'train': train_calls, 'eval': eval_calls},
            'step_ms': result['step_seconds'][0] * 1e3,
            'l2_grads': loss['l2_grads'],
            'peak_gib': torch.cuda.max_memory_allocated() / 2**30,
            'eval_position_error_m': errors,
            'eval_forward_ms': served['forward_ms'],
            'allreduce_bytes': 4 * numel,
            'allreduce_ms': _allreduce_ms(numel, process.device)}
  finally:
    parallel_mesh.shutdown()


def data_axis_phase(smi: str) -> dict:
  """Phase 9: (a) the one-process steps, then DP_RANKS gloo ranks on the
  card against them; (b) one rank alone in an NCCL group."""
  torch.cuda.empty_cache()
  workdir = fresh_workdir('data_axis')
  workdir.mkdir(parents=True)
  tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
  torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = (
      False)
  t0 = time.perf_counter()
  one = _dp_steps(torch.device('cuda'), _f32_flagship(), DP_STEPS,
                  control_world=DP_RANKS)
  torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
  batch_shape = _leaf_errors(one['grads'][0], one['control'], one['names'])
  reference = workdir / 'one_process.pt'
  torch.save({'loss': one['loss'], 'params': one['params'],
              'grads': one['grads'], 'control': one['control']}, reference)
  del one['params'], one['grads'], one['control']
  torch.cuda.empty_cache()
  ranks = run_children('dp_step', [reference], world=DP_RANKS)
  reference.unlink()
  log(f'phase 9 (a), the data axis on the card (train_full1chip_exhaustive '
      f'in f32, TF32 off, global batch 2, {DP_RANKS} gloo ranks sharing the '
      f'card, {DP_STEPS} steps): the one process\'s losses {one["loss"]}, '
      f'ms a step {one["ms"]}, own peak {one["peak_gib"]:.2f} GiB, its '
      f'first step\'s gradient on the global batch against its blockwise '
      f'one (the batch shape\'s own effect, C11) {batch_shape}; the ranks '
      f'(losses, ms a step, own peak GiB, the first step\'s gradients '
      f'against the blockwise ones (held), each step\'s against the one '
      f'process\'s on the global batch (logged), the worst parameter error '
      f'as a share of the one-process steps\' largest move of its leaf, '
      f'the all-reduce\'s bytes and ms): '
      f'{[(r["loss"], r["step_ms"], r["peak_gib"], r["grads_vs_blockwise"], r["grads_vs_global_batch"], r["worst_param_share_of_move"], r["allreduce_bytes"], r["allreduce_ms"]) for r in ranks]}; '
      f'parameters equal on both ranks bit for bit after each step; {smi}')
  nccl, = run_children('nccl_rank', [workdir / 'nccl'], world=1)
  shutil.rmtree(workdir)
  log(f'phase 9 (b), one rank in an NCCL group: {nccl}; '
      f'{time.perf_counter() - t0:.1f} s for the phase; {smi}')
  return {'one': one, 'ranks': ranks, 'nccl': nccl}


def child_main(mode: str, args) -> int:
  """A child process's work: one JSON object as the last line."""
  logging.basicConfig(level=logging.WARNING)
  result = {'deterministic_step': _child_deterministic_step,
            'dp_step': _child_dp_step,
            'nccl_rank': _child_nccl_rank}[mode](*args)
  print(json.dumps(result), flush=True)
  return 0


if __name__ == '__main__':
  if len(sys.argv) > 2 and sys.argv[1] == CHILD:
    sys.exit(child_main(sys.argv[2], sys.argv[3:]))
  sys.exit(main())
