"""Drive the port's serving, training, RANSAC, held-out evaluation, bench,
gather-bench and long-run trainer paths on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases, each printed with its elapsed seconds; any failure raises (exit != 0).
The main paths (6-7d, 7g) read their batches from the dataset's iterators,
made on the card (``generator_kind`` must be ``device-torch``) and log each
batch's build time; the references (4-5c) give the card and the CPU the
host generator's batch:

1. device: a CUDA card must be present; prints its name and power limit;
2. build: compiles the eight CUDA kernels of ``snap_tpu_torch/csrc`` (one
   nvcc call); prints the SASS instructions of B4's, B7's and K1's loops
   (``cuobjdump``);
3. kernels: K1 (``lift_topk_fwd``), K2 (``patch_sample_2d``), K3
   (``lift_topk_bwd``) and K4 (``patch_sample_2d_bwd``) on seeded inputs at
   the flagship shapes and the training batch of 2 against their plain
   PyTorch versions (K3's inputs hold single-view points and unselected
   ranks, and repeat a rank for exact score ties); B4 (``pose_scoring``) on
   seeded inputs at the eval shape with transformed points on cell edges,
   borders and off the map, mask on and off; B7 (``pose_scoring_bwd``) at
   the training shape (batch 2, 10,001 poses, 4,652 points, 120 x 160) on
   the same kind of inputs, mask on and off, with invalid points, a run of
   2,000 identical poses (every pose of a point adds into the same four
   cells; alone, its sum is held to the closed form) and an example whose
   cotangent is all zero; B5 (``slice_gather``) and B6 (``table_gather``)
   at the gather tool's shapes over all N points;
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
   step 3 agrees under phase 5's tolerances, in phase 5's f32 with TF32 off
   (the bf16 pair's run-to-run spread is logged); a new ``train`` call resumes to
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
   scaled as the other backward kernels'), each with its bound;
   K1, K2, K3, K4, B4 and their library calls timed again with the
   launches queued behind a spin of the card (the card's time alone,
   without the host's launch overhead); K3's selected ranks and K4's points
   by their sorts' bins (count, non-empty bins, the largest), and K2's,
   K3's and K4's device time by launch stage (``torch.profiler``); for
   every launch of each kernel on these inputs,
   its registers, shared memory and spills and the blocks per SM the card
   keeps resident at that launch's shape (``kernels.occupancy``); K1 and
   K2 also checked and timed on the held-out run's f32 inputs, behind a
   spin too, ``F.grid_sample`` in f32 beside K2.

The line before the last is a JSON object with one entry per kernel (K1
and K2 launches from the serving run, K3 and K4 from the training run, B4
from the RANSAC run, B7 from the RANSAC training run, B5 and B6 from the
gather bench), one for B4 at the RANSAC training run's inputs
(``/train``, launches from that run) and two for K1 and K2 at the
held-out run's f32 inputs (``/heldout_f32``, launches from that run); the
last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import logging
import math
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
from snap_tpu_torch.utils import geometry
from snap_tpu_torch.utils import grids
from snap_tpu_torch.train_lib import checkpoints
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
# f32 and differ by summation order (the backward kernels add with atomics,
# in an order that changes from run to run), then by one rounding of the
# output dtype. The backward kernels are linear in the cotangent and are
# checked on cotangents scaled to a largest entry in [1, 2) (see
# unit_cotangent), so that atol stays far below the gradient it bounds.
TOLERANCES = {torch.bfloat16: (1e-3, 2.0**-7), torch.float32: (1e-4, 1e-5)}
# Training reference, card against CPU in f32 with TF32 off: cuDNN, cuFFT
# and the atomics sum in other orders than the CPU, and where two values
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
NEAR_TIE_RTOL = 1e-4
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

STREET_ROOT = 'bev_mapper.streetview_encoder.image_encoder.encoder.root_block.conv_root.weight'
PROJ_MLP = 'bev_mapper.streetview_encoder.proj_mlp.Dense_0.weight'
AERIAL_TRUNK = 'bev_mapper.aerial_encoder.encoder.'


def log(msg: str) -> None:
  print(f'[{time.perf_counter() - T0:7.1f}s] {msg}', flush=True)


def assert_close(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
  atol, rtol = TOLERANCES[want.dtype]
  got, want = got.float(), want.float()
  err = (got - want).abs()
  bad = err > atol + rtol * want.abs()
  if bad.any() or not torch.isfinite(got).all():
    raise AssertionError(
        f'{name}: {int(bad.sum())} of {got.numel()} values off, max abs err '
        f'{float(err.max()):.3g} (atol {atol}, rtol {rtol})')
  return float(err.max())


def check_lift(args, kwargs) -> float:
  """K1 against its plain version on the same CUDA inputs; max abs error."""
  stats, valid = kernels.lift_topk_fwd(*args, **kwargs)
  stats_p, valid_p = view_scan.lift_topk_plain(*args, **kwargs)
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


def assert_close_bwd(name: str, got: torch.Tensor, want: torch.Tensor
                     ) -> float:
  """``assert_close``, and the gradient must stand well above atol."""
  atol = TOLERANCES[want.dtype][0]
  peak = float(want.abs().max())
  if not peak > 10 * atol:
    raise AssertionError(f'{name}: largest entry {peak:.3g} is within 10x '
                         f'of atol {atol}; the check would be vacuous')
  return assert_close(name, got, want)


def without_near_ties(args, kwargs):
  """``args`` with g_m zeroed at the points of near but inexact ties of the
  two largest selected scores (see NEAR_TIE_RTOL); and their count."""
  stack, view_idx, p2d, select, depth, g_stats = args
  if view_idx.shape[-1] < 2:
    return args, 0
  ranks = view_scan._lift_ranks(stack, view_idx, p2d, select, depth,
                                **kwargs)
  top = torch.stack([r.score for r in ranks], -1).topk(2, -1).values
  gap = top[..., 0] - top[..., 1]
  near = ((top[..., 1] > view_scan.NEG_INF / 2) & (gap > 0)
          & (gap <= NEAR_TIE_RTOL * top[..., 0].abs().clamp(min=1.0)))
  g_stats = g_stats.clone()
  g_stats[..., -1] = torch.where(near, 0.0, g_stats[..., -1])
  return (*args[:-1], g_stats), int(near.sum())


def check_lift_bwd(args, kwargs) -> float:
  """K3 against its plain version; ``args`` end with ``g_stats``, which is
  scaled by ``unit_cotangent`` and freed of near ties first."""
  args = (*args[:-1], unit_cotangent(args[-1]))
  args, near = without_near_ties(args, kwargs)
  got = kernels.lift_topk_bwd(*args, **kwargs)
  want = view_scan.lift_topk_bwd_plain(*args, **kwargs)
  torch.cuda.synchronize()
  log(f'lift_topk_bwd at {tuple(args[0].shape)}: g_m zeroed at {near} of '
      f'{args[1].shape[0] * args[1].shape[1]} points (near ties)')
  return assert_close_bwd('lift_topk_bwd d_stack', got, want)


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


def seeded_kernel_inputs(device: str):
  """K1-K4 inputs at the flagship shapes and the training batch of 2, from
  a seeded generator."""
  g = torch.Generator(device=device).manual_seed(0)
  b, v, h, w, c, dim, n, k = 2, 20, 45, 60, 160, 128, 1_152_000, 4
  stack = torch.randn((b, v * (h + 1), w + 1, c), generator=g, device=device
                      ).to(torch.bfloat16)
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
                        ).to(torch.bfloat16)
  lift_bwd = ((stack, view_idx, p2d, select, depth, g_stats), lift_kw)
  hq, wq, d, p = 120, 80, 32, 64 * 120 * 80
  plane = torch.randn((b, hq + 1, wq + 1, d + 1), generator=g, device=device)
  plane[..., d] = (plane[..., d] > -1.0).float()
  pts_scale = torch.tensor([hq, wq], dtype=torch.float32, device=device)
  points = torch.rand((b, p, 2), generator=g, device=device) * (
      pts_scale + 4) - 2
  sample = ((plane.to(torch.bfloat16), points), dict(dim=d, has_valid=True))
  g_values = torch.randn((b, p, d), generator=g, device=device
                         ).to(torch.bfloat16)
  sample_bwd = ((g_values, points), dict(plane_shape=tuple(plane.shape)))
  return lift, sample, lift_bwd, sample_bwd


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
  launches, and of all the others together (``torch.profiler``, over
  ``iters`` calls after a warm one)."""
  fn()
  torch.cuda.synchronize()
  with torch.profiler.profile(
      activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
    for _ in range(iters):
      fn()
    torch.cuda.synchronize()
  stages = {name: 0.0 for name in (*names, 'other')}
  for evt in prof.key_averages():
    us = evt.self_device_time_total
    if us <= 0:
      continue
    name = next((n for n in names if n in evt.key), 'other')
    stages[name] += us / 1e3 / iters
  return stages


# Bounds: the larger of the bytes moved over the HBM rate and the f32
# operations over the f32 peak (bench_gather's H100 figures).
_nbytes = bench_gather.nbytes
_bound = bench_gather.bound


def lift_bound(args, kwargs, stats, valid):
  """(bound_ms, bound_by): bytes moved vs f32 operations this input needs."""
  stack, _, _, select, _ = args
  c, dim = stack.shape[-1], kwargs['dim']
  nbytes = _nbytes(*args, stats, valid)
  # Per selected rank: 4-tap combine (8C), depth hat (4S), online-softmax
  # update (5D); per point: the (mean, var) epilogue (5D).
  ops = int(select.sum()) * (8 * c + 4 * (c - dim) + 5 * dim) + (
      select.shape[0] * select.shape[1] * 5 * dim)
  return _bound(nbytes, ops)


def lift_bwd_bound(args, kwargs, d_stack):
  """K3: its inputs read once, ``d stack`` written once; f32 operations."""
  stack, _, _, select, _, _ = args
  c, dim = stack.shape[-1], kwargs['dim']
  nbytes = _nbytes(*args, d_stack)
  # Per selected rank: the 4-tap combine of f and c (8C) and the depth hat
  # (4S), d f and u (8D), d z and d c (2S), and w_tap * [d f, d c] added at
  # 4 taps (8C); per point: the (mean, E2) gradients (10D). K3's recompute
  # of the online-softmax update is a cost of its design, not counted.
  s = c - dim
  ops = int(select.sum()) * (16 * c + 6 * s + 8 * dim) + (
      select.shape[0] * select.shape[1] * 10 * dim)
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


def flips_per_site(flips):
  """``MaxChoices.flips`` of one step summed per site: name -> [outputs
  flipped, outputs, largest gap]; raises where a site flipped more than
  ``MAX_FLIPS_PER_STEP`` outputs."""
  per_site = {}
  for name, n, total, gap in flips:
    count = per_site.setdefault(name, [0, 0, 0.0])
    count[0] += n
    count[1] += total
    count[2] = max(count[2], gap)
  for name, (n, total, _) in per_site.items():
    if n > MAX_FLIPS_PER_STEP:
      raise AssertionError(f'{name}: {n} of {total} max choices flipped in a '
                           f'step (limit {MAX_FLIPS_PER_STEP})')
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
  over ``CHOICE_GAP_RTOL`` (a choice that is no near tie) raises. A context
  manager: the hooks, and ``F.relu``'s stand-in, go on exit.
  """

  def __init__(self, model: torch.nn.Module, replay=None):
    self.calls, self.flips, self.replay = [], [], replay
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
      return own
    recorded = self.replay[len(self.flips)].to(own.device)
    if recorded.shape != own.shape:
      raise AssertionError(f'{name}: recorded choice {tuple(recorded.shape)}'
                           f' against {tuple(own.shape)}')
    flips, total, gap = flips_of(own, recorded)
    self.flips.append((name, flips, total, gap))
    if not gap <= CHOICE_GAP_RTOL:
      raise AssertionError(
          f'{name}: a recorded max choice is {gap:.3g} of the site\'s '
          f'largest magnitude from a tie here (limit {CHOICE_GAP_RTOL})')
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


def training_reference(config_name: str = 'smoke_train_exhaustive'):
  """2 steps of the tiny trainer ``config_name`` on the card and on the CPU in
  lockstep: each step starts both from the CPU's weights, with the same
  batch and draws (the card's, injected on the CPU; on the RANSAC backend
  also its pose samples, which the two devices' f64 prefix sums may round
  to a neighbouring category), and the CPU's maxima pick the entries the
  card's picked (``MaxChoices``); the loss and every gradient leaf agree.
  (Comparing after separate updates would not work: Adam's first update is
  ~lr * sign(g), so a gradient entry near 0 that differs in sign moves its
  weight by 2 lr.) On the RANSAC backend B4 and B7 launch each card step.
  Returns per step the worst leaf error relative to its largest entry and
  to its norm, and the flips per max site."""
  cfg = configs.get_config(config_name)
  ransac = cfg.model.pose_backend == 'ransac'
  card_launches = []
  models = {dev: evaluate.build_localizer(cfg, dev, 0).train()
            for dev in ('cpu', 'cuda')}
  adam = optimizers.Adam(cfg.train)
  states = {dev: trainer.create_train_state(m, adam, seed=0)
            for dev, m in models.items()}
  generator = loader.make_generator(cfg.data, 0)
  worst, worst_norm, losses, flips = [0.0, 0.0], [0.0, 0.0], [], []
  worst_leaf = ['', '']
  for i in range(2):
    models['cuda'].load_state_dict(models['cpu'].state_dict())
    examples = loader.make_train_examples(generator, i, cfg.batch_size,
                                          cfg.data)
    before = dict(kernels.LAUNCHES)
    with MaxChoices(models['cuda']) as on_card:
      card = trainer.train_step(states['cuda'],
                                loader.pair_batch_to_torch(examples, 'cuda'),
                                adam)
    launched = {k: v - before[k] for k, v in kernels.LAUNCHES.items()}
    card_launches.append(launched)
    samples = None
    if ransac:
      if launched['pose_scoring'] < 1 or launched['pose_scoring_bwd'] < 1:
        raise AssertionError(f'step {i}: card step launched {launched}')
      samples = geometry.Transform2D(angle=card.pose_samples.angle.cpu(),
                                     t=card.pose_samples.t.cpu())
    with MaxChoices(models['cpu'], replay=on_card.calls) as replayed:
      cpu = trainer.train_step(states['cpu'],
                               loader.pair_batch_to_torch(examples, 'cpu'),
                               adam, draws=card.draws, pose_samples=samples)
    flips.append({name: f'{n} of {total}, gap {gap:.3g}' for name, (
        n, total, gap) in flips_per_site(replayed.flips).items() if n})
    loss = [trainer.summarize([o.metrics])['loss/total'] for o in (cpu, card)]
    losses.append(loss)
    if not math.isclose(loss[0], loss[1], rel_tol=TRAIN_LOSS_RTOL):
      raise AssertionError(f'step {i}: loss cpu {loss[0]} vs card {loss[1]}')
    for name, want in cpu.grads.items():
      got = card.grads[name].cpu()
      scale = float(want.abs().max())
      err = float((got - want).abs().max())
      norm = float(want.norm())
      err_norm = float((got - want).norm())
      if not err <= TRAIN_GRAD_RTOL * scale + 1e-7:
        raise AssertionError(f'step {i}: gradient of {name} off by {err:.3g} '
                             f'(largest entry {scale:.3g})')
      if not err_norm <= TRAIN_GRAD_NORM_RTOL * norm + 1e-7:
        raise AssertionError(f'step {i}: gradient of {name} off by '
                             f'{err_norm:.3g} in norm (norm {norm:.3g})')
      if err / max(scale, 1e-30) > worst[i]:
        worst[i], worst_leaf[i] = err / max(scale, 1e-30), name
      worst_norm[i] = max(worst_norm[i], err_norm / max(norm, 1e-30))
  log(f'training reference ({config_name}, f32): losses [cpu, '
      f'card] per step {losses}; every gradient leaf within {worst} of '
      f'its largest entry (worst: {worst_leaf}) and within {worst_norm} of '
      f'its norm (per step); '
      f'max choices the card flipped against the CPU\'s own, replayed on '
      f'the CPU (site: outputs over its calls, the largest gap from a tie '
      f'relative to the site\'s largest magnitude), per step {flips}; card '
      f'launches per step {card_launches}')
  return worst, worst_leaf, worst_norm, flips


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
  model = evaluate.build_localizer(configs.bench_full(), 'cuda', 0)
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
}


def training_main_path(smi: str, name: str = 'train_full1chip_exhaustive'):
  """``name`` (a key of ``TRAIN_PATHS``), batch 2, 3 steps; returns
  launches and the captured inputs of the config's kernels to check."""
  least, never, captured = TRAIN_PATHS[name]
  resident = torch.cuda.memory_allocated()  # earlier phases' tensors
  model = evaluate.build_localizer(configs.get_config(name), 'cuda', 0)
  params = dict(model.named_parameters())
  flat = lambda: torch.cat([p.detach().flatten() for p in params.values()])
  before = [flat()]
  per_step, aerial_checked = [], []

  def check_step(step: int, out: trainer.StepOutput) -> None:
    counts = dict(kernels.LAUNCHES)
    prev = per_step[-1][0] if per_step else {k: 0 for k in counts}
    launched = {k: counts[k] - prev[k] for k in counts}
    loss = trainer.summarize([out.metrics])['loss/total']
    if not (math.isfinite(loss) and math.isfinite(out.logs['l2_grads'])
            and out.logs['is_finite'] == 1.0):
      raise AssertionError(f'step {step}: loss {loss}, logs {out.logs}')
    for leaf in (STREET_ROOT, PROJ_MLP, 'temperature'):
      if not out.grads[leaf].abs().max() > 0:
        raise AssertionError(f'step {step}: no gradient reaches {leaf}')
    keep = out.draws.modality_keep.cpu()
    aerial = max(float(g.abs().max()) for n, g in out.grads.items()
                 if n.startswith(AERIAL_TRUNK))
    if bool(keep[1].any()):
      if not aerial > 0:
        raise AssertionError(f'step {step}: aerial kept {keep[1].tolist()} '
                             'but its trunk has no gradient')
      aerial_checked.append(step)
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
    log(f'train step {step} ({name}): loss {loss:.4f}, l2_grads '
        f'{out.logs["l2_grads"]:.4g}, lr {lr:.3g}, params moved {moved:.3g}, '
        f'draws: z jitter {out.draws.z_jitter.tolist()}, modality keep '
        f'[street, aerial] x example {keep.tolist()}; |grad| street root '
        f'{float(out.grads[STREET_ROOT].abs().max()):.3g}, proj '
        f'{float(out.grads[PROJ_MLP].abs().max()):.3g}, aerial trunk '
        f'{aerial:.3g}, temperature {float(out.grads["temperature"]):.3g}; '
        f'launches {launched}')

  workdir = fresh_workdir(name)
  torch.cuda.reset_peak_memory_stats()
  with contextlib.ExitStack() as stack:
    captures = [stack.enter_context(Capture(kernels, kernel, 0))
                for kernel in captured]
    kernels.reset_launch_counts()
    result = train.train(name, 3, 'cuda', seed=0, model=model,
                         on_step=check_step, workdir=workdir)
  shutil.rmtree(workdir)
  # The steps' launches; the eval and checkpoint at the stop step follow.
  launches = per_step[-1][0]
  after_steps = {k: v - launches[k] for k, v in kernels.LAUNCHES.items()
                 if v - launches[k]}
  peak = torch.cuda.max_memory_allocated()
  # The path's own footprint: its peak less what earlier phases still hold.
  TRAIN_PEAK[name] = peak - resident
  if not aerial_checked:
    raise AssertionError('no step kept the aerial modality')
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
      f'phases\' tensors), aerial gradient checked on '
      f'steps {aerial_checked}; the eval at the stop step launched '
      f'{after_steps}, its checkpoint {result["checkpoints"]}; {smi}')
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
  """B7 against its plain version; ``args`` = (g, angle, t, xy,
  valid_points, valid_map), and ``g`` is scaled by ``unit_cotangent``
  first. Where every entry of ``g`` of an example is 0, its gradient must
  be 0."""
  args = (unit_cotangent(args[0]), *args[1:])
  got = kernels.pose_scoring_bwd(*args, **kwargs)
  want = pose_estimation.pose_scoring_bwd_plain(
      *args, **kwargs, pose_chunk=PLAIN_POSE_CHUNK)
  torch.cuda.synchronize()
  silent = ~args[0].any(-1)
  if got[silent].any():
    raise AssertionError('pose_scoring_bwd: an example whose cotangent is 0 '
                         'has a gradient')
  return assert_close_bwd('pose_scoring_bwd d_sim', got, want)


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
  models = {dev: evaluate.build_localizer(cfg, dev, 0)
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
  model = evaluate.build_localizer(configs.eval_full1chip_ransac(), 'cuda', 0)
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
  model = evaluate.build_localizer(configs.eval_full1chip_exhaustive(), 'cpu',
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


def _in_f32(config: configs.Config, state: trainer.TrainState
            ) -> trainer.TrainState:
  """``state`` (its weights, moments, counters and transform) on a model
  that computes in f32."""
  model = evaluate.build_localizer(
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
  model = evaluate.build_localizer(config, 'cpu', seed)
  np.savez(path / evaluator.PARAMS_FILE, **convert.flax_from_torch(
      dict(model.named_parameters()), model))
  (path / evaluator.CHECKPOINT_FILE).write_text(json.dumps({'step': step}))


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
  model = evaluate.build_localizer(config, 'cuda', 0)
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
  restored_model = evaluate.build_localizer(config, 'cuda', 1)
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
  # Phase 5's tolerances are f32's with TF32 off: in bf16 two steps from one
  # state differ run to run by a few % of a leaf's largest entry (the
  # atomics' order, amplified through 50 bf16 layers: ROADMAP C20), so
  # the check runs both states' step in f32 and logs the bf16 pair's spread.
  tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
  torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = (
      False)
  live32, restored32 = _in_f32(config, live), _in_f32(config, restored)
  step3 = _steps_agree(trainer.train_step(live32, batch, live.tx),
                       trainer.train_step(restored32, batch, restored.tx))
  del live32, restored32
  torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
  step3_bf16 = _steps_agree(trainer.train_step(live, batch, live.tx),
                            trainer.train_step(restored, batch, restored.tx),
                            check=False)
  del model, live, restored, restored_model, first, batch, dataset
  torch.cuda.empty_cache()
  log(f'trainer loop, first chunk (train_full1chip_exhaustive, batch 2, '
      f'bf16, steps 1-2): checkpoint 2 saved in {out["save"]["seconds"]:.2f} '
      f's, {out["save"]["bytes"]} bytes; restored into other weights in '
      f'{out["restore_seconds"]:.2f} s, equal bit for bit; step 3 from the '
      f'live and the restored state in f32 (TF32 off): losses {step3[0]}, '
      f'worst gradient leaf {step3[1]:.3g} of its largest entry '
      f'({step3[3]}), {step3[2]:.3g} of its norm; the same in bf16 (not '
      f'held to a tolerance): losses {step3_bf16[0]}, {step3_bf16[1]:.3g} '
      f'({step3_bf16[3]}), {step3_bf16[2]:.3g}; {smi}')

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
  out.update(step3=step3, step3_bf16=step3_bf16, resumed_ms=ms, trace=trace,
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
  init = evaluate.build_localizer(warm, 'cpu', 0).state_dict()
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

  seen['model'] = evaluate.build_localizer(warm, 'cuda', 0)
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


@functools.lru_cache(maxsize=1)
def library_sass():
  """``cuobjdump -sass`` of the kernel library (one call, ~10 s); None
  where the toolkit has no ``cuobjdump``."""
  tool = kernels._nvcc().replace('nvcc', 'cuobjdump')
  try:
    return subprocess.run([tool, '-sass', str(kernels.library_path())],
                          capture_output=True, text=True, timeout=120,
                          check=True).stdout
  except (OSError, subprocess.SubprocessError):
    return None


def sass_loops(function: str):
  """The loops of the compiled kernel whose mangled name contains
  ``function`` (``cuobjdump -sass``): per loop (a predicated backward
  branch; an unpredicated one returns from out-of-line code), its
  instructions and those outside the loops nested in it, largest first;
  None where the toolkit has no ``cuobjdump``."""
  sass = library_sass()
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
      time_ms(lambda: kernels.lift_topk_bwd(*args, **kw)),
      time_ms(lambda: view_scan.lift_topk_bwd_plain(*args, **kw), iters=3),
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
  log(f'patch_sample_2d stages at {tuple(args[1].shape)}, device ms per '
      f'call: {stages}')
  args, kw = lift_bwd.largest()
  queued['lift_topk_bwd'] = time_ms(
      lambda: kernels.lift_topk_bwd(*args, **kw), spin=True)
  stages = kernel_stages_ms(lambda: kernels.lift_topk_bwd(*args, **kw),
                            ('count_kernel', 'scan_kernel', 'ranks_kernel',
                             'runs_kernel'))
  log(f'lift_topk_bwd stages at {tuple(args[0].shape)}, device ms per call: '
      f'{stages}')
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
                            ('bin_points_kernel', 'scan_kernel',
                             'place_points_kernel', 'sum_runs_kernel',
                             'cast_grad_kernel'))
  log(f'patch_sample_2d_bwd stages at {tuple(args[1].shape)}, device ms per '
      f'call (the memset in other): {stages}')
  log(f'ms per call with the launches queued behind a spin of the card '
      f'(host launch overhead hidden; the rows below are timed without): '
      f'{queued}')
  for row, calls in zip(rows, (lift, sample, lift_bwd, sample_bwd)):
    shape = max(calls.calls, key=lambda s: math.prod(s))
    log(f'{row["name"]} at {shape}: {row["ms"]:.4f} ms (plain '
        f'{row["plain_ms"]:.4f} ms, bound {row["bound_ms"]:.4f} ms by '
        f'{row["bound_by"]}, library {row["library_ms"]})')
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
  log(f'SASS loops (instructions, of them outside nested loops), largest '
      f'first: pose_scoring_kernel<false> '
      f'{sass_loops("pose_scoring_kernelILb0E")}, pose_scoring_bwd_kernel'
      f'<false> {sass_loops("pose_scoring_bwd_kernelILb0E")}, '
      f'lift_topk_fwd_kernel<bf16, 1, true> '
      f'{sass_loops("lift_topk_fwd_kernelI13__nv_bfloat16Li1ELb1E")}')

  # 3. Kernels against their plain versions on seeded flagship-shape inputs.
  lift, sample, lift_bwd, sample_bwd = seeded_kernel_inputs('cuda')
  log(f'kernels on seeded inputs: max abs err lift_topk_fwd '
      f'{check_lift(*lift):.3g}, patch_sample_2d {check_sample(*sample):.3g}, '
      f'lift_topk_bwd {check_lift_bwd(*lift_bwd):.3g}, patch_sample_2d_bwd '
      f'{check_sample_bwd(*sample_bwd):.3g}')
  del lift, sample, lift_bwd, sample_bwd
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

  # 7f. The device generator on the card. After the main paths: its
  # profile of one build is this script's first, and later launches on
  # the host-bound paths would pay for it.
  data_on_card(smi)

  # 8. Kernels on the main paths' own inputs: check, then time.
  with torch.no_grad():
    rows = kernel_rows(serve_launches, train_launches, lift, sample,
                       lift_bwd, sample_bwd, lift_f32)
    rows += new_kernel_rows(ransac_launches, bench_launches, scoring,
                            gather_bench)
    rows += ransac_training_rows(ransac_train_launches, scoring_train,
                                 scoring_bwd)
    rows += heldout_rows(heldout_launches, heldout_lift, heldout_sample)
  print(smi, flush=True)
  print(json.dumps({'kernels': rows}), flush=True)
  print(json.dumps({'ok': True, 'device': {
      'platform': 'gpu', 'kind': name, 'count': torch.cuda.device_count()}}),
        flush=True)
  return 0


if __name__ == '__main__':
  sys.exit(main())
