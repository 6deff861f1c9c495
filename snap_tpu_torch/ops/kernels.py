"""Build, bind and launch the port's CUDA kernels (``snap_tpu_torch/csrc``).

The sources are compiled by plain ``nvcc`` calls, one per source, all
started together, and linked into a shared library with a C interface,
loaded with ``ctypes``; nothing here includes
PyTorch's headers. The library lands in ``build/kernels/`` at the repo root
(listed in ``.gitignore``), named by a hash of the sources, on first use.

Each launcher checks device, dtype, shape and contiguity, allocates its
outputs with ``torch.empty`` (``torch.zeros`` for K3's f32 accumulation
buffer and counts; K4's C side zeroes its own), launches on the current
CUDA stream, raises on a non-zero ``cudaError_t``, and adds one to its
count in ``LAUNCHES``.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import pathlib
import shutil
import subprocess
import tempfile
import time
from typing import Dict, List, Optional, Tuple

import torch

Tensor = torch.Tensor

CSRC = pathlib.Path(__file__).resolve().parents[1] / 'csrc'
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / 'build' / 'kernels'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-shared', '-Xcompiler', '-fPIC')
BUILD_TIMEOUT_S = 180

# Launches per kernel since the last reset_launch_counts(); each kernel's
# source is csrc/<name>.cu and its C entry point carries the same name.
LAUNCHES = {'lift_topk_fwd': 0, 'patch_sample_2d': 0, 'lift_topk_bwd': 0,
            'patch_sample_2d_bwd': 0, 'pose_scoring': 0,
            'pose_scoring_bwd': 0, 'slice_gather': 0, 'table_gather': 0}

# The C entry points' dtype codes: K1-K4 have an instantiation of each (B4,
# B7 take f32 alone, B5 bf16 alone).
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_lib: Optional[ctypes.CDLL] = None
# K3's calls whose counts are still to be read: the count of selected ranks
# each was given, the one its count stage found (an int32 that the card
# writes into pinned host memory) and an event after its launches.
_LIFT_COUNTS: List[Tuple[int, Tensor, torch.cuda.Event]] = []


def reset_launch_counts() -> None:
  for name in LAUNCHES:
    LAUNCHES[name] = 0


def on_card(t: Tensor, kernel_name: str) -> bool:
  """A wrapper's dispatch on its input's device: True for the kernel
  (CUDA), False for the plain version (CPU); any other device raises."""
  if t.device.type == 'cuda':
    return True
  if t.device.type == 'cpu':
    return False
  raise ValueError(f'{kernel_name}: no kernel for device {t.device}')


def _nvcc() -> str:
  found = shutil.which('nvcc')
  if found:
    return found
  cuda_home = os.environ.get('CUDA_HOME') or '/usr/local/cuda'
  candidate = pathlib.Path(cuda_home) / 'bin' / 'nvcc'
  if candidate.exists():
    return str(candidate)
  raise RuntimeError('nvcc not found: put the CUDA toolkit on PATH or set '
                     'CUDA_HOME to build snap_tpu_torch/csrc.')


def library_path() -> pathlib.Path:
  sources = sorted(CSRC.glob('*.cu')) + sorted(CSRC.glob('*.cuh'))
  digest = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
  for src in sources:
    digest.update(src.name.encode())
    digest.update(src.read_bytes())
  return BUILD_DIR / f'libsnap_kernels-{digest.hexdigest()[:16]}.so'


def build() -> pathlib.Path:
  """Compile every ``csrc/*.cu`` into one .so unless it is already built:
  one ``nvcc -c`` per source, all started together, then one link."""
  target = library_path()
  if target.exists():
    return target
  BUILD_DIR.mkdir(parents=True, exist_ok=True)
  nvcc = _nvcc()
  compile_flags = [f for f in NVCC_FLAGS if f != '-shared']
  deadline = time.monotonic() + BUILD_TIMEOUT_S
  # Build in a temporary directory and rename the library: concurrent
  # builds never see a half-written one.
  with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:

    def start(cmd, name):
      log = open(os.path.join(tmp, f'{name}.log'), 'w+')
      return cmd, log, subprocess.Popen(cmd, stdout=log,
                                        stderr=subprocess.STDOUT)

    def finish(cmd, log, proc):
      try:
        proc.wait(timeout=max(1.0, deadline - time.monotonic()))
      finally:
        if proc.poll() is None:
          proc.kill()
          proc.wait()
        log.seek(0)
        output = log.read()
        log.close()
      if proc.returncode != 0:
        raise RuntimeError(
            f'nvcc failed ({proc.returncode}): {" ".join(cmd)}\n{output}')

    jobs, objects, failures = [], [], []
    try:
      for src in sorted(CSRC.glob('*.cu')):
        objects.append(os.path.join(tmp, f'{src.stem}.o'))
        jobs.append(start([nvcc, *compile_flags, '-c', '-o', objects[-1],
                           str(src)], src.stem))
    finally:
      for job in jobs:  # every job ends (or is killed) before a raise
        try:
          finish(*job)
        except (RuntimeError, subprocess.TimeoutExpired) as e:
          failures.append(e)
    if failures:
      raise failures[0]
    library = os.path.join(tmp, 'library.so')
    finish(*start([nvcc, *NVCC_FLAGS, '-o', library, *objects], 'link'))
    os.replace(library, target)
  return target


class _Occupancy(ctypes.Structure):
  """csrc/launch_log.cuh:KernelOccupancy."""
  _fields_ = [('name', ctypes.c_char_p)] + [
      (field, ctypes.c_int) for field in (
          'threads', 'dynamic_smem', 'registers', 'static_smem',
          'local_bytes', 'blocks_per_sm')]


def load_library() -> ctypes.CDLL:
  """Build (if needed) and load the kernel library; bind argument types."""
  global _lib
  if _lib is not None:
    return _lib
  lib = ctypes.CDLL(str(build()))
  vp, i32, i64, f32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_float)
  lib.lift_topk_fwd.argtypes = [vp] * 7 + [i32] * 14 + [f32] * 3 + [vp]
  lib.patch_sample_2d.argtypes = [vp] * 6 + [i32] * 9 + [vp]
  lib.lift_topk_bwd.argtypes = [vp] * 15 + [i32] * 15 + [f32] * 3 + [vp]
  lib.patch_sample_2d_bwd.argtypes = [vp] * 8 + [i32] * 7 + [vp]
  lib.pose_scoring.argtypes = [vp] * 8 + [i32] * 5 + [f32] + [i32] * 3 + [vp]
  lib.pose_scoring_bwd.argtypes = [vp] * 8 + [i32] * 5 + [f32, i32, i32, vp]
  lib.slice_gather.argtypes = [vp] * 3 + [i64] + [i32] * 3 + [vp]
  lib.table_gather.argtypes = [vp] * 3 + [i64] + [i32] * 3 + [vp]
  for name in LAUNCHES:
    getattr(lib, name).restype = i32
    getattr(lib, f'{name}_occupancy').argtypes = [
        ctypes.POINTER(_Occupancy), i32]
    getattr(lib, f'{name}_occupancy').restype = i32
  _lib = lib
  return lib


def occupancy(name: str) -> Tuple[Dict[str, object], ...]:
  """The launches of the last call of kernel ``name`` (a key of
  ``LAUNCHES``), in order: each one's kernel, block size (``threads``),
  ``dynamic_smem`` bytes, ``registers`` per thread, ``static_smem`` and
  ``local_bytes`` (spills) from ``cudaFuncGetAttributes``, and the
  ``blocks_per_sm`` the card keeps resident at that launch's shape."""
  records = (_Occupancy * 8)()
  count = getattr(load_library(), f'{name}_occupancy')(records, 8)
  if count < 0:
    raise RuntimeError(f'{name}_occupancy failed: cudaError_t {-count}')
  return tuple({field: getattr(r, field) for field, _ in r._fields_}
               | {'name': r.name.decode()} for r in records[:count])


def _check(t: Tensor, name: str, dtype: torch.dtype, shape: Tuple[int, ...],
           device: torch.device) -> None:
  if t.device != device:
    raise ValueError(f'{name} is on {t.device}, expected {device}')
  if t.dtype != dtype:
    raise ValueError(f'{name} has dtype {t.dtype}, expected {dtype}')
  if tuple(t.shape) != tuple(shape):
    raise ValueError(f'{name} has shape {tuple(t.shape)}, expected {shape}')
  if not t.is_contiguous():
    raise ValueError(f'{name} must be contiguous')


def _raise_on_error(code: int, kernel: str) -> None:
  if code != 0:
    raise RuntimeError(f'{kernel} launch failed: cudaError_t {code}')


def stats_width(dim: int, weighted: bool, use_variance: bool,
                add_minmax: bool) -> int:
  """Channels of the lift's statistics ``[mean, var?, max?, min?,
  score_max?]`` over ``dim`` features (``csrc/lift_stats.cuh``)."""
  return dim * (1 + int(use_variance) + 2 * int(add_minmax)) + int(weighted)


def _lift_layout(name: str, stack: Tensor, k: int, *, h: int, w: int,
                 dim: int, use_variance: bool, add_minmax: bool) -> int:
  """Checks K1's and K3's shared arguments; their stats width. The stack
  holds score bins past ``dim`` (weighted fusion) or none."""
  if stack.device.type != 'cuda':
    raise ValueError(f'{name} needs CUDA tensors, got {stack.device}')
  if stack.dtype not in _DTYPE_CODES:
    raise ValueError(f'{name}: unsupported dtype {stack.dtype}')
  _, r, wp, c = stack.shape
  if r % (h + 1) or wp != w + 1 or not 0 < dim <= c:
    raise ValueError(f'stack {tuple(stack.shape)} vs h={h} w={w} dim={dim}')
  if (c * stack.element_size()) % 16 or stack.data_ptr() % 16 or dim % 4:
    raise ValueError(f'{name} needs 16-byte aligned stack rows and '
                     f'dim % 4 == 0, got {c} channels, dim {dim}')
  flagship = c > dim and use_variance and not add_minmax
  if k > 32 or dim > (4 if flagship and name == 'lift_topk_fwd' else 2) * 128:
    raise ValueError(f'{name} supports at most 32 ranks and dim <= 256 '
                     f'(512 in the forward of the layout [mean, var, '
                     f'score_max]), got dim {dim}, {k} ranks')
  if r * wp >= 2**31:
    raise ValueError(f'{name} supports fewer than 2^31 pixels an example, '
                     f'got {r} x {wp}')
  return stats_width(dim, c > dim, use_variance, add_minmax)


def lift_topk_fwd(stack: Tensor, view_idx: Tensor, p2d: Tensor,
                  select: Tensor, depth: Tensor, *, h: int, w: int, dim: int,
                  depth_min_max: Tuple[float, float],
                  use_variance: bool = True, add_minmax: bool = False
                  ) -> Tuple[Tensor, Tensor]:
  """K1 on the card: ``stats [B, N, stats_width(...)]`` (stack dtype),
  ``valid``."""
  b, r, wp, c = stack.shape
  n, k = view_idx.shape[1:]
  width = _lift_layout('lift_topk_fwd', stack, k, h=h, w=w, dim=dim,
                       use_variance=use_variance, add_minmax=add_minmax)
  dev = stack.device
  _check(stack, 'stack', stack.dtype, (b, r, wp, c), dev)
  _check(view_idx, 'view_idx', torch.int32, (b, n, k), dev)
  _check(p2d, 'p2d', torch.float32, (b, n, k, 2), dev)
  _check(select, 'select', torch.bool, (b, n, k), dev)
  _check(depth, 'depth', torch.float32, (b, n, k), dev)
  stats = torch.empty((b, n, width), dtype=stack.dtype, device=dev)
  valid = torch.empty((b, n), dtype=torch.bool, device=dev)
  lo, hi = depth_min_max
  lib = load_library()
  code = lib.lift_topk_fwd(
      stack.data_ptr(), view_idx.data_ptr(), p2d.data_ptr(),
      select.data_ptr(), depth.data_ptr(), stats.data_ptr(), valid.data_ptr(),
      _DTYPE_CODES[stack.dtype], b, n, k, r, wp, c, dim, h, w, int(c > dim),
      int(use_variance), int(add_minmax), width, float(lo), float(hi),
      math.log(hi / lo),
      torch.cuda.current_stream(dev).cuda_stream)
  _raise_on_error(code, 'lift_topk_fwd')
  LAUNCHES['lift_topk_fwd'] += 1
  return stats, valid


def patch_sample_2d(padded: Tensor, points: Tensor, *, dim: int,
                    has_valid: bool) -> Tuple[Tensor, Tensor]:
  """K2 on the card: ``values [B, P, dim]`` (plane dtype), ``valid [B, P]``.

  The kernel first repacks the plane into 16-byte aligned feature rows and
  a uint8 validity plane (scratch allocated here), then samples.
  """
  if padded.device.type != 'cuda':
    raise ValueError(f'patch_sample_2d needs CUDA tensors, got {padded.device}')
  if padded.dtype not in _DTYPE_CODES:
    raise ValueError(f'patch_sample_2d: unsupported dtype {padded.dtype}')
  b, hp, wp, c = padded.shape
  p = points.shape[1]
  if c != dim + int(has_valid):
    raise ValueError(f'plane has {c} channels, expected {dim} + {has_valid}')
  dev = padded.device
  _check(padded, 'padded', padded.dtype, (b, hp, wp, c), dev)
  _check(points, 'points', torch.float32, (b, p, 2), dev)
  if points.data_ptr() % 8:
    raise ValueError('patch_sample_2d needs 8-byte aligned points')
  per_chunk = 16 // padded.element_size()
  dim_padded = -(-dim // per_chunk) * per_chunk
  if b * p * (dim_padded // per_chunk) >= 2**31:
    raise ValueError(f'patch_sample_2d: {b} x {p} points are too many')
  feats = torch.empty((b, hp, wp, dim_padded), dtype=padded.dtype,
                      device=dev)
  valid_plane = torch.empty((b, hp, wp), dtype=torch.uint8, device=dev)
  values = torch.empty((b, p, dim), dtype=padded.dtype, device=dev)
  valid = torch.empty((b, p), dtype=torch.bool, device=dev)
  lib = load_library()
  code = lib.patch_sample_2d(
      padded.data_ptr(), feats.data_ptr(), valid_plane.data_ptr(),
      points.data_ptr(), values.data_ptr(), valid.data_ptr(),
      _DTYPE_CODES[padded.dtype], b, p, hp - 1, wp - 1, c, dim, dim_padded,
      int(has_valid), torch.cuda.current_stream(dev).cuda_stream)
  _raise_on_error(code, 'patch_sample_2d')
  LAUNCHES['patch_sample_2d'] += 1
  return values, valid


def check_lift_counts(wait: bool = False) -> None:
  """Raises if a call of ``lift_topk_bwd`` was given another count of
  selected ranks than its count stage found (its scratch had too few slots,
  or too many; no stage wrote past it). Reads the calls whose launches have
  ended, or with ``wait`` every call after waiting for it. Each call of
  ``lift_topk_bwd`` reads the ended ones first, without a wait."""
  pending, wrong = [], []
  for given, found, done in _LIFT_COUNTS:
    if wait:
      done.synchronize()
    elif not done.query():
      pending.append((given, found, done))
      continue
    if int(found) != given:
      wrong.append((given, int(found)))
  _LIFT_COUNTS[:] = pending
  if wrong:
    raise RuntimeError('lift_topk_bwd: ' + '; '.join(
        f'{given} selected ranks passed, the count stage found {found}'
        for given, found in wrong))


def lift_topk_bwd(stack: Tensor, view_idx: Tensor, p2d: Tensor,
                  select: Tensor, depth: Tensor, g_stats: Tensor, *, h: int,
                  w: int, dim: int, depth_min_max: Tuple[float, float],
                  use_variance: bool = True, add_minmax: bool = False,
                  selected: Optional[int] = None) -> Tensor:
  """K3 on the card: ``d stack`` (stack dtype) from ``g_stats`` = d stats.

  Scratch allocated here for the kernel's stages: per bin (example, view,
  lower-tap pixel) its count and first slot; per rank its place in its
  bin; per point a place on the list of points with more than 4 selected
  ranks; and per selected rank a record, its bin and its f32 ``d f`` row
  (``selected * dim * 4`` bytes, 4.4 GB on the training path).

  ``selected`` is the count of selected ranks, ``select.sum()``, which
  sizes that scratch; None counts them here (a wait for the card). No stage
  writes past it. The count stage's own total is compared with it once the
  call has ended: ``check_lift_counts`` raises on a difference, at this
  wrapper's next call or when asked.
  """
  check_lift_counts()
  b, r, wp, c = stack.shape
  n, k = view_idx.shape[1:]
  width = _lift_layout('lift_topk_bwd', stack, k, h=h, w=w, dim=dim,
                       use_variance=use_variance, add_minmax=add_minmax)
  if c > 8 * 32:
    raise ValueError(f'lift_topk_bwd supports at most 256 channels, got {c}')
  dev = stack.device
  _check(stack, 'stack', stack.dtype, (b, r, wp, c), dev)
  _check(view_idx, 'view_idx', torch.int32, (b, n, k), dev)
  _check(p2d, 'p2d', torch.float32, (b, n, k, 2), dev)
  _check(select, 'select', torch.bool, (b, n, k), dev)
  _check(depth, 'depth', torch.float32, (b, n, k), dev)
  _check(g_stats, 'g_stats', stack.dtype, (b, n, width), dev)
  ranks = b * n * k
  bins = b * (r // (h + 1)) * h * w
  if ranks >= 2**31 or bins >= 2**31:
    raise ValueError(f'lift_topk_bwd: {ranks} ranks, {bins} bins are too many')
  if selected is None:
    selected = int(select.sum())
  if not 0 <= selected <= ranks:
    raise ValueError(f'lift_topk_bwd: {selected} selected of {ranks} ranks')
  counts = torch.zeros((bins + 1,), dtype=torch.int32, device=dev)
  offsets = torch.empty((bins + 1,), dtype=torch.int32, device=dev)
  within = torch.empty((ranks,), dtype=torch.int32, device=dev)
  wide = torch.empty((b * n,), dtype=torch.int32, device=dev)
  slot_bins = torch.empty((selected,), dtype=torch.int32, device=dev)
  records = torch.empty((selected, 4), dtype=torch.float32, device=dev)
  d_f = torch.empty((selected, dim), dtype=torch.float32, device=dev)
  grad = torch.zeros((b, r, wp, c), dtype=torch.float32, device=dev)
  found = torch.empty((1,), dtype=torch.int32, pin_memory=True)
  lo, hi = depth_min_max
  lib = load_library()
  stream = torch.cuda.current_stream(dev)
  code = lib.lift_topk_bwd(
      stack.data_ptr(), view_idx.data_ptr(), p2d.data_ptr(),
      select.data_ptr(), depth.data_ptr(), g_stats.data_ptr(),
      grad.data_ptr(), counts.data_ptr(), offsets.data_ptr(),
      within.data_ptr(), d_f.data_ptr(), records.data_ptr(),
      slot_bins.data_ptr(), wide.data_ptr(), found.data_ptr(),
      _DTYPE_CODES[stack.dtype], b, n, k, r, wp, c, dim, h, w, int(c > dim),
      int(use_variance), int(add_minmax), width, selected, float(lo),
      float(hi), math.log(hi / lo), stream.cuda_stream)
  _raise_on_error(code, 'lift_topk_bwd')
  LAUNCHES['lift_topk_bwd'] += 1
  done = torch.cuda.Event()
  done.record(stream)
  _LIFT_COUNTS.append((selected, found, done))
  return grad.to(stack.dtype)


def patch_sample_2d_bwd(g_values: Tensor, points: Tensor, *,
                        plane_shape: Tuple[int, int, int, int]) -> Tensor:
  """K4 on the card: ``d padded`` ``plane_shape`` in ``g_values``' dtype,
  zero on the validity channel, from ``g_values`` = d values.

  Scratch allocated here for the kernel's stages (it zeroes what it needs
  zeroed): per bin (example, lower-tap cell) its count and first slot; per
  point its place in its bin and its 16-byte record in the sorted order;
  the f32 accumulator of the plane's D channels rounded up to 4.
  """
  if g_values.device.type != 'cuda':
    raise ValueError(
        f'patch_sample_2d_bwd needs CUDA tensors, got {g_values.device}')
  if g_values.dtype not in _DTYPE_CODES:
    raise ValueError(f'patch_sample_2d_bwd: unsupported dtype {g_values.dtype}')
  b, hp, wp, c = plane_shape
  p, dim = g_values.shape[1:]
  if not 0 < dim <= c:
    raise ValueError(f'plane has {c} channels, values {dim}')
  dev = g_values.device
  _check(g_values, 'g_values', g_values.dtype, (b, p, dim), dev)
  _check(points, 'points', torch.float32, (b, p, 2), dev)
  if points.data_ptr() % 8:
    raise ValueError('patch_sample_2d_bwd needs 8-byte aligned points')
  n, bins = b * p, b * (hp - 1) * (wp - 1)
  if not 0 < n < 2**30 or not 0 < bins < 2**30:
    raise ValueError(f'patch_sample_2d_bwd: {n} points, {bins} bins')
  acc = torch.empty((b, hp, wp, -(-dim // 4) * 4), dtype=torch.float32,
                    device=dev)
  counts = torch.empty((bins,), dtype=torch.int32, device=dev)
  offsets = torch.empty((bins + 1,), dtype=torch.int32, device=dev)
  within = torch.empty((n,), dtype=torch.int32, device=dev)
  records = torch.empty((n, 4), dtype=torch.int32, device=dev)
  grad = torch.empty(plane_shape, dtype=g_values.dtype, device=dev)
  lib = load_library()
  code = lib.patch_sample_2d_bwd(
      g_values.data_ptr(), points.data_ptr(), grad.data_ptr(),
      acc.data_ptr(), counts.data_ptr(), offsets.data_ptr(),
      within.data_ptr(), records.data_ptr(), _DTYPE_CODES[g_values.dtype], b,
      p, hp - 1, wp - 1, c, dim, torch.cuda.current_stream(dev).cuda_stream)
  _raise_on_error(code, 'patch_sample_2d_bwd')
  LAUNCHES['patch_sample_2d_bwd'] += 1
  return grad


# B4's block scores POSE_TILE poses (csrc/pose_scoring.cu: kThreads x
# kPosesPerThread); its dynamic shared memory holds two staged maps, the
# staged valid map (with the mask) and a point group of at most
# POSE_MAX_GROUP points, within an H100 block's 227 KB.
POSE_TILE = 768 * 9
POSE_MAX_GROUP = 1024
MAX_DYNAMIC_SMEM = 232_448
# A block's fixed cost (its poses' cos and sin, the first map's copy) in
# points' worth of scoring, for the plan's cost model.
POSE_BLOCK_OVERHEAD_POINTS = 4


def pose_scoring_smem_bytes(h: int, w: int, group: int, mask: bool) -> int:
  """B4's dynamic shared memory per block (the C side's
  ``block_smem_bytes``): two maps of ``h + 1`` rows of ``w + 1``
  floats rounded up to 4, the valid map's bytes alike, 20 B per point
  (its coordinates, footprint and index)."""
  cells = (h + 1) * ((w + 1 + 3) & ~3)
  return 2 * cells * 4 + (((cells + 15) & ~15) if mask else 0) + 20 * group


def pose_scoring_plan(b: int, p: int, n: int, *, sms: int,
                      tile: int = POSE_TILE) -> dict:
  """B4's grid (pose tiles x point groups x examples), one block per SM
  (its shared memory allows no second): the number of groups G that
  minimizes waves x points per group, so that the grid fills whole waves
  where it can."""
  tiles = -(-p // tile)
  g_min = max(1, -(-n // POSE_MAX_GROUP))
  best = None
  for g in range(g_min, max(g_min, min(n, 4 * sms)) + 1):
    group = max(1, -(-n // g))
    if g > 1 and (g - 1) * group >= n:
      continue  # the last group would be empty
    waves = -(-(tiles * g * b) // sms)
    cost = waves * (group + POSE_BLOCK_OVERHEAD_POINTS)
    if best is None or cost < best[0]:
      best = (cost, g, group)
  _, g, group = best
  blocks = tiles * g * b
  return dict(tiles=tiles, groups=g, examples=b, group=group, blocks=blocks,
              waves=blocks / sms)


def pose_scoring(angle: Tensor, t: Tensor, sim: Tensor, xy: Tensor,
                 valid_points: Tensor, valid_map: Tensor, *,
                 cell_size: float, mask_out_of_bounds: bool) -> Tensor:
  """B4 on the card: ``[B, P]`` f32 scores of the poses ``(angle, t)``.

  Two launches from one call when the plan has more than one point group:
  the scoring into ``[B, G, P]`` partial sums (scratch allocated here), then
  their sum per pose. The raw launcher: its gradient is B7
  (``pose_scoring_bwd``), through ``models/pose_estimation.py:_PoseScoring``.
  """
  if sim.device.type != 'cuda':
    raise ValueError(f'pose_scoring needs CUDA tensors, got {sim.device}')
  b, n, h, w = sim.shape
  p = angle.shape[-1]
  dev = sim.device
  _check(angle, 'angle', torch.float32, (b, p), dev)
  _check(t, 't', torch.float32, (b, p, 2), dev)
  _check(sim, 'sim', torch.float32, (b, n, h, w), dev)
  _check(xy, 'xy', torch.float32, (b, n, 2), dev)
  _check(valid_points, 'valid_points', torch.bool, (b, n), dev)
  _check(valid_map, 'valid_map', torch.bool, (b, h, w), dev)
  if not 0 < h < 2**15 or not 0 < w < 2**15:
    raise ValueError(f'pose_scoring: map of {h} x {w} cells')
  plan = pose_scoring_plan(
      b, p, n, sms=torch.cuda.get_device_properties(dev).multi_processor_count)
  smem = pose_scoring_smem_bytes(h, w, plan['group'], mask_out_of_bounds)
  if smem > MAX_DYNAMIC_SMEM:
    raise ValueError(
        f'pose_scoring: a {h} x {w} map does not fit twice in a block\'s '
        f'shared memory ({smem} of {MAX_DYNAMIC_SMEM} bytes)')
  out = torch.empty((b, p), dtype=torch.float32, device=dev)
  g = plan['groups']
  partial = (torch.empty((b, g, p), dtype=torch.float32, device=dev)
             if g > 1 else out)
  lib = load_library()
  code = lib.pose_scoring(
      angle.data_ptr(), t.data_ptr(), sim.data_ptr(), xy.data_ptr(),
      valid_points.data_ptr(), valid_map.data_ptr(), out.data_ptr(),
      partial.data_ptr(), b, p, n, h, w, float(cell_size),
      int(mask_out_of_bounds), g, plan['group'],
      torch.cuda.current_stream(dev).cuda_stream)
  _raise_on_error(code, 'pose_scoring')
  LAUNCHES['pose_scoring'] += 1
  return out


# B7's tiles: 384 poses (12 producer warps of 32), each with one slot (cell,
# value; 8 bytes) in each of the 4 parity classes of the map's cells, two
# tiles in flight.
POSE_BWD_PRODUCERS = 12
POSE_BWD_TILE_BYTES = 2 * 4 * 32 * POSE_BWD_PRODUCERS * 8


def pose_scoring_bwd_smem_bytes(h: int, w: int, mask: bool) -> int:
  """B7's dynamic shared memory per block, which the wrapper passes to the
  launch: one point's ``h x w`` f32 map as 4 planes (one per parity class
  of its cells, ``(h + 1) // 2`` rows of a pitch of ``(w + 1) // 2``
  rounded up to even, plus 2), two tiles of slots, each producer warp's
  marks (a bit per cell of a plane) and, with the mask, the example's
  valid map as bits."""
  plane = (h + 1) // 2 * ((((w + 1) // 2) + 2) & ~1)
  return (16 * plane + POSE_BWD_TILE_BYTES
          + 4 * POSE_BWD_PRODUCERS * ((plane + 31) // 32)
          + (4 * ((h * w + 31) // 32) if mask else 0))


def pose_scoring_bwd(g: Tensor, angle: Tensor, t: Tensor, xy: Tensor,
                     valid_points: Tensor, valid_map: Tensor, *,
                     sim_shape: Tuple[int, int, int, int], cell_size: float,
                     mask_out_of_bounds: bool) -> Tensor:
  """B7 on the card: ``d sim`` ``[B, N, H, W]`` f32 from ``g`` = d scores
  ``[B, P]``, every entry written.

  Two launches from one call: each pose's (cos, sin, t) into ``[B, P, 4]``
  scratch allocated here, then one block per (point, example) that sums the
  point's gradient in shared memory, each entry in the fixed order of
  ``models/pose_estimation.py:pose_scoring_bwd_plain`` (runs of 32
  consecutive poses, each in ascending pose then tap, then the runs in
  order): the same bits on every run, and the plain version's.
  """
  if g.device.type != 'cuda':
    raise ValueError(f'pose_scoring_bwd needs CUDA tensors, got {g.device}')
  b, n, h, w = sim_shape
  p = g.shape[-1]
  dev = g.device
  _check(g, 'g', torch.float32, (b, p), dev)
  _check(angle, 'angle', torch.float32, (b, p), dev)
  _check(t, 't', torch.float32, (b, p, 2), dev)
  _check(xy, 'xy', torch.float32, (b, n, 2), dev)
  _check(valid_points, 'valid_points', torch.bool, (b, n), dev)
  _check(valid_map, 'valid_map', torch.bool, (b, h, w), dev)
  if not 0 < h < 2**15 or not 0 < w < 2**15 or not 0 < b < 2**16:
    raise ValueError(f'pose_scoring_bwd: {b} examples of {h} x {w} cells')
  smem = pose_scoring_bwd_smem_bytes(h, w, mask_out_of_bounds)
  if smem > MAX_DYNAMIC_SMEM:
    raise ValueError(
        f'pose_scoring_bwd: a {h} x {w} map does not fit in a block\'s '
        f'shared memory ({smem} of {MAX_DYNAMIC_SMEM} bytes)')
  d_sim = torch.empty((b, n, h, w), dtype=torch.float32, device=dev)
  poses = torch.empty((b, p, 4), dtype=torch.float32, device=dev)
  lib = load_library()
  code = lib.pose_scoring_bwd(
      g.data_ptr(), angle.data_ptr(), t.data_ptr(), xy.data_ptr(),
      valid_points.data_ptr(), valid_map.data_ptr(), d_sim.data_ptr(),
      poses.data_ptr(), b, p, n, h, w, float(cell_size),
      int(mask_out_of_bounds), smem,
      torch.cuda.current_stream(dev).cuda_stream)
  _raise_on_error(code, 'pose_scoring_bwd')
  LAUNCHES['pose_scoring_bwd'] += 1
  return d_sim


def slice_gather(stack: Tensor, rid: Tensor, *, w: int) -> Tensor:
  """B5 on the card: ``[N, C]`` bf16 sums of the 2x2 taps at ``rid``."""
  if stack.device.type != 'cuda':
    raise ValueError(f'slice_gather needs CUDA tensors, got {stack.device}')
  rows, c = stack.shape
  n = rid.shape[0]
  if c % 8 or stack.data_ptr() % 16:
    raise ValueError('slice_gather needs 16-byte aligned rows of bf16')
  if rows < w + 3:
    raise ValueError(f'stack of {rows} rows holds no 2x2 patch at w={w}')
  dev = stack.device
  _check(stack, 'stack', torch.bfloat16, (rows, c), dev)
  _check(rid, 'rid', torch.int32, (n,), dev)
  out = torch.empty((n, c), dtype=torch.bfloat16, device=dev)
  lib = load_library()
  code = lib.slice_gather(stack.data_ptr(), rid.data_ptr(), out.data_ptr(),
                          n, c, w, rows,
                          torch.cuda.current_stream(dev).cuda_stream)
  _raise_on_error(code, 'slice_gather')
  LAUNCHES['slice_gather'] += 1
  return out


# B6 stages the whole table in 8 KB of shared memory.
TABLE_GATHER_MAX_FLOATS = 2048


def table_gather(table: Tensor, ids: Tensor) -> Tensor:
  """B6 on the card: ``[N, D]`` f32 rows ``table[ids]``."""
  if table.device.type != 'cuda':
    raise ValueError(f'table_gather needs CUDA tensors, got {table.device}')
  rows, d = table.shape
  n = ids.shape[0]
  if d % 4 or rows * d > TABLE_GATHER_MAX_FLOATS or table.data_ptr() % 16:
    raise ValueError(f'table_gather takes aligned tables of at most '
                     f'{TABLE_GATHER_MAX_FLOATS} floats, D % 4 == 0; got '
                     f'{tuple(table.shape)}')
  dev = table.device
  _check(table, 'table', torch.float32, (rows, d), dev)
  _check(ids, 'ids', torch.int32, (n,), dev)
  out = torch.empty((n, d), dtype=torch.float32, device=dev)
  lib = load_library()
  sms = torch.cuda.get_device_properties(dev).multi_processor_count
  code = lib.table_gather(table.data_ptr(), ids.data_ptr(), out.data_ptr(),
                          n, rows, d, sms,
                          torch.cuda.current_stream(dev).cuda_stream)
  _raise_on_error(code, 'table_gather')
  LAUNCHES['table_gather'] += 1
  return out
