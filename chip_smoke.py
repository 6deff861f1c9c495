"""Drive the port's serving path once on one NVIDIA GPU (H100) and check it.

    python3 chip_smoke.py

Phases, each printed with its elapsed seconds; any failure raises (exit != 0):

1. device: a CUDA card must be present; prints its name and power limit;
2. build: compiles the CUDA kernels of ``snap_tpu_torch/csrc`` with nvcc;
3. kernels: K1 (``lift_topk_fwd``) and K2 (``patch_sample_2d``) on seeded
   inputs at the flagship shapes against their plain PyTorch versions;
4. reference: the tiny ``smoke_exhaustive`` localizer on the card (f32,
   TF32 off) against the same model on the CPU (the plain path);
5. main path: ``snap_tpu_torch.evaluate`` on ``bench_full`` (R50, 20 views
   of 180x240, 120x160x60 voxels, 64 rotations + refinement, bf16, random
   seeded weights), batch 1, 2 synthetic queries; both kernels must launch;
6. the kernels against their plain versions again, on the inputs the main
   path gave them, and CUDA-event times of kernel, plain version and, for
   K2, ``F.grid_sample`` as a library yardstick.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

from snap_tpu_torch import configs
from snap_tpu_torch import evaluate
from snap_tpu_torch.ops import kernels
from snap_tpu_torch.ops import view_scan

T0 = time.perf_counter()

# H100 SXM peaks (NVIDIA data sheet, 700 W): HBM bytes/s and f32 FLOP/s
# outside the tensor cores, for the kernels' lower bounds.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12

# Tolerances, kernel against plain version (both accumulate in f32; they
# differ by summation order, then by one rounding of the output dtype).
TOLERANCES = {torch.bfloat16: (1e-3, 2.0**-7), torch.float32: (1e-4, 1e-5)}


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


def seeded_kernel_inputs(device: str):
  """K1/K2 inputs at the flagship shapes, from a seeded generator."""
  g = torch.Generator(device=device).manual_seed(0)
  b, v, h, w, c, dim, n, k = 1, 20, 45, 60, 160, 128, 1_152_000, 4
  stack = torch.randn((b, v * (h + 1), w + 1, c), generator=g, device=device
                      ).to(torch.bfloat16)
  view_idx = torch.randint(0, v, (b, n, k), generator=g, device=device,
                           dtype=torch.int32)
  scale = torch.tensor([h, w], dtype=torch.float32, device=device)
  p2d = torch.rand((b, n, k, 2), generator=g, device=device) * (scale + 2) - 1
  select = torch.rand((b, n, k), generator=g, device=device) < 0.7
  depth = torch.rand((b, n, k), generator=g, device=device) * 40
  lift = ((stack, view_idx, p2d, select, depth),
          dict(h=h, w=w, dim=dim, depth_min_max=(1.0, 32.0)))
  hq, wq, d, p = 120, 80, 32, 64 * 120 * 80
  plane = torch.randn((b, hq + 1, wq + 1, d + 1), generator=g, device=device)
  plane[..., d] = (plane[..., d] > -1.0).float()
  pts_scale = torch.tensor([hq, wq], dtype=torch.float32, device=device)
  points = torch.rand((b, p, 2), generator=g, device=device) * (
      pts_scale + 4) - 2
  sample = ((plane.to(torch.bfloat16), points), dict(dim=d, has_valid=True))
  return lift, sample


def time_ms(fn, iters: int = 20) -> float:
  """Mean CUDA-event time of ``fn()`` over ``iters`` launches, after warmup."""
  fn()
  torch.cuda.synchronize()
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  start.record()
  for _ in range(iters):
    fn()
  end.record()
  torch.cuda.synchronize()
  return start.elapsed_time(end) / iters


def _nbytes(*tensors) -> int:
  return sum(t.numel() * t.element_size() for t in tensors)


def _bound(nbytes: int, ops: int):
  """(bound_ms, bound_by): the larger of the bytes time and the ops time."""
  t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS
  return max(t_bytes, t_ops) * 1e3, ('bytes' if t_bytes >= t_ops
                                     else 'operations')


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


def sample_bound(args, kwargs, values, valid):
  padded, points = args
  nbytes = _nbytes(padded, points, values, valid)
  ops = points.shape[0] * points.shape[1] * (8 * kwargs['dim'] + 40)
  return _bound(nbytes, ops)


def grid_sample_call(padded: torch.Tensor, points: torch.Tensor):
  """``F.grid_sample`` over the same plane and points (values only)."""
  dim = padded.shape[-1] - 1
  plane = padded[:, :-1, :-1, :dim].permute(0, 3, 1, 2).contiguous()
  h, w = plane.shape[-2:]
  size = torch.tensor([h, w], dtype=torch.float32, device=points.device)
  # (x, y) in [-1, 1]; grid_sample takes the grid in the plane's dtype.
  norm = (points / size * 2 - 1).flip(-1)[:, None].to(plane.dtype)
  return lambda: F.grid_sample(plane, norm, mode='bilinear',
                               padding_mode='border', align_corners=False)


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
  log(f'build: {time.perf_counter() - t:.1f} s ({kernels.library_path().name})')

  # 3. Kernels against their plain versions on seeded flagship-shape inputs.
  lift, sample = seeded_kernel_inputs('cuda')
  log(f'kernels on seeded inputs: max abs err lift_topk_fwd '
      f'{check_lift(*lift):.3g}, patch_sample_2d {check_sample(*sample):.3g}')
  del lift, sample

  # 4. Reference: the tiny localizer on the card against the CPU.
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  ref = {dev: evaluate.evaluate('smoke_exhaustive', 2, dev, seed=0,
                                batch_size=2)['last_pred']
         for dev in ('cpu', 'cuda')}
  cpu_idx = ref['cpu']['best_volume_index']
  gpu_idx = ref['cuda']['best_volume_index'].cpu()
  if not torch.equal(cpu_idx, gpu_idx):
    raise AssertionError(f'best_volume_index cpu {cpu_idx} vs card {gpu_idx}')
  dt = (ref['cpu']['map_t_query'].t - ref['cuda']['map_t_query'].t.cpu())
  if float(dt.abs().max()) > 1e-3:
    raise AssertionError(f'refined translation differs by {dt}')
  log(f'reference (smoke_exhaustive, f32): best_volume_index {cpu_idx.tolist()}'
      ' equal on card and CPU')

  # 5. Main path: bench_full at batch 1 on 2 queries, bf16. The matmuls
  # run in bf16; the f32 refinement conv of bf16 values is exact in TF32.
  torch.backends.cudnn.allow_tf32 = True
  model = evaluate.build_localizer(configs.bench_full(), 'cuda', 0)
  # Keep the first inputs of each shape that the main path hands the kernel
  # wrappers, to check and time the kernels on them afterwards.
  captured = {}
  lift_wrapper, sample_wrapper = view_scan.lift_topk, view_scan.patch_sample_2d

  def capture_lift(*args, **kwargs):
    captured.setdefault(('lift', tuple(args[0].shape)), (args, kwargs))
    return lift_wrapper(*args, **kwargs)

  def capture_sample(*args, **kwargs):
    captured.setdefault(('sample', tuple(args[1].shape)), (args, kwargs))
    return sample_wrapper(*args, **kwargs)

  view_scan.lift_topk, view_scan.patch_sample_2d = capture_lift, capture_sample
  kernels.reset_launch_counts()
  result = evaluate.evaluate('bench_full', 2, 'cuda', seed=0, batch_size=1,
                             model=model)
  launches = dict(kernels.LAUNCHES)
  view_scan.lift_topk, view_scan.patch_sample_2d = lift_wrapper, sample_wrapper
  pred = result['last_pred']
  volume = pred['scores_pose_volume']
  if tuple(volume.shape[1:]) != (64, 239, 239):
    raise AssertionError(f'pose volume {tuple(volume.shape)}')
  if not (torch.isfinite(pred['map_t_query'].t).all()
          and torch.isfinite(pred['map_t_query'].angle).all()):
    raise AssertionError('non-finite pose')
  for kernel, count in launches.items():
    if count == 0:
      raise AssertionError(f'{kernel} was not launched on the main path')
  ms = [1e3 * s for s in result['batch_seconds']]
  log(f'main path: launches {launches}, ms per query {ms}, position error '
      f'{result["position_error_m"]} m (random weights)')

  # 6. Kernels on the main path's own inputs: check, then time.
  lift_keys = sorted((k for k in captured if k[0] == 'lift'),
                     key=lambda k: -k[1][1])
  sample_keys = sorted((k for k in captured if k[0] == 'sample'),
                       key=lambda k: -k[1][1])
  errs = {
      'lift_topk_fwd': max(check_lift(*captured[k]) for k in lift_keys),
      'patch_sample_2d': max(check_sample(*captured[k]) for k in sample_keys),
  }
  log(f'kernels on main-path inputs {lift_keys + sample_keys}: '
      f'max abs err {errs}')

  report = []
  largs, lkw = captured[lift_keys[0]]
  stats, valid = kernels.lift_topk_fwd(*largs, **lkw)
  bound, bound_by = lift_bound(largs, lkw, stats, valid)
  k_ms = time_ms(lambda: kernels.lift_topk_fwd(*largs, **lkw))
  p_ms = time_ms(lambda: view_scan.lift_topk_plain(*largs, **lkw), iters=5)
  report.append(dict(
      name='lift_topk_fwd', route='cuda',
      source='snap_tpu_torch/csrc/lift_topk_fwd.cu',
      replaces='tools/pallas_gather_probe.py:39',
      launches=launches['lift_topk_fwd'], max_abs_err=errs['lift_topk_fwd'],
      ms=k_ms, plain_ms=p_ms, bound_ms=bound, bound_by=bound_by,
      library_ms=None))
  sargs, skw = captured[sample_keys[0]]
  values, ok = kernels.patch_sample_2d(*sargs, **skw)
  bound, bound_by = sample_bound(sargs, skw, values, ok)
  k_ms = time_ms(lambda: kernels.patch_sample_2d(*sargs, **skw))
  p_ms = time_ms(lambda: view_scan.patch_sample_2d_plain(*sargs, **skw))
  lib_ms = time_ms(grid_sample_call(*sargs))
  report.append(dict(
      name='patch_sample_2d', route='cuda',
      source='snap_tpu_torch/csrc/patch_sample_2d.cu',
      replaces='tools/pallas_gather_probe.py:39',
      launches=launches['patch_sample_2d'],
      max_abs_err=errs['patch_sample_2d'], ms=k_ms, plain_ms=p_ms,
      bound_ms=bound, bound_by=bound_by, library_ms=lib_ms))
  for r, key in zip(report, (lift_keys[0], sample_keys[0])):
    log(f'{r["name"]} at {key[1]}: {r["ms"]:.4f} ms (plain '
        f'{r["plain_ms"]:.4f} ms, bound {r["bound_ms"]:.4f} ms by '
        f'{r["bound_by"]}, library {r["library_ms"]})')

  print(smi, flush=True)
  print(json.dumps({'kernels': report}), flush=True)
  print(json.dumps({'ok': True, 'device': {
      'platform': 'gpu', 'kind': name, 'count': torch.cuda.device_count()}}),
        flush=True)
  return 0


if __name__ == '__main__':
  sys.exit(main())
