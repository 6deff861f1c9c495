"""Drive the port's serving and training paths on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases, each printed with its elapsed seconds; any failure raises (exit != 0):

1. device: a CUDA card must be present; prints its name and power limit;
2. build: compiles the CUDA kernels of ``snap_tpu_torch/csrc`` (one nvcc
   call);
3. kernels: K1 (``lift_topk_fwd``), K2 (``patch_sample_2d``), K3
   (``lift_topk_bwd``) and K4 (``patch_sample_2d_bwd``) on seeded inputs at
   the flagship shapes and the training batch of 2 against their plain
   PyTorch versions (K3's inputs hold single-view points and unselected
   ranks, and repeat a rank for exact score ties);
4. serving reference: the tiny ``smoke_exhaustive`` localizer on the card
   (f32, TF32 off) against the same model on the CPU (the plain path);
5. training reference: ``smoke_train_exhaustive`` (f32, TF32 off), 2 steps
   on the card and on the CPU in lockstep, each step from the same weights,
   batch and (injected) draws; the loss and every parameter's gradient must
   agree at each step, leaf by leaf in the largest entry and in norm;
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
   launches each step (K1 >= 2, K2 >= 1, K3 >= 2, K4 >= 1);
8. the four kernels against their plain versions again, on the inputs the
   main paths gave them (the backward kernels' cotangents scaled by a power
   of two to a largest entry in [1, 2)), and CUDA-event times of kernel,
   plain version and, for K2 and K4, ``F.grid_sample`` (its input gradient
   for K4) as a library yardstick.

The line before the last is a JSON object with one entry per kernel (K1
and K2 launches from the serving run, K3 and K4 from the training run); the
last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

from snap_tpu_torch import configs
from snap_tpu_torch import evaluate
from snap_tpu_torch import train
from snap_tpu_torch.data import loader
from snap_tpu_torch.ops import kernels
from snap_tpu_torch.ops import view_scan
from snap_tpu_torch.train_lib import optimizers
from snap_tpu_torch.train_lib import trainer

T0 = time.perf_counter()

# H100 SXM peaks (NVIDIA data sheet, 700 W): HBM bytes/s and f32 FLOP/s
# outside the tensor cores, for the kernels' lower bounds.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12

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
TRAIN_LOSS_RTOL = 1e-4
TRAIN_GRAD_RTOL = 1e-2
TRAIN_GRAD_NORM_RTOL = 1e-2

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
  """The tiny localizer on the card (kernels) against the CPU (plain)."""
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
  log(f'serving reference (smoke_exhaustive, f32): best_volume_index '
      f'{cpu_idx.tolist()} equal on card and CPU')


def training_reference() -> None:
  """2 steps of the tiny trainer on the card and on the CPU in lockstep:
  each step starts both from the CPU's weights, with the same batch and
  draws; the loss and every gradient leaf agree. (Comparing after separate
  updates would not work: Adam's first update is ~lr * sign(g), so a
  gradient entry near 0 that differs in sign moves its weight by 2 lr.)"""
  cfg = configs.smoke_train_exhaustive()
  models = {dev: evaluate.build_localizer(cfg, dev, 0).train()
            for dev in ('cpu', 'cuda')}
  adam = optimizers.Adam(cfg.train)
  states = {dev: trainer.create_train_state(m, adam, seed=0)
            for dev, m in models.items()}
  generator = loader.make_generator(cfg.data, 0)
  worst, worst_norm, losses = [0.0, 0.0], [0.0, 0.0], []
  for i in range(2):
    models['cuda'].load_state_dict(models['cpu'].state_dict())
    examples = loader.make_train_examples(generator, i, cfg.batch_size,
                                          cfg.data)
    outs = {}
    for dev in ('cpu', 'cuda'):
      batch = loader.pair_batch_to_torch(examples, dev)
      draws = None if dev == 'cpu' else outs['cpu'].draws  # injected
      outs[dev] = trainer.train_step(states[dev], batch, adam, draws=draws)
    cpu, card = outs['cpu'], outs['cuda']
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
      worst[i] = max(worst[i], err / max(scale, 1e-30))
      worst_norm[i] = max(worst_norm[i], err_norm / max(norm, 1e-30))
  log(f'training reference (smoke_train_exhaustive, f32): losses [cpu, '
      f'card] per step {losses}; every gradient leaf within {worst} of '
      f'its largest entry and within {worst_norm} of its norm (per step)')


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
  ms = [1e3 * s for s in result['batch_seconds']]
  log(f'serving main path: launches {launches}, ms per query {ms}, position '
      f'error {result["position_error_m"]} m (random weights)')
  return launches, lift, sample


def training_main_path(smi: str):
  """train_full1chip_exhaustive, batch 2, 3 steps; returns launches and the
  backward kernels' captured inputs."""
  model = evaluate.build_localizer(configs.train_full1chip_exhaustive(),
                                   'cuda', 0)
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
    for name in (STREET_ROOT, PROJ_MLP, 'temperature'):
      if not out.grads[name].abs().max() > 0:
        raise AssertionError(f'step {step}: no gradient reaches {name}')
    keep = out.draws.modality_keep.cpu()
    aerial = max(float(g.abs().max()) for n, g in out.grads.items()
                 if n.startswith(AERIAL_TRUNK))
    if bool(keep[1].any()):
      if not aerial > 0:
        raise AssertionError(f'step {step}: aerial kept {keep[1].tolist()} '
                             'but its trunk has no gradient')
      aerial_checked.append(step)
    mins = {'lift_topk_fwd': 2, 'patch_sample_2d': 1, 'lift_topk_bwd': 2,
            'patch_sample_2d_bwd': 1}
    for kernel, least in mins.items():
      if launched[kernel] < least:
        raise AssertionError(f'step {step}: {kernel} launched '
                             f'{launched[kernel]} times, expected >= {least}')
    after = flat()
    moved = float((after - before[-1]).abs().max())
    lr = out.logs['learning_rate']
    if (lr > 0) != (moved > 0):
      raise AssertionError(f'step {step}: lr {lr} but params moved {moved}')
    before.append(after)
    per_step.append((counts, launched))
    log(f'train step {step}: loss {loss:.4f}, l2_grads '
        f'{out.logs["l2_grads"]:.4g}, lr {lr:.3g}, params moved {moved:.3g}, '
        f'draws: z jitter {out.draws.z_jitter.tolist()}, modality keep '
        f'[street, aerial] x example {keep.tolist()}; |grad| street root '
        f'{float(out.grads[STREET_ROOT].abs().max()):.3g}, proj '
        f'{float(out.grads[PROJ_MLP].abs().max()):.3g}, aerial trunk '
        f'{aerial:.3g}, temperature {float(out.grads["temperature"]):.3g}; '
        f'launches {launched}')

  torch.cuda.reset_peak_memory_stats()
  with Capture(kernels, 'lift_topk_bwd', 0) as lift_bwd, \
       Capture(kernels, 'patch_sample_2d_bwd', 0) as sample_bwd:
    kernels.reset_launch_counts()
    result = train.train('train_full1chip_exhaustive', 3, 'cuda', seed=0,
                         model=model, on_step=check_step)
    launches = dict(kernels.LAUNCHES)
  peak = torch.cuda.max_memory_allocated()
  if not aerial_checked:
    raise AssertionError('no step kept the aerial modality')
  ms = [1e3 * s for s in result['step_seconds']]
  log(f'training main path (train_full1chip_exhaustive, batch 2, bf16): '
      f'launches {launches}; ms per step {ms} (steps 2-3: '
      f'{sum(ms[1:]) / len(ms[1:]):.1f} ms), host batch build ms '
      f'{[1e3 * s for s in result["batch_seconds"]]}, peak memory '
      f'{peak / 2**30:.2f} GiB, aerial gradient checked on steps '
      f'{aerial_checked}; {smi}')
  del model, params, before, result
  torch.cuda.empty_cache()
  return launches, lift_bwd, sample_bwd


def report(name, source, launches, err, k_ms, p_ms, bound, lib_ms):
  return dict(name=name, route='cuda', source=source,
              replaces='tools/pallas_gather_probe.py:39', launches=launches,
              max_abs_err=err, ms=k_ms, plain_ms=p_ms, bound_ms=bound[0],
              bound_by=bound[1], library_ms=lib_ms)


def kernel_rows(serve_launches, train_launches, lift, sample, lift_bwd,
                sample_bwd):
  """Check each kernel on every captured input, then time it on the
  largest: one JSON row per kernel."""
  errs = {
      'lift_topk_fwd': max(check_lift(*c) for c in lift.calls.values()),
      'patch_sample_2d': max(check_sample(*c) for c in sample.calls.values()),
      'lift_topk_bwd': max(check_lift_bwd(*c)
                           for c in lift_bwd.calls.values()),
      'patch_sample_2d_bwd': max(check_sample_bwd(*c)
                                 for c in sample_bwd.calls.values()),
  }
  log(f'kernels on main-path inputs (lift {list(lift.calls)}, sample '
      f'{list(sample.calls)}, lift_bwd {list(lift_bwd.calls)}, sample_bwd '
      f'{list(sample_bwd.calls)}): max abs err {errs}')

  rows = []
  args, kw = lift.largest()
  out = kernels.lift_topk_fwd(*args, **kw)
  rows.append(report(
      'lift_topk_fwd', 'snap_tpu_torch/csrc/lift_topk_fwd.cu',
      serve_launches['lift_topk_fwd'], errs['lift_topk_fwd'],
      time_ms(lambda: kernels.lift_topk_fwd(*args, **kw)),
      time_ms(lambda: view_scan.lift_topk_plain(*args, **kw), iters=5),
      lift_bound(args, kw, *out), None))
  args, kw = sample.largest()
  out = kernels.patch_sample_2d(*args, **kw)
  rows.append(report(
      'patch_sample_2d', 'snap_tpu_torch/csrc/patch_sample_2d.cu',
      serve_launches['patch_sample_2d'], errs['patch_sample_2d'],
      time_ms(lambda: kernels.patch_sample_2d(*args, **kw)),
      time_ms(lambda: view_scan.patch_sample_2d_plain(*args, **kw)),
      sample_bound(args, kw, *out), time_ms(grid_sample_call(*args))))
  args, kw = lift_bwd.largest()
  out = kernels.lift_topk_bwd(*args, **kw)
  rows.append(report(
      'lift_topk_bwd', 'snap_tpu_torch/csrc/lift_topk_bwd.cu',
      train_launches['lift_topk_bwd'], errs['lift_topk_bwd'],
      time_ms(lambda: kernels.lift_topk_bwd(*args, **kw)),
      time_ms(lambda: view_scan.lift_topk_bwd_plain(*args, **kw), iters=3),
      lift_bwd_bound(args, kw, out), None))
  args, kw = sample_bwd.largest()
  out = kernels.patch_sample_2d_bwd(*args, **kw)
  rows.append(report(
      'patch_sample_2d_bwd', 'snap_tpu_torch/csrc/patch_sample_2d_bwd.cu',
      train_launches['patch_sample_2d_bwd'], errs['patch_sample_2d_bwd'],
      time_ms(lambda: kernels.patch_sample_2d_bwd(*args, **kw)),
      time_ms(lambda: view_scan.patch_sample_2d_bwd_plain(*args, **kw)),
      sample_bwd_bound(args, kw, out),
      time_ms(grid_sample_bwd_call(*args, kw['plane_shape']))))
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

  # 3. Kernels against their plain versions on seeded flagship-shape inputs.
  lift, sample, lift_bwd, sample_bwd = seeded_kernel_inputs('cuda')
  log(f'kernels on seeded inputs: max abs err lift_topk_fwd '
      f'{check_lift(*lift):.3g}, patch_sample_2d {check_sample(*sample):.3g}, '
      f'lift_topk_bwd {check_lift_bwd(*lift_bwd):.3g}, patch_sample_2d_bwd '
      f'{check_sample_bwd(*sample_bwd):.3g}')
  del lift, sample, lift_bwd, sample_bwd

  # 4-5. References: the tiny localizer and trainer, card against CPU.
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  serving_reference()
  training_reference()

  # 6-7. Main paths, each with the launch counts reset just before it.
  serve_launches, lift, sample = serving_main_path()
  train_launches, lift_bwd, sample_bwd = training_main_path(smi)

  # 8. Kernels on the main paths' own inputs: check, then time.
  with torch.no_grad():
    rows = kernel_rows(serve_launches, train_launches, lift, sample,
                       lift_bwd, sample_bwd)
  print(smi, flush=True)
  print(json.dumps({'kernels': rows}), flush=True)
  print(json.dumps({'ok': True, 'device': {
      'platform': 'gpu', 'kind': name, 'count': torch.cuda.device_count()}}),
        flush=True)
  return 0


if __name__ == '__main__':
  sys.exit(main())
