"""B7 (``pose_scoring_bwd``) of two trees on one card, in turns.

As ``tests/torch_k1_ab.py`` does for K1, with ``tests/torch_k3_ab.py``'s
set-up: the other tree's kernels (``--parent``: a checkout's root, whose
``snap_tpu_torch/ops/kernels.py`` is loaded beside this tree's and builds
its own library under its own ``build/``) and this tree's are timed in
turns (parent, change, change, parent) on the B7 call that one training
step of ``train_full1chip_ransac`` gives it (batch 2, 10,001 poses, 4,652
points, 120 x 160; the cotangent as ``chip_smoke.py`` scales it, as
captured and without the GT pose's entry) and on ``chip_smoke.py`` phase
3's seeded 10,001-pose inputs (a run of 2,000 identical poses), mask off
and on. Per row and turn: ms per call (CUDA events over 20 calls) and the
summing kernel's registers, local bytes (spills, stack) and blocks per SM;
per row the entries whose bits differ from the parent's (and by how
much), whether the change equals its plain version bit for bit and ten of
its calls give the same bits, and the most values one cell of a point's
map sums (the longest run of its fold). Then the RANSAC training step's
device ms (``torch.profiler``, 2 steps of a freshly seeded model, B7's own
device ms beside) with each tree's B7 in turns. Card only:

    python3 tests/torch_b7_ab.py --parent checkout_check/parent

One JSON line per row on stdout and in ``--out``.
"""

from __future__ import annotations

import pathlib
import shutil
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
import torch_k3_ab  # noqa: E402
from snap_tpu_torch import configs  # noqa: E402
from snap_tpu_torch import evaluate  # noqa: E402
from snap_tpu_torch import train  # noqa: E402
from snap_tpu_torch.models import pose_estimation  # noqa: E402
from snap_tpu_torch.ops import kernels  # noqa: E402
from snap_tpu_torch.train_lib import trainer  # noqa: E402

CONFIG = 'train_full1chip_ransac'


def longest_run(args, kw, chunk: int = 256) -> int:
  """The most nonzero values that one cell of one point's map sums: the
  taps of the kept poses (``g`` not 0) counted per (example, point, cell),
  ``chunk`` points at a time."""
  g, angle, t, xy, valid_points, valid_map = args
  b, n, h, w = kw['sim_shape']
  most = 0
  for s in range(0, n, chunk):
    taps, valid = pose_estimation._pose_taps(
        angle, t, xy[:, s:s + chunk], valid_map, h, w, kw['cell_size'],
        kw['mask_out_of_bounds'])
    keep = valid_points[:, None, s:s + chunk] & (g[:, :, None] != 0)
    if valid is not None:
      keep = keep & valid
    points = xy[:, s:s + chunk].shape[1]
    where = (torch.arange(b, device=g.device)[:, None, None] * points
             + torch.arange(points, device=g.device)) * (h * w)
    cells = torch.cat([(where + cu * w + cv)[keep & (weight != 0)]
                       for cu, cv, weight in taps])
    if cells.numel():
      most = max(most, int(torch.bincount(cells).max()))
  return most


def turn(module, args, kw):
  fn = lambda: module.pose_scoring_bwd(*args, **kw)
  ms = chip_smoke.time_ms(fn)
  summing = module.occupancy('pose_scoring_bwd')[-1]
  return dict(ms=ms, **{k: summing[k] for k in (
      'registers', 'local_bytes', 'blocks_per_sm', 'dynamic_smem')})


def compare(name, parent, args, kw):
  args = (chip_smoke.unit_cotangent(args[0]), *args[1:])
  got_p = parent.pose_scoring_bwd(*args, **kw)
  got = kernels.pose_scoring_bwd(*args, **kw)
  torch.cuda.synchronize()
  differ = int((got.view(torch.int32) != got_p.view(torch.int32)).sum())
  diff = float((got - got_p).abs().max())
  del got_p
  plain = pose_estimation.pose_scoring_bwd_plain(
      *args, **kw, pose_chunk=chip_smoke.PLAIN_POSE_CHUNK)
  equals_plain = bool(torch.equal(got, plain))
  largest = float(got.abs().max())
  del got, plain
  repeats = chip_smoke.check_pose_scoring_bwd_repeats(args, kw)
  turns = [(label, turn(module, args, kw)) for label, module in (
      ('parent', parent), ('change', kernels), ('change', kernels),
      ('parent', parent))]
  return dict(row=name, poses=args[0].shape[-1], points=list(args[3].shape),
              valid_points=int(args[4].sum()), mask=kw['mask_out_of_bounds'],
              longest_run=longest_run(args, kw),
              entries_differing_from_parent=differ,
              max_diff_vs_parent=diff, largest_entry=largest,
              equals_plain=equals_plain, equal_repeat_calls=repeats,
              turns=turns)


def captured_call():
  """B7's inputs in one training step of ``CONFIG``."""
  model = evaluate.build_model(configs.get_config(CONFIG), 'cuda', 0)
  workdir = chip_smoke.fresh_workdir('b7_ab_capture')
  with chip_smoke.Capture(kernels, 'pose_scoring_bwd', 0) as capture:
    train.train(CONFIG, 1, 'cuda', seed=0, model=model, workdir=str(workdir))
  shutil.rmtree(workdir)
  del model
  torch.cuda.empty_cache()
  return capture.largest()


def step_turn(module, label: str):
  """2 traced steps of a freshly seeded ``CONFIG`` with ``module``'s B7:
  device ms per step, and B7's own device ms per launch."""
  change = kernels.pose_scoring_bwd
  kernels.pose_scoring_bwd = module.pose_scoring_bwd
  try:
    model = evaluate.build_model(configs.get_config(CONFIG), 'cuda', 0)
    workdir = chip_smoke.fresh_workdir(f'b7_ab_{label}')
    with torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA]) as prof:
      train.train(CONFIG, 2, 'cuda', seed=0, model=model,
                  workdir=str(workdir))
    prof.export_chrome_trace(str(workdir / 'traced.json'))
    device_ms = trainer.step_device_ms(workdir / 'traced.json')
    b7 = [(e.self_device_time_total / 1e3 / e.count, e.count)
          for e in prof.key_averages()
          if 'pose_scoring_bwd_kernel' in e.key and e.count]
    shutil.rmtree(workdir)
    del model
  finally:
    kernels.pose_scoring_bwd = change
  torch.cuda.empty_cache()
  return dict(step_device_ms=device_ms, b7_device_ms=b7)


def main() -> int:
  started = torch_k3_ab.start('chiprun_out/b7_ab.json')
  if started is None:
    return 1
  parent, emit = started
  call = captured_call()
  with torch.no_grad():
    emit(compare('train', parent, *call))
    emit(compare('train without the GT pose', parent,
                 *chip_smoke.without_gt_pose(call)))
    del call
    for mask in (False, True):
      emit(compare(f'seeded, mask {mask}', parent,
                   *chip_smoke.seeded_pose_scoring_bwd_inputs('cuda', mask)))
  emit(dict(row='RANSAC training step', config=CONFIG, turns=[
      (label, step_turn(module, label)) for label, module in (
          ('parent', parent), ('change', kernels), ('change', kernels),
          ('parent', parent))]))
  return 0


if __name__ == '__main__':
  sys.exit(main())
