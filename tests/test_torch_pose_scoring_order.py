"""B7's summation order, held on the CPU: ``pose_scoring_bwd_plain`` (the
kernel's oracle) forms each entry of ``d sim`` as the left fold from +0.0,
over the runs of ``POSE_RUN`` (32) consecutive poses in ascending order, of
each run's left fold from +0.0 of its contributions in ascending pose, a
pose's taps in the order (lower, lower), (lower, upper), (upper, lower),
(upper, upper), whatever its ``pose_chunk``; ``fold_runs`` folds each
key's values in their order.

Inputs drawn with numpy from a seed as in
``tests/test_torch_pose_scoring_bwd.py:_inputs`` (poses on cell edges and
borders and off the map, invalid points and cells), with a run of
identical poses and cotangents that are 0 on some poses. The kernel is
held to the same bits on the card (tests/test_torch_kernels.py,
chip_smoke.py).
"""

import numpy as np
import pytest
import torch

from snap_tpu_torch.models import pose_estimation as pe
from test_torch_pose_scoring_bwd import _inputs
from test_torch_pose_scoring_bwd import _torch_args

torch.set_num_threads(2)


def _order_inputs(seed=0, p=90, **kw):
  """``_inputs`` with poses 30-44 of example 0 one pose (each point's four
  cells take 15 values, in two runs of 32 poses), pose 31's cotangent 0
  there and every third pose's in example 1."""
  d = _inputs(seed, p=p, **kw)
  d['angle'][0, 30:45] = d['angle'][0, 30]
  d['t'][0, 30:45] = d['t'][0, 30]
  d['g'][0, 31] = 0.0
  d['g'][1, ::3] = 0.0
  return d


def _left_fold(d, mask):
  """The stated order by hand: per run of 32 poses, per pose in ascending
  order, per tap in order, each kept value added into the run's sum for
  its cell in f32, one at a time from +0.0; each run's sums then added
  into the cells in f32, one run at a time."""
  angle, t, xy, valid_points, valid_map = _torch_args(d)
  b, n, h, w = d['sim'].shape
  taps, valid = pe._pose_taps(angle, t, xy, valid_map, h, w, d['cell'],
                              mask)
  keep = valid_points[:, None, :]
  if mask:
    keep = keep & valid
  g_keep = torch.from_numpy(d['g'])[:, :, None] * keep
  rows = [(cu.numpy(), cv.numpy(), (weight * g_keep).numpy())
          for cu, cv, weight in taps]
  out = np.zeros((b, n, h, w), np.float32)
  p = angle.shape[1]
  for start in range(0, p, pe.POSE_RUN):
    run = np.zeros((b, n, h, w), np.float32)
    for e in range(b):
      for q in range(start, min(start + pe.POSE_RUN, p)):
        for cu, cv, value in rows:
          for i in range(n):
            cell = (e, i, cu[e, q, i], cv[e, q, i])
            run[cell] = np.float32(run[cell] + value[e, q, i])
    out = (out + run).astype(np.float32)
  return torch.from_numpy(out)


def _plain(d, mask, pose_chunk=pe.POSE_CHUNK, g=None):
  angle, t, xy, valid_points, valid_map = _torch_args(d)
  g = torch.from_numpy(d['g']) if g is None else g
  return pe.pose_scoring_bwd_plain(
      g, angle, t, xy, valid_points, valid_map, sim_shape=d['sim'].shape,
      cell_size=d['cell'], mask_out_of_bounds=mask, pose_chunk=pose_chunk)


@pytest.mark.parametrize('mask', [False, True])
def test_plain_is_the_left_fold_in_pose_then_tap_order(mask):
  d = _order_inputs(n=9, h=6, w=7)
  got = _plain(d, mask)
  want = _left_fold(d, mask)
  assert torch.equal(got, want)
  # The inputs reach what the order must hold to: invalid points, a cell
  # that sums many values (the identical run), a clamped tap on a border
  # cell, and a value that is not the first of its cell.
  assert not d['valid_points'].all() and not got[
      torch.from_numpy(~d['valid_points'])].any()
  _, _, xy, _, valid_map = _torch_args(d)
  taps, _ = pe._pose_taps(*_torch_args(d)[:2], xy, valid_map, 6, 7,
                          d['cell'], mask)
  (lower_u, _, _), (_, _, _), (upper_u, _, _), _ = taps
  assert (lower_u == upper_u).any()
  assert torch.unique(got[got != 0]).numel() > 10


def test_plain_differs_from_another_order_on_these_inputs():
  """The same values summed in descending pose give other bits somewhere:
  the bit-for-bit checks above tell orders apart on these inputs."""
  d = _order_inputs(n=9, h=6, w=7)
  reversed_poses = dict(d, angle=d['angle'][:, ::-1].copy(),
                        t=d['t'][:, ::-1].copy(), g=d['g'][:, ::-1].copy())
  assert not torch.equal(_plain(d, False), _plain(reversed_poses, False))
  torch.testing.assert_close(_plain(d, False), _plain(reversed_poses, False),
                             atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize('mask', [False, True])
@pytest.mark.parametrize('pose_chunk', [1, 7, 128, 'P'])
def test_plain_bits_do_not_depend_on_pose_chunk(pose_chunk, mask):
  d = _order_inputs(seed=3, p=300)
  p = d['angle'].shape[-1]
  got = _plain(d, mask, pose_chunk=p if pose_chunk == 'P' else pose_chunk)
  assert torch.equal(got, _plain(d, mask, pose_chunk=4096))


@pytest.mark.parametrize('bad', [np.nan, np.inf, -np.inf])
def test_non_finite_cotangent_gives_its_example_a_non_finite_gradient(bad):
  d = _order_inputs(seed=5)
  d['g'][0, 50] = bad
  got = _plain(d, False)
  assert not torch.isfinite(got[0]).all()
  assert torch.isfinite(got[1]).all()
  d['g'][0, 50] = 0.0
  assert torch.equal(got[1], _plain(d, False)[1])


def test_fold_runs_is_the_left_fold_of_each_key():
  rng = np.random.default_rng(7)
  key = torch.from_numpy(rng.integers(0, 40, size=3000))
  key[:500] = 17  # one long run
  value = torch.from_numpy(
      (rng.normal(size=3000) * 10.0 ** rng.integers(-4, 5, size=3000)
       ).astype(np.float32))
  keys, sums = pe.fold_runs(key, value)
  want = {}
  for k, v in zip(key.tolist(), value.numpy()):
    want[k] = np.float32(want.get(k, np.float32(0)) + v)
  assert sorted(keys.tolist()) == sorted(want)
  assert torch.equal(sums, torch.tensor([want[k] for k in keys.tolist()]))
  empty_keys, empty_sums = pe.fold_runs(key[:0], value[:0])
  assert empty_keys.numel() == 0 and empty_sums.numel() == 0
