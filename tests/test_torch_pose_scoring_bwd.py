"""Port parity of B7's plain version: the RANSAC scores' gradient in the
per-point score maps (``pose_estimation.pose_scoring_bwd_plain``) and the
autograd ``Function`` that carries it (``_PoseScoring``).

The oracle is ``jax.vjp`` of ``snap_tpu.models.pose_estimation.
pose_scoring_many`` with respect to ``scores_points_all`` (JAX's autodiff
of its ``take_along_axis`` reads, a scatter-add), on the CPU as
tests/conftest.py sets it up; inputs and cotangents drawn with numpy from
a seed. The kernel itself (``csrc/pose_scoring_bwd.cu``) runs on the card
only: tests/test_torch_kernels.py and chip_smoke.py hold it to this plain
version there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from snap_tpu.models import pose_estimation as jpe
from snap_tpu.utils import geometry as jgeometry
from snap_tpu.utils import grids as jgrids
from snap_tpu_torch.models import pose_estimation as pe
from snap_tpu_torch.utils import geometry
from snap_tpu_torch.utils import grids

torch.set_num_threads(2)

# f32 on both sides: each added value (w_u w_v) * (g * keep) is formed
# alike, and a cell sums it over the poses that reach it in another order
# (JAX adds the chunks' cotangents one after another). Without the mask
# the off-map poses' clamped reads pile onto the border cells, whose
# gradients reach 59.4 here: measured worst 1.6e-5 (mask off) and 5.7e-6
# (mask on, largest entry 9.7), held to 1e-5 + 1e-5 of the entry.
GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-5
# The plain version against torch's own autograd of pose_scoring_plain
# (torch.gather's backward): the same values, added in another order;
# measured worst 1.5e-6 on entries up to 9.7.
AUTOGRAD_ATOL = 1e-5
# ``grid_sampler_2d_backward`` (the library call that chip_smoke.py times
# beside B7) reads at the grid's normalized coordinates, which round v -
# 0.5 differently from the plain version's clamp, so every tap weight
# carries an error of a few ulps of the coordinate, small and large cells
# alike: measured worst 2.1e-5 with a largest entry of 27.8 (mask off)
# and 4.8e-6 of 7.0 (mask on), held to 1e-5 of the largest entry.
LIBRARY_TOL = 1e-5


def _inputs(seed, b=2, n=23, h=9, w=11, p=300, cell=0.5):
  """Poses and points with transformed points on cell edges and borders
  (angle 0 and pi / 2 with translations in whole cells, points at cell
  edges), inside and off the map; some points and cells invalid; a seeded
  N(0, 1) cotangent, zero on example 1's last pose."""
  rng = np.random.default_rng(seed)
  angle = rng.uniform(-np.pi, np.pi, size=(b, p)).astype(np.float32)
  t = rng.uniform(-2, [h * cell + 2, w * cell + 2], size=(b, p, 2))
  edge0, edge1 = min(p, 60), min(p, 90)
  angle[:, :edge0] = 0.0
  angle[:, edge0:edge1] = np.float32(np.pi / 2)
  t[:, :edge1] = rng.integers(-2, [h + 2, w + 2], size=(b, edge1, 2)) * cell
  xy = rng.uniform(-2, 2, size=(b, n, 2))
  edge = min(n, 8)
  xy[:, :edge] = rng.integers(-2, 3, size=(b, edge, 2)) * cell
  xy[:, edge:edge + 2] = cell / 2
  sim = rng.normal(size=(b, n, h, w)).astype(np.float32)
  valid_points = rng.random((b, n)) < 0.8
  valid_map = rng.random((b, h, w)) < 0.85
  g = rng.normal(size=(b, p)).astype(np.float32)
  g[1, -1] = 0.0
  return dict(angle=angle, t=t.astype(np.float32), sim=sim,
              xy=xy.astype(np.float32), valid_points=valid_points,
              valid_map=valid_map, g=g, grid=(h, w), cell=cell)


def _torch_args(d):
  return [torch.from_numpy(d[k]) for k in ('angle', 't', 'xy',
                                           'valid_points', 'valid_map')]


def _jax_vjp(d, mask):
  poses = jgeometry.Transform2D.from_radians(jnp.asarray(d['angle']),
                                             jnp.asarray(d['t']))
  jgrid = jgrids.Grid2D(d['grid'], d['cell'])

  def scores(sim):
    return jpe.pose_scoring_many(
        poses, sim, jnp.asarray(d['xy']), jnp.asarray(d['valid_points']),
        jnp.asarray(d['valid_map']), jgrid, mask)

  _, vjp = jax.vjp(scores, jnp.asarray(d['sim']))
  return np.asarray(vjp(jnp.asarray(d['g']))[0])


@pytest.mark.parametrize('mask', [False, True])
def test_pose_scoring_bwd_plain_matches_jax_vjp(mask):
  """P = 4,500 > 4,096: JAX tiles the poses into two chunks (the second
  padded) and adds their cotangents; the port adds per chunk of 1,000."""
  d = _inputs(0, p=4500)
  want = _jax_vjp(d, mask)
  angle, t, xy, valid_points, valid_map = _torch_args(d)
  got = pe.pose_scoring_bwd_plain(
      torch.from_numpy(d['g']), angle, t, xy, valid_points, valid_map,
      sim_shape=d['sim'].shape, cell_size=d['cell'],
      mask_out_of_bounds=mask, pose_chunk=1000)
  assert got.shape == want.shape and got.dtype == torch.float32
  np.testing.assert_allclose(got.numpy(), want, atol=GRAD_ATOL,
                             rtol=GRAD_RTOL)
  # Invalid points get nothing; a valid point's map holds its poses' taps.
  invalid = ~d['valid_points']
  assert invalid.any() and not got.numpy()[invalid].any()
  assert np.abs(want[d['valid_points']]).max() > 1


@pytest.mark.parametrize('mask', [False, True])
def test_pose_scoring_bwd_plain_matches_autograd_of_the_forward(mask):
  d = _inputs(1)
  angle, t, xy, valid_points, valid_map = _torch_args(d)
  sim = torch.from_numpy(d['sim']).requires_grad_()
  kwargs = dict(cell_size=d['cell'], mask_out_of_bounds=mask)
  scores = pe.pose_scoring_plain(angle, t, sim, xy, valid_points, valid_map,
                                 **kwargs, pose_chunk=128)
  g = torch.from_numpy(d['g'])
  want, = torch.autograd.grad(scores, sim, g)
  got = pe.pose_scoring_bwd_plain(g, angle, t, xy, valid_points, valid_map,
                                  sim_shape=tuple(sim.shape), **kwargs,
                                  pose_chunk=128)
  torch.testing.assert_close(got, want, atol=AUTOGRAD_ATOL, rtol=0)


@pytest.mark.parametrize('mask', [False, True])
def test_pose_scoring_gradcheck(mask):
  """``_PoseScoring`` in f64 at a tiny size: its backward is the Jacobian
  of its forward in ``sim`` (linear, so finite differences are exact up to
  rounding)."""
  d = _inputs(2, b=2, n=4, h=5, w=6, p=40, cell=0.5)
  angle, t, xy, valid_points, valid_map = _torch_args(d)
  angle, t, xy = angle.double(), t.double(), xy.double()
  poses = geometry.Transform2D(angle=angle, t=t)
  grid = grids.Grid2D(d['grid'], d['cell'])
  sim = torch.from_numpy(d['sim']).double().requires_grad_()
  assert torch.autograd.gradcheck(
      lambda s: pe.pose_scoring_many(poses, s, xy, valid_points, valid_map,
                                     grid, mask, pose_chunk=16),
      (sim,), eps=1e-6, atol=1e-8, rtol=1e-6)


def test_pose_scoring_many_backward_is_the_plain_backward():
  """Through ``pose_scoring_many`` on the CPU, the gradient is
  ``pose_scoring_bwd_plain``'s, and only ``sim`` may need one."""
  d = _inputs(3)
  angle, t, xy, valid_points, valid_map = _torch_args(d)
  grid = grids.Grid2D(d['grid'], d['cell'])
  sim = torch.from_numpy(d['sim']).requires_grad_()
  scores = pe.pose_scoring_many(geometry.Transform2D(angle=angle, t=t), sim,
                                xy, valid_points, valid_map, grid, True)
  g = torch.from_numpy(d['g'])
  scores.backward(g)
  want = pe.pose_scoring_bwd_plain(g, angle, t, xy, valid_points, valid_map,
                                   sim_shape=tuple(sim.shape),
                                   cell_size=d['cell'],
                                   mask_out_of_bounds=True)
  assert torch.equal(sim.grad, want)
  with pytest.raises(ValueError, match='score maps only'):
    pe.pose_scoring_many(
        geometry.Transform2D(angle=angle.clone().requires_grad_(), t=t),
        sim, xy, valid_points, valid_map, grid, True)


@pytest.mark.parametrize('mask', [False, True])
def test_library_call_computes_the_plain_backward(mask):
  """chip_smoke.py's ``library_ms`` for B7 times one call of
  ``grid_sampler_2d_backward``: on edges, borders and off-map points it
  computes the same ``d sim`` as the plain version."""
  d = _inputs(4, p=2000)
  angle, t, xy, valid_points, valid_map = _torch_args(d)
  kwargs = dict(sim_shape=d['sim'].shape, cell_size=d['cell'],
                mask_out_of_bounds=mask)
  args = (torch.from_numpy(d['g']), angle, t, xy, valid_points, valid_map)
  want = pe.pose_scoring_bwd_plain(*args, **kwargs)
  got = chip_smoke.pose_scoring_bwd_library_call(args, kwargs)()
  largest = float(want.abs().max())
  assert largest > 1
  np.testing.assert_allclose(got.reshape(want.shape).numpy(), want.numpy(),
                             atol=LIBRARY_TOL * largest, rtol=0)
