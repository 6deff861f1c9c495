"""Port parity of ``models/pose_estimation.py`` (the RANSAC backend's poses).

Inputs are drawn with numpy from a seed and reach both sides as numpy
arrays; the JAX side runs on the CPU as tests/conftest.py sets it up. Where
the JAX function draws from ``jax.random``, the test recomputes the draws
from the same key and injects them into the port (ROADMAP C8).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snap_tpu.models import pose_estimation as jpe
from snap_tpu.utils import geometry as jgeometry
from snap_tpu.utils import grids as jgrids
from snap_tpu_torch.models import pose_estimation as pe
from snap_tpu_torch.utils import geometry
from snap_tpu_torch.utils import grids

torch.set_num_threads(2)

# f32 on both sides; the closed-form fit and the compositions differ in the
# last bits (atan2, sums in another order).
POSE_ATOL = 1e-5
# A score sums ~100 bilinear reads of O(1) values: the two sides agree per
# term to a few ulps and differ by summation order over the points.
SCORE_ATOL, SCORE_RTOL = 1e-5, 1e-5
# The refinement lattice's offsets differ from JAX's by up to 4.8e-7 m and
# 4.2e-9 rad (its jitted linspace rounds some entries otherwise), which
# moves each of ~37 reads of N(0, 1) maps at 0.5 m cells by up to ~1e-6
# times the local slope: measured 2.3e-5 on scores of up to ~6.
REFINE_ATOL = 5e-5


def _t2d(tfm):
  return geometry.Transform2D(angle=torch.from_numpy(np.asarray(tfm.angle)),
                              t=torch.from_numpy(np.asarray(tfm.t)))


def _jt2d(tfm):
  return jgeometry.Transform2D.from_radians(jnp.asarray(tfm.angle.numpy()),
                                            jnp.asarray(tfm.t.numpy()))


@pytest.mark.parametrize('num_points', [2, 7])
def test_kabsch_2d_matches_jax(num_points):
  rng = np.random.default_rng(num_points)
  i_p = rng.normal(size=(3, 5, num_points, 2)).astype(np.float32) * 10
  j_p = rng.normal(size=(3, 5, num_points, 2)).astype(np.float32) * 10
  want, want_rssd = jpe.kabsch_2d(jnp.asarray(i_p), jnp.asarray(j_p))
  got, got_rssd = pe.kabsch_2d(torch.from_numpy(i_p), torch.from_numpy(j_p))
  np.testing.assert_allclose(got.angle.numpy(), np.asarray(want.angle),
                             atol=POSE_ATOL)
  np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t),
                             atol=POSE_ATOL * 10)
  np.testing.assert_allclose(got_rssd.numpy(), np.asarray(want_rssd),
                             atol=1e-3, rtol=1e-4)


def test_kabsch_2d_recovers_a_rigid_motion():
  rng = np.random.default_rng(0)
  j_p = torch.from_numpy(rng.normal(size=(4, 6, 2)).astype(np.float32))
  truth = geometry.Transform2D(angle=torch.tensor([0.3, -2.0, 3.0, 0.0]),
                               t=torch.tensor([[1.0, 2.0], [-3.0, 0.5],
                                               [0.0, 0.0], [7.0, -7.0]]))
  i_p = truth.transform(j_p)
  fit, rssd = pe.kabsch_2d(i_p, j_p)
  np.testing.assert_allclose(fit.angle.numpy(), truth.angle.numpy(),
                             atol=1e-5)
  np.testing.assert_allclose(fit.t.numpy(), truth.t.numpy(), atol=1e-5)
  assert float(rssd.max()) < 1e-2


def _pdf(rng, b, n, h, w):
  logits = rng.normal(size=(b, n, h, w)).astype(np.float32) * 2
  p = np.exp(logits)
  return (p / p.sum((-1, -2), keepdims=True) / n).astype(np.float32)


@pytest.mark.parametrize('num_retries', [1, 3])
def test_sample_transforms_ransac_matches_jax(num_retries):
  """Indices recomputed from the same JAX keys and injected."""
  rng = np.random.default_rng(num_retries)
  b, n, h, w, p = 2, 9, 6, 8, 40
  grid = jgrids.Grid2D((h, w), 0.5)
  prob = _pdf(rng, b, n, h, w)
  xy = rng.uniform(-4, 4, size=(b, n, 2)).astype(np.float32)
  keys = jax.random.split(jax.random.PRNGKey(7), b)
  want = jpe.sample_transforms_ransac(keys, jnp.asarray(prob),
                                      jnp.asarray(xy), p, num_retries, grid)
  draws = p * num_retries * 2
  indices = jax.vmap(lambda k, q: jax.random.choice(
      k, n * h * w, shape=(draws,), replace=True, p=q))(
          keys, jnp.asarray(prob.reshape(b, -1)))
  got = pe.sample_transforms_ransac(
      torch.from_numpy(prob), torch.from_numpy(xy), p, num_retries,
      grids.Grid2D((h, w), 0.5), indices=torch.from_numpy(
          np.asarray(indices)))
  assert got.angle.shape == (b, p)
  np.testing.assert_allclose(got.angle.numpy(), np.asarray(want.angle),
                             atol=POSE_ATOL)
  np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t),
                             atol=POSE_ATOL * 10)


def test_sample_categorical_distribution():
  """The inverse-CDF sampler draws each category at its probability, and
  never one of probability 0 (the first, the last, and one inside)."""
  probs = torch.tensor([[0.0, 0.1, 0.2, 0.0, 0.3, 0.25, 0.15, 0.0],
                        [0.5, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.5]])
  num = 200_000
  draws = pe.sample_categorical(probs, num, torch.Generator().manual_seed(0))
  assert draws.shape == (2, num) and draws.dtype == torch.int64
  for row in range(2):
    counts = torch.bincount(draws[row], minlength=8).double() / num
    p = probs[row].double()
    assert counts[p == 0].sum() == 0
    sigma = torch.sqrt(p * (1 - p) / num)
    assert ((counts - p).abs() <= 5 * sigma + 1e-12).all(), (counts, p)


def test_sample_categorical_reaches_tiny_categories():
  """2^20 categories of mass 1e-8 behind 3 x 2^20 that hold ~99% of the
  mass: an f32 prefix sum, near 1 there, gives almost all of them no width
  (ROADMAP C14); the port's f64 one draws them at their rate."""
  head, tail = 3 << 20, 1 << 20
  probs = torch.cat([torch.full((head,), (1 - tail * 1e-8) / head),
                     torch.full((tail,), 1e-8)])[None]
  f32_width = torch.diff(torch.cumsum(probs[0], 0))[head:]
  assert float((f32_width == 0).double().mean()) > 0.5
  num = 400_000
  draws = pe.sample_categorical(probs, num, torch.Generator().manual_seed(1))
  p = float(probs[0, head:].double().sum())
  got = float((draws >= head).double().mean())
  assert abs(got - p) <= 5 * math.sqrt(p * (1 - p) / num), (got, p)


def test_sample_sparse_query_points_matches_jax():
  rng = np.random.default_rng(3)
  features = rng.normal(size=(6, 8, 5)).astype(np.float32)
  valid = rng.random((6, 8)) < 0.7
  grid = jgrids.Grid2D((6, 8), 0.5)
  key = jax.random.PRNGKey(4)
  want = jpe.sample_sparse_query_points(jnp.asarray(features),
                                        jnp.asarray(valid), key, grid, 11)
  indices = jax.random.choice(key, 48, (11,), replace=False)
  got = pe.sample_sparse_query_points(
      torch.from_numpy(features), torch.from_numpy(valid),
      grids.Grid2D((6, 8), 0.5), 11,
      indices=torch.from_numpy(np.asarray(indices)))
  for g, w in zip(got, want):
    np.testing.assert_array_equal(g.numpy(), np.asarray(w))
  drawn = pe.sample_sparse_query_points(
      torch.from_numpy(features), torch.from_numpy(valid),
      grids.Grid2D((6, 8), 0.5), 48, torch.Generator().manual_seed(0))
  assert sorted((drawn[3][:, 0] * 8 + drawn[3][:, 1]).tolist()) == list(
      range(48))


def test_sample_transforms_random_ranges():
  """Yaw in [0, 2 pi); the grid center maps to within 2/3 of the half
  extents of itself. (The JAX function raises on its own einsum of a bare
  [2] point, ROADMAP C15, so this checks the distribution's support.)"""
  grid = grids.Grid2D((12, 16), 0.5)
  poses = pe.sample_transforms_random(torch.Generator().manual_seed(0),
                                      5000, grid)
  assert float(poses.angle.min()) >= 0 and float(poses.angle.max()) < (
      2 * math.pi)
  half = torch.tensor([3.0, 4.0])
  center = poses.transform(half[None].expand(5000, 1, 2))[:, 0]
  offset = (center - half).abs()
  assert (offset <= half * 4 / 3 + 1e-5).all()
  assert (offset.amax(0) > half * 4 / 3 * 0.95).all()


def _scoring_inputs(seed, b=2, n=37, h=9, w=11, p=300, cell=0.5):
  """Poses and points with transformed points on cell edges and borders
  (angle 0 and pi / 2 with translations in whole cells, the point at a
  cell edge), inside, and off the map."""
  rng = np.random.default_rng(seed)
  angle = rng.uniform(-np.pi, np.pi, size=(b, p)).astype(np.float32)
  t = rng.uniform(-1, [h * cell + 1, w * cell + 1], size=(b, p, 2))
  edge0, edge1 = min(p, 60), min(p, 90)
  angle[:, :edge0] = 0.0
  angle[:, edge0:edge1] = np.float32(np.pi / 2)
  t[:, :edge1] = rng.integers(-2, [h + 2, w + 2], size=(b, edge1, 2)) * cell
  xy = rng.uniform(-2, 2, size=(b, n, 2))
  xy[:, :12] = rng.integers(-2, 3, size=(b, 12, 2)) * cell
  xy[:, 12:16] = cell / 2
  sim = rng.normal(size=(b, n, h, w)).astype(np.float32)
  valid_points = rng.random((b, n)) < 0.8
  valid_map = rng.random((b, h, w)) < 0.85
  return dict(angle=angle, t=t.astype(np.float32), sim=sim,
              xy=xy.astype(np.float32), valid_points=valid_points,
              valid_map=valid_map, grid=(h, w), cell=cell)


@pytest.mark.parametrize('mask', [False, True])
def test_pose_scoring_plain_matches_jax_block(mask):
  d = _scoring_inputs(0)
  jgrid = jgrids.Grid2D(d['grid'], d['cell'])
  poses = jgeometry.Transform2D.from_radians(jnp.asarray(d['angle']),
                                             jnp.asarray(d['t']))
  want = jpe._pose_scoring_block(
      poses, jnp.asarray(d['sim']), jnp.asarray(d['xy']),
      jnp.asarray(d['valid_points']), jnp.asarray(d['valid_map']), jgrid,
      mask)
  got = pe.pose_scoring_plain(
      *(torch.from_numpy(d[k]) for k in ('angle', 't', 'sim', 'xy',
                                         'valid_points', 'valid_map')),
      cell_size=d['cell'], mask_out_of_bounds=mask)
  assert got.shape == (2, 300)
  np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=SCORE_ATOL,
                             rtol=SCORE_RTOL)


@pytest.mark.parametrize('mask', [False, True])
def test_pose_scoring_many_matches_jax_chunked(mask):
  """P = 300 poses in chunks of 128 (not a multiple) on both sides."""
  d = _scoring_inputs(1)
  jgrid = jgrids.Grid2D(d['grid'], d['cell'])
  poses = jgeometry.Transform2D.from_radians(jnp.asarray(d['angle']),
                                             jnp.asarray(d['t']))
  want = jpe.pose_scoring_many(
      poses, jnp.asarray(d['sim']), jnp.asarray(d['xy']),
      jnp.asarray(d['valid_points']), jnp.asarray(d['valid_map']), jgrid,
      mask, pose_chunk=128)
  tposes = geometry.Transform2D(angle=torch.from_numpy(d['angle']),
                                t=torch.from_numpy(d['t']))
  got = pe.pose_scoring_many(
      tposes, torch.from_numpy(d['sim']), torch.from_numpy(d['xy']),
      torch.from_numpy(d['valid_points']), torch.from_numpy(d['valid_map']),
      grids.Grid2D(d['grid'], d['cell']), mask, pose_chunk=128)
  np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=SCORE_ATOL,
                             rtol=SCORE_RTOL)
  whole = pe.pose_scoring_plain(
      *(torch.from_numpy(d[k]) for k in ('angle', 't', 'sim', 'xy',
                                         'valid_points', 'valid_map')),
      cell_size=d['cell'], mask_out_of_bounds=mask, pose_chunk=1000)
  np.testing.assert_array_equal(got.numpy(), whole.numpy())


def test_pose_scoring_plain_keeps_clamped_reads_without_mask():
  """A point far off the map reads the clamped border cell and counts
  unless the mask is on."""
  sim = torch.zeros((1, 1, 3, 4))
  sim[0, 0, 2, 3] = 5.0
  args = (torch.zeros((1, 1)), torch.tensor([[[100.0, 100.0]]]), sim,
          torch.zeros((1, 1, 2)), torch.ones((1, 1), dtype=torch.bool),
          torch.ones((1, 3, 4), dtype=torch.bool))
  kept = pe.pose_scoring_plain(*args, cell_size=1.0,
                               mask_out_of_bounds=False)
  masked = pe.pose_scoring_plain(*args, cell_size=1.0,
                                 mask_out_of_bounds=True)
  assert float(kept) == 5.0 and float(masked) == 0.0


def test_refinement_offsets_match_jax():
  want, want_shape = jpe.make_refinement_offsets()
  got, shape = pe.make_refinement_offsets()
  assert shape == want_shape == (41, 41, 41)
  np.testing.assert_allclose(got.angle.numpy(), np.asarray(want.angle),
                             atol=5e-9)
  np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t), atol=5e-7)


def test_grid_refinement_matches_jax():
  d = _scoring_inputs(2, p=1)
  jgrid = jgrids.Grid2D(d['grid'], d['cell'])
  init = jgeometry.Transform2D.from_radians(
      jnp.asarray(d['angle'][:, 0]), jnp.asarray(d['t'][:, 0]))
  args = [d[k] for k in ('sim', 'xy', 'valid_points', 'valid_map')]
  want, want_scores = jpe.grid_refinement(
      init, *map(jnp.asarray, args), jgrid, False)
  got, scores = pe.grid_refinement(
      _t2d(init), *map(torch.from_numpy, args),
      grids.Grid2D(d['grid'], d['cell']), False)
  assert scores.shape == (2, 41, 41, 41)
  np.testing.assert_allclose(scores.numpy(), np.asarray(want_scores),
                             atol=REFINE_ATOL)
  np.testing.assert_allclose(got.angle.numpy(), np.asarray(want.angle),
                             atol=POSE_ATOL)
  np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t),
                             atol=POSE_ATOL)


def test_pose_scoring_refuses_other_devices():
  d = _scoring_inputs(3, p=4)
  poses = geometry.Transform2D(angle=torch.from_numpy(d['angle']),
                               t=torch.from_numpy(d['t']))
  with pytest.raises(ValueError, match='no kernel for device meta'):
    pe.pose_scoring_many(
        poses, torch.empty(d['sim'].shape, device='meta'),
        torch.from_numpy(d['xy']), torch.from_numpy(d['valid_points']),
        torch.from_numpy(d['valid_map']), grids.Grid2D(d['grid'], d['cell']),
        False)
