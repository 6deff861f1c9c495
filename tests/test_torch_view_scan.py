"""Port parity: the plain versions of K1 (streamed lift) and K2 (patch sampler).

The JAX side runs on the CPU as tests/conftest.py sets it up; inputs come
from a numpy seed and reach both sides as numpy arrays.
"""

import importlib.util
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snap_tpu.ops import view_fusion as jview_fusion
from snap_tpu.ops import view_scan as jview_scan
from snap_tpu.utils import geometry as jgeometry
from snap_tpu.utils import grids as jgrids
from snap_tpu_torch import configs
from snap_tpu_torch.data import loader
from snap_tpu_torch.ops import view_fusion
from snap_tpu_torch.ops import view_scan
from snap_tpu_torch.utils import geometry
from snap_tpu_torch.utils import grids

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parents[1]

# f32 on both sides; the two differ by summation order only.
ATOL, RTOL = 1e-5, 1e-5
# The lift's stats are softmax-weighted over the ranks: a last-bit difference
# in the projected depth moves a score by ~1e-5, and exp() passes that on to
# the weights, so the pooled mean/variance of O(1) features get 1e-4.
LIFT_ATOL, LIFT_RTOL = 1e-4, 1e-4


def _load_pallas_probe():
  spec = importlib.util.spec_from_file_location(
      'pallas_gather_probe', REPO / 'tools' / 'pallas_gather_probe.py')
  module = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(module)
  return module


@pytest.mark.parametrize('channels', [8, 40])
def test_patch_gather_matches_pallas_probe(channels):
  """The plain 2x2xC gather equals P1 (patch_gather_pallas, interpret)."""
  probe = _load_pallas_probe()
  rng = np.random.default_rng(channels)
  r, w, n = 12, 9, 64
  stack = rng.normal(size=(r, w, channels)).astype(np.float32)
  row0 = rng.integers(0, r - 1, size=n).astype(np.int32)
  col0 = rng.integers(0, w - 1, size=n).astype(np.int32)
  want = probe.patch_gather_pallas(
      jnp.asarray(stack), jnp.asarray(row0), jnp.asarray(col0), tile=32,
      interpret=True)
  got = view_scan.gather_bilinear_patches(
      torch.from_numpy(stack)[None], torch.from_numpy(row0)[None],
      torch.from_numpy(col0)[None])[0]
  np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _rig(seed: int, batch: int = 2, num_views: int = 5):
  """Map-scene rigs of the synthetic generator, as numpy dicts."""
  data = configs.DataConfig(num_views=num_views, image_size=(36, 48),
                            voxel_size=1.0, add_rasters=False)
  gen = loader.make_generator(data, seed)
  ex = loader.make_pair_examples(gen, range(batch), data)['map']
  return ex['T_view2scene'], ex['camera']


def _lift_inputs(seed, top_k):
  rng = np.random.default_rng(seed)
  pose, cam = _rig(seed)
  b, v = pose['t'].shape[:2]
  h, w, dim, bins = 9, 12, 16, 8
  f_images = rng.normal(size=(b, v, h, w, dim)).astype(np.float32)
  scores = rng.normal(size=(b, v, h, w, bins)).astype(np.float32)
  xyz = np.stack(np.meshgrid(np.arange(1, 24, 2.0), np.arange(1, 32, 2.0),
                             np.arange(0.25, 6, 1.0), indexing='ij'), -1)
  points = np.broadcast_to(xyz.reshape(1, -1, 3), (b, xyz.size // 3, 3))
  points = (points + rng.uniform(-0.5, 0.5, points.shape)).astype(np.float32)
  return dict(f_images=f_images, scores=scores, pose=pose, cam=cam,
              points=points, top_k=top_k)


def _jax_lift(x):
  pose = jgeometry.Transform3D(R=jnp.asarray(x['pose']['R']),
                               t=jnp.asarray(x['pose']['t']))
  cam = jgeometry.FisheyeCamera.from_dict(x['cam']).scale(
      jnp.asarray([0.25, 0.25]))
  points = jnp.asarray(x['points'])
  out = jview_scan.pool_views_stream(
      jnp.asarray(x['f_images']), jnp.asarray(x['scores']), pose, cam, points,
      top_k=x['top_k'], depth_min_max=(1.0, 32.0), add_minmax=False,
      use_variance=True)
  _, vis, _, _ = jview_fusion.project_points_to_views(pose, cam, points)
  idx, _ = jview_fusion.view_selection(points, pose, vis, 3)
  return out, np.asarray(idx)


def _torch_lift(x):
  pose = geometry.Transform3D(R=torch.from_numpy(x['pose']['R']),
                              t=torch.from_numpy(x['pose']['t']))
  cam = geometry.FisheyeCamera.from_dict(x['cam']).scale(
      torch.tensor([0.25, 0.25]))
  points = torch.from_numpy(np.ascontiguousarray(x['points']))
  out = view_scan.pool_views_stream(
      torch.from_numpy(x['f_images']), torch.from_numpy(x['scores']), pose,
      cam, points, top_k=x['top_k'], depth_min_max=(1.0, 32.0))
  _, vis, _, _ = view_fusion.project_points_to_views(pose, cam, points)
  idx, _ = view_fusion.view_selection(points, pose, vis, 3)
  return out, idx.numpy()


@pytest.mark.parametrize('top_k', [3, 0])
def test_pool_views_stream_matches_jax(top_k):
  """Plain K1 path: exact validity and top-k views, stats within 1e-4."""
  x = _lift_inputs(seed=7 + top_k, top_k=top_k)
  (want, want_idx), (got, got_idx) = _jax_lift(x), _torch_lift(x)
  np.testing.assert_array_equal(got_idx, want_idx)
  np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
  assert got.valid.any() and not got.valid.all()
  np.testing.assert_allclose(got.stats.numpy(), np.asarray(want.stats),
                             atol=LIFT_ATOL, rtol=LIFT_RTOL)
  np.testing.assert_allclose(got.min_distance.numpy(),
                             np.asarray(want.min_distance), rtol=1e-6)


def test_view_selection_fills_with_distinct_invisible_views():
  """With fewer visible views than k, fillers are distinct invisible views."""
  rng = np.random.default_rng(3)
  points = rng.normal(size=(1, 50, 3)).astype(np.float32)
  t = rng.normal(size=(1, 6, 3)).astype(np.float32)
  vis = rng.random((1, 50, 6)) < 0.3
  pose_j = jgeometry.Transform3D(R=jnp.eye(3)[None, None].repeat(6, 1),
                                 t=jnp.asarray(t))
  pose_t = geometry.Transform3D(R=torch.eye(3).expand(1, 6, 3, 3),
                                t=torch.from_numpy(t))
  want, want_min = jview_fusion.view_selection(
      jnp.asarray(points), pose_j, jnp.asarray(vis), 4)
  got, got_min = view_fusion.view_selection(
      torch.from_numpy(points), pose_t, torch.from_numpy(vis), 4)
  np.testing.assert_array_equal(got.numpy(), np.asarray(want))
  np.testing.assert_allclose(got_min.numpy(), np.asarray(want_min), rtol=1e-6)
  assert all(len(set(row)) == 4 for row in got[0].tolist())


def _plane_and_points(seed, with_valid):
  rng = np.random.default_rng(seed)
  h, w, d = 7, 9, 5
  array = rng.normal(size=(h, w, d)).astype(np.float32)
  valid = (rng.random((h, w)) < 0.8) if with_valid else None
  edges = np.array([0.0, 0.2, 0.5, 0.7, 1.0, h - 1.0, h - 0.5, h - 0.3,
                    h - 1e-4, h, -1e-3])
  cols = np.array([0.0, 0.3, 0.5, w - 0.5, w - 0.2, w - 1e-4, 4.4, w, 2.5,
                   0.1, 3.0])
  edge_pts = np.stack(np.meshgrid(edges, cols, indexing='ij'), -1)
  rand_pts = rng.uniform([-1, -1], [h + 1, w + 1], size=(200, 2))
  points = np.concatenate([edge_pts.reshape(-1, 2), rand_pts]).astype(
      np.float32)
  return array, valid, points


@pytest.mark.parametrize('with_valid', [True, False])
def test_interpolate_patch_2d_matches_jax(with_valid):
  """Plain K2 path vs interpolate_patch_2d and interpolate_nd, edges too."""
  array, valid, points = _plane_and_points(11, with_valid)
  jvalid = None if valid is None else jnp.asarray(valid)
  want_v, want_ok = jview_scan.interpolate_patch_2d(
      jnp.asarray(array), jvalid, jnp.asarray(points))
  nd_v, nd_ok = jgrids.interpolate_nd(
      jnp.asarray(array), jnp.asarray(points), jvalid)
  tvalid = None if valid is None else torch.from_numpy(valid)[None]
  got_v, got_ok = view_scan.interpolate_patch_2d(
      torch.from_numpy(array)[None], tvalid, torch.from_numpy(points)[None])
  got_v, got_ok = got_v[0].numpy(), got_ok[0].numpy()
  np.testing.assert_array_equal(got_ok, np.asarray(want_ok))
  np.testing.assert_array_equal(got_ok, np.asarray(nd_ok))
  assert got_ok.any() and not got_ok.all()
  np.testing.assert_allclose(got_v, np.asarray(want_v), atol=ATOL, rtol=RTOL)
  np.testing.assert_allclose(got_v, np.asarray(nd_v), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize('order', [0, 1])
def test_interpolate_nd_matches_jax(order):
  array, valid, points = _plane_and_points(5, True)
  want_v, want_ok = jgrids.interpolate_nd(
      jnp.asarray(array), jnp.asarray(points), jnp.asarray(valid), order=order)
  got_v, got_ok = grids.interpolate_nd(
      torch.from_numpy(array), torch.from_numpy(points),
      torch.from_numpy(valid), order=order)
  np.testing.assert_array_equal(got_ok.numpy(), np.asarray(want_ok))
  np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), atol=ATOL,
                             rtol=RTOL)


def test_wrappers_refuse_other_devices():
  """A tensor that is neither on the CPU nor on a card reaches no fallback."""
  stack = torch.empty((1, 4, 3, 8), device='meta')
  idx = torch.empty((1, 2, 1), dtype=torch.int32, device='meta')
  with pytest.raises(ValueError, match='no kernel'):
    view_scan.lift_topk(stack, idx, idx.float()[..., None].expand(1, 2, 1, 2),
                        idx.bool(), idx.float(), h=1, w=2, dim=4,
                        depth_min_max=(1.0, 32.0))
  with pytest.raises(ValueError, match='no kernel'):
    view_scan.patch_sample_2d(stack, torch.empty((1, 5, 2), device='meta'),
                              dim=7, has_valid=True)


def test_lift_ranks_sum_the_taps_in_the_stated_order():
  """Each rank's ``f`` is the left fold of the four tap products, each
  rounded on its own, taps (0,0), (0,1), (1,0), (1,1) (ROADMAP C10),
  formed here step by step in numpy f32 and held bit for bit; the inputs
  are such that a sum with the products fused into it (an FMA each, formed
  exactly in f64 and rounded once) differs at many entries, and so does
  the fold in another order."""
  rng = np.random.default_rng(7)
  b, v, h, w, c, n, k = 2, 3, 6, 7, 24, 64, 2
  stack = rng.standard_normal((b, v * (h + 1), w + 1, c)).astype(np.float32)
  view_idx = rng.integers(0, v, (b, n, k)).astype(np.int32)
  p2d = (rng.random((b, n, k, 2)) * [h + 1, w + 1] - 0.5).astype(np.float32)
  select = np.ones((b, n, k), bool)
  depth = np.ones((b, n, k), np.float32)
  ranks = view_scan._lift_ranks(
      torch.as_tensor(stack), torch.as_tensor(view_idx),
      torch.as_tensor(p2d), torch.as_tensor(select), torch.as_tensor(depth),
      h=h, w=w, dim=c, depth_min_max=(1.0, 32.0))
  flat = stack.reshape(b, -1, c)
  one = np.float32(1)
  fused_differs = reordered_differs = 0
  for r, rank in enumerate(ranks):
    pts = np.minimum(np.maximum(p2d[:, :, r] - np.float32(0.5), 0),
                     np.array([h - 1, w - 1], np.float32))
    lower = np.floor(pts)
    fi, fj = (pts - lower)[..., 0], (pts - lower)[..., 1]
    tw = [(one - fi) * (one - fj), (one - fi) * fj, fi * (one - fj), fi * fj]
    row0 = view_idx[:, :, r] * (h + 1) + lower[..., 0].astype(np.int32)
    col0 = lower[..., 1].astype(np.int32)
    taps = [flat[np.arange(b)[:, None], (row0 + di) * (w + 1) + col0 + dj]
            for di in (0, 1) for dj in (0, 1)]
    products = [(tw[t][..., None] * taps[t]).astype(np.float32)
                for t in range(4)]
    want = products[0]
    for t in range(1, 4):
      want = (want + products[t]).astype(np.float32)
    np.testing.assert_array_equal(rank.f.numpy().view(np.int32),
                                  want.view(np.int32))
    fused = np.zeros_like(want)
    for t in range(4):
      fused = (tw[t][..., None].astype(np.float64) * taps[t]
               + fused).astype(np.float32)
    reordered = ((products[3] + products[2]) + products[1]) + products[0]
    fused_differs += int((fused != want).sum())
    reordered_differs += int((reordered != want).sum())
  assert fused_differs > 100 and reordered_differs > 100, (
      fused_differs, reordered_differs)
