"""Port parity of the backward halves: K3 (lift) and K4 (patch sampler).

``jax.vjp`` of the JAX package's ``pool_views_stream`` and
``interpolate_patch_2d`` (custom VJPs included, on the CPU as
tests/conftest.py sets it up) against the port's autograd ``Function``s,
whose CPU backward is the kernels' plain version (``*_bwd_plain``), and
against autograd of the plain forward. Inputs and cotangents come from a
numpy seed; f32 on both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snap_tpu.ops import view_fusion as jview_fusion
from snap_tpu.ops import view_scan as jview_scan
from snap_tpu.utils import geometry as jgeometry
from snap_tpu_torch import configs
from snap_tpu_torch.data import loader
from snap_tpu_torch.models import pose_exhaustive_voting as pev
from snap_tpu_torch.ops import view_fusion
from snap_tpu_torch.ops import view_scan
from snap_tpu_torch.utils import geometry
from snap_tpu_torch.utils import grids

torch.set_num_threads(2)

# The lift's forward stats agree to 1e-4 (test_torch_view_scan: a last-bit
# difference in the projected depth moves a score, and exp() passes it on
# to the softmax weights); its gradients go through the same weights, so
# they are held to 1e-4 absolute + 1e-4 relative of the largest entry.
LIFT_ATOL, LIFT_RTOL = 1e-4, 1e-4
# The plain backward against autograd of the plain forward: the same f32
# arithmetic in another order.
SELF_ATOL = 1e-5
# The sampler's gradient is a sum of tap-weighted cotangents: summation
# order only.
SAMPLE_ATOL, SAMPLE_RTOL = 1e-5, 1e-5


def _rig(seed, num_views, batch=2):
  data = configs.DataConfig(num_views=num_views, image_size=(36, 48),
                            voxel_size=1.0, add_rasters=False)
  ex = loader.make_pair_examples(loader.make_generator(data, seed),
                                 range(batch), data)['map']
  return ex['T_view2scene'], ex['camera']


def _lift_inputs(seed, num_views, top_k):
  rng = np.random.default_rng(seed)
  pose, cam = _rig(seed, num_views)
  b, v = pose['t'].shape[:2]
  h, w, dim, bins = 9, 12, 16, 8
  xyz = np.stack(np.meshgrid(np.arange(1, 24, 2.0), np.arange(1, 32, 2.0),
                             np.arange(0.25, 6, 1.0), indexing='ij'), -1)
  points = np.broadcast_to(xyz.reshape(1, -1, 3), (b, xyz.size // 3, 3))
  points = (points + rng.uniform(-0.5, 0.5, points.shape)).astype(np.float32)
  return dict(
      f_images=rng.normal(size=(b, v, h, w, dim)).astype(np.float32),
      scores=rng.normal(size=(b, v, h, w, bins)).astype(np.float32),
      pose=pose, cam=cam, points=points, top_k=top_k,
      cotangent=rng.normal(size=(b, points.shape[1], 2 * dim + 1)
                           ).astype(np.float32))


def _jax_lift_vjp(x, cotangent):
  pose = jgeometry.Transform3D(R=jnp.asarray(x['pose']['R']),
                               t=jnp.asarray(x['pose']['t']))
  cam = jgeometry.FisheyeCamera.from_dict(x['cam']).scale(
      jnp.asarray([0.25, 0.25]))

  def stats(f, s):
    return jview_scan.pool_views_stream(
        f, s, pose, cam, jnp.asarray(x['points']), top_k=x['top_k'],
        depth_min_max=(1.0, 32.0), add_minmax=False,
        use_variance=True).stats

  out, vjp = jax.vjp(stats, jnp.asarray(x['f_images']),
                     jnp.asarray(x['scores']))
  d_f, d_s = vjp(jnp.asarray(cotangent))
  return np.asarray(out), np.asarray(d_f), np.asarray(d_s)


def _torch_lift_vjp(x, cotangent):
  pose = geometry.Transform3D(R=torch.from_numpy(x['pose']['R']),
                              t=torch.from_numpy(x['pose']['t']))
  cam = geometry.FisheyeCamera.from_dict(x['cam']).scale(
      torch.tensor([0.25, 0.25]))
  f = torch.from_numpy(x['f_images']).requires_grad_()
  s = torch.from_numpy(x['scores']).requires_grad_()
  out = view_scan.pool_views_stream(
      f, s, pose, cam, torch.from_numpy(np.ascontiguousarray(x['points'])),
      top_k=x['top_k'], depth_min_max=(1.0, 32.0))
  d_f, d_s = torch.autograd.grad(out.stats, (f, s),
                                 torch.from_numpy(cotangent))
  return out, d_f.numpy(), d_s.numpy()


def _num_selected(x):
  """Selected ranks per point, as the port's forward picks them."""
  pose = geometry.Transform3D(R=torch.from_numpy(x['pose']['R']),
                              t=torch.from_numpy(x['pose']['t']))
  cam = geometry.FisheyeCamera.from_dict(x['cam']).scale(
      torch.tensor([0.25, 0.25]))
  points = torch.from_numpy(np.ascontiguousarray(x['points']))
  _, vis, _, _ = view_fusion.project_points_to_views(pose, cam, points)
  if x['top_k'] and vis.shape[-1] > x['top_k']:
    idx, _ = view_fusion.view_selection(points, pose, vis, x['top_k'])
    vis = torch.gather(vis, 2, idx)
  return vis.sum(-1).numpy()


def _assert_grad_close(got, want, atol, rtol):
  scale = np.abs(want).max()
  np.testing.assert_allclose(got, want, atol=atol + rtol * scale, rtol=0)


@pytest.mark.parametrize('num_views,top_k', [(6, 4), (3, 0)])
@pytest.mark.parametrize('backward', ['plain_bwd', 'autograd_of_plain'])
def test_lift_backward_matches_jax_vjp(monkeypatch, num_views, top_k,
                                       backward):
  """d f_images and d scores_images of the lift against ``jax.vjp``: the
  top-k branch (V=6, k=4) and the all-views branch (V=3), through the
  ``Function``'s plain backward or through autograd of the plain forward."""
  x = _lift_inputs(20 + num_views, num_views, top_k)
  counts = _num_selected(x)
  assert (counts == 1).any() and (counts >= 2).any() and (counts == 0).any()
  if backward == 'autograd_of_plain':
    monkeypatch.setattr(view_scan, 'lift_topk', view_scan.lift_topk_plain)
  want_stats, want_f, want_s = _jax_lift_vjp(x, x['cotangent'])
  out, got_f, got_s = _torch_lift_vjp(x, x['cotangent'])
  np.testing.assert_allclose(out.stats.detach().numpy(), want_stats,
                             atol=LIFT_ATOL, rtol=LIFT_RTOL)
  assert np.abs(want_s).max() > 0 and np.abs(want_f).max() > 0
  _assert_grad_close(got_f, want_f, LIFT_ATOL, LIFT_RTOL)
  _assert_grad_close(got_s, want_s, LIFT_ATOL, LIFT_RTOL)


def test_variance_tie_passes_half_the_gradient():
  """ROADMAP C7: at E2 - mean^2 == 0 exactly (a single-view point), JAX's
  ``jnp.maximum`` passes half the gradient; ``torch.clamp`` (the port's
  former code) passes all of it, ``torch.maximum`` half, as the port now
  does and as K3's tau does."""
  zero = torch.zeros((), requires_grad=True)
  (d_clamp,) = torch.autograd.grad(torch.clamp(zero, min=0), zero)
  (d_max,) = torch.autograd.grad(torch.maximum(zero, torch.zeros(())), zero)
  d_jax = jax.grad(lambda v: jnp.maximum(v, 0.0))(0.0)
  assert float(d_clamp) == 1.0
  assert float(d_max) == float(d_jax) == 0.5


def test_single_view_points_backward_matches_jax():
  """A cotangent on the single-view points only (their variance is an exact
  tie at 0): d f_images and d scores_images against ``jax.vjp``."""
  x = _lift_inputs(23, 3, 0)
  single = _num_selected(x) == 1
  assert single.sum() > 20
  cotangent = x['cotangent'] * single[..., None]
  _, want_f, want_s = _jax_lift_vjp(x, cotangent)
  _, got_f, got_s = _torch_lift_vjp(x, cotangent)
  assert np.abs(want_f).max() > 0
  _assert_grad_close(got_f, want_f, LIFT_ATOL, LIFT_RTOL)
  _assert_grad_close(got_s, want_s, LIFT_ATOL, LIFT_RTOL)


def _raw_lift_inputs(seed, k):
  """Direct K1/K3 inputs: single-view points and unselected ranks too."""
  g = torch.Generator().manual_seed(seed)
  b, v, h, w, dim, bins, n = 2, 5, 7, 9, 12, 6, 400
  stack = torch.randn((b, v * (h + 1), w + 1, dim + bins), generator=g)
  view_idx = torch.randint(0, v, (b, n, k), generator=g, dtype=torch.int32)
  p2d = torch.rand((b, n, k, 2), generator=g) * torch.tensor(
      [h + 2.0, w + 2.0]) - 1
  select = torch.rand((b, n, k), generator=g) < 0.6
  select[:, :40] = False
  select[:, 40:80] = False
  select[:, 40:80, k - 1] = True  # one selected rank, and it is the last
  depth = torch.rand((b, n, k), generator=g) * 40
  g_stats = torch.randn((b, n, 2 * dim + 1), generator=g)
  return (stack, view_idx, p2d, select, depth), g_stats, dict(
      h=h, w=w, dim=dim, depth_min_max=(1.0, 32.0))


@pytest.mark.parametrize('k', [1, 4])
def test_lift_bwd_plain_is_autograd_of_plain_forward(k):
  """K3's oracle equals ``torch.autograd.grad`` of K1's oracle."""
  args, g_stats, kwargs = _raw_lift_inputs(k, k)
  stack = args[0].clone().requires_grad_()
  stats, valid = view_scan.lift_topk_plain(stack, *args[1:], **kwargs)
  assert not valid.all() and valid.any()
  (want,) = torch.autograd.grad(stats, stack, g_stats)
  got = view_scan.lift_topk_bwd_plain(*args, g_stats, **kwargs)
  np.testing.assert_allclose(got.numpy(), want.numpy(), atol=SELF_ATOL,
                             rtol=0)


def test_max_chain_shares_split_ties_like_jnp_maximum():
  """The score max's gradient down its chain of maxima, ties included."""
  scores = [
      [1.0, view_scan.NEG_INF, 2.0, 2.0],
      [3.0, 3.0, 3.0, 1.0],
      [view_scan.NEG_INF, 0.5, 0.5, view_scan.NEG_INF],
  ]
  s = np.asarray(scores, np.float32)

  def chain(z):
    m = jnp.full(z.shape[:1], view_scan.NEG_INF)
    for k in range(z.shape[1]):
      m = jnp.maximum(m, z[:, k])
    return m

  want = jax.grad(lambda z: chain(z).sum())(jnp.asarray(s))
  got = view_scan._max_chain_shares(
      list(torch.from_numpy(s).unbind(1)), torch.ones(3))
  np.testing.assert_array_equal(torch.stack(got, 1).numpy(),
                                np.asarray(want))


def _plane_and_points(seed, points_from='edges'):
  """A 7 x 9 plane of 5 channels, validity and cotangents from a numpy
  seed, and points: on every edge of the plane (low, high, cell centres,
  just inside and just outside) and at random ('edges'), or where 5
  rotated templates read it (``pose_exhaustive_voting.template_points``:
  template order, the rotated corners off the plane, 'templates')."""
  rng = np.random.default_rng(seed)
  h, w, d = 7, 9, 5
  array = rng.normal(size=(h, w, d)).astype(np.float32)
  valid = rng.random((h, w)) < 0.8
  if points_from == 'edges':
    edges = np.array([0.0, 0.2, 0.5, 0.7, 1.0, h - 1.0, h - 0.5, h - 0.3,
                      h - 1e-4, h, -1e-3])
    cols = np.array([0.0, 0.3, 0.5, w - 0.5, w - 0.2, w - 1e-4, 4.4, w, 2.5,
                     0.1, 3.0])
    edge_pts = np.stack(np.meshgrid(edges, cols, indexing='ij'), -1)
    rand_pts = rng.uniform([-1, -1], [h + 1, w + 1], size=(200, 2))
    points = np.concatenate([edge_pts.reshape(-1, 2), rand_pts]).astype(
        np.float32)
  else:
    angles = np.concatenate([[0.0], rng.uniform(0, 2 * np.pi, 4)])
    points = pev.template_points(
        torch.from_numpy(angles.astype(np.float32)),
        grids.Grid2D((h, w), 0.5), 1)[0].numpy()
  cotangent = rng.normal(size=(points.shape[0], d)).astype(np.float32)
  return array, valid, points, cotangent


@pytest.mark.parametrize('backward', ['plain_bwd', 'autograd_of_plain'])
@pytest.mark.parametrize('points_from', ['edges', 'templates'])
@pytest.mark.parametrize('mode', ['direct', 'sorted', 'segsum'])
def test_sampler_backward_matches_jax_vjp(monkeypatch, mode, points_from,
                                          backward):
  """d array of interpolate_patch_2d against ``jax.vjp``, under each of the
  JAX package's exact scatter modes of its patch-gather backward (the
  direct scatter-add, the sorted one, and the sort-cumsum-difference
  'segsum': the same transpose as K4's sorted runs): low-edge, high-edge
  (the pad row/col folds back onto the edge) and out-of-bounds points, or
  the templates' own points; the cotangent is masked by validity
  downstream on both sides."""
  array, valid, points, cotangent = _plane_and_points(12, points_from)
  monkeypatch.setattr(jview_scan, '_gather_backward_mode',
                      jview_scan.gather_backward_mode())  # restored
  jview_scan.set_gather_backward_mode(mode)

  def jax_values(a):
    values, ok = jview_scan.interpolate_patch_2d(a, jnp.asarray(valid),
                                                 jnp.asarray(points))
    return jnp.where(ok[:, None], values, 0)

  _, vjp = jax.vjp(jax_values, jnp.asarray(array))
  (want,) = vjp(jnp.asarray(cotangent))
  assert jview_scan.gather_backward_mode() == mode
  if backward == 'autograd_of_plain':
    monkeypatch.setattr(
        view_scan, 'patch_sample_2d',
        lambda padded, pts, **kw: view_scan.patch_sample_2d_plain(
            padded, pts, **kw))
  a = torch.from_numpy(array)[None].requires_grad_()
  values, ok = view_scan.interpolate_patch_2d(
      a, torch.from_numpy(valid)[None], torch.from_numpy(points)[None])
  masked = torch.where(ok[..., None], values, 0)
  (got,) = torch.autograd.grad(masked, a, torch.from_numpy(cotangent)[None])
  assert ok.any() and not ok.all()
  np.testing.assert_allclose(got[0].numpy(), np.asarray(want),
                             atol=SAMPLE_ATOL, rtol=SAMPLE_RTOL)
  assert np.abs(np.asarray(want)[-1]).max() > 0  # the high edge is reached


def test_sampler_bwd_plain_is_autograd_of_plain_forward():
  """K4's oracle equals autograd of K2's oracle; the validity channel
  gets no gradient."""
  array, valid, points, cotangent = _plane_and_points(13)
  plane = np.concatenate([array, valid[..., None].astype(np.float32)], -1)
  plane = np.pad(plane, ((0, 1), (0, 1), (0, 0)), mode='edge')[None]
  padded = torch.from_numpy(plane).requires_grad_()
  pts = torch.from_numpy(points)[None]
  values, _ = view_scan.patch_sample_2d_plain(padded, pts, dim=5,
                                              has_valid=True)
  g = torch.from_numpy(cotangent)[None]
  (want,) = torch.autograd.grad(values, padded, g)
  got = view_scan.patch_sample_2d_bwd_plain(g, pts,
                                            plane_shape=tuple(plane.shape))
  np.testing.assert_allclose(got.numpy(), want.numpy(), atol=SAMPLE_ATOL,
                             rtol=0)
  assert not got[..., 5].any()
