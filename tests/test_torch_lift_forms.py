"""Port parity of the lift's forms (A14, item 5) and B8's plain version.

Each form of the street-view lift (``pooling_impl``): the top-k stream
(``pool_views_stream``), the per-view scan (``pool_views_scan``) and the
gather form (``interpolate_views_selective`` + ``pool_multiview_features``
after ``view_selection``), weighted or not, with and without the variance
and the per-channel max and min. The port's CPU path (the plain K1 and K3
for the stream and the scan, plain torch for the gather form) against the
JAX package's, on the CPU as tests/conftest.py sets it up: the stats, and
their VJP into the feature and score maps (``jax.vjp`` against the port's
autograd). Inputs come from a numpy seed on the synthetic generator's rigs;
view 5 repeats view 0 (pose, camera and image), so that observations tie
exactly: the max's and min's gradients split at those ties (the stream's
and the scan's chains as ``jnp.maximum``'s, the gather form evenly as
``jnp.max``'s), and the scan's threshold ties too.
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
from snap_tpu_torch.ops import kernels
from snap_tpu_torch.ops import view_fusion
from snap_tpu_torch.ops import view_scan
from snap_tpu_torch.utils import geometry

torch.set_num_threads(2)

# The stats: tests/test_torch_view_scan.py's lift tolerance (a last-bit
# difference in the projected depth moves a score, and exp() passes it on
# to the softmax weights).
LIFT_ATOL, LIFT_RTOL = 1e-4, 1e-4
# The gradients: tests/test_torch_train.py's, relative to the largest
# entry of each.
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-7
DEPTH_MIN_MAX = (1.0, 32.0)
TOP_K = 2
FORMS = ('stream', 'scan', 'gather')


def _inputs(seed: int, weighted: bool):
  """Two rigs of 6 views (view 5 a copy of view 0), feature maps (and
  score maps), points of the map's volume, as numpy."""
  rng = np.random.default_rng(seed)
  data = configs.DataConfig(num_views=6, image_size=(36, 48), voxel_size=1.0,
                            add_rasters=False)
  ex = loader.make_pair_examples(loader.make_generator(data, seed), range(2),
                                 data)['map']

  def repeat_view(tree):
    if isinstance(tree, dict):
      return {k: repeat_view(v) for k, v in tree.items()}
    tree = tree.copy()
    tree[:, 5] = tree[:, 0]
    return tree

  pose, cam = repeat_view(ex['T_view2scene']), repeat_view(ex['camera'])
  b, v, h, w, dim, bins = 2, 6, 9, 12, 16, 8
  f_images = rng.normal(size=(b, v, h, w, dim)).astype(np.float32)
  f_images[:, 5] = f_images[:, 0]
  scores = None
  if weighted:
    scores = rng.normal(size=(b, v, h, w, bins)).astype(np.float32)
    scores[:, 5] = scores[:, 0]
  xyz = np.stack(np.meshgrid(np.arange(1, 24, 2.0), np.arange(1, 32, 2.0),
                             np.arange(0.25, 6, 1.0), indexing='ij'), -1)
  points = np.broadcast_to(xyz.reshape(1, -1, 3), (b, xyz.size // 3, 3))
  points = (points + rng.uniform(-0.5, 0.5, points.shape)).astype(np.float32)
  return dict(pose=pose, cam=cam, f_images=f_images, scores=scores,
              points=points)


def _gather_form(vf, images, f_dim, pose, cam, points, add_minmax,
                 use_variance, take):
  """The gather form of either package ``vf`` (its view_fusion), composed
  as the street-view encoder composes it; ``take`` slices the channels.
  Returns (stats, valid, view indices)."""
  p2d, vis, depth, _ = vf.project_points_to_views(pose, cam, points)
  idx, _ = vf.view_selection(points, pose, vis, TOP_K)
  p2d, vis, depth = (vf.gather_observations(x, idx) for x in (p2d, vis,
                                                               depth))
  f_proj = vf.interpolate_views_selective(images, p2d, idx)
  scores = None
  if images.shape[-1] > f_dim:
    scores = vf.interpolate_depth_score(take(f_proj, f_dim, None), depth,
                                        DEPTH_MIN_MAX)
    f_proj = take(f_proj, 0, f_dim)
  stats, valid = vf.pool_multiview_features(f_proj, vis, scores, add_minmax,
                                            use_variance)
  return stats, valid, idx


def _jax(x, form, add_minmax, use_variance, cotangent):
  pose = jgeometry.Transform3D(R=jnp.asarray(x['pose']['R']),
                               t=jnp.asarray(x['pose']['t']))
  cam = jgeometry.FisheyeCamera.from_dict(x['cam']).scale(
      jnp.asarray([0.25, 0.25]))
  points = jnp.asarray(x['points'])
  weighted = x['scores'] is not None
  kw = dict(top_k=TOP_K, depth_min_max=DEPTH_MIN_MAX, add_minmax=add_minmax,
            use_variance=use_variance)
  aux = {}

  def stats(f, s=None):
    if form == 'gather':
      images = f if s is None else jnp.concatenate([f, s], -1)
      out, valid, idx = _gather_form(
          jview_fusion, images, f.shape[-1], pose, cam, points, add_minmax,
          use_variance, lambda a, lo, hi: a[..., lo:hi])
      aux.update(valid=valid, idx=idx)
      return out
    lift = (jview_scan.pool_views_stream if form == 'stream'
            else jview_scan.pool_views_scan)
    out = lift(f, s, pose, cam, points, **kw)
    aux.update(valid=out.valid, min_distance=out.min_distance)
    return out.stats

  maps = [jnp.asarray(x['f_images'])]
  if weighted:
    maps.append(jnp.asarray(x['scores']))
  out, vjp = jax.vjp(stats, *maps)
  grads = vjp(jnp.asarray(cotangent))
  return np.asarray(out), [np.asarray(g) for g in grads], {
      k: np.asarray(v) for k, v in aux.items()}


def _jax_selection(x):
  """The top-k views of the stream and the gather form, and the scan's
  selected views (visible, within the k-th nearest visible distance)."""
  pose = jgeometry.Transform3D(R=jnp.asarray(x['pose']['R']),
                               t=jnp.asarray(x['pose']['t']))
  cam = jgeometry.FisheyeCamera.from_dict(x['cam']).scale(
      jnp.asarray([0.25, 0.25]))
  points = jnp.asarray(x['points'])
  _, vis, _, _ = jview_fusion.project_points_to_views(pose, cam, points)
  idx, _ = jview_fusion.view_selection(points, pose, vis, TOP_K)
  selected = []
  for b in range(points.shape[0]):
    threshold, _ = jview_scan._view_threshold(points[b], pose.t[b], vis[b],
                                              TOP_K)
    dist = jnp.linalg.norm(points[b][:, None] - pose.t[b][None], axis=-1)
    selected.append(vis[b] & (dist <= threshold[:, None]))
  return np.asarray(idx), np.stack(selected)


def _port(x, form, add_minmax, use_variance, cotangent):
  pose = geometry.Transform3D(R=torch.from_numpy(x['pose']['R']),
                              t=torch.from_numpy(x['pose']['t']))
  cam = geometry.FisheyeCamera.from_dict(x['cam']).scale(
      torch.tensor([0.25, 0.25]))
  points = torch.from_numpy(np.ascontiguousarray(x['points']))
  maps = [torch.from_numpy(x['f_images']).requires_grad_()]
  if x['scores'] is not None:
    maps.append(torch.from_numpy(x['scores']).requires_grad_())
  scores = maps[1] if len(maps) > 1 else None
  aux = {}
  if form == 'gather':
    images = maps[0] if scores is None else torch.cat(maps, -1)
    stats, valid, idx = _gather_form(
        view_fusion, images, maps[0].shape[-1], pose, cam, points, add_minmax,
        use_variance, lambda a, lo, hi: a[..., lo:hi])
    aux.update(valid=valid, idx=idx)
  else:
    lift = (view_scan.pool_views_stream if form == 'stream'
            else view_scan.pool_views_scan)
    out = lift(maps[0], scores, pose, cam, points, top_k=TOP_K,
               depth_min_max=DEPTH_MIN_MAX, add_minmax=add_minmax,
               use_variance=use_variance)
    stats = out.stats
    aux.update(valid=out.valid, min_distance=out.min_distance)
  grads = torch.autograd.grad(stats, maps, torch.from_numpy(cotangent))
  _, vis, _, _ = view_fusion.project_points_to_views(pose, cam, points)
  aux['top_k'], _ = view_fusion.view_selection(points, pose, vis, TOP_K)
  aux['scan_select'], _ = view_scan.scan_selection(points, pose, vis, TOP_K)
  return stats.detach().numpy(), [g.numpy() for g in grads], {
      k: v.detach().numpy() for k, v in aux.items()}


def _assert_grad_close(got, want):
  scale = np.abs(want).max()
  assert scale > 0
  np.testing.assert_allclose(got, want, atol=GRAD_ATOL + GRAD_RTOL * scale,
                             rtol=0)


@pytest.mark.parametrize('use_variance', [True, False])
@pytest.mark.parametrize('add_minmax', [False, True])
@pytest.mark.parametrize('weighted', [True, False])
@pytest.mark.parametrize('form', FORMS)
def test_lift_form_matches_jax(form, weighted, add_minmax, use_variance):
  """Stats and their VJP against JAX's; validity, the top-k views and the
  scan's selected views exactly."""
  x = _inputs(31, weighted)
  b, n = x['points'].shape[:2]
  width = kernels.stats_width(16, weighted, use_variance, add_minmax)
  cotangent = np.random.default_rng(5).normal(size=(b, n, width)).astype(
      np.float32)
  want, want_grads, want_aux = _jax(x, form, add_minmax, use_variance,
                                    cotangent)
  got, got_grads, got_aux = _port(x, form, add_minmax, use_variance,
                                  cotangent)
  want_idx, want_select = _jax_selection(x)
  np.testing.assert_array_equal(got_aux['top_k'], want_idx)
  np.testing.assert_array_equal(got_aux['scan_select'], want_select)
  if form == 'gather':
    np.testing.assert_array_equal(got_aux['idx'], want_aux['idx'])
  else:
    np.testing.assert_allclose(got_aux['min_distance'],
                               want_aux['min_distance'], rtol=1e-6)
  np.testing.assert_array_equal(got_aux['valid'], want_aux['valid'])
  assert want_aux['valid'].any() and not want_aux['valid'].all()
  assert got.shape == want.shape == (b, n, width)
  np.testing.assert_allclose(got, want, atol=LIFT_ATOL, rtol=LIFT_RTOL)
  assert len(got_grads) == len(want_grads) == 1 + weighted
  for got_g, want_g in zip(got_grads, want_grads):
    _assert_grad_close(got_g, want_g)


def test_the_inputs_tie_exactly():
  """The repeated view makes exact ties: points whose selected views
  include both copies, and (the scan) more views selected than k."""
  x = _inputs(31, True)
  want_idx, want_select = _jax_selection(x)
  both = ((want_idx == 0) | (want_idx == 5)).sum(-1) == 2
  assert both.sum() > 20
  assert (want_select.sum(-1) > TOP_K).sum() > 20


@pytest.mark.parametrize('weighted', [True, False])
def test_plain_lift_backward_is_autograd_of_its_forward(weighted):
  """B8's plain K3 (``lift_topk_bwd_plain``) against torch autograd of the
  plain K1 with the max, min and variance at their ties: 6 ranks, 3 of
  them repeats (exact ties of every channel and score), unselected ranks
  and points with one rank."""
  g = torch.Generator().manual_seed(7)
  b, v, h, w, n, k, dim = 2, 3, 5, 6, 400, 6, 8
  c = dim + (4 if weighted else 0)
  stack = torch.randn((b, v * (h + 1), w + 1, c), generator=g)
  view_idx = torch.randint(0, v, (b, n, k), generator=g, dtype=torch.int32)
  p2d = torch.rand((b, n, k, 2), generator=g) * torch.tensor([h + 2.0,
                                                               w + 2.0]) - 1
  select = torch.rand((b, n, k), generator=g) < 0.7
  select[:, :50] = False
  select[:, :50, 2] = True
  depth = torch.rand((b, n, k), generator=g) * 40
  for t in (view_idx, p2d, depth):
    t[:, :, 3:] = t[:, :, :3]
  kw = dict(h=h, w=w, dim=dim, depth_min_max=DEPTH_MIN_MAX,
            use_variance=True, add_minmax=True)
  cot = torch.randn((b, n, kernels.stats_width(dim, weighted, True, True)),
                    generator=g)
  leaf = stack.clone().requires_grad_()
  stats, _ = view_scan.lift_topk_plain(leaf, view_idx, p2d, select, depth,
                                       **kw)
  (want,) = torch.autograd.grad(stats, leaf, cot)
  got = view_scan.lift_topk_bwd_plain(stack, view_idx, p2d, select, depth,
                                      cot, **kw)
  assert want.abs().max() > 0
  torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
