"""The premise of K3's compaction (``csrc/lift_topk_bwd.cu``, the ranks
stage): a point's selected ranks moved to the front in rank order, the rest
left unselected, give the plain versions of K1 and K3 the same stats,
validity and ``d stack``, value for value. An unselected rank adds nothing
to the online softmax or to the chains of maxima, and takes no share of
their cotangents (it scores -1e30, and the first selected rank passes 0
back past it).

Every statistics layout at the stream's 4 ranks and the scan's 20, on
points with 0, 1, 2-4, 5-8 (at K = 20) and all ranks selected, and with
exact ties (a rank repeating an earlier one, both selected). Each point is
an example of its own, so that its ``d stack`` is its own ranks' sum, whose
order the compaction keeps. Then the scan form's compacted ranks against
the JAX package's ``pool_views_scan`` (stats and VJP), on the inputs of
``test_torch_lift_forms.py`` whose repeated view ties at the scan's
threshold.

The premises of K1's compaction (``csrc/lift_topk_fwd.cu``, B8's layouts),
which never reads an unselected rank's view, pixel or depth, and reads no
depth at all in the unweighted layouts: other values there (another valid
view, other finite pixels on the image, any depth, NaN and infinities
included) give the plain versions the same stats, validity and ``d stack``,
value for value; so does a depth of NaN everywhere in the unweighted
layouts. The pixels stay finite because the plain version multiplies an
unselected rank's combined features by its weight of 0.
"""

import numpy as np
import pytest
import torch

import test_torch_lift_forms as forms
from snap_tpu_torch.ops import kernels
from snap_tpu_torch.ops import view_fusion
from snap_tpu_torch.ops import view_scan
from snap_tpu_torch.utils import geometry

torch.set_num_threads(2)

LAYOUTS = [(w, v, m) for w in (True, False) for v in (True, False)
           for m in (False, True)]


def compact(view_idx, p2d, select, depth):
  """Each point's selected ranks first, in rank order; the unselected ones
  after them, in theirs."""
  order = torch.sort((~select).to(torch.int8), dim=-1, stable=True).indices
  take = lambda t: torch.gather(
      t, 2, order if t.dim() == 3 else order[..., None].expand_as(t))
  return take(view_idx), take(p2d), take(select), take(depth)


def _ranks(k: int, seed: int = 0):
  """240 points, each its own example, on 5 views of 7 x 9 pixels (pixels
  past every edge): 20 with no selected rank, 20 with one, 60 with 2-4 at
  random places, 40 with 5-8 (every rank at K = 4), 60 with 2-4 of which
  the last repeats the first (exact ties of every channel and score), 40
  with every rank."""
  rng = np.random.default_rng(seed)
  p, v, h, w = 240, 5, 7, 9
  view_idx = rng.integers(0, v, (p, 1, k)).astype(np.int32)
  p2d = (rng.uniform(size=(p, 1, k, 2)) * [h + 2.0, w + 2.0] - 1).astype(
      np.float32)
  depth = rng.uniform(0, 40, (p, 1, k)).astype(np.float32)
  counts = np.concatenate([np.zeros(20), np.ones(20), rng.integers(2, 5, 60),
                           rng.integers(5, 9, 40), rng.integers(2, 5, 60),
                           np.full(40, k)]).astype(int).clip(max=k)
  select = np.zeros((p, 1, k), bool)
  for i, c in enumerate(counts):
    places = np.sort(rng.choice(k, c, replace=False))
    select[i, 0, places] = True
    if 140 <= i < 200:
      for t in (view_idx, p2d, depth):
        t[i, 0, places[-1]] = t[i, 0, places[0]]
  return [torch.from_numpy(t) for t in (view_idx, p2d, select, depth)]


def _layout_inputs(layout, k):
  """The stack, the kwargs and a cotangent of ``layout`` for ``_ranks(k)``:
  32 features, 8 score bins when weighted."""
  weighted, use_variance, add_minmax = layout
  rng = np.random.default_rng(1)
  dim, bins = 32, 8 if weighted else 0
  p = 240
  image = rng.normal(size=(1, 5 * 8, 10, dim + bins)).astype(np.float32)
  stack = torch.from_numpy(image).expand(p, -1, -1, -1).contiguous()
  kw = dict(h=7, w=9, dim=dim, depth_min_max=(1.0, 32.0),
            use_variance=use_variance, add_minmax=add_minmax)
  g = torch.from_numpy(rng.normal(size=(p, 1, kernels.stats_width(
      dim, weighted, use_variance, add_minmax))).astype(np.float32))
  return stack, kw, g


def _assert_same_lift(stack, given, other, g, kw):
  """The plain K1 and K3 on ``given`` and on ``other``: the same stats,
  validity and ``d stack``, value for value."""
  stats, valid = view_scan.lift_topk_plain(stack, *given, **kw)
  stats_o, valid_o = view_scan.lift_topk_plain(stack, *other, **kw)
  assert torch.equal(valid, valid_o) and torch.equal(stats, stats_o)
  d_stack = view_scan.lift_topk_bwd_plain(stack, *given, g, **kw)
  d_stack_o = view_scan.lift_topk_bwd_plain(stack, *other, g, **kw)
  assert d_stack.abs().max() > 0.1
  assert torch.equal(d_stack, d_stack_o)


@pytest.mark.parametrize('k', [4, 20])
@pytest.mark.parametrize('layout', LAYOUTS)
def test_compacted_ranks_give_the_same_stats_and_d_stack(layout, k):
  stack, kw, g = _layout_inputs(layout, k)
  view_idx, p2d, select, depth = _ranks(k)
  given = (view_idx, p2d, select, depth)
  packed = compact(*given)
  n = select.sum(-1)
  assert (n == 0).any() and (n == 1).any() and (n == k).any()
  assert k == 4 or ((n >= 5) & (n <= 8) & (n < k)).any()
  assert not torch.equal(packed[2], select)  # the compaction moves ranks
  _assert_same_lift(stack, given, packed, g, kw)


@pytest.mark.parametrize('k', [4, 20])
@pytest.mark.parametrize('layout', LAYOUTS)
def test_unselected_ranks_inputs_are_never_read(layout, k):
  """An unselected rank's view, pixel and depth replaced by others (another
  valid view, other finite pixels on the image, any depth: NaN, +-inf and
  finite values in and out of the depth range) change nothing."""
  stack, kw, g = _layout_inputs(layout, k)
  view_idx, p2d, select, depth = _ranks(k)
  rng = np.random.default_rng(2)
  off = ~select
  shape = tuple(select.shape)
  other_view = torch.where(off, (view_idx + torch.from_numpy(
      rng.integers(1, 5, shape).astype(np.int32))) % 5, view_idx)
  pixels = torch.from_numpy((rng.uniform(size=shape + (2,)) * [7.0, 9.0]
                             ).astype(np.float32))
  other_p2d = torch.where(off[..., None], pixels, p2d)
  anything = torch.from_numpy(rng.choice(
      np.array([np.nan, np.inf, -np.inf, -3.0, 0.0, 0.5, 17.0, 1e4],
               np.float32), shape))
  other_depth = torch.where(off, anything, depth)
  assert off.any() and not torch.equal(other_view, view_idx)
  assert not torch.equal(other_p2d, p2d)
  assert other_depth[off].isnan().any() and other_depth[off].isinf().any()
  _assert_same_lift(stack, (view_idx, p2d, select, depth),
                    (other_view, other_p2d, select, other_depth), g, kw)


@pytest.mark.parametrize('k', [4, 20])
@pytest.mark.parametrize('layout', [l for l in LAYOUTS if not l[0]])
def test_unweighted_layouts_read_no_depth(layout, k):
  """Without score bins, a depth of NaN at every rank changes nothing."""
  stack, kw, g = _layout_inputs(layout, k)
  view_idx, p2d, select, depth = _ranks(k)
  nan = torch.full_like(depth, float('nan'))
  _assert_same_lift(stack, (view_idx, p2d, select, depth),
                    (view_idx, p2d, select, nan), g, kw)


def _port_scan_compacted(x, add_minmax, use_variance, cotangent):
  """The port's scan form with each point's selected views compacted in
  view order before the lift (as K3's ranks stage takes them)."""
  pose = geometry.Transform3D(R=torch.from_numpy(x['pose']['R']),
                              t=torch.from_numpy(x['pose']['t']))
  cam = geometry.FisheyeCamera.from_dict(x['cam']).scale(
      torch.tensor([0.25, 0.25]))
  points = torch.from_numpy(np.ascontiguousarray(x['points']))
  maps = [torch.from_numpy(x['f_images']).requires_grad_()]
  if x['scores'] is not None:
    maps.append(torch.from_numpy(x['scores']).requires_grad_())
  b, v, h, w, dim = maps[0].shape
  p2d, visible, depth, _ = view_fusion.project_points_to_views(pose, cam,
                                                               points)
  select, _ = view_scan.scan_selection(points, pose, visible, forms.TOP_K)
  assert (select.sum(-1) > forms.TOP_K).any()  # ties at the threshold
  view_idx = torch.arange(v, dtype=torch.int32).expand(select.shape)
  ranks = [t.contiguous() for t in compact(view_idx, p2d, select, depth)]
  stats, _ = view_scan.lift_topk(
      view_scan._image_stack(maps[0], maps[1] if len(maps) > 1 else None),
      *ranks, h=h, w=w, dim=dim, depth_min_max=forms.DEPTH_MIN_MAX,
      use_variance=use_variance, add_minmax=add_minmax)
  grads = torch.autograd.grad(stats, maps, torch.from_numpy(cotangent))
  return stats.detach().numpy(), [g.numpy() for g in grads]


@pytest.mark.parametrize('add_minmax', [False, True])
@pytest.mark.parametrize('weighted', [True, False])
def test_compacted_scan_matches_jax_pool_views_scan(weighted, add_minmax):
  x = forms._inputs(31, weighted)
  b, n = x['points'].shape[:2]
  width = kernels.stats_width(16, weighted, True, add_minmax)
  cotangent = np.random.default_rng(5).normal(size=(b, n, width)).astype(
      np.float32)
  want, want_grads, _ = forms._jax(x, 'scan', add_minmax, True, cotangent)
  got, got_grads = _port_scan_compacted(x, add_minmax, True, cotangent)
  np.testing.assert_allclose(got, want, atol=forms.LIFT_ATOL,
                             rtol=forms.LIFT_RTOL)
  assert len(got_grads) == len(want_grads) == 1 + weighted
  for got_g, want_g in zip(got_grads, want_grads):
    forms._assert_grad_close(got_g, want_g)
