"""The lift's streamed and scanned forms, and the 2x2 patch sampler.

Port of ``snap_tpu/ops/view_scan.py``:

- ``pool_views_stream`` (``pooling_impl='stream'``): project, select the
  top-k views and pick the per-rank (view, pixel, visibility, depth) in
  plain torch, then pool with ``lift_topk``;
- ``pool_views_scan`` (``pooling_impl='scan'``): every view is a rank, in
  view order, and a rank counts where the view is visible and no farther
  than the point's k-th nearest visible view; pooled with ``lift_topk``;
- ``lift_topk``: **K1** forward (2x2 bilinear patch reads of the
  row-padded image stack, the depth-hat score of weighted fusion, online
  softmax over the ranks) and **K3** backward (the gradient scattered onto
  the stack), for each statistics layout ``[mean, var?, max?, min?,
  score_max?]``: weighted or not (unweighted, every selected rank scores 0
  and the softmax weights are equal), with or without the variance and
  the per-channel max and min (B8, the switches of K1 and K3);
- ``interpolate_patch_2d``: bilinear 2-D sampling with ``interpolate_nd``'s
  boundary rules around ``patch_sample_2d``: **K2** forward, **K4**
  backward (the tap-weighted scatter onto the plane).

Both wrappers are ``torch.autograd.Function``s. Each dispatches on the
device of its input: a CPU tensor takes the plain PyTorch version beside it
(``*_plain``, ``*_bwd_plain``), a CUDA tensor launches the kernel
(``ops/kernels.py``), any other device raises.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import torch

from snap_tpu_torch.ops import kernels
from snap_tpu_torch.ops import view_fusion
from snap_tpu_torch.utils import geometry

Tensor = torch.Tensor

NEG_INF = -1e30


class ViewScanOutput(NamedTuple):
  stats: Tensor  # [B, N, C] pooled [mean, var?, max?, min?, score_max?]
  valid: Tensor  # [B, N]
  min_distance: Tensor  # [B, N]


def gather_bilinear_patches(images: Tensor, row0: Tensor, col0: Tensor
                            ) -> Tensor:
  """``[B, R, W, C]`` stack, ``[B, N]`` origins -> ``[B, N, 2, 2, C]`` patches.

  The plain form of the 2x2xC gather (``tools/pallas_gather_probe.py:
  patch_gather_pallas``); the caller guarantees ``row0 <= R - 2`` and
  ``col0 <= W - 2``.
  """
  taps = list(_taps(images, row0, col0))
  return torch.stack([torch.stack(taps[:2], 2), torch.stack(taps[2:], 2)], 2)


def _taps(images: Tensor, row0: Tensor, col0: Tensor):
  """The 2x2 patch's taps ``[B, N, C]`` one at a time, in the order (di,
  dj) = (0,0), (0,1), (1,0), (1,1)."""
  b, _, w, c = images.shape
  flat = images.reshape(b, -1, c)
  bidx = torch.arange(b, device=images.device)[:, None]
  for di in (0, 1):
    for dj in (0, 1):
      yield flat[bidx, ((row0 + di) * w + col0 + dj).long()]


class _Rank(NamedTuple):
  """One rank of every point: its taps, combined channels and score."""

  row0: Tensor  # [B, N] int32 tap-patch origin in the stack
  col0: Tensor  # [B, N] int32
  weights: Tensor  # [B, N, 2, 2] f32 bilinear tap weights
  f: Tensor  # [B, N, C] f32 combined channels (features, then score bins)
  hat: Tensor  # [B, N, S] f32 depth-hat weights (S = 0 unweighted)
  score: Tensor  # [B, N] f32, NEG_INF where the rank is not selected


def _bilinear_taps(p2d: Tensor, size: Tensor):
  """Clamped tap origin ``[..., 2]`` int32 and weights ``[..., 2, 2]``."""
  pts = torch.minimum(torch.clamp(p2d - 0.5, min=0), size - 1)
  lower = torch.floor(pts)
  frac = pts - lower
  w_i = torch.stack([1 - frac[..., 0], frac[..., 0]], -1)
  w_j = torch.stack([1 - frac[..., 1], frac[..., 1]], -1)
  return lower.int(), w_i[..., :, None] * w_j[..., None, :]


def _lift_ranks(stack: Tensor, view_idx: Tensor, p2d: Tensor, select: Tensor,
                depth: Tensor, *, h: int, w: int, dim: int,
                depth_min_max: Tuple[float, float]) -> List[_Rank]:
  """Gather, combine and score each rank of each point (f32 inside). The
  stack's channels past ``dim`` are the score bins; without any (the
  unweighted lift) every selected rank scores 0.

  A rank's combined ``f`` is formed in one stated order
  (``csrc/lift_stats.cuh:tap_add``): the taps t = 0..3 = (di, dj) =
  (0,0), (0,1), (1,0), (1,1), each product ``w_t * v_t`` rounded on its
  own, added left to right from the first, ``((p0 + p1) + p2) + p3``. K1
  and K3 form the score bins so in every layout, and the features so in
  the layouts with the max and min: the channels whose values route a
  cotangent (the score max's, the max's, the min's) then have the same
  bits on every side, and a near tie goes to the same rank (ROADMAP C10).
  In the other layouts, the flagship's among them, K1 and K3 fuse each
  feature product into the sum (an FMA; the stated order cost the
  flagship's K1 5.4% and K3 4.4% on an H100), so there their features,
  which route nothing, are within rounding of these, not equal."""
  size = torch.tensor([h, w], dtype=torch.float32, device=stack.device)
  bins = stack.shape[-1] - dim
  ranks = []
  for r in range(view_idx.shape[-1]):
    lower, weights = _bilinear_taps(p2d[:, :, r], size)
    row0 = view_idx[:, :, r] * (h + 1) + lower[..., 0]
    # The left fold of the tap products, a tap at a time (no [B, N, 2, 2,
    # C] patch held at once: the plain version runs at full width on the
    # card too).
    f = None
    for t, tap in enumerate(_taps(stack, row0, lower[..., 1])):
      term = weights[..., t // 2, t % 2, None] * tap.float()
      f = term if f is None else f + term
    if bins:
      hat = view_fusion.depth_hat_weights(depth[:, :, r], bins, depth_min_max)
      score = (f[..., dim:] * hat).sum(-1)
    else:
      hat, score = f[..., dim:], torch.zeros_like(f[..., 0])
    score = torch.where(select[:, :, r], score, NEG_INF)
    ranks.append(_Rank(row0, lower[..., 1], weights, f, hat, score))
  return ranks


class _Pool(NamedTuple):
  """The online pool's state after the last rank."""

  m: Tensor  # [B, N] running max score
  l: Tensor  # [B, N] sum of exp(score - m)
  s1: Tensor  # [B, N, D] sum of exp(score - m) f
  s2: Tensor  # [B, N, D] sum of exp(score - m) f^2
  f_max: Tensor  # [B, N, D] max of f over the selected ranks (or -inf)
  f_min: Tensor  # [B, N, D] min (or +inf)
  valid: Tensor  # [B, N] some rank selected


def _online_pool(ranks: List[_Rank], select: Tensor, dim: int) -> _Pool:
  """The reference's online softmax over the ranks, and the running max and
  min of the features (``jnp.where(select, jnp.maximum(f_max, f), f_max)``)."""
  b, n = select.shape[:2]
  dev = select.device
  m = torch.full((b, n), NEG_INF, device=dev)
  l = torch.zeros((b, n), device=dev)
  s1 = torch.zeros((b, n, dim), device=dev)
  s2 = torch.zeros((b, n, dim), device=dev)
  f_max = torch.full((b, n, dim), -torch.inf, device=dev)
  f_min = torch.full((b, n, dim), torch.inf, device=dev)
  for r, rank in enumerate(ranks):
    f = rank.f[..., :dim]
    sel = select[:, :, r]
    new_m = torch.maximum(m, rank.score)
    safe_m = torch.where(new_m <= NEG_INF, 0.0, new_m)
    rescale = torch.exp(torch.where(m <= NEG_INF, NEG_INF, m) - safe_m)
    wv = torch.exp(rank.score - safe_m) * sel
    l = l * rescale + wv
    s1 = s1 * rescale[..., None] + wv[..., None] * f
    s2 = s2 * rescale[..., None] + wv[..., None] * f * f
    f_max = torch.where(sel[..., None], torch.maximum(f_max, f), f_max)
    f_min = torch.where(sel[..., None], torch.minimum(f_min, f), f_min)
    m = new_m
  return _Pool(m, l, s1, s2, f_max, f_min, select.any(-1))


def lift_topk_plain(stack: Tensor, view_idx: Tensor, p2d: Tensor,
                    select: Tensor, depth: Tensor, *, h: int, w: int, dim: int,
                    depth_min_max: Tuple[float, float],
                    use_variance: bool = True, add_minmax: bool = False
                    ) -> Tuple[Tensor, Tensor]:
  """Plain version of K1; ``stats`` in the stack's dtype, f32 inside.

  Differentiable in plain torch; ``torch.maximum`` (not ``clamp``) on the
  variance, and on the chains of the max and min, passes half the gradient
  at a tie, as ``jnp.maximum`` does.
  """
  ranks = _lift_ranks(stack, view_idx, p2d, select, depth, h=h, w=w, dim=dim,
                      depth_min_max=depth_min_max)
  pool = _online_pool(ranks, select, dim)
  valid = pool.valid
  l_safe = torch.clamp(pool.l, min=1e-20)[..., None]
  mean = pool.s1 / l_safe
  stats = [mean]
  if use_variance:
    var_raw = pool.s2 / l_safe - mean * mean
    stats.append(torch.maximum(var_raw, torch.zeros_like(var_raw)))
  if add_minmax:
    stats.append(torch.where(valid[..., None], pool.f_max, 0.0))
    stats.append(torch.where(valid[..., None], pool.f_min, 0.0))
  if stack.shape[-1] > dim:
    stats.append(torch.where(valid, pool.m, 0.0)[..., None])
  stats = torch.where(valid[..., None], torch.cat(stats, -1), 0.0)
  return stats.to(stack.dtype), valid


def _max_chain_shares(scores: List[Tensor], g_m: Tensor) -> List[Tensor]:
  """d m / d score_k for m = max(..max(max(NEG_INF, s_0), s_1).., s_K-1),
  times ``g_m``: all of it to the strict running maximum, and half to each
  side of an exact tie (``jnp.maximum``'s gradient). A score of -inf (a
  rank that is not selected, in the features' chains) takes none and
  passes all."""
  before, m = [], torch.full_like(g_m, NEG_INF)
  for score in scores:
    before.append(m)
    m = torch.maximum(m, score)
  shares, coef = [None] * len(scores), g_m
  for k in reversed(range(len(scores))):
    gt, eq = scores[k] > before[k], scores[k] == before[k]
    shares[k] = torch.where(gt, coef, torch.where(eq, coef * 0.5, 0.0))
    coef = torch.where(gt, 0.0, torch.where(eq, coef * 0.5, coef))
  return shares


def lift_topk_bwd_plain(stack: Tensor, view_idx: Tensor, p2d: Tensor,
                        select: Tensor, depth: Tensor, g_stats: Tensor, *,
                        h: int, w: int, dim: int,
                        depth_min_max: Tuple[float, float],
                        use_variance: bool = True, add_minmax: bool = False
                        ) -> Tensor:
  """Plain version of K3: ``d stack`` in the stack's dtype from ``g_stats``.

  The formulas of ``csrc/lift_topk_bwd.cu``, written out with
  ``index_add_`` into an f32 buffer: the forward is recomputed, the
  gradient goes through (mean, E2 = sum p f^2) of the softmax weights p,
  the variance's tie passes half, the max and min of each channel and the
  score max pass their cotangents down their chains of maxima (half to
  each side of an exact tie), and each selected rank adds ``w_tap * [d f,
  d c]`` at its four taps. Coordinates, selection and depth get no
  gradient.
  """
  weighted = stack.shape[-1] > dim
  ranks = _lift_ranks(stack, view_idx, p2d, select, depth, h=h, w=w, dim=dim,
                      depth_min_max=depth_min_max)
  pool = _online_pool(ranks, select, dim)
  valid = pool.valid
  l_safe = torch.clamp(pool.l, min=1e-20)[..., None]
  mean = pool.s1 / l_safe
  g = torch.where(valid[..., None], g_stats.float(), 0.0)
  g_mean, at = g[..., :dim], dim
  g_e2 = torch.zeros_like(g_mean)
  if use_variance:
    var_raw = pool.s2 / l_safe - mean * mean
    tau = torch.where(var_raw > 0, 1.0, torch.where(var_raw == 0, 0.5, 0.0))
    g_e2, at = g[..., at:at + dim] * tau, at + dim
  g_mu = g_mean - 2 * mean * g_e2
  p = [torch.where(select[:, :, r] & valid,
                   torch.exp(rank.score - pool.m) / l_safe[..., 0], 0.0)
       for r, rank in enumerate(ranks)]
  # Per rank, d [f, c]: the features' gradient, then the score bins'.
  d_ranks = [p_r[..., None] * (g_mu + 2 * g_e2 * rank.f[..., :dim])
             for p_r, rank in zip(p, ranks)]
  if add_minmax:
    feats = [torch.where(select[:, :, r, None], rank.f[..., :dim], -torch.inf)
             for r, rank in enumerate(ranks)]
    negated = [torch.where(select[:, :, r, None], -rank.f[..., :dim],
                           -torch.inf) for r, rank in enumerate(ranks)]
    to_max = _max_chain_shares(feats, g[..., at:at + dim])
    to_min = _max_chain_shares(negated, g[..., at + dim:at + 2 * dim])
    d_ranks = [d + a + b for d, a, b in zip(d_ranks, to_max, to_min)]
  if weighted:
    u = [(g_mu * rank.f[..., :dim] + g_e2 * rank.f[..., :dim]**2).sum(-1)
         for rank in ranks]
    sum_pu = sum(p_r * u_r for p_r, u_r in zip(p, u))
    shares = _max_chain_shares([rank.score for rank in ranks], g[..., -1])
    d_ranks = [torch.cat([d, (p_r * (u_r - sum_pu) + share * select[:, :, r]
                              )[..., None] * rank.hat], -1)
               for r, (d, p_r, u_r, share, rank) in enumerate(
                   zip(d_ranks, p, u, shares, ranks))]

  b, rows, cols, c = stack.shape
  grad = torch.zeros((b * rows * cols, c), device=stack.device)
  offset = (torch.arange(b, device=stack.device) * rows * cols)[:, None]
  for r, (rank, d) in enumerate(zip(ranks, d_ranks)):
    d = torch.where(select[:, :, r, None], d, 0.0)  # [B, N, C]
    for a in (0, 1):
      for e in (0, 1):
        ids = offset + (rank.row0 + a) * cols + rank.col0 + e
        grad.index_add_(0, ids.reshape(-1).long(),
                        (rank.weights[..., a, e, None] * d).reshape(-1, c))
  return grad.reshape(stack.shape).to(stack.dtype)


class _SelectedCount:
  """``select.sum()`` copied to pinned host memory behind the card's work,
  and an event after the copy: read in the backward, long after the copy
  ended, without a wait for the card."""

  def __init__(self, select: Tensor):
    self.count = torch.empty((), dtype=torch.int64, pin_memory=True)
    self.count.copy_(select.sum(), non_blocking=True)
    self.done = torch.cuda.Event()
    self.done.record()

  def __int__(self) -> int:
    self.done.synchronize()
    return int(self.count)


class _LiftTopk(torch.autograd.Function):
  """K1 forward, K3 backward (their plain versions for CPU tensors). On the
  card each call keeps its own count of selected ranks, which sizes K3's
  scratch."""

  @staticmethod
  def forward(ctx, stack, view_idx, p2d, select, depth, kwargs):
    args = (stack, view_idx, p2d, select, depth)
    ctx.selected = None
    if kernels.on_card(stack, 'lift_topk'):
      stats, valid = kernels.lift_topk_fwd(*args, **kwargs)
      if ctx.needs_input_grad[0]:
        ctx.selected = _SelectedCount(select)
    else:
      stats, valid = lift_topk_plain(*args, **kwargs)
    ctx.save_for_backward(*args)
    ctx.kwargs = kwargs
    ctx.mark_non_differentiable(valid)
    return stats, valid

  @staticmethod
  def backward(ctx, g_stats, g_valid):
    del g_valid
    args = (*ctx.saved_tensors, g_stats.contiguous())
    if kernels.on_card(g_stats, 'lift_topk_bwd'):
      selected = None if ctx.selected is None else int(ctx.selected)
      d_stack = kernels.lift_topk_bwd(*args, **ctx.kwargs, selected=selected)
    else:
      d_stack = lift_topk_bwd_plain(*args, **ctx.kwargs)
    return d_stack, None, None, None, None, None


def lift_topk(stack: Tensor, view_idx: Tensor, p2d: Tensor, select: Tensor,
              depth: Tensor, *, h: int, w: int, dim: int,
              depth_min_max: Tuple[float, float], use_variance: bool = True,
              add_minmax: bool = False) -> Tuple[Tensor, Tensor]:
  """K1: pool the ranks of each point from the row-padded stack.

  Args:
    stack: ``[B, V*(h+1), w+1, C]`` row-padded image stack: the ``dim``
      features, then (weighted fusion) S = C - dim log-depth score bins;
      C = dim pools unweighted.
    view_idx: ``[B, N, K]`` int32 view of each rank.
    p2d: ``[B, N, K, 2]`` f32 (row, col) pixel coordinates per rank.
    select: ``[B, N, K]`` bool, the rank counts.
    depth: ``[B, N, K]`` f32 camera-frame depth per rank.

  Returns:
    ``stats [B, N, kernels.stats_width(...)]`` = ``[mean, var?, max?,
    min?, score_max?]`` (the variance with ``use_variance``, the max and
    min of each channel over the selected ranks with ``add_minmax``, the
    max score when weighted), zero where invalid, in the stack's dtype, and
    ``valid [B, N]``. Differentiable in ``stack`` (all C channels) through
    K3.
  """
  kwargs = dict(h=h, w=w, dim=dim, depth_min_max=depth_min_max,
                use_variance=use_variance, add_minmax=add_minmax)
  return _LiftTopk.apply(stack, view_idx, p2d, select, depth, kwargs)


def _image_stack(f_images: Tensor, scores_images: Optional[Tensor]) -> Tensor:
  """``[B, V*(h+1), w+1, C]``: features (and score bins) of every view, a
  zero row and column after each. The clamped bilinear coordinates give
  the out-of-range tap a weight of exactly 0, so patches never need
  clamping."""
  b, v, h, w, _ = f_images.shape
  images = f_images if scores_images is None else torch.cat(
      [f_images, scores_images.to(f_images.dtype)], -1)
  padded = torch.nn.functional.pad(images, (0, 0, 0, 1, 0, 1))
  return padded.reshape(b, v * (h + 1), w + 1, padded.shape[-1])


def pool_views_stream(
    f_images: Tensor,
    scores_images: Optional[Tensor],
    scene_t_view: geometry.Transform3D,
    camera: geometry.Camera,
    points: Tensor,
    *,
    top_k: int,
    depth_min_max: Tuple[float, float],
    add_minmax: bool = False,
    use_variance: bool = True,
) -> ViewScanOutput:
  """Top-k streamed lifting of ``[B, V, h, w, D]`` features at ``[B, N, 3]``.

  The ranks of a point are its top-k views (all V when ``top_k`` is 0 or
  at least V), pooled softmax-weighted by the depth scores of
  ``scores_images [B, V, h, w, S]``, or unweighted where that is None;
  returns stats ``[B, N, C]`` (the layout of ``lift_topk``) in the feature
  dtype, valid ``[B, N]`` and min view distance ``[B, N]``.
  """
  b, v, h, w, dim = f_images.shape
  n = points.shape[1]
  p2d_all, vis_all, depth_all, _ = view_fusion.project_points_to_views(
      scene_t_view, camera, points)
  if top_k and v > top_k:
    view_indices, min_dist = view_fusion.view_selection(
        points, scene_t_view, vis_all, top_k)
  else:
    view_indices = torch.arange(v, device=points.device).expand(b, n, v)
    dist = torch.linalg.norm(
        points[..., None, :] - scene_t_view.t[..., None, :, :], dim=-1)
    min_dist = torch.where(vis_all, dist, torch.inf).amin(-1)

  idx = view_indices
  p2d_sel = torch.gather(p2d_all, 2, idx[..., None].expand(-1, -1, -1, 2))
  vis_sel = torch.gather(vis_all, 2, idx)
  depth_sel = torch.gather(depth_all, 2, idx)
  stats, valid = lift_topk(
      _image_stack(f_images, scores_images), idx.int().contiguous(),
      p2d_sel.contiguous(), vis_sel.contiguous(), depth_sel.contiguous(),
      h=h, w=w, dim=dim, depth_min_max=depth_min_max,
      use_variance=use_variance, add_minmax=add_minmax)
  return ViewScanOutput(stats=stats, valid=valid, min_distance=min_dist)


def scan_selection(points: Tensor, scene_t_view: geometry.Transform3D,
                   visible: Tensor, top_k: int) -> Tuple[Tensor, Tensor]:
  """The scan form's ranks that count, ``[B, N, V]``: visible, and no
  farther than the k-th nearest visible view (every visible view with
  fewer than k, or ``top_k`` 0); so a tie at that distance counts more than
  k (``_view_threshold``). Also the distance to the nearest visible view
  ``[B, N]``."""
  dist = torch.where(visible, view_fusion.view_distances(points, scene_t_view),
                     torch.inf)
  if top_k and dist.shape[-1] > top_k:
    threshold = -torch.topk(-dist, top_k, dim=-1).values[..., -1:]
  else:
    threshold = torch.full_like(dist[..., :1], torch.inf)
  return visible & (dist <= threshold), dist.amin(-1)


def pool_views_scan(
    f_images: Tensor,
    scores_images: Optional[Tensor],
    scene_t_view: geometry.Transform3D,
    camera: geometry.Camera,
    points: Tensor,
    *,
    top_k: int,
    depth_min_max: Tuple[float, float],
    add_minmax: bool = False,
    use_variance: bool = True,
) -> ViewScanOutput:
  """The scan form of the lift: every view a rank, in view order, as the
  reference's loop over the views visits them; a rank counts as
  ``scan_selection`` says. Shapes and layout as ``pool_views_stream``."""
  b, v, h, w, dim = f_images.shape
  n = points.shape[1]
  p2d, visible, depth, _ = view_fusion.project_points_to_views(
      scene_t_view, camera, points)
  select, min_dist = scan_selection(points, scene_t_view, visible, top_k)
  view_idx = torch.arange(v, dtype=torch.int32, device=points.device)
  stats, valid = lift_topk(
      _image_stack(f_images, scores_images),
      view_idx.expand(b, n, v).contiguous(), p2d.contiguous(),
      select.contiguous(), depth.contiguous(), h=h, w=w, dim=dim,
      depth_min_max=depth_min_max, use_variance=use_variance,
      add_minmax=add_minmax)
  return ViewScanOutput(stats=stats, valid=valid, min_distance=min_dist)


def patch_sample_2d_plain(padded: Tensor, points: Tensor, *, dim: int,
                          has_valid: bool) -> Tuple[Tensor, Tensor]:
  """Plain version of K2 (see ``patch_sample_2d``)."""
  b, hp, wp, _ = padded.shape
  h, w = hp - 1, wp - 1
  size = torch.tensor([h, w], dtype=torch.float32, device=points.device)
  in_bounds = ((points >= 0) & (points < size)).all(-1)
  pts = points - 0.5
  count_upper = pts >= 0  # else both taps collapse onto index 0
  pts = torch.minimum(torch.clamp(pts, min=0), size - 1)
  lower = torch.minimum(torch.floor(pts).int(), (size - 1).int())
  frac = pts - lower
  patches = gather_bilinear_patches(padded, lower[..., 0], lower[..., 1])
  w_i = torch.stack([1 - frac[..., 0], frac[..., 0]], -1)
  w_j = torch.stack([1 - frac[..., 1], frac[..., 1]], -1)
  weights = w_i[..., :, None] * w_j[..., None, :]  # [B, P, 2, 2]
  values = (weights[..., None] * patches[..., :dim].float()).sum((2, 3))
  ok = in_bounds
  if has_valid:
    tap_valid = patches[..., dim].float() > 0.5  # [B, P, 2, 2]
    first = torch.tensor([True, False], device=points.device)
    counted = ((count_upper[..., 0, None, None] | first[:, None])
               & (count_upper[..., 1, None, None] | first[None, :]))
    ok = ok & (tap_valid | ~counted).all(-1).all(-1)
  return values.to(padded.dtype), ok


def patch_sample_2d_bwd_plain(g_values: Tensor, points: Tensor, *,
                              plane_shape: Tuple[int, int, int, int]
                              ) -> Tensor:
  """Plain version of K4: ``d padded`` from ``g_values`` = d values.

  ``w_tap * g`` is added with ``index_add_`` at the four clamped taps of
  every point (K2's f32 coordinates), into an f32 buffer cast to
  ``g_values``' dtype; the validity channel gets nothing.
  """
  b, hp, wp, c = plane_shape
  dim = g_values.shape[-1]
  size = torch.tensor([hp - 1, wp - 1], dtype=torch.float32,
                      device=points.device)
  lower, weights = _bilinear_taps(points, size)
  lower = torch.minimum(lower, (size - 1).int())
  grad = torch.zeros((b * hp * wp, dim), device=points.device)
  offset = (torch.arange(b, device=points.device) * hp * wp)[:, None]
  g = g_values.float()
  for a in (0, 1):
    for e in (0, 1):
      ids = offset + (lower[..., 0] + a) * wp + lower[..., 1] + e
      grad.index_add_(0, ids.reshape(-1).long(),
                      (weights[..., a, e, None] * g).reshape(-1, dim))
  grad = torch.nn.functional.pad(grad, (0, c - dim))
  return grad.reshape(plane_shape).to(g_values.dtype)


class _PatchSample2d(torch.autograd.Function):
  """K2 forward, K4 backward (their plain versions for CPU tensors)."""

  @staticmethod
  def forward(ctx, padded, points, dim, has_valid):
    if kernels.on_card(padded, 'patch_sample_2d'):
      values, valid = kernels.patch_sample_2d(padded, points, dim=dim,
                                              has_valid=has_valid)
    else:
      values, valid = patch_sample_2d_plain(padded, points, dim=dim,
                                            has_valid=has_valid)
    ctx.save_for_backward(points)
    ctx.plane_shape = tuple(padded.shape)
    ctx.mark_non_differentiable(valid)
    return values, valid

  @staticmethod
  def backward(ctx, g_values, g_valid):
    del g_valid
    (points,) = ctx.saved_tensors
    args = (g_values.contiguous(), points)
    if kernels.on_card(g_values, 'patch_sample_2d_bwd'):
      d_padded = kernels.patch_sample_2d_bwd(*args,
                                             plane_shape=ctx.plane_shape)
    else:
      d_padded = patch_sample_2d_bwd_plain(*args, plane_shape=ctx.plane_shape)
    return d_padded, None, None, None


def patch_sample_2d(padded: Tensor, points: Tensor, *, dim: int,
                    has_valid: bool) -> Tuple[Tensor, Tensor]:
  """K2: bilinear samples of an edge-padded plane with validity.

  Args:
    padded: ``[B, H+1, W+1, C]`` edge-padded plane, C = dim (+1 validity
      channel holding 1.0 / 0.0 when ``has_valid``).
    points: ``[B, P, 2]`` f32 grid coordinates (cell centers at
      half-integers), as ``grids.interpolate_nd`` takes them.

  Returns:
    ``values [B, P, dim]`` in the plane's dtype and ``valid [B, P]``: in
    bounds, and every consulted corner valid. Differentiable in the
    feature channels of ``padded`` through K4.
  """
  return _PatchSample2d.apply(padded, points, dim, has_valid)


def interpolate_patch_2d(array: Tensor, valid: Optional[Tensor],
                         points: Tensor) -> Tuple[Tensor, Tensor]:
  """Bilinear 2-D interpolation with ``interpolate_nd``'s boundary rules.

  ``array [B, H, W, D]``, ``valid [B, H, W]`` bool or None, ``points
  [B, P, 2]``. Corner indices clamp to the grid (a clamped upper corner
  reads the edge-replicated pad), a low-edge point collapses both taps onto
  index 0 (the out-of-cell tap's validity is not consulted), and a point is
  valid iff in bounds and every consulted corner is valid. Returns
  ``(values [B, P, D], valid [B, P])``.
  """
  dim = array.shape[-1]
  if valid is not None:
    array = torch.cat([array, valid[..., None].to(array.dtype)], -1)
  padded = torch.cat([array, array[:, -1:]], 1)
  padded = torch.cat([padded, padded[:, :, -1:]], 2)
  return patch_sample_2d(padded.contiguous(), points.float().contiguous(),
                         dim=dim, has_valid=valid is not None)
