"""Pose hypotheses of the RANSAC backend: sampling, scoring, refinement.

Port of ``snap_tpu/models/pose_estimation.py``, with its names:

- ``sample_transforms_ransac``: correspondences drawn from the match PDF,
  two per hypothesis, the most rigid of ``num_retries`` pairs kept, and a
  closed-form 2-point fit (``kabsch_2d``);
- ``pose_scoring_many``: for every pose and query point, a bilinear read of
  that point's own score map at the transformed point, summed over the
  points. On a CUDA tensor it launches **B4** (``csrc/pose_scoring.cu``,
  the port of ``_pose_scoring_block``) once for all poses, and its
  gradient in the score maps is **B7** (``csrc/pose_scoring_bwd.cu``, the
  port of JAX's autodiff of it); on a CPU tensor it runs
  ``pose_scoring_plain`` and ``pose_scoring_bwd_plain``, the same
  arithmetic in chunks of poses (of points for the latter, which sums each
  entry in B7's order: runs of 32 poses, each in ascending pose then tap);
- ``grid_refinement``: every offset of a dense 41 x 41 x 41 (rotation, x,
  y) lattice around a pose, scored the same way.

Every random draw takes an explicit CPU ``torch.Generator``, so a run on the
card and one on the CPU draw the same numbers; the draws of JAX's
``jax.random`` are other numbers from the same distributions (ROADMAP C8),
so each sampler can also take its draws injected (``indices=``).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from snap_tpu_torch.ops import kernels
from snap_tpu_torch.utils import geometry
from snap_tpu_torch.utils import grids

Tensor = torch.Tensor

# Poses per chunk of the plain scorer, as the JAX package tiles them; it
# bounds the [B, chunk, N] intermediates, not the result.
POSE_CHUNK = 4096
# B7 sums each entry of d sim over runs of this many consecutive poses
# first, then over the runs (csrc/pose_scoring_bwd.cu: a producer warp's
# poses).
POSE_RUN = 32


def sample_sparse_query_points(
    features: Tensor, valid: Tensor, grid: grids.Grid2D, num_points: int,
    generator: Optional[torch.Generator] = None,
    indices: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
  """``num_points`` distinct cells of a 2D feature map ``[H, W, D]``.

  The cells are ``indices`` (flat, into the grid's cells) or a prefix of a
  random permutation drawn on ``generator``.
  """
  uv_all = grid.grid_index(features.device).reshape(-1, 2)
  assert num_points <= uv_all.shape[0]
  if indices is None:
    indices = torch.randperm(uv_all.shape[0], generator=generator)
    indices = indices[:num_points]
  uv = uv_all[indices.to(features.device).long()]
  xy = (uv + 0.5) * grid.cell_size
  rows, cols = uv[:, 0].long(), uv[:, 1].long()
  return features[rows, cols], valid[rows, cols], xy, uv


def sample_categorical(probs: Tensor, num: int,
                       generator: Optional[torch.Generator] = None,
                       batch_rows: Optional[Tuple[int, int]] = None
                       ) -> Tensor:
  """``num`` draws with replacement from each row of ``probs [B, M]``.

  Inverse CDF as ``jax.random.choice(p=...)`` draws it (the first index
  whose prefix sum reaches ``total * (1 - u)``), but the prefix sum is
  taken in f64: at M = 89.3M categories of mean mass 1.1e-8 an f32 prefix
  sum stops growing once it passes half an ulp of the running total, and
  categories behind that point could not be drawn (ROADMAP C14).
  ``torch.multinomial`` refuses more than 2^24 categories. The uniforms
  are drawn on ``generator`` (CPU); the returned indices are int64 on
  ``probs``' device. ``batch_rows`` = (first, size): ``probs`` holds rows
  ``first ..`` of a global batch of ``size`` (a rank's block), and the
  uniforms are drawn for the global batch and these rows taken.
  """
  b, m = probs.shape
  first, size = (0, b) if batch_rows is None else batch_rows
  u = torch.rand((size, num), generator=generator, dtype=torch.float64)
  u = u[first:first + b].to(probs.device)
  out = []
  for row in range(b):  # one f64 prefix sum (M x 8 bytes) at a time
    cdf = torch.cumsum(probs[row].to(torch.float64), 0)
    draw = torch.searchsorted(cdf, cdf[-1] * (1 - u[row]))
    out.append(draw.clamp_(max=m - 1))
    del cdf
  return torch.stack(out)


def sample_transforms_random(generator: Optional[torch.Generator], num: int,
                             grid: grids.Grid2D) -> geometry.Transform2D:
  """Uniform random poses: any yaw, translation within 2/3 grid extents,
  the rotation acting about the grid center (see the JAX docstring)."""
  draws = torch.rand((num, 3), generator=generator)
  yaw = draws[:, 0] * (2 * math.pi)
  half_extent = torch.as_tensor(np.asarray(grid.extent_meters) / 2,
                                dtype=torch.float32)
  t_about_center = (draws[:, 1:] * 2 - 1) * (half_extent * 4 / 3)
  spin = geometry.Transform2D.from_radians(yaw, torch.zeros_like(
      t_about_center))
  t_corner = half_extent + t_about_center - spin.transform(half_extent[None])[
      :, 0]
  return geometry.Transform2D.from_radians(yaw, t_corner)


def kabsch_2d(i_p: Tensor, j_p: Tensor) -> Tuple[geometry.Transform2D, Tensor]:
  """Closed-form least-squares 2D rigid fit ``i_t_j`` between point sets
  (the point axis is -2), and the residual RSSD: ``theta = atan2(b, a)``
  with ``a = sum <i', j'>``, ``b = sum cross(j', i')`` of the centered
  sets."""
  mu_i = i_p.mean(-2)
  mu_j = j_p.mean(-2)
  i_c = i_p - mu_i[..., None, :]
  j_c = j_p - mu_j[..., None, :]
  a = torch.sum(i_c * j_c, dim=(-1, -2))
  b = torch.sum(j_c[..., 0] * i_c[..., 1] - j_c[..., 1] * i_c[..., 0], -1)
  angle = torch.atan2(b, a)
  cos, sin = torch.cos(angle), torch.sin(angle)
  r_mu_j = torch.stack([cos * mu_j[..., 0] - sin * mu_j[..., 1],
                        sin * mu_j[..., 0] + cos * mu_j[..., 1]], -1)
  t = mu_i - r_mu_j
  norm2 = torch.sum(i_c**2 + j_c**2, dim=(-1, -2))
  rssd = torch.sqrt((norm2 - 2 * torch.hypot(a, b)).clamp(min=0))
  return geometry.Transform2D.from_radians(angle, t), rssd


def sample_transforms_ransac(
    prob_points: Tensor, i_xy_p: Tensor, num_poses: int, num_retries: int,
    grid: grids.Grid2D, generator: Optional[torch.Generator] = None,
    indices: Optional[Tensor] = None,
    batch_rows: Optional[Tuple[int, int]] = None,
) -> geometry.Transform2D:
  """Poses from 2-point correspondences drawn from the match PDF.

  Args:
    prob_points: ``[B, N, H, W]`` correspondence PDF.
    i_xy_p: ``[B, N, 2]`` query-point coordinates (meters).
    num_poses, num_retries: P poses; per pose, ``num_retries`` pairs are
      drawn and the one whose two segment lengths (query, map) differ least
      in log is fitted.
    grid: the map grid.
    generator: draws the match indices (``sample_categorical``) unless
      ``indices`` are given.
    indices: ``[B, P * R * 2]`` flat indices into ``[N, H, W]``, as
      ``jax.random.choice`` returns them.
    batch_rows: (first, size) where the batch is a rank's block of a global
      batch (``sample_categorical``).

  Returns:
    ``j_t_i`` poses with batch shape ``[B, P]``.
  """
  b, n, h, w = prob_points.shape
  if indices is None:
    indices = sample_categorical(prob_points.reshape(b, -1),
                                 num_poses * num_retries * 2, generator,
                                 batch_rows)
  indices = indices.to(prob_points.device).long()
  point, cell = indices // (h * w), indices % (h * w)
  pool_shape = (b, num_poses, num_retries, 2, 2)
  i_xy_pool = torch.gather(i_xy_p, 1, point[..., None].expand(-1, -1, 2))
  i_xy_pool = i_xy_pool.reshape(pool_shape)
  j_xy_pool = grid.index_to_xyz(torch.stack([cell // w, cell % w], -1))
  j_xy_pool = j_xy_pool.reshape(pool_shape)
  if num_retries > 1:
    def segment_log_length(pts):  # [..., R, 2 (obs), 2 (xy)] -> [..., R]
      length = torch.linalg.norm(pts[..., 1, :] - pts[..., 0, :], dim=-1)
      return torch.log(length.clamp(min=1e-5))

    stretch = torch.abs(segment_log_length(i_xy_pool)
                        - segment_log_length(j_xy_pool))
    select = torch.argmin(stretch, -1)[..., None, None, None]
    select = select.expand(-1, -1, 1, 2, 2)
    i_xy_pool = torch.gather(i_xy_pool, 2, select).squeeze(2)
    j_xy_pool = torch.gather(j_xy_pool, 2, select).squeeze(2)
  else:
    i_xy_pool = i_xy_pool.squeeze(2)
    j_xy_pool = j_xy_pool.squeeze(2)
  j_t_i, _ = kabsch_2d(j_xy_pool, i_xy_pool)
  return j_t_i


def _pose_taps(angle: Tensor, t: Tensor, xy: Tensor, valid_map: Tensor,
               h: int, w: int, cell_size: float, mask_out_of_bounds: bool):
  """The four bilinear taps of every (pose, point) of ``_pose_scoring_block``
  of the JAX package, whose arithmetic B4 and B7 repeat operation by
  operation: per tap (a, c) its row and column ``[B, P, N]`` and weight
  ``w_u[a] * w_v[c]``, and whether the read counts beside the point's own
  validity (the transformed point in bounds on four valid cells, with the
  mask; else None)."""
  cos, sin = torch.cos(angle)[..., None], torch.sin(angle)[..., None]
  x, y = xy[:, None, :, 0], xy[:, None, :, 1]  # [B, 1, N]
  # R @ p + t with R = [[cos, -sin], [sin, cos]], then / cell_size (a
  # device tensor: a CUDA division by a CPU scalar multiplies by its
  # reciprocal instead).
  cell = torch.tensor(cell_size, dtype=torch.float32, device=xy.device)
  u = (t[..., 0, None] + (cos * x + (-sin) * y)) / cell
  v = (t[..., 1, None] + (sin * x + cos * y)) / cell
  pu = torch.clamp(u - 0.5, min=0, max=h - 1)
  pv = torch.clamp(v - 0.5, min=0, max=w - 1)
  lower_u, lower_v = torch.floor(pu).long(), torch.floor(pv).long()
  upper_u = torch.clamp(lower_u + 1, max=h - 1)
  upper_v = torch.clamp(lower_v + 1, max=w - 1)
  frac_u, frac_v = pu - lower_u, pv - lower_v
  w_u, w_v = (1 - frac_u, frac_u), (1 - frac_v, frac_v)
  coords_u, coords_v = (lower_u, upper_u), (lower_v, upper_v)
  taps = [(coords_u[a], coords_v[c], w_u[a] * w_v[c])
          for a in range(2) for c in range(2)]
  if not mask_out_of_bounds:
    return taps, None
  valid = (u >= 0) & (u < h) & (v >= 0) & (v < w)  # [B, P, N]
  b = angle.shape[0]
  flat_valid = valid_map.reshape(b, -1)
  for cu, cv, _ in taps:
    idx = (cu * w + cv).reshape(b, -1)
    valid = valid & torch.gather(flat_valid, 1, idx).reshape(cu.shape)
  return taps, valid


def _pose_scoring_block(angle: Tensor, t: Tensor, sim: Tensor, xy: Tensor,
                        valid_points: Tensor, valid_map: Tensor,
                        cell_size: float, mask_out_of_bounds: bool
                        ) -> Tensor:
  """``[B, P]`` scores of the poses ``(angle [B, P], t [B, P, 2])``: per
  pose, the sum over points n of ``sim[b, n]`` read bilinearly at the
  transformed point (``_pose_scoring_block`` of the JAX package)."""
  b, n, h, w = sim.shape
  taps, valid = _pose_taps(angle, t, xy, valid_map, h, w, cell_size,
                           mask_out_of_bounds)
  flat = sim.reshape(b, -1)
  point_ids = torch.arange(n, device=sim.device) * (h * w)
  scores = None
  for cu, cv, weight in taps:
    idx = (point_ids + cu * w + cv).reshape(b, -1)
    contrib = weight * torch.gather(flat, 1, idx).reshape(cu.shape)
    scores = contrib if scores is None else scores + contrib
  keep = valid_points[:, None, :]
  if mask_out_of_bounds:
    keep = keep & valid
  return torch.sum(keep * scores, -1)


def pose_scoring_plain(angle: Tensor, t: Tensor, sim: Tensor, xy: Tensor,
                       valid_points: Tensor, valid_map: Tensor, *,
                       cell_size: float, mask_out_of_bounds: bool,
                       pose_chunk: int = POSE_CHUNK) -> Tensor:
  """B4's plain version: ``_pose_scoring_block`` over chunks of
  ``pose_chunk`` poses (the chunks only bound memory)."""
  return torch.cat([
      _pose_scoring_block(angle[:, s:s + pose_chunk], t[:, s:s + pose_chunk],
                          sim, xy, valid_points, valid_map, cell_size,
                          mask_out_of_bounds)
      for s in range(0, angle.shape[-1], pose_chunk)], -1)


def fold_runs(key: Tensor, value: Tensor) -> Tuple[Tensor, Tensor]:
  """Per distinct ``key``, the left fold from +0.0 of its ``value`` entries
  in the order they are listed: ``(keys, sums)``, one entry per key (the
  longest runs first).

  A stable sort puts each key's entries in one run, in their order; round
  r then adds the r-th entry of every run still open into its sum, one
  gather and one add over distinct sums. Each sum is thus formed by the
  same sequence of f32 (or f64) additions on any device and for any
  batching of the runs; the rounds number the longest run."""
  if key.numel() == 0:
    return key, value
  key, order = torch.sort(key, stable=True)
  value = value[order]
  first = torch.ones_like(key, dtype=torch.bool)
  first[1:] = key[1:] != key[:-1]
  starts = first.nonzero().squeeze(1)
  lengths = torch.diff(starts, append=starts.new_tensor([key.numel()]))
  lengths, by_length = torch.sort(lengths, descending=True)
  starts = starts[by_length]
  # open_runs[r]: the runs of more than r entries, a prefix of the sorted.
  ended = torch.cumsum(torch.bincount(lengths), 0)[:-1]
  open_runs = (starts.numel() - ended).tolist()
  sums = torch.zeros_like(value[:starts.numel()])
  for r, k in enumerate(open_runs):
    sums[:k] += value[starts[:k] + r]
  return key[starts], sums


def pose_scoring_bwd_plain(g: Tensor, angle: Tensor, t: Tensor, xy: Tensor,
                           valid_points: Tensor, valid_map: Tensor, *,
                           sim_shape: Tuple[int, int, int, int],
                           cell_size: float, mask_out_of_bounds: bool,
                           pose_chunk: int = POSE_CHUNK) -> Tensor:
  """B7's plain version: ``d sim [B, N, H, W]`` (``g``'s dtype) from ``g`` =
  d scores ``[B, P]``, the VJP of ``pose_scoring_plain`` in ``sim``.

  Summation order (B7's, ``csrc/pose_scoring_bwd.cu``): each entry of
  ``d sim`` is the left fold from +0.0, over the runs of ``POSE_RUN``
  consecutive poses in ascending order, of each run's left fold from +0.0
  of its contributions ``(w_u w_v) * (g * keep)`` to the entry (the
  reference's product, as JAX's autodiff forms it) in ascending pose, a
  pose's taps in the order (lower, lower), (lower, upper), (upper, lower),
  (upper, upper). Contributions that are +-0 change no such fold and are
  left out before it (``fold_runs``).

  It recomputes the forward's taps for all poses and a chunk of points at
  a time, sized so that the ``[B, P, points]`` intermediates hold about as
  many entries as ``[B, pose_chunk, N]``: ``pose_chunk`` bounds memory
  and leaves the result unchanged."""
  b, n, h, w = sim_shape
  p = angle.shape[-1]
  out = torch.zeros((b * n * h * w,), dtype=g.dtype, device=g.device)
  step = max(1, pose_chunk * n // max(p, 1))
  example = torch.arange(b, device=g.device)[:, None, None, None]
  runs = max(1, -(-p // POSE_RUN))
  run = (torch.arange(p, device=g.device) // POSE_RUN)[:, None, None]
  for s in range(0, n, step):
    points = torch.arange(s, min(s + step, n), device=g.device)
    taps, valid = _pose_taps(angle, t, xy[:, s:s + step], valid_map, h, w,
                             cell_size, mask_out_of_bounds)
    keep = valid_points[:, None, s:s + step]
    if mask_out_of_bounds:
      keep = keep & valid
    g_keep = g[:, :, None] * keep
    # [B, P, points, tap]: for each (example, point), poses then taps.
    cell = torch.stack([cu * w + cv for cu, cv, _ in taps], -1)
    value = torch.stack([weight * g_keep for _, _, weight in taps], -1)
    key = ((example * n + points[:, None]) * (h * w) + cell) * runs + run
    key, value = key.reshape(-1), value.reshape(-1)
    nonzero = value != 0  # NaN stays
    key, sums = fold_runs(key[nonzero], value[nonzero])  # each run's fold
    key, order = torch.sort(key)  # per entry, its runs in ascending order
    key, sums = fold_runs(key // runs, sums[order])
    out[key] = sums
  return out.reshape(b, n, h, w)


class _PoseScoring(torch.autograd.Function):
  """B4 forward, B7 backward (their plain versions for CPU tensors); the
  gradient reaches ``sim`` only. The scores are linear in ``sim``, so the
  backward needs the poses, points and masks, never ``sim`` itself."""

  @staticmethod
  def forward(ctx, angle, t, sim, xy, valid_points, valid_map, kwargs,
              pose_chunk):
    args = (angle, t, sim, xy, valid_points, valid_map)
    if kernels.on_card(sim, 'pose_scoring'):
      scores = kernels.pose_scoring(*args, **kwargs)
    else:
      scores = pose_scoring_plain(*args, **kwargs, pose_chunk=pose_chunk)
    ctx.save_for_backward(angle, t, xy, valid_points, valid_map)
    ctx.kwargs = dict(kwargs, sim_shape=tuple(sim.shape))
    ctx.pose_chunk = pose_chunk
    return scores

  @staticmethod
  def backward(ctx, g):
    args = (g.contiguous(), *ctx.saved_tensors)
    if kernels.on_card(g, 'pose_scoring_bwd'):
      d_sim = kernels.pose_scoring_bwd(*args, **ctx.kwargs)
    else:
      d_sim = pose_scoring_bwd_plain(*args, **ctx.kwargs,
                                     pose_chunk=ctx.pose_chunk)
    return None, None, d_sim, None, None, None, None, None


def pose_scoring_many(
    j_t_i: geometry.Transform2D, scores_points_all: Tensor,
    i_xy_points: Tensor, valid_points: Tensor, valid_j: Tensor,
    grid: grids.Grid2D, mask_out_of_bounds: bool,
    pose_chunk: int = POSE_CHUNK,
) -> Tensor:
  """``[B, P]`` scores of the poses ``j_t_i [B, P]``.

  Args:
    scores_points_all: ``[B, N, H, W]`` f32 per-query-point score maps.
    i_xy_points: ``[B, N, 2]`` query points in frame i (meters).
    valid_points: ``[B, N]`` query-point validity.
    valid_j: ``[B, H, W]`` map validity.
    mask_out_of_bounds: also require the transformed point to land inside
      the map on four valid cells; otherwise reads clamp to the border and
      count.

  Differentiable in ``scores_points_all`` only (the poses and points
  raise if they need a gradient): on a CUDA tensor B4 scores all poses in
  one launch and B7 takes the gradient; on a CPU tensor their plain
  versions run, their intermediates about ``[B, pose_chunk, N]``; any
  other device raises.
  """
  args = (j_t_i.angle.contiguous(), j_t_i.t.contiguous(),
          scores_points_all.contiguous(), i_xy_points.contiguous(),
          valid_points.contiguous(), valid_j.contiguous())
  if torch.is_grad_enabled() and any(
      a.requires_grad for a in (args[0], args[1], args[3])):
    raise ValueError('pose_scoring_many differentiates in the score maps '
                     'only; the poses and points need no gradient')
  kwargs = dict(cell_size=grid.cell_size,
                mask_out_of_bounds=mask_out_of_bounds)
  return _PoseScoring.apply(*args, kwargs, pose_chunk)


def make_refinement_offsets(
    delta_p: float = 0.2, delta_r: float = 0.25, range_p: float = 4.0,
    range_r: float = 5.0, device: torch.device = torch.device('cpu'),
) -> Tuple[geometry.Transform2D, Tuple[int, int, int]]:
  """Dense (rotation, x, y) offsets around a pose for grid refinement:
  +-5 deg at 0.25 deg x (+-4 m at 0.2 m)^2 = 41 x 41 x 41 by default."""
  def axis(extent, step):
    # jnp.linspace's formula in f32, start (1 - s) + stop s with s = i / div;
    # XLA's fused evaluation of it rounds some entries differently (by up
    # to 4.8e-7 m and 4.2e-9 rad at the defaults).
    div = round(2 * extent / step)
    s = torch.arange(div, dtype=torch.float32, device=device) / div
    out = -extent * (1 - s) + extent * s
    return torch.cat([out, torch.full((1,), extent, device=device)])

  rot, dx, dy = torch.meshgrid(
      axis(range_r, delta_r), axis(range_p, delta_p), axis(range_p, delta_p),
      indexing='ij')
  offsets = geometry.Transform2D.from_radians(
      torch.deg2rad(rot.reshape(-1)),
      torch.stack([dx.reshape(-1), dy.reshape(-1)], -1))
  return offsets, tuple(rot.shape)


def grid_refinement(
    j_t_i_init: geometry.Transform2D, scores_points_all: Tensor,
    i_xy_points: Tensor, valid_points: Tensor, valid_j: Tensor,
    grid: grids.Grid2D, mask_out_of_bounds: bool,
) -> Tuple[geometry.Transform2D, Tensor]:
  """Score every offset of ``make_refinement_offsets`` around each pose of
  ``j_t_i_init [B]``; returns the best ``[B]`` and the ``[B, R, X, Y]``
  score volume."""
  offsets, shape = make_refinement_offsets(
      device=scores_points_all.device)
  samples = j_t_i_init.unsqueeze(-1) @ offsets  # [B, 1] @ [R] -> [B, R]
  scores = pose_scoring_many(samples, scores_points_all, i_xy_points,
                             valid_points, valid_j, grid, mask_out_of_bounds)
  refined = samples.take(torch.argmax(scores, -1))
  return refined, scores.reshape(*scores.shape[:-1], *shape)
