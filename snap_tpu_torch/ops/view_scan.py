"""Streamed top-k lifting and the 2x2 patch sampler.

Port of the serving half of ``snap_tpu/ops/view_scan.py``:

- ``pool_views_stream``: project, select the top-k views and pick the
  per-rank (view, pixel, visibility, depth) in plain torch, then pool with
  **K1** (``lift_topk``: 2x2 bilinear patch reads of the row-padded image
  stack, depth-hat score, online softmax over the k ranks);
- ``interpolate_patch_2d``: bilinear 2-D sampling with ``interpolate_nd``'s
  boundary rules around **K2** (``patch_sample_2d``).

Each kernel wrapper dispatches on the device of its input: a CPU tensor
takes the plain PyTorch version beside it (``*_plain``), a CUDA tensor
launches the kernel (``ops/kernels.py``), any other device raises.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from snap_tpu_torch.ops import kernels
from snap_tpu_torch.ops import view_fusion
from snap_tpu_torch.utils import geometry

Tensor = torch.Tensor

NEG_INF = -1e30


class ViewScanOutput(NamedTuple):
  stats: Tensor  # [B, N, 2D + 1] pooled (mean, var, score max)
  valid: Tensor  # [B, N]
  min_distance: Tensor  # [B, N]


def _dispatch(t: Tensor, kernel_name: str) -> bool:
  """True for the kernel (CUDA), False for the plain version (CPU)."""
  if t.device.type == 'cuda':
    return True
  if t.device.type == 'cpu':
    return False
  raise ValueError(f'{kernel_name}: no kernel for device {t.device}')


def gather_bilinear_patches(images: Tensor, row0: Tensor, col0: Tensor
                            ) -> Tensor:
  """``[B, R, W, C]`` stack, ``[B, N]`` origins -> ``[B, N, 2, 2, C]`` patches.

  The plain form of the 2x2xC gather (``tools/pallas_gather_probe.py:
  patch_gather_pallas``); the caller guarantees ``row0 <= R - 2`` and
  ``col0 <= W - 2``.
  """
  b, _, w, c = images.shape
  flat = images.reshape(b, -1, c)
  bidx = torch.arange(b, device=images.device)[:, None]
  rows = []
  for di in (0, 1):
    taps = [flat[bidx, ((row0 + di) * w + col0 + dj).long()] for dj in (0, 1)]
    rows.append(torch.stack(taps, 2))
  return torch.stack(rows, 2)


def _depth_hat_weights(depth: Tensor, num_bins: int,
                       depth_min_max: Tuple[float, float]) -> Tensor:
  """Hat-function interpolation weights over S log-depth bins: [..., S]."""
  lo, hi = depth_min_max
  x = torch.log(depth.clamp(lo, hi) / lo) / math.log(hi / lo) * (num_bins - 1)
  x = x.clamp(0, num_bins - 1)
  bins = torch.arange(num_bins, dtype=depth.dtype, device=depth.device)
  return torch.clamp(1 - torch.abs(x[..., None] - bins), min=0)


def lift_topk_plain(stack: Tensor, view_idx: Tensor, p2d: Tensor,
                    select: Tensor, depth: Tensor, *, h: int, w: int, dim: int,
                    depth_min_max: Tuple[float, float]
                    ) -> Tuple[Tensor, Tensor]:
  """Plain version of K1; ``stats`` in the stack's dtype, f32 inside."""
  b, n, k = view_idx.shape
  size = torch.tensor([h, w], dtype=torch.float32, device=stack.device)
  m = torch.full((b, n), NEG_INF, device=stack.device)
  l = torch.zeros((b, n), device=stack.device)
  s1 = torch.zeros((b, n, dim), device=stack.device)
  s2 = torch.zeros((b, n, dim), device=stack.device)
  count = torch.zeros((b, n), dtype=torch.int32, device=stack.device)
  for r in range(k):
    pts = torch.minimum(torch.clamp(p2d[:, :, r] - 0.5, min=0), size - 1)
    lower = torch.floor(pts)
    frac = pts - lower
    lower = lower.int()
    patches = gather_bilinear_patches(
        stack, view_idx[:, :, r] * (h + 1) + lower[..., 0], lower[..., 1])
    w_i = torch.stack([1 - frac[..., 0], frac[..., 0]], -1)
    w_j = torch.stack([1 - frac[..., 1], frac[..., 1]], -1)
    weights = w_i[..., :, None] * w_j[..., None, :]  # [B, N, 2, 2]
    f = (weights[..., None] * patches.float()).sum((2, 3))
    f, scales = f[..., :dim], f[..., dim:]
    score = (scales * _depth_hat_weights(
        depth[:, :, r], scales.shape[-1], depth_min_max)).sum(-1)
    sel = select[:, :, r]
    score = torch.where(sel, score, NEG_INF)
    new_m = torch.maximum(m, score)
    safe_m = torch.where(new_m <= NEG_INF, 0.0, new_m)
    rescale = torch.exp(torch.where(m <= NEG_INF, NEG_INF, m) - safe_m)
    wv = torch.exp(score - safe_m) * sel
    l = l * rescale + wv
    s1 = s1 * rescale[..., None] + wv[..., None] * f
    s2 = s2 * rescale[..., None] + wv[..., None] * f * f
    m = new_m
    count = count + sel
  valid = count > 0
  l_safe = torch.clamp(l, min=1e-20)[..., None]
  mean = s1 / l_safe
  var = torch.clamp(s2 / l_safe - mean * mean, min=0)
  stats = torch.cat([mean, var, torch.where(valid, m, 0.0)[..., None]], -1)
  stats = torch.where(valid[..., None], stats, 0.0)
  return stats.to(stack.dtype), valid


def lift_topk(stack: Tensor, view_idx: Tensor, p2d: Tensor, select: Tensor,
              depth: Tensor, *, h: int, w: int, dim: int,
              depth_min_max: Tuple[float, float]) -> Tuple[Tensor, Tensor]:
  """K1: pool the top-k ranks of each point from the row-padded stack.

  Args:
    stack: ``[B, V*(h+1), w+1, C]`` row-padded image stack, C = dim + S
      (features, then S log-depth score bins).
    view_idx: ``[B, N, K]`` int32 view of each rank.
    p2d: ``[B, N, K, 2]`` f32 (row, col) pixel coordinates per rank.
    select: ``[B, N, K]`` bool, the rank counts (visible and selected).
    depth: ``[B, N, K]`` f32 camera-frame depth per rank.

  Returns:
    ``stats [B, N, 2*dim + 1]`` = (mean, variance, max score), zero where
    invalid, in the stack's dtype, and ``valid [B, N]``.
  """
  args = (stack, view_idx, p2d, select, depth)
  kwargs = dict(h=h, w=w, dim=dim, depth_min_max=depth_min_max)
  if _dispatch(stack, 'lift_topk'):
    return kernels.lift_topk_fwd(*args, **kwargs)
  return lift_topk_plain(*args, **kwargs)


def pool_views_stream(
    f_images: Tensor,
    scores_images: Tensor,
    scene_t_view: geometry.Transform3D,
    camera: geometry.Camera,
    points: Tensor,
    *,
    top_k: int,
    depth_min_max: Tuple[float, float],
) -> ViewScanOutput:
  """Top-k streamed lifting of ``[B, V, h, w, D]`` features at ``[B, N, 3]``.

  Score-weighted mean/variance pooling (``use_variance=True``,
  ``add_minmax=False``, the configs' values); returns stats ``[B, N, 2D+1]``
  in the feature dtype, valid ``[B, N]`` and min view distance ``[B, N]``.
  """
  b, v, h, w, dim = f_images.shape
  n = points.shape[1]
  p2d_all, vis_all, depth_all = view_fusion.project_points_to_views(
      scene_t_view, camera, points)
  if top_k and v > top_k:
    view_indices, min_dist = view_fusion.view_selection(
        points, scene_t_view, vis_all, top_k)
  else:
    view_indices = torch.arange(v, device=points.device).expand(b, n, v)
    dist = torch.linalg.norm(
        points[..., None, :] - scene_t_view.t[..., None, :, :], dim=-1)
    min_dist = torch.where(vis_all, dist, torch.inf).amin(-1)

  images = torch.cat([f_images, scores_images.to(f_images.dtype)], -1)
  # Pad one zero row/col per view: the clamped bilinear coordinates give the
  # out-of-range tap a weight of exactly 0, so patches never need clamping.
  padded = torch.nn.functional.pad(images, (0, 0, 0, 1, 0, 1))
  stack = padded.reshape(b, v * (h + 1), w + 1, padded.shape[-1])

  idx = view_indices
  p2d_sel = torch.gather(p2d_all, 2, idx[..., None].expand(-1, -1, -1, 2))
  vis_sel = torch.gather(vis_all, 2, idx)
  depth_sel = torch.gather(depth_all, 2, idx)
  stats, valid = lift_topk(
      stack, idx.int().contiguous(), p2d_sel.contiguous(),
      vis_sel.contiguous(), depth_sel.contiguous(), h=h, w=w, dim=dim,
      depth_min_max=depth_min_max)
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
    bounds, and every consulted corner valid.
  """
  if _dispatch(padded, 'patch_sample_2d'):
    return kernels.patch_sample_2d(padded, points, dim=dim,
                                   has_valid=has_valid)
  return patch_sample_2d_plain(padded, points, dim=dim, has_valid=has_valid)


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
