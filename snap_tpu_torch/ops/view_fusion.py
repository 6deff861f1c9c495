"""Multi-view lifting ops: project, select, sample and pool image features.

Port of ``snap_tpu/ops/view_fusion.py``: the prologue that every form of
the lift runs (``project_points_to_views``, ``view_selection``), and the
gather form (``pooling_impl='gather'``, and every form with a depth MLP):
the per-observation ``[B, N, K, D]`` features sampled from the selected
views (``interpolate_views_selective``, ``interpolate_views_all``), the
depth score of weighted fusion (``interpolate_depth_score``) and the masked
statistics over the views (``pool_multiview_features``). The gather form is
the reference's plain XLA, not a hand-shaped op: its plain torch is its
port on the card too, differentiated by autograd.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from snap_tpu_torch.utils import geometry

Tensor = torch.Tensor


def project_points_to_views(
    scene_t_view: geometry.Transform3D,
    camera: geometry.Camera,
    points: Tensor,
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
  """Project ``[B, N, 3]`` scene points into every view of ``[B, V]``.

  Returns ``p2d [B, N, V, 2]`` in (i, j) = (row, col) pixels, ``visible
  [B, N, V]``, the camera-frame z ``depth [B, N, V]`` and the unit viewing
  rays in the camera frame ``[B, N, V, 3]``.
  """
  points_view = scene_t_view.inv.transform(points[:, None])  # [B, V, N, 3]
  depth = points_view[..., -1]
  distance = torch.linalg.norm(points_view, dim=-1, keepdim=True)
  rays = points_view / distance.clamp(min=1e-5)
  p2d, vis = camera.world2image(points_view)  # [B, V, N, 2], [B, V, N]
  p2d = p2d.flip(-1)  # (x, y) -> (i, j)
  return (p2d.transpose(1, 2), vis.transpose(1, 2), depth.transpose(1, 2),
          rays.transpose(1, 2))


def view_distances(points: Tensor, scene_t_view: geometry.Transform3D
                   ) -> Tensor:
  """``[B, N, V]`` distances from each point to each view's center."""
  diff = points[..., None, :] - scene_t_view.t[..., None, :, :]  # B,N,V,3
  return torch.sqrt((diff * diff).sum(-1))


def view_selection(
    points: Tensor,
    scene_t_view: geometry.Transform3D,
    vis: Tensor,
    num: int,
) -> Tuple[Tensor, Tensor]:
  """The ``num`` nearest visible views per point: ``[B, N, K]`` indices.

  Two penalty tiers keep the k indices distinct: already chosen views get a
  larger penalty than invisible ones, so once the visible views run out the
  fillers are distinct invisible views (masked downstream). ``argmin`` takes
  the first of equal values, as ``jnp.argmin`` does. Also returns the
  distance to the nearest visible view ``[B, N]``.
  """
  dist = view_distances(points, scene_t_view)
  min_dist = torch.where(vis, dist, torch.inf).amin(-1)
  remaining = torch.where(vis, dist, 1e20)
  indices = []
  for _ in range(num):
    idx = torch.argmin(remaining, dim=-1)
    indices.append(idx)
    remaining = remaining + F.one_hot(
        idx, dist.shape[-1]).to(remaining.dtype) * 1e30
  return torch.stack(indices, -1), min_dist


def gather_observations(x: Tensor, indices: Tensor) -> Tensor:
  """``x[b, n, indices[b, n, k]]``: ``[B, N, V, ...]`` -> ``[B, N, K, ...]``."""
  idx = indices.reshape(*indices.shape, *(1,) * (x.ndim - 3))
  idx = idx.expand(*indices.shape, *x.shape[3:])
  return torch.gather(x, 2, idx)


def interpolate_views_selective(images: Tensor, points: Tensor,
                                view_indices: Tensor) -> Tensor:
  """Bilinear samples ``[B, N, K, D]`` of ``[B, V, H, W, D]`` feature maps
  at ``[B, N, K, 2]`` (i, j) pixels of the views ``[B, N, K]``.

  The reference's 4-tap bilinear: coordinates shifted by -0.5 (pixel
  centres) and clamped to [0, size - 1], the upper tap clamped too (its
  weight is 0 there); the taps' products summed in the images' dtype.
  """
  b, v, h, w, d = images.shape
  n, k = view_indices.shape[1:]
  flat = images.reshape(b * v * h * w, d)
  size = torch.tensor([h, w], dtype=points.dtype, device=points.device)
  pts = torch.minimum(torch.clamp(points - 0.5, min=0), size - 1)
  lower = torch.floor(pts)
  w_upper = pts - lower
  w_lower = 1.0 - w_upper
  lower = lower.long()
  upper = torch.minimum(lower + 1, torch.tensor([h - 1, w - 1],
                                                device=points.device))
  example = torch.arange(b, device=points.device)[:, None, None]
  base = (example * v + view_indices) * (h * w)  # [B, N, K]
  out = None
  for ci, wi in ((lower[..., 0], w_lower[..., 0]),
                 (upper[..., 0], w_upper[..., 0])):
    for cj, wj in ((lower[..., 1], w_lower[..., 1]),
                   (upper[..., 1], w_upper[..., 1])):
      flat_idx = (base + ci * w + cj).reshape(-1)
      vals = flat.index_select(0, flat_idx).reshape(b, n, k, d)
      contrib = (wi * wj)[..., None].to(vals.dtype) * vals
      out = contrib if out is None else out + contrib
  return out


def interpolate_views_all(images: Tensor, points: Tensor) -> Tensor:
  """Every view sampled at its own points: ``[B, N, V, 2]`` -> ``[B, N, V,
  D]``."""
  b, v = images.shape[:2]
  n = points.shape[1]
  view_idx = torch.arange(v, device=points.device).expand(b, n, v)
  return interpolate_views_selective(images, points, view_idx)


def depth_hat_weights(depth: Tensor, num_bins: int,
                      depth_min_max: Tuple[float, float],
                      dtype: torch.dtype = torch.float32) -> Tensor:
  """Hat-function interpolation weights ``[..., S]`` over S log-spaced depth
  bins, the bins' abscissa computed in ``depth``'s dtype and the hats in
  ``dtype``.

  The abscissa is ``log(d / lo) / log(hi / lo) * (S - 1)``, each division a
  true one by a tensor on ``depth``'s device, as K1 and K3 form it: a
  division by a Python scalar is a product with its reciprocal on the card,
  which moves the abscissa, and with it a score and the rank its max picks,
  by an ulp (ROADMAP C10)."""
  lo, hi = depth_min_max
  as_tensor = lambda v: torch.tensor(v, dtype=depth.dtype, device=depth.device)
  x = torch.log(depth.clamp(lo, hi) / as_tensor(lo)) / as_tensor(
      math.log(hi / lo)) * (num_bins - 1)
  x = x.clamp(0, num_bins - 1)
  bins = torch.arange(num_bins, dtype=dtype, device=depth.device)
  return torch.clamp(1 - torch.abs(x[..., None].to(dtype) - bins), min=0)


def interpolate_depth_score(score_scales: Tensor, depth: Tensor,
                            depth_min_max: Tuple[float, float]) -> Tensor:
  """Per-observation scores ``[..., S]`` over log-depth bins, linearly
  interpolated at ``depth [...]``: ``[...]`` in the scores' dtype."""
  hat = depth_hat_weights(depth, score_scales.shape[-1], depth_min_max,
                          score_scales.dtype)
  return (score_scales * hat).sum(-1)


def pool_multiview_features(
    feats: Tensor,
    valid: Tensor,
    scores: Optional[Tensor] = None,
    add_minmax: bool = True,
    use_variance: bool = True,
) -> Tuple[Tensor, Tensor]:
  """Masked statistics of ``feats [..., V, D]`` over the views ``valid
  [..., V]``: ``[mean, var?, max?, min?, score_max?]`` in the features'
  dtype, zero where no view is valid, and ``valid.any(-1)``.

  As ``jnp.mean``/``jnp.var`` on bf16, the mean and variance are computed
  in f32 and cast; with ``scores [..., V]`` they are weighted by the f32
  softmax of the valid scores. The max and min split their gradient evenly
  over tied entries, as ``jnp.max``'s (``reduce_max``'s JVP) does, which
  ``torch.amax``/``amin`` do too.
  """
  valid_any = valid.any(-1)
  valid_ = torch.where(valid_any[..., None], valid, True)[..., None]
  feats32 = feats.float()
  if scores is None:
    count = valid_.sum(-2).float()
    mean32 = torch.where(valid_, feats32, 0.0).sum(-2) / count
    centered = feats32 - mean32[..., None, :]
    var32 = torch.where(valid_, centered * centered, 0.0).sum(-2) / count
  else:
    weights = torch.softmax(
        torch.where(valid_, scores.float()[..., None], -torch.inf), dim=-2)
    weights = torch.where(valid_, weights, 0.0)
    mean32 = (weights * feats32).sum(-2)
    var32 = (weights * (feats32 - mean32[..., None, :])**2).sum(-2)
  stats = [mean32.to(feats.dtype)]
  if use_variance:
    stats.append(var32.to(feats.dtype))
  if add_minmax:
    stats.append(torch.where(valid_, feats, -torch.inf).amax(-2))
    stats.append(torch.where(valid_, feats, torch.inf).amin(-2))
  if scores is not None:
    stats.append(
        torch.where(valid_, scores[..., None], -torch.inf).amax(-2))
  stats = torch.where(valid_any[..., None], torch.cat(stats, -1), 0)
  return stats, valid_any
