"""Multi-view lifting prologue: project points and select views.

Port of ``snap_tpu/ops/view_fusion.py:project_points_to_views`` and
``view_selection``, the plain-torch prologue of the streamed lift.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from snap_tpu_torch.utils import geometry

Tensor = torch.Tensor


def project_points_to_views(
    scene_t_view: geometry.Transform3D,
    camera: geometry.Camera,
    points: Tensor,
) -> Tuple[Tensor, Tensor, Tensor]:
  """Project ``[B, N, 3]`` scene points into every view of ``[B, V]``.

  Returns ``p2d [B, N, V, 2]`` in (i, j) = (row, col) pixels, ``visible
  [B, N, V]`` and the camera-frame z ``depth [B, N, V]``. (The JAX version
  also returns viewing rays, which the streamed lift does not read.)
  """
  points_view = scene_t_view.inv.transform(points[:, None])  # [B, V, N, 3]
  depth = points_view[..., -1]
  p2d, vis = camera.world2image(points_view)  # [B, V, N, 2], [B, V, N]
  p2d = p2d.flip(-1)  # (x, y) -> (i, j)
  return p2d.transpose(1, 2), vis.transpose(1, 2), depth.transpose(1, 2)


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
  diff = points[..., None, :] - scene_t_view.t[..., None, :, :]  # B,N,V,3
  dist = torch.sqrt((diff * diff).sum(-1))
  min_dist = torch.where(vis, dist, torch.inf).amin(-1)
  remaining = torch.where(vis, dist, 1e20)
  indices = []
  for _ in range(num):
    idx = torch.argmin(remaining, dim=-1)
    indices.append(idx)
    remaining = remaining + F.one_hot(
        idx, dist.shape[-1]).to(remaining.dtype) * 1e30
  return torch.stack(indices, -1), min_dist
