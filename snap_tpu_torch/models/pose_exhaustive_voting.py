"""Dense 3-DoF pose voting: exhaustive translation x rotation matching.

Port of ``snap_tpu/models/pose_exhaustive_voting.py`` (serving path):

- the query BEV is warped into R rotated templates by **K2**
  (``view_scan.interpolate_patch_2d``);
- the templates are correlated against the edge-padded map with
  ``torch.fft`` (the same 5-smooth FFT sizes as the JAX package, chunks of
  8 rotations, the conj-product channel contraction as ``torch.einsum``),
  with the ``min_overlap`` valid-count mask and the per-template
  normalization;
- the best coarse pose is refined over a fan of fine angles by a windowed
  ``conv2d`` correlation.

Functions take a leading batch axis where the JAX package vmaps.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from snap_tpu_torch.models import types
from snap_tpu_torch.ops import view_scan
from snap_tpu_torch.utils import geometry
from snap_tpu_torch.utils import grids

Tensor = torch.Tensor


def template_points(angles: Tensor, grid: grids.Grid2D, batch: int
                    ) -> Tensor:
  """Where the templates read the query BEV: ``[B, R * H * W, 2]`` grid
  coordinates, template r at cell u reading ``c + R(angle_r) (u - c)``
  (rotation about the grid center c), in template order. ``angles``:
  ``[R]`` (shared) or ``[B, R]`` radians, on the device of the result."""
  device = angles.device
  angles = angles.float()
  if angles.ndim == 1:
    angles = angles[None].expand(batch, -1)
  r = angles.shape[1]
  c = torch.as_tensor(grid.extent_meters / 2, dtype=torch.float32,
                      device=device)
  # corner_t_center @ rotated_t_grid @ corner_t_center.inv
  corner_t_center = geometry.Transform2D(angle=torch.zeros((), device=device),
                                         t=c)
  rotated = geometry.Transform2D(angle=angles, t=torch.zeros(batch, r, 2,
                                                             device=device))
  templates_t_grid = corner_t_center @ rotated @ corner_t_center.inv
  grid_xy = grid.index_to_xyz(grid.grid_index(device).float()).reshape(-1, 2)
  templates_uv = templates_t_grid.transform(grid_xy) / grid.cell_size
  return templates_uv.reshape(batch, -1, 2)


def sample_query_templates(
    features: Tensor,
    valid: Tensor,
    angles: Tensor,
    grid: grids.Grid2D,
) -> Tuple[Tensor, Tensor]:
  """Rotate ``[B, H, W, D]`` BEVs into templates about the grid center.

  ``angles``: ``[R]`` (shared) or ``[B, R]`` radians. Returns templates
  ``[B, R, H, W, D]`` (zero where invalid) and validity ``[B, R, H, W]``;
  template r at cell u holds the query value at ``c + R(angle_r) (u - c)``.
  """
  b, h, w, d = features.shape
  points = template_points(angles.to(features.device), grid, b)
  r = points.shape[1] // (h * w)
  t_feats, t_valid = view_scan.interpolate_patch_2d(features, valid, points)
  t_feats = torch.where(t_valid[..., None], t_feats, 0)
  return t_feats.reshape(b, r, h, w, d), t_valid.reshape(b, r, h, w)


def _next_fast_len(n: int) -> int:
  """Smallest 5-smooth (2^a 3^b 5^c) size >= n."""
  best = 1 << (n - 1).bit_length()
  p3 = 1
  while p3 < best:
    p5 = p3
    while p5 < best:
      p2 = p5
      while p2 < n:
        p2 *= 2
      best = min(best, p2)
      p5 *= 5
    p3 *= 3
  return best


def _edge_pad2d(x: Tensor, ph: int, pw: int) -> Tensor:
  """Edge-replicate ``ph`` rows and ``pw`` cols on each side of [H, W, D]."""
  rows = torch.arange(-ph, x.shape[0] + ph, device=x.device)
  cols = torch.arange(-pw, x.shape[1] + pw, device=x.device)
  rows = rows.clamp(0, x.shape[0] - 1)
  cols = cols.clamp(0, x.shape[1] - 1)
  return x[rows][:, cols]


def template_matching_fft(
    q: Tensor,
    q_valid: Tensor,
    m: Tensor,
    m_valid: Tensor,
    min_overlap: Optional[float] = 0.05,
) -> Tuple[Tensor, Tensor]:
  """Correlate R templates ``[R, Hq, Wq, D]`` against a map ``[H, W, D]``.

  Returns ``(masked, raw)`` score volumes ``[R, H + Hq - 1, W + Wq - 1]``:
  output (r, a, b) aligns template cell (0, 0) with map cell
  (a - Hq + 1, b - Wq + 1); scores are normalized by the template's valid
  count, and ``masked`` is -inf where fewer than ``min_overlap`` of the
  template's cells overlap valid map cells.
  """
  r, hq, wq, d = q.shape
  h, w = m.shape[:2]
  out_h, out_w = h + hq - 1, w + wq - 1
  m_pad = _edge_pad2d(m, hq - 1, wq - 1).float()
  fft_h = _next_fast_len(m_pad.shape[0])
  fft_w = _next_fast_len(m_pad.shape[1])
  mf = torch.fft.rfft2(m_pad, s=(fft_h, fft_w), dim=(0, 1))

  chunks = []
  for start in range(0, r, 8):
    qf = torch.fft.rfft2(q[start:start + 8].float(), s=(fft_h, fft_w),
                         dim=(1, 2))
    # Correlation <-> conjugate product; contract the feature channel.
    prod = torch.einsum('rxyd,xyd->rxy', qf.conj(), mf)
    corr = torch.fft.irfft2(prod, s=(fft_h, fft_w), dim=(1, 2))
    chunks.append(corr[:, :out_h, :out_w])
  scores = torch.cat(chunks)

  norm = q_valid.sum((-1, -2), keepdim=True).clamp(min=1)
  raw = scores / norm
  if min_overlap is None:
    return raw, raw
  # The valid-count correlation uses the *unpadded* map mask, zero-padded
  # into the same frame as the edge-padded map.
  m_valid_pad = F.pad(m_valid.float(), (wq - 1, wq - 1, hq - 1, hq - 1))
  mvf = torch.fft.rfft2(m_valid_pad, s=(fft_h, fft_w))
  qvf = torch.fft.rfft2(q_valid.float(), s=(fft_h, fft_w))
  num_valid = torch.fft.irfft2(qvf.conj() * mvf[None], s=(fft_h, fft_w))
  num_valid = torch.round(num_valid[:, :out_h, :out_w])
  threshold = min_overlap * hq * wq
  return torch.where(num_valid > threshold, raw, -torch.inf), raw


def exhaustive_pose_voting(
    plane_q: types.FeaturePlane,
    plane_map: types.FeaturePlane,
    num_rotations: int,
    grid_q: grids.Grid2D,
    conf_q: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor]:
  """Batched dense voting: ``(masked, raw)`` volumes ``[B, R, A, B']``.

  ``plane_q`` holds ``[B, Hq, Wq, D]`` features on ``grid_q``; ``plane_map``
  holds ``[B, H, W, D]``. A per-cell weight ``conf_q [B, Hq, Wq]`` scales
  the query's features before the templates are sampled (in the promoted
  dtype, as ``snap_tpu``'s product).
  """
  angles = torch.linspace(0, 2 * math.pi, num_rotations + 1)[:-1]
  features = plane_q.features
  if conf_q is not None:
    features = features * conf_q[..., None]
  templates, t_valid = sample_query_templates(
      features, plane_q.valid, angles, grid_q)
  out = [template_matching_fft(templates[i], t_valid[i],
                               plane_map.features[i], plane_map.valid[i])
         for i in range(templates.shape[0])]
  return (torch.stack([o[0] for o in out]), torch.stack([o[1] for o in out]))


def read_pose_volume(volume: Tensor, index_rab: Tensor,
                     floor_value: float = -1e9) -> Tensor:
  """Trilinearly read ``[R, A, B]`` at continuous ``(r, a, b)`` (r wraps)."""
  num_rot = volume.shape[0]
  volume = torch.clamp(volume, min=floor_value)
  r, ab = index_rab[..., 0], index_rab[..., 1:]
  size = torch.as_tensor(volume.shape[1:], device=volume.device)
  ab = torch.minimum(torch.clamp(ab, min=0), size - 1)
  r0 = torch.floor(r)
  fr = r - r0
  r0 = r0.long()
  ab0 = torch.floor(ab)
  fab = ab - ab0
  ab0 = ab0.long()
  ab1 = torch.minimum(ab0 + 1, size - 1)
  out = 0.0
  for dr, wr in ((r0, 1 - fr), (r0 + 1, fr)):
    for da, wa in ((ab0[..., 0], 1 - fab[..., 0]), (ab1[..., 0], fab[..., 0])):
      for db, wb in ((ab0[..., 1], 1 - fab[..., 1]),
                     (ab1[..., 1], fab[..., 1])):
        out = out + wr * wa * wb * volume[dr % num_rot, da, db]
  return out


def parabolic_peak_offsets(scores: Tensor, idx: Sequence[int]) -> Tensor:
  """Per-axis sub-bin offsets of a score-volume peak (3-point parabola).

  Keeps the reference's quirk: the concavity test uses an absolute epsilon
  (``den < -1e-12``) whatever the scale of the scores.
  """
  idx = [int(i) for i in idx]
  s0 = scores[tuple(idx)]
  offs = []
  for axis in range(scores.ndim):
    n = scores.shape[axis]
    i = idx[axis]

    def take(j):
      at = list(idx)
      at[axis] = min(max(j, 0), n - 1)
      return scores[tuple(at)]

    sm, sp = take(i - 1), take(i + 1)
    den = sm - 2.0 * s0 + sp
    interior = 0 < i < n - 1
    concave = bool(den < -1e-12)
    if interior and concave:
      offs.append(torch.clamp(0.5 * (sm - sp) / den, -0.5, 0.5))
    else:
      offs.append(torch.zeros((), dtype=scores.dtype, device=scores.device))
  return torch.stack(offs)


def offset_to_tfm(angle: Tensor, ab_index: Tensor, grid_q: grids.Grid2D,
                  qgrid_p_q: np.ndarray) -> geometry.Transform2D:
  """(map angle, volume translation index) -> ``map_t_query``."""
  hq, wq = grid_q.extent
  device = ab_index.device
  delta_m = (ab_index - torch.tensor([hq - 1, wq - 1], device=device)
             ) * grid_q.cell_size
  c = torch.as_tensor(grid_q.extent_meters / 2, dtype=torch.float32,
                      device=device)
  rot = geometry.Transform2D(angle=angle, t=torch.zeros_like(delta_m))
  t = delta_m + c - rot.transform(c.expand(delta_m.shape)[..., None, :])[
      ..., 0, :]
  map_t_qgrid = geometry.Transform2D(angle=angle, t=t)
  qgrid_t_q = geometry.Transform2D(
      angle=torch.zeros_like(angle),
      t=torch.as_tensor(qgrid_p_q, dtype=torch.float32,
                        device=device).expand(delta_m.shape))
  return map_t_qgrid @ qgrid_t_q


def exhaustive_index_to_tfm(index: Tensor, grid_q: grids.Grid2D,
                            num_rotations: int, qgrid_p_q: np.ndarray
                            ) -> geometry.Transform2D:
  """Pose-volume index (r, a, b) -> ``map_t_query``."""
  angle = -index[..., 0] * 2 * math.pi / num_rotations
  return offset_to_tfm(angle.float(), index[..., 1:].float(), grid_q,
                       qgrid_p_q)


def exhaustive_tfm_to_index(map_t_q: geometry.Transform2D,
                            grid_q: grids.Grid2D, num_rotations: int,
                            qgrid_p_q: np.ndarray) -> Tensor:
  """Inverse of ``exhaustive_index_to_tfm`` (continuous-valued index)."""
  hq, wq = grid_q.extent
  device = map_t_q.t.device
  qgrid_p = torch.as_tensor(qgrid_p_q, dtype=torch.float32, device=device)
  map_t_qgrid = map_t_q @ geometry.Transform2D(
      angle=torch.zeros_like(map_t_q.angle),
      t=(-qgrid_p).expand(map_t_q.t.shape))
  angle = map_t_qgrid.angle
  r = (-angle / (2 * math.pi) % 1) * num_rotations
  c = torch.as_tensor(grid_q.extent_meters / 2, dtype=torch.float32,
                      device=device)
  rot = geometry.Transform2D(angle=angle, t=torch.zeros_like(map_t_qgrid.t))
  delta_m = map_t_qgrid.t - c + rot.transform(
      c.expand(map_t_qgrid.t.shape)[..., None, :])[..., 0, :]
  ab = delta_m / grid_q.cell_size + torch.tensor([hq - 1, wq - 1],
                                                 device=device)
  return torch.cat([r[..., None], ab], -1)


def dense_refinement(
    plane_q: types.FeaturePlane,
    plane_map: types.FeaturePlane,
    coarse_index: Tensor,
    grid_q: grids.Grid2D,
    num_rotations: int,
    qgrid_p_q: np.ndarray,
    stages: Sequence[Tuple[float, float]] = ((5.0, 0.25),),
    range_p_cells: int = 20,
    subcell: bool = False,
) -> Tuple[geometry.Transform2D, Tensor]:
  """Dense local refinement around coarse pose-volume indices ``[B, 3]``.

  Each (range_deg, delta_deg) stage builds a fan of finely rotated templates
  (K2) around the current angle and correlates them against a map window of
  +-``range_p_cells`` around the current translation (a VALID ``conv2d``
  computed in f32), re-centering on the best. Returns the refined
  ``map_t_query`` ``[B]`` and the last stage's ``[B, R_f, 2P+1, 2P+1]``
  scores.
  """
  hq, wq = grid_q.extent
  b = plane_map.features.shape[0]
  h, w = plane_map.features.shape[1:3]
  p = range_p_cells
  device = plane_map.features.device
  angles_out, ab_out, scores_out = [], [], []
  for i in range(b):
    center_angle = float(coarse_index[i, 0]) * (2 * math.pi / num_rotations)
    ab = [min(max(int(coarse_index[i, 1]), 0), h + hq - 2),
          min(max(int(coarse_index[i, 2]), 0), w + wq - 2)]
    m_pad = _edge_pad2d(plane_map.features[i], hq - 1 + p, wq - 1 + p)
    scores = None
    for range_deg, delta_deg in stages:
      num_fine = int(round(2 * range_deg / delta_deg)) + 1
      deltas = torch.deg2rad(torch.linspace(-range_deg, range_deg, num_fine))
      template_angles = center_angle - deltas
      templates, t_valid = sample_query_templates(
          plane_q.features[i:i + 1], plane_q.valid[i:i + 1],
          template_angles, grid_q)
      templates, t_valid = templates[0], t_valid[0]
      start = [min(max(ab[0], 0), h + hq - 2), min(max(ab[1], 0), w + wq - 2)]
      crop = m_pad[start[0]:start[0] + hq + 2 * p,
                   start[1]:start[1] + wq + 2 * p]
      # [1, D, Hq+2P, Wq+2P] x [Rf, D, Hq, Wq] -> [Rf, 2P+1, 2P+1], in f32
      # (the reference accumulates bf16 operands in f32).
      scores = F.conv2d(crop.permute(2, 0, 1)[None].float(),
                        templates.permute(0, 3, 1, 2).float())[0]
      scores = scores / t_valid.sum((-1, -2))[:, None, None].clamp(min=1)
      flat_best = int(torch.argmax(scores.reshape(-1)))
      fr, fa, fb = np.unravel_index(flat_best, tuple(scores.shape))
      center_angle = float(template_angles[fr])
      ab = [start[0] + int(fa) - p, start[1] + int(fb) - p]
    ab_t = torch.tensor(ab, dtype=torch.float32, device=device)
    angle = torch.tensor(center_angle, dtype=torch.float32, device=device)
    if subcell:
      off = parabolic_peak_offsets(scores, (fr, fa, fb))
      angle = angle - off[0] * math.radians(stages[-1][1])
      ab_t = ab_t + off[1:]
    angles_out.append(-angle)
    ab_out.append(ab_t)
    scores_out.append(scores)
  tfm = offset_to_tfm(torch.stack(angles_out), torch.stack(ab_out), grid_q,
                      qgrid_p_q)
  return tfm, torch.stack(scores_out)
