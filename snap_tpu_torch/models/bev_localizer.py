"""Estimate the 3-DoF pose of a query view against a neural map.

Port of ``snap_tpu/models/bev_localizer.py`` with both pose backends. The
map and the query (on a gravity-aligned frustum grid) go through the same
BEV mapper, or the query through a street-view mapper of its own
(``bev_mapper_query``: a map without street views, as the aerial-only
neural map); then

- ``pose_backend='exhaustive'``: the dense (rotation x translation) pose
  volume is voted by FFT correlation and its argmax refined over a fan of
  fine angles;
- ``pose_backend='ransac'`` (the reference's default): every query point is
  correlated with every map cell, pose hypotheses are drawn from the
  resulting match PDF, scored by bilinear reads of the per-point score maps
  (B4, ``models/pose_estimation.py``), and the best is refined on a dense
  offset lattice.

``loss_metrics_function`` gives the loss (InfoNCE of the GT pose's score
against the volume, or against the sampled poses' scores) and the recall
metrics.

With ``add_confidence_query`` the mappers get a confidence head (where the
query has a mapper of its own, the map's is built, as the reference's, and
takes no gradient), and the query's per-cell confidence weights its points:
on the sampled path by its masked softmax over the valid points, in place
of the division by their count; on the dense path, as ``exp`` of the
log-probability, the features the templates are sampled from (the dense
refinement keeps the unweighted plane, as the reference does: ROADMAP C23).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F

from snap_tpu_torch import configs
from snap_tpu_torch.models import bev_mapper
from snap_tpu_torch.models import layers
from snap_tpu_torch.models import pose_estimation
from snap_tpu_torch.models import pose_exhaustive_voting as pev
from snap_tpu_torch.utils import geometry
from snap_tpu_torch.utils import grids

Tensor = torch.Tensor


def build_query_frustum_grid(
    cell_size: float,
    depth: float,
    filter_points_in_fov: bool = False,
    hfov_deg: Optional[float] = None,
) -> Tuple[grids.Grid2D, np.ndarray, np.ndarray]:
  """Gravity-aligned grid bounding the query camera frustum (numpy)."""
  width = 3 * depth // 2  # Coarse approximation of the 72 deg HFoV.
  grid = grids.Grid2D.from_extent_meters((width, depth), cell_size)
  grid_p_view = np.array([width / 2, 0.0])
  idx = np.moveaxis(np.mgrid[:grid.extent[0], :grid.extent[1]], 0, -1)
  q_xy_p = (idx + 0.5) * cell_size - grid_p_view
  if filter_points_in_fov:
    angle = np.arctan2(q_xy_p[..., 0], q_xy_p[..., 1])
    q_xy_p = q_xy_p[np.abs(angle) < np.deg2rad(hfov_deg / 2)][:, None]
  return grid, grid_p_view, q_xy_p.astype(np.float32)


def dense_top1_correct(best_idx: Tensor, gt_idx: Tensor,
                       num_rotations: int) -> Tensor:
  """Coarse argmax within one cell and one (wrapping) rotation bin of GT."""
  d_rot = torch.abs(best_idx[..., 0] - gt_idx[..., 0])
  d_rot = torch.minimum(d_rot, num_rotations - d_rot)
  d_ab = torch.abs(best_idx[..., 1:] - gt_idx[..., 1:])
  return (d_rot <= 1) & (d_ab <= 1).all(-1)


class BEVLocalizer(nn.Module):
  """Pose estimation between an overlapping (map, query) scene pair."""

  def __init__(self, config: configs.BEVLocalizerConfig,
               grid_map: grids.Grid2D, streetview_hfov_deg: float = 72.0,
               dtype: torch.dtype = torch.float32,
               semantic_map_classes: Optional[Sequence[str]] = None):
    super().__init__()
    if config.pose_backend not in ('exhaustive', 'ransac'):
      raise ValueError(f'Unknown pose_backend {config.pose_backend!r}')
    if config.pose_backend == 'exhaustive' and config.filter_points_in_fov:
      raise ValueError('The exhaustive backend needs the dense query grid '
                       '(filter_points_in_fov=False).')
    if config.add_confidence_map:
      # As the reference (``bev_localizer.py:104-105``).
      raise NotImplementedError('Map confidence is not yet supported.')
    self.config = config
    self.grid_map = grid_map
    self.grid_query, self.qgrid_p_q, self.q_xy_p = build_query_frustum_grid(
        grid_map.cell_size, config.query_frustum_depth,
        config.filter_points_in_fov, streetview_hfov_deg)
    confidence = dict(add_confidence=True) if (
        config.add_confidence_query) else {}
    self.bev_mapper = bev_mapper.BEVMapper(
        dataclasses.replace(config.bev_mapper, **confidence), grid_map, dtype,
        semantic_map_classes)
    self.bev_mapper_query = None
    if config.bev_mapper_query is not None:
      self.bev_mapper_query = bev_mapper.BEVMapper(
          dataclasses.replace(config.bev_mapper_query, **confidence),
          grid_map, dtype, semantic_map_classes)
    if config.add_temperature:
      self.temperature = nn.Parameter(
          torch.tensor(config.init_temperature, dtype=torch.float32))

  @property
  def query_mapper(self) -> bev_mapper.BEVMapper:
    """The mapper the query goes through."""
    return self.bev_mapper_query or self.bev_mapper

  def sample_draws(self, batch_size: int, generator: torch.Generator,
                   device: torch.device) -> bev_mapper.TrainDraws:
    """The query's z jitter, drawn by the query's mapper's config, then
    the map's modality dropout, by the map's."""
    return bev_mapper.TrainDraws(
        z_jitter=self.query_mapper.sample_z_jitter(batch_size, generator,
                                                   device),
        modality_keep=self.bev_mapper.sample_modality_keep(
            batch_size, generator, device))

  def forward(self, data: Dict[str, Any], train: bool = False,
              generator: Optional[torch.Generator] = None,
              draws: Optional[bev_mapper.TrainDraws] = None,
              pose_samples: Optional[geometry.Transform2D] = None,
              batch_rows: Optional[Tuple[int, int]] = None
              ) -> Dict[str, Any]:
    """Localize the query in the map. With ``train``, the mapper's z jitter
    and modality dropout apply, from ``draws`` or else drawn on
    ``generator`` (a CPU ``torch.Generator``). The RANSAC backend draws its
    ``[B, num_pose_samples]`` pose hypotheses on ``generator`` too, unless
    they are given as ``pose_samples``; with ``batch_rows`` = (first, size)
    the batch is rows ``first ..`` of a global batch of ``size`` (a rank's
    block), and they are drawn for the global batch and these rows
    taken."""
    query = data['query']
    batch = query['images'].shape[0]
    device = query['images'].device
    q_xy_p = torch.as_tensor(self.q_xy_p, device=device)
    if train and draws is None:
      if generator is None:
        raise ValueError('train=True needs a generator or draws')
      draws = self.sample_draws(batch, generator, device)
    pred: Dict[str, Any] = {'draws': draws}
    pred['map'] = self.bev_mapper(data['map'], train=train, draws=draws)
    pred['query'] = self.query_mapper(
        dict(query, xy_bev=q_xy_p[None].expand(batch, *q_xy_p.shape)),
        train=train, is_query=True, draws=draws)
    m_t_q_gt = data.get('T_query2map')
    if isinstance(m_t_q_gt, geometry.Transform3D):
      m_t_q_gt = geometry.Transform2D.from_Transform3D(m_t_q_gt)
    plane_q, plane_map = pred['query']['bev_matching'], pred['map'][
        'bev_matching']
    conf_q = pred['query'].get('bev_confidence')
    if self.config.pose_backend == 'exhaustive':
      pred.update(self._poses_exhaustive(plane_q, plane_map, m_t_q_gt,
                                         conf_q))
      return pred
    pred.update(self._poses_sampled(plane_q, plane_map, q_xy_p, m_t_q_gt,
                                    generator, pose_samples, conf_q,
                                    batch_rows))
    return pred

  def _point_scores(self, plane_q, plane_map, conf_q=None
                    ) -> Tuple[Tensor, Tensor, Tensor]:
    """The dense point-vs-map similarity ``sim_points [B, N, H, W]`` f32
    (clipped, scaled by the temperature, divided by the valid count, or
    weighted by the masked softmax of the query's confidence ``conf_q``),
    its match PDF ``prob_points`` (softmax over the map, divided or
    weighted likewise; no gradient, as JAX's ``stop_gradient`` before the
    draws) and the query points' validity ``[B, N]``."""
    b = plane_map.features.shape[0]
    valid_points = plane_q.valid.reshape(b, -1)
    f_p_q = plane_q.features.reshape(b, -1, plane_q.features.shape[-1])
    # A plain product, left to cuBLAS as the JAX package leaves it to XLA.
    sim = torch.einsum('bnd,bijd->bnij', f_p_q, plane_map.features)
    if self.config.clip_negative_scores:
      sim = F.relu(sim)
    sim = sim.float()
    if self.config.add_temperature:
      sim = sim * torch.exp(self.temperature)
    # Off the autograd graph: the softmax would keep its [B, N, H, W]
    # output for a backward that nothing takes.
    flat = sim.detach().reshape(*sim.shape[:2], -1)
    prob = torch.softmax(flat, -1).reshape(sim.shape)
    if conf_q is not None:
      weights = layers.masked_softmax(conf_q.reshape(b, -1), valid_points,
                                      -1)[..., None, None]
      return sim * weights, prob * weights.detach(), valid_points
    num_valid = valid_points.sum(-1).clamp(min=1)[:, None, None, None]
    return sim / num_valid, prob / num_valid, valid_points

  def _poses_sampled(self, plane_q, plane_map, q_xy_p, m_t_q_gt, generator,
                     pose_samples, conf_q=None, batch_rows=None
                     ) -> Dict[str, Any]:
    """PDF-RANSAC hypotheses, B4 scoring, the best refined on a lattice."""
    out: Dict[str, Any] = {}
    b = plane_map.features.shape[0]
    q_xy_p = q_xy_p.reshape(-1, 2)[None].expand(b, -1, 2).contiguous()
    sim, prob, valid_points = self._point_scores(plane_q, plane_map, conf_q)
    if pose_samples is None:
      if generator is None:
        raise ValueError('the RANSAC backend needs a generator for its '
                         'pose samples, or pose_samples')
      pose_samples = pose_estimation.sample_transforms_ransac(
          prob, q_xy_p, self.config.num_pose_samples,
          self.config.num_pose_sampling_retries, self.grid_map, generator,
          batch_rows=batch_rows)
    del prob
    m_t_q = pose_samples
    if m_t_q_gt is not None:
      m_t_q = geometry.Transform2D.cat([m_t_q_gt.unsqueeze(-1), m_t_q])
    out['map_t_query_samples'] = m_t_q
    out['scores_poses'] = scores = pose_estimation.pose_scoring_many(
        m_t_q, sim, q_xy_p, valid_points, plane_map.valid, self.grid_map,
        self.config.mask_score_out_of_bounds)
    # The GT pose (index 0, if present) only takes part in the loss.
    start = int(m_t_q_gt is not None)
    out['best_index'] = best = torch.argmax(scores[:, start:], -1)
    out['map_t_query'] = m_t_q[:, start:].take(best)
    if self.config.do_grid_refinement:
      out['map_t_query_ransac'] = out['map_t_query']
      out['map_t_query'], out['scores_grid_refine'] = (
          pose_estimation.grid_refinement(
              out['map_t_query'], sim, q_xy_p, valid_points, plane_map.valid,
              self.grid_map, self.config.mask_score_out_of_bounds))
    return out

  def _poses_exhaustive(self, plane_q, plane_map, m_t_q_gt, conf_q=None
                        ) -> Dict[str, Any]:
    """Dense translation x rotation voting (the templates from the query's
    features weighted by ``exp(conf_q)`` when given), argmax, fine
    refinement (on the unweighted plane, ROADMAP C23)."""
    out: Dict[str, Any] = {}
    num_rot = self.config.num_rotations
    hq, wq = self.grid_query.extent
    b = plane_map.features.shape[0]
    plane_q = type(plane_q)(
        features=plane_q.features.reshape(b, hq, wq, -1),
        valid=plane_q.valid.reshape(b, hq, wq))
    if conf_q is not None:
      conf_q = torch.exp(conf_q.reshape(b, hq, wq))
    volume, volume_raw = pev.exhaustive_pose_voting(
        plane_q, plane_map, num_rot, self.grid_query, conf_q)
    if self.config.add_temperature:
      # Scale the raw (finite) volume and re-apply the mask: -inf times the
      # learned scale would poison the temperature's gradient (0 * inf).
      scale = torch.exp(self.temperature)
      volume_raw = volume_raw * scale
      volume = torch.where(torch.isfinite(volume), volume_raw, -torch.inf)
    out['scores_pose_volume'] = volume
    flat = volume.reshape(b, -1)
    best = torch.argmax(flat, dim=-1)
    best_idx = torch.stack(torch.unravel_index(best, volume.shape[1:]), -1)
    best_score = flat.gather(1, best[:, None])[:, 0]
    out['best_volume_index'] = best_idx

    if self.config.do_grid_refinement:
      m_t_q_best, fine_scores = pev.dense_refinement(
          plane_q, plane_map, best_idx, self.grid_query, num_rot,
          self.qgrid_p_q, stages=self.config.dense_refinement_stages,
          subcell=self.config.subcell_refinement)
      if self.config.add_temperature:
        fine_scores = fine_scores * torch.exp(self.temperature)
      out['scores_grid_refine'] = fine_scores
      best_score = fine_scores.reshape(b, -1).amax(-1)
    else:
      m_t_q_best = pev.exhaustive_index_to_tfm(
          best_idx, self.grid_query, num_rot, self.qgrid_p_q)
    out['map_t_query'] = m_t_q_best

    if m_t_q_gt is not None:
      gt_idx = pev.exhaustive_tfm_to_index(
          m_t_q_gt, self.grid_query, num_rot, self.qgrid_p_q)
      # Read the GT from the *unmasked* volume.
      gt_score = torch.stack([pev.read_pose_volume(volume_raw[i], gt_idx[i])
                              for i in range(b)])
      out['scores_poses'] = torch.stack([gt_score, best_score], -1)
      out['top1_coarse_correct'] = dense_top1_correct(
          best_idx, gt_idx, num_rot)
    else:
      out['scores_poses'] = best_score[:, None]
    return out

  def loss_metrics_function(self, pred: Dict[str, Any], data: Dict[str, Any]
                            ) -> Tuple[Dict[str, Tensor], Dict[str, Tensor]]:
    """Per-example losses and metrics (``BEVLocalizerModel``'s).

    The loss is InfoNCE. Dense path: ``logsumexp`` over the masked pose
    volume minus the GT pose's score read from the unmasked one. Sampled
    path: ``-log_softmax`` of the GT pose's score (index 0) among the
    sampled poses' scores, without the samples that lie within
    ``threshold_remove_accurate_poses`` of the GT. Metrics: position and
    rotation error of ``map_t_query``, top-1 (dense: the coarse argmax
    within one cell and bin of the GT; sampled: the GT pose scores best),
    the recalls at 0.5, 1, 2 and 5 m / deg, the temperature parameter and,
    sampled only, the share of samples within (0.5 m, 1 deg), (1 m, 2 deg)
    and (2 m, 4 deg) of the GT.
    """
    scores = pred['scores_poses']
    m_t_q_gt = data['T_query2map']
    if isinstance(m_t_q_gt, geometry.Transform3D):
      m_t_q_gt = geometry.Transform2D.from_Transform3D(m_t_q_gt)
    dense = 'scores_pose_volume' in pred
    if dense:
      volume = pred['scores_pose_volume']
      flat = torch.where(torch.isfinite(volume), volume, -torch.inf)
      flat = flat.reshape(volume.shape[0], -1)
      nll = torch.logsumexp(flat, -1) - scores[..., 0]
    else:
      samples_t_gt = (pred['map_t_query_samples'].inv
                      @ m_t_q_gt.unsqueeze(-1))
      dr_samples, dt_samples = samples_t_gt.magnitude()
      threshold = self.config.threshold_remove_accurate_poses
      if threshold is not None:
        remove = (dr_samples < threshold[0]) & (dt_samples < threshold[1])
        remove[..., 0] = False  # Keep the GT pose score.
        scores = torch.where(remove, -torch.inf, scores)
      nll = -torch.log_softmax(scores, -1)[..., 0]
    losses = {'localization/nll': nll, 'total': nll}
    dr, dt = (pred['map_t_query'].inv @ m_t_q_gt).magnitude()
    top1 = (pred['top1_coarse_correct'] if dense
            else torch.argmax(pred['scores_poses'], -1) == 0)
    metrics = {
        'loc/err_max_position': dt,
        'loc/err_max_rotation': dr,
        'loc/recall_top1': top1,
    }
    for t in [0.5, 1, 2, 5]:
      metrics[f'loc/recall_max_{t}m'] = dt < t
      metrics[f'loc/recall_max_{t}deg'] = dr < t
    if self.config.add_temperature:
      metrics['loc/temperature'] = self.temperature.detach().expand(
          nll.shape)
    if not dense:
      for dt_thresh, dr_thresh in [(0.5, 1), (1, 2), (2, 4)]:
        recall = (dr_samples < dr_thresh) & (dt_samples < dt_thresh)
        metrics[f'loc/recall_samples_{dt_thresh}m_{dr_thresh}deg'] = (
            recall[..., 1:].float().mean(-1))  # exclude the GT pose
    return losses, metrics


def build(config: configs.BEVLocalizerConfig, meta_data: Dict[str, Any],
          dtype: torch.dtype) -> BEVLocalizer:
  """The registry's builder (``BEVLocalizerModel.build_flax_model``)."""
  return BEVLocalizer(config, meta_data['grid'].bev(), dtype=dtype,
                      semantic_map_classes=meta_data['semantic_map_classes'])
