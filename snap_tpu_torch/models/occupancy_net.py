"""3D occupancy prediction supervised by lidar rays.

Port of ``snap_tpu/models/occupancy_net.py``. On each ray, the hit point is
sampled as occupied and ``num_samples_per_ray - 1`` points in front of it
as free; the street-view encoder's feature volume over the scene grid
(lifted by K1) is read trilinearly at the samples and decoded to logits by
an MLP; the loss is a class-balanced binary cross-entropy over the samples
that at least one view sees.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, Optional

import torch
from torch import nn
import torch.nn.functional as F

from snap_tpu_torch import configs
from snap_tpu_torch.models import base
from snap_tpu_torch.models import bev_mapper
from snap_tpu_torch.models import layers
from snap_tpu_torch.models import streetview_encoder
from snap_tpu_torch.models import types
from snap_tpu_torch.utils import grids

Tensor = torch.Tensor


def sample_queries_from_rays(hits: Tensor, origins: Tensor, valid: Tensor,
                             num_samples: int, margin: float
                             ) -> types.LidarRaySamples:
  """1 occupied hit + (num_samples - 1) free-space points per ray, as the
  reference samples them (the distance clipped at 1 m below, the free
  points at ``linspace(0, 1, num_samples - 1)`` of the way to ``margin``
  before the hit). The ray axis is -2 of ``hits`` / ``origins``; the
  samples come sample-major, ``[..., num_samples * R]``."""
  hits = hits[..., None, :, :]  # add the sample axis
  origins = origins[..., None, :, :]
  direction = hits - origins
  distance = torch.linalg.norm(direction, dim=-1, keepdim=True)
  direction = direction * ((distance - margin) / distance.clamp(min=1))
  num_neg = num_samples - 1
  steps = torch.linspace(0, 1, num_neg, device=hits.device)
  samples_neg = steps[:, None, None] * direction + origins
  samples = torch.cat([hits, samples_neg], -3)
  labels = torch.zeros(samples.shape[:-1], dtype=torch.bool,
                       device=hits.device)
  labels[..., 0, :] = True
  valid = valid[..., None, :].expand(samples.shape[:-1])
  batch = samples.shape[:-3]
  return types.LidarRaySamples(points=samples.reshape(*batch, -1, 3),
                               labels=labels.reshape(*batch, -1),
                               valid=valid.reshape(*batch, -1))


class OccupancyNet(nn.Module):
  """Per-point occupancy from the multi-view feature volume."""

  def __init__(self, config: configs.OccupancyNetConfig, grid: grids.Grid3D,
               dtype: torch.dtype = torch.float32):
    super().__init__()
    self.config = config
    self.grid = grid
    self.streetview_encoder = streetview_encoder.StreetViewEncoder(
        config.streetview_encoder, dtype)
    self.mlp_out = layers.MLP(
        config.occupancy_mlp,
        self.streetview_encoder.config.fusion.layers[-1], dtype)

  def sample_draws(self, batch_size: int, generator: torch.Generator,
                   device: torch.device) -> bev_mapper.TrainDraws:
    """Nothing random: the head's forward is the same in training."""
    del batch_size, generator, device
    return bev_mapper.TrainDraws(z_jitter=None, modality_keep=None)

  def forward(self, data: base.Batch, train: bool = False,
              generator: Optional[torch.Generator] = None,
              draws: Optional[bev_mapper.TrainDraws] = None
              ) -> base.Predictions:
    del generator
    if 'map' in data:
      data = data['map']
    device = data['images'].device
    xyz = self.grid.index_to_xyz(self.grid.grid_index(device))
    xyz = xyz[None].expand(data['images'].shape[0], *xyz.shape)
    # Exact when the whole encoder is frozen (``streetview_encoder/``):
    # only the MLP takes a gradient.
    with (torch.no_grad() if self.config.stop_encoder_gradients
          else contextlib.nullcontext()):
      pred = self.streetview_encoder(dict(data, xyz_query=xyz))
    pred['draws'] = draws
    volume = pred['feature_volume']
    queries = data.get('occupancy_queries')
    if queries is None:
      if 'lidar_rays' not in data:
        raise ValueError('No points or rays given in the data dict.')
      rays = data['lidar_rays']
      pred['ray_samples'] = samples = sample_queries_from_rays(
          rays['points'], rays['origins'], rays['mask'],
          self.config.num_samples_per_ray, self.config.ray_margin)
      queries = samples.points
    # Trilinear reads of each example's volume at the query points.
    features, valid = grids.interpolate_nd_batched(
        volume.features, queries / self.grid.cell_size, volume.valid)
    logits = self.mlp_out(features).squeeze(-1).float()
    pred['occupancy'] = types.OccupancySamples(
        values=torch.sigmoid(logits), valid=valid, logits=logits)
    return pred

  def loss_metrics_function(self, pred: base.Predictions, data: base.Batch
                            ) -> base.LossMetricsTuple:
    """The mean of the BCE over the occupied and over the free samples
    that some view sees, and the accuracy, the recall of the occupied and
    that of the free samples (``occupancy/precision``, the reference's
    name for the true-negative rate)."""
    del data
    labels = pred['ray_samples'].labels
    logits = pred['occupancy'].logits
    mask = pred['occupancy'].valid & pred['ray_samples'].valid
    bce = -torch.where(labels, F.logsigmoid(logits), F.logsigmoid(-logits))
    bce_pos = layers.masked_mean(bce, mask & labels, 1)
    bce_neg = layers.masked_mean(bce, mask & ~labels, 1)
    bce = (bce_pos + bce_neg) / 2
    correct = (logits > 0) == labels
    metrics = {
        'occupancy/accuracy': layers.masked_mean(correct, mask, 1),
        'occupancy/recall': layers.masked_mean(correct, mask & labels, 1),
        'occupancy/precision': layers.masked_mean(correct, mask & ~labels,
                                                  1),
    }
    return {'occupancy_bce': bce, 'total': bce}, metrics


def build(config: configs.OccupancyNetConfig, meta_data: Dict[str, Any],
          dtype: torch.dtype) -> OccupancyNet:
  """The registry's builder (``OccupancyNetModel.build_flax_model``)."""
  return OccupancyNet(config, meta_data['grid'], dtype)
