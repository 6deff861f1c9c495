"""Lift a rig of posed images into a 3D feature volume at query points.

Port of ``snap_tpu/models/streetview_encoder.py``: views folded into the
batch for the image encoder; with weighted fusion, one linear layer
emitting the features and the log-depth-bin scores (``proj_mlp``); the
lift in the form the config names (``pooling_impl``): streamed over the
top-k views or scanned over every view (``ops/view_scan.py``, K1 and K3),
or the gather form of the per-observation features
(``ops/view_fusion.py``), which a depth MLP (``depth_mlp``, unweighted
fusion only) always takes; the statistics ``[mean, var?, max?, min?,
score_max?]`` (``fusion_use_variance``, ``fusion_add_minmax``, weighted
or not); and the fusion MLP over them.

Its own warm start (the occupancy head's adoption path): with a
``pretrained_path``, the encoder takes the config of the experiment there
("export wins", ``merged_config``) and ``load_pretrained_variables`` gives
its ``streetview_encoder`` subtree.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import Any, Dict, Optional

import torch
from torch import nn

from snap_tpu_torch import configs
from snap_tpu_torch.models import image_encoder
from snap_tpu_torch.models import layers
from snap_tpu_torch.models import types
from snap_tpu_torch.ops import kernels
from snap_tpu_torch.ops import view_fusion
from snap_tpu_torch.ops import view_scan
from snap_tpu_torch.train_lib import checkpoints
from snap_tpu_torch.utils import geometry

Tensor = torch.Tensor


def merged_config(config: configs.StreetViewEncoderConfig
                  ) -> configs.StreetViewEncoderConfig:
  """``config``, or with a ``pretrained_path`` the street-view encoder's
  config of the experiment there (its ``config.json``, under
  ``model.bev_mapper``): "export wins", so the adopted weights fit
  (``snap_tpu/models/streetview_encoder.py:41-61``). ``pretrained_path``
  stays this config's: the export's own is None (its run warm-started the
  whole mapper), and taking it would silently skip the adoption."""
  workdir = config.pretrained_path
  if workdir is None:
    return config
  record = json.loads((pathlib.Path(workdir) / 'config.json').read_text())
  exported = configs.streetview_encoder_from_reference(
      record['model']['bev_mapper']['streetview_encoder'])
  return dataclasses.replace(exported, pretrained_path=workdir)


class StreetViewEncoder(nn.Module):
  """Encode a set of posed images into a 3D feature grid."""

  def __init__(self, config: configs.StreetViewEncoderConfig,
               dtype: torch.dtype):
    super().__init__()
    config = merged_config(config)
    self.config = config
    self.dtype = dtype
    self.image_encoder = image_encoder.ImageEncoder(
        config.image_encoder, dtype)
    dim = config.image_encoder.output_dim
    self.proj_mlp = self.depth_mlp = None
    if config.do_weighted_fusion:
      # One linear layer emits the features and the per-depth-bin scores.
      self.proj_mlp = layers.MLP(
          dataclasses.replace(config.proj_mlp, layers=(
              config.feature_dim + config.num_scale_bins,)), dim, dtype)
      dim = config.feature_dim
    elif config.depth_mlp is not None:
      # Over [features, log10 depth, ray], added to the features.
      self.depth_mlp = layers.MLP(config.depth_mlp, dim + 4, dtype)
    self.fusion_mlp = layers.MLP(config.fusion, kernels.stats_width(
        dim, config.do_weighted_fusion, config.fusion_use_variance,
        config.fusion_add_minmax), dtype)

  def encode_images(self, images: Tensor) -> types.FeatureImagePyramid:
    """Run the image encoder with views folded into the batch axis."""
    b, v = images.shape[:2]
    pyr = self.image_encoder(images.reshape(b * v, *images.shape[2:]))
    features = [f.reshape(b, v, *f.shape[1:]) for f in pyr.features]
    return types.FeatureImagePyramid(features=features, strides=pyr.strides)

  def forward(self, data: Dict[str, Any]) -> Dict[str, Any]:
    f_image_pyr = self.encode_images(data['images'].to(self.dtype))
    f_images = f_image_pyr.features[-1]  # [B, V, h, w, C], finest level
    stride_i, stride_j = f_image_pyr.strides[-1]
    # Cameras are expressed in (x, y); strides are (i, j) = (row, col).
    scale = torch.tensor([1.0 / stride_j, 1.0 / stride_i],
                         device=f_images.device)
    cameras = data['camera'].scale(scale)
    pred: Dict[str, Any] = {'image_feature_pyramid': f_image_pyr}
    if self.proj_mlp is not None:
      f_images = self.proj_mlp(f_images)
      pred['scores_images'] = f_images[..., self.config.feature_dim:]
    xyz = data['xyz_query']  # [B, *grid_shape, 3]
    xyz_flat = xyz.reshape(xyz.shape[0], -1, 3)
    if (self.config.pooling_impl in ('stream', 'scan')
        and self.config.depth_mlp is None):
      stats, valid = self._lift(f_images, cameras, data['T_view2scene'],
                                xyz_flat)
    else:
      stats, valid = self._gather(f_images, cameras, data['T_view2scene'],
                                  xyz_flat)
    f_grid = self.fusion_mlp(stats.to(self.dtype))
    f_grid = torch.where(valid[..., None], f_grid, 0)
    grid_shape = (-1, *xyz.shape[-4:-1])
    pred['feature_volume'] = types.FeatureVolume(
        features=f_grid.reshape(*grid_shape, f_grid.shape[-1]),
        valid=valid.reshape(grid_shape))
    return pred

  def _lift(self, f_images: Tensor, cameras: geometry.Camera,
            scene_t_view: geometry.Transform3D, xyz: Tensor):
    """The streamed or scanned lift (K1, K3): pooled stats, and valid within
    ``max_view_distance`` of the nearest visible view."""
    config = self.config
    score_maps = None
    if config.do_weighted_fusion:
      dim = config.feature_dim
      f_images, score_maps = f_images[..., :dim], f_images[..., dim:]
    lift = (view_scan.pool_views_stream if config.pooling_impl == 'stream'
            else view_scan.pool_views_scan)
    out = lift(f_images, score_maps, scene_t_view, cameras, xyz,
               top_k=config.top_k_view_selection or 0,
               depth_min_max=tuple(config.depth_min_max),
               add_minmax=config.fusion_add_minmax,
               use_variance=config.fusion_use_variance)
    valid = out.valid
    if config.max_view_distance is not None:
      valid = valid & (out.min_distance <= config.max_view_distance)
    return out.stats, valid

  def _gather(self, f_images: Tensor, cameras: geometry.Camera,
              scene_t_view: geometry.Transform3D, xyz: Tensor):
    """The gather form (``snap_tpu/models/streetview_encoder.py:123-170``):
    the ``[B, N, K, D]`` observations of the top-k views (of every view
    when there are no more than k: then no distance is known and
    ``max_view_distance`` is not applied, ROADMAP C25), the depth MLP's
    residual (unweighted only: weighted fusion never applies it, C24),
    then the masked statistics."""
    config = self.config
    p2d, visible, depth, rays = view_fusion.project_points_to_views(
        scene_t_view, cameras, xyz)
    k = config.top_k_view_selection
    min_distance = None
    if k and f_images.shape[1] > k:
      view_indices, min_distance = view_fusion.view_selection(
          xyz, scene_t_view, visible, k)
      p2d, visible, depth, rays = (
          view_fusion.gather_observations(x, view_indices)
          for x in (p2d, visible, depth, rays))
      f_proj = view_fusion.interpolate_views_selective(f_images, p2d,
                                                       view_indices)
    else:
      f_proj = view_fusion.interpolate_views_all(f_images, p2d)
    scores = None
    if config.do_weighted_fusion:
      dim = config.feature_dim
      f_proj, score_scales = f_proj[..., :dim], f_proj[..., dim:]
      scores = view_fusion.interpolate_depth_score(
          score_scales, depth, tuple(config.depth_min_max))
    elif self.depth_mlp is not None:
      log_depth = torch.log10(depth.clamp(0.1, 100))
      rays = torch.where(visible[..., None], rays, 0)
      f_proj = f_proj + self.depth_mlp(torch.cat(
          [f_proj, log_depth[..., None].to(f_proj.dtype),
           rays.to(f_proj.dtype)], -1))
    stats, valid = view_fusion.pool_multiview_features(
        f_proj, visible, scores, config.fusion_add_minmax,
        config.fusion_use_variance)
    if config.max_view_distance is not None and min_distance is not None:
      valid = valid & (min_distance <= config.max_view_distance)
    return stats, valid

  def load_pretrained_variables(self) -> Optional[Dict[str, Tensor]]:
    """The ``streetview_encoder`` parameters of the experiment workdir
    ``config.pretrained_path`` (``:227-237``), named relative to this
    module. None without a path."""
    path = self.config.pretrained_path
    if path is None:
      return None
    return checkpoints.load_subtree(self, path, 'streetview_encoder')
