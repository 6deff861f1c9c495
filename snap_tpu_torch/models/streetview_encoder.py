"""Lift a rig of posed images into a 3D feature volume at query points.

Port of ``snap_tpu/models/streetview_encoder.py`` on its streamed path
(``pooling_impl='stream'``, ``do_weighted_fusion=True``): views folded into
the batch for the image encoder, one linear layer emitting 128 features +
32 log-depth-bin scores (``proj_mlp``), the top-k streamed lift (K1), and
the fusion MLP over the pooled statistics.

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
from snap_tpu_torch.ops import view_scan
from snap_tpu_torch.train_lib import checkpoints

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
    if config.pooling_impl != 'stream' or not config.do_weighted_fusion:
      raise NotImplementedError(
          'The port implements the streamed, score-weighted lift only '
          f'(pooling_impl={config.pooling_impl!r}, '
          f'do_weighted_fusion={config.do_weighted_fusion}): the lift\'s '
          'other forms are A14, item 5.')
    if config.fusion_add_minmax or not config.fusion_use_variance:
      raise NotImplementedError(
          'The port pools (mean, variance, max score) only: the other '
          'statistics are A14, item 5 (B8).')
    self.config = config
    self.dtype = dtype
    self.image_encoder = image_encoder.ImageEncoder(
        config.image_encoder, dtype)
    dim, bins = config.feature_dim, config.num_scale_bins
    # One linear layer emits the features and the per-depth-bin scores.
    self.proj_mlp = layers.MLP(
        dataclasses.replace(config.proj_mlp, layers=(dim + bins,)),
        config.image_encoder.output_dim, dtype)
    self.fusion_mlp = layers.MLP(config.fusion, 2 * dim + 1, dtype)

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
    f_images = self.proj_mlp(f_images)
    dim = self.config.feature_dim
    xyz = data['xyz_query']  # [B, *grid_shape, 3]
    out = view_scan.pool_views_stream(
        f_images[..., :dim], f_images[..., dim:], data['T_view2scene'],
        cameras, xyz.reshape(xyz.shape[0], -1, 3),
        top_k=self.config.top_k_view_selection or 0,
        depth_min_max=tuple(self.config.depth_min_max))
    valid = out.valid
    if self.config.max_view_distance is not None:
      valid = valid & (out.min_distance <= self.config.max_view_distance)
    f_grid = self.fusion_mlp(out.stats.to(self.dtype))
    f_grid = torch.where(valid[..., None], f_grid, 0)
    grid_shape = (-1, *xyz.shape[-4:-1])
    return {
        'image_feature_pyramid': f_image_pyr,
        'scores_images': f_images[..., dim:],
        'feature_volume': types.FeatureVolume(
            features=f_grid.reshape(*grid_shape, f_grid.shape[-1]),
            valid=valid.reshape(grid_shape)),
    }

  def load_pretrained_variables(self) -> Optional[Dict[str, Tensor]]:
    """The ``streetview_encoder`` parameters of the experiment workdir
    ``config.pretrained_path`` (``:227-237``), named relative to this
    module. None without a path."""
    path = self.config.pretrained_path
    if path is None:
      return None
    return checkpoints.load_subtree(self, path, 'streetview_encoder')
