"""Encode boolean semantic map rasters into a neural map.

Port of ``snap_tpu/models/semantic_raster_encoder.py``. The mutually
exclusive "surfel road" classes become one multiclass embedding (the first
class present, through an argmax); each other class gets a 2-way
(absent/present) embedding, at index ``2 * i + raster`` as the reference
has it. The embeddings, concatenated, go through a stride-1 ResNet + FPN
(an R26 x2 at full width: 24 input channels, 56.7M parameters).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from snap_tpu_torch import configs
from snap_tpu_torch.data import types as data_types
from snap_tpu_torch.models import image_encoder
from snap_tpu_torch.models import layers
from snap_tpu_torch.models import types

Tensor = torch.Tensor


class SemanticRasterEncoder(nn.Module):
  """Encode 2D semantic rasters ``[B, H, W, len(raster_classes)]`` (bool)
  into a feature pyramid."""

  def __init__(self, config: configs.SemanticRasterEncoderConfig,
               raster_classes: Sequence[str], dtype: torch.dtype):
    super().__init__()
    self.dtype = dtype
    self.raster_classes = tuple(raster_classes)
    self.indices_surfel_road = [
        i for i, c in enumerate(self.raster_classes)
        if c in data_types.SURFEL_ROAD_CLASSES]
    self.indices_other_classes = [
        i for i, c in enumerate(self.raster_classes)
        if c not in data_types.SURFEL_ROAD_CLASSES]
    dim = config.embedding_dim
    # flax ``nn.Embed``: f32 tables, looked up in the compute dtype.
    self.embeddings_surfel_road = layers.Embed(
        max(len(self.indices_surfel_road), 1), dim)
    self.embeddings_other_classes = layers.Embed(
        max(len(self.indices_other_classes), 1) * 2, dim)
    in_channels = dim * (bool(self.indices_surfel_road)
                         + len(self.indices_other_classes))
    self.encoder = image_encoder.ImageEncoder(config.encoder, dtype,
                                              in_channels)

  def forward(self, rasters: Tensor) -> types.FeatureImagePyramid:
    if rasters.shape[-1] != len(self.raster_classes):
      raise ValueError(f'rasters {tuple(rasters.shape)} for '
                       f'{len(self.raster_classes)} classes')
    parts = []
    if self.indices_surfel_road:
      road = rasters[..., self.indices_surfel_road]
      # The first class present (0 where none is): torch.argmax takes no
      # bool and returns the first of tied maxima.
      label = torch.argmax(road.to(torch.uint8), -1)
      parts.append(self.embeddings_surfel_road(label, self.dtype))
    if self.indices_other_classes:
      others = rasters[..., self.indices_other_classes].long()
      n = others.shape[-1]
      labels = torch.arange(n, device=others.device) * 2 + others
      f_others = self.embeddings_other_classes(labels, self.dtype)
      parts.append(f_others.reshape(*f_others.shape[:-2], -1))
    return self.encoder(torch.cat(parts, -1))
