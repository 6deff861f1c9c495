"""Typed containers for model outputs (port of ``snap_tpu/models/types.py``)."""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch

Tensor = torch.Tensor


@dataclasses.dataclass
class FeatureVolume:
  """A 3D volume of features with validity mask ([..., X, Y, Z, D])."""

  features: Tensor
  valid: Optional[Tensor] = None


@dataclasses.dataclass
class FeaturePlane:
  """A 2D plane of features with validity mask ([..., X, Y, D])."""

  features: Tensor
  valid: Optional[Tensor] = None


@dataclasses.dataclass
class FeatureImagePyramid:
  """Multi-scale image features with per-level (row, col) strides."""

  features: List[Tensor]
  strides: Sequence[Tuple[int, int]]


@dataclasses.dataclass
class LidarRaySamples:
  """Points sampled along lidar rays ([..., K, 3]), their occupancy labels
  (the hit True, the free space in front of it False) and validity."""

  points: Tensor
  labels: Tensor
  valid: Tensor


@dataclasses.dataclass
class OccupancySamples:
  """Occupancy probabilities at sample points, their validity and logits."""

  values: Tensor
  valid: Tensor
  logits: Tensor
