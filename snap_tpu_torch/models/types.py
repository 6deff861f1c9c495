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
