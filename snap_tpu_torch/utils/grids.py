"""Regular N-D grids and linear interpolation.

Port of ``snap_tpu/utils/grids.py``.
"""

from __future__ import annotations

import dataclasses
import functools
import itertools
from typing import Optional, Tuple, Type, TypeVar, Union

import numpy as np
import torch

Tensor = torch.Tensor
AnyGrid = TypeVar('AnyGrid', bound='GridND')


@dataclasses.dataclass(frozen=True)
class GridND:
  """N-dimensional regular grid (static metadata)."""

  extent: Tuple[int, ...]
  cell_size: float

  @classmethod
  def from_extent_meters(
      cls: Type[AnyGrid], extent_meters: Tuple[float, ...], cell_size: float
  ) -> AnyGrid:
    extent = tuple(i / cell_size for i in extent_meters)
    if not all(abs(e - round(e)) < 1e-9 for e in extent):
      raise ValueError(
          f'The metric grid extent {extent_meters} is not divisible '
          f'by the cell size {cell_size}.')
    return cls(tuple(int(round(e)) for e in extent), cell_size)

  def index_to_xyz(self, idx: Tensor) -> Tensor:
    return (idx + 0.5) * self.cell_size

  @property
  def extent_meters(self) -> np.ndarray:
    return np.asarray(self.extent) * self.cell_size

  def grid_index(self, device: Union[str, torch.device] = 'cpu') -> Tensor:
    """``[*extent, N]`` int32 cell indices."""
    axes = [torch.arange(e, dtype=torch.int32, device=device)
            for e in self.extent]
    return torch.stack(torch.meshgrid(*axes, indexing='ij'), -1)


@dataclasses.dataclass(frozen=True)
class Grid2D(GridND):
  extent: Tuple[int, int]


@dataclasses.dataclass(frozen=True)
class Grid3D(GridND):
  extent: Tuple[int, int, int]

  def bev(self) -> Grid2D:
    return Grid2D(self.extent[:2], self.cell_size)


def interpolate_nd(
    array: Tensor,
    points: Tensor,
    valid_array: Optional[Tensor] = None,
    order: int = 1,
) -> Tuple[Tensor, Tensor]:
  """Linear interpolation of an N-D array of channel vectors at given points.

  ``array``: ``[*spatial, D]``; ``points``: ``[K, N]`` with the origin at the
  corner of cell ``(0,)*N`` (cell centers at half-integers). Corner indices
  clamp to the grid ('nearest') while the fractional weights are kept; a
  point is invalid when out of bounds or when any corner it reads is invalid.
  Returns ``(values [K, D], valid [K])``.
  """
  values, valid = interpolate_nd_batched(
      array[None], points[None],
      None if valid_array is None else valid_array[None], order)
  return values[0], valid[0]


def interpolate_nd_batched(
    array: Tensor,
    points: Tensor,
    valid_array: Optional[Tensor] = None,
    order: int = 1,
) -> Tuple[Tensor, Tensor]:
  """``interpolate_nd`` per example (JAX ``vmap``s it): ``array``
  ``[B, *spatial, D]``, ``points`` ``[B, K, N]``, ``valid_array``
  ``[B, *spatial]``; returns ``(values [B, K, D], valid [B, K])``."""
  spatial = array.shape[1:-1]
  n = len(spatial)
  if points.shape[-1] != n or points.shape[0] != array.shape[0]:
    raise ValueError(f'points {tuple(points.shape)} vs grid '
                     f'{tuple(array.shape)}')
  batch, k = points.shape[:2]
  size = torch.as_tensor(spatial, device=points.device)
  in_bounds = ((points >= 0) & (points < size)).all(-1)
  pts = points.to(array.dtype) - 0.5

  # Each example's cells follow the previous example's in the flat array.
  flat = array.reshape(-1, array.shape[-1])
  flat_valid = None if valid_array is None else valid_array.reshape(-1)
  strides = [int(np.prod(spatial[d + 1:])) for d in range(n)]
  offset = (torch.arange(batch, device=points.device)
            * int(np.prod(spatial)))[:, None]

  def read(coords):
    flat_idx = (offset + sum(c * s for c, s in zip(coords, strides))).long()
    return flat_idx.reshape(-1)

  if order == 0:
    idx = torch.minimum(torch.clamp(torch.round(pts).int(), min=0), size - 1)
    flat_idx = read([idx[..., d] for d in range(n)])
    valid = in_bounds
    if flat_valid is not None:
      valid = valid & flat_valid[flat_idx].reshape(batch, k)
    return flat[flat_idx].reshape(batch, k, -1), valid

  lower_raw = torch.floor(pts)
  frac = pts - lower_raw
  lower_int = lower_raw.int()
  lower = torch.minimum(torch.clamp(lower_int, min=0), size - 1)
  upper = torch.minimum(torch.clamp(lower_int + 1, min=0), size - 1)

  values = torch.zeros((batch, k, array.shape[-1]), dtype=array.dtype,
                       device=array.device)
  corners_valid = in_bounds
  for corner in itertools.product((0, 1), repeat=n):
    coords = [(upper if c else lower)[..., d] for d, c in enumerate(corner)]
    w = functools.reduce(
        torch.mul, [(frac if c else (1 - frac))[..., d]
                    for d, c in enumerate(corner)])
    flat_idx = read(coords)
    values = values + w[..., None] * flat[flat_idx].reshape(batch, k, -1)
    if flat_valid is not None:
      corners_valid = corners_valid & flat_valid[flat_idx].reshape(batch, k)
  return values, corners_valid
