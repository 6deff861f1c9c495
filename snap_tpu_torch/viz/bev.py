"""Overhead (BEV) plots: grids, camera frusta, rasters, point clouds
(``snap_tpu/viz/bev.py``).

``rasterize_pointcloud`` accumulates per-point values into a grid's cells
(numpy); ``Plotter2D`` draws an overhead scene with matplotlib, which is
imported inside it alone, so that this module imports where matplotlib is
not installed. Poses are the port's ``geometry`` transforms (their tensors
read on the host) or anything with the same fields as numpy arrays.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from snap_tpu_torch.utils import geometry
from snap_tpu_torch.utils import grids


def _host(x) -> np.ndarray:
  """A tensor (any device) or array as a numpy array."""
  if hasattr(x, 'detach'):
    x = x.detach().cpu()
  return np.asarray(x)


def rasterize_pointcloud(
    xy: np.ndarray,
    values: np.ndarray,
    grid: grids.Grid2D,
    reduce: str = 'mean',
) -> Tuple[np.ndarray, np.ndarray]:
  """Accumulate per-point values into grid cells.

  Args:
    xy: ``[N, 2]`` point positions (meters, grid-corner origin).
    values: ``[N, D]`` per-point values (``[D, N]`` is transposed).
    grid: target 2D grid.
    reduce: 'mean', 'sum', or 'max'.

  Returns:
    raster ``[X, Y, D]`` and count ``[X, Y]``; points outside the grid are
    dropped.
  """
  xy = _host(xy)
  values = np.atleast_2d(_host(values))
  if values.shape[0] != xy.shape[0]:
    values = values.T
  idx = np.floor(xy / grid.cell_size).astype(int)
  in_grid = ((idx >= 0) & (idx < np.asarray(grid.extent))).all(-1)
  idx = idx[in_grid]
  values = values[in_grid]
  flat = idx[:, 0] * grid.extent[1] + idx[:, 1]
  num_cells = int(np.prod(grid.extent))
  count = np.bincount(flat, minlength=num_cells).reshape(grid.extent)
  raster = np.zeros((num_cells, values.shape[-1]), values.dtype)
  if reduce == 'max':
    np.maximum.at(raster, flat, values)
  else:
    np.add.at(raster, flat, values)
    if reduce == 'mean':
      raster /= np.maximum(count.reshape(-1, 1), 1)
  return raster.reshape(*grid.extent, values.shape[-1]), count


class Plotter2D:
  """Overhead scene plots: grid box, camera frusta, rasters, poses."""

  def __init__(self, grid: Optional[grids.Grid2D] = None, ax=None,
               figsize: float = 6.0):
    import matplotlib.pyplot as plt  # pylint: disable=g-import-not-at-top
    if ax is None:
      _, ax = plt.subplots(1, 1, figsize=(figsize, figsize))
    self.ax = ax
    self.grid = grid
    ax.set_aspect('equal')
    if grid is not None:
      self.plot_grid_box(grid)

  def plot_grid_box(self, grid: grids.Grid2D, color: str = 'k', **kwargs):
    ex, ey = grid.extent_meters
    self.ax.plot([0, ex, ex, 0, 0], [0, 0, ey, ey, 0], color=color, **kwargs)

  def plot_cameras(self, scene_t_view: geometry.Transform3D,
                   hfov_deg: float = 72.0, depth: float = 4.0,
                   color: str = 'r', **kwargs):
    """Camera positions and viewing frusta projected to the plane."""
    t = _host(scene_t_view.t).reshape(-1, 3)
    rotations = _host(scene_t_view.R).reshape(-1, 3, 3)
    self.ax.scatter(t[:, 0], t[:, 1], color=color, s=10, **kwargs)
    half = np.deg2rad(hfov_deg / 2)
    for k in range(len(t)):
      # The optical axis (camera +z) projected to the plane.
      forward = rotations[k] @ np.array([0.0, 0.0, 1.0])
      yaw = np.arctan2(forward[1], forward[0])
      for a in (yaw - half, yaw + half):
        end = t[k, :2] + depth * np.array([np.cos(a), np.sin(a)])
        self.ax.plot([t[k, 0], end[0]], [t[k, 1], end[1]], color=color,
                     linewidth=0.8, **kwargs)

  def plot_raster(self, raster: np.ndarray, grid: grids.Grid2D,
                  map_t_raster: Optional[geometry.Transform2D] = None,
                  alpha: float = 1.0, **kwargs):
    """A raster, SE(2)-transformed into the map frame when given."""
    import matplotlib.transforms as mtransforms  # pylint: disable=g-import-not-at-top
    ex, ey = grid.extent_meters
    # raster[i, j] indexes x (rows) and y (columns): shown transposed, x
    # horizontal.
    im = self.ax.imshow(_host(raster).swapaxes(0, 1), origin='lower',
                        extent=(0, ex, 0, ey), alpha=alpha, **kwargs)
    if map_t_raster is not None:
      angle = float(_host(map_t_raster.angle))
      tx, ty = _host(map_t_raster.t)
      im.set_transform(mtransforms.Affine2D().rotate(angle).translate(tx, ty)
                       + self.ax.transData)
    return im

  def plot_pose(self, map_t_query: geometry.Transform2D, color: str = 'g',
                length: float = 3.0, **kwargs):
    t = _host(map_t_query.t).reshape(-1, 2)
    angle = _host(map_t_query.angle).reshape(-1)
    # The query's forward axis is +y in its frame.
    self.ax.quiver(t[:, 0], t[:, 1], -length * np.sin(angle),
                   length * np.cos(angle), color=color, angles='xy',
                   scale_units='xy', scale=1, **kwargs)
