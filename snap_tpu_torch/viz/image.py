"""Images and features as pictures (``snap_tpu/viz/image.py``): a grid of
images, a categorical legend, and features projected to RGB by a fitted
3-component PCA, its basis saved and loaded, shared by several maps.

matplotlib is imported inside the plotting functions alone, so that this
module imports where it is not installed. Features are numpy arrays (or
tensors, read on the host).
"""

from __future__ import annotations

import pickle
from typing import List, Optional, Sequence

import numpy as np


def _host(x) -> np.ndarray:
  if hasattr(x, 'detach'):
    x = x.detach().cpu()
  return np.asarray(x)


def plot_images(images: Sequence[np.ndarray],
                titles: Optional[Sequence[str]] = None, cols: int = 4,
                figsize: float = 3.0, cmap: str = 'viridis'):
  """A list of images in a grid of ``cols`` columns; returns the figure."""
  import matplotlib.pyplot as plt  # pylint: disable=g-import-not-at-top
  n = len(images)
  cols = min(cols, n)
  rows = -(-n // cols)
  fig, axes = plt.subplots(rows, cols, figsize=(figsize * cols,
                                                figsize * rows),
                           squeeze=False)
  for i, img in enumerate(images):
    img = _host(img)
    ax = axes[i // cols][i % cols]
    ax.imshow(img, cmap=None if img.ndim == 3 else cmap)
    ax.set_axis_off()
    if titles is not None:
      ax.set_title(titles[i])
  for i in range(n, rows * cols):
    axes[i // cols][i % cols].set_axis_off()
  return fig


def add_categorical_legend(ax, names: Sequence[str], colors: Sequence):
  """A legend of one colour patch per category on ``ax``."""
  import matplotlib.patches as mpatches  # pylint: disable=g-import-not-at-top
  handles = [mpatches.Patch(color=c, label=n) for n, c in zip(names, colors)]
  ax.legend(handles=handles, loc='upper right', fontsize='small')


class FeaturePCA:
  """Features to RGB through a fitted 3-component PCA: the top 3
  principal directions (an SVD of at most 20,000 rows, drawn with seed 0),
  each scaled from its 1st to its 99th percentile onto [0, 1]."""

  def __init__(self):
    self.mean_: Optional[np.ndarray] = None
    self.components_: Optional[np.ndarray] = None
    self.mins_: Optional[np.ndarray] = None
    self.maxs_: Optional[np.ndarray] = None

  def fit(self, features: np.ndarray, mask: Optional[np.ndarray] = None):
    features = _host(features)
    flat = features.reshape(-1, features.shape[-1])
    if mask is not None:
      flat = flat[_host(mask).reshape(-1)]
    self.mean_ = flat.mean(0)
    centered = flat - self.mean_
    fit_rows = centered
    if len(centered) > 20_000:
      fit_rows = centered[np.random.default_rng(0).choice(
          len(centered), 20_000, replace=False)]
    _, _, vt = np.linalg.svd(fit_rows, full_matrices=False)
    self.components_ = vt[:3]
    proj = centered @ self.components_.T
    self.mins_ = np.percentile(proj, 1, axis=0)
    self.maxs_ = np.percentile(proj, 99, axis=0)
    return self

  def __call__(self, features: np.ndarray) -> np.ndarray:
    if self.components_ is None:
      raise ValueError('FeaturePCA: fit() or load() first')
    features = _host(features)
    shape = features.shape[:-1]
    proj = (features.reshape(-1, features.shape[-1])
            - self.mean_) @ self.components_.T
    rgb = (proj - self.mins_) / np.maximum(self.maxs_ - self.mins_, 1e-9)
    return np.clip(rgb, 0, 1).reshape(*shape, 3)

  def save(self, path: str):
    with open(path, 'wb') as f:
      pickle.dump(dict(mean=self.mean_, components=self.components_,
                       mins=self.mins_, maxs=self.maxs_), f)

  @classmethod
  def load(cls, path: str) -> 'FeaturePCA':
    with open(path, 'rb') as f:
      data = pickle.load(f)
    pca = cls()
    pca.mean_, pca.components_ = data['mean'], data['components']
    pca.mins_, pca.maxs_ = data['mins'], data['maxs']
    return pca


def features_to_rgb(*feature_maps: np.ndarray,
                    masks: Optional[Sequence[np.ndarray]] = None,
                    pca: Optional[FeaturePCA] = None) -> List[np.ndarray]:
  """Several feature maps in one colour space: one PCA fitted on all of
  them (their ``masks``' rows) unless ``pca`` is given."""
  maps = [_host(f) for f in feature_maps]
  if pca is None:
    flat = np.concatenate([f.reshape(-1, f.shape[-1]) for f in maps], 0)
    mask = None
    if masks is not None:
      mask = np.concatenate([_host(m).reshape(-1) for m in masks], 0)
    pca = FeaturePCA().fit(flat, mask)
  return [pca(f) for f in maps]
