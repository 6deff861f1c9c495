"""The port's ``viz`` against ``snap_tpu/viz`` on the same inputs: the cases
of ``tests/test_viz_and_eval.py:18-62`` (point-cloud rasterization, the
feature PCA's range, save and load, the shared colour space), every
reduction, the PCA's colours equal to JAX's, and the BEV plotter's and the
image grid's drawings equal to JAX's on matplotlib's Agg backend; and both
modules import where matplotlib is not installed (the card's machine has
none).
"""

import pathlib
import subprocess
import sys

import matplotlib
import numpy as np
import pytest
import torch

from snap_tpu.utils import geometry as jgeometry
from snap_tpu.utils import grids as jgrids
from snap_tpu.viz import bev as jbev
from snap_tpu.viz import image as jimage
from snap_tpu_torch.utils import geometry
from snap_tpu_torch.utils import grids
from snap_tpu_torch.viz import bev
from snap_tpu_torch.viz import image

matplotlib.use('Agg')
REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.mark.parametrize('reduce', ['mean', 'sum', 'max'])
def test_rasterize_pointcloud_matches_jax(reduce):
  """The reference test's points (two in a cell, one alone) and seeded
  ones in and out of a 4 x 5 grid; values given [N, D] and [D, N]."""
  rng = np.random.default_rng(0)
  xy = np.concatenate([np.array([[0.5, 0.5], [0.6, 0.7], [3.5, 3.5]]),
                       rng.uniform(-1, 6, size=(200, 2))])
  values = rng.normal(size=(203, 3))
  values[:3, 0] = [1.0, 3.0, 10.0]
  for vals in (values, values.T):
    want = jbev.rasterize_pointcloud(xy, vals, jgrids.Grid2D((4, 5), 1.0),
                                     reduce)
    got = bev.rasterize_pointcloud(torch.from_numpy(xy), vals,
                                   grids.Grid2D((4, 5), 1.0), reduce)
    for g, w in zip(got, want):
      assert g.shape == w.shape and g.dtype == w.dtype
      np.testing.assert_array_equal(g, w)
  if reduce == 'mean':
    raster, count = bev.rasterize_pointcloud(
        xy[:3], values[:3, :1], grids.Grid2D((4, 4), 1.0))
    np.testing.assert_allclose(raster[0, 0, 0], 2.0)
    np.testing.assert_allclose(raster[3, 3, 0], 10.0)
    assert count[0, 0] == 2 and count[3, 3] == 1


def test_out_of_grid_points_dropped():
  xy = np.array([[-1.0, 0.0], [5.0, 5.0], [0.5, 0.5]])
  _, count = bev.rasterize_pointcloud(xy, np.ones((3, 1)),
                                      grids.Grid2D((2, 2), 1.0))
  assert count.sum() == 1


def test_feature_pca_matches_jax_and_stays_in_range():
  """The reference's range check, and the colours JAX's PCA gives, on
  seeded features past 20,000 rows (the fit's subsample) with a mask."""
  rng = np.random.default_rng(1)
  feats = rng.normal(size=(150, 150, 8)) * np.linspace(1, 3, 8)
  mask = rng.random((150, 150)) < 0.9
  got = image.FeaturePCA().fit(torch.from_numpy(feats), mask)(feats)
  want = jimage.FeaturePCA().fit(feats, mask)(feats)
  assert got.shape == (150, 150, 3)
  assert got.min() >= 0.0 and got.max() <= 1.0
  np.testing.assert_allclose(got, want, atol=1e-12)
  rgb = image.features_to_rgb(rng.normal(size=(16, 16, 8)))[0]
  assert rgb.shape == (16, 16, 3) and rgb.min() >= 0 and rgb.max() <= 1


def test_save_load_roundtrip_reads_jax_files(tmp_path):
  """The port's saved basis loads back equal, and a basis JAX saved loads
  into the port's (the same pickle)."""
  feats = np.random.default_rng(1).normal(size=(100, 8))
  pca = image.FeaturePCA().fit(feats)
  pca.save(str(tmp_path / 'pca.pkl'))
  np.testing.assert_allclose(pca(feats),
                             image.FeaturePCA.load(str(tmp_path /
                                                       'pca.pkl'))(feats))
  jimage.FeaturePCA().fit(feats).save(str(tmp_path / 'jax.pkl'))
  np.testing.assert_allclose(image.FeaturePCA.load(str(tmp_path /
                                                       'jax.pkl'))(feats),
                             pca(feats), atol=1e-12)


def test_shared_color_space_matches_jax():
  rng = np.random.default_rng(2)
  a = rng.normal(size=(10, 10, 6))
  b = rng.normal(size=(4, 4, 6))
  masks = [rng.random((10, 10)) < 0.7, np.ones((4, 4), bool)]
  for kwargs in ({}, {'masks': masks}):
    got = image.features_to_rgb(a, b, **kwargs)
    want = jimage.features_to_rgb(a, b, **kwargs)
    assert [g.shape for g in got] == [(10, 10, 3), (4, 4, 3)]
    for g, w in zip(got, want):
      np.testing.assert_allclose(g, w, atol=1e-12)
  pca = image.FeaturePCA().fit(a)
  np.testing.assert_array_equal(image.features_to_rgb(b, pca=pca)[0], pca(b))


def _drawn(ax):
  """What an axis holds: its lines' data, its collections' offsets, its
  images' arrays and extents, its legend's labels."""
  legend = ax.get_legend()
  return dict(
      lines=[np.asarray(line.get_xydata()) for line in ax.get_lines()],
      collections=[np.asarray(c.get_offsets()) for c in ax.collections],
      images=[(np.asarray(im.get_array()), im.get_extent())
              for im in ax.get_images()],
      legend=None if legend is None else [t.get_text()
                                          for t in legend.get_texts()])


def _assert_drawn_equal(got, want):
  assert got.keys() == want.keys()
  for key in ('lines', 'collections'):
    assert len(got[key]) == len(want[key]), key
    for g, w in zip(got[key], want[key]):
      np.testing.assert_allclose(g, w, atol=1e-6, err_msg=key)
  assert len(got['images']) == len(want['images'])
  for (g, ge), (w, we) in zip(got['images'], want['images']):
    np.testing.assert_array_equal(g, w)
    assert tuple(ge) == tuple(we)
  assert got['legend'] == want['legend']


def test_plotter2d_draws_what_jax_draws():
  """Grid box, 3 cameras' frusta, a raster SE(2)-placed in the map, 2
  poses and a legend: the same drawing from the port's tensors as from
  JAX's arrays."""
  import matplotlib.pyplot as plt  # pylint: disable=g-import-not-at-top
  rng = np.random.default_rng(3)
  angles = rng.uniform(-np.pi, np.pi, 3)
  rot = np.stack([np.array([[np.cos(a), 0, np.sin(a)], [np.sin(a), 0,
                                                         -np.cos(a)],
                            [0, 1, 0]]) for a in angles]).astype(np.float32)
  t = rng.uniform(0, 10, (3, 3)).astype(np.float32)
  raster = rng.random((8, 6, 3))
  pose = (np.float32(0.4), np.array([3.0, 2.0], np.float32))
  poses = (rng.uniform(-3, 3, 2).astype(np.float32),
           rng.uniform(0, 10, (2, 2)).astype(np.float32))
  drawings = []
  for geo, grid_cls, to in ((jgeometry, jgrids, np.asarray),
                            (geometry, grids, torch.as_tensor)):
    plotter = (jbev if geo is jgeometry else bev).Plotter2D(
        grid_cls.Grid2D((12, 10), 1.0))
    plotter.plot_cameras(geo.Transform3D(R=to(rot), t=to(t)))
    plotter.plot_raster(raster, grid_cls.Grid2D((8, 6), 0.5),
                        geo.Transform2D(angle=to(pose[0]), t=to(pose[1])))
    plotter.plot_pose(geo.Transform2D(angle=to(poses[0]), t=to(poses[1])))
    (jimage if geo is jgeometry else image).add_categorical_legend(
        plotter.ax, ['road', 'building'], ['k', 'r'])
    drawings.append(_drawn(plotter.ax))
    plt.close(plotter.ax.figure)
  _assert_drawn_equal(drawings[1], drawings[0])
  assert len(drawings[0]['lines']) == 1 + 3 * 2


def test_plot_images_draws_what_jax_draws():
  import matplotlib.pyplot as plt  # pylint: disable=g-import-not-at-top
  rng = np.random.default_rng(4)
  images = [rng.random((5, 7, 3)), rng.random((5, 7)), rng.random((4, 4))]
  figs = [module.plot_images(images, titles=['a', 'b', 'c'], cols=2)
          for module in (jimage, image)]
  for got, want in zip(figs[1].axes, figs[0].axes):
    _assert_drawn_equal(_drawn(got), _drawn(want))
    assert got.get_title() == want.get_title()
    assert got.axison == want.axison
  for fig in figs:
    plt.close(fig)


def test_viz_imports_without_matplotlib():
  code = ('import sys; sys.modules["matplotlib"] = None; '
          'from snap_tpu_torch.viz import bev, image; '
          'print(bev.rasterize_pointcloud([[0.5, 0.5]], [[1.0]], '
          '__import__("snap_tpu_torch.utils.grids", fromlist=["x"]).Grid2D('
          '(1, 1), 1.0))[1].sum())')
  proc = subprocess.run([sys.executable, '-c', code], cwd=REPO,
                        capture_output=True, text=True, timeout=120)
  assert proc.returncode == 0, proc.stderr
  assert proc.stdout.split()[-1] == '1'
