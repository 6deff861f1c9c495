"""Port parity of the whole slice: the exhaustive-backend localizer.

``smoke_exhaustive()`` against ``configs/smoke_localization.py:
pose_backend=exhaustive`` at batch 2 in f32 on the CPU, on flax-initialized
weights carried by ``convert.params_from_flax``. Dense refinement is turned
on on both sides (the bench path refines) so the refined pose is compared.
"""

import copy
import dataclasses
import math

import jax
import jax.numpy as jnp
import ml_collections
import numpy as np
import pytest
import torch

from snap_tpu.configs import smoke_localization
from snap_tpu.data import loader as jloader
from snap_tpu.data import synthetic as jsynthetic
from snap_tpu.data import types as jtypes
from snap_tpu.models import bev_localizer as jbev_localizer
from snap_tpu.models import bev_mapper as jbev_mapper
from snap_tpu.models import types as jmodel_types
from snap_tpu.models import pose_exhaustive_voting as jpev
from snap_tpu.utils import geometry as jgeometry
from snap_tpu.utils import grids as jgrids
from snap_tpu_torch import configs
from snap_tpu_torch import convert
from snap_tpu_torch import evaluate
from snap_tpu_torch.data import loader
from snap_tpu_torch.models import bev_localizer
from snap_tpu_torch.models import bev_mapper
from snap_tpu_torch.models import pose_exhaustive_voting as pev
from snap_tpu_torch.models import types as model_types
from snap_tpu_torch.utils import geometry
from snap_tpu_torch.utils import grids

torch.set_num_threads(2)

# f32 on both sides: the planes and volumes differ by summation order
# through the encoders and the FFT; the refined pose is an argmax, and at
# these seeds it lands on the same cell and angle (exact), but a tolerance
# of 1e-4 m / rad is what the comparison states.
PLANE_ATOL = 1e-5
VOLUME_ATOL = 2e-5
FINE_ATOL = 1e-4
POSE_ATOL = 1e-4


def _jax_config():
  cfg = smoke_localization.get_config('pose_backend=exhaustive')
  cfg.model.do_grid_refinement = True
  return cfg


def _torch_config():
  cfg = configs.smoke_exhaustive(batch_size=2)
  return dataclasses.replace(
      cfg, model=dataclasses.replace(cfg.model, do_grid_refinement=True))


@pytest.fixture(scope='module')
def slice_outputs():
  tcfg = _torch_config()
  # The examples the evaluate CLI serves first (the config's eval split).
  examples = loader.make_pair_examples(
      loader.split_generator(tcfg.data, 'eval'), [0, 1], tcfg.data)
  jbatch = jloader.process_batch(copy.deepcopy(examples),
                                 jtypes.DataMode.PAIR_SCENE_VIEW)
  jbatch.pop('_host')
  grid = jgrids.Grid3D.from_extent_meters((24, 32, 12), 1.0)
  jmodel = jbev_localizer.BEVLocalizer(
      _jax_config().model, jtypes.SceneConfig(num_views=3), grid.bev(), None,
      jnp.float32)
  rngs = {'params': jax.random.PRNGKey(0), 'sampling': jax.random.PRNGKey(1)}
  variables = jax.jit(lambda b: jmodel.init(rngs, b, train=False))(jbatch)
  want = jax.jit(lambda v, b: jmodel.apply(
      v, b, train=False, rngs={'sampling': jax.random.PRNGKey(2)}))(
          variables, jbatch)
  params = jax.tree_util.tree_map(np.asarray, variables['params'])
  model = bev_localizer.BEVLocalizer(
      tcfg.model, loader.map_grid(tcfg.data).bev(), dtype=torch.float32)
  model.load_state_dict(convert.params_from_flax(params, model))
  with torch.inference_mode():
    got = model(loader.pair_batch_to_torch(examples, 'cpu'))
  return want, got, params


@pytest.mark.parametrize('scene', ['map', 'query'])
def test_bev_matching_plane(slice_outputs, scene):
  want, got, _ = slice_outputs
  w, g = want[scene]['bev_matching'], got[scene]['bev_matching']
  np.testing.assert_array_equal(g.valid.numpy(), np.asarray(w.valid))
  np.testing.assert_allclose(g.features.numpy(), np.asarray(w.features),
                             atol=PLANE_ATOL)


def test_pose_volume(slice_outputs):
  want, got, _ = slice_outputs
  w = np.asarray(want['scores_pose_volume'])
  g = got['scores_pose_volume'].numpy()
  np.testing.assert_array_equal(np.isfinite(g), np.isfinite(w))
  fin = np.isfinite(w)
  np.testing.assert_allclose(g[fin], w[fin], atol=VOLUME_ATOL)
  np.testing.assert_allclose(got['scores_grid_refine'].numpy(),
                             np.asarray(want['scores_grid_refine']),
                             atol=FINE_ATOL)
  np.testing.assert_allclose(got['scores_poses'].numpy(),
                             np.asarray(want['scores_poses']),
                             atol=FINE_ATOL)


def test_best_volume_index_exact(slice_outputs):
  want, got, _ = slice_outputs
  np.testing.assert_array_equal(got['best_volume_index'].numpy(),
                                np.asarray(want['best_volume_index']))
  np.testing.assert_array_equal(got['top1_coarse_correct'].numpy(),
                                np.asarray(want['top1_coarse_correct']))


def test_refined_pose(slice_outputs):
  want, got, _ = slice_outputs
  np.testing.assert_allclose(got['map_t_query'].t.numpy(),
                             np.asarray(want['map_t_query'].t),
                             atol=POSE_ATOL)
  np.testing.assert_allclose(got['map_t_query'].angle.numpy(),
                             np.asarray(want['map_t_query'].angle),
                             atol=POSE_ATOL)


def _plain(value):
  if isinstance(value, (list, tuple)):
    return tuple(_plain(v) for v in value)
  return value


def _assert_config_equal(port, ref, path=''):
  """Every field of the port's config equals the JAX config's same key."""
  for field in dataclasses.fields(port):
    value, name = getattr(port, field.name), f'{path}{field.name}'
    if field.name not in ref:
      continue  # a port-only field (e.g. the config's batch size)
    if dataclasses.is_dataclass(value):
      _assert_config_equal(value, ref[field.name], name + '.')
    else:
      assert _plain(value) == _plain(ref[field.name]), (
          name, value, ref[field.name])


def test_smoke_config_equals_jax():
  port = configs.smoke_exhaustive()
  ref = smoke_localization.get_config('pose_backend=exhaustive')
  _assert_config_equal(port.model, ref.model)
  _assert_config_equal(port.data, ref.data)
  assert port.dtype_str == ref.dtype_str


def test_bench_config_equals_jax():
  import bench  # the JAX benchmark's config builder (bench.py:63-100)
  port = configs.bench_full()
  ref = bench.build_config(1)
  _assert_config_equal(port.model, ref.model)
  _assert_config_equal(port.data, ref.data)
  assert port.dtype_str == ref.dtype_str


@pytest.mark.parametrize('index', [0, 4])
def test_generator_copy_equals_jax(index):
  """The port's numpy scene generator gives the JAX package's scenes."""
  data = configs.DataConfig(num_views=3, image_size=(18, 24), voxel_size=1.0)
  gen = loader.make_generator(data, 11)
  ref = jsynthetic.SyntheticSceneGenerator(
      scene_config=jtypes.SceneConfig(num_views=3),
      rasters_config=jtypes.RastersConfig(resolution=1.0),
      lidar_config=jtypes.LidarConfig(), image_hw=(18, 24), voxel_size=1.0,
      seed=11)
  got = gen.make_example(index, 'pair_scene_view', add_rasters=True)
  want = ref.make_example(index, 'pair_scene_view', add_rasters=True)
  flat_got = jax.tree_util.tree_leaves_with_path(got)
  flat_want = jax.tree_util.tree_leaves_with_path(want)
  assert [p for p, _ in flat_got] == [p for p, _ in flat_want]
  for (path, g), (_, w) in zip(flat_got, flat_want):
    np.testing.assert_array_equal(np.asarray(g), np.asarray(w),
                                  err_msg=str(path))


def test_query_frustum_grid_equals_jax():
  for cell in (0.2, 1.0):
    want = jbev_localizer.build_query_frustum_grid(cell, 16.0)
    got = bev_localizer.build_query_frustum_grid(cell, 16.0)
    assert got[0].extent == want[0].extent
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
  assert bev_localizer.build_query_frustum_grid(0.2, 16.0)[0].extent == (
      120, 80)


def test_index_tfm_converters_match_jax():
  rng = np.random.default_rng(0)
  grid_q = jgrids.Grid2D((24, 16), 1.0)
  qgrid_p_q = np.array([12.0, 0.0])
  idx = np.stack([rng.integers(0, 16, 6), rng.integers(0, 40, 6),
                  rng.integers(0, 40, 6)], -1).astype(np.int32)
  want = jpev.exhaustive_index_to_tfm(jnp.asarray(idx), grid_q, None, 16,
                                      qgrid_p_q)
  tgrid_q = grids.Grid2D((24, 16), 1.0)
  got = pev.exhaustive_index_to_tfm(torch.from_numpy(idx), tgrid_q, 16,
                                    qgrid_p_q)
  np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t), atol=1e-5)
  np.testing.assert_allclose(got.angle.numpy(), np.asarray(want.angle),
                             atol=1e-6)
  back_want = jpev.exhaustive_tfm_to_index(want, grid_q, 16, qgrid_p_q)
  back = pev.exhaustive_tfm_to_index(got, tgrid_q, 16, qgrid_p_q)
  np.testing.assert_allclose(back.numpy(), np.asarray(back_want), atol=1e-4)
  np.testing.assert_allclose(back.numpy() % [16, 1e9, 1e9], idx, atol=1e-3)


def test_read_pose_volume_matches_jax():
  rng = np.random.default_rng(1)
  volume = rng.normal(size=(8, 9, 11)).astype(np.float32)
  volume[2, 3:5] = -np.inf
  for index in ([2.5, 3.2, 4.7], [7.9, 0.0, 10.0], [0.3, 8.6, -0.5]):
    index = np.asarray(index, np.float32)
    want = jpev.read_pose_volume(jnp.asarray(volume), jnp.asarray(index))
    got = pev.read_pose_volume(torch.from_numpy(volume),
                               torch.from_numpy(index))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


@pytest.mark.parametrize('scale', [1.0, 1e-13])
def test_parabolic_peak_offsets_keeps_absolute_epsilon(scale):
  """The concavity test is absolute (den < -1e-12), as in the reference: a
  peak whose scores are scaled down to ~1e-13 counts as flat."""
  r, a, b = np.meshgrid(np.arange(5), np.arange(6), np.arange(7),
                        indexing='ij')
  scores = -((r - 2.3)**2 + (a - 2.8)**2 + (b - 3.1)**2) * scale
  scores = scores.astype(np.float32)
  idx = np.unravel_index(np.argmax(scores), scores.shape)
  want = jpev.parabolic_peak_offsets(jnp.asarray(scores), jnp.asarray(idx))
  got = pev.parabolic_peak_offsets(torch.from_numpy(scores), idx)
  np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
  assert (np.abs(got.numpy()) > 0).all() == (scale == 1.0)


def test_template_matching_fft_matches_jax():
  rng = np.random.default_rng(2)
  q = rng.normal(size=(10, 6, 5, 4)).astype(np.float32)
  q_valid = rng.random((10, 6, 5)) < 0.8
  m = rng.normal(size=(9, 12, 4)).astype(np.float32)
  m_valid = rng.random((9, 12)) < 0.7
  want, want_raw = jpev.template_matching_fft(
      jnp.asarray(q), jnp.asarray(q_valid), jnp.asarray(m),
      jnp.asarray(m_valid), return_raw=True)
  got, got_raw = pev.template_matching_fft(
      torch.from_numpy(q), torch.from_numpy(q_valid), torch.from_numpy(m),
      torch.from_numpy(m_valid))
  np.testing.assert_array_equal(np.isfinite(got.numpy()),
                                np.isfinite(np.asarray(want)))
  np.testing.assert_allclose(got_raw.numpy(), np.asarray(want_raw),
                             atol=1e-5)


def test_median_is_jnp_median():
  """``torch.median`` takes the lower middle; the mapper needs jnp's mean."""
  x = np.random.default_rng(3).normal(size=(3, 20)).astype(np.float32)
  np.testing.assert_array_equal(
      bev_mapper.median(torch.from_numpy(x)).numpy(),
      np.asarray(jnp.median(jnp.asarray(x), axis=-1)))
  assert not np.array_equal(torch.from_numpy(x).median(-1).values.numpy(),
                            np.asarray(jnp.median(jnp.asarray(x), axis=-1)))


def test_geometry_matches_jax():
  rng = np.random.default_rng(4)
  angle = rng.uniform(-math.pi, math.pi, (3, 2)).astype(np.float32)
  t = rng.normal(size=(3, 2, 2)).astype(np.float32)
  pts = rng.normal(size=(3, 2, 5, 2)).astype(np.float32)
  jt = jgeometry.Transform2D(angle=jnp.asarray(angle), t=jnp.asarray(t))
  tt = geometry.Transform2D(angle=torch.from_numpy(angle),
                            t=torch.from_numpy(t))
  perm = [2, 0, 1]
  np.testing.assert_allclose((tt.inv @ tt[torch.tensor(perm)]).t.numpy(),
                             np.asarray((jt.inv @ jt[np.array(perm)]).t),
                             atol=1e-6)
  np.testing.assert_allclose((tt @ torch.from_numpy(pts)).numpy(),
                             np.asarray(jt @ jnp.asarray(pts)), atol=1e-6)
  for got, want in zip(tt.magnitude(), jt.magnitude()):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_ransac_backend_raises():
  """An unknown backend raises; the RANSAC backend (ported since) raises
  when it has neither a generator for its pose samples nor the samples."""
  smoke = configs.smoke_exhaustive()
  grid = loader.map_grid(smoke.data).bev()
  with pytest.raises(ValueError, match='Unknown pose_backend'):
    bev_localizer.BEVLocalizer(
        dataclasses.replace(smoke.model, pose_backend='sampled'), grid)
  model = bev_localizer.BEVLocalizer(
      dataclasses.replace(smoke.model, pose_backend='ransac',
                          filter_points_in_fov=True), grid)
  batch = loader.pair_batch_to_torch(loader.make_pair_examples(
      loader.split_generator(smoke.data, 'eval'), [0], smoke.data), 'cpu')
  with pytest.raises(ValueError, match='generator'), torch.inference_mode():
    model(batch)


def test_evaluate_reads_params_npz(slice_outputs, tmp_path):
  """The entry point on a flat .npz of JAX params gives JAX's argmax."""
  want, _, params = slice_outputs
  path = tmp_path / 'params.npz'
  np.savez(path, **convert.flatten_params(params))
  result = evaluate.evaluate('smoke_exhaustive', 2, 'cpu', seed=3,
                             batch_size=2, params_npz=str(path))
  np.testing.assert_array_equal(
      result['last_pred']['best_volume_index'].numpy(),
      np.asarray(want['best_volume_index']))


def test_evaluate_cli_on_cpu(capsys):
  evaluate.main(['--config=smoke_exhaustive', '--num_queries=2',
                 '--batch_size=2', '--device=cpu', '--profile'])
  out = capsys.readouterr().out
  assert 'query 1: position error' in out
  assert '"recall_1m"' in out
  assert 'aten::conv2d' in out  # the profile table


@pytest.mark.parametrize('subcell', [False, True])
def test_dense_refinement_matches_jax(subcell):
  """The fine fan (K2 templates + f32 conv), with and without sub-cell fit."""
  rng = np.random.default_rng(5)
  hq, wq, h, w, d = 12, 8, 16, 20, 6
  grid_q = jgrids.Grid2D((hq, wq), 1.0)
  qgrid_p_q = np.array([6.0, 0.0])
  fq = rng.normal(size=(2, hq, wq, d)).astype(np.float32)
  vq = rng.random((2, hq, wq)) < 0.9
  fm = rng.normal(size=(2, h, w, d)).astype(np.float32)
  vm = np.ones((2, h, w), bool)
  coarse = np.array([[3, 10, 14], [30, 2, 25]], np.int32)
  stages = ((5.0, 0.25), (1.0, 0.5))
  want_t, want_s = jpev.dense_refinement_batched(
      jtypes_plane(fq, vq), jtypes_plane(fm, vm), jnp.asarray(coarse), grid_q,
      32, qgrid_p_q, stages=stages, subcell=subcell)
  got_t, got_s = pev.dense_refinement(
      tplane(fq, vq), tplane(fm, vm), torch.from_numpy(coarse),
      grids.Grid2D((hq, wq), 1.0), 32, qgrid_p_q, stages=stages,
      subcell=subcell)
  np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), atol=1e-4)
  np.testing.assert_allclose(got_t.t.numpy(), np.asarray(want_t.t),
                             atol=POSE_ATOL)
  np.testing.assert_allclose(got_t.angle.numpy(), np.asarray(want_t.angle),
                             atol=POSE_ATOL)


def jtypes_plane(f, v):
  return jmodel_types.FeaturePlane(features=jnp.asarray(f),
                                   valid=jnp.asarray(v))


def tplane(f, v):
  return model_types.FeaturePlane(features=torch.from_numpy(f),
                                  valid=torch.from_numpy(v))


@pytest.mark.parametrize('mode', ['max', 'sum', 'mean'])
def test_vertical_pooling_matches_jax(mode):
  rng = np.random.default_rng(6)
  f = rng.normal(size=(2, 4, 5, 6, 3)).astype(np.float32)
  v = rng.random((2, 4, 5, 6)) < 0.4
  v[0, 0, 0] = False  # an empty column
  jpool = jbev_mapper.VerticalPooling(
      ml_collections.ConfigDict({'pooling': mode}), jnp.float32)
  want = jpool.apply({}, jmodel_types.FeatureVolume(
      features=jnp.asarray(f), valid=jnp.asarray(v)))['plane']
  got = bev_mapper.VerticalPooling(configs.VerticalPoolingConfig(mode))(
      model_types.FeatureVolume(features=torch.from_numpy(f),
                                valid=torch.from_numpy(v)))
  np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
  np.testing.assert_allclose(got.features.numpy(), np.asarray(want.features),
                             atol=1e-6)
