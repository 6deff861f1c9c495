"""Port parity of the RANSAC-backend localizer (``smoke_eval_ransac``).

``configs.smoke_eval_ransac()`` against ``configs/smoke_localization.py``
(RANSAC, the in-FoV query points) with ``smoke_eval_localization.py``'s
model overrides (64 samples x 2 retries, grid refinement) at batch 2 in f32
on the CPU, on flax-initialized weights carried by
``convert.params_from_flax``. JAX's ``jax.random`` draws are not the port's
(ROADMAP C8), so JAX's sampled poses are injected (``pose_samples=``).
"""

import copy
import dataclasses
import json
import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snap_tpu.configs import smoke_eval_localization
from snap_tpu.configs import smoke_localization
from snap_tpu.data import loader as jloader
from snap_tpu.data import types as jtypes
from snap_tpu.models import bev_localizer as jbev_localizer
from snap_tpu.utils import grids as jgrids
from snap_tpu_torch import configs
from snap_tpu_torch import convert
from snap_tpu_torch import evaluate
from snap_tpu_torch.data import loader
from snap_tpu_torch.models import bev_localizer
from snap_tpu_torch.utils import geometry

torch.set_num_threads(2)

# f32 on both sides. The two differ by summation order through the
# encoders, the einsum and the sum over the query points (planes to 1e-5,
# as tests/test_torch_localizer.py holds them); scores of up to 5.6 here
# differ by up to 3.8e-6 (measured), held to 1e-5.
SCORE_ATOL = 1e-5
# The injected samples are JAX's own values; the refined pose composes one
# of them with a lattice offset (last-bit differences, measured 9.5e-7 m).
POSE_ATOL = 1e-5
# nll = -log_softmax of the scores: the score tolerance times 2.
NLL_ATOL = 2e-5


def _jax_config():
  cfg = smoke_localization.get_config()
  cfg.model.update(dict(smoke_eval_localization.get_config().model))
  return cfg


def test_smoke_eval_ransac_config_equals_jax():
  port = configs.smoke_eval_ransac()
  ref = _jax_config()
  for field in ('pose_backend', 'filter_points_in_fov', 'num_pose_samples',
                'num_pose_sampling_retries', 'do_grid_refinement',
                'clip_negative_scores', 'mask_score_out_of_bounds',
                'add_temperature', 'init_temperature',
                'threshold_remove_accurate_poses', 'query_frustum_depth'):
    assert getattr(port.model, field) == ref.model[field], field
  ev = smoke_eval_localization.get_config()
  assert port.batch_size == ev.batch_size == 2
  assert port.dtype_str == ev.dtype_str == 'float32'
  assert port.data.shuffle_seed == ev.data.rng_seed
  location = ev.data.name_pattern.format(ev.data.split)
  assert port.data.locations.evaluation == location


@pytest.fixture(scope='module')
def ransac_outputs():
  tcfg = configs.smoke_eval_ransac(batch_size=2)
  examples = loader.make_pair_examples(
      loader.split_generator(tcfg.data, 'eval'), [0, 1], tcfg.data)
  jbatch = jloader.process_batch(copy.deepcopy(examples),
                                 jtypes.DataMode.PAIR_SCENE_VIEW)
  jbatch.pop('_host')
  grid = jgrids.Grid3D.from_extent_meters((24, 32, 12), 1.0)
  meta = {'build_config': types.SimpleNamespace(
              scene_config=jtypes.SceneConfig(num_views=3)),
          'grid': grid, 'semantic_map_classes': None}
  jmodel = jbev_localizer.BEVLocalizerModel(_jax_config().model, meta,
                                            jnp.float32)
  rngs = {'params': jax.random.PRNGKey(0), 'sampling': jax.random.PRNGKey(1)}
  variables = jax.jit(lambda b: jmodel.flax_model.init(
      rngs, b, train=False))(jbatch)

  def run(v, b):
    pred = jmodel.flax_model.apply(v, b, train=False,
                                   rngs={'sampling': jax.random.PRNGKey(2)})
    return pred, jmodel.loss_metrics_function(pred, b, v['params'])

  want, (want_losses, want_metrics) = jax.jit(run)(variables, jbatch)
  params = jax.tree_util.tree_map(np.asarray, variables['params'])
  model = bev_localizer.BEVLocalizer(
      tcfg.model, loader.map_grid(tcfg.data).bev(), dtype=torch.float32)
  model.load_state_dict(convert.params_from_flax(params, model))
  samples = want['map_t_query_samples']
  injected = geometry.Transform2D(
      angle=torch.from_numpy(np.asarray(samples.angle)[:, 1:]),
      t=torch.from_numpy(np.asarray(samples.t)[:, 1:]))
  batch = loader.pair_batch_to_torch(examples, 'cpu')
  with torch.inference_mode():
    got = model(batch, pose_samples=injected)
    got_losses, got_metrics = model.loss_metrics_function(got, batch)
  return dict(want=want, got=got, want_losses=want_losses,
              want_metrics=want_metrics, got_losses=got_losses,
              got_metrics=got_metrics, params=params, batch=batch,
              injected=injected)


def test_query_points_are_the_fov_list(ransac_outputs):
  want, got = ransac_outputs['want'], ransac_outputs['got']
  w, g = want['query']['bev_matching'], got['query']['bev_matching']
  assert g.features.shape == w.features.shape  # [B, N, 1, D]
  assert g.features.shape[2] == 1
  np.testing.assert_array_equal(g.valid.numpy(), np.asarray(w.valid))
  np.testing.assert_allclose(g.features.numpy(), np.asarray(w.features),
                             atol=1e-5)


def test_scores_poses(ransac_outputs):
  want, got = ransac_outputs['want'], ransac_outputs['got']
  w = np.asarray(want['scores_poses'])
  assert got['scores_poses'].shape == w.shape == (2, 65)
  np.testing.assert_allclose(got['scores_poses'].numpy(), w,
                             atol=SCORE_ATOL)


def test_best_index_exact(ransac_outputs):
  want, got = ransac_outputs['want'], ransac_outputs['got']
  np.testing.assert_array_equal(got['best_index'].numpy(),
                                np.asarray(want['best_index']))
  for key in ('map_t_query_ransac',):
    np.testing.assert_array_equal(got[key].t.numpy(), np.asarray(want[key].t))
    np.testing.assert_array_equal(got[key].angle.numpy(),
                                  np.asarray(want[key].angle))


def test_grid_refinement(ransac_outputs):
  want, got = ransac_outputs['want'], ransac_outputs['got']
  w = np.asarray(want['scores_grid_refine'])
  assert got['scores_grid_refine'].shape == w.shape == (2, 41, 41, 41)
  np.testing.assert_allclose(got['scores_grid_refine'].numpy(), w,
                             atol=SCORE_ATOL)
  np.testing.assert_allclose(got['map_t_query'].t.numpy(),
                             np.asarray(want['map_t_query'].t),
                             atol=POSE_ATOL)
  np.testing.assert_allclose(got['map_t_query'].angle.numpy(),
                             np.asarray(want['map_t_query'].angle),
                             atol=POSE_ATOL)


def test_nll_and_recalls(ransac_outputs):
  o = ransac_outputs
  np.testing.assert_allclose(o['got_losses']['total'].numpy(),
                             np.asarray(o['want_losses']['total']),
                             atol=NLL_ATOL)
  assert set(o['got_metrics']) == set(o['want_metrics'])
  for key, want in o['want_metrics'].items():
    got = o['got_metrics'][key].numpy()
    want = np.asarray(want)
    if want.dtype == bool:
      np.testing.assert_array_equal(got, want, err_msg=key)
    else:
      np.testing.assert_allclose(got, want, atol=1e-4, err_msg=key)


def test_threshold_removes_accurate_samples(ransac_outputs):
  """``threshold_remove_accurate_poses`` masks the samples near the GT (not
  the GT itself) out of the softmax, as the JAX loss does."""
  o = ransac_outputs
  cfg = configs.smoke_eval_ransac()
  model = bev_localizer.BEVLocalizer(
      dataclasses.replace(cfg.model,
                          threshold_remove_accurate_poses=(1e9, 1e9)),
      loader.map_grid(cfg.data).bev())
  model.load_state_dict(convert.params_from_flax(o['params'], model))
  losses, _ = model.loss_metrics_function(o['got'], o['batch'])
  np.testing.assert_allclose(losses['total'].numpy(), 0.0, atol=1e-6)


def test_ransac_needs_samples_or_a_generator(ransac_outputs):
  model = bev_localizer.BEVLocalizer(
      configs.smoke_eval_ransac().model,
      loader.map_grid(configs.smoke_eval_ransac().data).bev())
  with pytest.raises(ValueError, match='generator'):
    with torch.inference_mode():
      model(ransac_outputs['batch'])


def test_evaluate_cli_on_cpu(capsys):
  """The entry point serves the RANSAC smoke config on the CPU; its metrics
  are finite and its recalls lie in [0, 1]."""
  evaluate.main(['--config=smoke_eval_ransac', '--num_queries=2',
                 '--batch_size=2', '--device=cpu'])
  out = capsys.readouterr().out.strip().splitlines()
  summary = json.loads(out[-1])
  assert summary['config'] == 'smoke_eval_ransac'
  for key in ('recall_1m', 'recall_top1', 'recall_samples_0.5m_1deg',
              'recall_samples_1m_2deg', 'recall_samples_2m_4deg'):
    assert 0.0 <= summary[key] <= 1.0, key
  assert all(math.isfinite(x) for x in summary['position_error_m'])
