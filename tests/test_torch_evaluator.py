"""The port's evaluator against ``snap_tpu/evaluator.py``.

On the CPU in f32: the recall curve and the closest-map-view distances
against JAX's; the per-example metrics of the smoke localizer on a batch
of the eval split, with flax-initialized weights carried over by
``convert``, against JAX's ``pack_localization_metrics``; the dump's round
trip; ``eval_on_dataset`` over a padded eval split against per-example
runs, its step context around the forward alone; and ``evaluate
--workdir`` writing one row per query.
"""

import contextlib
import copy
import dataclasses
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import torch

from snap_tpu import evaluator as jevaluator
from snap_tpu.configs import smoke_localization
from snap_tpu.data import loader as jloader
from snap_tpu.data import types as jtypes
from snap_tpu.models import bev_localizer as jbev_localizer
from snap_tpu.utils import geometry as jgeometry
from snap_tpu.utils import grids as jgrids
from snap_tpu_torch import configs
from snap_tpu_torch import convert
from snap_tpu_torch import evaluate
from snap_tpu_torch import evaluator
from snap_tpu_torch.data import loader
from snap_tpu_torch.models import bev_localizer
from snap_tpu_torch.utils import geometry

torch.set_num_threads(2)

# The localizer tests' tolerances (tests/test_torch_localizer.py,
# tests/test_torch_train.py): the pose to 1e-4 m / rad, scores to 1e-4,
# the loss to 1e-5 relative. Angles here are in degrees.
POSE_ATOL = 1e-4
DEG_ATOL = float(np.rad2deg(POSE_ATOL))
SCORE_ATOL = 1e-4
LOSS_RTOL = 1e-5
# Closest-view distances are data-only geometry in f32.
VIEW_ATOL = 1e-5


def _random_transforms(rng, shape):
  q, _ = np.linalg.qr(rng.normal(size=(*shape, 3, 3)))
  q *= np.sign(np.linalg.det(q))[..., None, None]
  return q.astype(np.float32), rng.uniform(-20, 20, (*shape, 3)).astype(
      np.float32)


def test_compute_recall_equals_jax():
  errors = np.random.default_rng(0).exponential(2.0, 500)
  for got, want in zip(evaluator.compute_recall(errors, 5.0),
                       jevaluator.compute_recall(errors, 5.0)):
    np.testing.assert_array_equal(got, want)


def test_compute_distance_view_to_map_equals_jax():
  rng = np.random.default_rng(1)
  rq, tq = _random_transforms(rng, (4, 1))
  rm, tm = _random_transforms(rng, (4, 6))
  want = jevaluator.compute_distance_view_to_map(
      jgeometry.Transform3D(R=jnp.asarray(rq), t=jnp.asarray(tq)),
      jgeometry.Transform3D(R=jnp.asarray(rm), t=jnp.asarray(tm)))
  got = evaluator.compute_distance_view_to_map(
      geometry.Transform3D(R=torch.as_tensor(rq), t=torch.as_tensor(tq)),
      geometry.Transform3D(R=torch.as_tensor(rm), t=torch.as_tensor(tm)))
  np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                             atol=1e-3)  # degrees, from arccos
  np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                             atol=VIEW_ATOL)


def test_dump_round_trips_with_strings(tmp_path):
  results = {'error_max_meter': np.array([0.5, 2.0], np.float32),
             'recall_top1': np.array([True, False]),
             'pair_id': np.array(['synthetic/1/0|q', 'synthetic/1/1|q'])}
  config = configs.smoke_eval_ransac()
  evaluator.write_eval_dump(tmp_path / 'dump', results, {'config': config})
  got, got_config = evaluator.read_eval_dump(tmp_path / 'dump')
  assert set(got) == set(results)
  for key, value in results.items():
    assert got[key].dtype == value.dtype
    np.testing.assert_array_equal(got[key], value)
  assert got_config['config']['data']['locations']['evaluation'] == (
      'smokeville-synthetic_eval')
  assert got_config['config']['model']['pose_backend'] == 'ransac'


def _jax_smoke_model():
  cfg = smoke_localization.get_config('pose_backend=exhaustive')
  grid = jgrids.Grid3D.from_extent_meters((24, 32, 12), 1.0)
  meta = {'build_config': types.SimpleNamespace(
              scene_config=jtypes.SceneConfig(num_views=3)),
          'grid': grid, 'semantic_map_classes': None}
  return jbev_localizer.BEVLocalizerModel(cfg.model, meta, jnp.float32)


def test_pack_localization_metrics_matches_jax():
  cfg = configs.smoke_exhaustive(batch_size=2)
  examples = loader.make_pair_examples(
      loader.split_generator(cfg.data, 'eval'), [0, 1], cfg.data)
  jbatch = jloader.process_batch(copy.deepcopy(examples),
                                 jtypes.DataMode.PAIR_SCENE_VIEW)
  jbatch.pop('_host')
  jmodel = _jax_smoke_model()
  rngs = {'params': jax.random.PRNGKey(0), 'sampling': jax.random.PRNGKey(1)}
  params = jax.jit(lambda b: jmodel.flax_model.init(rngs, b, train=False))(
      jbatch)['params']

  def packed(p, b):
    pred = jmodel.flax_model.apply({'params': p}, b, train=False,
                                   rngs={'sampling': jax.random.PRNGKey(2)})
    losses, metrics = jmodel.loss_metrics_function(pred, b, p)
    return jevaluator.pack_localization_metrics(metrics, losses, b, pred)

  want = jax.tree_util.tree_map(np.asarray, jax.jit(packed)(params, jbatch))
  model = bev_localizer.BEVLocalizer(
      cfg.model, loader.map_grid(cfg.data).bev(), dtype=torch.float32)
  model.load_state_dict(convert.params_from_flax(
      jax.tree_util.tree_map(np.asarray, params), model))
  batch = loader.pair_batch_to_torch(examples, 'cpu')
  with torch.inference_mode():
    pred = model(batch)
    losses, metrics = model.loss_metrics_function(pred, batch)
    got = evaluator.pack_localization_metrics(metrics, losses, batch, pred)
  got = {k: v.numpy() for k, v in got.items()}
  assert set(got) == set(want)
  np.testing.assert_array_equal(got['recall_top1'], want['recall_top1'])
  for key, atol in (('error_max_meter', POSE_ATOL), ('error_max_deg',
                    DEG_ATOL), ('pose_score_max', SCORE_ATOL),
                    ('closest_map_view_meter', VIEW_ATOL),
                    ('closest_map_view_deg', 1e-3)):
    np.testing.assert_allclose(got[key], want[key], atol=atol, err_msg=key)
  np.testing.assert_allclose(got['loss'], want['loss'], rtol=LOSS_RTOL)
  for key in ('overlap', 'time_delta_days'):
    np.testing.assert_array_equal(got[key], want[key])


def test_eval_on_dataset_equals_per_example_runs():
  """Three examples at batch 2 (the last row padded and dropped) against
  the same three at batch 1."""
  cfg = configs.smoke_exhaustive()
  model = evaluate.build_model(cfg, 'cpu', seed=0)
  data = dataclasses.replace(cfg.data, evaluation_size=3, num_workers=1)
  results = {}
  for bs in (2, 1):
    with loader.get_dataset(data, bs, device='cpu') as dataset:
      results[bs] = evaluator.eval_on_dataset(model, dataset, bs)
  got, want = results[2], results[1]
  assert set(got) == set(want)
  assert all(len(v) == 3 for v in got.values())
  seed = loader.split_seed(data, 'eval')
  np.testing.assert_array_equal(got['pair_id'], [
      f'synthetic/{seed}/{i}|synthetic_query/{seed}/{i}' for i in range(3)])
  for key, value in want.items():
    if value.dtype.kind in 'Ub':
      np.testing.assert_array_equal(got[key], value, err_msg=key)
    else:
      np.testing.assert_allclose(got[key], value, atol=SCORE_ATOL,
                                 rtol=LOSS_RTOL, err_msg=key)


def test_step_context_spans_only_the_forward(monkeypatch):
  """``step_context(k)`` is open during batch k's forward and closed while
  its metrics are computed."""
  cfg = configs.smoke_exhaustive()
  model = evaluate.build_model(cfg, 'cpu', seed=0)
  data = dataclasses.replace(cfg.data, evaluation_size=3)
  inside, seen = [], []

  @contextlib.contextmanager
  def step_context(step):
    inside.append(step)
    yield
    inside.remove(step)

  def spy(name):
    call = getattr(model, name)

    def wrapped(*args, **kwargs):
      seen.append((name, tuple(inside)))
      return call(*args, **kwargs)

    return wrapped

  monkeypatch.setattr(model, 'forward', spy('forward'))
  monkeypatch.setattr(model, 'loss_metrics_function',
                      spy('loss_metrics_function'))
  with loader.get_dataset(data, 2, device='cpu') as dataset:
    evaluator.eval_on_dataset(model, dataset, 2, step_context=step_context)
  assert seen == [('forward', (0,)), ('loss_metrics_function', ()),
                  ('forward', (1,)), ('loss_metrics_function', ())]


def test_evaluate_writes_one_row_per_query(capsys, tmp_path):
  evaluate.main(['--config=smoke_eval_ransac', '--num_queries=3',
                 '--batch_size=2', '--device=cpu',
                 '--on_device_generation=true', f'--workdir={tmp_path}'])
  summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
  assert summary['generator_kind'] == 'device-torch'
  assert len(summary['build_ms']) == len(summary['forward_ms']) == 2
  assert summary['eval_seconds'] >= sum(summary['forward_ms']) / 1e3
  path = tmp_path / 'evaluation' / 'smokeville-synthetic_eval'
  assert summary['dump'] == str(path)
  results, config = evaluator.read_eval_dump(path)
  assert set(results) == {
      'error_max_meter', 'error_max_deg', 'recall_top1', 'pose_score_max',
      'overlap', 'time_delta_days', 'closest_map_view_meter',
      'closest_map_view_deg', 'loss', 'vehicle_map', 'vehicle_query',
      'pair_id'}
  assert all(len(v) == 3 for v in results.values())
  np.testing.assert_allclose(results['error_max_meter'],
                             summary['position_error_m'])
  assert list(results['vehicle_query']) == ['TREKKER'] * 3
  assert config['data_generator_kind'] == 'device-torch'
  assert config['data']['evaluation_size'] == 3
