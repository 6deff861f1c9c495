"""The port's ``evaluator.run`` against ``snap_tpu/evaluator.py:run``.

A JAX smoke experiment (``smoke_localization.py:pose_backend=exhaustive``,
flax-initialized weights) is saved with the JAX package's own checkpoint
and config functions, evaluated over two cities by JAX's ``run`` and,
exported to the port's workdir (``test_torch_recall.export_workdir``), by
the port's; the dumps agree city by city. The dump cache's protocol
checks mirror ``tests/test_viz_and_eval.py:TestDumpCacheProtocolGuard``,
and the CLI's ``--eval_config`` mode writes, reads back and diverts dumps.
"""

import contextlib
import dataclasses
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snap_tpu import evaluator as jevaluator
from snap_tpu.configs import smoke_eval_localization
from snap_tpu.configs import smoke_localization
from snap_tpu.data import loader as jloader
from snap_tpu.data import types as jtypes
from snap_tpu.models import bev_localizer as jbev_localizer
from snap_tpu.train_lib import checkpoints
from snap_tpu.utils import configs as jconfig_utils
from snap_tpu.utils import grids as jgrids
from snap_tpu_torch import configs
from snap_tpu_torch import evaluate
from snap_tpu_torch import evaluator
from snap_tpu_torch.data import loader
from test_torch_recall import export_workdir

torch.set_num_threads(2)

STEP = 3
CITIES = ('smokeville', 'smoketown')
# tests/test_torch_evaluator.py's tolerances: the pose to 1e-4 m / rad,
# scores to 1e-4, the loss to 1e-5 relative, closest views to 1e-5 m and
# 1e-3 deg (arccos).
POSE_ATOL = 1e-4
DEG_ATOL = float(np.rad2deg(POSE_ATOL))
SCORE_ATOL = 1e-4
LOSS_RTOL = 1e-5
VIEW_ATOL = 1e-5


class TestDumpCacheProtocolGuard:
  """A cached dump serves only its own protocol; a mismatched run goes to a
  protocol-qualified path and the first dump stays."""

  def _setup_workdir(self, tmp_path):
    workdir = tmp_path / 'exp'
    workdir.mkdir()
    (workdir / evaluator.CONFIG_FILE).write_text(
        json.dumps({'model_name': 'bev_localizer'}))
    full_dir = workdir / 'evaluation' / 'loc'
    evaluator.write_eval_dump(full_dir, {'error_max_meter': np.arange(8.0)},
                              {'eval_checkpoint_step': 100})
    return workdir, full_dir

  def _eval_config(self, workdir, size, step):
    ec = configs.EvalConfig(workdir=str(workdir), checkpoint_step=step)
    loader_config = dataclasses.replace(ec.data.loader, evaluation_size=size)
    return dataclasses.replace(
        ec, data=dataclasses.replace(ec.data, loader=loader_config))

  def _patch_compute(self, monkeypatch, n_examples, counter):
    def fake_get(eval_config, experiment, workdir, location, device):
      return None, contextlib.nullcontext(), {
          'eval_checkpoint_step': eval_config.checkpoint_step}

    def fake_eval(model, dataset, batch_size, generator, on_batch):
      counter.append(1)
      return {'error_max_meter': np.full(n_examples, 7.0)}

    monkeypatch.setattr(evaluator, 'get_model_and_dataset', fake_get)
    monkeypatch.setattr(evaluator, 'eval_on_dataset', fake_eval)

  def test_matching_protocol_hits_cache(self, tmp_path, monkeypatch):
    workdir, _ = self._setup_workdir(tmp_path)
    calls = []
    self._patch_compute(monkeypatch, 8, calls)
    results, _ = evaluator.run_for_location(
        'loc', self._eval_config(workdir, 8, 100))
    assert not calls
    assert len(results['error_max_meter']) == 8

  def test_mismatch_diverts_and_preserves_original(self, tmp_path,
                                                   monkeypatch):
    workdir, full_dir = self._setup_workdir(tmp_path)
    calls = []
    self._patch_compute(monkeypatch, 4, calls)
    results, _ = evaluator.run_for_location(
        'loc', self._eval_config(workdir, 4, 100))
    assert calls
    assert len(results['error_max_meter']) == 4
    kept, _ = evaluator.read_eval_dump(full_dir)
    assert len(kept['error_max_meter']) == 8
    qualified = workdir / 'evaluation' / 'loc-n4-s100'
    assert (qualified / 'results.npz').exists()
    calls.clear()
    results, _ = evaluator.run_for_location(
        'loc', self._eval_config(workdir, 4, 100))
    assert not calls
    assert len(results['error_max_meter']) == 4

  def test_unstamped_dump_fails_explicit_step_request(self, tmp_path,
                                                      monkeypatch):
    workdir, full_dir = self._setup_workdir(tmp_path)
    evaluator.write_eval_dump(full_dir, {'error_max_meter': np.arange(8.0)},
                              {})
    calls = []
    self._patch_compute(monkeypatch, 8, calls)
    evaluator.run_for_location('loc', self._eval_config(workdir, 8, 100))
    assert calls


def _jax_smoke_params(cfg):
  grid = jgrids.Grid3D.from_extent_meters((24, 32, 12), 1.0)
  meta = {'build_config': types.SimpleNamespace(
              scene_config=jtypes.SceneConfig(num_views=3)),
          'grid': grid, 'semantic_map_classes': None}
  jmodel = jbev_localizer.BEVLocalizerModel(cfg.model, meta, jnp.float32)
  port_data = configs.smoke_exhaustive().data
  examples = loader.make_pair_examples(
      loader.split_generator(port_data, 'eval'), [0], port_data)
  batch = jloader.process_batch(examples, jtypes.DataMode.PAIR_SCENE_VIEW)
  batch.pop('_host')
  rngs = {'params': jax.random.PRNGKey(0), 'sampling': jax.random.PRNGKey(1)}
  variables = jax.jit(lambda b: jmodel.flax_model.init(rngs, b, train=False))(
      batch)
  return jax.tree_util.tree_map(np.asarray, variables['params'])


@pytest.fixture(scope='module')
def smoke_runs(tmp_path_factory):
  """JAX's and the port's ``run`` over two smoke cities, same weights."""
  root = tmp_path_factory.mktemp('eval_run')
  jax_dir, port_dir = root / 'jax', root / 'port'
  cfg = smoke_localization.get_config('pose_backend=exhaustive')
  checkpoints.save_checkpoint(jax_dir, {
      'params': _jax_smoke_params(cfg),
      'global_step': np.asarray(STEP, np.int32)}, STEP)
  jconfig_utils.config_save(jax_dir, cfg)
  jeval = smoke_eval_localization.get_config()
  jeval.workdir = str(jax_dir)
  jeval.data.split = ','.join(CITIES)
  want = jevaluator.run(jeval)

  export_workdir(jax_dir, port_dir)
  ec = configs.smoke_eval_localization()
  ec = dataclasses.replace(ec, workdir=str(port_dir), data=dataclasses.replace(
      ec.data, split=','.join(CITIES), loader=dataclasses.replace(
          ec.data.loader, on_device_generation=False)))
  got = evaluator.run(ec, device='cpu')
  return want, got, ec


def test_run_equals_jax_per_city(smoke_runs):
  want, got, _ = smoke_runs
  assert set(got) == set(want) == set(CITIES)
  for city in CITIES:
    (g, g_config), (w, w_config) = got[city], want[city]
    assert set(g) == set(w), city
    assert len(g['pair_id']) == 4
    for key in ('pair_id', 'vehicle_map', 'vehicle_query', 'recall_top1',
                'overlap', 'time_delta_days'):
      np.testing.assert_array_equal(g[key], w[key], err_msg=(city, key))
    for key, atol in (('error_max_meter', POSE_ATOL),
                      ('error_max_deg', DEG_ATOL),
                      ('pose_score_max', SCORE_ATOL),
                      ('closest_map_view_meter', VIEW_ATOL),
                      ('closest_map_view_deg', 1e-3)):
      np.testing.assert_allclose(g[key], w[key], atol=atol,
                                 err_msg=(city, key))
    np.testing.assert_allclose(g['loss'], w['loss'], rtol=LOSS_RTOL)
    assert g_config['eval_checkpoint_step'] == w_config[
        'eval_checkpoint_step'] == STEP
    assert g_config['data_generator_kind'] == w_config[
        'data_generator_kind'] == 'host-numpy'
    # The merged configs: JAX's dump keeps the experiment's shuffle seed,
    # the port's the one its data ran with (the eval's data seed, 0), and
    # the port's run asked for the host generator that JAX's CPU backend
    # picks by itself.
    port = configs.from_reference(g_config)
    ref = configs.from_reference(json.loads(json.dumps(w_config.to_dict())))
    assert port == dataclasses.replace(ref, data=dataclasses.replace(
        ref.data, shuffle_seed=0, on_device_generation=False))
    assert port.data.locations.evaluation == f'{city}-synthetic_eval'


def test_second_run_reads_the_dumps(smoke_runs, monkeypatch):
  _, got, ec = smoke_runs
  monkeypatch.setattr(evaluator, 'get_model_and_dataset', None)
  again = evaluator.run(ec, device='cpu')
  for city in CITIES:
    for key, value in got[city][0].items():
      np.testing.assert_array_equal(again[city][0][key], value)
    assert again[city][1]['eval_seconds'] == got[city][1]['eval_seconds']


def test_pinned_step_must_be_the_workdirs(smoke_runs, tmp_path):
  _, _, ec = smoke_runs
  pinned = dataclasses.replace(ec, checkpoint_step=STEP + 1, tag='-other')
  with pytest.raises(ValueError, match=f'not of step {STEP + 1}'):
    evaluator.run_for_location('smokeville-synthetic_eval', pinned,
                               device='cpu')


def test_cli_writes_reads_back_and_diverts(smoke_runs, tmp_path, capsys):
  _, _, ec = smoke_runs
  workdir = tmp_path / 'exp'
  workdir.mkdir()
  for name in (evaluator.CONFIG_FILE, evaluator.PARAMS_FILE,
               evaluator.CHECKPOINT_FILE):
    (workdir / name).symlink_to(f'{ec.workdir}/{name}')
  base = ['--eval_config=smoke_eval_localization', f'--workdir={workdir}',
          '--split=smokeville', '--device=cpu']
  dump = workdir / 'evaluation' / 'smokeville-synthetic_eval' / 'results.npz'

  def lines():
    return [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith('{')]

  evaluate.main(base)
  first = lines()
  assert len(first) == 1 and first[0]['city'] == 'smokeville'
  assert first[0]['num_examples'] == 4
  assert first[0]['generator_kind'] == 'host-numpy'
  assert first[0]['eval_checkpoint_step'] == STEP
  assert first[0]['cudnn_allow_tf32'] is False
  assert first[0]['matmul_allow_tf32'] is False
  written = dump.stat().st_mtime_ns
  evaluate.main(base)
  assert lines() == first
  assert dump.stat().st_mtime_ns == written
  evaluate.main(base + ['--evaluation_size=2'])
  diverted = lines()
  assert diverted[0]['num_examples'] == 2
  assert (workdir / 'evaluation' / 'smokeville-synthetic_eval-n2-sNone'
          / 'results.npz').exists()
  assert dump.stat().st_mtime_ns == written
