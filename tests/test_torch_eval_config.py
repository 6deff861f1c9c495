"""The port's eval configs against the JAX package's.

``configs.from_reference`` on the export's ``config.yaml`` and on the
training config; ``to_reference`` read back for every named config;
``merge_eval_config`` against what ``snap_tpu/evaluator.py:
get_model_and_dataset`` builds for the export (its restore runs, no
forward; the data iterators are not started), field by field; the eval
configs against ``eval_localization.py`` and ``smoke_eval_localization.py``.
"""

import copy
import dataclasses
import json
import pathlib

import jax
import numpy as np
import pytest

from snap_tpu import evaluator as jevaluator
from snap_tpu.configs import eval_localization
from snap_tpu.configs import smoke_eval_localization
from snap_tpu.configs import train_localization
from snap_tpu.data import loader as jloader
from snap_tpu.train_lib import checkpoints
from snap_tpu.utils import configs as jconfig_utils
from snap_tpu_torch import configs

EXPORT = pathlib.Path(__file__).resolve().parents[1] / 'pretrained' / (
    'loc_full1chip_r5')
FULL1CHIP = 'scale=full1chip,pose_backend=exhaustive'


def _export_dict():
  return json.loads(json.dumps(jconfig_utils.config_load(EXPORT).to_dict()))


def _assert_fields_equal(port, ref, path=''):
  """Every field of the port's dataclass that the reference has, equal."""
  for field in dataclasses.fields(port):
    value, name = getattr(port, field.name), f'{path}{field.name}'
    if field.name not in ref:
      continue  # a port-only field, checked by the caller
    want = ref[field.name]
    if dataclasses.is_dataclass(value):
      _assert_fields_equal(value, want, name + '.')
    elif isinstance(value, tuple):
      assert value == configs._tuples(want), (name, value, want)
    else:
      assert value == want, (name, value, want)


def test_from_reference_reads_the_export():
  """The export continues the flagship run from effective step 7000
  (``train_localization.py:continue_step``): the flagship's config with
  the schedule's tail and the data seed folded with that step."""
  got = configs.from_reference(_export_dict())
  flagship = configs.train_full1chip_exhaustive()
  continued = dataclasses.replace(
      flagship,
      data=dataclasses.replace(flagship.data, shuffle_seed=1234567 + 7000),
      train=dataclasses.replace(
          flagship.train, num_training_steps=20_000 - 7000,
          lr_configs=dataclasses.replace(
              flagship.train.lr_configs, warmup_steps=100,
              start_decay_step=4000 - 7000, steps_per_cycle=16_000)))
  assert got == continued
  _assert_fields_equal(got.model, _export_dict()['model'])


def test_from_reference_reads_the_training_config():
  ref = train_localization.get_config(FULL1CHIP)
  assert configs.from_reference(ref.to_dict()) == (
      configs.train_full1chip_exhaustive())


@pytest.mark.parametrize('name', sorted(configs.CONFIGS))
def test_to_reference_reads_back(name):
  config = configs.get_config(name)
  d = json.loads(json.dumps(configs.to_reference(config)))
  assert configs.from_reference(d) == config


def test_to_reference_keys_are_the_references():
  ref = train_localization.get_config(FULL1CHIP).to_dict()
  got = json.loads(json.dumps(configs.to_reference(
      configs.train_full1chip_exhaustive())))

  def check(got, want, path):
    for key, value in got.items():
      assert key in want, f'{path}{key}'
      if isinstance(value, dict):
        check(value, want[key], f'{path}{key}.')
      else:
        assert value == json.loads(json.dumps(want[key])), f'{path}{key}'
  check(got, ref, '')


@pytest.mark.parametrize('path,value,match', [
    (('model', 'bev_mapper', 'semantic_encoder'), {'embedding_dim': 8},
     'model.bev_mapper.semantic_encoder is set'),
    (('model', 'bev_mapper', 'bev_net'), {'num_units': 2},
     'model.bev_mapper.bev_net is set'),
    (('model', 'bev_mapper_query'), {}, 'model.bev_mapper_query is set'),
    (('model', 'bev_mapper', 'streetview_encoder', 'color'), 1,
     'unknown key model.bev_mapper.streetview_encoder.color'),
    (('model_name',), 'semantic_net', 'model_name'),
    (('mesh', 'model'), 2, 'mesh.model'),
    (('data', 'name'), 'tfds', 'data.name'),
])
def test_from_reference_raises_naming_the_key(path, value, match):
  d = _export_dict()
  node = d
  for key in path[:-1]:
    node = node[key]
  node[path[-1]] = value
  with pytest.raises(ValueError, match=match):
    configs.from_reference(d)


def test_from_reference_raises_on_a_missing_key():
  d = _export_dict()
  del d['model']['num_rotations']
  with pytest.raises(ValueError, match=r"model lacks \['num_rotations'\]"):
    configs.from_reference(d)


def test_from_reference_ignores_memory_devices():
  d = _export_dict()
  sv = d['model']['bev_mapper']['streetview_encoder']
  sv['point_tile'], sv['point_tile_eval'] = 1000, 2000
  sv['image_encoder']['encoder']['checkpoint_blocks'] = True
  assert configs.from_reference(d) == configs.from_reference(_export_dict())


def _jax_merge(monkeypatch, eval_config, experiment, workdir, location,
               raw=None):
  """``get_model_and_dataset``'s merged config and data seed, its iterators
  not started (and its restore replaced by ``raw`` when given)."""
  seeds = {}
  real_get_dataset = jloader.get_dataset

  def get_dataset(**kwargs):
    seeds['shuffle_seed'] = kwargs['shuffle_seed']
    return real_get_dataset(**kwargs)

  monkeypatch.setattr(jloader, '_PrefetchIterator',
                      lambda *args, **kwargs: None)
  monkeypatch.setattr(jloader, 'get_dataset', get_dataset)
  if raw is not None:
    monkeypatch.setattr(checkpoints, 'restore_raw', lambda *a, **k: raw)
  model, params, _, dataset, config, _ = jevaluator.get_model_and_dataset(
      eval_config, experiment, workdir, location)
  return model, params, dataset, config, seeds['shuffle_seed']


def _assert_merge_equal(port, jconfig, shuffle_seed, jdataset):
  _assert_fields_equal(port.model, jconfig.model)
  _assert_fields_equal(port.data, jconfig.data)
  assert port.data.shuffle_seed == shuffle_seed
  assert port.batch_size == jconfig.batch_size
  assert port.dtype_str == 'float32'
  assert port.data.evaluation_size == jdataset.meta_data['num_eval_examples']


def test_merge_eval_config_equals_jax_on_the_export(monkeypatch):
  jeval = eval_localization.get_config('evaluation_size=256,batch_size=4')
  jeval.workdir = str(EXPORT)
  jmodel, params, jdataset, jconfig, seed = _jax_merge(
      monkeypatch, jeval, jconfig_utils.config_load(EXPORT), EXPORT,
      'zurich-synthetic_eval')
  port = configs.merge_eval_config(
      configs.eval_localization(evaluation_size=256, batch_size=4),
      configs.from_reference(_export_dict()), 'zurich-synthetic_eval')
  _assert_merge_equal(port, jconfig, seed, jdataset)
  assert port.model.do_grid_refinement and jmodel.config.do_grid_refinement
  assert jmodel.dtype == np.float32
  assert all(v.dtype == np.float32 for v in jax.tree_util.tree_leaves(params))


def test_eval_full1chip_exhaustive_equals_jax(monkeypatch, tmp_path):
  """The held-out protocol: dense refinement on, f32, as JAX's merge gives
  it."""
  jeval = eval_localization.get_config('evaluation_size=256,batch_size=4')
  jeval.workdir = str(tmp_path)
  jmodel, _, jdataset, jconfig, seed = _jax_merge(
      monkeypatch, jeval, train_localization.get_config(FULL1CHIP), tmp_path,
      'zurich-synthetic_eval', raw={'params': {}})
  port = configs.eval_full1chip_exhaustive()
  _assert_merge_equal(port, jconfig, seed, jdataset)
  assert port.model.pose_backend == 'exhaustive'
  assert port.model.do_grid_refinement and jmodel.config.do_grid_refinement
  assert port.data.locations == configs.LocationsConfig(
      'zurich-synthetic_eval', 'zurich-synthetic_eval')
  assert (port.batch_size, port.data.evaluation_size) == (4, 256)


@pytest.mark.parametrize('args', [
    '', 'evaluation_size=256,batch_size=4',
    'num_rotations=128,refinement_stages=11x1+1.25x0.125,subcell=1,tag=-x'])
def test_eval_localization_equals_jax(args):
  ref = eval_localization.get_config(args or None)
  kwargs = dict(kv.split('=') for kv in args.split(',') if kv)
  port = configs.eval_localization(**{
      k: v if k in ('tag', 'refinement_stages') else int(v)
      for k, v in kwargs.items()})
  _assert_eval_config_equal(port, ref)


def test_smoke_eval_localization_equals_jax():
  _assert_eval_config_equal(configs.smoke_eval_localization(),
                            smoke_eval_localization.get_config())


def _assert_eval_config_equal(port, ref):
  for key in ('workdir', 'checkpoint_step', 'batch_size', 'rng_seed',
              'dtype_str', 'tag', 'overwrite'):
    assert getattr(port, key) == ref[key], key
  for key in ('rng_seed', 'split', 'name_pattern'):
    assert getattr(port.data, key) == ref.data[key], key
  _assert_fields_equal(port.data.loader, ref.data.loader)
  model = ref.model.to_dict()
  assert set(port.model) == set(model)
  for key, value in port.model.items():
    want = model[key]
    assert value == (configs._tuples(want) if isinstance(want, (list, tuple))
                     else want), key


def test_merge_overrides_nested_fields():
  config = configs.smoke_exhaustive()
  merged = configs.merge(config.model, {
      'num_rotations': 8,
      'bev_mapper': {'streetview_encoder': {'top_k_view_selection': 1}}})
  assert merged.num_rotations == 8
  sv = merged.bev_mapper.streetview_encoder
  assert sv.top_k_view_selection == 1
  assert sv.feature_dim == config.model.bev_mapper.streetview_encoder.feature_dim
  assert merged.bev_mapper.aerial_encoder == (
      config.model.bev_mapper.aerial_encoder)
  with pytest.raises(ValueError, match='no field'):
    configs.merge(config.model, {'colour': 1})
  assert copy.deepcopy(config) == config  # merged a copy
