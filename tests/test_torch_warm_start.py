"""Warm starts against the JAX package's ``update_pretrained_variables``.

The mapper's hook (``pretrained_path``: an experiment workdir) on the smoke
model, read from a JAX export's flat ``params.npz`` and from a port
checkpoint, against JAX's hook reading the same weights from its orbax
checkpoint; both raise when no pretrained weight could be used. The
ResNet's BiT ``.npz`` hook as ``tests/test_trainer.py`` drives it, with a
synthetic file, against JAX's.
"""

import copy
import dataclasses
import json
import logging
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snap_tpu.configs import defaults
from snap_tpu.configs import smoke_localization
from snap_tpu.data import loader as jloader
from snap_tpu.data import types as jtypes
from snap_tpu.models import bev_localizer as jbev_localizer
from snap_tpu.models import resnet as jresnet
from snap_tpu.train_lib import checkpoints as jcheckpoints
from snap_tpu.train_lib import trainer as jtrainer
from snap_tpu.utils import configs as jconfig_utils
from snap_tpu.utils import grids as jgrids
from snap_tpu_torch import configs
from snap_tpu_torch import convert
from snap_tpu_torch import evaluate
from snap_tpu_torch.data import loader
from snap_tpu_torch.models import resnet
from snap_tpu_torch.train_lib import checkpoints
from snap_tpu_torch.train_lib import optimizers
from snap_tpu_torch.train_lib import trainer

torch.set_num_threads(2)


def _jax_model(pretrained_path=None):
  cfg = smoke_localization.get_config('pose_backend=exhaustive')
  if pretrained_path is not None:
    cfg.model.bev_mapper.pretrained_path = str(pretrained_path)
  grid = jgrids.Grid3D.from_extent_meters((24, 32, 12), 1.0)
  meta = {'build_config': types.SimpleNamespace(
              scene_config=jtypes.SceneConfig(num_views=3)),
          'grid': grid, 'semantic_map_classes': None}
  return cfg, jbev_localizer.BEVLocalizerModel(cfg.model, meta, jnp.float32)


@pytest.fixture(scope='module')
def flax_params():
  """Two flax inits of the smoke model (keys 0 and 1) as numpy trees."""
  _, jmodel = _jax_model()
  cfg = configs.smoke_train_exhaustive()
  examples = loader.make_train_examples(loader.make_generator(cfg.data, 3),
                                        0, 2, cfg.data)
  jbatch = jloader.process_batch(copy.deepcopy(examples),
                                 jtypes.DataMode.PAIR_SCENE_VIEW)
  jbatch.pop('_host')
  init = jax.jit(lambda r, b: jmodel.flax_model.init(
      {'params': r, 'sampling': jax.random.PRNGKey(9)}, b, train=False))
  return [jax.tree_util.tree_map(np.asarray, init(jax.random.PRNGKey(k),
                                                  jbatch)['params'])
          for k in (0, 1)]


def _port_model(params, pretrained_path=None):
  cfg = configs.smoke_train_exhaustive()
  if pretrained_path is not None:
    cfg = configs.merge(cfg, {'model': {'bev_mapper': {
        'pretrained_path': str(pretrained_path)}}})
  model = evaluate.build_model(cfg, 'cpu')
  model.load_state_dict(convert.params_from_flax(params, model))
  return cfg, model


def _jax_workdir(path, params):
  """An orbax checkpoint of ``params`` with its config, as JAX's trainer
  leaves a workdir."""
  cfg, _ = _jax_model()
  jconfig_utils.config_save(path, cfg)
  jcheckpoints.save_checkpoint(path, {'params': params}, 12500)


def _jax_updated(jax_dir, params):
  _, jmodel = _jax_model(jax_dir)
  return convert.flatten_params(jax.tree_util.tree_map(
      np.asarray, jtrainer.update_pretrained_variables(
          jmodel.flax_model, {'params': params})['params']))


def _write_export(path, params, config, step=12500):
  """The port's JAX-format workdir: flat params, config.json, the step."""
  path.mkdir(parents=True, exist_ok=True)
  np.savez(path / 'params.npz', **convert.flatten_params(params))
  (path / 'config.json').write_text(json.dumps(configs.to_reference(config)))
  (path / 'checkpoint.json').write_text(json.dumps({'step': step}))


@pytest.mark.parametrize('source', ['export', 'checkpoint'])
def test_mapper_warm_start_equals_jax(tmp_path, flax_params, source):
  """The mapper takes the pretrained run's weights, the temperature keeps
  its own: as JAX's ``update_pretrained_variables`` leaves them."""
  init, pretrained = flax_params
  # JAX reads the same weights from its orbax checkpoint.
  _jax_workdir(tmp_path / 'jax', pretrained)
  want = _jax_updated(tmp_path / 'jax', init)
  port_dir = tmp_path / 'port'
  if source == 'export':
    _write_export(port_dir, pretrained, configs.smoke_train_exhaustive())
  else:
    cfg, model = _port_model(pretrained)
    state = trainer.create_train_state(
        model, optimizers.get_optimizer(cfg.train, model), 0)
    checkpoints.save_checkpoint(port_dir, state, 12500)
  _, model = _port_model(init, port_dir)
  assert trainer.update_pretrained_variables(model) == len(
      [k for k in want if k.startswith('bev_mapper/')])
  got = convert.flax_from_torch(dict(model.named_parameters()), model)
  assert set(got) == set(want)
  flat_pretrained = convert.flatten_params(pretrained)
  flat_init = convert.flatten_params(init)
  for key, value in want.items():
    np.testing.assert_array_equal(got[key], value, err_msg=key)
    source_tree = flat_pretrained if key.startswith('bev_mapper/') else (
        flat_init)
    np.testing.assert_array_equal(got[key], source_tree[key], err_msg=key)


def test_warm_start_raises_when_no_weight_is_used(tmp_path, flax_params):
  """Pretrained weights that match no parameter: both packages raise."""
  init, _ = flax_params
  stray = {'bev_mapper': {'no_such_layer': {'kernel': np.ones((2, 2),
                                                              np.float32)}}}
  _jax_workdir(tmp_path / 'jax', stray)
  with pytest.raises(ValueError) as jax_error:
    _jax_updated(tmp_path / 'jax', init)
  _write_export(tmp_path / 'port', stray, configs.smoke_train_exhaustive())
  _, model = _port_model(init, tmp_path / 'port')
  with pytest.raises(ValueError) as port_error:
    trainer.update_pretrained_variables(model)
  assert str(port_error.value) == str(jax_error.value) == (
      'Could not load any pre-trained weight, all were left unused.')


def test_mapper_hook_needs_a_mapper_subtree(tmp_path, flax_params):
  init, _ = flax_params
  _write_export(tmp_path, {'temperature': np.float32(1.0)},
                configs.smoke_train_exhaustive())
  _, model = _port_model(init, tmp_path)
  with pytest.raises(ValueError, match='No parameters for BEVMapper'):
    trainer.update_pretrained_variables(model)


def test_mapper_warns_on_a_config_difference(tmp_path, flax_params, caplog):
  """``bev_mapper.py:112-119``: the pretrained run's mapper config against
  this one's, from the workdir's ``config.json``."""
  init, pretrained = flax_params
  other = configs.merge(configs.smoke_train_exhaustive(), {'model': {
      'bev_mapper': {'scene_z_offset': 3.0}}})
  _write_export(tmp_path, pretrained, other)
  _, model = _port_model(init, tmp_path)
  with caplog.at_level(logging.WARNING):
    trainer.update_pretrained_variables(model)
  assert 'scene_z_offset: (4.0, 3.0)' in caplog.text


def test_resnet_bit_npz_hook_equals_jax(tmp_path):
  """``tests/test_trainer.py:173``'s synthetic BiT file (big_vision keys,
  one behind a 'resnet/' scope, one unused) through both hooks and both
  ``update_pretrained_variables``."""
  jcfg = defaults.resnet('tiny')
  jmodel = jresnet.ResNetV2(jcfg, jnp.float32)
  variables = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
  params = jax.tree_util.tree_map(np.asarray, variables['params'])
  kernel = params['root_block']['conv_root']['kernel'] * 0 + 0.5
  scale = params['block1']['unit01']['gn1']['scale'] * 0 + 2.0
  conv1 = params['block1']['unit01']['conv1']['kernel'] * 0 - 1.0
  flat = {'root_block/conv_root/kernel': kernel,
          'block1/unit01/gn1/scale': scale,
          'resnet/block1/unit01/conv1/kernel': conv1,
          'head/kernel': np.ones((3, 3), np.float32)}
  path = str(tmp_path / 'bit.npz')
  np.savez(path, **flat)
  jcfg2 = copy.deepcopy(jcfg)
  jcfg2.pretrained_path = path
  want = convert.flatten_params(jax.tree_util.tree_map(
      np.asarray, jtrainer.update_pretrained_variables(
          jresnet.ResNetV2(jcfg2.lock(), jnp.float32), variables)['params']))
  port_cfg = configs.ResNetConfig(depth=(1, 1), limit_num_blocks=2,
                                  pretrained_path=path)
  model = resnet.ResNetV2(port_cfg, torch.float32)
  model.load_state_dict(convert.params_from_flax(params, model))
  hooked = model.load_pretrained_variables()
  assert set(hooked) == {'root_block.conv_root.weight',
                         'block1.unit01.gn1.scale',
                         'block1.unit01.conv1.weight', 'head.weight'}
  assert trainer.update_pretrained_variables(model) == 3
  got = convert.flax_from_torch(dict(model.named_parameters()), model)
  assert set(got) == set(want)
  for key, value in want.items():
    np.testing.assert_array_equal(got[key], value, err_msg=key)
  np.testing.assert_array_equal(got['root_block/conv_root/kernel'], kernel)
  np.testing.assert_array_equal(got['block1/unit01/conv1/kernel'], conv1)


def test_train_warm_starts_a_continuation(tmp_path, flax_params, caplog):
  """``trainer.train`` on a fresh workdir applies the warm start, and a
  resumed one restores its checkpoint instead."""
  init, pretrained = flax_params
  _write_export(tmp_path / 'export', pretrained,
                configs.smoke_train_exhaustive())
  cfg = configs.merge(configs.smoke_train_exhaustive(), {
      'model': {'bev_mapper': {'pretrained_path': str(tmp_path / 'export')}},
      'train': {'xprof': False}})
  model = evaluate.build_model(cfg, 'cpu')
  seen = []
  with caplog.at_level(logging.INFO):
    with loader.get_dataset(cfg.data, cfg.batch_size, device='cpu') as data:
      trainer.train(cfg, model, data, tmp_path / 'run', num_steps=1,
                    on_step=lambda i, out: seen.append(
                        {n: p.detach().clone()
                         for n, p in model.named_parameters()}))
  assert 'Updating 62 variable(s) from pretrained weights.' in caplog.text
  caplog.clear()
  flat = convert.flatten_params(pretrained)
  first = convert.flax_from_torch(seen[0], model)
  # One Adam step at lr 1e-3 moves a weight by at most ~1e-3: the step
  # started from the export's mapper, not from the seeded one.
  for key, value in flat.items():
    if key.startswith('bev_mapper/'):
      np.testing.assert_allclose(first[key], value, atol=1.1e-3, rtol=0,
                                 err_msg=key)
  assert any(not np.array_equal(first[k], flat[k]) for k in flat)
  with caplog.at_level(logging.INFO):
    with loader.get_dataset(cfg.data, cfg.batch_size, device='cpu',
                            start_step=1) as data:
      out = trainer.train(cfg, evaluate.build_model(cfg, 'cpu'), data,
                          tmp_path / 'run', num_steps=1)
  assert out['start_step'] == 1 and 'Restored checkpoint at step 1' in (
      caplog.text)
  assert 'pretrained weights' not in caplog.text
