"""``configs.train_localization`` (the reference's ``train_localization.py``
with its ``image_encoder``, ``scale`` and ``pose_backend`` arguments)
against the JAX package.

- Every trunk x scale x backend, and the aerial-only map at ``full`` and
  ``small``: the port's config field by field against
  ``train_localization.get_config``, and ``from_reference`` of the JAX
  config is the port's.
- ``train_full1chip_*`` are ``train_localization`` at ``scale=full1chip``;
  ``continue_step`` raises at another scale as JAX's does; the remat flags
  go through ``to_reference`` and back; the eval CLI takes an eval
  config's arguments after a colon.
- The BiT hook on a three-stage trunk with a full four-stage checkpoint
  and its head: the port and JAX take the same leaves and leave the same
  ones unused.
- The ``scale=small`` localizer (0.4 m voxels, 90x120 views, the tiny
  trunk; batch 1 and 3 views to stay fast) against JAX's in f32 on the
  CPU: each scene's lifted volume and planes, the pose volume, the best
  index (exact) and the loss, at ``tests/test_torch_localizer.py``'s
  tolerances.
"""

import argparse
import copy
import dataclasses
import itertools
import json
import logging
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_train as ttrain
import torch_heads
from snap_tpu.configs import defaults
from snap_tpu.configs import train_localization
from snap_tpu.data import loader as jloader
from snap_tpu.data import types as jtypes
from snap_tpu.models import bev_localizer as jbev_localizer
from snap_tpu.models import pose_exhaustive_voting as jpev
from snap_tpu.models import resnet as jresnet
from snap_tpu.ops import view_scan as jview_scan
from snap_tpu.train_lib import trainer as jtrainer
from snap_tpu.utils import geometry as jgeometry
from snap_tpu.utils import grids as jgrids
from snap_tpu_torch import configs
from snap_tpu_torch import convert
from snap_tpu_torch import evaluate
from snap_tpu_torch import evaluator
from snap_tpu_torch.data import loader
from snap_tpu_torch.models import pose_exhaustive_voting as pev
from snap_tpu_torch.models import resnet
from snap_tpu_torch.train_lib import trainer
from snap_tpu_torch.utils import grids

torch.set_num_threads(2)

# tests/test_torch_localizer.py's tolerances (f32 on both sides; the
# planes and volumes differ by summation order through the encoders and
# the FFT) scaled to the recipe's widths: its 128-wide fusion and 32-wide
# matching plane over 144,000 points, and a volume entry that sums 2,400
# query cells x 32 channels (the smoke model's, 384 x 16). Measured: the
# matching plane 1.5e-5, the volume 3.3e-5. tests/test_torch_train.py's
# loss tolerance.
PLANE_ATOL = 5e-5
VOLUME_ATOL = 1e-4
LOSS_RTOL = 1e-5
# The lifted volume before the vertical pooling, as
# tests/test_torch_encoders.py holds the street-view encoder's.
LIFT_ATOL, LIFT_RTOL = 1e-4, 1e-4

TRUNKS = ('R50', 'R152x2', 'R101', 'R26', 'tiny')
CASES = [f'image_encoder={trunk},scale={scale},pose_backend={backend}'
         for trunk, scale, backend in itertools.product(
             TRUNKS, configs.SCALES, configs.POSE_BACKENDS)]
CASES += ['modalities=aerial,scale=full', 'modalities=aerial,scale=small']


@pytest.mark.parametrize('args', CASES)
def test_train_localization_equals_jax(args):
  ref = train_localization.get_config(args)
  port = configs.get_config(f'train_localization:{args}')
  ttrain._assert_fields_equal(port.model, ref.model)
  ttrain._assert_fields_equal(port.data, ref.data)
  ttrain._assert_fields_equal(port.train, ref)
  assert (port.dtype_str, port.batch_size) == (ref.dtype_str, ref.batch_size)
  assert configs.from_reference(json.loads(json.dumps(ref.to_dict()))) == port
  street = (port.model.bev_mapper_query or port.model.bev_mapper
            ).streetview_encoder.image_encoder.encoder
  assert street == configs.resnet(args.split(',')[0].partition('=')[2]
                                  if 'image_encoder' in args else 'R50')


@pytest.mark.parametrize('name,backend', [
    ('train_full1chip_exhaustive', 'exhaustive'),
    ('train_full1chip_ransac', 'ransac')])
def test_full1chip_configs_are_train_localization(name, backend):
  for kwargs in ({}, dict(modalities='aerial', bev_net=1, batch_size=4,
                          pretrained_resnet='bit.npz')):
    assert configs.get_config(name, **kwargs) == configs.train_localization(
        pose_backend=backend, scale='full1chip', **kwargs)


@pytest.mark.parametrize('scale', ['full', 'small'])
def test_continue_step_needs_full1chip(scale, tmp_path):
  args = f'scale={scale},continue_step=12500,pretrained_mapper={tmp_path}'
  with pytest.raises(ValueError, match='only defined for scale=full1chip'):
    train_localization.get_config(args)
  with pytest.raises(ValueError, match='only defined for scale=full1chip'):
    configs.get_config(f'train_localization:{args}')


@pytest.mark.parametrize('blocks,units', list(itertools.product(
    (False, True), repeat=2)))
def test_remat_flags_round_trip(blocks, units):
  """``to_reference`` writes ``checkpoint_blocks`` / ``checkpoint_units``
  and ``from_reference`` reads them back (they were read and dropped
  before the port honoured them)."""
  config = configs.train_localization(image_encoder='R26', scale='small')
  encoder = dataclasses.replace(configs.resnet('R26'),
                                checkpoint_blocks=blocks,
                                checkpoint_units=units)
  config = configs.merge(config, {'model': {'bev_mapper': {
      'streetview_encoder': {'image_encoder': {'encoder': encoder}}}}})
  d = json.loads(json.dumps(configs.to_reference(config)))
  written = d['model']['bev_mapper']['streetview_encoder']['image_encoder'][
      'encoder']
  assert (written['checkpoint_blocks'], written['checkpoint_units']) == (
      blocks, units)
  back = configs.from_reference(d)
  assert back == config
  got = back.model.bev_mapper.streetview_encoder.image_encoder.encoder
  assert (got.checkpoint_blocks, got.checkpoint_units) == (blocks, units)


def test_eval_cli_takes_an_eval_configs_arguments():
  args = argparse.Namespace(
      eval_config='eval_localization:evaluation_size=256,batch_size=8',
      on_device_generation='auto', evaluation_size=None, split='zurich',
      workdir='w', checkpoint_step=None, batch_size=None, tag='',
      overwrite=False)
  got = evaluate.eval_config_from_args(args)
  want = configs.eval_localization(evaluation_size=256, batch_size=8)
  assert got.data.loader.evaluation_size == 256
  assert (got.batch_size, got.model) == (8, want.model)
  with pytest.raises(ValueError, match='Unknown eval config'):
    evaluate.eval_config_from_args(argparse.Namespace(
        **{**vars(args), 'eval_config': 'eval_nothing'}))


@pytest.mark.parametrize('args', ['scale=small,pose_backend=exhaustive',
                                  'scale=full,image_encoder=R152x2'])
def test_an_experiment_is_served_at_its_scale(args, tmp_path):
  """``read_experiment`` + ``merge_eval_config``: the held-out protocol of
  a ``scale=small`` or an R152x2 workdir runs its scene geometry and
  trunk."""
  ref = train_localization.get_config(args)
  (tmp_path / 'config.json').write_text(json.dumps(ref.to_dict()))
  experiment = configs.read_experiment(str(tmp_path))
  merged = configs.merge_eval_config(
      configs.eval_localization(evaluation_size=256, batch_size=8),
      experiment, 'zurich-synthetic_eval')
  for key in configs.EXPERIMENT_DATA_KEYS:
    want = ref.data[key]
    assert getattr(merged.data, key) == (
        tuple(want) if isinstance(want, tuple) else want), key
  assert merged.model.bev_mapper == experiment.model.bev_mapper
  assert (merged.batch_size, merged.data.evaluation_size) == (8, 256)


def test_bit_hook_takes_jaxs_leaves_from_a_full_checkpoint(tmp_path, caplog):
  """A BiT ``.npz`` with four stages and a head (big_vision's keys, the
  head's and the pre-head norm's)
  warm-starts a three-stage width-2 trunk: the port takes the leaves
  JAX's ``update_pretrained_variables`` takes, leaves the same ones unused
  (logged, not raised), and ends with JAX's weights."""
  jcfg = defaults.resnet('tiny')
  jcfg.width = 2
  jcfg.depth = (1, 1, 1)
  jcfg.limit_num_blocks = 3
  x = jnp.zeros((1, 32, 32, 3))
  variables = jresnet.ResNetV2(jcfg, jnp.float32).init(
      jax.random.PRNGKey(0), x)
  full = copy.deepcopy(jcfg)
  full.depth = (1, 1, 1, 1)
  full.limit_num_blocks = 4
  bit = convert.flatten_params(jax.tree_util.tree_map(
      lambda p: np.asarray(p) + 1.0, jresnet.ResNetV2(full, jnp.float32).init(
          jax.random.PRNGKey(1), x)['params']))
  npz = dict(bit)
  npz.update({'head/kernel': np.ones((1024, 10), np.float32),
              'head/bias': np.zeros((10,), np.float32),
              'norm-pre-head/scale': np.ones((1024,), np.float32)})
  path = str(tmp_path / 'bit.npz')
  np.savez(path, **npz)
  jcfg.pretrained_path = path
  jmodel = jresnet.ResNetV2(jcfg, jnp.float32)
  want = convert.flatten_params(jax.tree_util.tree_map(
      np.asarray, jtrainer.update_pretrained_variables(
          jmodel, variables)['params']))
  jax_hooked = convert.flatten_params(jmodel.apply(
      variables, method=jmodel.load_pretrained_variables)['params'])
  jax_unused = set(jax_hooked) - set(want)
  assert any(key.startswith('block4/') for key in jax_unused)
  for key, value in want.items():  # every trunk leaf from the file
    np.testing.assert_array_equal(value, bit[key], err_msg=key)

  model = resnet.ResNetV2(configs.ResNetConfig(
      width=2, depth=(1, 1, 1), limit_num_blocks=3, pretrained_path=path),
                          torch.float32)
  model.load_state_dict(convert.params_from_flax(
      jax.tree_util.tree_map(np.asarray, variables['params']), model))
  hooked = model.load_pretrained_variables()
  unused = set(hooked) - set(model.state_dict())
  assert {convert.flax_path(name) for name in unused} == jax_unused
  with caplog.at_level(logging.INFO):
    assert trainer.update_pretrained_variables(model) == len(want)
  assert 'will not be used' in caplog.text
  got = convert.flax_from_torch(dict(model.named_parameters()), model)
  assert set(got) == set(want)
  for key, value in want.items():
    np.testing.assert_array_equal(got[key], value, err_msg=key)


def _small_configs():
  """The ``scale=small`` recipe with the tiny street-view trunk (and a
  tiny aerial trunk), 3 views, batch 1, f32: the port's and JAX's."""
  args = 'scale=small,pose_backend=exhaustive,image_encoder=tiny'
  jcfg = train_localization.get_config(args)
  jcfg.model.bev_mapper.aerial_encoder.encoder = defaults.resnet('tiny')
  jcfg.model.bev_mapper.aerial_encoder.encoder.skip_root_block = True
  jcfg.data.num_views = 3
  config = configs.get_config(f'train_localization:{args}', batch_size=1)
  aerial = dataclasses.replace(
      config.model.bev_mapper.aerial_encoder,
      encoder=dataclasses.replace(configs.resnet('tiny'),
                                  skip_root_block=True))
  config = configs.merge(config, {
      'model': {'bev_mapper': {'aerial_encoder': aerial}},
      'data': {'num_views': 3}})
  config = dataclasses.replace(config, dtype_str='float32')
  assert config.data.voxel_size == 0.4
  assert config.data.image_size == (90, 120)
  return config, jcfg


def _port_template_uv(num_rotations: int, grid) -> np.ndarray:
  """The port's coarse template coordinates ``[R, H * W, 2]`` on a JAX
  grid (``pose_exhaustive_voting.exhaustive_pose_voting``'s angles)."""
  angles = torch.linspace(0, 2 * math.pi, num_rotations + 1)[:-1]
  port_grid = grids.Grid2D(tuple(grid.extent), float(grid.cell_size))
  return pev.template_points(angles, port_grid, 1).numpy().reshape(
      num_rotations, -1, 2)


def _shared_coordinates(real):
  """JAX's ``sample_query_templates`` reading the coarse templates at the
  port's coordinates (ROADMAP C29); the rest of it as it is."""

  def sample(features, valid, num_rotations, grid):
    if not isinstance(num_rotations, int):
      return real(features, valid, num_rotations, grid)
    uv = jnp.asarray(_port_template_uv(num_rotations, grid))
    t_feats, t_valid = jview_scan.interpolate_patch_2d(
        features, valid, uv.reshape(-1, 2))
    t_feats = t_feats.reshape(*uv.shape[:2], -1)
    t_valid = t_valid.reshape(uv.shape[:2])
    t_feats = jnp.where(t_valid[..., None], t_feats, 0)
    h, w = grid.extent
    return (t_feats.reshape(num_rotations, h, w, -1),
            t_valid.reshape(num_rotations, h, w))
  return sample


@pytest.fixture(scope='module')
def small_case():
  """Both packages' forward (``train=False``) and loss on one batch of the
  small recipe, JAX's coarse templates read at the port's coordinates."""
  config, jcfg = _small_configs()
  examples = loader.make_train_examples(loader.make_generator(config.data, 5),
                                        0, 1, config.data)
  jbatch = jloader.process_batch(copy.deepcopy(examples),
                                 jtypes.DataMode.PAIR_SCENE_VIEW)
  jbatch.pop('_host')
  jmodel = jbev_localizer.BEVLocalizerModel(
      jcfg.model, torch_heads.jax_meta(config), jnp.float32)
  rngs = {'params': jax.random.PRNGKey(0), 'sampling': jax.random.PRNGKey(1)}
  params = jax.jit(
      lambda b: jmodel.flax_model.init(rngs, b, train=False))(jbatch)[
          'params']

  def forward(p, b):
    pred = jmodel.flax_model.apply(
        {'params': p}, b, train=False,
        rngs={'sampling': jax.random.PRNGKey(2)})
    losses, _ = jmodel.loss_metrics_function(pred, b, p)
    return pred, losses

  with pytest.MonkeyPatch.context() as mp:
    mp.setattr(jpev, 'sample_query_templates',
               _shared_coordinates(jpev.sample_query_templates))
    want, jlosses = jax.jit(forward)(params, jbatch)
  model = evaluator.build_model(config, 'cpu', state_dict=convert.
                                params_from_flax(jax.tree_util.tree_map(
                                    np.asarray, params)))
  batch = loader.pair_batch_to_torch(examples, 'cpu')
  with torch.no_grad():
    loss, losses, _, got = trainer.loss_and_metrics(model, batch, False)
  return want, jlosses, got, float(loss), config


def test_small_template_coordinates_are_jaxs_to_ulps():
  """C29: on the 0.4 m query grid the port's template coordinates are
  JAX's to a few ulps, and no more."""
  config, _ = _small_configs()
  grid = jgrids.Grid3D.from_extent_meters(
      (24, 32, 12), config.data.voxel_size).bev()
  angles = jnp.linspace(0, 2 * jnp.pi, 64, endpoint=False)
  rotated = jgeometry.Transform2D.from_radians(angles, jnp.zeros((64, 2)))
  center = jpev.get_grid_center_transform(grid)
  xy = grid.index_to_xyz(grid.grid_index()).reshape(-1, 2)
  want = np.asarray((center @ rotated @ center.inv).transform(xy) /
                    grid.cell_size)
  got = _port_template_uv(64, grid)
  np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max(),
                             rtol=0)


@pytest.mark.parametrize('scene', ['map', 'query'])
def test_small_lift_and_planes_match_jax(small_case, scene):
  want, _, got, _, config = small_case
  w, g = want[scene]['streetview']['feature_volume'], got[scene][
      'streetview']['feature_volume']
  if scene == 'map':
    assert tuple(g.features.shape[1:4]) == (60, 80, 30)  # 144,000 points
  np.testing.assert_array_equal(g.valid.numpy(), np.asarray(w.valid))
  assert g.valid.any()
  np.testing.assert_allclose(g.features.numpy(), np.asarray(w.features),
                             atol=LIFT_ATOL, rtol=LIFT_RTOL)
  # The fused plane at the lift's tolerance, the normalized matching
  # plane at the localizer test's.
  for key, atol, rtol in (('bev_features', LIFT_ATOL, LIFT_RTOL),
                          ('bev_matching', PLANE_ATOL, 0)):
    w, g = want[scene][key], got[scene][key]
    np.testing.assert_array_equal(g.valid.numpy(), np.asarray(w.valid))
    np.testing.assert_allclose(g.features.numpy(), np.asarray(w.features),
                               atol=atol, rtol=rtol, err_msg=key)
  assert config.model.num_rotations == 64


def test_small_pose_volume_and_loss_match_jax(small_case):
  want, jlosses, got, loss, _ = small_case
  w = np.asarray(want['scores_pose_volume'])
  g = got['scores_pose_volume'].numpy()
  assert g.shape == w.shape and g.shape[1] == 64
  np.testing.assert_array_equal(np.isfinite(g), np.isfinite(w))
  fin = np.isfinite(w)
  np.testing.assert_allclose(g[fin], w[fin], atol=VOLUME_ATOL)
  np.testing.assert_array_equal(got['best_volume_index'].numpy(),
                                np.asarray(want['best_volume_index']))
  assert np.isfinite(loss)
  assert loss == pytest.approx(float(np.asarray(jlosses['total'])[0]),
                               rel=LOSS_RTOL)
