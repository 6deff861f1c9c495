"""Port parity of the aerial-only map with its own street-view query mapper
(``train_localization.py:modalities=aerial`` and ``aerial+semantic``).

The JAX package is the oracle, on the CPU as tests/conftest.py sets it up:
``BEVLocalizerModel`` of ``smoke_localization.py:pose_backend=exhaustive``
whose map mapper has no street views and whose query goes through a tiny
street-view ``bev_mapper_query`` (``tests/torch_a14.py``), its
flax-initialized weights carried over by ``convert.params_from_flax``. One
training step on the same batch, with JAX's draws injected into the port
(the query mapper's z jitter, the map's modality dropout): the map's and
the query's planes, the pose volume, its argmax (exact), the pose, the
loss, the metrics and every gradient leaf. The map scenes carry rasters
and no images, as the JAX generators make them. Tolerances:
``tests/torch_a14.py`` (those of tests/test_torch_localizer.py and
tests/test_torch_train.py).
"""

import dataclasses
import json
import math

import jax
import numpy as np
import pytest
import torch

from snap_tpu.configs import train_localization
from snap_tpu.data import device_synthetic as jds
from snap_tpu.data import synthetic as jsynthetic
from snap_tpu.data import types as jtypes
from snap_tpu_torch import configs
from snap_tpu_torch import evaluator
from snap_tpu_torch import train
from snap_tpu_torch.data import device_synthetic as ds
from snap_tpu_torch.data import loader
from snap_tpu_torch.data import types as data_types
from snap_tpu_torch.train_lib import checkpoints
from snap_tpu_torch.train_lib import trainer
import test_torch_device_synthetic as tds
import torch_a14
import torch_heads

torch.set_num_threads(2)
FULL1CHIP = 'scale=full1chip,pose_backend=exhaustive'
MAP_LESS_STREETVIEW = ['aerial', 'aerial+semantic']
# The semantic raster encoder (an R26 x2 at stride 1 over the class
# embeddings) adds its summation order to the map's plane: 1.18e-5 measured
# on one of 24,576 entries; the volume's tolerance. The volume is a mean of
# products of unit plane entries scaled by exp(temperature) = e^2, so its
# error is held to e^2 times the plane's (3.48e-5 measured).
SEMANTIC_PLANE_ATOL = torch_a14.VOLUME_ATOL
SEMANTIC_VOLUME_ATOL = math.exp(2.0) * SEMANTIC_PLANE_ATOL


@pytest.mark.parametrize('modalities', MAP_LESS_STREETVIEW)
@pytest.mark.parametrize('backend', ['exhaustive', 'ransac'])
def test_configs_are_the_references(modalities, backend):
  """``from_reference`` of the recipe at full width and of the tiny JAX
  config gives the port's; ``to_reference`` reads back."""
  args = f'modalities={modalities},scale=full1chip'
  port = configs.train_full1chip_ransac
  if backend == 'exhaustive':
    args, port = args + ',pose_backend=exhaustive', (
        configs.train_full1chip_exhaustive)
  want = port(modalities=modalities)
  ref = train_localization.get_config(args).to_dict()
  assert configs.from_reference(json.loads(json.dumps(ref))) == want
  assert configs.from_reference(json.loads(json.dumps(
      configs.to_reference(want)))) == want
  query = want.model.bev_mapper_query
  assert want.model.bev_mapper.streetview_encoder is None
  assert query.streetview_encoder.fusion.layers == (256, 256, 128)
  assert (query.aerial_encoder, query.semantic_encoder) == (None, None)
  assert not want.data.add_images and want.data.add_rasters
  smoke = torch_a14.port_config(modalities, backend)
  jcfg = torch_a14.jax_config(modalities, backend)
  assert configs.from_reference(jcfg.to_dict()).model == smoke.model
  assert not smoke.data.add_images


@pytest.fixture(scope='module', params=MAP_LESS_STREETVIEW)
def step(request):
  modalities = request.param
  return modalities, torch_a14.localizer_step(
      torch_a14.port_config(modalities), torch_a14.jax_config(modalities))


def test_map_scene_has_rasters_and_no_images(step):
  _, step = step
  assert 'images' not in step.batch['map'] and 'rasters' in step.batch['map']
  assert step.batch['query']['images'].shape[:2] == (2, 1)


def test_planes_volume_and_pose_match_jax(step):
  """The planes to ``PLANE_ATOL`` and the volume to ``VOLUME_ATOL``; with
  the semantic rasters, to ``SEMANTIC_PLANE_ATOL`` and
  ``SEMANTIC_VOLUME_ATOL``."""
  modalities, step = step
  want, pred = step.want.pred, step.got[3]
  for scene in ('map', 'query'):
    atol = torch_a14.PLANE_ATOL
    if scene == 'map' and 'semantic' in modalities:
      atol = SEMANTIC_PLANE_ATOL
    torch_a14.assert_plane_matches(pred[scene]['bev_matching'],
                                   want[scene]['bev_matching'], atol)
  assert 'streetview' in pred['query'] and 'streetview' not in pred['map']
  torch_a14.assert_dense_poses_match(
      step, SEMANTIC_VOLUME_ATOL if 'semantic' in modalities
      else torch_a14.VOLUME_ATOL)


def test_loss_and_gradients_match_jax(step):
  """Every leaf; the query mapper's street-view trunk and the map's aerial
  trunk take a gradient, and the semantic trunk where the draws keep it."""
  modalities, step = step
  got = torch_a14.assert_step_matches(step)
  assert not any(k.startswith('bev_mapper/streetview_encoder') for k in got)
  assert torch_a14.nonzero(
      got, 'bev_mapper_query/streetview_encoder/image_encoder/')
  assert torch_a14.nonzero(got, 'bev_mapper/aerial_encoder/')
  if modalities == 'aerial+semantic':
    keep = torch_heads.modality_keep(step.want.draws[0])
    assert keep.shape == (2, 2)
    if keep[1].any():
      assert torch_a14.nonzero(got, 'bev_mapper/semantic_encoder/')


def test_query_draws_follow_the_query_mapper():
  """The query's z jitter is drawn by the query mapper's range, the
  modality dropout by the map's modalities."""
  config = torch_a14.port_config('aerial+semantic')
  query = dataclasses.replace(config.model.bev_mapper_query,
                              scene_z_offset_range=(5.0, 6.0))
  mapper = dataclasses.replace(config.model.bev_mapper,
                               scene_z_offset_range=None)
  config = dataclasses.replace(config, model=dataclasses.replace(
      config.model, bev_mapper=mapper, bev_mapper_query=query))
  model = evaluator.build_model(config, 'cpu')
  draws = model.sample_draws(64, torch.Generator().manual_seed(0), 'cpu')
  assert ((draws.z_jitter >= 5.0) & (draws.z_jitter < 6.0)).all()
  assert draws.modality_keep.shape == (2, 64)
  assert draws.modality_keep.any(0).all()


def test_aerial_only_example_matches_jax():
  """A map scene without images (``add_images=False``): the device
  generator's example against JAX's ``make_example`` on JAX's draws, and
  the host generator's against JAX's host generator."""
  spec = dataclasses.replace(tds.SPEC, add_images=False,
                             add_lidar_rays=False)
  jspec = jds.Spec(**dataclasses.asdict(spec))
  mode = data_types.DataMode.PAIR_SCENE_VIEW
  jmode = jtypes.DataMode.PAIR_SCENE_VIEW
  want = [jax.tree_util.tree_map(np.asarray, jax.jit(
      lambda i: jds.make_example(jspec, jmode, 7, i))(i)) for i in range(2)]
  draws = loader.stack_examples([tds._jax_example_draws(jspec, jmode, 7, i)
                                 for i in range(2)])
  got = tds._flat(ds.make_batch(spec, mode, ds.draws_to(draws, 'cpu')))
  assert '/map/images' not in got and '/map/rasters/rgb' in got
  assert '/query/images' in got
  for i, example in enumerate(want):
    example = tds._flat(example)
    assert set(example) == set(got)
    for key, w in example.items():
      g = got[key][i]
      assert (g.shape, g.dtype) == (w.shape, w.dtype), key
      if w.dtype == bool:
        tds._assert_flips_bounded(g != w, key)
      elif 'images' in key or 'rgb' in key:
        np.testing.assert_allclose(g, w, atol=tds.IMAGE_ATOL, err_msg=key)
      else:
        np.testing.assert_allclose(g, w, atol=tds.ATOL, rtol=tds.ATOL,
                                   err_msg=key)

  data = configs.DataConfig(num_views=3, image_size=(18, 24), voxel_size=1.0)
  port = loader.make_generator(data, 11).make_example(
      2, 'pair_scene_view', add_images=False, add_rasters=True)
  ref = jsynthetic.SyntheticSceneGenerator(
      scene_config=jtypes.SceneConfig(num_views=3),
      rasters_config=jtypes.RastersConfig(resolution=1.0),
      lidar_config=jtypes.LidarConfig(), image_hw=(18, 24), voxel_size=1.0,
      seed=11).make_example(2, 'pair_scene_view', add_images=False,
                            add_rasters=True)
  flat_got = jax.tree_util.tree_leaves_with_path(port)
  flat_want = jax.tree_util.tree_leaves_with_path(ref)
  assert [p for p, _ in flat_got] == [p for p, _ in flat_want]
  assert 'images' not in port['map'] and 'images' in port['query']
  for (path, g), (_, w) in zip(flat_got, flat_want):
    np.testing.assert_array_equal(np.asarray(g), np.asarray(w),
                                  err_msg=str(path))


def test_trains_resumes_warm_starts_and_serves_from_a_workdir(tmp_path):
  """The tiny aerial-only localizer: 2 steps into a workdir, resumed to
  step 3 from its checkpoint (both mappers restored); a run warm-started
  from it adopts the map's mapper (``pretrained_mapper``) and trains with
  the query mapper frozen; ``evaluator.run`` of the first workdir reads
  ``config.json`` (the query mapper among the reference's keys) and its
  step 3."""
  config = torch_a14.port_config('aerial')
  run = tmp_path / 'run'
  train.train(config, device='cpu', workdir=str(run), stop_at_step=2)
  assert checkpoints.latest_step(run) == 2
  restored = checkpoints.restore_params(str(run))
  assert any(k.startswith('bev_mapper_query.') for k in restored)
  result = train.train(config, device='cpu', workdir=str(run),
                       stop_at_step=3)
  assert result['start_step'] == 2 and checkpoints.latest_step(run) == 3
  assert configs.read_experiment(str(run)) == config

  warm = configs.merge(config, {
      'model': {'bev_mapper': {'pretrained_path': str(run)}},
      'train': {'optimizer_configs': configs.OptimizerConfig(
          freeze_params_reg_exp=r'bev_mapper_query/')}})
  model = evaluator.build_model(warm, 'cpu', seed=5)
  frozen = {n: p.detach().clone() for n, p in model.named_parameters()
            if n.startswith('bev_mapper_query.')}
  out = train.train(warm, device='cpu', workdir=str(tmp_path / 'warm'),
                    model=model, stop_at_step=1)
  state = out['state']
  final = checkpoints.restore_params(str(run))
  for name, value in state.model.named_parameters():
    if name in frozen:
      assert torch.equal(value.detach(), frozen[name]), name
  # The learning rate of step 1 is the constant 1e-3: the adopted map
  # encoder moved from the checkpoint's weights by one step, no more.
  aerial = 'bev_mapper.aerial_encoder.encoder.conv_root.weight'
  delta = (dict(state.model.named_parameters())[aerial].detach()
           - final[aerial]).abs().max()
  assert 0 < float(delta) <= 1.5e-3

  eval_config = dataclasses.replace(
      configs.smoke_eval_localization(), workdir=str(run))
  (city, (results, record)), = evaluator.run(eval_config,
                                             device='cpu').items()
  assert record['eval_checkpoint_step'] == 3
  assert results['error_max_meter'].shape == (4,)
  assert np.isfinite(results['error_max_meter']).all()


@pytest.mark.parametrize('key,value', [
    ('pooling_impl', 'gather'), ('pooling_impl', 'scan'),
    ('fusion_add_minmax', True), ('fusion_use_variance', False),
    ('do_weighted_fusion', False),
    ('depth_mlp', {'layers': [torch_a14.DIM, torch_a14.DIM],
                   'activation': 'relu', 'apply_input_activation': False})])
def test_the_lifts_other_forms_raise_naming_their_item(key, value):
  """A14's fifth item, ported: ``from_reference`` reads each of the lift's
  other settings on the query mapper (a depth MLP with unweighted fusion),
  and the port builds the model and runs a forward on the CPU, whose query
  plane is finite and partly valid; only an unknown ``pooling_impl``
  raises, naming the value."""
  d = configs.to_reference(torch_a14.port_config('aerial'))
  encoder = d['model']['bev_mapper_query']['streetview_encoder']
  encoder[key] = value
  if key == 'depth_mlp':
    encoder['do_weighted_fusion'] = False
  config = configs.from_reference(json.loads(json.dumps(d)))
  assert getattr(config.model.bev_mapper_query.streetview_encoder, key) == (
      configs.MLPConfig(layers=(torch_a14.DIM,) * 2) if key == 'depth_mlp'
      else value)
  model = evaluator.build_model(config, 'cpu')
  _, batch = torch_a14.pair_batches(config)
  with torch.no_grad():
    pred = trainer.loss_and_metrics(model, batch, False)[3]
  plane = pred['query']['bev_matching']
  assert torch.isfinite(plane.features).all()
  assert plane.valid.any() and not plane.valid.all()
  encoder['pooling_impl'] = 'fused'
  with pytest.raises(ValueError, match="pooling_impl='fused'"):
    configs.from_reference(d)
