"""Port parity of the semantic BEV head (``models/semantic_net.py``).

The JAX package is the oracle, on the CPU as tests/conftest.py sets it up:
``SemanticNetModel`` of ``configs/smoke_semantics.py`` on a single-scene
batch of the host generator, its flax-initialized weights carried over by
``convert.params_from_flax``, the forward at ``train=True`` with JAX's
modality dropout and flips injected into the port. Held: the logits, the
losses and metrics, every gradient leaf against ``jax.grad``, the labels
exactly, the balancing weights alone; under ``stop_mapper_gradients``
every mapper leaf's gradient is 0 in both. The ``resnet_stage`` decoder is
held on one plane given to both packages: end to end, its GroupNorms of
one- or two-channel groups amplify the mapper's rounding (1.7e-6 of the
plane's largest entry) to 1.45e-5 of the area loss, past ``LOSS_RTOL``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snap_tpu.configs import smoke_semantics as jsmoke_semantics
from snap_tpu.models import semantic_net as jsemantic_net
from snap_tpu_torch import configs
from snap_tpu_torch import convert
from snap_tpu_torch import evaluate
from snap_tpu_torch import evaluator
from snap_tpu_torch import train
from snap_tpu_torch.data import types as data_types
from snap_tpu_torch.models import bev_mapper
from snap_tpu_torch.models import semantic_net
import helpers
import torch_heads

torch.set_num_threads(2)
# JAX's key of the forward's draws: it drops the aerial plane of one
# example and flips both axes of one, one axis of the other.
SAMPLING_KEY = 3
PLANE_SEED = 1


def _configs(**changes):
  """The port's ``smoke_semantics`` and the JAX model config, with the
  same ``changes`` to the model."""
  config = configs.smoke_semantics()
  config = configs.merge(config, {'model': changes})
  jconfig = jsmoke_semantics.get_config().model
  for key, value in changes.items():
    setattr(jconfig, key, value)
  return config, jconfig


def _run(monkeypatch, **changes):
  config, jconfig = _configs(**changes)
  jmodel = jsemantic_net.SemanticNetModel(
      jconfig, torch_heads.jax_meta(config), jnp.float32)
  jbatch, batch = torch_heads.single_scene_batches(config)
  want = torch_heads.jax_step(jmodel, jbatch, True, monkeypatch, SAMPLING_KEY)
  keep, flips = want.draws  # the mapper's modality dropout, then the flips
  model = torch_heads.port_model(config, want.params)
  injected = bev_mapper.TrainDraws(
      z_jitter=None, modality_keep=torch_heads.modality_keep(keep),
      flips=torch.as_tensor(flips.copy()))
  got = torch_heads.port_step(model, batch, True, draws=injected,
                              relu_sides=want.relu_sides)
  return dict(want=(want.loss, want.losses, want.metrics, want.pred,
                    want.grads), got=got,
              model=model, jmodel=jmodel, batch=batch, jbatch=jbatch,
              draws=(keep, flips))


@pytest.fixture(scope='module')
def whole(request):
  """The MLP decoder, every leaf trained."""
  with pytest.MonkeyPatch.context() as mp:
    return _run(mp)


@pytest.fixture(scope='module')
def cut(request):
  """The MLP decoder under ``stop_mapper_gradients``."""
  with pytest.MonkeyPatch.context() as mp:
    return _run(mp, stop_mapper_gradients=True)


def test_smoke_config_is_the_references():
  ref = configs.from_reference(jsmoke_semantics.get_config().to_dict())
  assert ref.model == configs.smoke_semantics().model
  assert ref.model_name == 'semantic_net'


def test_draws_drop_a_plane_and_flip(whole):
  keep, flips = whole['draws']
  assert keep.shape == (2, 2) and flips.shape == (2, 2)
  assert not torch_heads.modality_keep(keep).all()
  assert flips.any() and not flips.all()


@pytest.mark.parametrize('run', ['whole', 'cut'])
def test_logits_match_jax(run, request):
  r = request.getfixturevalue(run)
  jpred = r['want'][3]
  pred = r['got'][3]
  for key in ('logits_areas', 'logits_objects_exclusive',
              'logits_objects_independent'):
    want = np.asarray(jpred[key])
    got = pred[key].detach().numpy()
    assert got.shape == want.shape, key
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=torch_heads.LOSS_RTOL,
                               atol=torch_heads.LOSS_RTOL * scale,
                               err_msg=key)
  np.testing.assert_array_equal(pred['bev_features'].valid.numpy(),
                                np.asarray(jpred['bev_features'].valid))


@pytest.mark.parametrize('run', ['whole', 'cut'])
def test_losses_and_metrics_match_jax(run, request):
  r = request.getfixturevalue(run)
  loss, losses, metrics, _, _ = r['want']
  got_loss, got_losses, got_metrics, _, _ = r['got']
  torch_heads.assert_losses_match(got_loss, got_losses, loss, losses)
  torch_heads.assert_metrics_match(got_metrics, metrics)


@pytest.mark.parametrize('run', ['whole', 'cut'])
def test_gradients_match_jax(run, request):
  r = request.getfixturevalue(run)
  got = torch_heads.assert_grads_match(r['got'][4], r['model'], r['want'][4])
  mapper = torch_heads.leaves_under(got, 'bev_mapper/')
  zero = [k for k in mapper if not np.abs(got[k]).max() > 0]
  want_zero = [k for k in mapper if not np.abs(r['want'][4][k]).max() > 0]
  assert zero == want_zero
  if run == 'cut':
    # The backward stops at the mapper's output: its leaves get 0 in both.
    assert zero == mapper
  else:
    # Only the matching head, which the semantic head does not read.
    assert zero == ['bev_mapper/matching_proj/kernel',
                    'bev_mapper/matching_proj/bias']


def test_labels_match_jax_exactly(whole):
  """Area labels and validity, exclusive object labels with the void
  class, independent masks and the building/tree transfer."""
  model, jmodel = whole['model'], whole['jmodel']
  rasters = whole['batch']['rasters']
  jrasters = whole['jbatch']['rasters']
  masks = model.transfer_labels_from_pcm(rasters['gt_semantics'],
                                         rasters['semantics'])
  jmasks = jmodel.transfer_labels_from_pcm(
      jnp.asarray(jrasters['gt_semantics']), jnp.asarray(
          jrasters['semantics']))
  np.testing.assert_array_equal(masks.numpy(), np.asarray(jmasks))
  config = model.config
  for got, want in [
      (model._create_exclusive_labels(masks, config.area_classes),
       jmodel.create_area_labels(jmasks)),
      (model.create_object_labels(masks), jmodel.create_object_labels(jmasks)),
      (model._create_exclusive_labels(masks, ('crosswalk', 'line')),
       jmodel._create_exclusive_labels(jmasks, ('crosswalk', 'line'))),
  ]:
    for g, w in zip(got, want):
      np.testing.assert_array_equal(g.numpy(), np.asarray(w))
  labels_excl = model.create_object_labels(masks)[0]
  void = len(config.object_classes_exclusive)
  assert (labels_excl == void).any() and (labels_excl < void).any()


@pytest.mark.parametrize('binary', [False, True])
def test_balancing_weights_match_jax(binary):
  frequencies = dict(configs.OBJECT_FREQUENCIES)
  classes = ('fence', 'pole', 'tree', 'void')
  got = semantic_net.balancing_weights(frequencies, classes, binary)
  want = jsemantic_net.balancing_weights(frequencies, classes, binary)
  for g, w in zip(got if binary else (got,), want if binary else (want,)):
    assert g.dtype == torch.float32
    np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_pack_evaluation_metrics_match_jax(whole):
  _, losses, metrics, jpred, _ = whole['want']
  _, got_losses, got_metrics, pred, _ = whole['got']
  want = whole['jmodel'].pack_evaluation_metrics(
      metrics, losses, whole['jbatch'], jpred)
  got = whole['model'].pack_evaluation_metrics(
      got_metrics, got_losses, whole['batch'], pred)
  assert set(got) == set(want)
  for key, value in want.items():
    if key.startswith('gt_counts/'):
      np.testing.assert_array_equal(got[key].numpy(), np.asarray(value))
    else:
      np.testing.assert_allclose(got[key].detach().numpy(), value,
                                 rtol=torch_heads.METRIC_TOL,
                                 atol=torch_heads.METRIC_TOL, err_msg=key)


def test_semantic_mapper_under_the_head_raises_c22(whole):
  """The reference builds the head's mapper without the rasters' classes
  (``semantic_net.py:131-135``): it fails there, and the port raises."""
  modalities = 'streetview+aerial+semantic'
  mapper = configs.smoke_train_exhaustive(
      modalities=modalities).model.bev_mapper
  config = configs.merge(configs.smoke_semantics(),
                         {'model': {'bev_mapper': mapper}})
  with pytest.raises(ValueError, match='C22'):
    evaluator.build_model(config, 'cpu')
  jconfig = jsmoke_semantics.get_config().model
  jconfig.bev_mapper = helpers.tiny_bev_mapper(modalities.split('+'))
  jmodel = jsemantic_net.SemanticNetModel(
      jconfig, torch_heads.jax_meta(config), jnp.float32)
  with pytest.raises(TypeError):
    jmodel.flax_model.init({'params': jax.random.PRNGKey(0)},
                           whole['jbatch'], train=False)


def test_resnet_stage_decoder_matches_jax():
  """``train_semantics``'s decoder (2 units here, width 16) on one plane:
  flax's ``nn.Sequential`` of a Dense, a ResNet stage and an MLP, its
  params carried over as ``decoder/layers_{0,1,3}``; the logits and the
  gradient of every leaf for a fixed cotangent."""
  config, jconfig = _configs(decoder_type='resnet_stage', resnet_num_units=2)
  jmodel = jsemantic_net.SemanticNetModel(
      jconfig, torch_heads.jax_meta(config), jnp.float32)
  jbatch, _ = torch_heads.single_scene_batches(config)
  params = jax.jit(lambda b: jmodel.flax_model.init(
      {'params': jax.random.PRNGKey(0)}, b, train=False))(jbatch)['params']
  plane = np.random.default_rng(PLANE_SEED).normal(
      size=(2, 24, 32, 32)).astype(np.float32)
  cotangent = np.random.default_rng(1).normal(size=(2, 24, 32, 12)).astype(
      np.float32)
  module = jmodel.flax_model.bind({'params': params})
  decoder = module.decoder.clone(parent=None)

  def loss_fn(p):
    logits = decoder.apply({'params': p}, jnp.asarray(plane))
    return (logits * cotangent).sum(), logits

  (_, want), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
      params['decoder'])
  model = torch_heads.port_model(config, jax.tree_util.tree_map(np.asarray,
                                                                params))
  relu_inputs = []
  relu = torch.nn.functional.relu

  def recorded_relu(x, inplace=False):
    relu_inputs.append(x.detach())
    return relu(x, inplace=inplace)
  with pytest.MonkeyPatch.context() as mp:
    mp.setattr(torch.nn.functional, 'relu', recorded_relu)
    logits = model.decoder(torch.as_tensor(plane))
  # A relu input within rounding of 0 may take the other side in JAX and
  # move one term of a gradient (ROADMAP C11): this plane has none.
  margin = min(float(x.abs().min() / x.abs().max()) for x in relu_inputs)
  assert len(relu_inputs) == 7 and margin > 1e-6, margin
  want = np.asarray(want)
  np.testing.assert_allclose(
      logits.detach().numpy(), want, rtol=torch_heads.LOSS_RTOL,
      atol=torch_heads.LOSS_RTOL * float(np.abs(want).max()))
  named = dict(model.decoder.named_parameters())
  got = torch.autograd.grad((logits * torch.as_tensor(cotangent)).sum(),
                            list(named.values()))
  flat = convert.flatten_params(jax.tree_util.tree_map(np.asarray, grads))
  torch_heads.assert_grads_match(dict(zip(named, got)), model.decoder, flat)
  assert {k.split('/')[0] for k in flat} == {'layers_0', 'layers_1',
                                             'layers_3'}


def test_evaluate_semantics_writes_and_reads_its_dump(tmp_path):
  """``evaluate --eval_config=eval_semantics`` on a trained workdir: one
  row per example of the head's packed metrics, ``gt_counts/*`` and the
  loss, the protocol's config beside them; a second run reads the dump.
  The occupancy head has no packing function, as in the reference."""
  workdir = tmp_path / 'semantics'
  train.train(configs.smoke_semantics(), 1, 'cpu', workdir=str(workdir))
  evaluate.main(['--eval_config=eval_semantics', f'--workdir={workdir}',
                 '--evaluation_size=3', '--batch_size=2', '--device=cpu'])
  dump = workdir / 'evaluation' / 'val-synthetic_semantics_eval'
  results, record = evaluator.read_eval_dump(dump)
  assert record['model_name'] == 'semantic_net'
  assert record['eval_checkpoint_step'] == 1
  assert record['data']['locations']['evaluation'] == (
      'val-synthetic_semantics_eval')
  counts = [k for k in results if k.startswith('gt_counts/')]
  assert len(counts) == len(data_types.DEFAULT_GT_SEMANTIC_CLASSES)
  assert 'semantics/accuracy' in results and 'loss' in results
  for key, value in results.items():
    assert len(value) == 3, key
    if value.dtype.kind == 'f':
      assert np.isfinite(value).all(), key
  again, _ = evaluator.run_for_location(
      'val-synthetic_semantics_eval', dataclasses.replace(
          configs.eval_semantics(evaluation_size=3, batch_size=2),
          workdir=str(workdir)), device='cpu')
  for key, value in results.items():
    np.testing.assert_array_equal(again[key], value)

  occupancy = tmp_path / 'occupancy'
  train.train(configs.smoke_occupancy(), 1, 'cpu', workdir=str(occupancy))
  with pytest.raises(ValueError, match='No packing function'):
    evaluator.run(dataclasses.replace(
        configs.eval_semantics(evaluation_size=2, batch_size=2),
        workdir=str(occupancy)), device='cpu')
