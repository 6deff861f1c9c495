"""The trunk's rematerialization (``ResNetConfig.checkpoint_blocks`` /
``checkpoint_units``) and the three-stage, width-2 trunk of R152x2.

- A width-2 trunk through its third stage at a small depth, ``(1, 2, 2)``,
  and its FPN over the three levels (in-channels 512/1024/2048, stride 16),
  in f32 on the CPU: forward and every parameter's gradient against flax's
  ``nn.remat`` of the same config, for each combination of the two flags;
  and against the port's own trunk without remat, bit for bit. The crop to
  ``ceil(input / stride)`` keeps the lift's stack shape (180x240 is padded
  to 192x240, not 192x256).
- A ``{data: 1, model: 2}`` step over gloo (``tests/torch_parallel_ranks.py``)
  on the tiny localizer whose street-view trunk rematerializes: the same
  loss and gradients, bit for bit, as the step without remat (the
  recomputed units repeat their all-gathers in the backward).
- The full R152x2 trunk (172.4M parameters) on one 64x64 image against flax.
"""

import dataclasses
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_a14
import torch_parallel_ranks as ranks
from snap_tpu.configs import defaults
from snap_tpu.models import image_encoder as jimage_encoder
from snap_tpu.models import resnet as jresnet
from snap_tpu_torch import configs
from snap_tpu_torch import convert
from snap_tpu_torch import evaluator
from snap_tpu_torch.models import image_encoder
from snap_tpu_torch.models import resnet

torch.set_num_threads(2)

# tests/test_torch_encoders.py's tolerances (f32 convolutions on both
# sides, their summation orders differ).
ATOL, RTOL = 1e-4, 1e-4
# Each gradient leaf against its largest entry, as tests/test_torch_train.py
# holds the localizer's.
GRAD_RTOL_OF_MAX = 1e-4
# The full R152x2 trunk at flax's init: 47 units of pre-activation
# residuals grow the stream to ~400, and the summation orders' differences
# with it; measured 1.5e-4 of a stage's largest entry at the third stage.
DEEP_RTOL_OF_MAX = 1e-3
# 2 ranks of the model axis; the tiny model's widths of 32 and 64 sharded
# (tests/test_torch_tensor_parallel.py).
MIN_DIM = 16

REMAT = [(False, False), (True, False), (False, True), (True, True)]


def _trunk(blocks: bool, units: bool) -> configs.ResNetConfig:
  return configs.ResNetConfig(width=2, depth=(1, 2, 2), limit_num_blocks=3,
                              checkpoint_blocks=blocks,
                              checkpoint_units=units)


def _jax_encoder(blocks: bool, units: bool):
  jcfg = defaults.image_encoder()
  jcfg.encoder = defaults.resnet('tiny')  # a tuple of stage depths
  jcfg.encoder.width = 2
  jcfg.encoder.depth = (1, 2, 2)
  jcfg.encoder.limit_num_blocks = 3
  jcfg.encoder.checkpoint_blocks = blocks
  jcfg.encoder.checkpoint_units = units
  jcfg.output_dim = 16
  return jimage_encoder.ImageEncoder(jcfg, jnp.float32)


def _port_encoder(blocks: bool, units: bool, params):
  model = image_encoder.ImageEncoder(configs.ImageEncoderConfig(
      encoder=_trunk(blocks, units), output_dim=16), torch.float32)
  model.load_state_dict(convert.params_from_flax(params, model))
  return model


# Two images at a multiple of the stride of 16: padding would make
# constant regions, whose max-pool ties the two packages route apart in
# the backward (the crop is tested below).
IMAGES = np.random.default_rng(0).random((2, 48, 64, 3)).astype(np.float32)


def _weights(shapes):
  rng = np.random.default_rng(1)
  return [rng.normal(size=s).astype(np.float32) for s in shapes]


@pytest.fixture(scope='module')
def flax_case():
  """Flax's features and gradients of a weighted sum of them, perturbed
  params (so GroupNorm's scales and biases are not the identity), for each
  remat combination."""
  jmodel = _jax_encoder(False, False)
  rng = np.random.default_rng(2)
  params = jax.tree_util.tree_map(
      lambda p: np.asarray(p) + 0.1 * rng.normal(size=p.shape).astype(
          np.float32),
      jmodel.init(jax.random.PRNGKey(0), IMAGES)['params'])
  shapes = [f.shape for f in jmodel.apply({'params': params},
                                          IMAGES).features]
  weights = _weights(shapes)
  out = {}
  for blocks, units in REMAT:
    jmodel = _jax_encoder(blocks, units)

    def loss(p):
      pyramid = jmodel.apply({'params': p}, IMAGES)
      return sum((f * w).sum() for f, w in zip(pyramid.features, weights))

    features = jmodel.apply({'params': params}, IMAGES)
    grads = jax.jit(jax.grad(loss))(params)
    out[blocks, units] = (
        [np.asarray(f) for f in features.features], features.strides,
        convert.flatten_params(jax.tree_util.tree_map(np.asarray, grads)))
  return params, weights, out


def _port_run(blocks, units, params, weights):
  model = _port_encoder(blocks, units, params)
  pyramid = model(torch.from_numpy(IMAGES))
  loss = sum((f * torch.from_numpy(w)).sum()
             for f, w in zip(pyramid.features, weights))
  names = [n for n, _ in model.named_parameters()]
  grads = torch.autograd.grad(loss, [p for _, p in model.named_parameters()])
  return model, pyramid, dict(zip(names, grads))


@pytest.mark.parametrize('blocks,units', REMAT)
def test_remat_trunk_and_fpn_match_flax(flax_case, blocks, units):
  params, weights, out = flax_case
  want_features, want_strides, want_grads = out[blocks, units]
  model, pyramid, grads = _port_run(blocks, units, params, weights)
  assert tuple(pyramid.strides) == tuple(want_strides) == (
      (16, 16), (8, 8), (4, 4))
  for got, want in zip(pyramid.features, want_features):
    np.testing.assert_allclose(got.detach().numpy(), want, atol=ATOL,
                               rtol=RTOL)
  got = convert.flax_from_torch(grads, model)
  assert set(got) == set(want_grads)
  for key, want in want_grads.items():
    np.testing.assert_allclose(
        got[key], want, atol=GRAD_RTOL_OF_MAX * float(np.abs(want).max()),
        rtol=0, err_msg=key)


@pytest.mark.parametrize('blocks,units', REMAT[1:])
def test_remat_equals_the_plain_trunk_bit_for_bit(flax_case, blocks, units):
  """The recomputed forward gives the first's bits: features and every
  gradient equal the trunk's without remat; without autograd, no remat."""
  params, weights, _ = flax_case
  _, plain, plain_grads = _port_run(False, False, params, weights)
  model, pyramid, grads = _port_run(blocks, units, params, weights)
  for got, want in zip(pyramid.features, plain.features):
    assert torch.equal(got, want)
  for name, want in plain_grads.items():
    assert torch.equal(grads[name], want), name
  with torch.no_grad():
    again = model(torch.from_numpy(IMAGES))
  for got, want in zip(again.features, plain.features):
    assert torch.equal(got, want)


def test_remat_follows_the_reference_rule(monkeypatch):
  """``checkpoint_units`` wraps each unit; ``checkpoint_blocks`` the root
  block, and each stage whole only where its units are not wrapped
  (``snap_tpu/models/resnet.py:180-187``); nothing while autograd does not
  record."""
  wrapped = []
  real = resnet.checkpoint.checkpoint

  def record(module, *args, **kwargs):
    wrapped.append(type(module).__name__)
    return real(module, *args, **kwargs)

  monkeypatch.setattr(resnet.checkpoint, 'checkpoint', record)
  x = torch.rand(1, 32, 32, 3)
  want = {(False, False): [],
          (True, False): ['RootBlock'] + ['ResNetStage'] * 3,
          (False, True): ['ResidualUnit'] * 5,
          (True, True): ['RootBlock'] + ['ResidualUnit'] * 5}
  for (blocks, units), names in want.items():
    model = resnet.ResNetV2(_trunk(blocks, units), torch.float32)
    wrapped.clear()
    with torch.no_grad():
      model(x)
    assert not wrapped
    model(x)
    assert wrapped == names, (blocks, units)
  skip = resnet.ResNetV2(dataclasses.replace(
      _trunk(True, False), skip_root_block=True), torch.float32)
  wrapped.clear()
  skip(x)
  assert wrapped == ['ResNetStage'] * 3


def test_three_level_fpn_keeps_the_lift_stack_shape():
  """R152x2's FPN over 180x240 views: stride 16 pads to 192x240 (not
  192x256), lateral in-channels 2048/1024/512, and the finest level is
  cropped back to 45x60, the stack R50's FPN gives."""
  model = image_encoder.ImageEncoder(configs.ImageEncoderConfig(
      encoder=dataclasses.replace(configs.resnet('R152x2'),
                                  depth=(1, 1, 1)), output_dim=8),
                                     torch.float32)
  assert model.max_stride == 16
  assert model.encoder.out_channels == [512, 1024, 2048]
  assert [getattr(model.decoder, f'{i}_skip_conv').weight.shape[1]
          for i in range(3)] == [2048, 1024, 512]
  padded = image_encoder.pad_to_multiple(torch.zeros(1, 180, 240, 3), 16)
  assert tuple(padded.shape[1:3]) == (192, 240)
  with torch.no_grad():
    pyramid = model(torch.rand(1, 180, 240, 3))
  assert [tuple(f.shape[1:3]) for f in pyramid.features] == [
      (12, 15), (23, 30), (45, 60)]
  assert tuple(pyramid.strides[-1]) == (4, 4)


def _remat_config(on: bool) -> configs.Config:
  config = dataclasses.replace(torch_a14.port_config(), batch_size=2)
  trunk = config.model.bev_mapper.streetview_encoder.image_encoder.encoder
  return configs.merge(config, {'model': {'bev_mapper': {
      'streetview_encoder': {'image_encoder': {'encoder': dataclasses.replace(
          trunk, checkpoint_blocks=on, checkpoint_units=on)}}}}})


def test_model_axis_step_with_remat_equals_without(tmp_path):
  """``{data: 1, model: 2}`` on 2 gloo ranks: the step with the street-view
  trunk rematerialized (each unit's sharded convolutions gathered again in
  the backward) equals the step without, loss and every gradient slice bit
  for bit, on each rank."""
  plain = _remat_config(False)
  state_dict = evaluator.build_model(plain, 'cpu', seed=0).state_dict()
  _, batch = torch_a14.pair_batches(plain)
  runs = {}
  for on in (False, True):
    out = tmp_path / f'remat{int(on)}'
    out.mkdir()
    ranks.run_ranks(ranks.tp_step_rank, 2, str(out), _remat_config(on),
                    state_dict, [batch], [None], 1,
                    {'data': 1, 'model': 2}, MIN_DIM)
    runs[on] = [torch.load(out / f'rank{r}.pt', weights_only=False)
                for r in range(2)]
    shutil.rmtree(out)
  trunk = 'bev_mapper.streetview_encoder.image_encoder.encoder.'
  for plain_rank, remat_rank in zip(runs[False], runs[True]):
    assert plain_rank[2], 'nothing sharded'
    assert any(name.startswith(trunk) for name in plain_rank[2])
    want, got = plain_rank[0][0], remat_rank[0][0]
    assert got['loss'] == want['loss']
    assert got['logs'] == want['logs']
    assert set(got['grads']) == set(want['grads'])
    for name, grad in want['grads'].items():
      assert torch.equal(got['grads'][name], grad), name


def test_r152x2_trunk_matches_flax():
  """The reference's largest trunk through its third stage on one 64x64
  image, at flax's init: each stage's output."""
  jmodel = jresnet.ResNetV2(defaults.resnet('R152x2'), jnp.float32)
  x = np.random.default_rng(3).random((1, 64, 64, 3)).astype(np.float32)
  variables = jax.jit(jmodel.init)(jax.random.PRNGKey(0), x)
  want = jax.jit(jmodel.apply)(variables, x)
  model = resnet.ResNetV2(configs.resnet('R152x2'), torch.float32)
  model.load_state_dict(convert.params_from_flax(
      jax.tree_util.tree_map(np.asarray, variables['params']), model))
  del variables
  assert sum(p.numel() for p in model.parameters()) == 172_428_416
  assert model.blocks == [3, 8, 36]
  with torch.no_grad():
    got = model(torch.from_numpy(x))
  assert list(got) == ['stage1', 'stage2', 'stage3']
  for stage, value in got.items():
    units = want[stage]
    w = np.asarray(units[max(units)])
    np.testing.assert_allclose(
        value.numpy(), w, rtol=0,
        atol=DEEP_RTOL_OF_MAX * float(np.abs(w).max()), err_msg=stage)
