"""Port parity: ResNet, FPN, street-view encoder and layers against flax.

Flax params are initialized, perturbed with numpy noise (so GroupNorm scales
and biases are not the identity), and carried into the port by
``convert.params_from_flax``; both sides run in f32 on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import helpers  # tests/helpers.py: the JAX suite's tiny configs
from snap_tpu.configs import defaults
from snap_tpu.data import loader as jloader
from snap_tpu.data import types as jtypes
from snap_tpu.models import image_encoder as jimage_encoder
from snap_tpu.models import layers as jlayers
from snap_tpu.models import resnet as jresnet
from snap_tpu.models import streetview_encoder as jstreetview_encoder
from snap_tpu_torch import configs
from snap_tpu_torch import convert
from snap_tpu_torch.data import loader
from snap_tpu_torch.models import image_encoder
from snap_tpu_torch.models import layers
from snap_tpu_torch.models import resnet
from snap_tpu_torch.models import streetview_encoder

torch.set_num_threads(2)

# f32 convolutions on both sides; summation orders differ, and the errors
# grow through the normalizations of the trunk.
ATOL, RTOL = 1e-4, 1e-4


def _perturbed(params, seed):
  rng = np.random.default_rng(seed)
  return jax.tree_util.tree_map(
      lambda p: np.asarray(p) + 0.1 * rng.normal(size=p.shape).astype(
          np.float32), params)


def _load(module, params):
  module.load_state_dict(convert.params_from_flax(params, module))
  return module.eval()


def _images(seed, shape):
  return np.random.default_rng(seed).random(shape).astype(np.float32)


@pytest.mark.parametrize('skip_root', [False, True])
def test_resnet_tiny_matches_flax(skip_root):
  jcfg = defaults.resnet('tiny')
  jcfg.skip_root_block = skip_root
  images = _images(0, (2, 32, 40, 3))
  jmodel = jresnet.ResNetV2(jcfg, jnp.float32)
  params = _perturbed(
      jmodel.init(jax.random.PRNGKey(0), images)['params'], 1)
  want = jmodel.apply({'params': params}, images)
  model = _load(resnet.ResNetV2(configs.ResNetConfig(
      depth=(1, 1), limit_num_blocks=2, skip_root_block=skip_root),
      torch.float32), params)
  with torch.no_grad():
    got = model(torch.from_numpy(images))
  for stage in ('stage1', 'stage2'):
    units = want[stage]
    np.testing.assert_allclose(got[stage].numpy(),
                               np.asarray(units[max(units)]),
                               atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize('shape', [(1, 3, 4, 2), (2, 5, 7, 3)])
def test_upsample_matches_jax_image_resize(shape):
  """x2 bilinear resize: F.interpolate equals jax.image.resize, borders too."""
  x = np.random.default_rng(2).normal(size=shape).astype(np.float32)
  b, h, w, c = shape
  want = jax.image.resize(jnp.asarray(x), (b, 2 * h, 2 * w, c), 'bilinear')
  got = image_encoder.upsample2x(torch.from_numpy(x))
  np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                             rtol=1e-6)


@pytest.mark.parametrize('skip_root', [False, True])
def test_image_encoder_tiny_matches_flax(skip_root):
  jcfg = defaults.image_encoder()
  jcfg.encoder = defaults.resnet('tiny')
  jcfg.encoder.skip_root_block = skip_root
  jcfg.output_dim = 16
  images = _images(3, (2, 36, 44, 3))
  jmodel = jimage_encoder.ImageEncoder(jcfg, jnp.float32)
  params = _perturbed(
      jmodel.init(jax.random.PRNGKey(0), images)['params'], 4)
  want = jmodel.apply({'params': params}, images)
  model = _load(image_encoder.ImageEncoder(configs.ImageEncoderConfig(
      encoder=configs.ResNetConfig(depth=(1, 1), limit_num_blocks=2,
                                   skip_root_block=skip_root),
      output_dim=16), torch.float32), params)
  with torch.no_grad():
    got = model(torch.from_numpy(images))
  assert tuple(got.strides) == tuple(want.strides)
  for g, w in zip(got.features, want.features):
    np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, rtol=RTOL)


def test_streetview_encoder_matches_flax():
  """Views folded into the batch, proj 32+8 split, stream lift, fusion MLP."""
  data_cfg = configs.DataConfig(num_views=3, image_size=(36, 48),
                                voxel_size=1.0, add_rasters=False)
  ex = loader.make_pair_examples(loader.make_generator(data_cfg, 5), [0, 1],
                                 data_cfg)
  rng = np.random.default_rng(6)
  xyz = np.stack(np.meshgrid(np.arange(0.5, 24), np.arange(0.5, 32),
                             np.arange(0.5, 4), indexing='ij'), -1)
  xyz = np.broadcast_to(xyz[None], (2, *xyz.shape)).astype(np.float32)
  xyz = xyz + rng.uniform(-0.1, 0.1, xyz.shape).astype(np.float32)

  jcfg = helpers.tiny_streetview_encoder(32)
  jbatch = jloader.process_batch(
      {'map': ex['map'], 'query': ex['query'],
       'T_query2map': ex['T_query2map'], 'pair_id': ex['pair_id']},
      jtypes.DataMode.PAIR_SCENE_VIEW)['map']
  jdata = dict(images=ex['map']['images'], camera=jbatch['camera'],
               T_view2scene=jbatch['T_view2scene'], xyz_query=xyz)
  jmodel = jstreetview_encoder.StreetViewEncoder(jcfg, jnp.float32)
  params = _perturbed(
      jmodel.init(jax.random.PRNGKey(0), jdata)['params'], 7)
  want = jmodel.apply({'params': params}, jdata)['feature_volume']

  cfg = configs.smoke_exhaustive().model.bev_mapper.streetview_encoder
  model = _load(streetview_encoder.StreetViewEncoder(cfg, torch.float32),
                params)
  tdata = loader.pair_batch_to_torch(ex, 'cpu')['map']
  tdata['xyz_query'] = torch.from_numpy(xyz)
  with torch.no_grad():
    got = model(tdata)['feature_volume']
  np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
  assert got.valid.any() and not got.valid.all()
  np.testing.assert_allclose(got.features.numpy(), np.asarray(want.features),
                             atol=ATOL, rtol=RTOL)


def test_mlp_matches_flax():
  jcfg = defaults.mlp()
  jcfg.layers = (24, 8)
  jcfg.apply_input_activation = True
  x = np.random.default_rng(8).normal(size=(3, 5, 12)).astype(np.float32)
  jmodel = jlayers.MLP(jcfg, jnp.float32)
  params = _perturbed(jmodel.init(jax.random.PRNGKey(0), x)['params'], 9)
  want = jmodel.apply({'params': params}, x)
  model = _load(layers.MLP(configs.MLPConfig(
      layers=(24, 8), apply_input_activation=True), 12, torch.float32),
                params)
  with torch.no_grad():
    got = model(torch.from_numpy(x))
  np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                             rtol=1e-5)


def test_masked_layers_match_jax():
  """masked_mean / masked_softmax / normalize, empty masks and zero rows."""
  rng = np.random.default_rng(10)
  x = rng.normal(size=(4, 6)).astype(np.float32)
  mask = rng.random((4, 6)) < 0.5
  mask[0] = False  # an empty mask
  x[1] = 0.0  # a zero vector for normalize
  pairs = [
      (jlayers.masked_mean(jnp.asarray(x), jnp.asarray(mask), -1),
       layers.masked_mean(torch.from_numpy(x), torch.from_numpy(mask), -1)),
      (jlayers.masked_softmax(jnp.asarray(x), jnp.asarray(mask), -1),
       layers.masked_softmax(torch.from_numpy(x), torch.from_numpy(mask), -1)),
      (jlayers.normalize(jnp.asarray(x)),
       layers.normalize(torch.from_numpy(x))),
  ]
  for want, got in pairs:
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=1e-6)
