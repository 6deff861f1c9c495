"""Port parity of the semantic modality: the semantic raster encoder and
the localizer whose map fuses street views, the aerial raster and the
semantic rasters (``train_localization.py:modalities=streetview+aerial+
semantic``).

The JAX package is the oracle, on the CPU as tests/conftest.py sets it up:
``SemanticRasterEncoder`` and ``BEVLocalizerModel`` of
``smoke_localization.py:pose_backend=exhaustive`` with the tests' tiny
three-modality mapper (``tests/helpers.py:tiny_bev_mapper``), their
flax-initialized weights carried over by ``convert.params_from_flax``
(``nn.Embed``'s tables among them). The localizer runs at ``train=True``
with JAX's z jitter and ``[3, B]`` modality dropout injected into the
port; its loss, metrics and every gradient leaf are held to ``jax.grad``.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snap_tpu.configs import smoke_localization
from snap_tpu.data import loader as jloader
from snap_tpu.data import types as jtypes
from snap_tpu.models import bev_localizer as jbev_localizer
from snap_tpu.models import semantic_raster_encoder as jsre
from snap_tpu_torch import configs
from snap_tpu_torch import convert
from snap_tpu_torch.data import loader
from snap_tpu_torch.data import types as data_types
from snap_tpu_torch.models import bev_mapper
from snap_tpu_torch.models import semantic_raster_encoder
import helpers
import torch_heads

torch.set_num_threads(2)
MODALITIES = 'streetview+aerial+semantic'
# JAX's key of the forward's draws: it drops a modality of one example and
# keeps the semantic plane of at least one.
SAMPLING_KEY = 2


def _jax_config():
  cfg = smoke_localization.get_config('pose_backend=exhaustive')
  cfg.model.bev_mapper = helpers.tiny_bev_mapper(MODALITIES.split('+'))
  cfg.data.add_rasters = True
  return cfg


def _pair_batches(config):
  examples = loader.make_train_examples(loader.make_generator(config.data, 3),
                                        0, config.batch_size, config.data)
  jbatch = jloader.process_batch(copy.deepcopy(examples),
                                 jtypes.DataMode.PAIR_SCENE_VIEW)
  jbatch.pop('_host')
  return jbatch, loader.pair_batch_to_torch(examples, 'cpu')


@pytest.fixture(scope='module')
def localizer():
  config = configs.smoke_train_exhaustive(modalities=MODALITIES)
  jmodel = jbev_localizer.BEVLocalizerModel(
      _jax_config().model, torch_heads.jax_meta(config), jnp.float32)
  jbatch, batch = _pair_batches(config)
  with pytest.MonkeyPatch.context() as mp:
    want = torch_heads.jax_step(jmodel, jbatch, True, mp, SAMPLING_KEY)
  (keep,), (z_jitter,) = want.draws, want.uniforms
  model = torch_heads.port_model(config, want.params)
  draws = bev_mapper.TrainDraws(
      z_jitter=torch.as_tensor(z_jitter.copy()),
      modality_keep=torch_heads.modality_keep(keep))
  got = torch_heads.port_step(model, batch, True, draws=draws,
                              relu_sides=want.relu_sides)
  return dict(want=want, got=got, model=model, keep=draws.modality_keep)


def test_configs_are_the_references():
  want = configs.from_reference(_jax_config().to_dict()).model
  assert configs.smoke_train_exhaustive(modalities=MODALITIES).model == want
  semantic = configs.train_full1chip_exhaustive(
      modalities=MODALITIES).model.bev_mapper.semantic_encoder
  assert semantic == configs.SemanticRasterEncoderConfig()
  assert (semantic.encoder.encoder.width, semantic.encoder.encoder.depth,
          semantic.embedding_dim) == (2, 26, 8)
  # Without street views the map has no images and the query a street-view
  # mapper of its own (tests/test_torch_query_mapper.py).
  aerial = configs.train_full1chip_exhaustive(modalities='aerial+semantic')
  assert aerial.model.bev_mapper.semantic_encoder == semantic
  assert aerial.model.bev_mapper_query.streetview_encoder is not None
  assert not aerial.data.add_images


@pytest.mark.parametrize('classes', [
    data_types.DEFAULT_SEMANTIC_MAP_CLASSES,
    ('tree', 'sidewalk', 'buildings_raw', 'line'),  # interleaved
])
def test_semantic_raster_encoder_matches_jax(classes):
  """The embeddings (one 8-d table over the surfel-road classes through an
  argmax, 2-way tables at ``2 * i + raster`` for the others) and the
  stride-1 trunk + FPN: every pyramid level."""
  config = configs.smoke_train_exhaustive(
      modalities=MODALITIES).model.bev_mapper.semantic_encoder
  jconfig = helpers.tiny_bev_mapper(MODALITIES.split('+')).semantic_encoder
  rng = np.random.default_rng(0)
  rasters = rng.uniform(size=(2, 24, 32, len(classes))) < 0.3
  rasters[0, :4] = False  # no class present: label 0
  jmodule = jsre.SemanticRasterEncoder(jconfig, tuple(classes))
  params = jax.jit(jmodule.init)(jax.random.PRNGKey(0), jnp.asarray(rasters))
  want = jax.jit(jmodule.apply)(params, jnp.asarray(rasters))
  module = semantic_raster_encoder.SemanticRasterEncoder(
      config, classes, torch.float32)
  module.load_state_dict(convert.params_from_flax(
      jax.tree_util.tree_map(np.asarray, params['params']), module))
  got = module(torch.as_tensor(rasters))
  assert got.strides == tuple(tuple(s) for s in want.strides)
  for g, w in zip(got.features, want.features):
    w = np.asarray(w)
    np.testing.assert_allclose(g.detach().numpy(), w,
                               rtol=torch_heads.LOSS_RTOL,
                               atol=torch_heads.LOSS_RTOL * np.abs(w).max())
  assert got.features[-1].shape == (2, 24, 32, 32)


def test_draws_drop_a_modality_and_keep_the_semantic_plane(localizer):
  keep = localizer['keep']
  assert keep.shape == (3, 2)
  assert not keep.all() and keep[2].any()


def test_loss_and_metrics_match_jax(localizer):
  want = localizer['want']
  loss, losses, metrics, _, _ = localizer['got']
  torch_heads.assert_losses_match(loss, losses, want.loss, want.losses)
  for key, value in want.metrics.items():
    if value.dtype == bool:
      np.testing.assert_array_equal(metrics[key].numpy(), value, err_msg=key)
  torch_heads.assert_metrics_match(metrics, want.metrics)


def test_gradients_match_jax(localizer):
  """Every leaf, the semantic encoder's embeddings and trunk among them,
  which take a gradient on the example that keeps the semantic plane."""
  got = torch_heads.assert_grads_match(localizer['got'][4],
                                       localizer['model'],
                                       localizer['want'].grads)
  semantic = [k for k in got if k.startswith('bev_mapper/semantic_encoder/')]
  assert 'bev_mapper/semantic_encoder/embeddings_surfel_road/embedding' in (
      semantic)
  assert all(np.abs(got[k]).max() > 0 for k in semantic)
