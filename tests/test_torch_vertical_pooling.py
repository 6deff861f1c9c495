"""Port parity of the learned vertical poolings ``'weighted'``,
``'softmax'`` and ``'mlp'`` (``snap_tpu/models/bev_mapper.py:
VerticalPooling``), at both of their uses: the street-view volume's
column and the map modalities stacked as a column (modality fusion).

The JAX package is the oracle, on the CPU as tests/conftest.py sets it up.
The module alone: JAX's and the port's on one seeded volume with empty
columns, the plane and the gradients of a seeded linear function of it
(to the features and to every parameter), finite at the empty columns.
In the localizer (``tests/torch_a14.py``): one training step with
``'weighted'`` pooling and ``'softmax'`` fusion, and one with ``'mlp'``
pooling, against ``jax.grad`` with JAX's draws injected.
"""

import jax
import jax.numpy as jnp
import ml_collections
import numpy as np
import pytest
import torch

from snap_tpu.models import bev_mapper as jbev_mapper
from snap_tpu.models import types as jmodel_types
from snap_tpu_torch import configs
from snap_tpu_torch import convert
from snap_tpu_torch.models import bev_mapper
from snap_tpu_torch.models import types as model_types
import torch_a14
import torch_heads

torch.set_num_threads(2)

# The module alone: the plane as tests/test_torch_localizer.py holds the
# max / sum / mean poolings (1e-6), the gradients as torch_heads (1e-4 of
# a leaf's largest entry plus 1e-7).
PLANE_ATOL = 1e-6
MLP = (16, 8)
# (Z, D): a street-view column of 6 levels, and 2 stacked map modalities.
SITES = {'streetview': (6, 8), 'modality_fusion': (2, 8)}


def _jax_config(mode: str) -> ml_collections.ConfigDict:
  return ml_collections.ConfigDict({'pooling': mode, 'mlp': {
      'layers': MLP, 'activation': 'relu', 'apply_input_activation': False}})


@pytest.mark.parametrize('site', sorted(SITES))
@pytest.mark.parametrize('mode', ['weighted', 'softmax', 'mlp'])
def test_pooling_matches_jax(mode, site):
  z, d = SITES[site]
  rng = np.random.default_rng(7)
  f = rng.normal(size=(2, 4, 5, z, d)).astype(np.float32)
  v = rng.random((2, 4, 5, z)) < 0.5
  v[0, 0, :2] = False  # empty columns
  cot = rng.normal(size=(2, 4, 5, MLP[-1] if mode == 'mlp' else d))
  cot = jnp.asarray(cot.astype(np.float32))
  jpool = jbev_mapper.VerticalPooling(_jax_config(mode), jnp.float32)
  volume = jmodel_types.FeatureVolume(features=jnp.asarray(f),
                                      valid=jnp.asarray(v))
  variables = jpool.init(jax.random.PRNGKey(0), volume)

  def fn(params, features):
    plane = jpool.apply({'params': params}, jmodel_types.FeatureVolume(
        features=features, valid=jnp.asarray(v)))['plane']
    return jnp.sum(plane.features * cot), plane

  (_, want), (g_params, g_features) = jax.value_and_grad(
      fn, argnums=(0, 1), has_aux=True)(variables['params'], jnp.asarray(f))

  pool = bev_mapper.VerticalPooling(
      configs.VerticalPoolingConfig(mode, configs.MLPConfig(layers=MLP)),
      torch.float32, column=(z, d))
  params = jax.tree_util.tree_map(np.asarray, variables['params'])
  pool.load_state_dict(convert.params_from_flax(params, pool))
  features = torch.from_numpy(f).requires_grad_()
  got = pool(model_types.FeatureVolume(features=features,
                                       valid=torch.from_numpy(v)))
  np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
  np.testing.assert_allclose(got.features.detach().numpy(),
                             np.asarray(want.features), atol=PLANE_ATOL)
  assert (got.features[~got.valid] == 0).all()
  (got.features * torch.from_numpy(np.array(cot))).sum().backward()
  grads = {n: p.grad for n, p in pool.named_parameters()}
  g_params = convert.flatten_params(jax.tree_util.tree_map(np.asarray,
                                                           g_params))
  if mode == 'softmax':
    # The softmax does not see a shift of every logit: the bias's gradient
    # is 0 but for rounding, on both sides (JAX's and the port's alike).
    zero = torch_heads.GRAD_RTOL * np.abs(
        g_params['confidence_head/kernel']).max()
    assert abs(float(g_params.pop('confidence_head/bias')[0])) <= zero
    assert abs(float(grads.pop('confidence_head.bias')[0])) <= zero
  got_params = convert.flax_from_torch(grads, pool)
  assert set(got_params) == set(g_params)
  for key, want_grad in g_params.items():
    scale = np.abs(want_grad).max()
    assert np.abs(got_params[key] - want_grad).max() <= (
        torch_heads.GRAD_RTOL * scale + torch_heads.GRAD_ATOL), key
  g_features = np.asarray(g_features)
  got_features = features.grad.numpy()
  assert np.isfinite(got_features).all()
  np.testing.assert_array_equal(got_features[0, 0, :2], 0)
  scale = np.abs(g_features).max()
  assert np.abs(got_features - g_features).max() <= (
      torch_heads.GRAD_RTOL * scale + torch_heads.GRAD_ATOL)


def test_learned_pooling_needs_its_column():
  with pytest.raises(ValueError, match='column'):
    bev_mapper.VerticalPooling(configs.VerticalPoolingConfig('softmax'))


# The localizer with the learned poolings: (street-view pooling, modality
# fusion); 'mlp' maps the column to the plane's width, the tiny 32.
POOLINGS = {
    'weighted-softmax': (configs.VerticalPoolingConfig('weighted'),
                         configs.VerticalPoolingConfig('softmax')),
    'mlp-max': (configs.VerticalPoolingConfig(
        'mlp', configs.MLPConfig(layers=(64, torch_a14.DIM))),
                configs.VerticalPoolingConfig()),
}


@pytest.mark.parametrize('name', sorted(POOLINGS))
def test_localizer_step_matches_jax(name):
  pooling, fusion = POOLINGS[name]
  config = torch_a14.port_config(bev_mapper={'pooling': pooling,
                                             'modality_fusion': fusion})
  jcfg = torch_a14.jax_config()
  for key, value in (('pooling', pooling), ('modality_fusion', fusion)):
    section = jcfg.model.bev_mapper[key]
    section.pooling = value.pooling
    section.mlp.layers = value.mlp.layers
  assert configs.from_reference(jcfg.to_dict()).model == config.model
  step = torch_a14.localizer_step(config, jcfg)
  want, pred = step.want.pred, step.got[3]
  for scene in ('map', 'query'):
    torch_a14.assert_plane_matches(pred[scene]['bev_matching'],
                                   want[scene]['bev_matching'])
  torch_a14.assert_dense_poses_match(step)
  got = torch_a14.assert_step_matches(step)
  head = {'weighted-softmax': ('vertical_pooling/confidence_head/',
                               'modality_fusion/confidence_head/'),
          'mlp-max': ('vertical_pooling/fusion_mlp/',)}[name]
  for prefix in head:
    assert torch_a14.nonzero(got, 'bev_mapper/' + prefix)
