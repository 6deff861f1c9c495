"""Port parity of ``bev_net``, the residual stage over the fused plane
(``train_localization.py:bev_net=1``: 2 bottleneck units, rematerialized
in the reference).

The JAX package is the oracle, on the CPU as tests/conftest.py sets it up:
``smoke_localization.py:pose_backend=exhaustive`` with the tests' tiny
street-view + aerial mapper and ``bev_net`` (``tests/torch_a14.py``), its
flax-initialized weights carried over by ``convert.params_from_flax``. One
training step on the same batch with JAX's draws injected: the fused and
matching planes, the volume, the loss and every gradient leaf (the
stage's among them). The flax names are checked with ``jax.eval_shape``
under ``nn.remat``, as the recipe builds it. Tolerances:
``tests/torch_a14.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snap_tpu.configs import train_localization
from snap_tpu.models import resnet as jresnet
from snap_tpu_torch import configs
from snap_tpu_torch import convert
from snap_tpu_torch import evaluator
from snap_tpu_torch.models import bev_mapper
from snap_tpu_torch.models import resnet
from snap_tpu_torch.models import types as model_types
from snap_tpu_torch.utils import grids
import torch_a14

torch.set_num_threads(2)

# The stage on one plane given to both: the convs' summation order, as the
# encoders' features (tests/torch_heads.py's 1e-5 of the largest entry).
STAGE_RTOL = 1e-5
# In the model the stage's GroupNorms of one-channel groups (8 mid channels
# of the tiny 32-wide plane) over planes of mostly zeroed invalid cells
# amplify the fused plane's rounding: its output measured 1.6e-5 of its
# largest entry (the query's) and the matching plane 2.9e-5; held to 5e-5.
BEV_NET_RTOL = 5e-5
BEV_NET_MATCHING_ATOL = 5e-5


def test_config_is_the_reference():
  """The recipe's ``bev_net`` (``num_units`` and ``checkpoint_units``; the
  reference reads every key with a default) at full width and tiny."""
  ref = train_localization.get_config(
      'bev_net=1,scale=full1chip,pose_backend=exhaustive').to_dict()
  want = configs.train_full1chip_exhaustive(bev_net=1)
  assert configs.from_reference(ref) == want
  assert want.model.bev_mapper.bev_net == configs.BEVNetConfig(
      num_units=2, nmid=None, checkpoint_units=True)
  assert configs.from_reference(configs.to_reference(want)) == want
  ref['model']['bev_mapper']['bev_net'] = {}
  assert configs.from_reference(ref).model.bev_mapper.bev_net == (
      configs.BEVNetConfig())
  smoke = torch_a14.port_config(bev_net=True)
  jcfg = torch_a14.jax_config(bev_net=True)
  assert configs.from_reference(jcfg.to_dict()).model == smoke.model


@pytest.fixture(scope='module')
def step():
  return torch_a14.localizer_step(torch_a14.port_config(bev_net=True),
                                  torch_a14.jax_config(bev_net=True))


def test_stage_matches_jax_on_one_plane():
  """The stage alone on one plane given to both packages (a quarter of its
  cells invalid and zero), to 1e-5 of the output's largest entry."""
  rng = np.random.default_rng(0)
  plane = rng.normal(size=(2, 12, 16, 32)).astype(np.float32)
  plane[:, :3] = 0
  jstage = jresnet.ResNetStage(block_size=2)
  params = jax.jit(jstage.init)(jax.random.PRNGKey(0), jnp.asarray(plane))
  want, _ = jax.jit(jstage.apply)(params, jnp.asarray(plane))
  want = np.asarray(want)
  stage = resnet.ResNetStage(2, 32, 8, torch.float32)
  stage.load_state_dict(convert.params_from_flax(
      jax.tree_util.tree_map(np.asarray, params['params']), stage))
  got = stage(torch.from_numpy(plane)).detach().numpy()
  assert np.abs(got - want).max() <= STAGE_RTOL * np.abs(want).max()


def test_planes_and_volume_match_jax(step):
  """The stage's output to ``BEV_NET_RTOL`` of its largest entry and the
  matching plane to ``BEV_NET_MATCHING_ATOL``; the volume to
  ``VOLUME_ATOL`` and its argmax exactly."""
  want, pred = step.want.pred, step.got[3]
  for scene in ('map', 'query'):
    w, g = want[scene]['bev_features'], pred[scene]['bev_features']
    scale = float(np.abs(np.asarray(w.features)).max())
    torch_a14.assert_plane_matches(g, w, BEV_NET_RTOL * scale)
    torch_a14.assert_plane_matches(pred[scene]['bev_matching'],
                                   want[scene]['bev_matching'],
                                   BEV_NET_MATCHING_ATOL)
  torch_a14.assert_dense_poses_match(step)


def test_invalid_cells_stay_zero(step):
  """The convs smear into the query's cells outside its views; the stage's
  output is zeroed there again, as the reference's."""
  plane = step.got[3]['query']['bev_features']
  invalid = ~plane.valid
  assert invalid.any() and plane.valid.any()
  assert (plane.features[invalid] == 0).all()
  want = step.want.pred['query']['bev_features']
  assert (np.asarray(want.features)[~np.asarray(want.valid)] == 0).all()


def test_loss_and_gradients_match_jax(step):
  got = torch_a14.assert_step_matches(step)
  for unit in ('unit01', 'unit02'):
    assert torch_a14.nonzero(got, f'bev_mapper/bev_net/{unit}/')


def test_flax_names_under_remat():
  """``checkpoint_units=True`` wraps the units in ``nn.remat``; the
  parameter tree keeps the names ``convert`` maps (every leaf consumed,
  none missing)."""
  config = torch_a14.port_config(bev_net=True)
  jbatch, _ = torch_a14.pair_batches(config)
  jmodel = torch_a14.jax_model(config, torch_a14.jax_config(bev_net=True))
  rngs = {'params': jax.random.PRNGKey(0), 'sampling': jax.random.PRNGKey(1)}
  shapes = jax.eval_shape(
      lambda b: jmodel.flax_model.init(rngs, b, train=False), jbatch)
  params = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                  shapes['params'])
  model = evaluator.build_model(config, 'cpu')
  state = convert.params_from_flax(params, model)
  stage = sorted(k for k in state if k.startswith('bev_mapper.bev_net.'))
  assert 'bev_mapper.bev_net.unit02.conv3.weight' in stage
  assert not any('conv_proj' in k for k in stage)  # an identity residual


def _aerial_mapper(width: int, bev_net: configs.BEVNetConfig):
  encoder = configs.ImageEncoderConfig(
      encoder=configs.ResNetConfig(depth=(1, 1), limit_num_blocks=2,
                                   skip_root_block=True), output_dim=width)
  config = configs.BEVMapperConfig(streetview_encoder=None,
                                   aerial_encoder=encoder, bev_net=bev_net,
                                   matching_dim=8)
  return bev_mapper.BEVMapper(config, grids.Grid2D.from_extent_meters(
      (8, 8), 1.0), torch.float32)


def test_width_not_a_multiple_of_4_raises():
  """With ``nmid`` unset a unit widens to 4 (C // 4): the reference asserts
  C % 4 == 0 (``snap_tpu/models/bev_mapper.py:314-320``), the port raises
  on building. With ``nmid`` set the stage projects to 4 nmid."""
  with pytest.raises(ValueError, match='divisible by 4'):
    _aerial_mapper(30, configs.BEVNetConfig())
  mapper = _aerial_mapper(30, configs.BEVNetConfig(num_units=1, nmid=8))
  assert mapper.feature_dim == 32
  assert mapper.bev_net.unit01.conv_proj is not None
  pred = mapper({'rasters': {'rgb': torch.rand(1, 8, 8, 3)}})
  assert pred['bev_features'].features.shape == (1, 8, 8, 32)
  assert pred['bev_matching'].features.shape == (1, 8, 8, 8)
  assert isinstance(pred['bev_features'], model_types.FeaturePlane)
