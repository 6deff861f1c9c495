"""Port parity: the street-view encoder's gather form, with the depth MLP.

The JAX package's ``StreetViewEncoder`` (flax, f32 on the CPU as
tests/conftest.py sets it up) and the port's on the same batch, with the
flax params perturbed by numpy noise and carried across by
``convert.params_from_flax`` (which raises on any leaf left over or
missing: the ``depth_mlp/Dense_i`` names under ``nn.remat``, the fusion
MLP's width, the absence of ``proj_mlp``). The feature volume, its
validity exactly, and the gradient of every parameter against
``jax.grad``. Also the two reference quirks the port keeps (ROADMAP C24,
C25).
"""

import dataclasses

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import helpers  # tests/helpers.py: the JAX suite's tiny configs
import torch_heads
from snap_tpu.configs import defaults
from snap_tpu.data import loader as jloader
from snap_tpu.data import types as jtypes
from snap_tpu.models import streetview_encoder as jstreetview_encoder
from snap_tpu_torch import configs
from snap_tpu_torch import convert
from snap_tpu_torch.data import loader
from snap_tpu_torch.models import streetview_encoder

torch.set_num_threads(2)

# The volume: tests/test_torch_encoders.py's (f32 convolutions whose
# summation orders differ, grown through the trunk's normalizations).
ATOL, RTOL = 1e-4, 1e-4
# The gradients: tests/test_torch_train.py's, relative to each leaf's
# largest entry.
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-7
DIM = 32


def _batch(num_views: int, seed: int = 5):
  """Both packages' inputs: a map scene of ``num_views`` views and a
  jittered voxel grid of points."""
  data_cfg = configs.DataConfig(num_views=num_views, image_size=(36, 48),
                                voxel_size=1.0, add_rasters=False)
  ex = loader.make_pair_examples(loader.make_generator(data_cfg, seed),
                                 [0, 1], data_cfg)
  rng = np.random.default_rng(seed + 1)
  xyz = np.stack(np.meshgrid(np.arange(0.5, 24), np.arange(0.5, 32),
                             np.arange(0.5, 4), indexing='ij'), -1)
  xyz = np.broadcast_to(xyz[None], (2, *xyz.shape)).astype(np.float32)
  xyz = xyz + rng.uniform(-0.1, 0.1, xyz.shape).astype(np.float32)
  jbatch = jloader.process_batch(
      {'map': ex['map'], 'query': ex['query'],
       'T_query2map': ex['T_query2map'], 'pair_id': ex['pair_id']},
      jtypes.DataMode.PAIR_SCENE_VIEW)['map']
  jdata = dict(images=ex['map']['images'], camera=jbatch['camera'],
               T_view2scene=jbatch['T_view2scene'], xyz_query=xyz)
  tdata = loader.pair_batch_to_torch(ex, 'cpu')['map']
  tdata['xyz_query'] = torch.from_numpy(xyz)
  return jdata, tdata


def _configs(weighted: bool, depth_mlp, **keys):
  """The tiny encoder's JAX config and the port's, in the gather form."""
  jcfg = helpers.tiny_streetview_encoder(DIM)
  jcfg.pooling_impl = 'gather'
  jcfg.do_weighted_fusion = weighted
  if depth_mlp is not None:
    mlp = defaults.mlp()
    mlp.layers = depth_mlp
    jcfg.depth_mlp = mlp
  for key, value in keys.items():
    jcfg[key] = value
  cfg = configs.streetview_encoder_from_reference(
      jcfg.to_dict() | {'pretrained_path': None})
  return jcfg, cfg


def _run(jcfg, cfg, num_views: int, seed: int):
  """Both encoders on one batch: (JAX volume, grads), (port volume, grads,
  module); the loss is the volume's sum against a fixed cotangent. The
  port's relus take JAX's sides (``torch_heads``: a relu input within
  rounding of 0 may fall on the other side, ROADMAP C11; a first run met one
  of 393,216 in the depth MLP, 2.2e-7 of the largest from 0)."""
  jdata, tdata = _batch(num_views)
  jmodel = jstreetview_encoder.StreetViewEncoder(jcfg, jnp.float32)
  params = jmodel.init(jax.random.PRNGKey(0), jdata)['params']
  rng = np.random.default_rng(seed)
  params = jax.tree_util.tree_map(
      lambda p: np.asarray(p) + 0.1 * rng.normal(size=p.shape).astype(
          np.float32), params)
  want = jmodel.apply({'params': params}, jdata)['feature_volume']
  cot = rng.normal(size=want.features.shape).astype(np.float32)
  with pytest.MonkeyPatch.context() as mp:
    # Rematerialization recomputes the same values; without it a relu's
    # side can be returned from the traced function.
    mp.setattr(nn, 'remat', lambda module, *args, **kwargs: module)
    with torch_heads.recorded(mp, nn, 'relu',
                              lambda args, out: args[0] > 0) as sides:

      def loss(p):
        del sides[:]
        volume = jmodel.apply({'params': p}, jdata)['feature_volume']
        return jnp.sum(volume.features * cot), list(sides)

      (_, relu_sides), grads = jax.jit(jax.value_and_grad(
          loss, has_aux=True))(params)
  want_grads = convert.flatten_params(grads)
  model = streetview_encoder.StreetViewEncoder(cfg, torch.float32)
  model.load_state_dict(convert.params_from_flax(params, model))
  with torch.no_grad(), chip_smoke.MaxChoices(model) as own:
    model(tdata)
  relu_sides = iter(torch.as_tensor(np.array(s)) for s in relu_sides)
  replay = [next(relu_sides) if site == 'F.relu' else call
            for site, call in zip(own.sites, own.calls)]
  assert next(relu_sides, None) is None
  with chip_smoke.MaxChoices(model, replay=replay):
    got = model(tdata)['feature_volume']
  named = dict(model.named_parameters())
  grads = torch.autograd.grad((got.features * torch.from_numpy(cot)).sum(),
                              list(named.values()))
  got_grads = convert.flax_from_torch(dict(zip(named, grads)), model)
  return (want, want_grads), (got, got_grads, model)


def _assert_matches(want, got):
  (want_vol, want_grads), (got_vol, got_grads, _) = want, got
  np.testing.assert_array_equal(got_vol.valid.numpy(),
                                np.asarray(want_vol.valid))
  np.testing.assert_allclose(got_vol.features.detach().numpy(),
                             np.asarray(want_vol.features), atol=ATOL,
                             rtol=RTOL)
  assert sorted(got_grads) == sorted(want_grads)
  for key, value in want_grads.items():
    value = np.asarray(value)
    scale = np.abs(value).max()
    np.testing.assert_allclose(got_grads[key], value,
                               atol=GRAD_ATOL + GRAD_RTOL * scale, rtol=0,
                               err_msg=key)


@pytest.mark.parametrize('num_views', [3, 2])
def test_depth_mlp_encoder_matches_flax(num_views):
  """Unweighted fusion with a depth MLP over [feature, log10 depth, ray]:
  the top-k gather (3 views, k = 2; the rays gathered by the selected
  views) and every view (2 views). Stats [mean, max, min] (no variance)."""
  jcfg, cfg = _configs(False, (DIM, DIM), fusion_use_variance=False,
                       fusion_add_minmax=True)
  assert cfg.depth_mlp == configs.MLPConfig(layers=(DIM, DIM))
  want, got = _run(jcfg, cfg, num_views, seed=7)
  _assert_matches(want, got)
  model = got[2]
  assert model.proj_mlp is None and model.depth_mlp is not None
  assert model.fusion_mlp.Dense_0.weight.shape[1] == 3 * DIM
  grads = got[1]
  assert np.abs(grads['depth_mlp/Dense_0/kernel']).max() > 0
  assert np.abs(grads['depth_mlp/Dense_1/bias']).max() > 0


def test_c24_weighted_fusion_never_applies_the_depth_mlp():
  """C24: with weighted fusion and a depth MLP set, the streamed form falls
  to the gather form, which builds no depth MLP: the params are the
  weighted gather form's, the volume JAX's, and the same weights in the
  gather form without a depth MLP give that volume bit for bit."""
  jcfg, cfg = _configs(True, (DIM, DIM), pooling_impl='stream')
  assert cfg.pooling_impl == 'stream' and cfg.depth_mlp is not None
  want, got = _run(jcfg, cfg, 3, seed=8)
  assert not any(k.startswith('depth_mlp/') for k in want[1])
  assert got[2].depth_mlp is None and got[2].proj_mlp is not None
  _assert_matches(want, got)
  gather = dataclasses.replace(cfg, depth_mlp=None, pooling_impl='gather')
  model = streetview_encoder.StreetViewEncoder(gather, torch.float32)
  model.load_state_dict(got[2].state_dict())
  _, tdata = _batch(3)
  np.testing.assert_array_equal(
      model(tdata)['feature_volume'].features.detach().numpy(),
      got[0].features.detach().numpy())


@pytest.mark.parametrize('num_views,applied', [(2, False), (3, True)])
def test_c25_gather_over_every_view_skips_max_view_distance(num_views,
                                                             applied):
  """C25: the gather form over every view (V <= k) knows no view distance,
  so ``max_view_distance`` is not applied; with V > k it is."""
  jcfg, cfg = _configs(True, None, max_view_distance=3.0)
  want, got = _run(jcfg, cfg, num_views, seed=9)
  _assert_matches(want, got)
  unlimited = dataclasses.replace(cfg, max_view_distance=None)
  model = streetview_encoder.StreetViewEncoder(unlimited, torch.float32)
  model.load_state_dict(got[2].state_dict())
  _, tdata = _batch(num_views)
  valid = model(tdata)['feature_volume'].valid
  if applied:
    assert int(valid.sum()) > int(got[0].valid.sum())
  else:
    assert torch.equal(valid, got[0].valid)
