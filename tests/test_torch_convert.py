"""Port weights: the flax export converts onto the bench_full module.

The export ``pretrained/loc_full1chip_r5`` is read with the JAX package's
own restore (orbax), inside the test only; the port never reads orbax.
"""

import pathlib

import numpy as np
import pytest
import torch

from snap_tpu.train_lib import checkpoints
from snap_tpu_torch import configs
from snap_tpu_torch import convert
from snap_tpu_torch.data import loader
from snap_tpu_torch.models import bev_localizer

torch.set_num_threads(2)

EXPORT = pathlib.Path(__file__).resolve().parents[1] / 'pretrained' / (
    'loc_full1chip_r5')


def _bench_module():
  cfg = configs.bench_full()
  return bev_localizer.BEVLocalizer(
      cfg.model, loader.map_grid(cfg.data).bev(), dtype=torch.bfloat16)


def test_export_converts_onto_bench_full():
  """Every export key is consumed and every shape matches; no forward."""
  params = checkpoints.restore_params(EXPORT)
  model = _bench_module()
  state = convert.params_from_flax(params, model)
  assert set(state) == set(model.state_dict())
  model.load_state_dict(state, strict=True)
  flat = convert.flatten_params(params)
  assert len(flat) == len(state) == 331
  kernel = flat['bev_mapper/streetview_encoder/image_encoder/encoder/'
                'root_block/conv_root/kernel']
  np.testing.assert_array_equal(
      model.bev_mapper.streetview_encoder.image_encoder.encoder.root_block
      .conv_root.weight.detach().numpy(), kernel.transpose(3, 2, 0, 1))
  dense = flat['bev_mapper/matching_proj/kernel']
  np.testing.assert_array_equal(
      model.bev_mapper.matching_proj.weight.detach().numpy(), dense.T)
  assert float(model.temperature.detach()) == float(flat['temperature'])


def test_conversion_rules():
  rng = np.random.default_rng(0)
  tree = {
      'conv': {'kernel': rng.normal(size=(3, 3, 4, 5))},
      'gn': {'scale': rng.normal(size=(1, 1, 1, 5)),
             'bias': rng.normal(size=(1, 1, 1, 5))},
      'Dense_0': {'kernel': rng.normal(size=(5, 7)),
                  'bias': rng.normal(size=(7,))},
      'temperature': np.float32(2.5),
  }
  state = convert.params_from_flax(tree)
  np.testing.assert_allclose(state['conv.weight'].numpy(),
                             tree['conv']['kernel'].transpose(3, 2, 0, 1),
                             rtol=1e-6)
  assert state['gn.scale'].shape == (5,) and state['gn.bias'].shape == (5,)
  np.testing.assert_allclose(state['Dense_0.weight'].numpy(),
                             tree['Dense_0']['kernel'].T, rtol=1e-6)
  assert state['temperature'].shape == ()
  # A flat '/'-keyed dict (an .npz of the params) converts the same way.
  flat = convert.params_from_flax(convert.flatten_params(tree))
  assert all(torch.equal(flat[k], v) for k, v in state.items())


def test_conversion_raises_on_unconsumed_and_missing_keys():
  model = torch.nn.Module()
  model.Dense_0 = torch.nn.Module()
  model.Dense_0.weight = torch.nn.Parameter(torch.zeros(3, 2))
  model.Dense_0.bias = torch.nn.Parameter(torch.zeros(3))
  good = {'Dense_0': {'kernel': np.zeros((2, 3)), 'bias': np.zeros(3)}}
  convert.params_from_flax(good, model)
  with pytest.raises(ValueError, match='unconsumed'):
    convert.params_from_flax(good | {'extra': {'bias': np.zeros(2)}}, model)
  with pytest.raises(ValueError, match=r"missing \['Dense_0.bias'\]"):
    convert.params_from_flax({'Dense_0': {'kernel': np.zeros((2, 3))}}, model)
  with pytest.raises(ValueError, match='shape mismatches'):
    convert.params_from_flax(
        {'Dense_0': {'kernel': np.zeros((3, 3)), 'bias': np.zeros(3)}}, model)


def test_init_params_is_seeded():
  cfg = configs.smoke_exhaustive()
  models = [bev_localizer.BEVLocalizer(
      cfg.model, loader.map_grid(cfg.data).bev()) for _ in range(3)]
  for model, seed in zip(models, (0, 0, 1)):
    convert.init_params(model, seed)
  a, b, c = (m.state_dict() for m in models)
  assert all(torch.equal(a[k], b[k]) for k in a)
  assert not all(torch.equal(a[k], c[k]) for k in a)
  assert float(models[0].temperature.detach()) == cfg.model.init_temperature
