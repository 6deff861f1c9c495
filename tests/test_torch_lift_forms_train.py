"""Port parity: one localizer training step with each form of the lift that
``chip_smoke.py`` drives on the card (phases 5f and 7j).

``smoke_train_exhaustive`` with the street-view encoder's keys set as the
reference's ``--config.model.bev_mapper.streetview_encoder.*`` overrides
set them: the streamed lift with the per-channel max and min; the scanned
lift unweighted; the gather form unweighted, without the variance, with
the max and min and a depth MLP. One step of both packages on the same
batch and weights (``torch_a14.localizer_step``: JAX's draws injected, the
port's relus on JAX's sides): the loss, the metrics and every gradient
leaf against ``jax.grad`` (``torch_heads``' tolerances), and the planes.
"""

import ml_collections
import pytest
import torch

from snap_tpu_torch import configs
import torch_a14

torch.set_num_threads(2)

DIM = torch_a14.DIM
FORMS = {
    'stream-minmax': dict(fusion_add_minmax=True),
    'scan-unweighted': dict(pooling_impl='scan', do_weighted_fusion=False),
    'gather-depth_mlp': dict(
        pooling_impl='gather', do_weighted_fusion=False,
        fusion_use_variance=False, fusion_add_minmax=True,
        depth_mlp=configs.MLPConfig(layers=(DIM, DIM))),
}


def form_configs(name: str):
  """The JAX config and the port's of the form ``name``."""
  keys = FORMS[name]
  config = torch_a14.port_config(bev_mapper={'streetview_encoder': keys})
  jcfg = torch_a14.jax_config()
  encoder = jcfg.model.bev_mapper.streetview_encoder
  for key, value in keys.items():
    if isinstance(value, configs.MLPConfig):
      value = ml_collections.ConfigDict(dict(
          activation=value.activation, layers=value.layers,
          apply_input_activation=value.apply_input_activation))
    encoder[key] = value
  return config, jcfg


@pytest.mark.parametrize('name', sorted(FORMS))
def test_localizer_step_matches_jax(name):
  config, jcfg = form_configs(name)
  assert configs.from_reference(jcfg.to_dict()).model == config.model
  step = torch_a14.localizer_step(config, jcfg)
  want, pred = step.want.pred, step.got[3]
  for scene in ('map', 'query'):
    torch_a14.assert_plane_matches(pred[scene]['bev_matching'],
                                   want[scene]['bev_matching'])
  torch_a14.assert_dense_poses_match(step)
  got = torch_a14.assert_step_matches(step)
  encoder = 'bev_mapper/streetview_encoder/'
  assert torch_a14.nonzero(got, encoder + 'image_encoder/')
  assert torch_a14.nonzero(got, encoder + 'fusion_mlp/')
  if name == 'gather-depth_mlp':
    assert torch_a14.nonzero(got, encoder + 'depth_mlp/')
  weighted = FORMS[name].get('do_weighted_fusion', True)
  module = step.model.bev_mapper.streetview_encoder
  assert (module.proj_mlp is not None) == weighted
