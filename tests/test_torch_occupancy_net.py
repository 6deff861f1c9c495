"""Port parity of the occupancy head (``models/occupancy_net.py``) and of
the street-view encoder's warm start, its adoption path.

The JAX package is the oracle, on the CPU as tests/conftest.py sets it up:
``OccupancyNetModel`` of ``configs/smoke_occupancy.py`` on a single-scene
batch of the host generator with its lidar rays, its flax-initialized
weights carried over by ``convert.params_from_flax``. Held: the ray
samples, the occupancy logits and validity, the loss and metrics, every
gradient leaf against ``jax.grad``; under ``stop_encoder_gradients`` every
encoder leaf's gradient is 0 in both; ``sample_queries_from_rays`` and the
batched trilinear read alone; the encoder's "export wins" config merge
keeping ``pretrained_path`` and adopting the export's weights.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snap_tpu.configs import smoke_occupancy as jsmoke_occupancy
from snap_tpu.models import occupancy_net as jocc
from snap_tpu.utils import grids as jgrids
from snap_tpu_torch import configs
from snap_tpu_torch import convert
from snap_tpu_torch import evaluator
from snap_tpu_torch.models import occupancy_net
from snap_tpu_torch.train_lib import trainer
from snap_tpu_torch.utils import grids
import torch_heads

torch.set_num_threads(2)


def _run(monkeypatch, **changes):
  config = configs.merge(configs.smoke_occupancy(), {'model': changes})
  jconfig = jsmoke_occupancy.get_config().model
  for key, value in changes.items():
    setattr(jconfig, key, value)
  jmodel = jocc.OccupancyNetModel(jconfig, torch_heads.jax_meta(config),
                                  jnp.float32)
  jbatch, batch = torch_heads.single_scene_batches(config)
  want = torch_heads.jax_step(jmodel, jbatch, True, monkeypatch)
  model = torch_heads.port_model(config, want.params)
  got = torch_heads.port_step(model, batch, True,
                              relu_sides=want.relu_sides)
  return dict(want=(want.loss, want.losses, want.metrics, want.pred,
                    want.grads), got=got, model=model)


@pytest.fixture(scope='module')
def whole():
  with pytest.MonkeyPatch.context() as mp:
    return _run(mp)


@pytest.fixture(scope='module')
def cut():
  with pytest.MonkeyPatch.context() as mp:
    return _run(mp, stop_encoder_gradients=True)


def test_smoke_config_is_the_references():
  ref = configs.from_reference(jsmoke_occupancy.get_config().to_dict())
  assert ref.model == configs.smoke_occupancy().model
  assert ref.model_name == 'occupancy_net'
  assert ref.data == dataclasses.replace(configs.smoke_occupancy().data,
                                         on_device_generation=None)


@pytest.mark.parametrize('run', ['whole', 'cut'])
def test_samples_and_logits_match_jax(run, request):
  r = request.getfixturevalue(run)
  jpred, pred = r['want'][3], r['got'][3]
  samples, jsamples = pred['ray_samples'], jpred['ray_samples']
  np.testing.assert_allclose(samples.points.numpy(),
                             np.asarray(jsamples.points), atol=1e-5)
  np.testing.assert_array_equal(samples.labels.numpy(),
                                np.asarray(jsamples.labels))
  np.testing.assert_array_equal(samples.valid.numpy(),
                                np.asarray(jsamples.valid))
  occupancy, jocc_out = pred['occupancy'], jpred['occupancy']
  np.testing.assert_array_equal(occupancy.valid.numpy(),
                                np.asarray(jocc_out.valid))
  want = np.asarray(jocc_out.logits)
  scale = float(np.abs(want).max())
  np.testing.assert_allclose(occupancy.logits.detach().numpy(), want,
                             rtol=torch_heads.LOSS_RTOL,
                             atol=torch_heads.LOSS_RTOL * scale)
  assert samples.labels.any() and occupancy.valid.any()
  assert not occupancy.valid.all()


@pytest.mark.parametrize('run', ['whole', 'cut'])
def test_losses_and_metrics_match_jax(run, request):
  r = request.getfixturevalue(run)
  loss, losses, metrics, _, _ = r['want']
  got_loss, got_losses, got_metrics, _, _ = r['got']
  torch_heads.assert_losses_match(got_loss, got_losses, loss, losses)
  torch_heads.assert_metrics_match(got_metrics, metrics)
  assert set(got_metrics) == {'occupancy/accuracy', 'occupancy/recall',
                              'occupancy/precision'}


@pytest.mark.parametrize('run', ['whole', 'cut'])
def test_gradients_match_jax(run, request):
  r = request.getfixturevalue(run)
  got = torch_heads.assert_grads_match(r['got'][4], r['model'], r['want'][4])
  encoder = torch_heads.leaves_under(got, 'streetview_encoder/')
  zero = [k for k in encoder if not np.abs(got[k]).max() > 0]
  if run == 'cut':
    assert zero == encoder
    assert all(not np.abs(r['want'][4][k]).max() > 0 for k in encoder)
  else:
    assert not zero
  assert all(np.abs(got[k]).max() > 0 for k in got if k.startswith('mlp_out'))


def test_sample_queries_from_rays_matches_jax():
  """Rays shorter than 1 m (the distance's clip), longer ones, invalid
  ones; the free samples at ``linspace(0, 1, n - 1)``."""
  rng = np.random.default_rng(0)
  origins = rng.normal(size=(2, 50, 3)).astype(np.float32)
  hits = origins + rng.normal(size=(2, 50, 3)).astype(np.float32) * (
      rng.uniform(0.1, 10, size=(2, 50, 1)).astype(np.float32))
  valid = rng.uniform(size=(2, 50)) < 0.8
  want = jocc.sample_queries_from_rays(jnp.asarray(hits), jnp.asarray(origins),
                                       jnp.asarray(valid), 7, 0.2)
  got = occupancy_net.sample_queries_from_rays(
      torch.as_tensor(hits), torch.as_tensor(origins), torch.as_tensor(valid),
      7, 0.2)
  np.testing.assert_allclose(got.points.numpy(), np.asarray(want.points),
                             rtol=1e-6, atol=1e-6)
  np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
  np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))


@pytest.mark.parametrize('order', [0, 1])
def test_batched_interpolation_matches_jax_vmap(order):
  """``interpolate_nd_batched`` against JAX's ``vmap`` of
  ``interpolate_nd``: points inside, on borders and outside the grid."""
  rng = np.random.default_rng(1)
  volume = rng.normal(size=(3, 6, 7, 5, 4)).astype(np.float32)
  valid = rng.uniform(size=(3, 6, 7, 5)) < 0.9
  points = (rng.uniform(-1, 1.2, size=(3, 200, 3))
            * np.asarray([6, 7, 5])).astype(np.float32)
  points[:, :8] = np.asarray([[0, 0, 0], [6, 7, 5], [5.5, 6.5, 4.5],
                              [0.5, 0.5, 0.5], [3, 3.5, 2], [6, 0, 0],
                              [-0.01, 1, 1], [2, 2, 5.0]])
  want_v, want_ok = jax.vmap(
      lambda a, p, v: jgrids.interpolate_nd(a, p, v, order=order))(
          jnp.asarray(volume), jnp.asarray(points), jnp.asarray(valid))
  got_v, got_ok = grids.interpolate_nd_batched(
      torch.as_tensor(volume), torch.as_tensor(points),
      torch.as_tensor(valid), order=order)
  np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), rtol=1e-6,
                             atol=1e-6)
  np.testing.assert_array_equal(got_ok.numpy(), np.asarray(want_ok))


def test_encoder_merge_keeps_pointer_and_adopts_params(tmp_path):
  """A localization export's encoder config carries ``pretrained_path``
  None (its run warm-started the whole mapper): the "export wins" merge
  must keep the head's pointer, take the export's architecture and adopt
  its weights (``tests/test_heads.py:TestEncoderAdoptionFromExport``)."""
  export = configs.smoke_train_exhaustive()
  exported_sv = export.model.bev_mapper.streetview_encoder
  assert exported_sv.pretrained_path is None
  (tmp_path / 'config.json').write_text(json.dumps(
      configs.to_reference(export)))
  localizer = evaluator.build_model(export, 'cpu', seed=1)
  marked = {name: torch.full_like(p, 0.5)
            for name, p in localizer.named_parameters()}
  np.savez(tmp_path / 'params.npz',
           **convert.flax_from_torch(marked, localizer))

  head = configs.smoke_occupancy()
  sv = dataclasses.replace(head.model.streetview_encoder,
                           top_k_view_selection=3,
                           pretrained_path=str(tmp_path))
  head = configs.merge(head, {'model': {'streetview_encoder': sv}})
  model = evaluator.build_model(head, 'cpu', seed=2)
  merged = model.streetview_encoder.config
  assert merged.pretrained_path == str(tmp_path)
  assert merged.top_k_view_selection == exported_sv.top_k_view_selection
  assert dataclasses.replace(merged, pretrained_path=None) == exported_sv

  before = {k: v.clone() for k, v in model.state_dict().items()}
  assert trainer.update_pretrained_variables(model) > 0
  for name, value in model.state_dict().items():
    if name.startswith('streetview_encoder.'):
      assert torch.equal(value, torch.full_like(value, 0.5)), name
    else:
      assert torch.equal(value, before[name]), name
