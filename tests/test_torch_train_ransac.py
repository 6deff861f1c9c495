"""Port parity of the RANSAC-backend training path (``smoke_train_ransac``).

The JAX package is the oracle, on the CPU as tests/conftest.py sets it up:
``jax.grad`` of ``BEVLocalizerModel``'s masked-mean loss on
``smoke_localization.py`` (RANSAC, its default: the in-FoV query points,
64 pose samples x 2 retries) with flax-initialized weights carried over by
``convert``, batch 2 with ``batch_mask [1, 0]``. Both sides run at
``train=False`` (the two packages' random streams differ, ROADMAP C8), and
JAX's sampled poses are injected into the port (``pose_samples=``): the
loss is the GT pose's ``-log_softmax`` among the scores of those poses,
whose gradient reaches the parameters through the score maps only (B7's
plain version on the CPU).
"""

import copy
import json
import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snap_tpu.configs import smoke_localization
from snap_tpu.configs import train_localization
from snap_tpu.data import loader as jloader
from snap_tpu.data import types as jtypes
from snap_tpu.models import bev_localizer as jbev_localizer
from snap_tpu.utils import grids as jgrids
from snap_tpu_torch import configs
from snap_tpu_torch import convert
from snap_tpu_torch import evaluate
from snap_tpu_torch import train
from snap_tpu_torch.data import loader
from snap_tpu_torch.models import bev_localizer
from snap_tpu_torch.train_lib import optimizers
from snap_tpu_torch.train_lib import trainer
from snap_tpu_torch.utils import geometry

torch.set_num_threads(2)

# The tolerances of tests/test_torch_train.py. f32 on both sides; the loss
# differs by the encoders', the einsum's and the sums over the points'
# orders (measured 5.7e-7 relative), and each gradient leaf, against its
# largest entry, by those and the scatter's order (worst leaf measured
# 2.5e-5 of its largest entry, the temperature: a sum over every entry of
# the score maps): loss rtol 1e-5, leaves 1e-4 of their largest entry plus
# 1e-7 absolute.
LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-7


def _jax_model():
  cfg = smoke_localization.get_config()
  grid = jgrids.Grid3D.from_extent_meters((24, 32, 12), 1.0)
  meta = {'build_config': types.SimpleNamespace(
              scene_config=jtypes.SceneConfig(num_views=3)),
          'grid': grid, 'semantic_map_classes': None}
  return jbev_localizer.BEVLocalizerModel(cfg.model, meta, jnp.float32)


@pytest.fixture(scope='module')
def ransac_grads():
  """The masked-mean loss and its gradients on both sides, batch 2, JAX's
  pose samples injected into the port."""
  tcfg = configs.smoke_train_ransac(batch_size=2)
  examples = loader.make_train_examples(loader.make_generator(tcfg.data, 3),
                                        0, 2, tcfg.data)
  examples['batch_mask'] = np.asarray([1.0, 0.0], np.float32)
  jbatch = jloader.process_batch(copy.deepcopy(examples),
                                 jtypes.DataMode.PAIR_SCENE_VIEW)
  jbatch.pop('_host')
  jmodel = _jax_model()
  rngs = {'params': jax.random.PRNGKey(0), 'sampling': jax.random.PRNGKey(1)}
  params = jax.jit(
      lambda b: jmodel.flax_model.init(rngs, b, train=False))(jbatch)[
          'params']

  def loss_fn(p, b):
    pred = jmodel.flax_model.apply(
        {'params': p}, b, train=False,
        rngs={'sampling': jax.random.PRNGKey(2)})
    losses, metrics = jmodel.loss_metrics_function(pred, b, p)
    loss = losses['total'].mean(where=b['batch_mask'] > 0)
    return loss, (losses, metrics, pred['map_t_query_samples'])

  (jloss, (jlosses, jmetrics, jsamples)), jgrads = jax.jit(
      jax.value_and_grad(loss_fn, has_aux=True))(params, jbatch)

  model = bev_localizer.BEVLocalizer(
      tcfg.model, loader.map_grid(tcfg.data).bev(), dtype=torch.float32)
  model.load_state_dict(convert.params_from_flax(
      jax.tree_util.tree_map(np.asarray, params), model))
  injected = geometry.Transform2D(
      angle=torch.from_numpy(np.array(jsamples.angle)[:, 1:]),
      t=torch.from_numpy(np.array(jsamples.t)[:, 1:]))
  batch = loader.pair_batch_to_torch(examples, 'cpu')
  loss, losses, metrics, pred = trainer.loss_and_metrics(
      model, batch, False, pose_samples=injected)
  names = [n for n, _ in model.named_parameters()]
  grads = torch.autograd.grad(
      loss, [p for _, p in model.named_parameters()], allow_unused=True)
  return dict(
      want=(float(jloss), jax.tree_util.tree_map(np.asarray, jlosses),
            jax.tree_util.tree_map(np.asarray, jmetrics),
            convert.flatten_params(jax.tree_util.tree_map(np.asarray,
                                                          jgrads))),
      got=(float(loss.detach()), losses, metrics,
           dict(zip(names, grads))),
      model=model, pred=pred, samples=jsamples)


def test_ransac_loss_and_metrics_match_jax(ransac_grads):
  want_loss, want_losses, want_metrics, _ = ransac_grads['want']
  got_loss, got_losses, got_metrics, _ = ransac_grads['got']
  assert math.isfinite(got_loss)
  assert got_loss == pytest.approx(want_loss, rel=LOSS_RTOL)
  assert set(got_losses) == set(want_losses)
  for key in want_losses:
    np.testing.assert_allclose(got_losses[key].detach().numpy(),
                               want_losses[key], rtol=LOSS_RTOL)
  assert set(got_metrics) == set(want_metrics)
  for key, want in want_metrics.items():
    got = got_metrics[key].detach().numpy()
    if want.dtype == bool:
      np.testing.assert_array_equal(got, want, err_msg=key)
    else:
      np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4,
                                 err_msg=key)
  # The scored poses are JAX's: the GT first, then the injected samples.
  pred, samples = ransac_grads['pred'], ransac_grads['samples']
  assert pred['scores_poses'].shape == (2, 65)
  np.testing.assert_array_equal(pred['map_t_query_samples'].angle.numpy(),
                                np.asarray(samples.angle))


def test_ransac_per_parameter_gradients_match_jax(ransac_grads):
  """Every leaf, through ``convert.flax_from_torch``; equal leaf sets."""
  _, _, _, want = ransac_grads['want']
  _, _, _, grads = ransac_grads['got']
  assert all(g is not None for g in grads.values())
  got = convert.flax_from_torch(grads, ransac_grads['model'])
  assert set(got) == set(want)
  for key in sorted(want):
    assert got[key].shape == want[key].shape, key
    scale = np.abs(want[key]).max()
    np.testing.assert_allclose(got[key], want[key],
                               atol=GRAD_ATOL + GRAD_RTOL * scale, rtol=0,
                               err_msg=key)
  trunk = 'bev_mapper/streetview_encoder/image_encoder/encoder/'
  assert np.abs(got[trunk + 'root_block/conv_root/kernel']).max() > 0
  assert np.abs(got['bev_mapper/aerial_encoder/encoder/'
                     'block1/unit01/conv1/kernel']).max() > 0
  assert np.abs(got['temperature']).max() > 0


def _smoke_batch(seed=2):
  cfg = configs.smoke_train_ransac()
  examples = loader.make_train_examples(loader.make_generator(cfg.data, seed),
                                        0, 2, cfg.data)
  return cfg, loader.pair_batch_to_torch(examples, 'cpu')


def _step(cfg, batch, **inject):
  model = evaluate.build_localizer(cfg, 'cpu', 4)
  adam = optimizers.Adam(cfg.train)
  state = trainer.create_train_state(model, adam, seed=9)
  return trainer.train_step(state, batch, adam, **inject)


def test_train_step_with_injected_samples_equals_generator_samples():
  """The step's draws and pose samples, injected into the same step, give
  the same step; other injected samples give another loss."""
  cfg, batch = _smoke_batch()
  drawn = _step(cfg, batch)
  samples = drawn.pose_samples
  assert samples.angle.shape == (2, cfg.model.num_pose_samples)
  assert samples.t.shape == (2, cfg.model.num_pose_samples, 2)
  injected = _step(cfg, batch, draws=drawn.draws, pose_samples=samples)
  assert injected.logs == drawn.logs
  assert torch.equal(injected.pose_samples.t, samples.t)
  moved = _step(cfg, batch, draws=drawn.draws,
                pose_samples=geometry.Transform2D(angle=samples.angle,
                                                  t=samples.t + 1.0))
  assert moved.logs['l2_grads'] != drawn.logs['l2_grads']


def test_train_step_on_the_exhaustive_backend_has_no_pose_samples():
  cfg = configs.smoke_train_exhaustive()
  examples = loader.make_train_examples(loader.make_generator(cfg.data, 2),
                                        0, 2, cfg.data)
  out = _step(cfg, loader.pair_batch_to_torch(examples, 'cpu'))
  assert out.pose_samples is None


def test_train_ransac_cli_on_cpu(capsys, tmp_path):
  train.main(['--config=smoke_train_ransac', '--num_steps=2', '--device=cpu',
              f'--workdir={tmp_path}'])
  lines = [json.loads(l) for l in capsys.readouterr().out.splitlines()]
  steps = [l for l in lines if 'step' in l]
  assert [s['step'] for s in steps] == [0, 1]
  for s in steps:
    assert math.isfinite(s['loss/total']) and s['is_finite'] == 1.0
    assert math.isfinite(s['l2_grads']) and s['l2_grads'] > 0
  assert lines[-1]['config'] == 'smoke_train_ransac'
  assert 'temperature' in torch.load(
      tmp_path / 'checkpoints' / '2' / 'params.pt', weights_only=True)


def test_from_reference_reads_the_ransac_training_config():
  ref = train_localization.get_config('scale=full1chip')
  assert configs.from_reference(ref.to_dict()) == (
      configs.train_full1chip_ransac())


def test_eval_full1chip_ransac_is_the_ransac_run_under_the_eval_config():
  """``eval_full1chip_ransac`` (now built from ``train_full1chip_ransac``)
  is the reference's ``scale=full1chip`` experiment, read field by field
  by ``from_reference``, under ``eval_localization.py``."""
  ref = train_localization.get_config('scale=full1chip')
  assert configs.eval_full1chip_ransac() == configs.merge_eval_config(
      configs.eval_localization(), configs.from_reference(ref.to_dict()),
      'osaka-synthetic_eval')
