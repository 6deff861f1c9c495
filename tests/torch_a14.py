"""Shared by the parity tests of the mapper options the flagship does not
use (the aerial-only map with its own street-view query mapper,
``bev_net``, the learned vertical poolings, query confidence).

The JAX configs are ``smoke_localization.py`` with the tests' tiny
mappers (``tests/helpers.py``), set as the port's smoke configs set them;
``configs.from_reference`` of each equals the port's. ``localizer_step``
runs one step of both packages on the same batch and weights: JAX's
``jax.grad`` of the masked-mean loss (``torch_heads.jax_step``), and the
port's with JAX's draws injected (the query's z jitter, the map's modality
dropout) and its relus on JAX's sides. ``ransac_step`` runs the RANSAC
backend at ``train=False`` with JAX's pose samples injected, as
``tests/test_torch_train_ransac.py`` does.
"""

import collections
import copy

import jax.numpy as jnp
import ml_collections
import numpy as np
import pytest
import torch

from snap_tpu.configs import smoke_localization
from snap_tpu.data import loader as jloader
from snap_tpu.data import types as jtypes
from snap_tpu.models import bev_localizer as jbev_localizer
from snap_tpu_torch import configs
from snap_tpu_torch.data import loader
from snap_tpu_torch.models import bev_mapper
from snap_tpu_torch.train_lib import trainer
from snap_tpu_torch.utils import geometry
import helpers
import torch_heads

# f32 on both sides, as tests/test_torch_localizer.py holds the planes and
# the volume (summation order through the encoders and the FFT) and the
# pose; the loss, metrics and gradients as torch_heads.
PLANE_ATOL = 1e-5
VOLUME_ATOL = 2e-5
POSE_ATOL = 1e-4
DIM = 32

Step = collections.namedtuple('Step', 'want got model batch')


def jax_config(modalities: str = 'streetview+aerial',
               backend: str = 'exhaustive', bev_net: bool = False,
               **model):
  """``smoke_localization.py:pose_backend=<backend>`` with the tiny mapper
  of ``modalities``, a tiny street-view query mapper (fusion (2 dim,
  2 dim, dim), as ``train_localization.py:107-119``) where the map has no
  street views, the data layers they read, and ``model`` overrides."""
  cfg = smoke_localization.get_config(f'pose_backend={backend}')
  names = modalities.split('+')
  cfg.model.bev_mapper = helpers.tiny_bev_mapper(names)
  if 'streetview' not in names:
    query = helpers.tiny_bev_mapper(('streetview',))
    query.streetview_encoder.fusion.layers = (DIM * 2, DIM * 2, DIM)
    cfg.model.bev_mapper_query = query
  if bev_net:  # As ``train_localization.py:101-103`` sets it.
    cfg.model.bev_mapper.bev_net = ml_collections.ConfigDict(
        dict(num_units=2, checkpoint_units=True))
  for key, value in model.items():
    setattr(cfg.model, key, value)
  cfg.data.add_images = 'streetview' in names
  cfg.data.add_rasters = True
  return cfg


def port_config(modalities: str = 'streetview+aerial',
                backend: str = 'exhaustive', bev_net: bool = False,
                **model) -> configs.Config:
  """The port's smoke training config of the same model."""
  make = (configs.smoke_train_exhaustive if backend == 'exhaustive'
          else configs.smoke_train_ransac)
  config = make(modalities=modalities, bev_net=int(bev_net))
  return configs.merge(config, {'model': model}) if model else config


def pair_batches(config: configs.Config, seed: int = 3, batch_mask=None):
  """The host generator's training batch 0: JAX's and the port's."""
  examples = loader.make_train_examples(loader.make_generator(config.data,
                                                              seed),
                                        0, config.batch_size, config.data)
  if batch_mask is not None:
    examples['batch_mask'] = np.asarray(batch_mask, np.float32)
  jbatch = jloader.process_batch(copy.deepcopy(examples),
                                 jtypes.DataMode.PAIR_SCENE_VIEW)
  jbatch.pop('_host')
  return jbatch, loader.pair_batch_to_torch(examples, 'cpu')


def jax_model(config: configs.Config, jcfg):
  return jbev_localizer.BEVLocalizerModel(
      jcfg.model, torch_heads.jax_meta(config), jnp.float32)


def localizer_step(config: configs.Config, jcfg, sampling_key: int = 2
                   ) -> Step:
  """One training step (``train=True``) of both packages."""
  jbatch, batch = pair_batches(config)
  with pytest.MonkeyPatch.context() as mp:
    want = torch_heads.jax_step(jax_model(config, jcfg), jbatch, True, mp,
                                sampling_key)
  model = torch_heads.port_model(config, want.params)
  z_jitter, = want.uniforms
  keep = None
  if want.draws:
    keep = torch_heads.modality_keep(want.draws[0])
  draws = bev_mapper.TrainDraws(z_jitter=torch.as_tensor(z_jitter.copy()),
                                modality_keep=keep)
  got = torch_heads.port_step(model, batch, True, draws=draws,
                              relu_sides=want.relu_sides)
  return Step(want, got, model, batch)


def ransac_step(config: configs.Config, jcfg) -> Step:
  """The RANSAC backend at ``train=False``, batch 2 with ``batch_mask
  [1, 0]``, JAX's pose samples injected into the port."""
  jbatch, batch = pair_batches(config, batch_mask=[1.0, 0.0])
  with pytest.MonkeyPatch.context() as mp:
    want = torch_heads.jax_step(jax_model(config, jcfg), jbatch, False, mp)
  model = torch_heads.port_model(config, want.params)
  samples = want.pred['map_t_query_samples']
  injected = geometry.Transform2D(
      angle=torch.from_numpy(np.array(samples.angle)[:, 1:]),
      t=torch.from_numpy(np.array(samples.t)[:, 1:]))
  loss, losses, metrics, pred = trainer.loss_and_metrics(
      model, batch, False, pose_samples=injected)
  named = list(model.named_parameters())
  grads = torch.autograd.grad(loss, [p for _, p in named], allow_unused=True)
  grads = {n: torch.zeros_like(p) if g is None else g
           for (n, p), g in zip(named, grads)}
  return Step(want, (float(loss.detach()), losses, metrics, pred, grads),
              model, batch)


def assert_plane_matches(got, want, atol: float = PLANE_ATOL):
  np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
  np.testing.assert_allclose(got.features.detach().numpy(),
                             np.asarray(want.features), atol=atol)


def assert_step_matches(step: Step):
  """The loss, the losses, the metrics (booleans exact) and every
  gradient leaf; returns the port's gradients in flax layout."""
  want = step.want
  loss, losses, metrics, _, grads = step.got
  torch_heads.assert_losses_match(loss, losses, want.loss, want.losses)
  for key, value in want.metrics.items():
    if value.dtype == bool:
      np.testing.assert_array_equal(metrics[key].numpy(), value, err_msg=key)
  torch_heads.assert_metrics_match(metrics, want.metrics)
  return torch_heads.assert_grads_match(grads, step.model, want.grads)


def assert_dense_poses_match(step: Step, volume_atol: float = VOLUME_ATOL):
  """The pose volume (finite where JAX's is), its argmax exactly, and the
  pose read from it."""
  want, pred = step.want.pred, step.got[3]
  w = np.asarray(want['scores_pose_volume'])
  g = pred['scores_pose_volume'].detach().numpy()
  np.testing.assert_array_equal(np.isfinite(g), np.isfinite(w))
  fin = np.isfinite(w)
  np.testing.assert_allclose(g[fin], w[fin], atol=volume_atol)
  np.testing.assert_array_equal(pred['best_volume_index'].numpy(),
                                np.asarray(want['best_volume_index']))
  np.testing.assert_allclose(pred['map_t_query'].t.detach().numpy(),
                             np.asarray(want['map_t_query'].t),
                             atol=POSE_ATOL)
  np.testing.assert_allclose(pred['map_t_query'].angle.detach().numpy(),
                             np.asarray(want['map_t_query'].angle),
                             atol=POSE_ATOL)


def nonzero(flat, prefix: str) -> bool:
  """Some gradient leaf under ``prefix`` is non-zero."""
  return any(np.abs(flat[k]).max() > 0
             for k in torch_heads.leaves_under(flat, prefix))

