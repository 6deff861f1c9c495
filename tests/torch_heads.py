"""Shared by the heads' parity tests: the JAX model as the oracle of the
port's, on the same single-scene batch and weights.

``jax_step`` runs a JAX model's masked-mean loss and ``jax.grad`` (jitted)
and returns, beside them, the Bernoulli draws of the forward (modality
dropout, flips) and its uniform ones (the query's z jitter) in the order
it took them, so that the port can be given the same draws, and the side each relu's input fell on. ``port_step``
makes the port's relus take JAX's sides (``chip_smoke.MaxChoices``): a
relu input within rounding of 0 may fall on the other side in the two
packages and move a gradient term (ROADMAP C11); the replay holds each
such flip to a near tie.
"""

import collections
import contextlib
import copy
import types

import flax.linen as nn
import jax
import numpy as np
import torch

import chip_smoke
from snap_tpu.data import loader as jloader
from snap_tpu.data import types as jtypes
from snap_tpu.utils import grids as jgrids
from snap_tpu_torch import configs
from snap_tpu_torch import convert
from snap_tpu_torch.data import loader
from snap_tpu_torch.data import types as data_types
from snap_tpu_torch.train_lib import trainer

JaxStep = collections.namedtuple(
    'JaxStep', 'params loss losses metrics pred grads draws relu_sides '
    'uniforms')

# f32 on both sides, as tests/test_torch_train.py holds the localizer: the
# loss to 1e-5 relative; each gradient leaf to 1e-4 of its largest entry
# plus 1e-7; float metrics to 1e-4.
LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-7
METRIC_TOL = 1e-4


def jax_meta(config: configs.Config) -> dict:
  """The JAX loader's ``meta_data`` a model is built from."""
  rasters = jtypes.RastersConfig()
  return {
      'grid': jgrids.Grid3D.from_extent_meters((24, 32, 12),
                                               config.data.voxel_size),
      'build_config': types.SimpleNamespace(scene_config=jtypes.SceneConfig(
          num_views=config.data.num_views)),
      'semantic_map_classes': rasters.semantic_classes,
      'semantic_classes_gt': rasters.gt_semantic_classes,
  }


def single_scene_batches(config: configs.Config, seed: int = 3):
  """One single-scene batch of ``config`` from the host generator: the
  JAX loader's and the port's (no strings)."""
  mode = data_types.DataMode.SINGLE_SCENE
  examples = loader.make_examples(loader.make_generator(config.data, seed),
                                  range(config.batch_size), config.data,
                                  mode)
  examples['batch_mask'] = np.ones(config.batch_size, np.float32)
  jbatch = jloader.process_batch(copy.deepcopy(examples),
                                 jtypes.DataMode.SINGLE_SCENE)
  jbatch.pop('_host')
  batch = loader.process_batch(examples, mode, 'cpu')
  batch.pop('_host')
  return jbatch, batch


@contextlib.contextmanager
def recorded(monkeypatch, module, name: str, keep=lambda args, out: out):
  """Record ``keep(args, out)`` of every call of ``module.name`` (tracers
  inside a jit: return them from the traced function)."""
  calls = []
  original = getattr(module, name)

  def record(*args, **kwargs):
    out = original(*args, **kwargs)
    calls.append(keep(args, out))
    return out
  monkeypatch.setattr(module, name, record)
  yield calls
  monkeypatch.setattr(module, name, original)


def jax_step(jmodel, jbatch, train: bool, monkeypatch, sampling_key: int = 2):
  """Init (key 0), then the masked-mean loss and ``jax.grad`` at
  ``train`` (the draws from ``sampling_key``): (params, loss, losses,
  metrics, pred, grads, draws)."""
  rngs = {'params': jax.random.PRNGKey(0), 'sampling': jax.random.PRNGKey(1)}
  # Rematerialization recomputes the same values; without it a relu's side
  # can be returned from the traced function.
  monkeypatch.setattr(nn, 'remat', lambda module, *args, **kwargs: module)
  params = jax.jit(lambda b: jmodel.flax_model.init(rngs, b, train=False))(
      jbatch)['params']
  with recorded(monkeypatch, jax.random, 'bernoulli') as draws, recorded(
      monkeypatch, jax.random, 'uniform') as uniforms, recorded(
          monkeypatch, nn, 'relu', lambda args, out: args[0] > 0) as sides:

    def loss_fn(p, b):
      del draws[:], uniforms[:], sides[:]
      pred = jmodel.flax_model.apply(
          {'params': p}, b, train=train,
          rngs={'sampling': jax.random.PRNGKey(sampling_key)})
      losses, metrics = jmodel.loss_metrics_function(pred, b, p)
      loss = losses['total'].mean(where=b['batch_mask'] > 0)
      return loss, (losses, metrics, pred, list(draws), list(sides),
                    list(uniforms))

    (loss, (losses, metrics, pred, taken, relu_sides, drawn)), grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(params, jbatch)
  as_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)
  return JaxStep(as_np(params), float(loss), as_np(losses), as_np(metrics),
                 pred, convert.flatten_params(as_np(grads)),
                 [np.asarray(d) for d in taken],
                 [torch.as_tensor(np.array(s)) for s in relu_sides],
                 [np.asarray(u) for u in drawn])


def port_model(config: configs.Config, params):
  """The port's model of ``config`` with the JAX model's weights."""
  from snap_tpu_torch import evaluator  # pylint: disable=g-import-not-at-top
  model = evaluator.build_model(config, 'cpu')
  model.load_state_dict(convert.params_from_flax(params, model))
  return model


def relu_replay(model, batch, train: bool, relu_sides, **inject):
  """The choices for ``chip_smoke.MaxChoices`` to replay: ``relu_sides``
  (JAX's, in call order) at the port's relus, the port's own choices at
  its other max sites (a forward without autograd records them)."""
  with torch.no_grad(), chip_smoke.MaxChoices(model) as own:
    trainer.loss_and_metrics(model, batch, train, **inject)
  sides = iter(relu_sides)
  replay = [next(sides) if site == 'F.relu' else call
            for site, call in zip(own.sites, own.calls)]
  assert next(sides, None) is None
  assert [tuple(c.shape) for c in own.calls] == [
      tuple(c.shape) for c in replay]
  return replay


def port_step(model, batch, train: bool, draws=None, relu_sides=None,
              pose_samples=None):
  """The port's masked-mean loss and its gradients by parameter name (0
  where the loss does not reach a parameter); its relus take
  ``relu_sides`` (JAX's, in call order), its other max sites their own
  choices; ``pose_samples`` go to the RANSAC backend."""
  replay = relu_replay(model, batch, train, relu_sides, draws=draws,
                       pose_samples=pose_samples)
  with chip_smoke.MaxChoices(model, replay=replay):
    loss, losses, metrics, pred = trainer.loss_and_metrics(
        model, batch, train, draws=draws, pose_samples=pose_samples)
  named = list(model.named_parameters())
  grads = torch.autograd.grad(loss, [p for _, p in named], allow_unused=True)
  grads = {n: torch.zeros_like(p) if g is None else g
           for (n, p), g in zip(named, grads)}
  return float(loss.detach()), losses, metrics, pred, grads


def modality_keep(raw: np.ndarray) -> torch.Tensor:
  """JAX's ``[M, B]`` Bernoulli draw as the kept modalities: an example
  that would lose every one keeps them all (``bev_mapper.py:267-276``)."""
  return torch.as_tensor(raw | ~raw.any(0))


def assert_losses_match(got_loss, got_losses, want_loss, want_losses):
  assert np.isfinite(got_loss)
  np.testing.assert_allclose(got_loss, want_loss, rtol=LOSS_RTOL)
  assert set(got_losses) == set(want_losses)
  for key, want in want_losses.items():
    np.testing.assert_allclose(got_losses[key].detach().numpy(), want,
                               rtol=LOSS_RTOL, err_msg=key)


def assert_metrics_match(got_metrics, want_metrics):
  assert set(got_metrics) == set(want_metrics)
  for key, want in want_metrics.items():
    got = got_metrics[key].detach().numpy()
    np.testing.assert_allclose(got, want, rtol=METRIC_TOL, atol=METRIC_TOL,
                               err_msg=key)


def assert_grads_match(grads, model, want):
  """Leaf by leaf, in flax layout; equal leaf sets."""
  got = convert.flax_from_torch(grads, model)
  assert set(got) == set(want)
  for key in sorted(want):
    assert got[key].shape == want[key].shape, key
    scale = float(np.abs(want[key]).max())
    err = float(np.abs(got[key] - want[key]).max())
    assert err <= GRAD_RTOL * scale + GRAD_ATOL, (key, err, scale)
  return got


def leaves_under(flat, prefix: str):
  """The flax paths under ``prefix``, non-empty."""
  keys = [k for k in flat if k.startswith(prefix)]
  assert keys
  return keys

