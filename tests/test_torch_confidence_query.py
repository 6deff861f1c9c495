"""Port parity of query confidence (``add_confidence_query``) on both pose
backends (``snap_tpu/models/bev_localizer.py:104-124,183-192,264-271``).

The JAX package is the oracle, on the CPU as tests/conftest.py sets it up,
with the tiny models of ``tests/torch_a14.py`` and their flax-initialized
weights carried over by ``convert.params_from_flax``:

- the aerial-only localizer with its street-view query mapper, so that the
  map's confidence head (built, as the reference builds it, and unused)
  and the query's are apart: on the exhaustive backend one training step
  with JAX's draws injected, on the RANSAC backend the loss at
  ``train=False`` with JAX's pose samples injected; the loss, metrics and
  every gradient leaf, the map's head 0 on both sides and the query's not;
- the analogue of ``tests/test_models.py:194-215``: the gradient of the
  dense volume's finite sum reaches the (shared) mapper's confidence head,
  and equals JAX's leaf by leaf.

Tolerances: ``tests/torch_a14.py``.
"""

import jax
import numpy as np
import pytest
import torch

from snap_tpu_torch import configs
from snap_tpu_torch import convert
from snap_tpu_torch import evaluator
import torch_a14
import torch_heads

torch.set_num_threads(2)
MAP_HEAD = 'bev_mapper/confidence_head/'
QUERY_HEAD = 'bev_mapper_query/confidence_head/'


def _configs(backend: str):
  return (torch_a14.port_config('aerial', backend,
                                add_confidence_query=True),
          torch_a14.jax_config('aerial', backend, add_confidence_query=True))


def _assert_heads(got, want):
  """The map's head takes no gradient, the query's does."""
  for grads in (got, want):
    for key in torch_heads.leaves_under(grads, MAP_HEAD):
      assert not np.abs(grads[key]).any(), key
    assert torch_a14.nonzero(grads, QUERY_HEAD)


def test_config_is_the_reference():
  config, jcfg = _configs('exhaustive')
  assert configs.from_reference(jcfg.to_dict()).model == config.model
  assert config.model.add_confidence_query
  with pytest.raises(NotImplementedError, match='Map confidence'):
    evaluator.build_model(configs.merge(
        config, {'model': {'add_confidence_map': True}}), 'cpu')


def test_exhaustive_step_matches_jax():
  step = torch_a14.localizer_step(*_configs('exhaustive'))
  pred = step.got[3]
  assert pred['query']['bev_confidence'].shape == pred['query'][
      'bev_matching'].valid.shape
  np.testing.assert_allclose(
      pred['query']['bev_confidence'].detach().numpy(),
      np.asarray(step.want.pred['query']['bev_confidence']),
      atol=torch_a14.PLANE_ATOL)
  torch_a14.assert_dense_poses_match(step)
  got = torch_a14.assert_step_matches(step)
  _assert_heads(got, step.want.grads)


def test_ransac_loss_matches_jax():
  """The points weighted by the masked softmax of the query's confidence:
  the sampled poses' scores, the loss and every gradient leaf."""
  step = torch_a14.ransac_step(*_configs('ransac'))
  pred, want = step.got[3], step.want.pred
  np.testing.assert_array_equal(pred['best_index'].numpy(),
                                np.asarray(want['best_index']))
  np.testing.assert_allclose(pred['scores_poses'].detach().numpy(),
                             np.asarray(want['scores_poses']),
                             rtol=1e-4, atol=1e-5)
  got = torch_a14.assert_step_matches(step)
  _assert_heads(got, step.want.grads)


def test_confidence_reaches_the_dense_volume():
  """``test_models.py:test_confidence_affects_dense_volume``: the gradient
  of the volume's finite sum (``train=False``) reaches the confidence head
  of the mapper the query goes through; every leaf equals JAX's."""
  config = torch_a14.port_config(add_confidence_query=True)
  jcfg = torch_a14.jax_config(add_confidence_query=True)
  jbatch, batch = torch_a14.pair_batches(config)
  jmodel = torch_a14.jax_model(config, jcfg)
  rngs = {'params': jax.random.PRNGKey(0), 'sampling': jax.random.PRNGKey(1)}
  params = jax.jit(lambda b: jmodel.flax_model.init(rngs, b, train=False))(
      jbatch)['params']

  def vol_sum(p):
    out = jmodel.flax_model.apply({'params': p}, jbatch, train=False,
                                  rngs={'sampling': jax.random.PRNGKey(2)})
    vol = out['scores_pose_volume']
    return jax.numpy.where(jax.numpy.isfinite(vol), vol, 0.0).sum()

  want = convert.flatten_params(jax.tree_util.tree_map(
      np.asarray, jax.jit(jax.grad(vol_sum))(params)))
  model = torch_heads.port_model(
      config, jax.tree_util.tree_map(np.asarray, params))
  vol = model(batch)['scores_pose_volume']
  named = list(model.named_parameters())
  grads = torch.autograd.grad(torch.where(torch.isfinite(vol), vol, 0).sum(),
                              [p for _, p in named], allow_unused=True)
  grads = {n: torch.zeros_like(p) if g is None else g
           for (n, p), g in zip(named, grads)}
  got = torch_heads.assert_grads_match(grads, model, want)
  total = sum(float(np.abs(got[k]).sum())
              for k in torch_heads.leaves_under(got, MAP_HEAD))
  assert total > 0.0
