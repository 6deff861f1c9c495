"""Freezing by regex and SGD against the JAX package's optax chain.

The harness of ``tests/test_torch_train.py``: the JAX trainer's
``train_step`` (clip + the optax chain of ``optimizers.get_optimizer``,
the non-finite skip) on a flax module whose parameters are the prediction,
against ``trainer.apply_gradients`` with the port's chain on the same
parameters and gradients. Parameters carry flax paths, so the port's names
(``bev_mapper.Dense_0.weight``) map onto them as ``convert.flax_path``
maps them.
"""

import copy
import dataclasses
import types

import flax
import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snap_tpu.configs import defaults
from snap_tpu.configs import smoke_localization
from snap_tpu.data import loader as jloader
from snap_tpu.data import types as jtypes
from snap_tpu.models import bev_localizer as jbev_localizer
from snap_tpu.train_lib import lr_schedules as jlr_schedules
from snap_tpu.train_lib import optimizers as joptimizers
from snap_tpu.train_lib import trainer as jtrainer
from snap_tpu.utils import grids as jgrids
from snap_tpu_torch import configs
from snap_tpu_torch import convert
from snap_tpu_torch import evaluate
from snap_tpu_torch.data import loader
from snap_tpu_torch.train_lib import optimizers
from snap_tpu_torch.train_lib import trainer

torch.set_num_threads(2)

# The tolerances of tests/test_torch_train.py's optimizer test.
LR_RTOL, LR_ATOL_OF_BASE = 1e-6, 1e-6
PARAM_ATOL, PARAM_RTOL = 1e-6, 1e-5
# Adam's second bias correction 1 - b2^t is formed in f32 on both sides,
# and torch's and XLA's f32 pow may round b2^t an ulp apart: 1 - 0.999^3
# then differs by ~2e-5 relative, the update by half that (measured
# 1.0e-5 at t = 3). The update norm is held to 3e-5; l2_grads to 1e-5.
UPDATE_NORM_RTOL, GRAD_NORM_RTOL = 3e-5, 1e-5

# flax path -> shape; the port's names follow ``convert.flax_path``.
SHAPES = {'bev_mapper/aerial/Dense_0/kernel': (3, 4),
          'bev_mapper/aerial/Dense_0/bias': (4,),
          'bev_mapper/street/conv/kernel': (1, 1, 2, 3),
          'temperature': ()}
NAMES = {'bev_mapper/aerial/Dense_0/kernel': 'bev_mapper.aerial.Dense_0.weight',
         'bev_mapper/aerial/Dense_0/bias': 'bev_mapper.aerial.Dense_0.bias',
         'bev_mapper/street/conv/kernel': 'bev_mapper.street.conv.weight',
         'temperature': 'temperature'}


class _Leaves(nn.Module):
  """The parameters of ``SHAPES`` handed back as the prediction."""

  @nn.compact
  def __call__(self, batch, train=False):
    del batch, train
    return {path: self.param(path, nn.initializers.zeros, shape)
            for path, shape in SHAPES.items()}


def _linear_loss(pred, batch, params=None):
  """d loss / d leaf = batch[leaf]."""
  del params
  total = sum((pred[k] * batch[k]).sum() for k in SHAPES)
  return {'total': total[None]}, {}


def _nested(flat):
  return flax.traverse_util.unflatten_dict(
      {tuple(k.split('/')): v for k, v in flat.items()})


def _run_both(opt: configs.OptimizerConfig, steps: int = 6):
  """The JAX chain and the port's over ``steps`` steps (the first under a
  warmup at lr 0, clipping on the large ones, a NaN gradient on step 2);
  returns both sides' params, logs and states per step."""
  lr = configs.LrConfig(factors='constant * linear_warmup * cosine_decay',
                        base_learning_rate=1e-2, warmup_steps=3,
                        start_decay_step=2, steps_per_cycle=6)
  tcfg = configs.TrainConfig(lr_configs=lr, optimizer_configs=opt,
                             max_grad_norm=1.0)
  ref = defaults.base()
  ref.lr_configs.update(dataclasses.asdict(lr))
  ref.optimizer_configs.update(dataclasses.asdict(opt))
  ref.max_grad_norm = 1.0
  rng = np.random.default_rng(0)
  init = {k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}
  # The flax module names its params by the full path: one level, '/' kept
  # inside the name, as make_freeze_mask joins them.
  jparams = {k: jnp.asarray(v) for k, v in init.items()}
  lr_fn = jlr_schedules.get_learning_rate_fn(ref)
  tx = joptimizers.get_optimizer(ref, lr_fn, params=jparams)
  jstate = jtrainer.TrainState(
      global_step=jnp.zeros((), jnp.int32), params=jparams,
      opt_state=tx.init(jparams), model_state={}, rng=jax.random.PRNGKey(0),
      tx=tx)
  step_fn = jax.jit(lambda s, b: jtrainer.train_step(
      s, b, flax_model=_Leaves(), loss_metrics_fn=_linear_loss, lr_fn=lr_fn,
      has_model_state=False))
  names = [NAMES[k] for k in SHAPES]
  params = [torch.from_numpy(init[k].copy()) for k in SHAPES]
  chain = optimizers.Adam(tcfg, names)
  state = trainer.TrainState(model=None, opt_state=chain.init(params),
                             global_step=0, seed=0, tx=chain)
  out = []
  for step, scale in enumerate([0.05, 5.0, 0.1, 0.1, 3.0, 0.1][:steps]):
    g = {k: (rng.normal(size=s) * scale).astype(np.float32)
         for k, s in SHAPES.items()}
    if step == 2:
      g['temperature'] = np.float32(np.nan)
    batch = {k: jnp.asarray(v) for k, v in g.items()}
    batch['batch_mask'] = jnp.ones((1,), jnp.float32)
    jstate, _, jlogs = step_fn(jstate, batch)
    logs = trainer.apply_gradients(
        params, [torch.from_numpy(np.asarray(g[k])) for k in SHAPES], state,
        chain)
    out.append((jax.tree_util.tree_map(np.asarray, jstate.params),
                jax.tree_util.tree_map(np.asarray, jlogs),
                [p.numpy().copy() for p in params], logs))
  return out, init, chain, state, jstate


def _assert_matches(out, base_lr=1e-2):
  for step, (jparams, jlogs, params, logs) in enumerate(out):
    assert logs['is_finite'] == bool(jlogs['is_finite']) == (step != 2)
    assert logs['learning_rate'] == pytest.approx(
        float(jlogs['learning_rate']), rel=LR_RTOL,
        abs=LR_ATOL_OF_BASE * base_lr)
    if step != 2:
      for key, rtol in (('l2_grads', GRAD_NORM_RTOL),
                        ('l2_updates', UPDATE_NORM_RTOL)):
        assert logs[key] == pytest.approx(float(jlogs[key]), rel=rtol), key
    for got, key in zip(params, SHAPES):
      np.testing.assert_allclose(got, jparams[key], atol=PARAM_ATOL,
                                 rtol=PARAM_RTOL, err_msg=f'{step} {key}')


FREEZE = 'bev_mapper/aerial/'
FROZEN = ['bev_mapper/aerial/Dense_0/kernel', 'bev_mapper/aerial/Dense_0/bias']


@pytest.mark.parametrize('allocate', [True, False])
@pytest.mark.parametrize('optimizer', ['adam', 'adamw'])
def test_freezing_matches_the_optax_chain(allocate, optimizer):
  opt = configs.OptimizerConfig(
      optimizer=optimizer, weight_decay=1e-2 if optimizer == 'adamw' else 0.0,
      freeze_params_reg_exp=FREEZE, allocate_frozen_state=allocate)
  out, init, chain, state, jstate = _run_both(opt)
  _assert_matches(out)
  assert chain.frozen == [k in FROZEN for k in SHAPES]
  for key, got in zip(SHAPES, out[-1][2]):
    if key in FROZEN:  # frozen tensors do not move
      np.testing.assert_array_equal(got, init[key])
    else:
      assert not np.array_equal(got, init[key]), key
  # The lean setting allocates no moments for frozen parameters, as the
  # optax chain's masked state does not.
  jleaves = jax.tree_util.tree_leaves(jstate.opt_state)
  moments = len(state.opt_state.mu) + len(state.opt_state.nu)
  if allocate:
    assert moments == 2 * len(SHAPES)
  else:
    assert moments == 2 * (len(SHAPES) - len(FROZEN))
    assert len(state.opt_state.mu[0].shape) == 4  # the first trainable
  assert sum(x.size for x in jleaves if x.ndim) == sum(
      t.numel() for t in state.opt_state.mu + state.opt_state.nu if t.ndim)


def test_allocate_frozen_state_changes_what_clipping_sees():
  """True clips over every gradient, False over the trainable ones only:
  the two runs differ, each as optax's does."""
  runs = {}
  for allocate in (True, False):
    opt = configs.OptimizerConfig(freeze_params_reg_exp=FREEZE,
                                  allocate_frozen_state=allocate)
    out, *_ = _run_both(opt, steps=2)
    _assert_matches(out)
    runs[allocate] = out[1][2]
  assert not np.array_equal(runs[True][2], runs[False][2])


@pytest.mark.parametrize('freeze,allocate', [(None, True), (FREEZE, False)])
def test_sgd_matches_optax_sgd(freeze, allocate):
  """``optax.sgd(lr, momentum=0.9)`` after the clip, through the trainer
  harness (the lr-0 warmup step, clipping, the NaN skip); and frozen, with
  no trace for the frozen parameters."""
  opt = configs.OptimizerConfig(optimizer='sgd', freeze_params_reg_exp=freeze,
                                allocate_frozen_state=allocate)
  out, init, _, state, _ = _run_both(opt)
  _assert_matches(out)
  assert not state.opt_state.nu
  assert len(state.opt_state.mu) == len(SHAPES) - (
      0 if freeze is None else len(FROZEN))
  for key, got in zip(SHAPES, out[-1][2]):
    assert np.array_equal(got, init[key]) == (freeze is not None
                                              and key in FROZEN), key


@pytest.fixture(scope='module')
def smoke_flax_params():
  """The flax params' shapes of ``smoke_localization.py:exhaustive``."""
  cfg = smoke_localization.get_config('pose_backend=exhaustive')
  grid = jgrids.Grid3D.from_extent_meters((24, 32, 12), 1.0)
  meta = {'build_config': types.SimpleNamespace(
              scene_config=jtypes.SceneConfig(num_views=3)),
          'grid': grid, 'semantic_map_classes': None}
  jmodel = jbev_localizer.BEVLocalizerModel(cfg.model, meta, jnp.float32)
  tcfg = configs.smoke_train_exhaustive(batch_size=2)
  examples = loader.make_train_examples(loader.make_generator(tcfg.data, 3),
                                        0, 2, tcfg.data)
  jbatch = jloader.process_batch(copy.deepcopy(examples),
                                 jtypes.DataMode.PAIR_SCENE_VIEW)
  jbatch.pop('_host')
  rngs = {'params': jax.random.PRNGKey(0), 'sampling': jax.random.PRNGKey(1)}
  return jax.eval_shape(lambda b: jmodel.flax_model.init(rngs, b, train=False),
                        jbatch)['params']


@pytest.mark.parametrize('regex', ['bev_mapper/', 'streetview_encoder/',
                                   'aerial_encoder/encoder/block1/',
                                   r'^bev_mapper/.*/kernel/$', 'temperature'])
def test_the_same_regex_freezes_the_same_tensors(smoke_flax_params, regex):
  """On the smoke model: the port's mask over its parameter names equals
  ``make_freeze_mask`` over the flax params."""
  want = {'/'.join(k) for k, v in flax.traverse_util.flatten_dict(
      joptimizers.make_freeze_mask(smoke_flax_params, regex)).items() if v}
  model = evaluate.build_model(configs.smoke_train_exhaustive(), 'cpu')
  names = [n for n, _ in model.named_parameters()]
  assert {convert.flax_path(n) for n in names} == {
      '/'.join(k) for k in flax.traverse_util.flatten_dict(smoke_flax_params)}
  got = {convert.flax_path(n) for n, f in zip(
      names, optimizers.freeze_mask(names, regex)) if f}
  assert got == want and got


def test_frozen_mapper_does_not_move_in_a_train_step():
  """``freeze_params_reg_exp='bev_mapper/'`` on the smoke model: one step
  moves the temperature and nothing of the mapper; the lean setting
  allocates moments for the temperature only."""
  cfg = configs.smoke_train_exhaustive()
  opt = dataclasses.replace(cfg.train.optimizer_configs,
                            freeze_params_reg_exp='bev_mapper/',
                            allocate_frozen_state=False)
  cfg = dataclasses.replace(cfg, train=dataclasses.replace(
      cfg.train, optimizer_configs=opt))
  model = evaluate.build_model(cfg, 'cpu', 0)
  before = {n: p.detach().clone() for n, p in model.named_parameters()}
  chain = optimizers.get_optimizer(cfg.train, model)
  state = trainer.create_train_state(model, chain, seed=0)
  assert len(state.opt_state.mu) == len(state.opt_state.nu) == 1
  examples = loader.make_train_examples(loader.make_generator(cfg.data, 2),
                                        0, 2, cfg.data)
  out = trainer.train_step(state, loader.pair_batch_to_torch(examples, 'cpu'),
                           chain)
  assert out.logs['is_finite'] == 1.0
  for name, p in model.named_parameters():
    if name.startswith('bev_mapper.'):
      assert torch.equal(p, before[name]), name
      assert out.grads[name].abs().max() > 0 or 'bias' in name
    else:
      assert not torch.equal(p, before[name]), name
