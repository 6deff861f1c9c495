"""Port parity of the training path: loss, gradients, schedule, optimizer.

The JAX package is the oracle, on the CPU as tests/conftest.py sets it up:
``BEVLocalizerModel.loss_metrics_function`` and ``jax.grad`` of the
masked-mean loss on ``smoke_localization.py:pose_backend=exhaustive`` with
flax-initialized weights carried over by ``convert``, and the JAX trainer's
``train_step`` with the optax chain of ``optimizers.get_optimizer``. The
JAX side runs at ``train=False``: the two packages' random streams differ,
so the training draws are tested on the port alone, injected.
"""

import copy
import dataclasses
import json
import math
import types

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snap_tpu.configs import defaults
from snap_tpu.configs import smoke_localization
from snap_tpu.configs import train_localization
from snap_tpu.data import loader as jloader
from snap_tpu.data import types as jtypes
from snap_tpu.models import bev_localizer as jbev_localizer
from snap_tpu.train_lib import lr_schedules as jlr_schedules
from snap_tpu.train_lib import optimizers as joptimizers
from snap_tpu.train_lib import trainer as jtrainer
from snap_tpu.utils import grids as jgrids
from snap_tpu_torch import configs
from snap_tpu_torch import convert
from snap_tpu_torch import train
from snap_tpu_torch.data import loader
from snap_tpu_torch.models import bev_localizer
from snap_tpu_torch.models import bev_mapper
from snap_tpu_torch.train_lib import lr_schedules
from snap_tpu_torch.train_lib import optimizers
from snap_tpu_torch.train_lib import trainer

torch.set_num_threads(2)

# f32 on both sides. The loss is a logsumexp over the volume: it differs by
# the encoders' and the FFT's summation order (measured ~3e-6 relative).
LOSS_RTOL = 1e-5
# Per-leaf gradients, against the largest entry of the leaf: the worst leaf
# measured 3e-6 of its largest entry; 1e-4 of it plus 1e-7 absolute.
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-7
# Schedule and optimizer: float64 (port) against float32 (JAX) factors;
# 1 + cos(pi t) near the end of a cycle cancels in f32, so the schedule is
# also held to 1e-6 of the base rate absolute.
LR_RTOL, LR_ATOL_OF_BASE = 1e-6, 1e-6
PARAM_ATOL, PARAM_RTOL = 1e-6, 1e-5


def _jax_smoke_model():
  cfg = smoke_localization.get_config('pose_backend=exhaustive')
  grid = jgrids.Grid3D.from_extent_meters((24, 32, 12), 1.0)
  meta = {'build_config': types.SimpleNamespace(
              scene_config=jtypes.SceneConfig(num_views=3)),
          'grid': grid, 'semantic_map_classes': None}
  return jbev_localizer.BEVLocalizerModel(cfg.model, meta, jnp.float32)


@pytest.fixture(scope='module')
def smoke_grads():
  """The masked-mean loss and its gradients on both sides, batch 2."""
  tcfg = configs.smoke_train_exhaustive(batch_size=2)
  examples = loader.make_train_examples(loader.make_generator(tcfg.data, 3),
                                        0, 2, tcfg.data)
  examples['batch_mask'] = np.asarray([1.0, 0.0], np.float32)
  jbatch = jloader.process_batch(copy.deepcopy(examples),
                                 jtypes.DataMode.PAIR_SCENE_VIEW)
  jbatch.pop('_host')
  jmodel = _jax_smoke_model()
  rngs = {'params': jax.random.PRNGKey(0), 'sampling': jax.random.PRNGKey(1)}
  params = jax.jit(
      lambda b: jmodel.flax_model.init(rngs, b, train=False))(jbatch)[
          'params']

  def loss_fn(p, b):
    pred = jmodel.flax_model.apply(
        {'params': p}, b, train=False,
        rngs={'sampling': jax.random.PRNGKey(2)})
    losses, metrics = jmodel.loss_metrics_function(pred, b, p)
    return losses['total'].mean(where=b['batch_mask'] > 0), (losses, metrics)

  (jloss, (jlosses, jmetrics)), jgrads = jax.jit(
      jax.value_and_grad(loss_fn, has_aux=True))(params, jbatch)

  model = bev_localizer.BEVLocalizer(
      tcfg.model, loader.map_grid(tcfg.data).bev(), dtype=torch.float32)
  model.load_state_dict(convert.params_from_flax(
      jax.tree_util.tree_map(np.asarray, params), model))
  batch = loader.pair_batch_to_torch(examples, 'cpu')
  loss, losses, metrics, _ = trainer.loss_and_metrics(model, batch, False)
  names = [n for n, _ in model.named_parameters()]
  grads = torch.autograd.grad(
      loss, [p for _, p in model.named_parameters()], allow_unused=True)
  grads = {n: g for n, g in zip(names, grads)}
  return dict(
      want=(float(jloss), jax.tree_util.tree_map(np.asarray, jlosses),
            jax.tree_util.tree_map(np.asarray, jmetrics),
            convert.flatten_params(jax.tree_util.tree_map(np.asarray,
                                                          jgrads))),
      got=(float(loss.detach()), losses, metrics, grads), model=model)


def test_loss_and_metrics_match_jax(smoke_grads):
  want_loss, want_losses, want_metrics, _ = smoke_grads['want']
  got_loss, got_losses, got_metrics, _ = smoke_grads['got']
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


def test_per_parameter_gradients_match_jax(smoke_grads):
  """Leaf by leaf through ``convert.flax_from_torch``; equal leaf sets."""
  _, _, _, want = smoke_grads['want']
  _, _, _, grads = smoke_grads['got']
  assert all(g is not None for g in grads.values())
  got = convert.flax_from_torch(grads, smoke_grads['model'])
  assert set(got) == set(want)
  for key in sorted(want):
    assert got[key].shape == want[key].shape, key
    scale = np.abs(want[key]).max()
    np.testing.assert_allclose(got[key], want[key],
                               atol=GRAD_ATOL + GRAD_RTOL * scale, rtol=0,
                               err_msg=key)
  trunk = 'bev_mapper/streetview_encoder/image_encoder/encoder/'
  assert np.abs(got[trunk + 'root_block/conv_root/kernel']).max() > 0
  assert np.abs(got['temperature']).max() > 0


def test_flax_from_torch_inverts_params_from_flax(smoke_grads):
  model = smoke_grads['model']
  flat = convert.flax_from_torch(dict(model.named_parameters()), model)
  state = convert.params_from_flax(flat, model)
  for name, p in model.named_parameters():
    assert torch.equal(state[name], p.detach())


def _assert_fields_equal(port, ref, path=''):
  """Every field of the port's config equals the JAX config's same key."""
  for field in dataclasses.fields(port):
    value, name = getattr(port, field.name), f'{path}{field.name}'
    if field.name not in ref:
      continue  # a port-only field
    if dataclasses.is_dataclass(value):
      _assert_fields_equal(value, ref[field.name], name + '.')
    else:
      want = ref[field.name]
      if isinstance(value, tuple):
        value, want = tuple(value), tuple(want)
      assert value == want, (name, value, want)


@pytest.mark.parametrize('name,ref_args', [
    ('train_full1chip_exhaustive', 'scale=full1chip,pose_backend=exhaustive'),
    ('smoke_train_exhaustive', None),
    ('train_full1chip_ransac', 'scale=full1chip'),
    ('smoke_train_ransac', None),
])
def test_train_configs_equal_jax(name, ref_args):
  """``ref_args`` None: ``smoke_localization.py``, with the backend in the
  port config's name (RANSAC is its default)."""
  port = configs.get_config(name)
  if ref_args is None:
    ref = smoke_localization.get_config(
        'pose_backend=exhaustive' if name.endswith('exhaustive') else None)
  else:
    ref = train_localization.get_config(ref_args)
  _assert_fields_equal(port.model, ref.model)
  _assert_fields_equal(port.data, ref.data)
  _assert_fields_equal(port.train, ref)
  assert port.dtype_str == ref.dtype_str
  if ref_args is not None:
    assert port.batch_size == ref.batch_size == 2
    assert not port.model.do_grid_refinement
    assert port.model.bev_mapper.scene_z_offset_range == (-2, 2)
    assert port.model.bev_mapper.apply_modality_dropout


@pytest.mark.parametrize('factors', [
    'constant * linear_warmup * cosine_decay',
    'constant * linear_decay',
    'constant * linear_warmup * rsqrt_decay',
])
def test_lr_schedule_matches_jax(factors):
  cfg = configs.LrConfig(factors=factors, base_learning_rate=2e-4,
                         warmup_steps=5, start_decay_step=8,
                         steps_per_cycle=20)
  ref = defaults.base()
  ref.lr_configs.update(dataclasses.asdict(cfg))
  want = jlr_schedules.get_learning_rate_fn(ref)
  got = lr_schedules.get_learning_rate_fn(cfg)
  for step in range(0, 40, 3):
    assert got(step) == pytest.approx(
        float(want(step)), rel=LR_RTOL,
        abs=LR_ATOL_OF_BASE * cfg.base_learning_rate)
  if 'warmup' in factors:
    assert got(0) == 0.0


def test_full1chip_schedule_starts_at_zero():
  lr = lr_schedules.get_learning_rate_fn(
      configs.train_full1chip_exhaustive().train.lr_configs)
  assert lr(0) == 0.0
  assert lr(1) == pytest.approx(2e-7)
  assert lr(1000) == pytest.approx(2e-4)
  assert lr(20_000) == pytest.approx(0.0, abs=1e-12)


class _Leaves(nn.Module):
  """Two parameter leaves handed back as the prediction."""

  @nn.compact
  def __call__(self, batch, train=False):
    del train
    return {'w': self.param('w', nn.initializers.zeros, (3, 4)),
            'b': self.param('b', nn.initializers.zeros, (4,))}


def _linear_loss(pred, batch, params=None):
  """d loss / d leaf = batch['g_' + leaf]."""
  del params
  total = (pred['w'] * batch['g_w']).sum() + (pred['b'] * batch['g_b']).sum()
  return {'total': total[None]}, {}


@pytest.mark.parametrize('optimizer,weight_decay', [('adam', 0.0),
                                                    ('adamw', 1e-2)])
def test_optimizer_matches_optax_through_the_jax_trainer(optimizer,
                                                         weight_decay):
  """Six steps of the JAX trainer's ``train_step`` (clip + optax Adam, the
  non-finite skip) against ``trainer.apply_gradients``: warmup lr 0 on the
  first update, clipping on steps 1 and 4, a NaN gradient on step 2."""
  lr = configs.LrConfig(factors='constant * linear_warmup * cosine_decay',
                        base_learning_rate=1e-2, warmup_steps=3,
                        start_decay_step=2, steps_per_cycle=6)
  opt = configs.OptimizerConfig(optimizer=optimizer,
                                weight_decay=weight_decay)
  tcfg = configs.TrainConfig(lr_configs=lr, optimizer_configs=opt,
                             max_grad_norm=1.0)
  ref = defaults.base()
  ref.lr_configs.update(dataclasses.asdict(lr))
  ref.optimizer_configs.optimizer = optimizer
  ref.optimizer_configs.weight_decay = weight_decay
  ref.max_grad_norm = 1.0
  lr_fn = jlr_schedules.get_learning_rate_fn(ref)
  tx = joptimizers.get_optimizer(ref, lr_fn)
  rng = np.random.default_rng(0)
  init = {'w': rng.normal(size=(3, 4)).astype(np.float32),
          'b': rng.normal(size=4).astype(np.float32)}
  jstate = jtrainer.TrainState(
      global_step=jnp.zeros((), jnp.int32),
      params=jax.tree_util.tree_map(jnp.asarray, init),
      opt_state=tx.init(init), model_state={},
      rng=jax.random.PRNGKey(0), tx=tx)
  step_fn = jax.jit(lambda s, b: jtrainer.train_step(
      s, b, flax_model=_Leaves(), loss_metrics_fn=_linear_loss, lr_fn=lr_fn,
      has_model_state=False))

  params = [torch.from_numpy(init['w'].copy()),
            torch.from_numpy(init['b'].copy())]
  adam = optimizers.Adam(tcfg)
  state = trainer.TrainState(model=None, opt_state=adam.init(params),
                             global_step=0, seed=0)
  scales = [0.05, 5.0, 0.1, 0.1, 3.0, 0.1]
  clipped = 0
  for step, scale in enumerate(scales):
    g = {k: (rng.normal(size=v.shape) * scale).astype(np.float32)
         for k, v in init.items()}
    if step == 2:
      g['w'][1, 2] = np.nan
    jstate, _, jlogs = step_fn(jstate, {
        'g_w': jnp.asarray(g['w']), 'g_b': jnp.asarray(g['b']),
        'batch_mask': jnp.ones((1,), jnp.float32)})
    logs = trainer.apply_gradients(
        params, [torch.from_numpy(g['w']), torch.from_numpy(g['b'])], state,
        adam)
    assert logs['is_finite'] == bool(jlogs['is_finite']) == (step != 2)
    assert logs['learning_rate'] == pytest.approx(
        float(jlogs['learning_rate']), rel=LR_RTOL,
        abs=LR_ATOL_OF_BASE * lr.base_learning_rate)
    if step != 2:
      clipped += logs['l2_grads'] > 1.0
      for key in ('l2_grads', 'l2_updates'):
        assert logs[key] == pytest.approx(float(jlogs[key]), rel=1e-5)
    for got, key in zip(params, ('w', 'b')):
      np.testing.assert_allclose(got.numpy(),
                                 np.asarray(jstate.params[key]),
                                 atol=PARAM_ATOL, rtol=PARAM_RTOL)
    if step == 0:
      np.testing.assert_array_equal(params[0].numpy(), init['w'])  # lr 0
  assert clipped == 2
  assert state.global_step == int(jstate.global_step) == len(scales)
  assert state.opt_state.count == len(scales) - 1  # the skipped step


def test_clip_by_global_norm_is_optax_rule():
  """``g * max / ||g||`` above the norm; ``clip_grad_norm_``'s +1e-6 is not
  the rule."""
  g = [torch.tensor([3.0, 4.0]), torch.tensor([12.0])]
  got = optimizers.clip_by_global_norm(g, 1.0)
  assert torch.equal(got[0], torch.tensor([3.0, 4.0]) / 13.0)
  assert float(optimizers.global_norm(got)) == pytest.approx(1.0, rel=1e-7)
  small = optimizers.clip_by_global_norm(g, 100.0)
  assert all(torch.equal(a, b) for a, b in zip(small, g))


def _smoke_model(seed=0):
  from snap_tpu_torch import evaluate  # pylint: disable=g-import-not-at-top
  return evaluate.build_model(configs.smoke_train_exhaustive(), 'cpu',
                                  seed)


def test_draws_keep_a_modality_and_repeat_per_seed():
  mapper = _smoke_model().bev_mapper
  draws = [mapper.sample_draws(64, torch.Generator().manual_seed(5), 'cpu')
           for _ in range(2)]
  assert torch.equal(draws[0].z_jitter, draws[1].z_jitter)
  assert torch.equal(draws[0].modality_keep, draws[1].modality_keep)
  keep, z = draws[0].modality_keep, draws[0].z_jitter
  assert keep.shape == (2, 64) and keep.any(0).all() and not keep.all()
  assert z.shape == (64,) and (z >= -2).all() and (z < 2).all()


def test_injected_draws_move_the_column_and_drop_the_aerial_plane():
  """z jitter shifts the query's column floor by exactly the draw; a
  dropped aerial plane leaves the street-view plane alone in the fusion."""
  model = _smoke_model()
  cfg = configs.smoke_train_exhaustive()
  examples = loader.make_train_examples(loader.make_generator(cfg.data, 1),
                                        0, 2, cfg.data)
  batch = loader.pair_batch_to_torch(examples, 'cpu')
  mapper = model.bev_mapper
  jitter = torch.tensor([0.75, -1.5])
  base = mapper.build_xyz_query(batch['query'])
  moved = mapper.build_xyz_query(batch['query'], jitter)
  torch.testing.assert_close(moved[..., 2] - base[..., 2],
                             jitter[:, None, None, None].expand_as(
                                 base[..., 2]), atol=1e-5, rtol=0)
  keep = torch.tensor([[True, True], [False, True]])  # [modality, example]
  draws = bev_mapper.TrainDraws(z_jitter=jitter, modality_keep=keep)
  with torch.no_grad():
    pred = mapper(batch['map'], train=True, draws=draws)
  street = pred['streetview']['feature_plane']
  fused = pred['bev_features']
  torch.testing.assert_close(fused.features[0],
                             torch.where(street.valid[0, ..., None],
                                         street.features[0], 0))
  assert torch.equal(fused.valid[0], street.valid[0])
  assert fused.valid[1].all()  # the aerial plane is kept for example 1


def test_train_step_with_injected_draws_equals_generator_draws():
  cfg = configs.smoke_train_exhaustive()
  examples = loader.make_train_examples(loader.make_generator(cfg.data, 2),
                                        0, 2, cfg.data)
  batch = loader.pair_batch_to_torch(examples, 'cpu')
  logs, draws = [], None
  for inject in (False, True):
    model = _smoke_model(seed=4)
    adam = optimizers.Adam(cfg.train)
    state = trainer.create_train_state(model, adam, seed=9)
    out = trainer.train_step(state, batch, adam,
                             draws=draws if inject else None)
    draws = out.draws
    logs.append(out.logs)
  assert logs[0] == logs[1]


def test_train_cli_on_cpu(capsys, tmp_path):
  train.main(['--config=smoke_train_exhaustive', '--num_steps=3',
              '--device=cpu', f'--workdir={tmp_path}'])
  lines = [json.loads(l) for l in capsys.readouterr().out.splitlines()]
  steps = [l for l in lines if 'step' in l]
  assert [s['step'] for s in steps] == [0, 1, 2]
  for s in steps:
    assert math.isfinite(s['loss/total']) and s['is_finite'] == 1.0
    assert math.isfinite(s['l2_grads']) and s['l2_grads'] > 0
  assert lines[-1]['config'] == 'smoke_train_exhaustive'
  state = torch.load(tmp_path / 'checkpoints' / '3' / 'params.pt',
                     weights_only=True)
  assert 'temperature' in state
