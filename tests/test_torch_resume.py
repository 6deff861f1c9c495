"""Checkpoints, resume and the training loop against the JAX package's.

On the CPU at smoke size: a checkpoint's round trip is exact, the last N
stay, a half-written step is ignored; a step from a restored state equals
one from the live state bit for bit; the first batch after a resume is the
JAX loader's at the folded seed and ``start_step``; ``eval_step``'s summary
equals JAX's ``eval_step`` + ``_summarize`` on the same weights and batches;
the loop's summaries and evals (their steps, their finite-only means, NaN
for a window of skipped steps) equal the JAX trainer's on the same
sequences; the CLI trains in two chunks and the evaluator reads the
checkpoint it wrote.
"""

import copy
import dataclasses
import itertools
import json
import logging
import math
import types

import flax.linen as nn
import jax
import jax.numpy as jnp
import ml_collections
import numpy as np
import pytest
import torch

from snap_tpu.configs import defaults
from snap_tpu.configs import smoke_localization
from snap_tpu.data import loader as jloader
from snap_tpu.data import types as jtypes
from snap_tpu.models import bev_localizer as jbev_localizer
from snap_tpu.parallel import mesh as mesh_lib
from snap_tpu.train_lib import trainer as jtrainer
from snap_tpu.utils import grids as jgrids
from snap_tpu_torch import configs
from snap_tpu_torch import convert
from snap_tpu_torch import evaluate
from snap_tpu_torch import train
from snap_tpu_torch.data import loader
from snap_tpu_torch.train_lib import checkpoints
from snap_tpu_torch.train_lib import optimizers
from snap_tpu_torch.train_lib import trainer
from snap_tpu_torch.utils import prng

torch.set_num_threads(2)

# The loss-parity tolerances of tests/test_torch_train.py: f32 on both
# sides, the encoders' and the FFT's summation order.
LOSS_RTOL, METRIC_TOL = 1e-5, 1e-4
# The optimizer's logs (tests/test_torch_freeze.py): the update norm to
# 3e-5 (f32 bias corrections, an ulp of pow apart), the others to 1e-5.
LOG_RTOL = {'l2_updates': 3e-5}


def _smoke(**train_changes):
  cfg = configs.smoke_train_exhaustive()
  return dataclasses.replace(cfg, train=dataclasses.replace(
      cfg.train, **train_changes))


def _batch(cfg, start=0, seed=2):
  examples = loader.make_train_examples(loader.make_generator(cfg.data, seed),
                                        start, 2, cfg.data)
  return loader.pair_batch_to_torch(examples, 'cpu')


def _trained_state(cfg, steps=2):
  model = evaluate.build_localizer(cfg, 'cpu', 0)
  chain = optimizers.get_optimizer(cfg.train, model)
  state = trainer.create_train_state(model, chain, seed=5)
  for i in range(steps):
    trainer.train_step(state, _batch(cfg, start=2 * i), chain)
  return state, chain


def _fresh_state(cfg, seed=0):
  model = evaluate.build_localizer(cfg, 'cpu', seed)
  chain = optimizers.get_optimizer(cfg.train, model)
  return trainer.create_train_state(model, chain, seed=0), chain


def _assert_states_equal(a, b):
  for (name, p), (_, q) in zip(a.model.named_parameters(),
                               b.model.named_parameters()):
    assert torch.equal(p, q), name
  assert a.opt_state.count == b.opt_state.count
  for key in ('mu', 'nu'):
    for x, y in zip(getattr(a.opt_state, key), getattr(b.opt_state, key)):
      assert torch.equal(x, y), key
  assert (a.global_step, a.seed) == (b.global_step, b.seed)


def test_checkpoint_round_trip_is_exact(tmp_path):
  cfg = _smoke()
  state, _ = _trained_state(cfg)
  nbytes = checkpoints.save_checkpoint(tmp_path, state, 2)
  assert nbytes > 3 * 4 * sum(p.numel() for p in state.model.parameters())
  restored, _ = _fresh_state(cfg, seed=3)
  assert checkpoints.restore_checkpoint(tmp_path, restored) == 2
  _assert_states_equal(restored, state)
  params = checkpoints.restore_params(tmp_path, 2)
  assert set(params) == set(state.model.state_dict())


def test_lean_frozen_state_round_trips(tmp_path):
  """Moments only for the trainable parameters, keyed by their names."""
  opt = configs.OptimizerConfig(freeze_params_reg_exp='bev_mapper/',
                                allocate_frozen_state=False)
  cfg = _smoke(optimizer_configs=opt)
  state, _ = _trained_state(cfg, steps=1)
  checkpoints.save_checkpoint(tmp_path, state, 1)
  saved = torch.load(tmp_path / 'checkpoints' / '1' / checkpoints.OPT_STATE,
                     weights_only=True)
  assert set(saved['mu']) == set(saved['nu']) == {'temperature'}
  restored, _ = _fresh_state(cfg)
  checkpoints.restore_checkpoint(tmp_path, restored)
  _assert_states_equal(restored, state)


def test_keeps_the_last_n_and_ignores_partial_steps(tmp_path):
  cfg = _smoke()
  state, _ = _fresh_state(cfg)
  for step in (2, 4, 6, 8):
    state.global_step = step
    checkpoints.save_checkpoint(tmp_path, state, step, max_to_keep=2)
  root = tmp_path / 'checkpoints'
  assert sorted(p.name for p in root.iterdir()) == ['6', '8']
  # A run killed mid-write leaves its temporary, or a step without its
  # meta.json (a copy cut short): neither is a checkpoint.
  (root / '.tmp-10-123').mkdir()
  (root / '.tmp-10-123' / checkpoints.PARAMS).write_bytes(b'partial')
  (root / '12').mkdir()
  (root / '12' / checkpoints.PARAMS).write_bytes(b'partial')
  assert checkpoints.all_steps(tmp_path) == [6, 8]
  assert checkpoints.latest_step(tmp_path) == 8
  restored, _ = _fresh_state(cfg)
  assert checkpoints.restore_checkpoint(tmp_path, restored) == 8
  assert restored.global_step == 8
  with pytest.raises(ValueError, match='No checkpoint 12'):
    checkpoints.restore_checkpoint(tmp_path, restored, 12)


@pytest.fixture
def one_thread():
  """oneDNN's convolution backward splits its reduction over threads in an
  order that changes from call to call (measured at 4 and 8 threads: the
  root conv's weight gradient an ulp apart between two identical calls);
  one thread sums in one order."""
  threads = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(threads)


def test_a_step_from_the_restored_state_equals_the_live_one(tmp_path,
                                                            one_thread):
  cfg = _smoke()
  live, chain = _trained_state(cfg)
  checkpoints.save_checkpoint(tmp_path, live, live.global_step)
  restored, restored_chain = _fresh_state(cfg, seed=7)
  checkpoints.restore_checkpoint(tmp_path, restored)
  batch = _batch(cfg, start=4)
  a = trainer.train_step(live, batch, chain)
  b = trainer.train_step(restored, batch, restored_chain)
  assert a.logs == b.logs
  assert torch.equal(a.draws.z_jitter, b.draws.z_jitter)
  for name in a.grads:
    assert torch.equal(a.grads[name], b.grads[name]), name
  _assert_states_equal(live, restored)


class _Recorded:
  def __init__(self, make_batch, num_batches, sharding=None,
               start_index=0, **kwargs):
    del num_batches, sharding, kwargs
    self.make_batch, self.start_index = make_batch, start_index


def _leaves(tree, prefix=''):
  out = {}
  for key, value in tree.items():
    path = f'{prefix}/{key}'
    if isinstance(value, dict):
      out.update(_leaves(value, path))
    elif isinstance(value, (np.ndarray, torch.Tensor)):
      out[path] = np.asarray(value)
  return out


def test_the_first_batch_after_a_resume_is_the_jax_loaders(monkeypatch):
  """``snap_tpu/train.py`` resuming at step 2: the JAX loader at the folded
  seed and ``start_step=2`` against the port's (``train.py``'s fold), on
  the host path, example for example."""
  ref = smoke_localization.get_config('pose_backend=exhaustive')
  cfg = configs.smoke_train_exhaustive()
  step = 2
  folded = int(jax.random.fold_in(jax.random.PRNGKey(ref.shuffle_seed),
                                  step).sum())
  made = []
  monkeypatch.setattr(jloader, '_PrefetchIterator',
                      lambda *a, **k: made.append(_Recorded(*a, **k)) or
                      made[-1])
  jloader.get_dataset(batch_size=cfg.batch_size, eval_batch_size=None,
                      dataset_configs=ref.data, shuffle_seed=folded,
                      start_step=step)
  train_iter = made[0]
  assert train_iter.start_index == step
  want = train_iter.make_batch(step)
  data = dataclasses.replace(
      cfg.data, on_device_generation=False, shuffle_seed=(
          prng.resume_shuffle_seed(cfg.data.shuffle_seed, step)))
  assert data.shuffle_seed == folded
  with loader.get_dataset(data, cfg.batch_size, device='cpu',
                          start_step=step) as dataset:
    got = next(dataset.train_iter)
  assert dict(got['_host']) .keys() == dict(want['_host']).keys()
  for key, value in want['_host'].items():
    np.testing.assert_array_equal(np.asarray(got['_host'][key]),
                                  np.asarray(value), err_msg=key)
  got_leaves, want_leaves = _leaves(got), _leaves(want)
  common = sorted(set(got_leaves) & set(want_leaves))
  assert len(common) >= 10, common
  assert '/map/images' in common and '/query/images' in common
  for path in common:
    np.testing.assert_array_equal(got_leaves[path], want_leaves[path],
                                  err_msg=path)


@pytest.fixture(scope='module')
def jax_smoke():
  """Flax weights of ``smoke_localization.py:exhaustive`` and the same in
  the port, with two eval batches (the second with a padded row)."""
  jcfg = smoke_localization.get_config('pose_backend=exhaustive')
  grid = jgrids.Grid3D.from_extent_meters((24, 32, 12), 1.0)
  meta = {'build_config': types.SimpleNamespace(
              scene_config=jtypes.SceneConfig(num_views=3)),
          'grid': grid, 'semantic_map_classes': None}
  jmodel = jbev_localizer.BEVLocalizerModel(jcfg.model, meta, jnp.float32)
  cfg = configs.smoke_train_exhaustive()
  batches = []
  for start, mask in ((0, [1.0, 1.0]), (2, [1.0, 0.0])):
    examples = loader.make_train_examples(loader.make_generator(cfg.data, 4),
                                          start, 2, cfg.data)
    examples['batch_mask'] = np.asarray(mask, np.float32)
    batches.append(examples)
  jbatches = []
  for examples in batches:
    jbatch = jloader.process_batch(copy.deepcopy(examples),
                                   jtypes.DataMode.PAIR_SCENE_VIEW)
    jbatch.pop('_host')
    jbatches.append(jbatch)
  rngs = {'params': jax.random.PRNGKey(0), 'sampling': jax.random.PRNGKey(1)}
  params = jax.jit(lambda b: jmodel.flax_model.init(rngs, b, train=False))(
      jbatches[0])['params']
  model = evaluate.build_localizer(cfg, 'cpu')
  model.load_state_dict(convert.params_from_flax(
      jax.tree_util.tree_map(np.asarray, params), model))
  return dict(jmodel=jmodel, params=params, jbatches=jbatches, model=model,
              batches=[loader.pair_batch_to_torch(b, 'cpu') for b in batches])


def test_eval_step_summary_equals_jax(jax_smoke):
  jstate = jtrainer.TrainState(
      global_step=jnp.zeros((), jnp.int32), params=jax_smoke['params'],
      opt_state=None, model_state={}, rng=jax.random.PRNGKey(0), tx=None)
  jmodel = jax_smoke['jmodel']
  step = jax.jit(lambda s, b, r: jtrainer.eval_step(
      s, b, r, flax_model=jmodel.flax_model,
      loss_metrics_fn=jmodel.loss_metrics_function))
  want = jtrainer._summarize([
      jax.device_get(step(jstate, b, jax.random.fold_in(
          jax.random.PRNGKey(3), i)))
      for i, b in enumerate(jax_smoke['jbatches'])])
  got = trainer.summarize([
      trainer.eval_step(jax_smoke['model'], b, trainer.eval_generator(0, i))
      for i, b in enumerate(jax_smoke['batches'])])
  assert set(got) == set(want)
  assert any(k.startswith('loss/') for k in got)
  for key, value in want.items():
    if key.startswith('loss/'):
      assert got[key] == pytest.approx(value, rel=LOSS_RTOL), key
    else:
      assert got[key] == pytest.approx(value, rel=METRIC_TOL,
                                       abs=METRIC_TOL), key


# The loop against the JAX trainer's, on a model whose parameters are its
# prediction (tests/test_torch_train.py's harness): gradients are given by
# the batch, a NaN among them skips a step.
_SHAPES = {'w': (3, 4), 'b': (4,)}
_ROWS = 8  # the JAX trainer shards the batch over 8 CPU devices


class _JaxLeaves(nn.Module):

  @nn.compact
  def __call__(self, batch, train=False):
    del train
    return {k: self.param(k, nn.initializers.zeros, s)
            for k, s in _SHAPES.items()}


def _jax_loss(pred, batch, params=None):
  del params
  total = sum((pred[k] * batch[f'g_{k}'][0]).sum() for k in _SHAPES)
  return ({'total': jnp.broadcast_to(total, batch['batch_mask'].shape)},
          {'m': batch['m']})


class _TorchLeaves(torch.nn.Module):

  def __init__(self, init):
    super().__init__()
    for k in _SHAPES:
      self.register_parameter(k, torch.nn.Parameter(torch.tensor(init[k])))

  def forward(self, batch, train=False, generator=None, draws=None,
              pose_samples=None):
    del train, generator, draws, pose_samples
    return {'w': self.w, 'b': self.b, 'draws': None}

  def loss_metrics_function(self, pred, batch):
    total = sum((pred[k] * batch[f'g_{k}'][0]).sum() for k in _SHAPES)
    return ({'total': total.expand(batch['batch_mask'].shape)},
            {'m': batch['m']})


class _Iter:
  last_build = None

  def __init__(self, items):
    self._items = iter(items)

  def __iter__(self):
    return self

  def __next__(self):
    return dict(next(self._items))


def _loop_batches(num_steps, skipped):
  rng = np.random.default_rng(0)
  out = []
  for step in range(1, num_steps + 1):
    scale = 3.0 if step % 3 == 0 else 0.2
    b = {f'g_{k}': np.broadcast_to(rng.normal(size=s) * scale,
                                   (_ROWS, *s)).astype(np.float32)
         for k, s in _SHAPES.items()}
    if step in skipped:
      b['g_w'] = b['g_w'].copy()
      b['g_w'][:, 0, 0] = np.nan
    m = rng.normal(size=_ROWS).astype(np.float32)
    m[step % _ROWS] = np.nan  # a non-finite metric entry is masked
    b['m'] = m
    b['batch_mask'] = np.ones(_ROWS, np.float32)
    out.append(b)
  return out


class _Writer:
  def __init__(self):
    self.scalars = {}

  def write_scalars(self, step, scalars):
    self.scalars.setdefault(step, {}).update(scalars)


def test_the_loops_summaries_and_evals_equal_the_jax_trainers(tmp_path):
  """Steps 1-9, a summary every 2 steps and at the stop step, an eval every
  4; steps 3 and 4 (a whole window) and 7 skip on a NaN gradient. Every
  summary and eval, at the same steps, equals the JAX trainer's: the logs'
  means over finite steps, NaN for the window of skipped steps, the
  metrics' masked means."""
  num_steps, skipped = 9, (3, 4, 7)
  lr = configs.LrConfig(factors='constant * linear_warmup',
                        base_learning_rate=1e-2, warmup_steps=3)
  tc = configs.TrainConfig(lr_configs=lr, max_grad_norm=1.0,
                           num_training_steps=num_steps, checkpoint=False,
                           log_summary_steps=2, log_eval_steps=4,
                           steps_per_eval=2, xprof=False)
  ref = defaults.base()
  ref.lr_configs.update(dataclasses.asdict(lr))
  ref.max_grad_norm = 1.0
  ref.num_training_steps = num_steps
  ref.dtype_str = 'float32'
  ref.checkpoint = False
  ref.log_summary_steps, ref.log_eval_steps, ref.steps_per_eval = 2, 4, 2
  ref.xprof = False
  ref.batch_size = _ROWS
  ref.model = ml_collections.ConfigDict()
  batches = _loop_batches(num_steps, skipped)
  evals = _loop_batches(2, ())
  writer = _Writer()
  dataset = types.SimpleNamespace(
      train_iter=iter([{k: jnp.asarray(v) for k, v in b.items()}
                       for b in batches]),
      valid_iter=itertools.cycle([{k: jnp.asarray(v) for k, v in b.items()}
                                  for b in evals]),
      meta_data={'get_dummy_batch_fn': lambda: dict(batches[0]),
                 'num_eval_examples': 2 * _ROWS})
  model_cls = lambda *_: types.SimpleNamespace(
      flax_model=_JaxLeaves(), loss_metrics_function=_jax_loss)
  (tmp_path / 'jax').mkdir()
  _, jsummary, jeval = jtrainer.train(
      rng=jax.random.PRNGKey(0), config=ref, model_cls=model_cls,
      dataset=dataset, workdir=str(tmp_path / 'jax'), writer=writer,
      mesh=mesh_lib.make_mesh({'data': -1, 'model': 1}))
  init = {k: np.zeros(s, np.float32) for k, s in _SHAPES.items()}
  to_torch = lambda b: {k: torch.from_numpy(np.array(v)) for k, v in b.items()}
  tdataset = types.SimpleNamespace(
      train_iter=_Iter([to_torch(b) for b in batches]),
      valid_iter=itertools.cycle([to_torch(b) for b in evals]),
      meta_data={'num_eval_examples': 2 * _ROWS})
  cfg = dataclasses.replace(configs.smoke_train_exhaustive(), train=tc,
                            batch_size=_ROWS)
  result = trainer.train(cfg, _TorchLeaves(init), tdataset, tmp_path / 'port')
  want_train = {s: {k[len('train/'):]: v for k, v in d.items()
                    if k.startswith('train/')} for s, d in writer.scalars.items()}
  want_train = {s: d for s, d in want_train.items() if d}
  want_eval = {s: {k[len('eval/'):]: v for k, v in d.items()
                   if k.startswith('eval/')} for s, d in writer.scalars.items()}
  want_eval = {s: d for s, d in want_eval.items() if d}
  assert sorted(result['summaries']) == sorted(want_train) == [2, 4, 6, 8, 9]
  assert sorted(result['evals']) == sorted(want_eval) == [4, 8, 9]
  assert math.isnan(result['summaries'][4]['l2_grads'])  # all skipped
  assert math.isnan(result['summaries'][4]['learning_rate'])
  # Step 7's NaN norms do not count in its window.
  assert math.isfinite(result['summaries'][8]['l2_grads'])
  for got_all, want_all in ((result['summaries'], want_train),
                            (result['evals'], want_eval)):
    for step, want in want_all.items():
      got = got_all[step]
      assert set(got) == set(want), step
      for key, value in want.items():
        if key == 'steps_per_sec':
          assert got[key] > 0
        elif math.isnan(value):
          assert math.isnan(got[key]), (step, key)
        else:
          assert got[key] == pytest.approx(
              value, rel=LOG_RTOL.get(key, 1e-5), abs=1e-7), (step, key)
  assert result['train_summary'] == result['summaries'][9]
  assert json.loads((tmp_path / 'port' / 'progress.json').read_text())[
      'step'] == 9
  assert set(jsummary) == set(result['train_summary'])
  assert set(jeval) == set(result['eval_summary'])


def test_cli_trains_in_chunks_and_the_evaluator_reads_it(tmp_path, capsys,
                                                        caplog):
  """Stop at 2, resume to 4 (the fold logged), evaluate step 4."""
  workdir = tmp_path / 'run'
  common = ['--config=smoke_train_exhaustive', '--device=cpu',
            f'--workdir={workdir}']
  with caplog.at_level(logging.INFO):
    train.main(common + ['--stop_at_step=2'])
    first = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert 'Folding' not in caplog.text
    train.main(common + ['--stop_at_step=4'])
    lines = [json.loads(l) for l in capsys.readouterr().out.splitlines()]
  assert (first['start_step'], first['stop_step']) == (0, 2)
  assert list(first['checkpoints']) == ['2']
  assert 'Folding global_step 2 into dataset seed.' in caplog.text
  assert [l['step'] for l in lines[:-1]] == [2, 3]
  second = lines[-1]
  assert (second['start_step'], second['stop_step']) == (2, 4)
  assert second['shuffle_seed'] == prng.resume_shuffle_seed(
      configs.SHUFFLE_SEED, 2)
  assert second['restore_seconds'] is not None
  assert list(second['checkpoints']) == ['4']
  assert checkpoints.all_steps(workdir) == [2, 4]
  assert math.isfinite(second['train_summary']['loss/total'])
  assert math.isfinite(second['eval_summary']['loss/total'])
  record = json.loads((workdir / 'config.json').read_text())
  assert record['data_generator_kind'] == 'host-numpy'
  assert configs.from_reference(record) == configs.smoke_train_exhaustive()
  evaluate.main(['--eval_config=smoke_eval_localization',
                 f'--workdir={workdir}', '--device=cpu'])
  summary = json.loads(capsys.readouterr().out.splitlines()[-1])
  assert summary['eval_checkpoint_step'] == 4
  dump = json.loads((workdir / 'evaluation' / 'smokeville-synthetic_eval' /
                     'config.json').read_text())
  assert dump['eval_checkpoint_step'] == 4
  evaluate.main(['--eval_config=smoke_eval_localization',
                 f'--workdir={workdir}', '--device=cpu',
                 '--checkpoint_step=2', '--tag=_s2'])
  assert json.loads(capsys.readouterr().out.splitlines()[-1])[
      'eval_checkpoint_step'] == 2
