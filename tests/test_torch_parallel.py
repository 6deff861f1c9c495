"""The mesh's data axis over processes (ROADMAP A12, its data-parallel
part): two gloo ranks on the CPU against one process and the JAX package.

- The loader: each rank's blocks of a global batch, stacked in rank order,
  are the one-process batch bit for bit, on the numpy path and the device
  generator's path run on the CPU.
- A step: two ranks (``tests/torch_parallel_ranks.py``, each a spawned
  process with ``torchrun``'s environment) on the tiny localizer at a
  global batch of 4 whose ``batch_mask`` keeps 2 rows of rank 0 and 1 of
  rank 1, against the one-process step on the global batch and both
  against JAX's ``trainer.train_step`` under a ``{data: -1}`` mesh of two
  CPU devices, the same converted weights and JAX's draws injected.
- A run in two chunks on two ranks (checkpoint written by rank 0, resumed
  by both) against the same in one process; an evaluation of 11 examples
  at batch 8 on two ranks, whose dump (rank 0's) equals the one-process
  dump and JAX's evaluation of the same weights (the case of
  ``tests/test_viz_and_eval.py:161``); ``make_mesh``'s rules.

Each rank's process must end within ``torch_parallel_ranks.TIMEOUT_S``.
"""

import dataclasses
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_a14
import torch_heads
import torch_parallel_ranks as ranks
from snap_tpu import evaluator as jevaluator
from snap_tpu.models import bev_localizer as jbev_localizer
from snap_tpu.parallel import mesh as jmesh
from snap_tpu.train_lib import lr_schedules as jlr_schedules
from snap_tpu.train_lib import optimizers as joptimizers
from snap_tpu.train_lib import trainer as jtrainer
from snap_tpu_torch import configs
from snap_tpu_torch import convert
from snap_tpu_torch import evaluator
from snap_tpu_torch.data import loader
from snap_tpu_torch.models import bev_mapper
from snap_tpu_torch.parallel import mesh

torch.set_num_threads(2)

# Two ranks against one process: the same f32 arithmetic but for the
# order of two sums (each rank's masked sum over the global count, then
# the gradients' sum over the ranks): the loss to 1e-6 relative, each
# gradient leaf to 1e-5 of its largest entry. Against JAX:
# tests/torch_heads.py's tolerances (the loss to 1e-5, each gradient leaf
# to 1e-4 of its largest entry plus 1e-7). The parameters after the update:
# Adam's first step moves an entry by lr g / (|g| + 1e-8), g the gradient
# clipped to a global norm of 1, so where |g| is at least TINY_GRAD the
# step's relative error is under 1e-2 of the gradient's and the entry is
# held to PARAM_ATOL (1e-3 of the lr of 1e-3);
# where it is smaller, rounding near 0 may move the step by up to the lr
# itself, and the entry is held to 2 lr from the one it is compared with.
RANKS_LOSS_RTOL, RANKS_RTOL_OF_MAX = 1e-6, 1e-5
TINY_GRAD, PARAM_ATOL, LR = 1e-6, 1e-6, 1e-3
MASK = [1.0, 1.0, 1.0, 0.0]  # rank 0 keeps 2 rows, rank 1 one


def _assert_params_close(got, want, grads, l2_grads, key):
  """``got`` against ``want`` after one Adam step from equal weights
  (``grads``: the reference side's gradient of the entry, before the clip
  at the global norm of 1; ``l2_grads`` that norm)."""
  got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
  big = np.abs(np.asarray(grads)) / max(l2_grads, 1.0) >= TINY_GRAD
  np.testing.assert_allclose(got[big], want[big], atol=PARAM_ATOL, rtol=0,
                             err_msg=key)
  np.testing.assert_allclose(got[~big], want[~big], atol=2 * LR, rtol=0,
                             err_msg=key)


def _rel_of_max(got, want) -> float:
  got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
  scale = np.abs(want).max()
  return float(np.abs(got - want).max() / scale) if scale else float(
      np.abs(got).max())


def test_make_mesh_rules():
  assert mesh.make_mesh(None, 4) == {'data': 4, 'model': 1}
  assert mesh.make_mesh({'data': -1, 'model': 1}, 2) == {'data': 2,
                                                         'model': 1}
  assert mesh.make_mesh({'data': 3}, 3) == {'data': 3, 'model': 1}
  with pytest.raises(ValueError, match='does not match 4 devices'):
    mesh.make_mesh({'data': 3}, 4)
  # The model axis (tensor parallelism): -1 takes what the other leaves.
  assert mesh.make_mesh({'data': 1, 'model': 2}, 2) == {'data': 1,
                                                        'model': 2}
  assert mesh.make_mesh({'data': -1, 'model': 2}, 4) == {'data': 2,
                                                         'model': 2}
  # Rank r at (r // model, r % model), the reference's row-major reshape.
  assert [mesh.place(r, 2) for r in range(4)] == [(0, 0), (0, 1), (1, 0),
                                                  (1, 1)]
  with pytest.raises(ValueError, match='does not match 4 devices'):
    mesh.make_mesh({'data': 3, 'model': 2}, 4)
  with pytest.raises(ValueError, match='mesh has'):
    mesh.make_mesh({'pipeline': 2}, 2)
  assert mesh.block(8, 2, 1) == slice(4, 8)
  with pytest.raises(ValueError, match='must divide evenly over 3'):
    mesh.block(8, 3, 0)
  # Without torchrun's environment: one rank, no process group, the mesh
  # {data: 1, model: 1} with this rank at (0, 0).
  assert mesh.world_size() == 1 and mesh.rank() == 0 and mesh.is_lead()
  assert (mesh.data_size(), mesh.model_size(), mesh.data_index(),
          mesh.model_index()) == (1, 1, 0, 0)
  assert mesh.all_reduce_sum([torch.ones(2)])[0].tolist() == [1.0, 1.0]
  assert mesh.model_sum(torch.ones(2)).tolist() == [1.0, 1.0]


def test_from_reference_reads_the_mesh():
  d = configs.to_reference(configs.smoke_train_exhaustive())
  assert d['mesh'] == {'data': -1, 'model': 1}
  d['mesh'] = {'data': 2}
  assert configs.from_reference(d).mesh == configs.MeshConfig(data=2)
  d['mesh'], d['tp_min_dim'] = {'data': 1, 'model': 2}, 16
  config = configs.from_reference(d)
  assert config.mesh == configs.MeshConfig(data=1, model=2)
  assert config.tp_min_dim == 16
  assert configs.to_reference(config)['tp_min_dim'] == 16
  del d['tp_min_dim']  # the reference's default
  assert configs.from_reference(d).tp_min_dim == mesh.TP_MIN_DIM == 256
  d['mesh'] = {'data': 1, 'model': 0}
  with pytest.raises(ValueError, match='mesh.model'):
    configs.from_reference(d)


def _leaves(tree, prefix=''):
  if isinstance(tree, torch.Tensor):
    return {prefix: tree}
  if isinstance(tree, dict):
    out = {}
    for k, v in tree.items():
      out.update(_leaves(v, f'{prefix}/{k}'))
    return out
  if dataclasses.is_dataclass(tree):
    return _leaves({f.name: getattr(tree, f.name)
                    for f in dataclasses.fields(tree)}, prefix)
  return {prefix: np.asarray(tree)}


def _assert_blocks_are_the_batch(blocks, whole):
  """The blocks' leaves concatenated in rank order equal the batch's."""
  parts = [_leaves(b) for b in blocks]
  want = _leaves(whole)
  assert set(want) == set(parts[0])
  for key, value in want.items():
    got = [p[key] for p in parts]
    if isinstance(value, torch.Tensor):
      assert torch.equal(torch.cat(got), value), key
    else:
      np.testing.assert_array_equal(np.concatenate(got), value, key)


@pytest.mark.parametrize('on_device', [False, True])
def test_each_ranks_block_is_its_rows_of_the_global_batch(on_device):
  """Process i of 2 builds rows [2i, 2i + 2) of each global batch of 4 (the
  eval split's last batch padded and masked), on the numpy path and the
  device generator's path on the CPU, with the one-process strings."""
  data = dataclasses.replace(configs.smoke_train_exhaustive().data,
                             evaluation_size=7,
                             on_device_generation=on_device)
  batches = []
  for index in (None, 0, 1):
    kwargs = ({} if index is None
              else dict(num_processes=2, process_index=index))
    with loader.get_dataset(data, 4, device='cpu', start_step=3,
                            **kwargs) as dataset:
      batches.append([next(dataset.train_iter), next(dataset.valid_iter),
                      next(dataset.valid_iter)])
  whole, *blocks = batches
  for i, batch in enumerate(whole):
    _assert_blocks_are_the_batch([b[i] for b in blocks], batch)
  assert blocks[1][2]['batch_mask'].tolist() == [1.0, 0.0]  # row 7 pads
  with pytest.raises(ValueError, match='must divide evenly over 3'):
    loader.get_dataset(data, 4, device='cpu', num_processes=3,
                       process_index=0)


def test_two_ranks_read_their_blocks_through_the_process_group(tmp_path):
  """The same through ``torchrun``'s environment: the loader takes each
  rank's block from the process group (gloo)."""
  data = dataclasses.replace(configs.smoke_train_exhaustive().data,
                             evaluation_size=3)
  ranks.run_ranks(ranks.blocks_rank, 2, str(tmp_path), data, 4, 2)
  with loader.get_dataset(data, 4, eval_batch_size=2,
                          device='cpu') as dataset:
    whole = [next(dataset.train_iter), next(dataset.valid_iter),
             next(dataset.valid_iter)]
  got = [torch.load(tmp_path / f'rank{r}.pt', weights_only=False)
         for r in range(2)]
  for i, batch in enumerate(whole):
    _assert_blocks_are_the_batch([g[i] for g in got], batch)


def _record(monkeypatch):
  """JAX's Bernoulli and uniform draws and ``optax.global_norm``'s trees
  (the gradients first), recorded inside the traced step."""
  import contextlib  # pylint: disable=g-import-not-at-top
  stack = contextlib.ExitStack()
  lists = [stack.enter_context(torch_heads.recorded(
      monkeypatch, module, name, keep)) for module, name, keep in (
          (jax.random, 'bernoulli', lambda args, out: out),
          (jax.random, 'uniform', lambda args, out: out),
          (optax, 'global_norm', lambda args, out: args[0]))]
  return stack, lists


@pytest.fixture(scope='module')
def step_case(tmp_path_factory):
  """JAX's ``trainer.train_step`` on the tiny localizer under a ``{data:
  -1}`` mesh of two CPU devices at a global batch of 4 (``MASK``), its
  draws recorded; the port's step in one process and on two ranks from
  the same weights with those draws injected."""
  config = torch_a14.port_config()
  config = dataclasses.replace(config, batch_size=4)
  jcfg = torch_a14.jax_config()
  jbatch, batch = torch_a14.pair_batches(config, batch_mask=MASK)
  jmodel = torch_a14.jax_model(config, jcfg)
  rngs = {'params': jax.random.PRNGKey(0), 'sampling': jax.random.PRNGKey(1)}
  params = jax.jit(lambda b: jmodel.flax_model.init(rngs, b, train=False))(
      jbatch)['params']
  lr_fn = jlr_schedules.get_learning_rate_fn(jcfg)
  tx = joptimizers.get_optimizer(jcfg, lr_fn, params=params)
  jstate = jtrainer.TrainState(
      global_step=jnp.zeros((), jnp.int32), params=params,
      opt_state=tx.init(params), model_state={}, rng=jax.random.PRNGKey(0),
      tx=tx)
  device_mesh = jmesh.make_mesh({'data': -1, 'model': 1},
                                devices=jax.devices()[:2])
  jbatch = jmesh.shard_batch(jbatch, device_mesh)
  jstate = jax.device_put(jstate, jmesh.replicated(device_mesh))
  with pytest.MonkeyPatch.context() as mp:
    stack, lists = _record(mp)
    with stack:

      def traced(s, b):
        for recorded in lists:
          del recorded[:]
        out = jtrainer.train_step(
            s, b, flax_model=jmodel.flax_model,
            loss_metrics_fn=jmodel.loss_metrics_function, lr_fn=lr_fn,
            has_model_state=False)
        return out, [list(recorded) for recorded in lists]
      (jstate, jmetrics, jlogs), (taken, drawn, norms) = jax.jit(traced)(
          jstate, jbatch)
  draws = bev_mapper.TrainDraws(
      z_jitter=torch.as_tensor(np.array(drawn[0])),
      modality_keep=torch_heads.modality_keep(np.asarray(taken[0])))
  want = dict(
      loss=float(jmetrics['loss/total'][0]) / float(jmetrics['loss/total'][1]),
      grads=convert.flatten_params(jax.tree_util.tree_map(np.asarray,
                                                          norms[0])),
      params=convert.flatten_params(jax.tree_util.tree_map(
          np.asarray, jstate.params)),
      l2_grads=float(jlogs['l2_grads']))
  state_dict = torch_heads.port_model(
      config, jax.tree_util.tree_map(np.asarray, params)).state_dict()
  one = ranks.steps(config, state_dict, [batch], [draws])
  out = tmp_path_factory.mktemp('step')
  ranks.run_ranks(ranks.step_rank, 2, str(out), config, state_dict, [batch],
                  [draws], 1)
  two = [torch.load(out / f'rank{r}.pt', weights_only=False)
         for r in range(2)]
  model = torch_heads.port_model(config, jax.tree_util.tree_map(np.asarray,
                                                                params))
  return want, one, two, model


def test_two_ranks_take_the_one_process_step(step_case):
  """Equal (sum, count) of the loss on both ranks, the global count 3; the
  gradients and updated parameters equal on both ranks bit for bit and
  the one-process ones to ``RANKS_RTOL_OF_MAX``."""
  _, (one, one_params), two, _ = step_case
  (a, a_params), (b, b_params) = two
  assert a[0]['loss'] == b[0]['loss'] and a[0]['loss'][1] == 3.0
  assert one[0]['loss'][1] == 3.0
  assert a[0]['loss'][0] == pytest.approx(one[0]['loss'][0],
                                          rel=RANKS_LOSS_RTOL)
  assert a[0]['logs'] == b[0]['logs']
  assert a[0]['logs']['l2_grads'] == pytest.approx(
      one[0]['logs']['l2_grads'], rel=RANKS_RTOL_OF_MAX)
  for name, grad in one[0]['grads'].items():
    assert torch.equal(a[0]['grads'][name], b[0]['grads'][name]), name
    assert _rel_of_max(a[0]['grads'][name], grad) <= RANKS_RTOL_OF_MAX, name
  moved = 0
  for name, p in one_params.items():
    assert torch.equal(a_params[name], b_params[name]), name
    _assert_params_close(a_params[name], p, one[0]['grads'][name],
                         one[0]['logs']['l2_grads'], name)
    moved += int(not torch.equal(p, step_case[3].state_dict()[name]))
  assert moved > 0


@pytest.mark.parametrize('side', ['one process', 'two ranks'])
def test_the_step_is_the_jax_trainers_under_a_data_mesh(step_case, side):
  """The loss, every gradient leaf (flax layout) and every parameter after
  the update against JAX's ``trainer.train_step`` on the global batch."""
  want, (one, one_params), two, model = step_case
  got, params = (one, one_params) if side == 'one process' else two[0]
  loss = got[0]['loss'][0] / got[0]['loss'][1]
  torch_heads.assert_losses_match(loss, {}, want['loss'], {})
  torch_heads.assert_grads_match(got[0]['grads'], model, want['grads'])
  assert got[0]['logs']['l2_grads'] == pytest.approx(want['l2_grads'],
                                                     rel=1e-4)
  flat = convert.flax_from_torch(params, model)
  assert set(flat) == set(want['params'])
  for key, value in want['params'].items():
    _assert_params_close(flat[key], value, want['grads'][key],
                         want['l2_grads'], key)


def test_two_ranks_train_in_chunks_as_one_process(tmp_path):
  """``train.train`` to step 2 and then, resumed from rank 0's checkpoint,
  to step 4, on two ranks and in one process: the same chunks
  (checkpoints, the folded data seed), the same summaries and parameters
  (to ``RANKS_RTOL_OF_MAX``), equal on both ranks bit for bit; rank 0
  alone wrote the checkpoints and ``config.json``."""
  config = dataclasses.replace(configs.smoke_train_exhaustive(batch_size=4),
                               train=dataclasses.replace(
                                   configs.smoke_train_exhaustive().train,
                                   checkpoint_steps=2, log_summary_steps=2,
                                   log_eval_steps=100, xprof=False))
  ranks.run_ranks(ranks.train_rank, 2, str(tmp_path), config,
                  str(tmp_path / 'two'), (2, 4), timeout=90)
  (tmp_path / 'one_out').mkdir()
  ranks.train_rank(0, str(tmp_path / 'one_out'), config,
                   str(tmp_path / 'one'), (2, 4))
  one_chunks, one_params = torch.load(tmp_path / 'one_out' / 'rank0.pt',
                                      weights_only=False)
  (a_chunks, a_params), (b_chunks, b_params) = [
      torch.load(tmp_path / f'rank{r}.pt', weights_only=False)
      for r in range(2)]
  assert [c['start'] for c in a_chunks] == [0, 2]
  for x, y in zip(a_chunks, one_chunks):
    assert x['checkpoints'] == y['checkpoints']
    assert x['shuffle_seed'] == y['shuffle_seed']
    for key in ('loss/total', 'l2_grads'):
      # Later steps start from parameters up to a few lr apart (above):
      # their loss and norm are held to 1e-3.
      assert x['summary'][key] == pytest.approx(y['summary'][key], rel=1e-3)
  for chunk in (*a_chunks, *b_chunks):
    del chunk['summary']['steps_per_sec']  # each rank's own clock
  assert a_chunks == b_chunks
  for name, p in one_params.items():
    assert torch.equal(a_params[name], b_params[name]), name
    np.testing.assert_allclose(a_params[name], p, atol=4 * 2 * LR, rtol=0,
                               err_msg=name)
  steps = sorted(p.name for p in (tmp_path / 'two' / 'checkpoints').iterdir())
  assert steps == ['2', '4']
  assert json.loads((tmp_path / 'two' / 'config.json').read_text())[
      'mesh'] == {'data': -1, 'model': 1}


def test_two_ranks_evaluate_as_one_process_and_jax(tmp_path):
  """``evaluator.run_for_location`` over 11 examples at batch 8 (the last
  batch 3 examples and 5 padded rows: rank 1 has none of its 4) of a JAX
  smoke experiment exported to the port: every rank holds the one-process
  results, the dump is rank 0's and equals the one-process dump, and both
  are JAX's ``evaluator.run`` of the experiment (its mesh over the CPU
  devices) to ``tests/test_torch_eval_run.py``'s tolerances."""
  from snap_tpu.configs import smoke_eval_localization  # pylint: disable=g-import-not-at-top
  from snap_tpu.configs import smoke_localization  # pylint: disable=g-import-not-at-top
  from snap_tpu.train_lib import checkpoints as jcheckpoints  # pylint: disable=g-import-not-at-top
  from snap_tpu.utils import configs as jconfig_utils  # pylint: disable=g-import-not-at-top
  import test_torch_eval_run as eval_run  # pylint: disable=g-import-not-at-top
  from test_torch_recall import export_workdir  # pylint: disable=g-import-not-at-top
  jax_dir = tmp_path / 'jax'
  cfg = smoke_localization.get_config('pose_backend=exhaustive')
  jcheckpoints.save_checkpoint(jax_dir, {
      'params': eval_run._jax_smoke_params(cfg),
      'global_step': np.asarray(eval_run.STEP, np.int32)}, eval_run.STEP)
  jconfig_utils.config_save(jax_dir, cfg)
  jeval = smoke_eval_localization.get_config().unlock()
  jeval.workdir, jeval.batch_size = str(jax_dir), 8
  jeval.data.loader.evaluation_size = 11
  (want, _), = jevaluator.run(jeval).values()

  def port_run(name, world):
    workdir = tmp_path / name
    export_workdir(jax_dir, workdir)
    ec = configs.smoke_eval_localization()
    ec = dataclasses.replace(
        ec, workdir=str(workdir), batch_size=8, data=dataclasses.replace(
            ec.data, loader=dataclasses.replace(
                ec.data.loader, evaluation_size=11,
                on_device_generation=False)))
    location = ec.data.name_pattern.format('smokeville')
    if world == 1:
      held = [evaluator.run_for_location(location, ec, device='cpu')[0]]
    else:
      ranks.run_ranks(ranks.eval_rank, world, str(tmp_path), ec, location,
                      timeout=90)
      held = [torch.load(tmp_path / f'rank{r}.pt', weights_only=False)
              for r in range(world)]
    dump, record = evaluator.read_eval_dump(workdir / 'evaluation' /
                                            location)
    assert record['num_processes'] == world
    return held, dump

  (one,), one_dump = port_run('one', 1)
  two, two_dump = port_run('two', 2)
  assert len(one['pair_id']) == 11
  for results in (one, *two):  # what each holds is what it wrote
    dump = one_dump if results is one else two_dump
    assert set(results) == set(dump)
    for key, value in dump.items():
      np.testing.assert_array_equal(results[key], value, err_msg=key)
  # A rank's batch of 4 against one of 8 rounds some convolutions'
  # sums differently: the two dumps, and JAX's, to the JAX comparison's
  # tolerances; strings and booleans exactly.
  for got in (two_dump, one_dump):
    for key in ('pair_id', 'vehicle_map', 'vehicle_query', 'recall_top1'):
      np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    for key, atol in (('error_max_meter', eval_run.POSE_ATOL),
                      ('error_max_deg', eval_run.DEG_ATOL),
                      ('pose_score_max', eval_run.SCORE_ATOL),
                      ('closest_map_view_meter', eval_run.VIEW_ATOL),
                      ('closest_map_view_deg', 1e-3)):
      np.testing.assert_allclose(got[key], want[key], atol=atol,
                                 err_msg=key)
      np.testing.assert_allclose(got[key], one_dump[key], atol=atol,
                                 err_msg=key)
    np.testing.assert_allclose(got['loss'], want['loss'],
                               rtol=eval_run.LOSS_RTOL)
