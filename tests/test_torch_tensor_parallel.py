"""The mesh's model axis (ROADMAP A12, its tensor-parallel part): ranks on
the CPU (gloo, ``tests/torch_parallel_ranks.py``) against one process and
the JAX package.

- The rule: the leaves ``parallel/mesh.py:infer_param_shardings`` shards
  are, by flax path, those JAX's ``infer_param_shardings`` does not
  replicate, on the tiny localizer at ``min_dim`` 16 over model axes of 2
  and 3 (GroupNorm leaves included; a last dim not divisible by 3 stays
  whole), and 225 leaves, 45,115,648 parameters of the flagship at 256
  over 2.
- A step on the tiny localizer (f32, ``min_dim`` 16) at ``{data: 1,
  model: 2}`` (2 ranks) and ``{data: 2, model: 2}`` (4 ranks), global batch
  4 with ``test_torch_parallel.MASK``: the loss, every gradient leaf
  reassembled from its slices and the updated parameters against the
  one-process step, and against JAX's ``trainer.train_step`` under a
  ``{data: 2, model: 2}`` mesh of 4 CPU devices (its parameters placed by
  its rule, its draws injected); every replicated leaf equal bit for bit
  across each model group. Without the sum of a sharded layer's input
  gradient over the model group the loss still matches and the gradients
  of the layers before the sharded ones do not: the step's check catches
  it.
- A run in two chunks that switches layouts at the checkpoint, both ways
  between ``{data: 1, model: 2}`` and one process: the checkpoint restored
  in the new layout and gathered back is the one written, bit for bit, and
  the end is the one-process run's.
- fp16: a gradient made infinite on one rank's slice skips the step on
  both ranks, and the loss scale backs off on both.
- A warm start loads each rank's slice of the full pretrained leaves; a
  semantic-head step on a frozen mapper: the frozen sharded leaves keep
  their bits, the head's move as in one process.

Each rank's process must end within ``torch_parallel_ranks.TIMEOUT_S``.
"""

import dataclasses
import shutil

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_parallel as tpar
import torch_a14
import torch_heads
import torch_parallel_ranks as ranks
from snap_tpu.parallel import mesh as jmesh
from snap_tpu.train_lib import lr_schedules as jlr_schedules
from snap_tpu.train_lib import optimizers as joptimizers
from snap_tpu.train_lib import trainer as jtrainer
from snap_tpu_torch import configs
from snap_tpu_torch import convert
from snap_tpu_torch import evaluator
from snap_tpu_torch.models import bev_mapper
from snap_tpu_torch.models import resnet
from snap_tpu_torch.parallel import mesh
from snap_tpu_torch.train_lib import checkpoints

torch.set_num_threads(2)

# tests/test_tp_parity.py's threshold: the tiny model's widths of 32 and 64
# are sharded.
MIN_DIM = 16
LAYOUTS = {'1x2': {'data': 1, 'model': 2}, '2x2': {'data': 2, 'model': 2}}


def _tiny():
  config = dataclasses.replace(torch_a14.port_config(), batch_size=4)
  return config, torch_a14.jax_config()


@pytest.mark.parametrize('model', [2, 3])
def test_the_rule_shards_the_leaves_jax_shards(model):
  """By flax path, over a ``{data, model}`` mesh of CPU devices."""
  config, jcfg = _tiny()
  jbatch, _ = torch_a14.pair_batches(config)
  jmodel = torch_a14.jax_model(config, jcfg)
  rngs = {'params': jax.random.PRNGKey(0), 'sampling': jax.random.PRNGKey(1)}
  shapes = jax.eval_shape(
      lambda b: jmodel.flax_model.init(rngs, b, train=False), jbatch)
  data = {2: 4, 3: 2}[model]
  device_mesh = jmesh.make_mesh({'data': data, 'model': model},
                                devices=jax.devices()[:data * model])
  rule = convert.flatten_params(jmesh.infer_param_shardings(
      shapes['params'], device_mesh, min_dim=MIN_DIM))
  want = {k for k, s in rule.items() if s.spec != jax.sharding.PartitionSpec()}
  port = evaluator.build_model(config, 'cpu')
  modules = dict(port.named_modules())
  dims = mesh.infer_param_shardings(port, MIN_DIM, model)
  got = {convert.flax_leaf(n, tuple(p.shape), modules)[0]
         for n, p in port.named_parameters() if n in dims}
  assert got == want
  norms = [n for n in dims
           if isinstance(modules[n.rpartition('.')[0]], resnet.GroupNorm)]
  # Over 2 the tiny model's widths of 32 and 64 (GroupNorm's included)
  # are sharded; over 3, none divides and every leaf stays whole.
  assert bool(norms) == bool(want) == (model == 2)
  shapes = [convert.flax_leaf(n, tuple(p.shape), modules)[2]
            for n, p in port.named_parameters()]
  wide_odd = [s for s in shapes
              if len(s) >= 2 and s[-1] >= MIN_DIM and s[-1] % model]
  assert bool(wide_odd) == (model == 3)


def test_the_rule_at_full_width():
  """The flagship (``train_full1chip_exhaustive``) at 256 over 2: 225
  leaves (76 conv kernels, a dense kernel, 148 GroupNorm scales and
  biases), 45,115,648 of its 48,106,945 parameters."""
  model = evaluator.build_model(configs.train_full1chip_exhaustive(), 'cpu')
  dims = mesh.infer_param_shardings(model, mesh.TP_MIN_DIM, 2)
  params = dict(model.named_parameters())
  modules = dict(model.named_modules())
  kinds = [type(modules[n.rpartition('.')[0]]).__name__ for n in dims]
  assert len(dims) == 225
  assert sum(params[n].numel() for n in dims) == 45_115_648
  assert sum(p.numel() for p in params.values()) == 48_106_945
  assert (kinds.count('StdConv'), kinds.count('Dense'),
          kinds.count('GroupNorm')) == (76, 1, 148)
  assert all(d == 0 for d in dims.values())


def _jax_step(config, jcfg, jbatch, axes):
  """JAX's ``trainer.train_step`` under ``axes`` (CPU devices), the
  parameters placed by its rule at ``MIN_DIM``: the loss, the gradients
  and parameters (flax paths), ``l2_grads``; the draws, the weights, and
  the side each relu's input fell on in the same loss's gradient under the
  same mesh (the step's sampling key), for the port to replay: JAX's own
  steps under ``{data: 2}`` and ``{data: 2, model: 2}`` put one relu input
  within 6e-6 of 0 on different sides, which moves a gradient leaf by 5e-3
  of its largest entry (ROADMAP C11)."""
  with pytest.MonkeyPatch.context() as mp:
    # Rematerialization recomputes the same values; without it a relu's
    # side can be returned from the traced function.
    mp.setattr(nn, 'remat', lambda module, *args, **kwargs: module)
    jmodel = torch_a14.jax_model(config, jcfg)
    rngs = {'params': jax.random.PRNGKey(0),
            'sampling': jax.random.PRNGKey(1)}
    params = jax.jit(lambda b: jmodel.flax_model.init(rngs, b, train=False))(
        jbatch)['params']
    lr_fn = jlr_schedules.get_learning_rate_fn(jcfg)
    tx = joptimizers.get_optimizer(jcfg, lr_fn, params=params)
    device_mesh = jmesh.make_mesh(
        axes, devices=jax.devices()[:axes['data'] * axes['model']])
    repl = jmesh.replicated(device_mesh)
    placed = jax.device_put(params, jmesh.infer_param_shardings(
        params, device_mesh, min_dim=MIN_DIM))
    jstate = jtrainer.TrainState(
        global_step=jax.device_put(jnp.zeros((), jnp.int32), repl),
        params=placed, opt_state=jax.device_put(tx.init(params), repl),
        model_state={}, rng=jax.device_put(jax.random.PRNGKey(0), repl),
        tx=tx)
    jbatch = jmesh.shard_batch(jbatch, device_mesh)
    stack, lists = tpar._record(mp)
    with stack, jax.set_mesh(device_mesh):

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
    # The step's sampling key (``trainer.py:186-187``) at step 0.
    sampling = jax.random.fold_in(jax.random.split(jax.random.PRNGKey(0))[1],
                                  0)
    with torch_heads.recorded(mp, nn, 'relu',
                              lambda args, out: args[0] > 0) as sides, (
                                  jax.set_mesh(device_mesh)):

      def loss_fn(p, b):
        del sides[:]
        pred = jmodel.flax_model.apply({'params': p}, b, train=True,
                                       rngs={'sampling': sampling})
        losses, _ = jmodel.loss_metrics_function(pred, b, p)
        return losses['total'].mean(where=b['batch_mask'] > 0), list(sides)
      _, relu_sides = jax.jit(jax.grad(loss_fn, has_aux=True))(placed,
                                                                jbatch)
  as_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)
  draws = bev_mapper.TrainDraws(
      z_jitter=torch.as_tensor(np.array(drawn[0])),
      modality_keep=torch_heads.modality_keep(np.asarray(taken[0])))
  want = dict(
      loss=float(jmetrics['loss/total'][0]) / float(jmetrics['loss/total'][1]),
      grads=convert.flatten_params(as_np(norms[0])),
      params=convert.flatten_params(as_np(jstate.params)),
      l2_grads=float(jlogs['l2_grads']))
  return want, draws, as_np(params), [torch.as_tensor(np.array(s))
                                      for s in relu_sides]


def _load(path, world):
  return [torch.load(path / f'rank{r}.pt', weights_only=False)
          for r in range(world)]


def _assemble(got, key):
  """The full leaves of ``key`` ('grads' of the first step, or 'params')
  from the first model group's ranks (data index 0), in model order."""
  group = sorted((g for g in got if g[3][0] == 0), key=lambda g: g[3][1])
  dims = group[0][2]
  parts = [g[0][0]['grads'] if key == 'grads' else g[1] for g in group]
  return {name: torch.cat([p[name] for p in parts], dims[name])
          if name in dims else parts[0][name] for name in parts[0]}


@pytest.fixture(scope='module')
def step_case(tmp_path_factory):
  """JAX's step under ``{data: 2, model: 2}``, its draws and relu sides
  recorded; the port's step, those draws injected and those sides
  replayed, in one process, on 2 ranks at ``{data: 1, model: 2}`` (then
  again there without the input gradient's sum) and on 4 at ``{data: 2,
  model: 2}``."""
  config, jcfg = _tiny()
  jbatch, batch = torch_a14.pair_batches(config, batch_mask=tpar.MASK)
  want, draws, params, sides = _jax_step(config, jcfg, jbatch,
                                         LAYOUTS['2x2'])
  model = torch_heads.port_model(config, params)
  state_dict = model.state_dict()
  one = ranks.steps(config, state_dict, [batch], [draws], relu_sides=sides)
  runs = {}
  for name, axes in LAYOUTS.items():
    out = tmp_path_factory.mktemp('tp_step')
    world = axes['data'] * axes['model']
    ranks.run_ranks(ranks.tp_step_rank, world, str(out), config, state_dict,
                    [batch], [draws], 1, axes, MIN_DIM, sides, name == '1x2')
    runs[name] = _load(out, world)
  runs['1x2 without the input sum'] = [
      (g[4], g[1], g[2], g[3]) for g in runs['1x2']]
  return want, one, runs, model


@pytest.mark.parametrize('layout', sorted(LAYOUTS))
def test_ranks_take_the_one_process_step(step_case, layout):
  """The loss (global count 3) to ``RANKS_LOSS_RTOL``, every gradient leaf
  reassembled from its slices to ``RANKS_RTOL_OF_MAX`` of its largest
  entry, the updated parameters by ``_assert_params_close``; every rank's
  logs equal."""
  _, (one, one_params), runs, model = step_case
  got = runs[layout]
  assert got[0][2], 'nothing sharded'
  first = got[0][0][0]
  assert first['loss'][1] == 3.0
  assert first['loss'][0] == pytest.approx(one[0]['loss'][0],
                                           rel=tpar.RANKS_LOSS_RTOL)
  for g in got[1:]:
    assert g[0][0]['logs'] == first['logs']
  assert first['logs']['l2_grads'] == pytest.approx(
      one[0]['logs']['l2_grads'], rel=tpar.RANKS_RTOL_OF_MAX)
  grads = _assemble(got, 'grads')
  params = _assemble(got, 'params')
  assert set(grads) == set(one[0]['grads'])
  moved = 0
  for name, grad in one[0]['grads'].items():
    assert tpar._rel_of_max(grads[name], grad) <= tpar.RANKS_RTOL_OF_MAX, (
        name)
    tpar._assert_params_close(params[name], one_params[name], grad,
                              one[0]['logs']['l2_grads'], name)
    moved += int(not torch.equal(one_params[name],
                                 model.state_dict()[name]))
  assert moved > 0


@pytest.mark.parametrize('layout', sorted(LAYOUTS))
def test_the_step_is_the_jax_trainers_under_a_model_mesh(step_case, layout):
  """The loss, every gradient leaf (flax layout, reassembled) and every
  parameter after the update against JAX's step under ``{data: 2,
  model: 2}``, to ``test_torch_parallel``'s tolerances."""
  want, _, runs, model = step_case
  got = runs[layout]
  first = got[0][0][0]
  torch_heads.assert_losses_match(first['loss'][0] / first['loss'][1], {},
                                  want['loss'], {})
  torch_heads.assert_grads_match(_assemble(got, 'grads'), model,
                                 want['grads'])
  assert first['logs']['l2_grads'] == pytest.approx(want['l2_grads'],
                                                    rel=1e-4)
  flat = convert.flax_from_torch(_assemble(got, 'params'), model)
  assert set(flat) == set(want['params'])
  for key, value in want['params'].items():
    tpar._assert_params_close(flat[key], value, want['grads'][key],
                              want['l2_grads'], key)


@pytest.mark.parametrize('layout', sorted(LAYOUTS))
def test_replicated_leaves_are_equal_across_each_model_group(step_case,
                                                             layout):
  """After the step, a replicated leaf (and its gradient) has the same
  bits on every rank of a model group, and a sharded one is a slice of
  the size the rule gives."""
  got = step_case[2][layout]
  groups = {}
  for g in got:
    groups.setdefault(g[3][0], []).append(g)
  for group in groups.values():
    dims = group[0][2]
    for name, p in group[0][1].items():
      if name in dims:
        continue
      for other in group[1:]:
        assert torch.equal(other[1][name], p), name
        assert torch.equal(other[0][0]['grads'][name],
                           group[0][0][0]['grads'][name]), name
  full = _assemble(got, 'params')
  for name, dim in got[0][2].items():
    assert got[0][1][name].shape[dim] * 2 == full[name].shape[dim]


def test_a_missing_input_sum_is_caught(step_case):
  """Without the all-reduce of a sharded layer's input gradient over the
  model group the loss is the one-process loss, and the gradients of the
  street-view encoder's trunk, before its sharded layers, are not."""
  _, (one, _), runs, _ = step_case
  got = runs['1x2 without the input sum']
  first = got[0][0][0]
  assert first['loss'][0] == pytest.approx(one[0]['loss'][0],
                                           rel=tpar.RANKS_LOSS_RTOL)
  grads = _assemble(got, 'grads')
  trunk = [n for n in one[0]['grads']
           if 'streetview_encoder' in n and 'root' in n]
  assert trunk
  for name in trunk:
    assert tpar._rel_of_max(grads[name], one[0]['grads'][name]) > (
        tpar.RANKS_RTOL_OF_MAX), name


def _run_config(model: int):
  config = configs.smoke_train_exhaustive(batch_size=4)
  return dataclasses.replace(
      config, mesh=configs.MeshConfig(data=1, model=model),
      tp_min_dim=MIN_DIM, train=dataclasses.replace(
          config.train, checkpoint_steps=2, log_summary_steps=2,
          log_eval_steps=100, steps_per_eval=1, xprof=False))


@pytest.fixture(scope='module')
def one_process_run(tmp_path_factory):
  """Four steps in one process, in chunks of 2: its workdir and the
  parameters at the end."""
  root = tmp_path_factory.mktemp('one_process_run')
  ranks.train_rank(0, str(root), _run_config(1), str(root / 'one'), (2, 4))
  _, params = torch.load(root / 'rank0.pt', weights_only=False)
  return root / 'one', params


@pytest.mark.parametrize('first', ['model axis', 'one process'])
def test_a_run_switches_layouts_at_its_checkpoint(tmp_path, first,
                                                  one_process_run):
  """Steps 1-2 in one layout, steps 3-4 resumed in the other (``{data: 1,
  model: 2}`` and one process): the checkpoint at the switch restored in
  the new layout is the one written, bit for bit (parameters and
  moments); the parameters at step 4 are the one-process run's, as
  ``test_torch_parallel`` holds a resumed run."""
  one_dir, one_params = one_process_run
  two_dir = tmp_path / 'two'
  if first == 'model axis':
    ranks.run_ranks(ranks.train_rank, 2, str(tmp_path), _run_config(2),
                    str(two_dir), (2,), timeout=90)
    (tmp_path / 'resume').mkdir()
    ranks.resume_rank(0, str(tmp_path / 'resume'), _run_config(1),
                      str(two_dir), 4)
    at_switch, start, end = torch.load(tmp_path / 'resume' / 'rank0.pt',
                                       weights_only=False)
    assert not mesh.active()
  else:
    shutil.copytree(one_dir / 'checkpoints' / '2',
                    two_dir / 'checkpoints' / '2')
    ranks.run_ranks(ranks.resume_rank, 2, str(tmp_path), _run_config(2),
                    str(two_dir), 4, timeout=90)
    (at_switch, start, end), (other, _, end_b) = _load(tmp_path, 2)
    for key in ('params', 'mu', 'nu'):
      for name, value in at_switch[key].items():
        assert torch.equal(other[key][name], value), (key, name)
    for name, p in end.items():
      assert torch.equal(end_b[name], p), name
  assert start == 2
  written = torch.load(two_dir / 'checkpoints' / '2' / checkpoints.PARAMS,
                       weights_only=True)
  moments = torch.load(two_dir / 'checkpoints' / '2' / checkpoints.OPT_STATE,
                       weights_only=True)
  assert set(at_switch['params']) == set(written)
  for name, value in written.items():
    assert torch.equal(at_switch['params'][name], value), name
  for key in ('mu', 'nu'):
    for name, value in moments[key].items():
      assert torch.equal(at_switch[key][name], value), (key, name)
  for name, p in one_params.items():
    np.testing.assert_allclose(end[name], p, atol=4 * 2 * tpar.LR, rtol=0,
                               err_msg=name)


def test_a_warm_start_loads_full_leaves_into_slices(tmp_path):
  """``update_pretrained_variables`` on a model sharded at ``{data: 1,
  model: 2}``: each rank copies its slice of every full pretrained leaf,
  so the leaves gathered back are the pretrained ones bit for bit."""
  config, _ = _tiny()
  pretrained = evaluator.build_model(config, 'cpu', seed=7).state_dict()
  ranks.run_ranks(ranks.warm_start_rank, 2, str(tmp_path), config,
                  pretrained, LAYOUTS['1x2'], MIN_DIM)
  for copied, params in _load(tmp_path, 2):
    assert copied == len(pretrained)
    for name, value in pretrained.items():
      assert torch.equal(params[name], value), name


def test_fp16_skips_a_step_on_every_rank(tmp_path):
  """One fp16 step at ``{data: 1, model: 2}`` (batch 2) whose gradient is
  infinite on rank 1's slice alone: both ranks log it not finite, keep
  every parameter and the optimizer's count, and halve the loss scale."""
  config, _ = _tiny()
  config = dataclasses.replace(config, dtype_str='float16', batch_size=2)
  _, batch = torch_a14.pair_batches(config)
  state_dict = evaluator.build_model(config, 'cpu').state_dict()
  ranks.run_ranks(ranks.fp16_rank, 2, str(tmp_path), config, state_dict,
                  batch, LAYOUTS['1x2'], MIN_DIM, 1)
  got = _load(tmp_path, 2)
  for g in got:
    assert g['logs']['is_finite'] == 0.0
    assert g['kept'] and g['count'] == 0
    assert g['scale'] == 65536.0 / 2
  assert got[0]['first'] == got[1]['first']


def test_a_frozen_mapper_keeps_its_sharded_leaves(tmp_path):
  """One ``smoke_semantics`` step (the tiny config of
  ``tests/torch_heads.py``) with the mapper frozen
  (``freeze_params_reg_exp='bev_mapper/'``) at ``{data: 1, model: 2}``:
  the mapper's sharded leaves keep their bits on both ranks, the head's
  move, and every leaf is the one-process step's."""
  config = configs.smoke_semantics()
  config = dataclasses.replace(config, train=dataclasses.replace(
      config.train, optimizer_configs=dataclasses.replace(
          config.train.optimizer_configs,
          freeze_params_reg_exp='bev_mapper/')))
  _, batch = torch_heads.single_scene_batches(config)
  model = evaluator.build_model(config, 'cpu')
  state_dict = model.state_dict()
  draws = model.sample_draws(config.batch_size,
                             torch.Generator().manual_seed(5), 'cpu')
  one, one_params = ranks.steps(config, state_dict, [batch], [draws])
  ranks.run_ranks(ranks.tp_step_rank, 2, str(tmp_path), config, state_dict,
                  [batch], [draws], 1, LAYOUTS['1x2'], MIN_DIM)
  got = _load(tmp_path, 2)
  dims = got[0][2]
  frozen = [n for n in dims if n.startswith('bev_mapper.')]
  assert frozen and len(frozen) < len(dims)
  for g in got:
    for name in frozen:
      size = state_dict[name].shape[dims[name]] // 2
      assert torch.equal(g[1][name], state_dict[name].narrow(
          dims[name], g[3][1] * size, size)), name
  params = _assemble(got, 'params')
  moved = [n for n in dims if n not in frozen
           and not torch.equal(params[n], state_dict[n])]
  assert moved
  for name, p in one_params.items():
    tpar._assert_params_close(params[name], p, one[0]['grads'][name],
                              one[0]['logs']['l2_grads'], name)
