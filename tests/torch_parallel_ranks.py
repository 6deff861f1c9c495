"""Ranks of the mesh on the CPU, for ``test_torch_parallel.py`` (the data
axis) and ``test_torch_tensor_parallel.py`` (the model axis).

``run_ranks(fn, world, *args)`` starts ``world`` processes (spawned, so no
state of the test's process leaks into them), each with the environment
``torchrun`` gives a rank (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``); each starts the
process group through ``parallel.mesh.init('cpu')`` (gloo), runs
``fn(rank, *args)`` and ends it. A rank that raises, or ranks that are not
done within ``timeout`` seconds, fail the call (the others are killed).
The functions below are the ranks' work; they write what the test
compares into files (``torch.save``). Those of the model axis lay the
ranks out on a ``{data, model}`` mesh first (``mesh.setup``) and write
each sharded leaf as the rank's slice beside its dim. Nothing here imports
JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import pathlib
import socket
import time
from typing import Any, Callable

import torch
import torch.multiprocessing as mp

import chip_smoke
from snap_tpu_torch import configs
from snap_tpu_torch import evaluator
from snap_tpu_torch import train
from snap_tpu_torch.data import loader
from snap_tpu_torch.parallel import mesh
from snap_tpu_torch.parallel import tensor
from snap_tpu_torch.train_lib import checkpoints
from snap_tpu_torch.train_lib import dynamic_scale
from snap_tpu_torch.train_lib import optimizers
from snap_tpu_torch.train_lib import trainer

# Each rank's whole life (start, import, its work): a hang fails in this
# time rather than holding the suite's clock.
TIMEOUT_S = 45


def free_port() -> int:
  with socket.socket() as s:
    s.bind(('localhost', 0))
    return s.getsockname()[1]


def _rank_main(rank: int, world: int, port: int, fn: Callable, args):
  os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                    LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world),
                    MASTER_ADDR='localhost', MASTER_PORT=str(port))
  torch.set_num_threads(1)
  process = mesh.init('cpu')
  assert (process.rank, process.world, process.backend) == (rank, world,
                                                            'gloo')
  try:
    fn(rank, *args)
  finally:
    mesh.shutdown()


def run_ranks(fn: Callable, world: int, *args: Any,
              timeout: float = TIMEOUT_S) -> None:
  context = mp.start_processes(_rank_main,
                               args=(world, free_port(), fn, args),
                               nprocs=world, join=False,
                               start_method='spawn')
  deadline = time.monotonic() + timeout
  while not context.join(timeout=max(deadline - time.monotonic(), 0.1)):
    if time.monotonic() > deadline:
      for process in context.processes:
        process.kill()
      raise TimeoutError(f'{world} ranks of {fn.__name__} not done in '
                         f'{timeout} s')


def _state(config: configs.Config, state_dict, seed: int = 0,
           min_dim=None):
  """A train state of ``config`` from ``state_dict``, its leaves sharded
  over the mesh's model axis by ``min_dim`` where one is given."""
  model = evaluator.build_model(config, 'cpu', state_dict=state_dict)
  if min_dim is not None:
    tensor.shard_model(model, min_dim)
  model.train()
  adam = optimizers.get_optimizer(config.train, model)
  return trainer.create_train_state(
      model, adam, seed=seed,
      dynamic_scale=dynamic_scale.for_dtype(config.dtype_str)), adam


def _replaying(model, batch, draw, relu_sides):
  """A context in which ``model``'s relus take ``relu_sides`` (in call
  order) and its other max sites the choices its own forward on ``batch``
  makes (recorded by a forward without autograd, the step's draws and rows
  as ``trainer.train_step`` takes them; ``chip_smoke.MaxChoices``); none
  without ``relu_sides``."""
  if relu_sides is None:
    return contextlib.nullcontext()
  rows = trainer._rows_of_batch(batch)
  local = draw if rows is None else trainer.local_draws(draw, rows[0])
  with torch.no_grad(), chip_smoke.MaxChoices(model) as own:
    trainer.loss_and_metrics(model, batch, True, draws=local)
  sides = iter(relu_sides)
  replay = [next(sides) if site == 'F.relu' else call
            for site, call in zip(own.sites, own.calls)]
  assert next(sides, None) is None
  return chip_smoke.MaxChoices(model, replay=replay)


def steps(config: configs.Config, state_dict, batches, draws,
          num_steps: int = 1, rows=None, min_dim=None, relu_sides=None):
  """``num_steps`` train steps from ``state_dict`` on ``batches`` (each
  the global batch's, or this rank's rows of it with ``rows``), the draws
  of each injected: per step the loss's (sum, count), the logs and the
  gradients, and the parameters after the last (a sharded leaf's, with
  ``min_dim``, this rank's slice). ``relu_sides``: the first step's relus
  take these sides (the global batch's, in call order; a rank takes its
  block of each, by data index) and its other max sites their own
  choices (ROADMAP C11)."""
  state, adam = _state(config, state_dict, min_dim=min_dim)
  if relu_sides is not None and rows is not None:
    relu_sides = [side.chunk(mesh.data_size())[mesh.data_index()]
                  for side in relu_sides]
  out = []
  for i, (batch, draw) in enumerate(zip(batches[:num_steps], draws)):
    if rows is not None:
      batch = {k: v for k, v in loader_rows(batch, rows).items()}
    with _replaying(state.model, batch, draw,
                    relu_sides if i == 0 else None):
      step = trainer.train_step(state, batch, adam, draws=draw)
    out.append(dict(loss=[float(t) for t in step.metrics['loss/total']],
                    logs=step.logs,
                    grads={k: g.clone() for k, g in step.grads.items()}))
  params = {k: p.detach().clone() for k, p in state.model.named_parameters()}
  return out, params


def loader_rows(tree, rows: slice):
  """Rows ``rows`` of every tensor of a batch (its geometry included)."""
  if isinstance(tree, torch.Tensor):
    return tree[rows]
  if isinstance(tree, dict):
    return {k: loader_rows(v, rows) for k, v in tree.items()}
  if hasattr(tree, '__dataclass_fields__'):
    return type(tree)(**{k: loader_rows(getattr(tree, k), rows)
                         for k in tree.__dataclass_fields__})
  return tree


def step_rank(rank: int, out: str, config: configs.Config, state_dict,
              batches, draws, num_steps: int):
  """This rank's steps on its block of each global batch."""
  rows = mesh.block(config.batch_size)
  torch.save(steps(config, state_dict, batches, draws, num_steps, rows),
             pathlib.Path(out) / f'rank{rank}.pt')


def _place():
  return mesh.data_index(), mesh.model_index()


def tp_step_rank(rank: int, out: str, config: configs.Config, state_dict,
                 batches, draws, num_steps: int, axes, min_dim: int,
                 relu_sides=None, without_input_sum: bool = False):
  """``step_rank`` on a ``{data, model}`` mesh, the leaves sharded by
  ``min_dim`` (and the relus of the first step given ``relu_sides``): its
  steps, parameters, the sharded leaves' dims and its place. With
  ``without_input_sum`` it then takes the first step again from the same
  state, without the all-reduce of a sharded layer's input gradient over
  the model group (the fault the test must catch), and keeps that step
  too."""
  mesh.setup(axes)
  dims = mesh.infer_param_shardings(
      evaluator.build_model(config, 'cpu'), min_dim)
  rows = mesh.block(config.batch_size)
  got = steps(config, state_dict, batches, draws, num_steps, rows, min_dim,
              relu_sides)
  broken = None
  if without_input_sum:
    tensor._CopyToModel.backward = staticmethod(lambda ctx, g: g)
    broken = steps(config, state_dict, batches, draws, 1, rows, min_dim,
                   relu_sides)[0]
  torch.save((*got, dims, _place(), broken),
             pathlib.Path(out) / f'rank{rank}.pt')


def full_params(model) -> dict:
  """``model``'s parameters as full leaves (a sharded one gathered over
  the model group: every rank of it takes part)."""
  return {k: tensor.full(p, p.tp_dim) if tensor.is_sharded(p)
          else p.detach().clone() for k, p in model.named_parameters()}


def restored(config: configs.Config, workdir: str) -> dict:
  """The latest checkpoint of ``workdir`` restored into a state of
  ``config`` on this mesh (sharded by ``config.tp_min_dim``), gathered back
  to full leaves: ``checkpoints.host_state``."""
  state, _ = _state(config, None, min_dim=config.tp_min_dim)
  checkpoints.restore_checkpoint(workdir, state)
  return checkpoints.host_state(state)


def blocks_rank(rank: int, out: str, data: configs.DataConfig, bs: int,
                eval_bs: int):
  """This rank's first train batch and every eval batch from the loader."""
  with loader.get_dataset(data, bs, eval_batch_size=eval_bs,
                          device='cpu') as dataset:
    got = [next(dataset.train_iter)] + [
        next(dataset.valid_iter)
        for _ in range(-(-data.evaluation_size // eval_bs))]
  torch.save(got, pathlib.Path(out) / f'rank{rank}.pt')


def train_rank(rank: int, out: str, config: configs.Config, workdir: str,
               stops):
  """``train.train`` in chunks, each to its stop step, resuming from the
  checkpoint of the one before: each chunk's start step, checkpoints and
  summaries, and the parameters at the end."""
  chunks = []
  for stop in stops:
    result = train.train(config, device='cpu', workdir=workdir, seed=0,
                         stop_at_step=stop)
    chunks.append(dict(start=result['start_step'],
                       checkpoints=sorted(result['checkpoints']),
                       summary=result['train_summary'],
                       shuffle_seed=result['shuffle_seed']))
  params = full_params(result['state'].model)
  torch.save((chunks, params), pathlib.Path(out) / f'rank{rank}.pt')


def resume_rank(rank: int, out: str, config: configs.Config, workdir: str,
                stop: int):
  """A run resumed from ``workdir``'s latest checkpoint on ``config``'s
  mesh: first that checkpoint restored and gathered back (``restored``),
  then ``train.train`` to ``stop``; the parameters at the end, full."""
  mesh.setup(mesh.make_mesh(dataclasses.asdict(config.mesh)))
  at_switch = restored(config, workdir)
  result = train.train(config, device='cpu', workdir=workdir, seed=0,
                       stop_at_step=stop)
  torch.save((at_switch, result['start_step'],
              full_params(result['state'].model)),
             pathlib.Path(out) / f'rank{rank}.pt')


def warm_start_rank(rank: int, out: str, config: configs.Config, pretrained,
                    axes, min_dim: int):
  """``trainer.update_pretrained_variables`` on a model sharded over
  ``axes`` whose hooks give ``pretrained`` (full leaves, by name): the
  leaves after it, full (gathered), and the count copied."""
  mesh.setup(axes)
  state, _ = _state(config, None, min_dim=min_dim)
  state.model.load_pretrained_variables = lambda: pretrained
  copied = trainer.update_pretrained_variables(state.model)
  torch.save((copied, full_params(state.model)),
             pathlib.Path(out) / f'rank{rank}.pt')


def fp16_rank(rank: int, out: str, config: configs.Config, state_dict,
              batch, axes, min_dim: int, poisoned: int):
  """One fp16 step on a ``{data, model}`` mesh whose gradient of the first
  sharded leaf is made infinite, on rank ``poisoned`` alone (a hook on
  its slice): the step's logs, the scale after it, whether every
  parameter kept its bits."""
  mesh.setup(axes)
  state, adam = _state(config, state_dict, min_dim=min_dim)
  named = dict(state.model.named_parameters())
  first = next(n for n, p in named.items() if tensor.is_sharded(p))
  if rank == poisoned:
    named[first].register_hook(
        lambda g: g.index_fill(0, torch.tensor([0]), float('inf')))
  before = {k: p.detach().clone() for k, p in named.items()}
  step = trainer.train_step(state, batch, adam)
  kept = all(torch.equal(before[k], p) for k, p in named.items())
  torch.save(dict(logs=step.logs, scale=state.dynamic_scale.scale,
                  kept=kept, first=first, count=state.opt_state.count),
             pathlib.Path(out) / f'rank{rank}.pt')



def eval_rank(rank: int, out: str, eval_config: configs.EvalConfig,
              location: str):
  """``evaluator.run_for_location``: this rank's copy of the results."""
  results, _ = evaluator.run_for_location(location, eval_config,
                                          device='cpu')
  torch.save(results, pathlib.Path(out) / f'rank{rank}.pt')
