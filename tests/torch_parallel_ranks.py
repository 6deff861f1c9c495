"""Ranks of the mesh's data axis on the CPU, for ``test_torch_parallel.py``.

``run_ranks(fn, world, *args)`` starts ``world`` processes (spawned, so no
state of the test's process leaks into them), each with the environment
``torchrun`` gives a rank (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``); each starts the
process group through ``parallel.mesh.init('cpu')`` (gloo), runs
``fn(rank, *args)`` and ends it. A rank that raises, or ranks that are not
done within ``timeout`` seconds, fail the call (the others are killed).
The functions below are the ranks' work; they write what the test
compares into files (``torch.save``). Nothing here imports JAX.
"""

from __future__ import annotations

import os
import pathlib
import socket
import time
from typing import Any, Callable

import torch
import torch.multiprocessing as mp

from snap_tpu_torch import configs
from snap_tpu_torch import evaluator
from snap_tpu_torch import train
from snap_tpu_torch.data import loader
from snap_tpu_torch.parallel import mesh
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


def _state(config: configs.Config, state_dict, seed: int = 0):
  model = evaluator.build_model(config, 'cpu', state_dict=state_dict)
  model.train()
  adam = optimizers.get_optimizer(config.train, model)
  return trainer.create_train_state(model, adam, seed=seed), adam


def steps(config: configs.Config, state_dict, batches, draws,
          num_steps: int = 1, rows=None):
  """``num_steps`` train steps from ``state_dict`` on ``batches`` (each
  the global batch's, or this rank's rows of it with ``rows``), the draws
  of each injected: per step the loss's (sum, count), the logs and the
  gradients, and the parameters after the last."""
  state, adam = _state(config, state_dict)
  out = []
  for batch, draw in zip(batches[:num_steps], draws):
    if rows is not None:
      batch = {k: v for k, v in loader_rows(batch, rows).items()}
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
  params = {k: p.detach().clone()
            for k, p in result['state'].model.named_parameters()}
  torch.save((chunks, params), pathlib.Path(out) / f'rank{rank}.pt')


def eval_rank(rank: int, out: str, eval_config: configs.EvalConfig,
              location: str):
  """``evaluator.run_for_location``: this rank's copy of the results."""
  results, _ = evaluator.run_for_location(location, eval_config,
                                          device='cpu')
  torch.save(results, pathlib.Path(out) / f'rank{rank}.pt')
