"""Train the port's exhaustive-backend localizer for a few steps.

    python -m snap_tpu_torch.train --config=train_full1chip_exhaustive \\
        --num_steps=3
    python -m snap_tpu_torch.train --config=smoke_train_exhaustive \\
        --num_steps=3 --device=cpu

Builds the localizer of the named config with weights drawn from
``--seed``, makes one batch of synthetic map/query pairs per step with the
port's generator (the config's training split, seeded as the JAX loader
seeds it; examples ``step * batch + k``), and takes ``num_steps``
Adam steps (``train_lib.trainer.train_step``). Prints one JSON line per
step (loss, gradient and update norms, learning rate, step time) and, at
the end, writes the model's ``state_dict`` to ``<workdir>/params.pt``.
``--profile`` runs the last step under ``torch.profiler`` and prints its
per-op table, sorted by device time. The default device is ``cuda``; there
is no fallback to the CPU when no card is found. Checkpoint resume, the
eval loop and parameter freezing are not ported yet.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import pathlib
import time
from typing import Any, Callable, Dict, Optional

import torch

from snap_tpu_torch import configs
from snap_tpu_torch import evaluate
from snap_tpu_torch.data import loader
from snap_tpu_torch.models import bev_localizer
from snap_tpu_torch.train_lib import optimizers
from snap_tpu_torch.train_lib import trainer

WORKDIRS = pathlib.Path(__file__).resolve().parents[1] / 'workdirs'


def train(config_name: str = 'train_full1chip_exhaustive', num_steps: int = 3,
          device: str = 'cuda', seed: int = 0,
          workdir: Optional[str] = None,
          model: Optional[bev_localizer.BEVLocalizer] = None,
          on_step: Optional[Callable[[int, trainer.StepOutput], None]] = None,
          profile: bool = False) -> Dict[str, Any]:
  """Take ``num_steps`` training steps; returns the logs and timings.

  The result holds per-step ``logs`` and metric means (``metrics``), the
  wall time of each step (ending in a device synchronize) and of building
  each batch on the host, and the final ``TrainState``. ``on_step(i, out)``
  sees each step's output (gradients included) before it is dropped. With
  ``profile``, ``profile`` holds the last step's per-op table.
  """
  config = configs.get_config(config_name)
  if model is None:
    model = evaluate.build_localizer(config, device, seed)
  model.train()
  optimizer = optimizers.Adam(config.train)
  state = trainer.create_train_state(model, optimizer, seed)
  generator = loader.split_generator(config.data, 'train')
  cuda = torch.device(device).type == 'cuda'
  logs, metrics, step_seconds, batch_seconds = [], [], [], []
  for step in range(num_steps):
    t0 = time.perf_counter()
    examples = loader.make_train_examples(generator, step, config.batch_size,
                                          config.data)
    batch = loader.pair_batch_to_torch(examples, device)
    batch_seconds.append(time.perf_counter() - t0)
    with contextlib.ExitStack() as stack:
      if profile and step == num_steps - 1:
        prof = stack.enter_context(torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]))
      t0 = time.perf_counter()
      out = trainer.train_step(state, batch, optimizer)
      if cuda:
        torch.cuda.synchronize(device)
      step_seconds.append(time.perf_counter() - t0)
    logs.append(out.logs)
    metrics.append(trainer.summarize([out.metrics]))
    if on_step is not None:
      on_step(step, out)
    del out
  if workdir is None:
    workdir = WORKDIRS / f'torch_{config_name}'
  workdir = pathlib.Path(workdir)
  workdir.mkdir(parents=True, exist_ok=True)
  torch.save(model.state_dict(), workdir / 'params.pt')
  table = None
  if profile:
    table = prof.key_averages().table(
        sort_by='cuda_time_total' if cuda else 'cpu_time_total',
        row_limit=40)
  return {
      'config': config_name,
      'device': str(device),
      'logs': logs,
      'metrics': metrics,
      'step_seconds': step_seconds,
      'batch_seconds': batch_seconds,
      'workdir': str(workdir),
      'state': state,
      'profile': table,
  }


def main(argv=None) -> None:
  parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  parser.add_argument('--config', default='train_full1chip_exhaustive',
                      choices=sorted(configs.CONFIGS))
  parser.add_argument('--num_steps', type=int, default=3)
  parser.add_argument('--device', default='cuda')
  parser.add_argument('--seed', type=int, default=0)
  parser.add_argument('--workdir', default=None)
  parser.add_argument('--profile', action='store_true',
                      help="print the last step's per-op profile")
  args = parser.parse_args(argv)

  def print_step(step: int, out: trainer.StepOutput) -> None:
    line = {'step': step, **out.logs,
            **{k: v for k, v in trainer.summarize([out.metrics]).items()
               if k.startswith('loss/')}}
    print(json.dumps(line), flush=True)

  result = train(args.config, args.num_steps, args.device, args.seed,
                 args.workdir, on_step=print_step,
                 profile=args.profile)
  if result['profile'] is not None:
    print(result['profile'])
  print(json.dumps({
      'config': result['config'], 'device': result['device'],
      'step_seconds': result['step_seconds'],
      'batch_seconds': result['batch_seconds'],
      'workdir': result['workdir']}))


if __name__ == '__main__':
  main()
