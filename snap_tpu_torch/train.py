"""Train the port's exhaustive-backend localizer for a few steps.

    python -m snap_tpu_torch.train --config=train_full1chip_exhaustive \\
        --num_steps=3
    python -m snap_tpu_torch.train --config=smoke_train_exhaustive \\
        --num_steps=3 --device=cpu

Builds the localizer of the named config with weights drawn from
``--seed``, reads one batch of synthetic map/query pairs per step from the
dataset's train iterator (the config's training split, seeded as the JAX
loader seeds it; examples ``step * batch + k``), and takes ``num_steps``
Adam steps (``train_lib.trainer.train_step``). The batches are made on the
card when ``--device`` is a CUDA card, unless
``--on_device_generation=false``; ``--on_device_generation=true
--device=cpu`` runs the device generator on the CPU. Prints one JSON line
per step (loss, gradient and update norms, learning rate) and, at the end,
one with the data path (``generator_kind``), the step times and each
batch's build time, and writes the model's ``state_dict`` to
``<workdir>/params.pt``.
``--profile`` runs the last step under ``torch.profiler`` and prints its
per-op table, sorted by device time. The default device is ``cuda``; there
is no fallback to the CPU when no card is found. Checkpoint resume, the
eval loop and parameter freezing are not ported yet.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
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
          profile: bool = False,
          on_device_generation: Optional[bool] = None) -> Dict[str, Any]:
  """Take ``num_steps`` training steps; returns the logs and timings.

  Batches come from the dataset's train iterator (``loader.get_dataset``),
  made on the card or on the host as ``on_device_generation`` says (None:
  on the card iff ``device`` is CUDA). The result holds per-step ``logs``
  and metric means (``metrics``), the wall time of each step
  (``step_seconds``, ending in a device synchronize; on the device path
  the card may still be making the batch when the step starts, and that
  tail counts in the step) and of each step with the wait for its batch
  (``wall_seconds``), each batch's build time (``build_ms``: the host's
  ms in the build; ``build_card_ms``: the card's ms from CUDA events, None
  off the card), ``generator_kind`` and the final ``TrainState``.
  ``on_step(i, out)`` sees each step's output (gradients included) before
  it is dropped. With ``profile``, ``profile`` holds the last step's
  per-op table.
  """
  config = configs.get_config(config_name)
  data = dataclasses.replace(config.data,
                             on_device_generation=on_device_generation)
  if model is None:
    model = evaluate.build_localizer(config, device, seed)
  model.train()
  optimizer = optimizers.Adam(config.train)
  state = trainer.create_train_state(model, optimizer, seed)
  cuda = torch.device(device).type == 'cuda'
  logs, metrics, step_seconds, wall_seconds, builds = [], [], [], [], []
  with loader.get_dataset(data, config.batch_size, device=device) as dataset:
    for step in range(num_steps):
      t_batch = time.perf_counter()
      batch = next(dataset.train_iter)
      del batch['_host']
      builds.append(dataset.train_iter.last_build)
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
        wall_seconds.append(time.perf_counter() - t_batch)
      logs.append(out.logs)
      metrics.append(trainer.summarize([out.metrics]))
      if on_step is not None:
        on_step(step, out)
      del out, batch
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
      'generator_kind': dataset.meta_data['generator_kind'],
      'logs': logs,
      'metrics': metrics,
      'step_seconds': step_seconds,
      'wall_seconds': wall_seconds,
      'build_ms': [build.wall_ms for build in builds],
      'build_card_ms': [build.card_ms for build in builds],
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
  parser.add_argument('--on_device_generation', default='auto',
                      choices=('auto', 'true', 'false'),
                      help='make the batches on the device (auto: iff it '
                      'is a CUDA card)')
  parser.add_argument('--profile', action='store_true',
                      help="print the last step's per-op profile")
  args = parser.parse_args(argv)

  def print_step(step: int, out: trainer.StepOutput) -> None:
    line = {'step': step, **out.logs,
            **{k: v for k, v in trainer.summarize([out.metrics]).items()
               if k.startswith('loss/')}}
    print(json.dumps(line), flush=True)

  result = train(args.config, args.num_steps, args.device, args.seed,
                 args.workdir, on_step=print_step, profile=args.profile,
                 on_device_generation=evaluate.on_device_flag(
                     args.on_device_generation))
  if result['profile'] is not None:
    print(result['profile'])
  print(json.dumps({
      key: result[key] for key in (
          'config', 'device', 'generator_kind', 'step_seconds',
          'wall_seconds', 'build_ms', 'build_card_ms', 'workdir')}))


if __name__ == '__main__':
  main()
