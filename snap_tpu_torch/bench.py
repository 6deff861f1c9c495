"""Benchmark the port on one card: localization and map building at eval
scale, and the full-scale training step.

    python -m snap_tpu_torch.bench

The port of ``bench.py:63-235, 428-466``. ``bench_eval`` builds the
localizer of ``bench_full`` (R50 street-view + aerial mapper, 20 views of
180x240, 0.2 m voxels, top-k 4 lift, 64 rotations + dense refinement,
bf16, seeded weights) at batch ``EVAL_BATCH`` on one batch of
'bench-city' made by the port's loader (on the card when the device is
one: ``generator_kind`` ``device-torch``), and times ``localize`` (the
whole forward, reduced to the scalars ``bench.py`` reduces it to) and
``build_map`` (the map's mapper alone) with ``time_fn``. ``bench_train_
step`` times the Adam step of ``train_full1chip_exhaustive`` at batch
``TRAIN_BATCH`` with a constant learning rate of 1e-4 on one batch of its
training split: one warm-up step, then ``NUM_ITERS`` steps, and the peak
of allocated memory. One JSON line follows, with ``bench.py``'s fields,
the device (``nvidia-smi``'s name and power limit of the card), the data
path and each batch's build ms. A failure raises: no older result stands
in for it. ``run`` takes other configs (the tests run it at smoke size on
the CPU).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import time
from typing import Any, Callable, Dict, Tuple

import torch

from snap_tpu_torch import configs
from snap_tpu_torch import evaluator
from snap_tpu_torch.data import loader
from snap_tpu_torch.train_lib import optimizers
from snap_tpu_torch.train_lib import trainer

EVAL_BATCH = 4  # the reference's eval protocol batch
TRAIN_BATCH = 2  # the flagship run's batch
NUM_ITERS = 10
TRAIN_LR = 1e-4
# The reference's sampled-path eval budget per localization query:
# 20,000 RANSAC samples + a 41^3 refinement lattice.
POSES_PER_QUERY = 20_000 + 41 * 41 * 41


def time_fn(fn: Callable[[], torch.Tensor], iters: int = NUM_ITERS) -> float:
  """Seconds per call: one warm-up call, then ``iters`` calls dispatched
  back to back and read at the end (``bench.py:time_fn``); reading a
  scalar on the card waits for it."""
  float(fn())
  t0 = time.perf_counter()
  outs = [fn() for _ in range(iters)]
  for out in outs:
    float(out)
  return (time.perf_counter() - t0) / iters


def one_batch(data: configs.DataConfig, batch_size: int, device: str,
              split: str) -> Tuple[Dict[str, Any], loader.BuildTime, str]:
  """The first batch of a split from the port's loader, its build time and
  the data path."""
  with loader.get_dataset(data, batch_size, device=device) as dataset:
    iterator = dataset.train_iter if split == 'train' else dataset.valid_iter
    batch = next(iterator)
    build = iterator.last_build
  batch.pop('_host')
  return batch, build, dataset.meta_data['generator_kind']


def bench_eval(device: str = 'cuda', config_name: str = 'bench_full'
               ) -> Dict[str, Any]:
  """Queries and maps per second at eval scale."""
  config = configs.get_config(config_name, batch_size=EVAL_BATCH)
  data = dataclasses.replace(config.data, evaluation_size=EVAL_BATCH)
  model = evaluator.build_localizer(config, device, seed=0)
  # bench.py times the loader's dummy batch: the training split's first.
  batch, build, kind = one_batch(data, EVAL_BATCH, device, 'train')
  generator = torch.Generator().manual_seed(2)

  def localize() -> torch.Tensor:
    pred = model(batch, generator=generator)
    return pred['scores_poses'].sum() + pred['map_t_query'].t.sum()

  def build_map() -> torch.Tensor:
    return model.bev_mapper(batch['map'])['bev_matching'].features.sum()

  with torch.inference_mode():
    localize_s = time_fn(localize)
    map_s = time_fn(build_map)
  return {'localization_queries_per_sec': EVAL_BATCH / localize_s,
          'bev_maps_per_sec': EVAL_BATCH / map_s,
          'generator_kind': kind, 'build_ms': build.wall_ms,
          'build_card_ms': build.card_ms}


def bench_train_step(device: str = 'cuda',
                     config_name: str = 'train_full1chip_exhaustive'
                     ) -> Dict[str, Any]:
  """Seconds per Adam step at full scale, and the peak memory."""
  config = configs.get_config(config_name, batch_size=TRAIN_BATCH)
  train = dataclasses.replace(config.train, lr_configs=configs.LrConfig(
      factors='constant', base_learning_rate=TRAIN_LR))
  model = evaluator.build_localizer(config, device, seed=0).train()
  optimizer = optimizers.Adam(train)
  state = trainer.create_train_state(model, optimizer, seed=0)
  batch, build, kind = one_batch(config.data, TRAIN_BATCH, device, 'train')
  cuda = torch.device(device).type == 'cuda'
  if cuda:
    torch.cuda.reset_peak_memory_stats(device)
  trainer.train_step(state, batch, optimizer)
  t0 = time.perf_counter()
  for _ in range(NUM_ITERS):
    out = trainer.train_step(state, batch, optimizer)
  loss = trainer.summarize([out.metrics])['loss/total']
  step_s = (time.perf_counter() - t0) / NUM_ITERS
  return {'train_step_sec_full_scale': step_s,
          'train_examples_per_sec': TRAIN_BATCH / step_s,
          'train_batch_per_chip': TRAIN_BATCH,
          'train_step_hbm_gb': (torch.cuda.max_memory_allocated(device) / 2**30
                                if cuda else None),
          'train_loss': loss, 'generator_kind': kind,
          'build_ms': build.wall_ms, 'build_card_ms': build.card_ms}


def device_name(device: str) -> str:
  """The card's name and power limit (``nvidia-smi``), or the device."""
  if torch.device(device).type != 'cuda':
    return str(device)
  smi = subprocess.run(
      ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
      capture_output=True, text=True, timeout=60, check=True).stdout
  return smi.strip().splitlines()[torch.device(device).index or 0]


def run(device: str = 'cuda', eval_config: str = 'bench_full',
        train_config: str = 'train_full1chip_exhaustive') -> Dict[str, Any]:
  """Both benches; the line ``main`` prints."""
  evals = bench_eval(device, eval_config)
  if torch.device(device).type == 'cuda':
    torch.cuda.empty_cache()
  trains = bench_train_step(device, train_config)
  poses_per_sec = evals['localization_queries_per_sec'] * POSES_PER_QUERY
  return {
      'metric': 'pose_queries_per_sec_per_chip',
      'value': poses_per_sec,
      'unit': 'poses/s',
      'vs_baseline': poses_per_sec / 1000.0,
      'poses_scored_per_query': POSES_PER_QUERY,
      'localization_queries_per_sec': evals['localization_queries_per_sec'],
      'bev_maps_per_sec': evals['bev_maps_per_sec'],
      'eval_batch_size': EVAL_BATCH,
      'num_timing_iters': NUM_ITERS,
      **{k: trains[k] for k in (
          'train_step_sec_full_scale', 'train_examples_per_sec',
          'train_batch_per_chip', 'train_step_hbm_gb', 'train_loss')},
      'device': device_name(device),
      'eval_config': eval_config,
      'train_config': train_config,
      'generator_kind': {'eval': evals['generator_kind'],
                         'train': trains['generator_kind']},
      'build_ms': {'eval': evals['build_ms'], 'train': trains['build_ms']},
      'build_card_ms': {'eval': evals['build_card_ms'],
                        'train': trains['build_card_ms']},
  }


def main(argv=None) -> Dict[str, Any]:
  parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  parser.add_argument('--device', default='cuda')
  args = parser.parse_args(argv)
  out = run(args.device)
  print(json.dumps(out), flush=True)
  return out


if __name__ == '__main__':
  main()
