"""Localize synthetic queries with the port's localizer.

    python -m snap_tpu_torch.evaluate --config=bench_full --num_queries=4
    python -m snap_tpu_torch.evaluate --config=eval_full1chip_ransac \\
        --num_queries=8 --batch_size=4
    python -m snap_tpu_torch.evaluate --config=smoke_eval_ransac \\
        --num_queries=2 --batch_size=2 --device=cpu

Builds the localizer of the named config (exhaustive or RANSAC backend),
makes ``num_queries`` synthetic map/query pairs with the port's generator
(the config's eval split, seeded as the JAX loader seeds it), localizes
them in batches, and prints each query's position and angle error, the
recall at 1 m, the top-1 recall and, for the RANSAC backend, the share of
pose samples near the GT. Weights are drawn from ``--seed``, or read from
``--params_npz``: a flat ``.npz`` of the JAX model's params keyed by
'/'-joined flax paths; the RANSAC backend's pose samples are drawn on a CPU
``torch.Generator`` seeded from ``--seed``. The default device is ``cuda``;
there is no fallback to the CPU when no card is found.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from snap_tpu_torch import configs
from snap_tpu_torch import convert
from snap_tpu_torch.data import loader
from snap_tpu_torch.models import bev_localizer
from snap_tpu_torch.utils import geometry

_DTYPES = {'bfloat16': torch.bfloat16, 'float32': torch.float32}


def build_localizer(config: configs.Config, device: str = 'cuda',
                    seed: int = 0,
                    params_npz: Optional[str] = None
                    ) -> bev_localizer.BEVLocalizer:
  """The localizer of ``config`` with seeded or converted weights."""
  model = bev_localizer.BEVLocalizer(
      config.model, loader.map_grid(config.data).bev(),
      dtype=_DTYPES[config.dtype_str])
  if params_npz is None:
    convert.init_params(model, seed, config.model.init_temperature)
  else:
    with np.load(params_npz) as npz:
      state = convert.params_from_flax(dict(npz), model)
    model.load_state_dict(state)
  return model.to(device).eval()


def pose_errors(pred_t: geometry.Transform2D, batch: Dict[str, Any]):
  """Position (m) and angle (deg) error of ``map_t_query`` against GT."""
  gt = geometry.Transform2D.from_Transform3D(batch['T_query2map'])
  dr, dt = (pred_t.inv @ gt).magnitude()
  return dt, dr


def evaluate(config_name: str = 'bench_full', num_queries: int = 4,
             device: str = 'cuda', seed: int = 0, batch_size: int = 1,
             params_npz: Optional[str] = None,
             model: Optional[bev_localizer.BEVLocalizer] = None,
             profile: bool = False,
             on_batch: Optional[Callable[[int, Dict[str, Any]], None]] = None,
             ) -> Dict[str, Any]:
  """Localize ``num_queries`` synthetic queries; returns errors and times.

  The result holds per-query ``position_error_m`` / ``angle_error_deg``,
  ``recall_1m``, the means of ``loss_metrics_function``'s top-1 recall
  and, RANSAC only, its sample recalls, the per-batch wall times of the
  forward (each ends in a device synchronize) and of building the batch on
  the host, and the last batch's predictions under ``last_pred``.
  ``on_batch(i, pred)`` sees each batch's predictions. With ``profile``,
  the last batch's forward runs under ``torch.profiler`` and ``profile``
  holds its per-op table, sorted by device time.
  """
  config = configs.get_config(config_name, batch_size=batch_size)
  if model is None:
    model = build_localizer(config, device, seed, params_npz)
  generator = loader.split_generator(config.data, 'eval')
  pose_generator = torch.Generator().manual_seed(seed)
  pos_err, ang_err, batch_seconds, build_seconds = [], [], [], []
  metrics: Dict[str, list] = {}
  pred = None
  for i, start in enumerate(range(0, num_queries, batch_size)):
    t0 = time.perf_counter()
    indices = range(start, min(start + batch_size, num_queries))
    examples = loader.make_pair_examples(generator, indices, config.data)
    batch = loader.pair_batch_to_torch(examples, device)
    build_seconds.append(time.perf_counter() - t0)
    last = start + batch_size >= num_queries
    with contextlib.ExitStack() as stack:
      if profile and last:
        prof = stack.enter_context(torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]))
      t0 = time.perf_counter()
      with torch.inference_mode():
        pred = model(batch, generator=pose_generator)
        if torch.device(device).type == 'cuda':
          torch.cuda.synchronize(device)
      batch_seconds.append(time.perf_counter() - t0)
    with torch.inference_mode():
      _, batch_metrics = model.loss_metrics_function(pred, batch)
    for key in ('loc/recall_top1', 'loc/recall_samples_0.5m_1deg',
                'loc/recall_samples_1m_2deg', 'loc/recall_samples_2m_4deg'):
      if key in batch_metrics:
        metrics.setdefault(key.split('/')[1], []).extend(
            batch_metrics[key].float().cpu().tolist())
    if on_batch is not None:
      on_batch(i, pred)
    dt, dr = pose_errors(pred['map_t_query'], batch)
    pos_err += dt.cpu().tolist()
    ang_err += dr.cpu().tolist()
  pos = np.asarray(pos_err)
  table = None
  if profile:
    sort_by = ('cuda_time_total' if torch.device(device).type == 'cuda'
               else 'cpu_time_total')
    table = prof.key_averages().table(sort_by=sort_by, row_limit=30)
  return {
      'config': config_name,
      'device': str(device),
      'num_queries': num_queries,
      'position_error_m': pos_err,
      'angle_error_deg': ang_err,
      'recall_1m': float((pos < 1.0).mean()),
      **{k: float(np.mean(v)) for k, v in metrics.items()},
      'batch_seconds': batch_seconds,
      'build_seconds': build_seconds,
      'last_pred': pred,
      'profile': table,
  }


def main(argv=None) -> None:
  parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  parser.add_argument('--config', default='bench_full',
                      choices=sorted(configs.CONFIGS))
  parser.add_argument('--num_queries', type=int, default=4)
  parser.add_argument('--batch_size', type=int, default=1)
  parser.add_argument('--device', default='cuda')
  parser.add_argument('--seed', type=int, default=0)
  parser.add_argument('--params_npz', default=None)
  parser.add_argument('--profile', action='store_true',
                      help="print the last batch's per-op profile")
  args = parser.parse_args(argv)
  result = evaluate(args.config, args.num_queries, args.device, args.seed,
                    args.batch_size, args.params_npz, profile=args.profile)
  if result['profile'] is not None:
    print(result['profile'])
  for i, (dt, dr) in enumerate(zip(result['position_error_m'],
                                   result['angle_error_deg'])):
    print(f'query {i}: position error {dt:.3f} m, angle error {dr:.3f} deg')
  summary = {k: v for k, v in result.items()
             if k not in ('last_pred', 'profile')}
  print(json.dumps(summary))


if __name__ == '__main__':
  main()
