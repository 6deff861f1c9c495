"""Localize synthetic queries with the port's localizer, or evaluate an
experiment over held-out cities.

    python -m snap_tpu_torch.evaluate --eval_config=eval_localization \
        --evaluation_size=256 --batch_size=4 \
        --workdir=weights/loc_full1chip_r5 --split=zurich,oslo
    python -m snap_tpu_torch.evaluate --eval_config=smoke_eval_localization \
        --workdir=<experiment> --split=smokeville --device=cpu
    python -m snap_tpu_torch.evaluate \
        --eval_config=eval_localization:evaluation_size=256,batch_size=8 \
        --workdir=workdirs/run_small --split=zurich
    python -m snap_tpu_torch.evaluate --eval_config=eval_semantics \
        --evaluation_size=64 --workdir=<semantic head experiment>
    python -m snap_tpu_torch.evaluate --config=bench_full --num_queries=4
    python -m snap_tpu_torch.evaluate --config=eval_full1chip_ransac \\
        --num_queries=8 --batch_size=4
    python -m snap_tpu_torch.evaluate --config=smoke_eval_ransac \\
        --num_queries=2 --batch_size=2 --device=cpu

Builds the localizer of the named config (exhaustive or RANSAC backend),
reads the first ``num_queries`` synthetic map/query pairs of the config's
eval split (seeded as the JAX loader seeds it) from the dataset's eval
iterator, localizes them in batches (``evaluator.eval_on_dataset``), and
prints each query's position and angle error, then one JSON line: the
recall at 1 m, the top-1 recall and, for the RANSAC backend, the share of
pose samples near the GT, the data path (``generator_kind``:
``device-torch`` when the card makes the batches, ``host-numpy`` when
numpy does), each batch's forward and build times and the whole loop's
wall time. The batches are made on the card when ``--device`` is a CUDA
card, unless ``--on_device_generation=false``;
``--on_device_generation=true --device=cpu`` runs the device generator on
the CPU. With ``--workdir`` the per-example metrics land in
``<workdir>/evaluation/<location><tag>/results.npz``. Weights are drawn
from ``--seed``, or read from ``--params_npz``: a flat ``.npz`` of the JAX
model's params keyed by '/'-joined flax paths; the RANSAC backend's pose
samples are drawn on a CPU ``torch.Generator`` seeded from ``--seed``. The
default device is ``cuda``; there is no fallback to the CPU when no card
is found.

With ``--eval_config`` (the reference's mode, ``snap_tpu/evaluate.py``)
the experiment in ``--workdir`` (its ``config.json`` in the reference's
keys, ``params.npz`` and ``checkpoint.json``; ``tests/test_torch_recall.py
--export`` writes one from a JAX export) is evaluated under the named eval
config (its arguments after a colon, as the reference's ``--config``
takes them) on each city of ``--split`` (``evaluator.run``), at the
experiment's scene scale and trunk (a ``train_localization:scale=small``
run's 10 views of 90x120 at 0.4 m, an R152x2 run's trunk): the dump of each
lands in ``<workdir>/evaluation/<location><tag>/``, or an earlier dump of
the same protocol is read back (``--eval_config=eval_semantics`` evaluates
a semantic head's experiment on 'val-synthetic'). One JSON line per city
gives the dump's summary (``evaluator.summarize_dump``), its data path, step, wall time,
build ms and TF32 settings. An f32 eval config runs with TF32 off in
cuDNN and in matmuls.

Under ``torchrun`` (``parallel/mesh.py``) each process evaluates its block
of every global batch (``--batch_size`` must divide over the ranks); the
per-example metrics are gathered in example order on every rank, and rank
0 alone writes the dumps and prints:

    torchrun --nproc_per_node=2 -m snap_tpu_torch.evaluate \\
        --eval_config=eval_localization --batch_size=4 --workdir=<experiment>
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import logging
import pathlib
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from snap_tpu_torch import configs
from snap_tpu_torch import evaluator
from snap_tpu_torch.evaluator import build_model
from snap_tpu_torch.data import loader
from snap_tpu_torch.models import bev_localizer
from snap_tpu_torch.parallel import mesh

def on_device_flag(value: str) -> Optional[bool]:
  """The CLIs' ``--on_device_generation`` value as the config's field."""
  return {'auto': None, 'true': True, 'false': False}[value]


def evaluate(config_name: str = 'bench_full', num_queries: int = 4,
             device: str = 'cuda', seed: int = 0, batch_size: int = 1,
             params_npz: Optional[str] = None,
             model: Optional[bev_localizer.BEVLocalizer] = None,
             profile: bool = False,
             on_batch: Optional[Callable[[int, Dict[str, Any]], None]] = None,
             on_device_generation: Optional[bool] = None,
             workdir: Optional[str] = None,
             tag: str = '') -> Dict[str, Any]:
  """Localize the first ``num_queries`` queries of the eval split.

  The queries are the eval iterator's (``loader.get_dataset`` with
  ``evaluation_size = num_queries``), made on the card or on the host as
  ``on_device_generation`` says (None: on the card iff ``device`` is
  CUDA). The result holds the packed per-example metrics
  (``evaluator.pack_localization_metrics``) under ``results``, per-query
  ``position_error_m`` / ``angle_error_deg``, ``recall_1m``, the means of
  the top-1 recall and, RANSAC only, of the sample recalls, each batch's
  forward time (``forward_ms``: on a CUDA card the card's, between two
  events recorded around the forward on its stream, with no synchronize
  in the loop; on the CPU the wall time), the wall time of the whole loop
  from the first batch's build to the last batch's metrics on the host
  (``eval_seconds``), each batch's build time (``build_ms``: the host's ms
  in the build; ``build_card_ms``: the card's ms from CUDA events, None
  off the card), ``generator_kind`` and the last batch's predictions
  under ``last_pred``.
  ``on_batch(i, pred)`` sees each batch's predictions. With ``profile``,
  the last batch's forward runs under ``torch.profiler`` and ``profile``
  holds its per-op table, sorted by device time. With ``workdir``, the
  per-example metrics are written to
  ``<workdir>/evaluation/<location><tag>/results.npz``, the config beside
  them as ``config.json``.
  """
  config = configs.get_config(config_name, batch_size=batch_size)
  data = dataclasses.replace(config.data, evaluation_size=num_queries,
                             on_device_generation=on_device_generation)
  if model is None:
    model = build_model(config, device, seed, params_npz)
  pose_generator = torch.Generator().manual_seed(seed)
  cuda = torch.device(device).type == 'cuda'
  num_batches = -(-num_queries // batch_size)
  forwards, builds, sample_recalls = [], [], []
  last = {}

  @contextlib.contextmanager
  def step_context(step: int):
    with contextlib.ExitStack() as stack:
      if profile and step == num_batches - 1:
        last['prof'] = stack.enter_context(torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA]))
      if cuda:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        yield
        end.record()
        forwards.append((start, end))
      else:
        t0 = time.perf_counter()
        yield
        forwards.append(1e3 * (time.perf_counter() - t0))

  with loader.get_dataset(data, batch_size, device=device) as dataset:

    def record(step: int, batch, pred, metrics) -> None:
      builds.append(dataset.valid_iter.last_build)
      sample_recalls.append((batch['batch_mask'], {
          key.split('/')[1]: value for key, value in metrics.items()
          if key.startswith('loc/recall_samples')}))
      last['pred'] = pred
      if on_batch is not None:
        on_batch(step, pred)

    t0 = time.perf_counter()
    results = evaluator.eval_on_dataset(model, dataset, batch_size,
                                        pose_generator, step_context, record)
    eval_seconds = time.perf_counter() - t0
  if cuda:
    forwards = [start.elapsed_time(end) for start, end in forwards]
  recalls: Dict[str, list] = {}
  for mask, values in sample_recalls:
    for key, value in values.items():
      recalls.setdefault(key, []).extend(
          value[mask > 0].float().cpu().tolist())
  if mesh.active():  # every rank's examples
    gathered = mesh.all_gather_objects(recalls)
    recalls = {key: [v for of_rank in gathered for v in of_rank[key]]
               for key in recalls}
  kind = dataset.meta_data['generator_kind']
  dump = None
  if workdir is not None:
    location = data.locations.evaluation or data.locations.training
    dump = pathlib.Path(workdir) / 'evaluation' / f'{location}{tag}'
    if mesh.is_lead():
      evaluator.write_eval_dump(dump, results, {
          'config_name': config_name, 'config': config, 'data': data,
          'seed': seed, 'params_npz': params_npz,
          'data_generator_kind': kind})
    mesh.barrier()
  pos = results['error_max_meter']
  table = None
  if profile:
    table = last['prof'].key_averages().table(
        sort_by='cuda_time_total' if cuda else 'cpu_time_total',
        row_limit=30)
  return {
      'config': config_name,
      'device': str(device),
      'num_queries': num_queries,
      'generator_kind': kind,
      'position_error_m': pos.tolist(),
      'angle_error_deg': results['error_max_deg'].tolist(),
      'recall_1m': float((pos < 1.0).mean()),
      'recall_top1': float(results['recall_top1'].mean()),
      **{k: float(np.mean(v)) for k, v in recalls.items()},
      'forward_ms': forwards,
      'eval_seconds': eval_seconds,
      'build_ms': [build.wall_ms for build in builds],
      'build_card_ms': [build.card_ms for build in builds],
      'dump': None if dump is None else str(dump),
      'results': results,
      'last_pred': last['pred'],
      'profile': table,
  }


def eval_config_from_args(args) -> configs.EvalConfig:
  """The named eval config (its arguments after a colon, as in
  ``eval_localization:evaluation_size=256,batch_size=8``) with the CLI's
  overrides."""
  name, kwargs = configs.parse_config_name(args.eval_config)
  if name not in configs.EVAL_CONFIGS:
    raise ValueError(f'Unknown eval config {name!r}; choose from '
                     f'{sorted(configs.EVAL_CONFIGS)}')
  eval_config = configs.EVAL_CONFIGS[name](**kwargs)
  loader_config = dataclasses.replace(
      eval_config.data.loader,
      on_device_generation=on_device_flag(args.on_device_generation))
  if args.evaluation_size is not None:
    loader_config = dataclasses.replace(
        loader_config, evaluation_size=args.evaluation_size)
  data = dataclasses.replace(eval_config.data, loader=loader_config,
                             split=args.split or eval_config.data.split)
  return dataclasses.replace(
      eval_config, workdir=args.workdir, data=data,
      checkpoint_step=args.checkpoint_step,
      batch_size=args.batch_size or eval_config.batch_size,
      tag=args.tag, overwrite=args.overwrite)


def city_summary(city: str, results, record) -> Dict[str, Any]:
  """One city's JSON line: the dump's summary and what its run recorded."""
  return {'city': city, **evaluator.summarize_dump(results),
          'generator_kind': record.get('data_generator_kind'),
          **{key: record.get(key) for key in (
              'eval_checkpoint_step', 'eval_seconds', 'build_ms',
              'build_card_ms', 'cudnn_allow_tf32', 'matmul_allow_tf32')}}


def main(argv=None) -> None:
  parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  parser.add_argument('--config', default=None,
                      help='localize queries of this config of '
                      'snap_tpu_torch.configs.CONFIGS, with its arguments '
                      'after a colon (default bench_full)')
  parser.add_argument('--eval_config', default=None,
                      help='evaluate the experiment in --workdir under this '
                      'config of snap_tpu_torch.configs.EVAL_CONFIGS, with '
                      'its arguments after a colon')
  parser.add_argument('--num_queries', type=int, default=4)
  parser.add_argument('--batch_size', type=int, default=None,
                      help='default 1, or the eval config\'s')
  parser.add_argument('--device', default='cuda')
  parser.add_argument('--seed', type=int, default=0)
  parser.add_argument('--params_npz', default=None)
  parser.add_argument('--on_device_generation', default='auto',
                      choices=('auto', 'true', 'false'),
                      help='make the queries on the device (auto: iff it '
                      'is a CUDA card)')
  parser.add_argument('--workdir', default=None,
                      help='with --config: write <workdir>/evaluation/'
                      '<location><tag>/results.npz; with --eval_config: '
                      'the experiment')
  parser.add_argument('--tag', default='')
  parser.add_argument('--split', default=None,
                      help="a split's name ('test', 'train') or cities "
                      'joined by commas')
  parser.add_argument('--checkpoint_step', type=int, default=None)
  parser.add_argument('--evaluation_size', type=int, default=None)
  parser.add_argument('--overwrite', action='store_true')
  parser.add_argument('--profile', action='store_true',
                      help="print the last batch's per-op profile")
  args = parser.parse_args(argv)
  process = mesh.init(args.device)
  try:
    _main(parser, args, str(process.device), process.rank == 0)
  finally:
    mesh.shutdown()


def _main(parser, args, device: str, lead: bool) -> None:
  if args.eval_config is not None:
    if args.config is not None or args.workdir is None:
      parser.error('--eval_config takes --workdir and no --config')
    eval_config = eval_config_from_args(args)
    if eval_config.dtype_str == 'float32':
      torch.backends.cuda.matmul.allow_tf32 = False
      torch.backends.cudnn.allow_tf32 = False
    logging.basicConfig(level=logging.INFO)
    for city, (results, record) in evaluator.run(
        eval_config, device=device).items():
      if lead:
        print(json.dumps(city_summary(city, results, record)), flush=True)
    return
  result = evaluate(args.config or 'bench_full', args.num_queries,
                    device, args.seed, args.batch_size or 1,
                    args.params_npz, profile=args.profile,
                    on_device_generation=on_device_flag(
                        args.on_device_generation),
                    workdir=args.workdir, tag=args.tag)
  if not lead:
    return
  if result['profile'] is not None:
    print(result['profile'])
  for i, (dt, dr) in enumerate(zip(result['position_error_m'],
                                   result['angle_error_deg'])):
    print(f'query {i}: position error {dt:.3f} m, angle error {dr:.3f} deg')
  summary = {k: v for k, v in result.items()
             if k not in ('results', 'last_pred', 'profile')}
  print(json.dumps(summary))


if __name__ == '__main__':
  main()
