"""Offline evaluation of an experiment over cities, with cached npz dumps.

The port of ``snap_tpu/evaluator.py``. ``run`` evaluates the cities of a
split one by one (``run_for_location``): the experiment's config
(``<workdir>/config.json``, the reference's keys, read by
``configs.from_reference``) merged with the eval config
(``configs.merge_eval_config``), its model (``config.model_name``), its
weights (the port's
``<workdir>/checkpoints/<step>/`` as ``train`` writes them, at the eval
config's ``checkpoint_step`` or the latest; else a JAX export's
``<workdir>/params.npz``: flax params keyed by '/'-joined paths, converted
by ``convert.params_from_flax``, with the step they were taken at in
``<workdir>/checkpoint.json``), the model run over the eval iterator
(``eval_on_dataset``, per-example metrics packed by ``pack_metrics``, with
the reference's one-batch lag: batch k + 1 is dispatched before batch k's
metrics are read back), and the
metrics dumped to ``<workdir>/evaluation/<location><tag>/results.npz``
beside the merged config as ``config.json`` (``write_eval_dump``), which a
later run of the same protocol reads back instead. The localizer's metrics
are packed by ``pack_localization_metrics``, the semantic head's by its
own ``pack_evaluation_metrics``; the occupancy head has no packing, as in
the reference (it is evaluated in the trainer's loop). ``compute_recall``
gives the recall curve.

Over the ranks of the mesh's data axis (``parallel/mesh.py``), each rank
evaluates its block of each eval batch (``snap_tpu/evaluator.py:108-120``,
``:183-192``), its padded rows masked as in one process; the per-example
rows are gathered in global example order, so every rank holds the
one-process results, and rank 0 alone writes the dump.
"""

from __future__ import annotations

import contextlib
import inspect
import io
import json
import logging
import pathlib
import time
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from snap_tpu_torch import configs
from snap_tpu_torch import convert
from snap_tpu_torch import models
from snap_tpu_torch.data import loader
from snap_tpu_torch.models import base
from snap_tpu_torch.models import bev_localizer
from snap_tpu_torch.models import semantic_net
from snap_tpu_torch.parallel import mesh
from snap_tpu_torch.train_lib import checkpoints
from snap_tpu_torch.utils import geometry

ResultDict = Dict[str, np.ndarray]
log = logging.getLogger(__name__)

CITIES_SPLITS = configs.DATA_SPLITS_CITIES
# An experiment's workdir: its config in the reference's keys, its weights
# as flat flax params, and the step they were taken at.
CONFIG_FILE = 'config.json'
PARAMS_FILE = 'params.npz'
CHECKPOINT_FILE = 'checkpoint.json'


def compute_dtype(dtype_str: str) -> torch.dtype:
  """The torch dtype of a config's ``dtype_str``; raises on one the port
  does not run."""
  if dtype_str not in configs.DTYPE_STRS:
    raise ValueError(f'dtype_str = {dtype_str!r}; the port runs '
                     f'{list(configs.DTYPE_STRS)}')
  return getattr(torch, dtype_str)


def build_model(config: configs.Config, device: str = 'cuda',
                seed: int = 0,
                params_npz: Optional[str] = None,
                state_dict: Optional[Dict[str, torch.Tensor]] = None
                ) -> base.Model:
  """The model of ``config`` (the registry's ``config.model_name``) with
  seeded weights, those of a flat ``.npz`` of flax params, or a
  ``state_dict`` (a port checkpoint's)."""
  model = models.get_model(config.model_name)(
      config.model, loader.scene_meta_data(config.data),
      compute_dtype(config.dtype_str))
  if params_npz is not None:
    with np.load(params_npz) as npz:
      state_dict = convert.params_from_flax(dict(npz), model)
  if state_dict is None:
    convert.init_params(model, seed, getattr(config.model,
                                             'init_temperature', 2.0))
  else:
    model.load_state_dict(state_dict)
  return model.to(device).eval()


def compute_distance_view_to_map(
    m_t_vq: geometry.Transform3D, m_t_vm: geometry.Transform3D
) -> Tuple[torch.Tensor, torch.Tensor]:
  """Angle (deg) and distance (m) from the query view to the closest map
  view (the closest by distance)."""
  dr, dt = (m_t_vq.inv @ m_t_vm).magnitude()
  dt_closest, closest = dt.min(-1)
  return dr.gather(-1, closest[..., None])[..., 0], dt_closest


def pack_localization_metrics(metrics: Dict[str, torch.Tensor],
                              losses: Dict[str, torch.Tensor],
                              data: Dict[str, Any],
                              pred: Dict[str, Any]) -> Dict[str, torch.Tensor]:
  """Per-example evaluation metrics of a batch."""
  t_q2m = data['T_query2map']
  m_t_vq = geometry.Transform3D(R=t_q2m.R[:, None], t=t_q2m.t[:, None]) @ (
      data['query']['T_view2scene'])
  dr_closest, dt_closest = compute_distance_view_to_map(
      geometry.Transform3D(R=m_t_vq.R[:, :1], t=m_t_vq.t[:, :1]),
      data['map']['T_view2scene'])
  return dict(
      error_max_meter=metrics['loc/err_max_position'],
      error_max_deg=metrics['loc/err_max_rotation'],
      recall_top1=metrics['loc/recall_top1'],
      pose_score_max=pred['scores_poses'][..., 1:].amax(-1),
      overlap=data['overlap'],
      time_delta_days=data['time_delta_days'],
      closest_map_view_meter=dt_closest,
      closest_map_view_deg=dr_closest,
      loss=losses['total'],
  )


def pack_metrics(model: base.Model, metrics: Dict[str, torch.Tensor],
                 losses: Dict[str, torch.Tensor], data: Dict[str, Any],
                 pred: Dict[str, Any]) -> Dict[str, torch.Tensor]:
  """An evaluation's per-example metrics of a batch, by model
  (``snap_tpu/evaluator.py:91-97``)."""
  if isinstance(model, bev_localizer.BEVLocalizer):
    return pack_localization_metrics(metrics, losses, data, pred)
  if isinstance(model, semantic_net.SemanticNet):
    return model.pack_evaluation_metrics(metrics, losses, data, pred)
  raise ValueError(f'No packing function for model {type(model).__name__}.')


def _fetch(tensors: Dict[str, torch.Tensor]):
  """Start copying ``tensors`` to the host; returns the copies and an event
  that marks them done (None on the CPU)."""
  first = next(iter(tensors.values()))
  if first.device.type != 'cuda':
    return tensors, None
  host = {}
  for key, t in tensors.items():
    host[key] = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host[key].copy_(t, non_blocking=True)
  done = torch.cuda.Event()
  done.record()
  return host, done


def eval_on_dataset(model, dataset: loader.Dataset, batch_size: int,
                    generator: Optional[torch.Generator] = None,
                    step_context: Callable[[int], Any] = (
                        lambda step: contextlib.nullcontext()),
                    on_batch: Optional[Callable[..., None]] = None
                    ) -> ResultDict:
  """Per-example metrics over the eval split, padded rows dropped.

  Each example's row also holds its host strings: ``vehicle_map``,
  ``vehicle_query`` and ``pair_id`` (pair modes). The copy of batch k's
  metrics to the host is queued right after its step and read after batch
  k + 1 has been dispatched. The forward of step k, and nothing else, runs
  inside ``step_context(k)`` (a caller's timer or profiler); the metrics
  follow it, and ``on_batch(k, batch, pred, metrics)`` then sees the
  batch, predictions and ``loss_metrics_function``'s metrics. Under a
  process group ``batch_size`` is the global one: each rank runs its block, draws
  (the RANSAC backend's pose samples) for the global batch and takes its
  rows, and the rows of every rank are gathered, batch by batch in rank
  order: the global example order.
  """
  num_examples = dataset.meta_data['num_eval_examples']
  num_steps = -(-num_examples // batch_size)
  rows = []
  kwargs = {}
  if mesh.active() and 'batch_rows' in inspect.signature(
      model.forward).parameters:
    kwargs['batch_rows'] = (mesh.block(batch_size).start, batch_size)

  def drain(metrics, host, done):
    if done is not None:
      done.synchronize()
    metrics = {k: v.numpy() for k, v in metrics.items()}
    mask = metrics.pop('batch_mask') > 0
    metrics['vehicle_map'] = host.get('map/vehicle_type',
                                      host.get('vehicle_type'))
    if 'pair_id' in host:
      metrics['vehicle_query'] = host['query/vehicle_type']
      metrics['pair_id'] = host['pair_id']
    rows.append([{k: v[i] for k, v in metrics.items()}
                 for i in np.flatnonzero(mask)])

  pending = None
  for step in range(num_steps):
    batch = next(dataset.valid_iter)
    host = batch.pop('_host', {})
    with torch.inference_mode():
      with step_context(step):
        pred = model(batch, generator=generator, **kwargs)
      losses, metrics = model.loss_metrics_function(pred, batch)
      packed = pack_metrics(model, metrics, losses, batch, pred)
    fetched, done = _fetch({**packed, 'batch_mask': batch['batch_mask']})
    if on_batch is not None:
      on_batch(step, batch, pred, metrics)
    if pending is not None:
      drain(*pending)
    pending = (fetched, host, done)
  if pending is not None:
    drain(*pending)
  ranks = mesh.all_gather_objects(rows)
  rows = [row for step in range(num_steps) for of_rank in ranks
          for row in of_rank[step]]
  return {k: np.stack([row[k] for row in rows]) for k in rows[0]}


def write_eval_dump(eval_dir: pathlib.Path, results: ResultDict,
                    config: Any) -> None:
  """``results.npz`` (no pickled objects: strings as ``<U`` arrays) and
  ``config.json`` (a dataclass config or a dict) in ``eval_dir``."""
  eval_dir = pathlib.Path(eval_dir)
  eval_dir.mkdir(parents=True, exist_ok=True)
  buf = io.BytesIO()
  np.savez(buf, **{k: np.asarray(v) for k, v in results.items()})
  (eval_dir / 'results.npz').write_bytes(buf.getvalue())
  (eval_dir / 'config.json').write_text(
      json.dumps(configs.plain(config), indent=2, sort_keys=True) + '\n')


def read_eval_dump(eval_dir: pathlib.Path) -> Tuple[ResultDict, Dict]:
  eval_dir = pathlib.Path(eval_dir)
  raw = (eval_dir / 'results.npz').read_bytes()
  results = dict(np.load(io.BytesIO(raw), allow_pickle=False))
  return results, json.loads((eval_dir / 'config.json').read_text())


def compute_recall(errors: np.ndarray,
                   max_error: float) -> Tuple[np.ndarray, np.ndarray]:
  """Cumulative recall over 100 thresholds in [0, max_error] (percent)."""
  thresholds = np.linspace(0, max_error, 100)
  recall = np.mean(errors < thresholds[:, None], axis=1)
  return thresholds, recall * 100


def read_checkpoint_step(workdir: pathlib.Path,
                         step: Optional[int] = None) -> Optional[int]:
  """The step of the weights an evaluation of ``workdir`` reads: its port
  checkpoint ``step`` (the latest when None; raises when it holds no such
  step), else the step of its ``checkpoint.json`` (None when it does not
  say)."""
  steps = checkpoints.all_steps(workdir)
  if steps:
    if step is not None and step not in steps:
      raise ValueError(f'{workdir} holds checkpoints {steps}, not step {step}')
    return steps[-1] if step is None else step
  path = pathlib.Path(workdir) / CHECKPOINT_FILE
  if not path.exists():
    return None
  return json.loads(path.read_text()).get('step')


def get_model_and_dataset(eval_config: configs.EvalConfig,
                          experiment: Mapping[str, Any],
                          workdir: pathlib.Path, location: str,
                          device: str = 'cuda'):
  """The model and dataset of one location, and the merged config as a
  reference dict with the step and the data path it records
  (``snap_tpu/evaluator.py:get_model_and_dataset``)."""
  config = configs.merge_eval_config(
      eval_config, configs.from_reference(experiment), location)
  step = read_checkpoint_step(workdir, eval_config.checkpoint_step)
  if eval_config.checkpoint_step not in (None, step):
    raise ValueError(f'{workdir} holds the weights of step {step}, not of '
                     f'step {eval_config.checkpoint_step}')
  if checkpoints.all_steps(workdir):
    model = build_model(
        config, device, state_dict=checkpoints.restore_params(workdir, step))
  else:
    model = build_model(config, device,
                        params_npz=pathlib.Path(workdir) / PARAMS_FILE)
  dataset = loader.get_dataset(config.data, config.batch_size, device=device)
  log.info('Loaded experiment %s at step %s.', workdir, step)
  record = configs.to_reference(config)
  if step is not None:
    # So that a cache hit can check that it holds the requested step.
    record['eval_checkpoint_step'] = int(step)
  record['data_generator_kind'] = dataset.meta_data['generator_kind']
  return model, dataset, record


def run_for_location(location: str, eval_config: configs.EvalConfig,
                     fail_if_missing: bool = False, device: str = 'cuda'
                     ) -> Tuple[ResultDict, Dict[str, Any]]:
  """Evaluate one location, or read the dump of an earlier run of the same
  protocol (``snap_tpu/evaluator.py:253-312``).

  The cache is keyed by location and tag. A dump there serves only if it
  holds the requested number of examples and, when a step is requested,
  was taken at that step (a dump that records no step never does). Else
  the run goes to ``<location><tag>-n<size>-s<step>`` and the first dump
  stays as it is; a dump there is read only when the step is pinned (the
  latest step moves). ``overwrite`` recomputes into the first path. The
  dump's ``config.json`` adds to the merged config the step
  (``eval_checkpoint_step``), the data path (``data_generator_kind``),
  the loop's wall time (``eval_seconds``), each batch's build ms and the
  TF32 settings it ran under.
  """
  workdir = pathlib.Path(eval_config.workdir)
  experiment = json.loads((workdir / CONFIG_FILE).read_text())
  eval_path = workdir / 'evaluation' / f'{location}{eval_config.tag}'
  if (eval_path / 'results.npz').exists() and not eval_config.overwrite:
    results, dump_config = read_eval_dump(eval_path)
    requested_size = eval_config.data.loader.evaluation_size
    dumped_size = len(next(iter(results.values())))
    size_ok = dumped_size == requested_size
    dumped_step = dump_config.get('eval_checkpoint_step')
    step_ok = (eval_config.checkpoint_step is None
               or dumped_step == eval_config.checkpoint_step)
    if size_ok and step_ok:
      log.info('Loading cached dump from %s.', eval_path)
      return results, dump_config
    qualified = (f'{location}{eval_config.tag}'
                 f'-n{requested_size}-s{eval_config.checkpoint_step}')
    log.warning(
        'Cached dump at %s does not match the requested protocol (%d '
        'examples dumped vs %s requested; checkpoint step %s vs %s): '
        'recomputing into %s (set overwrite to replace the dump).',
        eval_path, dumped_size, requested_size, dumped_step,
        eval_config.checkpoint_step, qualified)
    eval_path = workdir / 'evaluation' / qualified
    if (eval_path / 'results.npz').exists() and (
        eval_config.checkpoint_step is not None):
      log.info('Loading cached dump from %s.', eval_path)
      return read_eval_dump(eval_path)
  if fail_if_missing:
    raise ValueError(f'Missing dump for {workdir} at {eval_path}.')
  model, dataset, record = get_model_and_dataset(
      eval_config, experiment, workdir, location, device)
  builds = []
  with dataset:
    t0 = time.perf_counter()
    results = eval_on_dataset(
        model, dataset, eval_config.batch_size,
        torch.Generator().manual_seed(eval_config.rng_seed),
        on_batch=lambda *_: builds.append(dataset.valid_iter.last_build))
    record['eval_seconds'] = time.perf_counter() - t0
  record['cudnn_allow_tf32'] = torch.backends.cudnn.allow_tf32
  record['matmul_allow_tf32'] = torch.backends.cuda.matmul.allow_tf32
  record['build_ms'] = [build.wall_ms for build in builds]
  record['build_card_ms'] = [build.card_ms for build in builds]
  record['num_processes'] = mesh.world_size()
  if mesh.is_lead():
    write_eval_dump(eval_path, results, record)
    log.info('Evaluation results written to %s.', eval_path)
  mesh.barrier()
  return results, record


def run(eval_config: configs.EvalConfig, **kwargs
        ) -> Dict[str, Tuple[ResultDict, Dict[str, Any]]]:
  """Evaluate the cities of ``eval_config.data.split`` one after the other:
  a split's name, or cities joined by commas."""
  split = eval_config.data.split
  cities = CITIES_SPLITS.get(split, split.split(','))
  log.info('Running evaluation for cities %s.', cities)
  return {city: run_for_location(
      eval_config.data.name_pattern.format(city), eval_config, **kwargs)
          for city in cities}


def summarize_dump(results: ResultDict) -> Dict[str, Any]:
  """A dump's summary (``tools/run_supervisor.py:summarize_dump``): the
  number of examples, the median and mean errors in m and deg, the recall
  at 0.5, 1, 2 and 5 of each (errors <= the threshold) and the top-1
  recall; for the semantic head the mean of each ``semantics/`` metric."""
  out = {'num_examples': int(next(iter(results.values())).shape[0])}
  for key, unit in (('error_max_meter', 'm'), ('error_max_deg', 'deg')):
    if key in results:
      err = results[key]
      out[f'median_err_{unit}'] = float(np.median(err))
      out[f'mean_err_{unit}'] = float(np.mean(err))
      for t in (0.5, 1.0, 2.0, 5.0):
        out[f'recall_{t}{unit}'] = float(np.mean(err <= t))
  if 'recall_top1' in results:
    out['recall_top1'] = float(np.mean(results['recall_top1']))
  for key, value in sorted(results.items()):
    if key.startswith('semantics/'):
      out[key] = float(np.mean(value))
  return out
