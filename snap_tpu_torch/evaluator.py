"""Per-example evaluation over a dataset, with npz dumps.

The port of the dataset-reading core of ``snap_tpu/evaluator.py``:
``eval_on_dataset`` runs the localizer over the eval iterator and packs
per-example metrics (``pack_localization_metrics``), with the reference's
one-batch lag (batch k + 1 is dispatched before batch k's metrics are read
back); ``write_eval_dump`` / ``read_eval_dump`` store them as
``results.npz`` beside the config as JSON; ``compute_recall`` gives the
recall curve. The reference's three-level config merge, checkpoint restore,
dump cache and loop over cities are not ported.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import pathlib
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from snap_tpu_torch.data import loader
from snap_tpu_torch.utils import geometry

ResultDict = Dict[str, np.ndarray]


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
  batch, predictions and ``loss_metrics_function``'s metrics.
  """
  num_examples = dataset.meta_data['num_eval_examples']
  num_steps = -(-num_examples // batch_size)
  rows = []

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
    rows.extend({k: v[i] for k, v in metrics.items()}
                for i in np.flatnonzero(mask))

  pending = None
  for step in range(num_steps):
    batch = next(dataset.valid_iter)
    host = batch.pop('_host', {})
    with torch.inference_mode():
      with step_context(step):
        pred = model(batch, generator=generator)
      losses, metrics = model.loss_metrics_function(pred, batch)
      packed = pack_localization_metrics(metrics, losses, batch, pred)
    fetched, done = _fetch({**packed, 'batch_mask': batch['batch_mask']})
    if on_batch is not None:
      on_batch(step, batch, pred, metrics)
    if pending is not None:
      drain(*pending)
    pending = (fetched, host, done)
  if pending is not None:
    drain(*pending)
  return {k: np.stack([row[k] for row in rows]) for k in rows[0]}


def _plain(value):
  if dataclasses.is_dataclass(value):
    return {f.name: _plain(getattr(value, f.name))
            for f in dataclasses.fields(value)}
  if isinstance(value, dict):
    return {k: _plain(v) for k, v in value.items()}
  if isinstance(value, (list, tuple)):
    return [_plain(v) for v in value]
  return value


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
      json.dumps(_plain(config), indent=2, sort_keys=True) + '\n')


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
