"""The training loop of every model of the registry
(``snap_tpu/train_lib/trainer.py``): the localizer and the heads.

``train`` runs a run, or a chunk of one, from a fresh state or the
workdir's latest checkpoint: the warm start of ``pretrained_path`` modules
(``update_pretrained_variables``), a summary every ``log_summary_steps``, an
eval every ``log_eval_steps`` and a checkpoint every ``checkpoint_steps``
(each also at the stop step), and a trace of 5 steps after the (re)start.
``train_step`` runs the forward with ``train=True`` on a CPU generator
seeded from (seed, ``global_step``) (the reference folds the step into its
key), which draws the mapper's z jitter and modality dropout, the semantic
head's flips and, on the RANSAC backend, the pose samples (a head under
``stop_*_gradients`` runs its frozen part without autograd); takes the
mean loss over
``batch_mask``, backpropagates, clips and applies Adam. A step whose
gradients are not all finite keeps the parameters and the optimizer
state, while ``global_step`` still advances: the optimizer's count then
lags, as optax's does. fp16 (``dtype_str='float16'``) trains with a
dynamic loss scale (``train_lib/dynamic_scale.py``, flax's
``DynamicScale(minimum_scale=256.0)``): the loss is scaled before the
backward and the gradients unscaled in f32, the scale's step rule takes
whether they are all finite, the step logs ``loss_scale`` and the
checkpoints keep the scale; bf16 and f32 have none. Metrics are reduced to
``(sum, count)`` pairs, masked by ``batch_mask`` and finiteness. There is
no autocast, in any dtype: the modules cast to their compute dtype
themselves.

Over the ranks of the mesh's data axis (``parallel/mesh.py``), each rank
holds its block of the global batch and computes the step one process
computes on the global batch. The reference's loss is one masked mean over
the global batch (``snap_tpu/train_lib/trainer.py:200``,
``losses['total'].mean(where=batch['batch_mask'] > 0)``); here each rank's
loss is the sum of its masked example losses over the count of masked
examples of the whole batch (all-reduced), and the gradients are summed
over the ranks (one all-reduce of a flat f32 buffer after the backward),
so the sum is the gradient of that global mean whatever rows each rank's
``batch_mask`` keeps (an average over the ranks, DDP's default, would
weigh a rank's rows by its own count). The global norm, clipping, Adam,
the finiteness verdict and the loss scale then see the same gradients on
every rank, whose parameters stay equal. The training draws (z jitter,
modality dropout, flips, the RANSAC backend's pose samples) are drawn for
the global batch from the step's generator, and each rank takes its rows;
the metrics' (sum, count) pairs are summed over the ranks. Rank 0 alone
writes checkpoints, summaries, the progress note and the trace, and every
rank waits for each checkpoint and meets the others at the end.
"""

from __future__ import annotations

import contextlib
import dataclasses
import inspect
import json
import logging
import math
import pathlib
import time
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from snap_tpu_torch import configs
from snap_tpu_torch.data import loader
from snap_tpu_torch.models import base
from snap_tpu_torch.models import bev_mapper
from snap_tpu_torch.parallel import mesh
from snap_tpu_torch.train_lib import checkpoints
from snap_tpu_torch.train_lib import dynamic_scale as dynamic_scale_lib
from snap_tpu_torch.train_lib import optimizers
from snap_tpu_torch.utils import geometry

Tensor = torch.Tensor
AggregatedMetrics = Dict[str, Tuple[Tensor, Tensor]]
log = logging.getLogger(__name__)


@dataclasses.dataclass
class TrainState:
  model: base.Model
  opt_state: optimizers.AdamState
  global_step: int
  seed: int
  tx: Optional[optimizers.Adam] = None  # the transform of ``opt_state``
  # fp16 only: the dynamic loss scale; None in bf16 and f32.
  dynamic_scale: Optional[dynamic_scale_lib.DynamicScale] = None


class StepOutput(NamedTuple):
  metrics: AggregatedMetrics
  logs: Dict[str, float]
  grads: Dict[str, Tensor]  # by parameter name, before clipping
  draws: bev_mapper.TrainDraws  # the global batch's
  # The RANSAC backend's sampled poses [B, num_pose_samples], without the
  # GT pose (this rank's rows); None on the exhaustive backend.
  pose_samples: Optional[geometry.Transform2D] = None


def create_train_state(
    model: base.Model, optimizer: optimizers.Adam, seed: int,
    dynamic_scale: Optional[dynamic_scale_lib.DynamicScale] = None
) -> TrainState:
  params = [p for _, p in model.named_parameters()]
  return TrainState(model=model, opt_state=optimizer.init(params),
                    global_step=0, seed=seed, tx=optimizer,
                    dynamic_scale=dynamic_scale)


def fold_seed(seed: int, step: int, *salt: int) -> int:
  """A 63-bit generator seed from (seed, step[, salt])."""
  state = np.random.SeedSequence([seed, step, *salt]).generate_state(
      2, np.uint32)
  return (int(state[0]) << 31) ^ int(state[1])


# The salt of the eval stream's generators (``fold_seed(seed, i, EVAL)``).
EVAL = 1


def step_generator(state: TrainState) -> torch.Generator:
  return torch.Generator().manual_seed(fold_seed(state.seed,
                                                 state.global_step))


def reduce_metrics(metrics: Dict[str, Tensor], mask: Tensor
                   ) -> AggregatedMetrics:
  """Per-example metrics -> (sum, count), masked by ``mask`` & finiteness,
  summed over the ranks."""
  out = {}
  for key, value in metrics.items():
    value = value.detach().float()
    metric_mask = mask * torch.isfinite(value)
    out[key] = ((value * metric_mask).sum(), metric_mask.sum())
  if mesh.active():
    summed = iter(mesh.all_reduce_sum([t for pair in out.values()
                                       for t in pair]))
    out = {key: (next(summed), next(summed)) for key in out}
  return out


def summarize(accumulated: List[AggregatedMetrics]) -> Dict[str, float]:
  """(sum, count) pairs over steps -> means (host side)."""
  if not accumulated:
    return {}
  return {key: sum(float(m[key][0]) for m in accumulated)
          / max(sum(float(m[key][1]) for m in accumulated), 1.0)
          for key in accumulated[0]}


def loss_and_metrics(model: base.Model, batch: Dict[str, Any],
                     train: bool, generator=None, draws=None,
                     pose_samples=None, batch_rows=None):
  """(masked-mean loss, per-example losses, metrics, predictions).
  ``pose_samples`` goes to the localizer's RANSAC backend alone, and so
  does ``batch_rows`` (this rank's first row and the global batch size,
  whose rows its pose samples are drawn for). Under a process group the loss
  is this rank's share of the global batch's masked mean: its masked sum
  over the global count."""
  kwargs = {} if pose_samples is None else {'pose_samples': pose_samples}
  if batch_rows is not None:
    kwargs['batch_rows'] = batch_rows
  pred = model(batch, train=train, generator=generator, draws=draws,
               **kwargs)
  losses, metrics = model.loss_metrics_function(pred, batch)
  mask = batch['batch_mask'] > 0
  if not mesh.active():
    loss = losses['total'][mask].mean()
  else:
    count, = mesh.all_reduce_sum([mask.sum().float()])
    loss = losses['total'][mask].sum() / count
  return loss, losses, metrics, pred


def _rows_of_batch(batch: Dict[str, Any]):
  """This rank's rows of the global batch: (slice, global size), None
  without a process group."""
  if not mesh.active():
    return None
  world = mesh.world_size()
  local = batch['batch_mask'].shape[0]
  return mesh.block(local * world), local * world


def _draw_rows(model: base.Model):
  """Whether ``model``'s forward takes ``batch_rows`` (it draws per row)."""
  return 'batch_rows' in inspect.signature(model.forward).parameters


def local_draws(draws: bev_mapper.TrainDraws, rows: slice
                ) -> bev_mapper.TrainDraws:
  """A rank's rows of the global batch's draws (``modality_keep`` is
  ``[M, B]``; the others lead with the batch)."""
  take = lambda x, axis=0: None if x is None else x.narrow(
      axis, rows.start, rows.stop - rows.start)
  return bev_mapper.TrainDraws(z_jitter=take(draws.z_jitter),
                               modality_keep=take(draws.modality_keep, 1),
                               flips=take(draws.flips))


def apply_gradients(params: List[Tensor], grads: List[Tensor],
                    state: TrainState, optimizer: optimizers.Adam
                    ) -> Dict[str, float]:
  """Clip + Adam on ``params`` in place, unless a gradient is not finite
  (then params and optimizer state stay); advances ``global_step`` either
  way. Returns the step's logs."""
  updates, new_opt_state = optimizer.update(grads, state.opt_state, params)
  logs = {
      'l2_grads': optimizers.global_norm(grads),
      'l2_updates': optimizers.global_norm(updates),
      'learning_rate': optimizer.lr_fn(state.global_step),
  }
  is_finite = bool(torch.stack([torch.isfinite(g).all() for g in grads]
                               ).all())
  if is_finite:
    with torch.no_grad():
      for p, u in zip(params, updates):
        p.add_(u.to(p.dtype))
    state.opt_state = new_opt_state
  logs['is_finite'] = is_finite
  logs['l2_params'] = optimizers.global_norm([p.detach() for p in params])
  state.global_step += 1
  return {k: float(v) for k, v in logs.items()}


def train_step(state: TrainState, batch: Dict[str, Any],
               optimizer: optimizers.Adam,
               draws: Optional[bev_mapper.TrainDraws] = None,
               pose_samples: Optional[geometry.Transform2D] = None
               ) -> StepOutput:
  """One step: forward (train), backward, clip, Adam; updates ``state``.

  ``draws`` and ``pose_samples`` (the RANSAC backend's ``[B, P]`` sampled
  poses, without the GT) inject the forward's random draws, each the
  global batch's (a rank takes its rows); by default they come from the
  step's generator. With a dynamic loss scale (fp16)
  the backward takes the loss times the scale, the gradients are cast to
  f32 and divided by it, and the scale's step follows whether they are all
  finite (``DynamicScale.value_and_grad``): the same check that skips the
  update, on the same gradients (the reference folds the two, which agree).
  ``loss_scale`` logs the new scale.
  """
  model = state.model
  names = [n for n, _ in model.named_parameters()]
  params = [p for _, p in model.named_parameters()]
  generator = step_generator(state)
  rows = _rows_of_batch(batch)
  local, batch_rows = draws, None
  if rows is not None:
    if draws is None:
      draws = model.sample_draws(rows[1], generator,
                                 batch['batch_mask'].device)
    local = local_draws(draws, rows[0])
    if pose_samples is not None:
      pose_samples = pose_samples[rows[0]]
    if _draw_rows(model):
      batch_rows = (rows[0].start, rows[1])
  loss, losses, metrics, pred = loss_and_metrics(
      model, batch, True, generator, local, pose_samples, batch_rows)
  scale = state.dynamic_scale
  grads = torch.autograd.grad(loss if scale is None else loss * scale.scale,
                              params, allow_unused=True)
  grads = [torch.zeros_like(p) if g is None else g
           for g, p in zip(grads, params)]
  grads = mesh.all_reduce_sum(grads)
  if scale is not None:
    grads = [g.float() / scale.scale for g in grads]
  logs = apply_gradients(params, grads, state, optimizer)
  if scale is not None:
    state.dynamic_scale = scale.update(logs['is_finite'] == 1.0)
    logs['loss_scale'] = state.dynamic_scale.scale
  for key, value in losses.items():
    metrics[f'loss/{key}'] = value
  samples = pred.get('map_t_query_samples')
  return StepOutput(
      metrics=reduce_metrics(metrics, batch['batch_mask']), logs=logs,
      grads=dict(zip(names, grads)),
      draws=pred['draws'] if rows is None else draws,
      pose_samples=None if samples is None else samples[:, 1:])


def eval_step(model: base.Model, batch: Dict[str, Any],
              generator: torch.Generator) -> AggregatedMetrics:
  """The forward at ``train=False`` and its metrics and losses
  (``loss/<name>``) as (sum, count) pairs (``trainer.py:eval_step``),
  summed over the ranks."""
  rows = _rows_of_batch(batch)
  batch_rows = (rows[0].start, rows[1]) if rows and _draw_rows(model) else (
      None)
  with torch.no_grad():
    _, losses, metrics, _ = loss_and_metrics(model, batch, False, generator,
                                             batch_rows=batch_rows)
  for key, value in losses.items():
    metrics[f'loss/{key}'] = value
  return reduce_metrics(metrics, batch['batch_mask'])


def eval_generator(seed: int, i: int) -> torch.Generator:
  """The generator of the loop's ``i``-th eval batch (the reference folds
  ``i`` into its eval key)."""
  return torch.Generator().manual_seed(fold_seed(seed, i, EVAL))


class Chrono:
  """Walltime with pauses around the work that is not a step
  (``trainer.py:Chrono``): steps/s over this run's active time."""

  def __init__(self, first_step: int = 0):
    self._start = time.monotonic()
    self._paused_at: Optional[float] = None
    self._paused_total = 0.0
    self.first_step = first_step

  def pause(self) -> None:
    if self._paused_at is None:
      self._paused_at = time.monotonic()

  def resume(self) -> None:
    if self._paused_at is not None:
      self._paused_total += time.monotonic() - self._paused_at
      self._paused_at = None

  def active_walltime(self) -> float:
    return time.monotonic() - self._start - self._paused_total

  def tick(self, steps: int) -> float:
    """Steps/s of active time in this run."""
    return (steps - self.first_step) / max(self.active_walltime(), 1e-9)

  def exclude_elapsed(self, step: int) -> None:
    """Drop the active time so far (the first step's warm-up) and count
    rates from ``step``."""
    self._paused_total += self.active_walltime()
    self.first_step = step


# The step logs a summary averages (over the window's finite steps).
LOG_MEAN_KEYS = ('l2_grads', 'l2_updates', 'l2_params', 'learning_rate')


class Window:
  """A summary window (``trainer.py:_accumulate``, ``:676-685``): the
  metrics' (sum, count) pairs added on the device; the logs averaged over
  the window's finite steps (a skipped step's NaN norms do not count); NaN
  for a log when every step of the window was skipped."""

  def __init__(self):
    self.metrics: Optional[AggregatedMetrics] = None
    self.logs: Dict[str, float] = {}
    self.n_finite = 0.0

  def add(self, metrics: AggregatedMetrics, logs: Dict[str, float]) -> None:
    if self.metrics is None:
      self.metrics = {k: (s.detach().clone(), c.detach().clone())
                      for k, (s, c) in metrics.items()}
      self.logs = {k: 0.0 for k in LOG_MEAN_KEYS if k in logs}
    else:
      for key, (s, c) in metrics.items():
        self.metrics[key][0].add_(s)
        self.metrics[key][1].add_(c)
    if logs.get('is_finite', True):
      for key in self.logs:
        self.logs[key] += logs[key]
      self.n_finite += 1

  def summary(self) -> Dict[str, float]:
    out = {k: float(s) / max(float(c), 1.0)
           for k, (s, c) in (self.metrics or {}).items()}
    for key, value in self.logs.items():
      out[key] = value / self.n_finite if self.n_finite else math.nan
    return out


def resolve_stop_step(config: configs.TrainConfig,
                      stop_at_step: Optional[int] = None) -> int:
  """The last step of this run: ``stop_at_step`` (else the config's),
  capped at ``num_training_steps``; the schedule stays sized by the
  latter (``trainer.py:_resolve_stop_step``)."""
  total = int(config.num_training_steps)
  return min(total, int(stop_at_step or config.stop_at_step or total))


def gather_pretrained(module: torch.nn.Module, prefix: str = ''
                      ) -> Dict[str, Tensor]:
  """The tensors that modules' ``load_pretrained_variables`` hooks give,
  named from the model's root; a module whose hook gives some is not
  searched further (``trainer.py:_gather_variables_recursive``)."""
  hook = getattr(module, 'load_pretrained_variables', None)
  if hook is not None:
    got = hook()
    if got is not None:
      return {prefix + name: value for name, value in got.items()}
  out = {}
  for name, child in module.named_children():
    out.update(gather_pretrained(child, f'{prefix}{name}.'))
  return out


def update_pretrained_variables(model: torch.nn.Module) -> int:
  """Overwrite the model's weights with the pretrained ones its modules
  give (``trainer.py:update_pretrained_variables``); logs those left
  unused and raises when every one is. Returns how many were copied."""
  pretrained = gather_pretrained(model)
  if not pretrained:
    return 0
  live = model.state_dict()
  unused = sorted(set(pretrained) - set(live))
  update = sorted(set(pretrained) & set(live))
  if unused:
    log.info('The following pretrained variables will not be used:\n%s',
             '\n'.join(unused))
    if not update:
      raise ValueError(
          'Could not load any pre-trained weight, all were left unused.')
  log.info('Updating %d variable(s) from pretrained weights.', len(update))
  with torch.no_grad():
    for name in update:
      if live[name].shape != pretrained[name].shape:
        raise ValueError(f'pretrained {name}: shape '
                         f'{tuple(pretrained[name].shape)}, the model\'s '
                         f'{tuple(live[name].shape)}')
      live[name].copy_(pretrained[name])
  return len(update)


# The trace: ``NUM_TRACE_STEPS`` steps from the (re)start's 4th on, each
# step (its synchronize included) a ``STEP_SPAN`` span.
TRACE_AFTER, NUM_TRACE_STEPS = 3, 5
STEP_SPAN = 'train_step'
_DEVICE_EVENTS = ('kernel', 'gpu_memcpy', 'gpu_memset')


def _trace_intervals(path: pathlib.Path):
  """The chrome trace's ``train_step`` spans and device events, as sorted
  (start, stop) pairs in microseconds."""
  events = json.loads(pathlib.Path(path).read_text()).get('traceEvents', [])
  steps = sorted((e['ts'], e['ts'] + e['dur']) for e in events
                 if e.get('name') == STEP_SPAN
                 and e.get('cat') == 'user_annotation')
  spans = sorted((e['ts'], e['ts'] + e.get('dur', 0)) for e in events
                 if e.get('cat') in _DEVICE_EVENTS and 'ts' in e)
  return steps, spans


def step_device_ms(path: pathlib.Path) -> List[float]:
  """Per ``train_step`` span of the chrome trace, in order, the ms in it
  when a kernel, copy or memset ran on the device (the union of their
  intervals)."""
  steps, spans = _trace_intervals(path)
  out = []
  for step_start, step_stop in steps:
    busy, end = 0.0, step_start
    for start, stop in spans:
      start, stop = max(start, end), min(stop, step_stop)
      if stop > start:
        busy, end = busy + stop - start, stop
    out.append(busy / 1e3)
  return out


def trace_split(path: pathlib.Path, wall_ms: float) -> Dict[str, Any]:
  """The traced steps' split in the chrome trace: the wall time of the
  ``train_step`` spans (each ends in a device synchronize), and the time
  inside them when a device event ran (``step_device_ms``, summed). The
  window's other work (summaries, evals, checkpoints) counts in
  ``wall_ms`` alone."""
  steps, spans = _trace_intervals(path)
  steps_ms = sum(b - a for a, b in steps) / 1e3
  device_ms = sum(step_device_ms(path)) if spans else None
  return {'wall_ms': wall_ms, 'steps_ms': steps_ms,
          'device_busy_ms': device_ms,
          'idle_share': (None if device_ms is None or not steps_ms
                         else 1 - device_ms / steps_ms),
          'device_events': len(spans)}


def _sync(device: torch.device) -> None:
  if device.type == 'cuda':
    torch.cuda.synchronize(device)


def train(config: configs.Config, model: base.Model,
          dataset: loader.Dataset, workdir: pathlib.Path, seed: int = 0,
          stop_at_step: Optional[int] = None,
          num_steps: Optional[int] = None,
          on_step: Optional[Callable[[int, StepOutput], None]] = None,
          profile: bool = False) -> Dict[str, Any]:
  """Train from the latest checkpoint in ``workdir`` (when
  ``config.train.checkpoint``), else from ``model``'s weights with the
  pretrained modules' warm start, up to ``resolve_stop_step`` (and at most
  ``num_steps`` steps in this call). ``dataset``'s train iterator must
  start at the step the run resumes from.

  ``on_step(step, out)`` sees each step's output, ``step`` counted from 0
  (the global step before the update). With ``profile`` the last step runs
  under ``torch.profiler`` and ``profile`` holds its per-op table. Returns
  the state, the last summary and eval, every summary and eval by step,
  the checkpoints written, the steps' and the batches' times, and the
  trace's path and split.
  """
  tc = config.train
  device = next(model.parameters()).device
  workdir = pathlib.Path(workdir)
  workdir.mkdir(parents=True, exist_ok=True)
  optimizer = optimizers.get_optimizer(tc, model)
  state = create_train_state(model, optimizer, seed,
                             dynamic_scale_lib.for_dtype(config.dtype_str))
  restore_seconds = None
  ckpt_step = checkpoints.latest_step(workdir) if tc.checkpoint else None
  if ckpt_step is not None:
    t0 = time.perf_counter()
    checkpoints.restore_checkpoint(workdir, state, ckpt_step)
    _sync(device)
    restore_seconds = time.perf_counter() - t0
    log.info('Restored checkpoint at step %d from %s in %.2f s.', ckpt_step,
             workdir, restore_seconds)
  else:
    update_pretrained_variables(model)
  start_step = state.global_step
  stop_step = resolve_stop_step(tc, stop_at_step)
  if num_steps is not None:
    stop_step = min(stop_step, start_step + num_steps)
  log_eval_steps = tc.log_eval_steps or 1000
  checkpoint_steps = tc.checkpoint_steps or log_eval_steps
  log_summary_steps = tc.log_summary_steps or log_eval_steps
  eval_batch_size = tc.eval_batch_size or config.batch_size
  steps_per_eval = tc.steps_per_eval or -(
      -dataset.meta_data['num_eval_examples'] // eval_batch_size)
  trace_first = start_step + TRACE_AFTER + 1
  trace_last = trace_first + NUM_TRACE_STEPS - 1
  lead = mesh.is_lead()
  if not tc.xprof or trace_last > stop_step - int(profile) or not lead:
    trace_first = trace_last = -1
  activities = [torch.profiler.ProfilerActivity.CPU]
  if device.type == 'cuda':
    activities.append(torch.profiler.ProfilerActivity.CUDA)

  chrono = Chrono(first_step=start_step)
  window = Window()
  result = {'start_step': start_step, 'stop_step': stop_step,
            'restore_seconds': restore_seconds, 'logs': [],
            'step_seconds': [], 'wall_seconds': [], 'builds': [],
            'summaries': {}, 'evals': {}, 'checkpoints': {}, 'trace': None,
            'profile': None, 'train_summary': {}, 'eval_summary': {}}
  tracer = prof = None
  log.info('Starting training loop at step %d.', start_step + 1)
  for step in range(start_step + 1, stop_step + 1):
    if step == trace_first:
      _sync(device)
      tracer = torch.profiler.profile(activities=activities)
      tracer.start()
      t_trace = time.perf_counter()
    t_batch = time.perf_counter()
    batch = next(dataset.train_iter)
    batch.pop('_host', None)
    result['builds'].append(dataset.train_iter.last_build)
    with contextlib.ExitStack() as stack:
      if profile and step == stop_step:
        prof = stack.enter_context(torch.profiler.profile(
            activities=activities))
      t0 = time.perf_counter()
      with torch.profiler.record_function(STEP_SPAN):
        out = train_step(state, batch, optimizer)
        _sync(device)
      result['step_seconds'].append(time.perf_counter() - t0)
      result['wall_seconds'].append(time.perf_counter() - t_batch)
    result['logs'].append(out.logs)
    window.add(out.metrics, out.logs)
    if on_step is not None:
      on_step(step - 1, out)
    del out, batch
    if step == start_step + 1:
      if lead:
        log.info('First step done: %.1f s elapsed.', chrono.active_walltime())
      chrono.exclude_elapsed(step)
    if step == trace_last:
      _sync(device)
      wall_ms = 1e3 * (time.perf_counter() - t_trace)
      tracer.stop()
      path = workdir / f'trace-steps-{trace_first}-{trace_last}.json'
      tracer.export_chrome_trace(str(path))
      tracer = None
      result['trace'] = {'path': str(path), 'steps': [trace_first,
                                                      trace_last],
                         **trace_split(path, wall_ms)}
      log.info('Trace of steps %d-%d: %s', trace_first, trace_last,
               result['trace'])

    if step % log_summary_steps == 0 or step == stop_step:
      chrono.pause()
      steps_per_sec = chrono.tick(step)
      summary = window.summary()
      summary['steps_per_sec'] = steps_per_sec
      window = Window()
      result['summaries'][step] = result['train_summary'] = summary
      total = tc.num_training_steps
      eta = (total - step) / max(steps_per_sec, 1e-9)
      if lead:
        log.info('[%d] %s', step, summary)
        log.info('Progress: %.1f%% (step %d/%d), %.2f steps/s, ETA %dm.',
                 100 * step / total, step, total, steps_per_sec, eta / 60)
        try:
          (workdir / 'progress.json').write_text(json.dumps(dict(
              step=step, total_steps=total,
              percent=round(100 * step / total, 2),
              steps_per_sec=round(steps_per_sec, 4),
              eta_seconds=round(eta, 1))))
        except OSError as e:
          log.warning('Could not write progress note: %s', e)
      chrono.resume()

    if step % log_eval_steps == 0 or step == stop_step:
      chrono.pause()
      accumulated = []
      for i in range(steps_per_eval):
        eval_batch = next(dataset.valid_iter)
        eval_batch.pop('_host', None)
        accumulated.append(eval_step(model, eval_batch,
                                     eval_generator(state.seed, i)))
      result['evals'][step] = result['eval_summary'] = summarize(accumulated)
      if lead:
        log.info('[%d eval] %s', step, result['eval_summary'])
      chrono.resume()

    if tc.checkpoint and (step % checkpoint_steps == 0 or step == stop_step):
      chrono.pause()
      t0 = time.perf_counter()
      nbytes = None
      if lead:
        nbytes = checkpoints.save_checkpoint(
            workdir, state, step, max_to_keep=tc.max_checkpoints_to_keep)
      mesh.barrier()  # the others resume from it only once it is written
      result['checkpoints'][step] = {
          'seconds': time.perf_counter() - t0, 'bytes': nbytes}
      chrono.resume()
  if tracer is not None:
    tracer.stop()
  mesh.barrier()  # every rank meets the others at the end
  if prof is not None:
    result['profile'] = prof.key_averages().table(
        sort_by='cuda_time_total' if device.type == 'cuda'
        else 'cpu_time_total', row_limit=40)
  result['state'] = state
  return result
