"""One training step of the localizer (``snap_tpu/train_lib/trainer.py``).

``train_step`` runs the forward with ``train=True`` on a CPU generator
seeded from (seed, ``global_step``) (the reference folds the step into its
key), which draws the mapper's z jitter and modality dropout and, on the
RANSAC backend, the pose samples; takes the mean loss over
``batch_mask``, backpropagates, clips and applies Adam. A step whose
gradients are not all finite keeps the parameters and the optimizer
state, while ``global_step`` still advances: the optimizer's count then
lags, as optax's does. Metrics are reduced to
``(sum, count)`` pairs, masked by ``batch_mask`` and finiteness. There is
no autocast: the modules cast to their compute dtype themselves.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from snap_tpu_torch.models import bev_localizer
from snap_tpu_torch.models import bev_mapper
from snap_tpu_torch.train_lib import optimizers
from snap_tpu_torch.utils import geometry

Tensor = torch.Tensor
AggregatedMetrics = Dict[str, Tuple[Tensor, Tensor]]


@dataclasses.dataclass
class TrainState:
  model: bev_localizer.BEVLocalizer
  opt_state: optimizers.AdamState
  global_step: int
  seed: int


class StepOutput(NamedTuple):
  metrics: AggregatedMetrics
  logs: Dict[str, float]
  grads: Dict[str, Tensor]  # by parameter name, before clipping
  draws: bev_mapper.TrainDraws
  # The RANSAC backend's sampled poses [B, num_pose_samples], without the
  # GT pose; None on the exhaustive backend.
  pose_samples: Optional[geometry.Transform2D] = None


def create_train_state(model: bev_localizer.BEVLocalizer,
                       optimizer: optimizers.Adam, seed: int) -> TrainState:
  params = [p for _, p in model.named_parameters()]
  return TrainState(model=model, opt_state=optimizer.init(params),
                    global_step=0, seed=seed)


def fold_seed(seed: int, step: int) -> int:
  """A 63-bit generator seed from (seed, step)."""
  state = np.random.SeedSequence([seed, step]).generate_state(2, np.uint32)
  return (int(state[0]) << 31) ^ int(state[1])


def step_generator(state: TrainState) -> torch.Generator:
  return torch.Generator().manual_seed(fold_seed(state.seed,
                                                 state.global_step))


def reduce_metrics(metrics: Dict[str, Tensor], mask: Tensor
                   ) -> AggregatedMetrics:
  """Per-example metrics -> (sum, count), masked by ``mask`` & finiteness."""
  out = {}
  for key, value in metrics.items():
    value = value.detach().float()
    metric_mask = mask * torch.isfinite(value)
    out[key] = ((value * metric_mask).sum(), metric_mask.sum())
  return out


def summarize(accumulated: List[AggregatedMetrics]) -> Dict[str, float]:
  """(sum, count) pairs over steps -> means (host side)."""
  if not accumulated:
    return {}
  return {key: sum(float(m[key][0]) for m in accumulated)
          / max(sum(float(m[key][1]) for m in accumulated), 1.0)
          for key in accumulated[0]}


def loss_and_metrics(model: bev_localizer.BEVLocalizer, batch: Dict[str, Any],
                     train: bool, generator=None, draws=None,
                     pose_samples=None):
  """(masked-mean loss, per-example losses, metrics, predictions)."""
  pred = model(batch, train=train, generator=generator, draws=draws,
               pose_samples=pose_samples)
  losses, metrics = model.loss_metrics_function(pred, batch)
  mask = batch['batch_mask'] > 0
  loss = losses['total'][mask].mean()
  return loss, losses, metrics, pred


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
  poses, without the GT) inject the forward's random draws; by default
  they come from the step's generator.
  """
  model = state.model
  names = [n for n, _ in model.named_parameters()]
  params = [p for _, p in model.named_parameters()]
  loss, losses, metrics, pred = loss_and_metrics(
      model, batch, True, step_generator(state), draws, pose_samples)
  grads = torch.autograd.grad(loss, params, allow_unused=True)
  grads = [torch.zeros_like(p) if g is None else g
           for g, p in zip(grads, params)]
  logs = apply_gradients(params, grads, state, optimizer)
  for key, value in losses.items():
    metrics[f'loss/{key}'] = value
  samples = pred.get('map_t_query_samples')
  return StepOutput(
      metrics=reduce_metrics(metrics, batch['batch_mask']), logs=logs,
      grads=dict(zip(names, grads)), draws=pred['draws'],
      pose_samples=None if samples is None else samples[:, 1:])
