"""Compound-factor learning-rate schedules (``snap_tpu/train_lib/
lr_schedules.py``): ``factors='constant * linear_warmup * cosine_decay'``
multiplies the named factors, each a plain function of the step."""

from __future__ import annotations

import math
from typing import Callable

from snap_tpu_torch import configs

LrFn = Callable[[int], float]


def get_learning_rate_fn(config: configs.LrConfig) -> LrFn:
  """``lr(step)`` for ``config.factors`` (float64 arithmetic)."""
  factors = [f.strip() for f in config.factors.split('*')]
  known = {'constant', 'linear_warmup', 'cosine_decay', 'linear_decay',
           'rsqrt_decay'}
  unknown = [f for f in factors if f not in known]
  if unknown:
    raise NotImplementedError(f'Unknown lr factors: {unknown}')
  base = config.base_learning_rate
  warmup = config.warmup_steps or 0
  start_decay = config.start_decay_step or 0
  cycle = max(config.steps_per_cycle or 0, 1)

  def lr_fn(step: int) -> float:
    lr = 1.0
    for factor in factors:
      if factor == 'constant':
        lr *= base
      elif factor == 'linear_warmup':
        lr *= min(1.0, step / max(warmup, 1))
      elif factor == 'cosine_decay':
        progress = min(max((step - start_decay) / cycle, 0.0), 1.0)
        lr *= 0.5 * (1.0 + math.cos(math.pi * progress))
      elif factor == 'linear_decay':
        lr *= 1.0 - min(max((step - start_decay) / cycle, 0.0), 1.0)
      else:  # rsqrt_decay
        lr /= math.sqrt(max(step, warmup, 1.0))
    return lr

  return lr_fn
