"""The dynamic loss scale of fp16 training
(``flax.training.dynamic_scale.DynamicScale``, which
``snap_tpu/train_lib/trainer.py:396-400`` builds with
``minimum_scale=256.0`` when the dtype is float16).

The step multiplies the f32 loss by ``scale`` before the backward, casts
every gradient to f32 and divides it by ``scale``; ``update`` then takes
whether all of them are finite. After ``growth_interval`` finite steps in
a row the next finite step multiplies the scale by ``growth_factor``
(capped at the largest f32); a step that is not finite multiplies it by
``backoff_factor``, down to ``minimum_scale``. ``fin_steps`` restarts at 0
on growth and on a step that is not finite, and otherwise counts the
finite steps. The arithmetic is f32's, as flax's.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

F32_MAX = float(np.finfo(np.float32).max)
# The minimum scale of fp16 training (``snap_tpu/train_lib/trainer.py:400``).
MINIMUM_SCALE = 256.0


def _f32(x: float) -> np.float32:
  return np.float32(x)


@dataclasses.dataclass(frozen=True)
class DynamicScale:
  growth_factor: float = 2.0
  backoff_factor: float = 0.5
  growth_interval: int = 2000
  fin_steps: int = 0
  scale: float = 65536.0
  minimum_scale: Optional[float] = float(np.finfo(np.float32).tiny)

  def update(self, finite: bool) -> 'DynamicScale':
    """The scale and ``fin_steps`` after a step whose gradients were all
    finite, or not."""
    grow = self.fin_steps == self.growth_interval
    with np.errstate(over='ignore'):
      if finite:
        scale = (np.minimum(_f32(self.scale) * _f32(self.growth_factor),
                            _f32(F32_MAX)) if grow else _f32(self.scale))
      else:
        scale = _f32(self.scale) * _f32(self.backoff_factor)
        if self.minimum_scale is not None:
          scale = np.maximum(scale, _f32(self.minimum_scale))
    fin_steps = 0 if grow or not finite else self.fin_steps + 1
    return dataclasses.replace(self, fin_steps=fin_steps, scale=float(scale))

  def state(self) -> dict:
    """What a checkpoint keeps: the scale and ``fin_steps`` (the factors
    and the interval are the run's settings, as flax's static fields)."""
    return {'scale': self.scale, 'fin_steps': self.fin_steps}


def for_dtype(dtype_str: str) -> Optional[DynamicScale]:
  """fp16 trains with ``DynamicScale(minimum_scale=256.0)``; bf16 and f32
  with none."""
  return (DynamicScale(minimum_scale=MINIMUM_SCALE)
          if dtype_str == 'float16' else None)
