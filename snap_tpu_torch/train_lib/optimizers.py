"""Adam / AdamW with optax's numerics, and optax's global-norm clipping.

``snap_tpu/train_lib/optimizers.py`` chains ``optax.clip_by_global_norm``
before ``optax.adam`` (``adamw`` when a weight decay is set). The update is
written out functionally, as optax's is, so the trainer can drop a step
whose gradients are not finite and keep the old moments:

- clip: ``g * max_norm / ||g||`` when ``||g|| >= max_norm`` (optax's rule;
  ``torch.nn.utils.clip_grad_norm_`` divides by ``||g|| + 1e-6``);
- moments: ``mu = b1 mu + (1 - b1) g``, ``nu = b2 nu + (1 - b2) g^2``,
  bias-corrected at ``count + 1`` by ``1 - b^(count + 1)`` formed in f32;
- update: ``-lr(count) * (mu_hat / (sqrt(nu_hat) + eps) [+ wd * param])``,
  the learning rate read at the count *before* it increments (optax's
  ``scale_by_schedule``), so under a linear warmup the first update is 0.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import torch

from snap_tpu_torch import configs
from snap_tpu_torch.train_lib import lr_schedules

Tensor = torch.Tensor

# optax.adam's defaults, which the JAX configs keep.
B1, B2, EPS = 0.9, 0.999, 1e-8


@dataclasses.dataclass
class AdamState:
  count: int  # updates applied so far (optax's ScaleByAdamState.count)
  mu: List[Tensor]
  nu: List[Tensor]


def global_norm(tensors: Sequence[Tensor]) -> Tensor:
  """``sqrt(sum of squares)`` over every leaf, in f32 (``optax.global_norm``)."""
  return torch.sqrt(sum((t.float() ** 2).sum() for t in tensors))


def clip_by_global_norm(grads: Sequence[Tensor], max_norm: float
                        ) -> List[Tensor]:
  """optax's rule: unchanged below ``max_norm``, else scaled onto it."""
  norm = global_norm(grads)
  return [torch.where(norm < max_norm, g, g / norm.to(g.dtype) * max_norm)
          for g in grads]


class Adam:
  """``[clip_by_global_norm] -> adam | adamw`` as an optax-style transform."""

  def __init__(self, config: configs.TrainConfig):
    opt = config.optimizer_configs
    if opt.freeze_params_reg_exp:
      raise NotImplementedError(
          'freeze_params_reg_exp comes with the heads (ROADMAP A10).')
    if opt.optimizer not in ('adam', 'adamw'):
      raise NotImplementedError(f'optimizer {opt.optimizer!r}')
    self.weight_decay = opt.weight_decay
    self.max_grad_norm = config.max_grad_norm
    self.lr_fn = lr_schedules.get_learning_rate_fn(config.lr_configs)

  def init(self, params: Sequence[Tensor]) -> AdamState:
    return AdamState(
        count=0,
        mu=[torch.zeros_like(p, dtype=torch.float32) for p in params],
        nu=[torch.zeros_like(p, dtype=torch.float32) for p in params])

  def update(self, grads: Sequence[Tensor], state: AdamState,
             params: Sequence[Tensor]) -> Tuple[List[Tensor], AdamState]:
    """(updates to add to the params, the next state); pure."""
    grads = [g.float() for g in grads]
    if self.max_grad_norm is not None:
      grads = clip_by_global_norm(grads, self.max_grad_norm)
    count = state.count + 1
    mu = [(1 - B1) * g + B1 * m for g, m in zip(grads, state.mu)]
    nu = [(1 - B2) * g * g + B2 * v for g, v in zip(grads, state.nu)]
    # Bias corrections in f32, as optax forms them (1 - b2^t cancels).
    c1, c2 = (float(1 - torch.tensor(b, dtype=torch.float32) ** count)
              for b in (B1, B2))
    lr = self.lr_fn(state.count)
    updates = []
    for m, v, p in zip(mu, nu, params):
      u = (m / c1) / (torch.sqrt(v / c2) + EPS)
      if self.weight_decay:
        u = u + self.weight_decay * p.detach().float()
      updates.append(-lr * u)
    return updates, AdamState(count=count, mu=mu, nu=nu)
