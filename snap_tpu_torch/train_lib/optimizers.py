"""The optax chain of ``snap_tpu/train_lib/optimizers.py``, with its numerics.

``get_optimizer`` there chains ``optax.clip_by_global_norm`` before
``optax.adam`` (``adamw`` when a weight decay is set) or ``optax.sgd``, and
freezes the parameters whose flax path matches ``freeze_params_reg_exp``.
The update is written out functionally, as optax's is, so the trainer can
drop a step whose gradients are not finite and keep the old state:

- clip: ``g * max_norm / ||g||`` when ``||g|| >= max_norm`` (optax's rule;
  ``torch.nn.utils.clip_grad_norm_`` divides by ``||g|| + 1e-6``);
- Adam moments: ``mu = b1 mu + (1 - b1) g``, ``nu = b2 nu + (1 - b2) g^2``,
  bias-corrected at ``count + 1`` by ``1 - b^(count + 1)`` formed in f32;
  update ``-lr(count) * (mu_hat / (sqrt(nu_hat) + eps) [+ wd * param])``;
- SGD (``optax.sgd``): the trace ``t = g + momentum * t``, update
  ``-lr(count) * t``;
- the learning rate is read at the count *before* it increments (optax's
  ``scale_by_schedule``), so under a linear warmup the first update is 0;
- freezing (``allocate_frozen_state``): True runs the whole chain over
  every parameter (moments for frozen ones too, clipping over every
  gradient) and zeroes the frozen updates; False runs it over the
  trainable parameters only (``optax.masked``): no moments for frozen
  ones, clipping over the trainable gradients.
"""

from __future__ import annotations

import dataclasses
import re
from typing import List, Optional, Sequence, Tuple

import torch

from snap_tpu_torch import configs
from snap_tpu_torch import convert
from snap_tpu_torch.train_lib import lr_schedules

Tensor = torch.Tensor

# optax.adam's defaults, which the JAX configs keep; the momentum
# ``snap_tpu/train_lib/optimizers.py`` gives optax.sgd (its configs set no
# other).
B1, B2, EPS = 0.9, 0.999, 1e-8
SGD_MOMENTUM = 0.9


@dataclasses.dataclass
class AdamState:
  """The chain's state: ``count`` updates applied so far (optax's), and one
  moment per parameter of ``Adam.moment_index``: Adam's ``mu`` and ``nu``,
  or SGD's trace in ``mu`` (``nu`` empty)."""

  count: int
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


def freeze_mask(names: Sequence[str], regex: Optional[str]) -> List[bool]:
  """True where a parameter is frozen: its flax path, '/'-joined and ending
  in '/', matches ``regex`` (``make_freeze_mask``)."""
  if not regex:
    return [False] * len(names)
  pattern = re.compile(regex)
  return [bool(pattern.search(convert.flax_path(n) + '/')) for n in names]


class Adam:
  """``[clip_by_global_norm] -> adam | adamw | sgd [-> freeze]`` as an
  optax-style transform over the parameters named ``names`` (needed to
  freeze), in ``model.named_parameters()`` order."""

  def __init__(self, config: configs.TrainConfig,
               names: Optional[Sequence[str]] = None):
    opt = config.optimizer_configs
    if opt.optimizer not in ('adam', 'adamw', 'sgd'):
      raise NotImplementedError(f'optimizer {opt.optimizer!r}')
    self.sgd = opt.optimizer == 'sgd'
    self.weight_decay = 0.0 if self.sgd else opt.weight_decay
    self.max_grad_norm = config.max_grad_norm
    self.lr_fn = lr_schedules.get_learning_rate_fn(config.lr_configs)
    self.frozen: Optional[List[bool]] = None
    self.allocate_frozen_state = opt.allocate_frozen_state
    if opt.freeze_params_reg_exp:
      if names is None:
        raise ValueError('freeze_params_reg_exp needs the parameter names')
      self.frozen = freeze_mask(names, opt.freeze_params_reg_exp)

  def moment_index(self, num_params: int) -> List[int]:
    """The parameters that carry moments: all, or the trainable ones when
    frozen ones get no state."""
    if self.frozen is None or self.allocate_frozen_state:
      return list(range(num_params))
    return [i for i in range(num_params) if not self.frozen[i]]

  def init(self, params: Sequence[Tensor]) -> AdamState:
    index = self.moment_index(len(params))
    zeros = lambda: [torch.zeros_like(params[i], dtype=torch.float32)
                     for i in index]
    return AdamState(count=0, mu=zeros(), nu=[] if self.sgd else zeros())

  def update(self, grads: Sequence[Tensor], state: AdamState,
             params: Sequence[Tensor]) -> Tuple[List[Tensor], AdamState]:
    """(updates to add to the params, the next state); pure."""
    index = self.moment_index(len(params))
    sub_grads = [grads[i].float() for i in index]
    if self.max_grad_norm is not None:
      sub_grads = clip_by_global_norm(sub_grads, self.max_grad_norm)
    count = state.count + 1
    lr = self.lr_fn(state.count)
    if self.sgd:
      mu = [g + SGD_MOMENTUM * t for g, t in zip(sub_grads, state.mu)]
      nu = []
      sub_updates = [-lr * t for t in mu]
    else:
      mu = [(1 - B1) * g + B1 * m for g, m in zip(sub_grads, state.mu)]
      nu = [(1 - B2) * g * g + B2 * v for g, v in zip(sub_grads, state.nu)]
      # Bias corrections in f32, as optax forms them (1 - b2^t cancels).
      c1, c2 = (float(1 - torch.tensor(b, dtype=torch.float32) ** count)
                for b in (B1, B2))
      sub_updates = []
      for m, v, i in zip(mu, nu, index):
        u = (m / c1) / (torch.sqrt(v / c2) + EPS)
        if self.weight_decay:
          u = u + self.weight_decay * params[i].detach().float()
        sub_updates.append(-lr * u)
    updates = sub_updates
    if len(index) < len(grads):  # no state, and no update, for frozen ones
      updates = [torch.zeros_like(g, dtype=torch.float32) for g in grads]
      for i, u in zip(index, sub_updates):
        updates[i] = u
    if self.frozen is not None:
      updates = [torch.zeros_like(u) if f else u
                 for u, f in zip(updates, self.frozen)]
    return updates, AdamState(count=count, mu=mu, nu=nu)


def get_optimizer(config: configs.TrainConfig, model: torch.nn.Module
                  ) -> Adam:
  """The chain of ``config`` over ``model``'s parameters."""
  return Adam(config, [n for n, _ in model.named_parameters()])
