"""The protocol every model of the registry follows (port of
``snap_tpu/models/base.py``).

The JAX package wraps each flax module in a ``BaseModel`` that holds the
config, the dataset's metadata and the loss; in the port the module itself
is the model. Each module of the registry is built by its module's
``build(config, meta_data, dtype)`` (``models.get_model``) and has:

- ``forward(data, train=False, generator=None, draws=None)``: the
  predictions; with ``train`` its random draws come from ``draws``, else
  from ``sample_draws`` on ``generator``;
- ``sample_draws(batch_size, generator, device)``: a training forward's
  draws (``bev_mapper.TrainDraws``), taken on a CPU ``torch.Generator``, so
  that the card and the CPU draw the same numbers;
- ``loss_metrics_function(pred, data)``: per-example losses (``'total'``
  among them) and metrics; the trainer reduces them.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Protocol, Tuple

import torch

Batch = Dict[str, Any]
Predictions = Dict[str, Any]
LossDict = Dict[str, torch.Tensor]
MetricsDict = Dict[str, torch.Tensor]
LossMetricsTuple = Tuple[LossDict, MetricsDict]


class Model(Protocol):
  """What the trainer and the evaluator call on a model."""

  def __call__(self, data: Batch, train: bool = False,
               generator: Optional[torch.Generator] = None,
               draws: Any = None) -> Predictions:
    ...

  def sample_draws(self, batch_size: int, generator: torch.Generator,
                   device: torch.device) -> Any:
    ...

  def loss_metrics_function(self, pred: Predictions,
                            data: Batch) -> LossMetricsTuple:
    ...
