"""Common model building blocks (port of ``snap_tpu/models/layers.py``).

The masked reductions keep the JAX package's "double-where" structure, so
outputs stay finite when a mask is empty.
"""

from __future__ import annotations

from typing import Sequence, Union

import torch
from torch import nn
import torch.nn.functional as F

from snap_tpu_torch import configs

Tensor = torch.Tensor
Axis = Union[int, Sequence[int]]


def masked_mean(x: Tensor, mask: Tensor, axis: Axis) -> Tensor:
  """Mean of ``x`` where ``mask``; zero for empty masks."""
  div = torch.where(mask.any(axis, keepdim=True), mask, True).sum(axis)
  return (x * mask).sum(axis) / div


def masked_softmax(x: Tensor, mask: Tensor, axis: int) -> Tensor:
  """Softmax over masked values with always-finite outputs."""
  mask = torch.where(mask.any(axis, keepdim=True), mask, True)
  return torch.softmax(torch.where(mask, x, -torch.inf), dim=axis)


def normalize(x: Tensor, axis: int = -1, eps: float = 1e-5) -> Tensor:
  """L2-normalize, in f32, with zero output for (near-)zero vectors."""
  x_ = x.float()
  norm = torch.linalg.norm(x_, dim=axis, keepdim=True)
  invalid = norm < eps
  y = torch.where(invalid, eps, x_)
  z = x_ / torch.linalg.norm(y, dim=axis, keepdim=True)
  return torch.where(invalid, 0, z.to(x.dtype))


class Dense(nn.Module):
  """``flax.linen.Dense``: f32 parameters, compute in ``dtype``."""

  def __init__(self, in_features: int, out_features: int, dtype: torch.dtype,
               use_bias: bool = True):
    super().__init__()
    self.dtype = dtype
    self.weight = nn.Parameter(torch.empty(out_features, in_features))
    self.bias = nn.Parameter(torch.zeros(out_features)) if use_bias else None

  def forward(self, x: Tensor) -> Tensor:
    bias = None if self.bias is None else self.bias.to(self.dtype)
    return F.linear(x.to(self.dtype), self.weight.to(self.dtype), bias)


class Embed(nn.Embedding):
  """``flax.linen.Embed``: an f32 table, looked up in ``dtype``."""

  def forward(self, ids: Tensor, dtype: torch.dtype) -> Tensor:
    return F.embedding(ids, self.weight.to(dtype))


class MLP(nn.Module):
  """Config-driven MLP; layers are named ``Dense_{i}`` as in flax."""

  def __init__(self, config: configs.MLPConfig, in_features: int,
               dtype: torch.dtype):
    super().__init__()
    if config.activation != 'relu':
      raise NotImplementedError(config.activation)
    self.config = config
    self.num_layers = len(config.layers)
    for i, d in enumerate(config.layers):
      self.add_module(f'Dense_{i}', Dense(in_features, d, dtype))
      in_features = d

  def forward(self, x: Tensor) -> Tensor:
    for i in range(self.num_layers):
      if i > 0 or self.config.apply_input_activation:
        x = F.relu(x)
      x = getattr(self, f'Dense_{i}')(x)
    return x
