"""Weights for the port: converted from flax params, or drawn from a seed.

The port's modules carry the flax module names (``bev_mapper``,
``streetview_encoder``, ``block1/unit01/conv1``, ``Dense_0``,
``0_skip_conv``...), so a flax path maps onto a state-dict key by joining
it with dots and renaming the leaf:

- conv ``kernel`` ``[h, w, in, out]`` (HWIO) -> ``weight`` ``[out, in, h, w]``;
- dense ``kernel`` ``[in, out]`` -> ``weight`` ``[out, in]``;
- GroupNorm ``scale`` / ``bias`` ``[1, 1, 1, C]`` -> ``[C]``;
- dense ``bias`` and the scalar ``temperature`` as they are.

``flax_from_torch`` is the inverse map (tensors named as the module's
parameters -> '/'-joined flax paths in flax layout), so that gradients can
be held leaf by leaf against ``jax.grad``'s tree.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

from snap_tpu_torch.models import resnet


def flatten_params(tree: Mapping[str, Any], prefix: str = '') -> Dict[str, Any]:
  """Nested dict of arrays -> ``{'a/b/c': array}``."""
  flat = {}
  for key, value in tree.items():
    path = f'{prefix}/{key}' if prefix else str(key)
    if isinstance(value, Mapping):
      flat.update(flatten_params(value, path))
    else:
      flat[path] = value
  return flat


def params_from_flax(params: Mapping[str, Any],
                     module: Optional[nn.Module] = None
                     ) -> Dict[str, torch.Tensor]:
  """Convert a flax params tree (nested dict of numpy) to a state dict.

  ``params`` may also be flat, keyed by '/'-joined paths (as a ``.npz`` of
  the params holds them). With ``module``, raises ``ValueError`` naming
  every flax key that the module does not consume, every module key left
  missing, and every shape that differs.
  """
  state = {}
  for path, value in flatten_params(params).items():
    value = np.asarray(value, dtype=np.float32)
    parts = path.split('/')
    leaf = parts[-1]
    if leaf == 'kernel' and value.ndim == 4:
      leaf, value = 'weight', value.transpose(3, 2, 0, 1)
    elif leaf == 'kernel' and value.ndim == 2:
      leaf, value = 'weight', value.T
    elif leaf in ('scale', 'bias') and value.ndim > 1:
      value = value.reshape(-1)
    elif leaf == 'kernel':
      raise ValueError(f'{path}: unexpected kernel shape {value.shape}')
    state['.'.join(parts[:-1] + [leaf])] = torch.tensor(value)
  if module is not None:
    expected = {k: tuple(v.shape) for k, v in module.state_dict().items()}
    unconsumed = sorted(set(state) - set(expected))
    missing = sorted(set(expected) - set(state))
    mismatched = sorted(
        f'{k}: {tuple(state[k].shape)} vs {expected[k]}'
        for k in set(state) & set(expected)
        if tuple(state[k].shape) != expected[k])
    if unconsumed or missing or mismatched:
      raise ValueError(
          f'params_from_flax: unconsumed {unconsumed}, missing {missing}, '
          f'shape mismatches {mismatched}')
  return state


def flax_path(name: str) -> str:
  """The '/'-joined flax path of the port's parameter ``name`` (a conv's
  or dense layer's ``weight`` is flax's ``kernel``)."""
  owner, _, leaf = name.rpartition('.')
  leaf = 'kernel' if leaf == 'weight' else leaf
  return '/'.join(owner.split('.') + [leaf]) if owner else leaf


def flax_from_torch(named: Mapping[str, torch.Tensor], module: nn.Module
                    ) -> Dict[str, np.ndarray]:
  """Tensors named like ``module``'s parameters (its weights, or their
  gradients) -> ``{'a/b/kernel': array}`` in flax layout (f32 numpy)."""
  modules = dict(module.named_modules())
  flat = {}
  for name, tensor in named.items():
    value = tensor.detach().float().cpu().numpy()
    owner, _, leaf = name.rpartition('.')
    if leaf == 'weight' and value.ndim == 4:
      leaf, value = 'kernel', value.transpose(2, 3, 1, 0)
    elif leaf == 'weight' and value.ndim == 2:
      leaf, value = 'kernel', value.T
    elif leaf in ('scale', 'bias') and isinstance(modules[owner],
                                                  resnet.GroupNorm):
      value = value.reshape(1, 1, 1, -1)
    elif leaf == 'weight':
      raise ValueError(f'{name}: unexpected weight shape {value.shape}')
    flat['/'.join(owner.split('.') + [leaf]) if owner else leaf] = value
  return flat


def init_params(module: nn.Module, seed: int,
                init_temperature: float = 2.0) -> None:
  """Seeded random weights (flax-like scales), drawn on the CPU.

  Conv kernels ~ N(0, 1/fan_in), dense kernels ~ Glorot-uniform, biases 0,
  GroupNorm scales 1, ``temperature`` = ``init_temperature``.
  """
  gen = torch.Generator().manual_seed(seed)
  with torch.no_grad():
    for name, p in module.named_parameters():
      leaf = name.rsplit('.', 1)[-1]
      if leaf == 'temperature':
        value = torch.full(p.shape, init_temperature)
      elif leaf == 'scale':
        value = torch.ones(p.shape)
      elif leaf == 'bias':
        value = torch.zeros(p.shape)
      elif p.ndim == 4:
        fan_in = p.shape[1] * p.shape[2] * p.shape[3]
        value = torch.randn(p.shape, generator=gen) / math.sqrt(fan_in)
      elif p.ndim == 2:
        bound = math.sqrt(6.0 / (p.shape[0] + p.shape[1]))
        value = (torch.rand(p.shape, generator=gen) * 2 - 1) * bound
      else:
        raise ValueError(f'init_params: no rule for {name} {tuple(p.shape)}')
      p.copy_(value.to(p.dtype))
