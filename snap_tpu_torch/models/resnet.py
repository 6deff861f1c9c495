"""BiT ResNetV2 backbone (port of ``snap_tpu/models/resnet.py``).

Tensors are NHWC, as in the JAX package. Each convolution hands cuDNN an
NCHW view of the NHWC tensor (the channels-last layout), so no copy is made
to change layouts. Numerics kept from the reference:

- kernels are weight-standardized over (in, h, w) in f32 with eps 1e-10;
- GroupNorm standardizes over (spatial, in-group channels) with a biased f32
  variance and eps 1e-5, then scales in the compute dtype;
- the padding is explicit: (3, 3) for the 7x7-s2 root conv, (1, 1) for the
  3x3 convs and the 3x3-s2 max pool (padded with -inf), none for 1x1 convs;
- inputs are rescaled from [0, 1] to [-1, 1] (embedded rasters too, as the
  reference rescales every input).

Rematerialization follows the reference's ``nn.remat`` rule
(``ResNetConfig.checkpoint_units`` / ``checkpoint_blocks``): a
rematerialized module keeps only its input for the backward and runs its
forward again there (``torch.utils.checkpoint``, non-reentrant), while
autograd records. The second forward computes the same bits as the
first, so the gradients are those of the plain trunk.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F
from torch.utils import checkpoint

from snap_tpu_torch import configs

Tensor = torch.Tensor


def standardize(x: Tensor, dims: Sequence[int], eps: float) -> Tensor:
  dtype = x.dtype
  x = x.float()
  x = x - x.mean(dims, keepdim=True)
  x = x / torch.sqrt((x * x).mean(dims, keepdim=True) + eps)
  return x.to(dtype)


def conv_nhwc(x: Tensor, weight: Tensor, stride: int = 1,
              padding: int = 0) -> Tensor:
  """NHWC x OIHW convolution through a channels-last NCHW view."""
  y = F.conv2d(x.permute(0, 3, 1, 2), weight, stride=stride, padding=padding)
  return y.permute(0, 2, 3, 1)


def group_norm(x: Tensor, ngroups: int, scale: Tensor, bias: Tensor,
               dtype: torch.dtype) -> Tensor:
  """``x`` standardized over (spatial, in-group channels), then scaled."""
  c = x.shape[-1]
  y = x.reshape(*x.shape[:-1], ngroups, c // ngroups)
  dims = tuple(range(1, y.ndim - 2)) + (y.ndim - 1,)
  y = standardize(y, dims, eps=1e-5).reshape(x.shape)
  return y * scale.to(dtype) + bias.to(dtype)


class GroupNorm(nn.Module):
  """Group normalization with BiT-compatible variance (biased, f32)."""

  def __init__(self, num_channels: int, dtype: torch.dtype,
               ngroups: int = 32):
    super().__init__()
    self.dtype = dtype
    self.ngroups = min(ngroups, num_channels)
    self.scale = nn.Parameter(torch.ones(num_channels))
    self.bias = nn.Parameter(torch.zeros(num_channels))

  def forward(self, x: Tensor) -> Tensor:
    return group_norm(x, self.ngroups, self.scale, self.bias, self.dtype)


class StdConv(nn.Module):
  """Bias-free convolution with a weight-standardized kernel."""

  def __init__(self, nin: int, nout: int, kernel: int, dtype: torch.dtype,
               stride: int = 1, padding: int = 0):
    super().__init__()
    self.dtype = dtype
    self.stride = stride
    self.padding = padding
    self.weight = nn.Parameter(torch.empty(nout, nin, kernel, kernel))

  def forward(self, x: Tensor) -> Tensor:
    w = standardize(self.weight, (1, 2, 3), eps=1e-10).to(self.dtype)
    return conv_nhwc(x.to(self.dtype), w, self.stride, self.padding)


class RootBlock(nn.Module):
  """7x7-s2 conv + 3x3-s2 max-pool stem."""

  def __init__(self, width: int, dtype: torch.dtype, in_channels: int = 3):
    super().__init__()
    self.conv_root = StdConv(in_channels, width, 7, dtype, stride=2,
                             padding=3)

  def forward(self, x: Tensor) -> Tensor:
    x = self.conv_root(x)
    y = F.max_pool2d(x.permute(0, 3, 1, 2), 3, stride=2, padding=1)
    return y.permute(0, 2, 3, 1)


def remat(module: nn.Module, x: Tensor) -> Tensor:
  """``module(x)``; while autograd records, its activations are dropped
  and recomputed in the backward (``nn.remat``). The trunk draws no random
  numbers, so no generator state is kept for the second forward."""
  if not torch.is_grad_enabled():
    return module(x)
  return checkpoint.checkpoint(module, x, use_reentrant=False,
                               preserve_rng_state=False)


class ResidualUnit(nn.Module):
  """Pre-activation bottleneck unit."""

  def __init__(self, nin: int, nmid: int, dtype: torch.dtype,
               stride: int = 1):
    super().__init__()
    nout = nmid * 4
    self.gn1 = GroupNorm(nin, dtype)
    self.conv_proj = None
    if nin != nout or stride != 1:
      self.conv_proj = StdConv(nin, nout, 1, dtype, stride=stride)
    self.conv1 = StdConv(nin, nmid, 1, dtype)
    self.gn2 = GroupNorm(nmid, dtype)
    self.conv2 = StdConv(nmid, nmid, 3, dtype, stride=stride, padding=1)
    self.gn3 = GroupNorm(nmid, dtype)
    self.conv3 = StdConv(nmid, nout, 1, dtype)

  def forward(self, x: Tensor) -> Tensor:
    residual = x
    x = F.relu(self.gn1(x))
    if self.conv_proj is not None:
      residual = self.conv_proj(x)
    x = self.conv1(x)
    x = self.conv2(F.relu(self.gn2(x)))
    x = self.conv3(F.relu(self.gn3(x)))
    return x + residual


class ResNetStage(nn.Module):
  """A sequence of same-resolution bottleneck units ``unit01``, ``unit02``...,
  each rematerialized with ``checkpoint_units``."""

  def __init__(self, block_size: int, nin: int, nmid: int, dtype: torch.dtype,
               first_stride: int = 1, checkpoint_units: bool = False):
    super().__init__()
    self.num_units = block_size
    self.checkpoint_units = checkpoint_units
    for i in range(block_size):
      self.add_module(f'unit{i + 1:02d}', ResidualUnit(
          nin if i == 0 else nmid * 4, nmid, dtype,
          stride=first_stride if i == 0 else 1))

  def forward(self, x: Tensor) -> Tensor:
    for i in range(self.num_units):
      unit = getattr(self, f'unit{i + 1:02d}')
      x = remat(unit, x) if self.checkpoint_units else unit(x)
    return x


def get_block_desc(depth) -> List[int]:
  if isinstance(depth, (list, tuple)):
    return list(depth)
  return {
      26: [2, 2, 2, 2],
      50: [3, 4, 6, 3],
      101: [3, 4, 23, 3],
      152: [3, 8, 36, 3],
      200: [3, 24, 36, 3],
  }[depth]


class ResNetV2(nn.Module):
  """BiT-variant ResNet returning each stage's last unit output, over
  ``in_channels`` input channels (an image's 3, or embedded rasters').
  ``checkpoint_blocks`` rematerializes the root block, and each stage
  whole where its units are not (``snap_tpu/models/resnet.py:180-187``);
  a stride-1 stem (``skip_root_block``) is not rematerialized."""

  def __init__(self, config: configs.ResNetConfig, dtype: torch.dtype,
               in_channels: int = 3):
    super().__init__()
    self.dtype = dtype
    blocks = get_block_desc(config.depth)
    if config.limit_num_blocks is not None:
      blocks = blocks[:config.limit_num_blocks]
    self.blocks = blocks
    self.pretrained_path = config.pretrained_path
    self.level_names = [f'stage{i + 1}' for i in range(len(blocks))]
    self.skip_root_block = config.skip_root_block
    self.checkpoint_blocks = config.checkpoint_blocks
    self.checkpoint_stages = (config.checkpoint_blocks
                              and not config.checkpoint_units)
    width = int(64 * config.width)
    if config.skip_root_block:
      # Stride-1 stem for BEV-aligned rasters (aerial, semantic).
      self.conv_root = StdConv(in_channels, width, 3, dtype, padding=1)
    else:
      self.root_block = RootBlock(width, dtype, in_channels)
    nin = width
    self.out_channels: List[int] = []
    for i, block_size in enumerate(blocks):
      nmid = width * 2**i
      self.add_module(f'block{i + 1}', ResNetStage(
          block_size, nin, nmid, dtype, first_stride=1 if i == 0 else 2,
          checkpoint_units=config.checkpoint_units))
      nin = nmid * 4
      self.out_channels.append(nin)

  def forward(self, image: Tensor) -> Dict[str, Tensor]:
    x = image.to(self.dtype) * 2 - 1
    if self.skip_root_block:
      x = self.conv_root(x)
    elif self.checkpoint_blocks:
      x = remat(self.root_block, x)
    else:
      x = self.root_block(x)
    out = {}
    for i, name in enumerate(self.level_names):
      stage = getattr(self, f'block{i + 1}')
      x = out[name] = remat(stage, x) if self.checkpoint_stages else stage(x)
    return out

  def load_pretrained_variables(self) -> Optional[Dict[str, Tensor]]:
    """BiT weights from the big_vision ``.npz`` at ``pretrained_path``
    (``snap_tpu/models/resnet.py:211-233``), named relative to this module:
    flat keys such as ``'resnet/block1/unit01/conv1/standardized_conv2d/
    kernel'``, whose ``standardized_conv2d`` is the kernel and whose ''
    and ``resnet`` parts are dropped. None without a path."""
    if self.pretrained_path is None:
      return None
    from snap_tpu_torch import convert  # pylint: disable=g-import-not-at-top
    with open(self.pretrained_path, 'rb') as f:
      flat = dict(np.load(f, allow_pickle=False))
    params = {}
    for key, value in flat.items():
      parts = key.replace('standardized_conv2d', 'kernel').split('/')
      parts = [p for p in parts if p not in ('', 'resnet')]
      params['/'.join(parts)] = value
    return convert.params_from_flax(params)

