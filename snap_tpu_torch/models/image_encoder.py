"""Image backbone: ResNet trunk + top-down feature pyramid.

Port of ``snap_tpu/models/image_encoder.py``. The input is padded up to the
coarsest stride and every level is cropped back to ``ceil(input / stride)``.
The x2 upsampling is bilinear with half-pixel centres, as
``jax.image.resize(..., 'bilinear')`` is on octave steps, borders included
(tests/test_torch_encoders.py and tests/test_torch_upsample.py hold the two
against each other). It is written from shifted slices, so that its
backward is slicing and sums in a fixed order: ``F.interpolate``'s CUDA
backward (``upsample_bilinear2d_backward``) adds with atomics, and
``F.pad(mode='replicate')``'s too, so neither gives the same gradient on
every run (ROADMAP C20).
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F

from snap_tpu_torch import configs
from snap_tpu_torch.models import resnet
from snap_tpu_torch.models import types

Tensor = torch.Tensor


def pad_to_multiple(images: Tensor, stride: int) -> Tensor:
  """Zero-pad H/W (the two dims before channels) up to a multiple of stride."""
  pad_h, pad_w = ((-np.array(images.shape[-3:-1])) % stride).tolist()
  return F.pad(images, (0, 0, 0, pad_w, 0, pad_h))


def _upsample_axis(x: Tensor, axis: int) -> Tensor:
  """x2 along ``axis`` with half-pixel centres: output 2k is 0.75 x[k] +
  0.25 x[k - 1], output 2k + 1 is 0.75 x[k] + 0.25 x[k + 1], the
  neighbour clamped at the edges (where the two terms are the same row)."""
  n = x.shape[axis]
  before = torch.cat([x.narrow(axis, 0, 1), x.narrow(axis, 0, n - 1)], axis)
  after = torch.cat([x.narrow(axis, 1, n - 1), x.narrow(axis, n - 1, 1)],
                    axis)
  even = 0.75 * x + 0.25 * before
  odd = 0.75 * x + 0.25 * after
  return torch.stack([even, odd], axis + 1).flatten(axis, axis + 1)


def upsample2x(coarse: Tensor) -> Tensor:
  """Bilinear x2 upsampling of an NHWC tensor (half-pixel centres, edges
  clamped), rows then columns in f32, rounded once to the input's dtype.
  Its backward is the transposed stencil, formed by autograd from slices,
  ``cat``, ``stack`` and sums: no atomics, the same bits on every run."""
  x = coarse.float()
  return _upsample_axis(_upsample_axis(x, 1), 2).to(coarse.dtype)


class SkipConv(nn.Module):
  """A lateral head's bias-free 1x1 convolution (the kernel as it is, not
  standardized)."""

  def __init__(self, nin: int, nout: int, dtype: torch.dtype):
    super().__init__()
    self.dtype = dtype
    self.weight = nn.Parameter(torch.empty(nout, nin, 1, 1))

  def forward(self, x: Tensor) -> Tensor:
    return resnet.conv_nhwc(x, self.weight.to(self.dtype))


class FPNDecoder(nn.Module):
  """Lateral heads (relu -> GroupNorm -> 1x1 conv), then a top-down sum."""

  def __init__(self, output_dim: int, in_channels: List[int],
               dtype: torch.dtype):
    super().__init__()
    self.dtype = dtype
    self.num_levels = len(in_channels)
    for i, c in enumerate(in_channels):
      self.add_module(f'{i}_skip_norm', resnet.GroupNorm(c, dtype))
      self.add_module(f'{i}_skip_conv', SkipConv(c, output_dim, dtype))

  def forward(self, trunk_features: List[Tensor]) -> List[Tensor]:
    pyramid: List[Tensor] = []
    for i, f in enumerate(trunk_features):
      f = getattr(self, f'{i}_skip_norm')(F.relu(f))
      lateral = getattr(self, f'{i}_skip_conv')(f)
      if pyramid:
        if lateral.shape[1:3] != tuple(2 * s for s in pyramid[-1].shape[1:3]):
          raise ValueError('Pyramid levels must be octaves: '
                           f'{pyramid[-1].shape} -> {lateral.shape}.')
        lateral = lateral + upsample2x(pyramid[-1])
      pyramid.append(lateral)
    return pyramid


class ImageEncoder(nn.Module):
  """Trunk + FPNDecoder, returning a FeatureImagePyramid with strides."""

  def __init__(self, config: configs.ImageEncoderConfig, dtype: torch.dtype,
               in_channels: int = 3):
    super().__init__()
    if config.encoder_name != 'resnet':
      raise ValueError(f'Unknown trunk: {config.encoder_name!r}')
    self.config = config
    self.dtype = dtype
    self.encoder = resnet.ResNetV2(config.encoder, dtype, in_channels)
    self.num_levels = config.num_pyr_levels or len(self.encoder.level_names)
    root_octaves = 0 if config.encoder.skip_root_block else 2
    self.max_stride = 2 ** (root_octaves + self.num_levels - 1)
    channels = self.encoder.out_channels[:self.num_levels][::-1]
    self.decoder = FPNDecoder(config.output_dim, channels, dtype)

  def forward(self, image: Tensor) -> types.FeatureImagePyramid:
    """``image``: ``[N, H, W, in_channels]``, an image in [0, 1] or
    embedded rasters; features are NHWC."""
    image = image.to(self.dtype)
    input_hw = np.array(image.shape[-3:-1])
    padded = pad_to_multiple(image, self.max_stride)
    padded_hw = np.array(padded.shape[-3:-1])
    stages = self.encoder(padded)
    skips = [stages[name] for name in
             reversed(self.encoder.level_names[:self.num_levels])]
    features, strides = [], []
    for f in self.decoder(skips):
      stride = tuple(int(s) for s in padded_hw // np.array(f.shape[-3:-1]))
      h, w = (-(-input_hw // np.array(stride))).astype(int)
      features.append(f[..., :h, :w, :])
      strides.append(stride)
    return types.FeatureImagePyramid(features=features, strides=tuple(strides))
