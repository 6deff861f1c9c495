"""Multi-modal Bird's-Eye-View neural map builder.

Port of ``snap_tpu/models/bev_mapper.py``: street-view volumes are pooled
vertically into a plane, the aerial raster is encoded directly, the
modalities are fused by a masked max over a pseudo-z axis, and a linear
matching head gives L2-normalized features. In training the query's z
column floor is jittered and map modalities are dropped at random; the
draws come from an explicit CPU ``torch.Generator`` (``sample_draws``), so
a run on the card and one on the CPU draw the same numbers.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import math
import pathlib
from typing import Any, Dict, List, NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from snap_tpu_torch import configs
from snap_tpu_torch import convert
from snap_tpu_torch.models import image_encoder
from snap_tpu_torch.models import layers
from snap_tpu_torch.models import streetview_encoder
from snap_tpu_torch.models import types
from snap_tpu_torch.utils import grids

Tensor = torch.Tensor
log = logging.getLogger(__name__)


def median(x: Tensor, dim: int = -1) -> Tensor:
  """``jnp.median``: the mean of the two middle values for an even count
  (``torch.median`` returns the lower one)."""
  s = torch.sort(x, dim=dim).values
  n = x.shape[dim]
  lo = s.narrow(dim, (n - 1) // 2, 1).squeeze(dim)
  hi = s.narrow(dim, n // 2, 1).squeeze(dim)
  return lo * 0.5 + hi * 0.5


class TrainDraws(NamedTuple):
  """The random draws of one training forward."""

  z_jitter: Optional[Tensor]  # [B] f32 offset of the query's z floor
  modality_keep: Optional[Tensor]  # [M, B] bool, per map modality


class VerticalPooling(nn.Module):
  """Masked max / sum / mean over the column axis (-2) of a volume."""

  def __init__(self, config: configs.VerticalPoolingConfig):
    super().__init__()
    if config.pooling not in ('max', 'sum', 'mean'):
      raise NotImplementedError(
          f'VerticalPooling {config.pooling!r}: the port has max/sum/mean.')
    self.mode = config.pooling

  def forward(self, volume: types.FeatureVolume) -> types.FeaturePlane:
    features, valid = volume.features, volume.valid
    has_data = valid.any(-1)
    if self.mode == 'sum':
      plane = (features * valid[..., None]).sum(-2)
    elif self.mode == 'mean':
      plane = layers.masked_mean(features, valid[..., None], axis=-2)
    else:
      # Empty columns count as fully valid; their output is zeroed below.
      guard = torch.where(has_data[..., None], valid, True)[..., None]
      plane = torch.where(guard, features, -torch.inf).amax(-2)
    plane = torch.where(has_data[..., None], plane, 0)
    return types.FeaturePlane(features=plane, valid=has_data)


class BEVMapper(nn.Module):
  """Encode a scene (street views + optional aerial raster) into a plane."""

  def __init__(self, config: configs.BEVMapperConfig, grid: grids.Grid2D,
               dtype: torch.dtype):
    super().__init__()
    if config.add_confidence:
      raise NotImplementedError('Map confidence heads are not ported yet.')
    self.config = config
    self.grid = grid
    self.dtype = dtype
    dims = []
    self.streetview_encoder = None
    self.aerial_encoder = None
    if config.streetview_encoder is not None:
      self.streetview_encoder = streetview_encoder.StreetViewEncoder(
          config.streetview_encoder, dtype)
      self.vertical_pooling = VerticalPooling(config.pooling)
      dims.append(config.streetview_encoder.fusion.layers[-1])
    if config.aerial_encoder is not None:
      self.aerial_encoder = image_encoder.ImageEncoder(
          config.aerial_encoder, dtype)
      dims.append(config.aerial_encoder.output_dim)
    if not dims:
      raise ValueError('Need to create at least one input encoder.')
    if len(set(dims)) > 1:
      raise ValueError(f'Encoders have different output dimensions: {dims}')
    self.num_map_modalities = len(dims)
    self.modality_fusion = VerticalPooling(config.modality_fusion)
    self.matching_proj = None
    if config.matching_dim is not None:
      self.matching_proj = layers.Dense(dims[0], config.matching_dim, dtype)

  def sample_draws(self, batch: int, generator: torch.Generator,
                   device: torch.device) -> TrainDraws:
    """Draw one training forward's randomness on the CPU ``generator``.

    The query's z floor moves by U(lo, hi) per example; each (map modality,
    example) is kept with p = 0.5, and an example that would lose every
    modality keeps them all (``snap_tpu/models/bev_mapper.py:267-276``).
    """
    z_jitter = keep = None
    if self.config.scene_z_offset_range is not None:
      lo, hi = self.config.scene_z_offset_range
      z_jitter = lo + (hi - lo) * torch.rand(batch, generator=generator)
      z_jitter = z_jitter.to(device)
    if self.config.apply_modality_dropout and self.num_map_modalities > 1:
      keep = torch.rand((self.num_map_modalities, batch),
                        generator=generator) < 0.5
      keep = (keep | ~keep.any(0)).to(device)
    return TrainDraws(z_jitter=z_jitter, modality_keep=keep)

  def build_xyz_query(self, data: Dict[str, Any],
                      z_jitter: Optional[Tensor] = None) -> Tensor:
    """BEV grid xy x a z-column anchored below the median camera height."""
    t = data['T_view2scene'].t
    batch, device = t.shape[0], t.device
    cell = self.grid.cell_size
    xy = data.get('xy_bev')
    if xy is None:
      xy = self.grid.index_to_xyz(self.grid.grid_index(device).float())
    if xy.ndim != 4:
      xy = xy[None].expand(batch, *xy.shape)
    z_floor = median(t[..., -1], -1) - self.config.scene_z_offset
    if z_jitter is not None:
      z_floor = z_floor + z_jitter
    num_z = math.ceil(self.config.scene_z_height / cell - 1e-9)
    z_levels = (torch.arange(num_z, device=device, dtype=torch.float32)
                + 0.5) * cell
    z = z_floor[:, None] + z_levels[None]  # [B, Z]
    shape = (batch, *xy.shape[1:3], num_z)
    return torch.cat([
        xy[:, :, :, None, :].expand(*shape, 2),
        z[:, None, None, :, None].expand(*shape, 1),
    ], -1)

  def encode_streetview(self, data: Dict[str, Any],
                        z_jitter: Optional[Tensor] = None) -> Dict[str, Any]:
    data = dict(data)
    data['xyz_query'] = self.build_xyz_query(data, z_jitter)
    pred = self.streetview_encoder(data)
    pred['feature_plane'] = self.vertical_pooling(pred['feature_volume'])
    return pred

  def encode_aerial(self, aerial_rgb: Tensor) -> Dict[str, Any]:
    features = self.aerial_encoder(aerial_rgb).features[-1]
    valid = torch.ones(features.shape[:-1], dtype=torch.bool,
                       device=features.device)
    return {'feature_plane': types.FeaturePlane(features=features, valid=valid)}

  def fuse_neural_maps(self, planes: List[types.FeaturePlane],
                       keep: Optional[Tensor] = None) -> types.FeaturePlane:
    """Masked max over the modalities; ``keep [M, B]`` drops some."""
    if len(planes) == 1:
      return planes[0]
    if keep is not None:
      planes = [types.FeaturePlane(features=p.features,
                                   valid=p.valid & k[:, None, None])
                for p, k in zip(planes, keep)]
    stacked = types.FeatureVolume(
        features=torch.stack([p.features for p in planes], -2),
        valid=torch.stack([p.valid for p in planes], -1))
    return self.modality_fusion(stacked)

  def forward(self, data: Dict[str, Any], train: bool = False,
              is_query: bool = False,
              draws: Optional[TrainDraws] = None) -> Dict[str, Any]:
    """Encode one scene. With ``train``, the query's z jitter and the map's
    modality dropout apply, from ``draws`` (``sample_draws``)."""
    pred: Dict[str, Any] = {}
    planes = []
    z_jitter = keep = None
    if train:
      if draws is None:
        raise ValueError('train=True needs the draws (sample_draws)')
      device = data['T_view2scene'].t.device
      draws = TrainDraws(*(None if t is None else t.to(device)
                           for t in draws))
      z_jitter = draws.z_jitter if is_query else None
      keep = None if is_query else draws.modality_keep
    if self.streetview_encoder is not None:
      pred['streetview'] = self.encode_streetview(data, z_jitter)
      planes.append(pred['streetview']['feature_plane'])
    if self.aerial_encoder is not None and 'rasters' in data:
      # There is no aerial raster for query scenes.
      pred['aerial'] = self.encode_aerial(data['rasters']['rgb'])
      planes.append(pred['aerial']['feature_plane'])
    if not planes:
      raise ValueError('No map encoder given.')
    pred['bev_features'] = plane = self.fuse_neural_maps(planes, keep)
    if self.matching_proj is not None:
      f = self.matching_proj(plane.features)
      if self.config.normalize_matching_features:
        f = layers.normalize(f)
      f = torch.where(plane.valid[..., None], f, 0)
      pred['bev_matching'] = types.FeaturePlane(features=f, valid=plane.valid)
    return pred

  def load_pretrained_variables(self) -> Optional[Dict[str, Tensor]]:
    """The ``bev_mapper`` parameters of the experiment workdir
    ``config.pretrained_path`` (``snap_tpu/models/bev_mapper.py:340-350``),
    named relative to this module: from its latest checkpoint
    (``train_lib/checkpoints.py``), else from a JAX export's flat
    ``params.npz``. None without a path. Warns where the workdir's
    ``config.json`` gives the mapper another config (``:112-119``)."""
    path = self.config.pretrained_path
    if path is None:
      return None
    from snap_tpu_torch.train_lib import checkpoints  # pylint: disable=g-import-not-at-top
    workdir = pathlib.Path(path)
    warn_config_diff(self.config, workdir)
    if checkpoints.latest_step(workdir) is not None:
      params = checkpoints.restore_params(workdir)
    elif (workdir / 'params.npz').exists():
      with np.load(workdir / 'params.npz') as npz:
        params = convert.params_from_flax(dict(npz))
    else:
      params = {}
    params = subtree(params, 'bev_mapper')
    if not params:
      raise ValueError(f'No parameters for {type(self).__name__} in {path}')
    log.info('Loaded pretrained weights for %s from %s.',
             type(self).__name__, path)
    return params


def subtree(params: Dict[str, Tensor], name: str) -> Dict[str, Tensor]:
  """The entries under the first module called ``name`` (the shortest
  prefix ending in it), named relative to it (``misc.find_nested_dict``)."""
  prefixes = sorted({tuple(k.split('.')[:k.split('.').index(name) + 1])
                     for k in params if name in k.split('.')[:-1]}, key=len)
  if not prefixes:
    return {}
  prefix = '.'.join(prefixes[0]) + '.'
  return {k[len(prefix):]: v for k, v in params.items()
          if k.startswith(prefix)}


def _config_diff(ours, theirs, path: str = '') -> Dict[str, Any]:
  diff = {}
  for field in dataclasses.fields(ours):
    a, b = getattr(ours, field.name), getattr(theirs, field.name)
    if dataclasses.is_dataclass(a) and dataclasses.is_dataclass(b):
      diff.update(_config_diff(a, b, f'{path}{field.name}.'))
    elif a != b:
      diff[path + field.name] = (a, b)
  return diff


def warn_config_diff(config: configs.BEVMapperConfig,
                     workdir: pathlib.Path) -> None:
  """Log the fields where ``workdir``'s mapper config differs from
  ``config`` (its ``config.json`` in the reference's keys)."""
  record = pathlib.Path(workdir) / 'config.json'
  if not record.exists():
    log.info('No config.json in %s to compare the mapper with.', workdir)
    return
  theirs = configs.from_reference(json.loads(record.read_text()))
  diff = _config_diff(config, theirs.model.bev_mapper)
  if diff:
    log.warning('Found differences between configs (ours, pretrained):\n%s',
                '\n'.join(f'{k}: {v}' for k, v in sorted(diff.items())))
