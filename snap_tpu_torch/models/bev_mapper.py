"""Multi-modal Bird's-Eye-View neural map builder.

Port of ``snap_tpu/models/bev_mapper.py``: street-view volumes are pooled
vertically into a plane, the aerial raster and the semantic rasters are
encoded directly, the modalities are fused by a vertical pooling over a
pseudo-z axis (a masked max by default; any mode of ``VerticalPooling``), an
optional residual stage (``bev_net``) runs over the fused plane, a linear
matching head gives L2-normalized features and an optional confidence head
a per-cell log-probability. In training
the query's z column floor is jittered and map modalities are dropped at
random; the draws come from an explicit CPU ``torch.Generator``
(``sample_draws``), so a run on the card and one on the CPU draw the same
numbers.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import math
import pathlib
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch
from torch import nn
import torch.nn.functional as F

from snap_tpu_torch import configs
from snap_tpu_torch.models import image_encoder
from snap_tpu_torch.models import layers
from snap_tpu_torch.models import resnet
from snap_tpu_torch.models import semantic_raster_encoder
from snap_tpu_torch.models import streetview_encoder
from snap_tpu_torch.models import types
from snap_tpu_torch.train_lib import checkpoints
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
  # [B, 2] bool: the semantic head flips each example's plane along
  # each spatial axis where set.
  flips: Optional[Tensor] = None


class VerticalPooling(nn.Module):
  """Pool the column axis (-2) of a volume into a plane
  (``snap_tpu/models/bev_mapper.py:VerticalPooling``): a masked max, sum or
  mean; ``'weighted'`` / ``'softmax'``, a convex combination of the column's
  valid cells by the masked softmax of a learned per-cell score (through a
  log-sigmoid for ``'weighted'``); ``'mlp'``, an MLP over the zero-masked
  column flattened to ``Z * D`` inputs. The learned modes need the
  ``column`` shape ``(Z, D)`` they pool. Columns with no valid cell give 0.
  """

  def __init__(self, config: configs.VerticalPoolingConfig,
               dtype: torch.dtype = torch.float32,
               column: Optional[Tuple[int, int]] = None):
    super().__init__()
    self.mode = config.pooling
    self.dtype = dtype
    if self.mode in ('weighted', 'softmax', 'mlp') and column is None:
      raise ValueError(f'VerticalPooling {self.mode!r} needs the column '
                       'shape (Z, D)')
    if self.mode in ('weighted', 'softmax'):
      self.confidence_head = layers.Dense(column[1], 1, dtype)
      self.out_dim = column[1]
    elif self.mode == 'mlp':
      self.fusion_mlp = layers.MLP(config.mlp, column[0] * column[1], dtype)
      self.out_dim = config.mlp.layers[-1]
    elif self.mode in ('max', 'sum', 'mean'):
      self.out_dim = None if column is None else column[1]
    else:
      raise NotImplementedError(f'VerticalPooling {self.mode!r}')

  def forward(self, volume: types.FeatureVolume) -> types.FeaturePlane:
    features, valid = volume.features, volume.valid
    has_data = valid.any(-1)
    if self.mode in ('weighted', 'softmax'):
      logits = self.confidence_head(features)[..., 0].float()
      if self.mode == 'weighted':
        logits = F.logsigmoid(logits)  # an independent score in [-inf, 0]
      weights = layers.masked_softmax(logits, valid, axis=-1)
      weights = torch.where(valid, weights, 0.0)
      plane = (features * weights[..., None].to(self.dtype)).sum(-2)
      plane = plane.to(features.dtype)
    elif self.mode == 'mlp':
      column = torch.where(valid[..., None], features, 0)
      plane = self.fusion_mlp(column.reshape(*column.shape[:-2], -1))
    elif self.mode == 'sum':
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
  """Encode a scene (street views, an aerial raster, semantic rasters of
  ``semantic_map_classes``) into a plane; optionally a residual stage over
  the fused plane (``bev_net``) and a confidence head
  (``add_confidence``: ``bev_confidence``, a log-probability per cell)."""

  def __init__(self, config: configs.BEVMapperConfig, grid: grids.Grid2D,
               dtype: torch.dtype,
               semantic_map_classes: Optional[Sequence[str]] = None):
    super().__init__()
    self.config = config
    self.grid = grid
    self.dtype = dtype
    dims = []
    self.streetview_encoder = None
    self.aerial_encoder = None
    self.semantic_encoder = None
    if config.streetview_encoder is not None:
      self.streetview_encoder = streetview_encoder.StreetViewEncoder(
          config.streetview_encoder, dtype)
      column = (self.num_z(), config.streetview_encoder.fusion.layers[-1])
      self.vertical_pooling = VerticalPooling(config.pooling, dtype, column)
      dims.append(self.vertical_pooling.out_dim)
    if config.aerial_encoder is not None:
      self.aerial_encoder = image_encoder.ImageEncoder(
          config.aerial_encoder, dtype)
      dims.append(config.aerial_encoder.output_dim)
    if config.semantic_encoder is not None:
      if semantic_map_classes is None:
        raise ValueError('The semantic modality needs the rasters\' classes '
                         '(semantic_map_classes).')
      self.semantic_encoder = semantic_raster_encoder.SemanticRasterEncoder(
          config.semantic_encoder, semantic_map_classes, dtype)
      dims.append(config.semantic_encoder.encoder.output_dim)
    if not dims:
      raise ValueError('Need to create at least one input encoder.')
    if len(set(dims)) > 1:
      raise ValueError(f'Encoders have different output dimensions: {dims}')
    self.num_map_modalities = len(dims)
    width = dims[0]
    self.modality_fusion = None
    if len(dims) > 1:
      self.modality_fusion = VerticalPooling(config.modality_fusion, dtype,
                                             (len(dims), width))
      width = self.modality_fusion.out_dim
    self.bev_net = None
    if config.bev_net is not None:
      nmid = config.bev_net.nmid
      if nmid is None:
        # A unit of nmid=None widens to 4 * (C // 4): a width that is not
        # a multiple of 4 would change and lose the identity residual
        # (``snap_tpu/models/bev_mapper.py:312-320`` asserts).
        if width % 4:
          raise ValueError(f'bev_net needs a fused plane width divisible by '
                           f'4 (got {width}); set bev_net.nmid.')
        nmid = width // 4
      self.bev_net = resnet.ResNetStage(config.bev_net.num_units, width, nmid,
                                        dtype)
      width = nmid * 4
    self.feature_dim = width  # the fused plane's width
    self.matching_proj = None
    if config.matching_dim is not None:
      self.matching_proj = layers.Dense(width, config.matching_dim, dtype)
    self.confidence_head = None
    if config.add_confidence:
      self.confidence_head = layers.Dense(width, 1, dtype)

  def num_z(self) -> int:
    """The street-view column's levels (``ceil`` keeps the reference's
    ``arange(0, h, cell)`` count for heights the cell does not divide)."""
    return math.ceil(self.config.scene_z_height / self.grid.cell_size - 1e-9)

  def sample_z_jitter(self, batch: int, generator: torch.Generator,
                      device: torch.device) -> Optional[Tensor]:
    """The query's z floor moves by U(lo, hi) per example."""
    if self.config.scene_z_offset_range is None:
      return None
    lo, hi = self.config.scene_z_offset_range
    return (lo + (hi - lo) * torch.rand(batch, generator=generator)).to(device)

  def sample_modality_keep(self, batch: int, generator: torch.Generator,
                           device: torch.device) -> Optional[Tensor]:
    """Each (map modality, example) is kept with p = 0.5; an example that
    would lose every modality keeps them all
    (``snap_tpu/models/bev_mapper.py:267-276``)."""
    if not (self.config.apply_modality_dropout
            and self.num_map_modalities > 1):
      return None
    keep = torch.rand((self.num_map_modalities, batch),
                      generator=generator) < 0.5
    return (keep | ~keep.any(0)).to(device)

  def sample_draws(self, batch: int, generator: torch.Generator,
                   device: torch.device) -> TrainDraws:
    """Draw one training forward's randomness on the CPU ``generator``:
    the query's z jitter, then the map's modality dropout."""
    z_jitter = self.sample_z_jitter(batch, generator, device)
    keep = self.sample_modality_keep(batch, generator, device)
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
    num_z = self.num_z()
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

  @staticmethod
  def _raster_plane(pyramid: types.FeatureImagePyramid) -> Dict[str, Any]:
    features = pyramid.features[-1]
    valid = torch.ones(features.shape[:-1], dtype=torch.bool,
                       device=features.device)
    return {'feature_plane': types.FeaturePlane(features=features, valid=valid)}

  def encode_aerial(self, aerial_rgb: Tensor) -> Dict[str, Any]:
    return self._raster_plane(self.aerial_encoder(aerial_rgb))

  def encode_semantics(self, semantic_raster: Tensor) -> Dict[str, Any]:
    return self._raster_plane(self.semantic_encoder(semantic_raster))

  def fuse_neural_maps(self, planes: List[types.FeaturePlane],
                       keep: Optional[Tensor] = None) -> types.FeaturePlane:
    """``modality_fusion`` over the modalities stacked as a column;
    ``keep [M, B]`` drops some."""
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
    if self.semantic_encoder is not None and 'rasters' in data:
      pred['semantic'] = self.encode_semantics(data['rasters']['semantics'])
      planes.append(pred['semantic']['feature_plane'])
    if not planes:
      raise ValueError('No map encoder given.')
    pred['bev_features'] = plane = self.fuse_neural_maps(planes, keep)
    if self.bev_net is not None:
      f = self.bev_net(plane.features)
      # The convs smear into the invalid cells: zero them again.
      f = torch.where(plane.valid[..., None], f, 0)
      pred['bev_features'] = plane = types.FeaturePlane(features=f,
                                                        valid=plane.valid)
    if self.matching_proj is not None:
      f = self.matching_proj(plane.features)
      if self.config.normalize_matching_features:
        f = layers.normalize(f)
      f = torch.where(plane.valid[..., None], f, 0)
      pred['bev_matching'] = types.FeaturePlane(features=f, valid=plane.valid)
    if self.confidence_head is not None:
      scores = self.confidence_head(plane.features)[..., 0]
      conf = F.logsigmoid(scores.float())
      pred['bev_confidence'] = torch.where(plane.valid, conf, 0)
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
    warn_config_diff(self.config, pathlib.Path(path))
    return checkpoints.load_subtree(self, path, 'bev_mapper')


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
