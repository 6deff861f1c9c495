"""Semantic BEV segmentation head on a (frozen) BEV mapper.

Port of ``snap_tpu/models/semantic_net.py``: an MLP or a Dense + ResNet
stage decoder over the mapper's fused plane, a random flip of each
example's plane in training, a class-balanced multiclass cross-entropy over
the area classes, and for the objects the mean of an exclusive multiclass
(with a void class) and an independent binary cross-entropy. The building
and tree labels come from the semantic map rasters
(``transfer_labels_from_pcm``).

The mapper is built without the rasters' classes, as the reference builds
it (``:131-135``), so a mapper with the semantic modality cannot be built
under this head (ROADMAP C22): the port raises there.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F

from snap_tpu_torch import configs
from snap_tpu_torch.models import base
from snap_tpu_torch.models import bev_mapper
from snap_tpu_torch.models import layers
from snap_tpu_torch.models import resnet
from snap_tpu_torch.utils import grids

Tensor = torch.Tensor


def balancing_weights(frequencies: Mapping[str, float],
                      classes: Sequence[str], binary: bool = False,
                      eps: float = 1e-3):
  """Inverse-frequency class weights (f64 numpy, then f32 as
  ``jnp.asarray`` gives them); a uniform distribution maps to all-1.

  Multiclass: the listed frequencies are renormalized to a distribution.
  Binary: each class is its own two-way problem, with a weight vector for
  the positives and one for the negatives. Rates are floored at ``eps``.
  """
  inv_count = 1.0 / len(classes)
  rate = np.asarray([frequencies[c] for c in classes], dtype=np.float64)
  f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32))
  if binary:
    pos = rate.clip(min=eps)
    return f32(inv_count / pos), f32(inv_count / (1.0 - pos).clip(min=eps))
  rate = (rate / rate.sum()).clip(min=eps)
  return f32(inv_count / rate)


def _per_class_recall(correct: Tensor, in_class: Tensor, valid: Tensor,
                      classes: Sequence[str], namespace: Optional[str]
                      ) -> Dict[str, Tensor]:
  """The share of valid in-class cells predicted correctly, per class."""
  recall = layers.masked_mean(correct, valid[..., None] & in_class,
                              axis=(1, 2))
  suffix = f'/{namespace}' if namespace else ''
  out = {f'recall/average{suffix}': recall.mean(-1)}
  out.update({f'recall/{c}': recall[..., i] for i, c in enumerate(classes)})
  return out


def multiclass_crossentropy_metrics(
    logits: Tensor, labels: Tensor, valid: Tensor, classes: Sequence[str],
    frequencies: Mapping[str, float], namespace: Optional[str] = None
) -> Tuple[Tensor, Dict[str, Tensor]]:
  """Class-balanced multiclass CE and the accuracy and recalls, per
  example (``optax.softmax_cross_entropy_with_integer_labels``)."""
  label_logits = logits.gather(-1, labels[..., None])[..., 0]
  cell_nll = torch.logsumexp(logits, -1) - label_logits
  if frequencies:
    weights = balancing_weights(frequencies, classes).to(logits.device)
    cell_nll = cell_nll * weights[labels]
  nll = layers.masked_mean(cell_nll, valid, axis=(1, 2))
  predicted_ok = torch.argmax(logits, -1) == labels
  gt_one_hot = labels[..., None] == torch.arange(logits.shape[-1],
                                                 device=labels.device)
  suffix = f'/{namespace}' if namespace else ''
  metrics = {
      f'accuracy{suffix}': layers.masked_mean(predicted_ok, valid, (1, 2)),
      **_per_class_recall(predicted_ok[..., None], gt_one_hot, valid,
                          classes, namespace),
  }
  return nll, metrics


def binary_crossentropy_metrics(
    logits: Tensor, gt_mask: Tensor, valid: Tensor, classes: Sequence[str],
    frequencies: Mapping[str, float], namespace: Optional[str] = None
) -> Tuple[Tensor, Dict[str, Tensor]]:
  """Class-balanced binary CE and the recalls, per example
  (``optax.sigmoid_binary_cross_entropy``)."""
  labels = gt_mask.to(logits.dtype)
  cell_nll = (-labels * F.logsigmoid(logits)
              - (1.0 - labels) * F.logsigmoid(-logits))
  if frequencies:
    w_pos, w_neg = balancing_weights(frequencies, classes, binary=True)
    cell_nll = cell_nll * torch.where(gt_mask, w_pos.to(logits.device),
                                      w_neg.to(logits.device))
  nll = layers.masked_mean(cell_nll.mean(-1), valid, axis=(1, 2))
  predicted_ok = (logits > 0) == gt_mask  # sigmoid(x) > .5  <=>  x > 0
  return nll, _per_class_recall(predicted_ok, gt_mask, valid, classes,
                                namespace)


def batched_raster_flip(raster: Tensor, flips: Tensor) -> Tensor:
  """Flip each example's two leading spatial axes where ``flips [B, 2]``."""
  for i in range(2):
    where = flips[:, i].reshape(-1, *(1,) * (raster.ndim - 1))
    raster = torch.where(where, raster.flip(i + 1), raster)
  return raster


class ResNetStageDecoder(nn.Module):
  """The ``'resnet_stage'`` decoder, flax's ``nn.Sequential`` of a Dense, a
  ``ResNetStage`` (its unit dict dropped by a lambda, index 2) and an MLP:
  children ``layers_0``, ``layers_1`` and ``layers_3``."""

  def __init__(self, in_features: int, dim: int, num_units: int,
               num_classes: int, dtype: torch.dtype):
    super().__init__()
    self.layers_0 = layers.Dense(in_features, dim, dtype)
    self.layers_1 = resnet.ResNetStage(num_units, dim, dim // 4, dtype)
    self.layers_3 = layers.MLP(configs.MLPConfig(layers=(dim, num_classes)),
                               dim, dtype)

  def forward(self, x: Tensor) -> Tensor:
    return self.layers_3(self.layers_1(self.layers_0(x)))


class SemanticNet(nn.Module):
  """Predict semantic rasters from a BEV neural map."""

  def __init__(self, config: configs.SemanticNetConfig, grid: grids.Grid2D,
               semantic_map_classes: Sequence[str],
               semantic_classes_gt: Sequence[str],
               dtype: torch.dtype = torch.float32):
    super().__init__()
    if config.bev_mapper.semantic_encoder is not None:
      raise ValueError(
          'SemanticNet builds its BEVMapper without semantic_map_classes, as '
          'the reference does (snap_tpu/models/semantic_net.py:131-135), so '
          'a mapper with the semantic modality cannot run under it '
          '(ROADMAP C22).')
    self.config = config
    self.semantic_map_classes = tuple(semantic_map_classes)
    self.gt_indices = {c: i for i, c in enumerate(semantic_classes_gt)}
    self.bev_mapper = bev_mapper.BEVMapper(config.bev_mapper, grid, dtype)
    self.object_classes = (tuple(config.object_classes_exclusive)
                           + tuple(config.object_classes_independent))
    num_classes = len(config.area_classes)
    if self.object_classes:
      num_classes += len(self.object_classes) + 1  # + void
    dim, in_features = config.decoder_dim, self.bev_mapper.feature_dim
    if config.decoder_type == 'mlp':
      self.decoder = layers.MLP(configs.MLPConfig(
          layers=(dim,) * config.mlp_num_layers + (num_classes,)),
                                in_features, dtype)
    elif config.decoder_type == 'resnet_stage':
      self.decoder = ResNetStageDecoder(in_features, dim,
                                        config.resnet_num_units,
                                        num_classes, dtype)
    else:
      raise ValueError(f'Unknown {config.decoder_type}')

  def sample_draws(self, batch_size: int, generator: torch.Generator,
                   device: torch.device) -> bev_mapper.TrainDraws:
    """The mapper's draws (modality dropout), then the flips: each
    (example, spatial axis) with p = 0.5."""
    draws = self.bev_mapper.sample_draws(batch_size, generator, device)
    if self.config.apply_random_flip:
      flips = torch.rand((batch_size, 2), generator=generator) < 0.5
      draws = draws._replace(flips=flips.to(device))
    return draws

  def forward(self, data: base.Batch, train: bool = False,
              generator: Optional[torch.Generator] = None,
              draws: Optional[bev_mapper.TrainDraws] = None
              ) -> base.Predictions:
    if 'map' in data:
      data = data['map']
    if train and draws is None:
      if generator is None:
        raise ValueError('train=True needs a generator or draws')
      device = data['T_view2scene'].t.device
      draws = self.sample_draws(data['T_view2scene'].t.shape[0], generator,
                                device)
    # Exact when the whole mapper is frozen (``bev_mapper/``): nothing
    # upstream of the cut takes a gradient.
    with (torch.no_grad() if self.config.stop_mapper_gradients
          else contextlib.nullcontext()):
      pred = self.bev_mapper(data, train=train, draws=draws)
    pred['draws'] = draws
    plane = pred['bev_features']
    features, valid = plane.features, plane.valid
    flips = None
    if train and self.config.apply_random_flip:
      flips = draws.flips.to(features.device)
      features = batched_raster_flip(features, flips)
      valid = batched_raster_flip(valid, flips)
    logits = self.decoder(features).float()
    logits = torch.where(valid[..., None], logits, 0)
    if flips is not None:
      logits = batched_raster_flip(logits, flips)
    num_areas = len(self.config.area_classes)
    pred['logits_areas'] = logits[..., :num_areas]
    if self.object_classes:
      split = num_areas + len(self.config.object_classes_exclusive) + 1
      pred['logits_objects_exclusive'] = logits[..., num_areas:split]
      pred['logits_objects_independent'] = logits[..., split:]
    return pred

  def transfer_labels_from_pcm(self, masks: Tensor,
                               masks_pcm: Tensor) -> Tensor:
    """The building and tree GT layers overwritten by the semantic map
    rasters' ``buildings_raw`` and ``tree``."""
    indices_pcm = {c: i for i, c in enumerate(self.semantic_map_classes)}
    masks = masks.clone()
    for name_gt, name_pcm in (('building', 'buildings_raw'),
                              ('tree', 'tree')):
      if name_gt in self.gt_indices and name_pcm in indices_pcm:
        masks[..., self.gt_indices[name_gt]] = (
            masks_pcm[..., indices_pcm[name_pcm]])
    return masks

  def _create_exclusive_labels(self, masks_all: Tensor,
                               classes: Sequence[str],
                               add_void: bool = False
                               ) -> Tuple[Tensor, Tensor]:
    """Per cell, the first of ``classes`` present (``'line'`` standing for
    every lane marking not listed), and whether any is; the void class
    ``len(classes)`` where none is, with ``add_void``."""
    masks = masks_all[..., [self.gt_indices[c] for c in classes]]
    if 'line' in classes:
      mask_line = masks_all[..., self.gt_indices['line']]
      for c in ('stopline', 'otherlanemarking'):
        if c in self.gt_indices and c not in classes:
          mask_line = mask_line | masks_all[..., self.gt_indices[c]]
      masks[..., list(classes).index('line')] = mask_line
    valid = masks.any(-1)
    # torch.argmax takes no bool; it returns the first of tied maxima.
    labels = torch.argmax(masks.to(torch.uint8), -1)
    if add_void:
      labels = torch.where(valid, labels, len(classes))
    return labels, valid

  def create_object_labels(self, masks: Tensor) -> Tuple[Tensor, Tensor]:
    labels_excl, _ = self._create_exclusive_labels(
        masks, self.config.object_classes_exclusive, add_void=True)
    masks_indep = masks[..., [self.gt_indices[c] for c in
                              self.config.object_classes_independent]]
    return labels_excl, masks_indep

  def loss_metrics_function(self, pred: base.Predictions, data: base.Batch
                            ) -> base.LossMetricsTuple:
    """Per-example losses (the total ``(areas + (exclusive +
    independent) / 2) / 2``) and metrics, under ``semantics/``."""
    if 'map' in data:
      data = data['map']
    masks = self.transfer_labels_from_pcm(data['rasters']['gt_semantics'],
                                          data['rasters']['semantics'])
    config = self.config
    plane_valid = pred['bev_features'].valid
    labels, valid = self._create_exclusive_labels(masks, config.area_classes)
    nll_areas, metrics = multiclass_crossentropy_metrics(
        pred['logits_areas'], labels, plane_valid & valid,
        config.area_classes, dict(config.area_frequencies or []))
    losses = {'nll_areas': nll_areas}
    total = nll_areas
    if 'logits_objects_exclusive' in pred:
      labels_excl, masks_indep = self.create_object_labels(masks)
      frequencies = dict(config.object_frequencies or [])
      nll_excl, metrics_excl = multiclass_crossentropy_metrics(
          pred['logits_objects_exclusive'], labels_excl, plane_valid,
          (*config.object_classes_exclusive, 'void'), frequencies,
          namespace='excl')
      nll_indep, metrics_indep = binary_crossentropy_metrics(
          pred['logits_objects_independent'], masks_indep, plane_valid,
          config.object_classes_independent, frequencies, namespace='indep')
      total = (total + (nll_excl + nll_indep) / 2) / 2
      losses['nll_objects_exclusive'] = nll_excl
      losses['nll_objects_indep'] = nll_indep
      metrics.update(metrics_excl)
      metrics.update(metrics_indep)
    losses['total'] = total
    return losses, {f'semantics/{k}': v for k, v in metrics.items()}

  def pack_evaluation_metrics(self, metrics: base.MetricsDict,
                              losses: base.LossDict, data: base.Batch,
                              pred: base.Predictions) -> base.MetricsDict:
    """An evaluation's per-example row: the metrics, the loss and the
    count of each GT layer's cells (``gt_counts/<class>``)."""
    del pred
    if 'map' in data:
      data = data['map']
    counts = data['rasters']['gt_semantics'].sum((-3, -2))
    classes = sorted(self.gt_indices, key=self.gt_indices.get)
    return {**metrics, 'loss': losses['total'],
            **{f'gt_counts/{c}': counts[..., i]
               for i, c in enumerate(classes)}}


def build(config: configs.SemanticNetConfig, meta_data: Dict[str, Any],
          dtype: torch.dtype) -> SemanticNet:
  """The registry's builder (``SemanticNetModel.build_flax_model``)."""
  return SemanticNet(config, meta_data['grid'].bev(),
                     meta_data['semantic_map_classes'],
                     meta_data['semantic_classes_gt'], dtype)
