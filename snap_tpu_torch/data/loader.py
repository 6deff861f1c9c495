"""Synthetic map/query batches as torch tensors with typed geometry.

The port's counterpart of the host path of ``snap_tpu/data/loader.py``: a
``SyntheticSceneGenerator`` configured and seeded as the JAX loader
configures and seeds it (``split_generator``), examples stacked with numpy,
and pose/intrinsics dicts wrapped into ``Transform3D`` / ``FisheyeCamera``
on the requested device.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Union

import numpy as np
import torch

from snap_tpu_torch import configs
from snap_tpu_torch.data import synthetic
from snap_tpu_torch.data import types
from snap_tpu_torch.utils import geometry
from snap_tpu_torch.utils import grids

DataDict = Dict[str, Any]
Device = Union[str, torch.device]


# The seed salt of each split (``snap_tpu/data/loader.py:get_dataset``).
SPLIT_SALTS = {'train': 0, 'eval': 1}


def location_seed(location: Optional[str], base_seed: int) -> int:
  """Stable per-location seed so pseudo-cities have disjoint content
  (a copy of ``snap_tpu/data/loader.py:location_seed``)."""
  if not location:
    return base_seed
  h = 0
  for ch in str(location):
    h = (h * 131 + ord(ch)) % (2**31)
  return (base_seed * 1_000_003 + h) % (2**31)


def make_generator(data_config: configs.DataConfig, seed: int,
                   location: Optional[str] = None
                   ) -> synthetic.SyntheticSceneGenerator:
  """The scene generator with the JAX loader's settings for ``data_config``,
  seeded with ``location_seed(location, seed)`` (``seed`` itself when there
  is no location)."""
  return synthetic.SyntheticSceneGenerator(
      scene_config=types.SceneConfig(num_views=data_config.num_views),
      rasters_config=types.RastersConfig(resolution=data_config.voxel_size),
      lidar_config=types.LidarConfig(),
      pairing_config=types.PairingConfig(),
      image_hw=tuple(data_config.image_size),
      voxel_size=data_config.voxel_size,
      seed=location_seed(location, seed),
  )


def split_generator(data_config: configs.DataConfig,
                    split: str) -> synthetic.SyntheticSceneGenerator:
  """The ``'train'`` or ``'eval'`` generator of the JAX loader for this
  config: seeded with ``location_seed(location, shuffle_seed + salt)``, the
  eval split's location defaulting to the training one
  (``snap_tpu/data/loader.py:294-303``, ``:335-336``)."""
  locations = data_config.locations
  location = locations.training
  if split == 'eval':
    location = locations.evaluation or locations.training
  return make_generator(data_config,
                        data_config.shuffle_seed + SPLIT_SALTS[split],
                        location)


def map_grid(data_config: configs.DataConfig) -> grids.Grid3D:
  return grids.Grid3D.from_extent_meters(types.SceneConfig().grid_size,
                                         data_config.voxel_size)


def stack_examples(examples: Sequence[DataDict]) -> DataDict:
  """Stack a list of nested example dicts leaf by leaf (numpy)."""
  first = examples[0]
  if isinstance(first, dict):
    return {k: stack_examples([e[k] for e in examples]) for k in first}
  if isinstance(first, str):
    return np.asarray(examples)
  return np.stack(examples)


def make_pair_examples(generator: synthetic.SyntheticSceneGenerator,
                       indices: Sequence[int],
                       data_config: configs.DataConfig) -> DataDict:
  """Stacked numpy ``pair_scene_view`` examples (map scene + query view)."""
  return stack_examples([
      generator.make_example(
          i, types.DataMode.PAIR_SCENE_VIEW,
          add_images=data_config.add_images,
          add_rasters=data_config.add_rasters)
      for i in indices])


def make_train_examples(generator: synthetic.SyntheticSceneGenerator,
                        step: int, batch_size: int,
                        data_config: configs.DataConfig) -> DataDict:
  """Training batch ``step``: examples ``step * batch_size + k`` (fresh ones
  every step, as the JAX loader indexes them), with ``batch_mask`` = 1."""
  start = step * batch_size
  batch = make_pair_examples(generator, range(start, start + batch_size),
                             data_config)
  batch['batch_mask'] = np.ones(batch_size, np.float32)
  return batch


def _scene_to_torch(scene: DataDict, device: Device) -> DataDict:
  out: DataDict = {
      'images': torch.as_tensor(scene['images'], device=device),
      'camera': geometry.FisheyeCamera.from_dict(scene['camera'], device),
      'T_view2scene': geometry.Transform3D(
          R=torch.as_tensor(scene['T_view2scene']['R'], device=device),
          t=torch.as_tensor(scene['T_view2scene']['t'], device=device)),
  }
  if 'rasters' in scene:
    out['rasters'] = {'rgb': torch.as_tensor(scene['rasters']['rgb'],
                                             device=device)}
  return out


def pair_batch_to_torch(batch: DataDict, device: Device) -> DataDict:
  """Stacked numpy pair examples -> tensors and typed geometry on ``device``."""
  out = {
      'map': _scene_to_torch(batch['map'], device),
      'query': _scene_to_torch(batch['query'], device),
      'T_query2map': geometry.Transform3D(
          R=torch.as_tensor(batch['T_query2map']['R'], device=device),
          t=torch.as_tensor(batch['T_query2map']['t'], device=device)),
  }
  if 'batch_mask' in batch:
    out['batch_mask'] = torch.as_tensor(batch['batch_mask'], device=device)
  return out
