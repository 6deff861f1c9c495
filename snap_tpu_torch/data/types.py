"""Data schema: scene/pairing/raster/lidar configuration dataclasses.

A copy of ``snap_tpu/data/types.py`` (the port imports nothing of the JAX
package).

Mirrors the reference builder contract (snap/data/types.py) — including the
pieces the public release stripped (RastersConfig, LidarConfig are referenced
there but undefined; reconstructed here from their call sites in
snap/data/loader.py:347-349,431-432).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Dict, Optional, Tuple

DataDict = Dict[str, Any]

INVALID_GROUND_PLANE_HEIGHT = -1.0

AERIAL_BUILDING_CLASSES = ('buildings_raw', 'buildings_contoured')
SURFEL_ROAD_CLASSES = (
    'crosswalk',
    'sidewalk',
    'pavedroad',
    'stopline',
    'line',
    'otherlanemarking',
)

# Default class vocabulary of the synthetic builder: the surfel-road layers
# plus independent object layers, matching what the SNAP paper's rasters carry.
DEFAULT_SEMANTIC_MAP_CLASSES = SURFEL_ROAD_CLASSES + (
    'buildings_raw',
    'tree',
)
DEFAULT_GT_SEMANTIC_CLASSES = (
    'crosswalk', 'sidewalk', 'road', 'terrain', 'building',
    'fence', 'pole', 'tree',
    'traffic_sign', 'traffic_light', 'street_light',
    'line', 'stopline', 'otherlanemarking',
)


class DataMode(str, enum.Enum):
  SINGLE_SCENE = 'single_scene'
  PAIR_SCENES = 'pair_scenes'
  PAIR_SCENE_VIEW = 'pair_scene_view'


@dataclasses.dataclass
class SceneConfig:
  """Scene (grid and view) selection parameters."""

  grid_size: Tuple[int, int, int] = (24, 32, 12)
  grid_z_offset: int = 4
  center_grid_around_reference: bool = True
  num_views: int = 10
  min_distance_between_views: float = 1.5
  max_distance_between_views: float = 15
  only_views_in_grid: bool = True
  streetview_hfov_deg: float = 72.0
  camera_frustum_depth: float = 16.0


@dataclasses.dataclass
class PairingConfig:
  """Map/query pairing parameters."""

  min_overlap: float = 0.3
  max_overlap: float = 0.7
  min_distance_to_scene_views: Optional[float] = None
  max_elevation_diff: float = 2.0
  num_queries_per_scene: Optional[int] = None
  ratio_trekker: float = 0.5


@dataclasses.dataclass
class RastersConfig:
  """Raster channels attached to map scenes."""

  add_rgb: bool = True
  add_semantics: bool = True
  add_gt_semantics: bool = True
  resolution: float = 0.2
  semantic_classes: Tuple[str, ...] = DEFAULT_SEMANTIC_MAP_CLASSES
  gt_semantic_classes: Tuple[str, ...] = DEFAULT_GT_SEMANTIC_CLASSES


@dataclasses.dataclass
class LidarConfig:
  """Lidar ray supervision attached to map scenes."""

  num_rays: int = 10_000
  add_gt_semantics: bool = False


@dataclasses.dataclass
class ProcessingConfig:
  """Configuration for the entire data processing pipeline."""

  mode: DataMode = DataMode.SINGLE_SCENE
  scene_config: SceneConfig = dataclasses.field(default_factory=SceneConfig)
  pairing_config: PairingConfig = dataclasses.field(
      default_factory=PairingConfig)
  rasters_config: RastersConfig = dataclasses.field(
      default_factory=RastersConfig)
  lidar_config: LidarConfig = dataclasses.field(default_factory=LidarConfig)
  image_downsampling_factor: Optional[int] = None
  vehicle_types: Tuple[str, ...] = ('CAR', 'TREKKER')

  @classmethod
  def from_dict(cls, config_dict: Dict[str, Any]) -> 'ProcessingConfig':
    config_dict = dict(config_dict)
    if config_dict.pop('pair_scenes', False):
      config_dict['mode'] = DataMode.PAIR_SCENES
    elif 'mode' in config_dict:
      config_dict['mode'] = DataMode(config_dict['mode'])
    for key, sub_cls in (
        ('scene_config', SceneConfig),
        ('pairing_config', PairingConfig),
        ('rasters_config', RastersConfig),
        ('lidar_config', LidarConfig),
    ):
      value = config_dict.get(key, {})
      if not isinstance(value, sub_cls):
        config_dict[key] = sub_cls(**value)
    known = {f.name for f in dataclasses.fields(cls)}
    config_dict = {k: v for k, v in config_dict.items() if k in known}
    return cls(**config_dict)
