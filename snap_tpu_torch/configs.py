"""Configs of the port as plain dataclasses.

Values are copied from ``snap_tpu/configs/defaults.py`` and
``bench.py:build_config``; field names are the JAX config's keys, so a test
can hold the two side by side (tests/test_torch_localizer.py).

- ``bench_full()``: the flagship serving path — R50 street-view + aerial
  mapper, 20 views of 180x240, 0.2 m voxels (a 120x160x60 grid), top-k 4
  streamed lift, exhaustive pose backend with 64 rotations and dense
  refinement, bf16 compute.
- ``smoke_exhaustive()``: ``snap_tpu/configs/smoke_localization.py`` with
  ``pose_backend=exhaustive`` (tiny ResNet, dim 32, 3 views, top-k 2,
  16 rotations), f32 compute.
- ``train_full1chip_exhaustive()``: ``snap_tpu/configs/
  train_localization.py`` with ``scale=full1chip,pose_backend=exhaustive``
  — ``bench_full``'s model at the same widths, trained at batch 2 with z
  jitter on the query, modality dropout, Adam and a warmup + cosine
  schedule; no grid refinement.
- ``smoke_train_exhaustive()``: ``smoke_exhaustive`` with the training
  settings of ``smoke_localization.py`` (constant lr 1e-3, clipping at 1).
- ``smoke_eval_ransac()``: ``smoke_localization.py`` (RANSAC backend, the
  in-FoV query points, 64 pose samples x 2 retries) merged with
  ``smoke_eval_localization.py`` (grid refinement, batch 2, f32).
- ``eval_full1chip_ransac()``: ``train_localization.py:scale=full1chip``
  (whose default backend is RANSAC) merged with ``eval_localization.py``
  as ``snap_tpu/evaluator.py:get_model_and_dataset`` merges them: batch 4,
  f32, 20,000 pose samples x 8 retries, grid refinement.

``DataConfig.locations`` and ``shuffle_seed`` seed the scene generator as
``snap_tpu/data/loader.py:get_dataset`` does (``data/loader.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union


# ``defaults.base().shuffle_seed``, the experiments' data seed.
SHUFFLE_SEED = 1234567
# ``train_localization.py:121-132``: the joined training cities.
TRAIN_LOCATIONS = ','.join(f'{c}-synthetic' for c in (
    'barcelona', 'london', 'paris', 'manhattan', 'sanfrancisco', 'brooklyn',
    'manila', 'singapore', 'taiwan', 'tokyo1', 'rio', 'sydney'))


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
  width: int = 1
  depth: Union[int, Tuple[int, ...]] = 50
  limit_num_blocks: Optional[int] = 4
  skip_root_block: bool = False


@dataclasses.dataclass(frozen=True)
class ImageEncoderConfig:
  encoder: ResNetConfig = ResNetConfig()
  output_dim: int = 128
  num_pyr_levels: Optional[int] = None
  encoder_name: str = 'resnet'


@dataclasses.dataclass(frozen=True)
class MLPConfig:
  layers: Optional[Tuple[int, ...]] = None
  activation: str = 'relu'
  apply_input_activation: bool = False


@dataclasses.dataclass(frozen=True)
class StreetViewEncoderConfig:
  image_encoder: ImageEncoderConfig = ImageEncoderConfig()
  feature_dim: int = 128
  fusion: MLPConfig = MLPConfig(layers=(256, 128))
  proj_mlp: MLPConfig = MLPConfig(apply_input_activation=True)
  do_weighted_fusion: bool = True
  num_scale_bins: int = 32
  top_k_view_selection: int = 4
  depth_min_max: Tuple[float, float] = (1.0, 32.0)
  fusion_add_minmax: bool = False
  fusion_use_variance: bool = True
  max_view_distance: Optional[float] = None
  pooling_impl: str = 'stream'


@dataclasses.dataclass(frozen=True)
class VerticalPoolingConfig:
  pooling: str = 'max'


@dataclasses.dataclass(frozen=True)
class BEVMapperConfig:
  streetview_encoder: Optional[StreetViewEncoderConfig] = (
      StreetViewEncoderConfig())
  aerial_encoder: Optional[ImageEncoderConfig] = ImageEncoderConfig(
      encoder=ResNetConfig(skip_root_block=True))
  scene_z_offset: float = 4.0
  scene_z_height: float = 12.0
  pooling: VerticalPoolingConfig = VerticalPoolingConfig()
  modality_fusion: VerticalPoolingConfig = VerticalPoolingConfig()
  matching_dim: Optional[int] = 32
  normalize_matching_features: bool = True
  add_confidence: bool = False
  # Training only: U(lo, hi) jitter of the query's z column floor, and
  # dropping each map modality with p = 0.5 (never all of an example's).
  scene_z_offset_range: Optional[Tuple[float, float]] = (-2.0, 2.0)
  apply_modality_dropout: bool = True


@dataclasses.dataclass(frozen=True)
class BEVLocalizerConfig:
  bev_mapper: BEVMapperConfig = BEVMapperConfig()
  add_confidence_query: bool = False
  add_confidence_map: bool = False
  mask_score_out_of_bounds: bool = False
  clip_negative_scores: bool = True
  add_temperature: bool = True
  init_temperature: float = 2.0
  num_pose_samples: Optional[int] = None
  num_pose_sampling_retries: int = 1
  query_frustum_depth: float = 16.0
  filter_points_in_fov: bool = False
  threshold_remove_accurate_poses: Optional[Tuple[float, float]] = None
  do_grid_refinement: bool = False
  pose_backend: str = 'ransac'
  num_rotations: int = 64
  dense_refinement_stages: Tuple[Tuple[float, float], ...] = ((5.0, 0.25),)
  subcell_refinement: bool = False


@dataclasses.dataclass(frozen=True)
class LocationsConfig:
  """The pseudo-cities that seed the train and eval scene generators."""

  training: Optional[str] = None
  evaluation: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class DataConfig:
  """Synthetic-scene settings (``defaults.streetview_singlescene``).

  ``shuffle_seed`` is what the JAX loader is given as ``shuffle_seed``: the
  experiment's for training, the eval config's ``data.rng_seed`` for
  evaluation. ``on_device_generation`` None makes the batches on the
  entry point's device when it is a CUDA card and on the host otherwise
  (``data/loader.py:get_dataset``). ``num_workers`` threads build the host
  path's batches; the device path builds each batch in the consumer's
  thread and stream.
  """

  num_views: int = 10
  image_size: Tuple[int, int] = (180, 240)
  voxel_size: float = 0.2
  add_images: bool = True
  add_rasters: bool = True
  add_lidar_rays: bool = False
  num_rays: Optional[int] = None
  mode: str = 'pair_scene_view'
  evaluation_size: int = 1024
  num_workers: int = 2
  prefetch_buffer_size: int = 2
  on_device_generation: Optional[bool] = None
  locations: LocationsConfig = LocationsConfig()
  shuffle_seed: int = 0


@dataclasses.dataclass(frozen=True)
class LrConfig:
  """``lr_configs`` of ``defaults.base()``: a product of named factors."""

  factors: str = 'constant'
  base_learning_rate: float = 1e-3
  warmup_steps: int = 0
  start_decay_step: int = 0
  steps_per_cycle: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
  """``optimizer_configs`` of ``defaults.base()``."""

  optimizer: str = 'adam'
  weight_decay: float = 0.0
  freeze_params_reg_exp: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class TrainConfig:
  lr_configs: LrConfig = LrConfig()
  optimizer_configs: OptimizerConfig = OptimizerConfig()
  max_grad_norm: Optional[float] = None
  num_training_steps: int = 8


@dataclasses.dataclass(frozen=True)
class Config:
  model: BEVLocalizerConfig
  data: DataConfig
  dtype_str: str = 'bfloat16'
  batch_size: int = 1
  train: TrainConfig = TrainConfig()


def bench_full(batch_size: int = 1) -> Config:
  """``bench.py:build_config``: the exhaustive-backend serving path."""
  model = BEVLocalizerConfig(
      pose_backend='exhaustive',
      num_rotations=64,
      filter_points_in_fov=False,
      clip_negative_scores=False,
      do_grid_refinement=True,
  )
  data = DataConfig(num_views=20, image_size=(180, 240), voxel_size=0.2,
                    evaluation_size=1,
                    locations=LocationsConfig(training='bench-city'))
  return Config(model=model, data=data, dtype_str='bfloat16',
                batch_size=batch_size)


def _tiny_resnet(skip_root_block: bool = False) -> ResNetConfig:
  return ResNetConfig(depth=(1, 1), limit_num_blocks=2,
                      skip_root_block=skip_root_block)


def smoke_exhaustive(batch_size: int = 2) -> Config:
  """``configs/smoke_localization.py`` with ``pose_backend=exhaustive``."""
  dim = 32
  streetview = StreetViewEncoderConfig(
      image_encoder=ImageEncoderConfig(encoder=_tiny_resnet(),
                                       output_dim=dim),
      feature_dim=dim,
      fusion=MLPConfig(layers=(dim * 2, dim)),
      num_scale_bins=8,
      top_k_view_selection=2,
  )
  aerial = ImageEncoderConfig(encoder=_tiny_resnet(skip_root_block=True),
                              output_dim=dim)
  mapper = BEVMapperConfig(streetview_encoder=streetview,
                           aerial_encoder=aerial, matching_dim=16)
  model = BEVLocalizerConfig(
      bev_mapper=mapper,
      pose_backend='exhaustive',
      num_rotations=16,
      filter_points_in_fov=False,
      num_pose_samples=64,
      num_pose_sampling_retries=2,
  )
  data = DataConfig(num_views=3, image_size=(36, 48), voxel_size=1.0,
                    evaluation_size=4,
                    locations=LocationsConfig(training='smoke-city'),
                    shuffle_seed=SHUFFLE_SEED)
  return Config(model=model, data=data, dtype_str='float32',
                batch_size=batch_size)


def train_full1chip_exhaustive(batch_size: int = 2) -> Config:
  """``train_localization.py:scale=full1chip,pose_backend=exhaustive``.

  The JAX config also sets ``point_tile=288_000``: a memory device of the
  XLA program (rematerialized point tiles), numerically neutral, that the
  port's lift backward does without.
  """
  serve = bench_full(batch_size)
  lr = LrConfig(factors='constant * linear_warmup * cosine_decay',
                base_learning_rate=2e-4, warmup_steps=1_000,
                start_decay_step=4_000, steps_per_cycle=16_000)
  train = TrainConfig(lr_configs=lr, max_grad_norm=1.0,
                      num_training_steps=20_000)
  data = dataclasses.replace(
      serve.data, shuffle_seed=SHUFFLE_SEED, evaluation_size=32,
      locations=LocationsConfig(training=TRAIN_LOCATIONS))
  return dataclasses.replace(
      serve,
      model=dataclasses.replace(serve.model, do_grid_refinement=False,
                                num_pose_samples=10_000,
                                num_pose_sampling_retries=8),
      data=data, train=train)


def smoke_train_exhaustive(batch_size: int = 2) -> Config:
  """``smoke_exhaustive`` with ``smoke_localization.py``'s training setup."""
  lr = LrConfig(factors='constant', base_learning_rate=1e-3)
  return dataclasses.replace(
      smoke_exhaustive(batch_size),
      train=TrainConfig(lr_configs=lr, max_grad_norm=1.0,
                        num_training_steps=8))


def _eval_data(train_data: DataConfig, location: str,
               evaluation_size: int) -> DataConfig:
  """``evaluator.py:get_model_and_dataset``: the experiment's scene keys,
  the eval config's seed (``data.rng_seed`` = 0) and evaluation size, and
  one location for both splits."""
  return dataclasses.replace(
      train_data, shuffle_seed=0, evaluation_size=evaluation_size,
      locations=LocationsConfig(training=location, evaluation=location))


def smoke_eval_ransac(batch_size: int = 2) -> Config:
  """``smoke_localization.py`` (RANSAC) under ``smoke_eval_localization.py``:
  the in-FoV query points, 64 samples x 2 retries, grid refinement, f32,
  evaluated on 'smokeville-synthetic_eval'."""
  smoke = smoke_exhaustive(batch_size)
  model = dataclasses.replace(
      smoke.model, pose_backend='ransac', filter_points_in_fov=True,
      num_pose_samples=64, num_pose_sampling_retries=2,
      do_grid_refinement=True)
  return dataclasses.replace(
      smoke, model=model,
      data=_eval_data(smoke.data, 'smokeville-synthetic_eval', 4))


def eval_full1chip_ransac(batch_size: int = 4) -> Config:
  """``train_localization.py:scale=full1chip`` (RANSAC, its default backend)
  under ``eval_localization.py``: R50 street-view + aerial mapper, 20 views
  of 180x240, 0.2 m voxels, top-k 4 lift, 20,000 pose samples x 8 retries,
  grid refinement, batch 4, f32, evaluated on the first test city,
  'osaka-synthetic_eval'."""
  train = train_full1chip_exhaustive(batch_size)
  model = dataclasses.replace(
      train.model, pose_backend='ransac', filter_points_in_fov=True,
      clip_negative_scores=True, num_pose_samples=20_000,
      num_pose_sampling_retries=8, do_grid_refinement=True)
  return dataclasses.replace(
      train, model=model, dtype_str='float32',
      data=_eval_data(train.data, 'osaka-synthetic_eval', 4096))


CONFIGS = {
    'bench_full': bench_full,
    'smoke_exhaustive': smoke_exhaustive,
    'train_full1chip_exhaustive': train_full1chip_exhaustive,
    'smoke_train_exhaustive': smoke_train_exhaustive,
    'smoke_eval_ransac': smoke_eval_ransac,
    'eval_full1chip_ransac': eval_full1chip_ransac,
}


def get_config(name: str, **kwargs) -> Config:
  if name not in CONFIGS:
    raise ValueError(f'Unknown config {name!r}; choose from {sorted(CONFIGS)}')
  return CONFIGS[name](**kwargs)
