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
- ``train_full1chip_ransac()``: ``train_localization.py:scale=full1chip``
  with its default backend, RANSAC: ``train_full1chip_exhaustive``'s model
  and schedule with the in-FoV query points, clipped scores and 10,000
  pose samples x 8 retries.
- ``smoke_train_ransac()``: ``smoke_localization.py`` (RANSAC, its
  default) with ``smoke_train_exhaustive``'s training setup.
- ``smoke_eval_ransac()``: ``smoke_localization.py`` (RANSAC backend, the
  in-FoV query points, 64 pose samples x 2 retries) merged with
  ``smoke_eval_localization.py`` (grid refinement, batch 2, f32).
- ``eval_full1chip_ransac()``: ``train_localization.py:scale=full1chip``
  (whose default backend is RANSAC) merged with ``eval_localization.py``
  as ``snap_tpu/evaluator.py:get_model_and_dataset`` merges them: batch 4,
  f32, 20,000 pose samples x 8 retries, grid refinement.

- ``eval_full1chip_exhaustive()``: the held-out protocol, the flagship
  run (``train_full1chip_exhaustive``) under ``eval_localization.py:
  evaluation_size=256,batch_size=4``: dense refinement, f32, batch 4.
- ``train_semantics()`` / ``train_occupancy()``: the semantic BEV head and
  the lidar-supervised occupancy head (``model_name`` ``semantic_net`` /
  ``occupancy_net``) on a frozen mapper / street-view encoder,
  ``configs/train_semantics.py`` and ``train_occupancy.py``;
  ``smoke_semantics()`` / ``smoke_occupancy()`` their tiny counterparts,
  trained whole. The localizer configs take ``modalities`` (the semantic
  rasters as a third map modality; ``aerial[+semantic]``, a map without
  street views whose query goes through a street-view mapper of its own,
  ``bev_mapper_query``) and ``bev_net`` (the residual stage over the map's
  fused plane).

``DataConfig.locations`` and ``shuffle_seed`` seed the scene generator as
``snap_tpu/data/loader.py:get_dataset`` does (``data/loader.py``).

An evaluation of an experiment (``snap_tpu/evaluator.py``) takes an
``EvalConfig`` (``eval_localization()``, ``smoke_eval_localization()``,
``eval_semantics()``)
and the experiment's ``Config``, which ``from_reference`` reads from the
reference's config dict (``to_reference`` writes one), and
``merge_eval_config`` gives the config it runs.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import typing
from typing import Any, Dict, Mapping, Optional, Tuple, Union


# ``defaults.base().shuffle_seed``, the experiments' data seed.
SHUFFLE_SEED = 1234567
# ``defaults.py:22-30``: the cities of each split.
DATA_SPLITS_CITIES = {
    'train': ('barcelona', 'london', 'paris', 'manhattan', 'sanfrancisco',
              'brooklyn', 'manila', 'singapore', 'taiwan', 'tokyo1', 'rio',
              'sydney'),
    'test': ('osaka', 'amsterdam', 'mexico', 'melbourne', 'saopaulo',
             'seattle'),
}
# ``train_localization.py:121-132``: the joined training cities.
TRAIN_LOCATIONS = ','.join(f'{c}-synthetic'
                           for c in DATA_SPLITS_CITIES['train'])


def _warm_start_field():
  """Where a module's initial weights are read from (``pretrained_path``).

  Read by the trainer's init only (``trainer.update_pretrained_variables``);
  an evaluation reads the trained weights. It is where a run started, not
  part of what the config computes, so configs that differ only here
  compare equal (an export that continued another run is its recipe's
  config).
  """
  return dataclasses.field(default=None, compare=False)


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
  """``defaults.resnet()``. ``checkpoint_units`` rematerializes each
  residual unit in the backward, ``checkpoint_blocks`` the root block and
  each stage whose units are not (``models/resnet.py``): less memory for
  a second forward, the same numbers."""

  width: int = 1
  depth: Union[int, Tuple[int, ...]] = 50
  limit_num_blocks: Optional[int] = 4
  skip_root_block: bool = False
  checkpoint_blocks: bool = False
  checkpoint_units: bool = False
  # A big_vision BiT ``.npz`` (``models/resnet.py:load_pretrained_variables``).
  pretrained_path: Optional[str] = _warm_start_field()


# ``defaults.py:166-193``: the named trunks. R152x2 stops after its third
# stage (1,024 x 2 channels at stride 16) and, like R101, rematerializes.
RESNETS = {
    'R50': ResNetConfig(),
    'R152x2': ResNetConfig(width=2, depth=152, limit_num_blocks=3,
                           checkpoint_blocks=True, checkpoint_units=True),
    'R101': ResNetConfig(depth=101, checkpoint_blocks=True,
                         checkpoint_units=True),
    'R26': ResNetConfig(depth=26),
    # Small config for tests and CPU smoke runs.
    'tiny': ResNetConfig(depth=(1, 1), limit_num_blocks=2),
}


def resnet(name: str = 'R50') -> ResNetConfig:
  """The trunk ``defaults.resnet(name)`` names."""
  if name not in RESNETS:
    raise ValueError(f'Unknown ResNet name: {name}')
  return RESNETS[name]


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


POOLING_IMPLS = ('stream', 'scan', 'gather')


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
  # The lift's form (``defaults.py:244-250``): 'stream' (the top-k views
  # pooled online), 'scan' (every view in view order, those within the
  # k-th nearest visible one's distance pooled) or 'gather' (the
  # reference's [N, K, D] observations, then masked statistics).
  pooling_impl: str = 'stream'
  # A per-observation MLP over [feature, log10 depth, ray] added to the
  # features before pooling; built only without weighted fusion.
  depth_mlp: Optional[MLPConfig] = None
  # An experiment workdir whose ``streetview_encoder`` subtree warm-starts
  # this one, after its config is merged in ("export wins",
  # ``models/streetview_encoder.py:merged_config``).
  pretrained_path: Optional[str] = _warm_start_field()

  def __post_init__(self):
    if self.pooling_impl not in POOLING_IMPLS:
      raise ValueError(f'pooling_impl={self.pooling_impl!r}; choose from '
                       f'{POOLING_IMPLS}')


@dataclasses.dataclass(frozen=True)
class SemanticRasterEncoderConfig:
  """``defaults.semantic_raster_encoder()``: an R26 x2 trunk with a
  stride-1 stem over ``embedding_dim``-wide class embeddings."""

  encoder: ImageEncoderConfig = ImageEncoderConfig(encoder=ResNetConfig(
      width=2, depth=26, skip_root_block=True))
  embedding_dim: int = 8


@dataclasses.dataclass(frozen=True)
class VerticalPoolingConfig:
  """``defaults.vertical_pooling()``: ``pooling`` is ``'max'``, ``'sum'``,
  ``'mean'``, ``'weighted'`` / ``'softmax'`` (a learned per-cell score,
  through a log-sigmoid for ``'weighted'``, softmax-weighted over the
  column) or ``'mlp'`` (``mlp`` over the flattened column)."""

  pooling: str = 'max'
  mlp: MLPConfig = MLPConfig(layers=(256, 128))


@dataclasses.dataclass(frozen=True)
class BEVNetConfig:
  """The residual stage over the fused plane (``train_localization.py:
  bev_net=1``): ``num_units`` bottleneck units of ``nmid`` (else a quarter
  of the plane's width) mid channels. ``checkpoint_units`` is a memory
  device of the XLA program (rematerialized units), numerically neutral:
  read, and without effect in the port (its two units are small beside
  the trunk's). The reference reads each key with a default, so a config
  may leave any out."""

  num_units: int = 2
  nmid: Optional[int] = None
  checkpoint_units: bool = False


@dataclasses.dataclass(frozen=True)
class BEVMapperConfig:
  streetview_encoder: Optional[StreetViewEncoderConfig] = (
      StreetViewEncoderConfig())
  aerial_encoder: Optional[ImageEncoderConfig] = ImageEncoderConfig(
      encoder=ResNetConfig(skip_root_block=True))
  semantic_encoder: Optional[SemanticRasterEncoderConfig] = None
  scene_z_offset: float = 4.0
  scene_z_height: float = 12.0
  pooling: VerticalPoolingConfig = VerticalPoolingConfig()
  modality_fusion: VerticalPoolingConfig = VerticalPoolingConfig()
  bev_net: Optional[BEVNetConfig] = None
  matching_dim: Optional[int] = 32
  normalize_matching_features: bool = True
  add_confidence: bool = False
  # Training only: U(lo, hi) jitter of the query's z column floor, and
  # dropping each map modality with p = 0.5 (never all of an example's).
  scene_z_offset_range: Optional[Tuple[float, float]] = (-2.0, 2.0)
  apply_modality_dropout: bool = True
  # An experiment workdir whose ``bev_mapper`` subtree warm-starts this one
  # (``models/bev_mapper.py:load_pretrained_variables``).
  pretrained_path: Optional[str] = _warm_start_field()


@dataclasses.dataclass(frozen=True)
class BEVLocalizerConfig:
  bev_mapper: BEVMapperConfig = BEVMapperConfig()
  # The query's own (street-view) mapper, for maps without street views.
  bev_mapper_query: Optional[BEVMapperConfig] = None
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


# ``defaults.semantic_net()``: the head's classes and their frequencies.
AREA_CLASSES = ('crosswalk', 'sidewalk', 'road', 'terrain', 'building')
AREA_FREQUENCIES = (('crosswalk', 0.036434), ('sidewalk', 0.226553),
                    ('road', 0.446990), ('terrain', 0.085374),
                    ('building', 0.204649))
OBJECT_FREQUENCIES = (('fence', 0.006257), ('pole', 0.001172),
                      ('tree', 0.001924), ('traffic_sign', 0.000960),
                      ('traffic_light', 0.000559),
                      ('street_light', 0.000738), ('void', 0.988391))


@dataclasses.dataclass(frozen=True)
class SemanticNetConfig:
  """``defaults.semantic_net()``: a decoder over the mapper's fused plane
  (``'mlp'``: ``mlp_num_layers`` x ``decoder_dim``; ``'resnet_stage'``: a
  dense layer, ``resnet_num_units`` bottleneck units and a two-layer MLP),
  class-balanced by the frequencies. ``stop_mapper_gradients`` cuts the
  backward at the mapper's output (exact when the mapper is frozen)."""

  bev_mapper: BEVMapperConfig = BEVMapperConfig()
  decoder_type: str = 'mlp'
  decoder_dim: int = 128
  mlp_num_layers: int = 2
  resnet_num_units: int = 8
  apply_random_flip: bool = False
  stop_mapper_gradients: bool = False
  area_classes: Tuple[str, ...] = AREA_CLASSES
  area_frequencies: Optional[Tuple[Tuple[str, float], ...]] = AREA_FREQUENCIES
  object_classes_exclusive: Tuple[str, ...] = ('fence', 'pole', 'tree')
  object_classes_independent: Tuple[str, ...] = (
      'traffic_sign', 'traffic_light', 'street_light')
  object_frequencies: Optional[Tuple[Tuple[str, float], ...]] = (
      OBJECT_FREQUENCIES)


@dataclasses.dataclass(frozen=True)
class OccupancyNetConfig:
  """``defaults.occupancy_net()``: the street-view volume read at
  ``num_samples_per_ray`` points of each lidar ray (the hit and points in
  front of it) and decoded by ``occupancy_mlp``. ``stop_encoder_gradients``
  cuts the backward at the encoder's output (exact when it is frozen)."""

  num_samples_per_ray: int = 100
  ray_margin: float = 0.2
  streetview_encoder: StreetViewEncoderConfig = StreetViewEncoderConfig()
  occupancy_mlp: MLPConfig = MLPConfig(layers=(128, 1))
  stop_encoder_gradients: bool = False


ModelConfig = Union[BEVLocalizerConfig, SemanticNetConfig, OccupancyNetConfig]
# The model registry's names (``models.get_model``) and their configs.
MODEL_CONFIGS = {'bev_localizer': BEVLocalizerConfig,
                 'semantic_net': SemanticNetConfig,
                 'occupancy_net': OccupancyNetConfig}


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
  voxel_size: Optional[float] = 0.2
  add_images: bool = True
  add_rasters: bool = True
  add_lidar_rays: bool = False
  num_rays: Optional[int] = None
  mode: Optional[str] = 'pair_scene_view'
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
  """``optimizer_configs`` of ``defaults.base()``: ``adam``, ``adamw`` or
  ``sgd`` (momentum 0.9); parameters whose flax path
  (``'/'.join(path) + '/'``) matches ``freeze_params_reg_exp`` are frozen,
  with (``allocate_frozen_state``) or without Adam moments of their own."""

  optimizer: str = 'adam'
  weight_decay: float = 0.0
  freeze_params_reg_exp: Optional[str] = None
  allocate_frozen_state: bool = True


@dataclasses.dataclass(frozen=True)
class TrainConfig:
  """The schedule, the optimizer and the trainer's cadence
  (``defaults.base()``): a checkpoint every ``checkpoint_steps`` (else every
  ``log_eval_steps``), keeping the last ``max_checkpoints_to_keep``; a
  summary every ``log_summary_steps`` (else every ``log_eval_steps``); an
  eval over ``steps_per_eval`` batches (else the whole eval split) of
  ``eval_batch_size`` (else ``batch_size``) every ``log_eval_steps``; all
  three at the stop step, ``stop_at_step`` or ``num_training_steps``;
  a trace of 5 steps after a (re)start when ``xprof``."""

  lr_configs: LrConfig = LrConfig()
  optimizer_configs: OptimizerConfig = OptimizerConfig()
  max_grad_norm: Optional[float] = None
  num_training_steps: int = 8
  checkpoint: bool = True
  checkpoint_steps: Optional[int] = None
  max_checkpoints_to_keep: int = 10
  log_summary_steps: Optional[int] = None
  log_eval_steps: int = 1000
  steps_per_eval: Optional[int] = None
  eval_batch_size: Optional[int] = None
  stop_at_step: Optional[int] = None
  xprof: bool = True


@dataclasses.dataclass(frozen=True)
class MeshConfig:
  """The mesh's axis sizes (the reference's ``mesh``, ``defaults.py:103``):
  ``data`` ranks split each global batch, ``model`` ranks split each wide
  parameter (tensor parallelism, ``parallel/tensor.py``, by the rule of
  ``parallel/mesh.py:infer_param_shardings`` over ``Config.tp_min_dim``);
  -1 takes the ranks the other axis leaves (``parallel/mesh.py:
  make_mesh``). Rank r sits at (r // model, r % model)."""

  data: int = -1
  model: int = 1


@dataclasses.dataclass(frozen=True)
class Config:
  """An experiment: ``model`` is the config of the registry's
  ``model_name``; ``batch_size`` is the global batch, split over the
  ``mesh``'s ``data`` ranks; ``tp_min_dim`` is the smallest last dim (flax
  layout) of a leaf the ``model`` axis shards (``defaults.py:105``)."""

  model: ModelConfig
  data: DataConfig
  dtype_str: str = 'bfloat16'
  batch_size: int = 1
  train: TrainConfig = TrainConfig()
  model_name: str = 'bev_localizer'
  mesh: MeshConfig = MeshConfig()
  tp_min_dim: int = 256


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
  return dataclasses.replace(resnet('tiny'), skip_root_block=skip_root_block)


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


# ``train_localization.py``'s flagship recipe, which ``continue_step``
# continues.
FULL1CHIP_STEPS = 20_000


def export_steps(workdir: str) -> Tuple[int, ...]:
  """The steps an experiment workdir holds: its ``checkpoints/<step>``
  directories, else the step of its ``checkpoint.json``."""
  path = pathlib.Path(workdir)
  ckdir = path / 'checkpoints'
  if ckdir.is_dir():
    return tuple(sorted(int(p.name) for p in ckdir.iterdir()
                        if p.name.isdigit()))
  record = path / 'checkpoint.json'
  if record.exists():
    step = json.loads(record.read_text()).get('step')
    return () if step is None else (int(step),)
  return ()


def _check_continuation(continue_step: int, pretrained_mapper: str,
                        scale: str) -> None:
  """Raise where ``train_localization.py:61-87`` raises."""
  if not pretrained_mapper:
    raise ValueError('continue_step requires pretrained_mapper=<export>')
  if scale != 'full1chip':
    raise ValueError('continue_step is only defined for scale=full1chip, '
                     f'got scale={scale}')
  if not 0 < continue_step < FULL1CHIP_STEPS:
    raise ValueError(f'continue_step must be in (0, {FULL1CHIP_STEPS}), '
                     f'got {continue_step}')
  steps = export_steps(pretrained_mapper)
  if steps and continue_step not in steps:
    raise ValueError(
        f'continue_step={continue_step} does not match the export checkpoint '
        f'step(s) {list(steps)} in {pretrained_mapper}; pass the matching '
        'step or re-export with tools/export_pretrained.py --effective-step')


# ``defaults.MapModalities``: the map encoders a mapper may have.
MODALITIES = ('streetview', 'aerial', 'semantic')


def parse_modalities(modalities: str) -> Tuple[str, ...]:
  """``'streetview+aerial[+semantic]'``, ``'aerial[+semantic]'`` (the
  reference's argument) -> the names."""
  names = tuple(modalities.split('+'))
  unknown = sorted(set(names) - set(MODALITIES))
  if unknown:
    raise ValueError(f'Unknown map modalities {unknown}; choose from '
                     f'{MODALITIES}')
  return names


def mapper_of(mapper: BEVMapperConfig, modalities: str,
              semantic: SemanticRasterEncoderConfig) -> BEVMapperConfig:
  """``mapper`` with the map encoders of ``modalities``
  (``defaults.bev_mapper(modalities)``): its own street-view and aerial
  encoders, and ``semantic`` as the semantic raster encoder."""
  names = parse_modalities(modalities)
  return dataclasses.replace(
      mapper,
      streetview_encoder=(mapper.streetview_encoder if 'streetview' in names
                          else None),
      aerial_encoder=mapper.aerial_encoder if 'aerial' in names else None,
      semantic_encoder=semantic if 'semantic' in names else None)


def query_mapper_of(mapper: BEVMapperConfig) -> BEVMapperConfig:
  """The query's own mapper for a map without street views
  (``train_localization.py:107-119``): ``mapper``'s settings with its
  street-view encoder alone, whose fusion MLP is (2 dim, 2 dim, dim); no
  ``bev_net`` and no warm start of its own."""
  streetview = mapper.streetview_encoder
  dim = streetview.feature_dim
  return dataclasses.replace(
      mapper, aerial_encoder=None, semantic_encoder=None, bev_net=None,
      pretrained_path=None,
      streetview_encoder=dataclasses.replace(
          streetview, fusion=MLPConfig(layers=(dim * 2, dim * 2, dim))))


def with_modalities(config: Config, modalities: str,
                    semantic: SemanticRasterEncoderConfig) -> Config:
  """The localizer ``config`` with the map encoders of ``modalities``
  (``train_localization.py:99-100``), a query mapper of its own where the
  map has no street views (``:104-119``), and the data layers they read
  (``:135-138``): the map's images only with street views."""
  mapper = config.model.bev_mapper
  names = parse_modalities(modalities)
  query = None if 'streetview' in names else query_mapper_of(mapper)
  mapper = mapper_of(mapper, modalities, semantic)
  data = dataclasses.replace(
      config.data, add_images='streetview' in names,
      add_rasters=bool(mapper.aerial_encoder or mapper.semantic_encoder))
  return dataclasses.replace(
      config, model=dataclasses.replace(config.model, bev_mapper=mapper,
                                        bev_mapper_query=query),
      data=data)


def with_bev_net(config: Config, bev_net: int) -> Config:
  """``train_localization.py:101-103``: ``bev_net=1`` puts the residual
  stage (2 units, rematerialized in the reference) over the map's fused
  plane."""
  if not int(bev_net):
    return config
  mapper = dataclasses.replace(
      config.model.bev_mapper,
      bev_net=BEVNetConfig(num_units=2, checkpoint_units=True))
  return dataclasses.replace(config, model=dataclasses.replace(
      config.model, bev_mapper=mapper))


# ``train_localization.py``'s scales: the paper's recipe (``full``: batch
# 32, 400k steps), its per-chip shard (``full1chip``: batch 2, the 20k
# recipe) and the from-scratch recipe at a smaller scene scale (``small``:
# 0.4 m voxels, 10 views of 90x120, batch 8).
SCALES = ('full', 'full1chip', 'small')
POSE_BACKENDS = ('ransac', 'exhaustive')


def _localization_schedule(scale: str, image_encoder: str,
                           continue_step: int) -> TrainConfig:
  """``train_localization.py:160-232``: the schedule and cadence of
  ``scale``. ``small`` and ``full1chip`` warm up for 1,000 steps, then
  decay by a cosine from step 4,000 to 20,000 (lr 5e-4 and 2e-4), clipped
  at a gradient norm of 1; ``full`` is lr 5e-5 under a cosine from half
  its 400k steps (200k for R152x2) on, unclipped. A ``continue_step``
  (``full1chip`` only) runs the 20k recipe's tail from that step: a
  100-step re-warmup, then the same cosine."""
  if scale == 'full':
    steps, checkpoint, summary, every = (
        (200_000, 2_000, 500, 4_000) if image_encoder == 'R152x2'
        else (400_000, 10_000, 1_000, 5_000))
    lr = LrConfig(factors='constant * cosine_decay', base_learning_rate=5e-5,
                  start_decay_step=steps // 2,
                  steps_per_cycle=steps - steps // 2)
    return TrainConfig(lr_configs=lr, num_training_steps=steps,
                       checkpoint_steps=checkpoint, log_summary_steps=summary,
                       log_eval_steps=every)
  small = scale == 'small'
  lr = LrConfig(factors='constant * linear_warmup * cosine_decay',
                base_learning_rate=5e-4 if small else 2e-4,
                warmup_steps=1_000, start_decay_step=4_000,
                steps_per_cycle=16_000)
  train = TrainConfig(lr_configs=lr, max_grad_norm=1.0,
                      num_training_steps=FULL1CHIP_STEPS,
                      checkpoint_steps=1_000 if small else 500,
                      log_summary_steps=100, log_eval_steps=2_000,
                      steps_per_eval=8)
  if continue_step:
    train = dataclasses.replace(
        train, num_training_steps=FULL1CHIP_STEPS - continue_step,
        lr_configs=dataclasses.replace(
            lr, warmup_steps=100, start_decay_step=4_000 - continue_step))
  return train


def train_localization(image_encoder: str = 'R50',
                       modalities: str = 'streetview+aerial',
                       pose_backend: str = 'ransac', scale: str = 'full',
                       pretrained_resnet: str = '', bev_net: int = 0,
                       point_tile: int = 0, pretrained_mapper: str = '',
                       continue_step: int = 0, batch_size: int = 0
                       ) -> Config:
  """``configs/train_localization.py`` with its arguments.

  ``image_encoder`` names the street-view trunk (``resnet``: R50, R152x2
  through its third stage, R101, R26 or tiny; the query's own mapper has
  it when the map has no street views); the aerial trunk is R50 whatever
  it names. ``pose_backend`` 'exhaustive' scores the full query grid with
  unclipped scores, 'ransac' samples 10,000 poses x 8 retries over the
  in-FoV query points. ``scale`` (``SCALES``): 'full' the paper's recipe,
  batch 32 over 20 views of 180x240 at 0.2 m, 8,192 eval examples;
  'full1chip' the same scene at batch 2 with the 20k recipe; 'small' 10
  views of 90x120 at 0.4 m (a 60x80x30 grid), batch 8, 64 eval examples.
  ``modalities``, ``bev_net``, ``pretrained_mapper``, ``pretrained_resnet``
  and ``continue_step`` as ``train_full1chip_exhaustive`` has them; a
  ``continue_step`` needs ``scale='full1chip'``. ``batch_size`` > 0
  replaces the scale's (a global batch over the mesh's data ranks).

  ``point_tile`` is read and has no effect: the reference's tile of the
  lift's points in training, a memory device of the XLA program
  (rematerialized tiles), numerically neutral, that the port's lift
  backward does without.
  """
  del point_tile
  if scale not in SCALES:
    raise ValueError(f'scale={scale!r}; choose from {SCALES}')
  if pose_backend not in POSE_BACKENDS:
    raise ValueError(f'pose_backend={pose_backend!r}; choose from '
                     f'{POSE_BACKENDS}')
  cs = int(continue_step)
  if cs:
    _check_continuation(cs, pretrained_mapper, scale)
  encoder = resnet(image_encoder)
  if pretrained_resnet:
    encoder = dataclasses.replace(encoder,
                                  pretrained_path=str(pretrained_resnet))
  mapper = BEVMapperConfig()
  mapper = dataclasses.replace(
      mapper, streetview_encoder=merge(
          mapper.streetview_encoder, {'image_encoder': {'encoder': encoder}}),
      pretrained_path=str(pretrained_mapper) if pretrained_mapper else None)
  exhaustive = pose_backend == 'exhaustive'
  # Dense voting needs the full query grid and linear (unclipped) scores.
  model = BEVLocalizerConfig(
      bev_mapper=mapper, pose_backend=pose_backend,
      filter_points_in_fov=not exhaustive,
      clip_negative_scores=not exhaustive, num_pose_samples=10_000,
      num_pose_sampling_retries=8)
  small = scale == 'small'
  data = DataConfig(
      num_views=10 if small else 20,
      image_size=(90, 120) if small else (180, 240),
      voxel_size=0.4 if small else 0.2, mode='pair_scene_view',
      evaluation_size={'small': 64, 'full1chip': 32, 'full': 8_192}[scale],
      num_workers=8 if small else 2,
      locations=LocationsConfig(training=TRAIN_LOCATIONS),
      shuffle_seed=SHUFFLE_SEED + cs)
  config = Config(
      model=model, data=data, dtype_str='bfloat16',
      batch_size=int(batch_size) or {'small': 8, 'full1chip': 2,
                                     'full': 32}[scale],
      train=_localization_schedule(scale, image_encoder, cs))
  return with_bev_net(with_modalities(
      config, modalities, SemanticRasterEncoderConfig()), bev_net)


def train_full1chip_exhaustive(batch_size: int = 2,
                               pretrained_mapper: str = '',
                               pretrained_resnet: str = '',
                               continue_step: int = 0,
                               modalities: str = 'streetview+aerial',
                               bev_net: int = 0) -> Config:
  """``train_localization.py:scale=full1chip,pose_backend=exhaustive``:
  ``bench_full``'s model at the same widths, trained at batch 2 with z
  jitter on the query, modality dropout, Adam and a warmup + cosine
  schedule; no grid refinement.

  ``modalities`` (``'streetview+aerial[+semantic]'``, ``'aerial[+semantic]'``)
  picks the map encoders at full width; the semantic one is an R26 x2 over
  the class embeddings (56.7M parameters). A map without street views
  (the aerial-only neural map) has no images, and the query goes through a
  street-view mapper of its own. ``bev_net=1`` adds the residual stage
  over the map's fused plane.
  ``pretrained_mapper`` (an experiment workdir) warm-starts the mapper and
  ``pretrained_resnet`` (a BiT ``.npz``) the street-view trunk. A
  ``continue_step`` continues the 20k recipe from that step of
  ``pretrained_mapper`` (``:173-186``): a 100-step re-warmup, then the
  recipe's cosine tail, over the ``20000 - continue_step`` steps left, on
  a data seed moved by the step.
  """
  return train_localization(
      modalities=modalities, pose_backend='exhaustive', scale='full1chip',
      pretrained_resnet=pretrained_resnet, bev_net=bev_net,
      pretrained_mapper=pretrained_mapper, continue_step=continue_step,
      batch_size=batch_size)


def _tiny_semantic_encoder(dim: int = 32) -> SemanticRasterEncoderConfig:
  """The tests' tiny semantic raster encoder (``tests/helpers.py:41-43``)."""
  return SemanticRasterEncoderConfig(
      encoder=ImageEncoderConfig(encoder=_tiny_resnet(skip_root_block=True),
                                 output_dim=dim),
      embedding_dim=4)


def smoke_train_exhaustive(batch_size: int = 2,
                           modalities: str = 'streetview+aerial',
                           bev_net: int = 0) -> Config:
  """``smoke_exhaustive`` with ``smoke_localization.py``'s training setup:
  8 steps, a summary every 2, a checkpoint every 4, an eval of 1 batch at
  step 8. ``modalities`` and ``bev_net`` as ``train_full1chip_exhaustive``'s,
  the encoders tiny."""
  lr = LrConfig(factors='constant', base_learning_rate=1e-3)
  smoke = dataclasses.replace(
      smoke_exhaustive(batch_size),
      train=TrainConfig(lr_configs=lr, max_grad_norm=1.0,
                        num_training_steps=8, log_summary_steps=2,
                        log_eval_steps=8, checkpoint_steps=4,
                        steps_per_eval=1))
  return with_bev_net(with_modalities(smoke, modalities,
                                     _tiny_semantic_encoder()), bev_net)


def train_full1chip_ransac(batch_size: int = 2, pretrained_mapper: str = '',
                           pretrained_resnet: str = '',
                           continue_step: int = 0,
                           modalities: str = 'streetview+aerial',
                           bev_net: int = 0) -> Config:
  """``train_localization.py:scale=full1chip``, whose backend defaults to
  RANSAC: ``train_full1chip_exhaustive`` (its warm starts and continuation
  included) with the in-FoV query points, clipped scores and 10,000 pose
  samples x 8 retries; ``modalities`` and ``bev_net`` as there."""
  return train_localization(
      modalities=modalities, pose_backend='ransac', scale='full1chip',
      pretrained_resnet=pretrained_resnet, bev_net=bev_net,
      pretrained_mapper=pretrained_mapper, continue_step=continue_step,
      batch_size=batch_size)


def smoke_train_ransac(batch_size: int = 2,
                       modalities: str = 'streetview+aerial',
                       bev_net: int = 0) -> Config:
  """``smoke_localization.py`` with its default backend, RANSAC (the
  in-FoV query points, 64 pose samples x 2 retries, the default 64
  rotations), and ``smoke_train_exhaustive``'s training setup, its
  ``modalities`` and ``bev_net``."""
  smoke = smoke_train_exhaustive(batch_size, modalities, bev_net)
  return dataclasses.replace(smoke, model=dataclasses.replace(
      smoke.model, pose_backend='ransac', filter_points_in_fov=True,
      num_rotations=BEVLocalizerConfig().num_rotations))


def smoke_eval_ransac(batch_size: int = 2) -> Config:
  """``smoke_localization.py`` (RANSAC) under ``smoke_eval_localization.py``:
  the in-FoV query points, 64 samples x 2 retries, grid refinement, f32,
  evaluated on 'smokeville-synthetic_eval'."""
  smoke = smoke_exhaustive()
  experiment = dataclasses.replace(smoke, model=dataclasses.replace(
      smoke.model, pose_backend='ransac', filter_points_in_fov=True))
  return merge_eval_config(
      dataclasses.replace(smoke_eval_localization(), batch_size=batch_size),
      experiment, 'smokeville-synthetic_eval')


def eval_full1chip_ransac(batch_size: int = 4) -> Config:
  """``train_full1chip_ransac`` (``train_localization.py:scale=full1chip``)
  under ``eval_localization.py``: R50 street-view + aerial mapper, 20 views
  of 180x240, 0.2 m voxels, top-k 4 lift, 20,000 pose samples x 8 retries,
  grid refinement, batch 4, f32, evaluated on the first test city,
  'osaka-synthetic_eval'."""
  return merge_eval_config(
      eval_localization(evaluation_size=4096, batch_size=batch_size),
      train_full1chip_ransac(), 'osaka-synthetic_eval')


def eval_full1chip_exhaustive(batch_size: int = 4) -> Config:
  """The held-out protocol of the flagship run: ``train_full1chip_
  exhaustive`` under ``eval_localization.py:evaluation_size=256,
  batch_size=4`` (``tools/run_supervisor.py:309-314``) on
  'zurich-synthetic_eval': dense refinement on (one +-5 deg fan), f32, 256
  examples a city."""
  return merge_eval_config(
      eval_localization(evaluation_size=256, batch_size=batch_size),
      train_full1chip_exhaustive(), 'zurich-synthetic_eval')


# The downstream heads on a (frozen) mapper.


def read_experiment(workdir: str) -> Config:
  """The ``Config`` of the experiment in ``workdir`` (its ``config.json``,
  the reference's keys)."""
  path = pathlib.Path(workdir) / 'config.json'
  return from_reference(json.loads(path.read_text()))


def _head_schedule(config: Config, small: bool, batch_size: int) -> Config:
  """``train_semantics.py`` / ``train_occupancy.py``'s schedules:
  ``scale=small`` a short one (128 eval examples) at the config's batch
  size, else the reference's 50k steps at batch 1; a ``batch_size`` > 0
  wins."""
  if small:
    lr, steps, cadence = 2e-4, 3_000, dict(
        checkpoint_steps=500, log_summary_steps=100, log_eval_steps=500,
        steps_per_eval=8)
    config = dataclasses.replace(config, data=dataclasses.replace(
        config.data, evaluation_size=128))
  else:
    lr, steps, cadence = 5e-5, 50_000, dict(
        checkpoint_steps=10_000, log_summary_steps=1_000,
        log_eval_steps=5_000)
    config = dataclasses.replace(config, batch_size=1)
  train = dataclasses.replace(
      config.train, lr_configs=LrConfig(base_learning_rate=lr),
      num_training_steps=steps, **cadence)
  if int(batch_size):
    config = dataclasses.replace(config, batch_size=int(batch_size))
  return dataclasses.replace(config, train=train, dtype_str='bfloat16')


def _frozen(regex: str) -> TrainConfig:
  """The heads' optimizer: ``regex`` frozen, without Adam moments of its
  own (``allocate_frozen_state=False``)."""
  return TrainConfig(optimizer_configs=OptimizerConfig(
      freeze_params_reg_exp=regex, allocate_frozen_state=False))


def _scene_of(data: DataConfig, pretrained: Config) -> DataConfig:
  """``data`` with the scene geometry a pretrained mapper was trained on."""
  return dataclasses.replace(
      data, voxel_size=float(pretrained.data.voxel_size),
      num_views=int(pretrained.data.num_views),
      image_size=tuple(pretrained.data.image_size))


def train_semantics(scale: str = 'full', pretrained_mapper: str = '',
                    modalities: str = 'streetview+aerial',
                    batch_size: int = 0) -> Config:
  """``configs/train_semantics.py``: the semantic BEV head (a
  ``resnet_stage`` decoder of width 256 with 2 units, random flips) on a
  frozen mapper of ``modalities`` (the backward cut at its output), on
  single scenes of 20 views at 0.2 m with their rasters.

  ``pretrained_mapper`` (an experiment workdir) gives the mapper: its
  config as the workdir has it, warm-started from its weights, and the
  scene geometry it was trained on. ``scale='small'``: 3,000 steps at
  batch 8 and lr 2e-4; else the reference's 50,000 at batch 1 and 5e-5.
  """
  mapper = mapper_of(BEVMapperConfig(), modalities,
                     SemanticRasterEncoderConfig())
  if mapper.streetview_encoder is not None:
    mapper = dataclasses.replace(mapper, streetview_encoder=dataclasses.replace(
        mapper.streetview_encoder, max_view_distance=20.0))
  data = DataConfig(
      num_views=20, voxel_size=0.2, add_images=True, add_rasters=True,
      mode='single_scene', evaluation_size=1_024,
      locations=LocationsConfig(training='train-synthetic-semantics',
                                evaluation='val-synthetic-semantics'),
      shuffle_seed=SHUFFLE_SEED)
  if pretrained_mapper:
    pretrained = read_experiment(pretrained_mapper)
    mapper = dataclasses.replace(pretrained.model.bev_mapper,
                                 pretrained_path=str(pretrained_mapper))
    data = _scene_of(data, pretrained)
  model = SemanticNetConfig(
      bev_mapper=mapper, decoder_type='resnet_stage', decoder_dim=256,
      resnet_num_units=2, apply_random_flip=True, stop_mapper_gradients=True)
  config = Config(model=model, data=data, model_name='semantic_net',
                  train=_frozen(r'bev_mapper/'), batch_size=8)
  return _head_schedule(config, scale == 'small', batch_size)


def train_occupancy(scale: str = 'full', pretrained_mapper: str = '',
                    batch_size: int = 0) -> Config:
  """``configs/train_occupancy.py``: the occupancy head (an MLP 128-256-1)
  on a frozen street-view encoder (the backward cut at its output),
  supervised by 10,000 lidar rays a scene (4,000 at ``scale='small'``) of
  100 samples each, on single scenes of 20 views at 0.2 m from the 12
  training cities.

  ``pretrained_mapper`` (an experiment workdir) gives the encoder: its
  config as the workdir's mapper has it, warm-started from its weights,
  the scene geometry it was trained on, and an eval batch of 2.
  ``scale`` as ``train_semantics``'s, at batch 4 when small.
  """
  data = DataConfig(
      num_views=20, voxel_size=0.2, add_images=True, add_rasters=False,
      add_lidar_rays=True, num_rays=10_000, mode='single_scene',
      evaluation_size=4_096, locations=LocationsConfig(
          training=TRAIN_LOCATIONS), shuffle_seed=SHUFFLE_SEED)
  streetview = StreetViewEncoderConfig()
  train = _frozen(r'streetview_encoder/')
  if pretrained_mapper:
    pretrained = read_experiment(pretrained_mapper)
    streetview = dataclasses.replace(
        pretrained.model.bev_mapper.streetview_encoder,
        pretrained_path=str(pretrained_mapper))
    data = _scene_of(data, pretrained)
    train = dataclasses.replace(train, eval_batch_size=2)
  small = scale == 'small'
  if small:
    data = dataclasses.replace(data, num_rays=4_000)
  model = OccupancyNetConfig(
      streetview_encoder=streetview,
      occupancy_mlp=MLPConfig(layers=(128, 256, 1)),
      stop_encoder_gradients=True)
  config = Config(model=model, data=data, model_name='occupancy_net',
                  train=train, batch_size=4)
  return _head_schedule(config, small, batch_size)


def _smoke_head_data(**changes) -> DataConfig:
  """``smoke_semantics.py`` / ``smoke_occupancy.py``'s scenes: 3 views of
  36x48 at 1 m, single scenes of 'smoke-city'."""
  return DataConfig(num_views=3, image_size=(36, 48), voxel_size=1.0,
                    mode='single_scene', evaluation_size=4,
                    locations=LocationsConfig(training='smoke-city'),
                    shuffle_seed=SHUFFLE_SEED, **changes)


def _smoke_head_train() -> TrainConfig:
  return TrainConfig(lr_configs=LrConfig(base_learning_rate=1e-3),
                     num_training_steps=4, log_summary_steps=2,
                     log_eval_steps=4, checkpoint_steps=4, steps_per_eval=1)


def smoke_semantics(batch_size: int = 2) -> Config:
  """``configs/smoke_semantics.py``: the semantic head (an MLP decoder of
  width 16, random flips) on the tiny street-view + aerial mapper of
  ``smoke_exhaustive``, trained whole (nothing frozen), f32."""
  model = SemanticNetConfig(bev_mapper=smoke_exhaustive().model.bev_mapper,
                            decoder_dim=16, apply_random_flip=True)
  return Config(model=model, data=_smoke_head_data(add_rasters=True),
                model_name='semantic_net', dtype_str='float32',
                batch_size=batch_size, train=_smoke_head_train())


def smoke_occupancy(batch_size: int = 2) -> Config:
  """``configs/smoke_occupancy.py``: the occupancy head (an MLP 16-1, 16
  samples on each of 512 rays) on the tiny street-view encoder of
  ``smoke_exhaustive``, trained whole, f32."""
  model = OccupancyNetConfig(
      num_samples_per_ray=16,
      streetview_encoder=smoke_exhaustive().model.bev_mapper
      .streetview_encoder,
      occupancy_mlp=MLPConfig(layers=(16, 1)))
  data = _smoke_head_data(add_rasters=False, add_lidar_rays=True,
                          num_rays=512)
  return Config(model=model, data=data, model_name='occupancy_net',
                dtype_str='float32', batch_size=batch_size,
                train=_smoke_head_train())


# Offline evaluation of an experiment (``snap_tpu/evaluator.py``).


def streetview_singlescene() -> DataConfig:
  """``defaults.streetview_singlescene()``: the loader's defaults, with the
  scene keys (``voxel_size``, ``mode``) unset for the experiment to give."""
  return DataConfig(voxel_size=None, mode=None, add_rasters=False)


@dataclasses.dataclass(frozen=True)
class EvalDataConfig:
  """``data`` of ``configs/eval_localization.py``: the split (a name of
  ``DATA_SPLITS_CITIES`` or comma-joined cities), each city's location
  name, the data seed and the loader's defaults."""

  rng_seed: int = 0
  split: str = 'test'
  name_pattern: str = '{}-synthetic_eval'
  loader: DataConfig = dataclasses.field(
      default_factory=streetview_singlescene)


def _eval_model_overrides() -> Dict[str, Any]:
  return dict(num_pose_samples=20_000, num_pose_sampling_retries=8,
              do_grid_refinement=True)


@dataclasses.dataclass(frozen=True)
class EvalConfig:
  """``configs/eval_localization.py:25-45``: an evaluation of the
  experiment in ``workdir`` (at ``checkpoint_step``, or the one it holds).

  ``model`` overrides the experiment's model: field -> value, a dict
  merging into a nested config field by field (``merge``).
  """

  workdir: Optional[str] = None
  checkpoint_step: Optional[int] = None
  batch_size: int = 4
  rng_seed: int = 0
  dtype_str: str = 'float32'
  tag: str = ''
  overwrite: bool = False
  data: EvalDataConfig = EvalDataConfig()
  model: Mapping[str, Any] = dataclasses.field(
      default_factory=_eval_model_overrides)


def eval_localization(evaluation_size: int = 4096, batch_size: int = 4,
                      tag: str = '', num_rotations: int = 0,
                      refinement_stages: str = '',
                      subcell: int = 0) -> EvalConfig:
  """``configs/eval_localization.py`` with the arguments of its ``:12-23``
  that the port's model honours (``point_tile_eval``, a memory device of
  the XLA program, is not one): ``num_rotations`` > 0 sets the coarse
  rotation bins, ``refinement_stages`` the dense fans (``'5x0.25'``,
  ``'11x1+1.25x0.125'``), ``subcell`` the sub-bin peak fit."""
  model = _eval_model_overrides()
  if num_rotations:
    model['num_rotations'] = int(num_rotations)
  if subcell:
    model['subcell_refinement'] = True
  if refinement_stages:
    model['dense_refinement_stages'] = tuple(
        tuple(float(v) for v in stage.split('x'))
        for stage in refinement_stages.split('+'))
  loader = dataclasses.replace(streetview_singlescene(),
                               evaluation_size=int(evaluation_size))
  return EvalConfig(batch_size=int(batch_size), tag=tag,
                    data=EvalDataConfig(loader=loader), model=model)


def smoke_eval_localization() -> EvalConfig:
  """``configs/smoke_eval_localization.py``: 4 examples of 'smokeville'
  at batch 2, 64 pose samples x 2 retries, grid refinement, f32."""
  loader = dataclasses.replace(streetview_singlescene(), evaluation_size=4)
  return EvalConfig(
      batch_size=2,
      data=EvalDataConfig(split='smokeville', loader=loader),
      model=dict(num_pose_samples=64, num_pose_sampling_retries=2,
                 do_grid_refinement=True))


def eval_semantics(evaluation_size: int = 10_000, batch_size: int = 4,
                   tag: str = '') -> EvalConfig:
  """``configs/eval_semantics.py``: the semantic head's experiment on
  'val-synthetic' (location 'val-synthetic_semantics_eval'), f32, its
  model as trained."""
  loader = dataclasses.replace(streetview_singlescene(),
                               evaluation_size=int(evaluation_size))
  return EvalConfig(
      batch_size=int(batch_size), tag=tag, model={},
      data=EvalDataConfig(split='val-synthetic',
                          name_pattern='{}_semantics_eval', loader=loader))


EVAL_CONFIGS = {
    'eval_localization': eval_localization,
    'smoke_eval_localization': smoke_eval_localization,
    'eval_semantics': eval_semantics,
}


def merge(config, overrides: Mapping[str, Any]):
  """The dataclass ``config`` with ``overrides`` (field -> value; a dict
  merges into a nested dataclass field by field), as
  ``snap_tpu/utils/configs.py:configs_merge`` merges ConfigDicts."""
  names = {f.name for f in dataclasses.fields(config)}
  changes = {}
  for key, value in overrides.items():
    if key not in names:
      raise ValueError(f'{type(config).__name__} has no field {key!r}')
    current = getattr(config, key)
    if dataclasses.is_dataclass(current) and isinstance(value, Mapping):
      value = merge(current, value)
    changes[key] = value
  return dataclasses.replace(config, **changes)


# ``evaluator.py:get_model_and_dataset``: the data keys an experiment gives
# its evaluation; every other data key is the eval loader's.
EXPERIMENT_DATA_KEYS = ('voxel_size', 'add_images', 'add_lidar_rays',
                        'add_rasters', 'mode', 'num_views', 'image_size')


def merge_eval_config(eval_config: EvalConfig, experiment: Config,
                      location: str) -> Config:
  """The config an evaluation of ``experiment`` at ``location`` runs
  (``snap_tpu/evaluator.py:157-221``): the eval batch size and dtype; the
  eval loader overridden by the experiment's ``EXPERIMENT_DATA_KEYS``,
  ``location`` for both splits and the eval data seed as the shuffle seed;
  the experiment's model overridden by the eval model."""
  data = dataclasses.replace(
      eval_config.data.loader,
      **{key: getattr(experiment.data, key) for key in EXPERIMENT_DATA_KEYS},
      locations=LocationsConfig(training=location, evaluation=location),
      shuffle_seed=eval_config.data.rng_seed)
  return dataclasses.replace(
      experiment, batch_size=eval_config.batch_size, data=data,
      model=merge(experiment.model, eval_config.model),
      dtype_str=eval_config.dtype_str)


# A reference config as a plain dict (``ConfigDict.to_dict()``, as JSON).

# Keys the port reads and ignores, by the dataclass of their section.
_IGNORED_KEYS = {
    # The lift's point tiles in training and at eval: memory devices of
    # the XLA program (rematerialized tiles), numerically neutral.
    StreetViewEncoderConfig: ('point_tile', 'point_tile_eval'),
    DataConfig: (
        # Where a TFDS build would live; the synthetic generator reads none.
        'version', 'data_dir', 'dirname',
        # Read by the reference only as metadata, and not at all.
        'training_size_per_builder', 'raster_size'),
}
# Keys whose value the port checks: the one value it runs.
_CHECKED_KEYS = {
    DataConfig: {'name': 'streetview_singlescene'},
    LrConfig: {'learning_rate_schedule': 'compound'},
}
# Sections whose keys the reference reads with defaults (``.get``), so a
# config may leave any of them out.
_DEFAULTED = (BEVNetConfig, MeshConfig)
# Top-level keys read and ignored: the JAX trainer's bookkeeping that the
# port's has no use for (summary writers, debug flags, where its init
# runs), the seed of its flax init (the port draws its own weights) and
# the records an evaluation adds to its dump.
_IGNORED_TOP = (
    'write_summary', 'debug_train', 'debug_eval', 'init_backend',
    'rng_seed', 'eval_checkpoint_step', 'data_generator_kind',
    'eval_seconds', 'build_ms', 'build_card_ms', 'cudnn_allow_tf32',
    'matmul_allow_tf32', 'num_processes')
_TOP_KEYS = ('model', 'data', 'batch_size', 'dtype_str', 'shuffle_seed',
             'lr_configs', 'optimizer_configs', 'max_grad_norm',
             'num_training_steps')
# The trainer's cadence (``TrainConfig``), each read when the reference
# config has it (``stop_at_step`` only a run's own does).
_TRAINER_TOP = ('checkpoint', 'checkpoint_steps', 'max_checkpoints_to_keep',
                'log_summary_steps', 'log_eval_steps', 'steps_per_eval',
                'eval_batch_size', 'stop_at_step', 'xprof')
_CHECKED_TOP = {'data_dtype_str': 'float32', 'num_training_epochs': None}
# The compute dtypes the port runs (``dtype_str``): the reference's three.
DTYPE_STRS = ('bfloat16', 'float16', 'float32')


def _check(where: str, value, want) -> None:
  if value != want:
    raise ValueError(f'from_reference: {where} = {value!r}; the port runs '
                     f'{want!r} only')


def _tuples(value):
  if isinstance(value, (list, tuple)):
    return tuple(_tuples(v) for v in value)
  return value


def _nested_dataclass(hint):
  return next((t for t in (hint, *typing.get_args(hint))
               if dataclasses.is_dataclass(t)), None)


def _from_dict(cls, d: Mapping[str, Any], where: str, **given):
  hints = typing.get_type_hints(cls)
  kwargs = dict(given)
  for key, value in d.items():
    name = f'{where}.{key}'
    if key in _IGNORED_KEYS.get(cls, ()):
      continue
    if key in _CHECKED_KEYS.get(cls, {}):
      _check(name, value, _CHECKED_KEYS[cls][key])
      continue
    if key not in hints or key in given:
      raise ValueError(f'from_reference: unknown key {name}')
    sub = _nested_dataclass(hints[key])
    if sub is not None and isinstance(value, Mapping):
      kwargs[key] = _from_dict(sub, value, name)
    else:
      kwargs[key] = _tuples(value)
  missing = sorted(set(hints) - set(kwargs))
  if missing and cls not in _DEFAULTED:
    raise ValueError(f'from_reference: {where} lacks {missing}')
  return cls(**kwargs)


def streetview_encoder_from_reference(d: Mapping[str, Any]
                                      ) -> StreetViewEncoderConfig:
  """The street-view encoder's config of a reference dict's subtree."""
  return _from_dict(StreetViewEncoderConfig, d,
                    'model.bev_mapper.streetview_encoder')


def from_reference(d: Mapping[str, Any]) -> Config:
  """The port's ``Config`` of a JAX experiment config given as a plain dict
  (``ConfigDict.to_dict()``, as JSON: tuples as lists).

  Reads every key the port models; ignores, by name, the keys that do not
  change what the model computes (``_IGNORED_KEYS``, ``_IGNORED_TOP``);
  raises ``ValueError`` naming the key on a setting the port cannot run, on
  an unknown key and on a missing one.
  """
  for key, want in _CHECKED_TOP.items():
    _check(key, d.get(key), want)
  mesh = dict(d.get('mesh', {}))
  for axis, size in mesh.items():
    if not isinstance(size, int) or not (size == -1 or size >= 1):
      raise ValueError(f'from_reference: mesh.{axis} = {size!r}; an axis '
                       f'size is a positive int, or -1 (the ranks left)')
  if d.get('dtype_str') not in DTYPE_STRS:
    raise ValueError(f'from_reference: dtype_str = {d.get("dtype_str")!r}; '
                     f'the port runs {list(DTYPE_STRS)}')
  model_name = d.get('model_name')
  if model_name not in MODEL_CONFIGS:
    raise ValueError(f'from_reference: model_name = {model_name!r}; the '
                     f'port runs {sorted(MODEL_CONFIGS)}')
  known = {*_TOP_KEYS, *_TRAINER_TOP, *_IGNORED_TOP, *_CHECKED_TOP, 'mesh',
           'model_name', 'tp_min_dim'}
  unknown = sorted(set(d) - known)
  missing = sorted(set(_TOP_KEYS) - set(d))
  if unknown or missing:
    raise ValueError(f'from_reference: unknown keys {unknown}, missing '
                     f'{missing}')
  train = TrainConfig(
      lr_configs=_from_dict(LrConfig, d['lr_configs'], 'lr_configs'),
      optimizer_configs=_from_dict(OptimizerConfig, d['optimizer_configs'],
                                   'optimizer_configs'),
      max_grad_norm=d['max_grad_norm'],
      num_training_steps=d['num_training_steps'],
      **{key: d[key] for key in _TRAINER_TOP if key in d})
  return Config(
      model=_from_dict(MODEL_CONFIGS[model_name], d['model'], 'model'),
      data=_from_dict(DataConfig, d['data'], 'data',
                      shuffle_seed=d['shuffle_seed']),
      dtype_str=d['dtype_str'], batch_size=d['batch_size'], train=train,
      model_name=model_name, mesh=_from_dict(MeshConfig, mesh, 'mesh'),
      tp_min_dim=int(d.get('tp_min_dim') or 256))


def plain(value):
  """Dataclasses, dicts and tuples as dicts and lists (for JSON)."""
  if dataclasses.is_dataclass(value):
    return {f.name: plain(getattr(value, f.name))
            for f in dataclasses.fields(value)}
  if isinstance(value, Mapping):
    return {k: plain(v) for k, v in value.items()}
  if isinstance(value, (list, tuple)):
    return [plain(v) for v in value]
  return value


def to_reference(config: Config) -> Dict[str, Any]:
  """``config`` as a reference dict that ``from_reference`` reads back: an
  experiment's ``config.json`` in the reference's keys."""
  data = plain(config.data)
  shuffle_seed = data.pop('shuffle_seed')
  train = config.train
  trainer = {key: getattr(train, key) for key in _TRAINER_TOP}
  if trainer['stop_at_step'] is None:
    del trainer['stop_at_step']
  return {
      **_CHECKED_TOP, 'model_name': config.model_name,
      'model': plain(config.model),
      'data': {**data, **_CHECKED_KEYS[DataConfig]},
      'batch_size': config.batch_size, 'dtype_str': config.dtype_str,
      'shuffle_seed': shuffle_seed,
      'lr_configs': {**plain(train.lr_configs), **_CHECKED_KEYS[LrConfig]},
      'optimizer_configs': plain(train.optimizer_configs),
      'max_grad_norm': train.max_grad_norm,
      'num_training_steps': train.num_training_steps,
      'mesh': plain(config.mesh), 'tp_min_dim': config.tp_min_dim,
      **trainer,
  }

CONFIGS = {
    'bench_full': bench_full,
    'smoke_exhaustive': smoke_exhaustive,
    'train_full1chip_exhaustive': train_full1chip_exhaustive,
    'smoke_train_exhaustive': smoke_train_exhaustive,
    'train_full1chip_ransac': train_full1chip_ransac,
    'train_localization': train_localization,
    'smoke_train_ransac': smoke_train_ransac,
    'smoke_eval_ransac': smoke_eval_ransac,
    'eval_full1chip_ransac': eval_full1chip_ransac,
    'eval_full1chip_exhaustive': eval_full1chip_exhaustive,
    'train_semantics': train_semantics,
    'train_occupancy': train_occupancy,
    'smoke_semantics': smoke_semantics,
    'smoke_occupancy': smoke_occupancy,
}


def parse_config_name(spec: str) -> Tuple[str, Dict[str, Any]]:
  """``'name:key=value,...'`` (the reference's ``--config`` argument string)
  -> the name and its keyword arguments (integers where they parse)."""
  name, _, args = spec.partition(':')
  kwargs = {}
  for item in filter(None, args.split(',')):
    key, sep, value = item.partition('=')
    if not sep:
      raise ValueError(f'config argument {item!r} is not key=value')
    kwargs[key] = int(value) if value.lstrip('-').isdigit() else value
  return name, kwargs


def get_config(name: str, **kwargs) -> Config:
  """The named config; ``name`` may carry arguments, as in
  ``'train_full1chip_exhaustive:continue_step=12500,pretrained_mapper=D'``.
  Every config also takes ``mesh_data``, ``mesh_model`` (the mesh's axis
  sizes) and ``tp_min_dim``, e.g.
  ``'smoke_train_exhaustive:batch_size=4,mesh_model=2,tp_min_dim=16'``."""
  name, args = parse_config_name(name)
  if name not in CONFIGS:
    raise ValueError(f'Unknown config {name!r}; choose from {sorted(CONFIGS)}')
  args.update(kwargs)
  axes = {axis: args.pop(f'mesh_{axis}') for axis in ('data', 'model')
          if f'mesh_{axis}' in args}
  top = {'tp_min_dim': args.pop('tp_min_dim')} if 'tp_min_dim' in args else {}
  config = CONFIGS[name](**args)
  return dataclasses.replace(
      config, mesh=dataclasses.replace(config.mesh, **axes), **top)
