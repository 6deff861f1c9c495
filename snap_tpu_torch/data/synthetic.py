"""Procedural synthetic-scene generator with the SNAP batch schema.

A numpy-only copy of ``snap_tpu/data/synthetic.py``: the port imports
nothing of the JAX package, and tests/test_torch_localizer.py checks that
both generators give the same scenes for the same seed.

The upstream TFDS builder is unreleased (reference README.md:30-32), so this
generator is the framework's first-class data source for tests, smoke
training, and benchmarks. It builds a geometrically consistent world:

- each scene has a random smooth 2D ground texture (a mixture of oriented
  sinusoids) defining RGB appearance;
- street-level fisheye views render that texture by intersecting per-pixel
  camera rays with the ground plane (sky above the horizon), so multi-view
  observations of the same ground point agree — the self-supervised
  localization objective is learnable;
- the aerial raster samples the same texture on the BEV grid; semantic
  rasters threshold texture channels into boolean layers; lidar rays connect
  camera origins to ground points.

Coordinate conventions (matching the reference data, snap/data/loader.py):
- map scene frame: grid corner at the origin, z up; cameras inside the grid;
- query scene frame: camera at the x/y origin looking along +y,
  gravity-aligned;
- camera frame: x right, y down, z optical axis (forward).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np

from snap_tpu_torch.data import types as data_types

DataDict = Dict[str, Any]

# world_from_cam rotation for a yaw-0 camera looking along +y.
CAM_TO_WORLD = np.array([
    [1.0, 0.0, 0.0],
    [0.0, 0.0, 1.0],
    [0.0, -1.0, 0.0],
])


def yaw_matrix(yaw: np.ndarray) -> np.ndarray:
  cos, sin = np.cos(yaw), np.sin(yaw)
  zero, one = np.zeros_like(yaw), np.ones_like(yaw)
  return np.stack([
      cos, -sin, zero,
      sin, cos, zero,
      zero, zero, one,
  ], -1).reshape(*yaw.shape, 3, 3)


@dataclasses.dataclass
class TextureParams:
  """A random mixture of oriented 2D sinusoids per RGB channel."""

  freqs: np.ndarray  # [C, K, 2]
  phases: np.ndarray  # [C, K]
  amps: np.ndarray  # [C, K]

  @classmethod
  def sample(cls, rng: np.random.Generator, num_components: int = 24,
             num_channels: int = 3) -> 'TextureParams':
    # Mix coarse layout frequencies with fine detail (wavelengths down to
    # ~1 m) so locations are visually distinctive at the 0.2 m map scale —
    # the self-supervised matching task needs local texture identity.
    coarse = rng.uniform(-1.5, 1.5, size=(num_channels, num_components // 2, 2))
    fine = rng.uniform(-6.0, 6.0, size=(num_channels, num_components // 2, 2))
    freqs = np.concatenate([coarse, fine], axis=1)
    phases = rng.uniform(0, 2 * np.pi, size=(num_channels, num_components))
    amps = rng.normal(size=(num_channels, num_components))
    amps /= np.abs(amps).sum(-1, keepdims=True)
    return cls(freqs=freqs, phases=phases, amps=amps)

  def __call__(self, xy: np.ndarray) -> np.ndarray:
    """Evaluate the texture at ``[..., 2]`` points -> ``[..., C]`` in [0, 1]."""
    phase = np.einsum('...d,ckd->...ck', xy, self.freqs) + self.phases
    vals = (np.cos(phase) * self.amps).sum(-1)  # [..., C]
    return (vals + 1) / 2


@dataclasses.dataclass
class Boxes:
  """Axis-aligned boxes standing on the ground (buildings/obstacles)."""

  mins: np.ndarray  # [K, 3] (z always 0)
  maxs: np.ndarray  # [K, 3]
  colors: np.ndarray  # [K, 3]

  @classmethod
  def sample(cls, rng: np.random.Generator, grid_size, num: int = 5) -> 'Boxes':
    gx, gy, _ = grid_size
    centers = rng.uniform([3, 3], [gx - 3, gy - 3], size=(num, 2))
    sizes = rng.uniform(1.5, 4.0, size=(num, 2))
    heights = rng.uniform(3.0, 8.0, size=(num, 1))
    mins = np.concatenate([centers - sizes / 2, np.zeros((num, 1))], -1)
    maxs = np.concatenate([centers + sizes / 2, heights], -1)
    colors = rng.uniform(0.2, 0.9, size=(num, 3))
    return cls(mins=mins, maxs=maxs, colors=colors)

  def raycast(self, origins: np.ndarray, dirs: np.ndarray):
    """First-hit distance and box index for ``[..., 3]`` rays (slab method).

    Returns (t [...], hit_index [...]) with t=inf where nothing is hit.
    """
    o = origins[..., None, :]  # [..., K, 3]
    d = dirs[..., None, :]
    safe_d = np.where(np.abs(d) < 1e-9, 1e-9, d)
    t1 = (self.mins - o) / safe_d
    t2 = (self.maxs - o) / safe_d
    t_near = np.minimum(t1, t2).max(-1)
    t_far = np.maximum(t1, t2).min(-1)
    hit = (t_far >= np.maximum(t_near, 1e-4))
    t_near = np.where(hit & (t_near > 1e-4), t_near, np.inf)
    idx = np.argmin(t_near, axis=-1)
    t = np.take_along_axis(t_near, idx[..., None], axis=-1)[..., 0]
    return t, idx

  def footprint_mask(self, xy: np.ndarray) -> np.ndarray:
    """Boolean [...,] mask of points inside any box footprint."""
    inside = (
        (xy[..., None, 0] >= self.mins[:, 0])
        & (xy[..., None, 0] < self.maxs[:, 0])
        & (xy[..., None, 1] >= self.mins[:, 1])
        & (xy[..., None, 1] < self.maxs[:, 1])
    )
    return inside.any(-1)


def make_fisheye_intrinsics(
    image_hw: Tuple[int, int], hfov_deg: float = 72.0
) -> DataDict:
  h, w = image_hw
  f = (w / 2) / np.tan(np.deg2rad(hfov_deg) / 2)
  K = np.array([
      [f, 0.0, w / 2],
      [0.0, f, h / 2],
      [0.0, 0.0, 1.0],
  ], dtype=np.float32)
  return {
      'K': K,
      'image_width': np.float32(w),
      'image_height': np.float32(h),
      'distortion': {'radial': np.zeros(3, np.float32)},
      'maxfov': np.float32(np.deg2rad(115.0)),
  }


def render_view(
    texture: TextureParams,
    world_from_cam_r: np.ndarray,
    cam_pos: np.ndarray,
    intrinsics: DataDict,
    image_hw: Tuple[int, int],
    boxes: Optional[Boxes] = None,
) -> np.ndarray:
  """Render the ground texture + boxes seen by a pinhole-ish camera."""
  h, w = image_hw
  K = intrinsics['K']
  # Pixel centers (half-integer convention).
  u, v = np.meshgrid(np.arange(w) + 0.5, np.arange(h) + 0.5)
  rays_cam = np.stack([
      (u - K[0, 2]) / K[0, 0],
      (v - K[1, 2]) / K[1, 1],
      np.ones_like(u),
  ], -1)
  rays_world = rays_cam @ world_from_cam_r.T
  # Intersect z = 0: t = -cam_z / ray_z for downward rays.
  rz = rays_world[..., 2]
  hits_ground = rz < -1e-4
  t_ground = np.where(
      hits_ground, -cam_pos[2] / np.where(hits_ground, rz, -1.0), np.inf)
  ground_xy = cam_pos[:2] + t_ground[..., None] * rays_world[..., :2]
  ground_xy = np.nan_to_num(ground_xy, posinf=0.0, neginf=0.0)
  colors = texture(ground_xy).astype(np.float32)
  dist = np.linalg.norm(ground_xy - cam_pos[:2], axis=-1)
  fade = np.exp(-dist / 60.0)[..., None]
  sky = np.array([0.55, 0.65, 0.8], np.float32)
  img = np.where(hits_ground[..., None], colors * fade + sky * (1 - fade), sky)

  if boxes is not None and len(boxes.mins):
    norm = np.linalg.norm(rays_world, axis=-1, keepdims=True)
    dirs = rays_world / norm
    t_box, idx = boxes.raycast(np.broadcast_to(cam_pos, dirs.shape), dirs)
    box_in_front = t_box * norm[..., 0] < t_ground
    box_color = boxes.colors[idx].astype(np.float32)
    # Simple height shading so faces are not flat.
    hit_z = cam_pos[2] + t_box * dirs[..., 2]
    shade = np.clip(0.6 + 0.08 * np.nan_to_num(hit_z), 0.3, 1.0)[..., None]
    img = np.where(box_in_front[..., None], box_color * shade, img)
  return np.clip(img, 0.0, 1.0).astype(np.float32)


@dataclasses.dataclass
class SyntheticSceneGenerator:
  """Generates scene dicts with the reference batch schema."""

  scene_config: data_types.SceneConfig
  rasters_config: data_types.RastersConfig
  lidar_config: data_types.LidarConfig
  pairing_config: data_types.PairingConfig = dataclasses.field(
      default_factory=data_types.PairingConfig)
  image_hw: Tuple[int, int] = (90, 120)
  num_boxes: int = 5
  voxel_size: float = 0.2
  camera_height_range: Tuple[float, float] = (2.0, 3.0)
  seed: int = 0

  def scene_rng(self, index: int, salt: int = 0) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence([self.seed, salt, index]))

  def _sample_map_views(
      self, rng: np.random.Generator
  ) -> Tuple[np.ndarray, np.ndarray]:
    """Camera positions along a rough driving path + yaws."""
    cfg = self.scene_config
    gx, gy, _ = cfg.grid_size
    num = cfg.num_views
    start = rng.uniform([2, 2], [gx - 2, gy - 2])
    direction = rng.uniform(0, 2 * np.pi)
    positions = []
    pos = start
    for _ in range(num):
      positions.append(pos.copy())
      step = rng.uniform(cfg.min_distance_between_views,
                         min(cfg.max_distance_between_views, 4.0))
      direction += rng.normal() * 0.3
      pos = pos + step * np.array([np.cos(direction), np.sin(direction)])
      pos = np.clip(pos, 1.0, [gx - 1, gy - 1])
    positions = np.stack(positions)
    z = rng.uniform(*self.camera_height_range, size=num)
    yaws = rng.uniform(0, 2 * np.pi, size=num)
    return np.concatenate([positions, z[:, None]], -1), yaws

  def _views_dict(
      self,
      texture: TextureParams,
      positions: np.ndarray,
      yaws: np.ndarray,
      add_images: bool,
      boxes: Optional[Boxes] = None,
      scene2world: Optional[Tuple[np.ndarray, np.ndarray]] = None,
  ) -> DataDict:
    """Views posed in the scene frame; rendering happens in the world frame.

    ``scene2world`` (R [3,3], t [3]) maps scene-frame poses into the frame the
    texture/boxes live in (identity when the scene frame IS the world frame).
    """
    num = len(positions)
    intr = make_fisheye_intrinsics(
        self.image_hw, self.scene_config.streetview_hfov_deg)
    R = yaw_matrix(yaws) @ CAM_TO_WORLD  # [V, 3, 3] world_from_cam
    ret = {
        'T_view2scene': {
            'R': R.astype(np.float32),
            't': positions.astype(np.float32),
        },
        'camera': {
            'K': np.tile(intr['K'], (num, 1, 1)),
            'image_width': np.full(num, intr['image_width']),
            'image_height': np.full(num, intr['image_height']),
            'distortion': {
                'radial': np.tile(intr['distortion']['radial'], (num, 1))
            },
            'maxfov': np.full(num, intr['maxfov']),
        },
    }
    if add_images:
      if scene2world is None:
        render_r, render_pos = R, positions
      else:
        r_s2w, t_s2w = scene2world
        render_r = r_s2w[None] @ R
        render_pos = positions @ r_s2w.T + t_s2w
      images = np.stack([
          render_view(texture, render_r[i], render_pos[i], intr,
                      self.image_hw, boxes)
          for i in range(num)
      ])
      ret['images'] = images
    return ret

  def _rig_coverage(
      self,
      positions: np.ndarray,
      yaws: np.ndarray,
      cell: float = 1.0,
      scene2common: Optional[Tuple[np.ndarray, np.ndarray]] = None,
  ) -> np.ndarray:
    """Boolean grid of common-frame cells covered by the rig's view frusta.

    A cell counts as covered when some view sees its center within the
    camera frustum depth and half the horizontal FoV. Used to compute the
    pair ``overlap`` field (reference contract: snap/data/types.py:64-74).
    """
    cfg = self.scene_config
    gx, gy, _ = cfg.grid_size
    ii, jj = np.meshgrid(
        np.arange(gx / cell), np.arange(gy / cell), indexing='ij')
    centers = (np.stack([ii, jj], -1) + 0.5) * cell  # common frame
    if scene2common is None:
      cam_xy = positions[:, :2]
      fwd = np.stack([-np.sin(yaws), np.cos(yaws)], -1)
    else:
      r_s2c, t_s2c = scene2common
      cam_xy = positions[:, :2] @ r_s2c[:2, :2].T + t_s2c[:2]
      fwd = np.stack([-np.sin(yaws), np.cos(yaws)], -1) @ r_s2c[:2, :2].T
      # Also require the *cell* to be inside this rig's own grid.
      r_c2s = r_s2c[:2, :2].T
      cells_scene = (centers - t_s2c[:2]) @ r_c2s.T
      in_cells = ((cells_scene >= 0) & (cells_scene < [gx, gy])).all(-1)
    rel = centers[..., None, :] - cam_xy  # [X, Y, V, 2]
    dist = np.linalg.norm(rel, axis=-1)
    cos_angle = (rel * fwd).sum(-1) / np.maximum(dist, 1e-6)
    half_fov = np.deg2rad(cfg.streetview_hfov_deg) / 2
    seen = (dist <= cfg.camera_frustum_depth) & (
        cos_angle >= np.cos(half_fov))
    covered = seen.any(-1)
    if scene2common is not None:
      covered &= in_cells
    return covered

  def _rasters(
      self,
      texture: TextureParams,
      boxes: Optional[Boxes] = None,
      scene2world: Optional[Tuple[np.ndarray, np.ndarray]] = None,
  ) -> DataDict:
    gx, gy, _ = self.scene_config.grid_size
    nx = int(round(gx / self.voxel_size))
    ny = int(round(gy / self.voxel_size))
    ii, jj = np.meshgrid(np.arange(nx), np.arange(ny), indexing='ij')
    xy = (np.stack([ii, jj], -1) + 0.5) * self.voxel_size
    if scene2world is not None:
      r_s2w, t_s2w = scene2world
      xy = xy @ r_s2w[:2, :2].T + t_s2w[:2]
    rgb = texture(xy).astype(np.float32)
    rasters: DataDict = {'rgb': rgb}
    # Boolean layers from texture-channel thresholds: crude but consistent
    # across the aerial raster, the views, and the lidar geometry.
    classes = list(self.rasters_config.semantic_classes)
    thresholds = np.linspace(0.35, 0.65, len(classes))
    sem = np.stack([
        rgb[..., i % 3] > t for i, t in enumerate(thresholds)], -1)
    rasters['semantics'] = sem
    gt_classes = list(self.rasters_config.gt_semantic_classes)
    # Band-partitioned GT masks: class i's mask is a level BAND of its
    # texture channel, not a nested superlevel set. Nested sets made the
    # head-supervision argmax labels degenerate — same-channel masks are
    # subsets of each other, so 97.8% of cells labeled as the first class
    # and most per-class recalls pinned at 0/0 (measured, round 5,
    # results/run_sem_head_r5). Same-channel bands are disjoint (honest
    # support for every class); cross-channel overlaps keep the
    # multi-label character. Edges span the texture's 10-90% quantile
    # range (~[0.37, 0.63]) with open tails.
    n_gt = len(gt_classes)
    gt = np.zeros((*rgb.shape[:-1], n_gt), bool)
    for ch in range(3):
      group = [i for i in range(n_gt) if (i + 1) % 3 == ch]
      if not group:
        continue
      edges = np.linspace(0.36, 0.64, len(group) + 1)
      edges[0], edges[-1] = -np.inf, np.inf
      v = rgb[..., ch]
      for rank, i in enumerate(group):
        gt[..., i] = (v > edges[rank]) & (v <= edges[rank + 1])
    if boxes is not None:
      footprint = boxes.footprint_mask(xy)
      rgb = np.where(
          footprint[..., None],
          boxes.colors[np.argmax(
              footprint[..., None] & np.ones(len(boxes.mins), bool), -1)],
          rgb).astype(np.float32)
      rasters['rgb'] = rgb
      for name in ('buildings_raw', 'buildings_contoured'):
        if name in classes:
          sem[..., classes.index(name)] = footprint
      if 'building' in gt_classes:
        gt[..., gt_classes.index('building')] = footprint
    rasters['gt_semantics'] = gt
    return rasters

  def _lidar_rays(
      self,
      rng: np.random.Generator,
      positions: np.ndarray,
      num_rays: int,
      boxes: Optional[Boxes] = None,
      scene2world: Optional[Tuple[np.ndarray, np.ndarray]] = None,
  ) -> DataDict:
    """First-hit raycasts from camera origins (ground plane + box walls).

    Origins/points are scene-frame; box intersection happens in the world
    frame (the scene2world transform is z-preserving, so the ground plane is
    shared).
    """
    num_views = len(positions)
    view_idx = rng.integers(0, num_views, size=num_rays)
    origins = positions[view_idx]
    azim = rng.uniform(0, 2 * np.pi, size=num_rays)
    elev = rng.uniform(np.deg2rad(-35.0), np.deg2rad(10.0), size=num_rays)
    dirs = np.stack([
        np.cos(elev) * np.cos(azim),
        np.cos(elev) * np.sin(azim),
        np.sin(elev),
    ], -1)
    down = dirs[:, 2] < -1e-4
    t_ground = np.where(down, -origins[:, 2] / np.where(down, dirs[:, 2], -1),
                        np.inf)
    t = t_ground
    if boxes is not None and len(boxes.mins):
      if scene2world is not None:
        r_s2w, t_s2w = scene2world
        origins_w = origins @ r_s2w.T + t_s2w
        dirs_w = dirs @ r_s2w.T
      else:
        origins_w, dirs_w = origins, dirs
      t_box, _ = boxes.raycast(origins_w, dirs_w)
      t = np.minimum(t, t_box)
    mask = np.isfinite(t) & (t < 40.0)
    t_safe = np.where(mask, t, 1.0)
    points = origins + t_safe[:, None] * dirs
    return {
        'points': points.astype(np.float32),
        'origins': origins.astype(np.float32),
        'mask': mask,
    }

  def make_map_scene(
      self,
      index: int,
      add_images: bool = True,
      add_rasters: bool = False,
      add_lidar_rays: bool = False,
      num_rays: Optional[int] = None,
      world: Optional[tuple] = None,
      rig_salt: int = 1,
      scene2world: Optional[Tuple[np.ndarray, np.ndarray]] = None,
      rig: Optional[Tuple[np.ndarray, np.ndarray]] = None,
  ) -> Tuple[DataDict, tuple]:
    """Build one map scene.

    ``world`` reuses an existing (texture, boxes) world; ``scene2world``
    expresses this scene's frame in that world's frame (for the second rig of
    a PAIR_SCENES example); ``rig`` injects pre-sampled (positions, yaws).
    """
    rng = self.scene_rng(index, salt=rig_salt)
    if world is None:
      texture = TextureParams.sample(rng)
      boxes = Boxes.sample(rng, self.scene_config.grid_size, self.num_boxes)
    else:
      texture, boxes = world
    positions, yaws = rig if rig is not None else self._sample_map_views(rng)
    scene = self._views_dict(
        texture, positions, yaws, add_images, boxes, scene2world)
    scene['scene_id'] = f'synthetic/{self.seed}/{index}'
    scene['vehicle_type'] = 'CAR'
    scene['latlng'] = np.zeros(2, np.float32)
    if add_rasters:
      scene['rasters'] = self._rasters(texture, boxes, scene2world)
    if add_lidar_rays:
      scene['lidar_rays'] = self._lidar_rays(
          rng, positions, num_rays or self.lidar_config.num_rays, boxes,
          scene2world)
    return scene, (texture, boxes)

  def make_query_scene(
      self, index: int, world
  ) -> Tuple[DataDict, DataDict]:
    """A single-view trekker query + its T_query2map ground truth."""
    rng = self.scene_rng(index, salt=2)
    cfg = self.scene_config
    gx, gy, _ = cfg.grid_size
    # Keep the camera inside the map with room for the frustum.
    margin = min(4.0, cfg.camera_frustum_depth / 4)
    cam_xy_map = rng.uniform([margin, margin], [gx - margin, gy - margin])
    cam_z = rng.uniform(*self.camera_height_range)
    yaw_map = rng.uniform(0, 2 * np.pi)

    # Query scene frame: camera at the x/y origin, looking along +y, z up,
    # ground at z = 0 (same elevation as the map scene).
    positions = np.array([[0.0, 0.0, cam_z]])
    yaws = np.zeros(1)
    # Render in the map frame, then express the pose in the query frame.
    r_world = yaw_matrix(np.array(yaw_map)) @ CAM_TO_WORLD
    intr = make_fisheye_intrinsics(self.image_hw, cfg.streetview_hfov_deg)
    cam_pos_map = np.array([*cam_xy_map, cam_z])
    texture, boxes = world
    image = render_view(
        texture, r_world, cam_pos_map, intr, self.image_hw, boxes)

    scene = self._views_dict(texture, positions, yaws, add_images=False)
    scene['images'] = image[None]
    scene['scene_id'] = f'synthetic_query/{self.seed}/{index}'
    scene['vehicle_type'] = 'TREKKER'
    scene['latlng'] = np.zeros(2, np.float32)

    t_query2map = {
        'R': yaw_matrix(np.array(yaw_map)).astype(np.float32),
        't': np.array([*cam_xy_map, 0.0], np.float32),
    }
    return scene, t_query2map

  def make_example(
      self,
      index: int,
      mode: data_types.DataMode,
      add_images: bool = True,
      add_rasters: bool = False,
      add_lidar_rays: bool = False,
      num_rays: Optional[int] = None,
  ) -> DataDict:
    """One example in the requested mode (reference schema,
    snap/data/loader.py:113-136)."""
    kwargs = dict(add_images=add_images, add_rasters=add_rasters,
                  add_lidar_rays=add_lidar_rays, num_rays=num_rays)
    if mode == data_types.DataMode.SINGLE_SCENE:
      scene, _ = self.make_map_scene(index, **kwargs)
      return scene
    if mode == data_types.DataMode.PAIR_SCENE_VIEW:
      map_scene, world = self.make_map_scene(index, **kwargs)
      query_scene, t_query2map = self.make_query_scene(index, world)
      # Real frustum-coverage overlap (reference contract:
      # snap/data/types.py:71-81): the fraction of the query view's frustum
      # cells the map rig also covers — the evaluator dumps this per example
      # for recall-vs-overlap analysis, so a constant would make that
      # analysis vacuous (round-2 verdict).
      pos_map = map_scene['T_view2scene']['t'].astype(np.float64)
      yaw_mats = (
          map_scene['T_view2scene']['R'].astype(np.float64) @ CAM_TO_WORLD.T)
      yaws_map = np.arctan2(yaw_mats[:, 1, 0], yaw_mats[:, 0, 0])
      cov_map = self._rig_coverage(pos_map, yaws_map)
      r_q = t_query2map['R'].astype(np.float64)
      yaw_q = np.arctan2(r_q[1, 0], r_q[0, 0])
      cov_q = self._rig_coverage(
          t_query2map['t'].astype(np.float64)[None], np.array([yaw_q]))
      overlap = float((cov_q & cov_map).sum() / max(cov_q.sum(), 1))
      return {
          'map': map_scene,
          'query': query_scene,
          'T_query2map': t_query2map,
          'overlap': np.float32(overlap),
          'time_delta_days': np.float32(0.0),
          'pair_id': f'{map_scene["scene_id"]}|{query_scene["scene_id"]}',
      }
    if mode == data_types.DataMode.PAIR_SCENES:
      # Two *independent* rigs over the same world (reference schema:
      # snap/data/loader.py:121-124 — keys scene_i/scene_j + T_j2i).
      # scene_j lives in its own shifted/yawed frame; its rig, rasters, and
      # lidar are rendered from the shared world through T_j2i. The pair is
      # resampled until the frustum-coverage overlap falls inside the
      # PairingConfig window (snap/data/types.py:64-74).
      scene_i, world = self.make_map_scene(index, **kwargs)
      # Recover scene_i's rig from its pose dict (R = yaw_matrix @ CAM_TO_WORLD).
      pos_i = scene_i['T_view2scene']['t'].astype(np.float64)
      yaw_mats = scene_i['T_view2scene']['R'].astype(np.float64) @ CAM_TO_WORLD.T
      yaws_i = np.arctan2(yaw_mats[:, 1, 0], yaw_mats[:, 0, 0])
      cov_i = self._rig_coverage(pos_i, yaws_i)

      pairing = self.pairing_config
      best = None
      for attempt in range(8):
        rng_j = self.scene_rng(index, salt=100 + attempt)
        shift = rng_j.uniform([-8, -8], [8, 8])
        yaw = rng_j.uniform(-np.pi / 4, np.pi / 4)
        r_j2i = yaw_matrix(np.array(yaw))
        t_j2i_vec = np.array([*shift, 0.0])
        rig_j = self._sample_map_views(rng_j)
        cov_j = self._rig_coverage(
            *rig_j, scene2common=(r_j2i, t_j2i_vec))
        union = (cov_i | cov_j).sum()
        overlap = float((cov_i & cov_j).sum() / max(union, 1))
        candidate = (overlap, rig_j, r_j2i, t_j2i_vec)
        if pairing.min_overlap <= overlap <= pairing.max_overlap:
          best = candidate
          break
        # Keep the attempt closest to the window as a fallback.
        mid = (pairing.min_overlap + pairing.max_overlap) / 2
        if best is None or abs(overlap - mid) < abs(best[0] - mid):
          best = candidate
      overlap, rig_j, r_j2i, t_j2i_vec = best

      scene_j, _ = self.make_map_scene(
          index, **kwargs, world=world, rig_salt=4,
          scene2world=(r_j2i, t_j2i_vec), rig=rig_j)
      scene_j['scene_id'] = scene_j['scene_id'] + '/j'
      return {
          'scene_i': scene_i,
          'scene_j': scene_j,
          'T_j2i': {
              'R': r_j2i.astype(np.float32),
              't': t_j2i_vec.astype(np.float32),
          },
          'overlap': np.float32(overlap),
          'time_delta_days': np.float32(0.0),
      }
    raise NotImplementedError(mode)
