"""Synthetic scenes made on the device that consumes them.

The port of ``snap_tpu/data/device_synthetic.py``. The host generator
(``synthetic.py``) renders one example at a time in numpy: seconds of host
time per batch at full width. Here a whole batch is one pass of batched
tensor operations on the requested device (``[B * V, H, W, ...]`` per-pixel
rays, texture, raycasts; ``[B, X, Y]`` rasters; ``[B, C, X, Y]`` coverage
grids), so the host only draws the few random numbers a scene needs and
formats the string side-channel.

Each example is split into its **draws** and a **pure function of the
draws**:

- the draws (texture 3 x 24 sinusoids, 5 boxes, a rig of V steps, the
  query pose, 8 pairing candidates, the lidar angles) come from a numpy
  ``Generator(Philox)`` keyed by ``SeedSequence([seed, salt, index])``,
  the salts of the reference's ``fold_in`` chain (1 map scene, 2 query,
  100 + c pairing candidate c, 4 the second rig's lidar). They are the
  same on every device, so a batch made on the card can be held against
  the same batch made on the CPU;
- ``make_batch`` turns a batch of draws into the batch on ``device``.

The contract is the reference's: same schema, world model, pairing rule
and distributions (``device_synthetic.py:14-18``), not JAX's threefry bits
(tests/test_torch_device_synthetic.py injects JAX's draws to compare the
functions, and compares the port's own draws by distribution).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from snap_tpu_torch.data import types as data_types
from snap_tpu_torch.utils import geometry

Tensor = torch.Tensor
DataDict = Dict[str, Any]
Device = Union[str, torch.device]
RigidTransform = Tuple[Tensor, Tensor]  # (R [..., 3, 3], t [..., 3])

# world_from_cam rotation for a yaw-0 camera looking along +y (z up).
CAM_TO_WORLD = np.array([
    [1.0, 0.0, 0.0],
    [0.0, 0.0, 1.0],
    [0.0, -1.0, 0.0],
])

FAR = 1e9  # Finite stand-in for "no hit" (inf breaks where-free math).
# Pixels rendered per chunk: bounds the [pixels, 3 * 24] texture phases to
# ~0.3 GB and the [pixels, boxes, 3] slab temporaries to ~63 MB each.
_CHUNK_PIXELS = 1 << 20
SKY = (0.55, 0.65, 0.8)
# Draw salts of the reference's ``make_example`` (``scene_key(salt)``).
MAP_SALT, QUERY_SALT, RIG_J_SALT, CANDIDATE_SALT = 1, 2, 4, 100
NUM_CANDIDATES = 8


def yaw_matrix(yaw: Tensor) -> Tensor:
  cos, sin = torch.cos(yaw), torch.sin(yaw)
  zero, one = torch.zeros_like(yaw), torch.ones_like(yaw)
  return torch.stack([
      cos, -sin, zero,
      sin, cos, zero,
      zero, zero, one,
  ], -1).reshape(*yaw.shape, 3, 3)


@dataclasses.dataclass(frozen=True)
class Spec:
  """Static generation parameters."""

  num_views: int = 10
  image_hw: Tuple[int, int] = (90, 120)
  grid_size: Tuple[float, float, float] = (24.0, 32.0, 12.0)
  voxel_size: float = 0.2
  hfov_deg: float = 72.0
  frustum_depth: float = 16.0
  min_step: float = 1.5
  max_step: float = 4.0
  num_boxes: int = 5
  num_tex_components: int = 24
  camera_height_range: Tuple[float, float] = (2.0, 3.0)
  num_sem_classes: int = 8
  num_gt_classes: int = 6
  building_sem_indices: Tuple[int, ...] = ()
  building_gt_index: Optional[int] = None
  add_images: bool = True
  add_rasters: bool = False
  add_lidar_rays: bool = False
  num_rays: int = 10_000
  pair_overlap: Tuple[float, float] = (0.3, 0.7)

  @classmethod
  def from_configs(cls, scene_config: data_types.SceneConfig,
                   rasters_config: data_types.RastersConfig, image_hw,
                   voxel_size, **flags) -> 'Spec':
    sem = list(rasters_config.semantic_classes)
    gt = list(rasters_config.gt_semantic_classes)
    return cls(
        num_views=scene_config.num_views,
        image_hw=tuple(image_hw),
        grid_size=tuple(float(g) for g in scene_config.grid_size),
        voxel_size=float(voxel_size),
        hfov_deg=float(scene_config.streetview_hfov_deg),
        frustum_depth=float(scene_config.camera_frustum_depth),
        min_step=float(scene_config.min_distance_between_views),
        max_step=float(scene_config.max_distance_between_views),
        num_sem_classes=len(sem),
        num_gt_classes=len(gt),
        building_sem_indices=tuple(
            sem.index(n) for n in data_types.AERIAL_BUILDING_CLASSES
            if n in sem),
        building_gt_index=gt.index('building') if 'building' in gt else None,
        **flags,
    )


# --- draws (host, numpy) ---------------------------------------------------


def draw_rng(seed: int, salt: int, index: int) -> np.random.Generator:
  """The counter-keyed generator of one (seed, salt, index)."""
  return np.random.Generator(np.random.Philox(
      np.random.SeedSequence([int(seed), int(salt), int(index)])))


def _f32(**arrays) -> DataDict:
  return {k: np.asarray(v, np.float32) for k, v in arrays.items()}


def draw_texture(rng: np.random.Generator, spec: Spec) -> DataDict:
  """A random mixture of oriented 2D sinusoids per RGB channel."""
  half = spec.num_tex_components // 2
  coarse = rng.uniform(-1.5, 1.5, (3, half, 2))
  fine = rng.uniform(-6.0, 6.0, (3, half, 2))
  phases = rng.uniform(0.0, 2 * np.pi, (3, spec.num_tex_components))
  amps = rng.normal(size=(3, spec.num_tex_components))
  amps /= np.abs(amps).sum(-1, keepdims=True)
  return _f32(freqs=np.concatenate([coarse, fine], 1), phases=phases,
              amps=amps)


def draw_boxes(rng: np.random.Generator, spec: Spec) -> DataDict:
  gx, gy, _ = spec.grid_size
  n = spec.num_boxes
  centers = rng.uniform([3.0, 3.0], [gx - 3.0, gy - 3.0], (n, 2))
  sizes = rng.uniform(1.5, 4.0, (n, 2))
  heights = rng.uniform(3.0, 8.0, (n, 1))
  return _f32(
      mins=np.concatenate([centers - sizes / 2, np.zeros((n, 1))], -1),
      maxs=np.concatenate([centers + sizes / 2, heights], -1),
      colors=rng.uniform(0.2, 0.9, (n, 3)))


def draw_rig(rng: np.random.Generator, spec: Spec) -> DataDict:
  """The random inputs of a rig's walk (``rig_walk``)."""
  gx, gy, _ = spec.grid_size
  num = spec.num_views
  return _f32(
      start=rng.uniform([2.0, 2.0], [gx - 2.0, gy - 2.0]),
      dir0=rng.uniform(0.0, 2 * np.pi),
      steps=rng.uniform(spec.min_step, min(spec.max_step, 4.0), num),
      wander=rng.normal(size=num) * 0.3,
      z=rng.uniform(*spec.camera_height_range, num),
      yaws=rng.uniform(0.0, 2 * np.pi, num))


def draw_lidar(rng: np.random.Generator, spec: Spec) -> DataDict:
  n = spec.num_rays
  return {
      'view_idx': rng.integers(0, spec.num_views, n),
      **_f32(azim=rng.uniform(0.0, 2 * np.pi, n),
             elev=rng.uniform(np.deg2rad(-35.0), np.deg2rad(10.0), n)),
  }


def draw_query(rng: np.random.Generator, spec: Spec) -> DataDict:
  gx, gy, _ = spec.grid_size
  margin = min(4.0, spec.frustum_depth / 4)
  return _f32(xy=rng.uniform([margin, margin], [gx - margin, gy - margin]),
              z=rng.uniform(*spec.camera_height_range),
              yaw=rng.uniform(0.0, 2 * np.pi))


def draw_candidate(rng: np.random.Generator, spec: Spec) -> DataDict:
  """A second rig for PAIR_SCENES: its frame's shift and yaw, its walk."""
  return {**_f32(shift=rng.uniform(-8.0, 8.0, 2),
                 yaw=rng.uniform(-np.pi / 4, np.pi / 4)),
          'rig': draw_rig(rng, spec)}


def _stack(trees: Sequence[DataDict]) -> DataDict:
  if isinstance(trees[0], dict):
    return {k: _stack([t[k] for t in trees]) for k in trees[0]}
  return np.stack(trees)


def draw_example(spec: Spec, mode: data_types.DataMode, seed: int,
                 index: int) -> DataDict:
  """Every random input of example ``index`` (numpy, the same everywhere)."""
  rng = draw_rng(seed, MAP_SALT, index)
  draws = {'texture': draw_texture(rng, spec), 'boxes': draw_boxes(rng, spec),
           'rig': draw_rig(rng, spec)}
  if spec.add_lidar_rays:
    draws['lidar'] = draw_lidar(rng, spec)
  if mode == data_types.DataMode.PAIR_SCENE_VIEW:
    draws['query'] = draw_query(draw_rng(seed, QUERY_SALT, index), spec)
  elif mode == data_types.DataMode.PAIR_SCENES:
    draws['candidates'] = _stack([
        draw_candidate(draw_rng(seed, CANDIDATE_SALT + c, index), spec)
        for c in range(NUM_CANDIDATES)])
    if spec.add_lidar_rays:
      draws['lidar_j'] = draw_lidar(draw_rng(seed, RIG_J_SALT, index), spec)
  elif mode != data_types.DataMode.SINGLE_SCENE:
    raise NotImplementedError(mode)
  return draws


def draw_batch(spec: Spec, mode: data_types.DataMode, seed: int,
               indices: Sequence[int]) -> DataDict:
  """The draws of ``indices``, stacked with a leading batch axis."""
  return _stack([draw_example(spec, mode, seed, i) for i in indices])


def draws_to(draws: DataDict, device: Device) -> DataDict:
  if isinstance(draws, dict):
    return {k: draws_to(v, device) for k, v in draws.items()}
  return torch.as_tensor(draws, device=device)


# --- world functions (torch, batched) --------------------------------------


def _rotate(r: Tensor, p: Tensor) -> Tensor:
  """``p @ r.T`` written out over the columns: ``r [*B, n, n]`` against
  ``p [*B, *S, n]`` (any ``S``, n = 2 or 3)."""
  r = r.reshape(*r.shape[:-2], *([1] * (p.ndim - r.ndim + 1)),
                *r.shape[-2:])
  out = p[..., 0, None] * r[..., :, 0]
  for j in range(1, p.shape[-1]):
    out = out + p[..., j, None] * r[..., :, j]
  return out


def _batched(x: Tensor, nb: int, ndim: int) -> Tensor:
  """``x [*B, *E]`` (``nb`` batch axes) with unit axes inserted after the
  batch axes so that it has ``ndim`` axes."""
  return x.reshape(*x.shape[:nb], *([1] * (ndim - x.ndim)), *x.shape[nb:])


def texture_eval(texture: DataDict, xy: Tensor) -> Tensor:
  """Evaluate ``texture`` (fields ``[*B, 3, K, ...]``) at ``xy [*B, *S, 2]``
  -> ``[*B, *S, 3]`` in [0, 1]."""
  freqs = texture['freqs']
  nb = freqs.ndim - 3
  k = freqs.shape[-2]
  pts = xy.reshape(*xy.shape[:nb], -1, 2)
  fx = freqs[..., 0].reshape(*freqs.shape[:nb], 1, 3 * k)
  fy = freqs[..., 1].reshape(*freqs.shape[:nb], 1, 3 * k)
  phases = texture['phases'].reshape(*freqs.shape[:nb], 1, 3 * k)
  amps = texture['amps'].reshape(*freqs.shape[:nb], 1, 3, k)
  step = max(1, _CHUNK_PIXELS // max(1, int(np.prod(pts.shape[:nb]))))
  out = []
  for chunk in pts.split(step, dim=nb):
    phase = chunk[..., 0, None] * fx + chunk[..., 1, None] * fy
    waves = torch.cos(phase + phases).reshape(*chunk.shape[:-1], 3, k)
    out.append(((waves * amps).sum(-1) + 1) / 2)
  return torch.cat(out, nb).reshape(*xy.shape[:-1], 3)


def raycast_boxes(boxes: DataDict, origins: Tensor,
                  dirs: Tensor) -> Tuple[Tensor, Tensor]:
  """Slab-method first hit of ``[*B, *S, 3]`` rays against the boxes
  ``[*B, K, 3]`` -> (t, box index), each ``[*B, *S]``; t = ``FAR`` where
  nothing is hit."""
  nb = boxes['mins'].ndim - 2
  ndim = origins.ndim + 1
  mins = _batched(boxes['mins'], nb, ndim)
  maxs = _batched(boxes['maxs'], nb, ndim)
  o, d = origins[..., None, :], dirs[..., None, :]
  safe_d = torch.where(d.abs() < 1e-9, 1e-9, d)
  t1 = (mins - o) / safe_d
  t2 = (maxs - o) / safe_d
  t_near = torch.minimum(t1, t2).amax(-1)
  t_far = torch.maximum(t1, t2).amin(-1)
  hit = (t_far >= t_near.clamp(min=1e-4)) & (t_near > 1e-4)
  t_near = torch.where(hit, t_near, FAR)
  t, idx = t_near.min(-1)
  return t, idx


def box_footprint(boxes: DataDict, xy: Tensor) -> Tensor:
  """``[*B, *S, K]``: whether ``xy [*B, *S, 2]`` lies in each box's
  footprint."""
  nb = boxes['mins'].ndim - 2
  ndim = xy.ndim + 1
  mins = _batched(boxes['mins'], nb, ndim)
  maxs = _batched(boxes['maxs'], nb, ndim)
  x, y = xy[..., None, 0], xy[..., None, 1]
  return ((x >= mins[..., 0]) & (x < maxs[..., 0])
          & (y >= mins[..., 1]) & (y < maxs[..., 1]))


def _take_rows(table: Tensor, idx: Tensor) -> Tensor:
  """``table [B, K, C]`` at ``idx [B, *S]`` -> ``[B, *S, C]``."""
  flat = idx.reshape(idx.shape[0], -1, 1).expand(-1, -1, table.shape[-1])
  return torch.gather(table, 1, flat).reshape(*idx.shape, table.shape[-1])


# --- rendering -------------------------------------------------------------


def _pixel_rays_cam(spec: Spec) -> np.ndarray:
  """Camera-frame ray directions per pixel, ``[H, W, 3]``."""
  h, w = spec.image_hw
  f = (w / 2) / np.tan(np.deg2rad(spec.hfov_deg) / 2)
  u, v = np.meshgrid(np.arange(w) + 0.5, np.arange(h) + 0.5)
  return np.stack([(u - w / 2) / f, (v - h / 2) / f, np.ones_like(u)], -1)


def ground_hits(spec: Spec, world_from_cam_r: Tensor, cam_pos: Tensor):
  """Per pixel of views ``[N, 3, 3]``, ``[N, 3]``: the world ray
  ``[N, H, W, 3]``, whether it hits the ground, its ray parameter there and
  the hit's clipped xy."""
  rays_cam = torch.as_tensor(_pixel_rays_cam(spec), dtype=torch.float32,
                             device=cam_pos.device)
  r = world_from_cam_r[:, None, None]  # [N, 1, 1, 3, 3]
  rays = (rays_cam[..., 0, None] * r[..., 0] + rays_cam[..., 1, None]
          * r[..., 1] + rays_cam[..., 2, None] * r[..., 2])
  pos = cam_pos[:, None, None]
  rz = rays[..., 2]
  hits = rz < -1e-4
  t_ground = torch.where(hits, -pos[..., 2] / torch.where(hits, rz, -1.0),
                         FAR)
  xy = (pos[..., :2] + t_ground[..., None] * rays[..., :2]).clamp(-1e4, 1e4)
  return rays, hits, t_ground, xy


def _render_rows(spec: Spec, texture: DataDict, boxes: DataDict,
                 r: Tensor, pos: Tensor) -> Tensor:
  """``render_views`` of ``N`` views, each with its own world (fields with
  a leading ``N``)."""
  rays, hits, t_ground, xy = ground_hits(spec, r, pos)
  pos = pos[:, None, None]
  colors = texture_eval(texture, xy)
  dist = torch.linalg.norm(xy - pos[..., :2], dim=-1)
  fade = torch.exp(-dist / 60.0)[..., None]
  sky = torch.tensor(SKY, dtype=torch.float32, device=r.device)
  img = torch.where(hits[..., None], colors * fade + sky * (1 - fade), sky)
  if boxes['mins'].shape[-2]:
    norm = torch.linalg.norm(rays, dim=-1, keepdim=True)
    dirs = rays / norm
    t_box, idx = raycast_boxes(boxes, pos.expand(dirs.shape), dirs)
    in_front = t_box * norm[..., 0] < t_ground
    hit_z = pos[..., 2] + t_box * dirs[..., 2]
    shade = (0.6 + 0.08 * hit_z.clamp(-100, 100)).clamp(0.3, 1.0)
    img = torch.where(in_front[..., None],
                      _take_rows(boxes['colors'], idx) * shade[..., None],
                      img)
  return img.clamp(0.0, 1.0)


def render_views(spec: Spec, texture: DataDict, boxes: DataDict,
                 world_from_cam_r: Tensor, cam_pos: Tensor) -> Tensor:
  """Ground texture + boxes seen by pinhole cameras: worlds ``[B, ...]``,
  views ``[B, V, 3, 3]``, ``[B, V, 3]`` -> images ``[B, V, H, W, 3]``.

  The views of all examples are rendered as one ``[B * V, H, W]`` pass, in
  chunks of up to ``_CHUNK_PIXELS`` pixels.
  """
  b, v = cam_pos.shape[:2]
  h, w = spec.image_hw
  per_view = lambda x: x.repeat_interleave(v, 0)  # noqa: E731
  texture = {k: per_view(x) for k, x in texture.items()}
  boxes = {k: per_view(x) for k, x in boxes.items()}
  r = world_from_cam_r.reshape(b * v, 3, 3)
  pos = cam_pos.reshape(b * v, 3)
  step = max(1, _CHUNK_PIXELS // (h * w))
  out = [_render_rows(spec, {k: x[i:i + step] for k, x in texture.items()},
                      {k: x[i:i + step] for k, x in boxes.items()},
                      r[i:i + step], pos[i:i + step])
         for i in range(0, b * v, step)]
  return torch.cat(out).reshape(b, v, h, w, 3)


def make_rasters(spec: Spec, texture: DataDict, boxes: DataDict,
                 scene2world: Optional[RigidTransform] = None) -> DataDict:
  """Aerial rgb, semantic and GT layers of worlds ``[B, ...]`` on the
  scene's raster grid -> fields ``[B, X, Y, ...]``. The GT masks are bands
  of a texture channel, exactly as the host generator makes them."""
  gx, gy, _ = spec.grid_size
  b, device = texture['freqs'].shape[0], texture['freqs'].device
  ii, jj = torch.meshgrid(
      torch.arange(int(round(gx / spec.voxel_size)), device=device),
      torch.arange(int(round(gy / spec.voxel_size)), device=device),
      indexing='ij')
  xy = (torch.stack([ii, jj], -1) + 0.5) * spec.voxel_size  # [X, Y, 2]
  xy = xy.expand(b, *xy.shape)
  if scene2world is not None:
    r_s2w, t_s2w = scene2world
    xy = _rotate(r_s2w[:, :2, :2], xy) + t_s2w[:, None, None, :2]
  rgb = texture_eval(texture, xy)

  thresholds = np.linspace(0.35, 0.65, spec.num_sem_classes)
  sem = [rgb[..., i % 3] > float(t) for i, t in enumerate(thresholds)]
  n_gt = spec.num_gt_classes
  gt = [None] * n_gt
  for ch in range(3):
    group = [i for i in range(n_gt) if (i + 1) % 3 == ch]
    if not group:
      continue
    edges = np.linspace(0.36, 0.64, len(group) + 1)
    edges[0], edges[-1] = -np.inf, np.inf
    v = rgb[..., ch]
    for rank, i in enumerate(group):
      gt[i] = (v > float(edges[rank])) & (v <= float(edges[rank + 1]))

  if boxes['mins'].shape[-2]:
    inside = box_footprint(boxes, xy)  # [B, X, Y, K]
    footprint = inside.any(-1)
    first_box = inside.to(torch.uint8).argmax(-1)
    rgb = torch.where(footprint[..., None],
                      _take_rows(boxes['colors'], first_box), rgb)
    for i in spec.building_sem_indices:
      sem[i] = footprint
    if spec.building_gt_index is not None:
      gt[spec.building_gt_index] = footprint
  return {'rgb': rgb, 'semantics': torch.stack(sem, -1),
          'gt_semantics': torch.stack(gt, -1)}


def make_lidar_rays(lidar: DataDict, positions: Tensor, boxes: DataDict,
                    scene2world: Optional[RigidTransform] = None
                    ) -> DataDict:
  """First-hit raycasts from the camera origins ``[B, V, 3]`` along the
  drawn rays (``lidar`` fields ``[B, n]``; ground plane and box walls)."""
  origins = _take_rows(positions, lidar['view_idx'])  # [B, n, 3]
  azim, elev = lidar['azim'], lidar['elev']
  dirs = torch.stack([torch.cos(elev) * torch.cos(azim),
                      torch.cos(elev) * torch.sin(azim),
                      torch.sin(elev)], -1)
  down = dirs[..., 2] < -1e-4
  t = torch.where(down, -origins[..., 2] / torch.where(down, dirs[..., 2],
                                                        -1.0), FAR)
  if boxes['mins'].shape[-2]:
    if scene2world is not None:
      r_s2w, t_s2w = scene2world
      origins_w = _rotate(r_s2w, origins) + t_s2w[:, None]
      dirs_w = _rotate(r_s2w, dirs)
    else:
      origins_w, dirs_w = origins, dirs
    t_box, _ = raycast_boxes(boxes, origins_w, dirs_w)
    t = torch.minimum(t, t_box)
  mask = t < 40.0
  t_safe = torch.where(mask, t, 1.0)
  return {'points': origins + t_safe[..., None] * dirs, 'origins': origins,
          'mask': mask}


# --- scenes ----------------------------------------------------------------


def rig_walk(spec: Spec, rig: DataDict) -> Tuple[Tensor, Tensor]:
  """Camera positions along a rough driving path, and yaws: draws with
  leading axes ``[*B]`` -> ``([*B, V, 3], [*B, V])``. The heading turns by
  ``wander`` before each step, and each position is clipped into the grid
  before the next step (the reference's ``lax.scan``)."""
  gx, gy, _ = spec.grid_size
  hi = torch.tensor([gx - 1.0, gy - 1.0], device=rig['start'].device)
  pos, heading = rig['start'], rig['dir0']
  positions = []
  for v in range(rig['steps'].shape[-1]):
    positions.append(pos)
    heading = heading + rig['wander'][..., v]
    step = torch.stack([torch.cos(heading), torch.sin(heading)], -1)
    pos = torch.minimum(
        (pos + rig['steps'][..., v, None] * step).clamp(min=1.0), hi)
  xy = torch.stack(positions, -2)
  return torch.cat([xy, rig['z'][..., None]], -1), rig['yaws']


def camera_struct(spec: Spec, shape: Tuple[int, ...],
                  device: Device) -> geometry.FisheyeCamera:
  """The rig's (shared, undistorted-fisheye) intrinsics, ``shape`` cameras."""
  h, w = spec.image_hw
  f = (w / 2) / np.tan(np.deg2rad(spec.hfov_deg) / 2)
  full = lambda *v: torch.tensor(v, dtype=torch.float32,  # noqa: E731
                                 device=device).repeat(*shape, 1)
  return geometry.FisheyeCamera(
      wh=full(w, h), f=full(f, f), c=full(w / 2, h / 2),
      k_radial=full(0.0, 0.0, 0.0),
      max_fov=full(float(np.deg2rad(115.0)))[..., 0])


def rig_yaws(r_view: Tensor) -> Tensor:
  """The yaws of ``world_from_cam`` rotations ``[..., 3, 3]``."""
  cam_to_world = torch.as_tensor(CAM_TO_WORLD, dtype=r_view.dtype,
                                 device=r_view.device)
  yaw_mats = r_view @ cam_to_world.T
  return torch.atan2(yaw_mats[..., 1, 0], yaw_mats[..., 0, 0])


def map_scene(spec: Spec, world: DataDict, positions: Tensor, yaws: Tensor,
              lidar: Optional[DataDict] = None,
              scene2world: Optional[RigidTransform] = None) -> DataDict:
  """One posed multi-view scene per example (no images: ``make_batch``
  renders every view of a batch in one pass)."""
  b, v = yaws.shape
  r_view = yaw_matrix(yaws) @ torch.as_tensor(
      CAM_TO_WORLD, dtype=yaws.dtype, device=yaws.device)
  scene: DataDict = {
      'T_view2scene': geometry.Transform3D(R=r_view, t=positions),
      'camera': camera_struct(spec, (b, v), yaws.device),
      'latlng': torch.zeros(b, 2, device=yaws.device),
  }
  if spec.add_rasters:
    scene['rasters'] = make_rasters(spec, world['texture'], world['boxes'],
                                    scene2world)
  if spec.add_lidar_rays:
    scene['lidar_rays'] = make_lidar_rays(lidar, positions, world['boxes'],
                                          scene2world)
  return scene


def _render_pose(scene: DataDict, scene2world: Optional[RigidTransform]):
  """The views' rotations and positions in the world frame."""
  r_view, pos = scene['T_view2scene'].R, scene['T_view2scene'].t
  if scene2world is None:
    return r_view, pos
  r_s2w, t_s2w = scene2world
  return r_s2w[:, None] @ r_view, _rotate(r_s2w, pos) + t_s2w[:, None]


def query_scene(spec: Spec, query: DataDict):
  """A single-view trekker query per example -> (scene without images,
  its world rotation and position ``[B, 1, ...]``, ``T_query2map``)."""
  z, yaw = query['z'], query['yaw']
  b = z.shape[0]
  zeros = torch.zeros_like(z)
  cam_to_world = torch.as_tensor(CAM_TO_WORLD, dtype=torch.float32,
                                 device=z.device)
  scene: DataDict = {
      'T_view2scene': geometry.Transform3D(
          R=cam_to_world.repeat(b, 1, 1, 1),
          t=torch.stack([zeros, zeros, z], -1)[:, None]),
      'camera': camera_struct(spec, (b, 1), z.device),
      'latlng': torch.zeros(b, 2, device=z.device),
  }
  r_world = yaw_matrix(yaw) @ cam_to_world
  cam_pos = torch.cat([query['xy'], z[:, None]], -1)
  t_query2map = geometry.Transform3D(
      R=yaw_matrix(yaw), t=torch.cat([query['xy'], zeros[:, None]], -1))
  return scene, (r_world[:, None], cam_pos[:, None]), t_query2map


def rig_coverage(spec: Spec, positions: Tensor, yaws: Tensor,
                 scene2common: Optional[RigidTransform] = None,
                 cell: float = 1.0) -> Tensor:
  """Boolean ``[*B, X, Y]`` grid of common-frame cells inside the view
  frusta of rigs ``[*B, V, 3]``, ``[*B, V]`` (the PAIR_SCENES and
  PAIR_SCENE_VIEW ``overlap``; reference contract snap/data/types.py:71-81).
  With ``scene2common`` (``[*B, 3, 3]``, ``[*B, 3]``), the rig's frame in
  the common frame, a cell must also lie inside the rig's own grid."""
  gx, gy, _ = spec.grid_size
  ii, jj = torch.meshgrid(torch.arange(int(gx / cell), device=yaws.device),
                          torch.arange(int(gy / cell), device=yaws.device),
                          indexing='ij')
  centers = ((torch.stack([ii, jj], -1) + 0.5) * cell).float()  # [X, Y, 2]
  fwd = torch.stack([-torch.sin(yaws), torch.cos(yaws)], -1)
  cam_xy = positions[..., :2]
  in_cells = None
  if scene2common is not None:
    r_s2c, t_s2c = scene2common
    r2 = r_s2c[..., :2, :2]
    cam_xy = _rotate(r2, cam_xy) + t_s2c[..., None, :2]
    fwd = _rotate(r2, fwd)
    rel_s = centers - t_s2c[..., None, None, :2]  # [*B, X, Y, 2]
    cells_scene = _rotate(r2.transpose(-1, -2), rel_s)
    limits = torch.tensor([gx, gy], device=yaws.device)
    in_cells = ((cells_scene >= 0) & (cells_scene < limits)).all(-1)
  rel = centers[:, :, None] - cam_xy[..., None, None, :, :]  # [*B,X,Y,V,2]
  dist = torch.linalg.norm(rel, dim=-1)
  cos_angle = (rel * fwd[..., None, None, :, :]).sum(-1) / dist.clamp(
      min=1e-6)
  half_fov = np.deg2rad(spec.hfov_deg) / 2
  seen = (dist <= spec.frustum_depth) & (cos_angle >= float(np.cos(half_fov)))
  covered = seen.any(-1)
  return covered if in_cells is None else covered & in_cells


def _overlap(num: Tensor, den: Tensor) -> Tensor:
  return num.sum((-2, -1)).float() / den.sum((-2, -1)).clamp(min=1).float()


def _select_candidate(spec: Spec, cov_i: Tensor, candidates: DataDict):
  """The PAIR_SCENES pairing rule over each example's candidates
  (``[B, C, ...]``): the first whose overlap with ``cov_i`` lies in the
  pairing window, else the one closest to the window's center."""
  positions, yaws = rig_walk(spec, candidates['rig'])  # [B, C, V, ...]
  r_j2i = yaw_matrix(candidates['yaw'])
  t_j2i = torch.cat([candidates['shift'],
                     torch.zeros_like(candidates['shift'][..., :1])], -1)
  cov_j = rig_coverage(spec, positions, yaws, (r_j2i, t_j2i))
  cov_i = cov_i[:, None]
  overlaps = _overlap(cov_i & cov_j, cov_i | cov_j)  # [B, C]
  lo, hi = spec.pair_overlap
  in_window = (overlaps >= lo) & (overlaps <= hi)
  fallback = (overlaps - (lo + hi) / 2).abs().argmin(-1)
  best = torch.where(in_window.any(-1),
                     in_window.to(torch.uint8).argmax(-1), fallback)
  rows = torch.arange(best.shape[0], device=best.device)
  return (positions[rows, best], yaws[rows, best],
          (r_j2i[rows, best], t_j2i[rows, best]), overlaps[rows, best])


def make_batch(spec: Spec, mode: data_types.DataMode,
               draws: DataDict) -> DataDict:
  """A batch of examples (no strings: those live in the host side-channel)
  from draws ``[B, ...]`` (``draws_to``: on the device that makes it).
  Every view of the batch (map, query, second rig) is rendered in one
  ``render_views`` pass."""
  world = {'texture': draws['texture'], 'boxes': draws['boxes']}
  positions, yaws = rig_walk(spec, draws['rig'])
  scene = map_scene(spec, world, positions, yaws, draws.get('lidar'))
  zero = torch.zeros(yaws.shape[0], device=yaws.device)
  renders = [(scene, _render_pose(scene, None))] if spec.add_images else []
  if mode == data_types.DataMode.SINGLE_SCENE:
    batch = scene
  elif mode == data_types.DataMode.PAIR_SCENE_VIEW:
    query, query_pose, t_query2map = query_scene(spec, draws['query'])
    renders.append((query, query_pose))
    cov_map = rig_coverage(spec, positions, rig_yaws(scene['T_view2scene'].R))
    yaw_q = torch.atan2(t_query2map.R[:, 1, 0], t_query2map.R[:, 0, 0])
    cov_q = rig_coverage(spec, t_query2map.t[:, None], yaw_q[:, None])
    batch = {'map': scene, 'query': query, 'T_query2map': t_query2map,
             'overlap': _overlap(cov_q & cov_map, cov_q),
             'time_delta_days': zero}
  elif mode == data_types.DataMode.PAIR_SCENES:
    cov_i = rig_coverage(spec, positions, rig_yaws(scene['T_view2scene'].R))
    pos_j, yaws_j, scene2world, overlap = _select_candidate(
        spec, cov_i, draws['candidates'])
    scene_j = map_scene(spec, world, pos_j, yaws_j, draws.get('lidar_j'),
                        scene2world)
    if spec.add_images:
      renders.append((scene_j, _render_pose(scene_j, scene2world)))
    batch = {'scene_i': scene, 'scene_j': scene_j,
             'T_j2i': geometry.Transform3D(R=scene2world[0],
                                           t=scene2world[1]),
             'overlap': overlap, 'time_delta_days': zero}
  else:
    raise NotImplementedError(mode)
  if renders:
    images = render_views(spec, world['texture'], world['boxes'],
                          torch.cat([r for _, (r, _) in renders], 1),
                          torch.cat([p for _, (_, p) in renders], 1))
    sizes = [p.shape[1] for _, (_, p) in renders]
    for (target, _), image in zip(renders, images.split(sizes, 1)):
      target['images'] = image
  return batch
