"""The port's device generator against the JAX package's.

``snap_tpu_torch/data/device_synthetic.py`` against
``snap_tpu/data/device_synthetic.py`` on the CPU at smoke size (3 views,
24 x 32 images, 0.8 m voxels):

- each pure function of the port against the JAX function of the same
  name, on seeded numpy inputs;
- whole examples in the three modes against JAX's ``make_example``, with
  JAX's own draws injected into the port (recovered with JAX's
  ``sample_texture`` / ``sample_boxes`` and the same key splits as
  ``make_example``'s);
- the port's own draws: deterministic per (seed, salt, index), changed by
  the index and the seed, and distributed as JAX's device generator's
  (two-sample KS tests over 256 examples);
- the schema of every mode equal to the port's host path's, and the query
  view's ground pixels equal to the map's texture.

Tolerances: floats to 1e-5 (coordinates, overlaps) or 1e-4 (colors: the
two libraries' ``cos`` differ by an ulp of phases up to ~300 rad). Booleans
and indices are exact outside ``EPS`` of the threshold that decides them;
elements that differ are counted, and their share must stay under
``FLIP_SHARE``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch

from snap_tpu.data import device_synthetic as jds
from snap_tpu.data import types as jtypes
from snap_tpu_torch import configs
from snap_tpu_torch.data import device_synthetic as ds
from snap_tpu_torch.data import loader
from snap_tpu_torch.data import types

torch.set_num_threads(2)

ATOL = 1e-5
IMAGE_ATOL = 1e-4
EPS = 1e-4
FLIP_SHARE = 1e-3
MODES = list(types.DataMode)

SPEC = ds.Spec(num_views=3, image_hw=(24, 32), voxel_size=0.8,
               add_rasters=True, add_lidar_rays=True, num_rays=256,
               num_sem_classes=8, num_gt_classes=14,
               building_sem_indices=(6,), building_gt_index=4)
JSPEC = jds.Spec(**dataclasses.asdict(SPEC))


def _t(x):
  return torch.as_tensor(np.array(x))


def _batched(tree):
  """A numpy tree with a leading batch axis of 1, as tensors."""
  return {k: _batched(v) if isinstance(v, dict) else _t(v)[None]
          for k, v in tree.items()}


def _flat(tree, prefix=''):
  out = {}
  if isinstance(tree, dict):
    for key, value in tree.items():
      out.update(_flat(value, f'{prefix}/{key}'))
  elif dataclasses.is_dataclass(tree):
    for field in dataclasses.fields(tree):
      out.update(_flat(getattr(tree, field.name), f'{prefix}/{field.name}'))
  else:
    out[prefix] = np.asarray(tree)
  return out


def _assert_flips_bounded(differs, name=''):
  share = float(np.mean(differs))
  assert share <= FLIP_SHARE, (name, int(np.sum(differs)), share)


def _assert_equal_where_decided(got, want, decided, name=''):
  """Equal wherever the deciding value lies ``EPS`` or more from its
  threshold; flips elsewhere bounded."""
  differs = got != want
  assert not (differs & decided).any(), (name, int((differs & decided).sum()))
  _assert_flips_bounded(differs, name)


def _assert_close(got, want, atol, name=''):
  """Within ``atol`` except at a share of at most ``FLIP_SHARE`` (a boolean
  decision flipped on its threshold)."""
  _assert_flips_bounded(np.abs(got - want) > atol, name)


def _seeded_world(seed):
  rng = np.random.default_rng(seed)
  return ds.draw_texture(rng, SPEC), ds.draw_boxes(rng, SPEC)


def _seeded_pose(rng, num):
  yaw = rng.uniform(0, 2 * np.pi, num).astype(np.float32)
  r = np.asarray(jds.yaw_matrix(jnp.asarray(yaw)) @ jnp.asarray(
      jds.CAM_TO_WORLD, jnp.float32))
  pos = np.concatenate([rng.uniform(2, 22, (num, 1)),
                        rng.uniform(2, 30, (num, 1)),
                        rng.uniform(2, 3, (num, 1))], -1).astype(np.float32)
  return r, pos


# --- JAX's draws, recovered with make_example's key splits ----------------


def _jax_rig_draws(key, spec):
  gx, gy, _ = spec.grid_size
  num = spec.num_views
  k_start, k_dir, k_steps, k_wander, k_z, k_yaw = jax.random.split(key, 6)
  return dict(
      start=jax.random.uniform(k_start, (2,), minval=jnp.asarray([2.0, 2.0]),
                               maxval=jnp.asarray([gx - 2.0, gy - 2.0])),
      dir0=jax.random.uniform(k_dir, (), maxval=2 * jnp.pi),
      steps=jax.random.uniform(k_steps, (num,), minval=spec.min_step,
                               maxval=min(spec.max_step, 4.0)),
      wander=jax.random.normal(k_wander, (num,)) * 0.3,
      z=jax.random.uniform(k_z, (num,), minval=spec.camera_height_range[0],
                           maxval=spec.camera_height_range[1]),
      yaws=jax.random.uniform(k_yaw, (num,), maxval=2 * jnp.pi))


def _jax_lidar_draws(key, spec):
  k_view, k_azim, k_elev = jax.random.split(key, 3)
  n = spec.num_rays
  return dict(
      view_idx=jax.random.randint(k_view, (n,), 0, spec.num_views),
      azim=jax.random.uniform(k_azim, (n,), maxval=2 * jnp.pi),
      elev=jax.random.uniform(k_elev, (n,), minval=np.deg2rad(-35.0),
                              maxval=np.deg2rad(10.0)))


def _jax_example_draws(spec, mode, seed, index):
  """The draws ``jds.make_example(spec, mode, seed, index)`` makes."""
  base = jax.random.fold_in(jax.random.PRNGKey(0), seed)
  scene_key = lambda salt: jax.random.fold_in(  # noqa: E731
      jax.random.fold_in(base, salt), index)
  k_tex, k_boxes, k_rig, k_lidar = jax.random.split(scene_key(1), 4)
  draws = {'texture': jds.sample_texture(k_tex, spec),
           'boxes': jds.sample_boxes(k_boxes, spec),
           'rig': _jax_rig_draws(k_rig, spec)}
  if spec.add_lidar_rays:
    draws['lidar'] = _jax_lidar_draws(k_lidar, spec)
  if mode == jtypes.DataMode.PAIR_SCENE_VIEW:
    gx, gy, _ = spec.grid_size
    margin = min(4.0, spec.frustum_depth / 4)
    k_xy, k_z, k_yaw = jax.random.split(scene_key(2), 3)
    draws['query'] = dict(
        xy=jax.random.uniform(k_xy, (2,), minval=margin,
                              maxval=jnp.asarray([gx - margin, gy - margin])),
        z=jax.random.uniform(k_z, (), minval=spec.camera_height_range[0],
                             maxval=spec.camera_height_range[1]),
        yaw=jax.random.uniform(k_yaw, (), maxval=2 * jnp.pi))
  if mode == jtypes.DataMode.PAIR_SCENES:
    candidates = []
    for c in range(ds.NUM_CANDIDATES):
      k_shift, k_yaw, k_rig = jax.random.split(
          jax.random.fold_in(scene_key(100), c), 3)
      candidates.append(dict(
          shift=jax.random.uniform(k_shift, (2,), minval=-8.0, maxval=8.0),
          yaw=jax.random.uniform(k_yaw, (), minval=-jnp.pi / 4,
                                 maxval=jnp.pi / 4),
          rig=_jax_rig_draws(k_rig, spec)))
    draws['candidates'] = jax.tree_util.tree_map(
        lambda *x: jnp.stack(x), *candidates)
    if spec.add_lidar_rays:
      draws['lidar_j'] = _jax_lidar_draws(
          jax.random.split(scene_key(4), 4)[3], spec)
  return jax.tree_util.tree_map(np.asarray, draws)


# --- pure functions -------------------------------------------------------


def test_texture_eval_matches_jax():
  texture, _ = _seeded_world(0)
  xy = np.random.default_rng(1).uniform(-40, 40, (7, 9, 2)).astype(
      np.float32)
  want = np.asarray(jds.texture_eval(jax.tree_util.tree_map(
      jnp.asarray, texture), jnp.asarray(xy)))
  got = ds.texture_eval(_batched(texture), _t(xy)[None])[0].numpy()
  np.testing.assert_allclose(got, want, atol=IMAGE_ATOL)


def _raycast_margin(boxes, origins, dirs):
  """Per ray (float64): the distance of its closest decision to a
  threshold (a box's hit test, or a tie between two boxes' hits)."""
  o, d = origins[..., None, :], dirs[..., None, :]
  d = np.where(np.abs(d) < 1e-9, 1e-9, d)
  t1, t2 = (boxes['mins'] - o) / d, (boxes['maxs'] - o) / d
  t_near = np.minimum(t1, t2).max(-1)
  t_far = np.maximum(t1, t2).min(-1)
  margin = np.minimum(np.abs(t_far - np.maximum(t_near, 1e-4)),
                      np.abs(t_near - 1e-4)).min(-1)
  hit = (t_far >= np.maximum(t_near, 1e-4)) & (t_near > 1e-4)
  t_hit = np.sort(np.where(hit, t_near, np.inf), -1)
  with np.errstate(invalid='ignore'):  # inf - inf where no box is hit
    gap = np.where(np.isfinite(t_hit[..., 1]),
                   t_hit[..., 1] - t_hit[..., 0], np.inf)
  return np.minimum(margin, gap)


def test_raycast_boxes_matches_jax():
  _, boxes = _seeded_world(2)
  rng = np.random.default_rng(3)
  origins = np.concatenate([rng.uniform(0, 24, (4000, 1)),
                            rng.uniform(0, 32, (4000, 1)),
                            rng.uniform(0.5, 3, (4000, 1))], -1)
  dirs = rng.normal(size=(4000, 3))
  dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
  origins, dirs = origins.astype(np.float32), dirs.astype(np.float32)
  jboxes = jax.tree_util.tree_map(jnp.asarray, boxes)
  t_want, idx_want = (np.asarray(x) for x in jds.raycast_boxes(
      jboxes, jnp.asarray(origins), jnp.asarray(dirs)))
  t_got, idx_got = ds.raycast_boxes(_batched(boxes), _t(origins)[None],
                                    _t(dirs)[None])
  t_got, idx_got = t_got[0].numpy(), idx_got[0].numpy()
  hit = t_want < ds.FAR
  assert 0.05 < hit.mean() < 0.95
  decided = _raycast_margin({k: v.astype(np.float64) for k, v in
                             boxes.items()}, origins.astype(np.float64),
                            dirs.astype(np.float64)) >= EPS
  _assert_equal_where_decided(t_got < ds.FAR, hit, decided, 'hit')
  both = hit & (t_got < ds.FAR)
  _assert_equal_where_decided(idx_got[both], idx_want[both], decided[both],
                              'box index')
  np.testing.assert_allclose(t_got[decided & hit], t_want[decided & hit],
                             atol=ATOL, rtol=ATOL)


def test_box_footprint_matches_jax():
  _, boxes = _seeded_world(4)
  xy = np.random.default_rng(5).uniform(0, 32, (50, 40, 2)).astype(
      np.float32)
  want = np.asarray(jds.box_footprint(
      jax.tree_util.tree_map(jnp.asarray, boxes), jnp.asarray(xy)))
  got = ds.box_footprint(_batched(boxes), _t(xy)[None])[0].numpy()
  assert want.any()
  np.testing.assert_array_equal(got, want)


def test_render_views_matches_jax():
  """Colors to IMAGE_ATOL; where a far ground point has faded (fade below
  1e-3), its color may differ by up to its fade as well; pixels whose box
  hit flips are counted."""
  texture, boxes = _seeded_world(6)
  r, pos = _seeded_pose(np.random.default_rng(7), 5)
  want = np.asarray(jds.render_views(
      JSPEC, jax.tree_util.tree_map(jnp.asarray, texture),
      jax.tree_util.tree_map(jnp.asarray, boxes), jnp.asarray(r),
      jnp.asarray(pos)))
  got = ds.render_views(SPEC, _batched(texture), _batched(boxes),
                        _t(r)[None], _t(pos)[None])[0].numpy()
  assert got.shape == want.shape == (5, 24, 32, 3)
  _, _, _, xy = ds.ground_hits(SPEC, _t(r), _t(pos))
  dist = np.linalg.norm(xy.numpy() - pos[:, None, None, :2], axis=-1)
  fade = np.exp(-dist / 60.0)[..., None]
  tol = IMAGE_ATOL + np.where(fade < 1e-3, fade, 0.0)
  _assert_flips_bounded(np.abs(got - want) > tol, 'render_views')


@pytest.mark.parametrize('scene2world', [False, True])
def test_make_rasters_matches_jax(scene2world):
  """rgb to IMAGE_ATOL; the semantic and GT layers exact except where the
  channel lies within EPS of a threshold or band edge."""
  texture, boxes = _seeded_world(8)
  jtexture = jax.tree_util.tree_map(jnp.asarray, texture)
  jboxes = jax.tree_util.tree_map(jnp.asarray, boxes)
  jtfm = ttfm = None
  if scene2world:
    r = np.asarray(jds.yaw_matrix(jnp.asarray(0.4, jnp.float32)))
    t = np.asarray([3.5, -2.0, 0.0], np.float32)
    jtfm, ttfm = (jnp.asarray(r), jnp.asarray(t)), (_t(r)[None], _t(t)[None])
  want = jds.make_rasters(JSPEC, jtexture, jboxes, jtfm)
  got = ds.make_rasters(SPEC, _batched(texture), _batched(boxes), ttfm)
  want = {k: np.asarray(v) for k, v in want.items()}
  got = {k: v[0].numpy() for k, v in got.items()}
  np.testing.assert_allclose(got['rgb'], want['rgb'], atol=IMAGE_ATOL)
  rgb = want['rgb'].astype(np.float64)
  footprint = want['gt_semantics'][..., 4]
  assert footprint.any()
  for i, t in enumerate(np.linspace(0.35, 0.65, 8)):
    decided = footprint | (np.abs(rgb[..., i % 3] - t) >= EPS)
    _assert_equal_where_decided(got['semantics'][..., i],
                                want['semantics'][..., i], decided,
                                f'semantics {i}')
  for ch in range(3):
    group = [i for i in range(14) if (i + 1) % 3 == ch]
    edges = np.linspace(0.36, 0.64, len(group) + 1)[1:-1]
    decided = np.abs(rgb[..., ch, None] - edges).min(-1) >= EPS
    for i in group:
      _assert_equal_where_decided(got['gt_semantics'][..., i],
                                  want['gt_semantics'][..., i],
                                  decided | (footprint & (i == 4)),
                                  f'gt_semantics {i}')


@pytest.mark.parametrize('scene2world', [False, True])
def test_make_lidar_rays_matches_jax(scene2world):
  _, boxes = _seeded_world(9)
  _, positions = _seeded_pose(np.random.default_rng(10), SPEC.num_views)
  key = jax.random.PRNGKey(11)
  lidar = jax.tree_util.tree_map(np.asarray, _jax_lidar_draws(key, JSPEC))
  jtfm = ttfm = None
  if scene2world:
    r = np.asarray(jds.yaw_matrix(jnp.asarray(-0.3, jnp.float32)))
    t = np.asarray([-4.0, 6.0, 0.0], np.float32)
    jtfm, ttfm = (jnp.asarray(r), jnp.asarray(t)), (_t(r)[None], _t(t)[None])
  want = jds.make_lidar_rays(JSPEC, key, jnp.asarray(positions),
                             jax.tree_util.tree_map(jnp.asarray, boxes), jtfm)
  got = ds.make_lidar_rays(_batched(lidar), _t(positions)[None],
                           _batched(boxes), ttfm)
  want = {k: np.asarray(v) for k, v in want.items()}
  got = {k: v[0].numpy() for k, v in got.items()}
  assert want['mask'].any() and not want['mask'].all()
  _assert_flips_bounded(got['mask'] != want['mask'], 'lidar mask')
  np.testing.assert_array_equal(got['origins'], want['origins'])
  _assert_close(got['points'], want['points'], ATOL, 'lidar points')


def test_rig_walk_matches_jax():
  key = jax.random.PRNGKey(12)
  spec = dataclasses.replace(JSPEC, num_views=20)
  pos_want, yaws_want = jds.sample_rig(key, spec)
  draws = _jax_rig_draws(key, spec)
  pos_got, yaws_got = ds.rig_walk(spec, _batched(jax.tree_util.tree_map(
      np.asarray, draws)))
  np.testing.assert_allclose(pos_got[0].numpy(), np.asarray(pos_want),
                             atol=ATOL)
  np.testing.assert_array_equal(yaws_got[0].numpy(), np.asarray(yaws_want))


def _coverage_margin(spec, positions, yaws, scene2common=None):
  """Per cell (float64): the distance of its closest frustum decision to
  the frustum's depth or half-FoV cosine, or of its rig-frame
  coordinates to the grid's edges."""
  gx, gy, _ = spec.grid_size
  ii, jj = np.meshgrid(np.arange(int(gx)), np.arange(int(gy)), indexing='ij')
  centers = np.stack([ii, jj], -1) + 0.5
  fwd = np.stack([-np.sin(yaws), np.cos(yaws)], -1)
  cam_xy = positions[:, :2]
  margin = np.inf
  if scene2common is not None:
    r2, t = scene2common[0][:2, :2], scene2common[1][:2]
    cam_xy, fwd = cam_xy @ r2.T + t, fwd @ r2.T
    cells = (centers - t) @ r2
    margin = np.minimum(np.abs(cells), np.abs(cells - [gx, gy])).min(-1)
  rel = centers[..., None, :] - cam_xy
  dist = np.linalg.norm(rel, axis=-1)
  cos_angle = (rel * fwd).sum(-1) / np.maximum(dist, 1e-6)
  cos_half = np.cos(np.deg2rad(spec.hfov_deg) / 2)
  return np.minimum(margin, np.minimum(
      np.abs(dist - spec.frustum_depth), np.abs(cos_angle - cos_half)).min(-1))


@pytest.mark.parametrize('scene2common', [False, True])
def test_rig_coverage_matches_jax(scene2common):
  rng = np.random.default_rng(13)
  _, positions = _seeded_pose(rng, 6)
  yaws = rng.uniform(0, 2 * np.pi, 6).astype(np.float32)
  jtfm = ttfm = tfm64 = None
  if scene2common:
    r = np.asarray(jds.yaw_matrix(jnp.asarray(0.6, jnp.float32)))
    t = np.asarray([5.0, -3.0, 0.0], np.float32)
    jtfm, ttfm = (jnp.asarray(r), jnp.asarray(t)), (_t(r), _t(t))
    tfm64 = (r.astype(np.float64), t.astype(np.float64))
  want = np.asarray(jds._rig_coverage(JSPEC, jnp.asarray(positions),
                                      jnp.asarray(yaws), jtfm))
  got = ds.rig_coverage(SPEC, _t(positions), _t(yaws), ttfm).numpy()
  assert 0.05 < want.mean() < 0.95
  decided = _coverage_margin(SPEC, positions.astype(np.float64),
                             yaws.astype(np.float64), tfm64) >= EPS
  _assert_equal_where_decided(got, want, decided, 'coverage')


def test_camera_struct_matches_jax():
  want = jds.camera_struct(JSPEC, 3)
  got = ds.camera_struct(SPEC, (2, 3), 'cpu')
  for field in ('wh', 'f', 'c', 'k_radial', 'max_fov'):
    w, g = np.asarray(getattr(want, field)), getattr(got, field).numpy()
    assert g.dtype == w.dtype
    np.testing.assert_array_equal(g[0], w)
    np.testing.assert_array_equal(g[1], w)


# --- whole examples -------------------------------------------------------


@pytest.fixture(scope='module', params=MODES, ids=lambda m: m.value)
def examples(request):
  """Examples 0-2 of one mode: JAX's make_example and the port's
  make_batch on JAX's draws."""
  mode = request.param
  jmode = jtypes.DataMode(mode.value)
  make = jax.jit(lambda i: jds.make_example(JSPEC, jmode, 7, i))
  want = [jax.tree_util.tree_map(np.asarray, make(jnp.asarray(i)))
          for i in range(3)]
  draws = loader.stack_examples([_jax_example_draws(JSPEC, jmode, 7, i)
                     for i in range(3)])
  got = ds.make_batch(SPEC, mode, ds.draws_to(draws, 'cpu'))
  return mode, want, got


def test_make_example_matches_jax(examples):
  """Every leaf of the three examples: keys, shapes and dtypes equal;
  floats close; booleans equal but for a bounded share of flips."""
  _, want, got = examples
  got = _flat(got)
  for i, example in enumerate(want):
    example = _flat(example)
    assert set(example) == set(got)
    for key, w in example.items():
      g = got[key][i]
      assert (g.shape, g.dtype) == (w.shape, w.dtype), key
      if w.dtype == bool:
        _assert_flips_bounded(g != w, key)
      elif 'images' in key or 'rgb' in key:
        np.testing.assert_allclose(g, w, atol=IMAGE_ATOL, err_msg=key)
      elif key.endswith('/points'):
        _assert_close(g, w, ATOL, key)
      else:
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=ATOL, err_msg=key)
  if '/overlap' in got:
    overlap = got['/overlap']
    assert ((overlap >= 0) & (overlap <= 1)).all()
    assert np.unique(overlap).size > 1


# --- the port's own draws -------------------------------------------------


def _batch(spec, mode, seed, indices):
  return ds.make_batch(spec, mode, ds.draws_to(
      ds.draw_batch(spec, mode, seed, indices), 'cpu'))


def test_draws_are_deterministic_and_index_and_seed_dependent():
  mode = types.DataMode.PAIR_SCENE_VIEW
  first = ds.draw_example(SPEC, mode, 11, 0)
  again = ds.draw_example(SPEC, mode, 11, 0)
  for key, value in _flat(first).items():
    np.testing.assert_array_equal(value, _flat(again)[key])
  a = _batch(SPEC, mode, 11, [0, 1])['map']['images'].numpy()
  b = _batch(SPEC, mode, 11, [0, 2])['map']['images'].numpy()
  np.testing.assert_array_equal(a[0], b[0])
  assert np.abs(a[1] - b[1]).max() > 0.05
  c = _batch(SPEC, mode, 12, [0])['map']['images'].numpy()
  assert np.abs(c[0] - a[0]).max() > 0.05


def _statistics(batch):
  t = np.asarray(batch['map']['T_view2scene'].t)
  steps = np.linalg.norm(np.diff(t[..., :2], axis=1), axis=-1)
  return {'overlap': np.asarray(batch['overlap']),
          'camera height': t[..., 2].ravel(),
          'step length': steps.ravel(),
          'mean image intensity': np.asarray(
              batch['map']['images']).mean((1, 2, 3, 4))}


def test_draws_distributed_as_jax():
  """Two-sample KS tests, p > 1e-3, over 256 examples of each generator
  (fixed seeds)."""
  spec = dataclasses.replace(SPEC, add_rasters=False, add_lidar_rays=False)
  jspec = jds.Spec(**dataclasses.asdict(spec))
  mode = types.DataMode.PAIR_SCENE_VIEW
  indices = np.arange(256)
  want = _statistics(jds.DeviceBatcher(
      jspec, jtypes.DataMode.PAIR_SCENE_VIEW, seed=21)(
          indices, np.ones(256, bool)))
  got = _statistics(_batch(spec, mode, 22, indices))
  for key, w in want.items():
    p = scipy.stats.ks_2samp(got[key], w).pvalue
    assert p > 1e-3, (key, p)


# --- the port's own behaviour ---------------------------------------------


def _signature(tree):
  return {k: (v.shape, str(v.dtype)) for k, v in _flat(
      {k: v for k, v in tree.items() if k != '_host'}).items()}


@pytest.mark.parametrize('mode', MODES, ids=lambda m: m.value)
def test_schema_equals_the_host_path(mode):
  data = dataclasses.replace(
      configs.smoke_exhaustive().data, image_size=(24, 32), voxel_size=0.8,
      mode=mode.value, add_lidar_rays=True, num_rays=64, num_workers=1)
  batches = {}
  for on_device in (True, False):
    data = dataclasses.replace(data, on_device_generation=on_device)
    with loader.get_dataset(data, 2, device='cpu') as dataset:
      batches[on_device] = next(dataset.train_iter)
  assert _signature(batches[True]) == _signature(batches[False])
  hosts = [batches[k]['_host'] for k in (True, False)]
  assert set(hosts[0]) == set(hosts[1])
  for key in hosts[0]:
    np.testing.assert_array_equal(hosts[0][key], hosts[1][key])


def test_query_view_consistent_with_map_texture():
  """The query image's bottom-center pixel shows the map texture at its
  ground point (``tests/test_device_synthetic.py``'s check, unprojecting
  the pixel's center)."""
  spec = ds.Spec(num_views=2, image_hw=(32, 40), num_boxes=0)
  mode = types.DataMode.PAIR_SCENE_VIEW
  draws = ds.draws_to(ds.draw_batch(spec, mode, 5, [0]), 'cpu')
  example = ds.make_batch(spec, mode, draws)
  image = example['query']['images'][0, 0].numpy()
  cam = example['query']['camera']
  pose = example['query']['T_view2scene']
  h, w = spec.image_hw
  pix = np.array([w // 2 + 0.5, h - 0.5])
  f, c = cam.f[0, 0].numpy(), cam.c[0, 0].numpy()
  ray_cam = np.append((pix - c) / f, 1.0)
  r, t = pose.R[0, 0].numpy(), pose.t[0, 0].numpy()
  ray_q = r @ ray_cam
  assert ray_q[2] < 0
  ground_q = t + (-t[2] / ray_q[2]) * ray_q
  t_q2m = example['T_query2map']
  ground_map = t_q2m.R[0].numpy() @ ground_q + t_q2m.t[0].numpy()
  fade = np.exp(-np.linalg.norm(ground_q[:2] - t[:2]) / 60.0)
  texture = {k: v[:1] for k, v in draws['texture'].items()}
  color = ds.texture_eval(texture, torch.as_tensor(
      ground_map[None, :2], dtype=torch.float32))[0].numpy()
  expected = np.clip(color * fade + np.array(ds.SKY) * (1 - fade), 0, 1)
  np.testing.assert_allclose(image[h - 1, w // 2], expected,
                             atol=IMAGE_ATOL)
