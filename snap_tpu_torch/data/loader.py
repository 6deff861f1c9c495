"""Synthetic batches as torch tensors with typed geometry, and the
prefetching train/eval iterators over them.

The port of ``snap_tpu/data/loader.py``. ``get_dataset`` returns a train
and an eval iterator whose batches are made on one of two paths:

- on the device (``device_synthetic.make_batch``): the host draws each
  example's few random numbers and the whole batch is made by batched
  tensor operations on the device that consumes it;
- on the host (``synthetic.SyntheticSceneGenerator``, numpy): examples
  made one by one, stacked, and copied to the device (``process_batch``).

``DataConfig.on_device_generation`` picks the path; None picks the device
path iff the entry point's device is a CUDA card (the reference's rule for
an accelerator backend). ``meta_data['generator_kind']`` names the path
(``'device-torch'`` / ``'host-numpy'``). Both paths seed as the JAX loader
seeds (``split_seed``); they share the schema, world model, pairing rule
and distributions, not their random streams. Strings (scene and pair ids,
vehicle types) never go to the device: they live under the ``_host`` key,
with the same ids on both paths.

``PrefetchIterator`` builds the batches: ``num_workers`` threads ahead of
the consumer on the host path, and none on the device path, where each
batch is built in the consumer's thread and on its stream (worker threads
dispatching a build's ~500-650 launches slowed the host-bound train step
and serving query: PERF.md section 6). There, stream order alone keeps
the model from reading a batch before the card has made it, and the host
does not wait for the build: it goes on to dispatch the step. With
workers on a CUDA card, each builds on its own stream; the consumer's
stream waits on the build's end event and every tensor of the batch is
``record_stream``-ed on it, so its memory is not reused while the
consumer may still read it. Over the ranks of the mesh's data axis
(``parallel/mesh.py``), each process builds only its contiguous block of
every global batch, as the reference's do (``snap_tpu/data/loader.py:
305-337``): the blocks stacked in rank order are the one-process batch. A
resumed run's fold of the data seed is ``train.py``'s
(``utils/prng.resume_shuffle_seed``).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import (Any, Callable, Dict, Iterator, Optional, Sequence,
                    Tuple, Union)

import numpy as np
import torch

from snap_tpu_torch import configs
from snap_tpu_torch.data import device_synthetic
from snap_tpu_torch.data import synthetic
from snap_tpu_torch.data import types
from snap_tpu_torch.parallel import mesh
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


def _lidar_config(data_config: configs.DataConfig) -> types.LidarConfig:
  return types.LidarConfig(num_rays=data_config.num_rays or 10_000)


def make_generator(data_config: configs.DataConfig, seed: int,
                   location: Optional[str] = None
                   ) -> synthetic.SyntheticSceneGenerator:
  """The scene generator with the JAX loader's settings for ``data_config``,
  seeded with ``location_seed(location, seed)`` (``seed`` itself when there
  is no location)."""
  return synthetic.SyntheticSceneGenerator(
      scene_config=types.SceneConfig(num_views=data_config.num_views),
      rasters_config=types.RastersConfig(resolution=data_config.voxel_size),
      lidar_config=_lidar_config(data_config),
      pairing_config=types.PairingConfig(),
      image_hw=tuple(data_config.image_size),
      voxel_size=data_config.voxel_size,
      seed=location_seed(location, seed),
  )


def split_seed(data_config: configs.DataConfig, split: str) -> int:
  """The ``'train'`` or ``'eval'`` seed of the JAX loader for this config:
  ``location_seed(location, shuffle_seed + salt)``, the eval split's
  location defaulting to the training one
  (``snap_tpu/data/loader.py:294-303``, ``:335-336``)."""
  locations = data_config.locations
  location = locations.training
  if split == 'eval':
    location = locations.evaluation or locations.training
  return location_seed(location,
                       data_config.shuffle_seed + SPLIT_SALTS[split])


def split_generator(data_config: configs.DataConfig,
                    split: str) -> synthetic.SyntheticSceneGenerator:
  """The host generator of the split, seeded with ``split_seed``."""
  return make_generator(data_config, split_seed(data_config, split))


def device_spec(data_config: configs.DataConfig) -> device_synthetic.Spec:
  """The device generator's parameters for ``data_config``
  (``snap_tpu/data/loader.py:363-372``)."""
  pairing = types.PairingConfig()
  return device_synthetic.Spec.from_configs(
      types.SceneConfig(num_views=data_config.num_views),
      types.RastersConfig(resolution=data_config.voxel_size),
      data_config.image_size, data_config.voxel_size,
      add_images=data_config.add_images,
      add_rasters=data_config.add_rasters,
      add_lidar_rays=data_config.add_lidar_rays,
      num_rays=_lidar_config(data_config).num_rays,
      pair_overlap=(pairing.min_overlap, pairing.max_overlap))


def map_grid(data_config: configs.DataConfig) -> grids.Grid3D:
  return grids.Grid3D.from_extent_meters(types.SceneConfig().grid_size,
                                         data_config.voxel_size)


def scene_meta_data(data_config: configs.DataConfig) -> Dict[str, Any]:
  """What a model is built from (``snap_tpu/data/loader.py:460-468``): the
  scene ``grid`` (the ``grid_size`` of 24 x 32 x 12 m at the voxel size),
  the semantic raster's classes (``semantic_map_classes``) and the GT
  layers' (``semantic_classes_gt``)."""
  rasters = types.RastersConfig()
  return {'grid': map_grid(data_config),
          'semantic_map_classes': rasters.semantic_classes,
          'semantic_classes_gt': rasters.gt_semantic_classes}


def stack_examples(examples: Sequence[DataDict]) -> DataDict:
  """Stack a list of nested example dicts leaf by leaf (numpy)."""
  first = examples[0]
  if isinstance(first, dict):
    return {k: stack_examples([e[k] for e in examples]) for k in first}
  if isinstance(first, str):
    return np.asarray(examples)
  return np.stack(examples)


def make_examples(generator: synthetic.SyntheticSceneGenerator,
                  indices: Sequence[int], data_config: configs.DataConfig,
                  mode: types.DataMode = types.DataMode.PAIR_SCENE_VIEW
                  ) -> DataDict:
  """Stacked numpy examples of ``mode`` with the config's layers."""
  return stack_examples([
      generator.make_example(
          int(i), mode, add_images=data_config.add_images,
          add_rasters=data_config.add_rasters,
          add_lidar_rays=data_config.add_lidar_rays,
          num_rays=data_config.num_rays)
      for i in indices])


def make_pair_examples(generator: synthetic.SyntheticSceneGenerator,
                       indices: Sequence[int],
                       data_config: configs.DataConfig) -> DataDict:
  """Stacked numpy ``pair_scene_view`` examples (map scene + query view)."""
  return make_examples(generator, indices, data_config)


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


def _to_torch(tree, device: Device):
  if isinstance(tree, dict):
    return {k: _to_torch(v, device) for k, v in tree.items()}
  return torch.as_tensor(tree, device=device)


def _transform(pose: DataDict, device: Device) -> geometry.Transform3D:
  return geometry.Transform3D(R=torch.as_tensor(pose['R'], device=device),
                              t=torch.as_tensor(pose['t'], device=device))


def _scene(scene: DataDict, device: Device, host: DataDict,
           prefix: str = '') -> DataDict:
  """A stacked numpy scene -> tensors and typed geometry; its strings go to
  ``host`` under ``prefix``."""
  out = {}
  for key, value in scene.items():
    if key in ('scene_id', 'vehicle_type'):
      host[prefix + key] = value
    elif key == 'camera':
      out[key] = geometry.FisheyeCamera.from_dict(value, device)
    elif key == 'T_view2scene':
      out[key] = _transform(value, device)
    else:
      out[key] = _to_torch(value, device)
  return out


def process_batch(batch: DataDict, mode: types.DataMode,
                  device: Device) -> DataDict:
  """Stacked numpy examples -> tensors and typed geometry on ``device``,
  strings moved to the ``_host`` side-channel (``snap_tpu/data/
  loader.py:process_batch``). ``batch`` is not modified."""
  host: DataDict = {}
  if mode == types.DataMode.SINGLE_SCENE:
    out = _scene(batch, device, host)
  elif mode in (types.DataMode.PAIR_SCENE_VIEW, types.DataMode.PAIR_SCENES):
    out = {}
    for key, value in batch.items():
      if key in ('map', 'query', 'scene_i', 'scene_j'):
        out[key] = _scene(value, device, host, f'{key}/')
      elif key in ('T_query2map', 'T_j2i'):
        out[key] = _transform(value, device)
      elif key == 'pair_id':
        host[key] = value
      else:
        out[key] = _to_torch(value, device)
  else:
    raise NotImplementedError(mode)
  out['_host'] = host
  return out


def pair_batch_to_torch(batch: DataDict, device: Device) -> DataDict:
  """Stacked numpy pair examples -> tensors and typed geometry on ``device``
  (``process_batch`` without the string side-channel)."""
  out = process_batch(batch, types.DataMode.PAIR_SCENE_VIEW, device)
  del out['_host']
  return out


def host_strings(mode: types.DataMode, seed: int,
                 indices: Sequence[int]) -> DataDict:
  """The string side-channel of a device-made batch: the host generator's
  ids (``snap_tpu/data/loader.py:_host_strings``)."""
  scene_ids = np.asarray([f'synthetic/{seed}/{i}' for i in indices])
  num = len(scene_ids)
  if mode == types.DataMode.SINGLE_SCENE:
    return {'scene_id': scene_ids, 'vehicle_type': np.asarray(['CAR'] * num)}
  if mode == types.DataMode.PAIR_SCENE_VIEW:
    query_ids = np.asarray([f'synthetic_query/{seed}/{i}' for i in indices])
    return {
        'map/scene_id': scene_ids,
        'map/vehicle_type': np.asarray(['CAR'] * num),
        'query/scene_id': query_ids,
        'query/vehicle_type': np.asarray(['TREKKER'] * num),
        'pair_id': np.asarray(
            [f'{m}|{q}' for m, q in zip(scene_ids, query_ids)]),
    }
  if mode == types.DataMode.PAIR_SCENES:
    cars = np.asarray(['CAR'] * num)
    return {
        'scene_i/scene_id': scene_ids,
        'scene_i/vehicle_type': cars,
        'scene_j/scene_id': np.asarray([f'{s}/j' for s in scene_ids]),
        'scene_j/vehicle_type': cars,
    }
  raise NotImplementedError(mode)


def _tensors(tree) -> Iterator[torch.Tensor]:
  """Every tensor of a batch (dicts and geometry dataclasses), ``_host``
  left out."""
  if isinstance(tree, torch.Tensor):
    yield tree
  elif isinstance(tree, dict):
    for key, value in tree.items():
      if key != '_host':
        yield from _tensors(value)
  elif dataclasses.is_dataclass(tree):
    for field in dataclasses.fields(tree):
      yield from _tensors(getattr(tree, field.name))


@dataclasses.dataclass
class BuildTime:
  """How long one batch took to make. ``wall_ms``: the host's time in the
  call that made it (on a CUDA card the draws and the dispatch of the
  card's work, which the call does not wait for). ``card_ms``: on a CUDA
  card the card's time between two events recorded around the build on
  the stream it was built on, else None; reading it waits for the build
  to finish, so read it once the steps that follow have been dispatched.
  """

  wall_ms: float
  events: Optional[Tuple[torch.cuda.Event, torch.cuda.Event]] = None

  @property
  def card_ms(self) -> Optional[float]:
    if self.events is None:
      return None
    start, end = self.events
    end.synchronize()
    return start.elapsed_time(end)


class PrefetchIterator:
  """Worker threads building batches in order, up to ``buffer_size`` ahead
  (``snap_tpu/data/loader.py:_PrefetchIterator``).

  ``make_batch(i)`` builds batch ``i``; batches are emitted strictly in
  index order whatever order the workers finish in. An eval iterator
  (``num_batches`` set) wraps around after its batch count. A worker's
  error is raised by ``__next__`` as a ``RuntimeError``. The workers start
  at the first ``__next__``; ``close`` stops them. With ``num_workers=0``
  there are none: ``__next__`` builds each batch itself, in the consumer's
  thread and on its stream. After each ``__next__``, ``last_build`` holds
  that batch's ``BuildTime``.
  """

  def __init__(self, make_batch: Callable[[int], DataDict],
               num_batches: Optional[int], device: Device,
               buffer_size: int = 2, start_index: int = 0,
               num_workers: int = 2):
    self._make_batch = make_batch
    self._num_batches = num_batches
    self._device = torch.device(device)
    self._num_workers = max(0, num_workers)
    self._buffer_size = max(buffer_size, self._num_workers)
    self._results: Dict[int, Any] = {}
    self._error: Optional[BaseException] = None
    self._closed = False
    self._threads: list = []
    self._lock = threading.Lock()
    self._ready = threading.Condition(self._lock)
    self._next_to_build = start_index
    self._next_to_emit = start_index
    self.last_build: Optional[BuildTime] = None

  def _wrap(self, i: int) -> int:
    return i if self._num_batches is None else i % self._num_batches

  def _build(self, i: int, stream: Optional[torch.cuda.Stream]):
    t0 = time.perf_counter()
    if stream is None:
      batch = self._make_batch(self._wrap(i))
      return batch, BuildTime(1e3 * (time.perf_counter() - t0)), None
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with torch.cuda.stream(stream):
      start.record(stream)
      batch = self._make_batch(self._wrap(i))
      end.record(stream)
    wall_ms = 1e3 * (time.perf_counter() - t0)
    return batch, BuildTime(wall_ms, (start, end)), end

  def _worker(self):
    cuda = self._device.type == 'cuda'
    try:
      stream = torch.cuda.Stream(self._device) if cuda else None
      while True:
        with self._lock:
          while (self._error is None and not self._closed
                 and self._next_to_build - self._next_to_emit
                 >= self._buffer_size):
            self._ready.wait()
          if self._error is not None or self._closed:
            return
          i = self._next_to_build
          self._next_to_build += 1
        result = self._build(i, stream)
        with self._lock:
          self._results[i] = result
          self._ready.notify_all()
    except BaseException as e:  # pylint: disable=broad-except
      with self._lock:
        self._error = e
        self._ready.notify_all()

  def __iter__(self):
    return self

  def __next__(self) -> DataDict:
    if not self._num_workers:
      i = self._next_to_emit
      self._next_to_emit += 1
      stream = (torch.cuda.current_stream(self._device)
                if self._device.type == 'cuda' else None)
      batch, self.last_build, _ = self._build(i, stream)
      return batch
    with self._lock:
      if not self._threads:
        self._threads = [threading.Thread(target=self._worker, daemon=True)
                         for _ in range(self._num_workers)]
        for thread in self._threads:
          thread.start()
      while self._next_to_emit not in self._results:
        if self._error is not None:
          raise RuntimeError('Data pipeline worker failed') from self._error
        self._ready.wait()
      batch, build, done = self._results.pop(self._next_to_emit)
      self._next_to_emit += 1
      self._ready.notify_all()
    if done is not None:
      consumer = torch.cuda.current_stream(self._device)
      consumer.wait_event(done)
      for t in _tensors(batch):
        t.record_stream(consumer)
    self.last_build = build
    return batch

  def close(self) -> None:
    with self._lock:
      self._closed = True
      self._ready.notify_all()
    for thread in self._threads:
      thread.join()


@dataclasses.dataclass
class Dataset:
  """Train/eval iterators + metadata (the reference's ``Dataset``)."""

  train_iter: PrefetchIterator
  valid_iter: PrefetchIterator
  meta_data: Dict[str, Any]

  def close(self) -> None:
    self.train_iter.close()
    self.valid_iter.close()

  def __enter__(self) -> 'Dataset':
    return self

  def __exit__(self, *exc) -> None:
    self.close()


def _indices_and_mask(batch_size: int, num_examples: Optional[int],
                      batch_index: int):
  """Example indices of a batch and its ``batch_mask``: eval batches clamp
  their indices to the last example and mask the padded rows."""
  indices = np.arange(batch_index * batch_size,
                      (batch_index + 1) * batch_size)
  if num_examples is None:
    return indices, np.ones(batch_size, np.float32)
  mask = (indices < num_examples).astype(np.float32)
  return np.minimum(indices, max(num_examples - 1, 0)), mask


def get_dataset(data_config: configs.DataConfig, batch_size: int,
                eval_batch_size: Optional[int] = None,
                device: Device = 'cuda', start_step: int = 0,
                num_processes: Optional[int] = None,
                process_index: Optional[int] = None) -> Dataset:
  """Train and eval iterators of ``data_config`` on ``device``
  (``snap_tpu/data/loader.py:get_dataset``).

  Train batch ``s`` holds examples ``s * batch_size + k`` from
  ``start_step`` on; the eval split holds ``evaluation_size`` examples in
  ``ceil(evaluation_size / eval_batch_size)`` batches, the last one padded
  (``batch_mask`` 0) and the iterator wrapping around after it. The batch
  sizes are global: process ``process_index`` of ``num_processes`` (the
  mesh's rank and world by default) builds rows ``[index * bs / num,
  (index + 1) * bs / num)`` of each; sizes that do not divide raise.
  """
  eval_batch_size = eval_batch_size or batch_size
  num_processes = mesh.world_size() if num_processes is None else (
      num_processes)
  process_index = mesh.rank() if process_index is None else process_index
  if batch_size % num_processes or eval_batch_size % num_processes:
    raise ValueError(
        f'Global batch sizes ({batch_size}, {eval_batch_size}) must divide '
        f'evenly over {num_processes} processes.')
  mode = types.DataMode(data_config.mode or 'pair_scene_view')
  device = torch.device(device)
  on_device = data_config.on_device_generation
  if on_device is None:
    on_device = device.type == 'cuda'
  spec = device_spec(data_config) if on_device else None

  def batch_fn(split: str, bs: int, num_examples: Optional[int]):
    seed = split_seed(data_config, split)
    generator = None if on_device else split_generator(data_config, split)

    rows = mesh.block(bs, num_processes, process_index)

    def make(batch_index: int) -> DataDict:
      indices, mask = _indices_and_mask(bs, num_examples, batch_index)
      indices, mask = indices[rows], mask[rows]
      if generator is not None:
        batch = make_examples(generator, indices, data_config, mode)
        batch['batch_mask'] = mask
        return process_batch(batch, mode, device)
      draws = device_synthetic.draw_batch(spec, mode, seed, indices)
      batch = device_synthetic.make_batch(
          spec, mode, device_synthetic.draws_to(draws, device))
      batch['batch_mask'] = torch.as_tensor(mask, device=device)
      batch['_host'] = host_strings(mode, seed, indices)
      return batch

    return make

  evaluation_size = int(data_config.evaluation_size)
  num_eval_batches = -(-evaluation_size // eval_batch_size)
  workers = dict(device=device,
                 num_workers=0 if on_device else data_config.num_workers)
  train_iter = PrefetchIterator(
      batch_fn('train', batch_size, None), None,
      buffer_size=data_config.prefetch_buffer_size, start_index=start_step,
      **workers)
  valid_iter = PrefetchIterator(
      batch_fn('eval', eval_batch_size, evaluation_size), num_eval_batches,
      **workers)
  meta_data = {
      **scene_meta_data(data_config),
      'num_eval_examples': evaluation_size,
      'generator_kind': 'device-torch' if on_device else 'host-numpy',
  }
  return Dataset(train_iter, valid_iter, meta_data)
