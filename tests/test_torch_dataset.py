"""The port's dataset: the train/eval iterators of ``loader.get_dataset``.

At smoke size (3 views, 24 x 32 images, 0.8 m voxels) on the CPU: eval
batches padded and masked, the eval iterator wrapping, ``start_step``
offsetting the train indices, the prefetching iterator's order, buffer and
errors, the host strings equal to the JAX loader's, and the data path
picked by the device.
"""

import dataclasses
import json
import threading
import time

import numpy as np
import pytest
import torch

from snap_tpu.data import loader as jloader
from snap_tpu.data import types as jtypes
from snap_tpu_torch import configs
from snap_tpu_torch import train
from snap_tpu_torch.data import device_synthetic
from snap_tpu_torch.data import loader
from snap_tpu_torch.data import types

torch.set_num_threads(2)


def _data(**kwargs):
  data = dataclasses.replace(configs.smoke_exhaustive().data,
                             image_size=(24, 32), voxel_size=0.8,
                             num_workers=1)
  return dataclasses.replace(data, **kwargs)


@pytest.mark.parametrize('on_device', [True, False])
def test_eval_batches_are_padded_and_masked(on_device):
  data = _data(evaluation_size=3, on_device_generation=on_device)
  with loader.get_dataset(data, 2, device='cpu') as dataset:
    b0, b1 = next(dataset.valid_iter), next(dataset.valid_iter)
  np.testing.assert_array_equal(b0['batch_mask'].numpy(), [1.0, 1.0])
  np.testing.assert_array_equal(b1['batch_mask'].numpy(), [1.0, 0.0])
  # The padded row repeats the last example.
  ids = b1['_host']['pair_id']
  assert ids[0] == ids[1] and ids[0].endswith('/2')
  torch.testing.assert_close(b1['query']['images'][0],
                             b1['query']['images'][1], rtol=0, atol=0)


def test_eval_iterator_wraps_after_its_batches():
  data = _data(evaluation_size=3, on_device_generation=True)
  with loader.get_dataset(data, 2, device='cpu') as dataset:
    batches = [next(dataset.valid_iter) for _ in range(3)]
  np.testing.assert_array_equal(batches[2]['_host']['pair_id'],
                                batches[0]['_host']['pair_id'])
  torch.testing.assert_close(batches[2]['map']['images'],
                             batches[0]['map']['images'], rtol=0, atol=0)


@pytest.mark.parametrize('on_device', [True, False])
def test_start_step_offsets_the_train_indices(on_device):
  data = _data(on_device_generation=on_device)
  with loader.get_dataset(data, 2, device='cpu') as dataset:
    batches = [next(dataset.train_iter) for _ in range(4)]
  with loader.get_dataset(data, 2, device='cpu', start_step=3) as dataset:
    resumed = next(dataset.train_iter)
  seed = loader.split_seed(data, 'train')
  np.testing.assert_array_equal(resumed['_host']['map/scene_id'],
                                [f'synthetic/{seed}/6', f'synthetic/{seed}/7'])
  np.testing.assert_array_equal(resumed['_host']['pair_id'],
                                batches[3]['_host']['pair_id'])
  torch.testing.assert_close(resumed['map']['images'],
                             batches[3]['map']['images'], rtol=0, atol=0)


def test_prefetch_emits_in_order_within_its_buffer():
  """Two workers, the even batches slower than the odd ones: batches come
  out in index order, and no worker starts a batch more than
  ``buffer_size`` ahead of the consumer."""
  started, lock = [], threading.Lock()

  def make(i):
    with lock:
      started.append(i)
    time.sleep(0.05 if i % 2 == 0 else 0.0)
    return {'i': torch.tensor(i)}

  it = loader.PrefetchIterator(make, None, 'cpu', buffer_size=3,
                               num_workers=2)
  got = []
  for emitted in range(1, 9):
    got.append(int(next(it)['i']))
    time.sleep(0.02)
    with lock:
      assert max(started) < emitted + 3, (started, emitted)
    assert it.last_build.wall_ms >= 0 and it.last_build.card_ms is None
  it.close()
  assert got == list(range(8))


def test_prefetch_without_workers_builds_in_the_consumer():
  """``num_workers=0`` (the device path's default): each batch is built
  by ``__next__`` itself, in order, in the consumer's thread."""
  threads = []

  def make(i):
    threads.append(threading.get_ident())
    return {'i': torch.tensor(i)}

  it = loader.PrefetchIterator(make, 3, 'cpu', start_index=1, num_workers=0)
  assert threads == []
  assert [int(next(it)['i']) for _ in range(4)] == [1, 2, 0, 1]
  assert threads == [threading.get_ident()] * 4
  it.close()


def test_prefetch_reraises_a_worker_error():
  def make(i):
    if i == 2:
      raise ValueError('bad batch')
    return {'i': torch.tensor(i)}

  it = loader.PrefetchIterator(make, None, 'cpu', num_workers=1)
  assert int(next(it)['i']) == 0 and int(next(it)['i']) == 1
  with pytest.raises(RuntimeError, match='worker failed') as info:
    next(it)
  assert isinstance(info.value.__cause__, ValueError)
  it.close()


@pytest.mark.parametrize('mode', list(types.DataMode), ids=lambda m: m.value)
def test_host_strings_equal_the_jax_loaders(mode):
  indices = np.array([0, 5, 5, 11])
  got = loader.host_strings(mode, 1234, indices)
  want = jloader._host_strings(jtypes.DataMode(mode.value), 1234, indices)
  assert set(got) == set(want)
  for key in want:
    np.testing.assert_array_equal(got[key], want[key])


@pytest.mark.parametrize('on_device,kind', [
    (None, 'host-numpy'), (True, 'device-torch'), (False, 'host-numpy')])
def test_generator_kind(on_device, kind):
  """On the CPU the default is the host generator; forced, the device
  generator runs on the CPU."""
  with loader.get_dataset(_data(on_device_generation=on_device), 2,
                          device='cpu') as dataset:
    assert dataset.meta_data['generator_kind'] == kind


@pytest.mark.parametrize('on_device', [True, False])
def test_device_path_builds_in_the_consumers_thread(on_device, monkeypatch):
  """The device path builds each batch in the consumer's thread whatever
  ``num_workers`` says; the host path builds in its worker threads."""
  threads = []
  for module, name in ((device_synthetic, 'make_batch'),
                       (loader, 'make_examples')):
    build = getattr(module, name)

    def spy(*args, build=build, **kwargs):
      threads.append(threading.get_ident())
      return build(*args, **kwargs)

    monkeypatch.setattr(module, name, spy)
  data = _data(on_device_generation=on_device, num_workers=2)
  with loader.get_dataset(data, 2, device='cpu') as dataset:
    for _ in range(3):
      next(dataset.train_iter)
  assert len(threads) >= 3
  in_consumer = [t == threading.get_ident() for t in threads]
  assert all(in_consumer) if on_device else not any(in_consumer)


def test_train_cli_on_device_generation(capsys, tmp_path):
  """The device generator on the CPU."""
  train.main(['--config=smoke_train_exhaustive', '--num_steps=2',
              '--device=cpu', '--on_device_generation=true',
              f'--workdir={tmp_path}'])
  lines = [json.loads(l) for l in capsys.readouterr().out.splitlines()]
  summary = lines[-1]
  assert summary['generator_kind'] == 'device-torch'
  assert len(summary['build_ms']) == 2 and summary['build_card_ms'] == [
      None, None]
  assert len(summary['wall_seconds']) == 2
  assert [l['step'] for l in lines[:-1]] == [0, 1]
