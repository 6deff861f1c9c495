"""``python -m snap_tpu_torch.bench`` at smoke scale on the CPU.

The bench times the localizer and the training step of the configs it is
given; here the smoke ones, whose forward and step the parity tests
(``tests/test_torch_localizer.py``, ``tests/test_torch_train.py``) hold
against JAX. This checks its line: ``bench.py``'s fields, consistent with
one another, and the data path of each phase.
"""

import json

import pytest
import torch

from snap_tpu_torch import bench

torch.set_num_threads(2)


@pytest.fixture(scope='module')
def line():
  return bench.run('cpu', 'smoke_exhaustive', 'smoke_train_exhaustive')


def test_line_has_the_reference_fields(line):
  for key in ('metric', 'value', 'unit', 'vs_baseline',
              'poses_scored_per_query', 'localization_queries_per_sec',
              'bev_maps_per_sec', 'eval_batch_size', 'num_timing_iters',
              'train_step_sec_full_scale', 'train_examples_per_sec',
              'train_batch_per_chip', 'train_step_hbm_gb', 'device',
              'generator_kind', 'build_ms'):
    assert key in line, key
  assert json.loads(json.dumps(line)) == line


def test_line_is_consistent(line):
  assert line['poses_scored_per_query'] == 20_000 + 41**3
  assert line['value'] == pytest.approx(
      line['localization_queries_per_sec'] * line['poses_scored_per_query'])
  assert line['vs_baseline'] == pytest.approx(line['value'] / 1000)
  assert line['train_examples_per_sec'] == pytest.approx(
      line['train_batch_per_chip'] / line['train_step_sec_full_scale'])
  assert (line['eval_batch_size'], line['train_batch_per_chip'],
          line['num_timing_iters']) == (4, 2, 10)
  assert line['train_step_hbm_gb'] is None  # a card's figure only
  assert line['device'] == 'cpu'
  assert line['generator_kind'] == {'eval': 'host-numpy',
                                    'train': 'host-numpy'}
  assert all(ms > 0 for ms in line['build_ms'].values())
  assert torch.isfinite(torch.tensor(line['train_loss']))


def test_time_fn_reads_every_call():
  calls = []

  def fn():
    calls.append(1)
    return torch.ones(())

  assert bench.time_fn(fn, iters=3) >= 0
  assert len(calls) == 4  # one warm-up
