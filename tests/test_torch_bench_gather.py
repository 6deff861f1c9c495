"""Port parity of the gather micro-benchmark's kernels (B5, B6) and its CLI.

``slice_gather_plain`` and ``table_gather_plain`` against the tool's own
Pallas kernel bodies (``tools/bench_gather.py:pallas_slice_kernel``, P2, and
``dyngather_kernel``, P3), each wrapped in a test-local ``pl.pallas_call``
in interpret mode. N is not a multiple of the tile: the inputs are padded to
whole tiles and all N rows compared, where the tool's own grids would leave
the last N mod tile rows unwritten (ROADMAP C13).
"""

import importlib.util
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from snap_tpu_torch import bench_gather
from snap_tpu_torch.ops import gathers
from snap_tpu_torch.ops import kernels

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parents[1]

# P2 adds the bf16 taps in bf16, (top + bot).sum(0): three roundings of at
# most 2^-8 of a partial sum each, where the port adds in f32 and rounds
# once. Every partial sum is at most the sum of the taps' magnitudes, so
# the two differ by at most 4 * 2^-8 of it (measured: 0.0234 at C = 16,
# N = 8192, on values of up to ~8).
SLICE_RTOL_OF_TAPS = 4 * 2.0**-8


@pytest.fixture(scope='module')
def tool():
  """tools/bench_gather.py, loaded once (it makes its inputs on import)."""
  spec = importlib.util.spec_from_file_location(
      'bench_gather_tool', REPO / 'tools' / 'bench_gather.py')
  module = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(module)
  return module


def _pad(ids: np.ndarray, tile: int) -> np.ndarray:
  padded = np.zeros(-(-len(ids) // tile) * tile, ids.dtype)
  padded[:len(ids)] = ids
  return padded


def _p2(tool, stack: np.ndarray, rid: np.ndarray, tile: int) -> np.ndarray:
  """P2's kernel body over whole tiles covering all N points."""
  ridp = _pad(rid, tile)
  c = stack.shape[1]
  out = pl.pallas_call(
      tool.pallas_slice_kernel, grid=(len(ridp) // tile,),
      in_specs=[pl.BlockSpec((tile,), lambda i: (i,)),
                pl.BlockSpec(stack.shape, lambda i: (0, 0))],
      out_specs=pl.BlockSpec((tile, c), lambda i: (i, 0)),
      out_shape=jax.ShapeDtypeStruct((len(ridp), c), jnp.bfloat16),
      interpret=True)(jnp.asarray(ridp), jnp.asarray(stack))
  return np.asarray(out)[:len(rid)]


def _p3(tool, table: np.ndarray, ids: np.ndarray, block: int) -> np.ndarray:
  """P3's kernel body over whole blocks covering all N ids."""
  idsp = _pad(ids, block)
  out = pl.pallas_call(
      tool.dyngather_kernel, grid=(len(idsp) // block,),
      in_specs=[pl.BlockSpec((block,), lambda i: (i,)),
                pl.BlockSpec(table.shape, lambda i: (0, 0))],
      out_specs=pl.BlockSpec((block, table.shape[1]), lambda i: (i, 0)),
      out_shape=jax.ShapeDtypeStruct((len(idsp), table.shape[1]),
                                     table.dtype),
      interpret=True)(jnp.asarray(idsp), jnp.asarray(table))
  return np.asarray(out)[:len(ids)]


@pytest.mark.parametrize('channels,num_points', [(16, 8192 + 300),
                                                 (160, 1000)])
def test_slice_gather_plain_matches_p2(tool, channels, num_points):
  """Over all N points, tail included; the tool's W = 60 (61 columns)."""
  rng = np.random.default_rng(channels)
  w = tool.W
  rows = 40 * (w + 1)
  stack = rng.normal(size=(rows, channels)).astype(jnp.bfloat16)
  rid = rng.integers(0, rows - w - 2, size=num_points).astype(np.int32)
  want = _p2(tool, stack, rid, tile=1024).astype(np.float32)
  got = gathers.slice_gather(torch.from_numpy(stack.astype(np.float32)).to(
      torch.bfloat16), torch.from_numpy(rid), w=w)
  assert got.shape == (num_points, channels) and got.dtype == torch.bfloat16
  got = got.float().numpy()
  s = stack.astype(np.float32)
  taps = np.abs(s[rid]) + np.abs(s[rid + 1]) + np.abs(s[rid + w + 1]) + (
      np.abs(s[rid + w + 2]))
  assert (np.abs(got - want) <= SLICE_RTOL_OF_TAPS * taps).all()
  # The port rounds the exact f32 sum once (the four bf16 taps add exactly
  # in f32 at these magnitudes).
  exact = s[rid] + s[rid + 1] + s[rid + w + 1] + s[rid + w + 2]
  np.testing.assert_array_equal(
      got, torch.from_numpy(exact).to(torch.bfloat16).float().numpy())


@pytest.mark.parametrize('num_points', [2048 * 3 + 500, 100])
def test_table_gather_plain_matches_p3(tool, num_points):
  rng = np.random.default_rng(num_points)
  table = rng.normal(size=(8, 128)).astype(np.float32)
  ids = rng.integers(0, 8, size=num_points).astype(np.int32)
  want = _p3(tool, table, ids, block=2048)
  got = gathers.table_gather(torch.from_numpy(table), torch.from_numpy(ids))
  np.testing.assert_array_equal(got.numpy(), want)


def test_slice_rows_clamp_to_the_stack():
  rid = torch.tensor([-5, 0, 1000], dtype=torch.int32)
  rows = gathers.slice_rows(rid, 100, 9)
  assert rows.tolist() == [[0, 1, 10, 11], [0, 1, 10, 11],
                           [88, 89, 98, 99]]


def test_fused4_matches_its_f32_math():
  """The port of the tool's xla_fused4 differs from the same math in f32 by
  its bf16 roundings only (weights, per-rank contraction, output)."""
  inputs = bench_gather.make_inputs(4096, seed=1, device='cpu')
  args = [inputs[k] for k in ('stack', 'row0', 'col0', 'frac', 'score')]
  got = bench_gather.fused4(*args)
  want = bench_gather.fused4(*args, exact=True)
  assert got.shape == (1, 4096, 160) and got.dtype == torch.bfloat16
  err = (got.float() - want).abs()
  assert float(err.max()) <= 3 * 2.0**-8 * float(want.abs().max())


def test_bench_gather_cli_on_cpu(capsys):
  """One JSON line with the four strategies; the plain versions agree."""
  kernels.reset_launch_counts()
  result = bench_gather.main(['--device=cpu', '--num_points=5000',
                              '--iters=1'])
  line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
  assert line == json.loads(json.dumps(result))
  assert line['device'] == 'cpu' and line['num_points'] == 5000
  names = [s['name'] for s in line['strategies']]
  assert names == ['xla_patch', 'xla_fused4', 'pallas_slice',
                   'pallas_dyngather']
  by_name = {s['name']: s for s in line['strategies']}
  for name in ('xla_patch', 'pallas_slice', 'pallas_dyngather'):
    assert by_name[name]['max_abs_err'] == 0.0
  for s in line['strategies']:
    assert s['bound_ms'] > 0 and s['bound_by'] in ('bytes', 'operations')
  assert by_name['pallas_slice']['launches'] == 0  # the CPU ran the plain
  assert kernels.LAUNCHES['slice_gather'] == 0


def test_bench_gather_refuses_a_missing_card(monkeypatch):
  monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
  with pytest.raises(SystemExit, match='no CUDA card'):
    bench_gather.main(['--num_points=16'])


def test_tool_shapes():
  """The entry point keeps the tool's shapes (tools/bench_gather.py:33-36)."""
  assert (bench_gather.B, bench_gather.V, bench_gather.H, bench_gather.W,
          bench_gather.C, bench_gather.N, bench_gather.K) == (
              1, 20, 45, 60, 160, 1_152_000, 4)
  inputs = bench_gather.make_inputs(64, device='cpu')
  assert tuple(inputs['stack'].shape) == (1, 920, 61, 160)
  assert tuple(bench_gather.flat_stack(inputs['stack']).shape) == (56120, 160)
