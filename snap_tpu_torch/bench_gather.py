"""Gather micro-benchmark: four strategies of the lift's gather at its shape.

    python -m snap_tpu_torch.bench_gather
    python -m snap_tpu_torch.bench_gather --device=cpu --num_points=8192

The port's counterpart of ``tools/bench_gather.py``, at its shapes: a
row-padded image stack ``[B, V (h + 1), w + 1, C] = [1, 920, 61, 160]``
bf16 and N = 1,152,000 points (the 120 x 160 x 60 voxels of the flagship
lift), K = 4 ranks. The inputs are drawn from ``--seed`` on a
``torch.Generator``. Strategies:

- ``xla_patch``: the plain torch 2x2xC patch gather of rank 0
  (``view_scan.gather_bilinear_patches``), checked against an index
  gather of the same four rows;
- ``xla_fused4``: a plain torch port of the tool's own ``xla_fused4`` math
  (4 rank gathers, bf16 bilinear weights, softmax-weighted pooling), checked
  against the same math in f32. It has no depth score and no variance, so
  it is not K1's function;
- ``pallas_slice``: **B5** (``ops/gathers.py:slice_gather``), the
  unweighted 2x2 tap sum of rank 0, against its plain version;
- ``pallas_dyngather``: **B6** (``ops/gathers.py:table_gather``), rows of
  an ``[8, 128]`` f32 table, against its plain version.

B5 and B6 cover all N points; the tool's grids leave the last 1,024 rows
unwritten (ROADMAP C13). Times are CUDA-event means over ``--iters``
launches after a warmup on the card, host-clock means on the CPU (only when
asked for with ``--device=cpu``), of the strategy's output without the
tool's trailing sum to a scalar. The bound is the larger of the bytes each
strategy must move (inputs read once, output written once) over 3.35 TB/s
and its f32 operations over 67 TFLOP/s (H100 SXM, NVIDIA's data sheet);
``library_ms`` times one PyTorch call that computes the same function, where
there is one (``F.embedding``, ``F.embedding_bag``). Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Any, Callable, Dict, Optional

import torch
import torch.nn.functional as F

from snap_tpu_torch.ops import gathers
from snap_tpu_torch.ops import kernels
from snap_tpu_torch.ops import view_scan

Tensor = torch.Tensor

# tools/bench_gather.py:33-35.
B, V, H, W, C = 1, 20, 45, 60, 160
N = 1_152_000
K = 4
TABLE_SHAPE = (8, 128)

# H100 SXM peaks (NVIDIA's data sheet, 700 W): HBM bytes/s and f32 FLOP/s
# outside the tensor cores, for the lower bounds of the kernels' times.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12


def make_inputs(num_points: int = N, seed: int = 0,
                device: str = 'cuda') -> Dict[str, Tensor]:
  """The tool's inputs, drawn on a ``torch.Generator`` seeded ``seed``."""
  g = torch.Generator(device='cpu').manual_seed(seed)
  rows = V * (H + 1)
  inputs = {
      'stack': torch.randn((B, rows, W + 1, C), generator=g).to(
          torch.bfloat16),
      'row0': torch.randint(0, rows - 1, (K, B, num_points), generator=g,
                            dtype=torch.int32),
      'col0': torch.randint(0, W - 1, (K, B, num_points), generator=g,
                            dtype=torch.int32),
      'frac': torch.rand((K, B, num_points, 2), generator=g).to(
          torch.bfloat16),
      'score': torch.randn((K, B, num_points), generator=g),
      'table': torch.randn(TABLE_SHAPE, generator=g),
      'ids': torch.randint(0, TABLE_SHAPE[0], (num_points,), generator=g,
                           dtype=torch.int32),
  }
  return {k: v.to(device) for k, v in inputs.items()}


def flat_stack(stack: Tensor) -> Tensor:
  """Example 0 of the stack as ``[R (W + 1), C]``, as the tool flattens it."""
  return stack[0].reshape(-1, stack.shape[-1])


def row_ids(row0: Tensor, col0: Tensor) -> Tensor:
  """``r0 (W + 1) + c0`` of rank 0, example 0 (``pallas_slice``)."""
  return (row0[0, 0] * (W + 1) + col0[0, 0]).to(torch.int32)


def xla_patch(stack: Tensor, row0: Tensor, col0: Tensor) -> Tensor:
  """Rank 0's 2x2xC patches ``[B, N, 2, 2, C]`` by plain torch gathers."""
  return view_scan.gather_bilinear_patches(stack, row0[0], col0[0])


def xla_patch_plain(stack: Tensor, row0: Tensor, col0: Tensor) -> Tensor:
  """The same patches by an index gather of the four flat rows."""
  rows = gathers.slice_rows(row_ids(row0, col0), stack.shape[1] * (W + 1), W)
  return flat_stack(stack)[rows].reshape(B, -1, 2, 2, C)


def fused4(stack: Tensor, row0: Tensor, col0: Tensor, frac: Tensor,
           score: Tensor, exact: bool = False) -> Tensor:
  """``tools/bench_gather.py:xla_fused4``: K rank gathers, bilinear weights
  in bf16, the per-rank 2x2 contraction accumulated in f32 and rounded to
  bf16, softmax-weighted pooling in f32, output bf16. With ``exact``, the
  same math in f32 throughout (its plain reference)."""
  m = score.max(0).values
  w_rank = torch.exp(score - m)  # [K, B, N]
  l = w_rank.sum(0)
  s1 = torch.zeros((*score.shape[1:], stack.shape[-1]), dtype=torch.float32,
                   device=stack.device)
  for k in range(score.shape[0]):
    patches = view_scan.gather_bilinear_patches(stack, row0[k], col0[k])
    fr = frac[k].float() if exact else frac[k]
    wi = torch.stack([1 - fr[..., 0], fr[..., 0]], -1)
    wj = torch.stack([1 - fr[..., 1], fr[..., 1]], -1)
    wt = wi[..., :, None] * wj[..., None, :]  # [B, N, 2, 2]
    f_k = (wt.float()[..., None] * patches.float()).sum((2, 3))
    if not exact:
      f_k = f_k.to(torch.bfloat16).float()
    s1 = s1 + w_rank[k][..., None] * f_k
  out = s1 / l[..., None]
  return out if exact else out.to(torch.bfloat16)


def _timer(device: torch.device, iters: int) -> Callable[[Callable], float]:
  def time_ms(fn: Callable[[], Any]) -> float:
    fn()
    if device.type != 'cuda':
      t0 = time.perf_counter()
      for _ in range(iters):
        fn()
      return (time.perf_counter() - t0) / iters * 1e3
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
      fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / iters
  return time_ms


def nbytes(*tensors: Tensor) -> int:
  """Bytes of the tensors, each counted once."""
  return sum(t.numel() * t.element_size() for t in tensors)


def bound(nbytes: int, ops: int):
  """(bound_ms, bound_by): the larger of the bytes time and the ops time."""
  t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS
  return max(t_bytes, t_ops) * 1e3, ('bytes' if t_bytes >= t_ops
                                     else 'operations')


def _max_err(got: Tensor, want: Tensor) -> float:
  return float((got.float() - want.float()).abs().max())


def run(num_points: int = N, seed: int = 0, device: str = 'cuda',
        iters: int = 10) -> Dict[str, Any]:
  """Check and time the four strategies; returns the JSON line's object."""
  dev = torch.device(device)
  inputs = make_inputs(num_points, seed, device)
  stack, row0, col0 = inputs['stack'], inputs['row0'], inputs['col0']
  frac, score = inputs['frac'], inputs['score']
  table, ids = inputs['table'], inputs['ids']
  flat = flat_stack(stack)
  rid = row_ids(row0, col0)
  rows = gathers.slice_rows(rid, flat.shape[0], W)
  time_ms = _timer(dev, iters)
  n = num_points
  out: Dict[str, Any] = {}

  def entry(name, fn, plain_fn, nbytes, ops, library_fn=None,
            launches_key: Optional[str] = None):
    before = kernels.LAUNCHES[launches_key] if launches_key else 0
    with torch.no_grad():
      got, want = fn(), plain_fn()
      err = _max_err(got, want)
      del got, want
      row = {'name': name, 'max_abs_err': err, 'ms': time_ms(fn),
             'plain_ms': time_ms(plain_fn)}
      row['bound_ms'], row['bound_by'] = bound(nbytes, ops)
      row['library_ms'] = time_ms(library_fn) if library_fn else None
    if launches_key:
      row['kernel'] = launches_key
      row['launches'] = kernels.LAUNCHES[launches_key] - before
    out[name] = row

  patch_bytes = B * n * 4 * C * stack.element_size()
  entry('xla_patch', lambda: xla_patch(stack, row0, col0),
        lambda: xla_patch_plain(stack, row0, col0),
        nbytes(stack, row0[0], col0[0]) + patch_bytes, 0,
        library_fn=lambda: F.embedding(rows, flat))
  fused_bytes = nbytes(stack, row0, col0, frac, score) + B * n * C * 2
  # Per rank and point: 2x2 weights (6), the contraction (8C), the pooled
  # update (2C); per point: the softmax (4K) and the division (C).
  fused_ops = B * n * (K * (6 + 10 * C) + 4 * K + C)
  entry('xla_fused4', lambda: fused4(stack, row0, col0, frac, score),
        lambda: fused4(stack, row0, col0, frac, score, exact=True),
        fused_bytes, fused_ops)
  entry('pallas_slice', lambda: gathers.slice_gather(flat, rid, w=W),
        lambda: gathers.slice_gather_plain(flat, rid, w=W),
        nbytes(flat, rid) + n * C * 2, n * 3 * C,
        library_fn=lambda: F.embedding_bag(rows, flat, mode='sum'),
        launches_key='slice_gather')
  entry('pallas_dyngather', lambda: gathers.table_gather(table, ids),
        lambda: gathers.table_gather_plain(table, ids),
        nbytes(table, ids) + n * table.shape[1] * 4, 0,
        library_fn=lambda: F.embedding(ids, table),
        launches_key='table_gather')
  name = (torch.cuda.get_device_name(dev) if dev.type == 'cuda'
          else 'cpu')
  return {'bench': 'gather', 'device': name, 'num_points': n,
          'shapes': {'stack': list(stack.shape), 'table': list(table.shape),
                     'ranks': K},
          'strategies': list(out.values())}


def main(argv=None) -> Dict[str, Any]:
  parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  parser.add_argument('--device', default='cuda')
  parser.add_argument('--num_points', type=int, default=N)
  parser.add_argument('--seed', type=int, default=0)
  parser.add_argument('--iters', type=int, default=10)
  args = parser.parse_args(argv)
  if torch.device(args.device).type == 'cuda' and (
      not torch.cuda.is_available()):
    raise SystemExit('bench_gather: no CUDA card (pass --device=cpu to run '
                     'the plain versions on the CPU)')
  result = run(args.num_points, args.seed, args.device, args.iters)
  print(json.dumps(result), flush=True)
  return result


if __name__ == '__main__':
  main()
