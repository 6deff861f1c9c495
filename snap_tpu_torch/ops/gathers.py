"""The gather micro-benchmark's two kernels and their plain versions.

- ``slice_gather``: **B5** (``csrc/slice_gather.cu``), the port of
  ``tools/bench_gather.py:pallas_slice_kernel``: per point, the unweighted
  sum of the 2x2 taps of a flat, row-padded bf16 stack;
- ``table_gather``: **B6** (``csrc/table_gather.cu``), the port of
  ``tools/bench_gather.py:dyngather_kernel``: ``table[ids]`` from a small
  table.

Each dispatches on the device of its input (``kernels.on_card``): a CPU
tensor takes the plain version beside it, a CUDA tensor launches the
kernel (``ops/kernels.py``), any other device raises. Both cover all N
points, where the tool's grids leave a tail unwritten (ROADMAP C13).
"""

from __future__ import annotations

import torch

from snap_tpu_torch.ops import kernels

Tensor = torch.Tensor


def slice_rows(rid: Tensor, rows: int, w: int) -> Tensor:
  """The four flat rows of each point's 2x2 patch, ``[N, 4]`` int64, with
  ``rid`` clamped so that all four lie in a stack of ``rows`` rows."""
  rid = rid.long().clamp(0, rows - w - 3)
  offsets = torch.tensor([0, 1, w + 1, w + 2], device=rid.device)
  return rid[:, None] + offsets


def slice_gather_plain(stack: Tensor, rid: Tensor, *, w: int) -> Tensor:
  """B5's plain version: ``s[rid] + s[rid + 1] + s[rid + w + 1] +
  s[rid + w + 2]`` added in f32 in that order, rounded once to bf16."""
  taps = stack[slice_rows(rid, stack.shape[0], w)].float()  # [N, 4, C]
  total = taps[:, 0] + taps[:, 1] + taps[:, 2] + taps[:, 3]
  return total.to(stack.dtype)


def slice_gather(stack: Tensor, rid: Tensor, *, w: int) -> Tensor:
  """B5: ``[N, C]`` bf16 tap sums of the flat stack ``[R (w + 1), C]`` at
  the row ids ``rid [N]`` (int32, ``r0 (w + 1) + c0``)."""
  if kernels.on_card(stack, 'slice_gather'):
    return kernels.slice_gather(stack, rid, w=w)
  return slice_gather_plain(stack, rid, w=w)


def table_gather_plain(table: Tensor, ids: Tensor) -> Tensor:
  """B6's plain version: ``table[ids]``, ids clamped to the table's rows."""
  return table[ids.long().clamp(0, table.shape[0] - 1)]


def table_gather(table: Tensor, ids: Tensor) -> Tensor:
  """B6: ``[N, D]`` rows of ``table [rows, D]`` f32 at ``ids [N]`` int32."""
  if kernels.on_card(table, 'table_gather'):
    return kernels.table_gather(table, ids)
  return table_gather_plain(table, ids)
