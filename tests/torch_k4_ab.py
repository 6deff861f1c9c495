"""K4 (``patch_sample_2d_bwd``) of two trees on one card, in turns.

The other tree's kernels (``--parent``: a checkout's root, as
``tests/torch_k3_ab.py`` takes it) and this tree's are timed in turns
(parent, change, change, parent) on the input that one training step of
the flagship (``train_full1chip_exhaustive``, batch 2, bf16) gives K4 (the
templates' gradient to the query BEV), and on ``chip_smoke.py`` phase 3's
seeded inputs in bf16 and f16. Per row and turn: ms per call (CUDA events
over 20 calls, and with the launches queued behind a spin of the card),
device ms per launch stage (``torch.profiler``) and the call's own peak
memory; per row the change's largest difference from the parent, its
check against the plain version (``chip_smoke.check_sample_bwd``), the
entries of ten calls of the change that differ from its first (0: the
fixed order), and ``grid_sampler_2d_backward`` on the same function, the
library call K4 must stay faster than. Card only:

    python3 tests/torch_k4_ab.py --parent checkout_check/parent

One JSON line per row on stdout and in ``--out``.
"""

from __future__ import annotations

import functools
import pathlib
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / 'tests'))

import chip_smoke  # noqa: E402
import torch_k3_ab  # noqa: E402
from snap_tpu_torch.ops import kernels  # noqa: E402


def turn(module, args, kw):
  fn = functools.partial(module.patch_sample_2d_bwd, *args, **kw)
  return dict(ms=chip_smoke.time_ms(fn),
              spin_ms=chip_smoke.time_ms(fn, spin=True),
              stages=chip_smoke.kernel_stages_ms(fn, chip_smoke.K4_STAGES),
              peak_gib=torch_k3_ab.own_peak_gib(fn))


def repeat_differences(args, kw, calls: int = chip_smoke.REPEAT_CALLS):
  """The entries of each of ``calls`` - 1 later calls of this tree's K4
  whose bits differ from the first call's."""
  first = kernels.patch_sample_2d_bwd(*args, **kw)
  bits = {2: torch.int16, 4: torch.int32}[first.element_size()]
  return [int((kernels.patch_sample_2d_bwd(*args, **kw).view(bits)
               != first.view(bits)).sum()) for _ in range(calls - 1)]


def compare(name, parent, args, kw):
  args = (chip_smoke.unit_cotangent(args[0]), *args[1:])
  diff = float((parent.patch_sample_2d_bwd(*args, **kw).float()
                - kernels.patch_sample_2d_bwd(*args, **kw).float()
                ).abs().max())
  turns = [(label, turn(module, args, kw)) for label, module in (
      ('parent', parent), ('change', kernels), ('change', kernels),
      ('parent', parent))]
  library = chip_smoke.grid_sample_bwd_call(*args, kw['plane_shape'])
  return dict(row=name, g_values=list(args[0].shape),
              dtype=str(args[0].dtype), plane=list(kw['plane_shape']),
              max_diff_vs_parent=diff,
              max_abs_err_vs_plain=chip_smoke.check_sample_bwd(args, kw),
              repeat_differences=repeat_differences(args, kw),
              grid_sampler_2d_backward_ms=chip_smoke.time_ms(library),
              grid_sampler_2d_backward_spin_ms=chip_smoke.time_ms(
                  library, spin=True),
              turns=turns)


def main() -> int:
  started = torch_k3_ab.start('workdirs/k4_ab.json')
  if started is None:
    return 1
  parent, emit = started
  with torch.no_grad():
    for dtype in (torch.bfloat16, torch.float16):
      *_, sample_bwd = chip_smoke.seeded_kernel_inputs('cuda', dtype)
      emit(compare(f'seeded {str(dtype)[6:]}', parent, *sample_bwd))
      del sample_bwd
  (args, kw), = torch_k3_ab.step_inputs('flagship', ('patch_sample_2d_bwd',))
  with torch.no_grad():
    emit(compare('flagship', parent, args, kw))
  return 0


if __name__ == '__main__':
  sys.exit(main())
