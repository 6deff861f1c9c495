"""K1 (``lift_topk_fwd``) of two trees on one card, in turns.

As ``tests/torch_k3_ab.py`` does for K3, with its capture and set-up: the
other tree's kernels (``--parent``: a checkout's root, whose
``snap_tpu_torch/ops/kernels.py`` is loaded beside this tree's and builds
its own library under its own ``build/``) and this tree's are timed in
turns (parent, change, change, parent) on the inputs that one training step
gives K1 in the map's lift (batch 2, bf16) of the flagship
(``train_full1chip_exhaustive``) and of ``chip_smoke.py`` phase 7j's stream
with the max and min and scan unweighted, on the flagship's f32 input of one
``eval_full1chip_ransac`` batch (batch 4), and on phase 3's seeded B8 inputs
in bf16 and f32. Per row and turn: ms per call (CUDA events over 20 calls),
the kernel's registers, local bytes (spills, stack) and blocks per SM, and
the call's own peak memory; per row the change's check against the plain
version (``chip_smoke.check_lift``), the number of stats entries whose bits
differ from the parent's, per part of the row, and, on the step rows, K3 of
both trees in turns on the same step's inputs. Card only:

    python3 tests/torch_k1_ab.py --parent checkout_check/parent

One JSON line per row on stdout and in ``--out``.
"""

from __future__ import annotations

import pathlib
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
import torch_k3_ab  # noqa: E402
from snap_tpu_torch import configs  # noqa: E402
from snap_tpu_torch import evaluate  # noqa: E402
from snap_tpu_torch.ops import kernels  # noqa: E402


def ransac_inputs():
  """K1's inputs in the map's lift of one ``eval_full1chip_ransac`` batch
  (batch 4, f32)."""
  model = evaluate.build_model(configs.eval_full1chip_ransac(), 'cuda', 0)
  with chip_smoke.Capture(kernels, 'lift_topk_fwd', 0) as fwd:
    evaluate.evaluate('eval_full1chip_ransac', 4, 'cuda', seed=0,
                      batch_size=4, model=model)
  del model
  out = fwd.largest()
  fwd.calls.clear()
  torch.cuda.empty_cache()
  return out


def turn(module, args, kw):
  fn = lambda: module.lift_topk_fwd(*args, **kw)
  peak_gib = torch_k3_ab.own_peak_gib(fn)
  launch, = module.occupancy('lift_topk_fwd')
  return dict(ms=chip_smoke.time_ms(fn), peak_gib=peak_gib,
              **{k: launch[k] for k in ('registers', 'local_bytes',
                                        'blocks_per_sm')})


def k3_turns(parent, args, kw):
  """K3 of both trees in turns on one step's inputs (ms per call)."""
  args = (*args[:-1], chip_smoke.unit_cotangent(args[-1]))
  return [(label, chip_smoke.time_ms(torch_k3_ab.call(module, args, kw)))
          for label, module in (('parent', parent), ('change', kernels),
                                ('change', kernels), ('parent', parent))]


def differing(stats, stats_p, args, kw):
  """Per part of the stats row (``chip_smoke.lift_layout``'s names), the
  entries whose bits differ between the two trees' stats."""
  dim = kw['dim']
  names = chip_smoke.lift_layout(args[0], kw)[1:-1].split(', ')
  bits = torch.int16 if stats.dtype == torch.bfloat16 else torch.int32
  differ = stats.view(bits) != stats_p.view(bits)
  return {name: int(differ[..., i * dim:(i + 1) * dim].sum())
          for i, name in enumerate(names)}


def compare(name, parent, args, kw, bwd=None):
  stats_p, valid_p = parent.lift_topk_fwd(*args, **kw)
  stats, valid = kernels.lift_topk_fwd(*args, **kw)
  torch.cuda.synchronize()
  differ = differing(stats, stats_p, args, kw)
  same_valid = bool(torch.equal(valid, valid_p))
  del stats, valid, stats_p, valid_p
  err = chip_smoke.check_lift(args, kw, chip_smoke.PLAIN_LIFT_CHUNK)
  turns = [(label, turn(module, args, kw)) for label, module in (
      ('parent', parent), ('change', kernels), ('change', kernels),
      ('parent', parent))]
  result = dict(row=name, stack=list(args[0].shape), dtype=str(args[0].dtype),
                ranks=list(args[1].shape), selected=int(args[3].sum()),
                layout=chip_smoke.lift_layout(args[0], kw),
                stats_differing_from_parent=differ,
                valid_same_as_parent=same_valid, max_abs_err_vs_plain=err,
                turns=turns)
  if bwd is not None:
    result['k3_turns'] = k3_turns(parent, *bwd)
  return result


def main() -> int:
  started = torch_k3_ab.start('chiprun_out/k1_ab.json')
  if started is None:
    return 1
  parent, emit = started
  with torch.no_grad():
    for name, weighted, use_variance, add_minmax, ranks, n in (
        chip_smoke.B8_SEEDED):
      for dtype in (torch.bfloat16, torch.float32):
        args, _, kw = chip_smoke.seeded_lift_inputs(
            'cuda', dtype, weighted, use_variance, add_minmax, ranks, n)
        emit(compare(f'seeded {name}', parent, args, kw))
        del args
  for row in torch_k3_ab.ROWS:
    fwd, bwd = torch_k3_ab.step_inputs(row, ('lift_topk_fwd', 'lift_topk_bwd'))
    with torch.no_grad():
      emit(compare(row, parent, *fwd, bwd=bwd))
    del fwd, bwd
    torch.cuda.empty_cache()
  with torch.no_grad():
    emit(compare('flagship_f32', parent, *ransac_inputs()))
  return 0


if __name__ == '__main__':
  sys.exit(main())
