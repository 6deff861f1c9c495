"""K3 (``lift_topk_bwd``) of two trees on one card, in turns.

The other tree's kernels (``--parent``: a checkout's root, whose
``snap_tpu_torch/ops/kernels.py`` is loaded beside this tree's and builds
its own library under its own ``build/``) and this tree's are timed in
turns (parent, change, change, parent) on the inputs that one training step
gives K3 in the map's lift (batch 2, bf16) of the flagship
(``train_full1chip_exhaustive``) and of ``chip_smoke.py`` phase 7j's stream
with the max and min and scan unweighted, and on phase 3's seeded B8 inputs
in bf16. Per row and turn: ms per call (CUDA events over 20 calls), device
ms per launch stage (``torch.profiler``), the call's own peak memory, and
the ranks stage's registers, spills and blocks per SM; per row the change's
largest difference from the parent, its check against the plain version
(``chip_smoke.check_lift_bwd``) and the host and device cost of the count of
selected ranks that the autograd function keeps for K3; first, the SASS
loops of both trees' ranks stage in bf16 (``chip_smoke.SASS_LOOPS``).
Card only:

    python3 tests/torch_k3_ab.py --parent checkout_check/parent

One JSON line per row on stdout and in ``--out``. ``tests/torch_k1_ab.py``
times K1 the same way, with this script's capture and set-up.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import inspect
import json
import pathlib
import shutil
import sys
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from snap_tpu_torch import configs  # noqa: E402
from snap_tpu_torch import evaluate  # noqa: E402
from snap_tpu_torch import train  # noqa: E402
from snap_tpu_torch.ops import kernels  # noqa: E402
from snap_tpu_torch.ops import view_scan  # noqa: E402

# Both trees' stages: the parent's lack those it did not launch.
STAGES = chip_smoke.K3_STAGES
ROWS = {
    'flagship': None,
    'stream_minmax': 'stream, [mean, var, max, min, score_max]',
    'scan_unweighted': 'scan, unweighted [mean, var]',
}


def load_parent(root: pathlib.Path):
  """The other tree's ``ops/kernels.py`` as a module of its own."""
  path = root / 'snap_tpu_torch' / 'ops' / 'kernels.py'
  spec = importlib.util.spec_from_file_location('parent_kernels', path)
  module = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(module)
  return module


def step_inputs(row: str, names=('lift_topk_bwd',)):
  """The largest inputs (args, kwargs) that each wrapper of ``kernels`` in
  ``names`` is given in the map's lift of one training step of ``row``."""
  config = configs.train_full1chip_exhaustive()
  if ROWS[row] is not None:
    config = chip_smoke.with_lift_form(config, ROWS[row])
  model = evaluate.build_model(config, 'cuda', 0)
  workdir = chip_smoke.fresh_workdir(f'ab_{row}')
  with contextlib.ExitStack() as stack:
    captures = [stack.enter_context(chip_smoke.Capture(kernels, name, 0))
                for name in names]
    train.train(config, 1, 'cuda', seed=0, model=model, workdir=str(workdir))
  shutil.rmtree(workdir)
  del model
  out = [capture.largest() for capture in captures]
  for capture in captures:
    capture.calls.clear()
  torch.cuda.empty_cache()
  return out


def own_peak_gib(fn) -> float:
  """The peak memory that one call of ``fn`` adds, in GiB."""
  torch.cuda.synchronize()
  torch.cuda.empty_cache()
  base = torch.cuda.memory_allocated()
  torch.cuda.reset_peak_memory_stats()
  out = fn()
  torch.cuda.synchronize()
  del out
  return (torch.cuda.max_memory_allocated() - base) / 2**30


def call(module, args, kw):
  """K3 of ``module`` with the count of selected ranks passed where its
  wrapper takes one (as the autograd function passes it)."""
  kw = {k: v for k, v in kw.items() if k != 'selected'}
  if 'selected' in inspect.signature(module.lift_topk_bwd).parameters:
    kw['selected'] = int(args[3].sum())
  return lambda: module.lift_topk_bwd(*args, **kw)


def turn(module, args, kw):
  fn = call(module, args, kw)
  peak_gib = own_peak_gib(fn)
  ranks = [o for o in module.occupancy('lift_topk_bwd')
           if 'ranks' in o['name']]
  return dict(ms=chip_smoke.time_ms(fn),
              stages=chip_smoke.kernel_stages_ms(fn, STAGES),
              peak_gib=peak_gib,
              ranks=[{k: o[k] for k in ('name', 'registers', 'local_bytes',
                                        'blocks_per_sm')} for o in ranks])


def selected_count_cost(select, iters: int = 50):
  """What the autograd function adds to a lift's forward to size K3's
  scratch (``view_scan._SelectedCount``: ``select.sum()``, its copy to
  pinned memory and an event): host us per call (the host's clock over
  ``iters`` calls) and device ms per call (CUDA events, the calls queued
  behind a spin of the card)."""
  kept = []

  def fn():
    kept.append(view_scan._SelectedCount(select))

  fn()
  torch.cuda.synchronize()
  start = time.perf_counter()
  for _ in range(iters):
    fn()
  host_us = (time.perf_counter() - start) / iters * 1e6
  torch.cuda.synchronize()
  return dict(host_us=host_us,
              device_ms=chip_smoke.time_ms(fn, iters=iters, spin=True))


def compare(name, parent, args, kw, check=True):
  args = (*args[:-1], chip_smoke.unit_cotangent(args[-1]))
  diff = float((call(parent, args, kw)().float()
                - call(kernels, args, kw)().float()).abs().max())
  err = (chip_smoke.check_lift_bwd(args, kw, chip_smoke.PLAIN_LIFT_CHUNK,
                                   chip_smoke.B8_BWD_F32_TOL
                                   if args[0].dtype == torch.float32 else None)
         if check else None)
  turns = [(label, turn(module, args, kw)) for label, module in (
      ('parent', parent), ('change', kernels), ('change', kernels),
      ('parent', parent))]
  return dict(row=name, stack=list(args[0].shape), ranks=list(args[1].shape),
              selected=int(args[3].sum()), layout=chip_smoke.lift_layout(
                  args[0], kw), max_diff_vs_parent=diff,
              max_abs_err_vs_plain=err,
              selected_count=selected_count_cost(args[3]), turns=turns)


def start(default_out: str):
  """Parses ``--parent`` and ``--out``, loads both trees' kernel libraries
  and returns the parent's module and ``emit``, which prints a row as a
  JSON line beside the card's name and power limit and rewrites ``--out``
  with every row so far; None where no card is present."""
  parser = argparse.ArgumentParser()
  parser.add_argument('--parent', required=True)
  parser.add_argument('--out', default=default_out)
  opts = parser.parse_args()
  if not torch.cuda.is_available():
    print(f'{pathlib.Path(sys.argv[0]).stem}: needs a CUDA card',
          file=sys.stderr)
    return None
  parent = load_parent(pathlib.Path(opts.parent).resolve())
  parent.load_library()
  kernels.load_library()
  out = pathlib.Path(opts.out)
  out.parent.mkdir(parents=True, exist_ok=True)
  smi = chip_smoke.subprocess.run(
      ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
      capture_output=True, text=True, timeout=60, check=True).stdout.strip()
  results = []

  def emit(result):
    result['card'] = smi
    results.append(result)
    print(json.dumps(result), flush=True)
    out.write_text('\n'.join(json.dumps(r) for r in results) + '\n')

  torch.backends.cuda.matmul.allow_tf32 = False
  return parent, emit


def main() -> int:
  started = start('chiprun_out/k3_ab.json')
  if started is None:
    return 1
  parent, emit = started
  emit({'row': 'SASS loops of the ranks stage (instructions, of them '
               'outside nested loops)', **{
                   label: {'parent': chip_smoke.sass_loops(
                       name, parent.library_path()),
                           'change': chip_smoke.sass_loops(name)}
                   for label, name in chip_smoke.SASS_LOOPS
                   if 'ranks_kernel bf16' in label}})
  with torch.no_grad():
    for name, weighted, use_variance, add_minmax, ranks, n in (
        chip_smoke.B8_SEEDED):
      args, g_stats, kw = chip_smoke.seeded_lift_inputs(
          'cuda', torch.bfloat16, weighted, use_variance, add_minmax, ranks, n)
      emit(compare(f'seeded {name}', parent, (*args, g_stats), kw))
      del args, g_stats
  for row in ROWS:
    (args, kw), = step_inputs(row)
    with torch.no_grad():
      emit(compare(row, parent, args, kw))
    del args
    torch.cuda.empty_cache()
  return 0


if __name__ == '__main__':
  sys.exit(main())
