"""B7 (``pose_scoring_bwd``) of several trees on one card, in turns.

Each tree is a checkout's root (its own ``snap_tpu_torch/``, loaded as
``tests/torch_k3_ab.py:load_parent`` loads a parent, building its own
library under its own ``build/``), for instance a copy of this tree with
one part of the kernel changed or cut out. Beside this tree's kernels, each
is timed on the B7 call of one ``train_full1chip_ransac`` step (as
``tests/torch_b7_ab.py`` captures it) and on ``chip_smoke.py`` phase 3's
seeded inputs (mask off), in two rounds of turns: ms per call (CUDA events
over 20 calls), registers, local bytes, blocks per SM and dynamic shared
memory of the summing kernel, and whether its output equals this tree's
bit for bit. Card only:

    python3 tests/torch_b7_trees.py checkout_check/parent <tree> ...

One JSON line per tree and round on stdout.
"""

from __future__ import annotations

import json
import pathlib
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
import torch_b7_ab  # noqa: E402
import torch_k3_ab  # noqa: E402
from snap_tpu_torch.ops import kernels  # noqa: E402


def main() -> int:
  if not torch.cuda.is_available():
    print('torch_b7_trees: needs a CUDA card', file=sys.stderr)
    return 1
  trees = {'change': kernels}
  for root in sys.argv[1:]:
    trees[root] = torch_k3_ab.load_parent(pathlib.Path(root).resolve())
  for module in trees.values():
    module.load_library()
  args, kw = torch_b7_ab.captured_call()
  args = (chip_smoke.unit_cotangent(args[0]), *args[1:])
  seeded, seeded_kw = chip_smoke.seeded_pose_scoring_bwd_inputs('cuda', False)
  seeded = (chip_smoke.unit_cotangent(seeded[0]), *seeded[1:])
  with torch.no_grad():
    want = kernels.pose_scoring_bwd(*args, **kw)
    for turn in range(2):
      for name, module in trees.items():
        same = bool(torch.equal(module.pose_scoring_bwd(*args, **kw), want))
        ms = chip_smoke.time_ms(lambda: module.pose_scoring_bwd(*args, **kw))
        seeded_ms = chip_smoke.time_ms(
            lambda: module.pose_scoring_bwd(*seeded, **seeded_kw))
        summing = module.occupancy('pose_scoring_bwd')[-1]
        print(json.dumps(dict(
            tree=name, round=turn, train_ms=ms, seeded_ms=seeded_ms,
            equal_to_change=same, **{k: summing[k] for k in (
                'registers', 'local_bytes', 'blocks_per_sm',
                'dynamic_smem')})), flush=True)
  return 0


if __name__ == '__main__':
  sys.exit(main())
