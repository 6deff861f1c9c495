"""The occupancy head on trained and on seeded mapper weights, on one
NVIDIA GPU: the reference's ``results/run_occ_head_r5b`` and its control.

    python tests/test_torch_recall.py --export weights/loc_full1chip_r5
    python tests/torch_occupancy_transfer.py --steps=1000

(the first where JAX runs; the second on the card.) Trains
``train_occupancy:scale=small,batch_size=4`` (4,000 lidar rays a scene, lr
2e-4; an eval of 8 batches at eval batch 2 every 500 steps and at the last
step) for ``--steps`` steps on the frozen street-view encoder of
``weights/loc_full1chip_r5`` (the trained arm) and of a seeded JAX-format
export of the same architecture (the control arm), from the same head
weights and the same card-made batches. Prints one JSON line per arm (the
eval metrics at each eval step, the last train summary, the step ms and
the peak memory) and a last one with both arms' final held-out accuracy and
BCE and the card's name and power limit. Not a test: a long run for the
record (PERF.md).
"""

import argparse
import json
import pathlib
import shutil
import subprocess
import sys
import time

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))


def arm(name: str, export: pathlib.Path, steps: int, workdir: pathlib.Path):
  import torch  # pylint: disable=g-import-not-at-top
  from snap_tpu_torch import configs
  from snap_tpu_torch import train

  config = configs.get_config(
      f'train_occupancy:scale=small,batch_size=4,pretrained_mapper={export}')
  shutil.rmtree(workdir, ignore_errors=True)
  torch.cuda.reset_peak_memory_stats()
  t0 = time.perf_counter()
  result = train.train(config, None, 'cuda', 0, workdir=str(workdir),
                       stop_at_step=steps)
  seconds = time.perf_counter() - t0
  ms = [1e3 * t for t in result['step_seconds']]
  shutil.rmtree(workdir)
  return {
      'arm': name, 'export': str(export), 'steps': steps,
      'evals': {str(k): v for k, v in result['evals'].items()},
      'train_summary': result['train_summary'],
      'median_step_ms': sorted(ms)[len(ms) // 2],
      'mean_step_ms_after_first': sum(ms[1:]) / max(len(ms) - 1, 1),
      'seconds': seconds,
      'peak_gib': torch.cuda.max_memory_allocated() / 2**30,
      'generator_kind': result['generator_kind'],
  }


def main(argv=None) -> None:
  parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  parser.add_argument('--steps', type=int, default=1000)
  parser.add_argument('--trained', default=str(REPO / 'weights' /
                                               'loc_full1chip_r5'))
  args = parser.parse_args(argv)
  import torch  # pylint: disable=g-import-not-at-top
  import chip_smoke  # pylint: disable=g-import-not-at-top
  if not torch.cuda.is_available():
    raise SystemExit('needs a CUDA card')
  smi = subprocess.run(
      ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
      capture_output=True, text=True, timeout=60, check=True).stdout.strip()
  workdirs = REPO / 'workdirs'
  seeded = workdirs / 'occupancy_control_export'
  shutil.rmtree(seeded, ignore_errors=True)
  chip_smoke.write_seeded_export(seeded, seed=1, step=12_500)
  final = {}
  for name, export in (('trained', pathlib.Path(args.trained)),
                       ('seeded', seeded)):
    out = arm(name, export, args.steps, workdirs / f'occupancy_{name}')
    print(json.dumps(out), flush=True)
    last = out['evals'][str(args.steps)]
    final[name] = {'accuracy': last['occupancy/accuracy'],
                   'bce': last['loss/occupancy_bce']}
  shutil.rmtree(seeded)
  print(json.dumps({'final_eval': final, 'margin_points': 100 * (
      final['trained']['accuracy'] - final['seeded']['accuracy']),
                    'device': smi}), flush=True)


if __name__ == '__main__':
  main()
