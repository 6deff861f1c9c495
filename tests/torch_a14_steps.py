"""Where a training step of the mapper options goes, at full width on one
NVIDIA GPU, beside the flagship's.

    python tests/torch_a14_steps.py --steps=10 --out=chiprun_out/a14_steps

Trains, each in a process of its own (a profiler in the process slows the
host-bound steps that follow it), the flagship
(``train_full1chip_exhaustive``: batch 2, bf16, seeded weights), the
aerial-only map with its own street-view query mapper
(``modalities=aerial``), the flagship with ``bev_net=1``, the same with
``add_confidence_query``, and the flagship again, ``--steps`` steps each
with the trainer's trace of steps 4-8 (``torch.profiler``: the device's
busy time and idle share over them) and its per-op profile of the last
step, an eval of 1 batch and no checkpoint. Prints one JSON line per run
(the steps' ms, the trace's split, the peak memory, the card's name and
power limit) and writes each per-op table to ``<out>/<run>.txt``. Not a
test: a measurement for the record (PERF.md).
"""

import argparse
import dataclasses
import json
import pathlib
import shutil
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

# (run name, config, add_confidence_query), in the order they run.
RUNS = (
    ('flagship', 'train_full1chip_exhaustive', False),
    ('aerial', 'train_full1chip_exhaustive:modalities=aerial', False),
    ('bev_net', 'train_full1chip_exhaustive:bev_net=1', False),
    ('bev_net_confidence', 'train_full1chip_exhaustive:bev_net=1', True),
    ('flagship_again', 'train_full1chip_exhaustive', False),
)


def run_one(name: str, spec: str, confidence: bool, steps: int,
            out: pathlib.Path) -> None:
  import torch  # pylint: disable=g-import-not-at-top
  from snap_tpu_torch import configs  # pylint: disable=g-import-not-at-top
  from snap_tpu_torch import train  # pylint: disable=g-import-not-at-top
  if not torch.cuda.is_available():
    raise SystemExit('needs a CUDA card')
  smi = subprocess.run(
      ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
      capture_output=True, text=True, timeout=60, check=True).stdout.strip()
  config = configs.get_config(spec)
  if confidence:
    config = configs.merge(config, {'model': {'add_confidence_query': True}})
  config = dataclasses.replace(config, train=dataclasses.replace(
      config.train, steps_per_eval=1, checkpoint=False))
  workdir = REPO / 'workdirs' / f'a14_steps_{name}'
  shutil.rmtree(workdir, ignore_errors=True)
  result = train.train(config, None, 'cuda', 0, workdir=str(workdir),
                       stop_at_step=steps, profile=True)
  (out / f'{name}.txt').write_text(result['profile'])
  print(json.dumps({
      'run': name, 'config': spec, 'add_confidence_query': confidence,
      'batch_size': config.batch_size, 'dtype': config.dtype_str,
      'step_ms': [1e3 * t for t in result['step_seconds']],
      'wall_ms': [1e3 * t for t in result['wall_seconds']],
      'trace': {k: v for k, v in (result['trace'] or {}).items()
                if k != 'path'},
      'peak_gib': torch.cuda.max_memory_allocated() / 2**30,
      'device': smi}), flush=True)
  shutil.rmtree(workdir)


def main(argv=None) -> None:
  parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  parser.add_argument('--steps', type=int, default=10)
  parser.add_argument('--out', default=str(REPO / 'chiprun_out' /
                                           'a14_steps'))
  parser.add_argument('--run', default=None,
                      help='one run of RUNS, in this process')
  args = parser.parse_args(argv)
  out = pathlib.Path(args.out)
  out.mkdir(parents=True, exist_ok=True)
  if args.run is not None:
    name, spec, confidence = next(r for r in RUNS if r[0] == args.run)
    run_one(name, spec, confidence, args.steps, out)
    return
  for name, _, _ in RUNS:
    subprocess.run([sys.executable, __file__, f'--steps={args.steps}',
                    f'--out={out}', f'--run={name}'], check=True)


if __name__ == '__main__':
  main()
