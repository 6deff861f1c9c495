"""Where a head's training step goes, at full width on one NVIDIA GPU.

    python tests/torch_head_steps.py --steps=10 --out=chiprun_out/head_steps

Trains ``train_semantics`` and ``train_occupancy`` (``scale=full``: batch
1, bf16) warm-started from a seeded JAX-format export of the flagship run,
and the localizer with the semantic modality
(``train_full1chip_exhaustive:modalities=streetview+aerial+semantic``,
batch 2), ``--steps`` steps each with the trainer's trace of steps 4-8
(``torch.profiler``: the device's busy time and idle share over them) and
its per-op profile of the last step, an eval of 1 batch and no checkpoint.
Prints one JSON line per run (the steps' ms, the trace's split, the peak
memory, the card's name and power limit) and writes each per-op table to
``<out>/<config>.txt``. Not a test: a measurement for the record (PERF.md).
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


def main(argv=None) -> None:
  parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  parser.add_argument('--steps', type=int, default=10)
  parser.add_argument('--out', default=str(REPO / 'chiprun_out' /
                                           'head_steps'))
  args = parser.parse_args(argv)
  import torch  # pylint: disable=g-import-not-at-top
  import chip_smoke  # pylint: disable=g-import-not-at-top
  from snap_tpu_torch import configs  # pylint: disable=g-import-not-at-top
  from snap_tpu_torch import train  # pylint: disable=g-import-not-at-top
  if not torch.cuda.is_available():
    raise SystemExit('needs a CUDA card')
  smi = subprocess.run(
      ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
      capture_output=True, text=True, timeout=60, check=True).stdout.strip()
  out = pathlib.Path(args.out)
  out.mkdir(parents=True, exist_ok=True)
  workdirs = REPO / 'workdirs'
  export = workdirs / 'head_steps_export'
  shutil.rmtree(export, ignore_errors=True)
  chip_smoke.write_seeded_export(export, seed=1, step=12_500)
  for name in (f'train_semantics:pretrained_mapper={export}',
               f'train_occupancy:pretrained_mapper={export}',
               'train_full1chip_exhaustive:modalities='
               'streetview+aerial+semantic'):
    config = configs.get_config(name)
    config = dataclasses.replace(config, train=dataclasses.replace(
        config.train, steps_per_eval=1, checkpoint=False))
    short = configs.parse_config_name(name)[0]
    workdir = workdirs / f'head_steps_{short}'
    shutil.rmtree(workdir, ignore_errors=True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    result = train.train(config, None, 'cuda', 0, workdir=str(workdir),
                         stop_at_step=args.steps, profile=True)
    (out / f'{short}.txt').write_text(result['profile'])
    print(json.dumps({
        'config': name if 'modalities' in name else short,
        'batch_size': config.batch_size, 'dtype': config.dtype_str,
        'step_ms': [1e3 * t for t in result['step_seconds']],
        'wall_ms': [1e3 * t for t in result['wall_seconds']],
        'trace': {k: v for k, v in (result['trace'] or {}).items()
                  if k != 'path'},
        'peak_gib': (torch.cuda.max_memory_allocated() - resident) / 2**30,
        'device': smi}), flush=True)
    del result
    shutil.rmtree(workdir)
  shutil.rmtree(export)


if __name__ == '__main__':
  main()
