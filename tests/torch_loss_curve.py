"""The smoke trainer's loss curve in both packages, on the CPU.

    JAX_PLATFORMS=cpu python tests/torch_loss_curve.py --steps=300 \\
        --window=50

Trains ``smoke_localization.py:pose_backend=exhaustive`` at batch 2 with
the JAX trainer (``snap_tpu/train_lib/trainer.py``) and the port's
``smoke_train_exhaustive`` with ``snap_tpu_torch.train`` for ``--steps``
steps each from their own seeded weights, checkpoints off, a summary every
``--window`` steps, and prints one JSON line: each package's mean training
loss per window (the first window's and the last one's are what
``chip_smoke.py`` holds the card to: the last must lie below the first).
Not a test: a long run for the record (PERF.md).
"""

import argparse
import dataclasses
import json
import os
import pathlib
import sys
import tempfile

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))


def jax_curve(steps: int, window: int, workdir: str):
  import jax  # pylint: disable=g-import-not-at-top
  from snap_tpu import models
  from snap_tpu.configs import smoke_localization
  from snap_tpu.data import loader as jloader
  from snap_tpu.parallel import mesh as mesh_lib
  from snap_tpu.train_lib import trainer as jtrainer

  cfg = smoke_localization.get_config('pose_backend=exhaustive')
  cfg.batch_size = 2
  cfg.num_training_steps = steps
  cfg.log_summary_steps = window
  cfg.log_eval_steps = steps
  cfg.checkpoint = False
  cfg.xprof = False
  mesh = mesh_lib.make_mesh({'data': 1, 'model': 1})
  dataset = jloader.get_dataset(batch_size=2, eval_batch_size=None,
                                dataset_configs=cfg.data, mesh=mesh,
                                shuffle_seed=cfg.shuffle_seed)

  class Writer:
    def __init__(self):
      self.loss = {}

    def write_scalars(self, step, scalars):
      if 'train/loss/total' in scalars:
        self.loss[int(step)] = float(scalars['train/loss/total'])

  writer = Writer()
  jtrainer.train(rng=jax.random.PRNGKey(cfg.rng_seed), config=cfg,
                 model_cls=models.get_model(cfg.model_name), dataset=dataset,
                 workdir=workdir, writer=writer, mesh=mesh)
  return writer.loss


def port_curve(steps: int, window: int, workdir: str):
  import torch  # pylint: disable=g-import-not-at-top
  from snap_tpu_torch import configs
  from snap_tpu_torch import train

  torch.set_num_threads(4)
  cfg = configs.smoke_train_exhaustive()
  cfg = dataclasses.replace(cfg, train=dataclasses.replace(
      cfg.train, num_training_steps=steps, log_summary_steps=window,
      log_eval_steps=steps, checkpoint=False, xprof=False))
  result = train.train(cfg, None, 'cpu', 0, workdir=workdir)
  return {step: s['loss/total'] for step, s in result['summaries'].items()}


def main() -> None:
  parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  parser.add_argument('--steps', type=int, default=300)
  parser.add_argument('--window', type=int, default=50)
  args = parser.parse_args()
  os.environ.setdefault('JAX_PLATFORMS', 'cpu')
  with tempfile.TemporaryDirectory() as tmp:
    curves = {'jax': jax_curve(args.steps, args.window, tmp + '/jax'),
              'port': port_curve(args.steps, args.window, tmp + '/port')}
  out = {name: {'window_means': curve,
                'first': curve[min(curve)], 'last': curve[max(curve)]}
         for name, curve in curves.items()}
  print(json.dumps({'steps': args.steps, 'window': args.window, **out}))


if __name__ == '__main__':
  main()
