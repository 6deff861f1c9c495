"""Train the port's localizer (either pose backend) or a head on a frozen
mapper, in resumable chunks.

    python -m snap_tpu_torch.train --config=train_full1chip_exhaustive \\
        --workdir=workdirs/flagship --stop_at_step=500
    python -m snap_tpu_torch.train --config=train_full1chip_ransac \\
        --num_steps=3
    python -m snap_tpu_torch.train \\
        --config=train_full1chip_exhaustive:continue_step=12500,pretrained_mapper=weights/loc_full1chip_r5 \\
        --workdir=workdirs/continued
    python -m snap_tpu_torch.train --config=smoke_train_exhaustive \\
        --workdir=/tmp/smoke --stop_at_step=2 --device=cpu
    python -m snap_tpu_torch.train \\
        --config=train_localization:scale=small,pose_backend=exhaustive \\
        --workdir=workdirs/run_small --stop_at_step=2000
    python -m snap_tpu_torch.train \\
        --config=train_localization:scale=full1chip,pose_backend=exhaustive,image_encoder=R152x2 \\
        --num_steps=3
    python -m snap_tpu_torch.train \\
        --config=train_localization:scale=small,pose_backend=exhaustive,image_encoder=tiny,batch_size=1 \\
        --workdir=/tmp/small --stop_at_step=2 --device=cpu
    python -m snap_tpu_torch.train \\
        --config=train_occupancy:scale=small,pretrained_mapper=weights/loc_full1chip_r5 \\
        --workdir=workdirs/occupancy --stop_at_step=1000
    python -m snap_tpu_torch.train --config=smoke_semantics --num_steps=3 \\
        --device=cpu
    torchrun --nproc_per_node=2 -m snap_tpu_torch.train \\
        --config=train_full1chip_exhaustive:batch_size=4 --workdir=workdirs/dp

``train_localization`` is the reference's ``train_localization.py`` with
its arguments: ``image_encoder`` (the street-view trunk: ``R50``,
``R152x2`` through its third stage, ``R101``, ``R26`` or ``tiny``; R152x2 and
R101 rematerialize their units), ``scale`` (``full``: the paper's batch 32
and 400k steps, 200k for R152x2; ``full1chip``: batch 2 and the 20k
recipe; ``small``: the from-scratch recipe, 10 views of 90x120 at 0.4 m,
batch 8, 20k steps at lr 5e-4), ``pose_backend`` (``ransac``, its default,
or ``exhaustive``), ``modalities``, ``bev_net``, ``pretrained_resnet``,
``pretrained_mapper``, ``continue_step`` (``full1chip`` only),
``point_tile`` (read, no effect) and ``batch_size``.
``train_full1chip_exhaustive`` is the flagship run (dense pose volume),
``train_localization`` at ``scale=full1chip,pose_backend=exhaustive``;
``train_full1chip_ransac`` is the reference's default backend, whose loss
scores the step's sampled poses (B4) and backpropagates through their
scores (B7); ``smoke_train_exhaustive`` and ``smoke_train_ransac`` are
their tiny counterparts. ``train_semantics`` trains the semantic BEV head
and ``train_occupancy`` the lidar-supervised occupancy head on a frozen
mapper (``smoke_semantics``, ``smoke_occupancy``: tiny, nothing frozen);
the model is the registry's ``config.model_name``. ``--config`` takes the
config function's arguments after a colon, as the reference's does:
``continue_step``, ``pretrained_mapper`` (an experiment workdir: the
port's checkpoints, or a JAX export's ``params.npz`` + ``checkpoint.json``;
the heads adopt its mapper or street-view encoder), ``pretrained_resnet``
(a BiT ``.npz``), ``modalities`` (``streetview+aerial+semantic`` adds the
semantic rasters to the localizer's map; ``aerial[+semantic]`` is a map
without street views, whose query goes through a street-view mapper of its
own), ``bev_net`` (1: the residual stage over the map's fused plane),
``scale`` (the heads' ``small`` or ``full``) and ``batch_size``.

As ``snap_tpu/train.py`` does: writes ``<workdir>/config.json`` (the
reference's keys, with the data path the run takes); when the workdir
holds a checkpoint, folds its step into the data seed
(``utils/prng.resume_shuffle_seed``, the reference's threefry fold) and
starts the train iterator at that step; then hands off to
``train_lib.trainer.train``, which restores the checkpoint (or warm-starts
the pretrained modules), takes the steps, logs a summary and an eval at
the config's cadence and writes ``<workdir>/checkpoints/<step>/``.
``--stop_at_step`` ends the run at that absolute step without changing the
schedule; ``--num_steps`` takes at most that many steps in this call.
Weights are drawn from ``--seed`` on a fresh run. The batches are made on
the card when ``--device`` is a CUDA card, unless
``--on_device_generation=false``.

Prints one JSON line per step (loss, gradient and update norms, learning
rate; ``step`` counted from 0) and, at the end, one with the data path
(``generator_kind``), the step times, each batch's build time, the last
summary and eval, the checkpoints written (seconds, bytes), the restore's
seconds and the trace's split. Summaries and evals go to the log.
``--profile`` runs the last step under ``torch.profiler`` and prints its
per-op table, sorted by device time. The default device is ``cuda``; there
is no fallback to the CPU when no card is found.

Under ``torchrun`` each process is a rank of the config's mesh
(``parallel/mesh.py``: ``cuda:LOCAL_RANK`` and NCCL where each rank has a
card, the cards shared and gloo where there are fewer, gloo on the CPU),
``{data: D, model: M}`` with rank r at (r // M, r % M): each data rank
builds its block of every global batch (``batch_size`` is global and must
divide over the data ranks), the model axis splits the leaves that
``Config.tp_min_dim`` makes wide (``parallel/tensor.py:shard_model``), and
every rank takes the step one process would take on the global batch;
rank 0 alone writes ``config.json``, the checkpoints (full leaves) and
summaries and prints the JSON lines. A resumed run folds its step into the
data seed on every rank alike. For example, on the CPU,

    torchrun --nproc_per_node=2 -m snap_tpu_torch.train \
      --config=smoke_train_exhaustive:batch_size=4,mesh_data=1,mesh_model=2,tp_min_dim=16 \
      --device=cpu --workdir=/tmp/tp --stop_at_step=2
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import pathlib
from typing import Any, Callable, Dict, Optional, Union

from snap_tpu_torch import configs
from snap_tpu_torch import evaluate
from snap_tpu_torch.data import loader
from snap_tpu_torch.models import base
from snap_tpu_torch.parallel import mesh
from snap_tpu_torch.parallel import tensor
from snap_tpu_torch.train_lib import checkpoints
from snap_tpu_torch.train_lib import trainer
from snap_tpu_torch.utils import prng

WORKDIRS = pathlib.Path(__file__).resolve().parents[1] / 'workdirs'
log = logging.getLogger(__name__)


def config_save(workdir: pathlib.Path, record: Dict[str, Any]) -> None:
  (pathlib.Path(workdir) / 'config.json').write_text(
      json.dumps(record, indent=2, sort_keys=True) + '\n')


def train(config: Union[str, configs.Config] = 'train_full1chip_exhaustive',
          num_steps: Optional[int] = None, device: str = 'cuda',
          seed: int = 0, workdir: Optional[str] = None,
          model: Optional[base.Model] = None,
          on_step: Optional[Callable[[int, trainer.StepOutput], None]] = None,
          profile: bool = False,
          on_device_generation: Optional[bool] = None,
          stop_at_step: Optional[int] = None) -> Dict[str, Any]:
  """Train ``config`` (a config, or its name with arguments) in
  ``workdir`` (``workdirs/torch_<name>`` by default); returns the trainer's
  result with the data path and times.

  Batches come from the dataset's train iterator (``loader.get_dataset``),
  made on the card or on the host as ``on_device_generation`` says (None:
  on the card iff ``device`` is CUDA). The result holds per-step ``logs``,
  the wall time of each step (``step_seconds``, ending in a device
  synchronize) and of each step with the wait for its batch
  (``wall_seconds``), each batch's build time (``build_ms``: the host's ms
  in the build; ``build_card_ms``: the card's ms from CUDA events, None
  off the card), ``generator_kind``, the data seed (``shuffle_seed``,
  folded on a resume), the summaries, evals and checkpoints by step and
  the final ``TrainState``.
  """
  name = config if isinstance(config, str) else 'config'
  if isinstance(config, str):
    config = configs.get_config(config)
  if workdir is None:
    workdir = WORKDIRS / f'torch_{configs.parse_config_name(name)[0]}'
  workdir = pathlib.Path(workdir)
  workdir.mkdir(parents=True, exist_ok=True)
  axes = mesh.make_mesh(dataclasses.asdict(config.mesh))
  if mesh.active():
    mesh.setup(axes)
  record = configs.to_reference(config)
  lead = mesh.is_lead()
  if lead:
    config_save(workdir, record)
  data = dataclasses.replace(config.data,
                             on_device_generation=on_device_generation)
  start_step = (checkpoints.latest_step(workdir) if config.train.checkpoint
                else None) or 0
  if start_step:
    # A resumed run reads new examples, not the start of the stream again
    # (``snap_tpu/train.py:68-76``).
    log.info('Folding global_step %s into dataset seed.', start_step)
    data = dataclasses.replace(data, shuffle_seed=prng.resume_shuffle_seed(
        data.shuffle_seed, start_step))
  if model is None:
    model = evaluate.build_model(config, device, seed)
  sharded = tensor.shard_model(model, config.tp_min_dim)
  if sharded and lead:
    log.info('Sharded %d leaves (%d parameters a rank) over the model '
             'axis of %d ranks.', len(sharded), sum(
                 p.numel() for n, p in model.named_parameters()
                 if n in sharded), axes['model'])
  model.train()
  with loader.get_dataset(data, config.batch_size,
                          eval_batch_size=config.train.eval_batch_size,
                          device=device, start_step=start_step,
                          num_processes=axes['data']) as dataset:
    record['data_generator_kind'] = dataset.meta_data['generator_kind']
    if lead:
      config_save(workdir, record)
    result = trainer.train(config, model, dataset, workdir, seed=seed,
                           stop_at_step=stop_at_step, num_steps=num_steps,
                           on_step=on_step, profile=profile)
  builds = result.pop('builds')
  return {
      **result,
      'config': name,
      'device': str(device),
      'generator_kind': dataset.meta_data['generator_kind'],
      'shuffle_seed': data.shuffle_seed,
      'build_ms': [build.wall_ms for build in builds],
      'build_card_ms': [build.card_ms for build in builds],
      'workdir': str(workdir),
      'mesh': axes, 'rank': mesh.rank(), 'sharded': sharded,
  }


def main(argv=None) -> None:
  parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  parser.add_argument('--config', default='train_full1chip_exhaustive',
                      help='a config of snap_tpu_torch.configs.CONFIGS, '
                      'with its arguments after a colon (name:key=value,...)')
  parser.add_argument('--num_steps', type=int, default=None,
                      help='take at most this many steps in this call')
  parser.add_argument('--stop_at_step', type=int, default=None,
                      help='stop at this step (absolute), with a summary, '
                      'an eval and a checkpoint, keeping the schedule')
  parser.add_argument('--device', default='cuda')
  parser.add_argument('--seed', type=int, default=0)
  parser.add_argument('--workdir', default=None)
  parser.add_argument('--on_device_generation', default='auto',
                      choices=('auto', 'true', 'false'),
                      help='make the batches on the device (auto: iff it '
                      'is a CUDA card)')
  parser.add_argument('--profile', action='store_true',
                      help="print the last step's per-op profile")
  args = parser.parse_args(argv)
  logging.basicConfig(level=logging.INFO)
  process = mesh.init(args.device)
  try:
    _main(args, process)
  finally:
    mesh.shutdown()


def _main(args, process: mesh.Process) -> None:
  lead = process.rank == 0

  def print_step(step: int, out: trainer.StepOutput) -> None:
    if not lead:
      return
    line = {'step': step, **out.logs,
            **{k: v for k, v in trainer.summarize([out.metrics]).items()
               if k.startswith('loss/')}}
    print(json.dumps(line), flush=True)

  result = train(args.config, args.num_steps, str(process.device),
                 args.seed, args.workdir, on_step=print_step,
                 profile=args.profile,
                 on_device_generation=evaluate.on_device_flag(
                     args.on_device_generation),
                 stop_at_step=args.stop_at_step)
  if not lead:
    return
  if result['profile'] is not None:
    print(result['profile'])
  print(json.dumps({
      key: result[key] for key in (
          'config', 'device', 'generator_kind', 'start_step', 'stop_step',
          'shuffle_seed', 'step_seconds', 'wall_seconds', 'build_ms',
          'build_card_ms', 'train_summary', 'eval_summary', 'checkpoints',
          'restore_seconds', 'trace', 'workdir', 'mesh')}))


if __name__ == '__main__':
  main()
