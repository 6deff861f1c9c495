"""Step checkpoints of a training run (``snap_tpu/train_lib/checkpoints.py``).

``save_checkpoint`` writes ``<workdir>/checkpoints/<step>/``:

- ``params.pt``: the model's ``state_dict`` (parameter name -> tensor);
- ``opt_state.pt``: the optimizer's ``count`` and its moments ``mu`` and
  ``nu``, each keyed by the name of its parameter;
- ``meta.json``: ``global_step`` and the run's seed.

A step is written into a temporary directory beside the others and renamed
into place, so a run killed mid-write leaves no half-written step; the
step names (digits only) that hold ``meta.json`` are the checkpoints, and
the last ``max_to_keep`` stay. Tensors go to the host one at a time and are
read back with ``torch.load(..., weights_only=True)``. ``restore_checkpoint``
copies a step into the live model's and optimizer's tensors, so the device
holds one copy of the state; ``restore_params`` gives a step's parameters
alone (a warm start, an evaluation).
"""

from __future__ import annotations

import json
import os
import pathlib
import shutil
from typing import Any, Dict, List, Optional, Union

import torch

PathLike = Union[str, pathlib.Path]
PARAMS, OPT_STATE, META = 'params.pt', 'opt_state.pt', 'meta.json'
_TMP = '.tmp-'


def checkpoint_dir(workdir: PathLike) -> pathlib.Path:
  return pathlib.Path(workdir) / 'checkpoints'


def all_steps(workdir: PathLike) -> List[int]:
  """The complete checkpoints' steps, in order (temporaries ignored)."""
  root = checkpoint_dir(workdir)
  if not root.is_dir():
    return []
  return sorted(int(p.name) for p in root.iterdir()
                if p.name.isdigit() and (p / META).exists())


def latest_step(workdir: PathLike) -> Optional[int]:
  steps = all_steps(workdir)
  return steps[-1] if steps else None


def _moment_names(state) -> List[str]:
  names = [n for n, _ in state.model.named_parameters()]
  return [names[i] for i in state.tx.moment_index(len(names))]


def _to_host(tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
  return {k: v.detach().to('cpu', copy=True) for k, v in tensors.items()}


def save_checkpoint(workdir: PathLike, state, step: int,
                    max_to_keep: int = 10) -> int:
  """Write ``state`` (a ``trainer.TrainState``) as checkpoint ``step``;
  keep the last ``max_to_keep``. Returns the bytes written."""
  root = checkpoint_dir(workdir)
  root.mkdir(parents=True, exist_ok=True)
  tmp = root / f'{_TMP}{step}-{os.getpid()}'
  if tmp.exists():
    shutil.rmtree(tmp)
  tmp.mkdir()
  torch.save(_to_host(state.model.state_dict()), tmp / PARAMS)
  opt = state.opt_state
  names = _moment_names(state)
  torch.save({'count': int(opt.count),
              'mu': _to_host(dict(zip(names, opt.mu))),
              'nu': _to_host(dict(zip(names, opt.nu)))}, tmp / OPT_STATE)
  (tmp / META).write_text(json.dumps(
      {'global_step': int(state.global_step), 'seed': int(state.seed)}))
  nbytes = sum(p.stat().st_size for p in tmp.iterdir())
  final = root / str(step)
  if final.exists():
    shutil.rmtree(final)
  os.replace(tmp, final)
  for old in all_steps(workdir)[:-max_to_keep]:
    shutil.rmtree(root / str(old))
  return nbytes


def _step_dir(workdir: PathLike, step: Optional[int]) -> pathlib.Path:
  step = latest_step(workdir) if step is None else step
  path = checkpoint_dir(workdir) / str(step)
  if step is None or not (path / META).exists():
    raise ValueError(f'No checkpoint {"" if step is None else step} in '
                     f'{workdir}.')
  return path


def _load(path: pathlib.Path) -> Any:
  return torch.load(path, map_location='cpu', weights_only=True)


def _copy_into(live: Dict[str, torch.Tensor],
               saved: Dict[str, torch.Tensor], what: str) -> None:
  if set(live) != set(saved):
    raise ValueError(
        f'{what}: the checkpoint holds {sorted(set(saved) - set(live))} '
        f'beyond the live state and lacks {sorted(set(live) - set(saved))}')
  with torch.no_grad():
    for name, tensor in live.items():
      if tensor.shape != saved[name].shape:
        raise ValueError(f'{what} {name}: shape {tuple(saved[name].shape)} '
                         f'in the checkpoint, {tuple(tensor.shape)} live')
      tensor.copy_(saved.pop(name))


def restore_checkpoint(workdir: PathLike, state,
                       step: Optional[int] = None) -> int:
  """Copy checkpoint ``step`` (the latest when None) into ``state``'s
  model and optimizer tensors, and set its counters. Returns the step."""
  path = _step_dir(workdir, step)
  meta = json.loads((path / META).read_text())
  _copy_into(state.model.state_dict(), _load(path / PARAMS), 'params')
  saved = _load(path / OPT_STATE)
  names = _moment_names(state)
  opt = state.opt_state
  for key in ('mu', 'nu'):
    _copy_into(dict(zip(names, getattr(opt, key))), saved[key], key)
  opt.count = int(saved['count'])
  state.global_step = int(meta['global_step'])
  state.seed = int(meta['seed'])
  return int(path.name)


def restore_params(workdir: PathLike, step: Optional[int] = None
                   ) -> Dict[str, torch.Tensor]:
  """The parameters of checkpoint ``step`` (the latest when None), by name,
  on the host."""
  return _load(_step_dir(workdir, step) / PARAMS)
