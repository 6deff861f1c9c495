"""Step checkpoints of a training run (``snap_tpu/train_lib/checkpoints.py``).

``save_checkpoint`` writes ``<workdir>/checkpoints/<step>/``:

- ``params.pt``: the model's ``state_dict`` (parameter name -> tensor);
- ``opt_state.pt``: the optimizer's ``count`` and its moments ``mu`` and
  ``nu``, each keyed by the name of its parameter;
- ``meta.json``: ``global_step``, the run's seed and, in fp16, the
  dynamic loss scale's ``scale`` and ``fin_steps`` (``dynamic_scale``).

A step is written into a temporary directory beside the others and renamed
into place, so a run killed mid-write leaves no half-written step; the
step names (digits only) that hold ``meta.json`` are the checkpoints, and
the last ``max_to_keep`` stay. Tensors go to the host one at a time and are
read back with ``torch.load(..., weights_only=True)``. A checkpoint holds
full leaves: a leaf sharded over the mesh's model axis
(``parallel/tensor.py``) is gathered over the model group before rank 0
writes it (``host_state``, a collective every rank takes part in), and a
restore takes the rank's slice, so a checkpoint resumes under any
``{data, model}`` layout, as the reference's global arrays do.
``restore_checkpoint`` copies a step into the live model's and optimizer's
tensors, so the device holds one copy of the state; ``restore_params``
gives a step's parameters alone (a warm start, an evaluation);
``experiment_params`` those of an experiment workdir, its latest
checkpoint or a JAX export's flat ``params.npz``, and ``load_subtree`` a
module's subtree of them (a warm start's hook).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import pathlib
import shutil
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

from snap_tpu_torch import convert
from snap_tpu_torch.parallel import tensor

PathLike = Union[str, pathlib.Path]
PARAMS, OPT_STATE, META = 'params.pt', 'opt_state.pt', 'meta.json'
_TMP = '.tmp-'
log = logging.getLogger(__name__)


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


def _to_host(tensors: Dict[str, torch.Tensor],
             dims: Dict[str, int]) -> Dict[str, torch.Tensor]:
  """Each tensor on the host, a sharded one (``dims``) gathered whole."""
  return {k: (tensor.full(v, dims[k]) if k in dims else v.detach()).to(
      'cpu', copy=True) for k, v in tensors.items()}


def host_state(state) -> Dict[str, Any]:
  """``state``'s parameters and moments as full leaves on the host: every
  rank of a model group must call it together (it gathers the sharded
  leaves over the group)."""
  dims = tensor.shard_dims(state.model)
  opt = state.opt_state
  names = _moment_names(state)
  return {'params': _to_host(state.model.state_dict(), dims),
          'count': int(opt.count),
          'mu': _to_host(dict(zip(names, opt.mu)), dims),
          'nu': _to_host(dict(zip(names, opt.nu)), dims)}


def save_checkpoint(workdir: PathLike, state, step: int,
                    max_to_keep: int = 10,
                    host: Optional[Dict[str, Any]] = None) -> int:
  """Write ``state`` (a ``trainer.TrainState``) as checkpoint ``step``;
  keep the last ``max_to_keep``. ``host`` is its ``host_state`` where the
  caller has gathered it already. Returns the bytes written."""
  host = host_state(state) if host is None else host
  root = checkpoint_dir(workdir)
  root.mkdir(parents=True, exist_ok=True)
  tmp = root / f'{_TMP}{step}-{os.getpid()}'
  if tmp.exists():
    shutil.rmtree(tmp)
  tmp.mkdir()
  torch.save(host['params'], tmp / PARAMS)
  torch.save({key: host[key] for key in ('count', 'mu', 'nu')},
             tmp / OPT_STATE)
  meta = {'global_step': int(state.global_step), 'seed': int(state.seed)}
  if state.dynamic_scale is not None:
    meta['dynamic_scale'] = state.dynamic_scale.state()
  (tmp / META).write_text(json.dumps(meta))
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
               saved: Dict[str, torch.Tensor], what: str,
               dims: Optional[Dict[str, int]] = None) -> None:
  """Copies each saved full leaf into the live tensor of its name (this
  rank's slice of it where ``dims`` names the tensor sharded)."""
  saved = {k: tensor.local(v, dims[k]) if dims and k in dims else v
           for k, v in saved.items()}
  if set(live) != set(saved):
    raise ValueError(
        f'{what}: the checkpoint holds {sorted(set(saved) - set(live))} '
        f'beyond the live state and lacks {sorted(set(live) - set(saved))}')
  with torch.no_grad():
    for name, value in live.items():
      if value.shape != saved[name].shape:
        raise ValueError(f'{what} {name}: shape {tuple(saved[name].shape)} '
                         f'in the checkpoint, {tuple(value.shape)} live')
      value.copy_(saved.pop(name))


def restore_checkpoint(workdir: PathLike, state,
                       step: Optional[int] = None) -> int:
  """Copy checkpoint ``step`` (the latest when None) into ``state``'s
  model and optimizer tensors, and set its counters and its loss scale.
  Returns the step. A checkpoint with a loss scale restores into an fp16
  state alone, and one without into a bf16 or f32 state alone."""
  path = _step_dir(workdir, step)
  meta = json.loads((path / META).read_text())
  saved_scale = meta.get('dynamic_scale')
  if (saved_scale is None) != (state.dynamic_scale is None):
    raise ValueError(
        f'{path} holds {"no" if saved_scale is None else "a"} dynamic loss '
        f'scale, and the run is {"fp16" if saved_scale is None else "not"}: '
        f'fp16 trains with one, bf16 and f32 without')
  dims = tensor.shard_dims(state.model)
  _copy_into(state.model.state_dict(), _load(path / PARAMS), 'params', dims)
  saved = _load(path / OPT_STATE)
  names = _moment_names(state)
  opt = state.opt_state
  for key in ('mu', 'nu'):
    _copy_into(dict(zip(names, getattr(opt, key))), saved[key], key, dims)
  opt.count = int(saved['count'])
  state.global_step = int(meta['global_step'])
  state.seed = int(meta['seed'])
  if saved_scale is not None:
    state.dynamic_scale = dataclasses.replace(
        state.dynamic_scale, scale=float(saved_scale['scale']),
        fin_steps=int(saved_scale['fin_steps']))
  return int(path.name)


def restore_params(workdir: PathLike, step: Optional[int] = None
                   ) -> Dict[str, torch.Tensor]:
  """The parameters of checkpoint ``step`` (the latest when None), by name,
  on the host."""
  return _load(_step_dir(workdir, step) / PARAMS)


def experiment_params(workdir: pathlib.Path) -> Dict[str, torch.Tensor]:
  """The parameters of the experiment in ``workdir``, by state-dict name:
  its latest checkpoint, else a JAX export's flat ``params.npz``; empty
  when it holds neither."""
  if latest_step(workdir) is not None:
    return restore_params(workdir)
  if (workdir / 'params.npz').exists():
    with np.load(workdir / 'params.npz') as npz:
      return convert.params_from_flax(dict(npz))
  return {}


def load_subtree(module: torch.nn.Module, path: str,
                 name: str) -> Dict[str, torch.Tensor]:
  """The ``name`` subtree of the experiment at ``path``, for ``module``'s
  warm start; raises when the experiment has none."""
  params = subtree(experiment_params(pathlib.Path(path)), name)
  if not params:
    raise ValueError(f'No parameters for {type(module).__name__} in {path}')
  log.info('Loaded pretrained weights for %s from %s.',
           type(module).__name__, path)
  return params


def subtree(params: Dict[str, torch.Tensor], name: str
            ) -> Dict[str, torch.Tensor]:
  """The entries under the first module called ``name`` (the shortest
  prefix ending in it), named relative to it (``misc.find_nested_dict``)."""
  prefixes = sorted({tuple(k.split('.')[:k.split('.').index(name) + 1])
                     for k in params if name in k.split('.')[:-1]}, key=len)
  if not prefixes:
    return {}
  prefix = '.'.join(prefixes[0]) + '.'
  return {k[len(prefix):]: v for k, v in params.items()
          if k.startswith(prefix)}
