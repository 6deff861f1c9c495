"""The mesh's ``data`` axis over processes (``snap_tpu/parallel/mesh.py``).

The reference runs one jitted step over a ``jax.sharding.Mesh`` whose
``data`` axis splits the batch and whose ``model`` axis is kept for tensor
parallelism. The port runs one process per rank of the ``data`` axis, as
``torchrun`` starts them:

    torchrun --nproc_per_node=2 -m snap_tpu_torch.train --config=...

``init`` reads ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` and
``LOCAL_WORLD_SIZE`` as ``torchrun`` sets them (with ``MASTER_ADDR`` and
``MASTER_PORT``) and starts the process group. Each rank on a card of its
own takes ``cuda:LOCAL_RANK`` and NCCL; where the host has fewer cards than
ranks, the ranks share them (``cuda:LOCAL_RANK % cards``) and take gloo,
which all-reduces CUDA tensors through the host (NCCL refuses two ranks
on one card); ranks on the CPU take gloo. A process not started so (no
``WORLD_SIZE``) makes no process group: one rank, which runs as it would
without this module (a group of one rank, under ``torchrun``, reduces over
itself as a larger one does).

Each rank builds its contiguous block of every global batch
(``data/loader.py``), takes its rows of the step's draws, and the trainer
sums the gradients and the metrics' (sum, count) pairs over the ranks
(``all_reduce_sum``), so that every rank takes the step one process would
take on the global batch. Rank 0 alone writes checkpoints, summaries and
evaluation dumps; ``barrier`` makes the others wait for them. The
``model`` axis (tensor parallelism, ``infer_param_shardings``,
``constrain``) is not ported: ``make_mesh`` refuses ``model > 1``.
"""

from __future__ import annotations

import dataclasses
import datetime
import logging
import os
from typing import Any, Dict, List, Mapping, Optional, Sequence

import torch
import torch.distributed as dist

log = logging.getLogger(__name__)
Tensor = torch.Tensor

AXES = ('data', 'model')
# How long a collective may wait for the other ranks before it raises.
TIMEOUT = datetime.timedelta(minutes=10)


@dataclasses.dataclass(frozen=True)
class Process:
  """This process's place: its rank of ``world`` ranks, the device it
  computes on and the process group's backend (None: no group)."""

  rank: int
  world: int
  device: torch.device
  backend: Optional[str]


def make_mesh(mesh_config: Optional[Mapping[str, int]] = None,
              num: Optional[int] = None) -> Dict[str, int]:
  """The mesh's axis sizes over ``num`` ranks (the world's by default): a
  ``{axis: size}`` config whose -1 takes the ranks the others leave, as the
  reference's ``make_mesh``; sizes that do not multiply to ``num`` raise
  ``ValueError``, and so does ``model > 1`` (tensor parallelism, the
  tensor-parallel part of ROADMAP A12, is not ported)."""
  num = world_size() if num is None else num
  axes = dict(mesh_config) if mesh_config is not None else {}
  unknown = sorted(set(axes) - set(AXES))
  if unknown:
    raise ValueError(f'Mesh axes {unknown}: the mesh has {list(AXES)}.')
  axes.setdefault('data', -1)
  axes.setdefault('model', 1)
  known = 1
  for size in axes.values():
    if size != -1:
      known *= size
  for key, size in axes.items():
    if size == -1:
      axes[key] = num // known
  total = 1
  for size in axes.values():
    total *= size
  if total != num or min(axes.values()) < 1:
    raise ValueError(f'Mesh {axes} does not match {num} devices.')
  if axes['model'] != 1:
    raise ValueError(
        f'Mesh {axes}: model = {axes["model"]}; the model axis (tensor '
        f'parallelism, the tensor-parallel part of ROADMAP A12) is not '
        f'ported, only data parallelism over processes.')
  return axes


def _env_int(name: str) -> Optional[int]:
  value = os.environ.get(name)
  return None if value is None else int(value)


def pick_device(device: str, local_rank: int) -> torch.device:
  """``cuda`` becomes ``cuda:local_rank`` where the host has a card a rank,
  else the ranks share the cards in turn; any other device is kept."""
  dev = torch.device(device)
  if dev.type != 'cuda' or dev.index is not None:
    return dev
  cards = torch.cuda.device_count()
  if cards < 1:
    raise RuntimeError(f'device {device!r} asked for, and no CUDA card is '
                       f'found')
  return torch.device('cuda', local_rank % cards)


def pick_backend(device: torch.device, local_world: int) -> str:
  """NCCL where each rank of the host has a card of its own; gloo where
  ranks share a card (NCCL refuses two ranks on one device) or run on the
  CPU."""
  if device.type == 'cuda' and torch.cuda.device_count() >= local_world:
    return 'nccl'
  return 'gloo'


def init(device: str = 'cuda') -> Process:
  """This process's ``Process``: under ``torchrun`` (``WORLD_SIZE`` set)
  the process group is started on the device and backend picked above and
  the choice logged; else one rank on ``device``, no group."""
  world = _env_int('WORLD_SIZE')
  if world is None:
    return Process(0, 1, torch.device(device), None)
  rank = _env_int('RANK') or 0
  local_rank = _env_int('LOCAL_RANK') or 0
  local_world = _env_int('LOCAL_WORLD_SIZE') or world
  dev = pick_device(device, local_rank)
  backend = pick_backend(dev, local_world)
  if dev.type == 'cuda':
    torch.cuda.set_device(dev)
  if not dist.is_initialized():
    dist.init_process_group(backend, rank=rank, world_size=world,
                            timeout=TIMEOUT)
  log.info('Rank %d of %d on %s, %s (%d card(s) for %d rank(s) on this '
           'host).', rank, world, dev, backend,
           torch.cuda.device_count() if dev.type == 'cuda' else 0,
           local_world)
  return Process(rank, world, dev, backend)


def shutdown() -> None:
  """Ends the process group, if one was started."""
  if dist.is_initialized():
    dist.destroy_process_group()


def active() -> bool:
  """Whether this process is a rank of a process group (``torchrun``, one
  rank or more): the trainer and the evaluator then reduce over it."""
  return dist.is_initialized()


def world_size() -> int:
  return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
  return dist.get_rank() if dist.is_initialized() else 0


def is_lead() -> bool:
  """Whether this process writes what a run writes once (rank 0)."""
  return rank() == 0


def barrier() -> None:
  if dist.is_initialized():
    dist.barrier()


def block(size: int, num: Optional[int] = None,
          index: Optional[int] = None) -> slice:
  """This rank's contiguous rows of a global batch of ``size``: its
  ``size / num`` rows from ``index * size / num`` (the reference's
  ``start = process_index * local_bs``). Raises unless ``num`` divides
  ``size``."""
  num = world_size() if num is None else num
  index = rank() if index is None else index
  if size % num:
    raise ValueError(f'Global batch size {size} must divide evenly over '
                     f'{num} processes.')
  local = size // num
  return slice(index * local, (index + 1) * local)


def all_reduce_sum(tensors: Sequence[Tensor]) -> List[Tensor]:
  """The sum of each tensor over the ranks, in one all-reduce of a flat
  f32 buffer (the tensors' own dtype back); the tensors themselves with no
  group. Every rank gets the same bits."""
  if not dist.is_initialized() or not tensors:
    return list(tensors)
  flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
  dist.all_reduce(flat)
  out, at = [], 0
  for t in tensors:
    out.append(flat[at:at + t.numel()].reshape(t.shape).to(t.dtype))
    at += t.numel()
  return out


def all_gather_objects(obj: Any) -> List[Any]:
  """``obj`` of every rank, in rank order (``[obj]`` with no group)."""
  if not dist.is_initialized():
    return [obj]
  out: List[Any] = [None] * dist.get_world_size()
  dist.all_gather_object(out, obj)
  return out
