"""The mesh's ``data`` and ``model`` axes over processes
(``snap_tpu/parallel/mesh.py``).

The reference runs one jitted step over a ``jax.sharding.Mesh`` whose
``data`` axis splits the batch and whose ``model`` axis splits the wide
parameters (tensor parallelism). The port runs one process per rank, as
``torchrun`` starts them:

    torchrun --nproc_per_node=2 -m snap_tpu_torch.train --config=...

``init`` reads ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` and
``LOCAL_WORLD_SIZE`` as ``torchrun`` sets them (with ``MASTER_ADDR`` and
``MASTER_PORT``) and starts the process group. Each rank on a card of its
own takes ``cuda:LOCAL_RANK`` and NCCL; where the host has fewer cards than
ranks, the ranks share them (``cuda:LOCAL_RANK % cards``) and take gloo,
which runs CUDA collectives through the host (NCCL refuses two ranks on
one card); ranks on the CPU take gloo. A process not started so (no
``WORLD_SIZE``) makes no process group: one rank, which runs as it would
without this module (a group of one rank, under ``torchrun``, reduces over
itself as a larger one does).

``setup(make_mesh(...))`` lays the ranks out on a ``{data: D, model: M}``
mesh: rank r sits at (data, model) = (r // M, r % M), the reference's
``np.asarray(devices).reshape((data, model))``. Every rank makes, in the
same order, one process group per data row (the ranks of one model group,
which share a batch block and hold one parameter's slices) and one per
model column (the ranks of one data group, which hold the same slices and
split the batch). Without ``setup`` the mesh is ``{data: world, model: 1}``.

Each data rank builds its contiguous block of every global batch
(``data/loader.py``, by ``data_index`` over ``data_size``), takes its rows
of the step's draws, and the trainer sums the gradients and the metrics'
(sum, count) pairs over the data group (``all_reduce_sum``), so that every
rank takes the step one process would take on the global batch. The model
axis (``TP_MIN_DIM``, ``infer_param_shardings``; the sharded layers and
their collectives in ``parallel/tensor.py``) splits the wide leaves: the
ranks of a model group compute the same activations, each from its slice
of those leaves. Rank 0 alone writes checkpoints, summaries and
evaluation dumps; ``barrier`` makes the others wait for them.
"""

from __future__ import annotations

import dataclasses
import datetime
import logging
import os
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from snap_tpu_torch import convert

log = logging.getLogger(__name__)
Tensor = torch.Tensor

AXES = ('data', 'model')
# The smallest last dim (in the flax layout) of a leaf the model axis
# shards (``snap_tpu/parallel/mesh.py:TP_MIN_DIM``; ``Config.tp_min_dim``).
TP_MIN_DIM = 256
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
  ``ValueError``."""
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
  """Ends the process group, if one was started, and forgets the mesh."""
  global _LAYOUT
  _LAYOUT = None
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


@dataclasses.dataclass(frozen=True)
class Layout:
  """This rank's place on the mesh: the axis sizes, its (data, model)
  index, and the process groups of its model group (its data row) and its
  data group (its model column); None for a group of the whole world."""

  data: int
  model: int
  data_index: int
  model_index: int
  data_group: Any = None
  model_group: Any = None


_LAYOUT: Optional[Layout] = None


def place(rank_: int, model: int) -> Tuple[int, int]:
  """Rank ``rank_``'s (data, model) index on a mesh of ``model`` ranks a
  model group: the reference's ``np.asarray(devices).reshape((data,
  model))``, row-major."""
  return rank_ // model, rank_ % model


def setup(axes: Mapping[str, int]) -> Layout:
  """Lays the ranks out on ``axes`` (``make_mesh``'s sizes over the world):
  rank r at (r // model, r % model). Every rank makes every group, in the
  same order: first each data row's model group, then each model
  column's data group. A world of one rank, or ``model = 1``, makes none
  (the data axis is the world)."""
  global _LAYOUT
  data, model = int(axes['data']), int(axes.get('model', 1))
  world, r = world_size(), rank()
  if data * model != world:
    raise ValueError(f'Mesh {dict(axes)} does not match {world} ranks.')
  data_group = model_group = None
  if model > 1:
    for d in range(data):
      group = dist.new_group([d * model + m for m in range(model)])
      if d == r // model:
        model_group = group
    for m in range(model):
      group = dist.new_group([d * model + m for d in range(data)])
      if m == r % model:
        data_group = group
  _LAYOUT = Layout(data, model, *place(r, model), data_group, model_group)
  log.info('Rank %d at (data %d, model %d) of a {data: %d, model: %d} mesh.',
           r, *place(r, model), data, model)
  return _LAYOUT


def layout() -> Layout:
  """The mesh ``setup`` laid out, else ``{data: world, model: 1}``."""
  if _LAYOUT is not None and dist.is_initialized():
    return _LAYOUT
  return Layout(world_size(), 1, rank(), 0)


def data_size() -> int:
  return layout().data


def model_size() -> int:
  return layout().model


def data_index() -> int:
  return layout().data_index


def model_index() -> int:
  return layout().model_index


def block(size: int, num: Optional[int] = None,
          index: Optional[int] = None) -> slice:
  """This rank's contiguous rows of a global batch of ``size``: its
  ``size / num`` rows from ``index * size / num`` (the reference's
  ``start = process_index * local_bs``), over the data axis by default.
  Raises unless ``num`` divides ``size``."""
  num = data_size() if num is None else num
  index = data_index() if index is None else index
  if size % num:
    raise ValueError(f'Global batch size {size} must divide evenly over '
                     f'{num} processes.')
  local = size // num
  return slice(index * local, (index + 1) * local)


def all_reduce_sum(tensors: Sequence[Tensor]) -> List[Tensor]:
  """The sum of each tensor over the ranks of the data axis (this rank's
  data group; a group of one rank reduces over itself), in one all-reduce
  of a flat f32 buffer (the tensors' own dtype back); the tensors
  themselves with no process group. Every rank gets the same bits."""
  if not dist.is_initialized() or not tensors:
    return list(tensors)
  flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
  dist.all_reduce(flat, group=layout().data_group)
  out, at = [], 0
  for t in tensors:
    out.append(flat[at:at + t.numel()].reshape(t.shape).to(t.dtype))
    at += t.numel()
  return out


def model_gather(t: Tensor) -> List[Tensor]:
  """``t`` of every rank of this rank's model group, in model order
  (``dist.all_gather``; gloo stages CUDA tensors through the host)."""
  lay = layout()
  if lay.model == 1:
    return [t]
  t = t.contiguous()
  parts = [torch.empty_like(t) for _ in range(lay.model)]
  dist.all_gather(parts, t, group=lay.model_group)
  return parts


def model_sum(t: Tensor) -> Tensor:
  """The sum of ``t`` over this rank's model group, in one stated order:
  the left fold of the ranks' tensors in model order, in ``t``'s dtype, so
  that every rank of the group gets the same bits whatever the backend's
  own reduction order."""
  parts = model_gather(t)
  out = parts[0]
  for part in parts[1:]:
    out = out + part
  return out


def model_broadcast(tensors: Sequence[Tensor]) -> List[Tensor]:
  """The tensors of the first rank of this rank's model group (model index
  0), in one broadcast of a flat f32 buffer over the group (the tensors'
  own dtype back); the tensors themselves for ``model = 1``."""
  lay = layout()
  if lay.model == 1 or not tensors:
    return list(tensors)
  flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
  dist.broadcast(flat, lay.data_index * lay.model, group=lay.model_group)
  out, at = [], 0
  for t in tensors:
    out.append(flat[at:at + t.numel()].reshape(t.shape).to(t.dtype))
    at += t.numel()
  return out


def any_true(flag: bool) -> bool:
  """Whether ``flag`` holds on some rank of the world (one all-reduce)."""
  if not dist.is_initialized() or world_size() == 1:
    return flag
  device = (torch.device('cuda', torch.cuda.current_device())
            if dist.get_backend() == 'nccl' else torch.device('cpu'))
  count = torch.tensor([float(flag)], device=device)
  dist.all_reduce(count)
  return bool(count.item() > 0)


def infer_param_shardings(module: torch.nn.Module,
                          min_dim: int = TP_MIN_DIM,
                          model: Optional[int] = None) -> Dict[str, int]:
  """The reference's rule (``infer_param_shardings``) over ``model`` ranks
  of the model axis (this mesh's by default): a leaf is sharded where, in
  the flax layout (``convert.flax_leaf``: a conv kernel HWIO, a dense
  kernel ``[in, out]``, a GroupNorm scale or bias ``[1, 1, 1, C]``, an
  embedding ``[num, dim]``), it has two dims or more and its last dim is
  at least ``min_dim`` and divisible by ``model``. Returns ``{name: dim}``,
  the torch dim that flax's last dim is: a conv's or dense layer's output
  channels (dim 0), a GroupNorm parameter's only dim, an embedding's last
  dim. Empty for ``model = 1``."""
  model = model_size() if model is None else model
  if model == 1:
    return {}
  modules = dict(module.named_modules())
  out = {}
  for name, p in module.named_parameters():
    _, perm, flax_shape = convert.flax_leaf(name, tuple(p.shape), modules)
    if (len(flax_shape) >= 2 and flax_shape[-1] >= min_dim
        and flax_shape[-1] % model == 0):
      out[name] = perm[-1] if perm is not None else p.ndim - 1
  return out


def all_gather_objects(obj: Any) -> List[Any]:
  """``obj`` of every rank, in rank order (``[obj]`` with no group)."""
  if not dist.is_initialized():
    return [obj]
  out: List[Any] = [None] * dist.get_world_size()
  dist.all_gather_object(out, obj)
  return out
