"""The mesh's ``model`` axis: tensor parallelism over the ranks of a model
group (``snap_tpu/parallel/mesh.py:infer_param_shardings``, the MLP's
``constrain`` in ``snap_tpu/models/layers.py``).

``shard_model(model, min_dim)`` applies the reference's rule
(``mesh.infer_param_shardings``) to a built model: each sharded leaf is
replaced by this rank's contiguous block ``model_index`` of the dim that
flax's last dim is (the reference's ``NamedSharding(P(..., 'model'))``),
and the layer that holds it computes with that slice:

- a convolution or dense layer (``resnet.StdConv``, the FPN's
  ``image_encoder.SkipConv``, ``layers.Dense``) computes its own output
  channels from the full input (weight standardization is per output
  channel, so it stays local). Its output is gathered over the model group
  along the channel dim, the last (NHWC), and a dense layer's bias, which
  the rule replicates, is added after the gather. Its input passes through
  ``copy_to_model`` (Megatron's "copy to the model region"): the identity
  forward, and in the backward the sum over the model group of the ranks'
  partial input gradients, each over the rank's own output channels. The
  gather's backward is the rank's slice of the incoming cotangent, which
  is the same on every rank of the group: everything downstream is
  replicated;
- a GroupNorm's scale and bias, and an embedding table, are gathered for
  the forward; the gradient is the rank's slice of the full one.

Every collective is a ``torch.autograd.Function`` over ``mesh``'s model
group (``mesh.model_gather``: ``dist.all_gather``; ``mesh.model_sum``: the
left fold of the gathered tensors in model order), so every rank of a
model group computes the same activations and the same replicated
gradients, bit for bit. A sharded parameter carries its dim as
``tp_dim``; ``full`` and ``local`` gather and slice a leaf for the
checkpoints and the warm start.
"""

from __future__ import annotations

import types
from typing import Dict

import torch
from torch import nn
import torch.nn.functional as F

from snap_tpu_torch.models import image_encoder
from snap_tpu_torch.models import layers
from snap_tpu_torch.models import resnet
from snap_tpu_torch.parallel import mesh

Tensor = torch.Tensor


class _CopyToModel(torch.autograd.Function):
  """Identity forward; the backward sums the ranks' partial gradients over
  the model group."""

  @staticmethod
  def forward(ctx, x):
    return x.view_as(x)

  @staticmethod
  def backward(ctx, g):
    return mesh.model_sum(g.contiguous())


class _GatherFromModel(torch.autograd.Function):
  """The ranks' blocks concatenated along ``dim`` in model order; the
  backward takes this rank's block of the cotangent."""

  @staticmethod
  def forward(ctx, x, dim):
    ctx.dim, ctx.size = dim, x.shape[dim]
    return torch.cat(mesh.model_gather(x), dim)

  @staticmethod
  def backward(ctx, g):
    at = mesh.model_index() * ctx.size
    return g.narrow(ctx.dim, at, ctx.size).contiguous(), None


def copy_to_model(x: Tensor) -> Tensor:
  return _CopyToModel.apply(x)


def gather(x: Tensor, dim: int) -> Tensor:
  return _GatherFromModel.apply(x, dim % x.ndim)


def _conv(self, x: Tensor) -> Tensor:
  """A sharded convolution: its output channels from the full input,
  gathered (the class's own forward on this rank's kernel slice)."""
  return gather(type(self).forward(self, copy_to_model(x)), -1)


def _dense(self, x: Tensor) -> Tensor:
  """A sharded ``layers.Dense``: its output features, gathered, then the
  replicated bias."""
  y = F.linear(copy_to_model(x).to(self.dtype), self.weight.to(self.dtype))
  y = gather(y, -1)
  return y if self.bias is None else y + self.bias.to(self.dtype)


def _group_norm(self, x: Tensor) -> Tensor:
  """A GroupNorm whose scale and bias are sharded: both gathered."""
  full_param = lambda p: gather(p, 0) if is_sharded(p) else p
  return resnet.group_norm(x, self.ngroups, full_param(self.scale),
                           full_param(self.bias), self.dtype)


def _embed(self, ids: Tensor, dtype: torch.dtype) -> Tensor:
  """A ``layers.Embed`` whose table is sharded: the table gathered."""
  return F.embedding(ids, gather(self.weight, -1).to(dtype))


# The forward of each layer that may hold a sharded leaf, and the leaves
# it may hold sharded.
_SHARDED_FORWARD = (
    (resnet.StdConv, _conv, ('weight',)),
    (image_encoder.SkipConv, _conv, ('weight',)),
    (layers.Dense, _dense, ('weight',)),
    (resnet.GroupNorm, _group_norm, ('scale', 'bias')),
    (layers.Embed, _embed, ('weight',)),
)


def is_sharded(p: Tensor) -> bool:
  return getattr(p, 'tp_dim', None) is not None


def shard_dims(model: nn.Module) -> Dict[str, int]:
  """``{name: dim}`` of ``model``'s sharded parameters."""
  return {name: p.tp_dim for name, p in model.named_parameters()
          if is_sharded(p)}


def local(t: Tensor, dim: int) -> Tensor:
  """This rank's block ``model_index`` of the full ``t`` along ``dim``."""
  size = t.shape[dim] // mesh.model_size()
  return t.narrow(dim, mesh.model_index() * size, size)


def full(t: Tensor, dim: int) -> Tensor:
  """The full leaf of this rank's slice ``t``: the model group's slices
  concatenated along ``dim`` (a collective of the group)."""
  return torch.cat(mesh.model_gather(t.detach()), dim)


def shard_model(model: nn.Module, min_dim: int = mesh.TP_MIN_DIM
                ) -> Dict[str, int]:
  """Shards ``model``'s leaves by the rule over this mesh's model axis, in
  place, and gives their layers the sharded forwards; returns ``{name:
  dim}``. Raises where the rule names a leaf of a layer that has no
  sharded form. Nothing changes for ``model = 1``, nor for a model that is
  sharded already."""
  if shard_dims(model):
    return shard_dims(model)
  dims = mesh.infer_param_shardings(model, min_dim)
  modules = dict(model.named_modules())
  owners = {}
  for name, dim in dims.items():
    owner, _, leaf = name.rpartition('.')
    owners.setdefault(owner, []).append(leaf)
    module = modules[owner]
    p = getattr(module, leaf)
    part = nn.Parameter(local(p.detach(), dim).clone(),
                        requires_grad=p.requires_grad)
    part.tp_dim = dim
    setattr(module, leaf, part)
  for owner, leaves in owners.items():
    module = modules[owner]
    for cls, forward, allowed in _SHARDED_FORWARD:
      if type(module) is cls and set(leaves) <= set(allowed):
        module.forward = types.MethodType(forward, module)
        break
    else:
      raise NotImplementedError(
          f'{owner} ({type(module).__name__}): leaves {leaves} are sharded '
          f'by the rule, and the layer has no sharded form')
  return dims
