"""Batched SE(2)/SE(3) transforms and camera models on torch tensors.

Port of ``snap_tpu/utils/geometry.py``. Fields carry arbitrary leading batch
dimensions and every method is broadcast-native, as in the JAX package.

Conventions
- Points are stored as ``[..., N, D]`` (a trailing set axis ``N``).
- A transform ``a_t_b`` maps points from frame ``b`` to frame ``a``.
- Pixel coordinates use half-integer pixel centers: the origin is the top-left
  corner of the top-left pixel.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping, Tuple, Union

import torch

Tensor = torch.Tensor


def _rotmat2d(angle: Tensor) -> Tensor:
  cos, sin = torch.cos(angle), torch.sin(angle)
  return torch.stack([cos, -sin, sin, cos], -1).reshape(*angle.shape, 2, 2)


def _apply(mat: Tensor, points: Tensor) -> Tensor:
  """``einsum('...ij,...nj->...ni')`` written out over the 2 or 3 columns."""
  out = mat[..., None, :, 0] * points[..., 0, None]
  for j in range(1, mat.shape[-1]):
    out = out + mat[..., None, :, j] * points[..., j, None]
  return out


def _matvec(mat: Tensor, vec: Tensor) -> Tensor:
  return _apply(mat, vec[..., None, :])[..., 0, :]


@dataclasses.dataclass
class Transform2D:
  """SE(2) transform stored as (angle, translation)."""

  angle: Tensor  # [...]
  t: Tensor  # [..., 2]

  @classmethod
  def from_radians(cls, angle: Tensor, t: Tensor) -> 'Transform2D':
    return cls(angle=torch.as_tensor(angle), t=torch.as_tensor(t))

  @classmethod
  def from_R(cls, R: Tensor, t: Tensor) -> 'Transform2D':
    return cls(angle=torch.atan2(R[..., 1, 0], R[..., 0, 0]), t=t)

  @classmethod
  def from_Transform3D(cls, tfm: 'Transform3D') -> 'Transform2D':
    return cls.from_R(tfm.R, tfm.t[..., :2])

  @property
  def shape(self) -> Tuple[int, ...]:
    return tuple(self.angle.shape)

  def __getitem__(self, idx: Any) -> 'Transform2D':
    return Transform2D(angle=self.angle[idx], t=self.t[idx])

  def unsqueeze(self, dim: int) -> 'Transform2D':
    """A new batch axis at ``dim`` (JAX's ``tfm[..., None]`` for -1)."""
    dim = dim if dim >= 0 else self.angle.ndim + 1 + dim
    return Transform2D(angle=self.angle.unsqueeze(dim),
                       t=self.t.unsqueeze(dim))

  @staticmethod
  def cat(tfms, dim: int = -1) -> 'Transform2D':
    """Concatenate along batch axis ``dim``."""
    dim = dim if dim >= 0 else tfms[0].angle.ndim + dim
    return Transform2D(angle=torch.cat([t.angle for t in tfms], dim),
                       t=torch.cat([t.t for t in tfms], dim))

  def take(self, idx: Tensor) -> 'Transform2D':
    """Per batch row ``b``, the transform at ``idx[b]`` of the last axis."""
    rows = torch.arange(idx.shape[0], device=idx.device)
    return Transform2D(angle=self.angle[rows, idx], t=self.t[rows, idx])

  @property
  def R(self) -> Tensor:
    return _rotmat2d(self.angle)

  @property
  def inv(self) -> 'Transform2D':
    t_inv = -_matvec(self.R.transpose(-1, -2), self.t)
    return Transform2D(angle=-self.angle, t=t_inv)

  def magnitude(self) -> Tuple[Tensor, Tensor]:
    dr = torch.rad2deg(torch.abs(self.angle)) % 360
    dr = torch.minimum(dr, 360 - dr)
    return dr, torch.linalg.norm(self.t, dim=-1)

  def transform(self, points: Tensor) -> Tensor:
    return self.t[..., None, :] + _apply(self.R, points)

  def compose(self, other: 'Transform2D') -> 'Transform2D':
    t = self.t + _matvec(self.R, other.t)
    return Transform2D(angle=self.angle + other.angle, t=t)

  def __matmul__(self, other):
    if isinstance(other, Transform2D):
      return self.compose(other)
    if isinstance(other, Tensor):
      return self.transform(other)
    raise TypeError(f'Unexpected type: {type(other)}')


@dataclasses.dataclass
class Transform3D:
  """SE(3) transform stored as (rotation matrix, translation)."""

  R: Tensor  # [..., 3, 3]
  t: Tensor  # [..., 3]

  @property
  def shape(self) -> Tuple[int, ...]:
    return tuple(self.t.shape[:-1])

  def __getitem__(self, idx: Any) -> 'Transform3D':
    return Transform3D(R=self.R[idx], t=self.t[idx])

  @property
  def inv(self) -> 'Transform3D':
    R_inv = self.R.transpose(-1, -2)
    return Transform3D(R=R_inv, t=-_matvec(R_inv, self.t))

  def magnitude(self) -> Tuple[Tensor, Tensor]:
    """Rotation angle (deg, from the trace) and translation norm."""
    trace = self.R.diagonal(dim1=-2, dim2=-1).sum(-1)
    cos = ((trace - 1) / 2).clamp(-1, 1)
    return torch.rad2deg(torch.arccos(cos).abs()), torch.linalg.norm(
        self.t, dim=-1)

  def transform(self, p3d: Tensor) -> Tensor:
    return self.t[..., None, :] + _apply(self.R, p3d)

  def compose(self, other: 'Transform3D') -> 'Transform3D':
    return Transform3D(R=self.R @ other.R, t=self.t + _matvec(self.R, other.t))

  def __matmul__(self, other):
    if isinstance(other, Transform3D):
      return self.compose(other)
    if isinstance(other, Tensor):
      return self.transform(other)
    raise TypeError(f'Unexpected type: {type(other)}')


@dataclasses.dataclass
class Camera:
  """Pinhole camera with half-integer pixel-center convention."""

  wh: Tensor  # [..., 2]
  f: Tensor  # [..., 2]
  c: Tensor  # [..., 2]

  eps = 1e-3

  def scale(self, scale: Tensor):
    return dataclasses.replace(
        self, wh=self.wh * scale, f=self.f * scale, c=self.c * scale)

  def in_image(self, p2d: Tensor) -> Tensor:
    return ((p2d >= 0) & (p2d < self.wh[..., None, :])).all(-1)

  def project(self, p3d: Tensor) -> Tuple[Tensor, Tensor]:
    z = p3d[..., -1]
    valid = z >= self.eps
    z = z.clamp(min=self.eps)[..., None]
    return p3d[..., :-1] / z, valid

  def denormalize(self, p2d: Tensor) -> Tensor:
    return p2d * self.f[..., None, :] + self.c[..., None, :]

  def world2image(self, p3d: Tensor) -> Tuple[Tensor, Tensor]:
    p2d, visible = self.project(p3d)
    p2d = self.denormalize(p2d)
    return p2d, visible & self.in_image(p2d)


@dataclasses.dataclass
class FisheyeCamera(Camera):
  """Pinhole camera with 3-coefficient radial (theta-polynomial) distortion."""

  k_radial: Tensor  # [..., 3]
  max_fov: Tensor  # [...] radians

  @classmethod
  def from_dict(cls, intrinsics: Mapping[str, Any],
                device: Union[str, torch.device] = 'cpu') -> 'FisheyeCamera':
    as_t = lambda x: torch.as_tensor(x, device=device)  # noqa: E731
    K = as_t(intrinsics['K'])
    wh = torch.stack([as_t(intrinsics['image_width']),
                      as_t(intrinsics['image_height'])], -1).to(K.dtype)
    f = torch.stack([K[..., 0, 0], K[..., 1, 1]], -1)
    c = torch.stack([K[..., 0, 2], K[..., 1, 2]], -1)
    k_radial = as_t(intrinsics['distortion']['radial'])
    max_fov = intrinsics.get('maxfov')
    if max_fov is None:
      max_fov = torch.full(wh.shape[:-1], math.radians(115.0), dtype=K.dtype,
                           device=device)
    return cls(wh=wh, f=f, c=c, k_radial=k_radial, max_fov=as_t(max_fov))

  def distort_points(self, p2d: Tensor) -> Tuple[Tensor, Tensor]:
    radius2 = (p2d * p2d).sum(-1)
    in_center = radius2 < self.eps**2
    radius = torch.sqrt(torch.where(in_center, self.eps**2, radius2))
    theta = torch.arctan(radius)
    theta2 = theta * theta
    k = self.k_radial
    # Horner evaluation of k0*t^2 + k1*t^4 + k2*t^6.
    offset = theta2 * (
        k[..., None, 0] + theta2 * (k[..., None, 1] + theta2 * k[..., None, 2]))
    dist = (offset + 1) * theta / radius
    dist = torch.where(in_center, 1.0, dist)
    p2d_dist = p2d * dist[..., None]
    max_radius = torch.tan(0.5 * self.max_fov)[..., None]
    valid = in_center | ((radius < max_radius) & (dist > 0))
    return p2d_dist, valid

  def world2image(self, p3d: Tensor) -> Tuple[Tensor, Tensor]:
    p2d, visible = self.project(p3d)
    p2d, valid = self.distort_points(p2d)
    p2d = self.denormalize(p2d)
    return p2d, visible & valid & self.in_image(p2d)
