"""The FPN's x2 upsampling (``image_encoder.upsample2x``) against
``jax.image.resize(..., 'bilinear')``: forward and VJP, odd and even sizes,
one-pixel sides (every output a border), f32 and bf16; and its backward
graph free of the ops whose CUDA backward adds with atomics (ROADMAP C20).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snap_tpu_torch.models import image_encoder

torch.set_num_threads(2)

SHAPES = [(1, 1, 1, 2), (1, 1, 5, 3), (2, 3, 4, 5), (1, 5, 7, 3),
          (2, 6, 8, 4)]
# f32: both sides round the same stencil's sums; bf16: JAX resizes in bf16
# (each product and sum rounded) and the port in f32 rounded once, a few
# bf16 ulps apart at an entry (0.0156 at most on entries of magnitude ~2).
TOLERANCES = {torch.float32: dict(atol=1e-6, rtol=1e-6),
              torch.bfloat16: dict(atol=1e-2, rtol=2.0**-7)}
JAX_DTYPES = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _inputs(shape, seed):
  rng = np.random.default_rng(seed)
  b, h, w, c = shape
  x = rng.normal(size=shape).astype(np.float32)
  g = rng.normal(size=(b, 2 * h, 2 * w, c)).astype(np.float32)
  return x, g


def _to_torch(x, dtype):
  return torch.from_numpy(x).to(dtype)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('shape', SHAPES)
def test_upsample2x_and_its_vjp_match_jax_image_resize(shape, dtype):
  x, g = _inputs(shape, sum(shape))
  b, h, w, c = shape
  jdtype = JAX_DTYPES[dtype]

  def resize(v):
    return jax.image.resize(v, (b, 2 * h, 2 * w, c), 'bilinear')

  want, vjp = jax.vjp(resize, jnp.asarray(x, jdtype))
  (want_grad,) = vjp(jnp.asarray(g, jdtype))
  xt = _to_torch(x, dtype).requires_grad_()
  got = image_encoder.upsample2x(xt)
  assert got.dtype == dtype and got.shape == (b, 2 * h, 2 * w, c)
  (got_grad,) = torch.autograd.grad(got, xt, _to_torch(g, dtype))
  assert got_grad.dtype == dtype
  np.testing.assert_allclose(got.detach().float().numpy(),
                             np.asarray(want, np.float32),
                             **TOLERANCES[dtype])
  np.testing.assert_allclose(got_grad.float().numpy(),
                             np.asarray(want_grad, np.float32),
                             **TOLERANCES[dtype])


def _graph_ops(fn) -> set:
  """The names of every node of ``fn``'s backward graph."""
  seen, names, todo = set(), set(), [fn]
  while todo:
    node = todo.pop()
    if node is None or node in seen:
      continue
    seen.add(node)
    names.add(type(node).__name__)
    todo.extend(next_fn for next_fn, _ in node.next_functions)
  return names


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_upsample2x_backward_has_no_atomic_ops(dtype):
  """No ``upsample_bilinear2d_backward`` (``F.interpolate``'s) and no
  replication pad (``F.pad(mode='replicate')``'s): both add with atomics
  in their CUDA backward, so neither gives the same bits on every run."""
  x = torch.randn((2, 3, 5, 4), dtype=dtype, requires_grad=True)
  names = _graph_ops(image_encoder.upsample2x(x).grad_fn)
  assert {'CatBackward0', 'StackBackward0'} <= names
  lowered = {n.lower() for n in names}
  assert not any('upsample' in n or 'replication' in n or 'pad' in n
                 for n in lowered), names


def test_upsample2x_gradient_is_the_same_on_every_call():
  """Two backward calls of the same graph give the same bits."""
  x, g = _inputs((2, 6, 8, 4), 7)
  xt = torch.from_numpy(x).requires_grad_()
  out = image_encoder.upsample2x(xt)
  grads = [torch.autograd.grad(out, xt, torch.from_numpy(g),
                               retain_graph=True)[0] for _ in range(2)]
  assert torch.equal(grads[0], grads[1])
