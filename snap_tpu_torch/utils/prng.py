"""JAX's default PRNG (threefry2x32) in numpy, for the data-seed fold.

``snap_tpu/train.py:68-76`` folds the step a run resumes from into the
data seed:
``int(jax.random.fold_in(jax.random.PRNGKey(shuffle_seed), step).sum())``.
``resume_shuffle_seed`` gives the same integer without JAX: ``PRNGKey``
makes the key ``[seed >> 32, seed & 0xFFFFFFFF]``, ``fold_in`` hashes the
counter ``[0, step]`` under that key with Threefry-2x32 (20 rounds), and the
sum of the two uint32 words wraps modulo 2^32, so the fold may exceed 2^31.
"""

from __future__ import annotations

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_MASK = 0xFFFFFFFF


def _rotl(x: int, r: int) -> int:
  return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(key, count):
  """Threefry-2x32 of one counter pair under one key pair (uint32 words)."""
  k0, k1 = (int(k) & _MASK for k in key)
  ks = (k0, k1, k0 ^ k1 ^ _PARITY)
  x0 = (int(count[0]) + ks[0]) & _MASK
  x1 = (int(count[1]) + ks[1]) & _MASK
  for block in range(5):
    for r in _ROTATIONS[block % 2]:
      x0 = (x0 + x1) & _MASK
      x1 = _rotl(x1, r) ^ x0
    x0 = (x0 + ks[(block + 1) % 3]) & _MASK
    x1 = (x1 + ks[(block + 2) % 3] + block + 1) & _MASK
  return np.array([x0, x1], np.uint32)


def prng_key(seed: int) -> np.ndarray:
  """``jax.random.PRNGKey(seed)``: the seed's high and low 32 bits."""
  seed = int(seed) & 0xFFFFFFFFFFFFFFFF
  return np.array([seed >> 32, seed & _MASK], np.uint32)


def fold_in(key, data: int) -> np.ndarray:
  """``jax.random.fold_in(key, data)`` for the threefry key ``key``."""
  return threefry2x32(key, (0, int(data) & _MASK))


def resume_shuffle_seed(shuffle_seed: int, step: int) -> int:
  """``int(fold_in(PRNGKey(shuffle_seed), step).sum())``: the uint32 sum of
  the folded key's words, which wraps."""
  return int(fold_in(prng_key(shuffle_seed), step).sum(dtype=np.uint32))
