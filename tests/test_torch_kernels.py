"""The CUDA kernels K1/K3 (lift_topk_fwd/bwd), K2/K4 (patch_sample_2d
and its backward), B4/B7 (pose_scoring and its backward), B5
(slice_gather) and B6 (table_gather).

Tests that need a card take the ``cuda`` fixture and skip where there is
none (a CUDA kernel has no CPU mode); on a card, run them with
``python -m pytest tests/test_torch_kernels.py -q``. The CPU tests check
the build recipe and the wrappers' refusals.
"""

from fractions import Fraction
import math

import numpy as np
import pytest
import torch

import chip_smoke
from snap_tpu_torch import evaluate
from snap_tpu_torch.models import pose_estimation
from snap_tpu_torch.models import pose_exhaustive_voting as pev
from snap_tpu_torch.ops import gathers
from snap_tpu_torch.ops import kernels
from snap_tpu_torch.ops import view_fusion
from snap_tpu_torch.ops import view_scan
from snap_tpu_torch.utils import geometry
from snap_tpu_torch.utils import grids

torch.set_num_threads(2)

# Kernel vs plain version: both accumulate in f32; bf16 and f16 outputs
# may differ by one rounding (an ulp: 2^-7 relative at most in bf16, 2^-10
# in f16), f32 ones by summation order.
TOLERANCES = {torch.float32: dict(atol=1e-5, rtol=1e-5),
              torch.bfloat16: dict(atol=1e-3, rtol=2.0**-7),
              torch.float16: dict(atol=1e-3, rtol=2.0**-10)}
# The backward kernels: each output is a sum of tap-weighted contributions
# added with atomics (the plain version's index_add_ on the card too) in
# orders that change from run to run. The test points spill one pixel past
# each image edge, so a view's corner pixels collect a few hundred
# contributions of magnitude up to ~10 whose f32 sums differ by up to
# ~1e-3 between two orders (a first run measured 7e-4): f32 outputs get
# 2e-3 absolute.
BWD_TOLERANCES = {torch.float32: dict(atol=2e-3, rtol=1e-5),
                  torch.bfloat16: dict(atol=1e-3, rtol=2.0**-7),
                  torch.float16: dict(atol=1e-3, rtol=2.0**-10)}


@pytest.fixture
def cuda():
  if not torch.cuda.is_available():
    pytest.skip('needs a CUDA card: the kernels have no CPU mode')
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  return torch.device('cuda')


def _lift_inputs(device, dtype, channels, dim, seed=0):
  g = torch.Generator(device='cpu').manual_seed(seed)
  b, v, h, w, n, k = 2, 5, 7, 9, 3000, 3
  stack = torch.randn((b, v * (h + 1), w + 1, channels), generator=g)
  view_idx = torch.randint(0, v, (b, n, k), generator=g, dtype=torch.int32)
  p2d = torch.rand((b, n, k, 2), generator=g) * torch.tensor(
      [h + 2.0, w + 2.0]) - 1
  select = torch.rand((b, n, k), generator=g) < 0.6
  depth = torch.rand((b, n, k), generator=g) * 40
  args = [t.to(device) for t in (stack.to(dtype), view_idx, p2d, select,
                                 depth)]
  return args, dict(h=h, w=w, dim=dim, depth_min_max=(1.0, 32.0))


def _plane_inputs(device, dtype, seed=0):
  g = torch.Generator(device='cpu').manual_seed(seed)
  b, h, w, d, p = 2, 11, 8, 17, 5000
  plane = torch.randn((b, h + 1, w + 1, d + 1), generator=g)
  plane[..., d] = (plane[..., d] > -1.0).float()
  points = torch.rand((b, p, 2), generator=g) * torch.tensor(
      [h + 2.0, w + 2.0]) - 1
  return [plane.to(dtype).to(device), points.to(device)], dict(
      dim=d, has_valid=True)


@pytest.mark.parametrize('dtype,channels,dim', [
    (torch.float32, 40, 32),  # one 16-byte chunk per lane
    (torch.bfloat16, 160, 128),  # the flagship stack
    (torch.float32, 320, 288),  # several chunks per lane
    (torch.float16, 160, 128),  # the flagship stack in f16
])
def test_lift_topk_fwd_matches_plain(cuda, dtype, channels, dim):
  args, kwargs = _lift_inputs(cuda, dtype, channels, dim)
  before = kernels.LAUNCHES['lift_topk_fwd']
  stats, valid = view_scan.lift_topk(*args, **kwargs)
  assert kernels.LAUNCHES['lift_topk_fwd'] == before + 1
  stats_p, valid_p = view_scan.lift_topk_plain(*args, **kwargs)
  torch.cuda.synchronize()
  assert torch.equal(valid, valid_p)
  torch.testing.assert_close(stats.float(), stats_p.float(),
                             **TOLERANCES[dtype])


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_patch_sample_2d_matches_plain(cuda, dtype):
  args, kwargs = _plane_inputs(cuda, dtype)
  before = kernels.LAUNCHES['patch_sample_2d']
  values, valid = view_scan.patch_sample_2d(*args, **kwargs)
  assert kernels.LAUNCHES['patch_sample_2d'] == before + 1
  values_p, valid_p = view_scan.patch_sample_2d_plain(*args, **kwargs)
  torch.cuda.synchronize()
  assert torch.equal(valid, valid_p)
  torch.testing.assert_close(values.float(), values_p.float(),
                             **TOLERANCES[dtype])


def test_smoke_localizer_on_card_matches_cpu(cuda):
  """The whole slice in f32: card (kernels) against CPU (plain versions),
  both on the host generator's batch."""
  kernels.reset_launch_counts()
  on_card = evaluate.evaluate('smoke_exhaustive', 2, 'cuda', batch_size=2,
                              on_device_generation=False)
  assert kernels.LAUNCHES['lift_topk_fwd'] and kernels.LAUNCHES[
      'patch_sample_2d']
  on_cpu = evaluate.evaluate('smoke_exhaustive', 2, 'cpu', batch_size=2,
                             on_device_generation=False)
  card, cpu = on_card['last_pred'], on_cpu['last_pred']
  assert torch.equal(card['best_volume_index'].cpu(), cpu['best_volume_index'])
  torch.testing.assert_close(card['map_t_query'].t.cpu(),
                             cpu['map_t_query'].t, atol=1e-4, rtol=0)


def test_cuda_launchers_refuse_cpu_tensors():
  """The kernel launchers take CUDA tensors only; the wrappers route CPU."""
  args, kwargs = _lift_inputs('cpu', torch.float32, 40, 32)
  with pytest.raises(ValueError, match='needs CUDA'):
    kernels.lift_topk_fwd(*args, **kwargs)
  g_stats = torch.zeros(args[1].shape[:2] + (2 * 32 + 1,))
  with pytest.raises(ValueError, match='needs CUDA'):
    kernels.lift_topk_bwd(*args, g_stats, **kwargs)
  args, kwargs = _plane_inputs('cpu', torch.float32)
  with pytest.raises(ValueError, match='needs CUDA'):
    kernels.patch_sample_2d(*args, **kwargs)
  with pytest.raises(ValueError, match='needs CUDA'):
    kernels.patch_sample_2d_bwd(torch.zeros(2, 5000, 17), args[1],
                                plane_shape=tuple(args[0].shape))
  before = dict(kernels.LAUNCHES)
  padded = args[0].clone().requires_grad_()
  values, _ = view_scan.patch_sample_2d(padded, args[1], **kwargs)
  values.sum().backward()
  assert kernels.LAUNCHES == before


def test_build_recipe():
  """Plain nvcc calls for sm_90a into a .gitignored build directory."""
  assert 'arch=compute_90a,code=sm_90a' in kernels.NVCC_FLAGS
  assert '-shared' in kernels.NVCC_FLAGS
  path = kernels.library_path()
  assert path.parent == kernels.BUILD_DIR
  assert path.parts[-3] == 'build' and path.suffix == '.so'
  sources = sorted(p.name for p in kernels.CSRC.glob('*.cu'))
  assert sources == ['lift_topk_bwd.cu', 'lift_topk_fwd.cu',
                     'patch_sample_2d.cu', 'patch_sample_2d_bwd.cu',
                     'pose_scoring.cu', 'pose_scoring_bwd.cu',
                     'slice_gather.cu', 'table_gather.cu']
  assert sorted(f'{name}.cu' for name in kernels.LAUNCHES) == sources
  assert kernels.library_path() == path  # stable: keyed by the sources


def _raw_lift_bwd_inputs(device, dtype, channels, dim, k=4, seed=0):
  """K3 inputs with single-view points and unselected ranks."""
  args, kwargs = _lift_inputs(device, dtype, channels, dim, seed)
  stack, view_idx, p2d, select, depth = args
  b, n = view_idx.shape[:2]
  g = torch.Generator(device='cpu').manual_seed(seed + 1)
  view_idx = torch.randint(0, 5, (b, n, k), generator=g, dtype=torch.int32)
  p2d = torch.rand((b, n, k, 2), generator=g) * torch.tensor([9.0, 11.0]) - 1
  select = torch.rand((b, n, k), generator=g) < 0.6
  select[:, :200] = False
  select[:, 200:400] = False
  select[:, 200:400, k - 1] = True
  depth = torch.rand((b, n, k), generator=g) * 40
  g_stats = torch.randn((b, n, 2 * dim + 1), generator=g).to(dtype)
  args = [stack] + [t.to(device) for t in (view_idx, p2d, select, depth)]
  return args, g_stats.to(device), kwargs


@pytest.mark.parametrize('dtype,channels,dim', [
    (torch.float32, 40, 32),  # the smoke stack
    (torch.bfloat16, 160, 128),  # the flagship stack
    (torch.float32, 256, 224),  # the widest stack K3 takes
    (torch.float16, 160, 128),  # the flagship stack in f16
])
def test_lift_topk_bwd_matches_plain(cuda, dtype, channels, dim):
  args, g_stats, kwargs = _raw_lift_bwd_inputs(cuda, dtype, channels, dim)
  before = kernels.LAUNCHES['lift_topk_bwd']
  stack = args[0].clone().requires_grad_()
  stats, _ = view_scan.lift_topk(stack, *args[1:], **kwargs)
  (got,) = torch.autograd.grad(stats, stack, g_stats)
  assert kernels.LAUNCHES['lift_topk_bwd'] == before + 1
  want = view_scan.lift_topk_bwd_plain(*args, g_stats, **kwargs)
  torch.cuda.synchronize()
  torch.testing.assert_close(got.float(), want.float(),
                             **BWD_TOLERANCES[dtype])


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_patch_sample_2d_bwd_matches_plain(cuda, dtype):
  args, kwargs = _plane_inputs(cuda, dtype)
  padded = args[0].clone().requires_grad_()
  before = kernels.LAUNCHES['patch_sample_2d_bwd']
  values, _ = view_scan.patch_sample_2d(padded, args[1], **kwargs)
  g = torch.randn(values.shape, device=cuda).to(dtype)
  (got,) = torch.autograd.grad(values, padded, g)
  assert kernels.LAUNCHES['patch_sample_2d_bwd'] == before + 1
  want = view_scan.patch_sample_2d_bwd_plain(
      g, args[1], plane_shape=tuple(padded.shape))
  torch.cuda.synchronize()
  assert not got[..., kwargs['dim']].any()
  torch.testing.assert_close(got.float(), want.float(),
                             **BWD_TOLERANCES[dtype])


def _binned_lift_bwd_inputs(device, dtype, channels, dim, k, seed=3):
  """K3 inputs on views of 45 x 60 pixels: 1,000 points per example with
  every rank on one pixel (4,000 or more ranks in one of K3's bins, more
  than one block of its last stage takes), points whose lower taps lie on
  the last row or column of an 8 x 8 tile and on the view's last pixel row
  and column (whose upper taps, on the pad row and column, get a weight of
  0), points past the edges, and view 1 of 3 empty."""
  g = torch.Generator(device='cpu').manual_seed(seed)
  b, v, h, w, n = 2, 3, 45, 60, 6000
  stack = torch.randn((b, v * (h + 1), w + 1, channels), generator=g)
  view_idx = torch.randint(0, v, (b, n, k), generator=g, dtype=torch.int32)
  view_idx[view_idx == 1] = 2
  p2d = torch.rand((b, n, k, 2), generator=g) * torch.tensor(
      [h + 2.0, w + 2.0]) - 1
  select = torch.rand((b, n, k), generator=g) < 0.7
  pile = slice(0, 1000)
  p2d[:, pile] = torch.tensor([20.3, 33.7])
  view_idx[:, pile] = 0
  select[:, pile] = True
  edge = slice(1000, 3000)
  tile_end = torch.tensor([7.5, 15.5, 23.5, 39.5, h - 0.5, h + 0.7])
  tile_end_j = torch.tensor([7.5, 31.5, 55.5, w - 0.5, w + 0.3, 0.2])
  shape = (b, 2000, k)
  p2d[:, edge, :, 0] = tile_end[torch.randint(0, 6, shape, generator=g)] + (
      torch.rand(shape, generator=g) * 0.99 * (torch.rand(shape, generator=g)
                                               < 0.5))
  p2d[:, edge, :, 1] = tile_end_j[torch.randint(0, 6, shape, generator=g)]
  depth = torch.rand((b, n, k), generator=g) * 40
  g_stats = torch.randn((b, n, 2 * dim + 1), generator=g)
  args = [t.to(device) for t in (stack.to(dtype), view_idx, p2d, select,
                                 depth)]
  return args, g_stats.to(dtype).to(device), dict(
      h=h, w=w, dim=dim, depth_min_max=(1.0, 32.0))


@pytest.mark.parametrize('dtype,channels,dim,k', [
    (torch.float32, 40, 32, 4),  # the smoke stack
    (torch.bfloat16, 160, 128, 4),  # the flagship stack
    (torch.float32, 256, 224, 4),  # the widest stack K3 takes
    (torch.float32, 40, 32, 6),  # K > 4: pass 2 gathers again
    (torch.float16, 160, 128, 4),  # the flagship stack in f16
])
def test_lift_topk_bwd_bins_match_plain(cuda, dtype, channels, dim, k):
  """K3 where its sorting by lower-tap pixel matters: a pile-up on one
  pixel, tile and view edges, an empty view."""
  args, g_stats, kwargs = _binned_lift_bwd_inputs(cuda, dtype, channels, dim,
                                                  k)
  counts = chip_smoke.lift_bwd_bin_counts(*args[1:4], views=3, h=45, w=60)
  assert counts.max() >= 4000 and not counts[:, 1].any()
  before = kernels.LAUNCHES['lift_topk_bwd']
  got = kernels.lift_topk_bwd(*args, g_stats, **kwargs)
  assert kernels.LAUNCHES['lift_topk_bwd'] == before + 1
  want = view_scan.lift_topk_bwd_plain(*args, g_stats, **kwargs)
  torch.cuda.synchronize()
  views = want.reshape(2, 3, 46, 61, -1)
  assert not views[:, 1].any()
  # The last pixel row and column are reached; the pad row and column only
  # with a tap weight of 0.
  assert views[:, :, 44].abs().max() > 0 and views[:, :, :, 59].abs().max() > 0
  assert not views[:, :, 45].any() and not views[:, :, :, 60].any()
  torch.testing.assert_close(got.float(), want.float(),
                             **BWD_TOLERANCES[dtype])


def _edge_plane_inputs(device, dtype, dim, has_valid, seed=4):
  """A plane of 11 x 8 cells and points on every edge of it (low, high,
  cell centres, just inside and just outside) and at random."""
  g = torch.Generator(device='cpu').manual_seed(seed)
  b, h, w = 2, 11, 8
  plane = torch.randn((b, h + 1, w + 1, dim + int(has_valid)), generator=g)
  if has_valid:
    plane[..., dim] = (plane[..., dim] > -1.0).float()
  rows = torch.tensor([-1e-3, 0.0, 0.25, 0.5, 0.75, 1.0, h - 1.0, h - 0.5,
                       h - 0.25, h - 1e-4, h, h + 0.3])
  cols = torch.tensor([-1e-3, 0.0, 0.3, 0.5, 1.5, w - 1.0, w - 0.5, w - 0.2,
                       w - 1e-4, w, w + 0.5, 3.0])
  edges = torch.stack(torch.meshgrid(rows, cols, indexing='ij'), -1)
  points = torch.rand((b, 3000, 2), generator=g) * torch.tensor(
      [h + 2.0, w + 2.0]) - 1
  points = torch.cat([edges.reshape(1, -1, 2).expand(b, -1, -1), points], 1)
  return [plane.to(dtype).to(device), points.contiguous().to(device)], dict(
      dim=dim, has_valid=has_valid)


@pytest.mark.parametrize('dim,has_valid', [(17, True), (32, True),
                                           (32, False)])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_patch_sample_2d_edges_match_plain(cuda, dtype, dim, has_valid):
  """K2's 16-byte chunks with a tail (D = 17) and without (D = 32)."""
  args, kwargs = _edge_plane_inputs(cuda, dtype, dim, has_valid)
  before = kernels.LAUNCHES['patch_sample_2d']
  values, valid = kernels.patch_sample_2d(*args, **kwargs)
  assert kernels.LAUNCHES['patch_sample_2d'] == before + 1
  values_p, valid_p = view_scan.patch_sample_2d_plain(*args, **kwargs)
  torch.cuda.synchronize()
  assert torch.equal(valid, valid_p) and valid.any() and not valid.all()
  torch.testing.assert_close(values.float(), values_p.float(),
                             **TOLERANCES[dtype])


@pytest.mark.parametrize('k', [4, 6])
def test_lift_bwd_bin_counts_bin_every_selected_rank(k):
  """The count of K3's bins that chip_smoke.py prints: each selected rank
  on the pixel of its clamped lower tap, in its example and view; nothing
  else counted."""
  args, _, _ = _binned_lift_bwd_inputs('cpu', torch.float32, 40, 32, k)
  _, view_idx, p2d, select, _ = args
  counts = chip_smoke.lift_bwd_bin_counts(view_idx, p2d, select, views=3,
                                          h=45, w=60)
  assert counts.shape == (2, 3, 45, 60)
  want = torch.zeros((2, 3, 45, 60), dtype=torch.int64)
  li = torch.clamp(p2d[..., 0] - 0.5, 0, 44).floor().long()
  lj = torch.clamp(p2d[..., 1] - 0.5, 0, 59).floor().long()
  for e, n, r in select.nonzero().tolist():
    want[e, view_idx[e, n, r], li[e, n, r], lj[e, n, r]] += 1
  assert torch.equal(counts, want)
  assert int(counts.sum()) == int(select.sum())
  assert counts[0, 0, 19, 33] >= 1000 * k  # the pile-up
  assert not counts[:, 1].any()


def test_backward_kernels_batches_are_independent(cuda):
  """Each example of a batch-2 launch of K3 and K4 equals that example
  launched alone: the kernels' per-example offsets."""
  args, g_stats, kwargs = _raw_lift_bwd_inputs(cuda, torch.float32, 40, 32)
  both = kernels.lift_topk_bwd(*args, g_stats, **kwargs)
  for i in range(2):
    alone = [t[i:i + 1].contiguous() for t in (*args, g_stats)]
    torch.testing.assert_close(kernels.lift_topk_bwd(*alone, **kwargs),
                               both[i:i + 1],
                               **BWD_TOLERANCES[torch.float32])
  (padded, points), _ = _plane_inputs(cuda, torch.float32)
  g = torch.randn(points.shape[:2] + (17,), device=cuda)
  both = kernels.patch_sample_2d_bwd(g, points,
                                     plane_shape=tuple(padded.shape))
  for i in range(2):
    alone = kernels.patch_sample_2d_bwd(
        g[i:i + 1].contiguous(), points[i:i + 1].contiguous(),
        plane_shape=(1,) + tuple(padded.shape[1:]))
    torch.testing.assert_close(alone, both[i:i + 1],
                               **BWD_TOLERANCES[torch.float32])


def _pileup_sample_bwd_inputs(device, dtype, dim, seed=9):
  """K4 inputs on a plane of 11 x 8 cells, 8,000 points an example: every
  point of example 0 on one cell (a run of 8,000, longer than a walker's
  chunk and than a block's slots), and in example 1 5,000 points past the
  far corner and 1,000 past the near one (the clamp piles them onto the
  corner cells), the rest spread over the plane and one cell past it."""
  g = torch.Generator(device='cpu').manual_seed(seed)
  b, h, w, p = 2, 11, 8, 8000
  points = torch.rand((b, p, 2), generator=g) * torch.tensor(
      [h + 2.0, w + 2.0]) - 1
  points[0] = torch.tensor([5.3, 4.7])
  points[1, :5000] = torch.tensor([h + 3.0, w + 5.0])
  points[1, 5000:6000] = torch.tensor([-2.0, -3.0])
  g_values = torch.randn((b, p, dim), generator=g).to(dtype)
  return (g_values.to(device), points.to(device)), dict(
      plane_shape=(b, h + 1, w + 1, dim + 1))


def _template_sample_bwd_inputs(device, dtype, dim, seed=10):
  """K4 inputs where the templates read the query BEV
  (``pose_exhaustive_voting.template_points``) on a 24 x 16 plane: 8
  rotations a batch of 2 (0, a right angle and six others), in template
  order, the rotated corners off the plane."""
  g = torch.Generator(device='cpu').manual_seed(seed)
  b, h, w = 2, 24, 16
  angles = torch.cat([torch.tensor([0.0, math.pi / 2]),
                      torch.rand(6, generator=g) * 2 * math.pi])
  points = pev.template_points(angles, grids.Grid2D((h, w), 0.5), b)
  g_values = torch.randn((b, points.shape[1], dim), generator=g).to(dtype)
  return (g_values.to(device), points.contiguous().to(device)), dict(
      plane_shape=(b, h + 1, w + 1, dim + 1))


SAMPLE_BWD_CASES = {'pileup': _pileup_sample_bwd_inputs,
                    'templates': _template_sample_bwd_inputs}


@pytest.mark.parametrize('dim', [17, 32])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize('case', sorted(SAMPLE_BWD_CASES))
def test_patch_sample_2d_bwd_sorted_runs_match_plain(cuda, case, dtype, dim):
  """K4 where its sort by lower-tap cell matters: a pile-up on one cell
  and on the clamped corners (runs across walkers and blocks), and the
  templates' own order and border clamping."""
  args, kwargs = SAMPLE_BWD_CASES[case](cuda, dtype, dim)
  counts = chip_smoke.sample_bwd_bin_counts(args[1], kwargs['plane_shape'])
  if case == 'pileup':
    assert counts[0].max() == 8000 and counts[1, -1, -1] >= 5000
  before = kernels.LAUNCHES['patch_sample_2d_bwd']
  got = kernels.patch_sample_2d_bwd(*args, **kwargs)
  assert kernels.LAUNCHES['patch_sample_2d_bwd'] == before + 1
  want = view_scan.patch_sample_2d_bwd_plain(*args, **kwargs)
  torch.cuda.synchronize()
  assert got.dtype == dtype and not got[..., dim].any()
  torch.testing.assert_close(got.float(), want.float(),
                             **BWD_TOLERANCES[dtype])


@pytest.mark.parametrize('case', sorted(SAMPLE_BWD_CASES))
def test_sample_bwd_bin_counts_bin_every_point(case):
  """The count of K4's bins that chip_smoke.py prints: each point on the
  cell of its clamped lower tap, in its example; nothing else counted."""
  (_, points), kwargs = SAMPLE_BWD_CASES[case]('cpu', torch.float32, 4)
  b, hp, wp, _ = kwargs['plane_shape']
  counts = chip_smoke.sample_bwd_bin_counts(points, kwargs['plane_shape'])
  assert counts.shape == (b, hp - 1, wp - 1)
  want = torch.zeros((b, hp - 1, wp - 1), dtype=torch.int64)
  for e in range(b):
    for i, j in points[e].tolist():
      li = min(max(math.floor(np.float32(i) - np.float32(0.5)), 0), hp - 2)
      lj = min(max(math.floor(np.float32(j) - np.float32(0.5)), 0), wp - 2)
      want[e, li, lj] += 1
  assert torch.equal(counts, want)
  assert int(counts.sum()) == points.shape[0] * points.shape[1]
  if case == 'pileup':
    assert counts[0, 4, 4] == 8000
    assert counts[1, -1, -1] >= 5000 and counts[1, 0, 0] >= 1000
  else:  # the rotated corners clamp onto the border
    border = counts.clone()
    border[:, 1:-1, 1:-1] = 0
    assert border.sum() > counts.sum() // 8


def _scoring_inputs(device, seed=0, b=2, n=300, h=20, w=24, p=3000,
                    cell=0.5):
  """B4 inputs with transformed points on cell edges and borders (angles 0
  and pi / 2, whole-cell translations, points at cell edges), inside the
  map and off it; some points and map cells invalid."""
  g = torch.Generator(device='cpu').manual_seed(seed)
  angle = (torch.rand((b, p), generator=g) * 2 - 1) * math.pi
  t = torch.rand((b, p, 2), generator=g) * torch.tensor(
      [h * cell + 2, w * cell + 2]) - 1
  edge0, edge1 = min(p, 500), min(p, 800)
  angle[:, :edge0] = 0.0
  angle[:, edge0:edge1] = math.pi / 2
  t[:, :edge1] = torch.randint(-2, min(h, w) + 2, (b, edge1, 2),
                               generator=g).float() * cell
  xy = torch.rand((b, n, 2), generator=g) * 8 - 4
  edge = min(n, 60)
  xy[:, :edge] = torch.randint(-4, 5, (b, edge, 2),
                               generator=g).float() * cell
  sim = torch.randn((b, n, h, w), generator=g)
  valid_points = torch.rand((b, n), generator=g) < 0.8
  valid_map = torch.rand((b, h, w), generator=g) < 0.9
  args = [x.to(device) for x in (angle, t, sim, xy, valid_points, valid_map)]
  return args, cell


@pytest.mark.parametrize('mask', [False, True])
def test_pose_scoring_matches_plain(cuda, mask):
  args, cell = _scoring_inputs(cuda)
  kwargs = dict(cell_size=cell, mask_out_of_bounds=mask)
  before = kernels.LAUNCHES['pose_scoring']
  poses = geometry.Transform2D(angle=args[0], t=args[1])
  got = pose_estimation.pose_scoring_many(
      poses, *args[2:], grids.Grid2D(tuple(args[2].shape[-2:]), cell), mask)
  assert kernels.LAUNCHES['pose_scoring'] == before + 1
  want = pose_estimation.pose_scoring_plain(*args, **kwargs)
  torch.cuda.synchronize()
  # Each (pose, point) term is the plain version's to the bit; the sums
  # over 300 points of O(1) terms differ by order.
  torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-5)
  on_cpu = pose_estimation.pose_scoring_plain(
      *(a.cpu() for a in args), **kwargs)
  torch.testing.assert_close(got.cpu(), on_cpu, atol=1e-4, rtol=1e-5)


# B7 against its plain version on the card: each added value is the plain
# version's to the bit, and both add a cell's values in one order (runs of
# 32 poses, each in ascending pose then tap, then the runs;
# csrc/pose_scoring_bwd.cu), so ``d sim`` is the
# plain version's bit for bit (torch.equal), the off-map poses' clamped
# reads piled onto the border cells included. Against the plain version on
# the CPU, the poses whose cos or sin the card's libm and the CPU's round
# an ulp apart add other values (see
# test_pose_scoring_bwd_plain_on_the_card_is_the_cpus): a few hundred N(0,
# 1) cotangents pile onto the border cells, whose f32 sums then differ by
# ~1e-5.
BWD_SCORE_TOL = dict(atol=1e-4, rtol=1e-5)


def _scoring_bwd_inputs(device, seed=0, **kw):
  """``_scoring_inputs`` with a seeded N(0, 1) cotangent ``g [B, P]``, a run
  of 500 identical poses in example 0 (every pose of a point adds into the
  same four cells) and example 1's cotangent zero but for 100 poses."""
  args, cell = _scoring_inputs('cpu', seed=seed, **kw)
  angle, t = args[0], args[1]
  angle[0, 1000:1500] = angle[0, 1000]
  t[0, 1000:1500] = t[0, 1000]
  g = torch.randn(angle.shape, generator=torch.Generator().manual_seed(seed))
  g[1, 100:] = 0.0
  return [x.to(device) for x in (g, *args)], cell


@pytest.mark.parametrize('mask', [False, True])
def test_pose_scoring_bwd_matches_plain(cuda, mask):
  (g, angle, t, sim, xy, valid_points, valid_map), cell = (
      _scoring_bwd_inputs(cuda))
  kwargs = dict(sim_shape=tuple(sim.shape), cell_size=cell,
                mask_out_of_bounds=mask)
  args = (g, angle, t, xy, valid_points, valid_map)
  before = kernels.LAUNCHES['pose_scoring_bwd']
  got = kernels.pose_scoring_bwd(*args, **kwargs)
  assert kernels.LAUNCHES['pose_scoring_bwd'] == before + 1
  want = pose_estimation.pose_scoring_bwd_plain(*args, **kwargs)
  torch.cuda.synchronize()
  assert torch.equal(got, want)
  assert not got[~valid_points].any()  # invalid points' maps are all 0
  on_cpu = pose_estimation.pose_scoring_bwd_plain(
      *(a.cpu() for a in args), **kwargs)
  torch.testing.assert_close(got.cpu(), on_cpu, **BWD_SCORE_TOL)


@pytest.mark.parametrize('mask', [False, True])
@pytest.mark.parametrize('case', ['ragged', 'valid_counts', 'off_map',
                                  'one_cell', 'odd_width'])
def test_pose_scoring_bwd_cases_match_plain(cuda, case, mask):
  """B7 on B4's edge cases ('one_cell': every pose the same, so every
  lane adds into the same four cells of each point's map)."""
  args, kwargs = _scoring_case(case, cuda, mask)
  angle, t, sim, xy, valid_points, valid_map = args
  g = torch.randn(angle.shape, generator=torch.Generator().manual_seed(3)
                  ).to(cuda)
  bwd_args = (g, angle, t, xy, valid_points, valid_map)
  kwargs = dict(kwargs, sim_shape=tuple(sim.shape))
  got = kernels.pose_scoring_bwd(*bwd_args, **kwargs)
  want = pose_estimation.pose_scoring_bwd_plain(*bwd_args, **kwargs)
  torch.cuda.synchronize()
  assert torch.equal(got, want)
  if case == 'off_map' and mask:
    assert not got.any()


def test_pose_scoring_autograd_launches_b4_and_b7(cuda):
  """``pose_scoring_many`` on CUDA tensors: B4 forward, B7 backward, and
  the gradient is B7's."""
  (g, angle, t, sim, xy, valid_points, valid_map), cell = (
      _scoring_bwd_inputs(cuda))
  sim.requires_grad_()
  before = dict(kernels.LAUNCHES)
  scores = pose_estimation.pose_scoring_many(
      geometry.Transform2D(angle=angle, t=t), sim, xy, valid_points,
      valid_map, grids.Grid2D(tuple(sim.shape[-2:]), cell), False)
  scores.backward(g)
  torch.cuda.synchronize()
  assert kernels.LAUNCHES['pose_scoring'] == before['pose_scoring'] + 1
  assert (kernels.LAUNCHES['pose_scoring_bwd']
          == before['pose_scoring_bwd'] + 1)
  want = pose_estimation.pose_scoring_bwd_plain(
      g, angle, t, xy, valid_points, valid_map, sim_shape=tuple(sim.shape),
      cell_size=cell, mask_out_of_bounds=False)
  assert torch.equal(sim.grad, want)


@pytest.mark.parametrize('mask', [False, True])
def test_pose_scoring_bwd_repeat_calls_give_equal_bits(cuda, mask):
  """Ten calls at the training shape (chip_smoke's seeded inputs: 10,001
  poses, 4,652 points, 120 x 160, a run of 2,000 identical poses) give
  the same bits: no sum depends on the order in which blocks or warps
  run."""
  args, kwargs = chip_smoke.seeded_pose_scoring_bwd_inputs('cuda', mask)
  first = kernels.pose_scoring_bwd(*args, **kwargs)
  for _ in range(9):
    assert torch.equal(kernels.pose_scoring_bwd(*args, **kwargs), first)


@pytest.mark.parametrize('mask', [False, True])
def test_pose_scoring_bwd_plain_on_the_card_is_the_cpus(cuda, mask):
  """The plain version (the kernel's oracle) folds each entry's values in
  the same order on the card as on the CPU (``fold_runs``: the same bits
  from the same keys and values). Its values are formed alike on both but
  for cos and sin, which the card's libm and the CPU's round an ulp apart
  at some angles; with those poses' cotangent 0 on both sides (a 0 changes
  no fold), the whole plain version gives the same bits."""
  (g, angle, t, sim, xy, valid_points, valid_map), cell = (
      _scoring_bwd_inputs(cuda))
  apart = ((torch.cos(angle).cpu() != torch.cos(angle.cpu()))
           | (torch.sin(angle).cpu() != torch.sin(angle.cpu())))
  assert apart.float().mean() < 0.5
  g = torch.where(apart.to(cuda), 0.0, g)
  kwargs = dict(sim_shape=tuple(sim.shape), cell_size=cell,
                mask_out_of_bounds=mask)
  args = (g, angle, t, xy, valid_points, valid_map)
  on_card = pose_estimation.pose_scoring_bwd_plain(*args, **kwargs)
  on_cpu = pose_estimation.pose_scoring_bwd_plain(
      *(a.cpu() for a in args), **kwargs)
  assert on_card.abs().max() > 1
  assert torch.equal(on_card.cpu(), on_cpu)
  gen = torch.Generator().manual_seed(1)
  key = torch.randint(0, 500, (200_000,), generator=gen)
  value = torch.randn(200_000, generator=gen) * 10.0 ** torch.randint(
      -4, 5, (200_000,), generator=gen)
  keys, sums = pose_estimation.fold_runs(key, value)
  keys_card, sums_card = pose_estimation.fold_runs(key.to(cuda),
                                                   value.to(cuda))
  order, order_card = torch.argsort(keys), torch.argsort(keys_card)
  assert torch.equal(keys[order], keys_card[order_card].cpu())
  assert torch.equal(sums[order], sums_card[order_card].cpu())


@pytest.mark.parametrize('bad', [math.nan, math.inf])
def test_pose_scoring_bwd_non_finite_cotangent_reaches_its_example(cuda,
                                                                   bad):
  """A non-finite entry of ``g`` gives its example a non-finite gradient
  on the card, as in the plain version; the other example's is the plain
  version's bit for bit."""
  (g, angle, t, sim, xy, valid_points, valid_map), cell = (
      _scoring_bwd_inputs(cuda))
  g[0, 1700] = bad
  kwargs = dict(sim_shape=tuple(sim.shape), cell_size=cell,
                mask_out_of_bounds=False)
  args = (g, angle, t, xy, valid_points, valid_map)
  got = kernels.pose_scoring_bwd(*args, **kwargs)
  want = pose_estimation.pose_scoring_bwd_plain(*args, **kwargs)
  torch.cuda.synchronize()
  assert not torch.isfinite(got[0]).all()
  assert not torch.isfinite(want[0]).all()
  assert torch.equal(got[1], want[1])


def test_pose_scoring_bwd_refuses_maps_too_large_for_shared_memory(cuda):
  g = torch.zeros((1, 3), device=cuda)
  with pytest.raises(ValueError, match='does not fit'):
    kernels.pose_scoring_bwd(
        g, torch.zeros((1, 3), device=cuda), torch.zeros((1, 3, 2),
                                                         device=cuda),
        torch.zeros((1, 1, 2), device=cuda),
        torch.ones((1, 1), dtype=torch.bool, device=cuda),
        torch.ones((1, 300, 200), dtype=torch.bool, device=cuda),
        sim_shape=(1, 1, 300, 200), cell_size=0.2, mask_out_of_bounds=False)


def test_slice_and_table_gather_match_plain(cuda):
  g = torch.Generator(device='cpu').manual_seed(0)
  w, rows, n = 60, 920 * 61, 100_003
  stack = torch.randn((rows, 160), generator=g).to(torch.bfloat16).to(cuda)
  rid = torch.randint(0, rows - w - 2, (n,), generator=g,
                      dtype=torch.int32).to(cuda)
  before = dict(kernels.LAUNCHES)
  got = gathers.slice_gather(stack, rid, w=w)
  want = gathers.slice_gather_plain(stack, rid, w=w)
  table = torch.randn((8, 128), generator=g).to(cuda)
  ids = torch.randint(0, 8, (n,), generator=g, dtype=torch.int32).to(cuda)
  rows_got = gathers.table_gather(table, ids)
  torch.cuda.synchronize()
  assert kernels.LAUNCHES['slice_gather'] == before['slice_gather'] + 1
  assert kernels.LAUNCHES['table_gather'] == before['table_gather'] + 1
  assert torch.equal(got, want)  # both add in f32 and round once
  assert torch.equal(rows_got, gathers.table_gather_plain(table, ids))


def test_new_cuda_launchers_refuse_cpu_tensors():
  args, cell = _scoring_inputs('cpu', p=10)
  with pytest.raises(ValueError, match='needs CUDA'):
    kernels.pose_scoring(*args, cell_size=cell, mask_out_of_bounds=False)
  with pytest.raises(ValueError, match='needs CUDA'):
    kernels.pose_scoring_bwd(
        torch.zeros(args[0].shape), *args[:2], *args[3:],
        sim_shape=tuple(args[2].shape), cell_size=cell,
        mask_out_of_bounds=False)
  with pytest.raises(ValueError, match='needs CUDA'):
    kernels.slice_gather(torch.zeros((200, 16), dtype=torch.bfloat16),
                         torch.zeros(5, dtype=torch.int32), w=9)
  with pytest.raises(ValueError, match='needs CUDA'):
    kernels.table_gather(torch.zeros((8, 128)),
                         torch.zeros(5, dtype=torch.int32))
  before = dict(kernels.LAUNCHES)
  sim = args[2].clone().requires_grad_()
  poses = geometry.Transform2D(angle=args[0], t=args[1])
  scores = pose_estimation.pose_scoring_many(
      poses, sim, *args[3:], grids.Grid2D(tuple(sim.shape[-2:]), cell),
      False)
  scores.sum().backward()  # the plain version on the CPU has a gradient
  assert sim.grad is not None and sim.grad.abs().sum() > 0
  assert kernels.LAUNCHES == before


def _lift_edge_inputs(device, dtype, channels, dim, k, seed=5):
  """K1 inputs: N = 3001 points per example (6,002 in all: K1's last block
  of 128 points and its last warp of 16 are partly empty), 300 points
  with no selected rank, depths on (or within an ulp of) a bin edge and
  past both clamps (the hat on bins 0 and S - 1 alone), pixels past every
  edge."""
  g = torch.Generator(device='cpu').manual_seed(seed)
  b, v, h, w, n = 2, 5, 7, 9, 3001
  lo, hi = 1.0, 32.0
  bins = channels - dim
  stack = torch.randn((b, v * (h + 1), w + 1, channels), generator=g)
  view_idx = torch.randint(0, v, (b, n, k), generator=g, dtype=torch.int32)
  p2d = torch.rand((b, n, k, 2), generator=g) * torch.tensor(
      [h + 2.0, w + 2.0]) - 1
  select = torch.rand((b, n, k), generator=g) < 0.6
  select[:, :300] = False
  depth = torch.rand((b, n, k), generator=g) * 40
  edge = torch.randint(0, bins, (b, 600, k), generator=g).double()
  depth[:, 300:900] = (lo * (hi / lo) ** (edge / (bins - 1))).float()
  depth[:, 900:1000] = 0.25 * lo
  depth[:, 1000:1100] = 4 * hi
  args = [t.to(device) for t in (stack.to(dtype), view_idx, p2d, select,
                                 depth)]
  return args, dict(h=h, w=w, dim=dim, depth_min_max=(lo, hi))


@pytest.mark.parametrize('dtype,channels,dim,k', [
    (torch.float32, 40, 32, 4),
    (torch.bfloat16, 160, 128, 4),
    (torch.float32, 160, 128, 4),  # the RANSAC path's f32 stack
    (torch.float32, 40, 32, 6),  # K > 4: the ranks in two groups
    (torch.bfloat16, 160, 128, 6),
    (torch.float32, 320, 288, 6),  # three channel quads per lane
    (torch.float32, 320, 288, 1),
])
def test_lift_topk_fwd_edges_match_plain(cuda, dtype, channels, dim, k):
  args, kwargs = _lift_edge_inputs(cuda, dtype, channels, dim, k)
  before = kernels.LAUNCHES['lift_topk_fwd']
  stats, valid = kernels.lift_topk_fwd(*args, **kwargs)
  assert kernels.LAUNCHES['lift_topk_fwd'] == before + 1
  stats_p, valid_p = view_scan.lift_topk_plain(*args, **kwargs)
  torch.cuda.synchronize()
  assert torch.equal(valid, valid_p)
  assert not valid[:, :300].any() and not stats[:, :300].any()
  torch.testing.assert_close(stats.float(), stats_p.float(),
                             **TOLERANCES[dtype])


def test_lift_topk_fwd_refuses_unaligned_dim(cuda):
  args, kwargs = _lift_inputs(cuda, torch.float32, 40, 32)
  with pytest.raises(ValueError, match='dim % 4 == 0'):
    kernels.lift_topk_fwd(*args, **{**kwargs, 'dim': 30})


def _scoring_case(case, device, mask, seed=6):
  """B4 inputs for ``case``: 'ragged' (P one pose tile + 37, N = 1,301: no
  whole tile or group), 'valid_counts' (examples with 95%, 5% and no valid
  points), 'off_map' (every pose far off the map), 'one_cell' (every pose
  the same: every lane reads one cell), 'one_point', 'odd_width' (W = 23:
  the maps are copied 4 bytes at a time)."""
  kw = dict(b=2, n=300, h=20, w=24, p=3000)
  if case == 'ragged':
    kw.update(n=1301, p=kernels.POSE_TILE + 37)
  elif case == 'valid_counts':
    kw.update(b=3)
  elif case == 'one_point':
    kw.update(n=1)
  elif case == 'odd_width':
    kw.update(w=23)
  args, cell = _scoring_inputs('cpu', seed=seed, **kw)
  angle, t, sim, xy, valid_points, valid_map = args
  if case == 'valid_counts':
    g = torch.Generator(device='cpu').manual_seed(seed)
    valid_points[0] = torch.rand(kw['n'], generator=g) < 0.95
    valid_points[1] = torch.rand(kw['n'], generator=g) < 0.05
    valid_points[2] = False
  elif case == 'off_map':
    t[:] = torch.tensor([-1000.0, 2000.0])
  elif case == 'one_cell':
    angle[:] = 0.3
    t[:] = torch.tensor([4.1, 5.3])
  elif case == 'one_point':
    valid_points[:] = True
  args = [a.to(device) for a in args]
  return args, dict(cell_size=cell, mask_out_of_bounds=mask)


@pytest.mark.parametrize('mask', [False, True])
@pytest.mark.parametrize('case', ['ragged', 'valid_counts', 'off_map',
                                  'one_cell', 'odd_width'])
def test_pose_scoring_cases_match_plain(cuda, case, mask):
  args, kwargs = _scoring_case(case, cuda, mask)
  before = kernels.LAUNCHES['pose_scoring']
  got = kernels.pose_scoring(*args, **kwargs)
  assert kernels.LAUNCHES['pose_scoring'] == before + 1
  want = pose_estimation.pose_scoring_plain(*args, **kwargs)
  torch.cuda.synchronize()
  torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-5)
  if case == 'valid_counts':
    assert not got[2].any()
  if case == 'off_map':
    assert bool(got.any()) != mask  # clamped reads count without the mask


@pytest.mark.parametrize('mask', [False, True])
def test_pose_scoring_one_point_is_the_plain_term_to_the_bit(cuda, mask):
  """One point: each score is one term, which B4 rounds as the plain
  version does, operation by operation (poses on cell edges and borders
  included)."""
  args, kwargs = _scoring_case('one_point', cuda, mask)
  got = kernels.pose_scoring(*args, **kwargs)
  want = pose_estimation.pose_scoring_plain(*args, **kwargs)
  torch.cuda.synchronize()
  assert torch.equal(got, want)


def test_pose_scoring_refuses_maps_too_large_for_shared_memory(cuda):
  args, kwargs = _scoring_case('one_point', cuda, False)
  angle, t, _, xy, valid_points, _ = args
  sim = torch.zeros((2, 1, 300, 400), device=cuda)
  valid_map = torch.ones((2, 300, 400), dtype=torch.bool, device=cuda)
  with pytest.raises(ValueError, match='does not fit'):
    kernels.pose_scoring(angle, t, sim, xy, valid_points, valid_map,
                         **kwargs)


def _lattice_inputs(device, mask, seed=7):
  """B4 at the RANSAC path's map (120 x 160 cells of 0.2 m) on refinement
  lattices (make_refinement_offsets around one pose an example: each pose
  tile sees a narrow angle range, and each point is staged only where its
  footprint lies), points up to the corners of the query's 24 x 32 m
  range, and every point's map a constant: 1 + n / 512 for points n = 0
  and 1 (mod 4), its negative for 2 and 3. A point's stale read from the
  buffer's previous map (two points back) has the other sign."""
  g = torch.Generator(device='cpu').manual_seed(seed)
  b, n, h, w, cell = 2, 300, 120, 160, 0.2
  init = geometry.Transform2D(
      angle=(torch.rand((b,), generator=g) * 2 - 1) * math.pi,
      t=torch.rand((b, 2), generator=g) * torch.tensor([h * cell, w * cell]))
  offsets, _ = pose_estimation.make_refinement_offsets()
  poses = init.unsqueeze(-1) @ offsets
  xy = torch.rand((b, n, 2), generator=g) * torch.tensor([24.0, 32.0]) - (
      torch.tensor([0.0, 16.0]))
  # 40 points within 0.5 m of the range's far corners (x 24 m, y +-16 m).
  xy[:, :40, 0] = 24.0 - torch.rand((b, 40), generator=g) * 0.5
  xy[:, :40, 1] = torch.tensor([16.0, -16.0]).repeat(20) * (
      1.0 - torch.rand((b, 40), generator=g) * 0.03)
  level = torch.where(torch.arange(n) % 4 < 2, 1.0, -1.0) * (
      1 + torch.arange(n) / 512)
  sim = level[None, :, None, None].expand(b, n, h, w).contiguous()
  valid_points = torch.ones((b, n), dtype=torch.bool)
  valid_map = torch.rand((b, h, w), generator=g) < 0.9
  args = [x.contiguous().to(device) for x in (
      poses.angle, poses.t, sim, xy, valid_points, valid_map)]
  return args, dict(cell_size=cell, mask_out_of_bounds=mask)


@pytest.mark.parametrize('mask', [False, True])
def test_pose_scoring_refinement_lattice_reads_each_points_own_map(cuda,
                                                                   mask):
  args, kwargs = _lattice_inputs(cuda, mask)
  got = kernels.pose_scoring(*args, **kwargs)
  want = pose_estimation.pose_scoring_plain(*args, **kwargs)
  torch.cuda.synchronize()
  assert args[0].shape[-1] == 41**3
  assert kernels.pose_scoring_plan(2, 41**3, 300, sms=132)['tiles'] > 1
  torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-5)


def _tied_lift_inputs(device, k=16, seed=8, weighted=True):
  """K1 inputs in f32 whose every step but the epilogue's divisions is
  exact: each point's ranks read one pixel centre of one view (bilinear
  weights 1, 0, 0, 0) at depth_min (the score is bin 0's value; without
  score bins every selected rank scores 0), and the stack holds bf16
  values, so the softmax weights are 1 and the sums c f and c f^2 over c
  selected ranks are exact. Then mean = f, E2 = f^2 and E2 - mean^2 = 0
  exactly, where the quotients are correctly rounded. Blocks of points
  select none, one, 2-4, 5-8 (where k > 4) and every rank, at random
  places."""
  g = torch.Generator(device='cpu').manual_seed(seed)
  b, v, h, w, n, dim = 2, 3, 7, 9, 2000, 32
  channels = dim + (8 if weighted else 0)
  lo, hi = 1.0, 32.0
  stack = torch.randn((b, v * (h + 1), w + 1, channels),
                      generator=g).to(torch.bfloat16).float()
  view = torch.randint(0, v, (b, n, 1), generator=g, dtype=torch.int32)
  pixel = torch.stack([torch.randint(0, h, (b, n), generator=g),
                       torch.randint(0, w, (b, n), generator=g)], -1)
  view_idx = view.expand(b, n, k).contiguous()
  p2d = (pixel.float() + 0.5)[:, :, None, :].expand(b, n, k, 2).contiguous()
  select = _blocks_of_selections(g, b, n, k)
  depth = torch.full((b, n, k), lo)
  args = [t.to(device) for t in (stack, view_idx, p2d, select, depth)]
  return args, dict(h=h, w=w, dim=dim, depth_min_max=(lo, hi))


def _blocks_of_selections(g, b, n, k):
  """select [b, n, k]: five blocks of points (in order) selecting none,
  one, 2-4, 5-8 (where k > 4) and every rank, at random places."""
  low = torch.tensor([0, 1, 2, 5, k]).clamp(max=k)
  high = torch.tensor([0, 1, 4, 8, k]).clamp(max=k)
  kind = torch.arange(n) * 5 // n
  count = low[kind] + (torch.rand((b, n), generator=g) * (
      high[kind] - low[kind] + 1)).long()
  order = torch.rand((b, n, k), generator=g).argsort(-1).argsort(-1)
  return order < count[..., None]


@pytest.mark.parametrize('layout,k', [
    ((True, True, False), 16), ((True, True, False), 4),
    ((True, True, False), 20), ((True, True, True), 4), ((True, True, True), 20),
    ((False, True, False), 4), ((False, True, False), 20),
    ((False, True, True), 4), ((False, True, True), 20)])
def test_lift_topk_fwd_tied_stats_are_the_plain_versions_to_the_bit(
    cuda, layout, k):
  """Where E2 - mean^2 is exactly 0, K1's stats are the plain version's bit
  for bit: a quotient an ulp off would leave a variance of an ulp (or
  clamp another point's), the tie K3's backward splits (C7). In every
  layout with the variance (the flagship's and B8's), at the stream's 4
  ranks and the scan's 20, so that B8's points with at most 4 selected
  ranks (one compile-time group) and with more (the runtime loop over
  their compacted ranks) both run."""
  weighted, use_variance, add_minmax = layout
  args, kwargs = _tied_lift_inputs(cuda, k, weighted=weighted)
  kwargs.update(use_variance=use_variance, add_minmax=add_minmax)
  n = args[3].sum(-1)
  assert (n == 0).any() and (n == 1).any() and (n == k).any()
  assert k == 4 or ((n > 4) & (n < k)).any()
  stats, valid = kernels.lift_topk_fwd(*args, **kwargs)
  stats_p, valid_p = view_scan.lift_topk_plain(*args, **kwargs)
  torch.cuda.synchronize()
  assert torch.equal(valid, valid_p)
  assert torch.equal(stats, stats_p)
  dim = kwargs['dim']
  assert not stats[..., dim:2 * dim].any()  # every variance is exactly 0


@pytest.mark.parametrize('k', [4, 20])
@pytest.mark.parametrize('layout', [(True, True, False), (True, True, True),
                                    (True, False, True), (True, False, False)])
def test_lift_topk_fwd_scores_and_extremes_are_the_plain_versions_to_the_bit(
    cuda, layout, k):
  """Each weighted layout's score max, and the max and min of the features,
  are the plain version's bit for bit at depths off the bins' centres: the
  score is RN(RN(a h0) + RN(b h1)) in both (the two bins around the depth;
  a fused product would be an ulp off at times), the scores K3 recomputes.
  Each rank reads a pixel centre of f32 values (bilinear weights 1, 0, 0,
  0: its features and bins are the pixel's, exactly), and depth_min 1 with
  a log range of 4 makes the bins' abscissa the same whether divided or
  multiplied by the reciprocal (as torch divides by a scalar on the card).
  The mean and variance, sums of softmax weights, are held to the f32
  tolerance."""
  _, use_variance, add_minmax = layout
  g = torch.Generator(device='cpu').manual_seed(9)
  b, v, h, w, n, dim, bins = 2, 3, 7, 9, 2000, 32, 8
  lo, hi = 1.0, math.exp(4.0)
  assert float(torch.tensor(math.log(hi / lo))) == 4.0
  stack = torch.randn((b, v * (h + 1), w + 1, dim + bins), generator=g)
  view_idx = torch.randint(0, v, (b, n, k), generator=g, dtype=torch.int32)
  pixel = torch.stack([torch.randint(0, h, (b, n, k), generator=g),
                       torch.randint(0, w, (b, n, k), generator=g)], -1)
  select = _blocks_of_selections(g, b, n, k)
  depth = 0.5 + torch.rand((b, n, k), generator=g) * (hi + 5.0)
  args = [t.to(cuda) for t in (stack, view_idx, pixel.float() + 0.5, select,
                               depth)]
  kwargs = dict(h=h, w=w, dim=dim, depth_min_max=(lo, hi),
                use_variance=use_variance, add_minmax=add_minmax)
  stats, valid = kernels.lift_topk_fwd(*args, **kwargs)
  stats_p, valid_p = view_scan.lift_topk_plain(*args, **kwargs)
  torch.cuda.synchronize()
  assert torch.equal(valid, valid_p)
  exact = dim * (1 + use_variance)  # the extremes and the score max
  assert torch.equal(stats[..., exact:], stats_p[..., exact:])
  torch.testing.assert_close(stats[..., :exact], stats_p[..., :exact],
                             **TOLERANCES[torch.float32])
  # The roundings differ here: the products fused into the sum (exact in
  # f64) give other scores than the plain version's at some ranks.
  hat = view_fusion.depth_hat_weights(depth, bins, (lo, hi))
  bins_read = stack[torch.arange(b)[:, None, None],
                    view_idx * (h + 1) + pixel[..., 0], pixel[..., 1], dim:]
  assert ((bins_read * hat).sum(-1) != (bins_read.double() * hat).sum(
      -1).float())[select].any()


@pytest.mark.parametrize('layout', [(True, True, True), (True, False, True),
                                    (True, False, False), (False, True, False),
                                    (False, True, True), (False, False, True),
                                    (False, False, False)])
def test_lift_topk_fwd_b8_bf16_keeps_three_blocks_without_spills(cuda,
                                                                 layout):
  """K1's bf16 instantiations of B8's layouts at phase 7j's widths (128
  features; 32 score bins when weighted): no local memory (spills or
  stack) within the bf16 launch bound, and 3 blocks of 256 threads an SM."""
  _assert_three_blocks_without_spills(cuda, layout, torch.bfloat16)


@pytest.mark.parametrize('layout', [(True, True, False), (True, True, True),
                                    (True, False, True), (True, False, False),
                                    (False, True, False), (False, True, True),
                                    (False, False, True), (False, False, False)])
def test_lift_topk_fwd_f16_takes_the_bf16_resources(cuda, layout):
  """K1's f16 instantiations, the flagship's layout and B8's, under bf16's
  launch bound (the same width): 3 blocks of 256 threads an SM, and no
  more local memory (spills, stack) than the bf16 instantiation of the
  layout (none in B8's layouts)."""
  bf16 = _assert_three_blocks_without_spills(cuda, layout, torch.bfloat16,
                                             spills=True)
  f16 = _assert_three_blocks_without_spills(cuda, layout, torch.float16,
                                            spills=True)
  assert f16['local_bytes'] <= bf16['local_bytes'], (f16, bf16)
  if layout != (True, True, False):
    assert bf16['local_bytes'] == 0, bf16


def _assert_three_blocks_without_spills(cuda, layout, dtype, spills=False):
  """K1 in ``layout`` and ``dtype`` at phase 7j's widths against its plain
  version; 3 blocks of 256 threads an SM, and no local memory unless
  ``spills``. Returns the launch's resources."""
  weighted, use_variance, add_minmax = layout
  g = torch.Generator(device='cpu').manual_seed(13)
  b, v, h, w, n, k, dim = 2, 3, 7, 9, 500, 20, 128
  c = dim + (32 if weighted else 0)
  stack = torch.randn((b, v * (h + 1), w + 1, c), generator=g)
  view_idx = torch.randint(0, v, (b, n, k), generator=g, dtype=torch.int32)
  p2d = torch.rand((b, n, k, 2), generator=g) * torch.tensor([h, w + 0.0])
  select = torch.rand((b, n, k), generator=g) < 0.2
  depth = torch.rand((b, n, k), generator=g) * 40
  args = [t.to(cuda) for t in (stack.to(dtype), view_idx, p2d, select,
                               depth)]
  kwargs = dict(h=h, w=w, dim=dim, depth_min_max=(1.0, 32.0),
                use_variance=use_variance, add_minmax=add_minmax)
  stats, valid = kernels.lift_topk_fwd(*args, **kwargs)
  launch, = kernels.occupancy('lift_topk_fwd')
  assert spills or launch['local_bytes'] == 0, launch
  assert launch['threads'] == 256 and launch['blocks_per_sm'] == 3, launch
  stats_p, valid_p = view_scan.lift_topk_plain(*args, **kwargs)
  torch.cuda.synchronize()
  assert torch.equal(valid, valid_p)
  torch.testing.assert_close(stats.float(), stats_p.float(),
                             **TOLERANCES[dtype])
  return launch


def test_occupancy_reports_each_launch_of_the_last_call(cuda):
  args, kwargs = _lift_inputs(cuda, torch.bfloat16, 160, 128)
  kernels.lift_topk_fwd(*args, **kwargs)
  launch, = kernels.occupancy('lift_topk_fwd')
  assert launch['name'] == 'lift_topk_fwd_kernel'
  assert launch['threads'] == 256 and launch['blocks_per_sm'] >= 1
  assert launch['dynamic_smem'] > 0 and launch['registers'] > 0
  args, kwargs = _scoring_case('ragged', cuda, False)
  kernels.pose_scoring(*args, **kwargs)
  names = [o['name'] for o in kernels.occupancy('pose_scoring')]
  assert names == ['pose_scoring_kernel', 'sum_groups_kernel']
  scoring, _ = kernels.occupancy('pose_scoring')
  assert scoring['blocks_per_sm'] == 1
  assert scoring['dynamic_smem'] == kernels.pose_scoring_smem_bytes(
      20, 24, kernels.pose_scoring_plan(2, kernels.POSE_TILE + 37, 1301,
                                        sms=torch.cuda.get_device_properties(
                                            cuda).multi_processor_count)[
                                                'group'], False)
  (g_values, points), kwargs = _pileup_sample_bwd_inputs(
      cuda, torch.bfloat16, 32)
  kernels.patch_sample_2d_bwd(g_values, points, **kwargs)
  names = [o['name'] for o in kernels.occupancy('patch_sample_2d_bwd')]
  assert names == ['bin_points_kernel', 'scan_kernel', 'keys_kernel',
                   'order_bins_kernel', 'place_points_kernel',
                   'sum_runs_kernel', 'fold_kernel']
  (g, angle, t, sim, xy, valid_points, valid_map), cell = (
      _scoring_bwd_inputs(cuda))
  kernels.pose_scoring_bwd(g, angle, t, xy, valid_points, valid_map,
                           sim_shape=tuple(sim.shape), cell_size=cell,
                           mask_out_of_bounds=True)
  prep, scatter = kernels.occupancy('pose_scoring_bwd')
  assert prep['name'] == 'pose_prep_kernel'
  assert scatter['name'] == 'pose_scoring_bwd_kernel'
  assert scatter['dynamic_smem'] == kernels.pose_scoring_bwd_smem_bytes(
      20, 24, True)


@pytest.mark.parametrize('b,p,n', [(4, 20_001, 4652), (4, 68_921, 4652),
                                   (2, 7_205, 1301), (1, 5, 1),
                                   (3, 100, 5000)])
def test_pose_scoring_plan_covers_every_pose_and_point(b, p, n):
  plan = kernels.pose_scoring_plan(b, p, n, sms=132)
  tiles, groups, group = plan['tiles'], plan['groups'], plan['group']
  assert (tiles - 1) * kernels.POSE_TILE < p <= tiles * kernels.POSE_TILE
  assert (groups - 1) * group < n <= groups * group
  assert group <= kernels.POSE_MAX_GROUP
  assert plan['blocks'] == tiles * groups * b
  assert kernels.pose_scoring_smem_bytes(120, 160, group, True) <= (
      kernels.MAX_DYNAMIC_SMEM)


def test_pose_scoring_bwd_keeps_two_blocks_per_sm_on_the_training_map():
  """B7's block at the RANSAC path's 120 x 160 map: the point's f32 map
  (4 padded planes), two tiles of slots, the producer warps' marks and the
  valid map's bits fit twice in an SM's 228 KB of shared memory."""
  for mask in (False, True):
    assert 2 * (kernels.pose_scoring_bwd_smem_bytes(120, 160, mask)
                + 1024) <= 228 * 1024
  assert kernels.pose_scoring_bwd_smem_bytes(300, 200, False) > (
      kernels.MAX_DYNAMIC_SMEM)


def test_pose_scoring_plan_fills_whole_waves_on_the_main_path():
  """B4's grid at the RANSAC path's calls on 132 SMs: the last wave is
  (nearly) full."""
  for poses in (20_001, 68_921):
    waves = kernels.pose_scoring_plan(4, poses, 4652, sms=132)['waves']
    assert math.ceil(waves) - waves <= 0.1, (poses, waves)
  assert kernels.pose_scoring_smem_bytes(300, 400, 1, False) > (
      kernels.MAX_DYNAMIC_SMEM)


def _rn32(x):
  """The f32 nearest to the rational ``x`` (ties to even; normal range)."""
  if x == 0:
    return 0.0
  sign, x = (-1, -x) if x < 0 else (1, x)
  e = x.numerator.bit_length() - x.denominator.bit_length()
  if x < Fraction(2) ** e:
    e -= 1
  m = x / Fraction(2) ** (e - 23)  # in [2^23, 2^24)
  q, r = divmod(m.numerator, m.denominator)
  twice = 2 * r
  if twice > m.denominator or (twice == m.denominator and q % 2):
    q += 1
  return sign * float(Fraction(q) * Fraction(2) ** (e - 23))


@pytest.mark.parametrize('cell', [0.2, 0.5, 0.25, 0.1, 1 / 3])
def test_pose_scoring_division_is_correctly_rounded(cell):
  """B4 divides by the cell as q = a r, q + (a - cell q) r with r the
  rounded reciprocal (csrc/pose_scoring.cu:div_rn, Markstein): exactly
  the rounded quotient that __fdiv_rn and the plain version give, checked
  in exact arithmetic on f32 numerators of the maps' range and beyond."""
  rng = np.random.default_rng(0)
  a = np.concatenate([
      rng.uniform(-200, 200, 1500),
      rng.uniform(1, 2, 1000) * 2.0 ** rng.integers(-30, 30, 1000),
      np.arange(-40, 41) * 0.1, np.arange(-40, 41) * cell]).astype(np.float32)
  b = Fraction(float(np.float32(cell)))
  r = Fraction(_rn32(1 / b))
  for value in a:
    x = Fraction(float(value))
    if x == 0:
      continue
    q = Fraction(_rn32(x * r))
    rem = Fraction(_rn32(x - b * q))
    assert rem == x - b * q  # the FMA remainder is exact
    assert _rn32(q + rem * r) == _rn32(x / b), float(value)


# B8: K1's and K3's statistics layouts besides the flagship's (weighted,
# variance), as (weighted, use_variance, add_minmax).
LAYOUTS = [(w, v, m) for w in (True, False) for v in (True, False)
           for m in (False, True)]
B8_LAYOUTS = [layout for layout in LAYOUTS if layout != (True, True, False)]


def _b8_inputs(device, dtype, weighted, k, case='mixed', seed=11):
  """K1 and K3 inputs of a layout: 3,000 points an example on 5 views of
  7 x 9 pixels (pixels past every edge), 32 features (and 8 score bins
  when weighted); the first 200 points with no selected rank. ``case``:
  'mixed', 200 with one and ~60% of the ranks of the rest selected, and in
  1,000 points the second half of the ranks repeats the first, all
  selected (exact ties of every channel and score); 'sparse', the scan's
  kind, ~4 selected a point (1 of 4 ranks at K = 4), 200 points with
  theirs only in the last 4 lanes, 200 with 5-8 (every rank at K = 4) and
  300 whose last rank repeats their first, both selected; 'dense', every
  rank selected, the second half repeating the first."""
  g = torch.Generator(device='cpu').manual_seed(seed)
  b, v, h, w, n, dim = 2, 5, 7, 9, 3000, 32
  c = dim + (8 if weighted else 0)
  stack = torch.randn((b, v * (h + 1), w + 1, c), generator=g)
  view_idx = torch.randint(0, v, (b, n, k), generator=g, dtype=torch.int32)
  p2d = torch.rand((b, n, k, 2), generator=g) * torch.tensor(
      [h + 2.0, w + 2.0]) - 1
  draw = torch.rand((b, n, k), generator=g)
  depth = torch.rand((b, n, k), generator=g) * 40
  half = k // 2
  if case == 'mixed':
    select = draw < 0.6
    select[:, 200:400] = False
    select[:, 200:400, k - 1] = True
    tie = slice(400, 1400)
    for t in (view_idx, p2d, depth):
      t[:, tie, half:2 * half] = t[:, tie, :half]
    select[:, tie, :2 * half] = True
  elif case == 'sparse':
    select = draw < min(0.25, 3.7 / k)
    select[:, 200:400] = False
    select[:, 200:400, k - 4:] = torch.rand((b, 200, 4), generator=g) < 0.6
    many = torch.randint(5, 9, (b, 200, 1), generator=g)
    order = torch.rand((b, 200, k), generator=g).argsort(-1).argsort(-1)
    select[:, 400:600] = order < many
    tie = slice(600, 900)
    for t in (view_idx, p2d, depth):
      t[:, tie, k - 1] = t[:, tie, 0]
    select[:, tie, 0] = select[:, tie, k - 1] = True
  else:
    select = torch.ones((b, n, k), dtype=torch.bool)
    for t in (view_idx, p2d, depth):
      t[:, :, half:2 * half] = t[:, :, :half]
  select[:, :200] = False
  args = [t.to(device) for t in (stack.to(dtype), view_idx, p2d, select,
                                 depth)]
  return args, dict(h=h, w=w, dim=dim, depth_min_max=(1.0, 32.0))


@pytest.mark.parametrize('case', ['mixed', 'sparse', 'dense'])
@pytest.mark.parametrize('k', [4, 20])  # the stream's ranks, the scan's
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize('layout', B8_LAYOUTS)
def test_lift_b8_layouts_match_plain(cuda, layout, dtype, k, case):
  """B8: K1 and K3 through the autograd wrapper against their plain
  versions, forward and backward (the cotangent scaled and freed of near
  ties as chip_smoke.py frees it: exact ties stay); K3 through its narrow
  stage (at most 4 selected ranks a point) and its wide one."""
  weighted, use_variance, add_minmax = layout
  args, kwargs = _b8_inputs(cuda, dtype, weighted, k, case)
  kwargs.update(use_variance=use_variance, add_minmax=add_minmax)
  stack = args[0].clone().requires_grad_()
  before = dict(kernels.LAUNCHES)
  stats, valid = view_scan.lift_topk(stack, *args[1:], **kwargs)
  assert kernels.LAUNCHES['lift_topk_fwd'] == before['lift_topk_fwd'] + 1
  assert stats.shape[-1] == kernels.stats_width(32, *layout)
  stats_p, valid_p = view_scan.lift_topk_plain(*args, **kwargs)
  torch.cuda.synchronize()
  assert torch.equal(valid, valid_p)
  assert not valid[:, :200].any() and not stats[:, :200].any()
  torch.testing.assert_close(stats.float(), stats_p.float(),
                             **TOLERANCES[dtype])
  g = chip_smoke.unit_cotangent(
      torch.randn(stats.shape, device=cuda).to(dtype))
  (got,) = torch.autograd.grad(stats, stack, g)
  assert kernels.LAUNCHES['lift_topk_bwd'] == before['lift_topk_bwd'] + 1
  stages = [o['name'] for o in kernels.occupancy('lift_topk_bwd')]
  assert ('wide_ranks_kernel' in stages) == (k > 4)
  want = view_scan.lift_topk_bwd_plain(*args, g, **kwargs)
  torch.cuda.synchronize()
  assert want.abs().max() > 0.1
  torch.testing.assert_close(got.float(), want.float(),
                             **BWD_TOLERANCES[dtype])


REPEAT_CALLS = 10


def _equal_bits_over_calls(call, calls: int = REPEAT_CALLS):
  """``call()`` ``calls`` times: every output's bits must be the first's.
  Returns the first output."""
  first = call()
  for i in range(1, calls):
    again = call()
    if not torch.equal(again.view(torch.uint8), first.view(torch.uint8)):
      differ = int((again.float() != first.float()).sum())
      raise AssertionError(f'call {i + 1} of {calls} differs from the first '
                           f'in {differ} entries')
  return first


@pytest.mark.parametrize('k', [4, 20])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize('layout', LAYOUTS)
def test_lift_topk_bwd_repeat_calls_give_equal_bits(cuda, layout, dtype, k):
  """K3 sums every entry in one order fixed by its inputs (ROADMAP C20):
  ten calls on one input give the same bits, in every statistics layout
  and dtype, through the narrow stage and the wide one; and they agree
  with the plain version as before."""
  weighted, use_variance, add_minmax = layout
  args, kwargs = _b8_inputs(cuda, dtype, weighted, k, 'mixed')
  kwargs.update(use_variance=use_variance, add_minmax=add_minmax)
  width = kernels.stats_width(32, *layout)
  g = chip_smoke.unit_cotangent(
      torch.randn((*args[1].shape[:2], width), device=cuda).to(dtype))
  got = _equal_bits_over_calls(
      lambda: kernels.lift_topk_bwd(*args, g, **kwargs))
  want = view_scan.lift_topk_bwd_plain(*args, g, **kwargs)
  torch.cuda.synchronize()
  assert want.abs().max() > 0.1
  torch.testing.assert_close(got.float(), want.float(),
                             **BWD_TOLERANCES[dtype])


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_lift_topk_bwd_pileup_repeat_calls_give_equal_bits(cuda, dtype):
  """K3 on a pixel with 4,000 or more ranks, a bin longer than one block
  of its run stage (its pieces folded in block order), tile and view
  edges: ten calls give the same bits."""
  args, g_stats, kwargs = _binned_lift_bwd_inputs(cuda, dtype, 160, 128, 4)
  got = _equal_bits_over_calls(
      lambda: kernels.lift_topk_bwd(*args, g_stats, **kwargs))
  want = view_scan.lift_topk_bwd_plain(*args, g_stats, **kwargs)
  torch.cuda.synchronize()
  torch.testing.assert_close(got.float(), want.float(),
                             **BWD_TOLERANCES[dtype])


@pytest.mark.parametrize('dim', [17, 32])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize('case', sorted(SAMPLE_BWD_CASES))
def test_patch_sample_2d_bwd_repeat_calls_give_equal_bits(cuda, case, dtype,
                                                          dim):
  """K4 sums every entry in one order fixed by its inputs (ROADMAP C20):
  ten calls give the same bits at a pile-up of 8,000 points on one cell
  (split across walkers), the clamped corners and the templates' border."""
  args, kwargs = SAMPLE_BWD_CASES[case](cuda, dtype, dim)
  got = _equal_bits_over_calls(
      lambda: kernels.patch_sample_2d_bwd(*args, **kwargs))
  want = view_scan.patch_sample_2d_bwd_plain(*args, **kwargs)
  torch.cuda.synchronize()
  torch.testing.assert_close(got.float(), want.float(),
                             **BWD_TOLERANCES[dtype])


def test_lift_bwd_scratch_follows_the_selected_count(cuda):
  """K3's scratch is sized by the selected ranks, not by every rank: on a
  sparse input of 20 ranks a point its own peak stays under what the
  per-rank ``d f`` rows alone would take; a count passed that is not the
  count stage's is read back from the card once the call has ended and
  raises, at the wrapper's next call or when the counts are checked."""
  g = torch.Generator(device='cpu').manual_seed(12)
  b, v, h, w, n, k, dim = 2, 5, 7, 9, 200_000, 20, 32
  stack = torch.randn((b, v * (h + 1), w + 1, dim), generator=g).to(cuda)
  view_idx = torch.randint(0, v, (b, n, k), generator=g, dtype=torch.int32)
  p2d = torch.rand((b, n, k, 2), generator=g) * torch.tensor([h, w + 0.0])
  select = torch.rand((b, n, k), generator=g) < 0.15
  depth = torch.rand((b, n, k), generator=g) * 40
  args = [stack] + [t.to(cuda) for t in (view_idx, p2d, select, depth)]
  kw = dict(h=h, w=w, dim=dim, depth_min_max=(1.0, 32.0),
            use_variance=True, add_minmax=False)
  g_stats = torch.randn((b, n, 2 * dim), device=cuda)
  selected = int(select.sum())
  torch.cuda.synchronize()
  base = torch.cuda.memory_allocated()
  torch.cuda.reset_peak_memory_stats()
  got = kernels.lift_topk_bwd(*args, g_stats, **kw, selected=selected)
  torch.cuda.synchronize()
  own = torch.cuda.max_memory_allocated() - base
  every_rank = b * n * k * dim * 4
  assert own < every_rank / 2, (own, every_rank)
  torch.testing.assert_close(
      got, view_scan.lift_topk_bwd_plain(*args, g_stats, **kw),
      **BWD_TOLERANCES[torch.float32])
  kernels.check_lift_counts(wait=True)
  for wrong in (selected - 1, selected + 1):
    kernels.lift_topk_bwd(*args, g_stats, **kw, selected=wrong)
    with pytest.raises(RuntimeError, match=f'{wrong} selected ranks passed, '
                       f'the count stage found {selected}'):
      kernels.check_lift_counts(wait=True)
  kernels.lift_topk_bwd(*args, g_stats, **kw, selected=selected - 1)
  torch.cuda.synchronize()
  with pytest.raises(RuntimeError, match='the count stage found'):
    kernels.lift_topk_bwd(*args, g_stats, **kw, selected=selected)
  kernels.check_lift_counts(wait=True)


@pytest.mark.parametrize('layout', LAYOUTS)
def test_stats_width_is_the_plain_versions(layout):
  """The launchers size stats and check g_stats by ``stats_width``: the
  plain versions' row, [mean, var?, max?, min?, score_max?]."""
  weighted, use_variance, add_minmax = layout
  args, kwargs = _b8_inputs('cpu', torch.float32, weighted, 4)
  kwargs.update(use_variance=use_variance, add_minmax=add_minmax)
  stats, valid = view_scan.lift_topk_plain(*args, **kwargs)
  assert stats.shape == (2, 3000, kernels.stats_width(32, *layout))
  dim = 32
  mean = stats[..., :dim]
  if add_minmax:
    at = dim * (1 + use_variance)
    f_max, f_min = stats[..., at:at + dim], stats[..., at + dim:at + 2 * dim]
    assert (f_min[valid] <= mean[valid] + 1e-6).all()
    assert (mean[valid] <= f_max[valid] + 1e-6).all()
  with pytest.raises(ValueError, match='needs CUDA'):
    kernels.lift_topk_fwd(*args, **kwargs)


def _near_tie_lift_inputs(device, dtype, k, seed=14):
  """K3 inputs whose every selected rank reads a pixel centre of its own
  (bilinear weights 1, 0, 0, 0; no two selected ranks share a pixel), at
  depth_min 1 with a log range of 4 (the bins' abscissa the same on both
  sides, as K1's bit-for-bit test has it), 3 selected ranks a point at
  K = 4 and 6 at K = 20 (K3's wide stage). A point's second selected rank
  reads the score bins of its first at a depth a few f32 ulps away, so
  that their scores nearly tie. Returns (args, kwargs, bins read, hats)."""
  g = torch.Generator(device='cpu').manual_seed(seed)
  b, v, h, w, n, dim, bins = 2, 20, 45, 60, 8000, 32, 8
  lo, hi = 1.0, math.exp(4.0)
  picked = 3 if k <= 4 else 6
  stack = torch.randn((b, v * (h + 1), w + 1, dim + bins),
                      generator=g).to(dtype)
  # Distinct pixels (view, row, col) for the selected ranks of an example.
  pixels = torch.stack([torch.randperm(v * h * w, generator=g)[:n * picked]
                        for _ in range(b)]).reshape(b, n, picked)
  order = torch.rand((b, n, k), generator=g).argsort(-1)[..., :picked]
  view = torch.randint(0, v, (b, n, k), generator=g)
  row = torch.randint(0, h, (b, n, k), generator=g)
  col = torch.randint(0, w, (b, n, k), generator=g)
  for t, part in ((view, pixels // (h * w)), (row, pixels // w % h),
                  (col, pixels % w)):
    t.scatter_(2, order, part)
  select = torch.zeros((b, n, k), dtype=torch.bool)
  select.scatter_(2, order, True)
  depth = 0.5 + torch.rand((b, n, k), generator=g) * (hi + 5.0)
  first, second = order[..., :1], order[..., 1:2]
  near = torch.gather(depth, 2, first) * (1 + (torch.randint(
      -4, 5, (b, n, 1), generator=g).float() * 2.0**-23))
  depth.scatter_(2, second, near.clamp(1.0 + 2.0**-20, hi - 1e-3))
  depth.scatter_(2, first, torch.gather(depth, 2, first).clamp(
      1.0 + 2.0**-20, hi - 1e-3))
  rows = view * (h + 1) + row
  e = torch.arange(b)[:, None]
  # In half the points the first rank's bins all hold one value: the two
  # scores are then equal before rounding, and the roundings alone order
  # them.
  flat = stack[e, torch.gather(rows, 2, first)[..., 0],
               torch.gather(col, 2, first)[..., 0], dim:]
  flat[:, :n // 2] = flat[:, :n // 2, :1]
  stack[e, torch.gather(rows, 2, first)[..., 0],
        torch.gather(col, 2, first)[..., 0], dim:] = flat
  stack[e, torch.gather(rows, 2, second)[..., 0],
        torch.gather(col, 2, second)[..., 0], dim:] = stack[
            e, torch.gather(rows, 2, first)[..., 0],
            torch.gather(col, 2, first)[..., 0], dim:]
  p2d = torch.stack([row, col], -1).float() + 0.5
  args = [t.to(device) for t in (stack, view.int(), p2d, select, depth)]
  kwargs = dict(h=h, w=w, dim=dim, depth_min_max=(lo, hi),
                use_variance=True, add_minmax=False)
  bins_read = stack[e[..., None], rows, col, dim:].float()
  hat = view_fusion.depth_hat_weights(depth, bins, (lo, hi))
  return args, kwargs, bins_read, hat


def _fused_score_flips(args, bins_read, hat):
  """Points whose score max would go to another rank if each score were
  RN(a h0 + RN(b h1)), the first product fused into the sum, instead of
  the plain version's RN(RN(a h0) + RN(b h1)) (a, b the bins around the
  depth, h0, h1 their hats); and the points whose two largest scores are
  within 4 f32 ulps and unequal."""
  select = args[3].cpu()
  s0 = (hat > 0).float().argmax(-1, keepdim=True)
  s1 = (s0 + 1).clamp(max=hat.shape[-1] - 1)
  at = lambda t, s: torch.gather(t, -1, s)[..., 0]
  b_h1 = torch.where(s1[..., 0] > s0[..., 0],
                     at(bins_read, s1) * at(hat, s1), 0.0)
  plain = at(bins_read, s0) * at(hat, s0) + b_h1
  fused = (at(bins_read, s0).double() * at(hat, s0).double()
           + b_h1.double()).float()
  plain = torch.where(select, plain, -torch.inf)
  fused = torch.where(select, fused, -torch.inf)
  top = plain.topk(2, -1).values
  near = (top[..., 0] != top[..., 1]) & (
      top[..., 0] - top[..., 1] <= 4 * torch.finfo(torch.float32).eps
      * top[..., 0].abs())
  return int((plain.argmax(-1) != fused.argmax(-1)).sum()), int(near.sum())


@pytest.mark.parametrize('k', [4, 20])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_lift_topk_bwd_score_is_the_plain_versions_to_the_bit(cuda, dtype,
                                                              k):
  """K3 recomputes each rank's score to route the score max's cotangent:
  RN(RN(a h0) + RN(b h1)), as K1 and the plain version round it (ROADMAP
  C27). With only g_m non-zero and no two selected ranks on one pixel,
  each entry of d stack is one rank's g_m h_s (or 0), so K3's d stack is
  the plain version's bit for bit exactly where both give g_m to the same
  rank; the inputs hold near ties that a product fused into the sum would
  send to the other rank (counted on the host)."""
  args, kwargs, bins_read, hat = _near_tie_lift_inputs('cpu', dtype, k)
  flips, near = _fused_score_flips(args, bins_read, hat)
  assert flips > 0 and near > 100, (flips, near)
  args = [t.to(cuda) for t in args]
  b, n = args[1].shape[:2]
  g = torch.Generator(device='cpu').manual_seed(15)
  g_stats = torch.zeros((b, n, 2 * kwargs['dim'] + 1))
  g_stats[..., -1] = torch.randn((b, n), generator=g)
  g_stats = g_stats.to(dtype).to(cuda)
  got = kernels.lift_topk_bwd(*args, g_stats, **kwargs)
  want = view_scan.lift_topk_bwd_plain(*args, g_stats, **kwargs)
  torch.cuda.synchronize()
  assert ('wide_ranks_kernel' in [
      o['name'] for o in kernels.occupancy('lift_topk_bwd')]) == (k > 4)
  assert want[..., kwargs['dim']:].abs().max() > 0.1
  assert not want[..., :kwargs['dim']].any()
  assert torch.equal(got, want)


# Example 1's cotangent in the non-finite tests: a largest entry in
# [2^14, 2^15), finite in f16, whose sums pass its 65504.
LARGE = 2.0**14


def _with_non_finite(g, at, bad=math.inf):
  """``g`` (largest entry in [1, 2)) with ``bad`` at index ``at`` and its
  example 1 times LARGE."""
  g = g.clone()
  g[1] *= LARGE
  g[at] = bad
  return g


def _assert_same_non_finite(got, want, tol):
  """The same entries non-finite (inf or NaN) on both sides, some of them
  in each example; the finite ones within ``tol``, its atol times LARGE in
  example 1 (sums in two orders of LARGE times the cotangents)."""
  fin = torch.isfinite(want)
  assert torch.equal(torch.isfinite(got), fin)
  assert not fin[0].all() and not fin[1].all()
  assert torch.isinf(want[1]).any()  # f16's overflow, in example 1
  for e, atol in ((0, tol['atol']), (1, tol['atol'] * LARGE)):
    torch.testing.assert_close(got[e][fin[e]].float(), want[e][fin[e]].float(),
                               atol=atol, rtol=tol['rtol'])


@pytest.mark.parametrize('bad', [math.inf, -math.inf, math.nan])
def test_lift_topk_bwd_f16_non_finite_cotangent_reaches_the_gradient(cuda,
                                                                     bad):
  """A non-finite cotangent, and sums past f16's largest value, give K3's
  d stack the plain version's non-finite entries: nothing clamps or masks
  them, and the cast of the f32 sum rounds past 65504 to inf."""
  args, g_stats, kwargs = _raw_lift_bwd_inputs(cuda, torch.float16, 160, 128)
  assert args[3][0, 500].any()
  g_stats = chip_smoke.unit_cotangent(g_stats)
  g_stats = _with_non_finite(g_stats.float(), (0, 500, 3), bad).to(
      torch.float16)
  got = kernels.lift_topk_bwd(*args, g_stats, **kwargs)
  want = view_scan.lift_topk_bwd_plain(*args, g_stats, **kwargs)
  torch.cuda.synchronize()
  assert got.dtype == torch.float16
  _assert_same_non_finite(got, want, BWD_TOLERANCES[torch.float16])


@pytest.mark.parametrize('bad', [math.inf, -math.inf, math.nan])
def test_patch_sample_2d_bwd_f16_non_finite_cotangent_reaches_the_gradient(
    cuda, bad):
  """K4 as K3 above: a non-finite cotangent reaches its taps' entries (a
  tap of weight 0 times inf gives NaN, as in the plain version), sums past
  65504 round to inf."""
  (padded, points), kwargs = _plane_inputs(cuda, torch.float16)
  g = torch.randn((2, points.shape[1], kwargs['dim']), device=cuda)
  g = _with_non_finite(chip_smoke.unit_cotangent(g), (0, 10, 3), bad).to(
      torch.float16)
  got = kernels.patch_sample_2d_bwd(g, points,
                                    plane_shape=tuple(padded.shape))
  want = view_scan.patch_sample_2d_bwd_plain(
      g, points, plane_shape=tuple(padded.shape))
  torch.cuda.synchronize()
  assert got.dtype == torch.float16
  _assert_same_non_finite(got, want, BWD_TOLERANCES[torch.float16])
