"""The CUDA kernels K1/K3 (lift_topk_fwd/bwd), K2/K4 (patch_sample_2d
and its backward), B4 (pose_scoring), B5 (slice_gather) and B6
(table_gather).

Tests that need a card take the ``cuda`` fixture and skip where there is
none (a CUDA kernel has no CPU mode); on a card, run them with
``python -m pytest tests/test_torch_kernels.py -q``. The CPU tests check
the build recipe and the wrappers' refusals.
"""

import math

import pytest
import torch

import chip_smoke
from snap_tpu_torch import evaluate
from snap_tpu_torch.models import pose_estimation
from snap_tpu_torch.ops import gathers
from snap_tpu_torch.ops import kernels
from snap_tpu_torch.ops import view_scan
from snap_tpu_torch.utils import geometry
from snap_tpu_torch.utils import grids

torch.set_num_threads(2)

# Kernel vs plain version: both accumulate in f32; bf16 outputs may differ
# by one rounding (2^-8 relative), f32 ones by summation order.
TOLERANCES = {torch.float32: dict(atol=1e-5, rtol=1e-5),
              torch.bfloat16: dict(atol=1e-3, rtol=2.0**-7)}
# The backward kernels: each output is a sum of tap-weighted contributions
# added with atomics (the plain version's index_add_ on the card too) in
# orders that change from run to run. The test points spill one pixel past
# each image edge, so a view's corner pixels collect a few hundred
# contributions of magnitude up to ~10 whose f32 sums differ by up to
# ~1e-3 between two orders (a first run measured 7e-4): f32 outputs get
# 2e-3 absolute.
BWD_TOLERANCES = {torch.float32: dict(atol=2e-3, rtol=1e-5),
                  torch.bfloat16: dict(atol=1e-3, rtol=2.0**-7)}


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


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
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
  """The whole slice in f32: card (kernels) against CPU (plain versions)."""
  kernels.reset_launch_counts()
  on_card = evaluate.evaluate('smoke_exhaustive', 2, 'cuda', batch_size=2)
  assert kernels.LAUNCHES['lift_topk_fwd'] and kernels.LAUNCHES[
      'patch_sample_2d']
  on_cpu = evaluate.evaluate('smoke_exhaustive', 2, 'cpu', batch_size=2)
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
  """One plain nvcc call for sm_90a into a .gitignored build directory."""
  assert 'arch=compute_90a,code=sm_90a' in kernels.NVCC_FLAGS
  assert '-shared' in kernels.NVCC_FLAGS
  path = kernels.library_path()
  assert path.parent == kernels.BUILD_DIR
  assert path.parts[-3] == 'build' and path.suffix == '.so'
  sources = sorted(p.name for p in kernels.CSRC.glob('*.cu'))
  assert sources == ['lift_topk_bwd.cu', 'lift_topk_fwd.cu',
                     'patch_sample_2d.cu', 'patch_sample_2d_bwd.cu',
                     'pose_scoring.cu', 'slice_gather.cu', 'table_gather.cu']
  assert sorted(f'{name}.cu' for name in kernels.LAUNCHES) == sources
  assert kernels.library_path() == path  # stable: keyed by the sources


@pytest.mark.parametrize('total', [1, 2, 7, 1_152_000, 614_400, 2 * 614_400])
def test_spread_stride_is_a_permutation(total):
  stride = kernels.spread_stride(total)
  assert math.gcd(stride, total) == 1
  if total < 10_000:
    assert sorted((w * stride) % total for w in range(total)) == list(
        range(total))


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


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
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
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
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
  xy[:, :60] = torch.randint(-4, 5, (b, 60, 2), generator=g).float() * cell
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


def test_pose_scoring_raises_where_a_gradient_is_needed(cuda):
  args, cell = _scoring_inputs(cuda, p=10)
  args[2].requires_grad_()
  with pytest.raises(RuntimeError, match='no backward kernel'):
    kernels.pose_scoring(*args, cell_size=cell, mask_out_of_bounds=False)
  with torch.no_grad():
    kernels.pose_scoring(*args, cell_size=cell, mask_out_of_bounds=False)


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
