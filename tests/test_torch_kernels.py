"""The CUDA kernels K1 (lift_topk_fwd) and K2 (patch_sample_2d).

Tests that need a card take the ``cuda`` fixture and skip where there is
none (a CUDA kernel has no CPU mode); on a card, run them with
``python -m pytest tests/test_torch_kernels.py -q``. The CPU tests check
the build recipe and the wrappers' refusals.
"""

import pytest
import torch

from snap_tpu_torch import evaluate
from snap_tpu_torch.ops import kernels
from snap_tpu_torch.ops import view_scan

torch.set_num_threads(2)

# Kernel vs plain version: both accumulate in f32; bf16 outputs may differ
# by one rounding (2^-8 relative), f32 ones by summation order.
TOLERANCES = {torch.float32: dict(atol=1e-5, rtol=1e-5),
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
  assert all(kernels.LAUNCHES.values())
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
  args, kwargs = _plane_inputs('cpu', torch.float32)
  with pytest.raises(ValueError, match='needs CUDA'):
    kernels.patch_sample_2d(*args, **kwargs)
  before = dict(kernels.LAUNCHES)
  view_scan.patch_sample_2d(*args, **kwargs)
  assert kernels.LAUNCHES == before


def test_build_recipe():
  """One plain nvcc call for sm_90a into a .gitignored build directory."""
  assert 'arch=compute_90a,code=sm_90a' in kernels.NVCC_FLAGS
  assert '-shared' in kernels.NVCC_FLAGS
  path = kernels.library_path()
  assert path.parent == kernels.BUILD_DIR
  assert path.parts[-3] == 'build' and path.suffix == '.so'
  sources = sorted(p.name for p in kernels.CSRC.glob('*.cu'))
  assert sources == ['lift_topk_fwd.cu', 'patch_sample_2d.cu']
  assert kernels.library_path() == path  # stable: keyed by the sources
