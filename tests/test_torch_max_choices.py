"""The card-vs-CPU training check's replay of max choices (ROADMAP C11).

``chip_smoke.MaxChoices`` records which entries the max poolings of one
copy of the model pick and makes another copy pick them. Replaying a
model's own choices must change nothing, bit for bit; replaying another
choice at a near tie must route the value and the gradient there, and one
far from a tie must fail.
"""

import pytest
import torch

import chip_smoke
from snap_tpu_torch import configs
from snap_tpu_torch import evaluate
from snap_tpu_torch.data import loader
from snap_tpu_torch.models import bev_mapper
from snap_tpu_torch.models import resnet
from snap_tpu_torch.models import types
from snap_tpu_torch.train_lib import optimizers
from snap_tpu_torch.train_lib import trainer

torch.set_num_threads(2)


def _train_step(replay=None, draws=None):
  """One step of the tiny trainer from seeded weights under MaxChoices."""
  cfg = configs.smoke_train_exhaustive()
  model = evaluate.build_model(cfg, 'cpu', 0).train()
  adam = optimizers.Adam(cfg.train)
  state = trainer.create_train_state(model, adam, seed=0)
  examples = loader.make_train_examples(loader.make_generator(cfg.data, 0),
                                        0, cfg.batch_size, cfg.data)
  with chip_smoke.MaxChoices(model, replay=replay) as choices:
    out = trainer.train_step(state, loader.pair_batch_to_torch(examples,
                                                               'cpu'),
                             adam, draws=draws)
  return out, choices


def test_replaying_own_max_choices_leaves_gradients_unchanged():
  recorded, on_record = _train_step()
  replayed, on_replay = _train_step(replay=on_record.calls,
                                    draws=recorded.draws)
  sites = {name for name, *_ in on_replay.flips}
  assert 'bev_mapper.vertical_pooling' in sites
  assert 'bev_mapper.modality_fusion' in sites
  assert any(name.endswith('root_block') for name in sites)
  assert 'F.relu' in sites
  assert all(flips == 0 and gap == 0 for _, flips, _, gap in on_replay.flips)
  assert trainer.summarize([recorded.metrics]) == trainer.summarize(
      [replayed.metrics])
  assert recorded.grads.keys() == replayed.grads.keys()
  for name, grad in recorded.grads.items():
    assert torch.equal(grad, replayed.grads[name]), name


NEAR = 3.0 - 2.0**-20  # 3.0's near tie: 2^-20 / 5 of the largest value


def test_replayed_vertical_pooling_choice_routes_the_gradient():
  pool = bev_mapper.VerticalPooling(configs.VerticalPoolingConfig())
  features = torch.tensor([[[3.0, 1.0], [NEAR, 5.0], [1.0, 4.0]]])
  valid = torch.ones(features.shape[:-1], dtype=torch.bool)
  volume = types.FeatureVolume(features=features, valid=valid)
  with chip_smoke.MaxChoices(pool) as recorded:
    own = pool(volume).features
  assert torch.equal(own, torch.tensor([[3.0, 5.0]]))
  other = recorded.calls[0].clone()
  other[0, :, 0] = torch.tensor([False, True, False])  # channel 0: row 1
  leaf = features.clone().requires_grad_()
  with chip_smoke.MaxChoices(pool, replay=[other]) as replayed:
    plane = pool(types.FeatureVolume(features=leaf, valid=valid)).features
  assert torch.equal(plane.detach(), torch.tensor([[NEAR, 5.0]]))
  assert replayed.flips == [('', 1, 2, 2.0**-20 / 5.0)]
  plane.sum().backward()
  assert torch.equal(leaf.grad, torch.tensor(
      [[[0.0, 0.0], [1.0, 1.0], [0.0, 0.0]]]))


def _root_and_image():
  """A root block and a 32 x 32 image of period 2 (the stride-2 conv's
  outputs away from the border are equal) with one pixel nudged by 1e-5:
  the 3 x 3 windows of pooled output (2, 2) hold near ties."""
  root = resnet.RootBlock(4, torch.float32)
  torch.nn.init.normal_(root.conv_root.weight,
                        generator=torch.Generator().manual_seed(0))
  cell = torch.randn((1, 2, 2, 3), generator=torch.Generator().manual_seed(1))
  image = cell.repeat(1, 16, 16, 1)
  image[0, 9, 9, 0] += 1e-5
  return root, image


def test_replayed_root_pool_choice_routes_the_gradient():
  root, image = _root_and_image()
  with chip_smoke.MaxChoices(root) as recorded:
    want = root(image)
  indices = recorded.calls[0]
  # Pooled output (2, 2) of channel 0 reads conv rows and columns 3..5
  # (16 per row): take the window's entry after the CPU's own.
  own = int(indices[0, 0, 2, 2])
  other = indices.clone()
  other[0, 0, 2, 2] = own + 1 if own % 16 < 5 else own - 1
  weight = root.conv_root.weight
  with chip_smoke.MaxChoices(root, replay=[indices]):
    same = root(image)
  assert torch.equal(same, want)
  same_grad, = torch.autograd.grad(same.sum(), weight)
  want_grad, = torch.autograd.grad(root(image).sum(), weight)
  assert torch.equal(same_grad, want_grad)
  with chip_smoke.MaxChoices(root, replay=[other]) as replayed:
    moved = root(image)
  (name, flips, total, gap), = replayed.flips
  assert (name, flips, total) == ('', 1, indices.numel())
  assert 0 <= gap <= chip_smoke.CHOICE_GAP_RTOL
  conv = root.conv_root(image).permute(0, 3, 1, 2).reshape(1, 4, -1)
  assert moved[0, 2, 2, 0] == conv[0, 0, other[0, 0, 2, 2]]
  kept = torch.ones_like(moved, dtype=torch.bool)
  kept[0, 2, 2, 0] = False
  assert torch.equal(moved[kept], want[kept])
  moved_grad, = torch.autograd.grad(moved[0, 2, 2, 0], weight)
  conv_grad, = torch.autograd.grad(
      root.conv_root(image).permute(0, 3, 1, 2).reshape(1, 4, -1)[
          0, 0, other[0, 0, 2, 2]], weight)
  assert torch.equal(moved_grad, conv_grad)


class _Relu(torch.nn.Module):

  def forward(self, x):
    return torch.nn.functional.relu(x)


def test_replayed_relu_choice_routes_the_gradient():
  relu = _Relu()
  x = torch.tensor([-1.0, 2.0, -3e-9, 4.0])
  with chip_smoke.MaxChoices(relu) as recorded:
    assert torch.equal(relu(x), torch.tensor([0.0, 2.0, 0.0, 4.0]))
  other = recorded.calls[0].clone()
  other[2] = True  # the card saw +3e-9 where this copy sees -3e-9
  leaf = x.clone().requires_grad_()
  with chip_smoke.MaxChoices(relu, replay=[other]) as replayed:
    y = relu(leaf)
  assert replayed.flips == [('F.relu', 1, 4, -float(x[2]) / 4.0)]
  assert torch.equal(y.detach(), torch.tensor([0.0, 2.0, -3e-9, 4.0]))
  y.sum().backward()
  assert torch.equal(leaf.grad, torch.tensor([0.0, 1.0, 1.0, 1.0]))
  assert torch.nn.functional.relu is chip_smoke.F.relu  # restored on exit


@pytest.mark.parametrize('site', ['vertical_pooling', 'root_pool', 'relu'])
def test_replayed_choice_far_from_a_tie_fails(site):
  """The replay takes near ties only: a recorded choice that moves a max
  by more than CHOICE_GAP_RTOL of the site's largest magnitude raises."""
  if site == 'vertical_pooling':
    model = bev_mapper.VerticalPooling(configs.VerticalPoolingConfig())
    features = torch.tensor([[[3.0, 1.0], [2.0, 5.0], [1.0, 4.0]]])
    valid = torch.ones(features.shape[:-1], dtype=torch.bool)
    x = types.FeatureVolume(features=features, valid=valid)
  elif site == 'root_pool':
    model, x = _root_and_image()
  else:
    model, x = _Relu(), torch.tensor([-1.0, 2.0, -3e-9, 4.0])
  with chip_smoke.MaxChoices(model) as recorded:
    model(x)
  other = recorded.calls[0].clone()
  if site == 'vertical_pooling':
    other[0, :, 0] = torch.tensor([False, True, False])  # 2.0 for 3.0
  elif site == 'root_pool':
    # The corner window's conv outputs see the padding, each its own part
    # of it: no near ties there.
    other[0, 0, 0, 0] = 17 if int(other[0, 0, 0, 0]) != 17 else 0
  else:
    other[0] = True  # -1.0 taken as above 0
  with pytest.raises(AssertionError, match='from a tie'):
    with chip_smoke.MaxChoices(model, replay=[other]):
      model(x)


def test_flips_per_site_sums_a_step_and_caps_it():
  step = [('F.relu', 2, 100, 1e-7), ('a', 1, 10, 0.0), ('F.relu', 3, 50,
                                                           2e-7)]
  assert chip_smoke.flips_per_site(step) == {'F.relu': [5, 150, 2e-7],
                                             'a': [1, 10, 0.0]}
  too_many = [('F.relu', chip_smoke.MAX_FLIPS_PER_STEP, 10**6, 0.0),
              ('F.relu', 1, 10**6, 0.0)]
  with pytest.raises(AssertionError, match='flipped in a step'):
    chip_smoke.flips_per_site(too_many)
