"""The trainer's configs against the JAX package's, and the data-seed fold.

``utils/prng.resume_shuffle_seed`` against ``jax.random.fold_in(
PRNGKey(s), t).sum()`` (a uint32 sum that wraps); the trainer keys of
``train_localization.py:scale=full1chip`` (both backends, and the
continuation from step 12500) and ``smoke_localization.py``, key by key;
``continue_step``'s errors; the continuation's learning rate against JAX's
``lr_fn``; ``from_reference`` / ``to_reference`` on the trainer keys.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest

from snap_tpu.configs import smoke_localization
from snap_tpu.configs import train_localization
from snap_tpu.train_lib import lr_schedules as jlr_schedules
from snap_tpu_torch import configs
from snap_tpu_torch.train_lib import lr_schedules
from snap_tpu_torch.utils import prng

# The cases whose uint32 sum wraps (the fold exceeds 2^31 or 2^32 wraps).
WRAPPING = [(0, 1, 87701676), (1234567, 500, 3583259883),
            (1247067, 100, 4277725857)]
TRAINER_KEYS = ('checkpoint', 'checkpoint_steps', 'max_checkpoints_to_keep',
                'log_summary_steps', 'log_eval_steps', 'steps_per_eval',
                'eval_batch_size', 'xprof', 'num_training_steps',
                'max_grad_norm')
# float64 (port) against float32 (JAX) schedule factors.
LR_RTOL, LR_ATOL_OF_BASE = 1e-6, 1e-6


@pytest.mark.parametrize('seed,step,want', WRAPPING)
def test_fold_wraps_as_jax(seed, step, want):
  key = jax.random.fold_in(jax.random.PRNGKey(seed), step)
  np.testing.assert_array_equal(prng.fold_in(prng.prng_key(seed), step),
                                np.asarray(key))
  assert prng.resume_shuffle_seed(seed, step) == int(key.sum()) == want


@pytest.mark.parametrize('seed', [0, 1, 7, 1234567, 1241567, 2**31 - 1,
                                  2**32 - 1])
def test_fold_equals_jax_over_a_grid_of_steps(seed):
  for step in (1, 2, 4, 100, 500, 12_500, 19_999, 2**31 - 1, 2**32 - 1):
    want = int(jax.random.fold_in(jax.random.PRNGKey(seed), step).sum())
    assert prng.resume_shuffle_seed(seed, step) == want, (seed, step)


def _assert_fields_equal(port, ref, path=''):
  for field in dataclasses.fields(port):
    value, name = getattr(port, field.name), f'{path}{field.name}'
    if field.name not in ref:
      continue  # a port-only field
    if dataclasses.is_dataclass(value):
      _assert_fields_equal(value, ref[field.name], name + '.')
    else:
      want = ref[field.name]
      if isinstance(value, tuple):
        value, want = tuple(value), tuple(want)
      assert value == want, (name, value, want)


CASES = [
    ('train_full1chip_exhaustive', 'scale=full1chip,pose_backend=exhaustive'),
    ('train_full1chip_ransac', 'scale=full1chip'),
    ('train_full1chip_exhaustive:continue_step=12500,pretrained_mapper={w}',
     'scale=full1chip,pose_backend=exhaustive,continue_step=12500,'
     'pretrained_mapper={w}'),
    ('train_full1chip_ransac:continue_step=12500,pretrained_mapper={w},'
     'pretrained_resnet=bit.npz',
     'scale=full1chip,continue_step=12500,pretrained_mapper={w},'
     'pretrained_resnet=bit.npz'),
    ('smoke_train_exhaustive', 'smoke:pose_backend=exhaustive'),
    ('smoke_train_ransac', 'smoke:'),
]


@pytest.mark.parametrize('name,ref_args', CASES)
def test_trainer_configs_equal_jax_key_by_key(tmp_path, name, ref_args):
  """Every trainer key, the schedule, the data seed and the warm starts
  (``pretrained_path`` of the mapper and of the street-view trunk)."""
  name, ref_args = (s.format(w=tmp_path) for s in (name, ref_args))
  port = configs.get_config(name)
  if ref_args.startswith('smoke:'):
    ref = smoke_localization.get_config(ref_args[len('smoke:'):] or None)
  else:
    ref = train_localization.get_config(ref_args)
  for key in TRAINER_KEYS:
    assert getattr(port.train, key) == ref[key], key
  assert port.train.stop_at_step is None
  _assert_fields_equal(port.train.lr_configs, ref.lr_configs)
  _assert_fields_equal(port.train.optimizer_configs, ref.optimizer_configs)
  _assert_fields_equal(port.model, ref.model)
  assert port.data.shuffle_seed == ref.shuffle_seed
  mapper, ref_mapper = port.model.bev_mapper, ref.model.bev_mapper
  assert mapper.pretrained_path == ref_mapper.pretrained_path
  encoder = mapper.streetview_encoder.image_encoder.encoder
  ref_encoder = ref_mapper.streetview_encoder.image_encoder.encoder
  assert encoder.pretrained_path == ref_encoder.pretrained_path
  assert mapper.aerial_encoder.encoder.pretrained_path is None


def test_from_and_to_reference_carry_the_trainer_keys(tmp_path):
  ref = train_localization.get_config(
      f'scale=full1chip,pose_backend=exhaustive,continue_step=12500,'
      f'pretrained_mapper={tmp_path}').to_dict()
  got = configs.from_reference(json.loads(json.dumps(ref)))
  assert got == configs.get_config(
      f'train_full1chip_exhaustive:continue_step=12500,'
      f'pretrained_mapper={tmp_path}')
  assert got.model.bev_mapper.pretrained_path == str(tmp_path)
  stopped = dataclasses.replace(
      got, train=dataclasses.replace(got.train, stop_at_step=7,
                                     checkpoint=False))
  back = configs.from_reference(json.loads(json.dumps(
      configs.to_reference(stopped))))
  assert back.train.stop_at_step == 7 and not back.train.checkpoint
  assert back.model.bev_mapper.pretrained_path == str(tmp_path)


def _jax_error(args):
  with pytest.raises(ValueError) as info:
    train_localization.get_config(args)
  return str(info.value)


@pytest.mark.parametrize('make_dir,args,match', [
    (None, 'continue_step=12500', 'requires pretrained_mapper'),
    ('empty', 'continue_step=20000,pretrained_mapper={w}',
     r'must be in \(0, 20000\)'),
    ('empty', 'continue_step=-5,pretrained_mapper={w}',
     r'must be in \(0, 20000\)'),
    ('checkpoints', 'continue_step=12000,pretrained_mapper={w}',
     r'does not match the export checkpoint step\(s\) \[12500\]'),
])
def test_continue_step_errors_are_the_references(tmp_path, make_dir, args,
                                                 match):
  if make_dir == 'checkpoints':
    (tmp_path / 'checkpoints' / '12500').mkdir(parents=True)
  args = args.format(w=tmp_path)
  want = _jax_error('scale=full1chip,' + args)
  for name in ('train_full1chip_exhaustive', 'train_full1chip_ransac'):
    with pytest.raises(ValueError, match=match) as info:
      configs.get_config(f'{name}:{args}')
    assert str(info.value) == want


def test_continue_step_reads_a_jax_format_workdirs_step(tmp_path):
  """A workdir of flat params records its step in ``checkpoint.json``."""
  (tmp_path / 'checkpoint.json').write_text(json.dumps({'step': 12500}))
  cfg = configs.get_config('train_full1chip_exhaustive:continue_step=12500,'
                           f'pretrained_mapper={tmp_path}')
  assert cfg.train.num_training_steps == 7500
  with pytest.raises(ValueError, match=r'step\(s\) \[12500\]'):
    configs.get_config('train_full1chip_exhaustive:continue_step=7000,'
                       f'pretrained_mapper={tmp_path}')


def test_continuation_lr_equals_jax(tmp_path):
  ref = train_localization.get_config(
      f'scale=full1chip,pose_backend=exhaustive,continue_step=12500,'
      f'pretrained_mapper={tmp_path}')
  port = configs.get_config(
      f'train_full1chip_exhaustive:continue_step=12500,'
      f'pretrained_mapper={tmp_path}')
  want = jlr_schedules.get_learning_rate_fn(ref)
  got = lr_schedules.get_learning_rate_fn(port.train.lr_configs)
  base = port.train.lr_configs.base_learning_rate
  for step in (0, 50, 100, 101, 3500, 7499):
    assert got(step) == pytest.approx(float(want(step)), rel=LR_RTOL,
                                      abs=LR_ATOL_OF_BASE * base), step
  assert got(0) == 0.0
  # Past the re-warmup, the recipe's own schedule at step 12500 + s.
  recipe = lr_schedules.get_learning_rate_fn(
      configs.train_full1chip_exhaustive().train.lr_configs)
  assert got(3500) == pytest.approx(recipe(16_000), rel=1e-12)
