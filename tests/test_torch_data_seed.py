"""The port's scene generators are the JAX loader's (ROADMAP C12).

For each config, ``snap_tpu.data.loader.get_dataset`` is called as the JAX
entry point calls it (``train.py`` for the training split,
``evaluator.py:get_model_and_dataset`` for the eval split), with its
prefetching stubbed out and its ``SyntheticSceneGenerator``s recorded. Both
generators are numpy, so the port's example must equal the JAX loader's
bit for bit.
"""

import jax
import ml_collections
import numpy as np
import pytest

from snap_tpu.configs import defaults as jdefaults
from snap_tpu.configs import eval_localization
from snap_tpu.configs import smoke_eval_localization
from snap_tpu.configs import smoke_localization
from snap_tpu.configs import train_localization
from snap_tpu.data import loader as jloader
from snap_tpu.utils import configs as jconfig_utils
from snap_tpu_torch import configs
from snap_tpu_torch.data import loader


class _NoPrefetch:
  def __init__(self, *args, **kwargs):
    del args, kwargs


def _jax_generators(monkeypatch, dataset_configs, batch_size, shuffle_seed):
  """get_dataset's (train, eval) generators and its example kwargs."""
  made = []

  class Recording(jloader.synthetic.SyntheticSceneGenerator):
    def __init__(self, **kwargs):
      super().__init__(**kwargs)
      made.append(self)

  monkeypatch.setattr(jloader.synthetic, 'SyntheticSceneGenerator', Recording)
  monkeypatch.setattr(jloader, '_PrefetchIterator', _NoPrefetch)
  dataset = jloader.get_dataset(
      batch_size=batch_size, eval_batch_size=batch_size,
      dataset_configs=dataset_configs, shuffle_seed=shuffle_seed)
  assert dataset.meta_data['generator_kind'] == 'host-numpy'
  assert len(made) == 2
  kwargs = dict(mode=jloader.types.DataMode(dataset_configs.mode),
                add_images=dataset_configs.add_images,
                add_rasters=dataset_configs.add_rasters,
                add_lidar_rays=dataset_configs.add_lidar_rays,
                num_rays=dataset_configs.get('num_rays'))
  return {'train': made[0], 'eval': made[1]}, kwargs


def _jax_eval_data(eval_config, config, location):
  """The data config ``evaluator.py:get_model_and_dataset`` builds."""
  xp = jconfig_utils.configs_merge(
      getattr(jdefaults, config.data.name)(), config.data)
  keys = ('voxel_size', 'add_images', 'add_lidar_rays', 'add_rasters',
          'mode', 'num_views', 'image_size')
  override = {k: xp.get(k) for k in keys if k in xp}
  data = jconfig_utils.configs_merge(eval_config.data.loader,
                                     ml_collections.ConfigDict(override))
  with data.unlocked():
    data.locations.training = location
    data.locations.evaluation = location
  return data


def _train_case():
  ref = train_localization.get_config('scale=full1chip,pose_backend=exhaustive')
  return ref.data, ref.batch_size, ref.shuffle_seed


def _smoke_train_case():
  ref = smoke_localization.get_config('pose_backend=exhaustive')
  return ref.data, ref.batch_size, ref.shuffle_seed


def _eval_case():
  ev = eval_localization.get_config()
  xp = train_localization.get_config('scale=full1chip')
  city = jdefaults.DATA_SPLITS_CITIES[ev.data.split][0]
  location = ev.data.name_pattern.format(city)
  return (_jax_eval_data(ev, xp, location), ev.batch_size,
          ev.data.rng_seed)


def _smoke_eval_case():
  ev = smoke_eval_localization.get_config()
  xp = smoke_localization.get_config()
  location = ev.data.name_pattern.format(ev.data.split)
  return (_jax_eval_data(ev, xp, location), ev.batch_size,
          ev.data.rng_seed)


@pytest.mark.parametrize('name,split,case,index', [
    ('train_full1chip_exhaustive', 'train', _train_case, 0),
    ('smoke_train_exhaustive', 'train', _smoke_train_case, 5),
    ('eval_full1chip_ransac', 'eval', _eval_case, 0),
    ('smoke_eval_ransac', 'eval', _smoke_eval_case, 3),
])
def test_examples_equal_the_jax_loaders(monkeypatch, name, split, case,
                                        index):
  cfg = configs.get_config(name)
  dataset_configs, batch_size, shuffle_seed = case()
  jgens, kwargs = _jax_generators(monkeypatch, dataset_configs, batch_size,
                                  shuffle_seed)
  gen = loader.split_generator(cfg.data, split)
  assert gen.seed == jgens[split].seed
  got = loader.make_pair_examples(gen, [index], cfg.data)
  want = jloader._stack_examples([jgens[split].make_example(index, **kwargs)])
  flat_got = jax.tree_util.tree_leaves_with_path(got)
  flat_want = jax.tree_util.tree_leaves_with_path(want)
  assert [p for p, _ in flat_got] == [p for p, _ in flat_want]
  for (path, g), (_, w) in zip(flat_got, flat_want):
    np.testing.assert_array_equal(np.asarray(g), np.asarray(w),
                                  err_msg=str(path))


def test_location_seed_is_the_jax_one():
  for location, base in ((None, 7), ('', 3), ('osaka-synthetic_eval', 1),
                         (configs.TRAIN_LOCATIONS, 1234567)):
    assert loader.location_seed(location, base) == jloader.location_seed(
        location, base)


def test_split_seeds():
  """Salt 0 for train, 1 for eval; the eval split falls back to the
  training location."""
  data = configs.DataConfig(
      locations=configs.LocationsConfig(training='a-city'), shuffle_seed=5)
  assert loader.split_generator(data, 'train').seed == (
      loader.location_seed('a-city', 5))
  assert loader.split_generator(data, 'eval').seed == (
      loader.location_seed('a-city', 6))
  bare = configs.DataConfig()
  assert loader.split_generator(bare, 'eval').seed == 1
