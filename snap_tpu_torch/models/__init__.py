"""The model registry (port of ``snap_tpu/models/__init__.py``)."""

import importlib
from typing import Callable

BASEPATH = 'snap_tpu_torch.models.{}'

# Registry name -> the module whose ``build(config, meta_data, dtype)``
# makes the model (``models/base.py``).
MODELS = {
    'occupancy_net': 'occupancy_net',
    'semantic_net': 'semantic_net',
    'bev_localizer': 'bev_localizer',
}


def get_model(name: str) -> Callable:
  """The builder ``build(config, meta_data, dtype)`` of a registry name."""
  if name not in MODELS:
    raise ValueError(f'Unknown model {name!r}; choose from {sorted(MODELS)}')
  return importlib.import_module(BASEPATH.format(MODELS[name])).build
