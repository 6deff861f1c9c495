"""The recall gate: the trained weights through the port and through JAX.

The export ``pretrained/loc_full1chip_r5`` (exhaustive backend, effective
step 12500) is evaluated on the first four examples of
'zurich-synthetic_eval' under ``eval_localization.py:evaluation_size=4,
batch_size=1`` (f32, dense refinement) by the JAX package's own
``evaluator.run_for_location`` and by the port's, on the host generator's
examples (bit-equal on both sides, ROADMAP C12), and the dumps are held
example by example. Full width: marked ``slow``.

Run as a script, the file writes the port's workdir of an export (the
JAX restore is read here, since no module of the port may import JAX):

    python tests/test_torch_recall.py --export weights/loc_full1chip_r5

writes ``params.npz`` (f32, '/'-joined flax paths), ``config.json`` (the
experiment's config as a dict, tuples as lists) and ``checkpoint.json``
(the step). ``weights/`` is listed in ``.gitignore``.
"""

import os
import pathlib
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]
if __name__ == '__main__':
  # The export reads the checkpoint on the host.
  os.environ['JAX_PLATFORMS'] = 'cpu'
  sys.path.insert(0, str(REPO))

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import shutil  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from snap_tpu import evaluator as jevaluator  # noqa: E402
from snap_tpu.configs import eval_localization  # noqa: E402
from snap_tpu.train_lib import checkpoints  # noqa: E402
from snap_tpu.utils import configs as jconfig_utils  # noqa: E402
from snap_tpu_torch import configs  # noqa: E402
from snap_tpu_torch import convert  # noqa: E402
from snap_tpu_torch import evaluator  # noqa: E402

torch.set_num_threads(2)

EXPORT = REPO / 'pretrained' / 'loc_full1chip_r5'
WEIGHTS = REPO / 'weights' / 'loc_full1chip_r5'
LOCATION = 'zurich-synthetic_eval'
NUM_EXAMPLES = 4
# ROADMAP C16's rule for the best volume index: equal, or the reference's
# score at the port's argmax within (atol, rtol) of its maximum.
SCORE_TOL = (1e-5, 1e-4)
# Where the argmax agrees: the pose errors of the two.
METER_ATOL = 1e-2
DEG_ATOL = 1e-2


def export_workdir(source: pathlib.Path, out: pathlib.Path) -> pathlib.Path:
  """The port's workdir of the JAX experiment (or export) ``source``, at
  its latest checkpoint."""
  source, out = pathlib.Path(source), pathlib.Path(out)
  step = checkpoints.latest_step(source)
  export = source / 'export.json'
  if export.exists():
    effective = json.loads(export.read_text())['effective_step']
    if effective != step:
      raise ValueError(f'{source}: checkpoint step {step} but effective '
                       f'step {effective} in export.json')
  params = checkpoints.restore_params(source, step)
  out.mkdir(parents=True, exist_ok=True)
  np.savez(out / evaluator.PARAMS_FILE, **{
      k: np.asarray(v, np.float32)
      for k, v in convert.flatten_params(params).items()})
  config = jconfig_utils.config_load(source).to_dict()
  (out / evaluator.CONFIG_FILE).write_text(json.dumps(config, indent=1))
  (out / evaluator.CHECKPOINT_FILE).write_text(
      json.dumps({'step': int(step)}))
  return out


@pytest.fixture(scope='module')
def weights():
  if not (WEIGHTS / evaluator.PARAMS_FILE).exists():
    export_workdir(EXPORT, WEIGHTS)
  return WEIGHTS


def _with_volume(pack):
  """``pack`` with each example's flattened pose volume added."""
  def packed(metrics, losses, data, pred):
    out = pack(metrics, losses, data, pred)
    volume = pred['scores_pose_volume']
    out['volume'] = volume.reshape(volume.shape[0], -1)
    return out
  return packed


@pytest.mark.slow
def test_trained_weights_localize_as_jax(tmp_path, weights, monkeypatch):
  monkeypatch.setattr(jevaluator, 'pack_localization_metrics', _with_volume(
      jevaluator.pack_localization_metrics))
  monkeypatch.setattr(evaluator, 'pack_localization_metrics', _with_volume(
      evaluator.pack_localization_metrics))
  jax_dir = tmp_path / 'jax'
  jax_dir.mkdir()
  shutil.copy(EXPORT / 'config.yaml', jax_dir / 'config.yaml')
  (jax_dir / 'checkpoints').symlink_to(EXPORT / 'checkpoints')
  jeval = eval_localization.get_config(
      f'evaluation_size={NUM_EXAMPLES},batch_size=1')
  jeval.workdir = str(jax_dir)
  want, _ = jevaluator.run_for_location(LOCATION, jeval)

  port_dir = tmp_path / 'port'
  port_dir.mkdir()
  for name in (evaluator.PARAMS_FILE, evaluator.CONFIG_FILE,
               evaluator.CHECKPOINT_FILE):
    (port_dir / name).symlink_to(weights / name)
  ec = configs.eval_localization(evaluation_size=NUM_EXAMPLES, batch_size=1)
  ec = dataclasses.replace(ec, workdir=str(port_dir), data=dataclasses.replace(
      ec.data, loader=dataclasses.replace(ec.data.loader,
                                          on_device_generation=False)))
  got, record = evaluator.run_for_location(LOCATION, ec, device='cpu')
  assert record['data_generator_kind'] == 'host-numpy'
  np.testing.assert_array_equal(got['pair_id'], want['pair_id'])

  print('example | best index JAX, port | error m JAX, port | error deg '
        'JAX, port | recall_top1')
  near_ties = 0
  for i in range(NUM_EXAMPLES):
    scores = want['volume'][i]
    best, port_best = int(scores.argmax()), int(got['volume'][i].argmax())
    print(i, '|', best, port_best, '|', want['error_max_meter'][i],
          got['error_max_meter'][i], '|', want['error_max_deg'][i],
          got['error_max_deg'][i], '|', want['recall_top1'][i])
    if port_best != best:
      near_ties += 1
      assert scores[port_best] >= scores[best] - (
          SCORE_TOL[0] + SCORE_TOL[1] * abs(scores[best])), i
      continue
    assert abs(got['error_max_meter'][i]
               - want['error_max_meter'][i]) <= METER_ATOL, i
    assert abs(got['error_max_deg'][i]
               - want['error_max_deg'][i]) <= DEG_ATOL, i
  print(f'best index at a near tie in {near_ties} of {NUM_EXAMPLES}')
  np.testing.assert_array_equal(got['recall_top1'], want['recall_top1'])


def main(argv=None) -> None:
  parser = argparse.ArgumentParser(description='Write the port\'s workdir '
                                   'of a JAX export.')
  parser.add_argument('--export', required=True, help='the output workdir')
  parser.add_argument('--source', default=str(EXPORT))
  args = parser.parse_args(argv)
  out = export_workdir(pathlib.Path(args.source), pathlib.Path(args.export))
  print(json.dumps({'workdir': str(out), 'step': evaluator.read_checkpoint_step(
      out), 'params_bytes': (out / evaluator.PARAMS_FILE).stat().st_size}))


if __name__ == '__main__':
  main()
