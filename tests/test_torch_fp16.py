"""fp16 training and serving (``dtype_str='float16'``) against the JAX
package's, on the CPU at smoke size.

The loss scale against flax's ``DynamicScale`` step by step; one fp16 train
step of the tiny localizer (``tests/torch_a14.py``'s street-view + aerial
smoke model) against ``snap_tpu.train_lib.trainer.train_step`` with its
``DynamicScale(minimum_scale=256.0)``, JAX's draws injected and its relus'
sides replayed, until the first finite step; the fp16 forward; a resume
in fp16; the config's round trip; the evaluator on an fp16 workdir; and
the kernels' plain versions in fp16 against JAX's ``view_scan`` functions
in fp16, forward and VJP, a non-finite cotangent included.

Where JAX rounds the template sampler's coordinates to the plane's dtype
(ROADMAP C2) the model tests give JAX's ``interpolate_patch_2d`` f32
coordinates, weights and sums, rounded once, which is what K2 and its plain
version compute; ``test_c2_moves_the_fp16_volume`` measures what C2 does
in fp16 without that.
"""

import contextlib
import copy
import dataclasses
import json
import math

import flax.linen as nn
from flax.training import dynamic_scale as flax_dynamic_scale
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import chip_smoke
from snap_tpu.models import bev_localizer as jbev_localizer
from snap_tpu.ops import view_scan as jview_scan
from snap_tpu.train_lib import lr_schedules as jlr_schedules
from snap_tpu.train_lib import optimizers as joptimizers
from snap_tpu.train_lib import trainer as jtrainer
from snap_tpu.utils import geometry as jgeometry
from snap_tpu_torch import configs
from snap_tpu_torch import convert
from snap_tpu_torch import evaluator
from snap_tpu_torch.models import bev_mapper
from snap_tpu_torch.ops import view_scan
from snap_tpu_torch.train_lib import checkpoints
from snap_tpu_torch.train_lib import dynamic_scale
from snap_tpu_torch.train_lib import optimizers
from snap_tpu_torch.train_lib import trainer
from snap_tpu_torch.utils import geometry
import test_torch_view_scan
import torch_a14
import torch_heads

torch.set_num_threads(2)

# fp16 rounds at 2^-11 relative; each package rounds at its own places
# (C3: JAX forms the lift's tap weights in fp16, the port in f32), so the
# planes differ by a few fp16 roundings of their largest entries: measured
# 1.2e-3 and 1.5e-3 of the largest magnitude (map, query).
PLANE_RTOL_OF_MAX = 4e-3
# The pose volume (f32 after the FFT's cast in both) and the loss inherit
# the planes' differences: measured 3e-4 relative on the loss.
LOSS_RTOL = 2e-3
VOLUME_RTOL_OF_MAX = 4e-3
# Each gradient leaf against its largest entry: fp16 activations' roundings
# through the encoders' backward, with JAX's relu sides replayed (measured
# 4.3% at the worst leaf, a GroupNorm scale; without the replay 7.8%).
GRAD_RTOL_OF_MAX = 0.1
# A replayed relu or max choice: within two fp16 roundings of a tie,
# relative to the site's largest magnitude.
CHOICE_GAP_RTOL = 2.0**-10
# The kernels' plain versions against JAX's, both in fp16: JAX rounds the
# tap weights and (K2) the sums in fp16, the port once at the end; a few
# fp16 ulps of the outputs' magnitude.
KERNEL_ATOL, KERNEL_RTOL = 4e-3, 2.0**-8


def _flax_scale(**kw):
  return flax_dynamic_scale.DynamicScale(**kw)


@pytest.mark.parametrize('start,interval,finite', [
    # Growth every 2 finite steps, with non-finite steps between.
    (1024.0, 2, [True] * 7 + [False] + [True] * 5),
    # Back-off to the floor of 256, and staying there.
    (4096.0, 2000, [False] * 7 + [True, False, True]),
    # Growth capped at the largest f32, then a back-off from it.
    (2.0**126, 1, [True] * 7 + [False, True, True]),
])
def test_loss_scale_follows_flax_step_by_step(start, interval, finite):
  """The port's rule against flax's ``DynamicScale.value_and_grad`` over a
  scripted run of finite and non-finite gradients: the scale and
  ``fin_steps`` equal at every step."""
  ref = _flax_scale(minimum_scale=256.0, scale=start,
                    growth_interval=interval)
  port = dynamic_scale.DynamicScale(minimum_scale=256.0, scale=start,
                                    growth_interval=interval)
  step = jax.jit(lambda ds, c: ds.value_and_grad(
      lambda p, c: (p * c).sum())(jnp.ones(2), c))
  seen = set()
  for fin in finite:
    ref, is_fin, _, _ = step(ref, jnp.asarray([1.0, 1.0 if fin else np.inf],
                                              jnp.float32))
    port = port.update(fin)
    assert bool(is_fin) == fin
    assert port.scale == float(ref.scale)
    assert port.fin_steps == int(ref.fin_steps)
    seen.add(port.scale)
  if interval == 1:
    assert dynamic_scale.F32_MAX in seen
  if interval == 2000:
    assert 256.0 in seen


def test_loss_scale_defaults_are_flax_and_the_reference():
  ref = _flax_scale(minimum_scale=256.0)
  port = dynamic_scale.for_dtype('float16')
  for field in ('growth_factor', 'backoff_factor', 'growth_interval',
                'fin_steps', 'scale', 'minimum_scale'):
    assert getattr(port, field) == getattr(ref, field), field
  assert dynamic_scale.DynamicScale().minimum_scale == float(
      _flax_scale().minimum_scale)
  assert dynamic_scale.for_dtype('bfloat16') is None
  assert dynamic_scale.for_dtype('float32') is None


def test_from_reference_takes_float16_and_raises_on_other_dtypes():
  config = dataclasses.replace(configs.smoke_train_exhaustive(),
                               dtype_str='float16')
  ref = json.loads(json.dumps(configs.to_reference(config)))
  assert ref['dtype_str'] == 'float16'
  assert configs.from_reference(ref) == config
  for bad in ('float64', 'half', None):
    with pytest.raises(ValueError, match='dtype_str'):
      configs.from_reference({**ref, 'dtype_str': bad})
  with pytest.raises(ValueError, match='dtype_str'):
    evaluator.build_model(dataclasses.replace(config, dtype_str='int8'),
                          'cpu')


def _jax_f32_template_coords(monkeypatch):
  """JAX's template sampler with f32 coordinates, weights and sums, its
  values rounded once to the plane's dtype (K2's arithmetic; C2)."""
  original = jview_scan.interpolate_patch_2d

  def sample(array, valid, points):
    values, ok = original(array.astype(jnp.float32), valid, points)
    return values.astype(array.dtype), ok
  monkeypatch.setattr(jview_scan, 'interpolate_patch_2d', sample)


@pytest.fixture(scope='module')
def models():
  """The tiny localizer of both packages in fp16, JAX's weights in both."""
  config = dataclasses.replace(torch_a14.port_config(), dtype_str='float16')
  jcfg = torch_a14.jax_config()
  jbatch, batch = torch_a14.pair_batches(config)
  jmodel = jbev_localizer.BEVLocalizerModel(
      jcfg.model, torch_heads.jax_meta(config), jnp.float16)
  rngs = {'params': jax.random.PRNGKey(0), 'sampling': jax.random.PRNGKey(1)}
  params = jax.jit(lambda b: jmodel.flax_model.init(rngs, b, train=False))(
      jbatch)['params']
  model = torch_heads.port_model(config, jax.tree_util.tree_map(np.asarray,
                                                                params))
  return config, jcfg, jmodel, params, model, jbatch, batch


def _rel_of_max(got, want):
  got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
  return np.abs(got - want).max() / np.abs(want).max()


@pytest.fixture(scope='module')
def fp16_forward(models):
  """The fp16 forward (``train=False``) of both packages on one batch,
  JAX's with and without f32 template coordinates."""
  _, _, jmodel, params, model, jbatch, batch = models

  def jax_forward():
    def fn(p, b):
      pred = jmodel.flax_model.apply({'params': p}, b, train=False,
                                     rngs={'sampling': jax.random.PRNGKey(2)})
      losses, _ = jmodel.loss_metrics_function(pred, b, p)
      return pred, losses
    return jax.jit(fn)(params, jbatch)
  c2 = jax_forward()
  with pytest.MonkeyPatch.context() as mp:
    _jax_f32_template_coords(mp)
    want = jax_forward()
  with torch.no_grad():
    _, losses, _, pred = trainer.loss_and_metrics(model, batch, False)
  return want, c2, (pred, losses), model


@pytest.mark.parametrize('scene', ['map', 'query'])
def test_fp16_planes_match_jax(fp16_forward, scene):
  (want, _), _, (got, _), model = fp16_forward
  w, g = want[scene]['bev_matching'], got[scene]['bev_matching']
  assert g.features.dtype == torch.float16 and w.features.dtype == jnp.float16
  assert next(model.parameters()).dtype == torch.float32  # f32 masters
  np.testing.assert_array_equal(g.valid.numpy(), np.asarray(w.valid))
  assert _rel_of_max(g.features.float(), w.features) < PLANE_RTOL_OF_MAX


def test_fp16_volume_and_loss_match_jax(fp16_forward):
  (want, want_losses), _, (got, losses), _ = fp16_forward
  w = np.asarray(want['scores_pose_volume'])
  g = got['scores_pose_volume'].numpy()
  np.testing.assert_array_equal(np.isfinite(g), np.isfinite(w))
  fin = np.isfinite(w)
  assert fin.any() and _rel_of_max(g[fin], w[fin]) < VOLUME_RTOL_OF_MAX
  np.testing.assert_allclose(losses['total'].numpy(),
                             np.asarray(want_losses['total']), rtol=LOSS_RTOL)
  assert np.isfinite(losses['total'].numpy()).all()


def test_c2_moves_the_fp16_volume(fp16_forward):
  """ROADMAP C2 in fp16: JAX's template sampler rounds its coordinates to
  fp16, which moves sample points by up to a 2^-11 of their value and
  with them the volume's validity and values; the port keeps them in f32.
  Recorded, not repaired (the port's volume is the f32 coordinates')."""
  (want, _), (c2, _), (got, _), _ = fp16_forward
  w = np.asarray(want['scores_pose_volume'])
  c = np.asarray(c2['scores_pose_volume'])
  g = got['scores_pose_volume'].numpy()
  assert (np.isfinite(c) != np.isfinite(g)).any()
  fin = np.isfinite(c) & np.isfinite(w)
  assert _rel_of_max(c[fin], w[fin]) > 10 * _rel_of_max(g[fin], w[fin])


def _record_draws_and_sides(monkeypatch):
  """Patches JAX so that a traced step records its Bernoulli and uniform
  draws, its relus' sides and the trees ``optax.global_norm`` takes (the
  gradients first): return the lists from the traced function."""
  monkeypatch.setattr(nn, 'remat', lambda module, *args, **kwargs: module)
  stack = contextlib.ExitStack()
  lists = [stack.enter_context(torch_heads.recorded(
      monkeypatch, module, name, keep)) for module, name, keep in (
          (jax.random, 'bernoulli', lambda args, out: out),
          (jax.random, 'uniform', lambda args, out: out),
          (nn, 'relu', lambda args, out: args[0] > 0),
          (optax, 'global_norm', lambda args, out: args[0]))]
  return stack, lists


def _port_step(state, batch, adam, draws, relu_sides):
  """``trainer.train_step`` with ``draws`` injected and the relus on
  ``relu_sides``, the other max sites on their own choices."""
  replay = torch_heads.relu_replay(state.model, batch, True, relu_sides,
                                   draws=draws)
  with chip_smoke.MaxChoices(state.model, replay=replay,
                             gap_rtol=CHOICE_GAP_RTOL):
    return trainer.train_step(state, batch, adam, draws=draws)


@pytest.fixture(scope='module')
def fp16_steps(models):
  """Both packages' fp16 train steps from one state, the reference's
  ``DynamicScale(minimum_scale=256.0)`` on both, on one batch, until the
  first finite step; each step's (is_finite, loss_scale, loss, grads) on
  each side."""
  config, jcfg, jmodel, params, model, jbatch, batch = models
  model = copy.deepcopy(model)
  lr_fn = jlr_schedules.get_learning_rate_fn(jcfg)
  tx = joptimizers.get_optimizer(jcfg, lr_fn, params=params)
  jstate = jtrainer.TrainState(
      global_step=jnp.zeros((), jnp.int32), params=params,
      opt_state=tx.init(params), model_state={},
      rng=jax.random.PRNGKey(3), tx=tx,
      dynamic_scale=_flax_scale(minimum_scale=256.0))
  adam = optimizers.get_optimizer(config.train, model)
  state = trainer.create_train_state(model, adam, seed=0,
                                     dynamic_scale=dynamic_scale.for_dtype(
                                         config.dtype_str))
  steps = []
  with pytest.MonkeyPatch.context() as mp:
    _jax_f32_template_coords(mp)
    stack, lists = _record_draws_and_sides(mp)
    with stack:

      def traced(s, b):
        for recorded in lists:
          del recorded[:]
        out = jtrainer.train_step(
            s, b, flax_model=jmodel.flax_model,
            loss_metrics_fn=jmodel.loss_metrics_function, lr_fn=lr_fn,
            has_model_state=False)
        return out, [list(recorded) for recorded in lists]
      step_fn = jax.jit(traced)
      for _ in range(12):
        (jstate, jmetrics, jlogs), (taken, drawn, sides, norms) = step_fn(
            jstate, jbatch)
        z_jitter, = drawn
        draws = bev_mapper.TrainDraws(
            z_jitter=torch.as_tensor(np.array(z_jitter)),
            modality_keep=torch_heads.modality_keep(np.asarray(taken[0])))
        out = _port_step(state, batch, adam, draws,
                         [torch.as_tensor(np.array(s)) for s in sides])
        loss = lambda m: float(m['loss/total'][0]) / float(
            m['loss/total'][1])
        steps.append(dict(
            want=(bool(jlogs['is_finite']), float(jlogs['loss_scale']),
                  loss(jmetrics), convert.flatten_params(
                      jax.tree_util.tree_map(np.asarray, norms[0]))),
            got=(bool(out.logs['is_finite']), out.logs['loss_scale'],
                 loss(out.metrics), out.grads)))
        if steps[-1]['want'][0] or steps[-1]['got'][0]:
          break
  return steps, model


def test_fp16_steps_skip_and_scale_as_jax(fp16_steps):
  """The same steps skipped, and the same scale after each step: on this
  batch the initial 65536 overflows fp16 and the scale backs off before
  the first finite step."""
  steps, _ = fp16_steps
  assert [s['got'][:2] for s in steps] == [s['want'][:2] for s in steps]
  assert len(steps) >= 2 and steps[-1]['got'][0]  # backed off, then finite
  assert [s['got'][1] for s in steps] == [
      65536.0 * 0.5**(i + 1) for i in range(len(steps) - 1)] + [
          65536.0 * 0.5**(len(steps) - 1)]


def test_fp16_finite_step_matches_jax(fp16_steps):
  """At the first finite step, the loss and every gradient leaf (unscaled,
  f32) against JAX's."""
  steps, model = fp16_steps
  (_, _, want_loss, want), (_, _, got_loss, grads) = (
      steps[-1]['want'], steps[-1]['got'])
  assert math.isfinite(got_loss)
  assert got_loss == pytest.approx(want_loss, rel=LOSS_RTOL)
  got = convert.flax_from_torch(grads, model)
  assert set(got) == set(want)
  for key in sorted(want):
    assert got[key].dtype == np.float32 and want[key].dtype == np.float32
    scale = float(np.abs(want[key]).max())
    err = float(np.abs(got[key] - want[key]).max())
    assert err <= GRAD_RTOL_OF_MAX * scale, (key, err, scale)
  trunk = 'bev_mapper/streetview_encoder/image_encoder/encoder/'
  assert np.abs(got[trunk + 'root_block/conv_root/kernel']).max() > 0


@pytest.fixture
def one_thread():
  """One summation order in oneDNN's convolution backward
  (``tests/test_torch_resume.py``)."""
  threads = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(threads)


def _smoke_fp16():
  return dataclasses.replace(configs.smoke_train_exhaustive(),
                             dtype_str='float16')


def _state(cfg, seed, scale=None):
  model = evaluator.build_model(cfg, 'cpu', seed)
  adam = optimizers.get_optimizer(cfg.train, model)
  return trainer.create_train_state(model, adam, seed=seed,
                                    dynamic_scale=scale), adam


def test_fp16_resume_keeps_the_loss_scale_and_the_step(tmp_path, one_thread):
  """The loss scale and ``fin_steps`` survive a checkpoint, and the step
  after the resume equals the live run's bit for bit, its new scale too;
  a checkpoint restores only into a run of its kind (with a scale or
  without)."""
  cfg = _smoke_fp16()
  batches = [torch_a14.pair_batches(cfg, seed=2 + i)[1] for i in range(3)]
  # A growth every finite step: the scale moves from the default.
  scale = dynamic_scale.DynamicScale(minimum_scale=256.0, scale=2.0**14,
                                     growth_interval=1)
  live, adam = _state(cfg, 0, scale)
  logs = [trainer.train_step(live, b, adam).logs for b in batches[:2]]
  assert [l['is_finite'] for l in logs] == [1.0, 1.0]
  assert [l['loss_scale'] for l in logs] == [2.0**14, 2.0**15]
  assert live.dynamic_scale.fin_steps == 0
  checkpoints.save_checkpoint(tmp_path, live, live.global_step)
  restored, restored_adam = _state(cfg, 7, scale)
  checkpoints.restore_checkpoint(tmp_path, restored)
  assert restored.dynamic_scale == live.dynamic_scale
  a = trainer.train_step(live, batches[2], adam)
  b = trainer.train_step(restored, batches[2], restored_adam)
  assert a.logs == b.logs and 'loss_scale' in a.logs
  for name in a.grads:
    assert torch.equal(a.grads[name], b.grads[name]), name
  for (name, p), (_, q) in zip(live.model.named_parameters(),
                               restored.model.named_parameters()):
    assert torch.equal(p, q), name
  assert restored.dynamic_scale == live.dynamic_scale
  bf16 = dataclasses.replace(cfg, dtype_str='bfloat16')
  other, _ = _state(bf16, 0)
  with pytest.raises(ValueError, match='dynamic loss scale'):
    checkpoints.restore_checkpoint(tmp_path, other)
  checkpoints.save_checkpoint(tmp_path / 'bf16', other, 0)
  with pytest.raises(ValueError, match='dynamic loss scale'):
    checkpoints.restore_checkpoint(tmp_path / 'bf16', restored)


def test_evaluator_serves_an_fp16_workdir(tmp_path):
  """A workdir trained in fp16 (its ``config.json`` says so, its
  checkpoint keeps the scale) is served by ``evaluator.run`` in fp16, the
  held-out protocol's smoke config: finite metrics, the step read."""
  from snap_tpu_torch import train  # pylint: disable=g-import-not-at-top
  result = train.train(_smoke_fp16(), device='cpu', workdir=str(tmp_path),
                       stop_at_step=2)
  assert all('loss_scale' in logs for logs in result['logs'])
  record = json.loads((tmp_path / 'config.json').read_text())
  assert record['dtype_str'] == 'float16'
  assert configs.from_reference(record).dtype_str == 'float16'
  eval_config = dataclasses.replace(
      configs.smoke_eval_localization(), workdir=str(tmp_path),
      dtype_str='float16')
  (results, record), = evaluator.run(eval_config, device='cpu').values()
  assert record['eval_checkpoint_step'] == 2
  assert record['dtype_str'] == 'float16'
  assert results['error_max_meter'].shape == (4,)
  assert np.isfinite(results['error_max_meter']).all()


def _lift_pair(dtype, g_bad=None):
  """``pool_views_stream`` of both packages in ``dtype`` on
  ``tests/test_torch_view_scan.py``'s inputs (top-k 3): the stats, and the
  VJP in the images and scores of a seeded cotangent of the mean and
  variance (with ``g_bad`` at a valid point's mean channel 3)."""
  x = test_torch_view_scan._lift_inputs(seed=7, top_k=3)
  f_images, scores = (x['f_images'].astype(dtype), x['scores'].astype(dtype))
  pose = jgeometry.Transform3D(R=jnp.asarray(x['pose']['R']),
                               t=jnp.asarray(x['pose']['t']))
  cam = jgeometry.FisheyeCamera.from_dict(x['cam']).scale(
      jnp.asarray([0.25, 0.25]))
  want, vjp = jax.vjp(lambda f, s: jview_scan.pool_views_stream(
      f, s, pose, cam, jnp.asarray(x['points']), top_k=3,
      depth_min_max=(1.0, 32.0), add_minmax=False,
      use_variance=True).stats, jnp.asarray(f_images), jnp.asarray(scores))
  tf = torch.from_numpy(f_images).requires_grad_()
  ts = torch.from_numpy(scores).requires_grad_()
  got = view_scan.pool_views_stream(
      tf, ts, geometry.Transform3D(R=torch.from_numpy(x['pose']['R']),
                                   t=torch.from_numpy(x['pose']['t'])),
      geometry.FisheyeCamera.from_dict(x['cam']).scale(
          torch.tensor([0.25, 0.25])),
      torch.from_numpy(np.ascontiguousarray(x['points'])), top_k=3,
      depth_min_max=(1.0, 32.0))
  g = np.random.default_rng(1).normal(size=want.shape).astype(dtype)
  # The score max's cotangent goes to the rank that holds the max, and the
  # two packages' fp16 scores differ by fp16 roundings (C3), so at a near
  # tie they give it to different ranks (C10): held in f32 elsewhere.
  g[..., -1] = 0
  at = None
  if g_bad is not None:
    at = tuple(np.argwhere(got.valid.numpy())[5])
    g[at + (3,)] = g_bad
  want_grads = [np.asarray(v, np.float32) for v in vjp(jnp.asarray(g))]
  got_grads = [v.float().numpy() for v in torch.autograd.grad(
      got.stats, [tf, ts], torch.from_numpy(g))]
  return (np.asarray(want, np.float32), got.stats.detach().float().numpy(),
          want_grads, got_grads, at)


def _assert_kernel_close(got, want, fin):
  np.testing.assert_allclose(got[fin], want[fin], atol=KERNEL_ATOL,
                             rtol=KERNEL_RTOL)


def test_lift_plain_fp16_matches_jax():
  """K1's and K3's plain versions in fp16 (via ``pool_views_stream``)
  against JAX's fp16 stream, stats and VJP."""
  want, got, want_grads, got_grads, _ = _lift_pair(np.float16)
  _assert_kernel_close(got, want, np.isfinite(want))
  for w, g in zip(want_grads, got_grads):
    assert np.isfinite(w).all() and np.isfinite(g).all()
    _assert_kernel_close(g, w, np.ones(w.shape, bool))


@pytest.mark.parametrize('bad', [np.inf, np.nan])
def test_lift_plain_fp16_non_finite_cotangent_reaches_the_gradient(bad):
  """A non-finite cotangent at a valid point makes both packages' image
  gradients non-finite, and the scores' at the same entries; the port's
  non-finite image entries are JAX's, which also holds NaN where JAX takes
  ``0 * inf`` at the point's ranks that are not selected (the port skips
  them, as K3 does: ROADMAP C28). The finite entries agree."""
  _, _, (want_f, want_s), (got_f, got_s), at = _lift_pair(np.float16, bad)
  fin_f, fin_s = np.isfinite(want_f), np.isfinite(want_s)
  assert not np.isfinite(got_f).all() and not fin_s.all()
  np.testing.assert_array_equal(np.isfinite(got_s), fin_s)
  assert (fin_f <= np.isfinite(got_f)).all()  # the port's are JAX's
  extra = fin_f != np.isfinite(got_f)
  assert not extra[..., :3].any() and not extra[..., 4:].any()
  assert not extra[1 - at[0]].any()  # the other example has none
  _assert_kernel_close(got_f, want_f, fin_f)
  _assert_kernel_close(got_s, want_s, fin_s)


@pytest.mark.parametrize('bad', [None, np.inf])
def test_patch_sampler_plain_fp16_matches_jax(bad):
  """K2's and K4's plain versions (``interpolate_patch_2d``) in fp16
  against JAX's in fp16 at points that fp16 holds exactly (C2 then moves
  none), values, validity and VJP; an infinite cotangent reaches the same
  entries of both gradients (NaN at a tap of weight 0)."""
  rng = np.random.default_rng(12)
  h, w, d = 7, 9, 5
  array = rng.normal(size=(h, w, d)).astype(np.float16)
  valid = rng.random((h, w)) < 0.8
  points = np.round(rng.uniform([-1, -1], [h + 1, w + 1], size=(300, 2))
                    * 64) / 64
  points[:20] = np.round(points[:20])  # cell edges
  points = points.astype(np.float32)
  assert (points.astype(np.float16).astype(np.float32) == points).all()
  (want, want_ok), vjp = jax.vjp(
      lambda a: jview_scan.interpolate_patch_2d(a, jnp.asarray(valid),
                                                jnp.asarray(points)),
      jnp.asarray(array))
  ta = torch.from_numpy(array)[None].requires_grad_()
  got, got_ok = view_scan.interpolate_patch_2d(
      ta, torch.from_numpy(valid)[None], torch.from_numpy(points)[None])
  np.testing.assert_array_equal(got_ok[0].numpy(), np.asarray(want_ok))
  assert got.dtype == torch.float16
  _assert_kernel_close(got[0].detach().float().numpy(),
                       np.asarray(want, np.float32), np.ones(want.shape, bool))
  g = rng.normal(size=want.shape).astype(np.float16)
  if bad is not None:
    g[40, 2] = bad
  want_g, = vjp((jnp.asarray(g), np.zeros(want_ok.shape, jax.dtypes.float0)))
  want_g = np.asarray(want_g, np.float32)
  got_g, = torch.autograd.grad(got, ta, torch.from_numpy(g)[None])
  got_g = got_g[0].float().numpy()
  fin = np.isfinite(want_g)
  np.testing.assert_array_equal(np.isfinite(got_g), fin)
  assert fin.all() == (bad is None)
  _assert_kernel_close(got_g, want_g, fin)
