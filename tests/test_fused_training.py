"""Fused multi-step training (steps.scanned_train_steps + the CLI's
--steps_per_call): one lax.scan dispatch must reproduce the per-step
loop — same pool rows, same fold_in(key, step) stream."""

import pytest

import json

from gencast_tpu.nn import nnx
import jax
import jax.numpy as jnp
import numpy as np

from gencast_tpu import configs
from gencast_tpu.training import steps as steps_lib


def _build(seed=0, builder=configs.build_gencast):
  model, statics = builder(configs.TINY, rngs=nnx.Rngs(seed))
  opt = steps_lib.create_optimizer(
      model, steps_lib.OptimizerConfig(total_steps=100))
  return model, opt, statics


def _pool(statics, model, m=3, seed=1):
  d = getattr(model, 'denoiser', model)  # GraphCast holds layouts itself
  nlat = statics.grid_lat.shape[0]
  nlon = statics.grid_lon.shape[0]
  rng = np.random.default_rng(seed)

  def arr(c):
    return jnp.asarray(
        rng.standard_normal((m, 1, nlat, nlon, c)), jnp.float32)

  return {'inputs': arr(d.input_layout.num_channels),
          'targets': arr(d.target_layout.num_channels),
          'forcings': arr(d.forcing_layout.num_channels)}


@pytest.mark.slow
def test_scanned_matches_per_step():
  model_a, opt_a, statics = _build()
  model_b, opt_b, _ = _build()
  pool = _pool(statics, model_a)
  key = jax.random.PRNGKey(7)
  idx = [1, 0, 2, 1]
  steps = list(range(4))

  # Per-step reference loop.
  per_step_losses = []
  for i, s in zip(idx, steps):
    loss, _ = steps_lib.train_step(
        model_a, opt_a, pool['inputs'][i], pool['targets'][i],
        pool['forcings'][i], jax.random.fold_in(key, s))
    per_step_losses.append(float(loss))

  # One fused dispatch.
  fused_fn, state = steps_lib.scanned_train_steps(model_b, opt_b)
  state, losses = fused_fn(state, pool, np.asarray(idx), key,
                           np.asarray(steps))
  nnx.update((model_b, opt_b), state)

  np.testing.assert_allclose(np.asarray(losses), per_step_losses,
                             rtol=2e-5, atol=1e-6)
  pa = nnx.state(model_a, nnx.Param)
  pb = nnx.state(model_b, nnx.Param)
  la, lb = jax.tree.leaves(pa), jax.tree.leaves(pb)
  assert len(la) == len(lb) and len(la) > 0
  for a, b in zip(la, lb):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                               rtol=2e-4, atol=2e-6)


@pytest.mark.slow
def test_scanned_matches_per_step_graphcast():
  """The fused scan is model-agnostic (uniform predictor.loss API): the
  deterministic family must reproduce its per-step loop too. GraphCast
  ignores the PRNG key, so agreement here pins batch selection + the
  optimizer-threading rather than the noise stream."""
  model_a, opt_a, statics = _build(builder=configs.build_graphcast)
  model_b, opt_b, _ = _build(builder=configs.build_graphcast)
  pool = _pool(statics, model_a)
  key = jax.random.PRNGKey(7)
  idx = [2, 0, 1]
  steps = list(range(3))

  per_step_losses = []
  for i, s in zip(idx, steps):
    loss, _ = steps_lib.train_step(
        model_a, opt_a, pool['inputs'][i], pool['targets'][i],
        pool['forcings'][i], jax.random.fold_in(key, s))
    per_step_losses.append(float(loss))

  fused_fn, state = steps_lib.scanned_train_steps(model_b, opt_b)
  state, losses = fused_fn(state, pool, np.asarray(idx), key,
                           np.asarray(steps))
  nnx.update((model_b, opt_b), state)

  np.testing.assert_allclose(np.asarray(losses), per_step_losses,
                             rtol=2e-5, atol=1e-6)
  pa = nnx.state(model_a, nnx.Param)
  pb = nnx.state(model_b, nnx.Param)
  la, lb = jax.tree.leaves(pa), jax.tree.leaves(pb)
  assert len(la) == len(lb) and len(la) > 0
  for a, b in zip(la, lb):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                               rtol=2e-4, atol=2e-6)


@pytest.mark.slow
def test_scanned_matches_per_step_ar():
  """Fused AR mode: each scan step trains the multi-step autoregressive
  loss. Must reproduce the per-step AR loop (train.py's ar_train_step)
  exactly — same pool rows, same fold_in(key, step) keys handed to
  autoregressive_loss."""
  from gencast_tpu import rollout as rollout_lib

  ar_k = 2
  model_a, opt_a, statics = _build(builder=configs.build_graphcast)
  model_b, opt_b, _ = _build(builder=configs.build_graphcast)
  nlat = statics.grid_lat.shape[0]
  nlon = statics.grid_lon.shape[0]
  rng = np.random.default_rng(3)
  m = 3

  def arr(c, *lead):
    return jnp.asarray(
        rng.standard_normal((m, *lead, 1, nlat, nlon, c)), jnp.float32)

  pool = {'inputs': arr(model_a.input_layout.num_channels),
          'targets': arr(model_a.target_layout.num_channels, ar_k),
          'forcings': arr(model_a.forcing_layout.num_channels, ar_k)}
  key = jax.random.PRNGKey(11)
  idx = [1, 2, 0]
  steps = list(range(3))

  @nnx.jit
  def ar_step(m_, opt_, inputs, targets, forcings, k):
    def loss_fn(mm):
      loss, _ = rollout_lib.autoregressive_loss(mm, inputs, targets,
                                                forcings, k)
      return loss.mean()

    loss, grads = nnx.value_and_grad(loss_fn)(m_)
    opt_.update(m_, grads)
    return loss

  per_step_losses = []
  for i, s in zip(idx, steps):
    loss = ar_step(model_a, opt_a, pool['inputs'][i], pool['targets'][i],
                   pool['forcings'][i], jax.random.fold_in(key, s))
    per_step_losses.append(float(loss))

  fused_fn, state = steps_lib.scanned_train_steps(model_b, opt_b, ar=True)
  state, losses = fused_fn(state, pool, np.asarray(idx), key,
                           np.asarray(steps))
  nnx.update((model_b, opt_b), state)

  np.testing.assert_allclose(np.asarray(losses), per_step_losses,
                             rtol=2e-5, atol=1e-6)
  la = jax.tree.leaves(nnx.state(model_a, nnx.Param))
  lb = jax.tree.leaves(nnx.state(model_b, nnx.Param))
  assert len(la) == len(lb) and len(la) > 0
  for a, b in zip(la, lb):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                               rtol=2e-4, atol=2e-6)


@pytest.mark.slow
def test_cli_fused_ar_smoke(tmp_path):
  from gencast_tpu.training import train

  metrics_jsonl = str(tmp_path / 'metrics.jsonl')
  train.main(['--model', 'graphcast', '--preset', 'tiny',
              '--ar_steps', '2', '--data', 'synthetic', '--steps', '4',
              '--steps_per_call', '2', '--log_every', '2',
              '--metrics_jsonl', metrics_jsonl])
  with open(metrics_jsonl) as f:
    events = [json.loads(line) for line in f]
  assert events and events[0]['event'] == 'train'
  assert events[0]['step'] == 2 and 'loss' in events[0]


@pytest.mark.slow
def test_cli_fused_graphcast_smoke(tmp_path):
  from gencast_tpu.training import train

  metrics_jsonl = str(tmp_path / 'metrics.jsonl')
  train.main(['--model', 'graphcast', '--preset', 'tiny',
              '--data', 'synthetic', '--steps', '4',
              '--steps_per_call', '2', '--log_every', '2',
              '--metrics_jsonl', metrics_jsonl])
  with open(metrics_jsonl) as f:
    events = [json.loads(line) for line in f]
  assert events and events[0]['event'] == 'train'
  assert events[0]['step'] == 2 and 'loss' in events[0]


@pytest.mark.slow
def test_cli_fused_smoke(tmp_path):
  from gencast_tpu.training import train

  metrics_jsonl = str(tmp_path / 'metrics.jsonl')
  ckpt = str(tmp_path / 'ckpt')
  train.main(['--preset', 'tiny', '--data', 'synthetic', '--steps', '4',
              '--steps_per_call', '2', '--log_every', '2',
              '--save_every', '4', '--ckpt_dir', ckpt,
              '--metrics_jsonl', metrics_jsonl])
  with open(metrics_jsonl) as f:
    events = [json.loads(line) for line in f]
  assert events and events[0]['event'] == 'train'
  assert events[0]['step'] == 2 and 'loss' in events[0]
  # Resume from the fused checkpoint through the fused path.
  train.main(['--preset', 'tiny', '--data', 'synthetic', '--steps', '6',
              '--steps_per_call', '2', '--ckpt_dir', ckpt])
