"""Convergence smoke: the framework must *learn*, not just differentiate.

~300 AdamW steps of the tiny preset on deterministic synthetic data
(sources.SyntheticSource) must at least halve the diffusion loss, and a
sampled one-step forecast from the trained model must beat climatology
(predicting the per-variable mean). Persistence is NOT the bar here: the
synthetic fields are AR(1) with coefficient 0.9, for which persistence is
within 5% of the optimal predictor — beating it is not resolvable in a
smoke test, while climatology is ~2.3x worse than optimal.
"""

import pytest

import dataclasses

from gencast_tpu.nn import nnx
import jax
import jax.numpy as jnp
import numpy as np

from gencast_tpu import configs, rollout
from gencast_tpu.data import registry, sources
from gencast_tpu.models import wrappers
from gencast_tpu.training import steps as steps_lib

NUM_STEPS = 300


@pytest.mark.slow
def test_tiny_training_converges():
  spec = configs.ModelSpec(
      name='tiny', task=registry.GENCAST_TASK, resolution_deg=10.0,
      mesh_splits=2, d_model=64, num_layers=2, num_heads=2,
      attention_k_hop=4, ffw_hidden=128)
  model, statics = configs.build_gencast(spec, rngs=nnx.Rngs(0))
  source = sources.SyntheticSource(spec.task, statics.grid_lat,
                                   statics.grid_lon, num_times=40, seed=0)
  stats = sources.compute_stats(source)
  wrapped = wrappers.InputsAndResiduals(model, stats)

  opt_cfg = steps_lib.OptimizerConfig(learning_rate=1e-3, warmup_steps=30,
                                      total_steps=NUM_STEPS)
  optimizer = steps_lib.create_optimizer(wrapped, opt_cfg)
  it = sources.batch_iterator(source, batch_size=2, seed=0)
  key = jax.random.PRNGKey(0)

  losses = []
  for step in range(NUM_STEPS):
    batch = next(it)
    loss, _ = steps_lib.train_step(
        wrapped, optimizer,
        jnp.asarray(batch['inputs']), jnp.asarray(batch['targets']),
        jnp.asarray(batch['forcings']), jax.random.fold_in(key, step))
    losses.append(float(loss))

  initial = float(np.mean(losses[:10]))
  final = float(np.mean(losses[-10:]))
  assert np.isfinite(final)
  assert final < 0.5 * initial, (
      f'loss did not halve in {NUM_STEPS} steps: {initial:.4f} -> '
      f'{final:.4f}')

  # One-step sampled forecast on a window beyond the training iterator's
  # early samples: must beat climatology (the stats mean).
  w = source.sample(len(source) - 1)
  preds = rollout.sample_rollout(
      wrapped, jnp.asarray(w.inputs)[None],
      jnp.asarray(w.forcings)[None][None], jax.random.PRNGKey(42))
  pred = np.asarray(preds[0, 0])                     # [lat, lon, C]
  truth = np.asarray(w.targets)                      # [lat, lon, C]

  tgt_layout = model.denoiser.target_layout
  clim = np.zeros_like(truth)
  for name in tgt_layout.var_names:
    chans = tgt_layout.var_channels(name)
    mean = np.asarray(stats.mean[name], np.float32).reshape(-1)
    for i, c in enumerate(chans):
      clim[..., c] = mean[i % mean.size] if mean.size else 0.0

  rmse_model = float(np.sqrt(np.mean((pred - truth) ** 2)))
  rmse_clim = float(np.sqrt(np.mean((clim - truth) ** 2)))
  assert rmse_model < rmse_clim, (
      f'sampled forecast rmse {rmse_model:.4f} does not beat climatology '
      f'{rmse_clim:.4f}')
