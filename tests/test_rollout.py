"""Tests for the fused autoregressive rollout."""

from gencast_tpu.nn import nnx
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gencast_tpu.data import layout as L
from gencast_tpu import rollout as R
from tests.test_gencast_model import TINY_TASK, setup, _data


def _layouts(task):
  return (L.build_layout(task.input_variables, task.pressure_levels,
                         task.num_input_frames),
          L.build_layout(task.target_variables, task.pressure_levels, 1),
          L.build_layout(task.forcing_variables, task.pressure_levels, 1))


def test_advance_inputs_semantics():
  inp, tgt, frc = _layouts(TINY_TASK)
  maps = L.rollout_maps(inp, tgt, frc)
  rng = np.random.default_rng(0)
  x = jnp.asarray(rng.standard_normal((1, 2, 3, inp.num_channels)))
  p = jnp.asarray(rng.standard_normal((1, 2, 3, tgt.num_channels)))
  f = jnp.asarray(rng.standard_normal((1, 2, 3, frc.num_channels)))
  out = R.advance_inputs(x, p, f, maps)

  def chan(lay, name, t, lvl=-1):
    vi = lay.var_names.index(name)
    m = np.nonzero((lay.channel_var == vi) & (lay.channel_time == t)
                   & (lay.channel_level == lvl))[0]
    return int(m[0])

  # Frame 0 of 2m_temperature <- old frame 1.
  np.testing.assert_array_equal(
      out[..., chan(inp, '2m_temperature', 0)],
      x[..., chan(inp, '2m_temperature', 1)])
  # Frame 1 (newest) <- prediction.
  np.testing.assert_array_equal(
      out[..., chan(inp, '2m_temperature', 1)],
      p[..., chan(tgt, '2m_temperature', 0)])
  # Atmospheric var at level 1, newest frame <- prediction at level 1.
  np.testing.assert_array_equal(
      out[..., chan(inp, 'temperature', 1, 1)],
      p[..., chan(tgt, 'temperature', 0, 1)])
  # Forcing input newest frame <- step forcings.
  np.testing.assert_array_equal(
      out[..., chan(inp, 'year_progress_sin', 1)],
      f[..., chan(frc, 'year_progress_sin', 0)])
  # Static unchanged.
  lsm = inp.var_channels('land_sea_mask')[0]
  np.testing.assert_array_equal(out[..., lsm], x[..., lsm])


def test_sample_rollout_shapes_and_teacher_forcing(setup):
  statics, model = setup
  from gencast_tpu.models import wrappers
  from gencast_tpu.data import registry
  stats = L.Stats.unit(
      set(TINY_TASK.input_variables) | set(TINY_TASK.target_variables),
      TINY_TASK.pressure_levels)
  wrapped = wrappers.InputsAndResiduals(model, stats)
  inputs, targets, forcings = _data(statics, TINY_TASK)
  k_steps = 3
  frc_seq = jnp.stack([forcings] * k_steps)      # [K, B, lat, lon, C]
  preds = R.sample_rollout(wrapped, inputs, frc_seq, jax.random.PRNGKey(0))
  assert preds.shape == (k_steps,) + targets.shape
  assert bool(jnp.isfinite(preds).all())

  truth_seq = jnp.stack([targets] * k_steps)
  preds_tf = R.sample_rollout(wrapped, inputs, frc_seq,
                              jax.random.PRNGKey(0),
                              teacher_targets=truth_seq)
  assert preds_tf.shape == preds.shape
  # Same key -> step 0 identical (same window), later steps diverge
  # (teacher-forced window differs from the model's own).
  np.testing.assert_allclose(np.asarray(preds_tf[0]), np.asarray(preds[0]),
                             rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize('chunk_size', [1, 2, 5])
def test_chunked_rollout_matches_unchunked(setup, chunk_size):
  """Chunked offload is bit-exact vs the fused scan for any chunk size
  (including one that does not divide the step count)."""
  statics, model = setup
  from gencast_tpu.models import wrappers
  stats = L.Stats.unit(
      set(TINY_TASK.input_variables) | set(TINY_TASK.target_variables),
      TINY_TASK.pressure_levels)
  wrapped = wrappers.InputsAndResiduals(model, stats)
  inputs, _, forcings = _data(statics, TINY_TASK)
  k_steps = 4
  frc_seq = jnp.stack([forcings + 0.1 * i for i in range(k_steps)])
  key = jax.random.PRNGKey(3)

  full = np.asarray(R.sample_rollout(wrapped, inputs, frc_seq, key))
  chunked = R.chunked_rollout(wrapped, inputs, frc_seq, key,
                              chunk_size=chunk_size)
  assert isinstance(chunked, np.ndarray)
  np.testing.assert_array_equal(chunked, full)


def test_chunked_rollout_teacher_forcing(setup):
  statics, model = setup
  from gencast_tpu.models import wrappers
  stats = L.Stats.unit(
      set(TINY_TASK.input_variables) | set(TINY_TASK.target_variables),
      TINY_TASK.pressure_levels)
  wrapped = wrappers.InputsAndResiduals(model, stats)
  inputs, targets, forcings = _data(statics, TINY_TASK)
  k_steps = 3
  frc_seq = jnp.stack([forcings] * k_steps)
  truth_seq = jnp.stack([targets] * k_steps)
  key = jax.random.PRNGKey(5)
  full = np.asarray(R.sample_rollout(wrapped, inputs, frc_seq, key,
                                     teacher_targets=truth_seq))
  chunked = R.chunked_rollout(wrapped, inputs, frc_seq, key, chunk_size=2,
                              teacher_targets=truth_seq)
  np.testing.assert_array_equal(chunked, full)


def test_chunked_rollout_serialized_offload(setup):
  """overlap_offload=False (for runtimes unstable under concurrent
  device_get + compute) is still bit-exact."""
  statics, model = setup
  from gencast_tpu.models import wrappers
  stats = L.Stats.unit(
      set(TINY_TASK.input_variables) | set(TINY_TASK.target_variables),
      TINY_TASK.pressure_levels)
  wrapped = wrappers.InputsAndResiduals(model, stats)
  inputs, _, forcings = _data(statics, TINY_TASK)
  frc_seq = jnp.stack([forcings] * 3)
  key = jax.random.PRNGKey(9)
  full = np.asarray(R.sample_rollout(wrapped, inputs, frc_seq, key))
  chunked = R.chunked_rollout(wrapped, inputs, frc_seq, key, chunk_size=2,
                              overlap_offload=False)
  np.testing.assert_array_equal(chunked, full)
