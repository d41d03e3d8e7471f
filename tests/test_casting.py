"""Mixed-precision wrapper tests."""

from gencast_tpu.nn import nnx
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gencast_tpu.models import casting
from tests.test_gencast_model import TINY_TASK, setup, _data


@pytest.mark.slow
def test_bf16_loss_and_gradients(setup):
  statics, model = setup
  wrapped = casting.Bfloat16Cast(model)
  inputs, targets, forcings = _data(statics, TINY_TASK)

  def loss_fn(w):
    loss, _ = w.loss(inputs, targets, forcings, jax.random.PRNGKey(0))
    return loss.mean()

  loss, grads = nnx.value_and_grad(loss_fn)(wrapped)
  assert np.isfinite(float(loss))
  leaves = jax.tree_util.tree_leaves(grads)
  # Master gradients stay f32 and finite.
  assert all(g.dtype == jnp.float32 for g in leaves)
  assert all(bool(jnp.isfinite(g).all()) for g in leaves)

  # bf16 result tracks the f32 result loosely.
  f32_loss, _ = model.loss(inputs, targets, forcings, jax.random.PRNGKey(0))
  rel = abs(float(loss) - float(f32_loss.mean())) / abs(
      float(f32_loss.mean()))
  assert rel < 0.1


def test_bf16_forward_dtype(setup):
  statics, model = setup
  wrapped = casting.Bfloat16Cast(model)
  inputs, targets, forcings = _data(statics, TINY_TASK)
  out = wrapped(inputs, targets, jnp.ones((2,)), forcings)
  assert out.dtype == jnp.float32  # cast back at the boundary
  assert bool(jnp.isfinite(out).all())


def test_disabled_passthrough(setup):
  statics, model = setup
  wrapped = casting.Bfloat16Cast(model, enabled=False)
  inputs, targets, forcings = _data(statics, TINY_TASK)
  a = wrapped(inputs, targets, jnp.ones((2,)), forcings)
  b = model(inputs, targets, jnp.ones((2,)), forcings)
  np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_bf16_sample_runs_in_bf16(setup):
  """The sampler's scan carry must stay bf16 end-to-end under
  Bfloat16Cast — a f32 conditioning vector used to re-promote every
  FiLM-conditioned activation (and break the scan carry dtype)."""
  statics, model = setup
  wrapped = casting.Bfloat16Cast(model)
  inputs, _, forcings = _data(statics, TINY_TASK, batch=1)
  out = wrapped.sample(inputs, forcings, jax.random.PRNGKey(0))
  assert out.dtype == jnp.float32  # cast back at the boundary
  assert bool(jnp.isfinite(out).all())
  # The inner compute really ran bf16: the preconditioned denoiser output
  # on bf16 operands must be bf16 (no silent f32 promotion).
  inner = wrapped._inner()
  xb = inputs[..., : model.target_layout.num_channels].astype(jnp.bfloat16)
  raw = inner._precond_denoise(inputs.astype(jnp.bfloat16),
                               forcings.astype(jnp.bfloat16), xb,
                               jnp.ones((1,)))
  assert raw.dtype == jnp.bfloat16
