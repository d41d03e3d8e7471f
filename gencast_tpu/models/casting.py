"""Mixed-precision execution: bf16 compute with f32 master weights.

The reference's Bfloat16Cast wrapper (graphcast/casting.py:30-119) casts
inputs to bf16 and back around the model. The win comes from bf16
tensor-core matmuls, which requires the *parameters* to be bf16 in the
compute graph too. `cast_compute` merges a module whose Params are cast to the
compute dtype — master weights stay f32 in the optimizer; softmax and edge
aggregation still run in f32 via the precision guards
(nn/precision.py, ops/segment.py f32_accumulate).
"""

from __future__ import annotations


from gencast_tpu.nn import nnx
import jax
import jax.numpy as jnp



def cast_params(model: nnx.Module, dtype=jnp.bfloat16) -> nnx.Module:
  """A functional twin of `model` whose float Params are cast to `dtype`.

  Gradients w.r.t. the original f32 params flow through the cast (the cast
  is part of the traced graph), so this composes with nnx.value_and_grad
  for true mixed-precision training.
  """
  graphdef, params, rest = nnx.split(model, nnx.Param, ...)

  def cast(x):
    if isinstance(x, jax.Array) and jnp.issubdtype(x.dtype, jnp.floating):
      return x.astype(dtype)
    return x

  params = jax.tree.map(cast, params)
  return nnx.merge(graphdef, params, rest)


class Bfloat16Cast(nnx.Module):
  """Predictor wrapper running the inner model in bf16.

  Casts float inputs to bf16, runs the inner predictor with bf16-cast
  parameters, and casts outputs back to f32 (reference
  graphcast/casting.py:30-119 semantics, plus the parameter cast the
  reference leaves to Haiku).
  """

  def __init__(self, predictor: nnx.Module, enabled: bool = True):
    self.predictor = predictor
    self.enabled = enabled

  def _in(self, *arrays):
    if not self.enabled:
      return arrays
    return tuple(a.astype(jnp.bfloat16)
                 if a is not None and jnp.issubdtype(a.dtype, jnp.floating)
                 else a for a in arrays)

  def _out(self, x):
    return x.astype(jnp.float32) if self.enabled else x

  def _inner(self):
    return cast_params(self.predictor) if self.enabled else self.predictor

  def __call__(self, inputs, noisy_targets, noise_levels, forcings):
    i, t, f = self._in(inputs, noisy_targets, forcings)
    return self._out(self._inner()(i, t, noise_levels, f))

  def loss(self, inputs, targets, forcings, key):
    i, t, f = self._in(inputs, targets, forcings)
    loss, diags = self._inner().loss(i, t, f, key)
    return self._out(loss), jax.tree.map(self._out, diags)

  def sample(self, inputs, forcings, key, **kwargs):
    i, f = self._in(inputs, forcings)
    kwargs.setdefault('dtype', jnp.bfloat16)
    return self._out(self._inner().sample(i, f, key, **kwargs))

  def predict(self, inputs, forcings, key=None):
    i, f = self._in(inputs, forcings)
    return self._out(self._inner().predict(i, f, key))

  def loss_and_predictions(self, inputs, targets, forcings, key=None):
    i, t, f = self._in(inputs, targets, forcings)
    (loss, diags), preds = self._inner().loss_and_predictions(i, t, f, key)
    return (self._out(loss), jax.tree.map(self._out, diags)), \
        self._out(preds)
