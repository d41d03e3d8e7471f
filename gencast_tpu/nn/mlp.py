"""MLPs with conditional layer normalization (FiLM).

Initialization and structure match the reference (common/mlp.py): xavier-
uniform kernels / zero biases for MLPs, truncated-normal(1e-8) for the FiLM
projection, LayerNorm without learned scale/bias when FiLM-conditioned.
Kernels carry P(None, 'model') partitioning so tensor parallelism activates
under a real device mesh.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

from gencast_tpu.nn import nnx
import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P

CONDITIONING_DIM = 16  # norm-conditioning width used throughout GenCast.


def _partitioned(init):
  return nnx.with_partitioning(init, P(None, 'model'))


def _partitioned_bias():
  return nnx.with_partitioning(nnx.initializers.zeros_init(), P('model'))


class MLP(nnx.Module):
  """Plain MLP: [in -> hidden]*num_hidden -> out, activation between."""

  def __init__(self, in_size: int, hidden_size: int, num_hidden_layers: int,
               out_size: int, activation: Callable, *, rngs: nnx.Rngs):
    self.activation = activation
    self.layers = nnx.List()
    size = in_size
    widths = [hidden_size] * num_hidden_layers + [out_size]
    for w in widths:
      self.layers.append(nnx.Linear(
          size, w,
          kernel_init=_partitioned(nnx.initializers.xavier_uniform()),
          bias_init=_partitioned_bias(),
          rngs=rngs))
      size = w

  def __call__(self, x: jnp.ndarray) -> jnp.ndarray:
    for i, layer in enumerate(self.layers):
      x = layer(x)
      if i + 1 < len(self.layers):
        x = self.activation(x)
    return x


class FiLM(nnx.Module):
  """Linear norm conditioning: scale/offset from a conditioning vector.

  scale is (1 + linear(cond)) so the near-zero init leaves normalization
  untouched at start of training (reference common/mlp.py:40-65).
  """

  def __init__(self, feature_size: int, *, rngs: nnx.Rngs,
               conditioning_dim: int = CONDITIONING_DIM):
    self.linear = nnx.Linear(
        conditioning_dim, 2 * feature_size,
        kernel_init=_partitioned(
            nnx.initializers.truncated_normal(stddev=1e-8)),
        bias_init=_partitioned_bias(),
        rngs=rngs)

  def __call__(self, x: jnp.ndarray, cond: jnp.ndarray) -> jnp.ndarray:
    scale_minus_one, offset = jnp.split(self.linear(cond), 2, axis=-1)
    return x * (scale_minus_one + 1.0) + offset


def _align_cond(x: jnp.ndarray, cond: jnp.ndarray) -> jnp.ndarray:
  """Broadcast [B, D] conditioning against [..., B, ..., C] activations.

  Supports the two layouts used in the model: nodes-leading (N, B, C) and
  batch-leading (B, N, C) or (B, C).
  """
  if x.ndim == 2:
    return cond
  if x.ndim == 3:
    if x.shape[1] == cond.shape[0]:
      return cond[None, :, :]
    if x.shape[0] == cond.shape[0]:
      return cond[:, None, :]
  raise ValueError(f'cannot align conditioning {cond.shape} with {x.shape}')


class CondMLP(nnx.Module):
  """MLP -> LayerNorm -> FiLM, the universal GNN update function.

  With use_norm_conditioning the LayerNorm has no learned scale/bias; the
  FiLM layer supplies them from the global conditioning vector (diffusion
  noise-level encoding).
  """

  def __init__(self, in_size: int, hidden_size: int, num_hidden_layers: int,
               out_size: int, activation: Callable, *,
               use_layer_norm: bool, use_norm_conditioning: bool,
               rngs: nnx.Rngs):
    self.network = MLP(in_size, hidden_size, num_hidden_layers, out_size,
                       activation, rngs=rngs)
    self.use_layer_norm = use_layer_norm
    self.use_norm_conditioning = use_norm_conditioning
    if use_layer_norm:
      self.layer_norm = nnx.LayerNorm(
          out_size,
          use_scale=not use_norm_conditioning,
          use_bias=not use_norm_conditioning,
          rngs=rngs)
    if use_norm_conditioning:
      if not use_layer_norm:
        raise ValueError('norm conditioning requires layer norm')
      self.film = FiLM(out_size, rngs=rngs)

  def __call__(self, x: jnp.ndarray,
               cond: Optional[jnp.ndarray] = None) -> jnp.ndarray:
    x = self.network(x)
    if self.use_norm_conditioning:
      if cond is None:
        raise ValueError('conditioning vector required but not provided')
      x = self.layer_norm(x)
      return self.film(x, _align_cond(x, cond))
    if self.use_layer_norm:
      x = self.layer_norm(x)
    return x


def fourier_features(values: jnp.ndarray, base_period: float,
                     num_frequencies: int) -> jnp.ndarray:
  """sin/cos features at integer multiples of 1/base_period
  (reference common/model_utils.py:728-757)."""
  freqs = np.arange(1, num_frequencies + 1) / base_period
  ang = jnp.asarray(2 * np.pi * freqs, dtype=values.dtype)
  phases = values[..., None] * ang
  return jnp.concatenate([jnp.cos(phases), jnp.sin(phases)], axis=-1)


class FourierFeaturesMLP(nnx.Module):
  """log -> Fourier features -> small MLP; encodes the noise level sigma
  into the conditioning vector (reference common/mlp.py:207-265)."""

  def __init__(self, base_period: float = 16.0, num_frequencies: int = 32,
               output_sizes: Sequence[int] = (32, 16),
               apply_log_first: bool = True,
               activation: Callable = jax.nn.gelu, *, rngs: nnx.Rngs):
    self.base_period = base_period
    self.num_frequencies = num_frequencies
    self.apply_log_first = apply_log_first
    self.activation = activation
    w_init = nnx.initializers.variance_scaling(
        2.0, mode='fan_in', distribution='uniform')
    self.linears = nnx.List()
    size = 2 * num_frequencies
    for out in output_sizes:
      self.linears.append(nnx.Linear(
          size, out,
          kernel_init=_partitioned(w_init),
          bias_init=_partitioned_bias(),
          rngs=rngs))
      size = out

  def __call__(self, x: jnp.ndarray) -> jnp.ndarray:
    if self.apply_log_first:
      x = jnp.log(x)
    h = fourier_features(x, self.base_period, self.num_frequencies)
    for i, lin in enumerate(self.linears):
      h = lin(h)
      if i + 1 < len(self.linears):
        h = self.activation(h)
    return h
