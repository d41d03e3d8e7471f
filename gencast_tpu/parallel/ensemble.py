"""Ensemble-member parallelism for diffusion sampling.

GenCast's signature scaling axis: independent samples of the same forecast.
Members are a leading axis sharded over the mesh's 'ensemble' axis; member
RNGs come from fold_in(key, member_id) (replacing the reference's pmap +
per-device key split, common/rollout.py:78-202, 312-322).
"""

from __future__ import annotations

from typing import Optional

from gencast_tpu.nn import nnx
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def member_keys(key: jax.Array, num_members: int) -> jax.Array:
  return jax.vmap(lambda i: jax.random.fold_in(key, i))(
      jnp.arange(num_members))


def make_ensemble_rollout(model: nnx.Module,
                          mesh: Optional[Mesh] = None,
                          teacher_targets: Optional[jnp.ndarray] = None):
  """Builds the jitted ensemble-rollout callable once.

  Returns fn(inputs, forcings, keys) -> [M, K, B, lat, lon, C_tgt].
  Member-chunked callers (evaluate --member_chunk, the pod forecast CLI)
  must reuse ONE returned callable across chunks: jax's jit cache keys on
  the function object, so calling ensemble_rollout per chunk re-traces
  and re-compiles the full rollout program every chunk.
  """
  from gencast_tpu import rollout as rollout_lib
  d = rollout_lib._find_layouts(model)
  from gencast_tpu.data import layout as layout_lib
  maps = layout_lib.rollout_maps(d.input_layout, d.target_layout,
                                 d.forcing_layout)
  graphdef, state = nnx.split(model)

  @jax.jit
  def run(state, inputs, forcings, keys):
    def one(k):
      m = nnx.merge(graphdef, state)

      def predict(x, frc, kk):
        return m.sample(x, frc, kk)

      return rollout_lib.rollout(predict, inputs, forcings, maps, k,
                                 teacher_targets=teacher_targets)

    out = jax.vmap(one)(keys)  # [M, K, B, lat, lon, C]
    if mesh is not None:
      out = jax.lax.with_sharding_constraint(
          out, NamedSharding(mesh, P('ensemble')))
    return out

  def call(inputs, forcings, keys):
    if mesh is not None:
      keys = jax.device_put(keys, NamedSharding(mesh, P('ensemble')))
    return run(state, inputs, forcings, keys)

  return call


def ensemble_rollout(model: nnx.Module,
                     inputs: jnp.ndarray,        # [B, lat, lon, C_in]
                     forcings: jnp.ndarray,      # [K, B, lat, lon, C_frc]
                     key: jax.Array,
                     num_members: int,
                     mesh: Optional[Mesh] = None,
                     teacher_targets: Optional[jnp.ndarray] = None,
                     keys: Optional[jax.Array] = None) -> jnp.ndarray:
  """The GenCast production workload: a K-step autoregressive ensemble
  forecast, members sharded over the 'ensemble' mesh axis.

  Each member runs its own fused rollout scan (sampler scan nested inside);
  there is no cross-member communication until the caller reduces over the
  member axis. Returns [M, K, B, lat, lon, C_tgt].

  keys overrides the internal member_keys(key, num_members): member-chunked
  callers pass slices of one global member_keys split, so chunking over
  members never changes any member's sample stream. Chunked callers should
  use make_ensemble_rollout directly (one trace for all chunks).
  """
  if keys is None:
    keys = member_keys(key, num_members)
  return make_ensemble_rollout(model, mesh, teacher_targets)(
      inputs, forcings, keys)


def ensemble_statistics(members: jnp.ndarray,
                        mesh: Optional[Mesh] = None):
  """Mean and spread over the (possibly 'ensemble'-sharded) member axis.

  The only cross-member communication GenCast needs: under a mesh, XLA
  lowers the reductions to psums over ICI along the 'ensemble' axis
  (SURVEY §2.3). Returns (mean, std) with the member axis reduced,
  replicated across the ensemble axis.
  """
  def stats(m):
    mean = m.mean(axis=0)
    std = m.std(axis=0, ddof=1) if m.shape[0] > 1 else jnp.zeros_like(mean)
    return mean, std

  if mesh is None:
    return stats(members)

  @jax.jit
  def run(m):
    mean, std = stats(m)
    repl = NamedSharding(mesh, P())
    return (jax.lax.with_sharding_constraint(mean, repl),
            jax.lax.with_sharding_constraint(std, repl))

  return run(members)


def ensemble_scores(members: jnp.ndarray,      # [M, ..., lat, lon, C]
                    truth: jnp.ndarray,        # [..., lat, lon, C]
                    lat_weights: jnp.ndarray,  # [lat]
                    mesh: Optional[Mesh] = None):
  """Device-side ensemble verification: CRPS + ensemble-mean RMSE +
  spread per channel, reduced on device so only [..., C]-shaped scores
  (KBs) ever reach the host.

  Under a mesh, the member-sharded fields are resharded to SPATIAL
  sharding (lat over the 'ensemble' axis) first — one all-to-all over
  ICI — so the member-axis sort/means inside CRPS are device-local
  instead of gathering the full ensemble everywhere. Outputs are
  replicated. Numerics match ops/metrics on the gathered array up to f32
  reduction order (unit-tested); the 50-member 1-degree 30-step use case
  would otherwise offload ~10 GB of member fields through the host.

  Returns {'crps', 'rmse', 'spread'}: [..., C] jax arrays.
  """
  from gencast_tpu.ops import metrics

  @jax.jit
  def run(mem, tru, w):
    if mesh is not None:
      spatial = [None] * (mem.ndim - 3) + ['ensemble', None, None]
      mem = jax.lax.with_sharding_constraint(
          mem, NamedSharding(mesh, P(*spatial)))
    out = {'crps': metrics.crps_ensemble(mem, tru, w),
           'rmse': metrics.ensemble_mean_rmse(mem, tru, w),
           'spread': metrics.ensemble_spread(mem, w)}
    if mesh is not None:
      repl = NamedSharding(mesh, P())
      out = {k: jax.lax.with_sharding_constraint(v, repl)
             for k, v in out.items()}
    return out

  return run(members, truth, lat_weights)


def ensemble_sample(model: nnx.Module,
                    inputs: jnp.ndarray,
                    forcings: jnp.ndarray,
                    key: jax.Array,
                    num_members: int,
                    mesh: Optional[Mesh] = None) -> jnp.ndarray:
  """Draws num_members independent samples: [M, B, lat, lon, C].

  Under a mesh, the member axis is sharded over 'ensemble' — XLA partitions
  the vmapped sampler so each device group runs its own members with zero
  cross-member communication (the only collective is the final gather if the
  caller reduces over members).
  """
  graphdef, state = nnx.split(model)
  keys = member_keys(key, num_members)
  if mesh is not None:
    keys = jax.device_put(keys, NamedSharding(mesh, P('ensemble')))

  @jax.jit
  def run(state, inputs, forcings, keys):
    def one(k):
      m = nnx.merge(graphdef, state)
      return m.sample(inputs, forcings, k)

    out = jax.vmap(one)(keys)
    if mesh is not None:
      out = jax.lax.with_sharding_constraint(
          out, NamedSharding(mesh, P('ensemble', 'data')))
    return out

  return run(state, inputs, forcings, keys)
