"""Jitted training/eval steps and the optimizer.

Optimizer matches the reference harness (training/train_helpers.py:300-330):
AdamW with linear-warmup + cosine-decay schedule, global-norm clipping 1.0,
weight decay 0.1 applied to kernel parameters.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

from gencast_tpu.nn import nnx
import jax
import jax.numpy as jnp
import optax


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
  learning_rate: float = 3e-4
  warmup_steps: int = 1000
  total_steps: int = 30000
  weight_decay: float = 0.1
  clip_norm: float = 1.0
  b1: float = 0.9
  b2: float = 0.999
  final_lr_fraction: float = 0.0


def create_optimizer(model: nnx.Module,
                     config: OptimizerConfig) -> nnx.Optimizer:
  """AdamW + linear-warmup/cosine-decay, reference recipe values.

  Deviation from the reference (documented in PARITY.md): warmup is
  clamped to total_steps // 10 so short runs (tests, smoke trainings far
  below the 30k-step production schedule, where warmup_steps=1000 would
  otherwise cover most or all of the run) still see a full
  warmup->decay cycle. For any total_steps >= 10 * warmup_steps —
  including the reference's 30k-step recipe — the clamp is inactive and
  the schedule is exactly the reference's.
  """
  warmup = min(config.warmup_steps, max(1, config.total_steps // 10))
  schedule = optax.warmup_cosine_decay_schedule(
      init_value=0.0,
      peak_value=config.learning_rate,
      warmup_steps=warmup,
      decay_steps=config.total_steps,
      end_value=config.learning_rate * config.final_lr_fraction)
  tx = optax.chain(
      optax.clip_by_global_norm(config.clip_norm),
      optax.adamw(schedule, b1=config.b1, b2=config.b2,
                  weight_decay=config.weight_decay))
  return nnx.Optimizer(model, tx, wrt=nnx.Param)


@nnx.jit(donate_argnums=())
def train_step(model: nnx.Module, optimizer: nnx.Optimizer,
               inputs: jnp.ndarray, targets: jnp.ndarray,
               forcings: jnp.ndarray, key: jax.Array
               ) -> Tuple[jnp.ndarray, Dict[str, jnp.ndarray]]:
  """One optimization step; returns (mean loss, per-variable diagnostics)."""

  def loss_fn(m):
    loss, diags = m.loss(inputs, targets, forcings, key)
    return loss.mean(), diags

  (loss, diags), grads = nnx.value_and_grad(loss_fn, has_aux=True)(model)
  optimizer.update(model, grads)
  return loss, diags


def functional_train_step(model: nnx.Module, optimizer: nnx.Optimizer):
  """Donated-state training step for memory-bound configurations.

  Returns (step_fn, state). step_fn(state, inputs, targets, forcings, key)
  -> (new_state, loss, diags), jitted with the state buffer donated so the
  updated parameters/optimizer state alias the inputs — without donation a
  second full copy of params + Adam moments is live across the step
  (~1.9GB at 0.25 degrees). nnx.jit cannot donate
  here: unchanged pass-through buffers (StaticData) would be deleted
  without being written back to the module.

  The caller owns the state thread: `state, loss, _ = step_fn(state, ...)`.
  Use nnx.update(model_and_opt, state) to sync back into the modules.
  """
  import functools

  from gencast_tpu.nn.variables import StaticData

  # StaticData buffers (graph indices, SH tables, masks) are excluded
  # from donation: they are immutable, shared across model builds via
  # host-side caches, and donating them deletes arrays other model
  # instances still reference.
  graphdef, static, state = nnx.split((model, optimizer), StaticData, ...)

  @functools.partial(jax.jit, donate_argnums=(0,))
  def _step(state, static, inputs, targets, forcings, key):
    m, opt = nnx.merge(graphdef, static, state)

    def loss_fn(mm):
      loss, diags = mm.loss(inputs, targets, forcings, key)
      return loss.mean(), diags

    (loss, diags), grads = nnx.value_and_grad(loss_fn, has_aux=True)(m)
    opt.update(m, grads)
    _, _, new_state = nnx.split((m, opt), StaticData, ...)
    return new_state, loss, diags

  def step_fn(state, inputs, targets, forcings, key):
    return _step(state, static, inputs, targets, forcings, key)

  return step_fn, state


def scanned_train_steps(model: nnx.Module, optimizer: nnx.Optimizer,
                        ar: bool = False):
  """Fused multi-step training: one dispatch runs K steps on-device.

  A host-driven loop pays host jitter and per-call launch latency every
  step. This fuses K train steps into one jitted
  lax.scan over a device-resident sample pool, with the carried
  (params, opt) state donated like functional_train_step (reference
  role: the train loop of training/train.py:324-329, which has no
  equivalent — torch cannot fuse optimizer steps across iterations).

  Returns (fused_fn, state):
    fused_fn(state, pool, idx, base_key, steps) -> (state, losses[K])
  where pool is a dict of [M, B, lat, lon, C] device arrays
  ('inputs'/'targets'/'forcings'), idx int32[K] pool rows for each step,
  and steps int32[K] global step numbers (the per-step PRNG key is
  fold_in(base_key, step), matching the per-step CLI loop exactly).
  One compile per distinct K. Thread the returned state through calls
  and nnx.update((model, optimizer), state) to sync back.

  The scan carries the FULL state including StaticData buffers (an
  nnx.split filter cannot run inside the scan body — flax refuses to
  extract jit-level StaticData tracers at scan trace level); they pass
  through unchanged, which XLA threads without copies (verified: the
  same pattern in bench.py reproduces the single-step time exactly).
  The state is NOT donated: donating would invalidate the StaticData
  buffers other model instances share via the host-side graph caches.

  With ar=True each optimization step trains the multi-step
  autoregressive loss (rollout.autoregressive_loss — grads through the
  whole rollout, the reference's common/autoregressive.py:127-312 role)
  instead of the 1-step predictor loss; pool 'targets'/'forcings' then
  hold [M, K_ar, B, ...] frame windows. The per-step PRNG stream is
  unchanged (fold_in(base_key, step) is the key autoregressive_loss
  splits per forecast step, exactly as the per-step AR loop passes it).
  """
  from gencast_tpu import rollout as rollout_lib

  graphdef, state = nnx.split((model, optimizer))

  @jax.jit
  def _fused(state, inputs, targets, forcings, idx, base_key, steps):
    def body(carry, xs):
      i, step = xs
      m, opt = nnx.merge(graphdef, carry)
      k = jax.random.fold_in(base_key, step)

      def loss_fn(mm):
        if ar:
          loss, _ = rollout_lib.autoregressive_loss(
              mm, inputs[i], targets[i], forcings[i], k)
        else:
          loss, _ = mm.loss(inputs[i], targets[i], forcings[i], k)
        return loss.mean()

      loss, grads = nnx.value_and_grad(loss_fn)(m)
      opt.update(m, grads)
      _, new_state = nnx.split((m, opt))
      return new_state, loss

    state, losses = jax.lax.scan(body, state, (idx, steps))
    return state, losses

  def fused_fn(state, pool, idx, base_key, steps):
    return _fused(state, pool['inputs'], pool['targets'],
                  pool['forcings'], jnp.asarray(idx, jnp.int32), base_key,
                  jnp.asarray(steps, jnp.int32))

  return fused_fn, state


@nnx.jit
def eval_step(model: nnx.Module, inputs: jnp.ndarray, targets: jnp.ndarray,
              forcings: jnp.ndarray, key: jax.Array
              ) -> Tuple[jnp.ndarray, Dict[str, jnp.ndarray]]:
  loss, diags = model.loss(inputs, targets, forcings, key)
  return loss.mean(), diags
