"""Fused autoregressive rollout: one lax.scan over forecast steps.

The reference rolls out with a Python loop that round-trips xarray frame
composition through the host every step (training/train_helpers.py:399-638).
Here the whole K-step forecast — including the diffusion sampler's inner
scan and the frame-window advance — is a single jitted scan with donated
carry; forcings for all lead times are precomputed as one tensor.
"""

from __future__ import annotations

from typing import Callable, Optional

from gencast_tpu.nn import nnx
import jax
import jax.numpy as jnp

from gencast_tpu.data import layout as layout_lib

PredictFn = Callable[[jnp.ndarray, jnp.ndarray, jax.Array], jnp.ndarray]


def advance_inputs(inputs: jnp.ndarray, predictions: jnp.ndarray,
                   step_forcings: jnp.ndarray,
                   maps: layout_lib.RolloutMaps) -> jnp.ndarray:
  """Drops the oldest frame and appends the new one, entirely on device.

  inputs [B, lat, lon, C_in]; predictions [B, lat, lon, C_tgt];
  step_forcings [B, lat, lon, C_frc] (values at the newly predicted time).
  """
  src = jnp.asarray(maps.source)
  idx = jnp.asarray(maps.index)
  shifted = jnp.take(inputs, idx, axis=-1)
  from_pred = jnp.take(predictions, idx, axis=-1)
  from_forc = jnp.take(step_forcings, idx, axis=-1)
  out = jnp.where(src == 0, shifted,
                  jnp.where(src == 1, from_pred,
                            jnp.where(src == 2, from_forc, inputs)))
  return out


def rollout(predict_fn: PredictFn,
            inputs: jnp.ndarray,          # [B, lat, lon, C_in]
            forcings: jnp.ndarray,        # [K, B, lat, lon, C_frc]
            maps: layout_lib.RolloutMaps,
            key: Optional[jax.Array] = None,
            teacher_targets: Optional[jnp.ndarray] = None,  # [K, B, ...]
            step_keys: Optional[jnp.ndarray] = None,        # [K, key]
            return_final_inputs: bool = False):
  """K autoregressive steps; returns predictions [K, B, lat, lon, C_tgt].

  With teacher_targets, the window advances with ground truth instead of
  the model's own predictions (teacher forcing, as in the reference's
  evaluation loop) while still returning the model predictions.
  step_keys overrides the internal split(key, K) — chunked callers pass
  slices of one global split so chunking never changes the sample stream.
  """
  num_steps = forcings.shape[0]
  if step_keys is None:
    step_keys = jax.random.split(key, num_steps)

  if teacher_targets is None:
    xs = (forcings, step_keys)

    def body(carry, x):
      frc, k = x
      preds = predict_fn(carry, frc, k)
      return advance_inputs(carry, preds, frc, maps), preds
  else:
    xs = (forcings, step_keys, teacher_targets)

    def body(carry, x):
      frc, k, truth = x
      preds = predict_fn(carry, frc, k)
      return advance_inputs(carry, truth, frc, maps), preds

  final_inputs, predictions = jax.lax.scan(body, inputs, xs)
  if return_final_inputs:
    return predictions, final_inputs
  return predictions


def _find_layouts(model: nnx.Module):
  from gencast_tpu.models.wrappers import find_layout_provider
  return find_layout_provider(model)


def autoregressive_loss(model: nnx.Module,
                        inputs: jnp.ndarray,          # [B, lat, lon, C_in]
                        targets: jnp.ndarray,         # [K, B, lat, lon, C_t]
                        forcings: jnp.ndarray,        # [K, B, lat, lon, C_f]
                        key: Optional[jax.Array] = None,
                        remat: bool = True):
  """Multi-step training loss: scan over forecast steps with the window
  advanced on the model's own predictions (gradients flow through the whole
  rollout). The semantics of the reference's dead Haiku autoregressive
  wrapper (common/autoregressive.py:127-312), rebuilt with lax.scan +
  jax.checkpoint. Returns (mean loss [B], per-variable diagnostics)."""
  d = _find_layouts(model)
  maps = layout_lib.rollout_maps(d.input_layout, d.target_layout,
                                 d.forcing_layout)
  num_steps = targets.shape[0]
  keys = (jax.random.split(key, num_steps) if key is not None
          else jnp.zeros((num_steps, 2), jnp.uint32))

  def body(carry, x):
    frc, tgt, k = x
    (loss, diags), preds = model.loss_and_predictions(
        carry, tgt, frc, k if key is not None else None)
    nxt = advance_inputs(carry, preds, frc, maps)
    return nxt, (loss, diags)

  if remat:
    body = jax.checkpoint(body)
  _, (step_losses, step_diags) = jax.lax.scan(body, inputs,
                                              (forcings, targets, keys))
  loss = step_losses.mean(axis=0)
  diags = jax.tree.map(lambda x: x.mean(axis=0), step_diags)
  return loss, diags


def predict_rollout(model: nnx.Module,
                    inputs: jnp.ndarray,
                    forcings: jnp.ndarray,
                    key: Optional[jax.Array] = None,
                    teacher_targets: Optional[jnp.ndarray] = None,
                    jit: bool = True) -> jnp.ndarray:
  """Deterministic AR rollout via model.predict (GraphCast-style)."""
  d = _find_layouts(model)
  maps = layout_lib.rollout_maps(d.input_layout, d.target_layout,
                                 d.forcing_layout)
  graphdef, state = nnx.split(model)
  if key is None:
    key = jax.random.PRNGKey(0)

  def run(state, inputs, forcings, key, teacher_targets):
    m = nnx.merge(graphdef, state)

    def predict(x, frc, k):
      return m.predict(x, frc, k)

    return rollout(predict, inputs, forcings, maps, key,
                   teacher_targets=teacher_targets)

  if jit:
    run = jax.jit(run)
  return run(state, inputs, forcings, key, teacher_targets)


def chunked_rollout(model: nnx.Module,
                    inputs: jnp.ndarray,    # [B, lat, lon, C_in]
                    forcings: jnp.ndarray,  # [K, B, lat, lon, C_frc]
                    key: Optional[jax.Array] = None,
                    *,
                    chunk_size: int,
                    mode: str = 'sample',
                    teacher_targets: Optional[jnp.ndarray] = None,
                    overlap_offload: bool = True):
  """Long rollout in fixed-size jitted chunks with per-chunk host offload.

  The fused single-scan rollout stacks all K step outputs on device —
  ~10+ GB for a 30-step 0.25-degree forecast, more than one chip holds
  next to model + statics. This runs ceil(K / chunk_size) executions of
  one compiled chunk program (K is padded by repeating the final
  forcing frame, so every chunk has identical shapes and there is exactly
  one compilation), carrying only the input window on device and copying
  each chunk's predictions to host while the next chunk computes.
  Packed-array counterpart of the reference's
  chunked_prediction_generator (common/rollout.py:245-376).

  Step keys come from one global split(key, K), so results are exactly
  equal to the unchunked sample_rollout/predict_rollout for any
  chunk_size. Returns host numpy [K, B, lat, lon, C_tgt].
  """
  import numpy as np

  d = _find_layouts(model)
  maps = layout_lib.rollout_maps(d.input_layout, d.target_layout,
                                 d.forcing_layout)
  graphdef, state = nnx.split(model)
  num_steps = forcings.shape[0]
  if key is None:
    key = jax.random.PRNGKey(0)
  step_keys = jax.random.split(key, num_steps)

  pad = (-num_steps) % chunk_size
  if pad:
    def pad_steps(x):
      return jnp.concatenate([x, jnp.repeat(x[-1:], pad, axis=0)], axis=0)
    forcings = pad_steps(forcings)
    step_keys = pad_steps(step_keys)
    if teacher_targets is not None:
      teacher_targets = pad_steps(teacher_targets)
  num_chunks = (num_steps + pad) // chunk_size

  @jax.jit
  def run_chunk(state, window, frc, keys, tt):
    m = nnx.merge(graphdef, state)
    predict = m.sample if mode == 'sample' else (
        lambda x, f, k: m.predict(x, f, k))
    return rollout(predict, window, frc, maps, step_keys=keys,
                   teacher_targets=tt, return_final_inputs=True)

  window = inputs
  pending = None
  chunks = []
  for c in range(num_chunks):
    sl = slice(c * chunk_size, (c + 1) * chunk_size)
    tt = teacher_targets[sl] if teacher_targets is not None else None
    preds, window = run_chunk(state, window, forcings[sl], step_keys[sl], tt)
    if not overlap_offload:
      # Serialize device compute and host copies (no device_get while a
      # program runs).
      chunks.append(jax.device_get(preds))
      continue
    if pending is not None:
      # Offload the previous chunk while this one computes.
      chunks.append(jax.device_get(pending))
    pending = preds
  if pending is not None:
    chunks.append(jax.device_get(pending))
  return np.concatenate(chunks, axis=0)[:num_steps]


def sample_rollout(model: nnx.Module,
                   inputs: jnp.ndarray,
                   forcings: jnp.ndarray,
                   key: jax.Array,
                   teacher_targets: Optional[jnp.ndarray] = None,
                   jit: bool = True) -> jnp.ndarray:
  """Diffusion-sampled AR rollout for a (wrapped) GenCast model.

  `model` must expose .sample(inputs, forcings, key) in raw (unnormalized)
  space — e.g. InputsAndResiduals(NaNCleaner(GenCast)).
  """
  d = _find_layouts(model)
  maps = layout_lib.rollout_maps(d.input_layout, d.target_layout,
                                 d.forcing_layout)
  graphdef, state = nnx.split(model)

  def run(state, inputs, forcings, key, teacher_targets):
    m = nnx.merge(graphdef, state)

    def predict(x, frc, k):
      return m.sample(x, frc, k)

    return rollout(predict, inputs, forcings, maps, key,
                   teacher_targets=teacher_targets)

  if jit:
    run = jax.jit(run)
  return run(state, inputs, forcings, key, teacher_targets)
