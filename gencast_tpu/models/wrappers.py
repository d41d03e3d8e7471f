"""Predictor wrappers: normalization/residuals and NaN cleaning.

Packed-array equivalents of the reference's wrapper stack
(common/normalization.py:74-238, gencast/nan_cleaning.py:28-157). Because a
ChannelLayout fixes channel <-> (variable, level, frame) statically, each
wrapper reduces to precomputed per-channel vectors applied as elementwise
device ops that XLA fuses into the surrounding computation.
"""

from __future__ import annotations

from typing import Dict, Tuple

from gencast_tpu.nn import nnx
import jax.numpy as jnp
import numpy as np

from gencast_tpu.data import layout as layout_lib
from gencast_tpu.nn.variables import StaticData


def find_layout_provider(model: nnx.Module):
  """Walks wrapper nesting (wrappers hold .predictor, GenCast holds
  .denoiser) to the module exposing input/target/forcing layouts."""
  d = model
  while not hasattr(d, 'input_layout'):
    d = d.denoiser if hasattr(d, 'denoiser') else d.predictor
  return d


class InputsAndResiduals(nnx.Module):
  """Normalizes inputs/forcings; trains on normalized residuals.

  For target variables present in the inputs the inner predictor sees
  (target - last_input_frame) / diffs_std; other targets are normalized like
  inputs. Predictions are mapped back before returning.
  """

  def __init__(self, predictor: nnx.Module, stats: layout_lib.Stats):
    self.predictor = predictor
    d = find_layout_provider(predictor)
    in_lay, tgt_lay, frc_lay = (d.input_layout, d.target_layout,
                                d.forcing_layout)

    def vec(x):
      return StaticData(jnp.asarray(x))

    self.in_loc = vec(layout_lib.channel_locations(in_lay, stats))
    self.in_scale = vec(layout_lib.channel_scales(in_lay, stats))
    self.frc_loc = vec(layout_lib.channel_locations(frc_lay, stats))
    self.frc_scale = vec(layout_lib.channel_scales(frc_lay, stats))

    res_map = layout_lib.residual_channel_map(tgt_lay, in_lay)
    has_res = res_map >= 0
    tgt_loc = layout_lib.channel_locations(tgt_lay, stats)
    tgt_scale = layout_lib.channel_scales(tgt_lay, stats)
    diffs = layout_lib.channel_residual_scales(tgt_lay, stats)
    self.res_map = vec(np.maximum(res_map, 0))
    self.has_res = vec(has_res)
    # Residual channels: location is the last input frame, scale diffs_std.
    self.tgt_loc = vec(np.where(has_res, 0.0, tgt_loc))
    self.tgt_scale = vec(np.where(has_res, diffs, tgt_scale))

  # -- elementwise transforms --

  def _norm_inputs(self, x):
    return ((x - self.in_loc[...].astype(x.dtype))
            / self.in_scale[...].astype(x.dtype))

  def _norm_forcings(self, x):
    return ((x - self.frc_loc[...].astype(x.dtype))
            / self.frc_scale[...].astype(x.dtype))

  def _residual_base(self, raw_inputs):
    """Per-target-channel base value: last input frame (or 0)."""
    base = jnp.take(raw_inputs, self.res_map[...], axis=-1)
    return jnp.where(self.has_res[...], base, 0.0)

  def _norm_targets(self, raw_inputs, targets):
    base = self._residual_base(raw_inputs)
    return ((targets - base - self.tgt_loc[...].astype(targets.dtype))
            / self.tgt_scale[...].astype(targets.dtype))

  def _unnorm_predictions(self, raw_inputs, preds):
    base = self._residual_base(raw_inputs).astype(preds.dtype)
    return (preds * self.tgt_scale[...].astype(preds.dtype)
            + self.tgt_loc[...].astype(preds.dtype) + base)

  # -- predictor API --

  def loss(self, inputs, targets, forcings, key
           ) -> Tuple[jnp.ndarray, Dict[str, jnp.ndarray]]:
    return self.predictor.loss(
        self._norm_inputs(inputs),
        self._norm_targets(inputs, targets),
        self._norm_forcings(forcings), key)

  def __call__(self, inputs, noisy_targets, noise_levels, forcings):
    preds = self.predictor(self._norm_inputs(inputs), noisy_targets,
                           noise_levels, self._norm_forcings(forcings))
    return self._unnorm_predictions(inputs, preds)

  def sample(self, inputs, forcings, key, **kwargs):
    """Full diffusion sampling in normalized-residual space, mapped back."""
    norm_preds = self.predictor.sample(
        self._norm_inputs(inputs), self._norm_forcings(forcings), key,
        **kwargs)
    return self._unnorm_predictions(inputs, norm_preds)

  def predict(self, inputs, forcings, key=None):
    """Deterministic forward (GraphCast-style predictors)."""
    norm_preds = self.predictor.predict(
        self._norm_inputs(inputs), self._norm_forcings(forcings), key)
    return self._unnorm_predictions(inputs, norm_preds)

  def loss_and_predictions(self, inputs, targets, forcings, key=None):
    (loss, diags), norm_preds = self.predictor.loss_and_predictions(
        self._norm_inputs(inputs),
        self._norm_targets(inputs, targets),
        self._norm_forcings(forcings), key)
    return (loss, diags), self._unnorm_predictions(inputs, norm_preds)


class NaNCleaner(nnx.Module):
  """Replaces NaNs of one variable (e.g. sea_surface_temperature) with a
  fill value before the wrapped predictor sees the data; optionally
  reintroduces them into predictions using the input NaN mask."""

  def __init__(self, predictor: nnx.Module, var_to_clean: str,
               fill_value: float, reintroduce_nans: bool = False):
    self.predictor = predictor
    self.reintroduce_nans = reintroduce_nans
    d = find_layout_provider(predictor)
    self._masks = nnx.Dict()
    for role, lay in (('inputs', d.input_layout),
                      ('targets', d.target_layout),
                      ('forcings', d.forcing_layout)):
      m = np.zeros(lay.num_channels, dtype=bool)
      if var_to_clean in lay.var_names:
        m[lay.var_channels(var_to_clean)] = True
      self._masks[role] = StaticData(jnp.asarray(m))
    self.fill_value = fill_value
    # Channels of the cleaned var in each layout, for NaN reintroduction.
    tgt = d.target_layout
    self._has_target_var = var_to_clean in tgt.var_names
    if self._has_target_var:
      inp = d.input_layout
      self._tgt_chans = StaticData(
          jnp.asarray(tgt.var_channels(var_to_clean)))
      self._in_chans = StaticData(
          jnp.asarray(inp.var_channels(var_to_clean)))

  def _clean(self, x, role):
    mask = self._masks[role][...]
    return jnp.where(mask & jnp.isnan(x), jnp.asarray(self.fill_value,
                                                      x.dtype), x)

  def _reintroduce(self, raw_inputs, preds):
    if not (self.reintroduce_nans and self._has_target_var):
      return preds
    nan_any = jnp.isnan(
        jnp.take(raw_inputs, self._in_chans[...], axis=-1)).any(
            axis=-1, keepdims=True)
    tgt_ch = self._tgt_chans[...]
    chan_is_var = jnp.zeros(preds.shape[-1], bool).at[tgt_ch].set(True)
    return jnp.where(chan_is_var & nan_any, jnp.nan, preds)

  def loss(self, inputs, targets, forcings, key):
    return self.predictor.loss(self._clean(inputs, 'inputs'),
                               self._clean(targets, 'targets'),
                               self._clean(forcings, 'forcings'), key)

  def __call__(self, inputs, noisy_targets, noise_levels, forcings):
    preds = self.predictor(self._clean(inputs, 'inputs'), noisy_targets,
                           noise_levels, self._clean(forcings, 'forcings'))
    return self._reintroduce(inputs, preds)

  def sample(self, inputs, forcings, key, **kwargs):
    preds = self.predictor.sample(self._clean(inputs, 'inputs'),
                                  self._clean(forcings, 'forcings'), key,
                                  **kwargs)
    return self._reintroduce(inputs, preds)

  def predict(self, inputs, forcings, key=None):
    preds = self.predictor.predict(self._clean(inputs, 'inputs'),
                                   self._clean(forcings, 'forcings'), key)
    return self._reintroduce(inputs, preds)

  def loss_and_predictions(self, inputs, targets, forcings, key=None):
    (loss, diags), preds = self.predictor.loss_and_predictions(
        self._clean(inputs, 'inputs'), self._clean(targets, 'targets'),
        self._clean(forcings, 'forcings'), key)
    return (loss, diags), self._reintroduce(inputs, preds)


def build_stack(model: nnx.Module, stats, *, bf16: bool,
                clean_sst_nans: bool = False,
                normalize: bool = True) -> nnx.Module:
  """Assembles the canonical production wrapper stack.

  Order (reference: NaNCleaner inside normalization, train.py:170-175;
  Bfloat16Cast innermost): Bfloat16Cast -> NaNCleaner ->
  InputsAndResiduals. Checkpoint state trees depend on this nesting, so
  every CLI (train / evaluate / pod forecast) must assemble through here
  with the same flags it trained with.

  NaNCleaner sits INSIDE InputsAndResiduals and therefore sees normalized
  data: the fill is 0.0 (= the raw-space mean); only with normalize=False
  does the raw mean apply.
  """
  task = model.task  # GenCast and GraphCast both carry the TaskSpec
  wrapped = model
  if bf16:
    from gencast_tpu.models import casting
    wrapped = casting.Bfloat16Cast(wrapped)
  if clean_sst_nans and 'sea_surface_temperature' in task.input_variables:
    fill = (0.0 if normalize
            else float(np.asarray(stats.mean['sea_surface_temperature'])))
    wrapped = NaNCleaner(wrapped, 'sea_surface_temperature', fill)
  if normalize:
    wrapped = InputsAndResiduals(wrapped, stats)
  return wrapped
