"""GenCast: EDM-preconditioned diffusion forecasting (Karras et al. 2022).

Packed-array rebuild of the reference predictor (gencast/gencast.py:130-295)
plus its DPM-Solver++ 2S sampler (gencast/dpm_solver_plus_plus_2s.py) —
here the sampler is one `lax.scan` over noise levels with the
spherical-harmonic noise (and stochastic churn, which is broken in the
reference — see SURVEY §5 defect 1) generated inside the loop on device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

from gencast_tpu.nn import nnx
import jax
import jax.numpy as jnp
import numpy as np

from gencast_tpu.data import layout as layout_lib
from gencast_tpu.data.registry import TaskSpec
from gencast_tpu.graph.compiler import GraphStatics
from gencast_tpu.models import diffusion_utils
from gencast_tpu.models.denoiser import Denoiser, DenoiserConfig
from gencast_tpu.nn.transformer import TransformerConfig
from gencast_tpu.nn.variables import StaticData
from gencast_tpu.ops import losses, sph_harm


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
  """Sampling-time schedule (reference gencast/gencast.py:74-108)."""
  max_noise_level: float = 80.0
  min_noise_level: float = 0.03
  num_noise_levels: int = 20
  rho: float = 7.0
  stochastic_churn_rate: float = 2.5
  churn_min_noise_level: float = 0.75
  churn_max_noise_level: float = float('inf')
  noise_level_inflation_factor: float = 1.05


@dataclasses.dataclass(frozen=True)
class NoiseConfig:
  """Training-time noise-level distribution (gencast/gencast.py:111-115)."""
  training_noise_level_rho: float = 7.0
  training_max_noise_level: float = 88.0
  training_min_noise_level: float = 0.02


# Loss weighting per surface variable; atmospheric variables weight 1.0
# (reference gencast/gencast.py:259-278 and the upstream GenCast release).
LOSS_WEIGHTS_SURFACE = {
    '2m_temperature': 1.0,
    '10m_u_component_of_wind': 0.1,
    '10m_v_component_of_wind': 0.1,
    'mean_sea_level_pressure': 0.1,
    'sea_surface_temperature': 0.1,
    'total_precipitation_12hr': 0.1,
}


class GenCast(nnx.Module):
  """Denoising-diffusion predictor over packed fields.

  All tensors are [batch, lat, lon, channels] in *normalized* space (the
  InputsAndResiduals wrapper handles normalization outside). RNG is passed
  explicitly per call, so the model composes with scan/shard_map and
  per-ensemble-member key folding.
  """

  def __init__(self, task: TaskSpec, statics: GraphStatics,
               transformer: TransformerConfig,
               denoiser_config: DenoiserConfig = DenoiserConfig(),
               sampler_config: SamplerConfig = SamplerConfig(),
               noise_config: NoiseConfig = NoiseConfig(), *,
               rngs: nnx.Rngs,
               dense_attention_mask: Optional[np.ndarray] = None,
               noise_basis_dtype=np.float32):
    self.task = task
    self.sampler_config = sampler_config
    self.noise_config = noise_config
    self.denoiser = Denoiser(task, statics, transformer, denoiser_config,
                             rngs=rngs,
                             dense_attention_mask=dense_attention_mask)
    self.target_layout = self.denoiser.target_layout

    # The Legendre table is [L+1, L+1, num_lat]; at 0.25 degrees that is
    # 1.5GB f32, so the paper-scale config stores it bf16 (synthesis still
    # accumulates f32; see ops/sph_harm.synthesize). The tables live as
    # StaticData (traced operands): a plain attribute would be baked into
    # the program as a 1.5GB constant.
    basis = sph_harm.basis_for_grid(statics.grid_lat, statics.grid_lon,
                                    dtype=noise_basis_dtype)
    self._sh_legendre = StaticData(basis.legendre)
    self._sh_fourier = StaticData(basis.fourier)
    self._sh_max_l = basis.max_l
    lat_w = layout_lib.latitude_weights(statics.grid_lat)
    chan_w, diag_w = layout_lib.loss_channel_weights(
        self.target_layout, LOSS_WEIGHTS_SURFACE)
    self.lat_weights = StaticData(jnp.asarray(lat_w))
    self.loss_weights = StaticData(jnp.asarray(chan_w))
    self._diag_weights = diag_w

  # --- EDM preconditioning (sigma_data = 1; gencast/gencast.py:188-219) ---

  def _precond_denoise(self, inputs, forcings, noisy_targets, sigma):
    """D(x; sigma) = c_skip x + c_out F(c_in x; sigma)."""
    s = sigma.astype(noisy_targets.dtype)[:, None, None, None]
    c_in = (s ** 2 + 1.0) ** -0.5
    c_out = s * (s ** 2 + 1.0) ** -0.5
    c_skip = 1.0 / (s ** 2 + 1.0)
    raw = self.denoiser(inputs, noisy_targets * c_in, sigma, forcings)
    return raw * c_out + noisy_targets * c_skip

  def _sphere_noise(self, key, batch: int, dtype) -> jnp.ndarray:
    """Unit-variance isotropic noise, one independent field per channel:
    [B, lat, lon, C]."""
    basis = sph_harm.SphericalHarmonicBasis(
        legendre=self._sh_legendre[...], fourier=self._sh_fourier[...],
        max_l=self._sh_max_l)
    n = sph_harm.unit_white_noise(
        key, (batch, self.target_layout.num_channels), basis, dtype=dtype)
    return jnp.moveaxis(n, 1, -1)

  # --- Training loss (gencast/gencast.py:229-280) ---

  def loss(self, inputs: jnp.ndarray, targets: jnp.ndarray,
           forcings: jnp.ndarray, key: jax.Array
           ) -> Tuple[jnp.ndarray, Dict[str, jnp.ndarray]]:
    """Per-batch-element EDM loss, and per-variable diagnostics."""
    (loss, diagnostics), _ = self.loss_and_predictions(inputs, targets,
                                                       forcings, key)
    return loss, diagnostics

  def loss_and_predictions(self, inputs: jnp.ndarray, targets: jnp.ndarray,
                           forcings: jnp.ndarray, key: jax.Array):
    """EDM loss plus the denoised predictions from the SAME denoiser call.

    The reference runs the denoiser twice here (gencast/gencast.py:221-227,
    defect 4 in SURVEY §5); one call suffices — the loss's denoised estimate
    IS the prediction. Enables rollout.autoregressive_loss (multi-step
    fine-tuning) on GenCast stacks.
    """
    nc = self.noise_config
    batch = targets.shape[0]
    k_sigma, k_noise = jax.random.split(key)
    sigma = diffusion_utils.rho_inverse_cdf(
        nc.training_min_noise_level, nc.training_max_noise_level,
        nc.training_noise_level_rho,
        jax.random.uniform(k_sigma, (batch,), dtype=jnp.float32))

    noise = self._sphere_noise(k_noise, batch, targets.dtype)
    noisy = targets + noise * sigma.astype(targets.dtype)[:, None, None, None]
    denoised = self._precond_denoise(inputs, forcings, noisy, sigma)

    # lambda(sigma) = c_out^-2.
    lam = (sigma ** 2 + 1.0) / sigma ** 2
    loss = losses.weighted_mse(denoised, targets, self.lat_weights[...],
                               self.loss_weights[...],
                               per_sample_scale=lam)
    diagnostics = losses.per_variable_diagnostics(
        denoised, targets, self.lat_weights[...], self.target_layout,
        self._diag_weights)
    return (loss, diagnostics), denoised

  def __call__(self, inputs, noisy_targets, noise_levels, forcings):
    """Single preconditioned denoiser application."""
    return self._precond_denoise(inputs, forcings, noisy_targets,
                                 noise_levels)

  # --- Sampling: DPM-Solver++ 2S as one scan ---

  def sample(self, inputs: jnp.ndarray, forcings: jnp.ndarray,
             key: jax.Array, dtype=jnp.float32) -> jnp.ndarray:
    """Draws one sample of the (normalized-space) targets: [B,lat,lon,C].

    Second-order DPM-Solver++ 2S with optional stochastic churn, entirely
    on device: one lax.scan of full 2S steps (2 denoiser calls each) over
    the first N-1 levels, then the final level peeled out of the scan as a
    single Euler step — 2N-1 denoiser calls total, matching the
    reference's short-circuit (dpm_solver_plus_plus_2s.py:140-153).
    """
    sc = self.sampler_config
    batch = inputs.shape[0]
    sigmas_np = diffusion_utils.noise_schedule(
        sc.max_noise_level, sc.min_noise_level, sc.num_noise_levels, sc.rho)
    churn_np = diffusion_utils.stochastic_churn_rate_schedule(
        sigmas_np, sc.stochastic_churn_rate, sc.churn_min_noise_level,
        sc.churn_max_noise_level)
    sigmas = jnp.asarray(sigmas_np, dtype=jnp.float32)
    churns = jnp.asarray(churn_np, dtype=jnp.float32)
    use_churn = bool(np.any(churn_np > 0))

    key, k0 = jax.random.split(key)
    x0 = self._sphere_noise(k0, batch, dtype) * sigmas[0].astype(dtype)

    def denoise(x, sigma_scalar):
      sigma_b = jnp.full((batch,), jnp.maximum(sigma_scalar, 1e-6),
                         dtype=jnp.float32)
      return self._precond_denoise(inputs, forcings, x, sigma_b)

    def churn(x, sigma, churn_rate, step_key):
      if not use_churn:
        return x, sigma
      # Re-inject noise: sigma -> sigma * (1 + gamma)
      # (gencast/samplers_utils.py:434-452; fixed vs the reference's
      # broken apply_stochastic_churn_arr call).
      new_sigma = sigma * (1.0 + churn_rate)
      extra_std = (jnp.sqrt(jnp.maximum(new_sigma ** 2 - sigma ** 2, 0.0))
                   * sc.noise_level_inflation_factor)
      x = x + self._sphere_noise(step_key, batch, x.dtype) * \
          extra_std.astype(x.dtype)
      return x, new_sigma

    def body(x, per_step):
      sigma, sigma_next, churn_rate, step_key = per_step
      x, sigma = churn(x, sigma, churn_rate, step_key)
      sigma_mid = jnp.sqrt(sigma * sigma_next)
      x_denoised = denoise(x, sigma)
      alpha_mid = (sigma_mid / sigma).astype(x.dtype)
      x_mid = alpha_mid * x + (1.0 - alpha_mid) * x_denoised
      x_mid_denoised = denoise(x_mid, sigma_mid)
      alpha_next = (sigma_next / sigma).astype(x.dtype)
      x = alpha_next * x + (1.0 - alpha_next) * x_mid_denoised
      return x, ()

    num_steps = sc.num_noise_levels
    step_keys = jax.random.split(key, num_steps)
    # All but the last level take a full 2S step...
    xs = (sigmas[:-2], sigmas[1:-1], churns[:-1], step_keys[:-1])
    x, _ = jax.lax.scan(body, x0, xs)
    # ...and the final level (sigma_next == 0) is a single Euler step to
    # the denoised state: one call instead of two.
    x, sigma_last = churn(x, sigmas[-2], churns[-1], step_keys[-1])
    return denoise(x, sigma_last)
