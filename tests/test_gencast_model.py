"""End-to-end GenCast model tests on a tiny configuration."""

import dataclasses

from gencast_tpu.nn import nnx
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gencast_tpu.data import layout as L
from gencast_tpu.data import registry
from gencast_tpu.graph import compiler
from gencast_tpu.models import gencast as gencast_lib
from gencast_tpu.models import wrappers
from gencast_tpu.models.denoiser import DenoiserConfig
from gencast_tpu.nn.transformer import TransformerConfig

TINY_TASK = registry.TaskSpec(
    input_variables=('2m_temperature', 'temperature',
                     'year_progress_sin', 'day_progress_sin',
                     'land_sea_mask'),
    target_variables=('2m_temperature', 'temperature'),
    forcing_variables=('year_progress_sin', 'day_progress_sin'),
    pressure_levels=(500, 1000),
    num_input_frames=2,
)


@pytest.fixture(scope="module")
def setup():
  lat = np.arange(-90.0, 90.0 + 1e-6, 30.0, dtype=np.float32)
  lon = np.arange(0.0, 360.0, 30.0, dtype=np.float32)
  statics = compiler.build_graph_statics(1, lat, lon, attention_k_hop=2)
  transformer = TransformerConfig(d_model=32, num_layers=2, num_heads=2,
                                  ffw_hidden=64)
  model = gencast_lib.GenCast(
      TINY_TASK, statics, transformer,
      denoiser_config=dataclasses.replace(DenoiserConfig(), latent_size=32),
      sampler_config=gencast_lib.SamplerConfig(num_noise_levels=3),
      rngs=nnx.Rngs(0))
  return statics, model


def _data(statics, task, batch=2, seed=0):
  rng = np.random.default_rng(seed)
  nlat, nlon = statics.grid_lat.shape[0], statics.grid_lon.shape[0]
  inp = L.build_layout(task.input_variables, task.pressure_levels,
                       task.num_input_frames)
  tgt = L.build_layout(task.target_variables, task.pressure_levels, 1)
  frc = L.build_layout(task.forcing_variables, task.pressure_levels, 1)
  def r(shape):
    return jnp.asarray(rng.standard_normal(shape), dtype=jnp.float32)
  return (r((batch, nlat, nlon, inp.num_channels)),
          r((batch, nlat, nlon, tgt.num_channels)),
          r((batch, nlat, nlon, frc.num_channels)))


def test_loss_and_gradients(setup):
  statics, model = setup
  inputs, targets, forcings = _data(statics, TINY_TASK)

  def loss_fn(m):
    loss, _ = m.loss(inputs, targets, forcings, jax.random.PRNGKey(0))
    return loss.mean()

  loss, grads = nnx.value_and_grad(loss_fn)(model)
  assert np.isfinite(float(loss))
  leaves = jax.tree_util.tree_leaves(grads)
  assert all(bool(jnp.isfinite(g).all()) for g in leaves)
  # FiLM conditioning must receive gradient (noise conditioning is live).
  flat = nnx.state(grads, nnx.Param).flat_state()
  film_grads = [v.value for k, v in flat if 'film' in '/'.join(map(str, k))]
  assert film_grads and any(float(jnp.abs(g).max()) > 0 for g in film_grads)


def test_denoiser_deterministic(setup):
  statics, model = setup
  inputs, targets, forcings = _data(statics, TINY_TASK)
  sigma = jnp.ones((2,))
  out1 = model(inputs, targets, sigma, forcings)
  out2 = model(inputs, targets, sigma, forcings)
  np.testing.assert_array_equal(np.asarray(out1), np.asarray(out2))
  assert out1.shape == targets.shape


def test_sample_shape_and_determinism(setup):
  statics, model = setup
  inputs, _, forcings = _data(statics, TINY_TASK)
  key = jax.random.PRNGKey(7)
  s1 = model.sample(inputs, forcings, key)
  s2 = model.sample(inputs, forcings, key)
  assert s1.shape == (2, statics.grid_lat.shape[0],
                      statics.grid_lon.shape[0],
                      model.target_layout.num_channels)
  np.testing.assert_array_equal(np.asarray(s1), np.asarray(s2))
  s3 = model.sample(inputs, forcings, jax.random.PRNGKey(8))
  assert np.abs(np.asarray(s1 - s3)).max() > 1e-6


def test_wrapped_model_loss_and_sample(setup):
  statics, model = setup
  stats = L.Stats(
      mean={'2m_temperature': np.asarray(1.5),
            'temperature': np.asarray([1.0, 2.0])},
      std={'2m_temperature': np.asarray(2.0),
           'temperature': np.asarray([3.0, 4.0])},
      diffs_std={'2m_temperature': np.asarray(0.5),
                 'temperature': np.asarray([0.7, 0.9])})
  wrapped = wrappers.InputsAndResiduals(
      wrappers.NaNCleaner(model, '2m_temperature', fill_value=1.5), stats)
  inputs, targets, forcings = _data(statics, TINY_TASK)
  # Inject NaNs into the cleaned variable.
  inputs = inputs.at[0, 0, 0, 0].set(jnp.nan)
  loss, diags = wrapped.loss(inputs, targets, forcings, jax.random.PRNGKey(1))
  assert loss.shape == (2,)
  assert np.isfinite(np.asarray(loss)).all()
  assert set(diags) == {'2m_temperature', 'temperature'}

  sample = wrapped.sample(inputs, forcings, jax.random.PRNGKey(2))
  assert sample.shape == targets.shape
  assert np.isfinite(np.asarray(sample)).all()


def test_residual_normalization_roundtrip(setup):
  statics, model = setup
  stats = L.Stats(
      mean={'2m_temperature': np.asarray(1.5),
            'temperature': np.asarray([1.0, 2.0])},
      std={'2m_temperature': np.asarray(2.0),
           'temperature': np.asarray([3.0, 4.0])},
      diffs_std={'2m_temperature': np.asarray(0.5),
                 'temperature': np.asarray([0.7, 0.9])})
  w = wrappers.InputsAndResiduals(model, stats)
  inputs, targets, _ = _data(statics, TINY_TASK)
  norm = w._norm_targets(inputs, targets)
  back = w._unnorm_predictions(inputs, norm)
  np.testing.assert_allclose(np.asarray(back), np.asarray(targets),
                             rtol=1e-5, atol=1e-5)
  # Residual semantics: normalized target of the last-input-frame copy is 0.
  base = w._residual_base(inputs)
  zero = w._norm_targets(inputs, base)
  np.testing.assert_allclose(np.asarray(zero), 0.0, atol=1e-6)


def test_loss_and_predictions_single_denoiser_call(setup, monkeypatch):
  """loss_and_predictions must reuse the loss's denoiser call (reference
  defect 4: gencast/gencast.py:221-227 runs the denoiser twice)."""
  statics, model = setup
  inputs, targets, forcings = _data(statics, TINY_TASK)
  key = jax.random.PRNGKey(3)

  from gencast_tpu.models import denoiser as denoiser_mod
  calls = []
  orig = denoiser_mod.Denoiser.__call__
  monkeypatch.setattr(denoiser_mod.Denoiser, '__call__',
                      lambda self, *a, **kw: (calls.append(1),
                                              orig(self, *a, **kw))[1])
  (loss, diags), preds = model.loss_and_predictions(inputs, targets,
                                                    forcings, key)
  assert len(calls) == 1
  assert preds.shape == targets.shape
  assert bool(jnp.isfinite(preds).all())
  # Same key -> identical loss through the plain .loss path.
  loss2, _ = model.loss(inputs, targets, forcings, key)
  np.testing.assert_array_equal(np.asarray(loss), np.asarray(loss2))


def test_sampler_denoiser_call_structure(setup, monkeypatch):
  """The final noise level is peeled out of the 2S scan: trace-level call
  count is 2 (scan body) + 1 (peeled Euler step), i.e. 2N-1 executed calls
  (reference dpm_solver_plus_plus_2s.py:140-153 short-circuit)."""
  statics, model = setup
  inputs, _, forcings = _data(statics, TINY_TASK)

  from gencast_tpu.models import denoiser as denoiser_mod
  calls = []
  orig = denoiser_mod.Denoiser.__call__
  monkeypatch.setattr(denoiser_mod.Denoiser, '__call__',
                      lambda self, *a, **kw: (calls.append(1),
                                              orig(self, *a, **kw))[1])
  model.sample(inputs, forcings, jax.random.PRNGKey(4))
  assert len(calls) == 3  # 2 traced in the scan body + 1 peeled final step


def test_sampler_single_level_is_one_euler_step(setup):
  """With one noise level the sampler is exactly denoise(noise*sigma0)."""
  import dataclasses as dc
  statics, model = setup
  inputs, _, forcings = _data(statics, TINY_TASK)
  key = jax.random.PRNGKey(5)

  old = model.sampler_config
  model.sampler_config = dc.replace(old, num_noise_levels=1,
                                    stochastic_churn_rate=0.0)
  try:
    out = model.sample(inputs, forcings, key)
    from gencast_tpu.models import diffusion_utils
    sc = model.sampler_config
    sigma0 = float(diffusion_utils.noise_schedule(
        sc.max_noise_level, sc.min_noise_level, 1, sc.rho)[0])
    _, k0 = jax.random.split(key)
    x0 = model._sphere_noise(k0, inputs.shape[0], jnp.float32) * sigma0
    expected = model._precond_denoise(
        inputs, forcings, x0, jnp.full((inputs.shape[0],), sigma0))
  finally:
    model.sampler_config = old
  np.testing.assert_allclose(np.asarray(out), np.asarray(expected),
                             rtol=1e-5, atol=1e-5)


def test_sampler_matches_reference_loop_formulation(setup):
  """The scan-restructured sampler (peeled final Euler step, fused 2S body)
  produces the same trajectory as a direct transcription of the reference's
  fori_loop update rule (dpm_solver_plus_plus_2s.py:120-158) run as a plain
  Python loop over the same schedule, with churn disabled so the comparison
  is deterministic."""
  import dataclasses as dc
  statics, model = setup
  inputs, _, forcings = _data(statics, TINY_TASK)
  key = jax.random.PRNGKey(11)
  batch = inputs.shape[0]

  old = model.sampler_config
  model.sampler_config = dc.replace(old, stochastic_churn_rate=0.0)
  try:
    out = model.sample(inputs, forcings, key)

    from gencast_tpu.models import diffusion_utils
    sc = model.sampler_config
    sigmas = diffusion_utils.noise_schedule(
        sc.max_noise_level, sc.min_noise_level, sc.num_noise_levels, sc.rho)

    def denoise(x, sigma):
      sigma_b = jnp.full((batch,), max(sigma, 1e-6), dtype=jnp.float32)
      return model._precond_denoise(inputs, forcings, x, sigma_b)

    # Reference body_fn, transcribed: churnless 2S step per level, with the
    # final sigma_next == 0 level selecting the single denoised state.
    _, k0 = jax.random.split(key)
    x = model._sphere_noise(k0, batch, jnp.float32) * float(sigmas[0])
    for i in range(len(sigmas) - 1):
      sigma, sigma_next = float(sigmas[i]), float(sigmas[i + 1])
      x_denoised = denoise(x, sigma)
      if sigma_next == 0.0:
        x = x_denoised
        break
      sigma_mid = float(np.sqrt(sigma * sigma_next))
      alpha_mid = sigma_mid / sigma
      x_mid = alpha_mid * x + (1.0 - alpha_mid) * x_denoised
      x_mid_denoised = denoise(x_mid, sigma_mid)
      alpha_next = sigma_next / sigma
      x = alpha_next * x + (1.0 - alpha_next) * x_mid_denoised
  finally:
    model.sampler_config = old
  np.testing.assert_allclose(np.asarray(out), np.asarray(x),
                             rtol=2e-5, atol=2e-5)


@pytest.mark.slow
def test_autoregressive_loss_gencast(setup):
  """Multi-step AR fine-tuning on a wrapped GenCast stack: finite loss and
  gradients through the whole 2-step rollout."""
  from gencast_tpu import rollout as R
  statics, model = setup
  stats = L.Stats.unit(
      set(TINY_TASK.input_variables) | set(TINY_TASK.target_variables),
      TINY_TASK.pressure_levels)
  wrapped = wrappers.InputsAndResiduals(model, stats)
  inputs, targets, forcings = _data(statics, TINY_TASK)
  k_steps = 2
  tgt_seq = jnp.stack([targets] * k_steps)
  frc_seq = jnp.stack([forcings] * k_steps)

  def loss_fn(m):
    loss, diags = R.autoregressive_loss(m, inputs, tgt_seq, frc_seq,
                                        key=jax.random.PRNGKey(6))
    return loss.mean(), diags

  (loss, diags), grads = nnx.value_and_grad(loss_fn, has_aux=True)(wrapped)
  assert np.isfinite(float(loss))
  assert all(bool(jnp.isfinite(g).all())
             for g in jax.tree_util.tree_leaves(grads))
  assert '2m_temperature' in diags


@pytest.mark.slow
def test_remat_gnns_matches_plain(setup):
  """DenoiserConfig.remat_gnns is a pure memory/recompute tradeoff:
  identical loss and gradients (QUARTER_DEG relies on it)."""
  statics, _ = setup
  transformer = TransformerConfig(d_model=32, num_layers=1, num_heads=2,
                                  ffw_hidden=64)

  def build(remat):
    return gencast_lib.GenCast(
        TINY_TASK, statics, transformer,
        denoiser_config=dataclasses.replace(DenoiserConfig(),
                                            latent_size=32,
                                            remat_gnns=remat),
        sampler_config=gencast_lib.SamplerConfig(num_noise_levels=2),
        rngs=nnx.Rngs(0))

  m0, m1 = build(False), build(True)
  inputs, targets, forcings = _data(statics, TINY_TASK, batch=1)

  def loss_fn(m):
    loss, _ = m.loss(inputs, targets, forcings, jax.random.PRNGKey(0))
    return loss.mean()

  l0, g0 = nnx.value_and_grad(loss_fn)(m0)
  l1, g1 = nnx.value_and_grad(loss_fn)(m1)
  np.testing.assert_allclose(float(l0), float(l1), rtol=1e-6)
  p0 = jax.tree.leaves(nnx.state(g0, nnx.Param))
  p1 = jax.tree.leaves(nnx.state(g1, nnx.Param))
  for a, b in zip(p0, p1):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                               rtol=1e-5, atol=1e-7)


def test_quarter_deg_spec_memory_plan():
  """The QUARTER_DEG preset must carry every memory-plan knob the
  single-chip 0.25-degree training step depends on."""
  from gencast_tpu import configs
  spec = configs.QUARTER_DEG
  assert spec.edge_chunk_size is not None     # streamed edges
  assert spec.remat_gnns                      # whole-GNN remat
  assert spec.noise_basis_dtype == 'bfloat16'  # 750MB Legendre table
  assert spec.use_gradient_checkpointing      # transformer remat
  assert spec.remat_policy == 'save_attention'  # keep attention residuals
  # The block-sparse kernel on the GPU: no dense triblock at splits=6.
  assert configs.attention_type_for(spec, platform='gpu') == 'pallas'


def test_functional_train_step_matches_nnx(setup):
  """The donated-state functional step computes the same first-step loss
  as the nnx train_step and threads state across steps."""
  import jax.numpy as jnp
  from gencast_tpu.training import steps as steps_lib

  statics, _ = setup
  transformer = TransformerConfig(d_model=32, num_layers=1, num_heads=2,
                                  ffw_hidden=64)

  def build():
    m = gencast_lib.GenCast(
        TINY_TASK, statics, transformer,
        denoiser_config=dataclasses.replace(DenoiserConfig(),
                                            latent_size=32),
        sampler_config=gencast_lib.SamplerConfig(num_noise_levels=2),
        rngs=nnx.Rngs(0))
    return m, steps_lib.create_optimizer(m, steps_lib.OptimizerConfig())

  inputs, targets, forcings = _data(statics, TINY_TASK, batch=1)
  key = jax.random.PRNGKey(0)

  m0, o0 = build()
  loss_ref, _ = steps_lib.train_step(m0, o0, inputs, targets, forcings, key)

  m1, o1 = build()
  step_fn, state = steps_lib.functional_train_step(m1, o1)
  state, loss1, _ = step_fn(state, inputs, targets, forcings, key)
  np.testing.assert_allclose(float(loss_ref), float(loss1), rtol=1e-6)
  # Second step runs on the donated state without touching stale buffers.
  state, loss2, _ = step_fn(state, inputs, targets, forcings, key)
  assert np.isfinite(float(loss2))
