"""Tests for mesh/sharding/ensemble utilities on the virtual device mesh."""

from gencast_tpu.nn import nnx
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gencast_tpu.parallel import ensemble, meshes


def test_make_mesh_and_shardings():
  mesh = meshes.make_mesh(2, 2, 2)
  assert mesh.shape == {'ensemble': 2, 'data': 2, 'model': 2}
  with pytest.raises(ValueError):
    meshes.make_mesh(3, 1, 1)  # 3 != 8 devices


@pytest.mark.parametrize('shape', [(4, 1, 1), (1, 4, 1), (2, 1, 2)])
def test_make_mesh_on_four_of_eight_devices(shape):
  devices = jax.devices()[2:6]
  mesh = meshes.make_mesh(*shape, devices=devices)
  assert mesh.devices.shape == shape
  # A plain reshape: device order is the list's order.
  assert list(mesh.devices.ravel()) == devices
  x = jax.device_put(jnp.arange(8.0), meshes.batch_sharding(mesh))
  assert x.sharding.device_set == set(devices)


def test_shard_model_honors_annotations_and_falls_back():
  mesh = meshes.make_mesh(1, 1, 8)

  class M(nnx.Module):
    def __init__(self, rngs):
      from jax.sharding import PartitionSpec as P
      init = nnx.with_partitioning(nnx.initializers.xavier_uniform(),
                                   P(None, 'model'))
      self.big = nnx.Linear(16, 32, kernel_init=init, rngs=rngs)
      self.small = nnx.Linear(16, 3, kernel_init=init, rngs=rngs)

  m = M(nnx.Rngs(0))
  meshes.shard_model(m, mesh)
  big_shard = m.big.kernel[...].sharding
  small_shard = m.small.kernel[...].sharding
  # 32 divides 8 -> sharded over model; 3 doesn't -> replicated fallback.
  assert 'model' in str(big_shard.spec)
  assert 'model' not in str(small_shard.spec)


def test_member_keys_distinct():
  keys = ensemble.member_keys(jax.random.PRNGKey(0), 8)
  assert keys.shape[0] == 8
  assert np.unique(np.asarray(keys), axis=0).shape[0] == 8


def test_ensemble_statistics():
  mesh = meshes.make_mesh(8, 1, 1)
  rng = np.random.default_rng(0)
  members = jnp.asarray(rng.standard_normal((8, 4, 6)), jnp.float32)
  from jax.sharding import NamedSharding, PartitionSpec as P
  members_sharded = jax.device_put(
      members, NamedSharding(mesh, P('ensemble')))
  mean, std = ensemble.ensemble_statistics(members_sharded, mesh)
  np.testing.assert_allclose(np.asarray(mean),
                             np.asarray(members).mean(axis=0), atol=1e-6)
  np.testing.assert_allclose(np.asarray(std),
                             np.asarray(members).std(axis=0, ddof=1),
                             atol=1e-6)


def test_throughput_meter():
  from gencast_tpu.utils import Throughput
  t = Throughput()
  assert t.tick() is None
  assert t.tick() is not None and t.rate > 0


def test_ensemble_rollout_end_to_end():
  """4-member, 2-step ensemble forecast sharded over the 'ensemble' axis
  of the virtual mesh: member m must equal a solo rollout run with that
  member's folded key (no cross-member contamination)."""
  import numpy as np
  from gencast_tpu import rollout as rollout_lib
  from gencast_tpu.models import wrappers
  from gencast_tpu.data import layout as L
  from tests.test_gencast_model import TINY_TASK, _data
  from gencast_tpu.graph import compiler
  from gencast_tpu.models import gencast as gencast_lib
  from gencast_tpu.models.denoiser import DenoiserConfig
  from gencast_tpu.nn.transformer import TransformerConfig
  import dataclasses
  from gencast_tpu.nn import nnx

  lat = np.arange(-90.0, 90.0 + 1e-6, 30.0, dtype=np.float32)
  lon = np.arange(0.0, 360.0, 30.0, dtype=np.float32)
  statics = compiler.build_graph_statics(1, lat, lon, attention_k_hop=2)
  model = gencast_lib.GenCast(
      TINY_TASK, statics,
      TransformerConfig(d_model=16, num_layers=1, num_heads=2,
                        ffw_hidden=32),
      denoiser_config=dataclasses.replace(DenoiserConfig(), latent_size=16),
      sampler_config=gencast_lib.SamplerConfig(num_noise_levels=2),
      rngs=nnx.Rngs(0))
  stats = L.Stats.unit(
      set(TINY_TASK.input_variables) | set(TINY_TASK.target_variables),
      TINY_TASK.pressure_levels)
  wrapped = wrappers.InputsAndResiduals(model, stats)
  inputs, _, forcings = _data(statics, TINY_TASK, batch=1)
  frc_seq = jnp.stack([forcings] * 2)
  key = jax.random.PRNGKey(11)

  mesh = meshes.make_mesh(4, 2, 1)  # ensemble=4, data=2 on 8 CPU devices
  out = ensemble.ensemble_rollout(wrapped, inputs, frc_seq, key,
                                  num_members=4, mesh=mesh)
  assert out.shape[:2] == (4, 2)
  assert bool(jnp.isfinite(out).all())

  # Member 2 == solo rollout with that member's folded key.
  solo_key = ensemble.member_keys(key, 4)[2]
  solo = rollout_lib.sample_rollout(wrapped, inputs, frc_seq, solo_key)
  np.testing.assert_allclose(np.asarray(out[2]), np.asarray(solo),
                             rtol=2e-5, atol=2e-5)
  # Members differ from one another.
  assert float(jnp.abs(out[0] - out[1]).max()) > 1e-4

  mean, std = ensemble.ensemble_statistics(out, mesh)
  assert mean.shape == out.shape[1:]
  assert bool(jnp.isfinite(std).all())


@pytest.mark.slow
def test_dryrun_multichip_16_devices():
  """Exercises the 16-device row of the mesh-factors table
  (ensemble=4, data=2, model=2): dryrun_multichip re-execs itself in a
  forced-16-device CPU child, so the 8-device in-process platform here
  doesn't constrain it."""
  import __graft_entry__ as entrypoints
  entrypoints.dryrun_multichip(16)


def test_production_kernels_under_sharded_mesh():
  """Pins the kernel-bearing dryrun configs (nano-shaped triblock_pallas +
  tile-plan flash backend with agg plans / streamed edges / node sharding)
  to the 8-device mesh; see __graft_entry__.dryrun_production_kernels."""
  import __graft_entry__ as entrypoints
  mesh = meshes.make_mesh(2, 2, 2)
  entrypoints.dryrun_production_kernels(mesh, 2, 2, 2)


def test_local_batch_plan_covers_and_assembles():
  """local_batch_plan + assemble_local_batch must reproduce the global
  P('data') placement exactly for mixed mesh shapes (data x model,
  replicas over 'model' mapping to the same rows). Single-process here,
  so the plan covers ALL rows; the slicing/ordering logic is identical
  to the multi-process case the train CLI test drives."""
  import jax
  import numpy as np

  for dp, mp in [(4, 2), (8, 1), (2, 4), (1, 8)]:
    mesh = meshes.make_mesh(1, dp, mp)
    batch = 8
    rows, blocks = meshes.local_batch_plan(mesh, batch)
    assert sorted(rows.tolist()) == list(range(batch)), (dp, mp, rows)
    assert len(blocks) == 8  # one entry per addressable device

    full = np.arange(batch * 3, dtype=np.float32).reshape(batch, 3)
    local = full[rows]
    out = meshes.assemble_local_batch(mesh, batch, blocks, {'x': local})['x']
    np.testing.assert_array_equal(np.asarray(out), full)
    # Same placement as a direct global device_put.
    ref = jax.device_put(full, meshes.batch_sharding(mesh))
    assert out.sharding.is_equivalent_to(ref.sharding, full.ndim), (dp, mp)


def test_ensemble_scores_device_side_matches_cpu_path():
  """parallel.ensemble.ensemble_scores (member-sharded inputs, spatial
  reshard, on-device reduction) must agree with the plain ops/metrics
  functions on the gathered array AND with the streamed CPU scorer
  (score_ensemble_chunked) up to f32 reduction order."""
  from jax.sharding import NamedSharding, PartitionSpec as P

  from gencast_tpu.ops import metrics

  mesh = meshes.make_mesh(4, 1, 2)
  m, k, b, nlat, nlon, c = 8, 2, 1, 9, 8, 5
  rng = np.random.default_rng(0)
  members = rng.standard_normal((m, k, b, nlat, nlon, c)).astype(np.float32)
  truth = rng.standard_normal((k, b, nlat, nlon, c)).astype(np.float32)
  latw = np.linspace(0.5, 1.5, nlat).astype(np.float32)

  dev = jax.device_put(members, NamedSharding(mesh, P('ensemble')))
  scores = ensemble.ensemble_scores(dev, jnp.asarray(truth),
                                    jnp.asarray(latw), mesh=mesh)
  # Replicated outputs (KBs on the host, never the member fields).
  assert scores['crps'].sharding.is_fully_replicated

  direct = {
      'crps': metrics.crps_ensemble(jnp.asarray(members),
                                    jnp.asarray(truth), jnp.asarray(latw)),
      'rmse': metrics.ensemble_mean_rmse(jnp.asarray(members),
                                         jnp.asarray(truth),
                                         jnp.asarray(latw)),
      'spread': metrics.ensemble_spread(jnp.asarray(members),
                                        jnp.asarray(latw)),
  }
  chunked = metrics.score_ensemble_chunked(members, truth, latw,
                                           lat_chunk=4)
  for name in ('crps', 'rmse', 'spread'):
    np.testing.assert_allclose(np.asarray(scores[name]),
                               np.asarray(direct[name]), rtol=2e-5)
    np.testing.assert_allclose(np.asarray(scores[name]), chunked[name],
                               rtol=2e-5)


def test_batch_iterator_empty_rows_raises_clearly():
  """A dp/mp layout can leave a process with zero batch rows; the iterator
  must name the cause instead of crashing inside np.stack."""
  from gencast_tpu.data import registry, sources

  src = sources.SyntheticSource(registry.GENCAST_TASK,
                                np.linspace(-88, 88, 4),
                                np.linspace(0, 350, 8), num_times=10, seed=0)
  with pytest.raises(ValueError, match='owns no batch rows'):
    next(sources.batch_iterator(src, 2, rows=[]))
