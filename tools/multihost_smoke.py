"""Multi-process (multi-host) smoke: jax.distributed over N real processes.

The multi-host deployment (scripts/ensemble_forecast_pod.py --multihost)
spans HOSTS: one Python process per host, devices addressable only by
their own process, collectives across hosts. The virtual 8-device CPU mesh used everywhere else in the
test suite is single-process, so it cannot catch multi-process-only
failures (host-side placement of arrays onto non-addressable devices,
cross-process collectives, per-process PRNG/weight divergence).

This script IS one such process. It initializes jax.distributed against a
localhost coordinator (gloo CPU collectives), builds the same toy-but-
fully-featured GenCast the driver dryrun uses, and runs one sharded train
step plus a 2-member ensemble sample over an (ensemble, data, model) mesh
spanning both processes. Every process must print the same loss — the
proof that parameter placement, batch sharding, and the psum'd gradient
path agree across process boundaries.

Reference role: the reference has NO multi-process path at all (SURVEY
§2.3: no jax.distributed.initialize anywhere; pmap is single-process).
The localhost coordinator here is the CPU stand-in for a real host's
address.

Usage (run once per process, any order):
  python tools/multihost_smoke.py <process_id> <num_processes> [port]
Exercised by tests/test_multihost.py (slow tier).
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

LOCAL_DEVICES = 2  # per process


def main(proc: int, num_procs: int, port: int = 29781) -> None:
  # Env must be set before jax import; the in-Python config update below
  # selects the CPU whatever JAX_PLATFORMS says.
  from tools.xla_flags import force_host_device_count
  force_host_device_count(LOCAL_DEVICES)
  os.environ['JAX_PLATFORMS'] = 'cpu'
  import jax
  jax.config.update('jax_platforms', 'cpu')
  jax.distributed.initialize(f'localhost:{port}', num_procs, proc,
                             local_device_ids=list(range(LOCAL_DEVICES)))
  assert jax.process_count() == num_procs
  n_global = jax.device_count()
  print(f'[mh p{proc}] {jax.local_device_count()} local / '
        f'{n_global} global devices', flush=True)

  from gencast_tpu.nn import nnx
  import jax.numpy as jnp
  import numpy as np

  from gencast_tpu.data import registry
  from gencast_tpu.graph import compiler
  from gencast_tpu.models import wrappers
  from gencast_tpu.models.denoiser import DenoiserConfig
  from gencast_tpu.models.gencast import GenCast, SamplerConfig
  from gencast_tpu.nn.transformer import TransformerConfig
  from gencast_tpu.parallel import ensemble, meshes
  from gencast_tpu.training import steps
  from gencast_tpu.data import layout as L

  # ensemble x model mesh spanning the processes (4 global devices -> 2x2).
  assert n_global % 2 == 0, n_global
  mesh = meshes.make_mesh(ensemble=2, data=1, model=n_global // 2)

  task = registry.TaskSpec(
      input_variables=('2m_temperature', 'temperature', 'year_progress_sin',
                       'land_sea_mask'),
      target_variables=('2m_temperature', 'temperature'),
      forcing_variables=('year_progress_sin',),
      pressure_levels=(500, 1000),
      num_input_frames=2)
  lat = np.arange(-90.0, 90.0 + 1e-6, 45.0, dtype=np.float32)
  lon = np.arange(0.0, 360.0, 45.0, dtype=np.float32)
  # cache_dir=None: two processes racing the on-disk statics cache is a
  # test artifact, not a production concern (real pods share via GCS).
  statics = compiler.build_graph_statics(1, lat, lon, attention_k_hop=2,
                                         cache_dir=None)
  model = GenCast(
      task, statics,
      TransformerConfig(d_model=32, num_layers=2, num_heads=2,
                        ffw_hidden=64),
      denoiser_config=DenoiserConfig(latent_size=32,
                                     node_sharding_axis='model'),
      sampler_config=SamplerConfig(num_noise_levels=2,
                                   stochastic_churn_rate=2.5),
      rngs=nnx.Rngs(0))
  wrapped = wrappers.InputsAndResiduals(
      model, L.Stats.unit(set(task.input_variables)
                          | set(task.target_variables), task.pressure_levels))

  with jax.set_mesh(mesh):
    # device_put of process-identical host values onto cross-process
    # shardings: the exact path shard_model takes on a pod.
    meshes.shard_model(wrapped, mesh)
    optimizer = steps.create_optimizer(wrapped, steps.OptimizerConfig())

    rng = np.random.default_rng(0)  # identical on every process
    d = model.denoiser

    def arr(c):
      x = rng.standard_normal((2, lat.size, lon.size, c)).astype(np.float32)
      return jax.device_put(x, meshes.batch_sharding(mesh))

    inputs = arr(d.input_layout.num_channels)
    targets = arr(d.target_layout.num_channels)
    forcings = arr(d.forcing_layout.num_channels)

    loss, _ = steps.train_step(wrapped, optimizer, inputs, targets,
                               forcings, jax.random.PRNGKey(0))
    loss = float(loss)  # replicated output: addressable on every process
    assert np.isfinite(loss), loss
    print(f'[mh p{proc}] train step ok loss={loss:.6f}', flush=True)

    samples = ensemble.ensemble_sample(wrapped, inputs, forcings,
                                       jax.random.PRNGKey(1),
                                       num_members=2, mesh=mesh)
    # samples is 'ensemble'-sharded (one member per process group); the
    # eager reductions below compile tiny cross-process programs.
    finite = bool(jnp.isfinite(samples).all())
    total = float(jnp.asarray(samples).sum())
    assert finite
    print(f'[mh p{proc}] ensemble sample ok shape={tuple(samples.shape)} '
          f'sum={total:.6f}', flush=True)

  # The harness greps for this exact line from every process.
  print(f'MULTIHOST_OK p{proc}/{num_procs} loss={loss:.6f} '
        f'sum={total:.6f}', flush=True)


if __name__ == '__main__':
  main(int(sys.argv[1]), int(sys.argv[2]),
       int(sys.argv[3]) if len(sys.argv) > 3 else 29781)
