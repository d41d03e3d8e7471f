"""Observability utilities: profiling traces, throughput meters, and the
shared benchmark fixture used by bench.py and the tools/ timing scripts."""

from __future__ import annotations

import contextlib
import time
import types
from typing import Optional

import jax


def sampler_fixture(spec, *, batch: int = 1, rngs_seed: int = 0,
                    log=None) -> types.SimpleNamespace:
  """Production-wrapped model + jitted one-forecast-step sampler + inputs.

  The canonical copy of the build/bf16-wrap/denoiser-unwrap/nnx.split/
  jit-sample sequence shared by bench.py's sampler sections and
  tools/kernel_decisions.py, so a change to the production wrapper
  convention lands everywhere at once. Inputs are generated with
  jax.random on device (no host upload).

  Returns a namespace with: model (wrapped), statics, denoiser, graphdef,
  state, inputs, forcings, key, and sample — a jitted
  fn(state, inputs, forcings, key) -> scalar sum of one sampled forecast
  step (39 denoiser calls on-device).
  """
  from gencast_tpu.nn import nnx
  import jax.numpy as jnp

  from gencast_tpu import configs
  from gencast_tpu.models import wrappers

  t0 = time.time()
  model, statics = configs.build_gencast(spec, rngs=nnx.Rngs(rngs_seed))
  if spec.cast_bf16:
    from gencast_tpu.models import casting
    model = casting.Bfloat16Cast(model)
  if log is not None:
    log(f'model build: {time.time() - t0:.1f}s')
  d = wrappers.find_layout_provider(model)
  nlat, nlon = statics.grid_lat.shape[0], statics.grid_lon.shape[0]

  inputs = jax.random.normal(
      jax.random.PRNGKey(0),
      (batch, nlat, nlon, d.input_layout.num_channels), jnp.float32)
  forcings = jax.random.normal(
      jax.random.PRNGKey(1),
      (batch, nlat, nlon, d.forcing_layout.num_channels), jnp.float32)
  key = jax.random.PRNGKey(2)
  graphdef, state = nnx.split(model)

  @jax.jit
  def sample(state, inputs, forcings, k):
    m = nnx.merge(graphdef, state)
    return m.sample(inputs, forcings, k).sum()

  return types.SimpleNamespace(
      model=model, statics=statics, denoiser=d, graphdef=graphdef,
      state=state, inputs=inputs, forcings=forcings, key=key, sample=sample)


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str]):
  """jax.profiler trace context; no-op when log_dir is None.

  View with TensorBoard (installed) or xprof: the trace includes XLA HLO
  timelines per device.
  """
  if log_dir is None:
    yield
    return
  jax.profiler.start_trace(log_dir)
  try:
    yield
  finally:
    jax.profiler.stop_trace()


class Throughput:
  """Steps/sec meter with exponential smoothing, for training loops."""

  def __init__(self, smoothing: float = 0.9):
    self._smoothing = smoothing
    self._last: Optional[float] = None
    self._rate: Optional[float] = None

  def tick(self, steps: int = 1) -> Optional[float]:
    now = time.time()
    if self._last is not None:
      inst = steps / max(now - self._last, 1e-9)
      self._rate = (inst if self._rate is None else
                    self._smoothing * self._rate
                    + (1 - self._smoothing) * inst)
    self._last = now
    return self._rate

  @property
  def rate(self) -> Optional[float]:
    return self._rate
