"""Benchmarks: the metric set, on the device JAX finds.

Prints one JSON line per metric: {"metric", "value", "unit", "vs_baseline"}
— headline (nano denoiser fwd steps/s) first. The reference publishes no
quantitative numbers (README.md:19, BASELINE.md), so vs_baseline is null.

Metrics:
  nano_denoiser_steps_per_sec  — chained denoiser forwards (headline)
  nano_train_step_ms           — fwd+bwd+AdamW, nano
  nano_sampler_sec             — 20-level DPM++2S (39 denoiser calls)
  onedeg_train_step_ms         — fwd+bwd+AdamW, 1-degree splits=5 d=512
  onedeg_sampler_sec           — 20-level DPM++2S at 1 degree
  quarterdeg_train_step_sec    — fwd+bwd+AdamW at 0.25 degrees (bf16,
                                 donated state; dispatch-path timing)
  onedeg_rollout30_sec         — fused 30-step 1-member AR rollout at
                                 1 degree
  graphcast_nano_train_step_ms — the revived deterministic family
                                 (BASELINE config 5): fwd+bwd+AdamW
                                 through the 16-step multimesh GNN at
                                 the nano demo scale
  graphcast_onedeg_train_step_ms — GraphCast at its 1-degree operating
                                 point (splits=5, latent 512, 16 MP
                                 steps, bf16)
  qdeg_sampler_sec             — one 0.25-degree forecast step (39
                                 denoiser calls, bf16), fresh child
                                 process
  graphcast_onedeg_predict_ms  — one deterministic GraphCast forecast
                                 step at 1 degree (differenced fused AR
                                 rollout: predict + frame advance)
  graphcast_qdeg_train_step_sec — GraphCast at the published model's
                                 0.25-degree scale (splits=6 multimesh,
                                 latent 512, 16 MP steps, per-step remat);
                                 NOT in the default section list — run
                                 with BENCH_SECTIONS=graphcast_qdeg
  graphcast37_qdeg_train_step_sec — the FULL published configuration
                                 (0.25 degrees, 37 ERA5 levels,
                                 hierarchical remat_group=4); opt-in via
                                 BENCH_SECTIONS=graphcast_qdeg37
  graphcast_qdeg_predict_ms / graphcast_qdeg37_predict_ms — the
                                 deterministic forecast step at the
                                 published 0.25-degree scale (13-level
                                 task / the full 37-level configuration);
                                 opt-in sections

Every timed metric gets *_tflops / *_mfu companions (analytic model
FLOPs, gencast_tpu/training/flops.py; MFU against the bf16 peak of the
device kind in flops.PEAKS, and only on a device listed there).

Methodology: everything except the samplers is chained through an
on-device lax.scan (output feeds the next call's input) and differenced
between a 1-rep and an N-rep program with a scalar host readback. The
samplers are already 39-call on-device loops, timed wall-clock
post-warmup.

Run contract (this script is run unattended under an external timeout):
sections run in as few child processes as possible, except the
near-capacity sections (qdeg, qdeg_sampler, graphcast_onedeg/qdeg),
which each get a child of their own, with a deadline derived from
BENCH_BUDGET_S (default 1200 s of total wall clock); the section list
is ordered by metric priority (train-step metrics before the sampler
metrics, which rebuild their models in dedicated trailing sections),
each section is attempted while a minimal time floor remains, a hang
(which no in-process guard can interrupt) is killed at the deadline,
and the parent ALWAYS exits 0 with whatever metrics were emitted
before. So what falls off the end of a tight budget is a sampler
number, never the 0.25-degree train step.
Knobs:
  BENCH_BUDGET_S   total wall-clock budget, seconds (default 1200)
  BENCH_SECTIONS   comma list from {tiny,nano,onedeg,qdeg,nano_sampler,
                   onedeg_sampler,onedeg_rollout30,graphcast,
                   graphcast_onedeg,qdeg_sampler,graphcast_onedeg_predict,
                   graphcast_qdeg,graphcast_qdeg37,graphcast_qdeg_predict,
                   graphcast_qdeg37_predict,tiny_rollout3,
                   tiny_graphcast,tiny_graphcast_predict},
                   ordered by priority (default 'nano,onedeg,qdeg,
                   nano_sampler,onedeg_sampler,onedeg_rollout30,
                   graphcast,graphcast_onedeg,graphcast_onedeg_predict,
                   qdeg_sampler' — a tight budget drops the tail, whose
                   two sections are ordered cheap-first; 'tiny*' are the
                   CPU-sized configs the test tier uses to exercise this
                   plumbing)
  BENCH_SKIP_1DEG / BENCH_SKIP_QDEG  legacy single-section skips
"""

import json
import os
import subprocess
import sys
import threading
import time

REPS = 21
_T0 = time.time()

# Minimal remaining wall clock worth starting a section for. Sections
# are ordered by metric priority, so there is nothing after a section
# more important than the section itself: attempt whenever this floor
# remains and let the parent's deadline kill bound an overrun (metrics
# emit incrementally, so a killed section still lands whatever it
# printed).
_MIN_SECTION_S = 45


def _emit(metric, value, unit, ndigits=3):
  print(json.dumps({'metric': metric, 'value': round(value, ndigits),
                    'unit': unit, 'vs_baseline': None}))
  sys.stdout.flush()


def _emit_mfu(metric_prefix, flops_total, seconds):
  """Model-TFLOP/s + MFU companions to a timed metric (training/flops.py:
  analytic matmul FLOPs; MFU over the device's bf16 peak, f32 configs
  under-read by design). The MFU line is printed only for a device kind
  with a published peak (flops.PEAKS). 6 digits: small CPU test-tier
  values must stay nonzero in the JSON contract."""
  import jax
  from gencast_tpu.training import flops as flops_lib
  _emit(f'{metric_prefix}_tflops', flops_total / seconds / 1e12, 'TFLOP/s',
        ndigits=6)
  kind = jax.devices()[0].device_kind
  if kind in flops_lib.PEAKS:
    _emit(f'{metric_prefix}_mfu', flops_lib.mfu(flops_total, seconds, kind),
          'fraction_of_bf16_peak', ndigits=6)


def _timed_all(fn, make_args, iters=3):
  """Wall times of fn(*make_args(i)) with a scalar readback, post-warmup.

  make_args varies per i, so that no two calls are identical. Stops
  early when the section deadline approaches, so a slow section still
  lands a (noisier) metric.
  """
  float(fn(*make_args(-1)))
  times = []
  for i in range(iters):
    args = make_args(i)
    t0 = time.time()
    float(fn(*args))
    times.append(time.time() - t0)
    if _deadline_remaining() < 3 * times[-1]:
      break
  return times


def _timed(fn, make_args, iters=3):
  return min(_timed_all(fn, make_args, iters))


def bench_model(spec, tag, train_reps, fwd=False, sampler=True,
                builder=None):
  from gencast_tpu.nn import nnx
  import jax
  import jax.numpy as jnp

  from gencast_tpu import configs
  from gencast_tpu.models import wrappers
  from gencast_tpu.training import flops as flops_lib
  from gencast_tpu.training import steps

  t0 = time.time()
  build = builder if builder is not None else configs.build_gencast
  model, statics = build(spec, rngs=nnx.Rngs(0))
  if spec.cast_bf16:
    from gencast_tpu.models import casting
    model = casting.Bfloat16Cast(model)
  print(f'[{tag}] model build: {time.time()-t0:.1f}s', file=sys.stderr)
  d = wrappers.find_layout_provider(model)
  # Analytic model FLOPs for the MFU companions (the builder may have
  # substituted the task, e.g. build_graphcast on GenCast presets).
  if builder is configs.build_graphcast:
    fwd_flops = flops_lib.graphcast_forward_flops(spec, statics,
                                                  task=d.task)
  else:
    fwd_flops = flops_lib.denoiser_forward_flops(spec, statics, task=d.task)
  nlat, nlon = statics.grid_lat.shape[0], statics.grid_lon.shape[0]

  def arr(c, i):
    # Generated on device: no host upload.
    return jax.random.normal(jax.random.PRNGKey(i), (1, nlat, nlon, c),
                             jnp.float32)

  inputs = arr(d.input_layout.num_channels, 0)
  targets = arr(d.target_layout.num_channels, 1)
  forcings = arr(d.forcing_layout.num_channels, 2)
  key = jax.random.PRNGKey(0)

  # --- denoiser forward (chained) ---
  if fwd:
    graphdef, state = nnx.split(model)
    m = nnx.merge(graphdef, state)
    sigma = jnp.ones((1,), jnp.float32)

    def loop_factory(reps):
      @jax.jit
      def loop(x):
        def body(c, _):
          # f32 carry regardless of model compute dtype (bf16 presets).
          return m(inputs, c, sigma, forcings).astype(jnp.float32), ()
        c, _ = jax.lax.scan(body, x, None, length=reps)
        return c.sum()
      return loop

    t0 = time.time()
    t1 = _timed(loop_factory(1), lambda i: (targets + float(i),))
    tns = _timed_all(loop_factory(REPS), lambda i: (targets + float(i),),
                     iters=5)
    print(f'[{tag}] fwd phase wall: {time.time()-t0:.1f}s', file=sys.stderr)
    dts = sorted((tn - t1) / (REPS - 1) for tn in tns)
    dt = dts[0]
    # Log the within-session spread so that a cross-run delta can be
    # told from noise.
    print(f'[{tag}] denoiser fwd: {dt*1000:.2f} ms/step '
          f'(best of {len(dts)} differenced scans; spread '
          f'{dts[0]*1000:.2f}..{dts[-1]*1000:.2f} ms, '
          f'median {dts[len(dts)//2]*1000:.2f})', file=sys.stderr)
    _emit(f'{tag}_denoiser_steps_per_sec', 1.0 / dt, 'steps/s/chip')
    _emit_mfu(f'{tag}_denoiser_fwd', fwd_flops.total, dt)

  # --- train step (fwd+bwd+AdamW, chained through optimizer state) ---
  opt = steps.create_optimizer(model, steps.OptimizerConfig())
  graphdef, state = nnx.split((model, opt))

  def train_loop_factory(reps):
    @jax.jit
    def loop(state, inputs):
      def body(carry, _):
        mm, oo = nnx.merge(graphdef, carry)

        def loss_fn(m_):
          loss, _ = m_.loss(inputs, targets, forcings, key)
          return loss.mean()

        loss, grads = nnx.value_and_grad(loss_fn)(mm)
        oo.update(mm, grads)
        _, new_state = nnx.split((mm, oo))
        return new_state, loss
      _, losses = jax.lax.scan(body, state, None, length=reps)
      return losses.sum()
    return loop

  t0 = time.time()
  t1 = _timed(train_loop_factory(1), lambda i: (state, inputs + float(i)))
  tns = _timed_all(train_loop_factory(train_reps),
                   lambda i: (state, inputs + float(i)))
  print(f'[{tag}] train phase wall: {time.time()-t0:.1f}s', file=sys.stderr)
  dts = sorted((tn - t1) / (train_reps - 1) for tn in tns)
  dt = dts[0]
  # Log the within-session spread so that a cross-run delta can be told
  # from noise.
  print(f'[{tag}] train step: {dt*1000:.1f} ms (best of {len(dts)}; '
        f'spread {dts[0]*1000:.1f}..{dts[-1]*1000:.1f})', file=sys.stderr)
  _emit(f'{tag}_train_step_ms', dt * 1000, 'ms/step')
  _emit_mfu(f'{tag}_train', flops_lib.train_step_flops(fwd_flops).total, dt)

  if not sampler:
    return

  # --- full sampler (one forecast step: 39 denoiser calls on-device) ---
  graphdef_m, state_m = nnx.split(model)

  @jax.jit
  def sample(state, inputs, forcings, k):
    mm = nnx.merge(graphdef_m, state)
    return mm.sample(inputs, forcings, k).sum()

  t = _timed(sample, lambda i: (state_m, inputs + float(i), forcings, key),
             iters=2)
  print(f'[{tag}] sampler: {t:.2f}s/forecast-step', file=sys.stderr)
  _emit(f'{tag}_sampler_sec', t, 's/forecast-step')
  _emit_mfu(f'{tag}_sampler',
            flops_lib.sampler_step_flops(fwd_flops,
                                         spec.num_noise_levels).total, t)


def bench_sampler(spec, tag):
  """Sampler-only section: rebuilds the model (cheap with warm graph
  pickles, 3-15s) so the sampler metrics can run AFTER all train-step
  metrics in the priority order instead of inside bench_model."""
  from gencast_tpu import utils
  from gencast_tpu.training import flops as flops_lib

  fx = utils.sampler_fixture(
      spec, log=lambda m: print(f'[{tag}] {m}', file=sys.stderr))
  t = _timed(fx.sample,
             lambda i: (fx.state, fx.inputs + float(i), fx.forcings, fx.key),
             iters=2)
  print(f'[{tag}] sampler: {t:.2f}s/forecast-step', file=sys.stderr)
  _emit(f'{tag}_sampler_sec', t, 's/forecast-step')
  fwd = flops_lib.denoiser_forward_flops(spec, fx.statics,
                                         task=fx.denoiser.task)
  _emit_mfu(f'{tag}_sampler',
            flops_lib.sampler_step_flops(fwd, spec.num_noise_levels).total,
            t)


def bench_rollout30(spec, tag, num_steps=30):
  """Wall-clock of the fused num_steps-step, 1-member AR sampler rollout
  (one jitted lax.scan over forecast steps, each a 39-call DPM++2S
  sampler). An ensemble forecast scales from this single-card number
  over the ensemble axis. Reference role: common/rollout.py:245-376
  (python-loop chunked rollout with per-step host round-trips)."""
  from gencast_tpu.nn import nnx
  import jax
  import jax.numpy as jnp

  from gencast_tpu import rollout as rollout_lib
  from gencast_tpu import utils
  from gencast_tpu.data import layout as layout_lib

  fx = utils.sampler_fixture(
      spec, log=lambda m: print(f'[{tag}] {m}', file=sys.stderr))
  d = fx.denoiser
  nlat = fx.statics.grid_lat.shape[0]
  nlon = fx.statics.grid_lon.shape[0]
  frc = jax.random.normal(
      jax.random.PRNGKey(1),
      (num_steps, 1, nlat, nlon, d.forcing_layout.num_channels),
      jnp.float32)
  maps = layout_lib.rollout_maps(d.input_layout, d.target_layout,
                                 d.forcing_layout)
  graphdef, state = fx.graphdef, fx.state

  @jax.jit
  def run(state, inputs, forcings, key):
    m = nnx.merge(graphdef, state)
    preds = rollout_lib.rollout(lambda x, f, k: m.sample(x, f, k),
                                inputs, forcings, maps, key)
    return preds.sum()

  t = _timed(run, lambda i: (state, fx.inputs + float(i), frc, fx.key),
             iters=1)
  print(f'[{tag}] rollout{num_steps}: {t:.1f}s', file=sys.stderr)
  _emit(f'{tag}_rollout{num_steps}_sec', t, f's/{num_steps}-step-forecast')
  from gencast_tpu.training import flops as flops_lib
  fwd = flops_lib.denoiser_forward_flops(spec, fx.statics, task=d.task)
  _emit_mfu(
      f'{tag}_rollout{num_steps}',
      num_steps * flops_lib.sampler_step_flops(
          fwd, spec.num_noise_levels).total, t)


def bench_graphcast_predict(spec, tag, reps=9):
  """Marginal latency of ONE deterministic GraphCast forecast step: a
  fused AR rollout (rollout.rollout — predict() + on-device frame
  advance inside one lax.scan), differenced 1-rep vs reps-rep with a
  scalar readback.
  Completes the family's metric matrix: train steps are benched at
  nano/1deg/0.25deg scale, and this is the inference path a reference
  user would drive via common/rollout.py:245-376 (unrunnable there —
  graphcast.py never constructs)."""
  from gencast_tpu.nn import nnx
  import jax
  import jax.numpy as jnp

  from gencast_tpu import configs
  from gencast_tpu import rollout as rollout_lib
  from gencast_tpu.data import layout as layout_lib
  from gencast_tpu.models import wrappers
  from gencast_tpu.training import flops as flops_lib

  t0 = time.time()
  model, statics = configs.build_graphcast(spec, rngs=nnx.Rngs(0))
  if spec.cast_bf16:
    from gencast_tpu.models import casting
    model = casting.Bfloat16Cast(model)
  print(f'[{tag}] model build: {time.time()-t0:.1f}s', file=sys.stderr)
  d = wrappers.find_layout_provider(model)
  nlat, nlon = statics.grid_lat.shape[0], statics.grid_lon.shape[0]
  inputs = jax.random.normal(jax.random.PRNGKey(0),
                             (1, nlat, nlon, d.input_layout.num_channels),
                             jnp.float32)
  maps = layout_lib.rollout_maps(d.input_layout, d.target_layout,
                                 d.forcing_layout)
  graphdef, state = nnx.split(model)

  @jax.jit
  def run(state, x, forcings, key):
    m = nnx.merge(graphdef, state)
    preds = rollout_lib.rollout(lambda xx, ff, kk: m.predict(xx, ff),
                                x, forcings, maps, key)
    return preds.sum()

  key = jax.random.PRNGKey(0)

  def frc(n, i):
    # A jit argument, not a closure capture (no large baked-in
    # constants in the program).
    return jax.random.normal(
        jax.random.PRNGKey(100 + i),
        (n, 1, nlat, nlon, d.forcing_layout.num_channels), jnp.float32)

  t0 = time.time()
  t1 = _timed(run, lambda i: (state, inputs + float(i), frc(1, i), key))
  tns = _timed_all(run,
                   lambda i: (state, inputs + float(i), frc(reps, i), key))
  print(f'[{tag}] predict phase wall: {time.time()-t0:.1f}s',
        file=sys.stderr)
  dts = sorted((tn - t1) / (reps - 1) for tn in tns)
  dt = dts[0]
  print(f'[{tag}] predict step: {dt*1000:.1f} ms (best of {len(dts)}; '
        f'spread {dts[0]*1000:.1f}..{dts[-1]*1000:.1f})', file=sys.stderr)
  _emit(f'{tag}_predict_ms', dt * 1000, 'ms/forecast-step')
  fwd = flops_lib.graphcast_forward_flops(spec, statics, task=d.task)
  _emit_mfu(f'{tag}_predict', fwd.total, dt)


def bench_big_train(tag, prefix, spec, builder=None, **build_kwargs):
  """Shared scaffold for the near-capacity train-step sections (the
  0.25-degree GenCast / GraphCast configs). No scan chaining — the step
  itself is seconds long, far above dispatch noise — and a float(loss)
  scalar readback per step. Each caller gets its own child process (see
  main).

  build_kwargs pass through to the builder (e.g. remat_group=4 for the
  37-level published GraphCast configuration)."""
  from gencast_tpu.nn import nnx
  import jax
  import jax.numpy as jnp

  from gencast_tpu import configs
  from gencast_tpu.models import casting, wrappers
  from gencast_tpu.training import flops as flops_lib
  from gencast_tpu.training import steps

  t0 = time.time()
  build = builder if builder is not None else configs.build_gencast
  model, statics = build(spec, rngs=nnx.Rngs(0), **build_kwargs)
  model = casting.Bfloat16Cast(model)
  print(f'[{tag}] model build: {time.time()-t0:.1f}s', file=sys.stderr)
  t0 = time.time()
  opt = steps.create_optimizer(model, steps.OptimizerConfig())
  step_fn, state = steps.functional_train_step(model, opt)
  print(f'[{tag}] optimizer+state: {time.time()-t0:.1f}s', file=sys.stderr)

  d = wrappers.find_layout_provider(model)
  nlat, nlon = statics.grid_lat.shape[0], statics.grid_lon.shape[0]
  t0 = time.time()

  def arr(c, i):
    # Generated on device: no host upload.
    return jax.random.normal(jax.random.PRNGKey(i), (1, nlat, nlon, c),
                             jnp.float32)

  inputs = arr(d.input_layout.num_channels, 0)
  targets = arr(d.target_layout.num_channels, 1)
  forcings = arr(d.forcing_layout.num_channels, 2)
  jax.block_until_ready(forcings)
  print(f'[{tag}] inputs: {time.time()-t0:.1f}s', file=sys.stderr)
  key = jax.random.PRNGKey(0)

  t0 = time.time()
  state, loss, _ = step_fn(state, inputs, targets, forcings, key)
  print(f'[{tag}] compile+run: {time.time()-t0:.1f}s '
        f'loss={float(loss):.3f}', file=sys.stderr)
  ts = []
  for i in range(3):
    t0 = time.time()
    state, loss, _ = step_fn(state, inputs, targets, forcings,
                             jax.random.fold_in(key, i + 1))
    float(loss)  # scalar readback bounds the wall (block_until_ready lies)
    ts.append(time.time() - t0)
    if _deadline_remaining() < 3 * ts[-1]:
      break  # land the metric with the reps that fit the budget
  print(f'[{tag}] train step: {min(ts):.3f}s '
        f'(best of {len(ts)}; all {[round(t, 3) for t in ts]})',
        file=sys.stderr)
  _emit(f'{prefix}_train_step_sec', min(ts), 's/step')
  if builder is configs.build_graphcast:
    fwd = flops_lib.graphcast_forward_flops(spec, statics, task=d.task)
  else:
    fwd = flops_lib.denoiser_forward_flops(spec, statics, task=d.task)
  _emit_mfu(f'{prefix}_train', flops_lib.train_step_flops(fwd).total,
            min(ts))


def bench_quarterdeg():
  """0.25-degree train step: bf16 + donated state."""
  from gencast_tpu import configs
  bench_big_train('qdeg', 'quarterdeg', configs.QUARTER_DEG)


def bench_graphcast_qdeg():
  """GraphCast training step at the published model's 0.25-degree scale
  (graphcast/graphcast.py:174-201: splits=6 multimesh, latent 512, 16
  unshared MP steps; 13-level task per the preset conversion). Memory
  plan: bf16 + donated state + streamed encoder/decoder edges
  (edge_chunk_size) + whole-GNN encoder/decoder remat + per-MP-step
  processor remat (GraphCastConfig.remat — 16 x ~1.5 GB of unshared MLP
  residuals otherwise)."""
  from gencast_tpu import configs
  bench_big_train('graphcast_qdeg', 'graphcast_qdeg', configs.QUARTER_DEG,
                  builder=configs.build_graphcast)


def bench_graphcast_qdeg37():
  """The FULL published GraphCast configuration: 0.25 degrees, all 37
  ERA5 levels (in=466/tgt=227 channels), latent 512, 16 MP steps —
  hierarchical remat (remat_group=4; the 16 loop-carried step boundaries
  of flat per-step remat are ~480MB bf16 each)."""
  import dataclasses

  from gencast_tpu import configs
  from gencast_tpu.data import registry
  spec = dataclasses.replace(configs.QUARTER_DEG,
                             task=registry.GRAPHCAST_TASK_37)
  bench_big_train('gc37', 'graphcast37_qdeg', spec,
                  builder=configs.build_graphcast, remat_group=4)


def bench_qdeg_sampler():
  """One 0.25-degree forecast step (the paper-scale inference
  deliverable): the full 20-level DPM++2S sampler, bf16, one jitted
  program with a scalar readback. Own child process (near-capacity HBM,
  same rule as the qdeg train section). Reference role: training/evaluation.py:431-495 at the published
  model's scale."""
  from gencast_tpu import configs, utils
  from gencast_tpu.training import flops as flops_lib

  fx = utils.sampler_fixture(
      configs.QUARTER_DEG,
      log=lambda m: print(f'[qdeg_sampler] {m}', file=sys.stderr))
  t0 = time.time()
  v = float(fx.sample(fx.state, fx.inputs, fx.forcings, fx.key))
  print(f'[qdeg_sampler] compile+run: {time.time()-t0:.1f}s '
        f'(sum={v:.3e})', file=sys.stderr)
  ts = []
  for i in range(2):
    t0 = time.time()
    float(fx.sample(fx.state, fx.inputs + float(i + 1), fx.forcings,
                    fx.key))
    ts.append(time.time() - t0)
    if _deadline_remaining() < 1.5 * ts[-1]:
      break
  t = min(ts)
  print(f'[qdeg_sampler] sampler: {t:.1f}s/forecast-step', file=sys.stderr)
  _emit('qdeg_sampler_sec', t, 's/forecast-step')
  fwd = flops_lib.denoiser_forward_flops(configs.QUARTER_DEG, fx.statics,
                                         task=fx.denoiser.task)
  _emit_mfu('qdeg_sampler',
            flops_lib.sampler_step_flops(
                fwd, configs.QUARTER_DEG.num_noise_levels).total, t)


def _deadline_remaining(default: float = 1e9) -> float:
  """Seconds until this (child) process's deadline, from BENCH_DEADLINE."""
  dl = os.environ.get('BENCH_DEADLINE')
  return float(dl) - time.time() if dl else default


def _dispatch(name: str) -> None:
  from gencast_tpu import configs
  if name == 'tiny':
    bench_model(configs.TINY, 'tiny', train_reps=3, fwd=True)
  elif name == 'nano':
    bench_model(configs.NANO, 'nano', train_reps=REPS, fwd=True,
                sampler=False)
  elif name == 'onedeg':
    bench_model(configs.ONE_DEG, 'onedeg', train_reps=9, sampler=False)
  elif name == 'qdeg':
    bench_quarterdeg()
  elif name == 'nano_sampler':
    bench_sampler(configs.NANO, 'nano')
  elif name == 'onedeg_sampler':
    bench_sampler(configs.ONE_DEG, 'onedeg')
  elif name == 'onedeg_rollout30':
    bench_rollout30(configs.ONE_DEG, 'onedeg')
  elif name == 'tiny_rollout3':
    bench_rollout30(configs.TINY, 'tiny', num_steps=3)
  elif name == 'graphcast':
    # The revived deterministic family (BASELINE config 5) at the
    # reference demo scale: 2.5 deg, splits=4, latent 256, 16 multimesh
    # GNN message steps, bf16 (the nano preset's production wrapper).
    bench_model(configs.NANO, 'graphcast_nano', train_reps=REPS,
                sampler=False, builder=configs.build_graphcast)
  elif name == 'graphcast_onedeg':
    # GraphCast at the reference family's real operating point
    # (graphcast/graphcast.py:174-201): 1 degree, splits=5, latent 512,
    # 16 unshared multimesh MP steps, bf16.
    bench_model(configs.ONE_DEG, 'graphcast_onedeg', train_reps=5,
                sampler=False, builder=configs.build_graphcast)
  elif name == 'qdeg_sampler':
    bench_qdeg_sampler()
  elif name == 'graphcast_onedeg_predict':
    bench_graphcast_predict(configs.ONE_DEG, 'graphcast_onedeg')
  elif name == 'graphcast_qdeg_predict':
    # Published-model scale, 13-level task. Forward-only, so none of
    # the training memory plan is needed; reps=3 keeps the fused
    # rollout program small.
    bench_graphcast_predict(configs.QUARTER_DEG, 'graphcast_qdeg',
                            reps=3)
  elif name == 'graphcast_qdeg37_predict':
    # The published GraphCast operating point: 0.25 degrees, all 37
    # ERA5 levels; this measures the per-step (6h) cost.
    import dataclasses as _dc

    from gencast_tpu.data import registry as _reg
    bench_graphcast_predict(
        _dc.replace(configs.QUARTER_DEG, task=_reg.GRAPHCAST_TASK_37),
        'graphcast_qdeg37', reps=3)
  elif name == 'tiny_graphcast_predict':
    bench_graphcast_predict(configs.TINY, 'tiny_graphcast', reps=3)
  elif name == 'graphcast_qdeg':
    bench_graphcast_qdeg()
  elif name == 'graphcast_qdeg37':
    bench_graphcast_qdeg37()
  elif name == 'tiny_graphcast':
    bench_model(configs.TINY, 'tiny_graphcast', train_reps=3,
                sampler=False, builder=configs.build_graphcast)
  else:
    raise ValueError(f'unknown bench section {name!r}')


def _run_sections(names: str) -> None:
  """Child mode: run the comma-separated sections IN ONE PROCESS.

  A section that no longer fits the deadline is skipped with a note; a
  failing section doesn't stop later ones.
  """
  for name in names.split(','):
    rem = _deadline_remaining()
    # Sections are ordered by metric priority: nothing later in the
    # list outranks the section at hand, so there is no reason to skip
    # it to protect them — attempt whenever a minimal floor remains and
    # let the parent's deadline kill bound an overrun (metrics emit
    # incrementally, so a killed section still lands what it printed).
    if rem < _MIN_SECTION_S:
      print(f'[bench] SKIP {name}: {rem:.0f}s to deadline, '
            f'~{_MIN_SECTION_S}s floor '
            f'(raise BENCH_BUDGET_S to include it)', file=sys.stderr)
      continue
    try:
      _dispatch(name)
    except Exception as e:  # noqa: BLE001 - land the other sections
      print(f'[bench] section {name} failed: {e}', file=sys.stderr)
    finally:
      # Drop this section's host references before the next one: jitted
      # loops hold model/optimizer states in their closures and live on
      # in jax's executable cache after the section returns.
      import gc
      import jax
      jax.clear_caches()
      gc.collect()


def main():
  if os.environ.get('BENCH_CPU'):
    # Test tier: run on the CPU whatever JAX_PLATFORMS says.
    import jax
    jax.config.update('jax_platforms', 'cpu')
  section = os.environ.get('BENCH_SECTION')
  if section:  # child mode: run the listed sections, normal exit codes.
    _run_sections(section)
    return

  # The parent exits 0 at the deadline with whatever landed; priority
  # ordering drops only the tail metrics when the budget is tight.
  budget = float(os.environ.get('BENCH_BUDGET_S', '1200'))
  names = os.environ.get(
      'BENCH_SECTIONS',
      # graphcast_onedeg_predict (forward-only, memory-light) rides
      # inside the samplers child. The two heavy tails stay last,
      # cheap-first, so a tight budget lands more of them.
      'nano,onedeg,qdeg,nano_sampler,onedeg_sampler,onedeg_rollout30,'
      'graphcast,graphcast_onedeg_predict,graphcast_onedeg,qdeg_sampler'
  ).split(',')
  names = [n.strip() for n in names if n.strip()]
  if os.environ.get('BENCH_SKIP_1DEG'):
    names = [n for n in names if not n.startswith('onedeg')]
  if os.environ.get('BENCH_SKIP_QDEG'):
    names = [n for n in names if n != 'qdeg']
  if not names:
    sys.exit(0)

  # Sections run in as few child processes as possible, with a hard
  # parent-side kill at the shared budget deadline: a hung call cannot
  # be interrupted in-process, and already-printed metrics survive the
  # kill. The near-capacity sections get children of their own, so that
  # no buffer of an earlier section shares the device with them.
  heavy = {'qdeg', 'qdeg_sampler', 'graphcast_onedeg', 'graphcast_qdeg',
           'graphcast_qdeg37', 'graphcast_qdeg_predict',
           'graphcast_qdeg37_predict'}
  groups, cur = [], []
  for n in names:
    if n in heavy:
      if cur:
        groups.append(cur)
      groups.append([n])
      cur = []
    else:
      cur.append(n)
  if cur:
    groups.append(cur)

  # Children's stdout is teed through the parent, which collects every
  # metric line and re-prints ONE compact recap as the very last line,
  # so that a reader of only the end of the output still gets the full
  # name->value map.
  landed = {}

  def _stream_child(pipe):
    for line in pipe:
      sys.stdout.write(line)
      sys.stdout.flush()
      if line.startswith('{'):
        try:
          m = json.loads(line)
          if 'metric' in m and 'value' in m:
            landed[m['metric']] = m['value']
        except ValueError:
          pass

  hard_deadline = _T0 + budget - 10.0
  for group in groups:
    remaining = hard_deadline - time.time()
    if remaining < 20.0:
      print(f'[bench] SKIP group {group}: {remaining:.0f}s to deadline',
            file=sys.stderr)
      continue
    env = dict(os.environ, BENCH_SECTION=','.join(group),
               BENCH_DEADLINE=str(hard_deadline))
    try:
      proc = subprocess.Popen([sys.executable, os.path.abspath(__file__)],
                              env=env, stdout=subprocess.PIPE, text=True)
      reader = threading.Thread(target=_stream_child, args=(proc.stdout,),
                                daemon=True)
      reader.start()
      try:
        rc = proc.wait(timeout=remaining)
        if rc != 0:
          print(f'[bench] child {group} exited rc={rc}', file=sys.stderr)
      except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        print(f'[bench] child {group} hit the deadline; killed '
              f'(metrics printed before the kill still count)',
              file=sys.stderr)
      reader.join(timeout=10)  # pipe EOFs once the child is gone
    except Exception as e:  # noqa: BLE001 - never fail the driver run
      print(f'[bench] child {group} failed: {e}', file=sys.stderr)
  if landed:
    print(json.dumps({'metric': 'bench_recap', 'value': float(len(landed)),
                      'unit': 'metrics_landed', 'vs_baseline': None,
                      'metrics': landed}))
    sys.stdout.flush()
  sys.exit(0)


if __name__ == '__main__':
  main()
