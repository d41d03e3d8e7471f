#!/usr/bin/env python3
"""Runs the main paths once on one GPU and checks what comes out.

    python chip_smoke.py          # one card
    python chip_smoke.py --four   # four cards: ensemble forecast and
                                  # data-parallel training vs one card

One card, in order:
  1. kernel check: the block-sparse attention kernel, compiled for the
     card, forward and gradients, bf16 and f32, at the 1-degree (10,242
     mesh nodes) and 0.25-degree (40,962) k-hop masks, against dense
     masked attention in float32 at matmul precision "highest" (every
     query row at 1 degree, 12,288 of them at 0.25 degrees); then its time
     beside XLA's tri-block attention at 1 degree;
  2. GenCast train at 1 degree: three optimizer steps through
     `train.main` (published widths, synthetic data, bf16);
  3. GenCast forecast at 1 degree: one 20-level DPM-Solver++ 2S step
     through `evaluate.main`, one member;
  4. model check at 1 degree: one denoiser forward on the production
     path (kernel attention, bf16) and in f32, against the same weights on
     XLA's tri-block path in f32 at "highest";
  5. GraphCast train at 1 degree: two steps through `train.main`.

Weights are random, from fixed seeds. Any failed check raises: the
script then exits non-zero and never prints its last line, which is
  {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}
It refuses to run (non-zero exit, no result) when JAX finds no GPU.
"""

import argparse
import functools
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

KHOP = 16        # k-hop of the 1-degree and 0.25-degree presets
HEADS = 4
HEAD_DIM = 128   # d_model 512 / 4 heads
# Largest |kernel - reference| allowed, as a fraction of max |reference|.
# f32: every dot asks for Precision.HIGHEST (IEEE f32 products, no TF32)
# and sums of ~10^3 terms round at ~1e-6 of their magnitude, so 2e-5
# leaves an order of magnitude of headroom while still catching a dot
# that silently ran in TF32 (~1e-3). bf16: operands carry 8 mantissa bits
# (relative rounding 2^-9 = 2e-3 per operand, on q, k, v, the
# probabilities and the cotangent) with f32 accumulation; 3e-2 is the
# bound the interpret-mode tests hold the same kernel to.
KERNEL_TOL = {'float32': 2e-5, 'bfloat16': 3e-2}
# Denoiser forward vs the tri-block f32 path, as a fraction of max |ref|:
# the f32 kernel path differs only by summation order across 16 layers
# and the GNNs (1e-4); bf16 compute rounds every activation and weight
# to 8 mantissa bits through ~40 matmul layers (5e-2).
MODEL_TOL = {'float32': 1e-4, 'bfloat16': 5e-2}


def log(*args):
  print(*args, flush=True)


def device_summary():
  import jax
  devs = jax.devices()
  return {'platform': devs[0].platform, 'kind': devs[0].device_kind,
          'count': len(devs)}


def print_header():
  import jax
  from gencast_tpu import CACHE_DIR
  d = device_summary()
  log(f"platform={d['platform']} device_kind={d['kind']} "
      f"count={d['count']}")
  smi = subprocess.run(
      ['nvidia-smi', '--query-gpu=name,power.limit',
       '--format=csv,noheader'], capture_output=True, text=True,
      check=True).stdout.strip()
  log(smi)
  log(f'jax={jax.__version__} XLA_FLAGS={os.environ.get("XLA_FLAGS", "")!r}'
      f' compile_cache='
      f'{os.environ.get("JAX_COMPILATION_CACHE_DIR") or CACHE_DIR}')
  return smi.splitlines()[0]


def peak_memory():
  import jax
  stats = jax.devices()[0].memory_stats() or {}
  return stats.get('peak_bytes_in_use', 0) / 2**30


def time_call(f, *args, reps=10):
  """Median seconds of f(*args) after one warm-up call."""
  import jax
  jax.block_until_ready(f(*args))
  times = []
  for _ in range(reps):
    t = time.perf_counter()
    jax.block_until_ready(f(*args))
    times.append(time.perf_counter() - t)
  return statistics.median(times)


# ---------------------------------------------------------------------------
# 1. Kernel check.
# ---------------------------------------------------------------------------


def mesh_attention_mask(mesh_splits, k_hop):
  """The preset's k-hop mask on the RCM-ordered mesh (scipy CSR)."""
  from gencast_tpu.graph import compiler, icosahedron
  mesh, _ = compiler.rcm_permute(icosahedron.mesh_hierarchy(mesh_splits)[-1])
  senders, receivers = icosahedron.faces_to_edges(mesh.faces)
  return compiler.khop_mask_csr(senders, receivers, mesh.num_vertices,
                                k_hop)


def dense_reference(q, k, v, mask, chunk, rows=None):
  """Masked softmax attention in f32 at precision 'highest' for the query
  `rows` (default: all), streamed over query chunks (each chunk
  rematerialised in the backward), so that the logits never exist at
  once. q/k/v [B, N, H, d]; mask [len(rows), N] -> [B, len(rows), H, d]."""
  import jax
  import jax.numpy as jnp
  hi = jax.lax.Precision.HIGHEST
  if rows is not None:
    q = q[:, rows]
  b, n, h, d = q.shape
  nc = -(-n // chunk)
  pad = nc * chunk - n
  qs = jnp.pad(q, ((0, 0), (0, pad), (0, 0), (0, 0)))
  qs = qs.reshape(b, nc, chunk, h, d).swapaxes(0, 1)
  ms = jnp.pad(mask, ((0, pad), (0, 0))).reshape(nc, chunk, -1)

  @jax.checkpoint
  def block(qc, mc):
    s = jnp.einsum('bqhd,bkhd->bhqk', qc, k, precision=hi) * d ** -0.5
    s = jnp.where(mc[None, None], s, -1e30)
    p = jax.nn.softmax(s, axis=-1)
    return jnp.einsum('bhqk,bkhd->bqhd', p, v, precision=hi)

  out = jax.lax.map(lambda a: block(*a), (qs, ms))
  return out.swapaxes(0, 1).reshape(b, nc * chunk, h, d)[:, :n]


def kernel_check(label, csr, tile, *, heads=HEADS, head_dim=HEAD_DIM,
                 chunk=512, max_rows=12288, interpret=False):
  """Kernel vs dense reference, forward and q/k/v gradients, both dtypes.

  Up to `max_rows` query rows are checked (all of them at 1 degree; an
  even sample at 0.25 degrees, where the dense reference would be
  N^2-sized). The cotangent is zero outside the checked rows, so the
  kernel's full dq, dk and dv must match the reference's exactly as they
  stand: every key a checked row attends to is covered. Returns the
  plan."""
  import jax
  import jax.numpy as jnp
  from gencast_tpu.ops import sparse_attention as sa

  n = csr.shape[0]
  plan = sa.build_tile_plan(csr, tile=tile)
  arrs = plan.device_arrays()
  rows = np.unique(np.linspace(0, n - 1, min(n, max_rows)).astype(int))
  mask = jnp.asarray(csr[rows].toarray())
  log(f'[kernel] {label}: N={n} tile={tile} active pairs='
      f'{int(plan.fwd_counts.sum())} of {plan.num_q_tiles ** 2} '
      f'(max {plan.num_active_fwd} per q tile); checking {rows.size} '
      f'query rows')
  ks = jax.random.split(jax.random.PRNGKey(n), 4)
  q, k, v, cot = (jax.random.normal(kk, (1, n, heads, head_dim))
                  for kk in ks)
  cot = jnp.zeros_like(cot).at[:, rows].set(cot[:, rows])

  @jax.jit
  def ref_vjp(q, k, v, cot):
    with jax.default_matmul_precision('highest'):
      out, vjp = jax.vjp(
          lambda *x: dense_reference(*x, mask, chunk, rows), q, k, v)
      return (out,) + vjp(cot[:, rows])

  @jax.jit
  def kernel_vjp(q, k, v, cot):
    out, vjp = jax.vjp(
        lambda *x: sa.sparse_banded_attention(*x, arrs, tile, interpret),
        q, k, v)
    return (out[:, rows],) + vjp(cot.astype(out.dtype))

  for dtype in (jnp.bfloat16, jnp.float32):
    xs = [x.astype(dtype) for x in (q, k, v, cot)]
    got = kernel_vjp(*xs)
    want = ref_vjp(*(x.astype(jnp.float32) for x in xs))
    name = jnp.dtype(dtype).name
    tol = KERNEL_TOL[name]
    for what, a, r in zip(('out', 'dq', 'dk', 'dv'), got, want):
      a = np.asarray(a.astype(jnp.float32))
      r = np.asarray(r)
      assert a.shape == r.shape, (what, a.shape, r.shape)
      assert np.isfinite(a).all(), f'{label} {name} {what}: non-finite'
      err = float(np.abs(a - r).max() / np.abs(r).max())
      log(f'[kernel] {label} {name} {what}: max|err|/max|ref| = '
          f'{err:.3e} (tolerance {tol:.0e})')
      assert err <= tol, f'{label} {name} {what}: {err} > {tol}'
  return plan


def kernel_timings(plan, csr, card, *, heads=HEADS, head_dim=HEAD_DIM):
  """Kernel vs XLA's tri-block attention at one width, bf16, forward and
  forward+backward (median of 10 after warm-up). tools/kernel_decisions.py
  adds cuDNN's fused attention and the end-to-end steps."""
  import jax
  import jax.numpy as jnp
  from gencast_tpu.graph import compiler
  from gencast_tpu.nn import transformer
  from gencast_tpu.ops import sparse_attention as sa

  n = csr.shape[0]
  banded = compiler._banded_mask_from_csr(csr)
  blocks = jnp.asarray(banded.blocks)
  np_tri = banded.num_blocks * banded.block_size
  arrs = plan.device_arrays()
  ks = jax.random.split(jax.random.PRNGKey(0), 4)
  q, k, v, cot = (jax.random.normal(kk, (1, n, heads, head_dim),
                                    jnp.bfloat16) for kk in ks)

  def pad(x):
    return jnp.pad(x, ((0, 0), (0, np_tri - n), (0, 0), (0, 0)))

  backends = {
      'kernel': lambda q, k, v: sa.sparse_banded_attention(
          q, k, v, arrs, plan.tile),
      'xla_triblock': lambda q, k, v: transformer.triblock_attention(
          pad(q), pad(k), pad(v), blocks, banded.block_size)[:, :n],
  }
  for name, f in backends.items():
    fwd = jax.jit(f)
    fwd_bwd = jax.jit(lambda q, k, v, f=f: jax.vjp(f, q, k, v)[1](cot))
    t_f = time_call(fwd, q, k, v)
    t_fb = time_call(fwd_bwd, q, k, v)
    log(f'[kernel-time] {name} N={n} bf16 heads={heads} d={head_dim}: '
        f'fwd {t_f * 1e3:.3f} ms, fwd+bwd {t_fb * 1e3:.3f} ms  ({card})')


# ---------------------------------------------------------------------------
# 2, 3, 5. Training and forecasting through the CLIs.
# ---------------------------------------------------------------------------


def param_arrays(module):
  """A module's parameters as host arrays, in traversal order, each with
  its path."""
  import jax
  from gencast_tpu.nn import nnx
  flat = nnx.state(module, nnx.Param).flat_state()
  return [(path, np.asarray(jax.device_get(v.value))) for path, v in flat]


def initial_params(argv):
  """The parameters `train.main(argv)` starts from: the same model built
  from the same seed."""
  from gencast_tpu import configs
  from gencast_tpu.nn import nnx
  from gencast_tpu.training import train
  args = train.parse_args(argv)
  spec = train.build_spec(args)
  if args.model == 'graphcast':
    model, _ = configs.build_graphcast(spec, rngs=nnx.Rngs(args.seed),
                                       remat_group=args.remat_group)
  else:
    model, _ = configs.build_gencast(spec, rngs=nnx.Rngs(args.seed))
  return param_arrays(model)


def param_updates(before, run):
  """Trained minus initial parameters, one array each. The trained model
  sits inside the wrapper stack, which adds a prefix to every path."""
  after = param_arrays(run['model'])
  assert len(after) == len(before), (len(after), len(before))
  deltas = []
  for (p0, a0), (p1, a1) in zip(before, after):
    assert p1[len(p1) - len(p0):] == p0, (p0, p1)
    deltas.append(a1.astype(np.float32) - a0.astype(np.float32))
  return deltas


def train_check(label, argv):
  from gencast_tpu.training import train
  before = initial_params(argv)
  t = time.time()
  run = train.main(argv)
  losses = run['losses']
  log(f'[{label}] losses {losses} in {time.time() - t:.1f}s '
      f'(compile included)')
  assert losses and all(np.isfinite(losses)), f'{label}: losses {losses}'
  moved = sum(bool(np.any(d != 0)) for d in param_updates(before, run))
  log(f'[{label}] parameters changed: {moved} of {len(before)} arrays; '
      f'peak device memory {peak_memory():.2f} GiB')
  assert moved > len(before) // 2, f'{label}: only {moved} arrays moved'
  return run


def forecast_check(argv):
  """Predictions must be finite wherever the truth is: sea-surface
  temperature is NaN over land in the data, and the residual wrapper
  carries that mask into the forecast."""
  from gencast_tpu.training import evaluate
  t = time.time()
  out = evaluate.main(argv)
  preds, truth = out['predictions'], out['truth']
  log(f'[forecast] predictions {preds.shape} in {time.time() - t:.1f}s '
      f'(compile included); peak device memory {peak_memory():.2f} GiB; '
      f'{int(np.isnan(preds).sum())} NaN values where the truth has '
      f'{int(np.isnan(truth).sum())}')
  assert preds.shape[:2] == (1, 1), preds.shape
  assert (np.isfinite(preds) | np.isnan(truth)[None]).all(), \
      'forecast: non-finite predictions where the truth is finite'


# ---------------------------------------------------------------------------
# 4. Model check.
# ---------------------------------------------------------------------------


def model_check(spec, tile):
  """Denoiser forward: kernel attention (bf16 compute, and f32) vs the
  same weights on the tri-block path in f32 at 'highest'."""
  import dataclasses

  import jax
  import jax.numpy as jnp
  from gencast_tpu import configs
  from gencast_tpu.graph import compiler
  from gencast_tpu.models import casting
  from gencast_tpu.nn import nnx

  lat, lon = configs.grid_for_resolution(spec.resolution_deg)
  statics = compiler.build_graph_statics(
      spec.mesh_splits, lat, lon, attention_k_hop=spec.attention_k_hop,
      attention_tile_size=tile, build_triblock_mask=True,
      cache_dir=configs.DEFAULT_CACHE_DIR)

  def build(attention_type):
    s = dataclasses.replace(spec, attention_type=attention_type)
    model, _ = configs.build_gencast(s, statics=statics, rngs=nnx.Rngs(0))
    return model

  prod = build('pallas')
  ref = build('triblock')
  nnx.update(ref, nnx.state(prod, nnx.Param))
  d = prod.denoiser
  rng = np.random.default_rng(0)
  nlat, nlon = lat.size, lon.size

  def arr(c):
    return jnp.asarray(rng.standard_normal((1, nlat, nlon, c)), jnp.float32)

  inputs = arr(d.input_layout.num_channels)
  noisy = arr(d.target_layout.num_channels)
  forcings = arr(d.forcing_layout.num_channels)
  sigma = jnp.asarray([1.0], jnp.float32)

  def run(model, dtype):
    den = model.denoiser
    if dtype == jnp.bfloat16:
      den = casting.cast_params(den)
    return jax.jit(lambda *a: den(*a).astype(jnp.float32))(
        *(x.astype(dtype) for x in (inputs, noisy)), sigma,
        forcings.astype(dtype))

  with jax.default_matmul_precision('highest'):
    want = np.asarray(run(ref, jnp.float32))
    # f32 production path at 'highest' too, so that only the attention
    # backend differs; bf16 runs as in production.
    got32 = np.asarray(run(prod, jnp.float32))
  for dtype in (jnp.bfloat16, jnp.float32):
    got = (np.asarray(run(prod, dtype)) if dtype == jnp.bfloat16
           else got32)
    name = jnp.dtype(dtype).name
    assert got.shape == want.shape and np.isfinite(got).all(), name
    err = float(np.abs(got - want).max() / np.abs(want).max())
    rms = float(np.sqrt(np.mean((got - want) ** 2) / np.mean(want ** 2)))
    tol = MODEL_TOL[name]
    log(f'[model] {spec.name} denoiser {name} kernel path vs f32 '
        f'tri-block: max|err|/max|ref| = {err:.3e} (tolerance {tol:.0e}),'
        f' relative rms {rms:.3e}')
    assert err <= tol, f'model {name}: {err} > {tol}'


# ---------------------------------------------------------------------------
# Four cards.
# ---------------------------------------------------------------------------


def _on_all(arrays, n):
  import jax
  leaves = [x for x in jax.tree.leaves(arrays) if isinstance(x, jax.Array)]
  bad = [x.shape for x in leaves if len(x.sharding.device_set) != n]
  assert leaves and not bad, f'{len(bad)} arrays not on all {n} devices'


def one_card_members(preset, members, steps):
  """The pod CLI's forecast (same model seed, data and member keys) run
  member by member on the first device alone: [members, K, B, ...]."""
  import jax
  from gencast_tpu import configs
  from gencast_tpu.data import sources
  from gencast_tpu.models import wrappers
  from gencast_tpu.nn import nnx
  from gencast_tpu.parallel import ensemble, meshes

  spec = configs.SPECS[preset]
  model, statics = configs.build_gencast(spec, rngs=nnx.Rngs(0))
  source = sources.SyntheticSource(model.task, statics.grid_lat,
                                   statics.grid_lon, num_times=steps + 4)
  wrapped = wrappers.build_stack(model, sources.compute_stats(source),
                                 bf16=spec.cast_bf16, clean_sst_nans=True)
  mesh = meshes.make_mesh(devices=jax.devices()[:1])
  meshes.shard_model(wrapped, mesh)
  w = source.sample(0, num_target_frames=steps)
  repl = meshes.replicated(mesh)
  inputs = jax.device_put(np.asarray(w.inputs)[None], repl)
  forcings = jax.device_put(np.asarray(w.forcings)[:, None], repl)
  keys = ensemble.member_keys(jax.random.PRNGKey(0), members)
  run = ensemble.make_ensemble_rollout(wrapped, mesh=mesh)
  return np.concatenate([np.asarray(run(inputs, forcings, keys[m:m + 1]))
                         for m in range(members)])


def four_cards(tmp, preset='1deg'):
  """Ensemble forecast over every device and --dp 4 training, each
  against the same work on one card."""
  import importlib.util

  import jax
  from gencast_tpu.nn import nnx

  n_dev = len(jax.devices())
  assert n_dev >= 4, 'the --four phase needs four GPUs'
  spec_ = importlib.util.spec_from_file_location(
      'ensemble_forecast_pod', os.path.join(os.path.dirname(
          os.path.abspath(__file__)), 'scripts', 'ensemble_forecast_pod.py'))
  pod = importlib.util.module_from_spec(spec_)
  spec_.loader.exec_module(pod)
  t = time.time()
  run = pod.main(['--preset', preset, '--members', '4', '--steps', '2',
                  '--clean_sst_nans', '--out', os.path.join(tmp, 'pod.npz')])
  log(f'[four] pod CLI on {n_dev} devices: {time.time() - t:.1f}s '
      f'(compile included)')
  assert len(run['sharding'].device_set) == n_dev, run['sharding']
  t = time.time()
  a, b = run['predictions'], one_card_members(preset, 4, 2)
  log(f'[four] the same members on one card: {time.time() - t:.1f}s '
      f'(compile included)')
  assert a.shape == b.shape and a.shape[0] == 4, (a.shape, b.shape)
  for m in range(4):
    # NaN only where the data is NaN (sea-surface temperature over land),
    # and in both runs alike.
    assert (np.isnan(a[m]) == np.isnan(b[m])).all(), f'member {m}: NaNs'
    assert np.isfinite(b[m]).mean() > 0.9, f'member {m}: mostly NaN'
    err = float(np.nanmax(np.abs(a[m] - b[m])) / np.nanmax(np.abs(b[m])))
    log(f'[four] member {m}: {n_dev} devices vs one card max|err|/max|ref| = '
        f'{err:.3e} (tolerance {FOUR_TOL["member"]:.0e})')
    assert err <= FOUR_TOL['member'], f'member {m}: {err}'

  from gencast_tpu.training import train
  argv = ['--preset', preset, '--data', 'synthetic', '--steps', '2',
          '--batch_size', '4', '--log_every', '1', '--prefetch', '0',
          '--clean_sst_nans']
  start = initial_params(argv)
  dp = train.main(argv + ['--dp', '4'])
  _on_all(nnx.state(dp['model'], nnx.Param), 4)
  one = train.main(argv)
  for i, (x, y) in enumerate(zip(dp['losses'], one['losses'])):
    err = abs(x - y) / abs(y)
    log(f'[four] train step {i}: loss dp=4 {x:.6f} vs one card {y:.6f}, '
        f'relative {err:.3e} (tolerance {FOUR_TOL["loss"]:.0e})')
    assert err <= FOUR_TOL['loss'], (i, x, y)

  def moved(run):
    return np.concatenate([np.ravel(d) for d in param_updates(start, run)])

  da, db = moved(dp), moved(one)
  err = float(np.linalg.norm(da - db) / np.linalg.norm(db))
  log(f'[four] parameter update dp=4 vs one card: |diff|/|update| = '
      f'{err:.3e} (tolerance {FOUR_TOL["update"]:.0e})')
  assert err <= FOUR_TOL['update'], err


# Four-card tolerances. Members: each member's 2-step, 20-level sampler
# runs whole on one card in both runs; only XLA's per-program choices of
# bf16 kernels differ, and the sampler carries those roundings (2^-9
# relative) through 78 denoiser calls, so 2e-2 of max |ref|. Loss: the
# batch-4 bf16 loss summed over shards in another order, 1e-3 relative.
# Update: AdamW's first nonzero-lr step moves each parameter by about the
# learning rate times the sign of its gradient; parameters whose bf16
# gradients sit near zero can flip sign, so the two updates may differ in
# a few per cent of their norm (1e-1).
FOUR_TOL = {'member': 2e-2, 'loss': 1e-3, 'update': 1e-1}


# ---------------------------------------------------------------------------


def main(argv=None):
  p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  p.add_argument('--four', action='store_true',
                 help='run only the four-card comparisons')
  args = p.parse_args(argv)

  import jax
  if jax.devices()[0].platform != 'gpu':
    print(f'chip_smoke: needs a GPU, JAX found '
          f'{jax.devices()[0].platform!r}', file=sys.stderr)
    return 1
  card = print_header()
  tmp = tempfile.mkdtemp(prefix='chip_smoke_')

  if args.four:
    four_cards(tmp)
  else:
    from gencast_tpu import configs
    from gencast_tpu.ops import sparse_attention as sa
    # The 1-degree data holds NaN sea-surface temperature over land, as
    # ERA5 does: the CLIs run with --clean_sst_nans, as users run them.
    t = time.time()
    for label, splits in (('1deg', 5), ('0.25deg', 6)):
      csr = mesh_attention_mask(splits, KHOP)
      plan = kernel_check(label, csr, sa.TILE)
      if splits == 5:
        kernel_timings(plan, csr, card)
      del plan, csr
    log(f'[phase] kernels {time.time() - t:.1f}s')
    t = time.time()
    train_check('train 1deg', ['--preset', '1deg', '--data', 'synthetic',
                               '--steps', '3', '--log_every', '1',
                               '--prefetch', '0', '--clean_sst_nans'])
    log(f'[phase] train {time.time() - t:.1f}s')
    t = time.time()
    forecast_check(['--preset', '1deg', '--data', 'synthetic',
                    '--max_rollout_steps', '1', '--num_members', '1',
                    '--out_dir', os.path.join(tmp, 'eval'),
                    '--plot_vars', '--clean_sst_nans'])
    log(f'[phase] forecast {time.time() - t:.1f}s')
    t = time.time()
    model_check(configs.ONE_DEG, sa.TILE)
    log(f'[phase] model check {time.time() - t:.1f}s')
    t = time.time()
    train_check('graphcast 1deg', ['--model', 'graphcast', '--preset',
                                   '1deg', '--data', 'synthetic',
                                   '--steps', '2', '--log_every', '1',
                                   '--prefetch', '0', '--clean_sst_nans'])
    log(f'[phase] graphcast train {time.time() - t:.1f}s')

  print(json.dumps({'ok': True, 'device': device_summary()}), flush=True)
  return 0


if __name__ == '__main__':
  sys.exit(main())
