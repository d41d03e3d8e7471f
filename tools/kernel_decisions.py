#!/usr/bin/env python3
"""Times the attention backends on the GPU, end to end and alone.

For each preset it times the production train step (fwd + bwd + AdamW)
and the one-forecast-step sampler (39 denoiser calls) with the
block-sparse kernel ('pallas') and with XLA's tri-block attention, then
times the attention op alone at the 1-degree and 0.25-degree widths
against cuDNN's fused attention with the dense k-hop mask. With
--trace DIR it also writes a profiler trace of two 1-degree train steps
of each of --trace_models (gencast, graphcast) and a per-kernel summary
(trace_summary.json) beside it.

    python tools/kernel_decisions.py [--presets nano,1deg] [--trace DIR]
        [--trace_models gencast,graphcast] [--no_op]

Every time is the median of several calls after a warm-up, printed with
the card's name and power limit. A backend that fails (out of memory,
refused by cuDNN) prints its error and the others go on.
"""

import argparse
import collections
import dataclasses
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402


def log(*a):
  print(*a, flush=True)


def median_time(f, reps):
  jax.block_until_ready(f())
  ts = []
  for _ in range(reps):
    t = time.perf_counter()
    jax.block_until_ready(f())
    ts.append(time.perf_counter() - t)
  return statistics.median(ts)


def train_step_fixture(spec, model_name='gencast'):
  from gencast_tpu import configs
  from gencast_tpu.models import casting, wrappers
  from gencast_tpu.nn import nnx
  from gencast_tpu.training import steps

  build = (configs.build_graphcast if model_name == 'graphcast'
           else configs.build_gencast)
  model, statics = build(spec, rngs=nnx.Rngs(0))
  if spec.cast_bf16:
    model = casting.Bfloat16Cast(model)
  d = wrappers.find_layout_provider(model)
  shape = (1, statics.grid_lat.size, statics.grid_lon.size)
  ks = jax.random.split(jax.random.PRNGKey(0), 3)
  inputs = jax.random.normal(ks[0], shape + (d.input_layout.num_channels,))
  targets = jax.random.normal(ks[1], shape + (d.target_layout.num_channels,))
  forcings = jax.random.normal(ks[2],
                               shape + (d.forcing_layout.num_channels,))
  opt = steps.create_optimizer(model, steps.OptimizerConfig())
  key = jax.random.PRNGKey(3)
  return lambda: steps.train_step(model, opt, inputs, targets, forcings,
                                  key)[0]


def end_to_end(preset, card, sampler):
  from gencast_tpu import configs, utils
  for attn in ('triblock', 'pallas'):
    spec = dataclasses.replace(configs.SPECS[preset], attention_type=attn)
    try:
      t = time.time()
      step = train_step_fixture(spec)
      ms = median_time(step, 5) * 1e3
      log(f'[e2e] {preset} {attn} train step {ms:.2f} ms (set-up + '
          f'compile {time.time() - t:.0f}s)  ({card})')
      del step
      if sampler:
        t = time.time()
        fx = utils.sampler_fixture(spec)
        s = median_time(lambda: fx.sample(fx.state, fx.inputs, fx.forcings,
                                          fx.key), 3)
        log(f'[e2e] {preset} {attn} sampler step {s:.4f} s (set-up + '
            f'compile {time.time() - t:.0f}s)  ({card})')
        del fx
    except Exception as e:  # noqa: BLE001 - report and go on
      log(f'[e2e] {preset} {attn}: failed: {type(e).__name__}: '
          f'{str(e)[:300]}')


def op_alone(card):
  sys.path.insert(0, os.path.dirname(os.path.dirname(
      os.path.abspath(__file__))))
  import chip_smoke
  from gencast_tpu.graph import compiler
  from gencast_tpu.nn import transformer
  from gencast_tpu.ops import sparse_attention as sa

  for label, splits in (('1deg', 5), ('0.25deg', 6)):
    csr = chip_smoke.mesh_attention_mask(splits, chip_smoke.KHOP)
    n = csr.shape[0]
    ks = jax.random.split(jax.random.PRNGKey(0), 4)
    q, k, v, cot = (jax.random.normal(kk, (1, n, 4, 128), jnp.bfloat16)
                    for kk in ks)
    cands = {}
    for tile in (32, 64, 128):
      plan = sa.build_tile_plan(csr, tile=tile)
      cands[f'kernel_tile{tile}'] = (
          lambda q, k, v, a=plan.device_arrays(), t=tile:
          sa.sparse_banded_attention(q, k, v, a, t))
    banded = compiler._banded_mask_from_csr(csr)
    np_tri = banded.num_blocks * banded.block_size
    tri_bytes = 3 * np_tri * banded.block_size * 4 * 4
    log(f'[op] {label}: tri-block block_size={banded.block_size}, one '
        f'layer of f32 logits {tri_bytes / 2**30:.2f} GiB')
    blocks = jnp.asarray(banded.blocks)
    pad = lambda x: jnp.pad(x, ((0, 0), (0, np_tri - n), (0, 0), (0, 0)))
    cands['xla_triblock'] = lambda q, k, v: transformer.triblock_attention(
        pad(q), pad(k), pad(v), blocks, banded.block_size)[:, :n]
    mask = jnp.asarray(csr.toarray())[None, None]
    cands['cudnn_dense'] = lambda q, k, v: jax.nn.dot_product_attention(
        q, k, v, mask=mask, implementation='cudnn')
    for name, f in cands.items():
      try:
        fwd = jax.jit(f)
        fb = jax.jit(lambda q, k, v, f=f: jax.vjp(f, q, k, v)[1](cot))
        tf = median_time(lambda: fwd(q, k, v), 10) * 1e3
        tfb = median_time(lambda: fb(q, k, v), 10) * 1e3
        log(f'[op] {label} N={n} {name}: fwd {tf:.3f} ms, fwd+bwd '
            f'{tfb:.3f} ms  ({card})')
      except Exception as e:  # noqa: BLE001 - report and go on
        log(f'[op] {label} {name}: failed: {type(e).__name__}: '
            f'{str(e)[:300]}')
    del cands, mask, blocks


def trace_train(out_dir, card, model_name):
  """Profiler trace of two 1-degree train steps and a per-kernel table.

  Run with XLA_FLAGS=--xla_gpu_enable_command_buffer= to keep XLA from
  folding kernels into CUDA graphs, so that each kernel event carries its
  HLO op and the op's name scope (e.g. segment_sum_g2m)."""
  from gencast_tpu import configs
  out_dir = os.path.join(out_dir, model_name)
  step = train_step_fixture(configs.ONE_DEG, model_name)
  for _ in range(3):
    jax.block_until_ready(step())
  jax.profiler.start_trace(out_dir)
  for _ in range(2):
    jax.block_until_ready(step())
  jax.profiler.stop_trace()
  path = None
  for root, _, files in os.walk(out_dir):
    for f in files:
      if f.endswith('.xplane.pb'):
        path = os.path.join(root, f)
  data = jax.profiler.ProfileData.from_file(path)
  kernels = collections.defaultdict(lambda: [0, 0.0, ''])
  for plane in data.planes:
    if not plane.name.startswith('/device:GPU'):
      continue
    for line in plane.lines:
      for ev in line.events:
        stats = {k: str(v) for k, v in ev.stats}
        scope = ' '.join(stats.get(k, '') for k in ('hlo_op', 'tf_op'))
        entry = kernels[(line.name, ev.name)]
        entry[0] += 1
        entry[1] += ev.duration_ns / 1e6
        entry[2] = scope[:1000]
  rows = sorted(([ln, name, c, ms, scope]
                 for (ln, name), (c, ms, scope) in kernels.items()),
                key=lambda r: -r[3])
  with open(os.path.join(out_dir, 'trace_summary.json'), 'w') as f:
    json.dump({'card': card, 'steps': 2, 'kernels': rows}, f)
  shutil.rmtree(os.path.join(out_dir, 'plugins'))  # keep the summary only
  log(f'[trace] {len(rows)} kernels, summary in {out_dir}/trace_summary.json')
  for r in rows[:15]:
    log(f'[trace] {r[3] / 2:.3f} ms/step  x{r[2] // 2}  {r[1][:60]}  '
        f'{r[4][:120]}')


def main():
  p = argparse.ArgumentParser()
  p.add_argument('--presets', default='nano,1deg')
  p.add_argument('--sampler', default='1deg',
                 help='presets whose sampler step is timed too')
  p.add_argument('--no_op', action='store_true')
  p.add_argument('--trace', default=None)
  p.add_argument('--trace_models', default='gencast')
  args = p.parse_args()
  if jax.devices()[0].platform != 'gpu':
    sys.exit('kernel_decisions: needs a GPU')
  card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                         '--format=csv,noheader'], capture_output=True,
                        text=True, check=True).stdout.splitlines()[0]
  log(card)
  if not args.no_op:
    op_alone(card)
  for preset in filter(None, args.presets.split(',')):
    end_to_end(preset, card, preset in args.sampler.split(','))
  if args.trace:
    for model_name in args.trace_models.split(','):
      trace_train(args.trace, card, model_name)


if __name__ == '__main__':
  main()
