"""Evaluation CLI: restore a checkpoint, run an AR rollout, score and plot.

Equivalent of the reference's training/evaluation.py: rebuilds the model
from flags, restores the checkpoint (no ad-hoc state cleaning needed — the
checkpoint schema matches construction exactly), runs a (teacher-forced or
free-running) autoregressive rollout, and writes per-variable RMSE, packed
.npz outputs, PNG triptychs and a GIF.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict

import numpy as np


def parse_args(argv=None):
  p = argparse.ArgumentParser(description='Evaluate GenCast or GraphCast.')
  p.add_argument('--model', default='gencast',
                 choices=['gencast', 'graphcast'])
  p.add_argument('--preset', default='nano',
                 choices=['tiny', 'nano', '1deg', '0.25deg'])
  p.add_argument('--data', default='synthetic')
  p.add_argument('--ckpt_dir', default=None, required=False)
  p.add_argument('--out_dir', default='/tmp/gencast_eval')
  p.add_argument('--max_rollout_steps', type=int, default=4)
  p.add_argument('--num_members', type=int, default=1)
  p.add_argument('--chunk_size', type=int, default=None,
                 help='rollout in fixed-size jitted chunks with per-chunk '
                      'host offload (memory-safe long forecasts; exact '
                      'vs unchunked for any value). Required at 0.25deg.')
  p.add_argument('--member_chunk', type=int, default=None,
                 help='run ensemble members in groups of this size, '
                      'offloading each group to host (memory-safe large '
                      'ensembles; exact vs one-shot by the folded member '
                      'keys).')
  p.add_argument('--no_overlap_offload', action='store_true',
                 help='serialize device compute and host copies during '
                      'chunked rollouts')
  p.add_argument('--teacher_forcing', action='store_true')
  p.add_argument('--bf16', action=argparse.BooleanOptionalAction,
                 default=None,
                 help='bf16 compute with f32 master weights '
                      '(default: the preset decides; --no-bf16 forces f32)')
  p.add_argument('--save_netcdf', action='store_true',
                 help='write the ensemble-mean rollout (+ matching '
                      'targets) as compressed NetCDF4 (h5py dimension-'
                      'scale writer; no xarray needed). Skipped with a '
                      'warning if h5py is unavailable.')
  p.add_argument('--plot_vars', nargs='*',
                 default=['2m_temperature'])
  p.add_argument('--seed', type=int, default=0)
  p.add_argument('--no_normalization', action='store_true')
  p.add_argument('--clean_sst_nans', action='store_true')
  p.add_argument('--stats_path', default=None)
  # Architecture overrides, mirroring train.py.
  p.add_argument('--mesh_size', type=int, default=None)
  p.add_argument('--d_model', type=int, default=None)
  p.add_argument('--num_layers', type=int, default=None)
  p.add_argument('--num_heads', type=int, default=None)
  p.add_argument('--attention_k_hop', type=int, default=None)
  p.add_argument('--attention_type', default=None)
  return p.parse_args(argv)


def per_variable_rmse(preds: np.ndarray, truth: np.ndarray,
                      layout) -> Dict[str, float]:
  out = {}
  for name in layout.var_names:
    ch = layout.var_channels(name)
    d = preds[..., ch] - truth[..., ch]
    out[name] = float(np.sqrt(np.nanmean(d ** 2)))
  return out


def main(argv=None):
  args = parse_args(argv)

  from gencast_tpu.nn import nnx
  import jax
  import jax.numpy as jnp

  from gencast_tpu import configs, rollout as rollout_lib
  from gencast_tpu.data import sources
  from gencast_tpu.models import wrappers
  from gencast_tpu.training import plotting
  from gencast_tpu.training.train import build_spec

  spec = build_spec(args)
  if args.model == 'graphcast':
    model, statics = configs.build_graphcast(spec, rngs=nnx.Rngs(args.seed))
  else:
    model, statics = configs.build_gencast(spec, rngs=nnx.Rngs(args.seed))

  task = model.task
  if args.data == 'synthetic':
    source = sources.SyntheticSource(
        task, statics.grid_lat, statics.grid_lon,
        num_times=args.max_rollout_steps + task.num_input_frames + 2,
        seed=args.seed + 1)
  else:
    import glob as _glob
    if _glob.glob(os.path.join(args.data, 'era5_pressure_levels_*.nc')):
      from gencast_tpu.data import era5_netcdf
      source = era5_netcdf.Era5NetCDFSource(args.data, task,
                                            resolution_deg=spec.resolution_deg)
    else:
      source = sources.Era5NpzSource(args.data, task)

  if args.stats_path and os.path.exists(args.stats_path):
    # A directory means DeepMind's published NetCDF stats files.
    stats = sources.load_stats_auto(args.stats_path, task.pressure_levels)
  else:
    stats = sources.compute_stats(source)

  # Canonical wrapper stack, shared with train.py (checkpoint trees
  # depend on the nesting).
  bf16 = args.bf16 or (args.bf16 is None and spec.cast_bf16)
  if bf16:
    print('[eval] bf16 compute enabled')
  wrapped = wrappers.build_stack(model, stats, bf16=bf16,
                                 clean_sst_nans=args.clean_sst_nans,
                                 normalize=not args.no_normalization)

  if args.ckpt_dir:
    from gencast_tpu.training import checkpoint as ckpt_lib
    manager = ckpt_lib.create_manager(args.ckpt_dir)
    step = ckpt_lib.restore(manager, wrapped)
    print(f'[eval] restored checkpoint step {step}')
  else:
    print('[eval] WARNING: no checkpoint, evaluating untrained weights')

  k = args.max_rollout_steps
  w = source.sample(0, num_target_frames=k)
  # sample() returns unstacked [lat, lon, C] for a single target frame.
  w_targets = w.targets if k > 1 else w.targets[None]
  w_forcings = w.forcings if k > 1 else w.forcings[None]
  inputs = jnp.asarray(w.inputs)[None]
  forcings = jnp.asarray(w_forcings)[:, None]      # [K, B=1, ...]
  truth = np.asarray(w_targets)                    # [K, lat, lon, C]
  teacher = (jnp.asarray(w_targets)[:, None] if args.teacher_forcing
             else None)

  key = jax.random.PRNGKey(args.seed)
  if args.model == 'graphcast':
    if args.chunk_size:
      preds = rollout_lib.chunked_rollout(
          wrapped, inputs, forcings, key, chunk_size=args.chunk_size,
          mode='predict', teacher_targets=teacher,
          overlap_offload=not args.no_overlap_offload)
    else:
      preds = np.asarray(rollout_lib.predict_rollout(
          wrapped, inputs, forcings, teacher_targets=teacher))
    preds = preds[:, 0][None]                # [M=1, K, lat, lon, C]
  else:
    from gencast_tpu.parallel import ensemble as ensemble_lib
    mkeys = ensemble_lib.member_keys(key, args.num_members)
    if args.chunk_size:
      # Memory-safe on both axes: members stream one at a time, each
      # through the chunked rollout (exact vs the one-shot path — the
      # folded member keys and the global split(key, K) step keys are
      # both independent of the chunking).
      groups = [rollout_lib.chunked_rollout(
                    wrapped, inputs, forcings, mkeys[i],
                    chunk_size=args.chunk_size, teacher_targets=teacher,
                    overlap_offload=not args.no_overlap_offload)[None]
                for i in range(args.num_members)]
    elif args.member_chunk:
      # One jitted program reused across chunks (a fresh ensemble_rollout
      # call per chunk would re-trace + re-compile each time).
      mc = args.member_chunk
      run = ensemble_lib.make_ensemble_rollout(wrapped,
                                               teacher_targets=teacher)
      groups = [np.asarray(run(inputs, forcings, mkeys[lo:lo + mc]))
                for lo in range(0, args.num_members, mc)]
    else:
      # All members in one traced program (vmapped over member keys).
      groups = [np.asarray(ensemble_lib.ensemble_rollout(
          wrapped, inputs, forcings, key, num_members=args.num_members,
          teacher_targets=teacher, keys=mkeys))]
    preds = np.concatenate(groups, axis=0)[:, :, 0]  # [M, K, lat, lon, C]
  ens_mean = preds.mean(axis=0)

  d = model.denoiser if hasattr(model, 'denoiser') else model
  rmse = per_variable_rmse(ens_mean, truth, d.target_layout)
  results = {'rmse': rmse, 'steps': k, 'members': args.num_members}

  if preds.shape[0] > 1:
    # Probabilistic scores (GenCast's headline metrics), streamed over
    # latitude bands so 50-member 0.25-degree ensembles score on one chip.
    from gencast_tpu.data import layout as L
    from gencast_tpu.ops import metrics as metrics_lib
    latw = np.asarray(L.latitude_weights(statics.grid_lat))
    scores = metrics_lib.score_ensemble_chunked(preds, truth, latw)
    crps_pc = scores['crps'].mean(axis=0)
    spread_pc = scores['spread'].mean(axis=0)
    results['crps'] = {k2: float(v) for k2, v in metrics_lib.per_variable(
        crps_pc, d.target_layout).items()}
    results['spread'] = {k2: float(v) for k2, v in metrics_lib.per_variable(
        spread_pc, d.target_layout).items()}

  os.makedirs(args.out_dir, exist_ok=True)
  with open(os.path.join(args.out_dir, 'metrics.json'), 'w') as f:
    json.dump(results, f, indent=2)
  print('[eval] per-variable RMSE:')
  for name, v in rmse.items():
    print(f'  {name}: {v:.4f}')
  if 'crps' in results:
    print('[eval] per-variable CRPS:')
    for name, v in results['crps'].items():
      print(f'  {name}: {v:.4f}')

  np.savez(os.path.join(args.out_dir, 'rollout.npz'),
           predictions=preds, truth=truth,
           lat=statics.grid_lat, lon=statics.grid_lon)

  if args.save_netcdf:
    # The reference's deliverable artifact format (compressed NetCDF of
    # predictions + target_* variables, evaluation.py:194-260).
    try:
      from gencast_tpu.data import netcdf_writer
      nc_path = os.path.join(args.out_dir, 'rollout.nc')
      netcdf_writer.write_forecast(
          nc_path, ens_mean, d.target_layout,
          statics.grid_lat, statics.grid_lon, truth=truth,
          global_attrs={'members': args.num_members, 'steps': k,
                        'rmse_mean': float(np.mean(list(rmse.values())))})
      print(f'[eval] NetCDF rollout written to {nc_path}')
    except ImportError as e:
      print(f'[eval] --save_netcdf skipped: {e}')

  for var in args.plot_vars:
    if var not in d.target_layout.var_names:
      continue
    ch = d.target_layout.var_channels(var)[0]
    plotting.plot_triptych(
        ens_mean[-1, :, :, ch], truth[-1, :, :, ch],
        statics.grid_lat, statics.grid_lon, var,
        os.path.join(args.out_dir, f'triptych_{var}.png'))
    plotting.rollout_gif(
        ens_mean[:, :, :, ch], statics.grid_lat, statics.grid_lon, var,
        os.path.join(args.out_dir, f'rollout_{var}.gif'))
  print(f'[eval] outputs written to {args.out_dir}')
  return {'results': results, 'predictions': preds, 'truth': truth}


if __name__ == '__main__':
  main()
