#!/usr/bin/env python
"""Ensemble forecast: many members x many steps over all devices.

Run with one process per host (multi-host jax.distributed); members
shard over the 'ensemble' mesh axis, any leftover device factor becomes
tensor parallelism over 'model'. On one four-card host:

  python scripts/ensemble_forecast_pod.py --preset 1deg \
      --ckpt_dir /ckpt/1deg --data /data/era5 --members 50 --steps 30

Member count need not match the device count: members are padded up to a
multiple of the ensemble axis and run in chunks, each chunk one traced
program (the padded members' samples are computed and discarded; every
kept member's stream depends only on fold_in(key, member_id), so results
are independent of the chunking/device count).

--score computes CRPS / ensemble-mean RMSE / spread ON DEVICE over the
'ensemble' mesh axis (parallel.ensemble.ensemble_scores) and writes
per-variable scores JSON from process 0; with --no-save_members only
those KBs ever reach the host — the consumable north-star output when
the member fields themselves (~10 GB at 50 members x 30 steps x 1
degree) are not needed.

Several hosts pass --multihost: under a cluster manager (SLURM, Open
MPI, ...) jax.distributed.initialize() discovers the coordinator;
elsewhere add --coordinator/--process_id/--num_processes. For a CPU
stand-in (tests, laptops) add --cpu N;
tests/test_multihost.py drives this script as two actual processes.
`main(argv)` returns the saved members, so a caller can compare runs.

Reference role: the reference's ensemble path is single-process jax.pmap
(common/rollout.py:78-202) with no multi-host story (SURVEY §2.3).
"""

import argparse
import math
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def parse_args(argv=None):
  p = argparse.ArgumentParser()
  p.add_argument('--preset', default='1deg')
  p.add_argument('--data', default='synthetic')
  p.add_argument('--ckpt_dir', default=None)
  p.add_argument('--members', type=int, default=50)
  p.add_argument('--steps', type=int, default=30)
  p.add_argument('--out', default='/tmp/forecast.npz')
  p.add_argument('--score', action='store_true',
                 help='compute CRPS/RMSE/spread vs the data source\'s '
                      'targets ON DEVICE (parallel.ensemble.ensemble_'
                      'scores) and save per-variable scores JSON; only '
                      'KB-sized scores reach the host')
  p.add_argument('--save_members', action=argparse.BooleanOptionalAction,
                 default=True,
                 help='offload and save the member forecast fields '
                      '(--no-save_members for score-only runs: at 50 '
                      'members x 30 steps x 1 degree the fields are '
                      '~10 GB through the host, the scores are KBs)')
  p.add_argument('--multihost', action='store_true',
                 help='initialize jax.distributed (one process per host)')
  p.add_argument('--bf16', action=argparse.BooleanOptionalAction,
                 default=None,
                 help='bf16 compute (default: the preset decides); must '
                      'match how the checkpoint was trained')
  p.add_argument('--clean_sst_nans', action='store_true',
                 help='wrap with NaNCleaner, as in train.py; must match '
                      'how the checkpoint was trained')
  p.add_argument('--coordinator', default=None,
                 help='coordinator address for --multihost (host:port; '
                      'default: discovered from the cluster manager)')
  p.add_argument('--process_id', type=int, default=None)
  p.add_argument('--num_processes', type=int, default=None)
  p.add_argument('--cpu', type=int, default=0, metavar='N',
                 help='CPU stand-in with N local virtual devices '
                      '(testing; must be set before jax initializes)')
  args = p.parse_args(argv)
  if not args.save_members and not args.score:
    # Would compute the whole ensemble and write nothing at all.
    p.error('--no-save_members without --score produces no output; '
            'add --score (or drop --no-save_members)')
  return args


def main(argv=None):
  args = parse_args(argv)
  if args.cpu:
    # Must precede the jax backend's initialisation.
    from tools.xla_flags import force_host_device_count
    force_host_device_count(args.cpu)
    os.environ['JAX_PLATFORMS'] = 'cpu'
  import jax
  if args.cpu:
    jax.config.update('jax_platforms', 'cpu')
  if args.multihost:
    if args.coordinator is not None:
      jax.distributed.initialize(args.coordinator, args.num_processes,
                                 args.process_id)
    else:
      jax.distributed.initialize()

  from gencast_tpu.nn import nnx
  import numpy as np

  from gencast_tpu import configs
  from gencast_tpu.data import sources
  from gencast_tpu.models import wrappers
  from gencast_tpu.parallel import ensemble, meshes
  from gencast_tpu.training.train import build_spec

  n_dev = jax.device_count()
  # Ensemble gets the largest device-count divisor that member count can
  # fill; the leftover factor becomes tensor parallelism over 'model'
  # (e.g. 64 devices / 50 members -> ensemble=32, model=2, two chunks).
  ens_axis = max(d for d in range(1, n_dev + 1)
                 if n_dev % d == 0 and d <= max(1, args.members))
  mesh = meshes.make_mesh(ensemble=ens_axis, data=1,
                          model=n_dev // ens_axis)
  print(f'[forecast] {jax.process_count()} proc x '
        f'{jax.local_device_count()} local = {n_dev} devices, '
        f'mesh ensemble={ens_axis} model={n_dev // ens_axis}', flush=True)

  class _A:  # build_spec expects argparse-like fields
    preset = args.preset
    mesh_size = d_model = num_layers = num_heads = None
    attention_k_hop = attention_type = None
  spec = build_spec(_A)
  model, statics = configs.build_gencast(spec, rngs=nnx.Rngs(0))

  task = model.task
  source = (sources.SyntheticSource(task, statics.grid_lat, statics.grid_lon,
                                    num_times=args.steps + 4)
            if args.data == 'synthetic'
            else sources.Era5NpzSource(args.data, task))
  stats = sources.compute_stats(source)
  # Canonical wrapper stack, shared with train.py/evaluate.py: checkpoint
  # state trees depend on the nesting, so the flags must mirror training.
  wrapped = wrappers.build_stack(
      model, stats,
      bf16=args.bf16 or (args.bf16 is None and spec.cast_bf16),
      clean_sst_nans=args.clean_sst_nans)
  if args.ckpt_dir:
    from gencast_tpu.training import checkpoint as ckpt_lib
    manager = ckpt_lib.create_manager(args.ckpt_dir)
    step = ckpt_lib.restore(manager, wrapped)
    print(f'[forecast] restored step {step}', flush=True)

  # Host values are process-identical; device_put onto mesh-spanning
  # shardings is the multi-process-safe placement path (each process
  # contributes its addressable shards).
  meshes.shard_model(wrapped, mesh)
  w = source.sample(0, num_target_frames=args.steps)
  repl = meshes.replicated(mesh)
  inputs = jax.device_put(np.asarray(w.inputs)[None], repl)
  forcings = jax.device_put(np.asarray(w.forcings)[:, None], repl)

  # Member keys are folded once from the global key; chunking over the
  # ensemble axis never changes any member's stream.
  padded = math.ceil(args.members / ens_axis) * ens_axis
  mkeys = ensemble.member_keys(jax.random.PRNGKey(0), padded)

  t0 = time.time()
  kept = {}  # global member id -> np.ndarray [K, B, lat, lon, C]
  chunk_outs = []  # device-resident chunk outputs (for --score)
  # One jitted program for every chunk (same chunk shape by construction).
  run = ensemble.make_ensemble_rollout(wrapped, mesh=mesh)
  for lo in range(0, padded, ens_axis):
    out = run(inputs, forcings, mkeys[lo:lo + ens_axis])
    # [ens_axis, K, B, lat, lon, C], member axis sharded over 'ensemble'.
    if args.score:
      chunk_outs.append(out)
    if not args.save_members:
      continue
    # Under multi-process the global array is not fully addressable on
    # any one host: save each process's own shards (dedup the 'model'-
    # axis replicas by member range).
    seen = set()
    for shard in out.addressable_shards:
      mem_slice = shard.index[0]
      start = mem_slice.start or 0
      if start in seen:
        continue
      seen.add(start)
      data = np.asarray(shard.data)
      for j in range(data.shape[0]):
        member = lo + start + j
        if member < args.members:
          kept[member] = data[j]
  if not args.save_members:
    # chunk_outs is populated here (--score is required with
    # --no-save_members): wait for them so the wall time covers the
    # compute without offloading the member fields.
    jax.block_until_ready(chunk_outs)
  # Otherwise np.asarray(shard.data) above already forced host readback,
  # so the wall time covers this process's compute either way.
  dt = time.time() - t0
  print(f'[forecast] {args.members} members x {args.steps} steps: '
        f'{dt:.1f}s wall (incl. compile), '
        f'{args.members / dt:.2f} members/s', flush=True)

  if args.score:
    # Device-side verification over the 'ensemble' axis: member fields
    # stay sharded on the mesh; only [K, B, C]-shaped scores reach the
    # host (then per-variable scalars into JSON). Padding members are
    # sliced off on device before the reduction.
    import jax.numpy as jnp

    from gencast_tpu.data import layout as layout_lib
    from gencast_tpu.ops import metrics as metrics_lib

    t0 = time.time()
    all_members = (chunk_outs[0] if len(chunk_outs) == 1
                   else jnp.concatenate(chunk_outs, axis=0))
    truth = jnp.asarray(np.asarray(w.targets)[:, None])  # [K, B, ...]
    lat_w = jnp.asarray(layout_lib.latitude_weights(statics.grid_lat))
    scores = ensemble.ensemble_scores(
        all_members[:args.members], truth, lat_w, mesh=mesh)
    tgt_layout = wrappers.find_layout_provider(wrapped).target_layout
    per_var = {
        name: {var: np.asarray(v)[:, 0].tolist()  # [K] per forecast step
               for var, v in metrics_lib.per_variable(
                   np.asarray(arr), tgt_layout).items()}
        for name, arr in scores.items()}
    print(f'[forecast] device-side scores in {time.time()-t0:.1f}s',
          flush=True)
    if jax.process_index() == 0:
      import json
      base, _ = os.path.splitext(args.out)
      scores_path = f'{base}.scores.json'
      with open(scores_path, 'w') as f:
        json.dump({'members': args.members, 'steps': args.steps,
                   'scores': per_var}, f, indent=1)
      print(f'[forecast] saved scores to {scores_path}', flush=True)

  if args.save_members:
    ids = np.array(sorted(kept), dtype=np.int32)
    preds = np.stack([kept[i] for i in ids]) if len(ids) else np.zeros((0,))
    out_path = args.out
    if jax.process_count() > 1:
      base, ext = os.path.splitext(args.out)
      out_path = f'{base}.p{jax.process_index()}{ext}'
    np.savez(out_path, predictions=preds, members=ids,
             lat=statics.grid_lat, lon=statics.grid_lon)
    print(f'[forecast] saved members {ids.tolist()} to {out_path}',
          flush=True)
    return {'predictions': preds, 'members': ids, 'sharding': out.sharding}
  return {'sharding': out.sharding}


if __name__ == '__main__':
  main()
