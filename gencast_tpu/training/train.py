"""Training CLI.

Feature parity with the reference harness (training/train.py) plus:
optimizer-state checkpointing with mid-run resume, a synthetic data mode
(no ERA5 download needed), and jax.profiler hooks.

Examples:
  # Smoke-train a tiny model on synthetic data (CPU-friendly):
  python -m gencast_tpu.training.train --preset tiny --steps 20 --data synthetic

  # Nano-GenCast (reference demo config) on one GPU:
  python -m gencast_tpu.training.train --preset nano --steps 30000 \
      --data /path/to/era5_npz --ckpt_dir /tmp/ckpt
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import os
import time

import numpy as np


def parse_args(argv=None):
  p = argparse.ArgumentParser(description='Train GenCast or GraphCast.')
  p.add_argument('--model', default='gencast',
                 choices=['gencast', 'graphcast'])
  p.add_argument('--preset', default='nano',
                 choices=['tiny', 'nano', '1deg', '0.25deg'])
  p.add_argument('--ar_steps', type=int, default=1,
                 help='autoregressive training steps (graphcast only)')
  p.add_argument('--task', default=None,
                 help='registry task name overriding the preset task '
                      '(e.g. graphcast_37 for the full published '
                      '37-level GraphCast configuration)')
  p.add_argument('--remat_group', type=int, default=1,
                 help='graphcast only: nested-checkpoint group size for '
                      'the processor MP steps (hierarchical remat)')
  p.add_argument('--data', default='synthetic',
                 help="'synthetic' or a directory of era5 npz shards")
  p.add_argument('--steps', type=int, default=30000)
  p.add_argument('--batch_size', type=int, default=1)
  p.add_argument('--learning_rate', type=float, default=3e-4)
  p.add_argument('--warmup_steps', type=int, default=1000)
  p.add_argument('--weight_decay', type=float, default=0.1)
  p.add_argument('--seed', type=int, default=0)
  # Architecture overrides (None -> preset value).
  p.add_argument('--mesh_size', type=int, default=None)
  p.add_argument('--d_model', type=int, default=None)
  p.add_argument('--num_layers', type=int, default=None)
  p.add_argument('--num_heads', type=int, default=None)
  p.add_argument('--attention_k_hop', type=int, default=None)
  p.add_argument('--attention_type', default=None,
                 choices=[None, 'auto', 'triblock', 'dense', 'pallas'])
  # Wrappers.
  p.add_argument('--no_normalization', action='store_true',
                 help='skip the InputsAndResiduals wrapper')
  p.add_argument('--bf16', action=argparse.BooleanOptionalAction,
                 default=None,
                 help='bf16 compute with f32 master weights '
                      '(default: the preset decides; --no-bf16 forces f32)')
  p.add_argument('--functional_step', action='store_true', default=None,
                 help='donated-state training step (no second params/opt '
                      'copy across the step; default: on for 0.25deg)')
  p.add_argument('--steps_per_call', type=int, default=1,
                 help='fuse K train steps into one on-device lax.scan '
                      'over a device-resident sample pool (amortizes '
                      'per-step dispatch overhead; batch_size=1, '
                      'single-host only; composes with --ar_steps)')
  p.add_argument('--pool_size', type=int, default=64,
                 help='max samples resident on device in fused mode')
  p.add_argument('--clean_sst_nans', action='store_true')
  # Checkpointing / eval / logging.
  p.add_argument('--ckpt_dir', default=None)
  p.add_argument('--save_every', type=int, default=500)
  p.add_argument('--eval_every', type=int, default=500)
  p.add_argument('--do_sampling_eval', action='store_true')
  p.add_argument('--log_every', type=int, default=10)
  p.add_argument('--metrics_jsonl', default=None,
                 help='append one JSON line per log/eval event here '
                      '(role of the reference wandb scalars, '
                      'train_helpers.py:366-391)')
  p.add_argument('--wandb', action='store_true',
                 help='log metrics to wandb (requires the package; '
                      'falls back to a warning without it)')
  p.add_argument('--wandb_project', default='gencast_tpu')
  p.add_argument('--profile_dir', default=None,
                 help='capture a jax.profiler trace of steps 10-15 here')
  p.add_argument('--stats_path', default=None,
                 help='npz normalization stats (default: compute from data)')
  p.add_argument('--prefetch', type=int, default=None,
                 help='batches kept in flight by the background '
                      'host->device pipeline (data/prefetch.py, the '
                      'reference Grain role); 0 disables. Default: 2 on '
                      'multi-core hosts, 0 on <=2 cores, where the thread '
                      'would compete with the step loop for the core')
  p.add_argument('--data_workers', type=int, default=0,
                 help='out-of-process batch-packing workers '
                      '(data/workers.py, the scalable half of the '
                      'reference Grain role); 0 packs in-process. Output '
                      'batches are bitwise identical either way. Worth it '
                      'only on multi-core hosts where packing outruns one '
                      'core (e.g. 0.25-degree file reads)')
  # Parallelism (data axis; model/ensemble used by larger deployments).
  p.add_argument('--dp', type=int, default=1)
  p.add_argument('--mp', type=int, default=1)
  # Multi-host (one process per host). Under a cluster manager (SLURM,
  # Open MPI, ...) jax.distributed.initialize() discovers the coordinator;
  # elsewhere pass --coordinator host:port, --num_processes and
  # --process_id (tests/test_multihost.py drives that with a CPU stand-in).
  p.add_argument('--multihost', action='store_true',
                 help='initialize jax.distributed (one process per host); '
                      'the mesh spans all hosts')
  p.add_argument('--coordinator', default=None)
  p.add_argument('--process_id', type=int, default=None)
  p.add_argument('--num_processes', type=int, default=None)
  p.add_argument('--cpu', type=int, default=0, metavar='N',
                 help='CPU stand-in with N local virtual devices (testing; '
                      'must be the first jax use in the process)')
  return p.parse_args(argv)


def build_spec(args):
  from gencast_tpu import configs
  from gencast_tpu.data import registry
  spec = configs.SPECS[args.preset]
  overrides = {}
  if getattr(args, 'task', None):
    overrides['task'] = registry.TASKS[args.task]
  if args.mesh_size is not None:
    overrides['mesh_splits'] = args.mesh_size
  for field in ('d_model', 'num_layers', 'num_heads', 'attention_k_hop',
                'attention_type'):
    v = getattr(args, field)
    if v is not None:
      overrides[field] = v
  return dataclasses.replace(spec, **overrides) if overrides else spec


def _run_fused(args, source, wrapped, optimizer, manager, sink, start_step,
               ar_steps=1):
  """Fused training loop: K steps per dispatch via scanned_train_steps.

  Epoch shuffling matches the per-step loop's batch_iterator in spirit
  (a host-side permutation stream selects pool rows per step); the
  per-step PRNG keys are bit-identical to the per-step loop
  (fold_in(key, step) inside the scan body). With ar_steps > 1 the pool
  rows are AR frame windows ([K_ar, B, ...] targets/forcings, same
  shapes as the per-step AR iterator) and each scan step trains the
  multi-step autoregressive loss.
  """
  from gencast_tpu.nn import nnx
  import jax
  import jax.numpy as jnp

  from gencast_tpu.training import steps as steps_lib
  if manager is not None:
    from gencast_tpu.training import checkpoint as ckpt_lib

  k_call = args.steps_per_call
  ar = ar_steps > 1
  # AR windows consume ar_steps target frames, so the last ar_steps-1
  # start indices don't fit (same bound as the per-step AR iterator).
  m_pool = min(max(1, len(source) - ar_steps + 1), args.pool_size)
  samples = [source.sample(i, num_target_frames=ar_steps)
             for i in range(m_pool)]

  def frames(x):
    # [K_ar, ...] window -> [K_ar, B=1, ...]; 1-step sample -> [B=1, ...].
    return jnp.asarray(x)[:, None] if ar else jnp.asarray(x)[None]

  pool = {
      'inputs': jnp.stack([jnp.asarray(w.inputs)[None] for w in samples]),
      'targets': jnp.stack([frames(w.targets) for w in samples]),
      'forcings': jnp.stack([frames(w.forcings) for w in samples]),
  }
  del samples
  fused_fn, fstate = steps_lib.scanned_train_steps(wrapped, optimizer,
                                                   ar=ar)
  print(f'[train] fused mode: {k_call} steps/call, '
        f'device pool of {m_pool} samples'
        + (f', AR loss over {ar_steps} steps' if ar else ''))

  rng = np.random.default_rng(args.seed)
  perm: list = []
  key = jax.random.PRNGKey(args.seed)
  losses_acc = []
  logged = []
  steps_acc = 0
  t_log = time.time()
  step = start_step

  def crossed(every, lo, hi):
    return (hi // every) != (lo // every)

  while step < args.steps:
    k = min(k_call, args.steps - step)
    while len(perm) < k:
      perm.extend(rng.permutation(m_pool).tolist())
    idx, perm = perm[:k], perm[k:]
    fstate, losses = fused_fn(fstate, pool, np.asarray(idx),
                              key, np.arange(step, step + k))
    losses_acc.append(losses)
    steps_acc += k
    prev, step = step, step + k

    if crossed(args.log_every, prev, step):
      jax.block_until_ready(losses)
      dt = time.time() - t_log
      mean_loss = float(jnp.concatenate(losses_acc).mean())
      print(f'[train] step {step}/{args.steps} loss={mean_loss:.4f} '
            f'{steps_acc / dt:.2f} steps/s')
      sink.log('train', step, loss=mean_loss, steps_per_sec=steps_acc / dt)
      logged.append(mean_loss)
      losses_acc, steps_acc, t_log = [], 0, time.time()

    if manager is not None and crossed(args.save_every, prev, step):
      nnx.update((wrapped, optimizer), fstate)
      ckpt_lib.save(manager, step - 1, wrapped, optimizer)

  nnx.update((wrapped, optimizer), fstate)
  if manager is not None:
    ckpt_lib.save(manager, args.steps - 1, wrapped, optimizer)
    manager.wait_until_finished()
    print(f'[train] final checkpoint at {args.ckpt_dir}')
  sink.close()
  print('[train] done')
  return {'model': wrapped, 'optimizer': optimizer, 'losses': logged}


def main(argv=None):
  args = parse_args(argv)

  if args.cpu:
    # Honored only if the backend has not initialized yet in this process.
    # tools/ is a repo-root directory, not part of the package: anchor the
    # repo root so `python -m gencast_tpu.training.train --cpu N` works
    # from any cwd (same pattern as __graft_entry__.py).
    import pathlib
    import sys as _sys
    _root = str(pathlib.Path(__file__).resolve().parents[2])
    if _root not in _sys.path:
      _sys.path.append(_root)
    from tools.xla_flags import force_host_device_count
    force_host_device_count(args.cpu)

  from gencast_tpu.nn import nnx
  import jax
  import jax.numpy as jnp

  if args.cpu:
    jax.config.update('jax_platforms', 'cpu')
  if args.multihost:
    if args.coordinator is not None:
      jax.distributed.initialize(args.coordinator, args.num_processes,
                                 args.process_id)
    else:
      jax.distributed.initialize()
    print(f'[train] multihost: process {jax.process_index()}'
          f'/{jax.process_count()}, {jax.device_count()} global devices')

  from gencast_tpu import configs
  from gencast_tpu.data import sources
  from gencast_tpu.models import wrappers
  from gencast_tpu.parallel import meshes
  from gencast_tpu.training import steps as steps_lib
  from gencast_tpu import rollout as rollout_lib

  spec = build_spec(args)
  print(f'[train] model={args.model} spec={spec.name} '
        f'mesh_splits={spec.mesh_splits} d_model={spec.d_model} '
        f'layers={spec.num_layers} attention={spec.attention_type}')

  if args.model == 'graphcast':
    model, statics = configs.build_graphcast(
        spec, rngs=nnx.Rngs(args.seed), remat_group=args.remat_group)
  else:
    model, statics = configs.build_gencast(spec, rngs=nnx.Rngs(args.seed))

  # Data.
  task = model.task  # may differ from spec.task (e.g. graphcast variables)
  # source_factory is the picklable recipe --data_workers ships to its
  # packing processes (each worker builds its own source: h5py handles
  # don't cross processes).
  if args.data == 'synthetic':
    source_factory = functools.partial(
        sources.SyntheticSource, task, np.asarray(statics.grid_lat),
        np.asarray(statics.grid_lon),
        num_times=max(40, args.batch_size * 8), seed=args.seed)
  else:
    import glob as _glob
    if _glob.glob(os.path.join(args.data, 'era5_pressure_levels_*.nc')):
      from gencast_tpu.data import era5_netcdf
      source_factory = functools.partial(
          era5_netcdf.Era5NetCDFSource, args.data, task,
          resolution_deg=spec.resolution_deg)
    else:
      source_factory = functools.partial(sources.Era5NpzSource, args.data,
                                         task)
  source = source_factory()
  print(f'[train] data source: {type(source).__name__}, '
        f'{len(source)} samples')

  # Normalization stats. A directory means DeepMind's published NetCDF
  # stats files (gencast_stats_*_by_level.nc); a file means our npz.
  if args.stats_path and os.path.exists(args.stats_path):
    stats = sources.load_stats_auto(args.stats_path, task.pressure_levels)
    print(f'[train] loaded stats from {args.stats_path}')
  else:
    stats = sources.compute_stats(source)
    if args.stats_path and jax.process_index() == 0:
      sources.save_stats(stats, args.stats_path)
      print(f'[train] computed and saved stats to {args.stats_path}')

  # Canonical wrapper stack (checkpoint trees depend on the nesting).
  bf16 = args.bf16 or (args.bf16 is None and spec.cast_bf16)
  if bf16:
    print('[train] bf16 compute enabled (f32 master weights)')
  wrapped = wrappers.build_stack(model, stats, bf16=bf16,
                                 clean_sst_nans=args.clean_sst_nans,
                                 normalize=not args.no_normalization)

  # Parallelism. Under --multihost the mesh MUST span every global
  # device: each process computing on its local devices alone would
  # silently train divergent replicas.
  if args.multihost and args.dp * args.mp == 1:
    args.dp = jax.device_count()
    print(f'[train] multihost: defaulting --dp to {args.dp}')
  if args.multihost and args.dp * args.mp != jax.device_count():
    raise SystemExit(f'[train] --multihost needs dp*mp == global device '
                     f'count ({jax.device_count()}), got '
                     f'{args.dp}x{args.mp}')
  mesh = None
  if args.dp * args.mp > 1:
    if args.batch_size % args.dp:
      raise SystemExit(f'[train] batch_size ({args.batch_size}) must be '
                       f'divisible by dp ({args.dp})')
    mesh = meshes.make_mesh(1, args.dp, args.mp,
                            devices=jax.devices()[:args.dp * args.mp])
    meshes.shard_model(wrapped, mesh)
    print(f'[train] mesh: data={args.dp} model={args.mp}')

  opt_cfg = steps_lib.OptimizerConfig(
      learning_rate=args.learning_rate, warmup_steps=args.warmup_steps,
      total_steps=args.steps, weight_decay=args.weight_decay)
  optimizer = steps_lib.create_optimizer(wrapped, opt_cfg)
  if mesh is not None:
    # Place optimizer state on the mesh as well: a freshly created state
    # is uncommitted (jit re-places it), but checkpoint RESTORE uses it
    # as the placement template — left on one device, the restored state
    # is committed there and the first train step fails on mixed devices.
    meshes.shard_model(optimizer, mesh)

  # Resume.
  start_step = 0
  manager = None
  if args.ckpt_dir:
    from gencast_tpu.training import checkpoint as ckpt_lib
    manager = ckpt_lib.create_manager(args.ckpt_dir)
    if ckpt_lib.latest_step(manager) is not None:
      start_step = ckpt_lib.restore(manager, wrapped, optimizer) + 1
      print(f'[train] resumed from step {start_step - 1}')

  if args.multihost and args.do_sampling_eval:
    # The eval rollout mixes globally-sharded params with process-local
    # inputs; run evaluate.py / the pod forecast CLI on a checkpoint
    # instead.
    print('[train] WARNING: --do_sampling_eval is disabled under '
          '--multihost')
    args.do_sampling_eval = False

  from gencast_tpu.training.metrics_sink import MetricsSink
  # Host-side sinks write from process 0 only (every process computes
  # the identical replicated loss).
  if jax.process_index() != 0:
    args.metrics_jsonl, args.wandb = None, False
  sink = MetricsSink(args.metrics_jsonl, use_wandb=args.wandb,
                     wandb_project=args.wandb_project,
                     run_config={'preset': spec.name, 'model': args.model,
                                 'steps': args.steps,
                                 'batch_size': args.batch_size,
                                 'lr': args.learning_rate})

  # AR multi-step training is a graphcast-only mode; resolve the effective
  # value once so every downstream gate (multihost, fused, functional)
  # agrees. A stray --ar_steps 2 on a gencast run is a no-op, not an error.
  ar_steps = args.ar_steps if args.model == 'graphcast' else 1

  if args.multihost and ar_steps > 1:
    # The AR iterator yields [1, ...] / [K, B, ...] batches that the
    # P('data') sharding cannot split across a forced dp=device_count
    # mesh; fail clearly instead of crashing at the first device_put.
    raise SystemExit('[train] --ar_steps > 1 is not supported under '
                     '--multihost; train AR single-host or dp=1')

  key = jax.random.PRNGKey(args.seed)

  # Fused multi-step training: one dispatch per K steps (see
  # steps_lib.scanned_train_steps). The host loop's per-step dispatch
  # overhead would otherwise dominate small models.
  fused = (args.steps_per_call > 1 and mesh is None
           and args.batch_size == 1)
  if args.steps_per_call > 1 and not fused:
    print('[train] fused steps_per_call requires batch_size=1 and no '
          'mesh; falling back to per-step dispatch')
  if args.data_workers > 0 and (fused or ar_steps > 1):
    # Neither path reaches make_iterator; say so instead of silently
    # packing in-process.
    mode = 'fused steps_per_call' if fused else 'AR (ar_steps > 1)'
    print(f'[train] --data_workers is ignored in {mode} mode; '
          f'batches are packed in-process')
  if fused:
    return _run_fused(args, source, wrapped, optimizer, manager, sink,
                      start_step, ar_steps)

  # Donated-state step for memory-bound specs (ModelSpec.use_donated_step;
  # on for the 0.25deg preset).
  use_functional = (args.functional_step
                    if args.functional_step is not None
                    else spec.use_donated_step)
  step_fn = fstate = None
  if use_functional and args.model == 'gencast' and ar_steps <= 1:
    step_fn, fstate = steps_lib.functional_train_step(wrapped, optimizer)
    print('[train] donated-state functional step enabled')

  def sync_functional_state():
    """Writes the threaded functional state back into the modules
    (before checkpoint saves and sampling evals)."""
    if fstate is not None:
      nnx.update((wrapped, optimizer), fstate)

  # Exactly ONE live definition of the batch iterator per configuration
  # (AR multi-frame windows / multihost local rows / default).
  if ar_steps > 1:
    # Multi-step AR training: samples provide K target/forcing frames.
    def multi_it():
      rng = np.random.default_rng(args.seed)
      n = len(source) - ar_steps + 1
      while True:
        for i in rng.permutation(max(1, n)):
          w = source.sample(int(i), num_target_frames=ar_steps)
          yield {'inputs': w.inputs[None],
                 'targets': np.swapaxes(w.targets[None], 0, 1),
                 'forcings': np.swapaxes(w.forcings[None], 0, 1)}
    it = multi_it()

    @nnx.jit
    def ar_train_step(m, opt, inputs, targets, forcings, k):
      def loss_fn(mm):
        loss, diags = rollout_lib.autoregressive_loss(
            mm, inputs, targets, forcings, k)
        return loss.mean(), diags
      (loss, diags), grads = nnx.value_and_grad(loss_fn,
                                                has_aux=True)(m)
      opt.update(m, grads)
      return loss, diags

  # In-process vs out-of-process packing produce bitwise-identical batch
  # streams (tests/test_data_workers.py); --data_workers only changes
  # which cores do the packing.
  packer = None

  def make_iterator(rows=None):
    nonlocal packer
    if args.data_workers > 0:
      from gencast_tpu.data import workers as workers_lib
      packer = workers_lib.ParallelBatchIterator(
          source_factory, args.batch_size, num_workers=args.data_workers,
          seed=args.seed, rows=rows)
      print(f'[train] packing batches in {args.data_workers} worker '
            f'processes')
      return packer
    return sources.batch_iterator(source, args.batch_size, seed=args.seed,
                                  rows=rows)

  if mesh is not None and jax.process_count() > 1 and ar_steps == 1:
    # Multi-host input sharding: every process draws the same global
    # permutation but PACKS only the batch rows its own devices hold, so
    # the host-side packing cost per host divides by the host count.
    local_rows, local_blocks = meshes.local_batch_plan(mesh,
                                                       args.batch_size)
    it = make_iterator(rows=local_rows)
    print(f'[train] multihost input sharding: this process packs '
          f'{len(local_rows)}/{args.batch_size} batch rows')

    def put(batch):
      return meshes.assemble_local_batch(mesh, args.batch_size,
                                         local_blocks, batch)
  else:
    if ar_steps == 1:
      it = make_iterator()

    def put(batch):
      if mesh is not None:
        # device_put straight from HOST values: every process provides
        # the identical global batch (same source + seed) and
        # contributes its addressable shards; a jnp.asarray first would
        # commit to one local device, which cross-process shardings
        # reject.
        sh = meshes.batch_sharding(mesh)
        return {k: jax.device_put(np.asarray(v), sh)
                for k, v in batch.items()}
      return {k: jnp.asarray(v) for k, v in batch.items()}

  n_prefetch = args.prefetch
  if n_prefetch is None:
    n_prefetch = 2 if (os.cpu_count() or 1) > 2 else 0
  prefetcher = None
  if n_prefetch > 0:
    # Background host packing + device transfer (the Grain role): the
    # step loop consumes device-resident batches and never waits on the
    # host packer.
    from gencast_tpu.data import prefetch as prefetch_lib
    it = prefetcher = prefetch_lib.DevicePrefetcher(
        it, transform=put, buffer_size=n_prefetch)
    get_batch = lambda: next(it)  # noqa: E731
  else:
    get_batch = lambda: put(next(it))  # noqa: E731

  t_log = time.time()
  losses = []
  logged = []  # the mean losses printed at each log step
  try:
    for step in range(start_step, args.steps):
      if args.profile_dir and step == 10:
        jax.profiler.start_trace(args.profile_dir)
      batch = get_batch()
      step_key = jax.random.fold_in(key, step)
      if ar_steps > 1:
        loss, diags = ar_train_step(
            wrapped, optimizer, batch['inputs'], batch['targets'],
            batch['forcings'], step_key)
      elif step_fn is not None:
        fstate, loss, diags = step_fn(
            fstate, batch['inputs'], batch['targets'], batch['forcings'],
            step_key)
      else:
        loss, diags = steps_lib.train_step(
            wrapped, optimizer, batch['inputs'], batch['targets'],
            batch['forcings'], step_key)
      losses.append(loss)
      if args.profile_dir and step == 15:
        jax.block_until_ready(loss)
        jax.profiler.stop_trace()
        print(f'[train] profiler trace written to {args.profile_dir}')

      if (step + 1) % args.log_every == 0:
        jax.block_until_ready(loss)
        dt = time.time() - t_log
        mean_loss = float(jnp.stack(losses).mean())
        print(f'[train] step {step + 1}/{args.steps} '
              f'loss={mean_loss:.4f} {args.log_every / dt:.2f} steps/s')
        sink.log('train', step + 1, loss=mean_loss,
                 steps_per_sec=args.log_every / dt)
        logged.append(mean_loss)
        losses = []
        t_log = time.time()

      if manager is not None and (step + 1) % args.save_every == 0:
        sync_functional_state()
        ckpt_lib.save(manager, step, wrapped, optimizer)

      if args.do_sampling_eval and (step + 1) % args.eval_every == 0:
        sync_functional_state()
        w = source.sample(0)
        frc = jnp.asarray(w.forcings)[None][None]  # [K=1, B=1, ...]
        roll = (rollout_lib.sample_rollout if args.model == 'gencast'
                else rollout_lib.predict_rollout)
        preds = roll(
            wrapped, jnp.asarray(w.inputs)[None], frc,
            jax.random.fold_in(key, 10**9 + step))
        rmse = float(jnp.sqrt(jnp.nanmean(
            (preds[0, 0] - jnp.asarray(w.targets)) ** 2)))
        print(f'[train] sampling eval rmse={rmse:.4f}')
        sink.log('sampling_eval', step + 1, rmse=rmse)
        if args.metrics_jsonl or args.wandb:
          # Training-time triptych image (reference logs sampled images to
          # wandb during training, train.py:336-403).
          from gencast_tpu.training import plotting
          d = model.denoiser if hasattr(model, 'denoiser') else model
          var = d.target_layout.var_names[0]
          ch = d.target_layout.var_channels(var)[0]
          img_dir = os.path.dirname(args.metrics_jsonl) if args.metrics_jsonl \
              else (args.ckpt_dir or '/tmp')
          img = os.path.join(img_dir, f'eval_{var}_step{step + 1}.png')
          plotting.plot_triptych(
              np.asarray(preds[0, 0, :, :, ch]),
              np.asarray(w.targets)[:, :, ch],
              statics.grid_lat, statics.grid_lon, var, img)
          sink.log_image('sampling_eval', step + 1, var, img)

  finally:
    if prefetcher is not None:
      prefetcher.close()
    if packer is not None:
      packer.close()
  sync_functional_state()
  if manager is not None:
    ckpt_lib.save(manager, args.steps - 1, wrapped, optimizer)
    manager.wait_until_finished()
    print(f'[train] final checkpoint at {args.ckpt_dir}')
  sink.close()
  print('[train] done')
  return {'model': wrapped, 'optimizer': optimizer, 'losses': logged}


if __name__ == '__main__':
  main()
