"""Real multi-process jax.distributed coverage (tools/multihost_smoke.py).

Everything else in the suite runs on a single-process virtual device mesh,
which cannot catch multi-process-only failures: placing host arrays onto
shardings that span non-addressable devices (meshes.shard_model on a pod),
cross-process collectives in the psum'd gradient path, or per-process
weight/PRNG divergence. This test spawns TWO actual processes joined by a
localhost coordinator (gloo CPU collectives) and checks they compute the
same sharded train-step loss and ensemble-sample checksum.

Reference role: the reference has no multi-process path at all (SURVEY
§2.3); this backs scripts/ensemble_forecast_pod.py --multihost.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, 'tools', 'multihost_smoke.py')
POD_SCRIPT = os.path.join(REPO, 'scripts', 'ensemble_forecast_pod.py')


def _free_port() -> int:
  with socket.socket() as s:
    s.bind(('localhost', 0))
    return s.getsockname()[1]


# XLA's gloo CPU collectives give the cross-process key-value handshake a
# fixed 30s deadline. On a host with few cores the first attempt can blow
# it through no fault of the code under test: pytest + two children share
# the cores, and whichever child gets them compiles its sharded program and
# reaches the first collective >30s before the other. Retrying once is
# sound because the persistent compile cache is warm on attempt 2, which
# removes the skew — and a REAL cross-process bug fails both attempts.
_GLOO_FLAKE = 'Gloo context initialization failed'


def _drive_pair(spawn, tries=2):
  """Run spawn() -> [Popen, ...] to completion; retry once on the gloo
  handshake flake. Returns the outputs; asserts every process exited 0."""
  for attempt in range(tries):
    procs = spawn()
    outs = []
    for p in procs:
      try:
        out, _ = p.communicate(timeout=600)
      except subprocess.TimeoutExpired:
        for q in procs:
          q.kill()
        raise
      outs.append(out)
    if all(p.returncode == 0 for p in procs):
      return outs
    if attempt + 1 < tries and any(_GLOO_FLAKE in o for o in outs):
      print('[test_multihost] gloo handshake flake; retrying with a warm '
            'compile cache', file=sys.stderr)
      continue
    for i, (p, out) in enumerate(zip(procs, outs)):
      assert p.returncode == 0, f'process {i} failed:\n{out}'
  raise AssertionError('unreachable')


@pytest.mark.slow
def test_two_process_train_and_ensemble():
  # The smoke script owns its env (sets XLA_FLAGS/JAX_PLATFORMS before jax
  # import); just make sure the conftest's 8-device flag doesn't leak into
  # any earlier import in the child.
  env = {k: v for k, v in os.environ.items() if k != 'XLA_FLAGS'}

  def spawn():
    port = _free_port()
    return [
        subprocess.Popen([sys.executable, SCRIPT, str(i), '2', str(port)],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True, env=env, cwd=REPO)
        for i in range(2)
    ]

  outs = _drive_pair(spawn)

  oks = [line for out in outs for line in out.splitlines()
         if line.startswith('MULTIHOST_OK')]
  assert len(oks) == 2, outs
  # Same loss and ensemble checksum on both processes: parameter
  # placement, batch sharding, and collectives agree across the boundary.
  vals = {line.split(' ', 1)[1].split('/', 1)[1] for line in oks}
  assert len(vals) == 1, oks


@pytest.mark.slow
def test_pod_forecast_script_two_process(tmp_path):
  """Drives the PRODUCTION pod CLI (scripts/ensemble_forecast_pod.py) as
  two real processes and checks member-stream invariance: the same member
  keys must give the same forecast regardless of process count, mesh
  model-factor, or padding chunks (member 3 is padding here: 3 members on
  an ensemble=2 axis).
  """
  env = {k: v for k, v in os.environ.items() if k != 'XLA_FLAGS'}
  common = [sys.executable, POD_SCRIPT, '--preset', 'tiny', '--cpu', '2',
            '--members', '3', '--steps', '2', '--score']

  sp_out = str(tmp_path / 'sp.npz')
  r = subprocess.run(common + ['--out', sp_out], capture_output=True,
                     text=True, env=env, cwd=REPO, timeout=600)
  assert r.returncode == 0, r.stdout + r.stderr

  mh_out = str(tmp_path / 'mh.npz')

  def spawn():
    port = _free_port()
    return [
        subprocess.Popen(
            common + ['--out', mh_out, '--multihost',
                      '--coordinator', f'localhost:{port}',
                      '--process_id', str(i), '--num_processes', '2'],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, env=env, cwd=REPO)
        for i in range(2)
    ]

  _drive_pair(spawn)

  sp = np.load(sp_out)
  mh = {}
  for i in range(2):
    f = np.load(str(tmp_path / f'mh.p{i}.npz'))
    for m, pred in zip(f['members'], f['predictions']):
      mh[int(m)] = pred
  # Union of the per-process saves covers exactly the requested members.
  assert sorted(mh) == [0, 1, 2]
  for i, m in enumerate(sp['members']):
    a, b = sp['predictions'][i], mh[int(m)]
    assert a.shape == b.shape
    assert np.isfinite(a).all() and np.isfinite(b).all()
    rel = np.abs(a - b).max() / (np.abs(a).max() + 1e-9)
    # f32 reduction-order noise from the model=2 tensor sharding only.
    assert rel < 1e-5, (int(m), rel)

  # Device-side scoring (--score): the two-process run's on-device
  # CRPS/RMSE/spread must match the single-process run's (same members,
  # f32 reduction-order tolerance). Process 0 writes the JSON.
  import json
  with open(str(tmp_path / 'sp.scores.json')) as f:
    sp_scores = json.load(f)['scores']
  with open(str(tmp_path / 'mh.scores.json')) as f:
    mh_scores = json.load(f)['scores']
  assert set(sp_scores) == {'crps', 'rmse', 'spread'}
  for name, per_var in sp_scores.items():
    for var, vals in per_var.items():
      np.testing.assert_allclose(vals, mh_scores[name][var], rtol=1e-4,
                                 err_msg=f'{name}/{var}')
      assert np.isfinite(vals).all()


@pytest.mark.slow
def test_train_cli_two_process_with_resume(tmp_path):
  """Drives the PRODUCTION train CLI (--multihost) as two real processes:
  data-parallel training over a 2-proc x 2-device mesh with the
  distributed orbax checkpoint, then a second two-process run that
  resumes from it. Every process must report the identical replicated
  loss, and the resumed run must continue from the saved step."""
  ckpt = str(tmp_path / 'ckpt')

  def run_pair(steps):
    env = {k: v for k, v in os.environ.items() if k != 'XLA_FLAGS'}

    def spawn():
      port = _free_port()
      return [
          subprocess.Popen(
              [sys.executable, '-m', 'gencast_tpu.training.train',
               '--preset', 'tiny', '--data', 'synthetic',
               '--steps', str(steps), '--log_every', '2',
               '--batch_size', '4', '--cpu', '2', '--multihost',
               '--coordinator', f'localhost:{port}',
               '--process_id', str(i), '--num_processes', '2',
               '--ckpt_dir', ckpt],
              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
              text=True, env=env, cwd=REPO)
          for i in range(2)
      ]

    return _drive_pair(spawn)

  def loss_fields(out, tag='[train] step'):
    # '[train] step K/N loss=X.XXXX S steps/s' -> ('K/N', 'loss=X.XXXX');
    # wall-clock steps/s legitimately differs per process.
    return [tuple(ln.split()[2:4]) for ln in out.splitlines()
            if tag in ln]

  outs = run_pair(4)
  # The replicated loss is identical on both processes (the psum'd
  # data-parallel gradient path agrees across the process boundary).
  losses = [loss_fields(out) for out in outs]
  assert losses[0] and losses[0] == losses[1], losses
  assert os.path.isdir(ckpt)

  # Multi-host input sharding oracle: a SINGLE-process run on the same
  # 4-device data mesh packs the global batch directly; the two-process
  # run packs 2 rows per host and assembles per-device shards. Identical
  # printed losses prove the local row -> device mapping is right.
  env = {k: v for k, v in os.environ.items() if k != 'XLA_FLAGS'}
  r = subprocess.run(
      [sys.executable, '-m', 'gencast_tpu.training.train',
       '--preset', 'tiny', '--data', 'synthetic', '--steps', '4',
       '--log_every', '2', '--batch_size', '4', '--cpu', '4', '--dp', '4'],
      capture_output=True, text=True, env=env, cwd=REPO, timeout=600)
  assert r.returncode == 0, r.stdout + r.stderr
  assert loss_fields(r.stdout) == losses[0], (loss_fields(r.stdout),
                                              losses[0])

  outs = run_pair(6)
  for out in outs:
    assert 'resumed from step 3' in out, out
  losses = [loss_fields(out, '[train] step 6/6') for out in outs]
  assert losses[0] and losses[0] == losses[1], losses

  # Deployment-shape portability: the checkpoint written by distributed
  # orbax from two processes restores in a plain single-process evaluate
  # (same wrapper stack, no mesh).
  from gencast_tpu.training import evaluate
  out_dir = str(tmp_path / 'eval')
  evaluate.main(['--preset', 'tiny', '--data', 'synthetic',
                 '--ckpt_dir', ckpt, '--max_rollout_steps', '1',
                 '--out_dir', out_dir, '--plot_vars'])
  assert os.path.exists(os.path.join(out_dir, 'metrics.json'))
