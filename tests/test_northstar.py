"""Large-topology rehearsal of the ensemble forecast.

These tests execute a 64-device topology virtually: 64 forced CPU
devices, the (16,2,2) dryrun mesh factors, and the pod forecast CLI at
members=50 (ensemble=32 x model=2, padded to 64 in two chunks) — with a
small-topology oracle proving the member streams are invariant to the
device count and chunking. The 32-device row is exercised by a
documented drive, `python __graft_entry__.py 32`, to keep the slow tier
bounded.

Reference role: common/rollout.py:78-202 (the pmap ensemble helper this
framework's sharded rollout replaces).
"""

import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POD_SCRIPT = os.path.join(REPO, 'scripts', 'ensemble_forecast_pod.py')


def _run_pod(out, cpu, members, extra=()):
  env = {k: v for k, v in os.environ.items() if k != 'XLA_FLAGS'}
  r = subprocess.run(
      [sys.executable, POD_SCRIPT, '--preset', 'tiny', '--cpu', str(cpu),
       '--members', str(members), '--steps', '2', '--out', out, *extra],
      capture_output=True, text=True, env=env, cwd=REPO, timeout=900)
  assert r.returncode == 0, r.stdout + r.stderr
  return r.stdout


@pytest.mark.slow
def test_pod_cli_at_northstar_topology(tmp_path):
  """64 virtual devices, 50 members.

  The CLI factors 64 into ensemble=32 x model=2 and pads 50 members to
  64 (two chunks of 32); every requested member must come back finite,
  and members computed at this topology must match the same members from
  a 2-device run (chunking/padding/device-count invariance).
  """
  big = str(tmp_path / 'ns64.npz')
  out = _run_pod(big, cpu=64, members=50)
  assert 'ensemble=32 model=2' in out, out

  f = np.load(big)
  assert sorted(f['members'].tolist()) == list(range(50))
  assert np.isfinite(f['predictions']).all()

  small = str(tmp_path / 'ns2.npz')
  _run_pod(small, cpu=2, members=3)
  g = np.load(small)
  for m in range(3):
    a = f['predictions'][list(f['members']).index(m)]
    b = g['predictions'][list(g['members']).index(m)]
    assert a.shape == b.shape
    rel = np.abs(a - b).max() / (np.abs(a).max() + 1e-9)
    # f32 reduction-order noise from the model=2 tensor sharding only.
    assert rel < 1e-5, (m, rel)


@pytest.mark.slow
def test_dryrun_at_64_devices():
  """The (16,2,2) factor row of __graft_entry__.dryrun_multichip: sharded
  train step + churned ensemble sampling + production kernel paths over
  64 virtual devices. (The 32-row, (8,2,2), is the same code at a
  smaller shape; drive it with `python __graft_entry__.py 32`.)"""
  import __graft_entry__ as entrypoints
  entrypoints.dryrun_multichip(64)
