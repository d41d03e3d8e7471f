"""chip_smoke.py: refuses to run off the GPU, and its checks rehearsed on
the CPU at tiny sizes (kernel through the Pallas interpreter)."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


def _run_alone(cwd):
  env = dict(os.environ, JAX_PLATFORMS='cpu')
  return subprocess.run([sys.executable, 'chip_smoke.py'], cwd=cwd,
                        env=env, capture_output=True, text=True,
                        timeout=300)


def test_refuses_cpu_platform():
  r = _run_alone(ROOT)
  assert r.returncode != 0
  assert '"ok"' not in r.stdout
  assert 'needs a GPU' in r.stderr


def test_refuses_without_the_repo(tmp_path):
  shutil.copy(os.path.join(ROOT, 'chip_smoke.py'), tmp_path)
  r = _run_alone(tmp_path)
  assert r.returncode != 0
  assert '"ok"' not in r.stdout


@pytest.mark.parametrize('max_rows', [64, 20])
def test_kernel_check_rehearsal(max_rows):
  """All rows, and a sample of them (the 0.25-degree mode)."""
  csr = chip_smoke.mesh_attention_mask(1, 2)   # 42 mesh nodes
  plan = chip_smoke.kernel_check('tiny', csr, 16, heads=2, head_dim=16,
                                 chunk=16, max_rows=max_rows,
                                 interpret=True)
  assert plan.tile == 16


def test_dense_reference_matches_unchunked():
  import jax
  import jax.numpy as jnp
  csr = chip_smoke.mesh_attention_mask(1, 2)
  mask = jnp.asarray(csr.toarray())
  q, k, v = (jax.random.normal(jax.random.PRNGKey(i), (1, 42, 2, 8))
             for i in range(3))
  s = jnp.einsum('bqhd,bkhd->bhqk', q, k) * 8 ** -0.5
  p = jax.nn.softmax(jnp.where(mask, s, -1e30), -1)
  want = jnp.einsum('bhqk,bkhd->bqhd', p, v)
  got = chip_smoke.dense_reference(q, k, v, mask, chunk=16)
  np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=1e-5)
  rows = np.array([0, 5, 41])
  part = chip_smoke.dense_reference(q, k, v, mask[rows], chunk=16, rows=rows)
  np.testing.assert_allclose(np.asarray(part), np.asarray(want[:, rows]),
                             atol=1e-5)


def test_train_check_rehearsal():
  run = chip_smoke.train_check(
      'tiny', ['--preset', 'tiny', '--data', 'synthetic', '--steps', '3',
               '--log_every', '1', '--prefetch', '0'])
  assert len(run['losses']) == 3


def test_train_check_catches_frozen_parameters():
  """A run whose parameters did not move must fail the check."""
  with pytest.raises(AssertionError, match='moved'):
    chip_smoke.train_check(
        'tiny', ['--preset', 'tiny', '--data', 'synthetic', '--steps', '2',
                 '--learning_rate', '0', '--log_every', '1',
                 '--prefetch', '0'])


def test_four_card_phase_rehearsal(tmp_path):
  """The --four comparisons on 4 of the 8 virtual CPU devices, at the tiny
  preset: pod CLI over ensemble=4 vs one device, member by member, and a
  --dp 4 train step vs one device."""
  chip_smoke.four_cards(str(tmp_path), preset='tiny')
