"""Published normalization-stats ingestion.

The reference loads DeepMind's gencast_stats_{mean,stddev,diffs_stddev}
_by_level.nc with xarray (training/train_helpers.py:190-211); our loader
reads the same files with h5py into layout.Stats. Files here are
synthesized in the published structure by tools/synth_era5.synthesize_stats
(level-coordinate vectors for atmospheric variables, 0-d scalars for
surface/forcing variables) — the same trick as the ERA5 corpus e2e.
"""

import os

import numpy as np
import pytest

h5py = pytest.importorskip('h5py')

from gencast_tpu.data import layout as layout_lib  # noqa: E402
from gencast_tpu.data import registry, sources  # noqa: E402

LEVELS_6 = (100, 250, 500, 700, 850, 1000)


@pytest.fixture(scope='module')
def stats_dir(tmp_path_factory):
  from tools import synth_era5
  root = str(tmp_path_factory.mktemp('published_stats'))
  synth_era5.synthesize_stats(root, seed=7)
  return root


def test_load_selects_task_levels(stats_dir):
  stats = sources.load_stats_netcdf(stats_dir, LEVELS_6)
  # Atmospheric variables come back as [len(levels)] vectors in the
  # requested order; surface variables as scalars.
  t = stats.mean['temperature']
  assert t.shape == (6,)
  full = sources.load_stats_netcdf(stats_dir, None)
  assert full.mean['temperature'].shape == (13,)
  lvl13 = list(registry.PRESSURE_LEVELS_WEATHERBENCH_13)
  sel = [lvl13.index(l) for l in LEVELS_6]
  np.testing.assert_array_equal(t, full.mean['temperature'][sel])
  assert stats.mean['2m_temperature'].shape == ()
  # All three tables load with plausible value ranges.
  assert float(stats.std['geopotential'].min()) > 0
  assert float(stats.diffs_std['10m_u_component_of_wind']) > 0


def test_feeds_channel_packing(stats_dir):
  """The loaded tables must drive the per-channel vectors exactly like
  compute_stats output (levels index by POSITION in the task levels)."""
  task = registry.GENCAST_TASK
  stats = sources.load_stats_netcdf(stats_dir, task.pressure_levels)
  lay = layout_lib.build_layout(
      task.target_variables, task.pressure_levels, num_times=1)
  scales = layout_lib.channel_scales(lay, stats)
  assert scales.shape == (lay.num_channels,)
  assert (scales > 0).all()
  # Spot-check one atmospheric channel against its table entry.
  c = next(i for i in range(lay.num_channels)
           if lay.var_names[lay.channel_var[i]] == 'temperature'
           and lay.channel_level[i] == 3)
  assert scales[c] == stats.std['temperature'][3]


def test_unprefixed_graphcast_names(tmp_path):
  from tools import synth_era5
  root = str(tmp_path / 'gc_stats')
  synth_era5.synthesize_stats(root, seed=1, prefix='')
  stats = sources.load_stats_netcdf(root, LEVELS_6)
  assert stats.mean['temperature'].shape == (6,)


def test_absent_level_raises_instead_of_nearest(stats_dir):
  """A task level missing from the stats file must be an error, not a
  silent nearest-level substitution (wrong normalization)."""
  with pytest.raises(ValueError, match='125'):
    sources.load_stats_netcdf(stats_dir, (125, 500, 850))


def test_missing_files_raise_with_names(tmp_path):
  with pytest.raises(FileNotFoundError, match='gencast_stats_mean'):
    sources.load_stats_netcdf(str(tmp_path), LEVELS_6)


def test_load_stats_auto_dispatch(stats_dir, tmp_path):
  s_dir = sources.load_stats_auto(stats_dir, LEVELS_6)
  assert s_dir.mean['temperature'].shape == (6,)
  npz = str(tmp_path / 'stats.npz')
  sources.save_stats(s_dir, npz)
  s_npz = sources.load_stats_auto(npz)
  np.testing.assert_array_equal(s_npz.mean['temperature'],
                                s_dir.mean['temperature'])


def test_evaluate_runs_with_published_stats(stats_dir, tmp_path):
  """The published-weights recipe's stats half, end-to-end: evaluate.py
  consumes a NetCDF stats directory through --stats_path (a translated
  checkpoint slots into the same command via --ckpt_dir; the weight
  mapping itself is validated by tests/reference_parity_impl.py)."""
  from gencast_tpu.training import evaluate

  out = str(tmp_path / 'eval_out')
  evaluate.main(['--preset', 'tiny', '--data', 'synthetic',
                 '--stats_path', stats_dir,
                 '--max_rollout_steps', '1', '--num_members', '1',
                 '--out_dir', out])
  import json
  with open(os.path.join(out, 'metrics.json')) as f:
    metrics = json.load(f)
  assert 'rmse' in metrics
