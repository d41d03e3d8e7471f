"""Real-data-path loop: synthesized ERA5 NetCDF corpus -> train ->
checkpoint -> evaluate, all through Era5NetCDFSource (the h5py reader).

The NetCDF path is unit-tested for loading; this drives train ->
checkpoint -> evaluate through it end to end. The corpus is
generated by tools/synth_era5.py in the exact CDS-download layout
(reference training/era5_dataset.py:43-345), including descending
latitude, int16-packed temperature, NaN SST and cumulative precip.
"""

import json
import os

import numpy as np
import pytest

h5py = pytest.importorskip('h5py')


@pytest.fixture(scope='module')
def corpus(tmp_path_factory):
  from tools import synth_era5
  root = str(tmp_path_factory.mktemp('era5_synth'))
  synth_era5.synthesize(root, resolution_deg=10.0, months=['202001'],
                        steps_per_month=30, seed=3)
  return root


def test_source_loads_and_windows(corpus):
  from gencast_tpu.data import era5_netcdf, registry
  src = era5_netcdf.Era5NetCDFSource(corpus, registry.GENCAST_TASK,
                                     resolution_deg=10.0)
  assert len(src) == 30 - 2  # num_input_frames=2, 1 target frame
  w = src.sample(0)
  d = src.task if hasattr(src, 'task') else None
  assert w.inputs.shape[:2] == (19, 36)
  assert np.isfinite(w.inputs).all() and np.isfinite(w.targets).all()
  # Derived forcings landed in the packed forcing tensor.
  assert w.forcings.shape[-1] == 4  # year/day progress sin/cos


@pytest.mark.slow
def test_train_checkpoint_evaluate_cycle(corpus, tmp_path):
  """Loss decreases over a short real-data training run; the checkpoint
  restores into evaluate.py and produces a rollout + NetCDF export."""
  from gencast_tpu.training import evaluate, train

  ckpt = str(tmp_path / 'ckpt')
  out = str(tmp_path / 'eval')
  metrics_jsonl = str(tmp_path / 'metrics.jsonl')
  stats_path = str(tmp_path / 'stats.npz')

  train.main(['--preset', 'tiny', '--data', corpus,
              '--steps', '120', '--learning_rate', '1e-3',
              '--warmup_steps', '20',
              '--ckpt_dir', ckpt, '--save_every', '120',
              '--stats_path', stats_path,
              '--metrics_jsonl', metrics_jsonl, '--log_every', '10'])

  with open(metrics_jsonl) as f:
    events = [json.loads(line) for line in f if line.strip()]
  losses = [e['loss'] for e in events if e.get('event') == 'train']
  assert len(losses) >= 6
  early = np.mean(losses[:2])
  late = np.mean(losses[-2:])
  assert late < 0.7 * early, (early, late)

  evaluate.main(['--preset', 'tiny', '--data', corpus,
                 '--ckpt_dir', ckpt, '--stats_path', stats_path,
                 '--max_rollout_steps', '2', '--num_members', '2',
                 '--out_dir', out, '--save_netcdf'])
  with open(os.path.join(out, 'metrics.json')) as f:
    metrics = json.load(f)
  assert 'rmse' in metrics and np.isfinite(list(metrics['rmse'].values())).all()
  assert os.path.exists(os.path.join(out, 'rollout.nc'))
  # The exported NetCDF carries reference-convention variables.
  with h5py.File(os.path.join(out, 'rollout.nc'), 'r') as f:
    assert '2m_temperature' in f and 'target_temperature' in f
