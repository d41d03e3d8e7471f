"""Analytic FLOP accounting (training/flops.py) pinned two ways:

1. exact hand-computed matmul counts for the primitives;
2. XLA's own cost analysis of the compiled tiny denoiser/GraphCast
   forwards (the compiler counts executed FLOPs incl. elementwise and
   masked-attention waste, so it upper-bounds the analytic MODEL count
   and must sit close above it);
3. the nano preset's forward count pinned to a constant, so a silent
   config or formula drift shows up as a test failure rather than a
   wrong MFU in the next bench pass.
"""

from gencast_tpu.nn import nnx
import jax
import jax.numpy as jnp
import pytest

from gencast_tpu import configs
from gencast_tpu.training import flops as F


def test_mlp_flops_exact():
  # rows=10, widths 4 -> 8 -> 3: 2*10*(4*8 + 8*3) = 1120.
  assert F.mlp_flops(10, [4, 8, 3]) == 1120.0


def test_transformer_flops_exact():
  # N=8, P=16 pairs, D=4, F=6, 2 layers:
  # per layer 8*8*16 + 4*16*4 + 4*8*4*6 = 1024 + 256 + 768 = 2048.
  assert F.transformer_forward_flops(8, 16, 4, 6, 2) == 4096.0


def _xla_flops(fn, *args) -> float:
  comp = jax.jit(fn).lower(*args).compile()
  ca = comp.cost_analysis()
  if isinstance(ca, list):
    ca = ca[0]
  return float(ca['flops'])


def test_denoiser_forward_matches_xla_cost_analysis():
  spec = configs.TINY
  model, statics = configs.build_gencast(spec, rngs=nnx.Rngs(0))
  analytic = F.denoiser_forward_flops(spec, statics).total

  d = model.denoiser
  nlat, nlon = statics.grid_lat.shape[0], statics.grid_lon.shape[0]
  inputs = jnp.zeros((1, nlat, nlon, d.input_layout.num_channels))
  targets = jnp.zeros((1, nlat, nlon, d.target_layout.num_channels))
  forcings = jnp.zeros((1, nlat, nlon, d.forcing_layout.num_channels))
  graphdef, state = nnx.split(model)

  def fwd(state, inputs, targets, forcings):
    return nnx.merge(graphdef, state)(inputs, targets,
                                      jnp.ones((1,)), forcings)

  xla = _xla_flops(fwd, state, inputs, targets, forcings)
  # XLA counts executed FLOPs: >= the analytic model count (elementwise
  # ops, masked triblock attention waste, padding), but close above it —
  # measured ratio 1.026 at tiny (2026-08-19).
  assert analytic <= xla <= 1.35 * analytic, (analytic, xla)

  # Batch scaling is linear.
  assert F.denoiser_forward_flops(spec, statics, batch=3).total == (
      pytest.approx(3 * analytic))


def test_graphcast_forward_matches_xla_cost_analysis():
  spec = configs.TINY
  model, statics = configs.build_graphcast(spec, rngs=nnx.Rngs(0))
  analytic = F.graphcast_forward_flops(spec, statics, task=model.task).total

  nlat, nlon = statics.grid_lat.shape[0], statics.grid_lon.shape[0]
  inputs = jnp.zeros((1, nlat, nlon, model.input_layout.num_channels))
  forcings = jnp.zeros((1, nlat, nlon, model.forcing_layout.num_channels))
  graphdef, state = nnx.split(model)

  def fwd(state, inputs, forcings):
    return nnx.merge(graphdef, state).predict(inputs, forcings)

  xla = _xla_flops(fwd, state, inputs, forcings)
  assert analytic <= xla <= 1.35 * analytic, (analytic, xla)


def test_nano_forward_flops_pinned():
  """Pins the formula to the nano config: a change to either (task
  channels, mesh, k-hop mask, transformer dims, or the formula itself)
  must be a conscious decision, because every MFU number derives from
  this."""
  spec = configs.NANO
  statics = configs.build_statics(spec)
  fwd = F.denoiser_forward_flops(spec, statics)
  assert fwd.total == pytest.approx(1.6167e11, rel=1e-3), fwd.total
  assert fwd.transformer == pytest.approx(1.164e11, rel=1e-2)
  assert fwd.gnn == pytest.approx(4.532e10, rel=1e-2)
  # Derived step counts.
  assert F.train_step_flops(fwd).total == pytest.approx(3 * fwd.total)
  assert F.sampler_step_flops(fwd, 20).total == pytest.approx(
      39 * fwd.total)
  # MFU is model FLOP/s over the card's bf16 peak: the nano train step's
  # FLOPs in one second are that many FLOP/s.
  assert F.mfu(F.train_step_flops(fwd).total, 1.0,
               'NVIDIA H100 80GB HBM3') == pytest.approx(
                   3 * fwd.total / 989e12)


def test_peak_table_resolves_the_h100():
  p = F.peak('NVIDIA H100 80GB HBM3')
  assert p == {'bf16_flops': 989e12, 'hbm_bytes': 3.35e12}


@pytest.mark.parametrize('kind', ['cpu', 'NVIDIA A100-SXM4-80GB', ''])
def test_peak_table_refuses_unknown_devices(kind):
  with pytest.raises(KeyError, match='no published peak'):
    F.peak(kind)
  with pytest.raises(KeyError):
    F.mfu(1e12, 1.0, kind)
