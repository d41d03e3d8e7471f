"""Real spherical harmonics on lat/lon grids, as MXU-friendly einsums.

Replaces the reference's dependency on `dinosaur.spherical_harmonic`
(gencast/samplers_utils.py:14-330) for sampling isotropic Gaussian-process
noise on the sphere. The synthesis (inverse transform) is two dense matmuls
— Legendre contraction over total wavenumber l, then Fourier contraction
over zonal wavenumber m — which XLA tiles straight onto the MXU, so noise
sampling stays inside jit (and inside the fused sampling scan).

Conventions: orthonormal real spherical harmonics
  Y_{l0}        = Q_{l0}(x)
  Y_{lm}^{cos}  = sqrt(2) Q_{lm}(x) cos(m phi),  m >= 1
  Y_{lm}^{sin}  = sqrt(2) Q_{lm}(x) sin(m phi)
with Q_{lm} = N_{lm} P_l^m and integral of Y^2 over the sphere = 1. Sampling
coefficients iid N(0, 4 pi power_l / (2l+1)) per basis function yields noise
whose pointwise marginal variance equals sum_l power_l and whose law is
rotation-invariant.
"""

from __future__ import annotations

import dataclasses
import functools
import os
from typing import Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

# Tables at or above this max_l AND stored at reduced precision (bf16)
# are computed ON DEVICE (see legendre_table_device): at the 0.25-degree
# scale (L=719) the numpy f64 table is 3GB of host compute plus a 747MB
# host->device transfer in every model build; the on-device scan
# recursion never touches the host. f32 bases keep the f64-exact numpy path at any
# scale (the f32 recursion drifts ~1.5e-3 relative at L=719 — fine under
# bf16 storage rounding, a silent downgrade for f32 callers).
# GENCAST_SH_DEVICE_TABLE=0/1 forces the choice (resolved in
# basis_for_grid so it is part of the basis cache key).
_DEVICE_TABLE_MIN_L = 256


def legendre_table(x: np.ndarray, max_l: int) -> np.ndarray:
  """Normalized associated Legendre values, shape [L+1, L+1, len(x)].

  Entry [l, m, j] is sqrt(2 - delta_{m0}) * N_{lm} P_l^m(x_j) with
  N_{lm} = sqrt((2l+1)/(4pi) (l-m)!/(l+m)!) and the Condon-Shortley phase.
  Entries with m > l are zero. Uses the standard stable normalized
  recursions, vectorized over x, in float64.
  """
  x = np.asarray(x, dtype=np.float64)
  nx = x.shape[0]
  lmax = max_l
  p = np.zeros((lmax + 1, lmax + 1, nx), dtype=np.float64)
  s = np.sqrt(np.maximum(0.0, 1.0 - x * x))  # sin(theta)

  # Diagonal: Q_{mm} (sequential in m).
  p[0, 0] = 1.0 / np.sqrt(4.0 * np.pi)
  for m in range(1, lmax + 1):
    p[m, m] = -np.sqrt((2 * m + 1) / (2.0 * m)) * s * p[m - 1, m - 1]

  # Upward recursion in l, vectorized over all m < l (O(L) numpy calls
  # instead of O(L^2) — the difference between ~10 minutes and ~2 seconds
  # at the 0.25-degree scale, L=719).
  for l in range(1, lmax + 1):
    # First off-diagonal: Q_{l, l-1} = x sqrt(2l+1) Q_{l-1, l-1}.
    p[l, l - 1] = x * np.sqrt(2.0 * l + 1.0) * p[l - 1, l - 1]
    if l >= 2:
      m = np.arange(l - 1, dtype=np.float64)
      a = np.sqrt((4.0 * l * l - 1.0) / (l * l - m * m))
      b = np.sqrt(((l - 1.0) ** 2 - m * m) / (4.0 * (l - 1.0) ** 2 - 1.0))
      p[l, :l - 1] = a[:, None] * (x[None, :] * p[l - 1, :l - 1]
                                   - b[:, None] * p[l - 2, :l - 1])

  # Fold in sqrt(2) for m >= 1 (real-harmonic normalization).
  p[:, 1:] *= np.sqrt(2.0)
  return p


@functools.partial(jax.jit, static_argnames=('max_l', 'dtype_name'))
def _legendre_table_device_impl(x: jnp.ndarray, max_l: int,
                                dtype_name: str) -> jnp.ndarray:
  """On-device legendre_table: scaled f32 recursion under a lax.scan.

  The plain f32 recursion cannot work here: the diagonal seed Q_mm ~ s^m
  underflows f32 long before l climbs back to O(1) values (at the
  0.25-degree scale s^m reaches 1e-39 by m=54 two rows from the pole while
  Q_{300,54} is O(1)). Standard fix (SHTns/libsharp-style): recurse on
  u_lm = Q_lm / s^m — the three-term l-recursion is invariant under the
  substitution, and the seed u_mm = c_m is O(m^{1/4}) — with a per-(m,lat)
  power-of-two exponent carried alongside and renormalized whenever |u|
  leaves [2^-64, 2^64]. The s^m factor and the accumulated exponent are
  applied in exponent space only at emission, so intermediate under/
  overflow never touches the recursion. Each scan step emits its finished
  output row, so the f32 working set stays at 3 rows regardless of L.

  Accuracy vs the f64 oracle (max abs error / table max): 2.4e-4 at L=300,
  1.5e-3 at L=719 — O(L^2 eps) f32 recursion drift, strictly below the
  bf16 storage rounding (4e-3 relative) the 0.25-degree preset stores the
  table at, and irrelevant to its only consumer (isotropic noise synthesis,
  where it perturbs the noise covariance by ~(1.5e-3)^2).
  """
  lmax = max_l
  x = x.astype(jnp.float32)
  nx = x.shape[0]
  s = jnp.sqrt(jnp.maximum(0.0, 1.0 - x * x))

  # Scaled diagonal seeds c_m = Q_mm / s^m (cumprod of O(1) factors).
  mf = jnp.arange(1, lmax + 1, dtype=jnp.float32)[:, None]
  d0 = jnp.full((1, nx), 1.0 / np.sqrt(4.0 * np.pi), jnp.float32)
  c = jnp.concatenate(
      [d0, d0 * jnp.cumprod(
          jnp.broadcast_to(-jnp.sqrt((2.0 * mf + 1.0) / (2.0 * mf)),
                           (lmax, nx)), axis=0)], axis=0)

  m_idx = jnp.arange(lmax + 1, dtype=jnp.float32)
  # log2(s^m), with the m=0 column pinned to 0 (0 * log2(0) is nan).
  pole = jnp.where(m_idx[:, None] > 0,
                   m_idx[:, None] * jnp.log2(jnp.maximum(s, 1e-30))[None, :],
                   0.0)
  # sqrt(2) real-harmonic fold for m >= 1.
  fold = jnp.where(m_idx > 0, np.sqrt(2.0), 1.0)[:, None]
  out_dtype = jnp.dtype(dtype_name)

  def emit(u, e):
    # Q = u * 2^(e + m log2 s), applied as two half-exponent factors:
    # exp2(arg) itself can be denormal (flushed to 0 under XLA even on
    # CPU) while u * 2^arg is a perfectly normal number. exp2(arg/2) is
    # normal whenever the final Q is representable, and the grouped
    # products (u*f)*f only underflow where Q truly underflows.
    f = jnp.exp2((e + pole) * 0.5)
    return (u * f * f * fold).astype(out_dtype)

  row0 = jnp.zeros((lmax + 1, nx), jnp.float32).at[0].set(d0[0])
  e0 = jnp.zeros((lmax + 1, nx), jnp.float32)

  def body(carry, l):
    u1, u2, e = carry  # scaled rows l-1, l-2 and their shared exponent
    lf = l.astype(jnp.float32)
    # General three-term upward recursion; b vanishes at m = l-1 so the
    # first off-diagonal needs no special case. m >= l is masked (the a
    # coefficient is nan there; jnp.where selects it away).
    a = jnp.sqrt((4.0 * lf * lf - 1.0) / (lf * lf - m_idx * m_idx))
    b = jnp.sqrt(((lf - 1.0) ** 2 - m_idx * m_idx)
                 / (4.0 * (lf - 1.0) ** 2 - 1.0))
    u = a[:, None] * (x[None, :] * u1 - b[:, None] * u2)
    u = jnp.where((m_idx < lf)[:, None], u, 0.0)
    u = u.at[l].set(c[l])
    # Joint renormalization of (u, u1) keeping |u| within [2^-64, 2^64];
    # exact-zero columns (not yet activated) are left untouched.
    mx = jnp.maximum(jnp.abs(u), jnp.abs(u1))
    shift = jnp.where((mx > 0.0) & (mx < 2.0 ** -64), 128.0,
                      jnp.where(mx > 2.0 ** 64, -128.0, 0.0))
    # Two half-scale factors: exp2(-128) is denormal (flushed to zero by
    # XLA), exp2(-64) is normal and the intermediate products stay normal.
    half = jnp.exp2(shift * 0.5)
    return (u * half * half, u1 * half * half, e - shift), emit(u, e)

  _, rows = jax.lax.scan(body, (row0, jnp.zeros_like(row0), e0),
                         jnp.arange(1, lmax + 1))
  return jnp.concatenate([emit(row0, e0)[None], rows], axis=0)


def legendre_table_device(x: np.ndarray, max_l: int, dtype) -> jnp.ndarray:
  """legendre_table computed on the default device, returned at dtype."""
  return _legendre_table_device_impl(jnp.asarray(x, jnp.float32), max_l,
                                     jnp.dtype(dtype).name)


@dataclasses.dataclass(frozen=True)
class SphericalHarmonicBasis:
  """Precomputed synthesis operators for a fixed lat/lon grid.

  legendre: [L+1, L+1, num_lat] float32  (l, m, lat)
  fourier:  [2, L+1, num_lon]  float32  (cos(m phi), sin(m phi))
  """
  legendre: jnp.ndarray
  fourier: jnp.ndarray
  max_l: int

  @property
  def num_lat(self) -> int:
    return self.legendre.shape[-1]

  @property
  def num_lon(self) -> int:
    return self.fourier.shape[-1]


@functools.lru_cache(maxsize=8)
def _basis_cached(lat_key: Tuple[float, ...], lon_key: Tuple[float, ...],
                  max_l: int, dtype_name: str,
                  on_device: bool) -> SphericalHarmonicBasis:
  lat = np.asarray(lat_key)
  lon = np.asarray(lon_key)
  x = np.sin(np.deg2rad(lat))
  dtype = np.dtype(dtype_name)
  if on_device:
    leg = legendre_table_device(x, max_l, dtype)
  else:
    leg = jnp.asarray(legendre_table(x, max_l).astype(dtype))
  phi = np.deg2rad(lon)
  m = np.arange(max_l + 1)[:, None]
  four = np.stack([np.cos(m * phi[None]), np.sin(m * phi[None])])
  return SphericalHarmonicBasis(
      legendre=leg,
      fourier=jnp.asarray(four.astype(dtype)),
      max_l=max_l)


def basis_for_grid(lat_deg: Sequence[float], lon_deg: Sequence[float],
                   max_l: int | None = None,
                   dtype=np.float32) -> SphericalHarmonicBasis:
  """Basis resolving wavenumbers up to max_l (default: num_lon//2 - 1,
  the maximum the grid resolves — matching the reference's choice
  (gencast/samplers_utils.py:86, 336)).

  The Legendre table is computed on device (scaled-f32 recursion, ~1.5e-3
  relative drift at L=719 vs the f64-exact numpy path) only when BOTH the
  scale warrants it (max_l >= 256, where the host table and its upload
  are large) AND the storage dtype is reduced precision (bf16, whose
  quantization already dominates the recursion drift). f32 bases keep the
  f64-exact host table at any scale. GENCAST_SH_DEVICE_TABLE=0/1 forces
  the choice; the flag is resolved here so it participates in the cache
  key (toggling it mid-process yields the right table, not a stale one).
  """
  lon = tuple(float(v) for v in lon_deg)
  lat = tuple(float(v) for v in lat_deg)
  if max_l is None:
    max_l = len(lon) // 2 - 1
  dt = np.dtype(dtype)
  env = os.environ.get('GENCAST_SH_DEVICE_TABLE')
  if env is not None:
    on_device = bool(int(env))
  else:
    on_device = max_l >= _DEVICE_TABLE_MIN_L and dt.itemsize < 4
  return _basis_cached(lat, lon, max_l, dt.name, on_device)


def synthesize(coeffs: jnp.ndarray,
               basis: SphericalHarmonicBasis) -> jnp.ndarray:
  """Inverse transform: [..., 2, L+1, L+1] (s=cos/sin, l, m) -> [..., lat, lon].

  With a reduced-precision basis (e.g. bf16, halving the 1.5GB Legendre
  table at 0.25 degrees) the contractions still accumulate in f32 on the
  MXU and the result is returned at the coefficients' dtype.
  """
  out_dtype = coeffs.dtype
  bt = basis.legendre.dtype
  acc = {'preferred_element_type': jnp.float32} if bt != out_dtype else {}
  # Contract l: [..., s, m, lat]
  g = jnp.einsum('...slm,lmj->...smj', coeffs.astype(bt), basis.legendre,
                 **acc)
  # Contract m and s: [..., lat, lon]
  return jnp.einsum('...smj,smi->...ji', g.astype(bt), basis.fourier,
                    **acc).astype(out_dtype)


def sample_isotropic(key: jax.Array,
                     power_spectrum: jnp.ndarray,
                     batch_shape: Tuple[int, ...],
                     basis: SphericalHarmonicBasis,
                     dtype=jnp.float32) -> jnp.ndarray:
  """Isotropic GP noise with the given spectrum, shape [*batch, lat, lon].

  power_spectrum: [L+1] desired power per total wavenumber; the pointwise
  marginal variance of the result is sum(power_spectrum).
  """
  lmax = basis.max_l
  l_idx = jnp.arange(lmax + 1)
  m_idx = jnp.arange(lmax + 1)
  power = power_spectrum.astype(jnp.float32)
  # Std per (l) basis function; valid coefficients: m <= l, and for m == 0
  # only the cos (s=0) entry.
  sigma_l = jnp.sqrt(4.0 * jnp.pi * power / (2.0 * l_idx + 1.0))
  tri = (m_idx[None, :] <= l_idx[:, None]).astype(jnp.float32)  # [L+1, L+1]
  sin_mask = tri * (m_idx[None, :] > 0)
  mask = jnp.stack([tri, sin_mask])  # [2, L+1, L+1]
  scale = mask * sigma_l[None, :, None]
  z = jax.random.normal(key, batch_shape + scale.shape, dtype=jnp.float32)
  return synthesize(z * scale, basis).astype(dtype)


def unit_white_noise(key: jax.Array, batch_shape: Tuple[int, ...],
                     basis: SphericalHarmonicBasis,
                     dtype=jnp.float32) -> jnp.ndarray:
  """Unit-marginal-variance isotropic noise with a flat power spectrum
  (the reference's spherical_white_noise_like,
  gencast/samplers_utils.py:333-346)."""
  n = basis.max_l + 1
  power = jnp.full((n,), 1.0 / n, dtype=jnp.float32)
  return sample_isotropic(key, power, batch_shape, basis, dtype=dtype)
