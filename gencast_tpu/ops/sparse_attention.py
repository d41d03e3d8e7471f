"""Block-sparse flash attention over the k-hop mesh mask (Pallas, Triton).

The RCM-permuted mesh gives a banded k-hop mask, but inside the band only
a fraction of the (q tile, kv tile) pairs hold any allowed entry. The
graph compiler emits a `TilePlan`: for each query tile, the list of key/
value tiles with any unmasked entry and the index of the pair's exact
boolean mask tile; for each kv tile, the reverse list. Masked-out tiles
are never read.

Kernels, each one program per (tile, batch, head) so that a 1-degree
mesh (161 q tiles x 4 heads at tile 64) fills the card's SMs:

* forward: an online-softmax flash loop. A `fori_loop` inside the block
  walks the q tile's active kv list; the block loads its own kv and pair
  ids, and the trip count is the tile's own number of active pairs.
* dq: the same walk, recomputing probabilities from the saved row
  logsumexp.
* dk/dv: one program per kv tile, walking the reverse list.

Precision: bf16 operands go to the tensor cores with f32 accumulation
(`pl.dot` with the default precision); f32 operands ask for
`Precision.HIGHEST`, which Triton lowers to IEEE f32 products (no TF32),
so the f32 path matches the plain reference to f32 round-off. Softmax
arithmetic is f32 in both cases.

The kernels compile for the GPU only. `interpret=True`, which the tests
pass, runs them on the CPU through the Pallas interpreter; without it any
other backend raises.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

NEG_INF = -1e30
# Tile edge of the production plans: a power of two (Triton's block
# shapes) chosen by measurement on an H100 (see PERF.md, "Kernel
# decisions at bring-up").
TILE = 64
_LOG2E = math.log2(math.e)


# ---------------------------------------------------------------------------
# Host-side tile plan.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TilePlan:
  """Static block-sparsity structure of the attention mask.

  mask_tiles: [P + 1, tile, tile] uint8, rows = queries, cols = keys;
    index P is an all-zero pad tile.
  fwd_kv_ids / fwd_pair_ids: [nq, A] kv tile and mask-tile index per
    (q tile, active slot); fwd_counts [nq] the number of valid slots.
  bwd_q_ids / bwd_pair_ids / bwd_counts: the reverse lists, per kv tile.
  Slots past a tile's count repeat its last id and point at the pad tile.
  """
  tile: int
  padded_n: int
  mask_tiles: np.ndarray
  fwd_kv_ids: np.ndarray
  fwd_pair_ids: np.ndarray
  fwd_counts: np.ndarray
  bwd_q_ids: np.ndarray
  bwd_pair_ids: np.ndarray
  bwd_counts: np.ndarray

  @property
  def num_q_tiles(self) -> int:
    return self.fwd_kv_ids.shape[0]

  @property
  def num_active_fwd(self) -> int:
    return self.fwd_kv_ids.shape[1]

  @property
  def num_active_bwd(self) -> int:
    return self.bwd_q_ids.shape[1]

  def device_arrays(self) -> Tuple[jnp.ndarray, ...]:
    """Traced kernel operands, in `sparse_banded_attention`'s order."""
    return tuple(jnp.asarray(a) for a in (
        self.mask_tiles, self.fwd_kv_ids, self.fwd_pair_ids,
        self.fwd_counts, self.bwd_q_ids, self.bwd_pair_ids,
        self.bwd_counts))


def build_tile_plan(mask_csr, tile: int = TILE) -> TilePlan:
  """Builds the plan from a scipy boolean mask [n, n]."""
  n = mask_csr.shape[0]
  nt = -(-n // tile)
  coo = mask_csr.tocoo()
  rows = coo.row.astype(np.int64)
  cols = coo.col.astype(np.int64)
  # Pair index of every nonzero; pairs come out sorted by (q tile, kv tile).
  pairs, inverse = np.unique((rows // tile) * nt + cols // tile,
                             return_inverse=True)
  num_pairs = pairs.shape[0]
  mask_tiles = np.zeros((num_pairs + 1, tile, tile), np.uint8)
  mask_tiles[inverse, rows % tile, cols % tile] = 1
  pair_q = (pairs // nt).astype(np.int32)
  pair_kv = (pairs % nt).astype(np.int32)
  pair_id = np.arange(num_pairs, dtype=np.int32)

  def lists(key, other):
    order = np.lexsort((other, key))
    key, other, pid = key[order], other[order], pair_id[order]
    counts = np.bincount(key, minlength=nt).astype(np.int32)
    width = max(1, int(counts.max()))
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    slot = np.arange(key.shape[0]) - starts[key]
    ids = np.zeros((nt, width), np.int32)
    pids = np.full((nt, width), num_pairs, np.int32)
    ids[key, slot] = other
    pids[key, slot] = pid
    # Pad slots repeat the tile's last id (never read: loops stop at count).
    last = ids[np.arange(nt), np.maximum(counts - 1, 0)]
    pad = np.arange(width)[None, :] >= counts[:, None]
    ids = np.where(pad, last[:, None], ids)
    return ids, pids, counts

  fwd_kv, fwd_pid, fwd_cnt = lists(pair_q, pair_kv)
  bwd_q, bwd_pid, bwd_cnt = lists(pair_kv, pair_q)
  return TilePlan(tile=tile, padded_n=nt * tile, mask_tiles=mask_tiles,
                  fwd_kv_ids=fwd_kv, fwd_pair_ids=fwd_pid,
                  fwd_counts=fwd_cnt, bwd_q_ids=bwd_q, bwd_pair_ids=bwd_pid,
                  bwd_counts=bwd_cnt)


# ---------------------------------------------------------------------------
# Kernels. Refs: q/k/v/do are [Np, d] for one (batch, head) or one tile
# of it; lse/delta are [Np] or [tile]; ids/counts/mask tiles are whole.
# ---------------------------------------------------------------------------


def _dot(a, b, precision, trans_a=False, trans_b=False):
  return pl.dot(a, b, trans_a=trans_a, trans_b=trans_b, precision=precision)


def _rows(tile_id, tile):
  return pl.ds(pl.multiple_of(tile_id * tile, tile), tile)


def _fwd_kernel(kv_ids_ref, pair_ids_ref, counts_ref, mask_ref, q_ref,
                k_ref, v_ref, o_ref, lse_ref, *, tile, scale, precision):
  qi = pl.program_id(0)
  q = q_ref[...]
  d = q.shape[-1]

  def body(a, carry):
    acc, m_prev, l_prev = carry
    rows = _rows(kv_ids_ref[qi, a], tile)
    k = k_ref[rows, :]
    v = v_ref[rows, :]
    mask = mask_ref[pair_ids_ref[qi, a], :, :] != 0
    # Logits in log2 units (scale folds in log2(e)): exp2 is the cheap
    # transcendental on the GPU.
    s = _dot(q, k, precision, trans_b=True) * scale
    s = jnp.where(mask, s, NEG_INF)
    m_new = jnp.maximum(m_prev, s.max(axis=1))
    alpha = jnp.exp2(m_prev - m_new)
    # Explicit `where`: a row with nothing allowed so far has m == NEG_INF
    # and must still contribute 0.
    p = jnp.where(mask, jnp.exp2(s - m_new[:, None]), 0.0)
    l_new = l_prev * alpha + p.sum(axis=1)
    acc = acc * alpha[:, None] + _dot(p.astype(v.dtype), v, precision)
    return acc, m_new, l_new

  init = (jnp.zeros((tile, d), jnp.float32),
          jnp.full((tile,), NEG_INF, jnp.float32),
          jnp.zeros((tile,), jnp.float32))
  acc, m, l = jax.lax.fori_loop(0, counts_ref[qi], body, init)
  # Fully masked rows (node padding) have l == 0: output 0, and a
  # logsumexp so low that the backward's probabilities are exactly 0.
  l = jnp.maximum(l, 1e-30)
  o_ref[...] = (acc / l[:, None]).astype(o_ref.dtype)
  lse_ref[...] = m + jnp.log2(l)


def _dq_kernel(kv_ids_ref, pair_ids_ref, counts_ref, mask_ref, q_ref,
               k_ref, v_ref, do_ref, lse_ref, delta_ref, dq_ref, *, tile,
               scale, sm_scale, precision):
  qi = pl.program_id(0)
  q = q_ref[...]
  do = do_ref[...]
  lse = lse_ref[...]
  delta = delta_ref[...]

  def body(a, dq):
    rows = _rows(kv_ids_ref[qi, a], tile)
    k = k_ref[rows, :]
    v = v_ref[rows, :]
    mask = mask_ref[pair_ids_ref[qi, a], :, :] != 0
    s = _dot(q, k, precision, trans_b=True) * scale
    p = jnp.where(mask, jnp.exp2(s - lse[:, None]), 0.0)
    dp = _dot(do, v, precision, trans_b=True)
    ds = p * (dp - delta[:, None])
    return dq + _dot(ds.astype(k.dtype), k, precision)

  dq = jax.lax.fori_loop(0, counts_ref[qi], body,
                         jnp.zeros(q.shape, jnp.float32))
  dq_ref[...] = (dq * sm_scale).astype(dq_ref.dtype)


def _dkv_kernel(q_ids_ref, pair_ids_ref, counts_ref, mask_ref, k_ref,
                v_ref, q_ref, do_ref, lse_ref, delta_ref, dk_ref, dv_ref, *,
                tile, scale, sm_scale, precision):
  kj = pl.program_id(0)
  k = k_ref[...]
  v = v_ref[...]

  def body(a, carry):
    dk, dv = carry
    rows = _rows(q_ids_ref[kj, a], tile)
    q = q_ref[rows, :]
    do = do_ref[rows, :]
    lse = lse_ref[rows]
    delta = delta_ref[rows]
    mask = mask_ref[pair_ids_ref[kj, a], :, :] != 0   # [q rows, kv cols]
    s = _dot(q, k, precision, trans_b=True) * scale
    p = jnp.where(mask, jnp.exp2(s - lse[:, None]), 0.0)
    dv = dv + _dot(p.astype(do.dtype), do, precision, trans_a=True)
    dp = _dot(do, v, precision, trans_b=True)
    ds = p * (dp - delta[:, None])
    dk = dk + _dot(ds.astype(q.dtype), q, precision, trans_a=True)
    return dk, dv

  zeros = jnp.zeros(k.shape, jnp.float32)
  dk, dv = jax.lax.fori_loop(0, counts_ref[kj], body, (zeros, zeros))
  dk_ref[...] = (dk * sm_scale).astype(dk_ref.dtype)
  dv_ref[...] = dv.astype(dv_ref.dtype)


# ---------------------------------------------------------------------------
# pallas_call wrappers + custom VJP.
# ---------------------------------------------------------------------------


def _check(q, tile: int, interpret: bool):
  if not interpret and jax.default_backend() != 'gpu':
    raise ValueError(
        'sparse_banded_attention compiles for the GPU only; on '
        f'{jax.default_backend()!r} pass interpret=True (tests) or use the '
        "'triblock' attention backend")
  d = q.shape[-1]
  for name, v in (('tile', tile), ('head_dim', d)):
    if v & (v - 1):
      raise ValueError(f'{name}={v} must be a power of two (Triton blocks)')


def _precision(dtype):
  return (jax.lax.Precision.HIGHEST if dtype == jnp.float32
          else jax.lax.Precision.DEFAULT)


def _params(tile: int):
  return plgpu.CompilerParams(num_warps=4 if tile <= 64 else 8,
                              num_stages=2)


def _whole(x):
  return pl.BlockSpec(x.shape, lambda *_: (0,) * x.ndim)


def _tile_spec(t, d):
  return pl.BlockSpec((None, t, None, d), lambda i, b, h: (b, i, h, 0))


def _seq_spec(n, d):
  return pl.BlockSpec((None, n, None, d), lambda i, b, h: (b, 0, h, 0))


def _pad_nodes(x, padded_n):
  """[B, N, ...] -> [B, padded_n, ...] (no-op when already padded)."""
  pad = padded_n - x.shape[1]
  if pad == 0:
    return x
  return jnp.pad(x, ((0, 0), (0, pad)) + ((0, 0),) * (x.ndim - 2))


def _fwd_impl(q, k, v, plan_arrays, tile, interpret):
  mask_tiles, fwd_ids, fwd_pids, fwd_cnt = plan_arrays[:4]
  b, n, h, d = q.shape
  nq = fwd_ids.shape[0]
  np_ = nq * tile
  q, k, v = (_pad_nodes(x, np_) for x in (q, k, v))
  o, lse = pl.pallas_call(
      functools.partial(_fwd_kernel, tile=tile, scale=d ** -0.5 * _LOG2E,
                        precision=_precision(q.dtype)),
      grid=(nq, b, h),
      in_specs=[_whole(fwd_ids), _whole(fwd_pids), _whole(fwd_cnt),
                _whole(mask_tiles), _tile_spec(tile, d), _seq_spec(np_, d),
                _seq_spec(np_, d)],
      out_specs=[_tile_spec(tile, d),
                 pl.BlockSpec((None, None, tile), lambda i, b, h: (b, h, i))],
      out_shape=[jax.ShapeDtypeStruct(q.shape, q.dtype),
                 jax.ShapeDtypeStruct((b, h, np_), jnp.float32)],
      compiler_params=_params(tile),
      interpret=interpret,
      name='sparse_attention_fwd',
  )(fwd_ids, fwd_pids, fwd_cnt, mask_tiles, q, k, v)
  return o, lse, (q, k, v)


@functools.partial(jax.custom_vjp, nondiff_argnums=(4, 5))
def sparse_banded_attention(q, k, v, plan_arrays, tile: int,
                            interpret: bool = False):
  """Block-sparse attention; q/k/v [B, N, H, d] -> [B, N, H, d].

  plan_arrays is `TilePlan.device_arrays()` of a plan built at `tile`.
  N may already be padded to the plan's padded_n (padding rows are fully
  masked and come back as zeros).
  """
  _check(q, tile, interpret)
  o, _, _ = _fwd_impl(q, k, v, plan_arrays, tile, interpret)
  return o[:, :q.shape[1]]


def _sba_fwd(q, k, v, plan_arrays, tile, interpret):
  _check(q, tile, interpret)
  o, lse, qkv = _fwd_impl(q, k, v, plan_arrays, tile, interpret)
  return o[:, :q.shape[1]], (qkv, o, lse, plan_arrays, q.shape[1])


def _sba_bwd(tile, interpret, res, dout):
  (q, k, v), o, lse, plan_arrays, n = res
  mask_tiles, fwd_ids, fwd_pids, fwd_cnt, bwd_ids, bwd_pids, bwd_cnt = (
      plan_arrays)
  b, np_, h, d = q.shape
  nq = np_ // tile
  do = _pad_nodes(dout, np_)
  delta = jnp.einsum('bnhd,bnhd->bhn', do.astype(jnp.float32),
                     o.astype(jnp.float32))
  kw = dict(tile=tile, scale=d ** -0.5 * _LOG2E, sm_scale=d ** -0.5,
            precision=_precision(q.dtype))
  vec_tile = pl.BlockSpec((None, None, tile), lambda i, b, h: (b, h, i))
  vec_seq = pl.BlockSpec((None, None, np_), lambda i, b, h: (b, h, 0))

  dq = pl.pallas_call(
      functools.partial(_dq_kernel, **kw),
      grid=(nq, b, h),
      in_specs=[_whole(fwd_ids), _whole(fwd_pids), _whole(fwd_cnt),
                _whole(mask_tiles), _tile_spec(tile, d), _seq_spec(np_, d),
                _seq_spec(np_, d), _tile_spec(tile, d), vec_tile, vec_tile],
      out_specs=_tile_spec(tile, d),
      out_shape=jax.ShapeDtypeStruct(q.shape, q.dtype),
      compiler_params=_params(tile),
      interpret=interpret,
      name='sparse_attention_dq',
  )(fwd_ids, fwd_pids, fwd_cnt, mask_tiles, q, k, v, do, lse, delta)

  dk, dv = pl.pallas_call(
      functools.partial(_dkv_kernel, **kw),
      grid=(nq, b, h),
      in_specs=[_whole(bwd_ids), _whole(bwd_pids), _whole(bwd_cnt),
                _whole(mask_tiles), _tile_spec(tile, d), _tile_spec(tile, d),
                _seq_spec(np_, d), _seq_spec(np_, d), vec_seq, vec_seq],
      out_specs=[_tile_spec(tile, d), _tile_spec(tile, d)],
      out_shape=[jax.ShapeDtypeStruct(k.shape, k.dtype),
                 jax.ShapeDtypeStruct(v.shape, v.dtype)],
      compiler_params=_params(tile),
      interpret=interpret,
      name='sparse_attention_dkv',
  )(bwd_ids, bwd_pids, bwd_cnt, mask_tiles, k, v, q, do, lse, delta)

  return dq[:, :n], dk[:, :n], dv[:, :n], None


sparse_banded_attention.defvjp(_sba_fwd, _sba_bwd)
