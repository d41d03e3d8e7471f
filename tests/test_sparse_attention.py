"""Block-sparse flash attention (tile plan) vs the dense oracle.

The kernels run through the Pallas interpreter here (`interpret=True`);
`tests/test_gpu.py` runs them compiled on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from scipy import sparse as sp

from gencast_tpu.ops import sparse_attention as sa


def _random_banded_csr(n, bw, seed, density=0.3):
  rng = np.random.default_rng(seed)
  rows, cols = [], []
  for i in range(n):
    lo, hi = max(0, i - bw), min(n, i + bw + 1)
    cand = np.arange(lo, hi)
    sel = cand[rng.random(cand.size) < density]
    sel = np.union1d(sel, [i])  # self edges always
    rows.extend([i] * len(sel))
    cols.extend(sel.tolist())
  m = sp.csr_matrix((np.ones(len(rows), bool), (rows, cols)), shape=(n, n))
  return m


def _dense_oracle(q, k, v, mask_dense):
  d = q.shape[-1]
  q, k, v = (x.astype(jnp.float32) for x in (q, k, v))
  logits = jnp.einsum('bqhd,bkhd->bhqk', q, k,
                      precision='highest') * d ** -0.5
  logits = jnp.where(jnp.asarray(mask_dense)[None, None], logits, -1e30)
  w = jax.nn.softmax(logits, axis=-1)
  return jnp.einsum('bhqk,bkhd->bqhd', w, v, precision='highest')


def _qkvc(b, n, h, d, seed):
  ks = jax.random.split(jax.random.PRNGKey(seed), 4)
  return [jax.random.normal(k, (b, n, h, d)) for k in ks]


def _attn(plan):
  arrs = plan.device_arrays()

  def f(q, k, v):
    return sa.sparse_banded_attention(q, k, v, arrs, plan.tile, True)
  return f


@pytest.mark.parametrize("n,bw,tile", [(96, 20, 16), (128, 40, 32)])
def test_forward_matches_oracle(n, bw, tile):
  csr = _random_banded_csr(n, bw, seed=0)
  plan = sa.build_tile_plan(csr, tile=tile)
  q, k, v, _ = _qkvc(2, n, 2, 32, seed=1)
  got = _attn(plan)(q, k, v)
  want = _dense_oracle(q, k, v, csr.toarray())
  np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                             atol=1e-5, rtol=1e-5)


def test_gradients_match_oracle():
  n, bw, tile = 96, 24, 16
  csr = _random_banded_csr(n, bw, seed=2)
  plan = sa.build_tile_plan(csr, tile=tile)
  q, k, v, cot = _qkvc(1, n, 2, 32, seed=3)
  attn = _attn(plan)

  def f_kernel(q, k, v):
    return (attn(q, k, v) * cot).sum()

  def f_ref(q, k, v):
    return (_dense_oracle(q, k, v, csr.toarray()) * cot).sum()

  gp = jax.grad(f_kernel, argnums=(0, 1, 2))(q, k, v)
  gr = jax.grad(f_ref, argnums=(0, 1, 2))(q, k, v)
  for a, b, name in zip(gp, gr, 'qkv'):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                               atol=2e-5, rtol=2e-5, err_msg=f'd{name}')


def test_bf16_inputs_match_f32_oracle_loosely():
  """bf16 operands (Bfloat16Cast models) run the dots at input dtype with
  f32 accumulation; outputs/grads must track the f32 oracle at bf16
  tolerance and keep bf16 dtypes."""
  n, bw, tile = 96, 24, 16
  csr = _random_banded_csr(n, bw, seed=5)
  plan = sa.build_tile_plan(csr, tile=tile)
  q, k, v, cot = _qkvc(1, n, 2, 32, seed=6)
  attn = _attn(plan)

  def run(dtype):
    def f(q, k, v):
      return (attn(q.astype(dtype), k.astype(dtype), v.astype(dtype))
              .astype(jnp.float32) * cot).sum()
    out = attn(q.astype(dtype), k.astype(dtype), v.astype(dtype))
    return out, jax.grad(f, argnums=(0, 1, 2))(q, k, v)

  out16, g16 = run(jnp.bfloat16)
  out32, g32 = run(jnp.float32)
  assert out16.dtype == jnp.bfloat16
  scale = float(jnp.abs(out32).max())
  np.testing.assert_allclose(
      np.asarray(out16, np.float32), np.asarray(out32),
      atol=0.03 * scale, rtol=0.05)
  for a, b, name in zip(g16, g32, 'qkv'):
    s = float(jnp.abs(b).max())
    np.testing.assert_allclose(np.asarray(a, np.float32), np.asarray(b),
                               atol=0.05 * s, rtol=0.1,
                               err_msg=f'd{name}')


# Tile, band half-width, batch, heads, dtype: forward and all three
# gradients against the f32 dense oracle. bf16 keeps the 3e-2-of-max
# bound of the test above (bf16 operands, f32 accumulation).
@pytest.mark.parametrize('tile,bw,b,h,dtype', [
    (16, 8, 1, 1, jnp.float32),
    (16, 40, 2, 2, jnp.float32),
    (32, 20, 1, 4, jnp.float32),
    (32, 64, 2, 1, jnp.float32),
    (16, 24, 1, 2, jnp.bfloat16),
    (32, 40, 2, 2, jnp.bfloat16),
])
def test_kernel_matches_oracle_fwd_and_grad(tile, bw, b, h, dtype):
  n = 80   # not a multiple of the tile: the wrapper pads the node axis
  csr = _random_banded_csr(n, bw, seed=tile + bw)
  plan = sa.build_tile_plan(csr, tile=tile)
  q, k, v, cot = _qkvc(b, n, h, 16, seed=bw)
  attn = _attn(plan)
  mask = csr.toarray()

  def f(fn, q, k, v):
    out = fn(q.astype(dtype), k.astype(dtype), v.astype(dtype))
    return (out.astype(jnp.float32) * cot).sum(), out

  (_, out), g = jax.value_and_grad(
      lambda *a: f(attn, *a), argnums=(0, 1, 2), has_aux=True)(q, k, v)
  (_, ref), gr = jax.value_and_grad(
      lambda *a: f(lambda *x: _dense_oracle(*x, mask), *a),
      argnums=(0, 1, 2), has_aux=True)(q, k, v)
  assert out.shape == (b, n, h, 16) and out.dtype == dtype
  tol = 2e-5 if dtype == jnp.float32 else 3e-2
  for name, a, r in [('out', out, ref)] + list(zip('qkv', g, gr)):
    a = np.asarray(a, np.float32)
    r = np.asarray(r, np.float32)
    assert np.abs(a - r).max() <= tol * np.abs(r).max(), name


@pytest.mark.parametrize('dtype', [jnp.float32, jnp.bfloat16])
def test_fully_masked_rows_give_zero_output_and_gradients(dtype):
  """Rows with no allowed key (node padding) come back as exact zeros,
  and no gradient flows into or out of them."""
  n, tile = 48, 16
  csr = _random_banded_csr(n, 8, seed=9).tolil()
  dead = [5, 30, 31]
  for i in dead:
    csr[i, :] = False
    csr[:, i] = False
  csr = csr.tocsr()
  csr.eliminate_zeros()
  plan = sa.build_tile_plan(csr, tile=tile)
  q, k, v, cot = _qkvc(1, n, 2, 16, seed=10)
  q, k, v = (x.astype(dtype) for x in (q, k, v))
  attn = _attn(plan)
  out = attn(q, k, v)
  assert not np.asarray(out[:, dead], np.float32).any()

  def loss(q, k, v):
    return (attn(q, k, v).astype(jnp.float32) * cot).sum()

  for g in jax.grad(loss, argnums=(0, 1, 2))(q, k, v):
    assert np.isfinite(np.asarray(g, np.float32)).all()
    assert not np.asarray(g[:, dead], np.float32).any()


def test_refuses_other_backends_without_interpret():
  plan = sa.build_tile_plan(_random_banded_csr(32, 4, seed=0), tile=16)
  q = jnp.zeros((1, 32, 1, 16))
  with pytest.raises(ValueError, match='GPU only'):
    sa.sparse_banded_attention(q, q, q, plan.device_arrays(), 16)


@pytest.mark.parametrize('tile,d', [(24, 16), (16, 24)])
def test_rejects_non_power_of_two_blocks(tile, d):
  plan = sa.build_tile_plan(_random_banded_csr(48, 4, seed=0), tile=tile)
  q = jnp.zeros((1, 48, 1, d))
  with pytest.raises(ValueError, match='power of two'):
    sa.sparse_banded_attention(q, q, q, plan.device_arrays(), tile, True)


def test_plan_lists_are_consistent():
  """Forward and backward lists name the same pairs; pad slots repeat the
  last id and point at the all-zero pad tile."""
  n, tile = 200, 32
  plan = sa.build_tile_plan(_random_banded_csr(n, 50, seed=11), tile=tile)
  pad = plan.mask_tiles.shape[0] - 1
  assert not plan.mask_tiles[pad].any()
  fwd, bwd = set(), set()
  for qi in range(plan.num_q_tiles):
    c = plan.fwd_counts[qi]
    assert (plan.fwd_pair_ids[qi, c:] == pad).all()
    assert (plan.fwd_kv_ids[qi, c:] == plan.fwd_kv_ids[qi, max(c - 1, 0)]
            ).all()
    fwd |= {(qi, int(kv), int(p)) for kv, p in
            zip(plan.fwd_kv_ids[qi, :c], plan.fwd_pair_ids[qi, :c])}
  for kj in range(plan.num_q_tiles):
    c = plan.bwd_counts[kj]
    assert (plan.bwd_pair_ids[kj, c:] == pad).all()
    bwd |= {(int(qi), kj, int(p)) for qi, p in
            zip(plan.bwd_q_ids[kj, :c], plan.bwd_pair_ids[kj, :c])}
  assert fwd == bwd and len(fwd) == pad


def test_plan_skips_empty_tiles():
  """The plan's active count must be well under dense for a sparse band."""
  n, bw, tile = 512, 32, 64
  csr = _random_banded_csr(n, bw, seed=4, density=0.5)
  plan = sa.build_tile_plan(csr, tile=tile)
  assert plan.num_active_fwd < n // tile  # far fewer than dense tiles
  # Every nonzero is covered by some pair tile.
  coo = csr.tocoo()
  covered = set()
  for qi in range(plan.num_q_tiles):
    for a in range(plan.fwd_counts[qi]):
      covered.add((qi, int(plan.fwd_kv_ids[qi, a])))
  for r, c in zip(coo.row, coo.col):
    assert (r // tile, c // tile) in covered


def test_transformer_pallas_backend_matches_triblock():
  """End-to-end: MeshTransformer 'pallas' == 'triblock' with same weights."""
  from gencast_tpu.graph import compiler
  from gencast_tpu.nn import nnx
  from gencast_tpu.nn import transformer as tr

  lat = np.arange(-90.0, 90.0 + 1e-6, 15.0, dtype=np.float32)
  lon = np.arange(0.0, 360.0, 15.0, dtype=np.float32)
  statics = compiler.build_graph_statics(2, lat, lon, attention_k_hop=4,
                                         attention_tile_size=32)

  def cfg(attn):
    return tr.TransformerConfig(d_model=32, num_layers=2, num_heads=2,
                                ffw_hidden=64, attention_type=attn,
                                ffw_winit_final_mult=1.0,
                                attn_winit_final_mult=1.0,
                                interpret=attn == 'pallas')

  tri = tr.MeshTransformer(cfg('triblock'), statics.attention_mask,
                           rngs=nnx.Rngs(0))
  pal = tr.MeshTransformer(cfg('pallas'), statics.attention_mask,
                           tile_plan=statics.attention_tile_plan,
                           rngs=nnx.Rngs(0))
  n = statics.num_mesh_nodes
  x = jax.random.normal(jax.random.PRNGKey(1), (n, 2, 32))
  cond = jax.random.normal(jax.random.PRNGKey(2), (2, 16))
  np.testing.assert_allclose(np.asarray(pal(x, cond)),
                             np.asarray(tri(x, cond)),
                             atol=2e-5, rtol=2e-5)
