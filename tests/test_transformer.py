"""Transformer tests: the triblock banded path must match dense attention."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from gencast_tpu.nn import nnx
from scipy import sparse

from gencast_tpu.graph import compiler, icosahedron
from gencast_tpu.nn import transformer as tr


def _statics(splits=2, k_hop=4):
  lat = np.arange(-90.0, 90.0 + 1e-6, 15.0, dtype=np.float32)
  lon = np.arange(0.0, 360.0, 15.0, dtype=np.float32)
  return compiler.build_graph_statics(splits, lat, lon,
                                      attention_k_hop=k_hop)


def _dense_khop_mask(statics):
  s, r = statics.mesh_edges.senders, statics.mesh_edges.receivers
  n = statics.num_mesh_nodes
  adj = sparse.csr_matrix((np.ones_like(s, bool), (s, r)), shape=(n, n))
  adj = (adj + sparse.identity(n, dtype=bool, format='csr')).astype(bool)
  return np.linalg.matrix_power(
      adj.toarray().astype(np.int64), statics.attention_k_hop) > 0


@pytest.fixture(scope="module")
def statics():
  return _statics()


def _cfg(attention_type, num_layers=2):
  return tr.TransformerConfig(
      d_model=32, num_layers=num_layers, num_heads=4, ffw_hidden=64,
      attention_type=attention_type,
      # nonzero final inits so attention output is nontrivial.
      ffw_winit_final_mult=1.0, attn_winit_final_mult=1.0)


def test_triblock_matches_dense(statics):
  dense_mask = _dense_khop_mask(statics)
  n = statics.num_mesh_nodes
  x = jax.random.normal(jax.random.PRNGKey(1), (n, 2, 32))
  cond = jax.random.normal(jax.random.PRNGKey(2), (2, 16))

  dense = tr.MeshTransformer(_cfg('dense'), None, dense_mask=dense_mask,
                             rngs=nnx.Rngs(0))
  tri = tr.MeshTransformer(_cfg('triblock'), statics.attention_mask,
                           rngs=nnx.Rngs(0))
  out_d = dense(x, cond)
  out_t = tri(x, cond)
  assert out_d.shape == (n, 2, 32)
  np.testing.assert_allclose(np.asarray(out_t), np.asarray(out_d),
                             atol=2e-5, rtol=2e-5)


def test_triblock_gradients_finite(statics):
  model = tr.MeshTransformer(_cfg('triblock', num_layers=1),
                             statics.attention_mask, rngs=nnx.Rngs(0))
  n = statics.num_mesh_nodes
  x = jax.random.normal(jax.random.PRNGKey(3), (n, 1, 32))
  cond = jnp.zeros((1, 16))

  def loss_fn(m):
    return (m(x, cond) ** 2).mean()

  grads = nnx.grad(loss_fn)(model)
  leaves = jax.tree_util.tree_leaves(grads)
  assert leaves
  assert all(bool(jnp.isfinite(g).all()) for g in leaves)


def test_masked_positions_do_not_leak(statics):
  """Output at node i must not depend on nodes outside its k-hop set."""
  dense_mask = _dense_khop_mask(statics)
  model = tr.MeshTransformer(_cfg('triblock', num_layers=1),
                             statics.attention_mask, rngs=nnx.Rngs(0))
  n = statics.num_mesh_nodes
  x = jax.random.normal(jax.random.PRNGKey(4), (n, 1, 32))
  cond = jnp.zeros((1, 16))
  out1 = model(x, cond)
  # Perturb one node; only nodes attending to it may change.
  j = n // 2
  x2 = x.at[j].add(1.0)
  out2 = model(x2, cond)
  changed = np.abs(np.asarray(out2 - out1)).max(axis=(1, 2)) > 1e-7
  allowed = dense_mask[:, j] | (np.arange(n) == j)
  assert not np.any(changed & ~allowed)


def test_bf16_path_runs(statics):
  model = tr.MeshTransformer(_cfg('triblock', num_layers=1),
                             statics.attention_mask, rngs=nnx.Rngs(0))
  n = statics.num_mesh_nodes
  x = jax.random.normal(jax.random.PRNGKey(5), (n, 1, 32),
                        dtype=jnp.bfloat16)
  out = model(x, jnp.zeros((1, 16), jnp.bfloat16))
  # f32 params promote bf16 activations; a full mixed-precision policy
  # (param casting) is handled at the model level, not here.
  assert out.shape == (n, 1, 32)
  assert bool(jnp.isfinite(out.astype(jnp.float32)).all())


@pytest.mark.parametrize('attention_type', ['triblock', 'pallas'])
def test_save_attention_remat_matches_full(statics, attention_type):
  # remat_policy='save_attention' is a scheduling choice only: outputs and
  # gradients must be identical (up to roundoff) to full remat.
  n = statics.num_mesh_nodes
  x = jax.random.normal(jax.random.PRNGKey(4), (n, 2, 32))
  cond = jax.random.normal(jax.random.PRNGKey(5), (2, 16))

  def build(policy):
    cfg = dataclasses.replace(_cfg(attention_type),
                              use_gradient_checkpointing=True,
                              remat_policy=policy,
                              interpret=attention_type == 'pallas')
    mask = statics.attention_mask
    kw = {}
    if attention_type == 'pallas':
      kw['tile_plan'] = compiler_tile_plan(statics)
    return tr.MeshTransformer(cfg, mask, rngs=nnx.Rngs(0), **kw)

  def compiler_tile_plan(st):
    from gencast_tpu.ops import sparse_attention
    from gencast_tpu.graph.compiler import khop_mask_csr
    csr = khop_mask_csr(st.mesh_edges.senders, st.mesh_edges.receivers,
                        st.num_mesh_nodes, st.attention_k_hop)
    return sparse_attention.build_tile_plan(csr, tile=64)

  outs, grads = [], []
  for policy in ('full', 'save_attention'):
    model = build(policy)
    def loss_fn(m):
      return (m(x, cond) ** 2).mean()
    outs.append(np.asarray(model(x, cond)))
    g = nnx.grad(loss_fn)(model)
    grads.append(jax.tree_util.tree_leaves(g))
  np.testing.assert_allclose(outs[0], outs[1], atol=1e-6, rtol=1e-6)
  for ga, gb in zip(grads[0], grads[1]):
    np.testing.assert_allclose(np.asarray(ga), np.asarray(gb),
                               atol=1e-5, rtol=1e-4)
