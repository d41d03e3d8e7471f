"""Streamed (chunked) edge processing must match the dense GNN path."""

from gencast_tpu.nn import nnx
import jax
import jax.numpy as jnp
import numpy as np

from gencast_tpu.graph import compiler
from gencast_tpu.nn import gnn


def _make(edge_chunk_size, statics, seed=0):
  latent = 16
  return gnn.TypedGraphNet(
      topologies=[gnn.EdgeTopology('g2m', 'grid', 'mesh',
                                   statics.grid2mesh.senders,
                                   statics.grid2mesh.receivers)],
      num_nodes={'grid': statics.num_grid_nodes,
                 'mesh': statics.num_mesh_nodes},
      node_input_sizes={'grid': 5, 'mesh': 3},
      edge_input_sizes={'g2m': 4},
      node_latent_size={'grid': latent, 'mesh': latent},
      edge_latent_size={'g2m': latent},
      mlp_hidden_size=latent, mlp_num_hidden_layers=1,
      num_message_passing_steps=1,
      f32_aggregation=True,
      aggregate_normalization=2.0,
      node_output_sizes={'mesh': 6},
      edge_chunk_size=edge_chunk_size,
      rngs=nnx.Rngs(seed))


def test_streaming_matches_dense():
  lat = np.arange(-90.0, 90.1, 30.0, dtype=np.float32)
  lon = np.arange(0.0, 360.0, 30.0, dtype=np.float32)
  statics = compiler.build_graph_statics(1, lat, lon,
                                         build_attention_mask=False)
  dense = _make(None, statics)
  # Chunk size that does NOT divide the edge count (pads the last chunk).
  chunked = _make(37, statics)
  nnx.update(chunked, nnx.state(dense, nnx.Param))

  rng = np.random.default_rng(1)
  b = 2
  nodes = {'grid': jnp.asarray(rng.standard_normal(
               (statics.num_grid_nodes, b, 5)), jnp.float32),
           'mesh': jnp.asarray(rng.standard_normal(
               (statics.num_mesh_nodes, b, 3)), jnp.float32)}
  edges = {'g2m': jnp.asarray(rng.standard_normal(
      (statics.grid2mesh.num_edges, b, 4)), jnp.float32)}
  cond = jnp.asarray(rng.standard_normal((b, 16)), jnp.float32)

  out_d, _ = dense(nodes, edges, cond)
  out_s, _ = chunked(nodes, edges, cond)
  for k in out_d:
    np.testing.assert_allclose(np.asarray(out_s[k]), np.asarray(out_d[k]),
                               atol=2e-5, rtol=2e-5, err_msg=k)


def _make_m2g(edge_chunk_size, statics, seed=0):
  """mesh2grid net: uniform receiver degree (3 senders per grid node),
  which the streaming path turns into scatter-free reshape-sums."""
  latent = 16
  return gnn.TypedGraphNet(
      topologies=[gnn.EdgeTopology('m2g', 'mesh', 'grid',
                                   statics.mesh2grid.senders,
                                   statics.mesh2grid.receivers)],
      num_nodes={'grid': statics.num_grid_nodes,
                 'mesh': statics.num_mesh_nodes},
      node_input_sizes={'grid': 5, 'mesh': 3},
      edge_input_sizes={'m2g': 4},
      node_latent_size={'grid': latent, 'mesh': latent},
      edge_latent_size={'m2g': latent},
      mlp_hidden_size=latent, mlp_num_hidden_layers=1,
      num_message_passing_steps=1,
      f32_aggregation=True,
      node_output_sizes={'grid': 6},
      edge_chunk_size=edge_chunk_size,
      rngs=nnx.Rngs(seed))


def test_streaming_uniform_degree_matches_dense():
  """The scatter-free uniform-degree streamed path (chunk rounded down to
  a degree multiple, receiver rows broadcast, reshape-sum aggregation)
  must match the dense path in outputs AND gradients."""
  lat = np.arange(-90.0, 90.1, 30.0, dtype=np.float32)
  lon = np.arange(0.0, 360.0, 30.0, dtype=np.float32)
  statics = compiler.build_graph_statics(1, lat, lon,
                                         build_attention_mask=False)
  assert statics.mesh2grid.num_edges == 3 * statics.num_grid_nodes
  dense = _make_m2g(None, statics)
  # 37 is not a multiple of the degree (3): the net must round the chunk
  # down to 36 so chunks hold whole receivers.
  chunked = _make_m2g(37, statics)
  assert chunked.stream_meta['m2g'] == (36, 3)
  nnx.update(chunked, nnx.state(dense, nnx.Param))

  rng = np.random.default_rng(3)
  b = 2
  nodes = {'grid': jnp.asarray(rng.standard_normal(
               (statics.num_grid_nodes, b, 5)), jnp.float32),
           'mesh': jnp.asarray(rng.standard_normal(
               (statics.num_mesh_nodes, b, 3)), jnp.float32)}
  edges = {'m2g': jnp.asarray(rng.standard_normal(
      (statics.mesh2grid.num_edges, b, 4)), jnp.float32)}
  cond = jnp.asarray(rng.standard_normal((b, 16)), jnp.float32)

  out_d, _ = dense(nodes, edges, cond)
  out_s, _ = chunked(nodes, edges, cond)
  for k in out_d:
    np.testing.assert_allclose(np.asarray(out_s[k]), np.asarray(out_d[k]),
                               atol=2e-5, rtol=2e-5, err_msg=k)

  def loss(m):
    out, _ = m(nodes, edges, cond)
    return (out['grid'] ** 2).mean() + (out['mesh'] ** 2).mean()

  gd = jax.tree_util.tree_leaves(nnx.grad(loss)(dense))
  gs = jax.tree_util.tree_leaves(nnx.grad(loss)(chunked))
  for a, b_ in zip(gd, gs):
    np.testing.assert_allclose(np.asarray(b_), np.asarray(a),
                               atol=3e-5, rtol=3e-5)


def test_streaming_gradients_match():
  lat = np.arange(-90.0, 90.1, 45.0, dtype=np.float32)
  lon = np.arange(0.0, 360.0, 45.0, dtype=np.float32)
  statics = compiler.build_graph_statics(1, lat, lon,
                                         build_attention_mask=False)
  dense = _make(None, statics)
  chunked = _make(64, statics)
  nnx.update(chunked, nnx.state(dense, nnx.Param))

  rng = np.random.default_rng(2)
  b = 1
  nodes = {'grid': jnp.asarray(rng.standard_normal(
               (statics.num_grid_nodes, b, 5)), jnp.float32),
           'mesh': jnp.asarray(rng.standard_normal(
               (statics.num_mesh_nodes, b, 3)), jnp.float32)}
  edges = {'g2m': jnp.asarray(rng.standard_normal(
      (statics.grid2mesh.num_edges, b, 4)), jnp.float32)}
  cond = jnp.zeros((b, 16), jnp.float32)

  def loss(m):
    out, _ = m(nodes, edges, cond)
    return (out['mesh'] ** 2).mean() + (out['grid'] ** 2).mean()

  gd = nnx.grad(loss)(dense)
  gs = nnx.grad(loss)(chunked)
  leaves_d = jax.tree_util.tree_leaves(gd)
  leaves_s = jax.tree_util.tree_leaves(gs)
  for a, b_ in zip(leaves_d, leaves_s):
    np.testing.assert_allclose(np.asarray(b_), np.asarray(a),
                               atol=3e-5, rtol=3e-5)
