"""Numerical parity vs the ACTUAL reference modules, with translated weights.

Instantiates the reference implementation's NNX networks (via
tests/ref_shim.py stubs for jraph/xarray), translates their weights with
gencast_tpu.training.translate, and asserts our redesigned modules produce
the same outputs — the executable core of the 1e-4 parity requirement
(BASELINE.md).

Run standalone (the pytest wrapper test_reference_parity.py invokes this in
a subprocess with FLAX_PYTREE_MODULE=false, which the reference's flax-0.11
era module style requires):

  FLAX_PYTREE_MODULE=false python -m tests.reference_parity_impl
"""

import os
import sys

import numpy as np

import jax

jax.config.update('jax_platforms', 'cpu')

import jax.numpy as jnp  # noqa: E402
import flax.nnx as nnx  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tests import ref_shim  # noqa: E402

ref_shim.install()

from common import mlp as ref_mlp  # noqa: E402
from common import typed_graph as ref_tg  # noqa: E402
from common import deep_typed_graph_net as ref_dtgn  # noqa: E402
from gencast import sparse_transformer as ref_st  # noqa: E402

from gencast_tpu.nn import mlp as my_mlp  # noqa: E402
from gencast_tpu.nn import nnx as gnnx  # noqa: E402
from gencast_tpu.nn import gnn as my_gnn  # noqa: E402
from gencast_tpu.nn import transformer as my_tr  # noqa: E402
from gencast_tpu.training import translate  # noqa: E402
from gencast_tpu.graph import compiler  # noqa: E402


def _pure(module):
  return nnx.to_pure_dict(nnx.state(module))


def _load(module, pure):
  """Loads a translated pure dict into one of OUR modules (the in-repo
  module system; the reference's modules are flax's)."""
  state = gnnx.state(module)
  target = gnnx.to_pure_dict(state)
  translate.merge_into(target, pure)
  gnnx.replace_by_pure_dict(state, target)
  gnnx.update(module, state)


def test_cond_mlp_parity():
  ref = ref_mlp.MLPWithNormConditioning(
      mlp_input_size=10, mlp_hidden_size=16, mlp_num_hidden_layers=1,
      mlp_output_size=8, activation=jax.nn.swish, use_layer_norm=True,
      use_norm_conditioning=True, rngs=nnx.Rngs(0), mesh=None)
  mine = my_mlp.CondMLP(10, 16, 1, 8, jax.nn.swish, use_layer_norm=True,
                        use_norm_conditioning=True, rngs=nnx.Rngs(1))
  _load(mine, translate.cond_mlp(_pure(ref)))

  x = jax.random.normal(jax.random.PRNGKey(2), (5, 2, 10))
  cond = jax.random.normal(jax.random.PRNGKey(3), (2, 16))
  np.testing.assert_allclose(np.asarray(mine(x, cond)),
                             np.asarray(ref(x, cond)),
                             atol=1e-6, rtol=1e-6)


def _ref_bipartite_graph(statics, grid_feats, mesh_feats, edge_feats):
  g2m = statics.grid2mesh
  grid_set = ref_tg.NodeSet(n_node=np.array([statics.num_grid_nodes]),
                            features=grid_feats)
  mesh_set = ref_tg.NodeSet(n_node=np.array([statics.num_mesh_nodes]),
                            features=mesh_feats)
  edge_set = ref_tg.EdgeSet(
      n_edge=np.array([g2m.num_edges]),
      indices=ref_tg.EdgesIndices(senders=jnp.asarray(g2m.senders),
                                  receivers=jnp.asarray(g2m.receivers)),
      features=edge_feats)
  return ref_tg.TypedGraph(
      context=ref_tg.Context(n_graph=np.array([1]), features=()),
      nodes={'grid_nodes': grid_set, 'mesh_nodes': mesh_set},
      edges={ref_tg.EdgeSetKey('grid2mesh', ('grid_nodes', 'mesh_nodes')):
             edge_set})


def _statics():
  lat = np.arange(-90.0, 90.0 + 1e-6, 30.0, dtype=np.float32)
  lon = np.arange(0.0, 360.0, 30.0, dtype=np.float32)
  return compiler.build_graph_statics(1, lat, lon, attention_k_hop=2)


def test_typed_graph_net_parity(statics):
  """grid2mesh-style GNN: embed + 1 interaction + residuals, f32 agg."""
  latent = 24
  batch = 2
  c_grid, c_mesh, c_edge = 7, 5, 4

  rng = np.random.default_rng(0)
  grid_feats = jnp.asarray(
      rng.standard_normal((statics.num_grid_nodes, batch, c_grid)),
      jnp.float32)
  mesh_feats = jnp.asarray(
      rng.standard_normal((statics.num_mesh_nodes, batch, c_mesh)),
      jnp.float32)
  edge_feats = jnp.asarray(
      rng.standard_normal((statics.grid2mesh.num_edges, batch, c_edge)),
      jnp.float32)
  cond = jnp.asarray(rng.standard_normal((batch, 16)), jnp.float32)

  graph = _ref_bipartite_graph(statics, grid_feats, mesh_feats, edge_feats)
  ref = ref_dtgn.DeepTypedGraphNet(
      activation='swish',
      aggregate_normalization=None,
      edge_latent_size=dict(grid2mesh=latent),
      embed_edges=True, embed_nodes=True,
      f32_aggregation=True,
      include_sent_messages_in_node_update=False,
      mlp_hidden_size=latent, mlp_num_hidden_layers=1,
      node_latent_size=dict(grid_nodes=latent, mesh_nodes=latent),
      node_output_size=None,
      num_message_passing_steps=1,
      use_layer_norm=True, use_norm_conditioning=True,
      rngs=nnx.Rngs(0), gpu_mesh=None, graph_template=graph)
  ref_out = ref(graph, cond)

  mine = my_gnn.TypedGraphNet(
      topologies=[my_gnn.EdgeTopology('g2m', 'grid', 'mesh',
                                      statics.grid2mesh.senders,
                                      statics.grid2mesh.receivers)],
      num_nodes={'grid': statics.num_grid_nodes,
                 'mesh': statics.num_mesh_nodes},
      node_input_sizes={'grid': c_grid, 'mesh': c_mesh},
      edge_input_sizes={'g2m': c_edge},
      node_latent_size={'grid': latent, 'mesh': latent},
      edge_latent_size={'g2m': latent},
      mlp_hidden_size=latent, mlp_num_hidden_layers=1,
      num_message_passing_steps=1,
      f32_aggregation=True, rngs=nnx.Rngs(1))
  _load(mine, translate.typed_graph_net(_pure(ref)))

  nodes, edges = mine({'grid': grid_feats, 'mesh': mesh_feats},
                      {'g2m': edge_feats}, cond)
  np.testing.assert_allclose(
      np.asarray(nodes['mesh']),
      np.asarray(ref_out.nodes['mesh_nodes'].features),
      atol=2e-5, rtol=2e-5)
  np.testing.assert_allclose(
      np.asarray(nodes['grid']),
      np.asarray(ref_out.nodes['grid_nodes'].features),
      atol=2e-5, rtol=2e-5)


def test_transformer_parity(statics):
  """Full sparse transformer (triblockdiag) with translated weights."""
  import scipy.sparse as sp
  d_model, heads, layers = 32, 2, 3
  n = statics.num_mesh_nodes
  s, r = statics.mesh_edges.senders, statics.mesh_edges.receivers
  adj = sp.lil_matrix((n, n), dtype=np.int32)
  adj[s, r] = 1
  adj.setdiag(1)

  ref = ref_st.Transformer(
      adj_mat=adj.tocsr(), attention_k_hop=statics.attention_k_hop,
      attention_type='triblockdiag_mha', mask_type='full',
      num_heads=heads, rngs=nnx.Rngs(0), mesh=None,
      d_model=d_model, num_layers=layers, ffw_hidden=64,
      ffw_winit_final_mult=1.0, attn_winit_final_mult=1.0)

  # Reference block size differs from ours (we round up to a multiple of
  # 8); rebuild statics mask with multiple 1 for an apples-to-apples run.
  lat, lon = statics.grid_lat, statics.grid_lon
  statics_exact = compiler.build_graph_statics(
      1, lat, lon, attention_k_hop=statics.attention_k_hop,
      block_size_multiple=1)

  cfg = my_tr.TransformerConfig(
      d_model=d_model, num_layers=layers, num_heads=heads, ffw_hidden=64,
      attention_type='triblock', ffw_winit_final_mult=1.0,
      attn_winit_final_mult=1.0)
  mine = my_tr.MeshTransformer(cfg, statics_exact.attention_mask,
                               rngs=nnx.Rngs(1))
  _load(mine, translate.transformer(_pure(ref)))

  batch = 2
  x = jax.random.normal(jax.random.PRNGKey(5), (batch, n, d_model))
  cond = jax.random.normal(jax.random.PRNGKey(6), (batch, 16))
  ref_out = ref(x, cond)                      # batch-first
  my_out = mine(jnp.transpose(x, (1, 0, 2)), cond)  # nodes-first
  np.testing.assert_allclose(np.asarray(jnp.transpose(my_out, (1, 0, 2))),
                             np.asarray(ref_out), atol=2e-5, rtol=2e-5)


def test_full_denoiser_parity(statics):
  """The whole DenoiserArchitecture compute path (grid2mesh GNN -> mesh
  transformer -> mesh2grid GNN), reference vs ours, translated weights."""
  from gencast import denoiser as ref_den

  latent = 24
  c_data = 11
  out_size = 5
  batch = 2
  lat = statics.grid_lat
  lon = statics.grid_lon

  st_cfg = ref_den.SparseTransformerConfig(
      attention_k_hop=statics.attention_k_hop, d_model=latent,
      num_layers=2, num_heads=2, attention_type='triblockdiag_mha',
      ffw_hidden=48, ffw_winit_final_mult=1.0, attn_winit_final_mult=1.0)
  cfg = ref_den.DenoiserArchitectureConfig(
      sparse_transformer_config=st_cfg, mesh_size=1, latent_size=latent,
      hidden_layers=1, node_output_size=out_size)

  ref = ref_den.DenoiserArchitecture(cfg, rngs=nnx.Rngs(0), gpu_mesh=None)
  # Manual init (bypassing the xarray boundary of _maybe_init).
  ref._init_mesh_properties()
  ref._init_grid_properties(grid_lat=lat, grid_lon=lon)
  ref._data_feature_size = c_data
  ref._grid2mesh_graph_structure = ref._init_grid2mesh_graph(
      extra_node_features_size=c_data)
  ref._mesh_graph_structure = ref._init_mesh_graph()
  ref._mesh2grid_graph_structure = ref._init_mesh2grid_graph()
  import dataclasses as _dc
  from common import deep_typed_graph_net as _dtgn
  from gencast import transformer as _rtr
  ref.grid2mesh_gnn = _dtgn.DeepTypedGraphNet(
      activation='swish', aggregate_normalization=None,
      edge_latent_size=dict(grid2mesh=latent), embed_edges=True,
      embed_nodes=True, f32_aggregation=True,
      include_sent_messages_in_node_update=False,
      mlp_hidden_size=latent, mlp_num_hidden_layers=1,
      node_latent_size=dict(grid_nodes=latent, mesh_nodes=latent),
      node_output_size=None, num_message_passing_steps=1,
      use_layer_norm=True, use_norm_conditioning=True,
      rngs=nnx.Rngs(1), gpu_mesh=None,
      graph_template=ref._grid2mesh_graph_structure)
  ref.mesh_gnn = _rtr.MeshTransformer(
      transformer_kwargs=_dc.asdict(st_cfg), rngs=nnx.Rngs(2),
      gpu_mesh=None, graph_template=ref._mesh_graph_structure)
  ref.mesh2grid_gnn = _dtgn.DeepTypedGraphNet(
      activation='swish', edge_latent_size=dict(mesh2grid=latent),
      embed_nodes=False, f32_aggregation=False,
      include_sent_messages_in_node_update=False,
      mlp_hidden_size=latent, mlp_num_hidden_layers=1,
      node_latent_size=dict(grid_nodes=latent, mesh_nodes=latent),
      node_output_size=dict(grid_nodes=out_size),
      num_message_passing_steps=1, use_layer_norm=True,
      use_norm_conditioning=True, rngs=nnx.Rngs(3), gpu_mesh=None,
      graph_template=ref._mesh2grid_graph_structure)
  ref._initialized = True

  rng = np.random.default_rng(7)
  grid_feats = jnp.asarray(
      rng.standard_normal((statics.num_grid_nodes, batch, c_data)),
      jnp.float32)
  cond = jnp.asarray(rng.standard_normal((batch, 16)), jnp.float32)

  latent_mesh, latent_grid = ref._run_grid2mesh_gnn(grid_feats, cond)
  upd_mesh = ref._run_mesh_gnn(latent_mesh, cond)
  ref_out = ref._run_mesh2grid_gnn(upd_mesh, latent_grid, cond)

  # Ours, with exact (multiple=1) block size and translated weights.
  statics_exact = compiler.build_graph_statics(
      1, lat, lon, attention_k_hop=statics.attention_k_hop,
      block_size_multiple=1)
  from gencast_tpu.models import denoiser as my_den
  from gencast_tpu.nn.transformer import TransformerConfig
  mine = my_den.DenoiserArchitecture(
      statics_exact,
      TransformerConfig(d_model=latent, num_layers=2, num_heads=2,
                        ffw_hidden=48, attention_type='triblock',
                        ffw_winit_final_mult=1.0,
                        attn_winit_final_mult=1.0),
      num_data_channels=c_data, node_output_size=out_size,
      config=my_den.DenoiserConfig(latent_size=latent),
      rngs=nnx.Rngs(4))

  translated = {
      'grid2mesh': translate.typed_graph_net(
          _pure(ref.grid2mesh_gnn), mesh_embedder_keep_rows=3),
      'processor': translate.transformer(
          _pure(ref.mesh_gnn)['batch_first_transformer']),
      'mesh2grid': translate.typed_graph_net(_pure(ref.mesh2grid_gnn)),
  }
  _load(mine, translated)

  my_out = mine(grid_feats, cond)
  err = np.abs(np.asarray(my_out) - np.asarray(ref_out))
  rel = err.max() / (np.abs(np.asarray(ref_out)).max() + 1e-12)
  print(f'denoiser max abs err {err.max():.2e}, rel {rel:.2e}')
  assert rel < 1e-4, rel


def _setup_denoiser_translation(statics):
  """Builds a matched (mine, reference) denoiser pair plus the reference's
  nested state dict, shared by the translation and published-checkpoint
  round-trip tests. Returns (mine, ref, arch, ref_state, c_data)."""
  from gencast import denoiser as ref_den
  import dataclasses as _dc
  from common import deep_typed_graph_net as _dtgn
  from gencast import transformer as _rtr

  latent = 24
  batch = 2
  lat, lon = statics.grid_lat, statics.grid_lon

  # My Denoiser defines the task shape; reference arch gets matching dims.
  from gencast_tpu.data import registry
  from gencast_tpu.models import denoiser as my_den
  from gencast_tpu.nn.transformer import TransformerConfig
  task = registry.TaskSpec(
      input_variables=('2m_temperature', 'temperature', 'year_progress_sin',
                       'land_sea_mask'),
      target_variables=('2m_temperature', 'temperature'),
      forcing_variables=('year_progress_sin',),
      pressure_levels=(500, 1000),
      num_input_frames=2)
  statics_exact = compiler.build_graph_statics(
      1, lat, lon, attention_k_hop=statics.attention_k_hop,
      block_size_multiple=1)
  mine = my_den.Denoiser(
      task, statics_exact,
      TransformerConfig(d_model=latent, num_layers=2, num_heads=2,
                        ffw_hidden=48, attention_type='triblock',
                        ffw_winit_final_mult=1.0, attn_winit_final_mult=1.0),
      my_den.DenoiserConfig(latent_size=latent),
      rngs=nnx.Rngs(9))
  c_data = (mine.input_layout.num_channels + mine.cond_layout.num_channels)
  out_size = mine.target_layout.num_channels

  st_cfg = ref_den.SparseTransformerConfig(
      attention_k_hop=statics.attention_k_hop, d_model=latent,
      num_layers=2, num_heads=2, attention_type='triblockdiag_mha',
      ffw_hidden=48, ffw_winit_final_mult=1.0, attn_winit_final_mult=1.0)
  cfg = ref_den.DenoiserArchitectureConfig(
      sparse_transformer_config=st_cfg, mesh_size=1, latent_size=latent,
      hidden_layers=1, node_output_size=out_size)
  ref = ref_den.Denoiser(None, cfg, rngs=nnx.Rngs(0), gpu_mesh=None)
  arch = ref.predictor
  arch._init_mesh_properties()
  arch._init_grid_properties(grid_lat=lat, grid_lon=lon)
  arch._data_feature_size = c_data
  arch._grid2mesh_graph_structure = arch._init_grid2mesh_graph(
      extra_node_features_size=c_data)
  arch._mesh_graph_structure = arch._init_mesh_graph()
  arch._mesh2grid_graph_structure = arch._init_mesh2grid_graph()
  arch.grid2mesh_gnn = _dtgn.DeepTypedGraphNet(
      activation='swish', aggregate_normalization=None,
      edge_latent_size=dict(grid2mesh=latent), embed_edges=True,
      embed_nodes=True, f32_aggregation=True,
      include_sent_messages_in_node_update=False,
      mlp_hidden_size=latent, mlp_num_hidden_layers=1,
      node_latent_size=dict(grid_nodes=latent, mesh_nodes=latent),
      node_output_size=None, num_message_passing_steps=1,
      use_layer_norm=True, use_norm_conditioning=True,
      rngs=nnx.Rngs(1), gpu_mesh=None,
      graph_template=arch._grid2mesh_graph_structure)
  arch.mesh_gnn = _rtr.MeshTransformer(
      transformer_kwargs=_dc.asdict(st_cfg), rngs=nnx.Rngs(2),
      gpu_mesh=None, graph_template=arch._mesh_graph_structure)
  arch.mesh2grid_gnn = _dtgn.DeepTypedGraphNet(
      activation='swish', edge_latent_size=dict(mesh2grid=latent),
      embed_nodes=False, f32_aggregation=False,
      include_sent_messages_in_node_update=False,
      mlp_hidden_size=latent, mlp_num_hidden_layers=1,
      node_latent_size=dict(grid_nodes=latent, mesh_nodes=latent),
      node_output_size=dict(grid_nodes=out_size),
      num_message_passing_steps=1, use_layer_norm=True,
      use_norm_conditioning=True, rngs=nnx.Rngs(3), gpu_mesh=None,
      graph_template=arch._mesh2grid_graph_structure)
  arch._initialized = True

  # Reference-shaped state dict {noise_level_encoder, predictor} -> mine.
  ref_state = {
      'noise_level_encoder': _pure(ref.noise_level_encoder),
      'predictor': {
          'grid2mesh_gnn': _pure(arch.grid2mesh_gnn),
          'mesh_gnn': _pure(arch.mesh_gnn),
          'mesh2grid_gnn': _pure(arch.mesh2grid_gnn),
      },
  }
  return mine, ref, arch, ref_state, c_data


def _assert_denoiser_outputs_match(statics, mine, ref, arch, c_data,
                                   batch=2):
  """Sigma encoding + full architecture parity on identical node data."""
  rng = np.random.default_rng(11)
  sigma = jnp.asarray([0.5, 7.0], jnp.float32)
  enc_ref = ref.noise_level_encoder(sigma)
  enc_my = mine.noise_encoder(sigma)
  np.testing.assert_allclose(np.asarray(enc_my), np.asarray(enc_ref),
                             atol=1e-6, rtol=1e-6)
  grid_feats = jnp.asarray(
      rng.standard_normal((statics.num_grid_nodes, batch, c_data)),
      jnp.float32)
  cond = enc_my
  lm, lg = arch._run_grid2mesh_gnn(grid_feats, cond)
  um = arch._run_mesh_gnn(lm, cond)
  ref_out = arch._run_mesh2grid_gnn(um, lg, cond)
  my_out = mine.architecture(grid_feats, cond)
  rel = (np.abs(np.asarray(my_out) - np.asarray(ref_out)).max()
         / (np.abs(np.asarray(ref_out)).max() + 1e-12))
  return rel


def test_full_gencast_denoiser_translation(statics):
  """translate.gencast_denoiser end to end: reference Denoiser (noise
  encoder + architecture) -> my Denoiser, including the sigma encoding."""
  mine, ref, arch, ref_state, c_data = _setup_denoiser_translation(statics)
  _load(mine, translate.gencast_denoiser(ref_state))
  rel = _assert_denoiser_outputs_match(statics, mine, ref, arch, c_data)
  print(f'gencast denoiser translation rel err {rel:.2e}')
  assert rel < 1e-4, rel


def _haikuify(tree):
  """Renames NNX leaves to Haiku-era names (kernel->w, bias->b, LayerNorm
  bias->offset) to synthesize published-checkpoint naming."""
  if not isinstance(tree, dict):
    return tree
  is_ln = 'scale' in tree
  out = {}
  for k, v in tree.items():
    if not isinstance(v, dict):
      if k == 'kernel':
        k = 'w'
      elif k == 'bias':
        k = 'offset' if is_ln else 'b'
    out[k] = _haikuify(v)
  return out


def test_deepmind_checkpoint_roundtrip(statics):
  """Published-checkpoint family: a CheckPoint-schema npz (flattened
  dataclass container, reference gencast/gencast.py:118-127 +
  common/checkpoint.py) with Haiku-era leaf naming loads into my Denoiser
  with full numerical parity."""
  import tempfile

  from gencast_tpu.training import deepmind_checkpoint as dm_ckpt

  mine, ref, arch, ref_state, c_data = _setup_denoiser_translation(statics)
  ckpt_tree = {
      'description': 'synthesized parity-test checkpoint',
      'license': 'CC-BY-NC-SA-4.0',
      'params': _haikuify(ref_state),
      'sampler_config': {'max_noise_level': 80.0, 'min_noise_level': 0.03,
                         'num_noise_levels': 20, 'rho': 7.0,
                         'stochastic_churn_rate': 2.5,
                         'churn_min_noise_level': 0.75,
                         'noise_level_inflation_factor': 1.05},
      'noise_config': {'training_noise_level_rho': 7.0,
                       'training_max_noise_level': 88.0,
                       'training_min_noise_level': 0.02},
  }
  with tempfile.NamedTemporaryFile(suffix='.npz') as f:
    dm_ckpt.save(f.name, ckpt_tree)
    assert dm_ckpt.is_checkpoint_npz(f.name)
    tree = dm_ckpt.load(f.name)
  assert tree['description'] == 'synthesized parity-test checkpoint'
  cfg = dm_ckpt.config_tree(tree, 'sampler_config')
  assert cfg['max_noise_level'] == 80.0 and cfg['num_noise_levels'] == 20
  _load(mine, dm_ckpt.denoiser_state(tree))
  rel = _assert_denoiser_outputs_match(statics, mine, ref, arch, c_data)
  print(f'deepmind checkpoint roundtrip rel err {rel:.2e}')
  assert rel < 1e-4, rel


def test_reference_serializer_cross_compat(statics):
  """Published-npz grammar vs the reference's OWN serializer: a CheckPoint
  the reference's common/checkpoint.py:26-39 `dump` writes (with the real
  gencast/gencast.py:118-127 CheckPoint dataclass) loads through
  training/deepmind_checkpoint with full numerical parity, and a container
  we write deserializes through the reference's typed `load` (:42-53) into
  equal configs and bitwise-equal params. This is the strongest offline
  validation of the published-weights path available without the real
  DeepMind npz files (PARITY.md documents the residual risk)."""
  import tempfile

  from common import checkpoint as ref_ckpt
  from gencast import gencast as ref_gencast
  from gencast import denoiser as ref_den
  from graphcast import graphcast as ref_graphcast
  from gencast_tpu.training import deepmind_checkpoint as dm_ckpt

  mine, ref, arch, ref_state, c_data = _setup_denoiser_translation(statics)
  haiku_params = _haikuify(ref_state)
  out_size = mine.target_layout.num_channels
  st_cfg = ref_den.SparseTransformerConfig(
      attention_k_hop=statics.attention_k_hop, d_model=24, num_layers=2,
      num_heads=2, attention_type='triblockdiag_mha', ffw_hidden=48,
      ffw_winit_final_mult=1.0, attn_winit_final_mult=1.0)
  ckpt = ref_gencast.CheckPoint(
      description='cross-serializer parity checkpoint',
      license='CC-BY-NC-SA-4.0',
      params=haiku_params,
      task_config=ref_graphcast.TASK_13,
      denoiser_architecture_config=ref_den.DenoiserArchitectureConfig(
          sparse_transformer_config=st_cfg, mesh_size=1, latent_size=24,
          hidden_layers=1, node_output_size=out_size),
      sampler_config=ref_gencast.SamplerConfig(),
      noise_config=ref_gencast.NoiseConfig(),
      noise_encoder_config=ref_den.NoiseEncoderConfig())

  # Direction 1: the reference writes, we read.
  with tempfile.NamedTemporaryFile(suffix='.npz') as f:
    with open(f.name, 'wb') as fh:
      ref_ckpt.dump(fh, ckpt)
    ref_flat_keys = set(np.load(f.name).files)
    assert dm_ckpt.is_checkpoint_npz(f.name)
    tree = dm_ckpt.load(f.name)
  # Flattening conventions must agree key-for-key on the params tree.
  my_flat_keys = set(dm_ckpt.flatten_tree({'params': haiku_params}))
  assert my_flat_keys <= ref_flat_keys, sorted(my_flat_keys - ref_flat_keys)
  assert tree['description'] == 'cross-serializer parity checkpoint'
  scfg = dm_ckpt.config_tree(tree, 'sampler_config')
  assert scfg['max_noise_level'] == 80.0
  assert scfg['num_noise_levels'] == 20
  assert scfg['rho'] == 7.0
  ncfg = dm_ckpt.config_tree(tree, 'noise_config')
  assert ncfg['training_max_noise_level'] == 88.0
  _load(mine, dm_ckpt.denoiser_state(tree))
  rel = _assert_denoiser_outputs_match(statics, mine, ref, arch, c_data)
  print(f'reference-serializer checkpoint rel err {rel:.2e}')
  assert rel < 1e-4, rel

  # Direction 2: we write, the reference's typed loader reads.
  with tempfile.NamedTemporaryFile(suffix='.npz') as f:
    dm_ckpt.save(f.name, tree)
    with open(f.name, 'rb') as fh:
      back = ref_ckpt.load(fh, ref_gencast.CheckPoint)
  assert back.description == ckpt.description
  assert back.sampler_config == ckpt.sampler_config
  assert back.noise_config == ckpt.noise_config
  assert back.noise_encoder_config == ckpt.noise_encoder_config
  assert back.task_config == ckpt.task_config
  assert back.denoiser_architecture_config == ckpt.denoiser_architecture_config
  flat_orig = dm_ckpt.flatten_tree(haiku_params)
  flat_back = dm_ckpt.flatten_tree(back.params)
  assert set(flat_back) == set(flat_orig)
  for k, v in flat_orig.items():
    np.testing.assert_array_equal(np.asarray(flat_back[k]), np.asarray(v), k)


def test_sampler_schedule_parity():
  """EDM sampler schedule + preconditioning math vs the reference's OWN
  code: gencast/samplers_utils.py:350-431 (rho_inverse_cdf, noise_schedule,
  stochastic_churn_rate_schedule) and the DPM++2S Sampler's schedule
  construction + c_in/c_out/c_skip (gencast/dpm_solver_plus_plus_2s.py:33-43,
  182-190). These define WHICH noise levels the 2N-1 denoiser calls see, so
  drift here silently changes every forecast while all module-level parity
  stays green."""
  from gencast import samplers_utils as ref_su
  from gencast import dpm_solver_plus_plus_2s as ref_dpm
  from gencast_tpu.models import diffusion_utils as my_du
  from gencast_tpu.models.gencast import NoiseConfig, SamplerConfig

  # Schedule functions across configs incl. the clamp regime (rate/num
  # exceeding sqrt(2)-1) and a finite churn_max window.
  configs = [
      (80.0, 0.03, 20, 7.0, 2.5, 0.75, float('inf')),   # production sampler
      (88.0, 0.02, 30, 7.0, 0.0, 0.05, 50.0),           # churn off
      (80.0, 0.002, 4, 3.0, 10.0, 0.05, 50.0),          # clamped churn
      (160.0, 0.1, 50, 5.0, 1.0, 1.0, 40.0),            # windowed churn
  ]
  for (mx, mn, num, rho, rate, cmin, cmax) in configs:
    ref_lv = ref_su.noise_schedule(mx, mn, num, rho)
    my_lv = my_du.noise_schedule(mx, mn, num, rho)
    np.testing.assert_allclose(my_lv, ref_lv, rtol=1e-12, atol=0)
    ref_ch = ref_su.stochastic_churn_rate_schedule(ref_lv, rate, cmin, cmax)
    my_ch = my_du.stochastic_churn_rate_schedule(my_lv, rate, cmin, cmax)
    np.testing.assert_allclose(my_ch, ref_ch, rtol=1e-12, atol=0)

  # Training-time noise distribution quantiles (gencast.py loss path).
  nc = NoiseConfig()
  cdf = np.linspace(0.0, 1.0, 257)
  ref_q = ref_su.rho_inverse_cdf(nc.training_min_noise_level,
                                 nc.training_max_noise_level,
                                 nc.training_noise_level_rho, cdf)
  my_q = my_du.rho_inverse_cdf(nc.training_min_noise_level,
                               nc.training_max_noise_level,
                               nc.training_noise_level_rho, cdf)
  np.testing.assert_allclose(my_q, ref_q, rtol=1e-12, atol=0)

  # The reference Sampler's constructed schedules for OUR SamplerConfig
  # values, and its preconditioning coefficients vs ours
  # (models/gencast.py:108-115).
  sc = SamplerConfig()
  ref_sampler = ref_dpm.Sampler(
      denoiser=None, max_noise_level=sc.max_noise_level,
      min_noise_level=sc.min_noise_level,
      num_noise_levels=sc.num_noise_levels, rho=sc.rho,
      stochastic_churn_rate=sc.stochastic_churn_rate,
      churn_min_noise_level=sc.churn_min_noise_level,
      churn_max_noise_level=sc.churn_max_noise_level,
      noise_level_inflation_factor=sc.noise_level_inflation_factor)
  np.testing.assert_allclose(
      my_du.noise_schedule(sc.max_noise_level, sc.min_noise_level,
                           sc.num_noise_levels, sc.rho),
      ref_sampler._noise_levels, rtol=1e-12, atol=0)
  np.testing.assert_allclose(
      my_du.stochastic_churn_rate_schedule(
          np.asarray(ref_sampler._noise_levels), sc.stochastic_churn_rate,
          sc.churn_min_noise_level, sc.churn_max_noise_level),
      ref_sampler._per_step_churn_rates, rtol=1e-12, atol=0)

  sig = np.concatenate([[1e-4, nc.training_min_noise_level],
                        np.geomspace(0.01, 88.0, 31)])
  my_c_in = (sig ** 2 + 1.0) ** -0.5
  my_c_out = sig * (sig ** 2 + 1.0) ** -0.5
  my_c_skip = 1.0 / (sig ** 2 + 1.0)
  np.testing.assert_allclose(my_c_in, ref_sampler._c_in(sig), rtol=1e-12)
  np.testing.assert_allclose(my_c_out, ref_sampler._c_out(sig), rtol=1e-12)
  np.testing.assert_allclose(my_c_skip, ref_sampler._c_skip(sig), rtol=1e-12)

def test_derived_forcings_parity():
  """year/day progress math vs the reference's OWN get_year_progress /
  get_day_progress / featurize_progress (common/data_utils.py:51-135).
  These generate four of the input channels of every task, so a constant
  drift here shifts every model family's conditioning."""
  from common import data_utils as ref_du
  from gencast_tpu.data import forcings as my_f

  rng = np.random.default_rng(7)
  # Epoch boundary, far future, ERA5-era timestamps, odd fractions.
  t = np.concatenate([
      [0.0, 1.0, 86400.0 - 1.0, 86400.0],
      rng.uniform(0, 2.2e9, 64),
      np.arange(1.0e9, 1.0e9 + 12 * 43200.0, 43200.0),  # 12h cadence
  ])
  lon = np.arange(0.0, 360.0, 2.5)
  np.testing.assert_array_equal(my_f.year_progress(t),
                                ref_du.get_year_progress(t))
  np.testing.assert_array_equal(my_f.day_progress(t, lon),
                                ref_du.get_day_progress(t, lon))

  # The sin/cos featurization (featurize_progress:104-135) vs our packed
  # generated_forcings fields.
  lat = np.arange(-90.0, 90.1, 30.0)
  mine = my_f.generated_forcings(t, lat, lon)
  ref_yp = ref_du.featurize_progress(
      'year_progress', ('time',), ref_du.get_year_progress(t))
  ref_dp = ref_du.featurize_progress(
      'day_progress', ('time', 'lon'), ref_du.get_day_progress(t, lon))
  for suffix in ('sin', 'cos'):
    ref_y = np.asarray(ref_yp[f'year_progress_{suffix}'].data)
    np.testing.assert_allclose(mine[f'year_progress_{suffix}'][:, 0, 0],
                               ref_y, rtol=0, atol=0)
    ref_d = np.asarray(ref_dp[f'day_progress_{suffix}'].data)
    np.testing.assert_allclose(mine[f'day_progress_{suffix}'][:, 0, :],
                               ref_d, rtol=0, atol=0)


def test_loss_weight_parity():
  """Latitude/level loss-weight vectors vs the reference's OWN helpers
  (common/losses.py:99-187). These scale every term of the training loss;
  the parity run proves both pole-handling regimes and the
  pressure-proportional level weights bit-for-bit."""
  from common import losses as ref_losses
  from gencast_tpu.data import layout as my_layout

  for dlat in (30.0, 10.0, 2.5, 1.0):
    # With poles: [-90, ..., 90].
    lat_p = np.arange(-90.0, 90.0 + 1e-9, dlat)
    ref_w = ref_losses._weight_for_latitude_vector_with_poles(lat_p.copy())
    ref_w = ref_w / ref_w.mean()
    np.testing.assert_allclose(my_layout.latitude_weights(lat_p), ref_w,
                               rtol=1e-6)  # ours stores f32 (device dtype)
    # Without poles: [-(90 - dlat/2), ..., 90 - dlat/2].
    lat_np = np.arange(-90.0 + dlat / 2, 90.0, dlat)
    ref_w = ref_losses._weight_for_latitude_vector_without_poles(lat_np.copy())
    ref_w = ref_w / ref_w.mean()
    np.testing.assert_allclose(my_layout.latitude_weights(lat_np), ref_w,
                               rtol=1e-6)

  # Pressure-proportional level weights (normalized_level_weights:99-102)
  # as baked into loss_channel_weights for a multi-level variable.
  levels = (500, 700, 850, 1000)
  lay = my_layout.build_layout(('temperature',), levels, 1)
  total_w, _ = my_layout.loss_channel_weights(lay, {})
  lv = np.asarray(levels, dtype=np.float64)
  ref_level_w = lv / lv.mean()
  # One variable, weight 1.0, channels_of_var = len(levels).
  np.testing.assert_allclose(total_w, ref_level_w / len(levels), rtol=1e-6)


if __name__ == '__main__':
  assert not __import__('flax').config.flax_pytree_module, \
      'run with FLAX_PYTREE_MODULE=false'
  statics = _statics()
  test_cond_mlp_parity()
  print('cond_mlp parity OK')
  test_typed_graph_net_parity(statics)
  print('typed_graph_net parity OK')
  test_transformer_parity(statics)
  print('transformer parity OK')
  test_full_denoiser_parity(statics)
  print('FULL DENOISER parity OK (<=1e-4 relative)')
  test_full_gencast_denoiser_translation(statics)
  print('GENCAST DENOISER translation parity OK')
  test_deepmind_checkpoint_roundtrip(statics)
  print('DEEPMIND CHECKPOINT roundtrip parity OK')
  test_reference_serializer_cross_compat(statics)
  print('REFERENCE-SERIALIZER cross-compat OK')
  test_sampler_schedule_parity()
  print('SAMPLER SCHEDULE parity OK')
  test_derived_forcings_parity()
  print('DERIVED FORCINGS parity OK')
  test_loss_weight_parity()
  print('LOSS WEIGHT parity OK')
