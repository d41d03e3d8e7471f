"""GenCast denoiser: grid2mesh GNN -> banded mesh transformer -> mesh2grid GNN.

Packed-array counterpart of the reference's DenoiserArchitecture + Denoiser
(gencast/denoiser.py:142-867). Device-side interface is
[batch, lat, lon, channels] tensors; all graph structure and feature
packing metadata is static at construction (no lazy init).

One deliberate deviation from the reference: the mesh-node embedder input is
the 3 structural features only, instead of structural features plus a block
of always-zero "dummy data" channels (reference gencast/denoiser.py:479-491,
662). Zero inputs contribute nothing to outputs or gradients, so this is
mathematically equivalent while skipping dead MXU work; checkpoint
translation simply drops the corresponding all-zero-input kernel rows.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from gencast_tpu.nn import nnx
import jax
import jax.numpy as jnp
import numpy as np

from gencast_tpu.data import layout as layout_lib
from gencast_tpu.data.registry import TaskSpec
from gencast_tpu.graph.compiler import GraphStatics
from gencast_tpu.nn.gnn import EdgeTopology, TypedGraphNet
from gencast_tpu.nn.mlp import FourierFeaturesMLP
from gencast_tpu.nn.transformer import MeshTransformer, TransformerConfig
from gencast_tpu.nn.variables import StaticData


@dataclasses.dataclass(frozen=True)
class NoiseEncoderConfig:
  """Reference gencast/denoiser.py:47-68."""
  apply_log_first: bool = True
  base_period: float = 16.0
  num_frequencies: int = 32
  output_sizes: tuple = (32, 16)


@dataclasses.dataclass(frozen=True)
class DenoiserConfig:
  """Architecture hyperparameters (reference DenoiserArchitectureConfig,
  gencast/denoiser.py:100-139; mesh/grid structure lives in GraphStatics)."""
  latent_size: int = 512
  hidden_layers: int = 1
  grid2mesh_aggregate_normalization: Optional[float] = None
  noise_encoder: NoiseEncoderConfig = NoiseEncoderConfig()
  # Streamed edge processing for the encoder/decoder GNNs (see
  # nn/gnn.py:_streaming_call); None keeps the dense path. Required for
  # the 0.25-degree configuration on a single chip.
  edge_chunk_size: Optional[int] = None
  # Mesh axis name to shard the grid-node axis over (sequence/node
  # parallelism for paper-scale training). None = no constraint; XLA
  # inserts the halo collectives implied by the graph edges.
  node_sharding_axis: Optional[str] = None
  # Remat the encoder/decoder GNNs as whole units: their backward then
  # recomputes MLP internals instead of saving them (at 0.25 degrees the
  # grid-node MLP residuals alone are several GB per layer of hidden
  # state). Required for the paper-scale single-chip training step.
  remat_gnns: bool = False


class DenoiserArchitecture(nnx.Module):
  """Encode-process-decode over grid & mesh nodes.

  Works on node-leading arrays: grid data [G, B, C_data] in,
  grid outputs [G, B, out] back.
  """

  def __init__(self, statics: GraphStatics, transformer: TransformerConfig,
               num_data_channels: int, node_output_size: int,
               config: DenoiserConfig, *, rngs: nnx.Rngs,
               dense_attention_mask: Optional[np.ndarray] = None):
    cfg = config
    latent = cfg.latent_size
    self._node_sharding_axis = cfg.node_sharding_axis
    self._remat_gnns = cfg.remat_gnns
    if transformer.d_model != latent:
      raise ValueError(
          f'transformer d_model ({transformer.d_model}) must equal the GNN '
          f'latent size ({latent}): the mesh transformer operates directly '
          'on grid2mesh latents')
    self.num_grid_nodes = statics.num_grid_nodes
    self.num_mesh_nodes = statics.num_mesh_nodes

    # Device-resident static features.
    self.grid_struct = StaticData(jnp.asarray(statics.grid_node_features))
    self.mesh_struct = StaticData(jnp.asarray(statics.mesh_node_features))
    self.g2m_edge_feats = StaticData(jnp.asarray(statics.grid2mesh.features))
    self.m2g_edge_feats = StaticData(jnp.asarray(statics.mesh2grid.features))

    num_nodes = {'grid': statics.num_grid_nodes,
                 'mesh': statics.num_mesh_nodes}

    g2m_topo = EdgeTopology('g2m', 'grid', 'mesh',
                            statics.grid2mesh.senders,
                            statics.grid2mesh.receivers)
    m2g_topo = EdgeTopology('m2g', 'mesh', 'grid',
                            statics.mesh2grid.senders,
                            statics.mesh2grid.receivers)

    self.grid2mesh = TypedGraphNet(
        topologies=[g2m_topo],
        num_nodes=num_nodes,
        node_input_sizes={'grid': 3 + num_data_channels, 'mesh': 3},
        edge_input_sizes={'g2m': 4},
        node_latent_size={'grid': latent, 'mesh': latent},
        edge_latent_size={'g2m': latent},
        mlp_hidden_size=latent,
        mlp_num_hidden_layers=cfg.hidden_layers,
        num_message_passing_steps=1,
        f32_aggregation=True,
        aggregate_normalization=cfg.grid2mesh_aggregate_normalization,
        edge_chunk_size=cfg.edge_chunk_size,
        rngs=rngs)

    self.processor = MeshTransformer(
        transformer, statics.attention_mask,
        dense_mask=dense_attention_mask,
        tile_plan=statics.attention_tile_plan, rngs=rngs)

    self.mesh2grid = TypedGraphNet(
        topologies=[m2g_topo],
        num_nodes=num_nodes,
        node_input_sizes={},
        edge_input_sizes={'m2g': 4},
        node_latent_size={'grid': latent, 'mesh': latent},
        edge_latent_size={'m2g': latent},
        mlp_hidden_size=latent,
        mlp_num_hidden_layers=cfg.hidden_layers,
        num_message_passing_steps=1,
        embed_nodes=False,
        node_output_sizes={'grid': node_output_size},
        f32_aggregation=False,
        edge_chunk_size=cfg.edge_chunk_size,
        rngs=rngs)

  def _shard_nodes(self, x: jnp.ndarray) -> jnp.ndarray:
    """Optionally constrains the node axis onto the configured mesh axis
    (sequence parallelism; XLA derives the edge-halo collectives)."""
    if self._node_sharding_axis is None:
      return x
    from jax.sharding import PartitionSpec as P
    return jax.lax.with_sharding_constraint(
        x, P(self._node_sharding_axis, None, None))

  def __call__(self, grid_data: jnp.ndarray,
               cond: jnp.ndarray) -> jnp.ndarray:
    """grid_data: [G, B, C_data]; cond: [B, 16] -> [G, B, out]."""
    batch = grid_data.shape[1]
    dtype = grid_data.dtype

    def bcast(feat):
      return jnp.broadcast_to(feat[:, None, :].astype(dtype),
                              (feat.shape[0], batch, feat.shape[1]))

    grid_in = self._shard_nodes(
        jnp.concatenate([bcast(self.grid_struct[...]), grid_data], -1))

    def run_g2m(grid_in, mesh_in, edge_in, cond):
      nodes, _ = self.grid2mesh({'grid': grid_in, 'mesh': mesh_in},
                                {'g2m': edge_in}, cond)
      return nodes['grid'], nodes['mesh']

    def run_m2g(latent_grid, latent_mesh, edge_in, cond):
      nodes, _ = self.mesh2grid({'grid': latent_grid, 'mesh': latent_mesh},
                                {'m2g': edge_in}, cond)
      return nodes['grid']

    if self._remat_gnns:
      # Whole-GNN remat: the backward recomputes the encoder/decoder MLP
      # internals instead of saving [num_grid_nodes, latent]-sized hidden
      # activations (several GB each at 0.25 degrees).
      run_g2m = jax.checkpoint(run_g2m)
      run_m2g = jax.checkpoint(run_m2g)

    latent_grid, latent_mesh = run_g2m(
        grid_in, bcast(self.mesh_struct[...]),
        bcast(self.g2m_edge_feats[...]), cond)
    latent_grid = self._shard_nodes(latent_grid)

    latent_mesh = self.processor(latent_mesh, cond).astype(dtype)

    out = run_m2g(latent_grid, latent_mesh,
                  bcast(self.m2g_edge_feats[...]), cond)
    return self._shard_nodes(out)


class Denoiser(nnx.Module):
  """Noise-conditioned denoiser over packed [B, lat, lon, C] tensors.

  Appends noisy targets to forcings channel-wise (static permutation),
  encodes the noise level into the FiLM conditioning vector, and runs the
  architecture. Reference gencast/denoiser.py:142-202.
  """

  def __init__(self, task: TaskSpec, statics: GraphStatics,
               transformer: TransformerConfig,
               config: DenoiserConfig = DenoiserConfig(), *,
               rngs: nnx.Rngs,
               dense_attention_mask: Optional[np.ndarray] = None):
    self.task = task
    self.num_lat = statics.grid_lat.shape[0]
    self.num_lon = statics.grid_lon.shape[0]

    self.input_layout = layout_lib.build_layout(
        task.input_variables, task.pressure_levels, task.num_input_frames)
    self.target_layout = layout_lib.build_layout(
        task.target_variables, task.pressure_levels, 1)
    self.forcing_layout = layout_lib.build_layout(
        task.forcing_variables, task.pressure_levels, 1)
    self.cond_layout, perm = layout_lib.merge_permutation(
        self.forcing_layout, self.target_layout)
    self.cond_perm = StaticData(jnp.asarray(perm))

    num_data_channels = (self.input_layout.num_channels
                         + self.cond_layout.num_channels)
    self.noise_encoder = FourierFeaturesMLP(
        base_period=config.noise_encoder.base_period,
        num_frequencies=config.noise_encoder.num_frequencies,
        output_sizes=config.noise_encoder.output_sizes,
        apply_log_first=config.noise_encoder.apply_log_first,
        rngs=rngs)
    self.architecture = DenoiserArchitecture(
        statics, transformer,
        num_data_channels=num_data_channels,
        node_output_size=self.target_layout.num_channels,
        config=config, rngs=rngs,
        dense_attention_mask=dense_attention_mask)

  def __call__(self,
               inputs: jnp.ndarray,        # [B, lat, lon, C_in]
               noisy_targets: jnp.ndarray,  # [B, lat, lon, C_tgt]
               noise_levels: jnp.ndarray,   # [B]
               forcings: jnp.ndarray,       # [B, lat, lon, C_frc]
               ) -> jnp.ndarray:
    # Conditioning in the compute dtype: noise_levels stay f32 (log/sigma
    # resolution), but a f32 cond vector would re-promote every FiLM-
    # conditioned activation back to f32 under bf16 execution.
    cond = self.noise_encoder(noise_levels).astype(inputs.dtype)  # [B, 16]
    conditioning = jnp.take(
        jnp.concatenate([forcings, noisy_targets], axis=-1),
        self.cond_perm[...], axis=-1)
    grid_data = jnp.concatenate([inputs, conditioning], axis=-1)

    b = grid_data.shape[0]
    g = self.num_lat * self.num_lon
    # [B, lat, lon, C] -> [G, B, C]
    node_data = grid_data.reshape(b, g, -1).transpose(1, 0, 2)
    out = self.architecture(node_data, cond)  # [G, B, out]
    return out.transpose(1, 0, 2).reshape(
        b, self.num_lat, self.num_lon, -1)
