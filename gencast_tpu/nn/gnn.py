"""Typed graph networks over static topologies.

The counterpart of the reference's typed_graph_net.py +
deep_typed_graph_net.py: node/edge sets are plain dicts of [N, B, C] /
[E, B, C] arrays, topology (sender/receiver indices) is static numpy fixed
at construction, and aggregation is a sorted segment-sum. All MLP input
widths are known statically from the graph compiler, so construction is
eager — no lazy-init or dummy-channel machinery
(cf. gencast/denoiser.py:479-491 in the reference).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Mapping, Optional, Tuple

from gencast_tpu.nn import nnx
import jax
import jax.numpy as jnp
import numpy as np

from gencast_tpu.nn.mlp import MLP, CondMLP
from gencast_tpu.nn.variables import StaticData
from gencast_tpu.ops import segment


@dataclasses.dataclass(frozen=True, eq=False)
class EdgeTopology:
  """Static structure of one directed edge set, receivers ascending.

  Lives as static (hashable) metadata inside jitted module graphdefs, so
  equality/hash must be well-defined for numpy fields — content-based
  equality lets a re-created model hit the jit cache instead of crashing
  pytree metadata comparison.
  """
  name: str
  sender_set: str
  receiver_set: str
  senders: np.ndarray
  receivers: np.ndarray

  @property
  def num_edges(self) -> int:
    return self.senders.shape[0]

  def __eq__(self, other):
    return (isinstance(other, EdgeTopology)
            and self.name == other.name
            and self.sender_set == other.sender_set
            and self.receiver_set == other.receiver_set
            and np.array_equal(self.senders, other.senders)
            and np.array_equal(self.receivers, other.receivers))

  def __hash__(self):
    return hash((self.name, self.sender_set, self.receiver_set,
                 self.senders.shape[0]))


def _activation(name: str) -> Callable:
  if name == 'identity':
    return lambda x: x
  return getattr(jax.nn, name)


def _chunked_node_apply(fn: Callable, arrays, chunk: int) -> jnp.ndarray:
  """Applies a node-pointwise fn over leading-axis chunks.

  Rematerialized lax.scan: numerically identical to fn(*arrays) but the
  backward's working set is one chunk's MLP internals instead of the full
  [num_nodes, ...] activations (several GB at 0.25 degrees).
  """
  n = arrays[0].shape[0]
  n_chunks = -(-n // chunk)
  if n % n_chunks == 0:
    # Exact division: reshape without the pad copy (a full [n, latent]
    # pad temp costs 2GB at 0.25 degrees).
    chunk = n // n_chunks
    pad = 0
    xs = tuple(a.reshape((n_chunks, chunk) + a.shape[1:]) for a in arrays)
  else:
    pad = n_chunks * chunk - n
    xs = tuple(
        jnp.pad(a, ((0, pad),) + ((0, 0),) * (a.ndim - 1))
        .reshape((n_chunks, chunk) + a.shape[1:]) for a in arrays)

  def body(carry, xs_c):
    return carry, fn(*xs_c)

  _, out = jax.lax.scan(jax.checkpoint(body), 0, xs)
  out = out.reshape((out.shape[0] * out.shape[1],) + out.shape[2:])
  return out[:n] if pad else out


NodeFeats = Dict[str, jnp.ndarray]   # set name -> [N, B, C]
EdgeFeats = Dict[str, jnp.ndarray]   # edge set name -> [E, B, C]


class InteractionNetwork(nnx.Module):
  """One message-passing step: edge update then node update.

  Edge update: MLP(concat[edge, sender_nodes[s], receiver_nodes[r]]).
  Node update: MLP(concat[node, aggregated incoming messages per edge set]).
  (Battaglia et al. Alg. 1 without globals; reference
  common/typed_graph_net.py:238-326.)
  """

  def __init__(self, *,
               topologies: List[EdgeTopology],
               node_sizes: Mapping[str, int],
               edge_sizes: Mapping[str, int],
               num_nodes: Mapping[str, int],
               mlp_hidden_size: int,
               mlp_num_hidden_layers: int,
               activation: Callable,
               use_layer_norm: bool,
               use_norm_conditioning: bool,
               f32_aggregation: bool,
               aggregate_normalization: Optional[float],
               rngs: nnx.Rngs):
    self.topologies = topologies
    self.num_nodes = dict(num_nodes)
    self.f32_aggregation = f32_aggregation
    self.aggregate_normalization = aggregate_normalization

    self.edge_mlps = nnx.Dict()
    for topo in topologies:
      in_size = (edge_sizes[topo.name] + node_sizes[topo.sender_set]
                 + node_sizes[topo.receiver_set])
      self.edge_mlps[topo.name] = CondMLP(
          in_size, mlp_hidden_size, mlp_num_hidden_layers,
          edge_sizes[topo.name], activation,
          use_layer_norm=use_layer_norm,
          use_norm_conditioning=use_norm_conditioning, rngs=rngs)

    self.node_mlps = nnx.Dict()
    for name, size in node_sizes.items():
      in_size = size + sum(
          edge_sizes[t.name] for t in topologies if t.receiver_set == name)
      self.node_mlps[name] = CondMLP(
          in_size, mlp_hidden_size, mlp_num_hidden_layers, size, activation,
          use_layer_norm=use_layer_norm,
          use_norm_conditioning=use_norm_conditioning, rngs=rngs)

  def __call__(self, nodes: NodeFeats, edges: EdgeFeats,
               cond: Optional[jnp.ndarray] = None
               ) -> Tuple[NodeFeats, EdgeFeats]:
    new_edges = {}
    for topo in self.topologies:
      sent = segment.gather(nodes[topo.sender_set], topo.senders)
      received = segment.gather(nodes[topo.receiver_set], topo.receivers)
      concat = jnp.concatenate([edges[topo.name], sent, received], axis=-1)
      new_edges[topo.name] = self.edge_mlps[topo.name](concat, cond)

    new_nodes = {}
    for name, mlp in self.node_mlps.items():
      parts = [nodes[name]]
      for topo in self.topologies:
        if topo.receiver_set == name:
          with jax.named_scope(f'segment_sum_{topo.name}'):
            parts.append(segment.sorted_segment_sum(
                new_edges[topo.name], topo.receivers,
                num_segments=self.num_nodes[name],
                f32_accumulate=self.f32_aggregation,
                normalization=self.aggregate_normalization))
      new_nodes[name] = mlp(jnp.concatenate(parts, axis=-1), cond)
    return new_nodes, new_edges


class TypedGraphNet(nnx.Module):
  """Encode-process-decode deep GNN over a static typed graph.

  Embedder MLPs lift raw node/edge features to latents, N unshared (x M
  shared repetitions) InteractionNetwork steps run with node+edge residual
  connections, decoder MLPs (plain, no norm) project listed node sets to
  outputs. Reference: common/deep_typed_graph_net.py:214-589.
  """

  def __init__(self, *,
               topologies: List[EdgeTopology],
               num_nodes: Mapping[str, int],
               node_input_sizes: Mapping[str, int],
               edge_input_sizes: Mapping[str, int],
               node_latent_size: Mapping[str, int],
               edge_latent_size: Mapping[str, int],
               mlp_hidden_size: int,
               mlp_num_hidden_layers: int = 1,
               num_message_passing_steps: int = 1,
               num_processor_repetitions: int = 1,
               embed_nodes: bool = True,
               embed_edges: bool = True,
               node_output_sizes: Optional[Mapping[str, int]] = None,
               activation: str = 'swish',
               use_layer_norm: bool = True,
               use_norm_conditioning: bool = True,
               f32_aggregation: bool = False,
               aggregate_normalization: Optional[float] = None,
               edge_chunk_size: Optional[int] = None,
               remat_steps: bool = False,
               remat_group: int = 1,
               rngs: nnx.Rngs):
    act = _activation(activation)
    self.num_processor_repetitions = num_processor_repetitions
    # jax.checkpoint around every processor message-passing step (dense
    # path only; the streaming path remats internally per edge chunk).
    # remat_group > 1 nests those per-step checkpoints inside
    # group-of-steps checkpoints (sqrt-style hierarchical remat) to
    # shrink live step-boundary storage for deep unshared processors.
    self.remat_steps = remat_steps
    self.remat_group = remat_group
    # Streamed edge processing: lax.scan over edge chunks, fusing edge
    # embedding + edge update + receiver aggregation so no [E, B, latent]
    # tensor is ever materialized. Only valid for single-step graphs whose
    # callers don't consume output edge latents (the grid2mesh / mesh2grid
    # encoders at paper scale: 3.1M edges x 1028-wide concats otherwise
    # exceed single-chip HBM). Trades recompute/loop overhead for memory.
    self.edge_chunk_size = edge_chunk_size
    self.stream_indices = nnx.Dict()
    # name -> (per-topology chunk size, uniform receiver degree or None).
    # Uniform-degree receiver-sorted edge sets (mesh2grid: exactly 3
    # senders per grid node) get a degree-aligned chunk so every chunk
    # holds whole receivers: aggregation becomes a dense reshape-sum
    # emitted through the scan, and the receiver gather a contiguous
    # row broadcast — no scatter anywhere (the generic path scatters into
    # a [1.04M, 512] accumulator at 0.25 degrees three times per step:
    # forward aggregation, remat replay and receiver-gather transpose).
    self.stream_meta = {}
    if edge_chunk_size is not None:
      if num_message_passing_steps != 1 or num_processor_repetitions != 1:
        raise ValueError('edge_chunk_size requires a single-step graph net')
      # Chunked sender/receiver/validity tables as device buffers: plain
      # numpy here would be baked into the HLO as multi-MB constants at
      # paper scale.
      for topo in topologies:
        e = topo.num_edges
        k_uni = segment._uniform_degree(topo.receivers,
                                        num_nodes[topo.receiver_set])
        chunk = edge_chunk_size
        if k_uni is not None and chunk >= k_uni:
          chunk -= chunk % k_uni
        else:
          k_uni = None
        self.stream_meta[topo.name] = (chunk, k_uni)
        n_chunks = -(-e // chunk)
        pad = n_chunks * chunk - e
        send_p = np.pad(topo.senders, (0, pad)).astype(np.int32)
        recv_p = np.pad(topo.receivers, (0, pad)).astype(np.int32)
        valid = np.pad(np.ones(e, np.float32), (0, pad))
        self.stream_indices[topo.name] = nnx.List([
            StaticData(jnp.asarray(send_p.reshape(n_chunks, chunk))),
            StaticData(jnp.asarray(recv_p.reshape(n_chunks, chunk))),
            StaticData(jnp.asarray(valid.reshape(n_chunks, chunk))),
        ])
    self.f32_aggregation = f32_aggregation
    self.aggregate_normalization = aggregate_normalization
    self.topologies = topologies
    self.num_nodes = dict(num_nodes)

    # Uniform latent size is required by the concat-based updates.
    self.node_latent_size = dict(node_latent_size)
    self.edge_latent_size = dict(edge_latent_size)

    self.node_embedders = nnx.Dict()
    self._embedded_node_keys = ()
    if embed_nodes:
      self._embedded_node_keys = tuple(node_latent_size)
      for name, latent in node_latent_size.items():
        self.node_embedders[name] = CondMLP(
            node_input_sizes[name], mlp_hidden_size, mlp_num_hidden_layers,
            latent, act, use_layer_norm=use_layer_norm,
            use_norm_conditioning=use_norm_conditioning, rngs=rngs)
    self.edge_embedders = nnx.Dict()
    self._embedded_edge_keys = ()
    if embed_edges:
      self._embedded_edge_keys = tuple(edge_latent_size)
      for name, latent in edge_latent_size.items():
        self.edge_embedders[name] = CondMLP(
            edge_input_sizes[name], mlp_hidden_size, mlp_num_hidden_layers,
            latent, act, use_layer_norm=use_layer_norm,
            use_norm_conditioning=use_norm_conditioning, rngs=rngs)

    self.processors = nnx.List([
        InteractionNetwork(
            topologies=topologies,
            node_sizes=node_latent_size,
            edge_sizes=edge_latent_size,
            num_nodes=num_nodes,
            mlp_hidden_size=mlp_hidden_size,
            mlp_num_hidden_layers=mlp_num_hidden_layers,
            activation=act,
            use_layer_norm=use_layer_norm,
            use_norm_conditioning=use_norm_conditioning,
            f32_aggregation=f32_aggregation,
            aggregate_normalization=aggregate_normalization,
            rngs=rngs)
        for _ in range(num_message_passing_steps)
    ])

    self.node_decoders = nnx.Dict()
    self._decoded_node_keys = tuple(node_output_sizes or ())
    for name, out in (node_output_sizes or {}).items():
      self.node_decoders[name] = MLP(
          node_latent_size[name], mlp_hidden_size, mlp_num_hidden_layers,
          out, act, rngs=rngs)

  def __call__(self, nodes: NodeFeats, edges: EdgeFeats,
               cond: Optional[jnp.ndarray] = None
               ) -> Tuple[NodeFeats, EdgeFeats]:
    if self.edge_chunk_size is not None:
      return self._streaming_call(nodes, edges, cond)

    nodes = {k: (self.node_embedders[k](v, cond)
                 if k in self._embedded_node_keys else v)
             for k, v in nodes.items()}
    edges = {k: (self.edge_embedders[k](v, cond)
                 if k in self._embedded_edge_keys else v)
             for k, v in edges.items()}

    def make_step(processor):
      def step(nodes, edges, cond, _p=processor):
        upd_nodes, upd_edges = _p(nodes, edges, cond)
        return ({k: nodes[k] + upd_nodes[k] for k in nodes},
                {k: edges[k] + upd_edges[k] for k in edges})
      # Per-step remat for deep unshared processors (GraphCast's 16
      # multimesh MP steps at 0.25 degrees): the backward recomputes
      # each step's edge/node MLP internals (~1.5 GB bf16 per step at
      # paper scale) and keeps only the step-boundary latents.
      return jax.checkpoint(step) if self.remat_steps else step

    seq = [p for _ in range(self.num_processor_repetitions)
           for p in self.processors]
    group = self.remat_group if self.remat_steps else 1
    if group <= 1:
      for processor in seq:
        nodes, edges = make_step(processor)(nodes, edges, cond)
    else:
      # Hierarchical (sqrt-style) rematerialization: nested checkpoints
      # over GROUPS of steps cut the forward's live step-boundary
      # storage from num_steps boundaries to num_groups + group_size
      # (each boundary is the full loop-carried node+edge latent state —
      # ~480 MB bf16 per step at GraphCast-0.25-degree scale, which is
      # what OOM'd the 37-level published configuration under flat
      # per-step remat). Cost: one extra forward recompute of each step
      # during the backward.
      for start in range(0, len(seq), group):
        def run_group(nodes, edges, cond, _ps=tuple(seq[start:start + group])):
          for p in _ps:
            nodes, edges = make_step(p)(nodes, edges, cond)
          return nodes, edges
        nodes, edges = jax.checkpoint(run_group)(nodes, edges, cond)

    out_nodes = {k: (self.node_decoders[k](v)
                     if k in self._decoded_node_keys else v)
                 for k, v in nodes.items()}
    return out_nodes, edges

  def _streaming_call(self, nodes: NodeFeats, edges: EdgeFeats,
                      cond: Optional[jnp.ndarray]
                      ) -> Tuple[NodeFeats, EdgeFeats]:
    """Single-step forward with edges processed in fixed-size chunks.

    Numerically equivalent to the dense path for 1-step graphs, except
    output edge latents are not produced (returned as the raw inputs).
    """
    chunk = self.edge_chunk_size

    def node_chunked(fn, arrays):
      if arrays[0].shape[0] > chunk:
        return _chunked_node_apply(fn, arrays, chunk)
      return fn(*arrays)

    node_lat = {}
    for k, v in nodes.items():
      if k in self._embedded_node_keys:
        emb = self.node_embedders[k]
        node_lat[k] = node_chunked(
            lambda v_c, emb=emb: emb(v_c, cond), [v])
      else:
        node_lat[k] = v
    processor = self.processors[0]

    agg = {}
    for topo in self.topologies:
      raw_e = edges[topo.name]
      e, b = raw_e.shape[0], raw_e.shape[1]
      e_chunk, k_uni = self.stream_meta[topo.name]
      n_chunks = -(-e // e_chunk)
      pad = n_chunks * e_chunk - e
      raw_p = jnp.pad(raw_e, ((0, pad), (0, 0), (0, 0)))
      send_c, recv_c, valid_c = (v[...]
                                 for v in self.stream_indices[topo.name])

      acc_dtype = jnp.float32 if self.f32_aggregation else raw_e.dtype
      sender_lat = node_lat[topo.sender_set]
      receiver_lat = node_lat[topo.receiver_set]
      embed = (self.edge_embedders[topo.name]
               if topo.name in self._embedded_edge_keys else None)
      edge_mlp = processor.edge_mlps[topo.name]

      # Remat the chunk bodies below: without it AD stacks each chunk's
      # MLP residuals ([n_chunks, chunk, ~3*latent]) — the full edge
      # tensor the streaming path exists to avoid. Scan-invariant node
      # latents are saved once, not per chunk.
      if k_uni is not None:
        # Uniform receiver degree (mesh2grid's 3 senders per grid node):
        # chunks hold whole receivers, so each chunk CONTRIBUTES a dense
        # [rows, B, latent] reshape-sum emitted through the scan — no
        # accumulator carry, no scatter — and the receiver latents arrive
        # as a contiguous row slice broadcast edge-wise (its AD transpose
        # is a dense sum, not a scatter). Bitwise the same sums as the
        # dense path's uniform-degree fast path.
        rows = e_chunk // k_uni
        num_recv = self.num_nodes[topo.receiver_set]
        # Closure-capture the (lightly padded) receiver latents and
        # dynamic-slice each chunk's contiguous rows inside the body —
        # stacking the rows as a scan input would materialize a second
        # full copy of the receiver latents ([1.04M, 512] ≈ 1 GB at
        # 0.25 degrees). As a scan constant it is saved once and
        # its AD transpose is a dense dynamic_update_slice accumulation,
        # not a scatter.
        recv_pad = jnp.pad(
            receiver_lat,
            ((0, n_chunks * rows - num_recv), (0, 0), (0, 0)))

        norm = self.aggregate_normalization

        def body_u(carry, xs, embed=embed, edge_mlp=edge_mlp,
                   sender_lat=sender_lat, recv_pad=recv_pad,
                   rows=rows, k_uni=k_uni, norm=norm):
          raw_c, s_idx, v_c, start = xs
          r_rows = jax.lax.dynamic_slice_in_dim(recv_pad, start, rows)
          e_lat = embed(raw_c, cond) if embed is not None else raw_c
          r_rep = jnp.broadcast_to(
              r_rows[:, None], (rows, k_uni) + r_rows.shape[1:]).reshape(
                  (rows * k_uni,) + r_rows.shape[1:])
          concat = jnp.concatenate(
              [e_lat, sender_lat[s_idx], r_rep], axis=-1)
          msg = edge_mlp(concat, cond) * v_c[:, None, None]
          part = msg.astype(acc_dtype).reshape(
              (rows, k_uni) + msg.shape[1:]).sum(axis=1)
          if norm is not None:
            part = part / norm
          # Each receiver's COMPLETE degree-k sum is intra-chunk, so the
          # acc_dtype math finishes here: emit in the edge dtype. This
          # matches the generic path's final astype (acc_dtype sums, one
          # final cast) and keeps the stacked scan output small when
          # f32_aggregation is on.
          return carry, part.astype(raw_c.dtype)

        xs = (raw_p.reshape(n_chunks, e_chunk, b, -1),
              send_c, valid_c.astype(raw_e.dtype),
              jnp.arange(n_chunks, dtype=jnp.int32) * rows)
        _, parts = jax.lax.scan(jax.checkpoint(body_u), 0, xs)
        agg[topo.name] = parts.reshape(
            (n_chunks * rows,) + parts.shape[2:])[:num_recv]
        continue
      else:
        latent = self.edge_latent_size[topo.name]
        acc0 = jnp.zeros((self.num_nodes[topo.receiver_set], b, latent),
                         acc_dtype)

        def body(acc, xs, embed=embed, edge_mlp=edge_mlp,
                 sender_lat=sender_lat, receiver_lat=receiver_lat):
          raw_c, s_idx, r_idx, v_c = xs
          e_lat = embed(raw_c, cond) if embed is not None else raw_c
          concat = jnp.concatenate(
              [e_lat, sender_lat[s_idx], receiver_lat[r_idx]], axis=-1)
          msg = edge_mlp(concat, cond) * v_c[:, None, None]
          return acc.at[r_idx].add(msg.astype(acc.dtype)), ()

        xs = (raw_p.reshape(n_chunks, e_chunk, b, -1),
              send_c, recv_c, valid_c.astype(raw_e.dtype))
        acc, _ = jax.lax.scan(jax.checkpoint(body), acc0, xs)
      if self.aggregate_normalization is not None:
        acc = acc / self.aggregate_normalization
      agg[topo.name] = acc.astype(raw_e.dtype)

    out_nodes = {}
    for name, mlp in processor.node_mlps.items():
      aggs = [agg[t.name] for t in self.topologies
              if t.receiver_set == name]
      decoder = (self.node_decoders[name]
                 if name in self._decoded_node_keys else None)

      def update_fn(lat_c, *agg_c, mlp=mlp, decoder=decoder):
        out = lat_c + mlp(jnp.concatenate([lat_c, *agg_c], -1), cond)
        return decoder(out) if decoder is not None else out

      out_nodes[name] = node_chunked(update_fn, [node_lat[name], *aggs])
    return out_nodes, edges
