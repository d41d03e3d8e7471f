"""The graph compiler: one-time host-side construction of all static arrays.

Given a mesh refinement level and a lat/lon grid, produces a frozen
`GraphStatics` bundle containing everything the device-side model needs:

* the RCM-permuted icosahedral mesh (banded adjacency for sparse attention),
* grid2mesh / mesh / mesh2grid edge lists with precomputed spatial features,
  each sorted by receiver (enables sorted segment-sum aggregation kernels),
* per-edge-set receiver counts,
* the k-hop banded attention mask in tri-block-diagonal block layout.

This collapses the reference's lazy `_maybe_init` graph construction
(gencast/denoiser.py:343-416) plus the transformer's mask pipeline
(gencast/sparse_transformer.py:554-592) into one explicit, cacheable stage.
Results are cached on disk keyed by the build configuration.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import pickle
from typing import Optional

import numpy as np
from scipy import sparse

from gencast_tpu.graph import connectivity, features, icosahedron
from gencast_tpu.ops.sparse_attention import TilePlan, build_tile_plan


@dataclasses.dataclass(frozen=True)
class EdgeSet:
  """A static directed edge set with precomputed features.

  Edges are sorted by receiver index (stable sort preserving the builder's
  order among ties) so receiver aggregation is a sorted segment-sum.
  """
  senders: np.ndarray    # [E] int32, into the sender node set
  receivers: np.ndarray  # [E] int32, into the receiver node set, ascending
  features: np.ndarray   # [E, 4] float32

  @property
  def num_edges(self) -> int:
    return self.senders.shape[0]


@dataclasses.dataclass(frozen=True)
class BandedMask:
  """Tri-block-diagonal attention mask for the RCM-banded mesh.

  blocks: [3, num_blocks, block, block] bool — diagonal, super-diagonal and
    sub-diagonal blocks of the k-hop adjacency (padded to a multiple of
    `block_size` nodes).
  """
  blocks: np.ndarray
  block_size: int
  num_padding_nodes: int

  @property
  def num_blocks(self) -> int:
    return self.blocks.shape[1]


@dataclasses.dataclass(frozen=True)
class GraphStatics:
  """Everything static about the model's graphs. All numpy, host-resident."""
  # Mesh (RCM-permuted).
  mesh_vertices: np.ndarray      # [M, 3]
  mesh_faces: np.ndarray         # [F, 3]
  mesh_lat: np.ndarray           # [M] degrees
  mesh_lon: np.ndarray           # [M] degrees
  mesh_node_features: np.ndarray  # [M, 3]
  # Grid.
  grid_lat: np.ndarray           # [num_lat] degrees
  grid_lon: np.ndarray           # [num_lon] degrees
  grid_node_features: np.ndarray  # [G, 3], G = num_lat * num_lon
  # Edge sets.
  grid2mesh: EdgeSet             # senders: grid, receivers: mesh
  mesh_edges: EdgeSet            # senders/receivers: mesh (finest level)
  mesh2grid: EdgeSet             # senders: mesh, receivers: grid
  # Attention.
  attention_mask: Optional[BandedMask]
  attention_k_hop: int
  # GraphCast multimesh: union of edges across all refinement levels
  # (vertices = finest mesh). None unless built with build_multimesh=True.
  multimesh_edges: Optional[EdgeSet] = None
  # Block-sparse attention tile plan (Pallas backend). None unless built
  # with attention_tile_size > 0.
  attention_tile_plan: Optional[TilePlan] = None

  @property
  def num_mesh_nodes(self) -> int:
    return self.mesh_vertices.shape[0]

  @property
  def num_grid_nodes(self) -> int:
    return self.grid_lat.shape[0] * self.grid_lon.shape[0]


def rcm_permute(mesh: icosahedron.TriMesh):
  """Reverse-Cuthill-McKee permutation of mesh vertices to banded adjacency.

  Deterministic for a given mesh (reference gencast/denoiser.py:849-867 uses
  the same scipy routine). Returns (permuted_mesh, inverse_permutation) so
  companion structures (e.g. multimesh faces) can be permuted consistently.
  """
  senders, receivers = icosahedron.faces_to_edges(mesh.faces)
  n = mesh.num_vertices
  adj = sparse.csr_matrix(
      (np.ones_like(senders, dtype=np.int8), (senders, receivers)),
      shape=(n, n))
  perm = sparse.csgraph.reverse_cuthill_mckee(adj, symmetric_mode=True)
  inverse = np.empty(n, dtype=np.int64)
  inverse[perm] = np.arange(n)
  permuted = icosahedron.TriMesh(vertices=mesh.vertices[perm],
                                 faces=inverse[mesh.faces].astype(np.int32))
  return permuted, inverse


def _sorted_edge_set(senders: np.ndarray, receivers: np.ndarray,
                     feats: np.ndarray) -> EdgeSet:
  order = np.argsort(receivers, kind='stable')
  return EdgeSet(senders=senders[order].astype(np.int32),
                 receivers=receivers[order].astype(np.int32),
                 features=feats[order])


def khop_mask_csr(senders: np.ndarray, receivers: np.ndarray,
                  num_nodes: int, k_hop: int) -> sparse.csr_matrix:
  """Boolean k-hop reachability (adjacency + self loops, k-th power)."""
  adj = sparse.csr_matrix(
      (np.ones_like(senders, dtype=bool), (senders, receivers)),
      shape=(num_nodes, num_nodes))
  adj = (adj + sparse.identity(num_nodes, dtype=bool, format='csr')
         ).astype(bool)
  # Self loops make adj^k monotone in k, so exponentiation by squaring
  # computes the k-hop closure in O(log k) boolean matmuls.
  power = adj
  result = None
  k = k_hop
  while k:
    if k & 1:
      result = power if result is None else (result @ power).astype(bool)
    k >>= 1
    if k:
      power = (power @ power).astype(bool)
  result.eliminate_zeros()
  return result.tocsr()


def _banded_mask_from_csr(mask: sparse.csr_matrix,
                          block_size_multiple: int = 8) -> BandedMask:
  """Packs a banded boolean mask into tri-block-diagonal blocks.

  block_size_multiple rounds the block size up for aligned einsum tiles;
  correctness only needs block_size > bandwidth.
  """
  num_nodes = mask.shape[0]
  coo = mask.tocoo()

  # Tri-block decomposition needs block_size > bandwidth so that every
  # nonzero lands in the diagonal / super- / sub-diagonal block.
  block_size = int(np.abs(coo.row - coo.col).max()) + 1
  block_size = -(-block_size // block_size_multiple) * block_size_multiple
  num_pad = (-num_nodes) % block_size
  padded = num_nodes + num_pad
  num_blocks = padded // block_size

  dense_ok = padded * block_size * 3 <= 2 ** 31
  assert dense_ok, 'banded mask too large to materialize; increase sparsity'

  csr = mask.tocsr()
  diag = np.zeros((num_blocks, block_size, block_size), dtype=bool)
  upper = np.zeros((num_blocks, block_size, block_size), dtype=bool)
  lower = np.zeros((num_blocks, block_size, block_size), dtype=bool)
  for b in range(num_blocks):
    r0, r1 = b * block_size, min((b + 1) * block_size, num_nodes)
    if r0 >= num_nodes:
      break
    sub = csr[r0:r1]
    c_lo = b * block_size

    def fill(dst, col0):
      c0, c1 = col0, col0 + block_size
      if c0 >= num_nodes or c1 <= 0:
        return
      c0c = max(c0, 0)
      window = sub[:, c0c:min(c1, num_nodes)].toarray()
      dst[b, :r1 - r0, c0c - c0:c0c - c0 + window.shape[1]] = window

    fill(diag, c_lo)
    fill(upper, c_lo + block_size)
    fill(lower, c_lo - block_size)

  return BandedMask(blocks=np.stack([diag, upper, lower]),
                    block_size=block_size, num_padding_nodes=num_pad)


def _cache_key(**kwargs) -> str:
  blob = pickle.dumps(sorted(kwargs.items()))
  return hashlib.sha256(blob).hexdigest()[:16]


def build_graph_statics(
    mesh_splits: int,
    grid_lat: np.ndarray,
    grid_lon: np.ndarray,
    radius_query_fraction_edge_length: float = 0.6,
    attention_k_hop: int = 16,
    build_attention_mask: bool = True,
    attention_tile_size: int = 0,
    build_triblock_mask: bool = True,
    build_multimesh: bool = False,
    block_size_multiple: int = 8,
    cache_dir: Optional[str] = None,
) -> GraphStatics:
  """Compiles all static graph structure for a (mesh, grid) pair.

  Args:
    mesh_splits: icosahedron refinement level (4 -> 2562 mesh nodes).
    grid_lat: latitude values in degrees, ascending.
    grid_lon: longitude values in degrees.
    radius_query_fraction_edge_length: grid2mesh connectivity radius as a
      fraction of the longest mesh edge.
    attention_k_hop: neighborhood hops for the mesh attention mask.
    build_attention_mask: skip the (relatively expensive) mask build when the
      processor is a GNN (GraphCast) rather than a transformer.
    cache_dir: directory for on-disk caching; None disables caching.
  """
  grid_lat = np.asarray(grid_lat, dtype=np.float32)
  grid_lon = np.asarray(grid_lon, dtype=np.float32)

  cache_path = None
  if cache_dir is not None:
    key = _cache_key(splits=mesh_splits, lat=grid_lat.tobytes(),
                     lon=grid_lon.tobytes(),
                     frac=radius_query_fraction_edge_length,
                     k_hop=attention_k_hop, mask=build_attention_mask,
                     triblock=build_triblock_mask,
                     tile=attention_tile_size,
                     multimesh=build_multimesh,
                     bsm=block_size_multiple, v=4)
    cache_path = os.path.join(cache_dir, f'graph_{key}.pkl')
    if os.path.exists(cache_path):
      with open(cache_path, 'rb') as f:
        return pickle.load(f)

  hierarchy = icosahedron.mesh_hierarchy(mesh_splits)
  # One permutation applied consistently to the finest mesh and (for the
  # GraphCast multimesh) the merged face set.
  mesh, inv_perm = rcm_permute(hierarchy[-1])
  mesh_phi, mesh_theta = features.xyz_to_spherical(mesh.vertices)
  mesh_lat, mesh_lon = features.spherical_to_lat_lon(mesh_phi, mesh_theta)
  mesh_lat = mesh_lat.astype(np.float32)
  mesh_lon = mesh_lon.astype(np.float32)

  grid_mesh_lon, grid_mesh_lat = np.meshgrid(grid_lon, grid_lat)
  grid_nodes_lat = grid_mesh_lat.reshape(-1).astype(np.float32)
  grid_nodes_lon = grid_mesh_lon.reshape(-1).astype(np.float32)

  senders_m, receivers_m = icosahedron.faces_to_edges(mesh.faces)
  max_edge_len = float(np.linalg.norm(
      mesh.vertices[senders_m] - mesh.vertices[receivers_m], axis=-1).max())
  radius = max_edge_len * radius_query_fraction_edge_length

  # --- grid2mesh ---
  g2m_grid, g2m_mesh = connectivity.radius_query(grid_lat, grid_lon, mesh,
                                                 radius)
  g2m_feats = features.edge_features(
      grid_nodes_lat, grid_nodes_lon, g2m_grid,
      mesh_lat, mesh_lon, g2m_mesh).features

  # --- mesh ---
  mesh_feats = features.edge_features(
      mesh_lat, mesh_lon, senders_m, mesh_lat, mesh_lon, receivers_m).features

  # --- mesh2grid ---
  m2g_grid, m2g_mesh = connectivity.containing_triangle_edges(
      grid_lat, grid_lon, mesh)
  m2g_feats = features.edge_features(
      mesh_lat, mesh_lon, m2g_mesh,
      grid_nodes_lat, grid_nodes_lon, m2g_grid).features

  mask = None
  tile_plan = None
  if build_attention_mask:
    csr = khop_mask_csr(senders_m, receivers_m, mesh.num_vertices,
                        attention_k_hop)
    if build_triblock_mask:
      # Skippable at paper scale (splits=6 bandwidth makes the dense
      # tri-block layout ~1GB); the Pallas path needs only the tile plan.
      mask = _banded_mask_from_csr(csr,
                                   block_size_multiple=block_size_multiple)
    if attention_tile_size:
      tile_plan = build_tile_plan(csr, tile=attention_tile_size)

  multimesh_es = None
  if build_multimesh:
    merged = icosahedron.merge_hierarchy(hierarchy)
    mm_faces = inv_perm[merged.faces].astype(np.int32)
    mm_s, mm_r = icosahedron.faces_to_edges(mm_faces)
    mm_feats = features.edge_features(
        mesh_lat, mesh_lon, mm_s, mesh_lat, mesh_lon, mm_r).features
    multimesh_es = _sorted_edge_set(mm_s, mm_r, mm_feats)

  statics = GraphStatics(
      mesh_vertices=mesh.vertices.astype(np.float32),
      mesh_faces=mesh.faces,
      mesh_lat=mesh_lat,
      mesh_lon=mesh_lon,
      mesh_node_features=features.node_features(mesh_lat, mesh_lon),
      grid_lat=grid_lat,
      grid_lon=grid_lon,
      grid_node_features=features.node_features(grid_nodes_lat,
                                                grid_nodes_lon),
      grid2mesh=_sorted_edge_set(g2m_grid, g2m_mesh, g2m_feats),
      mesh_edges=_sorted_edge_set(senders_m, receivers_m, mesh_feats),
      mesh2grid=_sorted_edge_set(m2g_mesh, m2g_grid, m2g_feats),
      attention_mask=mask,
      attention_k_hop=attention_k_hop,
      multimesh_edges=multimesh_es,
      attention_tile_plan=tile_plan,
  )

  if cache_path is not None:
    os.makedirs(cache_dir, exist_ok=True)
    tmp = cache_path + '.tmp'
    with open(tmp, 'wb') as f:
      pickle.dump(statics, f)
    os.replace(tmp, cache_path)
  return statics
