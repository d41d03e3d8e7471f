"""Edge -> node aggregation over static, receiver-sorted edge lists.

The graph compiler sorts every edge set by receiver, so aggregation is a
sorted segment-sum. Two strategies:

1. Uniform-degree fast path: mesh2grid edges have exactly 3 senders per
   grid node (the containing triangle) and are receiver-sorted, so the
   segment ids are `repeat(arange(N), 3)` and the reduction is a dense
   reshape+sum (and its AD transpose a dense broadcast).
2. Otherwise XLA's sorted segment sum (`indices_are_sorted=True`), and
   `jnp.take` for the sender gather.

Replaces jraph.segment_sum usage in the reference
(common/typed_graph_net.py:62-64, 173, 182).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np


def _uniform_degree(segment_ids, num_segments: int) -> Optional[int]:
  """k if segment_ids == repeat(arange(num_segments), k) exactly, else None.

  Only answered for static (numpy) indices — the check runs at trace time.
  """
  if not isinstance(segment_ids, np.ndarray):
    return None
  e = int(segment_ids.shape[0])
  if e == 0 or num_segments <= 0 or e % num_segments:
    return None
  k = e // num_segments
  if int(segment_ids[0]) != 0 or int(segment_ids[-1]) != num_segments - 1:
    return None
  expected = np.repeat(np.arange(num_segments, dtype=segment_ids.dtype), k)
  return k if np.array_equal(segment_ids, expected) else None


def sorted_segment_sum(
    data: jnp.ndarray,          # [E, ...]
    segment_ids: jnp.ndarray,   # [E] ascending
    num_segments: int,
    f32_accumulate: bool = False,
    normalization: Optional[float] = None,
) -> jnp.ndarray:
  """Sum of `data` rows per receiver segment, shape [num_segments, ...].

  f32_accumulate upcasts bf16 messages to f32 for the reduction and casts
  back (the reference's f32_aggregation,
  common/deep_typed_graph_net.py:396-404).
  """
  dtype = data.dtype
  if f32_accumulate and dtype != jnp.float32:
    data = data.astype(jnp.float32)
  k = _uniform_degree(segment_ids, num_segments)
  if k is not None:
    out = data.reshape((num_segments, k) + data.shape[1:]).sum(axis=1)
  else:
    out = jax.ops.segment_sum(data, segment_ids, num_segments=num_segments,
                              indices_are_sorted=True)
  if normalization is not None:
    out = out / normalization
  if f32_accumulate and dtype != jnp.float32:
    out = out.astype(dtype)
  return out


def gather(nodes: jnp.ndarray, indices: jnp.ndarray) -> jnp.ndarray:
  """nodes[indices] along the leading axis; [N, ...] -> [E, ...]."""
  n = nodes.shape[0]
  k = _uniform_degree(indices, n) if isinstance(indices, np.ndarray) else None
  if k is not None:
    # indices == repeat(arange(n), k): broadcast instead of gather, so the
    # AD transpose is a dense sum over the repeat axis, not a scatter-add.
    e = indices.shape[0]
    rep = jnp.broadcast_to(nodes[:, None], (n, k) + nodes.shape[1:])
    return rep.reshape((e,) + nodes.shape[1:])
  return jnp.take(nodes, indices, axis=0, indices_are_sorted=False,
                  unique_indices=False)
