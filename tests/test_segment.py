"""segment ops: uniform-degree dense fast path vs the scatter reference."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gencast_tpu.ops import segment


def _ref_segment_sum(data, ids, n):
  return jax.ops.segment_sum(jnp.asarray(data), jnp.asarray(ids),
                             num_segments=n)


def test_uniform_degree_detection():
  assert segment._uniform_degree(np.repeat(np.arange(7), 3), 7) == 3
  assert segment._uniform_degree(np.repeat(np.arange(7), 1), 7) == 1
  # Right counts but wrong (interleaved) order must NOT take the fast path.
  assert segment._uniform_degree(np.array([0, 1, 0, 1]), 2) is None
  # Ragged degrees.
  assert segment._uniform_degree(np.array([0, 0, 1, 2, 2, 2]), 3) is None
  # Traced (non-numpy) ids: no static answer.
  assert segment._uniform_degree(jnp.repeat(jnp.arange(7), 3), 7) is None
  assert segment._uniform_degree(np.zeros((0,), np.int32), 4) is None


def test_uniform_segment_sum_matches_scatter():
  rng = np.random.default_rng(0)
  n, k, c = 11, 3, 5
  data = rng.standard_normal((n * k, 2, c)).astype(np.float32)
  ids = np.repeat(np.arange(n), k)
  fast = segment.sorted_segment_sum(jnp.asarray(data), ids, n)
  ref = _ref_segment_sum(data, ids, n)
  np.testing.assert_allclose(np.asarray(fast), np.asarray(ref), rtol=1e-6)
  # Normalization still applied on the fast path.
  fast_n = segment.sorted_segment_sum(jnp.asarray(data), ids, n,
                                      normalization=2.0)
  np.testing.assert_allclose(np.asarray(fast_n), np.asarray(ref) / 2.0,
                             rtol=1e-6)


def test_uniform_gather_matches_take_and_grads():
  rng = np.random.default_rng(1)
  n, k, c = 9, 3, 4
  nodes = rng.standard_normal((n, c)).astype(np.float32)
  idx = np.repeat(np.arange(n), k)

  def fast(x):
    return (segment.gather(x, idx) ** 2).sum()

  def ref(x):
    return (jnp.take(x, jnp.asarray(idx), axis=0) ** 2).sum()

  x = jnp.asarray(nodes)
  np.testing.assert_allclose(np.asarray(segment.gather(x, idx)),
                             np.asarray(jnp.take(x, jnp.asarray(idx), 0)))
  g_fast = jax.grad(fast)(x)
  g_ref = jax.grad(ref)(x)
  np.testing.assert_allclose(np.asarray(g_fast), np.asarray(g_ref),
                             rtol=1e-6)


def test_non_uniform_falls_back():
  ids = np.array([0, 0, 1, 3])  # segment 2 empty
  data = jnp.arange(8, dtype=jnp.float32).reshape(4, 2)
  out = segment.sorted_segment_sum(data, ids, 4)
  ref = _ref_segment_sum(data, ids, 4)
  np.testing.assert_allclose(np.asarray(out), np.asarray(ref))


def _skewed_sorted_ids(rng, n, e):
  """Receiver ids with a heavy-tailed degree: a few hubs, many leaves,
  some empty segments; ascending, as the graph compiler emits them."""
  weights = rng.pareto(1.2, n) + 1e-3
  weights[rng.choice(n, n // 5, replace=False)] = 0.0   # empty segments
  ids = rng.choice(n, e, p=weights / weights.sum())
  return np.sort(ids).astype(np.int32)


@pytest.mark.parametrize('f32_accumulate', [False, True])
@pytest.mark.parametrize('seed', [0, 1])
def test_skewed_segment_sum_and_grad_match_numpy(seed, f32_accumulate):
  rng = np.random.default_rng(seed)
  n, e, c = 37, 400, 6
  ids = _skewed_sorted_ids(rng, n, e)
  data = rng.standard_normal((e, 2, c)).astype(np.float32)
  want = np.zeros((n, 2, c), np.float64)
  np.add.at(want, ids, data.astype(np.float64))
  got = segment.sorted_segment_sum(jnp.asarray(data), ids, n,
                                   f32_accumulate=f32_accumulate,
                                   normalization=4.0)
  np.testing.assert_allclose(np.asarray(got), want / 4.0, rtol=1e-5,
                             atol=1e-5)
  # The transpose of a segment sum is a gather of the cotangent.
  cot = rng.standard_normal((n, 2, c)).astype(np.float32)
  g = jax.grad(lambda d: (segment.sorted_segment_sum(d, ids, n) *
                          cot).sum())(jnp.asarray(data))
  np.testing.assert_allclose(np.asarray(g), cot[ids], rtol=1e-6)


@pytest.mark.parametrize('seed', [0, 1])
def test_unsorted_gather_and_grad_match_numpy(seed):
  rng = np.random.default_rng(seed)
  n, e, c = 23, 300, 5
  idx = rng.integers(0, n, e).astype(np.int32)   # unsorted, repeats
  idx[:7] = 3                                     # one hub
  nodes = rng.standard_normal((n, c)).astype(np.float32)
  got = segment.gather(jnp.asarray(nodes), idx)
  np.testing.assert_array_equal(np.asarray(got), nodes[idx])
  cot = rng.standard_normal((e, c)).astype(np.float32)
  g = jax.grad(lambda x: (segment.gather(x, idx) * cot).sum())(
      jnp.asarray(nodes))
  want = np.zeros((n, c), np.float64)
  np.add.at(want, idx, cot.astype(np.float64))
  np.testing.assert_allclose(np.asarray(g), want, rtol=1e-5, atol=1e-5)


def test_bf16_segment_sum_accumulates_in_f32():
  """f32_accumulate: many small bf16 messages sum in f32 and come back
  in bf16 (the reference's f32_aggregation)."""
  ids = np.zeros(4096, np.int32)
  data = jnp.full((4096, 1), 1e-3, jnp.bfloat16)
  exact = segment.sorted_segment_sum(data, ids, 1, f32_accumulate=True)
  assert exact.dtype == jnp.bfloat16
  np.testing.assert_allclose(float(exact[0, 0]), 4096 * float(data[0, 0]),
                             rtol=1e-2)
