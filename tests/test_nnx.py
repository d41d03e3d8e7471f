"""The in-repo module system (gencast_tpu.nn.nnx): graph split/merge,
state filters and updates, jit write-back, gradients and the optimizer."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from gencast_tpu.nn import nnx
from gencast_tpu.nn.variables import StaticData


class Net(nnx.Module):
  def __init__(self, rngs):
    self.lin = nnx.Linear(4, 3, rngs=rngs)
    self.blocks = nnx.List([nnx.Linear(3, 3, rngs=rngs) for _ in range(2)])
    self.tables = nnx.Dict({'idx': StaticData(jnp.arange(3))})
    self.norm = nnx.LayerNorm(3, rngs=rngs)
    self.scale = 2.0

  def __call__(self, x):
    h = self.lin(x)
    for b in self.blocks:
      h = jax.nn.relu(b(h))
    return self.norm(h)[..., self.tables['idx'][...]] * self.scale


def test_split_merge_round_trip_and_filters():
  m = Net(nnx.Rngs(0))
  gdef, params, rest = nnx.split(m, nnx.Param, ...)
  assert set(params) == {'lin', 'blocks', 'norm'}
  assert set(rest) == {'tables'}
  assert isinstance(params['blocks'][1]['kernel'], nnx.Param)
  m2 = nnx.merge(gdef, params, rest)
  x = jnp.ones((2, 4))
  np.testing.assert_array_equal(np.asarray(m(x)), np.asarray(m2(x)))
  assert m2.scale == 2.0 and m2 is not m
  # Equal structure -> equal, hashable graphdefs (jit cache keys).
  assert nnx.split(m2)[0] == nnx.split(m)[0]
  assert hash(nnx.split(m2)[0]) == hash(nnx.split(m)[0])


def test_update_and_pure_dicts():
  m = Net(nnx.Rngs(0))
  params = nnx.state(m, nnx.Param)
  pure = nnx.to_pure_dict(params)
  assert isinstance(pure['blocks'][0]['kernel'], jax.Array)
  pure = jax.tree.map(jnp.zeros_like, pure)
  nnx.replace_by_pure_dict(params, pure)
  nnx.update(m, params)
  assert not np.asarray(m.blocks[0].kernel[...]).any()
  assert np.asarray(m.tables['idx'][...]).tolist() == [0, 1, 2]


def test_jit_writes_variables_back():
  m = Net(nnx.Rngs(0))

  @nnx.jit
  def bump(model, x):
    model.lin.bias.value = model.lin.bias.value + x
    return model.lin.bias.value.sum()

  out = bump(m, jnp.float32(1.0))
  assert float(out) == pytest.approx(3.0)
  np.testing.assert_allclose(np.asarray(m.lin.bias[...]), 1.0)


def test_value_and_grad_matches_jax_on_params():
  m = Net(nnx.Rngs(1))
  x = jax.random.normal(jax.random.PRNGKey(0), (5, 4))
  loss, grads = nnx.value_and_grad(lambda mm: (mm(x) ** 2).mean())(m)
  gdef, params, rest = nnx.split(m, nnx.Param, ...)
  want = jax.grad(lambda p: (nnx.merge(gdef, p, rest)(x) ** 2).mean())(
      params)
  assert set(grads) == {'lin', 'blocks', 'norm'}   # no StaticData
  for a, b in zip(jax.tree.leaves(grads), jax.tree.leaves(want)):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-6)
  assert np.isfinite(float(loss))


def test_optimizer_steps_params_like_optax():
  m = Net(nnx.Rngs(2))
  tx = optax.adam(1e-2)
  opt = nnx.Optimizer(m, tx, wrt=nnx.Param)
  x = jnp.ones((3, 4))
  p0 = nnx.to_pure_dict(nnx.state(m, nnx.Param))
  _, grads = nnx.value_and_grad(lambda mm: mm(x).sum())(m)
  opt.update(m, grads)
  g = nnx.to_pure_dict(grads)
  upd, _ = tx.update(g, tx.init(p0), p0)
  want = optax.apply_updates(p0, upd)
  got = nnx.to_pure_dict(nnx.state(m, nnx.Param))
  for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-6)
  assert int(opt.step[...]) == 1
  # The optimizer state is part of the graph: split/merge round-trips it.
  gdef, state = nnx.split((m, opt))
  m2, opt2 = nnx.merge(gdef, state)
  assert int(opt2.step[...]) == 1 and opt2.tx is tx


def test_stacked_init_and_layer_scan():
  stack = nnx.stacked_init(lambda r: nnx.Linear(3, 3, rngs=r), 4,
                           nnx.Rngs(0))
  assert stack.kernel[...].shape == (4, 3, 3)
  k = np.asarray(stack.kernel[...])
  assert not np.allclose(k[0], k[1])   # independent draws per layer
  gdef, state = nnx.split(stack)
  y, _ = jax.lax.scan(lambda h, s: (nnx.merge(gdef, s)(h), None),
                      jnp.ones((2, 3)), state)
  assert y.shape == (2, 3)


def test_bare_arrays_are_refused():
  m = nnx.Module()
  m.w = jnp.ones(3)
  with pytest.raises(TypeError, match='bare jax.Array'):
    nnx.split(m)


def test_rngs_streams_are_deterministic_and_distinct():
  a, b = nnx.Rngs(0), nnx.Rngs(0)
  ka, kb = a.params(), b()
  assert (jax.random.key_data(ka) == jax.random.key_data(kb)).all()
  assert not (jax.random.key_data(a()) == jax.random.key_data(ka)).all()
