"""A small module system: the part of the Flax NNX API this package uses.

Modules are plain Python objects whose attributes hold `Variable`s
(parameters and device buffers), child modules, containers of either, and
static configuration. `split` turns an object graph into a hashable
`GraphDef` and a `State` (a nested dict pytree of Variables); `merge`
rebuilds a fresh graph from the two. Everything else (`jit`,
`value_and_grad`, `Optimizer`, ...) is written on top of that pair, so
the models run with nothing beyond JAX, numpy and optax.

Supported surface: Module, List, Dict, Variable, Param, Rngs, Linear,
LayerNorm, Optimizer, initializers, with_partitioning, split, merge,
state, update, to_pure_dict, replace_by_pure_dict, jit, grad,
value_and_grad and stacked_init (layer stacks for `lax.scan`).
"""

from __future__ import annotations

import functools
import types
from typing import Any, Callable, Dict as TDict, Iterator, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import optax

# ---------------------------------------------------------------------------
# Variables.
# ---------------------------------------------------------------------------


class _WithMetadata:
  """An initializer's value plus metadata for the Variable that wraps it."""

  def __init__(self, value, metadata):
    self.value = value
    self.metadata = metadata


class Variable:
  """A mutable box around one array (or pytree) plus hashable metadata.

  Each subclass is its own pytree node type: the value is the child and
  (type, metadata) the static part, so a State of Variables goes through
  `jax.tree.map`, `jax.grad`, `jit` and optax with its types intact.
  """

  def __init_subclass__(cls, **kwargs):
    super().__init_subclass__(**kwargs)
    jax.tree_util.register_pytree_node(cls, _var_flatten,
                                       functools.partial(_var_unflatten, cls))

  def __init__(self, value, **metadata):
    if isinstance(value, _WithMetadata):
      metadata = {**value.metadata, **metadata}
      value = value.value
    self.value = value
    self.metadata = tuple(sorted(metadata.items()))

  def __getitem__(self, idx):
    return self.value[idx]

  def __setitem__(self, idx, val):
    if idx is Ellipsis:
      self.value = val
    else:
      self.value = self.value.at[idx].set(val)

  @property
  def sharding(self):
    """The PartitionSpec this variable was annotated with, or None."""
    return dict(self.metadata).get('sharding')

  def replace(self, value) -> 'Variable':
    return _var_unflatten(type(self), self.metadata, (value,))

  def __repr__(self):
    v = self.value
    desc = (f'{v.dtype}{list(v.shape)}' if hasattr(v, 'shape')
            else type(v).__name__)
    return f'{type(self).__name__}({desc})'


def _var_flatten(v):
  return (v.value,), v.metadata


def _var_unflatten(cls, metadata, children):
  v = object.__new__(cls)
  v.value = children[0]
  v.metadata = metadata
  return v


jax.tree_util.register_pytree_node(
    Variable, _var_flatten, functools.partial(_var_unflatten, Variable))


class Param(Variable):
  """A trainable parameter."""


class OptState(Variable):
  """Optimizer state: the step counter and optax's moments."""


def _is_var(x) -> bool:
  return isinstance(x, Variable)


def with_partitioning(init: Callable, sharding) -> Callable:
  """Wraps an initializer so its Variable carries a PartitionSpec."""
  def wrapped(*args, **kwargs):
    return _WithMetadata(init(*args, **kwargs), {'sharding': sharding})
  return wrapped


initializers = types.SimpleNamespace(
    **{name: getattr(jax.nn.initializers, name)
       for name in ('constant', 'glorot_normal', 'glorot_uniform',
                    'he_normal', 'he_uniform', 'lecun_normal',
                    'lecun_uniform', 'normal', 'ones', 'truncated_normal',
                    'uniform', 'variance_scaling', 'xavier_normal',
                    'xavier_uniform', 'zeros')},
    zeros_init=lambda: jax.nn.initializers.zeros,
    ones_init=lambda: jax.nn.initializers.ones)


# ---------------------------------------------------------------------------
# Modules and containers.
# ---------------------------------------------------------------------------


class Module:
  """Base class: every attribute is a graph child or static data."""

  def _graph_items(self) -> Iterator[Tuple[Any, Any]]:
    return iter(sorted(vars(self).items()))

  @classmethod
  def _graph_build(cls, items: TDict[Any, Any]) -> 'Module':
    obj = object.__new__(cls)
    obj.__dict__.update(items)
    return obj


class List(Module):
  """A list of modules or variables, addressed by index in the State."""

  def __init__(self, items=()):
    self._items = list(items)

  def _graph_items(self):
    return iter(enumerate(self._items))

  @classmethod
  def _graph_build(cls, items):
    obj = object.__new__(cls)
    obj._items = [items[i] for i in range(len(items))]
    return obj

  def append(self, item):
    self._items.append(item)

  def __getitem__(self, i):
    return self._items[i]

  def __setitem__(self, i, item):
    self._items[i] = item

  def __len__(self):
    return len(self._items)

  def __iter__(self):
    return iter(self._items)


class Dict(Module):
  """A string-keyed mapping of modules or variables."""

  def __init__(self, items=None):
    self._items = dict(items or {})

  def _graph_items(self):
    return iter(self._items.items())

  @classmethod
  def _graph_build(cls, items):
    obj = object.__new__(cls)
    obj._items = dict(items)
    return obj

  def __getitem__(self, k):
    return self._items[k]

  def __setitem__(self, k, v):
    self._items[k] = v

  def __contains__(self, k):
    return k in self._items

  def __len__(self):
    return len(self._items)

  def __iter__(self):
    return iter(self._items)

  def get(self, k, default=None):
    return self._items.get(k, default)

  def keys(self):
    return self._items.keys()

  def values(self):
    return self._items.values()

  def items(self):
    return self._items.items()


# ---------------------------------------------------------------------------
# State: a nested dict of Variables, keyed by attribute name or index.
# ---------------------------------------------------------------------------


class State(dict):
  """Nested mapping path -> Variable; a pytree with its keys as aux data."""

  def flat_state(self):
    """[(path, Variable)] in traversal order."""
    return list(_flat_items(self, ()))

  @classmethod
  def from_flat(cls, flat) -> 'State':
    root = cls()
    for path, v in flat:
      node = root
      for k in path[:-1]:
        node = node.setdefault(k, cls())
      node[path[-1]] = v
    return root


def _flat_items(tree, prefix):
  for k, v in tree.items():
    if isinstance(v, dict):
      yield from _flat_items(v, prefix + (k,))
    else:
      yield prefix + (k,), v


jax.tree_util.register_pytree_with_keys(
    State,
    lambda s: ([(jax.tree_util.DictKey(k), v) for k, v in s.items()],
               tuple(s.keys())),
    lambda keys, children: State(zip(keys, children)),
    flatten_func=lambda s: (list(s.values()), tuple(s.keys())))


# ---------------------------------------------------------------------------
# Graph flattening.
# ---------------------------------------------------------------------------


class _Static:
  """A static attribute inside a GraphDef: equal when identical or, for
  hashable values of one type, equal by value (jit cache keys)."""

  __slots__ = ('v',)

  def __init__(self, v):
    self.v = v

  def _key(self):
    try:
      hash(self.v)
    except TypeError:
      return None
    return self.v

  def __eq__(self, other):
    if not isinstance(other, _Static):
      return False
    if self.v is other.v:
      return True
    a, b = self._key(), other._key()
    return (a is not None and b is not None and type(a) is type(b)
            and bool(a == b))

  def __hash__(self):
    k = self._key()
    return hash((type(self.v), k)) if k is not None else id(self.v)


def _is_node(x) -> bool:
  return isinstance(x, (Module, Variable))


def _has_graph(x) -> bool:
  if _is_node(x):
    return True
  if isinstance(x, (jax.Array, np.ndarray, str, int, float, type(None))):
    return False
  return any(_is_node(l) for l in jax.tree.leaves(x, is_leaf=_is_node))


def _pytree_children(x):
  """One level of a pytree: [(key, child)], treedef."""
  kv, treedef = jax.tree_util.tree_flatten_with_path(
      x, is_leaf=lambda y: y is not x)
  keys = []
  for path, _ in kv:
    (entry,) = path
    for attr in ('key', 'idx', 'name'):
      if hasattr(entry, attr):
        keys.append(getattr(entry, attr))
        break
  return list(zip(keys, (c for _, c in kv))), treedef


def _flatten(node, path, seen, flat):
  """GraphDef of `node`; appends (path, Variable) pairs to `flat`."""
  if _is_node(node):
    if id(node) in seen:
      return ('ref', seen[id(node)])
    index = seen[id(node)] = len(seen)
    if isinstance(node, Variable):
      flat.append((path, node))
      return ('var', type(node), index)
    statics, children = [], []
    for k, v in node._graph_items():
      if _has_graph(v):
        children.append((k, _flatten(v, path + (k,), seen, flat)))
      elif isinstance(v, jax.Array):
        raise TypeError(
            f'{type(node).__name__}.{k} holds a bare jax.Array; wrap it in '
            'a Variable (Param or StaticData)')
      else:
        statics.append((k, _Static(v)))
    return ('module', type(node), tuple(statics), tuple(children), index)
  items, treedef = _pytree_children(node)
  children, statics = [], []
  for k, v in items:
    if _has_graph(v):
      children.append((k, _flatten(v, path + (k,), seen, flat)))
    else:
      statics.append((k, _Static(v)))
  return ('pytree', treedef, tuple(k for k, _ in items), tuple(statics),
          tuple(children))


def _build(gdef, path, values, built):
  kind = gdef[0]
  if kind == 'ref':
    return built[gdef[1]]
  if kind == 'var':
    v = values.get(path)
    if v is None:
      raise ValueError(f'state has no variable at {path}')
    built[gdef[2]] = v = v.replace(v.value) if _is_var(v) else (
        _var_unflatten(gdef[1], (), (v,)))
    return v
  if kind == 'module':
    _, cls, statics, children, index = gdef
    obj = object.__new__(cls)  # placeholder for references to itself
    built[index] = obj
    items = {k: s.v for k, s in statics}
    for k, c in children:
      items[k] = _build(c, path + (k,), values, built)
    real = cls._graph_build(items)
    obj.__dict__.update(real.__dict__)
    return obj
  _, treedef, keys, statics, children = gdef
  items = {k: s.v for k, s in statics}
  for k, c in children:
    items[k] = _build(c, path + (k,), values, built)
  return jax.tree_util.tree_unflatten(treedef, [items[k] for k in keys])


class GraphDef:
  """Hashable structure of an object graph (everything but the State)."""

  __slots__ = ('tree',)

  def __init__(self, tree):
    self.tree = tree

  def __eq__(self, other):
    return isinstance(other, GraphDef) and self.tree == other.tree

  def __hash__(self):
    return hash(self.tree)


def _matches(filt, path, var) -> bool:
  if filt is Ellipsis:
    return True
  if isinstance(filt, type):
    return isinstance(var, filt)
  if isinstance(filt, tuple):
    return any(_matches(f, path, var) for f in filt)
  if callable(filt):
    return filt(path, var)
  raise TypeError(f'unsupported filter {filt!r}')


def _partition(flat, filters):
  parts = [[] for _ in filters]
  for path, var in flat:
    for i, f in enumerate(filters):
      if _matches(f, path, var):
        parts[i].append((path, var))
        break
    else:
      raise ValueError(f'no filter matches {path} ({type(var).__name__})')
  return [State.from_flat(p) for p in parts]


def _graph_flat(node):
  flat = []
  tree = _flatten(node, (), {}, flat)
  return GraphDef(tree), flat


def split(node, *filters):
  """-> (GraphDef, State, ...): one State per filter (default: all)."""
  gdef, flat = _graph_flat(node)
  return (gdef, *_partition(flat, filters or (Ellipsis,)))


def merge(gdef: GraphDef, *states):
  """A fresh object graph from a GraphDef and the States of `split`."""
  values = {}
  for s in states:
    values.update(_flat_items(s, ()))
  return _build(gdef.tree, (), values, {})


def state(node, *filters):
  """The node's Variables (or a State's), filtered; one State per filter."""
  if isinstance(node, State):
    flat = node.flat_state()
  else:
    _, flat = _graph_flat(node)
  if not filters:
    return State.from_flat(flat)
  # Variables that no filter selects are left out.
  parts = _partition([(p, v) for p, v in flat
                      if any(_matches(f, p, v) for f in filters)], filters)
  return parts[0] if len(parts) == 1 else tuple(parts)


def update(node, *states) -> None:
  """Writes the States' values into the node's Variables, in place."""
  _, flat = _graph_flat(node)
  targets = dict(flat)
  for s in states:
    for path, v in _flat_items(s, ()):
      if path not in targets:
        raise ValueError(f'no variable at {path}')
      targets[path].value = v.value if _is_var(v) else v


def to_pure_dict(s: State) -> dict:
  """Nested plain dicts of raw values (checkpoint and translation trees)."""
  return {k: to_pure_dict(v) if isinstance(v, dict)
          else (v.value if _is_var(v) else v) for k, v in s.items()}


def replace_by_pure_dict(s: State, pure: dict) -> None:
  """Sets the State's Variables from a tree made by `to_pure_dict`."""
  for k, v in s.items():
    if isinstance(v, dict):
      replace_by_pure_dict(v, pure[k])
    elif _is_var(v):
      v.value = pure[k]
    else:
      s[k] = pure[k]


def _values(tree):
  return jax.tree.map(lambda v: v.value, tree, is_leaf=_is_var)


# ---------------------------------------------------------------------------
# Transforms.
# ---------------------------------------------------------------------------


def jit(fun=None, **jit_kwargs):
  """`jax.jit` for functions of modules: module arguments go in as State,
  and the Variables they hold after the call are written back."""
  if fun is None:
    return functools.partial(jit, **jit_kwargs)
  # Argument 0 of the jitted function is the tuple of GraphDefs.
  donate = jit_kwargs.pop('donate_argnums', ())
  donate = (donate,) if isinstance(donate, int) else tuple(donate)
  jit_kwargs.update(static_argnums=0,
                    donate_argnums=tuple(n + 1 for n in donate))

  def inner(gdefs, *args, **kwargs):
    objs = [a if g is None else merge(g, a) for g, a in zip(gdefs, args)]
    out = fun(*objs, **kwargs)
    new = tuple(None if g is None else split(o)[1]
                for g, o in zip(gdefs, objs))
    return out, new

  jitted = jax.jit(inner, **jit_kwargs)

  @functools.wraps(fun)
  def wrapper(*args, **kwargs):
    gdefs, leaves = [], []
    for a in args:
      if _has_graph(a):
        g, s = split(a)
        gdefs.append(g)
        leaves.append(s)
      else:
        gdefs.append(None)
        leaves.append(a)
    out, new = jitted(tuple(gdefs), *leaves, **kwargs)
    for a, s in zip(args, new):
      if s is not None:
        update(a, s)
    return out

  return wrapper


def value_and_grad(f, argnums: int = 0, has_aux: bool = False):
  """Gradients with respect to the Params of the module at `argnums`
  (returned as a State of Params), or of a plain array argument."""

  def wrapper(*args, **kwargs):
    target = args[argnums]
    if not _has_graph(target):
      return jax.value_and_grad(f, argnums, has_aux=has_aux)(*args, **kwargs)
    gdef, params, rest = split(target, Param, ...)

    def pure(p):
      new_args = list(args)
      new_args[argnums] = merge(gdef, p, rest)
      return f(*new_args, **kwargs)

    return jax.value_and_grad(pure, has_aux=has_aux)(params)

  return wrapper


def grad(f, argnums: int = 0, has_aux: bool = False):
  vg = value_and_grad(f, argnums, has_aux)

  def wrapper(*args, **kwargs):
    out, g = vg(*args, **kwargs)
    return (g, out[1]) if has_aux else g

  return wrapper


def stacked_init(make: Callable[['Rngs'], Module], num: int,
                 rngs: 'Rngs') -> Module:
  """`num` independently initialised copies of `make(rngs)`, with every
  Variable stacked on a new leading axis (for `lax.scan` over layers)."""
  gdefs = []

  def one(key):
    g, s = split(make(Rngs(key)))
    gdefs.append(g)
    return s

  stacked = jax.vmap(one)(jax.random.split(rngs.params(), num))
  return merge(gdefs[0], stacked)


# ---------------------------------------------------------------------------
# Random streams and layers.
# ---------------------------------------------------------------------------


class Rngs:
  """Counter-based key stream: each call folds a fresh count into the seed.

  `rngs()`, `rngs.params()` and any other stream name draw from the one
  stream; initialisation is the only consumer.
  """

  def __init__(self, seed=0):
    if isinstance(seed, int):
      seed = jax.random.key(seed)
    elif not jnp.issubdtype(jnp.asarray(seed).dtype, jax.dtypes.prng_key):
      seed = jax.random.wrap_key_data(seed)
    self._key = seed
    self._count = 0

  def __call__(self):
    key = jax.random.fold_in(self._key, self._count)
    self._count += 1
    return key

  def __getattr__(self, name):
    if name.startswith('_'):
      raise AttributeError(name)
    return self


def _promote(*xs):
  dtype = jnp.result_type(*(x for x in xs if x is not None))
  return tuple(None if x is None else jnp.asarray(x, dtype) for x in xs)


class Linear(Module):
  """y = x @ kernel + bias, in the common dtype of x and the parameters."""

  def __init__(self, in_features: int, out_features: int, *,
               use_bias: bool = True,
               kernel_init=jax.nn.initializers.lecun_normal(),
               bias_init=jax.nn.initializers.zeros,
               param_dtype=jnp.float32, rngs: Rngs):
    self.kernel = Param(kernel_init(rngs.params(),
                                    (in_features, out_features),
                                    param_dtype))
    self.bias = (Param(bias_init(rngs.params(), (out_features,), param_dtype))
                 if use_bias else None)

  def __call__(self, x):
    bias = None if self.bias is None else self.bias.value
    x, kernel, bias = _promote(x, self.kernel.value, bias)
    y = jax.lax.dot_general(x, kernel, (((x.ndim - 1,), (0,)), ((), ())))
    return y if bias is None else y + bias


class LayerNorm(Module):
  """Layer normalisation over the last axis; statistics in float32."""

  def __init__(self, num_features: int, *, epsilon: float = 1e-6,
               use_scale: bool = True, use_bias: bool = True,
               param_dtype=jnp.float32, rngs: Rngs):
    del rngs
    self.epsilon = epsilon
    self.scale = (Param(jnp.ones((num_features,), param_dtype))
                  if use_scale else None)
    self.bias = (Param(jnp.zeros((num_features,), param_dtype))
                 if use_bias else None)

  def __call__(self, x):
    scale = None if self.scale is None else self.scale.value
    bias = None if self.bias is None else self.bias.value
    x, scale, bias = _promote(x, scale, bias)
    x32 = x.astype(jnp.promote_types(x.dtype, jnp.float32))
    mean = x32.mean(-1, keepdims=True)
    var = jnp.maximum(0.0, (x32 * x32).mean(-1, keepdims=True) - mean ** 2)
    mul = jax.lax.rsqrt(var + self.epsilon)
    if scale is not None:
      mul = mul * scale
    y = (x - mean) * mul
    if bias is not None:
      y = y + bias
    return y.astype(x.dtype)


# ---------------------------------------------------------------------------
# Optimizer.
# ---------------------------------------------------------------------------


class Optimizer(Module):
  """An optax transformation and its state, for the `wrt` Variables of
  a model: `optimizer.update(model, grads)` steps the model in place."""

  def __init__(self, model: Module, tx: optax.GradientTransformation,
               wrt=Param):
    self.tx = tx
    self.wrt = wrt
    self.step = OptState(jnp.zeros((), jnp.uint32))
    self.opt_state = jax.tree.map(
        OptState, tx.init(_values(state(model, wrt))))

  def update(self, model: Module, grads: State, **kwargs) -> None:
    params = state(model, self.wrt)
    updates, new_opt_state = self.tx.update(
        _values(grads), _values(self.opt_state), _values(params), **kwargs)
    new_params = optax.apply_updates(_values(params), updates)
    update(model, new_params)
    self.opt_state = jax.tree.map(OptState, new_opt_state)
    self.step.value = self.step.value + 1
