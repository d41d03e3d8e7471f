"""Device mesh construction and model/data sharding.

The framework uses one logical mesh with three axes:

* 'ensemble' — independent diffusion samples (GenCast's signature axis;
  replaces the reference's jax.pmap ensemble path, common/rollout.py:78-202)
* 'data'     — batch data parallelism
* 'model'    — tensor parallelism over MLP hidden / attention head dims,
  activating the P(None, 'model') annotations carried by every kernel.

Gradient reduction across 'data'/'ensemble' is implicit: jit over the mesh
inserts the collectives from the sharding specs, and XLA hands them to
NCCL over NVLink. The cards of a host reach each other all to all at one
rate, so the mesh is a plain reshape of the device list.
"""

from __future__ import annotations


from gencast_tpu.nn import nnx
import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

AXES = ('ensemble', 'data', 'model')


def make_mesh(ensemble: int = 1, data: int = 1, model: int = 1,
              devices=None) -> Mesh:
  """Mesh over (ensemble, data, model); total must equal device count."""
  if devices is None:
    devices = jax.devices()
  n = ensemble * data * model
  if n != len(devices):
    raise ValueError(f'mesh {ensemble}x{data}x{model}={n} != '
                     f'{len(devices)} devices')
  dev_array = np.asarray(devices).reshape(ensemble, data, model)
  return Mesh(dev_array, AXES)


def shard_model(model: nnx.Module, mesh: Mesh) -> None:
  """Places model state on the mesh according to its partitioning metadata.

  Parameters annotated P(None, 'model') shard over the model axis; all
  other state (and parameters without annotations) replicates.
  """
  state = nnx.state(model)

  def sanitize(x, spec) -> P:
    """Drop axis assignments whose size doesn't divide the dim (e.g. a
    3-channel decoder bias annotated P('model')) — replicate instead."""
    if not isinstance(spec, P):
      return P()
    dims = []
    for i, axis in enumerate(spec):
      if axis is None or i >= x.ndim:
        dims.append(None)
        continue
      names = axis if isinstance(axis, tuple) else (axis,)
      size = int(np.prod([mesh.shape[n] for n in names]))
      dims.append(axis if x.shape[i] % size == 0 else None)
    return P(*dims)

  def place(var):
    x = var.value
    if not isinstance(x, (jax.Array, np.ndarray)):
      return var
    return var.replace(
        jax.device_put(x, NamedSharding(mesh, sanitize(x, var.sharding))))

  sharded = jax.tree.map(place, state, is_leaf=lambda v: isinstance(
      v, nnx.Variable))
  nnx.update(model, sharded)


def batch_sharding(mesh: Mesh) -> NamedSharding:
  """[B, lat, lon, C] data tensors: batch over the 'data' axis."""
  return NamedSharding(mesh, P('data'))


def ensemble_batch_sharding(mesh: Mesh) -> NamedSharding:
  """[members, B, lat, lon, C]: members over 'ensemble', batch over 'data'."""
  return NamedSharding(mesh, P('ensemble', 'data'))


def replicated(mesh: Mesh) -> NamedSharding:
  return NamedSharding(mesh, P())


def local_batch_plan(mesh: Mesh, batch_size: int):
  """Per-process plan for assembling a P('data')-sharded batch from rows
  packed locally (multi-host input sharding: each host materializes only
  the batch rows its devices own instead of packing the global batch).

  Returns (rows, blocks): rows — ascending global batch-row positions
  this process must pack; blocks — (device, local_slice) per addressable
  device, where local_slice indexes the LOCAL row array (devices that
  replicate a data shard over other mesh axes map to the same rows).
  """
  sh = NamedSharding(mesh, P('data'))
  smap = sh.devices_indices_map((batch_size,))
  pid = jax.process_index()
  local = [(d, s[0]) for d, s in smap.items() if d.process_index == pid]
  spans = sorted({(s.start or 0,
                   batch_size if s.stop is None else s.stop)
                  for _, s in local})
  rows = (np.concatenate([np.arange(a, b) for a, b in spans])
          if spans else np.zeros((0,), np.int64))
  offs = {}
  lo = 0
  for a, b in spans:
    offs[a] = lo
    lo += b - a
  blocks = [(d, slice(offs[s.start or 0],
                      offs[s.start or 0]
                      + (batch_size if s.stop is None else s.stop)
                      - (s.start or 0)))
            for d, s in local]
  return rows, blocks


def assemble_local_batch(mesh: Mesh, batch_size: int, blocks, batch):
  """Builds global P('data')-sharded arrays from this process's locally
  packed rows (see local_batch_plan). Each device's shard is device_put
  from the matching local block; the global array is assembled without
  any cross-process data movement."""
  sh = batch_sharding(mesh)
  out = {}
  for k, v in batch.items():
    v = np.asarray(v)
    gshape = (batch_size,) + v.shape[1:]
    bufs = [jax.device_put(v[sl], d) for d, sl in blocks]
    out[k] = jax.make_array_from_single_device_arrays(gshape, sh, bufs)
  return out
