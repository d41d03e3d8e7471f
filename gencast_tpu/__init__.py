"""gencast_tpu: a weather diffusion-model framework in JAX.

A from-scratch rebuild of the capabilities of fgiral000/gencast-flax-nnx
(GenCast EDM diffusion + GraphCast deterministic forecasting):

* Device-side data model is packed arrays with static channel metadata
  (`gencast_tpu.data.layout.ChannelLayout`) instead of xarray-inside-jit.
* Graph construction is an explicit host-side compiler
  (`gencast_tpu.graph.compiler`) emitting frozen static arrays.
* Mesh attention runs on a banded block-sparse layout (RCM-permuted
  icosahedral mesh): a block-sparse Pallas kernel compiled for the GPU
  through Triton, and a plain-XLA tri-block path.
* Sampling and autoregressive rollout are single `lax.scan` programs with
  donated state; ensembles scale over a `jax.sharding.Mesh` via shard_map.
"""

__version__ = "0.1.0"

import os as _os

import jax as _jax

# Persistent compilation cache: the fused sampler program is large (2
# denoiser calls per scan step x 16 transformer blocks) and cold-compiles
# in minutes. JAX_COMPILATION_CACHE_DIR, when set, is JAX's own setting
# and is left alone; otherwise the cache lives at a fixed path in the
# checkout (the path is part of the cache key).
CACHE_DIR = _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
    ".jax_cache")
if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
  _jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
