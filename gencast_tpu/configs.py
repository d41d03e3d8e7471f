"""Standard model configurations and factories.

Mirrors the reference's model zoo (README.md:155-182, training/
train_helpers.py:94-158): the CPU-runnable nano model, the 1-degree
split-5 model, and the paper-scale 0.25-degree split-6 model.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

import jax
import numpy as np

from gencast_tpu.data import registry
from gencast_tpu.graph import compiler
from gencast_tpu.models.denoiser import DenoiserConfig
from gencast_tpu.models.gencast import GenCast, NoiseConfig, SamplerConfig
from gencast_tpu.nn import nnx
from gencast_tpu.nn.transformer import TransformerConfig
from gencast_tpu.ops import sparse_attention

DEFAULT_CACHE_DIR = os.path.join(
    os.environ.get('GENCAST_TPU_CACHE', os.path.expanduser('~/.cache')),
    'gencast_tpu')


@dataclasses.dataclass(frozen=True)
class ModelSpec:
  """One named model configuration."""
  name: str
  task: registry.TaskSpec
  resolution_deg: float
  mesh_splits: int
  d_model: int
  num_layers: int
  num_heads: int
  attention_k_hop: int
  # 'auto' (see attention_type_for), or one of TransformerConfig's
  # backends: 'triblock', 'dense', 'pallas'.
  attention_type: str = 'auto'
  ffw_hidden: int = 2048  # SparseTransformerConfig default (denoiser.py:97)
  hidden_layers: int = 1
  radius_query_fraction_edge_length: float = 0.6
  stochastic_churn_rate: float = 0.0
  num_noise_levels: int = 20
  # Storage dtype of the spherical-harmonic noise basis ('float32' or
  # 'bfloat16'); synthesis accumulates in f32 either way. bfloat16 halves
  # the basis, the largest static buffer at 0.25 degrees.
  noise_basis_dtype: str = 'float32'
  edge_chunk_size: Optional[int] = None
  # Remat transformer blocks in the backward pass: the backward recomputes
  # each block instead of keeping its activations.
  use_gradient_checkpointing: bool = True
  # 'full' or 'save_attention' (see nn.transformer.TransformerConfig):
  # 'save_attention' keeps the pallas kernel's custom-VJP residuals and
  # recomputes only LN/FiLM/FFW in the backward.
  remat_policy: str = 'full'
  # lax.scan unroll factor for the transformer layer stack (see
  # TransformerConfig.scan_unroll); >1 trades compile time for cross-layer
  # fusion.
  scan_unroll: int = 1
  # Tile edge of the block-sparse attention plan ('pallas' backend only).
  attention_tile_size: int = sparse_attention.TILE
  # Whole-GNN remat for the encoder/decoder (DenoiserConfig.remat_gnns):
  # the backward recomputes the GNN MLPs instead of keeping their
  # per-edge residuals.
  remat_gnns: bool = False
  # Run the model under models.casting.Bfloat16Cast (bf16 compute, f32
  # master weights).
  cast_bf16: bool = False
  # Train with the donated-state functional step (training/steps.py:
  # functional_train_step) so updated params/optimizer state alias their
  # inputs instead of holding a second full copy across the step. A spec
  # flag (not a preset-name compare) so renamed/user-built specs keep the
  # path.
  use_donated_step: bool = False


# CPU-friendly smoke config (tests, CI, bench plumbing); not a reference
# preset.
TINY = ModelSpec(
    name='tiny', task=registry.GENCAST_TASK, resolution_deg=10.0,
    mesh_splits=2, d_model=64, num_layers=2, num_heads=2,
    attention_k_hop=4, ffw_hidden=128)

# The reference demo model (training/train.py defaults: mesh 4, d_model 256,
# 16 layers, 4 heads, k_hop 8, 2.5-degree data). bf16 compute with f32
# master weights, like the larger presets; cast_bf16=False restores f32.
NANO = ModelSpec(
    name='nano', task=registry.GENCAST_TASK, resolution_deg=2.5,
    mesh_splits=4, d_model=256, num_layers=16, num_heads=4,
    attention_k_hop=8, cast_bf16=True)

# GenCast 1deg (README.md:168-175: splits=5, 1-degree, full variable set).
# bf16 compute with f32 master weights is the default: it is the dtype
# GenCast was actually trained in by DeepMind (the reference fork ships
# the same Bfloat16Cast wrapper but never wires it into training).
# cast_bf16=False restores the f32 step.
ONE_DEG = ModelSpec(
    name='1deg', task=registry.GENCAST_TASK_FULL, resolution_deg=1.0,
    mesh_splits=5, d_model=512, num_layers=16, num_heads=4,
    attention_k_hop=16, stochastic_churn_rate=2.5,
    remat_policy='save_attention', cast_bf16=True)

# Paper-scale 0.25-degree splits=6 (README.md:157-166). The memory plan:
# streamed encoder/decoder edges, whole-GNN remat, a bf16 noise basis,
# bf16 compute and the donated-state train step; 'save_attention' keeps
# the attention kernel's residuals so the backward does not re-run its
# forward.
QUARTER_DEG = ModelSpec(
    name='0.25deg', task=registry.GENCAST_TASK_FULL, resolution_deg=0.25,
    mesh_splits=6, d_model=512, num_layers=16, num_heads=4,
    attention_k_hop=16,
    stochastic_churn_rate=2.5,
    edge_chunk_size=128 * 1024,
    noise_basis_dtype='bfloat16',
    remat_policy='save_attention',
    remat_gnns=True,
    cast_bf16=True,
    use_donated_step=True)

SPECS = {s.name: s for s in (TINY, NANO, ONE_DEG, QUARTER_DEG)}

def attention_type_for(spec: ModelSpec, platform: Optional[str] = None
                       ) -> str:
  """The attention backend a spec runs with.

  An explicit `spec.attention_type` is kept. 'auto' takes the Triton
  block-sparse kernel on the GPU, where it beat XLA's tri-block attention
  at every preset measured (PERF.md, "Kernel decisions at bring-up"), and
  XLA's tri-block attention on every other platform, where the kernel
  does not compile.
  """
  if spec.attention_type != 'auto':
    return spec.attention_type
  platform = platform or jax.default_backend()
  return 'pallas' if platform == 'gpu' else 'triblock'


def grid_for_resolution(deg: float) -> Tuple[np.ndarray, np.ndarray]:
  """Equiangular grid with poles: lat ascending [-90, 90], lon [0, 360)."""
  lat = np.arange(-90.0, 90.0 + deg / 2, deg, dtype=np.float32)
  lon = np.arange(0.0, 360.0, deg, dtype=np.float32)
  return lat, lon


def build_statics(spec: ModelSpec,
                  cache_dir: Optional[str] = DEFAULT_CACHE_DIR
                  ) -> compiler.GraphStatics:
  lat, lon = grid_for_resolution(spec.resolution_deg)
  pallas = attention_type_for(spec) == 'pallas'
  return compiler.build_graph_statics(
      spec.mesh_splits, lat, lon,
      radius_query_fraction_edge_length=(
          spec.radius_query_fraction_edge_length),
      attention_k_hop=spec.attention_k_hop,
      attention_tile_size=spec.attention_tile_size if pallas else 0,
      build_triblock_mask=not pallas,
      cache_dir=cache_dir)


def build_graphcast(spec: ModelSpec, *, rngs: Optional[nnx.Rngs] = None,
                    statics: Optional[compiler.GraphStatics] = None,
                    cache_dir: Optional[str] = DEFAULT_CACHE_DIR,
                    **config_overrides):
  """Builds a GraphCast deterministic model from a ModelSpec.

  The registry's GenCast tasks are converted to the GraphCast variable set
  (adds precipitation + TISR forcing) keeping their pressure levels — the
  presets all carry GenCast tasks, and "train GraphCast at preset X" means
  the GraphCast variable conversion, not GenCast's variables through a GNN.
  Any other task (graphcast_13 / graphcast_37 / graphcast_13_precip_out or
  user-built) is used exactly as given. num_layers is interpreted as
  gnn_msg_steps (reference default 16). Extra keyword arguments override
  GraphCastConfig fields (e.g. remat_group=4 for the 37-level 0.25-degree
  configuration). An explicit remat_group > 1 implies remat=True —
  grouped processor remat is meaningless with remat off, and silently
  dropping it would defeat its memory-fitting purpose.
  """
  from gencast_tpu.models.graphcast import GraphCast, GraphCastConfig
  if (config_overrides.get('remat_group', 1) > 1
      and 'remat' not in config_overrides and not spec.remat_gnns):
    config_overrides = dict(config_overrides, remat=True)
  gencast_families = {
      dataclasses.replace(t, pressure_levels=())
      for t in (registry.GENCAST_TASK, registry.GENCAST_TASK_FULL)}
  if dataclasses.replace(spec.task, pressure_levels=()) in gencast_families:
    task = dataclasses.replace(registry.GRAPHCAST_TASK_13,
                               pressure_levels=spec.task.pressure_levels)
  else:
    task = spec.task
  spec = dataclasses.replace(spec, task=task)
  if statics is None:
    lat, lon = grid_for_resolution(spec.resolution_deg)
    statics = compiler.build_graph_statics(
        spec.mesh_splits, lat, lon,
        radius_query_fraction_edge_length=(
            spec.radius_query_fraction_edge_length),
        build_attention_mask=False,
        build_multimesh=True,
        cache_dir=cache_dir)
  model = GraphCast(
      task, statics,
      dataclasses.replace(
          GraphCastConfig(latent_size=spec.d_model,
                          gnn_msg_steps=spec.num_layers,
                          hidden_layers=spec.hidden_layers,
                          edge_chunk_size=spec.edge_chunk_size,
                          remat=spec.remat_gnns),
          **config_overrides),
      rngs=rngs if rngs is not None else nnx.Rngs(0))
  return model, statics


def build_gencast(spec: ModelSpec, *, rngs: Optional[nnx.Rngs] = None,
                  statics: Optional[compiler.GraphStatics] = None,
                  cache_dir: Optional[str] = DEFAULT_CACHE_DIR
                  ) -> Tuple[GenCast, compiler.GraphStatics]:
  """Builds a GenCast model (unwrapped; see models.wrappers for the
  normalization/NaN stack) plus its graph statics."""
  if statics is None:
    statics = build_statics(spec, cache_dir)
  dense_mask = None
  if attention_type_for(spec) == 'dense':
    from gencast_tpu.graph.compiler import khop_mask_csr
    dense_mask = khop_mask_csr(
        statics.mesh_edges.senders, statics.mesh_edges.receivers,
        statics.num_mesh_nodes, spec.attention_k_hop).toarray()
  transformer = TransformerConfig(
      d_model=spec.d_model, num_layers=spec.num_layers,
      num_heads=spec.num_heads, attention_type=attention_type_for(spec),
      ffw_hidden=spec.ffw_hidden,
      use_gradient_checkpointing=spec.use_gradient_checkpointing,
      remat_policy=spec.remat_policy,
      scan_unroll=spec.scan_unroll)
  model = GenCast(
      spec.task, statics, transformer,
      denoiser_config=DenoiserConfig(latent_size=spec.d_model,
                                     hidden_layers=spec.hidden_layers,
                                     edge_chunk_size=spec.edge_chunk_size,
                                     remat_gnns=spec.remat_gnns),
      sampler_config=SamplerConfig(
          stochastic_churn_rate=spec.stochastic_churn_rate,
          num_noise_levels=spec.num_noise_levels),
      noise_config=NoiseConfig(),
      rngs=rngs if rngs is not None else nnx.Rngs(0),
      dense_attention_mask=dense_mask,
      noise_basis_dtype=np.dtype(spec.noise_basis_dtype))
  return model, statics
