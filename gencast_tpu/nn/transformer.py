"""Banded sparse transformer over RCM-permuted mesh nodes.

The mesh-node sequence is banded after the graph compiler's RCM permutation,
so k-hop attention is tri-block-diagonal at coarse granularity and
block-sparse at fine granularity. Backends (same weights, same math):

* 'triblock' — pure-XLA einsum implementation with a joint 3-block softmax;
  the numerics reference and the path off the GPU (reference
  gencast/sparse_transformer.py:100-125, 294-354).
* 'dense'    — full masked attention for small meshes.
* 'pallas'   — block-sparse flash kernel over a TilePlan
  (gencast_tpu.ops.sparse_attention), compiled for the GPU through
  Triton.

The layer stack runs as a `lax.scan` over stacked per-layer parameters
(one transformer block in the compiled program instead of num_layers
inlined copies), which cuts XLA compile time of the fused sampler by an
order of magnitude; masks/plans are owned once by the transformer and
passed to blocks as broadcast operands.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from gencast_tpu.nn import nnx
import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P

from gencast_tpu.graph.compiler import BandedMask
from gencast_tpu.nn import precision
from gencast_tpu.nn.mlp import FiLM
from gencast_tpu.nn.variables import StaticData


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
  """Matches the reference's transformer hyperparameters
  (gencast/sparse_transformer.py:32-81, SparseTransformerConfig defaults
  gencast/denoiser.py:71-97)."""
  d_model: int
  num_layers: int = 16
  num_heads: int = 4
  ffw_hidden: int = 2048
  attention_type: str = 'triblock'  # 'triblock' | 'dense' | 'pallas'
  activation: str = 'gelu'
  ffw_winit_mult: float = 2.0
  ffw_winit_final_mult: float = 0.0
  attn_winit_mult: float = 2.0
  attn_winit_final_mult: float = 0.0
  use_gradient_checkpointing: bool = False
  scan_layers: bool = True
  # lax.scan unroll factor for the layer stack: >1 inlines that many
  # blocks per loop iteration, letting XLA fuse across layer boundaries
  # (residual add into the next LN) at the cost of a proportionally
  # larger program / compile time. Must divide num_layers.
  scan_unroll: int = 1
  # Remat scope when use_gradient_checkpointing is on:
  #   'full'           — recompute the whole block in the backward (lowest
  #                      memory; the attention forward runs twice).
  #   'save_attention' — keep the attention sublayer OUT of the remat
  #                      region so its residuals (for the pallas kernel:
  #                      q/k/v/out/lse via its custom VJP) are saved and
  #                      only LN/FiLM/FFW are recomputed: the backward no
  #                      longer re-runs the attention forward, for
  #                      O(N * d) saved bytes per layer.
  #                      Intended for attention_type='pallas'; with
  #                      'triblock' it saves the O(block^2) softmax
  #                      intermediates instead, which defeats the remat.
  remat_policy: str = 'full'
  # Run the 'pallas' kernel through the Pallas interpreter; only CPU
  # tests set it (off the GPU the kernel otherwise refuses to run).
  interpret: bool = False

  def __post_init__(self):
    if self.remat_policy not in ('full', 'save_attention'):
      raise ValueError(
          f'remat_policy must be "full" or "save_attention", '
          f'got {self.remat_policy!r}')

  @property
  def head_dim(self) -> int:
    if self.d_model % self.num_heads:
      raise ValueError('num_heads must divide d_model')
    return self.d_model // self.num_heads


def _scaled_init(scale: float, num_layers: int):
  return nnx.with_partitioning(
      nnx.initializers.variance_scaling(scale / num_layers, 'fan_in',
                                        'truncated_normal'),
      P(None, 'model'))


def _zeros_bias():
  return nnx.with_partitioning(nnx.initializers.zeros_init(), P('model'))


class _QKVProjections(nnx.Module):
  """Shared q/k/v/out projections for all attention backends."""

  def __init__(self, cfg: TransformerConfig, *, rngs: nnx.Rngs):
    self.cfg = cfg
    d, h, hd = cfg.d_model, cfg.num_heads, cfg.head_dim
    proj_init = _scaled_init(cfg.attn_winit_mult, cfg.num_layers)
    self.q = nnx.Linear(d, h * hd, kernel_init=proj_init, use_bias=False,
                        rngs=rngs)
    self.k = nnx.Linear(d, h * hd, kernel_init=proj_init, use_bias=False,
                        rngs=rngs)
    self.v = nnx.Linear(d, h * hd, kernel_init=proj_init, use_bias=False,
                        rngs=rngs)
    self.out = nnx.Linear(
        h * hd, d,
        kernel_init=_scaled_init(cfg.attn_winit_final_mult, cfg.num_layers),
        bias_init=_zeros_bias(), rngs=rngs)

  def split_heads(self, x: jnp.ndarray) -> Tuple[jnp.ndarray, ...]:
    h, hd = self.cfg.num_heads, self.cfg.head_dim
    def s(y):
      return y.reshape(y.shape[:-1] + (h, hd))
    return s(self.q(x)), s(self.k(x)), s(self.v(x))


def _joint_softmax3(logits):
  """Softmax over the union of diag/upper/lower key blocks, sharing one max
  (reference gencast/sparse_transformer.py:100-125)."""
  d, u, l = logits
  m = jnp.max(jnp.stack([
      jax.lax.stop_gradient(d.max(-1, keepdims=True)),
      jax.lax.stop_gradient(u.max(-1, keepdims=True)),
      jax.lax.stop_gradient(l.max(-1, keepdims=True))]), axis=0)
  ed, eu, el = jnp.exp(d - m), jnp.exp(u - m), jnp.exp(l - m)
  denom = (ed.sum(-1, keepdims=True) + eu.sum(-1, keepdims=True)
           + el.sum(-1, keepdims=True))
  return ed / denom, eu / denom, el / denom


def triblock_attention(q, k, v, mask, block_size: int):
  """Tri-block-diagonal attention on [B, Np, H, hd] operands.

  Np is a multiple of block_size; mask [3, nb, bs, bs] holds the diag,
  upper (next) and lower (previous) key blocks of each query block."""
  b, np_, h, hd = q.shape
  nb = np_ // block_size
  q, k, v = (t.reshape(b, nb, block_size, h, hd) for t in (q, k, v))
  zero = lambda t: jnp.zeros_like(t[:, :1])
  k = jnp.concatenate([zero(k), k, zero(k)], axis=1)
  v = jnp.concatenate([zero(v), v, zero(v)], axis=1)

  scale = hd ** -0.5
  def qk(queries, keys):
    return jnp.einsum('bnqhd,bnkhd->bnhqk', queries, keys) * scale

  neg = jnp.asarray(-1e30, dtype=q.dtype)
  # Key blocks aligned with each query block: diag, upper (next), lower
  # (previous); k/v were padded with one zero block on each side.
  logits = tuple(
      jnp.where(mask[i][None, :, None], qk(q, kk), neg)
      for i, kk in ((0, k[:, 1:-1]), (1, k[:, 2:]), (2, k[:, :-2])))
  wd, wu, wl = precision.with_f32(_joint_softmax3, logits)

  def av(w, values):
    return jnp.einsum('bnhqk,bnkhd->bnqhd', w, values)
  o = (av(wd, v[:, 1:-1]) + av(wu, v[:, 2:]) + av(wl, v[:, :-2]))
  return o.reshape(b, np_, h, hd)


class TriblockAttention(nnx.Module):
  """Tri-block-diagonal attention (XLA einsum path). Mask passed per call.

  Pads the node axis TO `padded_nodes` (a no-op when the caller already
  hoisted the padding out of the layer scan) and slices back to the
  input length."""

  def __init__(self, cfg: TransformerConfig, block_size: int,
               padded_nodes: int, *, rngs: nnx.Rngs):
    self.cfg = cfg
    self.proj = _QKVProjections(cfg, rngs=rngs)
    self.block_size = block_size
    self.padded_nodes = padded_nodes

  def __call__(self, x: jnp.ndarray, attn_args) -> jnp.ndarray:
    # x: [B, N, C] with N the real or pre-padded node count.
    (mask,) = attn_args  # [3, nb, bs, bs] bool
    n = x.shape[1]
    x_p = jnp.pad(x, ((0, 0), (0, self.padded_nodes - n), (0, 0)))
    q, k, v = self.proj.split_heads(x_p)  # [B, Np, H, hd]
    o = triblock_attention(q, k, v, mask, self.block_size)
    o = o.reshape(o.shape[0], o.shape[1], -1)
    return self.proj.out(o[:, :n])


class DenseAttention(nnx.Module):
  """Full masked attention; reference MHA path
  (gencast/sparse_transformer.py:358-399)."""

  def __init__(self, cfg: TransformerConfig, *, rngs: nnx.Rngs):
    self.cfg = cfg
    self.proj = _QKVProjections(cfg, rngs=rngs)

  def __call__(self, x: jnp.ndarray, attn_args) -> jnp.ndarray:
    (mask,) = attn_args  # [N, N] bool
    cfg = self.cfg
    q, k, v = self.proj.split_heads(x)  # [B, N, H, hd]
    logits = jnp.einsum('bthd,bThd->bhtT', q, k) * cfg.head_dim ** -0.5
    logits = jnp.where(mask[None, None], logits,
                       jnp.asarray(-1e30, logits.dtype))
    weights = precision.with_f32(jax.nn.softmax, logits)
    o = jnp.einsum('bhtT,bThd->bthd', weights, v)
    o = o.reshape(o.shape[:2] + (cfg.num_heads * cfg.head_dim,))
    return self.proj.out(o)


class PallasSparseAttention(nnx.Module):
  """Block-sparse flash attention via the Triton-route Pallas kernel
  (ops/sparse_attention.py); tile-plan arrays passed per call."""

  def __init__(self, cfg: TransformerConfig, tile: int,
               interpret: bool = False, *, rngs: nnx.Rngs):
    self.cfg = cfg
    self.proj = _QKVProjections(cfg, rngs=rngs)
    self.tile = tile
    self.interpret = interpret

  def __call__(self, x: jnp.ndarray, attn_args) -> jnp.ndarray:
    from gencast_tpu.ops import sparse_attention
    cfg = self.cfg
    q, k, v = self.proj.split_heads(x)  # [B, N, H, hd]
    o = sparse_attention.sparse_banded_attention(
        q, k, v, attn_args, self.tile, self.interpret)
    o = o.reshape(o.shape[0], o.shape[1], cfg.num_heads * cfg.head_dim)
    return self.proj.out(o)


class FeedForward(nnx.Module):
  def __init__(self, cfg: TransformerConfig, *, rngs: nnx.Rngs):
    self.lin1 = nnx.Linear(
        cfg.d_model, cfg.ffw_hidden,
        kernel_init=_scaled_init(cfg.ffw_winit_mult, cfg.num_layers),
        bias_init=_zeros_bias(), rngs=rngs)
    self.lin2 = nnx.Linear(
        cfg.ffw_hidden, cfg.d_model,
        kernel_init=_scaled_init(cfg.ffw_winit_final_mult, cfg.num_layers),
        bias_init=_zeros_bias(), rngs=rngs)
    self.activation = getattr(jax.nn, cfg.activation)

  def __call__(self, x: jnp.ndarray) -> jnp.ndarray:
    return self.lin2(self.activation(self.lin1(x)))


class TransformerBlock(nnx.Module):
  """Pre-LN block with FiLM noise conditioning on both sublayers."""

  def __init__(self, cfg: TransformerConfig, attn: nnx.Module, *,
               rngs: nnx.Rngs):
    self.attn = attn
    self.ffw = FeedForward(cfg, rngs=rngs)
    self.ln1 = nnx.LayerNorm(cfg.d_model, use_scale=False, use_bias=False,
                             rngs=rngs)
    self.ln2 = nnx.LayerNorm(cfg.d_model, use_scale=False, use_bias=False,
                             rngs=rngs)
    self.film1 = FiLM(cfg.d_model, rngs=rngs)
    self.film2 = FiLM(cfg.d_model, rngs=rngs)

  def attn_half(self, x: jnp.ndarray, cond: jnp.ndarray,
                attn_args) -> jnp.ndarray:
    h = self.film1(self.ln1(x), cond[:, None, :])
    return x + self.attn(h, attn_args)

  def ffw_half(self, x: jnp.ndarray, cond: jnp.ndarray) -> jnp.ndarray:
    h = self.film2(self.ln2(x), cond[:, None, :])
    return x + self.ffw(h)

  def __call__(self, x: jnp.ndarray, cond: jnp.ndarray,
               attn_args) -> jnp.ndarray:
    # x: [B, N, C]; cond: [B, D].
    return self.ffw_half(self.attn_half(x, cond, attn_args), cond)


class MeshTransformer(nnx.Module):
  """Stack of banded-attention blocks over mesh nodes.

  Input/output layout [N, B, C] (nodes leading, matching the GNN stack);
  transposed to batch-first internally. Per-layer parameters are stacked
  with a leading layer axis and applied with lax.scan.
  """

  def __init__(self, cfg: TransformerConfig,
               mask: Optional[BandedMask],
               dense_mask: Optional[np.ndarray] = None,
               tile_plan=None, *,
               rngs: nnx.Rngs):
    self.cfg = cfg

    # Attention operands, owned once (shared across layers).
    # Node-axis padding hoisted out of the per-layer attention calls:
    # x is padded once before the layer scan and sliced once after, so
    # the in-scan pads/slices become no-ops. Padded rows are fully masked
    # as keys and sliced off at the end; as queries the kernel returns 0
    # for them while the einsum backends return a finite masked-softmax
    # artifact. Either way LN/FiLM/FFW keep them finite and their
    # cotangents are exactly 0 (nothing downstream of the final slice
    # reads them).
    self._hoisted_pad = 0
    if cfg.attention_type == 'dense':
      assert dense_mask is not None
      self.attn_operands = nnx.List([StaticData(jnp.asarray(dense_mask))])
      block_kwargs = {}
    elif cfg.attention_type == 'pallas':
      assert tile_plan is not None, (
          "'pallas' attention requires GraphStatics built with a tile plan")
      self.attn_operands = nnx.List(
          [StaticData(a) for a in tile_plan.device_arrays()])
      block_kwargs = {'tile': tile_plan.tile, 'interpret': cfg.interpret}
      self._hoisted_pad = tile_plan.padded_n
    elif cfg.attention_type == 'triblock':
      assert mask is not None
      self.attn_operands = nnx.List([StaticData(jnp.asarray(mask.blocks))])
      block_kwargs = {'block_size': mask.block_size,
                      'padded_nodes': mask.num_blocks * mask.block_size}
      self._hoisted_pad = mask.num_blocks * mask.block_size
    else:
      raise ValueError(f'unknown attention_type {cfg.attention_type}')

    def make_block(block_rngs: nnx.Rngs) -> TransformerBlock:
      if cfg.attention_type == 'triblock':
        attn = TriblockAttention(cfg, rngs=block_rngs, **block_kwargs)
      elif cfg.attention_type == 'pallas':
        attn = PallasSparseAttention(cfg, rngs=block_rngs, **block_kwargs)
      else:
        attn = DenseAttention(cfg, rngs=block_rngs)
      return TransformerBlock(cfg, attn, rngs=block_rngs)

    if cfg.scan_layers:
      self.blocks = nnx.stacked_init(make_block, cfg.num_layers, rngs)
    else:
      self.blocks = nnx.List(
          [make_block(rngs) for _ in range(cfg.num_layers)])

    self.final_ln = nnx.LayerNorm(cfg.d_model, use_scale=False,
                                  use_bias=False, rngs=rngs)
    self.final_film = FiLM(cfg.d_model, rngs=rngs)

  def __call__(self, node_feats: jnp.ndarray,
               cond: jnp.ndarray) -> jnp.ndarray:
    n = node_feats.shape[0]
    x = jnp.transpose(node_feats, (1, 0, 2))  # [B, N, C]
    if self._hoisted_pad > n:
      x = jnp.pad(x, ((0, 0), (0, self._hoisted_pad - n), (0, 0)))
    attn_args = tuple(v[...] for v in self.attn_operands)

    if self.cfg.scan_layers:
      # Plain lax.scan over the stacked per-layer state (nnx.scan refuses
      # modules captured across an enclosing lax.scan trace, e.g. inside
      # the fused diffusion sampler).
      graphdef, stacked_state = nnx.split(self.blocks)

      remat = self.cfg.use_gradient_checkpointing
      save_attn = remat and self.cfg.remat_policy == 'save_attention'

      if save_attn:
        def body(carry, layer_state):
          block = nnx.merge(graphdef, layer_state)
          # Attention outside the remat region: its (custom-VJP) residuals
          # are saved, so the backward reuses them instead of re-running
          # the attention forward. Only LN/FiLM/FFW are recomputed.
          mid = block.attn_half(carry, cond, attn_args)
          out = jax.checkpoint(block.ffw_half)(mid, cond)
          # Keep the carry dtype stable (f32 params promote bf16
          # activations).
          return out.astype(carry.dtype), None
      else:
        def body(carry, layer_state):
          block = nnx.merge(graphdef, layer_state)
          return block(carry, cond, attn_args).astype(carry.dtype), None
        if remat:
          body = jax.checkpoint(body)
      x, _ = jax.lax.scan(body, x, stacked_state,
                          unroll=self.cfg.scan_unroll)
    else:
      for block in self.blocks:
        if (self.cfg.use_gradient_checkpointing
            and self.cfg.remat_policy == 'save_attention'):
          x = jax.checkpoint(block.ffw_half)(
              block.attn_half(x, cond, attn_args), cond)
        else:
          x = block(x, cond, attn_args)

    h = self.final_film(self.final_ln(x), cond[:, None, :])
    return jnp.transpose(h[:, :n], (1, 0, 2))
