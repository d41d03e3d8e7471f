"""Translate a reference (fgiral000/gencast-flax-nnx) checkpoint into a
gencast_tpu checkpoint.

Reads either:
  * an orbax PyTreeCheckpointer directory saved by the reference's
    training/train_helpers.py save_checkpoint (nested nnx state of its
    GenCast module, possibly wrapped in NaNCleaner/InputsAndResiduals), or
  * a typed npz tree (common/checkpoint.py format),

translates the parameter structure (gencast_tpu.training.translate — the
mapping is numerically validated by tests/reference_parity_impl.py), and
saves into a gencast_tpu orbax checkpoint usable by --ckpt_dir.

Usage:
  python tools/translate_checkpoint.py --ref /path/to/ref_ckpt \
      --preset nano --out /path/to/new_ckpt
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _find_denoiser_subtree(tree):
  """Locates the reference GenCast denoiser state inside possible wrapper
  nesting (NaNCleaner/InputsAndResiduals store the model under
  'predictor'; evaluation-time trees may be wrapped once more)."""
  node = tree
  for _ in range(6):
    if 'denoiser' in node:
      return node['denoiser']
    if 'predictor' in node:
      node = node['predictor']
      continue
    if 'model' in node:
      node = node['model']
      continue
    break
  raise KeyError(f'could not locate denoiser in tree: {list(tree.keys())}')


def main():
  p = argparse.ArgumentParser()
  p.add_argument('--ref', required=True,
                 help='reference checkpoint: orbax dir or .npz file')
  p.add_argument('--preset', default='nano')
  p.add_argument('--out', required=True)
  args = p.parse_args()

  from gencast_tpu.nn import nnx
  import orbax.checkpoint as ocp

  from gencast_tpu import configs
  from gencast_tpu.training import checkpoint as ckpt_lib
  from gencast_tpu.training import npz_checkpoint, translate
  from gencast_tpu.training.train import build_spec

  from gencast_tpu.training import deepmind_checkpoint as dm_ckpt

  if args.ref.endswith('.npz') and dm_ckpt.is_checkpoint_npz(args.ref):
    # Published-DeepMind CheckPoint container (flattened dataclass npz,
    # Haiku-era naming normalized inside denoiser_state).
    tree = dm_ckpt.load(args.ref)
    denoiser_tree = dm_ckpt.find_denoiser(
        dm_ckpt.normalize_params(tree['params']))
  else:
    if args.ref.endswith('.npz'):
      ref_tree = npz_checkpoint.load(args.ref)
      if 'params' in ref_tree:
        ref_tree = ref_tree['params']
    else:
      ref_tree = ocp.PyTreeCheckpointer().restore(os.path.abspath(args.ref))
    denoiser_tree = _find_denoiser_subtree(ref_tree)

  class _A:
    preset = args.preset
    mesh_size = d_model = num_layers = num_heads = None
    attention_k_hop = attention_type = None
  spec = build_spec(_A)
  model, _ = configs.build_gencast(spec, rngs=nnx.Rngs(0))

  translated = {'denoiser': translate.gencast_denoiser(denoiser_tree)}
  state = nnx.state(model, nnx.Param)
  target = nnx.to_pure_dict(state)
  translate.merge_into(target, translated)
  nnx.replace_by_pure_dict(state, target)
  nnx.update(model, state)

  manager = ckpt_lib.create_manager(args.out)
  ckpt_lib.save(manager, 0, model)
  manager.wait_until_finished()
  print(f'translated checkpoint written to {args.out}')


if __name__ == '__main__':
  main()
