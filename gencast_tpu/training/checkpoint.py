"""Checkpoint save/restore with full training-state resume.

Improves on the reference, which saves model params only and always
restarts training from step 0 (SURVEY §5: "no optimizer-state save and no
mid-run resume path"). Here a checkpoint holds model params, optimizer
state, and the step counter, managed by orbax with retention/rotation.

StaticData variables (attention masks, graph indices, per-channel vectors)
are deliberately NOT saved — they are reconstructed by the graph compiler,
keeping checkpoints small and portable across grid changes.
"""

from __future__ import annotations

import os
from typing import Optional

from gencast_tpu.nn import nnx
import orbax.checkpoint as ocp

from gencast_tpu.nn.variables import StaticData


def _trainable_state(model: nnx.Module) -> nnx.State:
  return nnx.state(model, nnx.Param)


def create_manager(directory: str, max_to_keep: int = 3,
                   save_interval_steps: int = 1) -> ocp.CheckpointManager:
  options = ocp.CheckpointManagerOptions(
      max_to_keep=max_to_keep,
      save_interval_steps=save_interval_steps,
      create=True)
  return ocp.CheckpointManager(os.path.abspath(directory), options=options)


def save(manager: ocp.CheckpointManager, step: int, model: nnx.Module,
         optimizer: Optional[nnx.Optimizer] = None) -> None:
  items = {'params': ocp.args.StandardSave(
      nnx.to_pure_dict(_trainable_state(model)))}
  if optimizer is not None:
    items['opt_state'] = ocp.args.StandardSave(
        nnx.to_pure_dict(nnx.state(optimizer)))
  manager.save(step, args=ocp.args.Composite(**items))


def latest_step(manager: ocp.CheckpointManager) -> Optional[int]:
  return manager.latest_step()


def restore(manager: ocp.CheckpointManager, model: nnx.Module,
            optimizer: Optional[nnx.Optimizer] = None,
            step: Optional[int] = None) -> int:
  """Restores params (and optimizer state) in place; returns the step."""
  if step is None:
    step = manager.latest_step()
  if step is None:
    raise FileNotFoundError('no checkpoint found')

  params = _trainable_state(model)
  targets = {'params': ocp.args.StandardRestore(nnx.to_pure_dict(params))}
  if optimizer is not None:
    opt_state = nnx.state(optimizer)
    targets['opt_state'] = ocp.args.StandardRestore(
        nnx.to_pure_dict(opt_state))
  restored = manager.restore(step, args=ocp.args.Composite(**targets))

  nnx.replace_by_pure_dict(params, restored['params'])
  nnx.update(model, params)
  if optimizer is not None:
    nnx.replace_by_pure_dict(opt_state, restored['opt_state'])
    nnx.update(optimizer, opt_state)
  return int(step)
