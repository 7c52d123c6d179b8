"""Checkpoint save and restore (counterpart of the JAX package's
``utils/checkpoint.py``, which writes an orbax tree).

The port's format is a directory holding ``state.pt``, a ``torch.save`` of
the training state as a dict of JAX ``TrainState``'s fields:

- ``params``: the parameter tree in the JAX package's layout (nested dicts
  and lists, ``weights.to_jax_tree``) of CPU tensors;
- ``opt_state``: ``{"optimizer": ..., "scheduler": ...}``, the Adam and
  schedule ``state_dict``s (each leaf's Adam count is its ``step``);
- ``occ``: the occupancy grid, ``{"occs", "binaries", "aabbs"}``;
- ``step``: the next step to train;
- ``rng``: the system generator's ``get_state()`` in place of JAX's key.

Beside it, ``params.npz`` holds the parameters under the dotted keys of
``weights.flatten_tree``, as ``launch --params`` reads them.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from intrinsicavatar_tpu_torch.weights import flatten_tree

STATE_FILE = "state.pt"
PARAMS_FILE = "params.npz"


def save_checkpoint(path: str, state: dict) -> None:
    """Save a training state (tensors on any device) to the directory
    ``path``, with its parameters also as ``params.npz``."""
    os.makedirs(path, exist_ok=True)
    state = _to_cpu(state)
    torch.save(state, os.path.join(path, STATE_FILE))
    if "params" in state:
        np.savez(os.path.join(path, PARAMS_FILE),
                 **{k: np.asarray(v) for k, v in
                    flatten_tree(state["params"]).items()})


def restore_checkpoint(path: str, target=None):
    """Restore a state saved by :func:`save_checkpoint`, on the CPU.

    With ``target`` given, the result has its structure: every key of
    ``target`` must be in the checkpoint with the same shapes, and each
    tensor comes back on the device and in the dtype of ``target``'s.
    """
    state = torch.load(os.path.join(path, STATE_FILE), map_location="cpu",
                       weights_only=True)
    if target is None:
        return state
    return _like(state, target, "")


def filter_for_test(state_dict: dict) -> dict:
    """Drop the occupancy grids and the pose corrections for a test-time
    restore: test frames build their own deformed-space grids, and pose
    corrections do not apply to novel poses."""
    out = dict(state_dict)
    out.pop("occ", None)
    params = dict(out.get("params", {}))
    params.pop("pose_correction", None)
    out["params"] = params
    return out


def _to_cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree


def _like(tree, target, where):
    if isinstance(target, dict):
        if not isinstance(tree, dict):
            raise ValueError(f"checkpoint{where}: expected a dict")
        missing = set(target) - set(tree)
        if missing:
            raise KeyError(f"checkpoint{where} lacks {sorted(missing)}")
        return {k: _like(tree[k], v, f"{where}.{k}")
                for k, v in target.items()}
    if isinstance(target, (list, tuple)):
        if not isinstance(tree, (list, tuple)) or len(tree) != len(target):
            raise ValueError(f"checkpoint{where}: expected {len(target)} "
                             "items")
        return type(target)(_like(a, b, f"{where}.{i}")
                            for i, (a, b) in enumerate(zip(tree, target)))
    if isinstance(target, torch.Tensor):
        if tuple(tree.shape) != tuple(target.shape):
            raise ValueError(f"checkpoint{where}: shape {tuple(tree.shape)} "
                             f"!= {tuple(target.shape)}")
        return tree.to(device=target.device, dtype=target.dtype)
    return tree
