"""Carry a parameter tree of the JAX package into the port's modules.

``IntrinsicAvatar.init`` of the JAX package returns a nested dict of arrays
(`render/renderer.py:115-131`): ``{v, g, b}`` weight-normed layers,
``{w, b}`` layers and the material head's ``{w, b, c}`` layers in lists
under ``mlp``, hash tables ``[L, T, F]`` under ``table``, the density
``beta``, the emitter's lobes (``axes, sharpness, amplitude``) or image
(``base``), the pose corrections, and empty groups for the deformer, the
pose encoder and the scatterer.  Weights are ``[in, out]`` on both sides.
:func:`to_jax_tree` is the inverse of :func:`from_jax_params`: the port's
parameters as a JAX-shaped tree.  :func:`seed_grid_from_jax` carries a seed
grid baked by the JAX package across.
"""

from __future__ import annotations

import numpy as np
import torch

from intrinsicavatar_tpu_torch.anim.seedgrid import SeedGrid, node_records


def flatten_tree(tree, prefix: str = "") -> dict:
    """``{"a.b.0.v": array}`` from nested dicts and lists of arrays."""
    flat = {}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        key = f"{prefix}{k}"
        if isinstance(v, (dict, list, tuple)):
            flat.update(flatten_tree(v, key + "."))
        else:
            flat[key] = np.asarray(v)
    return flat


def port_key(jax_key: str) -> str:
    """Name of a JAX leaf in the port's ``state_dict``."""
    return jax_key.replace(".mlp.", ".mlp.layers.")


def jax_key(port_name: str) -> str:
    """Dotted path of the JAX leaf that a port parameter carries."""
    return port_name.replace(".mlp.layers.", ".mlp.")


def unflatten(flat: dict) -> dict:
    """Nested dicts and lists from dotted keys (list items are digits)."""
    root: dict = {}
    for key, arr in flat.items():
        node, parts = root, key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr

    def lists(node):
        if not isinstance(node, dict):
            return node
        node = {k: lists(v) for k, v in node.items()}
        if node and all(k.isdigit() for k in node):
            return [node[str(i)] for i in range(len(node))]
        return node

    return lists(root)


def to_jax_tree(model, grads: bool = False) -> dict:
    """The port's parameters (or, with ``grads``, their ``.grad``, zeros
    where unset) as numpy arrays in the JAX tree's layout."""
    flat = {}
    for name, p in model.named_parameters():
        t = p if not grads else (p.grad if p.grad is not None
                                 else torch.zeros_like(p))
        flat[jax_key(name)] = t.detach().cpu().numpy()
    return unflatten(flat)


@torch.no_grad()
def from_jax_params(model, tree) -> dict:
    """Load the JAX tree into ``model``; returns ``{jax key: port key}``.

    Raises if a leaf of the tree has no home in the port, if a shape
    differs, or if a parameter of the port is left unset.
    """
    state = model.state_dict()
    flat = flatten_tree(tree)
    landed, unset = {}, set(state)
    for key, arr in flat.items():
        pk = port_key(key)
        if pk not in state:
            raise KeyError(f"JAX parameter {key!r} has no counterpart "
                           f"{pk!r} in the port")
        if tuple(state[pk].shape) != arr.shape:
            raise ValueError(f"{key}: JAX shape {arr.shape} != port shape "
                             f"{tuple(state[pk].shape)}")
        state[pk].copy_(torch.from_numpy(np.array(arr, dtype=np.float32)))
        landed[key] = pk
        unset.discard(pk)
    if unset:
        raise KeyError(f"port parameters not set by the tree: "
                       f"{sorted(unset)}")
    return landed


def seed_grid_from_jax(grid):
    """A seed grid baked by the JAX package (its ``SeedGrid``: ``packed
    [res^3, 8*C]`` corner-packed with "border" padding, ``center``,
    ``half``) as the port's channel-last
    :class:`SeedGrid` in node records.  Corner 0 of
    a border-packed row is the node itself, so the grid is ``packed[:,
    :C]``."""
    packed = np.asarray(grid.packed, np.float32)
    C = packed.shape[1] // 8
    res = round(packed.shape[0] ** (1.0 / 3.0))
    as_t = lambda a: torch.as_tensor(np.array(a, np.float32))
    return SeedGrid(grid=node_records(as_t(packed[:, :C]
                                           .reshape(res, res, res, C))),
                    center=as_t(grid.center), half=as_t(grid.half))
