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
grid baked by the JAX package across.  :func:`jax_init` draws the JAX
package's ``IntrinsicAvatar.init(PRNGKey(seed))`` without JAX, by its key
path in numpy (``utils/jax_random.py``), so that a seed gives both packages
the same initial model.
"""

from __future__ import annotations

import math

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
    where unset) as numpy arrays in the JAX tree's layout.  The arrays are
    copies: JAX on the CPU may take a numpy array's buffer as its own, and a
    later in-place update of the model (an optimizer step) must not change
    a JAX array made from them, nor race JAX's asynchronous dispatch."""
    flat = {}
    for name, p in model.named_parameters():
        t = p if not grads else (p.grad if p.grad is not None
                                 else torch.zeros_like(p))
        flat[jax_key(name)] = t.detach().cpu().numpy().copy()
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


def _vanilla_mlp(key, mlp) -> list:
    """The JAX ``VanillaMLP.init`` (`nets/mlp.py:73-104` of the JAX
    package) for the port's ``mlp``, each op rounded to float32 as JAX's
    eager ops round."""
    from intrinsicavatar_tpu_torch.utils import jax_random as JR
    f32 = np.float32
    n = len(mlp.dims) - 1
    keys = JR.split(key, n)
    layers = []
    for i in range(n):
        d_in, d_out = mlp.dims[i], mlp.dims[i + 1]
        b = np.zeros(d_out, f32)
        if mlp.sphere_init:
            if i == n - 1:
                w = JR.normal(keys[i], (d_in, d_out)) * f32(1e-4) \
                    + f32(math.sqrt(math.pi) / math.sqrt(d_in))
                b = np.full(d_out, -mlp.sphere_init_radius, f32)
            else:
                rows = min(3, d_in) if i == 0 else d_in
                w = np.zeros((d_in, d_out), f32)
                w[:rows] = JR.normal(keys[i], (rows, d_out)) \
                    * f32(math.sqrt(2)) / f32(math.sqrt(d_out))
        else:
            bound = math.sqrt(6.0 / d_in)
            w = JR.uniform(keys[i], (d_in, d_out), -bound, bound)
        if mlp.weight_norm:
            g = np.sqrt(np.sum(w.astype(np.float64) ** 2, 0, keepdims=True))
            layers.append({"v": w, "g": g.astype(f32), "b": b})
        else:
            layers.append({"w": w, "b": b})
    return layers


def _lipschitz_mlp(key, mlp) -> list:
    """The JAX ``LipschitzMLP.init`` (`nets/mlp.py:270-283`)."""
    from intrinsicavatar_tpu_torch.utils import jax_random as JR
    keys = JR.split(key, len(mlp.dims) - 1)
    layers = []
    for k, d_in, d_out in zip(keys, mlp.dims[:-1], mlp.dims[1:]):
        bound = 1.0 / math.sqrt(d_in)
        w = JR.uniform(k, (d_in, d_out), -bound, bound)
        b = JR.uniform(JR.fold_in(k, 1), (d_out,), -bound, bound)
        c = np.abs(w).sum(0, dtype=np.float64).max() * 2.0
        layers.append({"w": w, "b": b, "c": np.full(1, c, np.float32)})
    return layers


def _mlp(key, mlp) -> list:
    from intrinsicavatar_tpu_torch.nets.mlp import LipschitzMLP, VanillaMLP
    if isinstance(mlp, LipschitzMLP):
        return _lipschitz_mlp(key, mlp)
    if isinstance(mlp, VanillaMLP):
        return _vanilla_mlp(key, mlp)
    raise NotImplementedError(f"jax_init: no JAX init for {type(mlp)}")


@torch.no_grad()
def jax_init(model, seed: int) -> dict:
    """Load the JAX package's ``IntrinsicAvatar.init(PRNGKey(seed))``
    (`render/renderer.py:115-131`) into the port's ``model``; returns the
    tree.  The hash tables, the uniform MLP layers and the emitter's draws
    are JAX's bits; the sphere-initialized SDF layers (``jax.random.normal``)
    within a few ulp of them.  Leaves drawn from no key (the density's
    beta, the emitter's lobe axes and sharpness, the pose corrections) are
    the model's own init's."""
    from intrinsicavatar_tpu_torch.pbr.envlight import (
        EnvLightSG, EnvLightTensor,
    )
    from intrinsicavatar_tpu_torch.utils import jax_random as JR
    model.init(torch.Generator().manual_seed(0))
    tree = to_jax_tree(model)
    ks = JR.split(JR.prng_key(seed), 8)

    def field(key, module):
        k_table, k_mlp = JR.split(key)
        return {"table": JR.uniform(k_table, tuple(module.table.shape),
                                    -1e-4, 1e-4),
                "mlp": _mlp(k_mlp, module.mlp)}

    tree["geometry"] = field(ks[0], model.geometry)
    tree["radiance"] = field(ks[1], model.radiance)
    tree["material"] = {"mlp": _mlp(ks[3], model.material.mlp)}
    em = model.emitter
    if em is not None:
        k_em = JR.fold_in(ks[7], 1)
        if isinstance(em, EnvLightSG):
            tree["emitter"]["amplitude"] = JR.uniform(
                k_em, tuple(em.amplitude.shape)) * np.float32(0.5) \
                + np.float32(0.25)
        elif isinstance(em, EnvLightTensor):
            tree["emitter"]["base"] = JR.uniform(
                k_em, tuple(em.base.shape)) * np.float32(em.scale) \
                + np.float32(em.bias)
        else:
            raise NotImplementedError(f"jax_init: no JAX init for "
                                      f"{type(em)}")
    from_jax_params(model, tree)
    return tree
