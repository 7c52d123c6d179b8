"""Occupancy-grid ray marching with rectangular output (counterpart of the
JAX package's ``ops/grid_traversal.py``).

Every ray gets a fixed budget of ``S`` uniform steps between its entry and
exit of the scene AABB; a step is a sample iff the occupancy voxel at its
midpoint is set.  Output is the edge-list form the merge resampler consumes.
:func:`occupancy_sampling` launches kernel KE (``csrc/march.cu``) for CUDA
tensors and takes the plain twin :func:`occupancy_sampling_plain` only for
CPU tensors; :func:`secondary_march` (the secondary rays' march straight to
capped samples, ``render/pbr.py:197-224`` of the JAX package) launches
kernel KK of the same source, with :func:`secondary_march_plain` its twin.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from intrinsicavatar_tpu_torch import kernels
from intrinsicavatar_tpu_torch.ops.compact import stable_partition_indices


class RayIntervals(NamedTuple):
    """Edge-list intervals ``[R, E]``: interval k spans ``vals[k],
    vals[k+1]`` and is a sample iff ``is_left[k] & is_right[k+1]``; valid
    slots are left-packed and ascending, invalid ones hold +inf."""

    vals: torch.Tensor
    is_left: torch.Tensor
    is_right: torch.Tensor
    valid: torch.Tensor


def ray_aabb_intersect(rays_o, rays_d, aabb):
    """Slab test against ``aabb [6]`` (min, max) -> ``(t_min, t_max)``."""
    inv = 1.0 / torch.where(torch.abs(rays_d) > 1e-10, rays_d,
                            torch.where(rays_d >= 0, 1e-10, -1e-10))
    t0 = (aabb[:3] - rays_o) * inv
    t1 = (aabb[3:] - rays_o) * inv
    t_min = torch.minimum(t0, t1).max(-1).values
    t_max = torch.maximum(t0, t1).min(-1).values
    return t_min, t_max


def occupancy_sampling_plain(rays_o, rays_d, binaries, aabb,
                             step_size: float, num_steps: int, near=None,
                             far=None, stratified_u=None) -> RayIntervals:
    """Plain twin of kernel KE."""
    S = num_steps
    res = binaries.shape[0]
    t_enter, t_exit = ray_aabb_intersect(rays_o, rays_d, aabb)
    t_enter = torch.clamp(t_enter, min=0.0)
    if near is not None:
        t_enter = torch.maximum(t_enter, near)
    if far is not None:
        t_exit = torch.minimum(t_exit, far)
    if stratified_u is not None:
        t_enter = t_enter + stratified_u * step_size
    i = torch.arange(S + 1, dtype=rays_o.dtype, device=rays_o.device)
    edges = t_enter[:, None] + i[None, :] * step_size            # [R, S+1]
    mids = 0.5 * (edges[:, :-1] + edges[:, 1:])
    pos = rays_o[:, None, :] + rays_d[:, None, :] * mids[..., None]
    ext = aabb[3:] - aabb[:3]
    v = torch.floor((pos - aabb[:3]) / ext * res).to(torch.int64)
    in_grid = ((v >= 0) & (v < res)).all(-1)
    vc = torch.clamp(v, 0, res - 1)
    occ = binaries[vc[..., 0], vc[..., 1], vc[..., 2]]
    hit = t_exit > t_enter
    occ = occ & in_grid & (edges[:, 1:] <= t_exit[:, None]) & hit[:, None]
    is_left = F.pad(occ, (0, 1))                # edge i opens interval i
    is_right = F.pad(occ, (1, 0))               # edge i closes interval i-1
    valid = is_left | is_right
    vals = torch.where(valid, edges, torch.inf)
    order = stable_partition_indices(valid)
    take = lambda a: torch.gather(a, 1, order)
    return RayIntervals(vals=take(vals), is_left=take(is_left),
                        is_right=take(is_right), valid=take(valid))


def occupancy_sampling(rays_o, rays_d, binaries, aabb, step_size: float,
                       num_steps: int, near=None, far=None,
                       stratified_u=None) -> RayIntervals:
    """March rays ``[R, 3]`` through the binary grid ``[res]^3`` (x, y, z
    order) inside ``aabb [6]``; ``near``/``far [R]`` clip each ray and
    ``stratified_u [R]`` shifts each start by ``u * step_size``.  Returns
    ``[R, num_steps + 1]`` edge lists."""
    if rays_o.device.type == "cpu":
        return occupancy_sampling_plain(rays_o, rays_d, binaries, aabb,
                                        step_size, num_steps, near, far,
                                        stratified_u)
    dev = rays_o.device
    R, S, res = rays_o.shape[0], int(num_steps), binaries.shape[0]
    f32 = torch.float32
    kernels.require(rays_o, "rays_o", f32, dev, (R, 3))
    kernels.require(rays_d, "rays_d", f32, dev, (R, 3))
    kernels.require(binaries, "binaries", torch.bool, dev, (res, res, res))
    kernels.require(aabb, "aabb", f32, dev, (6,))
    opt = []
    for name, t in (("near", near), ("far", far),
                    ("stratified_u", stratified_u)):
        if t is not None:
            kernels.require(t, name, f32, dev, (R,))
        opt.append(None if t is None else t.data_ptr())
    vals = torch.empty((R, S + 1), dtype=f32, device=dev)
    # is_left, is_right and valid: views of one buffer
    flags = torch.empty((3, R, S + 1), dtype=torch.bool, device=dev)
    fp, n = flags.data_ptr(), R * (S + 1)
    err = kernels.lib("march").occupancy_march_fwd(
        rays_o.data_ptr(), rays_d.data_ptr(), *opt, binaries.data_ptr(),
        aabb.data_ptr(), R, S, res, float(step_size), vals.data_ptr(), fp,
        fp + n, fp + 2 * n, kernels.stream_ptr(dev))
    kernels.check(err, "occupancy_march")
    kernels.launches["occupancy_march"] += 1
    return RayIntervals(vals, *flags.unbind(0))


def intervals_to_samples(iv: RayIntervals):
    """Edge list -> ``(t_starts, t_ends, mask)``, each ``[R, E-1]``."""
    mask = iv.is_left[:, :-1] & iv.is_right[:, 1:] & iv.valid[:, :-1] \
        & iv.valid[:, 1:]
    t_starts = torch.where(mask, iv.vals[:, :-1], 0.0)
    t_ends = torch.where(mask, iv.vals[:, 1:], 0.0)
    return t_starts, t_ends, mask


def secondary_march_plain(rays_o, rays_d, binaries, aabb, step_size: float,
                          num_steps: int, near, far, active=None,
                          max_valid: int = 0):
    """Plain twin of kernel KK."""
    iv = occupancy_sampling_plain(rays_o, rays_d, binaries, aabb, step_size,
                                  num_steps, near=near, far=far)
    t_starts, t_ends, smask = intervals_to_samples(iv)
    if active is not None:
        smask = smask & active[:, None]
    if 0 < max_valid < num_steps:
        smask = smask & (torch.cumsum(smask.to(torch.int32), 1) <= max_valid)
    return t_starts, t_ends, smask


def secondary_march(rays_o, rays_d, binaries, aabb, step_size: float,
                    num_steps: int, near, far, active=None,
                    max_valid: int = 0):
    """March secondary rays ``[M, 3]`` through the grid (``near``/``far``
    ``[M]``, no stratified shift) and return their samples ``(t_starts,
    t_ends, mask)``, each ``[M, num_steps]``, the mask ANDed with
    ``active [M]`` and cut after each ray's first ``max_valid`` masked
    samples (0: no cut)."""
    if rays_o.device.type == "cpu":
        return secondary_march_plain(rays_o, rays_d, binaries, aabb,
                                     step_size, num_steps, near, far, active,
                                     max_valid)
    dev = rays_o.device
    M, S, res = rays_o.shape[0], int(num_steps), binaries.shape[0]
    f32 = torch.float32
    kernels.require(rays_o, "rays_o", f32, dev, (M, 3))
    kernels.require(rays_d, "rays_d", f32, dev, (M, 3))
    kernels.require(near, "near", f32, dev, (M,))
    kernels.require(far, "far", f32, dev, (M,))
    kernels.require(binaries, "binaries", torch.bool, dev, (res, res, res))
    kernels.require(aabb, "aabb", f32, dev, (6,))
    if active is not None:
        kernels.require(active, "active", torch.bool, dev, (M,))
    t_starts = torch.empty((M, S), dtype=f32, device=dev)
    t_ends = torch.empty((M, S), dtype=f32, device=dev)
    smask = torch.empty((M, S), dtype=torch.bool, device=dev)
    err = kernels.lib("march").secondary_march_fwd(
        rays_o.data_ptr(), rays_d.data_ptr(), near.data_ptr(),
        far.data_ptr(), None if active is None else active.data_ptr(),
        binaries.data_ptr(), aabb.data_ptr(), M, S, res, float(step_size),
        int(max_valid) if 0 < max_valid < S else 0, t_starts.data_ptr(),
        t_ends.data_ptr(), smask.data_ptr(), kernels.stream_ptr(dev))
    kernels.check(err, "secondary_march")
    kernels.launches["secondary_march"] += 1
    return t_starts, t_ends, smask
