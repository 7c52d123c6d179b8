"""Occupancy-grid state, its training-time EMA update and the per-frame eval
grid (counterpart of the JAX package's ``render/occupancy.py``)."""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from intrinsicavatar_tpu_torch.ops.morphology import (
    max_connected_component, max_pool3d,
)


class OccGridState(NamedTuple):
    occs: torch.Tensor       # [T, res^3] float EMA occupancy
    binaries: torch.Tensor   # [T, res, res, res] bool
    aabbs: torch.Tensor      # [T, 6]


def make_occ_grid(aabbs, resolution: int = 64, device=None) -> OccGridState:
    """``aabbs [T, 6]``: one all-occupied level per time index."""
    aabbs = torch.as_tensor(aabbs, dtype=torch.float32,
                            device=device).reshape(-1, 6)
    T = aabbs.shape[0]
    return OccGridState(
        occs=torch.zeros((T, resolution ** 3), device=aabbs.device),
        binaries=torch.ones((T, resolution, resolution, resolution),
                            dtype=torch.bool, device=aabbs.device),
        aabbs=aabbs)


def level_of(state: OccGridState, t_idx) -> int:
    """Temporal level selection ``floor(t_idx * T)``, clipped."""
    T = state.binaries.shape[0]
    return min(max(int(float(t_idx) * T), 0), T - 1)


def grid_coords(resolution: int, device=None) -> torch.Tensor:
    """Integer voxel coordinates ``[res^3, 3]`` in x-major (x, y, z) order."""
    r = torch.arange(resolution, device=device)
    x, y, z = torch.meshgrid(r, r, r, indexing="ij")
    return torch.stack([x, y, z], -1).reshape(-1, 3)


def sample_voxel_points(aabb, resolution: int, u) -> torch.Tensor:
    """Jittered positions ``[res^3 * n, 3]`` from offsets ``u [res^3, n, 3]``
    in [0, 1)."""
    gc = grid_coords(resolution, aabb.device).to(torch.float32)[:, None, :]
    x = (gc + u) / resolution
    return (aabb[:3] + x * (aabb[3:] - aabb[:3])).reshape(-1, 3)


def compute_test_occ_grid(occ_eval_fn: Callable, aabb, resolution: int = 64,
                          n_samples: int = 3, occ_thre: float = 0.01,
                          jitter=None, generator=None):
    """Fresh deformed-space grid for eval (`models/intrinsic_avatar.py:
    307-381`): ``n_samples`` jittered samples per voxel -> max -> 3^3 max
    pool -> adaptive threshold -> largest component.

    ``jitter [res^3, n_samples, 3]`` injects the offsets; otherwise they are
    drawn from ``generator`` (on the CPU, then moved).
    """
    if jitter is None:
        jitter = torch.rand((resolution ** 3, n_samples, 3),
                            generator=generator).to(aabb.device)
    x = sample_voxel_points(aabb, resolution, jitter)
    occ = occ_eval_fn(x).reshape(-1, n_samples).max(1).values
    pooled = max_pool3d(occ.reshape(resolution, resolution, resolution))
    thre = torch.clamp(pooled.mean(), max=occ_thre)
    return max_connected_component(pooled > thre)


@torch.no_grad()
def update_occ_grid(state: OccGridState, level: int, occ_eval_fn: Callable,
                    jitter, occ_thre: float = 0.001,
                    ema_decay: float = 0.8) -> OccGridState:
    """EMA-max update of one level (`temporal_occ_grid.py:369-411`):
    ``occ_eval_fn`` maps one jittered point per voxel (``jitter [res^3, 1,
    3]`` in [0, 1)) to alphas; the decayed EMA takes their max, then a 3^3
    max pool, the adaptive threshold ``min(mean, occ_thre)`` and the largest
    connected component give the level's binary grid."""
    res = state.binaries.shape[1]
    x = sample_voxel_points(state.aabbs[level], res, jitter)
    occ = occ_eval_fn(x).reshape(-1)
    occs_lvl = torch.maximum(state.occs[level] * ema_decay, occ)
    occs = state.occs.clone()
    occs[level] = occs_lvl
    pooled = max_pool3d(occs_lvl.reshape(res, res, res))
    thre = torch.clamp(pooled.mean(), max=occ_thre)
    binaries = state.binaries.clone()
    binaries[level] = max_connected_component(pooled > thre)
    return OccGridState(occs=occs, binaries=binaries, aabbs=state.aabbs)
