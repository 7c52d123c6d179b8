"""Isosurface extraction: marching tetrahedra (a copy of the JAX package's
``utils/marching.py``; numpy, dependency-free; the crossing cubes found
from the corners' signs before any cube's values are gathered, and the
weld's unique rows by a lexicographic sort, with the same output).

Replaces the reference's ``torchmcubes``/``mcubes`` marching-cubes helper
(`models/rf/geometry.py:14-49` in taconite/IntrinsicAvatar).  Marching
tetrahedra needs no 256-entry case tables: each cube splits into 6
tetrahedra and every tet emits 0-2 triangles depending on its sign
configuration — meshes are watertight and adequate for export/eval.
"""

from __future__ import annotations

import numpy as np

# 6-tetrahedra decomposition of the unit cube (corner indices).
# Cube corners: bit 0 -> x, bit 1 -> y, bit 2 -> z.
_TETS = np.array([
    [0, 5, 1, 3],
    [0, 5, 3, 7],
    [0, 5, 7, 4],
    [0, 7, 3, 2],
    [0, 7, 2, 6],
    [0, 7, 6, 4],
])

_CORNERS = np.array([[(c >> 0) & 1, (c >> 1) & 1, (c >> 2) & 1]
                     for c in range(8)])


def marching_tetrahedra(sdf: np.ndarray, level: float = 0.0):
    """Extract the ``sdf == level`` surface.

    Args:
      sdf: ``[Nx, Ny, Nz]`` scalar field on the unit-spaced integer grid.
    Returns:
      ``(verts [V, 3], faces [F, 3])`` with vertices in voxel coordinates
      (``[0, N-1]`` per axis).
    """
    sdf = np.asarray(sdf, np.float32)
    nx, ny, nz = sdf.shape
    # cubes with a crossing, from the corners' signs alone (the JAX
    # package gathers every cube's 8 values first): the same cubes in the
    # same (x, y, z) order, and only theirs are gathered
    ins = sdf < level
    any_in = np.zeros((nx - 1, ny - 1, nz - 1), bool)
    all_in = np.ones((nx - 1, ny - 1, nz - 1), bool)
    for c in range(8):
        dx, dy, dz = _CORNERS[c]
        s = ins[dx:nx - 1 + dx, dy:ny - 1 + dy, dz:nz - 1 + dz]
        any_in |= s
        all_in &= s
    cube = np.nonzero(any_in & ~all_in)
    if len(cube[0]) == 0:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64)
    base = np.stack(cube, -1).astype(np.int64)
    vals = np.empty((len(base), 8), np.float32)
    for c in range(8):
        dx, dy, dz = _CORNERS[c]
        vals[:, c] = sdf[cube[0] + dx, cube[1] + dy, cube[2] + dz]

    tris = []
    corner_pos = _CORNERS.astype(np.float32)          # [8, 3]
    for tet in _TETS:
        v = vals[:, tet]                              # [M, 4]
        p = base[:, None, :] + corner_pos[tet][None]  # [M, 4, 3]
        ins = v < level                               # [M, 4]
        n_in = ins.sum(1)

        def edge_point(sel, a, b):
            """Interpolated crossing on edge (a, b) for rows sel."""
            va, vb = v[sel, a], v[sel, b]
            t = (level - va) / np.where(np.abs(vb - va) > 1e-12, vb - va, 1.0)
            t = np.clip(t, 0.0, 1.0)[:, None]
            return p[sel, a] * (1 - t) + p[sel, b] * t

        # one vertex inside (or one outside): single triangle
        for k, flip in ((1, False), (3, True)):
            sel_rows = np.where(n_in == k)[0]
            if len(sel_rows) == 0:
                continue
            pivot_mask = ins if k == 1 else ~ins
            pivot = np.argmax(pivot_mask[sel_rows], axis=1)
            others = np.array([[b for b in range(4) if b != a]
                               for a in range(4)])
            tri = np.stack([
                edge_point(sel_rows, pivot, others[pivot][:, j])
                for j in range(3)
            ], 1)
            tris.append(tri)

        # two inside: quad -> two triangles
        sel_rows = np.where(n_in == 2)[0]
        if len(sel_rows) > 0:
            ins2 = ins[sel_rows]
            # indices of the two inside (i0 < i1) and two outside verts
            order = np.argsort(~ins2, axis=1)
            i0, i1 = order[:, 0], order[:, 1]
            o0, o1 = order[:, 2], order[:, 3]
            e00 = edge_point(sel_rows, i0, o0)
            e01 = edge_point(sel_rows, i0, o1)
            e10 = edge_point(sel_rows, i1, o0)
            e11 = edge_point(sel_rows, i1, o1)
            tris.append(np.stack([e00, e01, e10], 1))
            tris.append(np.stack([e10, e01, e11], 1))

    tri = np.concatenate(tris, 0)                     # [T, 3, 3]
    # weld vertices
    flat = tri.reshape(-1, 3)
    key = np.round(flat / 1e-5).astype(np.int64)
    # np.unique(key, axis=0, return_index=True, return_inverse=True) by a
    # stable lexicographic sort of the three columns (the same rows, first
    # occurrences and inverse; unique's row sort is the slow part)
    order = np.lexsort((key[:, 2], key[:, 1], key[:, 0]))
    sk = key[order]
    first = np.ones(len(sk), bool)
    first[1:] = np.any(sk[1:] != sk[:-1], axis=1)
    idx = order[first]
    inv = np.empty(len(key), np.int64)
    inv[order] = np.cumsum(first) - 1
    verts = flat[idx]
    faces = inv.reshape(-1, 3)
    # drop degenerate faces
    good = (faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2]) \
        & (faces[:, 0] != faces[:, 2])
    return verts.astype(np.float32), faces[good].astype(np.int64)


def export_mesh_obj(path: str, verts: np.ndarray, faces: np.ndarray):
    """Minimal OBJ writer (replaces the trimesh export in
    `utils/mixins.py:226-239`)."""
    with open(path, "w") as f:
        for v in verts:
            f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        for tri in faces + 1:
            f.write(f"f {tri[0]} {tri[1]} {tri[2]}\n")


def extract_isosurface(sdf_fn, bbox: np.ndarray, resolution: int = 256,
                       chunk: int = 262144, level: float = 0.0,
                       two_pass: bool = True):
    """Coarse-to-fine isosurface of an SDF callable over ``bbox [2,3]``.

    Mirrors ``BaseImplicitGeometry.isosurface`` (`models/rf/geometry.py:93-104`):
    a coarse pass bounds the surface, the fine pass re-extracts inside the
    (10%-padded) tight bbox.
    """

    def field(vmin, vmax, res):
        axes = [np.linspace(vmin[i], vmax[i], res) for i in range(3)]
        grid = np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3)
        out = []
        for i in range(0, len(grid), chunk):
            out.append(np.asarray(sdf_fn(grid[i:i + chunk])))
        return np.concatenate(out).reshape(res, res, res), axes

    bbox = np.asarray(bbox, np.float32)
    res0 = min(resolution, 128) if two_pass else resolution
    sdf0, axes0 = field(bbox[0], bbox[1], res0)
    verts, faces = marching_tetrahedra(sdf0, level)
    if len(verts) == 0:
        return verts, faces
    scale0 = (bbox[1] - bbox[0]) / (res0 - 1)
    verts_w = bbox[0] + verts * scale0
    if not two_pass:
        return verts_w, faces

    vmin, vmax = verts_w.min(0), verts_w.max(0)
    pad = (vmax - vmin) * 0.1
    vmin = np.clip(vmin - pad, bbox[0], bbox[1])
    vmax = np.clip(vmax + pad, bbox[0], bbox[1])
    sdf1, _ = field(vmin, vmax, resolution)
    verts, faces = marching_tetrahedra(sdf1, level)
    scale1 = (vmax - vmin) / (resolution - 1)
    return vmin + verts * scale1, faces
