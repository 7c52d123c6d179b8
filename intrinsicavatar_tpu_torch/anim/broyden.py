"""Broyden inverse-LBS root search with its prologue and epilogue.

Counterpart of the JAX package's ``anim/broyden.py`` and of the search's
surroundings in its ``anim/deformer.py``.  Each wrapper launches its kernel
for CUDA tensors and takes its plain twin only for CPU tensors:

- :func:`deform_prologue` (kernel KH, ``csrc/deform.cu``): init pruning;
- :func:`broyden_search` (kernel KC, ``csrc/broyden.cu``): the single-phase
  loop (the JAX op's ``two_phase=False``);
- :func:`broyden_polish` (kernel KL, the same source): one lane per point
  started at a seed root, KC's loop body for a few iterations;
- :func:`deform_epilogue` (kernel KH): duplicate filter, overflow count and
  first-K survivors, then, where asked, :func:`deform_skinning` (KH's second
  stage): the LBS-weight sample and the forward-skinning rotation;
- :func:`deform_skinning_bwd` (kernel KN, ``csrc/deform.cu``): the
  cotangent of ``tfs`` from the train-mode correction and the rotation.

Nothing here copies the TPU layouts (SoA state, corner-packed tables, lane
compaction).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from intrinsicavatar_tpu_torch import kernels
from intrinsicavatar_tpu_torch.ops.compact import stable_partition_indices

# Bone indices used as Broyden initializations (`deformer_torch.py:27`).
INIT_BONES = np.array([0, 1, 2, 4, 5, 10, 11, 12, 15, 16, 17, 18, 19],
                      dtype=np.int64)
N_BONES = 24
MAX_INIT = 16   # kMaxInit of csrc/deform.cu
MAX_INIT_BONES = N_BONES   # kBones of csrc/deform.cu: the prologue's
#                            limit on the rows of its table
SKIN_BWD_TILE = 288      # KN_TILE of csrc/deform.cu: lanes a tile
SKIN_BWD_SLICES = 16     # KN_SLICES: the lane slices of a tile's reduction
SKIN_BWD_BLOCKS = 3 * 132  # KN's persistent blocks: KN_BLOCKS_PER_SM on each
#                            of an H100's streaming multiprocessors


def grid_sample_3d(vox_cl: torch.Tensor, shape_dhw, coords: torch.Tensor,
                   padding: str = "zeros") -> torch.Tensor:
    """Trilinear sample of a channel-last voxel ``[D*H*W, C]`` at ``[N, 3]``
    coords in [-1, 1] (align_corners) -> ``[N, C]``.

    ``zeros`` drops out-of-grid corners (the inlined CUDA sampler of
    Fast-SNARF); ``border`` clamps the coordinates and corners (torch
    ``grid_sample(padding_mode='border')``).  Corners are summed in
    ``(dx, dy, dz)`` order, dz fastest.
    """
    D, H, W = shape_dhw
    ix = (coords[:, 0] + 1.0) * 0.5 * (W - 1)
    iy = (coords[:, 1] + 1.0) * 0.5 * (H - 1)
    iz = (coords[:, 2] + 1.0) * 0.5 * (D - 1)
    if padding == "border":
        ix = torch.clamp(ix, 0.0, W - 1.0)
        iy = torch.clamp(iy, 0.0, H - 1.0)
        iz = torch.clamp(iz, 0.0, D - 1.0)
    x0f, y0f, z0f = torch.floor(ix), torch.floor(iy), torch.floor(iz)
    fx, fy, fz = ix - x0f, iy - y0f, iz - z0f
    x0, y0, z0 = x0f.long(), y0f.long(), z0f.long()
    out = torch.zeros((coords.shape[0], vox_cl.shape[1]), dtype=vox_cl.dtype,
                      device=vox_cl.device)
    for dx in (0, 1):
        wx = fx if dx else 1.0 - fx
        for dy in (0, 1):
            wy = fy if dy else 1.0 - fy
            for dz in (0, 1):
                wz = fz if dz else 1.0 - fz
                px, py, pz = x0 + dx, y0 + dy, z0 + dz
                w = wx * wy * wz
                if padding != "border":
                    ok = ((px >= 0) & (px < W) & (py >= 0) & (py < H)
                          & (pz >= 0) & (pz < D))
                    w = torch.where(ok, w, 0.0)
                idx = (torch.clamp(pz, 0, D - 1) * H
                       + torch.clamp(py, 0, H - 1)) * W \
                    + torch.clamp(px, 0, W - 1)
                out = out + w[:, None] * vox_cl[idx]
    return out


def channel_last(vox: torch.Tensor) -> torch.Tensor:
    """``[C, D, H, W]`` -> contiguous ``[D*H*W, C]``."""
    return vox.reshape(vox.shape[0], -1).T.contiguous()


def segment_table(init_segs: np.ndarray) -> np.ndarray:
    """``[n, 7]`` rows ``(a, b - a, |b - a|^2 + 1e-9)`` of the canonical bone
    segments ``init_segs [n, 2, 3]``.  The denominator is rounded on the
    host as the JAX op rounds its Python-float denominator, so the pruning
    of both packages divides by the same float32."""
    a = init_segs[:, 0]
    ab = init_segs[:, 1] - a
    denom = np.asarray([float(v @ v) + 1e-9 for v in ab], np.float32)
    return np.concatenate([a, ab, denom[:, None]], 1).astype(np.float32)


def deform_prologue_plain(pts, tfs_table, segs, n_init: int) -> torch.Tensor:
    """Plain twin of :func:`deform_prologue`."""
    px, py, pz = pts[:, 0], pts[:, 1], pts[:, 2]
    dists = []
    for s_ in range(tfs_table.shape[0]):
        T, g = tfs_table[s_], segs[s_]
        dx, dy, dz = px - T[0, 3], py - T[1, 3], pz - T[2, 3]
        xi = T[0, 0] * dx + T[1, 0] * dy + T[2, 0] * dz
        yi = T[0, 1] * dx + T[1, 1] * dy + T[2, 1] * dz
        zi = T[0, 2] * dx + T[1, 2] * dy + T[2, 2] * dz
        t = torch.clamp(((xi - g[0]) * g[3] + (yi - g[1]) * g[4]
                         + (zi - g[2]) * g[5]) / g[6], 0.0, 1.0)
        ddx = xi - (g[0] + t * g[3])
        ddy = yi - (g[1] + t * g[4])
        ddz = zi - (g[2] + t * g[5])
        dists.append(ddx * ddx + ddy * ddy + ddz * ddz)
    d = torch.stack(dists, -1)
    # ascending stable sort = jax.lax.top_k(-d) with its tie order
    slot = torch.argsort(d, dim=-1, stable=True)[:, :n_init]
    return slot.reshape(-1).to(torch.int32)


def deform_prologue(pts, tfs_table, segs, n_init: int) -> torch.Tensor:
    """Init pruning of the search (`FastSNARF.search`): for each point
    ``pts [N, 3]`` the ``n_init`` rows of ``tfs_table [n, 4, 4]`` whose
    canonicalized start point ``R^T (p - t)`` lies nearest its segment
    (``segs [n, 7]`` from :func:`segment_table`), nearest first, lower row
    first on ties.  Returns ``slot [N * n_init]`` int32."""
    if pts.device.type == "cpu":
        return deform_prologue_plain(pts, tfs_table, segs, n_init)
    dev = pts.device
    N, n_all = pts.shape[0], tfs_table.shape[0]
    kernels.require(pts, "pts", torch.float32, dev, (N, 3))
    kernels.require(tfs_table, "tfs_table", torch.float32, dev, (n_all, 4, 4))
    kernels.require(segs, "segs", torch.float32, dev, (n_all, 7))
    if n_all > MAX_INIT_BONES:
        raise ValueError(f"deform_prologue's kernel takes at most "
                         f"{MAX_INIT_BONES} init bones, got {n_all}")
    if not 1 <= n_init <= min(n_all, MAX_INIT):
        raise ValueError(f"n_init {n_init} outside "
                         f"[1, {min(n_all, MAX_INIT)}]")
    slot = torch.empty((N * n_init,), dtype=torch.int32, device=dev)
    err = kernels.lib("deform").deform_prologue_fwd(
        pts.data_ptr(), tfs_table.data_ptr(), segs.data_ptr(), N, n_all,
        n_init, slot.data_ptr(), kernels.stream_ptr(dev))
    kernels.check(err, "deform_prologue")
    kernels.launches["deform_prologue"] += 1
    return slot


class BroydenResult(NamedTuple):
    x: torch.Tensor        # [M, 3] canonical roots (0 where invalid)
    j_inv: torch.Tensor    # [M, 9] J^-1, row-major (0 where invalid)
    valid: torch.Tensor    # [M] bool


def _broyden_plain(xd, x, y, z, done, voxel_J, offset, scale_kernel,
                   cvg_thresh, dvg_thresh, max_iters, lane_counts=None):
    """The JAX loop (`anim/broyden.py:242-314`), vectorized over lanes, from
    canonical starts ``x, y, z [M]``; lanes ``done`` at entry stay invalid."""
    shape_dhw = tuple(voxel_J.shape[:3])
    vox = voxel_J.reshape(-1, 12)
    off = [float(v) for v in offset]
    sk = [float(v) for v in scale_kernel]

    def norm(x, y, z):
        return torch.stack([sk[0] * (x - off[0]), sk[1] * (y - off[1]),
                            sk[2] * (z - off[2])], dim=-1)

    def sample(x, y, z):
        return grid_sample_3d(vox, shape_dhw, norm(x, y, z)).unbind(-1)

    tx, ty, tz = xd[:, 0], xd[:, 1], xd[:, 2]
    J0 = sample(x, y, z)
    Ji = [J0[0], J0[4], J0[8], J0[1], J0[5], J0[9], J0[2], J0[6], J0[10]]
    g0 = J0[0] * x + J0[1] * y + J0[2] * z + J0[3] - tx
    g1 = J0[4] * x + J0[5] * y + J0[6] * z + J0[7] - ty
    g2 = J0[8] * x + J0[9] * y + J0[10] * z + J0[11] - tz

    valid = torch.zeros_like(done)
    out_x = [torch.zeros_like(x) for _ in range(3)]
    out_J = [torch.zeros_like(x) for _ in range(9)]
    cvg2, dvg2 = cvg_thresh ** 2, dvg_thresh ** 2
    steps = torch.zeros(xd.shape[0], dtype=torch.int32, device=xd.device)
    for _ in range(max_iters):
        J00, J01, J02, J10, J11, J12, J20, J21, J22 = Ji
        active = ~done
        if lane_counts is not None:
            steps += active
        u0 = -(J00 * g0 + J01 * g1 + J02 * g2)
        u1 = -(J10 * g0 + J11 * g1 + J12 * g2)
        u2 = -(J20 * g0 + J21 * g1 + J22 * g2)
        x = torch.where(active, x + u0, x)
        y = torch.where(active, y + u1, y)
        z = torch.where(active, z + u2, z)
        Jl = sample(x, y, z)
        n0 = Jl[0] * x + Jl[1] * y + Jl[2] * z + Jl[3] - tx
        n1 = Jl[4] * x + Jl[5] * y + Jl[6] * z + Jl[7] - ty
        n2 = Jl[8] * x + Jl[9] * y + Jl[10] * z + Jl[11] - tz
        nsq = n0 * n0 + n1 * n1 + n2 * n2
        conv = active & (nsq < cvg2)
        dvg = active & ~conv & (nsq > dvg2)
        cont = active & ~conv & ~dvg
        nc = norm(x, y, z)
        in_bounds = ((nc >= -1) & (nc <= 1)).all(-1)
        out_x = [torch.where(conv, v, o) for v, o in zip((x, y, z), out_x)]
        out_J = [torch.where(conv, v, o) for v, o in zip(Ji, out_J)]
        valid = torch.where(conv, in_bounds, valid)
        d0, d1, d2 = n0 - g0, n1 - g1, n2 - g2
        c0 = J00 * u0 + J10 * u1 + J20 * u2
        c1 = J01 * u0 + J11 * u1 + J21 * u2
        c2 = J02 * u0 + J12 * u1 + J22 * u2
        sden = c0 * d0 + c1 * d1 + c2 * d2
        r0 = -(J00 * d0 + J01 * d1 + J02 * d2)
        r1 = -(J10 * d0 + J11 * d1 + J12 * d2)
        r2 = -(J20 * d0 + J21 * d1 + J22 * d2)
        inv_s = torch.where(torch.abs(sden) > 1e-30, 1.0 / sden, 0.0)
        a = [(r0 + u0) * inv_s, (r1 + u1) * inv_s, (r2 + u2) * inv_s]
        c = [c0, c1, c2]
        Ji = [torch.where(cont, Ji[3 * i + j] + c[j] * a[i], Ji[3 * i + j])
              for i in range(3) for j in range(3)]
        g0 = torch.where(cont, n0, g0)
        g1 = torch.where(cont, n1, g1)
        g2 = torch.where(cont, n2, g2)
        done = done | conv | dvg
    if lane_counts is not None:
        lane_counts.append(steps)
    vf = valid.to(xd.dtype)[:, None]
    return BroydenResult(x=torch.stack(out_x, -1) * vf,
                         j_inv=torch.stack(out_J, -1) * vf, valid=valid)


def broyden_search_plain(xd, bone_idx, voxel_J, tfs, offset, scale_kernel,
                         cvg_thresh=1e-5, dvg_thresh=1e-1, max_iters=10,
                         lane_counts: list | None = None) -> BroydenResult:
    """Plain twin of kernel KC: the JAX single-phase loop, vectorized.

    ``lane_counts``, when given, receives an int32 ``[M]``: the iterations
    each lane ran before converging, diverging or running out (a
    measurement of the work this data needs)."""
    tx, ty, tz = xd[:, 0], xd[:, 1], xd[:, 2]
    T = tfs[:, :3, :].reshape(tfs.shape[0], 12)[bone_idx]
    Tb = T.unbind(-1)
    dx_, dy_, dz_ = tx - Tb[3], ty - Tb[7], tz - Tb[11]
    x = Tb[0] * dx_ + Tb[4] * dy_ + Tb[8] * dz_
    y = Tb[1] * dx_ + Tb[5] * dy_ + Tb[9] * dz_
    z = Tb[2] * dx_ + Tb[6] * dy_ + Tb[10] * dz_
    done = torch.zeros(xd.shape[0], dtype=torch.bool, device=xd.device)
    return _broyden_plain(xd, x, y, z, done, voxel_J, offset, scale_kernel,
                          cvg_thresh, dvg_thresh, max_iters, lane_counts)


def broyden_search(xd, bone_idx, voxel_J, tfs, offset, scale_kernel,
                   cvg_thresh=1e-5, dvg_thresh=1e-1,
                   max_iters=10) -> BroydenResult:
    """Broyden inverse-LBS search over lanes (`fuse_cuda_kernel_fast.cu`).

    ``xd [M, 3]`` deformed targets, ``bone_idx [M]`` rows of ``tfs [B, 4, 4]``
    to initialize from, ``voxel_J [D, H, W, 12]`` the baked transform voxel
    channel-last (as ``FrameState`` holds it), ``offset`` / ``scale_kernel``
    (3 floats each) its normalization.
    CPU tensors take the plain twin; CUDA tensors launch kernel KC.
    """
    if xd.device.type == "cpu":
        return broyden_search_plain(xd, bone_idx, voxel_J, tfs, offset,
                                    scale_kernel, cvg_thresh, dvg_thresh,
                                    max_iters)
    dev = xd.device
    M = xd.shape[0]
    D, H, W, _ = voxel_J.shape
    kernels.require(xd, "xd", torch.float32, dev, (M, 3))
    kernels.require(bone_idx, "bone_idx", torch.int32, dev, (M,))
    kernels.require(tfs, "tfs", torch.float32, dev, (None, 4, 4))
    kernels.require(voxel_J, "voxel_J", torch.float32, dev, (D, H, W, 12))
    x = torch.empty((M, 3), dtype=torch.float32, device=dev)
    j_inv = torch.empty((M, 9), dtype=torch.float32, device=dev)
    valid = torch.empty((M,), dtype=torch.bool, device=dev)
    off = [float(v) for v in offset]
    sk = [float(v) for v in scale_kernel]
    err = kernels.lib("broyden").broyden_search_fwd(
        xd.data_ptr(), bone_idx.data_ptr(), tfs.data_ptr(), voxel_J.data_ptr(),
        x.data_ptr(), j_inv.data_ptr(), valid.data_ptr(), M, D, H, W,
        int(max_iters), *off, *sk, float(cvg_thresh) ** 2,
        float(dvg_thresh) ** 2, kernels.stream_ptr(dev))
    kernels.check(err, "broyden_search")
    kernels.launches["broyden_search"] += 1
    return BroydenResult(x=x, j_inv=j_inv, valid=valid)


def broyden_polish_plain(xd, seed, seed_ok, voxel_J, offset, scale_kernel,
                         cvg_thresh=1e-5, dvg_thresh=1e-1, max_iters=4,
                         lane_counts: list | None = None) -> BroydenResult:
    """Plain twin of kernel KL; ``lane_counts`` as for
    :func:`broyden_search_plain` (0 for lanes without a seed)."""
    x, y, z = seed.unbind(-1)
    res = _broyden_plain(xd, x, y, z, ~seed_ok, voxel_J, offset,
                         scale_kernel, cvg_thresh, dvg_thresh, max_iters,
                         lane_counts)
    return res._replace(valid=res.valid & seed_ok)


def broyden_polish(xd, seed, seed_ok, voxel_J, offset, scale_kernel,
                   cvg_thresh=1e-5, dvg_thresh=1e-1,
                   max_iters=4) -> BroydenResult:
    """Warm-started Broyden (`anim/broyden.py:464-515` of the JAX package):
    one lane per point ``xd [M, 3]``, started at ``seed [M, 3]``; lanes with
    ``seed_ok [M]`` false, and lanes that do not converge within
    ``max_iters``, come back invalid with zero outputs.  Arguments as
    :func:`broyden_search`.  CPU tensors take the plain twin; CUDA tensors
    launch kernel KL."""
    if xd.device.type == "cpu":
        return broyden_polish_plain(xd, seed, seed_ok, voxel_J, offset,
                                    scale_kernel, cvg_thresh, dvg_thresh,
                                    max_iters)
    dev = xd.device
    M = xd.shape[0]
    D, H, W, _ = voxel_J.shape
    kernels.require(xd, "xd", torch.float32, dev, (M, 3))
    kernels.require(seed, "seed", torch.float32, dev, (M, 3))
    kernels.require(seed_ok, "seed_ok", torch.bool, dev, (M,))
    kernels.require(voxel_J, "voxel_J", torch.float32, dev, (D, H, W, 12))
    x = torch.empty((M, 3), dtype=torch.float32, device=dev)
    j_inv = torch.empty((M, 9), dtype=torch.float32, device=dev)
    valid = torch.empty((M,), dtype=torch.bool, device=dev)
    err = kernels.lib("broyden").broyden_polish_fwd(
        xd.data_ptr(), seed.data_ptr(), seed_ok.data_ptr(), voxel_J.data_ptr(),
        x.data_ptr(), j_inv.data_ptr(), valid.data_ptr(), M, D, H, W,
        int(max_iters), *(float(v) for v in offset),
        *(float(v) for v in scale_kernel), float(cvg_thresh) ** 2,
        float(dvg_thresh) ** 2, kernels.stream_ptr(dev))
    kernels.check(err, "broyden_polish")
    kernels.launches["broyden_polish"] += 1
    return BroydenResult(x=x, j_inv=j_inv, valid=valid)


def filter_duplicates(xc: torch.Tensor, valid: torch.Tensor,
                      thresh: float = 1e-4) -> torch.Tensor:
    """Drop converged candidates duplicated by a later one
    (`filter.cu:25-51`).  ``xc [N, I, 3]``, ``valid [N, I]``."""
    x, y, z = xc.unbind(-1)
    d2 = ((x[:, :, None] - x[:, None, :]) ** 2
          + (y[:, :, None] - y[:, None, :]) ** 2
          + (z[:, :, None] - z[:, None, :]) ** 2)
    I = xc.shape[1]
    ar = torch.arange(I, device=xc.device)
    later = ar[:, None] < ar[None, :]
    dup = torch.any(later[None] & valid[:, None, :] & (d2 < thresh * thresh),
                    dim=-1)
    return valid & ~dup


def forward_skinning(xc: torch.Tensor, weights: torch.Tensor,
                     tfs: torch.Tensor):
    """LBS: ``xc [M, 3]``, ``weights [M, 24]`` -> ``(xd [M, 3], rot [M, 9])``,
    the blended transform's rotation row-major (`deformer_torch.py:213-227`).
    """
    t = weights @ tfs[:, :3, :4].reshape(tfs.shape[0], 12)      # [M, 12]
    t = t.unbind(-1)
    x, y, z = xc.unbind(-1)
    xd = torch.stack([t[0] * x + t[1] * y + t[2] * z + t[3],
                      t[4] * x + t[5] * y + t[6] * z + t[7],
                      t[8] * x + t[9] * y + t[10] * z + t[11]], dim=-1)
    rot = torch.stack([t[0], t[1], t[2], t[4], t[5], t[6], t[8], t[9], t[10]],
                      dim=-1)
    return xd, rot


class EpilogueOut(NamedTuple):
    xc: torch.Tensor        # [N*K, 3] kept roots
    j_inv: torch.Tensor     # [N*K, 9] their J^-1
    valid: torch.Tensor     # [N*K] kept lane is a surviving root
    overflow: torch.Tensor  # () int64: survivors beyond K, summed
    fwd_rot: torch.Tensor | None  # [N*K, 9] blended rotation, row-major


def deform_epilogue_plain(res: BroydenResult, n_init: int, n_keep: int,
                          need_rot: bool, lbs_cl, spec, tfs, voxel_J,
                          thresh: float = 1e-4) -> EpilogueOut:
    """Plain twin of :func:`deform_epilogue` (``voxel_J`` unread: the twin
    blends ``lbs_cl``'s weights over ``tfs``)."""
    I, K = n_init, n_keep
    N = res.x.shape[0] // I
    valid = filter_duplicates(res.x.reshape(N, I, 3), res.valid.reshape(N, I),
                              thresh)
    overflow = torch.relu(valid.sum(-1, dtype=torch.int64) - K).sum()
    order = stable_partition_indices(valid)[:, :K]                # [N, K]
    lane = (torch.arange(N, device=res.x.device)[:, None] * I
            + order).reshape(-1)
    xc = res.x[lane]
    return EpilogueOut(
        xc=xc, j_inv=res.j_inv[lane], valid=valid.reshape(-1)[lane],
        overflow=overflow,
        fwd_rot=deform_skinning_plain(xc, lbs_cl, spec, tfs) if need_rot
        else None)


def deform_epilogue(res: BroydenResult, n_init: int, n_keep: int,
                    need_rot: bool, lbs_cl, spec, tfs, voxel_J,
                    thresh: float = 1e-4) -> EpilogueOut:
    """After the search over ``n_init`` lanes per point: drop each root
    within ``thresh`` of a later valid one (`filter.cu:25-51`), count the
    survivors beyond ``n_keep``, keep the first ``n_keep`` survivors in lane
    order (then the first lanes that did not survive), and with
    ``need_rot`` sample the LBS weights ``lbs_cl [D*H*W, 24]`` (border
    padding) at each kept root and blend the rotation of ``tfs [24, 4, 4]``
    (`deformer_torch.py:213-227`; :func:`deform_skinning`, whose kernel
    reads ``voxel_J``, the transform voxel of the same frame's ``lbs_cl``
    and ``tfs``).  ``spec`` is the voxel's
    :class:`~intrinsicavatar_tpu_torch.anim.lbs_voxel.VoxelSpec`.  Without
    ``need_rot``, ``lbs_cl``, ``spec``, ``tfs`` and ``voxel_J`` may be
    None."""
    if res.x.device.type == "cpu":
        return deform_epilogue_plain(res, n_init, n_keep, need_rot, lbs_cl,
                                     spec, tfs, voxel_J, thresh)
    dev = res.x.device
    I, K = n_init, n_keep
    M = res.x.shape[0]
    N = M // I
    if N * I != M or not 1 <= K <= I <= MAX_INIT:
        raise ValueError(f"{M} lanes, n_init {I}, n_keep {K}")
    kernels.require(res.x, "x", torch.float32, dev, (M, 3))
    kernels.require(res.j_inv, "j_inv", torch.float32, dev, (M, 9))
    kernels.require(res.valid, "valid", torch.bool, dev, (M,))
    xc = torch.empty((N * K, 3), dtype=torch.float32, device=dev)
    j_inv = torch.empty((N * K, 9), dtype=torch.float32, device=dev)
    valid = torch.empty((N * K,), dtype=torch.bool, device=dev)
    overflow = torch.zeros((), dtype=torch.int64, device=dev)
    err = kernels.lib("deform").deform_epilogue_fwd(
        res.x.data_ptr(), res.j_inv.data_ptr(), res.valid.data_ptr(), N, I,
        K, float(thresh) * float(thresh), xc.data_ptr(), j_inv.data_ptr(),
        valid.data_ptr(), overflow.data_ptr(), kernels.stream_ptr(dev))
    kernels.check(err, "deform_epilogue")
    kernels.launches["deform_epilogue"] += 1
    return EpilogueOut(
        xc=xc, j_inv=j_inv, valid=valid, overflow=overflow,
        fwd_rot=deform_skinning(xc, lbs_cl, spec, tfs, voxel_J) if need_rot
        else None)


def deform_skinning_plain(xc, lbs_cl, spec, tfs) -> torch.Tensor:
    """Plain twin of :func:`deform_skinning`: the 24 LBS weights sampled
    with border padding, then blended over ``tfs`` (JAX's `query_weights`
    + `forward_skinning`)."""
    weights = grid_sample_3d(lbs_cl, spec.shape_dhw, spec.normalize(xc),
                             padding="border")
    return forward_skinning(xc, weights, tfs)[1]


# the rotation channels of a [3, 4] transform voxel row (row-major)
ROT_CHANNELS = (0, 1, 2, 4, 5, 6, 8, 9, 10)


def deform_skinning_voxel_plain(xc, voxel_J, spec) -> torch.Tensor:
    """What KH skinning's kernel computes: the 9 rotation channels of the
    transform voxel ``voxel_J [D, H, W, 12]`` (``sum_b W_b tfs[b, :3,
    :4]``, as :meth:`FastSNARF.prepare` bakes it) sampled with border
    padding at ``xc [M, 3]`` (the kernel adds the two x sides of a cell's
    corners apart, then each other).  The trilinear sample is linear in the
    voxel, so this is :func:`deform_skinning_plain` with the sums in
    another order."""
    out = grid_sample_3d(voxel_J.reshape(-1, 12), spec.shape_dhw,
                         spec.normalize(xc), padding="border")
    return out[:, list(ROT_CHANNELS)]


def deform_skinning(xc, lbs_cl, spec, tfs, voxel_J) -> torch.Tensor:
    """Rotation rows ``[M, 9]`` of the LBS transform at canonical points
    ``xc [M, 3]``: the weights ``lbs_cl [D*H*W, 24]`` sampled with border
    padding (``spec`` normalizes), blended over ``tfs [24, 4, 4]``
    (`FastSNARF.query_weights` + `forward_skinning`).  Kernel KH's second
    stage; :func:`deform_epilogue` calls it when ``need_rot``.

    CPU tensors take the plain twin, which reads ``lbs_cl`` and ``tfs``.
    For CUDA tensors the kernel samples the frame's transform voxel
    ``voxel_J [D, H, W, 12]``, baked from the same weights and ``tfs``
    (:func:`deform_skinning_voxel_plain`): 8 corner rows of 48 B a lane
    where the weights take 8 of 96 B and a blend over 24 bones."""
    if xc.device.type == "cpu":
        return deform_skinning_plain(xc, lbs_cl, spec, tfs)
    dev = xc.device
    M = xc.shape[0]
    D, H, W = spec.shape_dhw
    kernels.require(xc, "xc", torch.float32, dev, (M, 3))
    kernels.require(voxel_J, "voxel_J", torch.float32, dev, (D, H, W, 12))
    if voxel_J.data_ptr() % 16:
        raise ValueError("voxel_J must be 16-byte aligned")
    rot = torch.empty((M, 9), dtype=torch.float32, device=dev)
    err = kernels.lib("deform").deform_skinning_fwd(
        xc.data_ptr(), voxel_J.data_ptr(), M, D, H, W,
        *(float(v) for v in spec.offset), float(spec.scale),
        float(spec.ratio), rot.data_ptr(), kernels.stream_ptr(dev))
    kernels.check(err, "deform_skinning")
    kernels.launches["deform_skinning"] += 1
    return rot


def skin_bwd_blocks(M: int) -> int:
    """KN's block count for ``M`` lanes: fixed for a given ``M``, so that
    its sums run in one order."""
    return max(1, min(-(-M // SKIN_BWD_TILE), SKIN_BWD_BLOCKS))


def deform_skinning_bwd_plain(xc, valid, jinv, g_xc, g_rot, lbs_cl,
                              spec) -> torch.Tensor:
    """Plain twin of :func:`deform_skinning_bwd`: autograd through
    :func:`forward_skinning` of the JAX correction (`anim/deformer.py:
    396-412` of the JAX package).  The function is linear in ``tfs``, so
    its cotangent does not depend on where it is taken."""
    with torch.enable_grad():
        tfs = torch.zeros((N_BONES, 4, 4), dtype=xc.dtype, device=xc.device,
                          requires_grad=True)
        weights = grid_sample_3d(lbs_cl, spec.shape_dhw, spec.normalize(xc),
                                 padding="border")
        xd, rot = forward_skinning(xc, weights, tfs)
        r = xd - xd.detach()
        vf = valid.to(xc.dtype)[:, None]
        corr = -vf * torch.einsum("mab,mb->ma", jinv.reshape(-1, 3, 3), r)
        loss = torch.sum(corr * g_xc)
        if g_rot is not None:
            loss = loss + torch.sum(rot * g_rot)
        (d_tfs,) = torch.autograd.grad(loss, tfs)
    return d_tfs


def deform_skinning_bwd(xc, valid, jinv, g_xc, g_rot, lbs_cl,
                        spec) -> torch.Tensor:
    """Cotangent ``d_tfs [24, 4, 4]`` of the train-mode correction
    ``x_c - v J^-1 (x_d(x_c, tfs) - sg(x_d))`` and of the blended rotation
    rows (:func:`deform_skinning`) at the detached roots ``xc [M, 3]``, for
    the cotangents ``g_xc [M, 3]`` of the corrected roots and ``g_rot [M,
    9]`` (or None) of the rotation; ``valid [M]``, ``jinv [M, 9]``
    row-major, ``lbs_cl`` and ``spec`` as :func:`deform_skinning`.  Kernel
    KN (``csrc/deform.cu``) for CUDA tensors, its plain twin for CPU
    tensors."""
    if xc.device.type == "cpu":
        return deform_skinning_bwd_plain(xc, valid, jinv, g_xc, g_rot,
                                         lbs_cl, spec)
    dev = xc.device
    M = xc.shape[0]
    D, H, W = spec.shape_dhw
    kernels.require(xc, "xc", torch.float32, dev, (M, 3))
    kernels.require(valid, "valid", torch.bool, dev, (M,))
    kernels.require(jinv, "jinv", torch.float32, dev, (M, 9))
    kernels.require(g_xc, "g_xc", torch.float32, dev, (M, 3))
    if g_rot is not None:
        kernels.require(g_rot, "g_rot", torch.float32, dev, (M, 9))
    kernels.require(lbs_cl, "lbs_cl", torch.float32, dev,
                    (D * H * W, N_BONES))
    if lbs_cl.data_ptr() % 16:
        raise ValueError("lbs_cl must be 16-byte aligned")
    # the kernel copies the lanes' validity and rotation cotangents in
    # 16-byte words: a view that does not start 16-byte aligned is copied
    if valid.data_ptr() % 16:
        valid = valid.clone()
    if g_rot is not None and g_rot.data_ptr() % 16:
        g_rot = g_rot.clone()
    G = skin_bwd_blocks(M)
    # each block's sums, added by the last block to finish (one launch)
    partial = torch.empty((G, N_BONES * 12), dtype=torch.float32,
                          device=dev)
    d_tfs = torch.empty((N_BONES, 4, 4), dtype=torch.float32, device=dev)
    err = kernels.lib("deform").deform_skinning_bwd(
        xc.data_ptr(), valid.data_ptr(), jinv.data_ptr(), g_xc.data_ptr(),
        g_rot.data_ptr() if g_rot is not None else None, lbs_cl.data_ptr(),
        M, D, H, W, *(float(v) for v in spec.offset), float(spec.scale),
        float(spec.ratio), partial.data_ptr(), G, d_tfs.data_ptr(),
        kernels.stream_ptr(dev))
    kernels.check(err, "deform_skinning_bwd")
    kernels.launches["deform_skinning_bwd"] += 1
    return d_tfs


def skin_bwd_adds(valid, g_rot) -> torch.Tensor:
    """``[M]`` bool: the lanes that KN adds.  A lane that is not valid and
    has no rotation cotangent has ``U = 0`` (its ``rho`` is ``v`` times a
    product), and KN skips it."""
    adds = valid.clone()
    if g_rot is not None:
        adds |= (g_rot != 0).any(-1)
    return adds


def skin_bwd_terms(xc, valid, jinv, g_xc, g_rot, lbs_cl, spec):
    """``(W [M, 24], U [M, 12], |U| bound [M, 12])`` of KN's function in
    float64: the weights are the float32 sample that KN takes (the twin's
    blend, each coordinate divided by the scale as the kernel divides it);
    ``Uabs = |J^-1|^T |g| |x^| + |R|`` bounds the magnitudes that KN's
    float32 U rounds; U and Uabs are 0 at the lanes KN skips
    (:func:`skin_bwd_adds`)."""
    M, f64 = xc.shape[0], torch.float64
    off = torch.as_tensor(np.asarray(spec.offset, np.float32),
                          device=xc.device)
    coords = (xc - off) / torch.full_like(xc, float(spec.scale))
    coords = coords * torch.tensor([1.0, 1.0, spec.ratio],
                                   dtype=torch.float32, device=xc.device)
    W = grid_sample_3d(lbs_cl, spec.shape_dhw, coords,
                       padding="border").to(f64)
    J = jinv.to(f64).reshape(M, 3, 3)
    g = g_xc.to(f64)
    v = valid.to(f64)[:, None]
    xh = torch.cat([xc.to(f64), torch.ones((M, 1), dtype=f64,
                                           device=xc.device)], -1)
    U = (-v * torch.einsum("mba,mb->ma", J, g))[:, :, None] \
        * xh[:, None, :]
    Uabs = (v * torch.einsum("mba,mb->ma", J.abs(), g.abs()))[:, :, None] \
        * xh.abs()[:, None, :]
    if g_rot is not None:
        R = g_rot.to(f64).reshape(M, 3, 3)
        U[:, :, :3] += R
        Uabs[:, :, :3] += R.abs()
    adds = skin_bwd_adds(valid, g_rot)[:, None]
    U = torch.where(adds, U.reshape(M, 12), 0.0)
    Uabs = torch.where(adds, Uabs.reshape(M, 12), 0.0)
    return W, U, Uabs


def deform_skinning_bwd_exact(xc, valid, jinv, g_xc, g_rot, lbs_cl, spec):
    """KN's function summed in float64, and each entry's bound on KN's
    float32 rounding: ``(d_tfs [24, 4, 4], limit [24, 4, 4])``, float64.

    KN rounds each term ``w U`` (its U within 5 eps of ``Uabs``, its
    weights a float32 sample) and sums the terms in a fixed order: tile
    ``t`` of ``SKIN_BWD_TILE`` lanes goes to block ``t mod G``
    (:func:`skin_bwd_blocks`); within a tile the lanes that KN adds
    (:func:`skin_bwd_adds`) are numbered in lane order, number ``n`` goes
    to slice ``n mod SKIN_BWD_SLICES``, and each (block, slice) keeps one
    running sum over its numbers, tile by tile; a block then adds its
    slices in order, and the block sums are added in block order.  A
    recursive sum rounds by at most eps times the sum of its running sums'
    magnitudes (Higham, *Accuracy and Stability of Numerical Algorithms*,
    section 4.2; a fused multiply-add rounds its sum once), so

        limit = eps (1.01 sum_k |S_k| + 32 sum_m |w_m| Uabs_m)

    over KN's running sums ``S_k`` of the three levels (1.01: the computed
    running sums for the exact ones); 32 eps per term also covers a weight
    that differs from the twin's by rounding (KN adds each weight's 8
    corners in the twin's order, with fused multiply-adds)."""
    W, U, Uabs = skin_bwd_terms(xc, valid, jinv, g_xc, g_rot, lbs_cl, spec)
    adds = skin_bwd_adds(valid, g_rot)
    M, E = xc.shape[0], N_BONES * 12
    T, S, G = SKIN_BWD_TILE, SKIN_BWD_SLICES, skin_bwd_blocks(M)
    dev, f64 = xc.device, torch.float64
    run = torch.zeros((G, S, E), dtype=f64, device=dev)
    run_abs = torch.zeros(E, dtype=f64, device=dev)
    for lo in range(0, M, G * T):
        # one tile a block: lane g T + p of this round is lane p of block
        # g's tile; its adding lanes go to their numbers n, in slice n mod S
        n = min(G * T, M - lo)
        a = torch.zeros(G * T, dtype=torch.bool, device=dev)
        a[:n] = adds[lo:lo + n]
        a = a.reshape(G, T)
        dest = (torch.arange(G, device=dev)[:, None] * T
                + a.cumsum(1) - 1)[a]
        sel = adds[lo:lo + n]
        terms = torch.zeros((G * T, E), dtype=f64, device=dev)
        terms[dest] = (W[lo:lo + n][sel, :, None]
                       * U[lo:lo + n][sel, None, :]).reshape(-1, E)
        chain = run[:, None] + terms.reshape(G, T // S, S, E).cumsum(1)
        # the numbers past a tile's adding lanes add nothing and round
        # nothing
        filled = torch.zeros(G * T, dtype=torch.bool, device=dev)
        filled[dest] = True
        run_abs += (chain.abs() * filled.reshape(G, T // S, S, 1)
                    ).sum((0, 1, 2))
        run = chain[:, -1]
    blocks = run.cumsum(1)                      # each block's slices
    run_abs += blocks.abs().sum((0, 1))
    run_abs += blocks[:, -1].cumsum(0).abs().sum(0)
    mag = (W.abs().t() @ Uabs).reshape(E)
    limit = 2.0 ** -24 * (1.01 * run_abs + 32.0 * mag)
    d_tfs = torch.zeros((N_BONES, 4, 4), dtype=f64, device=dev)
    d_tfs[:, :3] = (W.t() @ U).reshape(N_BONES, 3, 4)
    lim = torch.zeros_like(d_tfs)
    lim[:, :3] = limit.reshape(N_BONES, 3, 4)
    return d_tfs, lim


def deform_skinning_bwd_faults(xc, valid, jinv, g_xc, g_rot, lbs_cl, spec,
                               out, limit):
    """Wrong answers that a check of KN against
    :func:`deform_skinning_bwd_exact` must refuse, by name: all zeros, bone
    0 alone, KN without its position term, without its rotation term (when
    it has a nonzero one), and without the tile of ``SKIN_BWD_TILE`` lanes
    (KN's unit of work: a block stages, samples and adds one tile at a
    time) that moves an entry most against its ``limit``."""
    M, T = xc.shape[0], SKIN_BWD_TILE
    args = (xc, valid, jinv, g_xc, g_rot, lbs_cl, spec)
    faults = {"zeros": torch.zeros_like(out),
              "bone 0 alone": torch.cat([out[:1],
                                         torch.zeros_like(out[1:])])}
    faults["no position term"] = deform_skinning_bwd(
        xc, valid, jinv, torch.zeros_like(g_xc), g_rot, lbs_cl, spec)
    if g_rot is not None and bool(g_rot.any()):
        faults["no rotation term"] = deform_skinning_bwd(
            xc, valid, jinv, g_xc, None, lbs_cl, spec)
    W, U, _ = skin_bwd_terms(*args)
    n_tiles = -(-M // T)
    pad = n_tiles * T - M
    Wt = torch.nn.functional.pad(W, (0, 0, 0, pad)).reshape(n_tiles, T, -1)
    Ut = torch.nn.functional.pad(U, (0, 0, 0, pad)).reshape(n_tiles, T, -1)
    per_tile = (Wt.transpose(1, 2) @ Ut).reshape(n_tiles, -1)
    lim = limit[:, :3].reshape(-1).clamp(min=1e-300)
    tile = int((per_tile.abs() / lim).amax(1).argmax())
    keep = torch.ones(M, dtype=torch.bool, device=xc.device)
    keep[tile * T:(tile + 1) * T] = False
    faults[f"tile {tile} dropped"] = deform_skinning_bwd(
        *(a[keep] if a is not None else None for a in args[:5]), lbs_cl,
        spec)
    return faults


def deform_skinning_bwd_refused(out, exact, limit) -> bool:
    """Whether ``out`` is refused: an entry of rows 0-2 off ``exact`` by
    more than ``limit``, or row 3 not zero."""
    err = (out.to(torch.float64) - exact)[:, :3].abs()
    return bool((err > limit[:, :3]).any()) or bool(out[:, 3].any())
