"""Per-frame baked correspondence grid for eval-time inverse skinning
(counterpart of the JAX package's ``anim/seedgrid.py``).

At eval the pose is fixed for a frame, so the inverse skinning x_d -> x_c is
a fixed field.  :func:`bake_seed_grid` runs the ordinary searched
canonicalization once per frame over a lattice spanning the deformed-space
bbox, dilates its validity twice, and keeps the roots (and the canonical
SDF) per node.  Every eval query then reads its seed from the 8 corners of
its cell (:func:`gather_from_grid`, kernel KM on the card) and is polished
by the seeded Broyden lane (kernel KL) instead of the multi-init search;
placement-only passes read the SDF from the same gather.

Each cell is classified from its 8 corner roots: when the valid corners
agree to within ``coh_factor`` cell diagonals their validity-masked
trilinear blend is the seed, else the nearest valid corner's root (a blend
across a root-branch boundary would be no root at all).

The grid is channel-last, ``[res, res, res, C]`` indexed ``(z, y, x)``,
a view of 32-byte node records (:func:`node_records`: the C channels
zero-padded to 8 floats, so KM reads a corner in one or two vector loads
within one 32 B sector).  The JAX package's corner packing (8 copies of
each node, one gather row per cell) is a TPU layout and is not copied.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from intrinsicavatar_tpu_torch import kernels

RECORD = 8  # floats a node record: the channels, then zeros


def node_records(channels: torch.Tensor) -> torch.Tensor:
    """``channels [res, res, res, C]`` as a view of 32-byte node records:
    the same values, stored ``[res, res, res, 8]`` with zeros after the C
    channels, the layout kernel KM reads."""
    *lead, C = channels.shape
    rec = channels.new_zeros((*lead, RECORD))
    rec[..., :C] = channels
    return rec[..., :C]


def is_node_records(t: torch.Tensor) -> bool:
    """Whether ``t [res, res, res, C]`` is a view of :func:`node_records`
    (8-float records, channel 0 first, 16 B aligned).  KM reads channels
    0..C-1 of each record only, all inside the view's own extent."""
    res = t.shape[0]
    return t.dim() == 4 and t.shape[1] == t.shape[2] == res \
        and t.stride() == (res * res * RECORD, res * RECORD, RECORD, 1) \
        and t.data_ptr() % 16 == 0


class SeedGrid(NamedTuple):
    """Correspondence lattice over the deformed-space bbox.

    ``grid[z, y, x]`` holds ``(x_c*ok, y_c*ok, z_c*ok, ok)`` and, when baked
    with an SDF channel (C == 6), ``(sdf*sdf_ok, sdf_ok)``.  ``sdf_ok`` is
    the search's validity before dilation: adopted margin nodes give seeds
    but never an SDF.  ``center`` / ``half`` map SMPL-space points into the
    lattice's [-1, 1]^3 frame per axis.  ``grid`` is a view of
    :func:`node_records`.
    """

    grid: torch.Tensor     # [res, res, res, C], C in (4, 6), 8-float records
    center: torch.Tensor   # [3]
    half: torch.Tensor     # [3]

    @property
    def resolution(self) -> int:
        return int(self.grid.shape[0])

    @property
    def channels(self) -> int:
        return int(self.grid.shape[-1])

    @property
    def has_sdf(self) -> bool:
        return self.channels >= 5

    def to(self, device) -> "SeedGrid":
        """The grid on ``device``, its nodes in 8-float records there."""
        grid = self.grid
        if grid.device != torch.device(device):
            grid = node_records(grid.to(device))
        return SeedGrid(grid, self.center.to(device), self.half.to(device))


def lattice_points(aabb: torch.Tensor, resolution: int) -> torch.Tensor:
    """``[res^3, 3]`` align-corners lattice over ``aabb [2, 3]``, flat index
    ``(z * res + y) * res + x``.  ``i / (res - 1)`` in float32 is what
    ``jnp.linspace(0, 1, res)`` computes, so both packages place the nodes
    alike; it is divided on the host (a CUDA tensor divided by a scalar is
    multiplied by its reciprocal)."""
    lo, hi = aabb[0], aabb[1]
    lin = torch.as_tensor(np.arange(resolution, dtype=np.float32)
                          / np.float32(max(resolution - 1, 1)),
                          device=aabb.device)
    zz, yy, xx = torch.meshgrid(lin, lin, lin, indexing="ij")
    norm01 = torch.stack([xx, yy, zz], -1).reshape(-1, 3)
    return lo + norm01 * (hi - lo)


def _shift0(a: torch.Tensor, shift: int, axis: int) -> torch.Tensor:
    """Shifted copy along ``axis`` with a zero fill (no wrap-around)."""
    n = a.shape[axis]
    z = torch.zeros_like(a.narrow(axis, 0, 1))
    if shift > 0:
        return torch.cat([z, a.narrow(axis, 0, n - 1)], axis)
    return torch.cat([a.narrow(axis, 1, n - 1), z], axis)


def pack_seed_grid(xc, ok, sdf, aabb, resolution: int) -> SeedGrid:
    """The searched lattice outputs ``xc [res^3, 3]``, ``ok [res^3]`` and
    ``sdf [res^3]`` (or None) -> :class:`SeedGrid`.

    Two dilation passes: a failed node with a valid 6-neighbour adopts their
    mean root (zero-fill shifts, summed in axis order z, y, x, +1 shift
    first), so the margin of the body hands out seeds and the polish decides
    validity there.  The SDF channel keeps the pre-dilation mask."""
    res = resolution
    has_sdf = sdf is not None
    sdf_ = sdf if has_sdf else torch.zeros_like(ok, dtype=xc.dtype)
    xg = torch.cat([xc, sdf_[:, None]], -1).reshape(res, res, res, 4)
    og = ok.reshape(res, res, res)
    for _ in range(2):
        ogf = og.to(xg.dtype)[..., None]
        xm = xg * ogf
        acc = torch.zeros_like(xg)
        cnt = torch.zeros_like(ogf)
        for axis in (0, 1, 2):
            for shift in (1, -1):
                acc = acc + _shift0(xm, shift, axis)
                cnt = cnt + _shift0(ogf, shift, axis)
        fill = acc / torch.clamp(cnt, min=1.0)
        adopt = ~og & (cnt[..., 0] > 0.5)
        xg = torch.where(adopt[..., None], fill, xg)
        og = og | adopt
    xd = xg.reshape(-1, 4)[:, :3]
    okf = og.reshape(-1).to(xc.dtype)
    chans = [xd[:, 0] * okf, xd[:, 1] * okf, xd[:, 2] * okf, okf]
    if has_sdf:
        okf0 = ok.to(xc.dtype)
        chans += [sdf * okf0, okf0]
    lo, hi = aabb[0], aabb[1]
    return SeedGrid(grid=node_records(torch.stack(chans, -1)
                                      .reshape(res, res, res, -1)),
                    center=0.5 * (lo + hi),
                    half=torch.clamp(0.5 * (hi - lo), min=1e-6))


@torch.no_grad()
def bake_seed_grid(deform_fn: Callable, aabb: torch.Tensor, resolution: int,
                   chunk: int = 65536) -> SeedGrid:
    """Run the searched canonicalization over the lattice and pack it.

    ``deform_fn(pts [n, 3]) -> (xc [n, 3], valid [n])`` or ``-> (xc, valid,
    sdf [n])``; the third output bakes the SDF channel.  The lattice runs in
    ``chunk``-point pieces, the last one padded with points at the origin
    as the JAX bake pads it (a chunk's candidate budget counts them)."""
    pts = lattice_points(aabb, resolution)
    N = pts.shape[0]
    pad = -N % chunk
    if pad:
        pts = torch.cat([pts, pts.new_zeros((pad, 3))])
    outs = [deform_fn(pts[i:i + chunk]) for i in range(0, N + pad, chunk)]
    xc = torch.cat([o[0] for o in outs])[:N]
    ok = torch.cat([o[1] for o in outs])[:N]
    sdf = torch.cat([o[2] for o in outs])[:N] if len(outs[0]) > 2 else None
    return pack_seed_grid(xc, ok, sdf, aabb, resolution)


def _corner_setup(n: torch.Tensor, res: int):
    """Base node ``[N, 3]`` (x, y, z) and fractions ``[N, 3]`` of the
    align-corners "border" sampler (`anim/broyden.py:44-61` of the JAX
    package): ``((c + 1) * 0.5) * (res - 1)`` clipped to the lattice."""
    i = torch.clamp((n + 1.0) * 0.5 * (res - 1), 0.0, res - 1.0)
    i0 = torch.floor(i)
    return i0.long(), i - i0


def _sum8(t: torch.Tensor) -> torch.Tensor:
    """Sum over dim 1 in corner order, as the kernel sums."""
    s = t[:, 0]
    for k in range(1, t.shape[1]):
        s = s + t[:, k]
    return s


def gather_from_grid_plain(grid: SeedGrid, pts: torch.Tensor,
                           coh_factor: float = 3.0):
    """Plain twin of :func:`gather_from_grid`: the JAX op's arithmetic,
    with every sum over the corners taken in corner order as KM takes it."""
    res = grid.resolution
    C = grid.channels
    N = pts.shape[0]
    n = (pts - grid.center) / grid.half
    inside = (torch.abs(n) <= 1.0 + 1.0 / max(res - 1, 1)).all(-1)
    i0, f = _corner_setup(n, res)
    flat = grid.grid.reshape(-1, C)
    ws, rows = [], []
    for dx in (0, 1):
        wx = f[:, 0] if dx else 1.0 - f[:, 0]
        x = torch.clamp(i0[:, 0] + dx, max=res - 1)
        for dy in (0, 1):
            wy = f[:, 1] if dy else 1.0 - f[:, 1]
            y = torch.clamp(i0[:, 1] + dy, max=res - 1)
            for dz in (0, 1):
                wz = f[:, 2] if dz else 1.0 - f[:, 2]
                z = torch.clamp(i0[:, 2] + dz, max=res - 1)
                ws.append(wx * wy * wz)
                rows.append(flat[(z * res + y) * res + x])
    w = torch.stack(ws, 1)                                    # [N, 8]
    rows = torch.stack(rows, 1)                               # [N, 8, C]
    ok_c = rows[:, :, 3] > 0.5
    okf = ok_c.to(rows.dtype)
    xc_c = rows[:, :, :3]                                     # pre-masked
    wok = w * okf
    trilerp = _sum8(wok[:, :, None] * xc_c) \
        / torch.clamp(_sum8(wok), min=1e-9)[:, None]
    mean = _sum8(xc_c) / torch.clamp(_sum8(okf), min=1.0)[:, None]
    d = (xc_c - mean[:, None, :]) ** 2
    dev2 = ((d[..., 0] + d[..., 1] + d[..., 2]) * okf).max(1).values
    # a tensor divisor: a CUDA tensor divided by a scalar is multiplied by
    # its reciprocal, where the kernel divides
    e = (2.0 * grid.half / torch.full_like(grid.half, max(res - 1, 1))) ** 2
    coherent = dev2 <= (coh_factor * coh_factor) * (e[0] + e[1] + e[2])
    ar = torch.arange(N, device=pts.device)
    nearest = torch.argmax(wok + okf * 1e-6, 1)
    seed_xc = torch.where(coherent[:, None], trilerp, xc_c[ar, nearest])
    seed_ok = ok_c.any(1) & inside
    sdf = None
    if grid.has_sdf:
        sdf_c = rows[:, :, 4]
        sok_c = rows[:, :, 5] > 0.5
        sokf = sok_c.to(rows.dtype)
        wsok = w * sokf
        sdf_tri = _sum8(wsok * sdf_c) / torch.clamp(_sum8(wsok), min=1e-9)
        near_s = torch.argmax(wsok + sokf * 1e-6, 1)
        sdf = torch.where(coherent, sdf_tri, sdf_c[ar, near_s])
        sdf = torch.where(sok_c.any(1) & inside, sdf, 1e5)
    return seed_xc, seed_ok, sdf


def gather_from_grid(grid: SeedGrid, pts: torch.Tensor,
                     coh_factor: float = 3.0):
    """Seeds (and the baked SDF) of ``pts [N, 3]`` from their cells' 8
    corners.  Returns ``(seed_xc [N, 3], seed_ok [N], sdf [N] | None)``.

    Coherent cells (valid corner roots within ``coh_factor`` cell diagonals
    of their mean) get the validity-masked trilinear blend, the others the
    nearest valid corner's root (the largest trilinear weight, first corner
    on ties).  A cell with no valid corner, or a point beyond the lattice by
    more than half a cell, gives ``seed_ok = False``.  The SDF takes the
    same choice under its own validity and is 1e5 where no corner is
    SDF-valid or the point is outside.  Kernel KM for CUDA tensors, the
    plain twin for CPU ones."""
    if pts.device.type == "cpu":
        return gather_from_grid_plain(grid, pts, coh_factor)
    g, center, half = grid
    dev = pts.device
    res, C, N = g.shape[0], g.shape[-1], pts.shape[0]
    # the checks in as few tensor calls as will do: at this size the
    # wrapper's host time is as long as the kernel's time on the card
    if not (C in (4, 6) and is_node_records(g) and pts.shape == (N, 3)
            and center.shape == half.shape == (3,) and pts.is_contiguous()
            and center.is_contiguous() and half.is_contiguous()
            and all(t.device == dev and t.dtype == torch.float32
                    for t in (pts, g, center, half))):
        raise ValueError(
            f"KM takes float32 pts [N, 3], contiguous center and half [3] "
            f"and a grid of 4 or 6 channels in node records "
            f"(node_records), all on {dev}; got pts {pts.dtype} "
            f"{tuple(pts.shape)} on {pts.device}, grid {g.dtype} "
            f"{tuple(g.shape)} strides {g.stride()} on {g.device}, center "
            f"{tuple(center.shape)} on {center.device}, half "
            f"{tuple(half.shape)} on {half.device}")
    # new_empty: the cheapest allocation for the host
    seed_xc = pts.new_empty((N, 3))
    seed_ok = pts.new_empty((N,), dtype=torch.bool)
    sdf = pts.new_empty((N,)) if C == 6 else None
    # ctypes rounds the two floats to float32 as the twin's scalars round
    err = kernels.lib("seedgrid").seed_gather_fwd(
        pts.data_ptr(), g.data_ptr(), center.data_ptr(), half.data_ptr(), N,
        res, C, 1.0 + 1.0 / max(res - 1, 1), coh_factor * coh_factor,
        seed_xc.data_ptr(), seed_ok.data_ptr(),
        None if sdf is None else sdf.data_ptr(), kernels.stream_ptr(dev))
    kernels.check(err, "seed_gather")
    kernels.launches["seed_gather"] += 1
    return seed_xc, seed_ok, sdf


def seed_from_grid(grid: SeedGrid, pts: torch.Tensor,
                   coh_factor: float = 3.0):
    """``(seed_xc, seed_ok)`` view of :func:`gather_from_grid`."""
    xc, ok, _ = gather_from_grid(grid, pts, coh_factor=coh_factor)
    return xc, ok
