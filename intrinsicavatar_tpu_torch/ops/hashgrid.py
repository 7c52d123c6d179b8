"""Multi-level hash-grid encoding (Instant-NGP style), forward and backward.

Counterpart of the JAX package's ``ops/hashgrid.py``.  :func:`hashgrid_encode`
is differentiable in the table and the points (the JAX custom VJP,
``ops/hashgrid.py:173-188``).  For CUDA tensors its forward launches kernel
KA and its backward kernel KA' (both ``csrc/hashgrid.cu``); CPU tensors take
the plain twins :func:`hashgrid_encode_plain` and
:func:`hashgrid_encode_bwd_plain`.

Inside a bf16 compute scope (``ops/precision.py``) the forward gathers bf16
rows of the table rounded once per version (KA's bf16-row form, or the twin
on the rounded table); the blend and the output stay float32, and the
backward stays float32 on the float32 table, as the JAX custom VJP's
backward runs outside the scope.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from intrinsicavatar_tpu_torch import kernels
from intrinsicavatar_tpu_torch.ops import precision

# tcnn's spatial hash primes (instant-ngp, Mueller et al. 2022)
_PRIMES = (1, 2654435761, 805459861)


@dataclasses.dataclass(frozen=True)
class HashGridSpec:
    """Static geometry of a multi-level hash grid."""

    n_levels: int = 16
    n_features_per_level: int = 2
    log2_hashmap_size: int = 19
    base_resolution: int = 16
    per_level_scale: float = 1.447269237440378
    include_xyz: bool = False
    xyz_scale: float = 2.0
    xyz_offset: float = -1.0

    @property
    def table_size(self) -> int:
        return 1 << self.log2_hashmap_size

    @property
    def scales(self) -> np.ndarray:
        # tcnn grid_scale: 2^(l * log2(growth)) * base - 1
        l = np.arange(self.n_levels)
        return np.exp2(l * np.log2(self.per_level_scale)) \
            * self.base_resolution - 1.0

    @property
    def resolutions(self) -> np.ndarray:
        return np.ceil(self.scales).astype(np.int32) + 1

    @property
    def dense_levels(self) -> np.ndarray:
        """Levels small enough to index densely instead of hashing."""
        return (self.resolutions.astype(np.int64) ** 3) <= self.table_size

    @property
    def n_output_dims(self) -> int:
        d = self.n_levels * self.n_features_per_level
        if self.include_xyz:
            d += 3
        return d



@functools.lru_cache(maxsize=None)
def level_tensors(spec: HashGridSpec, device: torch.device):
    """``(scales f32 [L], resolutions i32 [L])`` on ``device``, made once."""
    return (torch.as_tensor(spec.scales.astype(np.float32), device=device),
            torch.as_tensor(spec.resolutions, device=device))


def init_hashgrid(spec: HashGridSpec, generator: torch.Generator,
                  device=None) -> torch.Tensor:
    """Hash table ``[n_levels, table_size, F]``, U(-1e-4, 1e-4)."""
    shape = (spec.n_levels, spec.table_size, spec.n_features_per_level)
    u = torch.rand(shape, generator=generator, dtype=torch.float32)
    return (u * 2e-4 - 1e-4).to(device)


def level_coords(xc: torch.Tensor, scale: float):
    """Per-level corner setup for one coordinate: ``(c0 int64, frac)``."""
    p = xc * float(np.float32(scale)) + 0.5
    c0 = torch.floor(p)
    return c0.to(torch.int64), p - c0


def corner_rows(c0, r: int, dense: bool, T: int):
    """``[N, 8]`` table rows of the 8 corners, corner ``k = dx*4+dy*2+dz``.

    Dense levels clamp the cell to ``[0, r-1]`` and the +1 corner to
    ``r-1`` (the border shift of the reference's corner packing); hashed
    levels clamp each corner, then hash in uint32 arithmetic (computed in
    int64 and masked: the low bits of the products and xors agree)."""
    x0, y0, z0 = c0
    rows = []
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                if dense:
                    x = torch.clamp(torch.clamp(x0, 0, r - 1) + dx, max=r - 1)
                    y = torch.clamp(torch.clamp(y0, 0, r - 1) + dy, max=r - 1)
                    z = torch.clamp(torch.clamp(z0, 0, r - 1) + dz, max=r - 1)
                    rows.append((z * r + y) * r + x)
                else:
                    x = torch.clamp(x0 + dx, 0, r - 1)
                    y = torch.clamp(y0 + dy, 0, r - 1)
                    z = torch.clamp(z0 + dz, 0, r - 1)
                    h = (x * _PRIMES[0]) ^ (y * _PRIMES[1]) ^ (z * _PRIMES[2])
                    rows.append(h & (T - 1))
    return torch.stack(rows, dim=-1)


def corner_weights(f):
    """``[N, 8]`` trilinear corner weights in corner order (dz fastest)."""
    fx, fy, fz = f
    ws = []
    for dx in (0, 1):
        wx = fx if dx else 1.0 - fx
        for dy in (0, 1):
            wy = fy if dy else 1.0 - fy
            for dz in (0, 1):
                wz = fz if dz else 1.0 - fz
                ws.append(wx * wy * wz)
    return torch.stack(ws, dim=-1)


def hashgrid_encode_plain(table, x, spec: HashGridSpec, level_mask=None):
    """Plain PyTorch twin of kernel KA (the JAX ``hashgrid_encode_raw``); a
    bf16 table gives its bf16-row form (rows widened to float32 before the
    blend, as JAX promotes them)."""
    L, T, F = table.shape
    outs = []
    for lvl in range(L):
        s = float(spec.scales[lvl])
        r = int(spec.resolutions[lvl])
        c0, f = zip(*(level_coords(x[:, a], s) for a in range(3)))
        rows = corner_rows(c0, r, bool(spec.dense_levels[lvl]), T)
        w = corner_weights(f)
        feats = table[lvl][rows].to(x.dtype)            # [N, 8, F]
        acc = torch.zeros((x.shape[0], F), dtype=x.dtype, device=x.device)
        for k in range(8):
            acc = acc + feats[:, k] * w[:, k, None]
        outs.append(acc)
    out = torch.cat(outs, dim=-1)
    if level_mask is not None:
        out = out * level_mask[None, :]
    if spec.include_xyz:
        out = torch.cat([x * spec.xyz_scale + spec.xyz_offset, out], -1)
    return out


def corner_weight_grads(f):
    """``[N, 8]`` x 3: d w_k / d pos along x, y and z (corner order as
    :func:`corner_weights`)."""
    fx, fy, fz = f
    gx, gy, gz = [], [], []
    for dx in (0, 1):
        wx, sx = (fx, 1.0) if dx else (1.0 - fx, -1.0)
        for dy in (0, 1):
            wy, sy = (fy, 1.0) if dy else (1.0 - fy, -1.0)
            for dz in (0, 1):
                wz, sz = (fz, 1.0) if dz else (1.0 - fz, -1.0)
                gx.append(sx * wy * wz)
                gy.append(wx * sy * wz)
                gz.append(wx * wy * sz)
    return [torch.stack(g, dim=-1) for g in (gx, gy, gz)]


def hashgrid_encode_bwd_plain(table, x, spec: HashGridSpec, g,
                              level_mask=None, need_x: bool = True):
    """Plain twin of kernel KA': ``(d_table, d_x)`` for the output cotangent
    ``g [N, n_output_dims]`` (``d_x`` is None unless ``need_x``).

    The table cotangent adds ``w_k * g`` into each corner's row with
    ``index_add_`` (the JAX ``encode_table_grad``, ``ops/encode_grad.py:
    350-392``); the point pullback is ``hashgrid_encode_vjp_x``
    (``ops/hashgrid.py:263-346``).  The level mask multiplies ``g`` first."""
    N = x.shape[0]
    L, T, F = table.shape
    gl = g[:, 3:] if spec.include_xyz else g
    if level_mask is not None:
        gl = gl * level_mask[None, :]
    gl = gl.reshape(N, L, F)
    d_table = torch.zeros_like(table)
    d_x = torch.zeros_like(x) if need_x else None
    for lvl in range(L):
        s = float(spec.scales[lvl])
        r = int(spec.resolutions[lvl])
        c0, f = zip(*(level_coords(x[:, a], s) for a in range(3)))
        rows = corner_rows(c0, r, bool(spec.dense_levels[lvl]), T)
        w = corner_weights(f)
        d_table[lvl].index_add_(0, rows.reshape(-1),
                                (w[:, :, None] * gl[:, lvl, None, :])
                                .reshape(-1, F))
        if need_x:
            fg = torch.einsum("nkf,nf->nk", table[lvl][rows], gl[:, lvl])
            d_x = d_x + s * torch.stack(
                [torch.sum(fg * dw, -1) for dw in corner_weight_grads(f)], -1)
    if need_x and spec.include_xyz:
        d_x = d_x + g[:, :3] * spec.xyz_scale
    return d_table, d_x


def _check(table, x, spec: HashGridSpec, level_mask,
           table_dtype=torch.float32):
    """Shape, dtype, device and layout checks before a launch; returns
    ``(device, N, L, T, F)``."""
    dev = x.device
    L, T, F = table.shape
    N = x.shape[0]
    if (L, T, F) != (spec.n_levels, spec.table_size,
                     spec.n_features_per_level) or F > 4:
        raise ValueError(f"table shape {tuple(table.shape)} does not match "
                         f"the spec (or F > 4)")
    kernels.require(table, "table", table_dtype, dev, (L, T, F))
    kernels.require(x, "x", torch.float32, dev, (N, 3))
    if level_mask is not None:
        kernels.require(level_mask, "level_mask", torch.float32, dev, (L * F,))
    return dev, N, L, T, F


def _launch_fwd(table, x, spec: HashGridSpec, level_mask):
    """KA, or its bf16-row form ``hashgrid_encode_bf16`` for a bf16 table."""
    low = table.dtype == torch.bfloat16
    dev, N, L, T, F = _check(table, x, spec, level_mask,
                             torch.bfloat16 if low else torch.float32)
    scales, res = level_tensors(spec, dev)
    out = torch.empty((N, spec.n_output_dims), dtype=torch.float32,
                      device=dev)
    fn = "hashgrid_encode_fwd_bf16" if low else "hashgrid_encode_fwd"
    err = getattr(kernels.lib("hashgrid"), fn)(
        table.data_ptr(), x.data_ptr(), scales.data_ptr(), res.data_ptr(),
        level_mask.data_ptr() if level_mask is not None else None,
        out.data_ptr(), N, L, T, F, int(spec.include_xyz),
        float(spec.xyz_scale), float(spec.xyz_offset),
        kernels.stream_ptr(dev))
    name = "hashgrid_encode_bf16" if low else "hashgrid_encode"
    kernels.check(err, name)
    kernels.launches[name] += 1
    return out


def hashgrid_encode_bwd(table, x, spec: HashGridSpec, g, level_mask=None,
                        need_x: bool = True):
    """``(d_table, d_x)``: CPU tensors take the plain twin; CUDA tensors
    launch kernel KA' (a warp's same-row adds merged into one reduction;
    ``d_x`` summed in level order, the same on every call)."""
    if x.device.type == "cpu":
        return hashgrid_encode_bwd_plain(table, x, spec, g, level_mask,
                                         need_x)
    dev, N, L, T, F = _check(table, x, spec, level_mask)
    kernels.require(g, "g", torch.float32, dev, (N, spec.n_output_dims))
    if F == 2 and need_x and table.data_ptr() % 8:
        raise ValueError("table must be 8-byte aligned for d_x with F = 2 "
                         "(its rows are read as float2)")
    scales, res = level_tensors(spec, dev)
    d_table = torch.zeros_like(table)
    d_x = torch.zeros_like(x) if need_x else None
    err = kernels.lib("hashgrid").hashgrid_encode_bwd(
        table.data_ptr(), x.data_ptr(), scales.data_ptr(), res.data_ptr(),
        level_mask.data_ptr() if level_mask is not None else None,
        g.data_ptr(), d_table.data_ptr(),
        d_x.data_ptr() if need_x else None, N, L, T, F,
        int(spec.include_xyz), float(spec.xyz_scale),
        kernels.stream_ptr(dev))
    kernels.check(err, "hashgrid_encode_bwd")
    kernels.launches["hashgrid_encode_bwd"] += 1
    return d_table, d_x


class _HashgridEncode(torch.autograd.Function):
    """The encode with its closed-form backward; the level mask is a
    function of the step only and gets no gradient.  ``low`` is the table
    in the scope's compute dtype (None outside a scope): the forward
    gathers its rows, the backward uses the float32 ``table``."""

    @staticmethod
    def forward(ctx, table, x, spec, level_mask, low):
        ctx.spec = spec
        ctx.save_for_backward(table, x, level_mask)
        src = table if low is None else low
        if x.device.type == "cpu":
            return hashgrid_encode_plain(src, x, spec, level_mask)
        return _launch_fwd(src, x, spec, level_mask)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        table, x, level_mask = ctx.saved_tensors
        need_table, need_x = ctx.needs_input_grad[:2]
        if not (need_table or need_x):
            return None, None, None, None, None
        d_table, d_x = hashgrid_encode_bwd(table, x, ctx.spec,
                                           g.contiguous(), level_mask,
                                           need_x)
        return (d_table if need_table else None), d_x, None, None, None


def hashgrid_encode(table, x, spec: HashGridSpec, level_mask=None):
    """Encode points ``x in [0,1]^3`` -> ``[N, n_output_dims]`` features.

    CPU tensors take the plain twins; CUDA tensors launch kernel KA (and
    KA' in the backward).  Inside a bf16 scope the forward gathers the rows
    of the table rounded to bf16 (:func:`precision.cast_table`).
    """
    low = precision.cast_table(table)
    return _HashgridEncode.apply(table, x, spec, level_mask,
                                 None if low is table else low)
