"""Fused hash encode + SDF MLP + SDF point gradient, with its closed-form
backward.

Counterpart of the JAX package's ``ops/encode_grad.py``: the composition
``(table, MLP weights, xn) -> (feat = MLP(enc(xn)), grad = d feat[0] / d xn)``
as one ``torch.autograd.Function`` whose backward is ``_bwd``
(``ops/encode_grad.py:225-344``): pass 1 regathers the corner rows and
rebuilds ``enc`` and the gradient's encode cotangent; the MLP's
vector-Jacobian product stays in PyTorch (``nets/mlp.py``); pass 2 adds the
merged row cotangent into the table and pulls ``xn`` back.

For CUDA tensors the forward launches kernel KB and the two passes kernel
KB' (``csrc/encode_grad.cu``); CPU tensors take the plain twins
:func:`encode_mlp_sdfgrad_plain`, :func:`encode_mlp_sdfgrad_bwd_gather_plain`
and :func:`encode_mlp_sdfgrad_bwd_scatter_plain`.  The Function takes the
MLP's effective weights, so weight normalization chains through autograd.

Inside a bf16 compute scope (``ops/precision.py``) the forward gathers bf16
rows of the table rounded once per version and runs the MLP's products on
bf16 operands with float32 accumulation (KB's bf16 form, or the twin on the
rounded table under the scope); the backward runs in float32 on the float32
table, as the JAX custom VJP's backward is traced outside the scope.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from intrinsicavatar_tpu_torch import kernels
from intrinsicavatar_tpu_torch.ops import precision
from intrinsicavatar_tpu_torch.ops.hashgrid import (
    HashGridSpec, corner_rows, corner_weight_grads, corner_weights,
    level_coords, level_tensors,
)

# corner k = dx*4 + dy*2 + dz (dz fastest)
_SGN = [[2.0 * ((k >> s) & 1) - 1.0 for k in range(8)] for s in (2, 1, 0)]


def encode_mlp_sdfgrad_plain(spec: HashGridSpec, mlp, table, xn, level_mask,
                             weights=None):
    """Plain twin of kernel KB: ``(feat [N, d_out], grad [N, 3])`` with
    ``grad = d feat[:, 0] / d xn`` from the same gathered rows.  A bf16 table
    gives KB's bf16 form, with the MLP's products in the scoped compute
    dtype (call it inside the scope)."""
    N = xn.shape[0]
    L, T, F = table.shape
    cache, parts = [], []
    for lvl in range(L):
        s = float(spec.scales[lvl])
        r = int(spec.resolutions[lvl])
        c0, f = zip(*(level_coords(xn[:, a], s) for a in range(3)))
        rows = table[lvl][corner_rows(c0, r, bool(spec.dense_levels[lvl]),
                                      T)].to(xn.dtype)
        w8 = corner_weights(f)
        parts.append(torch.einsum("nk,nkf->nf", w8, rows))
        cache.append((s, rows, f))
    enc = torch.cat(parts, dim=-1) * level_mask[None, :]
    if spec.include_xyz:
        enc = torch.cat([xn * spec.xyz_scale + spec.xyz_offset, enc], dim=-1)

    feat, g_enc = mlp.value_and_input_grad(enc, weights=weights)

    off = 3 if spec.include_xyz else 0
    g_used = (g_enc[:, off:] * level_mask[None, :]).reshape(N, L, F)
    sgn = torch.tensor(_SGN, dtype=xn.dtype, device=xn.device)   # [3, 8]
    g = torch.zeros((N, 3), dtype=xn.dtype, device=xn.device)
    for lvl, (s, rows, (fx, fy, fz)) in enumerate(cache):
        fg = torch.einsum("nkf,nf->nk", rows, g_used[:, lvl, :])  # [N, 8]
        bx, by, bz = (sgn[a].clamp(min=0.0)[None, :] for a in range(3))
        wx = fx[:, None] * bx + (1.0 - fx[:, None]) * (1.0 - bx)
        wy = fy[:, None] * by + (1.0 - fy[:, None]) * (1.0 - by)
        wz = fz[:, None] * bz + (1.0 - fz[:, None]) * (1.0 - bz)
        g = g + s * torch.stack([
            torch.sum(fg * (sgn[0][None] * wy * wz), -1),
            torch.sum(fg * (wx * sgn[1][None] * wz), -1),
            torch.sum(fg * (wx * wy * sgn[2][None]), -1)], dim=-1)
    if spec.include_xyz:
        g = g + g_enc[:, :3] * spec.xyz_scale
    return feat, g


def _levels(spec: HashGridSpec, table, xn):
    """Per level: ``(lvl, s, rows [N, 8, F], row indices [N, 8], f, w8,
    dw8)``."""
    L, T, F = table.shape
    for lvl in range(L):
        s = float(spec.scales[lvl])
        r = int(spec.resolutions[lvl])
        c0, f = zip(*(level_coords(xn[:, a], s) for a in range(3)))
        idx = corner_rows(c0, r, bool(spec.dense_levels[lvl]), T)
        yield (lvl, s, table[lvl][idx], idx, f, corner_weights(f),
               corner_weight_grads(f))


def encode_mlp_sdfgrad_bwd_gather_plain(spec: HashGridSpec, table, xn,
                                        level_mask, g_grad):
    """Plain twin of KB' pass 1 (``_bwd`` ``:238-269``): ``(enc [N, d_in],
    g_genc_cot [N, d_in])``, the encode and the cotangent that the point
    gradient's cotangent ``g_grad`` puts on the MLP's input gradient."""
    enc, gg = [], []
    for lvl, s, rows, _, _, w8, dw8 in _levels(spec, table, xn):
        u8 = s * sum(g_grad[:, a, None] * dw8[a] for a in range(3))
        enc.append(torch.einsum("nk,nkf->nf", w8, rows))
        gg.append(torch.einsum("nk,nkf->nf", u8, rows))
    enc = torch.cat(enc, -1) * level_mask[None, :]
    gg = torch.cat(gg, -1) * level_mask[None, :]
    if spec.include_xyz:
        enc = torch.cat([xn * spec.xyz_scale + spec.xyz_offset, enc], -1)
        gg = torch.cat([g_grad * spec.xyz_scale, gg], -1)
    return enc, gg


def encode_mlp_sdfgrad_bwd_scatter_plain(spec: HashGridSpec, table, xn,
                                         level_mask, g_grad, d_enc, g_enc,
                                         need_x: bool = True):
    """Plain twin of KB' pass 2 (``_bwd`` ``:288-341``): ``(d_table,
    d_xn)``.  The merged row cotangent ``w_k d_enc + u_k g_enc`` goes into
    each corner's row with ``index_add_``; ``d_xn`` is the encode path's
    term plus the s^2 second-order terms (None unless ``need_x``)."""
    N = xn.shape[0]
    L, T, F = table.shape
    off = 3 if spec.include_xyz else 0
    de_all = (d_enc[:, off:] * level_mask[None, :]).reshape(N, L, F)
    gl_all = (g_enc[:, off:] * level_mask[None, :]).reshape(N, L, F)
    sgn = torch.tensor(_SGN, dtype=xn.dtype, device=xn.device)[:, None, :]
    gg = [g_grad[:, a, None] for a in range(3)]
    d_table = torch.zeros_like(table)
    d_xn = torch.zeros_like(xn) if need_x else None
    for lvl, s, rows, idx, f, w8, dw8 in _levels(spec, table, xn):
        de, gl = de_all[:, lvl], gl_all[:, lvl]
        u8 = s * sum(gg[a] * dw8[a] for a in range(3))
        row_cot = w8[:, :, None] * de[:, None, :] \
            + u8[:, :, None] * gl[:, None, :]
        d_table[lvl].index_add_(0, idx.reshape(-1), row_cot.reshape(-1, F))
        if not need_x:
            continue
        re = torch.einsum("nkf,nf->nk", rows, de)
        fg = torch.einsum("nkf,nf->nk", rows, gl)
        # d^2 w_k / d pos_a d pos_b: the product of the two axes' signs
        # with the third axis' weight
        wa = [torch.where(sgn[a] > 0, f[a][:, None], 1.0 - f[a][:, None])
              for a in range(3)]
        second = []
        for a in range(3):
            b, c = [i for i in range(3) if i != a]
            second.append(torch.sum(fg * sgn[a] * (
                gg[b] * sgn[b] * wa[c] + gg[c] * sgn[c] * wa[b]), -1))
        d_xn = d_xn + s * torch.stack(
            [torch.sum(re * dw8[a], -1) for a in range(3)], -1) \
            + (s * s) * torch.stack(second, -1)
    if need_x and spec.include_xyz:
        d_xn = d_xn + d_enc[:, :3] * spec.xyz_scale
    return d_table, d_xn


def _check(spec: HashGridSpec, table, xn, level_mask, g_grad=None,
           table_dtype=torch.float32):
    dev = xn.device
    L, T, F = table.shape
    N = xn.shape[0]
    if (L, T, F) != (spec.n_levels, spec.table_size,
                     spec.n_features_per_level) or L * F > 32 or F > 4:
        raise ValueError(f"table shape {tuple(table.shape)} does not match "
                         f"the spec (or L*F > 32, F > 4)")
    kernels.require(table, "table", table_dtype, dev, (L, T, F))
    kernels.require(xn, "xn", torch.float32, dev, (N, 3))
    kernels.require(level_mask, "level_mask", torch.float32, dev, (L * F,))
    if g_grad is not None:
        kernels.require(g_grad, "g_grad", torch.float32, dev, (N, 3))
    return dev, N, L, T, F


def encode_mlp_sdfgrad_bwd_gather(spec: HashGridSpec, table, xn, level_mask,
                                  g_grad):
    """KB' pass 1 for CUDA tensors, its plain twin for CPU tensors."""
    if xn.device.type == "cpu":
        return encode_mlp_sdfgrad_bwd_gather_plain(spec, table, xn,
                                                   level_mask, g_grad)
    dev, N, L, T, F = _check(spec, table, xn, level_mask, g_grad)
    if F == 2 and table.data_ptr() % 16:
        raise ValueError("table must be 16-byte aligned for F = 2 (its row "
                         "pairs are read as float4 words)")
    scales, res = level_tensors(spec, dev)
    enc = torch.empty((N, spec.n_output_dims), dtype=torch.float32,
                      device=dev)
    gg = torch.empty_like(enc)
    err = kernels.lib("encode_grad").encode_mlp_sdfgrad_bwd_gather(
        table.data_ptr(), xn.data_ptr(), scales.data_ptr(), res.data_ptr(),
        level_mask.data_ptr(), g_grad.data_ptr(), enc.data_ptr(),
        gg.data_ptr(), N, L, T, F, int(spec.include_xyz),
        float(spec.xyz_scale), float(spec.xyz_offset),
        kernels.stream_ptr(dev))
    kernels.check(err, "encode_mlp_sdfgrad_bwd_gather")
    kernels.launches["encode_mlp_sdfgrad_bwd_gather"] += 1
    return enc, gg


def encode_mlp_sdfgrad_bwd_scatter(spec: HashGridSpec, table, xn,
                                   level_mask, g_grad, d_enc, g_enc,
                                   need_x: bool = True):
    """KB' pass 2 for CUDA tensors, its plain twin for CPU tensors."""
    if xn.device.type == "cpu":
        return encode_mlp_sdfgrad_bwd_scatter_plain(
            spec, table, xn, level_mask, g_grad, d_enc, g_enc, need_x)
    dev, N, L, T, F = _check(spec, table, xn, level_mask, g_grad)
    for t, name in ((d_enc, "d_enc"), (g_enc, "g_enc")):
        kernels.require(t, name, torch.float32, dev,
                        (N, spec.n_output_dims))
    if F == 2 and need_x and table.data_ptr() % 8:
        raise ValueError("table must be 8-byte aligned for d_xn with F = 2 "
                         "(its rows are read as float2)")
    scales, res = level_tensors(spec, dev)
    d_table = torch.zeros_like(table)
    # the kernel stores every point's d_xn once
    d_xn = torch.empty_like(xn) if need_x else None
    err = kernels.lib("encode_grad").encode_mlp_sdfgrad_bwd_scatter(
        table.data_ptr(), xn.data_ptr(), scales.data_ptr(), res.data_ptr(),
        level_mask.data_ptr(), g_grad.data_ptr(), d_enc.data_ptr(),
        g_enc.data_ptr(), d_table.data_ptr(),
        d_xn.data_ptr() if need_x else None, N, L, T, F,
        int(spec.include_xyz), float(spec.xyz_scale),
        kernels.stream_ptr(dev))
    kernels.check(err, "encode_mlp_sdfgrad_bwd_scatter")
    kernels.launches["encode_mlp_sdfgrad_bwd_scatter"] += 1
    return d_table, d_xn


def _launch_fwd(spec: HashGridSpec, mlp, table, xn, level_mask, weights):
    """KB, or its bf16 form ``encode_mlp_sdfgrad_bf16`` for a bf16 table."""
    if len(weights) != 2 or not mlp.sphere_init:
        raise ValueError("kernel KB takes a one-hidden-layer sphere-init MLP")
    low = table.dtype == torch.bfloat16
    dev, N, L, T, F = _check(spec, table, xn, level_mask,
                             table_dtype=torch.bfloat16 if low
                             else torch.float32)
    (W1, b1), (W2, b2) = [(w.contiguous(), b.contiguous())
                          for w, b in weights]
    d_in, hidden = W1.shape
    d_out = W2.shape[1]
    if d_in != spec.n_output_dims:
        raise ValueError(f"MLP input width {d_in} != encode width "
                         f"{spec.n_output_dims}")
    for t, name in ((W1, "W1"), (b1, "b1"), (W2, "W2"), (b2, "b2")):
        kernels.require(t, name, torch.float32, dev)
    scales, res = level_tensors(spec, dev)
    feat = torch.empty((N, d_out), dtype=torch.float32, device=dev)
    grad = torch.empty((N, 3), dtype=torch.float32, device=dev)
    fn = "encode_mlp_sdfgrad_fwd_bf16" if low else "encode_mlp_sdfgrad_fwd"
    err = getattr(kernels.lib("encode_grad"), fn)(
        table.data_ptr(), xn.data_ptr(), scales.data_ptr(), res.data_ptr(),
        level_mask.data_ptr(), W1.data_ptr(), b1.data_ptr(), W2.data_ptr(),
        b2.data_ptr(), feat.data_ptr(), grad.data_ptr(), N, L, T, F,
        int(spec.include_xyz), d_in, hidden, d_out, float(spec.xyz_scale),
        float(spec.xyz_offset), kernels.stream_ptr(dev))
    name = "encode_mlp_sdfgrad_bf16" if low else "encode_mlp_sdfgrad"
    kernels.check(err, name)
    kernels.launches[name] += 1
    return feat, grad


class _EncodeMLPSDFGrad(torch.autograd.Function):
    """``(table, xn, W1, b1, ..., Wn, bn) -> (feat, grad)`` with the
    closed-form backward of the JAX ``_bwd``; the level mask is a function
    of the step only and gets no gradient.  ``low`` is the table in the
    scope's compute dtype (None outside a scope): the forward gathers its
    rows; the backward runs in float32 on ``table``."""

    @staticmethod
    def forward(ctx, spec, mlp, level_mask, low, table, xn, *flat_w):
        weights = list(zip(flat_w[0::2], flat_w[1::2]))
        ctx.spec, ctx.mlp = spec, mlp
        ctx.save_for_backward(level_mask, table, xn, *flat_w)
        src = table if low is None else low
        if xn.device.type == "cpu":
            return encode_mlp_sdfgrad_plain(spec, mlp, src, xn,
                                            level_mask, weights)
        return _launch_fwd(spec, mlp, src, xn, level_mask, weights)

    @staticmethod
    @once_differentiable
    def backward(ctx, g_feat, g_grad):
        level_mask, table, xn, *flat_w = ctx.saved_tensors
        spec = ctx.spec
        weights = list(zip(flat_w[0::2], flat_w[1::2]))
        g_grad = g_grad.contiguous()
        with precision.scope(None):
            enc, g_genc_cot = encode_mlp_sdfgrad_bwd_gather(
                spec, table, xn, level_mask, g_grad)
            d_w, d_enc, g_enc = ctx.mlp.pair_vjp(
                enc, weights, g_feat.contiguous(), g_genc_cot)
            need_x = ctx.needs_input_grad[5]
            d_table, d_xn = encode_mlp_sdfgrad_bwd_scatter(
                spec, table, xn, level_mask, g_grad, d_enc.contiguous(),
                g_enc.contiguous(), need_x)
        return (None, None, None, None,
                d_table if ctx.needs_input_grad[4] else None, d_xn,
                *[d for pair in d_w for d in pair])


def encode_mlp_sdfgrad(spec: HashGridSpec, mlp, table, xn, level_mask=None):
    """``(feat, grad)``: ``feat = MLP(encode(xn))`` and ``grad`` the analytic
    d feat[0] / d xn in normalized coordinates, differentiable in the
    table, the MLP's parameters and ``xn``.

    CPU tensors take the plain twins; CUDA tensors launch kernel KB, which
    takes a one-hidden-layer sphere-init (Softplus(100)) MLP, and KB' in the
    backward.  Inside a bf16 scope the forward is KB's bf16 form on the
    table rounded to bf16 (:func:`precision.cast_table`).
    """
    L, T, F = table.shape
    if level_mask is None:
        level_mask = torch.ones(L * F, dtype=xn.dtype, device=xn.device)
    flat_w = [t for w, b in mlp.effective_weights() for t in (w, b)]
    low = precision.cast_table(table)
    return _EncodeMLPSDFGrad.apply(spec, mlp, level_mask,
                                   None if low is table else low, table, xn,
                                   *flat_w)
