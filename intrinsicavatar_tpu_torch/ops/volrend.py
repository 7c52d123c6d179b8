"""Rectangular masked volume rendering (counterpart of the JAX package's
``ops/volrend.py:24-126``): kernel KD, its weights in CUDA and its
composite in Triton.

KD replaces ``alpha_from_sdf`` + ``render_weight_from_alpha`` +
``accumulate_along_rays`` of the JAX op (themselves the nerfacc kernels of
the reference).  Two entries:

* :func:`render_weight_from_alpha` -- weights and transmittance, used by the
  importance rounds and the secondary shader chunks; a CUDA kernel
  (``csrc/volrend.cu``) in two forms: a thread a row for short rows of
  16-byte words (a shader chunk's ``[32768, 4]``), a warp a row with a
  multiplicative warp scan for any other (the importance rounds' 129 and
  145 samples);
* :func:`composite` -- Laplace alpha from SDF, weights, and the rgb, normal,
  opacity and depth sums of the final composite; differentiable in the SDF,
  beta, rgb and normals, with kernel KD' (Triton) as its backward.

What bounds KD on an H100: bytes.  Per sample it reads a few floats and
writes one or two, with ~30 flops between, far below the card's ~20 flops
per byte.  The composite: one Triton program per ray, the whole row (S <=
161 samples, padded to a power of two) in one block; the exclusive
transmittance is an inclusive ``tl.cumprod`` over the row shifted by one
sample, which is loaded from memory at offset -1 (no division by ``1 -
alpha``, which can be 0).  Masked samples have alpha 0 and do not
attenuate.

KD' (the backward of the composite; JAX differentiates ``cumprod`` by
autodiff, ``ops/volrend.py:46-82``) is bound by bytes the same way.  It
never divides by ``1 - alpha``: ``dL/dalpha_i = T_i (gv_i - R_i)`` with
``gv_i`` the cotangent reaching sample i's weight and ``R_i = alpha_{i+1}
gv_{i+1} + (1 - alpha_{i+1}) R_{i+1}``, a reverse linear recurrence that the
kernel runs as a forward ``tl.associative_scan`` over the row loaded back to
front.  Beta's cotangent is summed per ray by the kernel and over rays by
``torch.sum``, with no float atomics.

CPU tensors take the plain twins ``*_plain``; CUDA tensors launch the
kernels: the weights' from ``csrc/volrend.cu``, the composite's and KD''s
from ``ops/volrend_triton.py``, which the launching functions load on first
use (``triton`` exists only where there is a card).
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from intrinsicavatar_tpu_torch import kernels


def laplace_density(sdf, beta):
    """VolSDF Laplace-CDF density
    ``(1/beta) * (0.5 + 0.5 * sign(sdf) * expm1(-|sdf| / beta))``."""
    return torch.reciprocal(beta) * (
        0.5 + 0.5 * torch.sign(sdf) * torch.expm1(-torch.abs(sdf) / beta))


def alpha_from_sdf(sdf, dists, beta):
    """Per-interval opacity ``1 - exp(-density(sdf) * dist)``."""
    return 1.0 - torch.exp(-laplace_density(sdf, beta) * dists)


def exclusive_prod(x):
    """Exclusive cumulative product along the last axis (first = 1)."""
    p = torch.cumprod(x, dim=-1)
    return torch.cat([torch.ones_like(p[..., :1]), p[..., :-1]], dim=-1)


def render_weight_from_alpha_plain(alphas, mask):
    alphas = torch.where(mask, alphas, 0.0)
    trans = exclusive_prod(1.0 - alphas)
    return alphas * trans, trans


def accumulate_along_rays(weights, values=None, mask=None):
    """Weighted sum along the sample axis (``[..., 1]`` opacity when
    ``values`` is None)."""
    if mask is not None:
        weights = torch.where(mask, weights, 0.0)
    if values is None:
        return torch.sum(weights, dim=-1, keepdim=True)
    return torch.einsum("...s,...sc->...c", weights, values)


def composite_plain(sdf, dists, beta, mask, rgb, normal, mids):
    alpha = torch.where(mask, alpha_from_sdf(sdf, dists, beta), 0.0)
    weights, _ = render_weight_from_alpha_plain(alpha, mask)
    return (alpha, weights,
            accumulate_along_rays(weights, rgb, mask),
            accumulate_along_rays(weights, normal, mask),
            accumulate_along_rays(weights, None, mask),
            accumulate_along_rays(weights, mids[..., None], mask))


def render_weight_from_alpha(alphas, mask):
    """``(weights, trans)``, each ``[R, S]``: ``w_i = alpha_i *
    prod_{j<i} (1 - alpha_j)`` over valid samples.  CPU tensors take the
    plain twin; CUDA tensors launch KD weights, whose entry picks its form
    from S and the pointers' alignment (``csrc/volrend.cu``)."""
    if alphas.device.type == "cpu":
        return render_weight_from_alpha_plain(alphas, mask)
    R, S = alphas.shape
    kernels.require(alphas, "alphas", torch.float32, alphas.device, (R, S))
    kernels.require(mask, "mask", torch.bool, alphas.device, (R, S))
    w = torch.empty_like(alphas)
    t = torch.empty_like(alphas)
    if R and S:
        err = kernels.lib("volrend").volrend_weights_fwd(
            alphas.data_ptr(), mask.data_ptr(), w.data_ptr(), t.data_ptr(),
            R, S, kernels.stream_ptr(alphas.device))
        kernels.check(err, "volrend_weights")
        kernels.launches["volrend_weights"] += 1
    return w, t


def composite_bwd_plain(sdf, dists, beta, mask, rgb, normal, mids, g_w,
                        g_rgb, g_normal, g_opacity, g_depth):
    """Plain twin of kernel KD': ``(d_sdf [R, S], d_beta [R] per ray,
    d_rgb [R, S, 3], d_normal [R, S, 3])`` from the cotangents of the
    weights ``[R, S]``, rgb and normal ``[R, 3]``, opacity and depth
    ``[R, 1]``.  As JAX's autodiff: masked samples get 0, and ``sign`` and
    ``|.|`` have gradient 0 at ``sdf == 0``."""
    sg = torch.sign(sdf)
    e = torch.exp(-torch.abs(sdf) / beta)
    dens = torch.reciprocal(beta) * (0.5 + 0.5 * sg * torch.expm1(
        -torch.abs(sdf) / beta))
    ex = torch.exp(-dens * dists)                 # 1 - alpha before masking
    alpha = torch.where(mask, 1.0 - ex, 0.0)
    trans = exclusive_prod(1.0 - alpha)
    w = alpha * trans
    gv = g_w + torch.einsum("rsc,rc->rs", rgb, g_rgb) \
        + torch.einsum("rsc,rc->rs", normal, g_normal) + g_opacity \
        + g_depth * mids
    gv = torch.where(mask, gv, 0.0)
    # R_i = alpha_{i+1} gv_{i+1} + (1 - alpha_{i+1}) R_{i+1}, R_{S-1} = 0
    R, S = sdf.shape
    rec = torch.zeros((R, S), dtype=sdf.dtype, device=sdf.device)
    acc = torch.zeros((R,), dtype=sdf.dtype, device=sdf.device)
    for i in range(S - 2, -1, -1):
        acc = alpha[:, i + 1] * gv[:, i + 1] + (1.0 - alpha[:, i + 1]) * acc
        rec[:, i] = acc
    d_alpha = torch.where(mask, trans * (gv - rec), 0.0)
    common = d_alpha * dists * ex
    d_sdf = common * (-0.5 / (beta * beta)) * e * (sg * sg)
    d_beta = torch.sum(common * (-dens / beta + 0.5 / beta * sg * e
                                 * torch.abs(sdf) / (beta * beta)), -1)
    wm = torch.where(mask, w, 0.0)[..., None]
    return (d_sdf, d_beta, wm * g_rgb[:, None, :], wm * g_normal[:, None, :])


def _check_composite(sdf, dists, mask, rgb, normal, mids):
    dev = sdf.device
    R, S = sdf.shape
    for t, name, shape in ((sdf, "sdf", (R, S)), (dists, "dists", (R, S)),
                           (rgb, "rgb", (R, S, 3)),
                           (normal, "normal", (R, S, 3)),
                           (mids, "mids", (R, S))):
        kernels.require(t, name, torch.float32, dev, shape)
    kernels.require(mask, "mask", torch.bool, dev, (R, S))
    return dev, R, S


def _launch_composite(sdf, dists, beta, mask, rgb, normal, mids):
    dev, R, S = _check_composite(sdf, dists, mask, rgb, normal, mids)
    beta = beta.reshape(1).to(torch.float32).contiguous()
    from intrinsicavatar_tpu_torch.ops import volrend_triton as k
    k.load()
    alpha = torch.empty_like(sdf)
    weights = torch.empty_like(sdf)
    out = torch.empty((R, 8), dtype=torch.float32, device=dev)
    if R:
        k.composite_kernel[(R,)](sdf, dists, beta, mask.view(torch.uint8),
                                 rgb, normal, mids, alpha, weights, out, S,
                                 BLOCK=k.block(S), num_warps=4)
        kernels.launches["volrend_composite"] += 1
    return (alpha, weights, out[:, 0:3], out[:, 3:6], out[:, 6:7],
            out[:, 7:8])


def composite_bwd(sdf, dists, beta, mask, rgb, normal, mids, g_w, g_rgb,
                  g_normal, g_opacity, g_depth):
    """``(d_sdf, d_beta per ray, d_rgb, d_normal)``: CPU tensors take the
    plain twin; CUDA tensors launch kernel KD'."""
    if sdf.device.type == "cpu":
        return composite_bwd_plain(sdf, dists, beta, mask, rgb, normal, mids,
                                   g_w, g_rgb, g_normal, g_opacity, g_depth)
    dev, R, S = _check_composite(sdf, dists, mask, rgb, normal, mids)
    kernels.require(g_w, "g_w", torch.float32, dev, (R, S))
    g_out = torch.cat([g_rgb, g_normal, g_opacity, g_depth], -1) \
        .to(torch.float32).contiguous()
    kernels.require(g_out, "g_out", torch.float32, dev, (R, 8))
    beta = beta.reshape(1).to(torch.float32).contiguous()
    from intrinsicavatar_tpu_torch.ops import volrend_triton as k
    k.load()
    d_sdf = torch.empty_like(sdf)
    d_rgb = torch.empty_like(rgb)
    d_normal = torch.empty_like(normal)
    d_beta = torch.empty((R,), dtype=torch.float32, device=dev)
    scratch = torch.empty_like(sdf)
    if R:
        k.composite_bwd_kernel[(R,)](
            sdf, dists, beta, mask.view(torch.uint8), rgb, normal, mids, g_w,
            g_out, d_sdf, d_beta, d_rgb, d_normal, scratch, S,
            BLOCK=k.block(S), num_warps=4)
        kernels.launches["volrend_composite_bwd"] += 1
    return d_sdf, d_beta, d_rgb, d_normal


class _Composite(torch.autograd.Function):
    """The composite, differentiable in ``sdf``, ``beta``, ``rgb`` and
    ``normal``; ``dists``, ``mask`` and ``mids`` come from the gradient-free
    sampling stage, and ``alpha`` is returned without a gradient."""

    @staticmethod
    def forward(ctx, sdf, dists, beta, mask, rgb, normal, mids):
        ctx.save_for_backward(sdf, dists, beta, mask, rgb, normal, mids)
        if sdf.device.type == "cpu":
            out = composite_plain(sdf, dists, beta, mask, rgb, normal, mids)
        else:
            out = _launch_composite(sdf, dists, beta, mask, rgb, normal,
                                    mids)
        ctx.mark_non_differentiable(out[0])
        return tuple(t.contiguous() for t in out)

    @staticmethod
    @once_differentiable
    def backward(ctx, _g_alpha, g_w, g_rgb, g_normal, g_opacity, g_depth):
        sdf, dists, beta, mask, rgb, normal, mids = ctx.saved_tensors
        d_sdf, d_beta, d_rgb, d_normal = composite_bwd(
            sdf, dists, beta, mask, rgb, normal, mids, g_w.contiguous(),
            g_rgb, g_normal, g_opacity, g_depth)
        d_beta = torch.sum(d_beta).reshape(beta.shape)
        return d_sdf, None, d_beta, None, d_rgb, d_normal, None


def composite(sdf, dists, beta, mask, rgb, normal, mids):
    """Final composite of ``[R, S]`` samples: returns ``(alpha, weights,
    rgb [R, 3], normal [R, 3], opacity [R, 1], depth [R, 1])`` where depth
    is the weighted sum of ``mids`` (the caller adds the background term).

    CPU tensors take the plain twins; CUDA tensors launch kernel KD (and
    KD' in the backward).
    """
    return _Composite.apply(sdf, dists, beta, mask, rgb, normal, mids)


def distortion_loss(weights, t_starts, t_ends, mask=None):
    """Mip-NeRF 360 distortion loss over rectangular samples, averaged over
    the rays with a valid sample (the JAX ``ops/volrend.py:133-158``)."""
    if mask is not None:
        weights = torch.where(mask, weights, 0.0)
    mids = 0.5 * (t_starts + t_ends)
    intervals = t_ends - t_starts
    dm = torch.abs(mids[..., :, None] - mids[..., None, :])
    loss_inter = torch.sum(weights[..., :, None] * weights[..., None, :] * dm,
                           dim=(-1, -2))
    per_ray = loss_inter + torch.sum(weights ** 2 * intervals, -1) / 3.0
    if mask is None:
        return per_ray.mean()
    alive = mask.any(-1)
    return torch.sum(torch.where(alive, per_ray, 0.0)) \
        / torch.clamp(alive.sum(), min=1)
