"""Importance merge resampling (counterpart of the JAX package's
``ops/resample.py`` ``merge_resample`` / ``merge_resample_rays``, batched
over rays).  :func:`merge_resample_rays` launches kernel KF
(``csrc/resample.cu``) for CUDA tensors and takes the plain twin
:func:`merge_resample_rays_plain` only for CPU tensors."""

from __future__ import annotations

from typing import NamedTuple

import torch

from intrinsicavatar_tpu_torch import kernels

MAX_BINS = 64   # kMaxBins of csrc/resample.cu


def _bin_params(n_bins: int):
    """``(u_0, du)`` of :func:`uniform_bins`, as Python floats."""
    if n_bins == 1:
        return 0.5, 0.0
    return 1.0 / (2.0 * n_bins), (1.0 - 1.0 / n_bins) / (n_bins - 1)


def uniform_bins(n_bins: int, dtype=torch.float32, device=None):
    """``u_k = 1/(2B) + k (1 - 1/B) / (B - 1)``, k < B (cdf.cu:53-58)."""
    if n_bins == 1:
        return torch.tensor([0.5], dtype=dtype, device=device)
    u0, du = _bin_params(n_bins)
    k = torch.arange(n_bins, dtype=dtype, device=device)
    return u0 + k * du


class MergeResampleOut(NamedTuple):
    vals: torch.Tensor        # [R, E+B] merged edge values (invalid = +inf)
    is_left: torch.Tensor
    is_right: torch.Tensor
    valid: torch.Tensor
    is_new: torch.Tensor      # slot came from resampling (needs re-query)
    gather_idx: torch.Tensor  # index into cat(old[E], new[B]) per slot


def merge_resample_rays_plain(vals, is_left, is_right, valid, weights,
                              n_samples: int) -> MergeResampleOut:
    """Plain twin of kernel KF.  Old edges win ties: they come first in the
    concatenation and the sort is stable."""
    R, E = vals.shape
    B = n_samples
    steps = valid.sum(-1)
    has_any = steps > 0
    last = torch.clamp(steps - 1, min=0)

    nxt_valid = torch.roll(valid, -1, 1)
    nxt_valid[:, -1] = False
    nxt_right = torch.roll(is_right, -1, 1)
    real = valid & nxt_valid & is_left & nxt_right
    w = torch.where(real, weights, 0.0)
    wsum_fg = w.sum(-1, keepdim=True)
    denom = wsum_fg + torch.clamp(1.0 - wsum_fg, min=0.0)
    cdf = torch.cumsum(w, -1) / denom
    cdf_prev = cdf - w / denom
    fg_total = torch.gather(cdf, 1, last[:, None])

    u = uniform_bins(B, vals.dtype, vals.device)[None, :].expand(R, B)
    placed = (u < fg_total) & has_any[:, None]
    idx = torch.searchsorted(cdf.contiguous(), u.contiguous(), right=True)
    idx = torch.minimum(torch.clamp(idx, min=0), last[:, None])
    g = lambda a, i: torch.gather(a, 1, i)
    t0 = g(vals, idx)
    t1 = g(vals, torch.clamp(idx + 1, max=E - 1))
    seg = torch.clamp(g(cdf, idx) - g(cdf_prev, idx), min=1e-20)
    t_new = t0 + (u - g(cdf_prev, idx)) * (t1 - t0) / seg

    all_vals = torch.cat([torch.where(valid, vals, torch.inf),
                          torch.where(placed, t_new, torch.inf)], 1)
    all_left = torch.cat([is_left & valid, placed], 1)
    all_right = torch.cat([is_right & valid, placed], 1)
    all_valid = torch.cat([valid, placed], 1)
    all_new = torch.cat([torch.zeros_like(valid), placed], 1)
    order = torch.argsort(all_vals, dim=1, stable=True)
    take = lambda a: torch.gather(a, 1, order)
    return MergeResampleOut(vals=take(all_vals), is_left=take(all_left),
                            is_right=take(all_right), valid=take(all_valid),
                            is_new=take(all_new), gather_idx=order)


def merge_resample_rays(vals, is_left, is_right, valid, weights,
                        n_samples: int) -> MergeResampleOut:
    """Merge ``n_samples`` inverse-CDF draws per ray into its sorted edge
    list ``[R, E]`` (`cdf_resampling_merge_kernel`, cdf.cu:218-333), with
    ``weights [R, E]`` the interval weights.  Returns ``[R, E + B]``."""
    if vals.device.type == "cpu":
        return merge_resample_rays_plain(vals, is_left, is_right, valid,
                                         weights, n_samples)
    dev = vals.device
    R, E = vals.shape
    B = int(n_samples)
    if not 1 <= B <= MAX_BINS:
        raise ValueError(f"n_samples {B} outside [1, {MAX_BINS}]")
    kernels.require(vals, "vals", torch.float32, dev, (R, E))
    kernels.require(weights, "weights", torch.float32, dev, (R, E))
    for name, t in (("is_left", is_left), ("is_right", is_right),
                    ("valid", valid)):
        kernels.require(t, name, torch.bool, dev, (R, E))
    out_vals = torch.empty((R, E + B), dtype=torch.float32, device=dev)
    flags = [torch.empty((R, E + B), dtype=torch.bool, device=dev)
             for _ in range(4)]
    gather_idx = torch.empty((R, E + B), dtype=torch.int64, device=dev)
    u0, du = _bin_params(B)
    err = kernels.lib("resample").merge_resample_fwd(
        vals.data_ptr(), is_left.data_ptr(), is_right.data_ptr(),
        valid.data_ptr(), weights.data_ptr(), R, E, B, u0, du,
        out_vals.data_ptr(), *(f.data_ptr() for f in flags),
        gather_idx.data_ptr(), kernels.stream_ptr(dev))
    kernels.check(err, "merge_resample")
    kernels.launches["merge_resample"] += 1
    return MergeResampleOut(out_vals, *flags, gather_idx)
