"""Inverse-CDF ray resampling, batched over rays (counterpart of the JAX
package's ``ops/resample.py``).  Each wrapper launches its kernel of
``csrc/resample.cu`` for CUDA tensors and takes its plain twin only for CPU
tensors:

- :func:`merge_resample_rays`, kernel KF: importance merge resampling;
- :func:`cdf_resample_rays`, kernel KI: scatter-point sampling with a
  background bin and surface pinning;
- :func:`sdf_fine_resample_rays` / :func:`fine_resample_rays`, kernel KJ:
  the secondary rays' fine resampling.

The twins of KI and KJ sum (and multiply) their CDFs in double and round to
float, as the kernels do, so on the card both build the same CDF and their
searches agree exactly; on the CPU that is ``torch.cumsum``'s own rounding.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from intrinsicavatar_tpu_torch import kernels

MAX_BINS = 64   # kMaxBins of csrc/resample.cu
MAX_EDGES = 2048  # kMaxEdges of csrc/resample.cu
CDF_MAX_S = 256  # kCdfMaxS of csrc/resample.cu
MAX_SHARED = 232_448  # shared memory a block can have on an H100 (227 KB)
BG_OFFSET = 10000.0  # background sample t offset (cdf.cu:131)


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
    if not 1 <= E <= MAX_EDGES:
        raise ValueError(f"{E} edges a ray outside [1, {MAX_EDGES}]")
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


class CdfResampleOut(NamedTuple):
    ts: torch.Tensor           # [R, B] sampled t (pinned at the surface)
    offsets: torch.Tensor      # [R, B] offset inside the interval
    indices: torch.Tensor      # [R, B] int32 source interval
    is_bg: torch.Tensor        # [R, B] background-bin draws
    fg_counts: torch.Tensor    # [R, S] int32 draws per interval
    bg_count: torch.Tensor     # [R] int32
    surface_idx: torch.Tensor  # [R] int32 crossing interval or -1


def _crossing(sdfs, mask):
    """``[R, S]`` bool: interval i crosses + -> - into interval i + 1."""
    nxt_mask = torch.roll(mask, -1, 1)
    nxt_mask[:, -1] = False
    return mask & nxt_mask & (sdfs >= 0.0) & (torch.roll(sdfs, -1, 1) < 0.0)


def _first(flags, none: int):
    """Index of the first True per row, ``none`` where there is none."""
    S = flags.shape[1]
    ar = torch.arange(S, device=flags.device).expand_as(flags)
    first = torch.where(flags, ar, S).min(-1).values
    return torch.where(first < S, first, none)


def _cdf(w, denom):
    """``(cdf, cdf_prev)`` of the row weights ``w`` over ``denom``: the sums
    in double, rounded to float (the kernels' rounding)."""
    cdf = torch.cumsum(w.double(), -1).float() / denom
    return cdf, cdf - w / denom


def cdf_resample_rays_plain(t_starts, t_ends, weights, sdfs, mask,
                            n_samples: int) -> CdfResampleOut:
    """Plain twin of kernel KI."""
    R, S = t_starts.shape
    B = n_samples
    g = lambda a, i: torch.gather(a, 1, i)
    steps = mask.sum(-1)
    has_any = steps > 0
    last = torch.clamp(steps - 1, min=0)[:, None]
    w = torch.where(mask, weights, 0.0)
    wsum = torch.cumsum(w.double(), -1)[:, -1:].float()
    cdf, cdf_prev = _cdf(w, wsum + torch.clamp(1.0 - wsum, min=0.0))
    fg_total = g(cdf, last)

    u = uniform_bins(B, t_starts.dtype, t_starts.device)[None].expand(R, B)
    idx = torch.searchsorted(cdf.contiguous(), u.contiguous(), right=True)
    idx = torch.minimum(idx, last)
    is_bg = (u >= fg_total) | ~has_any[:, None]
    c_lo = g(cdf_prev, idx)
    seg = torch.clamp(g(cdf, idx) - c_lo, min=1e-20)
    dist = g(t_ends, idx) - g(t_starts, idx)
    offset = (u - c_lo) * dist / seg
    t_raw = g(t_starts, idx) + offset

    cross = _first(_crossing(sdfs, mask), S + 1)[:, None]
    s_lo = g(sdfs, idx)
    s_hi = g(torch.roll(sdfs, -1, 1), idx)
    s_ap = s_lo + (s_hi - s_lo) * offset / torch.clamp(dist, min=1e-20)
    pinned = ~is_bg & ((idx > cross) | ((idx == cross) & (s_ap < 0.0)))

    # forward-fill the pinned draws from the last unpinned one
    t_cand = torch.where(is_bg, g(t_ends, last) + BG_OFFSET, t_raw)
    ar = torch.arange(B, device=u.device).expand(R, B)
    src = torch.cummax(torch.where(pinned, -1, ar), 1).values
    ts = torch.where(src >= 0, g(t_cand, torch.clamp(src, min=0)),
                     g(t_starts, idx[:, :1]))
    offsets = torch.where(is_bg, BG_OFFSET, offset)
    indices = torch.where(is_bg, last, idx)
    fg_counts = torch.zeros((R, S), dtype=torch.int32, device=u.device)
    fg_counts.scatter_add_(1, indices, (~is_bg).to(torch.int32))
    u_last = u[:, -1:]
    passed = (cross <= S - 1) & has_any[:, None] \
        & (u_last >= g(cdf, torch.clamp(cross, max=S - 1)))
    return CdfResampleOut(
        ts=ts, offsets=offsets, indices=indices.to(torch.int32),
        is_bg=is_bg, fg_counts=fg_counts,
        bg_count=is_bg.sum(-1, dtype=torch.int32),
        surface_idx=torch.where(passed, cross, -1)[:, 0].to(torch.int32))


def cdf_resample_rays(t_starts, t_ends, weights, sdfs, mask,
                      n_samples: int) -> CdfResampleOut:
    """Stratified inverse-CDF draw of ``n_samples`` scattering points per
    ray over ``[R, S]`` intervals (valid entries left-packed), with an
    implicit background bin and pinning at the first SDF zero-crossing
    (`cdf_resampling_kernel`, cdf.cu:10-148)."""
    if t_starts.device.type == "cpu":
        return cdf_resample_rays_plain(t_starts, t_ends, weights, sdfs, mask,
                                       n_samples)
    dev = t_starts.device
    R, S = t_starts.shape
    B = int(n_samples)
    if not (1 <= S <= CDF_MAX_S and B >= 1):
        raise ValueError(f"S {S} outside [1, {CDF_MAX_S}] or B {B} < 1")
    for name, t in (("t_starts", t_starts), ("t_ends", t_ends),
                    ("weights", weights), ("sdfs", sdfs)):
        kernels.require(t, name, torch.float32, dev, (R, S))
    kernels.require(mask, "mask", torch.bool, dev, (R, S))
    f32, i32 = torch.float32, torch.int32
    ts = torch.empty((R, B), dtype=f32, device=dev)
    offsets = torch.empty((R, B), dtype=f32, device=dev)
    indices = torch.empty((R, B), dtype=i32, device=dev)
    is_bg = torch.empty((R, B), dtype=torch.bool, device=dev)
    fg_counts = torch.empty((R, S), dtype=i32, device=dev)
    bg_count = torch.empty((R,), dtype=i32, device=dev)
    surface_idx = torch.empty((R,), dtype=i32, device=dev)
    u0, du = _bin_params(B)
    err = kernels.lib("resample").cdf_resample_fwd(
        t_starts.data_ptr(), t_ends.data_ptr(), weights.data_ptr(),
        sdfs.data_ptr(), mask.data_ptr(), R, S, B, u0, du, ts.data_ptr(),
        offsets.data_ptr(), indices.data_ptr(), is_bg.data_ptr(),
        fg_counts.data_ptr(), bg_count.data_ptr(), surface_idx.data_ptr(),
        kernels.stream_ptr(dev))
    kernels.check(err, "cdf_resample")
    kernels.launches["cdf_resample"] += 1
    return CdfResampleOut(ts, offsets, indices, is_bg, fg_counts, bg_count,
                          surface_idx)


class FineResampleOut(NamedTuple):
    t_starts: torch.Tensor   # [R, n] resampled interval starts
    t_ends: torch.Tensor     # [R, n]
    mask: torch.Tensor       # [R, n] interval validity


def _draws(t_starts, t_ends, cdf, cdf_prev, idx, u, placed):
    g = lambda a: torch.gather(a, 1, idx)
    c_lo = g(cdf_prev)
    seg = torch.clamp(g(cdf) - c_lo, min=1e-20)
    ts0 = g(t_starts)
    t = ts0 + (u - c_lo) * (g(t_ends) - ts0) / seg
    return FineResampleOut(t_starts=t[:, :-1], t_ends=t[:, 1:],
                           mask=placed[:, :-1] & placed[:, 1:])


def sdf_fine_resample_rays_plain(t_starts, t_ends, alphas, sdfs, mask,
                                 n_samples: int) -> FineResampleOut:
    """Plain twin of kernel KJ, zero-crossing mode."""
    R, S = t_starts.shape
    cross = _first(_crossing(sdfs, mask), -1)
    found = cross >= 0
    ar = torch.arange(S, device=mask.device)[None]
    a = torch.where(mask & (ar >= torch.clamp(cross, min=0)[:, None]),
                    alphas, 0.0)
    trans = torch.cumprod((1.0 - a).double(), -1).float()
    w = a * torch.cat([torch.ones_like(trans[:, :1]), trans[:, :-1]], -1)
    cdf, cdf_prev = _cdf(w, 1.0)
    u = uniform_bins(n_samples + 1, t_starts.dtype,
                     t_starts.device)[None].expand(R, -1).contiguous()
    placed = (u < cdf[:, -1:]) & found[:, None]
    idx = torch.clamp(torch.searchsorted(cdf.contiguous(), u, right=True),
                      max=S - 1)
    return _draws(t_starts, t_ends, cdf, cdf_prev, idx, u, placed)


def fine_resample_rays_plain(t_starts, t_ends, weights, mask,
                             n_samples: int) -> FineResampleOut:
    """Plain twin of kernel KJ, plain mode."""
    R, S = t_starts.shape
    steps = mask.sum(-1)
    last = torch.clamp(steps - 1, min=0)[:, None]
    w = torch.where(mask, weights, 0.0)
    wsum = torch.cumsum(w.double(), -1)[:, -1:].float()
    cdf, cdf_prev = _cdf(w, wsum + torch.clamp(1.0 - wsum, min=0.0))
    u = uniform_bins(n_samples + 1, t_starts.dtype,
                     t_starts.device)[None].expand(R, -1).contiguous()
    placed = (u < torch.gather(cdf, 1, last)) & (steps > 0)[:, None]
    idx = torch.minimum(torch.searchsorted(cdf.contiguous(), u, right=True),
                        last)
    return _draws(t_starts, t_ends, cdf, cdf_prev, idx, u, placed)


def _launch_fine(t_starts, t_ends, vals, sdfs, mask, n_samples, sdf_mode):
    dev = t_starts.device
    R, S = t_starts.shape
    n = int(n_samples)
    if n < 1:
        raise ValueError(f"n_samples {n} < 1")
    for name, t in (("t_starts", t_starts), ("t_ends", t_ends),
                    ("weights", vals), ("sdfs", sdfs)):
        kernels.require(t, name, torch.float32, dev, (R, S))
    kernels.require(mask, "mask", torch.bool, dev, (R, S))
    lib = kernels.lib("resample")
    smem = lib.fine_resample_smem(S, n + 1)
    if smem > MAX_SHARED:
        raise ValueError(f"rows of {S} slots with {n + 1} draws need {smem} B "
                         f"of shared memory a block, above {MAX_SHARED}")
    o_ts = torch.empty((R, n), dtype=torch.float32, device=dev)
    o_te = torch.empty((R, n), dtype=torch.float32, device=dev)
    o_mask = torch.empty((R, n), dtype=torch.bool, device=dev)
    u0, du = _bin_params(n + 1)
    err = lib.fine_resample_fwd(
        t_starts.data_ptr(), t_ends.data_ptr(), vals.data_ptr(),
        sdfs.data_ptr(), mask.data_ptr(), R, S, n + 1, u0, du,
        int(sdf_mode), o_ts.data_ptr(), o_te.data_ptr(), o_mask.data_ptr(),
        kernels.stream_ptr(dev))
    kernels.check(err, "fine_resample")
    kernels.launches["fine_resample"] += 1
    return FineResampleOut(o_ts, o_te, o_mask)


def sdf_fine_resample_rays(t_starts, t_ends, alphas, sdfs, mask,
                           n_samples: int) -> FineResampleOut:
    """``n_samples`` intervals per ray importance-sampled onward from the
    first SDF zero-crossing by the restarted transmittance CDF
    (`cdf_resampling_sdf_fine_kernel`, cdf.cu:537-638); rays without a
    crossing place nothing.  Inputs ``[R, S]``."""
    if t_starts.device.type == "cpu":
        return sdf_fine_resample_rays_plain(t_starts, t_ends, alphas, sdfs,
                                            mask, n_samples)
    return _launch_fine(t_starts, t_ends, alphas, sdfs, mask, n_samples, 1)


def fine_resample_rays(t_starts, t_ends, weights, mask,
                       n_samples: int) -> FineResampleOut:
    """Standard ``n_samples + 1``-point inverse-CDF interval resampling
    with the background bin (`cdf_resampling_fine_kernel`, cdf.cu:404-534).
    Inputs ``[R, S]``."""
    if t_starts.device.type == "cpu":
        return fine_resample_rays_plain(t_starts, t_ends, weights, mask,
                                        n_samples)
    return _launch_fine(t_starts, t_ends, weights, weights, mask, n_samples,
                        0)
