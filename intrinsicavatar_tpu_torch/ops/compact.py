"""Valid-first stable compaction into a static budget (counterpart of the
JAX package's ``ops/compact.py``).

:func:`compact_indices` and :func:`compact_indices_interleaved` launch
kernel KG (``csrc/compact.cu``) for CUDA tensors and take the plain twin
:func:`compact_indices_plain` only for CPU tensors.  The row gather and the
scatter back with fills around ``fn`` stay tensor indexing: plain data
movement, which the JAX op also leaves to XLA's gather and scatter.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from intrinsicavatar_tpu_torch import kernels

MAX_SAMPLES = 4096  # kMaxS of csrc/compact.cu: samples a ray, sample-major


def stable_partition_indices(mask: torch.Tensor) -> torch.Tensor:
    """Permutation putting True entries first, order preserved, along the
    last axis (rows are partitioned independently)."""
    return torch.argsort((~mask).to(torch.uint8), dim=-1, stable=True)


def compact_indices_plain(mask: torch.Tensor, budget: int,
                          sample_major: bool = False):
    """Plain twin of kernel KG.  ``mask`` is ``[M]``, or ``[R, S]`` with
    ``sample_major``: the order then runs over samples first and the indices
    returned are flat ray-major."""
    if not sample_major:
        idx = stable_partition_indices(mask)[:budget]
        return idx, mask[idx]
    R, S = mask.shape
    idx_sm, picked = compact_indices_plain(mask.T.reshape(-1), budget)
    return (idx_sm % R) * S + idx_sm // R, picked


def _compact(mask: torch.Tensor, budget: int, sample_major: bool):
    if mask.device.type == "cpu":
        return compact_indices_plain(mask, budget, sample_major)
    dev = mask.device
    kernels.require(mask, "mask", torch.bool, dev,
                    (None, None) if sample_major else (None,))
    R, S = mask.shape if sample_major else (mask.shape[0], 1)
    M = mask.numel()
    if not 0 <= budget <= M:
        raise ValueError(f"budget {budget} outside [0, {M}]")
    idx = torch.empty((budget,), dtype=torch.int64, device=dev)
    picked = torch.empty((budget,), dtype=torch.bool, device=dev)
    if budget == 0:
        return idx, picked
    lib = kernels.lib("compact")
    if sample_major and S > MAX_SAMPLES:
        raise ValueError(f"{S} samples a ray above the sample-major "
                         f"kernel's {MAX_SAMPLES}")
    # the count pass's per-block counts (per sample in sample-major order),
    # read by the scatter pass on the same stream
    counts = torch.empty(
        (lib.compact_counts_len(M, R, S, int(sample_major)),),
        dtype=torch.int32, device=dev)
    err = lib.compact_indices_fwd(
        mask.data_ptr(), M, R, S, int(sample_major), budget,
        counts.data_ptr(), idx.data_ptr(), picked.data_ptr(),
        kernels.stream_ptr(dev))
    kernels.check(err, "compact_indices")
    kernels.launches["compact_indices"] += 1
    return idx, picked


def compact_indices(mask: torch.Tensor, budget: int):
    """``(idx [budget], picked [budget])``: up to ``budget`` valid entries in
    valid-first stable order."""
    return _compact(mask, budget, False)


def compact_indices_interleaved(mask2d: torch.Tensor, budget: int):
    """Valid-first indices over a ``[R, S]`` mask in sample-major order, so
    budget overflow drops the far samples of every ray.  Returns flat
    ray-major ``(indices [budget], picked [budget])``."""
    return _compact(mask2d, budget, True)


def scatter_compacted(outs, idx, picked, M: int, fills: Sequence):
    """Scatter outputs computed on ``points[idx]`` back to ``[M, ...]``;
    slots not picked (or never gathered) get ``fills``."""
    results = []
    for o, fill in zip(outs, fills):
        fill_t = torch.as_tensor(fill, dtype=o.dtype, device=o.device)
        full = fill_t.expand(M, *o.shape[1:]).clone()
        keep = picked.reshape(-1, *([1] * (o.dim() - 1)))
        full[idx] = torch.where(keep, o, fill_t)
        results.append(full)
    return tuple(results)


def compact_apply(fn: Callable, points: torch.Tensor, mask: torch.Tensor,
                  budget: int, fills: Sequence, mask2d=None):
    """Apply ``fn`` to the compacted valid subset of ``points`` and scatter
    its outputs back to ``[M, ...]``; unevaluated slots get ``fills``.
    ``mask2d`` (the ``[R, S]`` view of ``mask``) selects sample-major
    order."""
    if mask2d is not None:
        idx, picked = compact_indices_interleaved(mask2d, budget)
    else:
        idx, picked = compact_indices(mask, budget)
    out = fn(points[idx])
    if not isinstance(out, (tuple, list)):
        out = (out,)
    return scatter_compacted(out, idx, picked, points.shape[0], fills)
