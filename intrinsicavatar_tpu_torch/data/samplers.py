"""Pixel/ray samplers (host-side numpy; a copy of the JAX package's
``data/samplers.py``).

Equivalents of `utils/sampler.py` (taconite/IntrinsicAvatar, adapted there
from InstantAvatar): EdgeSampler (the training default: 60% foreground /
30% mask-edge band / 10% random), UniformSampler, BalancedSampler,
PatchSampler.  The mask's erosion and dilation are ``cv2.erode`` /
``cv2.dilate`` with a square kernel of ones, which the JAX package runs
where ``cv2`` exists, by scipy's minimum and maximum filters: the same
window (for an even size too; scipy's ``grey_dilation``, the JAX package's
fallback, mirrors it) and, at the border, the same values.
"""

from __future__ import annotations

import numpy as np
from scipy.ndimage import maximum_filter, minimum_filter


def _erode(mask, k):
    return minimum_filter(mask, size=(k, k))


def _dilate(mask, k):
    return maximum_filter(mask, size=(k, k))


class EdgeSampler:
    def __init__(self, num_sample, ratio_mask=0.6, ratio_edge=0.3,
                 kernel_size=16, rng=None):
        if not (0.0 <= ratio_mask and 0.0 <= ratio_edge
                and ratio_edge + ratio_mask <= 1.0):
            raise ValueError(f"EdgeSampler: ratio_mask {ratio_mask} and "
                             f"ratio_edge {ratio_edge} must be >= 0 and sum "
                             f"to <= 1")
        self.kernel_size = kernel_size
        self.num_mask = int(num_sample * ratio_mask)
        self.num_edge = int(num_sample * ratio_edge)
        self.num_rand = num_sample - self.num_mask - self.num_edge
        self.rng = rng or np.random.default_rng()

    def sample(self, mask, *args):
        m = mask
        mask_i = _erode(m.astype(np.float32), self.kernel_size)
        mask_o = _dilate(m.astype(np.float32), self.kernel_size)
        mask_e = mask_o - mask_i
        flat = m.reshape(-1)
        mask_loc = np.where(flat)[0]
        edge_loc = np.where(mask_e.reshape(-1))[0]
        if len(mask_loc) == 0:
            mask_loc = np.arange(len(flat))
        if len(edge_loc) == 0:
            edge_loc = np.arange(len(flat))
        idx = np.concatenate([
            mask_loc[self.rng.integers(0, len(mask_loc), self.num_mask)],
            edge_loc[self.rng.integers(0, len(edge_loc), self.num_edge)],
            self.rng.integers(0, len(flat), self.num_rand),
        ])
        out = [flat[idx]]
        for d in args:
            out.append(d.reshape(len(flat), -1)[idx])
        return out


class UniformSampler:
    def __init__(self, num_sample, rng=None):
        self.num_rand = num_sample
        self.rng = rng or np.random.default_rng()

    def sample(self, mask, *args):
        flat = mask.reshape(-1)
        idx = self.rng.integers(0, len(flat), self.num_rand)
        out = [flat[idx]]
        for d in args:
            out.append(d.reshape(len(flat), -1)[idx])
        return out


class BalancedSampler:
    def __init__(self, num_sample, rng=None):
        self.num_fg = num_sample // 2
        self.num_bg = num_sample - self.num_fg
        self.rng = rng or np.random.default_rng()

    def sample(self, mask, *args):
        flat = mask.reshape(-1)
        fg = np.where(flat == 1)[0]
        bg = np.where(flat == 0)[0]
        if len(fg) == 0:
            fg = np.arange(len(flat))
        if len(bg) == 0:
            bg = np.arange(len(flat))
        idx = np.concatenate([
            self.rng.choice(fg, self.num_fg, replace=len(fg) <= self.num_fg),
            self.rng.choice(bg, self.num_bg, replace=len(bg) <= self.num_bg),
        ])
        out = [flat[idx]]
        for d in args:
            out.append(d.reshape(len(flat), -1)[idx])
        return out


class PatchSampler:
    def __init__(self, num_patch=4, patch_size=32, ratio_mask=0.9, dilate=0,
                 rng=None):
        if patch_size % 2:
            raise ValueError(f"PatchSampler: patch_size {patch_size} must "
                             f"be even")
        self.n = num_patch
        self.patch_size = patch_size
        self.p = ratio_mask
        self.dilate = dilate
        self.rng = rng or np.random.default_rng()

    def sample(self, mask, *args):
        ps = self.patch_size
        shape = mask.shape[:2]
        if self.rng.random() < self.p:
            o = ps // 2
            m = _dilate(mask, self.dilate) > 0 if self.dilate > 0 else mask
            xs, ys = np.where(m[o:-o, o:-o] > 0)
            if len(xs) == 0:
                xs = np.arange(shape[0] - ps)
                ys = np.zeros_like(xs)
            idx = self.rng.choice(len(xs), size=self.n,
                                  replace=len(xs) < self.n)
            x, y = xs[idx], ys[idx]
        else:
            x = self.rng.integers(0, shape[0] - ps, size=self.n)
            y = self.rng.integers(0, shape[1] - ps, size=self.n)
        out = []
        for d in [mask, *args]:
            patches = np.stack([d[xi:xi + ps, yi:yi + ps]
                                for xi, yi in zip(x, y)], 0)
            if patches.shape[-1] == 1:
                patches = patches.squeeze(-1)
            out.append(patches)
        return out


def make_sampler(config, rng=None):
    """The sampler ``config`` (``dataset.sampler``) names: ``edge`` (the
    default), ``uniform``, ``balanced`` or ``patch``."""
    name = config.get("name", "edge")
    n = config.get("num_sample", 4096)
    if name == "edge":
        return EdgeSampler(n, config.get("ratio_mask", 0.6),
                           config.get("ratio_edge", 0.3),
                           config.get("kernel_size", 16), rng=rng)
    if name == "uniform":
        return UniformSampler(n, rng=rng)
    if name == "balanced":
        return BalancedSampler(n, rng=rng)
    if name == "patch":
        return PatchSampler(config.get("num_patch", 4),
                            config.get("patch_size", 32),
                            config.get("ratio_mask", 0.9),
                            config.get("dilate", 0), rng=rng)
    raise ValueError(f"unknown sampler {name!r}")
