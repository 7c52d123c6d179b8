"""Image metrics the render slices report (copies of the JAX package's
``masked_psnr`` and ``albedo_aligned_metrics``)."""

from __future__ import annotations

import numpy as np


def masked_psnr(pred: np.ndarray, gt: np.ndarray,
                mask: np.ndarray | None = None) -> float:
    """PSNR over masked pixels (`systems/criterions.py:43`)."""
    pred = np.asarray(pred, np.float64)
    gt = np.asarray(gt, np.float64)
    if mask is not None:
        m = np.asarray(mask, bool).reshape(-1)
        pred = pred.reshape(-1, pred.shape[-1])[m]
        gt = gt.reshape(-1, gt.shape[-1])[m]
    mse = np.mean((pred - gt) ** 2)
    return float(-10.0 * np.log10(np.maximum(mse, 1e-12)))


def albedo_aligned_metrics(pred_albedo, gt_albedo, mask):
    """Channel-aligned albedo PSNR and the per-channel least-squares scales
    (`models/utils.py:268-277`, `systems/intrinsic_avatar.py:598-611`)."""
    m = np.asarray(mask, bool).reshape(-1)
    p = np.asarray(pred_albedo).reshape(-1, 3)[m]
    g = np.asarray(gt_albedo).reshape(-1, 3)[m]
    scale = (g * p).sum(0) / np.maximum((p * p).sum(0), 1e-12)
    aligned = np.clip(np.asarray(pred_albedo) * scale, 0.0, 1.0)
    return masked_psnr(aligned.reshape(-1, 3)[m], g), scale
