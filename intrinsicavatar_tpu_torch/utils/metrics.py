"""Evaluation metrics (copies of the JAX package's ``utils/metrics.py``):
masked PSNR, bbox-cropped SSIM (Gaussian window, matching skimage's
``gaussian_weights=True, sigma=1.5, use_sample_covariance=False``),
bbox-cropped LPIPS-VGG (where its weights are given, ``utils/lpips.py``),
the mean angular normal error in degrees and the channel-aligned albedo
PSNR (`systems/criterions.py` of the reference)."""

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


def bbox_of_mask(mask: np.ndarray):
    ys, xs = np.where(np.asarray(mask) > 0)
    if len(ys) == 0:
        return 0, mask.shape[0], 0, mask.shape[1]
    return ys.min(), ys.max() + 1, xs.min(), xs.max() + 1


def _gaussian_window(size=11, sigma=1.5):
    x = np.arange(size) - size // 2
    g = np.exp(-(x**2) / (2 * sigma**2))
    g /= g.sum()
    return np.outer(g, g)


def ssim(img0: np.ndarray, img1: np.ndarray, data_range: float = 1.0) -> float:
    """Gaussian-window SSIM of an image pair ``[H, W, C]`` (skimage's
    ``structural_similarity(..., gaussian_weights=True, sigma=1.5,
    use_sample_covariance=False)``, as the reference evaluates it,
    `systems/criterions.py:83`)."""
    from scipy.signal import fftconvolve

    img0 = np.asarray(img0, np.float64)
    img1 = np.asarray(img1, np.float64)
    if img0.ndim == 2:
        img0 = img0[..., None]
        img1 = img1[..., None]
    win = _gaussian_window(11, 1.5)
    C1 = (0.01 * data_range) ** 2
    C2 = (0.03 * data_range) ** 2

    def filt(x):
        return np.stack([
            fftconvolve(x[..., c], win, mode="valid")
            for c in range(x.shape[-1])
        ], -1)

    mu0, mu1 = filt(img0), filt(img1)
    mu00, mu11, mu01 = mu0 * mu0, mu1 * mu1, mu0 * mu1
    s00 = filt(img0 * img0) - mu00
    s11 = filt(img1 * img1) - mu11
    s01 = filt(img0 * img1) - mu01
    num = (2 * mu01 + C1) * (2 * s01 + C2)
    den = (mu00 + mu11 + C1) * (s00 + s11 + C2)
    return float(np.mean(num / den))


def cropped_ssim(pred, gt, mask) -> float:
    """SSIM over the tight bbox of ``mask`` (`systems/criterions.py:83`)."""
    y0, y1, x0, x1 = bbox_of_mask(mask)
    return ssim(pred[y0:y1, x0:x1], gt[y0:y1, x0:x1])


def lpips_fn(path: str | None = None):
    """``f(pred, gt, mask=None) -> float``, LPIPS-VGG of two ``[H, W, 3]``
    images in [0, 1] over the bbox of ``mask`` (the port's own network,
    ``utils/lpips.py``, on the CPU), or None when no weights are given
    (``path`` or ``INTRINSICAVATAR_LPIPS_WEIGHTS``)."""
    from intrinsicavatar_tpu_torch.utils import lpips

    net = lpips.lpips_fn(path)
    if net is None:
        return None

    def compute(pred, gt, mask=None):
        if mask is not None:
            y0, y1, x0, x1 = bbox_of_mask(mask)
            pred, gt = pred[y0:y1, x0:x1], gt[y0:y1, x0:x1]
        return net(pred, gt)

    return compute


def normal_angular_error_deg(pred: np.ndarray, gt: np.ndarray,
                             mask: np.ndarray | None = None) -> float:
    """Mean angular error between unit normal maps, degrees
    (`systems/criterions.py:58`)."""
    pred = np.asarray(pred, np.float64)
    gt = np.asarray(gt, np.float64)
    pred = pred / np.maximum(np.linalg.norm(pred, axis=-1, keepdims=True),
                             1e-6)
    gt = gt / np.maximum(np.linalg.norm(gt, axis=-1, keepdims=True), 1e-6)
    cos = np.clip(np.sum(pred * gt, -1), -1.0, 1.0)
    ang = np.degrees(np.arccos(cos))
    if mask is not None:
        ang = ang[np.asarray(mask, bool)]
    return float(np.mean(ang))


def albedo_aligned_metrics(pred_albedo, gt_albedo, mask):
    """Channel-aligned albedo PSNR and the per-channel least-squares scales
    (`models/utils.py:268-277`, `systems/intrinsic_avatar.py:598-611`)."""
    m = np.asarray(mask, bool).reshape(-1)
    p = np.asarray(pred_albedo).reshape(-1, 3)[m]
    g = np.asarray(gt_albedo).reshape(-1, 3)[m]
    scale = (g * p).sum(0) / np.maximum((p * p).sum(0), 1e-12)
    aligned = np.clip(np.asarray(pred_albedo) * scale, 0.0, 1.0)
    return masked_psnr(aligned.reshape(-1, 3)[m], g), scale
