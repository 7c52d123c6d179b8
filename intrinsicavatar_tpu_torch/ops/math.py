"""Scalar/vector math used by the render slice (the subset of the JAX
package's ``ops/math.py`` that the path runs)."""

from __future__ import annotations

import math

import torch


def dot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Row-wise dot product, keepdims."""
    return torch.sum(x * y, dim=-1, keepdim=True)


def reflect(x: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Reflect direction ``x`` (pointing away from surface) about ``n``."""
    return 2.0 * dot(x, n) * n - x


def safe_normalize(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """``x / max(||x||, eps)`` along the last axis."""
    norm = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    return x / torch.clamp(norm, min=eps)


def linear_to_srgb(x: torch.Tensor) -> torch.Tensor:
    """Linear RGB -> sRGB (IEC 61966-2-1), clamped to [0, 1]."""
    srgb = torch.where(
        x > 0.0031308,
        torch.pow(torch.clamp(x, min=0.0031308), 1.0 / 2.4) * 1.055 - 0.055,
        12.92 * x,
    )
    return torch.clamp(srgb, 0.0, 1.0)


def get_activation(name):
    """String-keyed activation lookup (the names this slice's configs use)."""
    if name is None or str(name).lower() == "none":
        return lambda x: x
    name = str(name).lower()
    if name == "sigmoid":
        return torch.sigmoid
    if name == "relu":
        return torch.relu
    raise ValueError(f"activation {name!r} is not ported yet")


def rodrigues(rot_vecs: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Axis-angle ``[..., 3]`` -> rotation matrices ``[..., 3, 3]``."""
    angle = torch.linalg.vector_norm(rot_vecs + eps, dim=-1, keepdim=True)
    axis = rot_vecs / angle
    cos = torch.cos(angle)[..., None]
    sin = torch.sin(angle)[..., None]
    rx, ry, rz = axis[..., 0], axis[..., 1], axis[..., 2]
    zeros = torch.zeros_like(rx)
    K = torch.stack([zeros, -rz, ry, rz, zeros, -rx, -ry, rx, zeros],
                    dim=-1).reshape(*rot_vecs.shape[:-1], 3, 3)
    eye = torch.eye(3, dtype=rot_vecs.dtype, device=rot_vecs.device)
    outer = axis[..., :, None] * axis[..., None, :]
    return cos * eye + (1.0 - cos) * outer + sin * K


def transform_mat(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """``[..., 4, 4]`` transforms from ``R [..., 3, 3]`` and ``t [..., 3]``."""
    top = torch.cat([R, t[..., :, None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=R.dtype,
                          device=R.device).expand(*R.shape[:-2], 1, 4)
    return torch.cat([top, bottom], dim=-2)


def rigid_inverse(T: torch.Tensor) -> torch.Tensor:
    """Invert ``[..., 4, 4]`` rigid transforms analytically (R^T, -R^T t)."""
    Rt = T[..., :3, :3].transpose(-1, -2)
    ti = -torch.einsum("...ij,...j->...i", Rt, T[..., :3, 3])
    return transform_mat(Rt, ti)


def luminance(rgb: torch.Tensor) -> torch.Tensor:
    """Rec.709 luminance of linear RGB, ``[..., 3] -> [..., 1]``."""
    w = torch.tensor([0.2126, 0.7152, 0.0722], dtype=rgb.dtype,
                     device=rgb.device)
    return torch.sum(rgb * w, -1, keepdim=True)


def luma(rgb: torch.Tensor) -> torch.Tensor:
    """Rec.601 luma of the demodulated radiance, ``[..., 3] -> [..., 1]``."""
    w = torch.tensor([0.299, 0.587, 0.114], dtype=rgb.dtype,
                     device=rgb.device)
    return torch.sum(rgb * w, -1, keepdim=True)


def gaussian_histogram(x: torch.Tensor, bins: int, lo: float, hi: float,
                       sigma: torch.Tensor) -> torch.Tensor:
    """Soft (Gaussian-kernel) histogram ``[bins]`` of ``x`` flattened."""
    delta = float(hi - lo) / float(bins)
    centers = lo + delta * (torch.arange(bins, dtype=x.dtype,
                                         device=x.device) + 0.5)
    d = x.reshape(-1)[None, :] - centers[:, None]
    k = torch.exp(-0.5 * (d / sigma) ** 2) \
        / (sigma * math.sqrt(2.0 * math.pi)) * delta
    return torch.sum(k, 1)
