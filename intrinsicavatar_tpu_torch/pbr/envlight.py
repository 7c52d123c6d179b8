"""Environment lights with luminance-CDF importance sampling (counterpart
of the JAX package's ``pbr/envlight.py``): ``envlight-SG``, 64 spherical
Gaussians (the default), and ``envlight-tensor``, an HDR lat-long image
(the relighting emitter).  The MLP and NGP emitters are not ported yet.

Emitter protocol: ``forward(dirs) -> [N, 3]`` world-space radiance;
``update_pdf() -> EnvPdfState``; ``sample(state, u [n, 4]) -> dirs`` with
``u`` the U[0, 1) draws (row, column, two texel jitters) that the JAX
emitter draws from its key; ``pdf(state, dirs) -> [N, 1]`` solid-angle pdf.
Lat-long convention: ``v = acos(y) / pi`` rows, ``u = atan2(x, -z) /
(2 pi) + 0.5`` columns; ``xyz2lonlat_mode: blender`` is z-up.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from intrinsicavatar_tpu_torch.nets.mlp import softplus
from intrinsicavatar_tpu_torch.registry import register


def luminance(rgb: torch.Tensor) -> torch.Tensor:
    """Rec.709 luminance of linear RGB, ``[..., 3] -> [..., 1]``."""
    w = torch.tensor([0.2126, 0.7152, 0.0722], dtype=rgb.dtype,
                     device=rgb.device)
    return torch.sum(rgb * w, -1, keepdim=True)


def xyz_to_uv(dirs: torch.Tensor, mode=None):
    """Unit directions -> lat-long ``(u, v)`` in [0, 1]."""
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    if mode == "blender":
        up, lon = z, torch.atan2(y, x)
    else:
        up, lon = y, torch.atan2(x, -z)
    v = torch.arccos(torch.clamp(up, -1.0, 1.0)) / math.pi
    u = lon / (2.0 * math.pi) + 0.5
    return u, v


def uv_to_xyz(u: torch.Tensor, v: torch.Tensor, mode=None):
    theta = v * math.pi
    lon = (u - 0.5) * 2.0 * math.pi
    st = torch.sin(theta)
    if mode == "blender":
        return torch.stack([st * torch.cos(lon), st * torch.sin(lon),
                            torch.cos(theta)], -1)
    return torch.stack([st * torch.sin(lon), torch.cos(theta),
                        -st * torch.cos(lon)], -1)


def bilinear_sample(img: torch.Tensor, u: torch.Tensor, v: torch.Tensor):
    """Bilinear lookup of ``img [H, W, C]`` at continuous ``(u, v)``; u
    wraps, v clamps."""
    H, W = img.shape[:2]
    x = u * W - 0.5
    y = torch.clamp(v * H - 0.5, 0.0, H - 1.0)
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = (x - x0)[..., None], (y - y0)[..., None]
    x0i = torch.remainder(x0.to(torch.int64), W)
    x1i = torch.remainder(x0i + 1, W)
    y0i = torch.clamp(y0.to(torch.int64), 0, H - 1)
    y1i = torch.clamp(y0i + 1, 0, H - 1)
    a, b = img[y0i, x0i], img[y0i, x1i]
    c, d = img[y1i, x0i], img[y1i, x1i]
    return (a * (1 - fx) + b * fx) * (1 - fy) + (c * (1 - fx) + d * fx) * fy


class EnvPdfState(NamedTuple):
    """2D luminance CDF tables for lat-long importance sampling."""

    marginal_cdf: torch.Tensor     # [H] CDF over rows
    conditional_cdf: torch.Tensor  # [H, W] CDF over columns per row
    pdf_image: torch.Tensor        # [H, W] probability per texel
    pdf_scale: float               # H * W / (2 pi^2)


def build_pdf(image: torch.Tensor) -> EnvPdfState:
    """Sampling tables of ``image [H, W, 3]`` (luminance x sin(theta))."""
    H, W = image.shape[:2]
    lum = luminance(image)[..., 0]
    v = (torch.arange(H, dtype=image.dtype, device=image.device) + 0.5) / H
    w = torch.clamp(lum, min=0.0) * torch.sin(v * math.pi)[:, None] + 1e-12
    p = w / torch.sum(w)
    row_p = torch.sum(p, 1)
    return EnvPdfState(
        marginal_cdf=torch.cumsum(row_p, 0),
        conditional_cdf=torch.cumsum(p / row_p[:, None], 1),
        pdf_image=p, pdf_scale=H * W / (2.0 * math.pi ** 2))


def sample_from_pdf(state: EnvPdfState, u: torch.Tensor, mode=None):
    """Directions by the tables from ``u [n, 4]`` U[0, 1) draws (row,
    column, texel jitter in u, in v)."""
    H, W = state.pdf_image.shape
    row = torch.clamp(torch.searchsorted(state.marginal_cdf,
                                         u[:, 0].contiguous()), 0, H - 1)
    col = torch.searchsorted(state.conditional_cdf[row],
                             u[:, 1:2].contiguous())[:, 0]
    col = torch.clamp(col, 0, W - 1)
    uu = (col.to(u.dtype) + u[:, 2]) / W
    vv = (row.to(u.dtype) + u[:, 3]) / H
    return uv_to_xyz(uu, vv, mode)


def pdf_of_dirs(state: EnvPdfState, dirs: torch.Tensor, mode=None):
    """Solid-angle pdf ``[N, 1]`` of directions under the tables."""
    H, W = state.pdf_image.shape
    u, v = xyz_to_uv(dirs, mode)
    col = torch.clamp((u * W).to(torch.int64), 0, W - 1)
    row = torch.clamp((v * H).to(torch.int64), 0, H - 1)
    p = state.pdf_image[row, col]
    sin_theta = torch.clamp(torch.sin(v * math.pi), min=1e-6)
    return (p * state.pdf_scale / sin_theta)[..., None]


def sample_uniform_sphere_stratified(ju: torch.Tensor, jv: torch.Tensor):
    """Stratified uniform sphere directions ``[n1 * n2, 3]`` over (cos
    theta, phi), y up, from the jitters ``ju, jv [n1, n2]``, and the
    inverse pdf 4 pi (reference call site `models/intrinsic_avatar.py:
    677-687`, 16 x 32)."""
    n1, n2 = ju.shape
    i = torch.arange(n1, dtype=ju.dtype, device=ju.device)
    j = torch.arange(n2, dtype=ju.dtype, device=ju.device)
    ct = 1.0 - 2.0 * (i[:, None] + ju) / n1
    phi = 2.0 * math.pi * (j[None, :] + jv) / n2
    st = torch.sqrt(torch.clamp(1.0 - ct ** 2, min=0.0))
    dirs = torch.stack([st * torch.cos(phi), ct.expand_as(st),
                        st * torch.sin(phi)], -1)
    inv_pdf = torch.full((n1 * n2, 1), 4.0 * math.pi, dtype=ju.dtype,
                         device=ju.device)
    return dirs.reshape(-1, 3), inv_pdf


class _EmitterBase(nn.Module):
    def __init__(self, config):
        super().__init__()
        self.mode = config.get("xyz2lonlat_mode", None)
        self.base_res = config.get("envlight_config", {}).get("base_res", 256)

    def update_pdf(self) -> EnvPdfState:
        return build_pdf(self.generate_image())

    def sample(self, state: EnvPdfState, u: torch.Tensor):
        return sample_from_pdf(state, u, self.mode)

    def pdf(self, state: EnvPdfState, dirs):
        return pdf_of_dirs(state, dirs, self.mode)


@register("envlight-tensor")
class EnvLightTensor(_EmitterBase):
    """HDR image emitter, ``base [H, 2H, 3]``; for relighting the base is
    replaced by the evaluation HDRI (`models/intrinsic_avatar.py:292-305`).
    """

    def __init__(self, config):
        super().__init__(config)
        ec = config.get("envlight_config", {})
        self.scale, self.bias = ec.get("scale", 0.5), ec.get("bias", 0.25)
        self.base = nn.Parameter(torch.zeros(self.base_res,
                                             2 * self.base_res, 3))

    @torch.no_grad()
    def init(self, generator: torch.Generator):
        u = torch.rand(self.base.shape, generator=generator)
        self.base.copy_((u * self.scale + self.bias).to(self.base.device))

    def forward(self, dirs):
        u, v = xyz_to_uv(dirs, self.mode)
        return torch.clamp(bilinear_sample(self.base, u, v), min=0.0)

    def generate_image(self):
        return torch.clamp(self.base, min=0.0)


@register("envlight-SG")
class EnvLightSG(_EmitterBase):
    """Spherical-Gaussian mixture ``L(d) = sum_i |a_i| exp(lambda_i (d .
    mu_i - 1))`` (`configs/light/envlight_SG.yaml`: 64 lobes), axes on a
    Fibonacci sphere."""

    def __init__(self, config):
        super().__init__(config)
        n = config.get("envlight_config", {}).get("num_SGs", 64)
        self.axes = nn.Parameter(torch.zeros(n, 3))
        self.sharpness = nn.Parameter(torch.zeros(n, 1))
        self.amplitude = nn.Parameter(torch.zeros(n, 3))

    @torch.no_grad()
    def init(self, generator: torch.Generator):
        n = self.axes.shape[0]
        i = np.arange(n, dtype=np.float32)
        phi = np.pi * (3.0 - np.sqrt(5.0)) * i
        y = 1.0 - 2.0 * (i + 0.5) / n
        r = np.sqrt(np.maximum(1.0 - y * y, 0.0))
        axes = np.stack([r * np.cos(phi), y, r * np.sin(phi)], -1)
        dev = self.axes.device
        self.axes.copy_(torch.as_tensor(axes, dtype=torch.float32).to(dev))
        self.sharpness.fill_(float(np.float32(np.log(np.expm1(10.0)))))
        amp = torch.rand(self.amplitude.shape, generator=generator)
        self.amplitude.copy_((amp * 0.5 + 0.25).to(dev))

    def forward(self, dirs):
        mu = self.axes / torch.clamp(
            torch.linalg.vector_norm(self.axes, dim=-1, keepdim=True),
            min=1e-6)
        lam = softplus(self.sharpness)
        w = torch.exp(lam[None, :, 0] * (dirs @ mu.T - 1.0))
        return w @ torch.abs(self.amplitude)

    def generate_image(self):
        H, W = self.base_res, 2 * self.base_res
        dev = self.axes.device
        v = (torch.arange(H, device=dev) + 0.5) / H
        u = (torch.arange(W, device=dev) + 0.5) / W
        uu, vv = torch.meshgrid(u, v, indexing="xy")
        dirs = uv_to_xyz(uu.reshape(-1), vv.reshape(-1), self.mode)
        return self(dirs).reshape(H, W, 3)
