"""Surface BRDFs (counterpart of the JAX package's ``pbr/brdf.py``):
``brdf-lambertian``, ``brdf-ggx`` and ``brdf-multi-lobe`` (the default:
Lambertian diffuse + GGX specular with Fresnel-Schlick, F0 = mix(0.04,
albedo, metallic)).  The SGGX phase functions and the mirror are not ported
yet.

Over ``[N]`` batches in SMPL space, ``wi`` toward the camera and ``wo``
toward the light:

  ``sample(n, wi, alpha_x, alpha_y, albedo, metallic, atten, u) -> wo``,
  ``pdf(n, wi, wo, ...) -> [N, 1]``,
  ``eval(n, wi, wo, ...) -> (diff [N, 1], spec [N, 3])``,

``diff``/``spec`` with the cosine foreshortening.  ``u [N, 5]`` holds the
U[0, 1) draws the JAX scatterer draws from its key: two for the cosine
lobe, two for the GGX half-vector, one for the lobe choice.
"""

from __future__ import annotations

import math

import torch

from intrinsicavatar_tpu_torch.ops.math import dot, reflect, safe_normalize
from intrinsicavatar_tpu_torch.registry import register

EPS = 1e-7


def _onb(n):
    """Orthonormal tangents ``(t, b)`` around unit normals (Frisvad)."""
    nx, ny, nz = n[..., 0:1], n[..., 1:2], n[..., 2:3]
    sign = torch.where(nz >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + nz)
    b = nx * ny * a
    t = torch.cat([1.0 + sign * nx ** 2 * a, sign * b, -sign * nx], -1)
    bt = torch.cat([b, sign + ny ** 2 * a, -ny], -1)
    return t, bt


def _to_world(n, local):
    t, b = _onb(n)
    return local[..., 0:1] * t + local[..., 1:2] * b + local[..., 2:3] * n


def cosine_sample(n, u):
    """Cosine-weighted directions about ``n`` from ``u [N, 2]``."""
    u1, u2 = u[..., 0:1], u[..., 1:2]
    r = torch.sqrt(u1)
    phi = 2.0 * math.pi * u2
    local = torch.cat([r * torch.cos(phi), r * torch.sin(phi),
                       torch.sqrt(torch.clamp(1.0 - u1, min=0.0))], -1)
    return _to_world(n, local)


def _ggx_d(n_dot_h, alpha):
    a2 = alpha * alpha
    d = n_dot_h * n_dot_h * (a2 - 1.0) + 1.0
    return a2 / torch.clamp(math.pi * d * d, min=EPS)


def _smith_g1(n_dot_v, alpha):
    a2 = alpha * alpha
    return 2.0 * n_dot_v / torch.clamp(
        n_dot_v + torch.sqrt(a2 + (1.0 - a2) * n_dot_v * n_dot_v), min=EPS)


def ggx_sample_h(n, alpha, u):
    """GGX half-vectors about ``n`` from ``u [N, 2]``."""
    u1, u2 = u[..., 0:1], u[..., 1:2]
    a2 = alpha[..., None] ** 2
    ct = torch.sqrt(torch.clamp((1.0 - u1) / (1.0 + (a2 - 1.0) * u1),
                                0.0, 1.0))
    st = torch.sqrt(torch.clamp(1.0 - ct * ct, min=0.0))
    phi = 2.0 * math.pi * u2
    local = torch.cat([st * torch.cos(phi), st * torch.sin(phi), ct], -1)
    return _to_world(n, local)


def _fresnel_schlick(cos, f0):
    return f0 + (1.0 - f0) * torch.pow(torch.clamp(1.0 - cos, 0.0, 1.0),
                                       5.0)


def _f0(albedo, metallic):
    if metallic.shape[-1] == 3:
        return metallic        # volume mode: specular albedo directly
    return 0.04 * (1.0 - metallic) + albedo * metallic


@register("brdf-lambertian")
class Lambertian:
    def __init__(self, config=None):
        self.config = config

    def sample(self, n, wi, alpha_x, alpha_y, albedo, metallic, atten, u):
        return cosine_sample(n, u[..., 0:2])

    def pdf(self, n, wi, wo, alpha_x, alpha_y, albedo, metallic, atten):
        return torch.clamp(dot(n, wo), min=0.0) / math.pi

    def eval(self, n, wi, wo, alpha_x, alpha_y, albedo, metallic, atten):
        diff = torch.clamp(dot(n, wo), min=0.0) / math.pi
        return diff, torch.zeros((*wo.shape[:-1], 3), dtype=wo.dtype,
                                 device=wo.device)


@register("brdf-ggx")
class GGX:
    def __init__(self, config=None):
        self.config = config

    def sample(self, n, wi, alpha_x, alpha_y, albedo, metallic, atten, u):
        return reflect(wi, ggx_sample_h(n, alpha_x, u[..., 2:4]))

    def pdf(self, n, wi, wo, alpha_x, alpha_y, albedo, metallic, atten):
        h = safe_normalize(wi + wo)
        n_dot_h = torch.clamp(dot(n, h), min=0.0)
        pdf_h = _ggx_d(n_dot_h, alpha_x[..., None]) * n_dot_h
        return pdf_h / torch.clamp(4.0 * torch.abs(dot(wo, h)), min=EPS)

    def eval(self, n, wi, wo, alpha_x, alpha_y, albedo, metallic, atten):
        h = safe_normalize(wi + wo)
        n_dot_i = torch.clamp(dot(n, wi), min=0.0)
        n_dot_o = torch.clamp(dot(n, wo), min=0.0)
        n_dot_h = torch.clamp(dot(n, h), min=0.0)
        alpha = alpha_x[..., None]
        D = _ggx_d(n_dot_h, alpha)
        G = _smith_g1(torch.clamp(n_dot_i, min=EPS), alpha) * _smith_g1(
            torch.clamp(n_dot_o, min=EPS), alpha)
        F = _fresnel_schlick(torch.clamp(dot(h, wo), min=0.0),
                             _f0(albedo, metallic))
        # D G F / (4 n.wi n.wo) * n.wo: with the cosine foreshortening
        spec = D * G * F / torch.clamp(4.0 * n_dot_i, min=EPS)
        facing = ((n_dot_i > 0) & (n_dot_o > 0)).to(wo.dtype)
        return torch.zeros_like(n_dot_o), spec * facing


@register("brdf-multi-lobe")
class MultiLobe:
    """Lambertian + GGX (`configs/scatterer/brdf-multi-lobe.yaml`): sampling
    picks either lobe with probability 1/2; the pdf is the mixture."""

    def __init__(self, config=None):
        self.config = config
        self._ggx = GGX(config)
        self._lam = Lambertian(config)

    def sample(self, n, wi, alpha_x, alpha_y, albedo, metallic, atten, u):
        wo_d = cosine_sample(n, u[..., 0:2])
        wo_s = reflect(wi, ggx_sample_h(n, alpha_x, u[..., 2:4]))
        return torch.where(u[..., 4:5] < 0.5, wo_s, wo_d)

    def pdf(self, n, wi, wo, alpha_x, alpha_y, albedo, metallic, atten):
        args = (n, wi, wo, alpha_x, alpha_y, albedo, metallic, atten)
        return 0.5 * (self._lam.pdf(*args) + self._ggx.pdf(*args))

    def eval(self, n, wi, wo, alpha_x, alpha_y, albedo, metallic, atten):
        args = (n, wi, wo, alpha_x, alpha_y, albedo, metallic, atten)
        return self._lam.eval(*args)[0], self._ggx.eval(*args)[1]
