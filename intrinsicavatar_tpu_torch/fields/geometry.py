"""Canonical SDF geometry field (counterpart of the JAX package's
``fields/geometry.py``): progressive hash-grid encoding + sphere-initialized
MLP; channel 0 of the output is the SDF.  The analytic SDF gradient runs
through the fused kernel KB (``ops/encode_grad.py``), whose backward KB'
keeps the training loss's gradient of the gradient first-order; the
curvature proxy is the PermutoSDF tangent-perturbation angle.  Inside a
bf16 compute scope (``ops/precision.py``) the encodes and the MLP read the
scope themselves: :meth:`VolumeSDF.features`, :meth:`sdf_grad_feature` and
:meth:`tangent_laplace` then gather bf16 rows and multiply bf16 operands."""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from intrinsicavatar_tpu_torch.nets.mlp import make_mlp
from intrinsicavatar_tpu_torch.ops.encode_grad import encode_mlp_sdfgrad
from intrinsicavatar_tpu_torch.ops.encoding import hashgrid_level_mask
from intrinsicavatar_tpu_torch.ops.hashgrid import (
    HashGridSpec, hashgrid_encode, init_hashgrid,
)
from intrinsicavatar_tpu_torch.ops.math import safe_normalize
from intrinsicavatar_tpu_torch.registry import register


def hashgrid_spec_from_config(cfg) -> HashGridSpec:
    return HashGridSpec(
        n_levels=cfg.get("n_levels", 16),
        n_features_per_level=cfg.get("n_features_per_level", 2),
        log2_hashmap_size=cfg.get("log2_hashmap_size", 19),
        base_resolution=cfg.get("base_resolution", 16),
        per_level_scale=cfg.get("per_level_scale", 1.447269237440378),
        include_xyz=cfg.get("include_xyz", False),
        xyz_scale=cfg.get("xyz_scale", 2.0),
        xyz_offset=cfg.get("xyz_offset", -1.0),
    )


def level_mask_from_config(spec: HashGridSpec, enc_cfg, step, device):
    return hashgrid_level_mask(
        step, n_levels=spec.n_levels,
        n_features_per_level=spec.n_features_per_level,
        start_level=enc_cfg.get("start_level", spec.n_levels),
        start_step=enc_cfg.get("start_step", 0),
        update_steps=enc_cfg.get("update_steps", 1),
        smooth=enc_cfg.get("update_mode", "non_smooth") == "smooth",
        full_band_step=enc_cfg.get("full_band_step", 5000), device=device)


class BBoxNormalized(nn.Module):
    """Canonical bbox, set once from the deformer (first call wins)."""

    def __init__(self):
        super().__init__()
        self.center = np.zeros(3, np.float32)
        self.scale = np.ones(3, np.float32)
        self._bbox_set = False

    def prepare_bbox(self, bbox):
        if self._bbox_set:
            return
        bbox = np.asarray(bbox, np.float32)
        self.center = (bbox[0] + bbox[1]) / 2.0
        self.scale = bbox[1] - bbox[0]
        self._bbox_set = True

    def _normalize(self, x):
        c = torch.as_tensor(self.center, device=x.device)
        s = torch.as_tensor(self.scale, device=x.device)
        return (x - c) / s + 0.5


@register("volume-sdf")
class VolumeSDF(BBoxNormalized):
    def __init__(self, config):
        super().__init__()
        self.config = config
        self.feature_dim = config.get("feature_dim", 13)
        self.enc_cfg = config.get("xyz_encoding_config", {})
        self.spec = hashgrid_spec_from_config(self.enc_cfg)
        self.mlp = make_mlp(self.spec.n_output_dims, self.feature_dim,
                            config.get("mlp_network_config", {}))
        self.table = nn.Parameter(torch.zeros(
            self.spec.n_levels, self.spec.table_size,
            self.spec.n_features_per_level))
        if float(config.get("sdf_bias", 0.0)) or \
                config.get("grad_type", "analytic") != "analytic":
            raise ValueError("sdf_bias and non-analytic grad_type are not "
                             "ported yet")

    @torch.no_grad()
    def init(self, generator: torch.Generator):
        self.table.copy_(init_hashgrid(self.spec, generator,
                                       self.table.device))
        self.mlp.init(generator)

    def level_mask(self, global_step, device):
        return level_mask_from_config(self.spec, self.enc_cfg, global_step,
                                      device)

    def features(self, x, level_mask=None):
        """``[N, 3] -> [N, feature_dim]``; channel 0 is the SDF."""
        enc = hashgrid_encode(self.table, self._normalize(x).contiguous(),
                              self.spec, level_mask)
        return self.mlp(enc)

    def sdf_grad_feature(self, x, level_mask=None):
        """``(sdf, grad, feature)`` with the analytic SDF gradient wrt the
        input points, from one fused encode + MLP pass (kernel KB)."""
        feat, grad_n = encode_mlp_sdfgrad(
            self.spec, self.mlp, self.table, self._normalize(x).contiguous(),
            level_mask)
        grad = grad_n / torch.as_tensor(self.scale, device=x.device)[None, :]
        return feat[:, 0], grad, feat

    def tangent_laplace(self, x, grad, level_mask, rand_u):
        """PermutoSDF curvature proxy (`fields/geometry.py:214-228` of the
        JAX package): the angle, over pi, between the normals at ``x`` and
        at ``x + 1e-4 * t``, with ``t`` the tangent ``normal x
        normalize(rand_u)``; ``rand_u [N, 3]`` holds U[0, 1) draws."""
        normal = safe_normalize(grad)
        tangent = torch.linalg.cross(normal, safe_normalize(rand_u), dim=-1)
        _, grad_d, _ = self.sdf_grad_feature(x + 1e-4 * tangent, level_mask)
        dot = torch.sum(normal * safe_normalize(grad_d), -1)
        return torch.arccos(torch.clamp(dot, -1.0 + 1e-6, 1.0 - 1e-6)) \
            / np.pi
