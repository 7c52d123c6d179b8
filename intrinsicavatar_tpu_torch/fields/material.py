"""Material field: a Lipschitz-MLP head over hybrid features (counterpart
of the JAX package's ``fields/material.py``, ``VolumeMaterial`` of the
reference's ``models/pbr/material.py:13-87``): sigmoid outputs mapped to
albedo (x 0.77 + 0.03), roughness (x 0.9 + 0.09) and metallic (x 1 + 0)."""

from __future__ import annotations

import torch
from torch import nn

from intrinsicavatar_tpu_torch.nets.mlp import LipschitzMLP, make_mlp
from intrinsicavatar_tpu_torch.ops.math import get_activation
from intrinsicavatar_tpu_torch.registry import register


@register("volume-material")
class VolumeMaterial(nn.Module):
    def __init__(self, config):
        super().__init__()
        self.n_output_dims = config.get("n_output_dim", 5)
        self.mlp = make_mlp(config.get("input_feature_dim", 48),
                            self.n_output_dims,
                            config.get("mlp_network_config", {}))
        self.activation = get_activation(config.get("material_activation"))
        self.scale = torch.tensor(
            [config.get("albedo_scale", 0.77)] * 3
            + [config.get("roughness_scale", 0.9)]
            + [config.get("metallic_scale", 1.0)] * (self.n_output_dims - 4))
        self.bias = torch.tensor(
            [config.get("albedo_bias", 0.03)] * 3
            + [config.get("roughness_bias", 0.09)]
            + [config.get("metallic_bias", 0.0)] * (self.n_output_dims - 4))

    def init(self, generator: torch.Generator):
        self.mlp.init(generator)

    def forward(self, features):
        """``[N, F] -> [N, n_output_dims]`` = (albedo x 3, roughness,
        metallic x k)."""
        raw = self.activation(self.mlp(features))
        return raw * self.scale.to(raw.device) + self.bias.to(raw.device)

    def lipschitz_bound(self):
        if isinstance(self.mlp, LipschitzMLP):
            return self.mlp.lipschitz_bound()
        return torch.zeros(())
