"""Default radiance field (counterpart of the JAX package's
``fields/radiance.py`` ``VolumeRefDirRadiance``): its own progressive hash
grid over canonical xyz (kernel KA) + SH(4) of the reflected view direction
with a progressive band mask.  Inside a bf16 compute scope the encode
gathers bf16 rows (KA's bf16-row form) and the MLP multiplies bf16
operands (``ops/precision.py``)."""

from __future__ import annotations

import torch
from torch import nn

from intrinsicavatar_tpu_torch.fields.geometry import (
    BBoxNormalized, hashgrid_spec_from_config, level_mask_from_config,
)
from intrinsicavatar_tpu_torch.nets.mlp import make_mlp
from intrinsicavatar_tpu_torch.ops.encoding import (
    sh_band_mask, spherical_harmonics,
)
from intrinsicavatar_tpu_torch.ops.hashgrid import (
    hashgrid_encode, init_hashgrid,
)
from intrinsicavatar_tpu_torch.ops.math import get_activation, reflect
from intrinsicavatar_tpu_torch.registry import register


@register("volume-ref-dir-radiance")
class VolumeRefDirRadiance(BBoxNormalized):
    """Color from (xyz features, geometry features, SH of
    ``reflect(-dirs, normals)``, normals)."""

    def __init__(self, config):
        super().__init__()
        self.config = config
        self.input_feature_dim = config.get("input_feature_dim", 16)
        self.enc_cfg = config.get("xyz_encoding_config", None)
        if not self.enc_cfg:
            raise ValueError("a radiance field without xyz encoding is not "
                             "ported yet")
        self.spec = hashgrid_spec_from_config(self.enc_cfg)
        self.color_activation = get_activation(config.get("color_activation"))
        self.sh_degree = config.get("dir_encoding_config", {}).get("degree", 4)
        self.sh_start_step = config.get("start_step", 0)
        self.sh_full_band_step = config.get("full_band_step", 1)
        self.n_input_dims = (self.input_feature_dim + self.sh_degree ** 2
                             + self.spec.n_output_dims)
        self.mlp = make_mlp(self.n_input_dims, 3,
                            config.get("mlp_network_config", {}))
        self.table = nn.Parameter(torch.zeros(
            self.spec.n_levels, self.spec.table_size,
            self.spec.n_features_per_level))

    @torch.no_grad()
    def init(self, generator: torch.Generator):
        self.table.copy_(init_hashgrid(self.spec, generator,
                                       self.table.device))
        self.mlp.init(generator)

    def level_mask(self, global_step, device):
        return level_mask_from_config(self.spec, self.enc_cfg, global_step,
                                      device)

    def sh_mask(self, global_step, device):
        return sh_band_mask(global_step, 4, self.sh_start_step,
                            self.sh_full_band_step, device=device)

    def encode(self, points, level_mask=None):
        """The xyz features alone (the JAX ``feature_only`` call)."""
        return hashgrid_encode(self.table,
                               self._normalize(points).contiguous(),
                               self.spec, level_mask)

    def forward(self, points, features, dirs, normals, level_mask=None,
                sh_mask=None):
        xyz_embd = self.encode(points, level_mask)
        ref = reflect(-dirs, normals)
        dirs_embd = spherical_harmonics(ref, self.sh_degree)
        if sh_mask is not None:
            dirs_embd = dirs_embd * sh_mask
        inp = torch.cat([xyz_embd, features, dirs_embd, normals], dim=-1)
        color = self.color_activation(self.mlp(inp))
        return color, xyz_embd
