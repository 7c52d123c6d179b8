"""Pose encoder and per-frame pose correction (the defaults of the JAX
package's ``anim/pose.py``)."""

from __future__ import annotations

import torch
from torch import nn

from intrinsicavatar_tpu_torch.registry import register


@register("dummy_pose_encoder")
class DummyPoseEncoder(nn.Module):
    """Empty conditioning vector (the training default)."""

    n_output_dims = 0

    def __init__(self, config=None):
        super().__init__()

    def forward(self, rot_mats, joints):
        b = rot_mats.shape[0] if rot_mats is not None else 1
        dev = rot_mats.device if rot_mats is not None else None
        return torch.zeros((b, 0), dtype=torch.float32, device=dev)


@register("pose_correction")
class PoseCorrection(nn.Module):
    """Per-frame learnable SMPL-parameter residuals: zero (and gated off)
    until ``pose_correction_start_step``."""

    def __init__(self, config):
        super().__init__()
        n = config.get("dataset_length", 1)
        self.start_step = config.get("pose_correction_start_step", 4000)
        self.enable = config.get("enable_pose_correction", True)
        self.pose = nn.Parameter(torch.zeros(n, 69))
        self.global_orient = nn.Parameter(torch.zeros(n, 3))
        self.transl = nn.Parameter(torch.zeros(n, 3))
        self.betas = nn.Parameter(torch.zeros(1, 10))

    def active(self, global_step) -> bool:
        """The corrections enter the pose (and get a gradient) at this
        step: enabled and past ``pose_correction_start_step``."""
        return bool(self.enable) and global_step > self.start_step

    def forward(self, index, global_step=0):
        idx = torch.as_tensor(index, device=self.pose.device).reshape(-1)[:1]
        on = float(self.active(global_step))
        return {
            "betas_correction": self.betas * on,
            "global_orient_correction": self.global_orient[idx] * on,
            "transl_correction": self.transl[idx] * on,
            "pose_correction": self.pose[idx] * on,
        }
