"""Synthetic dataset: generated poses, procedural targets (copy of the JAX
package's ``data/synthetic.py``, host-side numpy)."""

from __future__ import annotations

import os

import numpy as np

from intrinsicavatar_tpu_torch.data import register
from intrinsicavatar_tpu_torch.data.rays import near_far_from_transl


@register("synthetic")
class SyntheticDataset:
    has_mask = True

    def __init__(self, config, split="train", mode="train", rng=None):
        self.config = config
        self.rng = rng or np.random.default_rng(config.get("seed", 0))
        self.n_rays = config.get("n_rays", 1024)
        pose_path = config.get("pose_path", None)
        if pose_path and os.path.exists(pose_path):
            p = dict(np.load(pose_path))
            self.body_pose = p["body_pose"].astype(np.float32)
            self.global_orient = p["global_orient"].astype(np.float32)
            self.transl = p["transl"].astype(np.float32)
            self.betas_arr = p["betas"].astype(np.float32).reshape(-1)[:10]
        else:
            n = config.get("n_frames", 8)
            t = np.linspace(0, 2 * np.pi, n, endpoint=False)[:, None]
            freq = self.rng.uniform(0.5, 1.5, (1, 69))
            amp = self.rng.uniform(0.0, 0.25, (1, 69))
            self.body_pose = (amp * np.sin(freq * t)).astype(np.float32)
            self.global_orient = np.zeros((n, 3), np.float32)
            self.transl = np.tile(np.asarray([[0.0, 0.3, 2.0]], np.float32),
                                  (n, 1))
            self.betas_arr = np.zeros(10, np.float32)
        self.n_frames = len(self.body_pose)

    def __len__(self):
        return self.n_frames

    @property
    def betas(self):
        return self.betas_arr

    def pose_batch(self, idx):
        return {
            "index": np.asarray([idx]),
            "betas": self.betas_arr,
            "body_pose": self.body_pose[idx],
            "global_orient": self.global_orient[idx],
            "transl": self.transl[idx],
        }

    def __getitem__(self, idx):
        R = self.n_rays
        target = self.transl[idx] + self.rng.normal(scale=0.25, size=(R, 3))
        rays_o = np.zeros((R, 3), np.float32)
        rays_d = (target / np.linalg.norm(target, axis=-1, keepdims=True)
                  ).astype(np.float32)
        near, far = near_far_from_transl(self.transl[idx], R)
        rays = np.concatenate([rays_o, rays_d, near[:, None], far[:, None]],
                              -1).astype(np.float32)
        # procedural target: color by direction, alpha by angular distance
        center = self.transl[idx] / np.linalg.norm(self.transl[idx])
        cos = rays_d @ center
        alpha = (cos > np.quantile(cos, 0.4)).astype(np.float32)
        rgb = (0.5 + 0.5 * np.abs(rays_d)).astype(np.float32) * alpha[:, None]
        return {
            "rays": rays,
            "rgb": rgb,
            "alpha": alpha,
            **self.pose_batch(idx),
            "t_idx": idx / self.n_frames,
        }

    def train_iter(self, rng=None):
        """Endless ``(batch, t_idx)`` of random frames, numpy arrays; frame
        indices from ``rng`` (a numpy generator, seeded 1 by default, as
        the JAX iterator draws them)."""
        rng = rng or np.random.default_rng(1)
        while True:
            idx = int(rng.integers(0, len(self)))
            d = self[idx]
            t_idx = d.pop("t_idx")
            yield d, t_idx
