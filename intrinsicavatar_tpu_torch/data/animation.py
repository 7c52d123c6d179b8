"""Animation (out-of-distribution pose) dataset: poses only, no images
(copy of the JAX package's ``data/animation.py``; the HDRI read by
``utils/image_io.py``).

Drives a trained avatar with novel motion (AIST, CAPE, ...): synthetic
intrinsics (f = 2000, the principal point at the image centre), identity
camera-to-world by default or per-frame extrinsics; betas from the caller
(the training subject) or the motion's ``poses.npz``; no rgb or mask.
"""

from __future__ import annotations

import json
import os

import numpy as np

from intrinsicavatar_tpu_torch.data import register
from intrinsicavatar_tpu_torch.data.peoplesnapshot import load_smpl_param
from intrinsicavatar_tpu_torch.data.rays import make_rays, near_far_from_transl
from intrinsicavatar_tpu_torch.utils.image_io import read_any


@register("animation")
class AnimationDataset:
    has_mask = False

    def __init__(self, config, split="test", mode="predict", betas=None,
                 rng=None):
        self.config = config
        root = config.get("dataroot", "./load/animation/aist")
        opt = config.get("opt", {}).get(mode, config.get("opt", {}))
        try:
            cameras = dict(np.load(os.path.join(root, "cameras.npz")))
        except FileNotFoundError:
            with open(os.path.join(root, "cameras.json")) as f:
                cameras = json.load(f)
            cameras["height"], cameras["width"] = 1024, 1024
        ext = np.asarray(cameras.get("extrinsic", np.eye(4)))
        self.per_frame_cams = ext.ndim == 3
        H = int(np.ravel(cameras["height"])[0])
        W = int(np.ravel(cameras["width"])[0])

        K = np.eye(3, dtype=np.float32)
        K[0, 0] = K[1, 1] = 2000.0
        K[0, 2] = H // 2
        K[1, 2] = W // 2
        self.downscale = opt.get("downscale", 1) if hasattr(opt, "get") else 1
        if self.downscale > 1:
            H, W = int(H / self.downscale), int(W / self.downscale)
            K[:2] /= self.downscale
        self.img_wh = (W, H)
        self.K = K
        self.cameras = cameras
        self.rays_o_cam, self.rays_d_cam = make_rays(K, np.eye(4), H, W)

        start = opt.get("start", 0)
        end = opt.get("end", -1)
        skip = opt.get("skip", 1)
        poses = load_smpl_param(os.path.join(root, "poses.npz"))
        sl = slice(start, None if end < 0 else end + 1, skip)
        self.body_pose = poses["body_pose"][sl]
        self.global_orient = poses["global_orient"][sl]
        self.transl = poses["transl"][sl]
        if self.per_frame_cams:
            self.extrinsics = ext[sl]
        # betas of the training subject (novel motion, the same body)
        self.betas_arr = (np.asarray(betas, np.float32).reshape(-1)[:10]
                          if betas is not None
                          else poses["betas"].reshape(-1)[:10])
        self.n_frames = len(self.body_pose)
        self.hdri_filepath = config.get("hdri_filepath", None)
        self._hdri = None

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
        if self.per_frame_cams:
            c2w = np.linalg.inv(self.extrinsics[idx]).astype(np.float32)
            rays_o = self.rays_o_cam.reshape(-1, 3) @ c2w[:3, :3].T \
                + c2w[:3, 3]
            rays_d = self.rays_d_cam.reshape(-1, 3) @ c2w[:3, :3].T
        else:
            rays_o = self.rays_o_cam.reshape(-1, 3)
            rays_d = self.rays_d_cam.reshape(-1, 3)
        near, far = near_far_from_transl(self.transl[idx], len(rays_d))
        rays = np.concatenate([rays_o, rays_d, near[:, None], far[:, None]],
                              -1).astype(np.float32)
        datum = {"rays": rays, **self.pose_batch(idx), "t_idx": 0.0}
        if self.hdri_filepath:
            if self._hdri is None:
                self._hdri = read_any(self.hdri_filepath).astype(np.float32)
            datum["hdri"] = self._hdri
        return datum
