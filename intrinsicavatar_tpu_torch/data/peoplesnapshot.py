"""PeopleSnapshot dataset loader (copy of the JAX package's
``data/peoplesnapshot.py``, host-side numpy; frames read by
``utils/image_io.py``).

Per-frame pinhole rays, SMPL parameters from the AnimNeRF-refined pose
caches, foreground masks, ``t_idx = idx / n_frames`` for the temporal
occupancy grid, near/far from the camera-to-pelvis distance.

Layout on disk (produced by ``scripts/preprocess_peoplesnapshot.py``)::

    <root>/cameras.npz          intrinsic, extrinsic, height, width
    <root>/images/*.png
    <root>/masks/*.npy
    <root>/poses/anim_nerf_{split}.npz   (betas/body_pose/global_orient/transl)
"""

from __future__ import annotations

import glob
import os

import numpy as np

from intrinsicavatar_tpu_torch.data import register
from intrinsicavatar_tpu_torch.data.rays import make_rays, near_far_from_transl
from intrinsicavatar_tpu_torch.data.samplers import make_sampler
from intrinsicavatar_tpu_torch.utils.image_io import (
    read_any, read_png, resize_down,
)


def load_smpl_param(path):
    """An .npz of SMPL parameters as the batch's keys: split axis-angle
    keys (``body_pose``/``global_orient``) or the packed 72-dim ``thetas``
    (the root orientation first; `datasets/peoplesnapshot.py:36-47`)."""
    raw = np.load(str(path))
    out = {"betas": np.reshape(raw["betas"], (1, 10)).astype(np.float32),
           "transl": raw["transl"].astype(np.float32)}
    if "thetas" in raw.files:
        packed = raw["thetas"].astype(np.float32)
        out["global_orient"], out["body_pose"] = np.split(packed, [3], -1)
    else:
        out["global_orient"] = raw["global_orient"].astype(np.float32)
        out["body_pose"] = raw["body_pose"].astype(np.float32)
    return out


@register("peoplesnapshot")
class PeopleSnapshotDataset:
    """One split of a PeopleSnapshot subject.

    ``config`` carries dataroot/subject and the per-mode ``opt`` (start,
    end, skip, downscale, sampler); ``mode`` in {train, val, test}.
    """

    has_mask = True

    def __init__(self, config, split="train", mode="train", rng=None):
        self.config = config
        self.mode = mode
        root = config.get("dataroot", "./load/peoplesnapshot/") \
            .replace("${dataset.subject}", config.get("subject", ""))
        root = os.path.expanduser(root)
        self.root = root
        opt = config.get("opt", {}).get(mode, {})
        camera = np.load(os.path.join(root, "cameras.npz"))
        K = camera["intrinsic"].astype(np.float32).copy()
        c2w = np.linalg.inv(camera["extrinsic"]).astype(np.float32)
        H, W = int(camera["height"]), int(camera["width"])
        self.downscale = opt.get("downscale", 1)
        if self.downscale > 1:
            H, W = int(H / self.downscale), int(W / self.downscale)
            K[:2] /= self.downscale
        self.img_wh = (W, H)
        self.rays_o, self.rays_d = make_rays(K, c2w, H, W)

        start, end, skip = opt.get("start", 0), opt.get("end", 0) + 1, \
            opt.get("skip", 1)
        self.img_lists = sorted(glob.glob(f"{root}/images/*.png"))[
            start:end:skip]
        self.msk_lists = sorted(glob.glob(f"{root}/masks/*.npy"))[
            start:end:skip]

        cached = os.path.join(root, f"poses/anim_nerf_{split}.npz")
        if not os.path.exists(cached):
            cached = os.path.join(root, f"poses/{split}.npz")
        if os.path.exists(cached):
            self.smpl_params = load_smpl_param(cached)
        else:
            self.smpl_params = load_smpl_param(os.path.join(root, "poses.npz"))
            for k, v in self.smpl_params.items():
                if k != "betas":
                    self.smpl_params[k] = v[start:end:skip]

        self.n_frames = max(len(self.img_lists),
                            len(self.smpl_params["body_pose"]))
        self.sampler = (make_sampler(opt.get("sampler", {"name": "edge"}),
                                     rng=rng)
                        if mode == "train" else None)
        self.hdri_filepath = config.get("hdri_filepath", None)
        self._hdri = None

    def __len__(self):
        return self.n_frames

    @property
    def betas(self):
        return self.smpl_params["betas"][0]

    def pose_batch(self, idx):
        """SMPL-only batch (the occupancy re-init and animation)."""
        return {
            "index": np.asarray([idx]),
            "betas": self.smpl_params["betas"][0],
            "body_pose": self.smpl_params["body_pose"][idx],
            "global_orient": self.smpl_params["global_orient"][idx],
            "transl": self.smpl_params["transl"][idx],
        }

    def hdri(self):
        """The test HDRI of ``hdri_filepath``, read once."""
        if self._hdri is None:
            self._hdri = read_any(self.hdri_filepath).astype(np.float32)
        return self._hdri

    def __getitem__(self, idx):
        img = read_png(self.img_lists[idx])
        msk = np.load(self.msk_lists[idx])
        if self.downscale > 1:
            img = resize_down(img, self.downscale)
            msk = resize_down(msk, self.downscale)
        img = (img[..., :3] / 255.0).astype(np.float32)
        msk = msk.astype(np.float32)

        if self.sampler is not None:
            msk, img, rays_o, rays_d = self.sampler.sample(
                msk, img, self.rays_o, self.rays_d)
        else:
            rays_o = self.rays_o.reshape(-1, 3)
            rays_d = self.rays_d.reshape(-1, 3)
            img = img.reshape(-1, 3)
            msk = msk.reshape(-1)

        near, far = near_far_from_transl(
            self.smpl_params["transl"][idx], len(rays_d))
        rays = np.concatenate(
            [rays_o, rays_d, near[:, None], far[:, None]], -1)
        datum = {
            "rays": rays.astype(np.float32),
            "rgb": img,
            "alpha": msk,
            **self.pose_batch(idx),
            "t_idx": idx / self.n_frames,
        }
        if self.mode == "test" and self.hdri_filepath:
            datum["hdri"] = self.hdri()
        return datum

    def train_iter(self, rng=None):
        """Endless ``(batch, t_idx)`` of random frames, numpy arrays; frame
        indices from ``rng`` (seeded 0 by default, as the JAX iterator's)."""
        rng = rng or np.random.default_rng(0)
        while True:
            idx = int(rng.integers(0, len(self)))
            d = self[idx]
            t_idx = d.pop("t_idx")
            yield d, t_idx
