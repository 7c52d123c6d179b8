"""Synthetic-image dataset: the sphere-traced capsule body as ground truth
(a copy of the JAX package's ``data/capsule.py``, host-side numpy).

The articulated capsule body that the synthetic SMPL stand-in samples its
surface from (``anim/smpl.py:make_synthetic_body_model``) is rendered as
ground truth by a renderer independent of the model: direct sphere tracing
of the posed union-of-capsules SDF with Lambertian shading, a per-bone
albedo and a fixed light.  Training then solves a real inverse problem
(geometry, radiance and materials from posed images) with exact masks,
normals and albedo for the metrics: the stand-in for the PeopleSnapshot
protocol (its batch contract, with the ``albedo`` / ``normal`` keys of
RANA / SyntheticHuman).

Poses come from a PeopleSnapshot pose cache where ``pose_path`` names one
that exists, else from smooth synthetic trajectories (said once on
stderr).  The posed joints come from the port's ``smpl_forward`` on the
CPU.
"""

from __future__ import annotations

import os
import warnings

import numpy as np

from intrinsicavatar_tpu_torch.anim.smpl import PARENTS
from intrinsicavatar_tpu_torch.data import register
from intrinsicavatar_tpu_torch.data.rays import make_rays, near_far_from_transl
from intrinsicavatar_tpu_torch.utils.image_io import read_any


def capsule_spec():
    """Bone capsules matching ``make_synthetic_body_model``: (child j,
    parent p) segments with radius ``radii[j]``."""
    radii = np.full(24, 0.06, np.float32)
    radii[[0, 3, 6, 9]] = 0.12
    radii[15] = 0.09
    radii[[22, 23]] = 0.035
    bones = [(j, int(PARENTS[j])) for j in range(1, 24)]
    return bones, radii


def bone_albedos(seed: int = 7) -> np.ndarray:
    """Fixed per-bone linear-RGB albedo palette ``[23, 3]``."""
    rng = np.random.default_rng(seed)
    return rng.uniform(0.15, 0.8, size=(23, 3)).astype(np.float32)


def procedural_hdri(height: int = 64, seed: int = 11) -> np.ndarray:
    """Held-out test environment map ``[H, 2H, 3]`` (lat-long, linear HDR):
    a sky gradient, a warm sun disk and a dim ground bounce, the stand-in
    for RANA's held-out ``.hdr`` files; deterministic in ``seed``."""
    H, W = height, 2 * height
    rng = np.random.default_rng(seed)
    theta = (np.arange(H) + 0.5) / H * np.pi            # 0 = up
    phi = (np.arange(W) + 0.5) / W * 2.0 * np.pi
    t, p = np.meshgrid(theta, phi, indexing="ij")
    up = np.cos(t)
    # sky: blue-white gradient toward the horizon
    sky_top = np.asarray([0.35, 0.55, 1.0])
    sky_hor = np.asarray([0.9, 0.85, 0.8])
    w = np.clip(up, 0.0, 1.0)[..., None]
    img = w * sky_top + (1.0 - w) * sky_hor
    # ground: dim neutral bounce
    ground = np.asarray([0.18, 0.16, 0.14]) * (1.0 + 0.3 * -up[..., None])
    img = np.where(up[..., None] < 0.0, ground, img)
    # sun: warm disk at a random azimuth, 30-50 deg elevation
    sun_t = rng.uniform(np.deg2rad(40), np.deg2rad(60))
    sun_p = rng.uniform(0.0, 2.0 * np.pi)
    sd = (np.sin(sun_t) * np.cos(sun_p), np.cos(sun_t),
          np.sin(sun_t) * np.sin(sun_p))
    d = np.stack([np.sin(t) * np.cos(p), np.cos(t), np.sin(t) * np.sin(p)],
                 -1)
    cosang = d @ np.asarray(sd)
    img = img + np.asarray([18.0, 15.0, 10.0]) * np.clip(
        (cosang - np.cos(np.deg2rad(4))) / (1 - np.cos(np.deg2rad(4))),
        0.0, 1.0)[..., None]
    return img.astype(np.float32)


def _capsule_dist(p, a, b, r):
    """Unsigned distance from points ``p [N, 3]`` to the capsule (a, b, r)."""
    ab = b - a
    denom = float(ab @ ab) + 1e-12
    t = np.clip(((p - a) @ ab) / denom, 0.0, 1.0)
    c = a + t[:, None] * ab
    return np.linalg.norm(p - c, axis=-1) - r


def render_capsule_body(joints, rays_o, rays_d, light_dir=(0.3, 0.8, -0.5),
                        ambient=0.35, n_steps=64, hit_eps=1e-3,
                        max_t=6.0, albedos=None):
    """Sphere-trace the posed capsule union; returns the GT maps.

    Args:
      joints: ``[24, 3]`` posed joint positions (world).
      rays_o, rays_d: ``[N, 3]``.
    Returns a dict of numpy arrays: ``rgb`` (sRGB in [0, 1], black
    background), ``alpha`` [N], ``albedo`` (linear, foreground only),
    ``normal`` (world, unit), ``depth``.
    """
    bones, radii = capsule_spec()
    if albedos is None:
        albedos = bone_albedos()
    N = rays_o.shape[0]
    caps = [(joints[p], joints[j], float(radii[j])) for (j, p) in bones]

    # prune rays against the body's bounding sphere and start marching at
    # the sphere's entry: only ~15-25% of a frame's rays ever touch it
    center = joints.mean(0)
    brad = float(np.linalg.norm(joints - center, axis=-1).max()
                 + radii.max() + 0.05)
    oc = rays_o - center
    b_ = np.einsum("nd,nd->n", oc, rays_d)
    c_ = np.einsum("nd,nd->n", oc, oc) - brad * brad
    disc = b_ * b_ - c_
    active = disc > 0.0
    t_entry = np.where(active, np.maximum(-b_ - np.sqrt(np.maximum(disc, 0.0)),
                                          0.0), max_t)
    ai = np.where(active)[0]
    ro, rd = rays_o[ai], rays_d[ai]

    def sdf(p):
        d = np.full(p.shape[0], np.inf, np.float32)
        idx = np.zeros(p.shape[0], np.int32)
        for k, (a, b, r) in enumerate(caps):
            dk = _capsule_dist(p, a, b, r)
            closer = dk < d
            d = np.where(closer, dk, d)
            idx = np.where(closer, k, idx)
        return d, idx

    t = t_entry[ai].astype(np.float32)
    for _ in range(n_steps):
        p = ro + t[:, None] * rd
        d, _ = sdf(p)
        t = np.minimum(t + np.maximum(d, 0.0), max_t)
    p = ro + t[:, None] * rd
    d, bone_id = sdf(p)
    hit_a = (d < hit_eps) & (t < max_t - 1e-3)

    # finite-difference normal at the hit points
    eps = 1e-3
    n_a = np.zeros((len(ai), 3), np.float32)
    for ax in range(3):
        dp = np.zeros(3, np.float32)
        dp[ax] = eps
        n_a[:, ax] = sdf(p + dp)[0] - sdf(p - dp)[0]
    norm = np.maximum(np.linalg.norm(n_a, axis=-1, keepdims=True), 1e-9)
    n_a = n_a / norm

    l = np.asarray(light_dir, np.float32)
    l = l / np.linalg.norm(l)
    albedo_a = albedos[np.clip(bone_id, 0, len(caps) - 1)]
    shade = ambient + (1.0 - ambient) * np.clip(n_a @ l, 0.0, None)
    rgb_lin = albedo_a * shade[:, None]
    srgb = np.where(rgb_lin <= 0.0031308, rgb_lin * 12.92,
                    1.055 * np.clip(rgb_lin, 1e-8, None) ** (1 / 2.4) - 0.055)

    def scatter(v_a, width):
        out = np.zeros((N, width), np.float32)
        out[ai] = v_a
        return out

    fg_a = hit_a[:, None].astype(np.float32)
    hit = np.zeros(N, bool)
    hit[ai] = hit_a
    t_full = np.zeros(N, np.float32)
    t_full[ai] = t
    return {
        "rgb": scatter(np.clip(srgb, 0.0, 1.0) * fg_a, 3),
        "alpha": hit.astype(np.float32),
        "albedo": scatter(albedo_a * fg_a, 3),
        "normal": scatter(n_a * fg_a, 3),
        "depth": np.where(hit, t_full, 0.0).astype(np.float32),
    }


def posed_joints(betas, body_pose, global_orient, transl) -> np.ndarray:
    """``[F, 24, 3]`` posed joints of the synthetic body, frame by frame,
    from the port's ``smpl_forward`` on the CPU in float32."""
    import torch

    from intrinsicavatar_tpu_torch.anim.smpl import (
        make_synthetic_body_model, smpl_forward,
    )

    body = make_synthetic_body_model()
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32))
    with torch.no_grad():
        return np.stack([
            smpl_forward(body, t(betas), t(body_pose[i]),
                         global_orient=t(global_orient[i]),
                         transl=t(transl[i])).joints[0].numpy()
            for i in range(len(body_pose))])


@register("synthetic-image")
class CapsuleImageDataset:
    """Posed capsule-body images and masks (and GT albedo and normals).

    Interface of the PeopleSnapshot loader: ``__getitem__`` yields the
    batch (sampled rays in train mode, whole frames otherwise) as numpy
    arrays, ``train_iter`` streams ``(batch, t_idx)``.
    """

    has_mask = True

    def __init__(self, config, split="train", mode="train", rng=None):
        self.config = config
        self.split = split
        self.mode = mode
        self.rng = rng or np.random.default_rng(config.get("seed", 0))
        W = H = int(config.get("image_size", 256))
        self.img_wh = (W, H)

        pose_path = config.get("pose_path", None)
        if pose_path and os.path.exists(pose_path):
            p = dict(np.load(pose_path))
            self.body_pose = p["body_pose"].astype(np.float32)
            self.global_orient = p["global_orient"].astype(np.float32)
            self.transl = p["transl"].astype(np.float32)
            self.betas_arr = p["betas"].astype(np.float32).reshape(-1)[:10]
        else:
            if pose_path:
                warnings.warn(f"pose_path {pose_path!r} does not exist: "
                              f"the capsule dataset draws synthetic "
                              f"trajectories instead", stacklevel=2)
            n = int(config.get("n_frames", 8))
            t = np.linspace(0, 2 * np.pi, n, endpoint=False)[:, None]
            r2 = np.random.default_rng(3)
            freq = r2.uniform(0.5, 1.5, (1, 69))
            amp = r2.uniform(0.0, 0.25, (1, 69))
            self.body_pose = (amp * np.sin(freq * t)).astype(np.float32)
            self.global_orient = np.zeros((n, 3), np.float32)
            self.transl = np.tile(np.asarray([[0.0, 0.3, 2.5]], np.float32),
                                  (n, 1))
            self.betas_arr = np.zeros(10, np.float32)
        limit = config.get("max_frames", None)
        if limit:
            step = max(1, len(self.body_pose) // int(limit))
            sl = slice(0, int(limit) * step, step)
            self.body_pose = self.body_pose[sl]
            self.global_orient = self.global_orient[sl]
            self.transl = self.transl[sl]
        if split == "val":
            half = slice(None, None, max(1, len(self.body_pose) // 2))
            self.body_pose = self.body_pose[half][:2]
            self.global_orient = self.global_orient[half][:2]
            self.transl = self.transl[half][:2]
        self.n_frames = len(self.body_pose)

        # camera: a fixed pinhole at the origin, f scaled to frame the body
        f = float(config.get("focal", 1.2)) * W
        self.K = np.asarray([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]],
                            np.float32)
        self.c2w = np.eye(4, dtype=np.float32)
        self.rays_o, self.rays_d = make_rays(self.K, self.c2w, H, W)

        # the posed joints of each frame, by the body the model uses
        self.joints = posed_joints(self.betas_arr, self.body_pose,
                                   self.global_orient, self.transl)
        self.albedos = bone_albedos(config.get("albedo_seed", 7))
        self._cache: dict = {}

        # the relighting protocol: a held-out test HDRI on test-mode
        # batches (``hdri_filepath`` -> batch["hdri"], which render_frame
        # swaps in as the emitter's base); ``procedural`` synthesizes one
        self.hdri = None
        hp = config.get("hdri_filepath", None)
        if mode == "test" and hp:
            if hp == "procedural":
                self.hdri = procedural_hdri(
                    int(config.get("hdri_height", 64)),
                    seed=int(config.get("hdri_seed", 11)))
            else:
                if not os.path.exists(hp):
                    raise FileNotFoundError(
                        f"hdri_filepath {hp!r} missing or unreadable")
                self.hdri = read_any(hp).astype(np.float32)

        self.sampler = None
        if mode == "train":
            from intrinsicavatar_tpu_torch.data.samplers import EdgeSampler
            scfg = config.get("sampler", {})
            self.sampler = EdgeSampler(
                int(scfg.get("num_sample", config.get("n_rays", 4096))),
                ratio_mask=scfg.get("ratio_mask", 0.6),
                ratio_edge=scfg.get("ratio_edge", 0.3),
                kernel_size=int(scfg.get("kernel_size", 16)),
                rng=self.rng)

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

    def _frame(self, idx):
        if idx not in self._cache:
            W, H = self.img_wh
            gt = render_capsule_body(
                self.joints[idx], self.rays_o.reshape(-1, 3),
                self.rays_d.reshape(-1, 3), albedos=self.albedos)
            # the eval bbox mask: the dilated foreground bounding box
            # (RANA's ``valid_mask``)
            a = gt["alpha"].reshape(H, W) > 0
            vm = np.zeros((H, W), bool)
            if a.any():
                ys, xs = np.where(a)
                py = max(8, (ys.max() - ys.min()) // 8)
                px = max(8, (xs.max() - xs.min()) // 8)
                vm[max(0, ys.min() - py):ys.max() + py,
                   max(0, xs.min() - px):xs.max() + px] = True
            gt["valid_mask"] = vm.reshape(-1).astype(np.float32)
            self._cache[idx] = gt
        return self._cache[idx]

    def __getitem__(self, idx):
        W, H = self.img_wh
        gt = self._frame(idx)
        if self.sampler is not None:
            msk, img, alb, nrm, vm, ro, rd = self.sampler.sample(
                gt["alpha"].reshape(H, W), gt["rgb"].reshape(H, W, 3),
                gt["albedo"].reshape(H, W, 3), gt["normal"].reshape(H, W, 3),
                gt["valid_mask"].reshape(H, W, 1), self.rays_o, self.rays_d)
            vm = vm[:, 0]
        else:
            msk = gt["alpha"]
            img, alb, nrm = gt["rgb"], gt["albedo"], gt["normal"]
            vm = gt["valid_mask"]
            ro = self.rays_o.reshape(-1, 3)
            rd = self.rays_d.reshape(-1, 3)
        near, far = near_far_from_transl(self.transl[idx], len(rd))
        rays = np.concatenate([ro, rd, near[:, None], far[:, None]], -1)
        d = {
            "rays": rays.astype(np.float32),
            "rgb": img.astype(np.float32),
            "alpha": msk.astype(np.float32),
            "albedo": alb.astype(np.float32),
            "normal": nrm.astype(np.float32),
            "valid_mask": vm.astype(np.float32),
            **self.pose_batch(idx),
            "t_idx": idx / self.n_frames,
        }
        if self.hdri is not None:
            d["hdri"] = self.hdri
        return d

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
