"""Validation and test rendering: per-frame test occupancy grid and seed
grid, chunked full-frame render (with the PBR stage from
``phys_kick_in_step`` on), the albedo alignment pre-pass, metrics, and the
eval outputs: image grids, the canonical mesh and the environment map
(counterpart of the JAX package's ``train/evaluate.py``)."""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from intrinsicavatar_tpu_torch.render.occupancy import (
    OccGridState, compute_test_occ_grid,
)
from intrinsicavatar_tpu_torch.render.renderer import RenderFlags
from intrinsicavatar_tpu_torch.utils import metrics as M
from intrinsicavatar_tpu_torch.utils import saver


def eval_flags(model_cfg, step: int, albedo_only: bool = False
               ) -> RenderFlags:
    """Render flags of an eval render at ``step`` (the JAX system's
    ``flags_for_step(step, training=False)``)."""
    return RenderFlags(
        training=False,
        enable_phys=step >= model_cfg.get("phys_kick_in_step", 10000),
        importance_sample=step > model_cfg.get(
            "importance_sample_kick_in_step", 1000),
        randomized=False,
        render_mode=model_cfg.get("render_mode", "uniform_light"),
        albedo_only=albedo_only,
        full_budget=False,
    )


def batch_to_device(batch: dict, device) -> dict:
    return {k: torch.as_tensor(np.asarray(v)).to(device)
            for k, v in batch.items() if k != "t_idx"}


@torch.no_grad()
def build_test_occ_grid(model, statics, batch, step, resolution=64,
                        jitter=None, generator=None):
    """Fresh per-frame grid in deformed space
    (`models/intrinsic_avatar.py:286-305,307-381`).  Returns
    ``(occ, frame, cond)``."""
    frame, cond = model.prepare(statics, batch, step)
    sched = model.schedules(step, batch["rays"].device)
    aabb2 = model.deformer.rigid.get_bbox_deformed(frame)
    aabb = torch.cat([aabb2[0], aabb2[1]])
    occ_fn = model.occ_eval_fn(statics, frame, cond, sched, step)
    binaries = compute_test_occ_grid(occ_fn, aabb, resolution=resolution,
                                     occ_thre=0.01, jitter=jitter,
                                     generator=generator)
    occ = OccGridState(occs=torch.zeros((1, resolution ** 3),
                                        device=aabb.device),
                       binaries=binaries[None], aabbs=aabb[None])
    return occ, frame, cond


@torch.no_grad()
def build_seed_grid(model, statics, frame, cond, step):
    """The frame's eval seed grid (``anim/seedgrid.py``), or None when
    ``eval_seed_grid`` is off or the deformer has no rigid part."""
    if not bool(model.config.get("eval_seed_grid", True)) \
            or not hasattr(model.deformer, "rigid"):
        return None
    return model.bake_seed_grid(statics, frame, cond, step)


KEEP = ("comp_rgb_full", "comp_normal", "opacity", "depth", "rays_valid")
# the maps of the physically based regime (without ``visibility`` in the
# render modes other than uniform_light, and only the material maps in the
# albedo-only pre-pass)
KEEP_PHYS = ("comp_rgb_phys_full", "comp_demod_phys_full",
             "comp_albedo_full", "comp_roughness_full", "comp_metallic_full",
             "visibility")


@torch.no_grad()
def render_frame(model, statics, batch, step, flags: RenderFlags,
                 ray_chunk: int = 4096, occ=None, frame=None, cond=None,
                 occ_resolution: int = 64, occ_jitter=None, generator=None,
                 draws=None, emitter_state=None, albedo_align_ratio=None,
                 seed_grid=None):
    """Chunked full-frame render; returns the stitched output maps (numpy)
    and the summed budget counters under ``counters``.

    ``batch`` holds tensors on the render device.  Without ``occ`` the
    per-frame test grid is built first, with jitter ``occ_jitter`` or drawn
    from ``generator``; without ``seed_grid`` the frame's seed grid is baked
    next (:func:`build_seed_grid`: None when ``eval_seed_grid`` is off).
    ``draws``, a list with one dict per chunk, holds the chunks' PBR draws
    (``IntrinsicAvatar.forward``); what it lacks is drawn from
    ``generator``.  A batch with an ``hdri [H, W, 3]`` relights:
    it replaces an image emitter's ``base`` for this frame and its sampling
    tables are rebuilt (`models/intrinsic_avatar.py:292-305`; an SG emitter
    has no image to replace).
    """
    if "hdri" in batch:
        hdri = batch["hdri"]
        batch = {k: v for k, v in batch.items() if k != "hdri"}
        base = getattr(model.emitter, "base", None)
        saved = None if base is None else base.data
        if base is not None:
            base.data = torch.as_tensor(hdri, dtype=torch.float32,
                                        device=saved.device)
        try:
            if flags.enable_phys and emitter_state is None:
                emitter_state = model.emitter.update_pdf()
            return render_frame(model, statics, batch, step, flags,
                                ray_chunk, occ, frame, cond, occ_resolution,
                                occ_jitter, generator, draws, emitter_state,
                                albedo_align_ratio, seed_grid)
        finally:
            if base is not None:
                base.data = saved
    if occ is None:
        occ, frame, cond = build_test_occ_grid(
            model, statics, batch, step, resolution=occ_resolution,
            jitter=occ_jitter, generator=generator)
    if seed_grid is None:
        seed_grid = build_seed_grid(model, statics, frame, cond, step)
    rays = batch["rays"]
    R = rays.shape[0]
    bg = torch.ones(3, device=rays.device)
    pad = (-R) % ray_chunk
    rays_p = torch.cat([rays, rays.new_zeros((pad, rays.shape[1]))])
    keep = KEEP + (KEEP_PHYS if flags.enable_phys else ())
    outs, counters = [], {}
    for n, i in enumerate(range(0, R + pad, ray_chunk)):
        o = model(statics, frame, cond, occ, rays_p[i:i + ray_chunk], step,
                  flags, t_idx=0.0, background_color=bg,
                  draws=None if draws is None else draws[n],
                  generator=generator, emitter_state=emitter_state,
                  albedo_align_ratio=albedo_align_ratio, seed_grid=seed_grid)
        outs.append({k: o[k] for k in keep if k in o})
        for k, v in o["counters"].items():
            counters[k] = counters.get(k, 0) + v
    stitched = {k: torch.cat([o[k] for o in outs])[:R].cpu().numpy()
                for k in outs[0]}
    stitched["counters"] = {k: int(v) for k, v in counters.items()}
    return stitched


def fit_albedo_ratio(model, statics, batch, step, flags: RenderFlags,
                     ray_chunk: int = 4096, occ=None, frame=None, cond=None,
                     generator=None, seed_grid=None) -> torch.Tensor:
    """The relighting protocol's albedo-only pre-pass: the material maps
    without the secondary rays, then one least-squares ratio per channel
    against the batch's ``albedo`` over its foreground (`systems/
    intrinsic_avatar.py:598-611`, `models/utils.py:268-277`).  Returns
    ``[3]`` on the render device."""
    pre = render_frame(model, statics, batch, step,
                       flags._replace(albedo_only=True), ray_chunk=ray_chunk,
                       occ=occ, frame=frame, cond=cond, generator=generator,
                       seed_grid=seed_grid)
    host = lambda k: batch[k].cpu().numpy() if torch.is_tensor(batch[k]) \
        else np.asarray(batch[k])
    gt = host("albedo").reshape(-1, 3)
    m = host("alpha").reshape(-1) > 0.5
    if "valid_mask" in batch:
        m &= host("valid_mask").reshape(-1).astype(bool)
    p = pre["comp_albedo_full"].reshape(-1, 3)[m]
    g = gt[m]
    scale = (g * p).sum(0) / np.maximum((p * p).sum(0), 1e-12)
    return torch.as_tensor(scale, dtype=torch.float32,
                           device=batch["rays"].device)


_LPIPS_FN = "unset"


def _lpips_cached():
    """The LPIPS callable of ``utils/metrics.lpips_fn`` (None without
    weights, said once on stderr), built once a process."""
    global _LPIPS_FN
    if _LPIPS_FN == "unset":
        _LPIPS_FN = M.lpips_fn()
        if _LPIPS_FN is None:
            print("frame metrics: no LPIPS-VGG weights "
                  "(INTRINSICAVATAR_LPIPS_WEIGHTS names no .npz), so no "
                  "lpips", file=sys.stderr)
    return _LPIPS_FN


def frame_metrics(out: dict, batch: dict, img_wh=None,
                  albedo_prealigned: bool = False) -> dict:
    """The JAX package's metrics of one frame: PSNR of the white-background
    composite against the GT (composited over white by its alpha), of the
    physically based composite (``psnr_phys``); with ``img_wh`` the SSIM
    over the GT mask's bbox and, where LPIPS weights are given, ``lpips``;
    the mean normal error over the foreground (``normal_error_deg``) where
    the batch has normals; and the albedo PSNR where it has an albedo:
    plain when the render applied the pre-pass ratio
    (``albedo_prealigned``), else after a per-channel least-squares
    alignment (its scales as ``albedo_scale``)."""
    m: dict = {}
    gt = np.asarray(batch["rgb"])
    if "alpha" in batch:
        # clip: ZJU's ignore label (alpha = 100) keeps the GT value
        a = np.clip(np.asarray(batch["alpha"]).reshape(-1, 1), 0.0, 1.0)
        gt = gt * a + 1.0 * (1.0 - a)
    mask = np.asarray(batch.get("valid_mask",
                                np.ones(gt.shape[0], bool))).astype(bool)
    pred = out["comp_rgb_full"]
    m["psnr"] = M.masked_psnr(pred, gt, mask)
    if img_wh is not None:
        W, H = img_wh
        alpha2d = np.asarray(batch["alpha"]).reshape(H, W)
        m["ssim"] = M.cropped_ssim(pred.reshape(H, W, 3),
                                   gt.reshape(H, W, 3), alpha2d > 0)
    if "comp_rgb_phys_full" in out:
        m["psnr_phys"] = M.masked_psnr(out["comp_rgb_phys_full"], gt, mask)
    if "normal" in batch:
        m["normal_error_deg"] = M.normal_angular_error_deg(
            out["comp_normal"], np.asarray(batch["normal"]),
            mask & (np.asarray(batch["alpha"]) > 0))
    if "albedo" in batch and "comp_albedo_full" in out:
        fg = mask & (np.asarray(batch["alpha"]) > 0)
        if albedo_prealigned:
            m["albedo_psnr"] = M.masked_psnr(
                np.clip(out["comp_albedo_full"], 0.0, 1.0),
                np.asarray(batch["albedo"]), fg)
        else:
            m["albedo_psnr"], m["albedo_scale"] = M.albedo_aligned_metrics(
                out["comp_albedo_full"], np.asarray(batch["albedo"]), fg)
    lp = _lpips_cached()
    if lp is not None and img_wh is not None:
        W, H = img_wh
        m["lpips"] = lp(pred.reshape(H, W, 3), gt.reshape(H, W, 3),
                        np.asarray(batch["alpha"]).reshape(H, W) > 0)
    return m


def dump_frame_images(out_dir: str, name: str, out: dict, batch: dict,
                      img_wh):
    """One eval frame's image grid as ``<out_dir>/<name>.png``, 4 columns:
    the GT over white (where the batch has one), the render, its normal
    map, its opacity, then the PBR maps the render has
    (`systems/intrinsic_avatar.py:423-542`)."""
    W, H = img_wh
    imgs = []
    if "rgb" in batch:
        gt = np.asarray(batch["rgb"]).reshape(H, W, 3)
        if "alpha" in batch:
            a = np.clip(np.asarray(batch["alpha"]).reshape(H, W, 1), 0., 1.)
            gt = gt * a + 1.0 * (1.0 - a)
        imgs.append(gt)
    imgs.append(out["comp_rgb_full"].reshape(H, W, 3))
    imgs.append(out["comp_normal"].reshape(H, W, 3) * 0.5 + 0.5)
    imgs.append(np.repeat(out["opacity"].reshape(H, W, 1), 3, -1))
    for k in ("comp_rgb_phys_full", "comp_demod_phys_full",
              "comp_albedo_full"):
        if k in out:
            imgs.append(out[k].reshape(H, W, 3))
    for k in ("comp_roughness_full", "comp_metallic_full", "visibility"):
        if k in out and out[k].shape[-1] == 1:
            imgs.append(np.repeat(out[k].reshape(H, W, 1), 3, -1))
    saver.save_image_grid(os.path.join(out_dir, f"{name}.png"), imgs,
                          ncols=4)


@torch.no_grad()
def export_canonical_mesh(model, step, path, resolution=256):
    """Marching-tetrahedra mesh of the canonical SDF at ``step``'s level
    mask over the deformer's canonical bbox, as OBJ at ``path``; the SDF
    queries run the geometry field on the model's device
    (`systems/intrinsic_avatar.py:923-930`).  Returns ``(verts, faces)``."""
    from intrinsicavatar_tpu_torch.utils.marching import (
        export_mesh_obj, extract_isosurface,
    )

    geo = model.geometry
    dev = geo.table.device
    mask = geo.level_mask(step, dev)

    def sdf_fn(x):
        x = torch.as_tensor(np.asarray(x, np.float32), device=dev)
        return geo.features(x, mask)[:, 0].cpu().numpy()

    verts, faces = extract_isosurface(sdf_fn, model.deformer.bbox,
                                      resolution=resolution)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    export_mesh_obj(path, verts, faces)
    return verts, faces


@torch.no_grad()
def dump_envmap(model, path):
    """The learned environment light's lat-long image as a Radiance
    ``.hdr`` beside ``path`` (`systems/intrinsic_avatar.py:553-564`);
    returns the path written."""
    img = model.emitter.generate_image().detach().float().cpu().numpy()
    return saver.save_hdr(path, img)
