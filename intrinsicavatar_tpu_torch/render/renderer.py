"""The composed volumetric renderer (counterpart of the JAX package's
``render/renderer.py``): the radiance regime in eval and training, the
physically based (relight) regime in eval.

Per batch of rays: rays world -> SMPL space; occupancy marching into edge
lists; two merge-importance rounds driven by coarse SDF queries (no
gradient); the shading pass at interval midpoints through the deformer ->
SDF (kernel KB) and radiance (kernel KA) fields; compositing (kernel KD).
In training the shading pass, the curvature proxy and the composite are
differentiated (kernels KB', KA', KD' in the backward).  With
``enable_phys`` (eval) the material field shades the same samples, the
albedo / roughness / metallic maps are composited, and ``render/pbr.py``
renders the physically based maps.

In the phys training regime the material head also shades a jittered clone
of (a subsample of) the shading lanes for the smoothness losses, and the
normal-orientation map is composited; the PBR stage's secondary pass runs
without autograd (the JAX package's ``stop_gradient``).

At eval a per-frame seed grid (:meth:`IntrinsicAvatar.bake_seed_grid`,
``anim/seedgrid.py``; on by default, ``eval_seed_grid``) answers the
importance rounds' SDF from its gather (kernel KM, ``baked_importance``) and
seeds the shading pass's inverse skinning, polished by kernel KL for
``seed_grid_polish_iters`` in place of the multi-init search;
``eval_seed_grid: false`` gives the searched path.  The bf16 scopes come
with a later slice.

Randomness is passed in through ``draws`` (a dict; see :meth:`forward`) or
drawn from a ``torch.Generator``, so a caller can reproduce another
implementation's draws.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from intrinsicavatar_tpu_torch.anim import seedgrid as SG
from intrinsicavatar_tpu_torch.ops import resample as RS
from intrinsicavatar_tpu_torch.ops import volrend as V
from intrinsicavatar_tpu_torch.ops.compact import (
    compact_apply, compact_indices_interleaved,
)
from intrinsicavatar_tpu_torch.ops.grid_traversal import (
    RayIntervals, intervals_to_samples, occupancy_sampling,
)
from intrinsicavatar_tpu_torch.ops.math import linear_to_srgb, safe_normalize
from intrinsicavatar_tpu_torch.registry import make, register
from intrinsicavatar_tpu_torch.render import pbr as PBR
from intrinsicavatar_tpu_torch.render.occupancy import OccGridState, level_of
from intrinsicavatar_tpu_torch.utils.diag import record


class RenderFlags(NamedTuple):
    training: bool = True
    enable_phys: bool = False
    importance_sample: bool = False
    randomized: bool = True
    with_curvature_loss: bool = True
    jitter_materials: bool = True
    render_mode: str = "uniform_light"
    # the material maps without the secondary-ray stage: the pre-pass that
    # fits the albedo alignment ratio (`models/intrinsic_avatar.py:222`)
    albedo_only: bool = False
    full_budget: bool = False
    budget_boost: int = 0


def get_draw(draws, key, make, generator, device):
    """``draws[key]`` on ``device``, else ``make(generator)`` (drawn on the
    CPU from ``generator``, then moved)."""
    if draws is not None and key in draws:
        return torch.as_tensor(draws[key], device=device)
    return make(generator).to(device)


@register("intrinsic-avatar")
class IntrinsicAvatar(nn.Module):
    """Composition root; construct from the ``model`` config node."""

    def __init__(self, config):
        super().__init__()
        self.config = config
        self.geometry = make(config.geometry.name, config.geometry)
        self.density = make(config.density.name, config.density)
        self.radiance = make(config.radiance.name, config.radiance)
        self.pose_encoder = make(config.pose_encoder.name,
                                 config.pose_encoder)
        self.pose_correction = make(config.pose_correction.name,
                                    config.pose_correction)
        self.deformer = make(config.deformer.name, config.deformer)
        self.material = make(config.material.name, config.material)
        self.scatterer = (make(config.scatterer.name, config.scatterer)
                          if config.get("scatterer") else None)
        self.emitter = (make(config.light.name, config.light)
                        if config.get("light") else None)

        if config.get("primary_dtype", "bfloat16") != "float32":
            raise ValueError("the bf16 primary scope is not ported yet: set "
                             "model.primary_dtype=float32")
        if config.get("march_concentrate", 0):
            raise ValueError("march_concentrate is not ported yet")
        self.scene_aabb = np.asarray(config.scene_aabb, np.float32)
        diag = float(np.linalg.norm(self.scene_aabb[3:] - self.scene_aabb[:3]))
        self.num_samples_per_ray = config.get("num_samples_per_ray", 128)
        self.render_step_size = diag / self.num_samples_per_ray
        self.n_importance_rounds = config.get("n_importance_rounds", 2)
        self.n_importance_samples = config.get("n_importance_samples", 16)
        self.samples_per_pixel = config.get("samples_per_pixel", 512)
        self.num_samples_per_secondary_ray = config.get(
            "num_samples_per_secondary_ray", 64)
        self.secondary_near_plane = config.get("secondary_near_plane", 0.0)
        self.secondary_far_plane = config.get("secondary_far_plane", 1.5)
        self.secondary_importance_sample = config.get(
            "secondary_importance_sample", True)
        self.zero_crossing_search = config.get("zero_crossing_search", True)
        self.add_emitter = config.get("add_emitter", False)
        self.material_feature = config.get("material_feature", "hybrid")

    # ------------------------------------------------------------- setup

    @torch.no_grad()
    def init(self, generator: torch.Generator):
        """Random parameters with the distributions of the JAX ``init``."""
        self.geometry.init(generator)
        self.radiance.init(generator)
        self.density.init(generator)
        self.material.init(generator)
        if self.emitter is not None:
            self.emitter.init(generator)
        return self

    def lipschitz_bound(self):
        """The material MLP's Lipschitz bound (`nets/mlp.py:301-305` of the
        JAX package; 0 for a plain MLP)."""
        return self.material.lipschitz_bound().to(
            self.geometry.table.device)

    @torch.no_grad()
    def initialize(self, betas):
        """Once-per-sequence statics; also sets the field bboxes."""
        device = self.geometry.table.device
        statics = self.deformer.initialize(betas, device)
        self.geometry.prepare_bbox(self.deformer.bbox)
        self.radiance.prepare_bbox(self.deformer.bbox)
        return statics

    # ------------------------------------------------------------- frame

    def prepare(self, statics, batch, global_step=0, training=False):
        """Pose correction + SMPL forward + transform baking + pose cond.

        With ``training`` and the pose correction active at ``global_step``
        the frame's ``tfs`` carries the autograd graph from the corrections
        (the JAX train step prepares inside its ``value_and_grad``);
        otherwise the frame is built without autograd."""
        grad = (training and torch.is_grad_enabled()
                and self.pose_correction.active(global_step))
        with torch.set_grad_enabled(grad):
            corr = self.pose_correction(batch["index"], global_step)
            smpl_params = {k: batch[k] for k in
                           ("betas", "body_pose", "global_orient", "transl")}
            smpl_params.update(corr)
            frame = self.deformer.prepare(statics, smpl_params)
            cond = self.pose_encoder(frame.rot_mats, frame.joints[None])
        return frame, cond

    def schedules(self, step, device):
        return {"geo_mask": self.geometry.level_mask(step, device),
                "rad_mask": self.radiance.level_mask(step, device),
                "sh_mask": self.radiance.sh_mask(step, device)}

    # ------------------------------------------------------------- fields

    def _deform_query(self, statics, frame, cond, pts, sched, with_grad,
                      global_step=0, mask=None, budget=None, mask2d=None,
                      boost=0, counters=None, eval_mode=True, seed=None,
                      seed_iters=None):
        """Canonicalize + query geometry; returns the deformer outputs.

        With ``mask`` and query compaction, only a fixed budget of valid
        points runs the search + field query; the rest get neutral fills
        (sdf = 1e5 -> alpha 0).  ``mask2d`` selects sample-major order.
        ``seed = (xc [M, 3], ok [M])`` warm-starts each point's root search
        at a known canonical root (the seeded polish of ``seed_iters``
        iterations, eval only); the seeds ride along as extra point columns
        through the compaction.
        """
        geo = self.geometry

        def geometry_fn(xc):
            if with_grad:
                return geo.sdf_grad_feature(xc, sched["geo_mask"])
            return (geo.features(xc, sched["geo_mask"])[:, 0],)

        def query(p):
            s = None
            if seed is not None:
                p, s = p[:, :3].contiguous(), (p[:, 3:6].contiguous(),
                                               p[:, 6] > 0.5)
            return tuple(self.deformer(
                statics, frame, p, cond, geometry_fn, with_jac=with_grad,
                eval_mode=eval_mode, global_step=global_step, boost=boost,
                counters=counters, seed=s, seed_iters=seed_iters))

        if seed is not None:
            pts = torch.cat([pts, seed[0], seed[1].to(pts.dtype)[:, None]],
                            -1)
        frac = self.config.get("query_compaction", 0.5)
        if mask is None or not frac:
            return list(query(pts))
        M = pts.shape[0]
        if budget is None:
            budget = int(np.ceil(
                M * min(1.0, float(frac) + 0.0625 * boost) / 128.0)) * 128
        budget = min(max(budget, 128), M)
        record(counters, "ovf_query",
               torch.relu(mask.sum(dtype=torch.int64) - budget))
        fills = [0.0, 1e5, False]
        if with_grad:
            fills += [[0.0, 0.0, 1.0], [0.0, 0.0, 1.0], 0.0]
        return list(compact_apply(query, pts, mask, budget, fills,
                                  mask2d=mask2d))

    # ---------------------------------------------------------- seed grid

    @torch.no_grad()
    def bake_seed_grid(self, statics, frame, cond, step, resolution=None,
                       chunk=65536) -> SG.SeedGrid:
        """The frame's seed grid (`render/renderer.py:390-415` of the JAX
        package): one chunked pass of the searched canonicalization, without
        features or mask, over a ``seed_grid_resolution``^3 lattice spanning
        the forward-skinned voxel's bbox, with the canonical SDF baked as a
        channel."""
        if resolution is None:
            resolution = int(self.config.get("seed_grid_resolution", 96))
        sched = self.schedules(step, frame.tfs.device)
        aabb = self.deformer.rigid.get_bbox_deformed(frame)

        def deform_fn(p):
            out = self._deform_query(statics, frame, cond, p, sched,
                                     with_grad=False, global_step=step)
            return out[0], out[2], out[1]

        return SG.bake_seed_grid(deform_fn, aabb, resolution, chunk)

    def _grid_gather(self, seed_grid, pts):
        """``(seed_xc, seed_ok, sdf | None)`` of ``pts`` from the seed grid
        (kernel KM), or None without a grid."""
        if seed_grid is None:
            return None
        return SG.gather_from_grid(
            seed_grid, pts.contiguous(),
            coh_factor=float(self.config.get("seed_grid_coh_factor", 3.0)))

    def _grid_seed(self, seed_grid, pts):
        """``(seed_xc, seed_ok)`` of ``pts`` from the seed grid, or None."""
        gth = self._grid_gather(seed_grid, pts)
        return None if gth is None else gth[:2]

    def grid_iters(self) -> int:
        """Polish iterations of a seed from the grid."""
        return int(self.config.get("seed_grid_polish_iters", 6))

    def get_alpha(self, sdf, dists, step):
        return V.alpha_from_sdf(sdf, dists, self.density.get_beta(step))

    def occ_eval_fn(self, statics, frame, cond, sched, step):
        """alpha(x) evaluator for the test occupancy grid."""

        def fn(x):
            out = self._deform_query(statics, frame, cond, x, sched,
                                     with_grad=False, global_step=step)
            return self.get_alpha(out[1], self.render_step_size, step)

        return fn

    # ------------------------------------------------------- importance

    def _coarse_sdf_at_edges(self, statics, frame, cond, sched, rays_o,
                             rays_d, iv: RayIntervals, step, prev_sdf=None,
                             is_new=None, boost=0, counters=None,
                             seed_grid=None):
        """SDF at (new) edge values; invalid slots get 1e10.  With a seed
        grid that has the SDF channel (and ``baked_importance``) every edge
        reads it from the grid's gather: the rounds only place the shading
        samples, which re-query their midpoints.  Otherwise the new edges
        are queried, seeded from the grid when there is one."""
        R, E = iv.vals.shape
        t = torch.where(iv.valid, iv.vals, 0.0)
        pos = (rays_o[:, None, :] + rays_d[:, None, :] * t[..., None]
               ).reshape(-1, 3)
        gth = self._grid_gather(seed_grid, pos)
        if (gth is not None and gth[2] is not None
                and bool(self.config.get("baked_importance", True))):
            return torch.where(iv.valid, gth[2].reshape(R, E), 1e10)
        qmask = iv.valid if is_new is None else (iv.valid & is_new)
        nb = None if is_new is None else R * self.n_importance_samples
        out = self._deform_query(statics, frame, cond, pos, sched,
                                 with_grad=False, global_step=step,
                                 mask=qmask.reshape(-1), budget=nb,
                                 mask2d=qmask, boost=boost,
                                 counters=counters,
                                 seed=None if gth is None else gth[:2],
                                 seed_iters=self.grid_iters())
        sdf = out[1].reshape(R, E)
        if prev_sdf is not None:
            sdf = torch.where(is_new, sdf, prev_sdf)
        return torch.where(iv.valid, sdf, 1e10)

    def _edge_alphas_min_sdf(self, iv: RayIntervals, sdf, step):
        """Interval alpha from min(sdf_left, sdf_right), constant dists."""
        sdf_r = torch.roll(sdf, -1, -1)
        valid_r = torch.roll(iv.valid, -1, -1)
        valid_r[:, -1] = False
        real = iv.is_left & torch.roll(iv.is_right, -1, -1) & iv.valid \
            & valid_r
        sdf_min = torch.minimum(sdf, torch.where(real, sdf_r, torch.inf))
        alphas = self.get_alpha(sdf_min, self.render_step_size, step)
        return torch.where(real, alphas, 0.0)

    def _importance_resample(self, statics, frame, cond, sched, rays_o,
                             rays_d, iv: RayIntervals, step, boost=0,
                             counters=None, seed_grid=None):
        """Merge-resampling rounds; each round after the first queries only
        the new edges (cached SDF carried through ``gather_idx``)."""
        n_new = self.n_importance_samples
        sdf = self._coarse_sdf_at_edges(statics, frame, cond, sched, rays_o,
                                        rays_d, iv, step, boost=boost,
                                        counters=counters,
                                        seed_grid=seed_grid)
        for r in range(self.n_importance_rounds):
            alphas = self._edge_alphas_min_sdf(iv, sdf, step)
            weights, _ = V.render_weight_from_alpha(alphas, iv.valid)
            merged = RS.merge_resample_rays(iv.vals, iv.is_left, iv.is_right,
                                            iv.valid, weights, n_new)
            iv = RayIntervals(vals=merged.vals, is_left=merged.is_left,
                              is_right=merged.is_right, valid=merged.valid)
            if r + 1 == self.n_importance_rounds:
                break  # shading re-queries its own midpoints
            fill = torch.full((sdf.shape[0], n_new), 1e10, dtype=sdf.dtype,
                              device=sdf.device)
            carried = torch.gather(torch.cat([sdf, fill], 1), 1,
                                   merged.gather_idx)
            sdf = self._coarse_sdf_at_edges(
                statics, frame, cond, sched, rays_o, rays_d, iv, step,
                prev_sdf=carried, is_new=merged.is_new, boost=boost,
                counters=counters, seed_grid=seed_grid)
        return iv

    # ------------------------------------------------------------ forward

    @torch.no_grad()
    def sample_intervals(self, statics, frame, cond, occ: OccGridState,
                         rays_world, step, flags: RenderFlags, t_idx=0.0,
                         draws=None, generator=None, counters=None,
                         seed_grid=None):
        """Ray transform, occupancy marching, importance rounds ->
        ``(t_starts, t_ends, smask)`` rectangular ``[R, S]``, without
        gradient.  ``draws["strat_u"] [R]`` holds the stratified offsets
        (drawn from ``generator`` when absent and ``flags.randomized``);
        ``seed_grid`` serves the importance rounds (eval)."""
        sched = self.schedules(step, rays_world.device)
        rays = self.deformer.rigid.transform_rays_w2s(frame, rays_world)
        R = rays.shape[0]
        rays_o, rays_d = rays[:, :3].contiguous(), rays[:, 3:6].contiguous()
        strat_u = None
        if flags.randomized:
            strat_u = get_draw(draws, "strat_u",
                               lambda g: torch.rand((R,), generator=g),
                               generator, rays.device).contiguous()
        lvl = level_of(occ, t_idx)
        iv = occupancy_sampling(
            rays_o, rays_d, occ.binaries[lvl], occ.aabbs[lvl],
            self.render_step_size, self.num_samples_per_ray,
            near=rays[:, 6].contiguous(), far=rays[:, 7].contiguous(),
            stratified_u=strat_u)
        if flags.importance_sample:
            iv = self._importance_resample(statics, frame, cond, sched,
                                           rays_o, rays_d, iv, step,
                                           boost=flags.budget_boost,
                                           counters=counters,
                                           seed_grid=seed_grid)
        return intervals_to_samples(iv)

    def forward(self, statics, frame, cond, occ: OccGridState, rays_world,
                step, flags: RenderFlags, t_idx=0.0, background_color=None,
                intervals=None, draws=None, generator=None,
                emitter_state=None, albedo_align_ratio=None, seed_grid=None):
        """Render a batch of rays ``[R, 8]``.  Returns ``comp_rgb,
        comp_normal, opacity, depth, rays_valid, ... comp_rgb_full``, the
        budget counters under ``counters`` and, in training, the per-sample
        outputs the losses read (``sdf_samples``, ``sdf_grad_samples``,
        ``weights``, ``points``, ``intervals``, ``sample_mask``,
        ``sample_valid``, ``sdf_laplace_samples``, ``laplace_mask``).

        ``intervals`` (from :meth:`sample_intervals`) skips the sampling
        stage.  ``draws`` may hold ``strat_u [R]``, the curvature
        subsample's lane indices ``lap_sub [n]`` and its directions' U[0, 1)
        draws ``lap_u [n, 3]``, the jittered material clone's lane
        subsample ``jit_sub [n]`` and N(0, 1) offsets ``jit_noise [n, 3]``,
        and the PBR stage's draws (:func:`render.pbr.pbr_forward`); what it
        lacks is drawn from ``generator``.  With ``enable_phys`` the output
        adds the material maps ``comp_albedo / comp_roughness /
        comp_metallic`` (the albedo scaled by ``albedo_align_ratio [3]``
        when given) and, unless ``albedo_only``, ``comp_rgb_phys``,
        ``comp_demod_phys`` and ``visibility``, each with its ``*_full``
        map (in training also the ``*_loss_map`` outputs of the smoothness
        and normal-orientation losses); ``emitter_state`` replaces the
        emitter's sampling tables.  ``seed_grid`` (from
        :meth:`bake_seed_grid`, eval only) answers the importance rounds and
        the secondary coarse pass and seeds the shading and fine passes.
        Eval renders run without autograd; a training render is
        differentiable in every parameter it reads.
        """
        if flags.training and seed_grid is not None:
            raise NotImplementedError("the seed grid serves eval renders "
                                      "only (train_seed_grid is not "
                                      "ported)")
        counters: dict = {}
        with torch.set_grad_enabled(flags.training
                                    and torch.is_grad_enabled()):
            out = self._forward_body(statics, frame, cond, occ, rays_world,
                                     step, flags, t_idx, background_color,
                                     intervals, draws, generator, counters,
                                     emitter_state, albedo_align_ratio,
                                     seed_grid)
        out["counters"] = {k: torch.as_tensor(v).to(torch.int32)
                           for k, v in counters.items()}
        return out

    def _forward_body(self, statics, frame, cond, occ, rays_world, step,
                      flags, t_idx, background_color, intervals, draws,
                      generator, counters, emitter_state, albedo_align_ratio,
                      seed_grid):
        dev = rays_world.device
        sched = self.schedules(step, dev)
        rays = self.deformer.rigid.transform_rays_w2s(frame, rays_world)
        R = rays.shape[0]
        rays_d = rays[:, 3:6]
        rays_o = rays[:, :3]
        far = rays[:, 7]
        if background_color is None:
            background_color = torch.zeros(3, device=dev)

        if intervals is None:
            intervals = self.sample_intervals(
                statics, frame, cond, occ, rays_world, step, flags, t_idx,
                draws, generator, counters, seed_grid)
        t_starts, t_ends, smask = intervals
        S = t_starts.shape[1]
        mids = 0.5 * (t_starts + t_ends)
        dists = t_ends - t_starts

        # shading queries in the compact domain of the valid samples
        pos = (rays_o[:, None, :] + rays_d[:, None, :] * mids[..., None]
               ).reshape(-1, 3)
        with_lap = flags.training and flags.with_curvature_loss
        Mfull = R * S
        frac = self.config.get("query_compaction", 0.5)
        use_compact = bool(frac) and Mfull >= 4096 and not flags.full_budget
        record(counters, "shading_valid_samples", smask.sum(dtype=torch.int64))
        record(counters, "shading_total_samples", torch.tensor(Mfull))
        dirs = torch.repeat_interleave(rays_d, S, dim=0)
        if use_compact:
            budget = int(np.ceil(Mfull * min(
                1.0, float(frac) + 0.0625 * (1 + flags.budget_boost))
                / 128.0)) * 128
            budget = min(max(budget, 128), Mfull)
            record(counters, "ovf_shading",
                   torch.relu(smask.sum(dtype=torch.int64) - budget))
            sidx, spicked = compact_indices_interleaved(smask, budget)
            pos_q, dirs_q = pos[sidx], dirs[sidx]
            qmask = None
        else:
            pos_q, dirs_q = pos, dirs
            qmask = None if flags.full_budget else smask.reshape(-1)

        # at eval the grid seeds the shading pass's inverse skinning
        out = self._deform_query(statics, frame, cond, pos_q, sched,
                                 with_grad=True, global_step=step, mask=qmask,
                                 boost=flags.budget_boost, counters=counters,
                                 eval_mode=not flags.training,
                                 seed=self._grid_seed(seed_grid, pos_q),
                                 seed_iters=self.grid_iters())
        pos_cano, sdf, valid, sdf_grad, sdf_grad_cano, feat = out[:6]

        # curvature on a with-replacement subsample of the shading lanes
        # (an unbiased estimator of the per-sample mean the loss reads)
        laplace = laplace_mask = None
        if with_lap:
            q_valid = valid & (spicked if use_compact else smask.reshape(-1))
            frac_lap = float(self.config.get("curvature_subsample", 0.25))
            nq = pos_cano.shape[0]
            if frac_lap >= 1.0:
                x_sub, grad_sub, laplace_mask = pos_cano, sdf_grad_cano, \
                    q_valid
            else:
                nsub = min(max(int(np.ceil(nq * frac_lap / 128.0)) * 128,
                               128), nq)
                sub = get_draw(draws, "lap_sub",
                               lambda g: torch.randint(0, nq, (nsub,),
                                                       generator=g),
                               generator, dev).to(torch.int64)
                x_sub, grad_sub = pos_cano[sub], sdf_grad_cano[sub]
                laplace_mask = q_valid[sub]
            lap_u = get_draw(draws, "lap_u",
                             lambda g: torch.rand((x_sub.shape[0], 3),
                                                  generator=g),
                             generator, dev)
            laplace = self.geometry.tangent_laplace(
                x_sub, grad_sub, sched["geo_mask"], lap_u)

        dirs_world = self.deformer.rigid.transform_dirs_s2w(frame, dirs_q)
        normal_world_q = self.deformer.rigid.transform_dirs_s2w(frame,
                                                                sdf_grad)
        rgbs, rgb_feat = self.radiance(pos_cano, feat, dirs_world,
                                       normal_world_q,
                                       level_mask=sched["rad_mask"],
                                       sh_mask=sched["sh_mask"])

        mats = mats_q = mats_jitter = jsub = None
        if flags.enable_phys:
            mats = self.material(self._material_features(feat, rgb_feat))
            if albedo_align_ratio is not None:
                # the fitted per-channel ratio aligns the albedo the relight
                # uses (`models/intrinsic_avatar.py:1114-1115`)
                mats = torch.cat([mats[:, :3] * albedo_align_ratio[None, :],
                                  mats[:, 3:]], -1)
            mats_q = mats
            if flags.training and flags.jitter_materials:
                # the jittered clone for the smoothness losses, on the
                # compacted path on a with-replacement subsample of the
                # lanes (an unbiased estimator of the means they read;
                # `render/renderer.py:674-713` of the JAX package)
                nq = pos_cano.shape[0]
                frac_j = float(self.config.get("smoothness_subsample", 0.25))
                if use_compact and frac_j < 1.0:
                    nsub = min(max(int(np.ceil(nq * frac_j / 128.0)) * 128,
                                   128), nq)
                    jsub = get_draw(draws, "jit_sub",
                                    lambda g: torch.randint(0, nq, (nsub,),
                                                            generator=g),
                                    generator, dev).to(torch.int64)
                    mats_jitter = self._jitter_materials(
                        pos_cano[jsub], sched, draws, generator)
                else:
                    mats_jitter = self._jitter_materials(pos_cano, sched,
                                                         draws, generator)

        n_mat = 0 if mats is None else mats.shape[-1]
        pack_jitter = mats_jitter is not None and jsub is None
        if use_compact:
            # one packed row scatter back to the rectangular [R*S] layout
            cols = [rgbs, sdf_grad, sdf[:, None]]
            if mats is not None:
                cols.append(mats)
            if pack_jitter:
                cols.append(mats_jitter)
            packed = torch.cat(cols, -1)
            packed = torch.where(spicked[:, None], packed, 0.0)
            full = torch.zeros((Mfull, packed.shape[-1]), dtype=packed.dtype,
                               device=dev)
            full[sidx] = packed
            rgbs, sdf_grad, sdf = full[:, :3], full[:, 3:6], full[:, 6]
            if mats is not None:
                mats = full[:, 7:7 + n_mat]
            if pack_jitter:
                mats_jitter = full[:, 7 + n_mat:]
            picked_full = torch.zeros(Mfull, dtype=torch.bool, device=dev)
            picked_full[sidx] = spicked
            smask = smask & picked_full.reshape(R, S)
            valid_full = torch.zeros(Mfull, dtype=torch.bool, device=dev)
            valid_full[sidx] = valid & spicked
            valid = valid_full

        normal_world = self.deformer.rigid.transform_dirs_s2w(frame, sdf_grad)
        beta = self.density.get_beta(step)
        _, weights, rgb_map, normal_map, acc_map, depth_map = V.composite(
            sdf.reshape(R, S).contiguous(), dists.contiguous(), beta,
            smask.contiguous(), rgbs.reshape(R, S, 3).contiguous(),
            normal_world.reshape(R, S, 3).contiguous(), mids.contiguous())
        depth_map = depth_map + (1.0 - acc_map) * far[:, None]

        bg_rgb = background_color[None, :].expand_as(rgb_map)
        out_dict = {
            "comp_rgb": rgb_map,
            "comp_normal": normal_map,
            "opacity": acc_map,
            "depth": depth_map,
            "rays_valid": acc_map > 0,
            "rays_valid_phys": (acc_map > 0) if flags.enable_phys
            else torch.zeros_like(acc_map, dtype=torch.bool),
            "num_samples": smask.sum(dtype=torch.int64),
            "beta": beta,
            "comp_rgb_bg": bg_rgb,
            "comp_rgb_full": torch.clamp(
                linear_to_srgb(rgb_map + bg_rgb * (1.0 - acc_map)), 0.0, 1.0),
        }
        if flags.enable_phys:
            m = mats.reshape(R, S, -1)
            acc = lambda v: V.accumulate_along_rays(weights, v, smask)
            out_dict.update({"comp_albedo": acc(m[..., :3]),
                             "comp_roughness": acc(m[..., 3:4]),
                             "comp_metallic": acc(m[..., 4:])})
            if not flags.albedo_only:
                out_dict.update(PBR.pbr_forward(
                    self, statics, frame, cond, occ, sched,
                    rays_o.contiguous(), rays_d.contiguous(), t_starts,
                    t_ends, smask, weights,
                    sdf.reshape(R, S), mats,
                    safe_normalize(sdf_grad).reshape(R, S, 3), step, flags,
                    background_color, level_of(occ, t_idx),
                    emitter_state=emitter_state, draws=draws,
                    generator=generator, counters=counters,
                    seed_grid=seed_grid))
                for k in ("comp_rgb_phys", "comp_demod_phys"):
                    out_dict[k + "_full"] = torch.clamp(
                        linear_to_srgb(out_dict[k]), 0.0, 1.0)
            bg_scalar = torch.mean(background_color)
            out_dict["comp_albedo_full"] = out_dict["comp_albedo"]
            for k in ("comp_metallic", "comp_roughness"):
                out_dict[k + "_full"] = out_dict[k] + bg_scalar * (1.0
                                                                  - acc_map)
            out_dict["rays_valid_phys_full"] = out_dict["rays_valid_phys"]
        if flags.training:
            out_dict.update({
                "sdf_samples": sdf,
                "sdf_grad_samples": sdf_grad,
                "weights": weights,
                "points": mids,
                "intervals": dists,
                "sample_mask": smask,
                "sample_valid": valid.reshape(R, S),
            })
            if laplace is not None:
                out_dict["sdf_laplace_samples"] = laplace
                out_dict["laplace_mask"] = laplace_mask
            if flags.enable_phys:
                jit = None if jsub is None else (
                    jsub, mats_q, mats_jitter, sidx, spicked)
                out_dict.update(self._phys_loss_maps(
                    rays_d, safe_normalize(sdf_grad).reshape(R, S, 3),
                    weights, smask, mats,
                    mats_jitter if jsub is None else None, jit))
        return out_dict

    def _material_features(self, feat, rgb_feat):
        if self.material_feature == "geometry":
            return feat
        if self.material_feature == "radiance":
            return rgb_feat
        return torch.cat([rgb_feat, feat], -1)

    def _jitter_materials(self, pos, sched, draws, generator):
        """The material head at ``pos`` moved by N(0, 0.01^2) offsets
        (``draws["jit_noise"]``), from its own geometry and radiance
        encodes."""
        noise = get_draw(draws, "jit_noise",
                         lambda g: torch.randn(pos.shape, generator=g),
                         generator, pos.device)
        pos_j = pos + noise * 0.01
        feat_j = self.geometry.features(pos_j, sched["geo_mask"])
        rgb_feat_j = None
        if self.material_feature != "geometry":
            rgb_feat_j = self.radiance.encode(pos_j, sched["rad_mask"])
        return self.material(self._material_features(feat_j, rgb_feat_j))

    @staticmethod
    def _phys_loss_maps(rays_d, normals, weights, smask, mats, mats_jitter,
                        jit):
        """The per-ray maps of the normal-orientation and smoothness losses
        (`render/renderer.py:809-861` of the JAX package): ``mats_jitter``
        ``[R*S, C]`` beside ``mats``, or the subsampled clone ``jit = (jsub,
        compacted mats, clone, sidx, spicked)``, whose estimator of the
        per-ray mean is a scalar; no clone, zero maps."""
        R = rays_d.shape[0]
        orient = torch.clamp(torch.sum(rays_d[:, None, :] * normals, -1,
                                       keepdim=True), min=0.0)
        out = {"normals_orientation_loss_map":
               V.accumulate_along_rays(weights, orient, smask)}

        def smooth(v, vj):
            base = torch.clamp(torch.maximum(v, vj), min=1e-6)
            return torch.sum(((v - vj) / base) ** 2, -1, keepdim=True)

        parts = (("albedo", slice(0, 3)), ("roughness", slice(3, 4)),
                 ("metallic", slice(4, None)))
        if jit is not None:
            # (lanes / R) x the subset's mean of weight x smoothness
            jsub, mats_q, clone, sidx, spicked = jit
            w_sub = weights.reshape(-1)[sidx[jsub]][:, None] \
                * spicked[jsub][:, None].to(weights.dtype)
            scale = mats_q.shape[0] / R
            for k, sl in parts:
                out[f"{k}_smoothness_loss_map"] = scale * torch.mean(
                    w_sub * smooth(mats_q[jsub][:, sl], clone[:, sl]))
        elif mats_jitter is not None:
            m = mats.reshape(R, -1, mats.shape[-1])
            mj = mats_jitter.reshape(R, -1, mats.shape[-1])
            for k, sl in parts:
                out[f"{k}_smoothness_loss_map"] = V.accumulate_along_rays(
                    weights, smooth(m[..., sl], mj[..., sl]), smask)
        else:
            z = torch.zeros((R, 1), dtype=weights.dtype,
                            device=weights.device)
            out.update({f"{k}_smoothness_loss_map": z for k, _ in parts})
        return out
