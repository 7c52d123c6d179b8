"""Articulated deformers: Fast-SNARF rigid inverse skinning + facade
(counterpart of the JAX package's ``anim/deformer.py``).

Once-per-sequence state lives in :class:`DeformerStatics`, per-frame state
in :class:`FrameState` (from :meth:`FastSNARF.prepare`).  A point query
prunes the bone inits to ``n_init`` (kernel KH's prologue), runs the Broyden
search (kernel KC) over them, filters duplicate roots and keeps the first
``max_candidates`` survivors (KH's epilogue, which also blends the LBS
rotation where a gradient query reads it), queries the canonical field on
them and reduces by min-SDF (`snarf_deformer.py:187-255`).  Gradients of
the field outputs pass through the candidate compaction's scatter and the
min-SDF gather.  A seeded query (:meth:`FastSNARF.deform_seeded`: the
secondary fine pass, and every query a seed grid answers, at eval or in a
training step with ``train_seed_grid``) replaces the search with one polish
lane per point started at a known root (kernel KL).  In train mode, with a
pose that carries a gradient (pose correction or optimized betas), the
roots of either take the implicit-function correction of the JAX package
(`anim/deformer.py:396-412`, `:525-533`): their value is unchanged, and
their cotangent, with that of the blended rotation, reaches ``tfs`` through
kernel KN (:class:`_SkinningCorrection`).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch
from torch import nn

from intrinsicavatar_tpu_torch.anim.broyden import (
    INIT_BONES, broyden_polish, broyden_search, channel_last,
    deform_epilogue, deform_prologue, deform_skinning, deform_skinning_bwd,
    segment_table,
)
from intrinsicavatar_tpu_torch.anim.lbs_voxel import (
    make_voxel_spec, make_weight_voxel, precompute_transform_voxels,
)
from intrinsicavatar_tpu_torch.anim.smpl import (
    get_bbox_from_verts, get_predefined_rest_pose, load_body_model,
    make_synthetic_body_model, smpl_forward,
)
from intrinsicavatar_tpu_torch.ops.compact import (
    compact_indices, scatter_compacted,
)
from intrinsicavatar_tpu_torch.ops.math import (
    rigid_inverse, rodrigues, safe_normalize,
)
from intrinsicavatar_tpu_torch.registry import make, register
from intrinsicavatar_tpu_torch.utils.diag import record


class DeformerStatics(NamedTuple):
    """Once-per-sequence tensors."""

    tfs_inv_t: torch.Tensor   # [24, 4, 4] inverse canonical-pose transforms
    lbs_voxel: torch.Tensor   # [24, D, H, W]
    lbs_cl: torch.Tensor      # [D*H*W, 24] channel-last copy for sampling
    vs_template: torch.Tensor  # [V, 3] canonical-pose vertices
    seg_table: torch.Tensor   # [13, 7] init-bone segments (segment_table)


class FrameState(NamedTuple):
    """Per-frame tensors produced by ``prepare``."""

    tfs: torch.Tensor         # [24, 4, 4] canonical -> SMPL-space transforms
    #                           (with the pose's autograd graph, if any)
    w2s: torch.Tensor         # [4, 4] world -> SMPL (pelvis-aligned); the
    #                           transforms below read it detached
    voxel_d: torch.Tensor     # [3, D, H, W] forward-skinned voxel centers
    voxel_J: torch.Tensor     # [D, H, W, 12] blended 3x4 transform voxel,
    #                           channel-last for the Broyden kernels
    vertices: torch.Tensor    # [V, 3] posed vertices in SMPL space
    joints: torch.Tensor      # [24, 3] posed joints in SMPL space
    rot_mats: torch.Tensor    # [1, 24, 9] local joint rotations (root = I)


@register("fast-snarf")
class FastSNARF(nn.Module):
    """Rigid inverse-LBS deformer (Fast-SNARF) with an explicit weight
    voxel."""

    def __init__(self, config):
        super().__init__()
        self.config = config
        dcfg = config.get("deformer_config", config)
        self.resolution = dcfg.get("resolution", 128)
        self.global_scale = dcfg.get("global_scale", 1.2)
        self.cano_pose = dcfg.get("cano_pose", "a_pose")
        self.use_j_inv = dcfg.get("use_j_inv", False)
        self.optimize_betas = dcfg.get("optimize_betas", False)
        self.cvg_thresh = dcfg.get("cvg", 1e-5)
        self.dvg_thresh = dcfg.get("dvg", 1e-1)
        self.max_candidates = dcfg.get("max_candidates", 4)
        self.n_init = min(int(dcfg.get("n_init", 8)), len(INIT_BONES))
        self.seed_polish_iters = int(dcfg.get("seed_polish_iters", 4))
        self.candidate_compaction = dcfg.get("candidate_compaction", 0.375)
        model_path = config.get("model_path", None)
        if model_path in (None, "synthetic"):
            self.body_model = make_synthetic_body_model()
        else:
            self.body_model = load_body_model(model_path,
                                              config.get("gender", "neutral"))
        self.spec = None
        self.bbox = None
        self.init_segs = None     # [13, 2, 3] canonical bone segments

    # ---------------------------------------------------------- init

    def initialize(self, betas, device) -> DeformerStatics:
        """Canonical-pose statics (`snarf_deformer.py:46-79`)."""
        betas = torch.as_tensor(np.asarray(betas, np.float32),
                                device=device).reshape(-1)[:10]
        body_pose_t = torch.as_tensor(get_predefined_rest_pose(self.cano_pose),
                                      device=device)
        out = smpl_forward(self.body_model, betas, body_pose_t)
        tfs_inv_t = rigid_inverse(out.A[0])
        verts_t = out.vertices[0]
        verts = verts_t.cpu().numpy()
        jc = out.joints[0].cpu().numpy()
        parents = np.asarray(self.body_model.parents)
        first_child = {int(b): int(b) for b in range(24)}
        for j in range(23, 0, -1):
            first_child[int(parents[j])] = j
        seg_a = jc[INIT_BONES]
        seg_b = np.stack([jc[first_child[int(b)]] for b in INIT_BONES])
        self.init_segs = np.stack([seg_a, seg_b], 1).astype(np.float32)
        self.spec = make_voxel_spec(verts, self.resolution, self.global_scale)
        self.bbox = get_bbox_from_verts(verts)
        lbs_voxel = make_weight_voxel(
            verts_t, torch.as_tensor(self.body_model.lbs_weights,
                                     device=device), self.spec)
        return DeformerStatics(
            tfs_inv_t=tfs_inv_t, lbs_voxel=lbs_voxel,
            lbs_cl=channel_last(lbs_voxel), vs_template=verts_t,
            seg_table=torch.as_tensor(segment_table(self.init_segs),
                                      device=device))

    # ---------------------------------------------------------- per frame

    def prepare(self, statics: DeformerStatics,
                smpl_params: dict) -> FrameState:
        """SMPL forward + transform baking (`snarf_deformer.py:81-126`).

        Under autograd ``tfs`` carries the graph from the pose corrections;
        the baked voxels are built from it detached, since the search reads
        them without gradient (`anim/deformer.py:245-296` of the JAX
        package)."""
        betas = smpl_params["betas"].reshape(-1)[:10]
        if self.optimize_betas:
            betas = betas + smpl_params["betas_correction"].reshape(-1)[:10]
        body_pose = (smpl_params["body_pose"].reshape(-1)
                     + smpl_params["pose_correction"].reshape(-1))
        global_orient = (smpl_params["global_orient"].reshape(-1)
                         + smpl_params["global_orient_correction"].reshape(-1))
        transl = (smpl_params["transl"].reshape(-1)
                  + smpl_params["transl_correction"].reshape(-1))
        out = smpl_forward(self.body_model, betas, body_pose, global_orient,
                           transl)
        w2s = rigid_inverse(out.A[0, 0])
        tfs = torch.einsum("ab,jbc,jcd->jad", w2s, out.A[0], statics.tfs_inv_t)
        voxel_d, voxel_J = precompute_transform_voxels(statics.lbs_voxel,
                                                       tfs.detach(),
                                                       self.spec)
        verts = out.vertices[0] @ w2s[:3, :3].T + w2s[:3, 3]
        joints = out.joints[0] @ w2s[:3, :3].T + w2s[:3, 3]
        rots = rodrigues(smpl_params["body_pose"].reshape(23, 3))
        eye = torch.eye(3, dtype=rots.dtype, device=rots.device)
        rot_mats = torch.cat([eye[None], rots], 0).reshape(1, 24, 9)
        voxel_J = voxel_J.permute(1, 2, 3, 0).contiguous()
        return FrameState(tfs=tfs, w2s=w2s, voxel_d=voxel_d, voxel_J=voxel_J,
                          vertices=verts, joints=joints, rot_mats=rot_mats)

    # ---------------------------------------------------------- transforms

    def transform_rays_w2s(self, frame: FrameState, rays):
        """World rays ``[R, 8]`` -> SMPL-space rays; near/far = ||o|| -+ 1.
        The transform is detached (`snarf_deformer.py:128-143`)."""
        w2s = frame.w2s.detach()
        o = rays[:, :3] @ w2s[:3, :3].T + w2s[:3, 3]
        d = rays[:, 3:6] @ w2s[:3, :3].T
        dist = torch.linalg.vector_norm(o, dim=-1, keepdim=True)
        return torch.cat([o, d, dist - 1.0, dist + 1.0], dim=-1)

    def transform_dirs_w2s(self, frame: FrameState, d):
        return safe_normalize(d @ frame.w2s.detach()[:3, :3].T)

    def transform_dirs_s2w(self, frame: FrameState, d):
        return safe_normalize(d @ frame.w2s.detach()[:3, :3])

    def get_bbox_deformed(self, frame: FrameState):
        """SMPL-space bbox of the forward-skinned voxel grid, ``[2, 3]``."""
        v = frame.voxel_d.reshape(3, -1)
        return torch.stack([v.min(1).values, v.max(1).values])

    # ---------------------------------------------------------- queries

    def search(self, statics: DeformerStatics, frame: FrameState, pts):
        """Broyden search from the ``n_init`` bone inits whose canonicalized
        start point lies closest to that bone's canonical segment."""
        N = pts.shape[0]
        I = self.n_init
        n_all = len(INIT_BONES)
        # all without gradient (`anim/deformer.py:245-296` of the JAX
        # package)
        pts = pts.detach()
        xd = torch.repeat_interleave(pts, I, dim=0)
        init_bones = torch.as_tensor(INIT_BONES, device=pts.device)
        tfs_table = frame.tfs.detach()[init_bones].contiguous()  # [13, 4, 4]
        if I >= n_all:
            slot = torch.arange(n_all, dtype=torch.int32,
                                device=pts.device).repeat(N)
        else:
            slot = deform_prologue(pts.contiguous(), tfs_table,
                                   statics.seg_table, I)
        return broyden_search(
            xd.contiguous(), slot, frame.voxel_J, tfs_table,
            self.spec.offset, self.spec.scale_kernel,
            cvg_thresh=self.cvg_thresh, dvg_thresh=self.dvg_thresh)

    def _query_geometry_compact(self, geometry_fn, xc_flat, valid_flat, boost,
                                counters, frac=None):
        """Run the canonical field only on a fixed budget of valid candidate
        lanes; the rest get neutral fills (sdf = 1e5).  ``frac`` overrides
        the configured budget fraction (0: every lane)."""

        def run(p):
            ret, j_inv_nr = geometry_fn(p)
            if not isinstance(ret, (tuple, list)):
                ret = (ret,)
            return tuple(ret) + (() if j_inv_nr is None else (j_inv_nr,))

        M = xc_flat.shape[0]
        if frac is None:
            frac = self.candidate_compaction
        if frac:
            frac = min(1.0, float(frac) + 0.0625 * boost)
        if not frac or M <= 4096:
            out = run(xc_flat)
        else:
            budget = min(max(int(np.ceil(M * float(frac) / 128.0)) * 128,
                             128), M)
            record(counters, "ovf_candidate_query", torch.relu(
                valid_flat.sum(dtype=torch.int64) - budget))
            idx, picked = compact_indices(valid_flat, budget)
            res = run(xc_flat[idx])
            out = scatter_compacted(res, idx, picked, M,
                                    [_fill_for(i, o) for i, o in
                                     enumerate(res)])
        out = list(out)
        j_inv_nr = out.pop() if len(out) > 1 and out[-1].dim() == 3 else None
        return tuple(out), j_inv_nr

    def deform(self, statics: DeformerStatics, frame: FrameState, pts,
               geometry_fn: Callable, with_jac: bool = False,
               eval_mode: bool = True, boost: int = 0, counters=None):
        """Canonicalize points, query geometry, min-SDF candidate reduce.

        Returns ``(pts_cano, sdf, valid_any, sdf_grad_obs, sdf_grad_cano,
        feature)`` (the last three when ``geometry_fn`` returns them), with
        invalid points carrying sdf = 1e5.  A ``geometry_fn`` that returns
        gradients needs ``with_jac``: the rotation that takes them to
        observation space is blended only then.  In train mode with a
        ``frame.tfs`` that requires a gradient the roots and the rotation
        carry it (:class:`_SkinningCorrection`); otherwise the correction is
        zero in value and in gradient, so train mode gives the eval-mode
        outputs.
        """
        N = pts.shape[0]
        I, K = self.n_init, min(self.max_candidates, self.n_init)
        res = self.search(statics, frame, pts)
        # the single-phase search drops no lane
        record(counters, "ovf_broyden_phase2",
               torch.zeros((), dtype=torch.int64, device=pts.device))
        # the blended rotation is read only by a gradient query without J^-1
        need_rot = with_jac and not self.use_j_inv
        pose_grad = not eval_mode and frame.tfs.requires_grad \
            and torch.is_grad_enabled()
        ep = deform_epilogue(res, I, K, need_rot and not pose_grad,
                             statics.lbs_cl, self.spec,
                             frame.tfs.detach().contiguous(), frame.voxel_J)
        record(counters, "ovf_candidates", ep.overflow)
        xc, rot = ep.xc, ep.fwd_rot
        if pose_grad:
            xc, rot = _SkinningCorrection.apply(
                ep.xc, ep.j_inv, ep.valid, frame.tfs, statics.lbs_cl,
                self.spec, frame.voxel_J, need_rot)
        c2w = ep.j_inv if self.use_j_inv else rot                 # [M, 9]
        return self._finish_query(N, K, xc, c2w, ep.valid, geometry_fn,
                                  boost, counters)

    def deform_seeded(self, statics: DeformerStatics, frame: FrameState, pts,
                      seed_xc, seed_ok, geometry_fn: Callable,
                      with_jac: bool = True, eval_mode: bool = True,
                      boost: int = 0, counters=None, seed_iters=None):
        """Canonicalization warm-started at known nearby roots ``seed_xc
        [N, 3]`` (``seed_ok [N]`` marks the usable ones): one polish lane
        per point (kernel KL) replaces the search, its filter and its
        top-K; outputs as :meth:`deform`.  The polish runs ``seed_iters``
        iterations (None: ``seed_polish_iters``; the seed grid's callers
        pass ``seed_grid_polish_iters``).  Lanes whose polish fails despite
        a usable seed are counted (``sec_seed_polish_fail``).  In train mode
        with a ``frame.tfs`` that requires a gradient the polished roots
        (detached, with their J^-1) and the rotation take :meth:`deform`'s
        correction (`anim/deformer.py:519-534` of the JAX package, the same
        formula); otherwise it is zero and nothing launches for it."""
        N = pts.shape[0]
        res = broyden_polish(
            pts.contiguous(), seed_xc.contiguous(), seed_ok.contiguous(),
            frame.voxel_J, self.spec.offset, self.spec.scale_kernel,
            cvg_thresh=self.cvg_thresh, dvg_thresh=self.dvg_thresh,
            max_iters=(self.seed_polish_iters if seed_iters is None
                       else int(seed_iters)))
        record(counters, "sec_seed_polish_fail",
               (seed_ok & ~res.valid).sum(dtype=torch.int64))
        need_rot = with_jac and not self.use_j_inv
        pose_grad = not eval_mode and frame.tfs.requires_grad \
            and torch.is_grad_enabled()
        xc, rot = res.x, None
        if pose_grad:
            xc, rot = _SkinningCorrection.apply(
                res.x, res.j_inv, res.valid, frame.tfs, statics.lbs_cl,
                self.spec, frame.voxel_J, need_rot)
        elif need_rot:
            rot = deform_skinning(res.x, statics.lbs_cl, self.spec,
                                  frame.tfs.detach().contiguous(),
                                  frame.voxel_J)
        c2w = res.j_inv if self.use_j_inv else rot
        # the lanes were compacted by the caller and are mostly valid: no
        # candidate-level budget (`anim/deformer.py:424-429` of the JAX
        # package)
        return self._finish_query(N, 1, xc, c2w, res.valid, geometry_fn,
                                  boost, counters, frac=0.0)

    def _finish_query(self, N, K, xc, c2w, valid_flat, geometry_fn, boost,
                      counters, frac=None):
        ret, j_inv_nr = self._query_geometry_compact(
            geometry_fn, xc, valid_flat, boost, counters, frac)
        sdf = torch.where(valid_flat, ret[0], 1e5).reshape(N, K)
        idx = torch.argmin(sdf, dim=-1)
        sel = torch.arange(N, device=xc.device) * K + idx
        out = [xc[sel], sdf.min(-1).values, valid_flat.reshape(N, K).any(-1)]
        if len(ret) > 1:
            if c2w is None:
                raise ValueError("a geometry query that returns gradients "
                                 "needs deform(..., with_jac=True)")
            gx, gy, gz = ret[1].unbind(-1)
            c = c2w.unbind(-1)
            if j_inv_nr is not None:
                nr = j_inv_nr.reshape(-1, 9).unbind(-1)
                c = tuple(c[3 * a] * nr[b] + c[3 * a + 1] * nr[3 + b]
                          + c[3 * a + 2] * nr[6 + b]
                          for a in range(3) for b in range(3))
            vf = valid_flat.to(gx.dtype)
            ox = vf * (c[0] * gx + c[1] * gy + c[2] * gz)
            oy = vf * (c[3] * gx + c[4] * gy + c[5] * gz)
            oz = vf * (c[6] * gx + c[7] * gy + c[8] * gz) + (1.0 - vf)
            gcz = vf * gz + (1.0 - vf)
            out.append(torch.stack([ox, oy, oz], -1)[sel])
            out.append(torch.stack([vf * gx, vf * gy, gcz], -1)[sel])
        if len(ret) > 2:
            feat = torch.where(valid_flat[:, None], ret[2], 0.0)
            out.append(feat[sel])
        return out


class _SkinningCorrection(torch.autograd.Function):
    """``(xc [M, 3], jinv [M, 9], valid [M], tfs [24, 4, 4]) -> (xc,
    rot [M, 9])``: the detached roots unchanged in value, and, with
    ``need_rot``, the blended LBS rotation rows (kernel KH's skinning,
    which reads ``voxel_J``, the transform voxel of ``lbs_cl`` and ``tfs``
    detached, of the same frame).
    The backward gives ``tfs`` the cotangent of the correction ``xc - v
    J^-1 (x_d(xc, tfs) - sg(x_d))`` and of the rotation (kernel KN); the
    roots, ``jinv`` and ``valid`` get none, as in the JAX package."""

    @staticmethod
    def forward(ctx, xc, jinv, valid, tfs, lbs_cl, spec, voxel_J, need_rot):
        ctx.spec, ctx.need_rot = spec, need_rot
        ctx.save_for_backward(xc, jinv, valid, lbs_cl)
        rot = (deform_skinning(xc, lbs_cl, spec, tfs.detach().contiguous(),
                               voxel_J) if need_rot else None)
        return xc.clone(), rot

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g_xc, g_rot):
        xc, jinv, valid, lbs_cl = ctx.saved_tensors
        d_tfs = None
        if ctx.needs_input_grad[3]:
            d_tfs = deform_skinning_bwd(
                xc, valid, jinv, g_xc.contiguous(),
                g_rot.contiguous() if ctx.need_rot and g_rot is not None
                else None, lbs_cl, ctx.spec)
        return None, None, None, d_tfs, None, None, None, None


def _fill_for(i, o):
    """Neutral fill of output ``i`` of a geometry query: far-outside sdf,
    identity Jacobians, +z gradients, zero features."""
    if i == 0:
        return 1e5
    if o.dim() == 3:
        return torch.eye(3)
    if o.dim() == 2 and o.shape[-1] == 3:
        return [0.0, 0.0, 1.0]
    return 0.0


@register("snarf_deformer")
class SNARFDeformer(nn.Module):
    """Facade composing the rigid Fast-SNARF with the non-rigid field
    (``x -> non_rigid(x) -> geometry(x')``)."""

    def __init__(self, config):
        super().__init__()
        self.rigid = make(config.rigid_deformer.name, config.rigid_deformer)
        self.non_rigid = make(config.non_rigid_deformer.name,
                              config.non_rigid_deformer)

    def initialize(self, betas, device):
        statics = self.rigid.initialize(betas, device)
        self.non_rigid.prepare_bbox(self.rigid.bbox)
        return statics

    @property
    def bbox(self):
        return self.rigid.bbox

    def prepare(self, statics, smpl_params):
        return self.rigid.prepare(statics, smpl_params)

    def forward(self, statics, frame, points, cond, geometry_fn,
                with_jac=False, eval_mode=True, global_step=0, boost=0,
                counters=None, seed=None, seed_iters=None):
        """Canonicalize ``points``; with ``seed = (seed_xc, seed_ok)`` by
        the seeded polish of ``seed_iters`` iterations (None: the
        deformer's ``seed_polish_iters``), else by the search; either in
        ``eval_mode`` or with the train-mode correction."""
        def composed_geometry_fn(x):
            x_nr, j_inv_nr = self.non_rigid(x, cond=cond, with_jac=with_jac,
                                            global_step=global_step)
            return geometry_fn(x_nr), j_inv_nr

        if seed is not None:
            return self.rigid.deform_seeded(
                statics, frame, points, seed[0], seed[1],
                composed_geometry_fn, with_jac=with_jac, eval_mode=eval_mode,
                boost=boost, counters=counters, seed_iters=seed_iters)
        return self.rigid.deform(statics, frame, points, composed_geometry_fn,
                                 with_jac=with_jac, eval_mode=eval_mode,
                                 boost=boost, counters=counters)
