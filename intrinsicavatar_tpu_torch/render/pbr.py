"""Physically based shading: scattering points and secondary rays
(counterpart of the JAX package's ``render/pbr.py``).

- :func:`sample_volume_interaction` draws ``spp`` scattering points per ray
  (kernel KI) and reuses the primary pass's normals and materials there;
- :func:`compute_indirect_radiance` marches secondary rays in shader chunks:
  the march with its cap of occupied samples (kernel KK), the coarse SDF
  (with a seed grid, the eval frame's by default or a training step's
  with ``train_seed_grid``: one compacted gather of the grid, kernel KM;
  without it, by the inverse-skinning search), the zero-crossing
  fine resampling (kernel KJ), the fine query seeded from the nearest
  valid coarse root (kernel KL), radiance and compositing -> per-ray
  (transmittance, indirect rgb);
- :func:`pbr_forward` assembles ``comp_rgb_phys`` / ``comp_demod_phys``
  (and ``visibility``) in the four render modes: ``uniform_light`` (16 x 32
  stratified sphere, shuffled per ray), ``light`` (emitter sampling),
  ``mats`` (BRDF sampling) and ``mis`` (both, MIS-weighted).

The scattering-point draw and the secondary rays run without autograd (the
JAX package's ``stop_gradient``, the reference's ``torch.no_grad``); in
training gradients reach the materials and normals through
``scatterer.eval``, the emitter through its radiance, and the primary
weights through the Monte-Carlo weights and the kd/ks composition.  In
every mode that samples (``light``, ``mats``, ``mis``) the emitter's
sampling tables are built without autograd; the BRDF-sampled directions,
``mats``'s pdf and the MIS weights are detached, as the JAX package's
``stop_gradient`` places them (`render/pbr.py:455-520`).  Its
randomness comes through ``draws`` (see :func:`pbr_forward`) or from a
``torch.Generator``.  The queried secondary coarse pass runs in the
``secondary_coarse_dtype`` compute scope (bf16 by default, as in JAX), the
fine shading query in ``secondary_fine_dtype`` (float32 by default).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from intrinsicavatar_tpu_torch.ops import precision
from intrinsicavatar_tpu_torch.ops import resample as RS
from intrinsicavatar_tpu_torch.ops import volrend as V
from intrinsicavatar_tpu_torch.ops.compact import compact_apply
from intrinsicavatar_tpu_torch.ops.grid_traversal import secondary_march
from intrinsicavatar_tpu_torch.ops.math import safe_normalize
from intrinsicavatar_tpu_torch.pbr.envlight import (
    sample_uniform_sphere_stratified,
)
from intrinsicavatar_tpu_torch.utils.diag import record


class VolumeInteractions(NamedTuple):
    positions: torch.Tensor   # [R, B, 3] scattering points (SMPL space)
    normals: torch.Tensor     # [R, B, 3] primary normals there
    albedo: torch.Tensor      # [R, B, 3]
    roughness: torch.Tensor   # [R, B, 1]
    metallic: torch.Tensor    # [R, B, Cm]
    weights: torch.Tensor     # [R, B] MC weights (fg w/cnt, bg trans/cnt)
    is_bg: torch.Tensor       # [R, B]
    valid: torch.Tensor       # [R] the ray has a primary sample


def sample_volume_interaction(rays_o, rays_d, t_starts, t_ends, smask,
                              weights, sdf, normals, mats, trans_map,
                              spp: int) -> VolumeInteractions:
    """`models/pbr/utils.py:70-229` of the reference, rectangular."""
    out = RS.cdf_resample_rays(t_starts.contiguous(), t_ends.contiguous(),
                               weights.detach().contiguous(),
                               sdf.detach().contiguous(), smask.contiguous(),
                               spp)
    idx = out.indices.long()
    take = lambda a: torch.gather(a, 1, idx)
    w_fg = take(weights) / torch.clamp(take(out.fg_counts).to(weights.dtype),
                                       min=1.0)
    w_bg = trans_map[:, None] / torch.clamp(
        out.bg_count[:, None].to(weights.dtype), min=1.0)
    valid = smask.any(-1)
    w = torch.where(valid[:, None], torch.where(out.is_bg, w_bg, w_fg), 0.0)
    take3 = lambda a: torch.gather(
        a, 1, idx[..., None].expand(-1, -1, a.shape[-1]))
    return VolumeInteractions(
        positions=rays_o[:, None, :] + rays_d[:, None, :] * out.ts[..., None],
        normals=take3(normals), albedo=take3(mats[..., :3]),
        roughness=take3(mats[..., 3:4]), metallic=take3(mats[..., 4:]),
        weights=w, is_bg=out.is_bg, valid=valid)


def secondary_budget(model, smask, fine: bool = False, boost: int = 0):
    """Static query budget of a secondary pass (`render/pbr.py:172-191` of
    the JAX package): ``secondary_query_compaction`` (0.125) of the coarse
    slots, ``secondary_fine_query_compaction`` (0.5) of the fine ones."""
    key = ("secondary_fine_query_compaction" if fine
           else "secondary_query_compaction")
    frac = float(model.config.get(key, 0.5 if fine else 0.125))
    frac = min(1.0, frac + 0.0625 * boost)
    M = smask.shape[0] * smask.shape[1]
    return min(max(int(-(-M * frac // 128)) * 128, 128), M)


def compute_indirect_radiance(model, statics, frame, cond, sched, binaries,
                              aabb, rays_o, rays_d, step, flags, active,
                              counters=None, seed_grid=None):
    """Secondary rays ``[M, 3]`` (SMPL space) -> ``(transmittance [M], rgb
    [M, 3])``, in chunks of ``secondary_shader_chunk`` rays (the last one
    padded with inactive rays of direction 1); the chunks' counters are
    summed (`models/intrinsic_avatar.py:396-545` of the reference).
    ``seed_grid`` is the frame's eval seed grid, a training step's grid,
    or None."""
    if float(model.config.get("secondary_active_compaction", 0.0)):
        raise NotImplementedError(
            "secondary_active_compaction is not ported yet")
    M = rays_o.shape[0]
    chunk = int(model.config.get("secondary_shader_chunk", 32768))
    if M <= chunk:
        return _indirect_impl(model, statics, frame, cond, sched, binaries,
                              aabb, rays_o, rays_d, step, flags, active,
                              counters, seed_grid)
    pad = -M % chunk
    ro = torch.cat([rays_o, rays_o.new_zeros((pad, 3))])
    rd = torch.cat([rays_d, rays_d.new_ones((pad, 3))])
    act = torch.cat([active, active.new_zeros((pad,))])
    trs, rgbs = [], []
    for i in range(0, M + pad, chunk):
        tr, rgb = _indirect_impl(model, statics, frame, cond, sched,
                                 binaries, aabb, ro[i:i + chunk],
                                 rd[i:i + chunk], step, flags,
                                 act[i:i + chunk], counters, seed_grid)
        trs.append(tr)
        rgbs.append(rgb)
    return torch.cat(trs)[:M], torch.cat(rgbs)[:M]


def _baked(model, seed_grid) -> bool:
    """The secondary coarse pass reads its SDF from the seed grid."""
    return (seed_grid is not None and seed_grid.has_sdf
            and bool(model.config.get("baked_secondary_coarse", True)))


def _indirect_impl(model, statics, frame, cond, sched, binaries, aabb,
                   rays_o, rays_d, step, flags, active, counters,
                   seed_grid=None):
    M = rays_o.shape[0]
    S = model.num_samples_per_secondary_ray
    near_p, far_p = model.secondary_near_plane, model.secondary_far_plane
    max_occ = int(model.config.get("secondary_max_valid_samples", 8))
    t_starts, t_ends, smask = secondary_march(
        rays_o.contiguous(), rays_d.contiguous(), binaries, aabb,
        (far_p - near_p) / (S - 1), S,
        torch.full((M,), near_p, device=rays_o.device),
        torch.full((M,), far_p, device=rays_o.device), active.contiguous(),
        max_occ)
    record(counters, "sec_valid_samples", smask.sum(dtype=torch.int64))
    record(counters, "sec_total_samples", torch.tensor(M * S))

    importance = model.secondary_importance_sample
    baked = _baked(model, seed_grid)
    s_iters = model.grid_iters()
    if importance:
        # coarse SDF at interval starts: it only places the fine samples
        pos = (rays_o[:, None, :] + rays_d[:, None, :] * t_starts[..., None]
               ).reshape(-1, 3)
        budget = secondary_budget(model, smask, boost=flags.budget_boost)
        if baked:
            # one gather of the grid at the occupied slots, compacted to
            # the queried pass's budget; the other slots keep the searched
            # path's fills (sdf 1e5, root 0, invalid)
            record(counters, "ovf_query",
                   torch.relu(smask.sum(dtype=torch.int64) - budget))
            xc_coarse, ok_full, sdf = compact_apply(
                lambda p: model._grid_gather(seed_grid, p), pos,
                smask.reshape(-1), budget, (0.0, False, 1e5), mask2d=smask)
            sdf = sdf.reshape(M, S)
            xc_coarse = xc_coarse.reshape(M, S, 3)
            ok_coarse = ok_full.reshape(M, S) & smask
        else:
            # it only places the fine samples: the secondary coarse scope
            # (bf16 by default; the baked pass above runs no field query)
            with precision.scope(model.config.get("secondary_coarse_dtype",
                                                  "bfloat16")):
                out = model._deform_query(
                    statics, frame, cond, pos, sched, with_grad=False,
                    global_step=step, mask=smask.reshape(-1), mask2d=smask,
                    budget=budget, counters=counters,
                    seed=model._grid_seed(seed_grid, pos),
                    seed_iters=s_iters)
            sdf = out[1].reshape(M, S)
            xc_coarse = out[0].reshape(M, S, 3)
            ok_coarse = out[2].reshape(M, S) & smask
        alphas = torch.where(smask, model.get_alpha(sdf, t_ends - t_starts,
                                                    step), 0.0)
        t_coarse = t_starts
        if model.zero_crossing_search:
            fine = RS.sdf_fine_resample_rays(t_starts, t_ends, alphas, sdf,
                                             smask, 4)
        else:
            w, _ = V.render_weight_from_alpha(alphas, smask)
            fine = RS.fine_resample_rays(t_starts, t_ends, w, smask, 4)
        smask = fine.mask
        t_starts = torch.where(smask, fine.t_starts, 0.0)
        t_ends = torch.where(smask, fine.t_ends, 0.0)

    Sf = t_starts.shape[1]
    mids = 0.5 * (t_starts + t_ends)
    pos = (rays_o[:, None, :] + rays_d[:, None, :] * mids[..., None]
           ).reshape(-1, 3)
    # seed each fine sample's inverse skinning with the root of the nearest
    # valid coarse sample on its ray (first one on ties): a converged root
    # polishes for the deformer's seed_polish_iters, a raw grid root of the
    # baked pass for seed_grid_polish_iters; with no coarse pass to seed
    # from, the grid seeds the fine samples itself
    seed, fine_iters = None, None
    if importance and bool(model.config.get("secondary_seed_fine", True)):
        d = torch.abs(mids[:, :, None] - t_coarse[:, None, :])   # [M, Sf, S]
        d = torch.where(ok_coarse[:, None, :], d, torch.inf)
        j = torch.argmin(d, -1)
        seed_xc = torch.gather(xc_coarse, 1,
                               j[..., None].expand(-1, -1, 3)).reshape(-1, 3)
        seed_ok = (torch.gather(ok_coarse, 1, j) & smask).reshape(-1)
        seed = (seed_xc, seed_ok)
        fine_iters = s_iters if baked else None
    elif seed_grid is not None:
        seed = model._grid_seed(seed_grid, pos)
        fine_iters = s_iters
    # the fine shading query and its radiance: the secondary fine scope
    # (float32 by default)
    with precision.scope(model.config.get("secondary_fine_dtype",
                                          "float32")):
        out = model._deform_query(
            statics, frame, cond, pos, sched, with_grad=True,
            global_step=step, mask=smask.reshape(-1), mask2d=smask,
            budget=secondary_budget(model, smask, fine=importance,
                                    boost=flags.budget_boost),
            counters=counters, seed=seed, seed_iters=fine_iters)
        pos_cano, sdf, _, sdf_grad, _, feat = out[:6]
        rigid = model.deformer.rigid
        normal_world = rigid.transform_dirs_s2w(frame, sdf_grad)
        dirs_world = rigid.transform_dirs_s2w(
            frame, torch.repeat_interleave(rays_d, Sf, dim=0))
        rgbs, _ = model.radiance(pos_cano, feat, dirs_world, normal_world,
                                 level_mask=sched["rad_mask"],
                                 sh_mask=sched["sh_mask"])
    alphas = model.get_alpha(sdf, (t_ends - t_starts).reshape(-1),
                             step).reshape(-1, Sf)
    w, _ = V.render_weight_from_alpha(alphas.contiguous(),
                                      smask.contiguous())
    rgb_map = V.accumulate_along_rays(w, rgbs.reshape(-1, Sf, 3), smask)
    acc = V.accumulate_along_rays(w, None, smask)[..., 0]
    return 1.0 - acc, rgb_map


def get_draw(draws, key, shape, generator, device):
    """``draws[key]`` on ``device``, else U[0, 1) of ``shape`` drawn on the
    CPU from ``generator`` and moved."""
    if draws is not None and key in draws:
        return torch.as_tensor(draws[key], device=device)
    return torch.rand(shape, generator=generator).to(device)


def pbr_forward(model, statics, frame, cond, occ, sched, rays_o, rays_d,
                t_starts, t_ends, smask, weights, sdf, mats, normals_smpl,
                step, flags, background_color, lvl, emitter_state=None,
                draws=None, generator=None, counters=None, seed_grid=None):
    """``comp_rgb_phys`` / ``comp_demod_phys`` ``[R, 3]`` (and, in
    ``uniform_light``, ``visibility [R, 1]``) for a chunk of primary rays.

    ``draws`` may hold the U[0, 1) draws of the JAX key path: ``sphere_u [2,
    n1, n2]`` (the stratified sphere's jitters), ``strata_u [R, spp]``
    (whose argsort shuffles the strata per ray), ``light_u [R * spp, 4]``
    (emitter sampling) and ``brdf_u [R * spp, 5]`` (BRDF sampling); what it
    lacks is drawn from ``generator``.
    """
    R, S = t_starts.shape
    B = model.samples_per_pixel
    dev = rays_o.device
    mode = flags.render_mode
    trans_map = 1.0 - V.accumulate_along_rays(weights, None, smask)[..., 0]
    vi = sample_volume_interaction(rays_o, rays_d, t_starts, t_ends, smask,
                                   weights, sdf, normals_smpl,
                                   mats.reshape(R, S, -1), trans_map, B)
    n_i = vi.normals.reshape(R * B, 3)
    wi = -torch.repeat_interleave(rays_d, B, dim=0)
    alb = vi.albedo.reshape(R * B, 3)
    rough = vi.roughness.reshape(R * B)
    metal = vi.metallic.reshape(R * B, -1)
    atten = torch.zeros((R * B, 1), device=dev)
    pos_i = vi.positions.reshape(R * B, 3)
    fg = ~vi.is_bg.reshape(-1)
    emitter, scatterer = model.emitter, model.scatterer
    rigid = model.deformer.rigid
    brdf = (n_i, wi)
    mat_args = (rough, rough, alb, metal, atten)

    def light_terms(dirs, active):
        with torch.no_grad():
            tr, ind_rgb = compute_indirect_radiance(
                model, statics, frame, cond, sched, occ.binaries[lvl],
                occ.aabbs[lvl], pos_i.detach(), dirs.detach(), step, flags,
                active, counters, seed_grid)
        tr = torch.clamp(tr, 0.0, 1.0)[:, None]
        em = emitter(rigid.transform_dirs_s2w(frame, dirs))
        em = torch.where((active & (tr[:, 0] > 0.0))[:, None], em, 0.0)
        Li = em * tr + ind_rgb if model.config.get("global_illumination",
                                                   True) else em * tr
        return Li, tr

    def state():
        # the sampling tables carry no gradient (the JAX package's
        # stop_gradient of update_pdf)
        if emitter_state is not None:
            return emitter_state
        with torch.no_grad():
            return emitter.update_pdf()

    vis = None
    if mode == "uniform_light":
        n1 = max(B // 32, 1)
        n2 = B // n1
        ju, jv = get_draw(draws, "sphere_u", (2, n1, n2), generator, dev)
        strata, inv_pdf = sample_uniform_sphere_stratified(ju, jv)
        perm = torch.argsort(get_draw(draws, "strata_u", (R, B), generator,
                                      dev), dim=-1)
        dirs = strata[perm].reshape(R * B, 3)
        inv_pdf = inv_pdf[perm.reshape(-1), 0][:, None]
        active = fg & (torch.sum(n_i * dirs, -1) > 1e-6)
        Li, tr = light_terms(dirs, active)
        diff, spec = scatterer.eval(*brdf, dirs, *mat_args)
        diff = torch.where(active[:, None], diff, 0.0)
        spec = torch.where(active[:, None], spec, 0.0)
        Lo_diff, Lo_spec = Li * diff * inv_pdf, Li * spec * inv_pdf
        vis = 2.0 * tr.expand(R * B, 3) * active[:, None]
    elif mode == "light":
        st = state()
        if not flags.training and not model.config.get("resample_light",
                                                       True):
            raise NotImplementedError("resample_light: false (one emitter "
                                      "sample for every pixel) is not "
                                      "ported yet")
        dirs = rigid.transform_dirs_w2s(frame, emitter.sample(
            st, get_draw(draws, "light_u", (R * B, 4), generator, dev)))
        active = fg & (torch.sum(n_i * dirs, -1) > 1e-6)
        Li, tr = light_terms(dirs, active)
        pdf = emitter.pdf(st, rigid.transform_dirs_s2w(frame, dirs))
        pdf = torch.where(pdf > 0, pdf, 1.0)
        diff, spec = scatterer.eval(*brdf, dirs, *mat_args)
        diff = torch.where(active[:, None], diff, 0.0)
        spec = torch.where(active[:, None], spec, 0.0)
        Lo_diff, Lo_spec = Li * diff / pdf, Li * spec / pdf
    elif mode == "mats":
        dirs = safe_normalize(scatterer.sample(
            *brdf, *mat_args,
            get_draw(draws, "brdf_u", (R * B, 5), generator, dev))).detach()
        Li, tr = light_terms(dirs, fg)
        pdf = scatterer.pdf(*brdf, dirs, *mat_args)
        pdf = torch.where(pdf > 0, pdf, 1.0).detach()
        diff, spec = scatterer.eval(*brdf, dirs, *mat_args)
        Lo_diff, Lo_spec = Li * diff / pdf, Li * spec / pdf
    elif mode == "mis":
        st = state()
        d_sc = safe_normalize(scatterer.sample(
            *brdf, *mat_args,
            get_draw(draws, "brdf_u", (R * B, 5), generator, dev))).detach()
        d_li = rigid.transform_dirs_w2s(frame, emitter.sample(
            st, get_draw(draws, "light_u", (R * B, 4), generator, dev)))
        Lo_diff = Lo_spec = 0.0
        # no cosine gating here: the MIS weights and the BRDF alone, as the
        # reference's pbr_mis_forward (`models/intrinsic_avatar.py:547-658`)
        for dirs in (d_sc, d_li):
            Li, tr = light_terms(dirs, fg)
            p_sc = scatterer.pdf(*brdf, dirs, *mat_args)
            p_li = emitter.pdf(st, rigid.transform_dirs_s2w(frame, dirs))
            mis_w = torch.where(p_sc + p_li > 1e-6, 1.0 / (p_sc + p_li),
                                0.0).detach()
            diff, spec = scatterer.eval(*brdf, dirs, *mat_args)
            Lo_diff = Lo_diff + Li * diff * mis_w
            Lo_spec = Lo_spec + Li * spec * mis_w
    else:
        raise NotImplementedError(f"render_mode {mode!r}")

    # kd/ks composition (`models/intrinsic_avatar.py:636-645`)
    if metal.shape[-1] == 1:
        kd, ks = (1.0 - metal) * alb, 1.0
    else:
        kd, ks = alb, metal
    if model.add_emitter:
        bg_li = emitter(rigid.transform_dirs_s2w(
            frame, torch.repeat_interleave(rays_d, B, dim=0)))
        ray_bg = emitter(rigid.transform_dirs_s2w(frame, rays_d))
    else:
        bg_li = background_color[None, :].expand(R * B, 3)
        ray_bg = background_color[None, :].expand(R, 3)
    Lo = torch.where(fg[:, None], kd * Lo_diff + ks * Lo_spec, bg_li)
    Lo_demod = torch.where(fg[:, None], Lo_diff + Lo_spec, bg_li)
    w = vi.weights
    no_sample = ~vi.valid[:, None]
    out = {"comp_rgb_phys": torch.where(
               no_sample, ray_bg,
               V.accumulate_along_rays(w, Lo.reshape(R, B, 3))),
           "comp_demod_phys": torch.where(
               no_sample, ray_bg,
               V.accumulate_along_rays(w, Lo_demod.reshape(R, B, 3)))}
    if vis is not None:
        out["visibility"] = V.accumulate_along_rays(
            w, vis.reshape(R, B, 3)).mean(-1, keepdim=True)
    return out
