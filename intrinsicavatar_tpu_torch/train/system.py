"""The training system: loss assembly, the train step, the occupancy cadence
and the training loop (counterpart of the JAX package's ``train/system.py``):
the radiance regime, and from ``phys_kick_in_step`` the phys regime in
``uniform_light``; with pose correction the per-frame corrections train from
``pose_correction_start_step`` on (kernel KN in the backward).

One step (``train_step``): the sampling stage without gradient, then the
differentiated shading pass, the losses, ``loss.backward()`` (kernels KA',
KB' and KD' on a card) and one Adam update; the occupancy grid's EMA update
runs every ``occ_update_every`` (20) steps.  Unlike the JAX package's
functional ``TrainState``, the parameters, the optimizer and the occupancy
grid live on the system and are updated in place.

Randomness is passed in through ``draws`` (``bg`` [3], ``strat_u`` [R],
``lap_sub`` [n], ``lap_u`` [n, 3] for a step, in the phys regime also
``jit_sub``, ``jit_noise``, ``sphere_u`` and ``strata_u`` (see
:meth:`IntrinsicAvatar.forward`); ``occ_u`` [res^3, 1, 3] for an occupancy
update) or drawn from the system's ``torch.Generator``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from intrinsicavatar_tpu_torch.ops.math import (
    gaussian_histogram, linear_to_srgb, luma, luminance,
)
from intrinsicavatar_tpu_torch.ops.volrend import distortion_loss
from intrinsicavatar_tpu_torch.registry import register
from intrinsicavatar_tpu_torch.render.occupancy import (
    OccGridState, compute_test_occ_grid, level_of, make_occ_grid,
    update_occ_grid,
)
from intrinsicavatar_tpu_torch.render.renderer import (
    IntrinsicAvatar, RenderFlags, get_draw,
)
from intrinsicavatar_tpu_torch.train.optim import (
    make_optimizer, step_every_leaf,
)
from intrinsicavatar_tpu_torch.train.schedules import C, lr_schedule_host
from intrinsicavatar_tpu_torch.utils.device import resolve_device
from intrinsicavatar_tpu_torch.weights import from_jax_params

BUDGET_COUNTERS = ("ovf_shading", "ovf_query", "ovf_candidate_query")


def masked_mean(x, mask):
    """Mean of ``x`` over the rows ``mask`` selects (``x[mask].mean()``)."""
    if x.dim() > mask.dim():
        mask = mask[..., None]
    m = mask.to(x.dtype)
    return torch.sum(x * m) / torch.clamp(torch.sum(m * torch.ones_like(x)),
                                          min=1.0)


def binary_cross_entropy(pred, target):
    return -torch.mean(target * torch.log(pred)
                       + (1.0 - target) * torch.log(1.0 - pred))


@register("intrinsic-avatar-system")
class IntrinsicAvatarSystem:
    """Owns the model, the optimizer, the occupancy grid and the step."""

    def __init__(self, config, device=None):
        self.config = config
        self.device = resolve_device(device)
        tcfg, scfg, mcfg = config.trainer, config.system, config.model
        if int(tcfg.get("grad_accum", 1)) > 1:
            raise NotImplementedError("trainer.grad_accum > 1 is not ported "
                                      "yet")
        for key in ("adaptive_query_compaction", "train_seed_grid"):
            if mcfg.get(key, False):
                raise NotImplementedError(f"model.{key} is not ported yet")
        if [s for s in scfg.get("reinit_optimizer_steps", []) if s >= 0] \
                or int(scfg.get("reinit_shape_every_n_steps", -1)) > 0:
            raise NotImplementedError("optimizer and shape re-inits are not "
                                      "ported yet")
        self.model = IntrinsicAvatar(mcfg).to(self.device)
        self.loss_cfg = scfg.loss
        self.reinit_occ_steps = list(scfg.get("reinit_occupancy_grid_steps",
                                              [8000]))
        self.occ_update_every = scfg.get("occ_update_every", 20)
        # overflow-feedback escalation: each level adds 1/16 of headroom to
        # every fractional query budget (RenderFlags.budget_boost)
        self._budget_boost = int(scfg.get("budget_boost_init", 0))
        self._budget_boost_max = int(scfg.get("budget_boost_max", 6))
        self.generator = torch.Generator().manual_seed(
            int(config.get("seed", 42)))
        self.statics = self.optimizer = self.scheduler = self.occ = None
        self.step = 0

    # ------------------------------------------------------------ setup

    def setup(self, betas, params=None):
        """Statics, parameters (random from the system's generator, or the
        JAX tree ``params``), optimizer and an all-occupied grid."""
        self.statics = self.model.initialize(betas)
        if params is None:
            self.model.init(self.generator)
        else:
            from_jax_params(self.model, params)
        scfg = self.config.system
        self.optimizer, self.scheduler = make_optimizer(
            self.model, scfg.optimizer, scfg.get("scheduler", {}),
            scfg.get("warmup_steps", 1000))
        self.occ = make_occ_grid(
            np.asarray(self.config.model.scene_aabb, np.float32)[None],
            resolution=self.config.model.get("occ_resolution", 64),
            device=self.device)
        self.step = 0
        return self

    def to_device(self, batch: dict) -> dict:
        return {k: torch.as_tensor(v, device=self.device)
                for k, v in batch.items() if k != "t_idx"}

    # ------------------------------------------------------------ flags

    def flags_for_step(self, step: int, training: bool = True) -> RenderFlags:
        mcfg = self.config.model
        return RenderFlags(
            training=training,
            enable_phys=step >= mcfg.get("phys_kick_in_step", 10000),
            importance_sample=step > mcfg.get(
                "importance_sample_kick_in_step", 1000),
            randomized=training and mcfg.get("randomized", True),
            with_curvature_loss=C(self.loss_cfg.lambda_curvature, step) > 0,
            jitter_materials=C(self.loss_cfg.lambda_albedo_smoothness,
                               step) > 0,
            render_mode=mcfg.get("render_mode", "uniform_light"),
            # full query budgets while the grid is still mostly occupied
            full_budget=training and step < mcfg.get(
                "compaction_warmup_steps", 512),
            budget_boost=self._budget_boost)

    # ------------------------------------------------------------ losses

    def compute_losses(self, out, batch, step: int, flags: RenderFlags):
        """The terms of `systems/intrinsic_avatar.py:160-301` (masked,
        rectangular), the PBR ones in the phys regime; ``(loss, {name:
        value})``."""
        L = self.loss_cfg
        losses = {}
        loss = 0.0
        valid = out["rays_valid"][..., 0]
        if not (self.config.system.get("pbr_loss_only", False)
                and flags.enable_phys):
            diff = out["comp_rgb_full"] - batch["rgb"]
            losses["rgb_mse"] = masked_mean(diff ** 2, valid)
            losses["rgb_l1"] = masked_mean(torch.abs(diff), valid)
            loss = losses["rgb_mse"] * C(L.lambda_rgb_mse, step) \
                + losses["rgb_l1"] * C(L.lambda_rgb_l1, step)
        if flags.enable_phys and self.config.model.get("learn_material",
                                                        True):
            loss = loss + self._phys_image_losses(out, batch, step, losses)

        # Eikonal over all marching samples (deformer-invalid samples carry
        # the unit fill gradient and contribute 0)
        smask = out["sample_mask"]
        grad_norm = torch.linalg.vector_norm(
            out["sdf_grad_samples"].reshape(*smask.shape, 3), dim=-1)
        losses["eikonal"] = masked_mean((grad_norm - 1.0) ** 2, smask)
        loss = loss + losses["eikonal"] * C(L.lambda_eikonal, step)

        opacity = torch.clamp(out["opacity"].reshape(-1), 1e-3, 1.0 - 1e-3)
        if "alpha" in batch:
            alpha = batch["alpha"].to(opacity.dtype)
            losses["mask_mse"] = torch.mean((opacity - alpha) ** 2)
            losses["mask_bce"] = binary_cross_entropy(opacity, alpha)
            loss = loss + losses["mask_mse"] * C(L.lambda_mask_mse, step) \
                + losses["mask_bce"] * C(L.lambda_mask_bce, step)
        losses["opaque"] = binary_cross_entropy(opacity, opacity)
        loss = loss + losses["opaque"] * C(L.lambda_opaque, step)

        sdf = out["sdf_samples"].reshape(smask.shape)
        losses["sparsity"] = masked_mean(
            torch.exp(-L.get("sparsity_scale", 1.0) * torch.abs(sdf)), smask)
        loss = loss + losses["sparsity"] * C(L.lambda_sparsity, step)

        if flags.with_curvature_loss:
            losses["curvature"] = masked_mean(
                torch.abs(out["sdf_laplace_samples"]), out["laplace_mask"])
            loss = loss + losses["curvature"] * C(L.lambda_curvature, step)

        dist_spec = L.get("lambda_distortion", 0.0)
        if isinstance(dist_spec, (int, float)):
            dist_on = float(dist_spec) != 0.0
        else:
            vals = list(dist_spec)
            vals = vals[0:2] if len(vals) == 3 else vals[1:3]
            dist_on = any(float(v) != 0.0 for v in vals)
        if dist_on:
            half = out["intervals"] / 2.0
            losses["distortion"] = distortion_loss(
                out["weights"], out["points"] - half, out["points"] + half,
                smask)
            loss = loss + losses["distortion"] * C(L.lambda_distortion, step)

        losses["lipshitz_bound"] = self.model.lipschitz_bound()
        loss = loss + losses["lipshitz_bound"] * C(L.lambda_lipshitz_bound,
                                                   step)
        if flags.enable_phys:
            loss = loss + self._phys_regularizers(out, step, losses)
        losses.update(out.get("counters", {}))
        losses["beta"] = out["beta"]
        losses["total"] = loss
        return loss, losses

    def _phys_image_losses(self, out, batch, step, losses):
        """The physically based image terms (`train/system.py:178-204` of
        the JAX package): the rendered image against the target (over
        every ray with ``add_emitter``, whose target is the unmasked
        image), its demodulated luma against the target's max channel, and
        the albedo where the frames carry one."""
        L = self.loss_cfg
        vphys = out["rays_valid_phys_full"][..., 0]
        add_emitter = self.model.add_emitter
        target = batch.get("rgb_wo_mask", batch["rgb"]) if add_emitter \
            else batch["rgb"]
        dphys = out["comp_rgb_phys_full"] - target
        if add_emitter:
            losses["rgb_phys_mse"] = torch.mean(dphys ** 2)
            losses["rgb_phys_l1"] = torch.mean(torch.abs(dphys))
        else:
            losses["rgb_phys_mse"] = masked_mean(dphys ** 2, vphys)
            losses["rgb_phys_l1"] = masked_mean(torch.abs(dphys), vphys)
        loss = losses["rgb_phys_mse"] * C(L.lambda_rgb_phys_mse, step) \
            + losses["rgb_phys_l1"] * C(L.lambda_rgb_phys_l1, step)
        demod = torch.abs(luma(out["comp_demod_phys_full"])
                          - torch.amax(batch["rgb"], -1, keepdim=True))
        losses["rgb_demodulated"] = masked_mean(demod, vphys)
        loss = loss + losses["rgb_demodulated"] * C(L.lambda_rgb_demodulated,
                                                    step)
        if C(L.lambda_albedo, step) > 0 and "albedo" in batch:
            losses["albedo"] = masked_mean(
                torch.abs(out["comp_albedo_full"] - batch["albedo"]), vphys)
            loss = loss + losses["albedo"] * C(L.lambda_albedo, step)
        return loss

    def _phys_regularizers(self, out, step, losses):
        """Normal orientation, the three smoothness terms, the albedo
        entropy and the energy conservation (`train/system.py:247-286` of
        the JAX package)."""
        L = self.loss_cfg
        loss = 0.0
        for k in ("normal_orientation", "albedo_smoothness",
                  "roughness_smoothness", "metallic_smoothness"):
            key = "normals_orientation" if k == "normal_orientation" else k
            losses[k] = torch.mean(out[f"{key}_loss_map"])
            loss = loss + losses[k] * C(getattr(L, f"lambda_{k}"), step)
        vphys = out["rays_valid_phys_full"][..., 0]
        n_valid = torch.clamp(vphys.sum(), min=1).to(torch.float32)
        if C(L.lambda_albedo_entropy, step) > 0:
            alb = torch.log(out["comp_albedo_full"] + 1e-6)
            ent = 0.0
            for i in range(3):
                ch = torch.where(vphys, alb[..., i], 0.0)
                mean = torch.sum(ch) / n_valid
                var = torch.sum(torch.where(vphys, (alb[..., i] - mean) ** 2,
                                            0.0)) / n_valid
                h = gaussian_histogram(ch, 15, 0.0, 1.0,
                                       torch.clamp(var, min=1e-4))
                h = h / torch.clamp(h.sum(), min=1e-6) + 1e-6
                ent = ent + torch.sum(-h * torch.log(h))
            losses["albedo_entropy"] = ent
            loss = loss + ent * C(L.lambda_albedo_entropy, step)
        if out["comp_metallic_full"].shape[-1] == 3:
            ec = torch.relu(luminance(out["comp_albedo_full"])
                            + luminance(out["comp_metallic_full"]) - 1.0)
            losses["energy_conservation"] = masked_mean(ec, vphys)
            loss = loss + losses["energy_conservation"] * C(
                L.lambda_energy_conservation, step)
        return loss

    # ------------------------------------------------------------ steps

    def background(self, draws=None):
        mode = self.config.model.get("background_color", "random")
        if mode == "white":
            return torch.ones(3, device=self.device)
        if mode == "black":
            return torch.zeros(3, device=self.device)
        return get_draw(draws, "bg", lambda g: torch.rand((3,), generator=g),
                        self.generator, self.device)

    def train_step(self, batch, t_idx, flags: RenderFlags, draws=None):
        """One optimization step at ``self.step``; returns the losses
        (detached) with the sampling stage's counters folded in.  The
        gradients stay in the parameters' ``.grad`` until the next step."""
        step = self.step
        bg = self.background(draws)
        fg = batch["alpha"][..., None]
        rgb = batch["rgb"] * fg + linear_to_srgb(bg)[None, :] * (1.0 - fg)
        batch = {**batch, "rgb_wo_mask": batch["rgb"], "rgb": rgb}
        frame, cond = self.model.prepare(self.statics, batch, step,
                                         training=flags.training)
        s_counters: dict = {}
        intervals = self.model.sample_intervals(
            self.statics, frame, cond, self.occ, batch["rays"], step, flags,
            t_idx, draws, self.generator, s_counters)
        self.optimizer.zero_grad(set_to_none=True)
        out = self.model(self.statics, frame, cond, self.occ, batch["rays"],
                         step, flags, t_idx=t_idx, background_color=bg,
                         intervals=intervals, draws=draws,
                         generator=self.generator)
        loss, losses = self.compute_losses(out, batch, step, flags)
        loss.backward()
        step_every_leaf(self.optimizer)
        self.scheduler.step()
        self.step = step + 1
        losses = {k: torch.as_tensor(v).detach() for k, v in losses.items()}
        for k, v in s_counters.items():
            v = torch.as_tensor(v).to(torch.int32)
            losses[k] = losses[k] + v if k in losses else v
        return losses

    def occ_update_step(self, batch, t_idx, draws=None):
        """EMA occupancy update on the current frame's level
        (`models/intrinsic_avatar.py:256-264`)."""
        step = self.step
        frame, cond = self.model.prepare(self.statics, batch, step)
        sched = self.model.schedules(step, self.device)
        fn = self.model.occ_eval_fn(self.statics, frame, cond, sched, step)
        res = self.occ.binaries.shape[1]
        jitter = get_draw(draws, "occ_u",
                          lambda g: torch.rand((res ** 3, 1, 3),
                                               generator=g),
                          self.generator, self.device)
        mcfg = self.config.model
        self.occ = update_occ_grid(
            self.occ, level_of(self.occ, t_idx), fn, jitter,
            occ_thre=mcfg.get("grid_prune_occ_thre", 0.001),
            ema_decay=mcfg.get("grid_prune_ema_decay", 0.8))

    @torch.no_grad()
    def reinit_occupancy_grid(self, batches):
        """One deformed-space level per frame (`systems/intrinsic_avatar.py:
        46-79`): each from 3 jittered samples per voxel."""
        res = self.config.model.get("occ_resolution", 64)
        occ_thre = self.config.model.get("grid_prune_occ_thre", 0.001)
        binaries, aabbs = [], []
        for batch in batches:
            frame, cond = self.model.prepare(self.statics, batch, self.step)
            sched = self.model.schedules(self.step, self.device)
            aabb2 = self.model.deformer.rigid.get_bbox_deformed(frame)
            aabb = torch.cat([aabb2[0], aabb2[1]])
            fn = self.model.occ_eval_fn(self.statics, frame, cond, sched,
                                        self.step)
            binaries.append(compute_test_occ_grid(
                fn, aabb, resolution=res, occ_thre=occ_thre,
                generator=self.generator))
            aabbs.append(aabb)
        self.occ = OccGridState(
            occs=torch.zeros((len(batches), res ** 3), device=self.device),
            binaries=torch.stack(binaries), aabbs=torch.stack(aabbs))

    # ------------------------------------------------------------ loop

    def fit(self, data_iter, max_steps: int, log_every: int = 100,
            callback=None, all_frames_fn=None, draws_fn=None):
        """The training loop from ``self.step`` to ``max_steps``.

        ``data_iter`` yields ``(batch, t_idx)`` (numpy arrays or tensors);
        ``all_frames_fn()`` returns one pose batch per training frame, for
        the grid re-init at the milestone steps; ``draws_fn(step)`` returns
        the draws of that step's occupancy update and train step.  Returns
        the ``(step, scalars)`` history of the log steps; a logged nonzero
        budget-overflow counter raises ``budget_boost`` by one level.
        """
        history = []
        ovf_window: dict = {}
        t0, step0, rays = time.perf_counter(), self.step, 0
        for step in range(self.step, max_steps):
            batch, t_idx = next(data_iter)
            batch = self.to_device(batch)
            draws = draws_fn(step) if draws_fn is not None else None
            if step in self.reinit_occ_steps and all_frames_fn is not None:
                self.reinit_occupancy_grid(
                    [self.to_device(b) for b in all_frames_fn()])
            if step % self.occ_update_every == 0:
                self.occ_update_step(batch, t_idx, draws)
            losses = self.train_step(batch, t_idx, self.flags_for_step(step),
                                     draws)
            rays += int(batch["rays"].shape[0])
            for k in BUDGET_COUNTERS:
                if k in losses:
                    ovf_window[k] = ovf_window.get(k, 0) + losses[k]
            if step % log_every != 0:
                continue
            scalars = {k: float(v) for k, v in losses.items() if v.dim() == 0}
            now = time.perf_counter()
            if step > step0:
                scalars["steps_per_sec_wall"] = (step - step0) / (now - t0)
                scalars["rays_per_sec_wall"] = rays / (now - t0)
            t0, step0, rays = now, step, 0
            ovf = sum(int(v) for v in ovf_window.values())
            ovf_window = {}
            if ovf > 0 and self._budget_boost < self._budget_boost_max:
                self._budget_boost += 1
                scalars["budget_boost"] = float(self._budget_boost)
                print(f"[{step}] budget overflow ({ovf} lanes) -> boost "
                      f"{self._budget_boost}", flush=True)
            scalars["lr"] = lr_schedule_host(step, self.config.system)
            if callback is not None:
                callback(step, scalars)
            history.append((step, scalars))
        return history
