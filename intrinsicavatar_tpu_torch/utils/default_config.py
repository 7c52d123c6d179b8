"""Default configuration tree (a copy of the JAX package's, plus
:func:`serve_config`, :func:`relight_config` and :func:`train_config`).

Mirrors the composed Hydra defaults of the reference
(`configs/config.yaml` + the per-module group yamls in
taconite/IntrinsicAvatar); values cited per-entry in comments where they
deviate.  ``default_config()`` returns a resolved ConfigNode; tests and small
runs shrink it with ``tiny_config()``.
"""

from __future__ import annotations

from intrinsicavatar_tpu_torch.utils.config import ConfigNode, merge, wrap


def hash_grid_encoding(n_levels=16, log2_hashmap_size=19):
    return {
        "otype": "ProgressiveBandHashGrid",
        "n_levels": n_levels,
        "n_features_per_level": 2,
        "log2_hashmap_size": log2_hashmap_size,
        "base_resolution": 16,
        "per_level_scale": 1.447269237440378,
        "include_xyz": True,
        "start_level": 4,
        "update_steps": 125,
        "start_step": 500,
    }


def default_config(dataset_length: int = 100) -> ConfigNode:
    geometry_feature_dim = 13
    radiance_xyz_dim = 16 * 2 + 3  # hash feats + xyz passthrough
    cfg = {
        "name": "intrinsic-avatar",
        "seed": 42,
        "model": {
            "name": "intrinsic-avatar",
            "global_illumination": True,
            "render_mode": "uniform_light",
            "scene_aabb": [-1.25, -1.55, -1.25, 1.25, 0.95, 1.25],
            "samples_per_pixel": 512,
            "num_samples_per_ray": 128,
            "num_samples_per_secondary_ray": 64,
            "secondary_near_plane": 0.0,
            "secondary_far_plane": 1.5,
            "secondary_importance_sample": True,
            # secondary-ray query budget: each secondary ray is capped at
            # its first 8 *occupied* coarse samples (early-termination
            # analog — rays either escape the grid within a few voxels or
            # cross the surface, and samples behind the crossing sit at
            # ~zero transmittance), so a 8/64 = 0.125 compaction budget is
            # overflow-free BY CONSTRUCTION and halves the dominant
            # no-grad coarse pass of the phys/relight regimes.  Set
            # secondary_max_valid_samples: 0 for the exact full march.
            "secondary_query_compaction": 0.125,
            # opt-in: track the measured primary valid-sample fraction
            # (bucketed 16ths, hysteresis) instead of the static
            # query_compaction fraction; overflow escalation still guards
            "adaptive_query_compaction": False,
            # opt-in DDA-parity sample concentration (c > 0): probe the
            # primary march at c-x finer steps and keep up to
            # num_samples_per_ray *occupied* probe steps — no sample
            # budget spent on empty space; thin limbs get c-x finer
            # sampling (ops/grid_traversal.py occupancy_sampling)
            "march_concentrate": 0,
            "secondary_max_valid_samples": 8,
            # eval-only: bake the fixed per-frame inverse-skinning field
            # on a lattice once, then warm-start every eval query from a
            # trilinear seed + short Broyden polish instead of the
            # multi-init search (anim/seedgrid.py).  The reference pays
            # the full search per query (`fast_snarf/deformer_torch.py:
            # 94-125`); at 540p/1024spp that is O(5e8) searches vs an
            # O(9e5)-point bake.  Training is unaffected.
            "eval_seed_grid": True,
            # when the bake carries the SDF channel, the secondary coarse
            # march — a placement-only pass (it never feeds a shading
            # weight; `render/pbr.py:_indirect_impl`) — reads sdf from the
            # same row gather as the seeds instead of running a seeded
            # polish + hash encode + MLP per sample.  The fine pass still
            # re-queries its placed midpoints exactly.  Eval-only (the
            # grid only exists at eval); false restores the queried pass.
            "baked_secondary_coarse": True,
            # same trade for the primary importance-resampling rounds —
            # placement-only edge sdf from the grid's row gather; the
            # primary shading pass re-queries its midpoints exactly
            "baked_importance": True,
            "seed_grid_resolution": 96,
            "seed_grid_polish_iters": 6,
            "seed_grid_coh_factor": 3.0,
            # per-STEP bake for the phys TRAINING regime: the secondary
            # march (gradient-free, `render/pbr.py`) answers its coarse
            # placement from the grid and warm-starts its fine queries,
            # exactly as at eval, but from a grid baked once per
            # optimizer step (a phys step's secondary fan-out issues
            # ~40x more inverse-skinning queries than a 64^3 bake).
            # Primary shading still runs the full search (its gradient
            # path is untouched).  Opt-in until the TPU delta is
            # measured (render/renderer.py use_train_seed_grid).
            "train_seed_grid": False,
            "train_seed_grid_resolution": 64,
            # "phys" (default) bakes only at phys steps; "all" also bakes
            # at radiance steps once importance sampling is on — the grid
            # then serves the importance rounds' placement and (with
            # train_seed_grid_primary) the primary shading pass
            "train_seed_grid_scope": "phys",
            # route the primary shading pass through the seeded polish at
            # training time too (FastSNARF.deform_seeded applies the same
            # implicit-function pose-gradient correction as the search)
            "train_seed_grid_primary": True,
            # gather only the ACTIVE secondary rays (fg & cos-gated — about
            # half the fan-out in light/uniform_light modes) into a static
            # budget = frac * M before the secondary march; overflow rays
            # keep the inactive fill and are counted (ovf_sec_active).
            # 0 disables (march every lane).  Opt-in until the TPU delta
            # is measured (render/pbr.py compute_indirect_radiance).
            "secondary_active_compaction": 0.0,
            "zero_crossing_search": True,
            "resample_light": True,
            "volume_scattering": True,
            "add_emitter": False,
            "grid_prune": True,
            "grid_prune_occ_thre": 0.001,
            "grid_prune_ema_decay": 0.8,
            "randomized": True,
            "ray_chunk": 4096,
            "learned_background": False,
            "learn_material": True,
            "material_feature": "hybrid",
            "phys_kick_in_step": 10000,
            "importance_sample_kick_in_step": 1000,
            "background_color": "random",
            "occ_resolution": 64,
            "geometry": {
                "name": "volume-sdf",
                "feature_dim": geometry_feature_dim,
                "grad_type": "analytic",
                "isosurface": {"method": "mc", "resolution": 512,
                               "chunk": 2097152, "threshold": 0.0},
                "xyz_encoding_config": hash_grid_encoding(),
                "mlp_network_config": {
                    "otype": "VanillaMLP", "output_activation": "none",
                    "n_neurons": 64, "n_hidden_layers": 1,
                    "sphere_init": True, "sphere_init_radius": 0.5,
                    "weight_norm": True,
                },
            },
            "radiance": {
                "name": "volume-ref-dir-radiance",
                # geometry features + world normal as extra input
                "input_feature_dim": geometry_feature_dim + 3,
                "xyz_encoding_config": hash_grid_encoding(),
                "dir_encoding_config": {"otype": "SphericalHarmonics",
                                        "degree": 4},
                "mlp_network_config": {
                    "otype": "VanillaMLP", "output_activation": "none",
                    "n_neurons": 64, "n_hidden_layers": 2,
                },
                "color_activation": "sigmoid",
                # progressive SH bands disabled by default, as reference
                "start_step": 0, "full_band_step": 1,
            },
            "material": {
                "name": "volume-material",
                "input_feature_dim": geometry_feature_dim + radiance_xyz_dim,
                "n_output_dim": 5,
                "albedo_scale": 0.77, "albedo_bias": 0.03,
                "roughness_scale": 0.9, "roughness_bias": 0.09,
                "metallic_scale": 1.0, "metallic_bias": 0.0,
                "mlp_network_config": {
                    "otype": "LipshitzMLP", "output_activation": "none",
                    "n_neurons": 64, "n_hidden_layers": 2,
                },
                "material_activation": "sigmoid",
            },
            "density": {
                "name": "learned-laplace-density",
                "beta_min": 1e-4,
                "params_init": {"beta": 0.3},
            },
            "deformer": {
                "name": "snarf_deformer",
                "rigid_deformer": {
                    "name": "fast-snarf",
                    "model_path": "synthetic",
                    "gender": "neutral",
                    "deformer_config": {
                        "resolution": 128,
                        "cano_pose": "a_pose",
                        "global_scale": 1.2,
                        "use_j_inv": False,
                        "optimize_betas": False,
                        "max_candidates": 4,
                    },
                },
                "non_rigid_deformer": {"name": "dummy_non_rigid_deformer"},
            },
            "pose_encoder": {"name": "dummy_pose_encoder",
                             "num_joints": 24, "dim_per_joint": 6},
            "pose_correction": {
                "name": "pose_correction",
                "dataset_length": dataset_length,
                "enable_pose_correction": False,
                "pose_correction_start_step": 4000,
            },
            "scatterer": {"name": "brdf-multi-lobe"},
            "light": {
                "name": "envlight-SG",
                "xyz2lonlat_mode": None,
                "envlight_config": {"base_res": 256, "num_SGs": 64},
            },
        },
        "system": {
            "name": "intrinsic-avatar-system",
            "pbr_loss_only": False,
            "reinit_occupancy_grid_steps": [8000],
            "reinit_shape_every_n_steps": -1,
            "loss": {
                "lambda_rgb_l1": 1.0,
                "lambda_rgb_phys_l1": 0.2,
                "lambda_mask_bce": 0.1,
                "lambda_eikonal": 0.1,
                "lambda_lipshitz_bound": [12500, 1e-5, 1e-5, 12501],
                "lambda_curvature": [1.5, 0.0, 12500],
                "lambda_albedo_smoothness": 0.01,
                "lambda_roughness_smoothness": 0.01,
                "lambda_metallic_smoothness": 0.01,
                "sparsity_scale": 1.0,
                "lambda_rgb_mse": 0.0,
                "lambda_rgb_phys_mse": 0.0,
                "lambda_rgb_demodulated": 0.0,
                "lambda_mask_mse": 0.0,
                "lambda_sparsity": 0.0,
                "lambda_distortion": 0.0,
                "lambda_opaque": 0.0,
                "lambda_albedo": 0.0,
                "lambda_normal_orientation": 0.0,
                "lambda_albedo_entropy": 0.0,
                "lambda_energy_conservation": 0.0,
            },
            "optimizer": {
                "name": "Adam",
                "args": {"lr": 1e-3, "betas": [0.9, 0.99], "eps": 1e-15},
                "params": {
                    "pose_correction": {"lr": 1e-4, "weight_decay": 1e-5},
                    "radiance.table": {"weight_decay": 1e-4},
                },
            },
            "warmup_steps": 1000,
            "scheduler": {
                "milestones": [12500, 18750, 22500, 23750],
                "gamma": 0.3,
                "warmup_start_factor": 0.01,
            },
        },
        "dataset": {
            "name": "peoplesnapshot",
            "subject": "male-3-casual",
            "gender": "male",
            "scene_aabb": [-1.25, -1.55, -1.25, 1.25, 0.95, 1.25],
            "sampler": {"name": "edge", "num_sample": 4096,
                        "ratio_mask": 0.6, "ratio_edge": 0.3,
                        "kernel_size": 16},
        },
        "trainer": {
            "max_steps": 25000,
            "log_every_n_steps": 100,
            "val_check_interval": 2000,
            # microbatches per optimizer step: >1 runs the shading/backward
            # stage in R/n-ray chunks with averaged gradients (activation
            # HBM scales with the chunk; 4096-ray steps need 2 on a 16GB v5e)
            "grad_accum": 1,
        },
    }
    return wrap(cfg)


def tiny_config(dataset_length: int = 4) -> ConfigNode:
    """Shrunk config for CPU tests: small grids, few samples, tiny voxels."""
    cfg = default_config(dataset_length)
    tiny = {
        "model": {
            "num_samples_per_ray": 32,
            "samples_per_pixel": 16,
            "num_samples_per_secondary_ray": 16,
            "n_importance_samples": 8,
            "occ_resolution": 16,
            "geometry": {
                "xyz_encoding_config": hash_grid_encoding(8, 13),
            },
            "radiance": {
                "input_feature_dim": 16,
                "xyz_encoding_config": hash_grid_encoding(8, 13),
            },
            "material": {"input_feature_dim": 13 + (8 * 2 + 3)},
            "deformer": {
                "rigid_deformer": {
                    "deformer_config": {"resolution": 32,
                                        "max_candidates": 3},
                },
            },
            "light": {"envlight_config": {"base_res": 32, "num_SGs": 16}},
        },
    }
    return merge(cfg, tiny)


def serve_config() -> ConfigNode:
    """The eval render this package serves: the default model at its
    published widths, rendered at step 5000 (importance sampling on, PBR
    off), on the seeded synthetic body and dataset, at the JAX package's
    default precision (the shading pass in the bf16 scope, and the
    secondary coarse pass where it is queried at eval steps with PBR;
    ``model.primary_dtype=float32`` for the exact path), with the default
    eval seed grid (a 96^3 bake per frame; set ``model.eval_seed_grid=false``
    for the searched path).  Built in Python so that no YAML parser is
    needed to run it."""
    cfg = default_config()
    return merge(cfg, {
        "dataset": {"name": "synthetic", "n_rays": 16384, "n_frames": 2},
        "trainer": {"eval_step": 5000},
    })


def relight_config() -> ConfigNode:
    """The physically based (relight) render: :func:`serve_config` at eval
    step 25,000, where the PBR stage is on (512 scattering points per ray,
    64-step secondary rays, ``uniform_light``, the SG emitter and the
    multi-lobe BRDF at their published widths), with the eval seed grid
    answering the secondary coarse pass.  25,000 is the step the JAX
    launcher evaluates at without a checkpoint."""
    return merge(serve_config(), {"trainer": {"eval_step": 25000}})


def train_config() -> ConfigNode:
    """The training this package runs: the default model at its published
    widths on the seeded synthetic body and dataset, 4096 rays per step
    (the published sampler's ``num_sample``), at the JAX package's default
    precision (the shading pass and the phys regime's secondary coarse
    pass in the bf16 scope, their backward in float32 where JAX's is) and
    without the eval seed grid."""
    cfg = default_config()
    return merge(cfg, {
        "dataset": {"name": "synthetic", "n_rays": 4096, "n_frames": 8},
        "model": {"eval_seed_grid": False},
    })
