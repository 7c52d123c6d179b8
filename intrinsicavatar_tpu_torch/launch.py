"""CLI launcher of the port: ``--mode validate``, ``test``, ``predict`` and
``train``.

    python -m intrinsicavatar_tpu_torch.launch --mode validate
    python -m intrinsicavatar_tpu_torch.launch --mode validate \\
        trainer.eval_step=25000
    python -m intrinsicavatar_tpu_torch.launch --mode test
    python -m intrinsicavatar_tpu_torch.launch --mode validate \\
        --config configs/tiny-synthetic.yaml --params params.npz --device cpu
    python -m intrinsicavatar_tpu_torch.launch --mode train \\
        trainer.max_steps=100 trainer.ckpt_every_n_steps=50
    python -m intrinsicavatar_tpu_torch.launch --mode train \\
        --config configs/tiny-capsule.yaml
    python -m intrinsicavatar_tpu_torch.launch --mode train \\
        --resume exp/intrinsic-avatar/<run>/ckpt/step50 trainer.max_steps=100
    python -m intrinsicavatar_tpu_torch.launch --mode test \\
        --resume exp/intrinsic-avatar/<run>/ckpt/final
    python -m intrinsicavatar_tpu_torch.launch --mode train \\
        --config configs/peoplesnapshot-male-3-casual.yaml \\
        dataset.dataroot=<subject dir> \\
        model.deformer.rigid_deformer.model_path=<SMPL_MALE.pkl>
    python -m intrinsicavatar_tpu_torch.launch --mode predict \\
        --config configs/animation-aist.yaml --resume <run>/ckpt/final \\
        dataset.dataroot=<motion dir> dataset.hdri_filepath=<sky.hdr> \\
        model.deformer.rigid_deformer.model_path=<SMPL_FEMALE.pkl>

Without ``--config`` a validate run uses :func:`serve_config` (the default
model at its published widths on the ``synthetic`` dataset, eval step 5000), a
test or predict run :func:`relight_config` (the same at step 25,000, where
the physically based maps are rendered) and a train run
:func:`train_config` (the same model, 4096 rays per step); a ``--config``
YAML is merged onto the default config in every mode, as the JAX
launcher's is (eval step 5000, or 25,000 for test and predict, unless
``trainer.eval_step`` says otherwise), so a train run's validation takes
the default eval path, the seed grid's.  A config may name the
``synthetic`` dataset, the capsule body's images, ``synthetic-image``
(``configs/tiny-capsule.yaml``, ``configs/capsule-m3c.yaml``), whose frames
add SSIM and the normal error to the metrics, or a real dataset on disk:
``peoplesnapshot``, ``synthetichuman``, ``rana`` (with GT albedo, normals
and per-frame test HDRIs) or, for ``--mode predict``, ``animation``
(poses only); those name an SMPL model file
(``model.deformer.rigid_deformer.model_path``, ``.pkl`` or ``.npz``) and
read their frames with ``utils/image_io.py`` (PNG, Radiance ``.hdr``).
``trainer.grad_accum`` splits a train step's shading pass into
microbatches.  Every mode runs at the JAX
package's default precision (the shading pass and the queried secondary
coarse pass in the bf16 scope); ``model.primary_dtype=float32`` and
``model.secondary_coarse_dtype=float32`` select the exact path.  An eval run at a step
from ``model.phys_kick_in_step`` (10,000) on renders the PBR maps; a test
run whose frames carry an ``albedo`` fits the albedo alignment ratio first.
Every eval frame bakes its seed grid once (``model.eval_seed_grid``, on by
default; ``model.eval_seed_grid=false`` renders by the searched path).
Training runs from step 0 (or the restored step) to ``trainer.max_steps``
(25,000; the phys regime from ``model.phys_kick_in_step``), prints the
losses every ``trainer.log_every_n_steps`` steps and logs them to the run
directory's ``metrics.jsonl``, validates on up to 2 frames of the val split
every ``trainer.check_val_every_n_steps`` (2,000) steps, saves
``ckpt/step<N>`` every ``trainer.ckpt_every_n_steps`` steps (0: never) and
``ckpt/final`` at the end, and stops early past the wall-clock time
``trainer.deadline_ts`` (0: none), and writes each validation frame's
image grid as ``val/it<step>_f<i>.png`` where the dataset has images;
``model.pose_correction.enable_pose_correction=true`` trains the per-frame
pose corrections from ``pose_correction_start_step`` (4,000) on.

Every run makes its directory ``--exp-dir``/<name>/<YYYYmmdd-HHMMSS> with
``config.json`` and, inside a git checkout, a copy of the tracked sources
under ``code/``; an eval run writes its mean metrics there as
``metrics.json``.  ``--resume`` restores a checkpoint directory
(``utils/checkpoint.py``): in train mode the whole training state (the
budget boost and the data's position start afresh, as in the JAX
package), in test mode the parameters but the pose corrections, and the
step (``filter_for_test``: every frame builds its own grids), in validate
and predict mode the parameters and the step; an eval run renders at the
checkpoint's step when it is past 0, writes each frame's image grid as
``save/<val|test>_<i>.png`` where the dataset has an image size, and in
test mode also the canonical mesh ``save/mesh.obj`` and the environment
map ``save/envmap.hdr``.  ``--params`` loads an ``.npz`` of
the JAX parameter tree flattened to dotted keys (as
:func:`weights.flatten_tree` names them; every checkpoint holds one as
``params.npz``); without either the parameters are the JAX package's
random init from the config's seed (``weights.jax_init``), in training
too.  The run is on ``cuda`` unless ``--device`` names another device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--mode", default="validate",
                        choices=["validate", "train", "test", "predict"])
    parser.add_argument("--config", default=None)
    parser.add_argument("--params", default=None,
                        help="npz of the JAX parameter tree, dotted keys")
    parser.add_argument("--resume", default=None,
                        help="a checkpoint directory (ckpt/step<N>, "
                             "ckpt/final)")
    parser.add_argument("--exp-dir", default="exp")
    parser.add_argument("--device", default=None,
                        help="torch device (default: cuda)")
    parser.add_argument("overrides", nargs="*")
    args = parser.parse_args(argv)

    import torch

    from intrinsicavatar_tpu_torch.data import make as make_dataset
    from intrinsicavatar_tpu_torch.render.renderer import IntrinsicAvatar
    from intrinsicavatar_tpu_torch.train import evaluate as EV
    from intrinsicavatar_tpu_torch.utils import checkpoint as ckpt
    from intrinsicavatar_tpu_torch.utils.device import resolve_device
    from intrinsicavatar_tpu_torch.weights import (
        flatten_tree, from_jax_params, jax_init, to_jax_tree, unflatten,
    )

    device = resolve_device(args.device)
    train = args.mode == "train"
    validate = args.mode == "validate"
    cfg = build_config(args.mode, args.config, args.overrides)
    seed = int(cfg.get("seed", 42))
    run_dir = os.path.join(args.exp_dir, cfg.get("name", "intrinsic-avatar"),
                           time.strftime("%Y%m%d-%H%M%S"))
    os.makedirs(run_dir, exist_ok=True)
    with open(os.path.join(run_dir, "config.json"), "w") as f:
        json.dump(cfg, f, indent=2, default=str)
    _snapshot_code(run_dir)
    if train:
        return _train(cfg, device, seed, args.params, args.resume, run_dir)
    restored = None
    if args.resume:
        restored = ckpt.restore_checkpoint(args.resume)
        if args.mode == "test":
            restored = ckpt.filter_for_test(restored)
    if restored is not None and int(restored["step"]) > 0:
        step = int(restored["step"])
    else:
        step = int(cfg.trainer.get("eval_step", 5000 if validate else 25000))
    flags = EV.eval_flags(cfg.model, step)

    model = IntrinsicAvatar(cfg.model).to(device)
    if args.params:
        from_jax_params(model, unflatten(dict(np.load(args.params))))
    else:
        jax_init(model, seed)
    if restored is not None:
        # the restored parameters over the model's (a test restore has no
        # pose corrections); corrections of a sequence of another length
        # (a subject's checkpoint driving an animation) index that
        # sequence's frames, and the model keeps its own
        tree = to_jax_tree(model)
        params = dict(restored["params"])
        pc = params.get("pose_correction")
        if pc is not None and {k: np.shape(v) for k, v in flatten_tree(
                pc).items()} != {k: np.shape(v) for k, v in flatten_tree(
                tree["pose_correction"]).items()}:
            params.pop("pose_correction")
        tree.update(params)
        from_jax_params(model, tree)
    split = "val" if validate else "test"
    dataset = make_dataset(cfg.dataset.get("name", "synthetic"), cfg.dataset,
                           split=split, mode=args.mode if args.mode ==
                           "predict" else split)
    statics = model.initialize(dataset.betas)
    chunk = int(cfg.model.get("ray_chunk", 4096))
    all_metrics = []
    for i in range(len(dataset)):
        batch_np = dataset[i]
        batch = EV.batch_to_device(batch_np, device)
        gen = torch.Generator().manual_seed(seed + i)
        occ = frame = cond = ratio = grid = None
        if args.mode == "test" and flags.enable_phys and "albedo" in batch:
            # the relighting protocol: one alignment ratio per frame from an
            # albedo-only pre-pass on the frame's own test grid and seed
            # grid, both shared with the full render
            occ, frame, cond = EV.build_test_occ_grid(model, statics, batch,
                                                      step, generator=gen)
            grid = EV.build_seed_grid(model, statics, frame, cond, step)
            ratio = EV.fit_albedo_ratio(model, statics, batch, step, flags,
                                        ray_chunk=chunk, occ=occ,
                                        frame=frame, cond=cond,
                                        generator=gen, seed_grid=grid)
        # otherwise render_frame builds both grids for the frame
        out = EV.render_frame(model, statics, batch, step, flags,
                              ray_chunk=chunk, occ=occ, frame=frame,
                              cond=cond, generator=gen,
                              albedo_align_ratio=ratio, seed_grid=grid)
        ovf = {k: v for k, v in out["counters"].items()
               if k.startswith("ovf_") and v}
        if ovf:
            print(f"frame {i}: budget overflow {ovf}", flush=True)
        img_wh = getattr(dataset, "img_wh", None)
        if "rgb" in batch_np:
            m = EV.frame_metrics(out, batch_np, img_wh,
                                 albedo_prealigned=ratio is not None)
            all_metrics.append(m)
            print(f"frame {i}: " + " ".join(
                f"{k}={v:.3f}" for k, v in m.items() if np.ndim(v) == 0),
                flush=True)
        if img_wh:
            EV.dump_frame_images(os.path.join(run_dir, "save"),
                                 f"{split}_{i:04d}", out, batch_np, img_wh)
    if all_metrics:
        agg = {k: float(np.mean([m[k] for m in all_metrics]))
               for k in all_metrics[0] if np.ndim(all_metrics[0][k]) == 0}
        print("mean:", json.dumps(agg))
        with open(os.path.join(run_dir, "metrics.json"), "w") as f:
            json.dump(agg, f, indent=2)
    if args.mode == "test":
        save = os.path.join(run_dir, "save")
        verts, faces = EV.export_canonical_mesh(
            model, step, os.path.join(save, "mesh.obj"))
        env = EV.dump_envmap(model, os.path.join(save, "envmap.exr"))
        print(f"saved {os.path.join(save, 'mesh.obj')} ({len(verts)} "
              f"vertices, {len(faces)} faces) and {env}", flush=True)
    return 0


def build_config(mode: str, config=None, overrides=()):
    """The run's resolved config: a ``--config`` YAML over the default
    config in every mode (the JAX launcher's rule), else
    :func:`serve_config` (validate), :func:`relight_config` (test,
    predict) or :func:`train_config`; then the dotlist ``overrides``."""
    from intrinsicavatar_tpu_torch.utils.config import (
        apply_dotlist, load_yaml, merge, resolve,
    )
    from intrinsicavatar_tpu_torch.utils.default_config import (
        default_config, relight_config, serve_config, train_config,
    )

    train = mode == "train"
    cfg = (train_config() if train else serve_config() if mode == "validate"
           else relight_config())
    if config:
        cfg = merge(default_config(), load_yaml(config))
    if overrides:
        cfg = apply_dotlist(cfg, list(overrides))
    return resolve(cfg)


def _snapshot_code(run_dir):
    """Copy the tracked source tree into ``<run_dir>/code``; skipped
    outside a git checkout."""
    import shutil
    import subprocess

    try:
        root = subprocess.run(["git", "rev-parse", "--show-toplevel"],
                              capture_output=True, text=True,
                              check=True).stdout.strip()
        files = subprocess.run(["git", "ls-files"], cwd=root,
                               capture_output=True, text=True,
                               check=True).stdout.splitlines()
    except (subprocess.CalledProcessError, FileNotFoundError):
        return
    dst_root = os.path.join(run_dir, "code")
    for rel in files:
        src = os.path.join(root, rel)
        if not os.path.isfile(src):
            continue
        dst = os.path.join(dst_root, rel)
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        shutil.copy2(src, dst)


def _train(cfg, device, seed, params_path, resume, run_dir):
    import torch

    from intrinsicavatar_tpu_torch.data import make as make_dataset
    from intrinsicavatar_tpu_torch.train import evaluate as EV
    from intrinsicavatar_tpu_torch.train.system import IntrinsicAvatarSystem
    from intrinsicavatar_tpu_torch.utils import checkpoint as ckpt
    from intrinsicavatar_tpu_torch.utils.logging import MetricLogger
    from intrinsicavatar_tpu_torch.weights import unflatten

    name = cfg.dataset.get("name", "synthetic")
    dataset = make_dataset(name, cfg.dataset, split="train", mode="train",
                           rng=np.random.default_rng(seed))
    system = IntrinsicAvatarSystem(cfg, device)
    params = unflatten(dict(np.load(params_path))) if params_path else None
    state = ckpt.restore_checkpoint(resume) if resume else None
    system.setup(dataset.betas, params, state)
    tcfg = cfg.trainer
    val_every = int(tcfg.get("check_val_every_n_steps", 2000))
    chunk = int(cfg.model.get("ray_chunk", 4096))
    logger = MetricLogger(run_dir, use_wandb=cfg.get("use_wandb", False),
                          config=cfg)

    def log(step, scalars):
        print(f"[{step}] " + " ".join(f"{k}={v:.5g}" for k, v in
                                      sorted(scalars.items())), flush=True)

    def all_frames():
        return [dataset.pose_batch(i) for i in range(len(dataset))]

    # in-training validation on up to 2 frames of the val split
    val_fn = None
    try:
        val_ds = make_dataset(name, cfg.dataset, split="val", mode="val")
    except Exception as e:
        print(f"no in-training validation: the val split does not build "
              f"({e!r})", file=sys.stderr)
        val_ds = None
    if val_ds is not None and val_every > 0:
        img_wh = getattr(val_ds, "img_wh", None)

        def val_fn(system, step):
            flags = system.flags_for_step(step, training=False)
            agg: dict = {}
            for i in range(min(len(val_ds), 2)):
                b_np = val_ds[i]
                out = EV.render_frame(
                    system.model, system.statics,
                    EV.batch_to_device(b_np, device), step, flags,
                    ray_chunk=chunk,
                    generator=torch.Generator().manual_seed(step + i))
                m = EV.frame_metrics(out, b_np, img_wh)
                if img_wh:
                    EV.dump_frame_images(os.path.join(run_dir, "val"),
                                         f"it{step}_f{i}", out, b_np, img_wh)
                # eval budget overflows show in validation too
                for k, v in out["counters"].items():
                    if k.startswith("ovf_") and v:
                        m[k] = m.get(k, 0) + int(v)
                for k, v in m.items():
                    agg.setdefault(k, []).append(v)
            mean = {k: float(np.mean(v)) for k, v in agg.items()}
            print(f"[val @ {step}] " + " ".join(
                f"{k}={v:.3f}" for k, v in sorted(mean.items())), flush=True)
            return mean

    def ckpt_fn(state, step):
        ckpt.save_checkpoint(os.path.join(run_dir, "ckpt", f"step{step}"),
                             state)

    try:
        history = system.fit(
            dataset.train_iter(np.random.default_rng(seed + 1)),
            int(tcfg.get("max_steps", 25000)),
            log_every=int(tcfg.get("log_every_n_steps", 100)),
            callback=log, all_frames_fn=all_frames, logger=logger,
            val_fn=val_fn, val_every=val_every, ckpt_fn=ckpt_fn,
            ckpt_every=int(tcfg.get("ckpt_every_n_steps", 0)),
            deadline_ts=float(tcfg.get("deadline_ts", 0.0)),
            betas=dataset.betas)
    finally:
        logger.close()
    final = os.path.join(run_dir, "ckpt", "final")
    ckpt.save_checkpoint(final, system.state_dict())
    print("saved checkpoint to", final, flush=True)
    if history:
        print("last:", json.dumps(history[-1][1]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
