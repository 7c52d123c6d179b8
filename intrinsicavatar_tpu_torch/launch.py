"""CLI launcher of the port: ``--mode validate``, ``test``, ``predict`` and
``train``.

    python -m intrinsicavatar_tpu_torch.launch --mode validate
    python -m intrinsicavatar_tpu_torch.launch --mode validate \\
        trainer.eval_step=25000
    python -m intrinsicavatar_tpu_torch.launch --mode test
    python -m intrinsicavatar_tpu_torch.launch --mode validate \\
        --config configs/tiny-synthetic.yaml --params params.npz --device cpu
    python -m intrinsicavatar_tpu_torch.launch --mode train \\
        trainer.max_steps=100

Without ``--config`` a validate run uses :func:`serve_config` (the default
model at its published widths on the synthetic dataset, eval step 5000), a
test or predict run :func:`relight_config` (the same at step 25,000, where
the physically based maps are rendered) and a train run
:func:`train_config` (the same model, 4096 rays per step); a ``--config``
YAML is merged onto the default config (validate, test, predict; eval step
5000, or 25,000 for test and predict, unless ``trainer.eval_step`` says
otherwise; in float32, said on stderr, since the bf16 scopes are not ported)
or onto :func:`train_config` (train).  An eval run at a step
from ``model.phys_kick_in_step`` (10,000) on renders the PBR maps; a test
run whose frames carry an ``albedo`` fits the albedo alignment ratio first.
Every eval frame bakes its seed grid once (``model.eval_seed_grid``, on by
default; ``model.eval_seed_grid=false`` renders by the searched path).
Training runs from step 0 to ``trainer.max_steps`` (25,000; the phys
regime from ``model.phys_kick_in_step``) and prints the losses every
``trainer.log_every_n_steps`` steps;
``model.pose_correction.enable_pose_correction=true`` trains the per-frame
pose corrections from ``pose_correction_start_step`` (4,000) on.
``--params`` loads an ``.npz`` of the JAX parameter tree flattened to
dotted keys (as :func:`weights.flatten_tree` names them); without it the parameters are random, drawn from the config's
seed.  The run is on ``cuda`` unless ``--device`` names another device.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--mode", default="validate",
                        choices=["validate", "train", "test", "predict"])
    parser.add_argument("--config", default=None)
    parser.add_argument("--params", default=None,
                        help="npz of the JAX parameter tree, dotted keys")
    parser.add_argument("--device", default=None,
                        help="torch device (default: cuda)")
    parser.add_argument("overrides", nargs="*")
    args = parser.parse_args(argv)
    if args.mode == "test":
        print("--mode test: the canonical mesh export and the env-map dump "
              "are not ported yet; they come with a later slice",
              file=sys.stderr)

    import torch

    from intrinsicavatar_tpu_torch.data import make as make_dataset
    from intrinsicavatar_tpu_torch.render.renderer import IntrinsicAvatar
    from intrinsicavatar_tpu_torch.train import evaluate as EV
    from intrinsicavatar_tpu_torch.utils.config import (
        apply_dotlist, load_yaml, merge, resolve,
    )
    from intrinsicavatar_tpu_torch.utils.default_config import (
        default_config, relight_config, serve_config, train_config,
    )
    from intrinsicavatar_tpu_torch.utils.device import resolve_device
    from intrinsicavatar_tpu_torch.weights import from_jax_params, unflatten

    device = resolve_device(args.device)
    train = args.mode == "train"
    validate = args.mode == "validate"
    cfg = (train_config() if train else serve_config() if validate
           else relight_config())
    if args.config:
        cfg = merge(train_config() if train else default_config(),
                    load_yaml(args.config))
        if not train:
            # the bf16 scopes are not ported: the YAML's model runs in
            # float32 (an explicit override to bfloat16 still raises)
            cfg = merge(cfg, {"model": {"primary_dtype": "float32",
                                        "secondary_coarse_dtype": "float32"}})
            print("--config: the bf16 scopes are not ported yet; this run "
                  "sets model.primary_dtype=float32 and "
                  "model.secondary_coarse_dtype=float32", file=sys.stderr)
    if args.overrides:
        cfg = apply_dotlist(cfg, args.overrides)
    cfg = resolve(cfg)
    seed = int(cfg.get("seed", 42))
    if train:
        return _train(cfg, device, seed, args.params)
    step = int(cfg.trainer.get("eval_step", 5000 if validate else 25000))
    flags = EV.eval_flags(cfg.model, step)

    model = IntrinsicAvatar(cfg.model).to(device)
    if args.params:
        from_jax_params(model, unflatten(dict(np.load(args.params))))
    else:
        model.init(torch.Generator().manual_seed(seed))
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
        if "rgb" not in batch_np:
            continue
        m = EV.frame_metrics(out, batch_np,
                             albedo_prealigned=ratio is not None)
        all_metrics.append(m)
        print(f"frame {i}: " + " ".join(f"{k}={v:.3f}" for k, v in m.items()),
              flush=True)
    if all_metrics:
        print("mean:", json.dumps({k: float(np.mean([m[k] for m in
                                                     all_metrics]))
                                   for k in all_metrics[0]}))
    return 0


def _train(cfg, device, seed, params_path):
    from intrinsicavatar_tpu_torch.data import make as make_dataset
    from intrinsicavatar_tpu_torch.train.system import IntrinsicAvatarSystem
    from intrinsicavatar_tpu_torch.weights import unflatten

    dataset = make_dataset(cfg.dataset.get("name", "synthetic"), cfg.dataset,
                           split="train", mode="train",
                           rng=np.random.default_rng(seed))
    system = IntrinsicAvatarSystem(cfg, device)
    params = unflatten(dict(np.load(params_path))) if params_path else None
    system.setup(dataset.betas, params)

    def log(step, scalars):
        print(f"[{step}] " + " ".join(f"{k}={v:.5g}" for k, v in
                                      sorted(scalars.items())), flush=True)

    def all_frames():
        return [dataset.pose_batch(i) for i in range(len(dataset))]

    history = system.fit(dataset.train_iter(np.random.default_rng(seed + 1)),
                         int(cfg.trainer.get("max_steps", 25000)),
                         log_every=int(cfg.trainer.get("log_every_n_steps",
                                                       100)),
                         callback=log, all_frames_fn=all_frames)
    if history:
        print("last:", json.dumps(history[-1][1]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
