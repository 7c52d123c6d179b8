"""CLI launcher of the port: ``--mode validate`` and ``--mode train``.

    python -m intrinsicavatar_tpu_torch.launch --mode validate
    python -m intrinsicavatar_tpu_torch.launch --mode validate \\
        --config configs/tiny-synthetic.yaml --params params.npz --device cpu
    python -m intrinsicavatar_tpu_torch.launch --mode train \\
        trainer.max_steps=100
    python -m intrinsicavatar_tpu_torch.launch --mode train --device cpu \\
        --config configs/tiny-synthetic.yaml trainer.max_steps=3

Without ``--config`` a validate run uses :func:`serve_config` (the default
model at its published widths on the synthetic dataset, eval step 5000) and
a train run :func:`train_config` (the same model, 4096 rays per step); a
``--config`` YAML is merged onto the default config (validate) or onto
:func:`train_config` (train).  Training runs the radiance regime from step
0 and prints the losses every ``trainer.log_every_n_steps`` steps.
``--params`` loads an ``.npz`` of the JAX parameter tree flattened to dotted
keys (as :func:`weights.flatten_tree` names them); without it the
parameters are random, drawn from the config's seed.  The run is on
``cuda`` unless ``--device`` names another device.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

LATER = {"test": "the relighting slice (PBR)",
         "predict": "the relighting slice (PBR)"}


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
    if args.mode in LATER:
        print(f"--mode {args.mode} is not ported yet: it comes with "
              f"{LATER[args.mode]}", file=sys.stderr)
        return 2

    import torch

    from intrinsicavatar_tpu_torch.data import make as make_dataset
    from intrinsicavatar_tpu_torch.render.renderer import IntrinsicAvatar
    from intrinsicavatar_tpu_torch.train import evaluate as EV
    from intrinsicavatar_tpu_torch.utils.config import (
        apply_dotlist, load_yaml, merge, resolve,
    )
    from intrinsicavatar_tpu_torch.utils.default_config import (
        default_config, serve_config, train_config,
    )
    from intrinsicavatar_tpu_torch.utils.device import resolve_device
    from intrinsicavatar_tpu_torch.weights import from_jax_params, unflatten

    device = resolve_device(args.device)
    train = args.mode == "train"
    cfg = train_config() if train else serve_config()
    if args.config:
        cfg = merge(train_config() if train else default_config(),
                    load_yaml(args.config))
    if args.overrides:
        cfg = apply_dotlist(cfg, args.overrides)
    cfg = resolve(cfg)
    seed = int(cfg.get("seed", 42))
    if train:
        return _train(cfg, device, seed, args.params)
    step = int(cfg.trainer.get("eval_step", 5000))
    flags = EV.eval_flags(cfg.model, step)
    if flags.enable_phys:
        print(f"step {step} renders with PBR, which comes with the "
              f"relighting slice", file=sys.stderr)
        return 2

    model = IntrinsicAvatar(cfg.model).to(device)
    if args.params:
        from_jax_params(model, unflatten(dict(np.load(args.params))))
    else:
        model.init(torch.Generator().manual_seed(seed))
    dataset = make_dataset(cfg.dataset.get("name", "synthetic"), cfg.dataset,
                           split="val", mode="val")
    statics = model.initialize(dataset.betas)
    chunk = int(cfg.model.get("ray_chunk", 4096))
    all_metrics = []
    for i in range(len(dataset)):
        batch_np = dataset[i]
        out = EV.render_frame(
            model, statics, EV.batch_to_device(batch_np, device), step,
            flags, ray_chunk=chunk,
            generator=torch.Generator().manual_seed(seed + i))
        ovf = {k: v for k, v in out["counters"].items()
               if k.startswith("ovf_") and v}
        if ovf:
            print(f"frame {i}: budget overflow {ovf}", flush=True)
        m = EV.frame_metrics(out, batch_np)
        all_metrics.append(m)
        print(f"frame {i}: " + " ".join(f"{k}={v:.3f}" for k, v in m.items()),
              flush=True)
    print("mean:", json.dumps({k: float(np.mean([m[k] for m in all_metrics]))
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
