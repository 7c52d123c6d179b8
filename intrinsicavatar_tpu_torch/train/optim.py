"""Adam with named parameter groups and the composite LR schedule
(counterpart of the JAX package's ``train/optim.py``, an optax chain).

``torch.optim.Adam`` with one group per configured prefix and one for the
rest: a group's ``lr`` sets its multiplier of the base rate, its
``weight_decay`` is torch's L2 added to the gradient before the moments
(the JAX chain's ``add_l2``); the rate is ``lr_schedule`` of the
optimizer's own step count through ``LambdaLR``, as optax counts its
updates.  Prefixes are dotted paths of the JAX tree (``radiance.table``,
``pose_correction``), matched against ``weights.jax_key`` of each parameter,
longest prefix first.
"""

from __future__ import annotations

import torch

from intrinsicavatar_tpu_torch.train.schedules import (
    DEFAULT_LR_MILESTONES, lr_schedule,
)
from intrinsicavatar_tpu_torch.weights import jax_key


def group_of(key: str, groups) -> str | None:
    """Longest configured prefix of the dotted parameter path ``key``."""
    best = None
    for prefix in groups:
        if key == prefix or key.startswith(prefix + "."):
            if best is None or len(prefix) > len(best):
                best = prefix
    return best


def make_optimizer(model, optimizer_cfg, scheduler_cfg,
                   warmup_steps: int = 1000):
    """``(torch.optim.Adam, LambdaLR)`` over ``model``'s parameters."""
    args = optimizer_cfg.get("args", {})
    base_lr = float(args.get("lr", 1e-3))
    b1, b2 = args.get("betas", [0.9, 0.99])
    groups_cfg = optimizer_cfg.get("params", {}) or {}
    members: dict = {}
    for name, p in model.named_parameters():
        members.setdefault(group_of(jax_key(name), groups_cfg), []).append(p)
    param_groups = []
    for g, params in members.items():
        gcfg = groups_cfg[g] if g is not None else {}
        param_groups.append({
            "params": params, "name": g or "default",
            "lr": float(gcfg.get("lr", base_lr)),
            "weight_decay": float(gcfg.get("weight_decay", 0.0))})
    opt = torch.optim.Adam(param_groups, lr=base_lr, betas=(b1, b2),
                           eps=float(args.get("eps", 1e-15)))
    milestones = tuple(scheduler_cfg.get("milestones",
                                         DEFAULT_LR_MILESTONES))
    start = scheduler_cfg.get("warmup_start_factor", 0.01)
    gamma = scheduler_cfg.get("gamma", 0.3)
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, lambda k: lr_schedule(k, 1.0, warmup_steps, start, milestones,
                                   gamma))
    return opt, sched


def step_every_leaf(optimizer) -> None:
    """``optimizer.step()`` as optax updates: every leaf each step, a leaf
    without a gradient (one the loss did not read) with a zero one, so its
    Adam count and moments run on (a leaf first read at a later step, the
    pose corrections at 4,001 or the material head at the phys kick-in,
    then sees JAX's bias correction).  ``.grad`` stays None for it."""
    unread = [p for g in optimizer.param_groups for p in g["params"]
              if p.grad is None]
    for p in unread:
        p.grad = torch.zeros_like(p)
    optimizer.step()
    for p in unread:
        p.grad = None
