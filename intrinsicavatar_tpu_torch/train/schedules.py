"""Scalar schedules for loss weights and learning rates (counterpart of the
JAX package's ``train/schedules.py``): ``BaseSystem.C`` of the reference
(`systems/base.py:33-88`) and the warmup + MultiStepLR composite
(`configs/config.yaml:137-152`), as functions of the integer step."""

from __future__ import annotations

DEFAULT_LR_MILESTONES = (12500, 18750, 22500, 23750)


def C(value, step: int) -> float:
    """Interpret a scheduled scalar.

    * number -> constant;
    * ``[v0, v1, end_step]`` -> step function: v0 before end_step, v1 after;
    * ``[start_step, v0, v1, end_step]`` -> 0 before start_step, then linear
      ramp v0 -> v1 over [start_step, end_step].
    """
    if isinstance(value, (int, float)):
        return float(value)
    value = list(value)
    if len(value) == 3:
        v0, v1, end = value
        return float(v0 if step < end else v1)
    if len(value) == 4:
        start, v0, v1, end = value
        if step < start:
            return 0.0
        t = min(max((step - start) / max(end - start, 1e-8), 0.0), 1.0)
        return float(v0 + (v1 - v0) * t)
    raise TypeError(f"bad schedule spec: {value!r}")


def lr_schedule(step: int, base_lr: float, warmup_steps: int = 1000,
                warmup_start_factor: float = 0.01,
                milestones=DEFAULT_LR_MILESTONES,
                gamma: float = 0.3) -> float:
    """Linear warmup then MultiStepLR decay."""
    warm = warmup_start_factor + (1.0 - warmup_start_factor) * min(
        max(step / max(warmup_steps, 1), 0.0), 1.0)
    decay = 1.0
    for m in milestones:
        if step >= m:
            decay *= gamma
    return base_lr * warm * decay


def lr_schedule_host(step: int, system_cfg) -> float:
    """:func:`lr_schedule` from the ``system`` config node."""
    sch = system_cfg.get("scheduler", {})
    return lr_schedule(
        step, system_cfg.get("optimizer", {}).get("args", {}).get("lr", 1e-3),
        system_cfg.get("warmup_steps", 1000),
        sch.get("warmup_start_factor", 0.01),
        sch.get("milestones", DEFAULT_LR_MILESTONES), sch.get("gamma", 0.3))
