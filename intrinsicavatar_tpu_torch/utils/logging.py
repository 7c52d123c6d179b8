"""Training observability (counterpart of the JAX package's
``utils/logging.py``): metric logging, a throughput counter, profiling.

- :class:`MetricLogger`: ``metrics.jsonl`` in the run directory, and wandb
  only when ``use_wandb`` is set and the package imports;
- :class:`Throughput`: a sliding-window rays/s and steps/s counter;
- :func:`profile_steps`: a ``torch.profiler`` span whose trace is written
  to ``log_dir``.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import time


class MetricLogger:
    def __init__(self, log_dir: str, use_wandb: bool = False,
                 project: str = "intrinsicavatar-tpu", config=None):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, "metrics.jsonl")
        self._f = open(self.path, "a")
        self.wandb = None
        if use_wandb:
            # a run goes on without wandb where it is missing or its init
            # fails, as the JAX package's does
            try:
                import wandb

                self.wandb = wandb.init(project=project, config=config,
                                        dir=log_dir)
            except Exception as e:
                print(f"MetricLogger: wandb is off ({e!r})", file=sys.stderr)

    def log(self, step: int, scalars: dict):
        rec = {"step": int(step),
               **{k: float(v) for k, v in scalars.items()}}
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        if self.wandb is not None:
            self.wandb.log(scalars, step=step)

    def log_image(self, step: int, name: str, image):
        """An image to wandb; a no-op without it."""
        if self.wandb is not None:
            import wandb

            self.wandb.log({name: wandb.Image(image)}, step=step)

    def close(self):
        self._f.close()
        if self.wandb is not None:
            self.wandb.finish()


class Throughput:
    """Sliding-window rays/s and steps/s counter."""

    def __init__(self, window: int = 50):
        self.window = window
        self._events = []  # (t, n_rays)

    def tick(self, n_rays: int):
        self._events.append((time.perf_counter(), n_rays))
        if len(self._events) > self.window:
            self._events.pop(0)

    @property
    def rays_per_sec(self) -> float:
        if len(self._events) < 2:
            return 0.0
        dt = self._events[-1][0] - self._events[0][0]
        n = sum(e[1] for e in self._events[1:])
        return n / max(dt, 1e-9)

    @property
    def steps_per_sec(self) -> float:
        if len(self._events) < 2:
            return 0.0
        dt = self._events[-1][0] - self._events[0][0]
        return (len(self._events) - 1) / max(dt, 1e-9)


@contextlib.contextmanager
def profile_steps(log_dir: str):
    """A ``torch.profiler`` span (CPU, and CUDA where a card is present);
    its Chrome trace is written to ``log_dir/trace.json``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
