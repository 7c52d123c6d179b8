"""Worked-out bound on an H100 for the hot op the port has not ported yet.

    python3 queued_bounds.py      # prints one JSON line

The K5 backward with respect to ``tfs`` (``anim/deformer.py:396-412``, the
implicit-function correction of a train-mode query, through
``anim/broyden.py:550`` ``forward_skinning_soa``) runs only when the pose
carries a gradient (``pose_correction.enable_pose_correction`` or
``optimize_betas``; both off by default), which the port does not train
yet, so nothing can be measured for it.  This works out, from the code of
the JAX package and the shapes of :func:`default_config`, what one train
step of 4,096 rays at step 2000 would give it:

- launches: one per train step.  The correction runs in the one deform call
  of a step that carries the pose gradient, the compacted shading query
  (the importance rounds run without gradient, the curvature proxy queries
  canonical points and does not deform);
- lanes: that query's points (``query_compaction`` 0.5 + 1/16 of 4,096 x
  (128 + 2 x 16) samples, rounded up to 128) times ``max_candidates`` (4);
- bytes: per lane the root (12 B), the cotangents of the skinned point
  (12 B) and of the blended rotation (36 B), the lane's validity (1 B) and
  its 24 LBS weights (96 B, sampled from the 50 MB weight voxel, counted
  once per lane); the 24 x 3 x 4 cotangent of ``tfs`` once;
- operations: per lane the weight sample (8 corners x 24 x 2) and the
  outer products into 24 x 12 entries (24 x 12 x 2), ~1,000 float32 ops.

The least time the card could take is the larger of bytes over 3.35 TB/s
and operations over 67 TFLOP/s.  K13's grid half, queued here before, is
kernel KM, measured by ``chip_smoke.py``.
"""

from __future__ import annotations

import json

from chip_smoke import PEAK_BYTES, PEAK_FP32
from intrinsicavatar_tpu_torch.utils.default_config import default_config

STEP_RAYS = 4096


def queued_ops(cfg=None) -> list:
    m = (cfg or default_config()).model
    S = int(m.num_samples_per_ray) + int(m.get("n_importance_rounds", 2)) \
        * int(m.get("n_importance_samples", 16))
    frac = float(m.get("query_compaction", 0.5)) + 0.0625
    points = -(-int(STEP_RAYS * S * frac) // 128) * 128
    K = int(m.deformer.rigid_deformer.deformer_config.get("max_candidates",
                                                          4))
    lanes = points * K
    ops = [
        ("K5 bwd wrt tfs",
         "intrinsicavatar_tpu/anim/deformer.py:396-412, "
         "anim/broyden.py:550", 1,
         lanes * (12 + 12 + 36 + 1 + 96) + 24 * 12 * 4,
         lanes * (8 * 24 * 2 + 24 * 12 * 2 + 40)),
    ]
    rows = []
    for name, replaces, launches, nbytes, flops in ops:
        b_bytes = nbytes / PEAK_BYTES * 1e3
        b_ops = flops / PEAK_FP32 * 1e3
        rows.append({"name": name, "replaces": replaces,
                     "launches_per_step": launches, "lanes": lanes,
                     "bytes_per_launch": nbytes, "flops_per_launch": flops,
                     "bound_ms_per_launch": max(b_bytes, b_ops),
                     "bound_by": "bytes" if b_bytes >= b_ops else "operations",
                     "bound_ms_per_step": launches * max(b_bytes, b_ops)})
    return rows


if __name__ == "__main__":
    print(json.dumps({"worked_out_not_measured": queued_ops()}))
