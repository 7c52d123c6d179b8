"""Worked-out bounds on an H100 for the hot ops the port has not ported yet.

    python3 queued_bounds.py      # prints one JSON line

K10-K13 run only in the PBR stage and with the eval seed grid, which the
port does not run yet, so nothing can be measured for them.  This works out,
from the code of the JAX package and the shapes of :func:`default_config`,
what one frame of 16,384 rays in 4,096-ray chunks would give each op: its
launches per frame (one per call), the bytes each call must move (each
input read once, each output written once; a gathered table counted at most
at its size) and its float32 operations, and from them the least time the
card could take (the larger of bytes over 3.35 TB/s and operations over
67 TFLOP/s).  The operation counts are estimates from the code, a few
operations per element; the bytes follow from the shapes alone.
"""

from __future__ import annotations

import json

from chip_smoke import PEAK_BYTES, PEAK_FP32
from intrinsicavatar_tpu_torch.utils.default_config import default_config

FRAME_RAYS = 16384


def queued_ops(cfg=None) -> list:
    m = (cfg or default_config()).model
    R = int(m.ray_chunk)                            # rays per chunk
    chunks = FRAME_RAYS // R
    # shading intervals per ray after the importance rounds
    S = int(m.num_samples_per_ray) + int(m.get("n_importance_rounds", 2)) \
        * int(m.get("n_importance_samples", 16))
    spp = int(m.samples_per_pixel)                  # scatter points per ray
    S2 = int(m.num_samples_per_secondary_ray)
    sub = int(m.get("secondary_shader_chunk", 32768))
    subs = R * spp // sub                           # secondary sub-chunks
    coarse = int(sub * S2 * float(m.secondary_query_compaction))
    fine = int(sub * 4 * float(m.get("secondary_fine_query_compaction", 0.5)))
    res = int(m.seed_grid_resolution)
    grid_bytes = res ** 3 * 8 * 6 * 4               # corner-packed, 6 ch
    iters = int(m.seed_grid_polish_iters)
    voxel_j = 32 * 128 * 128 * 12 * 4               # skinning transforms
    ops = [
        # ops/resample.py:62 cdf_resample over [R, S] -> spp draws per ray
        ("K10", "intrinsicavatar_tpu/ops/resample.py:62", chunks,
         R * S * (4 * 4 + 1) + R * spp * (4 + 4 + 4 + 1) + R * S * 4 + R * 8,
         R * (S * 12 + spp * 30)),
        # ops/resample.py:282 sdf_fine_resample over [sub, S2] -> 4 intervals
        ("K11", "intrinsicavatar_tpu/ops/resample.py:282", chunks * subs,
         sub * S2 * (4 * 4 + 1) + sub * 4 * (4 + 4 + 1),
         sub * (S2 * 15 + 5 * 20)),
        # render/pbr.py:194 the secondary march of each sub-chunk (K6 at
        # S2 steps, then the cap of 8 occupied samples)
        ("K12", "intrinsicavatar_tpu/render/pbr.py:194", chunks * subs,
         sub * (24 + 8) + 64 ** 3 + sub * (S2 + 1) * 7 + sub * S2,
         sub * S2 * 35),
        # anim/seedgrid.py:173 gather at the coarse budget, then :252 +
        # anim/broyden.py:464 seed and polish at the fine budget
        ("K13", "intrinsicavatar_tpu/anim/seedgrid.py:173, :252; "
                "intrinsicavatar_tpu/anim/broyden.py:464", 2 * chunks * subs,
         (coarse * (12 + 17) + min(grid_bytes, coarse * 192)
          + fine * (12 + 12 + 36 + 1) + min(grid_bytes, fine * 192)
          + min(voxel_j, fine * iters * 8 * 48)) / 2,
         (coarse * 150 + fine * (150 + iters * 300)) / 2),
    ]
    rows = []
    for name, replaces, launches, nbytes, flops in ops:
        b_bytes = nbytes / PEAK_BYTES * 1e3
        b_ops = flops / PEAK_FP32 * 1e3
        rows.append({"name": name, "replaces": replaces,
                     "launches_per_frame": launches,
                     "bytes_per_launch": nbytes, "flops_per_launch": flops,
                     "bound_ms_per_launch": max(b_bytes, b_ops),
                     "bound_by": "bytes" if b_bytes >= b_ops else "operations",
                     "bound_ms_per_frame": launches * max(b_bytes, b_ops)})
    return rows


if __name__ == "__main__":
    print(json.dumps({"worked_out_not_measured": queued_ops()}))
