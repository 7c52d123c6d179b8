"""Worked-out bound on an H100 for the hot op the port has not ported yet.

    python3 queued_bounds.py      # prints one JSON line

K13's grid half (``anim/seedgrid.py:173`` ``gather_from_grid`` and ``:252``
``seed_from_grid``) runs only with the eval seed grid, which the port does
not run yet, so nothing can be measured for it.  This works out, from the
code of the JAX package and the shapes of :func:`default_config`, what one
frame of 16,384 rays in 4,096-ray chunks would give it: its launches per
frame (one per call: the coarse gather and the fine seed of each 32,768-ray
shader chunk), the bytes each call must move (each input read once, each
output written once; the 96^3 six-channel corner-packed grid counted at
most at its size) and its float32 operations, and from them the least time
the card could take (the larger of bytes over 3.35 TB/s and operations over
67 TFLOP/s).  The operation counts are estimates from the code, a few
operations per element; the bytes follow from the shapes alone.  K13's
polish half is kernel KL, measured by ``chip_smoke.py``.
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
    spp = int(m.samples_per_pixel)                  # scatter points per ray
    S2 = int(m.num_samples_per_secondary_ray)
    sub = int(m.get("secondary_shader_chunk", 32768))
    subs = R * spp // sub                           # shader chunks
    coarse = int(sub * S2 * float(m.secondary_query_compaction))
    fine = int(sub * 4 * float(m.get("secondary_fine_query_compaction", 0.5)))
    res = int(m.seed_grid_resolution)
    grid_bytes = res ** 3 * 8 * 6 * 4               # corner-packed, 6 ch
    ops = [
        # the gather at the coarse budget, then the seed at the fine budget
        # (12 B point in, 17 B seed + sdf out; a corner row of 192 B)
        ("K13 grid", "intrinsicavatar_tpu/anim/seedgrid.py:173, :252",
         2 * chunks * subs,
         (coarse * (12 + 17) + min(grid_bytes, coarse * 192)
          + fine * (12 + 13) + min(grid_bytes, fine * 192)) / 2,
         (coarse + fine) * 150 / 2),
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
