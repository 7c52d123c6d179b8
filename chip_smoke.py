"""Drive the PyTorch/CUDA port on one NVIDIA card and check it.

    python3 chip_smoke.py            # build, check kernels, serve, train

1. prints the card's name and power limit and builds the CUDA kernels from
   the sources in this checkout (one ``nvcc`` per source, in parallel);
2. renders one chunk of a validation frame (its test grid included) at the
   full width of the default model by the searched path and records the
   inputs each kernel wrapper got there; then bakes the frame's seed grid
   and renders the chunk by the grid path, and records the bake's last
   chunk of the search, its prologue and epilogue, and the grid-seeded
   shading pass's fused SDF query;
3. runs each kernel and its plain PyTorch twin on those inputs, holds them
   to the stated tolerance and times both with CUDA events (the search,
   its prologue and epilogue and the fused SDF query at both paths'
   shapes); KB also with noise on every weight (the sphere init zeroes
   the weights of its hash features), at the tiny config's widths and at
   a relight fine pass, with its device time and its bound at the FP32
   and at the TF32 rate; KM's and ``F.grid_sample``'s device times; KA's,
   KC's and the KH prologue's and epilogue's device times (KA also at a
   relight fine pass and a train step and with noise on its table, the
   prologue, the epilogue and KC also at the phys step's secondary coarse
   call, KC with the histogram of its
   lanes' iterations and the share of issued samples that do work,
   ``lane_work``); KF's and KD weights' device times at their recorded
   calls (KD at a serve chunk's second importance round, [4096, 145]); KH
   skinning against its twin and its transform-voxel form in plain
   PyTorch, its bound over the voxel rows its points touch (of the
   transform voxel it reads and of the weight voxel); the registers,
   stack frame and spills of every kernel of the port from ``ptxas``;
4. serves: bakes one frame's 96^3 seed grid alone (its time and launches),
   then renders 2 frames x 16,384 rays of the synthetic val split through
   ``render_frame`` (each with its own 64^3 test grid and seed grid, the
   default eval path) with every launch counter set to 0 just before and
   read just after and the plain twins of the seed-grid gather and of KD
   weights set to fail if called; renders one more frame under
   ``torch.profiler`` to show where
   the device time goes; renders each frame again by the searched path
   (``model.eval_seed_grid=false``): its rays/s, peak memory (the first
   frame also under the profiler), its PSNR and its per-ray
   agreement with the grid path's render and with the grid path's render
   whose importance rounds are queried (``baked_importance: false``); and
   counts the grid-seeded shading lanes whose polish fails, and of those
   the ones a search canonicalizes; and times the two paths in turn, 3
   times each frame;
5. checks the output: finite maps, a surface (opacity > 0.5) in view, a
   32^3 seed grid baked on the card and on the CPU twins agreeing, and a
   256-ray crop of the same frame rendered on the CPU with the plain twins
   (from the card's seed grid) agreeing with the card's render;
6. relights (``relight_config()``, eval step 25,000, the PBR stage on at
   the published widths: 512 scattering points per ray, 64-step secondary
   rays in 32,768-ray shader chunks): records the inputs of KI-KM in one
   4,096-ray chunk with the frame's seed grid, holds each against its twin
   (KM also on a hand-built grid) and times both (KK also on the device;
   KD weights at a shader chunk's call and KL at the fine pass that seeds
   the most points, also with its points seeded from a search, each with
   its device time and bound, KL with its seeded points' iterations and
   warp efficiency); then, with every launch
   counter set to 0 just before and read just after and the plain twins of
   KI-KM and KD weights set to fail if called, renders one frame of 16,384
   rays; profiles
   one chunk; renders the frame by the searched path (its rays/s, peak
   memory, a chunk's profile, PSNR and per-ray agreement with the grid
   path's render) and times the two paths
   in turn, twice each; and renders a 32-ray
   crop on the card and on the CPU twins from the same draws and seed grid,
   whose physically based maps must agree;
7. trains: records the backward kernels' inputs in one full-width train
   step at step 2000, holds each backward kernel against its twin on them
   and times both (KB' pass 1 and pass 2 at the step's shading call and
   its curvature call, KA' at its radiance call, also with ``d_x`` on the
   same inputs, each with its device time, the warps' merge hit rate by
   level, its
   bound over the cotangent rows its corners touch, and ``index_add_`` of
   the same adds, precomputed, as the library yardstick); then, with every
   launch counter set to 0 just before and
   read just after, runs ``fit`` for 3 steps from step 0 (full budgets, no
   importance rounds, an occupancy update) and 10 from step 2000 (2 x 16
   importance samples, compacted shading, curvature on a 25% subsample),
   with the plain backward twins set to fail if called; profiles one step;
   and runs one 256-ray step on the card and on the CPU twins from the same
   parameters and draws, whose loss and gradients must agree;
8. trains with the pose correction on (``enable_pose_correction``): records
   KN's inputs in one full-width step at step 4,001, holds KN against its
   float64 sum within the rounding bound of its own order (and two calls
   against each other, bit for bit; planted faults refused) and times it
   beside the twin and ``W.t() @ U``; with every launch counter set to 0
   just before and read just after and the plain backward twins (KN's
   included) set to fail if called, runs ``fit`` for 10 steps from step
   4,001 (one KN launch a step; the pose corrections of the frames seen
   move) and 3 from step 10,000, the phys regime at full width (512
   scattering points, 64-step secondary rays in 32,768-ray shader chunks,
   ``uniform_light``, with the PBR kernels' twins set to fail too), and
   holds KD weights at the step's shader-chunk call, KL at its fine pass
   (with the points seeded a call over all its calls) and KH skinning at
   its fine pass against their twins, with their device times and bounds,
   and KN's call as at step 4,001;
   profiles one phys step; and runs a 256-ray step at step 4,001 and a
   32-ray phys step at step 10,000 on the card and on the CPU twins, whose
   losses and gradients (the pose's included) must agree;
9. prints the ``kernels`` line, the serve, relight and train lines (each
   profile with the device ms, launches and share of busy time of the
   kernels of the port, KG's count and scatter passes apart, and whether
   each was redesigned for the card, ``port_kernels``), and last the
   device line.

Any failure exits nonzero before the last line is printed.  There is no CPU
fallback: without a card the script fails.
"""

from __future__ import annotations

import collections
import copy
import json
import subprocess
import sys
import time

import numpy as np

SEED = 0
T0 = time.perf_counter()
# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_BYTES = 3.35e12
PEAK_FP32 = 67e12
PEAK_TF32 = 495e12
# the kernels redesigned for the card, before their redesign (PERF.md
# section 6, same card, 700 W): KB at the searched shading query's 552,960
# points, KM at a relight chunk's busiest secondary coarse gather, KA at a
# serve chunk's largest call (1,179,648 points), the KH epilogue and KC at
# a serve chunk's search (6,291,456 lanes; KC's events without the voxel
# copy), KB' pass 2 at a train step's shading call (552,960 points), KA' at
# its radiance call (368,640 points), KF at a serve chunk's second
# importance round ([4096, 145] edges, 16 draws), KJ at a shader chunk's
# call ([32768, 64] -> 4), KG at the test grid's candidate lanes
# (3,145,728 entries), the KH prologue at a serve chunk's search (786,432
# points; device 0.0349 at the phys step's secondary coarse call, 262,144),
# KK at a shader chunk's call ([32768, 64], cap 8; device 0.0210), KD
# weights at a shader chunk's call ([32768, 4]; device, the phys step's
# profile: 1.354 ms over 66 launches), KL at a phys step's fine pass
# (65,536 points; device, 0.903 ms over 64 launches), KH skinning at a
# serve chunk's shading query (1,474,560 lanes; device 0.101; 0.0092 at a
# phys step's fine pass, 0.855 ms over 65 launches in its profile) and
# KB' pass 1 at a train step's shading call (552,960 points; 0.786 ms over
# 2 launches in its profile), KN at a pose step's train call (1,474,560
# lanes, its two launches; device 0.217 ms a phys step) and KI at the PBR
# stage's [4096, 160] -> 512 call (device 0.0275)
EARLIER_MS = {"encode_mlp_sdfgrad": "6.887-6.892", "seed_gather":
              "0.0513-0.0740", "hashgrid_encode": "0.855",
              "deform_epilogue": "0.852-0.857", "broyden_search": "0.501",
              "encode_mlp_sdfgrad_bwd_scatter": "4.337-4.463",
              "hashgrid_encode_bwd": "3.798-4.137",
              "merge_resample": "0.500-0.502",
              "fine_resample": "0.0522-0.0527",
              "compact_indices": "0.046-0.072",
              "deform_prologue": "0.080-0.083",
              "secondary_march": "0.0486-0.0775",
              "volrend_weights": "0.0205", "broyden_polish": "0.0141",
              "deform_skinning": "0.108 (device 0.101)",
              "encode_mlp_sdfgrad_bwd_gather": "0.684-0.697",
              "deform_skinning_bwd": "0.2198-0.2321",
              "cdf_resample": "0.0617-0.0739 (device 0.0275)"}
# the profiler's names of every kernel of the port (KG's count and scatter
# passes apart); a kernel's wrapper counts its launches under the same
# name (KG's under compact_indices)
PORT_KERNELS = {"hashgrid_encode": "::hashgrid_encode_kernel",
                "hashgrid_encode_bwd": "hashgrid_encode_bwd_kernel",
                "encode_mlp_sdfgrad": "encode_mlp_sdfgrad_kernel",
                "encode_mlp_sdfgrad_bwd_gather":
                    "encode_mlp_sdfgrad_bwd_gather_kernel",
                "encode_mlp_sdfgrad_bwd_scatter":
                    "encode_mlp_sdfgrad_bwd_scatter_kernel",
                "broyden_search": "broyden_search_kernel",
                "broyden_polish": "broyden_polish_kernel",
                "deform_prologue": "::prologue_kernel<",
                "deform_epilogue": "::epilogue_kernel(",
                "deform_skinning": "::skinning_kernel(",
                "deform_skinning_bwd": "::skinning_bwd_",
                "occupancy_march": "occupancy_march_kernel",
                "secondary_march": "secondary_march_kernel",
                "merge_resample": "merge_resample_kernel",
                "cdf_resample": "cdf_resample_kernel",
                "fine_resample": "fine_resample_kernel",
                "compact_count": "compact_count_",
                "compact_scatter": "compact_scatter_",
                "seed_gather": "seed_gather_kernel",
                "volrend_weights": "weights_kernel",
                "volrend_composite": "composite_kernel",
                "volrend_composite_bwd": "composite_bwd_kernel"}
# the kernels redesigned for the card
REDESIGNED = ("encode_mlp_sdfgrad", "seed_gather", "hashgrid_encode",
              "deform_epilogue", "broyden_search",
              "encode_mlp_sdfgrad_bwd_scatter", "hashgrid_encode_bwd",
              "merge_resample", "fine_resample", "compact_count",
              "compact_scatter", "deform_prologue", "secondary_march",
              "volrend_weights", "broyden_polish", "deform_skinning",
              "encode_mlp_sdfgrad_bwd_gather", "deform_skinning_bwd",
              "cdf_resample")


def fail(msg: str):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 10) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


class Recorder:
    """Stands in for a kernel wrapper in the module that calls it and keeps
    the arguments of its largest call (and of every call in ``calls``,
    where given)."""

    def __init__(self, module, name, size_of, calls=None):
        self.module, self.name, self.size_of = module, name, size_of
        self.fn = getattr(module, name)
        self.best = None
        self.calls = calls
        setattr(module, name, self)

    def __call__(self, *args, **kwargs):
        if self.calls is not None:
            self.calls.append((args, kwargs))
        size = self.size_of(args)
        if self.best is None or size > self.best[0]:
            self.best = (size, args, kwargs)
        return self.fn(*args, **kwargs)

    def restore(self):
        setattr(self.module, self.name, self.fn)


def main():
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script runs on a card")
    try:
        from intrinsicavatar_tpu_torch import kernels
    except ImportError as e:
        fail(f"the port is not importable here ({e}); run from the repo root")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()
    print(f"card: {card}", flush=True)

    from intrinsicavatar_tpu_torch.anim import broyden as B
    from intrinsicavatar_tpu_torch.anim import deformer as DF
    from intrinsicavatar_tpu_torch.anim import seedgrid as SG
    from intrinsicavatar_tpu_torch.data.synthetic import SyntheticDataset
    from intrinsicavatar_tpu_torch.fields import geometry as GEO
    from intrinsicavatar_tpu_torch.fields import radiance as RAD
    from intrinsicavatar_tpu_torch.ops import compact as C
    from intrinsicavatar_tpu_torch.ops import encode_grad as EG
    from intrinsicavatar_tpu_torch.ops import grid_traversal as G
    from intrinsicavatar_tpu_torch.ops import resample as RS
    from intrinsicavatar_tpu_torch.ops import volrend as V
    from intrinsicavatar_tpu_torch.render import renderer as RD
    from intrinsicavatar_tpu_torch.render.renderer import IntrinsicAvatar
    from intrinsicavatar_tpu_torch.train import evaluate as EV
    from intrinsicavatar_tpu_torch.utils.default_config import serve_config

    # ---------------------------------------------------------- 1. build
    t0 = time.perf_counter()
    logs = kernels.build_all(verbose=True)
    for name, log in logs.items():
        print(f"--- nvcc {name}\n{log}", file=sys.stderr)
    print(f"built {sorted(logs)} in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for name, log in logs.items():
        for fn, info in ptxas_info(log).items():
            print(f"ptxas {fn}: {info} ({card})", flush=True)

    # ---------------------------------------------------------- model
    cfg = serve_config()
    step = int(cfg.trainer.eval_step)
    model = IntrinsicAvatar(cfg.model).to(dev)
    model.init(torch.Generator().manual_seed(SEED))
    ds = SyntheticDataset(cfg.dataset, split="val", mode="val")
    t0 = time.perf_counter()
    statics = model.initialize(ds.betas)
    torch.cuda.synchronize()
    print(f"statics in {time.perf_counter() - t0:.2f} s", flush=True)
    flags = EV.eval_flags(cfg.model, step)
    if flags.enable_phys or not flags.importance_sample:
        fail(f"step {step} is not in the radiance regime")
    if not cfg.model.eval_seed_grid:
        fail("serve_config() does not render with the eval seed grid")
    chunk = int(cfg.model.get("ray_chunk", 4096))
    # the synthetic dataset draws new rays on every read: keep each frame's
    # host copy for its metrics
    frames_np = [ds[i] for i in range(len(ds))]
    batches = [EV.batch_to_device(b, dev) for b in frames_np]

    # ---------------------------------------------------------- 2. capture
    recs = [
        Recorder(GEO, "hashgrid_encode", lambda a: a[1].shape[0]),
        Recorder(RAD, "hashgrid_encode", lambda a: a[1].shape[0]),
        Recorder(GEO, "encode_mlp_sdfgrad", lambda a: a[3].shape[0]),
        Recorder(DF, "broyden_search", lambda a: a[0].shape[0]),
        Recorder(V, "render_weight_from_alpha", lambda a: a[0].numel()),
        Recorder(V, "composite", lambda a: a[0].numel()),
        Recorder(RD, "occupancy_sampling", lambda a: a[0].shape[0]),
        Recorder(RS, "merge_resample_rays", lambda a: a[0].numel()),
        Recorder(C, "_compact", lambda a: a[0].numel()),
        Recorder(DF, "deform_prologue", lambda a: a[0].shape[0]),
        Recorder(DF, "deform_epilogue", lambda a: a[0].x.shape[0]),
        # the largest epilogue that blends the rotation (a shading query)
        Recorder(DF, "deform_epilogue",
                 lambda a: a[0].x.shape[0] if a[3] else -1),
    ]
    gen = torch.Generator().manual_seed(SEED + 1)
    occ, frame, cond = EV.build_test_occ_grid(model, statics, batches[0],
                                              step, generator=gen)
    # the searched path (eval_seed_grid: false) gives the search, its
    # prologue and epilogue their largest calls
    with torch.no_grad():
        model(statics, frame, cond, occ, batches[0]["rays"][:chunk], step,
              flags, background_color=torch.ones(3, device=dev))
    for r in reversed(recs):
        r.restore()
    ka = max(recs[:2], key=lambda r: r.best[0]).best
    kb, kc, kd_w, kd_c, ke, kf, kg, kh_pro, kh_epi, kh_rot = (
        r.best for r in recs[2:])
    # on the grid path the search, its prologue and epilogue run only in
    # the bake: keep its last chunk (padded with points at the origin);
    # KB runs on the grid-seeded shading pass, one candidate a lane
    order = iter(range(1 << 30))
    recs = [Recorder(DF, "broyden_search", lambda a: next(order)),
            Recorder(DF, "deform_prologue", lambda a: next(order)),
            Recorder(DF, "deform_epilogue", lambda a: next(order))]
    sgrid = EV.build_seed_grid(model, statics, frame, cond, step)
    for r in reversed(recs):
        r.restore()
    kc_g, kh_pro_g, kh_epi_g = (r.best for r in recs)
    recs = [Recorder(GEO, "encode_mlp_sdfgrad", lambda a: a[3].shape[0])]
    with torch.no_grad():
        model(statics, frame, cond, occ, batches[0]["rays"][:chunk], step,
              flags, background_color=torch.ones(3, device=dev),
              seed_grid=sgrid)
    recs[0].restore()
    kb_g = recs[0].best
    del recs, sgrid

    # ---------------------------------------------------------- 3. kernels
    rows = []

    def row(name, route, source, replaces, shape, err, ms, plain_ms, nbytes,
            flops, library_ms=None):
        b_bytes = nbytes / PEAK_BYTES * 1e3
        b_ops = flops / PEAK_FP32 * 1e3
        rows.append({
            "name": name, "route": route, "source": source,
            "replaces": replaces, "launches": 0, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": max(b_bytes, b_ops),
            "bound_by": "bytes" if b_bytes >= b_ops else "operations",
            "library_ms": library_ms})
        print(f"kernel {name} {shape}: max_abs_err={err:.3g} ms={ms:.4f} "
              f"plain_ms={plain_ms:.4f} bound_ms={max(b_bytes, b_ops):.4f}",
              flush=True)

    grid_shapes = []

    def grid_shape(name, at, shape, err, ms, plain_ms, nbytes, flops):
        """A kernel checked and timed at the grid path's call ``at``; its
        row in the kernels line keeps the searched path's shape."""
        b_bytes = nbytes / PEAK_BYTES * 1e3
        b_ops = flops / PEAK_FP32 * 1e3
        grid_shapes.append({
            "name": name, "at": at, "shape": shape, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": max(b_bytes, b_ops),
            "bound_by": "bytes" if b_bytes >= b_ops else "operations"})
        print(f"kernel {name} at the grid path's {at} {shape}: "
              f"max_abs_err={err:.3g} ms={ms:.4f} plain_ms={plain_ms:.4f} "
              f"bound_ms={max(b_bytes, b_ops):.4f}", flush=True)

    # KA hash encode
    def ka_row(rec, where):
        r = ka_reading(rec, where, card)
        return (r["shape"], r["max_abs_err"], r["ms"], r["plain_ms"],
                r["bytes"], r["flops"])

    row("hashgrid_encode", "cuda",
        "intrinsicavatar_tpu_torch/csrc/hashgrid.cu",
        "intrinsicavatar_tpu/ops/hashgrid.py:191",
        *ka_row(ka, "serve chunk's largest call"))

    # KB fused encode + SDF MLP + gradient
    def kb_row(rec, where):
        r = kb_reading(rec, where, card)
        return (r["shape"], r["max_abs_err"], r["ms"], r["plain_ms"],
                r["bytes"], r["flops"])

    row("encode_mlp_sdfgrad", "cuda",
        "intrinsicavatar_tpu_torch/csrc/encode_grad.cu",
        "intrinsicavatar_tpu/ops/encode_grad.py:166",
        *kb_row(kb, "searched shading query"))
    grid_shape("encode_mlp_sdfgrad", "seeded shading pass",
               *kb_row(kb_g, "seeded shading pass"))
    kb_tiny_widths(dev, card)

    # KC Broyden search
    def kc_row(rec, where):
        r = kc_reading(rec, where, card)
        return (r["shape"], r["max_abs_err"], r["ms"], r["plain_ms"],
                r["bytes"], r["flops"])

    row("broyden_search", "cuda", "intrinsicavatar_tpu_torch/csrc/broyden.cu",
        "intrinsicavatar_tpu/anim/broyden.py:351",
        *kc_row(kc, "searched shading query"))
    grid_shape("broyden_search", "bake's last chunk",
               *kc_row(kc_g, "bake's last chunk"))

    # KD weights (a serve chunk's second importance round, [4096, 145])
    # and composite (final)
    kd_read = kd_reading(kd_w, "serve chunk's second importance round",
                         card)
    row("volrend_weights", "cuda",
        "intrinsicavatar_tpu_torch/csrc/volrend.cu",
        "intrinsicavatar_tpu/ops/volrend.py:61",
        f"alphas{kd_read['shape']}", kd_read["max_abs_err"], kd_read["ms"],
        kd_read["plain_ms"], kd_read["bytes"], kd_read["flops"])

    cargs = kd_c[1]
    ok_ = V.composite(*cargs)
    op_ = V.composite_plain(*cargs)
    torch.cuda.synchronize()
    err = max((a - b).abs().max().item() for a, b in zip(ok_, op_))
    if not err <= 1e-5:
        fail(f"composite disagrees with its twin: {err}")
    n = cargs[0].numel()
    row("volrend_composite", "triton",
        "intrinsicavatar_tpu_torch/ops/volrend_triton.py",
        "intrinsicavatar_tpu/ops/volrend.py:38",
        f"sdf{list(cargs[0].shape)}", err,
        time_ms(lambda: V.composite(*cargs)),
        time_ms(lambda: V.composite_plain(*cargs)),
        n * (4 + 4 + 1 + 12 + 12 + 4 + 4 + 4) + cargs[0].shape[0] * 32,
        n * 40)

    # KE occupancy march (the chunk's march)
    args, kw = ke[1], ke[2]
    ik = G.occupancy_sampling(*args, **kw)
    ip = G.occupancy_sampling_plain(*args, **kw)
    torch.cuda.synchronize()
    for name in ("is_left", "is_right", "valid", "vals"):
        a, b = getattr(ik, name), getattr(ip, name)
        if name != "vals" and not torch.equal(a, b):
            fail(f"occupancy_march: {name} differs from its twin")
    if not torch.equal(torch.isinf(ik.vals), torch.isinf(ip.vals)):
        fail("occupancy_march: +inf slots differ from its twin")
    err = (ik.vals - ip.vals)[ip.valid].abs().max().item()
    if not err <= 1e-6:
        fail(f"occupancy_march disagrees with its twin: {err}")
    R, E = ip.vals.shape
    res = args[2].shape[0]
    row("occupancy_march", "cuda", "intrinsicavatar_tpu_torch/csrc/march.cu",
        "intrinsicavatar_tpu/ops/grid_traversal.py:56",
        f"rays{[R, 3]} S={E - 1}", err,
        time_ms(lambda: G.occupancy_sampling(*args, **kw)),
        time_ms(lambda: G.occupancy_sampling_plain(*args, **kw)),
        R * (12 + 12 + 4 + 4 + 4) + res ** 3 + 24 + R * E * (4 + 3),
        R * (E - 1) * 30 + R * 40)

    # KF merge resampling (the larger, second round)
    args = kf[1]
    mk = RS.merge_resample_rays(*args)
    mp = RS.merge_resample_rays_plain(*args)
    torch.cuda.synchronize()
    same = torch.ones(mp.vals.shape[0], dtype=torch.bool, device=dev)
    for name in ("is_left", "is_right", "valid", "is_new", "gather_idx"):
        same &= (getattr(mk, name) == getattr(mp, name)).all(-1)
    same_share = same.float().mean().item()
    err = (mk.vals - mp.vals)[same[:, None] & mp.valid].abs().max().item()
    # torch.cumsum on the card sums in another order than the kernel's
    # sequential sum and can move a draw across a CDF boundary
    print(f"merge_resample: {same_share:.6f} of rays equal on flags and "
          f"indices", flush=True)
    if not (same_share >= 0.999 and err <= 1e-5):
        fail(f"merge_resample disagrees with its twin: {same_share} of "
             f"rays equal, err={err}")
    R, E = args[0].shape
    n_new = args[5]
    kf_call = lambda: RS.merge_resample_rays(*args)
    row("merge_resample", "cuda",
        "intrinsicavatar_tpu_torch/csrc/resample.cu",
        "intrinsicavatar_tpu/ops/resample.py:166",
        f"vals{[R, E]} B={n_new}", err, time_ms(kf_call),
        time_ms(lambda: RS.merge_resample_rays_plain(*args)),
        R * E * (4 + 3 + 4) + R * (E + n_new) * (4 + 4 + 8),
        R * (E * 10 + n_new * 20 + 2 * E * n_new))
    # at this size the wrapper's six allocations may set the event time
    kf_read = {"shape": f"vals{[R, E]} B={n_new}",
               "ms": rows[-1]["ms"],
               "device_ms": device_ms(kf_call,
                                      PORT_KERNELS["merge_resample"]),
               "equal_share": same_share,
               "before_redesign_ms": EARLIER_MS["merge_resample"],
               "card": card}
    print(f"kernel merge_resample (serve chunk's second round): "
          f"{json.dumps(kf_read)}", flush=True)

    # KG compaction (the test grid's candidate lanes)
    kg_read = kg_row(row, rows, *kg[1], "test grid's candidate lanes", card)

    # KH prologue (the test grid's points)
    def check_kh_pro(rec, where):
        r = prologue_reading(rec, where, card)
        return (r["shape"], 0.0, r["ms"], r["plain_ms"], r["bytes"],
                r["flops"])

    row("deform_prologue", "cuda", "intrinsicavatar_tpu_torch/csrc/deform.cu",
        "intrinsicavatar_tpu/anim/deformer.py:264",
        *check_kh_pro(kh_pro, "serve chunk's search"))
    grid_shape("deform_prologue", "bake's last chunk",
               *check_kh_pro(kh_pro_g, "bake's last chunk"))

    # KH epilogue: filter + first-K (the test grid's lanes), without the
    # blend, which the next row times on a shading call
    def check_kh_epi(rec, where):
        r = epilogue_reading(rec, where, card)
        return (r["shape"], 0.0, r["ms"], r["plain_ms"], r["bytes"],
                r["flops"])

    row("deform_epilogue", "cuda", "intrinsicavatar_tpu_torch/csrc/deform.cu",
        "intrinsicavatar_tpu/anim/broyden.py:518",
        *check_kh_epi(kh_epi, "serve chunk's search"))
    grid_shape("deform_epilogue", "bake's last chunk",
               *check_kh_epi(kh_epi_g, "bake's last chunk"))

    # KH skinning: the LBS rotation at a shading call's kept lanes
    if not kh_rot[1][3]:
        fail("no deform_epilogue call blended the rotation")
    _, _, _, _, lbs_cl, spec, tfs, voxel_J = kh_rot[1]
    xc = B.deform_epilogue(*kh_rot[1], **kh_rot[2]).xc
    sk = skinning_reading((xc, lbs_cl, spec, tfs, voxel_J),
                          "serve chunk's shading query", card)
    row("deform_skinning", "cuda", "intrinsicavatar_tpu_torch/csrc/deform.cu",
        "intrinsicavatar_tpu/anim/deformer.py:235", sk["shape"],
        sk["max_abs_err"], sk["ms"], sk["plain_ms"], sk["bytes"],
        sk["flops"], sk["library_ms"])

    # ---------------------------------------------------------- 4. serve
    # the seed grid's bake alone: one frame's 96^3 lattice searched
    _, frame_b, cond_b = EV.build_test_occ_grid(
        model, statics, batches[0], step,
        generator=torch.Generator().manual_seed(100))
    bake_line = bake_alone(model, statics, frame_b, cond_b, step)

    trips = [Tripwire(SG, "gather_from_grid_plain"),
             Tripwire(V, "render_weight_from_alpha_plain")]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    outs, frame_s = [], []
    for i, b in enumerate(batches):
        tf = time.perf_counter()
        out = EV.render_frame(model, statics, b, step, flags,
                              ray_chunk=chunk,
                              generator=torch.Generator().manual_seed(100 + i))
        torch.cuda.synchronize()
        frame_s.append(time.perf_counter() - tf)
        outs.append(out)
    serve_s = time.perf_counter() - t0
    launches = dict(kernels.launches)
    peak = torch.cuda.max_memory_allocated()
    for t in trips:
        t.restore()
    if any(t.calls for t in trips):
        fail(f"plain twins ran on the card in the serve frames: "
             f"{[(t.name, t.calls) for t in trips if t.calls]}")
    names = {"hashgrid_encode", "encode_mlp_sdfgrad", "broyden_search",
             "volrend_weights", "volrend_composite", "occupancy_march",
             "merge_resample", "compact_indices", "deform_prologue",
             "deform_epilogue", "deform_skinning", "broyden_polish",
             "seed_gather"}
    for r in rows:
        r["launches"] = int(launches.get(r["name"], 0))
    missing = [n for n in names if not launches.get(n)]
    if missing:
        fail(f"kernels not launched on the main path: {missing}")
    # the LBS rotation is blended only for the shading query of each chunk
    n_chunks = sum(-(-b["rays"].shape[0] // chunk) for b in batches)
    n_rot = launches.get("deform_skinning", 0)
    if n_rot > n_chunks:
        fail(f"deform_skinning launched {n_rot} times for {n_chunks} chunks")
    # KM: the importance rounds' gathers and the shading pass's seeds
    n_km = n_chunks * (model.n_importance_rounds + 1)
    n_seed = launches.get("seed_gather", 0)
    if n_seed != n_km:
        fail(f"seed_gather launched {n_seed} times, expected {n_km}")
    print(f"serve launches per frame: "
          f"{json.dumps({k: v / len(batches) for k, v in launches.items()})}",
          flush=True)

    # where a frame's device time goes: one more frame under the profiler,
    # its test-grid build and its bake timed on their own
    grid = {}

    def profiled_frame():
        tf = time.perf_counter()
        occ_p, frame_p, cond_p = EV.build_test_occ_grid(
            model, statics, batches[0], step,
            generator=torch.Generator().manual_seed(100))
        torch.cuda.synchronize()
        tb = time.perf_counter()
        sgrid = EV.build_seed_grid(model, statics, frame_p, cond_p, step)
        torch.cuda.synchronize()
        grid["ms"] = (tb - tf) * 1e3
        grid["bake_ms"] = (time.perf_counter() - tb) * 1e3
        EV.render_frame(model, statics, batches[0], step, flags,
                        ray_chunk=chunk, occ=occ_p, frame=frame_p,
                        cond=cond_p, seed_grid=sgrid)

    wall_ms, by_kernel = profile_device(profiled_frame)
    busy_ms = sum(ms for ms, _ in by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:15]
    serve_profile = {
        "frame_wall_ms": wall_ms, "test_grid_wall_ms": grid["ms"],
        "bake_wall_ms": grid["bake_ms"], "device_busy_ms": busy_ms,
        "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
        "device_launches": sum(n for _, n in by_kernel.values()),
        "port_kernels": kernel_shares(by_kernel, busy_ms),
        "top": [[k[:70], ms, n] for k, (ms, n) in top]}
    print(json.dumps({"profile": serve_profile}), flush=True)

    # the searched eval path, for comparison: each frame again, from the
    # same test grid, its PSNR and its per-ray agreement with the grid
    # path's render; and where the grid-seeded polish loses lanes
    searched = []
    for i, b in enumerate(batches):
        line, out_s = searched_frame(
            model, statics, b, step, flags, chunk,
            torch.Generator().manual_seed(100 + i),
            profile_batch=b if i == 0 else None)
        line["psnr"] = EV.frame_metrics(out_s, frames_np[i])["psnr"]
        line["grid_vs_searched"] = agreement(outs[i], out_s, EV.KEEP[:3],
                                             "comp_rgb_full")
        line["shading_lanes"] = polish_losses(
            model, statics, b, step, flags, chunk,
            torch.Generator().manual_seed(100 + i))
        # the grid path with its importance rounds queried (seeded from the
        # grid) in place of the grid's SDF: what the baked rounds move
        model.config.baked_importance = False
        try:
            out_q = EV.render_frame(model, statics, b, step, flags,
                                    ray_chunk=chunk,
                                    generator=torch.Generator().manual_seed(
                                        100 + i))
        finally:
            model.config.baked_importance = True
        line["queried_importance_vs_searched"] = agreement(
            out_q, out_s, EV.KEEP[:3], "comp_rgb_full")
        print(f"frame {i}, grid vs searched: "
              f"{json.dumps({k: line[k] for k in ('psnr', 'grid_vs_searched', 'queried_importance_vs_searched', 'shading_lanes')})}",
              flush=True)
        searched.append(line)
        del out_s, out_q
    in_turn = alternate(model, statics, batches, step, flags, chunk,
                        [100 + i for i in range(len(batches))], 3)

    # ---------------------------------------------------------- 5. check
    n_rays = sum(b["rays"].shape[0] for b in batches)
    metrics = []
    for i, (out, b) in enumerate(zip(outs, batches)):
        for k in EV.KEEP:
            if not np.all(np.isfinite(out[k])):
                fail(f"frame {i}: {k} is not finite")
        if out["comp_rgb_full"].shape != (b["rays"].shape[0], 3):
            fail(f"frame {i}: comp_rgb_full has shape "
                 f"{out['comp_rgb_full'].shape}")
        hit = float((out["opacity"] > 0.5).mean())
        if hit <= 0.0:
            fail(f"frame {i}: no ray has opacity > 0.5")
        m = EV.frame_metrics(out, frames_np[i])
        metrics.append({"psnr": m["psnr"], "hit_fraction": hit,
                        "counters": out["counters"]})
        print(f"frame {i}: {json.dumps(metrics[-1])}", flush=True)

    # the same frame's first 256 rays, on the CPU with the plain twins, both
    # from the seed grid baked on the card
    b0 = batches[0]
    occ0, frame0, cond0 = EV.build_test_occ_grid(
        model, statics, b0, step, generator=torch.Generator().manual_seed(7))
    grid0 = EV.build_seed_grid(model, statics, frame0, cond0, step)
    crop = {k: v for k, v in b0.items()}
    crop["rays"] = b0["rays"][:256]
    gpu = EV.render_frame(model, statics, crop, step, flags, ray_chunk=256,
                          occ=occ0, frame=frame0, cond=cond0,
                          seed_grid=grid0)
    to_cpu = lambda t: type(t)(*(v.cpu() for v in t))
    model_cpu = copy.deepcopy(model).cpu()
    bake_check = bake_card_vs_cpu(model, model_cpu, statics, frame0, cond0,
                                  step)
    cpu = EV.render_frame(
        model_cpu, to_cpu(statics), {k: v.cpu() for k, v in crop.items()},
        step, flags, ray_chunk=256, occ=to_cpu(occ0), frame=to_cpu(frame0),
        cond=cond0.cpu(), seed_grid=grid0.to("cpu"))
    agree = min(float((np.abs(gpu[k] - cpu[k]).max(-1) < 1e-4).mean())
                for k in ("comp_rgb_full", "opacity", "depth", "comp_normal"))
    print(f"card vs plain-twin render of 256 rays: {agree:.4f} of rays "
          f"within 1e-4", flush=True)
    if agree < 0.99:
        fail(f"the card's render disagrees with the plain twins: {agree}")

    relight_line = relight(rows, row, card, dev)
    train_line = train(rows, row, card, dev)
    pose_phys_line = train_pose_phys(rows, row, card, dev)

    # ---------------------------------------------------------- 7. report
    print(json.dumps({
        "serve": {"frames": len(outs), "rays": n_rays,
                  "rays_per_s": n_rays / serve_s, "frame_s": frame_s,
                  "peak_mem_bytes": peak, "card": card,
                  "psnr": [m["psnr"] for m in metrics],
                  "launches_per_frame": {k: v / len(outs)
                                         for k, v in launches.items()},
                  "profile": {k: serve_profile[k] for k in (
                      "frame_wall_ms", "bake_wall_ms", "device_busy_ms",
                      "device_idle_share", "device_launches",
                      "port_kernels")},
                  "bake": bake_line, "bake_cpu_check": bake_check,
                  "kf_second_round": kf_read,
                  "kd_second_round": kd_read,
                  "kg_candidate_call": kg_read,
                  "grid_path_shapes": grid_shapes,
                  "searched": searched, "in_turn": in_turn}}), flush=True)
    print(json.dumps({"relight": relight_line}), flush=True)
    print(json.dumps({"train": train_line}), flush=True)
    print(json.dumps({"train_pose_phys": pose_phys_line}), flush=True)
    print(f"chip_smoke: {time.perf_counter() - T0:.0f} s in all",
          file=sys.stderr, flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


def kg_row(row, rows, mask, budget, sample_major, at, card):
    """KG on a recorded call: idx and picked equal to the twin's; its row
    (its bound: the mask read once, 9 B written a budget slot), tagged with
    ``at``; and its reading: the count and scatter passes' device time a
    call beside their events."""
    import torch

    from intrinsicavatar_tpu_torch.ops import compact as C
    ck = C._compact(mask, budget, sample_major)
    cp = C.compact_indices_plain(mask, budget, sample_major)
    torch.cuda.synchronize()
    if not (torch.equal(ck[0], cp[0]) and torch.equal(ck[1], cp[1])):
        fail(f"compact_indices differs from its twin at the {at}")
    flat = mask.T.reshape(-1) if sample_major else mask
    M = mask.numel()
    shape = (f"mask{list(mask.shape)} budget={budget}"
             + (" sample-major" if sample_major else ""))
    call = lambda: C._compact(mask, budget, sample_major)
    row("compact_indices", "cuda", "intrinsicavatar_tpu_torch/csrc/compact.cu",
        "intrinsicavatar_tpu/ops/compact.py:52" if sample_major
        else "intrinsicavatar_tpu/ops/compact.py:43", shape, 0.0,
        time_ms(call),
        time_ms(lambda: C.compact_indices_plain(mask, budget, sample_major)),
        M + budget * 9, M * 4,
        time_ms(lambda: torch.argsort(~flat, stable=True)[:budget]))
    rows[-1]["at"] = at
    r = {"at": at, "shape": shape, "valid": int(ck[1].sum()),
         "ms": rows[-1]["ms"], "bound_ms": rows[-1]["bound_ms"],
         "count_device_ms": device_ms(call, PORT_KERNELS["compact_count"]),
         "scatter_device_ms": device_ms(call,
                                        PORT_KERNELS["compact_scatter"]),
         "before_redesign_ms": EARLIER_MS["compact_indices"], "card": card}
    print(f"kernel compact_indices ({at}): {json.dumps(r)}", flush=True)
    return r


def profile_device(fn):
    """Run ``fn`` under ``torch.profiler``; returns ``(wall ms, {kernel
    name: (device ms, launches)})``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        tf = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - tf) * 1e3
    by_kernel: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            ms, n = by_kernel.get(e.name, (0.0, 0))
            by_kernel[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    return wall_ms, by_kernel


def device_ms(fn, substr, reps=10):
    """The device time a launch of the kernels whose names hold ``substr``
    when ``fn`` runs, from the profiler (``time_ms`` also counts the host's
    launch work where it is longer than the kernel)."""
    import torch
    fn()
    torch.cuda.synchronize()
    _, by_kernel = profile_device(lambda: [fn() for _ in range(reps)])
    hits = [(ms, n) for k, (ms, n) in by_kernel.items() if substr in k]
    n = sum(c for _, c in hits)
    return sum(ms for ms, _ in hits) / n if n else None


def kernel_shares(by_kernel, busy_ms):
    """The device ms, launches and share of the busy time in a profile of
    every kernel of the port (``PORT_KERNELS``), and whether it was
    redesigned for the card."""
    out = {}
    for name, sub in PORT_KERNELS.items():
        hits = [v for k, v in by_kernel.items() if sub in k]
        ms = sum(m for m, _ in hits)
        out[name] = {"device_ms": ms, "launches": sum(c for _, c in hits),
                     "share": ms / busy_ms if busy_ms else 0.0,
                     "redesigned": name in REDESIGNED}
    return out


def ptxas_info(log):
    """``{kernel's mangled name: its registers, stack frame and spill
    bytes}`` from an ``nvcc -Xptxas -v`` log."""
    out, fn = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1]
        elif "Function properties for" in line:
            fn = line.split("Function properties for")[-1].strip()
        elif fn and ("stack frame" in line or "registers" in line):
            out[fn] = (out.get(fn, "") + " " + line.strip()
                       .replace("ptxas info    : ", "")).strip()
    return out


def kb_reading(rec, where, card):
    """KB against its twin on a recorded call, within 1e-4 of max(1, |feat|,
    |grad|), with the model's weights and with noise on every weight;
    timed beside the twin; its bound both ways.  Returns the reading."""
    import torch

    from intrinsicavatar_tpu_torch.ops import encode_grad as EG
    spec_b, mlp, table_b, xn = rec[1][:4]
    mask_b = rec[1][4] if len(rec[1]) > 4 else rec[2].get("level_mask")
    # the sphere init zeroes the first layer's rows of the hash features, so
    # the model's own weights hide the encode from feat and grad: hold KB
    # also with noise on every weight
    noisy = copy.deepcopy(mlp)
    gen = torch.Generator().manual_seed(SEED + 10)
    with torch.no_grad():
        for p in noisy.parameters():
            p.add_(0.3 * torch.randn(p.shape, generator=gen).to(p.device))
    errs = []
    for m in (mlp, noisy):
        fk, gk = EG.encode_mlp_sdfgrad(spec_b, m, table_b, xn, mask_b)
        fp, gp = EG.encode_mlp_sdfgrad_plain(spec_b, m, table_b, xn, mask_b,
                                             m.effective_weights())
        torch.cuda.synchronize()
        err = max((fk - fp).abs().max().item(),
                  (gk - gp).abs().max().item())
        # reassociated sums (cuBLAS vs the kernel's 3xTF32 tensor-core
        # products)
        scale = max(1.0, fp.abs().max().item(), gp.abs().max().item())
        if not err <= 1e-4 * scale:
            fail(f"encode_mlp_sdfgrad disagrees with its twin at "
                 f"{list(xn.shape)} ({where}, "
                 f"{'noisy' if m is noisy else 'model'} weights): {err} "
                 f"> {1e-4 * scale}")
        errs.append((err, 1e-4 * scale))
    (err, tol), (err_noisy, tol_noisy) = errs
    del noisy, fk, gk, fp, gp
    Nb, (Lb, Tb, Fb) = xn.shape[0], table_b.shape
    (W1, _), (W2, _) = mlp.effective_weights()
    d_in, hid = W1.shape
    d_out = W2.shape[1]
    gathered = Nb * Lb * 8 * Fb * 4
    nbytes = (xn.numel() * 4 + min(table_b.numel() * 4, gathered)
              + (W1.numel() + W2.numel()) * 4 + Nb * (d_out + 3) * 4)
    products = Nb * 2 * (2 * d_in * hid + hid * d_out)
    rest = Nb * (Lb * 8 * (2 + 8 * Fb) + 30 * hid)
    call = lambda: EG.encode_mlp_sdfgrad(spec_b, mlp, table_b, xn, mask_b)
    r = {"where": where, "shape": f"x{list(xn.shape)}", "max_abs_err": err,
         "tolerance": tol, "noisy_weights_err": err_noisy,
         "noisy_weights_tolerance": tol_noisy, "ms": time_ms(call),
         "device_ms": device_ms(call, PORT_KERNELS["encode_mlp_sdfgrad"]),
         "plain_ms": time_ms(lambda: EG.encode_mlp_sdfgrad_plain(
             spec_b, mlp, table_b, xn, mask_b, mlp.effective_weights()), 3),
         "bytes": nbytes, "flops": products + rest,
         "bound_fp32_ms": max(nbytes / PEAK_BYTES,
                              (products + rest) / PEAK_FP32) * 1e3,
         "bound_tf32_ms": max(nbytes / PEAK_BYTES, 3 * products / PEAK_TF32
                              + rest / PEAK_FP32) * 1e3,
         "card": card}
    if Nb == 552_960:
        r["before_redesign_ms"] = EARLIER_MS["encode_mlp_sdfgrad"]
    print(f"kernel encode_mlp_sdfgrad ({where}): {json.dumps(r)}",
          flush=True)
    return r


def hash_rows_touched(x, spec, mask=None):
    """How many distinct table rows the corners of points ``x`` read, over
    the levels that ``mask`` leaves on (a level masked off reads nothing
    that reaches the output)."""
    import torch

    from intrinsicavatar_tpu_torch.ops import hashgrid as HG
    L, F, T = spec.n_levels, spec.n_features_per_level, spec.table_size
    on = (torch.ones(L, dtype=torch.bool) if mask is None
          else (mask.reshape(L, F) != 0).any(1).cpu())
    n = 0
    for lvl in range(L):
        if on[lvl]:
            c0, _ = zip(*(HG.level_coords(x[:, a], float(spec.scales[lvl]))
                          for a in range(3)))
            n += int(torch.unique(HG.corner_rows(
                c0, int(spec.resolutions[lvl]), bool(spec.dense_levels[lvl]),
                T)).numel())
    return n


def ka_reading(rec, where, card):
    """KA against its twin on a recorded call, with the model's table and
    with noise of 0.1 on it (the init's entries are below 1e-4), the hash
    features within 1e-6 + 1e-5 of the twin's largest hash feature and the
    xyz columns within 1e-6 + 1e-5 of their largest (the same f32
    operations in the same order); timed with events and on the device
    beside the twin; its bound over the table rows the call reads.
    Returns the reading."""
    import torch

    from intrinsicavatar_tpu_torch.ops import hashgrid as HG
    table, x, spec, mask = rec[1][:4]
    N, (L, T, F) = x.shape[0], table.shape
    off = 3 if spec.include_xyz else 0
    call = lambda: HG.hashgrid_encode(table, x, spec, mask)
    plain = lambda: HG.hashgrid_encode_plain(table, x, spec, mask)
    gen = torch.Generator().manual_seed(SEED + 11)
    noisy = table + 0.1 * torch.randn(table.shape,
                                      generator=gen).to(table.device)
    errs = {}
    with torch.no_grad():
        for which, t in (("model", table), ("noisy", noisy)):
            out_k = HG.hashgrid_encode(t, x, spec, mask)
            out_p = HG.hashgrid_encode_plain(t, x, spec, mask)
            torch.cuda.synchronize()
            for part, cols in (("hash", slice(off, None)),
                               ("xyz", slice(0, off))):
                if cols.start == cols.stop:
                    continue
                k, p = out_k[:, cols], out_p[:, cols]
                err = (k - p).abs().max().item() if N else 0.0
                tol = 1e-6 + 1e-5 * (p.abs().max().item() if N else 0.0)
                if not err <= tol:
                    fail(f"hashgrid_encode disagrees with its twin at {N} "
                         f"points ({where}, {which} table, {part} "
                         f"columns): {err} > {tol}")
                errs[which, part] = (err, tol)
        del noisy, out_k, out_p, k, p
        err, err_noisy = (max(e for (w, _), (e, _) in errs.items()
                              if w == which) for which in ("model", "noisy"))
        # x read once, each table row the corners touch once, the output
        # written once
        rows = hash_rows_touched(x, spec, mask)
        nbytes = x.numel() * 4 + rows * F * 4 + N * (L * F + off) * 4
        flops = N * L * (8 * (2 + 2 * F) + 12)
        r = {"where": where, "shape": f"x{list(x.shape)}",
             "max_abs_err": err, "hash_tolerance": errs["model", "hash"][1],
             "noisy_table_err": err_noisy,
             "noisy_hash_tolerance": errs["noisy", "hash"][1],
             "rows_read": rows,
             "ms": time_ms(call),
             "device_ms": device_ms(call, PORT_KERNELS["hashgrid_encode"]),
             "plain_ms": time_ms(plain, 3), "bytes": nbytes, "flops": flops,
             "bound_ms": max(nbytes / PEAK_BYTES, flops / PEAK_FP32) * 1e3,
             "card": card}
    if N == 1_179_648:
        r["before_redesign_ms"] = EARLIER_MS["hashgrid_encode"]
    print(f"kernel hashgrid_encode ({where}): {json.dumps(r)}", flush=True)
    return r


def prologue_reading(rec, where, card, launches=None):
    """The KH prologue against its twin on a recorded call, slot for slot;
    timed with events and on the device beside the twin; its bound (the
    points read once, the bone tables once, I slots a point written).
    Returns the reading."""
    import torch

    from intrinsicavatar_tpu_torch.anim import broyden as B
    args = rec[1]
    sk = B.deform_prologue(*args)
    sp = B.deform_prologue_plain(*args)
    torch.cuda.synchronize()
    if not torch.equal(sk, sp):
        fail(f"deform_prologue differs from its twin at "
             f"{list(args[0].shape)} ({where})")
    N, n_all, n_init = args[0].shape[0], args[1].shape[0], args[3]
    nbytes = N * 12 + n_all * (64 + 28) + N * n_init * 4
    flops = N * n_all * (45 + n_init)
    call = lambda: B.deform_prologue(*args)
    r = {"where": where, "shape": f"pts{[N, 3]}", "bones": n_all,
         "I": n_init, "ms": time_ms(call),
         "device_ms": device_ms(call, PORT_KERNELS["deform_prologue"]),
         "plain_ms": time_ms(lambda: B.deform_prologue_plain(*args), 3),
         "bytes": nbytes, "flops": flops,
         "bound_ms": max(nbytes / PEAK_BYTES, flops / PEAK_FP32) * 1e3,
         "card": card}
    if launches is not None:
        r["launches_per_step"] = launches
    if N == 786_432:
        r["before_redesign_ms"] = EARLIER_MS["deform_prologue"]
    print(f"kernel deform_prologue ({where}): {json.dumps(r)}", flush=True)
    return r


def epilogue_reading(rec, where, card):
    """The KH epilogue (filter, overflow, first-K; without the blend)
    against its twin on a recorded call, bit for bit on all four outputs;
    timed with events and on the device beside the twin; its bound.
    Returns the reading."""
    import torch

    from intrinsicavatar_tpu_torch.anim import broyden as B
    args = (*rec[1][:3], False, *rec[1][4:])
    ek = B.deform_epilogue(*args)
    ep = B.deform_epilogue_plain(*args)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(ek[:4], ep[:4])):
        fail(f"deform_epilogue differs from its twin at "
             f"{list(args[0].x.shape)} ({where})")
    res, n_init, K = args[:3]
    M = res.x.shape[0]
    N = M // n_init
    # x and valid of every lane; j_inv of the N*K kept lanes; the kept
    # lanes' xc, j_inv and valid written, and the overflow
    nbytes = M * (12 + 1) + N * K * (36 + 12 + 36 + 1) + 8
    flops = N * (n_init * (n_init - 1) // 2 * 10 + n_init * 4)
    call = lambda: B.deform_epilogue(*args)
    r = {"where": where, "shape": f"lanes[{M}] I={n_init} K={K}",
         "overflow": int(ep.overflow), "kept_valid": int(ep.valid.sum()),
         "ms": time_ms(call),
         "device_ms": device_ms(call, PORT_KERNELS["deform_epilogue"]),
         "plain_ms": time_ms(lambda: B.deform_epilogue_plain(*args), 3),
         "bytes": nbytes, "flops": flops,
         "bound_ms": max(nbytes / PEAK_BYTES, flops / PEAK_FP32) * 1e3,
         "card": card}
    if M == 6_291_456:
        r["before_redesign_ms"] = EARLIER_MS["deform_epilogue"]
    print(f"kernel deform_epilogue ({where}): {json.dumps(r)}", flush=True)
    return r


def lane_work(counts):
    """What the iterations ``counts [M]`` of a search's lanes (from the
    twin, whose loop is the kernel's) cost in voxel samples (1 + the
    iterations a lane): the histogram of iterations, and the share of
    issued samples that do work when 32 consecutive lanes share a warp and
    each runs until its slowest lane ends (the kernel's one lane a
    thread)."""
    import torch
    M = counts.numel()
    samples = counts.to(torch.int64) + 1
    total = int(samples.sum())
    warp_max = torch.nn.functional.pad(samples, (0, -M % 32)).reshape(
        -1, 32).max(1).values
    return {
        "lanes": M, "samples": total,
        "iterations_hist": torch.bincount(counts.to(torch.int64))
        .tolist(),
        "warp_efficiency": total / (32 * int(warp_max.sum()))}


def kc_reading(rec, where, card, launches=None):
    """KC against its twin on a recorded call (roots within 1e-4 where both
    converged, at most 1e-3 of lanes flipped: a lane whose |g|^2 sits at
    the threshold may flip with the order of a sum); timed with events and
    on the device beside the twin; the lanes' iterations (``lane_work``);
    its bound over this call's bytes.  Returns the reading."""
    import torch

    from intrinsicavatar_tpu_torch.anim import broyden as B
    args, kw = rec[1], rec[2]
    rk = B.broyden_search(*args, **kw)
    counts = []
    rp = B.broyden_search_plain(*args, **kw, lane_counts=counts)
    torch.cuda.synchronize()
    both = rk.valid & rp.valid
    flip = (rk.valid != rp.valid).float().mean().item()
    err = max((rk.x - rp.x)[both].abs().max().item(),
              (rk.j_inv - rp.j_inv)[both].abs().max().item())
    if not (err <= 1e-4 and flip <= 1e-3):
        fail(f"broyden_search disagrees with its twin at the {where}: "
             f"err={err} flipped={flip}")
    M = args[0].shape[0]
    steps = int(counts[0].sum())
    work = lane_work(counts[0])
    valid = rk.valid.float().mean().item()
    del rk, rp, both, counts
    nbytes = (M * (12 + 4 + 12 + 36 + 1) + args[2].numel() * 4
              + args[3].numel() * 4)
    flops = (M + steps) * (8 * 12 * 2 + 8 * 6 + 40) + steps * 80
    call = lambda: B.broyden_search(*args, **kw)
    r = {"where": where, "shape": f"xd{list(args[0].shape)}",
         "max_abs_err": err, "flipped": flip,
         "valid": valid, "lane_iterations": steps, "work": work,
         "ms": time_ms(call),
         "device_ms": device_ms(call, PORT_KERNELS["broyden_search"]),
         "plain_ms": time_ms(lambda: B.broyden_search_plain(*args, **kw), 2),
         "bytes": nbytes, "flops": flops,
         "bound_ms": max(nbytes / PEAK_BYTES, flops / PEAK_FP32) * 1e3,
         "card": card}
    if launches is not None:
        r["launches_per_step"] = launches
    if M == 6_291_456:
        r["before_redesign_ms"] = EARLIER_MS["broyden_search"]
    print(f"kernel broyden_search ({where}): {json.dumps(r)}", flush=True)
    return r


def kd_reading(rec, where, card, launches=None):
    """KD weights against its twin on a recorded call (within rtol 1e-5,
    atol 1e-6 and 1e-5 absolute: the kernel multiplies in another order
    than torch.cumprod), timed with events and on the device beside the
    twin; its bound, 13 B a sample.  Returns the reading."""
    import torch

    from intrinsicavatar_tpu_torch.ops import volrend as V
    alphas, mask = rec[1][:2]
    wk, tk = V.render_weight_from_alpha(alphas, mask)
    wp, tp = V.render_weight_from_alpha_plain(alphas, mask)
    torch.cuda.synchronize()
    err = max((wk - wp).abs().max().item(), (tk - tp).abs().max().item())
    close = all(torch.allclose(a, b, rtol=1e-5, atol=1e-6)
                for a, b in ((wk, wp), (tk, tp)))
    if not (close and err <= 1e-5):
        fail(f"render_weight_from_alpha disagrees with its twin at the "
             f"{where}: {err}")
    R, S = alphas.shape
    call = lambda: V.render_weight_from_alpha(alphas, mask)
    r = {"where": where, "shape": [R, S], "max_abs_err": err,
         "ms": time_ms(call),
         "device_ms": device_ms(call, PORT_KERNELS["volrend_weights"]),
         "plain_ms": time_ms(lambda: V.render_weight_from_alpha_plain(
             alphas, mask)),
         "bytes": R * S * 13, "flops": R * S * 4,
         "bound_ms": R * S * 13 / PEAK_BYTES * 1e3, "card": card,
         "before_redesign_ms": EARLIER_MS["volrend_weights"]}
    if launches is not None:
        r["launches_per_step"] = launches
    print(f"kernel volrend_weights ({where}): {json.dumps(r)}", flush=True)
    return r


def polish_work(a, steps):
    """Bytes and operations of a polish call on KL's arguments ``a``: every
    lane's target, seed and outputs; a trilinear sample (8 corner rows of
    48 B, at most the voxel once) and ~250 flops at each seeded lane's
    start and at each lane-iteration it runs."""
    M = a[0].shape[0]
    samples = int(a[2].sum()) + steps
    return (M * (12 + 12 + 1) + M * (12 + 36 + 1)
            + min(a[3].numel() * 4, samples * 384),
            samples * (8 * 12 * 2 + 8 * 6 + 40) + samples * 80)


def polish_slots(M):
    """The point each of KL's threads holds (``[blocks * 128]``; beyond M
    where M is not a multiple of 128), as ``csrc/broyden.cu`` lays them: in
    order for calls above ``KL_SPREAD_MAX`` (131,072) points, else thread t
    of block b holds point 4 (b + blocks (t // 4)) + t % 4.  A model of the
    kernel's layout, kept by hand beside it."""
    import torch
    nb = -(-M // 128)
    t = torch.arange(nb * 128)
    if M > 1 << 17:
        return t
    return 4 * (t // 128 + nb * (t % 128 // 4)) + t % 4


def polish_warps(counts, seed_ok):
    """The share of issued samples that do work in KL's warps, where a
    warp runs until its slowest lane ends and an unseeded lane samples
    nothing, modelled from the twin's lane counts: with 32 consecutive
    points a warp (KL's lane-order form) and as ``polish_slots`` models
    KL's layout; and the modelled warps with a seeded lane."""
    import torch
    samples = torch.where(seed_ok, counts.to(torch.int64) + 1, 0).cpu()
    total = int(samples.sum())

    def share(s):
        s = torch.nn.functional.pad(s, (0, -s.numel() % 32)).reshape(-1, 32)
        issued = 32 * int(s.max(1).values.sum())
        return (total / issued if issued else None), int((s > 0).any(1)
                                                         .sum())

    slots = polish_slots(samples.numel())
    laid = torch.where(slots < samples.numel(),
                       samples[slots.clamp(max=samples.numel() - 1)], 0)
    (one, _), (kl, warps) = share(samples), share(laid)
    return {"one_lane": one, "kl_modelled": kl,
            "kl_modelled_warps_seeded": warps}


def kl_reading(rec, where, card, launches=None):
    """KL against its twin on a recorded call (valid equal, x and J^-1
    within 1e-5 of the largest entry), timed with events and on the device
    beside the twin; its lanes, seeded lanes, the seeded lanes'
    iterations and warp efficiency (``polish_warps``); its bound
    (``polish_work``).  Returns the reading."""
    import torch

    from intrinsicavatar_tpu_torch.anim import broyden as B
    args, kw = rec[1], rec[2]
    pk = B.broyden_polish(*args, **kw)
    counts = []
    pp = B.broyden_polish_plain(*args, **kw, lane_counts=counts)
    torch.cuda.synchronize()
    if not torch.equal(pk.valid, pp.valid):
        fail(f"broyden_polish at the {where}: "
             f"{int((pk.valid != pp.valid).sum())} lanes' valid differ")
    errs = [relerr(pk.x, pp.x), relerr(pk.j_inv, pp.j_inv)]
    if not max(errs) <= 1e-5:
        fail(f"broyden_polish disagrees with its twin at the {where}: "
             f"{errs}")
    M = args[0].shape[0]
    ok = args[2]
    steps = int(counts[0].sum())
    nbytes, flops = polish_work(args, steps)
    call = lambda: B.broyden_polish(*args, **kw)
    r = {"where": where, "shape": f"xd[{M}, 3]", "lanes": M,
         "seeded": int(ok.sum()), "max_iters": kw.get("max_iters"),
         "lane_iterations": steps,
         "iterations_hist": torch.bincount(
             counts[0][ok].to(torch.int64)).tolist(),
         "warp_efficiency": polish_warps(counts[0], ok),
         "valid": int(pk.valid.sum()),
         "max_abs_err": max((pk.x - pp.x).abs().max().item(),
                            (pk.j_inv - pp.j_inv).abs().max().item()),
         "ms": time_ms(call),
         "device_ms": device_ms(call, PORT_KERNELS["broyden_polish"]),
         "plain_ms": time_ms(lambda: B.broyden_polish_plain(*args, **kw), 3),
         "bytes": nbytes, "flops": flops,
         "bound_ms": max(nbytes / PEAK_BYTES, flops / PEAK_FP32) * 1e3,
         "card": card, "before_redesign_ms": EARLIER_MS["broyden_polish"]}
    if launches is not None:
        r["launches_per_step"] = launches
    print(f"kernel broyden_polish ({where}): {json.dumps(r)}", flush=True)
    return r


def median_polish_call(calls, where):
    """Of the recorded polish calls ``calls`` (``(args, kwargs)`` a call),
    those of the most frequent size (a fine pass's budget): the one whose
    seeded count is their median, as a ``Recorder`` keeps a call, and
    their mean seeded count."""
    import torch
    M = collections.Counter(a[0].shape[0] for a, _ in calls).most_common(
        1)[0][0]
    same = [c for c in calls if c[0][0].shape[0] == M]
    seeded = torch.stack([a[2].sum() for a, _ in same]).cpu()
    pick = int(torch.argsort(seeded)[len(same) // 2])
    mean = seeded.double().mean().item()
    print(f"broyden_polish at the {where}: {len(same)} calls of {M} points,"
          f" {mean:.1f} seeded a call (median {int(seeded[pick])}, most "
          f"{int(seeded.max())})", flush=True)
    return (M, *same[pick]), mean


def lbs_rows_touched(xc, spec):
    """The voxel rows that KH skinning's trilinear corners read at ``xc``
    (border padding: coordinates clamped into the voxel); the weight voxel
    and the transform voxel share the grid."""
    import torch
    D, H, W = spec.shape_dhw
    c = spec.normalize(xc)
    idx = []
    for a, n in ((0, W), (1, H), (2, D)):
        i = torch.clamp((c[:, a] + 1.0) * 0.5 * (n - 1), 0.0, n - 1.0)
        i0 = torch.floor(i).long()
        idx.append((i0, torch.clamp(i0 + 1, max=n - 1)))
    rows = [(z * H + y) * W + x for x in idx[0] for y in idx[1]
            for z in idx[2]]
    return int(torch.unique(torch.cat(rows)).numel())


def skinning_reading(args, where, card, launches=None):
    """KH skinning against its twin on the call ``args`` (within 1e-5: the
    kernel samples the frame's transform voxel, the twin blends the
    sampled weights in cuBLAS's order), and against the voxel form in
    plain PyTorch; timed with events and on the device beside the twin and
    ``F.grid_sample`` of the transform voxel's 9 rotation channels (the
    same function; their channel-first copy made beforehand); its bound
    over the transform voxel's rows its points touch (48 B a row), and
    over the weight voxel's (96 B a row, and the 24 rotations).  Returns
    the reading."""
    import torch

    from intrinsicavatar_tpu_torch.anim import broyden as B
    xc, lbs_cl, spec, tfs, voxel_J = args
    rk = B.deform_skinning(*args)
    rp = B.deform_skinning_plain(*args[:4])
    rv = B.deform_skinning_voxel_plain(xc, voxel_J, spec)
    torch.cuda.synchronize()
    err = (rk - rp).abs().max().item()
    err_voxel = (rk - rv).abs().max().item()
    if not (err <= 1e-5 and err_voxel <= 1e-5):
        fail(f"deform_skinning disagrees with its twin at the {where}: "
             f"{err} (voxel form {err_voxel})")
    M = xc.shape[0]
    rows = lbs_rows_touched(xc, spec)
    # xc read, each transform voxel row touched read once, rot written
    nbytes = M * 12 + rows * 48 + M * 36
    flops = M * (8 * (2 + 9 * 2) + 20)
    # the weights' form: each weight row touched, the 24 bones' 3 x 3
    nbytes_w = M * 12 + rows * 96 + 24 * 36 + M * 36
    flops_w = M * (8 * (4 + 24 * 2) + 9 * 24 * 2 + 20)
    vox5 = voxel_J[..., list(B.ROT_CHANNELS)].permute(3, 0, 1, 2)[
        None].contiguous()
    grid5 = spec.normalize(xc).reshape(1, M, 1, 1, 3)
    call = lambda: B.deform_skinning(*args)
    r = {"where": where, "shape": f"xc{[M, 3]}", "max_abs_err": err,
         "voxel_form_err": err_voxel, "rows_touched": rows,
         "ms": time_ms(call),
         "device_ms": device_ms(call, PORT_KERNELS["deform_skinning"]),
         "plain_ms": time_ms(lambda: B.deform_skinning_plain(*args[:4]), 3),
         "library_ms": time_ms(lambda: torch.nn.functional.grid_sample(
             vox5, grid5, mode="bilinear", padding_mode="border",
             align_corners=True)),
         "bytes": nbytes, "flops": flops,
         "bound_ms": max(nbytes / PEAK_BYTES, flops / PEAK_FP32) * 1e3,
         "weights_bound_ms": max(nbytes_w / PEAK_BYTES,
                                 flops_w / PEAK_FP32) * 1e3,
         "before_redesign_ms": EARLIER_MS["deform_skinning"], "card": card}
    if launches is not None:
        r["launches_per_step"] = launches
    print(f"kernel deform_skinning ({where}): {json.dumps(r)}", flush=True)
    return r


def kb1_reading(rec, where, card):
    """KB' pass 1 against its twin on a recorded call (each output within
    1e-5 of its largest entry: the corner sums in another order), timed
    with events and on the device beside the twin; its bound over the
    table rows its corners read at the levels the mask leaves on.  Returns
    the reading."""
    import torch

    from intrinsicavatar_tpu_torch.ops import encode_grad as EG
    args = rec[1]
    spec, table, xn, mask, _ = args
    enc_k, gg_k = EG.encode_mlp_sdfgrad_bwd_gather(*args)
    enc_p, gg_p = EG.encode_mlp_sdfgrad_bwd_gather_plain(*args)
    torch.cuda.synchronize()
    rel = max(relerr(enc_k, enc_p), relerr(gg_k, gg_p))
    if not rel <= 1e-5:
        fail(f"encode_mlp_sdfgrad_bwd_gather disagrees with its twin at the "
             f"{where}: {rel}")
    err = max((enc_k - enc_p).abs().max().item(),
              (gg_k - gg_p).abs().max().item())
    N, (L, T, F) = xn.shape[0], table.shape
    D = enc_k.shape[1]
    del enc_k, gg_k, enc_p, gg_p
    rows = hash_rows_touched(xn, spec, mask)
    # x and g_grad read, each table row touched once, enc and gg written
    nbytes = N * 24 + rows * F * 4 + 2 * N * D * 4
    flops = N * L * 8 * (24 + 4 * F)
    call = lambda: EG.encode_mlp_sdfgrad_bwd_gather(*args)
    r = {"where": where, "shape": f"x{list(xn.shape)}", "max_abs_err": err,
         "relerr": rel, "rows_read": rows, "ms": time_ms(call),
         "device_ms": device_ms(
             call, PORT_KERNELS["encode_mlp_sdfgrad_bwd_gather"]),
         "plain_ms": time_ms(
             lambda: EG.encode_mlp_sdfgrad_bwd_gather_plain(*args), 3),
         "bytes": nbytes, "flops": flops,
         "bound_ms": max(nbytes / PEAK_BYTES, flops / PEAK_FP32) * 1e3,
         "before_redesign_ms": EARLIER_MS["encode_mlp_sdfgrad_bwd_gather"],
         "card": card}
    print(f"kernel encode_mlp_sdfgrad_bwd_gather ({where}): "
          f"{json.dumps(r)}", flush=True)
    return r


def relerr(a, b, rtol=0.0):
    """Largest error beyond ``rtol`` of each entry, over the largest
    entry."""
    excess = ((a - b).abs() - rtol * b.abs()).clamp(min=0.0)
    return excess.max().item() / max(b.abs().max().item(), 1e-30)


# float atomics (the kernels' and index_add_'s on the card) sum a dense
# level's row of ~300 terms in changing order: 1e-4 of each entry
ATOMIC_RTOL = 1e-4


def warp_row_hits(x, spec, mask=None, live=None):
    """By level, the share of the (point, corner) adds of KA' or KB' pass 2
    that a warp merges into another lane's: a warp takes 32 consecutive
    points of one level (tiles of 64 start at multiples of 64), and at
    corner k the lanes that add into one row issue one reduction.  A level
    masked off adds nothing (None), nor does a point where ``live [N, L]``
    is False (KA' skips a point whose cotangent is zero at a level)."""
    import torch

    from intrinsicavatar_tpu_torch.ops import hashgrid as HG
    L, F, T = spec.n_levels, spec.n_features_per_level, spec.table_size
    on = (torch.ones(L, dtype=torch.bool) if mask is None
          else (mask.reshape(L, F) != 0).any(1).cpu())
    N = x.shape[0]
    warp = (torch.arange(N, device=x.device) // 32)[:, None] * 8 \
        + torch.arange(8, device=x.device)[None, :]
    out = []
    for lvl in range(L):
        hit = None
        if on[lvl] and N:
            c0, _ = zip(*(HG.level_coords(x[:, a], float(spec.scales[lvl]))
                          for a in range(3)))
            rows = HG.corner_rows(c0, int(spec.resolutions[lvl]),
                                  bool(spec.dense_levels[lvl]), T)
            keys = warp * T + rows.reshape(N, 8).to(torch.int64)
            if live is not None:
                keys = keys[live[:, lvl]]
            hit = (1.0 - torch.unique(keys).numel() / keys.numel()
                   if keys.numel() else None)
        out.append({"level": lvl, "resolution": int(spec.resolutions[lvl]),
                    "dense": bool(spec.dense_levels[lvl]), "hit_rate": hit})
    return out


def scatter_terms(spec, table, xn, level_mask, g_grad, d_enc, g_enc):
    """KB' pass 2's table adds as ``(rows [n] into table.view(-1, F),
    values [n, F])``: every (point, level, corner) of the levels the mask
    leaves on, as the twin computes them."""
    import torch

    from intrinsicavatar_tpu_torch.ops import encode_grad as EG
    N = xn.shape[0]
    L, T, F = table.shape
    off = 3 if spec.include_xyz else 0
    de = (d_enc[:, off:] * level_mask[None, :]).reshape(N, L, F)
    gl = (g_enc[:, off:] * level_mask[None, :]).reshape(N, L, F)
    on = (level_mask.reshape(L, F) != 0).any(1).tolist()
    idx, vals = [], []
    for lvl, s, _, rows, _, w8, dw8 in EG._levels(spec, table, xn):
        if not on[lvl]:
            continue
        u8 = s * sum(g_grad[:, a, None] * dw8[a] for a in range(3))
        vals.append((w8[:, :, None] * de[:, lvl, None, :]
                     + u8[:, :, None] * gl[:, lvl, None, :]).reshape(-1, F))
        idx.append(rows.reshape(-1).to(torch.int64) + lvl * T)
    return torch.cat(idx), torch.cat(vals)


def encode_terms(table, x, spec, g, mask):
    """KA''s table adds as ``(rows [n] into table.view(-1, F), values [n,
    F])``: every (point, level, corner) of the levels the mask leaves on, as
    the twin computes them."""
    import torch

    from intrinsicavatar_tpu_torch.ops import hashgrid as HG
    N = x.shape[0]
    L, T, F = table.shape
    gl = g[:, 3:] if spec.include_xyz else g
    if mask is not None:
        gl = gl * mask[None, :]
    gl = gl.reshape(N, L, F)
    on = ([True] * L if mask is None
          else (mask.reshape(L, F) != 0).any(1).tolist())
    idx, vals = [], []
    for lvl in range(L):
        if not on[lvl]:
            continue
        c0, f = zip(*(HG.level_coords(x[:, a], float(spec.scales[lvl]))
                      for a in range(3)))
        rows = HG.corner_rows(c0, int(spec.resolutions[lvl]),
                              bool(spec.dense_levels[lvl]), T)
        w = HG.corner_weights(f)
        vals.append((w[:, :, None] * gl[:, lvl, None, :]).reshape(-1, F))
        idx.append(rows.reshape(-1).to(torch.int64) + lvl * T)
    return torch.cat(idx), torch.cat(vals)


def ka2_reading(rec, where, card):
    """KA' against its twin on a recorded call (the table cotangent within
    1e-5 of the largest entry beyond ATOMIC_RTOL of each entry), and with
    d_x on the same inputs (within 1e-5 of its largest entry beyond 1e-4 of
    each entry, and two calls bit-equal); timed with events (the wrapper's
    zero-fill of the cotangent included) and on the device beside the twin
    and beside ``index_add_`` of the same adds, precomputed; the warps'
    merge hit rate by level; its bound over the cotangent rows its corners
    touch.  Returns the reading."""
    import torch

    from intrinsicavatar_tpu_torch.ops import hashgrid as HG
    table, x, spec, g, mask, need_x = rec[1]
    args = (table, x, spec, g, mask, need_x)
    dk = HG.hashgrid_encode_bwd(*args)
    dp = HG.hashgrid_encode_bwd_plain(*args)
    torch.cuda.synchronize()
    err = relerr(dk[0], dp[0], ATOMIC_RTOL)
    if not err <= 1e-5:
        fail(f"hashgrid_encode_bwd disagrees with its twin at the {where}: "
             f"{err}")
    abs_err = (dk[0] - dp[0]).abs().max().item()
    del dk, dp
    # d_x, which the path does not ask for here (the radiance points carry
    # no gradient): its own sum, the same on every call
    xargs = (table, x, spec, g, mask, True)
    _, dx1 = HG.hashgrid_encode_bwd(*xargs)
    _, dx2 = HG.hashgrid_encode_bwd(*xargs)
    _, dxp = HG.hashgrid_encode_bwd_plain(*xargs)
    torch.cuda.synchronize()
    dx_err = relerr(dx1, dxp, 1e-4)
    dx_repeat = bool(torch.equal(dx1, dx2))
    if not (dx_err <= 1e-5 and dx_repeat):
        fail(f"hashgrid_encode_bwd's d_x at the {where}: {dx_err} from its "
             f"twin, two calls equal: {dx_repeat}")
    del dx1, dx2, dxp
    N, (L, T, F) = x.shape[0], table.shape
    # the (point, level) items that add: g not zero there (the kernel skips
    # the rest, the compaction's padded slots)
    gl = g[:, 3:] if spec.include_xyz else g
    if mask is not None:
        gl = gl * mask[None, :]
    live = (gl.reshape(N, L, F) != 0).any(-1)
    rows = hash_rows_touched(x, spec, mask)
    # x and g read once; each cotangent row the corners touch read and
    # written once; with d_x each table row they touch read once and d_x
    # written
    nbytes = (x.numel() * 4 + g.numel() * 4 + 2 * rows * F * 4
              + (rows * F * 4 + N * 12 if need_x else 0))
    flops = N * L * (8 * (6 + 2 * F) + 12) + (N * L * 8 * (2 * F + 8)
                                              if need_x else 0)
    call = lambda: HG.hashgrid_encode_bwd(*args)
    idx, vals = encode_terms(table, x, spec, g, mask)
    d_lib = torch.zeros_like(table).view(-1, F)
    lib = lambda: d_lib.index_add_(0, idx, vals)
    r = {"where": where, "shape": f"x{list(x.shape)}", "d_x": bool(need_x),
         "max_abs_err": abs_err, "relerr": err, "d_x_relerr": dx_err,
         "d_x_repeat_equal": dx_repeat, "rows_touched": rows,
         "live_share": live.float().mean().item(),
         "merge_hits": warp_row_hits(x, spec, mask, live),
         "ms": time_ms(call),
         "device_ms": device_ms(call, PORT_KERNELS["hashgrid_encode_bwd"]),
         "plain_ms": time_ms(lambda: HG.hashgrid_encode_bwd_plain(*args), 3),
         "library_ms": time_ms(lib),
         "library_device_ms": device_ms(lib, "index"),
         "bytes": nbytes, "flops": flops,
         "bound_ms": max(nbytes / PEAK_BYTES, flops / PEAK_FP32) * 1e3,
         "card": card}
    del idx, vals, d_lib
    if N == 368_640:
        r["before_redesign_ms"] = EARLIER_MS["hashgrid_encode_bwd"]
    print(f"kernel hashgrid_encode_bwd ({where}): {json.dumps(r)}",
          flush=True)
    return r


def kb2_reading(rec, where, card):
    """KB' pass 2 against its twin on a recorded call (each entry within
    1e-5 of the largest beyond ATOMIC_RTOL of itself); timed with events
    and on the device beside the twin and beside ``index_add_`` of the same
    adds, precomputed (the scatter alone); the warps' merge hit rate by
    level; its bound over the cotangent rows its corners touch.  Returns
    the reading."""
    import torch

    from intrinsicavatar_tpu_torch.ops import encode_grad as EG
    args = rec[1]
    spec, table, xn, mask, g_grad, d_enc, g_enc, need_x = args
    dk = EG.encode_mlp_sdfgrad_bwd_scatter(*args)
    dp = EG.encode_mlp_sdfgrad_bwd_scatter_plain(*args)
    torch.cuda.synchronize()
    pairs = list(zip(dk, dp))[:2 if need_x else 1]
    errs = [relerr(a, b, ATOMIC_RTOL) for a, b in pairs]
    if not max(errs) <= 1e-5:
        fail(f"encode_mlp_sdfgrad_bwd_scatter disagrees with its twin at "
             f"the {where}: {errs}")
    abs_err = max((a - b).abs().max().item() for a, b in pairs)
    del dk, dp, pairs
    N, (L, T, F) = xn.shape[0], table.shape
    D = d_enc.shape[1]
    rows = hash_rows_touched(xn, spec, mask)
    # x, g_grad, d_enc and g_enc read once; each cotangent row the corners
    # touch read and written once; with d_xn each table row they touch
    # read once and d_xn written
    nbytes = (N * 24 + 2 * N * D * 4 + 2 * rows * F * 4
              + (rows * F * 4 + N * 12 if need_x else 0))
    flops = N * L * 8 * (30 + (6 * F + 30 if need_x else 0))
    call = lambda: EG.encode_mlp_sdfgrad_bwd_scatter(*args)
    idx, vals = scatter_terms(spec, table, xn, mask, g_grad, d_enc, g_enc)
    d_lib = torch.zeros_like(table).view(-1, F)
    lib = lambda: d_lib.index_add_(0, idx, vals)
    r = {"where": where, "shape": f"x{list(xn.shape)}", "d_xn": bool(need_x),
         "max_abs_err": abs_err, "relerr": errs, "rows_touched": rows,
         "merge_hits": warp_row_hits(xn, spec, mask),
         "ms": time_ms(call),
         "device_ms": device_ms(call, PORT_KERNELS[
             "encode_mlp_sdfgrad_bwd_scatter"]),
         "plain_ms": time_ms(lambda: EG.encode_mlp_sdfgrad_bwd_scatter_plain(
             *args), 3),
         "library_ms": time_ms(lib),
         "library_device_ms": device_ms(lib, "index"),
         "bytes": nbytes, "flops": flops,
         "bound_ms": max(nbytes / PEAK_BYTES, flops / PEAK_FP32) * 1e3,
         "card": card}
    del idx, vals, d_lib
    if N == 552_960:
        r["before_redesign_ms"] = EARLIER_MS["encode_mlp_sdfgrad_bwd_scatter"]
    print(f"kernel encode_mlp_sdfgrad_bwd_scatter ({where}): "
          f"{json.dumps(r)}", flush=True)
    return r


class MostFrequent:
    """A ``Recorder``'s ``size_of`` that ranks each call by how often its
    size has come so far, so that the recorder keeps a call of the size
    that comes most often (a shader chunk's, where the chunks loop)."""

    def __init__(self, size_of):
        self.size_of = size_of
        self.seen = collections.Counter()

    def __call__(self, args):
        size = self.size_of(args)
        self.seen[size] += 1
        return self.seen[size]


def kb_tiny_widths(dev, card):
    """KB once at the tiny config's widths (8 levels x 2 features, 2^13
    tables, 19 -> 64 -> 13) through the same tiles, against its twin."""
    import torch

    from intrinsicavatar_tpu_torch.nets.mlp import VanillaMLP
    from intrinsicavatar_tpu_torch.ops import encode_grad as EG
    from intrinsicavatar_tpu_torch.ops import hashgrid as HG
    spec = HG.HashGridSpec(n_levels=8, n_features_per_level=2,
                           log2_hashmap_size=13, include_xyz=True)
    rng = np.random.default_rng(SEED + 9)
    table = torch.as_tensor(rng.uniform(-0.1, 0.1, (8, 1 << 13, 2)),
                            dtype=torch.float32, device=dev)
    x = torch.as_tensor(rng.uniform(-0.15, 1.15, (10_007, 3)),
                        dtype=torch.float32, device=dev)
    mask = torch.ones(16, device=dev)
    mlp = VanillaMLP(19, 13, n_neurons=64, n_hidden_layers=1,
                     sphere_init=True, weight_norm=True).to(dev)
    mlp.init(torch.Generator().manual_seed(SEED + 9))
    with torch.no_grad():
        kb_reading(((), (spec, mlp, table, x, mask), {}), "tiny widths", card)


RELIGHT_NAMES = ("cdf_resample", "fine_resample", "secondary_march",
                 "broyden_polish", "seed_gather")


def relight(rows, row, card, dev):
    """Step 6: KI-KM against their twins at the relight path's shapes, one
    relight frame with the launches counted, its profile, a frame by the
    searched path and the card vs CPU-twin crop.  Returns the relight
    line."""
    import torch

    from intrinsicavatar_tpu_torch import kernels
    from intrinsicavatar_tpu_torch.anim import broyden as B
    from intrinsicavatar_tpu_torch.anim import deformer as DF
    from intrinsicavatar_tpu_torch.anim import seedgrid as SG
    from intrinsicavatar_tpu_torch.data.synthetic import SyntheticDataset
    from intrinsicavatar_tpu_torch.fields import geometry as GEO
    from intrinsicavatar_tpu_torch.fields import radiance as RAD
    from intrinsicavatar_tpu_torch.ops import compact as C
    from intrinsicavatar_tpu_torch.ops import grid_traversal as G
    from intrinsicavatar_tpu_torch.ops import resample as RS
    from intrinsicavatar_tpu_torch.ops import volrend as V
    from intrinsicavatar_tpu_torch.render import pbr as PBR
    from intrinsicavatar_tpu_torch.render.renderer import IntrinsicAvatar
    from intrinsicavatar_tpu_torch.train import evaluate as EV
    from intrinsicavatar_tpu_torch.utils.default_config import relight_config

    cfg = relight_config()
    step = int(cfg.trainer.eval_step)
    model = IntrinsicAvatar(cfg.model).to(dev)
    model.init(torch.Generator().manual_seed(SEED))
    ds = SyntheticDataset(cfg.dataset, split="val", mode="val")
    statics = model.initialize(ds.betas)
    flags = EV.eval_flags(cfg.model, step)
    if not (flags.enable_phys and flags.render_mode == "uniform_light"):
        fail(f"step {step} does not render the PBR maps in uniform_light")
    chunk = int(cfg.model.get("ray_chunk", 4096))
    batch_np = ds[0]
    batch = EV.batch_to_device(batch_np, dev)
    occ, frame, cond = EV.build_test_occ_grid(
        model, statics, batch, step,
        generator=torch.Generator().manual_seed(SEED + 3))
    sgrid = EV.build_seed_grid(model, statics, frame, cond, step)
    if sgrid is None or not sgrid.has_sdf:
        fail("relight_config() bakes no seed grid with an SDF channel")

    # ------------------------------------------------ capture one chunk
    # every shader chunk has the same shapes: keep the call with the most
    # work (masked samples, active rays, seeded lanes), not the first one,
    # whose rays may miss the body
    sub = int(cfg.model.get("secondary_shader_chunk", 32768))
    sec_n = -(-int(sub * model.num_samples_per_secondary_ray * float(
        cfg.model.secondary_query_compaction)) // 128) * 128
    # a fine pass's static budget: 4 zero-crossing samples a secondary ray
    # (render/pbr.py), secondary_fine_query_compaction of them
    fine_n = -(-int(sub * 4 * float(cfg.model.get(
        "secondary_fine_query_compaction", 0.5))) // 128) * 128

    kl_calls = []

    def sec_inside(a):
        """Points of a secondary coarse gather inside the lattice."""
        if a[1].shape[0] != sec_n:
            return -1
        return int(((a[1] - a[0].center).abs() <= a[0].half).all(-1).sum())

    recs = [Recorder(RS, "cdf_resample_rays", lambda a: int(a[4].sum())),
            Recorder(RS, "sdf_fine_resample_rays",
                     lambda a: int(a[4].sum())),
            Recorder(PBR, "secondary_march", lambda a: int(a[8].sum())),
            Recorder(DF, "broyden_polish", lambda a: int(a[2].sum())),
            # KM: the largest call (an importance round's edges) and the
            # busiest secondary coarse gather
            Recorder(SG, "gather_from_grid", lambda a: a[1].shape[0]),
            Recorder(SG, "gather_from_grid", sec_inside),
            # KB: a secondary fine pass's fixed budget
            Recorder(GEO, "encode_mlp_sdfgrad",
                     lambda a: 0 if a[3].shape[0] == fine_n else -1),
            # KA: the radiance encode of a shader chunk's fine samples
            Recorder(RAD, "hashgrid_encode",
                     MostFrequent(lambda a: a[1].shape[0])),
            # KG: the largest sample-major call, a secondary coarse pass's
            Recorder(C, "_compact", lambda a: a[0].numel() if a[2] else -1),
            # KD weights: a shader chunk's call, the one that comes most
            # often
            Recorder(V, "render_weight_from_alpha",
                     MostFrequent(lambda a: tuple(a[0].shape))),
            # KL: every call, for a fine pass's (``median_polish_call``)
            Recorder(DF, "broyden_polish", lambda a: 0, calls=kl_calls)]
    with torch.no_grad():
        model(statics, frame, cond, occ, batch["rays"][:chunk], step, flags,
              background_color=torch.ones(3, device=dev),
              generator=torch.Generator().manual_seed(SEED + 4),
              seed_grid=sgrid)
    torch.cuda.synchronize()
    for r in reversed(recs):
        r.restore()
    ki, kj, kk, kl, km_big, km_sec, kb_f, ka_f, kg_sec, kd_sc, _ = (
        r.best for r in recs)
    if km_sec[0] < 0:
        fail(f"no secondary coarse gather of {sec_n} points was recorded")
    if kb_f is None or kb_f[0] < 0:
        fail(f"no secondary fine pass of {fine_n} points was recorded")
    with torch.no_grad():
        kb_fine = kb_reading(kb_f, "relight fine pass", card)
    ka_fine = ka_reading(ka_f, "relight fine pass", card)
    kd_chunk = kd_reading(kd_sc, "relight shader chunk", card)

    def rel(a, b):
        """Largest error over the reference's largest entry."""
        return (a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)

    def equal(name, a, b):
        if not torch.equal(a, b):
            fail(f"{name}: {int((a != b).sum())} entries differ from the "
                 f"twin")

    def close_where(name, a, b, where):
        """Fail unless ``a`` is within 1e-5 of ``max(|b|, 1)`` of ``b`` at
        every entry of ``where``; returns the largest error there."""
        d, ref = (a - b).abs()[where], b.abs()[where]
        if not bool((d <= 1e-5 * ref.clamp(min=1.0)).all()):
            fail(f"{name} disagrees with its twin: "
                 f"{int((d > 1e-5 * ref.clamp(min=1.0)).sum())} entries, "
                 f"max error {d.max().item()}")
        return d.max().item() if d.numel() else 0.0

    # KI scattering points (the chunk's [4096, S] -> spp draws)
    args = ki[1]
    ok_, op_ = RS.cdf_resample_rays(*args), RS.cdf_resample_rays_plain(*args)
    torch.cuda.synchronize()
    for name in ("indices", "is_bg", "fg_counts", "bg_count", "surface_idx"):
        equal(f"cdf_resample {name}", getattr(ok_, name), getattr(op_, name))
    # the background draws carry t_end + BG_OFFSET: equal, and the
    # foreground draws entry by entry, so the offset cannot hide an error
    fg = ~op_.is_bg
    equal("cdf_resample background ts", ok_.ts[~fg], op_.ts[~fg])
    equal("cdf_resample background offsets", ok_.offsets[~fg],
          op_.offsets[~fg])
    ki_err = max(close_where("cdf_resample ts", ok_.ts, op_.ts, fg),
                 close_where("cdf_resample offsets", ok_.offsets,
                             op_.offsets, fg))
    R, S = args[0].shape
    Bs = args[5]
    row("cdf_resample", "cuda", "intrinsicavatar_tpu_torch/csrc/resample.cu",
        "intrinsicavatar_tpu/ops/resample.py:62", f"[{R}, {S}] B={Bs}",
        ki_err,
        time_ms(lambda: RS.cdf_resample_rays(*args)),
        time_ms(lambda: RS.cdf_resample_rays_plain(*args), 3),
        R * S * (4 * 4 + 1) + R * Bs * (4 + 4 + 4 + 1) + R * S * 4 + R * 8,
        R * (S * 12 + Bs * (2 * int(np.log2(S)) + 40)))

    # KJ fine resampling (a shader chunk's [32768, 64] -> 4 intervals)
    args = kj[1]
    fk = RS.sdf_fine_resample_rays(*args)
    fp = RS.sdf_fine_resample_rays_plain(*args)
    torch.cuda.synchronize()
    equal("fine_resample mask", fk.mask, fp.mask)
    # only placed intervals are read; a ray that places nothing divides by
    # the 1e-20 floor and its unread draws can be huge
    kj_err = max(close_where("fine_resample t_starts", fk.t_starts,
                             fp.t_starts, fp.mask),
                 close_where("fine_resample t_ends", fk.t_ends, fp.t_ends,
                             fp.mask))
    M, S2 = args[0].shape
    n_f = args[5]
    kj_placed = int(fp.mask.sum())
    kj_call = lambda: RS.sdf_fine_resample_rays(*args)
    # its bytes: alphas, sdf and mask at every slot, t_starts and t_ends at
    # the n + 1 drawn slots, the outputs
    row("fine_resample", "cuda", "intrinsicavatar_tpu_torch/csrc/resample.cu",
        "intrinsicavatar_tpu/ops/resample.py:282", f"[{M}, {S2}] n={n_f}",
        kj_err, time_ms(kj_call),
        time_ms(lambda: RS.sdf_fine_resample_rays_plain(*args), 3),
        M * S2 * (4 + 4 + 1) + M * (n_f + 1) * 8 + M * n_f * (4 + 4 + 1),
        M * (S2 * 15 + (n_f + 1) * 20))
    # plain mode (no zero-crossing search) on the same rows, with the
    # weights of their alphas
    ts_, te_, al_, _, sm_ = args[:5]
    w_, _ = V.render_weight_from_alpha(al_, sm_)
    plain_args = (ts_, te_, w_, sm_, n_f)
    fk = RS.fine_resample_rays(*plain_args)
    fp = RS.fine_resample_rays_plain(*plain_args)
    torch.cuda.synchronize()
    equal("fine_resample mask, plain mode", fk.mask, fp.mask)
    kj_plain_err = max(
        close_where("fine_resample t_starts, plain mode", fk.t_starts,
                    fp.t_starts, fp.mask),
        close_where("fine_resample t_ends, plain mode", fk.t_ends,
                    fp.t_ends, fp.mask))
    kj_plain_call = lambda: RS.fine_resample_rays(*plain_args)
    kj_read = {
        "shape": f"[{M}, {S2}] n={n_f}",
        "sdf": {"ms": rows[-1]["ms"], "max_abs_err": kj_err,
                "placed": kj_placed,
                "device_ms": device_ms(kj_call,
                                       PORT_KERNELS["fine_resample"])},
        "plain": {"ms": time_ms(kj_plain_call), "max_abs_err": kj_plain_err,
                  "placed": int(fp.mask.sum()),
                  "device_ms": device_ms(kj_plain_call,
                                         PORT_KERNELS["fine_resample"]),
                  "plain_ms": time_ms(lambda: RS.fine_resample_rays_plain(
                      *plain_args), 3)},
        "bound_ms": rows[-1]["bound_ms"],
        "before_redesign_ms": EARLIER_MS["fine_resample"], "card": card}
    print(f"kernel fine_resample (shader chunk, both modes): "
          f"{json.dumps(kj_read)}", flush=True)

    # KG at the secondary coarse call (sample-major)
    if kg_sec is None or kg_sec[0] < 0:
        fail("no sample-major compaction was recorded in the relight chunk")
    kg_sec_read = kg_row(row, rows, *kg_sec[1], "secondary coarse call",
                         card)
    kg_sec_row = rows[-1]

    # KK secondary march (a shader chunk)
    args = kk[1]
    mk = G.secondary_march(*args)
    mp = G.secondary_march_plain(*args)
    torch.cuda.synchronize()
    equal("secondary_march mask", mk[2], mp[2])
    errs = [rel(mk[0], mp[0]), rel(mk[1], mp[1])]
    if not max(errs) <= 1e-5:
        fail(f"secondary_march disagrees with its twin: {errs}")
    M, S2 = mk[2].shape
    res = args[2].shape[0]
    print(f"secondary march: {int(mk[2].sum())} of {M * S2} samples "
          f"masked (cap {args[9]})", flush=True)
    kk_call = lambda: G.secondary_march(*args)
    row("secondary_march", "cuda", "intrinsicavatar_tpu_torch/csrc/march.cu",
        "intrinsicavatar_tpu/render/pbr.py:197", f"rays[{M}, 3] S={S2}",
        max((mk[0] - mp[0]).abs().max().item(),
            (mk[1] - mp[1]).abs().max().item()),
        time_ms(kk_call),
        time_ms(lambda: G.secondary_march_plain(*args), 3),
        M * (12 + 12 + 4 + 4 + 1) + res ** 3 + 24 + M * S2 * (4 + 4 + 1),
        M * (S2 + 1) * 30 + M * 40)
    kk_read = {"at": "shader chunk", "shape": f"rays[{M}, 3] S={S2}",
               "cap": args[9], "masked": int(mk[2].sum()),
               "ms": rows[-1]["ms"], "bound_ms": rows[-1]["bound_ms"],
               "device_ms": device_ms(kk_call,
                                      PORT_KERNELS["secondary_march"]),
               "before_redesign_ms": EARLIER_MS["secondary_march"],
               "card": card}
    print(f"kernel secondary_march (shader chunk): {json.dumps(kk_read)}",
          flush=True)

    # KL seeded polish: the call that seeds the most points (the
    # grid-seeded shading pass) and a shader chunk's fine pass
    args, kw = kl[1], kl[2]
    kl_shade = kl_reading(kl, "grid-seeded shading pass", card)
    M = args[0].shape[0]
    row("broyden_polish", "cuda", "intrinsicavatar_tpu_torch/csrc/broyden.cu",
        "intrinsicavatar_tpu/anim/broyden.py:464", kl_shade["shape"],
        kl_shade["max_abs_err"], kl_shade["ms"], kl_shade["plain_ms"],
        kl_shade["bytes"], kl_shade["flops"])
    kl_f, seeded_mean = median_polish_call(kl_calls, "relight fine pass")
    kl_fine = kl_reading(kl_f, "relight fine pass", card)
    kl_fine["seeded_per_call"] = seeded_mean
    # the same points with every lane seeded, from the roots of a search
    # from the first init bone (the relight cell's fine pass seeds few
    # lanes: its secondary rays leave the body)
    xd, vox, off, sk = args[0], args[3], args[4], args[5]
    roots = B.broyden_search(
        xd, torch.zeros(M, dtype=torch.int32, device=dev), vox,
        frame.tfs[torch.as_tensor(B.INIT_BONES, device=dev)].contiguous(),
        off, sk)
    full = (xd, roots.x, roots.valid, vox, off, sk)
    kl_full = kl_reading((0, full, kw), "grid-seeded shading pass's "
                         "points seeded from a search", card)
    check_seed_gather(row, km_big, km_sec, dev)
    del ok_, op_, fk, fp, mk, mp, recs, ki, kj, kk, kl, roots, kg_sec, full
    del kl_calls, kl_f

    # ------------------------------------------------ one relight frame
    trips = [Tripwire(RS, "cdf_resample_rays_plain"),
             Tripwire(RS, "sdf_fine_resample_rays_plain"),
             Tripwire(RS, "fine_resample_rays_plain"),
             Tripwire(G, "secondary_march_plain"),
             Tripwire(B, "broyden_polish_plain"),
             Tripwire(SG, "gather_from_grid_plain"),
             Tripwire(V, "render_weight_from_alpha_plain")]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    out = EV.render_frame(model, statics, batch, step, flags, ray_chunk=chunk,
                          occ=occ, frame=frame, cond=cond,
                          generator=torch.Generator().manual_seed(SEED + 5))
    torch.cuda.synchronize()
    frame_s = time.perf_counter() - t0
    launches = dict(kernels.launches)
    peak = torch.cuda.max_memory_allocated()
    for t in trips:
        t.restore()
    if any(t.calls for t in trips):
        fail(f"plain twins ran on the card in the relight frame: "
             f"{[(t.name, t.calls) for t in trips if t.calls]}")
    for r in rows:
        if r["name"] in RELIGHT_NAMES:
            r["launches"] = int(launches.get(r["name"], 0))
    kg_sec_row["launches"] = int(launches.get("compact_indices", 0))
    forward = {"hashgrid_encode", "encode_mlp_sdfgrad", "broyden_search",
               "volrend_weights", "volrend_composite", "occupancy_march",
               "merge_resample", "compact_indices", "deform_prologue",
               "deform_epilogue", "deform_skinning"}
    missing = [n for n in sorted(forward | set(RELIGHT_NAMES))
               if not launches.get(n)]
    if missing:
        fail(f"kernels not launched in the relight frame: {missing}")
    # KM per ray chunk: the importance rounds, the shading pass's seeds and
    # one coarse gather per shader chunk (the fine pass seeds from it)
    n_chunks = -(-batch["rays"].shape[0] // chunk)
    n_km = n_chunks * (model.n_importance_rounds + 1
                       + -(-chunk * model.samples_per_pixel // sub))
    n_seed = launches.get("seed_gather", 0)
    if n_seed != n_km:
        fail(f"seed_gather launched {n_seed} times in the relight frame, "
             f"expected {n_km}")
    n_rays = batch["rays"].shape[0]
    for k in EV.KEEP + EV.KEEP_PHYS:
        if not np.all(np.isfinite(out[k])):
            fail(f"relight frame: {k} is not finite")
    if out["comp_rgb_phys_full"].shape != (n_rays, 3):
        fail(f"relight frame: comp_rgb_phys_full has shape "
             f"{out['comp_rgb_phys_full'].shape}")
    hit = float((out["opacity"] > 0.5).mean())
    if hit <= 0.0 or np.ptp(out["comp_rgb_phys_full"]) <= 0.0:
        fail("relight frame: no surface or a constant PBR map")
    if not out["counters"].get("sec_valid_samples"):
        fail("relight frame: no secondary sample was marched")
    m = EV.frame_metrics(out, batch_np)
    counters = {k: v for k, v in out["counters"].items()
                if k.startswith(("ovf_", "sec_"))}
    print(f"relight frame: {n_rays} rays in {frame_s:.2f} s "
          f"({n_rays / frame_s:.1f} rays/s), peak "
          f"{peak / 2 ** 30:.2f} GiB, psnr {m['psnr']:.3f}, psnr_phys "
          f"{m['psnr_phys']:.3f}, counters {json.dumps(counters)}",
          flush=True)
    print(f"relight launches: {json.dumps(launches)}", flush=True)

    # where a chunk's device time goes
    wall_ms, by_kernel = profile_device(lambda: EV.render_frame(
        model, statics, {**batch, "rays": batch["rays"][:chunk]}, step,
        flags, ray_chunk=chunk, occ=occ, frame=frame, cond=cond,
        generator=torch.Generator().manual_seed(SEED + 6), seed_grid=sgrid))
    busy_ms = sum(ms for ms, _ in by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:15]
    profile_line = {
        "chunk_rays": chunk, "chunk_wall_ms": wall_ms,
        "device_busy_ms": busy_ms,
        "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
        "device_launches": sum(n for _, n in by_kernel.values()),
        "port_kernels": kernel_shares(by_kernel, busy_ms),
        "top": [[k[:70], ms, n] for k, (ms, n) in top]}
    print(json.dumps({"relight_profile": profile_line}), flush=True)

    # the searched eval path, for comparison: the same frame from the same
    # test grid and draws, its PSNR and its per-ray agreement with the grid
    # path's render
    searched, out_s = searched_frame(
        model, statics, batch, step, flags, chunk,
        torch.Generator().manual_seed(SEED + 5), keys=EV.KEEP + EV.KEEP_PHYS,
        profile_batch={**batch, "rays": batch["rays"][:chunk]}, occ=occ,
        frame=frame, cond=cond)
    m_s = EV.frame_metrics(out_s, batch_np)
    searched["psnr"], searched["psnr_phys"] = m_s["psnr"], m_s["psnr_phys"]
    searched["grid_vs_searched"] = agreement(
        out, out_s, EV.KEEP[:3] + EV.KEEP_PHYS[:3], "comp_rgb_phys_full")
    print(f"relight frame, grid vs searched: "
          f"{json.dumps({k: searched[k] for k in ('psnr', 'psnr_phys', 'grid_vs_searched')})}",
          flush=True)
    del out_s
    searched["in_turn"] = alternate(model, statics, [batch], step, flags,
                                    chunk, [SEED + 5], 2, occ=occ,
                                    frame=frame, cond=cond)

    # ------------------------------------------------ card vs CPU twins
    n_crop = 32
    B_ = model.samples_per_pixel
    g = torch.Generator().manual_seed(SEED + 7)
    n1 = max(B_ // 32, 1)
    draws = [{"sphere_u": torch.rand((2, n1, B_ // n1), generator=g),
              "strata_u": torch.rand((n_crop, B_), generator=g)}]
    crop = {**batch, "rays": batch["rays"][:n_crop]}
    gpu = EV.render_frame(model, statics, crop, step, flags,
                          ray_chunk=n_crop, occ=occ, frame=frame, cond=cond,
                          draws=draws, seed_grid=sgrid)
    to_cpu = lambda t: type(t)(*(v.cpu() for v in t))
    model_cpu = copy.deepcopy(model).cpu()
    tc = time.perf_counter()
    cpu = EV.render_frame(
        model_cpu, to_cpu(statics), {k: v.cpu() for k, v in crop.items()},
        step, flags, ray_chunk=n_crop, occ=to_cpu(occ), frame=to_cpu(frame),
        cond=cond.cpu(), draws=draws, seed_grid=sgrid.to("cpu"))
    cpu_s = time.perf_counter() - tc
    phys = ("comp_rgb_phys_full", "comp_demod_phys_full", "visibility",
            "comp_albedo_full", "comp_roughness_full", "comp_metallic_full")
    agree = {k: float((np.abs(gpu[k] - cpu[k]).max(-1) < 1e-3).mean())
             for k in phys}
    print(f"card vs plain-twin relight of {n_crop} rays (CPU {cpu_s:.1f} s):"
          f" share of rays within 1e-3 {json.dumps(agree)}; counters card "
          f"{json.dumps(gpu['counters'])} cpu {json.dumps(cpu['counters'])}",
          flush=True)
    if min(agree.values()) < 0.99:
        fail(f"the card's relight disagrees with the plain twins: {agree}")
    return {"rays": n_rays, "frame_s": frame_s, "rays_per_s": n_rays / frame_s,
            "peak_mem_bytes": peak, "card": card, "psnr": m["psnr"],
            "psnr_phys": m["psnr_phys"], "counters": counters,
            "launches": launches,
            "profile": {k: profile_line[k] for k in (
                "chunk_wall_ms", "device_busy_ms", "device_idle_share",
                "device_launches", "port_kernels")},
            "kj_shader_chunk": kj_read,
            "kg_secondary_coarse_call": kg_sec_read,
            "kb_fine_pass": kb_fine,
            "ka_fine_pass": ka_fine,
            "kd_shader_chunk": kd_chunk,
            "kl_shading_pass": kl_shade,
            "kl_fine_pass": kl_fine,
            "kl_seeded_from_a_search": kl_full,
            "searched": searched,
            "cpu_check": {"rays": n_crop, "agree_1e-3": agree}}


def bake_alone(model, statics, frame, cond, step):
    """One frame's seed grid baked alone, after a warm-up bake: its wall
    time, its launches and its valid share.  Returns the bake line."""
    import torch

    from intrinsicavatar_tpu_torch import kernels
    model.bake_seed_grid(statics, frame, cond, step)
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    grid = model.bake_seed_grid(statics, frame, cond, step)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    g = grid.grid.reshape(-1, grid.channels)
    line = {"resolution": grid.resolution, "nodes": g.shape[0],
            "channels": grid.channels, "wall_ms": ms,
            "launches": dict(kernels.launches),
            "valid_share": float((g[:, 3] > 0.5).float().mean()),
            "sdf_valid_share": float((g[:, 5] > 0.5).float().mean())}
    print(f"bake: {json.dumps(line)}", flush=True)
    if not 0.0 < line["sdf_valid_share"] <= line["valid_share"] < 1.0:
        fail(f"the bake's valid shares are implausible: {line}")
    return line


def bake_card_vs_cpu(model, model_cpu, statics, frame, cond, step, res=32):
    """A ``res``^3 seed grid baked on the card and on the CPU twins (one
    chunk of the whole lattice on both): node validity equal on >= 99.9% of
    nodes (a lane at a convergence threshold may flip, as KC's rule
    allows); the roots, and the SDF, within 1e-4 at every node valid on
    both."""
    import torch
    to_cpu = lambda t: type(t)(*(v.cpu() for v in t))
    g = model.bake_seed_grid(statics, frame, cond, step, resolution=res,
                             chunk=res ** 3)
    c = model_cpu.bake_seed_grid(to_cpu(statics), to_cpu(frame), cond.cpu(),
                                 step, resolution=res, chunk=res ** 3)
    a = g.grid.reshape(-1, g.channels).cpu()
    b = c.grid.reshape(-1, c.channels)
    line = {"resolution": res}
    bad = False
    for name, okc, cols in (("roots", 3, slice(0, 3)), ("sdf", 5,
                                                         slice(4, 5))):
        ok_a, ok_b = a[:, okc] > 0.5, b[:, okc] > 0.5
        both = ok_a & ok_b
        d = (a[both][:, cols] - b[both][:, cols]).abs().amax(-1)
        line[f"{name}_valid_agree"] = float((ok_a == ok_b).float().mean())
        line[f"{name}_both_valid"] = int(both.sum())
        line[f"{name}_apart_1e-4"] = int((d > 1e-4).sum())
        line[f"{name}_max_err"] = float(d.max())
        bad |= not (line[f"{name}_valid_agree"] >= 0.999
                    and line[f"{name}_apart_1e-4"] == 0)
    print(f"card vs plain-twin bake: {json.dumps(line)}", flush=True)
    if bad:
        fail(f"the card's bake disagrees with the CPU twins': {line}")
    return line


def searched_frame(model, statics, batch, step, flags, chunk, generator,
                   keys=None, profile_batch=None, **kw):
    """One frame by the searched eval path (``eval_seed_grid: false``), the
    launches counted and the peak memory read: its rays/s beside the grid
    path's; with ``profile_batch``, that batch rendered again the same way
    under the profiler (its idle share).  The seed grid's gather must not
    run there.  Returns its line and its render."""
    import torch

    from intrinsicavatar_tpu_torch import kernels
    from intrinsicavatar_tpu_torch.train import evaluate as EV
    model.config.eval_seed_grid = False
    prof = None
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        t0 = time.perf_counter()
        out = EV.render_frame(model, statics, batch, step, flags,
                              ray_chunk=chunk, generator=generator, **kw)
        torch.cuda.synchronize()
        frame_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        launches = dict(kernels.launches)
        if profile_batch is not None:
            wall_ms, by_kernel = profile_device(lambda: EV.render_frame(
                model, statics, profile_batch, step, flags, ray_chunk=chunk,
                generator=torch.Generator().manual_seed(
                    generator.initial_seed()), **kw))
            busy_ms = sum(ms for ms, _ in by_kernel.values())
            prof = {"rays": profile_batch["rays"].shape[0],
                    "wall_ms": wall_ms, "device_busy_ms": busy_ms,
                    "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
                    "device_launches": sum(n for _, n in by_kernel.values())}
    finally:
        model.config.eval_seed_grid = True
    if launches.get("seed_gather"):
        fail("the searched path launched the seed grid's gather")
    for k in keys or EV.KEEP:
        if not np.all(np.isfinite(out[k])):
            fail(f"searched frame: {k} is not finite")
    n = batch["rays"].shape[0]
    line = {"rays": n, "frame_s": frame_s, "rays_per_s": n / frame_s,
            "peak_mem_bytes": peak, "profile": prof,
            "kernel_launches": sum(launches.values()),
            "counters": {k: v for k, v in out["counters"].items()
                         if k.startswith(("ovf_", "sec_"))}}
    print(f"searched frame: {json.dumps(line)}", flush=True)
    return line, out


def alternate(model, statics, batches, step, flags, chunk, seeds, reps,
              **kw):
    """Each frame rendered by the grid path and by the searched path in
    turn (grid, searched, grid, ...), ``reps`` times, so that the host's
    drift over the run favours neither.  Returns each path's frame seconds
    and its rays/s at the median frame."""
    import torch

    from intrinsicavatar_tpu_torch.train import evaluate as EV
    times = {"grid": [], "searched": []}
    for _ in range(reps):
        for b, seed in zip(batches, seeds):
            for path in times:
                model.config.eval_seed_grid = path == "grid"
                try:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    EV.render_frame(model, statics, b, step, flags,
                                    ray_chunk=chunk,
                                    generator=torch.Generator().manual_seed(
                                        seed), **kw)
                    torch.cuda.synchronize()
                    times[path].append(time.perf_counter() - t0)
                finally:
                    model.config.eval_seed_grid = True
    n = batches[0]["rays"].shape[0]
    line = {}
    for path, t in times.items():
        line[f"{path}_frame_s"] = t
        line[f"{path}_rays_per_s"] = n / float(np.median(t))
    print(f"grid and searched frames in turn: {json.dumps(line)}",
          flush=True)
    return line


def agreement(grid_out, searched_out, keys, rgb_key):
    """Per-ray agreement of the grid path's render of a frame with the
    searched path's render of the same frame: for each map the share of
    rays within 1e-3 and within 1e-2 on every channel and the largest
    difference, and the PSNR of ``rgb_key``'s grid render against the
    searched one."""
    line = {}
    for k in keys:
        a = np.asarray(grid_out[k], np.float64).reshape(len(grid_out[k]), -1)
        b = np.asarray(searched_out[k], np.float64).reshape(a.shape)
        d = np.abs(a - b).max(-1)
        line[k] = {"within_1e-3": float((d < 1e-3).mean()),
                   "within_1e-2": float((d < 1e-2).mean()),
                   "max": float(d.max())}
    mse = float(np.mean((np.asarray(grid_out[rgb_key], np.float64)
                         - np.asarray(searched_out[rgb_key], np.float64))
                        ** 2))
    line["psnr_vs_searched"] = -10.0 * np.log10(mse) if mse > 0 else None
    return line


def polish_losses(model, statics, batch, step, flags, chunk, generator):
    """Renders a frame by the grid path with every grid-seeded polish call
    (the shading pass's) also canonicalized by the search, and counts the
    lanes: seeded by the grid, failed in the polish, and of those the ones
    the search finds a root for (lost) or none (no root either way); the
    unseeded lanes the search finds a root for; and of the lanes valid on
    both paths, those whose canonical point or SDF differ by more than 1e-3
    (the search keeps the least-SDF of its candidate roots, the polish the
    root its seed leads to).  Returns the counts."""
    import torch

    from intrinsicavatar_tpu_torch.train import evaluate as EV
    rigid = model.deformer.rigid
    seeded_fn = rigid.deform_seeded
    counts = dict.fromkeys(("lanes", "seeded", "polish_valid", "polish_fail",
                            "fail_search_valid", "fail_search_invalid",
                            "unseeded_search_valid", "both_valid",
                            "root_apart_1e-3", "sdf_apart_1e-3"), 0)

    def deform_seeded(statics_, frame_, pts, seed_xc, seed_ok, geometry_fn,
                      *a, with_jac=True, **kw):
        out = seeded_fn(statics_, frame_, pts, seed_xc, seed_ok, geometry_fn,
                        *a, with_jac=with_jac, **kw)
        srch = rigid.deform(statics_, frame_, pts, geometry_fn,
                            with_jac=with_jac)
        pv, sv = out[2], srch[2]
        fail_ = seed_ok & ~pv
        both = pv & sv
        for k, m in (("lanes", torch.ones_like(pv)), ("seeded", seed_ok),
                     ("polish_valid", pv), ("polish_fail", fail_),
                     ("fail_search_valid", fail_ & sv),
                     ("fail_search_invalid", fail_ & ~sv),
                     ("unseeded_search_valid", ~seed_ok & sv),
                     ("both_valid", both),
                     ("root_apart_1e-3",
                      both & ((out[0] - srch[0]).abs().amax(-1) > 1e-3)),
                     ("sdf_apart_1e-3",
                      both & ((out[1] - srch[1]).abs() > 1e-3))):
            counts[k] += int(m.sum())
        return out

    rigid.deform_seeded = deform_seeded
    try:
        EV.render_frame(model, statics, batch, step, flags, ray_chunk=chunk,
                        generator=generator)
    finally:
        del rigid.deform_seeded
    return counts


def hand_seed_grid(dev, res=9):
    """A small seed grid built by hand: two root branches (incoherent cells
    along their seam), scattered invalid and SDF-invalid nodes, over a box
    whose nodes and cell centres (all weights tied) are query points, with
    points beyond the lattice's half-cell slack."""
    import torch

    from intrinsicavatar_tpu_torch.anim import seedgrid as SG
    rng = np.random.default_rng(SEED + 8)
    # over [-1, 1]^3 with 2^k cells a side, nodes and cell centres map to
    # lattice coordinates exactly, so the centres' 8 weights tie exactly
    aabb = torch.tensor([[-1.0] * 3, [1.0] * 3], device=dev)
    nodes = SG.lattice_points(aabb, res)
    N = res ** 3
    xc = 0.5 * nodes.cpu().numpy() + 0.01 * rng.normal(size=(N, 3))
    xc[:, 0] += np.where(nodes[:, 0].cpu().numpy() > 0.0, 0.4, -0.4)
    ok = rng.random(N) < 0.7
    sdf = rng.normal(size=N)
    sok = ok & (rng.random(N) < 0.7)
    t = lambda a, dt=torch.float32: torch.as_tensor(a, dtype=dt, device=dev)
    ch = [t(xc[:, 0] * ok), t(xc[:, 1] * ok), t(xc[:, 2] * ok), t(ok),
          t(sdf * sok), t(sok)]
    lo, hi = aabb[0], aabb[1]
    grid = SG.SeedGrid(grid=SG.node_records(
        torch.stack(ch, -1).reshape(res, res, res, 6)), center=0.5 * (lo + hi),
                       half=0.5 * (hi - lo))
    cell = (hi - lo) / (res - 1)
    centres = SG.lattice_points(torch.stack([lo + 0.5 * cell,
                                             hi - 0.5 * cell]), res - 1)
    span = (hi - lo).cpu().numpy()
    pts = torch.cat([nodes, centres, t(rng.uniform(
        lo.cpu().numpy() - 0.3 * span, hi.cpu().numpy() + 0.3 * span,
        (20000, 3)))]).contiguous()
    return grid, pts


def check_seed_gather(row, km_big, km_sec, dev):
    """KM against its twin: at the largest call of a relight chunk (an
    importance round), at its busiest secondary coarse gather (timed: the
    kernel row) and on a hand-built grid, at two coherence factors.
    ``seed_ok`` and the background 1e5 equal; the coherent / nearest choice
    (a wrong one moves a seed by a cell's roots) and every float within
    1e-5 of max(|ref|, 1), entry by entry."""
    import torch

    from intrinsicavatar_tpu_torch.anim import seedgrid as SG

    def compare(name, grid, pts, coh):
        ok_, op_ = (f(grid, pts, coh) for f in (SG.gather_from_grid,
                                                  SG.gather_from_grid_plain))
        torch.cuda.synchronize()
        if not torch.equal(ok_[1], op_[1]):
            fail(f"seed_gather {name}: seed_ok differs from the twin at "
                 f"{int((ok_[1] != op_[1]).sum())} points")
        if not torch.equal(ok_[2] == 1e5, op_[2] == 1e5):
            fail(f"seed_gather {name}: the background sdf differs")
        err = 0.0
        for a, b in ((ok_[0], op_[0]), (ok_[2], op_[2])):
            d = (a - b).abs()
            bad = d > 1e-5 * b.abs().clamp(min=1.0)
            if bool(bad.any()):
                fail(f"seed_gather {name}: {int(bad.sum())} entries differ "
                     f"from the twin, max {d.max().item()}")
            err = max(err, d.max().item())
        print(f"seed_gather {name} (coh {coh}): {pts.shape[0]} points, "
              f"{int(op_[1].sum())} seeded, max_abs_err={err:.3g}",
              flush=True)
        return err

    errs = []
    def call(rec):
        """``(grid, pts, coh_factor)`` of a recorded call."""
        args, kw = rec[1], rec[2]
        return (*args[:2], args[2] if len(args) > 2
                else kw.get("coh_factor", 3.0))

    for name, rec in (("importance call", km_big),
                      ("secondary coarse call", km_sec)):
        errs.append(compare(name, *call(rec)))
    hgrid, hpts = hand_seed_grid(dev)
    for coh in (3.0, 0.1):
        errs.append(compare("hand-built grid", hgrid, hpts, coh))
    grid, pts, coh = call(km_sec)
    N, C = pts.shape[0], grid.channels
    res = grid.resolution
    # the grid's rows this call reads: its points' 8 corners, each row once
    i0, _ = SG._corner_setup((pts - grid.center) / grid.half, res)
    corners = [((torch.clamp(i0[:, 2] + dz, max=res - 1) * res
                 + torch.clamp(i0[:, 1] + dy, max=res - 1)) * res
                + torch.clamp(i0[:, 0] + dx, max=res - 1))
               for dx in (0, 1) for dy in (0, 1) for dz in (0, 1)]
    rows_read = int(torch.unique(torch.cat(corners)).numel())
    print(f"seed_gather secondary coarse call: {rows_read} of {res ** 3} "
          f"grid rows read", flush=True)
    # the library call: F.grid_sample's trilinear blend of the 4 root
    # channels (no coherence test, no nearest corner, no SDF policy)
    vox5 = grid.grid[..., :4].permute(3, 0, 1, 2)[None].contiguous()
    g5 = ((pts - grid.center) / grid.half).reshape(1, N, 1, 1, 3)
    km = lambda: SG.gather_from_grid(grid, pts, coh)
    lib = lambda: torch.nn.functional.grid_sample(
        vox5, g5, mode="bilinear", padding_mode="border", align_corners=True)
    ms, lib_ms = time_ms(km), time_ms(lib)
    row("seed_gather", "cuda", "intrinsicavatar_tpu_torch/csrc/seedgrid.cu",
        "intrinsicavatar_tpu/anim/seedgrid.py:173", f"pts[{N}, 3] "
        f"grid[{res}^3, {C}]", max(errs), ms,
        time_ms(lambda: SG.gather_from_grid_plain(grid, pts, coh), 3),
        # 12 B in and 17 B out a point; each grid row the points' corners
        # touch once (its C channels; the kernel reads them as 32 B
        # records); center and half
        N * (12 + 17) + rows_read * C * 4 + 24,
        N * 300, lib_ms)
    print(f"seed_gather secondary coarse call: {json.dumps({'ms': ms, 'device_ms': device_ms(km, PORT_KERNELS['seed_gather']), 'library_ms': lib_ms, 'library_device_ms': device_ms(lib, 'grid_sampler'), 'before_redesign_ms': EARLIER_MS['seed_gather']})}",
          flush=True)


class Tripwire:
    """Stands in for a plain twin during a phase on the card: a call there
    means a CUDA tensor did not reach its kernel."""

    def __init__(self, module, name):
        self.module, self.name = module, name
        self.fn = getattr(module, name)
        self.calls = 0
        setattr(module, name, self)

    def __call__(self, *args, **kwargs):
        self.calls += 1
        return self.fn(*args, **kwargs)

    def restore(self):
        setattr(self.module, self.name, self.fn)


def check_step_sizes(mcfg, R):
    """``(shading lanes, curvature subsample, samples per ray)`` of a
    compacted step at step 2000 of ``R`` rays."""
    S = int(mcfg.num_samples_per_ray) + int(mcfg.get(
        "n_importance_rounds", 2)) * int(mcfg.get("n_importance_samples", 16))
    frac = float(mcfg.get("query_compaction", 0.5)) + 0.0625
    nq = int(np.ceil(R * S * frac / 128)) * 128
    nsub = int(np.ceil(nq * float(mcfg.get("curvature_subsample", 0.25))
                       / 128)) * 128
    return nq, nsub, S


# norm-relative tolerance of the card-vs-CPU step's gradients, by leaf: 1%,
# but 5% for the geometry table (the curvature proxy)
GRAD_TOL = {"geometry.table": 5e-2}
# The pose's gradient sums every shading lane's cotangent, second-order
# pullbacks included, which jump where a lane crosses a hash cell's face: a
# move of the rays by rounding moves it by up to tens of percent at 256
# rays.  It is held, within 1%, to the gradient that the card step's own KN
# inputs give on the CPU (the twin's d tfs pulled back through the CPU
# frame's tfs), where no lane can jump; the step-to-step reading is printed.
CHAINED = ("pose_correction.pose",)
# zero but for rounding: the global orient and translation corrections
# cancel in tfs = A_0^-1 A_j tfs_inv_t (the frame is pelvis-aligned);
# held to 1e-4 of the pose's gradient on both sides
CANCELLED = ("pose_correction.global_orient", "pose_correction.transl")


def pose_pullback(system, batch, step, kn_args):
    """The pose corrections' gradients that KN's inputs ``kn_args`` give on
    the CPU ``system``: the twin's d tfs pulled back through the tfs of the
    frame that its train step at ``step`` prepares."""
    import torch

    from intrinsicavatar_tpu_torch.anim import broyden as B
    d_tfs = B.deform_skinning_bwd_plain(
        *(a.cpu() if torch.is_tensor(a) else a for a in kn_args))
    params = {n: p for n, p in system.model.named_parameters()
              if n.startswith("pose_correction.")}
    with torch.enable_grad():
        frame, _ = system.model.prepare(system.statics,
                                        system.to_device(batch), step,
                                        training=True)
        grads = torch.autograd.grad(frame.tfs, list(params.values()), d_tfs,
                                    allow_unused=True)
    return {n: g for n, g in zip(params, grads) if g is not None}


def check_draws(cfg, step, R, phys, g):
    """The draws of a train step of ``R`` rays at ``step`` past the
    importance kick-in (the phys regime's too with ``phys``), from the CPU
    generator ``g``; ``(draws, shading samples)``."""
    import torch
    nq, nsub, S = check_step_sizes(cfg.model, R)
    compact = R * S >= 4096
    if not compact:
        nq = R * S
        nsub = min(int(np.ceil(nq * float(cfg.model.get(
            "curvature_subsample", 0.25)) / 128)) * 128, nq)
    draws = {"bg": torch.rand(3, generator=g),
             "strat_u": torch.rand(R, generator=g),
             "lap_sub": torch.randint(0, nq, (nsub,), generator=g),
             "lap_u": torch.rand(nsub, 3, generator=g)}
    if phys:
        spp = int(cfg.model.samples_per_pixel)
        n1 = max(spp // 32, 1)
        if compact:
            draws["jit_sub"] = torch.randint(0, nq, (nsub,), generator=g)
        draws.update({
            "jit_noise": torch.randn(nsub if compact else nq, 3,
                                     generator=g),
            "sphere_u": torch.rand(2, n1, spp // n1, generator=g),
            "strata_u": torch.rand(R, spp, generator=g)})
    return draws, R * S


def card_vs_cpu_step(cfg_s, step, dev, skip=("pose_correction", "emitter.",
                                             "material.")):
    """One train step at ``step`` on the card and on the CPU twins from the
    same parameters, grid and draws: the loss within 1e-4, each leaf's
    gradient within 1% of its norm (``GRAD_TOL``), the pose's against the
    pullback of the card step's KN inputs (``CHAINED``).  Leaves starting
    with ``skip`` are not read at that step; the material head's Lipschitz
    parameters enter the loss with weight 0 before step 12,500."""
    import torch

    from intrinsicavatar_tpu_torch.anim import deformer as DF
    from intrinsicavatar_tpu_torch.data.synthetic import SyntheticDataset
    from intrinsicavatar_tpu_torch.train.system import IntrinsicAvatarSystem

    ds_s = SyntheticDataset(cfg_s.dataset, rng=np.random.default_rng(SEED))
    gpu = IntrinsicAvatarSystem(cfg_s, dev).setup(ds_s.betas)
    # noise on the SDF MLP's rows of the hash features, zero at the sphere
    # init (the geometry table would get no gradient)
    gen = torch.Generator().manual_seed(SEED)
    with torch.no_grad():
        v = gpu.model.geometry.mlp.layers[0].v
        v[3:] += 0.05 * torch.randn(v[3:].shape, generator=gen).to(dev)
    b = ds_s[0]
    t_idx = b.pop("t_idx")
    gpu.step = step
    gpu.occ_update_step(gpu.to_device(b), t_idx)
    cpu = IntrinsicAvatarSystem(cfg_s, "cpu").setup(ds_s.betas)
    cpu.model.load_state_dict({k: v.cpu()
                               for k, v in gpu.model.state_dict().items()})
    cpu.step = step
    cpu.occ = type(gpu.occ)(*(a.cpu() for a in gpu.occ))
    R = b["rays"].shape[0]
    flags = gpu.flags_for_step(step)
    draws, n_samples = check_draws(cfg_s, step, R, flags.enable_phys,
                                   torch.Generator().manual_seed(SEED + 2))
    rec = Recorder(DF, "deform_skinning_bwd", lambda a: a[0].shape[0])
    try:
        lg = gpu.train_step(gpu.to_device(b), t_idx, flags, draws)
    finally:
        rec.restore()
    # before the CPU step moves the parameters
    chained = pose_pullback(cpu, b, step, rec.best[1]) if rec.best else {}
    tc = time.perf_counter()
    lc = cpu.train_step(cpu.to_device(b), t_idx, cpu.flags_for_step(step),
                        draws)
    cpu_s = time.perf_counter() - tc
    if int(lg["shading_total_samples"]) != n_samples:
        fail(f"the check step at {step} has "
             f"{int(lg['shading_total_samples'])} samples, expected "
             f"{n_samples}")
    loss_rel = abs(float(lg["total"]) - float(lc["total"])) \
        / abs(float(lc["total"]))
    grads, cancelled, step_rel = {}, {}, {}
    cpu_params = dict(cpu.model.named_parameters())
    gpu_params = dict(gpu.model.named_parameters())
    for name, p in gpu_params.items():
        if name.startswith(skip) or (name.startswith("material.")
                                     and name.endswith(".c")):
            continue
        gc, gp = p.grad, cpu_params[name].grad
        if name in CANCELLED:
            ref = gpu_params["pose_correction.pose"].grad
            cancelled[name] = [float(g.norm() / ref.norm())
                               for g in (gc, gp)]
            continue
        if gc is None or gp is None or not torch.isfinite(gc).all() \
                or float(gc.abs().max()) == 0.0:
            fail(f"card step at {step}: {name} has no finite nonzero "
                 f"gradient")
        if name in CHAINED:
            if name not in chained:
                fail(f"card step at {step}: no KN call gave {name}")
            step_rel[name] = float((gc.cpu() - gp).norm() / gp.norm())
            gp = chained[name]
        grads[name] = float((gc.cpu() - gp).norm() / gp.norm())
    print(f"card vs CPU-twin step of {R} rays at step {step} (CPU "
          f"{cpu_s:.1f} s): loss {float(lg['total']):.7g} vs "
          f"{float(lc['total']):.7g} (rel {loss_rel:.2e}); gradient rel "
          f"errors {json.dumps(grads)} (the pose's against the pullback of "
          f"the card's KN inputs; against the CPU step's, not held: "
          f"{json.dumps(step_rel)}); cancelled leaves {cancelled}",
          flush=True)
    # the loss within 1e-4; each leaf's gradient within 1% of its norm
    # (atomics and cuBLAS sum in other orders), the geometry table's
    # within 5% (GRAD_TOL): near the initial sphere the curvature proxy,
    # arccos of a dot within ~1e-6 of 1, dominates the table's gradient
    # and its f32 rounding moves with every reordered sum (2.6% between
    # the CPU twins and JAX too, tests/test_torch_train.py)
    if not loss_rel <= 1e-4:
        fail(f"card and CPU-twin losses disagree at step {step}: "
             f"{loss_rel}")
    bad = {k: v for k, v in grads.items()
           if not v <= GRAD_TOL.get(k, 1e-2)}
    bad.update({k: v for k, v in cancelled.items() if max(v) > 1e-4})
    if bad:
        fail(f"card and CPU-twin gradients disagree at step {step}: {bad}")
    return {"rays": R, "step": step, "loss_rel": loss_rel,
            "grad_rel": grads, "pose_step_rel": step_rel,
            "cancelled_rel": cancelled, "cpu_s": cpu_s}


BWD_NAMES = ("hashgrid_encode_bwd", "encode_mlp_sdfgrad_bwd_gather",
             "encode_mlp_sdfgrad_bwd_scatter", "volrend_composite_bwd")


def train(rows, row, card, dev):
    """Steps 6: the backward kernels against their twins, the train phase,
    its profile and the card-vs-CPU step.  Returns the train line."""
    import torch

    from intrinsicavatar_tpu_torch import kernels
    from intrinsicavatar_tpu_torch.data.synthetic import SyntheticDataset
    from intrinsicavatar_tpu_torch.fields import geometry as GEO
    from intrinsicavatar_tpu_torch.fields import radiance as RAD
    from intrinsicavatar_tpu_torch.ops import encode_grad as EG
    from intrinsicavatar_tpu_torch.ops import hashgrid as HG
    from intrinsicavatar_tpu_torch.ops import volrend as V
    from intrinsicavatar_tpu_torch.train.system import IntrinsicAvatarSystem
    from intrinsicavatar_tpu_torch.utils.config import merge
    from intrinsicavatar_tpu_torch.utils.default_config import train_config

    cfg = train_config()
    ds = SyntheticDataset(cfg.dataset, rng=np.random.default_rng(SEED))
    system = IntrinsicAvatarSystem(cfg, dev)
    t0 = time.perf_counter()
    system.setup(ds.betas)
    torch.cuda.synchronize()
    print(f"train setup in {time.perf_counter() - t0:.2f} s", flush=True)
    data = ds.train_iter(np.random.default_rng(SEED + 1))

    # ------------------------------------------------ capture at step 2000
    recs = [Recorder(HG, "hashgrid_encode_bwd", lambda a: a[1].shape[0]),
            Recorder(EG, "encode_mlp_sdfgrad_bwd_gather",
                     lambda a: a[2].shape[0]),
            Recorder(EG, "encode_mlp_sdfgrad_bwd_scatter",
                     lambda a: a[2].shape[0]),
            # the largest pass 2 that pulls xn back (the curvature call)
            Recorder(EG, "encode_mlp_sdfgrad_bwd_scatter",
                     lambda a: a[2].shape[0] if a[7] else -1),
            Recorder(V, "composite_bwd", lambda a: a[0].numel()),
            # KA's forward: the step's largest encode
            Recorder(GEO, "hashgrid_encode", lambda a: a[1].shape[0]),
            Recorder(RAD, "hashgrid_encode", lambda a: a[1].shape[0]),
            # the smallest pass 1 with points (the curvature call)
            Recorder(EG, "encode_mlp_sdfgrad_bwd_gather",
                     lambda a: -a[2].shape[0] if a[2].shape[0] else -1 << 62)]
    batch, t_idx = next(data)
    batch = system.to_device(batch)
    system.step = 2000
    system.occ_update_step(batch, t_idx)
    system.train_step(batch, t_idx, system.flags_for_step(2000))
    torch.cuda.synchronize()
    for r in reversed(recs):
        r.restore()
    ka, kb1, kb2, kb2x, kd = (r.best for r in recs[:5])
    if kb2x[0] < 0:
        fail("no pass 2 of KB' pulled xn back (the curvature call)")
    ka_train = ka_reading(max((r.best for r in recs[5:7] if r.best),
                              key=lambda b: b[0]), "train step at 2000", card)
    kb1x = recs[7].best

    # KA' (table only, as on the path: the radiance points carry no grad)
    ka2 = ka2_reading(ka, "radiance call", card)
    row("hashgrid_encode_bwd", "cuda",
        "intrinsicavatar_tpu_torch/csrc/hashgrid.cu",
        "intrinsicavatar_tpu/ops/hashgrid.py:182", ka2["shape"],
        ka2["max_abs_err"], ka2["ms"], ka2["plain_ms"], ka2["bytes"],
        ka2["flops"], ka2["library_ms"])

    # KB' pass 1 at the shading and the curvature call, pass 2 at the
    # shading call, pass 2 with d_xn checked on the curvature call
    kb1_reads = [kb1_reading(kb1, "shading call", card),
                 kb1_reading(kb1x, "curvature call", card)]
    r = kb1_reads[0]
    row("encode_mlp_sdfgrad_bwd_gather", "cuda",
        "intrinsicavatar_tpu_torch/csrc/encode_grad.cu",
        "intrinsicavatar_tpu/ops/encode_grad.py:238", r["shape"],
        max(k["max_abs_err"] for k in kb1_reads), r["ms"], r["plain_ms"],
        r["bytes"], r["flops"])
    kb2_reads = [kb2_reading(kb2, "shading call", card),
                 kb2_reading(kb2x, "curvature call", card)]
    r = kb2_reads[0]
    row("encode_mlp_sdfgrad_bwd_scatter", "cuda",
        "intrinsicavatar_tpu_torch/csrc/encode_grad.cu",
        "intrinsicavatar_tpu/ops/encode_grad.py:288", r["shape"],
        max(k["max_abs_err"] for k in kb2_reads), r["ms"], r["plain_ms"],
        r["bytes"], r["flops"], r["library_ms"])

    # KD'
    dk = V.composite_bwd(*kd[1])
    dp = V.composite_bwd_plain(*kd[1])
    torch.cuda.synchronize()
    err = max(relerr(a, b) for a, b in zip(dk, dp))
    # a tree-ordered scan vs the twin's sequential recurrence
    if not err <= 1e-5:
        fail(f"composite_bwd disagrees with its twin: {err}")
    R, S = kd[1][0].shape
    n = R * S
    row("volrend_composite_bwd", "triton",
        "intrinsicavatar_tpu_torch/ops/volrend_triton.py",
        "intrinsicavatar_tpu/ops/volrend.py:38", f"sdf[{R}, {S}]",
        max((a - b).abs().max().item() for a, b in zip(dk, dp)),
        time_ms(lambda: V.composite_bwd(*kd[1])),
        time_ms(lambda: V.composite_bwd_plain(*kd[1]), 3),
        # reads sdf, dists, mask, rgb, normal, mids, d weights and the
        # per-ray cotangents; writes d sdf, d rgb, d normal, d beta
        n * (4 + 4 + 1 + 12 + 12 + 4 + 4) + R * 32 + n * (4 + 12 + 12)
        + R * 4, n * 60)
    del recs, ka, kb1, kb1x, kb2, kb2x, kd, dk, dp

    # ------------------------------------------------ train phase
    system.setup(ds.betas)
    trips = tripwires(TWINS)
    regimes = []
    torch.cuda.synchronize()
    kernels.reset_launches()
    for start, n_steps in ((0, 3), (2000, 10)):
        system.step = start
        stamps = [time.perf_counter()]
        torch.cuda.reset_peak_memory_stats()
        hist = system.fit(data, start + n_steps, log_every=1,
                          callback=lambda s, sc: stamps.append(
                              time.perf_counter()))
        steps_s = np.diff(stamps).tolist()
        last = hist[-1][1]
        regimes.append({
            "from_step": start, "steps": n_steps,
            "step_s": steps_s,
            "rays_per_s": cfg.dataset.n_rays * n_steps / sum(steps_s),
            "peak_mem_bytes": torch.cuda.max_memory_allocated(),
            "losses": {k: [h[1][k] for h in hist] for k in (
                "total", "rgb_l1", "eikonal", "mask_bce", "curvature")},
            "counters": {k: v for k, v in last.items()
                         if k.startswith(("ovf_", "shading_"))}})
        print(json.dumps({"train_regime": regimes[-1]}), flush=True)
    torch.cuda.synchronize()
    launches = dict(kernels.launches)
    for t in trips:
        t.restore()
    if any(t.calls for t in trips):
        fail(f"plain backward twins ran on the card: "
             f"{[(t.name, t.calls) for t in trips if t.calls]}")
    for r in rows:
        if r["name"] in BWD_NAMES:
            r["launches"] = int(launches.get(r["name"], 0))
    missing = [n for n in BWD_NAMES if not launches.get(n)]
    if missing:
        fail(f"backward kernels not launched in the train phase: {missing}")
    for reg in regimes:
        for k, v in reg["losses"].items():
            if not np.all(np.isfinite(v)):
                fail(f"train from step {reg['from_step']}: {k} is not "
                     f"finite: {v}")
    print(f"train launches: {json.dumps(launches)}", flush=True)

    # one step under the profiler
    wall_ms, by_kernel = profile_device(
        lambda: system.fit(data, system.step + 1, log_every=1))
    busy_ms = sum(ms for ms, _ in by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:15]
    profile_line = {
        "step": system.step - 1, "step_wall_ms": wall_ms,
        "device_busy_ms": busy_ms,
        "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
        "device_launches": sum(cnt for _, cnt in by_kernel.values()),
        "port_kernels": kernel_shares(by_kernel, busy_ms),
        "top": [[k[:70], ms, cnt] for k, (ms, cnt) in top]}
    print(json.dumps({"train_profile": profile_line}), flush=True)

    # ------------------------------------------------ card vs CPU twins
    cpu_check = card_vs_cpu_step(merge(cfg, {"dataset": {"n_rays": 256}}),
                                 2000, dev)
    return {"regimes": regimes, "launches": launches, "card": card,
            "profile": {k: profile_line[k] for k in (
                "step_wall_ms", "device_busy_ms", "device_idle_share",
                "device_launches", "port_kernels")},
            "ka_train_step": ka_train,
            "ka2_radiance_call": ka2,
            "kb1_shading_call": kb1_reads[0],
            "kb1_curvature_call": kb1_reads[1],
            "kb2_shading_call": kb2_reads[0],
            "kb2_curvature_call": kb2_reads[1],
            "cpu_check": cpu_check}


POSE_START = 4001    # the first step the pose corrections move
PHYS_START = 10000   # phys_kick_in_step of the default config
TWINS = (("hashgrid", "hashgrid_encode_bwd_plain"),
         ("encode_grad", "encode_mlp_sdfgrad_bwd_gather_plain"),
         ("encode_grad", "encode_mlp_sdfgrad_bwd_scatter_plain"),
         ("volrend", "composite_bwd_plain"),
         ("volrend", "render_weight_from_alpha_plain"),
         ("broyden", "deform_skinning_bwd_plain"))
PBR_TWINS = (("resample", "cdf_resample_rays_plain"),
             ("resample", "sdf_fine_resample_rays_plain"),
             ("resample", "fine_resample_rays_plain"),
             ("grid_traversal", "secondary_march_plain"),
             ("broyden", "broyden_polish_plain"))


def tripwires(pairs):
    from intrinsicavatar_tpu_torch.anim import broyden as B
    from intrinsicavatar_tpu_torch.ops import encode_grad as EG
    from intrinsicavatar_tpu_torch.ops import grid_traversal as G
    from intrinsicavatar_tpu_torch.ops import hashgrid as HG
    from intrinsicavatar_tpu_torch.ops import resample as RS
    from intrinsicavatar_tpu_torch.ops import volrend as V
    mods = {"hashgrid": HG, "encode_grad": EG, "volrend": V, "broyden": B,
            "resample": RS, "grid_traversal": G}
    return [Tripwire(mods[m], name) for m, name in pairs]


def kn_reading(args, where):
    """KN on the call ``args`` against its function summed in float64,
    each entry within the rounding bound of KN's summation order
    (``deform_skinning_bwd_exact``), two calls bit for bit, each planted
    fault refused; returns ``(the kernel's output, the twin's, a reading
    with the worst error / bound of both and of each fault)``."""
    import torch

    from intrinsicavatar_tpu_torch.anim import broyden as B
    out_k = B.deform_skinning_bwd(*args)
    out_k2 = B.deform_skinning_bwd(*args)
    out_p = B.deform_skinning_bwd_plain(*args)
    torch.cuda.synchronize()
    if not torch.equal(out_k, out_k2):
        fail(f"deform_skinning_bwd differs between two calls at the {where}")
    exact, limit = B.deform_skinning_bwd_exact(*args)
    ratio = lambda o: ((o.double() - exact)[:, :3].abs()
                       / limit[:, :3].clamp(min=1e-300)).max().item()
    if B.deform_skinning_bwd_refused(out_k, exact, limit):
        fail(f"deform_skinning_bwd is off its float64 sum by more than "
             f"its rounding bound at the {where}: worst error / bound "
             f"{ratio(out_k)}")
    faults = {k: ratio(v) for k, v in B.deform_skinning_bwd_faults(
        *args, out_k, limit).items()}
    passed = [k for k, v in faults.items() if not v > 1.0]
    if passed:
        fail(f"the KN check passes planted faults at the {where}: {passed}")
    return out_k, out_p, {
        "where": where, "lanes": args[0].shape[0],
        "rotation_cotangent": args[4] is not None,
        "err_over_bound": ratio(out_k), "twin_err_over_bound": ratio(out_p),
        "faults_err_over_bound": faults}


def check_kn(rows, row, system, data, dev):
    """KN's inputs from one full-width train step at step 4,001 with the
    pose correction on; ``kn_reading`` of them; timed beside its twin and
    beside ``W.t() @ U``, the product that is its reduction.  Returns KN's
    row."""
    import torch

    from intrinsicavatar_tpu_torch.anim import broyden as B
    from intrinsicavatar_tpu_torch.anim import deformer as DF

    rec = Recorder(DF, "deform_skinning_bwd", lambda a: a[0].shape[0])
    batch, t_idx = next(data)
    batch = system.to_device(batch)
    system.step = POSE_START
    system.occ_update_step(batch, t_idx)
    system.train_step(batch, t_idx, system.flags_for_step(POSE_START))
    torch.cuda.synchronize()
    rec.restore()
    if rec.best is None:
        fail("no deform_skinning_bwd call in a train step with the pose "
             "correction on")
    args = rec.best[1]
    xc, valid, jinv, g_xc, g_rot, lbs_cl, spec = args
    M = xc.shape[0]
    out_k, out_p, reading = kn_reading(args, "pose step's train call")
    err = (out_k - out_p).abs().max().item()
    W, U, _ = B.skin_bwd_terms(*args)
    W, U = W.float().contiguous(), U.float().contiguous()
    # the lanes that add anything (U = 0 at the others, whose root, J^-1,
    # position cotangent and weight rows the function does not need)
    adds = B.skin_bwd_adds(valid, g_rot)
    n_adds = int(adds.sum())
    rows_read = lbs_rows_touched(xc[adds], spec)
    call = lambda: B.deform_skinning_bwd(*args)
    row("deform_skinning_bwd", "cuda",
        "intrinsicavatar_tpu_torch/csrc/deform.cu",
        "intrinsicavatar_tpu/anim/deformer.py:396", f"xc[{M}, 3]", err,
        time_ms(call),
        time_ms(lambda: B.deform_skinning_bwd_plain(*args), 3),
        # validity and the rotation cotangent of every lane read once, the
        # adding lanes' root, J^-1 and position cotangent and the weight
        # rows their corners touch read once, d tfs written once
        M * (1 + (36 if g_rot is not None else 0))
        + n_adds * (12 + 36 + 12) + rows_read * 24 * 4 + 24 * 16 * 4,
        n_adds * (8 * 24 * 2 + 24 * 12 * 2 + 40),
        # the reduction alone, on the gathered weights
        time_ms(lambda: W.t() @ U))
    reading.update(adding_lanes=n_adds, rows_touched=rows_read,
                   device_ms=device_ms(call,
                                       PORT_KERNELS["deform_skinning_bwd"]),
                   before_redesign_ms=EARLIER_MS["deform_skinning_bwd"])
    print(f"KN at {M} lanes, {n_adds} adding ({rows_read} of "
          f"{lbs_cl.shape[0]} weight rows read): {json.dumps(reading)}; "
          f"bit-equal over two calls", flush=True)
    return rows[-1]


def run_regime(system, data, start, n_steps, cfg):
    """``fit`` for ``n_steps`` from ``start``: step seconds, rays/s, peak
    memory, the losses, and the frames seen."""
    import torch
    seen = set()

    def frames():
        for batch, t_idx in data:
            seen.add(int(np.asarray(batch["index"]).reshape(-1)[0]))
            yield batch, t_idx

    system.step = start
    stamps = [time.perf_counter()]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    hist = system.fit(frames(), start + n_steps, log_every=1,
                      callback=lambda s, sc: stamps.append(
                          time.perf_counter()))
    torch.cuda.synchronize()
    steps_s = np.diff(stamps).tolist()
    keys = ["total", "rgb_l1", "eikonal", "mask_bce", "curvature"]
    if "rgb_phys_l1" in hist[-1][1]:
        keys += ["rgb_phys_l1", "rgb_demodulated", "normal_orientation",
                 "albedo_smoothness"]
    line = {"from_step": start, "steps": n_steps, "step_s": steps_s,
            "rays_per_s": cfg.dataset.n_rays * n_steps / sum(steps_s),
            "peak_mem_bytes": torch.cuda.max_memory_allocated(),
            "losses": {k: [h[1][k] for h in hist] for k in keys},
            "counters": {k: v for k, v in hist[-1][1].items()
                         if k.startswith(("ovf_", "shading_", "sec_"))}}
    for k, v in line["losses"].items():
        if not np.all(np.isfinite(v)):
            fail(f"train from step {start}: {k} is not finite: {v}")
    return line, sorted(seen)


def train_pose_phys(rows, row, card, dev):
    """Step 8: pose-correction and phys-regime training.  KN against its
    twin; 10 steps from step 4,001 and 3 from step 10,000 at full width
    with the pose correction on and the plain backward (and PBR) twins set
    to fail if called, with the launches counted, one phys step profiled;
    the card-vs-CPU steps at 4,001 (256 rays) and 10,000 (32 rays).
    Returns the line."""
    import torch

    from intrinsicavatar_tpu_torch import kernels
    from intrinsicavatar_tpu_torch.anim import deformer as DF
    from intrinsicavatar_tpu_torch.data.synthetic import SyntheticDataset
    from intrinsicavatar_tpu_torch.ops import volrend as V
    from intrinsicavatar_tpu_torch.train.system import IntrinsicAvatarSystem
    from intrinsicavatar_tpu_torch.utils.config import merge
    from intrinsicavatar_tpu_torch.utils.default_config import train_config

    cfg = merge(train_config(), {"model": {"pose_correction": {
        "enable_pose_correction": True}}})
    ds = SyntheticDataset(cfg.dataset, rng=np.random.default_rng(SEED))
    data = ds.train_iter(np.random.default_rng(SEED + 1))
    system = IntrinsicAvatarSystem(cfg, dev).setup(ds.betas)
    kn_row = check_kn(rows, row, system, data, dev)

    # ------------------------------------------------ pose regime
    system.setup(ds.betas)
    trips = tripwires(TWINS)
    kernels.reset_launches()
    pose, seen = run_regime(system, data, POSE_START, 10, cfg)
    launches = dict(kernels.launches)
    for t in trips:
        t.restore()
    if any(t.calls for t in trips):
        fail(f"plain backward twins ran on the card: "
             f"{[(t.name, t.calls) for t in trips if t.calls]}")
    kn_row["launches"] = int(launches.get("deform_skinning_bwd", 0))
    if kn_row["launches"] != 10:
        fail(f"deform_skinning_bwd launched {kn_row['launches']} times in "
             f"10 steps")
    missing = [n for n in BWD_NAMES if not launches.get(n)]
    if missing:
        fail(f"backward kernels not launched in the pose regime: {missing}")
    corr = system.model.pose_correction.pose.detach()
    moved = {i: float(corr[i].abs().max()) for i in seen}
    if not all(v > 0 for v in moved.values()):
        fail(f"pose corrections of the frames seen did not move: {moved}")
    pose.update({"launches": launches, "frames_seen": seen,
                 "pose_correction_max_abs": moved})
    print(json.dumps({"pose_regime": pose}), flush=True)

    # ------------------------------------------------ phys regime
    system.setup(ds.betas)
    trips = tripwires(TWINS + PBR_TWINS)
    # the search and its epilogue of the searched secondary coarse pass: a
    # shader chunk's call, the one that comes most often
    rec = Recorder(DF, "deform_epilogue",
                   MostFrequent(lambda a: a[0].x.shape[0]))
    rec_kc = Recorder(DF, "broyden_search",
                      MostFrequent(lambda a: a[0].shape[0]))
    rec_pro = Recorder(DF, "deform_prologue",
                       MostFrequent(lambda a: a[0].shape[0]))
    # KD weights' shader-chunk call and the fine pass's skinning, each the
    # call that comes most often (KL's calls are kept in a step of their
    # own, after the profile, so that the measured steps hold no more than
    # one call's arguments a recorder)
    rec_kd = Recorder(V, "render_weight_from_alpha",
                      MostFrequent(lambda a: tuple(a[0].shape)))
    rec_sk = Recorder(DF, "deform_skinning",
                      MostFrequent(lambda a: a[0].shape[0]))
    rec_kn = Recorder(DF, "deform_skinning_bwd", lambda a: a[0].shape[0])
    kernels.reset_launches()
    try:
        phys, _ = run_regime(system, data, PHYS_START, 3, cfg)
    except torch.cuda.OutOfMemoryError as e:
        fail(f"a full-width phys step does not fit on the card "
             f"({torch.cuda.max_memory_allocated()} bytes allocated at "
             f"the peak): {e}")
    launches = dict(kernels.launches)
    for r in (rec_kn, rec_sk, rec_kd, rec_pro, rec_kc, rec):
        r.restore()
    for t in trips:
        t.restore()
    if any(t.calls for t in trips):
        fail(f"plain twins ran on the card in the phys regime: "
             f"{[(t.name, t.calls) for t in trips if t.calls]}")
    need = BWD_NAMES + ("deform_skinning_bwd", "cdf_resample",
                        "fine_resample", "secondary_march", "broyden_polish")
    missing = [n for n in need if not launches.get(n)]
    if missing:
        fail(f"kernels not launched in the phys regime: {missing}")
    phys["launches"] = launches
    print(json.dumps({"phys_regime": phys}), flush=True)
    epi_phys = epilogue_reading(rec.best, "phys step's secondary coarse call",
                                card)
    kc_phys = kc_reading(rec_kc.best, "phys step's secondary coarse call",
                         card, launches.get("broyden_search", 0) / 3)
    pro_phys = prologue_reading(rec_pro.best,
                                "phys step's secondary coarse call", card,
                                launches.get("deform_prologue", 0) / 3)
    kd_phys = kd_reading(rec_kd.best, "phys step's shader chunk", card,
                         launches.get("volrend_weights", 0) / 3)
    skin_phys = skinning_reading(rec_sk.best[1], "phys step's fine pass",
                                 card, launches.get("deform_skinning", 0) / 3)
    kn_phys = kn_reading(rec_kn.best[1], "phys step's train call")[2]
    kn_phys["device_ms"] = device_ms(
        lambda: DF.deform_skinning_bwd(*rec_kn.best[1]),
        PORT_KERNELS["deform_skinning_bwd"])
    print(f"KN: {json.dumps(kn_phys)}", flush=True)
    del rec, rec_kc, rec_pro, rec_kd, rec_sk, rec_kn
    wall_ms, by_kernel = profile_device(
        lambda: system.fit(data, system.step + 1, log_every=1))
    busy_ms = sum(ms for ms, _ in by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:15]
    phys_profile = {
        "step": system.step - 1, "step_wall_ms": wall_ms,
        "device_busy_ms": busy_ms,
        "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
        "device_launches": sum(cnt for _, cnt in by_kernel.values()),
        "port_kernels": kernel_shares(by_kernel, busy_ms),
        "top": [[k[:70], ms, cnt] for k, (ms, cnt) in top]}
    print(json.dumps({"phys_profile": phys_profile}), flush=True)
    # one more phys step, not measured, keeps every polish call's arguments
    # for a fine pass's median call
    kl_calls = []
    rec_kl = Recorder(DF, "broyden_polish", lambda a: 0, calls=kl_calls)
    system.fit(data, system.step + 1, log_every=1)
    rec_kl.restore()
    kl_f, seeded_mean = median_polish_call(kl_calls, "phys step's fine "
                                           "pass")
    kl_phys = kl_reading(kl_f, "phys step's fine pass", card,
                         launches.get("broyden_polish", 0) / 3)
    kl_phys["seeded_per_call"] = seeded_mean
    del system, rec_kl, kl_calls, kl_f

    # ------------------------------------------------ card vs CPU twins
    checks = [
        card_vs_cpu_step(merge(cfg, {"dataset": {"n_rays": 256}}),
                         POSE_START, dev, skip=("emitter.", "material.",
                                                "pose_correction.betas")),
        card_vs_cpu_step(merge(cfg, {"dataset": {"n_rays": 32}}),
                         PHYS_START, dev, skip=("pose_correction.betas",))]
    return {"pose_regime": pose, "phys_regime": phys, "card": card,
            "phys_profile": {k: phys_profile[k] for k in (
                "step_wall_ms", "device_busy_ms", "device_idle_share",
                "device_launches", "port_kernels")},
            "epilogue_secondary_coarse": epi_phys,
            "search_secondary_coarse": kc_phys,
            "prologue_secondary_coarse": pro_phys,
            "kd_shader_chunk": kd_phys,
            "kl_fine_pass": kl_phys,
            "skinning_fine_pass": skin_phys,
            "kn_phys_call": kn_phys,
            "cpu_checks": checks}



if __name__ == "__main__":
    main()
