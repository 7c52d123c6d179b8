"""Time kernels KA (hash encode forward), KB (fused encode + SDF MLP +
gradient), the KH epilogue (duplicate filter, overflow count, first-K), KM
(seed grid gather), KC (Broyden search), KB' pass 2 (the encode
backward's table scatter), KA' (the hash encode's backward), KF (merge
importance resampling), KJ (secondary fine resampling), KG (valid-first
compaction), the KH prologue (the search's init pruning), KK (the
secondary march), KD weights (the volume-rendering weights), KL (the
seeded Broyden polish), KH skinning (the LBS rotation at the roots), KB'
pass 1 (the encode backward's gather), KN (the LBS blend's backward) and KI
(scatter-point sampling) of the PyTorch/CUDA port on one card, three ways.

    python3 kernel_timing.py                      # the port in this checkout
    python3 kernel_timing.py --port-root DIR      # the port under DIR
    python3 kernel_timing.py --kernels ksk --compare-dir D [--port-root R]
                                                  # KH skinning's rows kept
                                                  # in D, compared across
                                                  # roots
    python3 kernel_timing.py --diff-digests A B   # two saved runs' digests,
                                                  # call by call
    python3 kernel_timing.py --kernels kn,ki,kf   # of ka, kb, kh, km, kc,
                                                  # kb2, ka2, kf, kj, kg,
                                                  # khp, kk, kd, kl, ksk,
                                                  # kb1, kn, ki

``--port-root`` imports ``intrinsicavatar_tpu_torch`` from another checkout
(e.g. a parent commit unpacked with ``git archive``), so that two versions
are timed on the same card in one session: run parent, change, change,
parent.  For each call it prints one JSON line:

- ``event_ms``: CUDA events around 20 back-to-back wrapper calls, as
  ``chip_smoke.py`` times a kernel (the wrapper's host work included
  wherever it is longer than the kernel);
- ``device_ms``: the kernel's own device time a launch, from
  ``torch.profiler``;
- ``op_device_ms`` (KA', KG, the KH prologue, KK): the device time of
  everything the call runs, from ``torch.profiler`` (KN's ``device_ms`` is
  this, since an earlier KN ran two kernels a call);
- ``host_us``: the wrapper's host time a call (200 calls, no sync between);
  for KM also the pieces of it (an allocation, the stream pointer, the
  ``ctypes`` call with N = 0, which launches nothing).

The inputs are made from a seed at the serve path's shapes, at the
published widths (16 levels x 2 features, 2^19 tables, base 16, scale
1.4473, with the xyz columns):

- KA at 1,179,648 ray-ordered points (4,096 rays x 288 samples, the serve
  path's largest call), 552,960 uniform random points (KB's shape below)
  and 65,536 ray-ordered points (1,024 rays x 64 samples, a relight fine
  pass), held to its twin within 1e-6 + 1e-5 max|ref|;
- KB at 552,960 points (the searched shading query of a 4,096-ray chunk)
  and 65,536 (a relight fine pass), a 35 -> 64 -> 13 sphere-init MLP with
  noise on every weight (the init zeroes the first layer's rows of the
  hash features), held within 1e-4 of max(1, |feat|, |grad|), and KA on
  the same points;
- the KH epilogue (I = 8 inits, K = 4 kept) at 6,291,456 lanes (a serve
  chunk's search), 2,097,152 (the phys step's searched secondary coarse
  call, 262,144 points) and 524,288 (the bake's last chunk): lanes with
  0, 30% or all roots valid and planted near-duplicates, held bit-equal;
- KM at 262,144 points (4,096 rays x 64 samples in ray order) on a 96^3
  grid with 6 and with 4 channels, beside ``F.grid_sample`` on the 4 root
  channels, seed_ok equal and floats within 1e-5 of max(|ref|, 1);
- KC at 6,291,456 lanes (786,432 points x 8 inits, a serve chunk's search)
  and 2,097,152 (262,144 x 8, the phys step's searched secondary coarse
  call) on the published 32 x 128 x 128 voxel of the synthetic body in a
  pose, the points on rays through the body (over 1 m each side of the
  surface, as the recorded calls' lanes stop, and over 0.3 m, mostly near
  the surface), each point's inits chosen by
  the port's own prologue (KH): roots within 1e-4 of the twin's where both
  converged, at most 1e-3 of lanes flipped; a digest of the outputs'
  bytes, equal between two trees whose kernels compute the same bits;
- KB' pass 2 at 552,960 ray-ordered points without d_xn (a train step's
  shading call) and 92,160 with it (its curvature call), random
  cotangents, held within 1e-5 of the largest entry beyond 1e-4 of each
  entry (float atomics in changing order);
- KA' at 368,640 points, random cotangents: ray-ordered (4,096 rays x 90
  samples) and as a train step's radiance call lays them out (compacted
  sample-major, so neighbours come from different rays: uniform over the
  recorded call's box, with 62% of the slots the compaction's padding, at
  one point with a zero cotangent); without d_x, as the path calls it,
  and with it; the table cotangent held as KB' pass 2's and d_x within
  1e-5 of its largest entry beyond 1e-4 of each; ``device_ms`` is
  the kernel's and ``op_device_ms`` adds the wrapper's zero-fill of the
  64 MB cotangent; with d_x a digest of d_x and whether two calls agree
  bit for bit;
- KF at a 4,096-ray chunk's two importance rounds ([4096, 129] and
  [4096, 145] edges, 16 draws each) of a march through a random occupancy
  grid (a quarter of the rays miss), with weights in a bump about a point
  among each ray's valid edges, of mass 0, 0.5, 1 or 1.5; the second
  round's edges are the twin's merge of the first; the share of rays
  equal to the twin on flags and indices (at least 0.999), on those rays
  each value within the bound that the CDF's conditioning gives
  (``kf_draw_bound``: the twin's float32 cumsum on the card against KF's
  double sum, amplified by |t1 - t0| / seg where the CDF is flat), the same
  comparison with the twin on the CPU (whose cumsum sums in double, as KF
  does), and a digest of all six outputs' bytes;
- KJ at a shader chunk's call, [32768, 64] -> 4 intervals, in sdf and in
  plain mode, and at [32768, 16] in both, on left-packed rows (a sixth of
  the rays empty, a fifth with a rising SDF and so no crossing): the mask
  equal to the twin's and the placed intervals within 1e-5 of max(|ref|,
  1), and a digest of the three outputs' bytes;
- KG at the secondary coarse call ([32768, 64] sample-major, budget
  262,144; ~19,500 entries valid in left-packed runs, 7.5% of the budget,
  as the phys step's chunks average) and at the serve
  path's candidate call (3,145,728 ray-major, budget 1,179,648, 30% valid,
  0-4 of each point's 4 candidates): idx and picked equal to the twin's, a
  digest of both, and ``op_device_ms`` the count and scatter passes'
  device time a call (``parts``: each pass's);
- the KH prologue (I = 8 of 13 bones, the synthetic body in KC's pose) at
  a serve chunk's search (786,432 points on rays through the body, as KC's
  serve call) and at a stand-in for the phys step's secondary coarse call
  (262,144 points laid out as that call's compaction lays them out:
  sample-major, the ~7.5% valid samples first, then padded slots, ~92% of
  the call, which sit at their rays' scattering points since an unmasked
  slot's t_starts is 0; a chunk's rays are 64 primary rays' 512
  scattering points, neighbours along the primary ray): slot equal to the
  twin's, and a digest of it;
- KK at a shader chunk's call ([32768, 64], cap 8 and cap 0) and at
  [32768, 16], cap 8: rays from scattering points on a body-shaped blob of
  a 64^3 occupancy grid (a third of them inward), about 60% active, 2% a
  padded chunk's rays (origin 0, direction 1, inactive), near 0, far 1.5:
  the mask equal to the twin's, t_starts/t_ends within 1e-6, and a digest
  of the three outputs' bytes;
- KD weights at a shader chunk's call ([32768, 4]) and at a chunk's two
  importance rounds ([4096, 129], [4096, 145]): alphas in [0, 0.3] with
  some 0 and some 1, a sixth of the rows fully masked, NaN at the masked
  slots; within rtol 1e-5, atol 1e-6 of the twin on the card (the scan
  orders differ), a digest of w and T, and the form the wrapper picked;
- KL at a fine pass's 65,536-point budget laid out as its compaction lays
  it out (the seeded points first, the rest padding at the origin,
  unseeded): a phys step's (``KL_FINE_SEEDED``, the recorded calls'
  share, 4 iterations) and a relight chunk's busiest (11 points, 6
  iterations); at 368,640 points with 37% seeded (a grid-seeded shading
  pass), at 65,536 with every point seeded and with none: targets near the
  posed body's surface (the published voxel in KC's pose, skinned from
  canonical points near the template), seeds those canonical points moved
  by ~1 cm (a fine sample lies within a march step of its coarse seed);
  valid equal to the twin's, x
  and J^-1 within 1e-5 of the largest entry, a digest of all three
  outputs' bytes, equal between two trees whose kernels compute the same
  bits;
- KH skinning on the published voxel in KC's pose at a phys step's
  fine-pass stand-in (65,536 lanes: ``KL_FINE_SEEDED`` of them canonical
  points near the template first, the rest the budget's padding at one
  root), at a serve chunk's shading query (1,474,560 lanes: 368,640 points
  in ray order through the template, 4 kept lanes a point, the first the
  point, the others another root within ~5 cm at 30% and the origin
  otherwise) and at 65,536 points beyond the voxel, whose coordinates
  border padding clamps: within 1e-5 of the twin, the voxel rows touched,
  a digest of the rotation rows (not equal across a redesign that sums in
  another order) and, with ``--compare-dir DIR``, the largest difference
  from the rows that another root's kernel wrote there on the same
  inputs;
- KB' pass 1 at a train step's shading call (552,960 ray-ordered points)
  and its curvature call (92,160), random g_grad, a table uniform in
  [-0.1, 0.1]: within 1e-5 of the largest entry of the twin, a digest of
  enc and g_genc_cot, equal between two trees whose kernels compute the
  same bits, and KA's device time on the same points (the gather alone);
- KN on the published voxel in KC's pose at a train step's shading call:
  1,474,560 lanes (368,640 points, the compaction's budget, x 4 kept
  lanes), the first 38% of the points on rays through the template (one
  valid root a point: 9.5% of the lanes valid, as in the calls that
  ``chip_smoke.py`` records at steps 4,001 and 10,000), or 87% with a
  second root on 30% of the other lanes (41% valid, a busier call), the
  rest the budget's padding at the origin with no root; J^-1 near the
  identity, random cotangents of both terms at the valid lanes and zero
  at the others (as a step's backward gives them): within the rounding
  bound of its own order
  (``deform_skinning_bwd_exact``), bit-equal over two calls, each planted
  fault refused, the bound over the weight rows touched, ``W.t() @ U``'s
  device time, and a digest of d tfs (not equal across a redesign that
  sums in another order);
- KI at the PBR stage's [4096, 160] -> 512 call on ``fine_rows`` (an SDF
  falling through zero on most rays, so draws are pinned; 69% of the draws
  in the background bin): integer outputs equal to the twin's, floats
  within 1e-5 of max(|ref|, 1), and a digest of all seven outputs, equal
  between two trees whose kernels compute the same bits.

A disagreement is printed, the timings go on, and the script exits nonzero
at the end.  The card's name and power limit come first, then each
kernel's registers, stack frame and spills from ``ptxas``.
"""

from __future__ import annotations

import argparse
import itertools
import json
import subprocess
import sys
import time

import numpy as np


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def timings(fn, kernel_substr, reps=20):
    """``(event_ms, device_ms, host_us)`` of ``fn``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    event_ms = start.elapsed_time(end) / reps
    t0 = time.perf_counter()
    for _ in range(200):
        fn()
    host_us = (time.perf_counter() - t0) / 200 * 1e6
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    dev = [e.time_range.elapsed_us() for e in prof.events()
           if e.device_type == DeviceType.CUDA and kernel_substr in e.name]
    device_ms = sum(dev) / len(dev) / 1e3 if dev else None
    return event_ms, device_ms, host_us


def op_device_ms(fn, reps=20, parts=()):
    """The device time of every kernel and copy that ``fn`` runs, a call,
    from ``torch.profiler``; with ``parts``, also ``{part: device ms a
    call}`` of the kernels whose names hold each substring."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    total = sum(e.time_range.elapsed_us() for e in ev) / reps / 1e3
    if not parts:
        return total
    return total, {p: sum(e.time_range.elapsed_us() for e in ev
                          if p in e.name) / reps / 1e3 for p in parts}


def digest_of(tensors):
    """The first 16 hex digits of a sha256 over the tensors' bytes."""
    import hashlib
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def seed_grid(SG, torch, dev, C, res=96, seed=0):
    """A 96^3 grid over a 2 m box: a blob of valid nodes whose roots break
    across a seam, SDF channels when C == 6, packed by the port itself."""
    rng = np.random.default_rng(seed)
    n = np.linspace(-1.0, 1.0, res, dtype=np.float32)
    z, y, x = np.meshgrid(n, n, n, indexing="ij")
    pts = np.stack([x, y, z], -1).reshape(-1, 3)
    r = np.linalg.norm(pts * [1.0, 0.5, 1.5], axis=-1)
    ok = (r < 0.7) & (rng.random(len(pts)) < 0.97)
    xc = 0.4 * pts + 0.01 * rng.normal(size=pts.shape)
    xc[:, 0] += np.where(pts[:, 0] > 0.1, 0.3, 0.0)
    sdf = (r - 0.6).astype(np.float32) if C == 6 else None
    aabb = torch.tensor([[-1.0, -1.1, -0.9], [1.0, 0.9, 1.1]], device=dev)
    return SG.pack_seed_grid(
        torch.as_tensor(xc, dtype=torch.float32, device=dev),
        torch.as_tensor(ok, device=dev),
        None if sdf is None else torch.as_tensor(sdf, device=dev), aabb, res)


def ray_points(torch, dev, rays=4096, samples=64, seed=1):
    """``[rays * samples, 3]`` points in ray order: rays from inside the
    blob outwards, 64 samples each over 1.5 m, as a secondary coarse pass
    lays them out."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-0.5, 0.5, (rays, 1, 3))
    d = rng.normal(size=(rays, 1, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t = np.linspace(0.0, 1.5, samples)[None, :, None]
    return torch.as_tensor((o + t * d).reshape(-1, 3), dtype=torch.float32,
                           device=dev).contiguous()


def ka_points(torch, dev, rays, samples, seed):
    """``[rays * samples, 3]`` points in [0, 1]^3 in ray order: each ray's
    samples over a third of the box, as a chunk's march lays them out."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(0.2, 0.8, (rays, 1, 3))
    d = rng.normal(size=(rays, 1, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t = np.linspace(-0.15, 0.15, samples)[None, :, None]
    return torch.as_tensor((o + t * d).reshape(-1, 3), dtype=torch.float32,
                           device=dev).contiguous()


def search_result(B, torch, dev, N, I, seed):
    """A search's result over ``N`` points of ``I`` lanes: a third of the
    points with no root, a third with 30% of the lanes valid, a third with
    all; 30% of the lanes moved within 2e-5 or 2e-4 of another lane; the
    invalid lanes' x zeroed, as the search leaves them."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1.3, 1.3, (N, I, 3)).astype(np.float32)
    valid = rng.random((N, I)) < rng.choice([0.0, 0.3, 1.0], (N, 1))
    src = rng.integers(0, I, (N, I))
    near = x[np.arange(N)[:, None], src] + rng.normal(
        scale=rng.choice([2e-5, 2e-4], (N, I, 1)), size=(N, I, 3)
    ).astype(np.float32)
    x = np.where((rng.random((N, I)) < 0.3)[..., None], near, x)
    x[~valid] = 0.0
    jinv = rng.normal(size=(N * I, 9)).astype(np.float32)
    return B.BroydenResult(
        x=torch.as_tensor(x.reshape(-1, 3), device=dev),
        j_inv=torch.as_tensor(jinv, device=dev),
        valid=torch.as_tensor(valid.reshape(-1), device=dev))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--port-root", default=None)
    ap.add_argument("--compare-dir", default=None,
                    help="ksk: save each call's rotation rows here and "
                         "report their largest difference from those that "
                         "other port roots saved there")
    ap.add_argument("--kernels",
                    default="ka,kb,kh,km,kc,kb2,ka2,kf,kj,kg,khp,kk,kd,kl,"
                            "ksk,kb1,kn,ki",
                    help="comma-separated, of ka, kb, kh, km, kc, kb2, ka2, "
                         "kf, kj, kg, khp, kk, kd, kl, ksk, kb1, kn, ki")
    ap.add_argument("--diff-digests", nargs=2, metavar=("A", "B"),
                    help="compare the digests of two saved outputs of this "
                         "script, call by call, and time nothing")
    args = ap.parse_args()
    if args.diff_digests:
        sys.exit(diff_digests(*args.diff_digests))
    which = set(args.kernels.split(","))
    import torch
    if not torch.cuda.is_available():
        sys.exit("kernel_timing: needs a CUDA card")
    if args.port_root:
        sys.path.insert(0, args.port_root)
    from chip_smoke import ptxas_info
    from intrinsicavatar_tpu_torch import kernels
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()
    print(f"card: {card}", flush=True)
    root = args.port_root or "."
    sources = {"ka": "hashgrid", "kb": "encode_grad", "kh": "deform",
               "km": "seedgrid", "kc": "broyden", "kb2": "encode_grad",
               "ka2": "hashgrid", "kf": "resample", "kj": "resample",
               "kg": "compact", "khp": "deform", "kk": "march",
               "kd": "volrend", "kl": "broyden", "ksk": "deform",
               "kb1": "encode_grad", "kn": "deform", "ki": "resample"}
    logs = kernels.build_all(tuple(sorted(
        {sources[k] for k in which} & set(kernels.SOURCES))), verbose=True)
    for name, log in logs.items():
        for fn, info in ptxas_info(log).items():
            print(f"ptxas {name} {fn}: {info}", flush=True)

    def report(line):
        print(json.dumps({"root": root, "card": card, **line}), flush=True)

    failed = []
    if "km" in which:
        time_km(torch, dev, kernels, report, failed)
    if "ka" in which:
        time_ka(torch, dev, report, failed)
    if "kh" in which:
        time_kh(torch, dev, report, failed)
    if "kb" in which:
        time_kb(torch, dev, report, failed)
    if "kc" in which:
        time_kc(torch, dev, report, failed)
    if "kb2" in which:
        time_kb2(torch, dev, report, failed)
    if "ka2" in which:
        time_ka2(torch, dev, report, failed)
    if "kf" in which:
        time_kf(torch, dev, report, failed)
    if "kj" in which:
        time_kj(torch, dev, report, failed)
    if "kg" in which:
        time_kg(torch, dev, report, failed)
    if "khp" in which:
        time_khp(torch, dev, report, failed)
    if "kk" in which:
        time_kk(torch, dev, report, failed)
    if "kd" in which:
        time_kd(torch, dev, report, failed)
    if "kl" in which:
        time_kl(torch, dev, report, failed)
    if "ksk" in which:
        time_ksk(torch, dev, report, failed, args.compare_dir, root)
    if "kb1" in which:
        time_kb1(torch, dev, report, failed)
    if "kn" in which:
        time_kn(torch, dev, report, failed)
    if "ki" in which:
        time_ki(torch, dev, report, failed)
    if failed:
        sys.exit(f"kernel_timing: disagrees with the twin: {failed}")


def diff_digests(path_a, path_b):
    """Pair the JSON lines of two runs of this script (with the same
    ``--kernels``, so their calls come in one order), print for each call
    whether its output digest is the same in both (or that the call has
    none), and return 1 if the runs made different calls."""
    def calls(path):
        return [json.loads(s) for s in open(path)
                if s.startswith("{") and '"kernel"' in s]

    a, b = calls(path_a), calls(path_b)
    measured = {"root", "card", "digest"}
    counts = {}
    for x, y in zip(a, b):
        if (x["kernel"], x.get("at")) != (y["kernel"], y.get("at")):
            print(f"diff_digests: the runs part at {x['kernel']} / "
                  f"{y['kernel']}")
            return 1
        call = {k: v for k, v in x.items() if k not in measured
                and not k.endswith(("_ms", "_us", "_err", "relerr"))
                and not isinstance(v, (float, dict))}
        if x.get("digest") is None and y.get("digest") is None:
            verdict = "no digest"
        else:
            verdict = "same" if x["digest"] == y.get("digest") else "DIFF"
        counts[verdict] = counts.get(verdict, 0) + 1
        print(verdict, json.dumps(call), x.get("digest"), y.get("digest"))
    print(f"{len(a)} and {len(b)} calls: {json.dumps(counts)}")
    return int(len(a) != len(b))


def time_ka(torch, dev, report, failed):
    """KA at the serve path's largest call, on uniform random points and at
    a relight fine pass."""
    from intrinsicavatar_tpu_torch.ops import hashgrid as HG
    spec = HG.HashGridSpec(n_levels=16, n_features_per_level=2,
                           log2_hashmap_size=19, include_xyz=True)
    rng = np.random.default_rng(3)
    table = torch.as_tensor(rng.uniform(-0.1, 0.1, (16, 1 << 19, 2)),
                            dtype=torch.float32, device=dev)
    mask = torch.ones(32, device=dev)
    shapes = (
        ("ray-ordered", ka_points(torch, dev, 4096, 288, 4)),
        ("uniform random", torch.as_tensor(
            rng.uniform(0.0, 1.0, (552_960, 3)), dtype=torch.float32,
            device=dev)),
        ("ray-ordered", ka_points(torch, dev, 1024, 64, 5)))
    for order, x in shapes:
        with torch.no_grad():
            out = HG.hashgrid_encode(table, x, spec, mask)
            ref = HG.hashgrid_encode_plain(table, x, spec, mask)
            torch.cuda.synchronize()
            err = (out - ref).abs().max().item()
            tol = 1e-6 + 1e-5 * ref.abs().max().item()
            if not err <= tol:
                print(f"kernel_timing: KA disagrees at {x.shape[0]} "
                      f"{order} points: {err}", flush=True)
                failed.append(f"hashgrid_encode at {x.shape[0]}")
            digest = digest_of([out])
            del out, ref
            ev, dv, hu = timings(
                lambda: HG.hashgrid_encode(table, x, spec, mask),
                "hashgrid_encode_kernel")
        report({"kernel": "hashgrid_encode", "points": x.shape[0],
                "order": order, "max_abs_err": err, "tolerance": tol,
                "digest": digest, "event_ms": ev, "device_ms": dv,
                "host_us": hu})


def time_kh(torch, dev, report, failed):
    """The KH epilogue at a serve chunk's search, the phys step's secondary
    coarse call and the bake's last chunk."""
    import inspect

    from intrinsicavatar_tpu_torch.anim import broyden as B
    I, K = 8, 4
    # a parent's epilogue may take no voxel_J
    skin = 4 if "voxel_J" in inspect.signature(
        B.deform_epilogue).parameters else 3
    for lanes in (6_291_456, 2_097_152, 524_288):
        res = search_result(B, torch, dev, lanes // I, I, seed=lanes % 97)
        args = (res, I, K, False) + (None,) * skin
        out = B.deform_epilogue(*args)
        ref = B.deform_epilogue_plain(*args)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(out[:4], ref[:4])):
            print(f"kernel_timing: the KH epilogue differs at {lanes} lanes",
                  flush=True)
            failed.append(f"deform_epilogue at {lanes}")
        ev, dv, hu = timings(lambda: B.deform_epilogue(*args),
                             "epilogue_kernel")
        report({"kernel": "deform_epilogue", "lanes": lanes, "I": I, "K": K,
                "overflow": int(ref.overflow), "kept_valid":
                int(ref.valid.sum()), "digest": digest_of(out[:4]),
                "event_ms": ev, "device_ms": dv, "host_us": hu})
        del res, out, ref


def time_km(torch, dev, kernels, report, failed):
    from intrinsicavatar_tpu_torch.anim import seedgrid as SG
    pts = ray_points(torch, dev)
    for C in (6, 4):
        grid = seed_grid(SG, torch, dev, C)
        out = SG.gather_from_grid(grid, pts, 3.0)
        ref = SG.gather_from_grid_plain(grid, pts, 3.0)
        torch.cuda.synchronize()
        err = 0.0
        for a, b in ((out[0], ref[0]), (out[2], ref[2])):
            if a is None:
                continue
            d = (a - b).abs()
            if bool((d > 1e-5 * b.abs().clamp(min=1.0)).any()):
                failed.append(f"seed_gather C={C}")
            err = max(err, d.max().item())
        if not torch.equal(out[1], ref[1]):
            failed.append(f"seed_gather C={C} seed_ok")
        ev, dv, hu = timings(lambda: SG.gather_from_grid(grid, pts, 3.0),
                             "seed_gather")
        line = {"kernel": "seed_gather", "C": C, "points": pts.shape[0],
                "seeded": int(ref[1].sum()), "max_abs_err": err,
                "digest": digest_of([t for t in out if t is not None]),
                "event_ms": ev, "device_ms": dv, "host_us": hu}
        if C == 4:
            N = pts.shape[0]
            vox5 = grid.grid[..., :4].permute(3, 0, 1, 2)[None].contiguous()
            g5 = ((pts - grid.center) / grid.half).reshape(1, N, 1, 1, 3)
            lev, ldv, lhu = timings(
                lambda: torch.nn.functional.grid_sample(
                    vox5, g5, mode="bilinear", padding_mode="border",
                    align_corners=True), "grid_sampler")
            line.update(library_event_ms=lev, library_device_ms=ldv,
                        library_host_us=lhu)
        report(line)
        del grid, out, ref

    # where KM's wrapper spends its host time, piece by piece
    grid = seed_grid(SG, torch, dev, 6)
    g, center, half = grid
    fn = kernels.lib("seedgrid").seed_gather_fwd
    pdev = pts.device
    N = pts.shape[0]
    null = (pts.data_ptr(), g.data_ptr(), center.data_ptr(),
            half.data_ptr(), 0, 96, 6, 1.0, 9.0, 0, 0, 0, 0)
    pieces = {
        "wrapper": lambda: SG.gather_from_grid(grid, pts, 3.0),
        "new_empty": lambda: pts.new_empty((N, 3)),
        "torch_empty": lambda: torch.empty((N, 3), dtype=torch.float32,
                                           device=pdev),
        "stream_ptr": lambda: kernels.stream_ptr(pdev),
        "current_stream": lambda: torch.cuda.current_stream(
            pdev).cuda_stream,
        "ctypes_call_n0": lambda: fn(*null),
    }
    host = {}
    for name, f in pieces.items():
        f()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(500):
            f()
        host[name] = (time.perf_counter() - t0) / 500 * 1e6
        torch.cuda.synchronize()
    report({"kernel": "seed_gather", "host_us_by_piece": host})
    del grid, g


def time_kb(torch, dev, report, failed):
    from intrinsicavatar_tpu_torch.nets.mlp import VanillaMLP
    from intrinsicavatar_tpu_torch.ops import encode_grad as EG
    from intrinsicavatar_tpu_torch.ops import hashgrid as HG
    spec = HG.HashGridSpec(n_levels=16, n_features_per_level=2,
                           log2_hashmap_size=19, include_xyz=True)
    rng = np.random.default_rng(2)
    table = torch.as_tensor(rng.uniform(-0.1, 0.1, (16, 1 << 19, 2)),
                            dtype=torch.float32, device=dev)
    mask = torch.ones(32, device=dev)
    mlp = VanillaMLP(35, 13, n_neurons=64, n_hidden_layers=1,
                     sphere_init=True, weight_norm=True).to(dev)
    mlp.init(torch.Generator().manual_seed(0))
    # noise on every weight: the sphere init zeroes the first layer's rows
    # of the hash features, which would hide the encode from the check
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for p in mlp.parameters():
            p.add_(0.3 * torch.randn(p.shape, generator=gen).to(dev))
    for N in (552_960, 65_536):
        x = torch.as_tensor(rng.uniform(0.0, 1.0, (N, 3)),
                            dtype=torch.float32, device=dev)
        with torch.no_grad():
            fk, gk = EG.encode_mlp_sdfgrad(spec, mlp, table, x, mask)
            fp, gp = EG.encode_mlp_sdfgrad_plain(
                spec, mlp, table, x, mask, mlp.effective_weights())
            torch.cuda.synchronize()
            err = max((fk - fp).abs().max().item(),
                      (gk - gp).abs().max().item())
            scale = max(1.0, fp.abs().max().item(), gp.abs().max().item())
            if not err <= 1e-4 * scale:
                print(f"kernel_timing: KB disagrees at {N}: {err}",
                      flush=True)
                failed.append(f"encode_mlp_sdfgrad at {N}")
            ev, dv, hu = timings(
                lambda: EG.encode_mlp_sdfgrad(spec, mlp, table, x, mask),
                "encode_mlp_sdfgrad_kernel")
            # KA on the same points and table: the gather alone
            kev, kdv, _ = timings(
                lambda: HG.hashgrid_encode(table, x, spec, mask),
                "hashgrid_encode_kernel")
        report({"kernel": "encode_mlp_sdfgrad", "points": N,
                "max_abs_err": err, "tolerance": 1e-4 * scale,
                "digest": digest_of([fk, gk]),
                "event_ms": ev, "device_ms": dv, "host_us": hu,
                "hashgrid_encode_event_ms": kev,
                "hashgrid_encode_device_ms": kdv})


def body_rays(torch, dev, verts, rays, samples, seed, span):
    """``[rays * samples, 3]`` points in ray order: rays through random
    vertices of the posed body, samples over ``span`` m on each side of
    the vertex: 1.0 lays a chunk's samples through the box (most lanes in
    empty space: on the synthetic body a quarter of the lanes converge
    and three quarters stop after one step, as at the recorded calls),
    0.3 mostly near the surface."""
    rng = np.random.default_rng(seed)
    hit = verts[rng.choice(len(verts), rays)][:, None, :]
    d = rng.normal(size=(rays, 1, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t = np.linspace(-span, span, samples)[None, :, None]
    return torch.as_tensor((hit + t * d).reshape(-1, 3), dtype=torch.float32,
                           device=dev).contiguous()


def posed_body(torch, dev):
    """The synthetic body's rigid deformer (the published 32 x 128 x 128
    voxel) in a pose: ``(deformer, statics, frame, posed vertices, the init
    bones' transforms)``."""
    from intrinsicavatar_tpu_torch.anim import broyden as B
    from intrinsicavatar_tpu_torch.anim.deformer import FastSNARF
    from intrinsicavatar_tpu_torch.utils.config import wrap
    rigid = FastSNARF(wrap({"name": "fast-snarf", "model_path": "synthetic",
                            "deformer_config": {"resolution": 128}}))
    statics = rigid.initialize(np.zeros(10), dev)
    pose = np.zeros(69, np.float32)
    pose[2], pose[5], pose[52] = 0.4, -0.4, 0.9
    z = lambda n: torch.zeros(1, n, device=dev)
    frame = rigid.prepare(statics, {
        "betas": torch.zeros(10, device=dev),
        "body_pose": torch.as_tensor(pose, device=dev),
        "global_orient": torch.zeros(3, device=dev),
        "transl": torch.tensor([0.0, 0.3, 2.0], device=dev),
        "betas_correction": z(10), "pose_correction": z(69),
        "global_orient_correction": z(3), "transl_correction": z(3)})
    tfs = frame.tfs[torch.as_tensor(B.INIT_BONES, device=dev)].contiguous()
    return rigid, statics, frame, frame.vertices.cpu().numpy(), tfs


def time_kc(torch, dev, report, failed):
    """KC at a serve chunk's search and at the phys step's secondary coarse
    call."""
    import inspect

    from intrinsicavatar_tpu_torch.anim import broyden as B
    rigid, statics, frame, verts, tfs = posed_body(torch, dev)
    I = rigid.n_init
    hook = "lane_counts" in inspect.signature(
        B.broyden_search_plain).parameters
    for (rays, samples), span in itertools.product(
            ((4096, 192), (4096, 64)), (1.0, 0.3)):
        pts = body_rays(torch, dev, verts, rays, samples, samples, span)
        slot = B.deform_prologue(pts, tfs, statics.seg_table, I)
        args = (torch.repeat_interleave(pts, I, dim=0).contiguous(), slot,
                frame.voxel_J, tfs, rigid.spec.offset,
                rigid.spec.scale_kernel)
        out = B.broyden_search(*args)
        # a parent's tree may predate the twin's lane_counts: no histogram
        counts = [] if hook else None
        ref = B.broyden_search_plain(
            *args, **({"lane_counts": counts} if hook else {}))
        torch.cuda.synchronize()
        M = args[0].shape[0]
        # lanes that ran exactly k iterations, k = 0 .. max_iters
        hist = (torch.bincount(counts[0].to(torch.int64), minlength=11)
                .tolist() if hook else None)
        samples = M + int(counts[0].sum()) if hook else None
        both = out.valid & ref.valid
        flip = (out.valid != ref.valid).float().mean().item()
        err = max((out.x - ref.x)[both].abs().max().item(),
                  (out.j_inv - ref.j_inv)[both].abs().max().item())
        if not (err <= 1e-4 and flip <= 1e-3):
            print(f"kernel_timing: KC disagrees at {M} lanes: err={err} "
                  f"flipped={flip}", flush=True)
            failed.append(f"broyden_search at {M}")
        digest = digest_of((out.x, out.j_inv, out.valid))
        valid = out.valid.float().mean().item()
        del out, ref, both, counts
        ev, dv, hu = timings(lambda: B.broyden_search(*args),
                             "broyden_search_kernel")
        report({"kernel": "broyden_search", "lanes": M, "span_m": span,
                "valid": valid,
                "iterations_hist": hist,
                "samples": samples,
                "flipped": flip, "max_abs_err": err,
                "digest": digest, "event_ms": ev,
                "device_ms": dv, "host_us": hu})
        del args, slot, pts


def time_kb2(torch, dev, report, failed):
    """KB' pass 2 at a train step's shading call (no d_xn) and its
    curvature call (d_xn)."""
    from intrinsicavatar_tpu_torch.ops import encode_grad as EG
    from intrinsicavatar_tpu_torch.ops import hashgrid as HG
    spec = HG.HashGridSpec(n_levels=16, n_features_per_level=2,
                           log2_hashmap_size=19, include_xyz=True)
    rng = np.random.default_rng(6)
    table = torch.as_tensor(rng.uniform(-0.1, 0.1, (16, 1 << 19, 2)),
                            dtype=torch.float32, device=dev)
    mask = torch.ones(32, device=dev)
    for rays, samples, need_x in ((4096, 135, False), (1024, 90, True)):
        x = ka_points(torch, dev, rays, samples, seed=samples)
        N = x.shape[0]
        g_grad, d_enc, g_enc = (torch.as_tensor(
            rng.normal(size=(N, w)), dtype=torch.float32, device=dev)
            for w in (3, spec.n_output_dims, spec.n_output_dims))
        args = (spec, table, x, mask, g_grad, d_enc, g_enc, need_x)
        out = EG.encode_mlp_sdfgrad_bwd_scatter(*args)
        ref = EG.encode_mlp_sdfgrad_bwd_scatter_plain(*args)
        torch.cuda.synchronize()
        errs = []
        for a, b in list(zip(out, ref))[:2 if need_x else 1]:
            excess = ((a - b).abs() - 1e-4 * b.abs()).clamp(min=0.0)
            errs.append(excess.max().item() / b.abs().max().item())
        if not max(errs) <= 1e-5:
            print(f"kernel_timing: KB' pass 2 disagrees at {N}: {errs}",
                  flush=True)
            failed.append(f"encode_mlp_sdfgrad_bwd_scatter at {N}")
        # the table's cotangent is added in the order the atomics land:
        # only d_xn has a digest
        digest = digest_of([out[1]]) if need_x else None
        del out, ref
        ev, dv, hu = timings(lambda: EG.encode_mlp_sdfgrad_bwd_scatter(*args),
                             "encode_mlp_sdfgrad_bwd_scatter_kernel")
        report({"kernel": "encode_mlp_sdfgrad_bwd_scatter", "points": N,
                "d_xn": need_x, "relerr": errs, "digest": digest,
                "event_ms": ev,
                "device_ms": dv, "host_us": hu})



def compacted_points(torch, dev, n, seed):
    """``(x [n, 3], padded [n])`` as a train step's radiance call lays its
    points out (as recorded on the card): uniform over the body's box in [0,
    1]^3 and, at 62% of the slots chosen at random, the padding point."""
    rng = np.random.default_rng(seed)
    x = rng.uniform([0.0, 0.11, 0.375], [0.9, 1.0, 0.625], (n, 3))
    pad = rng.random(n) < 0.62
    x[pad] = [0.4962, 0.5672, 0.4930]
    return (torch.as_tensor(x, dtype=torch.float32, device=dev),
            torch.as_tensor(pad, device=dev))


def time_ka2(torch, dev, report, failed):
    """KA' at a train step's radiance call, without and with d_x."""
    from intrinsicavatar_tpu_torch.ops import hashgrid as HG
    spec = HG.HashGridSpec(n_levels=16, n_features_per_level=2,
                           log2_hashmap_size=19, include_xyz=True)
    rng = np.random.default_rng(8)
    table = torch.as_tensor(rng.uniform(-0.1, 0.1, (16, 1 << 19, 2)),
                            dtype=torch.float32, device=dev)
    mask = torch.ones(32, device=dev)
    x = ka_points(torch, dev, 4096, 90, seed=90)
    N = x.shape[0]
    g = torch.as_tensor(rng.normal(size=(N, spec.n_output_dims)),
                        dtype=torch.float32, device=dev)
    xc, pad = compacted_points(torch, dev, N, seed=91)
    gc = torch.where(pad[:, None], 0.0, g)
    for (order, x, g), need_x in itertools.product(
            (("ray-ordered", x, g), ("compacted", xc, gc)), (False, True)):
        args = (table, x, spec, g, mask, need_x)
        out = HG.hashgrid_encode_bwd(*args)
        ref = HG.hashgrid_encode_bwd_plain(*args)
        torch.cuda.synchronize()
        errs = []
        for a, b, rtol in list(zip(out, ref, (1e-4, 1e-4)))[
                :2 if need_x else 1]:
            excess = ((a - b).abs() - rtol * b.abs()).clamp(min=0.0)
            errs.append(excess.max().item() / b.abs().max().item())
        if not max(errs) <= 1e-5:
            print(f"kernel_timing: KA' disagrees at {N}: {errs}", flush=True)
            failed.append(f"hashgrid_encode_bwd at {N}")
        line = {"kernel": "hashgrid_encode_bwd", "points": N,
                "order": order, "d_x": need_x, "relerr": errs}
        if need_x:
            again = HG.hashgrid_encode_bwd(*args)[1]
            line.update(digest=digest_of([out[1]]),
                        repeat_equal=bool(torch.equal(out[1], again)))
            del again
        del out, ref
        call = lambda: HG.hashgrid_encode_bwd(*args)
        ev, dv, hu = timings(call, "hashgrid_encode_bwd_kernel")
        line.update(event_ms=ev, device_ms=dv, op_device_ms=op_device_ms(
            call), host_us=hu)
        report(line)


def kf_rounds(torch, dev, G, RS, R=4096, S=128, res=64, seed=11):
    """The two importance rounds' inputs of an ``R``-ray chunk: the march's
    [R, S + 1] edges and their weights, then the twin's merge of them with
    16 draws and new weights."""
    rng = np.random.default_rng(seed)
    ang = rng.uniform(0, 2 * np.pi, R)
    o = np.stack([2.5 * np.cos(ang), rng.uniform(-0.5, 0.5, R),
                  2.5 * np.sin(ang)], -1)
    d = rng.uniform(-0.8, 0.8, (R, 3)) - o
    d[: R // 4] *= -1.0                                 # a quarter miss
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    aabb = [-1.0, -1.2, -0.9, 1.1, 1.0, 1.3]
    diag = float(np.linalg.norm(np.subtract(aabb[3:], aabb[:3])))
    t = lambda a, dt=torch.float32: torch.as_tensor(
        np.ascontiguousarray(a), dtype=dt, device=dev)
    iv = G.occupancy_sampling_plain(
        t(o), t(d), t(rng.random((res,) * 3) < 0.3, torch.bool), t(aabb),
        diag / S, S, stratified_u=t(rng.random(R)))

    def bump(valid):
        # around a point among the ray's valid edges
        E = valid.shape[1]
        c = rng.uniform(0, 1, (R, 1)) * valid.sum(-1, keepdims=True).cpu(
            ).numpy()
        w = np.exp(-0.5 * ((np.arange(E)[None, :] - c) / 3.0) ** 2)
        w *= rng.choice([0.0, 0.5, 1.0, 1.5], (R, 1)) / w.sum(-1,
                                                               keepdims=True)
        return t(w + 1e-4 * rng.random((R, E)))

    w1 = bump(iv.valid)
    m = RS.merge_resample_rays_plain(iv.vals, iv.is_left, iv.is_right,
                                     iv.valid, w1, 16)
    w2 = bump(m.valid)
    return ((iv.vals, iv.is_left, iv.is_right, iv.valid, w1, 16),
            (m.vals, m.is_left, m.is_right, m.valid, w2, 16))


def kf_draw_bound(RS, args, ref):
    """``[R, E + B]``: how far each merged value of KF may lie from the
    twin's on the card (see ``time_kf``).  A draw's t = t0 + (u - c_lo)
    (t1 - t0) / seg reads the CDF; the twin's float32 cumsum on the card
    and KF's double prefix sum rounded once differ by at most (E + 3) eps
    c_hi in c_lo and as much again in seg, and t moves by that times
    |t1 - t0| / seg: 2 (E + 3) eps c_hi |t1 - t0| / seg, plus 4 eps |t| for
    t's own rounding.  An old edge is a copy: 0."""
    import torch
    vals, is_left, is_right, valid, weights, B = args
    R, E = vals.shape
    eps = 2.0 ** -24
    d = lambda a: a.to(torch.float64)
    steps = valid.sum(-1)
    last = torch.clamp(steps - 1, min=0)[:, None]
    nxt_valid = torch.roll(valid, -1, 1)
    nxt_valid[:, -1] = False
    real = valid & nxt_valid & is_left & torch.roll(is_right, -1, 1)
    w = torch.where(real, weights, 0.0)
    wsum = w.sum(-1, keepdim=True)
    denom = wsum + torch.clamp(1.0 - wsum, min=0.0)
    cdf = torch.cumsum(w, -1) / denom
    u = RS.uniform_bins(B, vals.dtype, vals.device)[None].expand(R, B)
    idx = torch.minimum(torch.searchsorted(cdf.contiguous(), u.contiguous(),
                                           right=True), last)
    g = lambda a, i: torch.gather(a, 1, i)
    t0 = g(vals, idx)
    t1 = g(vals, torch.clamp(idx + 1, max=E - 1))
    c_hi = g(cdf, idx)
    seg = torch.clamp(c_hi - g(cdf - w / denom, idx), min=1e-20)
    # |t| <= max(|t0|, |t1|) where u lies in the interval's bracket
    draw = (4 * eps * torch.maximum(d(t0).abs(), d(t1).abs())
            + 2 * (E + 3) * eps * d(c_hi).abs() * d(t1 - t0).abs()
            / d(seg))
    bound = torch.zeros(ref.vals.shape, dtype=torch.float64,
                        device=vals.device)
    new = ref.gather_idx >= E
    bound[new] = torch.gather(draw, 1, torch.clamp(ref.gather_idx - E, 0,
                                                   B - 1))[new]
    return bound, draw


def time_kf(torch, dev, report, failed):
    """KF at a 4,096-ray chunk's two importance rounds: flags and indices
    equal to the twin's on at least 0.999 of the rays, and on those rays
    each merged value within ``kf_draw_bound`` of the twin's (the twin
    sums its CDF in float32 on the card, KF in double rounded once; a
    flat stretch of the CDF amplifies the difference), and beside it the
    same comparison with the twin on the CPU, whose cumsum sums in double
    as KF does."""
    from intrinsicavatar_tpu_torch.ops import grid_traversal as G
    from intrinsicavatar_tpu_torch.ops import resample as RS
    for rnd, args in enumerate(kf_rounds(torch, dev, G, RS)):
        out = RS.merge_resample_rays(*args)
        ref = RS.merge_resample_rays_plain(*args)
        cpu = RS.merge_resample_rays_plain(
            *(a.cpu() if torch.is_tensor(a) else a for a in args))
        torch.cuda.synchronize()
        R, E = args[0].shape

        def agree(ref):
            same = torch.ones(R, dtype=torch.bool, device=ref.vals.device)
            for a, b in list(zip(out, ref))[1:]:
                same &= (a.to(b.device) == b).all(-1)
            d = (out.vals.to(ref.vals.device) - ref.vals).abs()
            return same, torch.where(same[:, None] & ref.valid, d, 0.0)

        same, diff = agree(ref)
        share = same.float().mean().item()
        bound, draw = kf_draw_bound(RS, args, ref)
        # the draws that are not placed (+inf on both sides) have no bound
        held = same[:, None] & ref.valid
        ratio = (diff.double()[held] / bound[held].clamp(min=1e-30)).max(
            ).item() if bool(held.any()) else 0.0
        over = diff > 1e-5
        cpu_same, cpu_diff = agree(cpu)
        if not (share >= 0.999 and ratio <= 1.0):
            print(f"kernel_timing: KF disagrees at [{R}, {E}]: {share} of "
                  f"rays equal, worst error / bound {ratio}", flush=True)
            failed.append(f"merge_resample at [{R}, {E}]")
        line = {"kernel": "merge_resample", "round": rnd + 1, "rays": R,
                "edges": E, "draws": args[5], "equal_share": share,
                "placed": int(ref.is_new.sum()),
                "max_abs_err": diff.max().item(), "err_over_bound": ratio,
                # the values more than 1e-5 off: how many, and how flat
                # the CDF is there (the largest |t1 - t0| / seg bound)
                "over_1e-5": int(over.sum()),
                "over_1e-5_largest_bound": bound[over].max().item()
                if bool(over.any()) else None,
                "cpu_equal_share": cpu_same.float().mean().item(),
                "cpu_max_abs_err": cpu_diff.max().item(),
                "digest": digest_of(out)}
        del out, ref, cpu, diff, bound, draw
        ev, dv, hu = timings(lambda: RS.merge_resample_rays(*args),
                             "merge_resample_kernel")
        line.update(event_ms=ev, device_ms=dv, host_us=hu)
        report(line)


def fine_rows(R, S, seed):
    """``(t_starts, t_ends, alphas, weights, sdfs, mask)``, ``[R, S]``, as a
    shader chunk's march and coarse pass give them: each ray's valid samples
    left-packed (none on a sixth of the rays), t ascending with gaps,
    alphas and weights in [0, 1) (some rows over unit mass), an SDF falling
    through zero, rising on a fifth of the rays (no + to - crossing)."""
    rng = np.random.default_rng(seed)
    n = rng.integers(0, S + 1, R)
    n[rng.random(R) < 1.0 / 6.0] = 0
    mask = np.arange(S)[None] < n[:, None]
    dt = rng.uniform(0.005, 0.03, (R, S))
    ts = np.cumsum(dt, 1) + rng.uniform(0.0, 1.0, (R, 1))
    te = ts + dt * rng.uniform(0.3, 1.0, (R, S))
    alphas = rng.uniform(0.0, 1.0, (R, S)) ** 2
    w = rng.uniform(0.0, 1.0, (R, S))
    w = w / w.sum(1, keepdims=True) * rng.uniform(0.2, 1.3, (R, 1))
    sdf = rng.uniform(0.1, 0.6, (R, 1)) - np.cumsum(
        rng.uniform(0.0, 0.05, (R, S)), 1)
    sdf[rng.random(R) < 0.2] *= -1.0
    z = lambda a: np.where(mask, a, 0.0).astype(np.float32)
    return z(ts), z(te), z(alphas), z(w), sdf.astype(np.float32), mask


def time_kj(torch, dev, report, failed):
    """KJ at a shader chunk's call in both modes, at 64 and 16 slots."""
    from intrinsicavatar_tpu_torch.ops import resample as RS
    R, n = 32768, 4
    for S in (64, 16):
        ts, te, alphas, w, sdf, mask = (
            torch.as_tensor(a, device=dev) for a in fine_rows(R, S, seed=S))
        for mode in ("sdf", "plain"):
            if mode == "sdf":
                args = (ts, te, alphas, sdf, mask, n)
                fn, plain = (RS.sdf_fine_resample_rays,
                             RS.sdf_fine_resample_rays_plain)
            else:
                args = (ts, te, w, mask, n)
                fn, plain = RS.fine_resample_rays, RS.fine_resample_rays_plain
            out, ref = fn(*args), plain(*args)
            torch.cuda.synchronize()
            err = 0.0
            ok = torch.equal(out.mask, ref.mask)
            for a, b in ((out.t_starts, ref.t_starts),
                         (out.t_ends, ref.t_ends)):
                d, r = (a - b).abs()[ref.mask], b.abs()[ref.mask]
                ok &= bool((d <= 1e-5 * r.clamp(min=1.0)).all())
                err = max(err, d.max().item() if d.numel() else 0.0)
            if not ok:
                print(f"kernel_timing: KJ disagrees at [{R}, {S}] {mode}: "
                      f"err={err}", flush=True)
                failed.append(f"fine_resample [{R}, {S}] {mode}")
            line = {"kernel": "fine_resample", "rays": R, "slots": S,
                    "n": n, "mode": mode, "placed": int(ref.mask.sum()),
                    "max_abs_err": err, "digest": digest_of(out)}
            del out, ref
            ev, dv, hu = timings(lambda: fn(*args), "fine_resample_kernel")
            line.update(event_ms=ev, device_ms=dv, host_us=hu)
            report(line)


def time_kg(torch, dev, report, failed):
    """KG at the secondary coarse call and the serve path's candidate
    call."""
    from intrinsicavatar_tpu_torch.ops import compact as C
    rng = np.random.default_rng(12)
    R, S = 32768, 64
    runs = np.where(rng.random(R) < 0.964, 0, rng.integers(1, 33, R))
    coarse = torch.as_tensor(np.arange(S)[None] < runs[:, None], device=dev)
    kept = rng.choice(5, 786_432, p=[0.45, 0.2, 0.15, 0.1, 0.1])
    cand = torch.as_tensor((np.arange(4)[None] < kept[:, None]).reshape(-1),
                           device=dev)
    for where, mask, budget, fn in (
            ("secondary coarse call", coarse, 262_144,
             C.compact_indices_interleaved),
            ("candidate call", cand, 1_179_648, C.compact_indices)):
        out = fn(mask, budget)
        ref = C.compact_indices_plain(mask, budget, mask.dim() == 2)
        torch.cuda.synchronize()
        if not (torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1])):
            print(f"kernel_timing: KG differs from its twin at the {where}",
                  flush=True)
            failed.append(f"compact_indices at the {where}")
        line = {"kernel": "compact_indices", "at": where,
                "mask": list(mask.shape), "budget": budget,
                "valid": int(mask.sum()), "digest": digest_of(out)}
        del out, ref
        call = lambda: fn(mask, budget)
        ev, dv, hu = timings(call, "scatter_")
        total, parts = op_device_ms(call, parts=("count_", "scatter_"))
        line.update(event_ms=ev, op_device_ms=total,
                    count_device_ms=parts["count_"],
                    scatter_device_ms=parts["scatter_"], host_us=hu)
        report(line)


def coarse_call_points(verts, R=32768, S=64, budget=262_144, seed=13):
    """``[budget, 3]`` points as the phys step's secondary coarse call lays
    them out: a shader chunk's R secondary rays are 64 primary rays' 512
    scattering points each, drawn within 2 cm of a surface point along its
    primary ray in t order; S samples a secondary ray (t_starts 0 at an
    unmasked slot, so such a sample sits at its ray's origin), ~3.6% of the
    rays with a run of 1-32 masked samples (~7.5% of the budget),
    compacted sample-major: the valid samples first, then the padded
    slots in the same order."""
    rng = np.random.default_rng(seed)
    n = R // 512
    hit = verts[rng.choice(len(verts), n)]
    view = rng.normal(size=(n, 3))
    view /= np.linalg.norm(view, axis=-1, keepdims=True)
    t = np.sort(rng.uniform(-0.02, 0.02, (n, 512)), axis=1)
    o = (hit[:, None] + t[..., None] * view[:, None]).reshape(R, 3)
    d = rng.normal(size=(R, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    runs = np.where(rng.random(R) < 0.964, 0, rng.integers(1, 33, R))
    mask = np.arange(S)[None] < runs[:, None]
    ts = np.where(mask, 0.02 + (1.5 / 63) * np.arange(S)[None], 0.0)
    flat = mask.T.reshape(-1)                       # sample-major
    order = np.concatenate([np.flatnonzero(flat), np.flatnonzero(~flat)])
    idx = order[:budget]
    ray, k = idx % R, idx // R
    pts = o[ray] + d[ray] * ts[ray, k][:, None]
    return pts.astype(np.float32), int(mask.sum())


def time_khp(torch, dev, report, failed):
    """The KH prologue at a serve chunk's search and at the phys step's
    secondary coarse call."""
    from intrinsicavatar_tpu_torch.anim import broyden as B
    rigid, statics, _, verts, tfs = posed_body(torch, dev)
    I, segs = rigid.n_init, statics.seg_table
    coarse, valid = coarse_call_points(verts)
    for where, pts, n_valid in (
            ("serve search", body_rays(torch, dev, verts, 4096, 192, 192,
                                       1.0), None),
            ("phys secondary coarse call", torch.as_tensor(coarse,
                                                           device=dev),
             valid)):
        out = B.deform_prologue(pts, tfs, segs, I)
        ref = B.deform_prologue_plain(pts, tfs, segs, I)
        torch.cuda.synchronize()
        if not torch.equal(out, ref):
            print(f"kernel_timing: the KH prologue differs from its twin at "
                  f"the {where}", flush=True)
            failed.append(f"deform_prologue at the {where}")
        line = {"kernel": "deform_prologue", "at": where,
                "points": pts.shape[0], "valid_points": n_valid,
                "bones": tfs.shape[0], "I": I, "digest": digest_of([out])}
        del out, ref
        call = lambda: B.deform_prologue(pts, tfs, segs, I)
        ev, dv, hu = timings(call, "prologue_kernel")
        line.update(event_ms=ev, device_ms=dv, op_device_ms=op_device_ms(
            call), host_us=hu)
        report(line)


def kk_inputs(torch, dev, R, seed=14, res=64):
    """A shader chunk's secondary rays: from scattering points on a
    body-shaped blob of a 64^3 occupancy grid, a third of them pointing
    into it, about 60% active, the last 2% a padded chunk's rays (origin 0,
    direction 1, inactive); near 0, far 1.5."""
    rng = np.random.default_rng(seed)
    aabb = np.asarray([-1.25, -1.55, -1.25, 1.25, 0.95, 1.25], np.float32)
    c = (np.arange(res) + 0.5) / res
    X, Y, Z = np.meshgrid(*(aabb[a] + c * (aabb[3 + a] - aabb[a])
                            for a in range(3)), indexing="ij")
    axes = np.asarray([0.45, 1.1, 0.3])
    grid = ((X / axes[0]) ** 2 + ((Y + 0.3) / axes[1]) ** 2
            + (Z / axes[2]) ** 2) < 1.0
    n = rng.normal(size=(R, 3))
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    o = n * axes + [0.0, -0.3, 0.0]                 # on the blob's surface
    d = rng.normal(size=(R, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    out = (d * n).sum(-1, keepdims=True)
    d = np.where(rng.random((R, 1)) < 1.0 / 3.0, -np.sign(out) * d,
                 np.sign(out) * d)
    active = rng.random(R) < 0.6
    pad = R - R // 50
    o[pad:], d[pad:], active[pad:] = 0.0, 1.0, False
    t = lambda a, dt=torch.float32: torch.as_tensor(
        np.ascontiguousarray(a), dtype=dt, device=dev)
    return (t(o), t(d), t(grid, torch.bool), t(aabb), t(np.zeros(R)),
            t(np.full(R, 1.5)), t(active, torch.bool))


def time_kk(torch, dev, report, failed):
    """KK at a shader chunk's call (cap 8 and cap 0) and at 16 steps."""
    from intrinsicavatar_tpu_torch.ops import grid_traversal as G
    R = 32768
    o, d, grid, aabb, near, far, active = kk_inputs(torch, dev, R)
    for S, cap in ((64, 8), (64, 0), (16, 8)):
        args = (o, d, grid, aabb, 1.5 / (S - 1), S, near, far, active, cap)
        out = G.secondary_march(*args)
        ref = G.secondary_march_plain(*args)
        torch.cuda.synchronize()
        err = max((out[0] - ref[0]).abs().max().item(),
                  (out[1] - ref[1]).abs().max().item())
        if not (torch.equal(out[2], ref[2]) and err <= 1e-6):
            print(f"kernel_timing: KK disagrees at [{R}, {S}] cap {cap}: "
                  f"err={err}", flush=True)
            failed.append(f"secondary_march [{R}, {S}] cap {cap}")
        line = {"kernel": "secondary_march", "rays": R, "steps": S,
                "cap": cap, "masked": int(ref[2].sum()),
                "max_abs_err": err, "digest": digest_of(out)}
        del out, ref
        call = lambda: G.secondary_march(*args)
        ev, dv, hu = timings(call, "secondary_march_kernel")
        line.update(event_ms=ev, device_ms=dv, op_device_ms=op_device_ms(
            call), host_us=hu)
        report(line)


def kd_rows(torch, dev, R, S, seed):
    """``[R, S]`` alphas and mask: alphas in [0, 0.3] with 5% zeros and 1%
    ones, 70% of the slots valid, a sixth of the rows fully masked, NaN at
    the masked slots."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.0, 0.3, (R, S)).astype(np.float32)
    a[rng.random((R, S)) < 0.05] = 0.0
    a[rng.random((R, S)) < 0.01] = 1.0
    m = rng.random((R, S)) < 0.7
    m[rng.random(R) < 1 / 6] = False
    a[~m] = np.nan
    return (torch.as_tensor(a, device=dev), torch.as_tensor(m, device=dev))


def time_kd(torch, dev, report, failed):
    """KD weights at a shader chunk's call and the importance rounds'."""
    from intrinsicavatar_tpu_torch.ops import volrend as V
    for R, S in ((32768, 4), (4096, 129), (4096, 145)):
        alphas, mask = kd_rows(torch, dev, R, S, seed=20 + S)
        w, t = V.render_weight_from_alpha(alphas, mask)
        w_r, t_r = V.render_weight_from_alpha_plain(alphas, mask)
        torch.cuda.synchronize()
        err = max((w - w_r).abs().max().item(), (t - t_r).abs().max().item())
        close = all(torch.allclose(a, b, rtol=1e-5, atol=1e-6)
                    for a, b in ((w, w_r), (t, t_r)))
        if not close:
            print(f"kernel_timing: KD weights disagrees at [{R}, {S}]: "
                  f"err={err}", flush=True)
            failed.append(f"volrend_weights [{R}, {S}]")
        line = {"kernel": "volrend_weights", "shape": [R, S],
                "max_abs_err": err, "digest": digest_of((w, t)),
                "bound_ms": R * S * 13 / 3.35e12 * 1e3}
        ev, dv, hu = timings(lambda: V.render_weight_from_alpha(alphas, mask),
                             "weights_kernel")
        line.update(event_ms=ev, device_ms=dv, host_us=hu)
        report(line)


# the share of a fine pass's 65,536-point budget that KL's calls seeded,
# a call on average (chip_smoke.py on an NVIDIA H100 80GB HBM3, 700 W: a
# phys step's 1,222.5 over 192 calls; a relight chunk's 1.4 over 64, the
# busiest 11)
KL_FINE_SEEDED = 1222.5 / 65536
KL_RELIGHT_SEEDED = 11 / 65536


def kl_inputs(torch, dev, B, body, M, seeded, front, seed):
    """KL's arguments over ``M`` points: targets skinned from canonical
    points near the template's surface, ``seeded`` of them seeded at their
    canonical point moved by ~1 cm, first (``front``, as a compacted fine
    pass lays them out; the rest padding at the origin) or at random."""
    rigid, statics, frame, verts, tfs = body
    rng = np.random.default_rng(seed)
    n = int(round(M * seeded))
    vs = statics.vs_template.cpu().numpy()
    xc = torch.as_tensor(vs[rng.choice(len(vs), M)]
                         + rng.normal(scale=0.02, size=(M, 3)),
                         dtype=torch.float32, device=dev)
    w = B.grid_sample_3d(statics.lbs_cl, rigid.spec.shape_dhw,
                         rigid.spec.normalize(xc), padding="border")
    xd, _ = B.forward_skinning(xc, w, frame.tfs)
    if front:
        xd[n:] = 0.0
        ok = np.arange(M) < n
    else:
        ok = np.zeros(M, bool)
        ok[rng.choice(M, n, replace=False)] = True
    seed_xc = xc + torch.as_tensor(rng.normal(scale=0.01, size=(M, 3)),
                                   dtype=torch.float32, device=dev)
    return (xd.contiguous(), seed_xc.contiguous(),
            torch.as_tensor(ok, device=dev), frame.voxel_J,
            rigid.spec.offset, rigid.spec.scale_kernel)


def time_kl(torch, dev, report, failed):
    """KL at a phys step's fine pass, a grid-seeded shading pass and with
    every point seeded."""
    import inspect

    from intrinsicavatar_tpu_torch.anim import broyden as B
    body = posed_body(torch, dev)
    hook = "lane_counts" in inspect.signature(
        B.broyden_polish_plain).parameters
    for where, M, seeded, front, iters in (
            ("phys fine pass", 65536, KL_FINE_SEEDED, True, 4),
            ("relight fine pass", 65536, KL_RELIGHT_SEEDED, True, 6),
            ("grid-seeded shading pass", 368640, 0.37, False, 6),
            ("every point seeded", 65536, 1.0, False, 4),
            ("no point seeded", 65536, 0.0, True, 4)):
        args = kl_inputs(torch, dev, B, body, M, seeded, front, seed=M)
        out = B.broyden_polish(*args, max_iters=iters)
        counts = [] if hook else None
        ref = B.broyden_polish_plain(
            *args, max_iters=iters,
            **({"lane_counts": counts} if hook else {}))
        torch.cuda.synchronize()
        err = max(((a - b).abs().max() / b.abs().max().clamp(min=1e-30))
                  .item() for a, b in ((out.x, ref.x),
                                       (out.j_inv, ref.j_inv)))
        if not (torch.equal(out.valid, ref.valid) and err <= 1e-5):
            print(f"kernel_timing: KL disagrees at the {where}: err={err}",
                  flush=True)
            failed.append(f"broyden_polish at the {where}")
        line = {"kernel": "broyden_polish", "at": where, "lanes": M,
                "seeded": int(args[2].sum()), "max_iters": iters,
                "valid": int(out.valid.sum()), "max_rel_err": err,
                "digest": digest_of(out)}
        if hook:
            line["iterations_hist"] = torch.bincount(
                counts[0].to(torch.int64)).tolist()
        del out, ref, counts
        ev, dv, hu = timings(lambda: B.broyden_polish(*args,
                                                      max_iters=iters),
                             "broyden_polish_kernel")
        line.update(event_ms=ev, device_ms=dv, host_us=hu)
        report(line)
        del args


def skin_lanes(torch, dev, body, where, seed):
    """KH skinning's points ``xc`` at the call ``where`` (see the module's
    docstring)."""
    rigid, statics = body[:2]
    rng = np.random.default_rng(seed)
    vs = statics.vs_template.cpu().numpy()
    if where == "phys fine pass":
        M = 65536
        n = int(round(M * KL_FINE_SEEDED))
        x = np.zeros((M, 3))
        x[:n] = vs[rng.choice(len(vs), n)] + rng.normal(scale=0.02,
                                                        size=(n, 3))
    elif where == "serve shading query":
        pts = body_rays(torch, dev, vs, 4096, 90, seed, 0.3).cpu().numpy()
        x = np.repeat(pts, 4, 0).reshape(-1, 4, 3)
        other = rng.random((len(pts), 3)) < 0.3
        x[:, 1:] = np.where(other[..., None], x[:, 1:] + rng.normal(
            scale=0.05, size=(len(pts), 3, 3)), 0.0)
        x = x.reshape(-1, 3)
    else:
        x = rigid.spec.denormalize(torch.as_tensor(
            rng.uniform(-1.6, 1.6, (65536, 3)))).numpy()
    return torch.as_tensor(x, dtype=torch.float32, device=dev).contiguous()


def compare_saved(torch, cmp_dir, key, root, out):
    """Save ``out`` under ``cmp_dir`` as ``key`` of port root ``root``;
    return the largest absolute difference from each other root's ``key``
    saved there."""
    import pathlib
    d = pathlib.Path(cmp_dir)
    d.mkdir(parents=True, exist_ok=True)
    tag = root.strip("./").replace("/", "_") or "checkout"
    torch.save(out.cpu(), d / f"{key}@{tag}.pt")
    diffs = {}
    for f in sorted(d.glob(f"{key}@*.pt")):
        other = f.stem.split("@", 1)[1]
        if other != tag:
            diffs[other] = (torch.load(f) - out.cpu()).abs().max().item()
    return diffs


def time_ksk(torch, dev, report, failed, cmp_dir=None, root="."):
    """KH skinning at a phys step's fine pass, a serve chunk's shading
    query and beyond the voxel; with ``cmp_dir``, each call's largest
    difference from another port root's kernel on the same inputs."""
    import inspect

    from chip_smoke import lbs_rows_touched
    from intrinsicavatar_tpu_torch.anim import broyden as B
    body = posed_body(torch, dev)
    rigid, statics, frame = body[:3]
    spec, tfs = rigid.spec, frame.tfs.detach().contiguous()
    # a parent's kernel may read the weight voxel and tfs, not voxel_J
    voxel = "voxel_J" in inspect.signature(B.deform_skinning).parameters
    for where in ("phys fine pass", "serve shading query", "border"):
        xc = skin_lanes(torch, dev, body, where, seed=31)
        args = (xc, statics.lbs_cl, spec, tfs) + (
            (frame.voxel_J,) if voxel else ())
        out = B.deform_skinning(*args)
        ref = B.deform_skinning_plain(*args[:4])
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        if not err <= 1e-5:
            print(f"kernel_timing: KH skinning disagrees at the {where}: "
                  f"{err}", flush=True)
            failed.append(f"deform_skinning at the {where}")
        line = {"kernel": "deform_skinning", "at": where,
                "lanes": xc.shape[0], "rows_touched":
                lbs_rows_touched(xc, spec), "max_abs_err": err,
                "digest": digest_of([out])}
        if cmp_dir:
            line["max_abs_diff_from"] = compare_saved(
                torch, cmp_dir, "ksk-" + where.replace(" ", "-"), root, out)
        del out, ref
        ev, dv, hu = timings(lambda: B.deform_skinning(*args),
                             "::skinning_kernel(")
        line.update(event_ms=ev, device_ms=dv, host_us=hu)
        report(line)
        del args, xc


def time_kb1(torch, dev, report, failed):
    """KB' pass 1 at a train step's shading call and its curvature call."""
    from intrinsicavatar_tpu_torch.ops import encode_grad as EG
    from intrinsicavatar_tpu_torch.ops import hashgrid as HG
    spec = HG.HashGridSpec(n_levels=16, n_features_per_level=2,
                           log2_hashmap_size=19, include_xyz=True)
    rng = np.random.default_rng(9)
    table = torch.as_tensor(rng.uniform(-0.1, 0.1, (16, 1 << 19, 2)),
                            dtype=torch.float32, device=dev)
    mask = torch.ones(32, device=dev)
    for where, rays, samples in (("shading call", 4096, 135),
                                 ("curvature call", 1024, 90)):
        x = ka_points(torch, dev, rays, samples, seed=samples + 1)
        N = x.shape[0]
        g_grad = torch.as_tensor(rng.normal(size=(N, 3)),
                                 dtype=torch.float32, device=dev)
        args = (spec, table, x, mask, g_grad)
        out = EG.encode_mlp_sdfgrad_bwd_gather(*args)
        ref = EG.encode_mlp_sdfgrad_bwd_gather_plain(*args)
        torch.cuda.synchronize()
        errs = [(a - b).abs().max().item() / b.abs().max().item()
                for a, b in zip(out, ref)]
        if not max(errs) <= 1e-5:
            print(f"kernel_timing: KB' pass 1 disagrees at the {where}: "
                  f"{errs}", flush=True)
            failed.append(f"encode_mlp_sdfgrad_bwd_gather at the {where}")
        digest = digest_of(out)
        del out, ref
        ev, dv, hu = timings(
            lambda: EG.encode_mlp_sdfgrad_bwd_gather(*args),
            "encode_mlp_sdfgrad_bwd_gather_kernel")
        # KA on the same points and table: the gather alone
        _, kdv, _ = timings(lambda: HG.hashgrid_encode(table, x, spec, mask),
                            "hashgrid_encode_kernel")
        report({"kernel": "encode_mlp_sdfgrad_bwd_gather", "at": where,
                "points": N, "relerr": errs, "digest": digest,
                "event_ms": ev, "device_ms": dv, "host_us": hu,
                "hashgrid_encode_device_ms": kdv})



KN_POINTS = 368_640   # a train step's shading budget: 4 kept lanes a point


def kn_inputs(torch, dev, body, share, others, seed):
    """KN's arguments at a train step's shading call (see the module's
    docstring): ``(xc, valid, jinv, g_xc, g_rot, lbs_cl, spec)``; the first
    ``share`` of the points on rays through the template, their other 3
    lanes each a second root at probability ``others``."""
    rigid, statics = body[:2]
    rng = np.random.default_rng(seed)
    vs = statics.vs_template.cpu().numpy()
    n = int(round(KN_POINTS * share))
    pts = np.zeros((KN_POINTS, 3))
    pts[:n] = body_rays(torch, dev, vs, n // 90 + 1, 90, seed, 0.3
                        ).cpu().numpy()[:n]
    x = np.repeat(pts, 4, 0).reshape(-1, 4, 3)
    other = (rng.random((KN_POINTS, 3)) < others) & (np.arange(KN_POINTS)
                                                     < n)[:, None]
    x[:, 1:] = np.where(other[..., None], x[:, 1:] + rng.normal(
        scale=0.05, size=(KN_POINTS, 3, 3)), 0.0)
    valid = np.concatenate([(np.arange(KN_POINTS) < n)[:, None], other], 1)
    M = 4 * KN_POINTS
    jinv = np.eye(3).reshape(1, 9) + 0.3 * rng.normal(size=(M, 9))
    g = lambda k: np.where(valid.reshape(-1, 1), rng.normal(size=(M, k)),
                           0.0)
    t = lambda a, dt=torch.float32: torch.as_tensor(
        np.ascontiguousarray(a), dtype=dt, device=dev)
    return (t(x.reshape(-1, 3)), t(valid.reshape(-1), torch.bool), t(jinv),
            t(1e-3 * g(3)), t(1e-3 * g(9)), statics.lbs_cl, rigid.spec)


def time_kn(torch, dev, report, failed):
    """KN at a train step's shading call, with the recorded calls' share of
    valid lanes and with a busier one: against
    its float64 sum within the rounding bound of its own order, two calls
    bit-equal, each planted fault refused; the device time of every kernel
    a call runs (the parent's two launches, or one), and ``W.t() @ U``."""
    from chip_smoke import lbs_rows_touched
    from intrinsicavatar_tpu_torch.anim import broyden as B
    body = posed_body(torch, dev)
    for where, share, others in (("train-pose call", 0.38, 0.0),
                                 ("busier call", 0.87, 0.3)):
        args = kn_inputs(torch, dev, body, share, others, seed=41)
        out = B.deform_skinning_bwd(*args)
        out2 = B.deform_skinning_bwd(*args)
        exact, limit = B.deform_skinning_bwd_exact(*args)
        ratio = lambda o: ((o.double() - exact)[:, :3].abs()
                           / limit[:, :3].clamp(min=1e-300)).max().item()
        faults = {k: ratio(v) for k, v in B.deform_skinning_bwd_faults(
            *args, out, limit).items()}
        bad = (B.deform_skinning_bwd_refused(out, exact, limit)
               or not torch.equal(out, out2)
               or not all(v > 1.0 for v in faults.values()))
        if bad:
            print(f"kernel_timing: KN fails at the {where}: worst error / "
                  f"bound {ratio(out)}, faults {faults}, bit-equal "
                  f"{torch.equal(out, out2)}", flush=True)
            failed.append(f"deform_skinning_bwd at the {where}")
        xc, M = args[0], args[0].shape[0]
        # every lane's validity and rotation cotangent; the adding lanes'
        # root, J^-1, position cotangent and weight rows (chip_smoke.py)
        adds = args[1] | (args[4] != 0).any(1)
        n_adds = int(adds.sum())
        rows = lbs_rows_touched(xc[adds], args[6])
        nbytes = (M * (1 + 36) + n_adds * (12 + 36 + 12) + rows * 96
                  + 24 * 16 * 4)
        W, U, _ = B.skin_bwd_terms(*args)
        W, U = W.float().contiguous(), U.float().contiguous()
        line = {"kernel": "deform_skinning_bwd", "at": where, "lanes": M,
                "valid": args[1].float().mean().item(),
                "adding_lanes": n_adds, "rows_touched": rows,
                "bound_ms": nbytes / 3.35e12 * 1e3,
                "err_over_bound": ratio(out), "faults": faults,
                "digest": digest_of([out])}
        del out, out2, exact, limit
        ev, _, hu = timings(lambda: B.deform_skinning_bwd(*args),
                            "skinning_bwd_")
        line.update(event_ms=ev, device_ms=op_device_ms(
            lambda: B.deform_skinning_bwd(*args)), host_us=hu,
            library_device_ms=op_device_ms(lambda: W.t() @ U))
        report(line)
        del args, W, U


def time_ki(torch, dev, report, failed):
    """KI at the PBR stage's [4096, 160] -> 512 call: integer outputs equal
    to the twin's, the foreground draws' t and offsets within 1e-5 of
    max(|ref|, 1), the background draws equal, and a digest of all seven
    outputs."""
    from intrinsicavatar_tpu_torch.ops import resample as RS
    R, S, B = 4096, 160, 512
    ts, te, _, w, sdf, mask = (torch.as_tensor(a, device=dev)
                               for a in fine_rows(R, S, seed=S))
    args = (ts, te, w, sdf, mask, B)
    out, ref = RS.cdf_resample_rays(*args), RS.cdf_resample_rays_plain(*args)
    torch.cuda.synchronize()
    ok = all(torch.equal(getattr(out, k), getattr(ref, k)) for k in (
        "indices", "is_bg", "fg_counts", "bg_count", "surface_idx"))
    fg = ~ref.is_bg
    ok &= torch.equal(out.ts[~fg], ref.ts[~fg]) and torch.equal(
        out.offsets[~fg], ref.offsets[~fg])
    err = 0.0
    for a, b in ((out.ts, ref.ts), (out.offsets, ref.offsets)):
        d, r = (a - b).abs()[fg], b.abs()[fg]
        ok &= bool((d <= 1e-5 * r.clamp(min=1.0)).all())
        err = max(err, d.max().item() if d.numel() else 0.0)
    if not ok:
        print(f"kernel_timing: KI disagrees at [{R}, {S}] -> {B}: "
              f"err={err}", flush=True)
        failed.append(f"cdf_resample [{R}, {S}] -> {B}")
    nbytes = R * S * 17 + R * B * 13 + R * S * 4 + R * 8
    line = {"kernel": "cdf_resample", "rays": R, "slots": S, "draws": B,
            "background": ref.is_bg.float().mean().item(),
            "surface_rays": int((ref.surface_idx >= 0).sum()),
            "bound_ms": nbytes / 3.35e12 * 1e3, "max_abs_err": err,
            "digest": digest_of(out)}
    del out, ref
    ev, dv, hu = timings(lambda: RS.cdf_resample_rays(*args),
                         "cdf_resample_kernel")
    line.update(event_ms=ev, device_ms=dv, host_us=hu)
    report(line)

if __name__ == "__main__":
    main()
