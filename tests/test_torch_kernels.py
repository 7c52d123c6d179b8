"""Each hand-written kernel of the port against its plain PyTorch twin, on
a CUDA card, and a full-width train step on the card against the same step
on the CPU twins.  Where there is no card every test here skips with a
reason.

This file imports neither JAX nor the JAX package, so it also runs on a
machine with a card and no JAX, without the repository's conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels.py
"""

import numpy as np
import pytest
import torch

from intrinsicavatar_tpu_torch import kernels
from intrinsicavatar_tpu_torch.anim import broyden as TB
from intrinsicavatar_tpu_torch.anim import seedgrid as SG
from intrinsicavatar_tpu_torch.anim.deformer import FastSNARF
from intrinsicavatar_tpu_torch.anim.lbs_voxel import VoxelSpec
from intrinsicavatar_tpu_torch.nets.mlp import VanillaMLP
from intrinsicavatar_tpu_torch.ops import compact as C
from intrinsicavatar_tpu_torch.ops import encode_grad as EG
from intrinsicavatar_tpu_torch.ops import grid_traversal as G
from intrinsicavatar_tpu_torch.ops import hashgrid as HG
from intrinsicavatar_tpu_torch.ops import resample as RS
from intrinsicavatar_tpu_torch.ops import volrend as V
from intrinsicavatar_tpu_torch.utils.config import merge, wrap

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _grid(include_xyz, n, seed=0):
    spec = HG.HashGridSpec(n_levels=16, n_features_per_level=2,
                           log2_hashmap_size=19, include_xyz=include_xyz)
    rng = np.random.default_rng(seed)
    table = rng.uniform(-0.1, 0.1, (16, 1 << 19, 2)).astype(np.float32)
    # out-of-domain points reach the dense and hashed border clamps
    x = rng.uniform(-0.15, 1.15, (n, 3)).astype(np.float32)
    mask = (np.arange(32) < 28).astype(np.float32)
    return spec, table, x, mask


@pytest.mark.parametrize("include_xyz", [False, True])
def test_hashgrid_kernel_matches_twin(cuda, include_xyz):
    spec, *arrays = _grid(include_xyz, 200_000)
    table, x, mask = (torch.as_tensor(a, device=cuda) for a in arrays)
    before = kernels.launches["hashgrid_encode"]
    out = HG.hashgrid_encode(table, x, spec, mask)
    assert kernels.launches["hashgrid_encode"] == before + 1
    ref = HG.hashgrid_encode_plain(table, x, spec, mask)
    # same f32 operations in the same order
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("include_xyz", [False, True])
def test_encode_grad_kernel_matches_twin(cuda, include_xyz):
    spec, *arrays = _grid(include_xyz, 100_000, seed=1)
    table, x, mask = (torch.as_tensor(a, device=cuda) for a in arrays)
    mlp = VanillaMLP(spec.n_output_dims, 13, n_neurons=64, n_hidden_layers=1,
                     sphere_init=True, weight_norm=True).to(cuda)
    mlp.init(torch.Generator().manual_seed(0))
    with torch.no_grad():
        feat, grad = EG.encode_mlp_sdfgrad(spec, mlp, table, x, mask)
        feat_r, grad_r = EG.encode_mlp_sdfgrad_plain(spec, mlp, table, x,
                                                     mask)
    # the kernel's serial dot products vs cuBLAS: reassociated f32 sums
    torch.testing.assert_close(feat, feat_r, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(grad, grad_r, rtol=1e-4, atol=1e-4)


def _kb_case(cuda, n_levels, log2_size, include_xyz, hidden, n, seed):
    spec = HG.HashGridSpec(n_levels=n_levels, n_features_per_level=2,
                           log2_hashmap_size=log2_size,
                           include_xyz=include_xyz)
    rng = np.random.default_rng(seed)
    lf = 2 * n_levels
    table = rng.uniform(-0.1, 0.1, (n_levels, 1 << log2_size, 2))
    x = rng.uniform(-0.15, 1.15, (n, 3))
    mask = (np.arange(lf) < lf - 4).astype(np.float32)
    table, x, mask = (torch.as_tensor(a, dtype=torch.float32, device=cuda)
                      for a in (table, x, mask))
    mlp = VanillaMLP(spec.n_output_dims, 13, n_neurons=hidden,
                     n_hidden_layers=1, sphere_init=True,
                     weight_norm=True).to(cuda)
    mlp.init(torch.Generator().manual_seed(seed))
    # the sphere init zeroes the first layer's rows of the hash features,
    # which would hide the encode and its derivative from feat and grad:
    # noise on every weight puts each input to work
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for p in mlp.parameters():
            p.add_(0.3 * torch.randn(p.shape, generator=gen).to(cuda))
    return spec, mlp, table, x, mask


# (levels, log2 table size, include_xyz, hidden units, points): the
# published widths (35 -> 64 -> 13, or 32 without xyz), the tiny config's
# (19 -> 64 -> 13) and 32 hidden units, each through the same 128-point
# tiles: one point, and counts that leave the last tile ragged
@pytest.mark.parametrize("n_levels,log2_size,include_xyz,hidden,n", [
    (16, 19, True, 64, 1),
    (16, 19, True, 64, 128 * 37 + 5),
    (16, 19, False, 64, 129),
    (8, 13, True, 64, 5003),
    (16, 19, True, 32, 4099),
    (8, 13, True, 32, 1),
])
def test_encode_grad_kernel_widths_and_ragged_tiles(cuda, n_levels,
                                                    log2_size, include_xyz,
                                                    hidden, n):
    spec, mlp, table, x, mask = _kb_case(cuda, n_levels, log2_size,
                                         include_xyz, hidden, n, seed=n)
    before = kernels.launches["encode_mlp_sdfgrad"]
    with torch.no_grad():
        feat, grad = EG.encode_mlp_sdfgrad(spec, mlp, table, x, mask)
        feat_r, grad_r = EG.encode_mlp_sdfgrad_plain(spec, mlp, table, x,
                                                     mask)
    assert kernels.launches["encode_mlp_sdfgrad"] == before + 1
    assert feat.shape == (n, 13) and grad.shape == (n, 3)
    # the same tolerances as test_encode_grad_kernel_matches_twin
    torch.testing.assert_close(feat, feat_r, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(grad, grad_r, rtol=1e-4, atol=1e-4)


def test_encode_grad_kernel_refuses_widths_beyond_its_tile(cuda):
    spec, mlp, table, x, mask = _kb_case(cuda, 8, 13, True, 96, 16, seed=3)
    with torch.no_grad(), pytest.raises(RuntimeError):
        EG.encode_mlp_sdfgrad(spec, mlp, table, x, mask)


def test_broyden_kernel_matches_twin(cuda):
    rigid = FastSNARF(wrap({"name": "fast-snarf", "model_path": "synthetic",
                            "deformer_config": {"resolution": 64}}))
    statics = rigid.initialize(np.zeros(10), cuda)
    pose = np.zeros(69, np.float32)
    pose[2], pose[5], pose[52] = 0.4, -0.4, 0.9
    z = lambda n: torch.zeros(1, n, device=cuda)
    frame = rigid.prepare(statics, {
        "betas": torch.zeros(10, device=cuda),
        "body_pose": torch.as_tensor(pose, device=cuda),
        "global_orient": torch.zeros(3, device=cuda),
        "transl": torch.tensor([0.0, 0.3, 2.0], device=cuda),
        "betas_correction": z(10), "pose_correction": z(69),
        "global_orient_correction": z(3), "transl_correction": z(3)})
    rng = np.random.default_rng(2)
    verts = frame.vertices.cpu().numpy()
    pts = verts[rng.choice(len(verts), 50_000)] \
        + rng.normal(scale=0.03, size=(50_000, 3))
    I = len(TB.INIT_BONES)
    args = (torch.as_tensor(np.repeat(pts, I, 0), dtype=torch.float32,
                            device=cuda),
            torch.as_tensor(np.tile(np.arange(I), len(pts)),
                            dtype=torch.int32, device=cuda),
            frame.voxel_J,
            frame.tfs[torch.as_tensor(TB.INIT_BONES, device=cuda)]
            .contiguous(),
            rigid.spec.offset, rigid.spec.scale_kernel)
    out = TB.broyden_search(*args)
    ref = TB.broyden_search_plain(*args)
    assert 0.05 < ref.valid.float().mean().item() < 0.95
    # a lane whose |g|^2 sits at the threshold may flip with the order of a
    # sum; the roots where both converged agree to 1e-4
    assert (out.valid != ref.valid).float().mean().item() <= 1e-3
    both = out.valid & ref.valid
    torch.testing.assert_close(out.x[both], ref.x[both], rtol=0, atol=1e-4)


def test_volrend_kernels_match_twins(cuda):
    rng = np.random.default_rng(3)
    R, S = 4096, 161
    sdf = rng.normal(scale=0.3, size=(R, S)).astype(np.float32)
    sdf[:, ::7] = 0.0
    sdf[0] = 1e5
    dists = rng.uniform(0.0, 0.05, (R, S)).astype(np.float32)
    mask = rng.random((R, S)) < 0.6
    mask[1] = False
    rgb = rng.random((R, S, 3)).astype(np.float32)
    normal = rng.normal(size=(R, S, 3)).astype(np.float32)
    mids = (np.cumsum(dists, -1) + 1.0).astype(np.float32)
    args = [torch.as_tensor(a, device=cuda) for a in
            (sdf, dists, np.float32(0.05), mask, rgb, normal, mids)]
    out = V.composite(*args)
    ref = V.composite_plain(*args)
    # a tree-ordered scan and sums vs torch's; exp(x) - 1 vs expm1
    for a, b in zip(out, ref):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    alphas = ref[0].contiguous()
    w, t = V.render_weight_from_alpha(alphas, args[3])
    w_r, t_r = V.render_weight_from_alpha_plain(alphas, args[3])
    torch.testing.assert_close(w, w_r, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(t, t_r, rtol=1e-5, atol=1e-6)


AABB = [-1.0, -1.2, -0.9, 1.1, 1.0, 1.3]


def _march_inputs(cuda, fill, R=4096, S=128, res=64, seed=4):
    """Rays from a ring of origins at the scene: a quarter of them turned
    away (they miss), some along the top face (a miss: t_exit == 0), some
    whose far plane cuts the march short, and some with near == far."""
    rng = np.random.default_rng(seed)
    ang = rng.uniform(0, 2 * np.pi, R)
    o = np.stack([2.5 * np.cos(ang), rng.uniform(-0.5, 0.5, R),
                  2.5 * np.sin(ang)], -1)
    tgt = rng.uniform(-0.8, 0.8, (R, 3))
    d = tgt - o
    d[: R // 4] *= -1.0
    o[R // 4: R // 4 + 64, 1] = 1.0                 # on the top face
    d[R // 4: R // 4 + 64, 1] = 0.0
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    dist = np.linalg.norm(o, axis=-1)
    near, far = dist - 1.6, dist + 1.6
    far[R // 2: R // 2 + 64] = near[R // 2: R // 2 + 64] + 0.5
    near[R // 2 + 64: R // 2 + 128] = far[R // 2 + 64: R // 2 + 128]
    grid = (np.ones((res,) * 3, bool) if fill == "full"
            else rng.random((res,) * 3) < 0.3)
    diag = float(np.linalg.norm(np.subtract(AABB[3:], AABB[:3])))
    t = lambda a, dt=torch.float32: torch.as_tensor(
        np.ascontiguousarray(a), dtype=dt, device=cuda)
    return (t(o), t(d), t(grid, torch.bool), t(AABB), diag / S, S,
            t(near), t(far), t(rng.random(R)))


@pytest.mark.parametrize("fill", ["random", "full"])
def test_march_kernel_matches_twin(cuda, fill):
    o, d, grid, aabb, step, S, near, far, u = _march_inputs(cuda, fill)
    for kw in ({"near": near, "far": far, "stratified_u": u}, {}):
        before = kernels.launches["occupancy_march"]
        out = G.occupancy_sampling(o, d, grid, aabb, step, S, **kw)
        assert kernels.launches["occupancy_march"] == before + 1
        ref = G.occupancy_sampling_plain(o, d, grid, aabb, step, S, **kw)
        for name in ("is_left", "is_right", "valid"):
            assert torch.equal(getattr(out, name), getattr(ref, name)), name
        # the same f32 operations in the same order
        torch.testing.assert_close(out.vals, ref.vals, rtol=0, atol=1e-6)
        assert not ref.valid[: o.shape[0] // 4].any()       # the misses
        assert ref.valid.any(-1).float().mean() > 0.3


def test_resample_kernel_matches_twin(cuda):
    o, d, grid, aabb, step, S, near, far, u = _march_inputs(cuda, "random")
    iv = G.occupancy_sampling_plain(o, d, grid, aabb, step, S, near=near,
                                    far=far, stratified_u=u)
    rng = np.random.default_rng(5)
    R = o.shape[0]
    for rnd in range(2):
        E = iv.vals.shape[1]
        w = rng.random((R, E)) * rng.choice([0.0, 0.002, 0.02], (R, 1))
        w[-64:] *= 40.0                       # foreground mass above 1
        w = torch.as_tensor(w, dtype=torch.float32, device=cuda)
        args = (iv.vals, iv.is_left, iv.is_right, iv.valid, w, 16)
        out = RS.merge_resample_rays(*args)
        ref = RS.merge_resample_rays_plain(*args)
        # torch.cumsum on the card sums in another order than the kernel's
        # sequential sum, which can move a draw across a CDF boundary: rays
        # may differ on 1e-3 of rows; the rest agree exactly on flags and
        # indices and within 1e-5 on values (t_new divides by the CDF step)
        same = torch.ones(R, dtype=torch.bool, device=cuda)
        for name in ("is_left", "is_right", "valid", "is_new", "gather_idx"):
            same &= (getattr(out, name) == getattr(ref, name)).all(-1)
        assert same.float().mean().item() >= 0.999
        torch.testing.assert_close(out.vals[same], ref.vals[same], rtol=0,
                                   atol=1e-5)
        assert ref.is_new.any() and (ref.valid.sum(-1) == 0).any()
        iv = G.RayIntervals(ref.vals, ref.is_left, ref.is_right, ref.valid)


def _kg_budget(n_valid, M, budget_of):
    return {"below": max(1, n_valid // 2), "at": max(1, n_valid),
            "above": min(M, n_valid + (M - n_valid) // 2 + 1)}[budget_of]


@pytest.mark.parametrize("sample_major", [False, True])
@pytest.mark.parametrize("budget_of", ["below", "at", "above"])
@pytest.mark.parametrize("R, S", [(4096, 160), (31, 16), (32, 64),
                                  (4096 + 7, 64), (4096 + 7, 13)])
def test_compact_kernel_matches_twin(cuda, sample_major, budget_of, R, S):
    """KG against its twin: rows not a multiple of a warp, rows whose
    bytes are not 16-byte aligned (S = 13), budgets below, at and above the
    valid count."""
    rng = np.random.default_rng(6 + R + S)
    mask = torch.as_tensor(rng.random((R, S)) < 0.2, device=cuda)
    budget = _kg_budget(int(mask.sum()), mask.numel(), budget_of)
    m = mask if sample_major else mask.reshape(-1)
    fn = C.compact_indices_interleaved if sample_major else C.compact_indices
    before = kernels.launches["compact_indices"]
    idx, picked = fn(m, budget)
    assert kernels.launches["compact_indices"] == before + 1
    ref_idx, ref_picked = C.compact_indices_plain(m, budget, sample_major)
    assert torch.equal(idx, ref_idx) and torch.equal(picked, ref_picked)


@pytest.mark.parametrize("sample_major", [False, True])
@pytest.mark.parametrize("fill", ["all_valid", "all_invalid", "runs",
                                  "unaligned"])
def test_compact_kernel_edge_masks(cuda, sample_major, fill):
    """KG on an all-valid and an all-invalid mask, on left-packed runs as
    the secondary coarse call gives them, and on a mask that starts one
    byte past a 16-byte boundary (the byte loads); budgets of a third, a
    half and all of the entries."""
    rng = np.random.default_rng(9)
    R, S = 4096 + 7, 64
    runs = np.where(rng.random(R) < 0.9, 0, rng.integers(1, S + 1, R))
    mask = {"all_valid": np.ones((R, S), bool),
            "all_invalid": np.zeros((R, S), bool),
            "runs": np.arange(S)[None] < runs[:, None],
            "unaligned": rng.random((R, S)) < 0.3}[fill]
    flat = torch.zeros(R * S + 1, dtype=torch.bool, device=cuda)
    off = 1 if fill == "unaligned" else 0
    flat[off:off + R * S] = torch.as_tensor(mask.reshape(-1), device=cuda)
    m = flat[off:off + R * S]
    assert m.is_contiguous() and (m.data_ptr() % 16 != 0) == bool(off)
    if sample_major:
        m = m.view(R, S)
    fn = C.compact_indices_interleaved if sample_major else C.compact_indices
    for budget in (R * S // 3, R * S // 2, R * S):
        idx, picked = fn(m, budget)
        ref_idx, ref_picked = C.compact_indices_plain(m, budget,
                                                      sample_major)
        assert torch.equal(idx, ref_idx) and torch.equal(picked, ref_picked)


def test_compact_refuses_samples_beyond_its_limit(cuda):
    mask = torch.ones((2, C.MAX_SAMPLES + 1), dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError, match="samples a ray"):
        C.compact_indices_interleaved(mask, 8)


def _rigid_table(cuda, seed=7, n=13):
    rng = np.random.default_rng(seed)
    rots = []
    for _ in range(n):
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        rots.append(q)
    T = np.zeros((n, 4, 4))
    T[:, :3, :3] = rots
    T[:, :3, 3] = rng.normal(scale=0.3, size=(n, 3))
    T[:, 3, 3] = 1.0
    segs = rng.normal(scale=0.4, size=(n, 2, 3)).astype(np.float32)
    # rows 4 and 9 identical: every point has a tie between them
    T[9], segs[9] = T[4], segs[4]
    # row 2's segment is a point: zero length, the denominator is 1e-9
    segs[2, 1] = segs[2, 0]
    return (torch.as_tensor(T, dtype=torch.float32, device=cuda),
            torch.as_tensor(TB.segment_table(segs), device=cuda))


@pytest.mark.parametrize("n_all,I", [(13, 1), (13, 8), (13, 12), (13, 13),
                                     (24, 1), (24, 8), (24, 13), (24, 16)])
def test_deform_prologue_kernel_matches_twin(cuda, n_all, I):
    tfs_table, segs = _rigid_table(cuda, n=n_all)
    # a ragged last tile of 5 points; points near the bones and out to
    # |x| = 1e7, where the distances of all bones lie close together
    N = 128 * 1562 + 5
    gen = torch.Generator().manual_seed(8)
    scale = torch.tensor([0.5, 30.0, 1e4, 1e7])[
        torch.randint(0, 4, (N, 1), generator=gen)]
    pts = (torch.randn(N, 3, generator=gen) * scale).to(cuda)
    before = kernels.launches["deform_prologue"]
    slot = TB.deform_prologue(pts, tfs_table, segs, I)
    assert kernels.launches["deform_prologue"] == before + 1
    ref = TB.deform_prologue_plain(pts, tfs_table, segs, I)
    assert torch.equal(slot, ref)
    if I > 1 and n_all == 13:
        # the tie between rows 4 and 9: the lower row first
        s = ref.reshape(N, I)
        both = (s == 4).any(-1) & (s == 9).any(-1)
        assert bool(both.any())
        first = lambda v: (s == v).int().argmax(-1)
        assert bool((first(4)[both] < first(9)[both]).all())


def test_deform_prologue_refuses_bones_beyond_its_limit(cuda):
    tfs_table, segs = _rigid_table(cuda, n=TB.MAX_INIT_BONES + 1)
    pts = torch.zeros((256, 3), device=cuda)
    with pytest.raises(ValueError, match="init bones"):
        TB.deform_prologue(pts, tfs_table, segs, 8)
    # at the limit it runs
    tfs_table, segs = _rigid_table(cuda, n=TB.MAX_INIT_BONES)
    assert torch.equal(TB.deform_prologue(pts, tfs_table, segs, 8),
                       TB.deform_prologue_plain(pts, tfs_table, segs, 8))


def _search_result(cuda, N=50_000, I=8, seed=9):
    """Lanes with 0, some and all roots valid, near-duplicate roots (within
    and beyond 1e-4 of a later lane) and invalid lanes whose x is 0."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1.3, 1.3, (N, I, 3))
    valid = rng.random((N, I)) < rng.choice([0.0, 0.3, 1.0], (N, 1))
    dup = rng.random((N, I)) < 0.3
    src = rng.integers(0, I, (N, I))
    near = x[np.arange(N)[:, None], src] + rng.normal(
        scale=rng.choice([2e-5, 2e-4], (N, I, 1)), size=(N, I, 3))
    x = np.where(dup[..., None], near, x)
    x[~valid] = 0.0
    jinv = rng.normal(size=(N, I, 9)) * valid[..., None]
    f = lambda a: torch.as_tensor(a.reshape(N * I, -1).astype(np.float32),
                                  device=cuda)
    return TB.BroydenResult(x=f(x), j_inv=f(jinv),
                            valid=torch.as_tensor(valid.reshape(-1),
                                                  device=cuda))


def _skin_inputs(cuda, seed=10):
    rng = np.random.default_rng(seed)
    spec = VoxelSpec(resolution=128, offset=np.zeros(3, np.float32),
                     scale=1.0)
    D, H, W = spec.shape_dhw
    w = rng.random((D * H * W, 24)) ** 4
    lbs_cl = torch.as_tensor((w / w.sum(-1, keepdims=True)
                              ).astype(np.float32), device=cuda)
    tfs = torch.as_tensor(rng.normal(size=(24, 4, 4)), dtype=torch.float32,
                          device=cuda)
    return lbs_cl, spec, tfs


def _voxel_J(lbs_cl, spec, tfs):
    """The transform voxel ``[D, H, W, 12]`` of ``lbs_cl`` and ``tfs``
    (``sum_b W_b tfs[b, :3, :4]``), which KH skinning's kernel samples."""
    return (lbs_cl @ tfs[:, :3, :].reshape(24, 12)).reshape(
        *spec.shape_dhw, 12).contiguous()


@pytest.mark.parametrize("need_rot", [False, True])
def test_deform_epilogue_kernel_matches_twin(cuda, need_rot):
    res = _search_result(cuda)
    lbs_cl, spec, tfs = _skin_inputs(cuda)
    args = (res, 8, 4, need_rot, lbs_cl, spec, tfs,
            _voxel_J(lbs_cl, spec, tfs))
    before = kernels.launches["deform_skinning"]
    out = TB.deform_epilogue(*args)
    assert kernels.launches["deform_skinning"] == before + int(need_rot)
    ref = TB.deform_epilogue_plain(*args)
    for a, b in zip(out[:4], ref[:4]):
        assert torch.equal(a, b)
    assert ref.overflow.item() > 0
    if need_rot:
        # the kernel samples the blended voxel, the twin blends the sampled
        # weights (cuBLAS's order on both sides)
        torch.testing.assert_close(out.fwd_rot, ref.fwd_rot, rtol=0,
                                   atol=1e-5)
    else:
        assert out.fwd_rot is None and ref.fwd_rot is None


def _posed_body(cuda, resolution=128):
    """The synthetic body's rigid deformer (the published 32 x 128 x 128
    voxel by default) in a pose, on the card: ``(deformer, statics,
    frame)``."""
    rigid = FastSNARF(wrap({"name": "fast-snarf", "model_path": "synthetic",
                            "deformer_config": {"resolution": resolution}}))
    statics = rigid.initialize(np.zeros(10), cuda)
    pose = np.zeros(69, np.float32)
    pose[2], pose[5], pose[52] = 0.4, -0.4, 0.9
    z = lambda n: torch.zeros(1, n, device=cuda)
    frame = rigid.prepare(statics, {
        "betas": torch.zeros(10, device=cuda),
        "body_pose": torch.as_tensor(pose, device=cuda),
        "global_orient": torch.zeros(3, device=cuda),
        "transl": torch.tensor([0.0, 0.3, 2.0], device=cuda),
        "betas_correction": z(10), "pose_correction": z(69),
        "global_orient_correction": z(3), "transl_correction": z(3)})
    return rigid, statics, frame


@pytest.mark.parametrize("where", ["fine pass", "border"])
def test_skinning_kernel_matches_twin(cuda, where):
    """KH skinning on the frame's transform voxel against its twin (the
    weights sampled, then blended) within 1e-5, and against the voxel form
    in plain PyTorch (the kernel's order): a phys step's fine-pass
    stand-in (65,536 lanes, the recorded seeded share of 1,223 canonical
    points near the body first, the rest the budget's padding at one
    root), and 100,003 points (a ragged last block) beyond the voxel,
    whose coordinates border padding clamps."""
    rigid, statics, frame = _posed_body(cuda)
    spec = rigid.spec
    rng = np.random.default_rng(22)
    if where == "fine pass":
        M, n = 65_536, 1_223
        vs = statics.vs_template.cpu().numpy()
        x = np.zeros((M, 3), np.float32)
        x[:n] = vs[rng.choice(len(vs), n)] + rng.normal(scale=0.02,
                                                        size=(n, 3))
        xc = torch.as_tensor(x, device=cuda)
    else:
        xc = spec.denormalize(torch.as_tensor(
            rng.uniform(-1.6, 1.6, (100_003, 3)), dtype=torch.float32,
            device=cuda)).contiguous()
        assert (spec.normalize(xc).abs() > 1).any(-1).float().mean() > 0.5
    tfs = frame.tfs.detach().contiguous()
    before = kernels.launches["deform_skinning"]
    out = TB.deform_skinning(xc, statics.lbs_cl, spec, tfs, frame.voxel_J)
    assert kernels.launches["deform_skinning"] == before + 1
    ref = TB.deform_skinning_plain(xc, statics.lbs_cl, spec, tfs)
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-5)
    vox = TB.deform_skinning_voxel_plain(xc, frame.voxel_J, spec)
    torch.testing.assert_close(out, vox, rtol=0, atol=1e-5)
    # the wrapper refuses a voxel it cannot read as 16-byte words
    flat = torch.empty(frame.voxel_J.numel() + 1, device=cuda)
    with pytest.raises(ValueError):
        TB.deform_skinning(xc, statics.lbs_cl, spec, tfs,
                           flat[1:].view(frame.voxel_J.shape))


def _border(x, rng):
    """A third of the points in the last cell of the dense levels (their +1
    corners clamp onto the cell's own row) and just outside the domain."""
    n = x.shape[0] // 3
    x[:n] = rng.uniform(0.985, 1.0, (n, 3))
    x[n // 2:n, 1] = rng.uniform(-0.02, 0.0, n - n // 2)
    return x


# the kernels add the table cotangent with atomics, and index_add_ on the
# card does too, each in an order that changes from run to run: a dense
# level's row sums ~300 terms, so an entry may move by 1e-4 of itself;
# the rest within 1e-5 of the output's largest entry
def _close(a, b, tol=1e-5, rtol=1e-4):
    torch.testing.assert_close(a, b, rtol=rtol,
                               atol=tol * max(float(b.abs().max()), 1e-30))


def _row_terms(x, spec, T):
    """``[L, T, 1]``: how many (point, corner) terms each table row sums."""
    counts = torch.zeros((spec.n_levels, T, 1), device=x.device)
    for lvl in range(spec.n_levels):
        c0, _ = zip(*(HG.level_coords(x[:, a], float(spec.scales[lvl]))
                      for a in range(3)))
        rows = HG.corner_rows(c0, int(spec.resolutions[lvl]),
                              bool(spec.dense_levels[lvl]), T)
        counts[lvl].index_add_(0, rows.reshape(-1),
                               torch.ones((rows.numel(), 1), device=x.device))
    return counts


@pytest.mark.parametrize("include_xyz", [False, True])
def test_hashgrid_bwd_kernel_matches_twin(cuda, include_xyz):
    spec, table, x, mask = _grid(include_xyz, 200_000, seed=11)
    rng = np.random.default_rng(12)
    x = _border(x, rng)
    g = rng.normal(size=(x.shape[0], spec.n_output_dims)).astype(np.float32)
    table, x, mask, g = (torch.as_tensor(a, device=cuda)
                         for a in (table, x, mask, g))
    # the table cotangent: the kernel and the twin (index_add_) each sum a
    # row's n terms w * g in an order that changes from run to run, so
    # they differ by at most twice the summation error bound
    # (n - 1) u sum |w g| of each (u = eps / 2): c = n - 1 with eps, plus 1
    # for the terms' own rounding, so c = n, the row's term count
    c = _row_terms(x, spec, table.shape[1])
    eps = torch.finfo(torch.float32).eps
    for need_x in (True, False):
        before = kernels.launches["hashgrid_encode_bwd"]
        dt, dx = HG.hashgrid_encode_bwd(table, x, spec, g, mask, need_x)
        assert kernels.launches["hashgrid_encode_bwd"] == before + 1
        dt_r, dx_r = HG.hashgrid_encode_bwd_plain(table, x, spec, g, mask,
                                                  need_x)
        abs_terms = HG.hashgrid_encode_bwd_plain(table, x, spec, g.abs(),
                                                 mask, False)[0]
        excess = (dt - dt_r).abs() - c * eps * abs_terms
        assert float(excess.max()) <= 0.0, float(excess.max())
        assert not dt[14:].any()              # levels masked off
        if need_x:
            _close(dx, dx_r)
        else:
            assert dx is None


@pytest.mark.parametrize("include_xyz", [False, True])
def test_encode_grad_bwd_kernels_match_twins(cuda, include_xyz):
    """KB''s two passes against their twins, with the MLP's VJP between
    them as the backward runs it."""
    spec, table, x, mask = _grid(include_xyz, 100_000, seed=13)
    rng = np.random.default_rng(14)
    x = _border(x, rng)
    g_grad = rng.normal(size=(x.shape[0], 3)).astype(np.float32)
    g_feat = rng.normal(size=(x.shape[0], 13)).astype(np.float32)
    table, x, mask, g_grad, g_feat = (torch.as_tensor(a, device=cuda) for a
                                      in (table, x, mask, g_grad, g_feat))
    mlp = VanillaMLP(spec.n_output_dims, 13, n_neurons=64, n_hidden_layers=1,
                     sphere_init=True, weight_norm=True).to(cuda)
    mlp.init(torch.Generator().manual_seed(1))
    with torch.no_grad():
        mlp.layers[0].v.add_(0.3 * torch.randn_like(mlp.layers[0].v))
    weights = [(w.detach(), b.detach()) for w, b in mlp.effective_weights()]
    enc, gg = EG.encode_mlp_sdfgrad_bwd_gather(spec, table, x, mask, g_grad)
    enc_r, gg_r = EG.encode_mlp_sdfgrad_bwd_gather_plain(spec, table, x,
                                                         mask, g_grad)
    # the same f32 terms, the corner sums in another order: the finest
    # levels' terms reach ~4,000 x 0.1 and cancel, so each output within
    # 1e-5 of its largest entry
    _close(enc, enc_r, rtol=0)
    _close(gg, gg_r, rtol=0)
    # the xyz columns and the masked levels have no sums: equal
    cols = torch.cat([torch.arange(3 if include_xyz else 0),
                      (3 if include_xyz else 0) + torch.arange(28, 32)])
    assert torch.equal(enc[:, cols], enc_r[:, cols])
    assert torch.equal(gg[:, cols], gg_r[:, cols])
    _, d_enc, g_enc = mlp.pair_vjp(enc_r, weights, g_feat, gg_r)
    for need_x in (True, False):
        dt, dx = EG.encode_mlp_sdfgrad_bwd_scatter(spec, table, x, mask,
                                                   g_grad, d_enc, g_enc,
                                                   need_x)
        dt_r, dx_r = EG.encode_mlp_sdfgrad_bwd_scatter_plain(
            spec, table, x, mask, g_grad, d_enc, g_enc, need_x)
        _close(dt, dt_r)
        assert not dt[14:].any()
        if need_x:
            _close(dx, dx_r)
        else:
            assert dx is None


def _gather_in_corner_order(spec, table, x, mask, g_grad):
    """KB' pass 1 in plain PyTorch with the kernel's float32 operations in
    its order: each (point, level) sums its 8 corners in corner order (the
    twin sums them in an einsum)."""
    L, T, F = table.shape
    off = 3 if spec.include_xyz else 0
    enc = torch.empty((x.shape[0], off + L * F), device=x.device)
    gg = torch.empty_like(enc)
    if off:
        enc[:, :3] = x * spec.xyz_scale + spec.xyz_offset
        gg[:, :3] = g_grad * spec.xyz_scale
    for lvl in range(L):
        s = float(np.float32(spec.scales[lvl]))
        r = int(spec.resolutions[lvl])
        c0, f = zip(*(HG.level_coords(x[:, a], s) for a in range(3)))
        rows = table[lvl][HG.corner_rows(c0, r, bool(spec.dense_levels[lvl]),
                                         T)]
        w8 = HG.corner_weights(f)
        dw = HG.corner_weight_grads(f)
        e = torch.zeros((x.shape[0], F), device=x.device)
        u = torch.zeros_like(e)
        for k in range(8):
            uk = s * (g_grad[:, 0] * dw[0][:, k] + g_grad[:, 1] * dw[1][:, k]
                      + g_grad[:, 2] * dw[2][:, k])
            e = e + w8[:, k, None] * rows[:, k]
            u = u + uk[:, None] * rows[:, k]
        q = off + lvl * F
        enc[:, q:q + F] = e * mask[lvl * F:(lvl + 1) * F]
        gg[:, q:q + F] = u * mask[lvl * F:(lvl + 1) * F]
    return enc, gg


@pytest.mark.parametrize("include_xyz", [False, True])
def test_encode_grad_bwd_gather_kernel_keeps_corner_order_bits(cuda,
                                                               include_xyz):
    """KB' pass 1 bit for bit against its arithmetic in plain PyTorch
    (``_gather_in_corner_order``), the sign of a masked level's zeros
    included, at 100,003 points (a ragged last tile of 64) with two
    levels and one feature of a third masked off, and within 1e-5 of the
    largest entry of its twin."""
    spec, table, x, mask = _grid(include_xyz, 100_003, seed=23)
    rng = np.random.default_rng(24)
    x = _border(x, rng)
    mask[9] = 0.0
    g_grad = rng.normal(size=(x.shape[0], 3)).astype(np.float32)
    table, x, mask, g_grad = (torch.as_tensor(a, device=cuda) for a in
                              (table, x, mask, g_grad))
    before = kernels.launches["encode_mlp_sdfgrad_bwd_gather"]
    enc, gg = EG.encode_mlp_sdfgrad_bwd_gather(spec, table, x, mask, g_grad)
    assert kernels.launches["encode_mlp_sdfgrad_bwd_gather"] == before + 1
    enc_o, gg_o = _gather_in_corner_order(spec, table, x, mask, g_grad)
    for a, b in ((enc, enc_o), (gg, gg_o)):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    # a negative sum at a masked level is -0 on both sides
    assert bool((torch.signbit(enc) & (enc == 0)).any())
    enc_r, gg_r = EG.encode_mlp_sdfgrad_bwd_gather_plain(spec, table, x,
                                                         mask, g_grad)
    _close(enc, enc_r, rtol=0)
    _close(gg, gg_r, rtol=0)


def test_composite_bwd_kernel_matches_twin(cuda):
    rng = np.random.default_rng(15)
    R, S = 4096, 160
    sdf = rng.normal(scale=0.3, size=(R, S)).astype(np.float32)
    sdf[:, ::7] = 0.0                       # sign(0): no gradient there
    sdf[0] = 1e5                            # the compaction fill
    dists = rng.uniform(0.0, 0.05, (R, S)).astype(np.float32)
    sdf[2, 10:], dists[2, 10:] = -2.0, 5.0  # alpha == 1
    mask = rng.random((R, S)) < 0.6
    mask[1] = False                         # a ray with no sample
    rgb = rng.random((R, S, 3)).astype(np.float32)
    normal = rng.normal(size=(R, S, 3)).astype(np.float32)
    mids = (np.cumsum(dists, -1) + 1.0).astype(np.float32)
    cots = [rng.normal(size=s).astype(np.float32)
            for s in ((R, S), (R, 3), (R, 3), (R, 1), (R, 1))]
    t = lambda a: torch.as_tensor(a, device=cuda)
    args = [t(a) for a in (sdf, dists, np.float32(0.05), mask, rgb, normal,
                           mids)] + [t(c) for c in cots]
    before = kernels.launches["volrend_composite_bwd"]
    out = V.composite_bwd(*args)
    assert kernels.launches["volrend_composite_bwd"] == before + 1
    ref = V.composite_bwd_plain(*args)
    # a tree-ordered scan and sums vs the twin's sequential recurrence
    for a, b in zip(out, ref):
        _close(a, b, 1e-5, rtol=0)
    assert not out[0][1].any() and not out[0][t(sdf) == 0].any()
    assert torch.isfinite(out[0]).all()


def roughen(model, gen):
    """Noise on the SDF MLP's rows of the hash features, zero at the sphere
    init (the geometry table would get no gradient)."""
    with torch.no_grad():
        v = model.geometry.mlp.layers[0].v
        v[3:] += 0.05 * torch.randn(v[3:].shape, generator=gen).to(v.device)


def test_train_step_gradients_match_cpu_twins(cuda):
    """A step of the full-width default model on the card gives every
    trainable leaf of the fields (geometry table and MLP, radiance table and
    MLP, beta) a finite, nonzero gradient, equal to the same step's on the
    CPU with the plain twins: the kernels' backwards are wired into
    autograd."""
    from intrinsicavatar_tpu_torch.train.system import IntrinsicAvatarSystem
    from intrinsicavatar_tpu_torch.utils.default_config import train_config
    cfg = merge(train_config(), {"dataset": {"n_rays": 128}})
    from intrinsicavatar_tpu_torch.data.synthetic import SyntheticDataset
    ds = SyntheticDataset(cfg.dataset)
    card = IntrinsicAvatarSystem(cfg, cuda).setup(ds.betas)
    roughen(card.model, torch.Generator().manual_seed(3))
    cpu = IntrinsicAvatarSystem(cfg, "cpu").setup(ds.betas)
    cpu.model.load_state_dict(card.model.state_dict())
    batch = ds[0]
    t_idx = batch.pop("t_idx")
    card.step = cpu.step = 2000
    card.occ_update_step(card.to_device(batch), t_idx)
    cpu.occ = type(card.occ)(*(a.cpu() for a in card.occ))
    R = batch["rays"].shape[0]
    S = 128 + 2 * 16                # the march and two importance rounds
    nq = int(np.ceil(R * S * (0.5 + 0.0625) / 128)) * 128   # compacted
    nsub = int(np.ceil(nq * 0.25 / 128)) * 128             # curvature
    g = torch.Generator().manual_seed(4)
    draws = {"bg": torch.rand(3, generator=g),
             "strat_u": torch.rand(R, generator=g),
             "lap_sub": torch.randint(0, nq, (nsub,), generator=g),
             "lap_u": torch.rand(nsub, 3, generator=g)}
    lc = card.train_step(card.to_device(batch), t_idx,
                         card.flags_for_step(2000), draws)
    lp = cpu.train_step(cpu.to_device(batch), t_idx,
                        cpu.flags_for_step(2000), draws)
    assert int(lc["shading_total_samples"]) == R * S
    assert float(lc["total"]) == pytest.approx(float(lp["total"]), rel=1e-4)
    params_cpu = dict(cpu.model.named_parameters())
    for name, p in card.model.named_parameters():
        # the radiance regime reads neither the emitter nor the material
        # head (its Lipschitz bounds enter with weight 0 until step 12,500)
        if name.startswith(("pose_correction", "emitter.", "material.")):
            continue
        gc, gp = p.grad, params_cpu[name].grad
        assert gc is not None and torch.isfinite(gc).all(), name
        assert float(gc.abs().max()) > 0, name
        # sums in other orders (atomics, cuBLAS): 1% of each leaf's norm;
        # 5% for the geometry table, whose gradient the curvature proxy
        # dominates near the initial sphere (arccos of a dot within ~1e-6 of
        # 1: its f32 rounding moves with every reordered sum)
        tol = 5e-2 if name == "geometry.table" else 1e-2
        err = float((gc.cpu() - gp).norm())
        assert err <= tol * float(gp.norm()), (name, err, float(gp.norm()))


def _kn_check(args):
    """KN against its function summed in float64: each entry within the
    rounding bound of KN's own summation order
    (``deform_skinning_bwd_exact``), row 3 zero, two calls bit for bit, one
    launch a call, and each planted fault (zeros, bone 0 alone, a term or
    the heaviest tile dropped) refused.  The twin sums in cuBLAS's order:
    within n eps sum_m |w_m[b]| Uabs_m[a, c] over its n lanes."""
    M = args[0].shape[0]
    before = kernels.launches["deform_skinning_bwd"]
    out = TB.deform_skinning_bwd(*args)
    again = TB.deform_skinning_bwd(*args)
    assert kernels.launches["deform_skinning_bwd"] == before + 2
    assert torch.equal(out, again)
    exact, limit = TB.deform_skinning_bwd_exact(*args)
    assert float(exact.abs().max()) > 0
    ratio = lambda o: float(((o.double() - exact)[:, :3].abs()
                             / limit[:, :3].clamp(min=1e-300)).max())
    assert not TB.deform_skinning_bwd_refused(out, exact, limit), ratio(out)
    for name, bad in TB.deform_skinning_bwd_faults(*args, out,
                                                   limit).items():
        assert TB.deform_skinning_bwd_refused(bad, exact, limit), name
    W, _, Uabs = TB.skin_bwd_terms(*args)
    mag = (W.abs().t() @ Uabs).reshape(24, 3, 4)
    ref = TB.deform_skinning_bwd_plain(*args)
    assert bool(((ref.double() - exact)[:, :3].abs()
                 <= M * 2.0 ** -24 * mag).all())


@pytest.mark.parametrize("with_rot", [False, True])
def test_skinning_bwd_kernel_matches_twin(cuda, with_rot):
    """KN on random lanes (a count that is no multiple of its 288-lane
    tile, over more tiles than it has blocks), some invalid and some
    outside the weight voxel (border padding), with and without a rotation
    cotangent."""
    lbs_cl, spec, _ = _skin_inputs(cuda)
    rng = np.random.default_rng(13)
    M = 300_001
    f = lambda a: torch.as_tensor(a.astype(np.float32), device=cuda)
    args = (f(rng.uniform(-1.2, 1.2, (M, 3))),
            torch.as_tensor(rng.random(M) < 0.7, device=cuda),
            f(rng.normal(size=(M, 9))), f(rng.normal(size=(M, 3))),
            f(rng.normal(size=(M, 9))) if with_rot else None, lbs_cl, spec)
    _kn_check(args)



@pytest.mark.parametrize("M", [1, 289, 114_049])
def test_skinning_bwd_kernel_small_and_edge_calls(cuda, M):
    """KN on one lane (one block), 289 lanes (two blocks, the second tile
    one lane) and one lane more than a round of tiles over every block (the
    next round's first tile one lane); and on no lane, which gives zeros."""
    lbs_cl, spec, _ = _skin_inputs(cuda)
    rng = np.random.default_rng(M)
    f = lambda a: torch.as_tensor(a.astype(np.float32), device=cuda)
    # the first lane valid: with one lane, an invalid one has no position
    # term, and the fault that drops it would change nothing
    valid = rng.random(M) < 0.7
    valid[0] = True
    args = (f(rng.uniform(-1.2, 1.2, (M, 3))),
            torch.as_tensor(valid, device=cuda),
            f(rng.normal(size=(M, 9))), f(rng.normal(size=(M, 3))),
            f(rng.normal(size=(M, 9))), lbs_cl, spec)
    _kn_check(args)
    none = TB.deform_skinning_bwd(*(a[:0] if a is not None else None
                                    for a in args[:5]), lbs_cl, spec)
    assert torch.equal(none, torch.zeros_like(none))


def test_skinning_bwd_kernel_skips_lanes_without_terms(cuda):
    """KN where most lanes add nothing, as a train step's call gives them
    (10% of the lanes valid, the rotation cotangent zero at the others,
    which KN skips), over 200,003 lanes."""
    lbs_cl, spec, _ = _skin_inputs(cuda)
    rng = np.random.default_rng(14)
    M = 200_003
    valid = rng.random(M) < 0.1
    g_rot = np.where(valid[:, None], rng.normal(size=(M, 9)), 0.0)
    f = lambda a: torch.as_tensor(a.astype(np.float32), device=cuda)
    args = (f(rng.uniform(-1.2, 1.2, (M, 3))),
            torch.as_tensor(valid, device=cuda), f(rng.normal(size=(M, 9))),
            f(rng.normal(size=(M, 3))), f(g_rot), lbs_cl, spec)
    assert float(TB.skin_bwd_adds(args[1], args[4]).float().mean()) < 0.12
    _kn_check(args)


def test_skinning_bwd_kernel_takes_unaligned_views(cuda):
    """KN on validity and rotation cotangents that are views not starting
    16-byte aligned (the kernel copies them in 16-byte words; the wrapper
    copies such a view first): the same bits as on aligned tensors."""
    lbs_cl, spec, _ = _skin_inputs(cuda)
    rng = np.random.default_rng(15)
    M = 5_001
    f = lambda a: torch.as_tensor(a.astype(np.float32), device=cuda)
    valid = torch.as_tensor(rng.random(M + 1) < 0.5, device=cuda)
    g_rot = f(rng.normal(size=(M + 1, 9)))
    args = [f(rng.uniform(-1.2, 1.2, (M, 3))), valid[1:],
            f(rng.normal(size=(M, 9))), f(rng.normal(size=(M, 3))),
            g_rot[1:], lbs_cl, spec]
    assert args[1].data_ptr() % 16 and args[4].data_ptr() % 16
    out = TB.deform_skinning_bwd(*args)
    args[1], args[4] = args[1].clone(), args[4].clone()
    assert torch.equal(out, TB.deform_skinning_bwd(*args))

def test_skinning_bwd_kernel_on_recorded_inputs(cuda, monkeypatch):
    """KN on the inputs of a full-width train step at step 4,001 with the
    pose correction on (128 rays): the roots, validities, J^-1 and the
    cotangents the step's backward gives it."""
    from intrinsicavatar_tpu_torch.anim import deformer as DF
    from intrinsicavatar_tpu_torch.data.synthetic import SyntheticDataset
    from intrinsicavatar_tpu_torch.train.system import IntrinsicAvatarSystem
    from intrinsicavatar_tpu_torch.utils.default_config import train_config
    cfg = merge(train_config(), {
        "dataset": {"n_rays": 128},
        "model": {"pose_correction": {"enable_pose_correction": True}}})
    ds = SyntheticDataset(cfg.dataset)
    card = IntrinsicAvatarSystem(cfg, cuda).setup(ds.betas)
    roughen(card.model, torch.Generator().manual_seed(3))
    seen = []
    fn = DF.deform_skinning_bwd
    monkeypatch.setattr(DF, "deform_skinning_bwd",
                        lambda *a: (seen.append(a), fn(*a))[1])
    batch = ds[1]
    t_idx = batch.pop("t_idx")
    card.step = 4001
    card.train_step(card.to_device(batch), t_idx, card.flags_for_step(4001))
    assert len(seen) == 1
    assert float(card.model.pose_correction.pose.grad.abs().max()) > 0
    _kn_check(seen[0])


def test_skinning_bwd_wrapper_refuses_bad_input(cuda):
    lbs_cl, spec, _ = _skin_inputs(cuda)
    M = 64
    xc = torch.zeros((M, 3), device=cuda)
    valid = torch.ones(M, dtype=torch.bool, device=cuda)
    jinv = torch.zeros((M, 9), device=cuda)
    g = torch.zeros((M, 3), device=cuda)
    good = (xc, valid, jinv, g, None, lbs_cl, spec)
    TB.deform_skinning_bwd(*good)
    for i, bad in ((0, xc.double()), (1, valid.float()), (2, jinv[:, :8]),
                   (3, g.cpu()), (4, torch.zeros((M, 3), device=cuda)),
                   (5, lbs_cl[:, :12].contiguous())):
        args = list(good)
        args[i] = bad
        with pytest.raises(ValueError):
            TB.deform_skinning_bwd(*args)


def test_wrappers_refuse_bad_input(cuda):
    spec, table, x, mask = _grid(False, 16)
    table = torch.as_tensor(table, device=cuda)
    x = torch.as_tensor(x, device=cuda)
    with pytest.raises(ValueError):
        HG.hashgrid_encode(table, x.double(), spec)
    with pytest.raises(ValueError):
        HG.hashgrid_encode(table, x.T.contiguous().T, spec)
    o, d, grid, aabb, step, S, *_ = _march_inputs(cuda, "random", R=64)
    with pytest.raises(ValueError):
        G.occupancy_sampling(o.double(), d, grid, aabb, step, S)
    with pytest.raises(ValueError):
        G.occupancy_sampling(o, d, grid.float(), aabb, step, S)
    iv = G.occupancy_sampling(o, d, grid, aabb, step, S)
    w = torch.zeros_like(iv.vals)
    with pytest.raises(ValueError):
        RS.merge_resample_rays(iv.vals, iv.is_left, iv.is_right, iv.valid,
                               w.T.contiguous().T, 16)
    with pytest.raises(ValueError):
        RS.merge_resample_rays(iv.vals, iv.is_left, iv.is_right, iv.valid,
                               w, 65)
    with pytest.raises(ValueError):
        C.compact_indices(iv.valid.reshape(-1).int(), 10)
    with pytest.raises(ValueError):
        C.compact_indices(iv.valid.reshape(-1), iv.valid.numel() + 1)
    tfs_table, segs = _rigid_table(cuda)
    with pytest.raises(ValueError):
        TB.deform_prologue(o, tfs_table, segs[:, :6].contiguous(), 8)
    res = _search_result(cuda, N=16)
    with pytest.raises(ValueError):
        TB.deform_epilogue(res._replace(valid=res.valid.int()), 8, 4, False,
                           None, None, None, None)
    with pytest.raises(ValueError):
        TB.deform_epilogue(res, 8, 9, False, None, None, None, None)
    g = torch.zeros((16, spec.n_output_dims), device=cuda)
    with pytest.raises(ValueError):
        HG.hashgrid_encode_bwd(table, x, spec, g.double())
    with pytest.raises(ValueError):
        HG.hashgrid_encode_bwd(table, x, spec, g[:8])
    mask32 = torch.ones(32, device=cuda)
    with pytest.raises(ValueError):
        EG.encode_mlp_sdfgrad_bwd_gather(spec, table, x, mask32,
                                         torch.zeros((16, 3), device=cuda).T
                                         .contiguous().T)
    with pytest.raises(ValueError):
        EG.encode_mlp_sdfgrad_bwd_scatter(spec, table, x, mask32,
                                          torch.zeros((16, 3), device=cuda),
                                          g, g[:, :7], True)
    sdf = torch.zeros((4, 8), device=cuda)
    vec = torch.zeros((4, 8, 3), device=cuda)
    ray = torch.zeros((4, 3), device=cuda)
    one = torch.zeros((4, 1), device=cuda)
    good = [sdf, sdf, torch.tensor(0.1, device=cuda),
            torch.ones((4, 8), dtype=torch.bool, device=cuda), vec, vec, sdf,
            sdf, ray, ray, one, one]
    V.composite_bwd(*good)
    with pytest.raises(ValueError):
        V.composite_bwd(*good[:3], good[3].float(), *good[4:])
    with pytest.raises(ValueError):
        V.composite_bwd(*good[:7], sdf[:, :4], *good[8:])


def _pbr_rows(rng, R, S, gaps=False):
    """``[R, S]`` left-packed samples as the relight path gives them: t
    ascending, weights in [0, 1) (some rows over unit mass), SDF falling
    through zero; rows with no sample, with all mass in the background and
    with a crossing in the first slot."""
    n = rng.integers(0, S + 1, R)
    n[:8] = 0
    mask = np.arange(S)[None] < n[:, None]
    dt = rng.uniform(0.005, 0.03, (R, S))
    t0 = np.cumsum(dt, 1) + rng.uniform(0.0, 1.0, (R, 1))
    te = t0 + (dt * rng.uniform(0.3, 1.0, (R, S)) if gaps
               else np.roll(dt, -1, 1))
    w = rng.uniform(0.0, 1.0, (R, S))
    w = w / w.sum(1, keepdims=True) * rng.uniform(0.2, 1.3, (R, 1))
    w[8:16] = 0.0
    sdf = rng.uniform(0.1, 0.6, (R, 1)) - np.cumsum(
        rng.uniform(0.0, 0.05, (R, S)), 1)
    sdf[16:24, 0], sdf[16:24, 1:] = 1e-3, -1.0
    z = lambda a: np.where(mask, a, 0.0).astype(np.float32)
    return z(t0), z(te), z(w), sdf.astype(np.float32), mask


def _dev(cuda, *arrays):
    return [torch.as_tensor(a, device=cuda) for a in arrays]


def _close_where(a, b, where):
    """``a`` within 1e-5 of ``max(|b|, 1)`` of ``b`` at every entry of
    ``where``."""
    d, ref = (a - b).abs()[where], b.abs()[where]
    assert bool((d <= 1e-5 * ref.clamp(min=1.0)).all()), d.max()


@pytest.mark.parametrize("B", [1, 512])
def test_cdf_resample_kernel_matches_twin(cuda, B):
    rng = np.random.default_rng(11)
    args = _dev(cuda, *_pbr_rows(rng, 4096, 160))
    before = kernels.launches["cdf_resample"]
    out = RS.cdf_resample_rays(*args, B)
    assert kernels.launches["cdf_resample"] == before + 1
    ref = RS.cdf_resample_rays_plain(*args, B)
    # both sum the CDF in double and round it to float: the searches agree
    for name in ("indices", "is_bg", "fg_counts", "bg_count", "surface_idx"):
        assert torch.equal(getattr(out, name), getattr(ref, name)), name
    # the background draws carry t_end + BG_OFFSET: equal, and the
    # foreground draws entry by entry, so the offset cannot hide an error
    fg = ~ref.is_bg
    for name in ("ts", "offsets"):
        a, b = getattr(out, name), getattr(ref, name)
        assert torch.equal(a[~fg], b[~fg]), name
        _close_where(a, b, fg)
    assert ref.is_bg[:16].all() and (ref.surface_idx >= 0).any()



def _ki_pinned_rows(S):
    """``[2 S, S]`` rows whose pinned draws start at every slot: row r has
    all S slots valid with equal weights of total mass 1 (r < S) or 0.6
    (r >= S, so the last 40% of the draws are background draws, which are
    never pinned), and its first + to - SDF crossing at slot r % S, where
    the interpolated SDF turns negative just past the slot's start, so
    every draw from the first one in that slot on is pinned.  At B = 512
    and S = 160, the row crossing at slot 39 pins draws 125 onwards: over
    the boundary of the kernel's 32-draw chunks at draw 128, with every
    later chunk wholly pinned (its draws take the carry of the chunks
    before it)."""
    R = 2 * S
    t0 = np.cumsum(np.full((R, S), 0.01), 1) + 0.5
    te = t0 + 0.01
    w = np.full((R, S), 1.0 / S) * np.where(np.arange(R) < S, 1.0, 0.6)[
        :, None]
    c = np.arange(R) % S
    ar = np.arange(S)[None]
    sdf = np.where(ar <= c[:, None], 1.0, -1.0)
    sdf[np.arange(R), c] = 1e-6
    mask = np.ones((R, S), dtype=bool)
    f = lambda a: a.astype(np.float32)
    return f(t0), f(te), f(w), f(sdf), mask


@pytest.mark.parametrize("B", [1, 33, 512, 513])
def test_cdf_resample_kernel_pinned_runs_across_warps(cuda, B):
    """KI where a run of pinned draws starts at every draw position, so
    that it straddles each boundary between the forward fill's chunks of
    32 draws and leaves whole chunks with no unpinned draw (their draws
    take the last unpinned t of the chunks before them), at B of 1, 33 and
    512 (each draw's slot counted) and 513 (searched); and on
    ``_pbr_rows`` at B = 33."""
    S = 160
    pinned = _dev(cuda, *_ki_pinned_rows(S))
    for args in (pinned,
                 _dev(cuda, *_pbr_rows(np.random.default_rng(12), 4096, S))):
        out = RS.cdf_resample_rays(*args, B)
        ref = RS.cdf_resample_rays_plain(*args, B)
        for name in ("indices", "is_bg", "fg_counts", "bg_count",
                     "surface_idx"):
            assert torch.equal(getattr(out, name), getattr(ref, name)), name
        fg = ~ref.is_bg
        for name in ("ts", "offsets"):
            a, b = getattr(out, name), getattr(ref, name)
            assert torch.equal(a[~fg], b[~fg]), name
            _close_where(a, b, fg)
        if args is pinned and B == 512:
            # the run pinned from draw 125 of the row crossing at slot 39
            ts = ref.ts[39]
            assert bool((ts[125:] == ts[124]).all()) and ts[124] != ts[123]

KJ_KINDS = ("rows", "no_valid", "zero_mass", "cross_at_0", "all_valid",
            "no_cross", "nan_val", "nan_val_before_cross", "nan_sdf")


def _kj_case(R, S, sdf_mode, seed):
    """``R`` left-packed rows of ``S`` slots (``_pbr_rows``, alphas in
    sdf mode), row r of kind ``KJ_KINDS[r % 9]``: as drawn; no valid slot;
    zero weights; the crossing at slot 0; every slot valid, the crossing
    mid-row; every slot valid and the SDF positive (no crossing); a NaN
    value at a valid slot after the crossing; a NaN value before the
    crossing (which no weight reads); a NaN SDF before the crossing."""
    rng = np.random.default_rng(seed)
    ts, te, w, sdf, mask = _pbr_rows(rng, R, S, gaps=True)
    kind = np.arange(R) % len(KJ_KINDS)
    vals = (np.where(mask, rng.uniform(0.0, 1.0, mask.shape) ** 2, 0.0)
            if sdf_mode else w).astype(np.float32)
    ar = np.arange(S)[None]
    mid = S // 2
    mask[kind == 1] = False
    vals[kind == 2] = 0.0
    sdf[kind == 3] = np.where(ar == 0, 0.2, -0.3)
    mask[kind == 3, :2] = True
    full = np.isin(kind, (4, 5, 6, 7, 8))
    mask[full] = True
    dt = np.diff(ts[full], axis=1, prepend=0.0).clip(min=0.01)
    ts[full] = np.cumsum(np.abs(dt) + 0.01, 1)
    te[full] = ts[full] + 0.005
    vals[full] = (rng.uniform(0.05, 0.9, (int(full.sum()), S)) ** 2
                  if sdf_mode else 1.0 / S)
    sdf[full] = np.where(ar < mid, 0.3, -0.3)
    sdf[kind == 5] = 0.3
    vals[kind == 6, min(mid + 1, S - 1)] = np.nan
    vals[kind == 7, 1] = np.nan
    sdf[kind == 8, 1] = np.nan
    return (ts, te, vals, sdf.astype(np.float32), mask), kind


@pytest.mark.parametrize("S", [16, 64, 128])
@pytest.mark.parametrize("sdf_mode", [True, False])
def test_fine_resample_kernel_matches_twin(cuda, sdf_mode, S):
    """KJ against its twin run on the CPU (whose cumprod and cumsum run in
    double in slot order, as the kernel's walk does): the masks equal and
    the placed intervals bit for bit, over a ragged last block and rows of
    every kind of ``_kj_case``; two calls equal bit for bit."""
    R = 32768 + 37
    arrays, kind = _kj_case(R, S, sdf_mode, seed=12 + S + sdf_mode)
    ts, te, vals, sdf, mask = _dev(cuda, *arrays)
    if sdf_mode:
        args, fn, plain = ((ts, te, vals, sdf, mask),
                           RS.sdf_fine_resample_rays,
                           RS.sdf_fine_resample_rays_plain)
    else:
        args, fn, plain = ((ts, te, vals, mask), RS.fine_resample_rays,
                           RS.fine_resample_rays_plain)
    before = kernels.launches["fine_resample"]
    out = fn(*args, 4)
    assert kernels.launches["fine_resample"] == before + 1
    again = fn(*args, 4)
    ref = plain(*(a.cpu() for a in args), 4)
    for a, b in zip(out, again):
        assert bool(_same_bits(a, b).all())
    got = [a.cpu() for a in out]
    assert torch.equal(got[2], ref.mask)
    for a, b in zip(got[:2], ref[:2]):
        assert torch.equal(a[ref.mask], b[ref.mask])
    kind = torch.as_tensor(kind)
    placed = ref.mask.any(-1)
    # the kinds were reached: nothing placed without a valid slot, without
    # a crossing or after a NaN value; NaN before the crossing harmless
    assert placed.any() and not placed[kind == 1].any()
    if sdf_mode:
        assert not placed[kind == 5].any() and placed[kind == 3].any()
        assert placed[kind == 4].all() and placed[kind == 7].all()
    assert not placed[kind == 6].any()
    assert placed[kind == 8].any()


def test_fine_resample_refuses_rows_beyond_shared_memory(cuda):
    R, S = 4, 1024
    z = torch.zeros((R, S), device=cuda)
    m = torch.ones((R, S), dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        RS.sdf_fine_resample_rays(z, z, z, z, m, 4)
    with pytest.raises(ValueError, match="shared memory"):
        RS.fine_resample_rays(z, z, z, m, 4)


@pytest.mark.parametrize("S,cap,occupancy,active_share,shift", [
    (64, 8, "sparse", 0.6, 0.0), (64, 0, "sparse", 0.6, 0.0),
    (16, 8, "sparse", 0.6, 0.0), (100, 8, "sparse", 0.6, 0.0),
    (128, 0, "sparse", 0.6, 0.0), (64, 0, "full", 0.6, 0.0),
    (64, 8, "empty", 0.6, 0.0), (64, 8, "sparse", 0.0, 0.0),
    (64, 8, "sparse", 0.6, 1.25), (100, 0, "sparse", 0.6, 1.25)])
def test_secondary_march_kernel_matches_twin(cuda, S, cap, occupancy,
                                             active_share, shift):
    """``shift`` moves the box and the rays by +shift in x: at 1.25 the
    box's lower x bound is 0, where the kernel divides by the box's extent
    with `/` instead of its fast quotient."""
    rng = np.random.default_rng(13)
    M, res = 32771, 64         # not a multiple of a block's rays
    # a sparse grid: occupied steps with empty ones between them leave
    # masked gaps in the packed samples, which the cap must not count
    grid = {"sparse": rng.random((res, res, res)) < 0.3,
            "full": np.ones((res, res, res), bool),
            "empty": np.zeros((res, res, res), bool)}[occupancy]
    aabb = np.asarray([-1.25, -1.55, -1.25, 1.25, 0.95, 1.25], np.float32)
    aabb[[0, 3]] += shift
    o = rng.uniform(-0.8, 0.6, (M, 3)).astype(np.float32)
    o[:, 0] += shift
    d = rng.normal(size=(M, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o[:64], d[:64] = 3.0 + shift, [1.0, 0.0, 0.0]   # rays that miss
    o[-100:], d[-100:] = 0.0, 1.0              # a padded chunk's rays
    active = rng.random(M) < active_share
    active[-100:] = False
    near = np.zeros(M, np.float32)
    # with the full grid a ray's S steps may all be samples: the closing
    # edge at slot S is dropped
    far = np.full(M, 3.0 if occupancy == "full" else 1.5, np.float32)
    near[64:128], far[64:128] = 1.0, 0.5       # far below near
    args = _dev(cuda, o, d, grid, aabb)
    near, far, active = _dev(cuda, near, far, active)
    before = kernels.launches["secondary_march"]
    out = G.secondary_march(*args, 1.5 / 63, S, near, far, active, cap)
    assert kernels.launches["secondary_march"] == before + 1
    ref = G.secondary_march_plain(*args, 1.5 / 63, S, near, far, active, cap)
    assert torch.equal(out[2], ref[2])
    # the same f32 operations in the same order
    for a, b in zip(out[:2], ref[:2]):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)
    # misses and far < near: rows of zeros
    for a in out:
        assert not bool(a[:128].any())
    m = ref[2]
    assert not m[~active].any()
    if occupancy == "sparse" and active_share:
        assert m.any()
    else:
        assert occupancy == "full" or not m.any()
    if cap:
        assert int(m.sum(1).max()) <= cap
        if (S, occupancy) == (64, "sparse") and active_share:
            assert int(m.sum(1).max()) == cap
    if occupancy == "full" and not cap:
        assert bool(m.all(1).any())


def test_broyden_polish_kernel_matches_twin(cuda):
    rigid = FastSNARF(wrap({"name": "fast-snarf", "model_path": "synthetic",
                            "deformer_config": {"resolution": 64}}))
    statics = rigid.initialize(np.zeros(10), cuda)
    pose = np.zeros(69, np.float32)
    pose[2], pose[5], pose[52] = 0.4, -0.4, 0.9
    z = lambda n: torch.zeros(1, n, device=cuda)
    frame = rigid.prepare(statics, {
        "betas": torch.zeros(10, device=cuda),
        "body_pose": torch.as_tensor(pose, device=cuda),
        "global_orient": torch.zeros(3, device=cuda),
        "transl": torch.tensor([0.0, 0.3, 2.0], device=cuda),
        "betas_correction": z(10), "pose_correction": z(69),
        "global_orient_correction": z(3), "transl_correction": z(3)})
    rng = np.random.default_rng(14)
    N = 65536
    verts = frame.vertices.cpu().numpy()
    xd = torch.as_tensor(verts[rng.choice(len(verts), N)]
                         + rng.normal(scale=0.03, size=(N, 3)),
                         dtype=torch.float32, device=cuda)
    # seeds: roots of the search from the first init bone, nudged (some far)
    I = len(TB.INIT_BONES)
    tfs = frame.tfs[torch.as_tensor(TB.INIT_BONES, device=cuda)].contiguous()
    res = TB.broyden_search(xd, torch.zeros(N, dtype=torch.int32,
                                            device=cuda), frame.voxel_J,
                            tfs, rigid.spec.offset, rigid.spec.scale_kernel)
    scale = np.where(rng.random(N) < 0.8, 0.01, 0.3)[:, None]
    seed = res.x + torch.as_tensor(rng.normal(size=(N, 3)) * scale,
                                   dtype=torch.float32, device=cuda)
    seed_ok = res.valid & torch.as_tensor(rng.random(N) < 0.9, device=cuda)
    args = (xd, seed.contiguous(), seed_ok, frame.voxel_J, rigid.spec.offset,
            rigid.spec.scale_kernel)
    before = kernels.launches["broyden_polish"]
    out = TB.broyden_polish(*args, max_iters=4)
    assert kernels.launches["broyden_polish"] == before + 1
    ref = TB.broyden_polish_plain(*args, max_iters=4)
    assert I > 1 and 0.3 < ref.valid.float().mean().item() < 0.99
    # the kernel's body is the twin's loop in the same f32 order
    assert torch.equal(out.valid, ref.valid)
    assert not out.valid[~seed_ok].any()
    for a, b in ((out.x, ref.x), (out.j_inv, ref.j_inv)):
        assert (a - b).abs().max() <= 1e-5 * b.abs().max()


def test_relight_wrappers_refuse_bad_input(cuda):
    rng = np.random.default_rng(15)
    ts, te, w, sdf, mask = _dev(cuda, *_pbr_rows(rng, 64, 16))
    with pytest.raises(ValueError):
        RS.cdf_resample_rays(ts, te, w.double(), sdf, mask, 8)
    with pytest.raises(ValueError):
        RS.cdf_resample_rays(ts, te, w, sdf, mask.int(), 8)
    with pytest.raises(ValueError):
        RS.sdf_fine_resample_rays(ts, te, w, sdf[:, :8].contiguous(), mask,
                                  4)
    with pytest.raises(ValueError):
        RS.fine_resample_rays(ts, te, w.T.contiguous().T, mask, 4)
    o = torch.zeros((8, 3), device=cuda)
    grid = torch.ones((4, 4, 4), dtype=torch.bool, device=cuda)
    aabb = torch.tensor([-1.0, -1, -1, 1, 1, 1], device=cuda)
    near, far = torch.zeros(8, device=cuda), torch.ones(8, device=cuda)
    with pytest.raises(ValueError):
        G.secondary_march(o, o, grid.float(), aabb, 0.1, 8, near, far)
    with pytest.raises(ValueError):
        G.secondary_march(o, o, grid, aabb, 0.1, 8, near[:4], far)
    vox = torch.zeros((4, 4, 4, 12), device=cuda)
    with pytest.raises(ValueError):
        TB.broyden_polish(o, o, near.int(), vox, [0.0] * 3, [1.0] * 3)
    with pytest.raises(ValueError):
        TB.broyden_polish(o, o[:4], near > 0, vox, [0.0] * 3, [1.0] * 3)


def _seed_grid(cuda, C, res=96, seed=16):
    """A seed grid as a bake packs it: a smooth root field over a body-like
    blob of valid nodes, dilated, with a second root branch in one half of
    the blob (incoherent cells along the seam), SDF-invalid margin nodes and
    a 96^3 lattice over a 2 m box."""
    rng = np.random.default_rng(seed)
    n = np.linspace(-1.0, 1.0, res, dtype=np.float32)
    z, y, x = np.meshgrid(n, n, n, indexing="ij")
    pts = np.stack([x, y, z], -1).reshape(-1, 3)
    r = np.linalg.norm(pts * [1.0, 0.5, 1.5], axis=-1)
    ok = (r < 0.7) & (rng.random(len(pts)) < 0.97)
    xc = 0.4 * pts + 0.01 * rng.normal(size=pts.shape)
    xc[:, 0] += np.where(pts[:, 0] > 0.1, 0.3, 0.0)
    sdf = (r - 0.6).astype(np.float32) if C == 6 else None
    aabb = torch.tensor([[-1.0, -1.1, -0.9], [1.0, 0.9, 1.1]], device=cuda)
    return SG.pack_seed_grid(
        torch.as_tensor(xc, dtype=torch.float32, device=cuda),
        torch.as_tensor(ok, device=cuda),
        None if sdf is None else torch.as_tensor(sdf, device=cuda),
        aabb, res), aabb


@pytest.mark.parametrize("C", [6, 4])
def test_seed_gather_kernel_matches_twin(cuda, C):
    grid, aabb = _seed_grid(cuda, C)
    rng = np.random.default_rng(17)
    lo, hi = aabb.cpu().numpy()
    span = hi - lo
    nodes = SG.lattice_points(aabb, grid.resolution)
    pts = torch.cat([
        nodes[torch.as_tensor(rng.choice(len(nodes), 20_000),
                              device=cuda)],
        torch.as_tensor(rng.uniform(lo - 0.1 * span, hi + 0.1 * span,
                                    (300_000, 3)), dtype=torch.float32,
                        device=cuda)]).contiguous()
    before = kernels.launches["seed_gather"]
    out = SG.gather_from_grid(grid, pts, 3.0)
    assert kernels.launches["seed_gather"] == before + 1
    ref = SG.gather_from_grid_plain(grid, pts, 3.0)
    # the kernel sums the corners in the twin's order (-fmad=false): bools
    # equal, floats within 1e-5 of max(|ref|, 1) entry by entry
    assert torch.equal(out[1], ref[1])
    assert 0.05 < ref[1].float().mean().item() < 0.95
    _close_where(out[0], ref[0], torch.ones_like(ref[0], dtype=torch.bool))
    if C == 6:
        assert torch.equal(out[2] == 1e5, ref[2] == 1e5)
        _close_where(out[2], ref[2], torch.ones_like(ref[2],
                                                     dtype=torch.bool))
    else:
        assert out[2] is None and ref[2] is None
    # a tight coherence factor makes most cells incoherent: the nearest
    # corner's root is taken unblended, the same one on both
    out, ref = (f(grid, pts, 0.05) for f in (SG.gather_from_grid,
                                              SG.gather_from_grid_plain))
    assert torch.equal(out[0], ref[0])


def _hand_seed_grid(cuda, C, res=9, seed=23):
    """A seed grid built node by node: two root branches (incoherent cells
    along their seam), a corner block of invalid nodes (cells with no
    valid corner), scattered invalid and SDF-invalid nodes, over [-1, 1]^3
    with 2^k cells a side, so that nodes and cell centres (eight tied
    weights) map to lattice coordinates exactly; the query points are the
    nodes, the cell centres and points up to 30% beyond the box (past the
    half-cell slack)."""
    rng = np.random.default_rng(seed)
    aabb = torch.tensor([[-1.0] * 3, [1.0] * 3], device=cuda)
    nodes = SG.lattice_points(aabb, res)
    nn_ = nodes.cpu().numpy()
    N = res ** 3
    xc = 0.5 * nn_ + 0.01 * rng.normal(size=(N, 3))
    xc[:, 0] += np.where(nn_[:, 0] > 0.0, 0.4, -0.4)
    ok = rng.random(N) < 0.7
    ok &= ~((nn_[:, 0] < -0.5) & (nn_[:, 1] < -0.5))
    sdf = rng.normal(size=N)
    sok = ok & (rng.random(N) < 0.7)
    ch = [xc[:, 0] * ok, xc[:, 1] * ok, xc[:, 2] * ok, ok]
    if C == 6:
        ch += [sdf * sok, sok]
    g = torch.as_tensor(np.stack(ch, -1).reshape(res, res, res, C),
                        dtype=torch.float32, device=cuda)
    grid = SG.SeedGrid(grid=SG.node_records(g), center=torch.zeros(
        3, device=cuda), half=torch.ones(3, device=cuda))
    cell = 2.0 / (res - 1)
    centres = SG.lattice_points(torch.tensor(
        [[-1.0 + 0.5 * cell] * 3, [1.0 - 0.5 * cell] * 3], device=cuda),
        res - 1)
    pts = torch.cat([nodes, centres, torch.as_tensor(
        rng.uniform(-1.3, 1.3, (20_000, 3)), dtype=torch.float32,
        device=cuda)]).contiguous()
    return grid, pts


@pytest.mark.parametrize("C", [6, 4])
@pytest.mark.parametrize("coh", [3.0, 0.1])
def test_seed_gather_kernel_on_hand_built_cells(cuda, C, coh):
    grid, pts = _hand_seed_grid(cuda, C)
    before = kernels.launches["seed_gather"]
    out = SG.gather_from_grid(grid, pts, coh)
    assert kernels.launches["seed_gather"] == before + 1
    ref = SG.gather_from_grid_plain(grid, pts, coh)
    # the cases are there: outside the slack, cells with no valid corner,
    # seeded points
    inside = ((pts.abs() <= 1.0 + 1.0 / 8).all(-1))
    assert bool((~inside).any()) and bool((inside & ~ref[1]).any())
    assert bool(ref[1].any())
    assert torch.equal(out[1], ref[1])
    _close_where(out[0], ref[0], torch.ones_like(ref[0], dtype=torch.bool))
    if C == 6:
        assert torch.equal(out[2] == 1e5, ref[2] == 1e5)
        _close_where(out[2], ref[2], torch.ones_like(ref[2],
                                                     dtype=torch.bool))
    else:
        assert out[2] is None and ref[2] is None


def test_seedgrid_wrapper_refuses_bad_input(cuda):
    grid, _ = _seed_grid(cuda, 6, res=8)
    pts = torch.zeros((16, 3), device=cuda)
    with pytest.raises(ValueError):
        SG.gather_from_grid(grid, pts.double())
    with pytest.raises(ValueError):
        SG.gather_from_grid(grid, pts.T.contiguous().T)
    with pytest.raises(ValueError):
        SG.gather_from_grid(grid._replace(grid=grid.grid[..., :5]
                                          .contiguous()), pts)
    with pytest.raises(ValueError):
        SG.gather_from_grid(grid._replace(half=grid.half.cpu()), pts)
    # channels not in 8-float node records
    with pytest.raises(ValueError):
        SG.gather_from_grid(grid._replace(grid=grid.grid.contiguous()), pts)


# ---------------------------------------------------------------- KA tiles
KA_TILE = 64  # points a tile of the encode kernel (csrc/hashgrid.cu)
PUBLISHED = dict(n_levels=16, n_features_per_level=2, log2_hashmap_size=19,
                 base_resolution=16)
SMALL = dict(n_levels=6, n_features_per_level=2, log2_hashmap_size=10,
             base_resolution=4, per_level_scale=1.9)
# the kernel's other row widths: one feature, three, and four at 16 levels
# (64 features, the widest row its tile holds)
KA_SPECS = {
    "published": PUBLISHED, "small": SMALL,
    "f1": dict(SMALL, n_levels=8, n_features_per_level=1),
    "f3": dict(SMALL, n_features_per_level=3),
    "f4": dict(PUBLISHED, n_features_per_level=4, log2_hashmap_size=12),
}


@pytest.fixture(scope="module")
def ka_tables():
    """One table of each spec, made once (the published one is 64 MB)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    rng = np.random.default_rng(21)
    out = {}
    for name, kw in KA_SPECS.items():
        shape = (kw["n_levels"], 1 << kw["log2_hashmap_size"],
                 kw["n_features_per_level"])
        out[name] = torch.as_tensor(rng.uniform(-0.1, 0.1, shape),
                                    dtype=torch.float32, device="cuda")
    return out


def _ka_points(n, ordered, seed):
    """``n`` points: rays of 16 samples through the unit box (consecutive
    points share cells), a tenth of them outside [0, 1]^3 and a few at
    |x| ~ 1e7, where the cell's float-to-int cast saturates; ``ordered``
    False shuffles them."""
    rng = np.random.default_rng(seed)
    rays = -(-n // 16)
    o = rng.uniform(-0.1, 1.1, (rays, 1, 3))
    d = rng.normal(size=(rays, 1, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    x = (o + np.linspace(0.0, 0.3, 16)[None, :, None] * d).reshape(-1, 3)[:n]
    far = rng.random(n) < 0.01
    x[far] = rng.choice([-1e7, 1e7, -3.0, 3.0], (int(far.sum()), 3))
    if not ordered:
        x = x[rng.permutation(n)]
    return x.astype(np.float32)


@pytest.mark.parametrize("ordered", [True, False])
@pytest.mark.parametrize("include_xyz", [False, True])
@pytest.mark.parametrize("n", [0, 1, KA_TILE - 1, KA_TILE + 1,
                               3 * KA_TILE + 5, 20_011])
@pytest.mark.parametrize("which", list(KA_SPECS))
def test_hashgrid_kernel_tiles_and_orders(cuda, ka_tables, which, n,
                                          include_xyz, ordered):
    kw = KA_SPECS[which]
    spec = HG.HashGridSpec(include_xyz=include_xyz, **kw)
    table = ka_tables[which]
    L, F = kw["n_levels"], kw["n_features_per_level"]
    # zeroed levels: one coarse level, one fine level and the last
    mask = np.ones((L, F), np.float32)
    mask[[1, L - 3, L - 1]] = 0.0
    mask = torch.as_tensor(mask.reshape(-1), device=cuda)
    x = torch.as_tensor(_ka_points(n, ordered, seed=n + 7), device=cuda)
    before = kernels.launches["hashgrid_encode"]
    out = HG.hashgrid_encode(table, x, spec, mask)
    assert kernels.launches["hashgrid_encode"] == before + 1
    ref = HG.hashgrid_encode_plain(table, x, spec, mask)
    assert out.shape == (n, spec.n_output_dims) == ref.shape
    if n:
        # the wrapper's tolerance in chip_smoke.py: the same f32 operations
        # in the same order
        err = (out - ref).abs().max().item()
        assert err <= 1e-6 + 1e-5 * ref.abs().max().item(), err
        assert not out[:, -F:].any()


@pytest.mark.parametrize("kernel", ["ka", "ka_bwd", "kb", "kb_bwd"])
def test_corner_rule_at_saturated_cells(cuda, ka_tables, kernel):
    """KA, KA', KB and KB' share one corner rule (csrc/common.cuh): where a
    point's cell saturates the float-to-int cast (|x| ~ 1e7 at the finest
    levels' scale of ~4,000), each reads and adds into the twin's rows."""
    spec = HG.HashGridSpec(**PUBLISHED)
    table = ka_tables["published"]
    x = _ka_points(4099, True, seed=3)
    x[:6] = [[1e7, 1e7, 1e7], [1e7, -1e7, 0.5], [0.5, 1e7, -1e7],
             [-1e7, 0.5, 1e7], [-1e7, -1e7, -1e7], [1e7, 0.5, 0.5]]
    x = torch.as_tensor(x, device=cuda)
    rng = np.random.default_rng(5)
    normal = lambda *shape: torch.as_tensor(
        rng.normal(size=shape).astype(np.float32), device=cuda)
    if kernel == "ka":
        out = HG.hashgrid_encode(table, x, spec)
        ref = HG.hashgrid_encode_plain(table, x, spec)
        assert (out - ref).abs().max() <= 1e-6 + 1e-5 * ref.abs().max()
    elif kernel == "ka_bwd":
        g = normal(x.shape[0], spec.n_output_dims)
        dt, dx = HG.hashgrid_encode_bwd(table, x, spec, g, None, True)
        dt_r, dx_r = HG.hashgrid_encode_bwd_plain(table, x, spec, g, None,
                                                  True)
        # as test_hashgrid_bwd_kernel_matches_twin: twice the summation
        # error bound of each row's terms
        c = _row_terms(x, spec, table.shape[1])
        abs_terms = HG.hashgrid_encode_bwd_plain(table, x, spec, g.abs(),
                                                 None, False)[0]
        eps = torch.finfo(torch.float32).eps
        assert float(((dt - dt_r).abs() - c * eps * abs_terms).max()) <= 0.0
        _close(dx, dx_r)
    else:
        mlp = VanillaMLP(spec.n_output_dims, 13, n_neurons=64,
                         n_hidden_layers=1, sphere_init=True,
                         weight_norm=True).to(cuda)
        mlp.init(torch.Generator().manual_seed(6))
        with torch.no_grad():
            for p in mlp.parameters():
                p.add_(0.3 * normal(*p.shape))
        ones = torch.ones(spec.n_levels * 2, device=cuda)
        if kernel == "kb":
            with torch.no_grad():
                feat, grad = EG.encode_mlp_sdfgrad(spec, mlp, table, x, ones)
                feat_r, grad_r = EG.encode_mlp_sdfgrad_plain(spec, mlp,
                                                             table, x, ones)
            # as test_encode_grad_kernel_matches_twin
            torch.testing.assert_close(feat, feat_r, rtol=1e-4, atol=1e-5)
            torch.testing.assert_close(grad, grad_r, rtol=1e-4, atol=1e-4)
            return
        # as test_encode_grad_bwd_kernels_match_twins
        g_grad, g_feat = normal(x.shape[0], 3), normal(x.shape[0], 13)
        weights = [(w.detach(), b.detach())
                   for w, b in mlp.effective_weights()]
        enc, gg = EG.encode_mlp_sdfgrad_bwd_gather(spec, table, x, ones,
                                                   g_grad)
        enc_r, gg_r = EG.encode_mlp_sdfgrad_bwd_gather_plain(spec, table, x,
                                                             ones, g_grad)
        _close(enc, enc_r, rtol=0)
        _close(gg, gg_r, rtol=0)
        _, d_enc, g_enc = mlp.pair_vjp(enc_r, weights, g_feat, gg_r)
        dt, dx = EG.encode_mlp_sdfgrad_bwd_scatter(spec, table, x, ones,
                                                   g_grad, d_enc, g_enc, True)
        dt_r, dx_r = EG.encode_mlp_sdfgrad_bwd_scatter_plain(
            spec, table, x, ones, g_grad, d_enc, g_enc, True)
        _close(dt, dt_r)
        _close(dx, dx_r)


def test_hashgrid_kernel_refuses_widths_beyond_its_tile(cuda):
    # 33 levels: more than the 32 level slots of the tile's shared memory
    spec = HG.HashGridSpec(n_levels=33, n_features_per_level=1,
                           log2_hashmap_size=8)
    table = torch.zeros((33, 256, 1), device=cuda)
    x = torch.rand((16, 3), device=cuda)
    with pytest.raises(RuntimeError):
        HG.hashgrid_encode(table, x, spec)
    # a table whose start is not 16-byte aligned (the pair loads)
    spec = HG.HashGridSpec(n_levels=2, n_features_per_level=2,
                           log2_hashmap_size=8)
    table = torch.zeros(2 * 256 * 2 + 1, device=cuda)[1:].view(2, 256, 2)
    with pytest.raises(RuntimeError):
        HG.hashgrid_encode(table, x, spec)


# ---------------------------------------------------------------- KH groups
def _epilogue_case(cuda, N, I, share, seed):
    """``N`` points of ``I`` lanes: a ``share`` of the lanes valid (their x
    zeroed otherwise, as the search leaves them), a planted pair within
    0.99e-4, beyond 1.01e-4 or within 2e-5 of a later lane in most points,
    and chains (a within 0.6e-4 of b, b of c, a beyond 1e-4 of c)."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1.3, 1.3, (N, I, 3))
    u = rng.normal(size=(N, 3))
    u /= np.linalg.norm(u, axis=-1, keepdims=True)
    if I >= 2:
        a = rng.integers(0, I - 1, N)
        b = a + 1 + rng.integers(0, I - 1 - a)
        d = rng.choice([0.99e-4, 1.01e-4, 2e-5], N)
        pick = rng.random(N) < 0.8
        x[pick, b[pick]] = x[pick, a[pick]] + d[pick, None] * u[pick]
    if I >= 3:
        chain = rng.random(N) < 0.3
        c = rng.integers(0, I - 2, N)
        for k in (1, 2):
            x[chain, c[chain] + k] = (x[chain, c[chain] + k - 1]
                                      + 0.6e-4 * u[chain])
    valid = rng.random((N, I)) < share
    x[~valid] = 0.0
    jinv = rng.normal(size=(N, I, 9))
    f = lambda v: torch.as_tensor(v.reshape(N * I, -1).astype(np.float32),
                                  device=cuda)
    return TB.BroydenResult(x=f(x), j_inv=f(jinv),
                            valid=torch.as_tensor(valid.reshape(-1),
                                                  device=cuda))


@pytest.mark.parametrize("share", [0.0, 0.3, 1.0])
@pytest.mark.parametrize("I,K", [(1, 1), (3, 1), (3, 2), (3, 3), (8, 1),
                                 (8, 4), (8, 8), (16, 1), (16, 8), (16, 16)])
def test_deform_epilogue_kernel_groups(cuda, I, K, share):
    # 20,011 points: no multiple of a tile's 256 / G points
    N = 20_011
    res = _epilogue_case(cuda, N, I, share, seed=I * 100 + K)
    args = (res, I, K, False, None, None, None, None)
    before = kernels.launches["deform_epilogue"]
    out = TB.deform_epilogue(*args)
    assert kernels.launches["deform_epilogue"] == before + 1
    ref = TB.deform_epilogue_plain(*args)
    for a, b in zip(out[:4], ref[:4]):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert torch.equal(a, b)
    if share == 1.0 and K < I:
        assert ref.overflow.item() > 0
    if share == 0.0:
        assert ref.overflow.item() == 0 and not ref.valid.any()


# ---------------------------------------------------------------- KC blocks
KC_BLOCK = 128  # lanes a block of the search kernel (csrc/broyden.cu)


@pytest.fixture(scope="module")
def posed_body():
    """The synthetic body at the published voxel resolution (32 x 128 x
    128), in a pose."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    rigid = FastSNARF(wrap({"name": "fast-snarf", "model_path": "synthetic",
                            "deformer_config": {"resolution": 128}}))
    statics = rigid.initialize(np.zeros(10), "cuda")
    pose = np.zeros(69, np.float32)
    pose[2], pose[5], pose[52] = 0.4, -0.4, 0.9
    z = lambda n: torch.zeros(1, n, device="cuda")
    frame = rigid.prepare(statics, {
        "betas": torch.zeros(10, device="cuda"),
        "body_pose": torch.as_tensor(pose, device="cuda"),
        "global_orient": torch.zeros(3, device="cuda"),
        "transl": torch.tensor([0.0, 0.3, 2.0], device="cuda"),
        "betas_correction": z(10), "pose_correction": z(69),
        "global_orient_correction": z(3), "transl_correction": z(3)})
    tfs = frame.tfs[torch.as_tensor(TB.INIT_BONES, device="cuda")]
    return rigid, frame, tfs.contiguous()


def _kc_lanes(body, M, seed, far=0.0):
    """``M`` lanes: targets near the posed body's vertices (a share ``far``
    of them 5 m away), each with a random init bone."""
    rigid, frame, tfs = body
    rng = np.random.default_rng(seed)
    verts = frame.vertices.cpu().numpy()
    xd = verts[rng.choice(len(verts), M)] \
        + rng.normal(scale=0.03, size=(M, 3))
    xd[rng.random(M) < far] += 5.0
    return (torch.as_tensor(xd, dtype=torch.float32, device="cuda"),
            torch.as_tensor(rng.integers(0, len(TB.INIT_BONES), M),
                            dtype=torch.int32, device="cuda"),
            frame.voxel_J, tfs, rigid.spec.offset, rigid.spec.scale_kernel)


def _kc_check(args, **kw):
    """KC against its twin (a lane whose |g|^2 sits at a threshold may flip
    with the order of a sum: one lane, and one more in 1,000; roots and J^-1
    within 1e-4 where both converged, zeros elsewhere), and against itself
    with its lanes permuted, bit for bit: a lane's result does not depend
    on where it runs or which lanes share its warp."""
    M = args[0].shape[0]
    before = kernels.launches["broyden_search"]
    out = TB.broyden_search(*args, **kw)
    assert kernels.launches["broyden_search"] == before + 1
    ref = TB.broyden_search_plain(*args, **kw)
    assert out.x.shape == (M, 3) and out.j_inv.shape == (M, 9)
    assert int((out.valid != ref.valid).sum()) <= 1 + M // 1000
    both = out.valid & ref.valid
    torch.testing.assert_close(out.x[both], ref.x[both], rtol=0, atol=1e-4)
    torch.testing.assert_close(out.j_inv[both], ref.j_inv[both], rtol=0,
                               atol=1e-4)
    assert not out.x[~out.valid].any() and not out.j_inv[~out.valid].any()
    perm = torch.as_tensor(np.random.default_rng(M).permutation(M),
                           device="cuda")
    moved = TB.broyden_search(args[0][perm].contiguous(),
                              args[1][perm].contiguous(), *args[2:], **kw)
    for a, b in zip(moved, out):
        assert torch.equal(a, b[perm])
    return out, ref


@pytest.mark.parametrize("M", [1, 37, KC_BLOCK - 1, KC_BLOCK, KC_BLOCK + 1,
                               3 * KC_BLOCK + 17, 100_003])
def test_broyden_kernel_blocks(cuda, posed_body, M):
    """Ragged last blocks and warps, and fewer lanes than one block."""
    _, ref = _kc_check(_kc_lanes(posed_body, M, seed=M))
    if M > 10_000:
        assert 0.05 < ref.valid.float().mean().item() < 0.95


def test_broyden_kernel_every_lane_diverges(cuda, posed_body):
    args = _kc_lanes(posed_body, 3 * KC_BLOCK + 5, seed=31, far=1.0)
    out, _ = _kc_check(args)
    assert not out.valid.any()


def test_broyden_kernel_every_lane_runs_out(cuda, posed_body):
    """No lane converges (cvg 0) or diverges (dvg 1e30): every lane runs
    all max_iters steps."""
    args = _kc_lanes(posed_body, 2 * KC_BLOCK + 3, seed=32)
    counts = []
    TB.broyden_search_plain(*args, cvg_thresh=0.0, dvg_thresh=1e30,
                            lane_counts=counts)
    assert bool((counts[0] == 10).all())
    out, _ = _kc_check(args, cvg_thresh=0.0, dvg_thresh=1e30)
    assert not out.valid.any()


def test_broyden_kernel_slow_lane_among_converged(cuda, posed_body):
    """One lane a warp 5 m away (the voxel's zero padding leaves it where it
    is: it runs all max_iters steps, dvg 1e30) beside lanes that converge
    in a few steps."""
    args = list(_kc_lanes(posed_body, 4 * KC_BLOCK + 7, seed=33))
    xd = args[0].clone()
    xd[5::32] += 5.0
    args[0] = xd
    counts = []
    TB.broyden_search_plain(*args, dvg_thresh=1e30, lane_counts=counts)
    assert bool((counts[0][5::32] == 10).all())
    assert counts[0].float().mean().item() < 6.0
    out, _ = _kc_check(tuple(args), dvg_thresh=1e30)
    assert not out.valid[5::32].any()
    assert out.valid.float().mean().item() > 0.3


def test_broyden_kernel_roots_outside_the_voxel(cuda):
    """A voxel whose transform fades to zero over its last cell beyond the
    +x face puts the root of targets with x > 0 there: those lanes converge
    and are invalid; targets with x < 0 have their root inside."""
    n = 8
    vox = torch.tensor([1.0, 0, 0, -1, 0, 1, 0, 0, 0, 0, 1, 0],
                       device=cuda).expand(n, n, n, 12).contiguous()
    rng = np.random.default_rng(34)
    M = 2 * KC_BLOCK + 9
    out_x = rng.random(M) < 0.5
    tx = np.where(out_x, rng.uniform(0.005, 0.05, M),
                  rng.uniform(-1.5, -0.01, M))
    xd = np.stack([tx, rng.uniform(-0.5, 0.5, M),
                   rng.uniform(-0.5, 0.5, M)], 1)
    tfs = torch.eye(4, device=cuda)[None].clone()
    tfs[0, 0, 3] = -1.0        # start at x_d + (1, 0, 0)
    args = (torch.as_tensor(xd, dtype=torch.float32, device=cuda),
            torch.zeros(M, dtype=torch.int32, device=cuda), vox, tfs,
            (0.0, 0.0, 0.0), (1.0, 1.0, 1.0))
    counts = []
    TB.broyden_search_plain(*args, lane_counts=counts)
    # the outside lanes stop before max_iters: converged, not run out
    assert bool((counts[0][torch.as_tensor(out_x, device=cuda)] < 10).all())
    out, _ = _kc_check(args)
    assert not out.valid[torch.as_tensor(out_x, device=cuda)].any()
    assert out.valid[torch.as_tensor(~out_x, device=cuda)].all()


def test_broyden_polish_kernel_at_published_voxel(cuda, posed_body):
    """KL runs KC's lane function: held to its twin, equal valid, on seeds
    from KC's roots nudged, at the published voxel."""
    args = _kc_lanes(posed_body, 20_000, seed=35)
    res = TB.broyden_search(*args)
    rng = np.random.default_rng(36)
    seed = res.x + torch.as_tensor(rng.normal(scale=0.01, size=(20_000, 3)),
                                   dtype=torch.float32, device="cuda")
    pargs = (args[0], seed.contiguous(), res.valid, *args[2:3], *args[4:])
    out = TB.broyden_polish(*pargs, max_iters=4)
    ref = TB.broyden_polish_plain(*pargs, max_iters=4)
    assert torch.equal(out.valid, ref.valid)
    for a, b in ((out.x, ref.x), (out.j_inv, ref.j_inv)):
        assert (a - b).abs().max() <= 1e-5 * b.abs().max()


# ---------------------------------------------------------------- KB' pass 2
KB2_TILE = 64  # points a tile of pass 2 (csrc/encode_grad.cu)
KB2_SPECS = {
    "published": PUBLISHED, "small": SMALL,
    "f1": dict(SMALL, n_levels=8, n_features_per_level=1),
    "f3": dict(SMALL, n_features_per_level=3),
    "f4": dict(PUBLISHED, n_levels=8, n_features_per_level=4,
               log2_hashmap_size=12),
}


def _kb2_case(cuda, kw, x, include_xyz, mask, seed):
    spec = HG.HashGridSpec(include_xyz=include_xyz, **kw)
    rng = np.random.default_rng(seed)
    L, F = kw["n_levels"], kw["n_features_per_level"]
    T = 1 << kw["log2_hashmap_size"]
    normal = lambda *shape: torch.as_tensor(
        rng.normal(size=shape).astype(np.float32), device=cuda)
    table = torch.as_tensor(rng.uniform(-0.1, 0.1, (L, T, F)),
                            dtype=torch.float32, device=cuda)
    N = x.shape[0]
    return (spec, table, torch.as_tensor(x, device=cuda),
            torch.as_tensor(mask, device=cuda), normal(N, 3),
            normal(N, spec.n_output_dims), normal(N, spec.n_output_dims))


def _kb2_check(args, need_x):
    """Pass 2 against its twin within its tolerance in chip_smoke.py: float
    atomics (the kernel's and index_add_'s) sum a row in changing order."""
    before = kernels.launches["encode_mlp_sdfgrad_bwd_scatter"]
    dt, dx = EG.encode_mlp_sdfgrad_bwd_scatter(*args, need_x)
    assert kernels.launches["encode_mlp_sdfgrad_bwd_scatter"] == before + 1
    dt_r, dx_r = EG.encode_mlp_sdfgrad_bwd_scatter_plain(*args, need_x)
    _close(dt, dt_r)
    if need_x:
        assert dx.shape == dx_r.shape
        _close(dx, dx_r)
    else:
        assert dx is None
    return dt


@pytest.mark.parametrize("need_x", [False, True])
@pytest.mark.parametrize("include_xyz", [False, True])
@pytest.mark.parametrize("n", [1, KB2_TILE - 1, KB2_TILE + 1,
                               3 * KB2_TILE + 5, 20_011])
@pytest.mark.parametrize("which", list(KB2_SPECS))
def test_encode_grad_scatter_tiles_and_widths(cuda, which, n, include_xyz,
                                              need_x):
    """Ragged tiles, F = 1 to 4, ray-ordered points (a tenth outside the
    domain, a few saturating the cell cast), levels masked off."""
    kw = KB2_SPECS[which]
    L, F = kw["n_levels"], kw["n_features_per_level"]
    mask = np.ones((L, F), np.float32)
    mask[[1, L - 1]] = 0.0
    mask[L - 3, 0] = 0.0           # one feature of a level
    args = _kb2_case(cuda, kw, _ka_points(n, True, seed=n + 11),
                     include_xyz, mask.reshape(-1), seed=n)
    dt = _kb2_check(args, need_x)
    assert not dt[1].any() and not dt[L - 1].any()


@pytest.mark.parametrize("need_x", [False, True])
@pytest.mark.parametrize("which", ["published", "f1", "f3", "f4"])
def test_encode_grad_scatter_full_merge(cuda, which, need_x):
    """Every warp's 32 points at one position: at every level each corner's
    32 lanes add into one row (the merge at its fullest), beside a tile of
    points spread at random."""
    kw = KB2_SPECS[which]
    L, F = kw["n_levels"], kw["n_features_per_level"]
    rng = np.random.default_rng(41)
    same = np.repeat(rng.uniform(0.1, 0.9, (4, 1, 3)), 32, 1).reshape(-1, 3)
    x = np.concatenate([same, rng.uniform(0, 1, (KB2_TILE, 3))])
    args = _kb2_case(cuda, kw, x.astype(np.float32), True,
                     np.ones(L * F, np.float32), seed=42)
    _kb2_check(args, need_x)


def test_encode_grad_scatter_every_level_masked(cuda):
    """A mask that zeroes every level adds nothing; d_xn keeps only the
    xyz columns' term."""
    kw = KB2_SPECS["published"]
    args = _kb2_case(cuda, kw, _ka_points(1000, True, seed=43), True,
                     np.zeros(32, np.float32), seed=44)
    dt = _kb2_check(args, True)
    assert not dt.any()


@pytest.mark.parametrize("need_x", [False, True])
@pytest.mark.parametrize("which", ["published", "f1", "f3", "f4"])
def test_encode_grad_scatter_table_at_4_bytes(cuda, which, need_x):
    """A table that starts 4 bytes past an 8-byte boundary: taken wherever
    its rows are read with scalar loads, refused only where F = 2 reads
    them as float2 (d_xn)."""
    kw = KB2_SPECS[which]
    L, F = kw["n_levels"], kw["n_features_per_level"]
    args = list(_kb2_case(cuda, kw, _ka_points(3 * KB2_TILE + 5, True,
                                                 seed=45), True,
                          np.ones(L * F, np.float32), seed=46))
    buf = torch.empty(args[1].numel() + 1, device=cuda)
    table = buf[1:].view(args[1].shape)
    table.copy_(args[1])
    assert table.data_ptr() % 8 == 4
    args[1] = table
    if F == 2 and need_x:
        with pytest.raises(ValueError, match="8-byte aligned"):
            EG.encode_mlp_sdfgrad_bwd_scatter(*args, need_x)
    else:
        _kb2_check(tuple(args), need_x)


# ---------------------------------------------------------------- KA' tiles
def _ka2_case(cuda, kw, x, include_xyz, mask, seed):
    spec = HG.HashGridSpec(include_xyz=include_xyz, **kw)
    rng = np.random.default_rng(seed)
    L, F = kw["n_levels"], kw["n_features_per_level"]
    T = 1 << kw["log2_hashmap_size"]
    table = torch.as_tensor(rng.uniform(-0.1, 0.1, (L, T, F)),
                            dtype=torch.float32, device=cuda)
    g = rng.normal(size=(x.shape[0], spec.n_output_dims)).astype(np.float32)
    return (table, torch.as_tensor(x, device=cuda), spec,
            torch.as_tensor(g, device=cuda),
            None if mask is None else torch.as_tensor(mask, device=cuda))


def _ka2_check(args, need_x):
    """KA' against its twin: the table cotangent within twice the summation
    error bound of each row's terms (as test_hashgrid_bwd_kernel_matches_
    twin), d_x within the tolerance of chip_smoke.py and the same bits on
    a second call (it is summed in level order, without atomics)."""
    table, x, spec, g, mask = args
    before = kernels.launches["hashgrid_encode_bwd"]
    dt, dx = HG.hashgrid_encode_bwd(*args, need_x)
    assert kernels.launches["hashgrid_encode_bwd"] == before + 1
    dt_r, dx_r = HG.hashgrid_encode_bwd_plain(*args, need_x)
    c = _row_terms(x, spec, table.shape[1])
    abs_terms = HG.hashgrid_encode_bwd_plain(table, x, spec, g.abs(), mask,
                                             False)[0]
    eps = torch.finfo(torch.float32).eps
    assert float(((dt - dt_r).abs() - c * eps * abs_terms).max()) <= 0.0
    if need_x:
        assert dx.shape == dx_r.shape
        _close(dx, dx_r)
        _, dx2 = HG.hashgrid_encode_bwd(*args, True)
        assert torch.equal(dx.view(torch.int32), dx2.view(torch.int32))
    else:
        assert dx is None
    return dt, dx


@pytest.mark.parametrize("need_x", [False, True])
@pytest.mark.parametrize("include_xyz", [False, True])
@pytest.mark.parametrize("n", [1, KA_TILE - 1, KA_TILE + 1,
                               3 * KA_TILE + 5, 20_011])
@pytest.mark.parametrize("which", list(KA_SPECS))
def test_hashgrid_bwd_tiles_and_widths(cuda, which, n, include_xyz, need_x):
    """Ragged tiles, F = 1 to 4, ray-ordered points (a tenth outside the
    domain, a few saturating the cell cast), levels masked off."""
    kw = KA_SPECS[which]
    L, F = kw["n_levels"], kw["n_features_per_level"]
    mask = np.ones((L, F), np.float32)
    mask[[1, L - 1]] = 0.0
    mask[L - 3, 0] = 0.0           # one feature of a level
    args = _ka2_case(cuda, kw, _ka_points(n, True, seed=n + 13),
                     include_xyz, mask.reshape(-1), seed=n + 1)
    dt, _ = _ka2_check(args, need_x)
    assert not dt[1].any() and not dt[L - 1].any()


@pytest.mark.parametrize("need_x", [False, True])
@pytest.mark.parametrize("which", ["published", "f1", "f3", "f4"])
def test_hashgrid_bwd_full_merge(cuda, which, need_x):
    """Every warp's 32 points at one position: at every level each corner's
    32 lanes add into one row (the merge at its fullest), beside a tile of
    points spread at random; no level mask."""
    kw = KA_SPECS[which]
    rng = np.random.default_rng(51)
    same = np.repeat(rng.uniform(0.1, 0.9, (4, 1, 3)), 32, 1).reshape(-1, 3)
    x = np.concatenate([same, rng.uniform(0, 1, (KA_TILE, 3))])
    args = _ka2_case(cuda, kw, x.astype(np.float32), True, None, seed=52)
    _ka2_check(args, need_x)


def test_hashgrid_bwd_every_level_masked(cuda):
    """A mask that zeroes every level adds nothing; d_x keeps only the xyz
    columns' term."""
    kw = KA_SPECS["published"]
    args = _ka2_case(cuda, kw, _ka_points(1000, True, seed=53), True,
                     np.zeros(32, np.float32), seed=54)
    dt, dx = _ka2_check(args, True)
    assert not dt.any()
    torch.testing.assert_close(dx, args[3][:, :3] * args[2].xyz_scale,
                               rtol=0, atol=0)


@pytest.mark.parametrize("need_x", [False, True])
@pytest.mark.parametrize("which", ["published", "f1", "f3", "f4"])
def test_hashgrid_bwd_table_at_4_bytes(cuda, which, need_x):
    """A table that starts 4 bytes past an 8-byte boundary: taken wherever
    its rows are read with scalar loads or not at all, refused only where
    F = 2 reads them as float2 (d_x)."""
    kw = KA_SPECS[which]
    L, F = kw["n_levels"], kw["n_features_per_level"]
    args = list(_ka2_case(cuda, kw, _ka_points(3 * KA_TILE + 5, True,
                                                 seed=55), True,
                          np.ones(L * F, np.float32), seed=56))
    buf = torch.empty(args[0].numel() + 1, device=cuda)
    table = buf[1:].view(args[0].shape)
    table.copy_(args[0])
    assert table.data_ptr() % 8 == 4
    args[0] = table
    if F == 2 and need_x:
        with pytest.raises(ValueError, match="8-byte aligned"):
            HG.hashgrid_encode_bwd(*args, need_x)
    else:
        _ka2_check(tuple(args), need_x)


def test_hashgrid_bwd_refuses_widths_beyond_its_tile(cuda):
    # 33 levels: more than the 32 level slots of the tile's shared memory
    spec = HG.HashGridSpec(n_levels=33, n_features_per_level=1,
                           log2_hashmap_size=8)
    table = torch.zeros((33, 256, 1), device=cuda)
    x = torch.rand((16, 3), device=cuda)
    g = torch.zeros((16, 33), device=cuda)
    with pytest.raises(RuntimeError):
        HG.hashgrid_encode_bwd(table, x, spec, g, None, True)


# ---------------------------------------------------------------- KF warps
KF_KINDS = ("march", "no_valid", "zero_mass", "mass_above_1", "ties",
            "nan_tail", "all_nan", "nan_weight", "equal_edges")


def _kf_case(R, E, B, seed):
    """``R`` rays of ``E`` edges, ray r of kind ``KF_KINDS[r % 9]``: a
    march's left-packed ascending edges with random flags and a bump of
    weights of mass below 1; no valid edge; zero mass; mass above 1; every
    valid edge opening and closing with weights 1/128 (the CDF steps by
    1/128, so the draws land exactly on old edges: ties); the last valid
    edges NaN; every edge NaN; a NaN weight on a real interval; runs of
    equal edges (zero-length intervals).  Returns numpy arrays and each
    ray's foreground mass (float64)."""
    rng = np.random.default_rng(seed)
    kind = np.arange(R) % len(KF_KINDS)
    n_valid = rng.integers(2, E + 1, R)
    n_valid[kind == 1] = 0
    n_valid[np.isin(kind, (4, 5, 6))] = E
    valid = np.arange(E)[None, :] < n_valid[:, None]
    vals = np.sort(rng.uniform(1.0, 4.0, (R, E)), -1).astype(np.float32)
    eq = kind == 8
    vals[eq] = np.round(vals[eq] * 4.0) / 4.0       # runs of equal edges
    vals[kind == 5, E - 3:] = np.nan
    vals[kind == 6] = np.nan
    vals = np.where(valid, vals, np.inf).astype(np.float32)
    is_left = valid & (rng.random((R, E)) < 0.8)
    is_right = valid & (rng.random((R, E)) < 0.8)
    is_left[kind == 4] = True
    is_right[kind == 4] = True
    c = rng.uniform(0, 1, (R, 1)) * np.maximum(n_valid[:, None], 1)
    w = np.exp(-0.5 * ((np.arange(E)[None, :] - c) / 4.0) ** 2)
    w *= rng.uniform(0.05, 0.95, (R, 1)) / w.sum(-1, keepdims=True)
    w[kind == 2] = 0.0
    w[kind == 3] *= 40.0
    w[kind == 4] = np.where(np.arange(E) < 128, 1.0 / 128.0, 0.0)
    w = w.astype(np.float32)
    real = valid[:, :-1] & valid[:, 1:] & is_left[:, :-1] & is_right[:, 1:]
    real = np.concatenate([real, np.zeros((R, 1), bool)], 1)
    nan_rows = np.nonzero((kind == 7) & real.any(-1))[0]
    w[nan_rows, real[nan_rows].argmax(-1)] = np.nan
    mass = np.where(real, w.astype(np.float64), 0.0).sum(-1)
    return (vals, is_left & valid, is_right & valid, valid, w), mass


def _same_bits(a, b):
    """Per ray: every output slot equal bit for bit (floats by their bits,
    so NaNs compare)."""
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return (a == b).all(-1)


def _same_slots(a, b):
    """Per ray: every output slot equal, a NaN to any NaN (the CPU keeps an
    operand's NaN where the card returns its canonical one)."""
    eq = a == b
    if a.dtype == torch.float32:
        eq |= torch.isnan(a) & torch.isnan(b)
    return eq.all(-1)


@pytest.mark.parametrize("B", [1, 16, RS.MAX_BINS])
@pytest.mark.parametrize("E", [129, 145])
def test_merge_resample_kernel_cases(cuda, E, B):
    """KF against its twin run on the CPU (whose cumsum sums in double in
    order, as the kernel does) and against itself: rays of mass at most 1
    (the CDF's denominator is then exactly 1 on both sides) equal bit for
    bit; all rays but 1e-3 equal on flags and indices, the values within
    1e-5 (above mass 1 the twin sums the mass in float); two calls equal
    bit for bit; rays with no valid edge in the +inf layout."""
    R = 4096
    arrays, mass = _kf_case(R, E, B, seed=E * 100 + B)
    args = tuple(torch.as_tensor(a, device=cuda) for a in arrays) + (B,)
    before = kernels.launches["merge_resample"]
    out = RS.merge_resample_rays(*args)
    assert kernels.launches["merge_resample"] == before + 1
    again = RS.merge_resample_rays(*args)
    ref = RS.merge_resample_rays_plain(
        *(t.cpu() for t in args[:5]), B)
    ones = torch.ones(R, dtype=torch.bool)
    for a, b in zip(out, again):
        assert bool(_same_bits(a, b).all())
    exact, same = ones.clone(), ones.clone()
    for name in out._fields:
        a, b = getattr(out, name).cpu(), getattr(ref, name)
        assert a.shape == b.shape == (R, E + B) and a.dtype == b.dtype
        exact &= _same_slots(a, b)
        if name != "vals":
            same &= (a == b).all(-1)
    low = torch.as_tensor(mass <= 1.0)
    assert bool(exact[low].all()), torch.nonzero(~exact & low)[:8].tolist()
    assert same.float().mean().item() >= 0.999
    v, vr = out.vals.cpu()[same], ref.vals[same]
    finite = torch.isfinite(vr)
    assert torch.equal(torch.isnan(v), torch.isnan(vr))
    torch.testing.assert_close(v[finite], vr[finite], rtol=0, atol=1e-5)
    # the cases were reached: ties, NaN draws placed, nothing placed
    kind = torch.arange(R) % len(KF_KINDS)
    tie = ref.is_new[kind == 4] & (ref.vals[kind == 4] == torch.roll(
        ref.vals[kind == 4], 1, 1))
    assert bool(tie.any())
    assert bool((ref.is_new & torch.isnan(ref.vals)).any())
    for k in (1, 2, 7):
        assert not ref.is_new[kind == k].any()
    none = out.vals.cpu()[kind == 1]
    assert torch.isinf(none).all() and not out.valid.cpu()[kind == 1].any()
    assert torch.equal(out.gather_idx.cpu()[kind == 1],
                       torch.arange(E + B).expand(int((kind == 1).sum()),
                                                  E + B))


def test_merge_resample_refuses_rows_beyond_shared_memory(cuda):
    R, E = 4, RS.MAX_EDGES + 1
    vals = torch.zeros((R, E), device=cuda)
    flags = torch.ones((R, E), dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError, match="edges a ray"):
        RS.merge_resample_rays(vals, flags, flags, flags, vals, 16)


# ---------------------------------------------------------------- KD weights
KD_BLOCK = 128  # rows a block of the short form (csrc/volrend.cu)


def _kd_rows(cuda, R, S, seed, offset=0):
    """``[R, S]`` alphas and mask: random alphas with 0 and 1 among them, a
    fully masked row, a row whose middle alpha is 1, NaN at masked slots;
    with ``offset``, the alphas and mask lie ``offset`` elements into their
    storage (not 16-byte aligned)."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.0, 0.3, (R, S)).astype(np.float32)
    a[rng.random((R, S)) < 0.05] = 0.0
    a[rng.random((R, S)) < 0.01] = 1.0
    m = rng.random((R, S)) < 0.7
    m[0] = False                                  # fully masked
    if R > 1:
        m[1] = True
        a[1, S // 2] = 1.0                        # opaque mid-row
    a[~m] = np.nan
    flat_a = torch.zeros(offset + R * S, device=cuda)
    flat_a[offset:] = torch.as_tensor(a.reshape(-1), device=cuda)
    flat_m = torch.zeros(offset + R * S, dtype=torch.bool, device=cuda)
    flat_m[offset:] = torch.as_tensor(m.reshape(-1), device=cuda)
    return (flat_a[offset:].view(R, S), flat_m[offset:].view(R, S))


def _kd_kernels(fn):
    """The names of the KD weights kernels that ``fn`` launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.name for e in prof.events()
            if e.device_type == DeviceType.CUDA and "weights_kernel" in e.name}


@pytest.mark.parametrize("S", [1, 3, 4, 16, 17, 64, 129, 145, 161, 300])
def test_volrend_weights_forms_match_twin(cuda, S):
    """KD weights at every row length the path uses and around them (the
    short form at S 4 and 16, the warp form at the others, over two
    segments at 300), R not a multiple of a block: within the scan's
    rounding of the twin (rtol 1e-5, atol 1e-6), masked NaNs read as 0, T 1
    on a fully masked row and 0 after an opaque sample; two calls bit for
    bit."""
    R = 3 * KD_BLOCK + 5
    alphas, mask = _kd_rows(cuda, R, S, seed=S)
    before = kernels.launches["volrend_weights"]
    w, t = V.render_weight_from_alpha(alphas, mask)
    assert kernels.launches["volrend_weights"] == before + 1
    w_r, t_r = V.render_weight_from_alpha_plain(alphas.cpu(), mask.cpu())
    assert torch.isfinite(w).all() and torch.isfinite(t).all()
    torch.testing.assert_close(w.cpu(), w_r, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(t.cpu(), t_r, rtol=1e-5, atol=1e-6)
    assert not w[0].any() and bool((t[0] == 1.0).all())
    assert not t[1, S // 2 + 1:].any()
    w2, t2 = V.render_weight_from_alpha(alphas, mask)
    assert torch.equal(w, w2) and torch.equal(t, t2)


@pytest.mark.parametrize("S", [4, 17, 145])
def test_volrend_weights_unaligned_rows(cuda, S):
    """Alphas and mask that start off a 16-byte boundary take the warp
    form, within the twin's tolerance; at S > 16 the aligned call takes it
    too and gives the same bits."""
    R = KD_BLOCK + 9
    alphas, mask = _kd_rows(cuda, R, S, seed=100 + S, offset=1)
    assert alphas.data_ptr() % 16 and mask.data_ptr() % 16
    w, t = V.render_weight_from_alpha(alphas, mask)
    w_r, t_r = V.render_weight_from_alpha_plain(alphas.cpu(), mask.cpu())
    torch.testing.assert_close(w.cpu(), w_r, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(t.cpu(), t_r, rtol=1e-5, atol=1e-6)
    if S > 16:
        w_a, t_a = V.render_weight_from_alpha(alphas.clone(), mask.clone())
        assert torch.equal(w, w_a) and torch.equal(t, t_a)


def test_volrend_weights_picks_the_form_by_row_length(cuda):
    """Rows of up to 16 samples in whole 16-byte words take the short form
    (a thread a row), every other row the warp form; an empty call
    launches nothing."""
    for S, offset, words in ((4, 0, True), (16, 0, True), (4, 1, False),
                             (3, 0, False), (17, 0, False),
                             (145, 0, False)):
        alphas, mask = _kd_rows(cuda, 7, S, seed=7, offset=offset)
        names = _kd_kernels(lambda: V.render_weight_from_alpha(alphas, mask))
        assert len(names) == 1, names
        assert ("weights_kernel<true>" in names.pop()) == words, (S, offset)
    empty = torch.zeros((0, 4), device=cuda)
    before = kernels.launches["volrend_weights"]
    w, t = V.render_weight_from_alpha(empty, empty > 0)
    assert w.shape == (0, 4) and t.shape == (0, 4)
    assert kernels.launches["volrend_weights"] == before


# ---------------------------------------------------------------- KL
def _kl_args(body, M, seeded, seed):
    """``M`` points near the posed body seeded from KC's roots nudged (a
    fifth of them far), ``seeded`` the ``seed_ok`` mask to apply."""
    args = _kc_lanes(body, M, seed=seed)
    res = TB.broyden_search(*args)
    rng = np.random.default_rng(seed + 1)
    scale = np.where(rng.random(M) < 0.8, 0.01, 0.3)[:, None]
    xs = res.x + torch.as_tensor(rng.normal(size=(M, 3)) * scale,
                                 dtype=torch.float32, device="cuda")
    ok = res.valid & torch.as_tensor(seeded, device="cuda")
    return (args[0], xs.contiguous(), ok, args[2], args[4], args[5])


def _kl_check(pargs, **kw):
    """KL against its twin: valid equal, x and J^-1 within 1e-5 of the
    largest entry, zeros where invalid; a second call bit for bit the
    same."""
    before = kernels.launches["broyden_polish"]
    out = TB.broyden_polish(*pargs, **kw)
    assert kernels.launches["broyden_polish"] == before + 1
    ref = TB.broyden_polish_plain(*pargs, **kw)
    assert torch.equal(out.valid, ref.valid)
    assert not out.valid[~pargs[2]].any()
    for a, b in ((out.x, ref.x), (out.j_inv, ref.j_inv)):
        assert (a - b).abs().max() <= 1e-5 * max(b.abs().max(), 1e-30)
    assert not out.x[~out.valid].any() and not out.j_inv[~out.valid].any()
    for a, b in zip(TB.broyden_polish(*pargs, **kw), out):
        assert torch.equal(a, b)
    return out, ref


@pytest.mark.parametrize("M", [1, 15, 17, 63, 65, 1000, 40_003, 140_001])
@pytest.mark.parametrize("which", ["none", "one_a_warp", "all", "mixed"])
def test_broyden_polish_kernel_seeding(cuda, posed_body, M, which):
    """KL at M not a multiple of its 128-point blocks, in its spread form
    (up to 131,072 points, 4-point chunks spread over the blocks) and its
    lane-order form (140,001), with no point seeded, one point in 32, every
    point and 90% at random."""
    rng = np.random.default_rng(M)
    seeded = {"none": np.zeros(M, bool),
              "one_a_warp": np.arange(M) % 32 == 5,
              "all": np.ones(M, bool),
              "mixed": rng.random(M) < 0.9}[which]
    pargs = _kl_args(posed_body, M, seeded, seed=M + 7)
    out, _ = _kl_check(pargs, max_iters=4)
    if which == "none":
        assert not out.valid.any()


def test_broyden_polish_kernel_front_packed(cuda, posed_body):
    """A fine pass's budget as the compaction lays it out: the valid slots
    first (most seeded), then padding at the origin, unseeded; with the
    seed grid's 6 iterations."""
    M, n = 65_536, 6_000
    pargs = list(_kl_args(posed_body, M, np.arange(M) < n, seed=50))
    pargs[0] = pargs[0].clone()
    pargs[0][n:] = 0.0
    pargs[2] = pargs[2] & torch.as_tensor(
        np.random.default_rng(51).random(M) < 0.95, device="cuda")
    out, _ = _kl_check(tuple(pargs), max_iters=6)
    assert out.valid[:n].float().mean().item() > 0.3


def test_broyden_polish_kernel_is_the_search_lane(cuda, posed_body):
    """Seeded at KC's start points with KC's iterations, KL gives KC's
    outputs bit for bit: the two kernels run one lane body."""
    args = _kc_lanes(posed_body, 5_000, seed=52)
    xd, bone, vox, tfs = args[0], args[1], args[2], args[3]
    T = tfs[:, :3, :].reshape(tfs.shape[0], 12)[bone.long()].unbind(-1)
    dx, dy, dz = (xd[:, 0] - T[3], xd[:, 1] - T[7], xd[:, 2] - T[11])
    start = torch.stack([T[0] * dx + T[4] * dy + T[8] * dz,
                         T[1] * dx + T[5] * dy + T[9] * dz,
                         T[2] * dx + T[6] * dy + T[10] * dz], -1)
    kc = TB.broyden_search(*args)
    for ok in (torch.ones(5_000, dtype=torch.bool, device=cuda),
               torch.arange(5_000, device=cuda) < 100):
        kl = TB.broyden_polish(xd, start.contiguous(), ok, vox, args[4],
                               args[5], max_iters=10)
        for a, b in zip(kl, kc):
            assert torch.equal(a[ok], b[ok])
    assert 0.05 < kc.valid.float().mean().item() < 0.95
