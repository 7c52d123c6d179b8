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


@pytest.mark.parametrize("sample_major", [False, True])
@pytest.mark.parametrize("budget_of", ["below", "at", "above"])
def test_compact_kernel_matches_twin(cuda, sample_major, budget_of):
    rng = np.random.default_rng(6)
    mask = torch.as_tensor(rng.random((4096, 160)) < 0.2, device=cuda)
    n_valid = int(mask.sum())
    budget = {"below": n_valid - 1000, "at": n_valid,
              "above": n_valid + 70_000}[budget_of]
    m = mask if sample_major else mask.reshape(-1)
    fn = C.compact_indices_interleaved if sample_major else C.compact_indices
    idx, picked = fn(m, budget)
    ref_idx, ref_picked = C.compact_indices_plain(m, budget, sample_major)
    assert torch.equal(idx, ref_idx) and torch.equal(picked, ref_picked)


def _rigid_table(cuda, seed=7):
    rng = np.random.default_rng(seed)
    rots = []
    for _ in range(13):
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        rots.append(q)
    T = np.zeros((13, 4, 4))
    T[:, :3, :3] = rots
    T[:, :3, 3] = rng.normal(scale=0.3, size=(13, 3))
    T[:, 3, 3] = 1.0
    segs = rng.normal(scale=0.4, size=(13, 2, 3)).astype(np.float32)
    # rows 4 and 9 identical: every point has a tie between them
    T[9], segs[9] = T[4], segs[4]
    # row 2's segment is a point: zero length, the denominator is 1e-9
    segs[2, 1] = segs[2, 0]
    return (torch.as_tensor(T, dtype=torch.float32, device=cuda),
            torch.as_tensor(TB.segment_table(segs), device=cuda))


def test_deform_prologue_kernel_matches_twin(cuda):
    tfs_table, segs = _rigid_table(cuda)
    pts = torch.randn(200_000, 3, generator=torch.Generator().manual_seed(8)
                      ).to(cuda) * 0.5
    for I in (1, 8, 12):
        slot = TB.deform_prologue(pts, tfs_table, segs, I)
        ref = TB.deform_prologue_plain(pts, tfs_table, segs, I)
        assert torch.equal(slot, ref), I


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


@pytest.mark.parametrize("need_rot", [False, True])
def test_deform_epilogue_kernel_matches_twin(cuda, need_rot):
    res = _search_result(cuda)
    lbs_cl, spec, tfs = _skin_inputs(cuda)
    args = (res, 8, 4, need_rot, lbs_cl, spec, tfs)
    before = kernels.launches["deform_skinning"]
    out = TB.deform_epilogue(*args)
    assert kernels.launches["deform_skinning"] == before + int(need_rot)
    ref = TB.deform_epilogue_plain(*args)
    for a, b in zip(out[:4], ref[:4]):
        assert torch.equal(a, b)
    assert ref.overflow.item() > 0
    if need_rot:
        # the blend sums the 24 bones in order, the twin's matrix product
        # in cuBLAS's order
        torch.testing.assert_close(out.fwd_rot, ref.fwd_rot, rtol=0,
                                   atol=1e-5)
    else:
        assert out.fwd_rot is None and ref.fwd_rot is None


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
    tile), some invalid and some outside the weight voxel (border
    padding), with and without a rotation cotangent."""
    lbs_cl, spec, _ = _skin_inputs(cuda)
    rng = np.random.default_rng(13)
    M = 300_001
    f = lambda a: torch.as_tensor(a.astype(np.float32), device=cuda)
    args = (f(rng.uniform(-1.2, 1.2, (M, 3))),
            torch.as_tensor(rng.random(M) < 0.7, device=cuda),
            f(rng.normal(size=(M, 9))), f(rng.normal(size=(M, 3))),
            f(rng.normal(size=(M, 9))) if with_rot else None, lbs_cl, spec)
    _kn_check(args)


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
                           None, None, None)
    with pytest.raises(ValueError):
        TB.deform_epilogue(res, 8, 9, False, None, None, None)
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


@pytest.mark.parametrize("sdf_mode", [True, False])
def test_fine_resample_kernel_matches_twin(cuda, sdf_mode):
    rng = np.random.default_rng(12)
    ts, te, w, sdf, mask = _pbr_rows(rng, 32768, 64, gaps=True)
    if sdf_mode:
        alphas = np.where(mask, rng.uniform(0.0, 1.0, mask.shape) ** 2, 0.0)
        args = _dev(cuda, ts, te, alphas.astype(np.float32), sdf, mask)
        out = RS.sdf_fine_resample_rays(*args, 4)
        ref = RS.sdf_fine_resample_rays_plain(*args, 4)
    else:
        args = _dev(cuda, ts, te, w, mask)
        out = RS.fine_resample_rays(*args, 4)
        ref = RS.fine_resample_rays_plain(*args, 4)
    assert torch.equal(out.mask, ref.mask)
    # only placed intervals are read
    for a, b in ((out.t_starts, ref.t_starts), (out.t_ends, ref.t_ends)):
        _close_where(a, b, ref.mask)
    assert ref.mask.any() and not ref.mask[:8].any()


@pytest.mark.parametrize("cap", [8, 0])
def test_secondary_march_kernel_matches_twin(cuda, cap):
    rng = np.random.default_rng(13)
    M, S, res = 32768, 64, 64
    # a sparse grid: occupied steps with empty ones between them leave
    # masked gaps in the packed samples, which the cap must not count
    grid = rng.random((res, res, res)) < 0.3
    aabb = np.asarray([-1.25, -1.55, -1.25, 1.25, 0.95, 1.25], np.float32)
    o = rng.uniform(-0.8, 0.6, (M, 3)).astype(np.float32)
    d = rng.normal(size=(M, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d[-100:] = 1.0                        # a padded chunk's rays
    active = rng.random(M) < 0.6
    args = _dev(cuda, o, d, grid, aabb)
    near = torch.zeros(M, device=cuda)
    far = torch.full((M,), 1.5, device=cuda)
    before = kernels.launches["secondary_march"]
    out = G.secondary_march(*args, 1.5 / 63, S, near, far,
                            torch.as_tensor(active, device=cuda), cap)
    assert kernels.launches["secondary_march"] == before + 1
    ref = G.secondary_march_plain(*args, 1.5 / 63, S, near, far,
                                  torch.as_tensor(active, device=cuda), cap)
    assert torch.equal(out[2], ref[2])
    # the same f32 operations in the same order
    for a, b in zip(out[:2], ref[:2]):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)
    m = ref[2]
    assert m.any() and not m[torch.as_tensor(~active, device=cuda)].any()
    if cap:
        assert int(m.sum(1).max()) == cap


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
