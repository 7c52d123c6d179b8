"""The plain twins of the relight path's kernels against the JAX package on
the CPU: KI (``cdf_resample_rays``), KJ (``sdf_fine_resample_rays`` and
``fine_resample_rays``), KK (the secondary march: ``occupancy_sampling`` +
``intervals_to_samples`` + the active mask + the cap of
``render/pbr.py:197-219``) and KL (``broyden_polish``), with their edge
cases, and the seeded canonicalization ``FastSNARF.deform_seeded``.

Integer and bool outputs must be equal; floats within 1e-5 (f32 on both
sides; the twins sum their CDFs in double and round to float, JAX sums in
float).  The kernels themselves: ``test_torch_kernels.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from intrinsicavatar_tpu.anim import broyden as JB
from intrinsicavatar_tpu.anim import deformer as JD
from intrinsicavatar_tpu.anim import lbs_voxel as JL
from intrinsicavatar_tpu.ops import grid_traversal as JG
from intrinsicavatar_tpu.ops import resample as JR
from intrinsicavatar_tpu.utils.config import wrap as jwrap
from intrinsicavatar_tpu_torch.anim import broyden as TB
from intrinsicavatar_tpu_torch.anim import deformer as TD
from intrinsicavatar_tpu_torch.ops import compact as TC
from intrinsicavatar_tpu_torch.ops import grid_traversal as TG
from intrinsicavatar_tpu_torch.ops import resample as TR
from intrinsicavatar_tpu_torch.utils.config import wrap as twrap


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Tier-1 runs six test workers on one host: keep each worker's torch
    pool small so it does not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


TOL = dict(rtol=1e-5, atol=1e-5)
T = torch.as_tensor


def _rows(rng, R, S, n_valid=None, gaps=False):
    """``[R, S]`` left-packed samples: ascending t, nonnegative weights
    (some rows over unit mass), SDF falling through zero."""
    n = rng.integers(0, S + 1, R) if n_valid is None else np.full(R, n_valid)
    mask = np.arange(S)[None] < n[:, None]
    dt = rng.uniform(0.01, 0.05, (R, S)).astype(np.float32)
    t0 = np.cumsum(dt, 1) + rng.uniform(0.0, 1.0, (R, 1))
    t_starts = t0.astype(np.float32)
    t_ends = (t0 + (dt * rng.uniform(0.3, 1.0, (R, S)) if gaps
                    else np.roll(dt, -1, 1))).astype(np.float32)
    # no near-empty interval: a draw's t moves by (one ulp of the CDF) /
    # (the interval's weight) x its length, and the two packages round
    # their CDF sums apart by an ulp
    w = rng.uniform(0.02, 1.0, (R, S))
    w = w / w.sum(1, keepdims=True) * rng.uniform(0.2, 1.3, (R, 1))
    sdf = (rng.uniform(0.1, 0.6, (R, 1)) - np.cumsum(
        rng.uniform(0.0, 0.05, (R, S)), 1)).astype(np.float32)
    z = lambda a: np.where(mask, a, 0.0).astype(np.float32)
    return z(t_starts), z(t_ends), z(w), sdf, mask


def _cdf_both(args, B):
    ref = JR.cdf_resample_rays(*(jnp.asarray(a) for a in args), B)
    out = TR.cdf_resample_rays(*(T(a) for a in args), B)
    return ref, out


def _check_cdf(ref, out):
    for name in ("indices", "is_bg", "fg_counts", "bg_count",
                 "surface_idx"):
        np.testing.assert_array_equal(getattr(out, name).numpy(),
                                      np.asarray(getattr(ref, name)), name)
    for name in ("ts", "offsets"):
        np.testing.assert_allclose(getattr(out, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   err_msg=name, **TOL)


@pytest.mark.parametrize("B", [1, 64, 512])
def test_cdf_resample_twin_matches_jax(B):
    rng = np.random.default_rng(B)
    args = _rows(rng, 300, 40)
    ref, out = _cdf_both(args, B)
    _check_cdf(ref, out)
    # the data reach every branch: background draws, pinned draws, and
    # surfaces both recorded and not
    assert out.is_bg.any() and (~out.is_bg).any()
    surf = out.surface_idx.numpy()
    assert (surf >= 0).any() and (surf < 0).any()


def test_cdf_resample_edge_cases():
    rng = np.random.default_rng(5)
    S, B = 12, 32
    ts, te, w, sdf, mask = _rows(rng, 6, S, n_valid=8)
    mask[0] = False                      # no valid sample
    w[1] = 0.0                           # all mass in the background
    sdf[2] = np.where(np.arange(S) == 0, 1e-3, -1.0)  # crossing in slot 0:
    w[2] = np.where(mask[2], 0.12, 0.0)               # no unpinned draw
    sdf[3] = np.where(np.arange(S) < 7, 0.2, -0.1)    # crossing in the last
    w[3] = np.where(mask[3], 0.125, 0.0)              # valid interval
    w[4] = np.where(np.arange(S) == 0, 1.0, 0.0)      # one interval, B = 32
    w, mask = w.astype(np.float32), mask
    ref, out = _cdf_both((ts, te, w, sdf, mask), B)
    _check_cdf(ref, out)
    assert out.is_bg[0].all() and out.is_bg[1].all()
    # every foreground draw of row 2 is pinned to t_starts[idx[0]]
    fg = ~out.is_bg[2].numpy()
    assert fg.sum() > 20
    np.testing.assert_allclose(out.ts[2].numpy()[fg], ts[2, 0], **TOL)
    assert int(out.surface_idx[3]) in (-1, 6)


@pytest.mark.parametrize("S", [16, 64])
def test_sdf_fine_resample_twin_matches_jax(S):
    rng = np.random.default_rng(S)
    ts, te, _, sdf, mask = _rows(rng, 400, S, gaps=True)
    alphas = np.where(mask, rng.uniform(0.0, 1.0, mask.shape) ** 2,
                      0.0).astype(np.float32)
    sdf[:5] = np.abs(sdf[:5])                        # no crossing
    sdf[5] = np.where(np.arange(S) == 0, 0.3, -0.2)  # crossing in slot 0
    mask[5, :3] = True
    sdf[6] = np.where(np.arange(S) < S - 1, 0.3, -0.2)  # in the last one
    mask[6] = True
    alphas[5:7] = 0.9
    args = (ts, te, alphas, sdf, mask)
    ref = JR.sdf_fine_resample_rays(*(jnp.asarray(a) for a in args), 4)
    out = TR.sdf_fine_resample_rays(*(T(a) for a in args), 4)
    np.testing.assert_array_equal(out.mask.numpy(), np.asarray(ref.mask))
    for name in ("t_starts", "t_ends"):
        np.testing.assert_allclose(getattr(out, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   err_msg=name, **TOL)
    m = out.mask.numpy()
    assert not m[:5].any() and m.any() and m[5].any() and m[6].any()


def test_fine_resample_twin_matches_jax():
    rng = np.random.default_rng(3)
    ts, te, w, _, mask = _rows(rng, 400, 64, gaps=True)
    mask[0] = False
    args = (ts, te, w, mask)
    ref = JR.fine_resample_rays(*(jnp.asarray(a) for a in args), 4)
    out = TR.fine_resample_rays(*(T(a) for a in args), 4)
    np.testing.assert_array_equal(out.mask.numpy(), np.asarray(ref.mask))
    for name in ("t_starts", "t_ends"):
        np.testing.assert_allclose(getattr(out, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   err_msg=name, **TOL)
    assert not out.mask[0].any() and out.mask.any() and (~out.mask).any()


def _jax_march(o, d, grid, aabb, step, S, near, far, active, cap):
    iv = JG.occupancy_sampling(jnp.asarray(o), jnp.asarray(d),
                               jnp.asarray(grid), jnp.asarray(aabb), step,
                               S, near=jnp.asarray(near),
                               far=jnp.asarray(far))
    ts, te, m = JG.intervals_to_samples(iv)
    m = m & jnp.asarray(active)[:, None]
    if 0 < cap < S:
        m = m & (jnp.cumsum(m.astype(jnp.int32), axis=1) <= cap)
    return np.asarray(ts), np.asarray(te), np.asarray(m)


@pytest.mark.parametrize("cap,S,occupancy", [
    pytest.param(8, 64, "sparse", id="8"),
    pytest.param(0, 64, "sparse", id="0"),
    pytest.param(8, 16, "sparse", id="S16-8"),
    pytest.param(0, 16, "sparse", id="S16-0"),
    pytest.param(0, 64, "full", id="full"),
    pytest.param(8, 64, "empty", id="empty"),
    pytest.param(8, 64, "miss", id="miss")])
def test_secondary_march_twin_matches_jax(cap, S, occupancy):
    """Sparse, full and empty grids; in every case some rays miss the box
    and some have far below near (``miss``: all but a few rays miss)."""
    rng = np.random.default_rng(cap + S)
    M, res = 600, 16
    # a sparse grid: occupied steps with empty ones between (masked gaps)
    grid = {"full": np.ones((res,) * 3, bool),
            "empty": np.zeros((res,) * 3, bool)}.get(
        occupancy, rng.random((res, res, res)) < 0.35)
    aabb = np.asarray([-1.0, -1.2, -1.0, 1.0, 0.8, 1.0], np.float32)
    o = rng.uniform(-0.6, 0.6, (M, 3)).astype(np.float32)
    d = rng.normal(size=(M, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d[:3] = 1.0                          # the padded rays' direction
    miss = slice(3, M - 20 if occupancy == "miss" else 40)
    o[miss], d[miss] = 2.5, [0.0, 1.0, 0.0]   # rays that miss the box
    # with the full grid all S steps of some rays are samples
    near = np.zeros(M, np.float32)
    far = np.full(M, 3.0 if occupancy == "full" else 1.5, np.float32)
    near[-20:-10], far[-20:-10] = 0.9, 0.4    # far below near
    active = rng.random(M) < 0.8
    step = 1.5 / (S - 1)
    ref = _jax_march(o, d, grid, aabb, step, S, near, far, active, cap)
    out = TG.secondary_march(T(o), T(d), T(grid), T(aabb), step, S, T(near),
                             T(far), T(active), cap)
    np.testing.assert_array_equal(out[2].numpy(), ref[2])
    for a, b in zip(out[:2], ref[:2]):
        np.testing.assert_allclose(a.numpy(), b, **TOL)
    m = ref[2]
    assert not m[~active].any()
    assert not m[miss].any() and not m[-20:-10].any()
    if occupancy == "empty":
        assert not m.any()
        return
    assert m.any()
    if cap:
        assert m.sum(1).max() <= cap
    if occupancy == "full":
        assert m.all(1).any()
    if occupancy == "sparse":
        if cap and S == 64:
            assert m.sum(1).max() == cap
        # some ray has a masked gap between two of its samples
        first = np.argmax(m, 1)
        last = S - 1 - np.argmax(m[:, ::-1], 1)
        assert any(m[r].any() and not m[r, first[r]:last[r] + 1].all()
                   for r in range(M))


POSE = np.zeros(69, np.float32)
POSE[2], POSE[5] = 0.4, -0.4
POSE[(18 - 1) * 3 + 1] = 0.9
RIGID = {"name": "fast-snarf", "model_path": "synthetic",
         "deformer_config": {"resolution": 32, "cano_pose": "a_pose",
                             "global_scale": 1.2, "use_j_inv": False,
                             "optimize_betas": False, "max_candidates": 4}}


def _smpl_params(lib):
    z = lambda n: lib.zeros((1, n)) if lib is jnp else torch.zeros(1, n)
    a = lambda v: lib.asarray(v) if lib is jnp else torch.as_tensor(v)
    return {"betas": a(np.zeros(10, np.float32)), "body_pose": a(POSE),
            "global_orient": a(np.zeros(3, np.float32)),
            "transl": a(np.asarray([0.0, 0.3, 2.0], np.float32)),
            "betas_correction": z(10), "pose_correction": z(69),
            "global_orient_correction": z(3), "transl_correction": z(3)}


@pytest.fixture(scope="module")
def deformers():
    jd = JD.FastSNARF(jwrap(RIGID))
    js = jd.initialize(np.zeros(10))
    jf = jd.prepare(js, _smpl_params(jnp))
    td = TD.FastSNARF(twrap(RIGID))
    ts = td.initialize(np.zeros(10), "cpu")
    lbs = torch.as_tensor(np.array(js.lbs_voxel))   # identical inputs
    ts = ts._replace(lbs_voxel=lbs, lbs_cl=TB.channel_last(lbs))
    tf = td.prepare(ts, _smpl_params(torch))
    return jd, js, jf, td, ts, tf


def _seeds(deformers, n, seed):
    """Targets skinned from canonical points, seeds near the points (most
    converge in the polish, far ones do not), ``seed_ok`` mostly set."""
    jd, js, jf = deformers[:3]
    vc = np.asarray(js.vs_template)
    rng = np.random.default_rng(seed)
    pts = (vc[rng.choice(len(vc), n)]
           + rng.normal(scale=0.02, size=(n, 3))).astype(np.float32)
    w = JB.grid_sample_3d(js.lbs_voxel, jd.spec.normalize(jnp.asarray(pts)),
                          padding="border")
    xd, _ = JB.forward_skinning(jnp.asarray(pts), w, jf.tfs)
    scale = np.where(rng.random(n) < 0.8, 0.01, 0.25)[:, None]
    seed_xc = (pts + rng.normal(size=(n, 3)) * scale).astype(np.float32)
    ok = rng.random(n) < 0.9
    return np.asarray(xd), seed_xc, ok


def _compacted_budget(xd, seed_xc, ok, rays, seed):
    """The lanes of a secondary fine pass as ``compact_apply`` lays them
    out: ``rays`` x 4 slots, a tenth of them valid, compacted sample-major
    into half of the slots (valid first, then padding); a slot's seed is
    usable only where it is valid, so most of the budget is unseeded."""
    valid = np.random.default_rng(seed).random((rays, 4)) < 0.1
    idx, _ = TC.compact_indices_interleaved(torch.as_tensor(valid),
                                            rays * 2)
    idx = idx.numpy()
    return xd[idx], seed_xc[idx], (ok & valid.reshape(-1))[idx]


@pytest.mark.parametrize("layout", ["scattered", "compacted"])
def test_broyden_polish_twin_matches_jax(deformers, layout):
    jd, js, jf, td, ts, tf = deformers
    if layout == "scattered":
        xd, seed_xc, ok = _seeds(deformers, 2000, 0)
    else:
        xd, seed_xc, ok = _compacted_budget(*_seeds(deformers, 8000, 2),
                                            rays=2000, seed=3)
        assert 0.1 < ok.mean() < 0.25   # most of the budget unseeded
    _, voxel_J = JL.precompute_transform_voxels(js.lbs_voxel, jf.tfs, jd.spec)
    ref = JB.broyden_polish(
        jnp.asarray(xd), *(jnp.asarray(seed_xc[:, i]) for i in range(3)),
        jnp.asarray(ok), jf.voxel_J_packed, jnp.asarray(jd.spec.offset),
        jnp.asarray(jd.spec.scale_kernel), shape_dhw=jd.spec.shape_dhw,
        max_iters=4)
    out = TB.broyden_polish(T(xd), T(seed_xc), T(ok),
                            T(np.array(voxel_J).transpose(1, 2, 3, 0).copy()),
                            jd.spec.offset,
                            jd.spec.scale_kernel, max_iters=4)
    valid = np.asarray(ref.valid)
    np.testing.assert_array_equal(out.valid.numpy(), valid)
    # seed_ok false stays invalid; far seeds fail within 4 iterations
    assert not valid[~ok].any()
    assert 0.5 < valid[ok].mean() < 0.99
    np.testing.assert_allclose(out.x.numpy(), np.asarray(ref.xc_array()),
                               atol=1e-5)
    # J^-1 is path-dependent (tests/test_torch_broyden.py): each rank-1
    # update divides by c . dg, which can be tiny, so a rounding apart in
    # one step grows with the later ones
    d_j = np.abs(out.j_inv.numpy()
                 - np.asarray(ref.jinv_array()).reshape(-1, 9))[valid]
    assert np.mean(d_j.max(-1) < 1e-4) > 0.75 and d_j.max() < 0.1
    assert not out.x.numpy()[~valid].any()


def _check_polish_roots(td, tf, xd, seed_xc, ok, x):
    """Assert that each valid root ``x`` of the port's seeded deform meets
    the polish's own stopping rule, ``|J(x) x^ - x_d| < cvg_thresh`` with
    ``J`` the frame's ``voxel_J`` sampled as the polish samples it; return
    each lane's bound on its distance (max norm) to another root that meets
    the rule: ``max(1e-5, 2 cvg_thresh |J^-1|_inf)``.

    Both residuals lie below ``cvg_thresh``, so they differ by less than
    ``2 cvg_thresh``; to first order the roots then differ by ``J^-1`` of
    that, at most ``2 cvg_thresh |J^-1|_inf`` in each coordinate, with
    ``J^-1`` the lane's own from the polish (Broyden's estimate at the
    root).  Two packages whose float32 paths stop one iteration apart
    differ by up to that much."""
    res = TB.broyden_polish(T(xd), T(seed_xc), T(ok), tf.voxel_J,
                            td.spec.offset, td.spec.scale_kernel,
                            cvg_thresh=td.cvg_thresh,
                            dvg_thresh=td.dvg_thresh,
                            max_iters=td.seed_polish_iters)
    v = res.valid.numpy()
    np.testing.assert_array_equal(res.x.numpy()[v], x[v])
    # the residual as TB._broyden_plain computes it where it converges
    xt = T(x)
    off = [float(a) for a in td.spec.offset]
    sk = [float(a) for a in td.spec.scale_kernel]
    norm = torch.stack([sk[a] * (xt[:, a] - off[a]) for a in range(3)], -1)
    J = TB.grid_sample_3d(tf.voxel_J.reshape(-1, 12),
                          tuple(tf.voxel_J.shape[:3]), norm).unbind(-1)
    r = [J[4 * a] * xt[:, 0] + J[4 * a + 1] * xt[:, 1]
         + J[4 * a + 2] * xt[:, 2] + J[4 * a + 3] - T(xd)[:, a]
         for a in range(3)]
    nsq = (r[0] * r[0] + r[1] * r[1] + r[2] * r[2]).numpy()
    assert (nsq[v] < td.cvg_thresh ** 2).all()
    j_inf = np.abs(res.j_inv.numpy().reshape(-1, 3, 3)).sum(-1).max(-1)
    return np.maximum(1e-5, 2.0 * td.cvg_thresh * j_inf)


def _seeded_outputs(ts, td, tf, tfn, xc):
    """``deform_seeded``'s sdf, grad_obs, grad_cano and feature at valid
    roots ``xc``, from the field ``tfn`` and the port's LBS rotation
    (``deform_skinning_plain``)."""
    (sdf, grad, feat), _ = tfn(xc)
    rot = TB.deform_skinning_plain(xc, ts.lbs_cl, td.spec, tf.tfs.detach())
    return (sdf, torch.einsum("mab,mb->ma", rot.reshape(-1, 3, 3), grad),
            grad, feat)


def test_deform_seeded_matches_jax(deformers):
    """The seeded canonicalization with a sphere SDF as the field.  The
    roots meet the polish's stopping rule and lie within
    ``_check_polish_roots``' bound of JAX's (1e-5 where that is larger).
    At a valid lane the other outputs equal the port's functions of its own
    root within 1e-6, and those functions at JAX's root equal JAX's outputs
    within 1e-5; at an invalid lane they equal JAX's within 1e-5."""
    jd, js, jf, td, ts, tf = deformers
    xd, seed_xc, ok = _seeds(deformers, 1500, 1)

    def jfn(xc):
        sdf = jnp.sqrt(jnp.sum(xc ** 2, -1)) - 0.3
        grad = xc / jnp.sqrt(jnp.sum(xc ** 2, -1, keepdims=True))
        return (sdf, grad, jnp.concatenate([sdf[:, None], xc], -1)), None

    def tfn(xc):
        sdf = torch.sqrt(torch.sum(xc ** 2, -1)) - 0.3
        grad = xc / torch.sqrt(torch.sum(xc ** 2, -1, keepdim=True))
        return (sdf, grad, torch.cat([sdf[:, None], xc], -1)), None

    from intrinsicavatar_tpu.utils import diag
    with diag.collect() as jc:
        ref = jd.deform_seeded(js, jf, jnp.asarray(xd), jnp.asarray(seed_xc),
                               jnp.asarray(ok), jfn, with_jac=True)
    tc = {}
    out = td.deform_seeded(ts, tf, T(xd), T(seed_xc), T(ok), tfn,
                           counters=tc)
    valid = out[2].numpy()
    np.testing.assert_array_equal(valid, np.asarray(ref[2]))
    x_t, x_j = out[0].numpy(), np.asarray(ref[0])
    bound = _check_polish_roots(td, tf, xd, seed_xc, ok, x_t)
    d_x = np.abs(x_t - x_j).max(-1)
    assert (d_x <= bound).all(), \
        f"roots off JAX's: {d_x[d_x > bound]} > {bound[d_x > bound]}"
    # the other outputs are functions of the root.  At a valid lane the
    # port's outputs equal its functions at its own root within 1e-6, and
    # the same functions at JAX's root equal JAX's outputs within 1e-5; an
    # invalid lane's outputs are constants, held to JAX's within 1e-5
    names = ("sdf", "grad_obs", "grad_cano", "feature")
    outs, refs = out[1:2] + out[3:], ref[1:2] + ref[3:]
    for name, x, want, tol in (("port root", x_t, outs, 1e-6),
                               ("JAX root", x_j, refs, 1e-5)):
        at = _seeded_outputs(ts, td, tf, tfn, torch.as_tensor(x))
        for n, a, b in zip(names, at, want):
            np.testing.assert_allclose(a.numpy()[valid], np.asarray(b)[valid],
                                       rtol=0, atol=tol,
                                       err_msg=f"{n} at the {name}")
    for n, a, b in zip(names, outs, refs):
        np.testing.assert_allclose(a.numpy()[~valid], np.asarray(b)[~valid],
                                   rtol=0, atol=1e-5, err_msg=n)
    assert {k: int(v) for k, v in tc.items()} == \
        {k: int(v) for k, v in jc.items()}
    assert tc["sec_seed_polish_fail"] > 0


def _fine_both(args, sdf_mode):
    jfn = JR.sdf_fine_resample_rays if sdf_mode else JR.fine_resample_rays
    tfn = TR.sdf_fine_resample_rays if sdf_mode else TR.fine_resample_rays
    return (jfn(*(jnp.asarray(a) for a in args), 4),
            tfn(*(T(a) for a in args), 4))


def _check_fine(ref, out):
    """The masks equal; the placed intervals within ``TOL`` (an unplaced
    draw of a NaN row is NaN on one side and may be a number on the
    other)."""
    m = np.asarray(ref.mask)
    np.testing.assert_array_equal(out.mask.numpy(), m)
    for name in ("t_starts", "t_ends"):
        np.testing.assert_allclose(getattr(out, name).numpy()[m],
                                   np.asarray(getattr(ref, name))[m],
                                   err_msg=name, **TOL)


@pytest.mark.parametrize("S", [16, 64])
@pytest.mark.parametrize("sdf_mode", [True, False])
def test_fine_resample_edge_rows_match_jax(sdf_mode, S):
    """KJ's twin against JAX in both modes on the rows the kernel treats
    apart: no valid slot, every slot valid, no + to - crossing, the
    crossing in the first and in the last interval, NaN SDFs (before the
    crossing, in it, and everywhere), and a NaN value before the crossing
    (which no weight reads) and after it."""
    rng = np.random.default_rng(100 + S + sdf_mode)
    ts, te, w, sdf, mask = _rows(rng, 240, S, gaps=True)
    vals = (np.where(mask, rng.uniform(0.0, 1.0, mask.shape) ** 2, 0.0)
            if sdf_mode else w).astype(np.float32)
    ar = np.arange(S)
    kind = np.arange(240) % 12
    mask[kind == 1] = False
    full = kind >= 2
    mask[full] = True
    ts[full] = np.cumsum(np.full(S, 0.02, np.float32)) + 0.5
    te[full] = ts[full] + 0.015
    vals[full] = (rng.uniform(0.05, 0.9, (int(full.sum()), S)) ** 2
                  if sdf_mode else 0.5 / S)
    sdf[full] = np.where(ar < S // 2, 0.3, -0.3)
    sdf[kind == 3] = 0.3                                  # no crossing
    sdf[kind == 4] = np.where(ar == 0, 0.3, -0.3)         # in slot 0
    sdf[kind == 5] = np.where(ar < S - 1, 0.3, -0.3)      # in the last
    sdf[kind == 6, 1] = np.nan                            # NaN before it
    sdf[kind == 7, S // 2] = np.nan                       # NaN in it
    sdf[kind == 8] = np.nan                               # NaN everywhere
    vals[kind == 9, 1] = np.nan                           # before it
    vals[kind == 10, S // 2 + 1] = np.nan                 # after it
    args = ((ts, te, vals, sdf, mask) if sdf_mode else (ts, te, vals, mask))
    ref, out = _fine_both(args, sdf_mode)
    _check_fine(ref, out)
    placed = out.mask.numpy().any(-1)
    assert not placed[kind == 1].any() and placed[kind == 2].all()
    if sdf_mode:
        assert not placed[np.isin(kind, (3, 7, 8, 10))].any()
        assert placed[np.isin(kind, (4, 6, 9))].all()
        # the last interval's mass may fall short of the first draw
        assert placed[kind == 5].any()
    else:
        # plain mode reads no SDF; a NaN weight places nothing
        assert placed[np.isin(kind, (3, 4, 5, 6, 7, 8))].all()
        assert not placed[np.isin(kind, (9, 10))].any()
