"""The port's plain sampling ops against the JAX package: occupancy
marching, merge resampling, static-budget compaction, and the per-frame
test occupancy grid (max pool + largest connected component)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from intrinsicavatar_tpu.ops import compact as JC
from intrinsicavatar_tpu.ops import grid_traversal as JG
from intrinsicavatar_tpu.ops import resample as JR
from intrinsicavatar_tpu.render import occupancy as JO
from intrinsicavatar_tpu_torch import kernels
from intrinsicavatar_tpu_torch.anim import broyden as TB
from intrinsicavatar_tpu_torch.anim.lbs_voxel import VoxelSpec
from intrinsicavatar_tpu_torch.ops import compact as TC
from intrinsicavatar_tpu_torch.ops import grid_traversal as TG
from intrinsicavatar_tpu_torch.ops import resample as TR
from intrinsicavatar_tpu_torch.render import occupancy as TO


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Tier-1 runs six test workers on one host: keep each worker's torch
    pool small so it does not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# values: f32 arithmetic in the same order on both sides; bool and integer
# outputs must be equal exactly
VTOL = dict(rtol=0.0, atol=1e-6)
AABB = np.asarray([-1.25, -1.55, -1.25, 1.25, 0.95, 1.25], np.float32)
STEP = float(np.linalg.norm(AABB[3:] - AABB[:3]) / 32)


def _rays(seed=0, R=96):
    rng = np.random.default_rng(seed)
    o = np.tile(np.asarray([[0.0, -0.3, -2.0]], np.float32), (R, 1))
    t = rng.normal(scale=0.4, size=(R, 3)) - o
    d = (t / np.linalg.norm(t, axis=-1, keepdims=True)).astype(np.float32)
    near = np.full(R, 1.0, np.float32)
    far = np.full(R, 3.0, np.float32)
    binaries = rng.random((16, 16, 16)) < 0.6
    u = rng.random(R).astype(np.float32)
    return o, d, near, far, binaries, u


def _march(seed=0, case=None, steps=32):
    """``case``: ``miss`` turns every other ray away from the box; ``full``
    sets every voxel, so every step inside the box is a sample."""
    o, d, near, far, binaries, u = _rays(seed)
    if case == "miss":
        d[::2] *= -1.0
    elif case == "full":
        binaries[:] = True
    step = STEP * 32 / steps
    jiv = JG.occupancy_sampling(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(binaries),
        jnp.asarray(AABB), step, steps, near=jnp.asarray(near),
        far=jnp.asarray(far), stratified_u=jnp.asarray(u))
    tiv = TG.occupancy_sampling(
        torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(binaries),
        torch.as_tensor(AABB), step, steps, near=torch.as_tensor(near),
        far=torch.as_tensor(far), stratified_u=torch.as_tensor(u))
    return jiv, tiv


def _assert_intervals(j, t, vtol=VTOL):
    for name in ("is_left", "is_right", "valid"):
        np.testing.assert_array_equal(getattr(t, name).numpy(),
                                      np.asarray(getattr(j, name)), name)
    np.testing.assert_allclose(t.vals.numpy(), np.asarray(j.vals), **vtol)


def test_occupancy_sampling_matches_jax():
    jiv, tiv = _march()
    assert np.asarray(jiv.valid).any() and not np.asarray(jiv.valid).all()
    _assert_intervals(jiv, tiv)
    js = JG.intervals_to_samples(jiv)
    ts = TG.intervals_to_samples(tiv)
    np.testing.assert_array_equal(ts[2].numpy(), np.asarray(js[2]))
    for a, b in zip(ts[:2], js[:2]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **VTOL)


@pytest.mark.parametrize("case", ["miss", "full"])
def test_occupancy_sampling_edge_cases_match_jax(case):
    jiv, tiv = _march(5, case)
    _assert_intervals(jiv, tiv)
    valid = np.asarray(jiv.valid)
    if case == "miss":
        assert not valid[::2].any() and valid[1::2].any()
    else:
        # a hit ray's samples run without a gap from entry to exit
        n = valid.sum(-1)
        assert (n > 0).any()
        assert (valid == (np.arange(valid.shape[1]) < n[:, None])).all()
        assert (np.asarray(jiv.is_left).sum(-1) == np.maximum(n - 1, 0)).all()


def _assert_merged(jm, tm, vtol=VTOL):
    _assert_intervals(jm, tm, vtol)
    np.testing.assert_array_equal(tm.is_new.numpy(), np.asarray(jm.is_new))
    np.testing.assert_array_equal(tm.gather_idx.numpy(),
                                  np.asarray(jm.gather_idx))


def test_merge_resample_rays_matches_jax():
    jiv, tiv = _march(1)
    rng = np.random.default_rng(2)
    E = jiv.vals.shape[1]
    w = (rng.random((jiv.vals.shape[0], E)) * 0.1).astype(np.float32)
    w[:4] *= 20.0                           # rays whose fg mass exceeds 1
    jm = JR.merge_resample_rays(jiv.vals, jiv.is_left, jiv.is_right,
                                jiv.valid, jnp.asarray(w), 16)
    tm = TR.merge_resample_rays(tiv.vals, tiv.is_left, tiv.is_right,
                                tiv.valid, torch.as_tensor(w), 16)
    _assert_merged(jm, tm)
    assert np.asarray(jm.is_new).any()


MERGE_VTOL = dict(rtol=0.0, atol=1e-5)


def test_merge_resample_second_round_with_ties_matches_jax():
    """The second importance round's shape: a 128-step march (129 edges)
    merged with 16 draws gives 145 edges, merged again with 16 draws.  In
    the second round every third ray puts 1/128 on each of its first 128
    real intervals, so its CDF steps by exact multiples of 1/128 and the
    draws u = (8k + 4) / 128 land exactly on old edges (ties, which old
    edges win); the others carry random weights, some of mass above 1."""
    jiv, tiv = _march(8, "full", steps=128)
    rng = np.random.default_rng(9)
    R, E = jiv.vals.shape
    assert E == 129
    w = (rng.random((R, E)) * 0.05).astype(np.float32)
    jm = JR.merge_resample_rays(jiv.vals, jiv.is_left, jiv.is_right,
                                jiv.valid, jnp.asarray(w), 16)
    tm = TR.merge_resample_rays(tiv.vals, tiv.is_left, tiv.is_right,
                                tiv.valid, torch.as_tensor(w), 16)
    # JAX sums the CDF in float32 (XLA's cumsum and sum), the port in double
    # in edge order; t_new divides by the CDF's step, which turns a CDF a
    # few ulps apart into ~3e-6 on t over 129 edges; flags and indices equal
    _assert_merged(jm, tm, MERGE_VTOL)
    E = jm.vals.shape[1]
    assert E == 145
    valid, left, right = (np.asarray(a) for a in (jm.valid, jm.is_left,
                                                  jm.is_right))
    real = valid[:, :-1] & valid[:, 1:] & left[:, :-1] & right[:, 1:]
    real = np.concatenate([real, np.zeros((R, 1), bool)], 1)
    w = (rng.random((R, E)) * 0.02).astype(np.float32)
    w[1::6] *= 60.0                          # foreground mass above 1
    ties = np.arange(R) % 3 == 0
    planted = real & (np.cumsum(real, 1) <= 128)
    w[ties] = np.where(planted[ties], 1.0 / 128.0, 0.0)
    jm2 = JR.merge_resample_rays(jm.vals, jm.is_left, jm.is_right, jm.valid,
                                 jnp.asarray(w), 16)
    tm2 = TR.merge_resample_rays(tm.vals, tm.is_left, tm.is_right, tm.valid,
                                 torch.as_tensor(w), 16)
    _assert_merged(jm2, tm2, MERGE_VTOL)
    assert tm2.vals.shape == (R, 161)
    # the planted draws tie with the old edge just before them
    tied = tm2.is_new[ties] & (tm2.vals[ties] == torch.roll(tm2.vals[ties],
                                                            1, 1))
    assert int(tied.sum()) >= 4 * int(ties.sum())


@pytest.mark.parametrize("mass", ["zero", "above_one"])
def test_merge_resample_weight_mass_matches_jax(mass):
    """``zero``: no foreground mass, nothing is placed; ``above_one``: the
    CDF is normalized by the mass itself and every draw is placed."""
    jiv, tiv = _march(6)
    rng = np.random.default_rng(7)
    E = jiv.vals.shape[1]
    w = (1.0 + rng.random((jiv.vals.shape[0], E))).astype(np.float32)
    if mass == "zero":
        w[:] = 0.0
    args = lambda lib, iv, ww: (iv.vals, iv.is_left, iv.is_right, iv.valid,
                                lib(ww), 16)
    jm = JR.merge_resample_rays(*args(jnp.asarray, jiv, w))
    tm = TR.merge_resample_rays(*args(torch.as_tensor, tiv, w))
    _assert_merged(jm, tm)
    new = np.asarray(jm.is_new).sum(-1)
    if mass == "zero":
        assert (new == 0).all()
    else:
        hit = np.asarray(JG.intervals_to_samples(jiv)[2]).any(-1)
        assert hit.any() and (new[hit] == 16).all()


def test_compaction_matches_jax():
    rng = np.random.default_rng(3)
    mask2d = rng.random((64, 40)) < 0.4
    for budget in (640, 1024, 2560):        # overflow, fit, full
        ji, jp = JC.compact_indices_interleaved(jnp.asarray(mask2d), budget)
        ti, tp = TC.compact_indices_interleaved(torch.as_tensor(mask2d),
                                                budget)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    pts = rng.normal(size=(mask2d.size, 3)).astype(np.float32)
    mask = mask2d.reshape(-1)
    fills = [1e5, [0.0, 0.0, 1.0]]
    j = JC.compact_apply(lambda p: (p[:, 0] * 2.0, p * 3.0), jnp.asarray(pts),
                         jnp.asarray(mask), 896, fills,
                         mask2d=jnp.asarray(mask2d))
    t = TC.compact_apply(lambda p: (p[:, 0] * 2.0, p * 3.0),
                         torch.as_tensor(pts), torch.as_tensor(mask), 896,
                         fills, mask2d=torch.as_tensor(mask2d))
    for a, b in zip(t, j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("sample_major", [False, True])
@pytest.mark.parametrize("budget_of", ["below", "at", "above"])
def test_compaction_budgets_match_jax(sample_major, budget_of):
    """Budget below, at and above the valid count; above it the invalid
    entries follow in their order."""
    rng = np.random.default_rng(8)
    mask2d = rng.random((48, 30)) < 0.3
    n = int(mask2d.sum())
    budget = {"below": n - 50, "at": n, "above": n + 200}[budget_of]
    if sample_major:
        j = JC.compact_indices_interleaved(jnp.asarray(mask2d), budget)
        t = TC.compact_indices_interleaved(torch.as_tensor(mask2d), budget)
    else:
        j = JC.compact_indices(jnp.asarray(mask2d.reshape(-1)), budget)
        t = TC.compact_indices(torch.as_tensor(mask2d.reshape(-1)), budget)
    for a, b in zip(t, j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert int(t[1].sum()) == min(n, budget)


@pytest.mark.parametrize("R, S", [(31, 13), (33, 160), (4096 + 7, 64)])
@pytest.mark.parametrize("sample_major", [False, True])
@pytest.mark.parametrize("fill", ["random", "runs", "all_valid",
                                  "all_invalid"])
def test_compaction_edge_shapes_match_jax(R, S, sample_major, fill):
    """KG's twin against JAX where the kernel takes other paths: rays not a
    multiple of a warp, rows whose bytes are not 16-byte aligned (S = 13),
    left-packed runs as the secondary coarse call gives them, all-valid and
    all-invalid masks; budgets below and above the valid count, and all of
    the entries."""
    rng = np.random.default_rng(R + S)
    runs = np.where(rng.random(R) < 0.8, 0, rng.integers(1, S + 1, R))
    mask2d = {"random": rng.random((R, S)) < 0.3,
              "runs": np.arange(S)[None] < runs[:, None],
              "all_valid": np.ones((R, S), bool),
              "all_invalid": np.zeros((R, S), bool)}[fill]
    n, M = int(mask2d.sum()), R * S
    for budget in sorted({max(1, n // 2), min(M, n + (M - n) // 2 + 1), M}):
        if sample_major:
            j = JC.compact_indices_interleaved(jnp.asarray(mask2d), budget)
            t = TC.compact_indices_interleaved(torch.as_tensor(mask2d),
                                               budget)
        else:
            j = JC.compact_indices(jnp.asarray(mask2d.reshape(-1)), budget)
            t = TC.compact_indices(torch.as_tensor(mask2d.reshape(-1)),
                                   budget)
        for a, b in zip(t, j):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert int(t[1].sum()) == min(n, budget)


def test_cpu_tensors_take_the_twins():
    """Every wrapper of this slice gives its twin's result for CPU tensors
    and launches nothing."""
    before = dict(kernels.launches)
    o, d, near, far, binaries, u = (torch.as_tensor(a) for a in _rays(9))
    aabb = torch.as_tensor(AABB)
    pairs = []
    march = (o, d, binaries, aabb, STEP, 32, near, far, u)
    iv = TG.occupancy_sampling(*march)
    pairs.append((iv, TG.occupancy_sampling_plain(*march)))
    w = torch.rand(iv.vals.shape, generator=torch.Generator().manual_seed(0))
    merge = (*iv, w, 16)
    pairs.append((TR.merge_resample_rays(*merge),
                  TR.merge_resample_rays_plain(*merge)))
    pairs.append((TC.compact_indices(iv.valid.reshape(-1), 500),
                  TC.compact_indices_plain(iv.valid.reshape(-1), 500)))
    pairs.append((TC.compact_indices_interleaved(iv.valid, 500),
                  TC.compact_indices_plain(iv.valid, 500, True)))
    rng = np.random.default_rng(10)
    tfs = torch.as_tensor(np.tile(np.eye(4, dtype=np.float32), (24, 1, 1)))
    segs = torch.as_tensor(TB.segment_table(
        rng.normal(size=(13, 2, 3)).astype(np.float32)))
    pro = (o, tfs[:13].contiguous(), segs, 8)
    pairs.append((TB.deform_prologue(*pro), TB.deform_prologue_plain(*pro)))
    res = TB.BroydenResult(x=o[:64].repeat_interleave(8, 0),
                           j_inv=torch.zeros(512, 9),
                           valid=torch.as_tensor(rng.random(512) < 0.5))
    spec = VoxelSpec(resolution=8, offset=np.zeros(3, np.float32), scale=2.0)
    lbs_cl = torch.full((2 * 8 * 8, 24), 1.0 / 24)
    voxel_J = (lbs_cl @ tfs[:, :3, :].reshape(24, 12)).reshape(
        *spec.shape_dhw, 12)
    epi = (res, 8, 4, True, lbs_cl, spec, tfs, voxel_J)
    pairs.append((TB.deform_epilogue(*epi), TB.deform_epilogue_plain(*epi)))
    for out, ref in pairs:
        for a, b in zip(out, ref):
            assert torch.equal(a, b)
    assert dict(kernels.launches) == before


def test_test_occ_grid_matches_jax():
    """Injected jitter; an analytic two-blob alpha field, so the largest
    component is a real choice."""
    res, n = 16, 3
    aabb = np.asarray([-1.0, -1.0, -1.0, 1.0, 1.0, 1.0], np.float32)
    u = np.asarray(jax.random.uniform(jax.random.PRNGKey(4), (res ** 3, n, 3)))

    def alpha(x, lib):
        d1 = lib.sqrt(((x - lib.asarray([0.3, 0.0, 0.0])) ** 2).sum(-1))
        d2 = lib.sqrt(((x - lib.asarray([-0.6, 0.2, 0.0])) ** 2).sum(-1))
        s = lib.minimum(d1 - 0.4, d2 - 0.2)
        return 1.0 - lib.exp(-10.0 * lib.exp(-lib.abs(s) / 0.05))

    class Jnp:
        asarray = staticmethod(jnp.asarray)
        sqrt, minimum, exp, abs = jnp.sqrt, jnp.minimum, jnp.exp, jnp.abs

    class Torch:
        asarray = staticmethod(lambda v: torch.tensor(v, dtype=torch.float32))
        sqrt, minimum, exp, abs = (torch.sqrt, torch.minimum, torch.exp,
                                   torch.abs)

    x_j = JO.sample_voxel_points(jax.random.PRNGKey(4), jnp.asarray(aabb),
                                 res, n)
    x_t = TO.sample_voxel_points(torch.as_tensor(aabb), res,
                                 torch.as_tensor(u))
    np.testing.assert_allclose(x_t.numpy(), np.asarray(x_j), **VTOL)
    jb = JO.compute_test_occ_grid(lambda x: alpha(x, Jnp), jnp.asarray(aabb),
                                  jax.random.PRNGKey(4), resolution=res,
                                  n_samples=n, occ_thre=0.01)
    tb = TO.compute_test_occ_grid(lambda x: alpha(x, Torch),
                                  torch.as_tensor(aabb), resolution=res,
                                  n_samples=n, occ_thre=0.01,
                                  jitter=torch.as_tensor(u))
    jb = np.asarray(jb)
    assert jb.any() and not jb.all()
    np.testing.assert_array_equal(tb.numpy(), jb)
