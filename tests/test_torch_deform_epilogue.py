"""The plain twins of kernel KH (``deform_prologue``/``deform_epilogue`` of
``intrinsicavatar_tpu_torch.anim.broyden``) against the JAX package: the
init pruning of ``FastSNARF.search``, and ``filter_duplicates_soa``, the
overflow count, the first-K over ``stable_partition_rows``,
``query_weights`` and ``forward_skinning_soa`` as the JAX ``deform``
composes them (the kernel itself: ``test_torch_kernels.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from intrinsicavatar_tpu.anim import broyden as JB
from intrinsicavatar_tpu.anim import deformer as JD
from intrinsicavatar_tpu.ops.compact import stable_partition_rows
from intrinsicavatar_tpu.utils.config import wrap as jwrap
from intrinsicavatar_tpu_torch.anim import broyden as TB
from intrinsicavatar_tpu_torch.anim import deformer as TD
from intrinsicavatar_tpu_torch.utils.config import wrap as twrap


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Tier-1 runs six test workers on one host: keep each worker's torch
    pool small so it does not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


POSE = np.zeros(69, np.float32)
POSE[2], POSE[5] = 0.4, -0.4
POSE[(18 - 1) * 3 + 1] = 0.9
RIGID = {"name": "fast-snarf", "model_path": "synthetic",
         "deformer_config": {"resolution": 32, "n_init": 8,
                             "max_candidates": 4}}
I, K = 8, 4


def _smpl_params():
    return {"betas": jnp.zeros(10), "body_pose": jnp.asarray(POSE),
            "global_orient": jnp.zeros(3),
            "transl": jnp.asarray([0.0, 0.3, 2.0]),
            "betas_correction": jnp.zeros((1, 10)),
            "pose_correction": jnp.zeros((1, 69)),
            "global_orient_correction": jnp.zeros((1, 3)),
            "transl_correction": jnp.zeros((1, 3))}


@pytest.fixture(scope="module")
def jax_deformer():
    """The JAX deformer and its statics and frame, and the port's spec and
    channel-last copy of the JAX weight voxel (so both sample one voxel)."""
    jd = JD.FastSNARF(jwrap(RIGID))
    js = jd.initialize(np.zeros(10))
    jf = jd.prepare(js, _smpl_params())
    td = TD.FastSNARF(twrap(RIGID))
    td.initialize(np.zeros(10), "cpu")
    lbs_cl = TB.channel_last(torch.as_tensor(np.array(js.lbs_voxel)))
    return jd, js, jf, td, lbs_cl


def _points(js, n, seed):
    rng = np.random.default_rng(seed)
    v = np.asarray(js.vs_template)
    return (v[rng.choice(len(v), n)]
            + rng.normal(scale=0.05, size=(n, 3))).astype(np.float32)


@pytest.mark.parametrize("case", ["distinct", "tied", "n_init_1",
                                  "n_init_12", "far", "zero_length"])
def test_prologue_matches_jax_pruning(jax_deformer, monkeypatch, case):
    """``tied``: two init bones share their transform and segment, so every
    point has an exact tie between them; lower slot first on both sides.
    ``n_init_1`` / ``n_init_12``: other counts of inits kept (set on the JAX
    deformer); ``far``: points 2-50 m from the body; ``zero_length``: a
    bone's segment is a point (the denominator is 1e-9)."""
    jd, js, jf, _, _ = jax_deformer
    tfs = np.array(jf.tfs)
    segs = np.array(jd.init_segs)
    n_init = {"n_init_1": 1, "n_init_12": 12}.get(case, I)
    if case == "tied":
        a, b = JB.INIT_BONES[3], JB.INIT_BONES[6]
        tfs[b] = tfs[a]
        segs[6] = segs[3]
    if case == "zero_length":
        segs[5, 1] = segs[5, 0]
    monkeypatch.setattr(jd, "init_segs", segs)
    monkeypatch.setattr(jd, "n_init", n_init)
    pts = _points(js, 3000, 1)
    if case == "far":
        rng = np.random.default_rng(2)
        u = rng.normal(size=pts.shape)
        u /= np.linalg.norm(u, axis=-1, keepdims=True)
        pts = (pts + u * rng.uniform(2.0, 50.0, (len(pts), 1))
               ).astype(np.float32)
    seen = {}

    def capture(xd, bone_idx, *args, **kwargs):
        seen["slot"] = np.asarray(bone_idx)

    monkeypatch.setattr(JD, "broyden_search", capture)
    jd.search(jf._replace(tfs=jnp.asarray(tfs)), jnp.asarray(pts))
    slot = TB.deform_prologue(
        torch.as_tensor(pts), torch.as_tensor(tfs[JB.INIT_BONES]),
        torch.as_tensor(TB.segment_table(segs)), n_init)
    np.testing.assert_array_equal(slot.numpy(), seen["slot"])
    s = seen["slot"].reshape(-1, n_init)
    if case == "tied":
        both = (s == 3).any(-1) & (s == 6).any(-1)
        assert both.any()
        first = lambda v: np.argmax(s == v, -1)
        assert (first(3)[both] < first(6)[both]).all()
    if case == "zero_length":
        assert (s == 5).any()


def _search_result(js, N, valid_share, seed):
    """``I`` lanes per point: roots near the canonical body, some of them
    near-duplicates of another lane (within or beyond the 1e-4 filter
    radius), invalid lanes zeroed as the search leaves them."""
    rng = np.random.default_rng(seed)
    x = _points(js, N * I, seed).reshape(N, I, 3).astype(np.float64)
    valid = rng.random((N, I)) < valid_share
    src = rng.integers(0, I, (N, I))
    near = x[np.arange(N)[:, None], src] + rng.normal(
        scale=rng.choice([2e-5, 2e-4], (N, I, 1)), size=(N, I, 3))
    x = np.where((rng.random((N, I)) < 0.4)[..., None], near, x)
    x[~valid] = 0.0
    jinv = rng.normal(size=(N, I, 9)) * valid[..., None]
    return (x.astype(np.float32), jinv.astype(np.float32), valid)


def _voxel_J(lbs_cl, spec, tfs):
    """The transform voxel ``[D, H, W, 12]`` of the weights ``lbs_cl`` and
    ``tfs`` (``sum_b W_b tfs[b, :3, :4]``), which KH skinning's kernel
    reads in the rotation's place."""
    return (lbs_cl @ tfs[:, :3, :].reshape(24, 12)).reshape(
        *spec.shape_dhw, 12).contiguous()


@pytest.mark.parametrize("case", ["no_roots", "some_roots", "over_k"])
def test_epilogue_matches_jax(jax_deformer, case):
    jd, js, jf, td, lbs_cl = jax_deformer
    N = 512
    share = {"no_roots": 0.0, "some_roots": 0.3, "over_k": 1.0}[case]
    x, jinv, valid = _search_result(js, N, share, 2)

    # the JAX deform's epilogue (anim/deformer.py:374-394, eval branch)
    jv = JB.filter_duplicates_soa(*(jnp.asarray(x[..., c]) for c in range(3)),
                                  jnp.asarray(valid))
    j_ovf = jnp.sum(jax.nn.relu(jnp.sum(jv.astype(jnp.int32), -1) - K))
    order = stable_partition_rows(jv)[:, :K]
    lane = (jnp.arange(N)[:, None] * I + order).reshape(-1)
    xs = jnp.asarray(x.reshape(-1, 3))[lane]
    j_valid = (jv.reshape(-1) & jnp.asarray(valid.reshape(-1)))[lane]
    w = jd.query_weights(js, xs)
    _, j_rot = JB.forward_skinning_soa(xs[:, 0], xs[:, 1], xs[:, 2], w,
                                       jf.tfs)

    res = TB.BroydenResult(x=torch.as_tensor(x.reshape(-1, 3)),
                           j_inv=torch.as_tensor(jinv.reshape(-1, 9)),
                           valid=torch.as_tensor(valid.reshape(-1)))
    tfs = torch.as_tensor(np.array(jf.tfs))
    out = TB.deform_epilogue(res, I, K, True, lbs_cl, td.spec, tfs,
                             _voxel_J(lbs_cl, td.spec, tfs))
    # gathers: equal
    np.testing.assert_array_equal(out.xc.numpy(), np.asarray(xs))
    np.testing.assert_array_equal(
        out.j_inv.numpy(), jinv.reshape(-1, 9)[np.asarray(lane)])
    np.testing.assert_array_equal(out.valid.numpy(), np.asarray(j_valid))
    assert int(out.overflow) == int(j_ovf)
    if case == "over_k":
        assert int(j_ovf) > 0
    if case == "no_roots":
        assert not out.valid.any()
    # weights: the JAX packed sampler sums the 8 corners in one einsum and
    # blends with 12 dot products, the twin in corner order and one matrix
    # product; f32 rounding apart, rotations of norm ~1
    np.testing.assert_allclose(out.fwd_rot.numpy(),
                               np.stack(j_rot, -1), rtol=0, atol=1e-5)


def test_epilogue_without_rotation(jax_deformer):
    """A query that reads no rotation gets none and the same lanes."""
    _, js, jf, td, lbs_cl = jax_deformer
    x, jinv, valid = _search_result(js, 64, 0.5, 3)
    res = TB.BroydenResult(x=torch.as_tensor(x.reshape(-1, 3)),
                           j_inv=torch.as_tensor(jinv.reshape(-1, 9)),
                           valid=torch.as_tensor(valid.reshape(-1)))
    tfs = torch.as_tensor(np.array(jf.tfs))
    voxel_J = _voxel_J(lbs_cl, td.spec, tfs)
    a = TB.deform_epilogue(res, I, K, False, lbs_cl, td.spec, tfs, voxel_J)
    b = TB.deform_epilogue(res, I, K, True, lbs_cl, td.spec, tfs, voxel_J)
    assert a.fwd_rot is None and b.fwd_rot.shape == (64 * K, 9)
    for u, v in zip(a[:4], b[:4]):
        assert torch.equal(u, v)


def _planted(N, I, seed):
    """``I`` lanes a point, all valid: a pair within 0.99e-4, beyond
    1.01e-4 or within 2e-5 of a later lane in most points, and chains (a
    within 0.6e-4 of b, b of c, so that a and c lie 1.2e-4 apart)."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1.3, 1.3, (N, I, 3))
    u = rng.normal(size=(N, 3))
    u /= np.linalg.norm(u, axis=-1, keepdims=True)
    a = rng.integers(0, I - 1, N)
    b = a + 1 + rng.integers(0, I - 1 - a)
    d = rng.choice([0.99e-4, 1.01e-4, 2e-5], N)
    x[np.arange(N), b] = x[np.arange(N), a] + d[:, None] * u
    chain = rng.random(N) < 0.5
    c = rng.integers(0, I - 2, N)
    for k in (1, 2):
        x[chain, c[chain] + k] = x[chain, c[chain] + k - 1] + 0.6e-4 * u[chain]
    valid = rng.random((N, I)) < 0.9
    x[~valid] = 0.0
    jinv = rng.normal(size=(N, I, 9))
    return x.astype(np.float32), jinv.astype(np.float32), valid


@pytest.mark.parametrize("n_keep", [1, 16])
def test_epilogue_matches_jax_at_16_inits(n_keep):
    """I = 16 (a group of 16 lanes on the card), K = 1 and K = I, with
    planted pairs at the threshold and duplicate chains."""
    N, I_, K_ = 600, 16, n_keep
    x, jinv, valid = _planted(N, I_, 5 + K_)
    jv = JB.filter_duplicates_soa(*(jnp.asarray(x[..., c]) for c in range(3)),
                                  jnp.asarray(valid))
    j_ovf = jnp.sum(jax.nn.relu(jnp.sum(jv.astype(jnp.int32), -1) - K_))
    order = stable_partition_rows(jv)[:, :K_]
    lane = np.asarray((jnp.arange(N)[:, None] * I_ + order).reshape(-1))
    res = TB.BroydenResult(x=torch.as_tensor(x.reshape(-1, 3)),
                           j_inv=torch.as_tensor(jinv.reshape(-1, 9)),
                           valid=torch.as_tensor(valid.reshape(-1)))
    out = TB.deform_epilogue(res, I_, K_, False, None, None, None, None)
    np.testing.assert_array_equal(out.xc.numpy(), x.reshape(-1, 3)[lane])
    np.testing.assert_array_equal(out.j_inv.numpy(),
                                  jinv.reshape(-1, 9)[lane])
    np.testing.assert_array_equal(out.valid.numpy(),
                                  np.asarray(jv).reshape(-1)[lane])
    assert int(out.overflow) == int(j_ovf)
    # the planted pairs fall on both sides of the threshold, and the chains
    # drop their first two links
    dropped = valid & ~np.asarray(jv)
    assert 0 < dropped.sum() < valid.sum()
    if K_ == 1:
        assert int(j_ovf) > 0


@pytest.fixture(scope="module")
def published_voxel():
    """The JAX deformer at the published voxel (32 x 128 x 128) in the
    pose, and the port's spec, weights and transform voxel from the same
    weight voxel and ``tfs`` (``precompute_transform_voxels`` channel-last,
    as ``FastSNARF.prepare`` bakes the frame's ``voxel_J``)."""
    from intrinsicavatar_tpu_torch.anim.lbs_voxel import (
        VoxelSpec, precompute_transform_voxels)
    cfg = dict(RIGID, deformer_config=dict(RIGID["deformer_config"],
                                           resolution=128))
    jd = JD.FastSNARF(jwrap(cfg))
    js = jd.initialize(np.zeros(10))
    jf = jd.prepare(js, _smpl_params())
    spec = VoxelSpec(resolution=128, offset=np.asarray(jd.spec.offset),
                     scale=float(jd.spec.scale))
    lbs = torch.as_tensor(np.array(js.lbs_voxel))
    tfs = torch.as_tensor(np.array(jf.tfs))
    _, voxel_J = precompute_transform_voxels(lbs, tfs, spec)
    return (jd, js, jf, spec, TB.channel_last(lbs), tfs,
            voxel_J.permute(1, 2, 3, 0).contiguous())


@pytest.mark.parametrize("where", ["inside", "border"])
def test_skinning_voxel_form_matches_weights_and_jax(published_voxel, where):
    """KH skinning's kernel samples the 9 rotation channels of the frame's
    transform voxel (``deform_skinning_voxel_plain``); its twin samples the
    24 weights and blends ``tfs`` (``deform_skinning_plain``).  The sample
    is linear in the voxel, so the two are one function with the sums in
    another order: within 2e-6 (rotation rows of norm ~1, a few float32
    roundings apart), and both within 1e-5 of JAX's ``query_weights`` +
    ``forward_skinning_soa`` (its packed sampler sums the corners in one
    einsum), at points near the body and at points beyond the voxel,
    whose coordinates border padding clamps."""
    jd, js, jf, spec, lbs_cl, tfs, voxel_J = published_voxel
    rng = np.random.default_rng(21)
    n = 3000
    if where == "inside":
        v = np.asarray(js.vs_template)
        x = v[rng.choice(len(v), n)] + rng.normal(scale=0.05, size=(n, 3))
    else:
        x = spec.denormalize(torch.as_tensor(
            rng.uniform(-1.6, 1.6, (n, 3)))).numpy()
    x = torch.as_tensor(x.astype(np.float32))
    out = np.abs(spec.normalize(x).numpy()) > 1.0
    assert out.any(-1).mean() > (0.5 if where == "border" else -1.0)
    rot_w = TB.deform_skinning_plain(x, lbs_cl, spec, tfs)
    rot_v = TB.deform_skinning_voxel_plain(x, voxel_J, spec)
    np.testing.assert_allclose(rot_v.numpy(), rot_w.numpy(), rtol=0,
                               atol=2e-6)
    xs = jnp.asarray(x.numpy())
    w = jd.query_weights(js, xs)
    _, j_rot = JB.forward_skinning_soa(xs[:, 0], xs[:, 1], xs[:, 2], w,
                                       jf.tfs)
    for rot in (rot_w, rot_v):
        np.testing.assert_allclose(rot.numpy(), np.stack(j_rot, -1), rtol=0,
                                   atol=1e-5)
    # the CPU wrapper takes the twin
    assert torch.equal(TB.deform_skinning(x, lbs_cl, spec, tfs, voxel_J),
                       rot_w)
