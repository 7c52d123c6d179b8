"""Kernel KC's plain twin (``intrinsicavatar_tpu_torch.anim.broyden``)
against the JAX single-phase ``broyden_search``, the eval-mode
``FastSNARF.deform`` against JAX, and the SMPL forward and weight voxel
(the kernel itself: ``test_torch_kernels.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from intrinsicavatar_tpu.anim import broyden as JB
from intrinsicavatar_tpu.anim import deformer as JD
from intrinsicavatar_tpu.anim import lbs_voxel as JL
from intrinsicavatar_tpu.anim import smpl as JS
from intrinsicavatar_tpu.utils.config import wrap as jwrap
from intrinsicavatar_tpu_torch.anim import broyden as TB
from intrinsicavatar_tpu_torch.anim import deformer as TD
from intrinsicavatar_tpu_torch.anim import smpl as TS
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
POSE[2], POSE[5] = 0.4, -0.4             # legs
POSE[(18 - 1) * 3 + 1] = 0.9             # left elbow
POSE[(17 - 1) * 3 + 2] = -0.5            # right shoulder
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
    # the JAX weight voxel, so the search sees identical inputs (the port
    # builds its own within test_weight_voxel_matches_jax's tolerance)
    lbs = torch.as_tensor(np.array(js.lbs_voxel))
    ts = ts._replace(lbs_voxel=lbs, lbs_cl=TB.channel_last(lbs))
    tf = td.prepare(ts, _smpl_params(torch))
    return jd, js, jf, td, ts, tf


def test_smpl_forward_matches_jax():
    body = JS.make_synthetic_body_model()
    tbody = TS.make_synthetic_body_model()
    np.testing.assert_array_equal(tbody.v_template, body.v_template)
    j = JS.smpl_forward(body, jnp.zeros(10), jnp.asarray(POSE),
                        jnp.asarray([0.1, -0.2, 0.3]),
                        jnp.asarray([0.0, 0.3, 2.0]))
    t = TS.smpl_forward(tbody, torch.zeros(10), torch.as_tensor(POSE),
                        torch.tensor([0.1, -0.2, 0.3]),
                        torch.tensor([0.0, 0.3, 2.0]))
    for a, b in zip(t, j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-6)


def test_weight_voxel_matches_jax(deformers):
    """The KNN of the two packages can order a near-tie of the 30th and
    31st neighbour differently (their distance expansions round apart by
    an ulp, and torch.linspace and jnp.linspace differ by one), which moves
    a voxel's blended weight by a fraction of a percent before smoothing."""
    jd, js, _, td, _, _ = deformers
    ts = td.initialize(np.zeros(10), "cpu")
    diff = np.abs(ts.lbs_voxel.numpy() - np.asarray(js.lbs_voxel))
    assert diff.max() < 1e-3
    assert np.mean(diff < 1e-6) > 0.99
    np.testing.assert_allclose(td.spec.scale_kernel, jd.spec.scale_kernel)
    np.testing.assert_allclose(td.init_segs, jd.init_segs, atol=1e-6)


def _targets(deformers, n, seed):
    jd, js, jf, td, ts, tf = deformers
    vc = np.asarray(js.vs_template)
    rng = np.random.default_rng(seed)
    pts = (vc[rng.choice(len(vc), n)]
           + rng.normal(scale=0.02, size=(n, 3))).astype(np.float32)
    w = JB.grid_sample_3d(js.lbs_voxel, jd.spec.normalize(jnp.asarray(pts)),
                          padding="border")
    xd, _ = JB.forward_skinning(jnp.asarray(pts), w, jf.tfs)
    return np.asarray(xd)


def test_broyden_twin_matches_jax_single_phase(deformers):
    jd, js, jf, td, ts, tf = deformers
    xd = _targets(deformers, 512, 0)
    I = len(JB.INIT_BONES)
    N = xd.shape[0]
    xd_rep = np.repeat(xd, I, axis=0)
    bones = np.tile(JB.INIT_BONES, N)
    _, voxel_J = JL.precompute_transform_voxels(js.lbs_voxel, jf.tfs, jd.spec)
    ref = JB.broyden_search(
        jnp.asarray(xd_rep), jnp.asarray(bones), jf.voxel_J_packed, jf.tfs,
        jnp.asarray(jd.spec.offset), jnp.asarray(jd.spec.scale_kernel),
        shape_dhw=jd.spec.shape_dhw, two_phase=False)
    out = TB.broyden_search(
        torch.as_tensor(xd_rep), torch.as_tensor(bones),
        torch.as_tensor(np.array(voxel_J).transpose(1, 2, 3, 0).copy()),
        torch.as_tensor(np.array(jf.tfs)),
        jd.spec.offset, jd.spec.scale_kernel)
    valid = np.asarray(ref.valid)
    assert 0.1 < valid.mean() < 0.9
    np.testing.assert_array_equal(out.valid.numpy(), valid)
    # roots within 1e-4 where valid (same f32 steps, rounded apart where
    # XLA fuses or reorders them)
    np.testing.assert_allclose(out.x.numpy()[valid],
                               np.asarray(ref.xc_array())[valid], atol=1e-4)
    # J^-1 is path-dependent: each rank-1 update divides by c . dg, which
    # can be tiny, so a rounding apart in one step grows with every later
    # step (after 2 steps the two sides differ by <= 2e-4, after 10 by up
    # to ~6e-2 on a few lanes).  Four in five lanes still agree to 1e-4;
    # all agree to 0.1.  The eval path does not read J^-1 (use_j_inv:
    # false); the roots it does read agree to 1e-4 above.
    d_j = np.abs(out.j_inv.numpy()[valid]
                 - np.asarray(ref.jinv_array()).reshape(-1, 9)[valid])
    assert np.mean(d_j.max(-1) < 1e-4) > 0.75
    assert d_j.max() < 0.1


def test_deform_matches_jax(deformers):
    """Eval-mode canonicalization with a sphere SDF as the field."""
    jd, js, jf, td, ts, tf = deformers
    xd = _targets(deformers, 2048, 1)      # N * K = 8192 > 4096: compacted

    def jfn(xc):
        sdf = jnp.sqrt(jnp.sum(xc ** 2, -1)) - 0.3
        grad = xc / jnp.sqrt(jnp.sum(xc ** 2, -1, keepdims=True))
        feat = jnp.concatenate([sdf[:, None], xc], -1)
        return (sdf, grad, feat), None

    def tfn(xc):
        sdf = torch.sqrt(torch.sum(xc ** 2, -1)) - 0.3
        grad = xc / torch.sqrt(torch.sum(xc ** 2, -1, keepdim=True))
        feat = torch.cat([sdf[:, None], xc], -1)
        return (sdf, grad, feat), None

    from intrinsicavatar_tpu.utils import diag
    with diag.collect() as jc:
        ref = jd.deform(js, jf, jnp.asarray(xd), jfn, with_jac=True,
                        eval_mode=True)
    tc = {}
    out = td.deform(ts, tf, torch.from_numpy(xd.copy()), tfn, with_jac=True,
                    eval_mode=True, counters=tc)
    valid = np.asarray(ref[2])
    assert valid.mean() > 0.9
    np.testing.assert_array_equal(out[2].numpy(), valid)
    for name, a, b in zip(("pts_cano", "sdf", "valid", "grad_obs",
                           "grad_cano", "feature"), out, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4,
                                   err_msg=name)
    assert {k: int(v) for k, v in tc.items()} == \
        {k: int(v) for k, v in jc.items()}


@pytest.fixture(scope="module")
def published():
    """The JAX deformer at the published voxel (32 x 128 x 128) in the
    pose, its transform voxel channel-last for the port."""
    cfg = dict(RIGID, deformer_config=dict(RIGID["deformer_config"],
                                           resolution=128))
    jd = JD.FastSNARF(jwrap(cfg))
    js = jd.initialize(np.zeros(10))
    jf = jd.prepare(js, _smpl_params(jnp))
    _, voxel_J = JL.precompute_transform_voxels(js.lbs_voxel, jf.tfs, jd.spec)
    vox = torch.as_tensor(np.array(voxel_J).transpose(1, 2, 3, 0).copy())
    return jd, js, jf, vox


def test_broyden_twin_matches_jax_at_published_voxel(published):
    """KC's twin against the JAX single-phase loop on the published 32 x 128
    x 128 voxel: 384 points near the body, 8 of the 13 init bones each, so
    some lanes run all max_iters steps."""
    jd, js, jf, vox = published
    rng = np.random.default_rng(0)
    vc = np.asarray(js.vs_template)
    n, I = 384, 8
    pts = (vc[rng.choice(len(vc), n)]
           + rng.normal(scale=0.03, size=(n, 3))).astype(np.float32)
    w = JB.grid_sample_3d(js.lbs_voxel, jd.spec.normalize(jnp.asarray(pts)),
                          padding="border")
    xd = np.repeat(np.asarray(JB.forward_skinning(jnp.asarray(pts), w,
                                                  jf.tfs)[0]), I, 0)
    bones = np.stack([rng.choice(JB.INIT_BONES, I, replace=False)
                      for _ in range(n)]).reshape(-1)
    ref = JB.broyden_search(
        jnp.asarray(xd), jnp.asarray(bones), jf.voxel_J_packed, jf.tfs,
        jnp.asarray(jd.spec.offset), jnp.asarray(jd.spec.scale_kernel),
        shape_dhw=jd.spec.shape_dhw, two_phase=False)
    counts = []
    out = TB.broyden_search_plain(
        torch.as_tensor(xd), torch.as_tensor(bones, dtype=torch.int32), vox,
        torch.as_tensor(np.array(jf.tfs)), jd.spec.offset,
        jd.spec.scale_kernel, lane_counts=counts)
    assert int((counts[0] == 10).sum()) > 0      # lanes that run out
    valid = np.asarray(ref.valid)
    assert 0.1 < valid.mean() < 0.9
    np.testing.assert_array_equal(out.valid.numpy(), valid)
    # as test_broyden_twin_matches_jax_single_phase: roots within 1e-4,
    # J^-1 path-dependent through its rank-1 updates
    np.testing.assert_allclose(out.x.numpy()[valid],
                               np.asarray(ref.xc_array())[valid], atol=1e-4)
    d_j = np.abs(out.j_inv.numpy()[valid]
                 - np.asarray(ref.jinv_array()).reshape(-1, 9)[valid])
    assert np.mean(d_j.max(-1) < 1e-4) > 0.75
    assert d_j.max() < 0.1
    assert not out.x.numpy()[~valid].any()
