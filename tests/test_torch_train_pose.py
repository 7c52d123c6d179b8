"""Pose-correction training of the port against the JAX package: the
backward of the train-mode skinning correction with respect to ``tfs``
(kernel KN's plain twin and the autograd function around it) against
``jax.vjp``, which frames carry the pose's graph, the ``pose_correction``
leaves across the weights bridge, and one train step at step 4,001 (and
4,000, before the corrections switch on) with the corrections enabled,
also with ``optimize_betas``; planted faults of KN's twin that the
step's tolerances refuse; the step's pose gradient as the pullback of KN's
d tfs; and the documented ``--config`` eval launch.

One JAX system per deformer configuration is shared by the module; its
train step is one jit whose step is traced, so steps 4,000 and 4,001 share
a compile (set-up in ``train_setup.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import train_setup as TS
from intrinsicavatar_tpu.anim.broyden import forward_skinning_soa
from intrinsicavatar_tpu.anim.deformer import FastSNARF as JSNARF
from intrinsicavatar_tpu.utils.config import wrap as jwrap
from intrinsicavatar_tpu_torch.anim import broyden as TB
from intrinsicavatar_tpu_torch.anim.deformer import (
    FastSNARF, _SkinningCorrection,
)
from intrinsicavatar_tpu_torch.utils.config import wrap
from intrinsicavatar_tpu_torch.weights import from_jax_params, to_jax_tree


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Tier-1 runs six test workers on one host: keep each worker's torch
    pool small so it does not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# As tests/test_torch_train.py: f32 on both sides, sums reassociated, and a
# shading sample within rounding of a hash cell's face may take the other
# cell's derivative; each leaf's gradient within 2% of its norm, the
# losses within 1e-3 (the curvature proxy 2e-3).
GRAD_RTOL, LOSS_RTOL, CURV_RTOL = 2e-2, 1e-3, 2e-3
LOSS_KEYS = ("rgb_l1", "rgb_mse", "eikonal", "mask_bce", "mask_mse",
             "opaque", "sparsity", "curvature", "lipshitz_bound", "beta",
             "total", "shading_valid_samples")
# The global orient and translation corrections cancel in tfs = A_0^-1 A_j
# tfs_inv_t (the frame is pelvis-aligned, and the rays' transform is
# detached): their gradient is zero but for rounding, in both packages.
# Held to 1e-4 of the pose's gradient on both sides.
CANCELLED = ("pose_correction.global_orient", "pose_correction.transl")
CANCEL_RTOL = 1e-4
# The pose's gradient sums every shading lane's cotangent, the SDF
# gradient's second-order pullback included, which jumps where a canonical
# point crosses a hash cell's face.  At frame 1 one such lane moves it:
# JAX against itself, with the rays moved by rounding (x (1 + 2e-7 N)),
# differs by more than 2% (GRAD_RTOL) and less than these tolerances
# (test_rounding_moves_the_jax_pose_gradient; 3.7% and 5.1-5.6% over three
# draws when this was written, the port against JAX 3.7% and 5.2%).  Held
# to 5% and 8%, below what a planted fault gives
# (test_pose_tolerance_refuses_a_planted_fault).
RTOLS = {"pose_correction.pose": 5e-2, "pose_correction.betas": 8e-2}
START = 4000         # pose_correction_start_step of the default config


def _snarf_pair():
    dcfg = {"name": "fast-snarf", "model_path": "synthetic",
            "deformer_config": {"resolution": 32}}
    jr, tr = JSNARF(jwrap(dcfg)), FastSNARF(wrap(dcfg))
    return jr, jr.initialize(np.zeros(10)), tr, tr.initialize(np.zeros(10),
                                                             "cpu")


@pytest.fixture(scope="module")
def snarf():
    return _snarf_pair()


@pytest.mark.parametrize("use_j_inv", [False, True])
@pytest.mark.parametrize("rot_cotangent", [False, True])
def test_skinning_bwd_matches_jax_vjp(snarf, use_j_inv, rot_cotangent):
    """d tfs of the train-mode correction ``x_c - v J^-1 (x_d - sg(x_d))``
    and of the blended rotation (the rotation is ``J^-1`` with
    ``use_j_inv``, and only the position term reaches ``tfs``), at 512
    roots, some invalid and some outside the weight voxel (border
    padding): the autograd function (kernel KN's twin on the CPU) against
    ``jax.vjp`` of the JAX correction and ``forward_skinning_soa``."""
    jr, js, tr, ts = snarf
    rng = np.random.default_rng(5)
    M = 512
    lo, hi = np.asarray(tr.bbox[0]), np.asarray(tr.bbox[1])
    c, h = (lo + hi) / 2, (hi - lo) / 2
    xc = (c + h * rng.uniform(-1.3, 1.3, (M, 3))).astype(np.float32)
    jinv = rng.normal(size=(M, 9)).astype(np.float32)
    valid = rng.random(M) < 0.7
    tfs = np.tile(np.eye(4, dtype=np.float32), (24, 1, 1))
    tfs[:, :3, :] += rng.normal(scale=0.2, size=(24, 3, 4)).astype(
        np.float32)
    g_xc = rng.normal(size=(M, 3)).astype(np.float32)
    g_rot = (rng.normal(size=(M, 9)) if rot_cotangent
             else np.zeros((M, 9))).astype(np.float32)
    assert (np.abs(tr.spec.normalize(torch.as_tensor(xc)).numpy()) > 1).any()

    def jax_fn(t):
        w = jr.query_weights(js, jnp.asarray(xc))
        x, y, z = (jnp.asarray(xc[:, i]) for i in range(3))
        (d0, d1, d2), rot = forward_skinning_soa(x, y, z, w, t)
        r = [d - jax.lax.stop_gradient(d) for d in (d0, d1, d2)]
        J = jnp.asarray(jinv)
        vf = jnp.asarray(valid, jnp.float32)
        out = jnp.stack([(x, y, z)[a] - vf * sum(J[:, 3 * a + b] * r[b]
                                                 for b in range(3))
                         for a in range(3)], -1)
        c2w = J if use_j_inv else jnp.stack(rot, -1)
        return out, c2w

    _, vjp = jax.vjp(jax_fn, jnp.asarray(tfs))
    (ref,) = vjp((jnp.asarray(g_xc), jnp.asarray(g_rot)))
    ref = np.asarray(ref)

    t = torch.tensor(tfs, requires_grad=True)
    J = torch.as_tensor(jinv)
    # the transform voxel of the same weights and tfs, which only the
    # kernel reads (CPU tensors take the twin)
    voxel_J = (ts.lbs_cl @ t.detach()[:, :3, :].reshape(24, 12)).reshape(
        *tr.spec.shape_dhw, 12)
    out, rot = _SkinningCorrection.apply(
        torch.as_tensor(xc), J, torch.as_tensor(valid), t, ts.lbs_cl,
        tr.spec, voxel_J, not use_j_inv)
    np.testing.assert_array_equal(out.detach().numpy(), xc)
    c2w = J if use_j_inv else rot
    loss = torch.sum(out * torch.as_tensor(g_xc)) \
        + torch.sum(c2w * torch.as_tensor(g_rot))
    loss.backward()
    got = t.grad.numpy()
    assert np.linalg.norm(ref) > 0
    assert np.all(got[:, 3] == 0)
    assert np.linalg.norm(got - ref) <= 1e-5 * np.linalg.norm(ref)
    # the twin itself, as the wrapper takes it for CPU tensors
    args = (torch.as_tensor(xc), torch.as_tensor(valid), J,
            torch.as_tensor(g_xc),
            None if use_j_inv else torch.as_tensor(g_rot), ts.lbs_cl,
            tr.spec)
    twin = TB.deform_skinning_bwd(*args)
    assert np.linalg.norm(twin.numpy() - ref) <= 1e-5 * np.linalg.norm(ref)
    # the float64 sum and rounding bound that the card holds KN to, and
    # the planted faults that bound must refuse
    exact, limit = TB.deform_skinning_bwd_exact(*args)
    assert np.linalg.norm(exact.numpy() - ref) <= 1e-5 * np.linalg.norm(ref)
    assert not TB.deform_skinning_bwd_refused(exact.float(), exact, limit)
    faults = TB.deform_skinning_bwd_faults(*args, twin, limit)
    assert len(faults) == (5 if rot_cotangent and not use_j_inv else 4)
    for name, bad in faults.items():
        assert TB.deform_skinning_bwd_refused(bad, exact, limit), name



def _kn_sums_float32(xc, valid, jinv, g_xc, g_rot, lbs_cl, spec):
    """KN's d tfs summed in float32 in KN's order (``csrc/deform.cu``: the
    lanes it adds numbered in each tile, one running sum a (block, slice)
    over its numbers, then each block's slices, then the blocks), from the
    twin's weights and U computed as KN computes it, each product rounded
    apart where KN fuses it into its sum."""
    M, E = xc.shape[0], 24 * 12
    W = TB.skin_bwd_terms(xc, valid, jinv, g_xc, g_rot, lbs_cl, spec)[0]
    W = W.float()
    J = jinv.reshape(M, 3, 3)
    rho = -(valid.float()[:, None] * (J[:, 0] * g_xc[:, :1]
                                      + J[:, 1] * g_xc[:, 1:2]
                                      + J[:, 2] * g_xc[:, 2:]))
    U = rho[:, :, None] * torch.cat([xc, torch.ones((M, 1))], 1)[:, None]
    if g_rot is not None:
        U[:, :, :3] = U[:, :, :3] + g_rot.reshape(M, 3, 3)
    U = U.reshape(M, 12)
    adds = TB.skin_bwd_adds(valid, g_rot)
    T, S, G = TB.SKIN_BWD_TILE, TB.SKIN_BWD_SLICES, TB.skin_bwd_blocks(M)
    run = torch.zeros((G, S, E))
    for lo in range(0, M, G * T):
        n = min(G * T, M - lo)
        terms = torch.zeros((G * T, E))
        for g in range(min(G, -(-n // T))):
            lanes = torch.arange(lo + g * T, min(lo + (g + 1) * T, lo + n))
            lanes = lanes[adds[lanes]]
            terms[g * T:g * T + len(lanes)] = (
                W[lanes, :, None] * U[lanes, None]).reshape(-1, E)
        terms = terms.reshape(G, T // S, S, E)
        for j in range(T // S):
            run = run + terms[:, j]
    blocks = torch.zeros((G, E))
    for k in range(S):
        blocks = blocks + run[:, k]
    total = torch.zeros(E)
    for g in range(G):
        total = total + blocks[g]
    d_tfs = torch.zeros((24, 4, 4))
    d_tfs[:, :3] = total.reshape(24, 3, 4)
    return d_tfs


@pytest.mark.parametrize("M,rot", [(4001, "none"), (4001, "every lane"),
                                   (120_011, "valid lanes")])
def test_skinning_bwd_limit_holds_kn_order_and_refuses_faults(snarf, M,
                                                              rot):
    """KN's rounding bound (``deform_skinning_bwd_exact``) at random lanes,
    some invalid and some outside the weight voxel: 4,001 lanes (14 tiles
    on as many blocks, the last tile short), without a rotation cotangent
    (KN adds the valid lanes) and with one at every lane (KN adds them
    all), and 120,011 (a round of tiles over every block and a short
    second) with 10% of the lanes valid and a rotation cotangent at those
    only, as a train step gives them (KN skips the rest): KN's sums taken
    in float32 in its order lie within the bound, and the bound refuses
    each planted fault."""
    _, _, tr, ts = snarf
    rng = np.random.default_rng(M)
    lo, hi = np.asarray(tr.bbox[0]), np.asarray(tr.bbox[1])
    c, h = (lo + hi) / 2, (hi - lo) / 2
    f = lambda a: torch.as_tensor(a.astype(np.float32))
    valid = rng.random(M) < (0.1 if rot == "valid lanes" else 0.7)
    g_rot = rng.normal(size=(M, 9))
    if rot == "valid lanes":
        g_rot[~valid] = 0.0
    args = (f(c + h * rng.uniform(-1.3, 1.3, (M, 3))),
            torch.as_tensor(valid), f(rng.normal(size=(M, 9))),
            f(rng.normal(size=(M, 3))), None if rot == "none" else f(g_rot),
            ts.lbs_cl, tr.spec)
    exact, limit = TB.deform_skinning_bwd_exact(*args)
    got = _kn_sums_float32(*args)
    assert not TB.deform_skinning_bwd_refused(got, exact, limit)
    faults = TB.deform_skinning_bwd_faults(*args, got, limit)
    assert len(faults) == (4 if rot == "none" else 5)
    for name, bad in faults.items():
        assert TB.deform_skinning_bwd_refused(bad, exact, limit), name


def test_pose_correction_leaves_cross_the_bridge(pose_setup):
    """``from_jax_params`` and ``to_jax_tree`` carry the four
    ``pose_correction`` leaves both ways, values and gradients."""
    from intrinsicavatar_tpu_torch.render.renderer import IntrinsicAvatar
    tree = jax.tree.map(np.array, pose_setup["tree"])
    cfg = pose_setup["cfg"][False]
    rng = np.random.default_rng(3)
    for k in ("pose", "global_orient", "transl", "betas"):
        tree["pose_correction"][k] = rng.normal(
            size=tree["pose_correction"][k].shape).astype(np.float32)
    model = IntrinsicAvatar(cfg.model)
    landed = from_jax_params(model, tree)
    for k in ("pose", "global_orient", "transl", "betas"):
        assert landed[f"pose_correction.{k}"] == f"pose_correction.{k}"
        p = getattr(model.pose_correction, k)
        np.testing.assert_array_equal(p.detach().numpy(),
                                      tree["pose_correction"][k])
        p.grad = 2.0 * p.detach()
    back = to_jax_tree(model)["pose_correction"]
    grads = to_jax_tree(model, grads=True)["pose_correction"]
    for k in ("pose", "global_orient", "transl", "betas"):
        np.testing.assert_array_equal(back[k], tree["pose_correction"][k])
        np.testing.assert_array_equal(grads[k], 2.0 * back[k])


def test_prepare_builds_the_pose_graph_only_while_training(pose_setup):
    """A training frame past ``pose_correction_start_step`` carries the
    corrections' graph in ``tfs`` (and only there: the baked voxels and
    the rays' transform are detached); eval, the steps before the
    switch-on and a disabled correction build no graph."""
    sys_ = TS.port_system(pose_setup["cfg"][False], pose_setup["tree"],
                          START + 1)
    b = sys_.to_device(pose_setup["batch"])
    model = sys_.model
    frame, _ = model.prepare(sys_.statics, b, START + 1, training=True)
    assert frame.tfs.requires_grad and frame.w2s.requires_grad
    assert not frame.voxel_J.requires_grad
    assert not frame.voxel_d.requires_grad
    rays = model.deformer.rigid.transform_rays_w2s(frame, b["rays"])
    assert not rays.requires_grad
    for step, training in ((START + 1, False), (START, True)):
        frame, _ = model.prepare(sys_.statics, b, step, training=training)
        assert not frame.tfs.requires_grad
    model.pose_correction.enable = False
    frame, _ = model.prepare(sys_.statics, b, START + 1, training=True)
    assert not frame.tfs.requires_grad


@pytest.fixture(scope="module")
def pose_setup():
    """The JAX system with ``optimize_betas``, its state, the tree, the
    port config with and without it, frame 1 of the synthetic data (its
    joints bent: at the zero pose of frame 0 the joints' positions, and so
    the betas, do not move ``tfs``) and the jitted step.  The betas'
    correction is zero, so the JAX gradients of every other leaf are those
    without ``optimize_betas``: one compile serves the three cases."""
    betas_on = {"model": {"deformer": {"rigid_deformer": {
        "deformer_config": {"optimize_betas": True}}}}}
    jsys, state, tree, cfg_b, batch, t_idx = TS.make_systems(
        betas_on, START + 1, frame=1)
    cfg = TS.port_config({})
    flags = jsys.flags_for_step(START + 1)
    assert flags == jsys.flags_for_step(START)
    return dict(jsys=jsys, state=state, tree=tree, cfg={True: cfg_b,
                                                         False: cfg},
                batch=batch, t_idx=t_idx, flags=flags,
                grad_fn=TS.make_grad_fn(jsys, flags))


def _jax_step(s, step, betas):
    """The JAX occupancy update and train step at ``step``: ``(state after
    the update, losses, gradients, new state, draws)``."""
    jsys, cfg, batch, t_idx, flags = (s["jsys"], s["cfg"][betas],
                                      s["batch"], s["t_idx"], s["flags"])
    state = s["state"]._replace(step=jnp.asarray(step, jnp.int32))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    draws = TS.JaxDraws(
        state.rng, 64, lambda _: TS.shading_lanes(cfg, flags, 64),
        lambda _: False, 16)(step, occ=True)
    state = jsys.occ_update_step(state, jb, t_idx)
    return (state, *TS.jax_step(jsys, s["grad_fn"], state, jb, t_idx, draws,
                                flags), draws)


def _port_step(s, step, betas, draws):
    """The port's occupancy update and train step at ``step`` with the JAX
    key path's ``draws``: ``(system, losses)``."""
    sys_ = TS.port_system(s["cfg"][betas], s["tree"], step)
    b = sys_.to_device(s["batch"])
    sys_.occ_update_step(b, s["t_idx"], draws)
    return sys_, sys_.train_step(b, s["t_idx"], sys_.flags_for_step(step),
                                 draws)


@pytest.mark.parametrize("step, betas", [(START + 1, False),
                                          (START + 1, True),
                                          (START, True)])
def test_pose_step_matches_jax(pose_setup, step, betas):
    """One occupancy update and one train step with
    ``enable_pose_correction``: the losses, every leaf's gradient (the
    pose corrections' included and, past the switch-on, nonzero; the
    betas' with ``optimize_betas``, exactly 0 without) and the updated
    parameters.  At step 4,000 every correction's gradient is exactly 0 on
    both sides."""
    s = pose_setup
    state, ref_losses, ref_grads, ref_new, draws = _jax_step(s, step,
                                                             betas)
    sys_, losses = _port_step(s, step, betas, draws)
    np.testing.assert_array_equal(sys_.occ.binaries.numpy(),
                                  np.asarray(state.occ.binaries))
    for k in LOSS_KEYS:
        assert float(losses[k]) == pytest.approx(
            float(ref_losses[k]), rel=CURV_RTOL if k == "curvature"
            else LOSS_RTOL), k

    grads = to_jax_tree(sys_.model, grads=True)
    errs = TS.leaf_errors(grads, ref_grads)
    pc = grads["pose_correction"]
    jpc = {k: np.asarray(v) for k, v in ref_grads["pose_correction"].items()}
    skip = set(CANCELLED)
    if step <= START:
        for k in pc:
            assert np.all(pc[k] == 0) and np.all(jpc[k] == 0), k
    else:
        assert errs["pose_correction.pose"][1] > 0
        for k in CANCELLED:
            for g in (pc, jpc):
                assert np.linalg.norm(g[k.split(".")[1]]) <= CANCEL_RTOL \
                    * np.linalg.norm(jpc["pose"]), k
        if betas:
            assert errs["pose_correction.betas"][1] > 0
        else:
            # JAX's reference optimizes the betas; the port's does not
            assert np.all(pc["betas"] == 0)
            skip.add("pose_correction.betas")
    for k, (err, ref) in errs.items():
        if k not in skip:
            assert err <= RTOLS.get(k, GRAD_RTOL) * ref + 1e-30, (k, err,
                                                                  ref)
    assert errs["geometry.table"][1] > 0
    # Adam's eps of 1e-15 turns rounding-level gradients into steps of
    # the rate (1e-5 at the optimizer's first step): within 2 lr per
    # entry; the JAX betas move only where the port's do
    new = to_jax_tree(sys_.model)
    ref_params = jax.tree.map(np.asarray, ref_new.params)
    if not betas:
        ref_params["pose_correction"]["betas"] = \
            new["pose_correction"]["betas"]
    TS.assert_tree_close(new, ref_params, 0.0, atol=2e-5, what="params")


# (fault, leaf) pairs the end-to-end tolerances separate from rounding:
# without the rotation term the pose's gradient is off JAX's by 8.9% and
# without the position term by 101% (the betas' 100%).  Without the
# rotation term the betas' gradient reads 5.2%, inside their rounding
# (5.1-5.6%): that term is held only by the KN tests above and the
# analytic-field deform test of test_torch_train.py.
@pytest.mark.parametrize("fault, leaf", [("no rotation term", "pose"),
                                         ("no position term", "pose"),
                                         ("no position term", "betas")])
def test_pose_tolerance_refuses_a_planted_fault(pose_setup, monkeypatch,
                                                fault, leaf):
    """The control behind ``RTOLS``: the port's step at 4,001 (with
    ``optimize_betas`` for the betas) with KN's twin missing one of its two
    terms gives a gradient off JAX's by more than the leaf's tolerance,
    where the sound step stays within it (``test_pose_step_matches_jax``)
    and a move of the rays by rounding moves JAX's by less
    (``test_rounding_moves_the_jax_pose_gradient``)."""
    from intrinsicavatar_tpu_torch.anim import deformer as DF
    fn = DF.deform_skinning_bwd

    def faulty(xc, valid, jinv, g_xc, g_rot, lbs_cl, spec):
        if fault == "no rotation term":
            g_rot = None
        else:
            g_xc = torch.zeros_like(g_xc)
        return fn(xc, valid, jinv, g_xc, g_rot, lbs_cl, spec)

    monkeypatch.setattr(DF, "deform_skinning_bwd", faulty)
    betas = leaf == "betas"
    _, _, ref_grads, _, draws = _jax_step(pose_setup, START + 1, betas)
    sys_, _ = _port_step(pose_setup, START + 1, betas, draws)
    k = f"pose_correction.{leaf}"
    err, ref = TS.leaf_errors(to_jax_tree(sys_.model, grads=True),
                              ref_grads)[k]
    assert err > RTOLS[k] * ref, (err, ref)


def test_pose_gradient_is_the_pullback_of_kn(pose_setup, monkeypatch):
    """The pose corrections' gradient of a train step at 4,001 is KN's
    d tfs pulled back through the ``tfs`` of the frame the step prepares:
    nothing else the frame carries reaches the loss with a pose gradient.
    (``chip_smoke.py`` holds the card's pose gradient to this pullback of
    the card step's own KN inputs, where no lane can cross a hash cell's
    face.)"""
    from intrinsicavatar_tpu_torch.anim import deformer as DF
    seen = []
    fn = DF.deform_skinning_bwd
    monkeypatch.setattr(DF, "deform_skinning_bwd",
                        lambda *a: seen.append(fn(*a)) or seen[-1])
    _, _, _, _, draws = _jax_step(pose_setup, START + 1, False)
    stepped, _ = _port_step(pose_setup, START + 1, False, draws)
    assert len(seen) == 1
    fresh = TS.port_system(pose_setup["cfg"][False], pose_setup["tree"],
                           START + 1)
    names = ("pose", "global_orient", "transl")
    leaves = [getattr(fresh.model.pose_correction, k) for k in names]
    frame, _ = fresh.model.prepare(
        fresh.statics, fresh.to_device(pose_setup["batch"]), START + 1,
        training=True)
    pulled = torch.autograd.grad(frame.tfs, leaves, seen[0])
    for k, g in zip(names, pulled):
        got = getattr(stepped.model.pose_correction, k).grad
        assert float((got - g).norm()) <= 1e-6 * float(pulled[0].norm()), k
    assert float(pulled[0].abs().max()) > 0


def test_rounding_moves_the_jax_pose_gradient(pose_setup):
    """The noise floor behind ``RTOLS``: the JAX step at 4,001 against
    itself with the rays moved by rounding, two draws.  The pose's and
    the betas' gradients move by more than ``GRAD_RTOL`` (one shading lane
    at a hash cell's face) and by less than their tolerances; the losses
    by less than ``LOSS_RTOL``."""
    s = pose_setup
    jsys, cfg, batch, t_idx, flags = (s["jsys"], s["cfg"][True],
                                      s["batch"], s["t_idx"], s["flags"])
    state = jsys.occ_update_step(s["state"], {
        k: jnp.asarray(v) for k, v in batch.items()}, t_idx)
    draws = TS.JaxDraws(state.rng, 64,
                        lambda _: TS.shading_lanes(cfg, flags, 64),
                        lambda _: False, 16)(START + 1, occ=False)

    def grads(rays):
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        jb["rays"] = jnp.asarray(rays)
        losses, g, _ = TS.jax_step(jsys, s["grad_fn"], state, jb, t_idx,
                                   draws, flags)
        return losses, g

    ref_losses, ref = grads(batch["rays"])
    rng = np.random.default_rng(11)
    moves = {k: [] for k in RTOLS}
    for _ in range(2):
        rays = (batch["rays"] * (1 + 2e-7 * rng.normal(
            size=batch["rays"].shape))).astype(np.float32)
        losses, g = grads(rays)
        assert float(losses["total"]) == pytest.approx(
            float(ref_losses["total"]), rel=LOSS_RTOL)
        errs = TS.leaf_errors(jax.tree.map(np.asarray, g), ref)
        for k in RTOLS:
            moves[k].append(errs[k][0] / errs[k][1])
    for k, tol in RTOLS.items():
        assert GRAD_RTOL < max(moves[k]) < tol, (k, moves[k])


def test_deform_train_mode_without_a_pose_gradient_is_eval_mode(snarf):
    """Train mode without a pose gradient gives the eval-mode outputs bit
    for bit: the correction is zero in value and gradient."""
    _, _, tr, ts = snarf
    frame = tr.prepare(ts, {
        "betas": torch.zeros(10), "body_pose": torch.zeros(69),
        "global_orient": torch.zeros(3), "transl": torch.zeros(3),
        "pose_correction": torch.zeros(69),
        "global_orient_correction": torch.zeros(3),
        "transl_correction": torch.zeros(3)})
    rng = np.random.default_rng(9)
    pts = torch.as_tensor(rng.normal(scale=0.3, size=(64, 3)),
                          dtype=torch.float32)

    def gfn(x):
        sdf = x[:, 0] + 0.5 * (x ** 2).sum(-1)
        return (sdf, x + 1.0, torch.cat([x, sdf[:, None]], -1)), None

    a = tr.deform(ts, frame, pts, gfn, with_jac=True, eval_mode=True)
    b = tr.deform(ts, frame, pts, gfn, with_jac=True, eval_mode=False)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.numpy(), y.numpy())


def test_launcher_validates_with_config(capsys, monkeypatch, tmp_path):
    """The launcher docstring's eval ``--config`` run, cut to one frame of
    256 rays, a 16^3 seed grid and a 16^3 test grid (the launcher's is
    64^3, which the CPU twins search for over a minute): it renders at the
    JAX package's default precision, its shading pass gathering the bf16
    tables, and exits 0; ``model.primary_dtype=float32`` still renders, by
    the exact path."""
    from intrinsicavatar_tpu_torch.launch import main
    from intrinsicavatar_tpu_torch.ops import precision
    from intrinsicavatar_tpu_torch.train import evaluate as EV
    build = EV.build_test_occ_grid
    monkeypatch.setattr(EV, "build_test_occ_grid", lambda *a, **k: build(
        *a, **{**k, "resolution": 16}))
    scoped = []
    cast = precision.cast_table
    monkeypatch.setattr(precision, "cast_table", lambda t: (
        scoped.append(precision.current_dtype()), cast(t))[1])
    args = ["--mode", "validate", "--config", "configs/tiny-synthetic.yaml",
            "--device", "cpu", "--exp-dir", str(tmp_path),
            "dataset.n_frames=1", "dataset.n_rays=256",
            "model.seed_grid_resolution=16"]
    for dtype in ("bfloat16", "float32"):
        scoped.clear()
        extra = [] if dtype == "bfloat16" else ["model.primary_dtype=float32"]
        assert main(args + extra) == 0
        cap = capsys.readouterr()
        assert "frame 0: psnr=" in cap.out
        assert "float32" not in cap.err
        assert (torch.bfloat16 in scoped) == (dtype == "bfloat16"), dtype
