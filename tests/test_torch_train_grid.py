"""The per-step baked seed grid in training (``train_seed_grid``) against
the JAX package: which steps bake (``use_train_seed_grid``), one phys step
at step 11,000 whose importance rounds, shading pass and PBR stage read one
grid baked by JAX's ``sample_step`` (carried across by
``weights.seed_grid_from_jax``), with the seeded shading pass and with the
searched one (``train_seed_grid_primary: false``), the same step over two
microbatches against ``_train_step_accum`` (one bake a step), and the
train-mode seeded polish's pose gradient against ``jax.vjp``.

The pose correction is on (the tiny config's base in ``train_setup.py``),
so the seeded shading pass's roots carry the pose gradient through the
train-mode correction (kernel KN's twin).  One JAX system is shared by the
module: its sampling stage (occupancy update, bake, importance rounds) runs
once and serves every step."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import train_setup as TS
from intrinsicavatar_tpu.render.renderer import IntrinsicAvatar as JModel
from intrinsicavatar_tpu.render.renderer import RenderFlags as JFlags
from intrinsicavatar_tpu.utils.config import merge as jmerge
from intrinsicavatar_tpu.utils.default_config import tiny_config as jtiny
from intrinsicavatar_tpu_torch.anim import deformer as DF
from intrinsicavatar_tpu_torch.data.synthetic import SyntheticDataset
from intrinsicavatar_tpu_torch.render.renderer import (
    IntrinsicAvatar, RenderFlags,
)
from intrinsicavatar_tpu_torch.utils.config import merge
from intrinsicavatar_tpu_torch.utils.default_config import tiny_config
from intrinsicavatar_tpu_torch.weights import seed_grid_from_jax, to_jax_tree


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Tier-1 runs six test workers on one host: keep each worker's torch
    pool small so it does not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


STEP = 11000         # the phys regime, the pose corrections on
R = 96               # 96 x 48 shading samples: the compacted path
SPP = 16             # the tiny config's scattering points per ray
GRID = {"train_seed_grid": True, "train_seed_grid_resolution": 24}
OVERRIDES = {"system": {"budget_boost_max": 0}, "dataset": {"n_rays": R},
             "model": GRID}
# the tolerances of tests/test_torch_train_phys.py: each leaf's gradient
# within 2% of its norm, the pose's within 5% (a shading lane at a hash
# cell's face moves it, test_torch_train_pose.py), the losses within 1e-3
# (the curvature proxy 2e-3); the global orient and translation
# corrections cancel in tfs (their gradients are rounding)
GRAD_RTOL, LOSS_RTOL, CURV_RTOL = 2e-2, 1e-3, 2e-3
RTOLS = {"pose_correction.pose": 5e-2}
CANCELLED = ("pose_correction.global_orient", "pose_correction.transl")


@pytest.fixture(scope="module")
def grid_step():
    """The JAX system at step 11,000, the state after its occupancy update,
    the step's draws and its sampling stage (``sample_step``: intervals,
    counters and the baked grid), and the grid as the port's."""
    jsys, state, tree, cfg, batch, t_idx = TS.make_systems(OVERRIDES, STEP)
    flags = jsys.flags_for_step(STEP)
    assert flags.enable_phys and jsys.model.use_train_seed_grid(flags)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    draws = TS.JaxDraws(state.rng, R,
                        lambda _: TS.shading_lanes(cfg, flags, R),
                        lambda _: True, SPP)(STEP)
    assert "occ_u" in draws and "jit_sub" in draws
    state = jsys.occ_update_step(state, jb, t_idx)
    sampled = jsys.sample_step(state, jb, t_idx, flags)
    assert sampled[2] is not None
    grid = seed_grid_from_jax(sampled[2])
    assert grid.resolution == 24 and grid.channels == 6
    return dict(jsys=jsys, state=state, tree=tree, cfg=cfg, batch=batch,
                jb=jb, t_idx=t_idx, flags=flags, draws=draws,
                sampled=sampled, grid=grid)


def _port_step(s, cfg, draws):
    """The port's occupancy update and train step at ``STEP`` with JAX's
    grid in place of its own bake: ``(system, losses, bakes)``."""
    sys_ = TS.port_system(cfg, s["tree"], STEP)
    bakes = []
    sys_.model.bake_train_seed_grid = lambda *a: bakes.append(a) \
        or s["grid"]
    b = sys_.to_device(s["batch"])
    sys_.occ_update_step(b, s["t_idx"], draws)
    np.testing.assert_array_equal(sys_.occ.binaries.numpy(),
                                  np.asarray(s["state"].occ.binaries))
    losses = sys_.train_step(b, s["t_idx"], sys_.flags_for_step(STEP),
                             draws)
    return sys_, losses, bakes


def _check_step(sys_, losses, ref_losses, ref_grads, ref_params):
    assert set(losses) == set(ref_losses)
    for k, v in ref_losses.items():
        rel = CURV_RTOL if k == "curvature" else LOSS_RTOL
        assert float(losses[k]) == pytest.approx(float(v), rel=rel), k
    for k in ("rgb_phys_l1", "albedo_smoothness", "normal_orientation"):
        assert float(losses[k]) > 0, k
    grads = to_jax_tree(sys_.model, grads=True)
    errs = TS.leaf_errors(grads, ref_grads)
    pose = errs["pose_correction.pose"][1]
    for k in ("pose_correction.pose", "geometry.table", "radiance.table",
              "material.mlp.0.w", "emitter.amplitude"):
        assert errs[k][1] > 0, k
    for k, (err, ref) in errs.items():
        if k in CANCELLED:
            for g in (grads, jax.tree.map(np.asarray, ref_grads)):
                leaf = g["pose_correction"][k.split(".")[1]]
                assert np.linalg.norm(leaf) <= 1e-4 * pose, k
            continue
        assert err <= RTOLS.get(k, GRAD_RTOL) * ref + 1e-30, (k, err, ref)
    # Adam's eps of 1e-15 turns rounding-level gradients into steps of the
    # rate: within 2 lr per entry
    TS.assert_tree_close(to_jax_tree(sys_.model), ref_params, 0.0,
                         atol=2e-5, what="params")


FLAG_CASES = {"radiance": dict(training=True),
              "importance": dict(training=True, importance_sample=True),
              "phys": dict(training=True, importance_sample=True,
                           enable_phys=True),
              "eval": dict(training=False, importance_sample=True,
                           enable_phys=True)}
SCOPES = {"off": {"train_seed_grid": False},
          "phys": {"train_seed_grid": True},
          "all": {"train_seed_grid": True, "train_seed_grid_scope": "all"}}
BAKES = {("phys", "phys"), ("all", "importance"), ("all", "phys")}


@pytest.mark.parametrize("scope", list(SCOPES))
@pytest.mark.parametrize("case", list(FLAG_CASES))
def test_use_train_seed_grid_matches_jax(scope, case):
    """Which renders bake a training grid: both packages' rule, over the
    grid off and the scopes ``phys`` and ``all``, and the radiance regime
    before importance sampling, after it, the phys regime and eval."""
    over = {"model": SCOPES[scope]}
    jm = JModel(jmerge(jtiny(), over).model)
    tm = IntrinsicAvatar(merge(tiny_config(), over).model)
    got = tm.use_train_seed_grid(RenderFlags(**FLAG_CASES[case]))
    assert got == jm.use_train_seed_grid(JFlags(**FLAG_CASES[case]))
    assert got == ((scope, case) in BAKES)


def test_train_bake_is_the_eval_bake_without_autograd(grid_step):
    """The port's training bake is its eval bake at
    ``train_seed_grid_resolution``, from a frame whose ``tfs`` carries the
    pose's graph, without autograd."""
    cfg = TS.port_config({"model": {**GRID,
                                    "train_seed_grid_resolution": 8}})
    sys_ = TS.port_system(cfg, grid_step["tree"], 4001)
    b = sys_.to_device(SyntheticDataset(cfg.dataset)[1])
    frame, cond = sys_.model.prepare(sys_.statics, b, 4001, training=True)
    assert frame.tfs.requires_grad
    grid = sys_.model.bake_train_seed_grid(sys_.statics, frame, cond, 4001)
    ref = sys_.model.bake_seed_grid(sys_.statics, frame, cond, 4001,
                                    resolution=8)
    assert grid.resolution == 8 and not grid.grid.requires_grad
    for a, r in zip(grid, ref):
        assert torch.equal(a, r)


@pytest.mark.parametrize("primary", [True, False])
def test_grid_phys_step_matches_jax(grid_step, primary):
    """One occupancy update and one train step at step 11,000 with
    ``train_seed_grid`` and JAX's grid in both packages: the importance
    rounds read the grid's SDF, the secondary coarse pass gathers it and
    seeds the fine pass, and the shading pass is polished from its seeds
    (with ``train_seed_grid_primary``, JAX's default) or searched.  Every
    loss term and counter, every leaf's gradient (the pose's through the
    seeded roots' correction) and the updated parameters; the port bakes
    once (its bake stands in for JAX's grid here)."""
    s = grid_step
    jsys, flags = s["jsys"], s["flags"]
    mcfg = jsys.config.model
    mcfg["train_seed_grid_primary"] = primary
    try:
        grad_fn = TS.make_grad_fn(jsys, flags)
        ref_losses, ref_grads, ref_new = TS.jax_step(
            jsys, grad_fn, s["state"], s["jb"], s["t_idx"], s["draws"],
            flags, sampled=s["sampled"])
    finally:
        mcfg["train_seed_grid_primary"] = True
    cfg = merge(s["cfg"], {"model": {"train_seed_grid_primary": primary}})
    sys_, losses, bakes = _port_step(s, cfg, s["draws"])
    assert len(bakes) == 1
    # the seeded shading pass counts its polish's failures, the searched
    # one its candidates
    assert ("ovf_candidates" in losses) != primary
    _check_step(sys_, losses, ref_losses, ref_grads, ref_new.params)


def test_grid_accumulated_step_matches_jax(grid_step):
    """The same step with ``trainer.grad_accum: 2`` against the JAX
    package's accumulated step on the same grid: ``_train_step_accum``'s
    body (`train/system.py:523-547`: the microbatch keys, JAX's own
    ``_grad_microbatch`` for each, the gradients' and losses' means, Adam),
    with its microbatch function jitted once for both (the unrolled step
    compiles the microbatch twice, ~2.5x the time on a CPU).  The losses,
    every gradient and the updated parameters; the port bakes once for
    the two microbatches."""
    s = grid_step
    jsys, state, flags, cfg = s["jsys"], s["state"], s["flags"], s["cfg"]
    intervals, s_counters, jgrid = s["sampled"]
    _, k_bg, k_fwd = jax.random.split(state.rng, 3)
    bg = jax.random.uniform(k_bg, (3,))
    keys = jax.random.split(k_fwd, 2)
    micro = jax.jit(jsys._grad_microbatch, static_argnums=(3, 7))
    per = [micro(state.params, state.occ, state.step, flags, s["t_idx"],
                 keys[i], bg, 2, jnp.asarray(i, jnp.int32), s["jb"],
                 intervals, jgrid) for i in range(2)]
    ref_grads = jax.tree.map(lambda a, b: (a + b) / 2, per[0][0],
                             per[1][0])
    ref = {k: (per[0][1][k] + per[1][1][k]) / 2 for k in per[0][1]}
    for k, v in s_counters.items():
        ref[k] = ref[k] + v if k in ref else v
    updates, _ = jax.jit(jsys.tx.update)(ref_grads, state.opt_state,
                                         state.params)
    ref_new = jax.tree.map(lambda p, u: p + u, state.params, updates)

    # the accumulated step's draws: the sampling stage's from k_fwd, each
    # microbatch's from its key
    m = R // 2
    draws = {k: v for k, v in s["draws"].items()
             if k in ("occ_u", "bg", "strat_u")}
    draws["micro"] = [
        TS.forward_draws(key, m, *TS.shading_lanes(cfg, flags, m), True, SPP)
        for key in keys]
    np.testing.assert_array_equal(draws["bg"], np.asarray(bg))
    sys_, losses, bakes = _port_step(
        s, merge(cfg, {"trainer": {"grad_accum": 2}}), draws)
    assert sys_.grad_accum == 2 and len(bakes) == 1
    _check_step(sys_, losses, ref, ref_grads, ref_new)


def test_train_mode_seeded_polish_matches_jax_vjp(grid_step, monkeypatch):
    """Train-mode ``deform_seeded`` at a bent pose (frame 1) on a smooth
    analytic canonical field (no hash cell's face takes a branch apart),
    seeded near each package's searched roots: its d tfs, of the roots,
    SDF and observation-space gradient together and of the gradient alone
    (through the blended rotation, ``use_j_inv`` false), against
    ``jax.vjp`` of JAX's ``deform_seeded(eval_mode=False)``, within 1e-4
    of its norm.  Without a pose gradient, train mode gives the eval-mode
    outputs bit for bit and launches no KN."""
    jsys, state = grid_step["jsys"], grid_step["state"]
    cfg = grid_step["cfg"]
    batch = SyntheticDataset(cfg.dataset)[1]
    batch.pop("t_idx")
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jframe, _ = jsys.model.prepare(state.params, jsys.statics, jb, STEP)
    sys_ = TS.port_system(cfg, grid_step["tree"], STEP)
    frame, _ = sys_.model.prepare(sys_.statics, sys_.to_device(batch), STEP)
    rigid, jrigid = sys_.model.deformer.rigid, jsys.model.deformer.rigid
    assert not rigid.use_j_inv and not jrigid.use_j_inv
    rng = np.random.default_rng(8)
    rays = rigid.transform_rays_w2s(frame, torch.as_tensor(np.repeat(
        batch["rays"], 4, 0))).numpy()
    t = rng.uniform(rays[:, 6:7], rays[:, 7:8])
    pts = (rays[:, :3] + rays[:, 3:6] * t).astype(np.float32)
    a = rng.normal(size=3).astype(np.float32)
    c_x, c_g = (rng.normal(size=pts.shape).astype(np.float32)
                for _ in range(2))

    def field(x, xp):
        sdf = x @ xp.asarray(a) + 0.5 * xp.sum(x * x, -1)
        feat = xp.concatenate([x, sdf[:, None]], -1)
        return (sdf, xp.asarray(a)[None, :] + x, feat), None

    # the seeds: the searched roots moved by ~1e-3, as a grid's blend
    # lies near the root it polishes to
    found = rigid.deform(sys_.statics, frame, torch.as_tensor(pts),
                         lambda x: field(x, torch), with_jac=True)
    seed_ok = found[2].numpy()
    seed_xc = (found[0].numpy() + rng.normal(scale=1e-3, size=pts.shape)
               * seed_ok[:, None]).astype(np.float32)
    assert 0.2 < seed_ok.mean() < 1.0

    def loss(out, w, xp):
        x_c, sdf, valid, g_obs = out[:4]
        return w * (xp.sum(x_c * xp.asarray(c_x)) + xp.sum(
            xp.where(valid, sdf, 0.0))) + xp.sum(g_obs * xp.asarray(c_g))

    def jloss(tfs, w):
        out = jrigid.deform_seeded(
            jsys.statics, jframe._replace(tfs=tfs), jnp.asarray(pts),
            jnp.asarray(seed_xc), jnp.asarray(seed_ok),
            lambda x: field(x, jnp), with_jac=True, eval_mode=False)
        return loss(out, w, jnp), out[2]

    jgrad = jax.jit(jax.value_and_grad(jloss, has_aux=True))
    for w in (1.0, 0.0):       # every output; the rotation's term alone
        (_, jvalid), ref = jgrad(jframe.tfs, w)
        tfs = frame.tfs.clone().requires_grad_()
        out = rigid.deform_seeded(
            sys_.statics, frame._replace(tfs=tfs), torch.as_tensor(pts),
            torch.as_tensor(seed_xc), torch.as_tensor(seed_ok),
            lambda x: field(x, torch), with_jac=True, eval_mode=False)
        np.testing.assert_array_equal(out[2].numpy(), np.asarray(jvalid))
        (got,) = torch.autograd.grad(loss(out, w, torch), tfs)
        ref = np.asarray(ref)
        assert np.linalg.norm(ref) > 0
        assert np.linalg.norm(got.numpy() - ref) <= 1e-4 * np.linalg.norm(
            ref), w

    def no_kn(*a):
        raise AssertionError("KN launched without a pose gradient")

    monkeypatch.setattr(DF, "deform_skinning_bwd", no_kn)
    args = (sys_.statics, frame, torch.as_tensor(pts),
            torch.as_tensor(seed_xc), torch.as_tensor(seed_ok))
    x = torch.as_tensor(a).requires_grad_()
    fld = lambda p: ((p @ x + 0.5 * (p * p).sum(-1), x[None, :] + p,
                      torch.cat([p, (p @ x)[:, None]], -1)), None)
    ev = rigid.deform_seeded(*args, fld, with_jac=True, eval_mode=True)
    tr = rigid.deform_seeded(*args, fld, with_jac=True, eval_mode=False)
    for e, o in zip(ev, tr):
        assert torch.equal(e, o)
    loss(tr, 1.0, torch).backward()
    assert float(x.grad.abs().max()) > 0
