"""The phys training regime of the port against the JAX package, with the
pose correction on: one train step at step 10,000 (``uniform_light``, the
PBR losses, the jittered material clone on its compacted subsample, the
secondary pass without gradient), three ``fit`` steps across the phys
kick-in (9,999 in the radiance regime, 10,000 and 10,001 in the phys one),
and the PBR loss terms on a given render output.  The JAX key path's draws
(light sphere, per-ray shuffle, jitter subsample and offsets) are injected
into the port.

One JAX system is shared by the module; its train step is one jit per
regime whose step is traced, so the single step and the fit's phys steps
share a compile (set-up in ``train_setup.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import train_setup as TS
from intrinsicavatar_tpu.train.system import IntrinsicAvatarSystem as JSystem
from intrinsicavatar_tpu.utils.config import merge as jmerge
from intrinsicavatar_tpu.utils.default_config import tiny_config as jtiny
from intrinsicavatar_tpu_torch.render.renderer import RenderFlags
from intrinsicavatar_tpu_torch.utils.config import merge
from intrinsicavatar_tpu_torch.utils.default_config import tiny_config
from intrinsicavatar_tpu_torch.weights import to_jax_tree


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Tier-1 runs six test workers on one host: keep each worker's torch
    pool small so it does not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


KICK = 10000         # phys_kick_in_step of the default config
R = 96               # 96 x 48 shading samples: the compacted path
SPP = 16             # the tiny config's scattering points per ray
# no budget escalation: each step's budgets, and so the JAX compile, stay
# those of the first
OVERRIDES = {"system": {"budget_boost_max": 0},
             "dataset": {"n_rays": R}}
# f32 on both sides.  The radiance-regime terms and gradients as in
# tests/test_torch_train.py (2% of each leaf's norm, losses 1e-3, the
# curvature proxy 2e-3).  The PBR terms add the secondary pass, whose
# discrete decisions (a polish lane converging at another step, a
# scattering draw on a CDF boundary) may move a secondary ray apart
# (tests/relight_setup.py): the PBR losses are held to 1e-3, the leaves
# the PBR stage reaches alone (material head, emitter) to 2% of their norm.
GRAD_RTOL, LOSS_RTOL, CURV_RTOL = 2e-2, 1e-3, 2e-3
# the pose gradient sums every shading lane's cotangent, whose second-order
# pullback jumps where a canonical point crosses a hash cell's face; a
# rounding-level move of the rays that flips such a lane moves it by a few
# percent (test_torch_train_pose.py::test_rounding_moves_the_jax_pose_
# gradient): 5%, which a planted fault exceeds (test_torch_train_pose.py::
# test_pose_tolerance_refuses_a_planted_fault)
RTOLS = {"pose_correction.pose": 5e-2}
# From a fit's second step on the parameters differ by up to 2 lr per
# entry: Adam's eps of 1e-15 turns a gradient entry that differs by
# rounding into a step of the rate, whose sign may differ (the global
# orient and translation corrections, whose gradient is rounding, so turn
# the rays' transform by ~1e-5 rad).  The curvature proxy, arccos of a dot
# near 1, moves most with such a move of the rays, as the pose's gradient
# does (test_torch_train_pose.py::test_rounding_moves_the_jax_pose_
# gradient).  Later steps' losses within 5e-3, the curvature within 5%.
FIT_RTOL, FIT_RTOLS = 5e-3, {"curvature": 5e-2}
# zero but for rounding: they cancel in tfs = A_0^-1 A_j tfs_inv_t
CANCELLED = ("pose_correction.global_orient", "pose_correction.transl")


@pytest.fixture(scope="module")
def phys():
    jsys, state, tree, cfg, batch, t_idx = TS.make_systems(OVERRIDES, KICK)
    flags = jsys.flags_for_step(KICK)
    assert flags.enable_phys and flags.jitter_materials
    assert flags.render_mode == "uniform_light"
    assert flags == jsys.flags_for_step(KICK + 1)
    fns = {}

    def grad_fn(f):
        if f not in fns:
            fns[f] = TS.make_grad_fn(jsys, f)
        return fns[f]

    return dict(jsys=jsys, state=state, tree=tree, cfg=cfg, batch=batch,
                t_idx=t_idx, grad_fn=grad_fn)


def _draws(s, state):
    jsys, cfg = s["jsys"], s["cfg"]
    return TS.JaxDraws(
        state.rng, R,
        lambda step: TS.shading_lanes(cfg, jsys.flags_for_step(step), R),
        lambda step: step >= KICK, SPP)


def _check_grads(grads, ref_grads):
    errs = TS.leaf_errors(grads, ref_grads)
    for k in ("pose_correction.pose", "geometry.table", "radiance.table",
              "material.mlp.0.w", "emitter.amplitude", "emitter.axes",
              "emitter.sharpness"):
        assert errs[k][1] > 0, k
    pose = errs["pose_correction.pose"][1]
    for k, (err, ref) in errs.items():
        if k in CANCELLED:
            for g in (grads, jax.tree.map(np.asarray, ref_grads)):
                leaf = g["pose_correction"][k.split(".")[1]]
                assert np.linalg.norm(leaf) <= 1e-4 * pose, k
            continue
        assert err <= RTOLS.get(k, GRAD_RTOL) * ref + 1e-30, (k, err, ref)


def test_phys_step_matches_jax(phys):
    """One occupancy update and one train step at step 10,000: every loss
    term and counter of the JAX step, every leaf's gradient (the material
    head's, the emitter's and the pose correction's included) and the
    updated parameters."""
    s = phys
    jsys, tree, cfg, batch, t_idx = (s["jsys"], s["tree"], s["cfg"],
                                     s["batch"], s["t_idx"])
    state = s["state"]
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    flags = jsys.flags_for_step(KICK)
    draws = _draws(s, state)(KICK)
    assert "jit_sub" in draws and "occ_u" in draws
    state = jsys.occ_update_step(state, jb, t_idx)
    ref_losses, ref_grads, ref_new = TS.jax_step(
        jsys, s["grad_fn"](flags), state, jb, t_idx, draws, flags)

    sys_ = TS.port_system(cfg, tree, KICK)
    b = sys_.to_device(batch)
    sys_.occ_update_step(b, t_idx, draws)
    losses = sys_.train_step(b, t_idx, sys_.flags_for_step(KICK), draws)
    assert set(losses) == set(ref_losses)
    for k, v in ref_losses.items():
        rel = CURV_RTOL if k == "curvature" else LOSS_RTOL
        assert float(losses[k]) == pytest.approx(float(v), rel=rel), k
    for k in ("rgb_phys_l1", "albedo_smoothness", "normal_orientation"):
        assert float(losses[k]) > 0, k
    _check_grads(to_jax_tree(sys_.model, grads=True), ref_grads)
    TS.assert_tree_close(to_jax_tree(sys_.model), ref_new.params, 0.0,
                         atol=2e-5, what="params")


def test_fit_tracks_jax_across_phys_kick_in(phys):
    """``fit`` for steps 9,999 (radiance regime), 10,000 (the phys regime's
    first step, with an occupancy update) and 10,001, against the JAX
    step's loop on the same batch: every step's losses and counters, and
    the parameters after the last step."""
    s = phys
    jsys, tree, cfg, batch, t_idx = (s["jsys"], s["tree"], s["cfg"],
                                     s["batch"], s["t_idx"])
    start, n = KICK - 1, 3
    state = s["state"]._replace(step=jnp.asarray(start, jnp.int32))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    ref_hist = []
    for step in range(start, start + n):
        if step % 20 == 0:
            state = jsys.occ_update_step(state, jb, t_idx)
        flags = jsys.flags_for_step(step)
        assert flags.enable_phys == (step >= KICK)
        draws_ref = _draws(s, state)(step, occ=False)
        losses, _, state = TS.jax_step(jsys, s["grad_fn"](flags), state, jb,
                                       t_idx, draws_ref, flags)
        ref_hist.append({k: float(v) for k, v in losses.items()})

    def data():
        while True:
            yield batch, t_idx

    sys_ = TS.port_system(cfg, tree, start)
    hist = sys_.fit(data(), start + n, log_every=1,
                    draws_fn=_draws(s, s["state"]))
    assert [h[0] for h in hist] == list(range(start, start + n))
    for i, ((_, got), ref) in enumerate(zip(hist, ref_hist)):
        for k, v in ref.items():
            rel = (CURV_RTOL if k == "curvature" else LOSS_RTOL) if i == 0 \
                else FIT_RTOLS.get(k, FIT_RTOL)
            assert got[k] == pytest.approx(v, rel=rel, abs=1e-9), (i, k)
    assert "rgb_phys_l1" not in hist[0][1] and "rgb_phys_l1" in hist[1][1]
    # within 2 lr per step and entry (Adam's eps turns rounding-level
    # gradients into steps of the rate)
    TS.assert_tree_close(to_jax_tree(sys_.model), state.params, 0.0,
                         atol=2 * n * 1e-5, what="params")


def test_phys_losses_match_jax():
    """Every PBR term of the JAX ``compute_losses`` on one given render
    output, with every weight on (albedo, entropy, energy conservation on
    a 3-channel metallic map), with and without ``add_emitter``."""
    rng = np.random.default_rng(12)
    n, R_, S = 128, 32, 24
    on = {"system": {"loss": {
        k: 0.1 for k in ("lambda_rgb_mse", "lambda_rgb_phys_mse",
                         "lambda_rgb_demodulated", "lambda_albedo",
                         "lambda_normal_orientation",
                         "lambda_albedo_entropy",
                         "lambda_energy_conservation", "lambda_sparsity",
                         "lambda_opaque")}}}
    smask = rng.random((R_, S)) < 0.7
    out = {"rays_valid": rng.random((R_, 1)) < 0.8,
           "rays_valid_phys_full": rng.random((R_, 1)) < 0.7,
           "comp_rgb_full": rng.random((R_, 3)),
           "comp_rgb_phys_full": rng.random((R_, 3)),
           "comp_demod_phys_full": rng.random((R_, 3)),
           "comp_albedo_full": rng.random((R_, 3)) * 0.8,
           "comp_metallic_full": rng.random((R_, 3)) * 0.5,
           "sample_mask": smask,
           "sdf_grad_samples": rng.normal(size=(R_ * S, 3)),
           "opacity": rng.random((R_, 1)),
           "sdf_samples": rng.normal(size=(R_ * S,)),
           "sdf_laplace_samples": rng.random(n),
           "laplace_mask": rng.random(n) < 0.6,
           "normals_orientation_loss_map": rng.random((R_, 1)),
           "albedo_smoothness_loss_map": rng.random((R_, 1)),
           "roughness_smoothness_loss_map": rng.random((R_, 1)),
           "metallic_smoothness_loss_map": rng.random((R_, 1)),
           "beta": np.float32(0.2)}
    out = {k: (v.astype(np.float32) if v.dtype == np.float64 else v)
           for k, v in out.items()}
    batch = {"rgb": rng.random((R_, 3)).astype(np.float32),
             "rgb_wo_mask": rng.random((R_, 3)).astype(np.float32),
             "albedo": rng.random((R_, 3)).astype(np.float32),
             "alpha": (rng.random(R_) < 0.5).astype(np.float32)}
    for add_emitter in (False, True):
        over = TS.deep_merge(TS.deep_merge(TS.BASE, on),
                             {"model": {"add_emitter": add_emitter}})
        jsys = JSystem(jmerge(jtiny(), over))
        state = jsys.setup(np.zeros(10), jax.random.PRNGKey(0))
        sys_ = TS.port_system(merge(tiny_config(), over),
                              jax.tree.map(np.asarray, state.params), KICK)
        flags = jsys.flags_for_step(KICK)
        lip = jsys.model.material.lipschitz_bound(state.params["material"])
        _, ref = jsys.compute_losses(
            state.params, {k: jnp.asarray(v) for k, v in out.items()},
            {k: jnp.asarray(v) for k, v in batch.items()}, KICK, flags)
        tflags = sys_.flags_for_step(KICK)
        assert isinstance(tflags, RenderFlags) and tflags.enable_phys
        _, got = sys_.compute_losses(
            {k: torch.as_tensor(v) for k, v in out.items()},
            {k: torch.as_tensor(v) for k, v in batch.items()}, KICK, tflags)
        assert set(got) == set(ref)
        for k in ("rgb_phys_mse", "rgb_demodulated", "albedo",
                  "albedo_entropy", "energy_conservation"):
            assert float(ref[k]) > 0, k
        for k in ref:
            assert float(got[k]) == pytest.approx(float(ref[k]),
                                                  rel=1e-5), k
        assert float(got["lipshitz_bound"]) == pytest.approx(float(lip),
                                                             rel=1e-6)


def test_unread_leaves_keep_the_optax_adam_count(phys):
    """A leaf the loss does not read (the material head and emitter before
    the phys kick-in, the pose corrections before step 4,001) takes Adam
    steps with a zero gradient, as optax's chain does, so its bias
    correction is JAX's when it is first read: two steps where only the
    fields have gradients, then one where every leaf has one, against the
    JAX optimizer on the same gradients (zeros for the unread leaves)."""
    from intrinsicavatar_tpu.train.optim import make_optimizer as j_opt
    from intrinsicavatar_tpu_torch.train.optim import step_every_leaf
    from intrinsicavatar_tpu_torch.weights import flatten_tree, port_key
    tree, cfg = phys["tree"], phys["cfg"]
    sys_ = TS.port_system(cfg, tree, KICK)
    scfg = cfg.system
    tx = j_opt(tree, scfg.optimizer, scfg.scheduler, scfg.warmup_steps)
    params = jax.tree.map(jnp.asarray, tree)
    opt_state = tx.init(params)
    # under jit: op by op, the first update compiles each leaf's ops
    update = jax.jit(tx.update)
    names = dict(sys_.model.named_parameters())
    rng = np.random.default_rng(4)
    unread = ("material.", "emitter.", "pose_correction.")
    for k in range(3):
        grads = jax.tree.map(lambda p: np.asarray(rng.normal(
            size=p.shape), np.float32), tree)
        flat = flatten_tree(grads)
        for key, g in flat.items():
            if k < 2 and key.startswith(unread):
                g[...] = 0.0
                names[port_key(key)].grad = None
            else:
                names[port_key(key)].grad = torch.as_tensor(g)
        updates, opt_state = update(jax.tree.map(jnp.asarray, grads),
                                    opt_state, params)
        params = jax.tree.map(lambda p, u: p + u, params, updates)
        step_every_leaf(sys_.optimizer)
        sys_.scheduler.step()
        if k < 2:
            assert all(p.grad is None for n, p in names.items()
                       if n.startswith(unread))
    ref = flatten_tree(jax.tree.map(np.asarray, params))
    for name, p in names.items():
        key = name.replace(".mlp.layers.", ".mlp.")
        np.testing.assert_allclose(p.detach().numpy(), ref[key], rtol=1e-6,
                                   atol=1e-9, err_msg=key)
