"""The sampled render modes in training (``light``, ``mats``, ``mis``)
against the JAX package: ``pbr_forward`` under training flags at 32 rays
and 4 scattering points a ray, the JAX key path's emitter and BRDF draws
(``light_u``, ``brdf_u``) injected into the port.  A scalar of
``comp_rgb_phys`` and ``comp_demod_phys`` and its gradients with respect
to the emitter's parameters and to the inputs through which the material
and geometry fields reach the PBR stage (the material maps, the primary
normals and the compositing weights) must agree.  That holds each of the
JAX package's gradient stops in these modes (`render/pbr.py:386-528`):
the emitter's sampling tables (``update_pdf``) without gradient, the
BRDF-sampled directions and ``mats``'s pdf detached, the MIS weights
detached, and the emitter's radiance differentiated.  The frame's
world-to-SMPL rotation is detached on both sides
(``transform_dirs_w2s`` / ``_s2w``), so no pose gradient passes the stage.

The secondary pass (``compute_indirect_radiance``) carries no gradient on
either side and reads only the budget boost of the flags, so its training
forward is its eval forward, which ``test_torch_relight_sampled.py`` and
``test_torch_relight_mis.py`` hold to JAX in these modes.  Here the JAX
stage takes the port's secondary-pass outputs in its place, call by call,
and hands back the directions it asked them for, which must be the
port's: each mode's JAX jit then compiles the differentiated stage alone
(~1-3 s on a CPU, not the ~16 s of the whole pass)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import relight_setup as RS
from intrinsicavatar_tpu.render import pbr as JP
from intrinsicavatar_tpu.render.occupancy import make_occ_grid
from intrinsicavatar_tpu.render.renderer import IntrinsicAvatar as JModel
from intrinsicavatar_tpu.render.renderer import RenderFlags as JFlags
from intrinsicavatar_tpu.utils.config import merge as jmerge
from intrinsicavatar_tpu.utils.default_config import tiny_config as jtiny
from intrinsicavatar_tpu_torch.render import pbr as TP
from intrinsicavatar_tpu_torch.render.occupancy import OccGridState
from intrinsicavatar_tpu_torch.render.renderer import (
    IntrinsicAvatar, RenderFlags,
)
from intrinsicavatar_tpu_torch.utils.config import merge
from intrinsicavatar_tpu_torch.utils.default_config import tiny_config
from intrinsicavatar_tpu_torch.weights import from_jax_params, to_jax_tree


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Tier-1 runs six test workers on one host: keep each worker's torch
    pool small so it does not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


STEP = 25000                  # the phys regime, every schedule level on
R, S, SPP, RES = 32, 16, 4, 16
OVERRIDES = {"model": {"primary_dtype": "float32",
                       "secondary_coarse_dtype": "float32",
                       "eval_seed_grid": False, "samples_per_pixel": SPP}}
# f32 on both sides: the gradients of tests/test_torch_train_phys.py's
# step within 2% of each leaf's norm (the leaves the PBR stage reaches
# alone, material head and emitter), the scalar within 1e-3 relative
GRAD_RTOL, LOSS_RTOL = 2e-2, 1e-3
# the secondary directions: unit vectors from the same draws through
# float32 sampling tables (emitter) or BRDF inversions on both sides
DIR_TOL = 1e-5


@pytest.fixture(scope="module")
def stage():
    """Both models from one JAX init, a posed frame, a random occupancy
    grid and the primary pass's outputs for 32 rays toward the body (16
    samples, weights peaked near a surface 0.3 before the pelvis, random
    normals facing the camera, random materials): a few secondary rays
    from there meet the initial body."""
    jcfg = jmerge(jtiny(), OVERRIDES)
    cfg = merge(tiny_config(), OVERRIDES)
    jm = JModel(jcfg.model)
    js = jm.initialize(np.zeros(10))
    # jitted: eager JAX compiles each op of the init and the SMPL forward
    # on its first call (~12 s); both packages take these parameters
    jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
    model = IntrinsicAvatar(cfg.model)
    statics = model.initialize(np.zeros(10))
    from_jax_params(model, jax.tree.map(np.asarray, jp))
    rng = np.random.default_rng(1)
    batch = {"index": np.asarray([0]), "betas": np.zeros(10, np.float32),
             "body_pose": (rng.normal(size=69) * 0.2).astype(np.float32),
             "global_orient": np.zeros(3, np.float32),
             "transl": np.asarray([0.0, 0.3, 2.0], np.float32)}
    jframe, jcond = jax.jit(lambda p, b: jm.prepare(p, js, b, STEP))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    frame, cond = model.prepare(statics, {k: torch.as_tensor(v)
                                          for k, v in batch.items()}, STEP)
    # the rays in SMPL space, from the camera at the world's origin
    w2s = np.asarray(jframe.w2s)
    target = batch["transl"] + rng.normal(scale=0.15, size=(R, 3))
    d = target / np.linalg.norm(target, axis=-1, keepdims=True)
    t = np.linspace(1.0, 2.2, S + 1, dtype=np.float32)
    t_starts = np.broadcast_to(t[:-1], (R, S)).copy()
    t_ends = np.broadcast_to(t[1:], (R, S)).copy()
    mids = 0.5 * (t_starts + t_ends)
    t_hit = np.linalg.norm(target, axis=-1)[:, None] - 0.3
    smask = rng.random((R, S)) < 0.9
    w = np.exp(-((mids - t_hit) / 0.08) ** 2) * smask
    w = 0.9 * w / np.maximum(w.sum(-1, keepdims=True), 1e-6)
    rd = (d @ w2s[:3, :3].T).astype(np.float32)
    nrm = rng.normal(size=(R, S, 3)) - 2.0 * rd[:, None, :]
    arrays = {
        "rays_o": np.broadcast_to(w2s[:3, 3], (R, 3)), "rays_d": rd,
        "t_starts": t_starts, "t_ends": t_ends, "smask": smask,
        "sdf": t_hit - mids,
        "weights": w,
        "mats": rng.uniform(0.1, 0.9, size=(R * S, 5)),
        "normals": nrm / np.linalg.norm(nrm, axis=-1, keepdims=True),
        "bg": np.asarray([0.2, 0.5, 0.8]),
        "cw": rng.uniform(0.5, 1.5, size=(2, R, 3))}
    arrays = {k: (v.astype(np.float32) if v.dtype.kind == "f" else v)
              for k, v in arrays.items()}
    binaries = rng.random((RES, RES, RES)) < 0.7
    aabb = np.asarray(cfg.model.scene_aabb, np.float32)
    return dict(
        jm=jm, js=js, jp=jp, jframe=jframe, jcond=jcond, model=model,
        statics=statics, frame=frame, cond=cond, a=arrays,
        jocc=make_occ_grid(aabb[None], RES)._replace(
            binaries=jnp.asarray(binaries)[None]),
        occ=OccGridState(torch.zeros(1, RES ** 3),
                         torch.as_tensor(binaries)[None],
                         torch.as_tensor(aabb)[None]))


def _scalar(out, cw):
    return (out["comp_rgb_phys"] * cw[0]).sum() \
        + (out["comp_demod_phys"] * cw[1]).sum()


def _jax_stage(s, mode, key, indirect, monkeypatch):
    """The JAX scalar and its gradients with respect to the emitter's
    parameters, the material maps, the normals and the weights, with the
    port's secondary-pass outputs ``indirect`` (``[(tr, rgb)]`` in call
    order) in place of its own; and the directions of those calls."""
    jm, a = s["jm"], {k: jnp.asarray(v) for k, v in s["a"].items()}
    flags = JFlags(training=True, enable_phys=True, importance_sample=True,
                   randomized=True, render_mode=mode)

    def f(em, mats, normals, weights):
        asked = []

        def port_indirect(*args, **kwargs):
            tr, rgb = indirect[len(asked)]
            asked.append(args[9])
            return jnp.asarray(tr), jnp.asarray(rgb)

        monkeypatch.setattr(JP, "compute_indirect_radiance", port_indirect)
        params = dict(s["jp"], emitter=em)
        out = JP.pbr_forward(
            jm, params, s["js"], s["jframe"], s["jcond"], s["jocc"],
            jm._schedules(STEP), a["rays_o"], a["rays_d"], a["t_starts"],
            a["t_ends"], a["smask"], weights, None, a["sdf"], mats, normals,
            key, STEP, flags, a["bg"], 0)
        return _scalar(out, a["cw"]), asked

    (val, asked), grads = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1, 2, 3), has_aux=True))(
        s["jp"]["emitter"], a["mats"], a["normals"], a["weights"])
    monkeypatch.undo()
    return float(val), jax.tree.map(np.asarray, grads), \
        [np.asarray(d) for d in asked]


@pytest.mark.parametrize("mode", ["light", "mats", "mis"])
def test_sampled_mode_training_gradients_match_jax(stage, mode,
                                                   monkeypatch):
    """``pbr_forward`` in ``mode`` under training flags: the scalar and its
    gradients with respect to the emitter's parameters, the material maps,
    the normals and the weights, against JAX's from the same draws and the
    same secondary-pass outputs, whose directions JAX asks for as the port
    does (one pass, two in ``mis``); some secondary rays met the body
    (a transmittance below 1) and every gradient is nonzero."""
    s = stage
    key = jax.random.PRNGKey(7)
    model = s["model"]
    model.zero_grad(set_to_none=True)
    t = {k: torch.as_tensor(v) for k, v in s["a"].items()}
    leaves = {k: t[k].clone().requires_grad_()
              for k in ("mats", "normals", "weights")}
    counters, calls = {}, []
    port_indirect = TP.compute_indirect_radiance

    def recorded(*args, **kwargs):
        tr, rgb = port_indirect(*args, **kwargs)
        calls.append((args[8].numpy(), tr.numpy(), rgb.numpy()))
        return tr, rgb

    monkeypatch.setattr(TP, "compute_indirect_radiance", recorded)
    flags = RenderFlags(training=True, enable_phys=True,
                        importance_sample=True, randomized=True,
                        render_mode=mode)
    out = TP.pbr_forward(
        model, s["statics"], s["frame"], s["cond"], s["occ"],
        model.schedules(STEP, "cpu"), t["rays_o"], t["rays_d"],
        t["t_starts"], t["t_ends"], t["smask"], leaves["weights"], t["sdf"],
        leaves["mats"], leaves["normals"], STEP, flags, t["bg"], 0,
        draws=RS.pbr_draws(key, mode, R, SPP), counters=counters)
    loss = _scalar(out, t["cw"])
    loss.backward()
    monkeypatch.undo()
    assert len(calls) == (2 if mode == "mis" else 1)
    assert int(counters["sec_valid_samples"]) > 0
    assert min(float(tr.min()) for _, tr, _ in calls) < 1.0

    ref, (g_em, g_mats, g_nrm, g_w), asked = _jax_stage(
        s, mode, key, [c[1:] for c in calls], monkeypatch)
    assert len(asked) == len(calls)
    for d, (dirs, _, _) in zip(asked, calls):
        np.testing.assert_allclose(dirs, d, rtol=0, atol=DIR_TOL)
    assert float(loss.detach()) == pytest.approx(ref, rel=LOSS_RTOL)
    got = to_jax_tree(model, grads=True)["emitter"]
    pairs = [(f"emitter.{k}", got[k], g_em[k]) for k in g_em]
    pairs += [(k, leaves[k].grad.numpy(), g)
              for k, g in (("mats", g_mats), ("normals", g_nrm),
                           ("weights", g_w))]
    for name, a, b in pairs:
        ref_norm = np.linalg.norm(b)
        assert ref_norm > 0, name
        assert np.linalg.norm(np.asarray(a) - b) <= GRAD_RTOL * ref_norm, \
            (name, np.linalg.norm(np.asarray(a) - b), ref_norm)
