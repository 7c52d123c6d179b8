"""The port's render slice as a whole against the JAX package: the same
tiny config and parameters in both, the eval-mode forward on one occupancy
grid, then ``render_frame`` end to end with the test-grid jitter injected."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from intrinsicavatar_tpu.render.occupancy import make_occ_grid
from intrinsicavatar_tpu.render.renderer import IntrinsicAvatar as JModel
from intrinsicavatar_tpu.render.renderer import RenderFlags as JFlags
from intrinsicavatar_tpu.train import evaluate as JE
from intrinsicavatar_tpu.utils.config import merge as jmerge
from intrinsicavatar_tpu.utils.default_config import tiny_config as jtiny
from intrinsicavatar_tpu_torch.render.occupancy import OccGridState
from intrinsicavatar_tpu_torch.render.renderer import IntrinsicAvatar
from intrinsicavatar_tpu_torch.train import evaluate as TE
from intrinsicavatar_tpu_torch.utils.config import merge
from intrinsicavatar_tpu_torch.utils.default_config import tiny_config
from intrinsicavatar_tpu_torch.weights import from_jax_params


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Tier-1 runs six test workers on one host: keep each worker's torch
    pool small so it does not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


STEP = 5000          # radiance regime: importance rounds on, PBR off
RES = 16             # test-grid resolution (64 in serving)
CHUNK = 128
OVERRIDES = {"model": {"primary_dtype": "float32", "eval_seed_grid": False}}
KEYS = ("comp_rgb_full", "opacity", "depth", "comp_normal")
# f32 on both sides; 1e-4 leaves room for rounding through the importance
# rounds.  A ray beyond it would come from a discrete branch taken apart:
# a Broyden lane converging at another step, another argmin among
# candidates, or another budget cut (the counters compare the budgets).
TOL, MIN_FRACTION = 1e-4, 0.99


@pytest.fixture(scope="module")
def setup():
    jcfg = jmerge(jtiny(), OVERRIDES)
    cfg = merge(tiny_config(), OVERRIDES)
    jm = JModel(jcfg.model)
    js = jm.initialize(np.zeros(10))
    jp = jm.init(jax.random.PRNGKey(0))
    model = IntrinsicAvatar(cfg.model)
    statics = model.initialize(np.zeros(10))
    from_jax_params(model, jax.tree.map(np.asarray, jp))
    rng = np.random.default_rng(1)
    R = 256
    target = np.array([0.0, 0.3, 2.0]) + rng.normal(scale=0.2, size=(R, 3))
    d = (target / np.linalg.norm(target, axis=-1, keepdims=True))
    rays = np.concatenate([np.zeros((R, 3)), d, np.full((R, 1), 1.0),
                           np.full((R, 1), 3.0)], -1).astype(np.float32)
    batch = {"index": np.asarray([0]), "betas": np.zeros(10, np.float32),
             "body_pose": (rng.normal(size=69) * 0.2).astype(np.float32),
             "global_orient": np.zeros(3, np.float32),
             "transl": np.asarray([0.0, 0.3, 2.0], np.float32), "rays": rays}
    return dict(cfg=cfg, jm=jm, js=js, jp=jp, model=model, statics=statics,
                batch=batch, rng=rng,
                system=types.SimpleNamespace(model=jm, statics=js))


def _jflags():
    return JFlags(training=False, enable_phys=False, importance_sample=True,
                  randomized=False)


def _compare(jo, to, tol=TOL, min_fraction=MIN_FRACTION, worst=None):
    for k in KEYS:
        err = np.abs(np.asarray(jo[k]) - to[k]).max(-1)
        if worst is not None:
            assert float(err.max()) <= worst, (k, float(err.max()))
        frac = float(np.mean(err < tol))
        assert frac >= min_fraction, (
            f"{k}: {frac:.4f} of rays within {tol}; the others took a "
            f"discrete branch apart (Broyden convergence step, candidate "
            f"argmin or budget), max error {err.max():.3g}")
    assert {k: int(v) for k, v in to["counters"].items()} == \
        {k: int(v) for k, v in jo["counters"].items()}
    assert to["counters"]["ovf_broyden_phase2"] == 0


def test_flags_match_jax_system(setup):
    from intrinsicavatar_tpu.train.system import IntrinsicAvatarSystem
    jcfg = jmerge(jtiny(), OVERRIDES)
    jf = IntrinsicAvatarSystem(jcfg).flags_for_step(STEP, training=False)
    tf = TE.eval_flags(setup["cfg"].model, STEP)
    for name in ("training", "enable_phys", "importance_sample",
                 "randomized", "full_budget", "budget_boost"):
        assert getattr(tf, name) == getattr(jf, name), name


def _models(s, dtype):
    """The JAX system and the port's model and statics of ``setup``, or both
    again with the primary shading pass at ``dtype`` (the same
    parameters)."""
    if dtype == "float32":
        return s["system"], s["model"], s["statics"]
    over = {"model": {"primary_dtype": dtype}}
    jm = JModel(jmerge(jmerge(jtiny(), OVERRIDES), over).model)
    js = jm.initialize(np.zeros(10))
    model = IntrinsicAvatar(merge(s["cfg"], over).model)
    statics = model.initialize(np.zeros(10))
    from_jax_params(model, jax.tree.map(np.asarray, s["jp"]))
    return types.SimpleNamespace(model=jm, statics=js), model, statics


# at JAX's default bf16 primary pass both sides round the same operands and
# sum in float32 in other orders, where a bf16 operand's rounding can flip:
# the float32 bulk tolerance, and every ray within 5e-4 (measured: every
# ray within 8.6e-5, the normal's worst; the bf16 and float32 renders of
# the port differ by up to 1.2e-3, so the bound tells the scopes apart)
BF16_WORST = 5e-4


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_jax(setup, dtype):
    """One given occupancy grid; the chunked forward of both packages, with
    the primary shading pass at float32 (the exact path) and at JAX's
    default bf16 scope."""
    s = setup
    system, model, statics = _models(s, dtype)
    binaries = s["rng"].random((RES, RES, RES)) < 0.7
    aabb = np.asarray(s["cfg"].model.scene_aabb, np.float32)
    jocc = make_occ_grid(aabb[None], RES)._replace(
        binaries=jnp.asarray(binaries)[None])
    jb = {k: jnp.asarray(v) for k, v in s["batch"].items()}
    jframe, jcond = system.model.prepare(s["jp"], system.statics, jb, STEP)
    jo = JE.render_frame(system, s["jp"], jb, STEP,
                         jax.random.PRNGKey(2), _jflags(), ray_chunk=CHUNK,
                         occ=jocc, frame=jframe, cond=jcond)
    tb = TE.batch_to_device(s["batch"], "cpu")
    frame, cond = model.prepare(statics, tb, STEP)
    occ = OccGridState(torch.zeros(1, RES ** 3),
                       torch.as_tensor(binaries)[None],
                       torch.as_tensor(aabb)[None])
    to = TE.render_frame(model, statics, tb, STEP,
                         TE.eval_flags(model.config, STEP),
                         ray_chunk=CHUNK, occ=occ, frame=frame, cond=cond)
    assert float(np.mean(to["opacity"] > 0.5)) > 0.2
    _compare(jo, to, worst=None if dtype == "float32" else BF16_WORST)


def test_render_frame_matches_jax(setup):
    """End to end: each side builds its own test grid from the same
    jitter (the draws ``render_frame`` of the JAX package makes)."""
    s = setup
    key = jax.random.PRNGKey(7)
    _, k_occ = jax.random.split(key)
    jitter = np.array(jax.random.uniform(k_occ, (RES ** 3, 3, 3)))
    jb = {k: jnp.asarray(v) for k, v in s["batch"].items()}
    jocc, jframe, jcond = JE.build_test_occ_grid(s["system"], s["jp"], jb,
                                                 STEP, k_occ, resolution=RES)
    jo = JE.render_frame(s["system"], s["jp"], jb, STEP, key, _jflags(),
                         ray_chunk=CHUNK, occ=jocc, frame=jframe, cond=jcond)
    tb = TE.batch_to_device(s["batch"], "cpu")
    to = TE.render_frame(s["model"], s["statics"], tb, STEP,
                         TE.eval_flags(s["cfg"].model, STEP),
                         ray_chunk=CHUNK, occ_resolution=RES,
                         occ_jitter=torch.as_tensor(jitter))
    tocc, _, _ = TE.build_test_occ_grid(s["model"], s["statics"], tb, STEP,
                                        resolution=RES,
                                        jitter=torch.as_tensor(jitter))
    np.testing.assert_array_equal(tocc.binaries.numpy(),
                                  np.asarray(jocc.binaries))
    np.testing.assert_allclose(tocc.aabbs.numpy(), np.asarray(jocc.aabbs),
                               atol=1e-5)
    _compare(jo, to)
    psnr = TE.frame_metrics(to, {"rgb": np.ones((256, 3), np.float32)})
    assert np.isfinite(psnr["psnr"])


def test_no_quiet_cpu_fallback(monkeypatch):
    from intrinsicavatar_tpu_torch.utils.device import resolve_device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        resolve_device()
    assert resolve_device("cpu").type == "cpu"
