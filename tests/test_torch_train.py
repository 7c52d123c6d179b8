"""The port's training slice against the JAX package's: schedules, the Adam
groups, the losses, the occupancy update, one train step (losses and every
gradient, leaf by leaf), one step accumulated over two microbatches
(``trainer.grad_accum``, against ``_train_step_accum``) and five steps of
``fit``, from the same tiny config, parameters and batch, with the JAX key
path's draws injected into the port.

One JAX system is shared by the module: its jitted sampling, occupancy and
train steps compile once (the bulk of this file's time)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from intrinsicavatar_tpu.ops.math import linear_to_srgb as j_srgb
from intrinsicavatar_tpu.render.occupancy import (
    make_occ_grid as j_make_occ, update_occ_grid as j_update_occ,
)
from intrinsicavatar_tpu.render.renderer import IntrinsicAvatar as JModel
from intrinsicavatar_tpu.train import schedules as JS
from intrinsicavatar_tpu.train.optim import make_optimizer as j_make_opt
from intrinsicavatar_tpu.train.system import IntrinsicAvatarSystem as JSystem
from intrinsicavatar_tpu.utils.config import merge as jmerge
from intrinsicavatar_tpu.utils.default_config import tiny_config as jtiny
from intrinsicavatar_tpu_torch.anim.deformer import FastSNARF
from intrinsicavatar_tpu_torch.data.synthetic import SyntheticDataset
from intrinsicavatar_tpu_torch.ops.compact import compact_apply
from intrinsicavatar_tpu_torch.render import occupancy as TO
from intrinsicavatar_tpu_torch.train import schedules as TS
from intrinsicavatar_tpu_torch.train.system import IntrinsicAvatarSystem
from intrinsicavatar_tpu_torch.utils.config import merge, wrap
from intrinsicavatar_tpu_torch.utils.default_config import tiny_config
from intrinsicavatar_tpu_torch.weights import (
    flatten_tree, port_key, to_jax_tree,
)


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Tier-1 runs six test workers on one host: keep each worker's torch
    pool small so it does not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


OVERRIDES = {"model": {"primary_dtype": "float32", "eval_seed_grid": False},
             "dataset": {"name": "synthetic", "n_rays": 64, "n_frames": 2}}
STEP = 2000          # importance rounds on, curvature on a 25% subsample
RES = 16             # the tiny config's occupancy grid
# f32 on both sides; sums reassociate (the table cotangents are aggregated
# in another order).  Beyond rounding, a discrete branch may be taken apart:
# a canonical point within rounding of a hash cell's face takes the other
# cell's derivative (the SDF gradient jumps there; one shading sample of
# ~3,000 in this step), which moves the eikonal loss by ~1e-4 and each
# leaf's gradient by up to ~1% of its norm.  Gradients: each leaf within 2%
# of its norm; losses 1e-3 relative.
GRAD_RTOL, LOSS_RTOL, FIT_LOSS_RTOL = 2e-2, 1e-3, 1e-3
# the curvature proxy is arccos of a dot product close to 1: its f32
# rounding moves each sample's angle, and so the mean, further
CURV_RTOL = 2e-3
LOSS_KEYS = ("rgb_l1", "rgb_mse", "eikonal", "mask_bce", "mask_mse",
             "opaque", "sparsity", "curvature", "lipshitz_bound", "beta",
             "total", "shading_valid_samples")


@pytest.fixture(scope="module")
def setup():
    jcfg = jmerge(jtiny(), OVERRIDES)
    cfg = merge(tiny_config(), OVERRIDES)
    jsys = JSystem(jcfg)
    state = jsys.setup(np.zeros(10), jax.random.PRNGKey(0))
    # noise on the SDF MLP's rows of the hash features (zero at the sphere
    # init) gives the geometry table a gradient from the first step; a
    # rough geometry table makes the curvature proxy's angles large enough
    # that their f32 rounding does not swamp their gradient (near a sphere
    # the proxy is arccos of a dot within ~1e-6 of 1)
    tree = jax.tree.map(np.array, state.params)
    rng = np.random.default_rng(0)
    v = tree["geometry"]["mlp"][0]["v"]
    v[3:] += rng.normal(scale=0.05, size=v[3:].shape).astype(np.float32)
    tree["geometry"]["table"] += rng.uniform(
        -0.02, 0.02, tree["geometry"]["table"].shape).astype(np.float32)
    state = state._replace(params=jax.tree.map(jnp.asarray, tree),
                           step=jnp.asarray(STEP, jnp.int32))
    batch = SyntheticDataset(cfg.dataset)[0]
    t_idx = batch.pop("t_idx")
    return dict(jsys=jsys, state=state, tree=tree, cfg=cfg, batch=batch,
                jbatch={k: jnp.asarray(v) for k, v in batch.items()},
                t_idx=t_idx)


def _port(setup, cfg=None):
    sys_ = IntrinsicAvatarSystem(cfg or setup["cfg"], "cpu")
    sys_.setup(np.zeros(10), setup["tree"])
    sys_.step = STEP
    return sys_


class JaxDraws:
    """The draws of the JAX system's key path from ``state.rng``: the
    occupancy update splits first (`train/system.py:555`), then each step
    ``rng, k_bg, k_fwd = split(rng, 3)`` (`:324`), ``k_strat, k_lap, ... =
    split(k_fwd, 4)`` (`render/renderer.py:508`), ``k_sub, k_lap =
    split(k_lap)`` (`:639`)."""

    def __init__(self, rng, n_rays, n_samples):
        self.rng, self.R = rng, n_rays
        self.nq = n_rays * n_samples           # no shading compaction here
        self.nsub = min(max(int(np.ceil(self.nq * 0.25 / 128.0)) * 128, 128),
                        self.nq)

    def __call__(self, step):
        d = {}
        if step % 20 == 0:
            self.rng, k_occ = jax.random.split(self.rng)
            d["occ_u"] = jax.random.uniform(k_occ, (RES ** 3, 1, 3))
        self.rng, k_bg, k_fwd = jax.random.split(self.rng, 3)
        k_strat, k_lap, _, _ = jax.random.split(k_fwd, 4)
        k_sub, k_lap = jax.random.split(k_lap)
        d.update(bg=jax.random.uniform(k_bg, (3,)),
                 strat_u=jax.random.uniform(k_strat, (self.R,)),
                 lap_sub=jax.random.randint(k_sub, (self.nsub,), 0, self.nq),
                 lap_u=jax.random.uniform(k_lap, (self.nsub, 3)))
        d["k_fwd"] = k_fwd
        return {k: (v if k == "k_fwd" else np.asarray(v))
                for k, v in d.items()}


def _assert_tree_close(port_tree, jax_tree, rtol, atol=0.0, what=""):
    a, b = flatten_tree(port_tree), flatten_tree(jax.tree.map(np.asarray,
                                                              jax_tree))
    assert set(a) == set(b)
    for k in sorted(b):
        err = np.linalg.norm(a[k] - b[k])
        assert err <= rtol * np.linalg.norm(b[k]) + atol * np.sqrt(
            b[k].size) + 1e-30, (what, k, err, np.linalg.norm(b[k]))


def test_schedules_match_jax():
    specs = (0.1, [1.5, 0.0, 12500], [12500, 1e-5, 1e-5, 12501],
             [100, 1.0, 0.0, 200])
    for step in (0, 50, 100, 150, 12499, 12500, 12501, 20000):
        for spec in specs:
            # the port's step is a Python int: one function serves as
            # both of JAX's (traced and trace-time)
            assert TS.C(spec, step) == pytest.approx(float(JS.C(spec, step)),
                                                     rel=1e-6)
            assert TS.C(spec, step) == JS.C_static(spec, step)
        ref = float(JS.lr_schedule(step, 1e-3))
        assert TS.lr_schedule(step, 1e-3) == pytest.approx(ref, rel=1e-6)
    cfg = tiny_config().system
    for step in (0, 999, 13000, 24000):
        assert TS.lr_schedule_host(step, cfg) == pytest.approx(
            JS.lr_schedule_host(step, jtiny().system), rel=1e-12)



def test_to_jax_tree_copies_the_parameters():
    """The arrays that ``to_jax_tree`` returns are copies: an in-place
    update of the model (an optimizer step) changes neither them nor a JAX
    array made from them.  JAX on the CPU may take a numpy array's buffer
    as its own, so a shared buffer let ``test_adam_groups_match_optax``'s
    torch step overwrite the parameters that JAX's update, dispatched
    asynchronously, had not read yet: under the six test workers it
    failed."""
    class Net(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.lin = torch.nn.Linear(64, 64)

    model = Net()
    tree = to_jax_tree(model)
    j = jnp.asarray(tree["lin"]["weight"])
    before = np.array(j)
    with torch.no_grad():
        model.lin.weight += 1.0
    np.testing.assert_array_equal(np.asarray(j), before)
    np.testing.assert_array_equal(tree["lin"]["weight"], before)

def test_adam_groups_match_optax(setup):
    """Two Adam updates with the configured groups (pose correction at
    lr 1e-4 and decay 1e-5, the radiance table at decay 1e-4) against the
    JAX optax chain, on the same random gradients."""
    sys_ = _port(setup)
    model = sys_.model
    tree = to_jax_tree(model)
    scfg = setup["jsys"].config.system
    tx = j_make_opt(tree, scfg.optimizer, scfg.scheduler, scfg.warmup_steps)
    params = jax.tree.map(jnp.asarray, tree)
    opt_state = tx.init(params)
    # under jit: op by op, the first update compiles each leaf's ops (~13 s
    # on a CPU)
    update = jax.jit(tx.update)
    rng = np.random.default_rng(1)
    names = dict(model.named_parameters())
    for _ in range(2):
        grads = jax.tree.map(lambda p: jnp.asarray(rng.normal(
            size=p.shape).astype(np.float32)), params)
        flat_g = flatten_tree(jax.tree.map(np.asarray, grads))
        for key, g in flat_g.items():
            if port_key(key) in names:
                names[port_key(key)].grad = torch.as_tensor(g)
        updates, opt_state = update(grads, opt_state, params)
        params = jax.tree.map(lambda p, u: p + u, params, updates)
        sys_.optimizer.step()
        sys_.scheduler.step()
    ref = flatten_tree(jax.tree.map(np.asarray, params))
    for name, p in names.items():
        key = name.replace(".mlp.layers.", ".mlp.")
        np.testing.assert_allclose(p.detach().numpy(), ref[key], rtol=1e-6,
                                   atol=1e-9, err_msg=key)
    groups = {g["name"]: g for g in sys_.optimizer.param_groups}
    assert groups["radiance.table"]["weight_decay"] == 1e-4
    # the rate after two updates: the group's 1e-4 times the warmup's
    # factor at step 2
    assert groups["pose_correction"]["lr"] == pytest.approx(
        1e-4 * (0.01 + 0.99 * 2 / 1000))


def test_compute_losses_match_jax(setup):
    """Every radiance-regime term on one given ``out`` (distortion on)."""
    over = {"system": {"loss": {"lambda_distortion": 0.01,
                                "lambda_sparsity": 0.1}}}
    jsys = JSystem(jmerge(jmerge(jtiny(), OVERRIDES), over))
    sys_ = _port(setup, merge(setup["cfg"], over))
    rng = np.random.default_rng(2)
    R, S, n = 32, 24, 128
    smask = rng.random((R, S)) < 0.7
    out = {"rays_valid": rng.random((R, 1)) < 0.8,
           "comp_rgb_full": rng.random((R, 3)).astype(np.float32),
           "sample_mask": smask,
           "sdf_grad_samples": rng.normal(size=(R * S, 3)).astype(np.float32),
           "opacity": rng.random((R, 1)).astype(np.float32),
           "sdf_samples": rng.normal(size=(R * S,)).astype(np.float32),
           "sdf_laplace_samples": rng.random(n).astype(np.float32),
           "laplace_mask": rng.random(n) < 0.6,
           "points": np.cumsum(rng.random((R, S)), -1).astype(np.float32),
           "intervals": rng.random((R, S)).astype(np.float32) * 0.1,
           "weights": rng.random((R, S)).astype(np.float32) * 0.1,
           "beta": np.float32(0.2)}
    batch = {"rgb": rng.random((R, 3)).astype(np.float32),
             "alpha": (rng.random(R) < 0.5).astype(np.float32)}
    flags = jsys.flags_for_step(STEP)
    _, ref = jsys.compute_losses(setup["state"].params,
                                 {k: jnp.asarray(v) for k, v in out.items()},
                                 {k: jnp.asarray(v) for k, v in batch.items()},
                                 STEP, flags)
    _, got = sys_.compute_losses({k: torch.as_tensor(v)
                                  for k, v in out.items()},
                                 {k: torch.as_tensor(v)
                                  for k, v in batch.items()},
                                 STEP, sys_.flags_for_step(STEP))
    assert set(got) == set(ref)
    for k in ref:
        assert float(got[k]) == pytest.approx(float(ref[k]), rel=1e-5), k


def test_update_occ_grid_matches_jax():
    """The EMA-max update, pooling, threshold and largest component on one
    level, from the same jitter and alpha field."""
    aabb = np.asarray([[-1.0, -1.2, -1.0, 1.0, 0.8, 1.0]], np.float32)
    key = jax.random.PRNGKey(3)
    jitter = np.asarray(jax.random.uniform(key, (RES ** 3, 1, 3)))

    def alpha(x, xp):
        # a blob plus a floater: the component filter keeps the blob
        d1 = xp.sum((x - xp.asarray([0.2, 0.0, 0.1])) ** 2, -1)
        d2 = xp.sum((x - xp.asarray([-0.8, 0.6, -0.8])) ** 2, -1)
        return xp.exp(-d1 * 8.0) + 0.5 * (d2 < 0.02)

    js = j_make_occ(aabb, RES)
    ts = TO.make_occ_grid(aabb, RES)
    for _ in range(2):
        js = j_update_occ(js, 0, lambda x: alpha(x, jnp), key)
        ts = TO.update_occ_grid(ts, 0, lambda x: alpha(x, torch),
                                torch.as_tensor(jitter))
    np.testing.assert_allclose(ts.occs.numpy(), np.asarray(js.occs),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(ts.binaries.numpy(), np.asarray(js.binaries))
    assert 0 < int(ts.binaries.sum()) < RES ** 3


def _jax_grads(jsys, state, jb, t_idx, draws, model=None):
    """The body of the JAX ``train_step_impl`` (`train/system.py:324-355`)
    with its gradients returned; ``model`` (default ``jsys.model``)
    renders."""
    model = model or jsys.model
    flags = jsys.flags_for_step(int(state.step))
    intervals, _, _ = jsys.sample_step(state, jb, t_idx, flags)
    bg = jnp.asarray(draws["bg"])
    fg = jb["alpha"][..., None]
    jb = {**jb, "rgb_wo_mask": jb["rgb"],
          "rgb": jb["rgb"] * fg + j_srgb(bg)[None, :] * (1.0 - fg)}

    def loss_fn(params):
        frame, cond = model.prepare(params, jsys.statics, jb, state.step)
        out = model.forward(
            params, jsys.statics, frame, cond, state.occ, jb["rays"],
            draws["k_fwd"], state.step, flags, t_idx=t_idx,
            background_color=bg, intervals=intervals)
        return jsys.compute_losses(params, out, jb, state.step, flags)

    (_, losses), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        state.params)
    # under jit: op by op, the first update compiles each leaf's ops
    updates, _ = jax.jit(jsys.tx.update)(grads, state.opt_state,
                                         state.params)
    new = jax.tree.map(lambda p, u: p + u, state.params, updates)
    return losses, grads, new


# at JAX's default bf16 primary pass (the shading query, the curvature
# proxy and the radiance head in the scope; the fused op's backward in
# float32 and the radiance MLP's cotangents rounded to bf16 at the casts, on
# both sides) the float32 case's tolerances hold as they are: measured, the
# losses within 1.2e-4 relative (the curvature 2.2e-4), each leaf's
# gradient within 0.71% of its norm (the geometry table; the float32 case
# 0.92%), where the bf16 and float32 steps differ by up to 6.0% (JAX and
# port alike), so the bound tells the scopes apart
BF16_OVERRIDES = {"model": {"primary_dtype": "bfloat16"}}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_step_matches_jax(setup, dtype):
    """One occupancy update and one train step at step 2000: the losses,
    every parameter's gradient and the updated parameters, with the
    primary shading pass at float32 (the exact path) and at JAX's default
    bf16 scope."""
    jsys, state, t_idx = setup["jsys"], setup["state"], setup["t_idx"]
    cfg = jmodel = None
    if dtype == "bfloat16":
        # the bf16 model renders; the occupancy update and the importance
        # rounds (float32 in both scopes) keep the module's compiles
        jmodel = JModel(jmerge(jmerge(jtiny(), OVERRIDES),
                               BF16_OVERRIDES).model)
        jmodel.initialize(np.zeros(10))
        cfg = merge(setup["cfg"], BF16_OVERRIDES)
    draws_fn = JaxDraws(state.rng, 64, 48)
    draws = draws_fn(STEP)
    state = jsys.occ_update_step(state, setup["jbatch"], t_idx)
    assert np.array_equal(np.asarray(draws_fn.rng), np.asarray(
        jax.random.split(state.rng, 3)[0]))
    ref_losses, ref_grads, ref_new = _jax_grads(jsys, state, setup["jbatch"],
                                                t_idx, draws, jmodel)
    sys_ = _port(setup, cfg)
    batch = sys_.to_device(setup["batch"])
    sys_.occ_update_step(batch, t_idx, draws)
    np.testing.assert_array_equal(sys_.occ.binaries.numpy(),
                                  np.asarray(state.occ.binaries))
    losses = sys_.train_step(batch, t_idx, sys_.flags_for_step(STEP), draws)
    for k in LOSS_KEYS:
        assert float(losses[k]) == pytest.approx(
            float(ref_losses[k]), rel=CURV_RTOL if k == "curvature"
            else LOSS_RTOL), k
    grads = to_jax_tree(sys_.model, grads=True)
    _assert_tree_close(grads, ref_grads, GRAD_RTOL, what="grad")
    assert np.linalg.norm(grads["geometry"]["table"]) > 0
    # Adam's eps of 1e-15 turns rounding-level gradients into steps of
    # the rate (1e-5 at the optimizer's first step): within 2 lr per entry
    _assert_tree_close(to_jax_tree(sys_.model), ref_new, 0.0, atol=2e-5,
                       what="params")


def test_fit_tracks_jax(setup):
    """Five ``fit`` steps from step 2000, with the occupancy update of step
    2000, against the JAX ``fit`` on the same batch: the losses of every
    step and the parameters after the last."""
    jsys, state, t_idx = setup["jsys"], setup["state"], setup["t_idx"]

    def data(b):
        while True:
            yield b, t_idx

    n = 5
    draws_fn = JaxDraws(state.rng, 64, 48)
    end, ref_hist = jsys.fit(data(setup["jbatch"]), state, STEP + n,
                             log_every=1, prefetch=False)
    sys_ = _port(setup)
    hist = sys_.fit(data(setup["batch"]), STEP + n, log_every=1,
                    draws_fn=draws_fn)
    assert [s for s, _ in hist] == [s for s, _ in ref_hist] \
        == list(range(STEP, STEP + n))
    for (_, got), (_, ref) in zip(hist, ref_hist):
        counters = [k for k in ref if k.startswith(("ovf_", "shading_"))]
        for k in LOSS_KEYS + ("lr", *counters):
            assert got[k] == pytest.approx(ref[k], rel=FIT_LOSS_RTOL), k
    assert sys_.step == int(end.step)
    # within 2 lr per step and entry (Adam's eps, as above)
    _assert_tree_close(to_jax_tree(sys_.model), end.params, 0.0,
                       atol=2 * n * 1e-5, what="params")


def _grad_out_tx():
    """An optax transform whose state after an update is the gradient."""
    def init(params):
        return jax.tree.map(jnp.zeros_like, params)

    def update(grads, state, params=None):
        return jax.tree.map(jnp.zeros_like, grads), grads

    return optax.GradientTransformation(init, update)


def _accum_draws(rng, n_rays, n_micro, n_samples):
    """The draws of an accumulated step from ``rng`` (`train/system.py:
    502-508`): ``rng, k_bg, k_fwd = split(rng, 3)``, the sampling stage's
    ``k_strat`` from ``k_fwd`` (`:376-377`), and each microbatch's forward
    draws from its key of ``split(k_fwd, n)`` (its curvature subsample's
    ``k_sub, k_lap``, as a step's), under ``draws["micro"]``."""
    _, k_bg, k_fwd = jax.random.split(rng, 3)
    nq = n_rays // n_micro * n_samples     # no shading compaction here
    nsub = min(max(int(np.ceil(nq * 0.25 / 128.0)) * 128, 128), nq)
    micro = []
    for key in jax.random.split(k_fwd, n_micro):
        k_sub, k_lap = jax.random.split(jax.random.split(key, 4)[1])
        micro.append({
            "lap_sub": np.asarray(jax.random.randint(k_sub, (nsub,), 0, nq)),
            "lap_u": np.asarray(jax.random.uniform(k_lap, (nsub, 3)))})
    return {"bg": np.asarray(jax.random.uniform(k_bg, (3,))),
            "strat_u": np.asarray(jax.random.uniform(
                jax.random.split(k_fwd, 4)[0], (n_rays,))),
            "micro": micro}


def test_accumulated_step_matches_jax(setup):
    """One step at step 2000 with ``trainer.grad_accum: 2`` (2 x 32 rays)
    against the JAX package's ``_train_step_accum``: the losses (each the
    mean over the microbatches), every gradient (read out of the JAX step
    by an optax transform whose state is the gradient it was given) and
    the parameters after JAX's Adam on that gradient."""
    jsys, state, t_idx = setup["jsys"], setup["state"], setup["t_idx"]
    flags = jsys.flags_for_step(STEP)
    intervals, s_counters, _ = jsys.sample_step(state, setup["jbatch"],
                                                t_idx, flags)
    adam = jsys.tx
    jsys.tx = _grad_out_tx()
    try:
        out, ref = jsys._train_step_accum(
            state._replace(opt_state=jsys.tx.init(state.params)),
            setup["jbatch"], t_idx, flags, intervals, 2)
    finally:
        jsys.tx = adam
    ref = dict(ref)
    for k, v in s_counters.items():
        ref[k] = ref[k] + v if k in ref else v
    ref_grads = out.opt_state
    updates, _ = jax.jit(adam.update)(ref_grads, state.opt_state,
                                      state.params)
    ref_new = jax.tree.map(lambda p, u: p + u, state.params, updates)

    sys_ = _port(setup, merge(setup["cfg"], {"trainer": {"grad_accum": 2}}))
    assert sys_.grad_accum == 2
    losses = sys_.train_step(sys_.to_device(setup["batch"]), t_idx,
                             sys_.flags_for_step(STEP),
                             _accum_draws(state.rng, 64, 2, 48))
    for k in LOSS_KEYS:
        assert float(losses[k]) == pytest.approx(
            float(ref[k]), rel=CURV_RTOL if k == "curvature"
            else LOSS_RTOL), k
    assert sys_.step == STEP + 1
    grads = to_jax_tree(sys_.model, grads=True)
    _assert_tree_close(grads, ref_grads, GRAD_RTOL, what="grad")
    assert np.linalg.norm(grads["geometry"]["table"]) > 0
    # within 2 lr per entry (Adam's eps, as test_train_step_matches_jax)
    _assert_tree_close(to_jax_tree(sys_.model), ref_new, 0.0, atol=2e-5,
                       what="params")


def test_indivisible_batch_takes_the_monolithic_step(setup):
    """With the rays not divisible by ``grad_accum`` the system runs the
    monolithic step: the same losses and gradients, bit for bit, as
    ``grad_accum: 1`` from the same generator."""
    batch = {k: (v[:63] if k in ("rays", "rgb", "alpha") else v)
             for k, v in setup["batch"].items()}
    runs = []
    for n in (1, 2):
        sys_ = _port(setup, merge(setup["cfg"], {"trainer": {"grad_accum":
                                                             n}}))
        sys_.generator = torch.Generator().manual_seed(5)
        losses = sys_.train_step(sys_.to_device(batch), setup["t_idx"],
                                 sys_.flags_for_step(STEP))
        runs.append((losses, flatten_tree(to_jax_tree(sys_.model,
                                                      grads=True))))
    (l1, g1), (l2, g2) = runs
    assert set(l1) == set(l2) and set(g1) == set(g2)
    for k in l1:
        assert torch.equal(l1[k], l2[k]), k
    for k in g1:
        np.testing.assert_array_equal(g1[k], g2[k], err_msg=k)


def test_step0_regime_trains():
    """The first regime of a run (full budgets, no importance rounds, 4 of
    8 levels, curvature on every shading lane's subsample): finite losses,
    and every trainable leaf that the radiance regime reads gets a
    gradient: all but the pose correction, the emitter and the material
    head (the PBR stage is off; the head's Lipschitz bounds enter the loss
    with a weight of 0 before step 12,500)."""
    cfg = merge(tiny_config(), OVERRIDES)
    sys_ = IntrinsicAvatarSystem(cfg, "cpu").setup(np.zeros(10))
    flags = sys_.flags_for_step(0)
    assert flags.full_budget and not flags.importance_sample \
        and flags.with_curvature_loss
    ds = SyntheticDataset(cfg.dataset)
    hist = sys_.fit(ds.train_iter(), 2, log_every=1)
    assert all(np.isfinite(s["total"]) for _, s in hist)
    for name, p in sys_.model.named_parameters():
        if name.startswith("material.") and name.endswith(".c"):
            assert p.grad is not None, name
        elif name.startswith(("pose_correction", "emitter.", "material.")):
            assert p.grad is None, name
        else:
            assert p.grad is not None and float(p.grad.abs().sum()) > 0, name
    mask = sys_.model.geometry.level_mask(0, "cpu")
    assert int(mask.sum()) == 4 * 2


def test_gradients_pass_compaction_and_candidate_reduce():
    """``scatter_compacted`` (an ``index_put_``) and the min-SDF gather of
    the deformer's candidate reduce carry gradients to the compacted
    inputs."""
    rng = np.random.default_rng(4)
    pts = torch.tensor(rng.normal(size=(40, 3)), dtype=torch.float32,
                       requires_grad=True)
    mask = torch.as_tensor(rng.random(40) < 0.5)
    out, = compact_apply(lambda p: (p ** 2).sum(-1), pts, mask, 12, [7.0])
    (g,) = torch.autograd.grad(out.sum(), pts)
    idx = torch.nonzero(mask)[:12, 0]
    expect = torch.zeros_like(pts)
    expect[idx] = 2 * pts.detach()[idx]
    torch.testing.assert_close(g, expect)
    assert float(out[~mask].min()) == 7.0

    rigid = FastSNARF(wrap({"name": "fast-snarf", "model_path": "synthetic",
                            "deformer_config": {"resolution": 16}}))
    N, K = 6, 3
    xc = torch.tensor(rng.normal(size=(N * K, 3)), dtype=torch.float32)
    valid = torch.as_tensor(rng.random(N * K) < 0.7)
    w = torch.tensor(rng.normal(size=(N * K,)), dtype=torch.float32,
                     requires_grad=True)

    def geometry_fn(x):
        sdf = w * 1.0
        grad = x * w[:, None]
        return (sdf, grad, w[:, None].expand(-1, 4) * 1.0), None

    c2w = torch.eye(3).reshape(1, 9).expand(N * K, 9).contiguous()
    outs = rigid._finish_query(N, K, xc, c2w, valid, geometry_fn, 0, None)
    (g,) = torch.autograd.grad(outs[1].sum() + outs[3].sum(), w)
    sdf = torch.where(valid, w.detach(), 1e5).reshape(N, K)
    sel = torch.arange(N) * K + sdf.argmin(-1)
    hit = valid[sel]
    expect = torch.zeros_like(w)
    expect[sel[hit]] = 1.0 + xc[sel[hit]].sum(-1)
    torch.testing.assert_close(g, expect)


def test_deform_train_mode_refuses_a_pose_gradient(setup):
    """Train-mode ``deform`` with a ``tfs`` that requires a gradient (it
    raised before the K5 backward was ported; the name is kept): the
    implicit-function correction and the blended rotation give ``tfs`` the
    JAX package's gradient for the same downstream loss, on a smooth
    analytic canonical field (so no hash cell's face takes a branch
    apart), at a bent pose, within 1e-4 of its norm: the roots come from
    each package's own search, which agree to ~1e-6 (2e-5 here)."""
    jsys, state = setup["jsys"], setup["state"]
    ds = SyntheticDataset(setup["cfg"].dataset)
    batch = ds[1]                       # frame 1 bends its joints
    batch.pop("t_idx")
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jframe, _ = jsys.model.prepare(state.params, jsys.statics, jb, STEP)
    sys_ = _port(setup)
    frame, _ = sys_.model.prepare(sys_.statics, sys_.to_device(batch), STEP)
    rng = np.random.default_rng(8)
    rigid = sys_.model.deformer.rigid
    # 256 points on the rays in SMPL space, between near and far
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

    def loss(out, xp):
        x_c, sdf, valid, g_obs = out[:4]
        return xp.sum(x_c * xp.asarray(c_x)) + xp.sum(
            xp.where(valid, sdf, 0.0)) + xp.sum(g_obs * xp.asarray(c_g))

    jrigid = jsys.model.deformer.rigid

    def jloss(tfs):
        out = jrigid.deform(jsys.statics, jframe._replace(tfs=tfs),
                            jnp.asarray(pts), lambda x: field(x, jnp),
                            with_jac=True, eval_mode=False)
        return loss(out, jnp), out[2]

    # under jit: op by op, the search's iterations compile each op on its
    # first call (~30 s on a CPU)
    (_, jvalid), ref = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jframe.tfs)
    tfs = frame.tfs.clone().requires_grad_()
    out = rigid.deform(sys_.statics, frame._replace(tfs=tfs),
                       torch.as_tensor(pts), lambda x: field(x, torch),
                       with_jac=True, eval_mode=False)
    np.testing.assert_array_equal(out[2].numpy(), np.asarray(jvalid))
    assert 0.2 < float(out[2].float().mean()) < 1.0
    (got,) = torch.autograd.grad(loss(out, torch), tfs)
    ref = np.asarray(ref)
    assert np.linalg.norm(ref) > 0
    assert np.linalg.norm(got.numpy() - ref) <= 1e-4 * np.linalg.norm(ref)


def test_launcher_trains_on_the_cpu(capsys, tmp_path):
    from intrinsicavatar_tpu_torch.launch import main
    assert main(["--mode", "train", "--device", "cpu", "--config",
                 "configs/tiny-synthetic.yaml", "--exp-dir", str(tmp_path),
                 "trainer.max_steps=2", "trainer.log_every_n_steps=1",
                 "dataset.n_rays=32"]) == 0
    out = capsys.readouterr().out
    assert "[1] " in out and "rgb_l1=" in out
