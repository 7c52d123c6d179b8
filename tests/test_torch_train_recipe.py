"""The training recipe's levers in the port against the JAX package: the
adaptive shading budget (its controller, the budget it sets, and ``fit``
publishing it), the optimizer re-init (Adam and the rate schedule restart as
a fresh optax state does, also across a checkpoint), the shape re-init, the
per-step seed grid in the radiance regime (scope ``all``) with the pose
correction at step 4,001, and the two recipe configs that use them
(``configs/capsule-m3c-r5.yaml``, ``configs/capsule-m3c-full.yaml``) built
and trained through the launcher on the CPU."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import train_setup as TS
from intrinsicavatar_tpu.render.renderer import RenderFlags as JFlags
from intrinsicavatar_tpu.train.optim import make_optimizer as j_make_opt
from intrinsicavatar_tpu.train.system import IntrinsicAvatarSystem as JSystem
from intrinsicavatar_tpu.train.system import TrainState
from intrinsicavatar_tpu.utils.config import merge as jmerge
from intrinsicavatar_tpu.utils.default_config import tiny_config as jtiny
from intrinsicavatar_tpu_torch import launch
from intrinsicavatar_tpu_torch.data.synthetic import SyntheticDataset
from intrinsicavatar_tpu_torch.render import renderer as RD
from intrinsicavatar_tpu_torch.render.renderer import RenderFlags
from intrinsicavatar_tpu_torch.train.optim import step_every_leaf
from intrinsicavatar_tpu_torch.train.schedules import lr_schedule_host
from intrinsicavatar_tpu_torch.train.system import IntrinsicAvatarSystem
from intrinsicavatar_tpu_torch.utils import checkpoint as C
from intrinsicavatar_tpu_torch.utils.config import merge
from intrinsicavatar_tpu_torch.utils.default_config import tiny_config
from intrinsicavatar_tpu_torch.weights import (
    flatten_tree, port_key, seed_grid_from_jax, to_jax_tree,
)


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Tier-1 runs six test workers on one host: keep each worker's torch
    pool small so it does not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


ADAPTIVE = {"model": {"adaptive_query_compaction": True,
                      "primary_dtype": "float32", "eval_seed_grid": False},
            "dataset": {"name": "synthetic", "n_rays": 96, "n_frames": 2}}
# (valid, total) shading-sample counts: a first reading, a narrowing of
# 1/16 that the hysteresis holds, widenings up to the clip at 16, narrowings
# of 2/16 or more, an empty window (ignored) and a widening of 1/16
COUNTS = ([(3000, 9000), (2900, 9000), (2600, 9000), (1500, 9000),
           (1600, 9000), (4000, 9000)] + [(9000, 9000)] * 6
          + [(0, 9000)] * 9 + [(0, 0), (100, 9000), (3000, 9000)])


def _jsys(over):
    return JSystem(jmerge(jtiny(), over))


def _port(over, tree=None):
    return IntrinsicAvatarSystem(merge(tiny_config(), over),
                                 "cpu").setup(np.zeros(10), tree)


def test_adaptive_controller_matches_jax():
    """``_update_adaptive_budget`` fed the same (valid, total) counts
    publishes JAX's ``budget_frac_n16`` after every call (the EMA, the
    1.25 headroom, the clip to [2, 16], the 2/16 hysteresis that a
    widening overrides); the flags carry it; off without
    ``adaptive_query_compaction``."""
    jsys = _jsys(ADAPTIVE)
    sys_ = IntrinsicAvatarSystem(merge(tiny_config(), ADAPTIVE), "cpu")
    seen = []
    for valid, total in COUNTS:
        jsys._update_adaptive_budget(valid, total)
        sys_._update_adaptive_budget(valid, total)
        assert sys_._budget_frac_n16 == jsys._budget_frac_n16, (valid, total)
        assert sys_.flags_for_step(2000).budget_frac_n16 \
            == jsys.flags_for_step(2000).budget_frac_n16
        seen.append(sys_._budget_frac_n16)
    # JAX's values: held at 7 while the candidate is 6, up to 16, down to 3
    assert seen[3] == 7 and 16 in seen and seen[-3] == 3
    assert len(set(seen)) >= 8
    off = IntrinsicAvatarSystem(merge(tiny_config(), {}), "cpu")
    off._update_adaptive_budget(3000, 9000)
    assert off.flags_for_step(2000).budget_frac_n16 == 0


@pytest.mark.parametrize("n16, compaction", [(6, 0.5), (6, 0)])
def test_forced_budget_sets_jax_rows(monkeypatch, n16, compaction):
    """At a forced ``budget_frac_n16`` the eval shading pass of 64 rays x 96
    given samples (half of them valid) compacts to JAX's row count
    (``n16 / 16`` plus the 1/16 headroom) with JAX's ``ovf_shading``; an
    explicit ``query_compaction: 0`` wins (no compaction in either)."""
    from intrinsicavatar_tpu.ops import compact as JC
    over = {"model": {"primary_dtype": "float32", "eval_seed_grid": False,
                      "query_compaction": compaction},
            "dataset": {"name": "synthetic", "n_rays": 64, "n_frames": 2}}
    jsys = _jsys(over)
    state = jsys.setup(np.zeros(10), jax.random.PRNGKey(0))
    sys_ = _port(over, jax.tree.map(np.asarray, state.params))
    batch = SyntheticDataset(sys_.config.dataset)[0]
    t_idx = batch.pop("t_idx")
    rng = np.random.default_rng(3)
    R, S = 64, 96
    edges = np.sort(rng.uniform(0.5, 2.5, (R, S + 1)), -1).astype(
        np.float32)
    smask = rng.random((R, S)) < 0.5
    iv = (edges[:, :-1], edges[:, 1:], smask)
    kw = dict(training=False, importance_sample=True, randomized=False,
              budget_frac_n16=n16)

    budgets = {}
    jfn = JC.compact_indices_interleaved
    monkeypatch.setattr(JC, "compact_indices_interleaved", lambda m, b: (
        budgets.setdefault("jax", b), jfn(m, b))[1])
    tfn = RD.compact_indices_interleaved
    monkeypatch.setattr(RD, "compact_indices_interleaved", lambda m, b: (
        budgets.setdefault("port", b), tfn(m, b))[1])

    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    @jax.jit
    def jcounters(params, occ):
        frame, cond = jsys.model.prepare(params, jsys.statics, jb, 2000)
        out = jsys.model.forward(
            params, jsys.statics, frame, cond, occ, jb["rays"],
            jax.random.PRNGKey(0), 2000, JFlags(**kw), t_idx=t_idx,
            intervals=tuple(jnp.asarray(x) for x in iv))
        return out["counters"]

    ref = jcounters(state.params, state.occ)
    b = sys_.to_device(batch)
    frame, cond = sys_.model.prepare(sys_.statics, b, 2000)
    with torch.no_grad():
        out = sys_.model(sys_.statics, frame, cond, sys_.occ, b["rays"],
                         2000, RenderFlags(**kw), t_idx=t_idx,
                         intervals=tuple(torch.as_tensor(x) for x in iv))
    got = out["counters"]
    if compaction:
        full = R * S
        assert budgets["port"] == budgets["jax"] == int(np.ceil(
            full * (n16 + 1) / 16 / 128)) * 128
        assert int(got["ovf_shading"]) == int(ref["ovf_shading"]) > 0
    else:
        assert not budgets and "ovf_shading" not in got
        assert "ovf_shading" not in ref
    for k in ("shading_valid_samples", "shading_total_samples"):
        assert int(got[k]) == int(ref[k]), k


def test_fit_publishes_jax_budget(capsys, monkeypatch):
    """Three ``fit`` steps from step 2000 with ``adaptive_query_compaction``
    and ``log_every: 1``: after each log step the port publishes the
    ``budget_frac_n16`` that JAX's ``fit`` publishes from the same shading
    counts (JAX's train step stubbed to return the port's counts, its
    occupancy update too), logs and prints it when it moves, and its next
    step's shading pass compacts to that fraction; the valid-sample counts
    never raise the budget boost."""
    sys_ = _port(ADAPTIVE)
    sys_.step = 2000
    budgets = []
    tfn = RD.compact_indices_interleaved
    monkeypatch.setattr(RD, "compact_indices_interleaved", lambda m, b: (
        budgets.append((m.numel(), b)), tfn(m, b))[1])
    ds = SyntheticDataset(sys_.config.dataset)
    batch = ds[0]
    t_idx = batch.pop("t_idx")

    def data():
        while True:
            yield batch, t_idx

    hist = sys_.fit(data(), 2003, log_every=1)
    out = capsys.readouterr().out
    assert sys_._budget_boost == 0

    jsys = _jsys(ADAPTIVE)
    steps = iter(hist)

    def jstep(state, batch, t_idx, flags):
        _, sc = next(steps)
        return state._replace(step=state.step + 1), {
            k: jnp.float32(sc.get(k, 0.0)) for k in (
                "total", "shading_valid_samples", "shading_total_samples",
                "ovf_shading")}

    jsys.train_step = jstep
    jsys.occ_update_step = lambda state, batch, t_idx: state
    jstate = TrainState(params={}, opt_state=None, occ=None,
                        step=jnp.asarray(2000, jnp.int32), rng=None)
    _, jhist = jsys.fit(data(), jstate, 2003, log_every=1, prefetch=False)
    assert [s for s, _ in hist] == [s for s, _ in jhist]
    for (_, got), (_, ref) in zip(hist, jhist):
        assert got.get("budget_frac_n16") == ref.get("budget_frac_n16")
        assert "budget_boost" not in got
    assert sys_._budget_frac_n16 == jsys._budget_frac_n16 > 0
    assert "budget_frac_n16" in hist[0][1]
    assert f"adaptive shading budget -> {int(hist[0][1]['budget_frac_n16'])}" \
        "/16" in out
    # step 2000 compacts at query_compaction (0.5 + 1/16), later steps at
    # the published sixteenths (+ 1/16)
    pub = [int(h[1].get("budget_frac_n16", 0)) for h in hist]
    n16 = [0]
    for p in pub:
        n16.append(p or n16[-1])
    (full, _), = set((m, 0) for m, _ in budgets)
    fracs = [0.5 + 1 / 16] + [(k + 1) / 16 for k in n16[1:3]]
    assert [b for _, b in budgets] == [
        int(np.ceil(full * f / 128)) * 128 for f in fracs]


def _injected_fit(sys_, grads, start, stop, ckpt=None):
    """``fit`` from ``start`` to ``stop`` whose train step applies the
    injected gradient of each step (``grads[step]``, a tree of the JAX
    leaves) as the system's own step does: one Adam update of every leaf
    and one scheduler step.  Returns ``{step: rate applied}``."""
    params = dict(sys_.model.named_parameters())
    rates = {}

    def step_stub(batch, t_idx, flags, draws=None):
        sys_.optimizer.zero_grad(set_to_none=True)
        for key, g in flatten_tree(grads[sys_.step]).items():
            params[port_key(key)].grad = torch.as_tensor(g)
        rates[sys_.step] = next(g["lr"] for g in sys_.optimizer.param_groups
                                if g["name"] == "default")
        step_every_leaf(sys_.optimizer)
        sys_.scheduler.step()
        sys_.step += 1
        return {"total": torch.tensor(1.0)}

    sys_.train_step = step_stub
    sys_.occ_update_step = lambda batch, t_idx, draws=None: None
    sys_.step = start

    def data():
        while True:
            yield {"rays": np.zeros((8, 8), np.float32)}, 0.0

    hist = sys_.fit(data(), stop, log_every=1, ckpt_fn=ckpt,
                    ckpt_every=1 if ckpt else 0)
    return rates, hist


REINIT = {"system": {"reinit_optimizer_steps": [3000], "warmup_steps": 250,
                     "scheduler": {"milestones": [2500, 3400, 3700],
                                   "gamma": 0.3}},
          "model": {"primary_dtype": "float32"}}


def test_optimizer_reinit_matches_optax(tmp_path):
    """``fit`` across ``reinit_optimizer_steps: [3000]`` (the r5 recipe's
    schedule) with injected gradients: the parameters one, two and three
    steps after the re-init equal those of JAX's optimizer re-created at
    step 3000 (``reinit_optimizer``), whose rate counts from its own 0:
    the applied rate at 3000 is the warm-up's start factor times the
    base; the logged ``lr`` stays the global step's schedule, as JAX logs
    it.  A checkpoint saved after the re-init and restored into a fresh
    system gives the next step of the uninterrupted run, bit for bit."""
    jsys = _jsys(REINIT)
    state = jsys.setup(np.zeros(10), jax.random.PRNGKey(0))
    tree = jax.tree.map(np.array, state.params)
    rng = np.random.default_rng(4)
    start, stop = 2998, 3003
    grads = {s: jax.tree.map(lambda p: rng.normal(size=p.shape).astype(
        np.float32), tree) for s in range(start, stop)}

    scfg = jsys.config.system
    tx = j_make_opt(state.params, scfg.optimizer, scfg.scheduler,
                    scfg.warmup_steps)
    params, opt_state = state.params, tx.init(state.params)
    ref = {}
    for s in range(start, stop):
        if s in jsys.reinit_optimizer_steps:
            tx = j_make_opt(params, scfg.optimizer, scfg.scheduler,
                            scfg.warmup_steps)
            opt_state = tx.init(params)
        updates, opt_state = jax.jit(tx.update)(
            jax.tree.map(jnp.asarray, grads[s]), opt_state, params)
        params = jax.tree.map(lambda p, u: p + u, params, updates)
        ref[s] = jax.tree.map(np.asarray, params)

    sys_ = _port(REINIT, tree)
    assert sys_.reinit_optimizer_steps == [3000]
    saved = {}
    rates, hist = _injected_fit(sys_, grads, start, 3002,
                                lambda st, s: saved.setdefault(s, st))
    TS.assert_tree_close(to_jax_tree(sys_.model), ref[3001], 1e-6,
                         atol=1e-9, what="params at 3001")
    base = float(scfg.optimizer.args.lr)
    # the optimizer made at 2998 has counted one step at 2999, the one
    # re-created at 3000 none
    warm1 = base * (0.01 + 0.99 / 250)
    assert rates[2999] == pytest.approx(warm1, rel=1e-6)
    assert rates[3000] == pytest.approx(base * 0.01, rel=1e-6)
    assert rates[3001] == pytest.approx(warm1, rel=1e-6)
    assert [h[1]["lr"] for h in hist] == [
        lr_schedule_host(s, sys_.config.system) for s in range(start, 3002)]
    # a restart's Adam count: step 1 of the new optimizer at 3000, so 2
    # after 3001
    counts = {int(v["step"]) for v in sys_.optimizer.state.values()}
    assert counts == {2}

    # the state after step 3000 (one step past the re-init), through disk
    C.save_checkpoint(str(tmp_path / "ckpt"), saved[3000])
    fresh = IntrinsicAvatarSystem(sys_.config, "cpu").setup(
        np.zeros(10), tree, state=C.restore_checkpoint(str(tmp_path / "ckpt")))
    assert fresh.step == 3001
    _injected_fit(fresh, grads, 3001, stop)
    _injected_fit(sys_, grads, 3002, stop)
    a, b = (flatten_tree(to_jax_tree(x.model)) for x in (fresh, sys_))
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    TS.assert_tree_close(b, ref[stop - 1], 1e-6, atol=1e-9,
                         what="params at 3002")


def test_shape_reinit_rebuilds_jax_statics():
    """``reinit_shape`` with a nonzero betas correction rebuilds the statics
    (the canonical-pose inverse transforms, the weight voxel, the template
    and the fields' bbox) of JAX's ``initialize(betas + correction)``;
    ``fit`` calls it every ``reinit_shape_every_n_steps`` steps with the
    dataset's betas."""
    over = {"system": {"reinit_shape_every_n_steps": 2},
            "model": {"primary_dtype": "float32"}}
    jsys = _jsys(over)
    jsys.setup(np.zeros(10), jax.random.PRNGKey(0))
    rng = np.random.default_rng(6)
    betas = rng.normal(scale=0.5, size=10).astype(np.float32)
    corr = rng.normal(scale=0.3, size=(1, 10)).astype(np.float32)
    sys_ = _port(over)
    with torch.no_grad():
        sys_.model.pose_correction.betas.copy_(torch.as_tensor(corr))
    calls = []
    reinit = sys_.reinit_shape
    sys_.reinit_shape = lambda b: (calls.append((sys_.step, b)), reinit(b))
    sys_.train_step = lambda batch, t_idx, flags, draws=None: (
        setattr(sys_, "step", sys_.step + 1) or {"total": torch.tensor(1.)})
    sys_.occ_update_step = lambda batch, t_idx, draws=None: None
    sys_.step = 1

    def data():
        while True:
            yield {"rays": np.zeros((8, 8), np.float32)}, 0.0

    sys_.fit(data(), 5, log_every=1, betas=betas)
    assert [s for s, _ in calls] == [2, 4]
    assert all(np.array_equal(b, betas) for _, b in calls)

    ref = jsys.model.initialize(betas + corr[0])
    got = sys_.statics
    for name in ("tfs_inv_t", "vs_template"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   rtol=1e-5, atol=1e-5, err_msg=name)
    # the weight voxels' KNN may order a near-tie apart (as in
    # test_torch_broyden.py::test_weight_voxel_matches_jax)
    diff = np.abs(got.lbs_voxel.numpy() - np.asarray(ref.lbs_voxel))
    assert diff.max() < 1e-3 and np.mean(diff < 1e-6) > 0.99
    np.testing.assert_allclose(np.asarray(sys_.model.deformer.bbox),
                               np.asarray(jsys.model.deformer.bbox),
                               rtol=1e-5, atol=1e-6)
    # the correction moved the shape
    plain = jsys.model.initialize(betas)
    assert np.abs(np.asarray(plain.vs_template)
                  - got.vs_template.numpy()).max() > 1e-3


# the scope-all grid step with the pose correction: the tolerances of
# test_torch_train_pose.py (pose 5%, betas 8%: a shading lane at a hash
# cell's face moves them)
POSE = {"model": {"train_seed_grid": True, "train_seed_grid_resolution": 24,
                  "train_seed_grid_scope": "all",
                  "deformer": {"rigid_deformer": {"deformer_config": {
                      "optimize_betas": True}}}}}
GRAD_RTOL, LOSS_RTOL, CURV_RTOL = 2e-2, 1e-3, 2e-3
RTOLS = {"pose_correction.pose": 5e-2, "pose_correction.betas": 8e-2}
CANCELLED = ("pose_correction.global_orient", "pose_correction.transl")


def test_scope_all_grid_pose_step_matches_jax(monkeypatch):
    """One occupancy update and train step at step 4,001 (the radiance
    regime, importance sampling on, the pose corrections on with
    ``optimize_betas``, frame 1's bent pose) with ``train_seed_grid_scope:
    all`` and JAX's grid in both packages: the importance rounds read the
    grid's SDF and the shading pass is polished from its seeds, its roots
    carrying the pose and betas gradients through the train-mode
    correction (KN's twin, called once).  The losses, every leaf's gradient
    and the updated parameters."""
    step = 4001
    jsys, state, tree, cfg, batch, t_idx = TS.make_systems(POSE, step,
                                                           frame=1)
    flags = jsys.flags_for_step(step)
    assert not flags.enable_phys and flags.importance_sample
    assert jsys.model.use_train_seed_grid(flags)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    draws = TS.JaxDraws(state.rng, 64,
                        lambda _: TS.shading_lanes(cfg, flags, 64),
                        lambda _: False, 16)(step, occ=True)
    state = jsys.occ_update_step(state, jb, t_idx)
    sampled = jsys.sample_step(state, jb, t_idx, flags)
    ref_losses, ref_grads, ref_new = TS.jax_step(
        jsys, TS.make_grad_fn(jsys, flags), state, jb, t_idx, draws, flags,
        sampled=sampled)

    from intrinsicavatar_tpu_torch.anim import deformer as DF
    sys_ = TS.port_system(cfg, tree, step)
    grid = seed_grid_from_jax(sampled[2])
    bakes, kn = [], []
    sys_.model.bake_train_seed_grid = lambda *a: bakes.append(a) or grid
    kn_fn = DF.deform_skinning_bwd
    monkeypatch.setattr(DF, "deform_skinning_bwd",
                        lambda *a: kn.append(a) or kn_fn(*a))
    b = sys_.to_device(batch)
    sys_.occ_update_step(b, t_idx, draws)
    losses = sys_.train_step(b, t_idx, sys_.flags_for_step(step), draws)
    assert len(bakes) == 1 and len(kn) == 1
    assert set(losses) == set(ref_losses)
    assert "sec_seed_polish_fail" in losses and "ovf_candidates" \
        not in losses
    for k, v in ref_losses.items():
        rel = CURV_RTOL if k == "curvature" else LOSS_RTOL
        assert float(losses[k]) == pytest.approx(float(v), rel=rel), k
    grads = to_jax_tree(sys_.model, grads=True)
    errs = TS.leaf_errors(grads, ref_grads)
    pose = errs["pose_correction.pose"][1]
    assert pose > 0 and errs["pose_correction.betas"][1] > 0
    for k, (err, ref) in errs.items():
        if k in CANCELLED:
            for g in (grads, jax.tree.map(np.asarray, ref_grads)):
                leaf = g["pose_correction"][k.split(".")[1]]
                assert np.linalg.norm(leaf) <= 1e-4 * pose, k
            continue
        assert err <= RTOLS.get(k, GRAD_RTOL) * ref + 1e-30, (k, err, ref)
    TS.assert_tree_close(to_jax_tree(sys_.model), ref_new.params, 0.0,
                         atol=2e-5, what="params")


@pytest.mark.parametrize("name", ["capsule-m3c-r5", "capsule-m3c-full"])
def test_recipe_config_builds(name):
    """The system builds from each recipe config on the CPU, with its
    levers on: r5's per-step grid in the phys regime (from step 3,000) and
    its optimizer re-init at 3,000, full's adaptive budget."""
    cfg = launch.build_config("train", f"configs/{name}.yaml")
    sys_ = IntrinsicAvatarSystem(cfg, device="cpu")
    if name == "capsule-m3c-r5":
        assert sys_.reinit_optimizer_steps == [3000]
        assert sys_.model.use_train_seed_grid(sys_.flags_for_step(3000))
        assert not sys_.model.use_train_seed_grid(sys_.flags_for_step(2999))
        assert sys_.grad_accum == 2
    else:
        assert sys_._adaptive_budget and not sys_.reinit_optimizer_steps
        assert not sys_.model.use_train_seed_grid(sys_.flags_for_step(20000))


# each recipe cut to 4 CPU steps: 64 rays of 32^2 images, 2^12-row tables,
# a 16^3 weight voxel and occupancy grid; r5's phys regime and optimizer
# re-init moved to step 2 (its 8^3 grid, 8 scattering points, 16-step
# secondary rays), full's compaction warm-up and importance kick-in to 0
CUT = ["trainer.max_steps=4", "trainer.log_every_n_steps=1",
       "trainer.check_val_every_n_steps=0", "trainer.ckpt_every_n_steps=0",
       "dataset.image_size=32", "dataset.n_rays=64",
       "dataset.sampler.num_sample=64", "dataset.max_frames=2",
       "model.geometry.xyz_encoding_config.log2_hashmap_size=12",
       "model.radiance.xyz_encoding_config.log2_hashmap_size=12",
       "model.deformer.rigid_deformer.deformer_config.resolution=16",
       "model.occ_resolution=16"]
RECIPE_CUT = {
    "capsule-m3c-r5": ["model.phys_kick_in_step=2",
                       "system.reinit_optimizer_steps=[2]",
                       "model.train_seed_grid_resolution=8",
                       "model.samples_per_pixel=8",
                       "model.num_samples_per_secondary_ray=16"],
    "capsule-m3c-full": ["model.compaction_warmup_steps=0",
                         "model.importance_sample_kick_in_step=0",
                         "model.n_importance_samples=8"]}


@pytest.mark.parametrize("name", ["capsule-m3c-r5", "capsule-m3c-full"])
def test_recipe_config_trains_through_the_launcher(name, tmp_path, capsys,
                                                   monkeypatch):
    """``launch --mode train --device cpu --config configs/<name>.yaml`` cut
    to 4 steps (``CUT``) exits 0 with finite losses: r5 bakes a grid each
    phys step (steps 2 and 3) and re-creates its optimizer at step 2, so
    the final checkpoint's schedule has counted 2 steps; full publishes an
    adaptive budget at its first log step."""
    bakes = []
    bake = RD.IntrinsicAvatar.bake_train_seed_grid
    monkeypatch.setattr(RD.IntrinsicAvatar, "bake_train_seed_grid",
                        lambda self, *a: bakes.append(a[-1])
                        or bake(self, *a))
    assert launch.main(["--mode", "train", "--device", "cpu", "--config",
                        f"configs/{name}.yaml", "--exp-dir", str(tmp_path),
                        *CUT, *RECIPE_CUT[name]]) == 0
    out = capsys.readouterr().out
    last = json.loads(out.split("last: ", 1)[1].splitlines()[0])
    assert np.isfinite(last["total"])
    run, = (tmp_path / name).iterdir()
    state = C.restore_checkpoint(str(run / "ckpt" / "final"))
    assert state["step"] == 4
    sched = state["opt_state"]["scheduler"]["last_epoch"]
    if name == "capsule-m3c-r5":
        assert bakes == [2, 3] and "rgb_phys_l1" in last
        assert sched == 2
    else:
        assert not bakes and sched == 4
        assert "adaptive shading budget -> " in out
