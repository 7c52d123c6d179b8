"""The hand-off from training to serving in the port, against the JAX
package where it has a counterpart: a checkpoint saved mid-run and restored
into a fresh system trains on exactly as an uninterrupted run does;
``filter_for_test`` and ``MetricLogger`` against the JAX package's; a
``launch --mode validate --params`` render from a saved checkpoint against
the in-memory model's; and the cadence of ``fit``'s validation,
checkpoints and deadline against the JAX ``fit``'s."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from intrinsicavatar_tpu.train.system import IntrinsicAvatarSystem as JSystem
from intrinsicavatar_tpu.train.system import TrainState
from intrinsicavatar_tpu.utils import checkpoint as JC
from intrinsicavatar_tpu.utils.config import merge as jmerge
from intrinsicavatar_tpu.utils.default_config import tiny_config as jtiny
from intrinsicavatar_tpu.utils.logging import MetricLogger as JLogger
from intrinsicavatar_tpu_torch import launch
from intrinsicavatar_tpu_torch.data.synthetic import SyntheticDataset
from intrinsicavatar_tpu_torch.train import evaluate as EV
from intrinsicavatar_tpu_torch.train.system import IntrinsicAvatarSystem
from intrinsicavatar_tpu_torch.utils import checkpoint as C
from intrinsicavatar_tpu_torch.utils.config import merge
from intrinsicavatar_tpu_torch.utils.default_config import tiny_config
from intrinsicavatar_tpu_torch.utils.logging import MetricLogger
from intrinsicavatar_tpu_torch.weights import flatten_tree, to_jax_tree

OVERRIDES = {"model": {"primary_dtype": "float32", "eval_seed_grid": False},
             "dataset": {"name": "synthetic", "n_rays": 64, "n_frames": 2}}
START, N = 1996, 4   # importance rounds on; the occupancy update of step
#                      2000 falls after the restore
# wall-clock readings of fit, which no two runs share
WALL = ("rays_per_sec", "steps_per_sec_wall", "rays_per_sec_wall",
        "wall_time")


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Tier-1 runs six test workers on one host: keep each worker's torch
    pool small so it does not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _system(cfg, state=None):
    sys_ = IntrinsicAvatarSystem(cfg, "cpu").setup(np.zeros(10),
                                                   state=state)
    if state is None:
        sys_.step = START
    return sys_


def _data(batches):
    yield from batches


def _losses(history):
    return [(s, {k: v for k, v in sc.items()
                 if k not in WALL and not k.startswith("wall_")})
            for s, sc in history]


def test_resume_equals_an_uninterrupted_run(tmp_path):
    """N steps, a checkpoint, a fresh system restored from it and N more
    steps, all drawing from the system's generator, against 2N steps in
    one run on the same batches: every logged loss, the parameters, Adam's
    moments and counts, the schedule, the occupancy grid (updated at step
    2000, after the restore), the budget boost and the generator are
    equal."""
    cfg = merge(tiny_config(), OVERRIDES)
    ds = SyntheticDataset(cfg.dataset)
    batches = []
    for i in range(2 * N):
        b = ds[i % 2]
        batches.append((b, b.pop("t_idx")))
    whole = _system(cfg)
    ref = whole.fit(_data(batches), START + 2 * N, log_every=1)
    first = _system(cfg)
    hist = first.fit(_data(batches[:N]), START + N, log_every=1)
    C.save_checkpoint(str(tmp_path / "ckpt"), first.state_dict())
    # the budget boost is host state, not part of a checkpoint (as in the
    # JAX package): a resumed run takes it from budget_boost_init
    assert first._budget_boost == 1          # an overflow at step 1996
    resumed = _system(
        merge(cfg, {"system": {"budget_boost_init": first._budget_boost}}),
        C.restore_checkpoint(str(tmp_path / "ckpt")))
    assert resumed.step == START + N
    hist += resumed.fit(_data(batches[N:]), START + 2 * N, log_every=1)

    assert [s for s, _ in ref] == list(range(START, START + 2 * N))
    assert _losses(hist) == _losses(ref)
    assert resumed.step == whole.step
    assert resumed._budget_boost == whole._budget_boost
    a, b = flatten_tree(to_jax_tree(resumed.model)), \
        flatten_tree(to_jax_tree(whole.model))
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    oa, ob = resumed.optimizer.state_dict(), whole.optimizer.state_dict()
    assert set(oa["state"]) == set(ob["state"])
    for i, st in ob["state"].items():
        assert int(st["step"]) == 2 * N     # Adam's count of updates
        for k, v in st.items():
            assert torch.equal(oa["state"][i][k], v), (i, k)
    assert resumed.scheduler.state_dict() == whole.scheduler.state_dict()
    for k in ("occs", "binaries", "aabbs"):
        assert torch.equal(getattr(resumed.occ, k), getattr(whole.occ, k)), k
    assert not bool(whole.occ.binaries.all())     # the update of step 2000
    assert torch.equal(resumed.generator.get_state(),
                       whole.generator.get_state())


def test_checkpoint_holds_the_state_and_the_params_npz(tmp_path):
    """The saved directory: JAX ``TrainState``'s fields, the parameters
    under the dotted keys that ``launch --params`` reads, and a restore
    onto a target's structure, devices and dtypes."""
    cfg = merge(tiny_config(), OVERRIDES)
    sys_ = IntrinsicAvatarSystem(cfg, "cpu").setup(np.zeros(10))
    state = sys_.state_dict()
    C.save_checkpoint(str(tmp_path), state)
    back = C.restore_checkpoint(str(tmp_path))
    assert set(back) == {"params", "opt_state", "occ", "step", "rng"}
    npz = np.load(tmp_path / "params.npz")
    flat = flatten_tree(to_jax_tree(sys_.model))
    assert set(npz.files) == set(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(npz[k], v)
    like = C.restore_checkpoint(str(tmp_path), target=state)
    assert torch.equal(like["occ"]["binaries"], state["occ"]["binaries"])
    with pytest.raises(KeyError):
        C.restore_checkpoint(str(tmp_path), target={**state, "extra": 1})


def test_filter_for_test_matches_jax():
    rng = np.random.default_rng(0)
    arr = lambda *s: rng.normal(size=s).astype(np.float32)
    full = {"params": {"geometry": {"table": arr(4, 3),
                                    "mlp": [{"w": arr(2, 2)}]},
                       "pose_correction": {"body_pose": arr(3, 69)},
                       "density": {"beta": arr(1)}},
            "opt_state": {"count": np.asarray(3)},
            "occ": {"binaries": np.ones((2, 2, 2), bool)},
            "step": np.asarray(7), "rng": arr(2)}
    for tree in (full, {"params": {"density": {"beta": arr(1)}}}, {}):
        got, ref = C.filter_for_test(tree), JC.filter_for_test(tree)
        fa, fb = flatten_tree(got), flatten_tree(ref)
        assert set(fa) == set(fb)
        for k in fb:
            np.testing.assert_array_equal(fa[k], fb[k])
        assert "occ" not in got and "pose_correction" not in got["params"]
    assert "pose_correction" in full["params"] and "occ" in full


def test_metric_logger_writes_jax_records(tmp_path):
    records = [(0, {"total": 1.5, "lr": np.float32(1e-3), "n": 7}),
               (10, {"val/psnr": 21.25}), (20, {})]
    lines = []
    for Logger, d in ((MetricLogger, tmp_path / "port"),
                      (JLogger, tmp_path / "jax")):
        log = Logger(str(d))
        for step, sc in records:
            log.log(step, sc)
        log.log_image(10, "val/rgb", np.zeros((2, 2, 3)))   # no wandb
        log.close()
        lines.append((d / "metrics.jsonl").read_text())
    assert lines[0] == lines[1]
    assert json.loads(lines[0].splitlines()[0]) == {
        "step": 0, "total": 1.5, "lr": float(np.float32(1e-3)), "n": 7.0}


def test_throughput_and_profile_span(tmp_path, monkeypatch):
    """``Throughput`` counts the rays after the window's first tick over
    its span, as the JAX package's does; ``profile_steps`` writes the
    span's trace."""
    from intrinsicavatar_tpu.utils.logging import Throughput as JThroughput
    from intrinsicavatar_tpu_torch.utils.logging import (
        Throughput, profile_steps,
    )
    clock = [10.0]
    monkeypatch.setattr("time.perf_counter", lambda: clock[0])
    got, ref = Throughput(window=3), JThroughput(window=3)
    for n in (5, 7, 11, 13):
        clock[0] += 0.5
        got.tick(n)
        ref.tick(n)
    assert (got.rays_per_sec, got.steps_per_sec) == (
        ref.rays_per_sec, ref.steps_per_sec) == (24.0, 2.0)
    monkeypatch.undo()
    with profile_steps(str(tmp_path)):
        torch.ones(8).sum()
    assert (tmp_path / "trace.json").stat().st_size > 0


def test_fit_cadence_matches_jax(monkeypatch):
    """``val_fn`` and ``ckpt_fn`` are called at JAX's steps, the
    checkpoint holds the state after its step, the validation scalars are
    logged with a ``val/`` prefix, and the loop stops after the step that
    passes the deadline: the JAX ``fit`` and the port's with their train
    and occupancy steps stubbed, under one clock that validation moves past
    the deadline at step 8."""
    clock = [1000.0]
    monkeypatch.setattr("time.time", lambda: clock[0])
    calls = {"jax": {"val": [], "ckpt": []}, "port": {"val": [], "ckpt": []}}

    class Log:
        def __init__(self):
            self.recs = []

        def log(self, step, scalars):
            self.recs.append((step, sorted(k for k in scalars
                                           if k.startswith("val/"))))

    def cadence(who):
        def val_fn(state, step):
            calls[who]["val"].append(step)
            if step == 8:
                clock[0] += 100.0
            return {"psnr": 20.0 + step}

        def ckpt_fn(state, step):
            calls[who]["ckpt"].append((step, int(
                state["step"] if isinstance(state, dict) else state.step)))
        return dict(val_fn=val_fn, val_every=4, ckpt_fn=ckpt_fn,
                    ckpt_every=3, deadline_ts=1050.0)

    def data():
        while True:
            yield {"rays": np.zeros((8, 8), np.float32)}, 0.0

    jsys = JSystem(jmerge(jtiny(), OVERRIDES))
    jsys.train_step = lambda state, batch, t_idx, flags: (
        state._replace(step=state.step + 1), {"total": jnp.float32(1.0)})
    jsys.occ_update_step = lambda state, batch, t_idx: state
    jlog = Log()
    jstate = TrainState(params={}, opt_state=None, occ=None,
                        step=jnp.asarray(0, jnp.int32), rng=None)
    jsys.fit(data(), jstate, 13, log_every=2, prefetch=False, logger=jlog,
             **cadence("jax"))

    sys_ = IntrinsicAvatarSystem(merge(tiny_config(), OVERRIDES),
                                 "cpu").setup(np.zeros(10))

    def step_stub(batch, t_idx, flags, draws=None):
        sys_.step += 1
        return {"total": torch.tensor(1.0)}

    sys_.train_step = step_stub
    sys_.occ_update_step = lambda batch, t_idx, draws=None: None
    plog = Log()
    clock[0] = 1000.0
    sys_.fit(data(), 13, log_every=2, logger=plog, **cadence("port"))

    assert calls["port"] == calls["jax"] == {
        "val": [4, 8], "ckpt": [(3, 4), (6, 7)]}
    assert plog.recs == jlog.recs
    assert [s for s, keys in plog.recs if keys] == [4, 8]
    assert sys_.step == 9


def test_validate_from_saved_params_renders_as_the_in_memory_model(
        tmp_path, monkeypatch):
    """A system trained two steps on the launcher's own config, saved; then
    ``launch --mode validate --params <ckpt>/params.npz`` renders a frame
    that equals, bit for bit, the same frame rendered by the system's model
    in memory (the launcher's 64^3 test grid cut to 16^3, as in the
    launcher test of ``test_torch_train_pose.py``)."""
    overrides = ["dataset.n_frames=1", "dataset.n_rays=256",
                 "model.seed_grid_resolution=16", "trainer.eval_step=2000"]
    cfg = launch.build_config("validate", "configs/tiny-synthetic.yaml",
                              overrides)
    ds = SyntheticDataset(cfg.dataset)
    sys_ = IntrinsicAvatarSystem(cfg, "cpu").setup(ds.betas)
    sys_.fit(((b, b.pop("t_idx")) for b in (ds[0], ds[0])), 2, log_every=1)
    C.save_checkpoint(str(tmp_path / "ckpt"), sys_.state_dict())

    build = EV.build_test_occ_grid
    monkeypatch.setattr(EV, "build_test_occ_grid", lambda *a, **k: build(
        *a, **{**k, "resolution": 16}))
    render = EV.render_frame
    seen = []

    def recording(*a, **k):
        out = render(*a, **k)
        seen.append((a, k, out))
        return out

    monkeypatch.setattr(EV, "render_frame", recording)
    assert launch.main(["--mode", "validate", "--config",
                        "configs/tiny-synthetic.yaml", "--device", "cpu",
                        "--params", str(tmp_path / "ckpt" / "params.npz"),
                        "--exp-dir", str(tmp_path / "exp"), *overrides]) == 0
    (a, k, out), = seen
    assert a[3] == 2000
    seed = int(cfg.get("seed", 42))
    mine = render(sys_.model, sys_.model.initialize(ds.betas), *a[2:],
                  **{**k, "generator": torch.Generator().manual_seed(seed)})
    keys = [x for x in out if x != "counters"]
    assert keys and set(keys) == set(mine) - {"counters"}
    for x in keys:
        np.testing.assert_array_equal(np.asarray(out[x]),
                                      np.asarray(mine[x]), err_msg=x)
    assert out["counters"] == mine["counters"]
    run, = (tmp_path / "exp" / "tiny-synthetic").iterdir()
    assert json.loads((run / "metrics.json").read_text())["psnr"] > 0
    assert json.loads((run / "config.json").read_text())["name"] \
        == "tiny-synthetic"
