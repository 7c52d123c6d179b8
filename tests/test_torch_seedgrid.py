"""The port's eval seed grid (``anim/seedgrid.py``) against the JAX
package's: the lattice, the dilation and packing, the searched bake of the
tiny model's body, and the gather twin (kernel KM's plain version) on a
JAX-baked grid carried across by ``weights.seed_grid_from_jax`` and on
hand-built cells (incoherent, coherent, tied weights, points on nodes and
outside the lattice)."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from intrinsicavatar_tpu.anim import seedgrid as JS
from intrinsicavatar_tpu.anim.broyden import corner_pack
from intrinsicavatar_tpu.render.renderer import IntrinsicAvatar as JModel
from intrinsicavatar_tpu.utils.config import merge as jmerge
from intrinsicavatar_tpu.utils.default_config import tiny_config as jtiny
from intrinsicavatar_tpu_torch.anim import seedgrid as SG
from intrinsicavatar_tpu_torch.render.renderer import IntrinsicAvatar
from intrinsicavatar_tpu_torch.train import evaluate as TE
from intrinsicavatar_tpu_torch.utils.config import merge
from intrinsicavatar_tpu_torch.utils.default_config import tiny_config
from intrinsicavatar_tpu_torch.weights import (
    from_jax_params, seed_grid_from_jax,
)


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Tier-1 runs six test workers on one host: keep each worker's torch
    pool small so it does not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


STEP = 5000
RES = 20            # lattice nodes per axis (96 in serving)
OVERRIDES = {"model": {"primary_dtype": "float32"}}
# the gather: bools exact, floats within 1e-6 of max(|ref|, 1)
FTOL = 1e-6


def _close(a, b, tol=FTOL):
    a, b = np.asarray(a), np.asarray(b)
    err = np.abs(a - b) / np.maximum(np.abs(b), 1.0)
    assert err.max(initial=0.0) <= tol, err.max()


@pytest.fixture(scope="module")
def setup():
    """Both models on one body and pose, the JAX lattice, the JAX search's
    raw outputs on it and the JAX bake (without padding: one chunk of the
    whole lattice, on both sides)."""
    jcfg = jmerge(jtiny(), OVERRIDES)
    cfg = merge(tiny_config(), OVERRIDES)
    jm = JModel(jcfg.model)
    js = jm.initialize(np.zeros(10))
    jp = jm.init(jax.random.PRNGKey(0))
    model = IntrinsicAvatar(cfg.model)
    statics = model.initialize(np.zeros(10))
    from_jax_params(model, jax.tree.map(np.asarray, jp))
    rng = np.random.default_rng(3)
    batch = {"index": np.asarray([0]), "betas": np.zeros(10, np.float32),
             "body_pose": (rng.normal(size=69) * 0.2).astype(np.float32),
             "global_orient": np.zeros(3, np.float32),
             "transl": np.asarray([0.0, 0.3, 2.0], np.float32)}
    jframe, jcond = jm.prepare(jp, js, {k: jnp.asarray(v) for k, v in
                                         batch.items()}, STEP)
    frame, cond = model.prepare(statics, TE.batch_to_device(batch, "cpu"),
                                STEP)
    jaabb = jm.deformer.rigid.get_bbox_deformed(jframe)
    N = RES ** 3
    # the JAX lattice, read back through a bake whose "search" returns its
    # input point as the root, everywhere valid
    ident = JS.bake_seed_grid(
        lambda p: (p, jnp.ones(p.shape[0], bool), p[:, 0]), jaabb, RES,
        chunk=N)
    jpts = np.asarray(ident.packed)[:, :3]
    sched = jm._schedules(STEP)

    @jax.jit
    def search(p):
        out = jm._deform_query(jp, js, jframe, jcond, p, sched,
                               with_grad=False, with_feature=False,
                               eval_mode=True, global_step=STEP)
        return out[0], out[2], out[1]

    raw = tuple(np.asarray(a) for a in search(jnp.asarray(jpts)))
    jgrid = JS.bake_seed_grid(lambda p: tuple(jnp.asarray(a) for a in raw),
                              jaabb, RES, chunk=N)
    return types.SimpleNamespace(
        model=model, statics=statics, frame=frame, cond=cond, jaabb=jaabb,
        jpts=jpts, raw=raw, jgrid=jgrid)


def test_lattice_is_bit_equal(setup):
    """From one bbox both packages place the lattice's nodes bit for bit
    (each package's bbox of the skinned voxel rounds apart by an ulp)."""
    s = setup
    aabb = s.model.deformer.rigid.get_bbox_deformed(s.frame)
    np.testing.assert_allclose(aabb.numpy(), np.asarray(s.jaabb), atol=1e-6)
    pts = SG.lattice_points(torch.as_tensor(np.array(s.jaabb)), RES)
    np.testing.assert_array_equal(pts.numpy(), s.jpts)


def test_dilation_and_packing_match_jax(setup):
    """Fed the JAX search's raw outputs, the port's dilation and packing
    give the JAX grid."""
    s = setup
    xc, ok, sdf = (torch.as_tensor(np.array(a)) for a in s.raw)
    assert 0.05 < float(ok.float().mean()) < 0.95
    grid = SG.pack_seed_grid(xc, ok, sdf, torch.as_tensor(
        np.array(s.jaabb)), RES)
    ref = seed_grid_from_jax(s.jgrid)
    assert grid.grid.shape == (RES, RES, RES, 6)
    _close(grid.grid.numpy(), ref.grid.numpy())
    _close(grid.center.numpy(), ref.center.numpy())
    _close(grid.half.numpy(), ref.half.numpy())
    # dilation adopted nodes: seeds there, but no SDF
    g = grid.grid.reshape(-1, 6)
    adopted = (g[:, 3] > 0.5) & (g[:, 5] < 0.5)
    assert int(adopted.sum()) > 0
    assert not g[adopted, 4].any()


def test_searched_bake_matches_jax(setup):
    """The port's own bake of the same body: the search's validity on
    >= 99.9% of nodes, the roots within 1e-4 where both converged, and the
    packed grid's validity on >= 99.9% of nodes."""
    s = setup
    m = s.model
    sched = m.schedules(STEP, torch.device("cpu"))
    with torch.no_grad():
        out = m._deform_query(s.statics, s.frame, s.cond,
                              torch.as_tensor(np.array(s.jpts)), sched,
                              with_grad=False, global_step=STEP)
    xc, sdf, ok = (o.numpy() for o in out)
    jxc, jok, jsdf = s.raw
    assert np.mean(ok == jok) >= 0.999
    both = ok & jok
    assert np.abs(xc[both] - jxc[both]).max() < 1e-4
    assert np.abs(sdf[both] - jsdf[both]).max() < 1e-4
    grid = m.bake_seed_grid(s.statics, s.frame, s.cond, STEP,
                            resolution=RES, chunk=RES ** 3)
    ref = seed_grid_from_jax(s.jgrid)
    g, r = grid.grid.reshape(-1, 6), ref.grid.reshape(-1, 6)
    assert float(((g[:, 3] > 0.5) == (r[:, 3] > 0.5)).float().mean()) \
        >= 0.999
    assert float(((g[:, 5] > 0.5) == (r[:, 5] > 0.5)).float().mean()) \
        >= 0.999


def _compare_gather(jgrid, pts, coh=3.0):
    jx, jo, js = JS.gather_from_grid(jgrid, jnp.asarray(pts), coh)
    tx, to, ts = SG.gather_from_grid(seed_grid_from_jax(jgrid),
                                     torch.as_tensor(pts), coh)
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    _close(tx.numpy(), np.asarray(jx))
    if js is None:
        assert ts is None
    else:
        np.testing.assert_array_equal(ts.numpy() == 1e5,
                                      np.asarray(js) == 1e5)
        _close(ts.numpy(), np.asarray(js))
    return tx, to, ts


@pytest.mark.parametrize("with_sdf", [True, False])
def test_gather_twin_matches_jax(setup, with_sdf):
    """Points on lattice nodes, inside the lattice, in its half-cell slack
    and beyond it, on the baked grid with and without its SDF channel."""
    s = setup
    jgrid = s.jgrid
    if not with_sdf:
        packed = jgrid.packed.reshape(-1, 8, 6)[:, :, :4].reshape(-1, 32)
        jgrid = jgrid._replace(packed=packed)
    lo, hi = np.asarray(s.jaabb)
    span = hi - lo
    rng = np.random.default_rng(5)
    pts = np.concatenate([
        s.jpts[rng.choice(len(s.jpts), 400, replace=False)],
        rng.uniform(lo, hi, (3000, 3)),
        rng.uniform(lo - 0.2 * span, hi + 0.2 * span, (1500, 3)),
    ]).astype(np.float32)
    tx, to, ts = _compare_gather(jgrid, pts)
    assert 0.05 < float(to.float().mean()) < 0.95
    # the lattice's slack is half a cell: a point a cell beyond is outside
    far = (hi + span / (RES - 1))[None].astype(np.float32)
    _, ok, sdf = SG.gather_from_grid(seed_grid_from_jax(jgrid),
                                     torch.as_tensor(far))
    assert not ok.any()
    if with_sdf:
        assert float(sdf[0]) == 1e5


def _hand_grid(nodes):
    """A 2^3 JAX grid over [-1, 1]^3 from node rows ``[8, C]``."""
    C = nodes.shape[1]
    packed = corner_pack([jnp.asarray(nodes[:, c]) for c in range(C)],
                         (2, 2, 2), "border")
    return JS.SeedGrid(packed=packed, center=jnp.zeros(3), half=jnp.ones(3))


def test_hand_built_cells_match_jax():
    """The cells of ``tests/test_seedgrid.py``: two root branches in one
    cell (incoherent: the nearest valid corner, unblended), a gentle single
    branch (coherent: the blend), and a tied-weight cell: at the cell
    centre every weight is 1/8, so the nearest valid corner is the first
    valid one, for the seed and, under its own validity, for the SDF.  The
    points include nodes (on the lattice's corners) and one outside."""
    nodes = np.zeros((8, 6), np.float32)
    for z in range(2):
        for y in range(2):
            for x in range(2):
                i = (z * 2 + y) * 2 + x
                nodes[i, 0] = -1.0 if x == 0 else 1.0
                nodes[i, 1] = 0.3 * y
                nodes[i, 3] = 1.0
                nodes[i, 4] = 0.5 * x - 0.2 * z
                nodes[i, 5] = float(i not in (0, 4))
    pts = np.asarray([[-0.6, 0.0, 0.0], [0.6, 0.0, 0.0], [0.0, 0.0, 0.0],
                      [0.3, -0.7, 0.9], [-1.0, -1.0, -1.0],
                      [1.0, 1.0, 1.0], [2.5, 0.0, 0.0]], np.float32)
    # incoherent at coh 0.1, coherent at coh 3
    for coh in (0.1, 3.0):
        tx, to, ts = _compare_gather(_hand_grid(nodes), pts, coh)
        assert to[:6].all() and not to[6]
    tx, _, _ = _compare_gather(_hand_grid(nodes), pts, 0.1)
    np.testing.assert_allclose(tx[:2, 0].numpy(), [-1.0, 1.0], atol=1e-6)
    # tied weights at the centre: corner 0 (node 0) wins the seed; the SDF
    # skips its SDF-invalid corners 0 and 1 (nodes 0 and 4) to corner 2
    # (node 2)
    np.testing.assert_allclose(tx[2].numpy(), nodes[0, :3], atol=1e-6)
    _, _, ts = _compare_gather(_hand_grid(nodes), pts, 0.1)
    assert float(ts[2]) == pytest.approx(nodes[2, 4], abs=1e-6)
    # a gentle single branch blends
    gentle = nodes.copy()
    gentle[:, 0] = 0.1 * (np.arange(8) % 2)
    tx, _, _ = _compare_gather(_hand_grid(gentle), pts, 3.0)
    np.testing.assert_allclose(tx[2, 0].numpy(), 0.05, atol=1e-6)
    # a cell with no valid corner gives no seed and the far SDF
    none = nodes.copy()
    none[:, 3] = none[:, 5] = 0.0
    _, to, ts = _compare_gather(_hand_grid(none), pts)
    assert not to.any() and bool((ts == 1e5).all())


@pytest.mark.parametrize("C", [6, 4])
def test_node_records_layout_and_twin_match_jax(C):
    """The port's grid stores each node as a 32-byte record (its C
    channels, then zeros), the layout kernel KM reads; a JAX grid carried
    across, a packed one and one moved between devices are all records,
    and the twin reading them equals JAX's ``gather_from_grid`` on
    hand-built cells (two root branches, one SDF-invalid corner pair) at
    both coherence factors, the cell centre's tied weights included."""
    rng = np.random.default_rng(31)
    nodes = rng.normal(size=(8, 6)).astype(np.float32)
    nodes[:, 0] += np.where(np.arange(8) % 2, 0.8, -0.8)
    nodes[:, 3] = (np.arange(8) != 5).astype(np.float32)
    nodes[:, 5] = (np.arange(8) % 4 != 0).astype(np.float32)
    nodes[:, :3] *= nodes[:, 3:4]
    nodes[:, 4] *= nodes[:, 5]
    jgrid = _hand_grid(nodes[:, :C])
    grid = seed_grid_from_jax(jgrid)
    for g in (grid, grid.to("cpu"), SG.SeedGrid(
            SG.node_records(grid.grid.contiguous()), grid.center,
            grid.half)):
        assert SG.is_node_records(g.grid) and g.channels == C
        rec = torch.as_strided(g.grid, (8, SG.RECORD), (SG.RECORD, 1))
        np.testing.assert_array_equal(rec[:, :C].numpy(),
                                      nodes[:, :C])
        assert not bool(rec[:, C:].any())
    assert not SG.is_node_records(grid.grid.contiguous())
    pts = np.concatenate([
        np.zeros((1, 3)), rng.uniform(-1.2, 1.2, (200, 3)),
        SG.lattice_points(torch.tensor([[-1.0] * 3, [1.0] * 3]), 2).numpy(),
    ]).astype(np.float32)
    for coh in (0.1, 3.0):
        _compare_gather(jgrid, pts, coh)


def test_render_frame_bakes_when_eval_seed_grid(setup, monkeypatch):
    """``eval_seed_grid: true`` (the default) bakes one grid per frame and
    renders through it: the gather answers the importance rounds and seeds
    the shading pass (no search runs in the forward: its counters are
    absent, the polish's is there); ``false`` renders by the search."""
    s = setup
    m = s.model
    bakes, gathers = [], []
    bake, gather = m.bake_seed_grid, SG.gather_from_grid
    monkeypatch.setattr(m, "bake_seed_grid", lambda *a, **k: bakes.append(1)
                        or bake(*a, **{**k, "resolution": 12}))
    monkeypatch.setattr(SG, "gather_from_grid", lambda *a, **k:
                        gathers.append(a[1].shape[0]) or gather(*a, **k))
    rng = np.random.default_rng(1)
    R = 64
    d = np.array([0.0, 0.3, 2.0]) + rng.normal(scale=0.2, size=(R, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays = np.concatenate([np.zeros((R, 3)), d, np.full((R, 1), 1.0),
                           np.full((R, 1), 3.0)], -1).astype(np.float32)
    tb = TE.batch_to_device(
        {"index": np.asarray([0]), "betas": np.zeros(10, np.float32),
         "body_pose": np.zeros(69, np.float32),
         "global_orient": np.zeros(3, np.float32),
         "transl": np.asarray([0.0, 0.3, 2.0], np.float32), "rays": rays},
        "cpu")
    flags = TE.eval_flags(m.config, STEP)
    assert m.config.eval_seed_grid
    out = TE.render_frame(m, s.statics, tb, STEP, flags, ray_chunk=R,
                          occ_resolution=8,
                          generator=torch.Generator().manual_seed(0))
    assert len(bakes) == 1 and len(gathers) == 3     # 2 rounds + shading
    assert "sec_seed_polish_fail" in out["counters"]
    assert "ovf_candidates" not in out["counters"]
    m.config.eval_seed_grid = False
    try:
        out = TE.render_frame(m, s.statics, tb, STEP, flags, ray_chunk=R,
                              occ_resolution=8,
                              generator=torch.Generator().manual_seed(0))
    finally:
        m.config.eval_seed_grid = True
    assert len(bakes) == 1 and len(gathers) == 3
    assert "sec_seed_polish_fail" not in out["counters"]
    assert "ovf_candidates" in out["counters"]
