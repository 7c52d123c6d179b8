"""The port's PBR modules against the JAX package on the CPU: the SG and
image emitters (eval, ``generate_image``, the sampling tables, sampling and
pdf), the stratified sphere, the three BRDFs (sample, pdf, eval), the
material head, the scattering points (``sample_volume_interaction``) and
``compute_indirect_radiance`` with a small shader chunk, so that its
chunked, padded path and its summed counters run.  The JAX draws are
replayed from its keys and injected into the port.  Within 1e-5 (f32 on
both sides)."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from intrinsicavatar_tpu.fields.material import VolumeMaterial as JMaterial
from intrinsicavatar_tpu.pbr import brdf as JBRDF
from intrinsicavatar_tpu.pbr import envlight as JEnv
from intrinsicavatar_tpu.render import pbr as JPBR
from intrinsicavatar_tpu.render.renderer import IntrinsicAvatar as JModel
from intrinsicavatar_tpu.render.renderer import RenderFlags as JFlags
from intrinsicavatar_tpu.utils import diag
from intrinsicavatar_tpu.utils.config import merge as jmerge
from intrinsicavatar_tpu.utils.config import wrap as jwrap
from intrinsicavatar_tpu.utils.default_config import tiny_config as jtiny
from intrinsicavatar_tpu_torch.fields.material import VolumeMaterial
from intrinsicavatar_tpu_torch.pbr import brdf as TBRDF
from intrinsicavatar_tpu_torch.pbr import envlight as TEnv
from intrinsicavatar_tpu_torch.render import pbr as TPBR
from intrinsicavatar_tpu_torch.render.renderer import IntrinsicAvatar
from intrinsicavatar_tpu_torch.render.renderer import RenderFlags
from intrinsicavatar_tpu_torch.utils.config import merge, wrap
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


TOL = dict(rtol=1e-5, atol=1e-5)
T = torch.as_tensor
close = lambda a, b, msg="": np.testing.assert_allclose(
    np.asarray(a), np.asarray(b), err_msg=msg, **TOL)


def _dirs(rng, n):
    d = rng.normal(size=(n, 3)).astype(np.float32)
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


def _load(module, tree):
    """Load a JAX parameter dict into a port module by name."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            node = tree
            for part in name.replace("layers.", "").split("."):
                node = node[int(part)] if part.isdigit() else node[part]
            p.copy_(T(np.asarray(node)))


def _light_u(key, n):
    """The draws of the JAX ``_sample_from_pdf`` from ``key``."""
    k1, k2 = jax.random.split(key)
    k3, k4 = jax.random.split(k2)
    return np.stack([np.asarray(jax.random.uniform(k, (n,)))
                     for k in (k1, k2, k3, k4)], -1)


@pytest.mark.parametrize("name", ["envlight-SG", "envlight-tensor"])
def test_emitter_matches_jax(name):
    cfg = {"name": name, "xyz2lonlat_mode": None,
           "envlight_config": {"base_res": 16, "num_SGs": 16}}
    jcls = JEnv.EnvLightSG if name == "envlight-SG" else JEnv.EnvLightTensor
    tcls = TEnv.EnvLightSG if name == "envlight-SG" else TEnv.EnvLightTensor
    je, te = jcls(jwrap(cfg)), tcls(wrap(cfg))
    params = je.init(jax.random.PRNGKey(0))
    _load(te, params)
    rng = np.random.default_rng(0)
    dirs = _dirs(rng, 500)
    with torch.no_grad():
        close(te(T(dirs)), je.eval(params, jnp.asarray(dirs)), "eval")
        close(te.generate_image(), je.generate_image(params), "image")
        js, ts = je.update_pdf(params), te.update_pdf()
        for k in ("marginal_cdf", "conditional_cdf", "pdf_image"):
            close(getattr(ts, k), getattr(js, k), k)
        assert abs(ts.pdf_scale - float(js.pdf_scale)) < 1e-3
        key = jax.random.PRNGKey(1)
        d_j = je.sample(js, key, 400)
        d_t = te.sample(ts, T(_light_u(key, 400)))
        close(d_t, d_j, "sample")
        close(te.pdf(ts, T(dirs)), je.pdf(js, jnp.asarray(dirs)), "pdf")
    # the SG emitter's default init, drawn by the port
    te.init(torch.Generator().manual_seed(0))
    assert all(torch.isfinite(p).all() for p in te.parameters())


def test_stratified_sphere_matches_jax():
    key = jax.random.PRNGKey(2)
    d_j, inv_j = JEnv.sample_uniform_sphere_stratified(key, 16, 32)
    k1, k2 = jax.random.split(key)
    ju = T(np.asarray(jax.random.uniform(k1, (16, 32))))
    jv = T(np.asarray(jax.random.uniform(k2, (16, 32))))
    d_t, inv_t = TEnv.sample_uniform_sphere_stratified(ju, jv)
    close(d_t, d_j)
    close(inv_t, inv_j)


# the rows' sample error over eps32 / sin(theta) (_close_ggx_sample)
GGX_C = 16.0
EPS32 = float(np.finfo(np.float32).eps)


def _close_ggx_sample(s_t, s_j, u1, alpha):
    """GGX samples within ``1e-5 + GGX_C eps32 / sin(theta)`` a row (and
    1e-5 of each entry), ``sin(theta)`` in float64 from the row's draw
    ``u1`` and roughness ``alpha``.

    Both packages take ``sin = sqrt(1 - cos^2)`` of the half-vector's
    ``cos = sqrt((1 - u1) / (1 + (alpha^2 - 1) u1))``, which cancels where
    ``cos`` is near 1.  Each package rounds ``cos`` through six float32
    operations, within 1.75 eps32 of the exact value, so the two differ by
    up to 3.5 eps32; ``cos^2`` adds eps32 / 2 each side and ``1 - cos^2``
    is exact (Sterbenz), so ``1 - cos^2`` differs by up to 8 eps32 and
    ``sin`` by 8 eps32 / (2 sin) = 4 eps32 / sin.  The reflection ``2 (wi .
    h) h - wi`` moves by at most 4 |dh|: GGX_C = 16.  A row over 1e-5 must
    be one whose term exceeds 1e-5 (sin < GGX_C eps32 / 1e-5 = 0.19): a
    port fault in a well-conditioned row still fails."""
    u1 = np.asarray(u1, np.float64)
    a2 = np.asarray(alpha, np.float64) ** 2
    sin = np.sqrt(np.clip(1.0 - (1.0 - u1) / (1.0 + (a2 - 1.0) * u1),
                          0.0, 1.0))
    cond = GGX_C * EPS32 / np.maximum(sin, 1e-30)
    a, b = np.asarray(s_t, np.float64), np.asarray(s_j, np.float64)
    err = np.abs(a - b) - 1e-5 * np.abs(b)
    bad = np.flatnonzero((err > (1e-5 + cond)[:, None]).any(-1))
    assert not bad.size, f"sample rows {bad} off by {err[bad].max(-1)}"
    over = (err > 1e-5).any(-1)
    assert (cond[over] > 1e-5).all(), (
        f"rows over 1e-5 with a well-conditioned sin: "
        f"{np.flatnonzero(over & (cond <= 1e-5))}")


@pytest.mark.parametrize("name", ["brdf-lambertian", "brdf-ggx",
                                  "brdf-multi-lobe"])
def test_brdf_matches_jax(name):
    jb = {"brdf-lambertian": JBRDF.Lambertian, "brdf-ggx": JBRDF.GGX,
          "brdf-multi-lobe": JBRDF.MultiLobe}[name]()
    tb = {"brdf-lambertian": TBRDF.Lambertian, "brdf-ggx": TBRDF.GGX,
          "brdf-multi-lobe": TBRDF.MultiLobe}[name]()
    rng = np.random.default_rng(3)
    N = 2000
    n = _dirs(rng, N)
    wi = _dirs(rng, N)
    wi = np.where(np.sum(wi * n, -1, keepdims=True) < 0, -wi, wi)
    wo = _dirs(rng, N)
    rough = rng.uniform(0.09, 0.99, N).astype(np.float32)
    alb = rng.uniform(0.03, 0.8, (N, 3)).astype(np.float32)
    metal = rng.uniform(0.0, 1.0, (N, 1)).astype(np.float32)
    atten = np.zeros((N, 1), np.float32)
    ja = [jnp.asarray(a) for a in (rough, rough, alb, metal, atten)]
    ta = [T(a) for a in (rough, rough, alb, metal, atten)]
    key = jax.random.PRNGKey(4)
    u = jax.random.uniform
    if name == "brdf-multi-lobe":
        k1, k2, k3 = jax.random.split(key, 3)
        draws = np.concatenate([np.asarray(u(k1, (N, 2))),
                                np.asarray(u(k2, (N, 2))),
                                np.asarray(u(k3, (N, 1)))], -1)
    else:
        # a single lobe draws its two uniforms from the key itself
        pair = np.asarray(u(key, (N, 2)))
        draws = np.concatenate([pair, pair, np.zeros((N, 1))], -1)
    s_j = jb.sample({}, key, jnp.asarray(n), jnp.asarray(wi), *ja)
    s_t = tb.sample(T(n), T(wi), *ta, T(draws.astype(np.float32)))
    if name == "brdf-ggx":
        _close_ggx_sample(s_t, s_j, draws[:, 2], rough)
    else:
        close(s_t, s_j, "sample")
    close(tb.pdf(T(n), T(wi), T(wo), *ta),
          jb.pdf({}, jnp.asarray(n), jnp.asarray(wi), jnp.asarray(wo), *ja),
          "pdf")
    for a, b, k in zip(tb.eval(T(n), T(wi), T(wo), *ta),
                       jb.eval({}, jnp.asarray(n), jnp.asarray(wi),
                               jnp.asarray(wo), *ja), ("diff", "spec")):
        close(a, b, k)


def test_material_matches_jax():
    cfg = jtiny().model.material
    jm = JMaterial(cfg)
    params = jm.init(jax.random.PRNGKey(5))
    tm = VolumeMaterial(wrap(dict(cfg)))
    _load(tm, params)
    x = np.random.default_rng(5).normal(size=(300, cfg.input_feature_dim))
    x = x.astype(np.float32)
    with torch.no_grad():
        close(tm(T(x)), jm(params, jnp.asarray(x)))
        close(tm.lipschitz_bound(), jm.lipschitz_bound(params))


def test_sample_volume_interaction_matches_jax():
    rng = np.random.default_rng(6)
    R, S, spp = 64, 24, 32
    n = rng.integers(0, S + 1, R)
    mask = np.arange(S)[None] < n[:, None]
    t = np.cumsum(rng.uniform(0.01, 0.05, (R, S + 1)), 1).astype(np.float32)
    ts, te = np.where(mask, t[:, :-1], 0.0), np.where(mask, t[:, 1:], 0.0)
    w = rng.uniform(0.02, 1.0, (R, S))
    w = np.where(mask, w / w.sum(1, keepdims=True) * 0.9, 0.0)
    sdf = 0.3 - np.cumsum(rng.uniform(0.0, 0.05, (R, S)), 1)
    normals = _dirs(rng, R * S).reshape(R, S, 3)
    mats = rng.uniform(0.0, 1.0, (R, S, 5))
    trans = 1.0 - w.sum(1)
    o, d = rng.normal(size=(R, 3)), _dirs(rng, R)
    args = [a.astype(np.float32) if a.dtype != bool else a
            for a in (o, d, ts, te, mask, w, sdf, normals, mats, trans)]
    ref = JPBR.sample_volume_interaction(None, *(jnp.asarray(a)
                                                 for a in args), spp)
    out = TPBR.sample_volume_interaction(*(T(a) for a in args), spp)
    for k in ref._fields:
        close(getattr(out, k), getattr(ref, k), k)


@pytest.fixture(scope="module")
def secondary():
    over = {"model": {"primary_dtype": "float32",
                      "secondary_coarse_dtype": "float32",
                      "eval_seed_grid": False,
                      "secondary_shader_chunk": 512}}
    jcfg, cfg = jmerge(jtiny(), over), merge(tiny_config(), over)
    jm = JModel(jcfg.model)
    js = jm.initialize(np.zeros(10))
    jp = jm.init(jax.random.PRNGKey(0))
    model = IntrinsicAvatar(cfg.model)
    statics = model.initialize(np.zeros(10))
    from_jax_params(model, jax.tree.map(np.asarray, jp))
    rng = np.random.default_rng(7)
    batch = {"index": np.asarray([0]), "betas": np.zeros(10, np.float32),
             "body_pose": (rng.normal(size=69) * 0.2).astype(np.float32),
             "global_orient": np.zeros(3, np.float32),
             "transl": np.asarray([0.0, 0.3, 2.0], np.float32)}
    jframe, jcond = jm.prepare(jp, js, {k: jnp.asarray(v)
                                        for k, v in batch.items()}, 25000)
    frame, cond = model.prepare(statics, {k: T(v) for k, v in
                                          batch.items()}, 25000)
    return dict(jm=jm, js=js, jp=jp, model=model, statics=statics, rng=rng,
                jframe=jframe, jcond=jcond, frame=frame, cond=cond,
                aabb=np.asarray(cfg.model.scene_aabb, np.float32))


def _coarse_at(s, dtype):
    """The JAX model and the port's of ``secondary``, or both again with the
    queried secondary coarse pass at ``dtype`` (the same parameters)."""
    if dtype == "float32":
        return s["jm"], s["model"]
    over = {"model": {"primary_dtype": "float32",
                      "secondary_coarse_dtype": dtype,
                      "eval_seed_grid": False,
                      "secondary_shader_chunk": 512}}
    jm = JModel(jmerge(jtiny(), over).model)
    jm.initialize(np.zeros(10))
    model = IntrinsicAvatar(merge(tiny_config(), over).model)
    model.initialize(np.zeros(10))
    from_jax_params(model, jax.tree.map(np.asarray, s["jp"]))
    return jm, model


@pytest.mark.parametrize("coarse_dtype", ["float32", "bfloat16"])
def test_compute_indirect_radiance_matches_jax(secondary, coarse_dtype):
    """1,300 secondary rays in chunks of 512 (the last one padded): the
    transmittance and indirect rgb per ray, and the counters summed over
    the chunks; the queried coarse pass (no seed grid) at float32 and at
    JAX's default bf16 scope."""
    s = secondary
    jm, model = _coarse_at(s, coarse_dtype)
    rng = copy.deepcopy(s["rng"])       # the same rays for both cases
    M, res = 1300, 16
    verts = np.asarray(s["jframe"].vertices)
    o = (verts[rng.choice(len(verts), M)]
         + rng.normal(scale=0.05, size=(M, 3))).astype(np.float32)
    d = _dirs(rng, M)
    active = rng.random(M) < 0.9
    binaries = rng.random((res, res, res)) < 0.7
    step = 25000
    with diag.collect() as jc:
        jtr, jrgb = JPBR.compute_indirect_radiance(
            jm, s["jp"], s["js"], s["jframe"], s["jcond"],
            jm._schedules(step), jnp.asarray(binaries),
            jnp.asarray(s["aabb"]), jnp.asarray(o), jnp.asarray(d), step,
            JFlags(training=False, enable_phys=True),
            active=jnp.asarray(active))
    tc = {}
    with torch.no_grad():
        ttr, trgb = TPBR.compute_indirect_radiance(
            model, s["statics"], s["frame"], s["cond"],
            model.schedules(step, "cpu"), T(binaries), T(s["aabb"]),
            T(o), T(d), step, RenderFlags(training=False, enable_phys=True),
            T(active), tc)
    assert {k: int(v) for k, v in tc.items()} == \
        {k: int(v) for k, v in jc.items()}
    assert tc["sec_total_samples"] == 3 * 512 * 16
    assert 0 < tc["sec_valid_samples"]
    # some rays are attenuated, some escape
    tr = ttr.numpy()
    assert (tr < 0.9).any() and (tr > 0.99).any()
    err = np.maximum(np.abs(tr - np.asarray(jtr)),
                     np.abs(trgb.numpy() - np.asarray(jrgb)).max(-1))
    # a discrete branch taken apart (a Broyden lane converging at another
    # step, a seed's argmin) moves a ray; all others agree
    assert np.mean(err < 1e-5) >= 0.99, err.max()
    if coarse_dtype == "bfloat16":
        # with the bf16 coarse pass every ray within 1e-4 (measured 1.2e-7,
        # the counters equal); the bf16 and float32 passes place the fine
        # samples of 1.7% of the rays apart, by up to 5.3e-4
        assert err.max() <= 1e-4, err.max()


def test_render_frame_relights_with_the_hdri():
    """A batch with ``hdri`` renders as if the image emitter's ``base``
    were the HDRI (its sampling tables rebuilt from it), and the emitter
    gets its own base back afterwards."""
    from intrinsicavatar_tpu_torch.render.occupancy import OccGridState
    from intrinsicavatar_tpu_torch.train import evaluate as TE
    cfg = merge(tiny_config(), {"model": {
        "primary_dtype": "float32", "secondary_coarse_dtype": "float32",
        "eval_seed_grid": False, "render_mode": "light",
        "light": {"name": "envlight-tensor"}}})
    model = IntrinsicAvatar(cfg.model).init(torch.Generator().manual_seed(0))
    statics = model.initialize(np.zeros(10))
    rng = np.random.default_rng(8)
    R = 48
    target = np.array([0.0, 0.3, 2.0]) + rng.normal(scale=0.2, size=(R, 3))
    d = target / np.linalg.norm(target, axis=-1, keepdims=True)
    batch = {"index": T([0]), "betas": torch.zeros(10),
             "body_pose": T(rng.normal(size=69) * 0.2).float(),
             "global_orient": torch.zeros(3),
             "transl": T([0.0, 0.3, 2.0]),
             "rays": T(np.concatenate([np.zeros((R, 3)), d, np.ones((R, 1)),
                                       np.full((R, 1), 3.0)], -1)).float()}
    frame, cond = model.prepare(statics, batch, 25000)
    res = 16
    occ = OccGridState(torch.zeros(1, res ** 3),
                       T(rng.random((1, res, res, res)) < 0.7),
                       T(np.asarray(cfg.model.scene_aabb, np.float32))[None])
    flags = TE.eval_flags(cfg.model, 25000)
    base = model.emitter.base.detach().clone()
    hdri = T(rng.uniform(0.0, 4.0, base.shape)).float()
    gen = torch.Generator().manual_seed(9)
    draws = [{"light_u": torch.rand((R * 16, 4), generator=gen)}]
    kw = dict(ray_chunk=R, occ=occ, frame=frame, cond=cond, draws=draws)
    out = TE.render_frame(model, statics, {**batch, "hdri": hdri}, 25000,
                          flags, **kw)
    torch.testing.assert_close(model.emitter.base.detach(), base)
    with torch.no_grad():
        model.emitter.base.copy_(hdri)
    ref = TE.render_frame(model, statics, batch, 25000, flags, **kw)
    for k in ("comp_rgb_phys_full", "comp_demod_phys_full"):
        np.testing.assert_array_equal(out[k], ref[k])
    with torch.no_grad():
        model.emitter.base.copy_(base)
    other = TE.render_frame(model, statics, batch, 25000, flags, **kw)
    assert np.abs(other["comp_rgb_phys_full"]
                  - ref["comp_rgb_phys_full"]).max() > 1e-3
