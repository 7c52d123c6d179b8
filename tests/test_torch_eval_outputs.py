"""The port's eval outputs and its ``--config`` assembly against the JAX
package: marching tetrahedra on a seeded SDF grid, the canonical mesh export
from JAX's parameters, the image grid of one eval frame (written by the
port's PNG writer and by JAX's ``imageio``, both read back by ``cv2``), the
environment map (the port's Radiance file against JAX's ``generate_image``
within RGBE's rounding), and ``launch.build_config`` of every shipped YAML
against the JAX launcher's ``default_config()`` merged with it, in every
mode."""

import glob
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from intrinsicavatar_tpu.render.renderer import IntrinsicAvatar as JModel
from intrinsicavatar_tpu.train import evaluate as JE
from intrinsicavatar_tpu.utils import marching as JMC
from intrinsicavatar_tpu.utils.config import (
    load_yaml as jload, merge as jmerge, resolve as jresolve,
)
from intrinsicavatar_tpu.utils.default_config import (
    default_config as jdefault, tiny_config as jtiny,
)
from intrinsicavatar_tpu_torch import launch
from intrinsicavatar_tpu_torch.render.renderer import IntrinsicAvatar
from intrinsicavatar_tpu_torch.train import evaluate as TE
from intrinsicavatar_tpu_torch.utils import marching as TMC
from intrinsicavatar_tpu_torch.utils.config import merge
from intrinsicavatar_tpu_torch.utils.default_config import tiny_config
from intrinsicavatar_tpu_torch.weights import from_jax_params

cv2 = pytest.importorskip("cv2")

VERT_TOL = 1e-6      # the same numpy code on the same grid
# the mesh from each package's own SDF queries (f32 encode + MLP, the sums
# in another order, within 6e-7 of each other): a crossing at t = va / (va -
# vb) along a lattice edge of length h moves by ~h * 6e-7 / |va - vb|, below
# 1e-5 but at the few shallow crossings, where |va - vb| is small (6 faces
# of 23,114 here, at most 2.2e-5; 6 of 54,028 at 48^3, 4.4e-5); the second
# pass's lattice is fitted to the first pass's vertices, so it moves with
# them.  99.9% of the faces' corners within 1e-5, all within 1e-4.
MESH_VERT_TOL, MESH_SHALLOW_TOL, MESH_SHARE = 1e-5, 1e-4, 0.999


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _sdf_grid(n=20, seed=0):
    rng = np.random.default_rng(seed)
    ax = np.linspace(-1.0, 1.0, n)
    x, y, z = np.meshgrid(ax, ax, ax, indexing="ij")
    r = np.sqrt(x ** 2 + (1.3 * y) ** 2 + z ** 2)
    return (r - 0.6 + 0.05 * rng.normal(size=r.shape)).astype(np.float32)


@pytest.mark.parametrize("level", [0.0, 0.1])
def test_marching_tetrahedra_matches_jax(level):
    sdf = _sdf_grid()
    tv, tf = TMC.marching_tetrahedra(sdf, level)
    jv, jf = JMC.marching_tetrahedra(sdf, level)
    assert len(tf) > 100
    np.testing.assert_array_equal(tf, jf)
    np.testing.assert_allclose(tv, jv, rtol=0, atol=VERT_TOL)


@pytest.fixture(scope="module")
def models():
    """JAX's tiny model and parameters (noise on the geometry table and
    the SDF MLP's hash-feature rows, so the surface is not the init's
    sphere) and the port's model from the same tree."""
    jm = JModel(jtiny().model)
    jm.initialize(np.zeros(10))
    # under jit: op by op, the init compiles each op on its first call
    params = jax.jit(jm.init)(jax.random.PRNGKey(0))
    tree = jax.tree.map(np.array, params)
    rng = np.random.default_rng(0)
    tree["geometry"]["table"] += rng.uniform(
        -0.05, 0.05, tree["geometry"]["table"].shape).astype(np.float32)
    v = tree["geometry"]["mlp"][0]["v"]
    v[3:] += rng.normal(scale=0.1, size=v[3:].shape).astype(np.float32)
    tm = IntrinsicAvatar(tiny_config().model)
    from_jax_params(tm, tree)
    tm.initialize(np.zeros(10))
    return jm, jax.tree.map(jnp.asarray, tree), tm


def test_export_canonical_mesh_matches_jax(models, tmp_path):
    """Resolution 32 (a 32^3 pass, then 32^3 in the padded tight bbox) at
    step 2000's level mask: the same faces, their corners within
    ``MESH_VERT_TOL`` but at shallow crossings, the same count of OBJ face
    lines."""
    jm, params, tm = models

    class JSys:
        model = jm

    jp, tp = str(tmp_path / "jax.obj"), str(tmp_path / "mesh" / "port.obj")
    jv, jf = JE.export_canonical_mesh(JSys, params, 2000, jp, resolution=32)
    tv, tf = TE.export_canonical_mesh(tm, 2000, tp, resolution=32)
    assert len(tf) == len(jf) > 100
    assert abs(len(tv) - len(jv)) < 0.01 * len(jv)
    err = np.abs(tv[tf] - jv[jf]).max((1, 2))
    assert np.mean(err <= MESH_VERT_TOL) >= MESH_SHARE
    assert err.max() <= MESH_SHALLOW_TOL
    faces = lambda p: sum(x.startswith("f ") for x in open(p))
    verts = lambda p: sum(x.startswith("v ") for x in open(p))
    assert faces(tp) == faces(jp) and verts(tp) == len(tv)


@pytest.mark.parametrize("phys", [False, True])
def test_dump_frame_images_matches_jax(tmp_path, phys):
    """One frame's grid (the GT over white, render, normals, opacity; the
    PBR maps in the phys regime): the port's PNG equals JAX's pixel for
    pixel, both read back by cv2."""
    rng = np.random.default_rng(3)
    W, H = 12, 10
    N = W * H
    out = {"comp_rgb_full": rng.random((N, 3)).astype(np.float32),
           "comp_normal": rng.normal(size=(N, 3)).astype(np.float32),
           "opacity": rng.random((N, 1)).astype(np.float32) * 1.2}
    if phys:
        for k in ("comp_rgb_phys_full", "comp_demod_phys_full",
                  "comp_albedo_full"):
            out[k] = rng.random((N, 3)).astype(np.float32)
        for k in ("comp_roughness_full", "comp_metallic_full",
                  "visibility"):
            out[k] = rng.random((N, 1)).astype(np.float32)
    batch = {"rgb": rng.random((N, 3)).astype(np.float32),
             "alpha": (rng.random(N) < 0.5).astype(np.float32)}
    JE.dump_frame_images(str(tmp_path / "jax"), "val_0000", out, batch,
                         (W, H))
    TE.dump_frame_images(str(tmp_path / "port"), "val_0000", out, batch,
                         (W, H))
    ref = cv2.imread(str(tmp_path / "jax" / "val_0000.png"))
    got = cv2.imread(str(tmp_path / "port" / "val_0000.png"))
    assert got.shape == ref.shape == ((3 if phys else 1) * H, 4 * W, 3)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("light", ["envlight-SG", "envlight-tensor"])
def test_dump_envmap_matches_jax(tmp_path, light):
    """The port's ``.hdr`` of the learned light, read back by cv2, within
    RGBE's rounding of JAX's ``generate_image`` (8 bits of each pixel's
    largest channel, truncated)."""
    over = {"light": {"name": light,
                      "envlight_config": {"base_res": 16}}}
    jm = JModel(jmerge(jtiny(), {"model": over}).model)
    params = jm.init(jax.random.PRNGKey(1))
    ref = np.asarray(jm.emitter.generate_image(params["emitter"]))
    tm = IntrinsicAvatar(merge(tiny_config(), {"model": over}).model)
    from_jax_params(tm, jax.tree.map(np.array, params))
    path = TE.dump_envmap(tm, str(tmp_path / "save" / "envmap.exr"))
    assert path.endswith("envmap.hdr")
    got = cv2.cvtColor(cv2.imread(path, cv2.IMREAD_ANYDEPTH
                                  | cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)
    assert got.shape == ref.shape == (16, 32, 3)
    big = ref.max(-1, keepdims=True)
    assert np.all(got <= ref + 1e-7 * big)
    assert np.all(ref - got <= big * 2.0 ** -7)


def _norm(cfg):
    return json.loads(json.dumps(cfg, default=str))


@pytest.mark.parametrize("yaml", sorted(glob.glob("configs/*.yaml")))
def test_config_runs_resolve_to_jax_config(yaml):
    """A ``--config`` run of each shipped YAML, in every mode (train
    included: it merged onto ``train_config()`` before, which turned the
    eval seed grid off for the in-training validation), is JAX's
    ``default_config()`` merged with the YAML, key for key; dotlist
    overrides apply on top."""
    ref = _norm(jresolve(jmerge(jdefault(), jload(yaml))))
    for mode in ("train", "validate", "test", "predict"):
        assert _norm(launch.build_config(mode, yaml)) == ref, mode
    got = launch.build_config("train", yaml, ["trainer.grad_accum=3"])
    assert got.trainer.grad_accum == 3
    assert got.model.eval_seed_grid == ref["model"]["eval_seed_grid"]
