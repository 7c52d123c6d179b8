"""The port's real-data path against the JAX package's, on fixtures written
into ``tmp_path`` in the layouts of ``tests/test_data.py`` (by ``cv2``, the
JAX package's reader): the PeopleSnapshot, SyntheticHuman, RANA and
animation loaders' batches in each mode at downscale 1 and 2 (train mode
from the same numpy generator), the SMPL model file loader on a synthetic
``.pkl`` / ``.npz`` with a sparse joint regressor and nonzero pose blend
shapes, and the SMPL forward and the deformer's statics built from it."""

import json
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse
import torch

from intrinsicavatar_tpu.anim import smpl as JSMPL
from intrinsicavatar_tpu.anim.deformer import FastSNARF as JSNARF
from intrinsicavatar_tpu.data import animation as JA
from intrinsicavatar_tpu.data import peoplesnapshot as JP
from intrinsicavatar_tpu.data import synthetichuman as JH
from intrinsicavatar_tpu.utils.config import wrap as jwrap
from intrinsicavatar_tpu_torch import data as TD
from intrinsicavatar_tpu_torch.anim import smpl as TSMPL
from intrinsicavatar_tpu_torch.anim.deformer import FastSNARF
from intrinsicavatar_tpu_torch.utils.config import wrap

cv2 = pytest.importorskip("cv2")

H, W = 48, 40        # even: the rays' int(H / d) and cv2's rounded size agree
N_FRAMES = 3
RAY_TOL = 1e-6       # both packages build the rays by the same numpy code
SMPL_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------------ layouts


def _camera_npz(path):
    K = np.eye(3, dtype=np.float32)
    K[0, 0] = K[1, 1] = 60.0
    K[0, 2], K[1, 2] = W / 2 + 0.5, H / 2 - 0.5
    ang = 0.3
    ext = np.eye(4, dtype=np.float32)
    ext[:3, :3] = [[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                   [-np.sin(ang), 0, np.cos(ang)]]
    ext[:3, 3] = [0.1, -0.2, 0.3]
    np.savez(path, intrinsic=K, extrinsic=ext, height=H, width=W)


def _poses(rng, n, packed=False):
    pose = rng.normal(scale=0.2, size=(n, 72)).astype(np.float32)
    out = {"betas": rng.normal(scale=0.5, size=(1, 10)).astype(np.float32),
           "transl": (np.asarray([0.0, 0.3, 2.5], np.float32)
                      + rng.normal(scale=0.05, size=(n, 3))
                      ).astype(np.float32)}
    if packed:
        out["thetas"] = pose
    else:
        out["global_orient"], out["body_pose"] = pose[:, :3], pose[:, 3:]
    return out


def _disc(rng):
    yy, xx = np.mgrid[:H, :W]
    m = (yy - H / 2) ** 2 + (xx - W / 2) ** 2 < (H / 4) ** 2
    return m ^ (rng.random((H, W)) < 0.03)


def _peoplesnapshot(root, rng, mask_dtype=np.uint8, packed=False):
    """cameras.npz, PNG frames written by cv2 (BGR), masks as .npy, the
    pose caches of each split and a test HDRI."""
    for d in ("images", "masks", "poses"):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    _camera_npz(os.path.join(root, "cameras.npz"))
    for split in ("train", "val", "test"):
        np.savez(os.path.join(root, "poses", f"anim_nerf_{split}.npz"),
                 **_poses(rng, N_FRAMES, packed))
    yy, xx = np.mgrid[:H, :W]
    for i in range(N_FRAMES):
        base = np.stack([yy * 4, xx * 5, (yy + xx) * 2], -1) + 30 * i
        img = (base + rng.integers(0, 40, (H, W, 3))) % 256
        cv2.imwrite(os.path.join(root, "images", f"image_{i:04d}.png"),
                    img.astype(np.uint8)[..., ::-1])
        np.save(os.path.join(root, "masks", f"mask_{i:04d}.npy"),
                _disc(rng).astype(mask_dtype))
    hdri = (rng.random((8, 16, 3)) ** 3 * 30).astype(np.float32)
    cv2.imwrite(os.path.join(root, "sky.hdr"), hdri[..., ::-1])
    return root


def _synthetichuman(root, rng, albedo_bits=8):
    """PeopleSnapshot's layout plus GT albedo (8- or 16-bit PNG), normal
    PNGs and per-frame HDRIs named by ``hdri_files.json`` (frame 0 by its
    index, frame 1 by its image's name, frame 2 none)."""
    _peoplesnapshot(root, rng)
    for d in ("albedo", "normal", "hdri"):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    mx = 255 if albedo_bits == 8 else 65535
    dt = np.uint8 if albedo_bits == 8 else np.uint16
    for i in range(N_FRAMES):
        cv2.imwrite(os.path.join(root, "albedo", f"albedo_{i:04d}.png"),
                    rng.integers(0, mx + 1, (H, W, 3)).astype(dt))
        cv2.imwrite(os.path.join(root, "normal", f"normal_{i:04d}.png"),
                    rng.integers(0, 256, (H, W, 3)).astype(np.uint8))
    for name in ("a.hdr", "b.hdr"):
        cv2.imwrite(os.path.join(root, "hdri", name),
                    (rng.random((4, 8, 3)) * 5).astype(np.float32))
    with open(os.path.join(root, "hdri_files.json"), "w") as f:
        json.dump({"0": "a.hdr", "image_0001.png": "b.hdr"}, f)
    return root


def _opt(mode, downscale, **kw):
    o = {"start": 0, "end": N_FRAMES - 1, "skip": 1, "downscale": downscale,
         **kw}
    return {mode: o}


def _assert_batches_equal(got, ref, dtypes=True):
    assert set(got) == set(ref)
    for k in ref:
        a, b = np.asarray(got[k]), np.asarray(ref[k])
        assert a.shape == b.shape, (k, a.shape, b.shape)
        if k == "rays":
            np.testing.assert_allclose(a, b, rtol=0, atol=RAY_TOL,
                                       err_msg=k)
        else:
            assert a.dtype == b.dtype or not dtypes, (k, a.dtype, b.dtype)
            np.testing.assert_array_equal(a, b, err_msg=k)


# ------------------------------------------------------------------ loaders


@pytest.mark.parametrize("downscale", [1, 2])
@pytest.mark.parametrize("mask_dtype", [np.uint8, np.float32])
def test_peoplesnapshot_train_matches_jax(tmp_path, downscale, mask_dtype):
    """Train mode: the edge sampler's rays and targets from the same numpy
    generator, three reads and the first two of ``train_iter``."""
    root = _peoplesnapshot(str(tmp_path / "ps"), np.random.default_rng(0),
                           mask_dtype)
    sampler = {"name": "edge", "num_sample": 96, "kernel_size": 8}
    cfg = {"dataroot": root, "opt": _opt("train", downscale,
                                         sampler=sampler)}
    td = TD.make("peoplesnapshot", wrap(cfg), split="train", mode="train",
                 rng=np.random.default_rng(3))
    jd = JP.PeopleSnapshotDataset(jwrap(cfg), split="train", mode="train",
                                  rng=np.random.default_rng(3))
    assert td.img_wh == jd.img_wh == (W // downscale, H // downscale)
    np.testing.assert_array_equal(td.betas, jd.betas)
    for idx in (0, 2, 1):
        _assert_batches_equal(td[idx], jd[idx])
    ti = td.train_iter(np.random.default_rng(9))
    ji = jd.train_iter(np.random.default_rng(9))
    for _ in range(2):
        (tb, tt), (jb, jt) = next(ti), next(ji)
        assert tt == jt
        # JAX's iterator hands out device arrays (int32 indices)
        _assert_batches_equal(tb, {k: np.asarray(v) for k, v in jb.items()},
                              dtypes=False)


@pytest.mark.parametrize("downscale", [1, 2])
@pytest.mark.parametrize("mode", ["val", "test"])
def test_peoplesnapshot_eval_matches_jax(tmp_path, mode, downscale):
    """Whole frames in val and test mode; the test HDRI on test batches;
    the packed ``thetas`` pose cache; the ``poses.npz`` fallback cut by
    start / end / skip."""
    rng = np.random.default_rng(1)
    root = _peoplesnapshot(str(tmp_path / "ps"), rng, packed=True)
    cfg = {"dataroot": root, "hdri_filepath": os.path.join(root, "sky.hdr"),
           "opt": _opt(mode, downscale)}
    td = TD.make("peoplesnapshot", wrap(cfg), split=mode, mode=mode)
    jd = JP.PeopleSnapshotDataset(jwrap(cfg), split=mode, mode=mode)
    assert len(td) == len(jd) == N_FRAMES
    for idx in range(N_FRAMES):
        _assert_batches_equal(td[idx], jd[idx])
    assert ("hdri" in td[0]) == (mode == "test")
    # no cache of the split: poses.npz, cut as the frames are
    os.remove(os.path.join(root, "poses", f"anim_nerf_{mode}.npz"))
    np.savez(os.path.join(root, "poses.npz"), **_poses(rng, 7))
    cfg["opt"] = _opt(mode, downscale, start=1, end=5, skip=2)
    td = TD.make("peoplesnapshot", wrap(cfg), split=mode, mode=mode)
    jd = JP.PeopleSnapshotDataset(jwrap(cfg), split=mode, mode=mode)
    assert len(td) == len(jd) == 3
    for idx in range(len(jd)):
        _assert_batches_equal(td.pose_batch(idx), jd.pose_batch(idx))
    _assert_batches_equal(td[0], jd[0])


@pytest.mark.parametrize("downscale", [1, 2])
@pytest.mark.parametrize("mode", ["train", "val", "test"])
@pytest.mark.parametrize("name", ["synthetichuman", "rana"])
def test_synthetichuman_extras_match_jax(tmp_path, name, mode, downscale):
    """GT albedo (16-bit PNGs for the RANA case, which the JAX rule divides
    by 255 too), normals, the dilated-bbox ``valid_mask`` and, in test
    mode, each frame's HDRI by ``hdri_files.json``; train mode samples
    rays from the same numpy generator and carries no extras."""
    root = _synthetichuman(str(tmp_path / name), np.random.default_rng(2),
                           albedo_bits=16 if name == "rana" else 8)
    sampler = {"name": "edge", "num_sample": 96, "kernel_size": 8}
    cfg = {"dataroot": root, "opt": _opt(mode, downscale, sampler=sampler)}
    td = TD.make(name, wrap(cfg), split=mode, mode=mode,
                 rng=np.random.default_rng(4))
    jcls = JH.RanaDataset if name == "rana" else JH.SyntheticHumanDataset
    jd = jcls(jwrap(cfg), split=mode, mode=mode,
              rng=np.random.default_rng(4))
    for idx in range(N_FRAMES):
        got, ref = td[idx], jd[idx]
        _assert_batches_equal(got, ref)
        assert ({"albedo", "normal", "valid_mask"} <= set(got)) \
            == (mode != "train")
        assert ("hdri" in got) == (mode == "test" and idx < 2)


def test_synthetichuman_refuses_an_exr_albedo(tmp_path):
    """An albedo in a format the port cannot read raises, naming it."""
    root = _synthetichuman(str(tmp_path / "sh"), np.random.default_rng(4))
    for i in range(N_FRAMES):
        os.remove(os.path.join(root, "albedo", f"albedo_{i:04d}.png"))
        with open(os.path.join(root, "albedo", f"albedo_{i:04d}.exr"),
                  "wb") as f:
            f.write(b"\x76\x2f\x31\x01")
    td = TD.make("synthetichuman", wrap({"dataroot": root,
                                         "opt": _opt("val", 1)}),
                 split="val", mode="val")
    with pytest.raises(NotImplementedError, match=r"\.exr"):
        td[0]


@pytest.mark.parametrize("downscale", [1, 2])
@pytest.mark.parametrize("cams", ["npz", "json"])
def test_animation_matches_jax(tmp_path, cams, downscale):
    """Predict mode: per-frame extrinsics from ``cameras.npz`` or the
    identity of ``cameras.json`` (1024^2, cut further here), the packed
    poses, the caller's betas or the poses' own, the HDRI on every
    frame."""
    rng = np.random.default_rng(5)
    root = str(tmp_path / "anim")
    os.makedirs(root)
    n = 5
    if cams == "npz":
        ext = np.stack([np.eye(4, dtype=np.float32)] * n)
        ext[:, :3, 3] = rng.normal(scale=0.1, size=(n, 3))
        np.savez(os.path.join(root, "cameras.npz"), height=np.full(n, 40),
                 width=np.full(n, 40), intrinsic=np.stack([np.eye(3)] * n),
                 extrinsic=ext)
        d = downscale
    else:
        with open(os.path.join(root, "cameras.json"), "w") as f:
            json.dump({}, f)
        d = 16 * downscale
    p = _poses(rng, n, packed=True)
    p["betas"] = p["betas"].reshape(10)
    np.savez(os.path.join(root, "poses.npz"), **p)
    hdri = os.path.join(root, "city.hdr")
    cv2.imwrite(hdri, (rng.random((8, 16, 3)) * 9).astype(np.float32))
    cfg = {"dataroot": root, "hdri_filepath": hdri,
           "opt": {"predict": {"start": 1, "end": -1, "skip": 2,
                               "downscale": d}}}
    for betas in (None, rng.normal(size=(1, 10)).astype(np.float32)):
        td = TD.make("animation", wrap(cfg), split="test", mode="predict",
                     betas=betas)
        jd = JA.AnimationDataset(jwrap(cfg), split="test", mode="predict",
                                 betas=betas)
        assert len(td) == len(jd) == 2 and td.img_wh == jd.img_wh
        for idx in range(len(jd)):
            _assert_batches_equal(td[idx], jd[idx])
        assert "rgb" not in td[0] and "hdri" in td[0]


# ------------------------------------------------------------------ SMPL


def smpl_file(path, rng, n_betas=12):
    """A synthetic SMPL model file from the synthetic body: ``posedirs
    [V, 3, 207]`` nonzero, ``J_regressor`` a scipy sparse matrix, more
    shape directions than the 10 kept, random faces."""
    body = TSMPL.make_synthetic_body_model()
    V = body.v_template.shape[0]
    d = {"v_template": body.v_template.astype(np.float64),
         "shapedirs": rng.normal(scale=0.01, size=(V, 3, n_betas)),
         "posedirs": rng.normal(scale=0.01, size=(V, 3, 207)),
         "J_regressor": scipy.sparse.csc_matrix(body.j_regressor),
         "weights": body.lbs_weights.astype(np.float64),
         "f": rng.integers(0, V, (2 * V, 3)).astype(np.uint32),
         "kintree_table": np.stack([TSMPL.PARENTS, np.arange(24)])}
    if path.endswith(".npz"):
        d["J_regressor"] = d["J_regressor"].toarray()
        np.savez(path, **d)
    else:
        with open(path, "wb") as f:
            pickle.dump(d, f, protocol=2)
    return path


@pytest.mark.parametrize("ext", [".pkl", ".npz"])
def test_load_body_model_matches_jax(tmp_path, ext):
    path = smpl_file(str(tmp_path / f"SMPL_NEUTRAL{ext}"),
                     np.random.default_rng(6))
    got = TSMPL.load_body_model(path)
    ref = JSMPL.load_body_model(path)
    for f in ("v_template", "shapedirs", "posedirs", "j_regressor",
              "lbs_weights", "parents", "faces"):
        a, b = getattr(got, f), getattr(ref, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert got.posedirs.shape == (207, got.v_template.shape[0] * 3)
    assert got.shapedirs.shape[-1] == 10 and np.abs(got.posedirs).max() > 0


def test_smpl_forward_and_statics_from_a_model_file(tmp_path):
    """``smpl_forward`` with nonzero pose blend shapes at a random pose, and
    the deformer's statics (canonical transforms, weight voxel, vertices,
    bbox) built from the file, within 1e-5 of JAX's."""
    rng = np.random.default_rng(7)
    path = smpl_file(str(tmp_path / "SMPL_MALE.pkl"), rng)
    body = TSMPL.load_body_model(path)
    betas = rng.normal(scale=0.5, size=10).astype(np.float32)
    pose = rng.normal(scale=0.3, size=72).astype(np.float32)
    transl = np.asarray([0.1, 0.2, 2.0], np.float32)
    ref = jax.jit(lambda b, p, g, t: JSMPL.smpl_forward(
        JSMPL.load_body_model(path), b, p, g, t))(
        jnp.asarray(betas), jnp.asarray(pose[3:]), jnp.asarray(pose[:3]),
        jnp.asarray(transl))
    t = lambda a: torch.as_tensor(a)
    got = TSMPL.smpl_forward(body, t(betas), t(pose[3:]), t(pose[:3]),
                             t(transl))
    posed_blend = np.abs(body.posedirs).sum() > 0
    assert posed_blend
    for f in ("vertices", "joints", "A"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(ref, f)), rtol=0,
                                   atol=SMPL_TOL, err_msg=f)
    dcfg = {"name": "fast-snarf", "model_path": path, "gender": "male",
            "deformer_config": {"resolution": 16}}
    jr = JSNARF(jwrap(dcfg))
    js = jr.initialize(betas)
    tr = FastSNARF(wrap(dcfg))
    ts = tr.initialize(betas, "cpu")
    for f in ("tfs_inv_t", "lbs_voxel", "vs_template"):
        np.testing.assert_allclose(getattr(ts, f).numpy(),
                                   np.asarray(getattr(js, f)), rtol=0,
                                   atol=SMPL_TOL, err_msg=f)
    np.testing.assert_allclose(tr.bbox, jr.bbox, rtol=0, atol=SMPL_TOL)


# ------------------------------------------------------------------ launcher


def test_launcher_trains_and_tests_peoplesnapshot(monkeypatch, tmp_path,
                                                  capsys):
    """The flagship's path at ``configs/tiny-synthetic.yaml``'s widths on
    the CPU: a PeopleSnapshot fixture and a synthetic SMPL ``.pkl``, 2 steps
    of 2 x 32 rays (``grad_accum: 2``) with a validation that writes its
    image grid, then ``--mode test`` from ``ckpt/final`` (2 frames at
    downscale 2), which writes each frame's grid, ``mesh.obj`` and the env
    map.  The test grids, the seed grids and the mesh's lattice are cut to
    16-32 (the launcher's 64^3, 96^3 and 256^3 take the CPU twins
    minutes)."""
    import glob
    from intrinsicavatar_tpu_torch import launch
    from intrinsicavatar_tpu_torch.train import evaluate as TE
    from intrinsicavatar_tpu_torch.utils.config import load_yaml
    from intrinsicavatar_tpu_torch.utils.image_io import read_hdr, read_png

    rng = np.random.default_rng(8)
    root = _peoplesnapshot(str(tmp_path / "ps"), rng)
    smpl = smpl_file(str(tmp_path / "SMPL_MALE.pkl"), rng)
    # a val split of one frame and a test split of two (their pose caches
    # as long as their frames, as the dataset's are)
    for split, n in (("val", 1), ("test", 2)):
        np.savez(os.path.join(root, "poses", f"anim_nerf_{split}.npz"),
                 **_poses(rng, n))
    build = TE.build_test_occ_grid
    monkeypatch.setattr(TE, "build_test_occ_grid", lambda *a, **k: build(
        *a, **{**k, "resolution": 16}))
    export = TE.export_canonical_mesh
    monkeypatch.setattr(TE, "export_canonical_mesh", lambda *a, **k: export(
        *a, **{**k, "resolution": 24}))
    cfg = load_yaml("configs/tiny-synthetic.yaml")
    cfg["model"]["deformer"]["rigid_deformer"]["model_path"] = smpl
    cfg["model"]["seed_grid_resolution"] = 16
    cfg["dataset"] = {
        "name": "peoplesnapshot", "dataroot": root,
        "opt": {"train": {"start": 0, "end": 2, "skip": 1,
                          "sampler": {"name": "edge", "num_sample": 64,
                                      "kernel_size": 8}},
                "val": {"start": 0, "end": 0, "skip": 1, "downscale": 2},
                "test": {"start": 0, "end": 1, "skip": 1, "downscale": 2}}}
    cfg["trainer"] = {"max_steps": 2, "grad_accum": 2,
                      "log_every_n_steps": 1, "check_val_every_n_steps": 1}
    yaml = tmp_path / "ps.yaml"
    yaml.write_text(json.dumps(cfg))
    common = ["--config", str(yaml), "--device", "cpu"]
    assert launch.main(["--mode", "train", *common, "--exp-dir",
                        str(tmp_path / "train")]) == 0
    (run,) = glob.glob(str(tmp_path / "train" / "*" / "*"))
    recs = [json.loads(x) for x in open(os.path.join(run, "metrics.jsonl"))]
    assert [r["step"] for r in recs if "total" in r] == [0, 1]
    assert all(np.isfinite(r["total"]) for r in recs if "total" in r)
    assert read_png(os.path.join(run, "val", "it1_f0.png")).shape \
        == (H // 2, 4 * (W // 2), 3)
    assert launch.main(["--mode", "test", *common, "--exp-dir",
                        str(tmp_path / "test"), "--resume",
                        os.path.join(run, "ckpt", "final")]) == 0
    (test,) = glob.glob(str(tmp_path / "test" / "*" / "*"))
    save = os.path.join(test, "save")
    for i in range(2):
        assert read_png(os.path.join(save, f"test_{i:04d}.png")).shape \
            == (H // 2, 4 * (W // 2), 3)
    lines = open(os.path.join(save, "mesh.obj")).read().splitlines()
    assert sum(x.startswith("v ") for x in lines) > 100
    assert sum(x.startswith("f ") for x in lines) > 100
    assert read_hdr(os.path.join(save, "envmap.hdr")).shape == (32, 64, 3)
    assert "mean:" in capsys.readouterr().out
