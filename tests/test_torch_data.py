"""The port's capsule ``synthetic-image`` dataset and its samplers against
the JAX package's (``data/capsule.py``, ``data/samplers.py``): the posed
joints and the sphere-traced GT maps, every key of the batches in train,
val and test mode (the sampled rays included), and each sampler from the
same numpy seed (the JAX package on ``cv2``'s erosion and dilation, the
port on scipy's filters)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from intrinsicavatar_tpu.data import capsule as JC
from intrinsicavatar_tpu.data import samplers as JS
from intrinsicavatar_tpu_torch import data as TD
from intrinsicavatar_tpu_torch.data import capsule as TC
from intrinsicavatar_tpu_torch.data import samplers as TS


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Tier-1 runs six test workers on one host: keep each worker's torch
    pool small so it does not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# The joints of both packages differ by an ulp where XLA's and torch's sin
# and cos round apart.  The GT normal is a central difference of the
# capsule SDF over 2e-3, whose terms carry the rounding of a world
# coordinate near |p| = 2.5 (2.4e-7 each): a joint an ulp apart moves a
# normal, and the rgb it shades, by up to 2 x 2.4e-7 / 2e-3 = 2.4e-4.
JOINT_TOL, MAP_TOL, OWN_JOINTS_MAP_TOL = 1e-5, 1e-5, 2.5e-4
MAPS = ("rgb", "albedo", "normal", "depth")


def test_capsule_body_matches_jax():
    """24 x 24 frames of 8 synthetic-trajectory poses: the port's posed
    joints within 1e-5 of JAX's; ``render_capsule_body`` at JAX's joints
    gives JAX's maps within 1e-5, the same alpha and the same hits; at the
    port's own joints the same alpha and the maps within the rounding of
    the finite-difference normal."""
    cfg = {"image_size": 24, "n_frames": 8}
    jd = JC.CapsuleImageDataset(dict(cfg), split="train", mode="val")
    td = TC.CapsuleImageDataset(dict(cfg), split="train", mode="val")
    assert np.abs(td.joints - jd.joints).max() <= JOINT_TOL
    rays = (td.rays_o.reshape(-1, 3), td.rays_d.reshape(-1, 3))
    np.testing.assert_array_equal(rays[0], jd.rays_o.reshape(-1, 3))
    np.testing.assert_array_equal(rays[1], jd.rays_d.reshape(-1, 3))
    hits = 0
    for i in range(len(jd)):
        ref = JC.render_capsule_body(jd.joints[i], *rays,
                                     albedos=jd.albedos)
        got = TC.render_capsule_body(jd.joints[i], *rays,
                                     albedos=td.albedos)
        own = TC.render_capsule_body(td.joints[i], *rays,
                                     albedos=td.albedos)
        assert set(got) == set(ref)
        for out in (got, own):
            np.testing.assert_array_equal(out["alpha"], ref["alpha"])
            np.testing.assert_array_equal(out["depth"] > 0,
                                          ref["depth"] > 0)
        for k in MAPS:
            np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=MAP_TOL,
                                       err_msg=k)
            np.testing.assert_allclose(own[k], ref[k], rtol=0,
                                       atol=OWN_JOINTS_MAP_TOL, err_msg=k)
        hits += int(ref["alpha"].sum())
    assert 0 < hits < 0.5 * len(jd) * 24 * 24


def _batches(ds):
    """Every frame's batch, then three of ``train_iter``."""
    out = [ds[i] for i in range(len(ds))]
    it = ds.train_iter()
    for _ in range(3):
        b, t_idx = next(it)
        out.append({**{k: np.asarray(v) for k, v in b.items()},
                    "t_idx": t_idx})
    return out


@pytest.mark.parametrize("mode", ["train", "val", "test"])
def test_capsule_batches_match_jax(mode):
    """``CapsuleImageDataset`` in ``mode`` (its own split, a 32 x 32 image,
    4 frames, the procedural test HDRI) from the same config and numpy
    seed: every key of every frame's batch and of three ``train_iter``
    batches equals JAX's (in train mode the edge sampler's rays and GT),
    with JAX's joints given to the port (the joints themselves:
    test_capsule_body_matches_jax)."""
    cfg = {"image_size": 32, "n_frames": 4, "hdri_filepath": "procedural",
           "n_rays": 64, "sampler": {"num_sample": 64, "kernel_size": 6}}
    jd = JC.CapsuleImageDataset(dict(cfg), split=mode, mode=mode,
                                rng=np.random.default_rng(5))
    td = TC.CapsuleImageDataset(dict(cfg), split=mode, mode=mode,
                                rng=np.random.default_rng(5))
    assert td.img_wh == jd.img_wh == (32, 32)
    assert len(td) == len(jd) == (2 if mode == "val" else 4)
    assert np.abs(td.joints - jd.joints).max() <= JOINT_TOL
    td.joints = jd.joints
    ref, got = _batches(jd), _batches(td)
    for i, (r, g) in enumerate(zip(ref, got)):
        assert set(g) == set(r)
        assert ("hdri" in g) == (mode == "test")
        for k, v in r.items():
            v = np.asarray(v)
            # JAX's train_iter hands out jnp arrays (int64 -> int32), the
            # port's numpy ones, as its synthetic dataset does
            if i < len(jd):
                assert np.asarray(g[k]).dtype == v.dtype, k
            np.testing.assert_array_equal(g[k], v, err_msg=k)
    # train mode samples 64 rays a frame, the others render whole frames
    assert got[0]["rays"].shape == ((64, 8) if mode == "train"
                                    else (32 * 32, 8))
    assert got[0]["alpha"].sum() > 0


def test_capsule_dataset_says_what_is_missing(tmp_path):
    """The registry builds ``synthetic-image`` and the real-data loaders,
    and lists what is ported for another name; a ``pose_path`` that does
    not exist falls back to the synthetic trajectories with a warning; an
    ``hdri_filepath`` that does not exist raises, an ``.hdr`` file is read
    as the JAX package reads it (by ``cv2``), and a format without a reader
    in the port raises and names it."""
    cv2 = pytest.importorskip("cv2")
    cfg = {"image_size": 16, "n_frames": 2}
    assert isinstance(TD.make("synthetic-image", dict(cfg), split="val",
                              mode="val"), TC.CapsuleImageDataset)
    with pytest.raises(KeyError, match="peoplesnapshot"):
        TD.make("zju_mocap", dict(cfg))
    missing = str(tmp_path / "poses.npz")
    with pytest.warns(UserWarning, match="synthetic trajectories"):
        td = TC.CapsuleImageDataset({**cfg, "pose_path": missing},
                                    split="val", mode="val")
    jd = JC.CapsuleImageDataset({**cfg, "pose_path": missing}, split="val",
                                mode="val")
    np.testing.assert_array_equal(td.body_pose, jd.body_pose)
    sky = str(tmp_path / "sky.hdr")
    with pytest.raises(FileNotFoundError, match="sky.hdr"):
        TC.CapsuleImageDataset({**cfg, "hdri_filepath": sky}, split="test",
                               mode="test")
    hdri = (np.random.default_rng(5).random((8, 16, 3)) ** 3 * 20)
    cv2.imwrite(sky, hdri.astype(np.float32))
    args = ({**cfg, "hdri_filepath": sky},)
    np.testing.assert_array_equal(
        TC.CapsuleImageDataset(*args, split="test", mode="test").hdri,
        JC.CapsuleImageDataset(*args, split="test", mode="test").hdri)
    exr = tmp_path / "sky.exr"
    exr.write_bytes(b"\x76\x2f\x31\x01")
    with pytest.raises(NotImplementedError, match=r"\.exr"):
        TC.CapsuleImageDataset({**cfg, "hdri_filepath": str(exr)},
                               split="test", mode="test")


def _mask(rng):
    """A 40 x 37 mask: a block with a ragged, noisy edge."""
    m = np.zeros((40, 37), np.float32)
    m[8:30, 6:25] = 1.0
    m[rng.random(m.shape) < 0.05] = 1.0
    m[rng.random(m.shape) < 0.05] = 0.0
    return m


@pytest.mark.parametrize("k", [6, 16])
@pytest.mark.parametrize("name", ["edge", "uniform", "balanced", "patch"])
def test_sampler_matches_jax(name, k):
    """``make_sampler`` of each name, from the same numpy seed: four draws
    of the mask and two maps equal JAX's (the edge band and the patch
    sampler's dilation at kernel size ``k``, even as the configs' 6, 12
    and 16 are)."""
    assert JS.cv2 is not None, "the JAX side runs cv2's morphology here"
    cfg = {"name": name, "num_sample": 96, "kernel_size": k,
           "ratio_mask": 0.5, "num_patch": 3, "patch_size": 8, "dilate": k}
    rng = np.random.default_rng(k)
    mask = _mask(rng)
    rgb = rng.random((40, 37, 3)).astype(np.float32)
    vm = (rng.random((40, 37, 1)) < 0.8).astype(np.float32)
    js = JS.make_sampler(cfg, rng=np.random.default_rng(3))
    ts = TS.make_sampler(cfg, rng=np.random.default_rng(3))
    assert type(ts).__name__ == type(js).__name__
    for _ in range(4):
        ref = js.sample(mask, rgb, vm)
        got = ts.sample(mask, rgb, vm)
        assert len(got) == len(ref) == 3
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g, r)
    if name == "edge":
        np.testing.assert_array_equal(TS._erode(mask, k),
                                      JS._erode(mask, k))
        np.testing.assert_array_equal(TS._dilate(mask, k),
                                      JS._dilate(mask, k))
