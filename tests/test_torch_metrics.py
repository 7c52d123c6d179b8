"""The port's eval metrics against the JAX package's (``utils/metrics.py``,
``utils/lpips_jax.py``, ``train/evaluate.py:frame_metrics``): SSIM (whole
and cropped to a mask's bbox), the normal error, ``frame_metrics`` with the
image size, and LPIPS-VGG on random weights read from an ``.npz``; and a
launcher run of ``configs/tiny-capsule.yaml`` on the CPU, whose in-training
validation reports them."""

import glob
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from intrinsicavatar_tpu.data import capsule as JC
from intrinsicavatar_tpu.train import evaluate as JE
from intrinsicavatar_tpu.utils import lpips_jax
from intrinsicavatar_tpu.utils import metrics as JM
from intrinsicavatar_tpu_torch.train import evaluate as TE
from intrinsicavatar_tpu_torch.utils import lpips as TL
from intrinsicavatar_tpu_torch.utils import metrics as TM
from intrinsicavatar_tpu_torch.utils.image_io import read_png


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Tier-1 runs six test workers on one host: keep each worker's torch
    pool small so it does not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# the metrics are the same float64 numpy on both sides; LPIPS runs its VGG
# in float32 (XLA's convolutions against torch's)
TOL, LPIPS_TOL = 1e-10, 1e-5
W = H = 32


@pytest.fixture(scope="module")
def frame():
    """A 32 x 32 val frame of the capsule dataset as the GT, and a render
    of it: the GT with noise, random normals and albedo."""
    gt = JC.CapsuleImageDataset({"image_size": W, "n_frames": 4},
                                split="val", mode="val")[0]
    rng = np.random.default_rng(2)
    n = W * H
    nrm = gt["normal"] + rng.normal(scale=0.3, size=(n, 3))
    out = {"comp_rgb_full": np.clip(gt["rgb"] + rng.normal(
               scale=0.1, size=(n, 3)), 0.0, 1.0),
           "comp_rgb_phys_full": rng.random((n, 3)),
           "comp_normal": nrm,
           "comp_albedo_full": rng.random((n, 3)) * 0.8,
           "opacity": rng.random((n, 1))}
    out = {k: v.astype(np.float32) for k, v in out.items()}
    return gt, out


@pytest.fixture(scope="module")
def lpips_weights(tmp_path_factory):
    """Random VGG16 / LPIPS weights from a numpy seed, in the ``.npz``
    layout both packages read."""
    rng = np.random.default_rng(4)
    z, cin, i = {}, 3, 0
    for spec in lpips_jax._VGG16:
        if spec == "M":
            continue
        z[f"conv{i}_w"] = (rng.normal(size=(3, 3, cin, spec))
                           / np.sqrt(9 * cin)).astype(np.float32)
        z[f"conv{i}_b"] = rng.normal(scale=0.05, size=spec).astype(
            np.float32)
        cin, i = spec, i + 1
    for j, t in enumerate(lpips_jax._TAPS):
        z[f"lin{j}_w"] = rng.random(z[f"conv{t}_w"].shape[-1]).astype(
            np.float32)
    path = str(tmp_path_factory.mktemp("lpips") / "vgg.npz")
    np.savez(path, **z)
    return path


def test_ssim_and_normal_error_match_jax(frame):
    """``ssim`` (three channels, one, another data range),
    ``cropped_ssim`` to the GT mask's bbox, ``bbox_of_mask`` and
    ``normal_angular_error_deg`` (with and without a mask) equal JAX's
    within 1e-10."""
    gt, out = frame
    pred = out["comp_rgb_full"].reshape(H, W, 3)
    ref = gt["rgb"].reshape(H, W, 3)
    mask = gt["alpha"].reshape(H, W) > 0
    assert 0 < mask.sum() < mask.size
    pairs = [
        (TM.ssim(pred, ref), JM.ssim(pred, ref)),
        (TM.ssim(pred[..., 0], ref[..., 0]), JM.ssim(pred[..., 0],
                                                     ref[..., 0])),
        (TM.ssim(pred, ref, data_range=2.0), JM.ssim(pred, ref,
                                                     data_range=2.0)),
        (TM.cropped_ssim(pred, ref, mask), JM.cropped_ssim(pred, ref, mask)),
        (TM.normal_angular_error_deg(out["comp_normal"], gt["normal"]),
         JM.normal_angular_error_deg(out["comp_normal"], gt["normal"])),
        (TM.normal_angular_error_deg(out["comp_normal"], gt["normal"],
                                     gt["alpha"] > 0),
         JM.normal_angular_error_deg(out["comp_normal"], gt["normal"],
                                     gt["alpha"] > 0))]
    for got, want in pairs:
        assert abs(got - want) <= TOL, (got, want)
    assert TM.bbox_of_mask(mask) == JM.bbox_of_mask(mask)
    empty = np.zeros((H, W), bool)
    assert TM.bbox_of_mask(empty) == JM.bbox_of_mask(empty) == (0, H, 0, W)
    assert all(0.0 < got < 1.0 for got, _ in pairs[:4])
    assert pairs[3][0] != pairs[0][0]


def _metrics_match(got, ref):
    assert set(got) == set(ref)
    for k, v in ref.items():
        tol = LPIPS_TOL if k == "lpips" else TOL
        np.testing.assert_allclose(got[k], v, rtol=0, atol=tol, err_msg=k)


def test_frame_metrics_match_jax(frame, lpips_weights, monkeypatch):
    """``frame_metrics(out, batch, img_wh)`` of both packages, with and
    without the albedo re-alignment: JAX's keys (``ssim``,
    ``normal_error_deg``, ``albedo_scale`` where it re-aligns), equal
    within 1e-10; with LPIPS weights also ``lpips``, within 1e-5; without
    the image size neither SSIM nor LPIPS."""
    gt, out = frame
    for prealigned in (False, True):
        got = TE.frame_metrics(out, gt, (W, H), albedo_prealigned=prealigned)
        ref = JE.frame_metrics(out, gt, (W, H), albedo_prealigned=prealigned)
        assert {"psnr", "ssim", "psnr_phys", "normal_error_deg",
                "albedo_psnr"} <= set(got)
        assert ("albedo_scale" in got) != prealigned
        _metrics_match(got, ref)
    _metrics_match(TE.frame_metrics(out, gt), JE.frame_metrics(out, gt))
    assert "ssim" not in TE.frame_metrics(out, gt)
    monkeypatch.setenv("INTRINSICAVATAR_LPIPS_WEIGHTS", lpips_weights)
    monkeypatch.setattr(TE, "_LPIPS_FN", "unset")
    monkeypatch.setattr(JE, "_LPIPS_FN", "unset")
    got = TE.frame_metrics(out, gt, (W, H))
    _metrics_match(got, JE.frame_metrics(out, gt, (W, H)))
    assert got["lpips"] > 0


def test_lpips_matches_jax(lpips_weights, monkeypatch, capsys):
    """The port's LPIPS-VGG on the weights read back through
    ``INTRINSICAVATAR_LPIPS_WEIGHTS`` equals ``lpips_jax.lpips_distance``
    on the same weights within 1e-5 at 32 x 32 (two pairs of images;
    zero for an image against itself); without weights ``lpips_fn`` is
    None and the frame metrics say so."""
    monkeypatch.delenv("INTRINSICAVATAR_LPIPS_WEIGHTS", raising=False)
    assert TL.lpips_fn() is None and TM.lpips_fn() is None
    monkeypatch.setattr(TE, "_LPIPS_FN", "unset")
    assert TE._lpips_cached() is None
    assert "no LPIPS-VGG weights" in capsys.readouterr().err
    monkeypatch.setenv("INTRINSICAVATAR_LPIPS_WEIGHTS", lpips_weights)
    fn = TL.lpips_fn()
    params = lpips_jax.load_weights(lpips_weights)
    rng = np.random.default_rng(5)
    a, b = rng.random((2, 2, H, W, 3)).astype(np.float32)
    ref = np.asarray(lpips_jax.lpips_distance(
        params, jnp.asarray(a) * 2 - 1, jnp.asarray(b) * 2 - 1))
    got = [fn(x, y) for x, y in zip(a, b)]
    np.testing.assert_allclose(got, ref, rtol=0, atol=LPIPS_TOL)
    assert min(got) > 1e-3
    assert abs(fn(a[0], a[0])) < 1e-6


def test_launcher_trains_tiny_capsule(monkeypatch, tmp_path, capsys):
    """``configs/tiny-capsule.yaml`` through the launcher on the CPU, cut to
    2 steps on 32 x 32 images with the validation after the second (its
    test grids at 16^3 and, since a ``--config`` run validates by the
    default eval path as JAX's does, its seed grid at 16^3: the launcher's
    64^3 and 96^3 take the CPU twins minutes): the losses are finite, the
    validation reports the JAX package's image metrics, ``ssim`` and
    ``normal_error_deg`` among them, and writes its image grid."""
    from intrinsicavatar_tpu_torch import launch
    build = TE.build_test_occ_grid
    monkeypatch.setattr(TE, "build_test_occ_grid", lambda *a, **k: build(
        *a, **{**k, "resolution": 16}))
    args = ["--mode", "train", "--config", "configs/tiny-capsule.yaml",
            "--device", "cpu", "--exp-dir", str(tmp_path),
            "trainer.max_steps=2", "trainer.check_val_every_n_steps=1",
            "trainer.log_every_n_steps=1", "dataset.image_size=32",
            "model.seed_grid_resolution=16"]
    assert launch.main(args) == 0
    assert "[val @ 1]" in capsys.readouterr().out
    (run,) = glob.glob(str(tmp_path / "tiny-capsule" / "*" /
                           "metrics.jsonl"))
    recs = [json.loads(x) for x in open(run)]
    steps = [r for r in recs if "total" in r]
    assert [r["step"] for r in steps] == [0, 1]
    assert all(np.isfinite(r["total"]) for r in steps)
    (val,) = [r for r in recs if "val/psnr" in r]
    assert val["step"] == 1
    for k in ("psnr", "ssim", "normal_error_deg"):
        assert np.isfinite(val[f"val/{k}"]), k
    assert 0.0 < val["val/ssim"] < 1.0
    assert 0.0 < val["val/normal_error_deg"] < 180.0
    (grid,) = glob.glob(str(tmp_path / "tiny-capsule" / "*" / "val" /
                            "it1_f0.png"))
    assert read_png(grid).shape == (32, 128, 3)
