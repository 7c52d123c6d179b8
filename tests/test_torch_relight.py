"""The port's relight slice as a whole against the JAX package (set-up in
``relight_setup.py``): the eval forward with the PBR stage at step 25,000
in the ``uniform_light`` render mode (the others: ``test_torch_relight_
sampled.py`` and ``test_torch_relight_mis.py``), then the albedo alignment
pre-pass on a synthetic albedo and the frame's metrics."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import relight_setup as RS
from intrinsicavatar_tpu.render.renderer import RenderFlags as JFlags
from intrinsicavatar_tpu.train import evaluate as JE
from intrinsicavatar_tpu_torch.train import evaluate as TE


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Tier-1 runs six test workers on one host: keep each worker's torch
    pool small so it does not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    return RS.make_setup()


@pytest.mark.parametrize("mode", ["uniform_light"])
def test_relight_forward_matches_jax(setup, mode):
    RS.check_mode(setup, mode)


def test_render_frame_with_albedo_ratio_matches_jax(setup):
    """The relighting protocol: the albedo-only pre-pass fits one ratio per
    channel against a synthetic albedo, and the full render uses it."""
    s = setup
    R = RS.R
    albedo = s["rng"].uniform(0.2, 0.8, (R, 3)).astype(np.float32)
    alpha = (s["rng"].random(R) < 0.8).astype(np.float32)
    jb = {**s["jb"], "albedo": jnp.asarray(albedo),
          "alpha": jnp.asarray(alpha)}
    tb = {**s["tb"], "albedo": torch.as_tensor(albedo),
          "alpha": torch.as_tensor(alpha)}
    jflags = JFlags(training=False, enable_phys=True, importance_sample=True,
                    randomized=False)
    j_ratio = JE.fit_albedo_ratio(s["system"], s["jp"], jb, RS.STEP,
                                  jax.random.PRNGKey(4), jflags,
                                  ray_chunk=RS.CHUNK, occ=s["jocc"],
                                  frame=s["jframe"], cond=s["jcond"])
    flags = TE.eval_flags(s["cfg"].model, RS.STEP)
    t_ratio = TE.fit_albedo_ratio(s["model"], s["statics"], tb, RS.STEP,
                                  flags, ray_chunk=RS.CHUNK, occ=s["occ"],
                                  frame=s["frame"], cond=s["cond"])
    np.testing.assert_allclose(t_ratio.numpy(), np.asarray(j_ratio),
                               rtol=1e-4)
    assert not np.allclose(t_ratio.numpy(), 1.0)
    jo, to = RS.render(s, "uniform_light", jax.random.PRNGKey(5),
                       ratio=np.asarray(j_ratio))
    RS.compare(jo, to, RS.PHYS + ("visibility",))
    batch = {"rgb": np.ones((R, 3), np.float32), "albedo": albedo,
             "alpha": alpha}
    m = TE.frame_metrics(to, batch, albedo_prealigned=True)
    jm = JE.frame_metrics({k: np.asarray(v) for k, v in jo.items()
                           if k != "counters"}, batch,
                          albedo_prealigned=True)
    for k in ("psnr", "psnr_phys", "albedo_psnr"):
        assert abs(m[k] - jm[k]) < 1e-3, k
