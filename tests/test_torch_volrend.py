"""Kernels KD and KD''s plain twins (``intrinsicavatar_tpu_torch.ops.
volrend``) against the JAX ``alpha_from_sdf``, ``render_weight_from_alpha``
and ``accumulate_along_rays`` and their VJP (the kernels themselves:
``test_torch_kernels.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from intrinsicavatar_tpu.ops import volrend as JV
from intrinsicavatar_tpu_torch.ops import volrend as TV


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Tier-1 runs six test workers on one host: keep each worker's torch
    pool small so it does not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# elementwise f32 math and one scan per row on both sides
TOL = dict(rtol=0.0, atol=1e-6)


def _inputs(seed=0, R=64, S=161):
    rng = np.random.default_rng(seed)
    sdf = rng.normal(scale=0.3, size=(R, S)).astype(np.float32)
    sdf[:, ::7] = 0.0                       # exact zeros hit sign(0)
    sdf[0, :] = 1e5                         # the compaction fill
    dists = rng.uniform(0.0, 0.05, (R, S)).astype(np.float32)
    mask = rng.random((R, S)) < 0.6
    mask[1] = False                         # a ray with no sample
    rgb = rng.random((R, S, 3)).astype(np.float32)
    normal = rng.normal(size=(R, S, 3)).astype(np.float32)
    mids = np.cumsum(dists, -1).astype(np.float32) + 1.0
    beta = np.float32(0.05)
    return sdf, dists, beta, mask, rgb, normal, mids


@pytest.mark.parametrize("S", [161, 4, 145])
def test_weights_twin_matches_jax(S):
    """At the row lengths the path uses (a shader chunk's 4, an importance
    round's 145, and 161), with a fully masked row and NaN at masked
    slots, which read as alpha 0."""
    sdf, dists, beta, mask, *_ = _inputs(R=64, S=S)
    alphas = np.array(JV.alpha_from_sdf(jnp.asarray(sdf), jnp.asarray(dists),
                                        jnp.asarray(beta)))
    alphas[~mask] = np.nan
    w_r, t_r = JV.render_weight_from_alpha(jnp.asarray(alphas),
                                           jnp.asarray(mask))
    w, t = TV.render_weight_from_alpha(torch.as_tensor(alphas),
                                       torch.as_tensor(mask))
    np.testing.assert_allclose(w.numpy(), np.asarray(w_r), **TOL)
    np.testing.assert_allclose(t.numpy(), np.asarray(t_r), **TOL)
    assert not mask[1].any() and not w[1].any() and bool((t[1] == 1).all())
    assert np.isnan(alphas).any() and torch.isfinite(w).all()


def test_composite_twin_matches_jax():
    sdf, dists, beta, mask, rgb, normal, mids = _inputs(1)
    j = [jnp.asarray(a) for a in (sdf, dists, beta, mask, rgb, normal, mids)]
    alpha_r = JV.alpha_from_sdf(j[0], j[1], j[2])
    w_r, _ = JV.render_weight_from_alpha(alpha_r, j[3])
    ref = [jnp.where(j[3], alpha_r, 0.0), w_r,
           JV.accumulate_along_rays(w_r, j[4], j[3]),
           JV.accumulate_along_rays(w_r, j[5], j[3]),
           JV.accumulate_along_rays(w_r, None, j[3]),
           JV.accumulate_along_rays(w_r, j[6][..., None], j[3])]
    out = TV.composite(*(torch.as_tensor(a) for a in
                         (sdf, dists, beta, mask, rgb, normal, mids)))
    for name, a, b in zip(("alpha", "weights", "rgb", "normal", "opacity",
                           "depth"), out, ref):
        # depth sums ~160 terms of size ~1: allow their f32 rounding
        tol = dict(rtol=1e-6, atol=1e-6) if name != "depth" else \
            dict(rtol=1e-6, atol=1e-5)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name,
                                   **tol)


def _edge_inputs(seed):
    """The cases the backward must get right: a fully masked ray, rays whose
    alpha reaches 1 (deep inside, long intervals), exact zeros of the SDF
    and the compaction fill."""
    sdf, dists, beta, mask, rgb, normal, mids = _inputs(seed, R=24, S=40)
    sdf[2, 10:] = -2.0
    dists[2, 10:] = 5.0                    # alpha == 1 from sample 10 on
    sdf[3, :] = -0.5
    dists[3, :] = 0.3                      # alpha close to 1 everywhere
    mask[1] = False                        # no valid sample
    return sdf, dists, beta, mask, rgb, normal, mids


def _jax_composite(sdf, dists, beta, mask, rgb, normal, mids):
    alpha = jnp.where(mask, JV.alpha_from_sdf(sdf, dists, beta), 0.0)
    w, _ = JV.render_weight_from_alpha(alpha, mask)
    return (w, JV.accumulate_along_rays(w, rgb, mask),
            JV.accumulate_along_rays(w, normal, mask),
            JV.accumulate_along_rays(w, None, mask),
            JV.accumulate_along_rays(w, mids[..., None], mask))


def test_bwd_twin_matches_jax_vjp():
    """``composite_bwd_plain`` against ``jax.vjp`` of the JAX composite,
    with random cotangents of the weights, rgb, normal, opacity and depth."""
    sdf, dists, beta, mask, rgb, normal, mids = _edge_inputs(2)
    assert (sdf == 0).any()
    rng = np.random.default_rng(3)
    R, S = sdf.shape
    cots = [rng.normal(size=s).astype(np.float32)
            for s in ((R, S), (R, 3), (R, 3), (R, 1), (R, 1))]
    _, vjp = jax.vjp(
        lambda s, b, c, n: _jax_composite(s, jnp.asarray(dists), b,
                                          jnp.asarray(mask), c, n,
                                          jnp.asarray(mids)),
        jnp.asarray(sdf), jnp.asarray(beta), jnp.asarray(rgb),
        jnp.asarray(normal))
    ref = [np.asarray(a) for a in vjp(tuple(jnp.asarray(c) for c in cots))]
    t = lambda a: torch.as_tensor(a)
    d_sdf, d_beta, d_rgb, d_normal = TV.composite_bwd_plain(
        t(sdf), t(dists), t(beta), t(mask), t(rgb), t(normal), t(mids),
        *(t(c) for c in cots))
    # elementwise f32 math and one scan per row; beta's cotangent sums
    # ~900 terms
    for name, a, b in (("sdf", d_sdf, ref[0]), ("rgb", d_rgb, ref[2]),
                       ("normal", d_normal, ref[3])):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-5,
                                   atol=1e-5 * np.abs(b).max(), err_msg=name)
    np.testing.assert_allclose(float(d_beta.sum()), float(ref[1]), rtol=1e-4)
    assert not d_sdf[1].any() and not d_sdf[~mask].any()
    assert not d_sdf[sdf == 0].any()
    assert np.isfinite(d_sdf.numpy()).all()


def test_function_matches_autograd_of_twin():
    """The composite's ``autograd.Function`` against autograd through
    ``composite_plain``."""
    sdf, dists, beta, mask, rgb, normal, mids = _edge_inputs(4)
    leaves = [torch.tensor(a, requires_grad=True)
              for a in (sdf, np.asarray(beta), rgb, normal)]
    s, b, c, n = leaves
    rest = dict(dists=torch.as_tensor(dists), mask=torch.as_tensor(mask),
                mids=torch.as_tensor(mids))
    out = TV.composite(s, rest["dists"], b, rest["mask"], c, n, rest["mids"])
    assert not out[0].requires_grad          # alpha carries no gradient
    gen = torch.Generator().manual_seed(2)
    cots = [torch.randn(o.shape, generator=gen) for o in out[1:]]
    d_fn = torch.autograd.grad(out[1:], leaves, cots)
    ref = TV.composite_plain(s, rest["dists"], b, rest["mask"], c, n,
                             rest["mids"])
    d_ref = torch.autograd.grad(ref[1:], leaves, cots)
    for a, r in zip(d_fn, d_ref):
        torch.testing.assert_close(a, r, rtol=1e-4,
                                   atol=1e-5 * float(r.abs().max()))
