"""Kernels KA and KA''s plain twins (``intrinsicavatar_tpu_torch.ops.
hashgrid``) against the JAX ``hashgrid_encode_raw`` and the VJP of
``hashgrid_encode`` (the kernels themselves are held against their twins on
a card in ``test_torch_kernels.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from intrinsicavatar_tpu.ops import hashgrid as JH
from intrinsicavatar_tpu_torch.ops import hashgrid as TH


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Tier-1 runs six test workers on one host: keep each worker's torch
    pool small so it does not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# both sides run the same f32 gathers and blends; the tolerance covers the
# order of the 8-corner sum (an einsum in JAX for dense levels)
RTOL, ATOL = 1e-5, 1e-6


def _spec(include_xyz, mod):
    return mod.HashGridSpec(n_levels=6, n_features_per_level=2,
                            log2_hashmap_size=10, base_resolution=4,
                            per_level_scale=1.9, include_xyz=include_xyz)


def _inputs(include_xyz, masked, seed=0, n=257):
    spec = _spec(include_xyz, JH)
    assert spec.dense_levels.any() and not spec.dense_levels.all()
    rng = np.random.default_rng(seed)
    table = (rng.uniform(-1e-4, 1e-4, (6, 1024, 2)) * 1e3).astype(np.float32)
    # in-domain and out-of-domain points reach both border clamps
    x = rng.uniform(-0.15, 1.15, (n, 3)).astype(np.float32)
    lf = 12
    mask = ((np.arange(lf) < lf - 4) if masked else np.ones(lf)
            ).astype(np.float32)
    return table, x, mask


@pytest.mark.parametrize("include_xyz", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_twin_matches_jax(include_xyz, masked):
    table, x, mask = _inputs(include_xyz, masked)
    ref = JH.hashgrid_encode_raw(jnp.asarray(table), jnp.asarray(x),
                                 _spec(include_xyz, JH), jnp.asarray(mask))
    out = TH.hashgrid_encode(torch.as_tensor(table), torch.as_tensor(x),
                             _spec(include_xyz, TH), torch.as_tensor(mask))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)


def test_specs_agree():
    for include_xyz in (False, True):
        js, ts = _spec(include_xyz, JH), _spec(include_xyz, TH)
        np.testing.assert_array_equal(js.resolutions, ts.resolutions)
        np.testing.assert_array_equal(js.dense_levels, ts.dense_levels)
        assert js.n_output_dims == ts.n_output_dims


def test_hash_of_large_coordinates_matches_uint32():
    """The int64 hash agrees with uint32 arithmetic at the largest
    resolution the default grid reaches."""
    rng = np.random.default_rng(3)
    c = rng.integers(0, 2 ** 16, (3, 1000))
    T = 1 << 19
    ref = np.asarray(JH._hash_corner_idx(*(jnp.asarray(v, jnp.int32)
                                           for v in c), T))
    h = TH.corner_rows([torch.as_tensor(v) for v in c], 1 << 17, False, T)
    np.testing.assert_array_equal(h[:, 0].numpy(), ref)


def _border_points(x, spec, rng):
    """Replace a third of the points by points in the last cell of each
    dense level's grid (corners +1 clamp onto the cell's own row) and just
    outside the domain."""
    n = x.shape[0] // 3
    x = x.copy()
    x[:n] = rng.uniform(0.985, 1.0, (n, 3))
    x[n // 2:n, 1] = rng.uniform(-0.02, 0.0, n - n // 2)
    return x


# the table cotangent sums the same w_k * g terms in another order (JAX
# sort-aggregates, index_add_ adds in point order): tolerances relative to
# each leaf's largest entry
@pytest.mark.parametrize("include_xyz", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_bwd_twin_matches_jax_vjp(include_xyz, masked):
    table, x, mask = _inputs(include_xyz, masked, seed=1)
    rng = np.random.default_rng(2)
    x = _border_points(x, _spec(include_xyz, JH), rng).astype(np.float32)
    jspec, tspec = _spec(include_xyz, JH), _spec(include_xyz, TH)
    g = rng.normal(size=(x.shape[0], jspec.n_output_dims)).astype(np.float32)
    _, vjp = jax.vjp(lambda t, p: JH.hashgrid_encode(t, p, jspec,
                                                     jnp.asarray(mask)),
                     jnp.asarray(table), jnp.asarray(x))
    dt_r, dx_r = (np.asarray(a) for a in vjp(jnp.asarray(g)))
    dt, dx = TH.hashgrid_encode_bwd_plain(
        torch.as_tensor(table), torch.as_tensor(x), tspec, torch.as_tensor(g),
        torch.as_tensor(mask))
    np.testing.assert_allclose(dt.numpy(), dt_r, rtol=0,
                               atol=1e-5 * np.abs(dt_r).max())
    np.testing.assert_allclose(dx.numpy(), dx_r, rtol=0,
                               atol=1e-5 * np.abs(dx_r).max())
    if masked:       # masked levels get no table gradient
        assert not dt[4:].any()
    _, dx_none = TH.hashgrid_encode_bwd_plain(
        torch.as_tensor(table), torch.as_tensor(x), tspec, torch.as_tensor(g),
        torch.as_tensor(mask), need_x=False)
    assert dx_none is None


def test_autograd_function_matches_autograd_of_twin():
    """The encode's ``autograd.Function`` (closed-form backward) against
    autograd through the plain forward."""
    table, x, mask = _inputs(True, True, seed=3)
    spec = _spec(True, TH)
    t = torch.tensor(table, requires_grad=True)
    p = torch.tensor(x, requires_grad=True)
    m = torch.as_tensor(mask)
    g = torch.randn(x.shape[0], spec.n_output_dims,
                    generator=torch.Generator().manual_seed(0))
    out = TH.hashgrid_encode(t, p, spec, m)
    d_fn = torch.autograd.grad(out, (t, p), g)
    out_ref = TH.hashgrid_encode_plain(t, p, spec, m)
    torch.testing.assert_close(out, out_ref, rtol=0, atol=0)
    d_ref = torch.autograd.grad(out_ref, (t, p), g)
    for a, b in zip(d_fn, d_ref):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    # only the table asks for a gradient: d_x is not computed
    out = TH.hashgrid_encode(t, p.detach(), spec, m)
    (d_t,) = torch.autograd.grad(out, (t,), g)
    torch.testing.assert_close(d_t, d_fn[0])


@pytest.mark.parametrize("include_xyz", [False, True])
def test_twin_matches_jax_at_published_widths(include_xyz):
    """The published grid (16 levels x 2 features, 2^19 tables, base 16,
    scale 1.4473: 5 dense and 11 hashed levels) on 4,096 points, a quarter
    outside the unit box and a few far outside, with two levels masked."""
    kw = dict(n_levels=16, n_features_per_level=2, log2_hashmap_size=19,
              base_resolution=16, include_xyz=include_xyz)
    jspec, tspec = JH.HashGridSpec(**kw), TH.HashGridSpec(**kw)
    assert jspec.dense_levels.sum() == 5
    rng = np.random.default_rng(4)
    table = rng.uniform(-0.1, 0.1, (16, 1 << 19, 2)).astype(np.float32)
    x = rng.uniform(-0.15, 1.15, (4096, 3)).astype(np.float32)
    x[:64] = rng.choice([-50.0, -2.0, 2.0, 50.0], (64, 3))
    mask = np.ones(32, np.float32)
    mask[[4, 5, 30, 31]] = 0.0
    ref = JH.hashgrid_encode_raw(jnp.asarray(table), jnp.asarray(x), jspec,
                                 jnp.asarray(mask))
    out = TH.hashgrid_encode(torch.as_tensor(table), torch.as_tensor(x),
                             tspec, torch.as_tensor(mask))
    assert out.shape == (4096, 35 if include_xyz else 32)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)


def test_bwd_twin_matches_jax_vjp_at_published_widths():
    """KA''s twin against the JAX VJP at the published grid (16 levels x 2
    features, 2^19 tables, base 16, scale 1.4473, with the xyz columns) on
    2,048 points: a third at the dense levels' last cells and just outside
    the box, a few far outside, two levels masked."""
    kw = dict(n_levels=16, n_features_per_level=2, log2_hashmap_size=19,
              base_resolution=16, include_xyz=True)
    jspec, tspec = JH.HashGridSpec(**kw), TH.HashGridSpec(**kw)
    rng = np.random.default_rng(5)
    table = rng.uniform(-0.1, 0.1, (16, 1 << 19, 2)).astype(np.float32)
    x = rng.uniform(-0.15, 1.15, (2048, 3))
    x = _border_points(x, jspec, rng)
    x[-32:] = rng.choice([-50.0, -2.0, 2.0, 50.0], (32, 3))
    x = x.astype(np.float32)
    mask = np.ones(32, np.float32)
    mask[[4, 5, 30, 31]] = 0.0
    g = rng.normal(size=(2048, 35)).astype(np.float32)
    # under jit: op by op, the 64 MB table's pullback takes ~30 s on a CPU
    pullback = jax.jit(lambda t, p, m, gg: jax.vjp(
        lambda tt, pp: JH.hashgrid_encode(tt, pp, jspec, m), t, p)[1](gg))
    dt_r, dx_r = (np.asarray(a) for a in pullback(
        jnp.asarray(table), jnp.asarray(x), jnp.asarray(mask),
        jnp.asarray(g)))
    dt, dx = TH.hashgrid_encode_bwd_plain(
        torch.as_tensor(table), torch.as_tensor(x), tspec, torch.as_tensor(g),
        torch.as_tensor(mask))
    # the same tolerances as test_bwd_twin_matches_jax_vjp
    np.testing.assert_allclose(dt.numpy(), dt_r, rtol=0,
                               atol=1e-5 * np.abs(dt_r).max())
    np.testing.assert_allclose(dx.numpy(), dx_r, rtol=0,
                               atol=1e-5 * np.abs(dx_r).max())
    assert not dt[2].any() and not dt[15].any()       # levels masked off
    assert dt[:5].any() and dt[5:15].any()            # dense and hashed
