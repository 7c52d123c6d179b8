"""Kernels KB and KB''s plain twins (``intrinsicavatar_tpu_torch.ops.
encode_grad``) against the JAX ``encode_mlp_sdfgrad``, its custom VJP and
``VanillaMLP.value_and_input_grad`` (the kernels themselves:
``test_torch_kernels.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from intrinsicavatar_tpu.nets.mlp import VanillaMLP as JMLP
from intrinsicavatar_tpu.ops.encode_grad import encode_mlp_sdfgrad as j_fused
from intrinsicavatar_tpu.ops.hashgrid import HashGridSpec as JSpec
from intrinsicavatar_tpu_torch.nets.mlp import VanillaMLP as TMLP
from intrinsicavatar_tpu_torch.ops.encode_grad import (
    encode_mlp_sdfgrad, encode_mlp_sdfgrad_plain,
)
from intrinsicavatar_tpu_torch.ops.hashgrid import HashGridSpec as TSpec
from intrinsicavatar_tpu_torch.weights import from_jax_params


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Tier-1 runs six test workers on one host: keep each worker's torch
    pool small so it does not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# as tests/test_encode_grad.py:55-56: f32 on both sides, sums reassociated
FEAT_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-5, atol=1e-5)


class _Holder(torch.nn.Module):
    """Lets ``from_jax_params`` load a bare MLP (key prefix ``f.mlp``)."""

    def __init__(self, mlp):
        super().__init__()
        self.f = torch.nn.Module()
        self.f.mlp = mlp
        self.later_slices = {}


def _setup(include_xyz, masked, seed=0, n=257):
    kw = dict(n_levels=6, n_features_per_level=2, log2_hashmap_size=10,
              base_resolution=4, per_level_scale=1.9, include_xyz=include_xyz)
    jspec, tspec = JSpec(**kw), TSpec(**kw)
    jmlp = JMLP(jspec.n_output_dims, 13, n_neurons=32, n_hidden_layers=1,
                sphere_init=True, weight_norm=True)
    params = jmlp.init(jax.random.PRNGKey(seed))
    tmlp = TMLP(tspec.n_output_dims, 13, n_neurons=32, n_hidden_layers=1,
                sphere_init=True, weight_norm=True)
    from_jax_params(_Holder(tmlp), {"f": {"mlp": jax.tree.map(np.asarray,
                                                             params)}})
    rng = np.random.default_rng(seed)
    table = (rng.uniform(-1e-4, 1e-4, (6, 1024, 2)) * 1e3).astype(np.float32)
    x = rng.uniform(-0.15, 1.15, (n, 3)).astype(np.float32)
    lf = 12
    mask = ((np.arange(lf) < lf - 4) if masked else np.ones(lf)
            ).astype(np.float32)
    return jspec, tspec, jmlp, params, tmlp, table, x, mask


@pytest.mark.parametrize("include_xyz", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_twin_matches_jax_fused(include_xyz, masked):
    jspec, tspec, jmlp, params, tmlp, table, x, mask = _setup(include_xyz,
                                                              masked)
    feat_r, grad_r = j_fused(jspec, jmlp.value_and_input_grad,
                             jnp.asarray(table), params, jnp.asarray(x),
                             jnp.asarray(mask))
    with torch.no_grad():
        feat, grad = encode_mlp_sdfgrad(tspec, tmlp, torch.as_tensor(table),
                                        torch.as_tensor(x),
                                        torch.as_tensor(mask))
    np.testing.assert_allclose(feat.numpy(), np.asarray(feat_r), **FEAT_TOL)
    np.testing.assert_allclose(grad.numpy(), np.asarray(grad_r), **GRAD_TOL)


def test_twin_matches_jax_fused_at_published_widths():
    """The plain twin against the JAX op at the default model's widths:
    16 levels x 2 features, 2^19-row tables (dense and hashed levels), a
    35 -> 64 -> 13 sphere-init MLP with noise on its hash-feature rows (so
    every input reaches the gradient), a masked top level, 2,048 points
    inside and beyond [0, 1]^3."""
    kw = dict(n_levels=16, n_features_per_level=2, log2_hashmap_size=19,
              include_xyz=True)
    jspec, tspec = JSpec(**kw), TSpec(**kw)
    jmlp = JMLP(35, 13, n_neurons=64, n_hidden_layers=1, sphere_init=True,
                weight_norm=True)
    params = _perturbed(jax.jit(jmlp.init)(jax.random.PRNGKey(9)), 10)
    tmlp = TMLP(35, 13, n_neurons=64, n_hidden_layers=1, sphere_init=True,
                weight_norm=True)
    from_jax_params(_Holder(tmlp), {"f": {"mlp": params}})
    rng = np.random.default_rng(11)
    table = rng.uniform(-0.1, 0.1, (16, 1 << 19, 2)).astype(np.float32)
    x = rng.uniform(-0.15, 1.15, (2048, 3)).astype(np.float32)
    mask = (np.arange(32) < 30).astype(np.float32)
    feat_r, grad_r = j_fused(jspec, jmlp.value_and_input_grad,
                             jnp.asarray(table),
                             jax.tree.map(jnp.asarray, params),
                             jnp.asarray(x), jnp.asarray(mask))
    with torch.no_grad():
        feat, grad = encode_mlp_sdfgrad(tspec, tmlp, torch.as_tensor(table),
                                        torch.as_tensor(x),
                                        torch.as_tensor(mask))
    np.testing.assert_allclose(feat.numpy(), np.asarray(feat_r), **FEAT_TOL)
    # the gradient sums terms up to s_l ~ 2,000 times a corner difference
    # in f32, in another order than JAX: entries that cancel carry the
    # rounding of the large terms, so each is held within 1e-5 of the
    # largest entry (the sums' f32 rounding reads ~1e-6 of it)
    grad_r = np.asarray(grad_r)
    np.testing.assert_allclose(grad.numpy(), grad_r, rtol=1e-5,
                               atol=1e-5 * np.abs(grad_r).max())


def test_mlp_value_and_input_grad_matches_jax():
    _, _, jmlp, params, tmlp, _, _, _ = _setup(True, False)
    enc = np.random.default_rng(5).normal(size=(300, 15)).astype(np.float32)
    out_r, g_r = jmlp.value_and_input_grad(params, jnp.asarray(enc))
    with torch.no_grad():
        out, g = tmlp.value_and_input_grad(torch.as_tensor(enc))
        plain = tmlp(torch.as_tensor(enc))
    np.testing.assert_allclose(out.numpy(), np.asarray(out_r), **FEAT_TOL)
    np.testing.assert_allclose(plain.numpy(), np.asarray(out_r), **FEAT_TOL)
    np.testing.assert_allclose(g.numpy(), np.asarray(g_r), **GRAD_TOL)


def test_init_distributions_match_jax():
    """The port's own ``init`` draws from the JAX init's distributions."""
    jmlp = JMLP(35, 13, n_neurons=64, n_hidden_layers=1, sphere_init=True,
                weight_norm=True)
    jp = jmlp.init(jax.random.PRNGKey(0))
    tmlp = TMLP(35, 13, n_neurons=64, n_hidden_layers=1, sphere_init=True,
                weight_norm=True)
    tmlp.init(torch.Generator().manual_seed(0))
    for jl, tl in zip(jp, tmlp.layers):
        v, tv = np.asarray(jl["v"]), tl.v.detach().numpy()
        np.testing.assert_array_equal(v == 0, tv == 0)
        nz = v != 0
        # independent draws of >= 192 values: the sample moments agree to
        # well within 30% (the first layer's std has a ~5% standard error)
        np.testing.assert_allclose(tv[nz].mean(), v[nz].mean(), rtol=0.3,
                                   atol=0.3 * v[nz].std())
        np.testing.assert_allclose(tv[nz].std(), v[nz].std(), rtol=0.3)
        np.testing.assert_allclose(tl.g.detach().numpy(),
                                   np.linalg.norm(tv, axis=0, keepdims=True),
                                   rtol=1e-6)
        np.testing.assert_allclose(tl.b.detach().numpy(), np.asarray(jl["b"]))


def _perturbed(params, seed):
    """The sphere init zeroes the first layer's rows of the hash features;
    noise there puts every term of the backward to work."""
    rng = np.random.default_rng(seed)
    return [{k: np.asarray(v) + rng.normal(scale=0.3, size=np.shape(v))
             .astype(np.float32) for k, v in layer.items()}
            for layer in jax.tree.map(np.asarray, params)]


# the jitted JAX pullbacks, made once for the module (by width)
_PULLBACKS = {}


# f32 on both sides; the table cotangent is summed in another order (JAX
# sort-aggregates) and the MLP's VJP reassociates: each leaf within 1e-4 of
# its largest entry
def _close(a, b, name):
    b = np.asarray(b)
    np.testing.assert_allclose(np.asarray(a), b, rtol=0,
                               atol=1e-4 * max(np.abs(b).max(), 1e-12),
                               err_msg=name)


@pytest.mark.parametrize("include_xyz", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_backward_matches_jax_vjp(include_xyz, masked):
    """The Function's backward (pass 1, the MLP's VJP, pass 2) against
    ``jax.vjp`` of the JAX custom-VJP op, with random cotangents of both
    outputs; the weight-norm ``v``/``g``/``b`` gradients come through
    autograd from the effective weights."""
    jspec, tspec, jmlp, params, tmlp, table, x, mask = _setup(include_xyz,
                                                              masked, seed=4)
    params = _perturbed(params, 5)
    from_jax_params(_Holder(tmlp), {"f": {"mlp": params}})
    jparams = jax.tree.map(jnp.asarray, params)
    rng = np.random.default_rng(6)
    g_feat = rng.normal(size=(x.shape[0], 13)).astype(np.float32)
    g_grad = rng.normal(size=(x.shape[0], 3)).astype(np.float32)
    # one jit for each width (op by op, the first call of each op compiles)
    if include_xyz not in _PULLBACKS:
        _PULLBACKS[include_xyz] = jax.jit(lambda t, mp, p, m, cots: jax.vjp(
            lambda tt, mpp, pp: j_fused(jspec, jmlp.value_and_input_grad,
                                        tt, mpp, pp, m), t, mp, p)[1](cots))
    dt_r, dmlp_r, dx_r = _PULLBACKS[include_xyz](
        jnp.asarray(table), jparams, jnp.asarray(x), jnp.asarray(mask),
        (jnp.asarray(g_feat), jnp.asarray(g_grad)))
    t = torch.tensor(table, requires_grad=True)
    p = torch.tensor(x, requires_grad=True)
    feat, grad = encode_mlp_sdfgrad(tspec, tmlp, t, p, torch.as_tensor(mask))
    torch.autograd.backward((feat, grad), (torch.as_tensor(g_feat),
                                           torch.as_tensor(g_grad)))
    _close(t.grad, dt_r, "table")
    _close(p.grad, dx_r, "xn")
    assert np.abs(np.asarray(dt_r)).max() > 0
    for i, layer in enumerate(tmlp.layers):
        for k in ("v", "g", "b"):
            _close(getattr(layer, k).grad, dmlp_r[i][k], f"mlp.{i}.{k}")


def test_function_matches_autograd_of_twin():
    """The closed-form backward against autograd's second-order pass
    through the plain forward (``value_and_input_grad`` differentiated)."""
    _, tspec, _, params, tmlp, table, x, mask = _setup(True, True, seed=7)
    from_jax_params(_Holder(tmlp), {"f": {"mlp": _perturbed(params, 8)}})
    t = torch.tensor(table, requires_grad=True)
    p = torch.tensor(x, requires_grad=True)
    m = torch.as_tensor(mask)
    leaves = [t, p, *tmlp.parameters()]
    gen = torch.Generator().manual_seed(1)
    g_feat = torch.randn(x.shape[0], 13, generator=gen)
    g_grad = torch.randn(x.shape[0], 3, generator=gen)
    out = encode_mlp_sdfgrad(tspec, tmlp, t, p, m)
    d_fn = torch.autograd.grad(out, leaves, (g_feat, g_grad))
    out_ref = encode_mlp_sdfgrad_plain(tspec, tmlp, t, p, m,
                                       tmlp.effective_weights())
    d_ref = torch.autograd.grad(out_ref, leaves, (g_feat, g_grad))
    for a, b in zip(d_fn, d_ref):
        torch.testing.assert_close(a, b, rtol=1e-4,
                                   atol=1e-5 * float(b.abs().max()))


def _ray_points(rng, rays, samples):
    """``[rays * samples, 3]`` points in ray order inside [0, 1]^3: each
    ray's samples over 0.3, so neighbouring points share the dense levels'
    cells and rows."""
    o = rng.uniform(0.2, 0.8, (rays, 1, 3))
    d = rng.normal(size=(rays, 1, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t = np.linspace(-0.15, 0.15, samples)[None, :, None]
    return (o + t * d).reshape(-1, 3).astype(np.float32)


@pytest.mark.parametrize("masked", [False, True])
def test_backward_matches_jax_vjp_at_published_widths(masked):
    """The Function's backward (KB' pass 1, the MLP's VJP, pass 2) against
    ``jax.vjp`` of the JAX op at the default model's widths: 16 levels x 2
    features, 2^19-row tables, a 35 -> 64 -> 13 MLP with noise on every
    weight, 2,048 ray-ordered points (rows repeat along a ray at the dense
    levels, as pass 2's warps see them), all levels on or the top four off
    (the level mask's schedule)."""
    kw = dict(n_levels=16, n_features_per_level=2, log2_hashmap_size=19,
              include_xyz=True)
    jspec, tspec = JSpec(**kw), TSpec(**kw)
    jmlp = JMLP(35, 13, n_neurons=64, n_hidden_layers=1, sphere_init=True,
                weight_norm=True)
    params = _perturbed(jax.jit(jmlp.init)(jax.random.PRNGKey(12)), 13)
    tmlp = TMLP(35, 13, n_neurons=64, n_hidden_layers=1, sphere_init=True,
                weight_norm=True)
    from_jax_params(_Holder(tmlp), {"f": {"mlp": params}})
    rng = np.random.default_rng(14)
    table = rng.uniform(-0.1, 0.1, (16, 1 << 19, 2)).astype(np.float32)
    x = _ray_points(rng, 32, 64)
    mask = (np.arange(32) < (24 if masked else 32)).astype(np.float32)
    g_feat = rng.normal(size=(x.shape[0], 13)).astype(np.float32)
    g_grad = rng.normal(size=(x.shape[0], 3)).astype(np.float32)
    # under one jit for both cases: op by op, the pullback of the 64 MB
    # tables compiles each of its ops on its first call (~45 s on a CPU)
    if "published" not in _PULLBACKS:
        _PULLBACKS["published"] = jax.jit(lambda t, mp, p, m, cots: jax.vjp(
            lambda tt, mpp, pp: j_fused(jspec, jmlp.value_and_input_grad,
                                        tt, mpp, pp, m), t, mp, p)[1](cots))
    dt_r, dmlp_r, dx_r = _PULLBACKS["published"](
        jnp.asarray(table), jax.tree.map(jnp.asarray, params),
        jnp.asarray(x), jnp.asarray(mask),
        (jnp.asarray(g_feat), jnp.asarray(g_grad)))
    t = torch.tensor(table, requires_grad=True)
    p = torch.tensor(x, requires_grad=True)
    feat, grad = encode_mlp_sdfgrad(tspec, tmlp, t, p, torch.as_tensor(mask))
    torch.autograd.backward((feat, grad), (torch.as_tensor(g_feat),
                                           torch.as_tensor(g_grad)))
    _close(t.grad, dt_r, "table")
    _close(p.grad, dx_r, "xn")
    assert np.abs(np.asarray(dt_r)).max() > 0
    if masked:
        assert not t.grad[12:].any()
    for i, layer in enumerate(tmlp.layers):
        for k in ("v", "g", "b"):
            _close(getattr(layer, k).grad, dmlp_r[i][k], f"mlp.{i}.{k}")
