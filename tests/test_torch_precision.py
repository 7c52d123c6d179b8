"""The bf16 compute scope of the port (``intrinsicavatar_tpu_torch.ops.
precision``) against the JAX package's (``ops/precision.py``): the scope
stack, KA's and KB's twins in their bf16-row forms, and the backward, whose
dtypes follow JAX's (the fused op's custom-VJP backward in float32, the
autodiff MLP's cotangents rounded to bf16 at the casts).  The render, train
and secondary-pass checks at bf16 are parametrized cases of
``test_torch_render.py``, ``test_torch_train.py`` and
``test_torch_pbr.py``; the kernels' bf16 forms are held against these twins
on a card in ``test_torch_kernels.py``.

Both sides round the same operands to bf16 and sum in float32, in other
orders; a sum that lands within a float32 rounding of a bf16 rounding
boundary rounds to the neighbouring bf16 value on one side (one bf16 ulp,
2^-8 relative).  So each comparison states a bulk tolerance, held by nearly
every entry, and a worst-case one, both from what these tests measured.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from intrinsicavatar_tpu.nets.mlp import VanillaMLP as JMLP
from intrinsicavatar_tpu.ops import hashgrid as JH
from intrinsicavatar_tpu.ops import precision as JP
from intrinsicavatar_tpu.ops.encode_grad import encode_mlp_sdfgrad as j_fused
from intrinsicavatar_tpu_torch.nets.mlp import VanillaMLP as TMLP
from intrinsicavatar_tpu_torch.ops import hashgrid as TH
from intrinsicavatar_tpu_torch.ops import precision as TP
from intrinsicavatar_tpu_torch.ops.encode_grad import encode_mlp_sdfgrad
from intrinsicavatar_tpu_torch.weights import from_jax_params


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Tier-1 runs six test workers on one host: keep each worker's torch
    pool small so it does not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


BF16 = jnp.bfloat16
# relative to the largest entry of the reference: the bulk (float32 sums in
# another order; measured 1.4e-6 at most) on 99.9% of the entries, the
# worst case one bf16 ulp (2^-8) of it, what one rounding flip of an
# operand can move an entry by (measured 3.1e-6: the flips are rare)
BULK, WORST = (2e-6, 0.999), 2.0 ** -8


class _Holder(torch.nn.Module):
    """Lets ``from_jax_params`` load a bare MLP (key prefix ``f.mlp``)."""

    def __init__(self, mlp):
        super().__init__()
        self.f = torch.nn.Module()
        self.f.mlp = mlp
        self.later_slices = {}


def _bf16_exact(a) -> bool:
    """Every entry of ``a`` is a bf16 value (its low 16 bits are zero)."""
    return not np.any(np.asarray(a, np.float32).view(np.uint32) & 0xFFFF)


def _hold(got, ref, bulk, worst, share, what):
    """``got`` within ``bulk`` of ``ref`` on at least ``share`` of the
    entries and within ``worst`` on every one (both relative to the
    largest entry of ``ref``)."""
    got, ref = np.asarray(got), np.asarray(ref)
    err = np.abs(got - ref) / max(np.abs(ref).max(), 1e-30)
    assert float(np.mean(err <= bulk)) >= share, (
        what, float(np.mean(err <= bulk)), float(err.max()))
    assert float(err.max()) <= worst, (what, float(err.max()))


def test_scope_stack():
    """As ``tests/test_precision.py::test_scope_stack``, over torch dtypes;
    the configs' two names are accepted and any other value refused."""
    assert TP.current_dtype() is None
    with TP.scope("bfloat16"):
        assert TP.current_dtype() is torch.bfloat16
        with TP.scope(None):
            assert TP.current_dtype() is None
        with TP.scope("float32"):
            assert TP.current_dtype() is None
        assert TP.current_dtype() is torch.bfloat16
    assert TP.current_dtype() is None
    x = torch.ones(3)
    assert TP.cast_in(x) is x
    with TP.scope(torch.bfloat16):
        assert TP.cast_in(x).dtype == torch.bfloat16
    for bad in ("float16", torch.float16, "bf16"):
        with pytest.raises(ValueError):
            with TP.scope(bad):
                pass
    assert TP.current_dtype() is None


def test_cast_table_once_per_version():
    """The bf16 table is made once per version of the table: a second call
    returns the same tensor, an in-place update (an optimizer step) a new
    one with the new values; outside a scope the table itself."""
    t = torch.nn.Parameter(torch.randn(2, 64, 2))
    assert TP.cast_table(t) is t
    with TP.scope("bfloat16"):
        a = TP.cast_table(t)
        assert a.dtype == torch.bfloat16 and TP.cast_table(t) is a
        torch.testing.assert_close(a, t.detach().to(torch.bfloat16),
                                   rtol=0, atol=0)
        opt = torch.optim.Adam([t], lr=0.5)
        t.grad = torch.ones_like(t)
        opt.step()
        b = TP.cast_table(t)
        assert b is not a
        torch.testing.assert_close(b, t.detach().to(torch.bfloat16),
                                   rtol=0, atol=0)


def test_ka_twin_matches_jax_in_scope():
    """KA's twin in its bf16-row form against ``hashgrid_encode_raw`` under
    JAX's scope at the published widths (16 levels x 2 features, 2^19
    tables: 5 dense and 11 hashed levels) on a trained-scale table
    N(0, 0.1), 4,096 points, a few far outside, two levels masked."""
    kw = dict(n_levels=16, n_features_per_level=2, log2_hashmap_size=19,
              base_resolution=16, include_xyz=True)
    jspec, tspec = JH.HashGridSpec(**kw), TH.HashGridSpec(**kw)
    rng = np.random.default_rng(21)
    table = rng.normal(0.0, 0.1, (16, 1 << 19, 2)).astype(np.float32)
    x = rng.uniform(-0.15, 1.15, (4096, 3)).astype(np.float32)
    x[:64] = rng.choice([-50.0, -2.0, 2.0, 50.0], (64, 3))
    mask = np.ones(32, np.float32)
    mask[[4, 5, 30, 31]] = 0.0
    with JP.scope(BF16):
        ref = np.asarray(JH.hashgrid_encode_raw(
            jnp.asarray(table), jnp.asarray(x), jspec, jnp.asarray(mask)))
    t = torch.as_tensor(table)
    with TP.scope("bfloat16"):
        out = TH.hashgrid_encode(t, torch.as_tensor(x), tspec,
                                 torch.as_tensor(mask)).numpy()
    assert ref.dtype == np.float32 and out.dtype == np.float32
    # the same bf16 rows and float32 blends on both sides: the 8-corner
    # sum's order (an einsum in JAX for dense levels) is the only
    # difference (measured: 3.0e-8 at most, 95% of entries equal)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)
    f32 = TH.hashgrid_encode(t, torch.as_tensor(x), tspec,
                             torch.as_tensor(mask)).numpy()
    # the scope moved the features by the table's rounding (measured
    # 9.7e-4 at most), far beyond the sums' order
    assert np.abs(f32 - out).max() > 1e-4


def _mlp_pair(n_in, n_hidden, seed):
    """A sphere-init, weight-normed SDF MLP of the JAX package, its
    parameters with noise on every entry (the sphere init zeroes the rows of
    the hash features), and the port's MLP carrying them."""
    jmlp = JMLP(n_in, 13, n_neurons=n_hidden, n_hidden_layers=1,
                sphere_init=True, weight_norm=True)
    rng = np.random.default_rng(seed)
    params = [{k: np.asarray(v) + rng.normal(scale=0.3, size=np.shape(v))
               .astype(np.float32) for k, v in layer.items()}
              for layer in jax.tree.map(np.asarray,
                                        jmlp.init(jax.random.PRNGKey(seed)))]
    tmlp = TMLP(n_in, 13, n_neurons=n_hidden, n_hidden_layers=1,
                sphere_init=True, weight_norm=True)
    from_jax_params(_Holder(tmlp), {"f": {"mlp": params}})
    return jmlp, jax.tree.map(jnp.asarray, params), tmlp


def test_kb_twin_matches_jax_in_scope():
    """KB's twin (``feat``, ``grad``) under the scope against JAX's
    ``encode_mlp_sdfgrad`` under its scope, weight norm on: 6 levels (dense
    and hashed) x 2 features with the xyz columns, a 15 -> 32 -> 13 MLP
    with noise on every weight, 257 points inside and beyond the box, two
    levels masked."""
    jspec, tspec, jmlp, jparams, tmlp, table, x, mask = _small_fused(22)

    def fused(t, mp, p, m):
        with JP.scope(BF16):
            return j_fused(jspec, jmlp.value_and_input_grad, t, mp, p, m)

    # under jit (op by op, its first call compiles each op: ~10 s)
    feat_r, grad_r = (np.asarray(a) for a in jax.jit(fused)(
        jnp.asarray(table), jparams, jnp.asarray(x), jnp.asarray(mask)))
    with torch.no_grad(), TP.scope("bfloat16"):
        feat, grad = (a.numpy() for a in encode_mlp_sdfgrad(
            tspec, tmlp, torch.as_tensor(table), torch.as_tensor(x),
            torch.as_tensor(mask)))
    _hold(feat, feat_r, *BULK, WORST, "feat")
    _hold(grad, grad_r, *BULK, WORST, "grad")
    with torch.no_grad():
        f32 = encode_mlp_sdfgrad(tspec, tmlp, torch.as_tensor(table),
                                 torch.as_tensor(x), torch.as_tensor(mask))
    # the scope moved both outputs far beyond the bulk tolerance
    assert np.abs(f32[0].numpy() - feat).max() > 1e-3 * np.abs(feat).max()
    assert np.abs(f32[1].numpy() - grad).max() > 1e-3 * np.abs(grad).max()


def _small_fused(seed):
    """Inputs of the fused op at small widths: specs, the MLP pair, a table
    N(0, 0.1), points inside and beyond the box, the top level masked."""
    kw = dict(n_levels=6, n_features_per_level=2, log2_hashmap_size=10,
              base_resolution=4, per_level_scale=1.9, include_xyz=True)
    jspec, tspec = JH.HashGridSpec(**kw), TH.HashGridSpec(**kw)
    jmlp, jparams, tmlp = _mlp_pair(15, 32, seed)
    rng = np.random.default_rng(seed + 1)
    table = rng.normal(0.0, 0.1, (6, 1024, 2)).astype(np.float32)
    x = rng.uniform(-0.15, 1.15, (257, 3)).astype(np.float32)
    mask = (np.arange(12) < 10).astype(np.float32)
    return jspec, tspec, jmlp, jparams, tmlp, table, x, mask


def test_fused_backward_matches_jax_in_scope(monkeypatch):
    """The fused op's gradients under the scope against ``jax.vjp`` under
    JAX's, leaf by leaf (table, point, the weight-norm ``v``/``g``/``b``).
    A probe of ``precision.cast_in`` shows the finding the port follows:
    JAX's forward gathers under bf16, its custom-VJP backward (traced at
    transposition, after the ``with`` block) sees no scope and regathers
    float32 rows."""
    jspec, tspec, jmlp, jparams, tmlp, table, x, mask = _small_fused(24)
    seen = []
    cast = JP.cast_in
    monkeypatch.setattr(JP, "cast_in", lambda a: (
        seen.append(JP.current_dtype()), cast(a))[1])
    rng = np.random.default_rng(25)
    g_feat = rng.normal(size=(x.shape[0], 13)).astype(np.float32)
    g_grad = rng.normal(size=(x.shape[0], 3)).astype(np.float32)

    def fused(t, mp, p):
        with JP.scope(BF16):
            return j_fused(jspec, jmlp.value_and_input_grad, t, mp, p,
                           jnp.asarray(mask))

    n_fwd = []

    def pullback(t, mp, p, cots):
        _, vjp = jax.vjp(fused, t, mp, p)
        n_fwd.append(len(seen))
        return vjp(cots)

    dt_r, dmlp_r, dx_r = jax.jit(pullback)(
        jnp.asarray(table), jparams, jnp.asarray(x),
        (jnp.asarray(g_feat), jnp.asarray(g_grad)))
    # the forward's 6 level gathers under bf16, the backward's after them
    # with no scope
    n = n_fwd[0]
    assert n == 6 and all(d == jnp.dtype(BF16) for d in seen[:n])
    assert len(seen) > n and all(d is None for d in seen[n:])

    t = torch.tensor(table, requires_grad=True)
    p = torch.tensor(x, requires_grad=True)
    with TP.scope("bfloat16"):
        feat, grad = encode_mlp_sdfgrad(tspec, tmlp, t, p,
                                        torch.as_tensor(mask))
    torch.autograd.backward((feat, grad), (torch.as_tensor(g_feat),
                                           torch.as_tensor(g_grad)))
    # the backward is float32 on both sides; its cotangents come from the
    # bf16 forward (measured: 1.3e-6 at most)
    _hold(t.grad, dt_r, *BULK, WORST, "table")
    _hold(p.grad, dx_r, *BULK, WORST, "xn")
    for i, layer in enumerate(tmlp.layers):
        for k in ("v", "g", "b"):
            _hold(getattr(layer, k).grad, dmlp_r[i][k], *BULK, WORST,
                  f"mlp.{i}.{k}")


def test_vanilla_mlp_backward_matches_jax_in_scope():
    """A scoped two-hidden-layer ReLU ``VanillaMLP`` (the radiance head's
    kind): its forward and, by autograd, every weight gradient and the
    input cotangent against ``jax.grad`` under JAX's scope.  JAX's
    transposes of the scoped dot round there to bf16, and so do the port's
    casts: every weight gradient and the input cotangent are bf16 values on
    both sides."""
    jmlp = JMLP(32, 3, n_neurons=64, n_hidden_layers=2)
    jparams = jmlp.init(jax.random.PRNGKey(26))
    tmlp = TMLP(32, 3, n_neurons=64, n_hidden_layers=2)
    from_jax_params(_Holder(tmlp),
                    {"f": {"mlp": jax.tree.map(np.asarray, jparams)}})
    rng = np.random.default_rng(27)
    x = rng.normal(0.0, 0.5, (512, 32)).astype(np.float32)
    ct = rng.normal(size=(512, 3)).astype(np.float32)

    def loss(params, xx):
        with JP.scope(BF16):
            return jnp.sum(jmlp(params, xx) * ct)

    out_r = np.asarray(jax.jit(lambda p, xx: _scoped(jmlp, p, xx))(
        jparams, jnp.asarray(x)))
    g_r, gx_r = jax.jit(jax.grad(loss, argnums=(0, 1)))(jparams,
                                                        jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    with TP.scope("bfloat16"):
        out = tmlp(xt)
    (out * torch.as_tensor(ct)).sum().backward()
    # measured: out 6.3e-8; the input cotangent one flip of 3.1e-6 (one
    # entry in 16,384), the weight gradients equal
    _hold(out.detach(), out_r, *BULK, WORST, "out")
    assert _bf16_exact(xt.grad) and _bf16_exact(gx_r)
    _hold(xt.grad, gx_r, *BULK, WORST, "x")
    for i, layer in enumerate(tmlp.layers):
        assert _bf16_exact(layer.w.grad) and _bf16_exact(g_r[i]["w"])
        _hold(layer.w.grad, g_r[i]["w"], *BULK, WORST, f"mlp.{i}.w")
        # the bias add stays float32: its gradient is not rounded
        _hold(layer.b.grad, g_r[i]["b"], *BULK, WORST, f"mlp.{i}.b")


def _scoped(mlp, params, x):
    with JP.scope(BF16):
        return mlp(params, x)
