"""``VanillaMLP`` with the reference's sphere initialization, Softplus(100)
and weight normalization, and the material head's ``LipschitzMLP``
(counterpart of the JAX package's ``nets/mlp.py``).

Weights are stored ``[in, out]`` as in JAX, so the parameter tree carries
over unchanged (``weights.from_jax_params``).  ``VanillaMLP``'s products
honor the scoped compute dtype (``ops/precision.py``, :func:`matmul`);
``LipschitzMLP`` stays float32, as in JAX.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from intrinsicavatar_tpu_torch.ops import precision
from intrinsicavatar_tpu_torch.ops.math import get_activation


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in the scoped compute dtype (the JAX ``_matmul``,
    ``nets/mlp.py:29-37``).  Inside a bf16 scope both operands are rounded
    to bf16 and multiplied with float32 accumulation and a float32 result:
    on the card by one bf16 GEMM with a float32 output (``torch.mm``'s
    ``out_dtype``: one cast an operand, where a float32 GEMM of the rounded
    operands takes two and reads twice the bytes; PERF.md, PR 17), on the
    CPU by a float32 GEMM of the rounded operands (a bf16 x bf16 product is
    exact in float32, so both are JAX's dot up to summation order).  The
    cotangents of ``x`` and ``w`` are rounded to bf16, as JAX's transposes
    of the scoped dot round them (autograd does so at the casts)."""
    d = precision.current_dtype()
    if d is None:
        return x @ w
    if x.is_cuda:
        return _LowMatmul.apply(x, w, d)
    return x.to(d).to(torch.float32) @ w.to(d).to(torch.float32)


class _LowMatmul(torch.autograd.Function):
    """``x @ w`` with both operands rounded to ``dtype`` by one GEMM with a
    float32 result; the backward's cotangents are float32 products rounded
    to ``dtype``, as the JAX transposes of the scoped dot compute them."""

    @staticmethod
    def forward(ctx, x, w, dtype):
        xl, wl = x.to(dtype), w.to(dtype)
        ctx.save_for_backward(xl, wl)
        return torch.mm(xl, wl, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, ct):
        xl, wl = ctx.saved_tensors
        f32 = torch.float32
        d_x = d_w = None
        if ctx.needs_input_grad[0]:
            d_x = (ct @ wl.to(f32).T).to(xl.dtype).to(f32)
        if ctx.needs_input_grad[1]:
            d_w = (xl.to(f32).T @ ct).to(wl.dtype).to(f32)
        return d_x, d_w, None


def softplus100(x: torch.Tensor) -> torch.Tensor:
    """``softplus(100 x) / 100`` written as JAX writes it
    (``logaddexp(y, 0)``), without ``F.softplus``'s threshold of 20."""
    y = 100.0 * x
    return (torch.clamp(y, min=0.0) + torch.log1p(torch.exp(-torch.abs(y)))) \
        / 100.0


class _Layer(nn.Module):
    def __init__(self, d_in: int, d_out: int, weight_norm: bool):
        super().__init__()
        self.weight_norm = weight_norm
        if weight_norm:
            self.v = nn.Parameter(torch.zeros(d_in, d_out))
            self.g = nn.Parameter(torch.zeros(1, d_out))
        else:
            self.w = nn.Parameter(torch.zeros(d_in, d_out))
        self.b = nn.Parameter(torch.zeros(d_out))

    def effective_w(self) -> torch.Tensor:
        if self.weight_norm:
            norm = torch.linalg.vector_norm(self.v, dim=0, keepdim=True)
            return self.g * self.v / torch.clamp(norm, min=1e-12)
        return self.w


class VanillaMLP(nn.Module):
    """ReLU/Softplus MLP; sphere-init makes the raw output an approximate
    signed distance to a sphere of ``sphere_init_radius``."""

    def __init__(self, dim_in: int, dim_out: int, n_neurons: int = 64,
                 n_hidden_layers: int = 1, sphere_init: bool = False,
                 sphere_init_radius: float = 0.5, weight_norm: bool = False,
                 output_activation=None):
        super().__init__()
        self.dim_in, self.dim_out = dim_in, dim_out
        self.sphere_init = sphere_init
        self.sphere_init_radius = sphere_init_radius
        self.weight_norm = weight_norm
        self.output_activation = get_activation(output_activation)
        self.dims = [dim_in] + [n_neurons] * n_hidden_layers + [dim_out]
        self.layers = nn.ModuleList(
            _Layer(self.dims[i], self.dims[i + 1], weight_norm)
            for i in range(len(self.dims) - 1))

    @torch.no_grad()
    def init(self, generator: torch.Generator):
        """The distributions of the JAX ``VanillaMLP.init``."""
        n = len(self.layers)
        for i, layer in enumerate(self.layers):
            d_in, d_out = self.dims[i], self.dims[i + 1]
            normal = lambda *s: torch.randn(s, generator=generator)
            b = torch.zeros(d_out)
            if self.sphere_init:
                if i == n - 1:
                    w = normal(d_in, d_out) * 1e-4 \
                        + math.sqrt(math.pi) / math.sqrt(d_in)
                    b = torch.full((d_out,), -self.sphere_init_radius)
                elif i == 0:
                    w = torch.zeros(d_in, d_out)
                    w[:3] = normal(min(3, d_in), d_out) \
                        * math.sqrt(2) / math.sqrt(d_out)
                else:
                    w = normal(d_in, d_out) * math.sqrt(2) / math.sqrt(d_out)
            else:
                bound = math.sqrt(6.0 / d_in)
                w = (torch.rand(d_in, d_out, generator=generator) * 2 - 1) \
                    * bound
            dev = layer.b.device
            if self.weight_norm:
                layer.v.copy_(w.to(dev))
                layer.g.copy_(torch.linalg.vector_norm(w, dim=0,
                                                       keepdim=True).to(dev))
            else:
                layer.w.copy_(w.to(dev))
            layer.b.copy_(b.to(dev))

    def act(self, x):
        return softplus100(x) if self.sphere_init else torch.relu(x)

    def effective_weights(self):
        """``[(W [in, out], b [out]), ...]`` with weight norm applied."""
        return [(layer.effective_w(), layer.b) for layer in self.layers]

    def forward(self, x):
        ws = self.effective_weights()
        for i, (w, b) in enumerate(ws):
            x = matmul(x, w) + b
            if i < len(ws) - 1:
                x = self.act(x)
        return self.output_activation(x)

    def value_and_input_grad(self, x, out_channel: int = 0, weights=None):
        """Forward pass + d out[..., out_channel] / d input by manual
        backprop (its products in the scoped compute dtype, as the
        forward's).  Returns ``(out [N, dim_out], grad [N, dim_in])``."""
        ws = self.effective_weights() if weights is None else weights
        z = x
        pre = []
        for w, b in ws[:-1]:
            h = matmul(z, w) + b
            pre.append(h)
            z = self.act(h)
        out = matmul(z, ws[-1][0]) + ws[-1][1]
        g = ws[-1][0][:, out_channel][None, :].expand(x.shape[0], -1)
        for i in range(len(ws) - 2, -1, -1):
            if self.sphere_init:
                dact = torch.sigmoid(100.0 * pre[i])
            else:
                dact = (pre[i] > 0).to(x.dtype)
            g = matmul(g * dact, ws[i][0].T)
        return self.output_activation(out), g

    def pair_vjp(self, x, weights, g_out, g_grad, out_channel: int = 0):
        """Vector-Jacobian product of :meth:`value_and_input_grad` (the
        ``jax.vjp`` step of the JAX ``encode_mlp_sdfgrad`` backward,
        ``ops/encode_grad.py:271-275``): pulls the cotangents ``(g_out,
        g_grad)`` of ``(out, grad)`` back to the weights and to ``x``.

        Returns ``([(d_W, d_b), ...], d_x, grad)``, all without history."""
        with torch.enable_grad():
            x = x.detach().requires_grad_()
            ws = [(w.detach().requires_grad_(), b.detach().requires_grad_())
                  for w, b in weights]
            out, grad = self.value_and_input_grad(x, out_channel, ws)
            flat = [t for pair in ws for t in pair]
            d = torch.autograd.grad((out, grad), flat + [x],
                                    (g_out, g_grad))
        d_w = list(zip(d[:-1:2], d[1:-1:2]))
        return d_w, d[-1], grad.detach()


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``log(1 + exp(x))`` as JAX writes it (``logaddexp(x, 0)``)."""
    return torch.logaddexp(x, torch.zeros_like(x))


class _LipschitzLayer(nn.Module):
    def __init__(self, d_in: int, d_out: int):
        super().__init__()
        self.w = nn.Parameter(torch.zeros(d_in, d_out))
        self.b = nn.Parameter(torch.zeros(d_out))
        self.c = nn.Parameter(torch.zeros(1))

    def normalized_w(self) -> torch.Tensor:
        """Columns scaled so each output unit's absolute row sum stays
        below ``softplus(c)``."""
        absrowsum = torch.sum(torch.abs(self.w), 0)
        scale = torch.clamp(softplus(self.c) / absrowsum, max=1.0)
        return self.w * scale[None, :]


class LipschitzMLP(nn.Module):
    """ReLU MLP with a learnable per-layer Lipschitz bound
    (`nets/mlp.py:255-305` of the JAX package, `models/network_utils.py:
    360-431` of the reference); weights ``[in, out]`` as in JAX."""

    def __init__(self, dim_in: int, dim_out: int, n_neurons: int = 64,
                 n_hidden_layers: int = 2, output_activation=None):
        super().__init__()
        self.dims = [dim_in] + [n_neurons] * n_hidden_layers + [dim_out]
        self.output_activation = get_activation(output_activation)
        self.layers = nn.ModuleList(
            _LipschitzLayer(a, b) for a, b in zip(self.dims[:-1],
                                                  self.dims[1:]))

    @torch.no_grad()
    def init(self, generator: torch.Generator):
        """The distributions of the JAX ``LipschitzMLP.init``: ``w`` and
        ``b`` uniform in +-1/sqrt(in), ``c`` twice the largest absolute
        column sum of ``w``."""
        for layer, d_in in zip(self.layers, self.dims[:-1]):
            bound = 1.0 / math.sqrt(d_in)
            w = (torch.rand(layer.w.shape, generator=generator) * 2 - 1) \
                * bound
            b = (torch.rand(layer.b.shape, generator=generator) * 2 - 1) \
                * bound
            layer.w.copy_(w.to(layer.w.device))
            layer.b.copy_(b.to(layer.b.device))
            layer.c.fill_(float(torch.sum(torch.abs(w), 0).max()) * 2.0)

    def forward(self, x):
        n = len(self.layers)
        for i, layer in enumerate(self.layers):
            x = x @ layer.normalized_w() + layer.b
            if i < n - 1:
                x = torch.relu(x)
        return self.output_activation(x)

    def lipschitz_bound(self) -> torch.Tensor:
        """Mean of the product of the layers' ``softplus(c)``."""
        bound = 1.0
        for layer in self.layers:
            bound = bound * softplus(layer.c)
        return torch.mean(bound)


def make_mlp(dim_in: int, dim_out: int, config):
    """Factory mirroring ``get_mlp`` (`models/network_utils.py:468-483`)."""
    otype = config.get("otype", "VanillaMLP")
    if otype in ("LipshitzMLP", "LipschitzMLP"):
        return LipschitzMLP(
            dim_in, dim_out, n_neurons=config.get("n_neurons", 64),
            n_hidden_layers=config.get("n_hidden_layers", 2),
            output_activation=config.get("output_activation"))
    if otype != "VanillaMLP":
        raise ValueError(f"mlp otype {otype!r} is not ported yet")
    return VanillaMLP(
        dim_in, dim_out,
        n_neurons=config.get("n_neurons", 64),
        n_hidden_layers=config.get("n_hidden_layers", 1),
        sphere_init=config.get("sphere_init", False),
        sphere_init_radius=config.get("sphere_init_radius", 0.5),
        weight_norm=config.get("weight_norm", False),
        output_activation=config.get("output_activation"),
    )
