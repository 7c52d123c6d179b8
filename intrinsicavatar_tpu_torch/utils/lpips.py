"""LPIPS (VGG16) in PyTorch: the architecture of the JAX package's
``utils/lpips_jax.py``.

The LPIPS-VGG metric the reference evaluates with
(`systems/criterions.py:105-126` of taconite/IntrinsicAvatar, through the
``lpips`` pip package): VGG16's convolution features after relu{1_2, 2_2,
3_3, 4_3, 5_3}, unit-normalized per channel, the learned 1x1 linear heads,
a spatial mean, summed over the layers.  Inputs are HWC RGB in [0, 1].

The weights are not in the repository, and nothing fetches them: give an
``.npz`` (as ``scripts/convert_lpips_weights.py`` writes it from the
published checkpoints) by path or by ``INTRINSICAVATAR_LPIPS_WEIGHTS``.
Its keys::

    conv{i}_w  [kh, kw, cin, cout]   (i = 0..12, VGG16 order)
    conv{i}_b  [cout]
    lin{j}_w   [c_j]                 (j = 0..4, the LPIPS heads)

The convolutions are library calls (``F.conv2d``): the JAX package
computes them with ``lax.conv`` outside any hot op.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F

# VGG16: output channels of each convolution, "M" a 2x2 max pool
_VGG16 = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
          512, 512, 512, "M", 512, 512, 512]
# the convolutions (by index among them) after whose relu LPIPS taps
_TAPS = (1, 3, 6, 9, 12)

# LPIPS's input normalization (the package's scaling layer)
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)


def load_weights(path: str | None = None, device="cpu"):
    """The ``.npz`` bundle as ``{"convs": [(w OIHW, b)], "lins": [w]}``
    (the convolutions transposed from HWIO once, here), or None where no
    file is given or it does not exist."""
    path = path or os.environ.get("INTRINSICAVATAR_LPIPS_WEIGHTS")
    if not path or not os.path.exists(path):
        return None
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    with np.load(path) as z:
        return {
            "convs": [(t(z[f"conv{i}_w"]).permute(3, 2, 0, 1).contiguous(),
                       t(z[f"conv{i}_b"])) for i in range(13)],
            "lins": [t(z[f"lin{j}_w"]) for j in range(5)]}


def _vgg_features(params, x):
    """``x [B, 3, H, W]`` in [-1, 1] -> the 5 tapped feature maps."""
    shift = torch.as_tensor(_SHIFT, device=x.device)[:, None, None]
    scale = torch.as_tensor(_SCALE, device=x.device)[:, None, None]
    x = (x - shift) / scale
    feats = []
    ci = 0
    for spec in _VGG16:
        if spec == "M":
            x = F.max_pool2d(x, 2, 2)
            continue
        w, b = params["convs"][ci]
        x = F.relu(F.conv2d(x, w, b, padding=1))
        if ci in _TAPS:
            feats.append(x)
        ci += 1
    return feats


def _unit_norm(f, eps=1e-10):
    return f / torch.sqrt(torch.sum(f * f, dim=1, keepdim=True) + eps)


@torch.no_grad()
def lpips_distance(params, img0, img1):
    """LPIPS distance ``[B]`` between ``[B, 3, H, W]`` images in [-1, 1]."""
    f0 = _vgg_features(params, img0)
    f1 = _vgg_features(params, img1)
    total = 0.0
    for j, (a, b) in enumerate(zip(f0, f1)):
        d = (_unit_norm(a) - _unit_norm(b)) ** 2       # [B, C, H, W]
        lin = params["lins"][j][None, :, None, None]
        total = total + torch.mean(torch.sum(d * lin, 1), dim=(1, 2))
    return total


def lpips_fn(path: str | None = None, device="cpu"):
    """``f(pred_hwc01, gt_hwc01) -> float``, or None without weights."""
    params = load_weights(path, device)
    if params is None:
        return None

    def image(x):
        x = torch.as_tensor(np.asarray(x, np.float32), device=device)
        return x.permute(2, 0, 1)[None] * 2.0 - 1.0

    def compute(pred, gt):
        return float(lpips_distance(params, image(pred), image(gt))[0])

    return compute
