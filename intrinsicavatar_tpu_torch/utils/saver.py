"""Image and array output writers (counterpart of the JAX package's
``utils/saver.py``, on the port's own PNG and Radiance writers in
``utils/image_io.py``): rgb and grayscale images, image grids, HDR images
and npz dumps.

The JAX package writes an HDR image as EXR where an ``imageio`` backend
can, else as Radiance ``.hdr``, else as ``.npy``; the port always writes
the ``.hdr`` (the format of the relighting HDRIs), beside the path asked
for.
"""

from __future__ import annotations

import os

import numpy as np

from intrinsicavatar_tpu_torch.utils.image_io import write_hdr, write_png


def _to_u8(img):
    return (np.clip(np.asarray(img), 0.0, 1.0) * 255).astype(np.uint8)


def save_rgb_image(path, img):
    """``img [H, W, 3]`` floats in [0, 1]."""
    write_png(path, _to_u8(img))


def save_grayscale_image(path, img, data_range=(0, 1)):
    x = (np.asarray(img, np.float32) - data_range[0]) / (
        data_range[1] - data_range[0])
    write_png(path, _to_u8(np.repeat(x[..., None], 3, -1)))


def save_image_grid(path, imgs, ncols=None):
    """Tile ``[H, W, 3]`` float images into one PNG row or grid."""
    imgs = [np.asarray(i) for i in imgs]
    H = max(i.shape[0] for i in imgs)
    W = max(i.shape[1] for i in imgs)
    padded = []
    for i in imgs:
        if i.ndim == 2:
            i = np.repeat(i[..., None], 3, -1)
        c = np.zeros((H, W, 3), np.float32)
        c[: i.shape[0], : i.shape[1]] = i[..., :3]
        padded.append(c)
    n = len(padded)
    ncols = ncols or n
    nrows = (n + ncols - 1) // ncols
    grid = np.zeros((nrows * H, ncols * W, 3), np.float32)
    for k, img in enumerate(padded):
        r, c = divmod(k, ncols)
        grid[r * H:(r + 1) * H, c * W:(c + 1) * W] = img
    save_rgb_image(path, grid)


def save_hdr(path, img):
    """``img [H, W, 3]`` as a Radiance ``.hdr`` at ``path`` with that
    extension; returns the path written."""
    return write_hdr(os.path.splitext(path)[0] + ".hdr",
                     np.asarray(img, np.float32))


def save_npz(path, **arrays):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **{k: np.asarray(v) for k, v in arrays.items()})
