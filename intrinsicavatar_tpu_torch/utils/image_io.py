"""Image I/O of the port in numpy and the standard library: PNG read and
write, Radiance ``.hdr`` (RGBE) read and write, and ``cv2.resize``'s linear
downscale.

The JAX package reads its frames with ``cv2`` and writes with ``imageio``;
the port has neither, and each function here states which of their calls
it stands for and how far it matches it:

- :func:`read_png` is ``cv2.cvtColor(cv2.imread(p), cv2.COLOR_BGR2RGB)``
  (and, with ``anydepth``, ``cv2.IMREAD_ANYDEPTH | cv2.IMREAD_COLOR``):
  RGB, grey replicated, alpha dropped, 16-bit samples cut to their high
  byte unless ``anydepth``.
- :func:`read_hdr` is ``cv2.imread(p, cv2.IMREAD_ANYDEPTH |
  cv2.IMREAD_COLOR)`` of an ``.hdr`` file, in RGB: ``m * 2^(e - 136)``
  for a nonzero exponent ``e``, no half-step added to the mantissa.
- :func:`resize_down` is ``cv2.resize(img, None, fx=1/d, fy=1/d)``
  (``INTER_LINEAR``) at integer ``d``: bit for bit for uint8; for float32
  within one rounding of the sums (cv2's own order of the four adds of
  its 2 x 2 mean depends on its SIMD width and on IPP).

What these readers cannot decode they refuse, naming the format:
interlaced, palette and sub-byte PNGs, old-style run-length ``.hdr``
scanlines, and every other format (``.exr``, JPEG).
"""

from __future__ import annotations

import os
import re
import struct
import zlib

import numpy as np

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}       # PNG colour type -> samples


def read_any(path: str) -> np.ndarray:
    """``cv2.imread(path, cv2.IMREAD_ANYDEPTH | cv2.IMREAD_COLOR)`` in RGB
    for the formats the port reads: a PNG at its own depth (uint8 or
    uint16), a Radiance ``.hdr`` as float32.  Any other format raises,
    naming it (``.exr`` among them)."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".png":
        return read_png(path, anydepth=True)
    if ext in (".hdr", ".pic"):
        return read_hdr(path)
    raise NotImplementedError(f"{path}: the {ext or 'extensionless'} format "
                              f"has no reader in the port (PNG, .hdr)")


# ------------------------------------------------------------------ PNG


def _chunks(data: bytes):
    pos = len(_PNG_SIG)
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        yield kind, data[pos + 8:pos + 8 + n]
        pos += 12 + n


def _unfilter(raw: np.ndarray, H: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the PNG row filters of ``raw [H, 1 + stride]`` (filter byte,
    then the row's bytes); returns ``[H, stride]`` uint8.

    A byte depends only on its left, upper and upper-left neighbours (at
    one pixel, ``bpp`` bytes, to the left), so every pixel of one
    anti-diagonal ``r + c = d`` is decoded at once: the rows are skewed so
    that diagonal ``d`` is the contiguous row ``T[d]``, with one pad pixel
    above and to the left."""
    ftype = raw[:, 0].astype(np.int16)
    if ftype.max(initial=0) > 4:
        raise ValueError(f"PNG: unknown row filter {int(ftype.max())}")
    W = stride // bpp
    f = raw[:, 1:].reshape(H, W, bpp).astype(np.int16)
    if not np.any(ftype >= 3):
        # None / Sub / Up only: row by row, Sub as a running sum mod 256
        out = np.zeros((H + 1, W, bpp), np.uint8)
        for r in range(H):
            row = f[r].astype(np.uint8)
            if ftype[r] == 1:
                row = np.cumsum(row, axis=0, dtype=np.uint8)
            elif ftype[r] == 2:
                row = row + out[r]
            out[r + 1] = row
        return out[1:].reshape(H, stride)
    D = H + W - 1
    rr, cc = np.mgrid[0:H, 0:W]
    # T[d + 2, r + 1] holds pixel (r, d - r); row 0/1 and column 0 pad
    T = np.zeros((D + 2, H + 1, bpp), np.int16)
    F = np.zeros((D + 2, H + 1, bpp), np.int16)
    F[rr + cc + 2, rr + 1] = f
    kind = ftype[:, None]
    present = [int(k) for k in np.unique(ftype)]
    for d in range(D):
        r0, r1 = max(0, d - W + 1), min(H - 1, d)
        rows = slice(r0 + 1, r1 + 2)
        a = T[d + 1, rows]                        # left
        b = T[d + 1, r0:r1 + 1]                   # up
        c = T[d, r0:r1 + 1]                       # up-left
        # where the neighbour lies outside the image its pad is 0: the left
        # pad of column 0 is the slot of pixel (r, -1), never written
        k = kind[r0:r1 + 1]
        pred = None
        for kk in present:                        # only the filters in use
            if kk == 4:
                pa = np.abs(b - c)
                pb = np.abs(a - c)
                pc = np.abs(a + b - 2 * c)
                v = np.where((pa <= pb) & (pa <= pc), a,
                             np.where(pb <= pc, b, c))
            else:
                v = (0, a, b, (a + b) >> 1)[kk]
            pred = v if pred is None else np.where(k == kk, v, pred)
        T[d + 2, rows] = (F[d + 2, rows] + pred) & 0xFF
    out = T[rr + cc + 2, rr + 1].astype(np.uint8)
    return out.reshape(H, stride)


def read_png(path: str, anydepth: bool = False) -> np.ndarray:
    """``[H, W, 3]`` RGB of a PNG file: uint8, or uint16 for a 16-bit file
    with ``anydepth``.  Grey is replicated, alpha dropped, 16-bit samples
    cut to their high byte (what ``cv2.imread`` gives with
    ``IMREAD_COLOR``).  Interlaced, palette and sub-byte files raise."""
    with open(path, "rb") as fh:
        data = fh.read()
    if not data.startswith(_PNG_SIG):
        raise ValueError(f"{path}: not a PNG file")
    ihdr, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    W, H, depth, ctype, _, _, interlace = ihdr
    if interlace:
        raise NotImplementedError(f"{path}: interlaced (Adam7) PNG has no "
                                  f"reader in the port")
    if ctype == 3:
        raise NotImplementedError(f"{path}: palette PNG has no reader in "
                                  f"the port")
    if ctype not in _CHANNELS or depth not in (8, 16):
        raise NotImplementedError(f"{path}: PNG of colour type {ctype} at "
                                  f"{depth} bits has no reader in the port")
    C = _CHANNELS[ctype]
    bpp = C * depth // 8
    stride = W * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    raw = raw[:H * (stride + 1)].reshape(H, stride + 1)
    px = _unfilter(raw, H, stride, bpp)
    if depth == 16:
        img = px.reshape(H, W * C, 2)
        img = (img[..., 0].astype(np.uint16) << 8) | img[..., 1]
        img = img.reshape(H, W, C)
        if not anydepth:
            img = (img >> 8).astype(np.uint8)
    else:
        img = px.reshape(H, W, C)
    if C <= 2:
        img = np.repeat(img[..., :1], 3, -1)
    return np.ascontiguousarray(img[..., :3])


def write_png(path: str, img) -> None:
    """Write ``img`` (uint8 or uint16; ``[H, W]`` grey, ``[H, W, 3]`` RGB or
    ``[H, W, 4]`` RGBA) as a PNG with unfiltered rows."""
    img = np.asarray(img)
    if img.dtype not in (np.uint8, np.uint16):
        raise TypeError(f"write_png: {img.dtype} (uint8 or uint16 only)")
    if img.ndim == 2:
        img = img[..., None]
    H, W, C = img.shape
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[C]
    depth = 8 * img.dtype.itemsize
    rows = img.astype(">u2" if depth == 16 else np.uint8).reshape(H, -1)
    rows = rows.view(np.uint8).reshape(H, -1)
    raw = np.concatenate([np.zeros((H, 1), np.uint8), rows], 1)

    def chunk(kind, body):
        crc = zlib.crc32(kind + body) & 0xFFFFFFFF
        return struct.pack(">I", len(body)) + kind + body \
            + struct.pack(">I", crc)

    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "wb") as fh:
        fh.write(_PNG_SIG
                 + chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, depth, ctype,
                                              0, 0, 0))
                 + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
                 + chunk(b"IEND", b""))


# ------------------------------------------------------------------ HDR


def read_hdr(path: str) -> np.ndarray:
    """``[H, W, 3]`` float32 RGB of a Radiance RGBE file (flat or
    new-style run-length scanlines, ``-Y H +X W`` orientation)."""
    with open(path, "rb") as fh:
        data = fh.read()
    pos = 0
    first = True
    while True:
        end = data.index(b"\n", pos)
        line = data[pos:end].strip()
        pos = end + 1
        if first:
            if not line.startswith(b"#?"):
                raise ValueError(f"{path}: not a Radiance HDR file")
            first = False
            continue
        if not line:
            break
        if line.startswith(b"FORMAT=") and line != b"FORMAT=32-bit_rle_rgbe":
            raise NotImplementedError(f"{path}: Radiance {line.decode()} has "
                                      f"no reader in the port")
    end = data.index(b"\n", pos)
    m = re.fullmatch(rb"-Y (\d+) \+X (\d+)", data[pos:end].strip())
    if m is None:
        raise NotImplementedError(f"{path}: the orientation "
                                  f"{data[pos:end]!r} has no reader in the "
                                  f"port (only -Y H +X W)")
    H, W = int(m.group(1)), int(m.group(2))
    pos = end + 1
    buf = np.frombuffer(data, np.uint8)
    out = np.empty((H, W, 4), np.uint8)
    for y in range(H):
        head = buf[pos:pos + 4]
        if 8 <= W < 0x8000 and head[0] == 2 and head[1] == 2 \
                and not head[2] & 0x80:
            if (int(head[2]) << 8 | int(head[3])) != W:
                raise ValueError(f"{path}: scanline {y} has a wrong width")
            pos += 4
            for ch in range(4):
                x = 0
                while x < W:
                    n = int(buf[pos])
                    if n > 128:
                        out[y, x:x + n - 128, ch] = buf[pos + 1]
                        x += n - 128
                        pos += 2
                    else:
                        if n == 0:
                            raise ValueError(f"{path}: bad run in scanline "
                                             f"{y}")
                        out[y, x:x + n, ch] = buf[pos + 1:pos + 1 + n]
                        x += n
                        pos += 1 + n
        else:
            px = buf[pos:pos + 4 * W].reshape(W, 4)
            if np.any((px[:, 0] == 1) & (px[:, 1] == 1) & (px[:, 2] == 1)):
                raise NotImplementedError(f"{path}: old-style run-length "
                                          f"scanlines have no reader in the "
                                          f"port")
            out[y] = px
            pos += 4 * W
    e = out[..., 3].astype(np.int32)
    scale = np.where(e > 0, np.ldexp(np.float32(1.0), e - 136),
                     np.float32(0.0)).astype(np.float32)
    return out[..., :3].astype(np.float32) * scale[..., None]


def write_hdr(path: str, img) -> str:
    """Write ``img [H, W, 3]`` (RGB, linear) as a Radiance RGBE file with
    run-length scanlines of literal runs (flat where the width is outside
    8..32767); the encoding of ``cv2.imwrite``'s: ``m = int(v * 2^8 /
    2^e)`` from the largest channel's ``frexp`` exponent ``e``.  Returns
    ``path``."""
    img = np.asarray(img, np.float32).astype(np.float64)
    H, W = img.shape[:2]
    v = img.max(-1)
    mant, ex = np.frexp(v)
    with np.errstate(divide="ignore", invalid="ignore"):
        f = np.where(v >= 1e-32, mant * 256.0 / v, 0.0)
    rgbe = np.zeros((H, W, 4), np.uint8)
    rgbe[..., :3] = (img * f[..., None]).astype(np.uint8)
    rgbe[..., 3] = np.where(v >= 1e-32, ex + 128, 0)
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    head = f"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n-Y {H} +X {W}\n"
    if 8 <= W < 0x8000:
        # per scanline: 2 2 W_hi W_lo, then each channel as literal runs of
        # at most 128 bytes, each after its count
        starts = np.arange(0, W, 128)
        lens = np.minimum(W - starts, 128)
        chan = np.empty(W + len(starts), np.int64)
        src = np.empty(W + len(starts), np.int64)
        is_count = np.zeros(W + len(starts), bool)
        o = 0
        for s, n in zip(starts, lens):
            is_count[o] = True
            chan[o] = n
            src[o + 1:o + 1 + n] = np.arange(s, s + n)
            o += 1 + n
        body = np.empty((H, 4, len(src)), np.uint8)
        for ch in range(4):
            vals = rgbe[:, :, ch][:, np.where(is_count, 0, src)]
            body[:, ch] = np.where(is_count[None], chan[None], vals)
        lead = np.tile(np.asarray([2, 2, W >> 8, W & 0xFF], np.uint8),
                       (H, 1))
        payload = np.concatenate([lead, body.reshape(H, -1)], 1).tobytes()
    else:
        payload = rgbe.tobytes()
    with open(path, "wb") as fh:
        fh.write(head.encode() + payload)
    return path


# ------------------------------------------------------------------ resize


def _axis_linear(n_src: int, n_dst: int, scale: float):
    """Source index and fraction of each output sample (cv2's linear rule:
    ``f = (i + 0.5) * scale - 0.5`` in float32, clamped at the edges)."""
    fx = ((np.arange(n_dst) + 0.5) * scale - 0.5).astype(np.float32)
    sx = np.floor(fx).astype(np.int64)
    fx = fx - sx.astype(np.float32)
    lo = sx < 0
    hi = sx >= n_src - 1
    fx[lo | hi] = 0.0
    sx[lo] = 0
    sx[hi] = n_src - 1
    return sx, np.minimum(sx + 1, n_src - 1), fx


def _area2(img: np.ndarray, out_hw) -> np.ndarray:
    """cv2's fast 2x2 area mean (what its linear downscale by exactly 2
    runs): ``(s + 2) >> 2`` for uint8, ``((a + b) + (c + d)) * 0.25`` for
    float32; an output pixel past an odd edge averages the source pixels
    that exist."""
    H, W = img.shape[:2]
    oh, ow = out_hw
    full_h, full_w = min(oh, H // 2), min(ow, W // 2)
    x = img.astype(np.int32 if img.dtype == np.uint8 else np.float32)
    out = np.zeros((oh, ow) + img.shape[2:], x.dtype)
    a = x[0:2 * full_h:2, 0:2 * full_w:2]
    b = x[0:2 * full_h:2, 1:2 * full_w:2]
    c = x[1:2 * full_h:2, 0:2 * full_w:2]
    e = x[1:2 * full_h:2, 1:2 * full_w:2]
    if img.dtype == np.uint8:
        out[:full_h, :full_w] = (a + b + c + e + 2) >> 2
    else:
        out[:full_h, :full_w] = ((a + b) + (c + e)) * np.float32(0.25)
    # the rows and columns past the last whole 2x2 block
    for i in range(oh):
        for j in range(ow):
            if i < full_h and j < full_w:
                continue
            blk = x[2 * i:2 * i + 2, 2 * j:2 * j + 2]
            n = blk.shape[0] * blk.shape[1]
            s = blk.reshape(n, *img.shape[2:]).sum(0)
            if img.dtype == np.uint8:
                out[i, j] = np.rint(s.astype(np.float32) / np.float32(n))
            else:
                out[i, j] = s * np.float32(1.0 / n)
    return out.astype(img.dtype)


def resize_down(img, d) -> np.ndarray:
    """``cv2.resize(img, None, fx=1/d, fy=1/d)`` (``INTER_LINEAR``) for a
    uint8 or float32 image ``[H, W]`` or ``[H, W, C]``: the output size
    ``round(H / d) x round(W / d)`` (half to even, as cv2 rounds it), a
    downscale by exactly 2 as cv2's 2x2 area mean, any other as its
    separable linear filter (uint8 in its 11-bit fixed point)."""
    img = np.asarray(img)
    if img.dtype not in (np.uint8, np.float32):
        raise TypeError(f"resize_down: {img.dtype} (uint8 or float32)")
    H, W = img.shape[:2]
    inv = 1.0 / float(d)
    oh, ow = int(np.rint(H * inv)), int(np.rint(W * inv))
    scale = 1.0 / inv
    if scale == 2.0:
        return _area2(img, (oh, ow))
    sy0, sy1, fy = _axis_linear(H, oh, scale)
    sx0, sx1, fx = _axis_linear(W, ow, scale)
    extra = (None,) * (img.ndim - 2)
    if img.dtype == np.uint8:
        one = 2048
        ax1 = np.rint(fx * one).astype(np.int64)
        ax0 = np.rint((1.0 - fx) * one).astype(np.int64)
        ay1 = np.rint(fy * one).astype(np.int64)
        ay0 = np.rint((1.0 - fy) * one).astype(np.int64)
        x = img.astype(np.int64)
        rows = (x[:, sx0] * ax0[(None, slice(None)) + extra]
                + x[:, sx1] * ax1[(None, slice(None)) + extra])
        out = (rows[sy0] * ay0[(slice(None), None) + extra]
               + rows[sy1] * ay1[(slice(None), None) + extra]
               + (1 << 21)) >> 22
        return np.clip(out, 0, 255).astype(np.uint8)
    x = img
    one = np.float32(1.0)
    rows = (x[:, sx0] * (one - fx)[(None, slice(None)) + extra]
            + x[:, sx1] * fx[(None, slice(None)) + extra])
    return (rows[sy0] * (one - fy)[(slice(None), None) + extra]
            + rows[sy1] * fy[(slice(None), None) + extra]).astype(np.float32)
