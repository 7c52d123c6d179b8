"""The port's image I/O (``utils/image_io.py``) against ``cv2``, the JAX
package's reader: PNG read at 8 and 16 bits in grey, grey + alpha, RGB and
RGBA, every row filter (files that cv2 wrote, and files whose rows this
test filters itself with each of the five filter types), the formats it
refuses; PNG write read back by cv2; Radiance ``.hdr`` read of cv2's
run-length files and write read back by cv2 (run-length and flat
scanlines); and ``resize_down`` against ``cv2.resize`` at d in {2, 4} on
uint8 and float32 images, odd sizes included.

Everything is bit-equal to cv2 but ``resize_down`` on float32 at d = 2:
cv2 adds a 2 x 2 block's four values in an order that depends on its SIMD
width, the channel count and IPP (measured on cv2 5.0 on an x86-64 CPU
with IPP off: ``(a + b) + (c + d)`` for one channel, ``((a + b) + c) + d``
in its scalar tail and for three), so the port's ``(a + b) + (c + d)`` is held
to one rounding of the mean (``ulp(max) = 2^-23`` for values in [0, 1),
6e-8 here); d = 4 is bit-equal with IPP off and within the same bound
with it on."""

import struct
import zlib

import numpy as np
import pytest

from intrinsicavatar_tpu_torch.utils import image_io as IO

cv2 = pytest.importorskip("cv2")

FLOAT_RESIZE_TOL = 6e-8


def _rgb(p, flags=cv2.IMREAD_COLOR):
    return cv2.cvtColor(cv2.imread(p, flags), cv2.COLOR_BGR2RGB)


def _image(rng, H, W, C, dtype):
    mx = np.iinfo(dtype).max + 1
    base = np.add.outer(np.arange(H), np.arange(W)) * (mx // (H + W))
    return ((base[..., None] + rng.integers(0, mx // 8, (H, W, C))) % mx
            ).astype(dtype)


def _filtered_png(path, img, filters):
    """Write ``img [H, W, C]`` (uint8 or uint16, RGB order) as a PNG whose
    row r is filtered by ``filters[r % len(filters)]`` (0 none, 1 sub, 2
    up, 3 average, 4 Paeth), in the encoder's arithmetic of the PNG
    specification."""
    H, W, C = img.shape
    depth = 8 * img.dtype.itemsize
    bpp = C * depth // 8
    rows = img.astype(">u2" if depth == 16 else np.uint8).reshape(H, -1)
    rows = rows.view(np.uint8).reshape(H, -1).astype(np.int32)
    out = []
    prev = np.zeros_like(rows[0])
    for r in range(H):
        x = rows[r]
        a = np.concatenate([np.zeros(bpp, np.int32), x[:-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
        b = prev
        f = filters[r % len(filters)]
        if f == 4:
            p = a + b - c
            pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
            pred = np.where((pa <= pb) & (pa <= pc), a,
                            np.where(pb <= pc, b, c))
        else:
            pred = (0 * x, a, b, (a + b) // 2)[f]
        out.append(np.concatenate([[f], (x - pred) % 256]).astype(np.uint8))
        prev = x
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[C]

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(
            ">I", zlib.crc32(kind + body) & 0xFFFFFFFF)

    with open(path, "wb") as fh:
        fh.write(b"\x89PNG\r\n\x1a\n"
                 + chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, depth,
                                              ctype, 0, 0, 0))
                 + chunk(b"IDAT", zlib.compress(np.concatenate(out)
                                                .tobytes()))
                 + chunk(b"IEND", b""))


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("C", [1, 3, 4])
def test_read_png_matches_cv2(tmp_path, C, dtype):
    """Files cv2 wrote, at three sizes; read at 8 bits (IMREAD_COLOR: 16-bit
    samples cut to their high byte) and at the file's depth
    (IMREAD_ANYDEPTH)."""
    rng = np.random.default_rng(C)
    p = str(tmp_path / "x.png")
    for H, W in ((5, 7), (33, 17), (64, 48)):
        a = _image(rng, H, W, C, dtype)
        cv2.imwrite(p, a[..., 0] if C == 1 else a)
        for anyd in (False, True):
            ref = _rgb(p, (cv2.IMREAD_ANYDEPTH | cv2.IMREAD_COLOR) if anyd
                       else cv2.IMREAD_COLOR)
            got = IO.read_png(p, anydepth=anyd)
            assert got.dtype == ref.dtype
            np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("filters", [(0,), (1,), (2,), (3,), (4,),
                                     (4, 1, 3, 0, 2), (2, 3)])
@pytest.mark.parametrize("C,dtype", [(3, np.uint8), (2, np.uint8),
                                     (4, np.uint16)])
def test_read_png_undoes_every_filter(tmp_path, filters, C, dtype):
    """Rows filtered by each of the five types and mixes of them (the
    anti-diagonal decode where an average or Paeth row is present), grey
    + alpha among the layouts; equal to cv2's decode of the same file."""
    rng = np.random.default_rng(len(filters) * 10 + C)
    p = str(tmp_path / "f.png")
    for H, W in ((1, 1), (6, 1), (1, 9), (31, 23)):
        a = _image(rng, H, W, C, dtype)
        _filtered_png(p, a, filters)
        for anyd in (False, True):
            ref = _rgb(p, (cv2.IMREAD_ANYDEPTH | cv2.IMREAD_COLOR) if anyd
                       else cv2.IMREAD_COLOR)
            np.testing.assert_array_equal(IO.read_png(p, anydepth=anyd), ref)


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("C", [1, 3, 4])
def test_write_png_reads_back_by_cv2(tmp_path, C, dtype):
    a = _image(np.random.default_rng(C + 7), 13, 11, C, dtype)
    p = str(tmp_path / "sub" / "w.png")
    IO.write_png(p, a[..., 0] if C == 1 else a)
    back = cv2.imread(p, cv2.IMREAD_UNCHANGED)
    if C == 1:
        np.testing.assert_array_equal(back, a[..., 0])
    else:
        conv = cv2.COLOR_BGR2RGB if C == 3 else cv2.COLOR_BGRA2RGBA
        np.testing.assert_array_equal(cv2.cvtColor(back, conv), a)
    np.testing.assert_array_equal(IO.read_png(p, anydepth=True),
                                  np.repeat(a[..., :1], 3, -1) if C == 1
                                  else a[..., :3])


def test_read_png_refuses_what_it_cannot_decode(tmp_path):
    """Interlaced (Adam7) and palette files raise and name their format;
    so does a format without a reader (JPEG, EXR)."""
    from PIL import Image
    rng = np.random.default_rng(1)
    a = rng.integers(0, 256, (9, 8, 3)).astype(np.uint8)
    p = str(tmp_path / "i.png")
    IO.write_png(p, a)
    data = bytearray(open(p, "rb").read())
    data[28] = 1                    # IHDR's interlace method: Adam7
    data[29:33] = struct.pack(">I", zlib.crc32(bytes(data[12:29]))
                              & 0xFFFFFFFF)
    open(p, "wb").write(bytes(data))
    with pytest.raises(NotImplementedError, match="interlaced"):
        IO.read_png(p)
    Image.fromarray(a).convert("P").save(p)
    assert cv2.imread(p) is not None
    with pytest.raises(NotImplementedError, match="palette"):
        IO.read_png(p)
    for ext in (".jpg", ".exr"):
        with pytest.raises(NotImplementedError, match=ext):
            IO.read_any(str(tmp_path / f"x{ext}"))


@pytest.mark.parametrize("W", [5, 10, 300])
def test_hdr_read_and_write_match_cv2(tmp_path, W):
    """cv2's run-length files (flat below 8 pixels wide) read equal to
    cv2's own read; the port's writes read back by cv2 as cv2's write of
    the same image does (the same RGBE bytes' values), with zeros and
    values below 1e-32."""
    rng = np.random.default_rng(W)
    img = (rng.random((7, W, 3)) ** 3 * 50).astype(np.float32)
    img[0, 0] = 0.0
    img[-1, -1] = 1e-33
    img[1, :] = img[1, :1]          # a run the encoder compresses
    p, q = str(tmp_path / "cv.hdr"), str(tmp_path / "port.hdr")
    cv2.imwrite(p, img[..., ::-1])
    ref = _rgb(p, cv2.IMREAD_ANYDEPTH | cv2.IMREAD_COLOR)
    np.testing.assert_array_equal(IO.read_hdr(p), ref)
    assert IO.write_hdr(q, img) == q
    np.testing.assert_array_equal(
        _rgb(q, cv2.IMREAD_ANYDEPTH | cv2.IMREAD_COLOR), ref)
    np.testing.assert_array_equal(IO.read_any(q), ref)
    # RGBE keeps 8 bits of the largest channel
    big = img.max(-1, keepdims=True)
    assert np.all(np.abs(ref - img) <= big * 2.0 ** -7 + 1e-30)


@pytest.mark.parametrize("d", [2, 4])
@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_resize_down_matches_cv2(d, dtype):
    """``cv2.resize(img, None, fx=1/d, fy=1/d)``: the size (rounded half to
    even) and the values, one and three channels, even and odd sizes."""
    rng = np.random.default_rng(d)
    for H, W in ((64, 48), (33, 17), (35, 38), (31, 29), (7, 9),
                 (1080, 1080)):
        for C in (None, 3):
            shp = (H, W) if C is None else (H, W, C)
            a = (rng.integers(0, 256, shp).astype(np.uint8)
                 if dtype == np.uint8 else rng.random(shp).astype(dtype))
            ref = cv2.resize(a, None, fx=1 / d, fy=1 / d)
            got = IO.resize_down(a, d)
            assert got.shape == ref.shape and got.dtype == ref.dtype
            if dtype == np.uint8:
                np.testing.assert_array_equal(got, ref)
            else:
                np.testing.assert_allclose(got, ref, rtol=0,
                                           atol=FLOAT_RESIZE_TOL)
