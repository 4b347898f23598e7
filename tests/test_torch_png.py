"""The port's PNG codec (``dspfun_tpu_torch/io/png.py``) against the
writers and readers it stands in for: Pillow's PNG plugin and
``dspfun_tpu/io/png16.py``.

* write: for the same quantised array and properties the port's bytes
  equal Pillow's (8-bit RGB/RGBA, 16-bit gray) or ``png16``'s (16-bit
  RGB/RGBA), whole file.  The decompressed scanline stream (filter bytes
  and filtered rows) and every chunk but ``IDAT`` are compared first:
  they must agree whatever zlib either side links; the compressed bytes
  agree where both link the same zlib, as here.
* read: files from Pillow (gray, gray + alpha, tRNS, zTXt, iTXt, its
  ``optimize`` filters), from ``png16``, and files with each of the five
  filters forced give the pixels, depth and properties of
  ``dspfun_tpu.io.images.read_image``, exactly.
* the formats and PNG varieties the port once refused read as the JAX
  package reads them (tests/test_torch_image_formats.py has the rest).
"""

import io
import struct
import sys
import zlib

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image, UnidentifiedImageError
from PIL.PngImagePlugin import PngInfo

from dspfun_tpu.io import images as jimages
from dspfun_tpu.io import png16
from dspfun_tpu_torch.io import images as timages
from dspfun_tpu_torch.io import png

SHAPES = {"random": (16, 16), "smooth": (40, 56), "flat": (16, 24), "1xN": (1, 37),
          "Nx1": (37, 1), "500x300": (300, 500)}
MODES = {"rgb8": (np.uint8, 3), "rgba8": (np.uint8, 4), "gray16": (np.uint16, 1),
         "rgb16": (np.uint16, 3), "rgba16": (np.uint16, 4)}
PROPS = {"DC": "ABCDEFGHIJKLMNOP" * 3, "colorspace": "RGB"}


def _array(kind, dtype, c, seed=0):
    h, w = SHAPES[kind]
    top = np.iinfo(dtype).max
    rng = np.random.default_rng(seed)
    if kind == "flat":
        a = np.full((h, w, c), top // 3, np.float64)
    elif kind in ("random", "1xN", "Nx1"):
        a = rng.integers(0, top + 1, (h, w, c)).astype(np.float64)
    else:  # smooth gradients under a little noise: every filter gets rows
        y, x = np.mgrid[0:h, 0:w]
        a = np.stack([(0.5 + 0.4 * np.sin(x / (7.0 + i) + y / 11.0)) * top * 0.9
                      for i in range(c)], -1)
        a[h // 2:] += rng.integers(0, max(top // 40, 2), (h - h // 2, w, c))
    a = a.astype(dtype)
    return a[..., 0] if c == 1 else a


def _reference_bytes(a, props):
    """What the JAX package writes for this array: png16 for 16-bit
    colour, Pillow otherwise (dspfun_tpu/io/images.py:240-294)."""
    buf = io.BytesIO()
    if a.dtype == np.uint16 and a.ndim == 3:
        png16.write_png16(buf, a, props)
        return buf.getvalue()
    img = Image.fromarray(a) if a.ndim == 2 else \
        Image.fromarray(a, mode="RGBA" if a.shape[2] == 4 else "RGB")
    info = PngInfo()
    for k, v in (props or {}).items():
        info.add_text(str(k), str(v))
    img.save(buf, format="PNG", pnginfo=info)
    return buf.getvalue()


def _chunks(data):
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, out = 8, []
    while pos < len(data):
        ln, typ = struct.unpack(">I4s", data[pos:pos + 8])
        out.append((typ, data[pos + 8:pos + 8 + ln]))
        pos += 12 + ln
    return out


def _scanlines(data):
    return zlib.decompress(b"".join(b for t, b in _chunks(data) if t == b"IDAT"))


@pytest.mark.parametrize("with_props", [False, True], ids=["bare", "props"])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("kind", SHAPES)
def test_written_bytes_equal_the_reference_writers(kind, mode, with_props):
    a = _array(kind, *MODES[mode])
    props = PROPS if with_props else None
    mine, ref = png.encode_png(a, props), _reference_bytes(a, props)
    assert _scanlines(mine) == _scanlines(ref)
    assert [c for c in _chunks(mine) if c[0] != b"IDAT"] == \
        [c for c in _chunks(ref) if c[0] != b"IDAT"]
    assert mine == ref


def test_pillow_stream_is_filtered_strategy_in_64k_chunks():
    """The facts the writer rests on: Pillow's stream is Z_FILTERED level
    6, not ``zlib.compress(raw, 6)``; it is cut into 65536-byte IDATs;
    the smooth image's rows use Sub, Up and Paeth, never Average."""
    a = _array("500x300", np.uint8, 3)
    ref = _reference_bytes(a, None)
    raw = _scanlines(ref)
    idat = [b for t, b in _chunks(ref) if t == b"IDAT"]
    assert b"".join(idat) != zlib.compress(raw, 6)
    z = zlib.compressobj(6, zlib.DEFLATED, 15, 9, zlib.Z_FILTERED)
    assert b"".join(idat) == z.compress(raw) + z.flush()
    assert len(idat) > 1 and all(len(b) == 65536 for b in idat[:-1])
    types = set(np.frombuffer(raw, np.uint8).reshape(300, -1)[:, 0].tolist())
    assert {1, 2, 4} <= types and 3 not in types


def _same_read(data, tmp_path, channels=("RGB", "RGBA", "I")):
    path = str(tmp_path / "f.png")
    with open(path, "wb") as f:
        f.write(data)
    for ch in channels:
        got, ref = timages.read_image(path, ch), jimages.read_image(path, ch)
        np.testing.assert_array_equal(got.pixels, ref.pixels)
        assert got.pixels.dtype == ref.pixels.dtype
        assert (got.depth, got.properties, got.linear) == \
            (ref.depth, ref.properties, ref.linear)


@pytest.mark.parametrize("ftype", range(5))
@pytest.mark.parametrize("mode", MODES)
def test_every_filter_reads_as_the_jax_package_reads_it(mode, ftype, tmp_path):
    a = _array("smooth", *MODES[mode], seed=ftype)
    data = png.encode_png(a, PROPS, filter_type=ftype)
    assert set(np.frombuffer(_scanlines(data), np.uint8)
               .reshape(a.shape[0], -1)[:, 0].tolist()) == {ftype}
    back, props, _ = png.decode_png(data)
    np.testing.assert_array_equal(back, a.reshape(back.shape))
    assert props == PROPS
    _same_read(data, tmp_path)


def _pil_file(img, **kw):
    buf = io.BytesIO()
    img.save(buf, format="PNG", **kw)
    return buf.getvalue()


def _pil_cases():
    rng = np.random.default_rng(3)
    g8 = _array("smooth", np.uint8, 3)[..., 0]
    rgb = _array("smooth", np.uint8, 3)
    info = PngInfo()
    info.add_text("DC", "HELLO" * 300, zip=True)
    info.add_itxt("Title", "déjà vu ✓", lang="fr", tkey="Titre")
    info.add_itxt("Packed", "z" * 500, zip=True)
    info.add_text("plain", "café")
    return {
        "gray8": _pil_file(Image.fromarray(g8)),
        "gray_alpha8": _pil_file(Image.fromarray(
            np.stack([g8, rng.integers(0, 256, g8.shape).astype(np.uint8)], -1), mode="LA")),
        "rgba8": _pil_file(Image.fromarray(_array("smooth", np.uint8, 4), mode="RGBA")),
        "gray16": _pil_file(Image.fromarray(_array("smooth", np.uint16, 1))),
        "text_chunks": _pil_file(Image.fromarray(rgb), pnginfo=info),
        "optimize": _pil_file(Image.fromarray(rgb), optimize=True),
        "trns_gray8": _pil_file(Image.fromarray(g8), transparency=int(g8[3, 5])),
        "trns_rgb8": _pil_file(Image.fromarray(rgb),
                               transparency=tuple(int(v) for v in rgb[2, 7])),
    }


@pytest.mark.parametrize("case", ["gray8", "gray_alpha8", "rgba8", "gray16", "text_chunks",
                                  "optimize", "trns_gray8", "trns_rgb8"])
def test_pillow_files_read_as_the_jax_package_reads_them(case, tmp_path):
    data = _pil_cases()[case]
    _same_read(data, tmp_path)
    if case.startswith("trns"):  # the colour key really made pixels transparent
        alpha = timages.read_image(_write(tmp_path, data), "A").pixels
        assert 0 < (alpha == 0).sum() < alpha.size
    if case == "text_chunks":
        assert set(png.decode_png(data)[1]) == {"DC", "Title", "Packed", "plain"}


def _write(tmp_path, data, name="g.png"):
    path = str(tmp_path / name)
    with open(path, "wb") as f:
        f.write(data)
    return path


@pytest.mark.parametrize("c", [3, 4])
def test_png16_files_read_as_the_jax_package_reads_them(c, tmp_path):
    a = _array("smooth", np.uint16, c)
    buf = io.BytesIO()
    png16.write_png16(buf, a, PROPS)
    _same_read(buf.getvalue(), tmp_path)
    back, props = png16.read_png16(png.encode_png(a, PROPS))
    np.testing.assert_array_equal(back, a)
    assert props == PROPS


def test_unfilter_equals_the_per_pixel_loop_on_mixed_rows():
    """The anti-diagonal unfilter against ``png16._unfilter`` (a loop per
    pixel for Average and Paeth) on rows of every type in random order."""
    rng = np.random.default_rng(11)
    for h, w, bpp in ((23, 31, 3), (9, 5, 8), (1, 40, 4), (40, 1, 6), (17, 17, 1)):
        raw = rng.integers(0, 256, (h, 1 + w * bpp)).astype(np.uint8)
        raw[:, 0] = rng.integers(0, 5, h)
        np.testing.assert_array_equal(png._unfilter(raw, h, w * bpp, bpp),
                                      png16._unfilter(raw, h, w * bpp, bpp))
    raw[0, 0] = 5
    with pytest.raises(ValueError, match="bad PNG filter type 5"):
        png._unfilter(raw, h, w * bpp, bpp)


def _patched_ihdr(data, **fields):
    """``data`` with IHDR fields replaced and its CRC made good."""
    names = ("w", "h", "depth", "color", "comp", "filt", "interlace")
    head = dict(zip(names, struct.unpack(">IIBBBBB", data[16:29])))
    head.update(fields)
    body = struct.pack(">IIBBBBB", *(head[n] for n in names))
    return data[:16] + body + struct.pack(">I", zlib.crc32(b"IHDR" + body)) + data[33:]


def _refused_files():
    """The files the port refused before it read every format: now each
    is read as the JAX package reads it (real interlaced and 4-bit files
    take the place of the patched headers, which no reader decodes)."""
    from tests.test_torch_image_formats import make_png

    arr = _array("random", np.uint8, 3)
    rgb = Image.fromarray(arr)
    out = {
        "interlaced": make_png(arr, 8, 2, 1),
        "palette": _pil_file(rgb.convert("P")),
        "depth1": _pil_file(rgb.convert("1")),
        "depth4": make_png(arr[..., :1] >> 4, 4, 0, 0),
        "not an image": b"hello, world\n",
    }
    for fmt in ("JPEG", "TIFF", "BMP", "PPM", "GIF", "WEBP"):
        buf = io.BytesIO()
        rgb.save(buf, format=fmt)
        out[fmt] = buf.getvalue()
    return out


@pytest.mark.parametrize("case", ["interlaced", "palette", "depth1", "depth4", "not an image",
                                  "JPEG", "TIFF", "BMP", "PPM", "GIF", "WEBP"])
def test_what_the_port_does_not_read_is_refused_by_item(case, tmp_path, monkeypatch):
    """Each file the port used to refuse (naming ROADMAP item 8) reads as
    the JAX package reads it: the same pixels and depth, or an error in
    both for what is no image.  Without cv2 JPEG, GIF and WebP (the
    port's own codecs) read the same pixels."""
    path = _write(tmp_path, _refused_files()[case], "in.bin")
    if case == "not an image":
        with pytest.raises(UnidentifiedImageError):
            jimages.read_image(path)
        with pytest.raises(ValueError, match="cannot identify"):
            timages.read_image(path)
        return
    j, t = jimages.read_image(path, channels="RGBA"), timages.read_image(path, channels="RGBA")
    assert t.depth == j.depth
    if case in ("JPEG", "GIF", "WEBP"):
        np.testing.assert_array_equal(t.pixels, j.pixels)
        monkeypatch.setitem(sys.modules, "cv2", None)
        np.testing.assert_array_equal(timages.read_image(path, channels="RGBA").pixels, j.pixels)
    else:
        np.testing.assert_array_equal(t.pixels, j.pixels)


def test_encode_refuses_what_it_cannot_write():
    for bad in (np.zeros((4, 4), np.uint8), np.zeros((4, 4, 2), np.uint16),
                np.zeros((4, 4, 3), np.float32), np.zeros((0, 4, 3), np.uint8)):
        with pytest.raises(ValueError, match="encode_png wants"):
            png.encode_png(bad)
    with pytest.raises(UnicodeEncodeError):
        png.encode_png(np.zeros((2, 2, 3), np.uint8), {"k": "✓"})
    with pytest.raises(ValueError, match="holds"):
        good = png.encode_png(np.zeros((4, 4, 3), np.uint8))
        png.decode_png(_patched_ihdr(good, h=5))


@settings(max_examples=60, deadline=None)
@given(h=st.integers(1, 24), w=st.integers(1, 24),
       mode=st.sampled_from(sorted(MODES)), ftype=st.sampled_from([None, 0, 1, 2, 3, 4]),
       seed=st.integers(0, 2**31 - 1), smooth=st.booleans())
def test_round_trip_over_shapes_depths_and_filters(h, w, mode, ftype, seed, smooth):
    dtype, c = MODES[mode]
    rng = np.random.default_rng(seed)
    top = np.iinfo(dtype).max
    a = rng.integers(0, top + 1, (h, w, c))
    if smooth:
        a = np.cumsum(a // max(top // 8, 1), axis=1) % (top + 1)
    a = a.astype(dtype)
    props = {"seed": str(seed)}
    back, got, trns = png.decode_png(png.encode_png(a[..., 0] if c == 1 else a, props, ftype))
    np.testing.assert_array_equal(back, a)
    assert (back.dtype, got, trns) == (dtype, props, None)
