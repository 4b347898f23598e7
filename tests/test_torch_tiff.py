"""The port's TIFF reader (``dspfun_tpu_torch/io/imgcodecs.py`` and
``native/tiff.cpp``) against the JAX package, which reads TIFF through
Pillow and libtiff (``dspfun_tpu/io/images.py``).

* Reads: files assembled by ``tests/torch_codec_fixtures.py:make_tiff``
  (LZW, deflate 8 and 32946, PackBits and uncompressed; strips and tiles,
  chunky and planar; predictor 1, 2 and 3; both fill orders; little- and
  big-endian; several strips with a short last one, edge tiles, at odd
  sizes) give ``read_image``'s pixels and depth exactly, with cv2
  importable and with it blocked: every key of Pillow's ``OPEN_INFO``
  the codec carries (the key matrix), each layout (the layout matrix),
  and Orientation 1-8.  Where Pillow raises, the port raises.
* Pillow's unpacker of every rawmode the codec meets, against
  ``Image.frombytes``; associated alpha (ExtraSamples 1) of every
  (colour, alpha) pair of 8 bits.
* No TIFF goes to cv2: the kinds that went there (or were refused)
  before the codec carried them read as the JAX package reads them here,
  in tests/test_torch_tiff_more.py, test_torch_tiff_zstd_lzma.py,
  test_torch_tiff_ojpeg.py and test_torch_tiff_12bit.py; a truncated or
  corrupt strip, tile or plane raises.
"""

import io
import struct
import sys

import numpy as np
import pytest
from PIL import Image

import chip_smoke
from dspfun_tpu.io import images as jimages
from dspfun_tpu_torch.io import imgcodecs
from dspfun_tpu_torch.io import images as timages
from tests import torch_codec_fixtures as fx
from tests.torch_codec_fixtures import MODES, make_tiff


_samples = fx.tiff_samples


_palette = fx.palette


def _same_read(tmp_path, data, channels=("RGB", "RGBA", "I")):
    path = tmp_path / "in.tif"
    path.write_bytes(data)
    for ch in channels:
        j, t = jimages.read_image(str(path), channels=ch), timages.read_image(str(path),
                                                                          channels=ch)
        assert t.depth == j.depth
        np.testing.assert_array_equal(t.pixels, j.pixels)


def _same_or_both_raise(tmp_path, data, monkeypatch=None, channels=("RGB", "RGBA", "I")):
    """The port reads ``data`` as the JAX package does, or raises
    ``ValueError`` or ``OSError`` where it raises; with ``monkeypatch``,
    with cv2 blocked too.  Returns whether it was read."""
    path = tmp_path / "in.tif"
    path.write_bytes(data)
    try:
        jimages.read_image(str(path))
    except (OSError, ValueError, SyntaxError):
        with pytest.raises((ValueError, OSError)):
            timages.read_image(str(path))
        return False
    _same_read(tmp_path, data, channels)
    if monkeypatch is not None:
        with monkeypatch.context() as mp:
            mp.setitem(sys.modules, "cv2", None)
            _same_read(tmp_path, data, channels=("RGBA",))
    return True


MATRIX = [(c, p, m) for c in (5, 8, 32946, 32773) for p in (1, 2)
          for m in ("1", "L", "LA", "P", "RGB", "RGBA", "RGBa", "I;16")]


@pytest.mark.parametrize("compression,predictor,mode", MATRIX)
def test_compressed_tiff_reads_as_pillow_reads_it(compression, predictor, mode, tmp_path,
                                                  monkeypatch):
    """Every compression and predictor over every mode, little- and
    big-endian, in one strip and in strips of 3 rows at odd sizes, with
    cv2 importable and blocked.  1-bit samples with predictor 2 under
    LZW or deflate are refused by libtiff, and by the port."""
    refused = mode == "1" and predictor == 2 and compression != 32773
    for k, ((h, w), rps) in enumerate((((1, 1), None), ((7, 9), 3), ((33, 17), 4))):
        for bo in ("<", ">"):
            s = _samples(mode, h, w, seed=compression + 10 * predictor + k)
            data = make_tiff(s, mode, bo, compression, predictor, rps,
                             cmap=_palette(k) if mode == "P" else None)
            if refused:
                path = tmp_path / "in.tif"
                path.write_bytes(data)
                with pytest.raises(OSError):
                    jimages.read_image(str(path))
                with pytest.raises(ValueError, match="predictor 2 with 1-bit"):
                    timages.read_image(str(path))
                continue
            _same_read(tmp_path, data)
            with monkeypatch.context() as mp:
                mp.setitem(sys.modules, "cv2", None)
                _same_read(tmp_path, data, channels=("RGBA",))


@pytest.mark.parametrize("mode", ["L inverted", "RGBX", "RGBaX", "RGBAXX",
                                  "I;16 photometric 0", "RGB;16", "RGBA;16", "RGBa;16"])
@pytest.mark.parametrize("compression", [1, 5, 8])
def test_more_modes_read_as_pillow_reads_them(mode, compression, tmp_path):
    """Photometric 0 (8 bits inverted, 16 bits not: Pillow's rawmode
    ``I;16``, which it has for little-endian files only), RGB with
    ignored extra samples after the colour or the alpha, and 16-bit
    colour (the high bytes; associated alpha un-premultiplied on them),
    at both predictors and byte orders."""
    for predictor in (1, 2):
        for bo in ("<", ">"):
            s = _samples(mode, 11, 13, seed=predictor)
            data = make_tiff(s, mode, bo, compression, predictor, 4)
            if mode == "I;16 photometric 0" and bo == ">":
                path = tmp_path / "in.tif"
                path.write_bytes(data)
                with pytest.raises(OSError, match="cannot identify"):
                    jimages.read_image(str(path))
                assert "unknown pixel mode" in imgcodecs.tiff_unidentified(data)
                with pytest.raises(ValueError, match="unknown pixel mode"):
                    timages.read_image(str(path))
                continue
            _same_read(tmp_path, data)


def test_a_table_that_fills_and_clears(tmp_path):
    """Noise large enough for LZW to fill its table of 4094 codes and
    clear it several times, in one strip and in strips of 16 rows."""
    rng = np.random.default_rng(4)
    s = rng.integers(0, 256, (64, 71, 3), dtype=np.uint8)
    for rps in (None, 16):
        data = make_tiff(s, "RGB", "<", 5, 1, rps)
        assert len(data) > 64 * 71 * 3
        _same_read(tmp_path, data)
        got, _ = imgcodecs.decode_tiff(data)
        np.testing.assert_array_equal(got, s)


def test_associated_alpha_of_every_pair_is_pillows():
    """All 256 x 256 (colour, alpha) pairs of 8 bits, stored with
    ExtraSamples 1: the port's decode equals Pillow's ``RGBa`` raw mode
    and Pillow's read of the same file, uncompressed and LZW."""
    c, a = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    s = np.stack([c, 255 - c, (c * 7) % 256, a], -1).astype(np.uint8)
    want = np.asarray(Image.frombytes("RGBA", (256, 256), s.tobytes(), "raw", "RGBa"))
    for comp in (1, 5):
        data = make_tiff(s, "RGBa", "<", comp, 1, 64)
        got, depth = imgcodecs.decode_tiff(data)
        assert depth == 8
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(data))), want)
    assert (want[a == 0] == 0).all() and (want[a == 255] == s[a == 255]).all()


def test_associated_alpha_reads_as_the_jax_package(tmp_path):
    """The fault repaired first: Pillow's RGBA TIFF with ExtraSamples
    patched to 1 (associated) reads un-premultiplied in both packages,
    uncompressed and LZW."""
    rng = np.random.default_rng(9)
    img = Image.fromarray(rng.integers(0, 256, (19, 23, 4), dtype=np.uint8))
    for comp in ("raw", "tiff_lzw"):
        buf = io.BytesIO()
        img.save(buf, "TIFF", compression=comp)
        data = bytearray(buf.getvalue())
        ifd = struct.unpack_from("<I", data, 4)[0]
        for k in range(struct.unpack_from("<H", data, ifd)[0]):
            at = ifd + 2 + 12 * k
            if struct.unpack_from("<H", data, at)[0] == 338:
                struct.pack_into("<H", data, at + 8, 1)
        assert imgcodecs._tiff_tags(bytes(data))[1][338] == (1,)
        _same_read(tmp_path, bytes(data))


def test_pillows_own_files_with_predictor_and_strips(tmp_path):
    """What Pillow writes through libtiff: predictor 2 and small strips
    over LZW, deflate and PackBits (which libtiff writes and reads without
    the predictor)."""
    rng = np.random.default_rng(2)
    for mode in ("RGB", "L", "RGBA", "I;16"):
        a = rng.integers(0, 65536 if mode == "I;16" else 256,
                         (29, 31) if mode in ("L", "I;16") else (29, 31, len(mode)))
        img = Image.fromarray(a.astype(np.uint16 if mode == "I;16" else np.uint8))
        for comp in ("tiff_lzw", "tiff_adobe_deflate", "tiff_deflate", "packbits"):
            for kw in ({"tiffinfo": {317: 2}}, {"strip_size": 256}):
                buf = io.BytesIO()
                img.save(buf, "TIFF", compression=comp, **kw)
                _same_read(tmp_path, buf.getvalue())


# ---- what the codec does not carry ------------------------------------------

def _not_carried(kind):
    s = _samples("RGB", 8, 8, 0)
    if kind == "tiled":
        return make_tiff(s, "RGB", "<", 5, tile=(16, 16))
    if kind == "planar":
        return make_tiff(s, "RGB", "<", 8, planar=True)
    if kind == "predictor 3":
        return make_tiff(_samples("F", 8, 8, 0), "F", "<", 8, 3)
    if kind == "JPEG":
        return make_tiff(s, "YCbCr", compression=7, rows_per_strip=16)
    if kind == "YCbCr":
        return make_tiff(s, "YCbCr", "<", 5, subsampling=(2, 2))
    if kind == "LAB":
        return make_tiff(s, kind, "<", 1)
    if kind in ("CCITT", "CCITT RLE"):
        return make_tiff((s[..., :1] > 127).astype(np.uint8), "1", "<", 4 if kind == "CCITT" else 2)
    if kind in ("LZMA", "Zstandard"):
        return make_tiff(s, "RGB", "<", 34925 if kind == "LZMA" else 50000, 2)
    comp = {"old-style JPEG": 6, "ThunderScan": 32809}[kind]
    return make_tiff(s, "RGB", "<", 1, extra_tags={259: (3, [comp])})


@pytest.mark.parametrize("kind", ["tiled", "planar", "predictor 3", "JPEG", "CCITT", "YCbCr",
                                  "LAB", "LZMA", "CCITT RLE", "old-style JPEG", "Zstandard",
                                  "ThunderScan"])
def test_what_the_codec_does_not_carry_goes_to_cv2(kind, tmp_path, monkeypatch):
    """No TIFF goes to cv2 any more: each of these kinds, which went to
    cv2 before the codec carried them, reaches ``decode_tiff`` and reads
    as the JAX package reads it, with cv2 importable and blocked and with
    a cv2 route that fails if called.  The old-style JPEG and ThunderScan
    files here hold 8-bit RGB strips (no JPEG data; samples libtiff's
    ThunderScan decoder refuses): both packages raise."""
    data = _not_carried(kind)
    assert timages._decoder(data) is imgcodecs.decode_tiff

    def no_cv2(d, name):
        raise AssertionError("a TIFF reached cv2")

    monkeypatch.setattr(timages, "_cv2_decode", no_cv2)
    read = _same_or_both_raise(tmp_path, data, monkeypatch)
    assert read == (kind not in ("old-style JPEG", "ThunderScan"))


def test_old_style_lzw_is_refused(tmp_path, monkeypatch):
    """libtiff's LSB-first 'compat' LZW (a first strip starting 0x00 with
    the low bit of the next byte set), which the codec refused until it
    carried it, reads as the JAX package reads it: files in that form
    (``make_tiff(..., old_lzw=True)``), and a new-style file whose first
    bytes were set to the old form's test (both raise)."""
    for mode, kw in (("L", {}), ("RGB", dict(predictor=2, rows_per_strip=3)),
                     ("RGBA", dict(tile=(16, 16))), ("I;16", dict(bo=">", planar=True))):
        data = make_tiff(_samples(mode, 21, 35, 1), mode, compression=5, old_lzw=True, **kw)
        assert timages._decoder(data) is imgcodecs.decode_tiff
        assert _same_or_both_raise(tmp_path, data, monkeypatch)
    data = bytearray(make_tiff(_samples("L", 4, 4, 0), "L", "<", 5))
    data[8:10] = b"\x00\x01"
    assert not _same_or_both_raise(tmp_path, bytes(data))


@pytest.mark.parametrize("compression", [5, 8, 32946, 32773])
def test_truncated_and_corrupt_files_raise(compression, tmp_path):
    """A strip cut short, and an LZW or deflate stream with a bad code,
    raise ``ValueError`` in the port and an error in Pillow."""
    s = _samples("RGB", 21, 17, 1)
    data = make_tiff(s, "RGB", "<", compression, 1, 7)
    _, t = imgcodecs._tiff_tags(data)
    cases = {}
    short = bytearray(data)       # the last strip's byte count cut to a third
    ifd = struct.unpack_from("<I", data, 4)[0]
    for k in range(struct.unpack_from("<H", data, ifd)[0]):
        at = ifd + 2 + 12 * k
        if struct.unpack_from("<H", data, at)[0] == 279:
            where = struct.unpack_from("<I", data, at + 8)[0]
            struct.pack_into("<I", short, where + 8, t[279][2] // 3)
    cases["short strip"] = bytes(short)
    if compression != 32773:
        bad = bytearray(data)
        o = t[273][1]
        bad[o + 2:o + 6] = b"\xff\xff\xff\xff"
        cases["bad code"] = bytes(bad)
    for name, d in cases.items():
        path = tmp_path / "in.tif"
        path.write_bytes(d)
        with pytest.raises(ValueError):
            timages.read_image(str(path))
        with pytest.raises(OSError):
            jimages.read_image(str(path))


# ---- the key matrix: every OPEN_INFO key the codec carries ---------------------

KEYED = [m for m in MODES if m != "YCbCr"]     # test_torch_tiff_more.py: YCbCr


@pytest.mark.parametrize("compression", [1, 5, 8, 32773])
@pytest.mark.parametrize("mode", KEYED)
def test_every_key_reads_as_pillow_reads_it(mode, compression, tmp_path, monkeypatch):
    """Each mode of ``MODES`` (one key of Pillow's ``OPEN_INFO`` per byte
    order: gray of 1 to 32 bits, signed and float samples, palettes of 1
    to 8 bits, PX and PA, RGB(A) with their extra samples, CMYK of 8 and
    16 bits, CIELab) in both byte orders, in strips of 3 rows at 11x13, read as
    RGB, RGBA and I: the JAX package's pixels and depth (32-bit and float
    samples past 0 and 65535 kept, as Pillow's ``I`` and clamped ``F``
    make them), or an error where Pillow has no such key or libtiff
    refuses the file.  Every little-endian key is read."""
    bits = MODES[mode][1]
    read = {}
    for bo in ("<", ">"):
        s = _samples(mode, 11, 13, seed=compression)
        data = make_tiff(s, mode, bo, compression, 1, 3,
                         cmap=_palette(bits, bits) if mode.startswith("P") else None)
        read[bo] = _same_or_both_raise(tmp_path, data, monkeypatch)
    assert read["<"]


LAYOUT_MODES = ["1", "L;4", "L inverted", "I;16", "I;32S", "F", "LA", "P;4", "P", "RGB", "RGBa",
                "RGBX", "RGB;16", "RGBA;16", "CMYK", "CMYKX", "CMYK;16", "LAB"]
LAYOUTS = {
    "tiles": dict(tile=(16, 16)),               # edge tiles to the right and below
    "tiles 32x16 predictor 2": dict(tile=(32, 16), predictor=2),
    "planar strips": dict(planar=True, rows_per_strip=5),
    "planar tiles": dict(planar=True, tile=(16, 16)),
    "planar tiles predictor 2": dict(planar=True, tile=(16, 32), predictor=2),
    "fill order 2": dict(fill_order=2, rows_per_strip=4),
    "fill order 2 tiles": dict(fill_order=2, tile=(16, 16)),
    "predictor 3": dict(predictor=3, rows_per_strip=6),
    "predictor 3 planar tiles": dict(predictor=3, planar=True, tile=(16, 16)),
}
# the planar modes of LAYOUT_MODES whose compressed planes Pillow reads
# to other pixels than their chunky file's (LA's alpha lost), which the
# port refuses
PLANAR_REFUSED = ("LA",)


@pytest.mark.parametrize("compression", [1, 5, 8, 32773])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_layouts_read_as_pillow_reads_them(layout, compression, tmp_path, monkeypatch):
    """Tiles with edge tiles in both directions, planar strips and tiles,
    FillOrder 2 (bits reversed by Pillow's ``;R`` unpackers in
    uncompressed files, by libtiff before it decompresses the others),
    predictor 2 on tiles and predictor 3 on float samples, over a set of
    modes and both byte orders at 19x37: the JAX package's read, or an
    error where it raises.  Pillow's own reader of uncompressed planar
    files takes the rawmode's letter of each plane, and the port follows
    it (16-bit and sub-byte planes included)."""
    kw = LAYOUTS[layout]
    modes = ["F"] if "predictor 3" in layout else LAYOUT_MODES
    for mode in modes:
        bits = MODES[mode][1]
        for bo in ("<", ">"):
            s = _samples(mode, 19, 37, seed=len(layout))
            data = make_tiff(s, mode, bo, compression,
                             cmap=_palette(bits, bits) if mode.startswith("P") else None, **kw)
            if kw.get("planar") and compression != 1 and mode in PLANAR_REFUSED:
                with pytest.raises(ValueError, match="planar TIFF .* not carried .*item 8c"):
                    imgcodecs.decode_tiff(data)
                continue
            _same_or_both_raise(tmp_path, data, monkeypatch if mode == "RGB" else None)


@pytest.mark.parametrize("orientation", range(1, 9))
def test_orientation_is_applied_as_pillow_applies_it(orientation, tmp_path):
    """Orientation (tag 274), which Pillow applies at load
    (``ImageOps.exif_transpose``): RGB, ``I;16`` and ``P`` files,
    uncompressed and LZW, both byte orders, read to the JAX package's
    shape and pixels (5-8 swap width and height)."""
    for mode in ("RGB", "I;16", "P"):
        for compression in (1, 5):
            for bo in ("<", ">"):
                s = _samples(mode, 7, 11, seed=orientation)
                data = make_tiff(s, mode, bo, compression, rows_per_strip=3,
                                 cmap=_palette(1) if mode == "P" else None,
                                 extra_tags={274: (3, [orientation])})
                _same_read(tmp_path, data)
                got, _ = imgcodecs.decode_tiff(data)
                assert got.shape[:2] == ((11, 7) if orientation >= 5 else (7, 11))


def test_orientation_outside_1_to_8_is_ignored(tmp_path):
    s = _samples("RGB", 5, 6, seed=0)
    for o in (0, 9, 300):
        data = make_tiff(s, "RGB", "<", 1, extra_tags={274: (3, [o])})
        _same_read(tmp_path, data)
        np.testing.assert_array_equal(imgcodecs.decode_tiff(data)[0], s)


RAWMODES = sorted({(m, raw) for *_, m, raw in imgcodecs._OPEN_INFO_ROWS}
                  | {("I;16", "I;16N"), ("RGB", "RGB;16N"), ("RGBA", "RGBA;16N"),
                     ("RGB", "RGBX;16N"), ("RGBA", "RGBa;16N"), ("CMYK", "CMYK;16N")}
                  | {(m, c) for m, cs in imgcodecs._BAND_RAWMODES.items() for c in cs}
                  | {("LA", "A"), ("RGB", "X"), ("I;16", "I"), ("PA", "P")})


@pytest.mark.parametrize("mode,raw", RAWMODES)
def test_unpackers_are_pillows(mode, raw):
    """Each rawmode the codec meets (and the one-letter ones of planar
    files) unpacks seeded bytes, 5 rows of 7 pixels, as
    ``Image.frombytes(mode, ..., "raw", raw)`` does, or raises where
    Pillow has no such unpacker."""
    bits = imgcodecs._rawmode_bits(raw)
    nbytes = (7 * bits + 7) // 8
    rows = np.random.default_rng(len(raw)).integers(0, 256, (5, nbytes), dtype=np.uint8)
    try:
        want = np.asarray(Image.frombytes(mode, (7, 5), rows.tobytes(), "raw", raw))
    except ValueError:
        with pytest.raises(ValueError, match="unknown raw mode"):
            imgcodecs._unpack(mode, raw, rows, 7)
        return
    got = imgcodecs._unpack(mode, raw, rows, 7)
    if got.ndim == 2:           # one band of a several-band mode
        got, want = got, want[..., imgcodecs._BAND_RAWMODES[mode].index(raw)]
    if mode == "1":
        want = want.astype(np.uint8) * 255
    np.testing.assert_array_equal(got.reshape(want.shape), want)


def test_cmyk_conversion_is_pillows():
    """Every (colour, K) pair of 8 bits through ``_cmyk_rgb`` equals
    Pillow's ``convert("RGB")`` of a CMYK image."""
    c, k = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    v = np.stack([c, 255 - c, (c * 7) % 256, k], -1).astype(np.uint8)
    want = np.asarray(Image.frombytes("CMYK", (256, 256), v.tobytes()).convert("RGB"))
    np.testing.assert_array_equal(imgcodecs._cmyk_rgb(v), want)


CORRUPT = ["tile cut short", "tile with a bad code", "plane cut short", "uncompressed tile past "
           "the end", "strip offsets missing"]


@pytest.mark.parametrize("case", CORRUPT)
def test_truncated_or_corrupt_tiles_and_planes_raise(case, tmp_path):
    """A tile's or plane's byte count cut to a third, an LZW tile with a
    bad code, an uncompressed tile whose rows run past the end of the
    file, and a planar file short of its third plane's strips: the port
    raises ``ValueError`` and the JAX package an error (Pillow loads no
    partial image)."""
    s = _samples("RGB", 21, 35, 1)
    if case.startswith("tile"):
        data = bytearray(make_tiff(s, "RGB", "<", 5, tile=(16, 16)))
        _, t = imgcodecs._tiff_tags(bytes(data))
        if case == "tile cut short":
            data = _set_value(data, 325, 2, t[325][2] // 3)
        else:
            o = t[324][1]
            data[o + 2:o + 6] = b"\xff\xff\xff\xff"
    elif case == "plane cut short":
        data = make_tiff(s, "RGB", "<", 8, planar=True, rows_per_strip=8)
        _, t = imgcodecs._tiff_tags(data)
        data = _set_value(bytearray(data), 279, 7, t[279][7] // 3)
    elif case == "strip offsets missing":
        data = make_tiff(s, "RGB", "<", 8, planar=True, rows_per_strip=8)
        _, t = imgcodecs._tiff_tags(data)
        data = _set_count(bytearray(data), 273, 6)
    else:
        data = make_tiff(s, "RGB", "<", 1, tile=(16, 16))
        _, t = imgcodecs._tiff_tags(data)
        data = _set_value(bytearray(data), 324, 5, len(data) - 50)
    path = tmp_path / "in.tif"
    path.write_bytes(bytes(data))
    with pytest.raises(ValueError):
        timages.read_image(str(path))
    with pytest.raises((OSError, ValueError)):
        jimages.read_image(str(path))


def _entry(data, tag):
    ifd = struct.unpack_from("<I", data, 4)[0]
    for k in range(struct.unpack_from("<H", data, ifd)[0]):
        at = ifd + 2 + 12 * k
        if struct.unpack_from("<H", data, at)[0] == tag:
            return at
    raise KeyError(tag)


def _set_value(data, tag, index, value):
    """A little-endian file with value ``index`` of a LONG tag held out of
    line set to ``value``."""
    where = struct.unpack_from("<I", data, _entry(data, tag) + 8)[0]
    struct.pack_into("<I", data, where + 4 * index, value)
    return data


def _set_count(data, tag, count):
    struct.pack_into("<I", data, _entry(data, tag) + 4, count)
    return data


# ---- chip_smoke.py phase 19's TIFFs, pinned to Pillow ------------------------


@pytest.mark.parametrize("name", sorted(fx.LAYOUT_TIFFS))
def test_phase_19_tiffs_are_pillows(name, tmp_path, monkeypatch):
    """The small TIFFs phase 19(a) writes by hand: the JAX package's
    ``read_image(..., "RGBA")`` pixels hash to
    ``chip_smoke.LAYOUT_TIFF_DIGESTS``, and the port's read equals it,
    with cv2 blocked."""
    data = fx.layout_tiffs()[name]
    path = tmp_path / "in.tif"
    path.write_bytes(data)
    assert fx.rgba_digest(jimages.read_image(str(path), channels="RGBA").pixels) \
        == chip_smoke.LAYOUT_TIFF_DIGESTS[name]
    monkeypatch.setitem(sys.modules, "cv2", None)
    assert timages._decoder(data) is imgcodecs.decode_tiff
    _same_read(tmp_path, data)


def test_phase_19_4k_digests_are_pillows():
    """Phase 19's 3840x2160 TIFFs: Pillow's ``convert("RGB")`` of the
    CMYK levels and its I-mode samples of the I;32S file hash to
    ``chip_smoke.TIFF_4K_DIGESTS`` (the card holds the port's decodes to
    them); the I;32S samples run past 0 and 65535."""
    import hashlib

    (h, w), seed, noise = chip_smoke.CODEC_4K
    rgb8 = fx.levels((h, w), seed, noise)
    cmyk = Image.fromarray(fx.cmyk_levels(rgb8), "CMYK").convert("RGB")
    assert hashlib.sha256(np.asarray(cmyk).tobytes()).hexdigest() \
        == chip_smoke.TIFF_4K_DIGESTS["cmyk"]
    i32 = chip_smoke._i32_levels(rgb8)
    assert i32.min() < 0 and i32.max() > 65535
    data = make_tiff(i32, "I;32S", "<", 8, rows_per_strip=64)
    got = np.ascontiguousarray(np.asarray(Image.open(io.BytesIO(data))), np.int32)
    assert hashlib.sha256(got.tobytes()).hexdigest() == chip_smoke.TIFF_4K_DIGESTS["i32"]


def test_the_key_table_is_pillows():
    """``_OPEN_INFO`` is Pillow's ``OPEN_INFO`` (mode and rawmode of every
    key, YCbCr's and LAB's too)."""
    from PIL import TiffImagePlugin

    pillow = {({b"II": "<", b"MM": ">"}[k[0]],) + k[1:]: v
              for k, v in TiffImagePlugin.OPEN_INFO.items()}
    assert imgcodecs._OPEN_INFO == pillow
