"""JPEG-in-TIFF, YCbCr, CCITT fax and CIELab TIFF on the port's own
codecs (``dspfun_tpu_torch/io/imgcodecs.py``, ``io/jpeg.py``,
``native/fax.cpp``, ``native/tiff.cpp``) against the JAX package, which
reads them through Pillow, libtiff and LittleCMS.

* JPEG-in-TIFF (compression 7): Pillow's own files (RGB, gray, YCbCr,
  CMYK; strips), files of ``make_tiff`` (the port's 4:2:0 streams in
  strips and in tiles with edge tiles, both byte orders), photometric 0,
  planar RGB and YCbCr of one-component streams, progressive strips.
* YCbCr without JPEG (compressions 1, 5, 8, 32946, 32773): every
  subsampling libtiff's RGBA reader takes (and some it refuses), strips
  and tiles, ReferenceBlackWhite and YCbCrCoefficients, both byte orders;
  the conversion over all 2^24 (Y, Cb, Cr) triples.
* CCITT (compressions 2, 3, 4): Modified Huffman, T.4 1-D and 2-D, EOL
  fill bits, no EOL, T.6, both fill orders, photometric 0 and 1, strips,
  the uncompressed-mode extension code (which libtiff does not support).
* CIELab (photometric 8, 8-bit): chunky and planar, every carried
  compression, strips and tiles, both byte orders, Pillow's JPEG LAB;
  the conversion over all 2^24 (L, a, b) triples; the photometric 8, 9
  and 10 keys Pillow lacks.
* Damaged strips: truncated and corrupt fax and JPEG strips read to
  Pillow's pixels, or raise in both, or are refused by the port where
  Pillow's rows are left undefined (a T.6 strip ending early: libtiff
  leaves the rows after it as its buffer held them) or where libjpeg-turbo's
  SIMD IDCT, which Pillow runs, holds a damaged block otherwise than its C
  version, which the port follows.
* chip_smoke.py phase 20's files, pinned to Pillow.
"""

import hashlib
import io
import re
import struct
import sys

import numpy as np
import pytest
from PIL import Image

import chip_smoke
from dspfun_tpu.io import images as jimages
from dspfun_tpu_torch.io import imgcodecs
from dspfun_tpu_torch.io import jpeg as tjpeg
from dspfun_tpu_torch.io import images as timages
from tests import torch_codec_fixtures as fx
from tests.test_torch_tiff import _same_or_both_raise, _same_read
from tests.torch_codec_fixtures import make_tiff, split_jpeg


def _pil(img, **kw) -> bytes:
    buf = io.BytesIO()
    img.save(buf, "TIFF", **kw)
    return buf.getvalue()


def _jpeg(img, **kw) -> bytes:
    buf = io.BytesIO()
    img.save(buf, "JPEG", **kw)
    return buf.getvalue()


def _set(data: bytes, tag: int, values) -> bytes:
    """A little-endian file with an in-line SHORT tag's value replaced."""
    out = bytearray(data)
    ifd = struct.unpack_from("<I", out, 4)[0]
    for k in range(struct.unpack_from("<H", out, ifd)[0]):
        at = ifd + 2 + 12 * k
        if struct.unpack_from("<H", out, at)[0] == tag:
            struct.pack_into("<H", out, at + 8, values)
            return bytes(out)
    raise KeyError(tag)


def _byte_count(data: bytes, index: int, value: int) -> bytes:
    """A little-endian file with StripByteCounts[index] set to ``value``."""
    out = bytearray(data)
    ifd = struct.unpack_from("<I", out, 4)[0]
    for k in range(struct.unpack_from("<H", out, ifd)[0]):
        at = ifd + 2 + 12 * k
        if struct.unpack_from("<H", out, at)[0] == 279:
            n = struct.unpack_from("<I", out, at + 4)[0]
            where = at + 8 if n == 1 else struct.unpack_from("<I", out, at + 8)[0] + 4 * index
            struct.pack_into("<I", out, where, value)
            return bytes(out)
    raise KeyError(279)


# ---- JPEG-in-TIFF -------------------------------------------------------------


@pytest.mark.parametrize("mode", ["RGB", "L", "YCbCr", "CMYK"])
def test_pillows_jpeg_tiffs_read_as_pillow_reads_them(mode, tmp_path, monkeypatch):
    """Pillow's JPEG-in-TIFF of each mode (JPEGTables, strips of the rows
    its strip size gives, a short last strip): one pixel, odd sizes, many
    strips; with cv2 importable and blocked."""
    for k, (h, w) in enumerate(((1, 1), (9, 17), (70, 131))):
        img = Image.fromarray(fx.levels((h, w), 60 + k)).convert(mode)
        for kw in ({}, {"strip_size": 4096}):
            data = _pil(img, compression="jpeg", **kw)
            assert timages._decoder(data) is imgcodecs.decode_tiff
            assert _same_or_both_raise(tmp_path, data, monkeypatch)


@pytest.mark.parametrize("layout", [dict(rows_per_strip=16), dict(rows_per_strip=None),
                                    dict(tile=(32, 48)), dict(tile=(16, 16))])
def test_jpeg_tiffs_of_the_ports_streams(layout, tmp_path, monkeypatch):
    """4:2:0 YCbCr JPEG-in-TIFF written by ``make_tiff`` from the port's
    ``encode_jpeg`` (tables moved to JPEGTables): strips with a short last
    one, one strip, tiles with edge tiles both ways; both byte orders; the
    YCbCrSubsampling tag absent (the stream's own sampling) or wrong
    (libtiff refuses the strip)."""
    for k, (h, w) in enumerate(((1, 1), (45, 67), (70, 131))):
        rgb = fx.levels((h, w), 70 + k)
        for bo in ("<", ">"):
            data = make_tiff(rgb, "YCbCr", bo, compression=7, **layout)
            assert _same_or_both_raise(tmp_path, data, monkeypatch if bo == "<" else None)
        no_tag = make_tiff(rgb, "YCbCr", compression=7, extra_tags={530: (3, [1, 1])}, **layout)
        assert not _same_or_both_raise(tmp_path, no_tag)
        with pytest.raises(ValueError, match="sampling factors"):
            imgcodecs.decode_tiff(no_tag)


def _plane_streams(planes, rows):
    """Pillow's gray JPEG of each plane's strips of ``rows`` rows, split
    into tables (the first) and abbreviated streams."""
    tables, blocks = b"", []
    for plane in planes:
        for y in range(0, plane.shape[0], rows):
            tables, blk = split_jpeg(_jpeg(Image.fromarray(plane[y:y + rows])))
            blocks.append(blk)
    return tables, blocks


def _sampled_2x2(blk: bytes) -> bytes:
    """A one-component abbreviated stream with its component's sampling
    factors (SOF0) set to 2x2: the same blocks, in the same order."""
    at = blk.index(b"\xff\xc0")
    assert blk[at + 9] == 1 and blk[at + 11] == 0x11
    return blk[:at + 11] + b"\x22" + blk[at + 12:]


@pytest.mark.parametrize("photo", [2, 6])
def test_planar_jpeg_tiffs(photo, tmp_path, monkeypatch):
    """PlanarConfiguration 2 of one-component streams (Pillow's gray
    JPEGs), RGB (libtiff's strip reader, planes interleaved) and YCbCr at
    1x1 (libtiff's RGBA reader, its YCbCr tables) and YCbCr at 2x2, which
    that reader refuses in planes; and plane streams sampled 2x2, which
    libtiff's JPEGPreDecode refuses ("improper JPEG sampling factors")."""
    rgb = fx.levels((37, 45), photo)
    tables, blocks = _plane_streams([rgb[..., c] for c in range(3)], 16)
    for sub, streams in (((1, 1), blocks), ((2, 2), blocks),
                         ((1, 1), [_sampled_2x2(b) for b in blocks])):
        tags = {256: (4, [45]), 257: (4, [37]), 258: (3, [8] * 3), 259: (3, [7]),
                262: (3, [photo]), 273: (4, []), 277: (3, [3]), 278: (4, [16]),
                279: (4, [len(b) for b in streams]), 284: (3, [2]), 347: (7, list(tables))}
        if photo == 6:
            tags[530] = (3, list(sub))
        data = fx._assemble(streams, tags, "<")
        read = _same_or_both_raise(tmp_path, data, monkeypatch)
        assert read == (streams is blocks and (photo == 2 or sub == (1, 1)))
        if streams is not blocks:
            with pytest.raises(ValueError, match="sampling factors"):
                imgcodecs.decode_tiff(data)


def test_gray_jpeg_tiff_of_photometric_0(tmp_path):
    """Pillow's gray JPEG-in-TIFF with photometric 0 (min-is-white): the
    samples as stored, inverted by the ``L;I`` unpacker."""
    data = _pil(Image.fromarray(fx.levels((20, 30), 3)).convert("L"), compression="jpeg")
    data = _set(data, 262, 0)
    assert _same_or_both_raise(tmp_path, data)


def test_progressive_jpeg_strips(tmp_path):
    """Strips that are progressive streams (Pillow's progressive JPEG of
    each strip, its own tables overriding the JPEGTables): read as Pillow
    reads them; a stream whose scans leave coefficients short (its last
    scan dropped), which libjpeg under libtiff smooths and the port once
    refused (item 8g), reads to Pillow's smoothed pixels, at 4:2:0 and at
    4:4:4 in YCbCr and as RGB."""
    rgb = fx.levels((40, 56), 5)
    tables, blocks = b"", []
    for y in range(0, 40, 16):       # each strip keeps its own (optimised) tables
        stream = _jpeg(Image.fromarray(rgb[y:y + 16]), progressive=True, subsampling=0)
        tables, _ = split_jpeg(stream)
        assert stream[2:4] == b"\xff\xe0"
        blocks.append(stream[:2] + stream[4 + struct.unpack_from(">H", stream, 4)[0]:])
    tags = {256: (4, [56]), 257: (4, [40]), 258: (3, [8] * 3), 259: (3, [7]), 262: (3, [6]),
            273: (4, []), 277: (3, [3]), 278: (4, [16]), 279: (4, [len(b) for b in blocks]),
            284: (3, [1]), 347: (7, list(tables)), 530: (3, [1, 1])}
    data = fx._assemble(blocks, tags, "<")
    assert _same_or_both_raise(tmp_path, data)
    from tests import test_torch_jpeg as tj
    short = tj._short_files()["without the last scan"]
    t2, blk = split_jpeg(short)
    tags.update({256: (4, [53]), 257: (4, [37]), 278: (4, [37]), 279: (4, [len(blk)]),
                 347: (7, list(t2)), 530: (3, [2, 2])})
    assert _held(tmp_path, fx._assemble([blk], tags, "<"), "") == "same"
    full = _jpeg(Image.fromarray(rgb), progressive=True, subsampling=0)
    cut = full[:full.rindex(b"\xff\xda")] + b"\xff\xd9"
    assert tjpeg.decode_coefficients(cut)[0].smoothed
    t3, blk = split_jpeg(cut)
    for photo in (6, 2):
        tags.update({256: (4, [56]), 257: (4, [40]), 278: (4, [40]), 279: (4, [len(blk)]),
                     347: (7, list(t3)), 530: (3, [1, 1]), 262: (3, [photo])})
        if photo == 2:
            del tags[530]
        assert _held(tmp_path, fx._assemble([blk], tags, "<"), "") == "same"


def test_twelve_bit_and_old_style_jpeg_are_not_carried(tmp_path):
    """12-bit JPEG-in-TIFF and old-style JPEG (compression 6), which
    named item 8c until the codec carried them, reach ``decode_tiff``
    (tests/test_torch_tiff_12bit.py and test_torch_tiff_ojpeg.py read
    them).  These two read as Pillow reads them: a 12-bit YCbCr file is a
    key Pillow's OPEN_INFO lacks ("cannot identify image file" in both),
    and old-style JPEG over 8-bit RGB strips (no JPEG data) raises in
    both."""
    s = fx.levels((8, 8), 1)
    data = make_tiff(s, "YCbCr", compression=7, extra_tags={258: (3, [12] * 3)})
    assert "unknown pixel mode" in imgcodecs.tiff_unidentified(data)
    assert _held(tmp_path, data, "") == "both raise"
    old = make_tiff(s, "RGB", extra_tags={259: (3, [6])})
    assert timages._decoder(old) is imgcodecs.decode_tiff
    assert _held(tmp_path, old, "") == "both raise"


# ---- YCbCr --------------------------------------------------------------------

SUBSAMPLINGS = [(1, 1), (2, 1), (2, 2), (4, 1), (4, 2), (4, 4), (1, 2), (1, 4), (2, 4), (3, 1)]


@pytest.mark.parametrize("sub", SUBSAMPLINGS)
def test_ycbcr_subsamplings_read_as_pillow_reads_them(sub, tmp_path, monkeypatch):
    """YCbCr samples in blocks of each subsampling under LZW, deflate (8
    and 32946) and PackBits, in strips (a short last one) and tiles (edge
    tiles both ways, 4x4's skew of libtiff's reader), with the default,
    a studio-range ReferenceBlackWhite and Rec. 709 coefficients, both
    byte orders: Pillow's pixels, or both raise (the subsamplings libtiff
    refuses: 1x4, 2x4, 3x1)."""
    refused = sub in ((1, 4), (2, 4), (3, 1))
    rng = np.random.default_rng(sub[0] * 10 + sub[1])
    extras = ({}, fx.REFBW, {529: (5, [2126, 10000, 7152, 10000, 722, 10000])})
    for k, (comp, layout) in enumerate((
            (5, dict(rows_per_strip=8)), (8, dict(tile=(16, 16))), (32946, dict(rows_per_strip=4)),
            (32773, dict(tile=(16, 32))), (5, {}))):
        for (h, w) in ((1, 1), (19, 37)):
            s = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
            for bo in ("<", ">"):
                data = make_tiff(s, "YCbCr", bo, comp, subsampling=sub,
                                 extra_tags=extras[k % 3], **layout)
                read = _same_or_both_raise(tmp_path, data, monkeypatch if k == 0 else None)
                assert read != refused


def test_ycbcr_uncompressed_is_pillows_raw_read(tmp_path):
    """Uncompressed YCbCr: Pillow's own reader takes it with rawmode RGBX
    (4 bytes a pixel), so Pillow's file raises as truncated, in both."""
    data = _pil(Image.fromarray(fx.levels((9, 11), 2)).convert("YCbCr"))
    assert imgcodecs._tiff_tags(data)[1][259] == (1,)
    assert not _same_or_both_raise(tmp_path, data)
    s = np.random.default_rng(4).integers(0, 256, (16, 12, 3)).astype(np.uint8)
    padded = make_tiff(s, "YCbCr", rows_per_strip=4, extra_tags={530: (3, [1, 1])})
    _same_or_both_raise(tmp_path, padded)


def test_ycbcr_conversion_of_every_triple_is_pillows():
    """All 2^24 (Y, Cb, Cr) triples at 1x1, one 4096x4096 deflate file:
    ``decode_tiff``'s uint8 RGB equals Pillow's (libtiff's
    ``TIFFYCbCrtoRGB`` with the default coefficients and
    ReferenceBlackWhite)."""
    y, cb, cr = np.meshgrid(np.arange(256), np.arange(256), np.arange(256), indexing="ij")
    trip = np.stack([y, cb, cr], -1).astype(np.uint8).reshape(4096, 4096, 3)
    data = make_tiff(trip, "YCbCr", compression=8, rows_per_strip=256, subsampling=(1, 1))
    want = np.asarray(Image.open(io.BytesIO(data)))
    got, depth = imgcodecs.decode_tiff(data)
    assert depth == 8
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("extra", ["ReferenceBlackWhite", "YCbCrCoefficients"])
def test_ycbcr_tables_of_other_tags_are_pillows(extra):
    """The tables of a studio-range ReferenceBlackWhite and of Rec. 709
    coefficients over every Y and Cb, Cr at a stride of 3 with both ends
    (256 x 86 x 86 triples: the tables are per sample, so this covers
    every entry of each)."""
    tag = fx.REFBW if extra == "ReferenceBlackWhite" else {
        529: (5, [2126, 10000, 7152, 10000, 722, 10000])}
    c = np.unique(np.r_[np.arange(0, 256, 3), 255])
    y, cb, cr = np.meshgrid(np.arange(256), c, c, indexing="ij")
    trip = np.stack([y, cb, cr], -1).astype(np.uint8).reshape(256 * len(c), len(c), 3)
    data = make_tiff(trip, "YCbCr", compression=8, rows_per_strip=512, subsampling=(1, 1),
                     extra_tags=tag)
    np.testing.assert_array_equal(imgcodecs.decode_tiff(data)[0],
                                  np.asarray(Image.open(io.BytesIO(data))))


# ---- CCITT --------------------------------------------------------------------

FAX = {"RLE": (2, None), "G3 1-D": (3, None), "G3 1-D fill": (3, dict(fill_bits=True)),
       "G3 2-D": (3, dict(two_d_every=4)), "G3 2-D fill": (3, dict(two_d_every=2, fill_bits=True)),
       "G3 no EOL": (3, dict(eol="none", rtc=False)), "G3 no EOL, RTC": (3, dict(eol="none")),
       "G4": (4, None)}


@pytest.mark.parametrize("kind", list(FAX))
def test_fax_reads_as_pillow_reads_it(kind, tmp_path, monkeypatch):
    """Each CCITT coding over a document page and seeded noise, one pixel
    to long rows (make-up codes past 2560), photometric 0 and 1, both
    fill orders, one strip and strips of 5 rows: Pillow's pixels (libtiff
    reads a T.4 strip with no EOL again without EOLs; an RTC after such a
    strip misleads it, and the port alike)."""
    comp, opts = FAX[kind]
    rng = np.random.default_rng(comp)
    for h, w in ((1, 1), (9, 13), (33, 45), (6, 3000)):
        for page in (fx.doc_page(h, w, 1), (rng.random((h, w)) < 0.4).astype(np.uint8)):
            for mode in ("1", "1 inverted"):
                for fill in (1, 2):
                    for rps in (None, 5):
                        data = make_tiff(page[..., None], mode, "<", comp, rows_per_strip=rps,
                                         fax=opts, fill_order=fill)
                        assert _same_or_both_raise(
                            tmp_path, data, monkeypatch if (mode, fill, rps) == ("1", 2, 5)
                            else None, channels=("RGBA",))
    data = make_tiff(fx.doc_page(20, 64, 2)[..., None], "1", ">", comp, fax=opts)
    _same_read(tmp_path, data)


@pytest.mark.parametrize("comp", ["group3", "group4", "tiff_ccitt"])
def test_pillows_fax_files(comp, tmp_path):
    """Pillow's own CCITT files (libtiff's encoder: EOLs, RTC, byte-aligned
    Modified Huffman)."""
    for h, w in ((1, 1), (37, 45), (64, 300)):
        img = Image.fromarray(fx.doc_page(h, w, 3).astype(bool))
        _same_read(tmp_path, _pil(img, compression=comp))


def _damaged(data: bytes, rng, kind: str) -> bytes:
    _, t = imgcodecs._tiff_tags(data)
    k = int(rng.integers(0, len(t[273])))
    off, cnt = t[273][k], t[279][k]
    if kind == "cut":
        return _byte_count(data, k, int(rng.integers(1, max(cnt, 2))))
    out = bytearray(data)
    for _ in range(int(rng.integers(1, 4))):
        out[off + int(rng.integers(0, cnt))] ^= 1 << int(rng.integers(0, 8))
    return bytes(out)


def _held(tmp_path, data, allowed: str) -> str:
    """Pillow's read and the port's: "same", "both raise", or (the port
    raising a ``ValueError`` that matches ``allowed`` where Pillow reads)
    "refused"."""
    path = tmp_path / "in.tif"
    path.write_bytes(data)
    try:
        want = jimages.read_image(str(path), channels="RGBA")
    except (OSError, ValueError, SyntaxError):
        with pytest.raises((ValueError, OSError)):
            timages.read_image(str(path), channels="RGBA")
        return "both raise"
    try:
        got = timages.read_image(str(path), channels="RGBA")
    except ValueError as e:
        assert allowed and re.search(allowed, str(e)), str(e)
        return "refused"
    np.testing.assert_array_equal(got.pixels, want.pixels)
    return "same"


@pytest.mark.parametrize("kind", ["cut", "bad code"])
@pytest.mark.parametrize("coding", ["RLE", "G3 1-D", "G3 2-D fill", "G4"])
def test_damaged_fax_strips(coding, kind, tmp_path):
    """Fax strips cut short or with flipped bits, 40 seeded cases each:
    Pillow's pixels (libtiff recovers from a bad code at the next row and
    fills the row it stops in), or both raise (a T.4 or Modified Huffman
    strip that ends before its last row).  A T.6 strip that ends (an EOFB
    or the data's end) before its last row but one, whose later rows
    libtiff leaves as its buffer held them (uninitialised memory in
    Pillow), the port refuses."""
    comp, opts = FAX[coding]
    rng = np.random.default_rng(len(coding) + len(kind))
    seen = set()
    for case in range(40):
        h, w = int(rng.integers(2, 30)), int(rng.integers(8, 200))
        page = fx.doc_page(h, w, case) if case % 2 else (rng.random((h, w)) < 0.3)
        data = make_tiff(np.asarray(page, np.uint8)[..., None], "1", "<", comp,
                         rows_per_strip=[None, 7][case % 2], fax=opts)
        seen.add(_held(tmp_path, _damaged(data, rng, kind), "libtiff leaves the rows after it"
                       if comp == 4 else ""))
    assert "same" in seen


@pytest.mark.parametrize("kind", ["cut", "bad code"])
@pytest.mark.parametrize("source", ["Pillow", "make_tiff"])
def test_damaged_jpeg_strips(source, kind, tmp_path):
    """JPEG-in-TIFF strips cut short or with flipped bits, 40 seeded cases
    each: Pillow's pixels (libjpeg under libtiff: a stream that runs out
    finishes its MCU on zero bits and leaves the rest gray, a bad code
    decodes as 0), or both raise; or the port refuses a damaged stream
    whose IDCT leaves the range where libjpeg-turbo's SIMD and C arithmetic
    agree, or whose headers libjpeg recovers from and the port does not."""
    rng = np.random.default_rng(len(source) * 7 + len(kind))
    seen = set()
    for case in range(40):
        h, w = int(rng.integers(8, 80)), int(rng.integers(8, 120))
        rgb = fx.levels((h, w), case)
        if source == "Pillow":
            mode = ("RGB", "L", "YCbCr")[case % 3]
            data = _pil(Image.fromarray(rgb).convert(mode), compression="jpeg", strip_size=8192)
        else:
            data = make_tiff(rgb, "YCbCr", compression=7, rows_per_strip=16)
        if kind == "bad code":      # damage the entropy-coded data, past the headers
            _, t = imgcodecs._tiff_tags(data)
            off, cnt = t[273][0], t[279][0]
            out = bytearray(data)
            out[off + int(rng.integers(cnt // 2, cnt - 2))] ^= 1 << int(rng.integers(0, 8))
            damaged = bytes(out)
        else:
            damaged = _damaged(data, rng, "cut")
        seen.add(_held(tmp_path, damaged, "SIMD and C arithmetic|corrupt JPEG-in-TIFF"))
    assert "same" in seen


# ---- CIELab ---------------------------------------------------------------------


def test_lab_conversion_of_every_triple_is_pillows():
    """All 2^24 (L, a, b) triples, one uncompressed 4096x4096 file:
    ``decode_tiff``'s uint8 RGB equals Pillow's ``Image.frombytes("LAB",
    ...).convert("RGB")`` of the same bytes (a and b signed in the file;
    LittleCMS's Lab -> sRGB transform)."""
    i = np.arange(1 << 24, dtype=np.uint32)
    trip = np.stack([i >> 16, i >> 8, i], -1).astype(np.uint8).reshape(4096, 4096, 3)
    want = np.asarray(Image.frombytes("LAB", (4096, 4096), trip.tobytes()).convert("RGB"))
    got, depth = imgcodecs.decode_tiff(make_tiff(trip, "LAB"))
    assert depth == 8
    np.testing.assert_array_equal(got, want)


LAB_LAYOUTS = {
    "strips": dict(rows_per_strip=5),
    "one strip": dict(),
    "tiles": dict(tile=(16, 32)),
    "planar strips": dict(planar=True, rows_per_strip=5),
    "planar tiles": dict(planar=True, tile=(16, 16)),
}


@pytest.mark.parametrize("layout", list(LAB_LAYOUTS))
def test_lab_reads_as_pillow_reads_it(layout, tmp_path, monkeypatch):
    """8-bit CIELab, chunky (Pillow's ``LAB`` rawmode: a and b signed) and
    planar (its one-band unpackers: every sample as stored, and alpha 0),
    uncompressed, LZW and deflate with and without predictor 2, deflate
    32946 and PackBits, both byte orders, at 19x37: the JAX package's
    pixels and depth as RGB, RGBA and I, with cv2 importable and blocked."""
    s = np.random.default_rng(len(layout)).integers(0, 256, (19, 37, 3)).astype(np.uint8)
    for compression, predictor in ((1, 1), (5, 1), (5, 2), (8, 2), (32946, 1), (32773, 1)):
        for bo in ("<", ">"):
            data = make_tiff(s, "LAB", bo, compression, predictor, **LAB_LAYOUTS[layout])
            assert timages._decoder(data) is imgcodecs.decode_tiff
            assert _same_or_both_raise(tmp_path, data, monkeypatch if bo == "<" else None)


def test_pillows_jpeg_lab_tiff(tmp_path, monkeypatch):
    """Pillow's JPEG-compressed LAB TIFF: three components as stored
    (libjpeg's ``JCS_UNKNOWN``), then the LAB rawmode and conversion."""
    for k, (h, w) in enumerate(((1, 1), (16, 24), (45, 67))):
        s = np.random.default_rng(k).integers(0, 256, (h, w, 3)).astype(np.uint8)
        data = _pil(Image.frombytes("LAB", (w, h), s.tobytes()), compression="jpeg")
        assert _same_or_both_raise(tmp_path, data, monkeypatch)


@pytest.mark.parametrize("mode,photo", [("L", 8), ("RGBX", 8), ("RGBA", 8), ("RGB;16", 8),
                                        ("RGB", 9), ("RGB", 10)])
def test_other_lab_keys_are_unknown_modes(mode, photo, tmp_path):
    """CIELab of one sample, with an extra sample or of 16 bits, ICCLab (9)
    and ITULab (10): keys Pillow's ``OPEN_INFO`` lacks, so both raise
    ("unknown pixel mode"); so does 8-bit CIELab in FillOrder 2."""
    s = fx.tiff_samples(mode, 9, 11, photo)
    for data in (make_tiff(s, mode, extra_tags={262: (3, [photo])}),
                 make_tiff(fx.tiff_samples("LAB", 9, 11, photo), "LAB", fill_order=2)):
        assert not _same_or_both_raise(tmp_path, data)
        with pytest.raises(ValueError, match="unknown pixel mode"):
            imgcodecs.decode_tiff(data)


# ---- chip_smoke.py phase 20's files, pinned to Pillow --------------------------


@pytest.mark.parametrize("name", sorted(fx.MORE_TIFFS))
def test_phase_20_tiffs_are_pillows(name, tmp_path, monkeypatch):
    """The small TIFFs phase 20(a) writes by hand: the JAX package's RGBA
    pixels hash to ``chip_smoke.MORE_TIFF_DIGESTS``, and the port's read
    equals them, with cv2 blocked."""
    data = fx.more_tiffs()[name]
    path = tmp_path / "in.tif"
    path.write_bytes(data)
    assert fx.rgba_digest(jimages.read_image(str(path), channels="RGBA").pixels) \
        == chip_smoke.MORE_TIFF_DIGESTS[name]
    monkeypatch.setitem(sys.modules, "cv2", None)
    assert timages._decoder(data) is imgcodecs.decode_tiff
    _same_read(tmp_path, data)


@pytest.mark.parametrize("name", sorted(fx.TIFF_JPEG_GOLDENS))
def test_phase_20_goldens_are_pillows(name, tmp_path, monkeypatch):
    """Pillow's JPEG-in-TIFF goldens: the file is what Pillow writes here,
    its sha256 and the JAX package's RGBA read are
    ``chip_smoke.TIFF_JPEG_FIXTURES``, and the port reads it so, cv2
    blocked."""
    data = (fx.GOLDENS / name).read_bytes()
    assert fx.tiff_jpeg_goldens()[name] == data
    path = tmp_path / "in.tif"
    path.write_bytes(data)
    want = chip_smoke.TIFF_JPEG_FIXTURES[name]
    assert (hashlib.sha256(data).hexdigest(),
            fx.rgba_digest(jimages.read_image(str(path), channels="RGBA").pixels)) == want
    monkeypatch.setitem(sys.modules, "cv2", None)
    assert fx.rgba_digest(timages.read_image(str(path), channels="RGBA").pixels) == want[1]


@pytest.mark.parametrize("kind", ["jpeg", "g4", "ycbcr"])
def test_phase_20_4k_digests_are_pillows(kind):
    """Phase 20(b)'s 3840x2160 files: Pillow's ``convert("RGB")`` hashes
    to ``chip_smoke.TIFF_MORE_4K_DIGESTS`` (the card holds the port's
    decodes to them); the G4 page stays small."""
    (h, w), seed, noise = chip_smoke.CODEC_4K
    data = fx.tiff_4k(kind, (h, w), seed, noise)
    px = np.ascontiguousarray(np.asarray(Image.open(io.BytesIO(data)).convert("RGB")))
    assert hashlib.sha256(px.tobytes()).hexdigest() == chip_smoke.TIFF_MORE_4K_DIGESTS[kind]
    if kind == "g4":
        assert len(data) < 300_000


@pytest.mark.parametrize("coding", ["G3 2-D", "G4"])
def test_uncompressed_mode_extension(coding, tmp_path):
    """A 2-D row that starts with the extension code of T.4/T.6's
    uncompressed mode (``0000001`` and a mode), with T4Options or
    T6Options bit 1 set: libtiff does not support it (it ends the row
    there, white to its end, and goes on with the next), and the port
    reads what Pillow reads."""
    comp, opts = FAX[coding]
    page = fx.doc_page(12, 64, 9)
    ref, rows = np.zeros(64, np.uint8), []
    for k, row in enumerate(page):
        bits = fx.fax_2d(row, ref) if comp == 4 or k % 4 else fx.fax_1d(row)
        if k == 5:
            bits = "0000001111" + bits
        if comp == 3:
            bits = fx.FAX_EOL + ("1" if k % 4 == 0 else "0") + bits
        rows.append(bits)
        ref = row
    data = fx._pack_bits("".join(rows) + (fx.FAX_EOL * 2 if comp == 4 else ""))
    tags = {256: (4, [64]), 257: (4, [12]), 258: (3, [1]), 259: (3, [comp]), 262: (3, [0]),
            273: (4, []), 278: (4, [12]), 279: (4, [len(data)]),
            292 if comp == 3 else 293: (4, [3 if comp == 3 else 2])}
    assert _held(tmp_path, fx._assemble([data], tags, "<"), "") == "same"
