"""Old-style JPEG TIFF (compression 6) on the port's own codec
(``dspfun_tpu_torch/io/ojpeg.py`` through ``io/imgcodecs.py``) against
the JAX package, which reads it through Pillow and libtiff's tif_ojpeg.c.

Each file is written by ``tests/torch_codec_fixtures.py:make_ojpeg`` from
a Pillow baseline JPEG of seeded levels, in both layouts real writers
use: JPEGInterchangeFormat pointing at the whole stream, and the JPEG
tables' tags (JPEGProc, JPEGQTables, JPEGDCTables, JPEGACTables) with the
entropy-coded data in strips.  Each reads through the port's
``read_image`` to the JAX package's arrays and its ``decode_tiff`` to
Pillow's samples at tolerance 0, with cv2 importable and blocked and with
a cv2 route that fails if called, or raises where Pillow raises:

* 4:4:4, 4:2:2 and 4:2:0, gray, sizes that are not whole MCUs, both byte
  orders, several strips with restarts and one strip;
* a YCbCrSubsampling tag that disagrees with the frame (libtiff corrects
  it from the frame), photometric RGB or none (libtiff reads YCbCr),
  ReferenceBlackWhite, JPEGProc 14 (libtiff does not read it);
* truncated strips and stream lengths;
* what libtiff refuses (a frame of another width, missing tables, three
  samples that are not YCbCr, strips that are not whole MCU rows);
* what the port refuses where Pillow reads: big-endian files of several
  strips (Pillow's libtiff reads the strips after the first to other
  pixels than the stream's);
* ``chip_smoke.py`` phase 28's old-style JPEG goldens, pinned to Pillow.
"""

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
from dspfun_tpu_torch.io import images as timages
from tests import torch_codec_fixtures as fx

SUBSAMPLING = {"444": 0, "422": 1, "420": 2}    # Pillow's subsampling= values
MCU = {"444": (8, 8), "422": (8, 16), "420": (16, 16)}


def _jpeg(hw, seed, sub="420", gray=False, **kw) -> bytes:
    rgb = fx.levels(hw, seed)
    img = Image.fromarray(rgb[..., 0] if gray else rgb)
    return fx._save(img, "JPEG", **({} if gray else {"subsampling": SUBSAMPLING[sub]}), **kw)


def _pillow(data):
    try:
        im = Image.open(io.BytesIO(data))
        im.load()
        return np.asarray(im)
    except (OSError, ValueError, SyntaxError) as e:
        return e


def _no_cv2(d, name):
    raise AssertionError("a TIFF reached cv2")


def held(tmp_path, monkeypatch, data, refused: str = "") -> str:
    """The port's read of a TIFF against the JAX package's and Pillow's:
    "read" (equal arrays, as RGBA and I, with cv2 importable and blocked;
    ``decode_tiff``'s samples equal to Pillow's, through
    ``torch_codec_fixtures.pillow_digests``), "both raise", or, where
    ``refused`` is given, "refused" (Pillow reads, the port raises a
    ``ValueError`` matching it).  A file Pillow opens goes to
    ``decode_tiff``."""
    path = tmp_path / "in.tif"
    path.write_bytes(data)
    pil = _pillow(data)
    if imgcodecs.tiff_unidentified(data) is None:
        assert timages._decoder(data) is imgcodecs.decode_tiff
    if refused and not isinstance(pil, Exception):
        try:
            imgcodecs.decode_tiff(data)
        except ValueError as e:
            assert re.search(refused, str(e)), str(e)
        else:
            refused = ""
    with monkeypatch.context() as mp:
        mp.setattr(timages, "_cv2_decode", _no_cv2)
        for blocked in (False, True):
            if blocked:
                mp.setitem(sys.modules, "cv2", None)
            if isinstance(pil, Exception):
                with pytest.raises((OSError, ValueError)):
                    jimages.read_image(str(path))
                with pytest.raises(ValueError):
                    timages.read_image(str(path))
                continue
            if refused:
                with pytest.raises(ValueError, match=refused):
                    timages.read_image(str(path))
                continue
            for ch in ("RGBA", "I") if not blocked else ("RGBA",):
                j, t = jimages.read_image(str(path), channels=ch), \
                    timages.read_image(str(path), channels=ch)
                assert t.depth == j.depth
                np.testing.assert_array_equal(t.pixels, j.pixels)
    if isinstance(pil, Exception):
        return "both raise"
    if refused:
        return "refused"
    got = imgcodecs.decode_tiff(data)[0]
    assert fx.port_digest(got) == fx.pillow_digests(data)[1]
    return "read"


def set_tag(data: bytes, tag: int, values) -> bytes:
    """The TIFF with a SHORT or LONG tag's values overwritten in place."""
    bo = "<" if data[:2] == b"II" else ">"
    d = bytearray(data)
    ifd = struct.unpack_from(bo + "I", d, 4)[0]
    for k in range(struct.unpack_from(bo + "H", d, ifd)[0]):
        at = ifd + 2 + 12 * k
        t, typ, n = struct.unpack_from(bo + "HHI", d, at)
        if t == tag:
            code = {3: "H", 4: "I"}[typ]
            where = at + 8 if n * struct.calcsize(code) <= 4 else \
                struct.unpack_from(bo + "I", d, at + 8)[0]
            struct.pack_into(bo + code * len(values), d, where, *values)
            return bytes(d)
    raise KeyError(tag)


# ---- both layouts, each sampling, both byte orders ---------------------------------

@pytest.mark.parametrize("bo", ["<", ">"])
@pytest.mark.parametrize("sub", ["444", "422", "420"])
@pytest.mark.parametrize("layout", ["jif", "tables"])
def test_layouts_and_samplings_read_as_pillow(layout, sub, bo, tmp_path, monkeypatch):
    """Both layouts at 4:4:4, 4:2:2 and 4:2:0, little- and big-endian, at
    a size of whole MCUs and at one that is not (edge MCUs); the two
    layouts of one stream read alike."""
    reads = {}
    for hw in ((48, 64), (37, 53)):
        jpg = _jpeg(hw, 3 + hw[0], sub)
        data = fx.make_ojpeg(jpg, hw[1], hw[0], layout, bo=bo)
        assert held(tmp_path, monkeypatch, data) == "read"
        other = fx.make_ojpeg(jpg, hw[1], hw[0], "tables" if layout == "jif" else "jif", bo=bo)
        reads[hw] = imgcodecs.decode_tiff(data)[0]
        np.testing.assert_array_equal(reads[hw], imgcodecs.decode_tiff(other)[0])


@pytest.mark.parametrize("layout", ["jif", "tables"])
@pytest.mark.parametrize("photometric", [1, 0])
def test_gray_reads_as_pillow(layout, photometric, tmp_path, monkeypatch):
    """One sample (Pillow's ``L``, as stored: MinIsWhite is not inverted,
    Pillow keys it as YCbCr)."""
    for hw in ((40, 56), (29, 43)):
        data = fx.make_ojpeg(_jpeg(hw, 7, gray=True), hw[1], hw[0], layout,
                             photometric=photometric)
        assert held(tmp_path, monkeypatch, data) == "read"


@pytest.mark.parametrize("sub", ["444", "422", "420"])
def test_strips_with_restarts_read_as_pillow(sub, tmp_path, monkeypatch):
    """Several strips of the tables layout, each a restart interval of one
    or two MCU rows (libtiff puts a restart marker between strips and
    makes the interval the strip's MCUs); the whole restart-marked stream
    in the JPEGInterchangeFormat layout; a strip count of 0 (to the file's
    end) on the last strip."""
    mh = MCU[sub][0]
    for rows_per, hw in ((1, (5 * mh, 72)), (2, (6 * mh - 3, 61))):
        jpg = _jpeg(hw, 11 + rows_per, sub, restart_marker_rows=rows_per)
        data = fx.make_ojpeg(jpg, hw[1], hw[0], "tables", rows=rows_per * mh)
        assert held(tmp_path, monkeypatch, data) == "read"
        assert held(tmp_path, monkeypatch, fx.make_ojpeg(jpg, hw[1], hw[0], "jif")) == "read"
        _, t = imgcodecs._tiff_tags(data)
        counts = list(t[279])
        assert held(tmp_path, monkeypatch, set_tag(data, 279, counts[:-1] + [0])) == "read"


# ---- tags libtiff reads otherwise than written -------------------------------------

@pytest.mark.parametrize("layout", ["jif", "tables"])
def test_a_subsampling_tag_that_disagrees(layout, tmp_path, monkeypatch):
    """A 4:2:0 stream under YCbCrSubsampling 1x1, 2x1 and 4x2, and none:
    libtiff takes the frame's sampling where the stream has a frame (the
    JPEGInterchangeFormat layout), and builds the frame from the tag
    where it has none (the tables layout: the data then decodes as
    Pillow decodes it, which is not the picture)."""
    jpg = _jpeg((48, 64), 21, "420")
    for tag in ((1, 1), (2, 1), (4, 2)):
        data = fx.make_ojpeg(jpg, 64, 48, layout, subsampling=tag)
        got = held(tmp_path, monkeypatch, data, refused="item 8e")
        assert got == "read" if layout == "jif" else got in ("read", "both raise", "refused")


@pytest.mark.parametrize("photometric", [2, 6, None])
def test_photometric_rgb_or_none_reads_as_ycbcr(photometric, tmp_path, monkeypatch):
    """libtiff reads an old-style JPEG of photometric RGB, or without the
    tag, as YCbCr; with ReferenceBlackWhite and YCbCrCoefficients, which
    its RGBA reader's conversion takes."""
    jpg = _jpeg((32, 48), 23, "422")
    extra = {**fx.REFBW, 529: (5, [2990, 10000, 5870, 10000, 1140, 10000])}
    for tags in ({}, extra):
        data = fx.make_ojpeg(jpg, 48, 32, "jif", photometric=photometric or 6, extra_tags=tags)
        if photometric is None:
            data = _without_tag(data, 262)
        assert held(tmp_path, monkeypatch, data) == "read"


def _without_tag(data: bytes, tag: int) -> bytes:
    """The TIFF with ``tag`` renamed to a private tag libtiff ignores."""
    bo = "<" if data[:2] == b"II" else ">"
    d = bytearray(data)
    ifd = struct.unpack_from(bo + "I", d, 4)[0]
    for k in range(struct.unpack_from(bo + "H", d, ifd)[0]):
        at = ifd + 2 + 12 * k
        if struct.unpack_from(bo + "H", d, at)[0] == tag:
            struct.pack_into(bo + "H", d, at, 65000)
    return bytes(d)


def test_jpegproc_is_not_read(tmp_path, monkeypatch):
    """JPEGProc 14 (lossless) on a baseline stream: libtiff does not read
    the tag, and both read the stream as baseline."""
    data = fx.make_ojpeg(_jpeg((32, 48), 25), 48, 32, "tables")
    assert held(tmp_path, monkeypatch, set_tag(data, 512, [14])) == "read"


# ---- truncated and damaged files ---------------------------------------------------

@pytest.mark.parametrize("cut", [1, 3, 5, 7])
def test_truncated_strips_read_as_pillow(cut, tmp_path, monkeypatch):
    """A strip's byte count cut to ``cut`` eighths: in one strip, in the
    middle and last of several (the MCUs after the data's end are zero up
    to the next restart marker, as libjpeg leaves them), and the
    JPEGInterchangeFormat length cut (the strip, the same stream from its
    SOI, follows it: libjpeg meets that marker inside the scan's data, or
    the header is cut and both raise).  A block decoded from the zeros
    whose IDCT leaves the range where libjpeg-turbo's SIMD and C
    arithmetic agree is refused (item 8e)."""
    jpg = _jpeg((64, 80), 31, "420", restart_marker_rows=1)
    one = fx.make_ojpeg(_jpeg((64, 80), 31, "420"), 80, 64, "tables")
    many = fx.make_ojpeg(jpg, 80, 64, "tables", rows=16)
    jif = fx.make_ojpeg(jpg, 80, 64, "jif")
    _, t1 = imgcodecs._tiff_tags(one)
    _, tm = imgcodecs._tiff_tags(many)
    c = list(tm[279])
    cases = [set_tag(one, 279, [t1[279][0] * cut // 8]),
             set_tag(many, 279, c[:1] + [c[1] * cut // 8] + c[2:]),
             set_tag(many, 279, c[:-1] + [c[-1] * cut // 8]),
             set_tag(jif, 514, [len(jpg) * cut // 8])]
    got = [held(tmp_path, monkeypatch, d, refused="item 8e") for d in cases[:3]]
    assert set(got) <= {"read", "refused"} and got.count("read") >= 2
    # the JPEGInterchangeFormat length cut: its stream is restart-marked, and
    # the strip after it starts the stream again (the port refuses), or the
    # header itself is cut (both raise); without restart markers it reads
    assert held(tmp_path, monkeypatch, cases[3], refused="starts the stream again") in (
        "refused", "both raise")
    plain = _jpeg((64, 80), 31, "420")
    cut_jif = set_tag(fx.make_ojpeg(plain, 80, 64, "jif"), 514, [len(plain) * cut // 8])
    assert held(tmp_path, monkeypatch, cut_jif) in ("read", "both raise")


@pytest.mark.parametrize("kind", ["width", "tables", "photometric 1 of 3", "strip rows",
                                  "samples", "bits", "DQT", "marker", "DRI"])
def test_what_libtiff_refuses_raises_in_both(kind, tmp_path, monkeypatch):
    """A frame of another width than the image, the tables layout without
    its JPEGQTables tag, three samples of photometric MinIsBlack (Pillow
    reads libtiff's raw samples as RGBX: it raises), strips that are not
    whole MCU rows, two samples, a 12-bit BitsPerSample (no key of
    Pillow's), a 16-bit DQT, an unknown marker and a bad DRI in the header:
    both packages raise."""
    jpg = _jpeg((48, 64), 41, "420", restart_marker_rows=1)
    if kind == "width":
        data = set_tag(fx.make_ojpeg(jpg, 64, 48, "jif"), 256, [60])
    elif kind == "tables":
        data = _without_tag(fx.make_ojpeg(jpg, 64, 48, "tables", rows=16), 519)
    elif kind == "photometric 1 of 3":
        data = fx.make_ojpeg(jpg, 64, 48, "jif", photometric=1)
    elif kind == "strip rows":
        data = set_tag(fx.make_ojpeg(jpg, 64, 48, "tables", rows=16), 278, [24])
    elif kind == "samples":
        data = set_tag(fx.make_ojpeg(jpg, 64, 48, "jif"), 277, [2])
    elif kind == "bits":
        data = fx.make_ojpeg(jpg, 64, 48, "jif", extra_tags={258: (3, [12] * 3)})
    else:
        d = bytearray(fx.make_ojpeg(jpg, 64, 48, "jif"))      # the stream at offset 8
        at = d.index({"DQT": b"\xff\xdb", "marker": b"\xff\xc4", "DRI": b"\xff\xdd"}[kind])
        if kind == "DQT":
            d[at + 4] |= 0x10
        elif kind == "marker":
            d[at + 1] = 0xC2
        else:
            d[at + 3] = 5
        data = bytes(d)
    assert held(tmp_path, monkeypatch, data) == "both raise"


def test_what_the_port_refuses(tmp_path, monkeypatch):
    """A big-endian file of several strips, which Pillow reads to other
    pixels than the stream's after the first strip (the little-endian
    file of the same strips reads to the stream's); tiles and planes,
    which no writer here makes for Pillow to pin, raise naming item 8c."""
    jpg = _jpeg((48, 64), 43, "420", restart_marker_rows=1)
    be = fx.make_ojpeg(jpg, 64, 48, "tables", bo=">", rows=16)
    assert held(tmp_path, monkeypatch, be, refused="big-endian old-style JPEG") == "refused"
    le = fx.make_ojpeg(jpg, 64, 48, "tables", rows=16)
    assert held(tmp_path, monkeypatch, le) == "read"
    assert not np.array_equal(_pillow(be), _pillow(le))
    tiled = fx.make_ojpeg(jpg, 64, 48, "jif", extra_tags={322: (3, [64]), 323: (3, [48])})
    planar = fx.make_ojpeg(jpg, 64, 48, "jif", extra_tags={284: (3, [2])})
    for data, what in ((tiled, "tiled"), (planar, "planar")):
        with pytest.raises(ValueError, match=f"{what} old-style JPEG .* item 8c"):
            imgcodecs.decode_tiff(data)


# ---- chip_smoke.py phase 28's goldens ----------------------------------------------

def test_phase_28_ojpeg_goldens_are_remade():
    """``ojpeg_goldens()`` remakes each golden byte for byte, and
    ``chip_smoke.OJPEG_FIXTURES`` holds its sha256 and that of Pillow's
    samples of it; the 4K golden is at most 1 MB."""
    made = fx.ojpeg_goldens()
    assert sorted(made) == sorted(fx.OJPEG_GOLDENS)
    for name, data in made.items():
        assert (fx.GOLDENS / name).read_bytes() == data, name
        assert fx.pillow_digests(data) == chip_smoke.OJPEG_FIXTURES[name], name
    assert len(made[fx.OJPEG_4K]) <= 1 << 20
    assert chip_smoke.OJPEG_4K == fx.OJPEG_4K


@pytest.mark.parametrize("name", [n for n in fx.OJPEG_GOLDENS if n != fx.OJPEG_4K])
def test_phase_28_ojpeg_goldens_read_through_the_port(name, tmp_path, monkeypatch):
    data = (fx.GOLDENS / name).read_bytes()
    assert held(tmp_path, monkeypatch, data) == "read"
    assert fx.port_digest(imgcodecs.decode_tiff(data)[0]) == chip_smoke.OJPEG_FIXTURES[name][1]
