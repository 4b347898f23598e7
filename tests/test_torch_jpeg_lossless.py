"""The port's 8-bit lossless JPEG (SOF3, Huffman coding: ``io/jpeg.py`` and
``native/jpeg.cpp:jpg_decode_lossless``) against Pillow, through which the
JAX package reads it (libjpeg-turbo 3.1's jdlhuff.c, jddiffct.c and
jdlossls.c).  Pillow writes no lossless JPEG: the files come from
``tests/torch_codec_fixtures.py:make_lossless_jpeg``, a numpy writer.

* ``read_image`` equals the JAX package's, pixels and depth, over
  predictors 1-7, point transforms 0 and 2, one, three and four
  components, with and without restart intervals, with cv2 importable and
  blocked; sampling factors (upsampled by replication: libjpeg's fancy
  upsampling is off at a DCT size of 1), a scan per component (a restart
  resets the predictor of the first row of the iMCU row it falls in),
  component IDs that name no colour space (RGB, as libjpeg-turbo assumes
  for a lossless file).
* Both packages raise on a JFIF marker or an Adobe transform 1 on three
  components and an Adobe transform 2 on four (libjpeg converts no
  colours in lossless mode), on precisions 12 and 16 (Pillow's SOF
  handler identifies no such file), on a restart interval that is not
  whole rows of MCUs, on bad scan parameters and on truncated files;
  lossless JPEG-in-TIFF reads as Pillow reads it (RGB and gray) or raises
  with it (YCbCr).
* The digests of ``chip_smoke.py`` phase 24's files (``short_jpegs`` and
  ``lossless_jpegs`` of the fixtures module) are Pillow's, and its 4K
  writer and decode rehearse here at a small size.
"""

import hashlib
import io
import struct
import sys

import numpy as np
import pytest
from PIL import Image

import chip_smoke
from dspfun_tpu.io import images as jimages
from dspfun_tpu_torch.io import images as timages
from dspfun_tpu_torch.io import imgcodecs, jpeg
from tests import torch_codec_fixtures as fx

JFIF = fx._jseg(0xE0, b"JFIF\0\1\1\0\0\1\0\1\0\0")


def _adobe(transform):
    return fx._jseg(0xEE, b"Adobe\0\x64\0\0\0\0" + bytes([transform]))


def _samples(h, w, nc, seed):
    """Seeded levels with noise (so every predictor has differences to
    code), gray as their first channel, CMYK as ``cmyk_levels``."""
    rgb = fx.levels((h, w), seed)
    return rgb[..., :1] if nc == 1 else fx.cmyk_levels(rgb) if nc == 4 else rgb


def _same_read(tmp_path, data, monkeypatch=None):
    """read_image of the port equals the JAX package's (pixels and depth,
    three channel sets), with cv2 importable and, given ``monkeypatch``,
    blocked; the port's own decoder takes the file."""
    assert timages._decoder(data) is jpeg.decode_jpeg
    path = tmp_path / "in.jpg"
    path.write_bytes(data)
    for blocked in ((False, True) if monkeypatch else (False,)):
        with (monkeypatch.context() if monkeypatch else _nothing()) as mp:
            if blocked:
                mp.setitem(sys.modules, "cv2", None)
            for ch in ("RGB", "RGBA", "I"):
                j = jimages.read_image(str(path), channels=ch)
                t = timages.read_image(str(path), channels=ch)
                assert t.depth == j.depth == 8
                np.testing.assert_array_equal(t.pixels, j.pixels)


class _nothing:
    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


def _both_raise(tmp_path, data, monkeypatch, match=None):
    path = tmp_path / "in.jpg"
    path.write_bytes(data)
    with pytest.raises(OSError):
        jimages.read_image(str(path))
    for blocked in (False, True):
        with monkeypatch.context() as mp:
            if blocked:
                mp.setitem(sys.modules, "cv2", None)
            with pytest.raises(ValueError, match=match):
                timages.read_image(str(path))


@pytest.mark.parametrize("restart", [False, True])
@pytest.mark.parametrize("nc", [1, 3, 4])
@pytest.mark.parametrize("pt", [0, 2])
@pytest.mark.parametrize("predictor", range(1, 8))
def test_lossless_reads_as_the_jax_package(predictor, pt, nc, restart, tmp_path, monkeypatch):
    h, w = 13, 17
    a = _samples(h, w, nc, 7 * predictor + pt + nc)
    data = fx.make_lossless_jpeg(a, predictor=predictor, pt=pt, restart=2 * w if restart else 0)
    frame, planes = jpeg.decode_coefficients(data)
    assert frame.lossless and not frame.smoothed
    for c, p in zip(frame.components, planes):
        assert p.shape == (c.blocks_h, c.blocks_w) == (h, w)
    _same_read(tmp_path, data, monkeypatch)
    got = jpeg.decode_jpeg(data)[0]
    if nc != 4:
        np.testing.assert_array_equal(got, (a >> pt) << pt)


# name -> (components, sampling factors, scans, restart in MCUs, (h, w))
LAYOUTS = {
    "gray 2x2": (1, [(2, 2)], None, 0, (15, 21)),
    "4:2:0": (3, [(2, 2), (1, 1), (1, 1)], None, 0, (15, 21)),
    "4:2:0 restarts": (3, [(2, 2), (1, 1), (1, 1)], None, 11, (15, 21)),
    "4:2:2": (3, [(2, 1), (1, 1), (1, 1)], None, 0, (15, 21)),
    "1x2 and 2x1": (3, [(1, 2), (2, 1), (1, 1)], None, 0, (16, 19)),
    "4:2:0 a scan per component": (3, [(2, 2), (1, 1), (1, 1)], [(0,), (1,), (2,)], 0, (15, 21)),
    "a scan per component, restarts": (3, [(1, 1)] * 3, [(2,), (0,), (1,)], 21, (15, 21)),
    # one component at 2x2 in its own scan, a restart every one of its rows:
    # the restart before each odd row resets the even row above it
    "2x2 alone, a restart a row": (3, [(2, 2), (1, 1), (1, 1)], [(0,), (1, 2)], 22, (16, 22)),
    "CMYK 2x2 and 1x1": (4, [(2, 2), (1, 1), (1, 1), (1, 1)], None, 0, (11, 9)),
    "CMYK a scan per component": (4, [(1, 1)] * 4, [(0,), (1,), (2,), (3,)], 0, (11, 9)),
}


@pytest.mark.parametrize("predictor", [1, 4, 7])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_lossless_layouts(layout, predictor, tmp_path, monkeypatch):
    nc, sampling, scans, restart, (h, w) = LAYOUTS[layout]
    a = _samples(h, w, nc, predictor)
    data = fx.make_lossless_jpeg(a, predictor=predictor, sampling=sampling, scans=scans,
                                 restart=restart)
    _same_read(tmp_path, data, monkeypatch)


@pytest.mark.parametrize("ids", [(1, 2, 3), (82, 71, 66), (5, 6, 7)])
def test_three_components_are_rgb_without_a_jfif_or_adobe_marker(ids, tmp_path):
    """With no JFIF marker and no Adobe transform (or transform 0), any
    IDs give RGB samples as stored (libjpeg-turbo assumes RGB for a
    lossless file whose IDs name nothing)."""
    a = _samples(12, 14, 3, 1)
    for app in (b"", _adobe(0)):
        data = fx.make_lossless_jpeg(a, predictor=6, ids=list(ids), app=app)
        np.testing.assert_array_equal(jpeg.decode_jpeg(data)[0], a)
        _same_read(tmp_path, data)


def _refused():
    a3, a4, g = _samples(12, 14, 3, 2), _samples(12, 14, 4, 3), _samples(12, 14, 1, 4)
    base = fx.make_lossless_jpeg(g, predictor=1)
    sos = base.index(b"\xff\xda")

    def patched(at, value):
        d = bytearray(base)
        d[sos + at] = value
        return bytes(d)

    return {
        "JFIF": (fx.make_lossless_jpeg(a3, predictor=1, app=JFIF), "YCbCr"),
        "Adobe transform 1": (fx.make_lossless_jpeg(a3, predictor=1, app=_adobe(1)), "YCbCr"),
        "CMYK under Adobe transform 2": (fx.make_lossless_jpeg(a4, predictor=1,
                                                               app=_adobe(2)), "YCCK"),
        "precision 12": (fx.make_lossless_jpeg(g, precision=12), "cannot identify"),
        "precision 16": (fx.make_lossless_jpeg(g, precision=16), "cannot identify"),
        "restart interval not whole rows": (fx.make_lossless_jpeg(a3, predictor=2, restart=5),
                                            "restart interval"),
        "predictor 0": (patched(7, 0), "bad lossless scan"),
        "predictor 8": (patched(7, 8), "bad lossless scan"),
        "Se 1": (patched(8, 1), "bad lossless scan"),
        "point transform 8": (patched(9, 8), "bad lossless scan"),
        "truncated": (base[:len(base) // 2], "truncated"),
        "no EOI": (base[:-2], "truncated"),
    }


@pytest.mark.parametrize("case", list(_refused()))
def test_lossless_refusals(case, tmp_path, monkeypatch):
    """Each raises in both packages, with cv2 importable and blocked."""
    data, match = _refused()[case]
    _both_raise(tmp_path, data, monkeypatch, match)


def test_a_baseline_frame_relabelled_lossless_raises():
    """A baseline file whose SOF is patched to SOF3 (a JFIF file with a
    scan of Ss 0): a corrupt lossless stream, refused by both."""
    img = Image.fromarray(fx.levels((16, 24), 9))
    buf = io.BytesIO()
    img.save(buf, "JPEG")
    d = bytearray(buf.getvalue())
    d[d.index(b"\xff\xc0") + 1] = 0xC3
    with pytest.raises(OSError):
        Image.open(io.BytesIO(bytes(d))).load()
    with pytest.raises(ValueError):
        jpeg.decode_jpeg(bytes(d))


@pytest.mark.parametrize("photo,nc", [(2, 3), (1, 1), (6, 3)])
def test_lossless_jpeg_in_tiff(photo, nc, tmp_path):
    """A lossless stream in a TIFF strip: as stored where the TIFF is RGB
    or gray, refused by both where it is YCbCr (libjpeg would convert)."""
    a = _samples(16, 24, nc, 5)
    tables, blk = fx.split_jpeg(fx.make_lossless_jpeg(a, predictor=5))
    tags = {256: (4, [24]), 257: (4, [16]), 258: (3, [8] * nc), 259: (3, [7]),
            262: (3, [photo]), 277: (3, [nc]), 284: (3, [1]), 347: (7, list(tables)),
            273: (4, []), 278: (4, [16]), 279: (4, [len(blk)])}
    if photo == 6:
        tags[530] = (3, [1, 1])
    data = fx._assemble([blk], tags, "<")
    path = tmp_path / "in.tif"
    path.write_bytes(data)
    if photo == 6:
        with pytest.raises(OSError):
            jimages.read_image(str(path))
        with pytest.raises(ValueError, match="lossless"):
            imgcodecs.decode_tiff(data)
        return
    np.testing.assert_array_equal(imgcodecs.decode_tiff(data)[0].reshape(a.shape), a)
    j, t = jimages.read_image(str(path)), timages.read_image(str(path))
    np.testing.assert_array_equal(t.pixels, j.pixels)


@pytest.mark.parametrize("predictor", [1, 4, 6, 7])
def test_differences_past_8_bits(predictor):
    """Crafted differences (categories 9 to 16; 32768 has no extra bits,
    which a lossless file's DC table may code, jdhuff.c allowing 0..16
    there): the predictions run modulo 2^16 on the undifferenced values,
    and each output sample is the value shifted by the point transform and
    cut to 8 bits, as Pillow reads them."""
    rng = np.random.default_rng(predictor)
    d = rng.integers(-300, 300, (9, 11))
    d[rng.random(d.shape) < 0.2] = 32768
    d[rng.random(d.shape) < 0.1] = -20000
    for pt in (0, 3):
        data = fx.make_lossless_jpeg(np.zeros((9, 11, 1), np.uint8), predictor=predictor, pt=pt,
                                     diffs=[d])
        want = np.asarray(Image.open(io.BytesIO(data)))
        np.testing.assert_array_equal(jpeg.decode_jpeg(data)[0][..., 0], want)


def test_phase_24_digests_are_pillows():
    """``chip_smoke.SHORT_JPEG_DIGESTS`` and ``LOSSLESS_DIGESTS``: the
    sha256 of each file the fixtures module makes at run time and of
    Pillow's ``convert("RGB")`` of it; the port's decode hashes the same."""
    made = {**fx.short_jpegs(), **fx.lossless_jpegs()}
    want = {**chip_smoke.SHORT_JPEG_DIGESTS, **chip_smoke.LOSSLESS_DIGESTS}
    assert sorted(made) == sorted(want)
    for name, data in made.items():
        assert fx.jpeg_digests(data) == want[name], name
        assert timages._decoder(data) is jpeg.decode_jpeg
        assert fx.rgb_digest(jpeg.decode_jpeg(data)[0]) == want[name][1], name
    assert set(chip_smoke.SHORT_4K) <= set(made) and chip_smoke.SHORT_SPEC in made


def test_phase_24_lossless_writer_at_a_small_size():
    """Phase 24c's writer and decode at 270x480 (its argument at 4K is a
    restart interval of 16 rows): Pillow and the port read the levels."""
    hw, seed, noise = chip_smoke.CODEC_4K
    lv = fx.levels((270, 480), seed, noise=noise)
    kw = dict(chip_smoke.LOSSLESS_4K, restart=480 * 16)
    data = fx.make_lossless_jpeg(lv, **kw)
    assert struct.unpack(">H", data[data.index(b"\xff\xdd") + 4:][:2])[0] == 480 * 16
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(data))), lv)
    np.testing.assert_array_equal(jpeg.decode_jpeg(data)[0], lv)
    assert hashlib.sha256(data).hexdigest() == hashlib.sha256(
        fx.make_lossless_jpeg(lv, **kw)).hexdigest()
