"""12-bit JPEG-in-TIFF, ThunderScan and CCITT RLE-W TIFF on the port's own
codecs (``dspfun_tpu_torch/io/imgcodecs.py``, ``io/jpeg.py``,
``native/jpeg.cpp``, ``native/tiff.cpp``, ``native/fax.cpp``) against the
JAX package, which reads them through Pillow and libtiff.

The files are written without Pillow by ``tests/torch_codec_fixtures.py``:
12-bit streams by :func:`make_jpeg12` (SOF1 or SOF0 from seeded quantised
coefficients, Huffman tables of every category up to 15) and
:func:`make_lossless_jpeg` (SOF3 at precision 12), ThunderScan by
:func:`thunder_encode`, RLE-W by ``fax_encode``'s 16-bit alignment.  Each
reads through the port's ``read_image`` to the JAX package's arrays and
its ``decode_tiff`` to Pillow's samples at tolerance 0, with cv2
importable and blocked and with a cv2 route that fails if called, or
raises where Pillow raises (``test_torch_tiff_ojpeg.held``):

* 12-bit gray JPEG-in-TIFF (Pillow's ``I;16`` from rawmode ``I;12``):
  SOF1, SOF0 and SOF3 (predictors, point transform, restarts); strips
  (abbreviated under one JPEGTables, or whole streams) and tiles with edge
  tiles, odd image widths in tiles; 16-bit quantisation tables; extreme
  coefficients (the range limit's wrap); truncated strips.  A strip of an
  odd width, whose last sample of each row libtiff leaves unwritten, the
  port refuses; a frame whose precision is not the TIFF's, and JPEG at
  other depths, raise in both;
* ThunderScan at every 4-bit key of Pillow's ``OPEN_INFO`` (photometric 0
  and 1, a palette; FillOrder 1 and 2), several strips, seeded random code
  streams, rows whose codes come short or run over (both raise), other
  depths and tiles (both raise);
* RLE-W: rows of every length, rows that end on a word, odd strip lengths,
  FillOrder 2, several strips, a strip that runs out early, photometric
  0 and 1, and Pillow's own RLE-W files (``compression="tiff_raw_16"``,
  libtiff's encoder, which libtiff's decoder reads otherwise than
  written: the port reads them as Pillow does);
* ``chip_smoke.py`` phase 28's goldens of these kinds and its 4K 12-bit
  file, pinned to Pillow.
"""

import numpy as np
import pytest
from PIL import Image

import chip_smoke
from dspfun_tpu_torch.io import imgcodecs
from tests import torch_codec_fixtures as fx
from tests.test_torch_tiff_ojpeg import _pillow, held, set_tag


# ---- 12-bit JPEG-in-TIFF -------------------------------------------------------------

@pytest.mark.parametrize("kind", ["sof1", "sof0", "sof3"])
@pytest.mark.parametrize("layout", ["strips", "tiles", "one strip"])
def test_twelve_bit_jpeg_reads_as_pillow(kind, layout, tmp_path, monkeypatch):
    """Each coding in 16-row strips (abbreviated under JPEGTables, and
    whole streams), in 16x16 tiles of an image of odd width (edge tiles
    padded with the edge samples) and in one strip."""
    hw = (45, 64) if layout != "tiles" else (37, 45)
    g = fx.gray12(hw, 3 + len(layout))
    kw = {"strips": dict(rows=16), "tiles": dict(tile=(16, 16)), "one strip": {}}[layout]
    for abbreviated in (True, False):
        data = fx.tiff12(g, kind, abbreviated=abbreviated, **kw)
        assert held(tmp_path, monkeypatch, data) == "read"
    assert imgcodecs.decode_tiff(data)[1] == 16


@pytest.mark.parametrize("case", ["restart", "16-bit DQT", "extreme", "ramp"])
def test_twelve_bit_coefficients_read_as_pillow(case, tmp_path, monkeypatch):
    """A restart every 7 blocks (and every 2 rows of a lossless scan with
    predictor 4 and a point transform), a quantisation table past 255 (a
    16-bit DQT), extreme coefficients (DC category 15, AC up to 14: the
    range limit's wrap at 12 bits), and a full-range ramp."""
    h, w = 40, 48
    g = fx.gray12((h, w), 11)
    q = fx.q12()
    if case == "restart":
        data = fx.tiff12(g, "sof1", restart=7)
        assert held(tmp_path, monkeypatch, data) == "read"
        data = fx.jpeg_in_tiff([fx.make_lossless_jpeg(g, predictor=4, pt=2, restart=2 * w,
                                                      precision=12)], w, h, 1, 1)
        data = set_tag(data, 258, [12])
    elif case == "16-bit DQT":
        data = fx.tiff12(g, "sof1", qtable=q * 300)
    elif case == "extreme":
        rng = np.random.default_rng(4)
        c = fx.jpeg12_coefficients(g, q)
        c[0, 0] = rng.integers(-16000, 16000, 64)
        c[1, 1, 0], c[2, 2, 0], c[3, 3, 5] = 32000, -32000, -16383
        c[2, 3, 1:] = rng.integers(-8000, 8000, 63)
        data = set_tag(fx.jpeg_in_tiff([fx.make_jpeg12(c, q, w, h)], w, h, 1, 1), 258, [12])
    else:
        ramp = (np.arange(h * w).reshape(h, w) * 4095 // (h * w - 1)).astype(np.uint16)
        data = fx.tiff12(ramp, "sof1", rows=8)
        assert held(tmp_path, monkeypatch, fx.tiff12(ramp, "sof3", rows=8)) == "read"
    assert held(tmp_path, monkeypatch, data) == "read"


@pytest.mark.parametrize("predictor", [1, 2, 3, 5, 6, 7])
def test_twelve_bit_lossless_predictors(predictor, tmp_path, monkeypatch):
    """SOF3 at precision 12 with each predictor (and a point transform)."""
    g = fx.gray12((24, 40), predictor)
    data = fx.jpeg_in_tiff([fx.make_lossless_jpeg(g, predictor=predictor, pt=predictor % 3,
                                                  precision=12)], 40, 24, 1, 1)
    assert held(tmp_path, monkeypatch, set_tag(data, 258, [12])) == "read"


@pytest.mark.parametrize("cut", [2, 5])
def test_truncated_twelve_bit_strips(cut, tmp_path, monkeypatch):
    """A strip's byte count cut to ``cut`` eighths: libjpeg under libtiff
    decodes what is there and leaves the rest of the blocks zero (2048),
    as the port does."""
    data = fx.tiff12(fx.gray12((48, 32), 5 + cut), "sof1", rows=16)
    _, t = imgcodecs._tiff_tags(data)
    c = list(t[279])
    assert held(tmp_path, monkeypatch, set_tag(data, 279, c[:1] + [c[1] * cut // 8] + c[2:])) \
        == "read"


def test_what_twelve_bits_refuse(tmp_path, monkeypatch):
    """A strip of an odd width: libtiff packs the samples in pairs and
    leaves each row's last one unwritten (Pillow's last column is
    uninitialised memory), which the port refuses; in tiles (even width)
    the same image reads.  An 8-bit frame under BitsPerSample 12, a 12-bit
    frame under 8 or 16, and a big-endian 12-bit file (no key of Pillow's)
    raise in both.  A 12-bit progressive or arithmetic-coded frame, which
    no writer here makes, is refused naming item 8c."""
    g = fx.gray12((21, 27), 9)
    odd = fx.tiff12(g, "sof1")
    assert held(tmp_path, monkeypatch, odd, refused="odd width") == "refused"
    assert held(tmp_path, monkeypatch, fx.tiff12(g, "sof1", tile=(16, 16))) == "read"
    even = fx.tiff12(fx.gray12((16, 24), 9), "sof1")
    eight = fx.jpeg_in_tiff([fx._save(Image.fromarray(
        (fx.gray12((16, 24), 9) >> 4).astype(np.uint8)), "JPEG")], 24, 16, 1, 1)
    for data in (set_tag(eight, 258, [12]), set_tag(even, 258, [8]), set_tag(even, 258, [16]),
                 fx.tiff12(fx.gray12((16, 24), 9), "sof1", bo=">")):
        assert held(tmp_path, monkeypatch, data) == "both raise"
    sof = even.index(b"\xff\xc1")
    for code in (0xC2, 0xC9):
        d = bytearray(even)
        d[sof + 1] = code
        with pytest.raises(ValueError, match="12-bit .* is not carried .* item 8c"):
            imgcodecs.decode_tiff(bytes(d))


# ---- ThunderScan -------------------------------------------------------------------

THUNDER_KEYS = [(0, 1), (1, 1), (3, 1), (0, 2), (1, 2), (3, 2)]     # (photometric, FillOrder)


@pytest.mark.parametrize("photometric,fill", THUNDER_KEYS)
def test_thunderscan_reads_as_pillow(photometric, fill, tmp_path, monkeypatch):
    """Every 4-bit key of Pillow's OPEN_INFO (``L;4I``, ``L;4``, ``P;4``
    and their FillOrder 2 forms, which libtiff bit-reverses before the
    decoder), seeded code streams at odd and even widths, one strip and
    several, both byte orders."""
    cmap = fx.palette(3, 4) if photometric == 3 else None
    for k, (hw, rps) in enumerate((((9, 16), None), ((23, 37), 8), ((11, 1), 4))):
        rows = fx.levels(hw, 40 + k)[..., 0] >> 4
        for bo in "<>":
            data = fx.thunder_tiff(rows, 10 * k + fill, photometric, rps, bo, fill, cmap)
            assert held(tmp_path, monkeypatch, data) == "read"


@pytest.mark.parametrize("seed", range(6))
def test_thunderscan_random_codes(seed, tmp_path, monkeypatch):
    """Random code bytes: whatever libtiff makes of them (a row's codes
    rarely give its width exactly: then both raise), and random rows
    coded with random choices of code."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 256, 400).astype(np.uint8).tobytes()
    w = int(rng.integers(1, 9))
    data = fx.thunder_tiff(np.zeros((5, w), np.uint8), 0,
                           strip_codec=lambda r, k, c=codes: c)
    assert held(tmp_path, monkeypatch, data) in ("read", "both raise")
    rows = rng.integers(0, 16, (13, 29)).astype(np.uint8)
    assert held(tmp_path, monkeypatch, fx.thunder_tiff(rows, seed, rows_per_strip=5)) == "read"


@pytest.mark.parametrize("case", ["short", "over", "empty strip", "bits 8", "bits 2", "tiles"])
def test_thunderscan_that_libtiff_refuses(case, tmp_path, monkeypatch):
    """A row whose codes end short of its width or pass it ("Not
    enough/Too much data at scanline"), an empty strip, samples of other
    than 4 bits, and tiles (libtiff has no tile decoder for it): both
    raise."""
    rows = fx.levels((6, 10), 50)[..., 0] >> 4
    codes = fx.thunder_encode(rows, 1)
    if case == "short":
        data = fx.thunder_tiff(rows, 1, strip_codec=lambda r, k: codes[:-1])
    elif case == "over":
        data = fx.thunder_tiff(rows, 1, strip_codec=lambda r, k: codes[:-1] + bytes([0x0F]))
    elif case == "empty strip":
        data = fx.thunder_tiff(rows, 1, strip_codec=lambda r, k: b"")
    elif case == "tiles":
        data = fx.thunder_tiff(rows, 1)
        data = fx._assemble([codes], {256: (4, [10]), 257: (4, [6]), 258: (3, [4]),
                                      259: (3, [32809]), 262: (3, [1]), 277: (3, [1]),
                                      322: (3, [16]), 323: (3, [16]), 324: (4, []),
                                      325: (4, [len(codes)])}, "<")
    else:
        data = set_tag(fx.thunder_tiff(rows, 1), 258, [int(case[-1])])
    assert held(tmp_path, monkeypatch, data) == "both raise"


def test_thunderscan_codes_as_libtiff_reads_them():
    """The decoder on hand-made codes: raw 0..15 give 0, 17, ..., 255; a
    run and 2-bit deltas after a raw 5 give 85 85 85 85 102 119 102; an
    empty run after an odd count changes nothing; 3-bit deltas wrap."""
    raw = lambda v: 0xC0 | v  # noqa: E731
    cases = {16: (bytes(raw(v) for v in range(16)), [17 * v for v in range(16)]),
             7: (bytes([raw(5), 0x03, 0x40 | 1 << 4 | 1 << 2 | 3]),
                 [85, 85, 85, 85, 102, 119, 102]),
             4: (bytes([raw(5), raw(6), raw(7), 0x00, raw(8)]), [85, 102, 119, 136])}
    for w, (codes, want) in cases.items():
        data = fx.thunder_tiff(np.zeros((1, w), np.uint8), 0, strip_codec=lambda r, k, c=codes: c)
        np.testing.assert_array_equal(imgcodecs.decode_tiff(data)[0][0, :, 0], want)
        np.testing.assert_array_equal(_pillow(data)[0], want)
    data = fx.thunder_tiff(np.zeros((1, 3), np.uint8), 0,
                           strip_codec=lambda r, k: bytes([raw(1), 0x80 | 5 << 3 | 7, 0x80 | 4 << 3]))
    np.testing.assert_array_equal(imgcodecs.decode_tiff(data)[0][0, :, 0], _pillow(data)[0])


# ---- CCITT RLE-W -------------------------------------------------------------------

@pytest.mark.parametrize("fill", [1, 2])
@pytest.mark.parametrize("photometric", [0, 1])
def test_rlew_reads_as_pillow(photometric, fill, tmp_path, monkeypatch):
    """Seeded pages at several widths (rows of every code length), in one
    strip and in strips of odd row counts (odd strip byte counts), both
    fill orders.  libtiff's word alignment drops the bits it holds past a
    16-bit multiple, whatever the row's codes took: it reads some of these
    strips otherwise than they were written, or fails on them, and the
    port reads them as it does."""
    seen = set()
    for k, (h, w, rps) in enumerate(((10, 37, None), (17, 70, 5), (20, 48, 4), (12, 16, 7))):
        page = fx.doc_page(max(h, 40), w, 60 + k)[:h]
        page[::3, : w // 3] ^= 1
        data = fx.make_tiff(page[..., None], "1", compression=32771, rows_per_strip=rps,
                            fill_order=fill, extra_tags={262: (3, [photometric])})
        seen.add(held(tmp_path, monkeypatch, data))
    assert "read" in seen


def test_rlew_rows_that_end_on_a_word(tmp_path, monkeypatch):
    """Rows whose codes fill whole 16-bit words (no padding) and rows of
    one code, with the strip's byte count odd (a padding byte dropped)."""
    w = 64
    rows = np.zeros((6, w), np.uint8)
    rows[:, 10:20] = 1      # white 10, black 10, white 44: 5 + 7 + 8 = 20 bits
    data = fx.make_tiff(rows[..., None], "1", compression=32771)
    assert held(tmp_path, monkeypatch, data) == "read"
    np.testing.assert_array_equal(imgcodecs.decode_tiff(data)[0][..., 0] > 0, rows > 0)
    blank = fx.make_tiff(np.zeros((5, 16), np.uint8)[..., None], "1", compression=32771)
    assert held(tmp_path, monkeypatch, blank) == "read"
    _, t = imgcodecs._tiff_tags(blank)
    assert held(tmp_path, monkeypatch, set_tag(blank, 279, [t[279][0] - 1])) == "read"


@pytest.mark.parametrize("cut", [1, 3, 6])
def test_rlew_strip_that_runs_out(cut, tmp_path, monkeypatch):
    """A strip's data cut to ``cut`` eighths: libtiff's decoder fails at
    the row it runs out in (both raise), or, where the cut falls in the
    last row's padding, reads."""
    rows = np.zeros((8, 32), np.uint8)
    rows[:, 4:9] = 1
    data = fx.make_tiff(rows[..., None], "1", compression=32771, rows_per_strip=4)
    _, t = imgcodecs._tiff_tags(data)
    c = list(t[279])
    assert held(tmp_path, monkeypatch, set_tag(data, 279, [c[0] * cut // 8, c[1]])) \
        == "both raise"


# ---- chip_smoke.py phase 28's goldens ----------------------------------------------

def test_phase_28_more_goldens_are_remade():
    """``more_tiff_goldens()`` remakes each golden byte for byte, and
    ``chip_smoke.OJPEG_FIXTURES`` holds its sha256 and that of Pillow's
    samples of it."""
    made = fx.more_tiff_goldens()
    assert sorted(made) == sorted(fx.MORE_TIFF_GOLDENS)
    for name, data in made.items():
        assert (fx.GOLDENS / name).read_bytes() == data, name
        assert fx.pillow_digests(data) == chip_smoke.OJPEG_FIXTURES[name], name


@pytest.mark.parametrize("name", fx.MORE_TIFF_GOLDENS)
def test_phase_28_more_goldens_read_through_the_port(name, tmp_path, monkeypatch):
    data = (fx.GOLDENS / name).read_bytes()
    assert held(tmp_path, monkeypatch, data) == "read"
    assert fx.port_digest(imgcodecs.decode_tiff(data)[0]) == chip_smoke.OJPEG_FIXTURES[name][1]


def test_phase_28_4k_twelve_bit_file():
    """Phase 28(c)'s 4K 12-bit file as the phase writes it: its sha256 and
    that of Pillow's samples are ``chip_smoke.TIFF12_4K``, and the port
    decodes it to them."""
    data = fx.tiff12(fx.gray12((chip_smoke.H, chip_smoke.W), chip_smoke.TIFF12_4K_SEED,
                               chip_smoke.TIFF12_4K_NOISE), "sof1")
    assert fx.pillow_digests(data) == chip_smoke.TIFF12_4K
    assert fx.port_digest(imgcodecs.decode_tiff(data)[0]) == chip_smoke.TIFF12_4K[1]


@pytest.mark.parametrize("rows_per_strip", [None, 7])
def test_rlew_of_pillows_own_writer(rows_per_strip, tmp_path, monkeypatch):
    """Pillow writes RLE-W (``compression="tiff_raw_16"``, libtiff's
    encoder): the port reads those files as Pillow does, pages its
    decoder reads otherwise than they were written included."""
    for k, (h, w) in enumerate(((40, 56), (33, 70), (17, 16))):
        page = fx.doc_page(max(h, 40), w, 70 + k)[:h]
        img = Image.fromarray((page == 0).astype(np.uint8) * 255).convert("1")
        kw = {"tiffinfo": {278: rows_per_strip}} if rows_per_strip else {}
        data = fx._save(img, "TIFF", compression="tiff_raw_16", **kw)
        assert held(tmp_path, monkeypatch, data) == "read"
