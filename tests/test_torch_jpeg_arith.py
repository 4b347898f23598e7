"""The port's arithmetic-coded JPEG (SOF9 and SOF10: ``io/jpeg.py`` and
``native/jpeg.cpp:jpg_decode_arith``) against Pillow, through which the JAX
package reads it (libjpeg-turbo's jdarith.c).  Pillow writes no
arithmetic-coded JPEG: ``tests/jpeg_arith_writer.c``, built here with
``gcc`` against the system's libjpeg-turbo (headers and ``-ljpeg``) once
per test process, writes the coefficients of Pillow's files again with
libjpeg's arithmetic coder, as ``jpegtran -arithmetic`` does (and, for the
Huffman twin of a file, with its Huffman coder under the same scan script).

* Parity: ``read_image`` of the port equals the JAX package's, pixels and
  depth, with cv2 importable and blocked (no JPEG reaches cv2), and the
  JAX package reads the Huffman twin to the same pixels: gray, RGB at
  4:2:0, 4:2:2 and 4:4:4, CMYK, YCCK and RGB under an Adobe marker; one
  interleaved scan, a scan per component, libjpeg's simple progression and
  hand-written scripts (AC refinement over several bits, one component
  per scan); restart intervals in MCUs and MCU rows; DAC conditioning
  (DC L and U, AC Kx) and statistics tables past 1; odd sizes and seeds.
* Pillow's 65,536-byte chunks (``ImageFile.MAXBLOCK``): libjpeg's
  arithmetic decoder cannot suspend, so a scan that needs a byte past the
  chunks read when it starts raises in Pillow; the port raises a
  ``ValueError`` saying so at the same edges (byte by byte around 65,536,
  an SOS header across the edge, later progressive scans, restart markers,
  a large APP segment).  F3: a large arithmetic file once read through cv2
  where the JAX package raises.  JPEG-in-TIFF has no such window.
* Short progressive files (smoothed), seeded damage (a bad code leaves
  the rest of its restart interval as it stands), a Huffman file under
  SOF9, truncation, bad DAC segments, and frames libjpeg does not decode
  (differential, SOF11), as Pillow reads them or raises.
* JPEG-in-TIFF: arithmetic strips and tiles, whole streams and abbreviated
  ones under JPEGTables (whose DAC a stream's SOI resets), at gray, RGB and
  YCbCr photometrics, as libtiff reads them through Pillow.
* The QM coder's Qe table equals the one in Pillow's own libjpeg
  (``jpeg_aritab``, read through ctypes), and ``chip_smoke.py`` phase 27's
  goldens are remade byte for byte, their digests Pillow's.
"""

import ctypes
import io
import re
import struct
import sys
from pathlib import Path

import numpy as np
import PIL
import pytest
from PIL import Image

import chip_smoke
from dspfun_tpu.io import images as jimages
from dspfun_tpu_torch.io import images as timages
from dspfun_tpu_torch.io import imgcodecs, jpeg
from tests import torch_codec_fixtures as fx

ROOT = Path(__file__).resolve().parent.parent
CHUNK = 65536


@pytest.fixture(scope="session")
def writer(tmp_path_factory):
    """The transcoder, built once per test process (a failed build fails
    the tests with the compiler's message)."""
    return fx.build_arith_writer(tmp_path_factory.mktemp("arith_writer"))


def _levels(h, w, seed):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = 128 + 90 * np.sin(x[..., None] / 5.0 + y[..., None] / 7.0 + np.arange(4))
    return np.clip(base + rng.normal(0, 14, (h, w, 4)), 0, 255).astype(np.uint8)


def _source(kind, h, w, seed, quality=85):
    """Pillow's JPEG of seeded levels, and the writer's options that mark it
    (``-y``: YCCK)."""
    px = _levels(h, w, seed)
    kw, opts = {"quality": quality}, ()
    if kind == "gray":
        img = Image.fromarray(px[..., 0])
    elif kind in ("cmyk", "ycck"):
        img = Image.fromarray(px, "CMYK")
        opts = ("-y",) if kind == "ycck" else ()
    else:
        img = Image.fromarray(px[..., :3])
        kw["subsampling"] = {"420": 2, "422": 1, "444": 0, "adobe_rgb": 0}[kind]
        kw["keep_rgb"] = kind == "adobe_rgb"
    buf = io.BytesIO()
    img.save(buf, "JPEG", **kw)
    return buf.getvalue(), opts


def _no_cv2(data, name):
    raise AssertionError(f"a {name} file reached cv2")


def _jax(path, channels="RGB"):
    try:
        return jimages.read_image(str(path), channels=channels)
    except (OSError, ValueError, SyntaxError) as e:
        return e


def _held(tmp_path, monkeypatch, data, suffix="jpg", twin=None, damaged=False):
    """The port's read of ``data`` against the JAX package's, with cv2
    importable and blocked: equal pixels and depth, or a ``ValueError``
    where the JAX package raises (or, ``damaged``, the port's refusal of a
    block past the range where libjpeg-turbo's SIMD and C IDCTs agree).
    ``twin``: a file the JAX package reads to the same pixels.  Returns
    "read", "raised" or "simd"."""
    path = tmp_path / f"arith.{suffix}"
    path.write_bytes(data)
    j = _jax(path)
    if twin is not None:
        tpath = tmp_path / f"twin.{suffix}"
        tpath.write_bytes(twin)
        h = _jax(tpath)
        assert not isinstance(h, Exception) and not isinstance(j, Exception), (h, j)
        np.testing.assert_array_equal(j.pixels, h.pixels)
    outcome = None
    for blocked in (False, True):
        with monkeypatch.context() as mp:
            mp.setattr(timages, "_cv2_decode", _no_cv2)
            if blocked:
                mp.setitem(sys.modules, "cv2", None)
            try:
                t = timages.read_image(str(path))
            except ValueError as e:
                t = e
        if isinstance(j, Exception):
            assert isinstance(t, ValueError), "the JAX package raises, the port reads"
            assert "ROADMAP" not in str(t), t
            outcome = "raised"
        elif isinstance(t, ValueError):
            assert damaged and "SIMD and C arithmetic" in str(t), t
            outcome = "simd"
        else:
            assert t.depth == j.depth
            np.testing.assert_array_equal(t.pixels, j.pixels)
            outcome = "read"
    return outcome


def _arith(writer, src, *opts):
    return fx.arith_transcode(writer, src, *opts)


# ---- the QM coder's table -------------------------------------------------------

def test_qe_table_is_pillows_libjpeg():
    """``native/jpeg.cpp``'s Table D.2 (Qe, Next_Index_LPS, Next_Index_MPS,
    Switch_MPS of each of 114 states) equals ``jpeg_aritab`` of the
    libjpeg Pillow links, which packs each state as Qe << 16 | Next_Index_MPS
    << 8 | Switch_MPS << 7 | Next_Index_LPS."""
    libs = Path(PIL.__file__).resolve().parent.parent / "pillow.libs"
    lib = ctypes.CDLL(str(next(libs.glob("libjpeg-*.so*"))))
    aritab = list((ctypes.c_long * 114).in_dll(lib, "jpeg_aritab"))
    assert aritab[0] == 0x5A1D0181 and aritab[113] == 0x5A1D7171
    src = (ROOT / "dspfun_tpu_torch" / "native" / "jpeg.cpp").read_text()
    body = src[src.index("const QeState kQe[114] = {"):]
    body = body[:body.index("};")]
    rows = re.findall(r"\{(0x[0-9A-F]{4}),\s*(\d+),\s*(\d+),\s*(\d)\}", body)
    assert len(rows) == 114
    packed = [int(qe, 16) << 16 | int(nmps) << 8 | int(sw) << 7 | int(nlps)
              for qe, nlps, nmps, sw in rows]
    assert packed == aritab


# ---- parity: kinds x scripts, restarts, conditioning, sizes ----------------------

KINDS = ["gray", "420", "422", "444", "cmyk", "ycck", "adobe_rgb"]
SIZES = [(1, 1), (7, 9), (17, 33), (37, 53), (61, 94), (90, 70)]


def _script(kind, name):
    """A scan script for the writer: AC refinement over several bits
    ("refine"), or one component per scan of a sequential file in another
    order ("per_component")."""
    n = {"gray": 1, "cmyk": 4, "ycck": 4}.get(kind, 3)
    if name == "per_component":
        return ";".join(f"{c}:0:63:0:0" for c in [n - 1, *range(n - 1)])
    comps = ",".join(map(str, range(n)))
    scans = [f"{comps}:0:0:0:2", "0:1:5:0:3", "0:6:63:0:2"]
    scans += [f"{c}:1:63:0:1" for c in range(1, n)]
    scans += ["0:1:5:3:2", f"{comps}:0:0:2:1", "0:1:63:2:1"]
    scans += [f"{c}:1:63:1:0" for c in range(n)]
    return ";".join(scans + [f"{comps}:0:0:1:0"])


def _options(kind, script, k):
    """The writer's options of case ``k``: its scan script, then a restart
    interval (none, in MCUs or in MCU rows) and conditioning by turns."""
    scripts = {"sequential": [], "progressive": ["-p"]}
    opts = scripts[script] if script in scripts else ["-s", _script(kind, script)]
    opts += [[], ["-r", 1 + k % 5], ["-R", 1 + k % 2]][k % 3]
    if k % 2:
        opts += ["-d", f"0:{k % 3}:{3 + k % 5}", "-k", f"0:{1 + 7 * k % 63}"]
        if kind != "gray":
            opts += ["-d", f"1:{k % 2}:{1 + k % 4}", "-k", f"1:{(11 * k) % 64}"]
    return opts


PARITY = [(kind, script) for kind in KINDS
          for script in ("sequential", "progressive", "refine", "per_component")]


@pytest.mark.parametrize("k", range(len(PARITY)),
                         ids=[f"{kind}-{script}" for kind, script in PARITY])
def test_read_as_the_jax_package_reads_it(k, writer, tmp_path, monkeypatch):
    """port(arithmetic) == JAX(arithmetic) == JAX(the Huffman twin)."""
    kind, script = PARITY[k]
    h, w = SIZES[k % len(SIZES)]
    src, mark = _source(kind, h, w, seed=k)
    opts = [*mark, *_options(kind, script, k)]
    data = _arith(writer, src, *opts)
    frame = jpeg.decode_coefficients(data)[0]
    assert frame.arithmetic and frame.progressive == (script in ("progressive", "refine"))
    twin = _arith(writer, src, "-h", *opts)     # the conditioning is the arithmetic coder's
    assert timages._decoder(data) is jpeg.decode_jpeg
    assert _held(tmp_path, monkeypatch, data, twin=twin) == "read"


@pytest.mark.parametrize("tables", [(0, 0, 0, 0), (5, 7, 15, 2), (3, 3, 9, 9)])
def test_statistics_tables_past_one(tables, writer, tmp_path, monkeypatch):
    """libjpeg keeps 16 arithmetic statistics tables: components may name
    any of them (and share them), in sequential and progressive files,
    conditioned per table."""
    src, _ = _source("420", 45, 67, seed=3)
    y_dc, y_ac, c_dc, c_ac = tables
    for prog in ((), ("-p",)):
        data = _arith(writer, src, *prog, "-t", f"0:{y_dc}:{y_ac}", "-t", f"1:{c_dc}:{c_ac}",
                      "-t", f"2:{c_dc}:{c_ac}", "-d", f"{c_dc}:1:2", "-k", f"{c_ac}:3")
        assert _held(tmp_path, monkeypatch, data, twin=_arith(writer, src, "-h")) == "read"


@pytest.mark.parametrize("kx", [0, 1, 63, 64, 255])
def test_ac_conditioning_of_any_value(kx, writer, tmp_path, monkeypatch):
    """libjpeg takes any Kx (0 and values past 63 included: every band then
    codes its magnitudes in one set of statistics) and so does the port."""
    src, _ = _source("444", 24, 40, seed=kx)
    data = _arith(writer, src, "-k", f"0:{kx}", "-k", f"1:{kx}")
    assert _held(tmp_path, monkeypatch, data, twin=src) == "read"


@pytest.mark.parametrize("lu", ["0:0", "0:15", "15:15", "4:9", "1:1"])
def test_dc_conditioning_over_l_and_u(lu, writer, tmp_path, monkeypatch):
    src, _ = _source("gray", 33, 45, seed=len(lu))
    for prog in ((), ("-p",)):
        data = _arith(writer, src, *prog, "-d", f"0:{lu}")
        assert _held(tmp_path, monkeypatch, data, twin=src) == "read"


# ---- Pillow's 65,536-byte chunks ---------------------------------------------------

def _com(n):
    """COM segments of ``n`` bytes in all (n = 0 or n >= 4)."""
    out = b""
    while n:
        k = n if n <= 60000 else 60000 if n - 60000 >= 4 else n - 4
        out += b"\xff\xfe" + struct.pack(">H", k - 2) + bytes(k - 4)
        n -= k
    return out


def _scan_starts(data):
    """Index of each SOS marker."""
    out, pos = [], 0
    while (pos := data.find(b"\xff\xda", pos)) >= 0:
        out.append(pos)
        pos += 2
    return out


@pytest.fixture(scope="module")
def window_files(tmp_path_factory):
    """A sequential and a progressive file of about 13 KB, with and without
    restarts."""
    w = fx.build_arith_writer(tmp_path_factory.mktemp("arith_writer_w"))
    rng = np.random.default_rng(3)
    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 256, (120, 150, 3), dtype=np.uint8)).save(buf, "JPEG",
                                                                             quality=85)
    src = buf.getvalue()
    return {name: fx.arith_transcode(w, src, *opts) for name, opts in
            (("sequential", ()), ("progressive", ("-p",)), ("restarts", ("-r", 5)),
             ("progressive restarts", ("-p", "-r", 7)))}


def _window_case(tmp_path, monkeypatch, data, want):
    """Both packages read ``data`` (``want`` "read") or both raise
    ("raised"); the port's message is Pillow's and names its chunks."""
    assert len(data) > 4
    got = _held(tmp_path, monkeypatch, data)
    assert got == want, (len(data), got)
    if want == "raised":
        with pytest.raises(ValueError, match=r"broken data stream.*65,536-byte chunk"):
            jpeg.decode_jpeg(data)


@pytest.mark.parametrize("size", [65534, 65535, 65536, 65537, 65538])
@pytest.mark.parametrize("name", ["sequential", "progressive"])
def test_pillows_window_byte_by_byte(name, size, window_files, tmp_path, monkeypatch):
    """Padded by a COM segment after SOI: each reads up to 65,536 bytes
    (its EOI at 65,534: the scan's decoder reads the marker's code at
    65,535) and raises from 65,537, in both packages."""
    data = window_files[name]
    padded = data[:2] + _com(size - len(data)) + data[2:]
    _window_case(tmp_path, monkeypatch, padded, "read" if size <= CHUNK else "raised")


@pytest.mark.parametrize("offset", [-1, 0, 1, 6, 13, 14, 15, 40])
def test_an_sos_header_across_the_edge(offset, window_files, tmp_path, monkeypatch):
    """The SOS segment (14 bytes with its marker) starts ``offset`` bytes
    before 65,536: where it crosses the edge (or starts past it) libjpeg's
    marker reader waits for the next chunk, and the scan then has it; where
    it ends within the first chunk, the scan's data crosses the edge (a
    header that ends at 65,536 leaves its scan no byte) and raises."""
    data = window_files["sequential"]
    sos = _scan_starts(data)[0]
    assert struct.unpack_from(">H", data, sos + 2)[0] == 12
    padded = data[:sos] + _com(CHUNK - offset - sos) + data[sos:]
    want = "raised" if offset >= 14 else "read"
    _window_case(tmp_path, monkeypatch, padded, want)


@pytest.mark.parametrize("target,want", [(CHUNK - 300, "raised"), (CHUNK + 10, "read"),
                                         (2 * CHUNK - 40, "raised"), (CHUNK - 20, "raised")])
@pytest.mark.parametrize("scan", [1, 4, -1])
def test_later_progressive_scans(scan, target, want, window_files, tmp_path, monkeypatch):
    """A progressive file padded before one of its later scans, which then
    starts at ``target``: read where it and the scans after it (to the EOI)
    fit in the chunks read when each starts, raised where one crosses."""
    data = window_files["progressive"]
    at = _scan_starts(data)[scan]
    padded = data[:at] + _com(target - at) + data[at:]
    rest = len(padded) - target
    if want == "read":
        assert target > CHUNK and rest < CHUNK - 10
    _window_case(tmp_path, monkeypatch, padded, want)


@pytest.mark.parametrize("shift", range(-3, 4))
@pytest.mark.parametrize("name", ["restarts", "progressive restarts"])
def test_a_restart_marker_at_the_edge(name, shift, window_files, tmp_path, monkeypatch):
    """A restart marker moved to the edge (its code at 65,535 + ``shift``):
    whether the interval's decoder or the marker reader meets it, a byte
    past the chunk raises, in both packages."""
    data = window_files[name]
    rst = data.index(b"\xff\xd3")
    pad = CHUNK - 1 + shift - (rst + 1)
    padded = data[:2] + _com(pad) + data[2:]
    assert padded[CHUNK - 1 + shift] == 0xD3
    _window_case(tmp_path, monkeypatch, padded, "raised")
    # and the same file short enough to fit in the first chunk reads
    _window_case(tmp_path, monkeypatch, data[:2] + _com(pad - 20000) + data[2:], "read")


@pytest.mark.parametrize("app", [65000, 65533, 65537])
def test_a_large_app_segment_before_the_frame(app, window_files, tmp_path, monkeypatch):
    """An APP1 segment of ``app`` bytes after SOI, which Pillow's source
    manager skips over the chunk's end: where the first scan's header then
    ends past 65,536 every scan reads from the second chunk; where it ends
    within the first, its data crosses the edge and raises.  Padded to
    131,073 bytes, the last scan crosses the second chunk's end."""
    for name in ("sequential", "progressive"):
        data = window_files[name]
        seg = b"\xff\xe1" + struct.pack(">H", app - 2) + b"\x11" * (app - 4)
        padded = data[:2] + seg + data[2:]
        sos = _scan_starts(padded)[0]
        sos_end = sos + 2 + struct.unpack_from(">H", padded, sos + 2)[0]
        _window_case(tmp_path, monkeypatch, padded, "read" if sos_end > CHUNK else "raised")
        fill = 2 * CHUNK - len(padded) + 1
        over = data[:2] + seg + _com(fill) + data[2:]
        _window_case(tmp_path, monkeypatch, over, "raised")


def test_f3_a_large_arithmetic_jpeg_raises_with_cv2(writer, tmp_path, monkeypatch):
    """F3: the 4K golden's coefficients as an arithmetic sequential file
    (198,880 bytes) raise in the JAX package (Pillow's chunks); the port
    once read it through cv2.  It raises in the port with cv2 importable
    and blocked, and no JPEG reaches cv2."""
    data = _arith(writer, (fx.GOLDENS / "codec_prog_4k.jpg").read_bytes())
    assert len(data) > 3 * CHUNK and jpeg.frame_header(data).marker == 0xC9
    path = tmp_path / "big.jpg"
    path.write_bytes(data)
    with pytest.raises(OSError, match="broken data stream"):
        jimages.read_image(str(path))
    pytest.importorskip("cv2")
    for blocked in (False, True):
        with monkeypatch.context() as mp:
            mp.setattr(timages, "_cv2_decode", _no_cv2)
            if blocked:
                mp.setitem(sys.modules, "cv2", None)
            with pytest.raises(ValueError, match="broken data stream") as e:
                timages.read_image(str(path))
        assert "ROADMAP" not in str(e.value)


def test_phase_27_past_the_window_raises_in_both():
    """``chip_smoke.arith_past_window`` of phase 27(b)'s golden raises in
    both packages; one byte shorter it reads."""
    data = (fx.GOLDENS / chip_smoke.ARITH_PAST).read_bytes()
    past = chip_smoke.arith_past_window(data)
    assert len(past) == chip_smoke.ARITH_PAST_SIZE == CHUNK + 1
    with pytest.raises(OSError, match="broken data stream"):
        Image.open(io.BytesIO(past)).load()
    with pytest.raises(ValueError, match="broken data stream"):
        jpeg.decode_jpeg(past)
    fits = chip_smoke.arith_past_window(data, CHUNK)
    np.testing.assert_array_equal(jpeg.decode_jpeg(fits)[0],
                                  np.asarray(Image.open(io.BytesIO(fits)).convert("RGB")))


# ---- short progressive files, damage, truncation ------------------------------------

@pytest.mark.parametrize("kind", ["420", "gray", "cmyk", "444"])
@pytest.mark.parametrize("keep", [1, 3, 6, 9])
def test_short_progressive_files_are_smoothed(kind, keep, writer, tmp_path, monkeypatch):
    """A progressive file cut after its first ``keep`` scans (an
    interrupted download): smoothed as libjpeg-turbo smooths it, equal to
    the JAX package's read and to its read of the Huffman file cut alike."""
    src, _ = _source(kind, 53, 77, seed=keep)
    script = _script(kind, "refine")
    cut = lambda d: fx.cut_scans(d, lambda k, s: k < keep)  # noqa: E731
    data, twin = cut(_arith(writer, src, "-s", script)), cut(_arith(writer, src, "-h", "-s",
                                                                        script))
    frame = jpeg.decode_coefficients(data)[0]
    assert frame.smoothed == jpeg.decode_coefficients(twin)[0].smoothed
    assert _held(tmp_path, monkeypatch, data, twin=twin) == "read"


def _damage_source(writer, opts):
    rng = np.random.default_rng(2)
    y, x = np.mgrid[0:48, 0:64]
    base = np.clip(128 + 90 * np.sin(x[..., None] / 5 + y[..., None] / 7 + np.arange(3))
                   + rng.normal(0, 12, (48, 64, 3)), 0, 255).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(base).save(buf, "JPEG", quality=90)
    data = _arith(writer, buf.getvalue(), *opts)
    sos = _scan_starts(data)[0]
    return data, sos + 2 + struct.unpack_from(">H", data, sos + 2)[0]


def _flip(data, start, seed):
    r = np.random.default_rng(seed)
    out = bytearray(data)
    at = int(r.integers(start, len(data) - 40))
    out[at] ^= int(r.integers(1, 256))
    return bytes(out)


@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("opts", [(), ("-r", "4"), ("-p",)], ids=["seq", "rst", "prog"])
def test_seeded_damage_reads_as_pillow_reads_it(opts, seed, writer, tmp_path, monkeypatch):
    """A byte of the entropy-coded data flipped: the port reads the garbage
    Pillow reads, or raises where it raises (or refuses a block past the
    SIMD range, item 8e)."""
    data, start = _damage_source(writer, opts)
    _held(tmp_path, monkeypatch, _flip(data, start, seed), damaged=True)


@pytest.mark.parametrize("opts,seed", [((), 10), (("-r", "4"), 45), (("-p",), 70)])
def test_a_bad_code_leaves_the_rest_of_the_interval(opts, seed, writer, tmp_path, monkeypatch):
    """A damage whose data decodes to a bad code (a magnitude or run past its
    range; jdarith.c warns and stops the interval): Pillow's pixels.  In the
    sequential file without restarts every block after the bad code keeps
    the zeros it started with."""
    data, start = _damage_source(writer, opts)
    bad = _flip(data, start, seed)
    assert _held(tmp_path, monkeypatch, bad, damaged=True) == "read"
    if not opts:
        _, coefs = jpeg.decode_coefficients(bad)
        _, clean = jpeg.decode_coefficients(data)
        cb = np.abs(coefs[1].reshape(-1, 64)).sum(1)
        last = np.nonzero(cb)[0].max()
        assert last < len(cb) - 2 and not cb[last + 1:].any()
        assert np.abs(clean[1].reshape(-1, 64)).sum(1)[last + 1:].any()


def test_a_huffman_file_under_sof9_reads_as_pillow_reads_it(tmp_path, monkeypatch):
    """A Huffman file whose SOF0 says SOF9: its data decoded as arithmetic
    coding (no Huffman table is read, so its DHT segments are parsed and
    left), garbage that Pillow reads alike."""
    for seed in range(3):
        src, _ = _source("420", 40, 56, seed=seed)
        data = bytearray(src)
        data[data.index(b"\xff\xc0") + 1] = 0xC9
        _held(tmp_path, monkeypatch, bytes(data), damaged=True)


@pytest.mark.parametrize("cut", [0.5, 0.9, 0.99])
@pytest.mark.parametrize("opts", [(), ("-p",), ("-r", "3")], ids=["seq", "prog", "rst"])
def test_truncated_files_raise(opts, cut, writer, tmp_path, monkeypatch):
    src, _ = _source("420", 64, 96, seed=4)
    data = _arith(writer, src, *opts)
    assert _held(tmp_path, monkeypatch, data[:int(len(data) * cut)]) == "raised"


def test_dac_segments_are_checked_as_libjpeg_checks_them(writer, tmp_path, monkeypatch):
    """jdmarker.c get_dac: L > U, a table index past 31 and an odd length
    raise in both packages."""
    src, _ = _source("444", 16, 24, seed=1)
    data = _arith(writer, src)
    at = data.index(b"\xff\xcc")
    assert data[at + 4:at + 8] == b"\x00\x10\x10\x05"      # DC 0: L 0, U 1; AC 0: Kx 5
    bad = {"L > U": data[:at + 5] + b"\x05" + data[at + 6:],
           "index 37": data[:at + 4] + b"\x25" + data[at + 5:],
           "odd length": data[:at] + b"\xff\xcc\x00\x05\x00\x11\x10" + data[at:]}
    for name, d in bad.items():
        assert _held(tmp_path, monkeypatch, d) == "raised", name


@pytest.mark.parametrize("code", [0xC5, 0xC6, 0xC7, 0xCB, 0xCD, 0xCE, 0xCF])
def test_frames_libjpeg_does_not_decode_raise(code, tmp_path, monkeypatch):
    """Differential frames (SOF5-7, SOF13-15) and arithmetic lossless
    (SOF11): Pillow opens the file and libjpeg-turbo raises; the port raises
    too, with cv2 importable and blocked, naming no ROADMAP item."""
    src, _ = _source("420", 16, 24, seed=0)
    data = bytearray(src)
    data[data.index(b"\xff\xc0") + 1] = code
    assert _held(tmp_path, monkeypatch, bytes(data)) == "raised"
    with pytest.raises(ValueError, match=f"SOF{code - 0xC0}.*does not decode"):
        jpeg.decode_jpeg(bytes(data))


def test_a_lossless_file_under_sof11_raises():
    """A valid lossless file (SOF3) whose frame says SOF11: libjpeg-turbo
    decodes no arithmetic-coded lossless file, and Pillow raises."""
    data = bytearray(fx.make_lossless_jpeg(fx.levels((24, 40), 5), predictor=1))
    np.testing.assert_array_equal(jpeg.decode_jpeg(bytes(data))[0], fx.levels((24, 40), 5))
    data[data.index(b"\xff\xc3") + 1] = 0xCB
    with pytest.raises(OSError, match="broken data stream"):
        Image.open(io.BytesIO(bytes(data))).load()
    with pytest.raises(ValueError, match="SOF11"):
        jpeg.decode_jpeg(bytes(data))


@pytest.mark.parametrize("jfif", [False, True])
@pytest.mark.parametrize("coding", ["huffman", "arithmetic"])
def test_three_components_under_adobe_transform_2(coding, jfif, writer, tmp_path, monkeypatch):
    """Three components under an Adobe marker whose transform is 2: libjpeg
    warns and takes them as YCbCr, with or without a JFIF marker; the port
    reads them as the JAX package does (they once went to cv2)."""
    src, _ = _source("420", 29, 41, seed=2)
    data = src if coding == "huffman" else _arith(writer, src)
    if not jfif:
        data = data[:2] + data[4 + struct.unpack_from(">H", data, 4)[0]:]
        assert b"JFIF" not in data[:30]
    adobe = b"\xff\xee\x00\x0eAdobe\x00\x64\x00\x00\x00\x00\x02"
    assert _held(tmp_path, monkeypatch, data[:2] + adobe + data[2:], twin=src) == "read"


# ---- JPEG-in-TIFF ---------------------------------------------------------------------

@pytest.mark.parametrize("photometric", [1, 2, 6])
@pytest.mark.parametrize("layout", ["strips", "tiles"])
@pytest.mark.parametrize("abbreviated", [False, True])
def test_jpeg_in_tiff(photometric, layout, abbreviated, writer, tmp_path, monkeypatch):
    """Arithmetic strips and tiles, whole streams or abbreviated ones under
    JPEGTables, at gray, RGB and YCbCr photometrics, read as libtiff reads
    them through Pillow (every pixel equal to the same TIFF's Huffman
    twin's)."""
    rgb = fx.levels((70, 90), 31 + photometric)
    px = rgb[..., 0] if photometric == 1 else rgb
    kw = dict(tile=(32, 48)) if layout == "tiles" else dict(rows=16)
    opts = ("-r", "2", "-d", "0:1:3") if abbreviated else ("-R", "1")
    data = fx.arith_tiff(writer, px, photometric, opts=opts, abbreviated=abbreviated,
                         table_codes=(0xDB,), **kw)
    twin = fx.arith_tiff(writer, px, photometric, opts=("-h",), abbreviated=abbreviated,
                         table_codes=(0xDB,), **kw)      # each stream its own optimal DHT
    assert timages._decoder(data) is imgcodecs.decode_tiff
    assert _held(tmp_path, monkeypatch, data, suffix="tif", twin=twin) == "read"


def test_the_tables_dac_does_not_reach_the_streams(writer, tmp_path, monkeypatch):
    """A DAC segment in JPEGTables: each stream's SOI sets the conditioning
    back to the defaults (libjpeg's get_soi), so streams coded with other
    conditioning decode as garbage in both packages; a bad DAC there
    raises in both."""
    g = fx.levels((64, 48), 9)[..., 1]
    opts = ("-d", "0:1:1", "-k", "0:6")
    data = fx.arith_tiff(writer, g, 1, rows=16, abbreviated=True, opts=opts,
                         table_codes=(0xDB, 0xCC))
    own = fx.arith_tiff(writer, g, 1, rows=16, abbreviated=True, opts=opts, table_codes=(0xDB,))
    assert _held(tmp_path, monkeypatch, data, suffix="tif", damaged=True) == "read"
    j = jimages.read_image(str(tmp_path / "arith.tif"), channels="I").pixels
    path = tmp_path / "ok.tif"
    path.write_bytes(own)
    assert not np.array_equal(j, jimages.read_image(str(path), channels="I").pixels)
    at = data.index(b"\xff\xcc")
    bad = data[:at + 5] + b"\x05" + data[at + 6:]            # L 5 > U 0
    assert _held(tmp_path, monkeypatch, bad, suffix="tif") == "raised"


def test_a_strip_past_pillows_window_and_a_short_one(writer, tmp_path, monkeypatch):
    """libtiff hands libjpeg a whole strip: an arithmetic strip of any size
    reads (no 65,536-byte window); a strip cut short ends in libtiff's fake
    EOI, its decoder taking zeros, as in Pillow."""
    rng = np.random.default_rng(7)
    g = rng.integers(0, 256, (360, 640), dtype=np.uint8)
    data = fx.arith_tiff(writer, g, 1, opts=("-p",))
    assert len(data) > CHUNK + CHUNK // 2
    assert _held(tmp_path, monkeypatch, data, suffix="tif",
                 twin=fx.arith_tiff(writer, g, 1, opts=("-h",))) == "read"
    for cut in (0.5, 0.97):
        seq = fx.arith_tiff(writer, g, 1, rows=120)
        streams = []
        _, t = imgcodecs._tiff_tags(seq)
        for off, n in zip(t[273], t[279]):
            streams.append(seq[off:off + n])
        streams[1] = streams[1][:int(len(streams[1]) * cut)]
        short = fx.jpeg_in_tiff(streams, 640, 360, 1, 1, rows=120)
        _held(tmp_path, monkeypatch, short, suffix="tif", damaged=True)


# ---- phase 27's goldens ------------------------------------------------------------------

def test_phase_27_goldens_are_remade(writer):
    """``arith_goldens()`` remakes each golden byte for byte, and
    ``chip_smoke.ARITH_FIXTURES`` holds its sha256 and that of Pillow's
    ``convert("RGB")`` of it; the .jpg goldens fit in Pillow's first chunk,
    and the 4K TIFF's pixels are ``codec_prog_4k.jpg``'s."""
    made = fx.arith_goldens(writer)
    assert sorted(made) == sorted(chip_smoke.ARITH_FIXTURES)
    for name, data in made.items():
        assert (fx.GOLDENS / name).read_bytes() == data, name
        assert fx.arith_digests(data) == chip_smoke.ARITH_FIXTURES[name], name
        assert not name.endswith(".jpg") or len(data) <= CHUNK
    assert chip_smoke.ARITH_FIXTURES[chip_smoke.ARITH_4K][1] == \
        chip_smoke.CODEC_FIXTURES["codec_prog_4k.jpg"][1]


@pytest.mark.parametrize("name", sorted(n for n in chip_smoke.ARITH_FIXTURES
                                        if n != chip_smoke.ARITH_4K))
def test_phase_27_goldens_read_through_the_port(name, tmp_path, monkeypatch):
    data = (fx.GOLDENS / name).read_bytes()
    decode = jpeg.decode_jpeg if name.endswith(".jpg") else imgcodecs.decode_tiff
    assert timages._decoder(data) is decode
    assert _held(tmp_path, monkeypatch, data, suffix=name[-3:]) == "read"
    assert fx.rgb_digest(decode(data)[0]) == chip_smoke.ARITH_FIXTURES[name][1]
    if name.endswith(".jpg"):
        assert jpeg.decode_coefficients(data)[0].arithmetic


def test_a_failed_writer_build_fails_with_the_compilers_message(tmp_path, monkeypatch):
    """The writer's build raises with gcc's message (the tests fail, they
    do not skip, where it cannot build)."""
    broken = tmp_path / "jpeg_arith_writer.c"
    broken.write_text("int main( {\n")
    monkeypatch.setattr(fx, "ARITH_WRITER", broken)
    with pytest.raises(RuntimeError, match=r"(?s)jpeg_arith_writer.c failed.*error"):
        fx.build_arith_writer(tmp_path)
