"""JPEG of the port: no Pillow, no cv2.

The JAX package reads and writes JPEG through Pillow, which links
libjpeg-turbo.  This codec gives the same results at Pillow's defaults:

* ``decode_jpeg(data)`` returns the samples ``Image.open(...)`` decodes
  (islow IDCT, fancy upsampling, libjpeg's YCbCr tables) for
  baseline (``SOF0``), extended-sequential (``SOF1``) and progressive
  (``SOF2``) Huffman files of 8-bit samples with one, three or four
  components: any sampling factors with integral ratios, one interleaved
  scan or a scan per component, restart intervals, the standard Huffman
  tables where a sequential scan names table 0 or 1 without defining it
  (Motion-JPEG frames; a progressive scan has no such default, as in
  libjpeg).  A progressive file's scans (spectral selection, successive
  approximation, end-of-band runs) refine the same coefficient arrays a
  sequential file fills, checked as libjpeg checks them (a bad Ss, Se,
  Ah or Al is an error, a scan out of the progression's order a warning
  only).  Arithmetic-coded files (``SOF9`` sequential, ``SOF10``
  progressive: the QM coder of T.81 Annex D with the statistics of F.1.4
  and G.1.3, as libjpeg's jdarith.c decodes them) fill the same arrays:
  16 statistics tables, the DAC segment's conditioning (DC L and U, AC
  Kx; defaults at every SOI), statistics and coder reset at each restart
  marker, a bad code leaving the rest of its restart interval as it
  stands, a marker met in the data ending its input with zeros.  Pillow
  hands libjpeg a ``.jpg`` file 65,536 bytes at a time
  (``PILLOW_CHUNK``), and libjpeg's arithmetic decoder cannot wait for the
  next chunk: a scan that needs a byte past the chunks read when it starts
  raises here as it does in Pillow ("broken data stream").  A
  progressive file whose scans leave one of a component's first
  ten coefficients short (an interrupted download) is smoothed as
  libjpeg-turbo smooths it (``jdcoefct.c`` smoothing_ok and
  decompress_smooth_data, with the latch of the last scan's Al).  Lossless
  files (``SOF3``, Huffman DPCM, predictors 1-7, a point transform) decode
  as ``jddiffct.c`` and ``jdlossls.c`` do, upsampled by replication and
  converted in no colour space (a lossless file in YCbCr or YCCK raises,
  as in Pillow).  Colour space as libjpeg picks it: one component gray;
  three YCbCr, or RGB under an Adobe marker with transform 0, with the
  component IDs 'R', 'G', 'B', or in a lossless file with IDs that name
  nothing (without a JFIF marker; three components under an Adobe
  transform other than 0 and 1 are YCbCr, as libjpeg assumes); four CMYK,
  or YCCK under an Adobe marker whose transform is not 0, which Pillow
  reads inverted (``CMYK;I``) and converts to RGB with ``cmyk2rgb``.
* ``encode_jpeg(rgb)`` returns the bytes of Pillow's ``save(...,
  "JPEG")`` at its defaults: JFIF 1.01, quality 75 (the Annex K tables at
  50 %), Y at 2x2 and Cb, Cr at 1x1, the Annex K Huffman tables, one
  interleaved scan.

``decode_coefficients(..., precision=12)`` takes, as libtiff's 12-bit
libjpeg does for a 12-bit JPEG-in-TIFF, a one-component frame of 12-bit
samples (sequential Huffman or lossless), which ``reconstruct`` turns
into uint16 samples with libjpeg-turbo's 12-bit islow IDCT (no SIMD
build exists at 12 bits); ``one_scan=True`` reads a stream as libtiff's
old-style JPEG session does (``io/ojpeg.py``).

This module parses the markers and checks the tables; the entropy coding
and the integer transforms are ``native/jpeg.cpp``, built at first use
(``_hostbuild.py``; a failed build raises with the compiler's message).
``unidentified(frame)`` names the frames Pillow's plugin does not open
(samples other than 8-bit, components other than 1, 3 or 4), which
``io/images.py`` passes on.  Frames libjpeg-turbo does not decode
(differential ``SOF5``-``SOF7`` and ``SOF13``-``SOF15``, arithmetic
lossless ``SOF11``) raise ``ValueError``, as Pillow raises.  A truncated or
corrupt file raises ``ValueError``, and so does a damaged one with a block
whose IDCT leaves the range where libjpeg-turbo's SIMD arithmetic, which
Pillow runs, agrees with the C version the port follows (ROADMAP.md queue
1, item 8e).  tests/test_torch_jpeg.py, test_torch_jpeg_lossless.py and
test_torch_jpeg_arith.py hold both directions to Pillow.
"""

from __future__ import annotations

import ctypes
import functools
import struct
from dataclasses import dataclass, field

import numpy as np

from dspfun_tpu_torch import _hostbuild

__all__ = ["PILLOW_CHUNK", "Component", "Frame", "decode_coefficients", "decode_jpeg",
           "encode_jpeg", "frame_header", "parse_tables", "reconstruct", "unidentified"]


def _zigzag() -> tuple[int, ...]:
    """Natural (row-major) index of each zigzag position."""
    order = sorted(((i + j, i if (i + j) % 2 else j, i, j) for i in range(8) for j in range(8)))
    return tuple(8 * i + j for _, _, i, j in order)


ZIGZAG = _zigzag()

# Annex K: the example quantisation tables (natural order) and Huffman tables
_LUMA_Q = (16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
           14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
           18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
           49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99)
_CHROMA_Q = (17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
             24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99) + (99,) * 32
_AC_LUMA_VALS = bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f0"
    "2433627282090a161718191a25262728292a3435363738393a43444546474849"
    "4a535455565758595a636465666768696a737475767778797a83848586878889"
    "8a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5"
    "c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa")
_AC_CHROMA_VALS = bytes.fromhex(
    "000102031104052131061241510761711322328108144291a1b1c109233352f0"
    "156272d10a162434e125f11718191a262728292a35363738393a434445464748"
    "494a535455565758595a636465666768696a737475767778797a828384858687"
    "88898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3"
    "c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8f9fa")
# (counts of codes of lengths 1..16, values) by (class, index): class 0 DC, 1 AC
STD_HUFFMAN = {
    (0, 0): (bytes([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0]), bytes(range(12))),
    (1, 0): (bytes([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D]), _AC_LUMA_VALS),
    (0, 1): (bytes([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0]), bytes(range(12))),
    (1, 1): (bytes([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77]), _AC_CHROMA_VALS),
}

_MAX_DIMENSION = 65500          # libjpeg's JPEG_MAX_DIMENSION
_CARRIED = {0xC0: "baseline", 0xC1: "extended sequential", 0xC2: "progressive",
            0xC3: "lossless", 0xC9: "arithmetic-coded sequential",
            0xCA: "arithmetic-coded progressive"}
# frames libjpeg-turbo does not decode (jdmarker.c: the hierarchical mode;
# jdmaster.c: arithmetic-coded lossless): Pillow raises "broken data stream"
_UNDECODED = {0xC5: "differential sequential", 0xC6: "differential progressive",
              0xC7: "differential lossless", 0xCB: "arithmetic-coded lossless",
              0xCD: "differential arithmetic sequential",
              0xCE: "differential arithmetic progressive",
              0xCF: "differential arithmetic lossless"}
_SOF = {**_CARRIED, **_UNDECODED}
# the bytes Pillow hands libjpeg at a time (ImageFile.MAXBLOCK), from the
# start of the file: libjpeg's arithmetic decoder cannot suspend to wait for
# the next ones
PILLOW_CHUNK = 65536
_ERRORS = {-1: "JPEG data ends inside a scan (truncated file)",
           -2: "corrupt JPEG data: no Huffman code matches",
           -3: "corrupt JPEG data: a scan's data ends before its last block",
           -4: "corrupt JPEG data: a restart marker is missing or out of order",
           -5: "bad JPEG Huffman table (not a prefix code)",
           -6: "out of memory",
           -7: "a damaged JPEG stream whose IDCT leaves the range in which libjpeg-turbo's "
               "SIMD and C arithmetic agree is not carried by the port's codec "
               "(ROADMAP.md queue 1, item 8e)",
           -8: "bad lossless JPEG restart interval: not whole rows of MCUs (libjpeg refuses it)",
           -9: "broken data stream: an arithmetic-coded scan of this JPEG runs past the "
               f"{PILLOW_CHUNK:,}-byte chunk Pillow hands libjpeg, whose arithmetic decoder "
               "cannot wait for the next chunk (Pillow raises)"}
_GRAY, _YCC, _RGB, _CMYK, _YCCK = 0, 1, 2, 3, 4


def _quality_table(base, quality: int) -> np.ndarray:
    """jcparam.c jpeg_add_quant_table at jpeg_quality_scaling(quality),
    force_baseline: values clamped to 1..255."""
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return np.array([min(max((b * scale + 50) // 100, 1), 255) for b in base], np.uint16)


_Q75 = (_quality_table(_LUMA_Q, 75), _quality_table(_CHROMA_Q, 75))


@dataclass
class Component:
    id: int
    h: int
    v: int
    tq: int
    blocks_w: int = 0           # blocks that hold the component (width_in_blocks)
    blocks_h: int = 0
    stride: int = 0             # blocks per row of its coefficient array (whole MCUs)
    rows: int = 0
    qtable: np.ndarray | None = None    # latched at its first scan


@dataclass
class Frame:
    marker: int
    precision: int
    height: int
    width: int
    components: list[Component] = field(default_factory=list)
    hmax: int = 1
    vmax: int = 1
    mcus_x: int = 0
    mcus_y: int = 0
    colorspace: int = _YCC
    smoothed: bool = False      # libjpeg smooths this progressive file's blocks
    # where smoothed: per component, the Al of the last scan at zigzag
    # positions 0-9, -1 where none came (jdcoefct.c's coef_bits_latch)
    latch: tuple | None = None

    @property
    def lossless(self) -> bool:
        return self.marker == 0xC3

    @property
    def progressive(self) -> bool:
        return self.marker in (0xC2, 0xCA)

    @property
    def arithmetic(self) -> bool:
        return self.marker in (0xC9, 0xCA)


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _markers(data: bytes, pos: int):
    """Markers from ``pos`` on, as jdmarker.c's next_marker finds them
    (bytes before a 0xFF and fill 0xFFs skipped): yields (code, index of
    the byte after the code); the caller sets where the search resumes
    by sending an index."""
    n = len(data)
    while True:
        pos = data.find(b"\xff", pos)
        if pos < 0:
            pos = n
        while pos < n and data[pos] == 0xFF:
            pos += 1
        if pos >= n:
            raise ValueError("JPEG data ends before its EOI marker (truncated file)")
        code = data[pos]
        pos += 1
        if code == 0:
            continue
        resume = yield code, pos
        if resume is not None:
            pos = resume


def _segment(data: bytes, pos: int, name: str) -> bytes:
    if pos + 2 > len(data):
        raise ValueError(f"JPEG {name} segment is truncated")
    length = struct.unpack_from(">H", data, pos)[0]
    if length < 2 or pos + length > len(data):
        raise ValueError(f"JPEG {name} segment is truncated or has a bad length")
    return data[pos + 2:pos + length]


def _sof(code: int, body: bytes) -> Frame:
    if len(body) < 6:
        raise ValueError("JPEG SOF segment is too short")
    p, h, w, nf = struct.unpack_from(">BHHB", body)
    if len(body) != 6 + 3 * nf:
        raise ValueError("JPEG SOF segment has a bad length")
    if h == 0 or w == 0 or nf == 0:
        raise ValueError("empty JPEG image (a DNL height is not supported)")
    if h > _MAX_DIMENSION or w > _MAX_DIMENSION:
        raise ValueError(f"JPEG image of {w}x{h}: the largest side is {_MAX_DIMENSION}")
    frame = Frame(code, p, h, w)
    for i in range(nf):
        cid, hv, tq = body[6 + 3 * i:9 + 3 * i]
        frame.components.append(Component(cid, hv >> 4, hv & 15, tq))
    return frame


def _layout(frame: Frame) -> None:
    """Block counts of each component (jdinput.c initial_setup; a lossless
    file's data unit is one sample, not an 8x8 block)."""
    comps = frame.components
    if any(not (1 <= c.h <= 4 and 1 <= c.v <= 4) for c in comps):
        raise ValueError("bad JPEG sampling factors")
    if any(c.tq > 3 for c in comps):
        raise ValueError("bad JPEG quantisation table index")
    frame.hmax = max(c.h for c in comps)
    frame.vmax = max(c.v for c in comps)
    if any(frame.hmax % c.h or frame.vmax % c.v for c in comps):
        raise ValueError("fractional JPEG sampling ratios are not supported (as in libjpeg)")
    unit = 1 if frame.lossless else 8
    frame.mcus_x = _ceil_div(frame.width, unit * frame.hmax)
    frame.mcus_y = _ceil_div(frame.height, unit * frame.vmax)
    for c in comps:
        c.blocks_w = _ceil_div(frame.width * c.h, unit * frame.hmax)
        c.blocks_h = _ceil_div(frame.height * c.v, unit * frame.vmax)
        c.stride, c.rows = frame.mcus_x * c.h, frame.mcus_y * c.v


def _dqt(body: bytes, tables: dict) -> None:
    p = 0
    while p < len(body):
        pq, tq = body[p] >> 4, body[p] & 15
        if tq > 3:
            raise ValueError(f"bad JPEG quantisation table index {tq}")
        size = 128 if pq else 64
        if p + 1 + size > len(body):
            raise ValueError("JPEG DQT segment is truncated")
        vals = np.frombuffer(body, ">u2" if pq else np.uint8, 64, p + 1)
        table = np.zeros(64, np.uint16)
        table[list(ZIGZAG)] = vals
        tables[tq] = table
        p += 1 + size


def _dht(body: bytes, tables: dict) -> None:
    p = 0
    while p < len(body):
        if p + 17 > len(body):
            raise ValueError("JPEG DHT segment is truncated")
        tc, th = body[p] >> 4, body[p] & 15
        if tc > 1 or th > 3:
            raise ValueError(f"bad JPEG Huffman table class or index 0x{body[p]:02x}")
        counts = body[p + 1:p + 17]
        n = sum(counts)
        if n > 256 or p + 17 + n > len(body):
            raise ValueError("bad JPEG Huffman table")
        tables[tc, th] = (counts, body[p + 17:p + 17 + n])
        p += 17 + n


def _default_conditioning() -> list[int]:
    """L, U and Kx of arithmetic tables 0-15 as an SOI sets them (jdmarker.c
    get_soi): L 0, U 1, Kx 5."""
    return [0] * 16 + [1] * 16 + [5] * 16


def _dac(body: bytes, cond: list[int]) -> None:
    """jdmarker.c get_dac: per table, a DC table's L (low nibble) and U
    (high nibble), L > U an error, or an AC table's Kx; an index past the
    16 AC tables is an error."""
    if len(body) % 2:
        raise ValueError("JPEG DAC segment has a bad length")
    for index, val in zip(body[::2], body[1::2]):
        if index >= 32:
            raise ValueError(f"bad JPEG DAC table index {index}")
        if index >= 16:
            cond[32 + index - 16] = val
        elif val & 15 > val >> 4:
            raise ValueError(f"bad JPEG DAC value 0x{val:02x} (L > U)")
        else:
            cond[index], cond[16 + index] = val & 15, val >> 4


def _table_bytes(table) -> bytes:
    counts, vals = table
    return bytes(counts) + bytes(vals).ljust(256, b"\0")


def _colorspace(frame: Frame, jfif: bool, adobe: int | None) -> int:
    """jdapimin.c default_decompress_parms for one, three or four
    components (four: CMYK without an Adobe marker or with transform 0,
    else YCCK; three with unknown IDs: RGB in a lossless file, else
    YCbCr)."""
    if len(frame.components) == 1:
        return _GRAY
    if len(frame.components) == 4:
        return _CMYK if adobe in (None, 0) else _YCCK
    if jfif:
        return _YCC
    if adobe is not None:
        return _RGB if adobe == 0 else _YCC
    ids = tuple(c.id for c in frame.components)
    return _RGB if ids == (82, 71, 66) or frame.lossless else _YCC


class _Reader:
    """Marker-level state of one decode (tables, restart interval, the
    frame, its coefficients, and a progressive file's progression)."""

    def __init__(self, data: bytes, lenient: bool = False, window: int = 0, precision: int = 8,
                 one_scan: bool = False):
        if not data.startswith(b"\xff\xd8"):
            raise ValueError("not a JPEG file (no SOI marker)")
        self.data = data
        self.lenient = lenient
        self.window = window
        self.precision = precision
        self.one_scan = one_scan
        self.frame: Frame | None = None
        self.qtables: dict = {}
        self.htables: dict = {}
        self.cond = _default_conditioning()
        self.restart = 0
        self.jfif = False
        self.adobe: int | None = None
        self.coefs: list[np.ndarray] = []
        self.scanned: set = set()
        # per component and zigzag position, the Al of its last scan (-1:
        # none yet): jdphuff.c's coef_bits
        self.coef_bits: list[list[int]] = []

    def run(self) -> None:
        """Read the markers, and every scan into the coefficient arrays."""
        data = self.data
        it = _markers(data, 2)
        resume = None
        while True:
            try:
                code, pos = it.send(resume)
            except ValueError:
                if not (self.lenient and self.coefs):
                    raise
                code = 0xD9         # libtiff's source: a fake EOI at the data's end
            resume = None
            if code == 0xD9:                              # EOI
                break
            if 0xD0 <= code <= 0xD7 or code == 0x01:      # RSTn, TEM: no segment
                continue
            if code == 0xD8:
                raise ValueError("corrupt JPEG data: a second SOI marker")
            body = _segment(data, pos, f"marker 0x{code:02x}")
            resume = pos + 2 + len(body)
            if code in _SOF:
                if self.frame is not None:
                    raise ValueError("corrupt JPEG data: a second SOF marker")
                self.frame = _sof(code, body)
                self.coef_bits = [[-1] * 64 for _ in self.frame.components]
                twelve = self.frame.precision == self.precision == 12
                why = None if twelve and len(self.frame.components) == 1 else unidentified(self.frame)
                if why:
                    raise ValueError(f"cannot identify image file ({why})")
                if code in _UNDECODED:
                    raise ValueError(f"{_UNDECODED[code]} JPEG (SOF{code - 0xC0}): libjpeg-turbo "
                                     "does not decode it (Pillow raises: broken data stream)")
                _layout(self.frame)
            elif code == 0xC4:
                _dht(body, self.htables)
            elif code == 0xCC:
                _dac(body, self.cond)
            elif code == 0xDB:
                _dqt(body, self.qtables)
            elif code == 0xDD:
                if len(body) != 2:
                    raise ValueError("JPEG DRI segment has a bad length")
                self.restart = struct.unpack(">H", body)[0]
            elif code == 0xE0:
                self.jfif |= len(body) >= 14 and body[:5] == b"JFIF\0"
            elif code == 0xEE:
                if len(body) >= 12 and body[:5] == b"Adobe":
                    self.adobe = body[11]
            elif code == 0xDA:
                if self.frame is None:
                    raise ValueError("corrupt JPEG data: a scan before the frame header")
                resume = self._scan(body, resume)
                if self.one_scan:
                    break
            elif not (0xE1 <= code <= 0xEF or code in (0xFE, 0xDC)):   # APPn, COM, DNL
                raise ValueError(f"unknown JPEG marker 0x{code:02x}")
        if self.frame is None or not self.coefs:
            raise ValueError("JPEG file holds no image")
        if len(self.scanned) != len(self.frame.components):
            raise ValueError("corrupt JPEG data: a component has no scan")
        f = self.frame
        f.smoothed = f.progressive and self._smoothing()
        if f.smoothed:
            f.latch = tuple(b for bits in self.coef_bits for b in bits[:10])

    def _progression(self, members: list, ss: int, se: int, ah: int, al: int) -> None:
        """jdphuff.c start_pass_phuff_decoder (and jdarith.c start_pass):
        a bad Ss, Se, Ah or Al is an error; a scan that does not follow the
        progression so far is a warning only (whatever libjpeg decodes, the
        port decodes)."""
        if ss == 0:
            bad = se != 0
        else:
            bad = ss > se or se > 63 or len(members) != 1
        if bad or (ah and al != ah - 1) or al > 13:
            raise ValueError(f"corrupt JPEG data: bad progression Ss={ss} Se={se} Ah={ah} "
                             f"Al={al}")
        for i in members:
            self.coef_bits[i][ss:se + 1] = [al] * (se + 1 - ss)

    def _smoothing(self) -> bool:
        """jdcoefct.c smoothing_ok after the last scan: whether
        libjpeg-turbo (block smoothing on, as Pillow leaves it) would
        smooth the output, because a component's first ten coefficients
        are not all at full precision."""
        useful = False
        for c, bits in zip(self.frame.components, self.coef_bits):
            if c.qtable is None or not all(c.qtable[ZIGZAG[k]] for k in range(10)) \
                    or bits[0] < 0:
                return False
            useful |= any(b != 0 for b in bits[1:10])
        return useful

    def _scan(self, body: bytes, pos: int) -> int:
        """One scan from ``pos``: its header checked and its data decoded;
        returns where its data ends."""
        f = self.frame
        ns = body[0] if body else 0
        if not 1 <= ns <= 4 or len(body) != 4 + 2 * ns:
            raise ValueError("JPEG SOS segment has a bad length")
        ss, se, ahl = body[1 + 2 * ns:4 + 2 * ns]
        ah, al = ahl >> 4, ahl & 15
        progressive = f.progressive
        # the Huffman tables the scan's decoder reads: a sequential scan
        # both, a progressive DC band's first pass DC, its refinements none,
        # an AC band AC (jdphuff.c start_pass_phuff_decoder); an arithmetic
        # scan none (its selectors name statistics, 0-15)
        if f.arithmetic:
            classes = ()
        elif f.lossless:
            classes = (0,)
        elif not progressive:
            classes = (0, 1)
        elif ss == 0:
            classes = () if ah else (0,)
        else:
            classes = (1,)
        by_id = {c.id: i for i, c in enumerate(f.components)}
        members, comp_args, tables = [], [], [b"\0" * 272] * 8
        for k in range(ns):
            cid, t = body[1 + 2 * k:3 + 2 * k]
            if cid not in by_id or by_id[cid] in members:
                raise ValueError(f"corrupt JPEG data: bad component {cid} in a scan")
            members.append(by_id[cid])
            for cls in classes:
                idx = (t >> 4, t & 15)[cls]
                tab = self.htables.get((cls, idx))
                if tab is None and idx <= 1 and not progressive:
                    tab = STD_HUFFMAN[cls, idx]   # jstdhuff.c: Motion-JPEG's default tables
                if tab is None:
                    raise ValueError(f"JPEG Huffman table {('DC', 'AC')[cls]} {idx} "
                                     "is not defined")
                top = 16 if f.lossless else 15                 # jdhuff.c's check
                if cls == 0 and any(v > top for v in tab[1]):
                    raise ValueError(f"bad JPEG Huffman table (a DC value above {top})")
                tables[4 * cls + idx] = _table_bytes(tab)
        comps = [f.components[i] for i in members]
        for c in comps:
            if c.qtable is None and not f.lossless:
                if c.tq not in self.qtables:
                    raise ValueError(f"JPEG quantisation table {c.tq} is not defined")
                c.qtable = self.qtables[c.tq].copy()
        if ns > 1 and sum(c.h * c.v for c in comps) > 10:
            raise ValueError("JPEG sampling factors too large for an interleaved scan")
        if progressive:
            self._progression(members, ss, se, ah, al)
        if f.lossless and not (1 <= ss <= 7 and se == 0 and ah == 0 and al < f.precision):
            raise ValueError(f"corrupt JPEG data: bad lossless scan Ss={ss} Se={se} Ah={ah} "
                             f"Al={al}")
        self.scanned.update(members)
        if f.lossless:
            return self._lossless_scan(members, body, pos, b"".join(tables[:4]), ss, al)
        if not self.coefs:
            self.coefs = [np.zeros((c.rows, c.stride, 64), np.int16) for c in f.components]
        if ns == 1:
            c = comps[0]
            mcus_x, mcus_y = c.blocks_w, c.blocks_h
            hv = [(1, 1)]
        else:
            mcus_x, mcus_y = f.mcus_x, f.mcus_y
            hv = [(c.h, c.v) for c in comps]
        for k, (c, t) in enumerate(zip(comps, body[2:2 + 2 * ns:2])):
            comp_args += [hv[k][0], hv[k][1], c.stride, t >> 4, t & 15]
        lib = _load()
        args = np.array(comp_args, np.int32).ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
        ptrs = (ctypes.POINTER(ctypes.c_int16) * ns)(
            *[self.coefs[i].ctypes.data_as(ctypes.POINTER(ctypes.c_int16)) for i in members])
        end = ctypes.c_int64(0)
        head = (self.data, len(self.data), pos, ns, args, mcus_x, mcus_y)
        if f.arithmetic:
            # the chunks read when the scan starts: every one up to its header's end
            limit = -(-pos // self.window) * self.window if self.window else len(self.data)
            rc = lib.jpg_decode_arith(*head, bytes(self.cond), self.restart, int(progressive),
                                      ss, se, ah, al, limit, int(self.lenient), ptrs,
                                      ctypes.byref(end))
        elif progressive:
            rc = lib.jpg_decode_progressive(*head, b"".join(tables), self.restart, ss, se, ah,
                                            al, ptrs, ctypes.byref(end))
        else:
            rc = lib.jpg_decode_scan(*head, b"".join(tables), self.restart,
                                     int(self.lenient and (self.one_scan or not self.restart)),
                                     ptrs, ctypes.byref(end))
        if rc:
            raise ValueError(_ERRORS.get(rc, f"JPEG decode failed ({rc})"))
        return end.value

    def _lossless_scan(self, members: list, body: bytes, pos: int, tables: bytes,
                       predictor: int, pt: int) -> int:
        """One scan of a lossless file: its components' samples, uint8
        [blocks_h, blocks_w] each (the undifferenced values << pt, cut to 8
        bits as jdlossls.c's scaler casts them; uint16 for 12-bit samples,
        cut to 16 bits as its 12-bit build's short samples are)."""
        f = self.frame
        wide = f.precision > 8
        if not self.coefs:
            self.coefs = [np.zeros((c.blocks_h, c.blocks_w), np.uint16 if wide else np.uint8)
                          for c in f.components]
        comps = [f.components[i] for i in members]
        args = np.array([[c.h, c.v, c.blocks_w, c.blocks_h, t >> 4]
                         for c, t in zip(comps, body[2:2 + 2 * len(members):2])], np.int32)
        raw = [np.zeros((c.blocks_h, c.blocks_w), np.uint16) for c in comps]
        ptrs = (ctypes.POINTER(ctypes.c_uint16) * len(raw))(
            *[r.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)) for r in raw])
        end = ctypes.c_int64(0)
        rc = _load().jpg_decode_lossless(
            self.data, len(self.data), pos, len(members),
            args.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), f.mcus_x, f.mcus_y, tables,
            self.restart, predictor, pt, f.precision, ptrs, ctypes.byref(end))
        if rc:
            raise ValueError(_ERRORS.get(rc, f"JPEG decode failed ({rc})"))
        for i, r in zip(members, raw):
            self.coefs[i] = (r.astype(np.uint32) << pt).astype(np.uint16 if wide else np.uint8)
        return end.value


def unidentified(frame: Frame) -> str | None:
    """Why Pillow's JPEG plugin does not open a file of this frame header
    (its SOF handler raises, so ``Image.open`` passes the file on): a
    sample precision other than 8, or components other than 1, 3 or 4;
    None where it opens it."""
    if frame.precision != 8:
        return f"Pillow's JPEG plugin cannot handle {frame.precision}-bit layers"
    if len(frame.components) not in (1, 3, 4):
        return f"Pillow's JPEG plugin cannot handle {len(frame.components)}-layer images"
    return None


def frame_header(data: bytes) -> Frame | None:
    """The frame header of a JPEG as Pillow's plugin reads it (the first
    SOF before the first scan), or None where there is none or the
    markers before it cannot be parsed."""
    if not data.startswith(b"\xff\xd8"):
        return None
    it = _markers(data, 2)
    resume = None
    try:
        while True:
            code, pos = it.send(resume)
            if code in (0xD9, 0xDA):
                return None
            resume = None
            if 0xD0 <= code <= 0xD7 or code in (0x01, 0xD8):
                continue
            body = _segment(data, pos, f"marker 0x{code:02x}")
            resume = pos + 2 + len(body)
            if code in _SOF:
                return _sof(code, body)
    except (ValueError, struct.error):
        return None


def parse_tables(data: bytes) -> tuple[dict, dict]:
    """The quantisation and Huffman tables of a tables-only datastream
    (SOI, DQT and DHT segments, EOI: what a TIFF's JPEGTables tag holds),
    as ``decode_coefficients`` takes them.  A DAC segment is checked, but
    its values do not reach a stream: the stream's own SOI sets every
    table's conditioning back to the defaults (jdmarker.c get_soi), as it
    does the restart interval."""
    if not data.startswith(b"\xff\xd8"):
        raise ValueError("JPEG tables: no SOI marker")
    qtables, htables = {}, {}
    it = _markers(data, 2)
    resume = None
    while True:
        code, pos = it.send(resume)
        if code == 0xD9:
            return qtables, htables
        body = _segment(data, pos, f"marker 0x{code:02x}")
        resume = pos + 2 + len(body)
        if code == 0xDB:
            _dqt(body, qtables)
        elif code == 0xC4:
            _dht(body, htables)
        elif code == 0xCC:
            _dac(body, _default_conditioning())
        elif not (0xE0 <= code <= 0xEF or code in (0xFE, 0xDD)):
            raise ValueError(f"JPEG tables: unexpected marker 0x{code:02x}")


def decode_coefficients(data: bytes, tables: tuple[dict, dict] | None = None,
                        lenient: bool = False, window: int = 0, precision: int = 8,
                        one_scan: bool = False) -> tuple[Frame, list[np.ndarray]]:
    """The frame and each component's quantised DCT coefficients, int16
    [rows, stride, 64] in natural order (whole MCUs; blocks past the
    component's ``blocks_w`` x ``blocks_h`` are an interleaved scan's
    dummy blocks), after the last scan (``frame.smoothed``: libjpeg
    smooths the blocks of this progressive file, with ``frame.latch``);
    for a lossless frame, each component's samples, uint8 [blocks_h,
    blocks_w] (its own size).  ``tables``
    (:func:`parse_tables`) are in force before the stream's own, which
    override them (an abbreviated stream, as a TIFF's strips and tiles
    hold it).  ``lenient`` decodes a sequential stream as libjpeg does
    when its source is all in memory (libtiff's): the data's end is an
    EOI, a scan that runs out of data finishes its MCU on zero bits and
    leaves the rest of its blocks zero (uniform gray), and a bit pattern
    no Huffman code matches takes 17 bits and decodes as 0; an
    arithmetic-coded scan that runs out of data takes zeros.  ``window``
    (0: none): the bytes libjpeg is handed at a time, from the file's
    start, as Pillow hands them (``PILLOW_CHUNK``): an arithmetic-coded
    scan that needs a byte past the chunks read when it starts (to its
    header's end) raises, as libjpeg does.  ``precision`` 12 also takes a
    one-component frame of 12-bit samples (as libjpeg-turbo's 12-bit
    build, which libtiff runs for a 12-bit JPEG-in-TIFF); its lossless
    samples are uint16.  ``one_scan`` reads the stream as libtiff's
    old-style JPEG session does: no marker after the first scan's data
    (libjpeg is never asked for one), and a lenient scan's restart markers
    honoured (the MCUs after a run out of data zero up to the next one)."""
    r = _Reader(bytes(data), lenient, window, precision, one_scan)
    if tables is not None:
        r.qtables, r.htables = dict(tables[0]), dict(tables[1])
    r.run()
    r.frame.colorspace = _colorspace(r.frame, r.jfif, r.adobe)
    return r.frame, r.coefs


def reconstruct(frame: Frame, coefs: list[np.ndarray], latch: tuple | None = None,
                as_stored: bool = False) -> np.ndarray:
    """Samples uint8 [H, W, C] of the coefficients (libjpeg's islow IDCT,
    fancy upsampling and colour conversion): C = 1 gray, 3 RGB; four
    components give the RGB of Pillow's ``convert("RGBA")`` of its CMYK
    image.  ``latch`` (a smoothed frame's ``frame.latch``): each block is
    first smoothed as libjpeg-turbo smooths a progressive file left short
    (``jdcoefct.c`` decompress_smooth_data); None: not smoothed.
    ``as_stored``: every component upsampled and none converted (libjpeg's
    ``JCS_UNKNOWN``, as libtiff reads the strips of a TIFF that is not
    YCbCr), C = the number of components.  A lossless frame's samples
    (``coefs``: uint8 [blocks_h, blocks_w] per component) are upsampled by
    replication, as libjpeg does for a DCT size of 1, and not converted:
    libjpeg refuses a lossless file in YCbCr or YCCK, and so does this.
    Raises where a block's IDCT meets a value (a product or sum past 16
    bits, an output past the range table's wrap) that libjpeg-turbo's SIMD
    IDCT, which Pillow runs, holds otherwise than its C version, which the
    port follows: only damaged streams have such blocks, and Pillow's
    pixels of them are not the port's."""
    comps = frame.components
    n = len(comps)
    if frame.precision == 12:
        return _reconstruct12(frame, coefs)
    colorspace = _RGB if as_stored else frame.colorspace
    out = np.empty((frame.height, frame.width, 3 if n == 4 and not as_stored else n), np.uint8)
    u8 = ctypes.POINTER(ctypes.c_uint8)
    if frame.lossless:
        if colorspace in (_YCC, _YCCK):
            raise ValueError("lossless JPEG in YCbCr or YCCK (a JFIF or Adobe marker): libjpeg "
                             "converts no colours in lossless mode, and Pillow raises")
        args = np.array([[c.h, c.v] for c in comps], np.int32)
        planes = [np.ascontiguousarray(k) for k in coefs]
        _load().jpg_lossless_pixels(n, args.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                                    frame.width, frame.height,
                                    (u8 * n)(*[k.ctypes.data_as(u8) for k in planes]),
                                    colorspace, out.ctypes.data_as(u8))
        return out
    args = np.array([[c.h, c.v, c.stride, c.rows] for c in comps], np.int32)
    qt = np.ascontiguousarray(np.stack([c.qtable for c in comps]), np.uint16)
    ptrs = (ctypes.POINTER(ctypes.c_int16) * n)(
        *[k.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)) for k in coefs])
    bits = None if latch is None else np.array(latch, np.int32)
    rc = _load().jpg_reconstruct(n, args.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                                 frame.width, frame.height, ptrs,
                                 qt.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
                                 colorspace,
                                 None if bits is None else
                                 bits.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                                 out.ctypes.data_as(u8))
    if rc:
        raise ValueError(_ERRORS.get(rc, f"JPEG decode failed ({rc})"))
    return out


def _reconstruct12(frame: Frame, coefs: list[np.ndarray]) -> np.ndarray:
    """The samples of a one-component frame of 12-bit samples, uint16
    [H, W, 1] in 0..4095 (a lossless one's as decoded, cut to 16 bits):
    libjpeg-turbo's 12-bit islow IDCT and range limit."""
    c = frame.components[0]
    if frame.lossless:
        return np.ascontiguousarray(coefs[0][:frame.height, :frame.width, None])
    out = np.empty((frame.height, frame.width, 1), np.uint16)
    qt = np.ascontiguousarray(c.qtable, np.uint16)
    k = np.ascontiguousarray(coefs[0])
    rc = _load().jpg_reconstruct12(c.stride, c.rows, frame.width, frame.height,
                                   k.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
                                   qt.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
                                   out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)))
    if rc:
        raise ValueError(_ERRORS.get(rc, f"JPEG decode failed ({rc})"))
    return out


def decode_jpeg(data: bytes) -> tuple[np.ndarray, int]:
    """Samples uint8 [H, W, C] (C = 1 gray, 3 RGB) and the depth 8, as
    Pillow decodes the file (a CMYK or YCCK file as its RGB conversion; a
    progressive file left short smoothed as libjpeg-turbo smooths it; an
    arithmetic-coded scan past Pillow's chunks raising, as in Pillow)."""
    frame, coefs = decode_coefficients(data, window=PILLOW_CHUNK)
    return reconstruct(frame, coefs, frame.latch), 8


def _marker(code: int, body: bytes) -> bytes:
    return bytes([0xFF, code]) + struct.pack(">H", len(body) + 2) + body


@functools.lru_cache(maxsize=1)
def _tables_head() -> bytes:
    """SOI, JFIF APP0 and the two DQT segments of every encoded file."""
    jfif = b"JFIF\0" + bytes([1, 1, 0]) + struct.pack(">HH", 1, 1) + b"\0\0"
    dqt = b"".join(_marker(0xDB, bytes([t]) + bytes(q[list(ZIGZAG)].astype(np.uint8)))
                   for t, q in enumerate(_Q75))
    return b"\xff\xd8" + _marker(0xE0, jfif) + dqt


@functools.lru_cache(maxsize=1)
def _scan_head() -> bytes:
    """The four DHT segments (DC0, AC0, DC1, AC1) and the SOS."""
    dht = b"".join(_marker(0xC4, bytes([16 * cls + idx]) + bytes(STD_HUFFMAN[cls, idx][0])
                           + bytes(STD_HUFFMAN[cls, idx][1]))
                   for idx in (0, 1) for cls in (0, 1))
    return dht + _marker(0xDA, bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0]))


def encode_jpeg(rgb: np.ndarray) -> bytes:
    """An RGB image, uint8 [H, W, 3], as Pillow's ``save(..., "JPEG")``
    writes it at its defaults."""
    a = np.ascontiguousarray(rgb)
    if a.dtype != np.uint8 or a.ndim != 3 or a.shape[2] != 3:
        raise ValueError(f"JPEG encodes uint8 RGB [H, W, 3], not {a.dtype} {a.shape}")
    h, w = a.shape[:2]
    if not (0 < h <= _MAX_DIMENSION and 0 < w <= _MAX_DIMENSION):
        raise ValueError(f"JPEG image of {w}x{h}: sides must be 1..{_MAX_DIMENSION}")
    sof = _marker(0xC0, struct.pack(">BHHB", 8, h, w, 3)
                  + bytes([1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1]))
    qt = np.ascontiguousarray(np.stack(_Q75), np.uint16)
    ht = b"".join(_table_bytes(STD_HUFFMAN[cls, idx]) for idx in (0, 1) for cls in (0, 1))
    out = ctypes.POINTER(ctypes.c_uint8)()
    n = ctypes.c_int64(0)
    lib = _load()
    rc = lib.jpg_encode_rgb(a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), h, w,
                            qt.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)), ht,
                            ctypes.byref(out), ctypes.byref(n))
    if rc:
        raise ValueError(_ERRORS.get(rc, f"JPEG encode failed ({rc})"))
    try:
        body = ctypes.string_at(out, n.value)
    finally:
        lib.jpg_free(out)
    return _tables_head() + sof + _scan_head() + body + b"\xff\xd9"


@functools.lru_cache(maxsize=None)
def _load() -> ctypes.CDLL:
    """The loaded libjpeg with its signatures declared (built on first
    use; raises when it cannot be built)."""
    lib = _hostbuild.load_library("jpeg")
    c = ctypes
    i16pp = c.POINTER(c.POINTER(c.c_int16))
    lib.jpg_decode_scan.restype = c.c_int
    head = [c.c_char_p, c.c_int64, c.c_int64, c.c_int, c.POINTER(c.c_int32), c.c_int, c.c_int,
            c.c_char_p, c.c_int]
    lib.jpg_decode_scan.argtypes = head + [c.c_int, i16pp, c.POINTER(c.c_int64)]
    lib.jpg_decode_progressive.restype = c.c_int
    lib.jpg_decode_progressive.argtypes = head + [c.c_int] * 4 + [i16pp, c.POINTER(c.c_int64)]
    lib.jpg_reconstruct.restype = c.c_int
    lib.jpg_reconstruct.argtypes = [c.c_int, c.POINTER(c.c_int32), c.c_int, c.c_int, i16pp,
                                    c.POINTER(c.c_uint16), c.c_int, c.POINTER(c.c_int32),
                                    c.POINTER(c.c_uint8)]
    lib.jpg_decode_arith.restype = c.c_int
    lib.jpg_decode_arith.argtypes = head[:7] + [c.c_char_p] + [c.c_int] * 6 + [
        c.c_int64, c.c_int, i16pp, c.POINTER(c.c_int64)]
    lib.jpg_decode_lossless.restype = c.c_int
    lib.jpg_decode_lossless.argtypes = head + [c.c_int, c.c_int, c.c_int,
                                               c.POINTER(c.POINTER(c.c_uint16)),
                                               c.POINTER(c.c_int64)]
    lib.jpg_reconstruct12.restype = c.c_int
    lib.jpg_reconstruct12.argtypes = [c.c_int] * 4 + [c.POINTER(c.c_int16), c.POINTER(c.c_uint16),
                                                      c.POINTER(c.c_uint16)]
    lib.jpg_lossless_pixels.restype = None
    lib.jpg_lossless_pixels.argtypes = [c.c_int, c.POINTER(c.c_int32), c.c_int, c.c_int,
                                        c.POINTER(c.POINTER(c.c_uint8)), c.c_int,
                                        c.POINTER(c.c_uint8)]
    lib.jpg_encode_rgb.restype = c.c_int
    lib.jpg_encode_rgb.argtypes = [c.POINTER(c.c_uint8), c.c_int, c.c_int,
                                   c.POINTER(c.c_uint16), c.c_char_p,
                                   c.POINTER(c.POINTER(c.c_uint8)), c.POINTER(c.c_int64)]
    lib.jpg_free.restype = None
    lib.jpg_free.argtypes = [c.POINTER(c.c_uint8)]
    return lib
