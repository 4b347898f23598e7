"""The codec fixtures of ``tests/goldens/`` that ``chip_smoke.py`` phase 17
decodes on the card, whose machine has no Pillow: Pillow's progressive
JPEG and compressed TIFF files of ``chip_smoke._seeded_pixels`` images.

* ``codec_prog_4k.jpg``: 3840x2160 RGB, ``noise=0.02``, seed 17, quality
  75, Pillow's default progressive script (libjpeg's simple
  progression) at 4:2:0;
* ``codec_prog_gray.jpg``: 517x333 gray, seed 18;
* ``codec_prog_444_rst.jpg``: 517x333 RGB at 4:4:4, a restart marker
  every 4 MCUs, seed 18;
* ``codec_lzw_p1.tif`` and ``codec_lzw_p2.tif``: 160x120 RGB, LZW,
  predictor 1 and 2, seed 19;
* ``codec_packbits.tif``: the same pixels in PackBits;
* ``codec_rgba_assoc.tif``: the same colour premultiplied by a seeded
  alpha in LZW, ExtraSamples set to 1 (associated alpha, as GIMP writes
  it).

``chip_smoke.CODEC_FIXTURES`` holds the sha256 of each file and of
Pillow's decode of it (``np.asarray(Image.open(...))``);
tests/test_torch_jpeg.py remakes the files and checks both.

The GIF fixtures of ``chip_smoke.py`` phase 18 (``gif_fixtures()``;
``chip_smoke.GIF_FIXTURES`` holds the sha256 of each file and of
Pillow's ``convert("RGBA")`` of it, checked by tests/test_torch_gif.py):

* ``gif_rgb_interlaced.gif``: Pillow's GIF of 96x128 RGB levels, seed
  21 (median cut, interlaced);
* ``gif_rgba_trns.gif``: Pillow's GIF of the same levels with a seeded
  alpha of 0 and 255 (octree, a transparency index, GIF89a);
* ``gif_gray.gif``: Pillow's GIF of their ``L`` conversion;
* ``gif_local_offset.gif``, ``gif_code2.gif``, ``gif_deferred_clear.gif``:
  written by :func:`make_gif`: a 40x24 frame at (7, 5) of a 64x40 screen
  with a local palette and a transparency index; a 4-colour palette at
  minimum code size 2; 128x96 indices of 256 colours whose code table
  fills and is kept, without a clear code, to the end (as gifsicle
  writes).

The CMYK JPEG fixtures of ``chip_smoke.py`` phase 19
(``cmyk_fixtures()``; ``chip_smoke.CMYK_FIXTURES`` holds the sha256 of
each file and of Pillow's ``convert("RGB")`` of it, checked by
tests/test_torch_jpeg.py): ``cmyk_prog_4k.jpg`` (the 4K levels above made
CMYK by :func:`cmyk_levels`, progressive), ``cmyk_rst.jpg`` (320x200,
seed 24, restart markers every 5 MCUs), ``cmyk_ycck.jpg`` (that file with
its Adobe transform set to 2) and ``cmyk_no_adobe.jpg`` (without its Adobe
marker).

The WebP fixtures of ``chip_smoke.py`` phase 21 (``webp_fixtures()``;
``chip_smoke.WEBP_FIXTURES`` holds the sha256 of each file and of the JAX
package's ``read_image(..., "RGBA")`` float64 pixels of it, checked by
tests/test_torch_webp.py): Pillow's lossy WebP of 96x128 levels (seed 27)
at its default quality 80, of 333x517 levels (seed 18) at quality 100 and
method 6, their RGBA with a seeded alpha (``alpha_quality`` 50), their
lossless RGB (the 333x517 levels at ``noise=0.02``) and RGBA
(``exact``), a 16-colour lossless palette (pixel
bundling), a two-frame animation, a ``VP8X`` file written by hand around
Pillow's ``VP8 `` chunk with a raw gradient-filtered ``ALPH`` chunk and
``ICCP``, ``EXIF``, ``XMP `` and unknown chunks (:func:`make_webp`),
``codec_webp_4k.webp`` (Pillow's quality 80 of ``codec_prog_4k.jpg``'s
levels) and ``webp_motion0000.webp`` to ``webp_motion0007.webp`` (quality
80 of 1080p windows of seeded levels, seed 28, ``noise=0.02``, for
phase 21c's motion sequence).

The PSD, DDS, CUR, DCX and IM fixtures of ``chip_smoke.py`` phase 25
(``psd_dds_fixtures()``; ``chip_smoke.PSD_DDS_FIXTURES`` holds the sha256
of each file and of the JAX package's ``read_image(..., "RGBA")`` pixels
of it, checked by tests/test_torch_dds.py): Pillow's DDS files (each
uncompressed mode and ``pixel_format``) and DCX files of its PCX pages
(``psd_dds_goldens()``, kept in tests/goldens/), and files written here
without Pillow: PSDs (:func:`make_psd`), cursors (:func:`make_cur`), DDS
headers around bit masks, palettes and seeded random blocks
(:func:`dds_file`, :func:`bc_blocks`) and IM's float and YCbCr modes
(:func:`make_im`); :func:`psd_4k` and :func:`bc7_4k` write phase 25's 4K
PSD and BC7 DDS.

The JPEG 2000 fixtures of ``chip_smoke.py`` phase 29
(``j2k_more_goldens()``, kept in tests/goldens/; ``chip_smoke.J2K_MORE_FIXTURES``
holds the sha256 of each file and of the JAX package's ``read_image(...,
"RGBA")`` pixels of it, or of Pillow's RGB decode for the two 4K files,
checked by tests/test_torch_jpeg2000_more.py): files coded by Pillow's own
OpenJPEG 2.5 (``pillow.libs/libopenjp2-*.so*``) through ctypes
(:func:`j2k_write`, which checks the COD, RGN and POC bytes it writes;
:func:`j2k_stitch` joins single-component codestreams under COC and QCC),
and Pillow's ``cinema4k-24`` file.  Remaking them needs that library.

The TIFF writer :func:`make_tiff` (its own LZW and PackBits encoders and
zlib; strips or tiles, chunky or planar, predictors 2 and 3, either fill
order, the sample formats of ``MODES``) needs no Pillow: the tests and
``chip_smoke.py`` phases 17 and 19 (which load this file by its path on
the card's machine) write their TIFFs with it, phase 19's small ones
through :func:`layout_tiffs`.

To remake them after a change of the images (and then update those
digests), run from the root of a checkout::

    python -m tests.torch_codec_fixtures

and, to time the port's TIFF decoders against Pillow's on this host at
3840x2160, ``python -m tests.torch_codec_fixtures --rates``.
"""

from __future__ import annotations

import bisect
import functools
import hashlib
import io
import re
import struct
import sys
import zlib
from pathlib import Path

import numpy as np

GOLDENS = Path(__file__).resolve().parent / "goldens"


def levels(hw, seed, noise=0.1) -> np.ndarray:
    """The 8-bit RGB levels ``write_image`` makes of the seeded pixels."""
    import chip_smoke  # noqa: PLC0415

    pix = chip_smoke._seeded_pixels(hw, seed, noise)
    return np.clip(np.rint(np.clip(pix, 0.0, 1.0) * 255), 0, 255).astype(np.uint8)


def _save(img, fmt, **kw) -> bytes:
    buf = io.BytesIO()
    img.save(buf, format=fmt, **kw)
    return buf.getvalue()


def _associated(data: bytes) -> bytes:
    """A little-endian TIFF with its ExtraSamples value set to 1."""
    out = bytearray(data)
    ifd = struct.unpack_from("<I", out, 4)[0]
    for k in range(struct.unpack_from("<H", out, ifd)[0]):
        at = ifd + 2 + 12 * k
        if struct.unpack_from("<H", out, at)[0] == 338:
            struct.pack_into("<H", out, at + 8, 1)
            return bytes(out)
    raise ValueError("no ExtraSamples tag")


# ---- a TIFF writer with its own LZW and PackBits encoders (no Pillow) --------


def lzw_encode(data: bytes, lsb: bool = False) -> bytes:
    """TIFF's LZW as libtiff's tif_lzw.c writes it: MSB-first codes, a
    ClearCode first, the width one code early, a ClearCode when the
    table reaches 4094, EOI last.  With ``lsb``, libtiff's old LSB-first
    form (which its LZWDecodeCompat reads): each code from the low bits
    up, the width one code later."""
    codes, nbits = [], 9
    table = {bytes([i]): i for i in range(256)}
    free = 258
    late = 1 if lsb else 0

    def put(code):
        codes.append((code, nbits))

    def grow():
        nonlocal free, nbits, table
        free += 1
        if free == 4094:
            put(256)
            table = {bytes([i]): i for i in range(256)}
            free, nbits = 258, 9
        elif free > (1 << nbits) - 1 + late and nbits < 12:
            nbits += 1

    put(256)
    w = b""
    for b in data:
        wb = w + bytes([b])
        if wb in table:
            w = wb
            continue
        put(table[w])
        table[wb] = free
        grow()
        w = bytes([b])
    if w:
        put(table[w])
        grow()
    put(257)
    if lsb:
        acc = sum(code << at for (code, _), at in zip(
            codes, np.cumsum([0] + [n for _, n in codes[:-1]]).tolist()))
        total = sum(n for _, n in codes)
        return acc.to_bytes((total + 7) // 8, "little")
    s = "".join(format(code, f"0{n}b") for code, n in codes)
    s += "0" * (-len(s) % 8)
    return bytes(int(s[i:i + 8], 2) for i in range(0, len(s), 8))


def zstd_compress(data: bytes, level: int = 3) -> bytes:
    """A Zstandard frame of ``data`` by the zstandard package (libzstd),
    content size in its header (as imagecodecs and tifffile write it)."""
    import zstandard  # noqa: PLC0415

    return zstandard.ZstdCompressor(level=level).compress(data)


def zstd_stored(data: bytes) -> bytes:
    """A Zstandard frame of raw blocks (at most 128 KiB each, the content
    size in its header), written without libzstd."""
    blocks = [data[k:k + 131072] for k in range(0, len(data), 131072)] or [b""]
    out = bytearray(struct.pack("<IBI", 0xFD2FB528, 0xA0, len(data)))
    for k, blk in enumerate(blocks):
        out += ((len(blk) << 3) | (k == len(blocks) - 1)).to_bytes(3, "little") + blk
    return bytes(out)


def xz_compress(data: bytes, preset: int = 6) -> bytes:
    """An xz stream of ``data`` with no integrity check, as libtiff's
    tif_lzma.c writes a strip (its default preset is 6)."""
    import lzma  # noqa: PLC0415

    return lzma.compress(data, format=lzma.FORMAT_XZ, check=lzma.CHECK_NONE, preset=preset)


def packbits_encode(data: bytes) -> bytes:
    """PackBits: repeats of 2 to 128 bytes, literals of up to 128, and a
    no-op header (-128) in front."""
    out, i, n = bytearray([0x80]), 0, len(data)
    while i < n:
        j = i + 1
        while j < n and j - i < 128 and data[j] == data[i]:
            j += 1
        if j - i >= 2:
            out += bytes([257 - (j - i), data[i]])
            i = j
            continue
        k = i + 1
        while k < n and k - i < 128 and not (k + 1 < n and data[k] == data[k + 1]):
            k += 1
        out += bytes([k - i - 1]) + data[i:k]
        i = k
    return bytes(out)


# (photometric, bits, samples per pixel, ExtraSamples, SampleFormat) of
# each mode make_tiff writes, by a name close to Pillow's rawmode
MODES = {
    "1": (1, 1, 1, (), 1), "1 inverted": (0, 1, 1, (), 1),
    "L;2": (1, 2, 1, (), 1), "L;2 inverted": (0, 2, 1, (), 1),
    "L;4": (1, 4, 1, (), 1), "L;4 inverted": (0, 4, 1, (), 1),
    "L": (1, 8, 1, (), 1), "L inverted": (0, 8, 1, (), 1), "L signed": (1, 8, 1, (), 2),
    "I;12": (1, 12, 1, (), 1), "I;16": (1, 16, 1, (), 1), "I;16 photometric 0": (0, 16, 1, (), 1),
    "I;16S": (1, 16, 1, (), 2), "I;32N": (1, 32, 1, (), 1), "I;32S": (1, 32, 1, (), 2),
    "F": (1, 32, 1, (), 3), "F photometric 0": (0, 32, 1, (), 3),
    "LA": (1, 8, 2, (2,), 1),
    "P;1": (3, 1, 1, (), 1), "P;2": (3, 2, 1, (), 1), "P;4": (3, 4, 1, (), 1),
    "P": (3, 8, 1, (), 1), "PX": (3, 8, 2, (0,), 1), "PA": (3, 8, 2, (2,), 1),
    "RGB": (2, 8, 3, (), 1), "RGBA no ExtraSamples": (2, 8, 4, (), 1),
    "RGBA": (2, 8, 4, (2,), 1), "RGBa": (2, 8, 4, (1,), 1), "RGBX": (2, 8, 4, (0,), 1),
    "RGBXX": (2, 8, 5, (0, 0), 1), "RGBXXX": (2, 8, 6, (0, 0, 0), 1),
    "RGBaX": (2, 8, 5, (1, 0), 1), "RGBaXX": (2, 8, 6, (1, 0, 0), 1),
    "RGBAX": (2, 8, 5, (2, 0), 1), "RGBAXX": (2, 8, 6, (2, 0, 0), 1),
    "RGBA 999": (2, 8, 4, (999,), 1),
    "RGB;16": (2, 16, 3, (), 1), "RGBA;16": (2, 16, 4, (2,), 1), "RGBa;16": (2, 16, 4, (1,), 1),
    "RGBX;16": (2, 16, 4, (0,), 1), "RGBA;16 no ExtraSamples": (2, 16, 4, (), 1),
    "CMYK": (5, 8, 4, (), 1), "CMYKX": (5, 8, 5, (0,), 1), "CMYKXX": (5, 8, 6, (0, 0), 1),
    "CMYK;16": (5, 16, 4, (), 1),
    "YCbCr": (6, 8, 3, (), 1), "LAB": (8, 8, 3, (), 1),
}
COMPRESS = {1: lambda b: b, 5: lzw_encode, 8: lambda b: zlib.compress(b, 1),
            32946: lambda b: zlib.compress(b, 1), 32773: packbits_encode,
            34925: xz_compress, 50000: zstd_compress}
_PREDICTED = (5, 8, 32946, 34925, 50000)
_BITREV = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)], np.uint8)


def _row_bytes(block: np.ndarray, bits: int, bo: str, predictor: int) -> list[bytes]:
    """Each row of a block [bh, bw, c] of samples as stored: packed MSB
    first below 8 bits and at 12, in byte order ``bo`` at 16 and 32 bits,
    after the horizontal (2) or floating-point (3) predictor's
    differencing, whose stride is c."""
    bh, bw, c = block.shape
    if bits % 8:
        v = block.astype(np.uint32).reshape(bh, bw * c)
        planes = (v[..., None] >> np.arange(bits - 1, -1, -1)) & 1
        return [r.tobytes() for r in np.packbits(planes.reshape(bh, -1).astype(np.uint8), axis=1)]
    u = np.ascontiguousarray(block).view(f"u{bits // 8}").reshape(bh, bw * c)
    if predictor == 2:       # differences modulo 2^bits, in the unsigned type
        u = u.copy()
        u[:, c:] = block.reshape(bh, bw * c).view(u.dtype)[:, c:] - u[:, :-c]
    if predictor == 3:       # libtiff's fpDiff: byte planes, most significant first
        be = u.astype(f">u{bits // 8}").view(np.uint8).reshape(bh, bw * c, bits // 8)
        p = np.ascontiguousarray(be.transpose(0, 2, 1)).reshape(bh, -1)
        p[:, c:] = p[:, c:] - p[:, :-c].copy()
        return [r.tobytes() for r in p]
    return [r.tobytes() for r in u.astype(f"{bo}u{bits // 8}")]


# ---- CCITT T.4 / T.6 (fax) coding, bits as strings, for make_tiff ------------

_WHITE_TERM = (
    "00110101 000111 0111 1000 1011 1100 1110 1111 10011 10100 00111 01000 001000 000011 110100 "
    "110101 101010 101011 0100111 0001100 0001000 0010111 0000011 0000100 0101000 0101011 "
    "0010011 0100100 0011000 00000010 00000011 00011010 00011011 00010010 00010011 00010100 "
    "00010101 00010110 00010111 00101000 00101001 00101010 00101011 00101100 00101101 00000100 "
    "00000101 00001010 00001011 01010010 01010011 01010100 01010101 00100100 00100101 01011000 "
    "01011001 01011010 01011011 01001010 01001011 00110010 00110011 00110100").split()
_BLACK_TERM = (
    "0000110111 010 11 10 011 0011 0010 00011 000101 000100 0000100 0000101 0000111 00000100 "
    "00000111 000011000 0000010111 0000011000 0000001000 00001100111 00001101000 00001101100 "
    "00000110111 00000101000 00000010111 00000011000 000011001010 000011001011 000011001100 "
    "000011001101 000001101000 000001101001 000001101010 000001101011 000011010010 000011010011 "
    "000011010100 000011010101 000011010110 000011010111 000001101100 000001101101 000011011010 "
    "000011011011 000001010100 000001010101 000001010110 000001010111 000001100100 000001100101 "
    "000001010010 000001010011 000000100100 000000110111 000000111000 000000100111 000000101000 "
    "000001011000 000001011001 000000101011 000000101100 000001011010 000001100110 "
    "000001100111").split()
_WHITE_MAKEUP = (
    "11011 10010 010111 0110111 00110110 00110111 01100100 01100101 01101000 01100111 011001100 "
    "011001101 011010010 011010011 011010100 011010101 011010110 011010111 011011000 011011001 "
    "011011010 011011011 010011000 010011001 010011010 011000 010011011").split()
_BLACK_MAKEUP = (
    "0000001111 000011001000 000011001001 000001011011 000000110011 000000110100 000000110101 "
    "0000001101100 0000001101101 0000001001010 0000001001011 0000001001100 0000001001101 "
    "0000001110010 0000001110011 0000001110100 0000001110101 0000001110110 0000001110111 "
    "0000001010010 0000001010011 0000001010100 0000001010101 0000001011010 0000001011011 "
    "0000001100100 0000001100101").split()
_EXT_MAKEUP = ("00000001000 00000001100 00000001101 000000010010 000000010011 000000010100 "
               "000000010101 000000010110 000000010111 000000011100 000000011101 000000011110 "
               "000000011111").split()      # 1792 .. 2560, either colour
FAX_EOL = "000000000001"
_MODES_2D = {"P": "0001", "H": "001", 0: "1", 1: "011", 2: "000011", 3: "0000011",
             -1: "010", -2: "000010", -3: "0000010"}


def fax_run(run: int, black: bool) -> str:
    """The T.4 code words of one run: 2560s, a make-up code, a terminating
    code."""
    term, makeup = (_BLACK_TERM, _BLACK_MAKEUP) if black else (_WHITE_TERM, _WHITE_MAKEUP)
    out = []
    while run >= 2560:
        out.append(_EXT_MAKEUP[-1])
        run -= 2560
    if run >= 64:
        m = run // 64
        out.append(makeup[m - 1] if m <= 27 else _EXT_MAKEUP[m - 28])
    out.append(term[run % 64])
    return "".join(out)


def _changes(row: np.ndarray) -> list[int]:
    """The changing elements of a row of 0/1 (the first pixel against an
    imaginary 0), then the width."""
    prev = np.concatenate([[0], row[:-1]])
    return [int(p) for p in np.flatnonzero(row != prev)] + [len(row)]


def fax_1d(row: np.ndarray) -> str:
    """A row of 0/1 (1 the "black" runs) in Modified Huffman."""
    ch = _changes(row)
    out, pos, black = [], 0, False
    for c in ch:
        out.append(fax_run(c - pos, black))
        pos, black = c, not black
        if c >= len(row):
            break
    return "".join(out)


def fax_2d(row: np.ndarray, ref: np.ndarray) -> str:
    """A row coded against the reference row ``ref`` in T.4's 2-D modes
    (the k-th changing element of a row, from 0, starts a black run where
    k is even)."""
    w = len(row)
    cur, rch = _changes(row) + [w], _changes(ref) + [w, w]
    out, a0, c = [], -1, 0
    while a0 < w:
        a1 = cur[bisect.bisect_right(cur, a0)]
        k = bisect.bisect_right(rch, a0)
        if k < len(rch) - 2 and rch[k] < w and k % 2 != c:    # b1: the colour opposite a0's
            k += 1
        b1, b2 = rch[k], rch[k + 1] if rch[k] < w else w
        if b2 < a1:
            out.append(_MODES_2D["P"])
            a0 = b2
        elif abs(a1 - b1) <= 3:
            out.append(_MODES_2D[a1 - b1])
            a0, c = a1, 1 - c
        else:
            a2 = cur[bisect.bisect_right(cur, a1)] if a1 < w else w
            out += [_MODES_2D["H"], fax_run(a1 - max(a0, 0), c == 1), fax_run(a2 - a1, c == 0)]
            a0 = a2
    return "".join(out)


def _pack_bits(bits: str) -> bytes:
    bits += "0" * (-len(bits) % 8)
    return bytes(int(bits[i:i + 8], 2) for i in range(0, len(bits), 8))


def fax_encode(block: np.ndarray, compression: int, two_d_every: int = 0,
               eol: str = "each", fill_bits: bool = False, rtc: bool = True) -> bytes:
    """A block [rows, w] of 0/1 as CCITT data: compression 2 (Modified
    Huffman, each row byte-aligned, no EOL; 32771, RLE-W: each row
    aligned to 16 bits from the block's start), 3 (T.4: 1-D rows, or with
    ``two_d_every`` k a 1-D row then k - 1 2-D rows, each row behind an
    EOL (``eol`` "each"; "none": no EOL at all) and, for 2-D, its tag bit;
    ``fill_bits``: zeros before each EOL so that it ends on a byte; RTC
    (six EOLs) last with ``rtc``), or 4 (T.6: 2-D rows against the row
    above, the first against white, then EOFB)."""
    rows, w = block.shape
    ref = np.zeros(w, np.uint8)
    if compression in (2, 32771):
        align = 8 if compression == 2 else 16
        return b"".join(_pack_bits(fax_1d(r) + "0" * (-len(fax_1d(r)) % align)) for r in block)
    out = ""
    for k, row in enumerate(block):
        if compression == 4:
            out += fax_2d(row, ref)
        else:
            one_d = not two_d_every or k % two_d_every == 0
            if eol == "each":
                if fill_bits:
                    out += "0" * ((-len(out) - len(FAX_EOL)) % 8)
                out += FAX_EOL + (("1" if one_d else "0") if two_d_every else "")
            out += fax_1d(row) if one_d else fax_2d(row, ref)
        ref = row
    if compression == 4:
        out += FAX_EOL * 2
    elif rtc:
        out += (FAX_EOL + ("1" if two_d_every else "")) * 6
    return _pack_bits(out)


def make_tiff(samples, mode, bo="<", compression=1, predictor=1, rows_per_strip=None,
              cmap=None, extra_tags=(), tile=None, planar=False, fill_order=1, fax=None,
              subsampling=None, level=None, old_lzw=False, codec=None) -> bytes:
    """A TIFF of samples [h, w, spp] (uint8 or uint16 below 17 bits, the
    int or float type of the sample format at 16 and 32) in byte order
    ``bo`` ('<' II, '>' MM): in strips of ``rows_per_strip`` rows (the last
    one short), or in tiles of ``tile`` = (height, width) whose parts past
    the image are filled with a seeded junk; chunky, or planar
    (PlanarConfiguration 2: the strips or tiles of each sample in turn);
    compressed as asked (``COMPRESS``), with the horizontal (2) or
    floating-point (3) predictor under LZW and deflate; ``fill_order`` 2
    with the bits of every stored byte reversed (after compression, as
    libtiff reverses them before it decompresses).  CCITT (compressions
    2, 3 and 4) of 1-bit samples through :func:`fax_encode`, ``fax`` its
    options (T4Options or T6Options follow them, unless ``extra_tags``
    sets them).  YCbCr samples (Y, Cb, Cr) with ``subsampling`` (h, v)
    are stored in its blocks (the block's luma, then the Cb and Cr of its
    top-left sample; edge samples repeated to whole blocks), with the
    YCbCrSubsampling tag.  Compression 7 (JPEG) takes RGB samples, each
    strip or tile coded by the port's ``encode_jpeg`` (Pillow's 4:2:0),
    its tables moved to JPEGTables, as YCbCr with subsampling 2x2.
    ``level``: the Zstandard level or xz preset (compressions 50000 and
    34925); ``old_lzw``: LZW in libtiff's old LSB-first form; ``codec``: a
    function of a block's bytes in place of the compression's own."""
    photo, bits, spp, extra, fmt = MODES[mode]
    compress = codec or COMPRESS.get(compression)
    if codec is None and compression == 5 and old_lzw:
        compress = lambda b: lzw_encode(b, lsb=True)  # noqa: E731
    elif codec is None and level is not None:
        compress = lambda b: COMPRESS[compression](b, level)  # noqa: E731
    h, w, _ = samples.shape
    if compression == 7:
        return _jpeg_tiff(samples, bo, rows_per_strip, tile, extra_tags)
    planes = [samples[..., k:k + 1] for k in range(spp)] if planar else [samples]
    if compression not in _PREDICTED:
        predictor_used = 1
    else:
        predictor_used = predictor
    if tile:
        th, tw = tile
        grid = [(y, x) for y in range(0, h, th) for x in range(0, w, tw)]
        junk = np.random.default_rng(99).integers(0, 1 << min(bits, 16), (-(-h // th) * th,
                                                                         -(-w // tw) * tw, 1))
    else:
        th, tw = min(rows_per_strip or h, h), w
        grid = [(y, 0) for y in range(0, h, th)]
    blocks = []
    for plane in planes:
        c = plane.shape[2]
        if tile:
            full = np.empty((junk.shape[0], junk.shape[1], c), plane.dtype)
            full[...] = junk.astype(plane.dtype)
            full[:h, :w] = plane
        else:
            full = plane
        for y, x in grid:
            if compression in (2, 3, 4, 32771):
                blk = fax_encode(full[y:y + th, x:x + tw, 0], compression, **(fax or {}))
            elif subsampling:
                blk = compress(_ycbcr_blocks(full[y:y + th, x:x + tw], *subsampling))
            else:
                rows = _row_bytes(full[y:y + th, x:x + tw], bits, bo, predictor_used)
                blk = compress(b"".join(rows))
            if fill_order == 2:
                blk = _BITREV[np.frombuffer(blk, np.uint8)].tobytes()
            blocks.append(blk)
    tags = {256: (4, [w]), 257: (4, [h]), 258: (3, [bits] * spp), 259: (3, [compression]),
            262: (3, [photo]), 277: (3, [spp]), 284: (3, [2 if planar else 1])}
    if tile:
        tags.update({322: (3, [tw]), 323: (3, [th]), 324: (4, []),
                     325: (4, [len(b) for b in blocks])})
    else:
        tags.update({273: (4, []), 278: (4, [th]), 279: (4, [len(b) for b in blocks])})
    if predictor != 1:
        tags[317] = (3, [predictor])
    if extra:
        tags[338] = (3, list(extra))
    if fmt != 1:
        tags[339] = (3, [fmt] * spp)
    if fill_order != 1:
        tags[266] = (3, [fill_order])
    if cmap is not None:
        tags[320] = (3, list(cmap))
    if subsampling:
        tags[530] = (3, list(subsampling))
    if compression == 3 and fax and fax.get("two_d_every"):
        tags[292] = (4, [1 | (4 if fax.get("fill_bits") else 0)])
    elif compression == 3 and fax and fax.get("fill_bits"):
        tags[292] = (4, [4])
    tags.update(extra_tags)
    return _assemble(blocks, tags, bo)


def _assemble(blocks, tags, bo, index=None) -> bytes:
    """A TIFF of the stored strips or tiles and the tags, (type, values)
    by tag; the offsets (273 or 324) are filled in: one strip or tile a
    block, or the block ``index[k]`` for strip or tile k.  Types: 3 SHORT,
    4 LONG, 5 RATIONAL (values in (numerator, denominator) pairs), 7
    UNDEFINED (bytes)."""
    offsets, pos = [], 8
    for blk in blocks:
        offsets.append(pos)
        pos += len(blk)
    if index is not None:
        offsets = [offsets[k] for k in index]
    tags = dict(tags)
    tags[324 if 324 in tags else 273] = (4, offsets)
    body = b"".join(blocks)
    body += b"\0" * (pos % 2)
    pos += pos % 2
    entries, data_at = [], pos
    out_of_line = bytearray()
    ifd_at = data_at
    for tag, (typ, vals) in sorted(tags.items()):
        raw = struct.pack(bo + {3: "H", 4: "I", 5: "I", 7: "B"}[typ] * len(vals), *vals)
        entries.append((tag, typ, len(vals) // (2 if typ == 5 else 1), raw))
        if len(raw) > 4:
            ifd_at += len(raw) + len(raw) % 2
    ifd = struct.pack(bo + "H", len(entries))
    at = data_at
    for tag, typ, n, raw in entries:
        if len(raw) > 4:
            ifd += struct.pack(bo + "HHII", tag, typ, n, at)
            out_of_line += raw + b"\0" * (len(raw) % 2)
            at += len(raw) + len(raw) % 2
        else:
            ifd += struct.pack(bo + "HHI", tag, typ, n) + raw.ljust(4, b"\0")
    head = (b"II*\0" if bo == "<" else b"MM\0*") + struct.pack(bo + "I", ifd_at)
    return head + body + bytes(out_of_line) + ifd + b"\0\0\0\0"


def _ycbcr_blocks(samples: np.ndarray, hs: int, vs: int) -> bytes:
    """YCbCr samples [h, w, 3] in TIFF's subsampled layout: per block of
    hs x vs luma samples (edge samples repeated to whole blocks) its luma,
    row by row, then the Cb and Cr of its top-left sample."""
    h, w, _ = samples.shape
    ph, pw = -(-h // vs) * vs, -(-w // hs) * hs
    full = np.pad(samples, ((0, ph - h), (0, pw - w), (0, 0)), mode="edge")
    y = full[..., 0].reshape(ph // vs, vs, pw // hs, hs).transpose(0, 2, 1, 3)
    y = y.reshape(ph // vs, pw // hs, hs * vs)
    c = full[::vs, ::hs, 1:]
    return np.ascontiguousarray(np.concatenate([y, c], -1), np.uint8).tobytes()


def split_jpeg(stream: bytes) -> tuple[bytes, bytes]:
    """A JPEG file as a TIFF holds it: (JPEGTables: SOI, its DQT and DHT
    segments, EOI; the abbreviated stream: SOI, the rest but APPn)."""
    tables, rest, pos = b"\xff\xd8", b"\xff\xd8", 2
    while True:
        code = stream[pos + 1]
        if code == 0xDA:
            return tables + b"\xff\xd9", rest + stream[pos:]
        n = struct.unpack_from(">H", stream, pos + 2)[0]
        seg = stream[pos:pos + 2 + n]
        if code in (0xDB, 0xC4):
            tables += seg
        elif not 0xE0 <= code <= 0xEF:
            rest += seg
        pos += 2 + n


def _jpeg_tiff(rgb, bo, rows_per_strip, tile, extra_tags) -> bytes:
    """make_tiff's compression 7: strips of ``rows_per_strip`` rows or
    tiles of ``tile`` (padded with the edge samples), each the port's
    4:2:0 JPEG of its RGB, sharing one JPEGTables."""
    from dspfun_tpu_torch.io import jpeg  # noqa: PLC0415

    h, w, _ = rgb.shape
    if tile:
        th, tw = tile
        full = np.pad(rgb, ((0, -h % th), (0, -w % tw), (0, 0)), mode="edge")
        grid = [(y, x) for y in range(0, h, th) for x in range(0, w, tw)]
    else:
        th, tw, full = min(rows_per_strip or h, h), w, rgb
        grid = [(y, 0) for y in range(0, h, th)]
    blocks, tables = [], b""
    for y, x in grid:
        tables, blk = split_jpeg(jpeg.encode_jpeg(np.ascontiguousarray(full[y:y + th, x:x + tw])))
        blocks.append(blk)
    tags = {256: (4, [w]), 257: (4, [h]), 258: (3, [8] * 3), 259: (3, [7]), 262: (3, [6]),
            277: (3, [3]), 284: (3, [1]), 347: (7, list(tables)), 530: (3, [2, 2])}
    if tile:
        tags.update({322: (3, [tw]), 323: (3, [th]), 324: (4, []),
                     325: (4, [len(b) for b in blocks])})
    else:
        tags.update({273: (4, []), 278: (4, [th]), 279: (4, [len(b) for b in blocks])})
    tags.update(extra_tags)
    return _assemble(blocks, tags, bo)


def tiff_samples(mode, h, w, seed) -> np.ndarray:
    """Seeded samples [h, w, spp] of a mode of ``MODES``: smooth (so
    predictor 2 and LZW have something to find) plus noise; premultiplied
    colour never above its alpha, as a writer of associated alpha stores
    it; 32-bit integers and floats past 0 and 65535 (and 255), with NaN
    and infinities."""
    photo, bits, spp, extra, fmt = MODES[mode]
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = (0.5 + 0.4 * np.sin(x[..., None] / 3.0 + y[..., None] / 5.0 + np.arange(spp)))
    if fmt == 3:
        v = (base * 400 - 60 + rng.normal(0, 20, (h, w, spp))).astype(np.float32)
        v.flat[:4] = [np.nan, np.inf, -np.inf, 254.999]
        return v
    if bits == 32:
        lo, hi = (-90000, 150000) if fmt == 2 else (0, 3 << 30)
        return (lo + base * (hi - lo) + rng.normal(0, 999, (h, w, spp))).astype(
            np.int64).astype(np.int32 if fmt == 2 else np.uint32)
    top = (1 << bits) - 1
    v = np.clip(base * top + rng.normal(0, top / 20, (h, w, spp)), 0, top).astype(np.int64)
    if bits == 1:
        return (v > 0).astype(np.uint8)
    if extra[:1] == (1,):
        v[..., :3] = v[..., :3] * v[..., 3:4] // top
    if fmt == 2:
        return (v - (top + 1) // 2).astype(np.int16 if bits == 16 else np.int8)
    return v.astype(np.uint16 if bits > 8 else np.uint8)


def palette(seed, bits=8) -> np.ndarray:
    """A seeded TIFF colormap of 3 * 2^bits 16-bit values."""
    return np.random.default_rng(seed).integers(0, 65536, 3 << bits)


# the small TIFFs of chip_smoke.py phase 19(a): name -> (mode, make_tiff's
# keywords); 45x67 samples of tiff_samples(mode, 45, 67, seed 31)
LAYOUT_TIFFS = {
    "tiled LZW RGB predictor 2": ("RGB", dict(compression=5, predictor=2, tile=(32, 16))),
    "planar deflate RGBA;16": ("RGBA;16", dict(compression=8, planar=True, rows_per_strip=8)),
    "FillOrder 2 1 raw": ("1", dict(fill_order=2, rows_per_strip=16)),
    "FillOrder 2 1 LZW": ("1", dict(compression=5, fill_order=2, rows_per_strip=16)),
    "FillOrder 2 L raw": ("L", dict(fill_order=2, rows_per_strip=16)),
    "FillOrder 2 L LZW": ("L", dict(compression=5, fill_order=2, rows_per_strip=16)),
    "predictor 3 deflate F": ("F", dict(compression=8, predictor=3, rows_per_strip=8)),
    "CMYK raw": ("CMYK", dict(rows_per_strip=10)),
    "CMYK;16 LZW big-endian": ("CMYK;16", dict(bo=">", compression=5, rows_per_strip=10)),
    "I;32S deflate": ("I;32S", dict(compression=8, rows_per_strip=12)),
    "4-bit palette PackBits": ("P;4", dict(compression=32773, rows_per_strip=12)),
    "PA LZW": ("PA", dict(compression=5, rows_per_strip=12)),
    "Orientation 6 RGB": ("RGB", dict(compression=8, extra_tags={274: (3, [6])})),
    "Orientation 8 RGB tiled": ("RGB", dict(compression=5, tile=(16, 16),
                                            extra_tags={274: (3, [8])})),
}


def layout_tiffs() -> dict[str, bytes]:
    """Each of ``LAYOUT_TIFFS`` written by :func:`make_tiff` (no Pillow)."""
    out = {}
    for name, (mode, kw) in LAYOUT_TIFFS.items():
        bits = MODES[mode][1]
        out[name] = make_tiff(tiff_samples(mode, 45, 67, 31), mode,
                              cmap=palette(31, bits) if mode.startswith("P") else None, **kw)
    return out


def doc_page(h: int, w: int, seed: int) -> np.ndarray:
    """A seeded bilevel page [h, w] of 0 (paper) and 1 (ink), as a
    document scanner sees one: margins, lines of word-like blocks of
    glyph strokes, a ruled box."""
    rng = np.random.default_rng(seed)
    page = np.zeros((h, w), np.uint8)
    m, pitch = max(w // 16, 2), max(h // 60, 12)
    for top in range(m, h - m - pitch, pitch):
        x = m + int(rng.integers(0, 4 * pitch))
        while x < w - m - pitch:
            word = int(rng.integers(2, 9)) * (pitch // 2)
            for gx in range(x, min(x + word, w - m), max(pitch // 2, 2)):
                gh, gw = int(rng.integers(pitch // 3, 2 * pitch // 3 + 1)), max(pitch // 4, 1)
                page[top + pitch - gh:top + pitch, gx:gx + gw] = 1
                if rng.random() < 0.4:
                    page[top + pitch - gh:top + pitch - gh + 2, gx:gx + pitch // 2] = 1
            x += word + pitch
    page[m // 2:m // 2 + 3, m:w - m] = 1
    page[h - m // 2 - 3:h - m // 2, m:w - m] = 1
    return page


def cmyk_levels(rgb: np.ndarray) -> np.ndarray:
    """A fixed CMYK of 8-bit RGB levels: K half the darkness, C, M, Y the
    rest of each channel's."""
    k = (255 - rgb.max(axis=-1, keepdims=True).astype(np.int32)) // 2
    return np.concatenate([255 - rgb.astype(np.int32) - k, k], -1).astype(np.uint8)


# the small TIFFs of chip_smoke.py phase 20(a) written here by hand: name ->
# (mode, samples' (kind, seed), make_tiff's keywords); 45x67 samples
REFBW = {532: (5, [16, 1, 235, 1, 128, 1, 240, 1, 128, 1, 240, 1])}
MORE_TIFFS = {
    "JPEG YCbCr 4:2:0 tiled": ("YCbCr", ("levels", 41), dict(compression=7, tile=(32, 48))),
    "YCbCr 2x2 LZW ReferenceBlackWhite": ("YCbCr", ("samples", 42), dict(
        compression=5, subsampling=(2, 2), rows_per_strip=8, extra_tags=REFBW)),
    "YCbCr 4x2 LZW ReferenceBlackWhite": ("YCbCr", ("samples", 43), dict(
        compression=5, subsampling=(4, 2), rows_per_strip=8, extra_tags=REFBW)),
    "G3 1-D": ("1 inverted", ("page", 44), dict(compression=3, rows_per_strip=16)),
    "G3 2-D EOL fill": ("1 inverted", ("page", 45), dict(
        compression=3, fax=dict(two_d_every=4, fill_bits=True))),
    "G4 FillOrder 2": ("1 inverted", ("page", 46), dict(compression=4, fill_order=2)),
    "CCITT RLE": ("1", ("page", 47), dict(compression=2, rows_per_strip=10)),
    "LAB deflate": ("LAB", ("samples", 48), dict(compression=8, rows_per_strip=8)),
    "LAB planar deflate": ("LAB", ("samples", 49), dict(compression=8, rows_per_strip=8,
                                                        planar=True)),
}
# Pillow's JPEG-in-TIFF goldens of phase 20(a) (tests/goldens/), which
# encode_jpeg cannot write: 64x96 levels of seed 48 (YCbCr at 1x1 in
# strips of 8 rows, RGB, gray, CMYK)
TIFF_JPEG_GOLDENS = {"tiffjpeg_ycbcr11.tif": "YCbCr", "tiffjpeg_rgb.tif": "RGB",
                     "tiffjpeg_gray.tif": "L", "tiffjpeg_cmyk.tif": "CMYK"}


def more_tiffs() -> dict[str, bytes]:
    """Each of ``MORE_TIFFS`` written by :func:`make_tiff` (no Pillow)."""
    out = {}
    for name, (mode, (kind, seed), kw) in MORE_TIFFS.items():
        if kind == "levels":
            s = levels((45, 67), seed)
        elif kind == "page":
            s = doc_page(45, 67, seed)[..., None]
        else:
            s = np.random.default_rng(seed).integers(0, 256, (45, 67, 3)).astype(np.uint8)
        out[name] = make_tiff(s, mode, **kw)
    return out


def tiff_jpeg_goldens() -> dict[str, bytes]:
    """Pillow's bytes of each of ``TIFF_JPEG_GOLDENS``."""
    from PIL import Image  # noqa: PLC0415

    img = Image.fromarray(levels((64, 96), 48))
    return {name: _save(img.convert(mode), "TIFF", compression="jpeg",
                        **({"strip_size": 96 * 3 * 8} if mode == "YCbCr" else {}))
            for name, mode in TIFF_JPEG_GOLDENS.items()}


def tiff_4k(kind: str, hw, seed: int, noise: float) -> bytes:
    """Phase 20(b)'s 4K TIFFs of the seeded levels: "jpeg" the 256x256
    tiled 4:2:0 JPEG-in-TIFF, "g4" a G4 page of :func:`doc_page`,
    "ycbcr" the levels as YCbCr samples at 2x2 in deflate strips of 64
    rows."""
    if kind == "g4":
        return make_tiff(doc_page(hw[0], hw[1], seed)[..., None], "1 inverted", compression=4)
    rgb = levels(hw, seed, noise)
    if kind == "jpeg":
        return make_tiff(rgb, "YCbCr", compression=7, tile=(256, 256))
    return make_tiff(rgb, "YCbCr", compression=8, subsampling=(2, 2), rows_per_strip=64)


# the Zstandard and LZMA TIFFs of chip_smoke.py phase 23(a) in tests/goldens/:
# Pillow's (libtiff's) of 48x64 samples (name -> mode, compression,
# predictor) and make_tiff's tiled and planar ones with predictor 2 of
# 45x67 samples (name -> mode, keywords); the card's machine has no
# Zstandard encoder
ZSTD_LZMA_PILLOW = {f"{c}_{name}.tif": (mode, c, pred) for c in ("zstd", "lzma")
                    for name, mode, pred in (("l", "L", 1), ("rgb_p2", "RGB", 2),
                                             ("rgba", "RGBA", 1), ("i16_p2", "I;16", 2),
                                             ("f_p3", "F", 3))}
ZSTD_LZMA_MADE = {
    "zstd_tiled_p2.tif": ("RGB", dict(compression=50000, predictor=2, tile=(32, 16), level=19)),
    "zstd_planar_p2.tif": ("RGBA;16", dict(compression=50000, predictor=2, planar=True,
                                           rows_per_strip=8, level=1)),
    "lzma_tiled_p2.tif": ("RGB", dict(compression=34925, predictor=2, tile=(32, 16))),
    "lzma_planar_p2.tif": ("RGBA;16", dict(compression=34925, predictor=2, planar=True,
                                           rows_per_strip=8, level=0)),
}
# phase 23(b)'s strips: Pillow's 3840x20 TIFF (four strips of 5 rows,
# predictor 2) of levels((20, 3840), STRIP_SEED, STRIP_NOISE) in each
# codec, whose strips strip_4k() repeats down a 3840x2160 file
STRIP_DONORS = {"zstd_4k_strips.tif": "zstd", "lzma_4k_strips.tif": "lzma"}
STRIP_SEED, STRIP_NOISE = 51, 0.02
# phase 23(a)'s LZW TIFFs in libtiff's old LSB-first form, written at run
# time (name -> mode, make_tiff's keywords; 45x67 samples of seed 52)
OLD_LZW_TIFFS = {
    "old LZW L": ("L", dict(rows_per_strip=16)),
    "old LZW RGB predictor 2": ("RGB", dict(predictor=2, rows_per_strip=8)),
    "old LZW tiled RGBA": ("RGBA", dict(tile=(16, 32))),
    "old LZW planar RGB;16 big-endian": ("RGB;16", dict(bo=">", planar=True, predictor=2,
                                                        rows_per_strip=12)),
    "old LZW FillOrder 2 L": ("L", dict(fill_order=2, rows_per_strip=20)),
}


def _pillow_samples(mode: str, seed: int):
    """A seeded 48x64 Pillow image of ``mode`` (L, RGB, RGBA, I;16 or F)."""
    from PIL import Image  # noqa: PLC0415

    rgb = levels((48, 64), seed)
    if mode in ("L", "RGB"):
        return Image.fromarray(rgb).convert(mode)
    if mode == "RGBA":
        return Image.fromarray(np.dstack([rgb, seeded_alpha(48, 64, seed)]))
    if mode == "I;16":
        v = rgb[..., 0].astype(np.uint16) * 257 + np.arange(64, dtype=np.uint16)
        return Image.fromarray(v)
    v = rgb[..., 1].astype(np.float32) * 1.5 - 40.25
    v.flat[:3] = [np.nan, np.inf, -np.inf]
    return Image.fromarray(v)


def zstd_lzma_fixtures() -> dict[str, bytes]:
    """Each of ``ZSTD_LZMA_PILLOW`` (Pillow's bytes), ``ZSTD_LZMA_MADE``
    (make_tiff's, through zstandard and lzma) and ``STRIP_DONORS``."""
    out = {}
    for k, (name, (mode, comp, pred)) in enumerate(ZSTD_LZMA_PILLOW.items()):
        out[name] = _save(_pillow_samples(mode, 53 + k % 5), "TIFF", compression=comp,
                          **({"tiffinfo": {317: pred}} if pred > 1 else {}))
    for name, (mode, kw) in ZSTD_LZMA_MADE.items():
        out[name] = make_tiff(tiff_samples(mode, 45, 67, 54), mode, **kw)
    from PIL import Image  # noqa: PLC0415

    donor = Image.fromarray(levels((20, 3840), STRIP_SEED, STRIP_NOISE))
    for name, comp in STRIP_DONORS.items():
        out[name] = _save(donor, "TIFF", compression=comp, tiffinfo={317: 2})
    return out


def old_lzw_tiffs() -> dict[str, bytes]:
    """Each of ``OLD_LZW_TIFFS`` written by :func:`make_tiff` (no Pillow)."""
    return {name: make_tiff(tiff_samples(mode, 45, 67, 52), mode, compression=5, old_lzw=True,
                            **kw) for name, (mode, kw) in OLD_LZW_TIFFS.items()}


def strip_4k(donor: bytes, h: int = 2160) -> bytes:
    """A TIFF of ``h`` rows whose strips are the donor's strips in turn
    (the donor's tags but for its height, offsets and byte counts; each
    strip's bytes stored once)."""
    bo = {b"II": "<", b"MM": ">"}[donor[:2]]
    ifd = struct.unpack_from(bo + "I", donor, 4)[0]
    tags = {}
    for k in range(struct.unpack_from(bo + "H", donor, ifd)[0]):
        tag, typ, count, val = struct.unpack_from(bo + "HHI4s", donor, ifd + 2 + 12 * k)
        code = {3: "H", 4: "I"}[typ]
        size = struct.calcsize(code) * count
        raw = val if size <= 4 else donor[struct.unpack(bo + "I", val)[0]:]
        tags[tag] = (typ, list(struct.unpack(bo + code * count, raw[:size])))
    donors = [donor[o:o + c] for o, c in zip(tags[273][1], tags[279][1])]
    index = [k % len(donors) for k in range(-(-h // tags[278][1][0]))]
    tags.update({257: (4, [h]), 273: (4, []), 279: (4, [len(donors[k]) for k in index])})
    return _assemble(donors, tags, bo, index)


def rgba_digest(pixels: np.ndarray) -> str:
    """sha256 of ``read_image(..., channels="RGBA")`` float64 pixels."""
    return hashlib.sha256(np.ascontiguousarray(pixels, np.float64).tobytes()).hexdigest()


def fixtures() -> dict[str, bytes]:
    """Each fixture's name and Pillow's bytes of it."""
    from PIL import Image  # noqa: PLC0415
    import chip_smoke  # noqa: PLC0415

    big = Image.fromarray(levels((chip_smoke.H, chip_smoke.W), 17, noise=0.02))
    small = Image.fromarray(levels((333, 517), 18))
    tiny = levels((120, 160), 19, noise=0.02)
    y, x = np.mgrid[0:120, 0:160]
    alpha = np.clip((x * 2 - 40) + (y - 60) // 4, 0, 255).astype(np.uint8)
    alpha[:8] = 255
    premultiplied = (tiny.astype(np.int64) * alpha[..., None] // 255).astype(np.uint8)
    rgba = Image.fromarray(np.dstack([premultiplied, alpha]))
    return {
        "codec_prog_4k.jpg": _save(big, "JPEG", progressive=True),
        "codec_prog_gray.jpg": _save(small.convert("L"), "JPEG", progressive=True),
        "codec_prog_444_rst.jpg": _save(small, "JPEG", progressive=True, subsampling=0,
                                        restart_marker_blocks=4),
        "codec_lzw_p1.tif": _save(Image.fromarray(tiny), "TIFF", compression="tiff_lzw"),
        "codec_lzw_p2.tif": _save(Image.fromarray(tiny), "TIFF", compression="tiff_lzw",
                                  tiffinfo={317: 2}),
        "codec_packbits.tif": _save(Image.fromarray(tiny), "TIFF", compression="packbits"),
        "codec_rgba_assoc.tif": _associated(_save(rgba, "TIFF", compression="tiff_lzw")),
    }


def set_adobe_transform(data: bytes, transform: int) -> bytes:
    """A JPEG with its Adobe marker's transform byte set."""
    out = bytearray(data)
    at = data.index(b"\xff\xee")
    out[at + 15] = transform
    return bytes(out)


def without_adobe(data: bytes) -> bytes:
    at = data.index(b"\xff\xee")
    return data[:at] + data[at + 2 + struct.unpack_from(">H", data, at + 2)[0]:]


def cmyk_fixtures() -> dict[str, bytes]:
    """The CMYK JPEG fixtures of ``chip_smoke.py`` phase 19 and Pillow's
    bytes of each: the 4K levels of ``codec_prog_4k.jpg`` made CMYK by
    :func:`cmyk_levels`, progressive; 320x200 levels (seed 24) baseline
    with restart markers every 5 MCUs, that file with its Adobe transform
    set to 2 (YCCK), and without its Adobe marker (CMYK as stored)."""
    from PIL import Image  # noqa: PLC0415

    import chip_smoke  # noqa: PLC0415

    big = Image.fromarray(cmyk_levels(levels((chip_smoke.H, chip_smoke.W), 17, noise=0.02)),
                          "CMYK")
    small = _save(Image.fromarray(cmyk_levels(levels((200, 320), 24)), "CMYK"), "JPEG",
                  restart_marker_blocks=5)
    return {"cmyk_prog_4k.jpg": _save(big, "JPEG", progressive=True),
            "cmyk_rst.jpg": small,
            "cmyk_ycck.jpg": set_adobe_transform(small, 2),
            "cmyk_no_adobe.jpg": without_adobe(small)}


def cmyk_digests(data: bytes) -> tuple[str, str]:
    """sha256 of a JPEG file and of Pillow's ``convert("RGB")`` of it."""
    from PIL import Image  # noqa: PLC0415

    pixels = np.ascontiguousarray(np.asarray(Image.open(io.BytesIO(data)).convert("RGB")))
    return hashlib.sha256(data).hexdigest(), hashlib.sha256(pixels.tobytes()).hexdigest()


def lzw_codes(pixels: bytes, min_code: int, defer: bool = False, clear_every: int = 0,
              end: bool = True, stop_at: int | None = None) -> list[tuple[int, int]]:
    """(code, width) of a greedy GIF LZW coding of ``pixels``: a clear code
    first, widths growing with the table, then either a clear code when
    the table is full or (``defer``) the full table kept to the end; a
    clear code after every ``clear_every`` codes; the end code, or none;
    ``stop_at``: the end code after the string that reaches that many
    pixels."""
    clear = 1 << min_code

    def reset():
        return {bytes([i]): i for i in range(min(clear, 256))}, clear + 2, min_code + 1

    table, nxt, width = reset()
    out, i, n, emitted = [(clear, width)], 0, len(pixels), 0
    while i < n and (stop_at is None or i < stop_at):
        s, j = pixels[i:i + 1], i + 1
        while j < n and pixels[i:j + 1] in table:
            s, j = pixels[i:j + 1], j + 1
        out.append((table[s], width))
        emitted += 1
        if j < n and nxt < 4096:
            table[pixels[i:j + 1]] = nxt
            nxt += 1
        i = j
        if nxt > 1 << width and width < 12:
            width += 1
        if i < n and ((not defer and nxt == 4096)
                      or (clear_every and emitted % clear_every == 0)):
            out.append((clear, width))
            table, nxt, width = reset()
    if end:
        out.append((clear + 1, width))
    return out


def pack_codes(codes) -> bytes:
    """GIF's bit order: each code's low bits first."""
    acc = nbits = 0
    out = bytearray()
    for code, width in codes:
        acc |= code << nbits
        nbits += width
        while nbits >= 8:
            out.append(acc & 255)
            acc >>= 8
            nbits -= 8
    if nbits:
        out.append(acc & 255)
    return bytes(out)


def sub_blocks(data: bytes, size: int = 255) -> bytes:
    """``data`` in sub-blocks of ``size`` bytes and the empty terminator."""
    return b"".join(bytes([len(data[i:i + size])]) + data[i:i + size]
                    for i in range(0, len(data), size)) + b"\0"


def interlace_order(h: int) -> list[int]:
    return [*range(0, h, 8), *range(4, h, 8), *range(2, h, 4), *range(1, h, 2)]


def _table(palette) -> tuple[bytes, int]:
    p = bytes(np.asarray(palette, np.uint8).ravel())
    bits = max(1, (len(p) // 3 - 1).bit_length())
    return p.ljust(3 << bits, b"\0"), bits - 1


def make_gif(idx, palette=None, local=None, min_code=8, interlace=False, screen=None,
             offset=(0, 0), trns=None, version=b"89a", extensions=b"", **lzw) -> bytes:
    """A one-frame GIF of the indices ``idx`` [h, w] written by hand: an
    optional global and local palette (padded to a power of two), a
    Graphic Control Extension with ``trns``, ``extensions`` before it, the
    frame at ``offset`` of a ``screen`` (w, h), interlaced or not, LZW
    codes of :func:`lzw_codes` (``lzw``: its options)."""
    idx = np.asarray(idx, np.uint8)
    h, w = idx.shape
    sw, sh = screen or (w, h)
    out = b"GIF" + version + struct.pack("<HH", sw, sh)
    if palette is not None:
        table, size = _table(palette)
        out += bytes([0x80 | size, 0, 0]) + table
    else:
        out += b"\0\0\0"
    out += extensions
    if trns is not None:
        out += b"!\xf9\x04\x01\x00\x00" + bytes([trns]) + b"\0"
    flags, table = 0x40 if interlace else 0, b""
    if local is not None:
        table, size = _table(local)
        flags |= 0x80 | size
    out += b"," + struct.pack("<HHHHB", *offset, w, h, flags) + table
    rows = interlace_order(h) if interlace else range(h)
    pixels = b"".join(idx[r].tobytes() for r in rows)
    return out + bytes([min_code]) + sub_blocks(pack_codes(lzw_codes(pixels, min_code,
                                                                       **lzw))) + b";"


def gif_fixtures() -> dict[str, bytes]:
    """Each GIF fixture's name and its bytes (Pillow's or :func:`make_gif`'s)."""
    from PIL import Image  # noqa: PLC0415

    rgb = levels((96, 128), 21)
    alpha = np.where(np.random.default_rng(21).random((96, 128)) < 0.25, 0, 255)
    rgba = np.dstack([rgb, alpha.astype(np.uint8)])
    rng = np.random.default_rng(22)
    palette = rng.integers(0, 256, (256, 3))
    y, x = np.mgrid[0:24, 0:40]
    return {
        "gif_rgb_interlaced.gif": _save(Image.fromarray(rgb), "GIF"),
        "gif_rgba_trns.gif": _save(Image.fromarray(rgba), "GIF"),
        "gif_gray.gif": _save(Image.fromarray(rgb).convert("L"), "GIF"),
        "gif_local_offset.gif": make_gif((x // 3 + y // 2) % 32, palette[:64], local=palette[64:96],
                                         screen=(64, 40), offset=(7, 5), trns=3),
        "gif_code2.gif": make_gif(rng.integers(0, 4, (30, 50)) * (rng.random((30, 50)) < 0.7),
                                  palette[:4], min_code=2, interlace=True),
        "gif_deferred_clear.gif": make_gif(rng.integers(0, 256, (96, 128)), palette, defer=True),
    }


def gif_digests(data: bytes) -> tuple[str, str]:
    """sha256 of a GIF file and of Pillow's ``convert("RGBA")`` of it."""
    from PIL import Image  # noqa: PLC0415

    pixels = np.ascontiguousarray(np.asarray(Image.open(io.BytesIO(data)).convert("RGBA")))
    return hashlib.sha256(data).hexdigest(), hashlib.sha256(pixels.tobytes()).hexdigest()


def digests(data: bytes) -> tuple[str, str]:
    """sha256 of a file and of Pillow's decode of it."""
    from PIL import Image  # noqa: PLC0415

    pixels = np.ascontiguousarray(np.asarray(Image.open(io.BytesIO(data))))
    return hashlib.sha256(data).hexdigest(), hashlib.sha256(pixels.tobytes()).hexdigest()


def webp_chunk(fourcc: bytes, payload: bytes) -> bytes:
    """A RIFF chunk: its padding byte after an odd payload."""
    return fourcc + struct.pack("<I", len(payload)) + payload + b"\0" * (len(payload) & 1)


def make_webp(*chunks: bytes, vp8x: tuple[int, int, int] | None = None) -> bytes:
    """A WebP file of ``chunks`` (see :func:`webp_chunk`), after a ``VP8X``
    chunk of (flags, width, height) where given."""
    if vp8x is not None:
        flags, w, h = vp8x
        chunks = (webp_chunk(b"VP8X", bytes([flags, 0, 0, 0])
                             + (w - 1).to_bytes(3, "little") + (h - 1).to_bytes(3, "little")),
                  *chunks)
    body = b"WEBP" + b"".join(chunks)
    return b"RIFF" + struct.pack("<I", len(body)) + body


def alpha_filter(alpha: np.ndarray, method: int) -> np.ndarray:
    """The deltas of libwebp's alpha filters (0 none, 1 horizontal, 2
    vertical, 3 gradient) that its unfilters turn back into ``alpha``."""
    a = alpha.astype(np.int32)
    pred = np.zeros_like(a)
    if method:
        pred[0, 1:] = a[0, :-1]                 # the first row: horizontal from 0
        pred[1:, 0] = a[:-1, 0]                 # the first column: the pixel above
        if method == 1:
            pred[1:, 1:] = a[1:, :-1]
        elif method == 2:
            pred[1:, 1:] = a[:-1, 1:]
        else:
            pred[1:, 1:] = np.clip(a[1:, :-1] + a[:-1, 1:] - a[:-1, :-1], 0, 255)
    return ((a - pred) & 255).astype(np.uint8)


def seeded_alpha(h: int, w: int, seed: int) -> np.ndarray:
    """A gradient alpha with seeded holes of 0 and spots of 255."""
    y, x = np.mgrid[0:h, 0:w]
    alpha = ((x * 255) // max(w - 1, 1) + (y * 64) // max(h, 1)) % 256
    r = np.random.default_rng(seed).random((h, w))
    return np.where(r < 0.1, 0, np.where(r > 0.9, 255, alpha)).astype(np.uint8)



def webp_fixtures() -> dict[str, bytes]:
    """Each WebP fixture's name and its bytes (Pillow's or
    :func:`make_webp`'s)."""
    from PIL import Image  # noqa: PLC0415

    import chip_smoke  # noqa: PLC0415

    rgb, big = levels((96, 128), 27), levels((333, 517), 18)
    rgba = np.dstack([rgb, seeded_alpha(96, 128, 27)])
    big_rgba = np.dstack([big, seeded_alpha(333, 517, 18)])
    vp8 = _save(Image.fromarray(rgb), "WEBP")[12:]
    raw = bytes([3 << 2]) + alpha_filter(rgba[..., 3], 3).tobytes()
    hand = make_webp(webp_chunk(b"ICCP", b"not a profile"), webp_chunk(b"ALPH", raw), vp8,
                     webp_chunk(b"EXIF", b"Exif\0\0II*\0"), webp_chunk(b"XMP ", b"<x/>"),
                     webp_chunk(b"ABCD", b"unknown"), vp8x=(0x10 | 0x20 | 0x08 | 0x04, 128, 96))
    palette = np.random.default_rng(27).integers(0, 256, (16, 3), dtype=np.uint8)
    anim = [Image.fromarray(np.roll(rgba, 9 * k, axis=1)) for k in range(2)]
    buf = io.BytesIO()
    anim[0].save(buf, format="WEBP", save_all=True, append_images=anim[1:], duration=80)
    mh, mw = chip_smoke.MH, chip_smoke.MW
    frames = chip_smoke.WEBP_FRAMES
    strip = levels((mh, mw + 4 * frames), 28, noise=0.02)
    return {
        "webp_lossy.webp": _save(Image.fromarray(rgb), "WEBP"),
        "webp_lossy_q100_m6.webp": _save(Image.fromarray(big), "WEBP", quality=100, method=6),
        "webp_lossy_alpha.webp": _save(Image.fromarray(big_rgba), "WEBP", alpha_quality=50),
        "webp_lossless.webp": _save(Image.fromarray(levels((333, 517), 18, noise=0.02)), "WEBP",
                                    lossless=True),
        "webp_lossless_alpha.webp": _save(Image.fromarray(rgba), "WEBP", lossless=True,
                                          exact=True),
        "webp_palette16.webp": _save(Image.fromarray(palette[(rgb[..., 0] // 16) % 16]), "WEBP",
                                     lossless=True),
        "webp_anim.webp": buf.getvalue(),
        "webp_hand_raw_alph.webp": hand,
        "codec_webp_4k.webp": _save(Image.fromarray(levels((chip_smoke.H, chip_smoke.W), 17,
                                                           noise=0.02)), "WEBP"),
        **{f"webp_motion{k:04d}.webp": _save(Image.fromarray(
            np.ascontiguousarray(strip[:, 4 * k:4 * k + mw])), "WEBP")
           for k in range(frames)},
    }


def webp_digests(data: bytes) -> tuple[str, str]:
    """sha256 of a WebP file and of the JAX package's ``read_image(...,
    "RGBA")`` float64 pixels of it."""
    import tempfile  # noqa: PLC0415

    from dspfun_tpu.io import images as jimages  # noqa: PLC0415

    with tempfile.NamedTemporaryFile(suffix=".webp") as f:
        f.write(data)
        f.flush()
        pixels = jimages.read_image(f.name, channels="RGBA").pixels
    return hashlib.sha256(data).hexdigest(), rgba_digest(pixels)


# ---- item 8h's formats: TGA, PCX, SGI written by hand (no Pillow) -----------


def tga_rle(px: np.ndarray) -> bytes:
    """TGA run-length packets of pixels [h, w, d] (the bytes of each pixel
    as stored), packets within a row: runs of two or more equal pixels as
    repeat packets, the rest as literal ones, each of at most 128 pixels.
    Vectorised over the whole image, so a 4K frame takes a fraction of a
    second."""
    h, w, d = px.shape
    flat = px.reshape(-1, d)
    n = h * w
    key = np.zeros(n, np.uint64)
    for i in range(d):
        key |= flat[:, i].astype(np.uint64) << np.uint64(8 * i)
    idx = np.arange(n)
    row_start = idx % w == 0
    new = row_start.copy()
    new[1:] |= key[1:] != key[:-1]
    run_id = np.cumsum(new) - 1
    starts = np.flatnonzero(new)
    rep = np.diff(np.append(starts, n))[run_id] >= 2
    lit_new = ~rep & (row_start | np.r_[True, rep[:-1]])
    lit_starts = np.flatnonzero(lit_new)
    lit_id = np.maximum(np.cumsum(lit_new) - 1, 0)
    pos = np.where(rep, idx - starts[run_id],
                   idx - (lit_starts[lit_id] if lit_starts.size else 0))
    seg = np.flatnonzero(pos % 128 == 0)
    seg_len = np.diff(np.append(seg, n))
    seg_rep = rep[seg]
    npx = np.where(seg_rep, 1, seg_len)
    size = 1 + npx * d
    off = np.cumsum(size) - size
    out = np.empty(int(size.sum()), np.uint8)
    out[off] = np.where(seg_rep, 0x80 | (seg_len - 1), seg_len - 1).astype(np.uint8)
    of = np.repeat(np.arange(len(seg)), npx)
    j = np.arange(int(npx.sum())) - (np.cumsum(npx) - npx)[of]
    dst = off[of] + 1 + j * d
    for b in range(d):
        out[dst + b] = flat[seg[of] + j, b]
    return out.tobytes()


def make_tga(img: np.ndarray, itype: int, depth: int, *, orient: int = 0, ident: bytes = b"",
             cmap: tuple | None = None, footer: bool = True) -> bytes:
    """A TGA of ``img``, [h, w, k] uint8 as it reads (``k`` the stored
    bytes of a pixel: indices, gray, gray + alpha, BGR(A), or the 2 bytes
    of a 16-bit pixel; a 1-bit image as 0/1 values), of image type
    ``itype`` (RLE where ``itype & 8``), stored in the ``orient`` (0x00,
    0x10, 0x20, 0x30) of its descriptor: rows bottom-up unless 0x20,
    columns right to left where 0x10.  ``cmap`` is (first index, map
    depth, the map's bytes)."""
    h, w = img.shape[:2]
    rows = img if orient & 0x20 else img[::-1]
    if orient & 0x10:
        rows = rows[:, ::-1]
    if depth == 1:
        rows = np.packbits(rows[..., 0].astype(np.uint8), axis=1)[..., None]
    first, mapdepth, table = cmap or (0, 0, b"")
    ncol = len(table) // max(mapdepth // 8, 1) if cmap else 0
    head = struct.pack("<BBBHHBHHHHBB", len(ident), 1 if cmap else 0, itype, first, ncol,
                       mapdepth, 0, 0, w, h, depth, orient | (8 if depth == 32 else 0))
    body = tga_rle(rows) if itype & 8 else np.ascontiguousarray(rows).tobytes()
    tail = b"\0" * 8 + b"TRUEVISION-XFILE.\0" if footer else b""
    return head + ident + table + body + tail


def pcx_rle(line: bytes) -> bytes:
    """One plane line in PCX's run-length code: runs of at most 63, a lone
    byte below 0xc0 as itself."""
    out, i = bytearray(), 0
    while i < len(line):
        j = i
        while j < len(line) and line[j] == line[i] and j - i < 63:
            j += 1
        if j - i == 1 and line[i] < 0xC0:
            out.append(line[i])
        else:
            out += bytes([0xC0 | (j - i), line[i]])
        i = j
    return bytes(out)


def make_pcx_planes(idx: np.ndarray, planes: int, palette: bytes, stride: int | None = None
                    ) -> bytes:
    """A 1-bit, ``planes``-plane PCX (2 or 4) of palette indices [h, w]
    with a 16-entry header palette; each plane line padded to ``stride``
    bytes (the even stride by default)."""
    h, w = idx.shape
    s = (w + 7) // 8
    stride = stride or s + s % 2
    head = (struct.pack("<BBBBHHHHHH", 10, 5, 1, 1, 0, 0, w - 1, h - 1, 72, 72)
            + palette[:48].ljust(48, b"\0") + b"\0"
            + struct.pack("<BHHHH", planes, stride, 1, w, h) + b"\0" * 54)
    body = bytearray()
    for r in range(h):
        line = b""
        for k in range(planes):
            bits = np.packbits(((idx[r] >> k) & 1).astype(np.uint8)).tobytes()
            line += bits.ljust(stride, b"\0")
        body += pcx_rle(line)
    return head + bytes(body)


def sgi_rle_row(values: np.ndarray, bpc: int) -> bytes:
    """One channel row in SGI's run-length code: runs of 3 or more equal
    samples as repeat packets, the rest copied, at most 127 a packet, a
    zero count last (every count and sample ``bpc`` bytes wide)."""
    out, i, n = bytearray(), 0, len(values)
    fmt = ">B" if bpc == 1 else ">H"
    while i < n:
        j = i
        while j < n and values[j] == values[i] and j - i < 127:
            j += 1
        if j - i >= 3:
            out += struct.pack(fmt, j - i) + struct.pack(fmt, int(values[i]))
            i = j
            continue
        j = i
        while j < n and j - i < 127 and not (j + 2 < n and values[j] == values[j + 1]
                                               == values[j + 2]):
            j += 1
        out += struct.pack(fmt, 0x80 | (j - i)) + b"".join(struct.pack(fmt, int(v))
                                                          for v in values[i:j])
        i = j
    return bytes(out + struct.pack(fmt, 0))


def make_sgi(img: np.ndarray, bpc: int = 1, rle: bool = True, name: bytes = b"") -> bytes:
    """An SGI of ``img`` [h, w, z] (uint8, or uint16 at ``bpc`` 2), rows
    bottom-up, RLE with its offset and length tables or verbatim."""
    h, w, z = img.shape
    dim = 3 if z > 1 else 2
    head = struct.pack(">hBBHHHHll4s79ssl404s", 474, 1 if rle else 0, bpc, dim, w, h, z, 0,
                       255 if bpc == 1 else 65535, b"", name, b"", 0, b"")
    planes = img[::-1].transpose(2, 0, 1)
    if not rle:
        return head + np.ascontiguousarray(planes, ">u2" if bpc == 2 else np.uint8).tobytes()
    rows = [[sgi_rle_row(planes[c, r], bpc) for r in range(h)] for c in range(z)]
    at = 512 + 8 * z * h
    starts, lengths, body = [], [], bytearray()
    for c in range(z):
        for r in range(h):
            starts.append(at + len(body))
            lengths.append(len(rows[c][r]))
            body += rows[c][r]
    return (head + struct.pack(f">{z * h}I", *starts) + struct.pack(f">{z * h}I", *lengths)
            + bytes(body))


def _other_levels(hw, seed) -> np.ndarray:
    """Seeded levels with flat stretches, so run-length codes have runs."""
    rgb = levels(hw, seed)
    rgb[:, : hw[1] // 4] = rgb[:, :1]
    rgb[hw[0] // 3: hw[0] // 2] = rgb[hw[0] // 3]
    return rgb


def other_fixtures() -> dict[str, bytes]:
    """The TGA, PCX, SGI, QOI, IM, ICO and DIB fixtures of phase 22: the
    kinds Pillow writes by Pillow, the others by the makers above."""
    from PIL import Image  # noqa: PLC0415

    rgb = _other_levels((48, 64), 41)
    alpha = seeded_alpha(48, 64, 41)
    rgba = np.dstack([rgb, alpha])
    gray = rgb[..., 1]
    odd = _other_levels((37, 45), 42)
    idx16 = (rgb[..., 0] // 16) % 16
    pal = np.random.default_rng(41).integers(0, 256, (256, 3), dtype=np.uint8)
    v16 = (rgb[..., :1].astype(np.uint16) << 7) | 0x8000 * (alpha[..., None] < 128)
    px16 = np.dstack([(v16 & 255).astype(np.uint8), (v16 >> 8).astype(np.uint8)])
    p_img = Image.fromarray(idx16.astype(np.uint8), "P")
    p_img.putpalette(pal[:16].tobytes())
    bmp_ico = _save(Image.fromarray(rgba), "ICO", sizes=[(32, 32), (48, 48)],
                    bitmap_format="bmp")
    p8_ico = _save(p_img.resize((32, 32)), "ICO", sizes=[(32, 32)], bitmap_format="bmp")
    return {
        "tga_rgb.tga": _save(Image.fromarray(rgb), "TGA"),
        "tga_rgba_rle_top.tga": make_tga(rgba[..., [2, 1, 0, 3]], 10, 32, orient=0x20),
        "tga_rgb_rle_flip.tga": make_tga(rgb[..., ::-1], 10, 24, orient=0x10),
        "tga_rgb_top_right.tga": make_tga(odd[..., ::-1], 2, 24, orient=0x30,
                                          ident=b"dspfun fixture"),
        "tga_16bit.tga": make_tga(px16, 2, 16),
        "tga_cmap_rle.tga": make_tga(idx16[..., None].astype(np.uint8) + 5, 9, 8,
                                     cmap=(5, 24, pal[:16, ::-1].tobytes()), ident=b"id"),
        "tga_cmap16.tga": make_tga(idx16[..., None].astype(np.uint8), 1, 8,
                                   cmap=(0, 16, px16[0, :16].tobytes())),
        "tga_gray_rle.tga": make_tga(gray[..., None], 11, 8, orient=0x20),
        "tga_la.tga": make_tga(np.dstack([gray, alpha]), 3, 16),
        "tga_1bit.tga": make_tga((gray[..., None] > 128).astype(np.uint8), 3, 1),
        "pcx_rgb.pcx": _save(Image.fromarray(odd), "PCX"),
        "pcx_l.pcx": _save(Image.fromarray(gray), "PCX"),
        "pcx_p.pcx": _save(p_img, "PCX"),
        "pcx_1bit.pcx": _save(Image.fromarray(gray > 128), "PCX"),
        "pcx_4plane.pcx": make_pcx_planes(idx16, 4, pal[:16].tobytes()),
        "pcx_2plane.pcx": make_pcx_planes(idx16 % 4, 2, pal[:16].tobytes()),
        "sgi_rgb.sgi": _save(Image.fromarray(rgb), "SGI"),
        "sgi_rgba.sgi": _save(Image.fromarray(rgba), "SGI"),
        "sgi_l_bpc2.sgi": _save(Image.fromarray(gray), "SGI", bpc=2),
        "sgi_rle_rgb.sgi": make_sgi(odd),
        "sgi_rle_rgba_bpc2.sgi": make_sgi(rgba.astype(np.uint16) * 257 + 3, bpc=2),
        "qoi_rgb.qoi": _save(Image.fromarray(rgb), "QOI"),
        "qoi_rgba.qoi": _save(Image.fromarray(rgba), "QOI"),
        "im_rgb.im": _save(Image.fromarray(rgb), "IM"),
        "im_l.im": _save(Image.fromarray(gray), "IM"),
        "im_l16.im": _save(Image.fromarray(gray.astype(np.uint16) * 257), "IM"),
        "im_lut.im": _save(p_img, "IM"),
        "ico_png.ico": _save(Image.fromarray(rgba), "ICO"),
        "ico_bmp32.ico": bmp_ico,
        "ico_bmp8.ico": p8_ico,
        "dib_rgb.dib": _save(Image.fromarray(odd), "DIB"),
        "dib_p8.dib": _save(p_img, "DIB"),
    }


def other_digests(data: bytes) -> tuple[str, str]:
    """sha256 of a file and of the JAX package's ``read_image(...,
    "RGBA")`` float64 pixels of it."""
    import tempfile  # noqa: PLC0415

    from dspfun_tpu.io import images as jimages  # noqa: PLC0415

    with tempfile.NamedTemporaryFile(suffix=".bin") as f:
        f.write(data)
        f.flush()
        pixels = jimages.read_image(f.name, channels="RGBA").pixels
    return hashlib.sha256(data).hexdigest(), rgba_digest(pixels)


# ---- lossless JPEG (SOF3), which Pillow reads but does not write ----------------

# a DC table of every category 0..16 (the standard luminance table's
# lengths for 0..11, then 10..14 bits; no code of all ones)
LOSSLESS_DC = (bytes([0, 1, 5, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0]), bytes(range(17)))


def _jseg(code: int, body: bytes) -> bytes:
    return bytes([0xFF, code]) + struct.pack(">H", len(body) + 2) + body


def _huffman_codes(table) -> tuple[np.ndarray, np.ndarray]:
    """(code, length) of each value of a Huffman table (counts, values)."""
    codes, lengths = np.zeros(256, np.int64), np.zeros(256, np.int64)
    code, k = 0, 0
    for length, n in enumerate(table[0], 1):
        for _ in range(n):
            codes[table[1][k]], lengths[table[1][k]] = code, length
            code, k = code + 1, k + 1
        code <<= 1
    return codes, lengths


def _pack_codes(values: np.ndarray, lengths: np.ndarray) -> bytes:
    """Codes of up to 32 bits each, most significant bit first, packed
    without a loop over them; the last byte padded with 1 bits, 0xFF
    stuffed with 0x00."""
    ends = np.cumsum(lengths)
    nbits = int(ends[-1]) if len(ends) else 0
    starts = ends - lengths
    word, off = starts // 32, starts % 32
    first = np.minimum(lengths, 32 - off)                # bits in the first word
    rest = lengths - first
    hi = (values >> rest) << (32 - off - first)
    lo = (values & ((1 << rest) - 1)) << (32 - rest)
    nw = nbits // 32 + 2
    # the codes' bits do not overlap, so a sum per word is their OR (exact in float64)
    words = np.bincount(word, weights=hi, minlength=nw) \
        + np.bincount(word + 1, weights=np.where(rest > 0, lo, 0), minlength=nw)
    out = words.astype(np.uint64).astype(">u4").view(np.uint8)[:(nbits + 7) // 8].copy()
    if nbits % 8:
        out[-1] |= (1 << (8 - nbits % 8)) - 1
    ff = np.flatnonzero(out == 0xFF)
    return np.insert(out, ff + 1, 0).tobytes()


def _lossless_diffs(plane: np.ndarray, predictor: int, pt: int, first_rows,
                    precision: int = 8) -> np.ndarray:
    """The differences jclossls.c codes for one component's samples (at
    their own size): the samples >> pt, each less its prediction (T.81
    H.1.2.1: Ra in a row that starts a restart interval, the first sample
    of that row 2^(P - Pt - 1); Rb in the first column; the scan's
    predictor elsewhere), modulo 2^16 as -32767..32768."""
    x = plane.astype(np.int64) >> pt
    ra = np.zeros_like(x)
    ra[:, 1:] = x[:, :-1]
    rb = np.zeros_like(x)
    rb[1:] = x[:-1]
    rc = np.zeros_like(x)
    rc[1:, 1:] = x[:-1, :-1]
    pred = {1: ra, 2: rb, 3: rc, 4: ra + rb - rc, 5: ra + ((rb - rc) >> 1),
            6: rb + ((ra - rc) >> 1), 7: (ra + rb) >> 1}[predictor].copy()
    pred[:, 0] = rb[:, 0]
    first = np.zeros(len(x), bool)
    first[list(first_rows)] = True
    pred[first, 1:] = ra[first, 1:]
    pred[first, 0] = 1 << ((12 if precision == 12 else 8) - pt - 1)
    d = (x - pred) & 0xFFFF
    return np.where(d > 32768, d - 65536, d)


def make_lossless_jpeg(samples: np.ndarray, predictor: int = 1, pt: int = 0, restart: int = 0,
                       sampling=None, ids=None, scans=None, app: bytes = b"",
                       precision: int = 8, diffs=None) -> bytes:
    """A Huffman lossless JPEG (SOF3) of uint8 samples [H, W, C], C in 1..4,
    as libjpeg-turbo's jclossls.c writes one, with no loop over samples:
    ``sampling`` [(h, v)] per component (each component the samples of its
    own grid, taken from the full-size plane), component ``ids`` (default
    1, 2, ...), ``scans`` (tuples of component indices; default one
    interleaved scan), a restart marker every ``restart`` MCUs (libjpeg
    needs a multiple of the MCUs in a row), ``app`` segments after SOI;
    every component codes with :data:`LOSSLESS_DC`.  ``precision`` 12
    takes uint16 samples below 4096 (the first prediction 2^(P - Pt - 1));
    any other is only written into the frame header; ``diffs`` (per component, the
    differences at its own size) are coded in place of the samples' (a
    crafted stream: 32768 is category 16)."""
    a = np.asarray(samples, np.uint16 if precision == 12 else np.uint8)
    a = a[..., None] if a.ndim == 2 else a
    h, w, nc = a.shape
    sampling = sampling or [(1, 1)] * nc
    ids = ids or list(range(1, nc + 1))
    scans = scans or [tuple(range(nc))]
    hmax, vmax = max(s[0] for s in sampling), max(s[1] for s in sampling)
    planes = []
    for c, (ch, cv) in enumerate(sampling):
        bw, bh = -(-w * ch // hmax), -(-h * cv // vmax)
        planes.append(a[::vmax // cv, ::hmax // ch, c][:bh, :bw])
    codes, lengths = _huffman_codes(LOSSLESS_DC)
    out = b"\xff\xd8" + app
    out += _jseg(0xC3, struct.pack(">BHHB", precision, h, w, nc)
                 + b"".join(bytes([ids[c], 16 * ch + cv, 0]) for c, (ch, cv) in enumerate(sampling)))
    out += _jseg(0xC4, b"\x00" + LOSSLESS_DC[0] + LOSSLESS_DC[1])
    if restart:
        out += _jseg(0xDD, struct.pack(">H", restart))
    for members in scans:
        single = len(members) == 1
        mx = -(-w // hmax) if not single else planes[members[0]].shape[1]
        my = -(-h // vmax) if not single else planes[members[0]].shape[0]
        rpi = restart // mx if restart else 0            # MCU rows in a restart interval
        units = []
        for c in members:
            ch, cv = (1, 1) if single else sampling[c]
            v = sampling[c][1]
            starts = [r for r in range(my) if r == 0 or rpi and r % rpi == 0]
            # libjpeg undifferences an iMCU row after decoding it: a restart
            # in it makes its first row of each component a first row
            first = sorted({r * cv for r in starts} if not single
                           else {r // v * v for r in starts})
            d = _lossless_diffs(planes[c], predictor, pt, first, precision) if diffs is None \
                else np.asarray(diffs[c], np.int64)
            full = np.zeros((my * cv, mx * ch), np.int64)
            full[:d.shape[0], :d.shape[1]] = d
            units.append(full.reshape(my, cv, mx, ch).transpose(0, 2, 1, 3).reshape(my, mx, -1))
        coded = np.concatenate(units, -1).reshape(my * mx, -1)
        mag = np.abs(coded)
        cat = np.where(coded == 32768, 16, np.ceil(np.log2(mag + 1)).astype(np.int64))
        extra = np.where(coded >= 0, coded, coded - 1) & ((1 << cat) - 1)
        extra = np.where(cat == 16, 0, extra)
        nextra = np.where(cat == 16, 0, cat)
        vals = (codes[cat] << nextra) | extra
        lens = lengths[cat] + nextra
        step = restart or my * mx
        out += _jseg(0xDA, bytes([len(members)]) + b"".join(bytes([ids[c], 0]) for c in members)
                     + bytes([predictor, 0, pt]))
        for k, at in enumerate(range(0, my * mx, step)):
            if k:
                out += bytes([0xFF, 0xD0 + (k - 1) % 8])
            out += _pack_codes(vals[at:at + step].ravel(), lens[at:at + step].ravel())
    return out + b"\xff\xd9"


def jpeg_scans(data: bytes) -> tuple[bytes, list[tuple[bytes, bytes]]]:
    """A JPEG cut at its scans: the bytes before the first scan's tables
    (SOI to the frame header) and, for each scan, its SOS body and its
    bytes (the tables and markers since the previous scan's data, the SOS
    and the entropy-coded data, restart markers included)."""
    pos, head_end, frame, units, start = 2, None, False, [], None
    while True:
        while data[pos + 1] == 0xFF:                  # fill bytes
            pos += 1
        code = data[pos + 1]
        if code == 0xD9:
            return data[:head_end], units
        n = struct.unpack_from(">H", data, pos + 2)[0]
        if frame and head_end is None:
            head_end = start = pos
        frame |= 0xC0 <= code <= 0xC3 or code in (0xC9, 0xCA)
        pos += 2 + n
        if code == 0xDA:
            body = data[pos - n + 2:pos]
            while True:                               # the data runs to a marker but RSTn
                pos = data.index(b"\xff", pos)
                if data[pos + 1] != 0 and not 0xD0 <= data[pos + 1] <= 0xD7:
                    break
                pos += 2
            units.append((body, data[start:pos]))
            start = pos


def cut_scans(data: bytes, keep) -> bytes:
    """The JPEG with only the scans ``keep`` (a predicate of a scan's
    index and its (Ss, Se, Ah, Al)) followed by EOI."""
    head, units = jpeg_scans(data)
    out = [head]
    for k, (body, unit) in enumerate(units):
        ss, se, ahl = body[-3:]
        if keep(k, (ss, se, ahl >> 4, ahl & 15)):
            out.append(unit)
    return b"".join(out) + b"\xff\xd9"


def short_jpegs() -> dict[str, bytes]:
    """Progressive JPEGs whose scans leave coefficients short, cut from
    Pillow's goldens (no Pillow needed): the 3840x2160 file's DC scans
    alone and all its scans but the last (luma's last refinement, so its
    AC band stays at Al 1); the gray file without its last scan; the
    4:4:4 restart-marked file with its first scan alone (the DC at Al 1)
    and without its AC refinements (every AC band at Al > 0)."""
    prog4k = (GOLDENS / "codec_prog_4k.jpg").read_bytes()
    gray = (GOLDENS / "codec_prog_gray.jpg").read_bytes()
    rst = (GOLDENS / "codec_prog_444_rst.jpg").read_bytes()
    n4k, ngray = len(jpeg_scans(prog4k)[1]), len(jpeg_scans(gray)[1])
    return {
        "prog4k_dc.jpg": cut_scans(prog4k, lambda k, s: s[0] == 0),
        "prog4k_short.jpg": cut_scans(prog4k, lambda k, s: k < n4k - 1),
        "gray_short.jpg": cut_scans(gray, lambda k, s: k < ngray - 1),
        "rst444_dc_al1.jpg": cut_scans(rst, lambda k, s: k == 0),
        "rst444_unrefined.jpg": cut_scans(rst, lambda k, s: s[0] == 0 or s[2] == 0),
    }


# name -> (levels (hw, seed), make_lossless_jpeg's arguments)
LOSSLESS_FIXTURES = {
    "ll_gray_p1.jpg": (((77, 123), 51), dict(predictor=1)),
    "ll_gray_p2_pt2.jpg": (((77, 123), 52), dict(predictor=2, pt=2)),
    "ll_rgb_p3.jpg": (((64, 96), 53), dict(predictor=3)),
    "ll_rgb_p4_pt1_rst.jpg": (((64, 96), 54), dict(predictor=4, pt=1, restart=96 * 8)),
    "ll_rgb_p5_scans.jpg": (((45, 70), 55), dict(predictor=5, scans=[(0,), (2,), (1,)],
                                                 restart=70 * 5)),
    "ll_rgb_p6_420.jpg": (((45, 71), 56), dict(predictor=6, sampling=[(2, 2), (1, 1), (1, 1)])),
    "ll_cmyk_p7_rst.jpg": (((50, 60), 57), dict(predictor=7, restart=60 * 3)),
}


def lossless_jpegs() -> dict[str, bytes]:
    """The lossless JPEGs of :data:`LOSSLESS_FIXTURES`, written by
    :func:`make_lossless_jpeg` from seeded levels (gray: their first
    channel; CMYK: :func:`cmyk_levels` of them)."""
    out = {}
    for name, ((hw, seed), kw) in LOSSLESS_FIXTURES.items():
        rgb = levels(hw, seed)
        samples = rgb[..., :1] if "gray" in name else cmyk_levels(rgb) if "cmyk" in name else rgb
        out[name] = make_lossless_jpeg(samples, **kw)
    return out


def rgb_digest(pixels: np.ndarray) -> str:
    """sha256 of uint8 [H, W, C] samples as RGB (gray repeated)."""
    a = np.asarray(pixels, np.uint8)
    a = a.reshape(a.shape[0], a.shape[1], -1)
    return hashlib.sha256(np.ascontiguousarray(np.repeat(a, 3 // a.shape[2], 2)).tobytes()) \
        .hexdigest()


def jpeg_digests(data: bytes) -> tuple[str, str]:
    """sha256 of a JPEG file and of Pillow's ``convert("RGB")`` of it."""
    from PIL import Image  # noqa: PLC0415

    return hashlib.sha256(data).hexdigest(), \
        rgb_digest(np.asarray(Image.open(io.BytesIO(data)).convert("RGB")))


def rates(repeats: int = 5) -> None:
    """The port's decode of Pillow's 3840x2160 LZW (predictor 1 and 2),
    deflate and PackBits TIFFs of ``codec_prog_4k.jpg``'s levels, timed on
    this host (the best of ``repeats``), beside Pillow's (libtiff) decode
    of the same files: the LZW rate no chip run measures, since the card's
    machine has no Pillow to write a 4K LZW file."""
    import time

    from PIL import Image  # noqa: PLC0415

    import chip_smoke  # noqa: PLC0415
    from dspfun_tpu_torch.io import imgcodecs

    img = Image.fromarray(levels((chip_smoke.H, chip_smoke.W), 17, noise=0.02))
    mb = img.width * img.height * 3 / 1e6
    for comp, kw in (("tiff_lzw", {}), ("tiff_lzw", {"tiffinfo": {317: 2}}),
                     ("tiff_adobe_deflate", {}), ("packbits", {})):
        data = _save(img, "TIFF", compression=comp, **kw)
        for who, fn in (("port", lambda d=data: imgcodecs.decode_tiff(d)),
                        ("Pillow", lambda d=data: np.asarray(Image.open(io.BytesIO(d))))):
            best = float("inf")
            for _ in range(repeats):
                t0 = time.perf_counter()
                fn()
                best = min(best, time.perf_counter() - t0)
            print(f"{comp} {kw.get('tiffinfo', {}).get(317, 1)} {len(data)} bytes: {who} "
                  f"{best:.4f} s, {mb / best:.1f} MB/s of RGB")


def main(argv=None) -> None:
    if "--rates" in (sys.argv[1:] if argv is None else argv):
        rates()
        return
    for made, digest in ((fixtures(), digests), (gif_fixtures(), gif_digests),
                         (cmyk_fixtures(), cmyk_digests), (tiff_jpeg_goldens(), digests),
                         (webp_fixtures(), webp_digests), (other_fixtures(), other_digests),
                         (psd_dds_goldens(), other_digests), (j2k_goldens(), other_digests),
                         (_arith_goldens(), arith_digests),
                         (j2k_more_goldens(), _j2k_more_digests)):
        for name, data in made.items():
            (GOLDENS / name).write_bytes(data)
            print(f"    {name!r}: {digest(data)},  # {len(data)} bytes")


def _j2k_more_digests(data: bytes) -> tuple[str, str]:
    """``chip_smoke.J2K_MORE_FIXTURES``' digests of a phase 29 golden: of
    Pillow's RGB decode for a 4K one, of the JAX package's RGBA read for
    the others."""
    at = data.index(b"\xff\x4f\xff\x51") + 8
    xsiz, ysiz, xo, yo = struct.unpack_from(">IIII", data, at)
    return (j2k_4k_digest if (xsiz - xo) * (ysiz - yo) >= 3840 * 2160 else other_digests)(data)


def _arith_goldens() -> dict[str, bytes]:
    """:func:`arith_goldens` with a writer built for the call."""
    import tempfile  # noqa: PLC0415

    with tempfile.TemporaryDirectory(prefix="arith_writer_") as tmp:
        return arith_goldens(build_arith_writer(tmp))


# ---- PSD and CUR, written by hand (Pillow writes neither) ----------------------

_RUN3 = re.compile(rb"(.)\1{2,127}", re.S)


def packbits_row(row: bytes) -> bytes:
    """One row in PackBits, fast enough for 4K rows: each run of 3 to 128
    equal bytes (found by a regular expression) a repeat, the bytes
    between them literals of at most 128."""
    out, at = bytearray(), 0

    def literal(lit: bytes) -> None:
        for k in range(0, len(lit), 128):
            out.extend(bytes([len(lit[k:k + 128]) - 1]) + lit[k:k + 128])

    for m in _RUN3.finditer(row):
        literal(row[at:m.start()])
        out.extend(bytes([257 - (m.end() - m.start()), row[m.start()]]))
        at = m.end()
    literal(row[at:])
    return bytes(out)


def psd_resource(rid: int, name: bytes, data: bytes) -> bytes:
    """An image resource block: ``8BIM``, its id, a Pascal name padded to
    even length, and its data padded to even length."""
    pname = bytes([len(name)]) + name
    pname += b"\0" * (len(pname) % 2)
    return b"8BIM" + struct.pack(">H", rid) + pname + struct.pack(">I", len(data)) + data \
        + b"\0" * (len(data) % 2)


def make_psd(planes, mode: int, bits: int = 8, compression: int = 0, *, width: int | None = None,
             color_data: bytes = b"", resources: bytes = b"", layers: bytes | None = None,
             channels: int | None = None, body: bytes | None = None) -> bytes:
    """A Photoshop file of ``planes`` (uint8 [C, H, rowbytes]: the rows of
    each channel as stored, bits already packed for a 1-bit file): the
    header (``channels`` defaults to C), the colour mode data, the image
    resources, a layer section (``layers``: its content after the length;
    None for an empty section) and the composite image, raw (0) or
    PackBits (1: the table of each row's byte count, then the rows coded
    one by one); any other ``compression`` stores ``body`` (or nothing)
    after its number."""
    planes = np.asarray(planes, np.uint8)
    c, h, rb = planes.shape
    w = rb if width is None else width
    head = b"8BPS" + struct.pack(">H6sHIIHH", 1, b"", channels or c, h, w, bits, mode)
    out = head + struct.pack(">I", len(color_data)) + color_data
    out += struct.pack(">I", len(resources)) + resources
    if layers is None:
        out += struct.pack(">I", 0)
    else:
        out += struct.pack(">I", len(layers)) + layers
    out += struct.pack(">H", compression)
    if compression == 0:
        return out + planes.tobytes()
    if compression != 1:
        return out + (body or b"")
    rows = [packbits_row(planes[k, y].tobytes()) for k in range(c) for y in range(h)]
    return out + struct.pack(f">{len(rows)}H", *map(len, rows)) + b"".join(rows)


def psd_layers(seed: int, n: int = 2) -> bytes:
    """A layer section Pillow's open skips (its length is all it reads):
    the layer info length, a count and seeded records it never parses."""
    rng = np.random.default_rng(seed)
    info = struct.pack(">h", n) + rng.integers(0, 256, 40 * n, dtype=np.uint8).tobytes()
    return struct.pack(">I", len(info)) + info + struct.pack(">I", 0)


def make_cur(entries) -> bytes:
    """A cursor file: the directory of ``entries`` (width byte, height
    byte, DIB bytes or an int offset to point at instead), then the
    DIBs in order."""
    head = struct.pack("<HHH", 0, 2, len(entries))
    at = len(head) + 16 * len(entries)
    dirs, body = b"", b""
    for w, h, dib in entries:
        if isinstance(dib, int):
            dirs += struct.pack("<BBBBHHII", w, h, 0, 0, 1, 1, 0, dib)
            continue
        dirs += struct.pack("<BBBBHHII", w, h, 0, 0, 1, 1, len(dib), at + len(body))
        body += dib
    return head + dirs + body


def cursor_dib(img: np.ndarray, bits: int, palette: np.ndarray | None = None,
               mask_seed: int = 0) -> bytes:
    """A cursor's DIB: a 40-byte header of twice the height, the palette
    (``bits`` <= 8: ``img`` holds indices), the bottom-up rows of ``img``
    (BGR(A) for 24 and 32 bits) and a seeded AND mask."""
    h, w = img.shape[:2]
    ncol = 0 if bits > 8 else len(palette)
    head = struct.pack("<IiiHHIIiiII", 40, w, 2 * h, 1, bits, 0, 0, 2835, 2835, ncol, 0)
    pal = b"" if bits > 8 else np.hstack([palette[:, ::-1], np.zeros((ncol, 1), np.uint8)]) \
        .astype(np.uint8).tobytes()
    stride = ((w * bits + 31) >> 3) & ~3
    if bits <= 8:
        v = np.packbits(np.unpackbits(img.astype(np.uint8)[..., None], axis=-1)[..., 8 - bits:]
                        .reshape(h, w * bits), axis=1)
    else:
        v = img[..., [2, 1, 0, 3][:bits // 8]].reshape(h, -1)
    rows = np.zeros((h, stride), np.uint8)
    rows[:, :v.shape[1]] = v
    mstride = ((w + 31) >> 3) & ~3
    mask = np.random.default_rng(mask_seed).integers(0, 256, (h, mstride), dtype=np.uint8)
    return head + pal + rows[::-1].tobytes() + mask.tobytes()


def make_im(kind: str, w: int, h: int, body: bytes) -> bytes:
    """An IM file: ``Image type: <kind> image`` and the size in a 512-byte
    header, then ``body`` (bottom-up rows, as IM stores them)."""
    head = f"Image type: {kind} image\r\nImage size (x*y): {w}*{h}\r\n".encode("ascii")
    return head + b"\0" * (511 - len(head)) + b"\x1a" + body


def dds_file(w: int, h: int, body: bytes, pfflags: int, fourcc: bytes = bytes(4),
             bitcount: int = 0, masks=(0, 0, 0, 0), dxgi: int | None = None,
             mipmaps: int = 0, palette: bytes = b"") -> bytes:
    """A DDS file: the 124-byte header with the pixel format given, the
    DX10 header where ``dxgi`` is set (four-CC ``DX10``), a palette, then
    ``body`` (the top surface, and whatever follows it)."""
    if dxgi is not None:
        fourcc = b"DX10"
    head = b"DDS " + struct.pack("<7I", 124, 0x1007 | (0x20000 if mipmaps else 0), h, w, 0, 0,
                                 mipmaps) + bytes(44)
    head += struct.pack("<2I4sI4I", 32, pfflags, fourcc, bitcount, *masks)
    head += struct.pack("<5I", 0x1000 | (0x400008 if mipmaps else 0), 0, 0, 0, 0)
    if dxgi is not None:
        head += struct.pack("<5I", dxgi, 3, 0, 1, 0)
    return head + palette + body


def bc_blocks(w: int, h: int, block_bytes: int, seed: int) -> bytes:
    """Seeded random blocks for a w x h surface (any 16 bytes are a valid
    block of each BC format)."""
    n = ((w + 3) // 4) * ((h + 3) // 4)
    return np.random.default_rng(seed).integers(0, 256, n * block_bytes, dtype=np.uint8).tobytes()


def _packed(px: np.ndarray, masks, nbytes: int) -> bytes:
    """uint8 channel values [H, W, C] placed in ``masks``' bits (each value
    scaled to its mask's width), little-endian pixels of ``nbytes``."""
    v = np.zeros(px.shape[:2], np.uint64)
    for i, mask in enumerate(masks):
        if mask:
            shift = (mask & -mask).bit_length() - 1
            top = mask >> shift
            v |= ((px[..., i].astype(np.uint64) * top // 255) << np.uint64(shift)) & np.uint64(mask)
    return np.ascontiguousarray(v.astype(f"<u{8 if nbytes > 4 else 4}")
                                .view(np.uint8).reshape(*px.shape[:2], -1)[..., :nbytes]).tobytes()


# the fixtures Pillow writes (remade by psd_dds_goldens(), kept in tests/goldens/)
PSD_DDS_GOLDENS = ("dds_rgb.dds", "dds_rgba.dds", "dds_l.dds", "dds_la.dds", "dds_dxt1.dds",
                   "dds_dxt3.dds", "dds_dxt5.dds", "dds_bc2.dds", "dds_bc3.dds", "dds_bc5.dds",
                   "dcx_rgb_l.dcx", "dcx_p.dcx")


def _slice_levels(hw, seed) -> np.ndarray:
    rgb = levels(hw, seed)
    rgb[:, : hw[1] // 3] = rgb[:, :1]
    return rgb


def psd_dds_goldens() -> dict[str, bytes]:
    """Pillow's DDS files of 45x37 levels (seed 51): uncompressed RGB,
    RGBA, L and LA and each ``pixel_format`` it writes, and DCX files of
    Pillow's PCX pages behind a directory (the first page is the one
    read)."""
    from PIL import Image  # noqa: PLC0415

    rgb = _slice_levels((37, 45), 51)
    rgba = np.dstack([rgb, seeded_alpha(37, 45, 51)])
    img, img_a = Image.fromarray(rgb), Image.fromarray(rgba)
    out = {"dds_rgb.dds": _save(img, "DDS"), "dds_rgba.dds": _save(img_a, "DDS"),
           "dds_l.dds": _save(img.convert("L"), "DDS"),
           "dds_la.dds": _save(img_a.convert("LA"), "DDS")}
    for pf in ("DXT1", "DXT3", "DXT5", "BC2", "BC3"):
        out[f"dds_{pf.lower()}.dds"] = _save(img_a, "DDS", pixel_format=pf)
    out["dds_bc5.dds"] = _save(img, "DDS", pixel_format="BC5")
    p_img = img.convert("P", palette=Image.Palette.ADAPTIVE, colors=16)

    def dcx(pages) -> bytes:
        at = 4 + 4 * (len(pages) + 1)
        offsets = []
        for page in pages:
            offsets.append(at)
            at += len(page)
        return struct.pack(f"<I{len(pages) + 1}I", 0x3ADE68B1, *offsets, 0) + b"".join(pages)

    out["dcx_rgb_l.dcx"] = dcx([_save(img, "PCX"), _save(img.convert("L"), "PCX")])
    out["dcx_p.dcx"] = dcx([_save(p_img, "PCX")])
    return out


def psd_fixtures() -> dict[str, bytes]:
    """PSD files written by :func:`make_psd` (seed 52): each mode of
    Pillow's ``MODES``, raw and PackBits, odd sizes, resources and a layer
    section, and more channels than the mode's."""
    rgb = _slice_levels((37, 45), 52)
    alpha = seeded_alpha(37, 45, 52)
    gray = rgb[..., 1]
    chans = rgb.transpose(2, 0, 1)
    pal = np.random.default_rng(52).integers(0, 256, 768, dtype=np.uint8).tobytes()
    res = psd_resource(1005, b"res", b"x" * 16) + psd_resource(1039, b"", b"icc data!")
    bits = np.packbits(gray > 128, axis=1)[None]
    cmyk = np.stack([255 - rgb[..., 0], 255 - rgb[..., 1], 255 - rgb[..., 2], gray // 2])
    lab = np.stack([gray, rgb[..., 0] // 2 + 64, rgb[..., 2] // 2 + 64])
    return {
        "psd_rgb_raw.psd": make_psd(chans, 3, resources=res, layers=psd_layers(52)),
        "psd_rgb_packbits.psd": make_psd(chans, 3, compression=1, resources=res),
        "psd_rgba_packbits.psd": make_psd(np.concatenate([chans, alpha[None]]), 3, compression=1,
                                          layers=psd_layers(53)),
        "psd_rgb_extra_raw.psd": make_psd(np.concatenate([chans, alpha[None], gray[None]]), 3),
        "psd_cmyk_packbits.psd": make_psd(cmyk, 4, compression=1),
        "psd_lab_raw.psd": make_psd(lab, 9, resources=res),
        "psd_gray_packbits.psd": make_psd(gray[None], 1, compression=1),
        "psd_indexed_raw.psd": make_psd((gray // 7)[None], 2, color_data=pal),
        "psd_bitmap_packbits.psd": make_psd(bits, 0, bits=1, compression=1, width=45),
        "psd_duotone_raw.psd": make_psd(gray[None], 8, color_data=b"duotone spec"),
        "psd_multichannel_packbits.psd": make_psd(chans, 7, compression=1),
    }


def cur_fixtures() -> dict[str, bytes]:
    """Cursor files written by :func:`make_cur` and :func:`cursor_dib`
    (seed 53): 1, 4, 8, 24 and 32 bits, odd sizes, and several entries
    whose largest is not the first."""
    rgb = _slice_levels((19, 21), 53)
    rgba = np.dstack([rgb, seeded_alpha(19, 21, 53)])
    pal = np.random.default_rng(53).integers(0, 256, (256, 3), dtype=np.uint8)
    idx = rgb[..., 0]
    small = _slice_levels((8, 8), 54)
    return {
        "cur_1bit.cur": make_cur([(21, 19, cursor_dib(idx % 2, 1, pal[:2], 1))]),
        "cur_4bit.cur": make_cur([(21, 19, cursor_dib(idx % 16, 4, pal[:16], 2))]),
        "cur_8bit.cur": make_cur([(21, 19, cursor_dib(idx, 8, pal, 3))]),
        "cur_24bit.cur": make_cur([(21, 19, cursor_dib(rgb, 24, mask_seed=4))]),
        "cur_32bit.cur": make_cur([(21, 19, cursor_dib(rgba, 32, mask_seed=5))]),
        "cur_entries.cur": make_cur([(8, 8, cursor_dib(small, 24, mask_seed=6)),
                                     (21, 19, cursor_dib(rgb, 24, mask_seed=7)),
                                     (21, 30, cursor_dib(rgb[:8], 24, mask_seed=8))]),
    }


def dds_made() -> dict[str, bytes]:
    """DDS files written by :func:`dds_file` (seed 54): bit masks of 16,
    24 and 32 bits, the 8-bit palette, BC4, BC5 signed, ATI1 and ATI2, and
    DX10 headers (R8G8B8A8, BC1, BC6H unsigned and signed, BC7 and its
    sRGB form), surfaces of 45x37 with a mipmap after one of them."""
    w, h = 45, 37
    rgb = _slice_levels((h, w), 54)
    rgba = np.dstack([rgb, seeded_alpha(h, w, 54)])
    pal = np.random.default_rng(54).integers(0, 256, 1024, dtype=np.uint8).tobytes()
    m565, m4444 = (0xF800, 0x7E0, 0x1F), (0xF00, 0xF0, 0xF, 0xF000)
    m10 = (0x3FF, 0xFFC00, 0x3FF00000, 0xC0000000)
    fourcc = lambda cc, nbytes, seed: dds_file(  # noqa: E731
        w, h, bc_blocks(w, h, nbytes, seed), 0x4, fourcc=cc)
    dx10 = lambda fmt, seed, **kw: dds_file(  # noqa: E731
        w, h, bc_blocks(w, h, 8 if fmt in (71,) else 16, seed), 0x4, dxgi=fmt, **kw)
    return {
        "dds_rgb565.dds": dds_file(w, h, _packed(rgb, m565, 2), 0x40, bitcount=16,
                                   masks=m565 + (0,)),
        "dds_argb4444.dds": dds_file(w, h, _packed(rgba, m4444, 2), 0x41, bitcount=16,
                                     masks=m4444),
        "dds_rgb24_bgr.dds": dds_file(w, h, _packed(rgb, (0xFF0000, 0xFF00, 0xFF), 3), 0x40,
                                      bitcount=24, masks=(0xFF0000, 0xFF00, 0xFF, 0)),
        "dds_a2b10g10r10.dds": dds_file(w, h, _packed(rgba, m10, 4), 0x41, bitcount=32,
                                        masks=m10),
        "dds_palette.dds": dds_file(w, h, rgb[..., 0].tobytes(), 0x20, bitcount=8, palette=pal),
        "dds_bc4.dds": fourcc(b"BC4U", 8, 1),
        "dds_ati1.dds": fourcc(b"ATI1", 8, 2),
        "dds_bc5s.dds": fourcc(b"BC5S", 16, 3),
        "dds_ati2.dds": fourcc(b"ATI2", 16, 4),
        "dds_dx10_rgba8.dds": dds_file(w, h, rgba.tobytes(), 0x4, dxgi=28),
        "dds_dx10_bc1.dds": dx10(71, 5),
        "dds_bc6h_uf16.dds": dx10(95, 6),
        "dds_bc6h_sf16.dds": dx10(96, 7),
        "dds_bc7.dds": dx10(98, 8, mipmaps=2),
        "dds_bc7_srgb.dds": dx10(99, 9),
    }


def im_mode_fixtures() -> dict[str, bytes]:
    """IM files of the floating-point and YCbCr modes (seed 55), written
    by :func:`make_im`."""
    w, h = 23, 17
    rng = np.random.default_rng(55)
    f = rng.normal(120, 100, (h, w)).astype("<f4")
    f.flat[::9] = np.nan
    f.flat[4::11] = np.inf
    f.flat[5::13] = -np.inf
    bits12 = rng.integers(0, 256, h * ((w * 12 + 7) // 8), dtype=np.uint8).tobytes()
    bits5 = rng.integers(0, 256, h * ((w * 5 + 7) // 8), dtype=np.uint8).tobytes()
    ycc = _slice_levels((h, w), 55)
    return {
        "im_f32.im": make_im("L 32F", w, h, f.tobytes()),
        "im_f8s.im": make_im("L 8S", w, h, rng.integers(0, 256, w * h, dtype=np.uint8).tobytes()),
        "im_f16s.im": make_im("L*16S", w, h, rng.integers(-300, 600, w * h).astype("<i2")
                              .tobytes()),
        "im_f32u.im": make_im("L 32", w, h, rng.integers(0, 400, w * h).astype("<u4").tobytes()),
        "im_bits12.im": make_im("L*12", w, h, bits12),
        "im_bits5.im": make_im("L*5", w, h, bits5),
        "im_ycc.im": make_im("YCC", w, h, ycc.transpose(0, 2, 1).tobytes()),
    }


def psd_dds_fixtures(goldens: dict | None = None) -> dict[str, bytes]:
    """Every fixture of phase 25: Pillow's (``goldens``, read from
    tests/goldens/ when None) and those written here."""
    if goldens is None:
        goldens = {name: (GOLDENS / name).read_bytes() for name in PSD_DDS_GOLDENS}
    return {**goldens, **psd_fixtures(), **cur_fixtures(), **dds_made(), **im_mode_fixtures()}


def psd_4k(rgb: np.ndarray) -> bytes:
    """Phase 25's 3840x2160 PackBits RGB PSD of ``rgb`` (uint8 [H, W, 3])."""
    return make_psd(np.ascontiguousarray(rgb.transpose(2, 0, 1)), 3, compression=1)


def bc7_4k(hw, seed: int) -> bytes:
    """Phase 25's DX10 BC7 DDS of seeded random blocks."""
    h, w = hw
    return dds_file(w, h, bc_blocks(w, h, 16, seed), 0x4, dxgi=98)


# ---- JPEG 2000 (phase 26): Pillow's files, and edits of them made here ---------------

J2K_4K = ("j2k_4k_irreversible.jp2", "j2k_4k_lossless.jp2")


def j2k_ramps(hw) -> np.ndarray:
    """Smooth 8-bit RGB levels whose lossless JPEG 2000 stays small at 4K:
    a ramp across, a ramp down and a diagonal ramp."""
    h, w = hw
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    return np.stack([np.rint(x * 255 / (w - 1)), np.rint(y * 255 / (h - 1)),
                     np.rint((x + y) * 255 / (w + h - 2))], -1).astype(np.uint8)


def j2k_goldens() -> dict[str, bytes]:
    """Pillow's JPEG 2000 files of phase 26 (kept in tests/goldens/, as the
    card's machine has no Pillow): both paths, JP2 and raw codestreams,
    tiles with offsets, RPCL with precincts, quality layers, 16-bit gray,
    gray + alpha in CPRL with PLT markers, a gray index plane for the
    palette edit, and the two 3840x2160 files of phase 26b (the 4K levels
    of ``codec_prog_4k.jpg`` irreversible at rate 150, and
    :func:`j2k_ramps` lossless)."""
    from PIL import Image  # noqa: PLC0415

    import chip_smoke  # noqa: PLC0415

    small = levels((120, 160), 19, noise=0.02)
    mid = levels((333, 517), 18)
    rgba = np.dstack([levels((96, 128), 27), seeded_alpha(96, 128, 27)])
    gray16 = (levels((96, 128), 28)[..., 0].astype(np.uint16) * 257
              + np.random.default_rng(28).integers(0, 256, (96, 128), dtype=np.uint16))
    idx = (levels((64, 96), 29)[..., 0] // 7).astype(np.uint8)
    hw = (chip_smoke.H, chip_smoke.W)
    j2k = "JPEG2000"
    return {
        "j2k_rgb_lossless.jp2": _save(Image.fromarray(small), j2k),
        "j2k_rgb_irreversible_mct.jp2": _save(Image.fromarray(mid), j2k, irreversible=True,
                                              mct=1, quality_layers=[30]),
        "j2k_rgba_tiles.j2k": _save(Image.fromarray(rgba), j2k, no_jp2=True, tile_size=(48, 40),
                                    tile_offset=(5, 3), offset=(9, 7), progression="PCRL"),
        "j2k_rpcl_precincts.jp2": _save(Image.fromarray(mid), j2k, irreversible=True,
                                        progression="RPCL", precinct_size=(128, 128),
                                        codeblock_size=(32, 32), quality_layers=[20]),
        "j2k_layers.jp2": _save(Image.fromarray(small), j2k, mct=1, progression="RLCP",
                                quality_layers=[40, 10, 2], quality_mode="rates"),
        "j2k_gray16.jp2": _save(Image.fromarray(gray16), j2k, progression="CPRL"),
        "j2k_la_cprl.j2k": _save(Image.fromarray(rgba).convert("LA"), j2k, no_jp2=True,
                                 irreversible=True, progression="CPRL", codeblock_size=(16, 16),
                                 num_resolutions=3, plt=True),
        "j2k_index.j2k": _save(Image.fromarray(idx), j2k, no_jp2=True),
        J2K_4K[0]: _save(Image.fromarray(levels(hw, 17, noise=0.02)), j2k, irreversible=True,
                         quality_layers=[150]),
        J2K_4K[1]: _save(Image.fromarray(j2k_ramps(hw)), j2k),
    }


def j2k_box(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body) + 8) + kind + body


def make_jp2(codestream: bytes, header: bytes, nc: int, bpc: int) -> bytes:
    """A JP2 file around a codestream: the signature and ``ftyp`` boxes, a
    ``jp2h`` of ``ihdr`` (the codestream's size, ``nc`` components of
    ``bpc`` - 1 | sign) and ``header`` (more boxes), and ``jp2c``."""
    xsiz, ysiz, xo, yo = struct.unpack_from(">IIII", codestream, 8)
    ihdr = j2k_box(b"ihdr", struct.pack(">IIHBBBB", ysiz - yo, xsiz - xo, nc, bpc, 7, 0, 0))
    return (j2k_box(b"jP  ", b"\x0d\x0a\x87\x0a") + j2k_box(b"ftyp", b"jp2 \0\0\0\0jp2 ")
            + j2k_box(b"jp2h", ihdr + header) + j2k_box(b"jp2c", codestream))


def j2k_colr(enumcs: int) -> bytes:
    return j2k_box(b"colr", struct.pack(">BBBI", 1, 0, 0, enumcs))


def j2k_pclr(entries, depth: int = 7) -> bytes:
    """A ``pclr`` box of 8-bit (``depth`` 7) entries, and the ``cmap`` box
    that maps the one component through all its columns."""
    npc = len(entries[0])
    body = struct.pack(">HB", len(entries), npc) + bytes([depth] * npc)
    cmap = b"".join(struct.pack(">HBB", 0, 1, i) for i in range(npc))
    return j2k_box(b"pclr", body + b"".join(bytes(e) for e in entries)) + j2k_box(b"cmap", cmap)


def set_enumcs(data: bytes, enumcs: int) -> bytes:
    """A JP2 with its first ``colr`` box's enumerated colour space set."""
    at = data.index(b"colr") + 7
    return data[:at] + struct.pack(">I", enumcs) + data[at + 4:]


def set_ssiz(data: bytes, ssiz: int) -> bytes:
    """A codestream (or JP2) with every component's Ssiz byte set
    (precision - 1, sign in the top bit)."""
    at = data.index(b"\xff\x4f\xff\x51") + 4
    csiz = struct.unpack_from(">H", data, at + 36)[0]
    out = bytearray(data)
    for c in range(csiz):
        out[at + 38 + 3 * c] = ssiz
    return bytes(out)


def j2k_palette(n: int, seed: int) -> list:
    """n seeded RGB entries, one of them repeated (Pillow's palette keeps
    only the first of equal colours)."""
    rng = np.random.default_rng(seed)
    out = [tuple(int(v) for v in rng.integers(0, 256, 3)) for _ in range(n)]
    out[5] = out[2]
    return out


def j2k_edits(goldens: dict) -> dict[str, bytes]:
    """Phase 26's files edited from Pillow's without Pillow: the lossless
    RGB file as sYCC (``colr`` 18), the RGBA tiles as CMYK (``colr`` 12 in
    a JP2 around them), the index plane behind a 40-entry ``pclr``, and
    the 16-bit gray file's codestream read at 12 bits, signed."""
    gray16 = goldens["j2k_gray16.jp2"]
    cs16 = gray16[gray16.index(b"\xff\x4f\xff\x51"):]
    return {
        "j2k_sycc.jp2": set_enumcs(goldens["j2k_rgb_lossless.jp2"], 18),
        "j2k_cmyk.jp2": make_jp2(goldens["j2k_rgba_tiles.j2k"], j2k_colr(12), 4, 7),
        "j2k_pclr.jp2": make_jp2(goldens["j2k_index.j2k"], j2k_colr(16)
                                 + j2k_pclr(j2k_palette(40, 29)), 1, 7),
        "j2k_signed12.j2k": set_ssiz(cs16, 0x80 | 11),
    }


def j2k_fixtures(goldens: dict | None = None) -> dict[str, bytes]:
    """Every small fixture of phase 26a: Pillow's (read from tests/goldens/
    when None) and the edits of :func:`j2k_edits`."""
    if goldens is None:
        goldens = {name: (GOLDENS / name).read_bytes() for name in j2k_golden_names()}
    small = {k: v for k, v in goldens.items() if k not in J2K_4K}
    return {**small, **j2k_edits(goldens)}


def j2k_golden_names() -> tuple:
    return ("j2k_rgb_lossless.jp2", "j2k_rgb_irreversible_mct.jp2", "j2k_rgba_tiles.j2k",
            "j2k_rpcl_precincts.jp2", "j2k_layers.jp2", "j2k_gray16.jp2", "j2k_la_cprl.j2k",
            "j2k_index.j2k", *J2K_4K)


def j2k_4k_digest(data: bytes) -> tuple[str, str]:
    """sha256 of a 4K file and of Pillow's ``convert("RGB")`` of it."""
    from PIL import Image  # noqa: PLC0415

    return hashlib.sha256(data).hexdigest(), rgb_digest(
        np.asarray(Image.open(io.BytesIO(data)).convert("RGB")))


# ---- JPEG 2000 written by Pillow's own OpenJPEG through ctypes (phase 29) -------

_OPJ_PROG = {"LRCP": 0, "RLCP": 1, "RPCL": 2, "PCRL": 3, "CPRL": 4}
# byte offsets into OpenJPEG 2.5's opj_cparameters_t (openjpeg.h), a
# 148-byte opj_poc_t each in POC[32], and into opj_image_t / opj_image_comp_t
_CP = dict(tile_size_on=0, cp_tx0=4, cp_ty0=8, cp_tdx=12, cp_tdy=16, cp_disto_alloc=20,
           csty=48, prog_order=52, POC=56, numpocs=4792, tcp_numlayers=4796, tcp_rates=4800,
           numresolution=5600, cblockw_init=5604, cblockh_init=5608, mode=5612,
           irreversible=5616, roi_compno=5620, roi_shift=5624, res_spec=5628, prcw_init=5632,
           prch_init=5764, image_offset_x0=18188, image_offset_y0=18192, tcp_mct=18698)
_CP_SIZE = 32768            # more than sizeof(opj_cparameters_t), 18720 on x86-64
_POC_SIZE, _COMP_SIZE = 148, 64
_CLRSPC = {"srgb": 1, "gray": 2, "sycc": 3}


def openjpeg_library():
    """The OpenJPEG library bundled with Pillow (the one that decodes for the
    JAX package), loaded with ctypes, or None where it is not found."""
    import ctypes  # noqa: PLC0415
    import glob  # noqa: PLC0415
    import os  # noqa: PLC0415

    try:
        import PIL  # noqa: PLC0415
    except ImportError:
        return None
    found = sorted(glob.glob(os.path.join(os.path.dirname(PIL.__file__), os.pardir,
                                          "pillow.libs", "libopenjp2-*.so*")))
    if not found:
        return None
    lib = ctypes.CDLL(found[0])
    c, p = ctypes, ctypes.c_void_p
    for name, res, args in (("opj_image_create", p, [c.c_uint32, p, c.c_int]),
                            ("opj_create_compress", p, [c.c_int]),
                            ("opj_set_default_encoder_parameters", None, [p]),
                            ("opj_set_error_handler", c.c_int, [p, p, p]),
                            ("opj_setup_encoder", c.c_int, [p, p, p]),
                            ("opj_stream_create_default_file_stream", p, [c.c_char_p, c.c_int]),
                            ("opj_start_compress", c.c_int, [p, p, p]),
                            ("opj_encode", c.c_int, [p, p]), ("opj_end_compress", c.c_int, [p, p]),
                            ("opj_stream_destroy", None, [p]), ("opj_destroy_codec", None, [p]),
                            ("opj_image_destroy", None, [p])):
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = res, args
    return lib


def _j2k_segment(cs: bytes, at: int) -> bytes:
    return cs[at + 4:at + 2 + struct.unpack_from(">H", cs, at + 2)[0]]


def _j2k_check(cs: bytes, nc: int, want: dict) -> None:
    """The coding markers OpenJPEG wrote are the ones asked for: COD's Scod,
    progression and code-block style, RGN, and each tile's POC."""
    cod = _j2k_segment(cs, cs.index(b"\xff\x52"))
    assert (cod[0], cod[1], cod[8]) == (want["scod"], want["prog"], want["mode"]), \
        ("COD", cod.hex(), want)
    if want["roi"] is not None:
        c, shift = want["roi"]
        assert _j2k_segment(cs, cs.index(b"\xff\x5e")) == bytes([c, 0, shift]), "RGN"
    else:
        assert b"\xff\x5e" not in cs[:cs.index(b"\xff\x90")], "RGN"
    pos, tiles = cs.index(b"\xff\x90"), {}
    while cs[pos:pos + 2] == b"\xff\x90":
        _l, isot, psot = struct.unpack_from(">HHI", cs, pos + 2)
        sod = cs.index(b"\xff\x93", pos)
        hdr, k = cs[pos + 12:sod], 0
        while k < len(hdr):
            m, n = struct.unpack_from(">HH", hdr, k)
            if m == 0xFF5F:
                tiles[isot] = tiles.get(isot, b"") + hdr[k + 4:k + 2 + n]
            k += 2 + n
        pos += psot
    for t in set(tiles) | set(want["pocs"]):
        assert tiles.get(t) == want["pocs"].get(t), ("POC", t, tiles.get(t), want["pocs"].get(t))


def j2k_write(planes, *, subsampling=None, prec=8, signed=False, origin=(0, 0), tiles=None,
              numres=6, cblk=(64, 64), prog="LRCP", irreversible=False, mct=False, sop=False,
              eph=False, mode=0, roi=None, rates=(0.0,), pocs=(), precincts=None, jp2=False,
              space=None, lib=None) -> bytes:
    """A codestream (or, ``jp2``, a JP2 file) OpenJPEG codes from int planes
    (component c at ``subsampling[c]``, the image's extent that of plane 0
    from ``origin``) with ``opj_encode``: tiles ``((w, h), (x0, y0))``,
    ``numres`` resolutions, code-blocks ``cblk``, progression ``prog``, the
    9/7 wavelet, MCT, SOP and EPH markers, the code-block style ``mode``
    (COD's SPcod byte 8), ``roi`` (component, shift) for RGN, a layer per
    rate (0: lossless), POC progressions (dicts of ``res0``, ``comp0``,
    ``lay1``, ``res1``, ``comp1``, ``prg`` and the 1-based ``tile``) and
    precinct sizes per resolution.  Checks that COD, RGN and POC are the
    bytes asked for."""
    import ctypes  # noqa: PLC0415
    import os  # noqa: PLC0415
    import tempfile  # noqa: PLC0415

    lib = lib or openjpeg_library()
    nc = len(planes)
    subs = list(subsampling or [(1, 1)] * nc)
    precs = list(prec) if isinstance(prec, (list, tuple)) else [prec] * nc
    x0, y0 = origin
    x1, y1 = x0 + planes[0].shape[1] * subs[0][0], y0 + planes[0].shape[0] * subs[0][1]
    parms = (ctypes.c_uint32 * (9 * nc))()
    for c, (plane, (dx, dy)) in enumerate(zip(planes, subs)):
        w, h = -(-x1 // dx) - -(-x0 // dx), -(-y1 // dy) - -(-y0 // dy)
        assert plane.shape == (h, w), (c, plane.shape, (h, w))
        parms[9 * c:9 * c + 9] = [dx, dy, w, h, -(-x0 // dx), -(-y0 // dy), precs[c], precs[c],
                                  int(signed)]
    space = space or ("srgb" if nc >= 3 else "gray")
    img = lib.opj_image_create(nc, parms, _CLRSPC[space])
    (ctypes.c_uint32 * 4).from_address(img)[:] = [x0, y0, x1, y1]
    comps = ctypes.c_void_p.from_address(img + 24).value
    kept = []
    for c, plane in enumerate(planes):
        a = np.ascontiguousarray(plane, np.int32)
        kept.append(a)              # alive until the copy is made
        ctypes.memmove(ctypes.c_void_p.from_address(comps + _COMP_SIZE * c + 48).value,
                       a.ctypes.data, a.nbytes)
    par = ctypes.create_string_buffer(_CP_SIZE)
    lib.opj_set_default_encoder_parameters(par)

    def put(key, v, fmt="<i", k=0):
        struct.pack_into(fmt, par, _CP[key] + k, v)

    if tiles:
        (tdx, tdy), (tx0, ty0) = tiles
        for key, v in (("tile_size_on", 1), ("cp_tx0", tx0), ("cp_ty0", ty0), ("cp_tdx", tdx),
                       ("cp_tdy", tdy)):
            put(key, v)
    scod = (1 if precincts else 0) | (2 if sop else 0) | (4 if eph else 0)
    put("cp_disto_alloc", 1)
    put("csty", scod)
    put("prog_order", _OPJ_PROG[prog])
    for k, pc in enumerate(pocs):
        for field, at in (("res0", 0), ("comp0", 4), ("lay1", 8), ("res1", 12), ("comp1", 16),
                          ("tile", 48)):
            put("POC", pc.get(field, 1), k=_POC_SIZE * k + at)
        put("POC", _OPJ_PROG[pc["prg"]], k=_POC_SIZE * k + 32)
    put("numpocs", len(pocs))
    put("tcp_numlayers", len(rates))
    for k, r in enumerate(rates):
        put("tcp_rates", float(r), "<f", 4 * k)
    put("numresolution", numres)
    put("cblockw_init", cblk[0])
    put("cblockh_init", cblk[1])
    put("mode", mode)
    put("irreversible", int(irreversible))
    if roi:
        put("roi_compno", roi[0])
        put("roi_shift", roi[1])
    if precincts:
        put("res_spec", len(precincts))
        for k, (pw, ph) in enumerate(precincts):
            put("prcw_init", pw, k=4 * k)
            put("prch_init", ph, k=4 * k)
    put("image_offset_x0", x0)
    put("image_offset_y0", y0)
    put("tcp_mct", int(mct), "<b")
    codec = lib.opj_create_compress(2 if jp2 else 0)
    msgs = []
    handler = ctypes.CFUNCTYPE(None, ctypes.c_char_p, ctypes.c_void_p)(
        lambda m, _d: msgs.append(m.decode().strip()))
    lib.opj_set_error_handler(codec, handler, None)
    with tempfile.TemporaryDirectory(prefix="j2k_write_") as tmp:
        path = os.path.join(tmp, "out").encode()
        stream = lib.opj_stream_create_default_file_stream(path, 0)
        ok = (lib.opj_setup_encoder(codec, par, img) and lib.opj_start_compress(codec, img, stream)
              and lib.opj_encode(codec, stream) and lib.opj_end_compress(codec, stream))
        lib.opj_stream_destroy(stream)
        lib.opj_destroy_codec(codec)
        lib.opj_image_destroy(img)
        if not ok:
            raise RuntimeError(f"OpenJPEG did not encode: {msgs}")
        with open(path, "rb") as f:
            data = f.read()
    cs = data[data.index(b"\xff\x4f\xff\x51"):]
    want_pocs = {}
    for t in range(256):        # OpenJPEG gives tile t the first n POCs, n those of tile t + 1
        n = sum(pc.get("tile", 1) == t + 1 for pc in pocs)
        if n:
            want_pocs[t] = b"".join(struct.pack(">BBHBBB", pc["res0"], pc["comp0"], pc["lay1"],
                                                pc["res1"], min(pc["comp1"], nc),
                                                _OPJ_PROG[pc["prg"]]) for pc in pocs[:n])
    _j2k_check(cs, nc, dict(scod=scod, prog=_OPJ_PROG[prog], mode=mode, roi=roi, pocs=want_pocs))
    return data


def j2k_stitch(streams, tile_coc=(), main_coc_from=None) -> bytes:
    """One codestream of the components of single-component, one-tile-part
    CPRL codestreams of one geometry (component c's packets follow component
    c - 1's in CPRL): SIZ with each one's Ssiz and sub-sampling, COD and QCD
    of the first, COC and QCC of the others.  A component in ``tile_coc``
    has its COC in every tile-part header instead, and the main header then
    a COC made of component ``main_coc_from``'s COD, which the tile's
    overrides."""
    parsed = []
    for cs in streams:
        pos, main = 2, {}
        while cs[pos:pos + 2] != b"\xff\x90":
            main[struct.unpack_from(">H", cs, pos)[0]] = _j2k_segment(cs, pos)
            pos += 2 + struct.unpack_from(">H", cs, pos + 2)[0]
        bodies = []
        while cs[pos:pos + 2] == b"\xff\x90":
            psot = struct.unpack_from(">I", cs, pos + 6)[0]
            bodies.append(cs[cs.index(b"\xff\x93", pos) + 2:pos + psot])
            pos += psot
        parsed.append((main, bodies))

    def seg(marker, body):
        return struct.pack(">HH", marker, len(body) + 2) + body

    def coc(c, cod):
        return seg(0xFF53, bytes([c, cod[0] & 1]) + cod[5:])

    nc = len(streams)
    siz = parsed[0][0][0xFF51]
    siz = siz[:34] + struct.pack(">H", nc) + b"".join(m[0xFF51][36:39] for m, _ in parsed)
    out = b"\xff\x4f" + seg(0xFF51, siz) + seg(0xFF52, parsed[0][0][0xFF52])
    for c in range(1, nc):
        if c not in tile_coc:
            out += coc(c, parsed[c][0][0xFF52])
        elif main_coc_from is not None:
            out += coc(c, parsed[main_coc_from][0][0xFF52])
    out += seg(0xFF5C, parsed[0][0][0xFF5C])
    out += b"".join(seg(0xFF5D, bytes([c]) + parsed[c][0][0xFF5C]) for c in range(1, nc))
    for t in range(len(parsed[0][1])):
        hdr = b"".join(coc(c, parsed[c][0][0xFF52]) for c in tile_coc)
        body = b"".join(bodies[t] for _, bodies in parsed)
        out += struct.pack(">HHHIBB", 0xFF90, 10, t, 14 + len(hdr) + len(body), 0, 1) + hdr \
            + b"\xff\x93" + body
    return out + b"\xff\xd9"


J2K_MORE_4K = ("j2k_cinema4k.jp2", "j2k_4k_bypass_termall.j2k")
J2K_STYLES = (1, 2, 4, 8, 16, 32, 63)      # each code-block style switch alone, and all six


def _planes(rgb: np.ndarray) -> list:
    return [rgb[..., c].astype(np.int32) for c in range(rgb.shape[-1])]


def _j2k_single(plane, **kw) -> bytes:
    return j2k_write([plane], prog="CPRL", **kw)


def j2k_more_goldens(lib=None) -> dict[str, bytes]:
    """The JPEG 2000 files of phase 29 (kept in tests/goldens/, as the
    card's machine has neither Pillow nor its OpenJPEG), each coded with
    what it pins by Pillow's OpenJPEG 2.5: Pillow's ``cinema4k-24`` of the
    4096x2160 :func:`j2k_ramps` (a POC marker in the main header and a tile
    part per component); POCs in every tile's header, and three POCs over
    three layers; SOP and EPH markers over layers and tiles; each code-block
    style switch alone and all six, 5/3 lossless and 9/7 at rate 3; an RGN
    marker (max shift 6 on the second component); COC and QCC (components
    coded apart in CPRL by :func:`j2k_write` and joined by
    :func:`j2k_stitch`: 5/3, 9/7 with every style switch, 5/3 in bypass with
    precincts), and COC in every tile-part header over a main-header COC;
    sub-sampled components (4:2:0 and tiled 4:2:2 codestreams Pillow reads
    as sYCC, a 4:2:0 JP2 in sYCC, four components with 4:2:0 chroma); and
    the 3840x2160 levels of ``codec_prog_4k.jpg`` in bypass with every pass
    terminated, 9/7 at rate 150."""
    from PIL import Image  # noqa: PLC0415

    import chip_smoke  # noqa: PLC0415

    lib = lib or openjpeg_library()
    w = functools.partial(j2k_write, lib=lib)
    small = _planes(levels((48, 64), 41, noise=0.02))
    mid = _planes(levels((80, 96), 42, noise=0.02))
    odd = _planes(levels((61, 75), 43, noise=0.02))
    out = {"j2k_cinema4k.jp2": _save(Image.fromarray(j2k_ramps((2160, 4096))), "JPEG2000",
                                     cinema_mode="cinema4k-24")}
    split = [dict(res0=r0, comp0=0, lay1=1, res1=r1, comp1=3, prg=prg, tile=t + 1)
             for t in range(4) for r0, r1, prg in ((0, 2, "CPRL"), (2, 4, "LRCP"))]
    out["j2k_poc_tiles.j2k"] = w(mid, numres=4, tiles=((48, 40), (0, 0)), pocs=split)
    out["j2k_poc_layers.j2k"] = w(mid, numres=4, rates=(40, 12, 0), pocs=[
        dict(res0=0, comp0=0, lay1=1, res1=4, comp1=3, prg="RPCL"),
        dict(res0=0, comp0=0, lay1=3, res1=2, comp1=2, prg="RLCP"),
        dict(res0=0, comp0=0, lay1=3, res1=4, comp1=3, prg="PCRL")])
    out["j2k_sop_eph.j2k"] = w(mid, numres=3, rates=(30, 8, 0), sop=True, eph=True, mct=True,
                               tiles=((48, 40), (0, 0)), prog="RPCL")
    for style in J2K_STYLES:
        out[f"j2k_style{style}_53.j2k"] = w(small, numres=3, cblk=(16, 16), mode=style, mct=True)
        out[f"j2k_style{style}_97.j2k"] = w(small, numres=3, cblk=(16, 16), mode=style, mct=True,
                                            irreversible=True, rates=(3,))
    out["j2k_rgn.j2k"] = w(mid, numres=3, roi=(1, 6), rates=(20, 0))
    comps = [_j2k_single(mid[0], numres=4, cblk=(32, 32), tiles=((48, 40), (0, 0)), lib=lib),
             _j2k_single(mid[1], numres=2, cblk=(8, 16), mode=63, irreversible=True, rates=(6,),
                         tiles=((48, 40), (0, 0)), lib=lib),
             _j2k_single(mid[2], numres=4, cblk=(16, 16), mode=1, precincts=[(32, 32), (16, 16)],
                         tiles=((48, 40), (0, 0)), lib=lib)]
    out["j2k_coc_qcc.j2k"] = j2k_stitch(comps)
    out["j2k_tile_coc.j2k"] = j2k_stitch(comps, tile_coc=(1, 2), main_coc_from=0)
    out["j2k_sub_420.j2k"] = w([mid[0], mid[1][::2, ::2], mid[2][::2, ::2]],
                               subsampling=[(1, 1), (2, 2), (2, 2)], numres=3)
    out["j2k_sub_422_tiles.j2k"] = w([odd[0], odd[1][:, ::2], odd[2][:, ::2]],
                                     subsampling=[(1, 1), (2, 1), (2, 1)], numres=3,
                                     tiles=((40, 32), (0, 0)))
    out["j2k_sycc_420.jp2"] = w([mid[0], mid[1][::2, ::2], mid[2][::2, ::2]],
                                subsampling=[(1, 1), (2, 2), (2, 2)], numres=3, jp2=True,
                                space="sycc", irreversible=True, rates=(8,))
    alpha = seeded_alpha(80, 96, 42).astype(np.int32)
    out["j2k_sub_rgba.j2k"] = w([mid[0], mid[1][::2, ::2], mid[2][::2, ::2], alpha],
                                subsampling=[(1, 1), (2, 2), (2, 2), (1, 1)], numres=3)
    big = _planes(levels((chip_smoke.H, chip_smoke.W), 17, noise=0.02))
    out["j2k_4k_bypass_termall.j2k"] = w(big, mode=5, mct=True, irreversible=True, rates=(150,))
    out.update(j2k_packed_goldens(out["j2k_sop_eph.j2k"], lib))
    return out


# ---- packed packet headers (PPM, PPT) and resolution-short POCs ------------------


def j2k_split(cs: bytes) -> tuple[list, list]:
    """A codestream's main-header segments (markers included) and its tile
    parts as (the 12 bytes of SOT, header segments, body)."""
    def segments(pos, stop):
        out = []
        while cs[pos:pos + 2] != stop:
            n = struct.unpack_from(">H", cs, pos + 2)[0]
            out.append(cs[pos:pos + 2 + n])
            pos += 2 + n
        return out, pos

    main, pos = segments(2, b"\xff\x90")
    parts = []
    while cs[pos:pos + 2] == b"\xff\x90":
        psot = struct.unpack_from(">I", cs, pos + 6)[0]
        segs, sod = segments(pos + 12, b"\xff\x93")
        parts.append((cs[pos:pos + 12], segs, cs[sod + 2:pos + psot]))
        pos += psot
    return main, parts


def j2k_join(main: list, parts: list) -> bytes:
    """:func:`j2k_split`'s pieces as a codestream again (each Psot remade)."""
    out = b"\xff\x4f" + b"".join(main)
    for sot, segs, body in parts:
        hdr = b"".join(segs)
        out += sot[:6] + struct.pack(">I", 14 + len(hdr) + len(body)) + sot[10:] + hdr \
            + b"\xff\x93" + body
    return out + b"\xff\xd9"


def j2k_marker(marker: int, body: bytes) -> bytes:
    return struct.pack(">HH", marker, len(body) + 2) + body


def j2k_packets(body: bytes) -> list:
    """A tile part's body coded with SOP and EPH markers as its packets'
    (SOP segment, header up to and with its EPH marker, data): neither
    marker can occur in a bit-stuffed header or in code-block data."""
    starts = [m.start() for m in re.finditer(b"\xff\x91\x00\x04", body)]
    assert starts and starts[0] == 0, "a body of SOP-led packets"
    out = []
    for a, b in zip(starts, starts[1:] + [len(body)]):
        pkt = body[a:b]
        e = pkt.index(b"\xff\x92", 6) + 2
        out.append((pkt[:6], pkt[6:e], pkt[e:]))
    return out


def _cuts(size: int, pieces: int, avoid=()) -> list:
    """``pieces`` non-empty spans of ``size`` bytes, no cut inside a span
    of ``avoid`` ((start, end) pairs)."""
    cuts = [0]
    for k in range(1, pieces):
        at = size * k // pieces
        for a, b in avoid:
            if a < at < b:
                at = b
        if cuts[-1] < at < size:
            cuts.append(at)
    return cuts + [size]


def j2k_pack(cs: bytes, where: str = "ppm", pieces: int = 1, zs=None, appear=None,
             keep_sop: bool = True, eph: bool = True, nppm_split: bool = False) -> bytes:
    """A codestream coded with SOP and EPH markers, its packet headers
    moved into packed headers: ``where`` ``ppm`` (the main header: an Nppm
    and the headers of each tile part in codestream order, the whole cut
    into ``pieces`` PPM markers, no cut inside an Nppm unless
    ``nppm_split``) or ``ppt`` (each tile part's headers in ``pieces`` PPT
    markers of its header).  The markers take the Z indices ``zs`` (in the
    data's order, gaps allowed; a tile's later tile parts theirs past the
    largest, as a tile's PPT indices run on) and stand in the order
    ``appear``; the
    bodies keep their SOP segments (``keep_sop``), the headers their EPH
    markers (``eph``: else the markers go and Scod's bit 2 is cleared)."""
    main, parts = j2k_split(cs)
    if not eph:
        main = [s[:4] + bytes([s[4] & ~4]) + s[5:] if s[:2] == b"\xff\x52" else s for s in main]
    heads, bodies = [], []
    for _sot, _segs, body in parts:
        pk = j2k_packets(body)
        heads.append(b"".join(h if eph else h[:-2] for _, h, _ in pk))
        bodies.append(b"".join((s if keep_sop else b"") + d for s, _, d in pk))

    def markers(marker, data, avoid=(), part=0):
        cuts = _cuts(len(data), pieces, avoid)
        chunks = [data[a:b] for a, b in zip(cuts, cuts[1:])]
        z = list(zs or range(pieces))
        z = [k + part * (max(z) + 1) for k in z[:len(chunks)]]
        segs = [j2k_marker(marker, bytes([k]) + c) for k, c in zip(z, chunks)]
        return [segs[k] for k in (appear or range(len(segs))) if k < len(segs)]

    if where == "ppm":
        payload, avoid = b"", []
        for h in heads:
            avoid.append((len(payload) + (2 if nppm_split else 4), len(payload) + 4))
            payload += struct.pack(">I", len(h)) + h
        if nppm_split:
            avoid = [(a, a + 1) for a, _ in avoid]
            cuts = [0, avoid[len(avoid) // 2][0], len(payload)]
            chunks = [payload[a:b] for a, b in zip(cuts, cuts[1:])]
            return j2k_join(main + [j2k_marker(0xFF60, bytes([k]) + c)
                                    for k, c in enumerate(chunks)],
                            [(sot, segs, b) for (sot, segs, _), b in zip(parts, bodies)])
        return j2k_join(main + markers(0xFF60, payload, avoid),
                        [(sot, segs, b) for (sot, segs, _), b in zip(parts, bodies)])
    return j2k_join(main, [(sot, segs + markers(0xFF61, h, part=sot[10]), b)
                           for (sot, segs, _), h, b in zip(parts, heads, bodies)])


def j2k_poc(r1: int, c0: int = 0, c1: int = 3, tile: int = 1, prg: str = "LRCP",
            r0: int = 0, lay1: int = 1) -> dict:
    """A POC progression for :func:`j2k_write` (``tile`` 1-based)."""
    return dict(res0=r0, comp0=c0, lay1=lay1, res1=r1, comp1=c1, prg=prg, tile=tile)


J2K_PACKED = ("j2k_ppm.j2k", "j2k_ppm_split.j2k", "j2k_ppt.j2k", "j2k_ppt_split.j2k",
              "j2k_pocres_all.j2k", "j2k_pocres_one.j2k", "j2k_pocres_tiles.j2k")


def j2k_packed_goldens(sop_eph: bytes, lib=None) -> dict[str, bytes]:
    """Phase 29's goldens of packed headers and resolution-short POCs: the
    SOP+EPH golden's headers in one PPM marker; in three PPM markers of Z
    indices 0, 2 and 5 standing in the order 5, 0, 2 with the SOP segments
    dropped from the bodies; in a PPT marker per tile part; in two PPT
    markers a tile part (Z 1 and 3, the second first); and files OpenJPEG
    coded under POCs that leave out the highest resolution: of all three
    components (9/7, MCT), of the first only, and of the first tile only
    (the second tile's three POCs cover it)."""
    lib = lib or openjpeg_library()
    mid = _planes(levels((80, 96), 42, noise=0.02))
    return {
        "j2k_ppm.j2k": j2k_pack(sop_eph),
        "j2k_ppm_split.j2k": j2k_pack(sop_eph, pieces=3, zs=(0, 2, 5), appear=(2, 0, 1),
                                      keep_sop=False),
        "j2k_ppt.j2k": j2k_pack(sop_eph, "ppt"),
        "j2k_ppt_split.j2k": j2k_pack(sop_eph, "ppt", pieces=2, zs=(1, 3), appear=(1, 0)),
        "j2k_pocres_all.j2k": j2k_write(mid, numres=4, mct=True, irreversible=True, rates=(6,),
                                        pocs=[j2k_poc(3)], lib=lib),
        "j2k_pocres_one.j2k": j2k_write(mid, numres=4, pocs=[j2k_poc(3, 0, 1),
                                                             j2k_poc(4, 1, 3, prg="RPCL")],
                                        lib=lib),
        "j2k_pocres_tiles.j2k": j2k_write(mid, numres=4, tiles=((48, 80), (0, 0)),
                                          pocs=[j2k_poc(3), j2k_poc(4, tile=2),
                                                j2k_poc(4, tile=2)], lib=lib),
    }


def j2k_more_names() -> tuple:
    return ("j2k_cinema4k.jp2", "j2k_poc_tiles.j2k", "j2k_poc_layers.j2k", "j2k_sop_eph.j2k",
            *(f"j2k_style{s}_{p}.j2k" for s in J2K_STYLES for p in ("53", "97")),
            "j2k_rgn.j2k", "j2k_coc_qcc.j2k", "j2k_tile_coc.j2k", "j2k_sub_420.j2k",
            "j2k_sub_422_tiles.j2k", "j2k_sycc_420.jp2", "j2k_sub_rgba.j2k",
            "j2k_4k_bypass_termall.j2k", *J2K_PACKED)


def j2k_more_fixtures() -> dict[str, bytes]:
    """Phase 29's goldens, as tests/goldens/ holds them."""
    return {name: (GOLDENS / name).read_bytes() for name in j2k_more_names()}


# ---- arithmetic-coded JPEG, written by libjpeg (tests/jpeg_arith_writer.c) ------

ARITH_WRITER = Path(__file__).resolve().parent / "jpeg_arith_writer.c"


def build_arith_writer(directory) -> Path:
    """``tests/jpeg_arith_writer.c`` compiled with ``gcc`` against the
    system's libjpeg (its headers and ``-ljpeg``) into ``directory``;
    raises ``RuntimeError`` with the compiler's message where it cannot."""
    import subprocess  # noqa: PLC0415

    out = Path(directory) / "jpeg_arith_writer"
    r = subprocess.run(["gcc", "-O2", "-Wall", str(ARITH_WRITER), "-ljpeg", "-o", str(out)],
                       capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"building {ARITH_WRITER.name} failed:\n{r.stdout}{r.stderr}")
    return out


def arith_transcode(writer, data: bytes, *opts) -> bytes:
    """The coefficients of the JPEG ``data`` written again by ``writer``
    (:func:`build_arith_writer`) with its options (arithmetic coding unless
    ``-h``; see the source's head); raises ``RuntimeError`` with libjpeg's
    message."""
    import subprocess  # noqa: PLC0415
    import tempfile  # noqa: PLC0415

    with tempfile.TemporaryDirectory(prefix="arith_") as tmp:
        src, dst = Path(tmp) / "in.jpg", Path(tmp) / "out.jpg"
        src.write_bytes(data)
        r = subprocess.run([str(writer), str(src), str(dst), *map(str, opts)],
                           capture_output=True, text=True)
        if r.returncode:
            raise RuntimeError(f"jpeg_arith_writer {' '.join(map(str, opts))}: {r.stderr}")
        return dst.read_bytes()


def jpeg_segments(data: bytes) -> list[tuple[int, bytes]]:
    """(code, bytes) of each marker segment after SOI up to the first SOS,
    then (0xDA, the rest of the file)."""
    out, pos = [], 2
    while True:
        code = data[pos + 1]
        if code == 0xDA:
            out.append((code, data[pos:]))
            return out
        n = struct.unpack_from(">H", data, pos + 2)[0]
        out.append((code, data[pos:pos + 2 + n]))
        pos += 2 + n


def abbreviate(data: bytes, table_codes=(0xDB, 0xC4)) -> tuple[bytes, bytes]:
    """A one-scan JPEG as a TIFF holds it: (JPEGTables: SOI, the segments
    of ``table_codes`` (DQT and DHT; DAC too where asked), EOI; the
    abbreviated stream: SOI and the rest but APPn)."""
    tables, rest = b"\xff\xd8", b"\xff\xd8"
    for code, seg in jpeg_segments(data):
        if code in table_codes:
            tables += seg
        elif not 0xE0 <= code <= 0xEF:
            rest += seg
    return tables + b"\xff\xd9", rest


def jpeg_in_tiff(streams, w: int, h: int, photometric: int, spp: int, tile=None,
                 rows: int | None = None, tables: bytes | None = None,
                 subsampling=None) -> bytes:
    """A little-endian JPEG-in-TIFF (compression 7) of one JPEG stream a
    strip of ``rows`` rows or a tile of ``tile`` = (height, width), with the
    JPEGTables ``tables`` where given, photometric 1 (gray), 2 (RGB) or 6
    (YCbCr, ``subsampling`` its YCbCrSubsampling)."""
    tags = {256: (4, [w]), 257: (4, [h]), 258: (3, [8] * spp), 259: (3, [7]),
            262: (3, [photometric]), 277: (3, [spp]), 284: (3, [1])}
    if tile:
        tags.update({322: (3, [tile[1]]), 323: (3, [tile[0]]), 324: (4, []),
                     325: (4, [len(s) for s in streams])})
    else:
        tags.update({273: (4, []), 278: (4, [rows or h]), 279: (4, [len(s) for s in streams])})
    if tables is not None:
        tags[347] = (7, list(tables))
    if subsampling:
        tags[530] = (3, list(subsampling))
    return _assemble(list(streams), tags, "<")


def arith_tiff(writer, pixels: np.ndarray, photometric: int, opts=(), tile=None,
               rows: int | None = None, abbreviated: bool = False,
               table_codes=(0xDB, 0xC4, 0xCC)) -> bytes:
    """A JPEG-in-TIFF of ``pixels`` (uint8 [h, w] gray, or [h, w, 3]) whose
    strips or tiles are arithmetic-coded: each block Pillow's JPEG (4:2:0
    YCbCr for photometric 6, RGB components for 2, gray for 1; a tile's
    part past the image filled with the edge samples) written again by
    ``writer`` with ``opts``; whole streams, or ``abbreviated`` streams
    under one JPEGTables holding the segments of ``table_codes``."""
    from PIL import Image  # noqa: PLC0415

    h, w = pixels.shape[:2]
    if tile:
        th, tw = tile
        pad = ((0, -h % th), (0, -w % tw)) + ((0, 0),) * (pixels.ndim - 2)
        full = np.pad(pixels, pad, mode="edge")
        grid = [(y, x) for y in range(0, h, th) for x in range(0, w, tw)]
    else:
        th, tw, full = rows or h, w, pixels
        grid = [(y, 0) for y in range(0, h, th)]
    kw = {"keep_rgb": True, "subsampling": 0} if photometric == 2 else {}
    streams, tables = [], None
    for y, x in grid:
        block = Image.fromarray(np.ascontiguousarray(full[y:y + th, x:x + tw]))
        data = arith_transcode(writer, _save(block, "JPEG", **kw), *opts)
        if abbreviated:
            tables, data = abbreviate(data, table_codes)
        streams.append(data)
    spp = 1 if pixels.ndim == 2 else 3
    return jpeg_in_tiff(streams, w, h, photometric, spp, tile, rows, tables,
                        (2, 2) if photometric == 6 else None)


# name -> (the Huffman source: a golden's name, or (hw, seed) of levels()
# saved by Pillow at its defaults; the writer's options; the scans kept)
ARITH_GOLDENS = {
    "arith_seq_420.jpg": (((333, 517), 18), (), None),
    "arith_seq_444_rst.jpg": ("codec_prog_444_rst.jpg", ("-r", 4), None),
    "arith_prog_gray_dac.jpg": ("codec_prog_gray.jpg", ("-p", "-d", "0:2:5", "-k", "0:12"), None),
    "arith_cmyk_rows.jpg": ("cmyk_rst.jpg", ("-R", 2), None),
    "arith_ycck_prog.jpg": ("cmyk_rst.jpg", ("-p", "-y"), None),
    "arith_prog_short.jpg": ("codec_prog_444_rst.jpg", ("-p",), 6),
}
ARITH_TIFFS = ("arith_tiles.tif", "arith_gray_strips.tif")
ARITH_4K = "arith_4k.tif"


def arith_source(name: str) -> bytes:
    """The Huffman JPEG an arithmetic golden of ``ARITH_GOLDENS`` is
    written from."""
    src = ARITH_GOLDENS[name][0]
    if isinstance(src, str):
        return (GOLDENS / src).read_bytes()
    from PIL import Image  # noqa: PLC0415

    return _save(Image.fromarray(levels(*src)), "JPEG")


def arith_goldens(writer) -> dict[str, bytes]:
    """``chip_smoke.py`` phase 27's files, written by ``writer``: the
    arithmetic JPEGs of ``ARITH_GOLDENS`` (a short file keeps its first
    scans only); a 4:2:0 YCbCr TIFF of 64x64 tiles, abbreviated streams
    (each with its own DAC: a stream's SOI sets the conditioning back to
    the defaults) under a JPEGTables of their DQT; a gray TIFF of 16-row strips,
    each a whole conditioned stream with a restart every 2 MCU rows; and
    ``codec_prog_4k.jpg``'s coefficients, sequential, in the one strip of a
    3840x2160 YCbCr TIFF."""
    out = {}
    for name, (_, opts, keep) in ARITH_GOLDENS.items():
        data = arith_transcode(writer, arith_source(name), *opts)
        out[name] = data if keep is None else cut_scans(data, lambda k, s: k < keep)
    rgb = levels((120, 160), 81)
    out["arith_tiles.tif"] = arith_tiff(writer, rgb, 6, tile=(64, 64), abbreviated=True,
                                        opts=("-d", "1:0:3", "-k", "1:9"), table_codes=(0xDB,))
    out["arith_gray_strips.tif"] = arith_tiff(writer, rgb[..., 1], 1, rows=16,
                                              opts=("-d", "0:1:4", "-k", "0:20", "-R", 2))
    prog4k = arith_transcode(writer, (GOLDENS / "codec_prog_4k.jpg").read_bytes())
    out[ARITH_4K] = jpeg_in_tiff([abbreviate(prog4k, ())[1]], 3840, 2160, 6, 3,
                                 subsampling=(2, 2))
    return out


def arith_digests(data: bytes) -> tuple[str, str]:
    """sha256 of a file and of Pillow's ``convert("RGB")`` of it."""
    from PIL import Image  # noqa: PLC0415

    return hashlib.sha256(data).hexdigest(), \
        rgb_digest(np.asarray(Image.open(io.BytesIO(data)).convert("RGB")))


if __name__ == "__main__":
    main()


# ---- 12-bit JPEG, ThunderScan, RLE-W and old-style JPEG TIFF ---------------------
# Pillow writes none of these, and the system's libjpeg is 8-bit only: the
# writers below are numpy.

# Huffman tables of every DC category 0..15 (5 bits each) and of every AC
# symbol: EOB, ZRL and each run 0..15 with each size 1..15 (8 bits each)
DC12 = (bytes([0, 0, 0, 0, 16] + [0] * 11), bytes(range(16)))
AC12 = (bytes([0] * 7 + [242] + [0] * 8),
        bytes([0x00, 0xF0] + [r << 4 | s for r in range(16) for s in range(1, 16)]))


def _category(v: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(T.81's magnitude category, the extra bits) of each int value."""
    cat = np.ceil(np.log2(np.abs(v) + 1)).astype(np.int64)
    return cat, np.where(v >= 0, v, v - 1) & ((1 << cat) - 1)


def jpeg12_coefficients(samples: np.ndarray, qtable, precision: int = 12) -> np.ndarray:
    """Quantised coefficients int64 [bh, bw, 64] (natural order) of one
    component's samples [h, w] (edge samples repeated to whole blocks):
    a float DCT of the samples less 2^(P-1), divided by ``qtable`` and
    rounded."""
    s = np.asarray(samples, np.float64)
    h, w = s.shape
    s = np.pad(s, ((0, -h % 8), (0, -w % 8)), mode="edge") - (1 << (precision - 1))
    k = np.arange(8)
    d = np.cos((2 * k[None, :] + 1) * k[:, None] * np.pi / 16) / 2
    d[0] /= np.sqrt(2)
    blocks = s.reshape(s.shape[0] // 8, 8, s.shape[1] // 8, 8).transpose(0, 2, 1, 3)
    c = d @ blocks @ d.T
    return np.rint(c.reshape(*c.shape[:2], 64) / np.asarray(qtable, np.float64)).astype(np.int64)


def make_jpeg12(coefs: np.ndarray, qtable, width: int, height: int, marker: int = 0xC1,
                restart: int = 0, precision: int = 12) -> bytes:
    """A one-component sequential Huffman JPEG (``marker`` SOF0 or SOF1)
    of quantised coefficients [bh, bw, 64] (natural order, bh x bw the
    blocks of ``width`` x ``height``) at ``precision`` bits, coded with
    :data:`DC12` and :data:`AC12` (no loop over blocks), a restart marker
    every ``restart`` blocks; a 16-bit DQT where a value passes 255."""
    from dspfun_tpu_torch.io.jpeg import ZIGZAG  # noqa: PLC0415

    bh, bw = coefs.shape[:2]
    zz = np.asarray(coefs, np.int64).reshape(bh * bw, 64)[:, list(ZIGZAG)]
    n = len(zz)
    step = restart or n
    dc = zz[:, 0].copy()
    prev = np.roll(dc, 1)
    prev[::step] = 0
    dcat, dbits = _category(dc - prev)
    dcodes, dlens = _huffman_codes(DC12)
    acodes, alens = _huffman_codes(AC12)
    blk, pos = np.nonzero(zz[:, 1:])
    pos = pos + 1
    last = np.zeros(len(pos), np.int64)
    same = np.flatnonzero(blk[1:] == blk[:-1]) + 1
    last[same] = pos[same - 1]
    run = pos - last - 1
    zrl = run // 16
    cat, bits = _category(zz[blk, pos])
    sym = (run % 16) << 4 | cat
    # tokens (block, position, order, code, length): DC, ZRLs, AC values, EOB
    ends = np.zeros(n, np.int64)
    ends[blk] = pos
    eob = np.flatnonzero(ends < 63)
    zb = np.repeat(np.arange(len(blk)), zrl)
    zorder = np.arange(len(zb)) - np.repeat(np.cumsum(zrl) - zrl, zrl)
    key_b = np.concatenate([np.arange(n), blk[zb], blk, eob])
    key_p = np.concatenate([np.zeros(n, np.int64), pos[zb], pos, np.full(len(eob), 64)])
    key_o = np.concatenate([np.zeros(n, np.int64), zorder, zrl, np.zeros(len(eob), np.int64)])
    vals = np.concatenate([dcodes[dcat] << dcat | dbits, np.full(len(zb), acodes[0xF0]),
                           acodes[sym] << cat | bits, np.full(len(eob), acodes[0])])
    lens = np.concatenate([dlens[dcat] + dcat, np.full(len(zb), alens[0xF0]),
                           alens[sym] + cat, np.full(len(eob), alens[0])])
    order = np.lexsort((key_o, key_p, key_b))
    key_b, vals, lens = key_b[order], vals[order], lens[order]
    q = np.asarray(qtable, np.int64)[list(ZIGZAG)]
    wide = int(q.max() > 255)
    out = b"\xff\xd8" + _jseg(0xDB, bytes([wide << 4]) + q.astype(">u2" if wide else np.uint8)
                              .tobytes())
    out += _jseg(marker, struct.pack(">BHHB", precision, height, width, 1) + bytes([1, 0x11, 0]))
    out += _jseg(0xC4, b"\x00" + DC12[0] + DC12[1]) + _jseg(0xC4, b"\x10" + AC12[0] + AC12[1])
    if restart:
        out += _jseg(0xDD, struct.pack(">H", restart))
    out += _jseg(0xDA, bytes([1, 1, 0x00, 0, 63, 0]))
    cuts = np.searchsorted(key_b, np.arange(0, n, step))
    for k, (a, b) in enumerate(zip(cuts, list(cuts[1:]) + [len(key_b)])):
        if k:
            out += bytes([0xFF, 0xD0 + (k - 1) % 8])
        out += _pack_codes(vals[a:b], lens[a:b])
    return out + b"\xff\xd9"


def jpeg_parts(data: bytes) -> dict:
    """The parts of a one-scan Huffman JPEG that an old-style JPEG TIFF
    holds as tags: quantisation tables (64 bytes, zigzag) and Huffman
    tables (16 counts and the values) by (class, id) or id, the frame's
    components ((id, h, v, tq) each), the scan's table selectors (per
    component, (dc, ac)), the restart interval, and the entropy-coded
    data cut at its restart markers (the segments, markers dropped)."""
    q, huff, dri, comps, sel, pos = {}, {}, 0, [], [], 2
    while True:
        code = data[pos + 1]
        n = struct.unpack_from(">H", data, pos + 2)[0]
        body = data[pos + 4:pos + 2 + n]
        pos += 2 + n
        if code == 0xDB:
            for k in range(0, len(body), 65):
                q[body[k] & 15] = body[k + 1:k + 65]
        elif code == 0xC4:
            k = 0
            while k < len(body):
                cnt = body[k + 1:k + 17]
                huff[body[k] >> 4, body[k] & 15] = cnt + body[k + 17:k + 17 + sum(cnt)]
                k += 17 + sum(cnt)
        elif code == 0xDD:
            dri = struct.unpack(">H", body)[0]
        elif code in (0xC0, 0xC1):
            comps = [(body[6 + 3 * c], body[7 + 3 * c] >> 4, body[7 + 3 * c] & 15, body[8 + 3 * c])
                     for c in range(body[5])]
        elif code == 0xDA:
            sel = [(body[2 + 2 * c] >> 4, body[2 + 2 * c] & 15) for c in range(body[0])]
            break
    end = data.rindex(b"\xff\xd9")
    segments = re.split(rb"\xff[\xd0-\xd7]", data[pos:end])
    return {"q": q, "huff": huff, "dri": dri, "comps": comps, "sel": sel, "segments": segments}


def make_ojpeg(jpeg: bytes, w: int, h: int, layout: str, bo: str = "<", rows=None,
               subsampling=None, photometric: int = 6, extra_tags=None) -> bytes:
    """An old-style JPEG TIFF (compression 6) of a baseline JPEG of w x h,
    in either layout libtiff's tif_ojpeg.c reads:

    * ``"jif"``: JPEGInterchangeFormat (513) and its length (514) point at
      the whole stream, which is also the one strip;
    * ``"tables"``: JPEGProc 1 (512), JPEGQTables, JPEGDCTables and
      JPEGACTables (519-521: one offset per component, to the bare
      tables), JPEGRestartInterval (515) where the stream has one, and the
      entropy-coded data in strips of ``rows`` rows (each strip one of
      the stream's restart intervals; the markers dropped, as libtiff
      puts them back between strips).

    YCbCrSubsampling (530) is ``subsampling``, or the frame's where None
    (and left out for one component); ``extra_tags`` are set last."""
    p = jpeg_parts(jpeg)
    spp = len(p["comps"])
    tags = {256: (4, [w]), 257: (4, [h]), 258: (3, [8] * spp), 259: (3, [6]),
            262: (3, [photometric]), 277: (3, [spp]), 284: (3, [1])}
    if spp == 3:
        tags[530] = (3, list(subsampling or p["comps"][0][1:3]))
    if layout == "jif":
        blocks = [jpeg]
        tags.update({273: (4, []), 278: (4, [h]), 279: (4, [len(jpeg)]), 513: (4, [8]),
                     514: (4, [len(jpeg)])})
    else:
        segs = p["segments"]
        nstrips = -(-h // (rows or h))
        if len(segs) != nstrips:
            raise ValueError(f"{len(segs)} restart intervals for {nstrips} strips")
        tables, at = [], 8 + sum(len(s) for s in segs)
        at += at % 2

        def offsets(items):
            nonlocal at
            out = {}
            for key, raw in items:
                out[key] = at
                tables.append(raw + b"\0" * (len(raw) % 2))
                at += len(raw) + len(raw) % 2
            return out

        qo = offsets(sorted(p["q"].items()))
        ho = offsets(sorted(p["huff"].items()))
        blocks = segs[:-1] + [segs[-1] + b"\0" * ((8 + sum(map(len, segs))) % 2)] + tables
        tags.update({273: (4, []), 278: (4, [rows or h]), 279: (4, [len(s) for s in segs]),
                     512: (3, [1]),
                     519: (4, [qo[c[3]] for c in p["comps"]]),
                     520: (4, [ho[0, s[0]] for s in p["sel"]]),
                     521: (4, [ho[1, s[1]] for s in p["sel"]])})
        if p["dri"]:
            tags[515] = (3, [p["dri"]])
        data = _assemble(blocks, tags | dict(extra_tags or {}), bo, index=range(nstrips))
        return data
    tags.update(extra_tags or {})
    return _assemble(blocks, tags, bo)


def thunder_encode(rows: np.ndarray, seed: int) -> bytes:
    """4-bit samples [h, w] as ThunderScan codes (libtiff's tif_thunder.c
    reads them), each row from a last pixel of 0, the code at each step
    drawn at random among those that fit: a run of the last pixel (up to
    63; now and then an empty one), three 2-bit deltas (0, +1, -1, with a
    skip where fewer pixels are left), two 3-bit deltas (-3..3, or one
    and a skip), or a raw value."""
    rng = np.random.default_rng(seed)
    d2, d3 = {0: 0, 1: 1, 15: 3}, {0: 0, 1: 1, 2: 2, 3: 3, 13: 5, 14: 6, 15: 7}
    out = bytearray()
    for row in np.asarray(rows, np.int64):
        last, k, w = 0, 0, len(row)
        while k < w:
            run = 0
            while k + run < w and run < 63 and row[k + run] == last:
                run += 1
            steps = [(row[j] - prev) % 16 for j, prev in zip(range(k, min(k + 3, w)),
                                                              [last, *row[k:k + 2]])]
            opts = ["raw"] + (["run"] if run else []) + (["empty"] if rng.random() < 0.05 else [])
            n2 = next((i for i, v in enumerate(steps) if v not in d2), len(steps))
            n3 = next((i for i, v in enumerate(steps[:2]) if v not in d3), len(steps[:2]))
            opts += (["d2"] if n2 else []) + (["d3"] if n3 else [])
            pick = opts[rng.integers(len(opts))]
            if pick == "run":
                n = int(rng.integers(1, run + 1))
                out.append(n)
                k += n
            elif pick == "empty":
                out.append(0)
            elif pick == "d2":
                n = int(rng.integers(1, n2 + 1))
                codes = [d2[v] for v in steps[:n]] + [2] * (3 - n)
                out.append(0x40 | codes[0] << 4 | codes[1] << 2 | codes[2])
                k += n
            elif pick == "d3":
                n = int(rng.integers(1, n3 + 1))
                codes = [d3[v] for v in steps[:n]] + [4] * (2 - n)
                out.append(0x80 | codes[0] << 3 | codes[1])
                k += n
            else:
                out.append(0xC0 | int(row[k]))
                k += 1
            last = row[k - 1] if k else last
    return bytes(out)


def thunder_tiff(rows: np.ndarray, seed: int, photometric: int = 1, rows_per_strip=None,
                 bo: str = "<", fill_order: int = 1, cmap=None, strip_codec=None) -> bytes:
    """A ThunderScan TIFF (compression 32809) of 4-bit samples [h, w], each
    strip's rows coded by :func:`thunder_encode` (``strip_codec``, a
    function of a strip's rows and its index, in its place)."""
    h, w = rows.shape
    rps = rows_per_strip or h
    code = strip_codec or (lambda r, k: thunder_encode(r, seed + k))
    blocks = [code(rows[y:y + rps], k) for k, y in enumerate(range(0, h, rps))]
    if fill_order == 2:
        blocks = [_BITREV[np.frombuffer(b, np.uint8)].tobytes() for b in blocks]
    tags = {256: (4, [w]), 257: (4, [h]), 258: (3, [4]), 259: (3, [32809]),
            262: (3, [photometric]), 273: (4, []), 277: (3, [1]), 278: (4, [rps]),
            279: (4, [len(b) for b in blocks])}
    if fill_order != 1:
        tags[266] = (3, [fill_order])
    if cmap is not None:
        tags[320] = (3, list(cmap))
    return _assemble(blocks, tags, bo)


def gray12(hw, seed: int, noise: float = 60.0) -> np.ndarray:
    """Seeded smooth 12-bit gray levels [h, w] (uint16, 0..4095) with noise."""
    h, w = hw
    y, x = np.mgrid[0:h, 0:w]
    rng = np.random.default_rng(seed)
    v = 2048 + 1500 * np.sin(x / 7 + seed) * np.cos(y / 5) + rng.normal(0, noise, (h, w))
    return np.clip(np.rint(v), 0, 4095).astype(np.uint16)


def q12() -> np.ndarray:
    """The quantisation table of the 12-bit fixtures (natural order): 1 at
    the DC, 2..64 by zigzag position."""
    from dspfun_tpu_torch.io.jpeg import ZIGZAG  # noqa: PLC0415

    q = np.empty(64, np.int64)
    q[list(ZIGZAG)] = np.arange(1, 65)
    return q


def tiff12(samples: np.ndarray, kind: str = "sof1", rows=None, tile=None, abbreviated=True,
           restart: int = 0, qtable=None, bo: str = "<") -> bytes:
    """A 12-bit gray JPEG-in-TIFF (BitsPerSample 12, photometric 1) of
    uint16 samples [h, w]: one stream a strip of ``rows`` rows or a tile
    of ``tile`` = (height, width) (the part past the image filled with the
    edge samples), each :func:`make_jpeg12` of its coefficients (``kind``
    "sof1" or "sof0") or :func:`make_lossless_jpeg` of its samples ("sof3",
    predictor 1), abbreviated under one JPEGTables where asked."""
    h, w = samples.shape
    q = q12() if qtable is None else qtable
    if tile:
        th, tw = tile
        full = np.pad(samples, ((0, -h % th), (0, -w % tw)), mode="edge")
        grid = [(y, x, th, tw) for y in range(0, h, th) for x in range(0, w, tw)]
    else:
        th, full = rows or h, samples
        grid = [(y, 0, min(th, h - y), w) for y in range(0, h, th)]
    streams, tables = [], None
    for y, x, bh, bw in grid:
        blk = full[y:y + bh, x:x + bw]
        if kind == "sof3":
            data = make_lossless_jpeg(blk, restart=restart, precision=12)
        else:
            data = make_jpeg12(jpeg12_coefficients(blk, q), q, bw, bh,
                               marker=0xC1 if kind == "sof1" else 0xC0, restart=restart)
        if abbreviated:
            tables, data = abbreviate(data)
        streams.append(data)
    tags = {256: (4, [w]), 257: (4, [h]), 258: (3, [12]), 259: (3, [7]), 262: (3, [1]),
            277: (3, [1]), 284: (3, [1])}
    if tile:
        tags.update({322: (3, [tile[1]]), 323: (3, [tile[0]]), 324: (4, []),
                     325: (4, [len(s) for s in streams])})
    else:
        tags.update({273: (4, []), 278: (4, [th]), 279: (4, [len(s) for s in streams])})
    if tables is not None:
        tags[347] = (7, list(tables))
    return _assemble(streams, tags, bo)


# phase 28's goldens: name -> how it is made (tests/test_torch_tiff_ojpeg.py
# and test_torch_tiff_12bit.py remake them and pin their digests)
OJPEG_GOLDENS = ("ojpeg_jif_420.tif", "ojpeg_tables_422_rst.tif", "ojpeg_jif_420_mm.tif",
                 "ojpeg_gray_tables.tif", "ojpeg_jif_444_refbw.tif", "ojpeg_4k.tif")
MORE_TIFF_GOLDENS = ("tiff12_sof1_strips.tif", "tiff12_sof3_tiles.tif", "thunderscan.tif",
                     "rlew_fill2.tif")
OJPEG_4K = "ojpeg_4k.tif"


def ojpeg_goldens() -> dict[str, bytes]:
    """Phase 28's old-style JPEG goldens, made from Pillow's baseline JPEGs
    of seeded levels: 77x53 4:2:0 in the JPEGInterchangeFormat layout,
    little- and big-endian; 96x64 4:2:2 in the tables layout, a restart
    every 2 MCU rows and a strip each; 61x45 gray in the tables layout; 4:4:4 with
    ReferenceBlackWhite; and the 3840x2160 levels of
    ``codec_prog_4k.jpg`` (4:2:0, a restart every 4 MCU rows) in 64-row
    strips of the tables layout."""
    from PIL import Image  # noqa: PLC0415

    def jpg(a, **kw):
        return _save(Image.fromarray(a), "JPEG", **kw)

    out = {"ojpeg_jif_420.tif": make_ojpeg(jpg(levels((53, 77), 90)), 77, 53, "jif")}
    out["ojpeg_tables_422_rst.tif"] = make_ojpeg(
        jpg(levels((64, 96), 91), subsampling=1, restart_marker_rows=2), 96, 64, "tables",
        rows=16)
    out["ojpeg_jif_420_mm.tif"] = make_ojpeg(jpg(levels((53, 77), 98)), 77, 53, "jif", bo=">")
    out["ojpeg_gray_tables.tif"] = make_ojpeg(jpg(levels((45, 61), 92)[..., 0]), 61, 45,
                                              "tables", photometric=1)
    out["ojpeg_jif_444_refbw.tif"] = make_ojpeg(jpg(levels((40, 56), 93), subsampling=0), 56, 40,
                                                "jif", extra_tags=REFBW)
    big = levels((2160, 3840), 17, noise=0.02)
    out[OJPEG_4K] = make_ojpeg(jpg(big, restart_marker_rows=4), 3840, 2160, "tables", rows=64)
    return out


def more_tiff_goldens() -> dict[str, bytes]:
    """Phase 28's 12-bit JPEG, ThunderScan and RLE-W goldens (no Pillow
    needed): 12-bit SOF1 in 16-row strips under one JPEGTables (64x45),
    12-bit lossless in 16x16 tiles (45x37, edge tiles), ThunderScan 4-bit
    gray (37x23, 8-row strips), RLE-W under FillOrder 2 (a 70x33 page in
    strips of 20 rows: libtiff's word alignment drops the bits it holds
    past a 16-bit multiple, so it reads most rows of this writer's
    strips otherwise than they were written, or fails on them; this one
    it reads)."""
    g = gray12((45, 64), 94)
    return {
        "tiff12_sof1_strips.tif": tiff12(g, "sof1", rows=16),
        "tiff12_sof3_tiles.tif": tiff12(gray12((37, 45), 95), "sof3", tile=(16, 16)),
        "thunderscan.tif": thunder_tiff((levels((23, 37), 96)[..., 0] >> 4), 96,
                                        rows_per_strip=8),
        "rlew_fill2.tif": make_tiff(doc_page(33, 70, 97)[..., None], "1", compression=32771,
                                    rows_per_strip=20, fill_order=2),
    }


def pillow_digests(data: bytes) -> tuple[str, str]:
    """sha256 of a TIFF and of Pillow's samples of it: its 16-bit gray
    array for mode ``I;16``, else its ``convert("RGB")``."""
    from PIL import Image  # noqa: PLC0415

    im = Image.open(io.BytesIO(data))
    if im.mode == "I;16":
        px = hashlib.sha256(np.asarray(im).astype("<u2").tobytes()).hexdigest()
    else:
        px = rgb_digest(np.asarray(im.convert("RGB")))
    return hashlib.sha256(data).hexdigest(), px


def port_digest(samples: np.ndarray) -> str:
    """The digest of :func:`pillow_digests` of the port's decode of it."""
    if samples.dtype == np.uint16:
        return hashlib.sha256(np.ascontiguousarray(samples, "<u2").tobytes()).hexdigest()
    return rgb_digest(samples)


# ---- item 8h's header-and-rows rasters (g1), written by hand --------------------
# Pillow writes XBM, MSP (version 1) and SPIDER; the rest, and the forms
# Pillow does not write, are written here with numpy (no Pillow), so the
# card's machine can make phase 30's 4K files itself.


def _card(key: str, value) -> bytes:
    """One 80-byte FITS card (``value`` None: the key alone)."""
    if value is None:
        return key.encode().ljust(80)
    if isinstance(value, bool):
        value = "T" if value else "F"
    return f"{key:<8}= {value!s:>20}".encode().ljust(80)


def _fits_block(cards) -> bytes:
    data = b"".join(_card(k, v) for k, v in cards) + _card("END", None)
    return data.ljust(-(-len(data) // 2880) * 2880)


_FITS_TYPES = {8: ">u1", 16: ">i2", 32: ">i4", -32: ">f4", -64: ">f8"}


def make_fits(samples: np.ndarray, bitpix: int, cards=(), naxis: int | None = None) -> bytes:
    """A primary-HDU FITS image: ``samples`` [h, w] as BITPIX big-endian
    samples, FITS row 0 first; ``cards`` extra (key, value) cards before
    END; ``naxis`` 1 writes NAXIS1 = h alone (a column)."""
    h, w = samples.shape
    axes = [("NAXIS", 1), ("NAXIS1", h)] if naxis == 1 else [("NAXIS", 2), ("NAXIS1", w),
                                                            ("NAXIS2", h)]
    head = _fits_block([("SIMPLE", True), ("BITPIX", bitpix), *axes, *cards])
    data = np.ascontiguousarray(samples, _FITS_TYPES[bitpix]).tobytes()
    return head + data.ljust(-(-len(data) // 2880) * 2880, b"\0")


def make_fits_gzip(samples: np.ndarray, bitpix: int, level: int = 6) -> bytes:
    """A tile-compressed FITS image as Pillow's ``FitsGzipDecoder`` reads
    it: a data-less primary HDU, then a BINTABLE HDU (``ZIMAGE`` T,
    ``ZCMPTYPE`` 'GZIP_1') whose one-row table (an 8-byte descriptor) is
    followed by the gzip of the samples as 4-byte big-endian integers."""
    h, w = samples.shape
    body = gzip_bytes(np.ascontiguousarray(samples, ">i4").tobytes(), level)
    table = struct.pack(">II", len(body), 0)
    head = _fits_block([("SIMPLE", True), ("BITPIX", 8), ("NAXIS", 0), ("EXTEND", True)])
    ext = _fits_block([("XTENSION", "'BINTABLE'"), ("BITPIX", 8), ("NAXIS", 2),
                       ("NAXIS1", 8), ("NAXIS2", 1), ("PCOUNT", len(body)), ("GCOUNT", 1),
                       ("TFIELDS", 1), ("TTYPE1", "'COMPRESSED_DATA'"),
                       ("TFORM1", f"'1PB({len(body)})'"), ("ZIMAGE", True),
                       ("ZBITPIX", bitpix), ("ZNAXIS", 2), ("ZNAXIS1", w), ("ZNAXIS2", h),
                       ("ZCMPTYPE", "'GZIP_1  '")])
    data = table + body
    return head + ext + data.ljust(-(-len(data) // 2880) * 2880, b"\0")


def gzip_bytes(data: bytes, level: int = 6) -> bytes:
    """A gzip member with no name and time 0 (the same bytes every run)."""
    import gzip  # noqa: PLC0415

    return gzip.compress(data, level, mtime=0)


def sun_rle(data: bytes) -> bytes:
    """Sun's type-2 run-length code of a byte stream (runs may cross rows,
    as Pillow reads them): a run of 3 to 256 ``0x80 n-1 v``, a 0x80 alone
    ``0x80 0``, two 0x80s a run, other bytes as they are; numpy, for 4K."""
    a = np.frombuffer(data, np.uint8)
    if not a.size:
        return b""
    starts = np.flatnonzero(np.r_[True, a[1:] != a[:-1]])
    lengths = np.diff(np.r_[starts, a.size])
    values = a[starts]
    chunks = -(-lengths // 256)                         # runs of at most 256
    cval = np.repeat(values, chunks)
    first = np.repeat(np.cumsum(chunks) - chunks, chunks)
    k = np.arange(cval.size) - first
    clen = np.minimum(256, np.repeat(lengths, chunks) - 256 * k)
    is80 = cval == 0x80
    run = (clen >= 3) | (is80 & (clen == 2))
    single80 = is80 & (clen == 1)
    size = np.where(run, 3, np.where(single80, 2, clen))
    at = np.cumsum(size) - size
    out = np.empty(int(size.sum()), np.uint8)
    lit = ~run & ~single80
    lit_at = np.repeat(at[lit], clen[lit]) + (np.arange(int(clen[lit].sum()))
                                              - np.repeat(np.cumsum(clen[lit]) - clen[lit],
                                                          clen[lit]))
    out[lit_at] = np.repeat(cval[lit], clen[lit])
    out[at[run]], out[at[run] + 1], out[at[run] + 2] = 0x80, clen[run] - 1, cval[run]
    out[at[single80]], out[at[single80] + 1] = 0x80, 0
    return out.tobytes()


def make_sun(rows: np.ndarray, width: int, depth: int, ftype: int = 1, palette: bytes = b"",
             maptype: int = 1) -> bytes:
    """A Sun raster of ``rows`` uint8 [h, bytes] (each row's samples as the
    file holds them: bits MSB first, BGR or, type 3, RGB), padded to 16
    bits for the raw types, run-length coded unpadded for type 2; a colour
    map ``palette`` (all reds, then greens, then blues)."""
    h, rowbytes = rows.shape
    if ftype == 2:
        data = sun_rle(rows.tobytes())
    else:
        stride = ((width * depth + 15) // 16) * 2
        data = np.pad(rows, ((0, 0), (0, stride - rowbytes))).tobytes()
    head = struct.pack(">8I", 0x59A66A95, width, h, depth, len(data), ftype,
                       maptype if palette else 0, len(palette))
    return head + palette + data


def make_xpm(indices: np.ndarray, colors: list, bpp: int = 1, none_key: bytes | None = None,
             pixels_line: bool = True) -> bytes:
    """An XPM of palette indices [h, w] over ``colors`` (RGB tuples), each
    colour a key of ``bpp`` characters; ``none_key`` adds a ``c None``
    entry (counted in the colours, used by no pixel)."""
    chars = "".join(chr(c) for c in range(35, 127) if chr(c) not in '"\\')
    keys = []
    for i in range(len(colors)):
        k, j = "", i
        for _ in range(bpp):
            k, j = k + chars[j % len(chars)], j // len(chars)
        keys.append(k.encode())
    h, w = indices.shape
    n = len(colors) + (none_key is not None)
    out = [b"/* XPM */", b"static char *image[] = {", b"/* columns rows colors chars */",
           f'"{w} {h} {n} {bpp}",'.encode()]
    if none_key is not None:
        out.append(b'"' + none_key + b' c None",')
    out += [b'"' + k + b" c #%02x%02x%02x" % tuple(c) + b'",' for k, c in zip(keys, colors)]
    if pixels_line:
        out.append(b"/* pixels */")
    out += [b'"' + b"".join(keys[i] for i in row) + b'",' for row in indices]
    return b"\n".join(out) + b"\n};\n"


def msp_rle_row(row: bytes) -> bytes:
    """One MSP version 2 row: runs of 3 to 255 equal bytes ``0 n v``, the
    bytes between them literal packets of at most 255."""
    out, at = bytearray(), 0
    for m in re.finditer(rb"(.)\1{2,254}", row, re.S):
        for k in range(at, m.start(), 255):
            lit = row[k:min(k + 255, m.start())]
            out += bytes([len(lit)]) + lit
        out += bytes([0, m.end() - m.start()]) + m.group(1)
        at = m.end()
    for k in range(at, len(row), 255):
        lit = row[k:k + 255]
        out += bytes([len(lit)]) + lit
    return bytes(out)


def make_msp(rows: np.ndarray, width: int, version: int = 2, blank=()) -> bytes:
    """An MSP of packed 1-bit rows [h, (w + 7) // 8] (a set bit white):
    version 1 raw, or version 2 with its row map and run-length rows (the
    rows in ``blank`` written with length 0, a white row)."""
    h = rows.shape[0]
    words = [0] * 16
    words[0], words[1] = struct.unpack("<HH", b"DanM" if version == 1 else b"LinS")
    words[2], words[3], words[4:8], words[8], words[9] = width, h, [1, 1, 1, 1], width, h
    for wd in words[:12] + words[13:]:
        words[12] ^= wd
    head = struct.pack("<16H", *words)
    if version == 1:
        return head + rows.tobytes()
    coded = [b"" if y in blank else msp_rle_row(rows[y].tobytes()) for y in range(h)]
    return head + struct.pack(f"<{h}H", *map(len, coded)) + b"".join(coded)


def make_spider(image: np.ndarray, order: str = ">", stack: int = 0) -> bytes:
    """A SPIDER image of float32 [h, w] (``order`` its byte order), alone
    or (``stack`` > 0) as the first of a stack of ``stack`` images: the
    stack's header, then each image's header and samples."""
    h, w = image.shape
    lenbyt = 4 * w
    labrec = -(-1024 // lenbyt)
    labbyt = labrec * lenbyt

    def header(istack, imgnum, maxim):
        v = np.zeros(labbyt // 4, np.float64)
        v[[0, 1, 4, 11, 12, 21, 22]] = [1, h, 1, w, labrec, labbyt, lenbyt]
        v[23], v[25], v[26] = istack, maxim, imgnum
        return v.astype(order + "f4").tobytes()

    body = np.ascontiguousarray(image, order + "f4").tobytes()
    if not stack:
        return header(0, 0, 0) + body
    return header(2, 0, stack) + b"".join(header(0, k + 1, 0) + body for k in range(stack))


def make_pixar(rgb: np.ndarray, chan: int = 14, depth: int = 2) -> bytes:
    """A PIXAR picture: the 1024-byte header (the size at 418 and 416, the
    channel and depth words at 424 and 426), RGB samples after it."""
    h, w, _ = rgb.shape
    head = bytearray(1024)
    head[:4] = b"\x80\xe8\x00\x00"
    struct.pack_into("<HH", head, 416, h, w)
    struct.pack_into("<HH", head, 424, chan, depth)
    return bytes(head) + np.ascontiguousarray(rgb, np.uint8).tobytes()


def make_mcidas(samples: np.ndarray, nbytes: int, prefix: int = 0, offset: int = 256) -> bytes:
    """A McIdas area of one band, ``nbytes`` big-endian bytes a sample,
    each line after ``prefix`` bytes, the data at ``offset``."""
    h, w = samples.shape
    words = np.zeros(65, np.int64)
    words[2], words[9], words[10], words[11], words[14] = 4, h, w, nbytes, 1
    words[15], words[34] = prefix, offset
    head = words[1:].astype(">i4").tobytes().ljust(offset, b"\0")
    dtype = {1: ">u1", 2: ">u2", 4: ">i4"}[nbytes]
    lines = np.ascontiguousarray(samples, dtype).view(np.uint8).reshape(h, -1)
    return head + np.pad(lines, ((0, 0), (prefix, 0)), constant_values=7).tobytes()


def make_xvthumb(indices: np.ndarray, comments=(b"#XVVERSION:Version 3.10a",
                                                b"#END_OF_COMMENTS")) -> bytes:
    """An XV thumbnail of 3-3-2 palette indices [h, w]."""
    h, w = indices.shape
    return b"P7 332\n" + b"".join(c + b"\n" for c in comments) + f"{w} {h} 255\n".encode() \
        + np.ascontiguousarray(indices, np.uint8).tobytes()


def make_gbr(pixels: np.ndarray, version: int = 2, name: bytes = b"brush",
             spacing: int = 25) -> bytes:
    """A GIMP brush of uint8 [h, w] (depth 1) or [h, w, 4] (depth 4)."""
    h, w = pixels.shape[:2]
    depth = 1 if pixels.ndim == 2 else pixels.shape[2]
    comment = name + b"\0"
    size = (20 if version == 1 else 28) + len(comment)
    head = struct.pack(">5I", size, version, w, h, depth)
    if version == 2:
        head += b"GIMP" + struct.pack(">I", spacing)
    return head + comment + np.ascontiguousarray(pixels, np.uint8).tobytes()


def make_imt(gray: np.ndarray, extra=(b"* an IM Tools image",)) -> bytes:
    """An IM Tools image: ``key value`` lines, a form feed, 8-bit rows."""
    h, w = gray.shape
    lines = [*extra, f"width {w}".encode(), f"height {h}".encode(), b"pixel n8"]
    return b"\n".join(lines) + b"\n\x0c" + np.ascontiguousarray(gray, np.uint8).tobytes()


def _raster_planes(hw=(30, 45), seed=61) -> tuple:
    """A seeded picture's RGB levels and gray, 16-bit, 32-bit and float
    planes of it."""
    rgb = levels(hw, seed, noise=0.05)
    g = rgb[..., 1].astype(np.int64)
    return (rgb, g, g * 257 - 32768, (g - 128) * 16_777_259 + g,
            (g.astype(np.float64) - 60.0) * 1.37)


def raster_goldens() -> dict[str, bytes]:
    """Phase 30's small goldens, a file per g1 kind and variant (Pillow's
    writes of XBM, MSP version 1 and SPIDER; the rest from the writers
    above): FITS at every BITPIX, NAXIS 1 and GZIP_1; Sun rasters at every
    depth, with colour maps, type 3 and type 2 (RLE); XBM with and without
    a hotspot; XPM with a ``None`` colour and above 256 colours; MSP
    versions 1 and 2; SPIDER little- and big-endian and a stack; PIXAR;
    McIdas at 1, 2 and 4 bytes; XV thumbnail; GBR versions 1 and 2; IMT."""
    from PIL import Image  # noqa: PLC0415

    rgb, g, g16, g32, gf = _raster_planes()
    h, w = g.shape
    bits = (g > 150) ^ (np.arange(w) % 7 == 0)
    bgr = rgb[..., ::-1].reshape(h, -1)
    pal = bytes(np.concatenate([np.arange(16) * 17, np.arange(16)[::-1] * 16,
                                (np.arange(16) * 5) % 256]).astype(np.uint8))
    idx = (g // 32).astype(np.uint8)
    colors = [(40 * k % 256, 255 - 30 * k, 90 + 20 * k) for k in range(8)]
    many = (g[:, :, None] * [1, 3, 7] % 256).astype(np.uint8).reshape(-1, 3)
    uniq, inv = np.unique(many, axis=0, return_inverse=True)
    out = {
        "raster_fits8.fits": make_fits(g, 8),
        "raster_fits16.fits": make_fits(g16, 16),
        "raster_fits32.fits": make_fits(g32, 32, cards=[("BSCALE", 1), ("BZERO", 0)]),
        "raster_fitsm32.fits": make_fits(gf, -32),
        "raster_fitsm64.fits": make_fits(gf, -64),
        "raster_fits_naxis1.fits": make_fits(g16[:, :1], 16, naxis=1),
        "raster_fits_gzip16.fits": make_fits_gzip(g16, 16),
        "raster_fits_gzip32.fits": make_fits_gzip(g32, 32),
        "raster_sun1.ras": make_sun(np.packbits(bits, axis=1), w, 1),
        "raster_sun4.ras": make_sun((idx[:, 0::2] << 4 | np.pad(idx, ((0, 0), (0, 1)))[:, 1::2]
                                     [:, :(w + 1) // 2]), w, 4),
        "raster_sun4_map.ras": make_sun((idx[:, 0::2] << 4 | np.pad(idx, ((0, 0), (0, 1)))
                                         [:, 1::2][:, :(w + 1) // 2]), w, 4, palette=pal),
        "raster_sun8.ras": make_sun(g.astype(np.uint8), w, 8),
        "raster_sun8_map.ras": make_sun(idx * 2, w, 8, palette=pal),
        "raster_sun24.ras": make_sun(bgr, w, 24),
        "raster_sun24_rgb.ras": make_sun(rgb.reshape(h, -1), w, 24, ftype=3),
        "raster_sun32.ras": make_sun(np.concatenate([rgb[..., ::-1], g[..., None] % 7], -1)
                                     .astype(np.uint8).reshape(h, -1), w, 32),
        "raster_sun_rle8.ras": make_sun((g // 16 * 16).astype(np.uint8), w, 8, ftype=2),
        "raster_sun_rle24.ras": make_sun(bgr // 8 * 8, w, 24, ftype=2),
        "raster_xbm.xbm": _save(Image.fromarray(bits), "XBM"),
        "raster_xbm_hot.xbm": _save(Image.fromarray(bits[:17, :20]), "XBM", hotspot=(5, 9)),
        "raster_xpm.xpm": make_xpm(idx, colors),
        "raster_xpm_none.xpm": make_xpm(idx, colors, none_key=b" "),
        "raster_xpm_rgb.xpm": make_xpm(inv.reshape(h, w), [tuple(c) for c in uniq], bpp=2),
        "raster_msp1.msp": _save(Image.fromarray(bits), "MSP"),
        "raster_msp2.msp": make_msp(np.packbits(bits, axis=1), w, blank=(3,)),
        "raster_spider.spi": _save(Image.fromarray(gf.astype(np.float32)), "SPIDER"),
        "raster_spider_be.spi": make_spider(gf.astype(np.float32)),
        "raster_spider_stack.spi": make_spider(gf.astype(np.float32)[::-1], "<", stack=2),
        "raster_pixar.pxr": make_pixar(rgb),
        "raster_mcidas8.area": make_mcidas(g, 1),
        "raster_mcidas16.area": make_mcidas(g16 & 0xFFFF, 2, prefix=4),
        "raster_mcidas32.area": make_mcidas(g32, 4, prefix=8, offset=512),
        "raster_xv.xv": make_xvthumb(rgb[..., 0] // 32 * 32 | rgb[..., 1] // 32 * 4
                                     | rgb[..., 2] // 64),
        "raster_gbr1.gbr": make_gbr(g.astype(np.uint8), 1),
        "raster_gbr2.gbr": make_gbr(np.concatenate([rgb, g[..., None]], -1).astype(np.uint8)),
        "raster_imt.imt": make_imt(g.astype(np.uint8)),
    }
    return out


RASTER_NAMES = (
    "raster_fits8.fits", "raster_fits16.fits", "raster_fits32.fits", "raster_fitsm32.fits",
    "raster_fitsm64.fits", "raster_fits_naxis1.fits", "raster_fits_gzip16.fits",
    "raster_fits_gzip32.fits", "raster_sun1.ras", "raster_sun4.ras", "raster_sun4_map.ras",
    "raster_sun8.ras", "raster_sun8_map.ras", "raster_sun24.ras", "raster_sun24_rgb.ras",
    "raster_sun32.ras", "raster_sun_rle8.ras", "raster_sun_rle24.ras", "raster_xbm.xbm",
    "raster_xbm_hot.xbm", "raster_xpm.xpm", "raster_xpm_none.xpm", "raster_xpm_rgb.xpm",
    "raster_msp1.msp", "raster_msp2.msp", "raster_spider.spi", "raster_spider_be.spi",
    "raster_spider_stack.spi", "raster_pixar.pxr", "raster_mcidas8.area",
    "raster_mcidas16.area", "raster_mcidas32.area", "raster_xv.xv", "raster_gbr1.gbr",
    "raster_gbr2.gbr", "raster_imt.imt")
# the goldens Pillow writes (remade with Pillow); the rest are numpy's
RASTER_PILLOW = ("raster_xbm.xbm", "raster_xbm_hot.xbm", "raster_msp1.msp", "raster_spider.spi")


def raster_fixtures() -> dict[str, bytes]:
    """Phase 30's goldens, as tests/goldens/ holds them."""
    return {name: (GOLDENS / name).read_bytes() for name in RASTER_NAMES}


def raster_picture(hw=(2160, 3840), seed: int = 71) -> np.ndarray:
    """A seeded RGB picture with runs for run-length codes: gray squares of
    16 pixels (equal bytes across B, G and R), seeded noise of up to 6
    levels a channel in a quarter of its 64-pixel blocks (literal bytes;
    soft enough that spec's 16-bit spectrum of it compresses)."""
    h, w = hw
    rng = np.random.default_rng(seed)
    y, x = np.ogrid[0:h, 0:w]
    rgb = np.repeat((((x // 16 + y // 16) % 8) * 32 + 16).astype(np.uint8)[..., None], 3, -1)
    blocks = rng.random((-(-h // 64), -(-w // 64))) < 0.25
    mask = np.repeat(np.repeat(blocks, 64, 0), 64, 1)[:h, :w]
    noise = rng.integers(-6, 7, (int(mask.sum()), 3))
    rgb[mask] = (rgb[mask].astype(np.int64) + noise).astype(np.uint8)
    return rgb


def g3_pixels(kind: str, hw=(72, 136), seed: int = 29) -> np.ndarray:
    """The seeded samples of the g3 goldens (``chip_smoke.DOCUMENT_GOLDENS``):
    smooth ramps with a little noise and an all-zero corner (code-blocks
    with no pass), uint8 [H, W, 3] for ``RGB``, [H, W, 4] for ``RGBA`` (a
    soft alpha ramp), uint16 [H, W] for ``I;16``."""
    h, w = hw
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    top = 65535 if kind == "I;16" else 255
    ramps = [(x * 7 + y * 3) % (top + 1), top // 2 + (top // 3) * np.sin(x / 9.0 + y / 13.0),
             (y * top) // max(1, h - 1), top - (x * top) // max(1, w - 1)]
    planes = []
    for c in range({"RGB": 3, "RGBA": 4, "I;16": 1}[kind]):
        p = np.asarray(ramps[c], np.float64) + rng.integers(-3, 4, (h, w)) * (top // 255)
        p[: h // 3, : w // 3] = 0
        planes.append(np.clip(np.rint(p), 0, top))
    out = np.stack(planes, -1).astype(np.uint16 if kind == "I;16" else np.uint8)
    return out[..., 0] if kind == "I;16" else out


def raster_4k(kind: str, rgb: np.ndarray | None = None) -> bytes:
    """Phase 30's 4K files, made with numpy alone from :func:`raster_picture`
    (or ``rgb``): ``sun`` a 24-bit type-2 (RLE) Sun raster, ``fits`` a
    BITPIX 16 FITS of its green levels."""
    rgb = raster_picture() if rgb is None else rgb
    h, w, _ = rgb.shape
    if kind == "sun":
        return make_sun(rgb[..., ::-1].reshape(h, -1), w, 24, ftype=2)
    return make_fits(rgb[..., 1].astype(np.int64) * 257 - 32768, 16)


# ---- item 8h's containers (g2), written by hand ---------------------------------
# Pillow writes ICNS and BLP from P images; the rest (FTEX, BLP DXT, raw and
# JPEG, FLI chunks, PCD, IPTC, ICNS RLE and JPEG 2000 payloads) are written
# here with numpy (no Pillow), so the card's machine can make phase 31's 4K
# files itself.


def bc1_blocks(rgb: np.ndarray, rows: int = 32) -> bytes:
    """A plain BC1 (DXT1) encoder of uint8 [H, W, 3]: per 4x4 block (edges
    padded by repetition) the 5:6:5 of its darkest and brightest pixels,
    the larger first (4-colour mode), each pixel the index of the nearest
    of the four colours; ``rows`` block rows at a time."""
    h, w, _ = rgb.shape
    bh, bw = -(-h // 4), -(-w // 4)
    p = np.pad(rgb, ((0, 4 * bh - h), (0, 4 * bw - w), (0, 0)), mode="edge")
    return b"".join(_bc1_slab(p[4 * r:4 * (r + rows)].astype(np.int64))
                    for r in range(0, bh, rows))


def _bc1_slab(p: np.ndarray) -> bytes:
    bh, bw = p.shape[0] // 4, p.shape[1] // 4
    blocks = p.reshape(bh, 4, bw, 4, 3).transpose(0, 2, 1, 3, 4).reshape(bh, bw, 16, 3)
    luma = blocks @ np.array([2, 4, 1])
    lo = np.take_along_axis(blocks, luma.argmin(-1)[..., None, None], 2)[..., 0, :]
    hi = np.take_along_axis(blocks, luma.argmax(-1)[..., None, None], 2)[..., 0, :]

    def pack(c):
        return (c[..., 0] >> 3) << 11 | (c[..., 1] >> 2) << 5 | c[..., 2] >> 3

    c0, c1 = pack(hi), pack(lo)
    swap = c0 < c1
    c0, c1 = np.where(swap, c1, c0), np.where(swap, c0, c1)

    def unpack(c):
        r, g, b = c >> 11 & 31, c >> 5 & 63, c & 31
        return np.stack([r << 3 | r >> 2, g << 2 | g >> 4, b << 3 | b >> 2], -1)

    e0, e1 = unpack(c0), unpack(c1)
    pal = np.stack([e0, e1, (2 * e0 + e1) // 3, (e0 + 2 * e1) // 3], 2)     # [bh, bw, 4, 3]
    dist = ((blocks[:, :, :, None, :] - pal[:, :, None, :, :]) ** 2).sum(-1)
    idx = np.where((c0 == c1)[..., None], 0, dist.argmin(-1))
    code = (idx << (2 * np.arange(16))).sum(-1)
    out = np.zeros((bh, bw, 8), np.uint8)
    out[..., 0], out[..., 1] = c0 & 255, c0 >> 8
    out[..., 2], out[..., 3] = c1 & 255, c1 >> 8
    for k in range(4):
        out[..., 4 + k] = code >> (8 * k) & 255
    return out.tobytes()


def make_ftex(payload: bytes, w: int, h: int, fmt: int = 0, nformats: int = 1,
              where: int | None = None, size: int | None = None) -> bytes:
    """An FTEX file: the header, one format (0 DXT1, 1 raw RGB) and its
    mipmap (its length word, ``size`` if given, then ``payload``)."""
    where = 32 if where is None else where
    head = b"FTEX" + struct.pack("<5i", 1, w, h, 1, nformats) + struct.pack("<2i", fmt, where)
    head = head.ljust(where, b"\0")
    return head + struct.pack("<i", len(payload) if size is None else size) + payload


def make_blp(w: int, h: int, mip: bytes, version: int = 2, compression: int = 1,
             encoding: int = 2, alpha: int = 0, alpha_encoding: int = 0,
             palette: bytes = b"", jpeg_header: bytes = b"", offset: int | None = None,
             length: int | None = None) -> bytes:
    """A BLP file of one mipmap: BLP1 (``version`` 1: JPEG when
    ``compression`` is 0, with ``jpeg_header`` shared; else palette of
    ``encoding`` 4 or 5) or BLP2 (palette encoding 1, DXT encoding 2 with
    ``alpha_encoding`` 0, 1 or 7); ``palette`` the 256 BGRA entries (zeros
    when empty), ``offset`` and ``length`` the first mipmap's table
    entries (where it lies, and its size, by default)."""
    if version == 1:
        head = b"BLP1" + struct.pack("<iIII", compression, alpha, w, h) \
            + struct.pack("<ii", encoding, 0)
    else:
        head = b"BLP2" + struct.pack("<ibbbbII", compression, encoding, alpha, alpha_encoding, 0,
                                     w, h)
    fixed = len(head) + 128
    if version == 1 and compression == 0:
        body = struct.pack("<I", len(jpeg_header)) + jpeg_header
    else:
        body = palette.ljust(1024, b"\0")
    at = fixed + len(body) if offset is None else offset
    tables = struct.pack("<16I", at, *(0,) * 15) \
        + struct.pack("<16I", len(mip) if length is None else length, *(0,) * 15)
    out = head + tables + body
    return out + bytes(max(0, at - len(out))) + mip


def fli_chunk(kind: int, body: bytes, pad: bool = True) -> bytes:
    """One FLI subchunk: its size, type and body (padded to an even size)."""
    if pad and len(body) % 2:
        body += b"\0"
    return struct.pack("<IH", 6 + len(body), kind) + body


def fli_color(entries, kind: int = 4) -> bytes:
    """A colour chunk (4: 256-level, 11: 64-level) of (skip, [(r, g, b),
    ...]) packets; a packet of 256 entries has the count 0."""
    body = struct.pack("<H", len(entries))
    for skip, rgb in entries:
        body += bytes([skip, len(rgb) & 255]) + bytes(np.asarray(rgb, np.uint8).ravel())
    return fli_chunk(kind, body)


def fli_brun(idx: np.ndarray) -> bytes:
    """BRUN (15) of uint8 [H, W]: per row a packet count byte (unread),
    then runs (count, value) of equal bytes and literals (-count, bytes)."""
    body = bytearray()
    for row in idx:
        body.append(0)
        x, w = 0, len(row)
        while x < w:
            run = 1
            while x + run < w and run < 127 and row[x + run] == row[x]:
                run += 1
            if run >= 3:
                body += bytes([run, row[x]])
                x += run
                continue
            n = 1
            while x + n < w and n < 127 and not (x + n + 2 < w and row[x + n] == row[x + n + 1]
                                                 == row[x + n + 2]):
                n += 1
            body += bytes([256 - n]) + bytes(row[x:x + n])
            x += n
    return fli_chunk(15, bytes(body))


def fli_lc(rows: dict, y0: int, nlines: int) -> bytes:
    """LC (12): lines y0.. y0 + nlines, each a list of (skip, run or
    literal) packets: ("r", n, v) or ("l", bytes)."""
    body = bytearray(struct.pack("<HH", y0, nlines))
    for y in range(y0, y0 + nlines):
        packets = rows.get(y, [])
        body.append(len(packets))
        for skip, p in packets:
            body += bytes([skip, 256 - p[1], p[2]]) if p[0] == "r" else \
                bytes([skip, len(p[1])]) + p[1]
    return fli_chunk(12, bytes(body))


def fli_ss2(lines: list) -> bytes:
    """SS2 (7): per line its packet words (skip words 0xC000 | -n, the odd
    width's last-byte word 0x8000 | v, then the count) and its packets
    (skip, ("r", n, (a, b)) or ("l", bytes of even length))."""
    body = bytearray(struct.pack("<H", len(lines)))
    for words, packets in lines:
        for wd in words:
            body += struct.pack("<H", wd & 0xFFFF)
        body += struct.pack("<H", len(packets))
        for skip, p in packets:
            body += bytes([skip, 256 - p[1], *p[2]]) if p[0] == "r" else \
                bytes([skip, len(p[1]) // 2]) + p[1]
    return fli_chunk(7, bytes(body))


def make_fli(w: int, h: int, chunks, magic: int = 0xAF12, frames: int = 1,
             prefix: bytes | None = None, framesize: int | None = None, flags: int = 3) -> bytes:
    """An FLI (0xAF11) or FLC (0xAF12) file whose first frame (0xF1FA)
    holds ``chunks``; ``prefix`` a prefix chunk's body put before it."""
    head = bytearray(128)
    struct.pack_into("<IHHHHHH", head, 0, 0, magic, frames, w, h, 8, flags)
    struct.pack_into("<I", head, 16, 5)
    body = b"".join(chunks)
    frame = struct.pack("<IHH8x", 16 + len(body) if framesize is None else framesize, 0xF1FA,
                        len(chunks)) + body
    pre = b"" if prefix is None else struct.pack("<IH", 6 + len(prefix), 0xF100) + prefix
    out = bytes(head) + pre + frame
    struct.pack_into("<I", head, 0, len(out))
    return bytes(head) + out[128:]


def make_pcd(y: np.ndarray, cb: np.ndarray, cr: np.ndarray, orientation: int = 0) -> bytes:
    """A PhotoCD file of its base image: the ``PCD_`` tag at 2048, the
    orientation byte at 2048 + 1538, and at 96 * 2048 the 256 pairs of
    luma rows (uint8 [512, 768]), each followed by its Cb and Cr rows
    (uint8 [256, 384])."""
    head = bytearray(96 * 2048)
    head[2048:2052] = b"PCD_"
    head[2048 + 1538] = orientation
    body = np.concatenate([y.reshape(256, 2 * 768), cb, cr], axis=1).astype(np.uint8)
    return bytes(head) + body.tobytes()


def iptc_field(record: int, tag: int, data: bytes, extended: int = 0) -> bytes:
    """One IPTC field: 0x1C, its record and tag, a 2-byte length (or, with
    ``extended`` 1-4, 0x8000 | extended and that many length bytes)."""
    if extended:
        return bytes([0x1C, record, tag, 0x80, extended]) \
            + len(data).to_bytes(extended, "big") + data
    return bytes([0x1C, record, tag]) + struct.pack(">H", len(data)) + data


def make_iptc(w: int, h: int, image: bytes, layers: int = 1, component: int = 0,
              compression: int = 1, band: int | None = None, chunk: int = 0,
              extra=()) -> bytes:
    """An IPTC/NAA image: record 2's caption, record 3's fields (3, 20)
    width, (3, 30) height, (3, 60) layers and component, (3, 65) the band,
    (3, 120) compression, then the image in (8, 10) records of ``chunk``
    bytes (all in one when 0)."""
    f = [iptc_field(2, 120, b"a caption"), *extra,
         iptc_field(3, 20, struct.pack(">I", w)), iptc_field(3, 30, struct.pack(">H", h)),
         iptc_field(3, 60, bytes([layers, component]))]
    if band is not None:
        f.append(iptc_field(3, 65, bytes([band])))
    f.append(iptc_field(3, 120, bytes([compression])))
    step = chunk or max(len(image), 1)
    f += [iptc_field(8, 10, image[k:k + step]) for k in range(0, max(len(image), 1), step)]
    return b"".join(f)


def icns_rle(band: np.ndarray) -> bytes:
    """ICNS's RLE of one 8-bit band: runs of 3 to 130 equal bytes as
    ``0x80 + n - 3`` and the byte, literals of up to 128 as ``n - 1`` and
    the bytes."""
    v, out, x = bytes(np.asarray(band, np.uint8).ravel()), bytearray(), 0
    while x < len(v):
        run = 1
        while x + run < len(v) and run < 130 and v[x + run] == v[x]:
            run += 1
        if run >= 3:
            out += bytes([0x80 + run - 3, v[x]])
            x += run
            continue
        n = 1
        while x + n < len(v) and n < 128 and not (x + n + 2 < len(v) and v[x + n] == v[x + n + 1]
                                                  == v[x + n + 2]):
            n += 1
        out += bytes([n - 1]) + v[x:x + n]
        x += n
    return bytes(out)


def make_icns(blocks, toc: bool = False, length: int | None = None) -> bytes:
    """An ICNS file of (type, payload) blocks, a table of contents first
    when ``toc``; ``length`` the header's file length if given."""
    body = [(t, p) for t, p in blocks]
    if toc:
        body.insert(0, (b"TOC ", b"".join(t + struct.pack(">I", 8 + len(p)) for t, p in blocks)))
    data = b"".join(t + struct.pack(">I", 8 + len(p)) + p for t, p in body)
    return b"icns" + struct.pack(">I", 8 + len(data) if length is None else length) + data


def icns_rgb(rgb: np.ndarray, it32: bool = False) -> bytes:
    """The RLE payload of uint8 [S, S, 3]: each band's runs in turn (with
    ``it32``'s four zero bytes first)."""
    return (bytes(4) if it32 else b"") + b"".join(icns_rle(rgb[..., k]) for k in range(3))


def _container_planes(hw=(24, 20), seed=81) -> tuple:
    """A seeded picture's RGB levels, its gray and a flat four-colour icon
    (so Pillow's 1024-pixel ICNS frames compress)."""
    rgb = levels(hw, seed, noise=0.05)
    icon = np.zeros((16, 16, 4), np.uint8)
    icon[:8, :8], icon[8:, :8], icon[:, 8:] = (200, 30, 30, 255), (30, 200, 30, 128), \
        (30, 30, 200, 255)
    return rgb, rgb[..., 1], icon


def container_goldens() -> dict[str, bytes]:
    """Phase 31's small goldens, a file per g2 kind and variant but PCD
    (Pillow's writes of ICNS, of BLP1 and BLP2 from ``P`` images, and of
    the JPEG and JPEG 2000 payloads; the rest from the writers above): ICNS
    from Pillow, RLE with masks at three sizes, ``it32`` and a JPEG 2000
    payload; BLP palette, DXT1 with and without alpha, DXT3, DXT5 and
    JPEG; FTEX DXT1 and raw; FLI and FLC with each frame chunk and both
    colour chunks; IPTC raw, JPEG and a merged band of RGB and CMYK."""
    from PIL import Image  # noqa: PLC0415

    rgb, g, icon = _container_planes()
    h, w = g.shape
    rng = np.random.default_rng(82)
    big = np.repeat(np.repeat(icon[..., :3], 8, 0), 8, 1)
    mask = np.repeat(np.repeat(icon[..., 3], 8, 0), 8, 1)
    pal_img = Image.fromarray(rgb).quantize(40)
    pal_rgba = pal_img.copy()
    pal_rgba.putpalette(bytes(np.concatenate([np.asarray(pal_img.getpalette()[:120]).reshape(40, 3),
                                              np.arange(40)[:, None] * 6], 1)
                              .astype(np.uint8).ravel()), "RGBA")
    bgra = np.concatenate([rgb[..., ::-1].reshape(-1, 3), np.full((h * w, 1), 255)], 1)[:256]
    pal = bytes(np.pad(bgra, ((0, 256 - len(bgra)), (0, 0))).astype(np.uint8).ravel())
    idx = (np.arange(h * w) % 256).astype(np.uint8).tobytes()
    dxt3 = bytes(np.concatenate([rng.integers(0, 256, (30, 8)),
                                 np.frombuffer(bc1_blocks(rgb), np.uint8).reshape(30, 8)], 1)
                 .astype(np.uint8).ravel())
    dxt5 = bytes(np.concatenate([np.tile([[200, 40]], (30, 1)), rng.integers(0, 256, (30, 6)),
                                 np.frombuffer(bc1_blocks(rgb), np.uint8).reshape(30, 8)], 1)
                 .astype(np.uint8).ravel())
    jpg = _save(Image.fromarray(rgb), "JPEG", quality=90)
    gray_jpg = _save(Image.fromarray(g), "JPEG", quality=90)
    j2k = _save(Image.fromarray(big), "JPEG2000", no_jp2=True)
    fw, fh = 37, 23
    fidx = (np.add.outer(np.arange(fh) // 3, np.arange(fw) // 5) * 7 % 256).astype(np.uint8)
    fpal = [(0, (np.arange(256)[:, None] * [1, 3, 7] % 256))]
    lc = {2: [(3, ("r", 5, 9)), (1, ("l", b"abcdef"))], 4: [(0, ("l", b"xy"))]}
    ss2 = [([], [(2, ("r", 3, (7, 8))), (1, ("l", b"abcd"))]), ([0xFFFE], [(0, ("l", b"zz"))]),
           ([0x8000 | 77], [(4, ("r", 2, (1, 2)))])]
    return {
        "icns_pillow_rgb.icns": _save(Image.fromarray(icon[..., :3]), "ICNS"),
        "icns_pillow_rgba.icns": _save(Image.fromarray(icon), "ICNS"),
        "icns_rle_masks.icns": make_icns([
            (b"is32", icns_rgb(icon[..., :3])), (b"s8mk", icon[..., 3].tobytes()),
            (b"il32", icns_rgb(np.repeat(np.repeat(icon[..., :3], 2, 0), 2, 1))),
            (b"l8mk", np.repeat(np.repeat(icon[..., 3], 2, 0), 2, 1).tobytes()),
            (b"ih32", icns_rgb(np.repeat(np.repeat(icon[..., :3], 3, 0), 3, 1)))], toc=True),
        "icns_it32.icns": make_icns([(b"it32", icns_rgb(big, True)), (b"t8mk", mask.tobytes())]),
        "icns_raw_rgb.icns": make_icns([(b"is32", icon[..., :3].tobytes())]),
        "icns_jpeg2000.icns": make_icns([(b"ic07", j2k)]),
        "blp1_palette.blp": _save(pal_img, "BLP", blp_version="BLP1"),
        "blp2_palette_rgba.blp": _save(pal_rgba, "BLP"),
        "blp1_palette_enc4.blp": make_blp(w, h, idx, 1, 1, 4, 8, palette=pal),
        "blp2_dxt1.blp": make_blp(w, h, bc1_blocks(rgb), 2, 1, 2, 0, 0),
        "blp2_dxt1_alpha.blp": make_blp(w, h, bc1_blocks(rgb), 2, 1, 2, 1, 0),
        "blp2_dxt3.blp": make_blp(w, h, dxt3, 2, 1, 2, 8, 1),
        "blp2_dxt5.blp": make_blp(w, h, dxt5, 2, 1, 2, 8, 7),
        "blp1_jpeg.blp": make_blp(w, h, jpg[400:], 1, 0, 5, 0, jpeg_header=jpg[:400]),
        "blp1_jpeg_gray_alpha.blp": make_blp(w, h, gray_jpg[300:], 1, 0, 5, 8,
                                             jpeg_header=gray_jpg[:300], offset=2048),
        "ftex_dxt1.ftc": make_ftex(bc1_blocks(rgb), w, h, 0),
        "ftex_raw.ftu": make_ftex(rgb.tobytes(), w, h, 1),
        "fli_brun.fli": make_fli(fw, fh, [fli_color(fpal), fli_brun(fidx)], 0xAF11),
        "flc_chunks.flc": make_fli(fw, fh, [
            fli_color([(3, np.arange(120).reshape(40, 3) % 64), (10, [(63, 0, 32)] * 5)], 11),
            fli_chunk(18, b"a stamp"), fli_brun(fidx), fli_lc(lc, 2, 4), fli_ss2(ss2)]),
        "flc_copy_black.flc": make_fli(fw, fh, [fli_color(fpal), fli_chunk(16, fidx.tobytes()),
                                                fli_chunk(13, b""),
                                                fli_lc({1: [(4, ("l", b"ab"))]}, 1, 1)]),
        "iptc_raw.iim": make_iptc(w, h, g.tobytes(), chunk=200),
        "iptc_jpeg.iim": make_iptc(w, h, gray_jpg, compression=5),
        "iptc_rgb_band.iim": make_iptc(w, h, g.tobytes(), 3, 1, band=2),
        "iptc_cmyk_band.iim": make_iptc(w, h, gray_jpg, 4, 1, 5, band=4),
    }


CONTAINER_NAMES = (
    "icns_pillow_rgb.icns", "icns_pillow_rgba.icns", "icns_rle_masks.icns", "icns_it32.icns",
    "icns_raw_rgb.icns", "icns_jpeg2000.icns", "blp1_palette.blp", "blp2_palette_rgba.blp",
    "blp1_palette_enc4.blp", "blp2_dxt1.blp", "blp2_dxt1_alpha.blp", "blp2_dxt3.blp",
    "blp2_dxt5.blp", "blp1_jpeg.blp", "blp1_jpeg_gray_alpha.blp", "ftex_dxt1.ftc", "ftex_raw.ftu",
    "fli_brun.fli", "flc_chunks.flc", "flc_copy_black.flc", "iptc_raw.iim", "iptc_jpeg.iim",
    "iptc_rgb_band.iim", "iptc_cmyk_band.iim")
# made at run time, not kept: a PhotoCD base image is 786,432 bytes whatever it shows
PCD_NAMES = ("pcd.pcd", "pcd_turned_90.pcd", "pcd_turned_270.pcd")


def pcd_file(orientation: int = 0, seed: int = 83) -> bytes:
    """A PhotoCD file of a seeded picture's PhotoYCC-like levels."""
    rgb = levels((512, 768), seed, noise=0.05).astype(np.int64)
    y = (rgb @ [77, 150, 29]) >> 8
    cb = (rgb[::2, ::2, 2] - y[::2, ::2]) // 2 + 156
    cr = (rgb[::2, ::2, 0] - y[::2, ::2]) // 2 + 137
    return make_pcd(np.clip(y * 3 // 4, 0, 255), np.clip(cb, 0, 255), np.clip(cr, 0, 255),
                    orientation)


def container_fixtures() -> dict[str, bytes]:
    """Phase 31's goldens, as tests/goldens/ holds them, and the PCD files
    made here."""
    out = {name: (GOLDENS / name).read_bytes() for name in CONTAINER_NAMES}
    out.update(zip(PCD_NAMES, (pcd_file(0), pcd_file(1), pcd_file(7))))
    return out


def container_4k(kind: str, rgb: np.ndarray | None = None, blocks: bytes | None = None) -> bytes:
    """Phase 31's 4K files, made with numpy alone from
    :func:`raster_picture` (or ``rgb``): ``blp`` a BLP2 DXT1 file, ``ftex``
    an FTEX DXT1 file, of the same blocks (``blocks`` if given)."""
    rgb = raster_picture() if rgb is None else rgb
    h, w, _ = rgb.shape
    blocks = bc1_blocks(rgb) if blocks is None else blocks
    if kind == "blp":
        return make_blp(w, h, blocks, 2, 1, 2, 0, 0)
    return make_ftex(blocks, w, h, 0)
