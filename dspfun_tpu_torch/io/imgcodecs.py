"""The port's codecs for PNM, BMP and TIFF: struct + numpy, no imaging
library.

The JAX package reads and writes these formats through Pillow
(``dspfun_tpu/io/images.py``).  Each decoder here returns what Pillow's
plugin decodes, as ``(samples [H, W, C], depth)`` with C in 1..4 and
uint8 samples at depth 8, or gray at depth 16: uint16 (Pillow's ``I;16``
modes) or int32 (its ``I`` mode, which ``io/images.py`` divides by 65535
as the JAX package does); ``io/images.py`` makes float RGBA of them as
Pillow's ``convert("RGBA")`` does.  Each encoder writes, for the
quantised arrays ``io/images.py`` hands it (uint8 RGB or RGBA, or uint16 gray), the bytes
Pillow writes (PNM and BMP) or a file Pillow decodes to the same array
(TIFF).  tests/test_torch_image_formats.py and test_torch_tiff.py hold
all of it to Pillow.

* **PNM** (``PpmImagePlugin``): P1 and P4 bitmaps, P2 and P5 graymaps, P3
  and P6 pixmaps at any maxval; a maxval other than 255 (and 65535 for
  raw gray) is scaled to 8 bits, or to 16 for a graymap above 255, with
  Python's ``round`` (half to even), as Pillow scales it; and Pillow's
  other magic numbers: ``Pf`` (PFM, float32 gray, clamped and truncated
  to 8 bits as its ``convert("RGBA")`` makes mode ``F``), ``P0CMYK`` and
  ``PyCMYK`` (through ``cmyk2rgb``), ``PyRGBA`` and ``PyP``.  Written: RGB
  (and RGBA, without its alpha) as P6, 16-bit gray as P5 with maxval
  65535.
* **BMP** (``BmpImagePlugin``): Windows headers of 40 to 124 bytes (and
  OS/2's 12), bottom-up or top-down, 1-, 4- and 8-bit palettes, 24 and
  32 bits (``BI_RGB``: the fourth byte ignored) and the 32-bit
  ``BI_BITFIELDS`` layouts with an alpha mask.  Written: RGB as 24-bit,
  RGBA as 32-bit ``BGRA``, both at 96 dpi.
* **TIFF** (``TiffImagePlugin`` and libtiff): the first image, keyed as
  Pillow's ``_setup`` keys it into its ``OPEN_INFO`` table (kept here as
  data, ``_OPEN_INFO_ROWS``) and unpacked by that key's rawmode as
  Pillow's unpackers do it: 1-, 2-, 4- and 8-bit gray, 12- and 16-bit
  gray (``I;16``), 16- and 32-bit signed and 32-bit unsigned gray (``I``), 32-bit float
  (``F``), gray + alpha, palettes of 1 to 8 bits with or without alpha,
  RGB(A) of 8 and 16 bits with their extra samples (16-bit colour keeps
  each sample's high byte; associated alpha, ExtraSamples 1,
  un-premultiplied as Pillow's ``RGBa`` unpacker does it), CMYK of 8 and
  16 bits (converted by Pillow's ``cmyk2rgb``), each in either fill
  order, and YCbCr: chunky JPEG-compressed YCbCr converted to RGB by
  libjpeg (``io/jpeg.py``), any other compressed YCbCr by libtiff's RGBA
  reader (its subsampled blocks, chroma repeated over each block, its
  float32 and fixed-point tables of YCbCrCoefficients and
  ReferenceBlackWhite), uncompressed YCbCr as Pillow's own reader takes
  it (rawmode ``RGBX``).  Uncompressed files are read as Pillow's own
  reader reads them (its strips and tiles, the one-letter rawmode of
  each plane of a planar file); LZW (``native/tiff.cpp``, with libtiff's
  old LSB-first form where the first strip starts as libtiff's
  LZWPreDecode tests), deflate (8 and 32946, the standard library's zlib),
  Zstandard (``native/zstd.cpp``, as libzstd decodes a strip for
  libtiff), LZMA (the standard library's liblzma: the first xz stream of
  each strip), PackBits, JPEG (each strip or
  tile an abbreviated stream decoded with the JPEGTables tag, leniently
  as libjpeg under libtiff decodes a damaged one) and CCITT RLE, Group 3
  (1-D and 2-D) and Group 4 (``native/fax.cpp``, libtiff's fax decoder
  with its recovery from bad codes) ones as libtiff hands them to Pillow:
  bits reversed before decompression under FillOrder 2 (but for JPEG and
  CCITT, whose decoders read the fill order), samples in native byte
  order, predictor 2 or 3 (libtiff's ``fpAcc``) undone in each row of a
  strip or tile, planes interleaved.  Orientation 2-8 applied last, as
  ``ImageOps.exif_transpose`` does at Pillow's load.  Written: one strip,
  little endian, no compression.  :func:`tiff_unidentified` names the
  files Pillow does not open (a compression that is not a key of its
  COMPRESSION_INFO, such as JPEG 2000 or PNG; a key its OPEN_INFO lacks,
  such as SGILog's photometrics), which ``io/images.py`` passes on as
  ``Image.open`` does; :func:`tiff_not_carried` names what the decoder
  does not take (old-style JPEG, ThunderScan, CCITT RLE-W, 12-bit
  JPEG-in-TIFF; ROADMAP queue 1, item 8c), which ``io/images.py`` hands
  to cv2; where Pillow raises (a predictor or colormap libtiff refuses,
  SGILog or WebP compression, which its libtiff refuses at load, a
  truncated or corrupt strip or tile), :func:`decode_tiff` raises, and where
  Pillow reads a damaged strip to what the port cannot reproduce (a T.6
  strip's rows libtiff leaves unwritten, a damaged JPEG block outside the
  range where libjpeg-turbo's SIMD and C arithmetic agree, an xz stream
  that liblzma finds corrupt before the strip is full), it raises too.

Everything else raises ``ValueError``.
"""

from __future__ import annotations

import ctypes
import functools
import struct
import zlib

import numpy as np

from dspfun_tpu_torch import _hostbuild
from dspfun_tpu_torch.io import jpeg as _jpeg
from dspfun_tpu_torch.io import png as _png

__all__ = ["bitmap", "bitmap_pixels", "decode_bmp", "decode_dib", "decode_pnm", "decode_tiff",
           "encode_bmp", "encode_dib", "encode_pnm", "encode_tiff", "pnm_magic",
           "tiff_cv2_differs", "tiff_not_carried", "tiff_unidentified"]

_WS = b" \t\n\r\x0b\x0c"


# ---------------------------------------------------------------------------
# PNM
# ---------------------------------------------------------------------------


# PpmImagePlugin.MODES: each magic number and its mode
_PNM_MODES = {b"P1": "1", b"P2": "L", b"P3": "RGB", b"P4": "1", b"P5": "L", b"P6": "RGB",
              b"P0CMYK": "CMYK", b"Pf": "F", b"PyP": "P", b"PyRGBA": "RGBA", b"PyCMYK": "CMYK"}


def pnm_magic(data: bytes) -> bytes | None:
    """The magic number of a file ``PpmImagePlugin`` takes (its _accept:
    ``P`` and one of ``0123456fy``), read as its _read_magic reads it (up to
    six bytes, to the first whitespace); None where _accept does not take
    the file.  Raises ``rawimg.Skip`` where the magic is not one of its
    MODES (``PF``, colour PFM, say): Image.open tries the next format."""
    from dspfun_tpu_torch.io.rawimg import Skip  # noqa: PLC0415

    if len(data) < 2 or data[:1] != b"P" or data[1] not in b"0123456fy":
        return None
    magic = bytearray()
    for c in data[:6]:
        if c in _WS:
            break
        magic.append(c)
    if bytes(magic) not in _PNM_MODES:
        raise Skip("not a PPM file")
    return bytes(magic)


def _pnm_header(data: bytes, count: int, pos: int = 2) -> tuple[list[bytes], int]:
    """``count`` header tokens from ``pos`` and the offset of the data (one
    whitespace byte after the last token; ``#`` comments skipped)."""
    vals = []
    while len(vals) < count:
        while pos < len(data) and data[pos] in _WS:
            pos += 1
        if data[pos:pos + 1] == b"#":
            while pos < len(data) and data[pos] not in b"\r\n":
                pos += 1
            continue
        start = pos
        while pos < len(data) and data[pos] not in _WS and data[pos:pos + 1] != b"#":
            pos += 1
        if start == pos:
            raise ValueError("Reached EOF while reading header")
        vals.append(data[start:pos])
    return vals, pos + 1


def _plain_tokens(body: bytes) -> list[bytes]:
    lines = [ln.split(b"#", 1)[0] for ln in body.replace(b"\r", b"\n").split(b"\n")]
    return b" ".join(lines).split()


def _scale(vals: np.ndarray, maxval: int, out_max: int) -> np.ndarray:
    """Pillow's ``min(out_max, round(value / maxval * out_max))``."""
    return np.minimum(out_max, np.rint(vals.astype(np.float64) / maxval * out_max))


def _f2l(v: np.ndarray) -> np.ndarray:
    """Pillow's ``convert`` of float samples (mode ``F``) to 8 bits, as its
    ``convert("RGBA")`` goes through ``L``: clamped to [0, 255] and
    truncated, NaN 0."""
    return np.where(np.isnan(v), 0, np.clip(v, 0, 255)).astype(np.uint8)


def decode_pnm(data: bytes) -> tuple[np.ndarray, int]:
    """A file of ``PpmImagePlugin``'s magic numbers as Pillow reads it then
    ``io/images.py`` takes it: P1-P6; PFM (``Pf``, one float32 channel,
    rows bottom-up, little-endian where the scale is negative) clamped
    and truncated to 8 bits; ``P0CMYK`` and ``PyCMYK`` converted by
    ``cmyk2rgb``; ``PyRGBA``; ``PyP``, whose image has no palette, black."""
    magic = pnm_magic(data)
    if magic is None:
        raise ValueError("not a PPM file")
    mode, at = _PNM_MODES[magic], len(magic)
    if mode == "1":
        (w, h), pos = _pnm_header(data, 2, at)
        w, h = int(w), int(h)
        if magic == b"P4":
            stride = (w + 7) // 8
            rows = np.frombuffer(data, np.uint8, h * stride, pos).reshape(h, stride)
            bits = np.unpackbits(rows, axis=1)[:, :w]
        else:
            digits = b"".join(_plain_tokens(data[pos - 1:]))
            bits = np.frombuffer(digits[:w * h], np.uint8).reshape(h, w) - ord("0")
        return ((1 - bits) * 255).astype(np.uint8)[..., None], 8
    if mode == "F":
        (w, h, scale), pos = _pnm_header(data, 3, at)
        w, h, scale = int(w), int(h), float(scale)
        if scale == 0.0 or not np.isfinite(scale):
            raise ValueError("scale must be finite and non-zero")
        v = np.frombuffer(data, "<f4" if scale < 0 else ">f4", w * h, pos).reshape(h, w)
        return _f2l(v[::-1])[..., None], 8
    (w, h, maxval), pos = _pnm_header(data, 3, at)
    w, h, maxval = int(w), int(h), int(maxval)
    if not 0 < maxval < 65536:
        raise ValueError("maxval must be greater than 0 and less than 65536")
    nch = {"L": 1, "P": 1, "RGB": 3, "RGBA": 4, "CMYK": 4}[mode]
    wide = mode == "L" and maxval > 255          # Pillow's mode I
    out_max = 65535 if wide else 255
    n = w * h * nch
    if magic in (b"P2", b"P3"):
        vals = np.array([int(t) for t in _plain_tokens(data[pos - 1:])[:n]], np.int64)
        if vals.size < n:
            raise ValueError("image file is truncated")
        vals = _scale(vals, maxval, out_max)
    else:
        vals = np.frombuffer(data, ">u2" if maxval > 255 else np.uint8, n, pos)
        if maxval != out_max:
            vals = _scale(vals, maxval, out_max)
    v = vals.astype(np.uint16 if wide else np.uint8).reshape(h, w, nch)
    if mode == "CMYK":
        v = _cmyk_rgb(v)
    elif mode == "P":
        v = np.zeros((h, w, 3), np.uint8)
    return v, 16 if wide else 8


def encode_pnm(arr: np.ndarray) -> bytes:
    """Pillow's PPM file of uint8 RGB or RGBA (P6, the alpha dropped) or
    uint16 gray [H, W] (P5, maxval 65535)."""
    if arr.dtype == np.uint16:
        h, w = arr.shape[:2]
        return b"P5\n%d %d\n65535\n" % (w, h) + np.ascontiguousarray(arr, ">u2").tobytes()
    h, w = arr.shape[:2]
    return b"P6\n%d %d\n255\n" % (w, h) + np.ascontiguousarray(arr[..., :3]).tobytes()


# ---------------------------------------------------------------------------
# BMP
# ---------------------------------------------------------------------------

_BMP_PPM = int(96 * 39.3701 + 0.5)
# BI_BITFIELDS masks Pillow reads, by bit count: (r, g, b, a) at 32 bits,
# (r, g, b) at 24 and 16, each to its rawmode
_BMP_MASKS = {
    32: {(0xFF0000, 0xFF00, 0xFF, 0x0): "BGRX", (0xFF000000, 0xFF0000, 0xFF00, 0x0): "XBGR",
         (0xFF000000, 0xFF00, 0xFF, 0x0): "BGXR", (0xFF000000, 0xFF0000, 0xFF00, 0xFF): "ABGR",
         (0xFF, 0xFF00, 0xFF0000, 0xFF000000): "RGBA", (0xFF0000, 0xFF00, 0xFF, 0xFF000000): "BGRA",
         (0xFF000000, 0xFF00, 0xFF, 0xFF0000): "BGAR", (0x0, 0x0, 0x0, 0x0): "BGRA"},
    24: {(0xFF0000, 0xFF00, 0xFF): "BGR"},
    16: {(0xF800, 0x7E0, 0x1F): "BGR;16", (0x7C00, 0x3E0, 0x1F): "BGR;15"},
}
_BMP_BITS = {1: "P;1", 4: "P;4", 8: "P", 16: "BGR;15", 24: "BGR", 32: "BGRX"}


def _u32(data: bytes, at: int) -> int:
    from dspfun_tpu_torch.io.rawimg import Skip  # noqa: PLC0415

    if len(data) < at + 4:
        raise Skip("short BMP header")
    return struct.unpack_from("<I", data, at)[0]


def bitmap(data: bytes, at: int, offset: int = 0) -> dict:
    """``BmpImageFile._bitmap``: the info header at ``at`` (12 bytes, OS/2,
    or 40 to 124, Windows), its masks and palette, and where the pixels
    start: ``offset`` (a BMP's bfOffBits, moved past the palette where it
    points at the palette, as Pillow moves it) or, at 0, right after the
    header, masks and palette (a DIB).  Raises ``rawimg.Skip`` where
    Pillow's open tries the next format and ``OSError`` where it fails."""
    from dspfun_tpu_torch.io.rawimg import Skip  # noqa: PLC0415

    hsize = _u32(data, at)
    hd = data[at + 4:at + hsize]
    if hsize - 4 > 0 and len(hd) < hsize - 4:
        raise OSError("Truncated File Read")
    pos = at + max(hsize, 4)
    if hsize == 12:
        w, h, _planes, bits = struct.unpack_from("<HHHH", hd)
        comp, colors, pad, down = 0, 0, 3, False
    elif hsize in (40, 52, 56, 64, 108, 124):
        down = hd[7] == 0xFF
        w, h, _planes, bits, comp = struct.unpack_from("<IIHHI", hd)
        h = 2 ** 32 - h if down else h
        colors, pad = struct.unpack_from("<I", hd, 28)[0], 4
    else:
        raise OSError(f"Unsupported BMP header type ({hsize})")
    raw = None
    if hsize != 12 and comp == 3:
        if len(hd) >= 48:
            masks = struct.unpack_from("<4I" if len(hd) >= 52 else "<3I", hd, 36)
        else:
            masks = tuple(_u32(data, pos + 4 * i) for i in range(3))
            pos += 12
        masks = masks + (0,) * (4 - len(masks))
        table = _BMP_MASKS.get(bits, {})
        raw = table.get(masks if bits == 32 else masks[:3])
        if raw is None:
            raise OSError("Unsupported BMP bitfields layout")
    colors = colors or (1 << bits)
    if offset == 14 + hsize and bits <= 8:
        offset += 4 * colors
    if bits not in _BMP_BITS:
        raise OSError(f"Unsupported BMP pixel depth ({bits})")
    raw = raw or _BMP_BITS[bits]
    if comp not in (0, 1, 2, 3):
        raise OSError(f"Unsupported BMP compression ({comp})")
    palette = None
    if bits <= 8:
        if not 0 < colors <= 65536:
            raise OSError(f"Unsupported BMP Palette size ({colors})")
        if colors > 256:
            raise Skip("o8 of a palette index past 255")  # struct.error in Pillow's gray check
        pal = data[pos:pos + pad * colors]
        pos += len(pal)
        n = len(pal) // pad
        palette = np.frombuffer(pal, np.uint8, n * pad).reshape(n, pad)[:, 2::-1]
    if w <= 0 or h <= 0:
        raise Skip("an empty size: not identified by the plugin")  # ImageFile's check
    return dict(size=(w, h), bits=bits, raw=raw, rle=comp in (1, 2) and comp, palette=palette,
                down=down, start=offset or pos, compression=comp)


def _bmp_rle(data: bytes, pos: int, w: int, h: int, rle4: bool) -> np.ndarray:
    """Pillow's ``BmpRleDecoder`` (Python in Pillow): the indices it
    collects, row after row as stored; fewer than w * h raise."""
    out = bytearray()
    x, n, total = 0, len(data), w * h
    while len(out) < total:
        if pos + 2 > n:
            break
        count, byte = data[pos], data[pos + 1]
        pos += 2
        if count:
            count = min(count, max(0, w - x)) if x + count > w else count
            if rle4:
                out += bytes((byte >> 4, byte & 15)[i % 2] for i in range(count))
            else:
                out += bytes([byte]) * count
            x += count
        elif byte == 0:
            out += bytes(-len(out) % w)
            x = 0
        elif byte == 1:
            break
        elif byte == 2:
            if pos + 2 > n:
                break
            pos += 2  # Pillow reads two bytes, then takes the next two as the delta
            if pos + 2 > n:
                raise ValueError("not enough values to unpack")
            right, up = data[pos], data[pos + 1]
            pos += 2
            out += bytes(right + up * w)
            x = len(out) % w
        else:
            want = byte // 2 if rle4 else byte
            got = data[pos:pos + want]
            pos += len(got)
            out += bytes(v for b in got for v in (b >> 4, b & 15)) if rle4 else got
            if len(got) < want:
                break
            x += byte
            if pos % 2:
                pos += 1
    if len(out) < total:
        raise ValueError("not enough image data")
    return np.frombuffer(bytes(out[:total]), np.uint8).reshape(h, w)


def _bgr16(px: np.ndarray, raw: str) -> np.ndarray:
    """Pillow's ``BGR;15`` and ``BGR;16`` unpackers."""
    v = px[..., 0].astype(np.uint32) | px[..., 1].astype(np.uint32) << 8
    gbits = 6 if raw == "BGR;16" else 5
    r = (v >> (5 + gbits)) & 31
    g = (v >> 5) & ((1 << gbits) - 1)
    b = v & 31
    return np.stack([r * 255 // 31, g * 255 // ((1 << gbits) - 1), b * 255 // 31],
                    axis=-1).astype(np.uint8)


def bitmap_pixels(data: bytes, bm: dict) -> np.ndarray:
    """The pixels of :func:`bitmap`'s layout, as Pillow's ``raw`` or
    ``bmp_rle`` decoder and ``convert("RGBA")`` give them (palettes
    expanded to RGB)."""
    (w, h), bits, raw = bm["size"], bm["bits"], bm["raw"]
    from dspfun_tpu_torch.io.rawimg import bomb_check  # noqa: PLC0415

    bomb_check(w, h)
    if bm["rle"]:
        idx = _bmp_rle(data, bm["start"], w, h, bm["rle"] == 2)
        if not bm["down"]:
            idx = idx[::-1]
    else:
        stride = ((w * bits + 31) >> 3) & ~3
        need = stride * (h - 1) + (w * bits + 7) // 8  # the last row's padding is not read
        if bm["start"] + need > len(data):
            raise OSError("image file is truncated")
        body = data[bm["start"]:bm["start"] + stride * h]
        rows = np.frombuffer(body.ljust(stride * h, b"\0"), np.uint8).reshape(h, stride)
        if not bm["down"]:
            rows = rows[::-1]
        if bits > 8:
            px = rows[:, :w * bits // 8].reshape(h, w, bits // 8)
            if bits == 16:
                return _bgr16(px, raw)
            order = [raw.index(ch) for ch in "RGBA" if ch in raw]
            return np.ascontiguousarray(px[..., order])
        idx = np.unpackbits(rows, axis=1)[:, :w * bits].reshape(h, w, bits)
        idx = (idx * (1 << np.arange(bits - 1, -1, -1, dtype=np.uint8))).sum(-1)
    pal = bm["palette"]
    full = np.zeros((256, 3), np.uint8)
    full[:min(len(pal), 256)] = pal[:256]
    return full[idx]


def decode_bmp(data: bytes) -> tuple[np.ndarray, int]:
    if data[:2] != b"BM":
        raise ValueError("Not a BMP file")
    return bitmap_pixels(data, bitmap(data, 14, _u32(data, 10))), 8


def decode_dib(data: bytes) -> tuple[np.ndarray, int]:
    """A DIB: a BMP without its file header, the pixels right after the
    header, masks and palette (Pillow's ``DibImageFile``)."""
    return bitmap_pixels(data, bitmap(data, 0)), 8


def encode_bmp(arr: np.ndarray) -> bytes:
    """Pillow's BMP file of uint8 RGB (24-bit) or RGBA (32-bit BGRA)."""
    if arr.dtype != np.uint8 or arr.ndim != 3 or arr.shape[2] not in (3, 4):
        raise ValueError(f"cannot write {arr.dtype} {arr.shape} as BMP")
    h, w, c = arr.shape
    bits = 8 * c
    stride = ((w * bits + 7) // 8 + 3) & ~3
    rows = np.zeros((h, stride), np.uint8)
    rows[:, :w * c] = arr[::-1][..., [2, 1, 0, 3][:c]].reshape(h, w * c)
    head = struct.pack("<IiiHHIIiiII", 40, w, h, 1, bits, 0, stride * h,
                       _BMP_PPM, _BMP_PPM, 0, 0)
    return (b"BM" + struct.pack("<IiI", 54 + stride * h, 0, 54) + head + rows.tobytes())


def encode_dib(arr: np.ndarray) -> bytes:
    """Pillow's DIB: its BMP without the 14-byte file header."""
    return encode_bmp(arr)[14:]


# ---------------------------------------------------------------------------
# TIFF
# ---------------------------------------------------------------------------

_TIFF_TYPES = {1: "B", 2: "c", 3: "H", 4: "I", 5: "II", 6: "b", 7: "B", 8: "h", 9: "i",
               10: "ii", 11: "f", 12: "d", 16: "Q"}
# the keys of Pillow 12.1's TiffImagePlugin.COMPRESSION_INFO: Image.open
# passes any other compression on (the file is not identified)
_PILLOW_COMPRESSIONS = frozenset({1, 2, 3, 4, 5, 6, 7, 8, 32771, 32773, 32809, 32946, 34676,
                                  34677, 34925, 50000, 50001})
# the compressions decode_tiff undoes, the names of those it leaves to cv2,
# and those Pillow's libtiff refuses at load: SGILog only takes the
# photometrics 32844 and 32845, which OPEN_INFO lacks, and WebP is not
# configured in it
_TIFF_CARRIED = {1: "uncompressed", 2: "CCITT RLE", 3: "CCITT Group 3", 4: "CCITT Group 4",
                 5: "LZW", 7: "JPEG", 8: "deflate", 32946: "deflate", 32773: "PackBits",
                 34925: "LZMA", 50000: "Zstandard"}
_TIFF_OTHERS = {6: "old-style JPEG", 32771: "CCITT RLE-W", 32809: "ThunderScan"}
_LIBTIFF_REFUSES = {34676: "SGILog compression with a photometric other than LogL or LogLuv",
                    34677: "SGILog24 compression with a photometric other than LogLuv",
                    50001: "WebP compression, which this libtiff is not configured for"}
_PREDICTED = (5, 8, 32946, 34925, 50000)    # the codecs libtiff runs the predictor with
_FAX = (2, 3, 4)                # CCITT RLE, Group 3, Group 4 (native/fax.cpp)
_OWN_BIT_ORDER = (2, 3, 4, 7)   # the codecs that read FillOrder themselves (or ignore it)

# Pillow's OPEN_INFO (TiffImagePlugin.py): (byte orders, photometric,
# SampleFormat, FillOrder, BitsPerSample, ExtraSamples, mode, rawmode)
_OPEN_INFO_ROWS = (
    ("<>", 0, (1,), 1, (1,), (), "1", "1;I"), ("<>", 0, (1,), 2, (1,), (), "1", "1;IR"),
    ("<>", 1, (1,), 1, (1,), (), "1", "1"), ("<>", 1, (1,), 2, (1,), (), "1", "1;R"),
    ("<>", 0, (1,), 1, (2,), (), "L", "L;2I"), ("<>", 0, (1,), 2, (2,), (), "L", "L;2IR"),
    ("<>", 1, (1,), 1, (2,), (), "L", "L;2"), ("<>", 1, (1,), 2, (2,), (), "L", "L;2R"),
    ("<>", 0, (1,), 1, (4,), (), "L", "L;4I"), ("<>", 0, (1,), 2, (4,), (), "L", "L;4IR"),
    ("<>", 1, (1,), 1, (4,), (), "L", "L;4"), ("<>", 1, (1,), 2, (4,), (), "L", "L;4R"),
    ("<>", 0, (1,), 1, (8,), (), "L", "L;I"), ("<>", 0, (1,), 2, (8,), (), "L", "L;IR"),
    ("<>", 1, (1,), 1, (8,), (), "L", "L"), ("<>", 1, (2,), 1, (8,), (), "L", "L"),
    ("<>", 1, (1,), 2, (8,), (), "L", "L;R"),
    ("<", 1, (1,), 1, (12,), (), "I;16", "I;12"),
    ("<", 0, (1,), 1, (16,), (), "I;16", "I;16"), ("<", 1, (1,), 1, (16,), (), "I;16", "I;16"),
    (">", 1, (1,), 1, (16,), (), "I;16B", "I;16B"), ("<", 1, (1,), 2, (16,), (), "I;16", "I;16R"),
    ("<", 1, (2,), 1, (16,), (), "I", "I;16S"), (">", 1, (2,), 1, (16,), (), "I", "I;16BS"),
    ("<", 0, (3,), 1, (32,), (), "F", "F;32F"), (">", 0, (3,), 1, (32,), (), "F", "F;32BF"),
    ("<", 1, (1,), 1, (32,), (), "I", "I;32N"),
    ("<", 1, (2,), 1, (32,), (), "I", "I;32S"), (">", 1, (2,), 1, (32,), (), "I", "I;32BS"),
    ("<", 1, (3,), 1, (32,), (), "F", "F;32F"), (">", 1, (3,), 1, (32,), (), "F", "F;32BF"),
    ("<>", 1, (1,), 1, (8, 8), (2,), "LA", "LA"),
    ("<>", 2, (1,), 1, (8,) * 3, (), "RGB", "RGB"), ("<>", 2, (1,), 2, (8,) * 3, (), "RGB", "RGB;R"),
    ("<>", 2, (1,), 1, (8,) * 4, (), "RGBA", "RGBA"),
    ("<>", 2, (1,), 1, (8,) * 4, (0,), "RGB", "RGBX"),
    ("<>", 2, (1,), 1, (8,) * 5, (0, 0), "RGB", "RGBXX"),
    ("<>", 2, (1,), 1, (8,) * 6, (0, 0, 0), "RGB", "RGBXXX"),
    ("<>", 2, (1,), 1, (8,) * 4, (1,), "RGBA", "RGBa"),
    ("<>", 2, (1,), 1, (8,) * 5, (1, 0), "RGBA", "RGBaX"),
    ("<>", 2, (1,), 1, (8,) * 6, (1, 0, 0), "RGBA", "RGBaXX"),
    ("<>", 2, (1,), 1, (8,) * 4, (2,), "RGBA", "RGBA"),
    ("<>", 2, (1,), 1, (8,) * 5, (2, 0), "RGBA", "RGBAX"),
    ("<>", 2, (1,), 1, (8,) * 6, (2, 0, 0), "RGBA", "RGBAXX"),
    ("<>", 2, (1,), 1, (8,) * 4, (999,), "RGBA", "RGBA"),
    ("<", 2, (1,), 1, (16,) * 3, (), "RGB", "RGB;16L"), (">", 2, (1,), 1, (16,) * 3, (), "RGB", "RGB;16B"),
    ("<", 2, (1,), 1, (16,) * 4, (), "RGBA", "RGBA;16L"),
    (">", 2, (1,), 1, (16,) * 4, (), "RGBA", "RGBA;16B"),
    ("<", 2, (1,), 1, (16,) * 4, (0,), "RGB", "RGBX;16L"),
    (">", 2, (1,), 1, (16,) * 4, (0,), "RGB", "RGBX;16B"),
    ("<", 2, (1,), 1, (16,) * 4, (1,), "RGBA", "RGBa;16L"),
    (">", 2, (1,), 1, (16,) * 4, (1,), "RGBA", "RGBa;16B"),
    ("<", 2, (1,), 1, (16,) * 4, (2,), "RGBA", "RGBA;16L"),
    (">", 2, (1,), 1, (16,) * 4, (2,), "RGBA", "RGBA;16B"),
    ("<>", 3, (1,), 1, (1,), (), "P", "P;1"), ("<>", 3, (1,), 2, (1,), (), "P", "P;1R"),
    ("<>", 3, (1,), 1, (2,), (), "P", "P;2"), ("<>", 3, (1,), 2, (2,), (), "P", "P;2R"),
    ("<>", 3, (1,), 1, (4,), (), "P", "P;4"), ("<>", 3, (1,), 2, (4,), (), "P", "P;4R"),
    ("<>", 3, (1,), 1, (8,), (), "P", "P"), ("<>", 3, (1,), 2, (8,), (), "P", "P;R"),
    ("<>", 3, (1,), 1, (8, 8), (0,), "P", "PX"), ("<>", 3, (1,), 1, (8, 8), (2,), "PA", "PA"),
    ("<>", 5, (1,), 1, (8,) * 4, (), "CMYK", "CMYK"),
    ("<>", 5, (1,), 1, (8,) * 5, (0,), "CMYK", "CMYKX"),
    ("<>", 5, (1,), 1, (8,) * 6, (0, 0), "CMYK", "CMYKXX"),
    ("<", 5, (1,), 1, (16,) * 4, (), "CMYK", "CMYK;16L"),
    (">", 5, (1,), 1, (16,) * 4, (), "CMYK", "CMYK;16B"),
    ("<>", 6, (1,), 1, (8,), (), "L", "L"), ("<>", 6, (1,), 1, (8,) * 3, (), "RGB", "RGBX"),
    ("<>", 8, (1,), 1, (8,) * 3, (), "LAB", "LAB"),
)
_OPEN_INFO = {(bo, *key): mode for bos, *key, m, raw in _OPEN_INFO_ROWS for bo in bos
              for mode in [(m, raw)]}
# the unpackers Pillow lacks for some of those rawmodes (Image.frombytes
# raises "unknown raw mode"), which only its own reader of uncompressed
# files reaches
_NO_UNPACKER = ("L;IR", "P;1R", "P;2R", "P;4R")
# the bands of each mode's pixels, and which of its letters a one-band
# rawmode may name (the planes of an uncompressed planar file)
_MODE_BANDS = {"1": 1, "L": 1, "P": 1, "I;16": 1, "I;16B": 1, "I": 1, "F": 1, "LA": 2,
               "PA": 2, "RGB": 3, "RGBA": 4, "CMYK": 4, "LAB": 3}
_BAND_RAWMODES = {"1": "1", "L": "L", "P": "LP", "I": "I", "F": "F", "RGB": "RGB",
                  "RGBA": "RGBA", "CMYK": "CMYK", "LAB": "LAB"}
_BITREV = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)], np.uint8)
# Orientation (tag 274) 2-8 as ImageOps.exif_transpose applies it to [H, W, C]
_ORIENT = {2: lambda a: a[:, ::-1], 3: lambda a: a[::-1, ::-1], 4: lambda a: a[::-1],
           5: lambda a: a.swapaxes(0, 1), 6: lambda a: a.swapaxes(0, 1)[:, ::-1],
           7: lambda a: a.swapaxes(0, 1)[::-1, ::-1], 8: lambda a: a.swapaxes(0, 1)[::-1]}


def _tiff_tags(data: bytes) -> tuple[str, dict]:
    bo = {b"II": "<", b"MM": ">"}.get(data[:2])
    try:
        if bo is None or struct.unpack_from(bo + "H", data, 2)[0] != 42:
            raise ValueError("not a TIFF file")
        ifd = struct.unpack_from(bo + "I", data, 4)[0]
        (n,) = struct.unpack_from(bo + "H", data, ifd)
        tags = {}
        for k in range(n):
            tag, typ, count, val = struct.unpack_from(bo + "HHI4s", data, ifd + 2 + 12 * k)
            code = _TIFF_TYPES.get(typ)
            if code is None:
                continue
            size = struct.calcsize(bo + code) * count
            at = struct.unpack(bo + "I", val)[0]
            raw = val if size <= 4 else data[at:at + size]
            if typ == 2:
                continue
            tags[tag] = struct.unpack(bo + code * count, raw[:size])
    except struct.error:
        raise ValueError("TIFF header or directory is truncated") from None
    return bo, tags


def _tiff_key(bo: str, t: dict) -> tuple:
    """The first image's key into Pillow's OPEN_INFO, as
    ``TiffImagePlugin._setup`` makes it: (byte order, photometric, sample
    format ((1,) where every sample's is 1), fill order, bits per sample
    (one value for all samples, extra values dropped), extra samples)."""
    comp = t.get(259, (1,))[0]
    photo = 6 if comp == 6 else t.get(262, (0,))[0]     # old-style JPEG is YCbCr to Pillow
    spp = t.get(277, (3 if comp == 6 else 1,))[0]
    bits = t.get(258, (1,))
    if spp > 6:
        raise ValueError("TIFF: invalid value for samples per pixel")
    if len(bits) > spp:
        bits = bits[:spp]
    elif len(bits) == 1:
        bits = bits * spp
    if len(bits) != spp:
        raise ValueError("TIFF: unknown data organization")
    fmt = t.get(339, (1,))
    if len(fmt) > 1 and set(fmt) == {1}:
        fmt = (1,)
    return (bo, photo, fmt, t.get(266, (1,))[0], bits, t.get(338, ()))


def tiff_unidentified(data: bytes) -> str | None:
    """Why ``TiffImagePlugin._setup`` fails on the first image of this TIFF
    with an error that ``Image.open`` takes as "not this format" (a
    compression that is not a key of its COMPRESSION_INFO, no dimensions,
    a bad sample count, a key its OPEN_INFO lacks, such as SGILog's
    photometrics 32844 and 32845), or None where it opens the file."""
    bo, t = _tiff_tags(data)
    comp = t.get(259, (1,))[0]
    if comp not in _PILLOW_COMPRESSIONS:
        return f"compression {comp} is not one of Pillow's"
    if 256 not in t or 257 not in t:
        return "TIFF: missing dimensions"
    try:
        key = _tiff_key(bo, t)
    except ValueError as e:
        return str(e)
    if key not in _OPEN_INFO:
        _, photo, fmt, fill, bits, extra = key
        return (f"TIFF of photometric {photo}, sample format {fmt}, fill order {fill}, {bits} "
                f"bits and extra samples {extra}: unknown pixel mode (Pillow's OPEN_INFO has "
                "no such key)")
    return None


def tiff_not_carried(data: bytes) -> tuple[str, str] | None:
    """None where :func:`decode_tiff` takes the first image of this TIFF
    (which it decodes, or refuses where Pillow raises), else (what it is,
    the letter of its part of ROADMAP queue 1 item 8), which
    ``io/images.py`` hands to cv2 or names in its refusal: old-style JPEG,
    CCITT RLE-W, ThunderScan, or 12-bit JPEG-in-TIFF.  (A file
    :func:`tiff_unidentified` names is no TIFF to ``Image.open``.)"""
    _, t = _tiff_tags(data)
    comp = t.get(259, (1,))[0]
    if comp not in _TIFF_CARRIED and comp not in _LIBTIFF_REFUSES:
        return f"{_TIFF_OTHERS.get(comp, f'compression {comp}')} TIFF", "c"
    if comp == 7 and any(b != 8 for b in t.get(258, (1,))):
        return f"{max(t.get(258, (1,)))}-bit JPEG-in-TIFF", "c"
    return None


def tiff_cv2_differs(data: bytes) -> str | None:
    """Why cv2 reads a TIFF that :func:`decode_tiff` does not take to
    other pixels than Pillow does (or reads it where Pillow raises), by its
    tags; None for the kinds tests/test_torch_cv2_route.py holds equal.
    (cv2's 4-channel read of alpha is caught after the decode.)"""
    _, t = _tiff_tags(data)
    photo, comp = t.get(262, (0,))[0], t.get(259, (1,))[0]
    bits = t.get(258, (1,))
    if photo == 8:
        return "cv2 reads the CIELab samples otherwise than Pillow's LAB conversion"
    if photo == 6 and comp not in (6, 7):
        return "cv2 converts YCbCr to RGB where Pillow raises or reads the samples as RGB"
    if photo == 5:
        return "cv2 converts CMYK to RGB otherwise than Pillow's cmyk2rgb"
    if max(bits) > 16 or any(f != 1 for f in t.get(339, (1,))):
        return "cv2 reads 32-bit, signed and float samples otherwise than Pillow's I and F modes"
    return None


@functools.lru_cache(maxsize=None)
def _tiff_lib() -> ctypes.CDLL:
    """The loaded ``native/tiff.cpp`` (LZW and PackBits) with its
    signatures declared (built on first use; raises when it cannot be
    built)."""
    lib = _hostbuild.load_library("tiff")
    lib.tif_lzw_decode.restype = ctypes.c_int64
    lib.tif_lzw_decode.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p,
                                   ctypes.c_int64, ctypes.c_int]
    lib.tif_packbits_decode.restype = ctypes.c_int64
    lib.tif_packbits_decode.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p,
                                        ctypes.c_int64]
    lib.tif_lab_rgb.restype = None
    lib.tif_lab_rgb.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                                ctypes.c_void_p, ctypes.c_int]
    return lib


@functools.lru_cache(maxsize=None)
def _zstd_lib() -> ctypes.CDLL:
    """The loaded ``native/zstd.cpp`` (Zstandard as libzstd decodes it for
    libtiff) with its signatures declared."""
    lib = _hostbuild.load_library("zstd")
    lib.zst_strip_decode.restype = ctypes.c_int64
    lib.zst_strip_decode.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p,
                                     ctypes.c_int64]
    return lib


# native/zstd.cpp's errors, by libzstd's names for them
_ZSTD_ERRORS = {-1: "Data corruption detected", -2: "Unknown frame descriptor",
                -3: "Unsupported frame parameter",
                -4: "Frame requires too much memory for decoding",
                -5: "Dictionary mismatch", -6: "Restored data doesn't match checksum",
                -7: "Destination buffer is too small", -8: "Src size is incorrect"}


def zstd_decode(data: bytes, capacity: int) -> bytes:
    """Zstandard through ``native/zstd.cpp``: what libtiff's ZSTDDecode
    hands out for a strip of ``capacity`` bytes (one frame: at most
    ``capacity`` bytes, fewer where the frame ends or the input runs out
    first).  A libzstd error raises ``ValueError``."""
    buf = ctypes.create_string_buffer(max(capacity, 1))
    n = _zstd_lib().zst_strip_decode(data, len(data), buf, capacity)
    if n < 0:
        raise ValueError(f"Zstandard: {_ZSTD_ERRORS.get(n, n)} (libzstd refuses the data)")
    return buf.raw[:n]


def _lzma_strip(raw: bytes, size: int) -> bytes:
    """libtiff's LZMADecode of one strip: the first xz stream (no
    concatenated streams) decoded by liblzma into ``size`` bytes.  libtiff
    keeps what liblzma decoded before an error, so a strip whose damage
    lies past its data (the check, the index, the footer) reads: where
    the standard library raises, the longest start of the input that
    decodes without the error gives those bytes.  Where that start holds
    fewer than ``size``, libtiff keeps what its own liblzma decoded into
    the damage before noticing, which depends on the version (5.8
    decodes further than 5.4): the port raises."""
    import lzma  # noqa: PLC0415  (liblzma, as libtiff's tif_lzma.c calls it)

    def run(data):
        return lzma.LZMADecompressor(format=lzma.FORMAT_XZ).decompress(data, size)

    try:
        return run(raw)
    except lzma.LZMAError as e:
        lo, hi = 0, len(raw)        # run(raw[:lo]) reads, run(raw[:hi]) raises
        while hi - lo > 1:
            mid = (lo + hi) // 2
            try:
                run(raw[:mid])
                lo = mid
            except lzma.LZMAError:
                hi = mid
        out = run(raw[:lo])
        if len(out) < size:
            raise ValueError(f"LZMA TIFF strip: liblzma finds the data corrupt ({e}) before "
                             f"the strip's {size} bytes, where libtiff keeps what its liblzma "
                             "decoded before noticing, which the port does not read") from None
        return out


@functools.lru_cache(maxsize=None)
def _fax_lib() -> ctypes.CDLL:
    """The loaded ``native/fax.cpp`` with its signature declared."""
    lib = _hostbuild.load_library("fax")
    lib.fax_decode.restype = ctypes.c_int
    lib.fax_decode.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                               ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                               ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int)]
    return lib


def _fax_inflater(t: dict, comp: int, fill: int, tw: int):
    """The decoder of one strip or tile of CCITT data (``native/fax.cpp``,
    libtiff's tif_fax3.c): compression 2 Modified Huffman, 3 T.4 (2-D
    rows where T4Options bit 0 is set), 4 T.6; FillOrder read by the
    decoder.  A T.4 strip read without EOLs leaves the strips after it
    read so too, as libtiff's mode does.  A strip libtiff's decoder fails
    on raises, and so does a T.6 strip that ends (EOFB or the data's end)
    before its last row but one, whose later rows libtiff leaves as its
    buffer held them (uninitialised memory in Pillow)."""
    scheme = {2: 2, 4: 4}.get(comp, 32 if t.get(292, (0,))[0] & 1 else 3)
    rb = (tw + 7) // 8
    no_eol = ctypes.c_int(0)        # libtiff's FAXMODE_NOEOL, kept from strip to strip
    lib = _fax_lib()

    def inflate(blk, n, last):
        buf = ctypes.create_string_buffer(n * rb)
        done = ctypes.c_int64(0)
        rc = lib.fax_decode(blk, len(blk), scheme, int(fill == 2), tw, n, buf, ctypes.byref(done),
                            ctypes.byref(no_eol))
        if rc < 0:
            raise ValueError(f"{_TIFF_CARRIED[comp]} TIFF strip: libtiff's decoder fails at row "
                             f"{done.value} of {n} (truncated or corrupt file)")
        if done.value + 1 < n:
            raise ValueError(f"{_TIFF_CARRIED[comp]} TIFF strip ends in row {done.value + 1} of "
                             f"{n}: libtiff leaves the rows after it as its buffer held them "
                             "(uninitialised memory in Pillow), which the port does not read")
        return buf.raw
    return inflate


def _lzw_compat(first: bytes) -> bool:
    """Whether libtiff reads an image's LZW as its old LSB-first form
    (LZWPreDecode's test, on the first strip or tile it decodes)."""
    return len(first) >= 2 and first[0] == 0 and bool(first[1] & 1)


def _tiff_strip(comp: int, raw: bytes, size: int, compat: bool = False) -> bytes:
    """One strip or tile decompressed to ``size`` bytes (the extra output
    of a longer stream ignored, as libtiff ignores it), or
    ``ValueError``; ``compat``: LZW in libtiff's old LSB-first form."""
    if comp in (8, 32946):
        try:
            out = zlib.decompressobj().decompress(raw, size)
        except zlib.error as e:
            raise ValueError(f"corrupt deflate TIFF strip: {e}") from None
    elif comp == 50000:
        out = zstd_decode(raw, size)
    elif comp == 34925:
        out = _lzma_strip(raw, size)
    else:
        lib = _tiff_lib()
        buf = ctypes.create_string_buffer(size)
        if comp == 5:
            n = lib.tif_lzw_decode(raw, len(raw), buf, size, int(compat))
        else:
            n = lib.tif_packbits_decode(raw, len(raw), buf, size)
        if n < 0:
            raise ValueError("corrupt LZW TIFF strip")
        out = buf.raw[:n]
    if len(out) < size:
        raise ValueError(f"{_TIFF_CARRIED[comp]} TIFF strip holds {len(out)} of its {size} "
                         "bytes (truncated or corrupt file)")
    return out


def _fields(rows: np.ndarray, bits: int, n: int) -> np.ndarray:
    """The first ``n`` fields of ``bits`` bits of each row, most
    significant bit first (uint16 [r, n])."""
    b = np.unpackbits(rows, axis=1)[:, :n * bits].reshape(len(rows), n, bits).astype(np.uint16)
    return (b << np.arange(bits - 1, -1, -1, dtype=np.uint16)).sum(axis=2, dtype=np.uint16)


def _unpremultiply(rgb: np.ndarray, a: np.ndarray) -> np.ndarray:
    """Pillow's ``RGBa`` unpacker (Unpack.c): alpha 0 gives 0, any other
    alpha ``min(c * 255 // a, 255)`` (255 copies)."""
    a = a.astype(np.int32)[..., None]
    c = np.minimum(rgb.astype(np.int32) * 255 // np.maximum(a, 1), 255)
    return np.where(a == 0, 0, c).astype(np.uint8)


def _rawmode_bits(raw: str) -> int:
    """Bits per pixel of a rawmode, as Pillow's unpacker table gives them."""
    letters, _, suffix = raw.partition(";")
    if letters in ("I", "F"):
        return int(suffix[:2]) if suffix else 32
    if letters in ("1", "L", "P") and suffix[:1].isdigit():      # L;2 L;4I P;1 ...
        return int(suffix[0])
    if letters == "1":
        return 1
    return len(letters) * (16 if suffix.startswith("16") else 8)


def _unpack(mode: str, raw: str, rows: np.ndarray, n: int) -> np.ndarray:
    """Pillow's unpacker of ``raw`` for ``mode`` on rows of bytes
    (uint8 [r, bytes], "N" read as little-endian): the first ``n`` pixels
    of each row as the mode holds them, [r, n, bands] (uint8; uint16 for
    I;16; int32 for I; float32 for F).  A one-letter rawmode of a
    several-band mode gives that band alone, [r, n]."""
    if raw in _NO_UNPACKER or len(raw) == 1 and raw not in _BAND_RAWMODES.get(mode, ""):
        raise ValueError(f"TIFF: unknown raw mode {raw} for mode {mode}")
    r = len(rows)
    letters, _, suffix = raw.partition(";")
    if "R" in suffix:                     # FillOrder 2: the bits of each byte reversed
        rows = _BITREV[rows]
    if mode in ("1", "L", "P") and letters in ("1", "L", "P"):
        bits = _rawmode_bits(raw)
        v = rows[:, :n] if bits == 8 else _fields(rows, bits, n).astype(np.uint8)
        if mode == "1":
            v = v * 255
        elif mode == "L" and bits < 8:
            v = v * (255 // ((1 << bits) - 1))
        if "I" in suffix:
            v = 255 - v
        return v.astype(np.uint8)[..., None]
    if raw == "I;12":
        return _fields(rows, 12, n)[..., None]
    if mode in ("I;16", "I;16B", "I", "F"):
        bits = _rawmode_bits(raw)
        big = raw in ("I;16B", "I;16BS", "I;32BS", "F;32BF")
        kind = "f" if mode == "F" else ("i" if raw.endswith("S") else "u")
        v = rows[:, :n * bits // 8].copy().view(f"{'>' if big else '<'}{kind}{bits // 8}")
        return v.astype({"F": np.float32, "I": np.int32}.get(mode, np.uint16))[..., None]
    size = 2 if suffix.startswith("16") else 1
    v = rows[:, :n * len(letters) * size].reshape(r, n, len(letters), size)
    v = v[..., 0 if suffix.endswith("B") else size - 1]       # a 16-bit sample's high byte
    if len(letters) == 1:
        # LAB's a and b bands hold a plane's bytes as they are, which
        # Pillow's array of its LAB image shows offset by 128
        return v[..., 0] ^ np.uint8(128 if mode == "LAB" and letters in ("A", "B") else 0)
    if letters.startswith("RGBa"):
        return np.concatenate([_unpremultiply(v[..., :3], v[..., 3]), v[..., 3:4]], -1)
    return v[..., :_MODE_BANDS[mode]]


def _cmyk_rgb(v: np.ndarray) -> np.ndarray:
    """Pillow's ``cmyk2rgb`` (Convert.c): each of C, M, Y becomes
    ``nk - MULDIV255(x, nk)`` with nk = 255 - K (in uint16, which holds
    every intermediate: x * nk + 128 + 255 < 65536)."""
    x = v[..., :3].astype(np.uint16)
    nk = (255 - v[..., 3:4]).astype(np.uint16)
    t = x * nk + 128
    return (nk - (((t >> 8) + t) >> 8)).astype(np.uint8)


# ---- CIELab: Pillow's convert("RGBA") of its LAB mode, through LittleCMS ----
#
# Pillow converts LAB with an lcms transform from createProfile("LAB")
# (cmsCreateLab2Profile: D50) to createProfile("sRGB") (cmsCreate_sRGBProfile)
# at the perceptual intent.  lcms drops the identity and V2 <-> V4 stages,
# is left with Lab -> XYZ, the inverse of sRGB's Bradford-adapted colorant
# matrix and the inverse sRGB curves (each stage's output float32, its
# arithmetic double), and samples that pipeline into a 33-point 16-bit
# table, which native/tiff.cpp:tif_lab_rgb interpolates.  The table is
# computed here in numpy and Python floats, in lcms's order of operations
# (cmspcs.c, cmsmtrx.c, cmswtpnt.c, cmsvirt.c, cmsgamma.c, cmslut.c), so no
# host's compiler contracts it into fused multiply-adds.

_D50 = (0.9642, 1.0, 0.8249)
_BRADFORD = ((0.8951, 0.2664, -0.1614), (-0.7502, 1.7135, 0.0367), (0.0389, -0.0685, 1.0296))
_MAX_ENCODEABLE_XYZ = 1.0 + 32767.0 / 32768.0


def _mat3_inverse(a) -> list:
    """cmsmtrx.c _cmsMAT3inverse, by cofactors."""
    c0 = a[1][1] * a[2][2] - a[1][2] * a[2][1]
    c1 = -a[1][0] * a[2][2] + a[1][2] * a[2][0]
    c2 = a[1][0] * a[2][1] - a[1][1] * a[2][0]
    det = a[0][0] * c0 + a[0][1] * c1 + a[0][2] * c2
    return [[c0 / det, (a[0][2] * a[2][1] - a[0][1] * a[2][2]) / det,
             (a[0][1] * a[1][2] - a[0][2] * a[1][1]) / det],
            [c1 / det, (a[0][0] * a[2][2] - a[0][2] * a[2][0]) / det,
             (a[0][2] * a[1][0] - a[0][0] * a[1][2]) / det],
            [c2 / det, (a[0][1] * a[2][0] - a[0][0] * a[2][1]) / det,
             (a[0][0] * a[1][1] - a[0][1] * a[1][0]) / det]]


def _mat3_eval(a, v) -> list:
    return [a[i][0] * v[0] + a[i][1] * v[1] + a[i][2] * v[2] for i in range(3)]


def _mat3_per(a, b) -> list:
    return [[a[i][0] * b[0][j] + a[i][1] * b[1][j] + a[i][2] * b[2][j] for j in range(3)]
            for i in range(3)]


def _srgb_to_d50() -> list:
    """cmsCreate_sRGBProfile's colorants: Rec. 709 primaries and the white
    (0.3127, 0.3290) through _cmsBuildRGB2XYZtransferMatrix, adapted to D50
    by Bradford (_cmsAdaptMatrixToD50)."""
    (xr, yr), (xg, yg), (xb, yb), (xn, yn) = (0.64, 0.33), (0.30, 0.60), (0.15, 0.06), \
        (0.3127, 0.3290)
    coef = _mat3_eval(_mat3_inverse([[xr, xg, xb], [yr, yg, yb],
                                     [(1 - xr - yr), (1 - xg - yg), (1 - xb - yb)]]),
                      [xn / yn, 1.0, (1.0 - xn - yn) / yn])
    rgb = [[coef[0] * xr, coef[1] * xg, coef[2] * xb], [coef[0] * yr, coef[1] * yg, coef[2] * yb],
           [coef[0] * (1.0 - xr - yr), coef[1] * (1.0 - xg - yg), coef[2] * (1.0 - xb - yb)]]
    white = [(xn / yn) * 1.0, 1.0, ((1 - xn - yn) / yn) * 1.0]
    src, dst = _mat3_eval(_BRADFORD, white), _mat3_eval(_BRADFORD, _D50)
    cone = [[dst[0] / src[0], 0.0, 0.0], [0.0, dst[1] / src[1], 0.0], [0.0, 0.0, dst[2] / src[2]]]
    adapt = _mat3_per(_mat3_inverse(_BRADFORD), _mat3_per(cone, _BRADFORD))
    return _mat3_per(adapt, rgb)


def _lcms_word(d: np.ndarray) -> np.ndarray:
    """_cmsQuickSaturateWord: d + 0.5 floored after lcms's 16.16 magic
    rounds it to a multiple of 2^-16, clamped to 0..65535."""
    d = d + 0.5
    magic = 1.5 * 2.0 ** 36
    floor = np.floor(((d - 32767.0) + magic) - magic) + 32767
    return np.where(d <= 0, 0, np.where(d >= 65535.0, 65535, floor)).astype(np.uint16)


@functools.lru_cache(maxsize=1)
def _lab_clut() -> np.ndarray:
    """lcms's 33-point table of the Lab -> sRGB pipeline, uint16
    [33, 33, 33, 3]: each node's 16-bit input (_cmsQuantizeVal) as float32
    / 65535, Lab (V4 encoding) to XYZ under D50 (cmsLab2XYZ) over
    MAX_ENCODEABLE_XYZ, the matrix, the inverse sRGB curve (parametric
    type -4), each float32; then _cmsQuickSaturateWord of x 65535."""
    f32 = np.float32
    node = _lcms_word(np.arange(33) * 65535.0 / 32)
    q = np.stack(np.meshgrid(node, node, node, indexing="ij"), -1).reshape(-1, 3)
    x = (q.astype(f32) / f32(65535.0)).astype(np.float64)
    y = (x[:, 0] * 100.0 + 16.0) / 116.0
    t = np.stack([y + 0.002 * (x[:, 1] * 255.0 - 128.0), y, y - 0.005 * (x[:, 2] * 255.0 - 128.0)])
    t = np.where(t <= 24.0 / 116.0, (108.0 / 841.0) * (t - 16.0 / 116.0), t * t * t)
    xyz = [(t[i] * _D50[i] / _MAX_ENCODEABLE_XYZ).astype(f32).astype(np.float64) for i in range(3)]
    inv = [[v * _MAX_ENCODEABLE_XYZ for v in row] for row in _mat3_inverse(_srgb_to_d50())]
    lin = [((0.0 + xyz[0] * inv[i][0]) + xyz[1] * inv[i][1] + xyz[2] * inv[i][2])
           .astype(f32).astype(np.float64) for i in range(3)]
    g, a, b, c, d = 2.4, 1.0 / 1.055, 0.055 / 1.055, 1.0 / 12.92, 0.04045
    disc = (a * d + b) ** g
    out = []
    for v in lin:
        # the C library's pow, as lcms calls it (numpy's may be a SIMD one)
        hi = np.array([(x ** (1.0 / g) - b) / a if x >= disc else x / c for x in v.tolist()])
        out.append(_lcms_word(hi.astype(f32).astype(np.float64) * 65535.0))
    return np.ascontiguousarray(np.stack(out, -1).reshape(33, 33, 33, 3))


def _lab_rgb(v: np.ndarray) -> np.ndarray:
    """RGB uint8 [..., 3] of LAB samples uint8 [..., 3] as Pillow's array
    of its LAB image shows them (a and b signed), as its
    ``convert("RGBA")`` makes them (of L, a + 128 and b + 128, which its
    LAB image holds)."""
    lab = np.ascontiguousarray(v ^ np.array([0, 128, 128], np.uint8))
    out = np.empty(lab.shape, np.uint8)
    _tiff_lib().tif_lab_rgb(lab.ctypes.data, lab.size // 3, _lab_clut().ctypes.data,
                            out.ctypes.data, 3)
    return out


def _tiff_layout(t: dict, w: int, h: int) -> tuple:
    """(tiled, block width, block height, offsets, byte counts) of the
    strips or tiles."""
    if 324 in t or 322 in t:
        try:
            tiles = True, t[322][0], t[323][0], t[324], t.get(325, ())
        except KeyError:
            raise ValueError("TIFF: invalid tile dimensions") from None
        if min(tiles[1:3]) <= 0:
            raise ValueError("TIFF: invalid tile dimensions")
        return tiles
    if 273 not in t:
        raise ValueError("TIFF: unknown data organization (no strips or tiles)")
    return False, w, t.get(278, (h,))[0], t[273], t.get(279, ())


def _estimated_count(data: bytes, bo: str) -> int:
    """libtiff's EstimateStripByteCounts for a compressed file's one strip
    whose StripByteCounts is 0: the file's size less the header, the IFD
    and its out-of-line values, cut to what the file holds after the
    strip's offset by the caller."""
    ifd = struct.unpack_from(bo + "I", data, 4)[0]
    (n,) = struct.unpack_from(bo + "H", data, ifd)
    space = 8 + 2 + 12 * n + 4
    for k in range(n):
        typ, count = struct.unpack_from(bo + "HI", data, ifd + 4 + 12 * k)
        size = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4, 10: 8, 11: 4, 12: 8,
                13: 4, 16: 8, 17: 8, 18: 8}.get(typ, 0) * count
        space += size if size > 4 else 0
    return max(len(data) - space, 0)


def _tiff_raw(data: bytes, t: dict, mode: str, raw: str, bits: tuple, w: int, h: int) -> np.ndarray:
    """An uncompressed image as Pillow's own reader makes it (its
    ``_setup`` tiles and the raw decoder): each strip or tile read from its
    offset, row after row (``stride`` apart at the image's right edge, as
    ``_setup`` sets it), through the rawmode's unpacker, or through its
    one-band rawmode ``raw[plane]`` in a planar file; byte counts unused."""
    tiled, tw, th, offsets, _ = _tiff_layout(t, w, h)
    planar = t.get(284, (1,))[0] == 2
    photo = t.get(262, (0,))[0]
    nbands = {2: 3, 5: 4, 8: 3}.get(photo, 1) + len(t.get(338, ()))
    if tw == w and th == h and not planar:
        offsets = offsets[-1:]
    out = np.zeros((h, w) + ((_MODE_BANDS[mode],) if _MODE_BANDS[mode] > 1 else (1,)),
                   {"I;16": np.uint16, "I;16B": np.uint16, "I": np.int32,
                    "F": np.float32}.get(mode, np.uint8))
    buf = np.frombuffer(data, np.uint8)
    x = y = layer = 0
    for off in offsets:
        stride = tw * sum(bits) / 8 if x + tw > w else 0
        tile_raw = raw
        if planar:
            if layer >= len(raw):
                raise ValueError("TIFF: more planes than the mode has letters")
            tile_raw = raw[layer]
            stride /= nbands
        x1, y1 = min(x + tw, w), min(y + th, h)
        ew, eh = x1 - x, y1 - y
        nbytes = (ew * _rawmode_bits(tile_raw) + 7) // 8
        step = int(stride) or nbytes
        if step < nbytes:
            raise ValueError("TIFF: a tile's stride is shorter than its rows")
        if off + (eh - 1) * step + nbytes > len(data):
            raise ValueError("uncompressed TIFF strips are truncated (image file is truncated)")
        rows = buf[off + step * np.arange(eh)[:, None] + np.arange(nbytes)]
        v = _unpack(mode, tile_raw, rows, ew)
        if v.ndim == 2:
            out[y:y1, x:x1, _BAND_RAWMODES[mode].index(tile_raw)] = v
        else:
            out[y:y1, x:x1] = v
        x += tw
        if x >= w:
            x, y = 0, y + th
            if y >= h:
                y, layer = 0, layer + 1
    return out


def _floats(t: dict, tag: int, default: tuple) -> np.ndarray:
    """A RATIONAL (or FLOAT) tag's values as libtiff holds them: float32,
    each numerator / denominator in double (0 for a zero denominator)."""
    v = t.get(tag)
    if v is None:
        return np.array(default, np.float32)
    if len(v) == 2 * len(default) and all(isinstance(x, int) for x in v):
        v = [n / d if d else 0.0 for n, d in zip(v[::2], v[1::2])]
    return np.array(v[:len(default)], np.float32)


def _ycbcr_tables(t: dict) -> tuple:
    """libtiff's ``TIFFYCbCrToRGBInit`` (tif_color.c) from YCbCrCoefficients
    (529) and ReferenceBlackWhite (532), in its float32 and fixed-point
    steps: (Y, Cr->R, Cb->B, Cr->G, Cb->G) tables, int64 [256] each."""
    f = np.float32
    luma = _floats(t, 529, (0.299, 0.587, 0.114))
    rbw = _floats(t, 532, (0.0, 255.0, 128.0, 255.0, 128.0, 255.0))
    if np.isnan(luma).any() or luma[1] == 0:
        raise ValueError("TIFF: invalid values for the YCbCrCoefficients tag (libtiff refuses "
                         "them)")
    if not ((rbw > f(-0x7FFFFFFF + 128)) & (rbw < f(0x7FFFFFFF))).all():
        raise ValueError("TIFF: invalid values for the ReferenceBlackWhite tag (libtiff refuses "
                         "them)")

    def fix(x):     # FIX(CLAMP(x, 0, 2)): float32 * 65536, + 0.5 in double, truncated
        x = min(max(x, f(0)), f(2)) if not np.isnan(x) else f(2)
        return int(float(x * f(65536)) + 0.5)

    def code2v(c, rb, rw, cr):      # Code2V, then CLAMPw to +-4096 and the int32 cast
        d = f(rw - rb)
        v = (np.asarray(c - int(rb), np.float32) * f(cr)) / (d if d != 0 else f(1))
        return np.trunc(np.clip(v, f(-4096), f(4096))).astype(np.int64)

    with np.errstate(all="ignore"):
        f1, f3 = f(2) - f(2) * luma[0], f(2) - f(2) * luma[2]
        d1, d3 = fix(f1), fix(f3)
        d2, d4 = -fix(luma[0] * f1 / luma[1]), -fix(luma[2] * f3 / luma[1])
        x = np.arange(-128, 128)
        cr = code2v(x, rbw[4] - f(128), rbw[5] - f(128), 127)
        cb = code2v(x, rbw[2] - f(128), rbw[3] - f(128), 127)
        y = code2v(x + 128, rbw[0], rbw[1], 255)
    return y, (d1 * cr + 32768) >> 16, (d3 * cb + 32768) >> 16, d2 * cr, d4 * cb + 32768


def _ycbcr_rgb(tabs: tuple, y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """libtiff's ``TIFFYCbCrtoRGB`` of uint8 samples: uint8 [..., 3]."""
    ytab, cr_r, cb_b, cr_g, cb_g = tabs
    yy = ytab[y]
    rgb = np.stack([yy + cr_r[cr], yy + ((cb_g[cb] + cr_g[cr]) >> 16), yy + cb_b[cb]], -1)
    return np.clip(rgb, 0, 255).astype(np.uint8)


# the subsamplings libtiff's TIFFRGBAImage converts (tif_getimage.c
# PickContigCase; a planar file 1x1 only)
_YCBCR_SUBSAMPLINGS = ((4, 4), (4, 2), (4, 1), (2, 2), (2, 1), (1, 2), (1, 1))


def _tiff_ycbcr(data: bytes, t: dict, w: int, h: int) -> np.ndarray:
    """A compressed YCbCr image (three 8-bit samples) as Pillow reads it
    through libtiff's ``TIFFRGBAImage``: each strip or tile decompressed
    to its blocks of YCbCrSubsampling (default 2x2: the block's luma
    samples, row by row, then Cb and Cr), each block's chroma replicated
    over its luma samples (no interpolation) and converted by
    ``TIFFYCbCrtoRGB``; blocks cut by the image's edges converted in part
    (and a right edge tile of 4x4 blocks read at libtiff's skew).
    A planar file (1x1 only) holds a plane of each sample.  A strip of
    4x4 blocks with an odd count of blocks per row is read short by
    ``TIFFScanlineSize``'s rounding, as libtiff reads it: its last bytes
    are zero.  A JPEG-compressed planar file's planes are one-component
    streams, each decoded as stored by :func:`_jpeg_inflater`."""
    comp = t.get(259, (1,))[0]
    hs, vs = t.get(530, (2, 2))[:2] if len(t.get(530, ())) >= 2 else (2, 2)
    planar = t.get(284, (1,))[0] == 2
    if hs not in (1, 2, 4) or vs not in (1, 2, 4):
        raise ValueError(f"TIFF: invalid YCbCr subsampling {hs}x{vs} (libtiff refuses it)")
    if (hs, vs) not in (_YCBCR_SUBSAMPLINGS[-1:] if planar else _YCBCR_SUBSAMPLINGS):
        raise ValueError(f"TIFF: YCbCr subsampling {hs}x{vs}{' in planes' if planar else ''}: "
                         "libtiff's RGBA reader cannot handle the format")
    if t.get(317, (1,))[0] != 1 and comp in _PREDICTED:
        raise ValueError("YCbCr TIFF with a predictor is not carried by the port's codec "
                         f"({_png.NOT_PORTED}c)")
    tabs = _ycbcr_tables(t)
    tiled, tw, th, offsets, counts = _tiff_layout(t, w, h)
    if not tiled:
        th = min(th, h) or h
    nx, ny = -(-w // tw), -(-h // th)
    planes = 3 if planar else 1
    if len(offsets) < planes * nx * ny or len(counts) < planes * nx * ny:
        raise ValueError(f"TIFF has {min(len(offsets), len(counts))} strips or tiles of "
                         f"{planes * nx * ny}")
    if comp == 7:
        plane = _jpeg_inflater(t, 2, 1, tw)     # one component, 1x1, as stored

        def inflate(blk, size, n, last):
            return plane(blk, n, last)
    else:
        compat = _lzw_compat(data[offsets[0]:offsets[0] + counts[0]])

        def inflate(blk, size, n, last):
            return _tiff_strip(comp, blk, size, compat)
    bw = -(-tw // hs)
    unit = hs * vs + (0 if planar else 2)
    out = np.empty((ny * th, nx * tw, 3), np.uint8)
    k = 0
    samples = np.empty((planes, ny * th, nx * tw), np.uint8) if planar else None
    for p in range(planes):
        for j in range(ny):
            n = th if tiled else min(th, h - j * th)
            for i in range(nx):
                blk = data[offsets[k]:offsets[k] + counts[k]]
                k += 1
                last = not tiled and j == ny - 1
                if planar:
                    samples[p, j * th:j * th + n, i * tw:(i + 1) * tw] = np.frombuffer(
                        inflate(blk, n * tw, n, last), np.uint8).reshape(n, tw)
                    continue
                brows = -(-n // vs)
                size = brows * bw * unit
                read = size if tiled else min(size, -(-n // vs) * vs * (bw * unit // vs))
                raw = np.zeros(size, np.uint8)
                raw[:read] = np.frombuffer(inflate(blk, read, n, last), np.uint8)
                # a right edge tile's block rows are ``step`` bytes apart: its
                # blocks, then the skipped ones (10 bytes each for 4x4, as
                # putcontig8bitYCbCr44tile adjusts its skew)
                npix = min(tw, w - i * tw)
                cols = -(-npix // hs)
                step = cols * unit + (tw - npix) // hs * (10 if (hs, vs) == (4, 4) else unit)
                b = raw[(np.arange(brows)[:, None, None] * step
                         + np.arange(bw)[:, None] % cols * unit + np.arange(unit))]
                yb = b[..., :hs * vs].reshape(brows, bw, vs, hs).transpose(0, 2, 1, 3)
                yy = yb.reshape(brows * vs, bw * hs)
                cb = np.repeat(np.repeat(b[..., -2], vs, 0), hs, 1)
                cr = np.repeat(np.repeat(b[..., -1], vs, 0), hs, 1)
                rgb = _ycbcr_rgb(tabs, yy, cb, cr)
                out[j * th:j * th + n, i * tw:(i + 1) * tw] = rgb[:n, :tw]
    if planar:
        out = _ycbcr_rgb(tabs, samples[0], samples[1], samples[2])
    return out[:h, :w]


def _jpeg_frame(blk: bytes, tables) -> tuple:
    """One strip or tile of a JPEG-in-TIFF: its frame and coefficients,
    decoded as libjpeg decodes it under libtiff (with the JPEGTables,
    leniently: a truncated or corrupt stream decodes to what libjpeg
    recovers); a frame whose samples are not 8-bit raises, as libtiff's
    JPEGPreDecode does where BitsPerSample is 8."""
    if len(blk) < 2:
        raise ValueError("TIFF: an empty JPEG strip or tile")
    head = _jpeg.frame_header(blk)
    if head is not None and head.precision != 8:
        raise ValueError(f"TIFF: a JPEG stream of {head.precision}-bit samples for 8-bit ones "
                         "(libtiff: improper JPEG data precision)")
    try:
        frame, coefs = _jpeg.decode_coefficients(blk, tables, lenient=True)
    except ValueError as e:
        if "not carried" in str(e):
            raise ValueError(f"JPEG-in-TIFF: {e}") from None
        raise ValueError(f"corrupt JPEG-in-TIFF strip or tile: {e}") from None
    return frame, coefs


def _jpeg_size(frame, seg_w: int, seg_h: int, last_strip: bool) -> None:
    """libtiff's JPEGPreDecode check of a stream's size against its strip
    or tile: a larger last strip of the same width is cut to the strip,
    any other difference refused."""
    if (frame.width, frame.height) == (seg_w, seg_h):
        return
    if frame.width == seg_w and frame.height > seg_h and last_strip:
        return
    raise ValueError(f"TIFF: a JPEG stream of {frame.width}x{frame.height} in a strip or tile "
                     f"of {seg_w}x{seg_h} (libtiff refuses it)")


def _jpeg_inflater(t: dict, photo: int, per: int, tw: int):
    """The decoder of one strip or tile of a JPEG-in-TIFF (of a plane of
    YCbCr with ``photo`` 2: its samples as stored): each an abbreviated
    stream decoded with the JPEGTables tag, a chunky YCbCr one
    (photometric 6) converted to RGB by libjpeg (libtiff's
    JPEGCOLORMODE_RGB: its tables and fancy upsampling), every other one
    as stored; cut to the strip's rows and the tile's width.  As in
    libtiff's JPEGPreDecode, the stream must hold one component per
    sample (one in a plane), the YCbCrSubsampling tag's sampling on its
    first component (the stream's own where the tag is absent; 1x1 but
    for YCbCr) and 1x1 on the others."""
    tables = _jpeg.parse_tables(bytes(t[347])) if 347 in t else None
    ycc = photo == 6
    tag = tuple(t[530][:2]) if ycc and len(t.get(530, ())) >= 2 else None

    def inflate(blk, n, last):
        frame, coefs = _jpeg_frame(blk, tables)
        comps = frame.components
        if len(comps) != per:
            raise ValueError(f"TIFF: a JPEG stream of {len(comps)} components for {per} samples "
                             "(libtiff: improper JPEG component count)")
        first = (comps[0].h, comps[0].v)
        want = (tag or first) if ycc else (1, 1)
        if first != want or any((c.h, c.v) != (1, 1) for c in comps[1:]):
            raise ValueError(f"TIFF: JPEG sampling factors {[(c.h, c.v) for c in comps]} where "
                             f"{want} is due (libtiff: improper JPEG sampling factors)")
        _jpeg_size(frame, tw, n, last)
        if ycc and frame.lossless:
            raise ValueError("TIFF: a lossless JPEG stream in YCbCr (libjpeg converts no colours "
                             "in lossless mode: unsupported color conversion request)")
        # a progressive stream left short is smoothed, as libjpeg under libtiff smooths it
        px = _jpeg.reconstruct(frame, coefs, frame.latch, as_stored=not ycc)
        return np.ascontiguousarray(px[:n, :tw]).tobytes()
    return inflate


def _tiff_libtiff(data: bytes, bo: str, t: dict, key: tuple, mode: str, raw: str, w: int,
                  h: int) -> np.ndarray:
    """A compressed image as Pillow's libtiff route makes it: every strip
    or tile (of every plane) bit-reversed where FillOrder is 2,
    decompressed, in native (little-endian) byte order (libtiff swaps a
    big-endian file's 16- and 32-bit samples, but after the
    floating-point predictor, whose output is native), the predictor
    undone per row of the block, the blocks laid out as the image's rows
    (a planar file's planes interleaved), then unpacked with the rawmode
    (``;16N`` for the 16-bit ones)."""
    comp = t.get(259, (1,))[0]
    _, photo, fmt, fill, bits, extra = key
    tiled, tw, th, offsets, counts = _tiff_layout(t, w, h)
    planar = t.get(284, (1,))[0] == 2 and len(bits) > 1
    if planar:
        # Pillow reads LA, PA and PX planes, and RGBA without ExtraSamples,
        # to other pixels than their chunky files; the port refuses them
        if (mode not in ("RGB", "RGBA", "CMYK", "LAB")
                or len(bits) != {2: 3, 5: 4, 8: 3}[photo] + len(extra)):
            raise ValueError(f"planar TIFF of mode {mode} with {len(bits)} samples and extra "
                             f"samples {extra} is not carried by the port's codec "
                             f"({_png.NOT_PORTED}c)")
        if not tiled and len(bits) > _MODE_BANDS[mode]:
            raise ValueError("TIFF: planar strips of more samples than the mode has bands "
                             "(Pillow's libtiff decoder refuses them)")
    spp, b = len(bits), bits[0]
    if not tiled and len(offsets) == 1 and counts[:1] == (0,) and offsets[0]:
        # TIFFReadDirectory: a lone strip's byte count of 0 is bogus, estimated
        counts = (min(_estimated_count(data, bo), max(len(data) - offsets[0], 0)),)
    if photo == 3 and len(t.get(320, ())) != 3 << b:
        raise ValueError(f"TIFF: a colormap of {len(t.get(320, ()))} values for {b}-bit "
                         "indices (libtiff requires 3 * 2^bits)")
    planes, per = (spp, 1) if planar else (1, spp)
    if not tiled:
        th = min(th, h) or h
    nx, ny = -(-w // tw), -(-h // th)
    row_bytes = (tw * per * b + 7) // 8
    if len(offsets) < planes * nx * ny or len(counts) < planes * nx * ny:
        raise ValueError(f"TIFF has {min(len(offsets), len(counts))} strips or tiles of "
                         f"{planes * nx * ny}")
    predictor = t.get(317, (1,))[0] if comp in _PREDICTED else 1
    if predictor == 2 and b not in (8, 16, 32):
        raise ValueError(f"TIFF: predictor 2 with {b}-bit samples (libtiff refuses it)")
    if predictor == 3 and (fmt != (3,) or b not in (16, 32)):
        raise ValueError(f"TIFF: predictor 3 with {b}-bit samples of format {fmt} (libtiff "
                         "refuses it)")
    if predictor not in (1, 2, 3):
        raise ValueError(f"TIFF: predictor {predictor} (libtiff refuses it)")
    if comp == 7:
        if photo == 6 and per != 3:
            raise ValueError("TIFF: JPEG-compressed YCbCr of one sample (libjpeg: bogus colour "
                             "space)")
        inflate = _jpeg_inflater(t, photo, per, tw)
    elif comp in _FAX:
        inflate = _fax_inflater(t, comp, fill, tw)
    else:
        first = data[offsets[0]:offsets[0] + counts[0]]
        if fill == 2:
            first = _BITREV[np.frombuffer(first, np.uint8)].tobytes()
        compat = _lzw_compat(first)
        inflate = lambda blk, n, last: _tiff_strip(comp, blk, n * row_bytes, compat)  # noqa: E731
    img = np.empty((planes, ny * th if tiled else h, nx * row_bytes), np.uint8)
    k = 0
    for p in range(planes):
        for j in range(ny):
            n = th if tiled else min(th, h - j * th)
            for i in range(nx):
                blk = data[offsets[k]:offsets[k] + counts[k]]
                if fill == 2 and comp not in _OWN_BIT_ORDER:
                    blk = _BITREV[np.frombuffer(blk, np.uint8)].tobytes()
                img[p, j * th:j * th + n, i * row_bytes:(i + 1) * row_bytes] = np.frombuffer(
                    inflate(blk, n, not tiled and j == ny - 1), np.uint8).reshape(n, row_bytes)
                k += 1
    if b in (16, 32) and bo == ">" and predictor != 3:
        img = img.view(f">u{b // 8}").astype(f"<u{b // 8}").view(np.uint8)
    if predictor == 2:      # each sample adds the one ``per`` before it in its block's row
        v = img.view(f"<u{b // 8}").reshape(planes, -1, nx, tw, per)
        img = np.cumsum(v, axis=3, dtype=v.dtype).view(np.uint8).reshape(img.shape)
    elif predictor == 3:    # libtiff's fpAcc: bytes summed, then byte planes interleaved
        sb = b // 8
        v = img.reshape(planes, -1, nx, row_bytes // per, per)
        v = np.cumsum(v, axis=3, dtype=np.uint8).reshape(planes, -1, nx, sb, tw * per)
        img = np.ascontiguousarray(v[:, :, :, ::-1].swapaxes(3, 4)).reshape(img.shape)
    if planar:
        sb = b // 8
        img = img.reshape(planes, img.shape[1], -1, sb)[:, :, :w].transpose(1, 2, 0, 3)
        img = np.ascontiguousarray(img).reshape(img.shape[0], -1)
    if photo == 6:          # Pillow's rawmode of chunky JPEG YCbCr, which libjpeg made RGB
        raw = "RGB"
    elif planar and photo == 8:     # its one-band unpackers of the L, a and b planes
        return np.stack([_unpack(mode, c, img[:, k::3], w) for k, c in enumerate(raw)], -1)[:h]
    elif raw == "I;16":
        raw = "I;16N"
    elif raw.endswith((";16B", ";16L")):
        raw = raw[:-1] + "N"
    return _unpack(mode, raw, img if planar else img[0], w)[:h]


def decode_tiff(data: bytes) -> tuple[np.ndarray, int]:
    """The first image of a TIFF that :func:`tiff_not_carried` takes, as
    Pillow reads it then ``io/images.py`` takes it: uncompressed strips
    and tiles through Pillow's own reader, LZW, deflate, PackBits, JPEG,
    CCITT, Zstandard and LZMA ones through libtiff's, compressed YCbCr
    (but chunky JPEG) through libtiff's RGBA reader, chunky or planar, predictor 1, 2 or 3,
    either fill order, then the Orientation tag applied.  Samples: uint8
    gray, gray + alpha, RGB (palettes looked up, CMYK converted by Pillow's
    ``cmyk2rgb``, YCbCr by libjpeg or libtiff, CIELab as Pillow's
    LittleCMS transform converts it) or RGBA (a planar CIELab file's
    alpha 0, as Pillow reads it) at depth 8; uint16
    gray (Pillow's ``I;16``) and int32 gray (its ``I``: 16- and 32-bit signed, 32-bit unsigned) at
    depth 16; float samples (``F``) clamped to [0, 255] and truncated to
    uint8, as Pillow's ``convert("RGBA")`` makes them, at depth 8."""
    bo, t = _tiff_tags(data)
    why = tiff_unidentified(data)
    if why is not None:
        raise ValueError(f"cannot identify image file ({why})")
    why = tiff_not_carried(data)
    if why is not None:
        raise ValueError(f"{why[0]} is not carried by the port's codec "
                         f"({_png.NOT_PORTED}{why[1]})")
    comp = t.get(259, (1,))[0]
    if comp in _LIBTIFF_REFUSES:
        raise ValueError(f"TIFF of {_LIBTIFF_REFUSES[comp]}: Pillow's libtiff refuses it")
    key = _tiff_key(bo, t)
    mode, raw = _OPEN_INFO[key]
    w, h = t[256][0], t[257][0]
    if comp == 1:
        v = _tiff_raw(data, t, mode, raw, key[4], w, h)
    elif key[1] == 6 and (comp != 7 or t.get(284, (1,))[0] == 2):
        if len(key[4]) != 3:
            raise ValueError("TIFF: compressed YCbCr of one sample: libtiff's RGBA reader cannot "
                             "handle the format")
        v = _tiff_ycbcr(data, t, w, h)
    else:
        if key[3] == 2:
            mode, raw = _OPEN_INFO[key[:3] + (1,) + key[4:]]
        v = _tiff_libtiff(data, bo, t, key, mode, raw, w, h)
    v = _ORIENT.get(t.get(274, (1,))[0], lambda a: a)(v)
    depth = 8
    if mode in ("P", "PA"):
        cmap = np.zeros((256, 3), np.uint8)
        pal = (np.asarray(t.get(320, ()), np.uint16).reshape(3, -1).T >> 8).astype(np.uint8)
        cmap[:min(len(pal), 256)] = pal[:256]
        v = np.concatenate([cmap[v[..., 0]], v[..., 1:]], -1)
    elif mode == "CMYK":
        v = _cmyk_rgb(v)
    elif mode == "LAB":
        v = _lab_rgb(v)
        if t.get(284, (1,))[0] == 2:
            # Pillow's band unpackers leave the byte its LAB pixels hold
            # past L, a and b at 0, which its conversion carries as alpha
            v = np.concatenate([v, np.zeros_like(v[..., :1])], -1)
    elif mode == "F":
        v = _f2l(v)
    elif mode in ("I;16", "I;16B", "I"):
        depth = 16
    return np.ascontiguousarray(v), depth


def encode_tiff(arr: np.ndarray) -> bytes:
    """An uncompressed little-endian TIFF of uint8 RGB or RGBA (unassociated
    alpha) or uint16 gray [H, W], in one strip, with the tags Pillow writes
    for its ``RGB``, ``RGBA`` and ``I;16`` modes (SamplesPerPixel only for
    more than one sample)."""
    if arr.dtype == np.uint16:
        arr = arr.reshape(arr.shape[0], arr.shape[1], 1)
    h, w, c = arr.shape
    bits = 8 * arr.dtype.itemsize
    body = np.ascontiguousarray(arr, "<u2" if bits == 16 else np.uint8).tobytes()
    tags = [(256, 4, [w]), (257, 4, [h]), (258, 3, [bits] * c), (259, 3, [1]),
            (262, 3, [1 if c == 1 else 2]), (273, 4, [0])] + ([(277, 3, [c])] if c > 1 else []) \
        + [(278, 4, [h]), (279, 4, [len(body)]), (284, 3, [1])]
    if c == 4:
        tags.append((338, 3, [2]))
    ifd_size = 2 + 12 * len(tags) + 4
    extra = bytearray()
    data_at = 8 + ifd_size
    entries = []
    for tag, typ, vals in tags:
        code = _TIFF_TYPES[typ]
        raw = struct.pack("<" + code * len(vals), *vals)
        entries.append([tag, typ, len(vals), raw])
    # the out-of-line values (BitsPerSample of 3-4 samples) after the IFD
    for e in entries:
        if len(e[3]) > 4:
            e[3], extra = struct.pack("<I", data_at + len(extra)), extra + e[3]
    strip_at = data_at + len(extra)
    for e in entries:
        if e[0] == 273:
            e[3] = struct.pack("<I", strip_at)
    ifd = struct.pack("<H", len(entries)) + b"".join(
        struct.pack("<HHI", tag, typ, n) + raw.ljust(4, b"\0") for tag, typ, n, raw in entries)
    return b"II*\0" + struct.pack("<I", 8) + ifd + b"\0\0\0\0" + bytes(extra) + body
