"""The port's codecs for PNM, BMP and TIFF: struct + numpy, no imaging
library.

The JAX package reads and writes these formats through Pillow
(``dspfun_tpu/io/images.py``).  Each decoder here returns what Pillow's
plugin decodes, as ``(samples [H, W, C], depth)`` with C in 1..4 and
uint8 samples at depth 8 or uint16 at depth 16 (Pillow's 16-bit gray
``I`` modes); ``io/images.py`` makes float RGBA of them as Pillow's
``convert("RGBA")`` does.  Each encoder writes, for the quantised arrays
``io/images.py`` hands it (uint8 RGB or RGBA, or uint16 gray), the bytes
Pillow writes (PNM and BMP) or a file Pillow decodes to the same array
(TIFF).  tests/test_torch_image_formats.py and test_torch_tiff.py hold
all of it to Pillow.

* **PNM** (``PpmImagePlugin``): P1 and P4 bitmaps, P2 and P5 graymaps, P3
  and P6 pixmaps at any maxval; a maxval other than 255 (and 65535 for
  raw gray) is scaled to 8 bits, or to 16 for a graymap above 255, with
  Python's ``round`` (half to even), as Pillow scales it.  Written: RGB
  (and RGBA, without its alpha) as P6, 16-bit gray as P5 with maxval
  65535.
* **BMP** (``BmpImagePlugin``): Windows headers of 40 to 124 bytes (and
  OS/2's 12), bottom-up or top-down, 1-, 4- and 8-bit palettes, 24 and
  32 bits (``BI_RGB``: the fourth byte ignored) and the 32-bit
  ``BI_BITFIELDS`` layouts with an alpha mask.  Written: RGB as 24-bit,
  RGBA as 32-bit ``BGRA``, both at 96 dpi.
* **TIFF** (``TiffImagePlugin`` and libtiff): the first image, in chunky
  strips (RowsPerStrip each, the last one short), uncompressed or
  compressed with LZW (``native/tiff.cpp``), deflate (8 and 32946, the
  standard library's zlib) or PackBits (``native/tiff.cpp``), with the
  horizontal predictor (2) undone where libtiff undoes it (LZW and
  deflate); the modes of Pillow's ``OPEN_INFO`` it lists in
  ``_TIFF_MODES``: bilevel, gray and gray+alpha of 8 bits, 16-bit gray,
  RGB and RGBA of 8 and 16 bits (16-bit colour keeps each sample's high
  byte, as Pillow's ``RGB`` mode does; associated alpha, ExtraSamples 1,
  un-premultiplied as Pillow's ``RGBa`` unpacker does it) and 8-bit
  palette.  Written: one strip, little endian, no compression.
  :func:`tiff_not_carried` names what the decoder does not take (tiles,
  planar strips, the floating-point predictor, other compressions and
  modes; ROADMAP queue 1, item 8c), which ``io/images.py`` hands to cv2.

Everything else raises ``ValueError``.
"""

from __future__ import annotations

import ctypes
import functools
import struct
import zlib

import numpy as np

from dspfun_tpu_torch import _hostbuild
from dspfun_tpu_torch.io import png as _png

__all__ = ["decode_bmp", "decode_pnm", "decode_tiff", "encode_bmp", "encode_pnm",
           "encode_tiff", "tiff_not_carried"]

_WS = b" \t\n\r\x0b\x0c"


# ---------------------------------------------------------------------------
# PNM
# ---------------------------------------------------------------------------


def _pnm_header(data: bytes, count: int) -> tuple[list[int], int]:
    """The magic's ``count`` header integers and the offset of the data
    (one whitespace byte after the last token; ``#`` comments skipped)."""
    pos, vals = 2, []
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
        vals.append(int(data[start:pos]))
    return vals, pos + 1


def _plain_tokens(body: bytes) -> list[bytes]:
    lines = [ln.split(b"#", 1)[0] for ln in body.replace(b"\r", b"\n").split(b"\n")]
    return b" ".join(lines).split()


def _scale(vals: np.ndarray, maxval: int, out_max: int) -> np.ndarray:
    """Pillow's ``min(out_max, round(value / maxval * out_max))``."""
    return np.minimum(out_max, np.rint(vals.astype(np.float64) / maxval * out_max))


def decode_pnm(data: bytes) -> tuple[np.ndarray, int]:
    magic = data[:2]
    if magic not in (b"P1", b"P2", b"P3", b"P4", b"P5", b"P6"):
        raise ValueError("not a PPM file")
    kind = magic[1] - ord("0")
    if kind in (1, 4):
        (w, h), pos = _pnm_header(data, 2)
        if kind == 4:
            stride = (w + 7) // 8
            rows = np.frombuffer(data, np.uint8, h * stride, pos).reshape(h, stride)
            bits = np.unpackbits(rows, axis=1)[:, :w]
        else:
            digits = b"".join(_plain_tokens(data[pos - 1:]))
            bits = np.frombuffer(digits[:w * h], np.uint8).reshape(h, w) - ord("0")
        return ((1 - bits) * 255).astype(np.uint8)[..., None], 8
    (w, h, maxval), pos = _pnm_header(data, 3)
    if not 0 < maxval < 65536:
        raise ValueError("maxval must be greater than 0 and less than 65536")
    nch = 1 if kind in (2, 5) else 3
    wide = nch == 1 and maxval > 255          # Pillow's mode I
    out_max = 65535 if wide else 255
    n = w * h * nch
    if kind in (2, 3):
        vals = np.array([int(t) for t in _plain_tokens(data[pos - 1:])[:n]], np.int64)
        if vals.size < n:
            raise ValueError("image file is truncated")
        vals = _scale(vals, maxval, out_max)
    else:
        vals = np.frombuffer(data, ">u2" if maxval > 255 else np.uint8, n, pos)
        if maxval != out_max:
            vals = _scale(vals, maxval, out_max)
    return vals.astype(np.uint16 if wide else np.uint8).reshape(h, w, nch), 16 if wide else 8


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
# 32-bit BI_BITFIELDS (r, g, b, a) masks Pillow reads, and the byte that
# holds each of R, G, B, A in a little-endian pixel (None: no alpha)
_BMP_MASKS = {
    (0xFF0000, 0xFF00, 0xFF, 0x0): (2, 1, 0, None),
    (0xFF000000, 0xFF0000, 0xFF00, 0x0): (3, 2, 1, None),
    (0xFF000000, 0xFF00, 0xFF, 0x0): (3, 1, 0, None),
    (0xFF000000, 0xFF0000, 0xFF00, 0xFF): (3, 2, 1, 0),
    (0xFF, 0xFF00, 0xFF0000, 0xFF000000): (0, 1, 2, 3),
    (0xFF0000, 0xFF00, 0xFF, 0xFF000000): (2, 1, 0, 3),
    (0xFF000000, 0xFF00, 0xFF, 0xFF0000): (3, 1, 0, 2),
    (0x0, 0x0, 0x0, 0x0): (2, 1, 0, 3),
}


def decode_bmp(data: bytes) -> tuple[np.ndarray, int]:
    if data[:2] not in (b"BM", b"BA", b"CI", b"CP", b"IC", b"PT"):
        raise ValueError("Not a BMP file")
    offset, hsize = struct.unpack_from("<II", data, 10)
    hd = data[18:14 + hsize]
    if hsize == 12:
        w, h, _planes, bits = struct.unpack_from("<HHHH", hd)
        comp, colors, pad, down = 0, 0, 3, False
    elif hsize in (40, 52, 56, 64, 108, 124):
        w, h, _planes, bits, comp = struct.unpack_from("<iiHHI", hd)
        colors = struct.unpack_from("<I", hd, 28)[0]
        pad, down = 4, h < 0
        h = abs(h)
    else:
        raise ValueError(f"Unsupported BMP header type ({hsize})")
    pal_at = 14 + hsize
    order = (2, 1, 0, None)
    if comp == 3:
        if bits != 32:
            raise ValueError("Unsupported BMP bitfields layout")
        n = 4 if hsize >= 56 else 3
        masks = struct.unpack_from(f"<{n}I", data, 54) + ((0,) if n == 3 else ())
        if hsize == 40:
            pal_at += 12
        if masks not in _BMP_MASKS:
            raise ValueError("Unsupported BMP bitfields layout")
        order = _BMP_MASKS[masks]
    elif comp != 0:
        raise ValueError(f"Unsupported BMP compression ({comp})")
    if bits not in (1, 4, 8, 24, 32):
        raise ValueError(f"Unsupported BMP pixel depth ({bits})")
    stride = ((w * bits + 31) >> 3) & ~3
    rows = np.frombuffer(data, np.uint8, stride * h, offset).reshape(h, stride)
    if not down:
        rows = rows[::-1]
    if bits <= 8:
        ncol = colors or (1 << bits)
        pal = np.frombuffer(data, np.uint8, pad * ncol, pal_at).reshape(ncol, pad)[:, 2::-1]
        idx = np.unpackbits(rows, axis=1).reshape(h, -1, bits) if bits < 8 else rows[..., None]
        if bits < 8:
            idx = (idx * (1 << np.arange(bits - 1, -1, -1))).sum(axis=2)[..., None]
        full = np.zeros((256, 3), np.uint8)
        full[:min(ncol, 256)] = pal[:256]
        return full[idx[:, :w, 0]], 8
    px = rows[:, :w * bits // 8].reshape(h, w, bits // 8)
    chans = [px[..., i] for i in order if i is not None]
    return np.stack(chans, axis=-1), 8


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


# ---------------------------------------------------------------------------
# TIFF
# ---------------------------------------------------------------------------

_TIFF_TYPES = {1: "B", 2: "c", 3: "H", 4: "I", 5: "II", 6: "b", 8: "h", 9: "i", 16: "Q"}
# the compressions decode_tiff undoes, and the names of some it does not
_TIFF_CARRIED = {1: "uncompressed", 5: "LZW", 8: "deflate", 32946: "deflate",
                 32773: "PackBits"}
_TIFF_OTHERS = {2: "CCITT RLE", 3: "CCITT Group 3", 4: "CCITT Group 4", 6: "old-style JPEG",
                7: "JPEG", 32809: "ThunderScan", 34676: "SGILog", 34677: "SGILog24",
                34925: "LZMA", 50000: "Zstandard", 50001: "WebP"}
_PREDICTED = (5, 8, 32946)      # the codecs libtiff runs the predictor with
# Pillow's OPEN_INFO entries that decode_tiff carries, of either byte
# order: (photometric, bits per sample, ExtraSamples) -> (mode, what the
# extra samples are: None, "X" ignored, "A" unassociated alpha, "a"
# associated alpha, then X).  16-bit photometric 0 is little-endian only.
_TIFF_MODES = {
    **{(p, (1,), ()): ("1", None) for p in (0, 1)},
    **{(p, (8,), ()): ("L", None) for p in (0, 1)},
    (1, (16,), ()): ("I;16", None),
    (1, (8, 8), (2,)): ("LA", None),
    (3, (8,), ()): ("P", None),
    **{(2, (b,) * 3, ()): ("RGB", None) for b in (8, 16)},
    **{(2, (b,) * 4, ()): ("RGBA", "A") for b in (8, 16)},
    **{(2, (b,) * 4, (k,)): ("RGBA" if k else "RGB", "XaA"[k]) for b in (8, 16)
       for k in (0, 1, 2)},
    (2, (8,) * 4, (999,)): ("RGBA", "A"),
    **{(2, (8,) * (4 + n), (k,) + (0,) * n): ("RGBA" if k else "RGB", "XaA"[k])
       for n in (1, 2) for k in (0, 1, 2)},
}


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


def _tiff_mode(bo: str, t: dict) -> tuple[tuple, int, int] | None:
    """((mode, extra kind), samples per pixel, bits) of the first image as
    Pillow's ``TiffImagePlugin._setup`` keys it (photometric 0 where the
    tag is missing, one BitsPerSample for all samples), or None where
    decode_tiff does not carry that key."""
    spp = t.get(277, (1,))[0]
    bits = t.get(258, (1,))
    if len(bits) > spp:
        bits = bits[:spp]
    elif len(bits) == 1:
        bits = bits * spp
    if len(bits) != spp or any(f != 1 for f in t.get(339, (1,))):
        return None
    key = (t.get(262, (0,))[0], bits, t.get(338, ()))
    mode = ("I;16", None) if key == (0, (16,), ()) and bo == "<" else _TIFF_MODES.get(key)
    return None if mode is None else (mode, spp, bits[0])


def tiff_not_carried(data: bytes) -> tuple[str, str] | None:
    """None where :func:`decode_tiff` decodes the first image of this
    TIFF, else (what it is, the letter of its part of ROADMAP queue 1
    item 8), which ``io/images.py`` hands to cv2 or names in its
    refusal."""
    bo, t = _tiff_tags(data)
    comp = t.get(259, (1,))[0]
    if comp not in _TIFF_CARRIED:
        return f"{_TIFF_OTHERS.get(comp, f'compression {comp}')} TIFF", "c"
    if t.get(284, (1,))[0] != 1:
        return "planar TIFF (PlanarConfiguration 2)", "c"
    if 322 in t or 324 in t:
        return "tiled TIFF", "c"
    if comp in _PREDICTED and t.get(317, (1,))[0] == 3:
        return "TIFF with the floating-point predictor", "c"
    if t.get(266, (1,))[0] != 1:
        return "TIFF of FillOrder 2", "c"
    if _tiff_mode(bo, t) is None:
        return (f"TIFF of photometric {t.get(262, (0,))[0]} with "
                f"{t.get(258, (1,))} bits and extra samples {t.get(338, ())}"), "c"
    return None


@functools.lru_cache(maxsize=None)
def _tiff_lib() -> ctypes.CDLL:
    """The loaded ``native/tiff.cpp`` (LZW and PackBits) with its
    signatures declared (built on first use; raises when it cannot be
    built)."""
    lib = _hostbuild.load_library("tiff")
    for fn in (lib.tif_lzw_decode, lib.tif_packbits_decode):
        fn.restype = ctypes.c_int64
        fn.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64]
    return lib


def _tiff_strip(comp: int, raw: bytes, size: int) -> bytes:
    """One strip decompressed to ``size`` bytes (the extra output of a
    longer stream ignored, as libtiff ignores it), or ``ValueError``."""
    if comp in (8, 32946):
        try:
            out = zlib.decompressobj().decompress(raw, size)
        except zlib.error as e:
            raise ValueError(f"corrupt deflate TIFF strip: {e}") from None
    else:
        lib = _tiff_lib()
        fn = lib.tif_lzw_decode if comp == 5 else lib.tif_packbits_decode
        buf = ctypes.create_string_buffer(size)
        n = fn(raw, len(raw), buf, size)
        if n == -2:
            raise ValueError("old-style (LSB-first) LZW TIFF is not carried by the port's "
                             f"codec ({_png.NOT_PORTED}c)")
        if n < 0:
            raise ValueError("corrupt LZW TIFF strip")
        out = buf.raw[:n]
    if len(out) < size:
        raise ValueError(f"{_TIFF_CARRIED[comp]} TIFF strip holds {len(out)} of its {size} "
                         "bytes (truncated or corrupt file)")
    return out


def _tiff_rows(data: bytes, bo: str, t: dict, h: int, stride: int) -> np.ndarray:
    """The image's rows, uint8 [h, stride] in the file's byte order: the
    strips gathered (RowsPerStrip of them each, the last one short) and
    decompressed, and the horizontal predictor undone."""
    comp = t.get(259, (1,))[0]
    offsets, counts = t.get(273, ()), t.get(279, ())
    if comp == 1:
        strips = b"".join(data[o:o + n] for o, n in zip(offsets, counts))
        if len(strips) < stride * h:
            raise ValueError("uncompressed TIFF strips are truncated")
        return np.frombuffer(strips, np.uint8, stride * h).reshape(h, stride)
    rps = min(t.get(278, (h,))[0], h) or h
    nstrips = -(-h // rps)
    if len(offsets) < nstrips or len(counts) < nstrips:
        raise ValueError(f"TIFF has {len(offsets)} strips of {nstrips}")
    rows = np.empty((h, stride), np.uint8)
    for i in range(nstrips):
        y = i * rps
        n = min(rps, h - y)
        raw = data[offsets[i]:offsets[i] + counts[i]]
        rows[y:y + n] = np.frombuffer(_tiff_strip(comp, raw, n * stride), np.uint8).reshape(n, -1)
    predictor = t.get(317, (1,))[0] if comp in _PREDICTED else 1
    if predictor == 1:
        return rows
    _, spp, bits = _tiff_mode(bo, t)
    if predictor != 2 or bits not in (8, 16):
        raise ValueError(f"TIFF: predictor {predictor} with {bits}-bit samples (libtiff "
                         "refuses it)")
    # horizontal differencing: each sample adds the one spp before it in
    # its row, modulo 2^bits, on the values in the file's byte order
    w = t[256][0]
    if bits == 8:
        return np.cumsum(rows.reshape(h, w, spp), axis=1, dtype=np.uint8).reshape(h, stride)
    v = np.cumsum(rows.view(bo + "u2").reshape(h, w, spp), axis=1, dtype=np.uint16)
    return v.astype(bo + "u2").view(np.uint8).reshape(h, stride)


def _unpremultiply(rgb: np.ndarray, a: np.ndarray) -> np.ndarray:
    """Pillow's ``RGBa`` unpacker (Unpack.c): alpha 0 gives 0, any other
    alpha ``min(c * 255 // a, 255)`` (255 copies)."""
    a = a.astype(np.int32)[..., None]
    c = np.minimum(rgb.astype(np.int32) * 255 // np.maximum(a, 1), 255)
    return np.where(a == 0, 0, c).astype(np.uint8)


def decode_tiff(data: bytes) -> tuple[np.ndarray, int]:
    """The first image of a TIFF that :func:`tiff_not_carried` takes:
    uncompressed, LZW, deflate or PackBits strips, chunky, predictor 1 or
    2; samples as Pillow's mode for it holds them."""
    bo, t = _tiff_tags(data)
    why = tiff_not_carried(data)
    if why is not None:
        raise ValueError(f"{why[0]} is not carried by the port's codec "
                         f"({_png.NOT_PORTED}{why[1]})")
    (mode, extra), spp, bits = _tiff_mode(bo, t)
    try:
        w, h = t[256][0], t[257][0]
    except KeyError:
        raise ValueError("TIFF: missing dimensions") from None
    stride = (w * spp * bits + 7) // 8
    buf = _tiff_rows(data, bo, t, h, stride)
    photo = t.get(262, (0,))[0]
    if mode == "1":
        v = np.unpackbits(buf, axis=1)[:, :w]
        v = v if photo == 1 else 1 - v
        return (v * 255).astype(np.uint8)[..., None], 8
    if mode == "I;16":      # photometric 0 too: Pillow's rawmode I;16 does not invert
        return buf.view(bo + "u2").reshape(h, w, 1).astype(np.uint16), 16
    if bits == 16:          # RGB(A) keep each sample's high byte
        v = (buf.view(bo + "u2").reshape(h, w, spp) >> 8).astype(np.uint8)
    else:
        v = buf.reshape(h, w, spp)
    if mode == "L":
        return (v if photo == 1 else 255 - v), 8
    if mode == "LA":
        return v, 8
    if mode == "P":
        cmap = np.asarray(t[320], np.uint16).reshape(3, -1).T
        return (cmap >> 8).astype(np.uint8)[v[..., 0]], 8
    if extra in (None, "X"):
        return v[..., :3], 8
    if extra == "a":
        return np.concatenate([_unpremultiply(v[..., :3], v[..., 3]), v[..., 3:4]], -1), 8
    return v[..., :4], 8


def encode_tiff(arr: np.ndarray) -> bytes:
    """An uncompressed little-endian TIFF of uint8 RGB or RGBA (unassociated
    alpha) or uint16 gray [H, W], in one strip."""
    if arr.dtype == np.uint16:
        arr = arr.reshape(arr.shape[0], arr.shape[1], 1)
    h, w, c = arr.shape
    bits = 8 * arr.dtype.itemsize
    body = np.ascontiguousarray(arr, "<u2" if bits == 16 else np.uint8).tobytes()
    tags = [(256, 4, [w]), (257, 4, [h]), (258, 3, [bits] * c), (259, 3, [1]),
            (262, 3, [1 if c == 1 else 2]), (273, 4, [0]), (277, 3, [c]),
            (278, 4, [h]), (279, 4, [len(body)]), (284, 3, [1])]
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
