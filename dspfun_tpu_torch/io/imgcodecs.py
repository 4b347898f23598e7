"""The port's codecs for PNM, BMP and baseline TIFF: struct + numpy, no
imaging library.

The JAX package reads and writes these formats through Pillow
(``dspfun_tpu/io/images.py``).  Each decoder here returns what Pillow's
plugin decodes, as ``(samples [H, W, C], depth)`` with C in 1..4 and
uint8 samples at depth 8 or uint16 at depth 16 (Pillow's 16-bit gray
``I`` modes); ``io/images.py`` makes float RGBA of them as Pillow's
``convert("RGBA")`` does.  Each encoder writes, for the quantised arrays
``io/images.py`` hands it (uint8 RGB or RGBA, or uint16 gray), the bytes
Pillow writes (PNM and BMP) or a file Pillow decodes to the same array
(TIFF).  tests/test_torch_image_formats.py holds all of it to Pillow.

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
* **TIFF**: the first image of a baseline file, uncompressed, chunky
  strips: bilevel, gray and gray+alpha of 8 bits, 16-bit gray, RGB and
  RGBA of 8 bits (16-bit RGB keeps each sample's high byte, as Pillow's
  ``RGB`` mode does) and 8-bit palette.  Written: one strip, little
  endian, no compression.

Everything else raises ``ValueError``; compressed TIFF goes to cv2 in
``io/images.py``.
"""

from __future__ import annotations

import struct

import numpy as np

__all__ = ["decode_bmp", "decode_pnm", "decode_tiff", "encode_bmp", "encode_pnm",
           "encode_tiff", "tiff_compression"]

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


def _tiff_tags(data: bytes) -> tuple[str, dict]:
    bo = {b"II": "<", b"MM": ">"}.get(data[:2])
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
        raw = val if size <= 4 else data[struct.unpack(bo + "I", val)[0]:][:size]
        if typ == 2:
            continue
        tags[tag] = struct.unpack(bo + code * count, raw[:size])
    return bo, tags


def decode_tiff(data: bytes) -> tuple[np.ndarray, int]:
    """The first image of an uncompressed baseline TIFF, or ``ValueError``
    (:func:`tiff_compression` tells ``io/images.py`` to hand a compressed
    file to cv2 instead)."""
    bo, t = _tiff_tags(data)
    if t.get(259, (1,))[0] != 1:
        raise ValueError("compressed TIFF")
    if t.get(284, (1,))[0] != 1 or 322 in t:
        raise ValueError("TIFF: only chunky strips are read")
    if t.get(339, (1,))[0] != 1:
        raise ValueError("TIFF: only unsigned integer samples are read")
    w, h = t[256][0], t[257][0]
    spp = t.get(277, (1,))[0]
    bits = t.get(258, (1,))[0]
    photo = t[262][0]
    strips = b"".join(data[o:o + n] for o, n in zip(t[273], t[279]))
    stride = (w * spp * bits + 7) // 8
    buf = np.frombuffer(strips, np.uint8, stride * h).reshape(h, stride)
    if bits == 1 and spp == 1 and photo in (0, 1):
        v = np.unpackbits(buf, axis=1)[:, :w]
        v = v if photo == 1 else 1 - v
        return (v * 255).astype(np.uint8)[..., None], 8
    if bits == 16:
        v = buf.view(bo + "u2").reshape(h, w, spp)
        if spp == 1 and photo in (0, 1):
            v = v if photo == 1 else 65535 - v
            return v.astype(np.uint16), 16
        if photo == 2 and spp in (3, 4):
            return (v >> 8).astype(np.uint8), 8
        raise ValueError(f"TIFF: 16-bit photometric {photo} with {spp} samples")
    if bits != 8:
        raise ValueError(f"TIFF: {bits}-bit samples")
    v = buf.reshape(h, w, spp)
    if photo in (0, 1) and spp in (1, 2):
        if photo == 0:
            v = v.copy()
            v[..., 0] = 255 - v[..., 0]
        return v, 8
    if photo == 2 and spp in (3, 4):
        return v, 8
    if photo == 3 and spp == 1:
        cmap = np.asarray(t[320], np.uint16).reshape(3, -1).T
        return (cmap >> 8).astype(np.uint8)[v[..., 0]], 8
    raise ValueError(f"TIFF: photometric {photo} with {spp} samples")


def tiff_compression(data: bytes) -> int:
    """The Compression tag of the first image (1: none)."""
    return _tiff_tags(data)[1].get(259, (1,))[0]


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
