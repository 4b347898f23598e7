"""ICO read and write of the port, and the LANCZOS thumbnail its writer
needs: no Pillow.

The JAX package reads and writes ICO through Pillow 12.1's
``IcoImagePlugin``; :func:`decode_ico` and :func:`encode_ico` give its
pixels and bytes.

* **Read** (``IcoFile``, ``IcoImageFile._open``): the directory's
  entries sorted by colour depth, then by area, largest first (a width or
  height byte of 0 is 256, a depth of 0 taken from the colour count), and
  the first of them decoded, inside the open as Pillow decodes it: so
  where that decode fails with what ``Image.open`` takes as "not this
  format", :class:`rawimg.Skip` is raised and ``io/images.py`` tries the
  next format.  A PNG entry goes through ``io/png.py`` as Pillow's PNG
  plugin reads it (16-bit colour cut to its high bytes, a ``tRNS`` chunk
  not applied, since the icon does not carry the PNG's ``info``); a BMP
  entry is a DIB of twice the icon's height (``io/imgcodecs.py:bitmap``)
  whose alpha is the fourth byte of each pixel where the directory says
  32 bits, else the AND mask after the pixels.
* **Write** (``_save`` with Pillow's defaults): one PNG frame
  (``io/png.py:encode_png``) for each of the sizes 16, 24, 32, 48, 64, 128
  and 256 that the image covers (none for an image under 16 pixels),
  each ``thumbnail(size, LANCZOS, reducing_gap=None)`` of the image.
* **Thumbnail** (``Image.thumbnail`` and ``Image.resize``): the target
  size by Pillow's aspect rounding; RGBA premultiplied (``RGBa``,
  ``MULDIV255``) before the resize and divided back after; the resize
  itself ``native/rawimg.cpp``'s port of ``Resample.c`` (LANCZOS weights
  from the C library's ``sin``, 22-bit fixed point for 8-bit samples,
  double weights for 16-bit gray).
* **CUR** (``CurImageFile._open``): of the directory's entries the first,
  replaced by each later one both wider and taller, read as a DIB at the
  entry's offset with half its height (the first rows stored: no mask;
  the fourth byte of a 32-bit bitmap is alpha only where the bitmap is
  at offset 22, right after a one-entry directory, as Pillow's BMP
  plugin has it).
"""

from __future__ import annotations

import math
import re
import struct
import zlib

import numpy as np

from dspfun_tpu_torch.io import imgcodecs as _codecs
from dspfun_tpu_torch.io import png as _png
from dspfun_tpu_torch.io import rawimg as _raw

__all__ = ["BICUBIC", "ICO_SIZES", "LANCZOS", "decode_cur", "decode_ico", "encode_ico", "open_cur",
           "open_ico", "resize", "thumbnail"]

ICO_SIZES = ((16, 16), (24, 24), (32, 32), (48, 48), (64, 64), (128, 128), (256, 256))
_PNG_SIG = b"\x89PNG\r\n\x1a\n"


def _thumbnail_size(w: int, h: int, size: tuple[int, int]) -> tuple[int, int] | None:
    """``Image.thumbnail``'s target: None where the image fits."""
    x, y = size
    if x >= w and y >= h:
        return None

    def round_aspect(number, key):
        return max(min(math.floor(number), math.ceil(number), key=key), 1)

    aspect = w / h
    if x / y >= aspect:
        x = round_aspect(y * aspect, key=lambda n: abs(aspect - n / y))
    else:
        y = round_aspect(x / aspect, key=lambda n: 0 if n == 0 else abs(aspect - x / n))
    return x, y


# Resample.c's filters by the index native/rawimg.cpp takes
LANCZOS, BICUBIC = 0, 1


def resize(arr: np.ndarray, ow: int, oh: int, resample: int = LANCZOS) -> np.ndarray:
    """``Image.resize((ow, oh), resample)`` of uint8 [H, W, 3|4] (RGBA
    through ``RGBa``) or uint16 gray [H, W]; ``resample`` is
    :data:`LANCZOS` or :data:`BICUBIC` (``resize``'s default)."""
    lib = _raw._load()
    if arr.dtype == np.uint16:
        src = np.ascontiguousarray(arr)
        out = np.empty((oh, ow), np.uint16)
        ptr = lambda a: a.ctypes.data_as(_raw.ctypes.POINTER(_raw.ctypes.c_uint16))  # noqa: E731
        lib.resample_16bpc(ptr(src), src.shape[1], src.shape[0], ow, oh, resample, ptr(out))
        return out
    h, w, c = arr.shape
    src = np.ascontiguousarray(arr)
    if c == 4:  # RGBA -> RGBa: each colour times alpha, MULDIV255
        t = src[..., :3].astype(np.uint32) * src[..., 3:].astype(np.uint32) + 128
        src = np.concatenate([(((t >> 8) + t) >> 8).astype(np.uint8), src[..., 3:]], axis=-1)
    out = np.empty((oh, ow, c), np.uint8)
    lib.resample_8bpc(_raw._ptr(src), w, h, c, ow, oh, resample, _raw._ptr(out))
    if c == 4:  # RGBa -> RGBA: CLIP8(255 * x / alpha) where alpha is not 0 or 255
        a = out[..., 3:].astype(np.uint32)
        div = np.minimum(255 * out[..., :3].astype(np.uint32) // np.maximum(a, 1), 255)
        keep = (a == 0) | (a == 255)
        out[..., :3] = np.where(keep, out[..., :3], div).astype(np.uint8)
    return out


def thumbnail(arr: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """``thumbnail(size, LANCZOS, reducing_gap=None)`` of a copy of the
    image."""
    h, w = arr.shape[:2]
    target = _thumbnail_size(w, h, size)
    if target is None or target == (w, h):
        return arr
    return resize(arr, *target)


def encode_ico(arr: np.ndarray) -> bytes:
    """Pillow's ICO of uint8 RGB or RGBA or uint16 gray: a PNG frame for
    each default size the image covers."""
    if not (arr.dtype == np.uint16 and arr.ndim == 2
            or arr.dtype == np.uint8 and arr.ndim == 3 and arr.shape[2] in (3, 4)):
        raise ValueError(f"cannot write {arr.dtype} {arr.shape} as ICO")
    h, w = arr.shape[:2]
    frames = [thumbnail(arr, s) for s in ICO_SIZES if s[0] <= w and s[1] <= h]
    pngs = [_png.encode_png(f) for f in frames]
    out = [b"\0\0\1\0", struct.pack("<H", len(frames))]
    offset = 6 + 16 * len(frames)
    for f, data in zip(frames, pngs):
        fh, fw = f.shape[:2]
        out.append(struct.pack("<BBBBHHII", fw if fw < 256 else 0, fh if fh < 256 else 0, 0, 0,
                               0, 32, len(data), offset))
        offset += len(data)
    return b"".join(out + pngs)


def open_ico(data: bytes) -> list[dict]:
    """``IcoFile``: the directory's entries in Pillow's order (the one it
    opens first)."""
    if not data.startswith(b"\0\0\1\0"):
        raise _raw.Skip("not an ICO file")
    if len(data) < 6:
        raise _raw.Skip("short ICO header")
    entries = []
    for i in range(struct.unpack_from("<H", data, 4)[0]):
        s = data[6 + 16 * i:22 + 16 * i]
        if len(s) < 16:
            raise _raw.Skip("short ICO directory")
        w, h, ncol = s[0] or 256, s[1] or 256, s[2]
        bpp, size, offset = struct.unpack_from("<HII", s, 6)
        depth = bpp or (ncol != 0 and math.ceil(math.log(ncol, 2))) or 256
        entries.append(dict(dim=(w, h), bpp=bpp, size=size, offset=offset, depth=depth))
    entries.sort(key=lambda e: e["depth"])
    entries.sort(key=lambda e: e["dim"][0] * e["dim"][1], reverse=True)
    if not entries:
        raise _raw.Skip("no icon in the file")
    return entries


def _png_chunks_ok(data: bytes) -> None:
    """``PngImageFile._open`` up to the first image data: each chunk's
    header and checksum, ``rawimg.Skip`` where Pillow raises
    ``SyntaxError`` (inside the icon's open, so the next format is
    tried)."""
    pos = 8
    while True:
        if pos + 8 > len(data):
            raise _raw.Skip("short PNG chunk header")
        length, cid = struct.unpack_from(">I4s", data, pos)
        if not re.match(rb"\w\w\w\w", cid):
            raise _raw.Skip("broken PNG file")
        if cid in (b"IDAT", b"fdAT", b"IEND"):
            return
        body = data[pos + 8:pos + 8 + length]
        if len(body) < length:
            raise OSError("Truncated File Read")
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(crc) < 4 or struct.unpack(">I", crc)[0] != zlib.crc32(cid + body) & 0xFFFFFFFF:
            raise _raw.Skip("broken PNG file (bad header checksum)")
        pos += 12 + length


def _png_frame(data: bytes) -> tuple[np.ndarray, int]:
    """A PNG entry as Pillow's PNG plugin gives it inside an icon."""
    _png_chunks_ok(data)
    try:
        arr, _props, _trns = _png.decode_png(data, lenient=True)
    except (ValueError, struct.error, IndexError, zlib.error) as e:
        raise OSError(f"cannot read the icon's PNG: {e}") from None
    if data[25:26] == b"\x03" and arr.shape[2] == 4:
        arr = arr[..., :3]          # the palette's tRNS is not applied
    if arr.dtype == np.uint16:
        if arr.shape[2] == 1:
            return arr, 16          # I;16
        arr = (arr >> 8).astype(np.uint8)
    _raw.bomb_check(arr.shape[1], arr.shape[0])
    return arr, 8


def _bmp_frame(data: bytes, e: dict) -> tuple[np.ndarray, int]:
    """A BMP entry: the DIB of twice the height, its lower half, and the
    alpha of the directory's depth."""
    bm = _codecs.bitmap(data, e["offset"])
    w, h2 = bm["size"]
    if w <= 0 or h2 <= 0:
        raise _raw.Skip("an empty size: not identified by the plugin")
    _raw.bomb_check(w, h2)
    h = int(h2 / 2)
    bm["size"] = (w, h)
    if e["bpp"] == 32:
        alpha = data[bm["start"]:bm["start"] + w * h * 4][3::4]
        if len(alpha) < w * h:
            raise ValueError("not enough image data")
        mask = np.frombuffer(alpha, np.uint8, w * h).reshape(h, w)[::-1]
    else:
        wp = w + (32 - w % 32) % 32
        total = int(wp * h / 8)
        at = e["offset"] + e["size"] - total
        if at < 0:
            raise ValueError("negative seek value")
        bits = data[at:at + total]
        if len(bits) < total:
            raise ValueError("not enough image data")
        rows = np.frombuffer(bits, np.uint8, total).reshape(h, wp // 8)[::-1]
        mask = ((1 - np.unpackbits(rows, axis=1)[:, :w]) * 255).astype(np.uint8)
    rgb = _codecs.bitmap_pixels(data, bm)
    return np.ascontiguousarray(np.dstack([rgb[..., :3], mask])), 8


def decode_ico(data: bytes) -> tuple[np.ndarray, int]:
    """The icon Pillow opens (see the module's docstring)."""
    data = bytes(data)
    e = open_ico(data)[0]
    head = data[e["offset"]:e["offset"] + 8]
    if head == _PNG_SIG:
        return _png_frame(data[e["offset"]:])
    return _bmp_frame(data, e)


def open_cur(data: bytes) -> dict:
    """``CurImageFile._open``: the largest cursor by Pillow's test (both
    sides larger than the one kept), its DIB header at the entry's offset
    (or, at offset 0, right after the directory), the height halved.
    :class:`rawimg.Skip` where the plugin's open fails with what
    ``Image.open`` takes as "not this format"."""
    if not data.startswith(b"\0\0\2\0"):
        raise _raw.Skip("not a CUR file")
    try:
        n, m, pos = struct.unpack_from("<H", data, 4)[0], b"", 6
        for _ in range(n):
            s = data[pos:pos + 16]
            pos += len(s)
            if not m:
                m = s
            elif s[0] > m[0] and s[1] > m[1]:
                m = s
        if not m:
            raise _raw.Skip("No cursors were found")
        at = struct.unpack_from("<I", m, 12)[0]
    except (IndexError, struct.error) as e:
        raise _raw.Skip(f"short CUR directory ({e})") from None
    bm = _codecs.bitmap(data, at or pos)
    if at == 22 and bm["bits"] == 32 and bm["compression"] == 0:
        bm["raw"] = "BGRA"      # BmpImagePlugin's "32-bit .cur offset": the fourth byte alpha
    w, h = bm["size"]
    if h // 2 <= 0:
        raise _raw.Skip("an empty size: not identified by the plugin")
    bm["size"] = (w, h // 2)
    return bm


def decode_cur(data: bytes) -> tuple[np.ndarray, int]:
    """The cursor Pillow opens: the bitmap's pixels, palettes expanded."""
    data = bytes(data)
    return _codecs.bitmap_pixels(data, open_cur(data)), 8
