"""The port's PNG codec: zlib + struct + numpy, no imaging library.

It stands in for two writers of the JAX package, and writes the bytes
each of them writes for the same quantised array and properties:

* 16-bit colour (types 2 and 6) as ``dspfun_tpu/io/png16.py:write_png16``:
  filter 0 on every row, ``zlib.compress(raw, 6)``, one ``IDAT``;
* 8-bit colour (types 2 and 6) and 16-bit gray (type 0) as Pillow's PNG
  plugin, through which ``dspfun_tpu/io/images.py`` writes them: the
  deflate stream of ``zlib.compressobj(6, DEFLATED, 15, 9, Z_FILTERED)``
  cut into ``IDAT`` chunks of ``max(65536, 4 * width)`` bytes, and a
  filter chosen per row by Pillow's rule (``ZipEncode.c``): the row's
  bytes are filtered with None, Up, Sub and Paeth, in that order, and a
  candidate replaces the one held when its sum of ``min(v, 256 - v)``
  over the filtered bytes is strictly smaller (Average is never tried).

Both put ``IHDR`` first, one ``tEXt`` chunk per property (latin-1) before
the image data, and ``IEND`` last.  Whole-file equality with Pillow
depends on the zlib both link; the scanline stream (filter bytes and
filtered rows) and every chunk but ``IDAT`` do not.

It reads every PNG of the standard: bit depths 1, 2, 4, 8 and 16, colour
types 0, 2, 3 (palette, with the ``tRNS`` alphas), 4 and 6, interlaced
(Adam7) or not, with all five filters, the text chunks (``tEXt``,
``zTXt``, ``iTXt``) and, for 8-bit types 0 and 2, the ``tRNS`` colour.
Palette files come back as 8-bit RGB (RGBA with ``tRNS``) and gray of
1, 2 or 4 bits scaled to 8 (Pillow's ``L``), as Pillow decodes them.

Unfiltering: a pixel needs its left, upper and upper-left neighbours
reconstructed, so pixels on one anti-diagonal are independent.
:func:`_unfilter` walks the w + h - 1 anti-diagonals with numpy
operations over all rows at once instead of looping over pixels (at
3840x2160 that is 6 thousand steps, not 8.3 million).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

__all__ = ["NOT_PORTED", "decode_png", "encode_png", "refusal", "write_png"]

_SIG = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
# Adam7: (x start, y start, x step, y step) of the seven passes
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4),
          (1, 0, 2, 2), (0, 1, 1, 2))
_COLOR_OF_CHANNELS = {1: 0, 3: 2, 4: 6}
NOT_PORTED = "ROADMAP.md queue 1, item 8"

# Pillow tries the filters in this order (ZipEncode.c) and keeps the
# first of the smallest sums
_PIL_ORDER = (0, 2, 1, 4)


def refusal(what: str, part: str = "") -> ValueError:
    """The error of an image format, or a kind of file, that the port's
    own codecs do not carry where cv2, which ``io/images.py`` reads and
    writes those through, does not import; ``part`` is the letter of its
    part of item 8.  Part ``h`` (Pillow's other formats) is refused with
    cv2 too."""
    lead, rest = ((f"{what} is not carried by the port, with or without cv2",
                   "and no other format") if part == "h" else
                  (f"{what} needs cv2, which does not import here", "and the rest only through cv2"))
    return ValueError(f"{lead}: the port reads and writes PNG, PNM, BMP, DIB, TIFF, JPEG, GIF, "
                      f"TGA, PCX, SGI, QOI, IM, ICO and DDS itself, writes MPO as JPEG, and reads "
                      f"WebP, PSD, CUR, DCX and JPEG 2000 itself (TIFF: uncompressed, LZW, "
                      f"deflate, PackBits, JPEG, CCITT RLE, Group 3 or Group 4, Zstandard or LZMA "
                      f"strips or tiles, chunky or planar, every sample layout Pillow reads, YCbCr "
                      f"and CIELab included; JPEG: baseline, extended and progressive Huffman, "
                      f"arithmetic-coded sequential and progressive, a progressive file left "
                      f"short, 8-bit lossless, gray, RGB, CMYK or YCCK; "
                      f"WebP: lossy, lossless, alpha, an animation's first frame; DDS: "
                      f"uncompressed, palette and BC1 to BC7 read, uncompressed written; JPEG "
                      f"2000: JP2 and raw codestreams, reversible and irreversible), {rest} "
                      f"({NOT_PORTED}{part})")


def _chunk(typ: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + typ + data
            + struct.pack(">I", zlib.crc32(typ + data) & 0xFFFFFFFF))


def _neighbours(rows: np.ndarray, bpp: int):
    """(left, up, upper-left) of every byte of ``rows`` [h, stride], zero
    outside the image."""
    left = np.zeros_like(rows)
    left[:, bpp:] = rows[:, :-bpp]
    up = np.zeros_like(rows)
    up[1:] = rows[:-1]
    upleft = np.zeros_like(rows)
    upleft[1:, bpp:] = rows[:-1, :-bpp]
    return left, up, upleft


def _paeth(a, b, c):
    """The Paeth predictor on int16 arrays: of a, b, c the one nearest
    a + b - c, ties in that order."""
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _filter_rows(rows: np.ndarray, bpp: int, ftype: int) -> np.ndarray:
    """Filter every row of ``rows`` (uint8 [h, stride]) with one PNG
    filter type.  Filtering reads the unfiltered neighbours, so the whole
    image goes at once."""
    if ftype == 0:
        return rows
    left, up, upleft = _neighbours(rows, bpp)
    if ftype == 1:
        return rows - left
    if ftype == 2:
        return rows - up
    a, b = left.astype(np.int16), up.astype(np.int16)
    if ftype == 3:
        return rows - ((a + b) >> 1).astype(np.uint8)
    if ftype == 4:
        return rows - _paeth(a, b, upleft.astype(np.int16)).astype(np.uint8)
    raise ValueError(f"bad PNG filter type {ftype}")


def _pil_filtered(rows: np.ndarray, bpp: int) -> tuple[np.ndarray, np.ndarray]:
    """Pillow's per-row filter choice: (filter types [h], filtered rows)."""
    best = best_sum = types = None
    for ftype in _PIL_ORDER:
        cand = _filter_rows(rows, bpp, ftype)
        # |v| of the byte read as signed, 128 counting as 128
        cost = np.minimum(cand, (256 - cand.astype(np.int16)).astype(np.uint8))
        cost = cost.sum(axis=1, dtype=np.int64)
        if best is None:
            best, best_sum = cand.copy(), cost
            types = np.zeros(rows.shape[0], np.uint8)
            continue
        take = cost < best_sum
        best[take] = cand[take]
        best_sum = np.where(take, cost, best_sum)
        types[take] = ftype
    return types, best


def encode_png(arr: np.ndarray, properties: dict | None = None,
               filter_type: int | None = None) -> bytes:
    """The PNG file of a quantised image: uint8 [H, W, 3|4], or uint16
    [H, W] (gray) or [H, W, 3|4].  ``filter_type`` forces one filter on
    every row; ``None`` takes the rule of the writer this array had in the
    JAX package (see the module's docstring)."""
    arr = np.asarray(arr)
    if arr.dtype == np.uint16 and arr.ndim == 2:
        arr = arr[:, :, None]
    if (arr.dtype not in (np.uint8, np.uint16) or arr.ndim != 3
            or arr.shape[2] not in ((1, 3, 4) if arr.dtype == np.uint16 else (3, 4))
            or 0 in arr.shape):
        raise ValueError("encode_png wants uint8 [H, W, 3|4] or uint16 [H, W] or "
                         f"[H, W, 3|4], got {arr.dtype} {arr.shape}")
    h, w, c = arr.shape
    depth = 8 * arr.dtype.itemsize
    bpp = c * arr.dtype.itemsize
    rows = np.ascontiguousarray(arr.astype(">u2") if depth == 16 else arr)
    rows = rows.view(np.uint8).reshape(h, w * bpp)
    as_pillow = not (depth == 16 and c > 1)
    if filter_type is None and as_pillow:
        types, rows = _pil_filtered(rows, bpp)
    else:
        types = np.full(h, filter_type or 0, np.uint8)
        rows = _filter_rows(rows, bpp, int(types[0]))
    raw = np.concatenate([types[:, None], rows], axis=1).tobytes()

    out = [_SIG, _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth,
                                             _COLOR_OF_CHANNELS[c], 0, 0, 0))]
    for k, v in (properties or {}).items():
        out.append(_chunk(b"tEXt", str(k).encode("latin-1") + b"\x00"
                          + str(v).encode("latin-1")))
    if as_pillow:
        z = zlib.compressobj(6, zlib.DEFLATED, 15, 9, zlib.Z_FILTERED)
        stream = z.compress(raw) + z.flush()
        size = max(65536, 4 * w)
        out += [_chunk(b"IDAT", stream[i:i + size]) for i in range(0, len(stream), size)]
    else:
        out.append(_chunk(b"IDAT", zlib.compress(raw, 6)))
    out.append(_chunk(b"IEND", b""))
    return b"".join(out)


def write_png(path_or_stream, arr: np.ndarray, properties: dict | None = None) -> None:
    """Write :func:`encode_png`'s bytes to a path or a binary stream."""
    data = encode_png(arr, properties)
    if hasattr(path_or_stream, "write"):
        path_or_stream.write(data)
    else:
        with open(path_or_stream, "wb") as f:
            f.write(data)


def _skewed(buf: np.ndarray, h: int, w: int, pad_d: int, pad_y: int) -> np.ndarray:
    """A [h, w, bpp] view of ``buf`` [w + h - 1 + pad_d, h + pad_y, bpp] whose
    pixel (y, x) is ``buf[x + y + pad_d, y + pad_y]``: row d of ``buf``
    holds anti-diagonal d - pad_d of the image."""
    row, bpp = buf.strides[0], buf.shape[2]
    return np.lib.stride_tricks.as_strided(
        buf[pad_d:, pad_y:], shape=(h, w, bpp), strides=(row + bpp, row, 1))


def _unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """Reverse PNG scanline filtering; ``raw`` is [h, 1 + stride] uint8,
    each row led by its filter type.  Returns [h, stride] uint8."""
    types = raw[:, 0]
    if types.max(initial=0) > 4:
        raise ValueError(f"bad PNG filter type {int(types.max())}")
    if not types.any():
        return raw[:, 1:]
    w = stride // bpp
    ndiag = w + h - 1
    # filtered bytes by anti-diagonal, and the reconstruction with two
    # zero diagonals before the first and a zero row above the image
    filt = np.zeros((ndiag, h, bpp), np.uint8)
    _skewed(filt, h, w, 0, 0)[...] = raw[:, 1:].reshape(h, w, bpp)
    rec = np.zeros((ndiag + 2, h + 1, bpp), np.uint8)
    kinds = [(t, (types == t)[:, None]) for t in range(1, 5) if (types == t).any()]
    for d in range(ndiag):
        lo, hi = max(0, d - w + 1), min(h - 1, d) + 1     # rows on this diagonal
        a = rec[d + 1, lo + 1:hi + 1].astype(np.int16)    # left
        b = rec[d + 1, lo:hi].astype(np.int16)            # up
        pred = np.zeros_like(a)
        for t, rows_of in kinds:
            if t == 1:
                val = a
            elif t == 2:
                val = b
            elif t == 3:
                val = (a + b) >> 1
            else:
                val = _paeth(a, b, rec[d, lo:hi].astype(np.int16))
            pred = np.where(rows_of[lo:hi], val, pred)
        rec[d + 2, lo + 1:hi + 1] = (filt[d, lo:hi] + pred).astype(np.uint8)
    return np.ascontiguousarray(_skewed(rec, h, w, 2, 1)).reshape(h, stride)


def _text(typ: bytes, body: bytes) -> tuple[str, str] | None:
    """One text chunk as Pillow's ``img.text`` holds it, or None for a
    chunk Pillow skips."""
    key, _, rest = body.partition(b"\x00")
    if not key:
        return None
    if typ == b"tEXt":
        return key.decode("latin-1"), rest.decode("latin-1")
    if typ == b"zTXt":
        if rest[:1] != b"\x00":
            return None
        return key.decode("latin-1"), zlib.decompress(rest[1:]).decode("latin-1")
    if len(rest) < 2:
        return None
    flag, method = rest[0], rest[1]
    _lang, _, rest = rest[2:].partition(b"\x00")
    _tkey, _, value = rest.partition(b"\x00")
    if flag:
        if method != 0:
            return None
        value = zlib.decompress(value)
    return key.decode("latin-1"), value.decode("utf-8")


def _unpack(rows: np.ndarray, w: int, nch: int, depth: int) -> np.ndarray:
    """Unfiltered scanlines [h, stride] as samples [h, w, nch] (uint8 for
    depths up to 8, big-endian pairs joined for 16), unscaled."""
    h = rows.shape[0]
    if depth == 16:
        pairs = rows[:, :w * nch * 2].reshape(h, w, nch, 2)
        return (pairs[..., 0].astype(np.uint16) << 8) | pairs[..., 1]
    if depth == 8:
        return rows[:, :w * nch].reshape(h, w, nch)
    bits = np.unpackbits(rows, axis=1).reshape(h, -1, depth)
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    vals = (bits * weights).sum(axis=2, dtype=np.uint8)
    return vals[:, :w * nch].reshape(h, w, nch)


def _decode_pass(raw: np.ndarray, w: int, h: int, nch: int, depth: int) -> np.ndarray:
    """One (sub)image of ``raw`` filtered bytes: samples [h, w, nch]."""
    stride = (w * nch * depth + 7) // 8
    bpp = max(1, nch * depth // 8)
    if raw.size != h * (1 + stride):
        raise ValueError(f"PNG image data holds {raw.size} bytes, not {h * (1 + stride)}")
    return _unpack(_unfilter(raw.reshape(h, 1 + stride), h, stride, bpp), w, nch, depth)


def _adam7(raw: np.ndarray, w: int, h: int, nch: int, depth: int) -> np.ndarray:
    """The seven passes of an interlaced image, each filtered on its own,
    put back on the image's grid."""
    out = np.zeros((h, w, nch), np.uint16 if depth == 16 else np.uint8)
    pos = 0
    for xs, ys, dx, dy in _ADAM7:
        pw, ph = -(-(w - xs) // dx) if w > xs else 0, -(-(h - ys) // dy) if h > ys else 0
        if not (pw and ph):
            continue
        size = ph * (1 + (pw * nch * depth + 7) // 8)
        out[ys::dy, xs::dx] = _decode_pass(raw[pos:pos + size], pw, ph, nch, depth)
        pos += size
    if pos != raw.size:
        raise ValueError(f"PNG image data holds {raw.size} bytes, not {pos}")
    return out


def _inflate(stream: bytes) -> bytes:
    """The bytes of a zlib stream as far as it goes: a stream cut short
    gives what it holds (a wrong checksum, where it is there, raises)."""
    return zlib.decompressobj().decompress(stream)


def decode_png(data: bytes, lenient: bool = False) -> tuple[np.ndarray, dict, tuple | None]:
    """Decode a PNG: (pixels [H, W, C] uint8 or uint16; text properties;
    the ``tRNS`` colour of an 8-bit type 0 or 2 file, else None).  C
    follows the colour type: palette files give 3 (4 with ``tRNS``, whose
    alphas become the fourth channel), and gray of 1, 2 or 4 bits is
    scaled to 8 (Pillow's ``L``; its ``tRNS`` gray scaled alike).
    ``lenient`` takes the image data as Pillow's decoder takes it: a zlib
    stream cut after the pixels (no end, no checksum) still reads."""
    if not data.startswith(_SIG):
        raise ValueError("not a PNG file")
    pos = 8
    idat = []
    props: dict[str, str] = {}
    head = trns = plte = None
    while pos + 8 <= len(data):
        ln, typ = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + ln]
        pos += 12 + ln
        if typ == b"IHDR":
            head = struct.unpack(">IIBBBBB", body)
        elif typ in (b"tEXt", b"zTXt", b"iTXt"):
            kv = _text(typ, body)
            if kv:
                props[kv[0]] = kv[1]
        elif typ == b"tRNS":
            trns = body
        elif typ == b"PLTE":
            plte = body
        elif typ == b"IDAT":
            idat.append(body)
        elif typ == b"IEND":
            break
    if head is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, color, _comp, _filt, interlace = head
    if depth not in _DEPTHS.get(color, ()):
        raise ValueError(f"invalid PNG: bit depth {depth} with colour type {color}")
    nch = _CHANNELS[color]
    raw = np.frombuffer(_inflate(b"".join(idat)) if lenient else zlib.decompress(b"".join(idat)),
                        dtype=np.uint8)
    out = (_adam7 if interlace else _decode_pass)(raw, w, h, nch, depth)
    if color == 3:
        if plte is None:
            raise ValueError("palette PNG without PLTE")
        pal = np.frombuffer(plte[:len(plte) // 3 * 3], np.uint8).reshape(-1, 3)
        pal = np.concatenate([pal, np.zeros((256 - len(pal), 3), np.uint8)])
        if trns is not None:
            alpha = np.full(256, 255, np.uint8)
            alpha[:len(trns)] = np.frombuffer(trns[:256], np.uint8)
            pal = np.concatenate([pal, alpha[:, None]], axis=1)
        return pal[out[..., 0]], props, None
    scale = 255 // ((1 << depth) - 1) if depth < 8 else 1
    if scale > 1:
        out = out * np.uint8(scale)
    if depth == 16:
        return out, props, None
    want = {0: 2, 2: 6}.get(color)
    trns = (tuple(v * scale for v in struct.unpack(f">{want // 2}H", trns))
            if trns is not None and want == len(trns) else None)
    return out, props, trns
