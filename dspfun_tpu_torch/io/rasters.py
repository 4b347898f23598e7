"""Pillow 12.1's header-and-rows raster formats, read by the port's own
code with no Pillow: FITS, Sun raster, XBM, XPM, MSP, SPIDER, PIXAR,
McIdas, XV thumbnail, GBR and IMT.

Each format is an ``open_*`` (the plugin's accept test and ``_open``:
:class:`rawimg.Skip` where ``Image.open`` would try the next plugin, any
other error where the open fails) and a ``decode_*`` (what ``load`` and
the JAX package's ``read_image`` make of the image: uint8 [H, W, C]
samples, uint16 gray at depth 16 for ``I;16``, int32 gray at depth 16 for
``I``, float mode ``F`` clamped and truncated to 8 bits as its
``convert("RGBA")`` goes through ``L``).  Pillow's reading is copied, not
corrected:

* **FITS** (``FitsImagePlugin``): the 80-byte cards up to each END, a
  BINTABLE ``ZIMAGE`` HDU after a data-less primary; raw data read
  bottom-up with Pillow's native little-endian raw modes on FITS's
  big-endian samples (BITPIX 8, 16, 32, -32 to ``L``, ``I;16``, ``I``,
  ``F``; BITPIX -64 as ``F``, so as pairs of float32 over the first half of
  the data); ``GZIP_1`` through ``FitsGzipDecoder`` (gzip of the rest of the
  file, the last ``min(BITPIX // 8, 4)`` bytes of each 4-byte sample, rows
  reversed, read as the mode's raw mode again);
* **Sun raster** (``SunImagePlugin``): depths 1 (``1;I``), 4 (``L;4``), 8,
  24 and 32 (RGB order for type 3, BGR otherwise), a colour map
  (``RGB;L``) turning 1- and 8-bit gray into ``P`` (and failing the load
  of ``1`` and ``RGB``, as Pillow's does), rows padded to 16 bits, type 2
  through ``native/rawimg.cpp:sun_rle_decode`` (unpadded rows);
* **XBM** (hex bytes through ``native/rawimg.cpp:xbm_decode``, ``1;R``),
  **XPM** (``c #rrggbb`` and ``None`` colour keys; ``P`` up to 256
  colours, ``RGB`` above; the ``None`` key's bytes as the palette's first
  alphas, as ``convert`` takes a bytes transparency, which fails the
  conversion of ``RGB``);
* **MSP**: version 1 raw rows, version 2 through
  ``native/rawimg.cpp:msp_rle_decode`` (``MspDecoder``);
* **SPIDER**: the first image of a file or stack, float32 of either byte
  order; written (:func:`encode_spider`) as ``SpiderImagePlugin._save``
  writes the JAX package's ``RGB``, ``RGBA`` and ``I;16`` images;
* **PIXAR** (``RGB`` at 1024), **McIdas** (8-, 16- and 32-bit big-endian
  with its stride), **XV thumbnail** (3-3-2 palette), **GBR** (versions 1
  and 2, ``L`` or ``RGBA``) and **IMT** (``L``).
"""

from __future__ import annotations

import ctypes
import gzip
import io
import math
import re
import struct

import numpy as np

from dspfun_tpu_torch.io import imgcodecs as _codecs
from dspfun_tpu_torch.io import rawimg as _raw

__all__ = ["decode_fits", "decode_gbr", "decode_imt", "decode_mcidas", "decode_msp",
           "decode_pixar", "decode_spider", "decode_sun", "decode_xbm", "decode_xpm",
           "decode_xvthumb", "encode_spider", "open_fits", "open_gbr", "open_imt",
           "open_mcidas", "open_msp", "open_pixar", "open_spider", "open_sun", "open_xbm",
           "open_xpm", "open_xvthumb", "to_float"]

_Skip = _raw.Skip


def _be32(d: bytes, o: int) -> int:
    """``i32be`` of a header read: a short one is Pillow's ``struct.error``."""
    if len(d) < o + 4:
        raise _Skip("short header")
    return struct.unpack_from(">I", d, o)[0]


def _open(size: tuple, mode: str) -> None:
    """``ImageFile.__init__``'s checks after ``_open`` and ``Image.open``'s
    decompression-bomb check."""
    if not mode or size[0] <= 0 or size[1] <= 0:
        raise _Skip("an empty size or no mode: not identified by the plugin")
    _raw.bomb_check(*size)


def _rows(data: bytes, pos: int, rowbytes: int, h: int, stride: int = 0) -> np.ndarray:
    """Pillow's raw decoder: h rows of ``rowbytes`` from ``pos``, each
    ``stride`` bytes apart (the last one's padding not needed)."""
    stride = stride or rowbytes
    if stride < rowbytes:
        raise OSError("decoder error -8")       # IMAGING_CODEC_CONFIG
    if pos < 0:
        raise ValueError("Tile offset cannot be negative")
    if pos + (h - 1) * stride + rowbytes > len(data):
        raise OSError("image file is truncated")
    if pos + h * stride > len(data):       # the last row's padding past the end
        data = data + bytes(stride - rowbytes)
    return np.frombuffer(data, np.uint8, h * stride, pos).reshape(h, stride)[:, :rowbytes]


def _samples(rows: np.ndarray, w: int, dtype: str) -> np.ndarray:
    return np.ascontiguousarray(rows[:, :w * np.dtype(dtype).itemsize]).view(dtype)


def _gray(v: np.ndarray, mode: str) -> tuple[np.ndarray, int]:
    """One sample plane of the modes the JAX package reads as gray: ``L``
    and ``1`` (uint8), ``I;16`` (uint16, depth 16), ``I`` (int32, depth 16)
    and ``F`` (through ``L``)."""
    if mode == "F":
        return _codecs._f2l(v.astype(np.float32))[..., None], 8
    if mode in ("I;16", "I;16B"):
        return np.ascontiguousarray(v.astype(np.uint16))[..., None], 16
    if mode == "I":
        return np.ascontiguousarray(v.astype(np.int32))[..., None], 16
    return np.ascontiguousarray(v.astype(np.uint8))[..., None], 8


def _bits(rows: np.ndarray, w: int, order: str = "big", invert: bool = False) -> np.ndarray:
    """1-bit rows as 0/255 (``1``, ``1;R`` LSB first, ``1;I`` inverted)."""
    bits = np.unpackbits(rows, axis=1, bitorder=order)[:, :w]
    return ((bits ^ invert) * 255).astype(np.uint8)


def _palette_rgb(pal: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """P samples through a palette of [n, 3] entries (opaque black past
    them, as Pillow's palette is)."""
    full = np.zeros((256, 3), np.uint8)
    full[:min(len(pal), 256)] = pal[:256]
    return full[idx]


# ---- FITS ---------------------------------------------------------------------------

_FITS_MODES = {8: ("L", "u1"), 16: ("I;16", "<u2"), 32: ("I", "<i4"), -32: ("F", "<f4"),
               -64: ("F", "<f4")}


def _fits_size(headers: dict, prefix: bytes):
    naxis = int(headers[prefix + b"NAXIS"])
    if naxis == 0:
        return None
    if naxis == 1:
        return 1, int(headers[prefix + b"NAXIS1"])
    return int(headers[prefix + b"NAXIS1"]), int(headers[prefix + b"NAXIS2"])


def _fits_parse(headers: dict, info: dict) -> str:
    """``_parse_headers``: the decoder's name ('' where there is no image)
    with the size, mode, offset and BITPIX into ``info``."""
    prefix, decoder, offset = b"", "raw", 0
    if (headers.get(b"XTENSION") == b"'BINTABLE'" and headers.get(b"ZIMAGE") == b"T"
            and headers[b"ZCMPTYPE"] == b"'GZIP_1  '"):
        w, h = _fits_size(headers, prefix) or (0, 0)
        offset = w * h * (int(headers[b"BITPIX"]) // 8)
        prefix, decoder = b"Z", "fits_gzip"
    size = _fits_size(headers, prefix)
    if not size:
        return ""
    bitpix = int(headers[prefix + b"BITPIX"])
    info.update(size=size, bitpix=bitpix, offset=offset)
    if bitpix in _FITS_MODES:
        info["mode"] = _FITS_MODES[bitpix][0]
    return decoder


def open_fits(data: bytes) -> dict:
    """``FitsImageFile._open``: the cards read 80 bytes at a time (a short
    last read counts as one), each header ended by END and the next read
    from the following 2880-byte boundary; the data starts where the card
    after the image's header starts.  A missing keyword is Pillow's
    ``KeyError`` (the file passed on); a value that is no integer raises."""
    if not data.startswith(b"SIMPLE"):
        raise _Skip("not a FITS file")
    try:
        return _fits_open(data)
    except KeyError as e:
        raise _Skip(f"FITS: no {e}") from None


def _fits_open(data: bytes) -> dict:
    headers, info, decoder, in_header, pos = {}, {"mode": ""}, "", False, 0
    while True:
        card = data[pos:pos + 80]
        pos += len(card)
        if not card:
            raise OSError("Truncated FITS file")
        keyword = card[:8].strip()
        if keyword in (b"SIMPLE", b"XTENSION"):
            in_header = True
        elif headers and not in_header:
            break
        elif keyword == b"END":
            pos = math.ceil(pos / 2880) * 2880
            if not decoder:
                decoder = _fits_parse(headers, info)
            in_header = False
            continue
        if decoder:
            continue
        value = card[8:].split(b"/")[0].strip()
        if value.startswith(b"="):
            value = value[1:].strip()
        if not headers and (not keyword.startswith(b"SIMPLE") or value != b"T"):
            raise _Skip("Not a FITS file")
        headers[keyword] = value
    if not decoder:
        raise ValueError("No image data")
    info.update(decoder=decoder, offset=info["offset"] + pos - 80)
    _open(info["size"], info["mode"])
    return info


def decode_fits(data: bytes) -> tuple[np.ndarray, int]:
    data = bytes(data)
    f = open_fits(data)
    (w, h), mode, dtype = f["size"], f["mode"], _FITS_MODES[f["bitpix"]][1]
    size = np.dtype(dtype).itemsize
    if f["decoder"] == "raw":
        v = _samples(_rows(data, f["offset"], w * size, h), w, dtype)[::-1]
    else:
        if f["offset"] < 0:
            raise ValueError("Tile offset cannot be negative")
        value = np.frombuffer(gzip.decompress(data[f["offset"]:]), np.uint8)
        n = min(f["bitpix"] // 8, 4)
        if n <= 0 or value.size < 4 * w * h:
            raise ValueError("not enough image data")
        raw = value[:4 * w * h].reshape(h, w, 4)[::-1, :, 4 - n:]
        v = np.ascontiguousarray(raw).reshape(h, w * n).view(dtype)
    return _gray(v, mode)


# ---- Sun raster ---------------------------------------------------------------------

# depth -> (mode, raw mode, bits); 24 and 32 bits BGR unless the type is 3
_SUN_MODES = {1: ("1", "1;I", 1), 4: ("L", "L;4", 4), 8: ("L", "L", 8), 24: ("RGB", "BGR", 24),
              32: ("RGB", "BGRX", 32)}


def open_sun(data: bytes) -> dict:
    """``SunImageFile._open``: the 32-byte header, the colour map (at most
    1024 bytes, type 1), the 16-bit row stride, types 0-5."""
    if _be32(data[:4], 0) != 0x59A66A95:
        raise _Skip("not a SUN raster file")
    s = data[:32]
    w, h, depth = _be32(s, 4), _be32(s, 8), _be32(s, 12)
    ftype, ptype, plen = _be32(s, 20), _be32(s, 24), _be32(s, 28)
    if depth not in _SUN_MODES:
        raise _Skip("Unsupported Mode/Bit Depth")
    mode, raw, bits = _SUN_MODES[depth]
    if depth >= 24 and ftype == 3:
        raw = raw.replace("BGR", "RGB")
    palette, offset = None, 32
    if plen:
        if plen > 1024:
            raise _Skip("Unsupported Color Palette Length")
        if ptype != 1:
            raise _Skip("Unsupported Palette Type")
        palette, offset = data[32:32 + plen], 32 + plen
        if mode == "L":
            mode, raw = "P", raw.replace("L", "P")
    if ftype not in (0, 1, 2, 3, 4, 5):
        raise _Skip("Unsupported Sun Raster file type")
    _open((w, h), mode)
    return dict(size=(w, h), mode=mode, raw=raw, bits=bits, palette=palette, offset=offset,
                rle=ftype == 2, stride=((w * depth + 15) // 16) * 2)


def decode_sun(data: bytes) -> tuple[np.ndarray, int]:
    data = bytes(data)
    s = open_sun(data)
    (w, h), raw = s["size"], s["raw"]
    if s["palette"] is not None and s["mode"] != "P":
        raise ValueError("unrecognized image mode")     # Pillow's putpalette on 1 or RGB
    rowbytes = (w * s["bits"] + 7) // 8
    if s["rle"]:
        rows = np.empty((h, rowbytes), np.uint8)
        _raw._check(_raw._load().sun_rle_decode(data, len(data), s["offset"], rowbytes, h,
                                           _raw._ptr(rows)))
    else:
        rows = _rows(data, s["offset"], rowbytes, h, s["stride"])
    if raw == "1;I":
        return _bits(rows, w, invert=True)[..., None], 8
    if raw in ("L;4", "P;4"):
        v = np.stack([rows >> 4, rows & 15], -1).reshape(h, -1)[:, :w]
        v = v * 17 if raw == "L;4" else v
    elif raw in ("L", "P"):
        v = rows[:, :w]
    else:
        px = rows[:, :w * len(raw.split(";")[0])].reshape(h, w, -1)[..., :3]
        return np.ascontiguousarray(px[..., ::-1] if raw.startswith("BGR") else px), 8
    if s["mode"] != "P":
        return np.ascontiguousarray(v.astype(np.uint8))[..., None], 8
    n = len(s["palette"]) // 3
    pal = np.frombuffer(s["palette"][:3 * n], np.uint8).reshape(3, n).T     # RGB;L
    return _palette_rgb(pal, v), 8


# ---- XBM and XPM --------------------------------------------------------------------

_XBM_HEAD = re.compile(
    rb"\s*#define[ \t]+.*_width[ \t]+(?P<width>[0-9]+)[\r\n]+"
    b"#define[ \t]+.*_height[ \t]+(?P<height>[0-9]+)[\r\n]+"
    b"(?P<hotspot>"
    b"#define[ \t]+[^_]*_x_hot[ \t]+(?P<xhot>[0-9]+)[\r\n]+"
    b"#define[ \t]+[^_]*_y_hot[ \t]+(?P<yhot>[0-9]+)[\r\n]+"
    b")?"
    rb"[\000-\377]*_bits\[]")


def open_xbm(data: bytes) -> dict:
    """``XbmImageFile._open``: the header matched in the first 512 bytes;
    the bits start after its (last) ``_bits[]``."""
    if not data[:16].lstrip().startswith(b"#define"):
        raise _Skip("not an XBM file")
    m = _XBM_HEAD.match(data[:512])
    if not m:
        raise _Skip("not a XBM file")
    size = int(m.group("width")), int(m.group("height"))
    _open(size, "1")
    return dict(size=size, offset=m.end())


def decode_xbm(data: bytes) -> tuple[np.ndarray, int]:
    data = bytes(data)
    x = open_xbm(data)
    (w, h), rowbytes = x["size"], (x["size"][0] + 7) // 8
    rows = np.empty((h, rowbytes), np.uint8)
    _raw._check(_raw._load().xbm_decode(data, len(data), x["offset"], rowbytes, h, _raw._ptr(rows)))
    return _bits(rows, w, "little")[..., None], 8


_XPM_HEAD = re.compile(b'"([0-9]*) ([0-9]*) ([0-9]*) ([0-9]*)')


def open_xpm(data: bytes) -> dict:
    """``XpmImageFile._open``: the values line, then a colour line per
    colour (the key's ``c`` value ``#rrggbb`` or ``None``; any other value,
    or no ``c``, raises); ``P`` up to 256 colours, else ``RGB``."""
    if not data.startswith(b"/* XPM */"):
        raise _Skip("not an XPM file")
    fp = io.BytesIO(data)
    fp.seek(9)
    while True:
        line = fp.readline()
        if not line:
            raise _Skip("broken XPM file")
        m = _XPM_HEAD.match(line)
        if m:
            break
    size = int(m.group(1)), int(m.group(2))
    ncolors, bpp = int(m.group(3)), int(m.group(4))
    palette, transparency = {}, None
    try:
        for _ in range(ncolors):
            line = fp.readline().rstrip()
            c, s = line[1:bpp + 1], line[bpp + 1:-2].split()
            for i in range(0, len(s), 2):
                if s[i] == b"c":
                    rgb = s[i + 1]
                    if rgb == b"None":
                        transparency = c
                    elif rgb.startswith(b"#"):
                        v = int(rgb[1:], 16)
                        palette[c] = bytes([(v >> 16) & 255, (v >> 8) & 255, v & 255])
                    else:
                        raise ValueError("cannot read this XPM file")
                    break
            else:
                raise ValueError("cannot read this XPM file")
    except IndexError as e:     # a "c" with no value: Pillow's SyntaxError
        raise _Skip(f"XPM: {e}") from None
    mode = "RGB" if ncolors > 256 else "P"
    _open(size, mode)
    return dict(size=size, mode=mode, bpp=bpp, palette=palette, transparency=transparency,
                offset=fp.tell())


def decode_xpm(data: bytes) -> tuple[np.ndarray, int]:
    """``XpmDecoder``: each line's text between its first and last quote,
    cut into keys of ``bpp`` bytes (an unknown key raises), until the image
    is full; a ``/* pixels */`` line skipped once."""
    data = bytes(data)
    x = open_xpm(data)
    (w, h), bpp, palette, rgb = x["size"], x["bpp"], x["palette"], x["mode"] == "RGB"
    keys = {k: i for i, k in enumerate(palette)}
    want = w * h * (3 if rgb else 1)
    out, header = bytearray(), False
    fp = io.BytesIO(data)
    fp.seek(x["offset"])
    while len(out) < want:
        line = fp.readline()
        if not line:
            break
        if line.rstrip() == b"/* pixels */" and not header:
            header = True
            continue
        line = b'"'.join(line.split(b'"')[1:-1])
        for i in range(0, len(line), bpp):
            key = line[i:i + bpp]
            if rgb:
                out += palette[key]
            elif key in keys:
                out.append(keys[key])
            else:
                raise ValueError(f"{key!r} is not in the XPM palette")
    if len(out) < want:
        raise ValueError("not enough image data")
    v = np.frombuffer(bytes(out[:want]), np.uint8)
    t = x["transparency"]
    if rgb:
        if t is not None:   # convert_transparent takes no bytes
            raise TypeError("'bytes' object cannot be interpreted as an integer")
        return v.reshape(h, w, 3).copy(), 8
    pal = np.zeros((256, 4), np.uint8)
    pal[:, 3] = 255
    entries = np.frombuffer(b"".join(palette.values()), np.uint8).reshape(-1, 3)
    pal[:len(entries), :3] = entries
    if t is not None:       # putpalettealphas: the key's bytes as the first alphas
        if len(t) > 256:
            raise ValueError("invalid palette size")
        pal[:len(t), 3] = np.frombuffer(t, np.uint8)
    return pal[v.reshape(h, w)], 8


# ---- MSP ----------------------------------------------------------------------------

_MSP_ERRORS = {-2: "Truncated MSP file in row map",
               -3: "Truncated MSP file, expected more bytes on row {}",
               -4: "Corrupted MSP file in row {}"}


def open_msp(data: bytes) -> dict:
    """``MspImageFile._open``: the 32-byte header, its 16 words XOR 0."""
    if not data.startswith((b"DanM", b"LinS")):
        raise _Skip("not an MSP file")
    if len(data) < 32:
        raise _Skip("short MSP header")
    words = struct.unpack_from("<16H", data)
    if np.bitwise_xor.reduce(np.asarray(words)) != 0:
        raise _Skip("bad MSP checksum")
    size = words[2], words[3]
    _open(size, "1")
    return dict(size=size, rle=data.startswith(b"LinS"))


def decode_msp(data: bytes) -> tuple[np.ndarray, int]:
    data = bytes(data)
    m = open_msp(data)
    (w, h), stride = m["size"], (m["size"][0] + 7) // 8
    if not m["rle"]:
        return _bits(_rows(data, 32, stride, h), w)[..., None], 8
    rows = np.empty((h, stride), np.uint8)
    row = ctypes.c_int64(0)
    n = _raw._load().msp_rle_decode(data, len(data), h, stride, rows.size, _raw._ptr(rows),
                              ctypes.byref(row))
    if n < 0:
        raise OSError(_MSP_ERRORS[n].format(row.value))
    if n < rows.size:
        raise ValueError("not enough image data")
    return _bits(rows, w)[..., None], 8


# ---- SPIDER -------------------------------------------------------------------------


def _is_int(f: float) -> bool:
    return math.isfinite(f) and f == int(f)


def _spider_header(t: tuple) -> int:
    """``isSpiderHeader``: the header's length in bytes, or 0."""
    h = (99, *t)
    if not all(_is_int(h[i]) for i in (1, 2, 5, 12, 13, 22, 23)):
        return 0
    if int(h[5]) not in (1, 3, -11, -12, -21, -22):
        return 0
    labrec, labbyt, lenbyt = int(h[13]), int(h[22]), int(h[23])
    return labbyt if labbyt == labrec * lenbyt else 0


def open_spider(data: bytes) -> dict:
    """``SpiderImageFile._open``: 27 floats, big-endian first, then
    little-endian; a 2-D image (iform 1) alone or the first of a stack."""
    f = data[:108]
    if len(f) < 108:
        raise _Skip("not a valid Spider file")
    for order in (">", "<"):
        t = struct.unpack(order + "27f", f)
        hdrlen = _spider_header(t)
        if hdrlen:
            break
    else:
        raise _Skip("not a valid Spider file")
    h = (99, *t)
    if int(h[5]) != 1:
        raise _Skip("not a Spider 2D image")
    size = int(h[12]), int(h[2])
    istack, imgnumber = int(h[24]), int(h[27])
    if istack == 0 and imgnumber == 0:
        offset = hdrlen
    elif istack > 0 and imgnumber == 0:
        offset = hdrlen * 2
    elif istack == 0 and imgnumber > 0:
        raise AttributeError("'SpiderImageFile' object has no attribute 'stkoffset'")
    else:
        raise _Skip("inconsistent stack header values")
    _open(size, "F")
    return dict(size=size, offset=offset, dtype=order + "f4")


def decode_spider(data: bytes) -> tuple[np.ndarray, int]:
    data = bytes(data)
    s = open_spider(data)
    (w, h) = s["size"]
    return _gray(_samples(_rows(data, s["offset"], 4 * w, h), w, s["dtype"]), "F")


def to_float(arr: np.ndarray) -> np.ndarray:
    """``convert("F")`` of uint8 RGB or RGBA (``R * 0.299 + G * 0.587 + B *
    0.114`` in double, then float32; alpha unread) or uint16 gray
    (``I;16``, exact)."""
    if arr.dtype == np.uint16:
        return arr.astype(np.float32)
    a = arr.astype(np.float64)
    return (a[..., 0] * 0.299 + a[..., 1] * 0.587 + a[..., 2] * 0.114).astype(np.float32)


def encode_spider(arr: np.ndarray) -> bytes:
    """``SpiderImagePlugin._save`` of uint8 RGB or RGBA or uint16 gray:
    ``convert("F")``, ``makeSpiderHeader`` (labrec records of 4 * nsam
    bytes, the Fortran-indexed values shifted down by one) and the
    samples as little-endian float32 (``F;32NF``, native order on the
    port's hosts)."""
    f = to_float(arr)
    nrow, nsam = f.shape
    lenbyt = nsam * 4
    labrec = 1024 // lenbyt + (1024 % lenbyt != 0)
    labbyt = labrec * lenbyt
    hdr = np.zeros(labbyt // 4, "<f4")
    hdr[[0, 1, 2, 4, 11, 12, 21, 22]] = [1, nrow, nrow, 1, nsam, labrec, labbyt, lenbyt]
    return hdr.tobytes() + np.ascontiguousarray(f, "<f4").tobytes()


# ---- PIXAR, McIdas, XV thumbnail ----------------------------------------------------


def open_pixar(data: bytes) -> dict:
    """``PixarImageFile._open``: the size at 418 and 416, ``RGB`` for the
    channel and depth words (14, 2) only."""
    if not data.startswith(b"\x80\xe8\x00\x00"):
        raise _Skip("not a PIXAR file")
    s = data[:512]
    if len(s) < 428:
        raise _Skip("short PIXAR header")
    w, h, chan, depth = (struct.unpack_from("<H", s, o)[0] for o in (418, 416, 424, 426))
    mode = "RGB" if (chan, depth) == (14, 2) else ""
    _open((w, h), mode)
    return dict(size=(w, h))


def decode_pixar(data: bytes) -> tuple[np.ndarray, int]:
    data = bytes(data)
    w, h = open_pixar(data)["size"]
    return np.ascontiguousarray(_rows(data, 1024, 3 * w, h).reshape(h, w, 3)), 8


_MCIDAS_MODES = {1: ("L", "u1"), 2: ("I;16B", ">u2"), 4: ("I", ">i4")}


def open_mcidas(data: bytes) -> dict:
    """``McIdasImageFile._open``: the 64 big-endian words of the area
    directory; 1, 2 or 4 bytes a sample; the data's offset and stride."""
    s = data[:256]
    if not s.startswith(b"\x00\x00\x00\x00\x00\x00\x00\x04") or len(s) != 256:
        raise _Skip("not an McIdas area file")
    w = (0, *struct.unpack(">64i", s))
    if w[11] not in _MCIDAS_MODES:
        raise _Skip("unsupported McIdas format")
    _open((w[10], w[9]), _MCIDAS_MODES[w[11]][0])
    return dict(size=(w[10], w[9]), bytes=w[11], offset=w[34] + w[15],
                stride=w[15] + w[10] * w[11] * w[14])


def decode_mcidas(data: bytes) -> tuple[np.ndarray, int]:
    data = bytes(data)
    m = open_mcidas(data)
    (w, h), n = m["size"], m["bytes"]
    mode, dtype = _MCIDAS_MODES[n]
    return _gray(_samples(_rows(data, m["offset"], n * w, h, m["stride"]), w, dtype), mode)


def _xv_palette() -> np.ndarray:
    r, g, b = np.meshgrid(np.arange(8), np.arange(8), np.arange(4), indexing="ij")
    return np.stack([r * 255 // 7, g * 255 // 7, b * 255 // 3], -1).reshape(256, 3).astype(
        np.uint8)


def open_xvthumb(data: bytes) -> dict:
    """``XVThumbImageFile._open``: the magic line, ``#`` comment lines, the
    size line; the bytes after it."""
    if not data.startswith(b"P7 332"):
        raise _Skip("not an XV thumbnail file")
    fp = io.BytesIO(data)
    fp.seek(6)
    fp.readline()
    while True:
        s = fp.readline()
        if not s:
            raise _Skip("Unexpected EOF reading XV thumbnail file")
        if s[0] != 35:
            break
    w, h = s.strip().split(maxsplit=2)[:2]
    size = int(w), int(h)
    _open(size, "P")
    return dict(size=size, offset=fp.tell())


def decode_xvthumb(data: bytes) -> tuple[np.ndarray, int]:
    data = bytes(data)
    x = open_xvthumb(data)
    (w, h) = x["size"]
    return _xv_palette()[_rows(data, x["offset"], w, h)], 8


# ---- GBR and IMT --------------------------------------------------------------------


def open_gbr(data: bytes) -> dict:
    """``GbrImageFile._open``: the header (version 2 with ``GIMP`` and the
    spacing), the comment; ``L`` at depth 1, ``RGBA`` at 4."""
    if not (len(data) >= 8 and _be32(data, 0) >= 20 and _be32(data, 4) in (1, 2)):
        raise _Skip("not a GIMP brush")
    header, version = _be32(data, 0), _be32(data, 4)
    w, h, depth = _be32(data, 8), _be32(data, 12), _be32(data, 16)
    if w == 0 or h == 0:
        raise _Skip("not a GIMP brush")
    if depth not in (1, 4):
        raise _Skip(f"Unsupported GIMP brush color depth: {depth}")
    pos = 20
    if version == 1:
        comment = header - 20
    else:
        comment = header - 28
        if data[20:24] != b"GIMP":
            raise _Skip("not a GIMP brush, bad magic number")
        _be32(data, 24)
        pos = 28
    pos = len(data) if comment < 0 else min(pos + comment, len(data))   # read(-n): the rest
    _raw.bomb_check(w, h)
    return dict(size=(w, h), depth=depth, offset=pos)


def decode_gbr(data: bytes) -> tuple[np.ndarray, int]:
    data = bytes(data)
    g = open_gbr(data)
    (w, h), depth = g["size"], g["depth"]
    px = data[g["offset"]:g["offset"] + w * h * depth]
    if len(px) < w * h * depth:
        raise ValueError("not enough image data")
    return np.frombuffer(px, np.uint8).reshape(h, w, depth).copy(), 8


_IMT_FIELD = re.compile(rb"([a-z]*) ([^ \r\n]*)")


def open_imt(data: bytes) -> dict:
    """``ImtImageFile._open``: a byte at a time, each ``key value`` line (a
    100-byte buffer refilled as the plugin's is) up to a form feed, where
    the image starts; ``L`` for ``pixel n8``."""
    buffer, pos = data[:100], min(len(data), 100)
    if b"\n" not in buffer:
        raise _Skip("not an IM file")
    w = h = 0
    mode, size, offset = "", (0, 0), None
    while True:
        if buffer:
            s, buffer = buffer[:1], buffer[1:]
        else:
            s, pos = data[pos:pos + 1], pos + len(data[pos:pos + 1])
        if not s:
            break
        if s == b"\x0c":
            offset = pos - len(buffer)
            break
        if b"\n" not in buffer:
            more = data[pos:pos + 100]
            buffer, pos = buffer + more, pos + len(more)
        lines = buffer.split(b"\n")
        s += lines.pop(0)
        buffer = b"\n".join(lines)
        if len(s) == 1 or len(s) > 100:
            break
        if s[0] == ord(b"*"):
            continue
        m = _IMT_FIELD.match(s)
        if not m:
            break
        k, v = m.group(1, 2)
        if k == b"width":
            w = int(v)
            size = (w, h)
        elif k == b"height":
            h = int(v)
            size = (w, h)
        elif k == b"pixel" and v == b"n8":
            mode = "L"
    _open(size, mode)
    return dict(size=size, offset=offset)


def decode_imt(data: bytes) -> tuple[np.ndarray, int]:
    data = bytes(data)
    m = open_imt(data)
    if m["offset"] is None:
        raise OSError("cannot load this image")
    (w, h) = m["size"]
    return np.ascontiguousarray(_rows(data, m["offset"], w, h))[..., None], 8
