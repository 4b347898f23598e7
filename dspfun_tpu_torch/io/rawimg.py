"""The port's codecs for Pillow's small raw and run-length formats: TGA,
PCX, SGI, QOI and IM, read and written without Pillow.

The JAX package reads and writes these through Pillow 12.1
(``dspfun_tpu/io/images.py``).  Each ``open_*`` here is the header rule
of Pillow's plugin (``TgaImagePlugin``, ``PcxImagePlugin``,
``SgiImagePlugin``, ``QoiImagePlugin``, ``ImImagePlugin``): it raises
:class:`Skip` where the plugin's ``_open`` raises what ``Image.open``
takes as "not this format" (``SyntaxError``, ``IndexError``,
``TypeError``, ``struct.error``), so that ``io/images.py`` tries the
next format as Pillow does, and ``ValueError`` or ``OSError`` where
Pillow's open fails outright.  Each ``decode_*`` gives what the plugin
decodes, as ``(samples [H, W, C], depth)`` in the convention of
``io/imgcodecs.py`` (palettes expanded to RGB or RGBA, as Pillow's
``convert("RGBA")`` expands them), and raises where Pillow's load
raises.  Each ``encode_*`` writes Pillow's bytes for the arrays
``io/images.py`` hands it (uint8 RGB or RGBA, uint16 gray) and raises a
``ValueError`` for a mode Pillow refuses.

* **TGA**: image types 1, 2, 3, 9, 10 and 11 at the depths of Pillow's
  ``MODES`` (1-bit, 8-bit gray or indices, gray + alpha, ``BGRA;15Z``
  with its inverted alpha bit, BGR, BGRA), colour maps of 16 or 24 bits
  from any first index (32-bit maps raise, as in Pillow), the ID
  section, run-length packets (``native/rawimg.cpp``), both vertical
  orientations and the horizontal flip.  Written: uncompressed,
  bottom-up, with the ``TRUEVISION-XFILE.`` footer; RGB or RGBA.
* **PCX**: 1-bit, 2- and 4-plane palettes, 8-bit gray or palette (a
  linear gray palette after the ``0x0c`` byte reads as gray) and 3-plane
  RGB, Pillow's stride rule (the stored stride trusted only where it is
  the computed one, else padded to even) and its decoder's band shift.
  Written: RGB, run-length coded per plane line, stride even.
* **SGI**: raw and RLE files at 1 or 2 bytes per sample, gray, RGB and
  RGBA; 2-byte samples read to their high bytes (Pillow's 8-bit modes).
  Written: uncompressed, 1 byte a sample, the output's base name in the
  header; RGB or RGBA.
* **QOI**: Pillow's own decoder and encoder (``native/rawimg.cpp``);
  colorspace byte 1 on write; RGB or RGBA.
* **IM**: the header lines up to the ``0x1a`` byte as Pillow parses
  them, the ``OPEN`` modes 1, L, P (2-, 4- and 8-bit, with the ``Lut:``
  palette), LA, PA, RGB (line-interleaved, packed or in three planes),
  RGBA, RGBX, CMYK, 16- and 32-bit gray, YCbCr (``YCC``, Pillow's integer
  YCbCr -> RGB tables) and the floating-point modes (every ``F;*``
  rawmode: 8-, 16- and 32-bit integers, signed or not, float32, and the
  bit decoder's 2- to 31-bit samples), which Pillow's ``F -> L`` convert
  truncates into 0..255.  Written: RGB, RGBA and 16-bit gray (``L 16``),
  with the ``Name:`` line of the output's base name.
* **DCX**: the first page of the directory, a PCX read at its offset.
"""

from __future__ import annotations

import ctypes
import functools
import os
import re
import struct

import numpy as np

from dspfun_tpu_torch import _hostbuild
from dspfun_tpu_torch.io import gif as _gif
from dspfun_tpu_torch.io import png as _png

__all__ = ["Skip", "bomb_check", "decode_dcx", "decode_im", "decode_pcx", "decode_qoi",
           "decode_sgi", "decode_tga", "encode_im", "encode_pcx", "encode_qoi", "encode_sgi", "encode_tga",
           "open_dcx", "open_im", "open_pcx", "open_qoi", "open_sgi", "open_tga"]

_ERRORS = {-1: "buffer overrun when reading image file",
           -20: "image file is truncated"}


class Skip(ValueError):  # noqa: N818 — Pillow's "not this format"
    """A plugin's ``_open`` failed the way ``Image.open`` takes as "try
    the next format"."""


def _i16(d: bytes, o: int, order: str = "<") -> int:
    if len(d) < o + 2:
        raise Skip("short header")
    return struct.unpack_from(order + "H", d, o)[0]


def _byte(d: bytes, o: int) -> int:
    if len(d) <= o:
        raise Skip("short header")
    return d[o]


def bomb_check(w: int, h: int) -> None:
    """Pillow's decompression-bomb error (twice ``MAX_IMAGE_PIXELS``)."""
    if w * h > _gif._MAX_PIXELS:
        raise ValueError(f"image size ({w * h} pixels) exceeds the limit of "
                         f"{_gif._MAX_PIXELS} pixels, could be decompression bomb DOS attack")


def _check(rc: int) -> None:
    if rc:
        raise OSError(_ERRORS.get(rc, f"decoder error {rc}"))


def _raw(data: bytes, pos: int, rowbytes: int, h: int) -> np.ndarray:
    """h rows of the raw decoder from ``pos``; a short file is truncated."""
    if pos + rowbytes * h > len(data):
        raise OSError("image file is truncated")
    return np.frombuffer(data, np.uint8, rowbytes * h, pos).reshape(h, rowbytes)


def _bits(rows: np.ndarray, w: int) -> np.ndarray:
    """Pillow's ``1`` rawmode: MSB first, a set bit white."""
    return (np.unpackbits(rows, axis=1)[:, :w] * 255).astype(np.uint8)[..., None]


def _bgra15z(rows: np.ndarray, w: int) -> np.ndarray:
    """Pillow's ``BGRA;15Z`` unpacker: 5 bits a colour scaled by 255 // 31,
    alpha 0 where bit 15 is set (``~((pixel >> 15) * 255)``)."""
    v = rows[:, :2 * w].reshape(rows.shape[0], w, 2).astype(np.uint16)
    v = v[..., 0] | v[..., 1] << 8
    out = np.empty(v.shape + (4,), np.uint8)
    for i, shift in enumerate((10, 5, 0)):
        out[..., i] = ((v >> shift) & 31) * 255 // 31
    out[..., 3] = np.where(v >> 15, 0, 255)
    return out


def _palette(entries: np.ndarray, n: int = 256) -> np.ndarray:
    """A palette of ``entries`` [k, 3|4] padded with opaque black to ``n``
    entries (what Pillow's ``putpalette`` leaves past the given ones)."""
    c = entries.shape[1]
    if len(entries) > n:
        raise ValueError("invalid palette size")
    full = np.zeros((n, c), np.uint8)
    if c == 4:
        full[:, 3] = 255
    full[:len(entries)] = entries
    return full


@functools.lru_cache(maxsize=None)
def _load() -> ctypes.CDLL:
    """The loaded library of ``native/rawimg.cpp`` with its signatures
    declared (built on first use; raises when it cannot be built)."""
    lib = _hostbuild.load_library("rawimg")
    c = ctypes
    u8p, i64 = c.POINTER(c.c_uint8), c.c_int64
    lib.qoi_decode.restype = c.c_int
    lib.qoi_decode.argtypes = [c.c_char_p, i64, i64, i64, c.c_int, u8p]
    lib.qoi_encode.restype = i64
    lib.qoi_encode.argtypes = [u8p, i64, c.c_int, u8p]
    lib.tga_rle_decode.restype = c.c_int
    lib.tga_rle_decode.argtypes = [c.c_char_p, i64, i64, i64, c.c_int, c.c_int, u8p]
    lib.sgi_rle_decode.restype = c.c_int
    lib.sgi_rle_decode.argtypes = [c.c_char_p, i64, c.c_int, c.c_int, c.c_int, c.c_int, u8p]
    lib.pcx_decode.restype = c.c_int
    lib.pcx_decode.argtypes = [c.c_char_p, i64, i64, i64, i64, c.c_int, u8p]
    lib.packbits_decode.restype = c.c_int
    lib.packbits_decode.argtypes = [c.c_char_p, i64, i64, i64, i64, u8p]
    lib.sun_rle_decode.restype = c.c_int
    lib.sun_rle_decode.argtypes = [c.c_char_p, i64, i64, i64, i64, u8p]
    lib.msp_rle_decode.restype = i64
    lib.msp_rle_decode.argtypes = [c.c_char_p, i64, i64, i64, i64, u8p, c.POINTER(i64)]
    lib.xbm_decode.restype = c.c_int
    lib.xbm_decode.argtypes = [c.c_char_p, i64, i64, i64, i64, u8p]
    lib.pcx_encode.restype = i64
    lib.pcx_encode.argtypes = [u8p, c.c_int, i64, c.c_int, u8p]
    lib.resample_8bpc.restype = None
    lib.resample_8bpc.argtypes = [u8p, c.c_int, c.c_int, c.c_int, c.c_int, c.c_int, c.c_int, u8p]
    lib.resample_16bpc.restype = None
    lib.resample_16bpc.argtypes = [c.POINTER(c.c_uint16), c.c_int, c.c_int, c.c_int, c.c_int,
                                   c.c_int, c.POINTER(c.c_uint16)]
    lib.fli_decode.restype = i64
    lib.fli_decode.argtypes = [c.c_char_p, i64, c.c_int, c.c_int, u8p, c.POINTER(c.c_int)]
    lib.blp_dxt_decode.restype = None
    lib.blp_dxt_decode.argtypes = [c.c_char_p, i64, i64, c.c_int, c.c_int, u8p]
    return lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _mode_of(arr: np.ndarray) -> str:
    if arr.dtype == np.uint16:
        return "I;16"
    return {3: "RGB", 4: "RGBA"}.get(arr.shape[2] if arr.ndim == 3 else 0, str(arr.shape))


# ---------------------------------------------------------------------------
# TGA
# ---------------------------------------------------------------------------

# (image type & 7, depth) -> Pillow's rawmode, and the rawmodes' bits
_TGA_RAW = {(1, 8): "P", (3, 1): "1", (3, 8): "L", (3, 16): "LA", (2, 16): "BGRA;15Z",
            (2, 24): "BGR", (2, 32): "BGRA"}
_RAW_BITS = {"1": 1, "P": 8, "L": 8, "LA": 16, "BGRA;15Z": 16, "BGR": 24, "BGRA": 32}


def open_tga(data: bytes) -> dict:
    """``TgaImageFile._open``: the header, the ID section and the colour
    map, and where the pixels start."""
    s = data[:18]
    if len(s) < 18:
        raise Skip("short TGA header")
    id_len, cmap, itype, depth, flags = s[0], s[1], s[2], s[16], s[17]
    w, h = _i16(s, 12), _i16(s, 14)
    if cmap not in (0, 1) or w <= 0 or h <= 0 or depth not in (1, 8, 16, 24, 32):
        raise Skip("not a TGA file")
    if itype in (3, 11):
        mode = {1: "1", 16: "LA"}.get(depth, "L")
    elif itype in (1, 9):
        mode = "P" if cmap else "L"
    elif itype in (2, 10):
        mode = "RGB" if depth == 24 else "RGBA"
    else:
        raise Skip("unknown TGA mode")
    orient = flags & 0x30
    pos = min(18 + id_len, len(data))
    palette = None
    if cmap:
        start, size, mapdepth = _i16(s, 3), _i16(s, 5), s[7]
        if mapdepth not in (16, 24, 32):
            raise Skip("unknown TGA map depth")
        k = mapdepth // 8
        raw = data[pos:pos + k * size]
        pos += len(raw)
        palette = (mapdepth, bytes(k * start) + raw)
    return dict(size=(w, h), mode=mode, rawmode=_TGA_RAW.get((itype & 7, depth)),
                rle=bool(itype & 8), depth=depth, top_down=orient in (0x20, 0x30),
                flip=orient in (0x10, 0x30), palette=palette, offset=pos)


def _tga_palette(palette: tuple) -> np.ndarray:
    mapdepth, raw = palette
    if mapdepth == 32:
        raise ValueError("unrecognized raw mode")  # Pillow has no BGRA palette unpacker
    k = mapdepth // 8
    n = len(raw) // k
    rows = np.frombuffer(raw, np.uint8, n * k).reshape(1, n * k)
    entries = _bgra15z(rows, n)[0] if k == 2 else rows.reshape(n, 3)[:, ::-1]
    return _palette(entries)


def decode_tga(data: bytes) -> tuple[np.ndarray, int]:
    data = bytes(data)
    t = open_tga(data)
    (w, h), raw = t["size"], t["rawmode"]
    bomb_check(w, h)
    if raw is None:
        raise OSError("cannot load this image")
    if t["mode"] == "L" and raw == "P":
        raise ValueError("unknown raw mode for given image mode")
    rowbytes = (w * _RAW_BITS[raw] + 7) // 8
    if t["rle"]:
        rows = np.empty((h, rowbytes), np.uint8)
        _check(_load().tga_rle_decode(data, len(data), t["offset"], rowbytes, h,
                                      t["depth"] // 8, _ptr(rows)))
    else:
        rows = _raw(data, t["offset"], rowbytes, h)
    if not t["top_down"]:
        rows = rows[::-1]
    if raw == "1":
        out = _bits(rows, w)
    elif raw == "BGRA;15Z":
        out = _bgra15z(rows, w)
    else:
        nch = _RAW_BITS[raw] // 8
        out = rows[:, :w * nch].reshape(h, w, nch)
        if nch >= 3:
            out = out[..., [2, 1, 0, 3][:nch]]
    if t["palette"] is not None:
        pal = _tga_palette(t["palette"])
        if t["mode"] == "P":
            out = pal[out[..., 0]]
        elif t["mode"] != "L":
            raise ValueError("illegal image mode")  # a colour map on an RGB(A) image
    if t["flip"]:
        out = out[:, ::-1]
    return np.ascontiguousarray(out), 8


def encode_tga(arr: np.ndarray) -> bytes:
    """Pillow's TGA of uint8 RGB or RGBA: uncompressed, bottom-up, the
    version 2 footer."""
    if _mode_of(arr) not in ("RGB", "RGBA"):
        raise ValueError(f"cannot write mode {_mode_of(arr)} as TGA")
    h, w, c = arr.shape
    head = struct.pack("<BBBHHBHHHHBB", 0, 0, 2, 0, 0, 0, 0, 0, w, h, 8 * c, 8 if c == 4 else 0)
    body = arr[::-1][..., [2, 1, 0, 3][:c]].tobytes()
    return head + body + b"\0" * 8 + b"TRUEVISION-XFILE.\0"


# ---------------------------------------------------------------------------
# PCX
# ---------------------------------------------------------------------------

_GRAY_RAMP = bytes(np.repeat(np.arange(256, dtype=np.uint8), 3))


def open_pcx(data: bytes, at: int = 0) -> dict:
    """``PcxImageFile._open`` of the header at ``at``: mode, size, palette
    and the decoder's stride; ``OSError`` for a mode Pillow does not know.
    The palette of an 8-bit file is the last 769 bytes of all of ``data``
    (a DCX page's too)."""
    s = data[at:at + 68]
    if not (len(s) >= 2 and s[0] == 10 and s[1] in (0, 2, 3, 5)):
        raise Skip("not a PCX file")
    x0, y0, x1, y1 = _i16(s, 4), _i16(s, 6), _i16(s, 8) + 1, _i16(s, 10) + 1
    if x1 <= x0 or y1 <= y0:
        raise Skip("bad PCX image size")
    version, bits, planes, stored = s[1], _byte(s, 3), _byte(s, 65), _i16(s, 66)
    palette = None
    if bits == 1 and planes == 1:
        mode = raw = "1"
    elif bits == 1 and planes in (2, 4):
        mode, raw = "P", f"P;{planes}L"
        palette = s[16:64]
    elif version == 5 and bits == 8 and planes == 1:
        mode = raw = "L"
        tail = data[-769:]  # BytesIO.seek(-769, SEEK_END) stops at 0 in a shorter file
        if len(tail) == 769 and tail[0] == 12 and tail[1:] != _GRAY_RAMP:
            mode = raw = "P"
            palette = tail[1:]
    elif version == 5 and bits == 8 and planes == 3:
        mode, raw = "RGB", "RGB;L"
    else:
        raise OSError("unknown PCX mode")
    w, h = x1 - x0, y1 - y0
    stride = (w * bits + 7) // 8
    if stored != stride:
        stride += stride % 2
    return dict(size=(w, h), mode=mode, rawmode=raw, palette=palette, bytes=planes * stride,
                offset=at + 128)


_PCX_BITS = {"1": 1, "P;2L": 2, "P;4L": 4, "L": 8, "P": 8, "RGB;L": 24}


def decode_pcx(data: bytes, at: int = 0) -> tuple[np.ndarray, int]:
    data = bytes(data)
    p = open_pcx(data, at)
    (w, h), raw, nbytes = p["size"], p["rawmode"], p["bytes"]
    bomb_check(w, h)
    if (w * _PCX_BITS[raw] + 7) // 8 > nbytes:
        raise OSError(_ERRORS[-1])
    rows = np.empty((h, nbytes), np.uint8)
    _check(_load().pcx_decode(data, len(data), p["offset"], nbytes, w, h, _ptr(rows)))
    if raw == "1":
        return _bits(rows, w), 8
    if raw == "RGB;L":
        return np.ascontiguousarray(np.stack([rows[:, k * w:(k + 1) * w] for k in range(3)],
                                             axis=-1)), 8
    if raw in ("P;2L", "P;4L"):
        s, n = (w + 7) // 8, int(raw[2])
        bits = np.unpackbits(rows, axis=1)
        idx = sum(bits[:, 8 * k * s:8 * k * s + w].astype(np.uint8) << k for k in range(n))
    else:
        idx = rows[:, :w]
    if p["palette"] is None:
        return np.ascontiguousarray(idx[..., None]), 8
    pal = np.frombuffer(p["palette"], np.uint8, len(p["palette"]) // 3 * 3).reshape(-1, 3)
    return _palette(pal)[idx], 8


def encode_pcx(arr: np.ndarray) -> bytes:
    """Pillow's PCX of uint8 RGB (version 5, 3 planes of 8 bits)."""
    mode = _mode_of(arr)
    if mode != "RGB":
        raise ValueError(f"Cannot save {mode} images as PCX")
    h, w, _ = arr.shape
    stride = w + w % 2
    head = (struct.pack("<BBBBHHHHHH", 10, 5, 1, 8, 0, 0, w - 1, h - 1, 100, 100)
            + b"\0" * 24 + b"\xff" * 24 + b"\0"
            + struct.pack("<BHHHH", 3, stride, 1, w, h) + b"\0" * 54)
    lines = np.ascontiguousarray(arr.transpose(0, 2, 1))
    out = np.empty(h * 3 * (2 * w + 1) + 16, np.uint8)
    n = _load().pcx_encode(_ptr(lines), h, w, 3, _ptr(out))
    return head + out[:n].tobytes()


# ---------------------------------------------------------------------------
# DCX
# ---------------------------------------------------------------------------

def open_dcx(data: bytes) -> dict:
    """``DcxImageFile._open``: the directory of at most 1024 offsets (up to
    the first 0), then ``seek(0)``, the first page's PCX header."""
    if not data.startswith(b"\xb1\x68\xde\x3a"):
        raise Skip("not a DCX file")
    offsets = []
    for i in range(1024):
        o = data[4 + 4 * i:8 + 4 * i]
        if len(o) < 4:
            raise Skip("short DCX directory")      # i32 of a short read: struct.error
        o = struct.unpack("<I", o)[0]
        if not o:
            break
        offsets.append(o)
    if not offsets:
        raise Skip("attempt to seek outside sequence")   # EOFError in Pillow's open
    return open_pcx(data, offsets[0])


def decode_dcx(data: bytes) -> tuple[np.ndarray, int]:
    data = bytes(data)
    return decode_pcx(data, open_dcx(data)["offset"] - 128)


# ---------------------------------------------------------------------------
# SGI
# ---------------------------------------------------------------------------

_SGI_MODES = {(1, 1, 1): "L", (1, 2, 1): "L", (2, 1, 1): "L;16B", (2, 2, 1): "L;16B",
              (1, 3, 3): "RGB", (2, 3, 3): "RGB;16B", (1, 3, 4): "RGBA", (2, 3, 4): "RGBA;16B"}


def open_sgi(data: bytes) -> dict:
    """``SgiImageFile._open`` (after its accept test: the magic 474)."""
    s = data[:512]
    if s[:2] != b"\x01\xda":
        raise Skip("not an SGI file")
    comp, bpc = _byte(s, 2), _byte(s, 3)
    dim, w, h, z = (_i16(s, o, ">") for o in (4, 6, 8, 10))
    raw = _SGI_MODES.get((bpc, dim, z))
    if raw is None:
        raise ValueError("Unsupported SGI image mode")
    if w <= 0 or h <= 0:
        raise Skip("an empty size: not identified by the plugin")
    return dict(size=(w, h), mode=raw.split(";")[0], comp=comp, bpc=bpc)


def decode_sgi(data: bytes) -> tuple[np.ndarray, int]:
    data = bytes(data)
    s = open_sgi(data)
    (w, h), bpc, z = s["size"], s["bpc"], len(s["mode"])
    bomb_check(w, h)
    if s["comp"] == 1:
        out = np.zeros((h, w * z * bpc), np.uint8)
        _check(_load().sgi_rle_decode(data, len(data), w, h, z, bpc, _ptr(out)))
        out = out.reshape(h, w, z, bpc)[..., 0]
    elif s["comp"] == 0:
        page = w * h * bpc
        if bpc == 2 and 512 + z * page > len(data):
            raise ValueError("not enough image data")
        planes = [_raw(data, 512 + k * page, w * bpc, h)[::-1, ::bpc] for k in range(z)]
        out = np.stack(planes, axis=-1)
    else:
        raise OSError("cannot load this image")
    return np.ascontiguousarray(out), 8


def encode_sgi(arr: np.ndarray, path: str = "") -> bytes:
    """Pillow's SGI of uint8 RGB or RGBA: verbatim, 1 byte a sample, the
    base name of ``path`` (the file written; "" for a stream) as its
    image name."""
    if _mode_of(arr) not in ("RGB", "RGBA"):
        raise ValueError("Unsupported SGI image mode")
    h, w, z = arr.shape
    name = os.path.splitext(os.path.basename(path))[0].encode("ascii", "ignore")
    head = (struct.pack(">hBBHHHHll4s79ssl404s", 474, 0, 1, 3, w, h, z, 0, 255, b"", name, b"",
                        0, b""))
    return head + np.ascontiguousarray(arr[::-1].transpose(2, 0, 1)).tobytes()


# ---------------------------------------------------------------------------
# QOI
# ---------------------------------------------------------------------------

def open_qoi(data: bytes) -> dict:
    """``QoiImageFile._open`` (after its accept test: ``qoif``)."""
    if not data.startswith(b"qoif"):
        raise Skip("not a QOI file")
    if len(data) < 12:
        raise Skip("short QOI header")
    w, h = struct.unpack_from(">II", data, 4)
    channels = _byte(data, 12)
    if w <= 0 or h <= 0:
        raise Skip("an empty size: not identified by the plugin")
    return dict(size=(w, h), mode="RGB" if channels == 3 else "RGBA")


def decode_qoi(data: bytes) -> tuple[np.ndarray, int]:
    data = bytes(data)
    q = open_qoi(data)
    (w, h), c = q["size"], len(q["mode"])
    bomb_check(w, h)
    out = np.empty((h, w, c), np.uint8)
    _check(_load().qoi_decode(data, len(data), 14, w * h, c, _ptr(out)))
    return out, 8


def encode_qoi(arr: np.ndarray) -> bytes:
    """Pillow's QOI of uint8 RGB or RGBA (colorspace byte 1)."""
    if _mode_of(arr) not in ("RGB", "RGBA"):
        raise ValueError("Unsupported QOI image mode")
    arr = np.ascontiguousarray(arr)
    h, w, c = arr.shape
    out = np.empty(w * h * 5 + 8, np.uint8)
    n = _load().qoi_encode(_ptr(arr), w * h, c, _ptr(out))
    return b"qoif" + struct.pack(">IIBB", w, h, c, 1) + out[:n].tobytes()


# ---------------------------------------------------------------------------
# IM
# ---------------------------------------------------------------------------

_IM_SIZE, _IM_MODE, _IM_LUT = "Image size (x*y)", "Image type", "Lut"
_IM_NUMERIC = ("File size (no of images)", "Scale (x,y)", _IM_SIZE)
_IM_TAGS = {"Comment", "Date", "Digitalization equipment", "File size (no of images)", _IM_LUT,
            "Name", "Scale (x,y)", _IM_SIZE, _IM_MODE}
_IM_OPEN = {
    "0 1 image": ("1", "1"), "L 1 image": ("1", "1"), "Greyscale image": ("L", "L"),
    "Grayscale image": ("L", "L"), "RGB image": ("RGB", "RGB;L"), "RLB image": ("RGB", "RLB"),
    "RYB image": ("RGB", "RLB"), "B1 image": ("1", "1"), "B2 image": ("P", "P;2"),
    "B4 image": ("P", "P;4"), "X 24 image": ("RGB", "RGB"), "L 32 S image": ("I", "I;32"),
    "L 32 F image": ("F", "F;32"), "RGB3 image": ("RGB", "RGB;T"),
    "RYB3 image": ("RGB", "RYB;T"), "LA image": ("LA", "LA;L"), "PA image": ("LA", "PA;L"),
    "RGBA image": ("RGBA", "RGBA;L"), "RGBX image": ("RGB", "RGBX;L"),
    "CMYK image": ("CMYK", "CMYK;L"), "YCC image": ("YCbCr", "YCbCr;L"),
}
for _i in ("8", "8S", "16", "16S", "32", "32F"):
    _IM_OPEN[f"L {_i} image"] = _IM_OPEN[f"L*{_i} image"] = ("F", f"F;{_i}")
for _i in ("16", "16L", "16B"):
    _IM_OPEN[f"L {_i} image"] = _IM_OPEN[f"L*{_i} image"] = (f"I;{_i}", f"I;{_i}")
_IM_OPEN["L 32S image"] = _IM_OPEN["L*32S image"] = ("I", "I;32S")
for _j in range(2, 33):
    _IM_OPEN[f"L*{_j} image"] = ("F", f"F;{_j}")
_IM_LINE = re.compile(rb"^([A-Za-z][^:]*):[ \t]*(.*)[ \t]*$")
# (mode, rawmode) -> (bytes a pixel, planes in a row) of the rows the port reads
_IM_ROWS = {("1", "1"): None, ("L", "L"): (1, 1), ("P", "P"): (1, 1), ("P", "P;2"): None,
            ("P", "P;4"): None, ("LA", "LA;L"): (1, 2), ("PA", "PA;L"): (1, 2),
            ("RGB", "RGB;L"): (1, 3), ("RGB", "RGB"): (1, 3), ("RGB", "RGBX;L"): (1, 4),
            ("RGBA", "RGBA;L"): (1, 4), ("CMYK", "CMYK;L"): (1, 4), ("YCbCr", "YCbCr;L"): (1, 3), ("I;16", "I;16"): (2, 1),
            ("I;16L", "I;16L"): (2, 1), ("I;16B", "I;16B"): (2, 1), ("I", "I;32"): (4, 1),
            ("I", "I;32S"): (4, 1), ("RGB", "RGB;T"): None, ("RGB", "RYB;T"): None}


# the F rawmodes of the raw decoder (Unpack.c: F;32 is unsigned), as numpy types
_IM_FLOAT = {"F;8": "u1", "F;8S": "i1", "F;16": "<u2", "F;16S": "<i2", "F;32": "<u4",
             "F;32F": "<f4"}


def _bit_rows(data: bytes, pos: int, bits: int, w: int, h: int) -> np.ndarray:
    """``BitDecode.c`` with IM's arguments (bits, pad 8, fill 3, unsigned,
    bottom-up): samples read LSB first from each row's own bytes, the
    bits left over at a row's end (the top of its last byte) ORed into the
    next row's first byte, as the decoder's bit buffer keeps them."""
    rb = (w * bits + 7) // 8
    rows = _raw(data, pos, rb, h).astype(np.uint8)
    left = 8 * rb - w * bits
    if left:
        rows = rows.copy()
        for y in range(1, h):
            rows[y, 0] |= rows[y - 1, rb - 1] >> (8 - left)
    lsb = np.unpackbits(rows, axis=1, bitorder="little")[:, :w * bits].reshape(h, w, bits)
    weights = (np.uint64(1) << np.arange(bits, dtype=np.uint64))
    return (lsb.astype(np.uint64) * weights).sum(-1).astype(np.float32)


def _im_float(data: bytes, pos: int, raw: str, w: int, h: int) -> np.ndarray:
    """The float32 samples [H, W] of IM's ``F`` mode, top row first."""
    if raw in _IM_FLOAT:
        dt = np.dtype(_IM_FLOAT[raw])
        rows = _raw(data, pos, w * dt.itemsize, h)
        return rows.copy().view(dt).astype(np.float32)[::-1]
    return _bit_rows(data, pos, int(raw[2:]), w, h)[::-1]


def _ycbcr_table(k: float) -> np.ndarray:
    """A row of ConvertYCbCr.c's YCbCr -> RGB tables: k * 64 * (i - 128)
    rounded half up toward zero (C's ``(int)(x + 0.5)``)."""
    return np.trunc(k * 64 * (np.arange(256) - 128) + 0.5).astype(np.int32)


_YCC_R_CR, _YCC_G_CB, _YCC_G_CR, _YCC_B_CB = (_ycbcr_table(k) for k in
                                              (1.40200, -0.34414, -0.71414, 1.77200))


def _ycbcr_rgb(v: np.ndarray) -> np.ndarray:
    """Pillow's ``ImagingConvertYCbCr2RGB`` of uint8 [..., 3] (Y, Cb, Cr):
    Y plus the tables' sums shifted right by 6, clipped to 0..255."""
    y = v[..., 0].astype(np.int32)
    cb, cr = v[..., 1], v[..., 2]
    out = np.stack([y + (_YCC_R_CR[cr] >> 6), y + ((_YCC_G_CB[cb] + _YCC_G_CR[cr]) >> 6),
                    y + (_YCC_B_CB[cb] >> 6)], -1)
    return np.clip(out, 0, 255).astype(np.uint8)


def _im_number(s: str):
    try:
        return int(s)
    except ValueError:
        return float(s)


def open_im(data: bytes) -> dict:
    """``ImImageFile._open``: the header lines up to the ``0x1a`` byte
    (at most 100 bytes a line, each ``key: value``; the keys of Pillow's
    ``TAGS`` counted), the ``Lut:`` palette, and where the pixels start."""
    if b"\n" not in data[:100]:
        raise Skip("not an IM file")
    info = {_IM_MODE: "L", _IM_SIZE: (512, 512)}
    rawmode, pos, n, s = "L", 0, 0, b""
    while True:
        s = data[pos:pos + 1]
        pos += len(s)
        if s == b"\r":
            continue
        if not s or s in (b"\0", b"\x1a"):
            break
        end = data.find(b"\n", pos)
        end = len(data) if end < 0 else end + 1
        s, pos = s + data[pos:end], end
        if len(s) > 100:
            raise Skip("not an IM file")
        s = s[:-2] if s.endswith(b"\r\n") else s[:-1] if s.endswith(b"\n") else s
        m = _IM_LINE.match(s)
        if not m:
            raise Skip("Syntax error in IM header")
        k, v = (g.decode("latin-1", "replace") for g in m.group(1, 2))
        if k in _IM_NUMERIC:
            v = tuple(_im_number(x) for x in v.replace("*", ",").split(","))
            v = v[0] if len(v) == 1 else v
        elif k == _IM_MODE and v in _IM_OPEN:
            v, rawmode = _IM_OPEN[v]
        info[k] = v
        n += k in _IM_TAGS
    if not n:
        raise Skip("Not an IM file")
    size, mode = info[_IM_SIZE], info[_IM_MODE]
    if not isinstance(size, tuple) or not mode:
        raise Skip("no size or mode")  # Pillow's size[0] of a number: TypeError
    if len(size) > 1 and (size[0] <= 0 or size[1] <= 0):
        raise Skip("an empty size: not identified by the plugin")
    while s and not s.startswith(b"\x1a"):
        s = data[pos:pos + 1]
        pos += len(s)
    if not s:
        raise Skip("File truncated")
    palette = None
    if _IM_LUT in info:
        lut = data[pos:pos + 768]
        pos += len(lut)
        if len(lut) < 768:
            raise Skip("short Lut")
        p = np.frombuffer(lut, np.uint8).reshape(3, 256)
        gray = bool((p[0] == p[1]).all() and (p[1] == p[2]).all())
        if mode in ("L", "LA", "P", "PA") and not gray:
            if mode in ("L", "P"):
                mode = rawmode = "P"
            else:
                mode, rawmode = "PA", "PA;L"
            palette = np.ascontiguousarray(p.T)
    return dict(size=size, mode=mode, rawmode=rawmode, palette=palette, offset=pos)


def decode_im(data: bytes) -> tuple[np.ndarray, int]:
    data = bytes(data)
    m = open_im(data)
    (w, h), mode, raw, pos = m["size"], m["mode"], m["rawmode"], m["offset"]
    if not (isinstance(w, int) and isinstance(h, int)):
        raise ValueError(f"bad IM image size {m['size']}")
    bomb_check(w, h)
    if mode == "F":
        from dspfun_tpu_torch.io import imgcodecs as _codecs  # noqa: PLC0415

        return _codecs._f2l(_im_float(data, pos, raw, w, h))[..., None], 8
    if (mode, raw) not in _IM_ROWS:
        raise ValueError(f"unknown raw mode {raw!r} for IM mode {mode!r}")
    if raw in ("RGB;T", "RYB;T"):
        planes = [_raw(data, pos + k * w * h, w, h)[::-1] for k in range(3)]
        return np.ascontiguousarray(np.stack([planes[1], planes[0], planes[2]], -1)), 8
    if raw in ("1", "P;2", "P;4"):
        bits = {"1": 1, "P;2": 2, "P;4": 4}[raw]
        rows = _raw(data, pos, (w * bits + 7) // 8, h)[::-1]
        if raw == "1":
            return np.ascontiguousarray(_bits(rows, w)), 8
        idx = np.unpackbits(rows, axis=1)[:, :w * bits].reshape(h, w, bits)
        idx = (idx * (1 << np.arange(bits - 1, -1, -1, dtype=np.uint8))).sum(-1).astype(np.uint8)
        return _palette(np.zeros((0, 3), np.uint8))[idx], 8
    size, planes = _IM_ROWS[(mode, raw)]
    rows = _raw(data, pos, w * size * planes, h)[::-1]
    if raw == "RGB":
        return np.ascontiguousarray(rows.reshape(h, w, 3)), 8
    if size > 1:
        dt = {"I;16B": ">u2", "I;32": "<i4", "I;32S": "<i4"}.get(raw, "<u2")
        out = rows.copy().view(dt).astype(np.int32 if size == 4 else np.uint16)[..., None]
        return out, 16
    out = rows.reshape(h, planes, w).transpose(0, 2, 1)
    if mode == "CMYK":
        from dspfun_tpu_torch.io import imgcodecs as _codecs  # noqa: PLC0415

        out = _codecs._cmyk_rgb(out)
    elif mode == "YCbCr":
        out = _ycbcr_rgb(out)
    elif raw == "RGBX;L":
        out = out[..., :3]
    if mode in ("P", "PA"):
        pal = _palette(m["palette"]) if m["palette"] is not None else _palette(
            np.zeros((0, 3), np.uint8))
        out = np.concatenate([pal[out[..., 0]], out[..., 1:]], axis=-1)
    return np.ascontiguousarray(out), 8


def encode_im(arr: np.ndarray, path: str = "") -> bytes:
    """Pillow's IM of uint8 RGB or RGBA or uint16 gray (``L 16``): the
    512-byte header with a ``Name:`` line of the base name of ``path``
    (the file written; none for a stream), then bottom-up rows."""
    mode = _mode_of(arr)
    kind = {"RGB": "RGB", "RGBA": "RGBA", "I;16": "L 16"}.get(mode)
    if kind is None:
        raise ValueError(f"Cannot save {mode} images as IM")
    lines = [f"Image type: {kind} image\r\n".encode("ascii")]
    if path:
        name, ext = os.path.splitext(os.path.basename(path))
        lines.append(f"Name: {name[:92 - len(ext)] + ext}\r\n".encode("ascii"))
    h, w = arr.shape[:2]
    lines.append(f"Image size (x*y): {w}*{h}\r\n".encode("ascii"))
    lines.append(b"File size (no of images): 1\r\n")
    head = b"".join(lines)
    head += b"\0" * (511 - len(head)) + b"\x1a"
    if mode == "I;16":
        body = np.ascontiguousarray(arr[::-1], "<u2").tobytes()
    else:
        body = np.ascontiguousarray(arr[::-1].transpose(0, 2, 1)).tobytes()
    return head + body
