"""BLP read of the port (Blizzard's mipmapped textures): no Pillow.

The JAX package reads BLP through Pillow 12.1's ``BlpImagePlugin``;
:func:`decode_blp` gives its pixels.  Its writes fail there for every
image the JAX package hands over (``Unsupported BLP image mode``: Pillow
saves only ``P``), and ``io/images.py`` raises the same.

* **Open** (``BlpImageFile._open``): the magic, the compression, the
  alpha flag (``RGBA`` where it is not 0, else ``RGB``), BLP2's encoding
  and alpha encoding, the size, BLP1's encoding; a header cut short
  passes the file on (:class:`rawimg.Skip`).
* **Read** (``BLP1Decoder``, ``BLP2Decoder``): the 16 mipmap offsets and
  lengths after the header, of which the first mipmap is read:

  - BLP1 JPEG (compression 0): the shared JPEG header joined to the
    mipmap's bytes, decoded by ``io/jpeg.py`` (four components read as
    CMYK, an Adobe marker's YCCK too, as the plugin's ``CMYK`` JPEG mode
    has libjpeg read them; then ``convert("RGB")``) and taken as ``BGR``,
    so red and blue swap;
  - palette (BLP1 compression 1 with encoding 4 or 5, read right after
    the palette whatever the offset says; BLP2 compression 1 encoding 1,
    at the offset): the 256 BGRA entries, one index a byte over the
    mipmap's length, each entry's alpha kept where the alpha flag is set
    (any alpha depth: the plugin reads no depth);
  - BLP2 DXT (encoding 2; alpha encoding 0 DXT1, 1 DXT3, 7 DXT5):
    ``BlpImagePlugin``'s own block decoders, not ``BcnDecode.c``
    (``native/rawimg.cpp:blp_dxt_decode``), each block row's four pixel
    rows of whole blocks laid one after another;
  - every decoded stream is taken as the raw bytes of the image's mode,
    row after row of the header's width: a width that is not a multiple
    of 4 shears the DXT rows, and a 4-byte DXT3 or DXT5 stream of an
    ``RGB`` image is read 3 bytes a pixel, as Pillow reads them.

  BLP2's raw BGRA encoding (3), other encodings and compressions fail as
  the plugin's ``BLPFormatError`` does.
"""

from __future__ import annotations

import struct

import numpy as np

from dspfun_tpu_torch.io import jpeg as _jpeg
from dspfun_tpu_torch.io import rawimg as _raw

__all__ = ["decode_blp", "open_blp"]

_DXT = {0: (1, 8), 1: (3, 16), 7: (5, 16)}     # alpha encoding -> (kind, block bytes)


def open_blp(data: bytes) -> dict:
    """``BlpImageFile._open``: the header's fields, the mode and where
    the mipmap tables start."""
    magic = data[:4]
    if magic not in (b"BLP1", b"BLP2"):
        raise _raw.Skip("not a BLP file")
    if len(data) < (24 if magic == b"BLP1" else 20):
        raise _raw.Skip("short BLP header")
    compression = struct.unpack_from("<i", data, 4)[0]
    if magic == b"BLP1":
        alpha = struct.unpack_from("<I", data, 8)[0] != 0
        encoding, alpha_encoding = None, None
    else:
        encoding, alpha, alpha_encoding = struct.unpack_from("<bbb", data, 8)
        alpha = alpha != 0
    w, h = struct.unpack_from("<II", data, 12)
    if magic == b"BLP1":
        encoding = struct.unpack_from("<i", data, 20)[0]
    mode = "RGBA" if alpha else "RGB"
    if w <= 0 or h <= 0:
        raise _raw.Skip("an empty size: not identified by the plugin")
    _raw.bomb_check(w, h)
    return dict(magic=magic, compression=compression, encoding=encoding, alpha=alpha,
                alpha_encoding=alpha_encoding, size=(w, h), mode=mode,
                offset=28 if magic == b"BLP1" else 20)


def _read(data: bytes, pos: int, n: int) -> bytes:
    """``ImageFile._safe_read``: n bytes, or the truncation error."""
    if n <= 0:
        return b""
    got = data[pos:pos + n]
    if len(got) < n:
        raise OSError("Truncated File Read")
    return got


def _palette(data: bytes, pos: int) -> np.ndarray:
    """The 256 BGRA entries at pos, as RGBA."""
    return np.frombuffer(_read(data, pos, 1024), np.uint8).reshape(256, 4)[:, [2, 1, 0, 3]]


def _jpeg_mipmap(data: bytes, pos: int, offset: int, length: int) -> np.ndarray:
    """``_decode_jpeg_stream``: the JPEG's ``convert("RGB")`` samples."""
    size = struct.unpack("<I", _read(data, pos, 4))[0]
    head = _read(data, pos + 4, size)
    pos += 4 + size
    pos += len(_read(data, pos, offset - pos))
    stream = head + _read(data, pos, length)
    if not stream.startswith(b"\xff\xd8\xff"):
        raise SyntaxError("not a JPEG file")
    frame = _jpeg.frame_header(stream)
    why = frame and _jpeg.unidentified(frame)
    if why:
        raise SyntaxError(why)
    frame, coefs = _jpeg.decode_coefficients(stream, window=_jpeg.PILLOW_CHUNK)
    _raw.bomb_check(frame.width, frame.height)
    rgb = _jpeg.reconstruct(frame, coefs, frame.latch, ycck_as_cmyk=True)
    return np.repeat(rgb, 3 // rgb.shape[2], axis=2)


def _dxt(data: bytes, pos: int, w: int, h: int, alpha_encoding: int, alpha: bool) -> np.ndarray:
    """The DXT decoders' stream of the first mipmap at pos."""
    if alpha_encoding not in _DXT:
        raise NotImplementedError(f"Unsupported alpha encoding {alpha_encoding!r}")
    kind, size = _DXT[alpha_encoding]
    blocks, rows = (w + 3) // 4, (h + 3) // 4
    src = _read(data, pos, blocks * size * rows)
    c = 3 if kind == 1 and not alpha else 4
    out = np.empty(rows * 4 * blocks * 4 * c, np.uint8)
    _raw._load().blp_dxt_decode(src, blocks, rows, kind, int(alpha), _raw._ptr(out))
    return out


def decode_blp(data: bytes) -> tuple[np.ndarray, int]:
    """The first mipmap as Pillow loads it: uint8 [H, W, 3|4], depth 8."""
    data = bytes(data)
    b = open_blp(data)
    (w, h), nch = b["size"], len(b["mode"])
    pos = b["offset"]
    offsets = struct.unpack("<16I", _read(data, pos, 64))
    lengths = struct.unpack("<16I", _read(data, pos + 64, 64))
    pos += 128
    comp, enc = b["compression"], b["encoding"]
    if b["magic"] == b"BLP1":
        if comp == 0:
            stream = _jpeg_mipmap(data, pos, offsets[0], lengths[0])[..., ::-1].tobytes()
            nch = 3     # taken as BGR, alpha 255
        elif comp == 1 and enc in (4, 5):
            pal = _palette(data, pos)
            idx = np.frombuffer(_read(data, pos + 1024, lengths[0]), np.uint8)
            stream = pal[idx][:, :len(b["mode"])].tobytes()
        elif comp == 1:
            raise NotImplementedError(f"Unsupported BLP encoding {enc!r}")
        else:
            raise NotImplementedError(f"Unsupported BLP compression {enc!r}")
    else:
        pal = _palette(data, pos)
        if comp != 1:
            raise NotImplementedError(f"Unknown BLP compression {comp!r}")
        if enc == 1:
            idx = np.frombuffer(_read(data, offsets[0], lengths[0]), np.uint8)
            stream = pal[idx][:, :nch].tobytes()
        elif enc == 2:
            stream = _dxt(data, offsets[0], w, h, b["alpha_encoding"], b["alpha"]).tobytes()
        else:
            raise NotImplementedError(f"Unknown BLP encoding {enc!r}")
    if len(stream) < w * h * nch:
        raise ValueError("not enough image data")
    arr = np.frombuffer(stream, np.uint8, w * h * nch).reshape(h, w, nch)
    return np.ascontiguousarray(arr), 8
