"""ICNS read and write of the port: no Pillow.

The JAX package reads and writes macOS icon files through Pillow 12.1's
``IcnsImagePlugin``; :func:`decode_icns` and :func:`encode_icns` give its
pixels and bytes.

* **Open** (``IcnsFile``): the 8-byte block headers up to the file's
  length, a block of length 0 or a header cut short passing the file on
  (:class:`rawimg.Skip`), the sizes of ``IcnsFile.SIZES`` that have a
  block, and the largest of them, or none (the file passed on too).
* **Read** (``IcnsImageFile.load``): the best size's blocks in
  ``SIZES``' order, a PNG or JPEG 2000 payload winning over the rest:
  a PNG (read to the end of the file, as Pillow's PNG plugin reads it
  inside an icon: ``io/ico.py``'s PNG frame) or JPEG 2000 codestream
  (``io/jpeg2000.py`` on the block's bytes) whose size must be one of
  the file's sizes over a whole scale; else the RLE colour of ``is32``,
  ``il32``, ``ih32`` or ``it32`` (behind its 4 zero bytes: each band's
  runs and literals read on across the blocks, the band's count met
  exactly) or raw RGB of the block's exact length, with the ``s8mk``,
  ``l8mk``, ``h8mk`` or ``t8mk`` mask as alpha.  The image opens as
  ``RGBA``, so the JAX package reads it at depth 8 and converts what
  loads to RGBA: a 16-bit gray payload's samples clipped to 255.
* **Write** (``_save`` without ``append_images``): each of the sizes
  32, 64, 128, 256, 512 and 1024 as ``Image.resize((s, s))``, whose
  default filter is BICUBIC (``io/ico.py:resize``, RGBA premultiplied),
  saved through ``io/png.py``; the eight types ``ic07`` to ``ic14`` each
  hold the PNG of their size, behind a table of contents.
"""

from __future__ import annotations

import struct

import numpy as np

from dspfun_tpu_torch.io import ico as _ico
from dspfun_tpu_torch.io import jpeg2000 as _jpeg2000
from dspfun_tpu_torch.io import png as _png
from dspfun_tpu_torch.io import rawimg as _raw

__all__ = ["ICNS_TYPES", "decode_icns", "encode_icns", "open_icns"]

# IcnsFile.SIZES in its order: (width, height, scale) -> the block types
# read for it, each with its reader
_SIZES = (
    ((512, 512, 2), ((b"ic10", "png"),)),
    ((512, 512, 1), ((b"ic09", "png"),)),
    ((256, 256, 2), ((b"ic14", "png"),)),
    ((256, 256, 1), ((b"ic08", "png"),)),
    ((128, 128, 2), ((b"ic13", "png"),)),
    ((128, 128, 1), ((b"ic07", "png"), (b"it32", "32t"), (b"t8mk", "mk"))),
    ((64, 64, 1), ((b"icp6", "png"),)),
    ((32, 32, 2), ((b"ic12", "png"),)),
    ((48, 48, 1), ((b"ih32", "32"), (b"h8mk", "mk"))),
    ((32, 32, 1), ((b"icp5", "png"), (b"il32", "32"), (b"l8mk", "mk"))),
    ((16, 16, 2), ((b"ic11", "png"),)),
    ((16, 16, 1), ((b"icp4", "png"), (b"is32", "32"), (b"s8mk", "mk"))),
)
# _save's types and sizes, in its order
ICNS_TYPES = ((b"ic07", 128), (b"ic08", 256), (b"ic09", 512), (b"ic10", 1024), (b"ic11", 32),
              (b"ic12", 64), (b"ic13", 256), (b"ic14", 512))
_J2K_SIGS = (b"\xff\x4f\xff\x51", b"\x0d\x0a\x87\x0a")


def open_icns(data: bytes) -> dict:
    """``IcnsFile`` and ``IcnsImageFile._open``: the blocks by type
    (start, length), the sizes found and the best of them."""
    if not data.startswith(b"icns"):
        raise _raw.Skip("not an icns file")
    if len(data) < 8:
        raise _raw.Skip("short icns header")
    filesize = struct.unpack_from(">I", data, 4)[0]
    blocks, i = {}, 8
    while i < filesize:
        if i + 8 > len(data):
            raise _raw.Skip("short icns block header")
        sig, size = struct.unpack_from(">4sI", data, i)
        if size <= 0:
            raise _raw.Skip("invalid block header")
        i += 8
        blocks[sig] = (i, size - 8)
        i += size - 8
    sizes = [size for size, kinds in _SIZES if any(t in blocks for t, _ in kinds)]
    if not sizes:
        raise _raw.Skip("No 32bit icon resources found")
    return dict(blocks=blocks, sizes=sizes, best=max(sizes))


def _rle(data: bytes, pos: int, count: int) -> tuple[bytes, int]:
    """``read_32``'s band: runs (a byte of 0x80 and up repeats the next
    byte ``b - 125`` times) and literals (``b + 1`` bytes) until ``count``
    bytes are out; the stream's position after them."""
    out, left = [], count
    while left > 0:
        if pos >= len(data):
            break
        b = data[pos]
        pos += 1
        if b & 0x80:
            n = b - 125
            out.append(data[pos:pos + 1] * n)
            pos += 1
        else:
            n = b + 1
            out.append(data[pos:pos + n])
            pos += n
        left -= n
    if left != 0:
        raise ValueError(f"Error reading channel [{left!r} left]")
    return b"".join(out), pos


def _plane(raw: bytes, w: int, h: int, c: int) -> np.ndarray:
    if len(raw) < w * h * c:
        raise ValueError("not enough image data")
    return np.frombuffer(raw, np.uint8, w * h * c).reshape(h, w, c)


def _payload(data: bytes, start: int, length: int) -> np.ndarray:
    """``read_png_or_jpeg2000``: the payload's samples, uint8 [H, W, C]
    (C 1-4, as Pillow's mode has them before ``convert("RGBA")``)."""
    sig = data[start:start + 12]
    if sig.startswith(b"\x89PNG\r\n\x1a\n"):
        arr, depth = _ico._png_frame(data[start:])
    elif sig.startswith(_J2K_SIGS) or sig == b"\x00\x00\x00\x0cjP  \x0d\x0a\x87\x0a":
        arr, depth = _jpeg2000.decode_j2k(data[start:] if length < 0 else
                                          data[start:start + length])
        _raw.bomb_check(arr.shape[1], arr.shape[0])
    else:
        raise ValueError("Unsupported icon subimage format")
    if depth == 16:     # I;16 converted to RGBA: each sample clipped to 255
        arr = np.minimum(arr, 255).astype(np.uint8)
    return arr


def _check_size(sizes: list, w: int, h: int) -> None:
    """``IcnsImageFile.size``'s setter: one of the sizes over a whole
    scale."""
    for sw, sh, scale in sizes:
        if (sh * scale) / h == (sw * scale) // w:
            return
    raise ValueError("This is not one of the allowed sizes of this image")


def decode_icns(data: bytes) -> tuple[np.ndarray, int]:
    """The best size's image as ``IcnsImageFile.load`` makes it: uint8
    [H, W, C] samples, depth 8."""
    data = bytes(data)
    f = open_icns(data)
    (w, h, scale), blocks = f["best"], f["blocks"]
    pw, ph = w * scale, h * scale
    got = {}
    for sig, kind in dict(_SIZES)[f["best"]]:
        if sig not in blocks:
            continue
        start, length = blocks[sig]
        if kind == "png":
            got["RGBA"] = _payload(data, start, length)
            continue
        if kind == "mk":
            got["A"] = _plane(data[start:start + pw * ph], pw, ph, 1)
            continue
        if kind == "32t":
            if data[start:start + 4] != bytes(4):
                raise ValueError("Unknown signature, expecting 0x00000000")
            start, length = start + 4, length - 4
        if length == pw * ph * 3:
            got["RGB"] = _plane(data[start:start + length], pw, ph, 3)
            continue
        bands, pos = [], start
        for _ in range(3):
            band, pos = _rle(data, pos, pw * ph)
            bands.append(_plane(band, pw, ph, 1))
        got["RGB"] = np.concatenate(bands, -1)
    if "RGBA" in got:
        arr = got["RGBA"]
    else:
        arr = got["RGB"] if "A" not in got else np.concatenate([got["RGB"], got["A"]], -1)
    _check_size(f["sizes"], arr.shape[1], arr.shape[0])
    return np.ascontiguousarray(arr), 8


def encode_icns(arr: np.ndarray) -> bytes:
    """Pillow's ICNS of uint8 RGB or RGBA or uint16 gray: a PNG of each
    size, resized with BICUBIC."""
    if not (arr.dtype == np.uint16 and arr.ndim == 2
            or arr.dtype == np.uint8 and arr.ndim == 3 and arr.shape[2] in (3, 4)):
        raise ValueError(f"cannot write {arr.dtype} {arr.shape} as ICNS")
    h, w = arr.shape[:2]
    streams = {s: _png.encode_png(arr if (w, h) == (s, s) else
                                  _ico.resize(arr, s, s, _ico.BICUBIC))
               for s in sorted({s for _, s in ICNS_TYPES})}
    entries = [(t, streams[s]) for t, s in ICNS_TYPES]
    total = 8 + 8 + 8 * len(entries) + sum(8 + len(s) for _, s in entries)
    out = [b"icns", struct.pack(">i", total), b"TOC ", struct.pack(">i", 8 + 8 * len(entries))]
    out += [t + struct.pack(">i", 8 + len(s)) for t, s in entries]
    for t, s in entries:
        out += [t, struct.pack(">i", 8 + len(s)), s]
    return b"".join(out)
