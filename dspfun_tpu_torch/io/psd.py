"""Photoshop (PSD) read of the port: the composite image, as Pillow 12.1's
``PsdImagePlugin`` opens it and its ``convert("RGBA")`` shows it, with no
Pillow.

* **Open** (``PsdImageFile._open``): the 26-byte header (signature,
  version 1, the (mode, bits) of Pillow's ``MODES``: bitmap, gray, indexed,
  RGB, CMYK, multichannel, duotone and Lab at 8 bits, bitmap at 1), the
  colour mode data (a 768-byte palette of an indexed file, planar R, G,
  B), the image resources walked as Pillow walks them (signature, id,
  Pascal name and data, each padded to even length), the layer section
  skipped by its length, and the composite's tiles (``_maketile``): raw
  (0) channel after channel, or PackBits (1) after a table of each row's
  byte count, read for the mode's channels only (so a file with more
  channels than its mode's starts its first channel inside the table, as
  in Pillow).  Where the open fails with what ``Image.open`` takes as "not
  this format" (a short read, a (mode, bits) outside ``MODES``: 16- and
  32-bit files, an empty size), :class:`rawimg.Skip` is raised and
  ``io/images.py`` tries the next format.
* **Decode**: each channel from its offset, ``raw`` or Pillow's PackBits
  decoder (``native/rawimg.cpp:packbits_decode``: one stream a channel,
  a packet cut at its row's end); a file that ends first is truncated, and
  any other compression (ZIP, 2 and 3) has no tile, which Pillow cannot
  load.  Channels past the mode's are ignored.  Then Pillow's converts:
  ``1`` (a set bit white), ``L``, ``P`` (black without a palette),
  ``RGB(A)``, ``CMYK`` read inverted (``C;I``) through ``cmyk2rgb``, and
  ``LAB`` (a and b as stored, 128 neutral) through the LittleCMS
  transform of ``io/imgcodecs.py``, its alpha the 0 its fourth byte holds.
"""

from __future__ import annotations

import io
import struct

import numpy as np

from dspfun_tpu_torch.io import imgcodecs as _codecs
from dspfun_tpu_torch.io import rawimg as _raw

__all__ = ["MODES", "decode_psd", "open_psd"]

# (photoshop mode, bits) -> (Pillow's mode, its channels): PsdImagePlugin.MODES
MODES = {(0, 1): ("1", 1), (0, 8): ("L", 1), (1, 8): ("L", 1), (2, 8): ("P", 1),
         (3, 8): ("RGB", 3), (4, 8): ("CMYK", 4), (7, 8): ("L", 1), (8, 8): ("L", 1),
         (9, 8): ("LAB", 3)}


def _open(data: bytes) -> dict:
    f = io.BytesIO(data)

    def u16() -> int:
        return struct.unpack(">H", f.read(2))[0]

    def u32() -> int:
        return struct.unpack(">I", f.read(4))[0]

    s = f.read(26)
    if not s.startswith(b"8BPS") or struct.unpack_from(">H", s, 4)[0] != 1:
        raise _raw.Skip("not a PSD file")
    nch, h, w, bits, pmode = struct.unpack_from(">HIIHH", s, 12)
    if (pmode, bits) not in MODES:
        raise _raw.Skip(f"no PSD mode {(pmode, bits)}")       # KeyError in Pillow's open
    mode, channels = MODES[(pmode, bits)]
    if channels > nch:
        raise ValueError("not enough channels")
    if mode == "RGB" and nch == 4:
        mode, channels = "RGBA", 4
    palette = None
    size = u32()
    if size:
        cdata = f.read(size)
        if mode == "P" and size == 768:
            palette = np.frombuffer(cdata, np.uint8, 768).reshape(3, 256).T
    size = u32()
    if size:
        end = f.tell() + size
        while f.tell() < end:
            f.read(4)
            u16()
            name = f.read(f.read(1)[0])
            if not len(name) & 1:
                f.read(1)
            if len(f.read(u32())) & 1:
                f.read(1)
    size = u32()
    if size:
        end = f.tell() + size
        u32()
        f.seek(end)
    comp = u16()
    offsets = []
    if comp == 0:
        offsets = [f.tell() + k * w * h for k in range(channels)]
    elif comp == 1:
        table = f.read(channels * h * 2)
        counts = struct.unpack_from(f">{channels * h}H", table)
        at = f.tell()
        for k in range(channels):
            offsets.append(at)
            at += sum(counts[k * h:(k + 1) * h])
    if w <= 0 or h <= 0:
        raise _raw.Skip("an empty size: not identified by the plugin")
    _raw.bomb_check(w, h)       # Image.open's, after the plugin's open
    return dict(size=(w, h), mode=mode, compression=comp, offsets=offsets, palette=palette)


def open_psd(data: bytes) -> dict:
    """``PsdImageFile._open``: the mode, size, palette and each channel's
    offset; :class:`rawimg.Skip` where Pillow's open passes the file on."""
    try:
        return _open(data)
    except (IndexError, struct.error) as e:
        raise _raw.Skip(f"short PSD file ({e})") from None


def _channel(data: bytes, at: int, comp: int, rowbytes: int, h: int) -> np.ndarray:
    if comp == 0:
        if at + rowbytes * h > len(data):
            raise ValueError("image file is truncated")
        return np.frombuffer(data, np.uint8, rowbytes * h, at).reshape(h, rowbytes)
    rows = np.empty((h, rowbytes), np.uint8)
    rc = _raw._load().packbits_decode(data, len(data), at, rowbytes, h, _raw._ptr(rows))
    if rc:
        raise ValueError("image file is truncated")
    return rows


def decode_psd(data: bytes) -> tuple[np.ndarray, int]:
    """The composite image Pillow loads and converts (see the module's
    docstring), uint8 [H, W, C], depth 8."""
    data = bytes(data)
    p = open_psd(data)
    (w, h), mode = p["size"], p["mode"]
    if not p["offsets"]:
        raise ValueError("cannot load this image")
    rowbytes = (w + 7) // 8 if mode == "1" else w
    planes = [_channel(data, at, p["compression"], rowbytes, h) for at in p["offsets"]]
    if mode == "1":
        return _raw._bits(planes[0], w), 8
    v = np.stack(planes, -1)
    if mode == "P":
        pal = p["palette"] if p["palette"] is not None else np.zeros((256, 3), np.uint8)
        return pal[v[..., 0]], 8
    if mode == "CMYK":
        return _codecs._cmyk_rgb(255 - v), 8
    if mode == "LAB":
        rgb = _codecs._lab_rgb(v ^ np.array([0, 128, 128], np.uint8))
        return np.concatenate([rgb, np.zeros_like(rgb[..., :1])], -1), 8
    return np.ascontiguousarray(v), 8
