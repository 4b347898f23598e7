"""GIF of the port: no Pillow, no cv2.

The JAX package reads and writes GIF through Pillow.  This module gives
the same results:

* :func:`decode_gif` returns the first frame as Pillow 12's
  ``GifImageFile`` loads it and ``convert("RGBA")`` converts it: blocks
  read and skipped as ``_open``/``_seek`` read them (GIF87a and GIF89a;
  comment, application, plain-text and unknown extensions; stray bytes
  between blocks), the Graphic Control Extension's transparency index,
  a local colour table in place of the global one, mode ``L`` where the
  table is absent or the identity gray ramp (``_is_palette_needed``; a
  gray local table leaves the global one's colours, as Pillow's
  ``self.palette`` does), indices past a shorter table black, a frame
  smaller than the screen or at an offset (a frame reaching past it
  widens the screen) on a screen filled with the transparency index,
  else index 0, and the interlaced row order.  A file Pillow cannot open raises ``OSError``
  (its ``UnidentifiedImageError``), LZW data that ends early or holds a
  code the table does not raises ``OSError``, and a frame of zero width
  or height ``ValueError``, as Pillow raises them.
* :func:`encode_gif` returns the bytes of ``Image.fromarray(a).save(...,
  "GIF")`` for the arrays the JAX package's ``write_image`` hands it:
  RGB (median cut) and RGBA (fast octree, the first fully transparent
  palette entry as the transparency index, which brings a Graphic
  Control Extension and GIF89a) through ``io/quant.py``, and 16-bit gray,
  which Pillow converts to ``L`` by clipping at 255.  Then
  ``_normalize_palette``: the palette is cut to the entries used when
  some are not (below 512x512 pixels, or always for ``L``), or when the
  used ones fill at most half of a palette of more than two entries;
  the global colour table is padded to a power of two of at least four
  entries; rows interlaced unless a side is below 16 pixels; 8-bit LZW
  codes.

The LZW coding is ``native/gif.cpp``, built at first use
(``_hostbuild.py``; a failed build raises with the compiler's message).
tests/test_torch_gif.py holds both directions to Pillow.
"""

from __future__ import annotations

import ctypes
import functools
import math
import struct

import numpy as np

from dspfun_tpu_torch import _hostbuild
from dspfun_tpu_torch.io import quant as _quant

__all__ = ["decode_gif", "encode_gif", "interlace_rows"]

# Pillow's decompression-bomb limit: twice Image.MAX_IMAGE_PIXELS
_MAX_PIXELS = 2 * int(1024 * 1024 * 1024 // 4 // 3)
_ERRORS = {-1: "buffer overrun when reading image file",
           -2: "broken data stream when reading image file",
           -8: "codec configuration error when reading image file",
           -21: "out of memory"}


class _Reader:
    """The file as Pillow's ``fp`` reads it: short reads at the end."""

    def __init__(self, data: bytes):
        self.data, self.pos = data, 0

    def read(self, n: int) -> bytes:
        out = self.data[self.pos:self.pos + n]
        self.pos += len(out)
        return out

    def block(self) -> bytes | None:
        """``GifImageFile.data``: the next sub-block, None at a
        terminator (or the end of the file)."""
        s = self.read(1)
        if s and s[0]:
            return self.read(s[0])
        return None


def _palette_needed(p: bytes) -> bool:
    # GifImagePlugin._is_palette_needed, an IndexError where Pillow's has one
    for i in range(0, len(p), 3):
        if not (i // 3 == p[i] == p[i + 1] == p[i + 2]):
            return True
    return False


def _i16(b: bytes, o: int = 0) -> int:
    return struct.unpack_from("<H", b, o)[0]


def _first_frame(data: bytes) -> dict:
    """The screen, palettes and first frame's descriptor, as
    ``GifImageFile._open`` and ``_seek(0)`` read them."""
    f = _Reader(data)
    s = f.read(13)
    if not s.startswith((b"GIF87a", b"GIF89a")):
        raise SyntaxError("not a GIF file")
    size = [_i16(s, 6), _i16(s, 8)]
    flags = s[10]
    palette = None  # the global palette, where it is not the gray ramp
    if flags & 128:
        p = f.read(3 << ((flags & 7) + 1))
        if _palette_needed(p):
            palette = p
    s = f.read(1)
    if not s or s == b";":
        raise EOFError("no more images in GIF file")
    local = None  # None: no local table; False: the gray ramp
    transparency = interlace = None
    while True:
        if not s:
            s = f.read(1)
        if not s or s == b";":
            break
        if s == b"!":
            s = f.read(1)
            block = f.block()
            if s[0] == 249 and block is not None:
                if block[0] & 1:
                    transparency = block[3]
                _i16(block, 1)  # the duration: Pillow reads it, and fails where it is short
            elif s[0] == 254:
                while block:
                    block = f.block()
                s = b""
                continue
            elif s[0] == 255 and block is not None and block.startswith(b"NETSCAPE2.0"):
                block = f.block()
                if block and len(block) >= 3 and block[0] == 1:
                    _i16(block, 1)
            while f.block():
                pass
        elif s == b",":
            s = f.read(9)
            x0, y0 = _i16(s, 0), _i16(s, 2)
            x1, y1 = x0 + _i16(s, 4), y0 + _i16(s, 6)
            size = [max(x1, size[0]), max(y1, size[1])]
            fl = s[8]
            interlace = (fl & 64) != 0
            if fl & 128:
                p = f.read(3 << ((fl & 7) + 1))
                local = p if _palette_needed(p) else False
            bits = f.read(1)[0]
            break
        s = b""
    if interlace is None:
        raise EOFError("image not found in GIF frame")
    if size[0] * size[1] > _MAX_PIXELS:
        raise ValueError(f"image size ({size[0] * size[1]} pixels) exceeds the limit of "
                         f"{_MAX_PIXELS} pixels, could be decompression bomb DOS attack")
    # the frame is mode L where it has neither table (or the gray ramp for
    # either); its colours come from the local table, else the global one
    return dict(size=size, palette=local or palette,
                mode_l=not (local if local is not None else palette),
                transparency=transparency, interlace=interlace, extent=(x0, y0, x1, y1),
                bits=bits, offset=f.pos)


def decode_gif(data: bytes) -> tuple[np.ndarray, int]:
    """(samples [H, W, 3] or, with a transparency index, [H, W, 4] uint8,
    8) of the first frame of a GIF file, as Pillow reads it and converts
    it to RGB(A)."""
    try:
        fr = _first_frame(bytes(data))
    except (SyntaxError, IndexError, TypeError, KeyError, EOFError, struct.error) as e:
        raise OSError(f"cannot identify image file ({e})") from None
    w, h = fr["size"]
    t = fr["transparency"]
    if fr["mode_l"] and fr["palette"] is not None and t is not None:
        # an L frame that Pillow gives the global palette: its convert fails
        raise ValueError("conversion from P to RGBA not supported in convert_transparent")
    screen = np.full((h, w), t or 0, np.uint8)
    x0, y0, x1, y1 = fr["extent"]
    if x0 == 0 and x1 == 0:  # Pillow's setimage takes an empty extent for the whole image
        x0, y0, x1, y1 = 0, 0, w, h
    if x1 - x0 <= 0 or y1 - y0 <= 0:
        raise ValueError("tile cannot extend outside image")
    body = data[fr["offset"]:]
    rc = _load().gif_decode(body, len(body), fr["bits"], int(fr["interlace"]),
                            screen.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), w, x0, y0,
                            x1 - x0, y1 - y0)
    if rc == -20:
        raise OSError("image file is truncated")
    if rc:
        raise OSError(_ERRORS.get(rc, f"decoder error {rc}"))
    nch = 3 if t is None else 4
    lut = np.zeros((256, nch), np.uint8)
    if fr["palette"] is None:  # mode L, the gray ramp
        lut[:, :3] = np.arange(256, dtype=np.uint8)[:, None]
    else:
        p = np.frombuffer(fr["palette"], np.uint8)
        n = min(len(p) // 3, 256)
        lut[:n, :3] = p[:3 * n].reshape(n, 3)
    if t is not None:
        lut[:, 3] = 255
        lut[t, 3] = 0
    return lut[screen], 8


def interlace_rows(h: int) -> np.ndarray:
    """The rows of an interlaced image in the order GIF stores them."""
    return np.concatenate([np.arange(0, h, 8), np.arange(4, h, 8), np.arange(2, h, 4),
                           np.arange(1, h, 2)])


def _used(idx: np.ndarray) -> list[int]:
    return np.flatnonzero(np.bincount(idx.ravel(), minlength=256)).tolist()


def encode_gif(arr: np.ndarray) -> bytes:
    """The GIF bytes Pillow writes for ``Image.fromarray(arr)``: ``arr``
    [H, W, 3] or [H, W, 4] uint8 (quantised to 256 colours), [H, W]
    uint8 (``L``) or [H, W] uint16 (``I;16``, clipped to ``L``)."""
    a = np.asarray(arr)
    if a.ndim == 2 and a.dtype in (np.uint8, np.uint16):
        mode = "L"
        idx = np.minimum(a, 255).astype(np.uint8)
        source, bands, transparency = np.repeat(np.arange(256, dtype=np.uint8), 3), 3, None
    elif a.ndim == 3 and a.dtype == np.uint8 and a.shape[2] in (3, 4):
        mode = "P"
        idx, pal, _ = _quant.quantize(a)
        source, bands = pal.ravel(), pal.shape[1]
        alpha0 = np.flatnonzero(pal[:, 3] == 0) if bands == 4 else []
        transparency = int(alpha0[0]) if len(alpha0) else None
    else:
        raise ValueError(f"GIF encodes uint8 RGB, RGBA or gray, or uint16 gray, not "
                         f"{a.dtype} {a.shape}")
    h, w = idx.shape
    if not (0 < h <= 0xFFFF and 0 < w <= 0xFFFF):
        raise ValueError(f"GIF image of {w}x{h}: sides must be 1..65535")
    # _normalize_palette with _get_optimize
    used = None
    if mode == "L" or w * h < 512 * 512:
        used = _used(idx)
        if mode == "P" and max(used) < len(used):
            entries = len(source) // bands
            current = 1 << (entries - 1).bit_length()
            if not (len(used) <= current // 2 and current > 2):
                used = None
    if used is not None:
        positions = np.zeros(256, np.uint8)
        positions[used] = np.arange(len(used), dtype=np.uint8)
        idx = positions[idx]
        source = source.reshape(-1, bands)[used].ravel()
        if transparency is not None:
            transparency = used.index(transparency) if transparency in used else None
    rgb = source.reshape(-1, bands)[:, :3].tobytes()
    # _get_global_header, _write_local_header
    table = 1 if len(rgb) < 9 else math.ceil(math.log(len(rgb) // 3, 2)) - 1
    rgb += b"\0" * (3 * max((2 << table) - len(rgb) // 3, 0))
    out = [b"GIF" + (b"89a" if transparency is not None else b"87a")
           + struct.pack("<HHBBB", w, h, table + 128, 0, 0), rgb]
    if transparency is not None:
        out.append(b"!\xf9\x04\x01\x00\x00" + bytes([transparency]) + b"\x00")
    interlaced = min(w, h) >= 16
    out.append(b"," + struct.pack("<HHHHB", 0, 0, w, h, 64 if interlaced else 0) + b"\x08")
    px = np.ascontiguousarray(idx[interlace_rows(h)] if interlaced else idx)
    buf = ctypes.POINTER(ctypes.c_uint8)()
    n = ctypes.c_int64(0)
    lib = _load()
    rc = lib.gif_encode(px.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), px.size,
                        max(65536, 4 * w), ctypes.byref(buf), ctypes.byref(n))
    if rc:
        raise MemoryError("GIF encode: out of memory")
    try:
        out.append(ctypes.string_at(buf, n.value))
    finally:
        lib.gif_free(buf)
    out.append(b"\0;")
    return b"".join(out)


@functools.lru_cache(maxsize=None)
def _load() -> ctypes.CDLL:
    """The loaded libgif with its signatures declared (built on first
    use; raises when it cannot be built)."""
    lib = _hostbuild.load_library("gif")
    c = ctypes
    u8p = c.POINTER(c.c_uint8)
    lib.gif_decode.restype = c.c_int
    lib.gif_decode.argtypes = [c.c_char_p, c.c_int64, c.c_int, c.c_int, u8p, c.c_int, c.c_int,
                               c.c_int, c.c_int, c.c_int]
    lib.gif_encode.restype = c.c_int
    lib.gif_encode.argtypes = [u8p, c.c_int64, c.c_int64, c.POINTER(u8p), c.POINTER(c.c_int64)]
    lib.gif_free.restype = None
    lib.gif_free.argtypes = [u8p]
    return lib
