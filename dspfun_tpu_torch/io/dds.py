"""DirectDraw Surface (DDS) read and write of the port, as Pillow 12.1's
``DdsImagePlugin`` reads and writes it, with no Pillow.

* **Open** (``DdsImageFile._open``): the 124-byte header after ``DDS ``
  (another size, or a short header, raises), its pixel format in
  Pillow's order: uncompressed RGB with any bit masks (``DDPF_RGB``, with
  alpha under ``DDPF_ALPHAPIXELS``), luminance (8-bit L, 16-bit LA), the
  8-bit palette (1024 bytes of RGBA after the header), and the four-CCs
  DXT1, DXT3, DXT5, BC4U/ATI1, BC5U/ATI2, BC5S and DX10 with its DXGI
  formats: BC1 to BC5 (BC5 signed too), BC6H (UF16 and SF16), BC7 (its
  sRGB form too) and R8G8B8A8; other formats raise.  A short read in the
  open (the DX10 header's) passes the file on (:class:`rawimg.Skip`).
  Only the top surface is read: mipmaps, array layers and cube faces after
  it are ignored.
* **Decode**: masks as Pillow's ``DdsRgbDecoder`` scales them (each
  channel ``int(v / total * 255)`` of its bits shifted down, a short file
  read as zeros); L, LA, P and R8G8B8A8 as Pillow's ``raw`` decoder reads
  them (a short file is truncated); the block formats through
  ``native/bcn.cpp`` (``bcn_decode``, ``bc6h_decode``; built at first use
  by ``_hostbuild.py``), edge blocks cropped, a file short of a block
  truncated.  BC6H's half floats become 8-bit samples here, in numpy, as
  Pillow's generic C build makes them: 0 below 0, 255 above 1, else the
  float32 product by 255 truncated.
* **Write** (``_save`` without ``pixel_format``): uncompressed RGB (BGR
  bytes, masks 0xff0000, 0xff00, 0xff) or RGBA (BGRA bytes, alpha mask
  0xff000000), the pitch of a row, flags CAPS, HEIGHT, WIDTH, PITCH and
  PIXELFORMAT; other modes raise as Pillow's do.
"""

from __future__ import annotations

import ctypes
import functools
import struct

import numpy as np

from dspfun_tpu_torch import _hostbuild
from dspfun_tpu_torch.io import rawimg as _raw

__all__ = ["decode_dds", "encode_dds", "half_to_u8", "open_dds"]

_MAGIC = b"DDS "
# DDSD, DDPF and DDSCAPS flags (DdsImagePlugin's IntFlags)
_CAPS, _HEIGHT, _WIDTH, _PITCH, _PIXELFORMAT = 0x1, 0x2, 0x4, 0x8, 0x1000
_ALPHAPIXELS, _FOURCC, _PALETTE8, _RGB, _LUMINANCE = 0x1, 0x4, 0x20, 0x40, 0x20000
_TEXTURE = 0x1000
# four-CC -> (Pillow's mode, bcn decoder number, signed)
_FOURCCS = {b"DXT1": ("RGBA", 1, 0), b"DXT3": ("RGBA", 2, 0), b"DXT5": ("RGBA", 3, 0),
            b"BC4U": ("L", 4, 0), b"ATI1": ("L", 4, 0), b"BC5S": ("RGB", 5, 1),
            b"BC5U": ("RGB", 5, 0), b"ATI2": ("RGB", 5, 0)}
# DXGI format -> the same, None for R8G8B8A8 (the raw decoder)
_DXGI = {70: ("RGBA", 1, 0), 71: ("RGBA", 1, 0), 73: ("RGBA", 2, 0), 74: ("RGBA", 2, 0),
         76: ("RGBA", 3, 0), 77: ("RGBA", 3, 0), 79: ("L", 4, 0), 80: ("L", 4, 0),
         82: ("RGB", 5, 0), 83: ("RGB", 5, 0), 84: ("RGB", 5, 1), 95: ("RGB", 6, 0),
         96: ("RGB", 6, 1), 97: ("RGBA", 7, 0), 98: ("RGBA", 7, 0), 99: ("RGBA", 7, 0),
         27: ("RGBA", None, 0), 28: ("RGBA", None, 0), 29: ("RGBA", None, 0)}
_BLOCK_BYTES = {1: 8, 2: 16, 3: 16, 4: 8, 5: 16, 6: 16, 7: 16}


@functools.lru_cache(maxsize=None)
def _load() -> ctypes.CDLL:
    """The loaded library of ``native/bcn.cpp`` (built on first use;
    raises with the compiler's message when it cannot be built)."""
    lib = _hostbuild.load_library("bcn")
    c = ctypes
    lib.bcn_decode.restype = c.c_int
    lib.bcn_decode.argtypes = [c.c_char_p, c.c_int64, c.c_int, c.c_int, c.c_int, c.c_int,
                               c.c_void_p]
    lib.bc6h_decode.restype = None
    lib.bc6h_decode.argtypes = [c.c_char_p, c.c_int64, c.c_int, c.c_int, c.c_int, c.c_void_p]
    return lib


def open_dds(data: bytes) -> dict:
    """``DdsImageFile._open``: the mode, size and decoder of the top
    surface and where its pixels start."""
    if not data.startswith(_MAGIC):
        raise _raw.Skip("not a DDS file")
    if len(data) < 8:
        raise _raw.Skip("short DDS header")             # struct.error in Pillow's open
    hsize = struct.unpack_from("<I", data, 4)[0]
    if hsize != 124:
        raise ValueError(f"Unsupported header size {hsize!r}")
    header = data[8:128]
    if len(header) != 120:
        raise ValueError(f"Incomplete header: {len(header)} bytes")
    _flags, h, w = struct.unpack_from("<3I", header)
    _pfsize, pfflags, fourcc, bitcount = struct.unpack_from("<I I 4s I", header, 68)
    out = dict(size=(w, h), offset=128, decoder="raw", n=None, sign=0, palette=None)
    if pfflags & _RGB:
        nmask = 4 if pfflags & _ALPHAPIXELS else 3
        masks = struct.unpack_from(f"<{nmask}I", header, 84)
        out.update(mode="RGBA" if nmask == 4 else "RGB", decoder="dds_rgb", bitcount=bitcount,
                   masks=masks)
    elif pfflags & _LUMINANCE:
        if bitcount == 8:
            out["mode"] = "L"
        elif bitcount == 16 and pfflags & _ALPHAPIXELS:
            out["mode"] = "LA"
        else:
            raise ValueError(f"Unsupported bitcount {bitcount} for {pfflags}")
    elif pfflags & _PALETTE8:
        pal = data[128:128 + 1024]
        out.update(mode="P", palette=pal, offset=128 + len(pal))
    elif pfflags & _FOURCC:
        if fourcc == b"DX10":
            if len(data) < 132:
                raise _raw.Skip("short DX10 header")    # struct.error in Pillow's open
            dxgi = struct.unpack_from("<I", data, 128)[0]
            if dxgi not in _DXGI:
                raise ValueError(f"Unimplemented DXGI format {dxgi}")
            kind = _DXGI[dxgi]
            out["offset"] = 148
        elif fourcc in _FOURCCS:
            kind = _FOURCCS[fourcc]
        else:
            raise ValueError(f"Unimplemented pixel format {fourcc!r}")
        mode, n, sign = kind
        out.update(mode=mode, n=n, sign=sign, decoder="raw" if n is None else "bcn")
    else:
        raise ValueError(f"Unknown pixel format flags {pfflags}")
    if w <= 0 or h <= 0:
        raise _raw.Skip("an empty size: not identified by the plugin")
    _raw.bomb_check(w, h)       # Image.open's, after the plugin's open
    return out


def half_to_u8(h: np.ndarray) -> np.ndarray:
    """Pillow's 8-bit sample of a BC6H half float (uint16 bits): 0 below
    0, 255 above 1, else ``(UINT8)(value * 255.0f)``."""
    v = np.asarray(h, np.uint16).view(np.float16).astype(np.float32)
    with np.errstate(invalid="ignore"):
        prod = v * np.float32(255.0)
        return np.where(v < 0, 0, np.where(v > 1, 255, prod)).astype(np.uint8)


def _dds_rgb(data: bytes, at: int, w: int, h: int, bitcount: int, masks) -> np.ndarray:
    """``DdsRgbDecoder``: each pixel the little-endian value of its
    ``bitcount // 8`` bytes (zeros past the end of the file), each mask's
    bits shifted down by its trailing zeros and scaled by 255 over the
    shifted mask, truncated."""
    nbytes = bitcount // 8
    npix = w * h
    out = np.zeros((npix, len(masks)), np.uint8)
    if nbytes == 0:
        return out.reshape(h, w, len(masks))
    raw = np.frombuffer(data[at:at + npix * nbytes].ljust(npix * nbytes, b"\0"), np.uint8)
    px = raw.reshape(npix, nbytes)[:, :4].astype(np.uint64)
    v = (px << (8 * np.arange(px.shape[1], dtype=np.uint64))).sum(-1)
    for i, mask in enumerate(masks):
        if not mask:
            continue
        shift = (mask & -mask).bit_length() - 1
        total = mask >> shift
        field = (v & np.uint64(mask)) >> np.uint64(shift)
        out[:, i] = (field.astype(np.float64) / total * 255).astype(np.uint8)
    return out.reshape(h, w, len(masks))


def decode_dds(data: bytes) -> tuple[np.ndarray, int]:
    """The top surface Pillow loads, as uint8 [H, W, C] samples (palettes
    expanded to RGBA), depth 8."""
    data = bytes(data)
    d = open_dds(data)
    (w, h), mode, at = d["size"], d["mode"], d["offset"]
    if d["decoder"] == "dds_rgb":
        return _dds_rgb(data, at, w, h, d["bitcount"], d["masks"]), 8
    if d["decoder"] == "raw":
        nch = {"L": 1, "LA": 2, "P": 1, "RGBA": 4}[mode]
        if at + w * h * nch > len(data):
            raise ValueError("image file is truncated")
        v = np.frombuffer(data, np.uint8, w * h * nch, at).reshape(h, w, nch)
        if mode == "P":
            pal = np.zeros((256, 4), np.uint8)
            given = np.frombuffer(d["palette"], np.uint8, len(d["palette"]) // 4 * 4)
            pal[:len(given) // 4] = given.reshape(-1, 4)
            return pal[v[..., 0]], 8
        return np.ascontiguousarray(v), 8
    n, sign = d["n"], d["sign"]
    nblocks = ((w + 3) // 4) * ((h + 3) // 4)
    if at + nblocks * _BLOCK_BYTES[n] > len(data):
        raise ValueError("image file is truncated")
    if n == 6:
        halves = np.empty((h, w, 3), np.uint16)
        _load().bc6h_decode(data, at, w, h, sign, halves.ctypes.data)
        return half_to_u8(halves), 8
    out = np.empty((h, w, {"RGBA": 4, "RGB": 3, "L": 1}[mode]), np.uint8)
    _load().bcn_decode(data, at, w, h, n, sign, out.ctypes.data)
    return out, 8


def encode_dds(arr: np.ndarray) -> bytes:
    """Pillow's uncompressed DDS of uint8 RGB or RGBA (``_save`` without a
    ``pixel_format``)."""
    mode = _raw._mode_of(arr)
    if mode not in ("RGB", "RGBA"):
        raise ValueError(f"cannot write mode {mode} as DDS")
    h, w, c = arr.shape
    alpha = c == 4
    head = _MAGIC + struct.pack("<7I", 124, _CAPS | _HEIGHT | _WIDTH | _PIXELFORMAT | _PITCH,
                                h, w, (w * 8 * c + 7) // 8, 0, 0)
    head += bytes(44)
    head += struct.pack("<4I", 32, _RGB | (_ALPHAPIXELS if alpha else 0), 0, 8 * c)
    head += struct.pack("<4I", 0xFF0000, 0xFF00, 0xFF, 0xFF000000 if alpha else 0)
    head += struct.pack("<5I", _TEXTURE, 0, 0, 0, 0)
    return head + np.ascontiguousarray(arr[..., [2, 1, 0, 3][:c]]).tobytes()
