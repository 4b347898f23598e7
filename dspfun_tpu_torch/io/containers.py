"""Pillow 12.1's FTEX, FLI, PCD and IPTC plugins, read by the port's own
code with no Pillow.

Each format is an ``open_*`` (the plugin's accept test and ``_open``:
:class:`rawimg.Skip` where ``Image.open`` would try the next plugin, any
other error where the open fails) and a ``decode_*`` (what ``load`` and
the JAX package's ``read_image`` make of the image: uint8 [H, W, C]
samples and the depth).  Pillow's reading is copied, not corrected:

* **FTEX** (``FtexImagePlugin``): one format (format 0 DXT1, through
  ``native/bcn.cpp``'s BC1 decoder as Pillow's ``bcn`` decoder, to
  ``RGBA``; format 1 raw ``RGB``), its mipmap read at the offset the
  header gives; any other format count fails the open.
* **FLI/FLC** (``FliImagePlugin``, ``FliDecode.c``): the 128-byte header
  and its zero fields, a prefix chunk (0xF100) passed over in the search
  for the first frame's palette chunk (4, 256 colours, or 11, 64 colours
  shifted left by 2, each entry kept to 8 bits), a gray ramp without one;
  the first frame decoded from offset 128 (where a prefix chunk, which
  the decoder does not take, fails the load) in the blocks of its frame
  size that ``ImageFile.load`` hands over, by
  ``native/rawimg.cpp:fli_decode`` (SS2, LC, BLACK, BRUN, COPY; colour
  and stamp chunks passed over), into a ``P`` image that starts black.
* **PCD** (``PcdImagePlugin``, ``PcdDecode.c``): the 768x512 base image
  at 96 * 2048, two luma rows then their 4:2:0 Cb and Cr (half rows), a
  pair of rows at a time; ``UnpackYCC.c``'s PhotoYCC tables to ``RGB``;
  the orientation's low bits 1 and 3 turning the image 90 and 270
  degrees (``rotate(..., expand=True)``).
* **IPTC** (``IptcImageFile``): the 0x1C-tagged fields up to the record
  (8, 10) (repeated tags gathered into lists, as the plugin does); the
  mode of (3, 60), the size of (3, 20) and (3, 30), compression (3, 120)
  1 (raw: a ``P5`` header put before the data) or 5 (any file
  ``Image.open`` identifies, through ``io/images.py``), the (8, 10)
  records joined; the band of (3, 65) merged into an ``RGB`` or ``CMYK``
  image whose other bands are 0.
"""

from __future__ import annotations

import ctypes
import io
import struct

import numpy as np

from dspfun_tpu_torch.io import dds as _dds
from dspfun_tpu_torch.io import imgcodecs as _codecs
from dspfun_tpu_torch.io import rawimg as _raw
from dspfun_tpu_torch.io.rasters import _open

__all__ = ["decode_fli", "decode_ftex", "decode_iptc", "decode_pcd", "iptc_fields",
           "open_fli", "open_ftex", "open_iptc", "open_pcd"]

_Skip = _raw.Skip


def _unpack(fmt: str, d: bytes, o: int) -> tuple:
    """``struct.unpack_from``, where a short read is the plugin's
    ``struct.error`` (the next format tried)."""
    if o < 0 or len(d) < o + struct.calcsize(fmt):
        raise _Skip("short header")
    return struct.unpack_from(fmt, d, o)


# ---- FTEX ---------------------------------------------------------------------------


def open_ftex(data: bytes) -> dict:
    """``FtexImageFile._open``: the size, one format and its mipmap."""
    if not data.startswith(b"FTEX"):
        raise _Skip("not an FTEX file")
    w, h, _mips, nformats = _unpack("<4i", data, 8)
    if nformats != 1:
        raise AssertionError("FTEX files hold one format")
    fmt, where = _unpack("<2i", data, 24)
    if where < 0:
        raise ValueError(f"negative seek value {where}")
    (size,) = _unpack("<i", data, where)
    mip = data[where + 4:] if size < 0 else data[where + 4:where + 4 + size]
    if fmt not in (0, 1):
        raise ValueError(f"Invalid texture compression format: {fmt!r}")
    mode = "RGBA" if fmt == 0 else "RGB"
    _open((w, h), mode)
    return dict(size=(w, h), mode=mode, mipmap=mip)


def decode_ftex(data: bytes) -> tuple[np.ndarray, int]:
    f = open_ftex(bytes(data))
    (w, h), mip = f["size"], f["mipmap"]
    if f["mode"] == "RGB":
        if len(mip) < w * h * 3:
            raise OSError("image file is truncated")
        return np.frombuffer(mip, np.uint8, w * h * 3).reshape(h, w, 3).copy(), 8
    if len(mip) < ((w + 3) // 4) * ((h + 3) // 4) * 8:
        raise OSError("image file is truncated")
    out = np.empty((h, w, 4), np.uint8)
    _dds._load().bcn_decode(mip, 0, w, h, 1, 0, out.ctypes.data)
    return out, 8


# ---- FLI/FLC ------------------------------------------------------------------------

_FLI_ERRORS = {-2: "buffer overrun when reading image file",
               -3: "broken data stream when reading image file",
               -4: "unrecognized data stream contents when reading image file"}


def _fli_palette(data: bytes, pos: int, shift: int) -> np.ndarray:
    """``FliImageFile._palette``: packets of a skip and a count of entries
    (0 is 256) into the gray ramp."""
    pal = np.repeat(np.arange(256, dtype=np.int64)[:, None], 3, 1)
    (npackets,) = _unpack("<H", data, pos)
    pos += 2
    i = 0
    for _ in range(npackets):
        s = data[pos:pos + 2]
        pos += len(s)
        if len(s) < 2:
            raise _Skip("short FLI palette packet")
        i, n = i + s[0], s[1] or 256
        rgb = data[pos:pos + 3 * n]
        pos += len(rgb)
        if len(rgb) % 3 or rgb and i + len(rgb) // 3 > 256:
            raise _Skip("a FLI palette past its 256 entries or cut in an entry")
        k = len(rgb) // 3
        pal[i:i + k] = np.frombuffer(rgb, np.uint8).reshape(k, 3).astype(np.int64) << shift
        i += k
    return (pal & 255).astype(np.uint8)


def open_fli(data: bytes) -> dict:
    """``FliImageFile._open``: the header, the first frame's palette and
    the first frame's size (its decode starts at 128)."""
    if not (len(data) >= 16 and _unpack("<H", data, 4)[0] in (0xAF11, 0xAF12)
            and _unpack("<H", data, 14)[0] in (0, 3)):
        raise _Skip("not an FLI file")
    s = data[:128]
    if not (s[20:22] == bytes(2) and s[42:80] == bytes(38) and s[88:] == bytes(40)):
        raise _Skip("not an FLI/FLC file")
    w, h = _unpack("<HH", data, 8)
    pal = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, 1)
    at = 128
    if _unpack("<H", data, at + 4)[0] == 0xF100:      # a prefix chunk
        at = 128 + _unpack("<I", data, at)[0]
    if _unpack("<H", data, at + 4)[0] == 0xF1FA:
        (chunks,) = _unpack("<H", data, at + 6)
        pos, size = at + 16, None
        for _ in range(chunks):
            if size is not None:
                pos = max(pos + size - 6, 0)
            s = data[pos:pos + 6]
            pos += len(s)
            (kind,) = _unpack("<H", s, 4)
            if kind in (4, 11):
                pal = _fli_palette(data, pos, 2 if kind == 11 else 0)
                break
            (size,) = _unpack("<I", s, 0)
            if not size:
                break
    if len(data) <= 128:
        raise _Skip("missing frame size")
    (framesize,) = _unpack("<I", data, 128)
    _open((w, h), "P")
    return dict(size=(w, h), palette=pal, framesize=framesize)


def decode_fli(data: bytes) -> tuple[np.ndarray, int]:
    """The first frame, as ``ImageFile.load`` feeds ``FliDecode.c``: the
    file from 128 in reads of the frame size, each call given what is
    left of the ones before; the palette's RGB of each index."""
    data = bytes(data)
    f = open_fli(data)
    (w, h), rb = f["size"], f["framesize"]
    im = np.zeros((h, w), np.uint8)
    lib, err = _raw._load(), ctypes.c_int(0)
    pos, b = 128, b""
    while True:
        s = data[pos:pos + rb]
        pos += len(s)
        if not s:
            raise OSError(f"image file is truncated ({len(b)} bytes not processed)")
        b += s
        n = lib.fli_decode(b, len(b), w, h, _raw._ptr(im), ctypes.byref(err))
        if n < 0:
            break
        b = b[n:]
    if err.value < 0:
        raise OSError(f"decoder error {err.value} ({_FLI_ERRORS.get(err.value, '')})")
    return f["palette"][im], 8


# ---- PCD ----------------------------------------------------------------------------

_YCC_CB = np.array([
    -345, -343, -341, -338, -336, -334, -332, -329, -327, -325, -323, -321, -318, -316,
    -314, -312, -310, -307, -305, -303, -301, -298, -296, -294, -292, -290, -287, -285,
    -283, -281, -278, -276, -274, -272, -270, -267, -265, -263, -261, -258, -256, -254,
    -252, -250, -247, -245, -243, -241, -239, -236, -234, -232, -230, -227, -225, -223,
    -221, -219, -216, -214, -212, -210, -207, -205, -203, -201, -199, -196, -194, -192,
    -190, -188, -185, -183, -181, -179, -176, -174, -172, -170, -168, -165, -163, -161,
    -159, -156, -154, -152, -150, -148, -145, -143, -141, -139, -137, -134, -132, -130,
    -128, -125, -123, -121, -119, -117, -114, -112, -110, -108, -105, -103, -101, -99,
    -97, -94, -92, -90, -88, -85, -83, -81, -79, -77, -74, -72, -70, -68, -66, -63, -61,
    -59, -57, -54, -52, -50, -48, -46, -43, -41, -39, -37, -34, -32, -30, -28, -26, -23,
    -21, -19, -17, -15, -12, -10, -8, -6, -3, -1, 0, 2, 4, 7, 9, 11, 13, 16, 18, 20, 22,
    24, 27, 29, 31, 33, 35, 38, 40, 42, 44, 47, 49, 51, 53, 55, 58, 60, 62, 64, 67, 69,
    71, 73, 75, 78, 80, 82, 84, 86, 89, 91, 93, 95, 98, 100, 102, 104, 106, 109, 111,
    113, 115, 118, 120, 122, 124, 126, 129, 131, 133, 135, 138, 140, 142, 144, 146, 149,
    151, 153, 155, 157, 160, 162, 164, 166, 169, 171, 173, 175, 177, 180, 182, 184, 186,
    189, 191, 193, 195, 197, 200, 202, 204, 206, 208, 211, 213, 215, 217, 220])
_YCC_CR = np.array([
    -249, -247, -245, -243, -241, -239, -238, -236, -234, -232, -230, -229, -227, -225,
    -223, -221, -219, -218, -216, -214, -212, -210, -208, -207, -205, -203, -201, -199,
    -198, -196, -194, -192, -190, -188, -187, -185, -183, -181, -179, -178, -176, -174,
    -172, -170, -168, -167, -165, -163, -161, -159, -157, -156, -154, -152, -150, -148,
    -147, -145, -143, -141, -139, -137, -136, -134, -132, -130, -128, -127, -125, -123,
    -121, -119, -117, -116, -114, -112, -110, -108, -106, -105, -103, -101, -99, -97,
    -96, -94, -92, -90, -88, -86, -85, -83, -81, -79, -77, -76, -74, -72, -70, -68, -66,
    -65, -63, -61, -59, -57, -55, -54, -52, -50, -48, -46, -45, -43, -41, -39, -37, -35,
    -34, -32, -30, -28, -26, -25, -23, -21, -19, -17, -15, -14, -12, -10, -8, -6, -4,
    -3, -1, 0, 2, 4, 5, 7, 9, 11, 13, 15, 16, 18, 20, 22, 24, 26, 27, 29, 31, 33, 35,
    36, 38, 40, 42, 44, 46, 47, 49, 51, 53, 55, 56, 58, 60, 62, 64, 66, 67, 69, 71, 73,
    75, 77, 78, 80, 82, 84, 86, 87, 89, 91, 93, 95, 97, 98, 100, 102, 104, 106, 107,
    109, 111, 113, 115, 117, 118, 120, 122, 124, 126, 128, 129, 131, 133, 135, 137, 138,
    140, 142, 144, 146, 148, 149, 151, 153, 155, 157, 158, 160, 162, 164, 166, 168, 169,
    171, 173, 175, 177, 179, 180, 182, 184, 186, 188, 189, 191, 193, 195, 197, 199, 200,
    202, 204, 206, 208, 209, 211, 213, 215])
_YCC_GB = np.array([
    67, 67, 66, 66, 65, 65, 65, 64, 64, 63, 63, 62, 62, 62, 61, 61, 60, 60, 59, 59, 59,
    58, 58, 57, 57, 56, 56, 56, 55, 55, 54, 54, 53, 53, 52, 52, 52, 51, 51, 50, 50, 49,
    49, 49, 48, 48, 47, 47, 46, 46, 46, 45, 45, 44, 44, 43, 43, 43, 42, 42, 41, 41, 40,
    40, 40, 39, 39, 38, 38, 37, 37, 37, 36, 36, 35, 35, 34, 34, 34, 33, 33, 32, 32, 31,
    31, 31, 30, 30, 29, 29, 28, 28, 28, 27, 27, 26, 26, 25, 25, 25, 24, 24, 23, 23, 22,
    22, 22, 21, 21, 20, 20, 19, 19, 19, 18, 18, 17, 17, 16, 16, 15, 15, 15, 14, 14, 13,
    13, 12, 12, 12, 11, 11, 10, 10, 9, 9, 9, 8, 8, 7, 7, 6, 6, 6, 5, 5, 4, 4, 3, 3, 3,
    2, 2, 1, 1, 0, 0, 0, 0, 0, -1, -1, -2, -2, -2, -3, -3, -4, -4, -5, -5, -5, -6, -6,
    -7, -7, -8, -8, -8, -9, -9, -10, -10, -11, -11, -11, -12, -12, -13, -13, -14, -14,
    -14, -15, -15, -16, -16, -17, -17, -18, -18, -18, -19, -19, -20, -20, -21, -21, -21,
    -22, -22, -23, -23, -24, -24, -24, -25, -25, -26, -26, -27, -27, -27, -28, -28, -29,
    -29, -30, -30, -30, -31, -31, -32, -32, -33, -33, -33, -34, -34, -35, -35, -36, -36,
    -36, -37, -37, -38, -38, -39, -39, -39, -40, -40, -41, -41, -42])
_YCC_GR = np.array([
    127, 126, 125, 124, 123, 122, 121, 121, 120, 119, 118, 117, 116, 115, 114, 113, 112,
    111, 110, 109, 108, 108, 107, 106, 105, 104, 103, 102, 101, 100, 99, 98, 97, 96, 95,
    95, 94, 93, 92, 91, 90, 89, 88, 87, 86, 85, 84, 83, 83, 82, 81, 80, 79, 78, 77, 76,
    75, 74, 73, 72, 71, 70, 70, 69, 68, 67, 66, 65, 64, 63, 62, 61, 60, 59, 58, 57, 57,
    56, 55, 54, 53, 52, 51, 50, 49, 48, 47, 46, 45, 45, 44, 43, 42, 41, 40, 39, 38, 37,
    36, 35, 34, 33, 32, 32, 31, 30, 29, 28, 27, 26, 25, 24, 23, 22, 21, 20, 19, 19, 18,
    17, 16, 15, 14, 13, 12, 11, 10, 9, 8, 7, 6, 6, 5, 4, 3, 2, 1, 0, 0, -1, -2, -3, -4,
    -5, -5, -6, -7, -8, -9, -10, -11, -12, -13, -14, -15, -16, -17, -18, -18, -19, -20,
    -21, -22, -23, -24, -25, -26, -27, -28, -29, -30, -31, -31, -32, -33, -34, -35, -36,
    -37, -38, -39, -40, -41, -42, -43, -44, -44, -45, -46, -47, -48, -49, -50, -51, -52,
    -53, -54, -55, -56, -56, -57, -58, -59, -60, -61, -62, -63, -64, -65, -66, -67, -68,
    -69, -69, -70, -71, -72, -73, -74, -75, -76, -77, -78, -79, -80, -81, -82, -82, -83,
    -84, -85, -86, -87, -88, -89, -90, -91, -92, -93, -94, -94, -95, -96, -97, -98, -99,
    -100, -101, -102, -103, -104, -105, -106, -107, -107, -108])
_PCD_BASE = 96 * 2048


def open_pcd(data: bytes) -> dict:
    """``PcdImageFile._open``: the ``PCD_`` tag at 2048 and the orientation
    byte 1538 bytes after it."""
    s = data[2048:2048 + 1539]
    if not s.startswith(b"PCD_"):
        raise _Skip("not a PCD file")
    if len(s) < 1539:
        raise _Skip("short PCD header")
    turn = {1: 90, 3: 270}.get(s[1538] & 3)
    return dict(size=(512, 768) if turn else (768, 512), turn=turn)


def decode_pcd(data: bytes) -> tuple[np.ndarray, int]:
    """The 768x512 base image through ``UnpackYCC.c``'s tables, turned as
    the orientation says."""
    data = bytes(data)
    p = open_pcd(data)
    need = 256 * 3 * 768
    if len(data) < _PCD_BASE + need:
        raise OSError("image file is truncated")
    pairs = np.frombuffer(data, np.uint8, need, _PCD_BASE).reshape(256, 3 * 768)
    y = pairs[:, :2 * 768].reshape(512, 768).astype(np.int64)
    half = np.arange(768) // 2
    cb = np.repeat(pairs[:, 2 * 768 + half], 2, 0).astype(np.int64)
    cr = np.repeat(pairs[:, 2 * 768 + 384 + half], 2, 0).astype(np.int64)
    lum = np.floor(1.3584 * y + 0.5).astype(np.int64)   # UnpackYCC.c's L table
    rgb = np.stack([lum + _YCC_CR[cr], lum + _YCC_GB[cb] + _YCC_GR[cr], lum + _YCC_CB[cb]], -1)
    rgb = np.clip(rgb, 0, 255).astype(np.uint8)
    if p["turn"]:
        rgb = np.rot90(rgb, 1 if p["turn"] == 90 else 3)
    return np.ascontiguousarray(rgb), 8


# ---- IPTC ---------------------------------------------------------------------------

_IPTC_RECORDS = (1, 2, 3, 4, 5, 6, 7, 8, 9, 240)
# what ImageFile.__init__ and Image.open take as "not this format"
_PASSED_ON = (SyntaxError, IndexError, TypeError, KeyError, EOFError, struct.error)


def _iptc_int(c: bytes) -> int:
    return int.from_bytes((b"\0\0\0\0" + c)[-4:], "big")


def _iptc_field(fp: io.BytesIO) -> tuple:
    """``IptcImageFile.field``: (tag, size), or (None, 0) at a field of
    zeros or the end; Pillow's errors as its Python raises them."""
    s = fp.read(5)
    if not s.strip(b"\0"):
        return None, 0
    tag = s[1], s[2]
    if s[0] != 0x1C or tag[0] not in _IPTC_RECORDS:
        raise SyntaxError("invalid IPTC/NAA file")
    size = s[3]
    if size > 132:
        raise OSError("illegal field length in IPTC/NAA file")
    if size == 128:
        size = 0
    elif size > 128:
        size = _iptc_int(fp.read(size - 128))
    else:
        size = struct.unpack_from(">H", s, 3)[0]
    return tag, size


def iptc_fields(data: bytes) -> tuple[dict, tuple | None, int]:
    """``IptcImageFile._open``'s walk: the fields up to (8, 10) or a field
    of zeros (a repeated tag's data gathered in a list), the tag it stopped
    at and that field's offset."""
    fp, info = io.BytesIO(data), {}
    while True:
        offset = fp.tell()
        tag, size = _iptc_field(fp)
        if not tag or tag == (8, 10):
            return info, tag, offset
        tagdata = fp.read(size) if size else None
        if tag not in info:
            info[tag] = tagdata
        elif isinstance(info[tag], list):
            info[tag].append(tagdata)
        else:
            info[tag] = [info[tag], tagdata]


def open_iptc(data: bytes) -> dict:
    """``IptcImageFile._open``: the mode, size, compression and band of the
    fields, and where the image's records start; :class:`rawimg.Skip`
    where the plugin passes the file on (the (3, 60) field missing among
    them)."""
    try:
        info, tag, offset = iptc_fields(data)
        layers, component = info[(3, 60)][0], info[(3, 60)][1]
        mode, band = "", None
        if layers == 1 and not component:
            mode = "L"
        else:
            if layers == 3 and component:
                mode = "RGB"
            elif layers == 4 and component:
                mode = "CMYK"
            band = info[(3, 65)][0] - 1 if (3, 65) in info else 0
        size = _iptc_int(info[(3, 20)]), _iptc_int(info[(3, 30)])
        try:
            compression = {1: "raw", 5: "jpeg"}[_iptc_int(info[(3, 120)])]
        except KeyError:
            raise OSError("Unknown IPTC image compression") from None
    except _PASSED_ON as e:
        raise _Skip(f"not an IPTC/NAA image ({type(e).__name__}: {e})") from None
    _open(size, mode)
    return dict(mode=mode, size=size, band=band, compression=compression,
                offset=offset if tag == (8, 10) else None)


def decode_iptc(data: bytes) -> tuple[np.ndarray, int]:
    """``IptcImageFile.load``: the (8, 10) records joined (behind a ``P5``
    header for raw data), the file they make opened as ``Image.open``
    opens it (``io/images.py``), and its band merged where the fields ask
    for ``RGB`` or ``CMYK``.  The mode stays the fields' one, so the JAX
    package reads depth 8 and converts what loaded."""
    from dspfun_tpu_torch.io import images as _images  # noqa: PLC0415 — images imports this

    data = bytes(data)
    p = open_iptc(data)
    if p["offset"] is None:
        raise OSError("cannot load this image")
    fp = io.BytesIO(data)
    fp.seek(p["offset"])
    parts = [b"P5\n%d %d\n255\n" % p["size"]] if p["compression"] == "raw" else []
    while True:
        tag, size = _iptc_field(fp)
        if tag != (8, 10):
            break
        parts.append(fp.read(size))
    inner = b"".join(parts)
    arr, _depth = _images._decoder(inner)(inner)
    if p["band"] is None:       # the inner image's own samples, converted to 8 bits
        return (arr if arr.dtype == np.uint8 else np.clip(arr, 0, 255).astype(np.uint8)), 8
    nb, band = len(p["mode"]), p["band"]
    if arr.ndim != 3 or arr.shape[2] != 1 or arr.dtype != np.uint8:
        raise ValueError("mode mismatch")
    if not -nb <= band < nb:
        raise IndexError("list assignment index out of range")
    out = np.zeros(arr.shape[:2] + (nb,), np.uint8)
    out[..., band] = arr[..., 0]
    return (_codecs._cmyk_rgb(out) if nb == 4 else out), 8
