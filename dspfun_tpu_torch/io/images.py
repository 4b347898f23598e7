"""Still-image I/O of the port: the MagickWand surface of the reference
(copy of ``dspfun_tpu/io/images.py`` on the port's own codecs).

Covers what the reference tools use from MagickWand
(spec/spec.c:46-60,141-155, ispec.c:54-81,170-182):

* read/write by path, ``-`` pipes, and ImageMagick-style ``fmt:path``
  specifiers (``png:-``, ``sixel:-``);
* pixel export/import as float arrays in [0, 1] with a channel string
  ("RGB", "RGBA", "I", ...);
* image properties, notably the base16-encoded per-channel "DC"
  property spec smuggles through the file header
  (spec/spec.h:157-168, spec.c:145-148), stored as a PNG tEXt chunk;
* sRGB <-> linear colorspace transform flags;
* original bit depth;
* sixel output (``io/sixel.py``), also the default of
  ``write_image(None, ...)`` on a terminal, as in the JAX package.

The JAX package reads and writes through Pillow; the port has its own
codecs: PNG (``io/png.py``), PNM (Pillow's PFM, CMYK and test headers
too), BMP and TIFF (``io/imgcodecs.py``:
uncompressed, LZW (libtiff's old LSB-first form too), deflate, PackBits,
JPEG (``io/jpeg.py`` with the JPEGTables), CCITT RLE, Group 3 and Group 4
(``native/fax.cpp``), Zstandard (``native/zstd.cpp``) and LZMA (the
standard library's liblzma) strips or tiles, chunky or planar, predictor 1, 2 or 3, either fill
order, every key of Pillow's ``OPEN_INFO`` (1- to 32-bit gray, signed
and float samples, palettes, RGB(A), CMYK, YCbCr through libtiff's RGBA
reader or libjpeg, CIELab through Pillow's LittleCMS transform), the
Orientation tag applied), JPEG
(``io/jpeg.py``: baseline, extended-sequential and progressive Huffman,
arithmetic-coded sequential and progressive (a ``.jpg`` within the
65,536-byte chunks Pillow hands libjpeg, whose arithmetic decoder cannot
wait for the next one; any JPEG-in-TIFF strip), a progressive file left
short smoothed as libjpeg-turbo smooths it, and 8-bit lossless; gray,
RGB, CMYK and YCCK; every JPEG, whether cv2 imports or not), GIF (``io/gif.py``: the first frame read,
Pillow's median-cut or octree palette written, through ``io/quant.py``),
WebP on read (``io/webp.py``: lossy, lossless, alpha, an animation's
first frame), TGA, PCX, DCX, SGI, QOI and IM (``io/rawimg.py``; IM's
floating-point and YCbCr modes too), ICO and CUR (``io/ico.py``, with
Pillow's LANCZOS thumbnails on ICO write), DIB (``io/imgcodecs.py``), PSD
(``io/psd.py``: the composite image), DDS (``io/dds.py`` with
``native/bcn.cpp``: uncompressed, palette, BC1 to BC7; written
uncompressed), JPEG 2000 on read (``io/jpeg2000.py`` with
``native/j2k.cpp``: JP2 and raw codestreams, reversible and irreversible),
and MPO on write (its one frame is a JPEG), each
reading what Pillow decodes and writing what it writes.  They take
every file they carry, whether cv2 imports or not.
Every TIFF Pillow opens goes to ``imgcodecs.decode_tiff``.
The rest (WebP frames with the simple loop filter or several token
partitions, and WebP output) goes through ``cv2`` where it imports
(``_cv2_decode``); where cv2 does not import, it is refused with a
``ValueError`` naming ROADMAP queue 1, item 8
and its part (``png.refusal``).  Pillow's other formats (AVIF, EPS and the
rest of ``_PILLOW_ORDER``'s refusals and ``_OTHER_WRITES``, JPEG 2000
writes among them), and the JPEG 2000 features no Pillow setting writes,
are refused with or without cv2, naming item 8h, on read and before
anything is written.
Inputs are identified as Pillow's ``Image.open`` identifies them: each
plugin in its order, passing the file on where Pillow's plugin would
(``_PILLOW_ORDER``: a JPEG frame of other than 8-bit samples, a TIFF whose
compression or pixel layout Pillow's tables lack, a PPM magic number not
among its modes), so a file no plugin opens raises "cannot identify image
file" with or without cv2; the ``fmt:`` prefix names the output format.
tests/test_torch_images.py, test_torch_image_formats.py and
test_torch_other_formats.py pin the rest to the original.
"""

from __future__ import annotations

import dataclasses
import math
import re
import struct
import sys

import numpy as np

from dspfun_tpu_torch.io import color as _color
from dspfun_tpu_torch.io import cv2_bridge as _cv2_bridge
from dspfun_tpu_torch.io import dds as _dds
from dspfun_tpu_torch.io import gif as _gif
from dspfun_tpu_torch.io import ico as _ico
from dspfun_tpu_torch.io import imgcodecs as _codecs
from dspfun_tpu_torch.io import jpeg as _jpeg
from dspfun_tpu_torch.io import jpeg2000 as _jpeg2000
from dspfun_tpu_torch.io import png as _png
from dspfun_tpu_torch.io import psd as _psd
from dspfun_tpu_torch.io import rawimg as _rawimg
from dspfun_tpu_torch.io import sixel as _sixel
from dspfun_tpu_torch.io import webp as _webp

__all__ = [
    "ImageData",
    "read_image",
    "write_image",
    "check_target",
    "base16_encode",
    "base16_decode",
    "encode_dc_property",
    "decode_dc_property",
]

# Channel letters understood by the export/import surface.  "I" is
# intensity (grayscale).
_RGBA = "RGBA"
# the formats the port writes itself beside PNG, by Pillow's format name,
# and those it hands to cv2 (with cv2's extension)
_NATIVE_WRITERS = {"PPM": _codecs.encode_pnm, "BMP": _codecs.encode_bmp,
                   "TIFF": _codecs.encode_tiff, "JPEG": _jpeg.encode_jpeg,
                   "GIF": _gif.encode_gif, "TGA": _rawimg.encode_tga,
                   "PCX": _rawimg.encode_pcx, "QOI": _rawimg.encode_qoi,
                   "DIB": _codecs.encode_dib, "MPO": _jpeg.encode_jpeg, "ICO": _ico.encode_ico,
                   "DDS": _dds.encode_dds}
# the writers that put the output's name into the file (Pillow's filename)
_NAMED_WRITERS = {"SGI": _rawimg.encode_sgi, "IM": _rawimg.encode_im}
_CV2_WRITERS = {"WEBP": ".webp"}


def _spider(d: bytes) -> bool:
    """``SpiderImageFile._open``'s header test: 27 floats of either byte
    order whose integer fields agree, iform 1 (a 2-D image)."""
    if len(d) < 108:
        return False
    for order in ">", "<":
        h = (99.0, *struct.unpack(order + "27f", d[:108]))
        if not all(math.isfinite(h[i]) and h[i] == int(h[i]) for i in (1, 2, 5, 12, 13, 22, 23)):
            continue
        if int(h[5]) in (1, 3, -11, -12, -21, -22) and int(h[22]) == int(h[13]) * int(h[23]):
            return int(h[5]) == 1
    return False


def _u32(d: bytes, o: int, order: str = "<") -> int:
    if len(d) < o + 4:
        raise _rawimg.Skip("short header")
    return struct.unpack_from(order + "I", d, o)[0]


def _gbr(d: bytes) -> bool:
    """``GbrImageFile._open``'s header checks."""
    if not (len(d) >= 8 and _u32(d, 0, ">") >= 20 and _u32(d, 4, ">") in (1, 2)):
        return False
    w, h, depth = (_u32(d, o, ">") for o in (8, 12, 16))
    return w > 0 and h > 0 and depth in (1, 4) and (_u32(d, 4, ">") == 1 or d[20:24] == b"GIMP")


def _imt(d: bytes) -> bool:
    """``ImtImageFile._open``: leading ``key value`` lines that give a
    width, a height and ``pixel n8``."""
    if b"\n" not in d[:100]:
        return False
    w = h = 0
    gray = False
    for line in d.split(b"\n"):
        if not line or line[:1] == b"\x0c" or len(line) == 1 or len(line) > 100:
            break
        if line[:1] == b"*":
            continue
        m = re.match(rb"([a-z]*) ([^ \r\n]*)", line)
        if not m:
            break
        k, v = m.group(1, 2)
        if k in (b"width", b"height"):
            w, h = (int(v), h) if k == b"width" else (w, int(v))
        gray |= k == b"pixel" and v == b"n8"
    return gray and w > 0 and h > 0


def _iptc(d: bytes) -> bool:
    """``IptcImageFile._open``'s field walk: 0x1c-tagged fields up to the
    record (8, 10); the image's (3, 60) field is required."""
    pos, info = 0, {}
    while True:
        s = d[pos:pos + 5]
        pos += len(s)
        if not s.strip(b"\0"):
            break
        if len(s) < 4 or s[0] != 0x1C or s[1] not in (1, 2, 3, 4, 5, 6, 7, 8, 9, 240):
            return False
        tag, size = (s[1], s[2]), s[3]
        if size > 132:
            raise OSError("illegal field length in IPTC/NAA file")
        if size == 128:
            size = 0
        elif size > 128:
            size = int.from_bytes((bytes(4) + d[pos:pos + size - 128])[-4:], "big")
            pos += min(size - 128, len(d) - pos)
        elif len(s) < 5:
            return False
        else:
            size = struct.unpack_from(">H", s, 3)[0]
        if tag == (8, 10):
            break
        info[tag] = d[pos:pos + size] if size else None
        pos += len(info[tag] or b"")
    if (3, 60) not in info:
        raise ValueError("cannot identify image file (an IPTC record without its (3, 60) field)")
    return isinstance(info[(3, 60)], bytes) and len(info[(3, 60)]) >= 2


def _dib_open(d: bytes) -> None:
    if int.from_bytes(d[:4], "little") not in (12, 40, 52, 56, 64, 108, 124):
        raise _rawimg.Skip("not a DIB")
    _codecs.bitmap(d, 0)


def _bmp_open(d: bytes) -> None:
    if d[:2] != b"BM":
        raise _rawimg.Skip("not a BMP")
    _codecs.bitmap(d, 14, _u32(d, 10))


def _jpeg_claim(d: bytes):
    if not d.startswith(b"\xff\xd8"):
        return None
    frame = _jpeg.frame_header(d)
    why = frame and _jpeg.unidentified(frame)
    if why:
        raise _rawimg.Skip(why)     # Pillow's SOF handler raises SyntaxError
    return _jpeg.decode_jpeg


def _tiff_claim(d: bytes):
    if d[:4] not in (b"II*\x00", b"MM\x00*"):
        return None
    why = _codecs.tiff_unidentified(d)
    if why:
        raise _rawimg.Skip(why)     # TiffImagePlugin._setup's KeyError, TypeError or SyntaxError
    return _codecs.decode_tiff


def _webp_claim(d: bytes):
    if not (d[:4] == b"RIFF" and d[8:12] == b"WEBP" and d[12:16] in (b"VP8 ", b"VP8L", b"VP8X")):
        return None
    if _webp.not_carried(d) is None:
        return _webp.decode_webp
    return lambda d: _cv2_decode(d, "WebP")


def _ported(opener, decode):
    """The claim of a format the port reads: None where Pillow's plugin
    tries the next format (``rawimg.Skip``), else the decoder."""
    def claim(d: bytes):
        try:
            opener(d)
        except _rawimg.Skip:
            return None
        return decode
    return claim


def _refused(name: str, test):
    """A format of item 8h: refused where Pillow's plugin would open the
    file (its accept test, or the first checks of its ``_open``, which may
    raise ``rawimg.Skip`` as the plugin passes the file on)."""
    def claim(d: bytes):
        try:
            ok = test(d)
        except (_rawimg.Skip, IndexError, struct.error):
            return None
        if ok:
            raise _png.refusal(f"{name} input", "h")
        return None
    return claim


# Pillow 12.1's plugins in the order ``Image.open`` tries them (``Image.ID``
# after ``Image.init()``), each a claim: the decoder of a format the port
# reads, None where the plugin passes the file on, or the refusal (naming
# item 8h) of one it does not carry.  PNG is taken first, in read_image.
_PILLOW_ORDER = (
    ("BMP", _ported(_bmp_open, _codecs.decode_bmp)),
    ("DIB", _ported(_dib_open, _codecs.decode_dib)),
    ("GIF", lambda d: _gif.decode_gif if d.startswith(b"GIF8") else None),
    ("JPEG", _jpeg_claim),
    ("PPM", lambda d: _codecs.decode_pnm if _codecs.pnm_magic(d) else None),
    ("AVIF", _refused("AVIF", lambda d: d[4:8] == b"ftyp" and d[8:12] in (b"avif", b"avis",
                                                                        b"mif1", b"msf1"))),
    ("BLP", _refused("BLP", lambda d: d.startswith((b"BLP1", b"BLP2")))),
    ("CUR", _ported(_ico.open_cur, _ico.decode_cur)),
    ("PCX", _ported(_rawimg.open_pcx, _rawimg.decode_pcx)),
    ("DCX", _ported(_rawimg.open_dcx, _rawimg.decode_dcx)),
    ("DDS", _ported(_dds.open_dds, _dds.decode_dds)),
    ("EPS", _refused("EPS", lambda d: d.startswith((b"%!PS", b"\xc5\xd0\xd3\xc6")))),
    ("FITS", _refused("FITS", lambda d: d.startswith(b"SIMPLE"))),
    ("FLI", _refused("FLI", lambda d: len(d) >= 22 and d[4:6] in (b"\x11\xaf", b"\x12\xaf")
                     and d[14:16] in (b"\0\0", b"\3\0") and d[20:22] == b"\0\0")),
    ("FTEX", _refused("FTEX", lambda d: d.startswith(b"FTEX"))),
    ("GBR", _refused("GBR", _gbr)),
    ("JPEG 2000", _ported(_jpeg2000.open_j2k, _jpeg2000.decode_j2k)),
    ("ICNS", _refused("ICNS", lambda d: d.startswith(b"icns"))),
    ("ICO", _ported(_ico.decode_ico, _ico.decode_ico)),  # Pillow decodes inside its open
    ("IM", _ported(_rawimg.open_im, _rawimg.decode_im)),
    ("IMT", _refused("IMT", _imt)),
    ("IPTC", _refused("IPTC", _iptc)),
    ("McIdas", _refused("McIdas", lambda d: d.startswith(b"\0\0\0\0\0\0\0\4"))),
    ("TIFF", _tiff_claim),
    ("MSP", _refused("MSP", lambda d: d.startswith((b"DanM", b"LinS")))),
    ("PCD", _refused("PCD", lambda d: d[2048:2052] == b"PCD_")),
    ("PIXAR", _refused("PIXAR", lambda d: d.startswith(b"\x80\xe8\0\0"))),
    ("PSD", _ported(_psd.open_psd, _psd.decode_psd)),
    ("QOI", _ported(_rawimg.open_qoi, _rawimg.decode_qoi)),
    ("SGI", _ported(_rawimg.open_sgi, _rawimg.decode_sgi)),
    ("SPIDER", _refused("SPIDER", _spider)),
    ("Sun raster", _refused("Sun raster", lambda d: d.startswith(b"\x59\xa6\x6a\x95"))),
    ("TGA", _ported(_rawimg.open_tga, _rawimg.decode_tga)),
    ("WEBP", _webp_claim),
    ("XBM", _refused("XBM", lambda d: d[:16].lstrip().startswith(b"#define"))),
    ("XPM", _refused("XPM", lambda d: d.startswith(b"/* XPM */"))),
    ("XV thumbnail", _refused("XV thumbnail", lambda d: d.startswith(b"P7 332"))),
)
# Pillow 12.1's save formats that the port does not write, refused
# naming item 8h before anything is read or written
_OTHER_WRITES = frozenset({"AVIF", "BLP", "EPS", "ICNS", "JPEG2000", "MSP", "PALM", "PDF",
                           "SPIDER", "XBM"})


def base16_encode(data: bytes) -> str:
    """spec's base16 codec: low nibble first, each nibble + 'A'
    (reference spec/spec.h:157-163)."""
    out = []
    for b in data:
        out.append(chr((b & 15) + 65))
        out.append(chr((b >> 4) + 65))
    return "".join(out)


def base16_decode(s: str) -> bytes:
    """Inverse of base16_encode (reference spec/spec.h:164-168)."""
    out = bytearray()
    for i in range(0, len(s) - 1, 2):
        out.append((ord(s[i]) - 65) | ((ord(s[i + 1]) - 65) << 4))
    return bytes(out)


def encode_dc_property(dc: np.ndarray) -> str:
    """Per-channel DC as base16 of little-endian float64s
    (reference spec/spec.c:66-68,145-148)."""
    return base16_encode(struct.pack("<%dd" % len(dc), *np.asarray(dc, dtype=np.float64)))


def decode_dc_property(prop: str, channels: int) -> np.ndarray:
    raw = base16_decode(prop)
    return np.array(struct.unpack("<%dd" % channels, raw[: 8 * channels]), dtype=np.float64)


@dataclasses.dataclass
class ImageData:
    """Float pixels in [0,1], shape [H, W, C], plus metadata."""

    pixels: np.ndarray
    channels: str = "RGB"
    properties: dict = dataclasses.field(default_factory=dict)
    depth: int = 8
    # Was the source tagged as linear RGB (ImageMagick "RGB" colorspace)?
    linear: bool = False

    @property
    def height(self) -> int:
        return self.pixels.shape[0]

    @property
    def width(self) -> int:
        return self.pixels.shape[1]


def _split_spec(spec: str) -> tuple[str | None, str]:
    """Split an ImageMagick-style ``fmt:path`` specifier."""
    known = ("png", "jpg", "jpeg", "bmp", "ppm", "pgm", "tiff", "webp", "sixel", "gif")
    if ":" in spec:
        fmt, rest = spec.split(":", 1)
        if fmt.lower() in known:
            return fmt.lower(), rest
    return None, spec


def _to_channels(rgba: np.ndarray, channels: str) -> np.ndarray:
    """Map an [H,W,4] float RGBA array onto a channel-letter string."""
    planes = []
    for ch in channels.upper():
        if ch in _RGBA:
            planes.append(rgba[..., _RGBA.index(ch)])
        elif ch == "I":
            # ITU-R 601 luma, matching common grayscale conversion.
            planes.append(
                0.299 * rgba[..., 0] + 0.587 * rgba[..., 1] + 0.114 * rgba[..., 2]
            )
        else:
            raise ValueError(f"unsupported channel {ch!r}")
    return np.stack(planes, axis=-1)


def _from_channels(pix: np.ndarray, channels: str) -> np.ndarray:
    """Expand channel-letter planes back to [H,W,4] RGBA in [0,1]."""
    h, w = pix.shape[:2]
    rgba = np.zeros((h, w, 4), dtype=np.float64)
    rgba[..., 3] = 1.0
    for i, ch in enumerate(channels.upper()):
        if ch in _RGBA:
            rgba[..., _RGBA.index(ch)] = pix[..., i]
        elif ch == "I":
            rgba[..., 0] = rgba[..., 1] = rgba[..., 2] = pix[..., i]
        else:
            raise ValueError(f"unsupported channel {ch!r}")
    return rgba


def _rgba(arr: np.ndarray, trns: tuple | None) -> np.ndarray:
    """A decoded image's [H, W, C] integers as float RGBA in [0, 1]: gray
    replicated, a missing alpha 1, and the ``tRNS`` colour of an 8-bit
    gray or RGB PNG transparent (what Pillow's ``convert("RGBA")`` makes
    of it).  int32 gray is Pillow's ``I`` mode, which the JAX package
    divides by 65535 whatever its range (values below 0 and above 1
    kept)."""
    top = 65535.0 if arr.dtype == np.int32 else float(np.iinfo(arr.dtype).max)
    fa = arr.astype(np.float64) / top
    h, w, nch = fa.shape
    rgba = np.zeros((h, w, 4), dtype=np.float64)
    rgba[..., 3] = 1.0
    if nch <= 2:
        rgba[..., 0] = rgba[..., 1] = rgba[..., 2] = fa[..., 0]
        if nch == 2:
            rgba[..., 3] = fa[..., 1]
    else:
        rgba[..., :nch] = fa
    if trns is not None:
        rgba[(arr == np.asarray(trns)).all(axis=-1), 3] = 0.0
    return rgba


def _cv2_decode(data: bytes, name: str) -> tuple[np.ndarray, int]:
    """A WebP image the port's codec does not take (``webp.not_carried``),
    through cv2 (imported here and nowhere else in this module): samples
    as the other decoders give them, 16-bit color cut to its high bytes as
    Pillow's ``RGB`` mode holds it.  Without cv2 it is refused naming its
    part of ROADMAP queue 1 item 8."""
    what, part = _webp.not_carried(data) or (name, "f")
    try:
        import cv2  # noqa: PLC0415
    except Exception:  # noqa: BLE001 — any import failure: no codec here
        raise _png.refusal(f"{what} input", part) from None
    img = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_UNCHANGED)
    if img is None:
        raise ValueError(f"cv2 cannot decode this {what} input ({_png.NOT_PORTED}{part})")
    if img.ndim == 2:
        img = img[..., None]
    if img.shape[2] >= 3:
        img = img[..., [2, 1, 0, 3][:img.shape[2]]]  # BGR(A) -> RGB(A)
    if img.dtype == np.uint16 and img.shape[2] > 1:
        img = (img >> 8).astype(np.uint8)
    return np.ascontiguousarray(img), 16 if img.dtype == np.uint16 else 8


def _decoder(data: bytes):
    """The decoder of an image file, found as Pillow's ``Image.open`` finds
    it (``_PILLOW_ORDER``): a function of the bytes to (samples, depth).
    The port's own codecs take every file they carry, whether cv2 imports
    or not; cv2 takes the rest."""
    passed = []
    for _name, claim in _PILLOW_ORDER:
        try:
            decode = claim(data)
        except _rawimg.Skip as e:     # the plugin's open failed: Pillow tries the next one
            passed.append(str(e))
            continue
        if decode is not None:
            return decode
    raise ValueError("cannot identify image file" + (f" ({'; '.join(passed)})" if passed else ""))


def read_image(spec: str, channels: str = "RGB", linear: bool = False) -> ImageData:
    """Read an image (path, ``-`` for stdin, or ``fmt:path``).

    ``linear=True`` converts sRGB input to linear light, the ``-g``
    behaviour (MagickTransformImageColorspace(RGBColorspace),
    reference spec/spec.c:57).
    """
    _, path = _split_spec(spec)
    if path == "-":
        data = sys.stdin.buffer.read()
    else:
        with open(path, "rb") as f:
            data = f.read()

    if data.startswith(b"\x89PNG\r\n\x1a\n"):
        arr, properties, trns = _png.decode_png(data)
        depth = 8 * arr.dtype.itemsize
    else:
        (arr, depth), properties, trns = _decoder(data)(data), {}, None
    rgba = _rgba(arr, trns)

    was_linear = properties.get("colorspace") == "RGB"
    if linear and not was_linear:
        rgba = np.concatenate(
            [_color.srgb_decode(rgba[..., :3]), rgba[..., 3:]], axis=-1
        )
    pix = _to_channels(rgba, channels)
    return ImageData(
        pixels=pix,
        channels=channels,
        properties=properties,
        depth=depth,
        linear=linear or was_linear,
    )


def _format_name(fmt: str | None, path: str) -> str:
    """Pillow's format name for an output, as the JAX package picks it."""
    name = (fmt or (path.rsplit(".", 1)[-1] if "." in path else "png")).upper()
    if name == "JPG":
        name = "JPEG"
    if path == "-" and not fmt:
        name = "PNG"
    return name


def check_target(spec: str | None) -> tuple[str | None, str]:
    """The (format, path) of an output specifier (``sixel:-`` for None on a
    terminal, as in the JAX package), or the ``ValueError`` of a
    compressed format when cv2 does not import here.  The tools call it
    before they read anything."""
    if spec is None:
        spec = "sixel:-" if sys.stdout.isatty() else "-"
    fmt, path = _split_spec(spec)
    name = _format_name(fmt, path)
    if fmt != "sixel" and name in _OTHER_WRITES:
        raise _png.refusal(f"{name} output", "h")
    if fmt != "sixel" and name in _CV2_WRITERS and not _cv2_bridge.available():
        raise _png.refusal(f"{name} output", "f")
    return fmt, path


def write_image(
    spec: str | None,
    pixels: np.ndarray,
    channels: str = "RGB",
    properties: dict | None = None,
    to_srgb: bool = False,
    depth: int = 8,
) -> None:
    """Write float pixels in [0,1] to path / ``-`` stdout / ``fmt:path``.

    ``to_srgb=True`` re-encodes linear-light pixels with the sRGB OETF
    before quantisation (the output half of ``-g``,
    reference ispec.c:173-176).  ``spec=None`` defaults to sixel on a
    tty, matching the reference tools' isatty behaviour
    (spec/spec.c:41-42).  Text properties go into PNG files only; 16-bit
    output is PNG, or gray in PPM or TIFF (the JAX package's rules).
    """
    fmt, path = check_target(spec)

    rgba = _from_channels(np.asarray(pixels, dtype=np.float64), channels)
    if to_srgb:
        rgba = np.concatenate(
            [_color.srgb_encode(rgba[..., :3]), rgba[..., 3:]], axis=-1
        )
    scale = (1 << depth) - 1
    quant = np.clip(np.rint(np.clip(rgba, 0.0, 1.0) * scale), 0, scale)

    if fmt == "sixel":
        rgb8 = (quant[..., :3] * (255.0 / scale)).astype(np.uint8)
        stream = sys.stdout.buffer if path == "-" else open(path, "wb")  # noqa: SIM115
        try:
            _sixel.write_sixel(rgb8, stream)
        finally:
            if path != "-":
                stream.close()
        return

    name = _format_name(fmt, path)
    has_alpha = "A" in channels.upper()
    if depth == 16:
        if len(channels) == 1:
            arr = quant[..., 0].astype(np.uint16)       # 16-bit gray
        elif name == "PNG":
            arr = quant[..., :4 if has_alpha else 3].astype(np.uint16)
        else:
            fmt16 = (fmt or (path.rsplit(".", 1)[-1] if "." in path else "png")).lower()
            raise ValueError(f"16-bit output requires PNG (got {fmt16!r})")
    else:
        arr = quant.astype(np.uint8)
        if not has_alpha:
            arr = arr[..., :3]

    if name == "PNG":
        data = _png.encode_png(arr, properties)
    elif name in ("JPEG", "MPO") and (arr.dtype != np.uint8 or arr.ndim == 3
                                      and arr.shape[2] == 4):
        # Pillow writes no alpha and no 16 bits as JPEG (an MPO's one frame)
        raise ValueError(f"cannot write {'I;16' if arr.dtype != np.uint8 else 'RGBA'} as JPEG")
    elif name in _NATIVE_WRITERS:
        data = _NATIVE_WRITERS[name](arr)
    elif name in _NAMED_WRITERS:
        data = _NAMED_WRITERS[name](arr, "" if path == "-" else path)
    elif name in _CV2_WRITERS:
        data = _cv2_encode(arr, name)
    else:
        raise ValueError(f"unknown image format {name!r}")
    if path == "-":
        sys.stdout.buffer.write(data)
        sys.stdout.buffer.flush()
    else:
        with open(path, "wb") as f:
            f.write(data)


def _cv2_encode(arr: np.ndarray, name: str) -> bytes:
    """A compressed file through cv2, at Pillow's default quality (WebP
    80)."""
    import cv2  # noqa: PLC0415

    img = arr if arr.ndim == 2 else arr[..., [2, 1, 0, 3][:arr.shape[2]]]
    params = {"WEBP": [cv2.IMWRITE_WEBP_QUALITY, 80]}.get(name, [])
    ok, buf = cv2.imencode(_CV2_WRITERS[name], np.ascontiguousarray(img), params)
    if not ok:
        raise ValueError(f"cv2 cannot write this image as {name}")
    return buf.tobytes()
