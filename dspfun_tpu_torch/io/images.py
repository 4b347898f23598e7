"""Still-image I/O of the port: the MagickWand surface of the reference
(copy of ``dspfun_tpu/io/images.py`` on the port's own PNG codec).

Covers what the reference tools use from MagickWand
(spec/spec.c:46-60,141-155, ispec.c:54-81,170-182):

* read/write by path, ``-`` pipes, and ImageMagick-style ``fmt:path``
  specifiers (``png:-``);
* pixel export/import as float arrays in [0, 1] with a channel string
  ("RGB", "RGBA", "I", ...);
* image properties, notably the base16-encoded per-channel "DC"
  property spec smuggles through the file header
  (spec/spec.h:157-168, spec.c:145-148), stored as a PNG tEXt chunk;
* sRGB <-> linear colorspace transform flags;
* original bit depth.

The JAX package reads and writes through Pillow; the port has
``io/png.py`` and nothing else, so it differs in what it refuses, each
with a ``ValueError`` naming the ROADMAP item: every format but PNG, on
read and on write (``png.NOT_PORTED``), and sixel output, including the
tty default of ``write_image(None, ...)`` (``SIXEL_NOT_PORTED``: its
palette comes from Pillow's quantiser).  Nothing falls back to another
format.  tests/test_torch_images.py pins the rest to the original.
"""

from __future__ import annotations

import dataclasses
import struct
import sys

import numpy as np

from dspfun_tpu_torch.io import color as _color
from dspfun_tpu_torch.io import png as _png

__all__ = [
    "ImageData",
    "SIXEL_NOT_PORTED",
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
SIXEL_NOT_PORTED = "ROADMAP.md queue 1, item 21"


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
    """A decoded PNG's [H, W, C] integers as float RGBA in [0, 1]: gray
    replicated, a missing alpha 1, and the ``tRNS`` colour of an 8-bit
    gray or RGB file transparent (what Pillow's ``convert("RGBA")``
    makes of it)."""
    fa = arr.astype(np.float64) / float(np.iinfo(arr.dtype).max)
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


def read_image(spec: str, channels: str = "RGB", linear: bool = False) -> ImageData:
    """Read a PNG (path, ``-`` for stdin, or ``fmt:path``).

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

    arr, properties, trns = _png.decode_png(data)
    depth = 8 * arr.dtype.itemsize
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


def check_target(spec: str | None) -> tuple[str | None, str]:
    """The (format, path) of an output specifier, or the ``ValueError``
    of a target the port does not write: sixel (also the default on a
    tty) and every file format but PNG."""
    if spec is None:
        spec = "sixel:-" if sys.stdout.isatty() else "-"
    fmt, path = _split_spec(spec)
    if fmt == "sixel":
        raise ValueError("sixel output (the default on a terminal) is not ported to "
                         f"dspfun_tpu_torch; name a PNG file ({SIXEL_NOT_PORTED})")
    name = (fmt or (path.rsplit(".", 1)[-1] if "." in path else "png")).lower()
    if name != "png":
        raise _png.refusal(f"{name.upper()} output")
    return fmt, path


def write_image(
    spec: str | None,
    pixels: np.ndarray,
    channels: str = "RGB",
    properties: dict | None = None,
    to_srgb: bool = False,
    depth: int = 8,
) -> None:
    """Write float pixels in [0,1] to a PNG: path / ``-`` stdout / ``png:path``.

    ``to_srgb=True`` re-encodes linear-light pixels with the sRGB OETF
    before quantisation (the output half of ``-g``,
    reference ispec.c:173-176).  ``spec=None`` is stdout, and refused on
    a tty, where the reference tools write sixel (spec/spec.c:41-42).
    """
    _, path = check_target(spec)

    rgba = _from_channels(np.asarray(pixels, dtype=np.float64), channels)
    if to_srgb:
        rgba = np.concatenate(
            [_color.srgb_encode(rgba[..., :3]), rgba[..., 3:]], axis=-1
        )
    scale = (1 << depth) - 1
    quant = np.clip(np.rint(np.clip(rgba, 0.0, 1.0) * scale), 0, scale)

    has_alpha = "A" in channels.upper()
    if depth == 16:
        if len(channels) == 1:
            arr = quant[..., 0].astype(np.uint16)       # 16-bit gray
        else:
            arr = quant[..., :4 if has_alpha else 3].astype(np.uint16)
    else:
        arr = quant.astype(np.uint8)
        if not has_alpha:
            arr = arr[..., :3]

    if path == "-":
        _png.write_png(sys.stdout.buffer, arr, properties)
        sys.stdout.buffer.flush()
    else:
        _png.write_png(path, arr, properties)
