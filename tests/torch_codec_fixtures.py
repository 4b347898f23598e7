"""The codec fixtures of ``tests/goldens/`` that ``chip_smoke.py`` phase 17
decodes on the card, whose machine has no Pillow: Pillow's progressive
JPEG and compressed TIFF files of ``chip_smoke._seeded_pixels`` images.

* ``codec_prog_4k.jpg``: 3840x2160 RGB, ``noise=0.02``, seed 17, quality
  75, Pillow's default progressive script (libjpeg's simple
  progression) at 4:2:0;
* ``codec_prog_gray.jpg``: 517x333 gray, seed 18;
* ``codec_prog_444_rst.jpg``: 517x333 RGB at 4:4:4, a restart marker
  every 4 MCUs, seed 18;
* ``codec_lzw_p1.tif`` and ``codec_lzw_p2.tif``: 160x120 RGB, LZW,
  predictor 1 and 2, seed 19;
* ``codec_packbits.tif``: the same pixels in PackBits;
* ``codec_rgba_assoc.tif``: the same colour premultiplied by a seeded
  alpha in LZW, ExtraSamples set to 1 (associated alpha, as GIMP writes
  it).

``chip_smoke.CODEC_FIXTURES`` holds the sha256 of each file and of
Pillow's decode of it (``np.asarray(Image.open(...))``);
tests/test_torch_jpeg.py remakes the files and checks both.  To remake
them after a change of the images (and then update those digests), run
from the root of a checkout::

    python -m tests.torch_codec_fixtures

and, to time the port's TIFF decoders against Pillow's on this host at
3840x2160, ``python -m tests.torch_codec_fixtures --rates``.
"""

from __future__ import annotations

import hashlib
import io
import struct
import sys
from pathlib import Path

import numpy as np
from PIL import Image

import chip_smoke

GOLDENS = Path(__file__).resolve().parent / "goldens"


def levels(hw, seed, noise=0.1) -> np.ndarray:
    """The 8-bit RGB levels ``write_image`` makes of the seeded pixels."""
    pix = chip_smoke._seeded_pixels(hw, seed, noise)
    return np.clip(np.rint(np.clip(pix, 0.0, 1.0) * 255), 0, 255).astype(np.uint8)


def _save(img, fmt, **kw) -> bytes:
    buf = io.BytesIO()
    img.save(buf, format=fmt, **kw)
    return buf.getvalue()


def _associated(data: bytes) -> bytes:
    """A little-endian TIFF with its ExtraSamples value set to 1."""
    out = bytearray(data)
    ifd = struct.unpack_from("<I", out, 4)[0]
    for k in range(struct.unpack_from("<H", out, ifd)[0]):
        at = ifd + 2 + 12 * k
        if struct.unpack_from("<H", out, at)[0] == 338:
            struct.pack_into("<H", out, at + 8, 1)
            return bytes(out)
    raise ValueError("no ExtraSamples tag")


def fixtures() -> dict[str, bytes]:
    """Each fixture's name and Pillow's bytes of it."""
    big = Image.fromarray(levels((chip_smoke.H, chip_smoke.W), 17, noise=0.02))
    small = Image.fromarray(levels((333, 517), 18))
    tiny = levels((120, 160), 19, noise=0.02)
    y, x = np.mgrid[0:120, 0:160]
    alpha = np.clip((x * 2 - 40) + (y - 60) // 4, 0, 255).astype(np.uint8)
    alpha[:8] = 255
    premultiplied = (tiny.astype(np.int64) * alpha[..., None] // 255).astype(np.uint8)
    rgba = Image.fromarray(np.dstack([premultiplied, alpha]))
    return {
        "codec_prog_4k.jpg": _save(big, "JPEG", progressive=True),
        "codec_prog_gray.jpg": _save(small.convert("L"), "JPEG", progressive=True),
        "codec_prog_444_rst.jpg": _save(small, "JPEG", progressive=True, subsampling=0,
                                        restart_marker_blocks=4),
        "codec_lzw_p1.tif": _save(Image.fromarray(tiny), "TIFF", compression="tiff_lzw"),
        "codec_lzw_p2.tif": _save(Image.fromarray(tiny), "TIFF", compression="tiff_lzw",
                                  tiffinfo={317: 2}),
        "codec_packbits.tif": _save(Image.fromarray(tiny), "TIFF", compression="packbits"),
        "codec_rgba_assoc.tif": _associated(_save(rgba, "TIFF", compression="tiff_lzw")),
    }


def digests(data: bytes) -> tuple[str, str]:
    """sha256 of a file and of Pillow's decode of it."""
    pixels = np.ascontiguousarray(np.asarray(Image.open(io.BytesIO(data))))
    return hashlib.sha256(data).hexdigest(), hashlib.sha256(pixels.tobytes()).hexdigest()


def rates(repeats: int = 5) -> None:
    """The port's decode of Pillow's 3840x2160 LZW (predictor 1 and 2),
    deflate and PackBits TIFFs of ``codec_prog_4k.jpg``'s levels, timed on
    this host (the best of ``repeats``), beside Pillow's (libtiff) decode
    of the same files: the LZW rate no chip run measures, since the card's
    machine has no Pillow to write a 4K LZW file."""
    import time

    from dspfun_tpu_torch.io import imgcodecs

    img = Image.fromarray(levels((chip_smoke.H, chip_smoke.W), 17, noise=0.02))
    mb = img.width * img.height * 3 / 1e6
    for comp, kw in (("tiff_lzw", {}), ("tiff_lzw", {"tiffinfo": {317: 2}}),
                     ("tiff_adobe_deflate", {}), ("packbits", {})):
        data = _save(img, "TIFF", compression=comp, **kw)
        for who, fn in (("port", lambda d=data: imgcodecs.decode_tiff(d)),
                        ("Pillow", lambda d=data: np.asarray(Image.open(io.BytesIO(d))))):
            best = float("inf")
            for _ in range(repeats):
                t0 = time.perf_counter()
                fn()
                best = min(best, time.perf_counter() - t0)
            print(f"{comp} {kw.get('tiffinfo', {}).get(317, 1)} {len(data)} bytes: {who} "
                  f"{best:.4f} s, {mb / best:.1f} MB/s of RGB")


def main(argv=None) -> None:
    if "--rates" in (sys.argv[1:] if argv is None else argv):
        rates()
        return
    for name, data in fixtures().items():
        (GOLDENS / name).write_bytes(data)
        print(f"    {name!r}: {digests(data)},  # {len(data)} bytes")


if __name__ == "__main__":
    main()
