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
tests/test_torch_jpeg.py remakes the files and checks both.

The GIF fixtures of ``chip_smoke.py`` phase 18 (``gif_fixtures()``;
``chip_smoke.GIF_FIXTURES`` holds the sha256 of each file and of
Pillow's ``convert("RGBA")`` of it, checked by tests/test_torch_gif.py):

* ``gif_rgb_interlaced.gif``: Pillow's GIF of 96x128 RGB levels, seed
  21 (median cut, interlaced);
* ``gif_rgba_trns.gif``: Pillow's GIF of the same levels with a seeded
  alpha of 0 and 255 (octree, a transparency index, GIF89a);
* ``gif_gray.gif``: Pillow's GIF of their ``L`` conversion;
* ``gif_local_offset.gif``, ``gif_code2.gif``, ``gif_deferred_clear.gif``:
  written by :func:`make_gif`: a 40x24 frame at (7, 5) of a 64x40 screen
  with a local palette and a transparency index; a 4-colour palette at
  minimum code size 2; 128x96 indices of 256 colours whose code table
  fills and is kept, without a clear code, to the end (as gifsicle
  writes).

To remake them after a change of the images (and then update those
digests), run from the root of a checkout::

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


def lzw_codes(pixels: bytes, min_code: int, defer: bool = False, clear_every: int = 0,
              end: bool = True, stop_at: int | None = None) -> list[tuple[int, int]]:
    """(code, width) of a greedy GIF LZW coding of ``pixels``: a clear code
    first, widths growing with the table, then either a clear code when
    the table is full or (``defer``) the full table kept to the end; a
    clear code after every ``clear_every`` codes; the end code, or none;
    ``stop_at``: the end code after the string that reaches that many
    pixels."""
    clear = 1 << min_code

    def reset():
        return {bytes([i]): i for i in range(min(clear, 256))}, clear + 2, min_code + 1

    table, nxt, width = reset()
    out, i, n, emitted = [(clear, width)], 0, len(pixels), 0
    while i < n and (stop_at is None or i < stop_at):
        s, j = pixels[i:i + 1], i + 1
        while j < n and pixels[i:j + 1] in table:
            s, j = pixels[i:j + 1], j + 1
        out.append((table[s], width))
        emitted += 1
        if j < n and nxt < 4096:
            table[pixels[i:j + 1]] = nxt
            nxt += 1
        i = j
        if nxt > 1 << width and width < 12:
            width += 1
        if i < n and ((not defer and nxt == 4096)
                      or (clear_every and emitted % clear_every == 0)):
            out.append((clear, width))
            table, nxt, width = reset()
    if end:
        out.append((clear + 1, width))
    return out


def pack_codes(codes) -> bytes:
    """GIF's bit order: each code's low bits first."""
    acc = nbits = 0
    out = bytearray()
    for code, width in codes:
        acc |= code << nbits
        nbits += width
        while nbits >= 8:
            out.append(acc & 255)
            acc >>= 8
            nbits -= 8
    if nbits:
        out.append(acc & 255)
    return bytes(out)


def sub_blocks(data: bytes, size: int = 255) -> bytes:
    """``data`` in sub-blocks of ``size`` bytes and the empty terminator."""
    return b"".join(bytes([len(data[i:i + size])]) + data[i:i + size]
                    for i in range(0, len(data), size)) + b"\0"


def interlace_order(h: int) -> list[int]:
    return [*range(0, h, 8), *range(4, h, 8), *range(2, h, 4), *range(1, h, 2)]


def _table(palette) -> tuple[bytes, int]:
    p = bytes(np.asarray(palette, np.uint8).ravel())
    bits = max(1, (len(p) // 3 - 1).bit_length())
    return p.ljust(3 << bits, b"\0"), bits - 1


def make_gif(idx, palette=None, local=None, min_code=8, interlace=False, screen=None,
             offset=(0, 0), trns=None, version=b"89a", extensions=b"", **lzw) -> bytes:
    """A one-frame GIF of the indices ``idx`` [h, w] written by hand: an
    optional global and local palette (padded to a power of two), a
    Graphic Control Extension with ``trns``, ``extensions`` before it, the
    frame at ``offset`` of a ``screen`` (w, h), interlaced or not, LZW
    codes of :func:`lzw_codes` (``lzw``: its options)."""
    idx = np.asarray(idx, np.uint8)
    h, w = idx.shape
    sw, sh = screen or (w, h)
    out = b"GIF" + version + struct.pack("<HH", sw, sh)
    if palette is not None:
        table, size = _table(palette)
        out += bytes([0x80 | size, 0, 0]) + table
    else:
        out += b"\0\0\0"
    out += extensions
    if trns is not None:
        out += b"!\xf9\x04\x01\x00\x00" + bytes([trns]) + b"\0"
    flags, table = 0x40 if interlace else 0, b""
    if local is not None:
        table, size = _table(local)
        flags |= 0x80 | size
    out += b"," + struct.pack("<HHHHB", *offset, w, h, flags) + table
    rows = interlace_order(h) if interlace else range(h)
    pixels = b"".join(idx[r].tobytes() for r in rows)
    return out + bytes([min_code]) + sub_blocks(pack_codes(lzw_codes(pixels, min_code,
                                                                       **lzw))) + b";"


def gif_fixtures() -> dict[str, bytes]:
    """Each GIF fixture's name and its bytes (Pillow's or :func:`make_gif`'s)."""
    rgb = levels((96, 128), 21)
    alpha = np.where(np.random.default_rng(21).random((96, 128)) < 0.25, 0, 255)
    rgba = np.dstack([rgb, alpha.astype(np.uint8)])
    rng = np.random.default_rng(22)
    palette = rng.integers(0, 256, (256, 3))
    y, x = np.mgrid[0:24, 0:40]
    return {
        "gif_rgb_interlaced.gif": _save(Image.fromarray(rgb), "GIF"),
        "gif_rgba_trns.gif": _save(Image.fromarray(rgba), "GIF"),
        "gif_gray.gif": _save(Image.fromarray(rgb).convert("L"), "GIF"),
        "gif_local_offset.gif": make_gif((x // 3 + y // 2) % 32, palette[:64], local=palette[64:96],
                                         screen=(64, 40), offset=(7, 5), trns=3),
        "gif_code2.gif": make_gif(rng.integers(0, 4, (30, 50)) * (rng.random((30, 50)) < 0.7),
                                  palette[:4], min_code=2, interlace=True),
        "gif_deferred_clear.gif": make_gif(rng.integers(0, 256, (96, 128)), palette, defer=True),
    }


def gif_digests(data: bytes) -> tuple[str, str]:
    """sha256 of a GIF file and of Pillow's ``convert("RGBA")`` of it."""
    pixels = np.ascontiguousarray(np.asarray(Image.open(io.BytesIO(data)).convert("RGBA")))
    return hashlib.sha256(data).hexdigest(), hashlib.sha256(pixels.tobytes()).hexdigest()


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
    for made, digest in ((fixtures(), digests), (gif_fixtures(), gif_digests)):
        for name, data in made.items():
            (GOLDENS / name).write_bytes(data)
            print(f"    {name!r}: {digest(data)},  # {len(data)} bytes")


if __name__ == "__main__":
    main()
