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

The CMYK JPEG fixtures of ``chip_smoke.py`` phase 19
(``cmyk_fixtures()``; ``chip_smoke.CMYK_FIXTURES`` holds the sha256 of
each file and of Pillow's ``convert("RGB")`` of it, checked by
tests/test_torch_jpeg.py): ``cmyk_prog_4k.jpg`` (the 4K levels above made
CMYK by :func:`cmyk_levels`, progressive), ``cmyk_rst.jpg`` (320x200,
seed 24, restart markers every 5 MCUs), ``cmyk_ycck.jpg`` (that file with
its Adobe transform set to 2) and ``cmyk_no_adobe.jpg`` (without its Adobe
marker).

The TIFF writer :func:`make_tiff` (its own LZW and PackBits encoders and
zlib; strips or tiles, chunky or planar, predictors 2 and 3, either fill
order, the sample formats of ``MODES``) needs no Pillow: the tests and
``chip_smoke.py`` phases 17 and 19 (which load this file by its path on
the card's machine) write their TIFFs with it, phase 19's small ones
through :func:`layout_tiffs`.

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
import zlib
from pathlib import Path

import numpy as np

GOLDENS = Path(__file__).resolve().parent / "goldens"


def levels(hw, seed, noise=0.1) -> np.ndarray:
    """The 8-bit RGB levels ``write_image`` makes of the seeded pixels."""
    import chip_smoke  # noqa: PLC0415

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


# ---- a TIFF writer with its own LZW and PackBits encoders (no Pillow) --------


def lzw_encode(data: bytes) -> bytes:
    """TIFF's LZW as libtiff's tif_lzw.c writes it: MSB-first codes, a
    ClearCode first, the width one code early, a ClearCode when the
    table reaches 4094, EOI last."""
    bits, nbits = [], 9
    table = {bytes([i]): i for i in range(256)}
    free = 258

    def put(code):
        bits.append(format(code, f"0{nbits}b"))

    def grow():
        nonlocal free, nbits, table
        free += 1
        if free == 4094:
            put(256)
            table = {bytes([i]): i for i in range(256)}
            free, nbits = 258, 9
        elif free > (1 << nbits) - 1:
            nbits += 1

    put(256)
    w = b""
    for b in data:
        wb = w + bytes([b])
        if wb in table:
            w = wb
            continue
        put(table[w])
        table[wb] = free
        grow()
        w = bytes([b])
    if w:
        put(table[w])
        grow()
    put(257)
    s = "".join(bits)
    s += "0" * (-len(s) % 8)
    return bytes(int(s[i:i + 8], 2) for i in range(0, len(s), 8))


def packbits_encode(data: bytes) -> bytes:
    """PackBits: repeats of 2 to 128 bytes, literals of up to 128, and a
    no-op header (-128) in front."""
    out, i, n = bytearray([0x80]), 0, len(data)
    while i < n:
        j = i + 1
        while j < n and j - i < 128 and data[j] == data[i]:
            j += 1
        if j - i >= 2:
            out += bytes([257 - (j - i), data[i]])
            i = j
            continue
        k = i + 1
        while k < n and k - i < 128 and not (k + 1 < n and data[k] == data[k + 1]):
            k += 1
        out += bytes([k - i - 1]) + data[i:k]
        i = k
    return bytes(out)


# (photometric, bits, samples per pixel, ExtraSamples, SampleFormat) of
# each mode make_tiff writes, by a name close to Pillow's rawmode
MODES = {
    "1": (1, 1, 1, (), 1), "1 inverted": (0, 1, 1, (), 1),
    "L;2": (1, 2, 1, (), 1), "L;2 inverted": (0, 2, 1, (), 1),
    "L;4": (1, 4, 1, (), 1), "L;4 inverted": (0, 4, 1, (), 1),
    "L": (1, 8, 1, (), 1), "L inverted": (0, 8, 1, (), 1), "L signed": (1, 8, 1, (), 2),
    "I;12": (1, 12, 1, (), 1), "I;16": (1, 16, 1, (), 1), "I;16 photometric 0": (0, 16, 1, (), 1),
    "I;16S": (1, 16, 1, (), 2), "I;32N": (1, 32, 1, (), 1), "I;32S": (1, 32, 1, (), 2),
    "F": (1, 32, 1, (), 3), "F photometric 0": (0, 32, 1, (), 3),
    "LA": (1, 8, 2, (2,), 1),
    "P;1": (3, 1, 1, (), 1), "P;2": (3, 2, 1, (), 1), "P;4": (3, 4, 1, (), 1),
    "P": (3, 8, 1, (), 1), "PX": (3, 8, 2, (0,), 1), "PA": (3, 8, 2, (2,), 1),
    "RGB": (2, 8, 3, (), 1), "RGBA no ExtraSamples": (2, 8, 4, (), 1),
    "RGBA": (2, 8, 4, (2,), 1), "RGBa": (2, 8, 4, (1,), 1), "RGBX": (2, 8, 4, (0,), 1),
    "RGBXX": (2, 8, 5, (0, 0), 1), "RGBXXX": (2, 8, 6, (0, 0, 0), 1),
    "RGBaX": (2, 8, 5, (1, 0), 1), "RGBaXX": (2, 8, 6, (1, 0, 0), 1),
    "RGBAX": (2, 8, 5, (2, 0), 1), "RGBAXX": (2, 8, 6, (2, 0, 0), 1),
    "RGBA 999": (2, 8, 4, (999,), 1),
    "RGB;16": (2, 16, 3, (), 1), "RGBA;16": (2, 16, 4, (2,), 1), "RGBa;16": (2, 16, 4, (1,), 1),
    "RGBX;16": (2, 16, 4, (0,), 1), "RGBA;16 no ExtraSamples": (2, 16, 4, (), 1),
    "CMYK": (5, 8, 4, (), 1), "CMYKX": (5, 8, 5, (0,), 1), "CMYKXX": (5, 8, 6, (0, 0), 1),
    "CMYK;16": (5, 16, 4, (), 1),
    "YCbCr": (6, 8, 3, (), 1), "LAB": (8, 8, 3, (), 1),
}
COMPRESS = {1: lambda b: b, 5: lzw_encode, 8: lambda b: zlib.compress(b, 1),
            32946: lambda b: zlib.compress(b, 1), 32773: packbits_encode}
_PREDICTED = (5, 8, 32946)
_BITREV = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)], np.uint8)


def _row_bytes(block: np.ndarray, bits: int, bo: str, predictor: int) -> list[bytes]:
    """Each row of a block [bh, bw, c] of samples as stored: packed MSB
    first below 8 bits and at 12, in byte order ``bo`` at 16 and 32 bits,
    after the horizontal (2) or floating-point (3) predictor's
    differencing, whose stride is c."""
    bh, bw, c = block.shape
    if bits % 8:
        v = block.astype(np.uint32).reshape(bh, bw * c)
        planes = (v[..., None] >> np.arange(bits - 1, -1, -1)) & 1
        return [r.tobytes() for r in np.packbits(planes.reshape(bh, -1).astype(np.uint8), axis=1)]
    u = np.ascontiguousarray(block).view(f"u{bits // 8}").reshape(bh, bw * c)
    if predictor == 2:       # differences modulo 2^bits, in the unsigned type
        u = u.copy()
        u[:, c:] = block.reshape(bh, bw * c).view(u.dtype)[:, c:] - u[:, :-c]
    if predictor == 3:       # libtiff's fpDiff: byte planes, most significant first
        be = u.astype(f">u{bits // 8}").view(np.uint8).reshape(bh, bw * c, bits // 8)
        p = np.ascontiguousarray(be.transpose(0, 2, 1)).reshape(bh, -1)
        p[:, c:] = p[:, c:] - p[:, :-c].copy()
        return [r.tobytes() for r in p]
    return [r.tobytes() for r in u.astype(f"{bo}u{bits // 8}")]


def make_tiff(samples, mode, bo="<", compression=1, predictor=1, rows_per_strip=None,
              cmap=None, extra_tags=(), tile=None, planar=False, fill_order=1) -> bytes:
    """A TIFF of samples [h, w, spp] (uint8 or uint16 below 17 bits, the
    int or float type of the sample format at 16 and 32) in byte order
    ``bo`` ('<' II, '>' MM): in strips of ``rows_per_strip`` rows (the last
    one short), or in tiles of ``tile`` = (height, width) whose parts past
    the image are filled with a seeded junk; chunky, or planar
    (PlanarConfiguration 2: the strips or tiles of each sample in turn);
    compressed as asked (``COMPRESS``), with the horizontal (2) or
    floating-point (3) predictor under LZW and deflate; ``fill_order`` 2
    with the bits of every stored byte reversed (after compression, as
    libtiff reverses them before it decompresses)."""
    photo, bits, spp, extra, fmt = MODES[mode]
    h, w, _ = samples.shape
    planes = [samples[..., k:k + 1] for k in range(spp)] if planar else [samples]
    if compression not in _PREDICTED:
        predictor_used = 1
    else:
        predictor_used = predictor
    if tile:
        th, tw = tile
        grid = [(y, x) for y in range(0, h, th) for x in range(0, w, tw)]
        junk = np.random.default_rng(99).integers(0, 1 << min(bits, 16), (-(-h // th) * th,
                                                                         -(-w // tw) * tw, 1))
    else:
        th, tw = min(rows_per_strip or h, h), w
        grid = [(y, 0) for y in range(0, h, th)]
    blocks = []
    for plane in planes:
        c = plane.shape[2]
        if tile:
            full = np.empty((junk.shape[0], junk.shape[1], c), plane.dtype)
            full[...] = junk.astype(plane.dtype)
            full[:h, :w] = plane
        else:
            full = plane
        for y, x in grid:
            rows = _row_bytes(full[y:y + th, x:x + tw], bits, bo, predictor_used)
            blk = COMPRESS[compression](b"".join(rows))
            if fill_order == 2:
                blk = _BITREV[np.frombuffer(blk, np.uint8)].tobytes()
            blocks.append(blk)
    offsets, pos = [], 8
    for blk in blocks:
        offsets.append(pos)
        pos += len(blk)
    tags = {256: (4, [w]), 257: (4, [h]), 258: (3, [bits] * spp), 259: (3, [compression]),
            262: (3, [photo]), 277: (3, [spp]), 284: (3, [2 if planar else 1])}
    if tile:
        tags.update({322: (3, [tw]), 323: (3, [th]), 324: (4, offsets),
                     325: (4, [len(b) for b in blocks])})
    else:
        tags.update({273: (4, offsets), 278: (4, [th]), 279: (4, [len(b) for b in blocks])})
    if predictor != 1:
        tags[317] = (3, [predictor])
    if extra:
        tags[338] = (3, list(extra))
    if fmt != 1:
        tags[339] = (3, [fmt] * spp)
    if fill_order != 1:
        tags[266] = (3, [fill_order])
    if cmap is not None:
        tags[320] = (3, list(cmap))
    tags.update(extra_tags)
    body = b"".join(blocks)
    body += b"\0" * (pos % 2)
    pos += pos % 2
    entries, data_at = [], pos
    out_of_line = bytearray()
    ifd_at = data_at
    for tag, (typ, vals) in sorted(tags.items()):
        raw = struct.pack(bo + {3: "H", 4: "I"}[typ] * len(vals), *vals)
        entries.append((tag, typ, len(vals), raw))
        if len(raw) > 4:
            ifd_at += len(raw) + len(raw) % 2
    ifd = struct.pack(bo + "H", len(entries))
    at = data_at
    for tag, typ, n, raw in entries:
        if len(raw) > 4:
            ifd += struct.pack(bo + "HHII", tag, typ, n, at)
            out_of_line += raw + b"\0" * (len(raw) % 2)
            at += len(raw) + len(raw) % 2
        else:
            ifd += struct.pack(bo + "HHI", tag, typ, n) + raw.ljust(4, b"\0")
    head = (b"II*\0" if bo == "<" else b"MM\0*") + struct.pack(bo + "I", ifd_at)
    return head + body + bytes(out_of_line) + ifd + b"\0\0\0\0"


def tiff_samples(mode, h, w, seed) -> np.ndarray:
    """Seeded samples [h, w, spp] of a mode of ``MODES``: smooth (so
    predictor 2 and LZW have something to find) plus noise; premultiplied
    colour never above its alpha, as a writer of associated alpha stores
    it; 32-bit integers and floats past 0 and 65535 (and 255), with NaN
    and infinities."""
    photo, bits, spp, extra, fmt = MODES[mode]
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = (0.5 + 0.4 * np.sin(x[..., None] / 3.0 + y[..., None] / 5.0 + np.arange(spp)))
    if fmt == 3:
        v = (base * 400 - 60 + rng.normal(0, 20, (h, w, spp))).astype(np.float32)
        v.flat[:4] = [np.nan, np.inf, -np.inf, 254.999]
        return v
    if bits == 32:
        lo, hi = (-90000, 150000) if fmt == 2 else (0, 3 << 30)
        return (lo + base * (hi - lo) + rng.normal(0, 999, (h, w, spp))).astype(
            np.int64).astype(np.int32 if fmt == 2 else np.uint32)
    top = (1 << bits) - 1
    v = np.clip(base * top + rng.normal(0, top / 20, (h, w, spp)), 0, top).astype(np.int64)
    if bits == 1:
        return (v > 0).astype(np.uint8)
    if extra[:1] == (1,):
        v[..., :3] = v[..., :3] * v[..., 3:4] // top
    if fmt == 2:
        return (v - (top + 1) // 2).astype(np.int16 if bits == 16 else np.int8)
    return v.astype(np.uint16 if bits > 8 else np.uint8)


def palette(seed, bits=8) -> np.ndarray:
    """A seeded TIFF colormap of 3 * 2^bits 16-bit values."""
    return np.random.default_rng(seed).integers(0, 65536, 3 << bits)


# the small TIFFs of chip_smoke.py phase 19(a): name -> (mode, make_tiff's
# keywords); 45x67 samples of tiff_samples(mode, 45, 67, seed 31)
LAYOUT_TIFFS = {
    "tiled LZW RGB predictor 2": ("RGB", dict(compression=5, predictor=2, tile=(32, 16))),
    "planar deflate RGBA;16": ("RGBA;16", dict(compression=8, planar=True, rows_per_strip=8)),
    "FillOrder 2 1 raw": ("1", dict(fill_order=2, rows_per_strip=16)),
    "FillOrder 2 1 LZW": ("1", dict(compression=5, fill_order=2, rows_per_strip=16)),
    "FillOrder 2 L raw": ("L", dict(fill_order=2, rows_per_strip=16)),
    "FillOrder 2 L LZW": ("L", dict(compression=5, fill_order=2, rows_per_strip=16)),
    "predictor 3 deflate F": ("F", dict(compression=8, predictor=3, rows_per_strip=8)),
    "CMYK raw": ("CMYK", dict(rows_per_strip=10)),
    "CMYK;16 LZW big-endian": ("CMYK;16", dict(bo=">", compression=5, rows_per_strip=10)),
    "I;32S deflate": ("I;32S", dict(compression=8, rows_per_strip=12)),
    "4-bit palette PackBits": ("P;4", dict(compression=32773, rows_per_strip=12)),
    "PA LZW": ("PA", dict(compression=5, rows_per_strip=12)),
    "Orientation 6 RGB": ("RGB", dict(compression=8, extra_tags={274: (3, [6])})),
    "Orientation 8 RGB tiled": ("RGB", dict(compression=5, tile=(16, 16),
                                            extra_tags={274: (3, [8])})),
}


def layout_tiffs() -> dict[str, bytes]:
    """Each of ``LAYOUT_TIFFS`` written by :func:`make_tiff` (no Pillow)."""
    out = {}
    for name, (mode, kw) in LAYOUT_TIFFS.items():
        bits = MODES[mode][1]
        out[name] = make_tiff(tiff_samples(mode, 45, 67, 31), mode,
                              cmap=palette(31, bits) if mode.startswith("P") else None, **kw)
    return out


def cmyk_levels(rgb: np.ndarray) -> np.ndarray:
    """A fixed CMYK of 8-bit RGB levels: K half the darkness, C, M, Y the
    rest of each channel's."""
    k = (255 - rgb.max(axis=-1, keepdims=True).astype(np.int32)) // 2
    return np.concatenate([255 - rgb.astype(np.int32) - k, k], -1).astype(np.uint8)


def rgba_digest(pixels: np.ndarray) -> str:
    """sha256 of ``read_image(..., channels="RGBA")`` float64 pixels."""
    return hashlib.sha256(np.ascontiguousarray(pixels, np.float64).tobytes()).hexdigest()


def fixtures() -> dict[str, bytes]:
    """Each fixture's name and Pillow's bytes of it."""
    from PIL import Image  # noqa: PLC0415
    import chip_smoke  # noqa: PLC0415

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


def set_adobe_transform(data: bytes, transform: int) -> bytes:
    """A JPEG with its Adobe marker's transform byte set."""
    out = bytearray(data)
    at = data.index(b"\xff\xee")
    out[at + 15] = transform
    return bytes(out)


def without_adobe(data: bytes) -> bytes:
    at = data.index(b"\xff\xee")
    return data[:at] + data[at + 2 + struct.unpack_from(">H", data, at + 2)[0]:]


def cmyk_fixtures() -> dict[str, bytes]:
    """The CMYK JPEG fixtures of ``chip_smoke.py`` phase 19 and Pillow's
    bytes of each: the 4K levels of ``codec_prog_4k.jpg`` made CMYK by
    :func:`cmyk_levels`, progressive; 320x200 levels (seed 24) baseline
    with restart markers every 5 MCUs, that file with its Adobe transform
    set to 2 (YCCK), and without its Adobe marker (CMYK as stored)."""
    from PIL import Image  # noqa: PLC0415

    import chip_smoke  # noqa: PLC0415

    big = Image.fromarray(cmyk_levels(levels((chip_smoke.H, chip_smoke.W), 17, noise=0.02)),
                          "CMYK")
    small = _save(Image.fromarray(cmyk_levels(levels((200, 320), 24)), "CMYK"), "JPEG",
                  restart_marker_blocks=5)
    return {"cmyk_prog_4k.jpg": _save(big, "JPEG", progressive=True),
            "cmyk_rst.jpg": small,
            "cmyk_ycck.jpg": set_adobe_transform(small, 2),
            "cmyk_no_adobe.jpg": without_adobe(small)}


def cmyk_digests(data: bytes) -> tuple[str, str]:
    """sha256 of a JPEG file and of Pillow's ``convert("RGB")`` of it."""
    from PIL import Image  # noqa: PLC0415

    pixels = np.ascontiguousarray(np.asarray(Image.open(io.BytesIO(data)).convert("RGB")))
    return hashlib.sha256(data).hexdigest(), hashlib.sha256(pixels.tobytes()).hexdigest()


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
    from PIL import Image  # noqa: PLC0415

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
    from PIL import Image  # noqa: PLC0415

    pixels = np.ascontiguousarray(np.asarray(Image.open(io.BytesIO(data)).convert("RGBA")))
    return hashlib.sha256(data).hexdigest(), hashlib.sha256(pixels.tobytes()).hexdigest()


def digests(data: bytes) -> tuple[str, str]:
    """sha256 of a file and of Pillow's decode of it."""
    from PIL import Image  # noqa: PLC0415

    pixels = np.ascontiguousarray(np.asarray(Image.open(io.BytesIO(data))))
    return hashlib.sha256(data).hexdigest(), hashlib.sha256(pixels.tobytes()).hexdigest()


def rates(repeats: int = 5) -> None:
    """The port's decode of Pillow's 3840x2160 LZW (predictor 1 and 2),
    deflate and PackBits TIFFs of ``codec_prog_4k.jpg``'s levels, timed on
    this host (the best of ``repeats``), beside Pillow's (libtiff) decode
    of the same files: the LZW rate no chip run measures, since the card's
    machine has no Pillow to write a 4K LZW file."""
    import time

    from PIL import Image  # noqa: PLC0415

    import chip_smoke  # noqa: PLC0415
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
    for made, digest in ((fixtures(), digests), (gif_fixtures(), gif_digests),
                         (cmyk_fixtures(), cmyk_digests)):
        for name, data in made.items():
            (GOLDENS / name).write_bytes(data)
            print(f"    {name!r}: {digest(data)},  # {len(data)} bytes")


if __name__ == "__main__":
    main()
