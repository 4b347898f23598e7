"""The port's TGA, PCX, SGI, QOI, IM, ICO and DIB codecs and its MPO
write (``dspfun_tpu_torch/io/rawimg.py``, ``io/ico.py``,
``io/imgcodecs.py``, ``native/rawimg.cpp``; ROADMAP queue 1, item 8h)
against the JAX package, which reads and writes them through Pillow 12.1.

* Reads: Pillow's files and files made by hand (every TGA image type and
  depth of Pillow's table, both orientations and the flip, 16- and 24-bit
  colour maps from a nonzero first index, RLE packets across rows; PCX
  1-bit, 2- and 4-plane, gray, palette and RGB at odd strides; raw and
  RLE SGI at 1 and 2 bytes; QOI streams with index misses and leading
  runs; IM in each mode the port reads, with and without a ``Lut:``;
  DIB and BMP of 1 to 32 bits, bit fields and RLE; ICO with PNG and BMP
  entries) read through both packages' ``read_image`` as RGB, RGBA and I,
  with cv2 importable and blocked: the same pixels and depth, or an error
  in both.  Seeded truncated and damaged files raise in both or read to
  the same pixels.
* Identification: the format the port picks is ``Image.open``'s on the
  fixtures and on seeded TGA headers, the ones PCX claims first included.
* Writes: RGB, RGBA and 16-bit gray to each format, to a path (the output
  name inside SGI and IM files included) and to ``-``: the same bytes as
  the JAX package, or an error in both and no file.
* ICO write: the LANCZOS thumbnails equal Pillow's at sizes that take
  every rule of ``thumbnail``, RGBA and 16-bit gray included.
* ``chip_smoke.OTHER_FIXTURES`` (phase 22) holds Pillow's files and the
  JAX package's pixels; ``OTHER_4K_DIGESTS`` Pillow's 4K writes.
"""

import io
import struct
import sys
import zlib

import numpy as np
import pytest
from PIL import Image

import chip_smoke
from dspfun_tpu.io import images as jimages
from dspfun_tpu_torch.io import dds, ico, imgcodecs, psd, rawimg
from dspfun_tpu_torch.io import images as timages
from tests import torch_codec_fixtures as fx


def _read(mod, path, ch):
    try:
        return mod.read_image(str(path), channels=ch)
    except Exception as e:  # noqa: BLE001 — Pillow raises KeyError and others too
        return e


def _same_read(tmp_path, data, monkeypatch, name="in.bin"):
    """Both packages' reads as RGB, RGBA and I, with cv2 and without it:
    the same pixels and depth, or an error in both."""
    path = tmp_path / name
    path.write_bytes(data)
    jax = {ch: _read(jimages, path, ch) for ch in ("RGB", "RGBA", "I")}
    for blocked in (False, True):
        if blocked:
            monkeypatch.setitem(sys.modules, "cv2", None)
        for ch, j in jax.items():
            t = _read(timages, path, ch)
            if isinstance(j, Exception):
                assert isinstance(t, Exception), (ch, blocked, j)
                continue
            assert not isinstance(t, Exception), (ch, blocked, t, j.depth)
            assert t.depth == j.depth, (ch, t.depth, j.depth)
            np.testing.assert_array_equal(t.pixels, j.pixels)
    return jax


def _image(h, w, seed=0, c=3) -> np.ndarray:
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([128 + 100 * np.sin(x / 5), 128 + 90 * np.cos(y / 4),
                     128 + 50 * np.sin((x + y) / 6), 128 + 120 * np.sin(x * y / 50)], -1)
    out = np.clip(base[..., :c] + rng.normal(0, 20, (h, w, c)), 0, 255).astype(np.uint8)
    out[:, : w // 3] = out[:, :1]            # runs for the run-length codes
    return out


def _save(img, fmt, **kw) -> bytes:
    buf = io.BytesIO()
    img.save(buf, format=fmt, **kw)
    return buf.getvalue()


# ---- the goldens of phase 22 ---------------------------------------------------------

GOLDEN_NAMES = sorted(chip_smoke.OTHER_FIXTURES)
DECODERS = {"tga": rawimg.decode_tga, "pcx": rawimg.decode_pcx, "sgi": rawimg.decode_sgi,
            "qoi": rawimg.decode_qoi, "im": rawimg.decode_im, "ico": ico.decode_ico,
            "dib": imgcodecs.decode_dib}


def test_phase_22_goldens_are_pillows():
    """``other_fixtures()`` remakes each golden file byte for byte, and
    ``chip_smoke.OTHER_FIXTURES`` holds its sha256 and that of the JAX
    package's RGBA read of it."""
    made = fx.other_fixtures()
    assert sorted(made) == GOLDEN_NAMES
    for name, data in made.items():
        assert (fx.GOLDENS / name).read_bytes() == data, name
        assert fx.other_digests(data) == chip_smoke.OTHER_FIXTURES[name], name
    assert sum(len(d) for d in made.values()) < 300_000


@pytest.mark.parametrize("name", GOLDEN_NAMES)
def test_goldens_read_as_the_jax_package_reads_them(name, tmp_path, monkeypatch):
    data = (fx.GOLDENS / name).read_bytes()
    assert timages._decoder(data) is DECODERS[name.rsplit(".", 1)[1]]
    jax = _same_read(tmp_path, data, monkeypatch)
    assert not any(isinstance(j, Exception) for j in jax.values())


# ---- files made by hand ----------------------------------------------------------------

def _tga_cases() -> dict:
    rgb = _image(13, 11, 1)
    rgba = _image(13, 11, 2, 4)
    gray = rgb[..., 1]
    idx = (rgb[..., 0] // 32).astype(np.uint8)
    pal = np.random.default_rng(3).integers(0, 256, (40, 4), dtype=np.uint8)
    v16 = rgb[..., 0].astype(np.uint16) * 257 ^ rgb[..., 2].astype(np.uint16)
    px16 = np.dstack([(v16 & 255).astype(np.uint8), (v16 >> 8).astype(np.uint8)])
    out = {}
    for orient in (0x00, 0x10, 0x20, 0x30):
        out[f"bgr orient {orient:#x}"] = fx.make_tga(rgb[..., ::-1], 2, 24, orient=orient)
        out[f"bgra rle orient {orient:#x}"] = fx.make_tga(rgba[..., [2, 1, 0, 3]], 10, 32,
                                                          orient=orient)
    out["16-bit rle"] = fx.make_tga(px16, 10, 16)
    out["gray"] = fx.make_tga(gray[..., None], 3, 8)
    out["gray + alpha rle"] = fx.make_tga(np.dstack([gray, rgba[..., 3]]), 11, 16, orient=0x20)
    out["1-bit"] = fx.make_tga((gray[..., None] > 100).astype(np.uint8), 3, 1, orient=0x20)
    out["1-bit rle"] = fx.make_tga((gray[..., None] > 100).astype(np.uint8), 11, 1)
    for first in (0, 7):
        out[f"24-bit map from {first}"] = fx.make_tga(
            idx[..., None] + first, 1, 8, cmap=(first, 24, pal[:8, :3].tobytes()))
        out[f"16-bit map from {first} rle"] = fx.make_tga(
            idx[..., None] + first, 9, 8, cmap=(first, 16, px16[0, :8].tobytes()))
    out["indices past the map"] = fx.make_tga(idx[..., None] * 5, 1, 8,
                                              cmap=(0, 24, pal[:4, :3].tobytes()))
    out["32-bit map"] = fx.make_tga(idx[..., None], 1, 8, cmap=(0, 32, pal[:8].tobytes()))
    out["a map on an RGB image"] = fx.make_tga(rgb[..., ::-1], 2, 24,
                                               cmap=(0, 24, pal[:4, :3].tobytes()))
    out["indices without a map (gray)"] = fx.make_tga(idx[..., None], 1, 8)
    out["ID section, no footer"] = fx.make_tga(rgb[..., ::-1], 2, 24, ident=b"x" * 200,
                                               footer=False)
    out["24-bit gray type"] = fx.make_tga(rgb[..., ::-1], 3, 24)
    out["8-bit RGB type"] = fx.make_tga(gray[..., None], 2, 8)
    out["16-bit indices"] = fx.make_tga(px16, 1, 16, cmap=(0, 24, pal[:4, :3].tobytes()))
    # packets by hand: a literal packet running into the next rows, a run
    # packet crossing a row (Pillow refuses it)
    head = struct.pack("<BBBHHBHHHHBB", 0, 0, 10, 0, 0, 0, 0, 0, 3, 4, 8 * 3, 0x20)
    lit = bytes([0x7F & 11]) + bytes(range(36))
    out["literal across rows"] = head[:2] + bytes([10]) + head[3:16] + bytes([24, 0x20]) + lit
    out["run across a row"] = head + bytes([0x80 | 4, 1, 2, 3]) + bytes([0x80 | 6, 4, 5, 6])
    return out


def _pcx_cases() -> dict:
    rgb = _image(9, 13, 4)
    gray = rgb[..., 0]
    idx = (rgb[..., 1] // 16).astype(np.uint8)
    pal = np.random.default_rng(5).integers(0, 256, (16, 3), dtype=np.uint8).tobytes()
    out = {
        "rgb odd width": _save(Image.fromarray(rgb), "PCX"),
        "rgb width 1": _save(Image.fromarray(rgb[:, :1].copy()), "PCX"),
        "rgb width 2": _save(Image.fromarray(rgb[:, :2].copy()), "PCX"),
        "gray": _save(Image.fromarray(_image(40, 30, 6)[..., 0]), "PCX"),
        "gray under 769 bytes": _save(Image.fromarray(gray[:3, :3].copy()), "PCX"),
        "1-bit": _save(Image.fromarray(gray > 90), "PCX"),
        "4 planes": fx.make_pcx_planes(idx, 4, pal),
        "2 planes": fx.make_pcx_planes(idx % 4, 2, pal),
        "4 planes odd stride": fx.make_pcx_planes(idx, 4, pal, stride=3),
        "4 planes stored stride": fx.make_pcx_planes(idx[:, :12], 4, pal, stride=2),
    }
    rgb3 = bytearray(_save(Image.fromarray(rgb[:, :3].copy()), "PCX"))
    rgb3[66:68] = struct.pack("<H", 3)          # the stride as stored: trusted, unpadded
    out["rgb stored odd stride"] = bytes(rgb3)
    for name, at, value in (("version 2 at 8 bits", 1, 2), ("2 bits a plane", 3, 2),
                            ("bad size", 8, 0)):
        d = bytearray(out["rgb odd width"])
        d[at] = value
        if name == "bad size":
            d[4:6] = struct.pack("<H", 9)
        out[name] = bytes(d)
    return out


def _sgi_cases() -> dict:
    rgb = _image(7, 9, 7)
    rgba = _image(7, 9, 8, 4)
    out = {
        "rle gray": fx.make_sgi(rgb[..., :1]),
        "rle gray bpc 2": fx.make_sgi(rgb[..., :1].astype(np.uint16) * 300, bpc=2),
        "rle rgb bpc 2": fx.make_sgi(rgb.astype(np.uint16) * 251, bpc=2),
        "rle rgba": fx.make_sgi(rgba),
        "raw rgba bpc 2": fx.make_sgi(rgba.astype(np.uint16) * 257, bpc=2, rle=False),
        "raw gray dimension 1": fx.make_sgi(rgb[:1, :, :1], rle=False),
    }
    d = bytearray(out["rle gray"])
    d[4:6] = struct.pack(">H", 1)
    out["rle gray dimension 1"] = bytes(d)
    d = bytearray(out["rle rgba"])
    d[2] = 2
    out["compression 2"] = bytes(d)
    d = bytearray(out["rle rgba"])
    d[10:12] = struct.pack(">H", 2)
    out["2 channels"] = bytes(d)
    d = bytearray(out["rle gray"])
    d[-1] = 5                                   # the last row ends on a nonzero count
    out["rle last count nonzero"] = bytes(d)
    return out


def _qoi(w, h, channels, chunks: bytes) -> bytes:
    return b"qoif" + struct.pack(">IIBB", w, h, channels, 0) + chunks + bytes(7) + b"\1"


def _qoi_cases() -> dict:
    rgba = _image(9, 7, 9, 4)
    return {
        "rgb": _save(Image.fromarray(_image(9, 7, 10)), "QOI"),
        "rgba": _save(Image.fromarray(rgba), "QOI"),
        "leading run, index miss": _qoi(4, 2, 4, bytes([0xC1, 0x05, 0xFE, 9, 8, 7, 0x2A,
                                                        0xFF, 1, 2, 3, 4, 0xC2])),
        "rgba op in an rgb file": _qoi(3, 1, 3, bytes([0xFF, 1, 2, 3, 4, 0x55, 0x8F, 0x88])),
        "channels byte 5": _qoi(2, 1, 5, bytes([0xFE, 1, 2, 3, 0xC0])),
        "run past the end": _qoi(2, 2, 3, bytes([0xFE, 1, 2, 3, 0xFD])),
        "luma and diff": _qoi(4, 1, 4, bytes([0xFE, 100, 100, 100, 0xA0, 0x3C, 0x6A, 0x40])),
    }


def _im(mode_line: bytes, w: int, h: int, body: bytes, lut: bytes | None = None,
        extra: bytes = b"") -> bytes:
    head = b"Image type: " + mode_line + b" image\r\n" + extra
    head += b"Image size (x*y): %d*%d\r\n" % (w, h)
    if lut is not None:
        head += b"Lut: 1\r\n"
    head = head + b"\0" * (511 - len(head)) + b"\x1a"
    return head + (lut or b"") + body


def _im_cases() -> dict:
    rgb = _image(5, 6, 11)
    rng = np.random.default_rng(12)
    raw = rng.integers(0, 256, 4 * 5 * 6 * 4, dtype=np.uint8).tobytes()
    color_lut = rng.integers(0, 256, 768, dtype=np.uint8).tobytes()
    gray_lut = bytes(255 - i for i in range(256)) * 3
    out = {m.decode(): _im(m, 6, 5, raw) for m in (
        b"0 1", b"L 1", b"B1", b"Greyscale", b"Grayscale", b"RGB", b"X 24", b"RGB3", b"RYB3",
        b"LA", b"RGBA", b"RGBX", b"CMYK", b"B2", b"B4", b"L 16", b"L 16L", b"L 16B",
        b"L 32S", b"L 32 S", b"RLB", b"PA")}
    out["L with a colour Lut"] = _im(b"Greyscale", 6, 5, raw, lut=color_lut)
    out["L with a gray Lut"] = _im(b"Greyscale", 6, 5, raw, lut=gray_lut)
    out["LA with a colour Lut"] = _im(b"LA", 6, 5, raw, lut=color_lut)
    out["B4 with a colour Lut"] = _im(b"B4", 6, 5, raw, lut=color_lut)
    out["RGB with a Lut"] = _im(b"RGB", 6, 5, raw, lut=color_lut)
    out["short Lut"] = _im(b"Greyscale", 6, 5, b"", lut=color_lut[:300])
    out["Pillow's RGBA"] = _save(Image.fromarray(_image(5, 6, 13, 4)), "IM")
    out["comments and a date"] = _im(b"RGB", 6, 5, raw, extra=b"Comment: one\r\nComment: two\n"
                                     b"Date: today\r\nOther key: x\r\n")
    out["truncated pixels"] = _im(b"RGB", 6, 5, raw[:50])
    d = bytearray(_im(b"RGB", 6, 5, raw))
    d[60] = 0                                   # the header ends on a zero byte
    out["header ends on 0"] = bytes(d)
    out["no size"] = b"Image type: RGB image\r\n\x1a" + raw
    out["size of one number"] = b"Image type: RGB image\r\nImage size (x*y): 5\r\n\x1a" + raw
    out["no 0x1a"] = b"Image type: RGB image\r\nImage size (x*y): 2*2\r\n"
    out["line of 101 bytes"] = b"Name: " + b"x" * 95 + b"\r\n" + _im(b"RGB", 6, 5, raw)
    out["not key: value"] = b"Image type RGB\n" + raw
    out["bad number"] = b"Image size (x*y): a*b\r\n\x1a" + raw
    return out


def _dib(w, h, bits, comp=0, colors=0, masks=None, hsize=40, palette=b"", body=b"",
         top_down=False) -> bytes:
    if hsize == 12:
        head = struct.pack("<IHHHH", 12, w, h, 1, bits)
    else:
        head = struct.pack("<IiiHHIIiiII", hsize, w, -h if top_down else h, 1, bits, comp,
                           len(body), 2835, 2835, colors, 0)
        if masks is not None and hsize >= 52:
            head += struct.pack(f"<{len(masks)}I", *masks)
        head = head.ljust(hsize, b"\0")
        if masks is not None and hsize == 40:
            head += struct.pack("<3I", *masks[:3])
    return head + palette + body


def _rows(px: np.ndarray, bits: int) -> bytes:
    """Bottom-up rows padded to 4 bytes."""
    h = px.shape[0]
    if bits < 8:
        flat = px.reshape(h, -1)
        bitsarr = ((flat[..., None] >> np.arange(bits - 1, -1, -1)) & 1).astype(np.uint8)
        rows = np.packbits(bitsarr.reshape(h, -1), axis=1)
    else:
        rows = px.reshape(h, -1)
    stride = (rows.shape[1] + 3) & ~3
    out = np.zeros((h, stride), np.uint8)
    out[:, :rows.shape[1]] = rows
    return out[::-1].tobytes()


def _rle8(idx: np.ndarray) -> bytes:
    out = bytearray()
    for row in idx[::-1]:
        i = 0
        while i < len(row):
            j = i
            while j < len(row) and row[j] == row[i] and j - i < 255:
                j += 1
            if j - i >= 2:
                out += bytes([j - i, row[i]])
                i = j
            else:
                k = min(len(row) - i, 4)
                if k >= 3:
                    out += bytes([0, k]) + bytes(row[i:i + k]) + (b"\0" if k % 2 else b"")
                    i += k
                else:
                    out += bytes([1, row[i]])
                    i += 1
        out += b"\0\0"
    return bytes(out + b"\0\1")


def _bmp_cases() -> dict:
    rng = np.random.default_rng(14)
    w, h = 7, 5
    idx = rng.integers(0, 16, (h, w), dtype=np.uint8)
    idx[1, :5] = 3
    pal4 = rng.integers(0, 256, (16, 4), dtype=np.uint8).tobytes()
    rgb = _image(h, w, 15)
    v = rng.integers(0, 65536, (h, w), dtype=np.uint16)
    px16 = np.dstack([(v & 255).astype(np.uint8), (v >> 8).astype(np.uint8)])
    bgra = _image(h, w, 16, 4)
    out = {
        "1-bit": _dib(w, h, 1, palette=pal4[:8], body=_rows(idx % 2, 1)),
        "4-bit": _dib(w, h, 4, palette=pal4, body=_rows(idx, 4)),
        "8-bit, 16 colours": _dib(w, h, 8, colors=16, palette=pal4, body=_rows(idx, 8)),
        "8-bit top-down": _dib(w, h, 8, colors=16, palette=pal4, body=_rows(idx[::-1], 8),
                               top_down=True),
        "16-bit 555": _dib(w, h, 16, body=_rows(px16, 16)),
        "16-bit 565 bitfields": _dib(w, h, 16, 3, masks=(0xF800, 0x7E0, 0x1F),
                                     body=_rows(px16, 16)),
        "16-bit 555 bitfields v4": _dib(w, h, 16, 3, masks=(0x7C00, 0x3E0, 0x1F, 0), hsize=108,
                                        body=_rows(px16, 16)),
        "24-bit": _dib(w, h, 24, body=_rows(rgb[..., ::-1], 24)),
        "24-bit bitfields": _dib(w, h, 24, 3, masks=(0xFF0000, 0xFF00, 0xFF),
                                 body=_rows(rgb[..., ::-1], 24)),
        "32-bit BGRX": _dib(w, h, 32, body=_rows(bgra, 32)),
        "32-bit BGRA bitfields": _dib(w, h, 32, 3, masks=(0xFF0000, 0xFF00, 0xFF, 0xFF000000),
                                      hsize=124, body=_rows(bgra, 32)),
        "32-bit odd bitfields": _dib(w, h, 32, 3, masks=(0xFF, 0xFF00, 0xFF0000, 0),
                                     hsize=56, body=_rows(bgra, 32)),
        "OS/2 header": _dib(w, h, 8, hsize=12, palette=bytes(768), body=_rows(idx, 8)),
        "RLE8": _dib(w, h, 8, 1, colors=16, palette=pal4, body=_rle8(idx)),
        "RLE8 cut short": _dib(w, h, 8, 1, colors=16, palette=pal4, body=_rle8(idx)[:20]),
        "RLE8 delta": _dib(w, h, 8, 1, colors=16, palette=pal4,
                           body=bytes([3, 9, 0, 2, 7, 7, 1, 1, 0, 0, 4, 2, 0, 1])),
        "RLE4": _dib(w, h, 4, 2, colors=16, palette=pal4,
                     body=bytes([5, 0x12, 0, 4, 0x34, 0x56, 0, 0] * h + [0, 1])),
        "RLE 3": _dib(w, h, 8, 3, colors=16, palette=pal4, body=_rows(idx, 8)),
        "compression 4": _dib(w, h, 24, 4, body=_rows(rgb, 24)),
        "2-bit": _dib(w, h, 2, palette=pal4[:16], body=_rows(idx % 4, 2)),
        "300 colours": _dib(w, h, 8, colors=300, palette=bytes(1200), body=_rows(idx, 8)),
        "truncated": _dib(w, h, 24, body=_rows(rgb, 24)[:40]),
    }
    return out


def _ico_file(entries) -> bytes:
    """An icon of (width byte, height byte, colours, bpp, payload)
    entries."""
    head = b"\0\0\1\0" + struct.pack("<H", len(entries))
    at = 6 + 16 * len(entries)
    dirs, body = b"", b""
    for w, h, ncol, bpp, payload in entries:
        dirs += struct.pack("<BBBBHHII", w, h, ncol, 0, 1, bpp, len(payload), at + len(body))
        body += payload
    return head + dirs + body


def _png(arr, **kw) -> bytes:
    return _save(Image.fromarray(arr), "PNG", **kw)


def _ico_cases() -> dict:
    rgb = _image(16, 16, 17)
    rgba = _image(16, 16, 18, 4)
    idx = (rgb[..., 0] // 16).astype(np.uint8)
    pal = np.random.default_rng(19).integers(0, 256, (16, 4), dtype=np.uint8).tobytes()
    mask = np.packbits(np.tile(np.arange(32) % 3 == 0, (16, 1)), axis=1)[::-1].tobytes()
    p = Image.fromarray(idx, "P")
    p.putpalette(np.frombuffer(pal, np.uint8).reshape(16, 4)[:, :3].tobytes())
    dib8 = _dib(16, 32, 4, palette=pal, body=_rows(idx, 4))
    dib32 = _dib(16, 32, 32, body=_rows(rgba, 32))
    p16 = (rgb[..., :3].astype(np.uint16) * 257)
    return {
        "png rgba": _ico_file([(16, 16, 0, 32, _png(rgba))]),
        "png palette with tRNS": _ico_file([(16, 16, 0, 32, _save(p, "PNG", transparency=3))]),
        "png rgb with tRNS": _ico_file([(16, 16, 0, 32, _png(rgb, transparency=tuple(rgb[0, 0])))]),
        "png 16-bit gray": _ico_file([(16, 16, 0, 32, _png(p16[..., 0]))]),
        "png 16-bit rgb": _ico_file([(16, 16, 0, 32, _png16(p16))]),
        "bmp 4-bit with its AND mask": _ico_file([(16, 16, 16, 4, dib8 + mask)]),
        "bmp 32-bit": _ico_file([(16, 16, 0, 32, dib32 + mask)]),
        "bmp 32-bit said 8": _ico_file([(16, 16, 0, 8, dib32 + mask)]),
        "depth order": _ico_file([(16, 16, 0, 32, dib32 + mask), (16, 16, 16, 4, dib8 + mask),
                                  (8, 8, 0, 32, _png(rgb[:8, :8]))]),
        "colour count as depth": _ico_file([(16, 16, 16, 0, dib8 + mask),
                                            (16, 16, 0, 32, dib32 + mask)]),
        "largest first": _ico_file([(8, 8, 0, 32, _png(rgb[:8, :8])),
                                    (16, 16, 0, 32, _png(rgba))]),
        "size byte 0": _ico_file([(0, 0, 0, 32, _png(_image(256, 256, 20)))]),
        "png not the directory's size": _ico_file([(8, 8, 0, 32, _png(rgb))]),
        "mask cut short": _ico_file([(16, 16, 16, 4, dib8 + mask[:10])]),
        "no entries": b"\0\0\1\0\0\0" + bytes(40),
        "entries past the end": b"\0\0\1\0\5\0" + bytes(30),
    }


def _png16(arr: np.ndarray) -> bytes:
    """A 16-bit RGB PNG (Pillow writes none)."""
    h, w, _ = arr.shape
    raw = b"".join(b"\0" + arr[r].astype(">u2").tobytes() for r in range(h))
    chunk = lambda t, d: (struct.pack(">I", len(d)) + t + d  # noqa: E731
                          + struct.pack(">I", zlib.crc32(t + d) & 0xFFFFFFFF))
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 16, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


def _cur_cases() -> dict:
    """Cursors of 1 to 32 bits; the largest entry by Pillow's rule (both
    sides larger than the one kept); a 32-bit bitmap whose alpha counts
    only at offset 22; top-down, RLE and bit-field bitmaps; offset 0; no
    entries; entries past the end; a height of one row (half of it 0)."""
    rgb = _image(11, 13, 23)
    rgba = _image(11, 13, 24, 4)
    pal = np.random.default_rng(25).integers(0, 256, (256, 3), dtype=np.uint8)
    idx = rgb[..., 0]
    d24 = fx.cursor_dib(rgb, 24, mask_seed=1)
    d32 = fx.cursor_dib(rgba, 32, mask_seed=2)
    small = fx.cursor_dib(rgb[:4, :5], 24, mask_seed=3)
    top_down = bytearray(d24)
    top_down[8:12] = struct.pack("<i", -22)
    rle8 = _dib(13, 22, 8, comp=1, colors=4,
                palette=np.hstack([pal[:4, ::-1], np.zeros((4, 1), np.uint8)]).tobytes(),
                body=b"".join(bytes([13, (2 * y) % 4, 0, 0]) for y in range(22)) + b"\0\1")
    bitfields = _dib(13, 22, 16, comp=3, masks=(0xF800, 0x7E0, 0x1F),
                     body=_rows(rgb[..., :2].repeat(2, 0), 16))
    one_row = fx.cursor_dib(rgb[:1, :5], 24, mask_seed=4)
    one_row = one_row[:8] + struct.pack("<i", 1) + one_row[12:]
    return {
        "1-bit": fx.make_cur([(13, 11, fx.cursor_dib(idx % 2, 1, pal[:2], 5))]),
        "4-bit": fx.make_cur([(13, 11, fx.cursor_dib(idx % 16, 4, pal[:16], 6))]),
        "8-bit": fx.make_cur([(13, 11, fx.cursor_dib(idx, 8, pal, 7))]),
        "24-bit": fx.make_cur([(13, 11, d24)]),
        "32-bit at offset 22": fx.make_cur([(13, 11, d32)]),
        "32-bit later": fx.make_cur([(4, 5, small), (13, 11, d32)]),
        "largest needs both sides": fx.make_cur([(13, 11, d24), (20, 11, small),
                                                 (5, 40, small), (14, 12, d32)]),
        "size byte 0": fx.make_cur([(0, 0, d24), (13, 11, small)]),
        "top-down": fx.make_cur([(13, 11, bytes(top_down))]),
        "rle8": fx.make_cur([(13, 11, rle8)]),
        "bit fields": fx.make_cur([(13, 11, bitfields)]),
        "offset 0": fx.make_cur([(13, 11, 0)]) + d24,
        "no entries": b"\0\0\2\0\0\0" + bytes(40),
        "entries past the end": b"\0\0\2\0\5\0" + bytes(30),
        "one row": fx.make_cur([(5, 1, one_row)]),
    }


def _dcx_cases() -> dict:
    """DCX files of Pillow's PCX pages: the first page read; a directory
    of one page at 1024 entries; an 8-bit gray page whose file ends in
    another page's palette; a first offset past the end; an empty
    directory; a directory cut short; a page that is not a PCX."""
    rgb = _image(9, 14, 26)
    gray = Image.fromarray(rgb[..., 1])
    pages = {"rgb": _save(Image.fromarray(rgb), "PCX"), "l": _save(gray, "PCX"),
             "p": _save(gray.convert("P", palette=Image.Palette.ADAPTIVE, colors=8), "PCX"),
             "1": _save(gray.convert("1"), "PCX")}

    def dcx(*names, offsets=None) -> bytes:
        at = 8 + 4 * len(names)
        if offsets is None:
            offsets = []
            for name in names:
                offsets.append(at)
                at += len(pages[name])
        return struct.pack(f"<I{len(offsets)}II", 0x3ADE68B1, *offsets, 0) \
            + b"".join(pages[name] for name in names)

    full = struct.pack("<I", 0x3ADE68B1) + struct.pack("<1024I", *([4100] * 1024))
    return {
        "rgb then l": dcx("rgb", "l"),
        "p": dcx("p", "rgb"),
        "1-bit": dcx("1"),
        "gray page, palette of the next": dcx("l", "p"),
        "1024 entries": full + pages["rgb"],
        "offset past the end": dcx("rgb", offsets=[9999]),
        "empty directory": struct.pack("<II", 0x3ADE68B1, 0) + pages["rgb"],
        "directory cut short": struct.pack("<III", 0x3ADE68B1, 12, 40),
        "not a pcx page": dcx("rgb")[:12] + b"\x0b" + dcx("rgb")[13:],
    }


CASES = {**{f"tga {k}": v for k, v in _tga_cases().items()},
         **{f"pcx {k}": v for k, v in _pcx_cases().items()},
         **{f"sgi {k}": v for k, v in _sgi_cases().items()},
         **{f"qoi {k}": v for k, v in _qoi_cases().items()},
         **{f"im {k}": v for k, v in _im_cases().items()},
         **{f"dib {k}": v for k, v in _bmp_cases().items()},
         **{f"bmp {k}": (lambda d: b"BM" + struct.pack("<IiI", len(d) + 14, 0, 0) + d)(v)
            for k, v in _bmp_cases().items()},
         **{f"ico {k}": v for k, v in _ico_cases().items()},
         **{f"cur {k}": v for k, v in _cur_cases().items()},
         **{f"dcx {k}": v for k, v in _dcx_cases().items()}}


def _bmp_offsets(name: str, data: bytes) -> bytes:
    """A BMP case's file header with bfOffBits at the pixels."""
    if not name.startswith("bmp "):
        return data
    dib = data[14:]
    bm = imgcodecs.bitmap(dib, 0)
    return data[:10] + struct.pack("<I", 14 + bm["start"]) + dib


@pytest.mark.parametrize("name", sorted(CASES))
def test_files_made_by_hand_read_as_the_jax_package_reads_them(name, tmp_path, monkeypatch):
    try:
        data = _bmp_offsets(name, CASES[name])
    except Exception:  # noqa: BLE001 — a header the port refuses: the file as it is
        data = CASES[name]
    _same_read(tmp_path, data, monkeypatch)


IM_FLOAT_MODES = [b"L 32F", b"L 8S", b"L*12", b"YCC", b"L 8", b"L 16S", b"L*16S", b"L 32",
                  b"L*32", b"L 32 F", b"L*2", b"L*7", b"L*13", b"L*31", b"L*16", b"L*8"]


@pytest.mark.parametrize("mode", IM_FLOAT_MODES)
def test_im_float_and_ycbcr_modes_read_as_the_jax_package_reads_them(mode, tmp_path,
                                                                     monkeypatch):
    """IM's floating-point modes (each ``F;*`` rawmode, the bit decoder's
    odd widths) and YCbCr: the JAX package's pixels and depth, with cv2
    and without it, at sizes whose rows end inside a byte; cut short, an
    error in both."""
    for w, h, seed in ((6, 5, 1), (7, 3, 2), (1, 4, 3), (13, 11, 4)):
        rng = np.random.default_rng(seed)
        body = rng.integers(0, 256, 4 * 3 * w * h, dtype=np.uint8)
        if mode in (b"L 32F", b"L 32 F"):
            body = rng.normal(120, 150, 3 * w * h).astype("<f4")
            body[::5] = np.nan
            body[1::7] = np.inf
        data = _im(mode, w, h, body.tobytes())
        jax = _same_read(tmp_path, data, monkeypatch)
        assert not any(isinstance(j, Exception) for j in jax.values())
    _same_read(tmp_path, _im(mode, 9, 9, bytes(20)), monkeypatch)


def test_im_float_to_l_is_pillows_convert_on_a_sweep():
    """``F -> L`` (the way ``convert("RGBA")`` takes from ``F``) on a sweep
    of float32 values around 0 and 256, every 1/8 between, their
    neighbours, the extremes, signed zeros, infinities and NaNs."""
    v = np.concatenate([np.arange(-4, 262, 0.125), [0.0, -0.0, np.inf, -np.inf, np.nan, -np.nan,
                                                   1e-45, -1e-45, 3.4e38, -3.4e38]])
    v = v.astype(np.float32)
    v = np.concatenate([v, np.nextafter(v, np.float32(np.inf)),
                        np.nextafter(v, np.float32(-np.inf))])
    v = np.concatenate([v, np.random.default_rng(9).normal(128, 200, 20000).astype(np.float32)])
    want = np.asarray(Image.frombytes("F", (len(v), 1), v.tobytes()).convert("RGBA"))[0, :, 0]
    np.testing.assert_array_equal(imgcodecs._f2l(v), want)


def test_im_ycbcr_is_pillows_convert_on_every_triple():
    """The YCbCr -> RGB tables (ConvertYCbCr.c's, made by their formula)
    on all 2^24 (Y, Cb, Cr) triples, a Y at a time over every (Cb, Cr)."""
    cb, cr = np.meshgrid(np.arange(256, dtype=np.uint8), np.arange(256, dtype=np.uint8),
                         indexing="ij")
    for y0 in range(0, 256, 64):
        ycc = np.stack([np.broadcast_to(np.arange(y0, y0 + 64, dtype=np.uint8)[:, None, None],
                                        (64, 256, 256)),
                        np.broadcast_to(cb, (64, 256, 256)), np.broadcast_to(cr, (64, 256, 256))],
                       -1).reshape(64 * 256, 256, 3)
        want = np.asarray(Image.frombytes("YCbCr", (256, 64 * 256), ycc.tobytes()).convert("RGB"))
        np.testing.assert_array_equal(rawimg._ycbcr_rgb(ycc), want)


def _damaged(seed: int) -> list:
    rng = np.random.default_rng(seed)
    out = []
    for name in GOLDEN_NAMES[seed::8]:
        base = (fx.GOLDENS / name).read_bytes()
        for cut in (int(rng.integers(1, 40)), len(base) // 2, len(base) - 1):
            out.append(base[:cut])
        for _ in range(3):
            d = bytearray(base)
            for _ in range(int(rng.integers(1, 4))):
                at = int(rng.integers(0, min(len(base), 600)))
                d[at] ^= int(rng.integers(1, 256))
            out.append(bytes(d))
    return out


@pytest.mark.parametrize("seed", range(8))
def test_truncated_and_damaged_files(seed, tmp_path, monkeypatch):
    """Each golden cut short and with bytes of its header or first pixels
    changed at random: an error in both packages or the same pixels."""
    for data in _damaged(seed):
        _same_read(tmp_path, data, monkeypatch)


# ---- identification --------------------------------------------------------------------

def _port_format(data: bytes) -> str | Exception:
    try:
        dec = timages._decoder(data)
    except Exception as e:  # noqa: BLE001
        return e
    return {rawimg.decode_tga: "TGA", rawimg.decode_pcx: "PCX", rawimg.decode_sgi: "SGI",
            rawimg.decode_qoi: "QOI", rawimg.decode_im: "IM", ico.decode_ico: "ICO",
            imgcodecs.decode_dib: "DIB", imgcodecs.decode_bmp: "BMP", ico.decode_cur: "CUR",
            rawimg.decode_dcx: "DCX", psd.decode_psd: "PSD", dds.decode_dds: "DDS"}.get(dec,
                                                                                     repr(dec))


def _pillow_format(data: bytes) -> str | Exception:
    try:
        return Image.open(io.BytesIO(data)).format
    except Exception as e:  # noqa: BLE001
        return e


def _tga_header_passes(d: bytes) -> bool:
    return (len(d) >= 18 and d[1] in (0, 1) and d[2] in (1, 2, 3, 9, 10, 11)
            and int.from_bytes(d[12:14], "little") > 0 and int.from_bytes(d[14:16], "little") > 0
            and d[16] in (1, 8, 16, 24, 32) and (d[1] == 0 or d[7] in (16, 24, 32)))


def _seeded_headers(seed: int, n: int = 12) -> list:
    """Seeded 18-byte headers that pass TGA's header test, with seeded
    payloads of 0 to 300 bytes; a third start with PCX's signature
    (a 10-byte ID, no colour map)."""
    rng = np.random.default_rng(seed)
    out = []
    while len(out) < n:
        d = bytearray(rng.integers(0, 256, 18, dtype=np.uint8).tobytes())
        d[1] = int(rng.integers(0, 2))
        d[2] = int(rng.choice([1, 2, 3, 9, 10, 11]))
        d[16] = int(rng.choice([1, 8, 16, 24, 32]))
        d[7] = int(rng.choice([16, 24, 32]))
        d[12:16] = struct.pack("<HH", *rng.integers(1, 9, 2))
        if len(out) % 3 == 0:
            d[0], d[1] = 10, 0
        if len(out) % 4 == 1:
            d[3:7] = bytes(4)
        payload = rng.integers(0, 256, int(rng.integers(0, 300)), dtype=np.uint8).tobytes()
        if _tga_header_passes(bytes(d)):
            out.append(bytes(d) + payload)
    return out


@pytest.mark.parametrize("seed", range(8))
def test_identification_follows_pillow_on_seeded_tga_headers(seed, tmp_path, monkeypatch):
    """The format the port picks is the one ``Image.open`` picks (or both
    fail), and the reads agree."""
    for data in _seeded_headers(seed):
        want, got = _pillow_format(data), _port_format(data)
        if isinstance(want, Exception):
            assert isinstance(got, Exception), (data[:18].hex(), got, want)
        else:
            assert got == want, (data[:18].hex(), got, want)
        _same_read(tmp_path, data, monkeypatch)


def test_identification_follows_pillow_on_the_goldens():
    for name in GOLDEN_NAMES:
        data = (fx.GOLDENS / name).read_bytes()
        assert _port_format(data) == _pillow_format(data), name


def test_a_tga_with_a_10_byte_id_is_pcxs():
    """PCX's signature is a TGA with a 10-byte ID and no colour map: where
    the file is long enough for PCX's header, Pillow's PCX plugin takes it
    and fails on its mode; shorter, PCX passes it on to TGA."""
    rgb = _image(8, 8, 21)
    long_file = fx.make_tga(rgb[..., ::-1], 2, 24, ident=b"0123456789")
    assert long_file[:2] == b"\x0a\x00"
    assert isinstance(_pillow_format(long_file), Exception)
    with pytest.raises(OSError, match="unknown PCX mode"):
        timages._decoder(long_file)
    short = fx.make_tga(rgb[:1, :2, ::-1], 2, 24, ident=b"0123456789", footer=False)
    assert _pillow_format(short) == _port_format(short) == "TGA"


# ---- writes ----------------------------------------------------------------------------

WRITE_EXTS = ("tga", "pcx", "sgi", "qoi", "im", "dib", "mpo", "ico")
WRITE_KINDS = {"rgb8": ("RGB", 8), "rgba8": ("RGBA", 8), "gray16": ("I", 16), "gray8": ("I", 8)}


def _write(mod, target, pix, ch, depth):
    try:
        mod.write_image(target, pix, channels=ch, depth=depth)
        return None
    except Exception as e:  # noqa: BLE001
        return e


@pytest.mark.parametrize("ext", WRITE_EXTS)
@pytest.mark.parametrize("kind", sorted(WRITE_KINDS))
def test_writes_are_the_jax_packages_bytes(ext, kind, tmp_path, monkeypatch):
    """The same bytes as the JAX package (the output's name inside SGI and
    IM files included), or an error in both and no file, with cv2 and
    without it."""
    ch, depth = WRITE_KINDS[kind]
    pix = np.random.default_rng(len(ext) + depth).random((37, 41, len(ch)))
    monkeypatch.chdir(tmp_path)
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    target = f"out_{kind}.{ext}"
    monkeypatch.chdir(tmp_path / "j")
    jerr = _write(jimages, target, pix, ch, depth)
    want = None if jerr else (tmp_path / "j" / target).read_bytes()
    monkeypatch.chdir(tmp_path / "t")
    for blocked in (False, True):
        if blocked:
            monkeypatch.setitem(sys.modules, "cv2", None)
        terr = _write(timages, target, pix, ch, depth)
        if jerr is not None:
            assert terr is not None, (ext, kind, jerr)
            assert not (tmp_path / "t" / target).exists()
            continue
        assert terr is None, terr
        assert (tmp_path / "t" / target).read_bytes() == want


@pytest.mark.parametrize("name", ["a.im", "dir/b.sgi", "x" * 120 + ".im", "y" * 30 + ".sgi",
                                  "née.sgi", "née.im", "c.d.e.im"])
def test_names_inside_sgi_and_im_files(name, tmp_path, monkeypatch):
    """SGI keeps the base name's ASCII (79 bytes at most); IM writes
    ``Name:`` cut to ``92 - len(ext)`` characters plus the extension and
    raises on a name ASCII cannot hold, leaving no file."""
    pix = np.random.default_rng(5).random((9, 8, 3))
    for who, mod in (("j", jimages), ("t", timages)):
        (tmp_path / who / "dir").mkdir(parents=True)
    monkeypatch.chdir(tmp_path / "j")
    jerr = _write(jimages, name, pix, "RGB", 8)
    monkeypatch.chdir(tmp_path / "t")
    terr = _write(timages, name, pix, "RGB", 8)
    assert (jerr is None) == (terr is None), (jerr, terr)
    if jerr is None:
        assert (tmp_path / "t" / name).read_bytes() == (tmp_path / "j" / name).read_bytes()
    else:
        assert not (tmp_path / "t" / name).exists()


@pytest.mark.parametrize("ch", ["RGB", "RGBA", "I"])
def test_writes_to_stdout_are_pngs_as_in_the_jax_package(ch, capfdbinary):
    """``-`` is PNG in both packages, whatever format the tools were given
    elsewhere (the IM writer's nameless header is for a stream it never
    gets from ``write_image``)."""
    pix = np.random.default_rng(6).random((7, 9, len(ch)))
    outs = []
    for mod in (jimages, timages):
        mod.write_image("-", pix, channels=ch)
        outs.append(capfdbinary.readouterr().out)
    assert outs[0] == outs[1] and outs[0].startswith(b"\x89PNG")
    assert rawimg.encode_im(np.zeros((2, 2, 3), np.uint8))[:40].count(b"Name:") == 0


def test_check_target_takes_the_new_formats_and_refuses_the_rest():
    """Every format Pillow saves passes the tools' check but AVIF (item 8h,
    part e2), and so do names Pillow has no handler for: ``write_image``
    fails those as Pillow does, after the compute."""
    for ext in WRITE_EXTS + ("dds", "xbm", "msp", "palm", "blp", "icns", "spider", "pdf", "eps",
                             "jpeg2000", "tif", "xyz", "wmf"):
        assert timages.check_target(f"out.{ext}") == (None, f"out.{ext}")
    with pytest.raises(ValueError, match=r"queue 1, item 8h"):
        timages.check_target("out.avif")


# ---- ICO write: Pillow's thumbnails -----------------------------------------------------

THUMB_SHAPES = [(16, 16), (20, 16), (16, 40), (300, 300), (257, 16), (1000, 17), (33, 70),
                (90, 61), (15, 100), (3, 3)]


@pytest.mark.parametrize("shape", THUMB_SHAPES)
@pytest.mark.parametrize("kind", ["RGB", "RGBA", "I;16"])
def test_ico_thumbnails_are_pillows(shape, kind):
    """``thumbnail(size, LANCZOS, reducing_gap=None)`` of each default ICO
    size equals Pillow's, and so does the icon (no frame for an image under
    16 pixels)."""
    w, h = shape
    rng = np.random.default_rng(w * 7 + h)
    if kind == "I;16":
        arr = rng.integers(0, 65536, (h, w), dtype=np.uint16)
        arr[:, : w // 2] = 65535
        img = Image.fromarray(arr)
    else:
        arr = _image(h, w, w + h, len(kind))
        if kind == "RGBA":
            arr[::3, ::2, 3] = 0
            arr[1::3, ::2, 3] = 255
        img = Image.fromarray(arr)
    for size in ico.ICO_SIZES:
        frame = img.copy()
        frame.thumbnail(size, Image.Resampling.LANCZOS, reducing_gap=None)
        np.testing.assert_array_equal(ico.thumbnail(arr, size), np.asarray(frame))
    assert ico.encode_ico(arr) == _save(img, "ICO")


def test_phase_22_writes_are_pillows_at_a_crop(tmp_path, monkeypatch):
    """``chip_smoke.OTHER_4K_DIGESTS`` holds a digest for each format of
    phase 22's 4K writes (made by the JAX package from the same seeded
    pixels); here the port writes a 1:8 crop of them to the JAX package's
    bytes (the full size is written on the card)."""
    assert sorted(chip_smoke.OTHER_4K_DIGESTS) == sorted(chip_smoke.OTHER_EXTS)
    pix = chip_smoke._seeded_pixels((chip_smoke.H // 8, chip_smoke.W // 8),
                                    chip_smoke.OTHER_4K_SEED, chip_smoke.OTHER_4K_NOISE)
    for who, mod in (("j", jimages), ("t", timages)):
        (tmp_path / who).mkdir()
        monkeypatch.chdir(tmp_path / who)
        for ext in chip_smoke.OTHER_EXTS:
            mod.write_image(f"still.{ext}", pix)
    for ext in chip_smoke.OTHER_EXTS:
        assert ((tmp_path / "j" / f"still.{ext}").read_bytes()
                == (tmp_path / "t" / f"still.{ext}").read_bytes()), ext


def test_rle_tga_maker_packets_stay_in_their_rows():
    """``tga_rle`` (the maker of phase 22's 4K and 1080p TGAs) gives files
    Pillow reads back to the same pixels: its run packets never cross a
    row, which Pillow refuses."""
    rgb = _image(40, 300, 22)
    rgb[5, 10:200] = 7
    data = fx.make_tga(rgb[..., ::-1], 10, 24)
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(data))), rgb)
    np.testing.assert_array_equal(rawimg.decode_tga(data)[0], rgb)
