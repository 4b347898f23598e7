"""The port's compressed TIFF (``dspfun_tpu_torch/io/imgcodecs.py`` and
``native/tiff.cpp``) against the JAX package, which reads TIFF through
Pillow and libtiff (``dspfun_tpu/io/images.py``).

* Reads: files assembled here (LZW, deflate 8 and 32946, PackBits and
  uncompressed strips; predictor 1 and 2; little- and big-endian; several
  strips with a short last one, at odd sizes; every mode the codec
  carries: 1, L, LA, P, RGB, RGBA with unassociated and associated alpha,
  I;16 and 16-bit RGB(A)) give ``read_image``'s pixels and depth
  exactly, with cv2 importable and with it blocked.
* Associated alpha (ExtraSamples 1): every (colour, alpha) pair of 8
  bits un-premultiplied as Pillow's ``RGBa`` unpacker does it.
* What the codec does not carry (tiles, planar strips, the
  floating-point predictor, JPEG-in-TIFF, CCITT, old-style LZW) goes to
  cv2, or is refused naming ROADMAP queue 1, item 8c, without it; a
  truncated or corrupt file raises ``ValueError``.
"""

import io
import struct
import sys
import zlib

import numpy as np
import pytest
from PIL import Image

from dspfun_tpu.io import images as jimages
from dspfun_tpu_torch.io import imgcodecs
from dspfun_tpu_torch.io import images as timages

# ---- a TIFF writer with its own LZW and PackBits encoders --------------------


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


# (photometric, bits, samples per pixel, ExtraSamples) of each mode
MODES = {
    "1": (1, 1, 1, ()), "L": (1, 8, 1, ()), "L inverted": (0, 8, 1, ()),
    "LA": (1, 8, 2, (2,)), "P": (3, 8, 1, ()), "RGB": (2, 8, 3, ()),
    "RGBA": (2, 8, 4, (2,)), "RGBa": (2, 8, 4, (1,)), "RGBX": (2, 8, 4, (0,)),
    "RGBaX": (2, 8, 5, (1, 0)), "RGBAXX": (2, 8, 6, (2, 0, 0)),
    "I;16": (1, 16, 1, ()), "I;16 photometric 0": (0, 16, 1, ()),
    "RGB;16": (2, 16, 3, ()), "RGBA;16": (2, 16, 4, (2,)), "RGBa;16": (2, 16, 4, (1,)),
}
COMPRESS = {1: lambda b: b, 5: lzw_encode, 8: zlib.compress, 32946: zlib.compress,
            32773: packbits_encode}


def _samples(mode, h, w, seed):
    """Seeded samples of a mode: smooth (so predictor 2 and LZW have
    something to find) plus noise; premultiplied colour never above its
    alpha, as a writer of associated alpha stores it."""
    photo, bits, spp, extra = MODES[mode]
    rng = np.random.default_rng(seed)
    top = (1 << bits) - 1
    y, x = np.mgrid[0:h, 0:w]
    base = (0.5 + 0.4 * np.sin(x[..., None] / 3.0 + y[..., None] / 5.0 + np.arange(spp)))
    v = np.clip(base * top + rng.normal(0, top / 20, (h, w, spp)), 0, top).astype(np.int64)
    if bits == 1:
        return (v > 0).astype(np.uint8)
    if extra[:1] == (1,):
        v[..., :3] = v[..., :3] * v[..., 3:4] // top
    return v.astype(np.uint16 if bits == 16 else np.uint8)


def make_tiff(samples, mode, bo="<", compression=1, predictor=1, rows_per_strip=None,
              cmap=None, extra_tags=()):
    """A TIFF of samples [h, w, spp] in chunky strips, compressed and
    predicted as asked, in byte order ``bo`` ('<' II, '>' MM)."""
    photo, bits, spp, extra = MODES[mode]
    h, w, _ = samples.shape
    if bits == 1:
        rows = [r.tobytes() for r in np.packbits(samples[..., 0], axis=1)]
    else:
        v = samples.astype(np.int64)
        if predictor == 2 and compression in (5, 8, 32946):
            v = v.copy()
            v[:, 1:] = (samples[:, 1:].astype(np.int64) - samples[:, :-1]) % (1 << bits)
        rows = [r.astype(bo + ("u2" if bits == 16 else "u1")).tobytes() for r in v]
    rps = rows_per_strip or h
    strips = [COMPRESS[compression](b"".join(rows[i:i + rps])) for i in range(0, h, rps)]
    offsets, pos = [], 8
    for s in strips:
        offsets.append(pos)
        pos += len(s)
    tags = {256: (4, [w]), 257: (4, [h]), 258: (3, [bits] * spp), 259: (3, [compression]),
            262: (3, [photo]), 273: (4, offsets), 277: (3, [spp]), 278: (4, [rps]),
            279: (4, [len(s) for s in strips]), 284: (3, [1])}
    if predictor != 1:
        tags[317] = (3, [predictor])
    if extra:
        tags[338] = (3, list(extra))
    if cmap is not None:
        tags[320] = (3, list(cmap))
    tags.update(extra_tags)
    body = b"".join(strips)
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


def _palette(seed):
    return np.random.default_rng(seed).integers(0, 65536, 768)


def _same_read(tmp_path, data, channels=("RGB", "RGBA", "I")):
    path = tmp_path / "in.tif"
    path.write_bytes(data)
    for ch in channels:
        j, t = jimages.read_image(str(path), channels=ch), timages.read_image(str(path),
                                                                          channels=ch)
        assert t.depth == j.depth
        np.testing.assert_array_equal(t.pixels, j.pixels)


MATRIX = [(c, p, m) for c in (5, 8, 32946, 32773) for p in (1, 2)
          for m in ("1", "L", "LA", "P", "RGB", "RGBA", "RGBa", "I;16")]


@pytest.mark.parametrize("compression,predictor,mode", MATRIX)
def test_compressed_tiff_reads_as_pillow_reads_it(compression, predictor, mode, tmp_path,
                                                  monkeypatch):
    """Every compression and predictor over every mode, little- and
    big-endian, in one strip and in strips of 3 rows at odd sizes, with
    cv2 importable and blocked.  1-bit samples with predictor 2 under
    LZW or deflate are refused by libtiff, and by the port."""
    refused = mode == "1" and predictor == 2 and compression != 32773
    for k, ((h, w), rps) in enumerate((((1, 1), None), ((7, 9), 3), ((33, 17), 4))):
        for bo in ("<", ">"):
            s = _samples(mode, h, w, seed=compression + 10 * predictor + k)
            data = make_tiff(s, mode, bo, compression, predictor, rps,
                             cmap=_palette(k) if mode == "P" else None)
            if refused:
                path = tmp_path / "in.tif"
                path.write_bytes(data)
                with pytest.raises(OSError):
                    jimages.read_image(str(path))
                with pytest.raises(ValueError, match="predictor 2 with 1-bit"):
                    timages.read_image(str(path))
                continue
            _same_read(tmp_path, data)
            with monkeypatch.context() as mp:
                mp.setitem(sys.modules, "cv2", None)
                _same_read(tmp_path, data, channels=("RGBA",))


@pytest.mark.parametrize("mode", ["L inverted", "RGBX", "RGBaX", "RGBAXX",
                                  "I;16 photometric 0", "RGB;16", "RGBA;16", "RGBa;16"])
@pytest.mark.parametrize("compression", [1, 5, 8])
def test_more_modes_read_as_pillow_reads_them(mode, compression, tmp_path):
    """Photometric 0 (8 bits inverted, 16 bits not: Pillow's rawmode
    ``I;16``, which it has for little-endian files only), RGB with
    ignored extra samples after the colour or the alpha, and 16-bit
    colour (the high bytes; associated alpha un-premultiplied on them),
    at both predictors and byte orders."""
    for predictor in (1, 2):
        for bo in ("<", ">"):
            s = _samples(mode, 11, 13, seed=predictor)
            data = make_tiff(s, mode, bo, compression, predictor, 4)
            if mode == "I;16 photometric 0" and bo == ">":
                path = tmp_path / "in.tif"
                path.write_bytes(data)
                with pytest.raises(OSError, match="cannot identify"):
                    jimages.read_image(str(path))
                assert imgcodecs.tiff_not_carried(data)[1] == "c"
                continue
            _same_read(tmp_path, data)


def test_a_table_that_fills_and_clears(tmp_path):
    """Noise large enough for LZW to fill its table of 4094 codes and
    clear it several times, in one strip and in strips of 16 rows."""
    rng = np.random.default_rng(4)
    s = rng.integers(0, 256, (64, 71, 3), dtype=np.uint8)
    for rps in (None, 16):
        data = make_tiff(s, "RGB", "<", 5, 1, rps)
        assert len(data) > 64 * 71 * 3
        _same_read(tmp_path, data)
        got, _ = imgcodecs.decode_tiff(data)
        np.testing.assert_array_equal(got, s)


def test_associated_alpha_of_every_pair_is_pillows():
    """All 256 x 256 (colour, alpha) pairs of 8 bits, stored with
    ExtraSamples 1: the port's decode equals Pillow's ``RGBa`` raw mode
    and Pillow's read of the same file, uncompressed and LZW."""
    c, a = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    s = np.stack([c, 255 - c, (c * 7) % 256, a], -1).astype(np.uint8)
    want = np.asarray(Image.frombytes("RGBA", (256, 256), s.tobytes(), "raw", "RGBa"))
    for comp in (1, 5):
        data = make_tiff(s, "RGBa", "<", comp, 1, 64)
        got, depth = imgcodecs.decode_tiff(data)
        assert depth == 8
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(data))), want)
    assert (want[a == 0] == 0).all() and (want[a == 255] == s[a == 255]).all()


def test_associated_alpha_reads_as_the_jax_package(tmp_path):
    """The fault repaired first: Pillow's RGBA TIFF with ExtraSamples
    patched to 1 (associated) reads un-premultiplied in both packages,
    uncompressed and LZW."""
    rng = np.random.default_rng(9)
    img = Image.fromarray(rng.integers(0, 256, (19, 23, 4), dtype=np.uint8))
    for comp in ("raw", "tiff_lzw"):
        buf = io.BytesIO()
        img.save(buf, "TIFF", compression=comp)
        data = bytearray(buf.getvalue())
        ifd = struct.unpack_from("<I", data, 4)[0]
        for k in range(struct.unpack_from("<H", data, ifd)[0]):
            at = ifd + 2 + 12 * k
            if struct.unpack_from("<H", data, at)[0] == 338:
                struct.pack_into("<H", data, at + 8, 1)
        assert imgcodecs._tiff_tags(bytes(data))[1][338] == (1,)
        _same_read(tmp_path, bytes(data))


def test_pillows_own_files_with_predictor_and_strips(tmp_path):
    """What Pillow writes through libtiff: predictor 2 and small strips
    over LZW, deflate and PackBits (which libtiff writes and reads without
    the predictor)."""
    rng = np.random.default_rng(2)
    for mode in ("RGB", "L", "RGBA", "I;16"):
        a = rng.integers(0, 65536 if mode == "I;16" else 256,
                         (29, 31) if mode in ("L", "I;16") else (29, 31, len(mode)))
        img = Image.fromarray(a.astype(np.uint16 if mode == "I;16" else np.uint8))
        for comp in ("tiff_lzw", "tiff_adobe_deflate", "tiff_deflate", "packbits"):
            for kw in ({"tiffinfo": {317: 2}}, {"strip_size": 256}):
                buf = io.BytesIO()
                img.save(buf, "TIFF", compression=comp, **kw)
                _same_read(tmp_path, buf.getvalue())


# ---- what the codec does not carry ------------------------------------------

def _not_carried(kind):
    s = _samples("RGB", 8, 8, 0)
    if kind == "tiled":
        return make_tiff(s, "RGB", "<", 5, extra_tags={322: (3, [16]), 323: (3, [16])})
    if kind == "planar":
        return make_tiff(s, "RGB", "<", 8, extra_tags={284: (3, [2])})
    if kind == "predictor 3":
        return make_tiff(s, "RGB", "<", 8, 3)
    if kind == "JPEG":
        return make_tiff(s, "RGB", "<", 1, extra_tags={259: (3, [7])})
    return make_tiff(s[..., :1] > 127, "1", "<", 1, extra_tags={259: (3, [4])})   # CCITT G4


@pytest.mark.parametrize("kind", ["tiled", "planar", "predictor 3", "JPEG", "CCITT"])
def test_what_the_codec_does_not_carry_goes_to_cv2(kind, tmp_path, monkeypatch):
    data = _not_carried(kind)
    assert imgcodecs.tiff_not_carried(data)[1] == "c"
    with pytest.raises(ValueError, match="not carried"):
        imgcodecs.decode_tiff(data)
    path = tmp_path / "in.tif"
    path.write_bytes(data)
    seen = []

    def fake_cv2(d, name):
        seen.append(name)
        return np.zeros((8, 8, 3), np.uint8), 8

    with monkeypatch.context() as mp:
        mp.setattr(timages, "_cv2_decode", fake_cv2)
        timages.read_image(str(path))
    assert seen == ["TIFF"]
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ValueError, match="queue 1, item 8c") as e:
        timages.read_image(str(path))
    assert "TIFF" in str(e.value)


def test_old_style_lzw_is_refused():
    """libtiff's LSB-first 'compat' LZW (a strip starting 0x00 with the
    low bit of the next byte set) is refused naming item 8c."""
    s = _samples("L", 4, 4, 0)
    good = make_tiff(s, "L", "<", 5)
    data = bytearray(good)
    data[8:10] = b"\x00\x01"
    with pytest.raises(ValueError, match="old-style .*item 8c"):
        imgcodecs.decode_tiff(bytes(data))


@pytest.mark.parametrize("compression", [5, 8, 32946, 32773])
def test_truncated_and_corrupt_files_raise(compression, tmp_path):
    """A strip cut short, and an LZW or deflate stream with a bad code,
    raise ``ValueError`` in the port and an error in Pillow."""
    s = _samples("RGB", 21, 17, 1)
    data = make_tiff(s, "RGB", "<", compression, 1, 7)
    _, t = imgcodecs._tiff_tags(data)
    cases = {}
    short = bytearray(data)       # the last strip's byte count cut to a third
    ifd = struct.unpack_from("<I", data, 4)[0]
    for k in range(struct.unpack_from("<H", data, ifd)[0]):
        at = ifd + 2 + 12 * k
        if struct.unpack_from("<H", data, at)[0] == 279:
            where = struct.unpack_from("<I", data, at + 8)[0]
            struct.pack_into("<I", short, where + 8, t[279][2] // 3)
    cases["short strip"] = bytes(short)
    if compression != 32773:
        bad = bytearray(data)
        o = t[273][1]
        bad[o + 2:o + 6] = b"\xff\xff\xff\xff"
        cases["bad code"] = bytes(bad)
    for name, d in cases.items():
        path = tmp_path / "in.tif"
        path.write_bytes(d)
        with pytest.raises(ValueError):
            timages.read_image(str(path))
        with pytest.raises(OSError):
            jimages.read_image(str(path))
