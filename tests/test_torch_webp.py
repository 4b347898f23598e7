"""The port's WebP decoder (``dspfun_tpu_torch/io/webp.py`` on
``native/webp.cpp``) against the JAX package, which reads WebP through
Pillow 12.1 (libwebp's ``WebPAnimDecoder``), and the refusals of Pillow's
other formats (ROADMAP queue 1, item 8h).

* Reads: Pillow's lossy files at qualities 0-100 and methods 0-6, sizes
  from 1x1 to past 512x512, RGBA with ``alpha_quality`` 100 and 30,
  lossless RGB and RGBA (``exact``) at quality 0 and 100 and method 0 and
  6, palettes of 2 to more than 256 colours, two-frame animations, and
  files written by hand (raw and VP8L-coded ALPH chunks under each of the
  four filters, ``VP8X`` files with ``ICCP``, ``EXIF``, ``XMP `` and
  unknown chunks, alpha flags and hints that disagree with the data, a
  first frame at an offset) read through both packages' ``read_image`` as
  RGB, RGBA and I, with cv2 importable and blocked: the same pixels and
  depth exactly, through the port's decoder.  Truncated files raise in
  both; damaged ones raise in both or decode to the same pixels.
* Seeded images of random sizes, content and settings: ``decode_webp``
  gives Pillow's array and mode.
* ``webp.not_carried`` (the simple loop filter, several token
  partitions, which no Pillow setting writes) is refused without cv2
  naming item 8f; ``.webp`` output is cv2's (Pillow's bytes) or refused
  naming 8f.
* Item 8h: each format the JAX package reads or writes beyond the port's
  (TGA, PCX, SGI, QOI, IM, ICO, DIB and MPO are the port's own since;
  tests/test_torch_other_formats.py) is refused naming it, on read and
  before anything is written.
* ``chip_smoke.WEBP_FIXTURES`` (phase 21) holds Pillow's files and the
  JAX package's pixels.
* A failed build raises with the compiler's message.
"""

import io
import struct
import sys

import numpy as np
import pytest
from PIL import Image

import chip_smoke
from dspfun_tpu.io import images as jimages
from dspfun_tpu_torch import _hostbuild
from dspfun_tpu_torch.io import webp
from dspfun_tpu_torch.io import images as timages
from tests import torch_codec_fixtures as fx


def _pil(a, **kw) -> bytes:
    img = a if isinstance(a, Image.Image) else Image.fromarray(a)
    buf = io.BytesIO()
    img.save(buf, format="WEBP", **kw)
    return buf.getvalue()


def _image(h, w, seed=0, c=3, noise=20.0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([128 + 100 * np.sin(x / 5), 128 + 90 * np.cos(y / 4),
                     128 + 50 * np.sin((x + y) / 6), 128 + 120 * np.sin(x * y / 50)], -1)
    return np.clip(base[..., :c] + rng.normal(0, noise, (h, w, c)), 0, 255).astype(np.uint8)


def _palette(n, seed=0, hw=(37, 45)) -> np.ndarray:
    rng = np.random.default_rng(n + seed)
    return rng.integers(0, 256, (n, 3), dtype=np.uint8)[rng.integers(0, n, hw)]


def _anim(frames, **kw) -> bytes:
    imgs = [Image.fromarray(f) for f in frames]
    buf = io.BytesIO()
    imgs[0].save(buf, format="WEBP", save_all=True, append_images=imgs[1:], duration=70, **kw)
    return buf.getvalue()


H, W = 23, 31


def _vp8() -> bytes:
    """A Pillow ``VP8 `` chunk of H x W."""
    return _pil(_image(H, W, 7))[12:]


def _alpha() -> np.ndarray:
    return ((np.add.outer(np.arange(H) * 7, np.arange(W) * 5) + 30) % 256).astype(np.uint8)


def _alph_vp8l(deltas: np.ndarray) -> bytes:
    """A VP8L image stream (no header) whose green channel is ``deltas``."""
    return _pil(np.dstack([deltas] * 3), lossless=True)[12 + 8 + 5:]


def _flip_hint(data: bytes) -> bytes:
    """A simple VP8L file with its header's alpha hint inverted."""
    out = bytearray(data)
    out[12 + 8 + 4] ^= 0x10
    return bytes(out)


def _moved_anim() -> bytes:
    """A two-frame animation whose canvas grows by (3, 5) and whose first
    frame sits at (2, 4)."""
    d = bytearray(_anim([_image(H, W, 8 + k, 4) for k in range(2)]))
    i = d.index(b"VP8X")
    for at, grow in ((i + 12, 3), (i + 15, 5)):
        d[at:at + 3] = (int.from_bytes(d[at:at + 3], "little") + grow).to_bytes(3, "little")
    j = d.index(b"ANMF")
    d[j + 8:j + 11] = (1).to_bytes(3, "little")
    d[j + 11:j + 14] = (2).to_bytes(3, "little")
    return bytes(d)


def _cases() -> dict:
    mk, ch = fx.make_webp, fx.webp_chunk
    rgba = np.dstack([_image(H, W, 7), _alpha()])
    cases = {
        **{f"lossy q{q}": lambda q=q: _pil(_image(40, 56, q), quality=q)
           for q in (0, 50, 80, 100)},
        **{f"lossy method {m}": lambda m=m: _pil(_image(40, 56, 10 + m), method=m)
           for m in range(7)},
        **{f"lossy {h}x{w}": lambda h=h, w=w: _pil(_image(h, w, 1))
           for h, w in ((1, 1), (15, 17), (333, 517), (520, 530))},
        **{f"RGBA lossy alpha_quality {aq}": lambda aq=aq: _pil(_image(40, 56, 2, 4),
                                                                 alpha_quality=aq)
           for aq in (100, 30)},
        **{f"lossless {mode} q{q} method {m}":
           lambda mode=mode, q=q, m=m: _pil(_image(40, 56, 3, len(mode)), lossless=True,
                                            quality=q, method=m, exact=True)
           for mode in ("RGB", "RGBA") for q in (0, 100) for m in (0, 6)},
        "lossless 1x1": lambda: _pil(_image(1, 1, 4), lossless=True),
        **{f"palette {n}": lambda n=n: _pil(_palette(n), lossless=True)
           for n in (2, 4, 16, 256, 300)},
        "animation RGBA lossy": lambda: _anim([_image(H, W, 8 + k, 4) for k in range(2)]),
        "animation RGB lossless": lambda: _anim([_image(H, W, 8 + k) for k in range(2)],
                                                lossless=True),
        "animation first frame at an offset": _moved_anim,
        **{f"raw ALPH filter {f}":
           lambda f=f: mk(ch(b"ALPH", bytes([f << 2]) + fx.alpha_filter(_alpha(), f).tobytes()),
                          _vp8(), vp8x=(0x10, W, H)) for f in range(4)},
        **{f"VP8L ALPH filter {f}":
           lambda f=f: mk(ch(b"ALPH", bytes([1 | f << 2 | 1 << 4])
                             + _alph_vp8l(fx.alpha_filter(_alpha(), f))),
                          _vp8(), vp8x=(0x10, W, H)) for f in range(4)},
        "VP8X metadata and unknown chunks": lambda: mk(
            ch(b"ICCP", b"abc"), ch(b"ALPH", bytes([0]) + _alpha().tobytes()), _vp8(),
            ch(b"EXIF", b"Exif\0\0xx"), ch(b"XMP ", b"<x/>"), ch(b"ABCD", b"12345"),
            vp8x=(0x10 | 0x20 | 0x08 | 0x04, W, H)),
        "Pillow's VP8X with ICC, EXIF and XMP": lambda: _pil(_image(H, W, 7, 4),
                                                             icc_profile=b"not a profile",
                                                             exif=b"Exif\0\0II*\0",
                                                             xmp=b"<x:xmpmeta/>"),
        "VP8X unknown chunk first, flags off": lambda: mk(ch(b"ABCD", b"1"), _vp8(),
                                                          vp8x=(0, W, H)),
        "VP8X alpha flag off, ALPH present": lambda: mk(
            ch(b"ALPH", bytes([0]) + _alpha().tobytes()), _vp8(), vp8x=(0, W, H)),
        "VP8X alpha flag on, no ALPH": lambda: mk(_vp8(), vp8x=(0x10, W, H)),
        "VP8L hint off, alpha in the data": lambda: _flip_hint(_pil(rgba, lossless=True,
                                                                    exact=True)),
        "VP8L hint on, opaque data": lambda: _flip_hint(_pil(rgba[..., :3], lossless=True)),
        "VP8X alpha flag off, VP8L hint on": lambda: mk(
            _pil(rgba, lossless=True, exact=True)[12:], vp8x=(0, W, H)),
        "VP8X alpha flag on, VP8L hint off": lambda: mk(
            _flip_hint(_pil(rgba, lossless=True, exact=True))[12:], vp8x=(0x10, W, H)),
    }
    return cases


CASES = _cases()


def _read(mod, path, ch):
    try:
        return mod.read_image(str(path), channels=ch)
    except (OSError, ValueError, EOFError, SyntaxError) as e:
        return e


def _same_read(tmp_path, data, monkeypatch):
    """Both packages' reads as RGB, RGBA and I, with cv2 and without it:
    the same pixels and depth, or an error in both."""
    path = tmp_path / "in.webp"
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
            assert not isinstance(t, Exception), (ch, blocked, t)
            assert t.depth == j.depth == 8
            np.testing.assert_array_equal(t.pixels, j.pixels)
    return jax


@pytest.mark.parametrize("name", list(CASES))
def test_webp_reads_as_the_jax_package_reads_it(name, tmp_path, monkeypatch):
    data = CASES[name]()
    assert timages._decoder(data) is webp.decode_webp
    jax = _same_read(tmp_path, data, monkeypatch)
    assert not any(isinstance(j, Exception) for j in jax.values())


def _damaged():
    lossy, lossless = _pil(_image(40, 56, 9)), _pil(_image(40, 56, 9), lossless=True)
    alpha = _pil(_image(40, 56, 9, 4), alpha_quality=50)
    out = {}
    for name, base in (("lossy", lossy), ("lossless", lossless), ("lossy alpha", alpha)):
        for cut in (30, len(base) // 2, len(base) - 1):
            out[f"{name} cut at {cut}"] = base[:cut]
        rng = np.random.default_rng(len(base))
        for _ in range(4):
            d = bytearray(base)
            at = int(rng.integers(20, len(base)))
            d[at] ^= int(rng.integers(1, 256))
            out[f"{name} byte {at} changed"] = bytes(d)
    d = bytearray(lossy)
    d[24] ^= 0xFF            # the key frame's start code: no VP8 header
    out["lossy start code"] = bytes(d)
    d = bytearray(lossless)
    d[20] ^= 0xFF            # the VP8L signature
    out["lossless signature"] = bytes(d)
    out["VP8X reserved flag"] = fx.make_webp(_vp8(), vp8x=(0x01, W, H))
    out["VP8X canvas off the image"] = fx.make_webp(_vp8(), vp8x=(0, W + 1, H))
    out["lossy partition cut"] = lossy[:-300] if len(lossy) > 600 else lossy[:-10]
    return out


DAMAGED = _damaged()


@pytest.mark.parametrize("name", list(DAMAGED))
def test_truncated_and_damaged_files(name, tmp_path, monkeypatch):
    """Truncated files raise in both packages; a changed byte raises in
    both or decodes to the same pixels."""
    _same_read(tmp_path, DAMAGED[name], monkeypatch)


@pytest.mark.parametrize("seed", range(8))
def test_damaged_streams_decode_as_pillow_decodes_them(seed):
    """Bytes of Pillow's files changed at random (lossy, lossless, lossy
    with alpha, a VP8L-coded ALPH chunk, a palette, an animation): Pillow
    and ``decode_webp`` both raise, or give the same array.  This holds
    libwebp's readers past a stream's end (the VP8L window read modulo 64
    bits, the 8-bit alpha path's end, the boolean decoder's 56-bit loads)
    and its 16-bit full IDCT on large coefficients."""
    bases = [_pil(_image(40, 56, 9)), _pil(_image(40, 56, 9), lossless=True),
             _pil(_image(40, 56, 9, 4), alpha_quality=50),
             _pil(_image(33, 21, 2, 4), lossless=True, exact=True),
             CASES["VP8L ALPH filter 3"](), CASES["palette 4"](),
             CASES["animation RGBA lossy"]()]
    rng = np.random.default_rng(2000 + seed)
    for k in range(70):
        data = bytearray(bases[k % len(bases)])
        for _ in range(int(rng.integers(1, 6))):
            at = int(rng.integers(12, len(data)))
            data[at:at + 1] = bytes([int(rng.integers(0, 256))])
        data = bytes(data)
        try:
            ref = np.asarray(Image.open(io.BytesIO(data)))
        except Exception:  # noqa: BLE001 — any error of Pillow's
            with pytest.raises((OSError, ValueError)):
                webp.decode_webp(data)
            continue
        got, _ = webp.decode_webp(data)
        np.testing.assert_array_equal(got, ref, err_msg=f"case {k}")


@pytest.mark.parametrize("seed", range(24))
def test_seeded_files_decode_to_pillows_arrays(seed):
    """Random sizes, content and encoder settings: ``decode_webp`` gives
    Pillow's array (its mode's channels) exactly."""
    rng = np.random.default_rng(1000 + seed)
    for _ in range(6):
        h, w, c = int(rng.integers(1, 80)), int(rng.integers(1, 80)), int(rng.choice([3, 4]))
        kind = int(rng.integers(0, 3))
        a = (rng.integers(0, 256, (h, w, c), dtype=np.uint8) if kind == 0
             else _image(h, w, seed, c) // (64 if kind == 2 else 1))
        lossless = bool(rng.integers(0, 2))
        kw = dict(lossless=lossless, quality=int(rng.integers(0, 101)),
                  method=int(rng.integers(0, 7)))
        if c == 4 and lossless:
            kw["exact"] = True
        elif c == 4:
            kw["alpha_quality"] = int(rng.integers(0, 101))
        data = _pil(a.astype(np.uint8), **kw)
        got, depth = webp.decode_webp(data)
        ref = np.asarray(Image.open(io.BytesIO(data)))
        assert depth == 8 and got.shape == ref.shape, (h, w, c, kw)
        np.testing.assert_array_equal(got, ref, err_msg=str((h, w, c, kw)))


# ---- what the decoder leaves out --------------------------------------------------

class _BoolWriter:
    """RFC 6386's boolean encoder (section 7.3)."""

    def __init__(self):
        self.out, self.range, self.bottom, self.count = bytearray(), 255, 0, 24

    def put(self, bit, prob=128):
        split = 1 + (((self.range - 1) * prob) >> 8)
        if bit:
            self.bottom += split
            self.range -= split
        else:
            self.range = split
        while self.range < 128:
            self.range <<= 1
            if self.bottom & (1 << 31):
                i = len(self.out) - 1
                while i >= 0 and self.out[i] == 255:
                    self.out[i] = 0
                    i -= 1
                self.out[i] += 1
            self.bottom = (self.bottom << 1) & 0xFFFFFFFF
            self.count -= 1
            if not self.count:
                self.out.append(self.bottom >> 24)
                self.bottom &= (1 << 24) - 1
                self.count = 8

    def value(self, v, n):
        for b in range(n - 1, -1, -1):
            self.put((v >> b) & 1)

    def bytes(self):
        for _ in range(32):
            self.put(0)
        return bytes(self.out)


def _vp8_header(simple: int, log2_parts: int) -> bytes:
    """A 16x16 VP8 key frame whose first partition sets the filter type and
    the number of token partitions (the rest of it and the token data
    zeros, which decode to some picture)."""
    bw = _BoolWriter()
    bw.value(0, 2)                      # colour space, clamping
    bw.put(0)                           # no segments
    bw.put(simple)
    bw.value(20, 6)                     # filter level
    bw.value(0, 3)                      # sharpness
    bw.put(0)                           # no loop-filter deltas
    bw.value(log2_parts, 2)
    first = bw.bytes() + bytes(400)
    parts = (1 << log2_parts) - 1
    body = b"\x40\x00\x00" * parts + bytes(64 * (parts + 1))  # 64 bytes each
    tag = (len(first) << 5) | 0x10      # key frame, version 0, shown
    frame = struct.pack("<I", tag)[:3] + b"\x9d\x01\x2a" + struct.pack("<HH", 16, 16)
    return fx.make_webp(fx.webp_chunk(b"VP8 ", frame + first + body))


@pytest.mark.parametrize("simple,log2_parts,what", [
    (1, 0, "the simple loop filter"), (0, 1, "2 token partitions"),
    (0, 3, "8 token partitions")])
def test_what_the_decoder_leaves_out_is_refused_without_cv2(simple, log2_parts, what, tmp_path,
                                                            monkeypatch):
    data = _vp8_header(simple, log2_parts)
    assert webp.not_carried(data) == (f"WebP with {what}", "f")
    assert timages._decoder(data).__name__ == "<lambda>"       # the cv2 route
    path = tmp_path / "in.webp"
    path.write_bytes(data)
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ValueError, match=r"queue 1, item 8f") as e:
        timages.read_image(str(path))
    assert what in str(e.value)


def test_pillows_files_are_carried():
    """Every file of this module's cases and Pillow's defaults: the normal
    loop filter and one token partition."""
    for make in CASES.values():
        assert webp.not_carried(make()) is None
    assert webp.not_carried(_vp8_header(0, 0)) is None


def test_webp_output_is_unchanged(tmp_path, monkeypatch):
    """``.webp`` output: Pillow's bytes through cv2, or refused naming
    item 8f without it, before any file is made."""
    pytest.importorskip("cv2")
    pix = _image(13, 21).astype(np.float64) / 255
    out = {}
    for name, mod in (("jax", jimages), ("torch", timages)):
        mod.write_image(str(tmp_path / f"{name}.webp"), pix)
        out[name] = (tmp_path / f"{name}.webp").read_bytes()
    assert out["torch"] == out["jax"]
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ValueError, match=r"queue 1, item 8f"):
        timages.write_image(str(tmp_path / "no.webp"), pix)
    assert not (tmp_path / "no.webp").exists()


# ---- item 8h: Pillow's other formats -----------------------------------------------

OTHER_SAVES = {  # extension -> the mode Pillow writes it from (the rest of item 8h; the
    # formats the port carries are held to the JAX package in test_torch_other_formats.py,
    # and JPEG 2000 in test_torch_jpeg2000.py)
    "blp": "P", "icns": "RGB", "msp": "1", "xbm": "1", "spider": "F",
    "avif": "RGB", "eps": "RGB", "pdf": "RGB", "palm": "1",
}


def _other_file(ext: str) -> bytes:
    mode = {"jpeg2000": "RGB"}.get(ext) or OTHER_SAVES[ext]
    img = Image.fromarray(_image(32, 32, 5))
    img = img.convert(mode) if mode != "F" else img.convert("L").convert("F")
    fmt = {"jpeg2000": "JPEG2000"}.get(ext, ext.upper())
    buf = io.BytesIO()
    img.save(buf, format=fmt)
    return buf.getvalue()


def _readable(data: bytes) -> bool:
    try:
        Image.open(io.BytesIO(data)).load()
        return True
    except Exception:  # noqa: BLE001 — Pillow cannot read it back (EPS, PDF, PALM)
        return False


# the formats of the table whose reads the port carries since g1's reads
# (io/rasters.py) and g2's (io/icns.py, io/blp.py)
READ_SINCE_G1 = ("blp", "icns", "msp", "spider", "xbm")


@pytest.mark.parametrize("ext", sorted(OTHER_SAVES))
def test_pillows_other_formats_are_refused_by_8h(ext, tmp_path, monkeypatch):
    """A file Pillow writes in each of its other formats: where the JAX
    package reads it, the port refuses it naming item 8h, with cv2 and
    without it, or, for BLP, ICNS, MSP, SPIDER and XBM (``READ_SINCE_G1``),
    reads the same pixels and depth; where it does not (EPS without
    Ghostscript, PDF, Palm), the port raises too."""
    data = _other_file(ext)
    path = tmp_path / "in.bin"
    path.write_bytes(data)
    jax = _read(jimages, path, "RGB")
    for blocked in (False, True):
        if blocked:
            monkeypatch.setitem(sys.modules, "cv2", None)
        if ext in READ_SINCE_G1:
            port = timages.read_image(str(path))
            assert port.depth == jax.depth
            np.testing.assert_array_equal(port.pixels, jax.pixels)
            continue
        if isinstance(jax, Exception) or not _readable(data):
            with pytest.raises(ValueError):
                timages.read_image(str(path))
            continue
        with pytest.raises(ValueError, match=r"queue 1, item 8h"):
            timages.read_image(str(path))


def test_pillows_jpeg2000_is_read_as_the_jax_package_reads_it(tmp_path, monkeypatch):
    """The JPEG 2000 file of this table (refused by 8h until the port
    read JPEG 2000): read as the JAX package reads it, with cv2 and
    without it."""
    path = tmp_path / "in.bin"
    path.write_bytes(_other_file("jpeg2000"))
    jax = _read(jimages, path, "RGB")
    for blocked in (False, True):
        if blocked:
            monkeypatch.setitem(sys.modules, "cv2", None)
        port = timages.read_image(str(path))
        assert port.depth == jax.depth
        np.testing.assert_array_equal(port.pixels, jax.pixels)


@pytest.mark.parametrize("name", sorted({"AVIF", "EPS", "JPEG2000", "PDF"}))
def test_pillows_other_save_formats_are_refused_before_writing(name, tmp_path, monkeypatch):
    """AVIF, the one save format of Pillow 12.1 the port does not write: the
    port refuses it naming item 8h before any file is made, whatever the
    JAX package does with the pixels (it writes them).  EPS, JPEG 2000 and
    PDF, refused here until the port wrote them, are now the JAX package's
    bytes (the PDF's clock fixed), with cv2 and without it (the rest:
    tests/test_torch_writes_g3.py).  ICNS and SPIDER are written, and XBM,
    MSP, PALM and BLP fail as in the JAX package
    (tests/test_torch_writes_g1.py)."""
    import time

    fixed = time.struct_time((2025, 6, 30, 12, 0, 59, 0, 181, 0))
    monkeypatch.setattr(time, "gmtime", lambda *a: fixed)
    pix = _image(16, 16, 6).astype(np.float64) / 255
    target = f"out.{name.lower()}"
    for sub in ("jax", "port"):
        (tmp_path / sub).mkdir()
    jax = tmp_path / "jax" / target
    try:
        jimages.write_image(str(jax), pix)
    except Exception:  # noqa: BLE001, S110 — Pillow cannot write the mode
        pass
    port = tmp_path / "port" / target
    for blocked in (False, True):
        if blocked:
            monkeypatch.setitem(sys.modules, "cv2", None)
        if name != "AVIF":
            timages.write_image(str(port), pix)
            assert port.read_bytes() == jax.read_bytes()
            continue
        with pytest.raises(ValueError, match=r"queue 1, item 8h"):
            timages.check_target(str(port))
        with pytest.raises(ValueError, match=r"queue 1, item 8h"):
            timages.write_image(str(port), pix)
        assert not port.exists()


@pytest.mark.parametrize("head", [b"hello, world\n", b"\0" * 64, b"RIFF\x10\0\0\0WEBPVP8Z",
                                  b"JP2 not quite", b"\x01\xdb not SGI"])
def test_unknown_bytes_still_cannot_be_identified(head, tmp_path):
    path = tmp_path / "in.bin"
    path.write_bytes(head)
    with pytest.raises(Exception):  # noqa: B017 — UnidentifiedImageError or another
        jimages.read_image(str(path))
    with pytest.raises(ValueError, match="cannot identify image file"):
        timages.read_image(str(path))


# ---- phase 21's goldens ---------------------------------------------------------------

def test_phase_21_goldens_are_pillows():
    """``webp_fixtures()`` remakes each golden file byte for byte, and
    ``chip_smoke.WEBP_FIXTURES`` holds its sha256 and that of the JAX
    package's RGBA read of it."""
    made = fx.webp_fixtures()
    assert sorted(made) == sorted(chip_smoke.WEBP_FIXTURES)
    for name, data in made.items():
        assert (fx.GOLDENS / name).read_bytes() == data, name
        assert fx.webp_digests(data) == chip_smoke.WEBP_FIXTURES[name], name


@pytest.mark.parametrize("name", sorted(n for n in chip_smoke.WEBP_FIXTURES
                                        if not n.startswith(("webp_motion", "codec_"))))
def test_phase_21_goldens_read_through_the_port(name, tmp_path, monkeypatch):
    data = (fx.GOLDENS / name).read_bytes()
    assert timages._decoder(data) is webp.decode_webp
    _same_read(tmp_path, data, monkeypatch)
    t = timages.read_image(str(fx.GOLDENS / name), channels="RGBA")
    assert fx.rgba_digest(t.pixels) == chip_smoke.WEBP_FIXTURES[name][1]


def test_a_failed_build_raises_with_the_compilers_message(tmp_path, monkeypatch):
    """A source that does not compile raises with the compiler's message:
    no fallback to cv2."""
    src = tmp_path / "src"
    src.mkdir()
    (src / "webp.cpp").write_text("int broken( {\n")
    monkeypatch.setattr(_hostbuild, "_NATIVE", src)
    monkeypatch.setattr(_hostbuild, "build_dir", lambda: tmp_path / "build")
    _hostbuild.load_library.cache_clear()
    webp._load.cache_clear()
    try:
        with pytest.raises(RuntimeError, match=r"(?s)failed \(\d+\).*error"):
            timages._decoder(_pil(_image(8, 8)))
    finally:
        _hostbuild.load_library.cache_clear()
        webp._load.cache_clear()
