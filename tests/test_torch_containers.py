"""Item 8h's containers over codecs the port has (g2's reads) in the port's
own code (``dspfun_tpu_torch/io/icns.py``, ``io/blp.py``,
``io/containers.py``; their loops in ``native/rawimg.cpp``) against the
JAX package, which reads them through Pillow 12.1's plugins: ICNS, BLP,
FTEX, FLI/FLC, PCD and IPTC.

* ``chip_smoke.CONTAINER_FIXTURES`` (phase 31a): the goldens of
  ``torch_codec_fixtures.container_goldens()`` (Pillow's ICNS and BLP
  writes, the numpy writers' files of every other kind and variant)
  remade byte for byte, the PhotoCD files made at run time, their digests,
  and both packages' reads of them;
* ``chip_smoke.CONTAINER_4K_DIGESTS`` (phase 31b): the 3840x2160 BLP2
  DXT1 and FTEX DXT1 files the numpy writers make on the card, held to
  the JAX package's read of the same bytes;
* every kind and variant: Pillow's own ICNS writes of each mode it saves
  and BLP1/BLP2 writes of ``P`` images, the writers' RLE, raw and JPEG
  2000 icons, BLP palette, DXT1/3/5 and JPEG mipmaps (CMYK and YCCK
  JPEGs among them), FTEX, FLI chunks, PCD orientations, IPTC modes,
  bands and compressions; and seeded sweeps: random header bytes, files
  cut short, random FLI chunks.

Each compares both packages' ``read_image`` (RGB, RGBA and I, with cv2
importable and blocked): the same pixels and depth, or an error in both.
"""

import hashlib
import io

import numpy as np
import pytest

import chip_smoke
from dspfun_tpu.io import images as jimages
from dspfun_tpu_torch.io import blp, containers, icns
from dspfun_tpu_torch.io import images as timages
from dspfun_tpu_torch.io import png as tpng
from tests import torch_codec_fixtures as fx
from tests.test_torch_other_formats import _same_read

NAMES = fx.CONTAINER_NAMES + fx.PCD_NAMES


@pytest.fixture(scope="module")
def remade():
    pytest.importorskip("PIL")
    return fx.container_goldens()


@pytest.fixture(scope="module")
def files():
    return fx.container_fixtures()


def _ok(jax) -> None:
    assert not any(isinstance(j, Exception) for j in jax.values()), jax


def _save(img, fmt, **kw) -> bytes:
    buf = io.BytesIO()
    img.save(buf, fmt, **kw)
    return buf.getvalue()


# ---- the goldens -------------------------------------------------------------------


@pytest.mark.parametrize("name", fx.CONTAINER_NAMES)
def test_goldens_are_remade(name, remade):
    """Each golden is what its writer (Pillow for ICNS, BLP palettes and
    the JPEG and JPEG 2000 payloads, numpy for the rest) makes again, byte
    for byte."""
    assert remade[name] == (fx.GOLDENS / name).read_bytes(), name
    assert sum(len(v) for v in remade.values()) < 200_000


@pytest.mark.parametrize("name", NAMES)
def test_phase_31_digests(name, files):
    """``chip_smoke.CONTAINER_FIXTURES``: the file's sha256 and the JAX
    package's RGBA read of it."""
    assert fx.other_digests(files[name]) == chip_smoke.CONTAINER_FIXTURES[name]
    assert sorted(chip_smoke.CONTAINER_FIXTURES) == sorted(NAMES)


@pytest.mark.parametrize("name", NAMES)
def test_goldens_read_as_the_jax_package_reads_them(name, files, tmp_path, monkeypatch):
    """Each golden takes its decoder and reads as the JAX package reads it."""
    data = files[name]
    decoder = chip_smoke._container_decoder(name)
    assert decoder.__module__ in (icns.__name__, blp.__name__, containers.__name__)
    assert timages._decoder(data) is decoder
    _ok(_same_read(tmp_path, data, monkeypatch))


@pytest.mark.parametrize("kind", sorted(chip_smoke.CONTAINER_4K_DIGESTS))
def test_phase_31_4k_digests(kind, tmp_path):
    """The 3840x2160 files phase 31b makes with the numpy writers: their
    sha256 and the JAX package's RGB read, as ``CONTAINER_4K_DIGESTS``
    holds them (the BLP through Pillow's Python DXT1 decoder, a few
    seconds)."""
    data = fx.container_4k(kind)
    path = tmp_path / kind
    path.write_bytes(data)
    got = (hashlib.sha256(data).hexdigest(),
           fx.rgba_digest(jimages.read_image(str(path), channels="RGB").pixels))
    assert got == chip_smoke.CONTAINER_4K_DIGESTS[kind]
    port = timages.read_image(str(path), channels="RGB")
    assert fx.rgba_digest(port.pixels) == got[1] and port.depth == 8


# ---- ICNS ---------------------------------------------------------------------------


@pytest.mark.parametrize("size", ((17, 23), (40, 40), (5, 3)))
@pytest.mark.parametrize("mode", ("RGB", "RGBA", "L", "LA", "P", "I;16", "1"))
def test_pillows_icns_writes_read_back(mode, size, tmp_path, monkeypatch):
    """Pillow's ICNS of each mode it saves (its 1024-pixel PNG the best
    size; a ``P`` image's transparency not applied, a 16-bit gray one's
    samples clipped to 255 by the ``RGBA`` open)."""
    from PIL import Image

    w, h = size
    rng = np.random.default_rng(w * 31 + h)
    if mode == "I;16":
        img = Image.fromarray(rng.integers(0, 65536, (h, w)).astype(np.uint16))
    else:
        img = Image.fromarray(rng.integers(0, 256, (h, w, 4)).astype(np.uint8)).convert(mode)
    if mode == "P":
        img.info["transparency"] = 3
    _ok(_same_read(tmp_path, _save(img, "ICNS"), monkeypatch))


def _icns_variants() -> dict:
    from PIL import Image

    rng = np.random.default_rng(7)
    rgb = rng.integers(0, 256, (16, 16, 3)).astype(np.uint8)
    rgb[:, :8] = 7
    m = rng.integers(0, 256, (16, 16)).astype(np.uint8)
    up = lambda a, k: np.repeat(np.repeat(a, k, 0), k, 1)  # noqa: E731
    png = lambda a: _save(Image.fromarray(a), "PNG")  # noqa: E731
    j2k = lambda a, **kw: _save(Image.fromarray(a), "JPEG2000", **kw)  # noqa: E731
    return {
        "is32": [(b"is32", fx.icns_rgb(rgb))],
        "is32 mask": [(b"is32", fx.icns_rgb(rgb)), (b"s8mk", m.tobytes())],
        "is32 raw": [(b"is32", rgb.tobytes())],
        "is32 short mask": [(b"is32", fx.icns_rgb(rgb)), (b"s8mk", m.tobytes()[:100])],
        "il32 mask toc": [(b"il32", fx.icns_rgb(up(rgb, 2))), (b"l8mk", up(m, 2).tobytes())],
        "ih32": [(b"ih32", fx.icns_rgb(up(rgb, 3)))],
        "it32": [(b"it32", fx.icns_rgb(up(rgb, 8), True))],
        "it32 bad signature": [(b"it32", b"\1" + fx.icns_rgb(up(rgb, 8), True)[1:])],
        "it32 and is32": [(b"it32", fx.icns_rgb(up(rgb, 8), True)), (b"is32", rgb.tobytes())],
        "mask alone": [(b"s8mk", m.tobytes())],
        "png": [(b"icp4", png(rgb))],
        "png over rle": [(b"is32", fx.icns_rgb(rgb)), (b"icp4", png(rgb[::-1]))],
        "png of a smaller size": [(b"icp4", png(np.zeros((8, 8, 3), np.uint8)))],
        "png of a size off the scale": [(b"ic10", png(np.zeros((7, 5, 3), np.uint8)))],
        "png la": [(b"icp5", png(np.dstack([up(m, 2), up(m, 2)[::-1]])))],
        "png 16-bit rgb": [(b"icp4", tpng.encode_png(rgb.astype(np.uint16) * 257))],
        "jp2": [(b"ic07", j2k(up(rgb, 8)))],
        "j2k gray 16": [(b"ic07", j2k(up(m, 8).astype(np.uint16) * 200, no_jp2=True))],
        "j2k rgba": [(b"ic12", j2k(np.dstack([up(rgb, 4), up(m, 4)])))],
        "unknown payload": [(b"ic07", b"hello world, not an image")],
        "no icon": [(b"xxxx", b"12")],
        "rle cut short": [(b"is32", fx.icns_rgb(rgb)[:300])],
    }


ICNS_VARIANTS = _icns_variants()


@pytest.mark.parametrize("name", sorted(ICNS_VARIANTS))
def test_icns_variants(name, tmp_path, monkeypatch):
    """ICNS's RLE colour (and its raw form, its ``it32`` signature) with
    and without masks, PNG and JPEG 2000 payloads over it, payload sizes
    on and off the file's scale: the same read as the JAX package's, or an
    error in both."""
    _same_read(tmp_path, fx.make_icns(ICNS_VARIANTS[name], toc="toc" in name), monkeypatch)


def test_icns_header_variants(tmp_path, monkeypatch):
    """A block of length 0, a header cut short and a length past the
    file's end pass the file on (nothing else takes it)."""
    rgb = np.zeros((16, 16, 3), np.uint8)
    for data in (b"icns" + (100).to_bytes(4, "big") + b"is32" + bytes(4),
                 b"icns\0\0", fx.make_icns([(b"is32", rgb.tobytes())], length=5000),
                 fx.make_icns([(b"is32", rgb.tobytes())], length=8)):
        _same_read(tmp_path, data, monkeypatch)


# ---- BLP ----------------------------------------------------------------------------


@pytest.mark.parametrize("size", ((17, 23), (16, 8), (5, 3)))
@pytest.mark.parametrize("version", ("BLP1", "BLP2"))
def test_pillows_blp_writes_read_back(version, size, tmp_path, monkeypatch):
    """Pillow's BLP1 and BLP2 of ``P`` images, with an RGB palette and an
    RGBA one."""
    from PIL import Image

    w, h = size
    rng = np.random.default_rng(w * 7 + h)
    img = Image.fromarray(rng.integers(0, 256, (h, w, 3)).astype(np.uint8)).convert("P")
    _ok(_same_read(tmp_path, _save(img, "BLP", blp_version=version), monkeypatch))
    q = Image.fromarray(rng.integers(0, 256, (h, w, 3)).astype(np.uint8)).quantize(200)
    q.putpalette(bytes(rng.integers(0, 256, 800).astype(np.uint8)), "RGBA")
    _ok(_same_read(tmp_path, _save(q, "BLP", blp_version=version), monkeypatch))


def _blp_variants() -> dict:
    rng = np.random.default_rng(8)
    out = {}
    for w, h in ((17, 23), (16, 8), (5, 3)):
        nb = ((w + 3) // 4) * ((h + 3) // 4)
        pal = bytes(rng.integers(0, 256, 1024).astype(np.uint8))
        idx = rng.integers(0, 256, w * h).astype(np.uint8).tobytes()
        for ae, size in ((0, 8), (1, 16), (7, 16), (5, 16)):
            for alpha in (0, 1, 8):
                blocks = rng.integers(0, 256, nb * size).astype(np.uint8)
                blocks[::size] = 0      # color0 <= color1 in some blocks
                out[f"dxt ae{ae} alpha{alpha} {w}x{h}"] = (w, h, blocks.tobytes(), 2, 1, 2,
                                                           alpha, ae, pal)
        for alpha in (0, 1, 4, 8):
            out[f"blp2 palette alpha{alpha} {w}x{h}"] = (w, h, idx, 2, 1, 1, alpha, 0, pal)
            out[f"blp1 palette alpha{alpha} {w}x{h}"] = (w, h, idx, 1, 1, 5, alpha, 0, pal)
        out[f"blp1 palette enc4 at an offset {w}x{h}"] = (w, h, idx, 1, 1, 4, 8, 0, pal, b"",
                                                         3000)
        out[f"blp2 raw bgra {w}x{h}"] = (w, h, idx * 4, 2, 1, 3, 8, 0, pal)
        out[f"blp2 jpeg compression {w}x{h}"] = (w, h, idx, 2, 0, 1, 8, 0, pal)
        out[f"blp1 encoding 3 {w}x{h}"] = (w, h, idx, 1, 1, 3, 0, 0, pal)
        out[f"blp1 compression 2 {w}x{h}"] = (w, h, idx, 1, 2, 5, 0, 0, pal)
        out[f"blp2 palette short {w}x{h}"] = (w, h, idx[:-3], 2, 1, 1, 0, 0, pal)
        out[f"blp2 palette long {w}x{h}"] = (w, h, idx + b"more", 2, 1, 1, 0, 0, pal)
        out[f"blp2 dxt short {w}x{h}"] = (w, h, bytes(nb * 8 - 1), 2, 1, 2, 0, 0, pal)
    return out


BLP_VARIANTS = _blp_variants()


@pytest.mark.parametrize("name", sorted(BLP_VARIANTS))
def test_blp_variants(name, tmp_path, monkeypatch):
    """BLP2 DXT1 (3 and 4 bytes a pixel), DXT3, DXT5 and an unknown alpha
    encoding at widths that shear Pillow's rows; palettes at every alpha
    depth; BLP1's palette read wherever the offset points; raw BGRA,
    unknown encodings and compressions, data short and long."""
    _same_read(tmp_path, fx.make_blp(*BLP_VARIANTS[name]), monkeypatch)


@pytest.mark.parametrize("jpeg", ("RGB", "L", "CMYK", "cmyk_ycck.jpg", "cmyk_no_adobe.jpg",
                                  "arith_ycck_prog.jpg", "arith_seq_420.jpg", "small", "large"))
def test_blp1_jpeg(jpeg, tmp_path, monkeypatch):
    """BLP1's JPEG mipmaps: RGB, gray and CMYK JPEGs from Pillow and the
    CMYK, YCCK and arithmetic-coded goldens (YCCK read as CMYK, as the
    plugin's ``CMYK`` mode has libjpeg read it), red and blue swapped, with
    and without the alpha flag and a gap before the mipmap; a JPEG smaller
    than the header's size fails, a larger one is cut."""
    from PIL import Image

    rng = np.random.default_rng(9)
    a = rng.integers(0, 256, (23, 17, 3)).astype(np.uint8)
    w, h = 17, 23
    if jpeg.endswith(".jpg"):
        data = (fx.GOLDENS / jpeg).read_bytes()
        w, h = Image.open(io.BytesIO(data)).size
    elif jpeg in ("small", "large"):
        data = _save(Image.fromarray(a[:11] if jpeg == "small" else np.tile(a, (2, 2, 1))), "JPEG")
    else:
        data = _save(Image.fromarray(a).convert(jpeg), "JPEG", quality=90)
    for alpha, offset in ((0, None), (8, None), (0, 2000)):
        blob = fx.make_blp(w, h, data[200:], 1, 0, 5, alpha, jpeg_header=data[:200],
                           offset=offset)
        jax = _same_read(tmp_path, blob, monkeypatch)
        if jpeg != "small":
            _ok(jax)


# ---- FTEX, PCD ------------------------------------------------------------------------


def _ftex_variants() -> dict:
    rng = np.random.default_rng(10)
    out = {}
    for w, h in ((17, 23), (16, 8), (5, 3)):
        rgb = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
        blk = fx.bc1_blocks(rgb)
        out.update({
            f"dxt1 {w}x{h}": (blk, w, h, 0), f"raw {w}x{h}": (rgb.tobytes(), w, h, 1),
            f"dxt1 short {w}x{h}": (blk[:-3], w, h, 0),
            f"raw short {w}x{h}": (rgb.tobytes()[:-1], w, h, 1),
            f"two formats {w}x{h}": (blk, w, h, 0, 2), f"format 3 {w}x{h}": (blk, w, h, 3),
            f"mipmap at 64 {w}x{h}": (blk, w, h, 0, 1, 64),
            f"size -1 {w}x{h}": (blk + b"xx", w, h, 0, 1, None, -1),
            f"size 0 {w}x{h}": (blk, w, h, 0, 1, None, 0),
            f"negative offset {w}x{h}": (blk, w, h, 0, 1, -4),
            f"width 0 {w}x{h}": (blk, 0, h, 0)})
    return out


FTEX_VARIANTS = _ftex_variants()


@pytest.mark.parametrize("name", sorted(FTEX_VARIANTS))
def test_ftex_variants(name, tmp_path, monkeypatch):
    """FTEX's DXT1 (format 0, ``RGBA``) and raw (format 1, ``RGB``)
    mipmaps, and its failures: a format count other than 1 (Pillow's
    assertion), an unknown format, a negative offset; a mipmap length of -1
    reads to the end."""
    _same_read(tmp_path, fx.make_ftex(*FTEX_VARIANTS[name]), monkeypatch)


@pytest.mark.parametrize("orientation", range(8))
def test_pcd_orientations(orientation, tmp_path, monkeypatch):
    """PhotoCD's base image through the PhotoYCC tables, its orientation's
    low bits turning it 90 (1) or 270 (3) degrees."""
    rng = np.random.default_rng(orientation)
    data = fx.make_pcd(rng.integers(0, 256, (512, 768)), rng.integers(0, 256, (256, 384)),
                       rng.integers(0, 256, (256, 384)), orientation)
    _ok(_same_read(tmp_path, data, monkeypatch))
    _same_read(tmp_path, data[:-1], monkeypatch)


def test_pcd_tables_are_pillows():
    """``UnpackYCC.c``'s tables give Pillow's RGB for every pair of luma
    and Cb (the Cr coupled to it), every pair of luma and Cr (the Cb
    coupled), and random triples."""
    from PIL import Image

    s = np.arange(256 * 384)
    c = (s % 256).reshape(256, 384)
    blocks = (4 * (s // 256)[:, None] + np.arange(4)) % 256        # each chroma's 2x2 lumas
    y = blocks.reshape(256, 384, 2, 2).transpose(0, 2, 1, 3).reshape(512, 768)
    rng = np.random.default_rng(13)
    for cb, cr, yy in ((c, c * 7 % 256, y), (c * 11 % 256, c, y),
                       (rng.integers(0, 256, (256, 384)), rng.integers(0, 256, (256, 384)),
                        rng.integers(0, 256, (512, 768)))):
        data = fx.make_pcd(yy, cb, cr)
        want = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
        np.testing.assert_array_equal(containers.decode_pcd(data)[0], want)


# ---- FLI ----------------------------------------------------------------------------


def _fli_cases() -> dict:
    rng = np.random.default_rng(11)
    w, h = 37, 23
    idx = rng.integers(0, 256, (h, w)).astype(np.uint8)
    idx[:, :10] = 5
    pal = [(0, rng.integers(0, 256, (256, 3)))]
    pal64 = [(3, rng.integers(0, 64, (40, 3))), (10, rng.integers(0, 64, (5, 3)))]
    lc = {2: [(3, ("r", 5, 9)), (1, ("l", b"abcdef"))], 4: [(0, ("l", b"xy"))]}
    ss2 = [([], [(2, ("r", 3, (7, 8))), (1, ("l", b"abcd"))]), ([0xFFFE], [(0, ("l", b"zz"))]),
           ([0x8000 | 77], [(4, ("r", 2, (1, 2)))])]
    c, brun = fx.fli_color(pal), fx.fli_brun(idx)
    return {
        "brun": ([c, brun], {}), "brun 64 colours": ([fx.fli_color(pal64, 11), brun], {}),
        "copy": ([c, fx.fli_chunk(16, idx.tobytes())], {}),
        "copy short": ([c, fx.fli_chunk(16, idx.tobytes()[:-40])], {}),
        "black": ([c, brun, fx.fli_chunk(13, b"")], {}),
        "lc": ([c, brun, fx.fli_lc(lc, 2, 4)], {}),
        "lc past the width": ([c, fx.fli_lc({0: [(30, ("r", 20, 9))]}, 0, 1)], {}),
        "lc past the height": ([c, fx.fli_lc({}, 20, 10)], {}),
        "ss2": ([c, brun, fx.fli_ss2(ss2)], {}),
        "stamp": ([c, fx.fli_chunk(18, b"stamp data"), brun], {}),
        "unknown chunk": ([c, fx.fli_chunk(99, b"??")], {}),
        "no palette": ([brun], {}), "palette after the image": ([brun, c], {}),
        "prefix chunk": ([c, brun], dict(prefix=b"prefixdata")),
        "frame size past the end": ([c, brun], dict(framesize=10 ** 6)),
        "frame size 0": ([c, brun], dict(framesize=0)),
        "frame size short": ([c, brun], dict(framesize=100)),
        "flags 1": ([c, brun], dict(flags=1)),
        "fli": ([c, brun], dict(magic=0xAF11)),
    }


FLI_CASES = _fli_cases()


@pytest.mark.parametrize("name", sorted(FLI_CASES))
def test_fli_chunks(name, tmp_path, monkeypatch):
    """FLI and FLC first frames of each frame chunk (SS2, LC, BLACK, BRUN,
    COPY) under a 256- or 64-level palette, stamp and unknown chunks, a
    prefix chunk (passed over by the palette search, fatal to the decode),
    frame sizes off the data and an unaccepted flags word."""
    chunks, kw = FLI_CASES[name]
    _same_read(tmp_path, fx.make_fli(37, 23, chunks, **kw), monkeypatch)


@pytest.mark.parametrize("seed", range(24))
def test_fli_random_chunks(seed, tmp_path, monkeypatch):
    """Random bodies of each chunk type, odd and even, in frames of random
    size, some cut short: the same image as Pillow's decoder, or an error
    in both."""
    pal = fx.fli_color([(0, np.arange(768).reshape(256, 3) % 256)])
    for k in range(8):
        r = np.random.default_rng(1000 * seed + k)
        w, h = int(r.integers(1, 40)), int(r.integers(1, 30))
        chunks = [pal] if k % 3 else []
        for _ in range(int(r.integers(1, 4))):
            kind = int(r.choice([7, 12, 13, 15, 16, 4, 11, 18]))
            body = bytearray(r.integers(0, 256, int(r.integers(0, 200))).astype(np.uint8))
            if kind == 12 and len(body) >= 4:
                body[:4] = bytes([int(r.integers(0, h)), 0, int(r.integers(0, 5)), 0])
            if kind == 7 and len(body) >= 2:
                body[:2] = bytes([int(r.integers(0, 4)), 0])
            chunks.append(fx.fli_chunk(kind, bytes(body), pad=bool(r.integers(0, 2))))
        data = fx.make_fli(w, h, chunks)
        if r.random() < 0.2:
            data = data[:int(r.integers(128, len(data)))]
        _same_read(tmp_path, data, monkeypatch)


# ---- IPTC ---------------------------------------------------------------------------


def _iptc_cases() -> dict:
    from PIL import Image

    rng = np.random.default_rng(12)
    w, h = 19, 13
    g = rng.integers(0, 256, (h, w)).astype(np.uint8)
    raw = g.tobytes()
    jpg = _save(Image.fromarray(g), "JPEG")
    rgbj = _save(Image.fromarray(rng.integers(0, 256, (h, w, 3)).astype(np.uint8)), "JPEG")
    png16 = _save(Image.fromarray(g.astype(np.uint16) * 250), "PNG")
    f = fx.iptc_field
    out = {
        "raw": fx.make_iptc(w, h, raw), "raw in records": fx.make_iptc(w, h, raw, chunk=50),
        "raw short": fx.make_iptc(w, h, raw[:-5]), "raw long": fx.make_iptc(w, h, raw + b"xx"),
        "jpeg": fx.make_iptc(w, h, jpg, compression=5),
        "rgb jpeg in L": fx.make_iptc(w, h, rgbj, compression=5),
        "16-bit png in L": fx.make_iptc(w, h, png16, compression=5),
        "compression 2": fx.make_iptc(w, h, raw, compression=2),
        "no compression": b"".join([f(3, 20, bytes([w])), f(3, 30, bytes([h])),
                                    f(3, 60, b"\1\0"), f(8, 10, raw)]),
        "no (3, 60)": b"".join([f(3, 20, bytes([w])), f(3, 30, bytes([h])), f(3, 120, b"\1"),
                                f(8, 10, raw)]),
        "no image": fx.make_iptc(w, h, b"")[:-5],
        "extended length": fx.make_iptc(w, h, raw, extra=[f(2, 5, b"x" * 300, extended=2)]),
        "repeated tag": fx.make_iptc(w, h, raw, extra=[f(2, 25, b"k1"), f(2, 25, b"k2"),
                                                       f(2, 25, b"k3")]),
        "repeated (3, 60)": fx.make_iptc(w, h, raw, extra=[f(3, 60, b"\1\0")]),
        "zeros after": fx.make_iptc(w, h, raw) + bytes(10),
        "junk after": fx.make_iptc(w, h, raw) + b"junk!",
        "field after": fx.make_iptc(w, h, raw) + f(2, 5, b"after"),
        "illegal length": fx.make_iptc(w, h, raw)[:-len(raw) - 2] + b"\x88\x00" + raw,
        "width 0": fx.make_iptc(0, h, raw),
    }
    for mode, lc in (("rgb", (3, 1)), ("cmyk", (4, 1)), ("two layers", (2, 1)),
                     ("3 layers no component", (3, 0))):
        for band in (None, 0, 1, 2, 3, 5):
            out[f"{mode} band {band} raw"] = fx.make_iptc(w, h, raw, *lc, band=band)
            out[f"{mode} band {band} jpeg"] = fx.make_iptc(w, h, jpg, *lc, 5, band=band)
            out[f"{mode} band {band} rgb jpeg"] = fx.make_iptc(w, h, rgbj, *lc, 5, band=band)
    return out


IPTC_CASES = _iptc_cases()


@pytest.mark.parametrize("name", sorted(IPTC_CASES))
def test_iptc_cases(name, tmp_path, monkeypatch):
    """IPTC's gray images (raw behind a ``P5`` header, or any file inside
    compression 5, whose own mode loads), RGB and CMYK with one band merged
    (0 the last one), bands off the mode, layers no mode takes, missing and
    unknown compressions, repeated tags and fields around the image."""
    _same_read(tmp_path, IPTC_CASES[name], monkeypatch)


# ---- seeded sweeps: random header bytes, files cut short ------------------------------

KINDS = ("icns-rle", "icns-png", "blp1-palette", "blp2-dxt1", "blp2-dxt3", "blp2-dxt5",
         "blp1-jpeg", "ftex", "fli", "pcd", "iptc")


def _base(kind: str, seed: int) -> tuple[bytes, int]:
    """A file of the kind at a seeded size, and the span of its header."""
    r = np.random.default_rng(seed)
    w, h = int(r.integers(1, 30)), int(r.integers(1, 24))
    rgb = r.integers(0, 256, (h, w, 3)).astype(np.uint8)
    if kind == "icns-rle":
        return fx.make_icns([(b"is32", fx.icns_rgb(np.resize(rgb, (16, 16, 3)))),
                             (b"s8mk", bytes(256))]), 40
    if kind == "icns-png":
        from PIL import Image

        return fx.make_icns([(b"icp4", _save(Image.fromarray(np.resize(rgb, (16, 16, 3))),
                                             "PNG"))]), 60
    if kind == "blp1-palette":
        return fx.make_blp(w, h, rgb[..., 0].tobytes(), 1, 1, 5, seed % 2,
                           palette=bytes(r.integers(0, 256, 1024).astype(np.uint8))), 160
    if kind.startswith("blp2-dxt"):
        ae = {"1": 0, "3": 1, "5": 7}[kind[-1]]
        nb = ((w + 3) // 4) * ((h + 3) // 4) * (8 if ae == 0 else 16)
        return fx.make_blp(w, h, bytes(r.integers(0, 256, nb).astype(np.uint8)), 2, 1, 2,
                           seed % 2, ae), 150
    if kind == "blp1-jpeg":
        if seed % 2:
            jpg = (fx.GOLDENS / "arith_seq_420.jpg").read_bytes()
            return fx.make_blp(16, 16, jpg[200:], 1, 0, 5, 0, jpeg_header=jpg[:200]), 160
        return (fx.GOLDENS / "blp1_jpeg.blp").read_bytes(), 160
    if kind == "ftex":
        return (fx.make_ftex(fx.bc1_blocks(rgb), w, h, 0) if seed % 2 else
                fx.make_ftex(rgb.tobytes(), w, h, 1)), 40
    if kind == "fli":
        idx = r.integers(0, 256, (h, w)).astype(np.uint8)
        return fx.make_fli(w, h, [fx.fli_color([(0, r.integers(0, 256, (256, 3)))]),
                                  fx.fli_brun(idx)], 0xAF11 + seed % 2), 180
    if kind == "pcd":
        return fx.make_pcd(r.integers(0, 256, (512, 768)), r.integers(0, 256, (256, 384)),
                           r.integers(0, 256, (256, 384)), seed % 4), 0
    return fx.make_iptc(w, h, rgb[..., 0].tobytes(), *((3, 1) if seed % 2 else (1, 0)),
                        band=1 if seed % 2 else None), 70


def _edits(data: bytes, span: int, seed: int) -> list:
    """The file cut at 50 and 90 % and without its last byte, and four
    copies with one to three random bytes of its header changed (a PCD's
    tag and orientation bytes)."""
    rng = np.random.default_rng(seed)
    out = [data[:len(data) // 2], data[:len(data) * 9 // 10], data[:-1]]
    for _ in range(4):
        d = bytearray(data)
        for _ in range(int(rng.integers(1, 4))):
            at = int(rng.integers(0, min(len(data), span))) if span else \
                2048 + int(rng.choice([0, 1, 2, 3, 1538]))
            d[at] = int(rng.integers(0, 256))
        out.append(bytes(d))
    return out


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("kind", KINDS)
def test_seeded_edits(kind, seed, tmp_path, monkeypatch):
    """Files cut short and header bytes changed at random: the same read as
    the JAX package's, or an error in both."""
    pytest.importorskip("PIL")
    data, span = _base(kind, seed)
    for d in _edits(data, span, seed):
        _same_read(tmp_path, d, monkeypatch)
