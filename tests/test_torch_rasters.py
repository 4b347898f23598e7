"""Item 8h's header-and-rows rasters (g1's reads) in the port's own code
(``dspfun_tpu_torch/io/rasters.py``, its loops in ``native/rawimg.cpp``)
against the JAX package, which reads them through Pillow 12.1's plugins:
FITS, Sun raster, XBM, XPM, MSP, SPIDER, PIXAR, McIdas, XV thumbnail, GBR
and IMT.

* ``chip_smoke.RASTER_FIXTURES`` (phase 30a): the goldens of
  ``torch_codec_fixtures.raster_goldens()`` (Pillow's XBM, MSP and SPIDER
  writes, the numpy writers' files of every other kind and variant) remade
  byte for byte, their digests, and both packages' reads of them;
* ``chip_smoke.RASTER_4K_DIGESTS`` (phase 30b): the 3840x2160 Sun raster
  and FITS the numpy writers make on the card, held to the JAX package's
  read of the same bytes;
* every kind and variant from the writers, Pillow's own writes of XBM,
  MSP and SPIDER read back at several sizes, and seeded edits: random
  header bytes and files cut short.

Each compares both packages' ``read_image`` (RGB, RGBA and I, with cv2
importable and blocked): the same pixels and depth, or an error in both.
No file of these kinds reaches cv2 or a refusal: each claimed one is
taken by its decoder in ``io/rasters.py``.
"""

import hashlib
import io

import numpy as np
import pytest

import chip_smoke
from dspfun_tpu.io import images as jimages
from dspfun_tpu_torch.io import images as timages
from dspfun_tpu_torch.io import rasters
from tests import torch_codec_fixtures as fx
from tests.test_torch_other_formats import _same_read

NAMES = fx.RASTER_NAMES


@pytest.fixture(scope="module")
def remade():
    pytest.importorskip("PIL")
    return fx.raster_goldens()


def _golden(name: str) -> bytes:
    return (fx.GOLDENS / name).read_bytes()


def _ok(jax) -> None:
    assert not any(isinstance(j, Exception) for j in jax.values()), jax


def _read_both(tmp_path, data, monkeypatch, decoder=None):
    """Both packages' reads agree; where the JAX package opens the file,
    the port takes it with ``decoder`` (or any decoder of io/rasters.py)."""
    jax = _same_read(tmp_path, data, monkeypatch)
    if decoder is not None:
        assert timages._decoder(data) is decoder
    return jax


# ---- the goldens -------------------------------------------------------------------


@pytest.mark.parametrize("name", NAMES)
def test_goldens_are_remade(name, remade):
    """Each golden is what its writer (Pillow for XBM, MSP version 1 and
    SPIDER, numpy for the rest) makes again, byte for byte."""
    assert remade[name] == _golden(name), name
    assert sum(len(_golden(n)) for n in NAMES) < 200_000


@pytest.mark.parametrize("name", NAMES)
def test_phase_30_digests(name):
    """``chip_smoke.RASTER_FIXTURES``: the file's sha256 and the JAX
    package's RGBA read of it."""
    assert fx.other_digests(_golden(name)) == chip_smoke.RASTER_FIXTURES[name]
    assert sorted(chip_smoke.RASTER_FIXTURES) == sorted(NAMES)


@pytest.mark.parametrize("name", NAMES)
def test_goldens_read_as_the_jax_package_reads_them(name, tmp_path, monkeypatch):
    """Each golden takes its decoder and reads as the JAX package reads it."""
    decoder = chip_smoke._raster_decoder(rasters, name)
    _ok(_read_both(tmp_path, _golden(name), monkeypatch, decoder))


@pytest.mark.parametrize("kind", sorted(chip_smoke.RASTER_4K_DIGESTS))
def test_phase_30_4k_digests(kind, tmp_path):
    """The 3840x2160 files phase 30b makes with the numpy writers: their
    sha256 and the JAX package's RGB read, as ``RASTER_4K_DIGESTS`` holds
    them."""
    data = fx.raster_4k(kind)
    path = tmp_path / kind
    path.write_bytes(data)
    got = (hashlib.sha256(data).hexdigest(),
           fx.rgba_digest(jimages.read_image(str(path), channels="RGB").pixels))
    assert got == chip_smoke.RASTER_4K_DIGESTS[kind]


# ---- every kind and variant from the writers --------------------------------------


def _planes(seed: int, hw=(23, 37)):
    rng = np.random.default_rng(seed)
    h, w = hw
    return rng, h, w, rng.integers(0, 256, (h, w))


def _variants() -> dict:
    rng, h, w, g8 = _planes(5)
    g16 = rng.integers(-32768, 32767, (h, w))
    g32 = rng.integers(-2 ** 31, 2 ** 31 - 1, (h, w))
    f = rng.normal(100, 120, (h, w))
    rows = lambda n: rng.integers(0, 256, (h, n)).astype(np.uint8)  # noqa: E731
    pal = bytes(rng.integers(0, 256, 3 * 200).astype(np.uint8))
    bits = rng.random((h, w)) < 0.4
    run = rows(3 * w)
    run[:, :40] = 0x80      # runs and lone bytes of the RLE escape
    run[::3, 41] = 0x80
    idx = rng.integers(0, 5, (h, w))
    cols = [tuple(int(v) for v in rng.integers(0, 256, 3)) for _ in range(300)]
    return {
        **{f"fits-{b}": (fx.make_fits, (s, b)) for b, s in
           ((8, g8), (16, g16), (32, g32), (-32, f), (-64, f))},
        "fits-naxis1": (fx.make_fits, (g16[:, :1], 16), dict(naxis=1)),
        "fits-extra-cards": (fx.make_fits, (g8, 8), dict(cards=[("BZERO", 32768),
                                                                  ("COMMENT", None)])),
        **{f"fits-gzip-{b}": (fx.make_fits_gzip, (s, b)) for b, s in
           ((8, g8), (16, g16), (32, g32), (-32, g16))},
        **{f"sun-{d}-type{t}": (fx.make_sun, (rows((w * d + 7) // 8), w, d), dict(ftype=t))
           for d in (1, 4, 8, 24, 32) for t in (0, 1, 2, 3, 4, 5)},
        "sun-rle-escapes": (fx.make_sun, (run, w, 24), dict(ftype=2)),
        "sun-8-map": (fx.make_sun, (rows(w), w, 8), dict(palette=pal)),
        "sun-8-short-map": (fx.make_sun, (rows(w), w, 8), dict(palette=pal[:30])),
        "sun-4-map-rle": (fx.make_sun, (rows((w + 1) // 2), w, 4), dict(palette=pal[:48],
                                                                          ftype=2)),
        "sun-1-map": (fx.make_sun, (rows((w + 7) // 8), w, 1), dict(palette=pal[:6])),
        "sun-24-map": (fx.make_sun, (rows(3 * w), w, 24), dict(palette=pal[:6])),
        "sun-map-type-2": (fx.make_sun, (rows(w), w, 8), dict(palette=pal[:6], maptype=2)),
        "sun-map-1027": (fx.make_sun, (rows(w), w, 8), dict(palette=pal[:342] * 3 + b"a")),
        "sun-type-6": (fx.make_sun, (rows(w), w, 8), dict(ftype=6)),
        "sun-depth-16": (fx.make_sun, (rows(2 * w), w, 16)),
        "xpm-p": (fx.make_xpm, (idx, cols[:5])),
        "xpm-none": (fx.make_xpm, (idx, cols[:5]), dict(none_key=b"~")),
        "xpm-two-chars": (fx.make_xpm, (idx, cols[:5], 2)),
        "xpm-no-pixels-line": (fx.make_xpm, (idx, cols[:5]), dict(pixels_line=False)),
        "xpm-rgb": (fx.make_xpm, (rng.integers(0, 300, (h, w)), cols, 2)),
        "xpm-rgb-none": (fx.make_xpm, (rng.integers(0, 300, (h, w)), cols, 3),
                         dict(none_key=b"~~~")),
        "msp-1": (fx.make_msp, (np.packbits(bits, axis=1), w, 1)),
        "msp-2": (fx.make_msp, (np.packbits(bits, axis=1), w)),
        "msp-2-blank-rows": (fx.make_msp, (np.packbits(bits, axis=1), w), dict(blank=(0, 7))),
        "spider-be": (fx.make_spider, (f.astype(np.float32),)),
        "spider-le": (fx.make_spider, (f.astype(np.float32), "<")),
        "spider-stack": (fx.make_spider, (f.astype(np.float32), ">", 3)),
        "pixar": (fx.make_pixar, (rng.integers(0, 256, (h, w, 3)),)),
        "pixar-not-rgb": (fx.make_pixar, (rng.integers(0, 256, (h, w, 3)), 3, 1)),
        "mcidas-1": (fx.make_mcidas, (g8, 1)),
        "mcidas-2": (fx.make_mcidas, (g16 & 0xFFFF, 2), dict(prefix=4)),
        "mcidas-4": (fx.make_mcidas, (g32, 4), dict(prefix=8, offset=300)),
        "xv": (fx.make_xvthumb, (rows(w),)),
        "xv-no-comments": (fx.make_xvthumb, (rows(w), ())),
        "gbr-1": (fx.make_gbr, (rows(w), 1)),
        "gbr-2": (fx.make_gbr, (rows(w), 2)),
        "gbr-2-rgba": (fx.make_gbr, (rng.integers(0, 256, (h, w, 4)), 2)),
        "imt": (fx.make_imt, (rows(w),)),
        "imt-no-comment": (fx.make_imt, (rows(w), ())),
    }


VARIANTS = _variants()


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_writers_read_as_the_jax_package_reads_them(name, tmp_path, monkeypatch):
    """Each kind and variant the writers make: the same read as the JAX
    package's, or an error in both (a colour map on 1- or 24-bit Sun
    rasters, a map longer than 1024 or of type 2, Sun type 6 and depth 16,
    GZIP_1 of floats, an RGB XPM with a ``None`` colour, PIXAR that is not
    RGB)."""
    make, args, *kw = VARIANTS[name]
    _read_both(tmp_path, make(*args, **(kw[0] if kw else {})), monkeypatch)


@pytest.mark.parametrize("size", ((1, 1), (7, 3), (16, 16), (33, 9), (64, 41)))
@pytest.mark.parametrize("fmt", ("XBM", "MSP", "SPIDER"))
def test_pillows_writes_read_back(fmt, size, tmp_path, monkeypatch):
    """Pillow's own XBM (with a hotspot), MSP and SPIDER files at several
    sizes: the port reads what the JAX package reads."""
    from PIL import Image

    rng = np.random.default_rng(size[0] * 100 + size[1])
    w, h = size
    if fmt == "SPIDER":
        img = Image.fromarray(rng.normal(120, 80, (h, w)).astype(np.float32))
    else:
        img = Image.fromarray(rng.random((h, w)) < 0.5)
    buf = io.BytesIO()
    img.save(buf, fmt, **({"hotspot": (w // 2, h // 2)} if fmt == "XBM" else {}))
    decoder = {"XBM": rasters.decode_xbm, "MSP": rasters.decode_msp,
               "SPIDER": rasters.decode_spider}[fmt]
    _ok(_read_both(tmp_path, buf.getvalue(), monkeypatch, decoder))


# ---- seeded edits: random header bytes, files cut short ---------------------------

KINDS = ("fits", "fits-gzip", "sun", "sun-rle", "xbm", "xpm", "msp-1", "msp-2", "spider",
         "pixar", "mcidas", "xv", "gbr", "imt")


def _base(kind: str, seed: int) -> bytes:
    rng, h, w, g8 = _planes(seed, (int(np.random.default_rng(seed).integers(1, 20)),
                                   int(np.random.default_rng(seed + 1).integers(1, 30))))
    if kind == "fits":
        return fx.make_fits(g8, int(rng.choice([8, 16, 32, -32, -64])))
    if kind == "fits-gzip":
        return fx.make_fits_gzip(g8, int(rng.choice([8, 16, 32])))
    if kind in ("sun", "sun-rle"):
        d = int(rng.choice([1, 4, 8, 24, 32]))
        rows = rng.integers(0, 256, (h, (w * d + 7) // 8)).astype(np.uint8)
        rows[:, :rows.shape[1] // 2] = rows[:, :1]
        return fx.make_sun(rows, w, d, ftype=2 if kind == "sun-rle" else 1)
    if kind == "xbm":
        from PIL import Image

        return fx._save(Image.fromarray(g8 > 128), "XBM")
    if kind == "xpm":
        return fx.make_xpm(g8 // 64, [(k, 2 * k, 3 * k) for k in range(4)])
    if kind.startswith("msp"):
        return fx.make_msp(np.packbits(g8 > 100, axis=1), w, int(kind[-1]))
    if kind == "spider":
        return fx.make_spider(g8.astype(np.float32), "<" if seed % 2 else ">", seed % 3)
    if kind == "pixar":
        return fx.make_pixar(rng.integers(0, 256, (h, w, 3)))
    if kind == "mcidas":
        n = int(rng.choice([1, 2, 4]))
        return fx.make_mcidas(g8, n, prefix=int(rng.integers(0, 5)))
    if kind == "xv":
        return fx.make_xvthumb(g8)
    if kind == "gbr":
        return fx.make_gbr(g8, int(rng.choice([1, 2])))
    return fx.make_imt(g8)


def _edits(data: bytes, seed: int) -> list:
    """The file cut at 50 and 90 % and without its last byte, and four
    copies with one to three random bytes of its header changed."""
    rng = np.random.default_rng(seed)
    out = [data[:len(data) // 2], data[:len(data) * 9 // 10], data[:-1]]
    span = min(len(data), 430 if data.startswith(b"\x80\xe8") else 120)
    for _ in range(4):
        d = bytearray(data)
        for _ in range(int(rng.integers(1, 4))):
            d[int(rng.integers(0, span))] = int(rng.integers(0, 256))
        out.append(bytes(d))
    return out


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("kind", KINDS)
def test_seeded_edits(kind, seed, tmp_path, monkeypatch):
    """Files cut short and header bytes changed at random: the same read as
    the JAX package's, or an error in both."""
    pytest.importorskip("PIL")
    for data in _edits(_base(kind, seed), seed):
        _read_both(tmp_path, data, monkeypatch)


def test_zero_led_files_pass_the_iptc_plugin_on(tmp_path, monkeypatch):
    """A file whose first bytes are zero ends Pillow's IPTC field walk with
    no (3, 60) field: a ``KeyError`` there passes the file on to the next
    plugins (McIdas here) rather than failing the open."""
    data = _golden("raster_mcidas8.area")
    assert data.startswith(bytes(7))
    _ok(_read_both(tmp_path, data, monkeypatch, rasters.decode_mcidas))
