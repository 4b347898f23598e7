"""g3's writes in the port (``io/documents.py``: EPS and PDF;
``io/jpeg2000.py:encode_jpeg2000`` with ``native/j2k.cpp``'s encoder) and
F5 (``io/images.py``'s ``_PILLOW_SAVES`` and ``_PILLOW_FAILS``) against the
JAX package's ``write_image``, which saves through Pillow 12.1 and
OpenJPEG 2.5.4:

* ``.jpeg2000`` as ``RGB``, ``RGBA`` and ``I;16`` byte-equal to the JAX
  package's at sizes where the level cut, empty code-blocks and one-sample
  rows and columns show, in five kinds of content, and over a seeded sweep
  of sizes up to 160 pixels; the same bytes at 1 and 8 host threads; the
  port's own reader gives the pixels back exactly;
* ``.pdf`` as ``RGB`` (the JPEG inside) and ``RGBA`` (the JP2 inside) with
  ``time.gmtime`` fixed, the stem in the title with spaces, parentheses, a
  backslash and letters outside ASCII;
* ``.eps`` as ``RGB`` at widths that end the hex lines anywhere;
* the goldens of ``chip_smoke.DOCUMENT_GOLDENS`` (phase 32a) the JAX
  package's bytes and the port's;
* F5: for every extension Pillow registers, ``.jpeg2000`` and one Pillow
  does not know, as ``RGB``, ``RGBA`` and ``I;16``: the same bytes, or the
  same exception class and message, and no file left.
"""

import time
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

import chip_smoke
from dspfun_tpu.io import images as jimages
from dspfun_tpu_torch.io import documents, jpeg2000
from dspfun_tpu_torch.io import images as timages
from tests import torch_codec_fixtures as fx

Image.init()
KINDS = {"RGB": ("RGB", 8), "RGBA": ("RGBA", 8), "I;16": ("I", 16)}
CLOCK = time.struct_time((2024, 2, 29, 23, 59, 58, 3, 60, 0))


@pytest.fixture
def fixed_clock(monkeypatch):
    """``time.gmtime`` at CLOCK for both packages' PDF dates."""
    monkeypatch.setattr(time, "gmtime", lambda *a: CLOCK)


def _pixels(arr: np.ndarray) -> np.ndarray:
    """Float pixels that ``write_image`` quantises back to ``arr``."""
    return arr[..., None] / 65535.0 if arr.dtype == np.uint16 else arr / 255.0


def _write(mod, path, pix, channels, depth):
    try:
        mod.write_image(str(path), pix, channels=channels, depth=depth)
    except Exception as e:  # noqa: BLE001 — Pillow's own error, whatever its class
        return type(e), str(e), path.exists()
    return path.read_bytes()


def _both(tmp_path, name, pix, kind):
    """Each package's write of ``pix`` to ``name`` (one directory each, so
    that a name inside the file is the same)."""
    ch, depth = KINDS[kind]
    out = []
    for sub, mod in (("jax", jimages), ("port", timages)):
        (tmp_path / sub).mkdir(exist_ok=True)
        out.append(_write(mod, tmp_path / sub / name, pix, ch, depth))
    return out


def _content(kind: str, h: int, w: int, what: str, seed: int) -> np.ndarray:
    top, dtype = (65535, np.uint16) if kind == "I;16" else (255, np.uint8)
    shape = (h, w) if kind == "I;16" else (h, w, len(kind))
    rng = np.random.default_rng(seed)
    if what == "noise":
        a = rng.integers(0, top + 1, shape)
    elif what == "smooth":
        y, x = np.mgrid[0:h, 0:w]
        a = np.rint((np.sin(x / 7.0) + np.cos(y / 5.0) + 2) / 4 * top)
        a = a if kind == "I;16" else np.repeat(a[..., None], len(kind), -1)
    else:
        a = np.full(shape, {"constant": top // 3, "zero": 0, "max": top}[what])
    return a.astype(dtype)


J2K_SIZES = [(1, 1), (2, 3), (1, 40), (40, 1), (31, 32), (33, 33), (64, 64), (65, 130)]


@pytest.mark.parametrize("what", ["noise", "smooth", "constant", "zero", "max"])
@pytest.mark.parametrize("size", J2K_SIZES)
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_jpeg2000_writes_are_the_jax_packages_bytes(kind, size, what, tmp_path):
    """Lossless JP2 of each mode: the level cut at the smaller side (0 at
    1 x 1 and 1 x N, 1 at 2 x 3, 4 at 31 x 32, 5 from 32), code-blocks of no
    pass (constant and zero content), several code-blocks a band (65 x
    130), 16-bit samples: the JAX package's bytes."""
    h, w = size
    arr = _content(kind, h, w, what, h * 1000 + w)
    want, got = _both(tmp_path, "a.jpeg2000", _pixels(arr), kind)
    assert isinstance(want, bytes) and got == want


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_a_smooth_300x200_jpeg2000_is_the_jax_packages(kind, tmp_path):
    arr = _content(kind, 200, 300, "smooth", 7)
    want, got = _both(tmp_path, "s.jpeg2000", _pixels(arr), kind)
    assert isinstance(want, bytes) and got == want


@pytest.mark.parametrize("seed", range(24))
def test_seeded_jpeg2000_sweep(seed, tmp_path):
    """Random sizes up to 160 pixels, random modes and sample ranges (few
    bit-planes to all of them), ramps under the noise in a third of the
    cases."""
    rng = np.random.default_rng(2900 + seed)
    h, w = (int(v) for v in rng.integers(1, 161, 2))
    kind = sorted(KINDS)[seed % 3]
    bits = int(rng.integers(1, 17 if kind == "I;16" else 9))
    shape = (h, w) if kind == "I;16" else (h, w, len(kind))
    a = rng.integers(0, 1 << bits, shape)
    if seed % 3 == 0:
        y, x = np.mgrid[0:h, 0:w]
        ramp = (x * 3 + y * 2) % (1 << bits)
        a = a // 4 + (ramp if kind == "I;16" else ramp[..., None])
    arr = np.clip(a, 0, 65535 if kind == "I;16" else 255).astype(
        np.uint16 if kind == "I;16" else np.uint8)
    want, got = _both(tmp_path, "r.jpeg2000", _pixels(arr), kind)
    assert isinstance(want, bytes) and got == want


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_jpeg2000_reads_back_exactly_and_threads_do_not_matter(kind, tmp_path):
    """The port's JP2 through the port's own reader (``decode_j2k`` and
    ``read_image``) gives the samples back; 1 and 8 host threads write the
    same bytes."""
    arr = _content(kind, 150, 201, "noise", 5) // (1 if kind == "I;16" else 2)
    data = jpeg2000.encode_jpeg2000(arr, threads=1)
    assert jpeg2000.encode_jpeg2000(arr, threads=8) == data == jpeg2000.encode_jpeg2000(arr)
    back, depth = jpeg2000.decode_j2k(data)
    if kind == "I;16":
        assert depth == 16 and back.dtype == np.uint16
        np.testing.assert_array_equal(back.reshape(arr.shape), arr)
    else:
        assert depth == 8
        np.testing.assert_array_equal(back[..., :len(kind)], arr)
    path = tmp_path / "b.jpeg2000"
    timages.write_image(str(path), _pixels(arr), channels=KINDS[kind][0], depth=KINDS[kind][1])
    img = timages.read_image(str(path), channels=KINDS[kind][0])
    top = 65535 if kind == "I;16" else 255
    assert img.depth == KINDS[kind][1]
    np.testing.assert_array_equal(np.rint(img.pixels * top).reshape(arr.shape), arr)


def test_the_com_marker_names_pillows_openjpeg():
    from PIL import features

    assert features.version("jpg_2000") == jpeg2000.OPENJPEG_VERSION
    data = jpeg2000.encode_jpeg2000(np.zeros((4, 4, 3), np.uint8))
    assert f"Created by OpenJPEG version {jpeg2000.OPENJPEG_VERSION}".encode() in data


STEMS = ["plain", "a b", "p(q)r", "(", "x)", "back\\slash", "ünï cödé", "€ 日本"]


@pytest.mark.parametrize("stem", STEMS)
@pytest.mark.parametrize("kind", ["RGB", "RGBA"])
def test_pdf_writes_are_the_jax_packages_bytes(kind, stem, tmp_path, fixed_clock):
    """One page: the JPEG (``RGB``) or the JP2 (``RGBA``) of the pixels, the
    stem in the title (UTF-16BE, ``(``, ``)`` and ``\\`` escaped, in its
    bytes too), the fixed clock as both dates, the offsets."""
    arr = _content(kind, 23, 41, "noise", len(stem)) // 2 + 40
    want, got = _both(tmp_path, f"{stem}.pdf", _pixels(arr), kind)
    assert isinstance(want, bytes) and got == want
    stream = jpeg2000.encode_jpeg2000(arr) if kind == "RGBA" else \
        timages._jpeg.encode_jpeg(arr)
    assert stream in got


def test_pdf_dates_are_read_from_the_clock(tmp_path, monkeypatch):
    """Both dates are ``time.gmtime()`` at the call, as Pillow reads them
    (two readings: creation, then modification)."""
    ticks = iter([CLOCK, time.struct_time((2030, 1, 1, 0, 0, 0, 1, 1, 0))])
    monkeypatch.setattr(time, "gmtime", lambda *a: next(ticks))
    data = documents.encode_pdf(np.zeros((2, 2, 3), np.uint8), "/x/y/t.pdf")
    assert b"/Title (\xfe\xff\x00t)\n/CreationDate (D:20240229235958Z)\n" \
           b"/ModDate (D:20300101000000Z)\n" in data


EPS_SIZES = [(1, 1), (1, 13), (1, 53), (3, 53), (2, 13), (7, 13), (40, 39), (100, 200),
             (5, 26)]


@pytest.mark.parametrize("size", EPS_SIZES)
def test_eps_writes_are_the_jax_packages_bytes(size, tmp_path):
    """Hex lines of 78 digits across rows, the last one short or full, and
    Pillow's header and trailer."""
    h, w = size
    arr = _content("RGB", h, w, "noise", w)
    want, got = _both(tmp_path, "e.eps", _pixels(arr), "RGB")
    assert isinstance(want, bytes) and got == want
    hexes = got.split(b"colorimage\n")[1].split(b"\n%%%%EndBinary")[0]
    assert bytes.fromhex(hexes.replace(b"\n", b"").decode()) == arr.tobytes()


@pytest.mark.parametrize("name", sorted(chip_smoke.DOCUMENT_GOLDENS))
def test_goldens_are_the_jax_packages_and_the_ports(name, tmp_path, monkeypatch):
    """Phase 32a's goldens: each is the JAX package's write of its seeded
    pixels (the PDFs at ``chip_smoke.DOCUMENT_CLOCK``) and the port's."""
    clock = time.struct_time(chip_smoke.DOCUMENT_CLOCK)
    monkeypatch.setattr(time, "gmtime", lambda *a: clock)
    mode, hw = chip_smoke.DOCUMENT_GOLDENS[name]
    arr = fx.g3_pixels(mode, hw)
    golden = (Path(__file__).parent / "goldens" / name).read_bytes()
    want, got = _both(tmp_path, name, _pixels(arr), mode)
    assert want == golden and got == golden


# ---- F5: what Pillow cannot save, raised as Pillow raises it -------------------------

F5_EXTS = sorted(Image.registered_extensions()) + [".jpeg2000", ".xyz"]


@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("ext", F5_EXTS)
def test_f5_every_extension_writes_or_fails_as_in_the_jax_package(ext, kind, tmp_path,
                                                                  fixed_clock):
    """Every extension Pillow registers names the format of its upper-case
    text (``.tif`` is ``TIF``): where Pillow has no save handler by that
    name, ``KeyError(name)``; the stub handlers (WMF, BUFR, GRIB) ``OSError:
    ... save handler not installed``; JPEG and MPO of ``RGBA`` or ``I;16``
    ``OSError: cannot write mode ... as JPEG``, and BMP, DIB, DDS and TGA of
    ``I;16`` their ``OSError``s; the rest the JAX package's bytes.  No file
    is left where the write fails.  AVIF stays refused naming item 8h."""
    arr = _content(kind, 8, 8, "noise", 5)
    want, got = _both(tmp_path, f"o{ext}", _pixels(arr), kind)
    if ext == ".avif":
        assert isinstance(want, bytes)
        assert got[0] is ValueError and "queue 1, item 8h" in got[1] and got[2] is False
        return
    assert got == want
    if not isinstance(want, bytes):
        assert want[2] is False
