"""The port's JPEG 2000 codec (``dspfun_tpu_torch/io/jpeg2000.py``,
``native/j2k.cpp``; ROADMAP queue 1, item 8) against the JAX package,
which reads JPEG 2000 through Pillow 12.1 and OpenJPEG 2.5.

* Pillow's own files, over its modes (``L``, ``LA``, ``RGB``, ``RGBA``,
  ``I;16``), both paths (reversible 5/3 and irreversible 9/7, each with
  ``mct`` 0 and 1), every progression order, tiles with tile and image
  offsets, precincts, code-block sizes, every ``num_resolutions``, quality
  layers by rate and by dB, PLT markers, raw codestreams, odd sizes, noise
  and smooth levels: both packages' ``read_image`` as RGB, RGBA and I,
  with cv2 importable and blocked, give the same pixels and depth.
* Files edited by hand: every precision from 1 to 16 bits, signed or not,
  of one component and three; the JP2 colour spaces (sYCC, CMYK, gray
  over four components, unknown ones, ICC profiles); palettes (``pclr``
  with and without ``cmap``, repeated colours, short palettes, RGBA
  palettes, ``PA``); the same pixels, or an error in both.
* Truncated files raise in both packages; a Pillow file edited to carry
  an SOP or EPH flag, a code-block style bit, RGN, POC, COC, QCC or a
  sub-sampled component reads as the JAX package reads it, or raises in
  both (files coded with them: ``test_torch_jpeg2000_more.py``); PPM and
  PPT are refused naming item 8h with and without cv2; headers Pillow
  passes on are passed on.
* ``chip_smoke.J2K_FIXTURES`` (phase 26) holds the sha256 of each file of
  ``torch_codec_fixtures.j2k_fixtures()`` and of the JAX package's read
  of it, and of the two 4K goldens and Pillow's decode of them; the
  goldens are Pillow's bytes.
* The refusal text of ``png.refusal`` names every format the port reads
  or writes itself.
"""

import io
import struct
import sys

import numpy as np
import pytest
from PIL import Image

import chip_smoke
from dspfun_tpu_torch.io import images as timages
from dspfun_tpu_torch.io import jpeg2000, png
from tests import torch_codec_fixtures as fx
from tests.test_torch_other_formats import _pillow_format, _same_read

J2K = "JPEG2000"
PATHS = {"53": {}, "53-mct": {"mct": 1}, "97": {"irreversible": True},
         "97-mct": {"irreversible": True, "mct": 1}}
PROGRESSIONS = ("LRCP", "RLCP", "RPCL", "PCRL", "CPRL")


def _levels(mode: str, h: int, w: int, seed: int, smooth: bool) -> Image.Image:
    """Seeded levels of a mode: noise, or smooth waves with a little noise."""
    rng = np.random.default_rng(seed)
    nch = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4, "I;16": 1}[mode]
    if smooth:
        y, x = np.mgrid[0:h, 0:w]
        a = np.stack([128 + 100 * np.sin(x / 7.0 + seed + c) * np.cos(y / 9.0 - c)
                      for c in range(nch)], -1) + rng.normal(0, 2, (h, w, nch))
    else:
        a = rng.integers(0, 256, (h, w, nch)).astype(np.float64)
    if mode == "I;16":
        a = np.clip(a[..., 0] * 257 + rng.integers(0, 256, (h, w)), 0, 65535)
        return Image.fromarray(a.astype(np.uint16))
    a = np.clip(a, 0, 255).astype(np.uint8)
    return Image.fromarray(a[..., 0] if nch == 1 else a, mode)


def _pillow_cases() -> dict:
    cases = {}
    for i, mode in enumerate(("L", "LA", "RGB", "RGBA", "I;16")):
        for j, (path, kw) in enumerate(PATHS.items()):
            cases[f"{mode}-{path}"] = (mode, 37 + i, 53 - j, 10 * i + j, (i + j) % 2, kw)
    for i, prog in enumerate(PROGRESSIONS):
        for path in ("53", "97-mct"):
            cases[f"{prog}-{path}-tiles-precincts"] = (
                "RGB", 67, 45, 60 + i, i % 2, dict(PATHS[path], progression=prog,
                                                   tile_size=(32, 24), tile_offset=(3, 5),
                                                   offset=(7, 6), precinct_size=(64, 64),
                                                   codeblock_size=(16, 8)))
        cases[f"{prog}-precincts"] = ("RGBA", 70, 90, 70 + i, 1, dict(
            progression=prog, precinct_size=(128, 64), codeblock_size=(8, 32)))
        cases[f"{prog}-layers"] = ("LA", 41, 59, 80 + i, 0, dict(
            progression=prog, quality_layers=[40, 20, 10], quality_mode="rates"))
    for n in range(1, 7):
        cases[f"resolutions-{n}-53"] = ("RGB", 37, 53, 90 + n, n % 2, {"num_resolutions": n})
        if n > 1:
            cases[f"resolutions-{n}-97"] = ("L", 37, 53, 100 + n, n % 2,
                                            {"num_resolutions": n, "irreversible": True})
    for path, kw in PATHS.items():
        cases[f"layers-rates-{path}"] = ("RGB", 45, 61, 110, 0, dict(
            kw, quality_layers=[60, 20, 5], quality_mode="rates"))
        cases[f"layers-db-{path}"] = ("RGBA", 45, 61, 111, 1, dict(
            kw, quality_layers=[30, 40, 50], quality_mode="dB"))
        cases[f"plt-{path}"] = ("RGB", 33, 47, 112, 1, dict(kw, plt=True))
        cases[f"codestream-{path}"] = ("RGB", 33, 47, 113, 0, dict(kw, no_jp2=True))
        cases[f"codeblocks-{path}"] = ("L", 70, 66, 114, 1, dict(kw, codeblock_size=(4, 64)))
    for k, (h, w) in enumerate(((1, 1), (1, 37), (29, 1), (2, 3), (65, 129), (130, 97))):
        for smooth in (0, 1):
            for path in ("53", "97"):
                cases[f"size-{h}x{w}-{'smooth' if smooth else 'noise'}-{path}"] = (
                    "RGB", h, w, 120 + k, smooth, PATHS[path])
    return cases


PILLOW_CASES = _pillow_cases()


def _pillow_file(case: str) -> bytes:
    mode, h, w, seed, smooth, kw = PILLOW_CASES[case]
    buf = io.BytesIO()
    _levels(mode, h, w, seed, bool(smooth)).save(buf, J2K, **kw)
    return buf.getvalue()


def _read_both(tmp_path, data, monkeypatch):
    """Both packages' reads agree; the port picks its JPEG 2000 decoder
    wherever Pillow opens the file as JPEG 2000."""
    if _pillow_format(data) == J2K:
        assert timages._decoder(data) is jpeg2000.decode_j2k
    return _same_read(tmp_path, data, monkeypatch)


@pytest.mark.parametrize("case", sorted(PILLOW_CASES))
def test_pillows_files_read_as_the_jax_package_reads_them(case, tmp_path, monkeypatch):
    jax = _read_both(tmp_path, _pillow_file(case), monkeypatch)
    assert not any(isinstance(j, Exception) for j in jax.values())


# ---- files edited by hand ----------------------------------------------------------


def _small(mode: str = "RGB", seed: int = 5, **kw) -> bytes:
    buf = io.BytesIO()
    _levels(mode, 23, 31, seed, False).save(buf, J2K, **kw)
    return buf.getvalue()


@pytest.mark.parametrize("signed", (0, 1))
@pytest.mark.parametrize("mode", ("L", "RGB"))
@pytest.mark.parametrize("prec", range(1, 17))
def test_every_precision(prec, mode, signed, tmp_path, monkeypatch):
    """SIZ's Ssiz of a lossless file set to each precision (its QCD keeps
    the file decodable): Pillow's unpackers shift, offset and wrap the
    samples to 8 or 16 bits, and both packages read the same."""
    for no_jp2 in (True, False):
        data = fx.set_ssiz(_small(mode, prec, no_jp2=no_jp2), (prec - 1) | signed << 7)
        _read_both(tmp_path, data, monkeypatch)


@pytest.mark.parametrize("path", sorted(PATHS))
@pytest.mark.parametrize("mode", ("L", "RGB"))
def test_pillows_signed_files(mode, path, tmp_path, monkeypatch):
    jax = _read_both(tmp_path, _small(mode, 6, signed=True, **PATHS[path]), monkeypatch)
    assert not any(isinstance(j, Exception) for j in jax.values())


@pytest.mark.parametrize("enumcs", (12, 16, 17, 18, 24, 0, 99))
@pytest.mark.parametrize("mode", ("L", "RGB", "RGBA"))
def test_colour_spaces(mode, enumcs, tmp_path, monkeypatch):
    """The first ``colr`` box's enumerated space: sYCC through Pillow's
    YCbCr tables, CMYK over four components through ``cmyk2rgb``, gray
    over four components as RGBA, unknown spaces as none; Pillow's
    unpacker table refuses the rest (gray over RGB, sRGB over gray, eYCC)."""
    for kw in ({}, {"irreversible": True, "mct": 1}):
        _read_both(tmp_path, fx.set_enumcs(_small(mode, 7, **kw), enumcs), monkeypatch)


def _with_colr(data: bytes, body: bytes) -> bytes:
    """A JP2 with its ``colr`` box replaced (the ``jp2h`` length fixed)."""
    at = data.index(b"colr") - 4
    old = struct.unpack_from(">I", data, at)[0]
    new = fx.j2k_box(b"colr", body)
    out = data[:at] + new + data[at + old:]
    h = out.index(b"jp2h") - 4
    return out[:h] + struct.pack(">I", struct.unpack_from(">I", out, h)[0] + len(new) - old) \
        + out[h + 4:]


@pytest.mark.parametrize("kind", ("icc", "meth-3", "short"))
@pytest.mark.parametrize("mode", ("L", "RGB"))
def test_colr_methods(mode, kind, tmp_path, monkeypatch):
    body = {"icc": b"\x02\x00\x00" + bytes(128), "meth-3": b"\x03\x00\x00" + bytes(4),
            "short": b"\x01\x00\x00"}[kind]
    _read_both(tmp_path, _with_colr(_small(mode, 8), body), monkeypatch)


def _index_codestream(alpha: bool = False) -> bytes:
    rng = np.random.default_rng(9)
    idx = rng.integers(0, 40, (19, 27), np.uint8)
    img = Image.fromarray(np.dstack([idx, rng.integers(0, 256, idx.shape, np.uint8)]), "LA") \
        if alpha else Image.fromarray(idx)
    buf = io.BytesIO()
    img.save(buf, J2K, no_jp2=True)
    return buf.getvalue()


def _pclr_body(entries, depth=7, cmap=True) -> bytes:
    box = fx.j2k_pclr(entries, depth)
    return box if cmap else box[:struct.unpack_from(">I", box)[0]]


PALETTES = {  # name -> (alpha plane, header boxes after ihdr, ihdr bpc)
    "pclr-cmap": (False, lambda: fx.j2k_colr(16) + _pclr_body(fx.j2k_palette(40, 1)), 7),
    "pclr-no-cmap": (False, lambda: fx.j2k_colr(16)
                     + _pclr_body(fx.j2k_palette(40, 2), cmap=False), 7),
    "pclr-short": (False, lambda: fx.j2k_colr(16) + _pclr_body(fx.j2k_palette(10, 3)), 7),
    "pclr-rgba": (False, lambda: fx.j2k_colr(16) + _pclr_body(
        [tuple(int(v) for v in np.random.default_rng(4).integers(0, 256, 4))
         for _ in range(40)]), 7),
    "pclr-12-bit": (False, lambda: fx.j2k_colr(16) + _pclr_body(fx.j2k_palette(40, 5), 11), 7),
    "pclr-9-bit": (False, lambda: fx.j2k_colr(16) + _pclr_body(fx.j2k_palette(40, 5), 8), 7),
    "pclr-gray-colr": (False, lambda: fx.j2k_colr(17) + _pclr_body(fx.j2k_palette(40, 6)), 7),
    "pclr-empty": (False, lambda: fx.j2k_colr(16) + fx.j2k_box(b"pclr", b"\0\0\3\7\7\7"), 7),
    "cmap-alone": (False, lambda: fx.j2k_colr(16) + fx.j2k_box(b"cmap", b"\0\0\1\0"), 7),
    "no-colr": (False, lambda: b"", 7),
    "ihdr-16-bit": (False, lambda: fx.j2k_colr(17), 15),
    "PA": (True, lambda: fx.j2k_colr(16) + _pclr_body(fx.j2k_palette(40, 7)), 7),
    "LA": (True, lambda: fx.j2k_colr(17), 7),
}


@pytest.mark.parametrize("name", sorted(PALETTES))
def test_jp2_headers_made_by_hand(name, tmp_path, monkeypatch):
    """JP2 files written here around Pillow's codestreams: palettes as
    Pillow builds them (a repeated colour keeps its first index, indices
    past the palette read opaque black), and the headers OpenJPEG
    refuses (an empty or short ``pclr``, ``cmap`` without ``pclr``)."""
    alpha, header, bpc = PALETTES[name]
    data = fx.make_jp2(_index_codestream(alpha), header(), 2 if alpha else 1, bpc)
    _read_both(tmp_path, data, monkeypatch)


# ---- truncated files, refusals and identification --------------------------------------

TRUNCATED = {"lossless": {}, "irreversible": {"irreversible": True},
             "tiles": {"tile_size": (16, 16), "no_jp2": True},
             "layers": {"quality_layers": [40, 20, 10], "quality_mode": "rates"}}


@pytest.mark.parametrize("cut", (0.3, 0.7, 0.95, -1, -2, "tile"))
@pytest.mark.parametrize("kind", sorted(TRUNCATED))
def test_truncated_files_raise_in_both(kind, cut, tmp_path, monkeypatch):
    """A file cut at 30, 70 or 95 %, without its last byte, without its
    EOC marker, or at the start of its last tile part: Pillow's "broken
    data stream", a ValueError in the port."""
    data = _small("RGB", 11, **TRUNCATED[kind])
    if cut == "tile":
        at = data.rindex(b"\xff\x90")
    else:
        at = int(len(data) * cut) if isinstance(cut, float) else len(data) + cut
    jax = _read_both(tmp_path, data[:at], monkeypatch)
    assert all(isinstance(j, Exception) for j in jax.values())


def _codestream() -> bytes:
    return _small("RGB", 12, no_jp2=True)


def _set(data: bytes, at: int, value: int) -> bytes:
    return data[:at] + bytes([value]) + data[at + 1:]


def _after_cod(data: bytes, segment: bytes) -> bytes:
    at = data.index(b"\xff\x52")
    at += 2 + struct.unpack_from(">H", data, at + 2)[0]
    return data[:at] + segment + data[at:]


def _in_tile_part(data: bytes, segment: bytes) -> bytes:
    at = data.index(b"\xff\x90")
    psot = struct.unpack_from(">I", data, at + 6)[0]
    out = data[:at + 12] + segment + data[at + 12:]
    return out[:at + 6] + struct.pack(">I", psot + len(segment)) + out[at + 10:]


def _edited(kind: str) -> bytes:
    d = _codestream()
    cod, siz = d.index(b"\xff\x52"), d.index(b"\xff\x51")
    if kind in ("SOP", "EPH"):
        return _set(d, cod + 4, d[cod + 4] | (2 if kind == "SOP" else 4))
    if kind.startswith("style"):
        return _set(d, cod + 12, 1 << int(kind[-1]))
    if kind.startswith("subsampled"):
        return _set(d, siz + 40 + (1 if kind.endswith("x") else 2), 2)
    return {"RGN": lambda: _after_cod(d, b"\xff\x5e\x00\x05\x00\x00\x03"),
            "POC": lambda: _after_cod(d, b"\xff\x5f\x00\x09\x00\x00\x00\x01\x06\x03\x00"),
            "PPM": lambda: _after_cod(d, b"\xff\x60\x00\x03\x00"),
            "PPT": lambda: _in_tile_part(d, b"\xff\x61\x00\x03\x00"),
            "COC": lambda: _after_cod(d, b"\xff\x53\x00\x09\x00\x00\x05\x04\x04\x00\x01"),
            "QCC": lambda: _after_cod(d, b"\xff\x5d\x00\x05\x00\x40\x48"),
            "tile-COC": lambda: _in_tile_part(d, b"\xff\x53\x00\x09\x00\x00\x05\x04\x04\x00\x01"),
            }[kind]()


CARRIED = ("SOP", "EPH", *(f"style{b}" for b in range(6)), "RGN", "POC", "COC", "QCC",
           "tile-COC", "subsampled-x", "subsampled-y")
REFUSED = ("PPM", "PPT")


@pytest.mark.parametrize("kind", CARRIED)
def test_edited_markers_read_as_the_jax_package_reads_them(kind, tmp_path, monkeypatch):
    """Each marker or bit set in a Pillow-written codestream (on data not
    coded with it): the same pixels as the JAX package's, or an error in
    both (EPH without EPH markers, a COC whose code-blocks overrun the
    data), with cv2 importable and blocked."""
    _read_both(tmp_path, _edited(kind), monkeypatch)


@pytest.mark.parametrize("kind", REFUSED)
def test_what_no_pillow_setting_writes_is_refused_by_8h(kind, tmp_path, monkeypatch):
    """Packed packet headers (PPM, PPT) set in a Pillow-written codestream:
    refused naming item 8h, with cv2 importable and blocked (no JPEG 2000
    file reaches cv2)."""
    path = tmp_path / "in.j2k"
    path.write_bytes(_edited(kind))
    for blocked in (False, True):
        if blocked:
            monkeypatch.setitem(sys.modules, "cv2", None)
        with pytest.raises(ValueError, match=r"queue 1, item 8h"):
            timages.read_image(str(path))


def _segment(data: bytes, marker: bytes) -> bytes:
    at = data.index(marker)
    return data[at:at + 2 + struct.unpack_from(">H", data, at + 2)[0]]


@pytest.mark.parametrize("kind", ("COD", "QCD", "COD+QCD", "COM"))
def test_tile_part_markers(kind, tmp_path, monkeypatch):
    """A tile part's own COD and QCD (the main header's again) and a COM
    in a tile part: read as Pillow reads them."""
    d = _small("RGB", 14, no_jp2=True, tile_size=(16, 16))
    segs = {"COD": _segment(d, b"\xff\x52"), "QCD": _segment(d, b"\xff\x5c"),
            "COM": b"\xff\x64\x00\x06\x00\x01hi"}
    extra = b"".join(segs[k] for k in kind.split("+"))
    jax = _read_both(tmp_path, _in_tile_part(d, extra), monkeypatch)
    assert not any(isinstance(j, Exception) for j in jax.values())


def _resized_jp2(dh: int, dw: int) -> bytes:
    """A JP2 whose ``ihdr`` size differs from its codestream's."""
    data = fx.make_jp2(_codestream(), fx.j2k_colr(16), 3, 7)
    at = data.index(b"ihdr") + 4
    h, w = struct.unpack_from(">II", data, at)
    return data[:at] + struct.pack(">II", h + dh, w + dw) + data[at + 8:]


def _jp2_prefix(*boxes: bytes) -> bytes:
    return fx.j2k_box(b"jP  ", b"\x0d\x0a\x87\x0a") + b"".join(boxes)


HEADERS = {
    "short-siz": lambda: b"\xff\x4f\xff\x51\x00",
    "five-components": lambda: (lambda d: d[:d.index(b"\xff\x51") + 38] + b"\x00\x05"
                                + d[d.index(b"\xff\x51") + 40:])(_codestream()),
    "zero-width": lambda: (lambda d: d[:d.index(b"\xff\x51") + 6] + bytes(4)
                           + d[d.index(b"\xff\x51") + 10:])(_codestream()),
    "jp2-signature-only": lambda: fx.j2k_box(b"jP  ", b"\x0d\x0a\x87\x0a"),
    "jp2-bad-box-length": lambda: _jp2_prefix(struct.pack(">I4s", 4, b"ftyp")),
    "jp2-no-jp2h": lambda: _jp2_prefix(fx.j2k_box(b"ftyp", b"jp2 \0\0\0\0jp2 ")),
    "jp2-empty-jp2h": lambda: _jp2_prefix(fx.j2k_box(b"jp2h", b"")),
    "jp2-no-ihdr": lambda: _jp2_prefix(fx.j2k_box(b"jp2h", fx.j2k_colr(16))),
    "jp2-box-to-end": lambda: _jp2_prefix(struct.pack(">I4s", 0, b"jp2h")),
    "jp2-ihdr-taller": lambda: _resized_jp2(1, 0),
    "jp2-ihdr-narrower": lambda: _resized_jp2(0, -1),
    "jp2-short-resc": lambda: fx.make_jp2(_codestream(), fx.j2k_colr(16) + fx.j2k_box(
        b"res ", fx.j2k_box(b"resc", struct.pack(">HHHH", 1, 1, 1, 1))), 3, 7),
}


@pytest.mark.parametrize("name", sorted(HEADERS))
def test_headers_pillow_passes_on_or_refuses(name, tmp_path, monkeypatch):
    """Headers the plugin passes on (Pillow then finds no format), or whose
    open fails: an error in both packages, and the same format found."""
    data = HEADERS[name]()
    pil = _pillow_format(data)
    try:
        port = timages._decoder(data)
    except ValueError as e:
        port = e
    assert isinstance(pil, Exception) == isinstance(port, Exception), (pil, port)
    jax = _read_both(tmp_path, data, monkeypatch)
    assert all(isinstance(j, Exception) for j in jax.values())


def test_open_passes_on_where_pillow_does():
    """``open_j2k`` raises ``rawimg.Skip`` (Pillow's ``SyntaxError``) for
    the plugin's failures to open and a ValueError for its other errors."""
    from dspfun_tpu_torch.io import rawimg

    with pytest.raises(rawimg.Skip):
        jpeg2000.open_j2k(HEADERS["five-components"]())
    with pytest.raises(rawimg.Skip):
        jpeg2000.open_j2k(HEADERS["jp2-bad-box-length"]())
    with pytest.raises(ValueError) as e:
        jpeg2000.open_j2k(HEADERS["jp2-no-jp2h"]())
    assert not isinstance(e.value, rawimg.Skip)
    info = jpeg2000.open_j2k(_small("RGBA", 13))
    assert (info["codec"], info["size"], info["mode"]) == ("jp2", (31, 23), "RGBA")


# ---- phase 26's goldens and digests ----------------------------------------------------


def test_phase_26_goldens_are_pillows():
    """``j2k_goldens()`` remakes each golden byte for byte, each at most
    256 KiB, and ``j2k_fixtures()`` is made the same way again from them."""
    made = fx.j2k_goldens()
    assert tuple(made) == fx.j2k_golden_names()
    for name, data in made.items():
        assert (fx.GOLDENS / name).read_bytes() == data, name
        assert len(data) <= 256 * 1024, name
    assert fx.j2k_fixtures(made) == fx.j2k_fixtures()
    assert sorted(fx.j2k_fixtures()) == sorted(n for n in chip_smoke.J2K_FIXTURES
                                               if n not in fx.J2K_4K)


@pytest.mark.parametrize("name", sorted(chip_smoke.J2K_FIXTURES))
def test_phase_26_digests(name, tmp_path):
    """``chip_smoke.J2K_FIXTURES``: the file's sha256 and the JAX package's
    RGBA read of it (Pillow's RGB decode for the 4K files), which the
    port's read gives too."""
    if name in fx.J2K_4K:
        data = (fx.GOLDENS / name).read_bytes()
        assert fx.j2k_4k_digest(data) == chip_smoke.J2K_FIXTURES[name]
        arr, depth = jpeg2000.decode_j2k(data)
        assert (depth, fx.rgb_digest(arr)) == (8, chip_smoke.J2K_FIXTURES[name][1])
        return
    data = fx.j2k_fixtures()[name]
    assert fx.other_digests(data) == chip_smoke.J2K_FIXTURES[name]
    path = tmp_path / name
    path.write_bytes(data)
    pixels = timages.read_image(str(path), channels="RGBA").pixels
    assert fx.rgba_digest(pixels) == chip_smoke.J2K_FIXTURES[name][1]


# ---- the refusal text -------------------------------------------------------------------


def test_refusal_names_every_format_the_port_carries():
    """``png.refusal``'s text names each format ``_PILLOW_ORDER`` reads with
    the port's own codecs (each claim that is not an item-8h refusal) and
    each format ``_NATIVE_WRITERS`` and ``_NAMED_WRITERS`` write, with PNG;
    and none of the formats refused by 8h (but as the refused one)."""
    text = str(png.refusal("X input", "h")).lower()
    read = {name for name, claim in timages._PILLOW_ORDER
            if not claim.__qualname__.startswith("_refused")}
    written = set(timages._NATIVE_WRITERS) | set(timages._NAMED_WRITERS)
    aliases = {"PPM": "pnm"}
    for name in sorted(read | written | {"PNG"}):
        assert aliases.get(name, name.lower()) in text, name
    assert "jpeg 2000" in text and "psd" in text and "dds" in text
    refused = {name for name, claim in timages._PILLOW_ORDER
               if claim.__qualname__.startswith("_refused")}
    for name in refused:
        assert f" {name.lower()}," not in text and f" {name.lower()} " not in text, name
