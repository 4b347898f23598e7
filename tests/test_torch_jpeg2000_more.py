"""JPEG 2000's rest in the port's codec (``dspfun_tpu_torch/io/jpeg2000.py``,
``native/j2k.cpp``; ROADMAP queue 1, item 8's rest, e1) against the JAX
package, which reads JPEG 2000 through Pillow 12.1 and OpenJPEG 2.5.4.

The files are coded with what they pin by Pillow's own OpenJPEG (the
library that decodes for the JAX package), driven through ctypes by
``torch_codec_fixtures.j2k_write``:

* ``chip_smoke.J2K_MORE_FIXTURES`` (phase 29): the goldens of
  ``j2k_more_goldens()`` (POC in the main header, in every tile and over
  layers, Pillow's ``cinema4k-24`` at 4096x2160; SOP and EPH; each
  code-block style switch alone and all six under both wavelets; RGN;
  COC and QCC in the main and tile-part headers; sub-sampled components;
  a 4K file in bypass with every pass terminated) remade byte for byte,
  their digests, and both packages' reads of them;
* edits of them by hand, per marker: POCs moved, joined, clamped and
  unknown; SOP and EPH missing, damaged or flagged without markers; RGN
  in tile-part headers and bad; COC, QCC, COD and QCD in every order in
  main and tile-part headers; MCT over sub-sampled or mixed-wavelet
  components; sub-sampled gray and gray + alpha;
* a seeded sweep of small files over every switch (style bits, wavelet,
  progression, one to three POCs, layers, SOP/EPH, RGN shift, tiles,
  precincts, code-block sizes, one to four components) and one of
  sub-sampled components (offsets, tiles, precisions, JP2).

Each compares both packages' ``read_image`` (RGB, RGBA and I, with cv2
importable and blocked; RGB for the 4K files): the same pixels and depth,
or an error in both.  Without Pillow's ``libopenjp2`` the regeneration
and the sweeps skip; the goldens are read as committed.
"""

import struct
import sys

import numpy as np
import pytest

import chip_smoke
from dspfun_tpu.io import images as jimages
from dspfun_tpu_torch.io import images as timages
from dspfun_tpu_torch.io import jpeg2000
from tests import torch_codec_fixtures as fx
from tests.test_torch_other_formats import _read, _same_read

GOLDENS = fx.j2k_more_names()
SMALL = tuple(n for n in GOLDENS if n not in fx.J2K_MORE_4K)


@pytest.fixture(scope="module")
def lib():
    found = fx.openjpeg_library()
    if found is None:
        pytest.skip("Pillow's bundled libopenjp2 is not found")
    return found


@pytest.fixture(scope="module")
def remade(lib):
    return fx.j2k_more_goldens(lib)


def _golden(name: str) -> bytes:
    return (fx.GOLDENS / name).read_bytes()


def _read_both(tmp_path, data, monkeypatch):
    """Both packages' reads agree; the port takes the file with its JPEG
    2000 decoder."""
    assert timages._decoder(data) is jpeg2000.decode_j2k
    return _same_read(tmp_path, data, monkeypatch)


def _ok(jax) -> None:
    assert not any(isinstance(j, Exception) for j in jax.values()), jax


def _raises(jax) -> None:
    assert all(isinstance(j, Exception) for j in jax.values()), jax


# ---- the goldens -------------------------------------------------------------------


@pytest.mark.parametrize("name", GOLDENS)
def test_goldens_are_openjpegs_bytes(name, remade):
    """Each golden is what the writer makes of it again, byte for byte (the
    writer checks the COD, RGN and POC bytes it was asked for)."""
    assert remade[name] == _golden(name), name
    assert len(remade[name]) <= 400_000


@pytest.mark.parametrize("name", GOLDENS)
def test_phase_29_digests(name):
    """``chip_smoke.J2K_MORE_FIXTURES``: the file's sha256 and the JAX
    package's RGBA read of it (Pillow's RGB decode for the 4K files)."""
    data = _golden(name)
    if name in fx.J2K_MORE_4K:
        assert fx.j2k_4k_digest(data) == chip_smoke.J2K_MORE_FIXTURES[name]
    else:
        assert fx.other_digests(data) == chip_smoke.J2K_MORE_FIXTURES[name]
    assert sorted(chip_smoke.J2K_MORE_FIXTURES) == sorted(GOLDENS)


@pytest.mark.parametrize("name", SMALL)
def test_goldens_read_as_the_jax_package_reads_them(name, tmp_path, monkeypatch):
    _ok(_read_both(tmp_path, _golden(name), monkeypatch))


@pytest.mark.parametrize("name", fx.J2K_MORE_4K)
def test_4k_goldens(name, tmp_path, monkeypatch):
    """The 4096x2160 ``cinema4k-24`` file (a main-header POC, a tile part
    per component) and the 3840x2160 bypass + termall file: RGB reads
    equal, with cv2 importable and blocked."""
    path = tmp_path / name
    path.write_bytes(_golden(name))
    jax = jimages.read_image(str(path), channels="RGB")
    for blocked in (False, True):
        if blocked:
            monkeypatch.setitem(sys.modules, "cv2", None)
        port = timages.read_image(str(path), channels="RGB")
        assert port.depth == jax.depth
        np.testing.assert_array_equal(port.pixels, jax.pixels)


# ---- edits, per marker -------------------------------------------------------------


def _segments(cs: bytes, pos: int, stop: bytes) -> tuple[list, int]:
    out = []
    while cs[pos:pos + 2] != stop:
        n = struct.unpack_from(">H", cs, pos + 2)[0]
        out.append(cs[pos:pos + 2 + n])
        pos += 2 + n
    return out, pos


def _split(data: bytes) -> tuple[list, list]:
    """A codestream's main-header segments and its tile parts as (header
    segments, body)."""
    main, pos = _segments(data, 2, b"\xff\x90")
    parts = []
    while data[pos:pos + 2] == b"\xff\x90":
        psot = struct.unpack_from(">I", data, pos + 6)[0]
        segs, sod = _segments(data, pos + 12, b"\xff\x93")
        parts.append((data[pos:pos + 12], segs, data[sod + 2:pos + psot]))
        pos += psot
    return main, parts


def _join(main: list, parts: list) -> bytes:
    out = b"\xff\x4f" + b"".join(main)
    for sot, segs, body in parts:
        hdr = b"".join(segs)
        out += sot[:6] + struct.pack(">I", 14 + len(hdr) + len(body)) + sot[10:] + hdr \
            + b"\xff\x93" + body
    return out + b"\xff\xd9"


def _is(seg: bytes, marker: int) -> bool:
    return struct.unpack_from(">H", seg)[0] == marker


def _edit(name: str, main_fn=None, part_fn=None) -> bytes:
    main, parts = _split(_golden(name))
    if main_fn:
        main = main_fn(main, parts)
    if part_fn:
        parts = [(sot, part_fn(segs, t), body) for t, (sot, segs, body) in enumerate(parts)]
    return _join(main, parts)


def _marker(m: int, body: bytes) -> bytes:
    return struct.pack(">HH", m, len(body) + 2) + body


def _after(main: list, marker: int, segs: list) -> list:
    at = max(i for i, s in enumerate(main) if _is(s, marker)) + 1
    return main[:at] + segs + main[at:]


def _tile_pocs(name: str) -> bytes:
    return b"".join(s[4:] for s in _split(_golden(name))[1][0][1] if _is(s, 0xFF5F))


def _without(segs: list, marker: int) -> list:
    return [s for s in segs if not _is(s, marker)]


def _poc_entries(body: bytes) -> list:
    return [body[k:k + 7] for k in range(0, len(body), 7)]


def _in_main(name: str, body: bytes) -> bytes:
    """The tile-part POCs of a golden moved into its main header."""
    return _edit(name, lambda m, p: _after(m, 0xFF52, [_marker(0xFF5F, body)]),
                 lambda s, t: _without(s, 0xFF5F))


def _main_and_tile(name: str) -> bytes:
    """The first POC in the main header, the rest in each tile's: OpenJPEG
    appends a tile's POCs to the main header's."""
    entries = _poc_entries(_tile_pocs(name))
    return _edit(name, lambda m, p: _after(m, 0xFF52, [_marker(0xFF5F, entries[0])]),
                 lambda s, t: _without(s, 0xFF5F) + [_marker(0xFF5F, b"".join(entries[1:]))])


def _set_entries(name: str, fn) -> bytes:
    return _edit(name, part_fn=lambda s, t: [
        _marker(0xFF5F, b"".join(fn(e) for e in _poc_entries(x[4:]))) if _is(x, 0xFF5F) else x
        for x in s])


def _sop_only() -> bytes:
    """The SOP+EPH golden with EPH dropped: Scod 2 and no EPH markers."""
    main, parts = _split(_golden("j2k_sop_eph.j2k"))
    main = [s[:4] + bytes([s[4] & ~4]) + s[5:] if _is(s, 0xFF52) else s for s in main]
    return _join(main, [(sot, segs, body.replace(b"\xff\x92", b"")) for sot, segs, body in parts])


def _damaged(data: bytes, marker: bytes, new: bytes, drop: bool = False) -> bytes:
    """The first ``marker`` in the data of the first tile part replaced by
    ``new`` (or dropped with its Nsop)."""
    main, parts = _split(data)
    sot, segs, body = parts[0]
    at = body.index(marker)
    body = body[:at] + body[at + 6:] if drop else body[:at] + new + body[at + len(new):]
    return _join(main, [(sot, segs, body)] + parts[1:])


def _rgn_in_tiles() -> bytes:
    main, _ = _split(_golden("j2k_rgn.j2k"))
    rgn = [s for s in main if _is(s, 0xFF5E)]
    return _edit("j2k_rgn.j2k", lambda m, p: _without(m, 0xFF5E), lambda s, t: s + rgn)


def _set_rgn(body: bytes) -> bytes:
    return _edit("j2k_rgn.j2k", lambda m, p: [_marker(0xFF5E, body) if _is(s, 0xFF5E) else s
                                              for s in m])


def _reordered(name: str, first: tuple) -> bytes:
    """The main header's segments of the markers in ``first`` moved before
    the others (after SIZ)."""
    def fn(m, p):
        head = [s for s in m[1:] if struct.unpack_from(">H", s)[0] in first]
        return [m[0]] + head + [s for s in m[1:] if s not in head]
    return _edit(name, fn)


def _tile_header(name: str, markers: tuple, comps=(1,)) -> bytes:
    """Each tile-part header given copies of main-header segments in the
    order of ``markers`` (COC and QCC: those of the components ``comps``)."""
    main, _ = _split(_golden(name))

    def pick(m):
        segs = [s for s in main if _is(s, m)]
        return [s for s in segs if s[4] in comps] if m in (0xFF53, 0xFF5D) else segs[:1]

    extra = [s for m in markers for s in pick(m)]
    return _edit(name, part_fn=lambda s, t: s + extra)


def _set_cod_mct(name: str, mct: int) -> bytes:
    return _edit(name, lambda m, p: [s[:8] + bytes([mct]) + s[9:] if _is(s, 0xFF52) else s
                                     for s in m])


def _bad_component(name: str, marker: int) -> bytes:
    return _edit(name, lambda m, p: [s[:4] + bytes([9]) + s[5:] if _is(s, marker) else s
                                     for s in m])


def _mixed_mct(first_irreversible: bool) -> bytes:
    """Three components of one size, the middle one in the other wavelet,
    under COD's MCT flag: OpenJPEG takes the first one's transform, over
    the others' samples as their bits lie."""
    lib = fx.openjpeg_library()
    if lib is None:
        pytest.skip("Pillow's bundled libopenjp2 is not found")
    planes = fx._planes(fx.levels((80, 96), 42, noise=0.02))
    comps = [fx.j2k_write([planes[k]], prog="CPRL", numres=3, lib=lib,
                          irreversible=(k == 1) != first_irreversible,
                          rates=(0.0,) if (k == 1) == first_irreversible else (6.0,))
             for k in range(3)]
    main, parts = _split(fx.j2k_stitch(comps))
    return _join([s[:8] + b"\x01" + s[9:] if _is(s, 0xFF52) else s for s in main], parts)


def _writer(**kw):
    def make():
        lib = fx.openjpeg_library()
        if lib is None:
            pytest.skip("Pillow's bundled libopenjp2 is not found")
        return fx.j2k_write(lib=lib, **kw)
    return make


_RAMP = np.add.outer(np.arange(40) * 3, np.arange(52) * 2) % 256
EDITS = {   # name -> (the bytes, whether the JAX package reads them)
    "poc-in-main": (lambda: _in_main("j2k_poc_layers.j2k", _tile_pocs("j2k_poc_layers.j2k")),
                    True),
    "poc-main-and-tile": (lambda: _main_and_tile("j2k_poc_layers.j2k"), True),
    "poc-lyepoc-past-layers": (lambda: _set_entries(
        "j2k_poc_layers.j2k", lambda e: e[:2] + (b"\xff\xff" if e[3] == 3 else e[2:4]) + e[4:]),
        True),
    "poc-cepoc-past-components": (lambda: _set_entries(
        "j2k_poc_tiles.j2k", lambda e: e[:5] + b"\xff" + e[6:]), True),
    "poc-unknown-order-appended": (lambda: _set_entries(
        "j2k_poc_layers.j2k", lambda e: e + (b"\x00\x00\x00\x03\x04\x03\x07"
                                             if e[6] == 3 else b"")), True),
    "poc-short": (lambda: _set_entries("j2k_poc_layers.j2k", lambda e: e[:6]), False),
    "sop-only": (_sop_only, True),
    "sop-dropped": (lambda: _damaged(_sop_only(), b"\xff\x91", b"", drop=True), True),
    "sop-nsop": (lambda: _damaged(_sop_only(), b"\xff\x91\x00\x04", b"\xff\x91\x00\x04\x12\x34"),
                 True),
    "sop-damaged": (lambda: _damaged(_golden("j2k_sop_eph.j2k"), b"\xff\x91",
                                     b"\xff\x90"), False),
    "eph-damaged": (lambda: _damaged(_golden("j2k_sop_eph.j2k"), b"\xff\x92", b"\xff\x00"),
                    False),
    "eph-flag-without-markers": (lambda: _edit(
        "j2k_poc_layers.j2k", lambda m, p: [s[:4] + bytes([s[4] | 4]) + s[5:]
                                            if _is(s, 0xFF52) else s for s in m]), False),
    "rgn-in-tile-parts": (_rgn_in_tiles, True),
    "rgn-style-1": (lambda: _set_rgn(b"\x01\x01\x06"), True),
    "rgn-bad-component": (lambda: _set_rgn(b"\x03\x00\x06"), False),
    "rgn-bad-length": (lambda: _set_rgn(b"\x01\x00\x06\x00"), False),
    "coc-before-cod": (lambda: _reordered("j2k_coc_qcc.j2k", (0xFF53,)), False),
    "qcc-before-qcd": (lambda: _reordered("j2k_coc_qcc.j2k", (0xFF5D,)), True),
    "coc-qcc-before-cod-qcd": (lambda: _reordered("j2k_coc_qcc.j2k", (0xFF53, 0xFF5D)),
                               False),
    "tile-coc-then-cod": (lambda: _tile_header("j2k_coc_qcc.j2k", (0xFF53, 0xFF52)), False),
    "tile-cod-then-coc": (lambda: _tile_header("j2k_coc_qcc.j2k", (0xFF52, 0xFF53)), False),
    "tile-cod-then-cocs": (lambda: _tile_header("j2k_coc_qcc.j2k", (0xFF52, 0xFF53), (1, 2)),
                           True),
    "tile-qcc-then-qcd": (lambda: _tile_header("j2k_coc_qcc.j2k", (0xFF5D, 0xFF5C)), True),
    "tile-qcd-then-qcc": (lambda: _tile_header("j2k_coc_qcc.j2k", (0xFF5C, 0xFF5D)), True),
    "coc-bad-component": (lambda: _bad_component("j2k_coc_qcc.j2k", 0xFF53), False),
    "qcc-bad-component": (lambda: _bad_component("j2k_coc_qcc.j2k", 0xFF5D), False),
    "mct-over-mixed-resolutions": (lambda: _set_cod_mct("j2k_coc_qcc.j2k", 1), False),
    "mct-over-5/3-9/7-5/3": (lambda: _mixed_mct(first_irreversible=False), True),
    "mct-over-9/7-5/3-9/7": (lambda: _mixed_mct(first_irreversible=True), True),
    "mct-over-subsampled": (lambda: _set_cod_mct("j2k_sub_420.j2k", 1), None),
    "subsampled-gray": (_writer(planes=[_RAMP[::2, ::2]], subsampling=[(2, 2)], numres=2),
                        False),
    "subsampled-gray-alpha": (_writer(planes=[_RAMP, _RAMP[:, ::2]],
                                      subsampling=[(1, 1), (2, 1)], numres=2), False),
}


@pytest.mark.parametrize("name", sorted(EDITS))
def test_edits(name, tmp_path, monkeypatch):
    """Each edit reads as the JAX package reads it, or raises where it
    raises (``True``: it reads; ``False``: it raises; ``None``: either)."""
    make, reads = EDITS[name]
    jax = _read_both(tmp_path, make(), monkeypatch)
    if reads is True:
        _ok(jax)
    elif reads is False:
        _raises(jax)


def test_progressions_that_leave_out_a_resolution_are_refused():
    """POCs under which a component's highest resolution has no packet:
    OpenJPEG decodes that component only to the highest resolution it read
    and hands Pillow the smaller plane, which the port does not carry; it
    raises naming item 8h, with cv2 importable and blocked."""
    data = _set_entries("j2k_poc_layers.j2k", lambda e: e[:4] + bytes([min(e[4], 3)]) + e[5:])
    with pytest.raises(ValueError, match=r"highest resolution .* item 8h"):
        jpeg2000.decode_j2k(data)


# ---- seeded sweeps -----------------------------------------------------------------

PROGRESSIONS = ("LRCP", "RLCP", "RPCL", "PCRL", "CPRL")


def _fits(h, w, origin, subs, tiles, numres) -> bool:
    """Every tile-component at least 2**numres on a side (OpenJPEG's encoder
    asserts on a one-sample line)."""
    x0, y0 = origin
    x1, y1 = x0 + w, y0 + h
    (tdx, tdy), (tx0, ty0) = tiles if tiles else ((x1, y1), (0, 0))
    xs = sorted({min(max(x0, tx0 + i * tdx), x1) for i in range((x1 - tx0) // tdx + 2)})
    ys = sorted({min(max(y0, ty0 + i * tdy), y1) for i in range((y1 - ty0) // tdy + 2)})
    return all(-(-b // dx) - -(-a // dx) >= 2 ** numres and -(-d // dy) - -(-c // dy) >= 2 ** numres
               for a, b in zip(xs, xs[1:]) for c, d in zip(ys, ys[1:]) for dx, dy in subs)


def _switches(seed: int) -> tuple[list, dict]:
    """Seeded planes and writer settings drawing among every switch."""
    rng = np.random.default_rng(seed)
    nc = int(rng.integers(1, 5))
    h, w = int(rng.integers(24, 80)), int(rng.integers(24, 80))
    numres = int(rng.integers(1, 5))
    tiles = None
    if rng.random() < 0.35:
        tiles = ((int(rng.integers(2 ** numres + 8, 64)), int(rng.integers(2 ** numres + 8, 64))),
                 (0, 0))
    if not _fits(h, w, (0, 0), [(1, 1)], tiles, max(numres - 1, 0)):
        tiles = None
    layers = int(rng.integers(1, 4))
    irreversible = bool(rng.integers(0, 2))
    rates = tuple(sorted((float(r) for r in rng.choice([60, 30, 15, 8, 4], layers - 1,
                                                       replace=False)), reverse=True))
    rates += (3.0,) if irreversible else (0.0,)
    y, x = np.mgrid[0:h, 0:w]
    planes = [np.clip(128 + 100 * np.sin(x / (5.0 + k) + seed) * np.cos(y / (7.0 + k))
                      + rng.normal(0, 6, (h, w)), 0, 255).astype(np.int32) for k in range(nc)]
    pocs = []
    if rng.random() < 0.5:
        npoc = int(rng.integers(1, 4))
        cuts = sorted(set(int(v) for v in rng.integers(1, numres + 1, npoc - 1))) \
            if numres > 1 else []
        bounds = [0] + [c for c in cuts if 0 < c < numres] + [numres]
        pocs = [dict(res0=r0, comp0=0, lay1=layers, res1=r1, comp1=nc,
                     prg=PROGRESSIONS[int(rng.integers(0, 5))])
                for r0, r1 in zip(bounds, bounds[1:])]
    cblk = (int(2 ** rng.integers(2, 7)), int(2 ** rng.integers(2, 7)))
    while cblk[0] * cblk[1] > 4096:
        cblk = (cblk[0] // 2, cblk[1])
    precincts = None
    if rng.random() < 0.4:
        precincts = [(int(2 ** rng.integers(4, 8)), int(2 ** rng.integers(4, 8)))
                     for _ in range(int(rng.integers(1, numres + 1)))]
    csty = int(rng.choice([0, 2, 4, 6]))
    kw = dict(numres=numres, cblk=cblk, prog=PROGRESSIONS[int(rng.integers(0, 5))],
              irreversible=irreversible, mct=bool(nc >= 3 and rng.random() < 0.5),
              sop=bool(csty & 2), eph=bool(csty & 4), mode=int(rng.integers(0, 64)), rates=rates,
              pocs=pocs, tiles=tiles, precincts=precincts,
              roi=(int(rng.integers(0, nc)), int(rng.integers(1, 8))) if rng.random() < 0.3
              else None, jp2=bool(rng.random() < 0.3))
    return planes, kw


def _subsampled(seed: int) -> tuple[list, dict] | None:
    """Seeded sub-sampled planes and settings (None where OpenJPEG would not
    code them)."""
    rng = np.random.default_rng(1000 + seed)
    steps = [(1, 1), (2, 2), (2, 1), (1, 2), (3, 2)]
    nc = int(rng.integers(3, 5))
    subs = [steps[int(rng.integers(0, 5))] if rng.random() < 0.6 else (1, 1) for _ in range(nc)]
    if all(d == (1, 1) for d in subs):
        subs[1] = (2, 2)
    origin = (int(rng.integers(0, 5)), int(rng.integers(0, 5))) if rng.random() < 0.4 \
        else (0, 0)
    (dx0, dy0), prec = subs[0], int(rng.choice([8, 8, 12, 4]))
    w, h = int(rng.integers(20, 70)), int(rng.integers(20, 70))
    w, h = w - (origin[0] + w) % dx0, h - (origin[1] + h) % dy0
    tiles = ((int(rng.integers(16, 40)), int(rng.integers(16, 40))), (0, 0)) \
        if rng.random() < 0.5 else None
    if (origin[0] % dx0 or origin[1] % dy0 or not _fits(h, w, origin, subs, tiles, 3)):
        return None
    x1, y1 = origin[0] + w, origin[1] + h
    planes = []
    for k, (dx, dy) in enumerate(subs):
        cw = -(-x1 // dx) - -(-origin[0] // dx)
        ch = -(-y1 // dy) - -(-origin[1] // dy)
        yy, xx = np.mgrid[0:ch, 0:cw]
        planes.append(((xx * (3 + k) + yy * 2 + 40 * k) * ((1 << prec) - 1) // 255
                       + rng.integers(0, 3, xx.shape)) % (1 << prec))
    return planes, dict(subsampling=subs, origin=origin, prec=prec, tiles=tiles, numres=3,
                        irreversible=bool(rng.integers(0, 2)), jp2=bool(rng.random() < 0.3),
                        mode=int(rng.integers(0, 64)) if rng.random() < 0.3 else 0)


@pytest.mark.parametrize("seed", range(48))
def test_sweep_of_every_switch(seed, lib, tmp_path, monkeypatch):
    planes, kw = _switches(seed)
    jax = _read_both(tmp_path, fx.j2k_write(planes, lib=lib, **kw), monkeypatch)
    _ok(jax)


SUBSAMPLED_SEEDS = tuple(s for s in range(200) if _subsampled(s) is not None)[:24]


@pytest.mark.parametrize("seed", SUBSAMPLED_SEEDS)
def test_sweep_of_subsampled_components(seed, lib, tmp_path, monkeypatch):
    planes, kw = _subsampled(seed)
    jax = _read_both(tmp_path, fx.j2k_write(planes, lib=lib, **kw), monkeypatch)
    _ok(jax)
