"""JPEG 2000's packed packet headers (PPM, PPT) and POC progressions that
leave a component's highest resolution without packets, in the port's
codec (``dspfun_tpu_torch/io/jpeg2000.py``, ``native/j2k.cpp``) against
the JAX package, which reads them through Pillow 12.1 and OpenJPEG 2.5.4.

No encoder here writes PPM or PPT: ``torch_codec_fixtures.j2k_pack`` moves
the headers of a codestream coded with SOP and EPH markers (each header
runs from its SOP segment to its EPH marker) into PPM markers of the main
header or PPT markers of the tile-part headers.  What OpenJPEG does with
them, found by these files through Pillow:

* PPM markers are joined in Zppm order (gaps allowed, whatever order they
  stand in), their Nppm lengths only checked (an Nppm split between two
  markers, or running past the data, raises; a run of Ippm may go on into
  the next marker): the headers form one stream, read on from tile to
  tile in decoding order, whatever each Nppm says;
* PPT markers are joined per tile in Zppt order; a PPT after a PPM, a
  repeated Z index, a PPM in a tile-part header or a PPT in the main
  header raises;
* SOP segments stay in the tile data and may be dropped; EPH markers are
  read from the header stream, so headers that run out before the tile's
  packets do raise under EPH and leave the rest of the packets empty
  without it.

Resolution-short POCs: OpenJPEG decodes each component of a tile only up
to the highest resolution it read a packet of and hands Pillow that
smaller plane, which Pillow's unpacker reads at the full size across its
rows (the rest of its per-tile buffer zero); an MCT over components cut
to different resolutions raises.

Each file goes through both packages' ``read_image`` (RGB, RGBA and I,
with cv2 importable and blocked): the same pixels and depth, or an error
in both.  Without Pillow's ``libopenjp2`` the sweeps skip; the edits of
the committed golden run everywhere Pillow does.
"""

import struct

import numpy as np
import pytest

from dspfun_tpu_torch.io import images as timages
from dspfun_tpu_torch.io import jpeg2000
from tests import torch_codec_fixtures as fx
from tests.test_torch_jpeg2000_more import PROGRESSIONS, _fits, _switches
from tests.test_torch_other_formats import _same_read


@pytest.fixture(scope="module")
def lib():
    found = fx.openjpeg_library()
    if found is None:
        pytest.skip("Pillow's bundled libopenjp2 is not found")
    return found


def _sop_eph() -> bytes:
    return (fx.GOLDENS / "j2k_sop_eph.j2k").read_bytes()


def _read_both(tmp_path, data, monkeypatch):
    assert timages._decoder(data) is jpeg2000.decode_j2k
    return _same_read(tmp_path, data, monkeypatch)


def _ok(jax) -> None:
    assert not any(isinstance(j, Exception) for j in jax.values()), jax


def _raises(jax) -> None:
    assert all(isinstance(j, Exception) for j in jax.values()), jax


# ---- PPM and PPT forms, edits of the SOP+EPH golden ----------------------------


def _headers(cs: bytes) -> tuple[list, list, list]:
    """The main header, tile parts and each tile part's packets."""
    main, parts = fx.j2k_split(cs)
    return main, parts, [fx.j2k_packets(body) for _, _, body in parts]


def _ppm_of(runs, main=None, parts=None, packets=None, eph=True) -> bytes:
    """One PPM marker of the given Nppm runs (each bytes, Nppm and its
    Ippm), the bodies without their headers."""
    if main is None:
        main, parts, packets = _headers(_sop_eph())
    bodies = [b"".join(s + d for s, _, d in pk) for pk in packets]
    return fx.j2k_join(main + [fx.j2k_marker(0xFF60, b"\0" + b"".join(runs))],
                       [(sot, segs, b) for (sot, segs, _), b in zip(parts, bodies)])


def _runs(packets, drop_last: int = 0, extra: bytes = b"") -> list:
    """An Nppm run per tile part (the last without its last ``drop_last``
    headers, then ``extra`` bytes)."""
    heads = [b"".join(h for _, h, _ in pk) for pk in packets]
    if drop_last:
        heads[-1] = b"".join(h for _, h, _ in packets[-1][:-drop_last])
    heads[-1] += extra
    return [struct.pack(">I", len(h)) + h for h in heads]


def _regrouped() -> bytes:
    """Every header under one Nppm (OpenJPEG reads one stream anyway)."""
    main, parts, packets = _headers(_sop_eph())
    allh = b"".join(h for pk in packets for _, h, _ in pk)
    return _ppm_of([struct.pack(">I", len(allh)) + allh], main, parts, packets)


def _moved_nppm() -> bytes:
    """The first tile part's last 10 header bytes counted in the second's
    Nppm."""
    main, parts, packets = _headers(_sop_eph())
    runs = [b"".join(h for _, h, _ in pk) for pk in packets]
    runs = [runs[0][:-10], runs[0][-10:] + runs[1], *runs[2:]]
    return _ppm_of([struct.pack(">I", len(h)) + h for h in runs], main, parts, packets)


def _edit_runs(**kw) -> bytes:
    main, parts, packets = _headers(_sop_eph())
    return _ppm_of(_runs(packets, **kw), main, parts, packets)


def _short_nppm() -> bytes:
    """An Nppm that runs 5 bytes past the PPM data."""
    main, parts, packets = _headers(_sop_eph())
    runs = _runs(packets)
    runs[-1] = runs[-1][:-5]
    return _ppm_of(runs, main, parts, packets)


def _noeph_runout(k: int) -> bytes:
    """EPH off (Scod bit 2 and the markers gone), the last tile part's
    last k headers dropped from the PPM stream."""
    main, parts, packets = _headers(_sop_eph())
    main = [s[:4] + bytes([s[4] & ~4]) + s[5:] if s[:2] == b"\xff\x52" else s for s in main]
    packets = [[(s, h[:-2], d) for s, h, d in pk] for pk in packets]
    return _ppm_of(_runs(packets, drop_last=k), main, parts, packets)


def _trailing(extra: bytes) -> bytes:
    """The PPM data followed by ``extra`` bytes (an empty Nppm, or too few
    bytes for one)."""
    main, parts, packets = _headers(_sop_eph())
    return _ppm_of(_runs(packets) + [extra], main, parts, packets)


def _ppm_and_ppt() -> bytes:
    main, parts = fx.j2k_split(fx.j2k_pack(_sop_eph(), "ppt"))
    return fx.j2k_join(main + [fx.j2k_marker(0xFF60, b"\0" + bytes(4))], parts)


def _ppt_runout() -> bytes:
    """The last tile part's PPT marker 20 bytes short."""
    main, parts = fx.j2k_split(fx.j2k_pack(_sop_eph(), "ppt"))
    sot, segs, body = parts[-1]
    segs = [fx.j2k_marker(0xFF61, s[4:-20]) if s[:2] == b"\xff\x61" else s for s in segs]
    return fx.j2k_join(main, parts[:-1] + [(sot, segs, body)])


def _misplaced(marker: int) -> bytes:
    """A PPT marker in the main header, or a PPM marker in a tile part's."""
    main, parts = fx.j2k_split(fx.j2k_pack(_sop_eph(), "ppm" if marker == 0xFF61 else "ppt"))
    if marker == 0xFF61:
        return fx.j2k_join(main + [fx.j2k_marker(0xFF61, b"\0\0")], parts)
    sot, segs, body = parts[0]
    return fx.j2k_join(main, [(sot, segs + [fx.j2k_marker(0xFF60, b"\0\0")], body)] + parts[1:])


FORMS = {   # name -> (the bytes, whether the JAX package reads them)
    "ppm-one": (lambda: fx.j2k_pack(_sop_eph()), True),
    "ppm-three-out-of-order": (lambda: fx.j2k_pack(_sop_eph(), pieces=3, appear=(2, 0, 1)), True),
    "ppm-z-gaps": (lambda: fx.j2k_pack(_sop_eph(), pieces=2, zs=(0, 2)), True),
    "ppm-seven-markers": (lambda: fx.j2k_pack(_sop_eph(), pieces=7, zs=(1, 4, 9, 16, 25, 36,
                                                                         49)), True),
    "ppm-without-sop": (lambda: fx.j2k_pack(_sop_eph(), keep_sop=False), True),
    "ppm-without-eph": (lambda: fx.j2k_pack(_sop_eph(), eph=False), True),
    "ppm-one-nppm": (_regrouped, True),
    "ppm-nppm-moved": (_moved_nppm, True),
    "ppm-trailing-zero-nppm": (lambda: _trailing(bytes(4)), True),
    "ppm-trailing-two-bytes": (lambda: _trailing(bytes(2)), False),
    "ppm-extra-headers": (lambda: _edit_runs(extra=b"\x00\xff\x92" * 3), True),
    "ppm-nppm-split": (lambda: fx.j2k_pack(_sop_eph(), nppm_split=True), False),
    "ppm-nppm-past-data": (_short_nppm, False),
    "ppm-runs-out": (lambda: _edit_runs(drop_last=1), False),
    "ppm-runs-out-without-eph": (lambda: _noeph_runout(2), True),
    "ppm-repeated-z": (lambda: fx.j2k_pack(_sop_eph(), pieces=2, zs=(3, 3)), False),
    "ppm-short-marker": (lambda: fx.j2k_join(fx.j2k_split(fx.j2k_pack(_sop_eph()))[0]
                                             + [fx.j2k_marker(0xFF60, b"\x09")],
                                             fx.j2k_split(fx.j2k_pack(_sop_eph()))[1]), False),
    "ppm-in-tile-part": (lambda: _misplaced(0xFF60), False),
    "ppt-one": (lambda: fx.j2k_pack(_sop_eph(), "ppt"), True),
    "ppt-swapped": (lambda: fx.j2k_pack(_sop_eph(), "ppt", pieces=2, appear=(1, 0)), True),
    "ppt-four-z-gaps": (lambda: fx.j2k_pack(_sop_eph(), "ppt", pieces=4, zs=(2, 3, 7, 200)),
                        True),
    "ppt-without-sop": (lambda: fx.j2k_pack(_sop_eph(), "ppt", keep_sop=False), True),
    "ppt-without-eph": (lambda: fx.j2k_pack(_sop_eph(), "ppt", eph=False, keep_sop=False), True),
    "ppt-repeated-z": (lambda: fx.j2k_pack(_sop_eph(), "ppt", pieces=2, zs=(0, 0)), False),
    "ppt-runs-out": (_ppt_runout, False),
    "ppt-in-main-header": (lambda: _misplaced(0xFF61), False),
    "ppm-and-ppt": (_ppm_and_ppt, False),
}


@pytest.mark.parametrize("name", sorted(FORMS))
def test_packed_header_forms(name, tmp_path, monkeypatch):
    """Each form reads as the JAX package reads it (``True``), or raises
    where it raises (``False``)."""
    make, reads = FORMS[name]
    jax = _read_both(tmp_path, make(), monkeypatch)
    (_ok if reads else _raises)(jax)


def test_packed_headers_read_the_golden_pixels():
    """The PPM and PPT goldens of phase 29 decode to the pixels of the
    SOP+EPH golden they were made from."""
    want, _ = jpeg2000.decode_j2k(_sop_eph())
    for name in fx.J2K_PACKED[:4]:
        got, _ = jpeg2000.decode_j2k((fx.GOLDENS / name).read_bytes())
        np.testing.assert_array_equal(got, want, err_msg=name)


# ---- seeded sweeps -----------------------------------------------------------------


def _packed(seed: int) -> tuple[list, dict, dict]:
    """Seeded planes and writer settings (SOP and EPH on), and how their
    headers are packed."""
    planes, kw = _switches(530 + seed)
    kw.update(sop=True, eph=True, jp2=False)
    rng = np.random.default_rng(seed)
    pieces = int(rng.integers(1, 5))
    zs = sorted(int(z) for z in rng.choice(60, pieces, replace=False))
    pack = dict(where=("ppm", "ppt")[seed % 2], pieces=pieces, zs=zs,
                appear=[int(k) for k in rng.permutation(pieces)],
                keep_sop=bool(rng.random() < 0.6), eph=bool(rng.random() < 0.7))
    return planes, kw, pack


@pytest.mark.parametrize("seed", range(24))
def test_sweep_of_packed_headers(seed, lib, tmp_path, monkeypatch):
    """Files of every switch (progressions, tiles, layers, POCs, styles)
    with their headers moved into PPM or PPT markers: read as the JAX
    package reads them."""
    planes, kw, pack = _packed(seed)
    data = fx.j2k_pack(fx.j2k_write(planes, lib=lib, **kw), **pack)
    _ok(_read_both(tmp_path, data, monkeypatch))


def _short(seed: int) -> tuple[list, dict]:
    """Seeded planes and POCs of which some leave out a component's (or a
    tile's) highest resolutions."""
    rng = np.random.default_rng(3000 + seed)
    nc = int(rng.integers(1, 5))
    numres = int(rng.integers(2, 6))
    h, w = int(rng.integers(2 ** numres + 8, 90)), int(rng.integers(2 ** numres + 8, 90))
    tiles = None
    if rng.random() < 0.4:
        tiles = ((int(rng.integers(2 ** numres + 8, 64)), int(rng.integers(2 ** numres + 8, 64))),
                 (0, 0))
        if not _fits(h, w, (0, 0), [(1, 1)], tiles, numres):
            tiles = None
    ntiles = 1 if tiles is None else -(-w // tiles[0][0]) * -(-h // tiles[0][1])
    layers = int(rng.integers(1, 3))
    pocs = []
    for t in range(1, min(ntiles, 3) + 1):
        for _ in range(int(rng.integers(1, 3))):
            c0, r1 = int(rng.integers(0, nc)), int(rng.integers(1, numres + 1))
            pocs.append(fx.j2k_poc(r1, c0, int(rng.integers(c0 + 1, nc + 1)), tile=t,
                                   prg=PROGRESSIONS[int(rng.integers(0, 5))],
                                   r0=int(rng.integers(0, r1)), lay1=layers))
    y, x = np.mgrid[0:h, 0:w]
    planes = [np.clip(128 + 90 * np.sin(x / (4.0 + k) + seed) * np.cos(y / (6.0 + k))
                      + rng.normal(0, 5, (h, w)), 0, 255).astype(np.int32) for k in range(nc)]
    irreversible = bool(rng.integers(0, 2))
    rates = (40.0,) * (layers - 1) + ((4.0,) if irreversible else (0.0,))
    return planes, dict(numres=numres, tiles=tiles, pocs=pocs, irreversible=irreversible,
                        rates=rates, prog=PROGRESSIONS[int(rng.integers(0, 5))],
                        jp2=bool(rng.random() < 0.3))


@pytest.mark.parametrize("seed", range(24))
def test_sweep_of_resolution_short_pocs(seed, lib, tmp_path, monkeypatch):
    """Files whose POCs leave out some components' or tiles' highest
    resolutions (or whole components): read as the JAX package reads
    them."""
    planes, kw = _short(seed)
    _ok(_read_both(tmp_path, fx.j2k_write(planes, lib=lib, **kw), monkeypatch))


def test_mct_over_components_cut_differently_raises(lib, tmp_path, monkeypatch):
    """MCT over three components of which only the first is cut: OpenJPEG
    skips the tile ("Tiles don't all have the same dimension"), Pillow
    raises, and so does the port."""
    planes = fx._planes(fx.levels((80, 96), 42, noise=0.02))
    data = fx.j2k_write(planes, numres=4, mct=True, lib=lib,
                        pocs=[fx.j2k_poc(3, 0, 1), fx.j2k_poc(4, 1, 3)])
    _raises(_read_both(tmp_path, data, monkeypatch))
