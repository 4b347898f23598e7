"""Zstandard and LZMA TIFF, and libtiff's old LSB-first LZW, on the port's
own codecs (``dspfun_tpu_torch/io/imgcodecs.py``, ``native/zstd.cpp``, the
standard library's lzma, ``native/tiff.cpp``) against the JAX package,
which reads them through Pillow's libtiff (libzstd 1.5.7, liblzma 5.8).

* Whole files: Pillow's Zstandard and LZMA files (its own writer, every
  mode it writes them in, predictors 1, 2 and 3), ``make_tiff``'s at
  Zstandard levels 1, 3, 9 and 19 and xz presets 0 and 6 (strips, tiles,
  planes, both byte orders, predictors 1, 2 and 3), the goldens of
  ``chip_smoke.py`` phase 23(a) and the LSB-first LZW files, each read
  to ``read_image``'s pixels and depth exactly, with cv2 importable and
  blocked; the goldens' and the 4K files' digests are pinned.
* The Zstandard decoder (a strip's decode, as libtiff calls libzstd)
  against the zstandard package (libzstd) on seeded inputs: levels -5 to
  22 with and without the content size and the checksum, several frames
  and skippable frames, raw, RLE and treeless-literal blocks byte for
  byte, the same error or the same bytes on seeded damaged frames, and a
  block that would make more than a block's bytes refused at once.
* Damaged strips: seeded damaged Zstandard and LZMA strips read to
  Pillow's pixels or raise in both packages; an LZMA strip that liblzma
  finds corrupt before the strip is full the port refuses (Pillow keeps
  what its liblzma decoded before noticing).  A Zstandard checksum
  mismatch raises in both.
"""

import io
import struct

import numpy as np
import pytest
from PIL import Image

import chip_smoke
from dspfun_tpu_torch.io import imgcodecs
from dspfun_tpu_torch.io import images as timages
from tests import torch_codec_fixtures as fx
from tests.test_torch_tiff import _same_or_both_raise
from tests.test_torch_tiff_more import _held
from tests.torch_codec_fixtures import make_tiff

zstandard = pytest.importorskip("zstandard")


def _pil(img, **kw) -> bytes:
    buf = io.BytesIO()
    img.save(buf, "TIFF", **kw)
    return buf.getvalue()


def _same_read(tmp_path, data, monkeypatch=None):
    """The port reads ``data`` to the JAX package's pixels and depth (with
    cv2 blocked too, given ``monkeypatch``), where the JAX package reads it."""
    assert _same_or_both_raise(tmp_path, data, monkeypatch)


# ---- the goldens of chip_smoke.py phase 23 ----------------------------------------


def _tags_and_blocks(data: bytes) -> tuple:
    """A TIFF's tags and the bytes of each strip or tile (libtiff leaves
    the byte that pads a strip to an even offset as its buffer held it)."""
    _, t = imgcodecs._tiff_tags(data)
    offsets, counts = t.get(273) or t.get(324), t.get(279) or t.get(325)
    return t, [data[o:o + c] for o, c in zip(offsets, counts)]


def test_phase_23_goldens_are_the_fixture_modules():
    """tests/goldens/ holds what ``zstd_lzma_fixtures`` writes (Pillow's
    files and make_tiff's through zstandard and lzma): the same tags and
    strip bytes; ``ZSTD_LZMA_FIXTURES`` names each of them."""
    made = fx.zstd_lzma_fixtures()
    assert sorted(made) == sorted(chip_smoke.ZSTD_LZMA_FIXTURES)
    for name, data in made.items():
        assert _tags_and_blocks((fx.GOLDENS / name).read_bytes()) == _tags_and_blocks(data), name


@pytest.mark.parametrize("name", sorted(chip_smoke.ZSTD_LZMA_FIXTURES))
def test_goldens_read_as_the_jax_package_reads_them(name, tmp_path, monkeypatch):
    data = (fx.GOLDENS / name).read_bytes()
    assert fx.other_digests(data) == chip_smoke.ZSTD_LZMA_FIXTURES[name]
    assert timages._decoder(data) is imgcodecs.decode_tiff
    _same_read(tmp_path, data, monkeypatch)


@pytest.mark.parametrize("name", sorted(chip_smoke.OLD_LZW_DIGESTS))
def test_old_lzw_files_read_as_the_jax_package_reads_them(name, tmp_path, monkeypatch):
    """libtiff's LSB-first LZW (``make_tiff(..., old_lzw=True)``): strips,
    tiles, planes, big-endian 16-bit samples, predictor 2, FillOrder 2."""
    data = fx.old_lzw_tiffs()[name]
    assert imgcodecs._lzw_compat(data[8:10]) or "FillOrder" in name
    assert fx.other_digests(data) == chip_smoke.OLD_LZW_DIGESTS[name]
    _same_read(tmp_path, data, monkeypatch)


@pytest.mark.parametrize("donor", sorted(fx.STRIP_DONORS))
def test_the_4k_files_are_pillows(donor):
    """``strip_4k`` of each donor: 432 strips of 5 rows on its 4 strips,
    decoded by Pillow to ``STRIP_4K_DIGEST`` and by the port to the same
    array."""
    data = fx.strip_4k((fx.GOLDENS / donor).read_bytes(), chip_smoke.H)
    want = np.asarray(Image.open(io.BytesIO(data)))
    assert want.shape == (chip_smoke.H, chip_smoke.W, 3)
    import hashlib

    assert hashlib.sha256(want.tobytes()).hexdigest() == chip_smoke.STRIP_4K_DIGEST
    np.testing.assert_array_equal(imgcodecs.decode_tiff(data)[0], want)


# ---- whole files --------------------------------------------------------------------

PILLOW_MODES = ["1", "L", "LA", "P", "RGB", "RGBA", "I;16", "I", "F", "CMYK"]


@pytest.mark.parametrize("mode", PILLOW_MODES)
@pytest.mark.parametrize("comp", ["zstd", "lzma"])
def test_pillows_files_read_as_the_jax_package_reads_them(comp, mode, tmp_path, monkeypatch):
    """Pillow's own Zstandard and LZMA writer (libtiff: one frame or xz
    stream a strip, no content size, no check) in each mode, predictor 1,
    2 where libtiff takes it and 3 for F, one strip and strips of 7
    rows."""
    rgb = fx.levels((23, 37), len(mode) + len(comp))
    img = Image.fromarray(rgb)
    if mode == "I;16":
        img = Image.fromarray(rgb[..., 0].astype(np.uint16) * 257 + 3)
    elif mode in ("I", "F"):
        v = rgb[..., 0].astype(np.int32) * 3000 - 90000
        img = Image.fromarray(v.astype(np.float32) / 7 if mode == "F" else v)
    elif mode != "RGB":
        img = img.convert(mode)
    assert img.mode == mode
    predictors = {"F": (1, 3), "1": (1,), "P": (1,)}.get(mode, (1, 2))
    for pred in predictors:
        for kw in ({}, {"strip_size": img.width * max(len(img.getbands()), 1) * 7}):
            data = _pil(img, compression=comp, **({"tiffinfo": {317: pred}} if pred > 1 else {}),
                        **kw)
            assert imgcodecs.tiff_not_carried(data) is None
            _same_read(tmp_path, data, monkeypatch if pred == 1 else None)


LAYOUTS = [("L", {}), ("RGB", dict(rows_per_strip=5)), ("RGBA", dict(tile=(16, 32))),
           ("RGB;16", dict(bo=">", rows_per_strip=4)), ("I;16", dict(planar=True)),
           ("RGBA;16", dict(planar=True, tile=(16, 16))), ("CMYK", dict(rows_per_strip=9))]


@pytest.mark.parametrize("predictor", [1, 2, 3])
@pytest.mark.parametrize("level", [1, 3, 9, 19])
def test_zstandard_levels_read_as_the_jax_package_reads_them(level, predictor, tmp_path):
    """make_tiff's files through zstandard at levels 1, 3, 9 and 19
    (content size in each frame's header: libzstd's one-pass route), over
    strips, tiles and planes, both byte orders; predictor 3 on float
    samples, 32- and 16-bit, little- and big-endian."""
    layouts = LAYOUTS if predictor != 3 else [("F", {}), ("F", dict(bo=">", tile=(16, 16)))]
    for k, (mode, kw) in enumerate(layouts):
        s = fx.tiff_samples(mode, 33, 41, level + k)
        data = make_tiff(s, mode, compression=50000, predictor=predictor, level=level, **kw)
        _same_read(tmp_path, data)


@pytest.mark.parametrize("predictor", [1, 2, 3])
@pytest.mark.parametrize("preset", [0, 6])
def test_xz_presets_read_as_the_jax_package_reads_them(preset, predictor, tmp_path):
    """make_tiff's files through the standard library's lzma (no check,
    as libtiff writes them; a CRC64 check; a second stream after the
    first, which libtiff never reads), at presets 0 and 6."""
    import lzma

    layouts = LAYOUTS[:4] if predictor != 3 else [("F", {}), ("F", dict(bo=">"))]
    for k, (mode, kw) in enumerate(layouts):
        s = fx.tiff_samples(mode, 29, 35, preset + k)
        codecs = [None, lambda b: lzma.compress(b, preset=preset) + lzma.compress(b"junk")]
        for codec in codecs:
            data = make_tiff(s, mode, compression=34925, predictor=predictor, level=preset,
                             codec=codec, **kw)
            _same_read(tmp_path, data)


def test_the_first_strip_decides_the_lzw_form(tmp_path):
    """libtiff picks its LSB-first LZW decoder for a whole image by its first
    strip: an old first strip then a new one, and the other way round,
    read as Pillow reads them (both raise)."""
    s = fx.tiff_samples("L", 45, 67, 3)
    for first_old in (True, False):
        n = [0]

        def codec(b, first_old=first_old):
            n[0] += 1
            return fx.lzw_encode(b, lsb=(n[0] == 1) == first_old)

        assert _held(tmp_path, make_tiff(s, "L", compression=5, rows_per_strip=8,
                                         codec=codec), "") == "both raise"
    big = np.random.default_rng(0).integers(0, 256, (120, 160, 3)).astype(np.uint8)
    _same_read(tmp_path, make_tiff(big, "RGB", compression=5, old_lzw=True))


@pytest.mark.parametrize("comp,what", [(6, "old-style JPEG"), (32809, "ThunderScan"),
                                       (34676, "SGILog"), (34677, "SGILog24"), (50001, "WebP"),
                                       (34925, None), (50000, None), (5, None)])
def test_what_stays_refused(comp, what):
    """Only old-style JPEG, ThunderScan, SGILog and WebP (and 12-bit
    JPEG-in-TIFF) stay with item 8c."""
    s = fx.tiff_samples("RGB", 8, 8, 0)
    data = make_tiff(s, "RGB", "<", 1, extra_tags={259: (3, [comp])})
    if what is None:
        assert imgcodecs.tiff_not_carried(data) is None
    else:
        assert imgcodecs.tiff_not_carried(data) == (f"{what} TIFF", "c")


# ---- the Zstandard decoder against libzstd ----------------------------------------

def _inputs():
    rng = np.random.default_rng(7)
    img = np.cumsum(rng.integers(-3, 4, (96, 256)), 1).astype(np.uint8).tobytes()
    text = b"".join(b"the %d quick brown foxes jump over %d lazy dogs; " % (k, k * 7 % 13)
                    for k in range(1500))
    return {"empty": b"", "one byte": b"a", "zeros": bytes(70000),
            "noise": rng.integers(0, 256, 3000, dtype=np.uint8).tobytes(),
            "levels": img, "text": text,
            "four symbols": rng.integers(0, 4, 140000, dtype=np.uint8).tobytes()}


INPUTS = _inputs()


@pytest.mark.parametrize("level", list(range(-5, 0)) + list(range(1, 23)))
def test_zstd_levels_decode_as_libzstd_decodes_them(level):
    """Every seeded input at the level, with and without the content size
    and the checksum: a strip of the input's size decodes to the input
    (the one-pass route where the frame states its size, block by block
    where it does not), a smaller strip to its head (block by block)."""
    for name, data in INPUTS.items():
        for size in (True, False):
            for check in (True, False):
                z = zstandard.ZstdCompressor(level=level, write_content_size=size,
                                             write_checksum=check).compress(data)
                head = len(data) // 3 + 1
                assert imgcodecs.zstd_decode(z, len(data)) == data, (name, size, check)
                assert imgcodecs.zstd_decode(z, head) == data[:head], (name, size, check)


def _block_kinds(frame: bytes) -> set:
    """The block types (raw, rle, compressed), literal section types (raw,
    rle, huffman 1 or 4 streams, treeless) and sequence table modes
    (predefined, rle, fse, repeat) of one frame."""
    le = lambda at, n: int.from_bytes(frame[at:at + n], "little")  # noqa: E731
    fhd = frame[4]
    single, fcs, did = (fhd >> 5) & 1, fhd >> 6, fhd & 3
    pos = 5 + (not single) + (0, 1, 2, 4)[did] + ((1 if single else 0) if fcs == 0 else 1 << fcs)
    kinds = set()
    while True:
        v = le(pos, 3)
        last, btype, size = v & 1, (v >> 1) & 3, v >> 3
        pos += 3
        kinds.add(("raw", "rle", "compressed")[btype] + " block")
        if btype == 2:
            lt, fmt = frame[pos] & 3, (frame[pos] >> 2) & 3
            kinds.add(("raw", "rle", "huffman", "treeless")[lt] + " literals"
                      + ("" if lt < 2 else (" 1 stream" if fmt == 0 else " 4 streams")))
            if lt < 2:
                lh, n = {1: (2, le(pos, 2) >> 4), 3: (3, le(pos, 3) >> 4)}.get(
                    fmt, (1, frame[pos] >> 3))
                q = pos + lh + (n if lt == 0 else 1)
            else:
                lhc = le(pos, 4)
                q = pos + {0: 3, 1: 3, 2: 4, 3: 5}[fmt] + {
                    0: (lhc >> 14) & 0x3FF, 1: (lhc >> 14) & 0x3FF, 2: lhc >> 18,
                    3: (lhc >> 22) + (le(pos + 4, 1) << 10)}[fmt]
            nseq = frame[q]
            q += 1 + (nseq >= 128) + (nseq == 255)
            if nseq:
                kinds |= {("predefined", "rle", "fse", "repeat")[frame[q] >> s & 3] + " sequences"
                          for s in (6, 4, 2)}
        pos += 1 if btype == 1 else size
        if last:
            return kinds


def test_block_and_literal_kinds_decode_as_libzstd_decodes_them():
    """Raw blocks (incompressible data), RLE blocks (a run of one byte),
    Huffman literals in 1 and 4 streams, and treeless literals (a later
    block reusing the table), each seen in a frame and decoded."""
    rng = np.random.default_rng(3)
    p = np.linspace(1, 3, 13)
    cases = {"raw": rng.integers(0, 256, 200000, dtype=np.uint8).tobytes(),
             "rle": bytes(300000) + b"x" * 300000,
             "treeless": bytes(rng.choice(np.arange(97, 110, dtype=np.uint8), 400000,
                                          p=p / p.sum())),
             "text": INPUTS["text"] * 4, "levels": INPUTS["levels"] * 3,
             "short literals": bytes(rng.integers(97, 100, 700, dtype=np.uint8))}
    seen = set()
    for data in cases.values():
        for level in (-1, 1, 3, 19):
            z = zstandard.ZstdCompressor(level=level, write_checksum=True).compress(data)
            seen |= _block_kinds(z)
            assert imgcodecs.zstd_decode(z, len(data)) == data
    assert {"raw block", "rle block", "raw literals", "huffman literals 1 stream",
            "huffman literals 4 streams", "treeless literals 4 streams",
            "predefined sequences", "fse sequences", "repeat sequences"} <= seen, seen


def test_several_frames_and_skippable_frames():
    """libtiff's ZSTD_decompressStream loop stops where a strip's first
    frame ends, as zstandard's decompressobj (one frame) does: a strip of
    several frames reads its first, one behind a skippable frame reads
    nothing; a frame of raw blocks alone (``zstd_stored``) reads whole."""
    c = zstandard.ZstdCompressor(level=3)
    a, b = INPUTS["levels"], INPUTS["text"]
    skip = struct.pack("<II", 0x184D2A53, 5) + b"hello"
    data = c.compress(a) + skip + c.compress(b) + struct.pack("<II", 0x184D2A50, 0)
    behind = skip + c.compress(a)
    for z, want in ((data, a), (behind, b"")):
        assert zstandard.ZstdDecompressor().decompressobj().decompress(z) == want
    assert imgcodecs.zstd_decode(data, len(a) + len(b)) == a
    assert imgcodecs.zstd_decode(behind, len(a)) == b""
    assert imgcodecs.zstd_decode(fx.zstd_stored(a), len(a)) == a


def test_a_checksum_mismatch_raises(tmp_path):
    """The content checksum (XXH64's low 32 bits) checked as libzstd
    checks it: a wrong one raises in a strip and in both packages' reads
    of a TIFF."""
    data = INPUTS["levels"]
    z = bytearray(zstandard.ZstdCompressor(level=5, write_checksum=True).compress(data))
    assert imgcodecs.zstd_decode(bytes(z), len(data)) == data
    z[-1] ^= 0x10
    with pytest.raises(zstandard.ZstdError):
        zstandard.ZstdDecompressor().decompress(bytes(z))
    with pytest.raises(ValueError, match="doesn't match checksum"):
        imgcodecs.zstd_decode(bytes(z), len(data))
    s = fx.tiff_samples("L", 96, 256, 0)

    def codec(b):
        out = bytearray(zstandard.ZstdCompressor(write_checksum=True).compress(b))
        out[-2] ^= 1
        return bytes(out)

    assert _held(tmp_path, make_tiff(s, "L", compression=50000, codec=codec), "") == "both raise"


@pytest.mark.parametrize("seed", range(6))
def test_damaged_frames_raise_where_libzstd_raises(seed):
    """Seeded frames with bits flipped or bytes changed, read as strips of
    twice the input's size: the decoder raises where zstandard's
    decompressobj (ZSTD_decompressStream into an output of that size)
    raises, and gives its bytes where it does not."""
    rng = np.random.default_rng(100 + seed)
    kept = 0
    for case in range(60):
        data = list(INPUTS.values())[3 + case % 4]
        z = bytearray(zstandard.ZstdCompressor(level=int(rng.integers(-3, 20)),
                                               write_checksum=bool(case % 3)).compress(data))
        for _ in range(int(rng.integers(1, 3))):
            z[int(rng.integers(len(z)))] ^= 1 << int(rng.integers(8))
        cap = 2 * len(data)
        try:
            want = zstandard.ZstdDecompressor().decompressobj(write_size=cap).decompress(bytes(z))
        except zstandard.ZstdError:
            with pytest.raises(ValueError):
                imgcodecs.zstd_decode(bytes(z), cap)
            continue
        assert imgcodecs.zstd_decode(bytes(z), cap) == want
        kept += 1
    assert kept


def test_a_block_that_makes_too_much_is_refused_at_once():
    """A frame of unknown size whose one compressed block asks for 98303
    sequences of 65540 bytes each (RLE literals and RLE tables, the bit
    stream read past its start as zeros): libzstd refuses it for want of
    room once the block passes its 128 KiB, and so does the strip decoder,
    without making the 6 GB the sequences ask for."""
    lit = 100000                                    # RLE literals, 20-bit size
    literals = bytes([1 | 3 << 2 | (lit & 0xF) << 4, (lit >> 4) & 0xFF, lit >> 12]) + b"a"
    # 0xFF then 0xFFFF: 0x7F00 + 0xFFFF sequences; LL, OF and ML tables RLE
    # (literal length 1, repeat offset 1, match length code 52: 65539 + 16 bits)
    seqs = b"\xff\xff\xff" + bytes([0b01010100, 1, 0, 52]) + b"\x01"
    body = literals + seqs
    frame = (struct.pack("<I", 0xFD2FB528) + bytes([0x00, 7 << 3])   # window 128 KiB
             + (1 | 2 << 1 | len(body) << 3).to_bytes(3, "little") + body)
    with pytest.raises(zstandard.ZstdError, match="too small"):
        zstandard.ZstdDecompressor().decompressobj(write_size=1 << 20).decompress(frame)
    with pytest.raises(ValueError, match="Destination buffer is too small"):
        imgcodecs.zstd_decode(frame, 1 << 20)


# ---- damaged strips ------------------------------------------------------------------

def _damage(data: bytes, rng) -> bytes:
    """One strip or tile of the file damaged: bits flipped, a byte
    replaced, the tail overwritten, or its last bytes changed."""
    _, t = imgcodecs._tiff_tags(data)
    offsets, counts = t.get(273) or t.get(324), t.get(279) or t.get(325)
    k = int(rng.integers(len(offsets)))
    off, cnt = offsets[k], counts[k]
    out = bytearray(data)
    kind = int(rng.integers(4))
    if kind == 0:
        for _ in range(int(rng.integers(1, 4))):
            out[off + int(rng.integers(cnt))] ^= 1 << int(rng.integers(8))
    elif kind == 1:
        out[off + int(rng.integers(cnt))] = int(rng.integers(256))
    elif kind == 2:
        at = int(rng.integers(cnt))
        out[off + at:off + cnt] = rng.integers(0, 256, cnt - at, dtype=np.uint8).tobytes()
    else:
        out[off + cnt - 1 - int(rng.integers(min(cnt, 40)))] ^= 1 << int(rng.integers(8))
    return bytes(out)


def _damage_bases(comp: str) -> list:
    out = []
    for seed in range(3):
        rgb = fx.levels((40, 60), seed)
        out.append(_pil(Image.fromarray(rgb), compression=comp))
        out.append(_pil(Image.fromarray(rgb).convert("L"), compression=comp,
                        tiffinfo={317: 2}, strip_size=60 * 9))
        code = 50000 if comp == "zstd" else 34925
        out.append(make_tiff(fx.tiff_samples("RGB", 40, 60, seed), "RGB", compression=code,
                             predictor=2, tile=(16, 32)))
    return out


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("comp", ["zstd", "lzma"])
def test_damaged_strips_read_as_pillow_reads_them(comp, seed, tmp_path):
    """40 seeded damaged strips of Pillow's and make_tiff's files:
    Pillow's pixels, or both raise.  An LZMA strip that liblzma finds
    corrupt before the strip is full the port refuses (libtiff keeps what
    its liblzma decoded before noticing, which differs between liblzma
    versions)."""
    rng = np.random.default_rng(1000 * len(comp) + seed)
    bases = _damage_bases(comp)
    seen = set()
    for case in range(40):
        data = _damage(bases[case % len(bases)], rng)
        seen.add(_held(tmp_path, data, "liblzma finds the data corrupt" if comp == "lzma" else ""))
    assert seen & {"same", "both raise"}
