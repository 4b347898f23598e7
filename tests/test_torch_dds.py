"""The port's DirectDraw Surface codec (``dspfun_tpu_torch/io/dds.py``,
``native/bcn.cpp``; ROADMAP queue 1, item 8h) against the JAX package,
which reads and writes DDS through Pillow 12.1's ``DdsImagePlugin``.

* Reads: Pillow's own files (uncompressed RGB, RGBA, L, LA and each
  ``pixel_format`` it writes) and files made by hand (bit masks of 16, 24
  and 32 bits, the 8-bit palette, BC4, BC5 signed, ATI1 and ATI2, DX10
  headers, a mipmap after the top surface), through both packages'
  ``read_image`` as RGB, RGBA and I, with cv2 importable and blocked: the
  same pixels and depth, or an error in both.
* The block formats BC1 to BC7 (BC5 signed, BC6H unsigned and signed, BC7
  and its sRGB form) on seeded random blocks (which take every mode,
  partition and reserved mode) at sizes that are not multiples of 4:
  the port's decode equals Pillow's ``convert("RGBA")``.
* Seeded truncated and damaged files, and headers Pillow refuses: an
  error in both or the same pixels; the format the port picks is
  ``Image.open``'s.
* Writes: RGB, RGBA and I to ``.dds`` are the JAX package's bytes; 16-bit
  gray is refused by both with no file left.
* ``chip_smoke.PSD_DDS_FIXTURES`` (phase 25a) holds the sha256 of each
  fixture of ``torch_codec_fixtures.psd_dds_fixtures()`` and of the JAX
  package's read of it; ``BC7_4K`` and ``DDS_4K`` the digests of phase
  25's 4K BC7 decode and 4K write, here at a crop or pinned to Pillow.
"""

import hashlib
import io
import struct
import sys

import numpy as np
import pytest
from PIL import Image

import chip_smoke
from dspfun_tpu.io import images as jimages
from dspfun_tpu_torch.io import dds
from dspfun_tpu_torch.io import images as timages
from tests import torch_codec_fixtures as fx
from tests.test_torch_other_formats import _pillow_format, _port_format, _same_read, _write

DDS_NAMES = sorted(n for n in fx.psd_dds_fixtures() if n.endswith(".dds"))


def test_phase_25_fixtures_are_pinned():
    """``psd_dds_goldens()`` remakes each Pillow golden byte for byte,
    every fixture of phase 25 is made the same way again, and
    ``chip_smoke.PSD_DDS_FIXTURES`` holds the sha256 of each and of the JAX
    package's RGBA read of it."""
    made = fx.psd_dds_goldens()
    assert sorted(made) == sorted(fx.PSD_DDS_GOLDENS)
    for name, data in made.items():
        assert (fx.GOLDENS / name).read_bytes() == data, name
        assert len(data) < 64 * 1024
    every = fx.psd_dds_fixtures()
    assert every == fx.psd_dds_fixtures(made)
    assert sorted(every) == sorted(chip_smoke.PSD_DDS_FIXTURES)
    for name, data in every.items():
        assert fx.other_digests(data) == chip_smoke.PSD_DDS_FIXTURES[name], name


@pytest.mark.parametrize("name", DDS_NAMES)
def test_dds_fixtures_read_as_the_jax_package_reads_them(name, tmp_path, monkeypatch):
    data = fx.psd_dds_fixtures()[name]
    assert timages._decoder(data) is dds.decode_dds
    assert _pillow_format(data) == "DDS"
    jax = _same_read(tmp_path, data, monkeypatch)
    assert not any(isinstance(j, Exception) for j in jax.values())


# ---- the block formats on seeded random blocks ---------------------------------------

BLOCKS = {  # name -> (four-CC or DXGI format, bytes a block)
    "BC1 (DXT1)": (b"DXT1", 8), "BC2 (DXT3)": (b"DXT3", 16), "BC3 (DXT5)": (b"DXT5", 16),
    "BC4": (b"BC4U", 8), "BC5": (b"BC5U", 16), "BC5S": (b"BC5S", 16),
    "BC1 DX10": (71, 8), "BC2 DX10": (74, 16), "BC3 DX10": (77, 16), "BC4 DX10": (80, 8),
    "BC5 DX10": (83, 16), "BC5S DX10": (84, 16), "BC6H UF16": (95, 16),
    "BC6H SF16": (96, 16), "BC7": (98, 16), "BC7 SRGB": (99, 16),
}
BLOCK_SIZES = [(1, 1), (3, 2), (13, 9), (47, 33)]


def _block_file(name: str, w: int, h: int, seed: int) -> bytes:
    fmt, nbytes = BLOCKS[name]
    body = fx.bc_blocks(w, h, nbytes, seed)
    if isinstance(fmt, bytes):
        return fx.dds_file(w, h, body, 0x4, fourcc=fmt)
    return fx.dds_file(w, h, body, 0x4, dxgi=fmt)


@pytest.mark.parametrize("name", sorted(BLOCKS))
@pytest.mark.parametrize("seed", range(3))
def test_block_formats_on_seeded_random_blocks(name, seed):
    """Every block format at sizes that are not multiples of 4: the port's
    samples equal Pillow's ``convert("RGBA")`` (tolerance 0)."""
    for w, h in BLOCK_SIZES:
        data = _block_file(name, w, h, 1000 * seed + 7 * w + h)
        want = np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"))
        arr = dds.decode_dds(data)[0]
        got = np.asarray(timages._rgba(arr, None) * 255.0).round().astype(np.uint8)
        np.testing.assert_array_equal(got, want, err_msg=f"{name} {w}x{h}")


@pytest.mark.parametrize("name", ["BC6H UF16", "BC6H SF16", "BC7"])
def test_every_mode_of_bc6h_and_bc7(name):
    """Random blocks whose first byte is set to each mode's number (and
    the reserved ones): each of BC6H's 14 modes and BC7's 8, over many
    partitions, equals Pillow."""
    fmt, _ = BLOCKS[name]
    firsts = [1 << k for k in range(8)] + [0] if name == "BC7" else \
        [0, 1] + [m for m in range(32) if m & 2]
    rng = np.random.default_rng(len(name))
    for first in firsts:
        body = bytearray(rng.integers(0, 256, 64 * 16, dtype=np.uint8).tobytes())
        for b in range(64):
            if name == "BC7":
                body[16 * b] = (body[16 * b] & ~((first << 1) - 1) & 0xFF) | first if first \
                    else 0
            else:
                nbits = 2 if first < 2 else 5
                body[16 * b] = (body[16 * b] & (0xFF << nbits) & 0xFF) | first
        data = fx.dds_file(4 * 64, 4, bytes(body), 0x4, dxgi=fmt)
        want = np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"))
        arr = dds.decode_dds(data)[0]
        got = np.asarray(timages._rgba(arr, None) * 255.0).round().astype(np.uint8)
        np.testing.assert_array_equal(got, want, err_msg=f"{name} mode byte {first:#x}")


def test_bc6h_half_to_8_bit_is_pillows():
    """``half_to_u8`` on every half float: 0 below 0 (and -0), 255 above 1,
    else the float32 product by 255 truncated (checked against Pillow
    through blocks of mode 11 whose endpoint 0 is each 10-bit value in
    turn, in both signednesses)."""
    h = np.arange(65536, dtype=np.uint32).astype(np.uint16)
    v = h.view(np.float16).astype(np.float64)
    got = dds.half_to_u8(h).astype(np.int64)
    finite = np.isfinite(v)
    assert (got[finite & (v < 0)] == 0).all() and (got[finite & (v > 1)] == 255).all()
    mid = finite & (v >= 0) & (v <= 1)
    assert (got[mid] == np.floor(np.float32(v[mid]) * np.float32(255))).all()
    for fmt in (95, 96):
        blocks = b""
        for e in range(1024):
            bits = 3 | e << 5 | e << 15 | e << 25
            blocks += bits.to_bytes(16, "little")
        data = fx.dds_file(4 * 1024, 4, blocks, 0x4, dxgi=fmt)
        want = np.asarray(Image.open(io.BytesIO(data)))
        np.testing.assert_array_equal(dds.decode_dds(data)[0], want)


# ---- headers, damage and identification -------------------------------------------------

def _header_cases() -> dict:
    w, h = 9, 7
    body = bytes(range(256)) * 2
    rgba8 = np.random.default_rng(3).integers(0, 256, (h, w, 4), dtype=np.uint8).tobytes()
    base = fx.dds_file(w, h, rgba8, 0x41, bitcount=32,
                       masks=(0xFF0000, 0xFF00, 0xFF, 0xFF000000))
    return {
        "header size 100": base[:4] + struct.pack("<I", 100) + base[8:],
        "short header": base[:60],
        "magic only": b"DDS ",
        "luminance 16 without alpha": fx.dds_file(w, h, body, 0x20000, bitcount=16),
        "luminance 4": fx.dds_file(w, h, body, 0x20000, bitcount=4),
        "luminance 16 with alpha": fx.dds_file(w, h, body, 0x20001, bitcount=16),
        "no pixel format flags": fx.dds_file(w, h, body, 0),
        "four-CC DXT2": fx.dds_file(w, h, body, 0x4, fourcc=b"DXT2"),
        "four-CC BC4S": fx.dds_file(w, h, body, 0x4, fourcc=b"BC4S"),
        "DXGI BC4 signed": fx.dds_file(w, h, body, 0x4, dxgi=81),
        "DXGI float RGBA": fx.dds_file(w, h, body, 0x4, dxgi=2),
        "DX10 header cut": fx.dds_file(w, h, b"", 0x4, dxgi=98)[:130],
        "DX10 RGBA8 short": fx.dds_file(w, h, body[:100], 0x4, dxgi=28),
        "RGB masks, 0 bits a pixel": fx.dds_file(w, h, body, 0x40, bitcount=0,
                                                 masks=(0xF, 0xF0, 0xF00, 0)),
        "RGB masks, 48 bits a pixel": fx.dds_file(w, h, body, 0x40, bitcount=48,
                                                  masks=(0xFF, 0xFF00, 0xFF000000, 0)),
        "RGBA with gappy masks": fx.dds_file(w, h, body, 0x41, bitcount=16,
                                             masks=(0x5, 0x18, 0xE0, 0x8200)),
        "RGB, file short": fx.dds_file(w, h, body[:50], 0x40, bitcount=24,
                                       masks=(0xFF0000, 0xFF00, 0xFF, 0)),
        "RGB flag over luminance": fx.dds_file(w, h, body, 0x20040, bitcount=8,
                                               masks=(0xE0, 0x1C, 0x3, 0)),
        "palette short": fx.dds_file(w, h, b"", 0x20, palette=bytes(500)),
        "width 0": fx.dds_file(0, h, body, 0x20000, bitcount=8),
        "BC1 one block short": fx.dds_file(w, h, fx.bc_blocks(w, h, 8, 1)[:-1], 0x4,
                                           fourcc=b"DXT1"),
        "BC7 with mipmaps": fx.dds_file(w, h, fx.bc_blocks(w, h, 16, 2) + bytes(200), 0x4,
                                        dxgi=98, mipmaps=3),
    }


HEADER_CASES = _header_cases()


@pytest.mark.parametrize("case", sorted(HEADER_CASES))
def test_headers_read_as_the_jax_package_reads_them(case, tmp_path, monkeypatch):
    data = HEADER_CASES[case]
    want, got = _pillow_format(data), _port_format(data)
    if isinstance(want, Exception):
        assert isinstance(got, Exception), (got, want)
    else:
        assert got == want, (got, want)
    _same_read(tmp_path, data, monkeypatch)


def _damaged(seed: int) -> list:
    rng = np.random.default_rng(seed)
    made = fx.psd_dds_fixtures()
    out = []
    for name in DDS_NAMES[seed::8]:
        base = made[name]
        for cut in (int(rng.integers(1, 150)), len(base) // 2, len(base) - 1):
            out.append(base[:cut])
        for _ in range(3):
            d = bytearray(base)
            for _ in range(int(rng.integers(1, 4))):
                at = int(rng.integers(0, min(len(base), 160)))
                d[at] ^= int(rng.integers(1, 256))
            out.append(bytes(d))
    return out


@pytest.mark.parametrize("seed", range(8))
def test_truncated_and_damaged_dds_files(seed, tmp_path, monkeypatch):
    for data in _damaged(seed):
        want, got = _pillow_format(data), _port_format(data)
        if isinstance(want, Exception):
            assert isinstance(got, Exception), (got, want)
        else:
            assert got == want, (got, want)
        _same_read(tmp_path, data, monkeypatch)


# ---- writes ------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["RGB", "RGBA", "I", "I16", "RGB16"])
@pytest.mark.parametrize("shape", [(37, 41), (1, 1), (4, 3)])
def test_dds_writes_are_the_jax_packages_bytes(kind, shape, tmp_path, monkeypatch):
    """``write_image`` to ``.dds``: the JAX package's bytes (Pillow's
    uncompressed ``_save``) for RGB, RGBA and I at 8 bits, with cv2 and
    without it; 16 bits raise in both and leave no file."""
    ch, depth = kind.rstrip("16"), 16 if kind.endswith("16") else 8
    pix = np.random.default_rng(shape[0] + len(kind)).random(shape + (len(ch),))
    for who in ("j", "t"):
        (tmp_path / who).mkdir()
    monkeypatch.chdir(tmp_path / "j")
    jerr = _write(jimages, "out.dds", pix, ch, depth)
    monkeypatch.chdir(tmp_path / "t")
    for blocked in (False, True):
        if blocked:
            monkeypatch.setitem(sys.modules, "cv2", None)
        terr = _write(timages, "out.dds", pix, ch, depth)
        assert (jerr is None) == (terr is None), (jerr, terr)
        if jerr is not None:
            assert not (tmp_path / "t" / "out.dds").exists()
            continue
        assert (tmp_path / "t" / "out.dds").read_bytes() \
            == (tmp_path / "j" / "out.dds").read_bytes()


def test_phase_25_digests():
    """``DDS_4K``: Pillow's uncompressed DDS of ``CODEC_4K``'s levels, which
    the port's ``encode_dds`` writes on the card; ``BC7_4K``: Pillow's
    decode of phase 25's 4K BC7 file (both made here at full size)."""
    hw, seed, noise = chip_smoke.CODEC_4K
    lv = fx.levels(hw, seed, noise=noise)
    want = hashlib.sha256(fx._save(Image.fromarray(lv), "DDS")).hexdigest()
    assert want == chip_smoke.DDS_4K
    assert hashlib.sha256(dds.encode_dds(lv[::8, ::8].copy())).hexdigest() \
        == hashlib.sha256(fx._save(Image.fromarray(lv[::8, ::8].copy()), "DDS")).hexdigest()
    data = fx.bc7_4k(hw, chip_smoke.BC7_4K_SEED)
    assert hashlib.sha256(data).hexdigest() == chip_smoke.BC7_4K[0]
    rgba = np.asarray(Image.open(io.BytesIO(data)))
    assert hashlib.sha256(rgba.tobytes()).hexdigest() == chip_smoke.BC7_4K[1]
    crop = fx.bc7_4k((hw[0] // 8, hw[1] // 8), chip_smoke.BC7_4K_SEED)
    np.testing.assert_array_equal(dds.decode_dds(crop)[0],
                                  np.asarray(Image.open(io.BytesIO(crop))))
