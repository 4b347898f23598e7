"""The port's Photoshop reader (``dspfun_tpu_torch/io/psd.py``,
``native/rawimg.cpp:packbits_decode``; ROADMAP queue 1, item 8h) against
the JAX package, which reads PSD through Pillow 12.1's
``PsdImagePlugin``.

* Reads: files written by ``tests/torch_codec_fixtures.py:make_psd`` in
  every mode of Pillow's ``MODES`` (bitmap, gray, indexed, RGB, RGBA,
  CMYK, multichannel, duotone, Lab), raw and PackBits, odd sizes,
  resources and a layer section, more channels than the mode's; read
  through both packages' ``read_image`` as RGB, RGBA and I, with cv2
  importable and blocked: the same pixels and depth, or an error in both.
  16- and 32-bit files and ZIP compression: an error in both.
* Seeded truncated and damaged files: an error in both or the same
  pixels; the format the port picks is ``Image.open``'s.
* Lab: Pillow's LittleCMS conversion on a sweep of (L, a, b) triples.
* ``chip_smoke.PSD_DDS_FIXTURES`` (phase 25) holds the sha256 of each
  fixture and of the JAX package's read of it, ``PSD_4K_CROP`` the PSD
  writer's bytes of phase 25's 4K levels at a crop.
"""

import hashlib
import io
import struct

import numpy as np
import pytest
from PIL import Image

import chip_smoke
from dspfun_tpu_torch.io import images as timages
from dspfun_tpu_torch.io import psd
from tests import torch_codec_fixtures as fx
from tests.test_torch_other_formats import _pillow_format, _port_format, _same_read

PSD_NAMES = sorted(fx.psd_fixtures())


@pytest.mark.parametrize("name", PSD_NAMES)
def test_psd_fixtures_read_as_the_jax_package_reads_them(name, tmp_path, monkeypatch):
    data = fx.psd_fixtures()[name]
    assert timages._decoder(data) is psd.decode_psd
    assert _pillow_format(data) == "PSD"
    jax = _same_read(tmp_path, data, monkeypatch)
    assert not any(isinstance(j, Exception) for j in jax.values())


def _planes(mode: int, bits: int, extra: int, h: int, w: int, seed: int) -> np.ndarray:
    nch = psd.MODES[(mode, bits)][1] + extra
    rb = (w + 7) // 8 if bits == 1 else w
    rng = np.random.default_rng(seed)
    planes = rng.integers(0, 256, (nch, h, rb), dtype=np.uint8)
    planes[:, :, : rb // 2] = planes[:, :, :1]      # runs for PackBits
    return planes


SIZES = [(1, 1), (5, 7), (9, 17), (16, 3)]


@pytest.mark.parametrize("key", sorted(psd.MODES))
@pytest.mark.parametrize("comp", [0, 1])
def test_every_mode_raw_and_packbits(key, comp, tmp_path, monkeypatch):
    """Each (mode, bits) of ``MODES`` at odd sizes, with 0, 1 and 2
    channels past the mode's (in a PackBits file those start the first
    channel inside the byte-count table, as Pillow reads it), resources
    of odd and even lengths and a layer section."""
    mode, bits = key
    res = fx.psd_resource(1005, b"ab", b"x" * 17) + fx.psd_resource(1039, b"", b"icc!") \
        + fx.psd_resource(7, b"odd", b"")
    pal = np.random.default_rng(1).integers(0, 256, 768, dtype=np.uint8).tobytes()
    for extra in (0, 1, 2):
        for k, (h, w) in enumerate(SIZES):
            planes = _planes(mode, bits, extra, h, w, 100 * mode + 10 * extra + k)
            data = fx.make_psd(planes, mode, bits, comp, width=w,
                               color_data=pal if mode == 2 else b"", resources=res,
                               layers=fx.psd_layers(k) if k % 2 else None)
            _same_read(tmp_path, data, monkeypatch)


@pytest.mark.parametrize("case", ["16-bit RGB", "32-bit gray", "16-bit CMYK", "zip RGB",
                                  "zip prediction gray", "compression 5", "2-bit bitmap",
                                  "1-bit gray", "Lab with 2 channels", "version 2",
                                  "no palette", "palette of 767 bytes"])
def test_what_pillow_does_not_read_or_reads_otherwise(case, tmp_path, monkeypatch):
    """Files outside ``MODES``, ZIP and other compressions, too few
    channels, another version: an error in both packages; an indexed file
    without its 768-byte palette: the same (black) pixels."""
    planes = _planes(3, 8, 0, 6, 9, 7)
    made = {
        "16-bit RGB": lambda: fx.make_psd(np.repeat(planes, 2, axis=2), 3, bits=16),
        "32-bit gray": lambda: fx.make_psd(np.repeat(planes[:1], 4, axis=2), 1, bits=32),
        "16-bit CMYK": lambda: fx.make_psd(np.repeat(np.concatenate([planes, planes[:1]]), 2,
                                                     axis=2), 4, bits=16),
        "zip RGB": lambda: fx.make_psd(planes, 3, compression=2, body=b"x\x9c" + bytes(40)),
        "zip prediction gray": lambda: fx.make_psd(planes[:1], 1, compression=3),
        "compression 5": lambda: fx.make_psd(planes, 3, compression=5, body=planes.tobytes()),
        "2-bit bitmap": lambda: fx.make_psd(planes[:1], 0, bits=2),
        "1-bit gray": lambda: fx.make_psd(planes[:1], 1, bits=1, width=72),
        "Lab with 2 channels": lambda: fx.make_psd(planes[:2], 9),
        "version 2": lambda: fx.make_psd(planes, 3)[:4] + b"\0\2" + fx.make_psd(planes, 3)[6:],
        "no palette": lambda: fx.make_psd(planes[:1], 2),
        "palette of 767 bytes": lambda: fx.make_psd(planes[:1], 2, color_data=bytes(767)),
    }
    jax = _same_read(tmp_path, made[case](), monkeypatch)
    if "palette" in case:
        assert not isinstance(jax["RGB"], Exception) and not jax["RGB"].pixels.any()
    else:
        assert isinstance(jax["RGB"], Exception), case


def _damaged(seed: int) -> list:
    rng = np.random.default_rng(seed)
    out = []
    names = PSD_NAMES[seed % 4::4]
    made = fx.psd_fixtures()
    for name in names:
        base = made[name]
        for cut in (int(rng.integers(1, 60)), int(rng.integers(60, 200)), len(base) // 2,
                    len(base) - 1):
            out.append(base[:cut])
        for _ in range(4):
            d = bytearray(base)
            for _ in range(int(rng.integers(1, 4))):
                at = int(rng.integers(0, min(len(base), 400)))
                d[at] ^= int(rng.integers(1, 256))
            out.append(bytes(d))
    return out


@pytest.mark.parametrize("seed", range(8))
def test_truncated_and_damaged_psds(seed, tmp_path, monkeypatch):
    """Fixtures cut short and with bytes of their headers, tables and
    first rows changed at random: an error in both packages or the same
    pixels, and the format the port picks is Pillow's."""
    for data in _damaged(seed):
        want, got = _pillow_format(data), _port_format(data)
        if isinstance(want, Exception):
            assert isinstance(got, Exception), (got, want)
        else:
            assert got == want, (got, want)
        _same_read(tmp_path, data, monkeypatch)


def test_lab_is_pillows_conversion_on_a_sweep_of_triples():
    """Lab channels as stored (a and b offset by 128) through Pillow's
    ``convert("RGBA")`` (its LittleCMS transform) on 64k seeded triples
    and the corners: the same RGB, alpha 0 (the fourth byte of Pillow's
    LAB pixels, which its band decoders leave at 0)."""
    rng = np.random.default_rng(8)
    lab = rng.integers(0, 256, (3, 256, 256), dtype=np.uint8)
    corners = np.array(np.meshgrid([0, 1, 127, 128, 129, 254, 255], [0, 128, 255], [0, 128, 255],
                                   indexing="ij")).reshape(3, -1)
    lab[:, 0, :corners.shape[1]] = corners
    data = fx.make_psd(lab, 9)
    want = np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"))
    got = psd.decode_psd(data)[0]
    np.testing.assert_array_equal(got, want)
    assert (want[..., 3] == 0).all()


def test_packbits_rows_cut_at_the_row_end():
    """A repeat or literal packet that passes a row's end is cut there (the
    rest dropped, as Pillow's decoder drops it), and the no-op 0x80 is
    skipped."""
    w, h = 7, 3
    rows = [bytes([0xFD, 5]) + bytes([0x80]) + bytes([5, 1, 2, 3, 4, 5, 6]),   # 4 + 6 > 7
            bytes([0xF8, 9]),                                                 # 9 repeats of 9
            bytes([8]) + bytes(range(20, 29))]                                # a literal of 9
    body = struct.pack(">3H", *map(len, rows)) + b"".join(rows)
    data = fx.make_psd(np.zeros((1, h, w), np.uint8), 1, compression=7)[:-2] + b"\0\1" + body
    want = np.asarray(Image.open(io.BytesIO(data)).convert("L"))
    got = psd.decode_psd(data)[0][..., 0]
    np.testing.assert_array_equal(got, want)
    assert got[1].tolist() == [9] * 7


def test_phase_25_psd_writer_at_a_crop():
    """Phase 25's 4K PackBits PSD of ``CODEC_4K``'s levels: at a 1:8 crop
    the writer's file is pinned (``PSD_4K_CROP``) and Pillow reads it back
    to the levels, as the port does."""
    hw, seed, noise = chip_smoke.CODEC_4K
    lv = fx.levels((hw[0] // 8, hw[1] // 8), seed, noise=noise)
    data = fx.psd_4k(lv)
    assert hashlib.sha256(data).hexdigest() == chip_smoke.PSD_4K_CROP
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(data))), lv)
    np.testing.assert_array_equal(psd.decode_psd(data)[0], lv)
