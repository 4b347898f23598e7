"""g1's writes in the port (``io/rasters.py:encode_spider``, ``io/icns.py:
encode_icns`` with the BICUBIC resample of ``native/rawimg.cpp``, and
``io/images.py``'s ``_PILLOW_FAILS``) against the JAX package's
``write_image``, which saves through Pillow 12.1:

* SPIDER and ICNS files byte-equal to the JAX package's for ``RGB``,
  ``RGBA``, ``I`` at 8 and 16 bits, at sizes under 32 pixels, square and
  not; ``chip_smoke.CONTAINER_WRITE_DIGESTS`` (phase 31c) at a crop;
* ``convert("F")`` and ``Image.resize((s, s))``'s BICUBIC equal to
  Pillow's;
* R1: XBM, MSP, PALM and BLP writes, which Pillow cannot make of the
  images the JAX package hands it, raise its exception class and message
  in both packages and leave no file.
"""

import hashlib
import sys

import numpy as np
import pytest

import chip_smoke
from dspfun_tpu.io import images as jimages
from dspfun_tpu_torch.io import ico, icns, rasters
from dspfun_tpu_torch.io import images as timages
from tests import torch_codec_fixtures as fx

KINDS = {"RGB": ("RGB", 8), "RGBA": ("RGBA", 8), "I": ("I", 8), "I16": ("I", 16)}
SIZES = ((17, 23), (5, 3), (1, 1), (40, 31), (64, 64), (300, 7))


def _write(mod, path, pix, channels, depth):
    try:
        mod.write_image(str(path), pix, channels=channels, depth=depth)
    except Exception as e:  # noqa: BLE001 — Pillow's own error, whatever its class
        return type(e), str(e), path.exists()
    return path.read_bytes()


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("ext", ("spider", "icns"))
def test_writes_are_the_jax_packages_bytes(ext, kind, size, tmp_path):
    """SPIDER (``convert("F")``, its header of whole records, float32 rows)
    and ICNS (a BICUBIC resize to each of 32-1024 pixels through the PNG
    writer) of each channel set and depth: the JAX package's bytes."""
    ch, depth = KINDS[kind]
    w, h = size
    pix = np.random.default_rng(w * h + depth).random((h, w, len(ch)))
    want = _write(jimages, tmp_path / f"j.{ext}", pix, ch, depth)
    assert isinstance(want, bytes)
    assert _write(timages, tmp_path / f"t.{ext}", pix, ch, depth) == want


def test_icns_writes_read_back_as_the_jax_package_reads_them(tmp_path):
    """The port's ICNS of an RGBA image reads back through both packages
    to the same pixels (its 1024-pixel frame)."""
    pix = np.random.default_rng(3).random((20, 12, 4))
    timages.write_image(str(tmp_path / "a.icns"), pix, channels="RGBA")
    j = jimages.read_image(str(tmp_path / "a.icns"), channels="RGBA")
    t = timages.read_image(str(tmp_path / "a.icns"), channels="RGBA")
    assert t.depth == j.depth == 8 and t.pixels.shape == (1024, 1024, 4)
    np.testing.assert_array_equal(t.pixels, j.pixels)


def test_phase_31_writes_are_pillows_at_a_crop(tmp_path):
    """``chip_smoke.CONTAINER_WRITE_DIGESTS`` holds the JAX package's ICNS
    and SPIDER of phase 31c's 4K picture; here both packages write a 1:8
    crop of it to the same bytes, and the SPIDER digest is checked at full
    size (a float32 copy: the ICNS's resizes take the card's host)."""
    pic = fx.raster_picture()
    crop = pic[: pic.shape[0] // 8, : pic.shape[1] // 8] / 255.0
    for ext in ("icns", "spider"):
        assert _write(jimages, tmp_path / f"j.{ext}", crop, "RGB", 8) == \
            _write(timages, tmp_path / f"t.{ext}", crop, "RGB", 8)
    full = rasters.encode_spider(pic)
    assert hashlib.sha256(full).hexdigest() == chip_smoke.CONTAINER_WRITE_DIGESTS["spider"]
    assert sorted(chip_smoke.CONTAINER_WRITE_DIGESTS) == ["icns", "spider"]


def test_float_conversion_is_pillows_on_every_colour():
    """``to_float`` equals Pillow's ``convert("F")`` of all 2^24 RGB
    colours (the products in double, then float32) and of RGBA (alpha
    unread), in four slabs; and of every 16-bit gray level."""
    from PIL import Image

    v = np.arange(1 << 24, dtype=np.uint32).reshape(4096, 4096)
    for k in range(4):
        s = v[1024 * k:1024 * (k + 1)]
        rgb = np.stack([s >> 16 & 255, s >> 8 & 255, s & 255], -1).astype(np.uint8)
        want = np.asarray(Image.fromarray(rgb).convert("F"))
        np.testing.assert_array_equal(rasters.to_float(rgb), want)
        rgba = np.concatenate([rgb, rgb[..., :1] ^ 0x5A], -1)
        np.testing.assert_array_equal(rasters.to_float(rgba),
                                      np.asarray(Image.fromarray(rgba).convert("F")))
    g = np.arange(65536, dtype=np.uint16).reshape(256, 256)
    np.testing.assert_array_equal(rasters.to_float(g), np.asarray(Image.fromarray(g).convert("F")))


THUMB_SHAPES = [(16, 16), (20, 16), (16, 40), (300, 300), (257, 16), (1000, 17), (33, 70),
                (90, 61), (15, 100), (3, 3)]


@pytest.mark.parametrize("shape", THUMB_SHAPES)
@pytest.mark.parametrize("kind", ["RGB", "RGBA", "I;16"])
def test_bicubic_resize_is_pillows(shape, kind):
    """``ico.resize(..., BICUBIC)`` equals ``Image.resize((s, s))`` (whose
    default is BICUBIC; RGBA through ``RGBa``) for each ICNS size, up and
    down."""
    from PIL import Image

    w, h = shape
    rng = np.random.default_rng(w * 11 + h)
    if kind == "I;16":
        arr = rng.integers(0, 65536, (h, w), dtype=np.uint16)
        arr[:, : w // 2] = 65535
    else:
        arr = rng.integers(0, 256, (h, w, len(kind)), dtype=np.uint8)
        if kind == "RGBA":
            arr[::3, ::2, 3] = 0
            arr[1::3, ::2, 3] = 255
    img = Image.fromarray(arr)
    for s in sorted({s for _, s in icns.ICNS_TYPES}):
        np.testing.assert_array_equal(ico.resize(arr, s, s, ico.BICUBIC),
                                      np.asarray(img.resize((s, s))))


@pytest.mark.parametrize("kind", sorted(KINDS) + ["RGB16", "R"])
@pytest.mark.parametrize("ext", ("xbm", "msp", "palm", "blp"))
def test_r1_writes_fail_as_in_the_jax_package(ext, kind, tmp_path, monkeypatch):
    """R1: Pillow saves XBM, MSP and Palm only from 1-bit images and BLP
    only from ``P``, so the JAX package's ``RGB``, ``RGBA`` and ``I;16``
    images fail there (``OSError: cannot write mode ... as XBM``,
    ``ValueError: Unsupported BLP image mode``; 16-bit colour fails before,
    on PNG's rule).  The port raises the same class and message, with cv2
    and without it, and neither leaves a file."""
    ch, depth = KINDS.get(kind) or {"RGB16": ("RGB", 16), "R": ("R", 8)}[kind]
    pix = np.random.default_rng(4).random((23, 17, len(ch)))
    want = _write(jimages, tmp_path / f"j.{ext}", pix, ch, depth)
    assert not isinstance(want, bytes) and want[2] is False
    for blocked in (False, True):
        if blocked:
            monkeypatch.setitem(sys.modules, "cv2", None)
        assert timages.check_target(str(tmp_path / f"t.{ext}"))[1] == str(tmp_path / f"t.{ext}")
        assert _write(timages, tmp_path / f"t.{ext}", pix, ch, depth) == want
