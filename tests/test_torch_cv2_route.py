"""The files the port's own codecs do not take, through the real cv2
(``dspfun_tpu_torch/io/images.py:_cv2_decode``), against the JAX
package, which reads them through Pillow.

Every kind Pillow writes here that goes to cv2 is read with cv2
importable: the JPEGs the codec leaves to cv2 (progressive files whose
scans leave coefficients short, three components under Adobe transform
2, and files whose frame header names arithmetic coding, 12 bits or
lossless coding).  Each is either read to the JAX package's pixels and
depth, or raises where the JAX package raises, or is refused with cv2
present (a ``ValueError`` naming its part of ROADMAP queue 1, item 8)
because cv2 reads it to other pixels (CMYK, LAB, 32-bit and float
samples, alpha) or cannot decode it.  The kinds of ``OWN_CODEC``
(JPEG-in-TIFF, CCITT group 3 and 4, uncompressed YCbCr and LAB; WebP,
RGB and RGBA, lossy and lossless; LZMA and Zstandard TIFF, which this
cv2 decodes neither of) went to cv2 until the port's codecs carried
them: their cases now hold the port's own decoder to the JAX package.
"""

import io

import numpy as np
import pytest
from PIL import Image

from dspfun_tpu.io import images as jimages
from dspfun_tpu_torch.io import imgcodecs, webp
from dspfun_tpu_torch.io import images as timages

cv2 = pytest.importorskip("cv2")


def _levels(h=40, w=56, seed=0):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([128 + 100 * np.sin(x / 5), 128 + 90 * np.cos(y / 4),
                     128 + 50 * np.sin((x + y) / 6)], -1)
    return np.clip(base + rng.normal(0, 10, base.shape), 0, 255).astype(np.uint8)


def _save(img, fmt, **kw):
    buf = io.BytesIO()
    img.save(buf, fmt, **kw)
    return buf.getvalue()


def _tiff(mode, compression):
    rgb = _levels()
    if mode == "RGBA":
        img = Image.fromarray(np.dstack([rgb, rgb[..., 1] // 2 + 100]))
    elif mode == "I;16":
        img = Image.fromarray(rgb[..., 0].astype(np.uint16) * 257)
    elif mode == "F":
        img = Image.fromarray(rgb[..., 0].astype(np.float32) * 1.5 - 20)
    else:
        img = Image.fromarray(rgb).convert(mode)
    return _save(img, "TIFF", compression=compression)


def _jpeg_cases():
    from tests import test_torch_jpeg as tj

    short = tj._short_files()
    base = tj._pil(Image.fromarray(tj._image(16, 24)))
    sof = base.index(b"\xff\xc0")
    adobe = b"\xff\xee\x00\x0eAdobe\x00\x64\x00\x00\x00\x00\x02"

    def patched(at, value):
        d = bytearray(base)
        d[at] = value
        return bytes(d)

    return {"progressive, DC only": short["DC only"],
            "progressive without its last scan": short["without the last scan"],
            "three components, Adobe transform 2": base[:2] + adobe + base[2:],
            "arithmetic SOF": patched(sof + 1, 0xC9),
            "12-bit SOF": patched(sof + 4, 12),
            "lossless SOF": patched(sof + 1, 0xC3)}


# name -> (bytes maker, whether the port refuses it with cv2 present)
CASES = {
    **{f"TIFF {m} JPEG": (lambda m=m: _tiff(m, "jpeg"), m == "CMYK")
       for m in ("RGB", "L", "YCbCr", "CMYK")},
    **{f"TIFF 1 {c}": (lambda c=c: _tiff("1", c), False) for c in ("group3", "group4")},
    # this cv2 decodes neither LZMA nor Zstandard, which the port's codecs carry
    **{f"TIFF {m} LZMA": (lambda m=m: _tiff(m, "lzma"), True)
       for m in ("RGB", "L", "P", "1", "I;16", "RGBA", "CMYK", "F")},
    "TIFF RGB Zstandard": (lambda: _tiff("RGB", "zstd"), True),
    "TIFF YCbCr uncompressed": (lambda: _tiff("YCbCr", "raw"), True),
    "TIFF LAB uncompressed": (lambda: _tiff("LAB", "raw"), True),
    "TIFF LAB LZMA": (lambda: _tiff("LAB", "lzma"), True),
    "TIFF I;32S LZMA": (lambda: _save(Image.fromarray(np.arange(-600, 600, dtype=np.int32)
                                                      .reshape(30, 40) * 97), "TIFF",
                                      compression="lzma"), True),
    **{f"WebP {m} {'lossless' if ll else 'lossy'}":
       (lambda m=m, ll=ll: _save(Image.fromarray(_levels()).convert(m), "WEBP", lossless=ll),
        False) for m in ("RGB", "RGBA") for ll in (False, True)},
}
# the cases whose kind the port's own codec now carries
OWN_CODEC = {"TIFF RGB JPEG", "TIFF L JPEG", "TIFF YCbCr JPEG", "TIFF CMYK JPEG", "TIFF 1 group3",
             "TIFF 1 group4", "TIFF YCbCr uncompressed", "TIFF LAB uncompressed",
             *(n for n in CASES if n.startswith("WebP") or "LZMA" in n or "Zstandard" in n)}
JPEG_CASES = ["progressive, DC only", "progressive without its last scan",
              "three components, Adobe transform 2", "arithmetic SOF", "12-bit SOF",
              "lossless SOF"]


def _read(path, ch):
    try:
        return jimages.read_image(str(path), channels=ch)
    except (OSError, ValueError, SyntaxError) as e:
        return e


def _check(tmp_path, data, refused, suffix):
    path = tmp_path / f"in.{suffix}"
    path.write_bytes(data)
    if refused:
        with pytest.raises(ValueError, match=r"queue 1, item 8[a-z]"):
            timages.read_image(str(path))
        return
    for ch in ("RGB", "RGBA", "I"):
        j = _read(path, ch)
        if isinstance(j, Exception):
            with pytest.raises((ValueError, OSError)):
                timages.read_image(str(path), channels=ch)
            continue
        t = timages.read_image(str(path), channels=ch)
        assert t.depth == j.depth
        np.testing.assert_array_equal(t.pixels, j.pixels)


@pytest.mark.parametrize("name", list(CASES))
def test_what_goes_to_cv2_reads_as_the_jax_package_or_is_refused(name, tmp_path):
    make, refused = CASES[name]
    data = make()
    if name in OWN_CODEC:
        webp_case = name.startswith("WebP")
        own = webp.decode_webp if webp_case else imgcodecs.decode_tiff
        assert timages._decoder(data) is own
        _check(tmp_path, data, False, "webp" if webp_case else "tif")
        return
    assert timages._decoder(data).__name__ == "<lambda>"    # the cv2 route
    _check(tmp_path, data, refused, "tif")


@pytest.mark.parametrize("name", JPEG_CASES)
def test_jpegs_left_to_cv2_read_as_the_jax_package(name, tmp_path):
    data = _jpeg_cases()[name]
    assert timages._decoder(data).__name__ == "<lambda>"
    _check(tmp_path, data, False, "jpg")
