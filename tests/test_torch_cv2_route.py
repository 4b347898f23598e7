"""The files the port's own codecs do not take, through the real cv2
(``dspfun_tpu_torch/io/images.py:_cv2_decode``), against the JAX
package, which reads them through Pillow.

Every kind Pillow writes here that goes to cv2 is read with cv2
importable (no JPEG and no TIFF goes to cv2 any more).  Each is either read to the
JAX package's pixels and depth, or
raises where the JAX package raises, or is refused with cv2 present (a
``ValueError`` naming its part of ROADMAP queue 1, item 8) because cv2
reads it to other pixels (CMYK, LAB, 32-bit and float samples, alpha) or
cannot decode it.  The kinds of ``OWN_CODEC`` (JPEG-in-TIFF, CCITT group
3 and 4, uncompressed YCbCr and LAB; WebP, RGB and RGBA, lossy and
lossless; LZMA and Zstandard TIFF, which this cv2 decodes neither of;
progressive JPEG left short and lossless JPEG; three components under
Adobe transform 2, read as YCbCr; a baseline file whose frame header says
arithmetic coding, its data decoded as arithmetic-coded data) went to cv2
until the
port's codecs carried them: their cases now hold the port's own decoder
to the JAX package.  ``UNIDENTIFIED`` went to cv2 too, but Pillow does
not open them at all (a 12-bit JPEG frame; TIFFs of a compression that
is not a key of its ``COMPRESSION_INFO``, or of SGILog's photometrics):
the port raises "cannot identify image file" as the JAX package does,
with the real cv2 importable.
"""

import io
import sys

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


def _hand_tiff(compression, photometric, bits=8):
    """A 4x2 one-sample strip TIFF written by hand, its data zeros."""
    from tests import torch_codec_fixtures as fx

    tags = {256: (4, [4]), 257: (4, [2]), 258: (3, [bits]), 259: (3, [compression]),
            262: (3, [photometric]), 273: (4, []), 277: (3, [1]), 278: (4, [2]),
            279: (4, [8 * bits // 8])}
    return fx._assemble([bytes(8 * bits // 8)], tags, "<")


def _tiff_jpeg_12bit():
    """A JPEG-in-TIFF whose stream's frame says 12-bit samples."""
    from tests import torch_codec_fixtures as fx

    data = bytearray(fx.make_tiff(fx.levels((16, 24), 3), "RGB", compression=7))
    data[data.index(b"\xff\xc0") + 4] = 12
    return bytes(data)


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
    # F1: Pillow does not identify these; the port once handed them to cv2
    **{f"TIFF compression {c} photometric {p}": (lambda c=c, p=p: _hand_tiff(c, p), False)
       for c in (34712, 34933) for p in (0, 1)},
    **{f"TIFF SGILog photometric {p}": (lambda p=p: _hand_tiff(34676, p, 16), False)
       for p in (32844, 32845)},
    "TIFF SGILog24 photometric 32845": (lambda: _hand_tiff(34677, 32845, 32), False),
    "TIFF JPEG of a 12-bit frame": (_tiff_jpeg_12bit, False),
}
# the cases whose kind the port's own codec now carries
OWN_CODEC = {"TIFF RGB JPEG", "TIFF L JPEG", "TIFF YCbCr JPEG", "TIFF CMYK JPEG", "TIFF 1 group3",
             "TIFF 1 group4", "TIFF YCbCr uncompressed", "TIFF LAB uncompressed",
             "TIFF JPEG of a 12-bit frame",
             *(n for n in CASES if n.startswith("WebP") or "LZMA" in n or "Zstandard" in n),
             "progressive, DC only", "progressive without its last scan", "lossless SOF",
             "three components, Adobe transform 2", "arithmetic SOF"}
# the cases Pillow does not open at all: "cannot identify image file" in both
UNIDENTIFIED = {"12-bit SOF", *(n for n in CASES if "photometric" in n)}
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


def _unidentified(tmp_path, data, suffix, monkeypatch):
    """Both packages raise "cannot identify image file", with the real cv2
    importable and with it blocked (no numpy dtype error)."""
    path = tmp_path / f"in.{suffix}"
    path.write_bytes(data)
    with pytest.raises(OSError, match="cannot identify image file"):
        jimages.read_image(str(path))
    for blocked in (False, True):
        with monkeypatch.context() as mp:
            if blocked:
                mp.setitem(sys.modules, "cv2", None)
            else:
                assert sys.modules.get("cv2") is cv2
            with pytest.raises(ValueError, match="cannot identify image file") as e:
                timages.read_image(str(path))
        assert "dtype" not in str(e.value)


@pytest.mark.parametrize("name", list(CASES))
def test_what_goes_to_cv2_reads_as_the_jax_package_or_is_refused(name, tmp_path, monkeypatch):
    make, refused = CASES[name]
    data = make()
    if name in UNIDENTIFIED:
        _unidentified(tmp_path, data, "tif", monkeypatch)
        return
    if name in OWN_CODEC:
        webp_case = name.startswith("WebP")
        own = webp.decode_webp if webp_case else imgcodecs.decode_tiff
        assert timages._decoder(data) is own
        _check(tmp_path, data, False, "webp" if webp_case else "tif")
        return
    assert timages._decoder(data).__name__ == "<lambda>"    # the cv2 route
    _check(tmp_path, data, refused, "tif")


@pytest.mark.parametrize("name", JPEG_CASES)
def test_jpegs_left_to_cv2_read_as_the_jax_package(name, tmp_path, monkeypatch):
    """The JPEG kinds that went to cv2, all now through ``decode_jpeg``:
    progressive files left short; a baseline file whose SOF says lossless,
    now a corrupt lossless stream that both packages refuse; three
    components under Adobe transform 2, read as YCbCr; a baseline file whose
    SOF says arithmetic coding, read as the garbage Pillow reads; and a
    12-bit frame refused by both as unidentified."""
    from dspfun_tpu_torch.io import jpeg

    data = _jpeg_cases()[name]
    if name in UNIDENTIFIED:
        _unidentified(tmp_path, data, "jpg", monkeypatch)
        return
    assert name in OWN_CODEC and timages._decoder(data) is jpeg.decode_jpeg
    _check(tmp_path, data, False, "jpg")
