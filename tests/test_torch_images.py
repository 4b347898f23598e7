"""The port's still-image I/O (``dspfun_tpu_torch/io/images.py``) against
``dspfun_tpu/io/images.py``: the same float pixels written by both give
the same bytes, the same file read by both gives the same arrays, depth,
properties and ``linear`` flag, for every channel string, both depths,
``linear``/``to_srgb``, ``-`` pipes and ``fmt:path`` specifiers; the
base16 and DC codecs are bit-equal.  The targets the port once refused
(every format but PNG, sixel) are written as the JAX package writes
them.
"""

import dataclasses
import io
import struct
import sys

import numpy as np
import pytest

from dspfun_tpu.io import images as jimages
from dspfun_tpu_torch.io import images as timages

# tests/test_images.py's channel strings, then the CLI defaults and alpha
CHANNELS = ["RGB", "I", "BGR", "RGBA", "IA", "R", "A", "rgb"]


def _pixels(h, w, c, seed=0):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    smooth = 0.5 + 0.45 * np.sin(x[..., None] / 5.0 + np.arange(c) + y[..., None] / 7.0)
    pix = smooth + 0.05 * rng.standard_normal((h, w, c))
    pix[0, 0] = -0.25          # clipped below
    pix[0, 1] = 1.5            # and above
    pix[1, 0] = 0.5 / 255      # a rounding edge of the 8-bit quantiser
    return pix


@pytest.mark.parametrize("to_srgb", [False, True], ids=["", "to_srgb"])
@pytest.mark.parametrize("depth", [8, 16])
@pytest.mark.parametrize("channels", CHANNELS)
def test_write_image_bytes_equal(channels, depth, to_srgb, tmp_path):
    pix = _pixels(20, 28, len(channels), seed=len(channels) + depth)
    props = {"DC": timages.encode_dc_property(np.arange(len(channels)) / 7.0)}
    a, b = str(tmp_path / "t.png"), str(tmp_path / "j.png")
    timages.write_image(a, pix, channels, props, to_srgb=to_srgb, depth=depth)
    jimages.write_image(b, pix, channels, props, to_srgb=to_srgb, depth=depth)
    assert open(a, "rb").read() == open(b, "rb").read()


@pytest.mark.parametrize("linear", [False, True], ids=["", "linear"])
@pytest.mark.parametrize("depth", [8, 16])
@pytest.mark.parametrize("channels", CHANNELS)
def test_read_image_equal(channels, depth, linear, tmp_path):
    """Files of every layout the writers make (RGB, RGBA, 16-bit gray)."""
    for file_channels in ("RGB", "RGBA", "I"):
        path = str(tmp_path / f"{file_channels}.png")
        jimages.write_image(path, _pixels(12, 18, len(file_channels), seed=depth),
                            file_channels, {"k": "v"}, depth=depth)
        got = timages.read_image(path, channels, linear=linear)
        ref = jimages.read_image(path, channels, linear=linear)
        np.testing.assert_array_equal(got.pixels, ref.pixels)
        assert got.pixels.dtype == ref.pixels.dtype == np.float64
        assert dataclasses.asdict(got).keys() == dataclasses.asdict(ref).keys()
        assert (got.channels, got.properties, got.depth, got.linear) == \
            (ref.channels, ref.properties, ref.depth, ref.linear)
        assert (got.height, got.width) == (12, 18)


def test_colorspace_property_marks_linear_input(tmp_path):
    path = str(tmp_path / "lin.png")
    timages.write_image(path, _pixels(8, 8, 3), properties={"colorspace": "RGB"})
    for linear in (False, True):
        got, ref = timages.read_image(path, linear=linear), jimages.read_image(path, linear=linear)
        assert got.linear is ref.linear is True
        np.testing.assert_array_equal(got.pixels, ref.pixels)


class _Std:
    def __init__(self, data=b""):
        self.buffer = io.BytesIO(data)

    def isatty(self):
        return False


@pytest.mark.parametrize("spec", ["-", "png:-", "PNG:-"])
@pytest.mark.parametrize("depth", [8, 16])
def test_pipes_and_format_specifiers(spec, depth, monkeypatch, tmp_path):
    pix = _pixels(10, 14, 3, seed=depth)
    out = {}
    for name, mod in (("t", timages), ("j", jimages)):
        std = _Std()
        monkeypatch.setattr(sys, "stdout", std)
        mod.write_image(spec, pix, properties={"DC": "AB"}, depth=depth)
        monkeypatch.undo()
        out[name] = std.buffer.getvalue()
    assert out["t"] == out["j"] and out["t"][:4] == b"\x89PNG"
    monkeypatch.setattr(sys, "stdin", _Std(out["t"]))
    got = timages.read_image(spec)
    monkeypatch.setattr(sys, "stdin", _Std(out["t"]))
    ref = jimages.read_image(spec)
    np.testing.assert_array_equal(got.pixels, ref.pixels)
    assert (got.depth, got.properties) == (depth, {"DC": "AB"})
    # fmt:path with a real path, and a path without an extension
    for target in (f"png:{tmp_path / 'a.dat'}", str(tmp_path / "noext")):
        timages.write_image(target, pix, depth=depth)
        path = target.split(":", 1)[-1]
        assert open(path, "rb").read() == timages._png.encode_png(
            timages._png.decode_png(out["t"])[0])


def test_split_spec_and_channel_maps_equal():
    for spec in ("a.png", "png:a", "sixel:-", "PNG:x:y", "c:/x.png", "jpeg:-", "-", "tiff:"):
        assert timages._split_spec(spec) == jimages._split_spec(spec)
    rgba = np.random.default_rng(2).random((5, 6, 4))
    for ch in CHANNELS:
        planes = timages._to_channels(rgba, ch)
        np.testing.assert_array_equal(planes, jimages._to_channels(rgba, ch))
        np.testing.assert_array_equal(timages._from_channels(planes, ch),
                                      jimages._from_channels(planes, ch))
    for mod in (timages, jimages):
        with pytest.raises(ValueError, match="unsupported channel 'X'"):
            mod._to_channels(rgba, "RXB")
        with pytest.raises(ValueError, match="unsupported channel 'X'"):
            mod._from_channels(rgba, "X")


def _doubles():
    rng = np.random.default_rng(5)
    special = [0.0, -0.0, 1.0, -1.0, 5e-324, -5e-324, 2.2250738585072014e-308,
               1.7976931348623157e308, np.inf, -np.inf, np.nan,
               struct.unpack("<d", struct.pack("<Q", 0x7FF8000000BADBAD))[0]]
    bits = rng.integers(0, 2**64, 64, dtype=np.uint64).view(np.float64)
    return np.concatenate([special, rng.standard_normal(32) * 1e3, bits])


def test_base16_and_dc_codecs_bit_equal():
    data = bytes(range(256)) + np.random.default_rng(1).bytes(999)
    enc = timages.base16_encode(data)
    assert enc == jimages.base16_encode(data)
    assert timages.base16_decode(enc) == jimages.base16_decode(enc) == data
    assert timages.base16_decode(enc[:-1]) == jimages.base16_decode(enc[:-1])
    vals = _doubles()
    for n in (1, 3, 4):
        for i in range(0, len(vals) - n, n):
            dc = vals[i:i + n]
            prop = timages.encode_dc_property(dc)
            assert prop == jimages.encode_dc_property(dc)
            got = timages.decode_dc_property(prop, n)
            assert got.tobytes() == jimages.decode_dc_property(prop, n).tobytes() \
                == np.asarray(dc, np.float64).tobytes()
    # a property longer than the channel count decodes its leading channels
    prop = timages.encode_dc_property(vals[:4])
    assert timages.decode_dc_property(prop, 3).tobytes() == vals[:3].tobytes()


@pytest.mark.parametrize("target", ["out.jpg", "jpeg:-", "out.tiff", "bmp:x", "x.ppm",
                                    "webp:x", "x.gif", "./noext"])
def test_other_formats_are_refused_on_write(target, tmp_path, monkeypatch):
    """Each target the port once refused (ROADMAP item 8) is written as the
    JAX package writes it: the same bytes, or the same failure (16-bit
    colour outside PNG), at both depths.  Without cv2 WebP output is still
    refused by item 8 (8f's write), writing nothing, and JPEG and GIF (the
    port's own codecs) are written as with it."""
    pytest.importorskip("cv2")
    pix = _pixels(4, 4, 3)
    monkeypatch.chdir(tmp_path)
    compressed = any(k in target for k in ("jp", "webp", "gif"))
    for depth in (8, 16):
        out = {}
        for name, mod in (("jax", jimages), ("torch", timages)):
            std = _Std()
            monkeypatch.setattr(sys, "stdout", std)
            (tmp_path / name).mkdir(exist_ok=True)
            spec = target if target.endswith("-") else target.replace(":", f":{name}/", 1) \
                if ":" in target else f"{name}/{target}"
            try:
                mod.write_image(spec, pix, depth=depth)
                path = spec.split(":", 1)[-1]
                out[name] = std.buffer.getvalue() if path == "-" else open(path, "rb").read()
            except (KeyError, OSError, ValueError):
                out[name] = "failed"  # Pillow: no such format or mode for it
        assert out["torch"] == out["jax"]
    if compressed:
        monkeypatch.setitem(sys.modules, "cv2", None)
        if "jp" in target or "gif" in target:
            got = {}
            for name, mod in (("jax", jimages), ("torch", timages)):
                std = _Std()
                monkeypatch.setattr(sys, "stdout", std)
                spec = target if target.endswith("-") else f"{name}/{target}"
                mod.write_image(spec, pix)
                got[name] = std.buffer.getvalue() if spec.endswith("-") else \
                    open(spec, "rb").read()
            assert got["torch"] == got["jax"]
            return
        before = sorted(tmp_path.iterdir())
        with pytest.raises(ValueError, match="queue 1, item 8"):
            timages.write_image(target, pix)
        assert sorted(tmp_path.iterdir()) == before


def test_sixel_is_refused_by_item(tmp_path, monkeypatch):
    """``sixel:`` targets and the tty default, once refused (ROADMAP item
    21), write sixel as the JAX package does: the same header and size,
    the JAX encoder's bytes (tests/test_torch_sixel.py), whose decoded
    colours are the image's; not a tty, PNG to stdout."""
    from tests.test_torch_sixel import decode_sixel

    pix = _pixels(4, 4, 3)
    got = {}
    for name, mod in (("jax", jimages), ("torch", timages)):
        mod.write_image(f"sixel:{tmp_path / name}.six", pix)
        got[name] = (tmp_path / f"{name}.six").read_bytes()
        tty = _Std()
        tty.isatty = lambda: True
        monkeypatch.setattr(sys, "stdout", tty)
        mod.write_image(None, pix)
        assert tty.buffer.getvalue() == got[name]
    assert got["torch"] == got["jax"]
    rgb8 = np.clip(np.rint(np.clip(pix, 0, 1) * 255), 0, 255)
    for data in got.values():
        assert data.startswith(b'\x1bPq"1;1;4;4') and data.endswith(b"\x1b\\")
    idx, pal = decode_sixel(got["torch"])
    lut = np.array([pal[k] for k in sorted(pal)])
    np.testing.assert_array_equal(lut[idx], rgb8.astype(np.int64) * 100 // 255)  # 16 colours
    pipe = _Std()
    monkeypatch.setattr(sys, "stdout", pipe)
    timages.write_image(None, pix)           # not a tty: PNG to stdout
    assert pipe.buffer.getvalue()[:4] == b"\x89PNG"
