"""The port's GIF codec (``dspfun_tpu_torch/io/gif.py`` on
``native/gif.cpp``) and colour quantiser (``io/quant.py`` on
``native/quant.cpp``) against Pillow, through which the JAX package reads
and writes GIF.

* Quantiser: the index image, palette and palette mode of
  ``convert("P", palette=ADAPTIVE)`` (median cut for RGB, fast octree for
  RGBA) on seeded smooth, noisy (more than 65536 colours, so that Pillow's
  colour table drops low bits), few-colour and tied images, at 256 and
  fewer colours.
* Reads: hand-written files (interlaced or not, global, local or no
  palette of 2 to 256 entries, minimum code sizes 2 to 12, a frame at an
  offset or past the screen, a transparency index, GIF87a and GIF89a,
  extensions and stray bytes, clear codes, a deferred clear, gray ramps)
  and Pillow-written ones read through both packages' ``read_image`` as
  RGB, RGBA and I, with cv2 present and blocked: the same pixels, or an
  error in both (truncated data, an early end code, a code size past 12,
  an empty frame, no frame).
* Writes: both packages' ``write_image`` give the same bytes for RGB,
  RGBA (alpha 0 and 255, and partial), I at 8 and 16 bits, more than
  65536 colours, at most 256, sides below 16, 1x1, both sides of
  512x512, a width whose encoder buffer is not 65536 bytes, and an LZW
  stream of whole 255-byte sub-blocks.
* The LZW code stream of Pillow's file: its clear codes and widths, the
  port's stream code for code.
* ``chip_smoke.GIF_FIXTURES`` and ``GIF_DIGESTS`` (phase 18) are Pillow's.
* A failed build of either library raises with the compiler's message.
"""

import hashlib
import io
import sys

import numpy as np
import pytest
from PIL import Image

import chip_smoke
from dspfun_tpu.io import images as jimages
from dspfun_tpu_torch import _hostbuild
from dspfun_tpu_torch.io import gif, quant
from dspfun_tpu_torch.io import images as timages
from tests import torch_codec_fixtures as fx


def _pil(img, **kw) -> bytes:
    buf = io.BytesIO()
    img.save(buf, format="GIF", **kw)
    return buf.getvalue()


# ---- the quantiser -------------------------------------------------------------

def _quant_images():
    rng = np.random.default_rng(31)
    y, x = np.mgrid[0:72, 0:96]
    smooth = np.stack([x * 255 // 95, y * 255 // 71, (x + y) % 256], -1)
    few = rng.integers(0, 256, (37, 3))[rng.integers(0, 37, (45, 61))]
    ties = np.kron(rng.integers(0, 256, (4, 4, 3)), np.ones((6, 6, 1)))
    return {
        "smooth": np.clip(smooth + rng.integers(-8, 9, smooth.shape), 0, 255),
        "noise_scale1": rng.integers(0, 256, (300, 300, 3)),
        "noise_scale3": rng.integers(0, 256, (400, 400, 3)),
        "few": few,
        "ties": ties,
        "one_colour": np.full((5, 7, 3), 77),
        "gray": np.repeat(rng.integers(0, 256, (50, 40, 1)), 3, axis=-1),
    }


def _with_alpha(rgb, seed):
    rng = np.random.default_rng(seed)
    alpha = np.where(rng.random(rgb.shape[:2]) < 0.3, 0,
                     np.where(rng.random(rgb.shape[:2]) < 0.5, 255,
                              rng.integers(0, 256, rgb.shape[:2])))
    return np.dstack([rgb, alpha])


def _pillow_quantize(a, colors=256):
    p = Image.fromarray(a).convert("P", palette=Image.Palette.ADAPTIVE, colors=colors)
    mode = p.im.getpalettemode()
    return np.asarray(p), np.array(p.getpalette(None), np.uint8).reshape(-1, len(mode)), mode


@pytest.mark.parametrize("channels", [3, 4])
@pytest.mark.parametrize("name", sorted(_quant_images()))
def test_quantize_is_pillows_adaptive_palette(name, channels):
    a = _quant_images()[name]
    if channels == 4:
        a = _with_alpha(a, len(name))
    a = np.ascontiguousarray(a, np.uint8)
    idx, pal, mode = quant.quantize(a)
    want_idx, want_pal, want_mode = _pillow_quantize(a)
    assert mode == want_mode == ("RGB" if channels == 3 else "RGBA")
    np.testing.assert_array_equal(pal, want_pal)
    np.testing.assert_array_equal(idx, want_idx)


@pytest.mark.parametrize("colors", [1, 2, 16, 100, 255])
def test_quantize_to_fewer_colours(colors):
    a = _quant_images()["smooth"].astype(np.uint8)
    for arr in (a, _with_alpha(a, colors).astype(np.uint8)):
        got, want = quant.quantize(arr, colors), _pillow_quantize(arr, colors)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert len(got[1]) <= colors


def test_rgba_is_quantised_with_its_alpha():
    """Pillow's octree for RGBA: another palette and index map than the
    median cut of the colour alone, RGBA entries, fully transparent pixels
    given the first one's colour."""
    rng = np.random.default_rng(0)
    a = rng.integers(0, 256, (40, 56, 4), dtype=np.uint8)
    a[..., 3] = np.where(rng.random((40, 56)) < 0.3, 0, 255)
    idx, pal, mode = quant.quantize(a)
    rgb_idx, rgb_pal, rgb_mode = quant.quantize(np.ascontiguousarray(a[..., :3]))
    assert (mode, rgb_mode) == ("RGBA", "RGB") and pal.shape == (256, 4)
    assert not np.array_equal(idx, rgb_idx) and rgb_pal.shape[1] == 3
    assert len(set(idx[a[..., 3] == 0].tolist())) == 1
    with pytest.raises(ValueError):
        quant.quantize(a.astype(np.float32))
    with pytest.raises(ValueError, match="number of colors"):
        quant.quantize(a, 0)


# ---- reads ---------------------------------------------------------------------

_EXT = (b"!\xfe\x05hello\x03abc\x00"                                  # comments
        b"!\xff\x0bNETSCAPE2.0\x03\x01\x05\x00\x00"                   # a loop count
        b"!\xff\x0bXMP DataXMP\x02ab\x00"                             # another application
        b"!\x01\x0c" + bytes(12) + b"\x02hi\x00"                      # plain text
        b"\x07\x07")                                                 # stray bytes


def _read_cases() -> dict:
    rng = np.random.default_rng(41)
    pal = rng.integers(0, 256, (256, 3))
    ramp = np.repeat(np.arange(256)[:, None], 3, axis=1)
    idx = rng.integers(0, 256, (37, 53))
    grad = np.add.outer(np.arange(37), np.arange(53)) // 3
    big = rng.integers(0, 256, (96, 128))
    m = fx.make_gif
    cases = {
        "plain": m(idx, pal),
        "interlaced": m(idx, pal, interlace=True),
        "interlaced_small": m(idx[:3, :5], pal, interlace=True),
        "local": m(idx % 64, pal[:64], local=pal[64:128]),
        "local_only": m(idx % 32, None, local=pal[:32]),
        "short_palette": m(idx, pal[:4]),
        "offset": m(idx, pal, screen=(70, 50), offset=(9, 6)),
        "offset_trns": m(idx, pal, screen=(70, 50), offset=(9, 6), trns=5),
        "past_screen": m(idx, pal, screen=(20, 20), offset=(3, 4)),
        "trns": m(idx, pal, trns=17),
        "gif87a": m(idx, pal, version=b"87a"),
        "extensions": m(idx, pal, extensions=_EXT, trns=0),
        "deferred_clear": m(big, pal, defer=True),
        "table_clears": m(big, pal),
        "clears": m(idx, pal, clear_every=7),
        "gray_ramp": m(idx, ramp),
        "gray_ramp_short": m(idx, ramp[:16]),
        "gray_local": m(idx, pal, local=ramp),
        "gray_local_trns": m(idx, pal, local=ramp, trns=5),
        "gray_global_trns": m(idx, ramp, trns=5),
        "colour_local_gray_global": m(idx % 64, ramp, local=pal[:64], trns=5),
        "no_palette": m(idx, None, trns=9),
        "no_end_code": m(idx, pal, end=False),
        "code12": m(idx % 2, pal[:2], min_code=12),
        "code1": m(idx % 2, pal[:2], min_code=1),
        "early_end": m(idx, pal, stop_at=100),
        "truncated_data": m(idx, pal)[:400],
        "truncated_header": m(idx, pal)[:300],
        "no_frame": b"GIF89a\x04\x00\x04\x00\x00\x00\x00;",
        "not_gif": b"GIF88a\x04\x00\x04\x00\x00\x00\x00;",
    }
    for n in (2, 4, 16, 100, 256):
        cases[f"palette{n}"] = m(idx % n, pal[:n], min_code=max(2, (n - 1).bit_length()))
    for mc in range(2, 9):
        cases[f"code{mc}"] = m(grad % (1 << mc), pal, min_code=mc, interlace=mc % 2 == 0)
    code13 = bytearray(m(idx % 2, pal[:2], min_code=2))
    code13[code13.index(b",") + 10] = 13
    cases["code13"] = bytes(code13)
    for name, at in (("zero_width", 5), ("zero_width_offset", 5), ("zero_height", 7)):
        data = bytearray(m(idx, pal, offset=(3, 0) if name == "zero_width_offset" else (0, 0),
                           screen=(60, 40)))
        i = data.index(b",")
        data[i + at:i + at + 2] = b"\0\0"
        cases[name] = bytes(data)
    rgb = np.clip(fx.levels((36, 52), 42).astype(np.int64), 0, 255).astype(np.uint8)
    img = Image.fromarray(rgb)
    for mode, im in (("RGB", img), ("RGBA", Image.fromarray(_with_alpha(rgb, 4).astype(np.uint8))),
                     ("L", img.convert("L")), ("P", img.quantize(37)), ("1", img.convert("1")),
                     ("I;16", Image.fromarray((rgb[..., 0].astype(np.uint16) * 300)))):
        cases[f"pillow_{mode}"] = _pil(im)
    cases["pillow_small"] = _pil(img.crop((0, 0, 15, 36)))
    return cases


READ_CASES = _read_cases()


@pytest.mark.parametrize("cv2", ["with_cv2", "cv2_blocked"])
@pytest.mark.parametrize("name", sorted(READ_CASES))
def test_reads_equal_the_jax_package(name, cv2, tmp_path, monkeypatch):
    if cv2 == "cv2_blocked":
        monkeypatch.setitem(sys.modules, "cv2", None)
    path = tmp_path / "in.gif"
    path.write_bytes(READ_CASES[name])
    for ch in ("RGB", "RGBA", "I"):
        try:
            want = jimages.read_image(str(path), channels=ch)
        except (ValueError, OSError) as e:
            with pytest.raises((ValueError, OSError)) as got:
                timages.read_image(str(path), channels=ch)
            assert isinstance(got.value, OSError) == isinstance(e, OSError), (e, got.value)
            continue
        got = timages.read_image(str(path), channels=ch)
        assert got.depth == want.depth == 8
        np.testing.assert_array_equal(got.pixels, want.pixels)


def test_reads_of_every_cut_of_a_file():
    """A file cut at any byte: Pillow's pixels or an error in both."""
    data = fx.make_gif(np.random.default_rng(5).integers(0, 256, (23, 29)),
                       np.random.default_rng(6).integers(0, 256, (256, 3)), trns=4)
    for cut in range(len(data) + 1):
        try:
            want = np.asarray(Image.open(io.BytesIO(data[:cut])).convert("RGBA"))
        except (ValueError, OSError):
            with pytest.raises((ValueError, OSError)):
                gif.decode_gif(data[:cut])
            continue
        got, depth = gif.decode_gif(data[:cut])
        assert depth == 8
        np.testing.assert_array_equal(chip_smoke._rgba8(got), want)


# ---- writes --------------------------------------------------------------------

def _levels(h, w, c, seed):
    return fx.levels((h, w), seed)[..., :c] if c <= 3 else np.dstack(
        [fx.levels((h, w), seed), fx.levels((h, w), seed + 1)[..., 0]])


def _write_cases() -> dict:
    rng = np.random.default_rng(51)
    opaque_or_clear = _levels(44, 52, 4, 3) / 255.0
    opaque_or_clear[..., 3] = rng.random((44, 52)) < 0.6
    return {
        "smooth": (_levels(40, 56, 3, 1) / 255.0, "RGB", 8),
        "noise_65536": (rng.random((270, 260, 3)), "RGB", 8),
        "few_colours": (np.kron(rng.random((5, 7, 3)), np.ones((9, 8, 1))), "RGB", 8),
        "gray8": (rng.random((33, 47, 1)), "I", 8),
        "gray16": (rng.random((33, 47, 1)), "I", 16),
        "rgba_partial": (_levels(44, 52, 4, 2) / 255.0, "RGBA", 8),
        "rgba_0_255": (opaque_or_clear, "RGBA", 8),
        "rgba_opaque": (np.dstack([_levels(44, 52, 3, 4) / 255.0, np.ones((44, 52))]), "RGBA", 8),
        "side15": (_levels(15, 40, 3, 5) / 255.0, "RGB", 8),
        "side15_tall": (_levels(40, 15, 3, 6) / 255.0, "RGB", 8),
        "one_pixel": (rng.random((1, 1, 3)), "RGB", 8),
        "one_pixel_rgba": (rng.random((1, 1, 4)), "RGBA", 8),
        "below_512x512": (_levels(511, 512, 3, 7) / 255.0, "RGB", 8),
        "at_512x512": (_levels(512, 512, 3, 7) / 255.0, "RGB", 8),
        "rgba_at_512x512": (_levels(512, 512, 4, 8) / 255.0, "RGBA", 8),
        "wide_buffer": (rng.random((5, 17001, 3)), "RGB", 8),
    }


WRITE_CASES = _write_cases()


@pytest.mark.parametrize("name", sorted(WRITE_CASES))
def test_writes_equal_the_jax_package(name, tmp_path):
    pix, channels, depth = WRITE_CASES[name]
    out = {}
    for who, mod in (("jax", jimages), ("torch", timages)):
        path = str(tmp_path / f"{who}.gif")
        mod.write_image(path, pix, channels=channels, depth=depth)
        out[who] = open(path, "rb").read()
    assert out["torch"] == out["jax"]
    # and the port reads back Pillow's pixels of it
    path = str(tmp_path / "jax.gif")
    np.testing.assert_array_equal(timages.read_image(path, channels="RGBA").pixels,
                                  jimages.read_image(path, channels="RGBA").pixels)


def _sub_blocks(data: bytes) -> tuple[int, bytes]:
    """(minimum code size, the joined sub-blocks) of a one-frame GIF as
    the encoders write it."""
    pos = 13 + (3 << ((data[10] & 7) + 1) if data[10] & 128 else 0)
    if data[pos:pos + 1] == b"!":
        pos += 8
    assert data[pos:pos + 1] == b","
    pos += 10
    min_code, pos, body = data[pos], pos + 1, bytearray()
    while data[pos]:
        body += data[pos + 1:pos + 1 + data[pos]]
        pos += 1 + data[pos]
    assert data[pos + 1:] == b";"
    return min_code, bytes(body)


def test_a_stream_of_whole_sub_blocks():
    """An image whose LZW stream fills its last 255-byte sub-block: no
    empty sub-block before the terminator, as in Pillow."""
    rng = np.random.default_rng(2)
    for _ in range(4000):
        h, w = rng.integers(8, 30, 2)
        a = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        data = gif.encode_gif(a)
        if len(_sub_blocks(data)[1]) % 255 == 0:
            assert data == _pil(Image.fromarray(a))
            return
    pytest.fail("no image of whole sub-blocks among the seeded ones")


def test_encode_refuses_what_pillow_does_not_write():
    for bad in (np.zeros((4, 4), np.float32), np.zeros((4, 4, 2), np.uint8),
                np.zeros((0, 4, 3), np.uint8), np.zeros((4, 4, 3), np.uint16)):
        with pytest.raises(ValueError):
            gif.encode_gif(bad)


# ---- the LZW code stream ----------------------------------------------------------

def read_codes(data: bytes) -> list[tuple[int, int]]:
    """(code, width) of a GIF's first frame, its widths as a decoder
    follows them (one wider after the code that adds entry 2**width - 1,
    back to the minimum after a clear code, no entries past 4095)."""
    min_code, body = _sub_blocks(data)
    clear = 1 << min_code
    bits = int.from_bytes(body, "little")
    pos, width, nxt, first, out = 0, min_code + 1, clear + 2, True, []
    while pos + width <= 8 * len(body):
        code = bits >> pos & ((1 << width) - 1)
        pos += width
        out.append((code, width))
        if code == clear:
            width, nxt, first = min_code + 1, clear + 2, True
        elif code == clear + 1:
            break
        elif first:
            first = False
        elif nxt < 4096:
            if nxt == (1 << width) - 1 and width < 12:
                width += 1
            nxt += 1
    return out


def _lzw_decode(codes, min_code) -> bytes:
    """The pixels of a code stream (a plain LZW decoder)."""
    clear = 1 << min_code
    out, table, prev = bytearray(), [], None
    for code, _ in codes:
        if code == clear:
            table, prev = [bytes([i]) for i in range(clear)] + [b"", b""], None
        elif code == clear + 1:
            break
        else:
            entry = table[code] if code < len(table) else prev + prev[:1]
            if prev is not None and len(table) < 4096:
                table.append(prev + entry[:1])
            out += entry
            prev = entry
    return bytes(out)


def test_the_code_stream_is_pillows():
    """Pillow's stream of a noisy 300x300 image: a clear code first and
    again right after each code that fills the table, widths 9 to 12, and
    the port's stream code for code; it decodes to the interlaced rows."""
    a = np.random.default_rng(7).integers(0, 256, (300, 300, 3), dtype=np.uint8)
    data = _pil(Image.fromarray(a))
    codes = read_codes(data)
    assert codes == read_codes(gif.encode_gif(a))
    assert codes[0] == (256, 9) and codes[-1][0] == 257
    clears = [i for i, (c, _) in enumerate(codes) if c == 256]
    assert len(clears) >= 3
    for i, j in zip(clears, clears[1:]):
        assert j - i - 1 == 4096 - 258 + 1   # 3838 entries added, then one more code
    assert {w for _, w in codes} == {9, 10, 11, 12}
    pixels = _lzw_decode(codes, 8)
    idx = np.asarray(Image.open(io.BytesIO(data)))
    assert pixels == idx[gif.interlace_rows(300)].tobytes()


def test_a_deferred_clear_keeps_the_full_table():
    """The hand-written fixture fills its table and codes on at 12 bits
    without a clear code; both readers take it."""
    data = (fx.GOLDENS / "gif_deferred_clear.gif").read_bytes()
    codes = read_codes(data)
    assert [c for c, _ in codes].count(256) == 1
    assert sum(w == 12 for _, w in codes) > 1000
    got, _ = gif.decode_gif(data)
    np.testing.assert_array_equal(got, np.asarray(Image.open(io.BytesIO(data)).convert("RGB")))


# ---- the fixtures and digests of chip_smoke.py phase 18 ------------------------------

def test_gif_fixtures_are_pillows():
    """tests/goldens/gif_*.gif are what tests/torch_codec_fixtures.py makes,
    with the sha256 of ``chip_smoke.GIF_FIXTURES``."""
    made = fx.gif_fixtures()
    assert sorted(made) == sorted(chip_smoke.GIF_FIXTURES)
    for name, data in made.items():
        assert (fx.GOLDENS / name).read_bytes() == data, name
        assert fx.gif_digests(data) == chip_smoke.GIF_FIXTURES[name], name


@pytest.mark.parametrize("name", sorted(chip_smoke.GIF_FIXTURES))
def test_gif_fixtures_decode_as_pillow(name, tmp_path, monkeypatch):
    """Each committed fixture, with cv2 blocked: ``read_image`` picks the
    port's codec, whose RGBA pixels hash to Pillow's, and equals the JAX
    package's ``read_image``."""
    monkeypatch.setitem(sys.modules, "cv2", None)
    data = (fx.GOLDENS / name).read_bytes()
    assert timages._decoder(data) is gif.decode_gif
    arr, _ = gif.decode_gif(data)
    assert hashlib.sha256(chip_smoke._rgba8(arr).tobytes()).hexdigest() == \
        chip_smoke.GIF_FIXTURES[name][1]
    path = tmp_path / name
    path.write_bytes(data)
    for ch in ("RGB", "RGBA"):
        np.testing.assert_array_equal(timages.read_image(str(path), channels=ch).pixels,
                                      jimages.read_image(str(path), channels=ch).pixels)


def test_4k_gif_digests_are_pillows():
    """``chip_smoke.GIF_DIGESTS``: Pillow's GIF of the 3840x2160 levels of
    ``CODEC_4K`` and its decode; the port writes the same bytes and reads
    the same pixels."""
    (h, w), seed, noise = chip_smoke.CODEC_4K
    rgb8 = fx.levels((h, w), seed, noise=noise)
    data = _pil(Image.fromarray(rgb8))
    assert fx.gif_digests(data) == chip_smoke.GIF_DIGESTS[(h, w)]
    assert gif.encode_gif(rgb8) == data
    arr, _ = gif.decode_gif(data)
    assert hashlib.sha256(chip_smoke._rgba8(arr).tobytes()).hexdigest() == \
        chip_smoke.GIF_DIGESTS[(h, w)][1]


# ---- the build -----------------------------------------------------------------

@pytest.mark.parametrize("name", ["gif", "quant"])
def test_a_failed_build_raises_with_the_compilers_message(name, tmp_path, monkeypatch):
    src = tmp_path / "src"
    src.mkdir()
    (src / f"{name}.cpp").write_text("int broken( {\n")
    monkeypatch.setattr(_hostbuild, "_NATIVE", src)
    monkeypatch.setattr(_hostbuild, "build_dir", lambda: tmp_path / "build")
    module = gif if name == "gif" else quant
    _hostbuild.load_library.cache_clear()
    module._load.cache_clear()
    try:
        with pytest.raises(RuntimeError, match=r"(?s)failed \(\d+\).*error"):
            if name == "gif":
                gif.decode_gif(READ_CASES["plain"])
            else:
                quant.quantize(np.zeros((2, 2, 3), np.uint8))
    finally:
        _hostbuild.load_library.cache_clear()
        module._load.cache_clear()
