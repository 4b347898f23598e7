"""The port's sixel encoder (``dspfun_tpu_torch/io/sixel.py``) against
``dspfun_tpu/io/sixel.py``.

* Given the same index image and palette (Pillow's, as the JAX encoder
  makes it), the port's band encoder writes the JAX encoder's bytes.
* The port's palette is Pillow's median cut (``io/quant.py``): its
  ``encode_sixel`` writes the JAX encoder's bytes on seeded smooth,
  noisy and blocky images of more than 256 colours and on images of
  fewer, and its ``quantize`` gives ``Image.quantize``'s index image and
  palette at 2 to 256 colours, and ``chip_smoke.SIXEL_DIGEST`` is the
  JAX encoder's.
* ``write_sixel`` writes ``encode_sixel``'s bytes to a stream.
"""

import io
import re

import numpy as np
import pytest
from PIL import Image

from dspfun_tpu.io import sixel as jsixel
from dspfun_tpu_torch.io import sixel as tsixel

def decode_sixel(data: bytes):
    """(index image [H, W], palette {index: (r%, g%, b%)}) of a sixel
    stream as the encoders write it."""
    assert data.startswith(b"\x1bPq") and data.endswith(b"\x1b\\")
    body = data[3:-2].decode()
    m = re.match(r'"1;1;(\d+);(\d+)', body)
    w, h = int(m.group(1)), int(m.group(2))
    body = body[m.end():]
    pal, idx = {}, np.full((h, w), -1, np.int64)
    i = color = x = y0 = 0
    while i < len(body):
        ch = body[i]
        if ch == "#":
            m = re.match(r"#(\d+)(;2;(\d+);(\d+);(\d+))?", body[i:])
            color = int(m.group(1))
            if m.group(2):
                pal[color] = tuple(int(m.group(k)) for k in (3, 4, 5))
            i += m.end()
            continue
        if ch in "$-":
            x, y0, i = 0, y0 + 6 * (ch == "-"), i + 1
            continue
        run = 1
        if ch == "!":
            m = re.match(r"!(\d+)", body[i:])
            run, i = int(m.group(1)), i + m.end()
            ch = body[i]
        bits = ord(ch) - 63
        for r in range(6):
            if bits >> r & 1 and y0 + r < h:
                idx[y0 + r, x:x + run] = color
        x, i = x + run, i + 1
    assert (idx >= 0).all()
    return idx, pal


def decoded_rgb(data: bytes) -> np.ndarray:
    idx, pal = decode_sixel(data)
    lut = np.zeros((max(pal) + 1, 3))
    for k, v in pal.items():
        lut[k] = v
    return lut[idx] * 255.0 / 100.0


def _images():
    rng = np.random.default_rng(21)
    y, x = np.mgrid[0:72, 0:128] / 72.0
    smooth = np.stack([0.5 + 0.4 * np.sin(6 * x), 0.5 + 0.4 * np.cos(4 * y), 0.3 + 0 * x], -1)
    return {
        "smooth": (smooth * 255).astype(np.uint8),
        "noise": rng.integers(0, 256, (45, 80, 3), dtype=np.uint8),
        "blocks": np.kron(rng.integers(0, 256, (6, 8, 3)), np.ones((7, 9, 1))).astype(np.uint8),
        "few": rng.integers(0, 4, (13, 17, 3), dtype=np.uint8) * 85,
        "tall": rng.integers(0, 256, (40, 3, 3), dtype=np.uint8),
    }


@pytest.mark.parametrize("name", sorted(_images()))
def test_band_encoder_equals_the_jax_encoder_on_its_palette(name):
    rgb = _images()[name]
    pal_img = Image.fromarray(rgb, mode="RGB").quantize(colors=256,
                                                        dither=Image.Dither.FLOYDSTEINBERG)
    idx = np.asarray(pal_img, dtype=np.int32)
    palette = np.array(pal_img.getpalette(), dtype=np.int64).reshape(-1, 3)
    assert tsixel.encode_bands(idx, palette) == jsixel.encode_sixel(rgb)


@pytest.mark.parametrize("name", sorted(_images()))
def test_palette_gate_against_the_jax_encoder(name):
    """The whole encoder, palette included, writes the JAX encoder's bytes."""
    rgb = _images()[name]
    assert tsixel.encode_sixel(rgb) == jsixel.encode_sixel(rgb)


def test_small_palettes_and_quantize():
    rgb = _images()["noise"]
    for n in (2, 7, 64):
        idx, pal = tsixel.quantize(rgb, n)
        ref = Image.fromarray(rgb, mode="RGB").quantize(colors=n)
        np.testing.assert_array_equal(idx, np.asarray(ref))
        np.testing.assert_array_equal(pal.ravel(), ref.getpalette())
        assert len(pal) <= n and idx.max() < len(pal) and idx.shape == rgb.shape[:2]
        _, dec_pal = decode_sixel(tsixel.encode_sixel(rgb, n))
        assert len(dec_pal) <= n
    idx, pal = tsixel.quantize(np.zeros((3, 5, 3), np.uint8))
    assert pal.tolist() == [[0, 0, 0]] and not idx.any()


def test_write_sixel_writes_the_encoding():
    rgb = _images()["few"]
    buf = io.BytesIO()
    tsixel.write_sixel(rgb, buf)
    assert buf.getvalue() == tsixel.encode_sixel(rgb)


def test_chip_smoke_sixel_digest_is_the_jax_encoders():
    """``chip_smoke.SIXEL_DIGEST`` (phase 15(d)) is the sha256 of the JAX
    encoder's sixel of that phase's source levels, and the port's."""
    import hashlib

    import chip_smoke

    rgb = chip_smoke._rgb8(chip_smoke._seeded_pixels(chip_smoke.SIXEL_HW, 16, noise=0.02))
    data = jsixel.encode_sixel(rgb)
    assert hashlib.sha256(data).hexdigest() == chip_smoke.SIXEL_DIGEST
    assert tsixel.encode_sixel(rgb) == data
