"""Sixel terminal graphics encoder (the port's counterpart of
``dspfun_tpu/io/sixel.py``).

Every reference tool that writes images defaults to Sixel inline
display when stdout is a tty (reference spec/spec.c:41-42,
applybasis/genbasis.c:132, draw.c:60-61, via ImageMagick's "sixel:"
coder).  The output is a <= 256-colour palette and run-length encoded
sixel bands.

The JAX package takes its palette from Pillow's ``Image.quantize``,
which, given no palette to map onto, ignores its ``dither`` argument and
runs a plain median cut.  :func:`quantize` takes the same palette and
index image from ``io/quant.py`` (Pillow's median cut, ported), and
:func:`encode_bands` writes the sixel bytes of an index image and its
palette as the JAX encoder writes them, with its runs found by numpy
instead of a loop over pixels; tests/test_torch_sixel.py holds
:func:`encode_sixel` to the JAX encoder's bytes.
"""

from __future__ import annotations

import sys

import numpy as np

from dspfun_tpu_torch.io import quant as _quant

__all__ = ["encode_bands", "encode_sixel", "quantize", "write_sixel"]


def quantize(rgb: np.ndarray, max_colors: int = 256) -> tuple[np.ndarray, np.ndarray]:
    """(index image [H, W] int32, palette [N, 3] int64 of 0..255) of an
    [H, W, 3] uint8 image, N <= ``max_colors``: Pillow's
    ``Image.quantize(max_colors)``."""
    idx, palette, _ = _quant.quantize(np.asarray(rgb, dtype=np.uint8), max_colors)
    return idx.astype(np.int32), palette.astype(np.int64)


def encode_bands(idx: np.ndarray, palette: np.ndarray) -> bytes:
    """The sixel bytes of an index image [H, W] over ``palette`` [N, 3]
    (0..255): the JAX encoder's header, palette (percent, rounded down),
    bands of six rows, one ``$``-separated pass per colour present, and
    runs longer than three as ``!n``."""
    idx = np.asarray(idx)
    palette = np.asarray(palette, dtype=np.int64)
    ncolors = int(idx.max()) + 1
    h, w = idx.shape

    out = bytearray()
    out += b"\x1bPq"
    out += f'"1;1;{w};{h}'.encode()
    for c in range(ncolors):
        r, g, b = (palette[c] * 100 // 255).tolist()
        out += f"#{c};2;{r};{g};{b}".encode()

    weights = (1 << np.arange(6, dtype=np.uint8))[:, None]
    for band_start in range(0, h, 6):
        band = idx[band_start:band_start + 6]
        first = True
        for c in np.unique(band).tolist():
            if not first:
                out += b"$"  # carriage return within band
            first = False
            out += f"#{c}".encode()
            chars = ((band == c) * weights[:band.shape[0]]).sum(axis=0, dtype=np.uint8) + 63
            starts = np.flatnonzero(np.concatenate(([True], chars[1:] != chars[:-1])))
            runs = np.diff(np.append(starts, w))
            for ch, run in zip(chars[starts].tolist(), runs.tolist()):
                out += f"!{run}".encode() + bytes([ch]) if run > 3 else bytes([ch]) * run
        out += b"-"  # next band
    out += b"\x1b\\"
    return bytes(out)


def encode_sixel(rgb: np.ndarray, max_colors: int = 256) -> bytes:
    """Encode an [H, W, 3] uint8 array as a sixel byte string."""
    return encode_bands(*quantize(np.asarray(rgb, dtype=np.uint8), max_colors))


def write_sixel(rgb: np.ndarray, stream=None) -> None:
    stream = stream or sys.stdout.buffer
    stream.write(encode_sixel(rgb))
    stream.flush()
