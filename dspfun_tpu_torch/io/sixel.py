"""Sixel terminal graphics encoder (the port's counterpart of
``dspfun_tpu/io/sixel.py``).

Every reference tool that writes images defaults to Sixel inline
display when stdout is a tty (reference spec/spec.c:41-42,
applybasis/genbasis.c:132, draw.c:60-61, via ImageMagick's "sixel:"
coder).  The output is a <= 256-colour palette and run-length encoded
sixel bands.

The JAX package takes its palette from Pillow's ``Image.quantize``
(median cut, Floyd-Steinberg dither), which the port cannot call.
:func:`quantize` builds one of its own: the image's own colours when
there are at most ``max_colors`` of them (then the sixel is exact), else
a median cut over the 8-bit colours weighted by their counts, each pixel
taking its nearest palette entry, without dither.
:func:`encode_bands` writes the sixel bytes of an index image and its
palette as the JAX encoder writes them (tests/test_torch_sixel.py holds
the two to equal bytes on the same palette), with its runs found by
numpy instead of a loop over pixels.
"""

from __future__ import annotations

import sys

import numpy as np

__all__ = ["encode_bands", "encode_sixel", "quantize", "write_sixel"]


def _median_cut(colors: np.ndarray, counts: np.ndarray, n: int) -> np.ndarray:
    """At most ``n`` palette colours for distinct ``colors`` [K, 3] seen
    ``counts`` times: split the box of colours with the widest channel
    range at the count-weighted median of that channel, until there are
    ``n`` boxes or none can split; each box gives its weighted mean."""
    boxes = [np.arange(len(colors))]
    spans = [np.ptp(colors, axis=0)]
    while len(boxes) < n:
        widest = [int(s.max()) if len(b) > 1 else -1 for b, s in zip(boxes, spans)]
        i = int(np.argmax(widest))
        if widest[i] <= 0:
            break
        box, ch = boxes.pop(i), int(np.argmax(spans.pop(i)))
        box = box[np.argsort(colors[box, ch], kind="stable")]
        cum = np.cumsum(counts[box])
        k = int(np.clip(np.searchsorted(cum, cum[-1] / 2.0) + 1, 1, len(box) - 1))
        for part in (box[:k], box[k:]):
            boxes.append(part)
            spans.append(np.ptp(colors[part], axis=0))
    w = [counts[b].astype(np.float64) for b in boxes]
    return np.array([np.rint((colors[b] * wi[:, None]).sum(0) / wi.sum()) for b, wi in
                     zip(boxes, w)], np.int64)


def _nearest(colors: np.ndarray, palette: np.ndarray, chunk: int = 4096) -> np.ndarray:
    """The index of the nearest palette entry (squared distance, the
    first of equals) of each colour."""
    pal = palette.astype(np.int64)
    out = np.empty(len(colors), np.int64)
    for lo in range(0, len(colors), chunk):
        c = colors[lo:lo + chunk].astype(np.int64)
        d = ((c[:, None, :] - pal[None, :, :]) ** 2).sum(axis=2)
        out[lo:lo + chunk] = d.argmin(axis=1)
    return out


def quantize(rgb: np.ndarray, max_colors: int = 256) -> tuple[np.ndarray, np.ndarray]:
    """(index image [H, W] int32, palette [N, 3] int64 of 0..255) of an
    [H, W, 3] uint8 image, N <= ``max_colors``."""
    h, w, _ = rgb.shape
    colors, inverse, counts = np.unique(rgb.reshape(-1, 3), axis=0, return_inverse=True,
                                        return_counts=True)
    inverse = inverse.reshape(-1)
    if len(colors) <= max_colors:
        return inverse.reshape(h, w).astype(np.int32), colors.astype(np.int64)
    palette = _median_cut(colors, counts, max_colors)
    return _nearest(colors, palette)[inverse].reshape(h, w).astype(np.int32), palette


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
