"""Colour quantisation of the port, as Pillow quantises: no Pillow.

The JAX package makes palettes through Pillow twice: its GIF writer
(``Image.save(..., "GIF")`` converts RGB and RGBA to ``P`` with
``palette=ADAPTIVE``) and its sixel encoder (``Image.quantize(256)``,
whose ``dither`` Pillow ignores when it is given no palette).  Both run
Pillow's ``ImagingQuantize`` with method 0 and no k-means, which is
median cut for RGB and fast octree for RGBA (Pillow turns every other
method into octree for RGBA).  :func:`quantize` gives the same indices
and palette; the algorithms are ``native/quant.cpp``, built at first use
(``_hostbuild.py``; a failed build raises with the compiler's message).
tests/test_torch_gif.py holds both to Pillow.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np

from dspfun_tpu_torch import _hostbuild

__all__ = ["quantize"]


def quantize(samples: np.ndarray, colors: int = 256) -> tuple[np.ndarray, np.ndarray, str]:
    """(indices [H, W] uint8, palette [N, C] uint8, palette mode) of an
    [H, W, 3] RGB or [H, W, 4] RGBA uint8 image, as Pillow's
    ``convert("P", palette=ADAPTIVE)`` makes them with ``colors`` entries:
    the mode is "RGB" and N the number of median-cut boxes for RGB,
    "RGBA" and N = ``colors`` (used or not) for RGBA."""
    a = np.ascontiguousarray(samples)
    if a.dtype != np.uint8 or a.ndim != 3 or a.shape[2] not in (3, 4) or 0 in a.shape[:2]:
        raise ValueError(f"quantize takes uint8 RGB or RGBA [H, W, 3|4], not {a.dtype} {a.shape}")
    if not 1 <= colors <= 256:
        raise ValueError("bad number of colors")
    h, w, nch = a.shape
    idx = np.empty((h, w), np.uint8)
    palette = np.zeros((colors, nch), np.uint8)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    args = (a.ctypes.data_as(u8p), h * w, colors, idx.ctypes.data_as(u8p),
            palette.ctypes.data_as(u8p))
    if nch == 3:
        n = ctypes.c_int(0)
        rc = _load().quant_median_cut(*args, ctypes.byref(n))
        palette = palette[:n.value]
    else:
        rc = _load().quant_octree_rgba(*args)
    if rc:
        raise MemoryError("quantize: out of memory") if rc == -2 else ValueError(
            f"quantize failed ({rc})")
    return idx, palette, "RGB" if nch == 3 else "RGBA"


@functools.lru_cache(maxsize=None)
def _load() -> ctypes.CDLL:
    """The loaded libquant with its signatures declared (built on first
    use; raises when it cannot be built)."""
    lib = _hostbuild.load_library("quant")
    c = ctypes
    u8p = c.POINTER(c.c_uint8)
    lib.quant_median_cut.restype = c.c_int
    lib.quant_median_cut.argtypes = [u8p, c.c_int64, c.c_int, u8p, u8p, c.POINTER(c.c_int)]
    lib.quant_octree_rgba.restype = c.c_int
    lib.quant_octree_rgba.argtypes = [u8p, c.c_int64, c.c_int, u8p, u8p]
    return lib
