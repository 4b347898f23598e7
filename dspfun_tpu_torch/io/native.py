"""ctypes binding of the host runtime (``native/dspio.cpp``; a copy of
``dspfun_tpu/io/native.py`` on the port's own build of the library).

Provides the compiled container demuxer, the prefetching frame reader,
pel conversions and Floyd-Steinberg dither.  The library is built on
first use by ``dspfun_tpu_torch/_hostbuild.py`` (g++ into
``build/native/``).  Unlike the JAX package, nothing falls back to
pure Python when the build fails: :func:`_load` raises with the
compiler's message, and the readers that need it raise with it.
tests/test_torch_native.py holds the copy to its original.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np

from dspfun_tpu_torch import _hostbuild


@functools.lru_cache(maxsize=None)
def _load() -> ctypes.CDLL:
    """The loaded libdspio with its signatures declared (built on first
    use; raises when it cannot be built)."""
    lib = _hostbuild.load_library("dspio")
    c = ctypes
    P = c.POINTER
    lib.dspio_open.restype = c.c_void_p
    lib.dspio_open.argtypes = [c.c_char_p]
    lib.dspio_open_indexed.restype = c.c_void_p
    lib.dspio_open_indexed.argtypes = [
        c.c_char_p, P(c.c_int64), c.c_int64, c.c_int64, c.c_int,
        P(c.c_int64), P(c.c_int64), c.c_int, c.c_int64, c.c_int64,
        c.c_int64, c.c_int64,
    ]
    for name in ("dspio_width", "dspio_height", "dspio_nframes",
                 "dspio_rate_num", "dspio_rate_den", "dspio_frame_bytes"):
        getattr(lib, name).restype = c.c_int64
        getattr(lib, name).argtypes = [c.c_void_p]
    lib.dspio_nplanes.restype = c.c_int
    lib.dspio_nplanes.argtypes = [c.c_void_p]
    lib.dspio_is_float.restype = c.c_int
    lib.dspio_is_float.argtypes = [c.c_void_p]
    lib.dspio_sample_bytes.restype = c.c_int
    lib.dspio_sample_bytes.argtypes = [c.c_void_p]
    lib.dspio_plane_w.restype = c.c_int64
    lib.dspio_plane_w.argtypes = [c.c_void_p, c.c_int]
    lib.dspio_plane_h.restype = c.c_int64
    lib.dspio_plane_h.argtypes = [c.c_void_p, c.c_int]
    lib.dspio_pixfmt.restype = c.c_char_p
    lib.dspio_pixfmt.argtypes = [c.c_void_p]
    lib.dspio_read_frame.restype = c.c_int
    lib.dspio_read_frame.argtypes = [c.c_void_p, P(c.c_uint8)]
    lib.dspio_seek.restype = c.c_int
    lib.dspio_seek.argtypes = [c.c_void_p, c.c_int64]
    lib.dspio_close.argtypes = [c.c_void_p]
    lib.dspio_prefetch_start.restype = c.c_void_p
    lib.dspio_prefetch_start.argtypes = [c.c_void_p, c.c_int]
    lib.dspio_prefetch_next.restype = c.c_int
    lib.dspio_prefetch_next.argtypes = [c.c_void_p, P(c.c_uint8)]
    lib.dspio_prefetch_stop.argtypes = [c.c_void_p]
    lib.dspio_dither_fs.argtypes = [P(c.c_float), c.c_int64, c.c_int64]
    lib.dspio_dither_fs_batch.argtypes = [P(c.c_float), c.c_int64,
                                          c.c_int64, c.c_int64]
    lib.dspio_u8_to_f32.argtypes = [P(c.c_uint8), P(c.c_float),
                                    c.c_int64, c.c_float]
    lib.dspio_f32_to_u8.argtypes = [P(c.c_float), P(c.c_uint8),
                                    c.c_int64, c.c_float]
    return lib


def available() -> bool:
    """True when the library builds and loads (the JAX package's gate;
    the port's readers call :func:`_load` and let its error through)."""
    try:
        _load()
    except (RuntimeError, OSError):
        return False
    return True


def dither_fs_batch(img: np.ndarray) -> np.ndarray:
    """In-place batched Floyd-Steinberg over [..., h, w] float32 pel
    values 0..255 (native; reference motion/motion.c:778-787)."""
    lib = _load()
    a = np.ascontiguousarray(img, dtype=np.float32)
    h, w = a.shape[-2:]
    n = int(np.prod(a.shape[:-2])) if a.ndim > 2 else 1
    lib.dspio_dither_fs_batch(
        a.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n, h, w
    )
    return a


class NativeVideoReader:
    """Demux y4m/fvid frames through the native reader, optionally with
    background prefetch.  ``index`` opens the indexed-payload mode
    (containers whose frame payloads a host parser located: the
    native NUT path): ``(offsets, frame_bytes, plane_dims,
    sample_bytes, (w, h), (rate_num, rate_den))``."""

    def __init__(self, path: str, prefetch: int = 0, index=None):
        lib = _load()
        self._lib = lib
        self.path = path
        if index is not None:
            offsets, frame_bytes, plane_dims, sample_bytes, wh, rate = index
            offs = np.asarray(offsets, dtype=np.int64)
            pw = np.asarray([d[0] for d in plane_dims], dtype=np.int64)
            ph = np.asarray([d[1] for d in plane_dims], dtype=np.int64)
            i64p = ctypes.POINTER(ctypes.c_int64)
            self._h = lib.dspio_open_indexed(
                path.encode(), offs.ctypes.data_as(i64p), len(offs),
                frame_bytes, len(plane_dims),
                pw.ctypes.data_as(i64p), ph.ctypes.data_as(i64p),
                sample_bytes, wh[0], wh[1], rate[0], rate[1],
            )
        else:
            self._h = lib.dspio_open(path.encode())
        if not self._h:
            raise OSError(f"dspio cannot open {path!r}")
        self.width = lib.dspio_width(self._h)
        self.height = lib.dspio_height(self._h)
        self.nframes = lib.dspio_nframes(self._h)
        self.rate = (lib.dspio_rate_num(self._h), lib.dspio_rate_den(self._h))
        self.is_float = bool(lib.dspio_is_float(self._h))
        self.sample_bytes = int(lib.dspio_sample_bytes(self._h))
        self.pixfmt = lib.dspio_pixfmt(self._h).decode()
        np_planes = lib.dspio_nplanes(self._h)
        self.plane_dims = [
            (lib.dspio_plane_w(self._h, i), lib.dspio_plane_h(self._h, i))
            for i in range(np_planes)
        ]
        self._frame_bytes = lib.dspio_frame_bytes(self._h)
        self._pf = None
        if prefetch:
            self.start_prefetch(prefetch)

    def start_prefetch(self, depth: int = 4) -> None:
        """Start the background reader thread from the current
        position; seeking is no longer possible afterwards."""
        if not self._pf:
            self._pf = self._lib.dspio_prefetch_start(self._h, depth)

    def seek(self, frame: int) -> None:
        if self._pf:
            raise RuntimeError("cannot seek while prefetching")
        if self._lib.dspio_seek(self._h, frame) != 0:
            raise OSError("seek failed")

    def read_frame(self) -> list[np.ndarray] | None:
        buf = np.empty(self._frame_bytes, dtype=np.uint8)
        ptr = buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
        if self._pf:
            rc = self._lib.dspio_prefetch_next(self._pf, ptr)
        else:
            rc = self._lib.dspio_read_frame(self._h, ptr)
        if rc < 0:
            # corrupt FRAME marker mid-stream: match the pure-Python
            # reader's behaviour (it raises) instead of reporting EOF
            raise ValueError(f"bad frame marker in {self.path!r}")
        if rc != 1:
            return None
        out = []
        off = 0
        dt = (np.dtype("<f4") if self.is_float
              else np.dtype("<u2") if self.sample_bytes == 2
              else np.dtype("u1"))
        for w, h in self.plane_dims:
            nb = w * h * dt.itemsize
            out.append(buf[off : off + nb].view(dt).reshape(h, w).copy())
            off += nb
        return out

    def close(self) -> None:
        if self._pf:
            self._lib.dspio_prefetch_stop(self._pf)
            self._pf = None
        if self._h:
            self._lib.dspio_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
