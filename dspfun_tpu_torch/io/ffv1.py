"""FFV1 codec binding (``native/ffv1.cpp``, RFC 9043; a copy of
``dspfun_tpu/io/ffv1.py`` on the port's own build of the library).

FFV1 is the reference's *default* output codec for every video tool
(reference motion/motion.c:447, motion/rotate.c:128,
motion/transcode.c:76, zoom/zoom.c:306, scan/scan.c:326 all pass
AV_CODEC_ID_FFV1); the reference gets it from libavcodec.  This
binding exposes the package's own implementation, so FFV1-in-NUT and
FFV1-in-Matroska encode and decode with no external binary.  The
encoder writes version-1 range-coded keyframes (YCbCr/gray, 8..16
bits; version 3 for 16-bit RGB or ``level=3``); the decoder covers
versions 0-3 including extradata parameters, slices, the Golomb-Rice
coder, and 8-bit RGB via the reversible color transform (see
FFV1Decoder).  Float formats cannot ride FFV1 at all and keep the
rawvideo payload path.

The library is built on first use by ``dspfun_tpu_torch/_hostbuild.py``
(g++ into ``build/native/``).  Unlike the JAX package, whose NUT writer
quietly writes rawvideo payloads when the library cannot be built, a
failed build raises here with the compiler's message.  The range coder
is integer arithmetic, so the copy writes the original's bytes
(tests/test_torch_ffv1.py).
"""

from __future__ import annotations

import ctypes
import functools
import re
from dataclasses import dataclass

import numpy as np

from dspfun_tpu_torch import _hostbuild

class _CParams(ctypes.Structure):
    _fields_ = [(n, ctypes.c_int32) for n in (
        "version", "coder", "colorspace", "bits", "chroma_planes",
        "h_shift", "v_shift", "transparency", "width", "height")]


@dataclass
class FFV1Params:
    """Decoded parameter set (RFC 9043 section 4.2)."""

    bits: int = 8
    chroma_planes: bool = True
    h_shift: int = 0
    v_shift: int = 0
    transparency: bool = False
    version: int = 1
    colorspace: int = 0  # 0 = YCbCr/gray, 1 = RGB (JPEG2000-RCT)

    def pix_fmt_name(self) -> str:
        """Map onto the framework's PIXEL_FORMATS registry name."""
        if self.colorspace == 1:
            # transparency (bgr0 padding or real alpha) decodes but the
            # 4th plane is dropped — no alpha pixel format exists here
            if self.bits == 8:
                return "gbrp"
            if self.bits == 16:
                return "gbrp16le"
            raise ValueError(
                f"FFV1 RGB at {self.bits} bits has no native format")
        if self.transparency:
            raise ValueError("FFV1 alpha plane has no native pixel format")
        if not self.chroma_planes:
            if self.bits == 8:
                return "gray"
            if self.bits == 16:
                return "gray16le"
            raise ValueError(f"FFV1 gray at {self.bits} bits unsupported")
        sub = {(1, 1): "420", (1, 0): "422", (0, 0): "444"}.get(
            (self.h_shift, self.v_shift))
        if sub is None:
            raise ValueError(
                f"FFV1 chroma shift {self.h_shift}/{self.v_shift} has no "
                "native pixel format")
        if self.bits == 8:
            return f"yuv{sub}p"
        if self.bits in (10, 12, 16):
            return f"yuv{sub}p{self.bits}le"
        raise ValueError(f"FFV1 YCbCr at {self.bits} bits unsupported")


def params_for_pix_fmt(pf, version: int = 1) -> FFV1Params:
    """FFV1 parameter set for a PixelFormat, or raise ValueError.

    ``version`` mirrors ffmpeg's ``level`` option: 1 (default, in-band
    parameters, whole-frame keyframes) or 3 (extradata + independent
    slices).  RGB beyond 8 bits needs the version-3 layout, as in
    libavcodec."""
    if version not in (1, 3):
        raise ValueError(f"FFV1 level {version} unsupported (1 or 3)")
    if pf.is_float:
        raise ValueError(f"{pf.name}: FFV1 codes integer samples only")
    if pf.is_rgb:
        if pf.ncomp != 3 or pf.depth not in (8, 16) or (
                pf.depth != 8 and version < 3):
            raise ValueError(
                f"{pf.name}: FFV1 RGB is 8-bit G,B,R planar "
                "(16-bit needs level=3)")
        return FFV1Params(bits=pf.depth, chroma_planes=False, colorspace=1,
                          version=version)
    if pf.ncomp == 1:
        return FFV1Params(bits=pf.depth, chroma_planes=False,
                          version=version)
    if pf.ncomp != 3:
        raise ValueError(f"{pf.name}: unsupported plane count")
    return FFV1Params(bits=pf.depth, chroma_planes=True,
                      h_shift=pf.chroma_shift[0], v_shift=pf.chroma_shift[1],
                      version=version)


@functools.lru_cache(maxsize=None)
def _load() -> ctypes.CDLL:
    """The loaded libffv1 with its signatures declared (built on first
    use; raises when it cannot be built)."""
    lib = _hostbuild.load_library("ffv1")
    c = ctypes
    u8p = c.POINTER(c.c_uint8)
    lib.ffv1_encode.restype = c.c_int64
    lib.ffv1_encode.argtypes = [c.POINTER(u8p), c.POINTER(c.c_int64),
                                c.POINTER(_CParams), u8p, c.c_int64]
    lib.ffv1_max_packet.restype = c.c_int64
    lib.ffv1_max_packet.argtypes = [c.POINTER(_CParams)]
    lib.ffv1_probe.restype = c.c_int32
    lib.ffv1_probe.argtypes = [c.c_char_p, c.c_int64, c.POINTER(_CParams)]
    lib.ffv1_decoder_new.restype = c.c_void_p
    lib.ffv1_decoder_new.argtypes = []
    lib.ffv1_decoder_free.restype = None
    lib.ffv1_decoder_free.argtypes = [c.c_void_p]
    lib.ffv1_decode.restype = c.c_int32
    lib.ffv1_decode.argtypes = [c.c_void_p, c.c_char_p, c.c_int64,
                                c.POINTER(u8p), c.POINTER(c.c_int64),
                                c.POINTER(_CParams)]
    lib.ffv1_set_extradata.restype = c.c_int32
    lib.ffv1_set_extradata.argtypes = [c.c_void_p, c.c_char_p,
                                       c.c_int64, c.POINTER(_CParams)]
    lib.ffv1_extradata.restype = c.c_int64
    lib.ffv1_extradata.argtypes = [c.POINTER(_CParams), c.c_int32,
                                   c.c_int32, u8p, c.c_int64]
    lib.ffv1_encode_v3.restype = c.c_int64
    lib.ffv1_encode_v3.argtypes = [c.POINTER(u8p), c.POINTER(c.c_int64),
                                   c.POINTER(_CParams), c.c_int32,
                                   c.c_int32, u8p, c.c_int64]
    return lib


def available() -> bool:
    """True when the library builds and loads (the JAX package's gate;
    the port's writers and readers call :func:`_load` and let its error
    through)."""
    try:
        _load()
    except (RuntimeError, OSError):
        return False
    return True


def _cparams(p: FFV1Params, width: int, height: int) -> _CParams:
    return _CParams(p.version, 1, p.colorspace, p.bits,
                    int(p.chroma_planes), p.h_shift, p.v_shift,
                    int(p.transparency), width, height)


def _params_from_c(cp: _CParams) -> FFV1Params:
    return FFV1Params(bits=cp.bits, chroma_planes=bool(cp.chroma_planes),
                      h_shift=cp.h_shift, v_shift=cp.v_shift,
                      transparency=bool(cp.transparency),
                      version=cp.version, colorspace=cp.colorspace)


def _plane_ptrs(planes: list[np.ndarray]):
    u8p = ctypes.POINTER(ctypes.c_uint8)
    ptrs = (u8p * len(planes))(
        *[pl.ctypes.data_as(u8p) for pl in planes])
    strides = (ctypes.c_int64 * len(planes))(
        *[pl.strides[0] // pl.itemsize for pl in planes])
    return ptrs, strides


def encode_frame(planes: list[np.ndarray], params: FFV1Params,
                 width: int, height: int) -> bytes:
    """Encode one keyframe; planes are uint8/uint16 C-contiguous rows."""
    lib = _load()
    dt = np.uint16 if params.bits > 8 else np.uint8
    planes = [np.ascontiguousarray(pl, dtype=dt) for pl in planes]
    cp = _cparams(params, width, height)
    cap = lib.ffv1_max_packet(ctypes.byref(cp))
    out = np.empty(cap, np.uint8)
    ptrs, strides = _plane_ptrs(planes)
    n = lib.ffv1_encode(ptrs, strides, ctypes.byref(cp),
                        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                        cap)
    if n < 0:
        raise RuntimeError("FFV1 encode overflow")  # cap bound is generous
    return out[:n].tobytes()


# ffmpeg's `slices` option values and their slice grids (ffv1enc's
# count -> num_h x num_v mapping); used when options request a count.
_SLICE_GRIDS = {4: (2, 2), 6: (3, 2), 9: (3, 3), 12: (4, 3), 16: (4, 4),
                24: (6, 4), 30: (6, 5)}


def slice_grid(params: FFV1Params, width: int, height: int,
               slices: int | None = None) -> tuple[int, int]:
    """Choose a version-3 slice grid.

    Interior boundaries must land on the chroma grid (the v3 floor
    geometry leaves a never-coded chroma column/row otherwise — see
    native/ffv1.cpp v3_enc_supported), so the requested grid shrinks
    toward 1x1 until every boundary aligns and fits the frame."""
    if slices:
        nh, nv = _SLICE_GRIDS.get(slices, (0, 0))
        if not nh:
            s = max(1, int(slices))
            nv = max(1, int(s ** 0.5))
            nh = (s + nv - 1) // nv
    else:
        # default: ~one slice per 512x512 region, at least 2x2 (the
        # point of level 3 is slice parallelism), within the table
        nh = max(2, -(-width // 512))
        nv = max(2, -(-height // 512))

    def aligned(n, dim, shift):
        if n > max(1, dim):
            return False
        mask = (1 << shift) - 1
        return all((s * dim // n) & mask == 0 for s in range(1, n))

    while nh > 1 and not aligned(nh, width, params.h_shift):
        nh -= 1
    while nv > 1 and not aligned(nv, height, params.v_shift):
        nv -= 1
    return min(nh, 256), min(nv, 256)


def extradata(params: FFV1Params, width: int, height: int,
              num_h: int, num_v: int) -> bytes:
    """Version-3 out-of-band parameter set (NUT codec_specific_data /
    matroska CodecPrivate) for encode_frame_v3 streams."""
    lib = _load()
    cp = _cparams(params, width, height)
    out = np.empty(65536, np.uint8)
    n = lib.ffv1_extradata(ctypes.byref(cp), num_h, num_v,
                           out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                           len(out))
    if n < 0:
        raise ValueError(
            f"FFV1 v3 parameters unsupported ({params}, {num_h}x{num_v})")
    return out[:n].tobytes()


def encode_frame_v3(planes: list[np.ndarray], params: FFV1Params,
                    width: int, height: int, num_h: int,
                    num_v: int) -> bytes:
    """Encode one version-3 keyframe as a num_h x num_v slice grid
    (pair with :func:`extradata` built from the same arguments)."""
    lib = _load()
    dt = np.uint16 if params.bits > 8 else np.uint8
    planes = [np.ascontiguousarray(pl, dtype=dt) for pl in planes]
    cp = _cparams(params, width, height)
    cap = lib.ffv1_max_packet(ctypes.byref(cp))
    out = np.empty(cap, np.uint8)
    ptrs, strides = _plane_ptrs(planes)
    n = lib.ffv1_encode_v3(ptrs, strides, ctypes.byref(cp), num_h, num_v,
                           out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                           cap)
    if n == -2:
        raise ValueError(
            f"FFV1 v3 parameters unsupported ({params}, {num_h}x{num_v})")
    if n < 0:
        raise RuntimeError("FFV1 encode overflow")  # cap bound is generous
    return out[:n].tobytes()


def parse_codec_opts(options: str | None) -> dict:
    """Tolerant k=v parse of an ffmpeg-style option string (``:`` / ``,``
    separated, as -encopts / --ff-opts take).  Only the FFV1-relevant
    keys are returned: level, slices, slicecrc."""
    out: dict = {}
    for part in re.split(r"[:,|]", options or ""):
        k, eq, v = part.strip().partition("=")
        if not eq or k not in ("level", "slices", "slicecrc"):
            continue
        try:
            out[k] = int(v)
        except ValueError:
            continue
    return out


class FFV1Encoder:
    """Frame encoder bound to one parameter set.

    ``level`` mirrors ffmpeg's option: 1 (default — in-band parameters,
    whole-frame keyframes, what the reference's libavcodec writes by
    default) or 3 (out-of-band extradata + independent slice grid with
    CRC trailers, ffmpeg's ``-level 3``).  16-bit RGB auto-selects
    level 3, as the v0/1 layout cannot carry it.  ``slices`` asks for
    an ffmpeg-style slice count (4/6/9/12/16/24/30); the grid shrinks
    to respect chroma alignment (see :func:`slice_grid`)."""

    def __init__(self, pix_fmt, width: int, height: int,
                 options: str | dict | None = None):
        opts = (options if isinstance(options, dict)
                else parse_codec_opts(options))
        level = opts.get("level")
        if level is None:
            level = 3 if (pix_fmt.is_rgb and pix_fmt.depth > 8) else 1
        if level in (0, 1):
            level = 1
        self.params = params_for_pix_fmt(pix_fmt, version=level)
        self.width, self.height = width, height
        if level >= 3:
            self.num_h, self.num_v = slice_grid(
                self.params, width, height, opts.get("slices"))
            self.extradata = extradata(self.params, width, height,
                                       self.num_h, self.num_v)
        else:
            self.num_h = self.num_v = 0
            self.extradata = b""

    def encode(self, planes: list[np.ndarray]) -> bytes:
        if self.num_h:
            return encode_frame_v3(planes, self.params, self.width,
                                   self.height, self.num_h, self.num_v)
        return encode_frame(planes, self.params, self.width, self.height)


def probe(packet: bytes, width: int, height: int) -> FFV1Params:
    """Parse the parameter set of a keyframe packet."""
    lib = _load()
    cp = _CParams(width=width, height=height)
    if not lib.ffv1_probe(packet, len(packet), ctypes.byref(cp)):
        raise ValueError("unsupported FFV1 bitstream (v2+ without "
                         "extradata, or not a keyframe)")
    return _params_from_c(cp)


class FFV1Decoder:
    """Stateful packet decoder (inter frames continue adaptation).

    ``extradata`` (NUT codec_specific_data / matroska CodecPrivate)
    switches to the version>=2 slice-based decode: both coders
    (range + Golomb-Rice), YCbCr/gray and RGB-RCT, validated
    bit-exactly against real libavcodec output
    (tests/test_interop_cv2.py).  RGB frames decode G,B,R(,A); the
    alpha plane is dropped from the returned list (no native alpha
    pixel format)."""

    def __init__(self, width: int, height: int,
                 extradata: bytes | None = None):
        lib = _load()
        self._lib = lib
        self._h = lib.ffv1_decoder_new()
        self.width, self.height = width, height
        self.params: FFV1Params | None = None
        if extradata:
            cp = _CParams(width=width, height=height)
            if not lib.ffv1_set_extradata(self._h, extradata,
                                          len(extradata), ctypes.byref(cp)):
                lib.ffv1_decoder_free(self._h)
                self._h = None
                raise ValueError(
                    "unsupported FFV1 extradata (version/coder/quant "
                    "tables out of the decoder's domain)")
            self.params = _params_from_c(cp)

    def decode(self, packet: bytes) -> list[np.ndarray]:
        if self._h is None:
            raise RuntimeError("FFV1Decoder is closed")
        if self.params is None:
            self.params = probe(packet, self.width, self.height)
        p = self.params
        dt = np.uint16 if p.bits > 8 else np.uint8
        if p.colorspace == 1:
            dims = [(self.width, self.height)] * (3 + int(p.transparency))
        else:
            dims = [(self.width, self.height)]
            if p.chroma_planes:
                cw = (self.width + (1 << p.h_shift) - 1) >> p.h_shift
                ch = (self.height + (1 << p.v_shift) - 1) >> p.v_shift
                dims += [(cw, ch), (cw, ch)]
            if p.transparency:
                dims.append((self.width, self.height))
        planes = [np.empty((h, w), dt) for (w, h) in dims]
        ptrs, strides = _plane_ptrs(planes)
        cp = _cparams(p, self.width, self.height)
        ok = self._lib.ffv1_decode(self._h, packet, len(packet),
                                   ptrs, strides, ctypes.byref(cp))
        if not ok:
            raise ValueError("corrupt or unsupported FFV1 packet")
        if p.colorspace == 1:
            return planes[:3]  # G, B, R; padding/alpha dropped
        return planes

    def close(self) -> None:
        if self._h:
            self._lib.ffv1_decoder_free(self._h)
            self._h = None

    def __del__(self):  # noqa: D105
        try:
            self.close()
        except Exception:  # noqa: BLE001 — interpreter shutdown
            pass
