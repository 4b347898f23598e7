"""WebP read of the port: no Pillow, no cv2, no libwebp.

The JAX package reads WebP through Pillow, whose ``WebPImagePlugin``
opens every file with libwebp's ``WebPAnimDecoder`` and takes its first
frame.  :func:`decode_webp` gives the same pixels:

* the RIFF container walked as libwebp's demuxer walks it (``demux.c``):
  a simple ``VP8 `` or ``VP8L`` file, or a ``VP8X`` file with its canvas,
  ``ICCP``, ``EXIF``, ``XMP `` and unknown chunks skipped (Pillow applies
  none of them to the pixels), an ``ALPH`` chunk before a ``VP8 `` one
  (dropped where the ``VP8X`` alpha flag is off, as ``ParseSingleImage``
  drops it), and an animation's first ``ANMF`` frame, placed at its
  offset (2·x, 2·y) on a canvas of zeros (transparent black), as
  ``WebPAnimDecoder`` gives its key frame.  The chunk sizes, the canvas and
  the frame's bounds are checked as the demuxer checks them; what it
  refuses raises ``OSError``;
* the mode Pillow picks: ``RGB`` where ``WebPGetFeatures`` reports no
  alpha, else ``RGBA``.  The alpha hint of a ``VP8L`` header, the
  ``VP8X`` alpha flag and an ``ALPH`` chunk decide it, not the decoded
  values (:func:`_has_alpha`);
* Pillow's decompression-bomb limit on the canvas.

The bitstreams (VP8L, ALPH, VP8 and the YUV to RGB conversion) are
``native/webp.cpp``, built at first use (``_hostbuild.py``; a failed build
raises with the compiler's message).  :func:`not_carried` names the files
that no test holds to Pillow here: VP8 frames with the simple loop filter
or more than one token partition, which no Pillow encoder setting writes.
``io/images.py`` sends those to cv2 where it imports and refuses them
naming ROADMAP item 8f where it does not.  tests/test_torch_webp.py holds
the rest to Pillow.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np

from dspfun_tpu_torch import _hostbuild
from dspfun_tpu_torch.io import gif as _gif

__all__ = ["decode_webp", "not_carried"]

_MAX_PAYLOAD = (1 << 32) - 1 - 8 - 1  # MAX_CHUNK_PAYLOAD
_ALPHA_FLAG, _ANIMATION_FLAG = 0x10, 0x02
_VALID_FLAGS = 0x10 | 0x02 | 0x20 | 0x08 | 0x04  # alpha, animation, ICC, EXIF, XMP
_ERRORS = {-1: "bitstream error", -2: "not enough data", -3: "out of memory",
           -4: "unsupported feature"}


def _le(b: bytes, o: int, n: int) -> int:
    return int.from_bytes(b[o:o + n], "little")


def _vp8_info(p: bytes, chunk_size: int) -> tuple[int, int] | None:
    """VP8GetInfo: the size of a VP8 key frame, None where it is not one."""
    if len(p) < 10 or p[3:6] != b"\x9d\x01\x2a":
        return None
    bits = _le(p, 0, 3)
    w, h = _le(p, 6, 2) & 0x3FFF, _le(p, 8, 2) & 0x3FFF
    if bits & 1 or (bits >> 1) & 7 > 3 or not (bits >> 4) & 1 or bits >> 5 >= chunk_size \
            or not w or not h:
        return None
    return w, h


def _vp8l_info(p: bytes) -> tuple[int, int, int] | None:
    """VP8LGetInfo: (width, height, alpha hint), None where the header is bad."""
    if len(p) < 5 or p[0] != 0x2F or p[4] >> 5:
        return None
    v = _le(p, 1, 4)
    return (v & 0x3FFF) + 1, ((v >> 14) & 0x3FFF) + 1, (v >> 28) & 1


def _features(chunk: bytes) -> tuple[int, int, int] | None:
    """WebPGetFeatures of an image chunk (its header and payload): (width,
    height, alpha), None where it fails."""
    size = _le(chunk, 4, 4)
    p = chunk[8:]
    if chunk[:4] == b"VP8L":
        return _vp8l_info(p)
    wh = _vp8_info(p, size)
    return None if wh is None else (*wh, 0)


class _Frame:
    def __init__(self):
        self.x = self.y = self.width = self.height = 0
        self.image = self.alpha = None  # (offset, size) of the chunks
        self.number = 0


def _store_frame(data: bytes, pos: int, end: int, number: int, fr: _Frame) -> int:
    """StoreFrame: the ALPH and image chunks of a frame from ``pos``;
    returns where the frame's chunks end."""
    if end - pos < 8:
        raise OSError("frame: not enough data")
    alphas = images = 0
    while True:
        fourcc, size = data[pos:pos + 4], _le(data, pos + 4, 4)
        if size > _MAX_PAYLOAD:
            raise OSError("chunk too large")
        padded = size + (size & 1)
        if padded > end - pos - 8:
            raise OSError("chunk runs past the RIFF size")
        if fourcc == b"ALPH" and not alphas:
            alphas = 1
            fr.alpha, fr.number = (pos, 8 + padded), number
        elif fourcc in (b"VP8 ", b"VP8L") and not images:
            if fourcc == b"VP8L" and alphas:
                raise OSError("VP8L after ALPH")
            feat = _features(data[pos:pos + 8 + padded])
            if feat is None:
                raise OSError("bad image chunk header")
            images = 1
            fr.image, fr.number = (pos, 8 + padded), number
            fr.width, fr.height = feat[:2]
        else:
            return pos
        pos += 8 + padded
        if pos == end:
            return pos
        if end - pos < 8:
            raise OSError("truncated chunk header")


def _demux(data: bytes) -> tuple[int, int, _Frame]:
    """WebPDemux and WebPAnimDecoder's first frame: (canvas width,
    canvas height, frame)."""
    if len(data) < 20 or data[:4] != b"RIFF" or data[8:12] != b"WEBP":
        raise OSError("not a WebP file")
    riff_size = _le(data, 4, 4)
    if riff_size < 8 or riff_size > _MAX_PAYLOAD:
        raise OSError("bad RIFF size")
    end = riff_size + 8
    if len(data) < end:
        raise OSError("truncated WebP file")
    first = data[12:16]
    if first in (b"VP8 ", b"VP8L"):
        fr = _Frame()
        _store_frame(data, 12, end, 1, fr)
        if fr.image is None:
            raise OSError("no image in WebP file")
        fr.alpha = None  # the simple format has no alpha flag
        return fr.width, fr.height, fr
    if first != b"VP8X":
        raise OSError("not a WebP file")
    size = _le(data, 16, 4)
    if size > _MAX_PAYLOAD or size < 10:
        raise OSError("bad VP8X chunk")
    padded = size + (size & 1)
    if padded > end - 20:
        raise OSError("VP8X runs past the RIFF size")
    flags = data[20]
    cw, ch = _le(data, 24, 3) + 1, _le(data, 27, 3) + 1
    if cw * ch >= 1 << 32:
        raise OSError("canvas too large")
    pos = 20 + padded
    if end - pos < 8:
        raise OSError("no chunk after VP8X")
    animation = bool(flags & _ANIMATION_FLAG)
    frames: list[_Frame] = []
    anim = 0
    while True:
        fourcc, size = data[pos:pos + 4], _le(data, pos + 4, 4)
        if size > _MAX_PAYLOAD:
            raise OSError("chunk too large")
        padded = size + (size & 1)
        if padded > end - pos - 8:
            raise OSError("chunk runs past the RIFF size")
        if fourcc == b"VP8X":
            raise OSError("second VP8X chunk")
        if fourcc in (b"ALPH", b"VP8 ", b"VP8L"):
            if anim or animation or frames:
                raise OSError("image chunk outside the animation's frames")
            fr = _Frame()
            pos = _store_frame(data, pos, end, 1, fr)
            if not flags & _ALPHA_FLAG:
                fr.alpha = None
            frames.append(fr)
        elif fourcc == b"ANIM":
            if padded < 6:
                raise OSError("bad ANIM chunk")
            anim += 1
            pos += 8 + padded
        elif fourcc == b"ANMF":
            if not anim:
                raise OSError("ANMF before ANIM")
            if padded < 16:
                raise OSError("bad ANMF chunk")
            fr = _Frame()
            q = pos + 8
            fr.x, fr.y = 2 * _le(data, q, 3), 2 * _le(data, q + 3, 3)
            if (_le(data, q + 6, 3) + 1) * (_le(data, q + 9, 3) + 1) >= 1 << 32:
                raise OSError("frame too large")
            stop = _store_frame(data, q + 16, end, len(frames) + 1, fr)
            if stop - (q + 16) > padded - 16:
                raise OSError("frame runs past its ANMF chunk")
            if animation and fr.number:
                if frames and frames[-1].image is None:
                    raise OSError("frame after an incomplete one")
                frames.append(fr)
            pos = stop
        else:
            pos += 8 + padded
        if pos == end:
            break
        if end - pos < 8:
            raise OSError("truncated chunk header")
    # IsValidExtendedFormat
    if not frames or flags & ~_VALID_FLAGS:
        raise OSError("invalid WebP file")
    for fr in frames:
        if fr.image is None or (not animation and fr.number > 1):
            raise OSError("invalid WebP frame")
        if fr.alpha is not None and fr.alpha[0] > fr.image[0]:
            raise OSError("ALPH after the image chunk")
        if not animation and (fr.x or fr.y or fr.width != cw or fr.height != ch):
            raise OSError("image size differs from the canvas")
        if fr.x + fr.width > cw or fr.y + fr.height > ch:
            raise OSError("frame outside the canvas")
    return cw, ch, frames[0]


def _has_alpha(data: bytes) -> bool | None:
    """WebPGetFeatures' ``has_alpha`` of a file ``_demux`` took (None where
    it fails, and Pillow keeps RGBA): the VP8X flag, replaced by a VP8L
    header's hint, or an ALPH chunk before the image."""
    riff_size, p = _le(data, 4, 4), 12
    vp8x = data[p:p + 4] == b"VP8X"
    flags = alpha = 0
    if vp8x:
        if _le(data, p + 4, 4) != 10:
            return None
        flags = _le(data, p + 8, 4)
        cw, ch = _le(data, p + 12, 3) + 1, _le(data, p + 15, 3) + 1
        if flags & _ANIMATION_FLAG:
            return bool(flags & _ALPHA_FLAG)
        p += 18
        total = 22  # ParseOptionalChunks: every chunk to the image within the RIFF size
        while True:
            size = _le(data, p + 4, 4)
            total += (8 + size + 1) & ~1
            if total > riff_size:
                return None
            if data[p:p + 4] in (b"VP8 ", b"VP8L"):
                break
            alpha |= data[p:p + 4] == b"ALPH"
            p += (8 + size + 1) & ~1
    fourcc, size = data[p:p + 4], _le(data, p + 4, 4)
    if size > riff_size - 12:
        return None
    body = data[p + 8:]
    if fourcc == b"VP8L":
        info = _vp8l_info(body)
        if info is None:
            return None
        w, h, has = info
    else:
        wh = _vp8_info(body, size)
        if wh is None:
            return None
        (w, h), has = wh, flags & _ALPHA_FLAG
    if vp8x and (w, h) != (cw, ch):
        return None
    return bool(has or alpha)


def _fragment(data: bytes, fr: _Frame) -> tuple[bytes, bytes | None, bytes]:
    """(fourcc, ALPH payload or None, image payload to the fragment's end,
    padding included) of a frame, as WebPDecode reads its fragment."""
    off, size = fr.image
    alpha = None
    if fr.alpha is not None:
        aoff = fr.alpha[0]
        alpha = data[aoff + 8:aoff + 8 + _le(data, aoff + 4, 4)]
    return data[off:off + 4], alpha, data[off + 8:off + size]


def decode_webp(data: bytes) -> tuple[np.ndarray, int]:
    """(samples [H, W, 3] or [H, W, 4] uint8, 8) of a WebP file's first
    frame, as Pillow reads it (mode RGB or RGBA)."""
    data = bytes(data)
    cw, ch, fr = _demux(data)
    if cw * ch > _gif._MAX_PIXELS:
        raise ValueError(f"image size ({cw * ch} pixels) exceeds the limit of "
                         f"{_gif._MAX_PIXELS} pixels, could be decompression bomb DOS attack")
    has_alpha = _has_alpha(data)
    fourcc, alpha, body = _fragment(data, fr)
    w, h = fr.width, fr.height
    rgba = np.empty((h, w, 4), np.uint8)
    out = rgba.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    lib = _load()
    if fourcc == b"VP8L":
        rc = lib.webp_vp8l_decode(body, len(body), w, h, out)
    else:
        rc = lib.webp_vp8_decode(body, len(body), alpha, 0 if alpha is None else len(alpha),
                                 w, h, out)
    if rc:
        raise OSError(f"failed to decode WebP frame: {_ERRORS.get(rc, rc)}")
    canvas = rgba
    if (fr.x, fr.y, w, h) != (0, 0, cw, ch):
        canvas = np.zeros((ch, cw, 4), np.uint8)
        canvas[fr.y:fr.y + h, fr.x:fr.x + w] = rgba
    if has_alpha is False:
        return np.ascontiguousarray(canvas[..., :3]), 8
    return canvas, 8


def not_carried(data: bytes) -> tuple[str, str] | None:
    """What a WebP file is where the port's decoder does not take it, and
    the letter of its part of ROADMAP queue 1 item 8; None where it does
    (or where the file is damaged, which the decoder then reports)."""
    try:
        _, _, fr = _demux(bytes(data))
        fourcc, _, body = _fragment(data, fr)
    except OSError:
        return None
    if fourcc != b"VP8 ":
        return None
    info = (ctypes.c_int * 2)()
    if _load().webp_vp8_features(body, len(body), info):
        return None
    if info[0] == 1:
        return "WebP with the simple loop filter", "f"
    if info[1] > 1:
        return f"WebP with {info[1]} token partitions", "f"
    return None


@functools.lru_cache(maxsize=None)
def _load() -> ctypes.CDLL:
    """The loaded libwebp of ``native/webp.cpp`` with its signatures
    declared (built on first use; raises when it cannot be built)."""
    lib = _hostbuild.load_library("webp")
    c = ctypes
    u8p = c.POINTER(c.c_uint8)
    lib.webp_vp8l_decode.restype = c.c_int
    lib.webp_vp8l_decode.argtypes = [c.c_char_p, c.c_int64, c.c_int, c.c_int, u8p]
    lib.webp_vp8_decode.restype = c.c_int
    lib.webp_vp8_decode.argtypes = [c.c_char_p, c.c_int64, c.c_char_p, c.c_int64, c.c_int,
                                    c.c_int, u8p]
    lib.webp_vp8_features.restype = c.c_int
    lib.webp_vp8_features.argtypes = [c.c_char_p, c.c_int64, c.POINTER(c.c_int)]
    return lib


