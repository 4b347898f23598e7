"""OpenCV input fallback: decode foreign media without an ffmpeg binary
(copy of ``dspfun_tpu/io/cv2_bridge.py``).

OpenCV (when installed) bundles genuine libavformat/libavcodec, so
containers and codecs outside the native stack (mp4/h264, mjpeg,
vp9, ...) can still be decoded when no standalone `ffmpeg` exists on
PATH.  This is a best-effort fallback, honestly scoped: OpenCV
surfaces frames as 8-bit BGR after its own color conversion, so the
reader presents full-range 8-bit RGB (`gbrp`) regardless of the
source's depth or matrix — better than an error, but not the
bit-faithful transport the ffmpeg-binary bridge provides.  With a
binary on PATH the bridge always wins.
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np


def available() -> bool:
    try:
        import cv2  # noqa: F401,PLC0415
    except Exception:  # noqa: BLE001 — any import failure disables
        return False
    return True


def open_cv2_input(spec: str):
    """A VideoReader over cv2.VideoCapture, or raise ValueError when
    OpenCV cannot open/decode the source."""
    import cv2  # noqa: PLC0415

    from dspfun_tpu_torch.io import video as _video  # noqa: PLC0415

    cap = cv2.VideoCapture(spec, cv2.CAP_FFMPEG)
    try:
        if not cap.isOpened():
            raise ValueError(f"{spec!r}: OpenCV could not open the source")
        ok, first = cap.read()
        if not ok or first is None or first.ndim < 2:
            raise ValueError(
                f"{spec!r}: OpenCV opened but decoded no frames")
    except BaseException:
        cap.release()
        raise

    # reader construction still owns the cap: release on any failure
    class _Cv2Reader(_video.VideoReader):
        def __init__(self):
            super().__init__(None, spec, "opencv")
            self._cap = cap
            self._first = first
            self.height, self.width = first.shape[:2]
            self.pix_fmt = _video.PIXEL_FORMATS["gbrp"]
            import math  # noqa: PLC0415

            fps = cap.get(cv2.CAP_PROP_FPS)
            self.rate = (Fraction(fps).limit_denominator(1001 * 60)
                         if fps and math.isfinite(fps) and fps > 0
                         else Fraction(25))
            fc = cap.get(cv2.CAP_PROP_FRAME_COUNT)
            n = int(fc) if math.isfinite(fc) else 0
            self.frames = n if n > 0 else None
            self.props = _video.ColorProps(
                pix_fmt="gbrp", color_range="jpeg", color_space="rgb",
            )

        def read_frame(self, raw: bool = False):
            if self._first is not None:
                bgr, self._first = self._first, None
            else:
                ok, bgr = self._cap.read()
                if not ok:
                    return None
            if bgr.ndim == 2:  # gray sources decode as one channel
                bgr = np.stack([bgr] * 3, axis=-1)
            self.frame_index += 1
            planes = [bgr[..., 1], bgr[..., 0], bgr[..., 2]]  # G, B, R
            if raw:
                return [np.ascontiguousarray(p) for p in planes]
            return [np.asarray(p, dtype=np.float64) / 255.0 for p in planes]

        def close(self) -> None:
            if self._cap is not None:
                self._cap.release()
                self._cap = None

    try:
        return _Cv2Reader()
    except BaseException:
        cap.release()
        raise
