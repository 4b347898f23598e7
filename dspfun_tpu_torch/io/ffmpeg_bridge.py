"""Real-media I/O via ffmpeg/ffprobe binaries on PATH (copy of
``dspfun_tpu/io/ffmpeg_bridge.py`` on the port's containers).

The reference links libavformat/libavcodec directly (include/ffapi.c);
this environment has no FFmpeg libraries, so arbitrary containers
(mp4/mkv/nut/webm/...) are bridged through the ffmpeg *binary* when one
is installed: inputs are demuxed+decoded to a pipe we parse natively,
outputs are piped into an ffmpeg encode process (FFV1 default for
mkv/nut/avi, matching the reference's default encoder —
motion/motion.c:447).  Without the binary these paths raise a clear
error; the native y4m/fvid/image2 containers remain the fast path.

Transport matches the content (the reference decodes any libav pix_fmt
at native depth and writes float GBRPF32 by default — ffapi.c:239-326,
zoom/zoom.c:254,306):

* 8-bit YCbCr rides y4m both directions (as before);
* float / RGB-family content rides ``-f rawvideo`` as gbrpf32le
  (grayf32le for mono), losslessly;
* >8-bit integer YCbCr rides rawvideo at native depth when the format
  is in PIXEL_FORMATS, else as yuv*p16le.

Stream metadata (frame count, rate, color properties incl. chroma
siting) comes from ffprobe when available.
"""

from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
import threading
from fractions import Fraction
from functools import lru_cache

__all__ = [
    "have_ffmpeg",
    "have_ffprobe",
    "probe",
    "open_ffmpeg_input",
    "open_ffmpeg_output",
]


@lru_cache(maxsize=1)
def have_ffmpeg() -> bool:
    return shutil.which("ffmpeg") is not None


@lru_cache(maxsize=1)
def have_ffprobe() -> bool:
    return shutil.which("ffprobe") is not None


def probe(spec: str) -> dict | None:
    """ffprobe stream/format metadata as a dict (None when
    unavailable or the probe fails)."""
    if not have_ffprobe():
        return None
    try:
        out = subprocess.run(
            ["ffprobe", "-v", "error", "-print_format", "json",
             "-show_streams", "-show_format", spec],
            capture_output=True, timeout=60, check=True,
        ).stdout
        return json.loads(out)
    except Exception:  # noqa: BLE001
        return None


_PROBE_RANGE = {"tv": "mpeg", "pc": "jpeg", "mpeg": "mpeg", "jpeg": "jpeg"}
_Y4M_NATIVE = ("gray", "yuv420p", "yuv422p", "yuv444p")
_CHROMA_LOCS = ("left", "center", "topleft", "top", "bottomleft", "bottom")


def _first_video_stream(meta: dict | None) -> dict:
    for st in (meta or {}).get("streams", []):
        if st.get("codec_type") == "video":
            return st
    return {}


def _decode_transport(src_fmt: str) -> str | None:
    """Our pixel format for demuxing ``src_fmt`` content, or None for
    the 8-bit y4m path.  Float/RGB sources decode to float RGB planes
    (lossless for float, exact for <=16-bit int RGB within f32);
    >8-bit YCbCr decodes at native depth (rawvideo passthrough) or
    yuv*p16le."""
    from dspfun_tpu_torch.io import video as _video

    if not src_fmt:
        return None
    pf = _video.PIXEL_FORMATS.get(src_fmt)
    if pf is not None:
        return src_fmt if (pf.depth > 8 or pf.is_float) else None
    if ("f32" in src_fmt or "f16" in src_fmt
            or src_fmt.startswith(("gbr", "rgb", "bgr", "0rgb", "0bgr",
                                   "argb", "abgr", "x2rgb", "x2bgr", "pal"))):
        return "gbrpf32le"
    m = re.match(r"(?:yuv|yuvj|yuva)(4\d\d)p(\d*)", src_fmt)
    if m:
        if int(m.group(2) or 8) <= 8:
            return None
        sub = m.group(1) if m.group(1) in ("420", "422", "444") else "444"
        return f"yuv{sub}p16le"
    if src_fmt.startswith("gray"):
        return "gray16le" if src_fmt != "gray" else None
    if src_fmt.startswith(("p0", "p2", "p4", "v210", "y210", "x210", "v410")):
        # semi-planar / packed high-depth: normalise to 16-bit planar
        return "yuv444p16le"
    return None


def _encode_transport(props) -> str | None:
    """Our pixel format for the rawvideo encode leg, or None for the
    8-bit y4m path.  Matches the reference's float GBRPF32 default
    (zoom/zoom.c:254, motion/motion.c:447)."""
    from dspfun_tpu_torch.io import video as _video

    pf = _video.PIXEL_FORMATS.get(props.pix_fmt) if props.pix_fmt else None
    if pf is None:
        return None
    if pf.is_float:
        return "grayf32le" if pf.ncomp == 1 else "gbrpf32le"
    if pf.depth > 8:
        return props.pix_fmt
    return None


def _parse_rate(st: dict) -> Fraction:
    for key in ("avg_frame_rate", "r_frame_rate"):
        v = st.get(key)
        if v:
            try:
                r = Fraction(v)
                if r > 0:
                    return r
            except (ValueError, ZeroDivisionError):
                pass
    return Fraction(25, 1)


def _apply_probe_metadata(reader, st: dict, fmt: dict | None = None) -> None:
    """Probe metadata beats container defaults (frame count, color
    properties incl. chroma siting — reference ffapi.c:255-269).
    Frame count: stream nb_frames, else stream duration * rate, else
    container (format-level) duration * rate — matroska streams carry
    no nb_frames or duration field (the DURATION tag is textual), so
    the container duration is the real-world path for mkv (caught by
    the ffprobe goldens, tests/goldens/ffprobe_ffv1_10bit_mkv.json)."""
    if not st:
        return
    nb = st.get("nb_frames")
    duration = st.get("duration") or (fmt or {}).get("duration")
    if nb is not None:
        try:
            reader.frames = int(nb)
        except ValueError:
            pass
    elif duration and st.get("avg_frame_rate"):
        try:
            rate = Fraction(st["avg_frame_rate"])
            if rate > 0:
                reader.frames = int(float(duration) * rate)
        except (ValueError, ZeroDivisionError):
            pass
    rng = _PROBE_RANGE.get(st.get("color_range", ""))
    if rng:
        reader.props.color_range = rng
    for key, attr in (("color_space", "color_space"),
                      ("color_transfer", "color_trc"),
                      ("color_primaries", "color_primaries")):
        if st.get(key):
            setattr(reader.props, attr, st[key])
    loc = st.get("chroma_location")
    if loc in _CHROMA_LOCS:
        reader.props.chroma_location = loc


def _pump(src, dst) -> None:
    try:
        shutil.copyfileobj(src, dst, 1 << 16)
    except (BrokenPipeError, OSError):
        pass
    finally:
        try:
            dst.close()
        except OSError:
            pass


def open_ffmpeg_input(spec: str, format: str | None = None,
                      options: str | None = None, stdin_stream=None):
    """Demux/decode any ffmpeg-supported input.

    The returned reader is a regular VideoReader (frame count and color
    properties filled from ffprobe where available; count may be None
    for unindexed streams — callers then need --frames, same as pipes).
    ``stdin_stream`` carries an already-opened (possibly peeked) byte
    stream — the "real container arriving on stdin" case (the reference
    probes any stream, ffapi.c:174-206); it is pumped into ffmpeg by a
    background thread and the probe step is skipped.
    """
    from dspfun_tpu_torch.io import video as _video

    if not have_ffmpeg():
        # binary-less last resort: OpenCV's bundled FFmpeg can decode
        # most real media (8-bit BGR presentation; io/cv2_bridge.py).
        # Files only (the pipe pump needs the real binary), and only
        # when no explicit demuxer format/options were requested —
        # OpenCV probes on its own and would silently drop them
        if (stdin_stream is None and format is None and options is None
                and spec not in ("-", "pipe:", "pipe:0")):
            from dspfun_tpu_torch.io import cv2_bridge  # noqa: PLC0415

            if cv2_bridge.available():
                try:
                    r = cv2_bridge.open_cv2_input(spec)
                except Exception:  # noqa: BLE001 — fall through to the
                    r = None       # clean binary-missing error below
                if r is not None:
                    print(f"{spec}: no ffmpeg binary; decoding via "
                          "OpenCV's bundled FFmpeg (8-bit RGB)",
                          file=sys.stderr)
                    return r
        raise RuntimeError(
            f"opening {spec!r} requires an ffmpeg binary on PATH "
            "(native containers: .y4m, .fvid, image patterns)"
        )
    meta = probe(spec) if stdin_stream is None else None
    st = _first_video_stream(meta)
    src_fmt = st.get("pix_fmt", "")
    transport = _decode_transport(src_fmt)
    if transport is not None and not (st.get("width") and st.get("height")):
        transport = None  # rawvideo needs probed geometry
    cmd = ["ffmpeg"]
    if stdin_stream is None:
        cmd += ["-nostdin"]
    cmd += ["-loglevel", "error"]
    if format:
        cmd += ["-f", format]
    if options:  # --decopts "k=v:k=v" demuxer/decoder options
        for pair in options.split(":"):
            if pair:
                k, _, v = pair.partition("=")
                cmd += [f"-{k}", v]
    cmd += ["-i", "-" if stdin_stream is not None else spec, "-map", "0:v:0"]
    if transport is None:
        if src_fmt not in _Y4M_NATIVE:
            cmd += ["-pix_fmt", "yuv444p"]
        cmd += ["-f", "yuv4mpegpipe", "-"]
    else:
        cmd += ["-pix_fmt", transport, "-f", "rawvideo", "-"]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE,
        stdin=subprocess.PIPE if stdin_stream is not None else None,
    )
    pump = None
    if stdin_stream is not None:
        pump = threading.Thread(target=_pump, args=(stdin_stream, proc.stdin),
                                daemon=True)
        pump.start()
    try:
        if transport is None:
            reader = _video.Y4MReader(proc.stdout, spec)
        else:
            pf = _video.PIXEL_FORMATS[transport]
            if pf.is_rgb or pf.is_float:
                props = _video.ColorProps(
                    pix_fmt=transport, color_range="jpeg",
                    color_primaries="bt709", color_trc="iec61966-2-1",
                    color_space="rgb",
                )
            else:
                props = _video.ColorProps(
                    pix_fmt=transport, color_range="mpeg",
                    color_primaries="smpte170m", color_trc="smpte170m",
                    color_space="smpte170m",
                )
            reader = _video.RawReader(
                proc.stdout, spec, pf, int(st["width"]), int(st["height"]),
                _parse_rate(st), props,
            )
    except Exception:
        proc.terminate()
        proc.wait()
        raise
    reader.format = "ffmpeg"
    reader._proc = proc
    _apply_probe_metadata(reader, st, (meta or {}).get("format"))

    orig_close = reader.close

    def close():
        orig_close()
        if proc.poll() is None:
            proc.terminate()
        proc.wait()

    reader.close = close
    return reader


# extensions AND ffmpeg muxer names that default to the reference's
# lossless FFV1 encoder (motion/motion.c:447)
_FFV1_DEFAULT_EXTS = ("nut", "mkv", "avi", "matroska")


def open_ffmpeg_output(
    spec: str,
    width: int,
    height: int,
    rate: Fraction,
    props,
    format: str | None = None,
    codec: str | None = None,
    options: str | None = None,
):
    """Encode a pipe into any ffmpeg-supported container.

    Default codec is FFV1 for nut/mkv/avi (the reference's default
    encoder, motion/motion.c:447); otherwise ffmpeg's per-container
    default applies.  ``options`` is the reference's "k=v:k=v" codec
    option string (--encopts), passed through as -k v flags.  Float and
    >8-bit content travels as ``-f rawvideo`` at native precision (the
    reference writes float GBRPF32 FFV1 — zoom/zoom.c:254,306); 8-bit
    keeps the y4m leg.
    """
    from dspfun_tpu_torch.io import video as _video

    if not have_ffmpeg():
        raise RuntimeError(
            f"writing {spec!r} requires an ffmpeg binary on PATH "
            "(native containers: .y4m, .fvid, image patterns)"
        )
    ext = spec.rsplit(".", 1)[-1].lower() if "." in spec else ""
    if codec is None and (format in _FFV1_DEFAULT_EXTS
                          or (format is None and ext in _FFV1_DEFAULT_EXTS)):
        codec = "ffv1"
    transport = _encode_transport(props)
    cmd = ["ffmpeg", "-nostdin", "-loglevel", "error", "-y"]
    if transport is None:
        pf = _video.PIXEL_FORMATS[_video._negotiate_pix_fmt("y4m", props)]
        wprops = props.copy()
        _video._default_props("y4m", wprops)
        cmd += ["-f", "yuv4mpegpipe", "-i", "-"]
    else:
        pf = _video.PIXEL_FORMATS[transport]
        wprops = props.copy()
        wprops.pix_fmt = transport
        if pf.is_rgb or pf.is_float:
            wprops.color_range = wprops.color_range or "jpeg"
            if wprops.color_space in (None,):
                wprops.color_space = "rgb"
        else:
            _video._default_props("y4m", wprops)
        cmd += ["-f", "rawvideo", "-pixel_format", transport,
                "-video_size", f"{width}x{height}",
                "-framerate", f"{rate.numerator}/{rate.denominator}",
                "-i", "-"]
    if codec:
        cmd += ["-c:v", codec]
    # full color-property handoff (reference ffapi.c:62-114 sets the
    # complete set on both open paths)
    for val, flag in ((wprops.color_primaries, "-color_primaries"),
                      (wprops.color_trc, "-color_trc"),
                      (wprops.color_space, "-colorspace")):
        if val and val != "rgb":
            cmd += [flag, val]
    if wprops.color_range:
        cmd += ["-color_range", "pc" if wprops.color_range == "jpeg" else "tv"]
    if wprops.chroma_location and pf.chroma_shift != (0, 0):
        cmd += ["-chroma_sample_location", wprops.chroma_location]
    if options:
        for pair in options.split(":"):
            if pair:
                k, _, v = pair.partition("=")
                cmd += [f"-{k}", v]
    if format:
        cmd += ["-f", format]
    cmd += [spec]
    proc = subprocess.Popen(cmd, stdin=subprocess.PIPE)
    if transport is None:
        writer = _video.Y4MWriter(proc.stdin, spec, "ffmpeg", width, height,
                                  rate, pf, wprops)
    else:
        writer = _video.RawWriter(proc.stdin, spec, "ffmpeg", width, height,
                                  rate, pf, wprops)
    orig_close = writer.close

    def close():
        orig_close()
        rc = proc.wait()
        if rc:
            raise RuntimeError(f"ffmpeg encode of {spec!r} failed (rc={rc})")

    writer.close = close
    return writer
