"""Native Matroska/WebM demuxer and FFV1 muxer (a copy of
``dspfun_tpu/io/mkv.py``; video track only).

Real-world FFV1 archives live in `.mkv` (the reference's ecosystem
pairs AV_CODEC_ID_FFV1 with matroska/NUT through libavformat —
ffapi.c:362-559 lets the format guess the muxer from the extension).
This demuxer covers what the native decoders can consume — FFV1
(any version, via io/ffv1.py) and uncompressed video — so those files
open with zero external binaries; everything else still routes to the
ffmpeg-binary bridge.

Scope: EBML element walk (unknown elements skipped, per the format's
forward-compat design), first video track's TrackEntry (CodecID,
CodecPrivate, dimensions, default duration, Colour element), Cluster
timestamps, SimpleBlock/BlockGroup frames (no lacing — video tracks
don't lace).  Validated against real libavformat-written files
(OpenCV's bundled FFmpeg, tests/test_interop_cv2.py); the copy is held
to the original, and to files cv2 writes, by tests/test_torch_mkv.py.
"""

from __future__ import annotations

import io
from dataclasses import dataclass, field
from fractions import Fraction

__all__ = ["MkvDemuxer", "MkvTrack", "MAGIC"]

MAGIC = b"\x1a\x45\xdf\xa3"  # EBML header ID

# element IDs (with the length marker kept, as conventionally written)
_SEGMENT = 0x18538067
_INFO = 0x1549A966
_TIMESTAMP_SCALE = 0x2AD7B1
_DURATION = 0x4489
_TRACKS = 0x1654AE6B
_TRACK_ENTRY = 0xAE
_TRACK_NUMBER = 0xD7
_TRACK_TYPE = 0x83
_CODEC_ID = 0x86
_CODEC_PRIVATE = 0x63A2
_DEFAULT_DURATION = 0x23E383
_VIDEO = 0xE0
_PIXEL_WIDTH = 0xB0
_PIXEL_HEIGHT = 0xBA
_COLOUR = 0x55B0
_MATRIX = 0x55B1
_RANGE = 0x55B9
_TRC = 0x55BA
_PRIMARIES = 0x55BB
_CLUSTER = 0x1F43B675
_CLUSTER_TS = 0xE7
_SIMPLE_BLOCK = 0xA3
_BLOCK_GROUP = 0xA0
_BLOCK = 0xA1

# ISO/IEC 23001-8 code points -> the framework's color-property names
_MATRIX_NAMES = {1: "bt709", 5: "bt470bg", 6: "smpte170m", 9: "bt2020nc",
                 0: "rgb"}
_TRC_NAMES = {1: "bt709", 6: "smpte170m", 8: "linear", 13: "iec61966-2-1"}
_PRIM_NAMES = {1: "bt709", 5: "bt470bg", 6: "smpte170m", 9: "bt2020"}


@dataclass
class MkvTrack:
    number: int = -1
    codec_id: str = ""
    codec_private: bytes = b""
    width: int = 0
    height: int = 0
    default_duration_ns: int | None = None
    color_range: str | None = None
    color_space: str | None = None
    color_trc: str | None = None
    color_primaries: str | None = None


@dataclass
class _Element:
    eid: int
    size: int | None  # None = unknown size (streamed)
    payload_start: int


class MkvDemuxer:
    """Sequential packet reader over the first video track."""

    def __init__(self, stream):
        self._s = stream
        self.timestamp_scale = 1_000_000  # ns per timestamp tick
        self.duration_ticks: float | None = None
        self.track: MkvTrack | None = None
        self._cluster_end: int | None = None
        self._cluster_ts = 0
        self._segment_end: int | None = None
        # corrupt length fields must not trigger multi-GB reads
        self._stream_end: int | None = None
        try:
            if stream.seekable():
                pos = stream.tell()
                self._stream_end = stream.seek(0, 2)
                stream.seek(pos)
        except (AttributeError, OSError):
            pass
        head = self._read_element()
        if head is None or head.eid != 0x1A45DFA3:
            raise ValueError("not a matroska/EBML stream")
        self._skip(head)
        seg = self._read_element()
        if seg is None or seg.eid != _SEGMENT:
            raise ValueError("matroska Segment missing")
        if seg.size is not None:
            self._segment_end = seg.payload_start + seg.size
        self._parse_headers()

    # -- EBML primitives --------------------------------------------

    def _read_vint(self, keep_marker: bool,
                   sentinel: bool = True) -> int | None:
        b = self._s.read(1)
        if not b:
            return None
        first = b[0]
        mask = 0x80
        length = 1
        while length <= 8 and not (first & mask):
            mask >>= 1
            length += 1
        if length > 8:
            raise ValueError("bad EBML varint")
        v = first if keep_marker else (first & (mask - 1))
        rest = self._s.read(length - 1)
        if len(rest) < length - 1:
            return None
        for byte in rest:
            v = (v << 8) | byte
        if not keep_marker and sentinel:
            # all-ones data = unknown SIZE (does not apply to other
            # varint fields like Block track numbers)
            if v == (1 << (7 * length)) - 1:
                return -1
        return v

    def _read_element(self) -> _Element | None:
        eid = self._read_vint(keep_marker=True)
        if eid is None:
            return None
        size = self._read_vint(keep_marker=False)
        if size is None:
            return None
        pos = self._s.tell()
        if (size != -1 and self._stream_end is not None
                and pos + size > self._stream_end):
            raise ValueError("matroska element overruns the file")
        return _Element(eid, None if size == -1 else size, pos)

    def _skip(self, el: _Element) -> None:
        if el.size is None:
            raise ValueError("cannot skip unknown-size element")
        self._s.seek(el.payload_start + el.size)

    def _read_uint(self, el: _Element) -> int:
        data = self._s.read(el.size or 0)
        v = 0
        for b in data:
            v = (v << 8) | b
        return v

    def _read_float(self, el: _Element) -> float:
        import struct

        data = self._s.read(el.size or 0)
        if len(data) == 4:
            return struct.unpack(">f", data)[0]
        if len(data) == 8:
            return struct.unpack(">d", data)[0]
        return 0.0

    # -- headers -----------------------------------------------------

    def _parse_headers(self) -> None:
        """Walk segment children up to (and including) Tracks; stop at
        the first Cluster (its element is held pending)."""
        self._pending: _Element | None = None
        while True:
            el = self._read_element()
            if el is None:
                break
            if el.eid == _CLUSTER:
                self._pending = el
                break
            if el.eid == _INFO:
                self._parse_info(el)
            elif el.eid == _TRACKS:
                self._parse_tracks(el)
            else:
                self._skip(el)
        if self.track is None:
            raise ValueError("matroska file has no video track")

    def _parse_info(self, el: _Element) -> None:
        end = el.payload_start + (el.size or 0)
        while self._s.tell() < end:
            ch = self._read_element()
            if ch is None:
                break
            if ch.eid == _TIMESTAMP_SCALE:
                self.timestamp_scale = self._read_uint(ch)
            elif ch.eid == _DURATION:
                self.duration_ticks = self._read_float(ch)
            else:
                self._skip(ch)
        self._s.seek(end)

    def _parse_tracks(self, el: _Element) -> None:
        end = el.payload_start + (el.size or 0)
        while self._s.tell() < end:
            ch = self._read_element()
            if ch is None:
                break
            if ch.eid == _TRACK_ENTRY:
                t = self._parse_track_entry(ch)
                if t is not None and self.track is None:
                    self.track = t
            else:
                self._skip(ch)
        self._s.seek(end)

    def _parse_track_entry(self, el: _Element) -> MkvTrack | None:
        end = el.payload_start + (el.size or 0)
        t = MkvTrack()
        ttype = 0
        while self._s.tell() < end:
            ch = self._read_element()
            if ch is None:
                break
            if ch.eid == _TRACK_NUMBER:
                t.number = self._read_uint(ch)
            elif ch.eid == _TRACK_TYPE:
                ttype = self._read_uint(ch)
            elif ch.eid == _CODEC_ID:
                t.codec_id = self._s.read(ch.size or 0).decode(
                    "ascii", "replace").rstrip("\0")
            elif ch.eid == _CODEC_PRIVATE:
                t.codec_private = self._s.read(ch.size or 0)
            elif ch.eid == _DEFAULT_DURATION:
                t.default_duration_ns = self._read_uint(ch)
            elif ch.eid == _VIDEO:
                self._parse_video(ch, t)
            else:
                self._skip(ch)
        self._s.seek(end)
        return t if ttype == 1 else None

    def _parse_video(self, el: _Element, t: MkvTrack) -> None:
        end = el.payload_start + (el.size or 0)
        while self._s.tell() < end:
            ch = self._read_element()
            if ch is None:
                break
            if ch.eid == _PIXEL_WIDTH:
                t.width = self._read_uint(ch)
            elif ch.eid == _PIXEL_HEIGHT:
                t.height = self._read_uint(ch)
            elif ch.eid == _COLOUR:
                self._parse_colour(ch, t)
            else:
                self._skip(ch)
        self._s.seek(end)

    def _parse_colour(self, el: _Element, t: MkvTrack) -> None:
        end = el.payload_start + (el.size or 0)
        while self._s.tell() < end:
            ch = self._read_element()
            if ch is None:
                break
            if ch.eid == _MATRIX:
                t.color_space = _MATRIX_NAMES.get(self._read_uint(ch))
            elif ch.eid == _RANGE:
                v = self._read_uint(ch)
                t.color_range = {1: "mpeg", 2: "jpeg"}.get(v)
            elif ch.eid == _TRC:
                t.color_trc = _TRC_NAMES.get(self._read_uint(ch))
            elif ch.eid == _PRIMARIES:
                t.color_primaries = _PRIM_NAMES.get(self._read_uint(ch))
            else:
                self._skip(ch)
        self._s.seek(end)

    # -- frames ------------------------------------------------------

    def rate(self) -> Fraction:
        t = self.track
        if t and t.default_duration_ns:
            return Fraction(1_000_000_000, t.default_duration_ns) \
                .limit_denominator(100_000)
        return Fraction(25)

    def read_packet(self, meta: bool = False):
        """Next (timestamp_ticks, frame bytes) of the video track, or
        (timestamp_ticks, offset, length) when ``meta`` (no payload
        read)."""
        while True:
            if self._pending is not None:
                el, self._pending = self._pending, None
            else:
                el = self._read_element()
            if el is None:
                return None
            if el.eid == _CLUSTER:
                self._cluster_end = (None if el.size is None
                                     else el.payload_start + el.size)
                continue
            if (self._cluster_end is not None
                    and el.payload_start > self._cluster_end):
                # shouldn't happen; resync by treating as top level
                pass
            if el.eid == _CLUSTER_TS:
                self._cluster_ts = self._read_uint(el)
                continue
            if el.eid == _BLOCK_GROUP:
                end = el.payload_start + (el.size or 0)
                got = None
                while self._s.tell() < end:
                    ch = self._read_element()
                    if ch is None:
                        break
                    if ch.eid == _BLOCK and got is None:
                        got = self._read_block(ch, meta=meta)
                    else:
                        self._skip(ch)
                self._s.seek(end)
                if got is not None:
                    return got
                continue
            if el.eid == _SIMPLE_BLOCK:
                got = self._read_block(el, meta=meta)
                if got is not None:
                    return got
                continue
            if el.size is None:
                raise ValueError("unknown-size element in stream body")
            self._skip(el)

    def _read_block(self, el: _Element, meta: bool = False):
        end = el.payload_start + (el.size or 0)
        # Block track numbers are plain data varints: the all-ones
        # "unknown size" reservation does NOT apply (track 127 codes
        # as 0xFF)
        tracknum = self._read_vint(keep_marker=False, sentinel=False)
        rel = int.from_bytes(self._s.read(2), "big", signed=True)
        flags = self._s.read(1)
        if tracknum is None or not flags:
            return None
        if self.track is not None and tracknum != self.track.number:
            self._s.seek(end)
            return None
        lacing = (flags[0] >> 1) & 3
        if lacing != 0:
            raise ValueError("matroska lacing is not supported for video")
        off = self._s.tell()
        if meta:
            self._s.seek(end)
            return self._cluster_ts + rel, off, end - off
        data = self._s.read(end - off)
        return self._cluster_ts + rel, data

    # (writer below)

    def scan_packets(self) -> list[tuple[int, int, int]]:
        """(timestamp_ticks, payload offset, length) of every video
        frame, recorded WITHOUT reading the payload bytes (headers-only
        walk — and the offsets stay correct when elements follow the
        Block inside a BlockGroup, e.g. ReferenceBlock on inter
        frames).  Consumes the stream body; seek back to replay."""
        out = []
        while True:
            got = self.read_packet(meta=True)
            if got is None:
                break
            out.append(got)
        return out


# ---------------------------------------------------------------------------
# muxer (FFV1 video track) — the zero-binary fallback for `.mkv`
# outputs when no ffmpeg exists; with a binary present the bridge
# handles mkv like the reference's libavformat would
# ---------------------------------------------------------------------------


def _enc_id(eid: int) -> bytes:
    out = []
    while eid:
        out.append(eid & 0xFF)
        eid >>= 8
    return bytes(reversed(out))


def _enc_size(n: int, length: int | None = None) -> bytes:
    """EBML size varint; fixed ``length`` pads for backpatching."""
    if length is None:
        length = 1
        while n >= (1 << (7 * length)) - 1 and length < 8:
            length += 1
    v = n | (1 << (7 * length))
    return v.to_bytes(length, "big")


def _el(eid: int, payload: bytes) -> bytes:
    return _enc_id(eid) + _enc_size(len(payload)) + payload


def _uint(v: int) -> bytes:
    n = max(1, (v.bit_length() + 7) // 8)
    return v.to_bytes(n, "big")


class MkvMuxer:
    """Matroska with one FFV1 video track; every frame a keyframe in
    its own cluster.  Seekable outputs backpatch the Segment size and
    Duration on close; pipes leave them unknown (valid per the spec's
    streaming form)."""

    def __init__(self, stream, width: int, height: int, rate: Fraction,
                 codec_private: bytes = b"", color_range: str | None = None,
                 color_space: str | None = None):
        self._s = stream
        self.rate = rate
        self.frame_index = 0
        self._wrote_header = False
        self._seg_size_pos: int | None = None
        self._dur_pos: int | None = None
        self._width, self._height = width, height
        self._csd = codec_private
        self._crange = color_range
        self._cspace = color_space

    def _header(self) -> None:
        s = self._s
        ebml = (_el(0x4286, _uint(1)) + _el(0x42F7, _uint(1))
                + _el(0x42F2, _uint(4)) + _el(0x42F3, _uint(8))
                + _el(0x4282, b"matroska") + _el(0x4287, _uint(4))
                + _el(0x4285, _uint(2)))
        s.write(_el(0x1A45DFA3, ebml))
        s.write(_enc_id(_SEGMENT))
        try:
            seekable = s.seekable()
        except AttributeError:
            seekable = False
        if seekable:
            self._seg_size_pos = s.tell()
        s.write(_enc_size((1 << 56) - 1, 8))  # unknown; backpatched
        self._seg_start = s.tell() if seekable else None
        # Info: 1 ms timestamp scale + muxer tags + Duration placeholder
        info = (_el(_TIMESTAMP_SCALE, _uint(1_000_000))
                + _el(0x4D80, b"dspfun-tpu") + _el(0x5741, b"dspfun-tpu"))
        import struct

        if seekable:
            dur = _enc_id(_DURATION) + _enc_size(8) + struct.pack(">d", 0.0)
            info_payload = info + dur
        else:
            info_payload = info
        info_el = _el(_INFO, info_payload)
        if seekable:
            # the Duration float sits at a fixed tail offset
            self._dur_pos = s.tell() + len(info_el) - 8
        s.write(info_el)
        # Tracks
        video = _el(_PIXEL_WIDTH, _uint(self._width)) + _el(
            _PIXEL_HEIGHT, _uint(self._height))
        colour = b""
        if self._crange:
            colour += _el(_RANGE, _uint(1 if self._crange == "mpeg" else 2))
        mat = {v: k for k, v in _MATRIX_NAMES.items()}.get(self._cspace)
        if mat is not None:
            colour += _el(_MATRIX, _uint(mat))
        if colour:
            video += _el(_COLOUR, colour)
        entry = (_el(_TRACK_NUMBER, _uint(1)) + _el(0x73C5, _uint(1))
                 + _el(_TRACK_TYPE, _uint(1))
                 + _el(0x9C, _uint(0))  # FlagLacing off
                 + _el(_CODEC_ID, b"V_FFV1"))
        if self._csd:
            entry += _el(_CODEC_PRIVATE, self._csd)
        entry += _el(_DEFAULT_DURATION,
                     _uint(round(1_000_000_000 * self.rate.denominator
                                 / self.rate.numerator)))
        entry += _el(_VIDEO, video)
        s.write(_el(_TRACKS, _el(_TRACK_ENTRY, entry)))

    def _ts_ms(self, index: int) -> int:
        return round(index * 1000 * self.rate.denominator
                     / self.rate.numerator)

    def write_frame_bytes(self, data: bytes) -> None:
        if not self._wrote_header:
            self._header()
            self._wrote_header = True
        ts = self._ts_ms(self.frame_index)
        block = (_enc_size(1)            # track number vint
                 + (0).to_bytes(2, "big", signed=True)  # relative ts
                 + bytes([0x80])         # keyframe flag
                 + data)
        cluster = _el(_CLUSTER_TS, _uint(ts)) + _el(_SIMPLE_BLOCK, block)
        self._s.write(_el(_CLUSTER, cluster))
        self.frame_index += 1

    def finalize(self) -> None:
        if not self._wrote_header:
            self._header()
            self._wrote_header = True
        if self._seg_size_pos is None:
            return
        import struct

        s = self._s
        end = s.tell()
        s.seek(self._seg_size_pos)
        s.write(_enc_size(end - self._seg_start, 8))
        if self._dur_pos is not None:
            s.seek(self._dur_pos)
            s.write(struct.pack(
                ">d", float(self._ts_ms(self.frame_index - 1)
                            + self._ts_ms(1)) if self.frame_index else 0.0))
        s.seek(end)
