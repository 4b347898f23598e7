"""Native NUT container (a copy of ``dspfun_tpu/io/nut.py``; FFV1 or
rawvideo payloads).

The reference's default motion output is FFV1-in-NUT
(reference motion/motion.c:447 via ffapi_open_output's format guess);
this environment has no FFmpeg, so the framework carries a native NUT
muxer/demuxer per the published NUT spec (nut.txt) so the reference's
default `.nut` paths open and write with zero external binaries
(VERDICT r3 item 4).  Payloads are rawvideo planes (the bitstream the
fvid path negotiates); genuinely foreign codecs still route to the
ffmpeg-binary bridge (which the port does not have yet).
tests/test_torch_nut.py holds the copy to its original byte for byte.

Spec structures implemented: file_id_string, v/s/vb value coding,
packet headers/footers with the NUT CRC32 (poly 0x104C11DB7, init 0,
MSB-first), main header with the generic 256-entry framecode table and
header-elision list, stream headers (video class, fourcc + width/
height/aspect/colorspace), info packets (used to round-trip the full
ColorProps set), per-frame syncpoints, and frame coding with
coded_pts/size_msb/header-CRC.  Frame payload bytes are NOT checksummed
(the frame CRC covers the frame *header*, as in the spec), so the muxer
adds no per-byte cost over fvid beyond the tiny headers.

Pixel formats with a well-known NUT/AVI fourcc (I420/422P/444P/Y800)
use it; everything else (notably float planar) uses the fourcc "DSPF"
with the pixel-format name in codec_specific_data — self-describing
for this demuxer, and honestly marked experimental for foreign ones.
"""

from __future__ import annotations

import os
import sys
from fractions import Fraction

import numpy as np

__all__ = ["NutReader", "NutWriter", "FILE_ID"]

FILE_ID = b"nut/multimedia container\0"

MAIN_STARTCODE = 0x4E4D7A561F5F04AD
STREAM_STARTCODE = 0x4E5311405BF2F9DB
SYNCPOINT_STARTCODE = 0x4E4BE4ADEECA4569
INDEX_STARTCODE = 0x4E58DD672F23E64E
INFO_STARTCODE = 0x4E49AB68B596BA78
_STARTCODES = {MAIN_STARTCODE, STREAM_STARTCODE, SYNCPOINT_STARTCODE,
               INDEX_STARTCODE, INFO_STARTCODE}

FLAG_KEY = 1
FLAG_EOR = 2
FLAG_CODED_PTS = 8
FLAG_STREAM_ID = 16
FLAG_SIZE_MSB = 32
FLAG_CHECKSUM = 64
FLAG_RESERVED = 128
FLAG_SM_DATA = 256
FLAG_HEADER_IDX = 1024
FLAG_MATCH_TIME = 2048
FLAG_CODED = 4096
FLAG_INVALID = 8192

MSB_PTS_SHIFT = 7

# fourccs shared with ffmpeg's nut raw tags where well-known; DSPF =
# pixel-format name carried in codec_specific_data
_KNOWN_TAGS = {
    "yuv420p": b"I420",
    "yuv422p": b"422P",
    "yuv444p": b"444P",
    "gray": b"Y800",
}
_TAG_TO_FMT = {v: k for k, v in _KNOWN_TAGS.items()}
_TAG_TO_FMT[b"YV12"] = "yuv420p"
_TAG_TO_FMT[b"GREY"] = "gray"


# ---------------------------------------------------------------------------
# NUT CRC32: polynomial 0x104C11DB7, MSB-first, init 0, no final xor
# ---------------------------------------------------------------------------

def _make_crc_table():
    tab = np.zeros(256, np.uint32)
    for i in range(256):
        c = i << 24
        for _ in range(8):
            c = ((c << 1) ^ 0x04C11DB7) if c & 0x80000000 else (c << 1)
            c &= 0xFFFFFFFF
        tab[i] = c
    return tab


_CRC_TABLE = _make_crc_table()


def crc32_nut(data: bytes, crc: int = 0) -> int:
    tab = _CRC_TABLE
    for b in data:
        crc = ((crc << 8) & 0xFFFFFFFF) ^ int(tab[((crc >> 24) ^ b) & 0xFF])
    return crc


# ---------------------------------------------------------------------------
# value coding
# ---------------------------------------------------------------------------

def put_v(buf: bytearray, value: int) -> None:
    if value < 0:
        raise ValueError("v values are unsigned")
    out = [value & 0x7F]
    value >>= 7
    while value:
        out.append(0x80 | (value & 0x7F))
        value >>= 7
    buf.extend(reversed(out))


def put_s(buf: bytearray, value: int) -> None:
    # inverse of get_s: 0->0, n>0 -> 2n-1, n<0 -> -2n
    temp = (-2 * value) if value < 0 else (2 * value - 1 if value else 0)
    put_v(buf, temp)


def put_vb(buf: bytearray, data: bytes) -> None:
    put_v(buf, len(data))
    buf.extend(data)


class _Damaged(ValueError):
    """Parse failure whose ``consumed`` bytes were read *past* the
    point of damage and may contain later syncpoints (a corrupted
    length field over-consumes).  The reader pushes them back before
    resyncing so only the genuinely damaged region is lost."""

    def __init__(self, msg: str, consumed: bytes = b""):
        super().__init__(msg)
        self.consumed = consumed


# Plausibility caps so a corrupted varint length cannot trigger a
# giant read()/allocation before its checksum gets a chance to fail:
# non-frame packets (headers/syncpoints/info/index) stay tiny-to-MBs,
# frame payloads are bounded by raw 8K float video.
_MAX_PACKET = 1 << 26
_MAX_FRAME = 1 << 30


class _Parser:
    """Byte cursor over a packet payload."""

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def get_v(self) -> int:
        v = 0
        while True:
            if self.pos >= len(self.data):
                raise ValueError("truncated NUT value")
            b = self.data[self.pos]
            self.pos += 1
            v = (v << 7) | (b & 0x7F)
            if not b & 0x80:
                return v

    def get_s(self) -> int:
        temp = self.get_v() + 1
        return -(temp >> 1) if temp & 1 else (temp >> 1)

    def get_vb(self) -> bytes:
        n = self.get_v()
        out = self.data[self.pos:self.pos + n]
        if len(out) < n:
            raise ValueError("truncated NUT vb")
        self.pos += n
        return out

    def remaining(self) -> int:
        return len(self.data) - self.pos


# ---------------------------------------------------------------------------
# packets
# ---------------------------------------------------------------------------

def _write_packet(stream, startcode: int, payload: bytes) -> None:
    """startcode, forward_ptr, [header_checksum], payload, checksum."""
    head = bytearray(startcode.to_bytes(8, "big"))
    fwd = bytearray()
    put_v(fwd, len(payload) + 4)  # payload + footer checksum
    head.extend(fwd)
    if len(payload) + 4 > 4096:
        head.extend(crc32_nut(bytes(head)).to_bytes(4, "big"))
    stream.write(bytes(head))
    stream.write(payload)
    stream.write(crc32_nut(payload).to_bytes(4, "big"))


def _read_packet(stream, startcode_tail: bytes) -> bytes:
    """Called with the 8 startcode bytes consumed; returns payload.
    Failures raise ``_Damaged`` carrying every byte read here (they
    may hold good syncpoints when the forward_ptr was the damage)."""
    consumed = bytearray()

    def rd(n):
        out = stream.read(n)
        consumed.extend(out)
        return out

    v = 0
    while True:
        b = rd(1)
        if not b:
            raise _Damaged("truncated NUT packet header", bytes(consumed))
        v = (v << 7) | (b[0] & 0x7F)
        if not b[0] & 0x80:
            break
    if v < 4 or v - 4 > _MAX_PACKET:
        raise _Damaged("bad NUT forward_ptr", bytes(consumed))
    if v > 4096:
        rd(4)  # header_checksum (not verified on read)
    payload = rd(v - 4)
    check = rd(4)
    if len(payload) < v - 4 or len(check) < 4:
        raise _Damaged("truncated NUT packet", bytes(consumed))
    if int.from_bytes(check, "big") != crc32_nut(payload):
        raise _Damaged("NUT packet checksum mismatch", bytes(consumed))
    return payload


# ---------------------------------------------------------------------------
# writer
# ---------------------------------------------------------------------------

_COLORSPACE_TYPES = {
    (None, None): 0,
    ("smpte170m", "mpeg"): 1, ("bt470bg", "mpeg"): 1,
    ("bt709", "mpeg"): 2,
    ("smpte170m", "jpeg"): 17, ("bt470bg", "jpeg"): 17,
    ("bt709", "jpeg"): 18,
}


def _frame_table_payload() -> list[tuple[int, dict]]:
    """(tmp_flag, fields) entries covering the 256 framecodes:
    framecode 1 = stream-0 keyframes (coded pts, msb size, header
    CRC); framecode 2 = the same with an explicit stream_id field
    (secondary streams, e.g. future audio — the demuxer skips them for
    video reads); everything else invalid."""
    frame_flags = (FLAG_KEY | FLAG_CODED_PTS | FLAG_SIZE_MSB | FLAG_CHECKSUM)
    return [
        (FLAG_INVALID, {"count": 1}),                  # framecode 0
        (frame_flags, {"count": 1}),                   # framecode 1
        (frame_flags | FLAG_STREAM_ID, {"count": 1}),  # framecode 2
        # 3..255: 'N' (0x4E) is reserved and consumes NO count per the
        # spec's table-filling loop — 252 entries, not 253 (ffmpeg's
        # decode_main_header rejects count > 256 - (i <= 'N') - i, so
        # 253 made every written file unreadable by libavformat)
        (FLAG_INVALID, {"count": 252}),
    ]


class NutWriter:
    """Mux rawvideo frames into NUT; one syncpoint per frame (every
    frame is a keyframe)."""

    def __init__(self, stream, width: int, height: int, rate: Fraction,
                 pix_fmt, props, start_index: int = 0,
                 codec: str = "rawvideo", codec_private: bytes = b""):
        self._stream = stream
        self._codec_private = codec_private
        self.width, self.height = width, height
        self.rate = rate
        self.pix_fmt = pix_fmt
        self.props = props
        self.codec = codec  # "rawvideo" | "ffv1" (native, io/ffv1.py)
        self.frame_index = start_index
        self._header_written = start_index > 0  # append mode
        # syncpoint byte positions for the EOF index packet (seekable
        # fresh files only; appended runs skip the index — the
        # prior run's syncpoint positions are unknown)
        self._sync_positions: list[int] = []
        self._appending = start_index > 0

    def write_header(self) -> None:
        s = self._stream
        s.write(FILE_ID)
        # --- main header -------------------------------------------------
        b = bytearray()
        put_v(b, 3)                 # version
        put_v(b, 1)                 # stream_count
        put_v(b, 65536)             # max_distance
        put_v(b, 1)                 # time_base_count
        put_v(b, self.rate.denominator)   # time_base_nom
        put_v(b, self.rate.numerator)     # time_base_denom (tb = 1/rate s)
        for tmp_flag, extra in _frame_table_payload():
            put_v(b, tmp_flag)
            put_v(b, 6)             # tmp_fields
            put_s(b, 0)             # tmp_pts
            put_v(b, 1)             # tmp_mul
            put_v(b, 0)             # tmp_stream
            put_v(b, 0)             # tmp_size
            put_v(b, 0)             # tmp_res
            put_v(b, extra["count"])
        # header_count_minus1 + elision list: REQUIRED after the frame
        # table — libavformat reads it unconditionally, and without it
        # header_count parses from stray bytes and every frame fails
        # the header_idx validity check (found with a real libavformat
        # via cv2; tests/test_interop_cv2.py)
        put_v(b, 0)
        _write_packet(s, MAIN_STARTCODE, bytes(b))
        # --- stream header ----------------------------------------------
        b = bytearray()
        put_v(b, 0)                 # stream_id
        put_v(b, 0)                 # stream_class: video
        name = self.pix_fmt.name
        if self.codec == "ffv1":
            # ffmpeg's NUT tag for FFV1; v1 carries its parameter set
            # in every keyframe (empty codec_specific_data), v3 rides
            # its extradata here (reference: libavformat nutenc writes
            # AVCodecParameters.extradata the same way)
            tag, csd = b"FFV1", self._codec_private
        else:
            tag = _KNOWN_TAGS.get(name)
            csd = b""
            if tag is None:
                tag, csd = b"DSPF", name.encode("ascii")
        put_vb(b, tag)              # fourcc
        put_v(b, 0)                 # time_base_id
        put_v(b, MSB_PTS_SHIFT)     # msb_pts_shift
        put_v(b, 1)                 # max_pts_distance
        put_v(b, 0)                 # decode_delay
        put_v(b, 0)                 # stream_flags
        put_vb(b, csd)              # codec_specific_data
        put_v(b, self.width)
        put_v(b, self.height)
        # pixel aspect (0/0 = unknown, per nut.txt)
        sw = sh = 0
        sar = getattr(self.props, "sample_aspect", None)
        if sar:
            num, _, den = sar.partition(":")
            if num.isdigit() and den.isdigit() and int(den):
                sw, sh = int(num), int(den)
        put_v(b, sw)                # sample_width
        put_v(b, sh)                # sample_height
        cs = _COLORSPACE_TYPES.get(
            (self.props.color_space, self.props.color_range), 0)
        put_v(b, cs)                # colorspace_type
        _write_packet(s, STREAM_STARTCODE, bytes(b))
        # --- info packet: full color-property round trip ------------------
        pairs = [(k, v) for k, v in (
            ("X-dspfun-color_range", self.props.color_range),
            ("X-dspfun-color_primaries", self.props.color_primaries),
            ("X-dspfun-color_trc", self.props.color_trc),
            ("X-dspfun-color_space", self.props.color_space),
            ("X-dspfun-chroma_location", self.props.chroma_location),
            ("X-dspfun-rate",
             f"{self.rate.numerator}/{self.rate.denominator}"),
        ) if v]
        b = bytearray()
        put_v(b, 1)                 # stream_id_plus1 (stream 0)
        put_s(b, 0)                 # chapter_id
        put_v(b, 0)                 # chapter_start (tt)
        put_v(b, 0)                 # chapter_len
        put_v(b, len(pairs))
        for k, v in pairs:
            put_vb(b, k.encode("ascii"))
            put_s(b, -1)            # value type: string
            put_vb(b, v.encode("ascii"))
        _write_packet(s, INFO_STARTCODE, bytes(b))

    def write_frame_bytes(self, data: bytes) -> None:
        if not self._header_written:
            self.write_header()
            self._header_written = True
        s = self._stream
        pts = self.frame_index
        # syncpoint (one per frame; every frame is a key frame)
        try:
            if s.seekable():
                self._sync_positions.append(s.tell())
        except (AttributeError, OSError):
            pass
        b = bytearray()
        put_v(b, pts * 1 + 0)       # global_key_pts in tt coding
        put_v(b, 0)                 # back_ptr_div16 (all-intra)
        _write_packet(s, SYNCPOINT_STARTCODE, bytes(b))
        # frame
        hdr = bytearray([1])        # framecode 1
        put_v(hdr, pts + (1 << MSB_PTS_SHIFT))   # coded_pts (full pts)
        put_v(hdr, len(data))       # data_size_msb (mul=1, lsb=0)
        hdr.extend(crc32_nut(bytes(hdr)).to_bytes(4, "big"))
        s.write(bytes(hdr))
        s.write(data)
        self.frame_index += 1

    def write_index(self) -> None:
        """EOF index packet (nut.txt): syncpoint positions div16 +
        per-stream keyframe runs + the trailing index_ptr, so
        libavformat gets exact duration/seeking instead of the
        read_timestamp fallback (validated against a real libavformat
        via cv2 — tests/test_interop_cv2.py).  Skipped for pipes,
        appended runs, and empty streams."""
        if self._appending or not self._sync_positions:
            return
        s = self._stream
        n = len(self._sync_positions)
        b = bytearray()
        put_v(b, self.frame_index * 1 + 0)  # max_pts in tt coding
        put_v(b, n)
        last = 0
        for pos in self._sync_positions:
            put_v(b, pos // 16 - last)      # delta-coded positions
            last = pos // 16
        # stream 0 keyframe bitmap, run-coded (type=1, flag=0): slot 0
        # means "keyframe before the first syncpoint" and must be 0
        # (libavformat rejects the index otherwise); the remaining
        # slots stay 0 too — per-keyframe pts entries are redundant
        # when every frame is a keyframe, and libavformat then seeks
        # by syncpoint search (exact, as every syncpoint is a seek
        # point here).  The trailing !flag run terminator lands in the
        # parser's sentinel slot and is never consumed.
        put_v(b, (n << 2) | 1)
        # index_ptr: byte length of the whole index packet (startcode
        # to EOF); the u64 sits inside the payload so sizes are stable
        fwd = bytearray()
        put_v(fwd, len(b) + 8 + 4)          # payload + index_ptr + crc
        total = 8 + len(fwd) + len(b) + 8 + 4
        payload = bytes(b) + total.to_bytes(8, "big")
        _write_packet(s, INDEX_STARTCODE, payload)


# ---------------------------------------------------------------------------
# reader
# ---------------------------------------------------------------------------

class NutParseState:
    """Decoded main/stream headers + framecode table."""

    def __init__(self):
        self.time_bases: list[Fraction] = []
        self.flags = [FLAG_INVALID] * 256
        self.pts_delta = [0] * 256
        self.data_size_mul = [1] * 256
        self.data_size_lsb = [0] * 256
        self.stream_id = [0] * 256
        self.reserved_count = [0] * 256
        self.elision = [b""]
        self.max_distance = 65536
        self.streams: list[dict] = []
        self.info: dict[str, str] = {}
        self.last_pts: dict[int, int] = {}   # per-stream pts prediction
        self.sync_pts = 0                     # reset value at syncpoints
        self.last_payload = (0, 0, 0)

    # -- header parsing ---------------------------------------------------

    def parse_main(self, payload: bytes) -> None:
        p = _Parser(payload)
        version = p.get_v()
        if version < 2 or version > 4:
            raise ValueError(f"unsupported NUT version {version}")
        if version > 3:
            p.get_v()  # minor_version
        p.get_v()      # stream_count
        self.max_distance = p.get_v()
        tb_count = p.get_v()
        self.time_bases = []
        for _ in range(tb_count):
            nom = p.get_v()
            den = p.get_v()
            self.time_bases.append(Fraction(nom, max(den, 1)))
        tmp_pts, tmp_mul, tmp_stream, tmp_size, tmp_res = 0, 1, 0, 0, 0
        i = 0
        while i < 256:
            tmp_flag = p.get_v()
            tmp_fields = p.get_v()
            if tmp_fields > 0:
                tmp_pts = p.get_s()
            if tmp_fields > 1:
                tmp_mul = p.get_v()
            if tmp_fields > 2:
                tmp_stream = p.get_v()
            tmp_size = p.get_v() if tmp_fields > 3 else 0
            tmp_res = p.get_v() if tmp_fields > 4 else 0
            count = p.get_v() if tmp_fields > 5 else max(tmp_mul - tmp_size, 0)
            for _ in range(6, tmp_fields):
                p.get_v()  # forward compat: ignore extra fields
            j = 0
            while j < count and i < 256:
                if i == ord("N"):
                    self.flags[i] = FLAG_INVALID
                    i += 1
                    continue
                self.flags[i] = tmp_flag
                self.pts_delta[i] = tmp_pts
                self.data_size_mul[i] = tmp_mul
                self.stream_id[i] = tmp_stream
                self.data_size_lsb[i] = tmp_size + j
                self.reserved_count[i] = tmp_res
                i += 1
                j += 1
        # header elision list (present when bytes remain)
        self.elision = [b""]
        if p.remaining() > 4:
            hcount = p.get_v()
            for _ in range(hcount):
                self.elision.append(p.get_vb())
        # version >= 4: main_flags — ignored

    def parse_stream(self, payload: bytes) -> None:
        p = _Parser(payload)
        st = {"id": p.get_v(), "class": p.get_v(), "fourcc": p.get_vb()}
        st["time_base_id"] = p.get_v()
        st["msb_pts_shift"] = p.get_v()
        st["max_pts_distance"] = p.get_v()
        st["decode_delay"] = p.get_v()
        st["flags"] = p.get_v()
        st["codec_specific"] = p.get_vb()
        if st["class"] == 0:
            st["width"] = p.get_v()
            st["height"] = p.get_v()
            st["sample_width"] = p.get_v()
            st["sample_height"] = p.get_v()
            st["colorspace_type"] = p.get_v()
        self.streams.append(st)

    def parse_info(self, payload: bytes) -> None:
        p = _Parser(payload)
        p.get_v()      # stream_id_plus1
        p.get_s()      # chapter_id
        p.get_v()      # chapter_start
        p.get_v()      # chapter_len
        count = p.get_v()
        for _ in range(count):
            name = p.get_vb().decode("ascii", "replace")
            vtype = p.get_s()
            if vtype == -1:
                self.info[name] = p.get_vb().decode("ascii", "replace")
            elif vtype == -2:
                p.get_vb()
                p.get_vb()
            elif vtype == -3:
                p.get_s()
            elif vtype == -4:
                p.get_v()  # tt
            elif vtype < -4:
                p.get_s()  # rational denominator; value was vtype? skip
            else:
                pass       # plain integer carried in vtype itself

    # -- frame parsing ----------------------------------------------------

    def parse_frame_header(self, stream, framecode: int,
                           skip_data: bool = False, end: int | None = None):
        """Returns (stream_id, pts, data) or raises; ``skip_data``
        seeks past the payload (frame counting; ``end`` is the
        caller's cached end-of-file offset — computed here with two
        extra seeks per frame otherwise)."""
        flags = self.flags[framecode]
        if flags & FLAG_INVALID:
            raise ValueError(f"invalid NUT framecode {framecode}")
        hdr_bytes = bytearray([framecode])

        def get_v():
            v = 0
            while True:
                b = stream.read(1)
                if not b:
                    raise _Damaged("truncated NUT frame header",
                                   bytes(hdr_bytes[1:]))
                hdr_bytes.append(b[0])
                v = (v << 7) | (b[0] & 0x7F)
                if not b[0] & 0x80:
                    return v

        if flags & FLAG_CODED:
            flags ^= get_v()
        sid = self.stream_id[framecode]
        if flags & FLAG_STREAM_ID:
            sid = get_v()
        prev = self.last_pts.get(sid, self.sync_pts)
        if flags & FLAG_CODED_PTS:
            coded = get_v()
            # per-STREAM shift and prediction (the spec's pts model);
            # one shared prediction decoded interleaved audio pts into
            # the video stream's timeline
            shift = (self.streams[sid]["msb_pts_shift"]
                     if sid < len(self.streams) else MSB_PTS_SHIFT)
            if coded < (1 << shift):
                mask = (1 << shift) - 1
                delta = prev - mask // 2
                pts = ((coded - delta) & mask) + delta
            else:
                pts = coded - (1 << shift)
        else:
            pts = prev + self.pts_delta[framecode]
        if flags & FLAG_MATCH_TIME:
            get_v()  # match_time_delta (s coded; consumed as v is wrong —
            #          but only ever present with FLAG_CODED streams we
            #          do not write; tolerated for robustness)
        hidx = 0
        if flags & FLAG_HEADER_IDX:
            hidx = get_v()
        size = self.data_size_lsb[framecode]
        if flags & FLAG_SIZE_MSB:
            size = get_v() * self.data_size_mul[framecode] \
                + self.data_size_lsb[framecode]
        if flags & FLAG_RESERVED:
            for _ in range(get_v()):
                get_v()
        else:
            for _ in range(self.reserved_count[framecode]):
                get_v()
        if flags & FLAG_CHECKSUM:
            check = stream.read(4)
            if int.from_bytes(check, "big") != crc32_nut(bytes(hdr_bytes)):
                raise _Damaged("NUT frame header checksum mismatch",
                               bytes(hdr_bytes[1:]) + check)
        if flags & FLAG_SM_DATA:
            raise _Damaged("NUT side/meta data frames are not supported",
                           bytes(hdr_bytes[1:]))
        head = self.elision[hidx] if hidx < len(self.elision) else b""
        nbytes = size - len(head)
        if nbytes < 0 or nbytes > _MAX_FRAME:
            raise _Damaged("implausible NUT frame size")
        self.last_pts[sid] = pts
        if skip_data:
            # (payload offset, raw byte count, elided head bytes) for
            # the native indexed reader's offset scan.  Validate the
            # payload is actually present before seeking past it — a
            # truncated final frame must count the same as a resynced
            # read would deliver (i.e. not at all).
            off = stream.tell()
            if end is None:
                end = stream.seek(0, os.SEEK_END)
                stream.seek(off)
            if off + nbytes > end:
                raise _Damaged("truncated NUT frame")
            self.last_payload = (off, nbytes, len(head))
            stream.seek(off + nbytes)
            return sid, pts, b""
        data = stream.read(nbytes)
        if len(data) < nbytes:
            raise _Damaged("truncated NUT frame", data)
        return sid, pts, head + data


class _PushbackStream:
    """Minimal pushback wrapper so the reader can re-deliver bytes
    found by a resync scan; tell/seek account for the buffered bytes
    (seek is only ever used on seekable files — count/offset scans
    guard on seekable())."""

    def __init__(self, s):
        self._s = s
        self._buf = b""

    def read(self, n=-1):
        if not self._buf:
            return self._s.read(n)
        if n is None or n < 0:
            out = self._buf + (self._s.read(n) or b"")
            self._buf = b""
            return out
        out, self._buf = self._buf[:n], self._buf[n:]
        if len(out) < n:
            out += self._s.read(n - len(out)) or b""
        return out

    def push(self, data: bytes) -> None:
        self._buf = data + self._buf

    def seekable(self):
        return self._s.seekable()

    def tell(self):
        return self._s.tell() - len(self._buf)

    def seek(self, pos, whence=0):
        if whence == os.SEEK_CUR:
            pos, whence = self.tell() + pos, 0
        self._buf = b""
        return self._s.seek(pos, whence)


class NutReader:
    """Demux NUT; yields raw frame payload bytes for stream 0.

    Damaged packets (bad startcode/framecode, checksum mismatch,
    truncated header) resync at the next syncpoint startcode — the
    spec's recovery procedure, also what libavformat's demuxer does —
    losing only the frames between the damage and the syncpoint
    (``damaged`` counts recoveries)."""

    def __init__(self, stream):
        self._stream = _PushbackStream(stream)
        self.state = NutParseState()
        self.damaged = 0
        magic = self._stream.read(len(FILE_ID))
        if magic != FILE_ID:
            raise ValueError("not a NUT stream")
        # read packets up to the first frame; its framecode byte is
        # held pending so header metadata is complete after __init__
        self._pending: int | None = self._read_until_frame(
            parse_only_headers=True)

    def _read_until_frame(self, parse_only_headers=False):
        """Advance to the next frame; returns its framecode or None at
        EOF.  Syncpoints/info/index packets are parsed in stride."""
        st = self.state
        while True:
            b = self._stream.read(1)
            if not b:
                return None
            if b[0] == ord("N"):
                tail = self._stream.read(7)
                if len(tail) < 7:
                    return None
                code = int.from_bytes(b + tail, "big")
                if code not in _STARTCODES:
                    raise _Damaged(f"bad NUT startcode {code:#x}", tail)
                payload = _read_packet(self._stream, tail)
                if code == MAIN_STARTCODE:
                    st.parse_main(payload)
                elif code == STREAM_STARTCODE:
                    st.parse_stream(payload)
                elif code == INFO_STARTCODE:
                    st.parse_info(payload)
                elif code == SYNCPOINT_STARTCODE:
                    # reset pts prediction per spec
                    p = _Parser(payload)
                    tt = p.get_v()
                    nb = max(len(st.time_bases), 1)
                    # reset every stream's pts prediction to the
                    # syncpoint's global pts (single shared timebase
                    # in our files; foreign multi-timebase streams are
                    # approximated by the same value)
                    st.sync_pts = tt // nb
                    st.last_pts = {}
                # index: ignored
                continue
            if parse_only_headers and not st.streams:
                raise ValueError("NUT frame before stream header")
            return b[0]

    def _resync(self, exc: ValueError | None = None) -> bool:
        """Scan forward for the next syncpoint startcode and re-deliver
        from it; False at EOF.  Bytes a failed parse consumed past the
        damage (``_Damaged.consumed`` — e.g. a corrupted length field
        slurping good syncpoints) are pushed back first so the scan
        covers them.  Every parse failure still nets at least one byte
        of progress past the pattern it failed on (the startcode /
        framecode byte is never pushed back), so repeated damage
        always advances."""
        consumed = getattr(exc, "consumed", b"")
        if consumed:
            self._stream.push(consumed)
        pat = SYNCPOINT_STARTCODE.to_bytes(8, "big")
        window = b""
        while True:
            chunk = self._stream.read(65536)
            if not chunk:
                return False
            buf = window + chunk
            i = buf.find(pat)
            if i >= 0:
                self._stream.push(buf[i:])
                return True
            window = buf[-7:]

    def read_frame_bytes(self, stream_id: int = 0) -> tuple[int, bytes] | None:
        """Next frame of ``stream_id`` (frames of other streams — e.g.
        audio in an ffmpeg-muxed file — are skipped)."""
        while True:
            try:
                fc = self._pending
                self._pending = None
                if fc is None:
                    fc = self._read_until_frame()
                if fc is None:
                    return None
                sid, pts, data = self.state.parse_frame_header(
                    self._stream, fc)
            except ValueError as e:
                self.damaged += 1
                if self.damaged == 1:
                    print("nut: damaged packet, resyncing at next "
                          "syncpoint", file=sys.stderr)
                if not self._resync(e):
                    return None
                continue
            if sid == stream_id:
                return pts, data

    def scan_payload_offsets(self, expect_size: int) -> list[int] | None:
        """Absolute file offsets of every frame's raw payload (for the
        native indexed reader, native/dspio.cpp dspio_open_indexed), or
        None when the stream is not seekable / uses header elision /
        has irregular payload sizes.  Restores the read position."""
        s = self._stream
        if not s.seekable():
            return None
        pos = s.tell()
        pending = self._pending
        last_pts = dict(self.state.last_pts)
        sync_pts = self.state.sync_pts
        end = s.seek(0, os.SEEK_END)
        s.seek(pos)
        offs: list[int] | None = []
        try:
            fc = pending
            while True:
                if fc is None:
                    fc = self._read_until_frame()
                if fc is None:
                    break
                sid, _, _ = self.state.parse_frame_header(
                    s, fc, skip_data=True, end=end)
                fc = None
                if sid != 0:
                    continue
                off, nbytes, head_len = self.state.last_payload
                # elided head bytes or irregular sizes make a raw pread
                # differ from the logical payload — bail to Python
                if head_len != 0 or nbytes != expect_size:
                    offs = None
                    break
                offs.append(off)
        except ValueError:
            offs = None
        finally:
            s.seek(pos)
            self._pending = pending
            self.state.last_pts = last_pts
            self.state.sync_pts = sync_pts
        return offs

    def count_frames(self) -> int | None:
        """Scan the remaining stream counting frames (seek past the
        payloads), then restore the position.  None if not seekable."""
        s = self._stream
        if not s.seekable():
            return None
        pos = s.tell()
        pending = self._pending
        last_pts = dict(self.state.last_pts)
        sync_pts = self.state.sync_pts
        end = s.seek(0, os.SEEK_END)
        s.seek(pos)
        n = 0
        try:
            fc = pending
            while True:
                try:
                    if fc is None:
                        fc = self._read_until_frame()
                    if fc is None:
                        break
                    sid, _, _ = self.state.parse_frame_header(
                        s, fc, skip_data=True, end=end)
                except ValueError as e:
                    # damaged packet: count what a resynced read would
                    # deliver
                    fc = None
                    if self._resync(e):
                        continue
                    break
                if sid == 0:
                    n += 1
                fc = None
        finally:
            s.seek(pos)
            self._pending = pending
            self.state.last_pts = last_pts
            self.state.sync_pts = sync_pts
        return n
