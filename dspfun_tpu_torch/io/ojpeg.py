"""Old-style JPEG TIFF (compression 6) as libtiff's tif_ojpeg.c hands it
to libjpeg and Pillow reads it: no Pillow, no libtiff.

libtiff rebuilds one JPEG stream for the whole image and decodes it in
one libjpeg session across the strips:

* the header comes from the bytes at JPEGInterchangeFormat (513, its
  length 514), or from the first strip where there is none, read marker
  by marker up to the scan header (SOI, APPn and COM skipped; DQT, DHT,
  DRI, SOF0, SOF1, SOS kept); where no frame header comes before the
  data, one is made from the tags: JPEGQTables (519), JPEGDCTables (520)
  and JPEGACTables (521), one offset per component (a repeated offset
  shares the table), component IDs 0, 1, 2, the YCbCrSubsampling tag's
  sampling on the first component, the image's size, one interleaved
  scan;
* the entropy-coded data is what follows the scan header, then each
  strip's bytes, with a restart marker put between strips; several
  strips make each one a restart interval (MCUs in a row times the
  strip's rows of MCUs), unless the stream's own DRI says otherwise;
* the YCbCrSubsampling tag is corrected from the frame's sampling
  (libtiff's OJPEGSubsamplingCorrect), and only a YCbCr file (photometric
  6, or RGB or none, which libtiff reads as YCbCr) of three samples is
  subsampled.

libtiff asks libjpeg for raw data: each component's islow IDCT at its
own resolution, no upsampling and no colour conversion.  A YCbCr file
then goes through libtiff's ``TIFFRGBAImage`` (Pillow's reader of
YCbCr): each sample's chroma repeated over its block, converted by
``TIFFYCbCrtoRGB`` with the file's YCbCrCoefficients and
ReferenceBlackWhite (``imgcodecs._ycbcr_rgb``).  A file of one sample is
read as stored, as Pillow's mode ``L``.

What libtiff refuses raises: a frame of other than 8-bit samples or of
another component count, a width other than the image's, tables missing
or unreadable, an unknown marker in the header, SamplesPerPixel other
than 1 or 3, strips whose height is not a whole number of MCU rows.
Tiled and planar files, the lossless process, a frame whose sampling
libtiff hands to libjpeg to upsample, a big-endian file in several
strips (whose later strips Pillow's libtiff reads to other pixels than
the stream's, most rows garbage) and restart-marked data that starts the
stream again after a JPEGInterchangeFormatLength cut short (read
otherwise from the first row) are not carried: no cause was found for
either reading (ROADMAP queue 1, item 8c).  tests/test_torch_tiff_ojpeg.py holds all of it to Pillow.
"""

from __future__ import annotations

import struct

import numpy as np

from dspfun_tpu_torch.io import jpeg as _jpeg

__all__ = ["decode_ojpeg"]

_APPS = frozenset([0xFE] + list(range(0xE0, 0xF0)))     # COM and APP0-APP15


class _Bytes:
    """The bytes tif_ojpeg.c's header reader takes in turn: those at
    JPEGInterchangeFormat, then every strip's (OJPEGReadBufferFill)."""

    def __init__(self, parts: list[bytes]):
        self.data = b"".join(parts)
        self.pos = 0

    def byte(self) -> int:
        if self.pos >= len(self.data):
            raise ValueError("old-style JPEG TIFF: the data ends inside the JPEG header "
                             "(libtiff fails)")
        self.pos += 1
        return self.data[self.pos - 1]

    def word(self) -> int:
        return self.byte() << 8 | self.byte()

    def block(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("old-style JPEG TIFF: the data ends inside the JPEG header "
                             "(libtiff fails)")
        self.pos += n
        return self.data[self.pos - n:self.pos]


def _segment(code: int, body: bytes) -> bytes:
    return bytes([0xFF, code]) + struct.pack(">H", len(body) + 2) + body


def _corrupt(what: str) -> ValueError:
    return ValueError(f"old-style JPEG TIFF: {what} (libtiff fails)")


class _Header:
    """The stream's tables, frame and scan as OJPEGReadHeaderInfoSec keeps
    them."""

    def __init__(self):
        self.q: dict[int, bytes] = {}       # id -> DQT body (its 65 bytes)
        self.dc: dict[int, bytes] = {}      # id -> DHT body
        self.ac: dict[int, bytes] = {}
        self.restart: int | None = None     # a DRI's interval
        self.sof: bytes | None = None       # the SOF segment
        self.sof_hv: tuple | None = None
        self.sos: bytes | None = None       # the SOS body's component part

    def read(self, src: _Bytes, spp: int, w: int, h: int) -> None:
        """Markers from the start of ``src`` up to the scan header, or to the
        first byte that is not a marker's 0xFF."""
        while src.pos < len(src.data) and src.data[src.pos] == 0xFF:
            src.pos += 1
            m = src.byte()
            while m == 0xFF:
                m = src.byte()
            if m == 0xD8:
                continue
            if m in _APPS:
                n = src.word()
                if n < 2:
                    raise _corrupt("corrupt JPEG data")
                src.block(n - 2)
            elif m == 0xDD:
                if src.word() != 4:
                    raise _corrupt("corrupt DRI marker in JPEG data")
                self.restart = src.word()
            elif m == 0xDB:
                n = src.word()
                if n <= 2:
                    raise _corrupt("corrupt DQT marker in JPEG data")
                n -= 2
                while n > 0:
                    if n < 65:
                        raise _corrupt("corrupt DQT marker in JPEG data")
                    body = src.block(65)
                    if body[0] & 15 > 3 or body[0] >> 4:
                        raise _corrupt("corrupt DQT marker in JPEG data")
                    self.q[body[0] & 15] = body
                    n -= 65
            elif m == 0xC4:
                n = src.word()
                if n <= 2:
                    raise _corrupt("corrupt DHT marker in JPEG data")
                body = src.block(n - 2)
                cls, tid = body[0] >> 4, body[0] & 15
                if cls > 1 or tid > 3:
                    raise _corrupt("corrupt DHT marker in JPEG data")
                (self.ac if cls else self.dc)[tid] = body
            elif m in (0xC0, 0xC1, 0xC3):
                self._sof(src, m, spp, w, h)
            elif m == 0xDA:
                n = src.word()
                if n != 6 + 2 * spp or src.byte() != spp:
                    raise _corrupt("corrupt SOS marker in JPEG data")
                self.sos = src.block(2 * spp)
                src.block(3)            # Ss, Se, Ah/Al: written anew as 0, 63, 0
                return
            else:
                raise _corrupt(f"unknown marker type {m} in JPEG data")

    def _sof(self, src: _Bytes, m: int, spp: int, w: int, h: int) -> None:
        if self.sof is not None:
            raise _corrupt("corrupt JPEG data (a second SOF marker)")
        n = src.word()
        if n < 11 or (n - 8) % 3:
            raise _corrupt("corrupt SOF marker in JPEG data")
        nc = (n - 8) // 3
        if nc != spp:
            raise _corrupt("JPEG compressed data indicates unexpected number of samples")
        body = src.block(n - 2)
        p, y, x, nf = struct.unpack_from(">BHHB", body)
        if p != 8:
            raise _corrupt("JPEG compressed data indicates unexpected number of bits per sample")
        if y < h:
            raise _corrupt("JPEG compressed data indicates unexpected height")
        if x != w:
            raise _corrupt("JPEG compressed data indicates unexpected width")
        if nf != nc:
            raise _corrupt("corrupt SOF marker in JPEG data")
        if m == 0xC3:
            raise ValueError("old-style JPEG TIFF of the lossless process is not carried by the "
                             "port's codec (ROADMAP.md queue 1, item 8c)")
        self.sof = _segment(m, body)
        self.sof_hv = tuple(body[7 + 3 * c] for c in range(nc))

    def from_tags(self, data: bytes, t: dict, spp: int, hs: int, vs: int, w: int,
                  h: int) -> None:
        """The tables, frame and scan made from the tags (OJPEGReadHeaderInfoSecTables*)."""
        def offsets(tag, what):
            offs = t.get(tag, ())
            if len(offs) != spp:
                raise _corrupt(f"{what} tag has incorrect count" if offs else
                               "missing JPEG tables")
            if not offs[0]:
                raise _corrupt("missing JPEG tables")
            return offs

        def table_ids(offs, what):
            ids = []
            for m, o in enumerate(offs):
                if o and (m == 0 or o != offs[m - 1]):
                    if o in offs[:max(m - 1, 0)]:
                        raise _corrupt(f"corrupt {what} tag value")
                    ids.append(m)
                else:
                    ids.append(ids[m - 1])
            return ids

        def read(at, n):
            if at + n > len(data):
                raise _corrupt("the JPEG tables lie past the file's end")
            return data[at:at + n]

        q_offs = offsets(519, "JpegQTables")
        tq = table_ids(q_offs, "JpegQTables")
        for m in sorted(set(tq)):
            self.q[m] = bytes([m]) + read(q_offs[m], 64)
        sof = bytes([8]) + struct.pack(">HH", h, w) + bytes([spp])
        for m in range(spp):
            sof += bytes([m, hs << 4 | vs if m == 0 else 0x11, tq[m]])
        self.sof = _segment(0xC0, sof)
        self.sof_hv = tuple(sof[7 + 3 * c] for c in range(spp))
        tda = [0] * spp
        for tag, cls, what in ((520, 0, "JpegDcTables"), (521, 1, "JpegAcTables")):
            offs = offsets(tag, what)
            ids = table_ids(offs, what)
            for m in sorted(set(ids)):
                counts = read(offs[m], 16)
                (self.ac if cls else self.dc)[m] = (
                    bytes([cls << 4 | m]) + counts + read(offs[m] + 16, sum(counts)))
            for m in range(spp):
                tda[m] |= ids[m] << (0 if cls else 4)
        self.sos = b"".join(bytes([m, tda[m]]) for m in range(spp))

    def stream(self, restart: int, data: bytes) -> bytes:
        """The stream OJPEGWriteHeaderInfo and OJPEGWriteStream hand
        libjpeg: SOI, the tables, DRI, the frame, the scan, the data, EOI."""
        out = b"\xff\xd8"
        out += b"".join(_segment(0xDB, self.q[k]) for k in sorted(self.q))
        out += b"".join(_segment(0xC4, self.dc[k]) for k in sorted(self.dc))
        out += b"".join(_segment(0xC4, self.ac[k]) for k in sorted(self.ac))
        if restart:
            out += _segment(0xDD, struct.pack(">H", restart))
        out += self.sof + _segment(0xDA, bytes([len(self.sos) // 2]) + self.sos + b"\x00\x3f\x00")
        return out + data + b"\xff\xd9"


def _strip_bytes(data: bytes, offset: int, count: int) -> bytes:
    """A strip's bytes as OJPEGReadBufferFill takes them: none at offset 0
    or past the file, to the file's end for a count of 0 or one that
    passes it."""
    if offset == 0 or offset >= len(data):
        return b""
    return data[offset:offset + count] if count else data[offset:]


def decode_ojpeg(data: bytes, t: dict, w: int, h: int, tabs) -> np.ndarray:
    """The first image of an old-style JPEG TIFF (tags ``t``) as Pillow
    reads it: uint8 [h, w, 3] RGB of YCbCr through ``tabs``
    (``imgcodecs._ycbcr_tables`` of the file), or [h, w, 1] for one
    sample."""
    from dspfun_tpu_torch.io.imgcodecs import _YCBCR_SUBSAMPLINGS, _ycbcr_rgb  # noqa: PLC0415

    if 322 in t or 324 in t:
        raise ValueError("tiled old-style JPEG TIFF is not carried by the port's codec "
                         "(ROADMAP.md queue 1, item 8c)")
    photo = t.get(262, (6,))[0]
    if photo == 2:          # libtiff: "assuming data is YCbCr instead of RGB"
        photo = 6
    spp = t[277][0] if 277 in t else 3 if photo == 6 else 1
    if spp not in (1, 3):
        raise _corrupt(f"SamplesPerPixel {spp} not supported for this compression scheme")
    if spp == 3 and t.get(284, (1,))[0] == 2:
        raise ValueError("planar old-style JPEG TIFF is not carried by the port's codec "
                         "(ROADMAP.md queue 1, item 8c)")
    if spp == 3 and photo != 6:
        raise ValueError(f"old-style JPEG TIFF of three samples in photometric {photo}: Pillow "
                         "reads libtiff's raw samples as RGBX, which the port does not read")
    if spp == 1 and photo == 6:
        raise ValueError("old-style JPEG TIFF of one YCbCr sample: libtiff's RGBA reader cannot "
                         "handle it (Pillow raises)")
    ycc = spp == 3
    hs, vs = (tuple(t[530][:2]) if len(t.get(530, ())) >= 2 else (2, 2)) if ycc else (1, 1)
    offsets, counts = t.get(273, ()), t.get(279, ())
    rps = min(t.get(278, (h,))[0] or h, h)
    nstrips = -(-h // rps)
    if len(offsets) < nstrips:
        raise _corrupt(f"{len(offsets)} strips of {nstrips}")
    if nstrips > 1 and data[:2] == b"MM":
        raise ValueError("big-endian old-style JPEG TIFF in several strips: Pillow's libtiff "
                         "reads the strips after the first to other pixels than the stream's, "
                         "which the port does not reproduce (ROADMAP.md queue 1, item 8c)")
    strips = [_strip_bytes(data, o, c) for o, c in zip(offsets[:nstrips],
                                                        list(counts[:nstrips]) + [0] * nstrips)]
    jif = b""
    if t.get(513, (0,))[0] and t[513][0] < len(data):
        at = t[513][0]
        n = t.get(514, (0,))[0]
        jif = data[at:at + n] if n and at + n <= len(data) else data[at:]
    src = _Bytes([jif] + strips)
    head = _Header()
    head.read(src, spp, w, h)
    if head.sof is not None:
        if head.sos is None:
            raise _corrupt("the JPEG header has a frame but no scan")
        # OJPEGSubsamplingCorrect: the frame's sampling stands over the tag's
        first, rest = head.sof_hv[0], head.sof_hv[1:]
        if not ycc:
            if any(hv != 0x11 for hv in head.sof_hv):
                raise _corrupt("JPEG compressed data indicates unexpected subsampling values")
        elif first >> 4 not in (1, 2, 4) or first & 15 not in (1, 2, 4) or any(r != 0x11
                                                                               for r in rest):
            raise ValueError("old-style JPEG TIFF whose frame sampling libtiff has libjpeg "
                             "upsample is not carried by the port's codec (ROADMAP.md queue 1, "
                             "item 8c)")
        else:
            hs, vs = first >> 4, first & 15
    restart = t.get(515, (0,))[0]
    if rps < h:
        if hs not in (1, 2, 4) or vs not in (1, 2, 4):
            raise _corrupt("invalid subsampling values")
        if rps % (8 * vs):
            raise _corrupt("incompatible vertical subsampling and image strip length")
        restart = -(-w // (8 * hs)) * (rps // (8 * vs))
    if head.sof is None:
        src.pos = 0
        head.from_tags(data, t, spp, hs, vs, w, h)
    if head.restart is not None:
        restart = head.restart
    if ycc and (hs, vs) not in _YCBCR_SUBSAMPLINGS:
        raise ValueError(f"TIFF: YCbCr subsampling {hs}x{vs}: libtiff's RGBA reader cannot "
                         "handle the format")
    # the data after the scan header: the rest of what the header was read
    # from, then each strip, a restart marker after each strip whose data
    # the decoder read out (OJPEGWriteStreamCompressed) but the last
    at = src.pos
    body, rst = [jif[at:]], 0
    start = len(jif)
    for k, strip in enumerate(strips):
        end = start + len(strip)
        if end > at and strip:
            body.append(strip[max(at - start, 0):])
            if k < nstrips - 1:
                body.append(bytes([0xFF, 0xD0 + rst % 8]))
                rst += 1
        start = end
    body = b"".join(body)
    eoi = body.find(b"\xff\xd9")
    if restart and b"\xff\xd8" in body[:eoi if eoi >= 0 else len(body)]:
        raise ValueError("old-style JPEG TIFF whose data after the scan header starts the stream "
                         "again (a JPEGInterchangeFormatLength cut short) under restart markers: "
                         "Pillow's libtiff reads it to other pixels from the first row, which "
                         "the port does not reproduce (ROADMAP.md queue 1, item 8c)")
    stream = head.stream(restart, body)
    frame, coefs = _jpeg.decode_coefficients(stream, lenient=True, one_scan=True)
    if ycc:
        planes = [_plane(frame, c, k) for c, k in zip(frame.components, coefs)]
        y = planes[0][:h, :w]
        cb, cr = (np.repeat(np.repeat(p, vs, 0), hs, 1)[:h, :w] for p in planes[1:])
        return _ycbcr_rgb(tabs, y, cb, cr)
    return _plane(frame, frame.components[0], coefs[0])[:h, :w, None]


def _plane(frame, comp, coefs: np.ndarray) -> np.ndarray:
    """One component's samples at its own resolution, whole blocks
    (libjpeg's raw data): its islow IDCT, as a one-component frame."""
    one = _jpeg.Frame(frame.marker, 8, comp.rows * 8, comp.stride * 8,
                      [_jpeg.Component(comp.id, 1, 1, comp.tq, comp.stride, comp.rows,
                                       comp.stride, comp.rows, comp.qtable)],
                      colorspace=0)
    return _jpeg.reconstruct(one, [coefs])[..., 0]
