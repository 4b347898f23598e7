"""JPEG 2000 read by the port's own codec, as Pillow 12.1 reads it through
OpenJPEG 2.5 (``Jpeg2KImagePlugin`` and ``Jpeg2KDecode.c``), with no
Pillow.

* **Open** (:func:`open_j2k`, ``Jpeg2KImageFile._open``): a raw
  codestream (``\\xff\\x4f\\xff\\x51``: ``.j2k``, ``.j2c``, ``.jpc``) or a
  JP2 file (the 12-byte signature box), its size and Pillow's mode from
  SIZ (``Csiz`` 1 -> ``L``, or ``I;16`` above 8 bits, 2 -> ``LA``, 3 ->
  ``RGB``, 4 -> ``RGBA``) or from the JP2 header box as Pillow's
  ``BoxReader`` walks it (``ihdr``; ``colr`` enumerated colour space 12
  over 4 components -> ``CMYK``; ``pclr`` over ``L``/``LA`` -> ``P``/``PA``
  with the palette Pillow's ``ImagePalette.getcolor`` builds).  Where the
  plugin raises ``SyntaxError`` or what ``Image.open`` takes as such
  (``struct.error``, ``IndexError``, a size that is not positive) the file
  is passed on (:class:`rawimg.Skip`); where it raises anything else the
  open fails with a ``ValueError``.
* **Decode** (:func:`decode_j2k`): the JP2 boxes as OpenJPEG walks them
  to the codestream and its ``colr`` colour space; the main header and
  the tile parts (SOT; TLM, PLM, PLT, CRG and COM skipped), read as
  strictly as OpenJPEG's strict mode reads them (a tile part longer than
  the stream raises, as Pillow's "broken data stream" does), their coding
  markers in order as OpenJPEG applies them: COD and QCD set every
  component and COC and QCC one (so a tile's override the main header's,
  and a COD after a COC undoes it), RGN a component's max-shift ROI, POC
  progressions appended to those read before; the tiles through
  ``native/j2k.cpp`` (``j2k_decode``: tier-2 with SOP and EPH markers and
  the POC progressions, tier-1 under every code-block style switch, the
  5/3 or 9/7 inverse wavelet, the RCT or ICT, the level shift and clamp;
  built at first use by ``_hostbuild.py``); then Pillow's unpacker of the
  mode and colour space (``j2ku_*``: each component's samples shifted to
  8 or 16 bits with its rounding offset and wrapped to them, sYCC through
  Pillow's YCbCr -> RGB tables; a raw codestream with full-size luma and
  sub-sampled chroma taken as sYCC, as Pillow guesses; sub-sampled planes
  laid out tile by tile as Pillow reads them, :func:`_pillow_tiles`), and
  what ``convert("RGBA")`` (or ``convert("I")`` for ``I;16``) makes of the
  mode: CMYK through ``cmyk2rgb``, palettes expanded.
* **Refused, naming item 8h**, with or without cv2 (no JPEG 2000 file
  reaches it): PPM and PPT (packed packet headers), HT code-blocks, and
  POC progressions that leave a component's highest resolution without a
  packet (OpenJPEG then hands Pillow a smaller plane).
"""

from __future__ import annotations

import ctypes
import functools
import io
import struct

import numpy as np

from dspfun_tpu_torch import _hostbuild
from dspfun_tpu_torch.io import imgcodecs as _codecs
from dspfun_tpu_torch.io import png as _png
from dspfun_tpu_torch.io import rawimg as _raw

__all__ = ["decode_j2k", "open_j2k"]

SOC_SIZ = b"\xff\x4f\xff\x51"
JP2_SIGNATURE = b"\x00\x00\x00\x0cjP  \x0d\x0a\x87\x0a"
_SOT, _SOD, _EOC = 0xFF90, 0xFF93, 0xFFD9
_SIZ, _COD, _COC, _QCD, _QCC = 0xFF51, 0xFF52, 0xFF53, 0xFF5C, 0xFF5D
_RGN, _POC, _PPM, _PPT = 0xFF5E, 0xFF5F, 0xFF60, 0xFF61
# OpenJPEG's colour spaces from a JP2 colr box's enumerated space
_GRAY, _SRGB, _SYCC, _CMYK = "gray", "srgb", "sycc", "cmyk"
_ENUMCS = {16: _SRGB, 17: _GRAY, 18: _SYCC, 24: "eycc", 12: _CMYK}
# Pillow's j2k_unpackers: (mode, colour space, components) -> unpacker
_UNPACKERS = {("L", _GRAY, 1): "l", ("P", _SRGB, 1): "l", ("PA", _SRGB, 2): "la",
              ("I;16", _GRAY, 1): "i", ("LA", _GRAY, 2): "la", ("RGB", _GRAY, 1): "gray_rgb",
              ("RGB", _GRAY, 2): "gray_rgb", ("RGB", _SRGB, 3): "rgb", ("RGB", _SYCC, 3): "ycc",
              ("RGB", _SRGB, 4): "rgb", ("RGB", _SYCC, 4): "ycc", ("RGBA", _GRAY, 1): "gray_rgb",
              ("RGBA", _GRAY, 2): "la", ("RGBA", _SRGB, 3): "rgb", ("RGBA", _SYCC, 3): "ycc",
              ("RGBA", _GRAY, 4): "rgba", ("RGBA", _SRGB, 4): "rgba", ("RGBA", _SYCC, 4): "ycca",
              ("CMYK", _CMYK, 4): "rgba"}


@functools.lru_cache(maxsize=None)
def _load() -> ctypes.CDLL:
    """The loaded library of ``native/j2k.cpp`` (built on first use;
    raises with the compiler's message when it cannot be built)."""
    lib = _hostbuild.load_library("j2k")
    c = ctypes
    lib.j2k_decode.restype = c.c_int
    lib.j2k_decode.argtypes = [c.c_char_p, c.c_int64, c.c_void_p, c.c_void_p, c.c_char_p,
                               c.c_int]
    return lib


# ---- Pillow's open ------------------------------------------------------------------


class _BoxReader:
    """Pillow's ``BoxReader`` over a byte stream."""

    def __init__(self, fp: io.BytesIO, length: int = -1) -> None:
        self.fp, self.has_length, self.length, self.remaining = fp, length >= 0, length, -1

    def _can_read(self, n: int) -> bool:
        if self.has_length and self.fp.tell() + n > self.length:
            return False
        return n <= self.remaining if self.remaining >= 0 else True

    def _read(self, n: int) -> bytes:
        if not self._can_read(n):
            raise _raw.Skip("Not enough data in header")
        data = self.fp.read(n)
        if len(data) < n:
            raise ValueError(f"JPEG 2000: expected to read {n} bytes but only got {len(data)}")
        if self.remaining > 0:
            self.remaining -= n
        return data

    def fields(self, fmt: str) -> tuple:
        return struct.unpack(fmt, self._read(struct.calcsize(fmt)))

    def boxes(self) -> _BoxReader:
        size = self.remaining
        return _BoxReader(io.BytesIO(self._read(size)), size)

    def has_next(self) -> bool:
        return self.fp.tell() + self.remaining < self.length if self.has_length else True

    def next_type(self) -> bytes:
        if self.remaining > 0:
            self.fp.seek(self.remaining, io.SEEK_CUR)
        self.remaining = -1
        lbox, tbox = self.fields(">I4s")
        hlen = 8
        if lbox == 1:
            lbox, hlen = self.fields(">Q")[0], 16
        if lbox < hlen or not self._can_read(lbox - hlen):
            raise _raw.Skip("Invalid header length")
        self.remaining = lbox - hlen
        return tbox


def _palette_bytes(colors: list, npc: int) -> tuple[str, bytes]:
    """``ImagePalette.getcolor`` of each ``pclr`` entry in turn: the
    palette's mode and bytes (a repeated colour keeps its first index)."""
    mode = "RGBA" if npc == 4 else "RGB"
    pal, seen = bytearray(), {}
    for color in colors:
        if mode == "RGB" and len(color) == 4:
            if color[3] != 255:
                raise ValueError("cannot add non-opaque RGBA color to RGB palette")
            color = color[:3]
        elif mode == "RGBA" and len(color) == 3:
            color += (255,)
        if color in seen:
            continue
        index = len(pal) // len(mode)
        if index >= 256:
            raise ValueError("cannot allocate more than 256 colors")
        seen[color] = index
        if index * len(mode) < len(pal):
            pal[index * len(mode):index * len(mode) + len(mode)] = bytes(color)
        else:
            pal += bytes(color)
    return mode, bytes(pal)


def _jp2_header(fp: io.BytesIO) -> tuple:
    """``_parse_jp2_header``: size, mode and palette."""
    reader = _BoxReader(fp)
    header = None
    while reader.has_next():
        tbox = reader.next_type()
        if tbox == b"jp2h":
            header = reader.boxes()
            break
        if tbox == b"ftyp":
            reader.fields(">4s")
    if header is None:      # Pillow's assert (a reader without length never ends so)
        raise ValueError("JPEG 2000: no JP2 header box")
    size = mode = nc = palette = None
    while header.has_next():
        tbox = header.next_type()
        if tbox == b"ihdr":
            height, width, nc, bpc = header.fields(">IIHB")
            size = (width, height)
            if nc == 1 and (bpc & 0x7F) > 8:
                mode = "I;16"
            elif nc in (1, 2, 3, 4):
                mode = ("L", "LA", "RGB", "RGBA")[nc - 1]
        elif tbox == b"colr" and nc == 4:
            meth, _, _, enumcs = header.fields(">BBBI")
            if meth == 1 and enumcs == 12:
                mode = "CMYK"
        elif tbox == b"pclr" and mode in ("L", "LA"):
            ne, npc = header.fields(">HB")
            depths = header.fields(">" + "B" * npc)
            if max(depths, default=0) <= 8:
                colors = [header.fields(">" + "B" * npc) for _ in range(ne)]
                palette = _palette_bytes(colors, npc)
                mode = "P" if mode == "L" else "PA"
        elif tbox == b"res ":
            res = header.boxes()
            while res.has_next():
                if res.next_type() == b"resc":
                    res.fields(">HHHHBB")       # Pillow's dpi, which no read uses
                    break
    if size is None or mode is None:
        raise _raw.Skip("Malformed JP2 header")
    return size, mode, palette


def _skip_to_comment(fp: io.BytesIO) -> None:
    """``_parse_comment``: the markers after SIZ up to a COM, SOT or EOC
    (a short length field is Pillow's ``struct.error``)."""
    while True:
        marker = fp.read(2)
        if not marker:
            return
        if len(marker) < 2:
            raise _raw.Skip("short marker")       # IndexError on marker[1]
        if marker[1] in (0x90, 0xD9):
            return
        hdr = fp.read(2)
        if len(hdr) < 2:
            raise _raw.Skip("short marker length")
        length = struct.unpack(">H", hdr)[0]
        if marker[1] == 0x64:
            return
        fp.seek(length - 2, io.SEEK_CUR)


def _open(data: bytes) -> dict:
    fp = io.BytesIO(data)
    sig = fp.read(4)
    palette = None
    if sig == SOC_SIZ:
        codec = "j2k"
        hdr = fp.read(2)
        if len(hdr) < 2:
            raise _raw.Skip("short SIZ")
        lsiz = struct.unpack(">H", hdr)[0]
        siz = hdr + fp.read(lsiz - 2)        # (a length below 2 reads to the end)
        if len(siz) < 38:
            raise _raw.Skip("short SIZ")
        xsiz, ysiz, xosiz, yosiz = struct.unpack_from(">IIII", siz, 4)
        csiz = struct.unpack_from(">H", siz, 36)[0]
        size = (xsiz - xosiz, ysiz - yosiz)
        if csiz == 1:
            if len(siz) < 39:
                raise _raw.Skip("short SIZ")
            mode = "I;16" if (siz[38] & 0x7F) + 1 > 8 else "L"
        elif csiz in (2, 3, 4):
            mode = ("LA", "RGB", "RGBA")[csiz - 2]
        else:
            raise _raw.Skip("unable to determine J2K image mode")
        _skip_to_comment(fp)
    else:
        sig += fp.read(8)
        if sig != JP2_SIGNATURE:
            raise _raw.Skip("not a JPEG 2000 file")
        codec = "jp2"
        size, mode, palette = _jp2_header(fp)
        if fp.read(12).endswith(b"jp2c" + SOC_SIZ):
            hdr = fp.read(2)
            if len(hdr) < 2:
                raise _raw.Skip("short SIZ")
            fp.seek(struct.unpack(">H", hdr)[0] - 2, io.SEEK_CUR)
            _skip_to_comment(fp)
    if size[0] <= 0 or size[1] <= 0:
        raise _raw.Skip("an empty size: not identified by the plugin")
    return dict(codec=codec, size=size, mode=mode, palette=palette)


def open_j2k(data: bytes) -> dict:
    """``Jpeg2KImageFile._open``: the codec (``j2k`` or ``jp2``), size,
    mode and palette (mode and bytes, or None) Pillow finds; raises
    :class:`rawimg.Skip` where Pillow passes the file on."""
    if not data.startswith((SOC_SIZ, JP2_SIGNATURE)):
        raise _raw.Skip("not a JPEG 2000 file")
    try:
        info = _open(bytes(data))
    except struct.error as e:
        raise _raw.Skip(f"JPEG 2000: {e}") from None
    _raw.bomb_check(*info["size"])
    return info


# ---- OpenJPEG's reading of the JP2 boxes and the codestream ----------------------------


def _check_pclr(body: bytes, again: bool) -> None:
    """OpenJPEG's checks of a ``pclr`` box: one box, 1 to 1024 entries, a
    column at least, and room for every entry at its columns' widths."""
    if again or len(body) < 3:
        raise ValueError("JPEG 2000: a second or short pclr box")
    ne, npc = struct.unpack_from(">HB", body)
    if not 0 < ne <= 1024 or npc == 0 or len(body) < 3 + npc:
        raise ValueError(f"JPEG 2000: a pclr box of {ne} entries and {npc} columns")
    row = sum(min(4, ((b & 0x7F) + 8) >> 3) for b in body[3:3 + npc])
    if len(body) < 3 + npc + ne * row:
        raise ValueError("JPEG 2000: a pclr box shorter than its entries")


def _jp2_codestream(data: bytes) -> tuple[bytes, str]:
    """The codestream of a JP2 file and the colour space of its first
    ``colr`` box, the boxes walked as OpenJPEG walks them (the signature
    box, then ``ftyp``, then ``jp2h`` before ``jp2c``)."""
    pos, n, space, header, palette = 0, 0, None, False, False
    while pos + 8 <= len(data):
        lbox, tbox = struct.unpack_from(">I4s", data, pos)
        hlen = 8
        if lbox == 1:
            if pos + 16 > len(data):
                break
            lbox, hlen = struct.unpack_from(">Q", data, pos + 8)[0], 16
        elif lbox == 0:
            lbox = len(data) - pos
        if tbox == b"jp2c":
            if not header:
                raise ValueError("JPEG 2000: the codestream box comes before the JP2 header box")
            return data[pos + hlen:pos + lbox], space or None
        if lbox < hlen or pos + lbox > len(data):
            raise ValueError(f"JPEG 2000: a {tbox!r} box of a bad length")
        if (n == 0) != (tbox == b"jP  ") or (n == 1) != (tbox == b"ftyp"):
            raise ValueError("JPEG 2000: the signature and file type boxes must come first")
        if tbox == b"jp2h":
            header = True
            sub = pos + hlen
            while sub + 8 <= pos + lbox:
                slen, stype = struct.unpack_from(">I4s", data, sub)
                if slen < 8 or sub + slen > pos + lbox:
                    raise ValueError(f"JPEG 2000: a {stype!r} box of a bad length")
                if stype == b"colr" and space is None and slen >= 11 and data[sub + 8] <= 2:
                    if data[sub + 8] == 1:      # an enumerated space (ICC profiles: unspecified)
                        if slen < 15:
                            raise ValueError("JPEG 2000: a short colr box")
                        space = _ENUMCS.get(struct.unpack_from(">I", data, sub + 11)[0], "")
                    else:
                        space = ""
                elif stype == b"pclr":
                    _check_pclr(data[sub + 8:sub + slen], palette)
                    palette = True
                elif stype == b"cmap" and not palette:
                    raise ValueError("JPEG 2000: a cmap box before any pclr box")
                sub += slen
        pos += lbox
        n += 1
    raise ValueError("JPEG 2000: no codestream box")


def _markers(cs: bytes, pos: int, end_markers) -> tuple[list, int]:
    """The (marker, segment) list from pos up to one of end_markers, and
    where that one starts."""
    out = []
    while True:
        if pos + 2 > len(cs):
            raise ValueError("JPEG 2000: the codestream ends inside a header (Pillow: broken "
                             "data stream)")
        m = struct.unpack_from(">H", cs, pos)[0]
        if m in end_markers:
            return out, pos
        if pos + 4 > len(cs):
            raise ValueError("JPEG 2000: the codestream ends inside a header")
        length = struct.unpack_from(">H", cs, pos + 2)[0]
        if length < 2 or pos + 2 + length > len(cs):
            raise ValueError(f"JPEG 2000: marker 0x{m:04X} runs past the codestream")
        out.append((m, cs[pos + 4:pos + 2 + length]))
        pos += 2 + length


def _spcod(seg: bytes, at: int, comp: dict) -> None:
    """OpenJPEG's ``opj_j2k_read_SPCod_SPCoc``: SPcod or SPcoc from ``at``
    to the segment's end into a component's record (its precinct sizes
    where the component's Scod or Scoc bit 0 says so)."""
    if len(seg) < at + 5:
        raise ValueError("JPEG 2000: a short SPcod or SPcoc element")
    nl, xcb, ycb, style, transform = seg[at:at + 5]
    if nl + 1 > 33:
        raise ValueError("JPEG 2000: more than 33 resolutions")
    if xcb > 8 or ycb > 8 or xcb + ycb > 8:
        raise ValueError("JPEG 2000: a bad code-block size")
    if style & 0x80:
        raise ValueError("JPEG 2000: the mixed HT code-block style")
    if style & 0x40:
        raise _png.refusal("JPEG 2000 with HT (high-throughput) code-blocks", "h")
    if transform > 1:
        raise ValueError("JPEG 2000: a bad wavelet transform")
    at += 5
    if comp["csty"] & 1:
        if len(seg) < at + nl + 1:
            raise ValueError("JPEG 2000: a short SPcod or SPcoc element")
        pp = seg[at:at + nl + 1]
        ppx, ppy = [b & 15 for b in pp], [b >> 4 for b in pp]
        if any(v == 0 for v in ppx[1:] + ppy[1:]):
            raise ValueError("JPEG 2000: a precinct size of 1 above the lowest resolution")
        at += nl + 1
    else:
        ppx = ppy = [15] * (nl + 1)
    if at != len(seg):
        raise ValueError("JPEG 2000: a COD or COC marker of a bad length")
    comp.update(numres=nl + 1, xcb=xcb + 2, ycb=ycb + 2, style=style, reversible=transform,
                ppx=ppx, ppy=ppy)


_SPCOD_KEYS = ("numres", "xcb", "ycb", "style", "reversible", "ppx", "ppy")
_QCD_KEYS = ("guard", "expn", "mant")


def _cod(seg: bytes, tcp: dict) -> None:
    """COD (``opj_j2k_read_cod``): SGcod, and SPcod into the first
    component's record and copied to the others."""
    if len(seg) < 5:
        raise ValueError("JPEG 2000: a short COD marker")
    scod, prog, layers, mct = struct.unpack_from(">BBHB", seg)
    if scod & ~7:
        raise ValueError("JPEG 2000: an unknown Scod value in COD")
    if layers == 0 or mct > 1:
        raise ValueError("JPEG 2000: a COD marker of bad values")
    tcp.update(csty=scod, prog=prog, layers=layers, mct=mct, cod=True)
    comps = tcp["comps"]
    for comp in comps:
        comp["csty"] = scod & 1
    _spcod(seg, 5, comps[0])
    for comp in comps[1:]:
        comp.update({k: comps[0][k] for k in _SPCOD_KEYS})


def _qcx(seg: bytes, at: int, comp: dict) -> None:
    """OpenJPEG's ``opj_j2k_read_SQcd_SQcc``: the style, guard bits and
    step sizes from ``at`` into a component's record (the bands the
    segment does not give keep theirs)."""
    if len(seg) < at + 1:
        raise ValueError("JPEG 2000: a short QCD or QCC marker")
    style, guard = seg[at] & 0x1F, seg[at] >> 5
    body = seg[at + 1:]
    expn, mant = list(comp.get("expn", [0] * 97)), list(comp.get("mant", [0] * 97))
    if style == 0:
        new = [(b >> 3, 0) for b in body]
    elif style in (1, 2):      # a derived style gives the LL band's alone
        if len(body) % 2 or (style == 1 and len(body) != 2):
            raise ValueError("JPEG 2000: a QCD or QCC marker of a bad length")
        new = [(x >> 11, x & 0x7FF) for x in struct.unpack(f">{len(body) // 2}H", body)]
    else:
        raise ValueError(f"JPEG 2000: quantisation style {style}")
    for i, (e, m) in enumerate(new[:97]):
        expn[i], mant[i] = e, m
    if style == 1:      # derived from the LL band's (E-5)
        expn = [expn[0]] + [max(expn[0] - (b - 1) // 3, 0) for b in range(1, 97)]
        mant = [mant[0]] * 97
    comp.update(guard=guard, expn=expn, mant=mant)


def _qcd(seg: bytes, tcp: dict) -> None:
    comps = tcp["comps"]
    _qcx(seg, 0, comps[0])
    for comp in comps[1:]:
        comp.update({k: comps[0][k] for k in _QCD_KEYS})
    tcp["qcd"] = True


def _component(seg: bytes, nc: int, what: str) -> tuple[int, int]:
    """The component a COC, QCC or RGN names (one byte, two above 256
    components) and where the rest starts."""
    room = 1 if nc <= 256 else 2
    if len(seg) < room:
        raise ValueError(f"JPEG 2000: a short {what} marker")
    c = seg[0] if room == 1 else struct.unpack_from(">H", seg)[0]
    if c >= nc:
        raise ValueError(f"JPEG 2000: a {what} marker of component {c} of {nc}")
    return c, room


def _coc(seg: bytes, tcp: dict) -> None:
    comps = tcp["comps"]
    c, at = _component(seg, len(comps), "COC")
    if len(seg) < at + 1:
        raise ValueError("JPEG 2000: a short COC marker")
    comps[c]["csty"] = seg[at]
    _spcod(seg, at + 1, comps[c])


def _qcc(seg: bytes, tcp: dict) -> None:
    c, at = _component(seg, len(tcp["comps"]), "QCC")
    _qcx(seg, at, tcp["comps"][c])


def _rgn(seg: bytes, tcp: dict) -> None:
    """RGN (max-shift ROI): the component's shift (Srgn is not read)."""
    nc = len(tcp["comps"])
    if len(seg) != 2 + (1 if nc <= 256 else 2):
        raise ValueError("JPEG 2000: an RGN marker of a bad length")
    c, at = _component(seg, nc, "RGN")
    tcp["comps"][c]["roishift"] = seg[at + 1]


def _poc(seg: bytes, tcp: dict) -> None:
    """POC (``opj_j2k_read_poc``): its progressions appended to those read
    before for the main header or the tile, each LYEpoc held to the layers
    known when it is read and each CEpoc to the components."""
    nc = len(tcp["comps"])
    room = 1 if nc <= 256 else 2
    size = 5 + 2 * room
    n, rest = divmod(len(seg), size)
    pocs = tcp["pocs"] if tcp["pocs"] is not None else []
    if n == 0 or rest:
        raise ValueError("JPEG 2000: a POC marker of a bad length")
    if len(pocs) + n >= 32:
        raise ValueError("JPEG 2000: more than 31 progressions")
    fmt = ">BBHBBB" if room == 1 else ">BHHBHB"
    for k in range(n):
        res0, comp0, lay1, res1, comp1, prg = struct.unpack_from(fmt, seg, k * size)
        pocs.append((res0, comp0, min(lay1, tcp["layers"]), res1, min(comp1, nc), prg))
    tcp["pocs"] = pocs


_MARKERS = {_COD: _cod, _COC: _coc, _QCD: _qcd, _QCC: _qcc, _RGN: _rgn, _POC: _poc}
_REFUSED = {_PPM: "a PPM marker (packed packet headers)",
            _PPT: "a PPT marker (packed packet headers)"}


def _read_markers(segs: list, tcp: dict) -> None:
    """The coding markers of a header in their order, as OpenJPEG reads
    them: a COD or QCD sets every component and a later COC or QCC one of
    them, so a tile's markers override the main header's."""
    for m, seg in segs:
        if m in _REFUSED:
            raise _png.refusal(f"JPEG 2000 with {_REFUSED[m]}", "h")
        if m in _MARKERS:
            _MARKERS[m](seg, tcp)


def _copy_tcp(tcp: dict) -> dict:
    return dict(tcp, comps=[dict(c) for c in tcp["comps"]],
                pocs=None if tcp["pocs"] is None else list(tcp["pocs"]))


def _main_header(cs: bytes) -> dict:
    """SIZ, the coding markers of the main header, and the tiles' joined
    tile-part bodies with their own coding parameters."""
    if not cs.startswith(SOC_SIZ):
        raise ValueError("JPEG 2000: the codestream does not start with SOC and SIZ")
    segs, pos = _markers(cs, 2, (_SOT, _EOC))
    if not segs or segs[0][0] != _SIZ:
        raise ValueError("JPEG 2000: no SIZ marker")
    siz = segs[0][1]
    if len(siz) < 36:
        raise ValueError("JPEG 2000: a short SIZ marker")
    (_rsiz, xsiz, ysiz, xo, yo, xt, yt, xto, yto, csiz) = struct.unpack_from(">HIIIIIIIIH", siz)
    if csiz == 0 or len(siz) != 36 + 3 * csiz:
        raise ValueError("JPEG 2000: a SIZ marker of a bad length")
    comps = [struct.unpack_from(">BBB", siz, 36 + 3 * i) for i in range(csiz)]
    if any(c[1] == 0 or c[2] == 0 for c in comps):
        raise ValueError("JPEG 2000: a component sub-sampling of 0")
    if any((c[0] & 0x7F) + 1 > 38 for c in comps):
        raise ValueError("JPEG 2000: a precision above 38 bits")
    if (xt == 0 or yt == 0 or xo >= xsiz or yo >= ysiz or xto > xo or yto > yo
            or xto + xt <= xo or yto + yt <= yo):
        raise ValueError("JPEG 2000: a SIZ marker of bad values")
    tcp = dict(csty=0, prog=0, layers=0, mct=0, pocs=None, cod=False, qcd=False,
               comps=[dict(csty=0, roishift=0) for _ in comps])
    _read_markers(segs[1:], tcp)
    if not tcp["cod"] or not tcp["qcd"]:
        raise ValueError("JPEG 2000: no COD or QCD marker in the main header")
    ntx, nty = -(-(xsiz - xto) // xt), -(-(ysiz - yto) // yt)
    if ntx * nty > 65535:
        raise ValueError("JPEG 2000: more than 65535 tiles")
    tiles = {}
    while True:
        if pos + 2 > len(cs):
            raise ValueError("JPEG 2000: the codestream ends before its EOC marker (Pillow: "
                             "broken data stream)")
        m = struct.unpack_from(">H", cs, pos)[0]
        if m == _EOC:
            break
        if m != _SOT or pos + 12 > len(cs):     # (a codestream without EOC too)
            raise ValueError("JPEG 2000: expected a tile part (Pillow: broken data stream)")
        lsot, isot, psot, _tpsot, _tnsot = struct.unpack_from(">HHIBB", cs, pos + 2)
        if lsot != 10 or isot >= ntx * nty:
            raise ValueError("JPEG 2000: a bad SOT marker")
        start = pos
        tsegs, pos = _markers(cs, pos + 12, (_SOD,))
        end = start + psot if psot else len(cs) - (2 if cs.endswith(b"\xff\xd9") else 0)
        if end > len(cs) or end < pos + 2:
            raise ValueError("JPEG 2000: a tile part longer than the codestream (Pillow: broken "
                             "data stream)")
        tile = tiles.setdefault(isot, {"tcp": _copy_tcp(tcp), "body": []})
        _read_markers(tsegs, tile["tcp"])
        tile["body"].append(cs[pos + 2:end])
        pos = end
    return dict(size=(xsiz, ysiz), origin=(xo, yo), tile_size=(xt, yt), tile_origin=(xto, yto),
                ntiles=(ntx, nty), comps=[((c[0] & 0x7F) + 1, c[0] >> 7) for c in comps],
                subsampling=[(c[1], c[2]) for c in comps], tiles=tiles)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _tile_boxes(head: dict) -> list:
    """Each tile's index and its area on the reference grid (the image
    area's part of it), for the tiles with a tile part."""
    (xsiz, ysiz), (xo, yo) = head["size"], head["origin"]
    (xt, yt), (xto, yto), (ntx, _) = head["tile_size"], head["tile_origin"], head["ntiles"]
    out = []
    for t in head["tiles"]:
        p, q = t % ntx, t // ntx
        out.append((t, (max(xto + p * xt, xo), max(yto + q * yt, yo),
                        min(xto + (p + 1) * xt, xsiz), min(yto + (q + 1) * yt, ysiz))))
    return out


def _samples(head: dict, packed: bool) -> np.ndarray:
    """The components' decoded samples: int32 [C, H, W] over the image area
    (a tile with no tile part left at 0, as Pillow's image is), or, packed,
    each tile's tile-components one after another at their own sizes."""
    (xsiz, ysiz), (xo, yo) = head["size"], head["origin"]
    comps, subs = head["comps"], head["subsampling"]
    nc, w, h = len(comps), xsiz - xo, ysiz - yo
    boxes = _tile_boxes(head)
    hdr = [nc, xo, yo, w, h, len(head["tiles"]), 0, int(packed)]
    for (prec, sgnd), (dx, dy) in zip(comps, subs):
        hdr += [prec, sgnd, dx, dy]
    bodies, off, total = [], 0, 0
    for t, box in boxes:
        tile = head["tiles"][t]
        tcp = tile["tcp"]
        body = b"".join(tile["body"])
        pocs = tcp["pocs"] or []
        hdr += [*box, off, len(body), tcp["prog"], tcp["layers"], tcp["mct"], tcp["csty"],
                len(pocs)]
        for pc in pocs:
            hdr += pc
        for comp, (dx, dy) in zip(tcp["comps"], subs):
            hdr += [comp["numres"], comp["xcb"], comp["ycb"], comp["reversible"], comp["guard"],
                    comp["style"], comp["roishift"], *(comp["ppx"] + [15] * 33)[:33],
                    *(comp["ppy"] + [15] * 33)[:33], *comp["expn"], *comp["mant"]]
            total += ((_cdiv(box[2], dx) - _cdiv(box[0], dx))
                      * (_cdiv(box[3], dy) - _cdiv(box[1], dy)))
        bodies.append(body)
        off += len(body)
    out = np.zeros(total if packed else (nc, h, w), np.int32)
    if not head["tiles"]:
        return out
    params = np.asarray(hdr, np.int32)
    err = ctypes.create_string_buffer(256)
    body = b"".join(bodies)
    rc = _load().j2k_decode(body, len(body), params.ctypes.data, out.ctypes.data, err, 256)
    if rc == 2:
        raise _png.refusal(f"JPEG 2000 with {err.value.decode()}", "h")
    if rc:
        raise ValueError(f"JPEG 2000: {err.value.decode()} (Pillow: broken data stream)")
    return out


def _shift(word: np.ndarray, prec: int, sgnd: int, bits: int) -> np.ndarray:
    """Pillow's ``j2ku_shift`` of stored words: plus the signed offset and,
    above the target width, half the dropped step, shifted to ``bits`` and
    wrapped to them."""
    shift = bits - prec
    offset = (1 << (prec - 1)) if sgnd else 0
    if shift < 0:
        offset += 1 << (-shift - 1)
    x = (word.astype(np.int64) + offset) & 0xFFFFFFFF
    x = x >> -shift if shift < 0 else (x << shift) & 0xFFFFFFFF
    return (x & ((1 << bits) - 1)).astype(np.uint8 if bits == 8 else np.uint16)


def _csiz(prec: int) -> int:
    """Bytes a sample as OpenJPEG hands a tile over (3 taken as 4)."""
    size = (prec + 7) >> 3
    return 4 if size == 3 else size


def _unpack(v: np.ndarray, prec: int, sgnd: int, bits: int) -> np.ndarray:
    """Pillow's ``j2ku_*`` of one component: its stored bytes (1, 2 or 4
    a sample) through :func:`_shift`."""
    if prec == bits and not sgnd:       # the samples as they are
        return v.astype(np.uint8 if bits == 8 else np.uint16)
    return _shift(v.astype(np.int64) & ((1 << (8 * _csiz(prec))) - 1), prec, sgnd, bits)


# Pillow's unpackers that take sub-sampled components, and their channels
_SUBSAMPLING = {"rgb": 3, "ycc": 3, "rgba": 4, "ycca": 4}


def _pillow_tiles(head: dict, unpacker: str, bits: int) -> np.ndarray:
    """Pillow's decode where a component is sub-sampled (its unpackers
    ``rgb``, ``ycc``, ``rgba`` and ``ycca``): OpenJPEG packs each tile's
    components one after another at their tile-component sizes (``_csiz``
    bytes a sample) into a buffer Pillow has zeroed, and the unpacker reads
    them back at its own layout, giving plane n ``w // dx * (h // dy)``
    samples of the tile's w x h and reading sample ``(y // dy, x // dx)`` of
    it.  The channels :func:`decode_j2k` makes of the samples, tile by
    tile."""
    comps, subs = head["comps"], head["subsampling"]
    (xsiz, ysiz), (xo, yo) = head["size"], head["origin"]
    csiz = [_csiz(p) for p, _ in comps]
    samples = _samples(head, packed=True)
    nch = _SUBSAMPLING[unpacker]
    out = np.zeros((ysiz - yo, xsiz - xo, nch), np.uint16 if bits == 16 else np.uint8)
    at = 0
    for _t, (x0, y0, x1, y1) in _tile_boxes(head):
        w, h = x1 - x0, y1 - y0
        packed = []
        for c, (dx, dy) in enumerate(subs):
            n = (_cdiv(x1, dx) - _cdiv(x0, dx)) * (_cdiv(y1, dy) - _cdiv(y0, dy))
            v = samples[at:at + n].astype("<i4").view(np.uint8).reshape(-1, 4)
            packed.append(v[:, :csiz[c]].reshape(-1))
            at += n
        data = np.concatenate(packed)
        buf = np.zeros(max(data.size, sum(csiz) * w * h), np.uint8)
        buf[:data.size] = data
        y, x = np.mgrid[0:h, 0:w]

        def plane(c, off, idx):
            word = np.zeros(idx.shape, np.int64)
            for k in range(csiz[c]):
                word |= buf[off + csiz[c] * idx + k].astype(np.int64) << (8 * k)
            return _shift(word, *comps[c], bits)

        chans, off = [], 0
        for c in range(nch):
            dx, dy = subs[c]
            chans.append(plane(c, off, (y // dy) * (w // dx) + x // dx))
            off += csiz[c] * (w // dx) * (h // dy)
        tile = np.stack(chans, -1)
        if unpacker.startswith("ycc"):
            tile[..., :3] = _raw._ycbcr_rgb(tile[..., :3])
        out[y0 - yo:y1 - yo, x0 - xo:x1 - xo] = tile
    return out


def _palette_rgba(mode: str, pal: bytes) -> np.ndarray:
    """The 256 RGBA entries of a P image's palette as Pillow's
    ``putpalette`` leaves them: the given ones, opaque black after them."""
    out = np.zeros((256, 4), np.uint8)
    out[:, 3] = 255
    n = len(mode)
    given = np.frombuffer(pal[:len(pal) // n * n], np.uint8).reshape(-1, n)[:256]
    out[:len(given), :n] = given
    return out


def decode_j2k(data: bytes) -> tuple[np.ndarray, int]:
    """The image Pillow loads, as ``convert("RGBA")`` (``convert("I")`` for
    ``I;16``) takes it: uint8 [H, W, C] samples (uint16 gray and depth 16
    for ``I;16``), palettes expanded to RGBA and CMYK converted to RGB."""
    data = bytes(data)
    info = open_j2k(data)
    mode = info["mode"]
    if info["codec"] == "jp2":
        cs, space = _jp2_codestream(data)
    else:
        cs, space = data, None
    head = _main_header(cs)
    comps = head["comps"]
    nc = len(comps)
    subs = head["subsampling"]
    if space is None:       # a raw codestream or no known space: by the components
        space = _GRAY if nc <= 2 else _SRGB
        if nc >= 3 and subs[0] == (1, 1) and subs[1:3] != [(1, 1), (1, 1)]:
            space = _SYCC   # Pillow's guess: full-size luma, sub-sampled chroma
    unpacker = _UNPACKERS.get((mode, space, nc))
    if unpacker is None:
        raise ValueError(f"JPEG 2000: Pillow has no unpacker for {mode} from {nc} components "
                         f"in colour space {space} (broken data stream)")
    (xsiz, ysiz), (xo, yo) = head["size"], head["origin"]
    if (xsiz - xo, ysiz - yo) != info["size"]:
        raise ValueError("JPEG 2000: the JP2 header's size is not the codestream's")
    bits = 16 if unpacker == "i" else 8
    if any(d != (1, 1) for d in subs):
        if unpacker not in _SUBSAMPLING:
            raise ValueError(f"JPEG 2000: Pillow's unpacker for {mode} takes no sub-sampled "
                             "component (broken data stream)")
        out = _pillow_tiles(head, unpacker, bits)
    else:
        v = _samples(head, packed=False)
        planes = [_unpack(v[c], *comps[c], bits) for c in range(min(nc, 4))]
        if unpacker in ("l", "i"):
            out = planes[0][..., None]
        elif unpacker == "la":
            out = np.stack(planes[:2], -1)
        elif unpacker == "gray_rgb":
            out = np.repeat(planes[0][..., None], 3, -1)
        elif unpacker in ("rgb", "ycc"):
            out = np.stack(planes[:3], -1)
            if unpacker == "ycc":
                out = _raw._ycbcr_rgb(out)
        else:       # rgba, ycca (CMYK too)
            out = np.stack(planes[:4], -1)
            if unpacker == "ycca":
                out = np.concatenate([_raw._ycbcr_rgb(out[..., :3]), out[..., 3:]], -1)
    if mode == "CMYK":
        out = _codecs._cmyk_rgb(out)
    elif mode in ("P", "PA"):
        pal = _palette_rgba(*info["palette"]) if info["palette"] else _palette_rgba("RGB", b"")
        rgba = pal[out[..., 0]]
        if mode == "PA":
            rgba[..., 3] = out[..., 1]
        out = rgba
    elif mode == "RGBA" and out.shape[-1] == 3:
        out = np.concatenate([out, np.full(out.shape[:2] + (1,), 255, np.uint8)], -1)
    elif mode == "RGBA" and unpacker == "la":
        out = np.concatenate([np.repeat(out[..., :1], 3, -1), out[..., 1:]], -1)
    return np.ascontiguousarray(out), 16 if mode == "I;16" else 8
