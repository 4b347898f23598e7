"""The port's JPEG codec (``dspfun_tpu_torch/io/jpeg.py`` and
``native/jpeg.cpp``) against Pillow, through which the JAX package reads
and writes JPEG (``dspfun_tpu/io/images.py``).

* Entropy decoding: each component's quantised coefficients equal those
  of a bit-by-bit Huffman reader written here (T.81 F.2.2).
* Decode: ``read_image``'s pixels and depth equal the JAX package's,
  exactly, for Pillow's files at 4:4:4, 4:2:2, 4:2:0 and gray, qualities
  5, 75 and 95, sizes 1x1 to 37x53; with ``optimize=True`` (its own
  Huffman tables) and restart intervals; one 1080p file; and for files
  assembled here from Pillow's coefficients that Pillow cannot write:
  Y at 1x2 (h1v2), a scan per component, SOF1, RGB by Adobe marker or by
  component IDs.
* Encode: ``write_image`` gives the JAX package's bytes over the same
  sizes for flat, noise and saturated images, and a 1080p one; the
  digests ``chip_smoke.py`` holds for its phase 16 images are Pillow's,
  and so are those of phase 17's fixtures (tests/goldens/codec_*, made
  by tests/torch_codec_fixtures.py), which the port decodes.
* Progressive decode: ``read_image`` equals the JAX package's, exactly,
  for Pillow's progressive files at 4:4:4, 4:2:2, 4:2:0 and gray,
  qualities 10, 75 and 95, sizes 1x1, 7x9 and 517x333, with restart
  intervals, with cv2 importable and blocked; its coefficients equal
  those of Pillow's baseline file of the same pixels; and for scripts
  assembled here that Pillow does not write (spectral selection only, DC
  successive approximation, one component per scan in another order, AC
  before DC, an end-of-band run across a restart).
* Progressive files left short (a script that leaves one of a
  component's first ten coefficients short): smoothed as libjpeg-turbo
  smooths them, equal to Pillow's pixels, for assembled scripts at 4:2:0,
  4:4:4, gray and CMYK and for every cut of Pillow's own files.
* CMYK: Pillow's CMYK files, baseline and progressive, at 4:4:4 and
  4:2:0, with restart intervals, as stored (Adobe transform 0), as YCCK
  (transform 2) and without an Adobe marker, read as the JAX package
  reads them, with cv2 importable and blocked; the CMYK fixtures of
  ``chip_smoke.py`` phase 19 are Pillow's.
* No JPEG goes to cv2: a baseline file whose frame says arithmetic coding
  reads as Pillow reads it (arithmetic-coded files:
  tests/test_torch_jpeg_arith.py); 12-bit files are not identified, as in
  Pillow; a truncated or corrupt file raises ``ValueError``.  Lossless
  files: tests/test_torch_jpeg_lossless.py.
"""

import hashlib
import io
import re
import struct
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

import chip_smoke
from dspfun_tpu.io import images as jimages
from dspfun_tpu_torch.io import images as timages
from dspfun_tpu_torch.io import jpeg

ROOT = Path(__file__).resolve().parent.parent

SIZES = [(1, 1), (7, 9), (17, 33), (37, 53)]


def _pil(img, **kw):
    buf = io.BytesIO()
    img.save(buf, format="JPEG", **kw)
    return buf.getvalue()


def _image(h, w, kind="smooth", seed=0):
    rng = np.random.default_rng(seed + 7 * h + w)
    if kind == "noise":
        return rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    if kind == "flat":
        return np.broadcast_to(rng.integers(0, 256, 3).astype(np.uint8), (h, w, 3)).copy()
    if kind == "saturated":
        return (rng.integers(0, 2, (h, w, 3)) * 255).astype(np.uint8)
    y, x = np.mgrid[0:h, 0:w]
    pix = 128 + 90 * np.sin(x[..., None] / 4.0 + y[..., None] / 6.0 + np.arange(3))
    return np.clip(pix + rng.normal(0, 12, (h, w, 3)), 0, 255).astype(np.uint8)


def _same_read(tmp_path, data, name="in.jpg"):
    path = tmp_path / name
    path.write_bytes(data)
    for ch in ("RGB", "RGBA", "I"):
        j, t = jimages.read_image(str(path), channels=ch), timages.read_image(str(path),
                                                                          channels=ch)
        assert t.depth == j.depth == 8
        np.testing.assert_array_equal(t.pixels, j.pixels)


# ---- a second reader and a writer, bit by bit -------------------------------

def _codes(counts, vals):
    """Canonical Huffman codes: {(length, code): value}."""
    out, code, k = {}, 0, 0
    for length, n in enumerate(counts, 1):
        for _ in range(n):
            out[length, code] = vals[k]
            code, k = code + 1, k + 1
        code <<= 1
    return out


def _segments(data):
    """(marker, body, index after the segment, end of its data) up to
    EOI; a scan's data runs to the next marker that is not RSTn."""
    pos = 2
    while True:
        while data[pos] == 0xFF:
            pos += 1
        m = data[pos]
        pos += 1
        if m == 0xD9:
            return
        length = struct.unpack_from(">H", data, pos)[0]
        body = data[pos + 2:pos + length]
        pos += length
        end = pos
        if m == 0xDA:
            while not (data[end] == 0xFF and data[end + 1] not in (0, *range(0xD0, 0xD8))):
                end += 1
        yield m, body, pos, end
        pos = end


def _bits(data):
    """The scan data as '0'/'1' strings, one per restart interval."""
    out, cur, i = [], bytearray(), 0
    while i < len(data):
        if data[i] == 0xFF:
            if data[i + 1] == 0:
                cur.append(0xFF)
                i += 2
                continue
            out.append(cur)
            cur = bytearray()
            i += 2
            continue
        cur.append(data[i])
        i += 1
    out.append(cur)
    return ["".join(f"{b:08b}" for b in part) for part in out]


def _extend(v, s):
    return v - (1 << s) + 1 if v < 1 << (s - 1) else v


def slow_coefficients(data):
    """Each component's coefficients [rows, stride, 64] (natural order,
    whole MCUs), read bit by bit from a sequential Huffman file."""
    tables, restart, comps = {}, 0, None
    for m, body, pos, end in _segments(data):
        if m == 0xC4:
            p = 0
            while p < len(body):
                counts = body[p + 1:p + 17]
                vals = body[p + 17:p + 17 + sum(counts)]
                tables[body[p] >> 4, body[p] & 15] = _codes(counts, vals)
                p += 17 + sum(counts)
        elif m == 0xDD:
            restart = struct.unpack(">H", body)[0]
        elif m in (0xC0, 0xC1):
            h, w, nf = struct.unpack_from(">HHB", body, 1)
            comps = [(body[6 + 3 * i], body[7 + 3 * i] >> 4, body[7 + 3 * i] & 15)
                     for i in range(nf)]
            hmax, vmax = max(c[1] for c in comps), max(c[2] for c in comps)
            mx, my = -(-w // (8 * hmax)), -(-h // (8 * vmax))
            coefs = [np.zeros((my * cv, mx * ch, 64), np.int16) for _, ch, cv in comps]
        elif m == 0xDA:
            ns = body[0]
            members = [[c[0] for c in comps].index(body[1 + 2 * k]) for k in range(ns)]
            tabs = [(tables[0, body[2 + 2 * k] >> 4], tables[1, body[2 + 2 * k] & 15])
                    for k in range(ns)]
            if ns == 1:
                _, ch, cv = comps[members[0]]
                units = [(bx, by) for by in range(-(-h * cv // (8 * vmax)))
                         for bx in range(-(-w * ch // (8 * hmax)))]
                shape = [(1, 1)]
            else:
                units = [(x, y) for y in range(my) for x in range(mx)]
                shape = [(comps[i][1], comps[i][2]) for i in members]
            parts = _bits(data[pos:end])
            per = restart or len(units)
            for part_i, start in enumerate(range(0, len(units), per)):
                bits, at, pred = parts[part_i], 0, [0] * ns

                def take(n):
                    nonlocal at
                    at += n
                    return int(bits[at - n:at], 2) if n else 0

                def symbol(tab):
                    n = 1
                    while (n, int(bits[at:at + n], 2)) not in tab:
                        n += 1
                    return tab[n, take(n)]

                for ux, uy in units[start:start + per]:
                    for k, ci in enumerate(members):
                        ch, cv = shape[k]
                        for by in range(cv):
                            for bx in range(ch):
                                blk = coefs[ci][uy * cv + by, ux * ch + bx]
                                s = symbol(tabs[k][0])
                                pred[k] += _extend(take(s), s) if s else 0
                                blk[0] = pred[k]
                                z = 1
                                while z < 64:
                                    rs = symbol(tabs[k][1])
                                    if rs & 15:
                                        z += rs >> 4
                                        blk[jpeg.ZIGZAG[z]] = _extend(take(rs & 15), rs & 15)
                                    elif rs != 0xF0:
                                        break
                                    else:
                                        z += 15
                                    z += 1
    return coefs


def _huffman_body(blocks, tables):
    """Entropy-coded data of [(block, component slot)] in order, with the
    standard tables of each slot, 1-bit padding and 0xFF00 stuffing."""
    enc = {k: {v: (c, n) for (n, c), v in _codes(*t).items()} for k, t in tables.items()}
    bits, pred = [], {}
    for blk, slot in blocks:
        dc, ac = enc[0, slot], enc[1, slot]
        diff = int(blk[0]) - pred.get(id(dc), 0)
        pred[id(dc)] = int(blk[0])

        def put(code, n):
            bits.append(format(code, f"0{n}b") if n else "")

        def mag(v):
            s = abs(v).bit_length()
            return s, (v if v >= 0 else v + (1 << s) - 1)

        s, v = mag(diff)
        put(*dc[s])
        put(v, s)
        run = 0
        for z in range(1, 64):
            c = int(blk[jpeg.ZIGZAG[z]])
            if c == 0:
                run += 1
                continue
            while run > 15:
                put(*ac[0xF0])
                run -= 16
            s, v = mag(c)
            put(*ac[(run << 4) + s])
            put(v, s)
            run = 0
        if run:
            put(*ac[0])
    s = "".join(bits)
    s += "1" * (-len(s) % 8)
    out = bytearray()
    for i in range(0, len(s), 8):
        out.append(int(s[i:i + 8], 2))
        if out[-1] == 0xFF:
            out.append(0)
    return bytes(out)


def _seg(code, body):
    return bytes([0xFF, code]) + struct.pack(">H", len(body) + 2) + body


def assemble(h, w, comps, qtables, coefs, scans, sof=0xC0, app=b""):
    """A sequential file of given coefficients: comps [(id, h, v, tq)],
    qtables {tq: natural order}, scans [[component index, ...]] (slot 0
    tables for the first component, slot 1 for the others)."""
    hmax, vmax = max(c[1] for c in comps), max(c[2] for c in comps)
    mx, my = -(-w // (8 * hmax)), -(-h // (8 * vmax))
    out = b"\xff\xd8" + app
    for t, q in qtables.items():
        out += _seg(0xDB, bytes([t]) + bytes(np.asarray(q)[list(jpeg.ZIGZAG)].astype(np.uint8)))
    out += _seg(sof, struct.pack(">BHHB", 8, h, w, len(comps))
                + b"".join(bytes([cid, 16 * ch + cv, tq]) for cid, ch, cv, tq in comps))
    for idx in (0, 1):
        for cls in (0, 1):
            counts, vals = jpeg.STD_HUFFMAN[cls, idx]
            out += _seg(0xC4, bytes([16 * cls + idx]) + counts + vals)
    for members in scans:
        slot = {ci: int(ci > 0) for ci in members}
        out += _seg(0xDA, bytes([len(members)]) + b"".join(
            bytes([comps[ci][0], 17 * slot[ci]]) for ci in members) + bytes([0, 63, 0]))
        blocks = []
        if len(members) == 1:
            ci = members[0]
            _, ch, cv, _ = comps[ci]
            for by in range(-(-h * cv // (8 * vmax))):
                for bx in range(-(-w * ch // (8 * hmax))):
                    blocks.append((coefs[ci][by, bx], slot[ci]))
        else:
            for y in range(my):
                for x in range(mx):
                    for ci in members:
                        _, ch, cv, _ = comps[ci]
                        for by in range(cv):
                            for bx in range(ch):
                                blocks.append((coefs[ci][y * cv + by, x * ch + bx], slot[ci]))
        tables = {(cls, idx): jpeg.STD_HUFFMAN[cls, idx] for cls in (0, 1) for idx in (0, 1)}
        out += _huffman_body(blocks, tables)
    return out + b"\xff\xd9"


def _quant(data):
    qt = {}
    for m, body, _, _ in _segments(data):
        if m == 0xDB:
            q = np.zeros(64, np.int64)
            q[list(jpeg.ZIGZAG)] = np.frombuffer(body, np.uint8, 64, 1)
            qt[body[0] & 15] = q
    return qt


def _transposed_h1v2(h, w, quality):
    """Y at 1x2, Cb and Cr at 1x1: Pillow's 4:2:2 file of the transposed
    image, every block and table transposed (a lossless transpose)."""
    a = _image(w, h)            # [w, h, 3]: its transpose is [h, w]
    src = _pil(Image.fromarray(a), subsampling=1, quality=quality)
    t = np.arange(64).reshape(8, 8).T.reshape(64)
    coefs = [np.ascontiguousarray(c.transpose(1, 0, 2)[..., t]) for c in slow_coefficients(src)]
    qt = {k: q[t] for k, q in _quant(src).items()}
    return assemble(h, w, [(1, 1, 2, 0), (2, 1, 1, 1), (3, 1, 1, 1)], qt, coefs, [[0, 1, 2]])


# ---- decode ---------------------------------------------------------------

COEF_CASES = [("420", {}), ("gray", {}), ("restart", {"restart_marker_blocks": 3}),
              ("optimize", {"optimize": True, "subsampling": 1})]


@pytest.mark.parametrize("name,kw", COEF_CASES, ids=[c[0] for c in COEF_CASES])
def test_entropy_decoding_equals_a_bit_by_bit_reader(name, kw):
    img = Image.fromarray(_image(37, 53))
    data = _pil(img.convert("L") if name == "gray" else img, quality=90, **kw)
    frame, coefs = jpeg.decode_coefficients(data)
    want = slow_coefficients(data)
    assert len(coefs) == len(want) == len(frame.components)
    for got, ref in zip(coefs, want):
        np.testing.assert_array_equal(got, ref)


DECODE_CASES = [(sub, q, hw) for sub in ("444", "422", "420", "h1v2", "gray")
                for q in (5, 75, 95) for hw in SIZES]


@pytest.mark.parametrize("sub,quality,hw", DECODE_CASES)
def test_decode_equals_pillow(sub, quality, hw, tmp_path):
    h, w = hw
    if sub == "h1v2":
        data = _transposed_h1v2(h, w, quality)
        assert jpeg.decode_coefficients(data)[0].components[0].v == 2
    else:
        img = Image.fromarray(_image(h, w, seed=quality))
        if sub == "gray":
            data = _pil(img.convert("L"), quality=quality)
        else:
            data = _pil(img, quality=quality, subsampling={"444": 0, "422": 1, "420": 2}[sub])
    _same_read(tmp_path, data)


OPTION_CASES = [(opt, hw) for opt in ("optimize", "restart_marker_blocks", "restart_marker_rows")
                for hw in SIZES]


@pytest.mark.parametrize("opt,hw", OPTION_CASES)
def test_decode_with_custom_tables_and_restarts(opt, hw, tmp_path):
    kw = {"optimize": True} if opt == "optimize" else {opt: 1}
    _same_read(tmp_path, _pil(Image.fromarray(_image(*hw, kind="noise")), **kw))


def test_decode_1080p_equals_pillow(tmp_path):
    data = _pil(Image.fromarray(_image(1080, 1920)), quality=90)
    got, depth = jpeg.decode_jpeg(data)
    assert depth == 8
    np.testing.assert_array_equal(got, np.asarray(Image.open(io.BytesIO(data)).convert("RGB")))
    _same_read(tmp_path, data)


def _layouts(h, w):
    """Files Pillow reads but does not write, from its 4:2:0 and 4:4:4
    coefficients."""
    img = Image.fromarray(_image(h, w))
    f420, f444 = _pil(img), _pil(img, subsampling=0)
    c420, c444 = slow_coefficients(f420), slow_coefficients(f444)
    ycc = [(1, 2, 2, 0), (2, 1, 1, 1), (3, 1, 1, 1)]
    rgb = [(1, 1, 1, 0), (2, 1, 1, 1), (3, 1, 1, 1)]
    adobe = _seg(0xEE, b"Adobe" + bytes([0, 100, 0, 0, 0, 0, 0]))
    return {
        "scan per component": assemble(h, w, ycc, _quant(f420), c420, [[0], [1], [2]]),
        "two scans": assemble(h, w, ycc, _quant(f420), c420, [[0], [1, 2]]),
        "SOF1": assemble(h, w, ycc, _quant(f420), c420, [[0, 1, 2]], sof=0xC1),
        "RGB by Adobe": assemble(h, w, rgb, _quant(f444), c444, [[0, 1, 2]], app=adobe),
        "RGB by IDs": assemble(h, w, [(82, 1, 1, 0), (71, 1, 1, 1), (66, 1, 1, 1)],
                               _quant(f444), c444, [[0, 1, 2]]),
    }


@pytest.mark.parametrize("layout", ["scan per component", "two scans", "SOF1", "RGB by Adobe",
                                    "RGB by IDs"])
@pytest.mark.parametrize("hw", [(17, 33), (37, 53)])
def test_decode_of_layouts_pillow_does_not_write(layout, hw, tmp_path):
    data = _layouts(*hw)[layout]
    frame = jpeg.decode_coefficients(data)[0]
    assert frame.colorspace == (jpeg._RGB if layout.startswith("RGB") else jpeg._YCC)
    _same_read(tmp_path, data)


# ---- encode ---------------------------------------------------------------

ENCODE_CASES = [(kind, hw) for kind in ("flat", "noise", "saturated", "smooth") for hw in SIZES]


@pytest.mark.parametrize("kind,hw", ENCODE_CASES)
def test_encode_equals_pillow(kind, hw, tmp_path):
    pix = _image(*hw, kind=kind) / 255.0
    for name, mod in (("jax", jimages), ("torch", timages)):
        mod.write_image(str(tmp_path / f"{name}.jpg"), pix)
    assert (tmp_path / "torch.jpg").read_bytes() == (tmp_path / "jax.jpg").read_bytes()


def test_encode_1080p_equals_pillow():
    a = _image(1080, 1920)
    assert jpeg.encode_jpeg(a) == _pil(Image.fromarray(a))


@pytest.mark.parametrize("index", [0, 1])
def test_chip_smoke_digests_are_pillows(index, tmp_path):
    """Phase 16(a)'s constants: Pillow's file and Pillow's decode of it
    for the seeded image, and the port's bytes equal to them here."""
    hw, seed = chip_smoke.JPEG_IMAGES[index]
    pix = chip_smoke._seeded_pixels(hw, seed)
    jimages.write_image(str(tmp_path / "j.jpg"), pix)
    data = (tmp_path / "j.jpg").read_bytes()
    decoded = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    want = chip_smoke.JPEG_DIGESTS[tuple(hw)]
    assert (hashlib.sha256(data).hexdigest(), hashlib.sha256(decoded.tobytes()).hexdigest()) \
        == want
    timages.write_image(str(tmp_path / "t.jpg"), pix)
    assert (tmp_path / "t.jpg").read_bytes() == data


# ---- progressive --------------------------------------------------------------

# tables that code every value: DC 0..15 (15 codes of 4 bits, 1 of 5), AC
# 0..255 (255 of 8 bits, 1 of 9), so any script's symbols have a code
ANY_DC = (bytes([0, 0, 0, 15, 1] + [0] * 11), bytes(range(16)))
ANY_AC = (bytes([0] * 7 + [255, 1] + [0] * 7), bytes(range(256)))


def _units(h, w, comps, members):
    """The blocks of a scan's MCUs in order, [(slot, row, column)] each."""
    hmax, vmax = max(c[1] for c in comps), max(c[2] for c in comps)
    if len(members) == 1:
        _, ch, cv, _ = comps[members[0]]
        bw, bh = -(-w * ch // (8 * hmax)), -(-h * cv // (8 * vmax))
        return [[(0, by, bx)] for by in range(bh) for bx in range(bw)]
    mx, my = -(-w // (8 * hmax)), -(-h // (8 * vmax))
    return [[(k, y * comps[ci][2] + by, x * comps[ci][1] + bx) for k, ci in enumerate(members)
             for by in range(comps[ci][2]) for bx in range(comps[ci][1])]
            for y in range(my) for x in range(mx)]


def _progressive_scan(h, w, comps, coefs, members, ss, se, ah, al, restart, eob_extra):
    """One scan's entropy-coded data as jcphuff.c writes a DC first
    pass, a DC refinement or an AC first pass, with RSTn markers; at
    each restart the pending end-of-band run is written ``eob_extra``
    longer than the blocks it covers (the decoder resets it there)."""
    dc = {v: (c, n) for (n, c), v in _codes(*ANY_DC).items()}
    ac = {v: (c, n) for (n, c), v in _codes(*ANY_AC).items()}
    parts, bits = [], []
    st = {"pred": [0] * len(members), "eob": 0}

    def put(v, n):
        if n:
            bits.append(format(v & ((1 << n) - 1), f"0{n}b"))

    def flush_eob(extra=0):
        run = st["eob"] + (extra if st["eob"] else 0)
        if run:
            nb = run.bit_length() - 1
            put(*ac[nb << 4])
            put(run, nb)
        st["eob"] = 0

    def end_interval(extra=0):
        flush_eob(extra)
        s = "".join(bits)
        s += "1" * (-len(s) % 8)
        out = bytearray()
        for i in range(0, len(s), 8):
            out.append(int(s[i:i + 8], 2))
            if out[-1] == 0xFF:
                out.append(0)
        parts.append(bytes(out))
        bits.clear()
        st["pred"] = [0] * len(members)

    for u, unit in enumerate(_units(h, w, comps, members)):
        if restart and u and u % restart == 0:
            end_interval(eob_extra)
        for k, by, bx in unit:
            blk = coefs[members[k]][by, bx]
            if ss == 0 and ah == 0:
                t = int(blk[0]) >> al
                diff, st["pred"][k] = t - st["pred"][k], t
                nb = abs(diff).bit_length()
                put(*dc[nb])
                put(diff if diff >= 0 else diff - 1, nb)
            elif ss == 0:
                put((int(blk[0]) >> al) & 1, 1)
            else:
                r = 0
                for z in range(ss, se + 1):
                    v = int(blk[jpeg.ZIGZAG[z]])
                    t = abs(v) >> al
                    if t == 0:
                        r += 1
                        continue
                    flush_eob()
                    while r > 15:
                        put(*ac[0xF0])
                        r -= 16
                    nb = t.bit_length()
                    put(*ac[(r << 4) + nb])
                    put(t if v >= 0 else ~t, nb)
                    r = 0
                if r:
                    st["eob"] += 1
    end_interval()
    return b"".join(p + (bytes([0xFF, 0xD0 + i % 8]) if i < len(parts) - 1 else b"")
                    for i, p in enumerate(parts))


def assemble_progressive(h, w, comps, qtables, coefs, script, restart=0, eob_extra=0,
                         dc_table=True):
    """A progressive file of given coefficients: ``script`` [(component
    indices, Ss, Se, Ah, Al)] with no AC refinement; table slot 0 for
    every scan (no DC table defined with ``dc_table=False``)."""
    out = b"\xff\xd8"
    for t, q in qtables.items():
        out += _seg(0xDB, bytes([t]) + bytes(np.asarray(q)[list(jpeg.ZIGZAG)].astype(np.uint8)))
    out += _seg(0xC2, struct.pack(">BHHB", 8, h, w, len(comps))
                + b"".join(bytes([cid, 16 * ch + cv, tq]) for cid, ch, cv, tq in comps))
    if dc_table:
        out += _seg(0xC4, bytes([0x00]) + ANY_DC[0] + ANY_DC[1])
    out += _seg(0xC4, bytes([0x10]) + ANY_AC[0] + ANY_AC[1])
    if restart:
        out += _seg(0xDD, struct.pack(">H", restart))
    for members, ss, se, ah, al in script:
        out += _seg(0xDA, bytes([len(members)]) + b"".join(bytes([comps[ci][0], 0])
                                                           for ci in members)
                    + bytes([ss, se, 16 * ah + al]))
        out += _progressive_scan(h, w, comps, coefs, members, ss, se, ah, al, restart,
                                 eob_extra)
    return out + b"\xff\xd9"


SCRIPTS = {
    "spectral selection": [((0, 1, 2), 0, 0, 0, 0)] + [((c,), 1, 5, 0, 0) for c in range(3)]
    + [((c,), 6, 63, 0, 0) for c in range(3)],
    "DC successive approximation": [((0, 1, 2), 0, 0, 0, 1)]
    + [((c,), 1, 63, 0, 0) for c in range(3)] + [((0, 1, 2), 0, 0, 1, 0)],
    "a scan per component, reordered": [((2,), 0, 0, 0, 0), ((0,), 0, 0, 0, 0),
                                        ((1,), 0, 0, 0, 0), ((1,), 1, 63, 0, 0),
                                        ((2,), 1, 63, 0, 0), ((0,), 1, 63, 0, 0)],
    "AC before DC": [((0,), 1, 63, 0, 0), ((0, 1, 2), 0, 0, 0, 0), ((1,), 1, 63, 0, 0),
                     ((2,), 1, 63, 0, 0)],
}


def _source(h, w, gray=False, quality=75):
    """Pillow's baseline file of a seeded image, its layout, tables and
    coefficients (the port's decode, held to the bit-by-bit reader)."""
    img = Image.fromarray(_image(h, w))
    data = _pil(img.convert("L") if gray else img, quality=quality)
    frame, coefs = jpeg.decode_coefficients(data)
    comps = [(c.id, c.h, c.v, c.tq) for c in frame.components]
    return data, comps, _quant(data), coefs


def _script(name, ncomp):
    if ncomp == 3:
        return SCRIPTS[name]
    out = []
    for members, *rest in SCRIPTS[name]:
        if 0 in members and (0,) + tuple(rest) not in [(m[0],) + tuple(r) for m, *r in out]:
            out.append(((0,), *rest))
    return out


PROG_CASES = [(sub, q, hw) for sub in ("444", "422", "420", "gray") for q in (10, 75, 95)
              for hw in ((1, 1), (7, 9), (333, 517))]


@pytest.mark.parametrize("sub,quality,hw", PROG_CASES)
def test_progressive_decode_equals_pillow(sub, quality, hw, tmp_path, monkeypatch):
    """Pillow's progressive files (libjpeg's simple progression: DC and AC
    first passes and refinements, end-of-band runs), read as the JAX
    package reads them, with cv2 importable and with it blocked."""
    img = Image.fromarray(_image(*hw, seed=quality))
    if sub == "gray":
        data = _pil(img.convert("L"), quality=quality, progressive=True)
    else:
        data = _pil(img, quality=quality, progressive=True,
                    subsampling={"444": 0, "422": 1, "420": 2}[sub])
    assert jpeg.decode_coefficients(data)[0].marker == 0xC2
    assert timages._decoder(data) is jpeg.decode_jpeg
    _same_read(tmp_path, data)
    monkeypatch.setitem(sys.modules, "cv2", None)
    _same_read(tmp_path, data)


@pytest.mark.parametrize("opt", ["restart_marker_blocks", "restart_marker_rows"])
@pytest.mark.parametrize("sub", [0, 2])
def test_progressive_decode_with_restarts(opt, sub, tmp_path):
    """Restart intervals reset the DC predictors and end-of-band runs."""
    for hw in ((7, 9), (37, 53)):
        img = Image.fromarray(_image(*hw, kind="noise"))
        _same_read(tmp_path, _pil(img, progressive=True, subsampling=sub, **{opt: 1}))


@pytest.mark.parametrize("gray", [False, True])
def test_progressive_coefficients_equal_the_baseline_files(gray):
    """Pillow's progressive and baseline files of the same pixels hold the
    same quantised coefficients: the scans refine them to full precision."""
    img = Image.fromarray(_image(61, 83))
    img = img.convert("L") if gray else img
    fb, cb = jpeg.decode_coefficients(_pil(img, quality=90))
    fp, cp = jpeg.decode_coefficients(_pil(img, quality=90, progressive=True))
    assert (fp.marker, fb.marker) == (0xC2, 0xC0) and not fp.smoothed
    for a, b in zip(cp, cb):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("script", list(SCRIPTS))
@pytest.mark.parametrize("gray", [False, True])
def test_assembled_progressive_scripts(script, gray, tmp_path, monkeypatch):
    """Scripts Pillow does not write, from its baseline coefficients, at
    4:2:0 and gray, without and with restart intervals (one with
    end-of-band runs written past the interval's end): the coefficients
    come back whole (those of the image's blocks: a scan of one component
    leaves an interleaved scan's dummy blocks out) and the pixels are
    Pillow's."""
    h, w = 37, 53
    base, comps, qt, coefs = _source(h, w, gray)
    for kw in ({}, {"restart": 2}, {"restart": 3, "eob_extra": 5}):
        data = assemble_progressive(h, w, comps, qt, coefs, _script(script, len(comps)), **kw)
        frame, got = jpeg.decode_coefficients(data)
        assert not frame.smoothed
        for c, a, b in zip(frame.components, got, coefs):
            np.testing.assert_array_equal(a[:c.blocks_h, :c.blocks_w],
                                          b[:c.blocks_h, :c.blocks_w])
        _same_read(tmp_path, data)
        with monkeypatch.context() as mp:
            mp.setitem(sys.modules, "cv2", None)
            _same_read(tmp_path, data)


def _short_files():
    """Progressive files whose scans leave coefficients short: the DC band
    alone, and Pillow's own file without its last scan (luma's last
    refinement)."""
    h, w = 37, 53
    _, comps, qt, coefs = _source(h, w)
    dc_only = assemble_progressive(h, w, comps, qt, coefs, [((0, 1, 2), 0, 0, 0, 0)])
    full = _pil(Image.fromarray(_image(h, w)), progressive=True)
    last = full.rindex(b"\xff\xda")
    return {"DC only": dc_only, "without the last scan": full[:last] + b"\xff\xd9"}


def _short_source(kind, h, w):
    """The layout, tables and coefficients of Pillow's baseline file of a
    seeded image: 4:2:0, 4:4:4, gray or CMYK."""
    img = Image.fromarray(_image(h, w))
    data = {"420": lambda: _pil(img), "444": lambda: _pil(img, subsampling=0),
            "gray": lambda: _pil(img.convert("L")),
            "cmyk": lambda: _pil(img.convert("CMYK"))}[kind]()
    frame, coefs = jpeg.decode_coefficients(data)
    return [(c.id, c.h, c.v, c.tq) for c in frame.components], _quant(data), coefs


def _short_script(name, n):
    """A progressive script [(components, Ss, Se, Ah, Al)] that leaves
    coefficients short, for n components."""
    every = tuple(range(n))
    dc = [(every, 0, 0, 0, 0)]
    return {"DC": dc,
            "DC at Al 1": [(every, 0, 0, 0, 1)],
            "spectral 1-5": dc + [((c,), 1, 5, 0, 0) for c in range(n)],
            "spectral 1-2": dc + [((c,), 1, 2, 0, 0) for c in range(n)],
            "AC at Al 2": dc + [((c,), 1, 63, 0, 2) for c in range(n)],
            "AC at Al 1, DC at Al 1": [(every, 0, 0, 0, 1)] + [((c,), 1, 63, 0, 1)
                                                               for c in range(n)],
            "luma's AC alone": dc + [((0,), 1, 63, 0, 0)]}[name]


# name -> (layout, (h, w), script, restart interval in MCUs)
SHORT_CASES = {
    "4:2:0 DC at Al 1": ("420", (37, 53), "DC at Al 1", 0),
    "4:2:0 spectral 1-2, 17x9": ("420", (17, 9), "spectral 1-2", 0),
    "4:2:0 AC at Al 2, 49x23": ("420", (49, 23), "AC at Al 2", 0),
    "4:2:0 restarts, AC at Al 2": ("420", (37, 53), "AC at Al 2", 2),
    "4:2:0 restarts, DC": ("420", (33, 41), "DC", 3),
    "4:2:0 one block wide": ("420", (40, 8), "DC", 0),
    "4:2:0 one block tall": ("420", (8, 40), "spectral 1-2", 0),
    "4:2:0 luma's AC alone": ("420", (24, 16), "luma's AC alone", 0),
    "4:4:4 spectral 1-5": ("444", (17, 9), "spectral 1-5", 0),
    "4:4:4 spectral 1-2, restarts": ("444", (37, 53), "spectral 1-2", 5),
    "4:4:4 one block tall": ("444", (8, 40), "AC at Al 1, DC at Al 1", 0),
    "gray AC at Al 2": ("gray", (33, 41), "AC at Al 2", 0),
    "gray DC, one block": ("gray", (8, 8), "DC", 0),
    "gray one block wide": ("gray", (70, 9), "spectral 1-2", 0),
    "gray 1x1": ("gray", (1, 1), "DC at Al 1", 0),
    "CMYK spectral 1-2": ("cmyk", (16, 24), "spectral 1-2", 0),
    "CMYK DC, restarts": ("cmyk", (23, 31), "DC", 2),
}


@pytest.mark.parametrize("case", ["DC only", "without the last scan", *SHORT_CASES])
def test_progressive_files_left_short_are_refused(case, tmp_path, monkeypatch):
    """Files whose scans leave one of a component's first ten coefficients
    short, which libjpeg-turbo smooths (jdcoefct.c smoothing_ok,
    decompress_smooth_data) and which the port once refused (item 8g):
    their pixels are Pillow's, with cv2 importable and blocked, through
    the port's own decoder, and not the plain reconstruction of the
    coefficients where smoothing changes them.  Cases: the DC band alone
    and Pillow's file without its last scan, and assembled scripts at
    4:2:0, 4:4:4, gray and CMYK with restart intervals, unrefined Al > 0
    bands, spectral selection alone, sizes that are not a multiple of the
    MCU and images one block wide or tall."""
    if case in SHORT_CASES:
        kind, (h, w), script, restart = SHORT_CASES[case]
        comps, qt, coefs = _short_source(kind, h, w)
        data = assemble_progressive(h, w, comps, qt, coefs, _short_script(script, len(comps)),
                                    restart=restart)
    else:
        data = _short_files()[case]
    frame, coefs = jpeg.decode_coefficients(data)
    assert frame.smoothed and len(frame.latch) == 10 * len(frame.components)
    assert timages._decoder(data) is jpeg.decode_jpeg
    pillow = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    got = jpeg.decode_jpeg(data)[0]
    np.testing.assert_array_equal(np.broadcast_to(got, pillow.shape), pillow)
    if case in ("DC only", "without the last scan"):
        assert not np.array_equal(jpeg.reconstruct(frame, coefs), got)
    _same_read(tmp_path, data)
    monkeypatch.setitem(sys.modules, "cv2", None)
    _same_read(tmp_path, data)


def test_smoothing_reads_an_interleaved_scans_padding_rows(tmp_path):
    """libjpeg-turbo counts the last iMCU row's block rows into its edge
    tests for that row alone: a luma row of an earlier iMCU row at 4:2:0
    reads the padding row below the image (an interleaved DC scan's dummy
    blocks) as a neighbour, and a row of the last one stops short.  With
    the padding rows' DC values changed the pixels stay Pillow's."""
    for h, w in ((17, 9), (33, 41), (49, 23)):
        comps, qt, coefs = _short_source("420", h, w)
        frame = jpeg.decode_coefficients(_pil(Image.fromarray(_image(h, w))))[0]
        c = frame.components[0]
        assert c.rows > c.blocks_h
        coefs = [k.copy() for k in coefs]
        coefs[0][c.blocks_h:, :, 0] += 37
        data = assemble_progressive(h, w, comps, qt, coefs, _short_script("DC", 3))
        pillow = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
        np.testing.assert_array_equal(jpeg.decode_jpeg(data)[0], pillow)


def test_every_cut_of_pillows_progressive_files(tmp_path):
    """Pillow's progressive files (4:2:0, 4:4:4, 4:2:2, gray, CMYK, with
    and without restarts) cut after each of their scans: each cut that
    libjpeg smooths reads to Pillow's pixels (only the last latch applies:
    Pillow reads every scan before its output pass)."""
    seen = 0
    for h, w in ((37, 53), (9, 70)):
        img = Image.fromarray(_image(h, w))
        for mode, kw in (("L", {}), ("RGB", {"subsampling": 2}), ("RGB", {"subsampling": 0}),
                         ("RGB", {"subsampling": 1}), ("CMYK", {}),
                         ("RGB", {"subsampling": 2, "restart_marker_blocks": 2})):
            full = _pil(img.convert(mode), quality=60, progressive=True, **kw)
            at = [m.start() for m in re.finditer(b"\xff\xda", full)]
            for k in at[1:]:
                data = full[:k] + b"\xff\xd9"
                if not jpeg.decode_coefficients(data)[0].smoothed:
                    continue
                seen += 1
                want = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
                got = jpeg.decode_jpeg(data)[0]
                np.testing.assert_array_equal(np.broadcast_to(got, want.shape), want)
    assert seen > 50


def test_bad_progressive_files_raise(tmp_path):
    """A progressive scan with no DC table defined (libjpeg has no default
    table for it), bad progression parameters (an AC band of two
    components, Ss > Se, Al above 13) and a truncated file raise in both
    packages."""
    h, w = 17, 33
    _, comps, qt, coefs = _source(h, w)
    script = SCRIPTS["spectral selection"]
    bad = {"no DC table": assemble_progressive(h, w, comps, qt, coefs, script, dc_table=False)}
    good = assemble_progressive(h, w, comps, qt, coefs, script)
    sos = good.index(b"\xff\xda", good.index(b"\xff\xda") + 2)   # the first AC scan
    for name, (at, val) in {"two-component AC band": (4, b"\x02\x01\x00\x02\x00"),
                            "Ss above Se": (7, b"\x05\x01"),
                            "Al above 13": (9, b"\x0e")}.items():
        d = bytearray(good)
        if name == "two-component AC band":
            seg = bytes([0xFF, 0xDA, 0, 12, 2, 1, 0, 2, 0, 1, 5, 0])
            d[sos:sos + 10] = seg
        else:
            d[sos + at:sos + at + len(val)] = val
        bad[name] = bytes(d)
    bad["truncated"] = _pil(Image.fromarray(_image(37, 53, kind="noise")),
                            progressive=True)[:1500]
    for name, d in bad.items():
        path = tmp_path / "in.jpg"
        path.write_bytes(d)
        with pytest.raises(OSError):
            jimages.read_image(str(path))
        with pytest.raises(ValueError):
            timages.read_image(str(path))


def test_codec_fixtures_are_pillows():
    """Phase 17(a)'s fixtures: remade with Pillow by
    tests/torch_codec_fixtures.py they equal the committed files, and the
    sha256 of each file and of Pillow's decode of it are
    ``chip_smoke.CODEC_FIXTURES``."""
    from tests import torch_codec_fixtures as fx

    made = fx.fixtures()
    assert sorted(made) == sorted(chip_smoke.CODEC_FIXTURES)
    for name, data in made.items():
        assert (fx.GOLDENS / name).read_bytes() == data, name
        assert fx.digests(data) == chip_smoke.CODEC_FIXTURES[name], name


@pytest.mark.parametrize("name", sorted(chip_smoke.CODEC_FIXTURES))
def test_codec_fixtures_decode_as_pillow(name, tmp_path, monkeypatch):
    """Each committed fixture, with cv2 blocked: the codec ``read_image``
    picks for it is the port's own, its samples hash to Pillow's decode
    of it, and ``read_image`` equals the JAX package's."""
    from dspfun_tpu_torch.io import imgcodecs

    from tests import torch_codec_fixtures as fx

    monkeypatch.setitem(sys.modules, "cv2", None)
    data = (fx.GOLDENS / name).read_bytes()
    decode = jpeg.decode_jpeg if name.endswith(".jpg") else imgcodecs.decode_tiff
    assert timages._decoder(data) is decode
    arr, _ = decode(data)
    assert hashlib.sha256(arr.tobytes()).hexdigest() == chip_smoke.CODEC_FIXTURES[name][1]
    if name != "codec_prog_4k.jpg":
        _same_read(tmp_path, data, name)


# ---- what the codec does not carry -------------------------------------------

def _not_carried(kind):
    img = Image.fromarray(_image(16, 24))
    if kind == "progressive":
        return _pil(img, progressive=True)
    if kind == "CMYK":
        return _pil(img.convert("CMYK"))
    data = bytearray(_pil(img))
    sof = data.index(b"\xff\xc0")
    if kind == "arithmetic":
        data[sof + 1] = 0xC9
    else:                                   # 12-bit samples
        data[sof + 4] = 12
    return bytes(data)


@pytest.mark.parametrize("kind", ["progressive", "arithmetic", "12-bit", "CMYK"])
def test_what_the_codec_does_not_carry_goes_to_cv2(kind, tmp_path, monkeypatch):
    """No JPEG goes to cv2 any more.  A 12-bit frame, which went to cv2
    too, is no JPEG to Pillow's plugin (its SOF handler raises): both
    packages raise "cannot identify image file", with cv2 importable and
    blocked.  Progressive and CMYK files, and a baseline file whose frame
    header says arithmetic coding (SOF9: its Huffman data decoded as
    arithmetic-coded data, garbage that Pillow reads alike), which went to
    cv2 before the codec carried them, read as the JAX package reads them
    through the port's own decoder, with cv2 importable and blocked."""
    data = _not_carried(kind)
    path = tmp_path / "in.jpg"
    path.write_bytes(data)
    if kind == "12-bit":
        with pytest.raises(ValueError, match="cannot identify image file"):
            jpeg.decode_jpeg(data)
        for blocked in (False, True):
            with monkeypatch.context() as mp:
                if blocked:
                    mp.setitem(sys.modules, "cv2", None)
                with pytest.raises(OSError, match="cannot identify image file"):
                    jimages.read_image(str(path))
                with pytest.raises(ValueError, match="cannot identify image file .*12-bit"):
                    timages.read_image(str(path))
        return
    assert timages._decoder(data) is jpeg.decode_jpeg
    if kind == "arithmetic":
        assert jpeg.decode_coefficients(data)[0].arithmetic

    def no_cv2(d, name):
        raise AssertionError("a JPEG reached cv2")

    monkeypatch.setattr(timages, "_cv2_decode", no_cv2)
    _same_read(tmp_path, data)
    monkeypatch.setitem(sys.modules, "cv2", None)
    _same_read(tmp_path, data)


@pytest.mark.parametrize("cut", [0.3, 0.9])
def test_truncated_files_raise(cut, tmp_path):
    data = _pil(Image.fromarray(_image(37, 53, kind="noise")))
    short = data[:int(len(data) * cut)]
    path = tmp_path / "in.jpg"
    path.write_bytes(short)
    with pytest.raises(OSError):
        jimages.read_image(str(path))
    with pytest.raises(ValueError, match="truncated"):
        timages.read_image(str(path))


def test_corrupt_files_raise():
    data = _pil(Image.fromarray(_image(17, 33)), restart_marker_blocks=1)
    rst = data.index(b"\xff\xd1")
    bad = {
        "no SOI": data[2:],
        "restart out of order": data[:rst + 1] + b"\xd5" + data[rst + 2:],
        "bad table": data.replace(b"\xff\xc4\x00\x1f\x00\x00", b"\xff\xc4\x00\x1f\x00\x09", 1),
        "unknown marker": data[:2] + b"\xff\xc8\x00\x02" + data[2:],
        "no frame": data[:2] + data[data.index(b"\xff\xda"):],
    }
    for name, d in bad.items():
        with pytest.raises(ValueError):
            jpeg.decode_jpeg(d)
    with pytest.raises(ValueError, match="uint8 RGB"):
        jpeg.encode_jpeg(np.zeros((4, 4, 4), np.uint8))


def _islow_pass(v, shift):
    """One pass of jidctint.c's islow IDCT on int64 [..., 8]: its eight
    outputs descaled by ``shift``, and the sums libjpeg-turbo's SIMD build
    holds in 16-bit lanes."""
    z2, z3 = v[..., 2], v[..., 6]
    sums = [z2 + z3, v[..., 0] + v[..., 4], v[..., 0] - v[..., 4]]
    z1 = (z2 + z3) * 4433
    t2, t3 = z1 - z3 * 15137, z1 + z2 * 6270
    t0, t1 = (v[..., 0] + v[..., 4]) * 8192, (v[..., 0] - v[..., 4]) * 8192
    t10, t13, t11, t12 = t0 + t3, t0 - t3, t1 + t2, t1 - t2
    a0, a1, a2, a3 = v[..., 7], v[..., 5], v[..., 3], v[..., 1]
    z1, z2, z3, z4 = a0 + a3, a1 + a2, a0 + a2, a1 + a3
    sums += [z1, z2, z3, z4, z3 + z4]
    z5 = (z3 + z4) * 9633
    z3, z4 = z3 * -16069 + z5, z4 * -3196 + z5
    z1, z2 = z1 * -7373, z2 * -20995
    a0, a1 = a0 * 2446 + z1 + z3, a1 * 16819 + z2 + z4
    a2, a3 = a2 * 25172 + z2 + z3, a3 * 12299 + z1 + z4
    out = np.stack([t10 + a3, t11 + a2, t12 + a1, t13 + a0,
                    t13 - a0, t12 - a1, t11 - a2, t10 - a3], -1)
    if shift:
        out = (out + (1 << (shift - 1))) >> shift
    return out, np.stack(sums, -1)


def _simd_safe(dq):
    """Per block of dequantised coefficients int64 [N, 8, 8]: whether
    every product, sum and pass-1 output stays within 16 bits and every
    output within the range-limit table's wrap (where libjpeg-turbo's
    SIMD and C IDCTs agree)."""
    fits = lambda a: ((a >= -32768) & (a <= 32767)).reshape(len(a), -1).all(1)  # noqa: E731
    cols, sums1 = _islow_pass(dq.transpose(0, 2, 1), 11)
    ws = cols.transpose(0, 2, 1)
    out, sums2 = _islow_pass(ws, 18)
    return (fits(dq) & fits(sums1) & fits(ws) & fits(sums2)
            & ((out >= -512) & (out <= 511)).reshape(len(out), -1).all(1))


def test_blocks_under_the_idct_check_bound_stay_in_range():
    """``native/jpeg.cpp`` checks a block for values where libjpeg-turbo's
    SIMD and C IDCTs part only when its dequantised coefficients sum past
    ``kNarrowL1`` in absolute value.  A numpy model of islow's arithmetic
    holds every block at that sum in range: 200,000 seeded random blocks
    (sparse and dense, heavy-tailed), every coefficient alone at either
    sign, and for every output sample the block of that sum whose signs
    follow the sample's weights; a DC of twice the bound leaves it."""
    src = (ROOT / "dspfun_tpu_torch" / "native" / "jpeg.cpp").read_text()
    bound = int(re.search(r"constexpr int32_t kNarrowL1 = (\d+);", src).group(1))
    rng = np.random.default_rng(1)
    n = 200_000
    v = rng.standard_normal((n, 64)) ** np.where(np.arange(n) % 2, 3, 1)[:, None]
    v *= rng.random((n, 64)) < rng.random((n, 1))
    v[~v.any(1), 0] = 1.0
    blocks = np.trunc(v / np.abs(v).sum(1, keepdims=True) * bound).astype(np.int64)
    single = np.concatenate([np.eye(64, dtype=np.int64), -np.eye(64, dtype=np.int64)]) * bound
    wt, _ = _islow_pass(np.eye(8, dtype=np.int64), 0)           # [coefficient, sample]
    w = np.einsum("ly,kx->yxlk", wt, wt).reshape(64, 64)        # [sample, coefficient]
    signed = np.sign(w) * (bound // 64)
    worst = np.concatenate([blocks, single, signed, -signed]).reshape(-1, 8, 8)
    assert np.abs(worst).reshape(len(worst), -1).sum(1).max() <= bound
    assert _simd_safe(worst).all()
    assert not _simd_safe(np.pad(np.array([[[2 * bound]]]), ((0, 0), (0, 7), (0, 7)))).all()


@pytest.mark.parametrize("dc_q", [8, 64, 255])
def test_blocks_past_the_simd_range_are_refused(dc_q, tmp_path, monkeypatch):
    """A white image's JPEG with its luma DC quantiser raised from 8 (a
    damaged DQT): Pillow reads it through libjpeg-turbo's SIMD IDCT, whose
    16-bit lanes saturate or wrap where the C IDCT the port follows wraps
    through its range-limit table (at 64 an output of 1016: Pillow's 255,
    the C version's 120) or carries 32 bits (at 255, where these blocks'
    two wraps happen to meet).  The port refuses both, naming item 8e,
    with cv2 present and blocked: it judges the arithmetic, not pixels it
    cannot compute.  At 8 (the table as written) it reads as Pillow."""
    data = bytearray(jpeg.encode_jpeg(np.full((16, 24, 3), 255, np.uint8)))
    at = data.index(b"\xff\xdb")
    assert data[at + 4:at + 6] == b"\x00\x08"         # table 0, its DC entry
    data[at + 5] = dc_q
    path = tmp_path / "in.jpg"
    path.write_bytes(bytes(data))
    jimages.read_image(str(path))
    if dc_q == 8:
        _same_read(tmp_path, bytes(data))
        return
    for blocked in (False, True):
        with monkeypatch.context() as mp:
            if blocked:
                mp.setitem(sys.modules, "cv2", None)
            with pytest.raises(ValueError, match="SIMD and C arithmetic.*item 8e"):
                timages.read_image(str(path))


# ---- four components: CMYK and YCCK ---------------------------------------------


def _cmyk(h, w, seed):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = 128 + 100 * np.sin(x[..., None] / 5.0 + y[..., None] / 7.0 + np.arange(4))
    return np.clip(base + rng.normal(0, 15, (h, w, 4)), 0, 255).astype(np.uint8)


@pytest.mark.parametrize("restart", [0, 2])
@pytest.mark.parametrize("progressive", [False, True])
@pytest.mark.parametrize("colour", ["CMYK", "YCCK", "no Adobe marker", "Adobe transform 1"])
def test_cmyk_reads_as_the_jax_package(colour, progressive, restart, tmp_path, monkeypatch):
    """Pillow's CMYK JPEG (it writes an Adobe marker with transform 0 and
    the samples inverted) at 4:4:4 and with the first component at 2x2,
    37x53 and 8x8; the same file with the transform set to 2 (YCCK: the
    first three components YCbCr, converted and inverted by libjpeg), to
    1 (an unknown transform on four components: YCCK, as libjpeg assumes)
    and without the marker (CMYK as stored).  Each reads to the JAX
    package's pixels, with cv2 importable and blocked."""
    from tests import torch_codec_fixtures as fx

    for (h, w), sub in (((37, 53), 0), ((37, 53), 2), ((8, 8), 0)):
        data = _pil(Image.fromarray(_cmyk(h, w, h + sub), "CMYK"), progressive=progressive,
                    subsampling=sub, **({"restart_marker_blocks": restart} if restart else {}))
        if colour == "YCCK":
            data = fx.set_adobe_transform(data, 2)
        elif colour == "Adobe transform 1":
            data = fx.set_adobe_transform(data, 1)
        elif colour == "no Adobe marker":
            data = fx.without_adobe(data)
        assert timages._decoder(data) is jpeg.decode_jpeg
        _same_read(tmp_path, data)
        with monkeypatch.context() as mp:
            mp.setitem(sys.modules, "cv2", None)
            _same_read(tmp_path, data)


def test_cmyk_fixtures_are_pillows():
    """Phase 19(a)'s CMYK JPEGs: remade with Pillow by
    tests/torch_codec_fixtures.py they equal the committed files, and the
    sha256 of each file and of Pillow's ``convert("RGB")`` of it are
    ``chip_smoke.CMYK_FIXTURES``."""
    from tests import torch_codec_fixtures as fx

    made = fx.cmyk_fixtures()
    assert sorted(made) == sorted(chip_smoke.CMYK_FIXTURES)
    for name, data in made.items():
        assert (fx.GOLDENS / name).read_bytes() == data, name
        assert fx.cmyk_digests(data) == chip_smoke.CMYK_FIXTURES[name], name


@pytest.mark.parametrize("name", sorted(chip_smoke.CMYK_FIXTURES))
def test_cmyk_fixtures_decode_as_pillow(name, tmp_path, monkeypatch):
    """Each committed CMYK fixture, with cv2 blocked: the port's own codec
    takes it and its samples hash to Pillow's ``convert("RGB")``; but the
    4K file, ``read_image`` equals the JAX package's."""
    from tests import torch_codec_fixtures as fx

    monkeypatch.setitem(sys.modules, "cv2", None)
    data = (fx.GOLDENS / name).read_bytes()
    assert timages._decoder(data) is jpeg.decode_jpeg
    arr, _ = jpeg.decode_jpeg(data)
    assert hashlib.sha256(arr.tobytes()).hexdigest() == chip_smoke.CMYK_FIXTURES[name][1]
    if name != "cmyk_prog_4k.jpg":
        _same_read(tmp_path, data, name)
