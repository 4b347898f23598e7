"""The document writes of the port, as Pillow 12.1 writes them, with no
Pillow:

* **EPS** (:func:`encode_eps`, ``EpsImagePlugin._save`` with the C
  ``EpsEncode``): the DSC header Pillow writes, the image operator for an
  ``RGB`` image, the samples as lowercase hex in lines of 78 digits (the
  encoder breaks a line after every 39 bytes, across rows, and not after
  the last one), ``%%%%EndBinary`` as Pillow writes it (literally, four
  percent signs) and ``grestore end``.  ``RGBA`` and ``I;16`` raise
  Pillow's ``ValueError``.
* **PDF** (:func:`encode_pdf`, ``PdfImagePlugin._save`` and
  ``PdfParser``): one page at 72 dpi, its objects in Pillow's order
  (catalog 4, pages 5, image 1, page 2, contents 3, info 6) and layout,
  the cross-reference table of their offsets and the trailer.  ``RGB``
  embeds ``io/jpeg.py``'s ``encode_jpeg`` of the pixels (``DCTDecode``),
  ``RGBA`` the JP2 of ``io/jpeg2000.py``'s ``encode_jpeg2000``
  (``JPXDecode`` with ``/SMaskInData 1``); ``I;16`` raises Pillow's
  ``ValueError``.  The info holds the output's stem as ``/Title`` (UTF-16BE
  after a byte-order mark, with PDF's escapes of ``\\``, ``(`` and ``)``)
  and ``time.gmtime()`` twice, read at the call as Pillow reads it, as
  ``/CreationDate`` and ``/ModDate``.
"""

from __future__ import annotations

import codecs
import os
import time

import numpy as np

from dspfun_tpu_torch.io import jpeg as _jpeg
from dspfun_tpu_torch.io import jpeg2000 as _jpeg2000

__all__ = ["encode_eps", "encode_pdf"]

EPS_LINE = 78       # hex digits a line: EpsEncode.c breaks after 79 // 2 bytes


def encode_eps(arr: np.ndarray) -> bytes:
    """The EPS file Pillow writes of uint8 [H, W, 3] samples."""
    arr = np.asarray(arr)
    if arr.dtype != np.uint8 or arr.ndim != 3 or arr.shape[2] != 3:
        raise ValueError("image mode is not supported")
    h, w = arr.shape[:2]
    digits = np.ascontiguousarray(arr).tobytes().hex().encode()
    body = b"\n".join(digits[i:i + EPS_LINE] for i in range(0, len(digits), EPS_LINE))
    return (b"%%!PS-Adobe-3.0 EPSF-3.0\n%%%%Creator: PIL 0.1 EpsEncode\n"
            b"%%%%BoundingBox: 0 0 %d %d\n%%%%Pages: 1\n%%%%EndComments\n%%%%Page: 1 1\n"
            b'%%ImageData: %d %d 8 3 0 1 1 "false 3 colorimage"\n'
            b"gsave\n10 dict begin\n/buf %d string def\n%d %d scale\n%d %d 8\n"
            b"[%d 0 0 -%d 0 %d]\n{ currentfile buf readhexstring pop } bind\n"
            b"false 3 colorimage\n"
            % (w, h, w, h, w * 3, w, h, w, h, w, h, h)) + body + b"\n%%%%EndBinary\ngrestore end\n"


def _text(s: str) -> bytes:
    """PdfParser's ``pdf_repr`` of a text string."""
    b = codecs.BOM_UTF16_BE + s.encode("utf_16_be")
    return b"(" + b.replace(b"\\", b"\\\\").replace(b"(", b"\\(").replace(b")", b"\\)") + b")"


def _date(t: time.struct_time) -> bytes:
    return b"(D:" + time.strftime("%Y%m%d%H%M%SZ", t).encode("us-ascii") + b")"


def encode_pdf(arr: np.ndarray, path: str) -> bytes:
    """The one-page PDF Pillow writes of uint8 [H, W, 3] or [H, W, 4]
    samples to ``path`` (whose stem is the title)."""
    arr = np.asarray(arr)
    if arr.dtype != np.uint8:
        raise ValueError("cannot save mode I;16")
    h, w, nch = arr.shape
    info = {b"Title": os.path.splitext(os.path.basename(path))[0],
            b"CreationDate": time.gmtime(), b"ModDate": time.gmtime()}
    if nch == 4:
        stream = _jpeg2000.encode_jpeg2000(arr)
        kind = b"/Filter /JPXDecode\n/SMaskInData 1"
    else:
        stream = _jpeg.encode_jpeg(arr)
        kind = b"/Filter /DCTDecode\n/BitsPerComponent 8\n/ColorSpace /DeviceRGB"
    contents = b"q %f 0 0 %f 0 0 cm /image Do Q\n" % (w * 72.0 / 72.0, h * 72.0 / 72.0)
    out = bytearray(b"%PDF-1.4\n% created by Pillow PDF driver\n")
    offsets = {}

    def obj(num: int, body: bytes) -> None:
        offsets[num] = len(out)
        out.extend(b"%d 0 obj" % num + body + b"endobj\n")

    obj(4, b"<<\n/Type /Catalog\n/Pages 5 0 R\n>>")
    obj(5, b"<<\n/Type /Pages\n/Count 1\n/Kids [ 2 0 R ]\n>>")
    obj(1, b"<<\n/Type /XObject\n/Subtype /Image\n/Width %d\n/Height %d\n%s\n/Length %d\n>>"
        b"stream\n%s\nendstream\n" % (w, h, kind, len(stream), stream))
    obj(2, b"<<\n/Resources <<\n/ProcSet [ /PDF /ImageC ]\n/XObject <<\n/image 1 0 R\n>>\n>>\n"
        b"/MediaBox [ 0 0 %s %s ]\n/Contents 3 0 R\n/Type /Page\n/Parent 5 0 R\n>>"
        % (str(w * 72.0 / 72.0).encode(), str(h * 72.0 / 72.0).encode()))
    obj(3, b"<<\n/Length %d\n>>stream\n%s\nendstream\n" % (len(contents), contents))
    fields = [b"/" + k + b" " + (_text(v) if isinstance(v, str) else _date(v))
              for k, v in info.items() if v]
    obj(6, b"<<\n" + b"\n".join(fields) + b"\n>>")
    start = len(out)
    out.extend(b"xref\n0 7\n0000000000 65536 f \n")
    for num in range(1, 7):
        out.extend(b"%010d %05d n \n" % (offsets[num], 0))
    out.extend(b"trailer\n<<\n/Root 4 0 R\n/Size 7\n/Info 6 0 R\n>>\nstartxref\n%d\n%%%%EOF" % start)
    return bytes(out)
