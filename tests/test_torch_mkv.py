"""The port's Matroska container (``dspfun_tpu_torch/io/mkv.py`` and the
Matroska classes of ``io/video.py``) against the JAX package's and
against files a real libavformat wrote (cv2's bundled FFmpeg).

* Every case of ``tests/test_interop_cv2.py`` runs on the port's modules
  (``tests/torch_port_cases.py``): real FFV1 NUT and Matroska files
  decode sample-exactly, the port's files decode bit-exactly in real
  libavcodec; a foreign codec inside Matroska decodes through cv2's
  bundled FFmpeg when no ffmpeg binary is on PATH, in both packages.
* The same planes through both packages' Matroska writers give equal
  bytes (the JAX package writes native Matroska when no ffmpeg binary
  is on PATH, as here).
* Append and resume into Matroska are refused, as in the JAX package.

Skipped where cv2 is absent.
"""

from fractions import Fraction

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

import tests.test_interop_cv2 as jinterop_tests  # noqa: E402
from dspfun_tpu.io import video as jvideo  # noqa: E402
from dspfun_tpu_torch.io import mkv as tmkv  # noqa: E402
from dspfun_tpu_torch.io import video as tvideo  # noqa: E402
from tests.torch_port_cases import hide_ffmpeg, port_cases, run_on_port  # noqa: E402

SKIP: dict = {}


@pytest.mark.parametrize("case", port_cases(jinterop_tests, SKIP))
def test_jax_interop_case_on_the_port(case, request):
    run_on_port(request, jinterop_tests, *case)


def _cv2_write(path, frames, fourcc, is_color=True):
    wr = cv2.VideoWriter(str(path), cv2.CAP_FFMPEG, cv2.VideoWriter_fourcc(*fourcc), 25,
                         (frames[0].shape[1], frames[0].shape[0]), isColor=is_color)
    assert wr.isOpened()
    for f in frames:
        wr.write(f)
    wr.release()


def test_real_matroska_decodes_and_foreign_codecs_are_refused(tmp_path, monkeypatch):
    rng = np.random.default_rng(108)
    frames = [rng.integers(0, 256, (16, 24, 3)).astype(np.uint8) for _ in range(3)]
    p = tmp_path / "a.mkv"
    _cv2_write(p, frames, "FFV1")
    with tvideo.open_input(str(p)) as r, jvideo.open_input(str(p)) as j:
        assert type(r).__name__ == type(j).__name__ == "MkvVideoReader"
        assert (r.pix_fmt.name, r.frames, r.rate) == ("gbrp", 3, Fraction(25))
        for f in frames:
            g, b, rr = r.read_frame(raw=True)
            for x, y in zip((g, b, rr), j.read_frame(raw=True)):
                np.testing.assert_array_equal(x, y)
        assert r.read_frame() is None
    # a foreign codec inside Matroska (once refused by the port, ROADMAP
    # item 13): without an ffmpeg binary both packages decode it through
    # cv2's bundled FFmpeg, to the same frames
    hide_ffmpeg(monkeypatch)
    q = tmp_path / "m.mkv"
    _cv2_write(q, frames[:1], "MJPG")
    with tvideo.open_input(str(q)) as r, jvideo.open_input(str(q)) as j:
        assert type(r).__name__ == type(j).__name__ and r.format == j.format == "opencv"
        assert (r.pix_fmt.name, r.frames) == (j.pix_fmt.name, j.frames) == ("gbrp", 1)
        for x, y in zip(r.read_frame(raw=True), j.read_frame(raw=True)):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("pix_fmt,options", [("yuv420p", None), ("gray", "level=3"),
                                             ("gbrp", None), ("gbrpf32le", None),
                                             ("yuv444pf32", None), (None, None)])
def test_writers_give_equal_bytes(pix_fmt, options, tmp_path, monkeypatch):
    hide_ffmpeg(monkeypatch)  # both packages' native Matroska
    rng = np.random.default_rng(9)
    frames = [rng.random((12, 20, 3)) for _ in range(3)]
    out = {}
    for name, mod in (("jax", jvideo), ("torch", tvideo)):
        path = tmp_path / f"{name}.mkv"
        w = mod.open_output(str(path), 20, 12, Fraction(24000, 1001),
                            mod.ColorProps(pix_fmt=pix_fmt), options=options)
        assert type(w).__name__ == "MkvVideoWriter"
        for f in frames:
            w.write_frame_rgb(f)
        w.close()
        out[name] = path
    assert out["jax"].read_bytes() == out["torch"].read_bytes()
    with tvideo.open_input(str(out["jax"])) as r, jvideo.open_input(str(out["torch"])) as j:
        assert (r.pix_fmt.name, r.frames, vars(r.props)) == (j.pix_fmt.name, j.frames, vars(j.props))
        for _ in range(3):
            for x, y in zip(r.read_frame(), j.read_frame()):
                np.testing.assert_array_equal(x, y)


def test_append_and_pipes_are_refused(tmp_path, monkeypatch):
    """Append and resume into Matroska are refused, as in the JAX package.
    Matroska on a pipe, under another extension or with another encoder
    (once refused by the port, ROADMAP item 13) is the ffmpeg bridge's in
    both packages: the same error without a binary."""
    path = str(tmp_path / "a.mkv")
    with tvideo.open_output(path, 8, 6, Fraction(25), tvideo.ColorProps(pix_fmt="gray")) as w:
        w.write_frame([np.zeros((6, 8))], raw=True)
    with pytest.raises(RuntimeError, match="append/resume"):
        tvideo.open_output(path, 8, 6, Fraction(25), append=True)
    hide_ffmpeg(monkeypatch)
    for spec, fmt, codec in (("-", "matroska", None), (str(tmp_path / "a.bin"), "matroska", None),
                             (str(tmp_path / "b.mkv"), None, "rawvideo")):
        errs = []
        for mod in (jvideo, tvideo):
            with pytest.raises(RuntimeError, match="requires an ffmpeg binary") as e:
                mod.open_output(spec, 8, 6, format=fmt, codec=codec)
            errs.append(str(e.value))
        assert errs[0] == errs[1]
    assert sorted(p.name for p in tmp_path.iterdir()) == ["a.mkv"]


def test_demuxer_copy_reads_the_jax_muxer():
    import io

    from dspfun_tpu.io import mkv as jmkv

    buf = io.BytesIO()
    mux = jmkv.MkvMuxer(buf, 16, 8, Fraction(25), codec_private=b"", color_range="jpeg")
    for k in range(4):
        mux.write_frame_bytes(bytes([k]) * (5 + k))
    mux.finalize()
    d = tmkv.MkvDemuxer(io.BytesIO(buf.getvalue()))
    assert (d.track.codec_id, d.track.width, d.track.height, d.rate()) == ("V_FFV1", 16, 8,
                                                                            Fraction(25))
    pk = d.scan_packets()
    assert [ln for _, _, ln in pk] == [5, 6, 7, 8]
