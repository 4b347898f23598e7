"""The port's motion CLI and its y4m and colour copies against the JAX
package's.

* CLI: ``dspfun_tpu_torch.tools.motion.main`` and
  ``dspfun_tpu.tools.motion.main`` on the same small yuv420p clip
  (64x48, 16 frames).  The y4m headers must be byte-equal and the frame
  payloads the same length; pels may differ by one level (a float32 sum
  in another order crossing a rounding edge) on at most 0.1 % of them.
* y4m container, pixel formats, colour properties and the RGB/pel
  conversions (``io/video.py``) and the colour matrices (``io/color.py``)
  are copies: equal bytes, equal arrays.  The torch transfer functions
  agree with the JAX device path to 1e-6 (float32, Newton-polished pow
  on both sides).
* The containers: fvid, NUT, Matroska and PNG sequences in; NUT (FFV1
  by default), Matroska and fvid out, against the JAX tool's output.
* ``--resume-file``: an interrupted run finished by a rerun equals one
  uninterrupted run, and the JAX package's own resume case through both
  tools.
* The flags the port refuses exit 1 and name the ROADMAP item; the mesh
  flags exit 1 where the request cannot run.
"""

import dataclasses
import io
from fractions import Fraction

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dspfun_tpu.io import color as jcolor
from dspfun_tpu.io import video as jvideo
from dspfun_tpu.tools import motion as jmotion
from dspfun_tpu_torch.io import color as tcolor
from dspfun_tpu_torch.io import video as tvideo
from dspfun_tpu_torch.tools import cli_device
from dspfun_tpu_torch.tools import motion as tmotion
from tests.torch_port_cases import assert_cli_parity, run_cli_both


def _planes(rng, pf, w, h, t):
    out = []
    for i, (pw, ph) in enumerate(pf.plane_dims(w, h)):
        y, x = np.mgrid[0:ph, 0:pw]
        base = 128 + 60 * np.sin(x / (7.0 + i) + t / 5.0) * np.cos(y / 9.0)
        out.append(np.clip(base + rng.normal(0, 12, (ph, pw)), 0, 255))
    return out


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    """A 64x48 yuv420p clip of 16 frames, written by the JAX package."""
    path = str(tmp_path_factory.mktemp("motion_cli") / "clip.y4m")
    rng = np.random.default_rng(0)
    pf = jvideo.PIXEL_FORMATS["yuv420p"]
    w = jvideo.open_output(path, 64, 48, Fraction(25, 1), jvideo.ColorProps(pix_fmt="yuv420p"))
    for t in range(16):
        w.write_frame(_planes(rng, pf, 64, 48, t), raw=True)
    w.close()
    return path


CLI_CASES = {
    "lowpass i8-kron/kron": ["-b", "16x16x16", "-p", "0x0x0-8x8x4", "-B", "1.25"],
    "quant dither": ["-b", "8x8x8", "-q", "0.05", "-d"],
    "csp yuv444p": ["-b", "8x8x4", "--csp", "pixel_format=yuv444p", "-B", "1.5",
                    "-p", "0x0x0-4x4x2", "-D", "0.5"],
    "spectrogram flat": ["-b", "8x8x8", "--spectrogram=flat"],
    "downscale slab batch": ["-b", "16x16x8", "-s", "8x8x8", "--slab-batch", "2",
                             "--coeff-limit", "30", "-q", "0.01"],
}


@pytest.mark.parametrize("case", list(CLI_CASES))
def test_cli_matches_jax(clip, tmp_path, case):
    args = ["-Q"] + CLI_CASES[case]
    outs = []
    for name, main, extra in (("jax", jmotion.main, []),
                              ("torch", tmotion.main, ["--device", "cpu"])):
        out = str(tmp_path / f"{name}.y4m")
        assert main(args + extra + [clip, out]) == 0
        outs.append(open(out, "rb").read())
    (j, t) = outs
    hj, ht = j.index(b"\n"), t.index(b"\n")
    assert t[:ht] == j[:hj]
    assert len(t) == len(j)
    a = np.frombuffer(j[hj:], np.uint8).astype(int)
    b = np.frombuffer(t[ht:], np.uint8).astype(int)
    diff = np.abs(a - b)
    assert diff.max() <= 1 and np.mean(diff > 0) <= 1e-3


@pytest.mark.parametrize("flag,item", [
    (["--mesh", "2", "--eval", "c*random(0)"], "stateful av_expr"),
    (["--coordinator", "h:1", "--mesh", "rows=2"], "multi-process mesh spec 'rows=2'"),
    (["--nprocs", "2"], "needs --coordinator host:port"),
    (["--proc-id", "1", "--nprocs", "1", "--coordinator", "h:1"], "not one of 1 processes"),
])
def test_refused_flags_exit_1(clip, tmp_path, capsys, flag, item):
    """The mesh and multi-process flags run (tests/test_torch_mesh_cli.py,
    test_torch_multihost.py); what they cannot run exits 1 before any
    rank starts or anything is read or written."""
    assert tmotion.main(["-Q", "--device", "cpu"] + flag + [clip, str(tmp_path / "o.y4m")]) == 1
    err = capsys.readouterr().err
    assert item in err and "not ported" not in err
    assert not (tmp_path / "o.y4m").exists()


@pytest.mark.parametrize("src,dst", [("in.nut", "o.y4m"), ("clip", "o.webm"),
                                     ("clip", "ffplay:")])
def test_other_containers_are_refused(clip, tmp_path, capsys, monkeypatch, src, dst):
    """The containers the port once refused (ROADMAP item 13) take the
    JAX tool's paths: with ffmpeg hidden and under the shim binaries, the
    same exit code, last error line, shim argv and output within one
    level."""
    def argv_of(d):
        s = clip if src == "clip" else str(d / src)
        if s.endswith(".nut"):
            open(s, "wb").write(b"nut/multimedia container\0")
        dev = ["--device", "cpu"] if d.name.startswith("torch") else []
        return ["-Q", *dev, "-b", "16x16x16", "-p", "0x0x0-8x8x4", "-B", "1.25", s,
                dst if dst == "ffplay:" else str(d / dst)]

    for shims in (False, True):
        got = run_cli_both(tmp_path, monkeypatch, capsys,
                           {"jax": jmotion.main, "torch": tmotion.main}, argv_of, shims)
        assert_cli_parity(got)
        assert got["torch"]["rc"] == (0 if shims and src == "clip" else 1)


def test_device_cuda_without_a_card_is_an_error(clip, tmp_path, capsys, monkeypatch):
    """The default device is the card: without one, no --device and
    --device cuda fail alike, and nothing runs on the CPU unasked."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for extra in (["--device", "cuda"], []):
        assert tmotion.main(["-Q"] + extra + [clip, str(tmp_path / "o.y4m")]) == 1
        assert "Bad --device" in capsys.readouterr().err
    assert not (tmp_path / "o.y4m").exists()
    with pytest.raises(ValueError, match="is_available"):
        cli_device(None)
    assert cli_device("cpu").type == "cpu"


PIX = [("yuv420p", None), ("yuv422p", "jpeg"), ("yuv444p", "mpeg"), ("gray", None),
       ("yuv420p10le", None), ("yuv444p16le", "jpeg")]


@pytest.mark.parametrize("pix,crange", PIX)
def test_y4m_writer_and_reader_match_jax(tmp_path, pix, crange):
    rng = np.random.default_rng(1)
    w, h = 21, 10  # odd width: ceiling-shifted chroma
    frames = []
    for t in range(3):
        pf = jvideo.PIXEL_FORMATS[pix]
        frames.append([rng.random((ph, pw)) for pw, ph in pf.plane_dims(w, h)])
    blobs = []
    for mod in (jvideo, tvideo):
        buf = io.BytesIO()
        props = mod.ColorProps(pix_fmt=pix, color_range=crange, chroma_location="left")
        mod._default_props("y4m", props)
        wr = mod.Y4MWriter(buf, "mem", "yuv4mpegpipe", w, h, Fraction(30000, 1001),
                           mod.PIXEL_FORMATS[pix], props)
        for f in frames:
            wr.write_frame(f)
        wr.write_frame([p * 255 for p in frames[0]], raw=True)
        blobs.append(buf.getvalue())
    assert blobs[0] == blobs[1]
    path = tmp_path / "v.y4m"
    path.write_bytes(blobs[1])
    rj = jvideo.open_input(str(path), native=False)
    rt = tvideo.open_input(str(path))
    for attr in ("width", "height", "rate", "frames"):
        assert getattr(rt, attr) == getattr(rj, attr)
    assert dataclasses.asdict(rt.props) == dataclasses.asdict(rj.props)
    assert dataclasses.asdict(rt.pix_fmt) == dataclasses.asdict(rj.pix_fmt)
    for raw in (False, True, False, True):
        pj, pt = rj.read_frame(raw=raw), rt.read_frame(raw=raw)
        for a, b in zip(pj, pt):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(b, a)
    assert rt.read_frame() is None and rj.read_frame() is None
    rj.close()
    rt.close()


def test_video_helpers_match_jax():
    assert {k: dataclasses.asdict(v) for k, v in tvideo.PIXEL_FORMATS.items()} == \
        {k: dataclasses.asdict(v) for k, v in jvideo.PIXEL_FORMATS.items()}
    for s in ("", "pixel_format=yuv444p:color_range=tv", "colorspace=bt709:color_trc=linear",
              "chroma_sample_location=left:color_primaries=bt2020"):
        assert dataclasses.asdict(tvideo.parse_color_props(s)) == \
            dataclasses.asdict(jvideo.parse_color_props(s))
    for bad in ("pixel_format=nope", "color_range=odd", "what=1"):
        with pytest.raises(ValueError):
            tvideo.parse_color_props(bad)
    for r in ("30", "30000/1001", "29.97", "25:2"):
        assert tvideo.parse_rate(r) == jvideo.parse_rate(r)
    rgb = np.random.default_rng(2).random((9, 13, 3))
    for name in ("yuv420p", "yuv422p", "gray", "gbrp", "yuv444p16le"):
        pj, pt = jvideo.PIXEL_FORMATS[name], tvideo.PIXEL_FORMATS[name]
        for space in (None, "bt709", "bt2020nc"):
            props_j, props_t = jvideo.ColorProps(color_space=space), tvideo.ColorProps(color_space=space)
            a = jvideo.rgb_to_planes(rgb, pj, props_j)
            b = tvideo.rgb_to_planes(rgb, pt, props_t)
            for x, y in zip(a, b):
                np.testing.assert_array_equal(y, x)
            np.testing.assert_array_equal(tvideo.planes_to_rgb(b, pt, props_t, 13, 9),
                                          jvideo.planes_to_rgb(a, pj, props_j, 13, 9))
            for i, p in enumerate(b):
                for cr in ("mpeg", "jpeg"):
                    pel = tvideo.plane_to_pel(p, pt, i, cr)
                    np.testing.assert_array_equal(pel, jvideo.plane_to_pel(p, pj, i, cr))
                    np.testing.assert_array_equal(tvideo.plane_from_pel(pel, pt, i, cr),
                                                  jvideo.plane_from_pel(pel, pj, i, cr))
        if not pt.is_rgb:
            assert tvideo._y4m_ctag(name, "topleft") == jvideo._y4m_ctag(name, "topleft")
    for req in (None, "gray", "yuv420p", "gbrp", "grayf32le", "yuv422p12le", "gbrpf32le"):
        for fmt in ("y4m", "fvid", "image2"):
            assert tvideo._negotiate_pix_fmt(fmt, tvideo.ColorProps(pix_fmt=req)) == \
                jvideo._negotiate_pix_fmt(fmt, jvideo.ColorProps(pix_fmt=req))
            pt, pj = tvideo.ColorProps(pix_fmt=req), jvideo.ColorProps(pix_fmt=req)
            tvideo._default_props(fmt, pt)
            jvideo._default_props(fmt, pj)
            assert dataclasses.asdict(pt) == dataclasses.asdict(pj)


def test_color_matches_jax():
    for name in ("bt601", "bt709", "bt2020"):
        np.testing.assert_array_equal(tcolor.ycbcr_matrix(name), jcolor.ycbcr_matrix(name))
        np.testing.assert_array_equal(tcolor.ycbcr_inverse_matrix(name),
                                      jcolor.ycbcr_inverse_matrix(name))
    x = np.concatenate([np.linspace(0, 1, 4001), [0.0031308, 0.04045, 1e-6, 0.0]])
    for fn in ("srgb_decode", "srgb_encode"):
        np.testing.assert_array_equal(getattr(tcolor, fn)(x), getattr(jcolor, fn)(x))
        xf = x.astype(np.float32)
        yj = np.asarray(getattr(jcolor, fn)(jnp.asarray(xf), jnp))
        yt = getattr(tcolor, fn)(torch.from_numpy(xf), torch)
        assert yt.dtype == torch.float32
        assert np.max(np.abs(yt.numpy() - yj)) <= 1e-6


def _decoded(path, raw=True):
    with tvideo.open_input(path) as r:
        frames = []
        while (f := r.read_frame(raw=raw)) is not None:
            frames.append([np.asarray(p, np.float64) for p in f])
    return frames


def _close_to_jax(jpath, tpath, tol, share=None):
    """Decoded frames (normalised) within ``tol``; with ``share``, at most
    that share of samples differ at all."""
    a, b = _decoded(jpath, raw=False), _decoded(tpath, raw=False)
    assert len(a) == len(b) > 0
    d = np.concatenate([np.abs(p - q).ravel() for fa, fb in zip(a, b) for p, q in zip(fa, fb)])
    assert d.max() <= tol, d.max()
    if share is not None:
        assert np.mean(d > 1e-6) <= share, np.mean(d > 1e-6)


@pytest.mark.parametrize("src_fmt", ["fvid", "nut", "mkv", "png"])
@pytest.mark.parametrize("dst", ["o.nut", "o.mkv", "o.fvid"])
def test_containers_in_and_out_match_jax(clip, tmp_path, src_fmt, dst):
    """motion reads fvid, NUT (FFV1), Matroska (FFV1) and PNG sequences and
    writes NUT, Matroska and fvid: the JAX tool's output from the same
    input, within one 8-bit level on at most 0.1 % of the samples where
    the pels are 8-bit, within 5e-6 (float pels: float32 sums over the
    1024 coefficients of a block, in another order) plus one 16-bit level
    where Matroska stores float content in 16 bits."""
    j = jvideo.open_input(clip)
    src = str(tmp_path / ("in%02d.png" if src_fmt == "png" else f"in.{src_fmt}"))
    props = jvideo.ColorProps(pix_fmt="gbrpf32le" if src_fmt == "fvid" else "yuv420p")
    w = jvideo.open_output(src, 64, 48, j.rate, props)
    for _ in range(8):
        w.write_frame_rgb(j.read_frame_rgb())
    w.close()
    j.close()
    outs = []
    for name, main, extra in (("jax", jmotion.main, []),
                              ("torch", tmotion.main, ["--device", "cpu"])):
        out = str(tmp_path / f"{name}_{dst}")
        assert main(["-Q", "-b", "16x16x4", "-p", "0x0x0-8x8x2", "-B", "1.25"] + extra
                    + [src, out]) == 0
        outs.append(out)
    if src_fmt in ("nut", "mkv"):
        _close_to_jax(*outs, 1.0 / 255 + 1e-6, share=1e-3)
    else:
        _close_to_jax(*outs, 5e-6 + (1.0 / 65535 if dst == "o.mkv" else 0.0))


def test_nut_output_is_ffv1_and_matches_y4m(clip, tmp_path):
    """The default NUT output codes FFV1 and decodes to the y4m run's
    frames (FFV1 is lossless); --codec rawvideo writes raw planes."""
    from dspfun_tpu_torch.io import nut as tnut

    args = ["-Q", "--device", "cpu", "-b", "16x16x8", "-p", "0x0x0-8x8x4", "-B", "1.25"]
    for out in ("o.y4m", "o.nut", "o.mkv"):
        assert tmotion.main(args + [clip, str(tmp_path / out)]) == 0
    assert tmotion.main(args + ["--codec", "rawvideo", clip, str(tmp_path / "r.nut")]) == 0
    ref = _decoded(str(tmp_path / "o.y4m"))
    for out in ("o.nut", "o.mkv", "r.nut"):
        got = _decoded(str(tmp_path / out))
        assert len(got) == len(ref) == 16
        for fa, fb in zip(ref, got):
            for p, q in zip(fa, fb):
                np.testing.assert_array_equal(p, q)
    for name, tag in (("o.nut", b"FFV1"), ("r.nut", b"I420")):
        with open(tmp_path / name, "rb") as f:
            assert bytes(tnut.NutReader(f).state.streams[0]["fourcc"]) == tag


class _Interrupt(Exception):
    pass


@pytest.mark.parametrize("ext", ["nut", "y4m", "fvid"])
def test_resume_after_an_interrupt_matches_a_single_run(clip, tmp_path, monkeypatch, ext):
    """--resume-file: a run cut after two of four slabs, finished by a
    rerun with the same flags into the same file, equals one
    uninterrupted run (the slab index, the fingerprint and the append)."""
    args = ["-Q", "--device", "cpu", "-b", "16x16x4", "-D", "0.5", "-p", "0x0x0-8x8x2"]
    if ext == "fvid":
        args += ["--csp", "pixel_format=gbrpf32le"]
    single, part = str(tmp_path / f"single.{ext}"), str(tmp_path / f"part.{ext}")
    state = str(tmp_path / "state.json")
    assert tmotion.main(args + [clip, single]) == 0
    real = tmotion.mp.filter_blocks
    calls = []

    def cut(*a, **k):
        calls.append(1)
        if len(calls) > 2 * 3:            # three planes a slab: stop in slab 3
            raise _Interrupt
        return real(*a, **k)

    monkeypatch.setattr(tmotion.mp, "filter_blocks", cut)
    with pytest.raises(_Interrupt):
        tmotion.main(args + ["--resume-file", state, clip, part])
    monkeypatch.setattr(tmotion.mp, "filter_blocks", real)
    assert tmotion.load_state(state)["slab"] == 2
    assert len(_decoded(part)) == 8
    assert tmotion.main(args + ["--resume-file", state, clip, part]) == 0
    assert tmotion.load_state(state)["slab"] == 4
    a, b = _decoded(single), _decoded(part)
    assert len(a) == len(b) == 16
    for fa, fb in zip(a, b):
        for p, q in zip(fa, fb):
            np.testing.assert_array_equal(p, q)
    if ext != "nut":
        assert open(single, "rb").read() == open(part, "rb").read()


def test_resume_with_other_flags_starts_over_and_mkv_refuses(clip, tmp_path, capsys):
    """A state file from a run with another edit does not resume (the
    fingerprint), and Matroska refuses resume as in the JAX tool."""
    state = str(tmp_path / "state.json")
    tmotion.save_state(state, {"slab": 3, "newres": [64, 48, 16], "fingerprint": "other"})
    out = str(tmp_path / "o.y4m")
    assert tmotion.main(["-Q", "--device", "cpu", "-b", "16x16x4", "--resume-file", state,
                         clip, out]) == 0
    assert len(_decoded(out)) == 16 and tmotion.load_state(state)["slab"] == 4
    tmotion.save_state(state, {"slab": 1, "newres": [64, 48, 16]})
    assert tmotion.main(["-Q", "--device", "cpu", "-b", "16x16x4", "--resume-file", state,
                         clip, str(tmp_path / "o.mkv")]) == 1
    assert "append/resume" in capsys.readouterr().err


def test_resume_matches_the_jax_tool(clip, tmp_path):
    """The JAX package's own resume case (tests/test_utils.py) through both
    tools: an fvid of 6 frames, a partial run, a resumed run."""
    from dspfun_tpu.utils import checkpoint as jcheckpoint

    outs = []
    for name, main, ck, extra in (("jax", jmotion.main, jcheckpoint, []),
                                  ("torch", tmotion.main, tmotion, ["--device", "cpu"])):
        state, part = str(tmp_path / f"{name}.json"), str(tmp_path / f"{name}.fvid")
        assert main(["-Q", "-b", "8x8x2", "--frames", "4", "--resume-file", state] + extra
                    + [clip, part]) == 0
        ck.save_state(state, {"slab": 2, "newres": [64, 48, 16]})
        assert main(["-Q", "-b", "8x8x2", "--resume-file", state] + extra + [clip, part]) == 0
        outs.append(part)
    _close_to_jax(*outs, 1.0 / 255 + 1e-6, share=1e-3)
