"""The port's ``rotate`` and ``transcode`` CLIs against the JAX package's,
on the CPU: the same seeded y4m and fvid clips (8-bit 4:4:4 and 4:2:0,
10-bit 4:2:0, float RGB) through ``dspfun_tpu.tools.<tool>`` and
``dspfun_tpu_torch.tools.<tool>`` with the same flags write files equal
byte for byte, to y4m, fvid, PNG, NUT (FFV1 by default, rawvideo, FFV1
level 3) and Matroska.  The ffmpeg bridge's containers, ``ffplay:`` and
foreign encoders behave as in the JAX tools, with ffmpeg hidden and under
the shim binaries of tests/test_ffmpeg_bridge.py."""

import itertools
import os
from fractions import Fraction

import numpy as np
import pytest

from dspfun_tpu.io import video as jvideo
from dspfun_tpu.tools import rotate as jrotate
from dspfun_tpu.tools import transcode as jtranscode
from dspfun_tpu_torch.io import video as tvideo
from dspfun_tpu_torch.tools import main as tmain
from dspfun_tpu_torch.tools import rotate as trotate
from dspfun_tpu_torch.tools import transcode as ttranscode
from tests.torch_port_cases import clear_ffmpeg_caches, hide_ffmpeg, use_shims

# (file name, pixel format, frames, height, width)
CLIPS = [("c444.y4m", "yuv444p", 4, 8, 12), ("c420.y4m", "yuv420p", 5, 8, 12),
         ("c10.y4m", "yuv420p10le", 3, 6, 10), ("cf.fvid", "gbrpf32le", 4, 6, 8),
         ("cgray.y4m", "gray", 3, 4, 6)]


def _clip(tmp_path, name, pix, t, h, w, seed=3):
    """A seeded clip written by the port's writer as stored pels (floats
    for fvid), including out-of-range mpeg pels in 8-bit y4m."""
    path = str(tmp_path / name)
    pf = tvideo.PIXEL_FORMATS[pix]
    rng = np.random.default_rng(seed)
    fmt = "fvid" if name.endswith(".fvid") else "y4m"
    with tvideo.open_output(path, w, h, Fraction(25), tvideo.ColorProps(pix_fmt=pix),
                            format=fmt) as wr:
        for _ in range(t):
            if pf.is_float:
                wr.write_frame([rng.random((ph, pw)).astype(np.float32)
                                for pw, ph in pf.plane_dims(w, h)], raw=True)
            else:
                top = (1 << pf.depth) - 1
                wr.write_frame([rng.integers(0, top + 1, (ph, pw)) for pw, ph in pf.plane_dims(w, h)],
                               raw=True)
    return path


def _both(tmp_path, jtool, ttool, argv, out_ext, tag="o"):
    jout, tout = str(tmp_path / f"j_{tag}.{out_ext}"), str(tmp_path / f"t_{tag}.{out_ext}")
    assert jtool.main(argv + [jout]) == 0
    assert ttool.main(argv + [tout]) == 0
    return open(jout, "rb").read(), open(tout, "rb").read()


def test_rotate_volume_and_axis_maps_equal():
    vol = np.random.default_rng(12).random((3, 4, 5, 2))
    specs = ["".join(s + a for s, a in zip(signs, perm))
             for perm in itertools.permutations("xyz")
             for signs in itertools.product("+-", repeat=3)]
    for spec in specs + ["zyx", "y-xz", "-x-yz"]:
        assert trotate.parse_axis_map(spec) == jrotate.parse_axis_map(spec)
        m, inv = trotate.parse_axis_map(spec)
        np.testing.assert_array_equal(trotate.rotate_volume(vol, m, inv),
                                      jrotate.rotate_volume(vol, m, inv))
    for bad in ("xy", "xyy", "abc", "x-y", ""):
        with pytest.raises(ValueError):
            jrotate.parse_axis_map(bad)
        with pytest.raises(ValueError):
            trotate.parse_axis_map(bad)


# every axis map the JAX package's CLI tests use, plus the rotations of
# the help text and a flip of every axis
AXIS_MAPS = ["zyx", "xyz", "y-xz", "-yxz", "-x-yz", "x-yz", "-z-y-x"]


@pytest.mark.parametrize("clip", CLIPS, ids=lambda c: c[1])
@pytest.mark.parametrize("spec", AXIS_MAPS)
def test_rotate_files_equal(tmp_path, clip, spec):
    src = _clip(tmp_path, *clip)
    ext = clip[0].rsplit(".", 1)[1]
    a, b = _both(tmp_path, jrotate, trotate, ["-q", "--", spec, src], ext)
    assert a == b
    assert set(trotate.LAST_STAGE_TIMES) == {"read", "rotate", "write"}


@pytest.mark.parametrize("argv,ext", [
    (["-q", "-s", "1:2", "zyx"], "y4m"),
    (["-q", "-r", "same", "zyx"], "y4m"),
    (["-q", "-r", "30000/1001", "y-xz"], "y4m"),
    (["-q", "-s", "0:100", "xyz"], "y4m"),           # clamped to the clip (rotate.c:117)
    (["-q", "-c", "pixel_format=yuv444p", "zyx"], "y4m"),
    (["-q", "-c", "colorspace=bt709", "--", "-x-yz"], "y4m"),
    (["-q", "zyx"], "fvid"),
    (["-q", "y-xz"], "png"),
])
def test_rotate_options_equal(tmp_path, argv, ext):
    src = _clip(tmp_path, "c420.y4m", "yuv420p", 5, 8, 12)
    if ext == "png":
        jout, tout = str(tmp_path / "j%02d.png"), str(tmp_path / "t%02d.png")
        assert jrotate.main(argv + [src, jout]) == 0 and trotate.main(argv + [src, tout]) == 0
        for i in range(5):
            assert open(jout % i, "rb").read() == open(tout % i, "rb").read()
        return
    a, b = _both(tmp_path, jrotate, trotate, argv + [src], ext)
    assert a == b


@pytest.mark.parametrize("clip", CLIPS, ids=lambda c: c[1])
@pytest.mark.parametrize("argv,ext", [([], "y4m"), ([], "fvid"), (["-s", "1:2"], "y4m"),
                                      (["-r", "30"], "fvid"),
                                      (["-c", "pixel_format=yuv420p"], "y4m")])
def test_transcode_files_equal(tmp_path, clip, argv, ext):
    src = _clip(tmp_path, *clip)
    a, b = _both(tmp_path, jtranscode, ttranscode, ["-q"] + argv + [src], ext)
    assert a == b
    assert set(ttranscode.LAST_STAGE_TIMES) == {"copy"}


def test_transcode_round_trip_and_budget(tmp_path, capsys):
    src = _clip(tmp_path, "c420.y4m", "yuv420p", 5, 8, 12)
    mid, back = str(tmp_path / "m.fvid"), str(tmp_path / "b.y4m")
    # fvid holds the clip as float yuv444 through RGB; asking for yuv420p
    # on the way back returns every stored pel
    assert ttranscode.main(["-q", src, mid]) == 0
    assert ttranscode.main(["-q", "-c", "pixel_format=yuv420p", mid, back]) == 0
    assert open(back, "rb").read() == open(src, "rb").read()
    # -s past the end: the unclamped budget reads past EOF in both
    for tool in (jtranscode, ttranscode):
        assert tool.main(["-q", "-s", "0:100", src, str(tmp_path / "x.y4m")]) == 1
        assert "end of stream" in capsys.readouterr().err


def test_help_usage_and_exit_codes(tmp_path, capsys):
    src = _clip(tmp_path, *CLIPS[0])
    for jt, tt in ((jrotate, trotate), (jtranscode, ttranscode)):
        assert jt.main(["-h"]) == tt.main(["-h"]) == 0
        out = capsys.readouterr().out
        half = len(out) // 2
        assert out[:half] == out[half:] and tt.USAGE == jt.USAGE
        for argv in ([], ["-Z"], [src]):
            assert jt.main(argv) == tt.main(argv) == 1
            err = capsys.readouterr().err
            assert err[: len(err) // 2] == err[len(err) // 2:]
    missing = str(tmp_path / "missing.y4m")
    for jt, tt, argv in ((jrotate, trotate, ["-q", "zyx", missing, str(tmp_path / "o.y4m")]),
                         (jrotate, trotate, ["-q", "zzx", src, str(tmp_path / "o.y4m")]),
                         (jtranscode, ttranscode, ["-q", missing, str(tmp_path / "o.y4m")]),
                         (jtranscode, ttranscode, ["-q", "-c", "pixel_format=nonesuch", src,
                                                   str(tmp_path / "o.y4m")])):
        assert jt.main(argv) == tt.main(argv) == 1
        err = capsys.readouterr().err.splitlines()
        assert err[0][:24] == err[1][:24], err


@pytest.mark.parametrize("tool", [trotate, ttranscode], ids=["rotate", "transcode"])
@pytest.mark.parametrize("target", ["o.webm", "-F matroska", "o.mp4", "ffplay:", "-e mpeg4",
                                    "-e libx264", "-F mp4", "in.nut"])
def test_refusals_name_item_13(tmp_path, capsys, monkeypatch, tool, target):
    """The targets the port once refused (ROADMAP item 13) now take the
    JAX tools' paths: with ffmpeg hidden, the same exit code and leading
    error text; under the shim binaries, the same exit code, ffmpeg and
    ffplay argv and output bytes."""
    jt = jrotate if tool is trotate else jtranscode
    lead = ["-q"] + (["zyx"] if tool is trotate else [])
    for shims in (False, True):
        got = {}
        for name, t in (("jax", jt), ("torch", tool)):
            d = tmp_path / f"{name}{int(shims)}"
            d.mkdir()
            src = _clip(d, *CLIPS[0])
            with monkeypatch.context() as mp:
                log = use_shims(mp, str(d)) if shims else hide_ffmpeg(mp)
                out = str(d / "o.y4m")
                if target.startswith("-"):
                    argv = lead + target.split() + [src, out]
                elif target == "in.nut":
                    nut = str(d / "in.nut")
                    open(nut, "wb").write(b"nut/multimedia container\0")
                    argv = lead + [nut, out]
                else:
                    argv = lead + [src, target if target == "ffplay:" else str(d / target)]
                rc = t.main(argv)
                clear_ffmpeg_caches()
            err = capsys.readouterr().err.replace(str(d), "D")
            argvs = sorted(open(log).read().replace(str(d), "D").splitlines()) \
                if shims and os.path.exists(log) else []
            outs = {p.name: p.read_bytes() for p in d.iterdir() if p.name.startswith("o.")}
            got[name] = (rc, err[:60] if rc else "", argvs, outs)
        assert got["torch"] == got["jax"]
        if not shims and not target.startswith(("-e", "in.")):  # y4m ignores -e
            assert got["torch"][0] == 1 and ("ffmpeg" in err or "ffplay" in err)


def test_dispatcher_runs_rotate_and_transcode(tmp_path):
    src = _clip(tmp_path, *CLIPS[1])
    r, t = str(tmp_path / "r.y4m"), str(tmp_path / "t.fvid")
    assert tmain.main(["rotate", "-q", "zyx", src, r]) == 0
    assert tmain.main(["transcode", "-q", src, t]) == 0
    with tvideo.open_input(r) as rr, jvideo.open_input(t) as tt:
        assert (rr.width, rr.height, rr.frames) == (5, 8, 12)
        assert (tt.width, tt.height, tt.frames) == (12, 8, 5)


@pytest.mark.parametrize("tool", ["rotate", "transcode"])
@pytest.mark.parametrize("clip", CLIPS, ids=lambda c: c[1])
@pytest.mark.parametrize("argv,ext", [([], "nut"), (["-e", "rawvideo"], "nut"),
                                      (["-e", "ffv1", "-O", "level=3:slices=4"], "nut"),
                                      ([], "mkv")])
def test_nut_and_mkv_files_equal(tmp_path, monkeypatch, tool, clip, argv, ext):
    """FFV1 by default (NUT and Matroska), rawvideo and level 3 on request:
    the files equal the JAX tools' byte for byte (the JAX package writes
    native Matroska when no ffmpeg binary is on PATH), and the port reads
    them back to the planes the JAX package reads."""
    hide_ffmpeg(monkeypatch)  # both packages' native Matroska
    src = _clip(tmp_path, *clip)
    jt, tt = (jrotate, trotate) if tool == "rotate" else (jtranscode, ttranscode)
    lead = ["-q"] + argv + (["zyx"] if tool == "rotate" else [])
    if "ffv1" in argv and clip[1] == "gbrpf32le":
        # FFV1 codes no float samples: the JAX package's bridge, refused here
        out = str(tmp_path / f"o.{ext}")
        assert jt.main(lead + [src, out]) == tt.main(lead + [src, out]) == 1
        return
    a, b = _both(tmp_path, jt, tt, lead + [src], ext)
    assert a == b
    with tvideo.open_input(str(tmp_path / f"t_o.{ext}")) as r, \
            jvideo.open_input(str(tmp_path / f"j_o.{ext}")) as j:
        assert r.frames == j.frames > 0 and r.pix_fmt.name == j.pix_fmt.name
        for _ in range(r.frames):
            for p, q in zip(r.read_frame(raw=True), j.read_frame(raw=True)):
                np.testing.assert_array_equal(p, q)


def test_ffv1_round_trip_reads_every_container(tmp_path):
    """transcode y4m -> NUT (FFV1) -> MKV -> fvid -> y4m returns the clip's
    bytes: FFV1 is lossless, and the NUT and Matroska readers feed the
    next hop."""
    src = _clip(tmp_path, "c420.y4m", "yuv420p", 5, 8, 12)
    hops = [src] + [str(tmp_path / n) for n in ("a.nut", "b.mkv", "c.nut", "back.y4m")]
    for a, b in zip(hops, hops[1:]):
        assert ttranscode.main(["-q", a, b]) == 0
    assert open(hops[-1], "rb").read() == open(src, "rb").read()
