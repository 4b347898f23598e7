"""The port's NUT container (``dspfun_tpu_torch/io/nut.py`` and the NUT
classes of ``io/video.py``) against the JAX package's.

* Every case of ``tests/test_nut.py`` runs on the port's modules
  (``tests/torch_port_cases.py``), but the JAX tools' mesh call and the
  JAX tools (the port's tools write NUT in the CLI tests).
* The same planes through both packages' writers give equal bytes, for
  FFV1 at levels 1 and 3, rawvideo, 16-bit and float content, and each
  package's reader decodes the other's file to equal planes.
* Where the JAX package routes to its ffmpeg bridge, so does the port
  (the same errors without a binary, the same argv and bytes under the
  shims); where it falls back to rawvideo payloads because the FFV1
  library cannot be built the port raises the build's error.
"""

import os
from fractions import Fraction

import numpy as np
import pytest

import tests.test_nut as jnut_tests
from dspfun_tpu.io import video as jvideo
from dspfun_tpu_torch import _hostbuild
from dspfun_tpu_torch.io import ffv1 as tffv1
from dspfun_tpu_torch.io import nut as tnut
from dspfun_tpu_torch.io import video as tvideo
from tests.torch_port_cases import (clear_ffmpeg_caches, hide_ffmpeg, port_cases, run_on_port,
                                    use_shims)

SKIP = {
    "test_tools_roundtrip_through_nut": "the JAX tools; the port's write NUT in the CLI tests",
    "test_scan_mesh_with_packed_emission": "the JAX tool's call (no --device); "
                                           "test_torch_mesh_cli.py runs it on the port",
}


@pytest.mark.parametrize("case", port_cases(jnut_tests, SKIP))
def test_jax_nut_case_on_the_port(case, request):
    run_on_port(request, jnut_tests, *case)


WRITES = [  # (pix_fmt, codec, options)
    ("yuv420p", None, None), ("yuv420p", "rawvideo", None), ("gray", None, "level=3:slices=4"),
    ("yuv444p16le", None, None), ("gbrp", None, None), ("gbrpf32le", None, None),
    ("gbrpf32le", None, "negotiate=1"), ("yuv422p10le", "ffv1", None),
]


@pytest.mark.parametrize("pix_fmt,codec,options", WRITES)
def test_writers_give_equal_bytes_and_cross_decode(pix_fmt, codec, options, tmp_path):
    rng = np.random.default_rng(3)
    frames = [rng.random((18, 22, 3)) for _ in range(3)]
    paths = {}
    for name, mod in (("jax", jvideo), ("torch", tvideo)):
        path = tmp_path / f"{name}.nut"
        w = mod.open_output(str(path), 22, 18, Fraction(30000, 1001),
                            mod.ColorProps(pix_fmt=pix_fmt, color_range="jpeg"),
                            codec=codec, options=options)
        w.write_frame_rgb(frames[0])
        w.write_frame(mod.rgb_to_planes(frames[1], w.pix_fmt, w.props))
        w.write_frame_payload(b"".join(
            np.asarray(mod._quantize_plane(p, w.pix_fmt, i, w.props.color_range)).tobytes()
            for i, p in enumerate(mod.rgb_to_planes(frames[2], w.pix_fmt, w.props))))
        w.close()
        paths[name] = path
    assert paths["jax"].read_bytes() == paths["torch"].read_bytes()
    for path in paths.values():
        with jvideo.open_input(str(path)) as a, tvideo.open_input(str(path)) as b:
            assert type(b).__name__ == type(a).__name__ == "NutVideoReader"
            assert (b.frames, b.pix_fmt.name, b.rate, vars(b.props)) == \
                (a.frames, a.pix_fmt.name, a.rate, vars(a.props))
            for _ in range(3):
                for x, y in zip(a.read_frame(raw=True), b.read_frame(raw=True)):
                    np.testing.assert_array_equal(x, y)
            assert b.read_frame() is None


def test_append_gives_equal_bytes(tmp_path):
    pf = tvideo.PIXEL_FORMATS["yuv420p"]
    rng = np.random.default_rng(4)
    frames = [[rng.integers(0, 256, (h, w)).astype(float) for w, h in pf.plane_dims(16, 12)]
              for _ in range(4)]
    out = []
    for name, mod in (("jax", jvideo), ("torch", tvideo)):
        path = str(tmp_path / f"{name}.nut")
        for part, append in ((frames[:2], False), (frames[2:], True)):
            with mod.open_output(path, 16, 12, Fraction(25), mod.ColorProps(pix_fmt="yuv420p"),
                                 append=append) as w:
                for f in part:
                    w.write_frame(f, raw=True)
        out.append(open(path, "rb").read())
    assert out[0] == out[1]
    with tvideo.open_input(str(tmp_path / "torch.nut")) as r:
        assert r.frames == 4


def _bridge_parity(tmp_path, monkeypatch, run):
    """``run(video_module, d)`` on both packages, with ffmpeg hidden and
    under the shims, each in a directory of its own: the same result
    (``d`` written ``D``), shim argv and files."""
    for shims in (False, True):
        got = {}
        for name, mod in (("jax", jvideo), ("torch", tvideo)):
            d = tmp_path / f"{name}{int(shims)}"
            d.mkdir()
            with monkeypatch.context() as mp:
                log = use_shims(mp, str(d)) if shims else hide_ffmpeg(mp)
                try:
                    res = run(mod, d)
                except (RuntimeError, ValueError) as e:
                    res = (type(e).__name__, str(e))
                clear_ffmpeg_caches()
            argv = sorted(open(log).read().splitlines()) if shims and os.path.exists(log) else []
            files = sorted((p.name, p.read_bytes()) for p in d.iterdir() if p.suffix == ".nut")
            got[name] = repr((res, argv, files)).replace(str(d), "D")
        assert got["torch"] == got["jax"]


def test_foreign_codec_is_refused(tmp_path, monkeypatch):
    """A foreign encoder on a NUT target, and FFV1 for float pels, are the
    ffmpeg bridge's in both packages (once refused by the port, ROADMAP
    item 13): the same error without a binary, the same argv and bytes
    under the shims; FFV1 of integer pels stays native."""
    def run(mod, d):
        out = []
        for name, pix, codec in (("e", "yuv420p", "h264"), ("f", "gbrpf32le", "ffv1"),
                                 ("g", "yuv420p", "ffv1")):
            try:
                with mod.open_output(str(d / f"{name}.nut"), 8, 6, Fraction(25),
                                     mod.parse_color_props(f"pixel_format={pix}"),
                                     codec=codec) as w:
                    w.write_frame_rgb(np.full((6, 8, 3), 0.5))
                    out.append((type(w).__name__, getattr(w, "codec", None)))
            except RuntimeError as e:
                out.append(str(e))
        return out

    _bridge_parity(tmp_path, monkeypatch, run)


def test_undecodable_ffv1_is_refused(tmp_path, monkeypatch):
    """A NUT file whose FFV1 stream the native decoder rejects goes to the
    ffmpeg bridge in both packages (once refused by the port, ROADMAP
    item 13): the same error without a binary, the same argv under the
    shims."""
    def run(mod, d):
        pf = tvideo.PIXEL_FORMATS["yuv420p"]
        p = d / "alien.nut"
        with open(p, "wb") as f:
            nw = tnut.NutWriter(f, 8, 6, Fraction(25), pf, tvideo.ColorProps(), codec="ffv1")
            nw.write_header()
            nw.write_frame_bytes(b"\x00" * 64)
        with mod.open_input(str(p)) as r:
            return r.format, r.read_frame(raw=True) is None

    _bridge_parity(tmp_path, monkeypatch, run)


def test_no_rawvideo_fallback_when_ffv1_cannot_build(tmp_path, monkeypatch):
    """Where the JAX package writes rawvideo payloads because libffv1
    cannot be built, the port raises the build's error: for the FFV1
    default of integer content and for reading FFV1."""
    good = tmp_path / "good.nut"
    with tvideo.open_output(str(good), 8, 6, Fraction(25),
                            tvideo.ColorProps(pix_fmt="gray")) as w:
        w.write_frame([np.zeros((6, 8))], raw=True)

    def broken():
        raise RuntimeError("g++ failed (1): cannot build ffv1")

    monkeypatch.setattr(tffv1, "_load", broken)
    with pytest.raises(RuntimeError, match="g.. failed"):
        tvideo.open_output(str(tmp_path / "a.nut"), 8, 6, Fraction(25),
                           tvideo.ColorProps(pix_fmt="gray"))
    with pytest.raises(RuntimeError, match="g.. failed"):
        tvideo.open_input(str(good))
    # float content never needed the codec
    with tvideo.open_output(str(tmp_path / "f.nut"), 8, 6, Fraction(25),
                            tvideo.ColorProps(pix_fmt="grayf32le")) as w:
        assert w.codec == "rawvideo"
    assert _hostbuild.library_path("ffv1").parent == _hostbuild.build_dir()
