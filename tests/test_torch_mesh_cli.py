"""The port's CLIs over a mesh of CPU ranks (``--device cpu``) against
the JAX CLIs over their mesh of 8 forced CPU devices, on the cases of
``tests/test_mesh_cli.py`` and ``tests/test_spec_sharded.py``.

Each port run starts its own ranks (``tools.launch``, ``spawn``); rank 0
writes the file.  Tolerances are the JAX mesh tests' own:

* motion's block route: the port's mesh output is **bit-equal** to the
  port's single-device output (space=3, two blocks per rank), and the
  port's and the JAX tool's mesh outputs (float fvid) agree to 1e-6;
  ragged batches (6 blocks over space=4) to 1e-6;
* motion's volume route (``-b 0x0x0`` over space=4,time=2): 1e-5, and
  the tool says so in its ``mesh:`` line;
* spec and ispec ``-M`` on an image that divides no mesh (30x50): two
  16-bit levels, and the round trip within 2e-3 rms;
* scan and zoom ``--mesh`` at an odd height: 1e-5.

What the port refuses exits 1 with the JAX tools' text: a stateful
``--eval`` under a mesh, a mesh larger than the devices, a time axis
for the space-only tools.
"""

import io
import sys
from fractions import Fraction

import jax
import numpy as np
import pytest

from dspfun_tpu.io import images as jimages
from dspfun_tpu.io import video as jvideo
from dspfun_tpu.tools import ispec as jispec
from dspfun_tpu.tools import motion as jmotion
from dspfun_tpu.tools import scan as jscan
from dspfun_tpu.tools import spec as jspec
from dspfun_tpu.tools import zoom as jzoom
from dspfun_tpu_torch.core import precision as tprec
from dspfun_tpu_torch.io import images as timages
from dspfun_tpu_torch.tools import ispec as tispec
from dspfun_tpu_torch.tools import motion as tmotion
from dspfun_tpu_torch.tools import scan as tscan
from dspfun_tpu_torch.tools import spec as tspec
from dspfun_tpu_torch.tools import zoom as tzoom

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")

CPU = ["--device", "cpu"]


@pytest.fixture(autouse=True)
def _policies(monkeypatch):
    """Each test starts from the packages' own defaults."""
    from dspfun_tpu.core import precision as jprec

    monkeypatch.delenv("DSPFUN_PRECISION", raising=False)
    monkeypatch.delenv("DSPFUN_MESH", raising=False)
    saved = (jprec._default, jprec._explicit, tprec._default, tprec._explicit)
    jprec._default, jprec._explicit = jprec.Precision(), False
    tprec._default, tprec._explicit = tprec.Precision(), False
    yield
    jprec._default, jprec._explicit, tprec._default, tprec._explicit = saved


def _write_clip(path, frames):
    t, h, w = frames.shape[:3]
    props = jvideo.parse_color_props("pixel_format=gbrpf32le")
    with jvideo.open_output(path, w, h, Fraction(25), props, format="fvid") as wr:
        for f in frames:
            wr.write_frame_rgb(f)


def _clip(path):
    with jvideo.open_input(path) as r:
        out = []
        while (f := r.read_frame_rgb()) is not None:
            out.append(f)
    return np.stack(out)


def _png(tmp_path, shape, seed):
    rng = np.random.default_rng(seed)
    path = str(tmp_path / "src.png")
    timages.write_image(path, rng.integers(0, 256, shape).astype(np.float64) / 255.0)
    return path


def test_motion_mesh_blocks_bit_identical(tmp_path):
    rng = np.random.default_rng(21)
    src = str(tmp_path / "in.fvid")
    _write_clip(src, rng.random((4, 16, 24, 3)).astype(np.float32))
    args = ["-Q", "-b", "8x8x2", "-p", "4x4x1", "-B", "1.5", "-D", "0.25",
            "-q", "0.5", "--preserve-dc"]
    out = {k: str(tmp_path / f"{k}.fvid") for k in ("one", "mesh", "jax")}
    assert tmotion.main(CPU + args + [src, out["one"]]) == 0
    # 6 blocks over space=3: two per rank
    assert tmotion.main(CPU + args + ["--mesh", "space=3", src, out["mesh"]]) == 0
    assert jmotion.main(args + ["--mesh", "space=3", src, out["jax"]]) == 0
    one, mesh, ref = (_clip(out[k]) for k in ("one", "mesh", "jax"))
    np.testing.assert_array_equal(mesh, one)
    np.testing.assert_allclose(mesh, ref, atol=1e-6, rtol=1e-6)


def test_motion_mesh_volume_route(tmp_path, capfd):
    rng = np.random.default_rng(22)
    src = str(tmp_path / "in.fvid")
    _write_clip(src, rng.random((4, 8, 16, 3)).astype(np.float32))
    args = ["-b", "0x0x0", "-p", "4x4x2", "-D", "0.5"]
    one, mesh, ref = (str(tmp_path / f"{k}.fvid") for k in ("one", "mesh", "jax"))
    assert tmotion.main(CPU + ["-Q"] + args + [src, one]) == 0
    capfd.readouterr()
    assert tmotion.main(CPU + args + ["--mesh", "space=4,time=2", src, mesh]) == 0
    err = capfd.readouterr().err
    assert "mesh: space=4 time=2 (plane 0: volume, plane 1: volume, plane 2: volume)" in err
    assert "ranks: 8 on cpu over gloo" in err
    assert jmotion.main(["-Q"] + args + ["--mesh", "space=4,time=2", src, ref]) == 0
    np.testing.assert_allclose(_clip(mesh), _clip(ref), atol=1e-5, rtol=1e-6)
    np.testing.assert_allclose(_clip(mesh), _clip(one), atol=1e-5, rtol=1e-6)


def test_motion_mesh_ragged_blocks(tmp_path):
    """24x16 at 8x8 -> 6 blocks over space=4: the batch pads internally."""
    rng = np.random.default_rng(23)
    src = str(tmp_path / "in.fvid")
    _write_clip(src, rng.random((2, 16, 24, 3)).astype(np.float32))
    args = ["-Q", "-b", "8x8x1", "-q", "2"]
    mesh, ref = str(tmp_path / "mesh.fvid"), str(tmp_path / "jax.fvid")
    assert tmotion.main(CPU + args + ["--mesh", "4", src, mesh]) == 0
    assert jmotion.main(args + ["--mesh", "4", src, ref]) == 0
    np.testing.assert_allclose(_clip(mesh), _clip(ref), atol=1e-6, rtol=1e-6)


def test_motion_mesh_refuses_a_stateful_eval(tmp_path, capsys):
    rng = np.random.default_rng(24)
    src = str(tmp_path / "in.fvid")
    _write_clip(src, rng.random((2, 8, 8, 3)).astype(np.float32))
    args = ["-Q", "-b", "8x8x1", "--eval", "c*(1+0.1*random(0))", "--mesh", "2", src]
    assert jmotion.main(args + [str(tmp_path / "j.fvid")]) == 1
    want = capsys.readouterr().err
    assert tmotion.main(CPU + args + [str(tmp_path / "t.fvid")]) == 1
    assert capsys.readouterr().err == want and "stateful av_expr" in want
    assert not (tmp_path / "t.fvid").exists()


def test_spec_and_ispec_mesh_pad_an_indivisible_image(tmp_path):
    src = _png(tmp_path, (30, 50, 3), 4)
    orig = timages.read_image(src).pixels
    paths = {k: str(tmp_path / f"{k}.png") for k in ("one", "mesh", "jax", "back", "jback")}
    assert tspec.main(CPU + ["-t", "shift", src, paths["one"]]) == 0
    assert tspec.main(CPU + ["-t", "shift", "-M", "3", src, paths["mesh"]]) == 0
    assert jspec.main(["-t", "shift", "-M", "8", src, paths["jax"]]) == 0
    one, mesh, ref = (timages.read_image(paths[k]) for k in ("one", "mesh", "jax"))
    assert mesh.pixels.shape == orig.shape and mesh.properties.keys() == ref.properties.keys()
    np.testing.assert_allclose(mesh.pixels, ref.pixels, atol=2.0 / 65535)
    np.testing.assert_allclose(mesh.pixels, one.pixels, atol=2.0 / 65535)
    assert tispec.main(CPU + ["-t", "shift", "-M", "3", paths["mesh"], paths["back"]]) == 0
    assert jispec.main(["-t", "shift", "-M", "8", paths["mesh"], paths["jback"]]) == 0
    back = timages.read_image(paths["back"]).pixels
    assert back.shape == orig.shape
    assert np.sqrt(np.mean((back - orig) ** 2)) < 2e-3
    np.testing.assert_allclose(back, jimages.read_image(paths["jback"]).pixels, atol=2.0 / 255)


def test_scan_mesh_odd_height(tmp_path):
    src = _png(tmp_path, (25, 25, 3), 16)
    args = ["-q", "-m", "zig", "-S", "13", "-P"]
    one, mesh, ref = (str(tmp_path / f"{k}.fvid") for k in ("one", "mesh", "jax"))
    assert tscan.main(CPU + args + [src, one]) == 0
    assert tscan.main(CPU + args + ["--mesh", "3", src, mesh]) == 0
    assert jscan.main(args + ["--mesh", "8", src, ref]) == 0
    np.testing.assert_allclose(_clip(mesh), _clip(ref), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(_clip(mesh), _clip(one), atol=1e-5, rtol=1e-5)


def test_scan_mesh_with_packed_emission(tmp_path):
    """--mesh and the packed emission on the device compose (the case of
    tests/test_nut.py): y4m frames within two levels of one device's."""
    src = _png(tmp_path, (16, 16, 3), 10)
    one, mesh = str(tmp_path / "one.y4m"), str(tmp_path / "mesh.y4m")
    assert tscan.main(CPU + ["-q", "-m", "zig", "-S", "16", src, one]) == 0
    assert tscan.main(CPU + ["-q", "-m", "zig", "-S", "16", "--mesh", "4", src, mesh]) == 0
    np.testing.assert_allclose(_clip(mesh), _clip(one), atol=2 / 255.0)


def test_zoom_mesh_odd_height(tmp_path):
    """3x of 15 rows: vh = 45 divides neither mesh, rows pad internally."""
    src = _png(tmp_path, (15, 16, 3), 15)
    args = ["-s", "3", "-n", "2", "-q", "--ff-format", "fvid"]
    one, mesh, ref = (str(tmp_path / f"{k}.fvid") for k in ("one", "mesh", "jax"))
    assert tzoom.main(CPU + args + [src, one]) == 0
    assert tzoom.main(CPU + args + ["--mesh", "4", src, mesh]) == 0
    assert jzoom.main(args + ["--mesh", "8", src, ref]) == 0
    a = _clip(mesh)
    assert a.shape[1] == 45
    np.testing.assert_allclose(a, _clip(ref), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(a, _clip(one), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("tool,args,msg", [
    ("spec", ["-M", "space=2,time=2"], "spec mesh uses the space axis only; pass -M N"),
    ("ispec", ["-M", "space=999"], "mesh unavailable (mesh needs 999 devices"),
    ("scan", ["--mesh", "time=2"], "scan --mesh shards space only (time=1); running single-device"),
    ("zoom", ["--mesh", "space=2,time=2"], "zoom --mesh shards space only (time=1)"),
    ("motion", ["--mesh", "rows=2"], "Bad --mesh: unknown mesh axis 'rows'"),
    ("motion", ["--nprocs", "2", "--proc-id", "0"], "needs --coordinator host:port"),
])
def test_what_cannot_run_exits_1_before_anything_is_read(tool, args, msg, tmp_path, capsys):
    mod = {"spec": tspec, "ispec": tispec, "scan": tscan, "zoom": tzoom, "motion": tmotion}[tool]
    out = str(tmp_path / ("o.fvid" if tool in ("motion", "zoom", "scan") else "o.png"))
    assert mod.main(CPU + args + [str(tmp_path / "missing.png"), out]) == 1
    err = capsys.readouterr().err
    assert msg in err and "missing.png" not in err
    assert not (tmp_path / out).exists()


class _Stdin:
    """A piped stdin holding ``data``."""

    def __init__(self, data: bytes):
        self.buffer = io.BufferedReader(io.BytesIO(data))

    def isatty(self):
        return False


def _spectrum(tmp_path, src):
    out = str(tmp_path / "spectrum.png")
    assert tspec.main(CPU + ["-t", "flat", "-G", "1000", src, out]) == 0
    return out


PIPE_CASES = {  # tool: (main, its input maker, the flags, the output)
    "spec": (tspec.main, lambda p: _png(p, (24, 40, 3), 41), ["-M", "2", "-t", "flat",
                                                              "-G", "1000"], "o.png"),
    "ispec": (tispec.main, lambda p: _spectrum(p, _png(p, (24, 40, 3), 42)),
              ["-M", "2", "-t", "flat", "-G", "1000"], "o.png"),
    "scan": (tscan.main, lambda p: _png(p, (24, 32, 3), 43),
             ["--mesh", "2", "-m", "zigzag", "-S", "64", "-q"], "o.y4m"),
    "zoom": (tzoom.main, lambda p: _png(p, (16, 20, 3), 44),
             ["--mesh", "2", "-s", "2", "-q"], "o.fvid"),
    "motion": (tmotion.main, None, ["-Q", "--frames", "8", "--mesh", "2", "-b", "16x16x4",
                                    "-B", "1.25"], "o.y4m"),
}


@pytest.mark.parametrize("tool", sorted(PIPE_CASES))
def test_mesh_reads_a_piped_input(tool, tmp_path, monkeypatch):
    """``-`` under a mesh: the launcher reads the pipe once and hands it
    to every rank (they start without stdin).  The mesh run on the pipe
    writes the bytes of the mesh run on the file; motion's block route
    and zoom write the bytes of the run without a mesh on the same pipe
    too, and spec, ispec and scan agree with it as the mesh tests above
    hold them (the sharded transforms round differently: two 16-bit
    levels, one 8-bit level)."""
    main, make, flags, out = PIPE_CASES[tool]
    if make is None:
        src = str(tmp_path / "in.y4m")
        rng = np.random.default_rng(45)
        pf = jvideo.PIXEL_FORMATS["yuv420p"]
        with jvideo.open_output(src, 32, 32, Fraction(25), jvideo.ColorProps(pix_fmt="yuv420p")) as w:
            for _ in range(12):
                w.write_frame([rng.integers(0, 256, (ph, pw)).astype(np.float64)
                               for pw, ph in pf.plane_dims(32, 32)], raw=True)
    else:
        src = make(tmp_path)
    data = open(src, "rb").read()
    nomesh = [a for i, a in enumerate(flags)
              if a not in ("-M", "--mesh") and (i == 0 or flags[i - 1] not in ("-M", "--mesh"))]
    got = {}
    for name, argv, piped in (("pipe", flags, True), ("file", flags, False),
                              ("one", nomesh, True)):
        monkeypatch.setattr(sys, "stdin", _Stdin(data))
        path = str(tmp_path / f"{name}.{out.split('.')[1]}")
        assert main(CPU + argv + ["-" if piped else src, path]) == 0, name
        got[name] = open(path, "rb").read()
    assert got["pipe"] == got["file"]
    if tool in ("motion", "zoom"):
        assert got["pipe"] == got["one"]
    elif tool == "scan":
        a, b = (np.frombuffer(got[k], np.uint8).astype(int) for k in ("pipe", "one"))
        assert a.size == b.size and np.abs(a - b).max() <= 1
    else:
        a, b = (np.asarray(timages.read_image(str(tmp_path / f"{k}.png")).pixels)
                for k in ("pipe", "one"))
        assert np.abs(a - b).max() <= 2 / 65535 + 1e-12
