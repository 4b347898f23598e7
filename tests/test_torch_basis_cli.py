"""The port's ``applybasis``, ``genbasis`` and ``draw`` CLIs against the
JAX package's, on the CPU.

The same PNG goes through ``dspfun_tpu.tools.<tool>`` and
``dspfun_tpu_torch.tools.<tool> --device cpu`` with the same flags.  With
both packages at ``f64`` the PNGs are equal byte for byte, and the
``.coeff`` dumps carry the same header and agree within 1e-12 of the
largest |value| (each package sums the partial-sum windows in its own
order); genbasis is host float64 in both and equal at any policy.  At
the tools' default policy (the port in complex64, the JAX package with
x64 in complex128) the PNGs agree within one 8-bit level.
"""

import io
import struct
import sys

import numpy as np
import pytest
import torch

from dspfun_tpu.core import precision as jprec
from dspfun_tpu.tools import applybasis as japply
from dspfun_tpu.tools import draw as jdraw
from dspfun_tpu.tools import genbasis as jgen
from dspfun_tpu_torch.core import precision as tprec
from dspfun_tpu_torch.io import images as timages
from dspfun_tpu_torch.models import basis_pipeline as tb
from dspfun_tpu_torch.tools import applybasis as tapply
from dspfun_tpu_torch.tools import draw as tdraw
from dspfun_tpu_torch.tools import genbasis as tgen
from dspfun_tpu_torch.tools import main as tmain


@pytest.fixture(autouse=True)
def _policies(monkeypatch):
    monkeypatch.delenv("DSPFUN_PRECISION", raising=False)
    saved = (jprec._default, jprec._explicit, tprec._default, tprec._explicit)
    jprec._default, jprec._explicit = jprec.Precision(), False
    tprec._default, tprec._explicit = tprec.Precision(), False
    yield
    jprec._default, jprec._explicit, tprec._default, tprec._explicit = saved


def _f64():
    jprec.set_precision(jprec.Precision.parse("f64:f64"))
    tprec.set_precision(tprec.Precision.parse("f64:f64"))


def _png(tmp_path, h=16, w=16, name="src.png"):
    """A smooth seeded image with noise: no coefficient is zero, so no
    value lands on a rounding tie, where the sign of a float64 residue
    (the packages' summation orders differ) would pick the level."""
    y, x = np.mgrid[0:h, 0:w] / 8.0
    img = np.clip(np.stack([0.5 + 0.3 * np.sin(3 * x + y), 0.5 + 0.3 * np.cos(2 * y - x),
                            0.4 + 0.3 * np.sin(x + y)], -1), 0, 1)
    img = img + 0.1 * (np.random.default_rng(h * w).random((h, w, 3)) - 0.5)
    path = str(tmp_path / name)
    timages.write_image(path, img)
    return path


def _levels(path):
    return np.round(timages.read_image(path, channels="RGBA").pixels * 255).astype(np.int64)


def _both(tmp_path, jtool, ttool, flags, src, tag="o", device=True):
    jout, tout = str(tmp_path / f"j_{tag}.png"), str(tmp_path / f"t_{tag}.png")
    assert jtool.main(list(flags) + ([src] if src else []) + [jout]) == 0
    dev = ["--device", "cpu"] if device else []
    assert ttool.main(dev + list(flags) + ([src] if src else []) + [tout]) == 0
    return jout, tout


APPLY_FLAGS = [
    ["-f", "DCT2", "-u", "4x4", "-S", "2"],
    ["-f", "DFT", "-P", "magnitude", "-R", "linearlog", "-N", "hue", "-g", "--bg", "#204080",
     "-u", "4x4"],
    ["-f", "DFT", "-P", "phase", "-N", "abs", "-t", "8x8", "-O", "2x1"],
    ["-f", "iDFT", "-P", "imaginary", "-N", "shift", "-u", "2x4", "-p", "0"],
    ["-f", "WHT", "-I", "-N", "invert", "-u", "4x4", "-p", "2", "--bg", "rgba(10,20,30,0.5)"],
    ["-f", "DCT1", "-R", "gain", "-N", "abs", "-u", "4x4"],
    ["-f", "DST1", "-R", "level-log", "-u", "2x2"],
    ["-f", "DHT", "-u", "8x8", "-S", "3", "-g"],
    ["-f", "dct", "-u", "16x16", "-R", "log"],
]


@pytest.mark.parametrize("flags", APPLY_FLAGS, ids=lambda f: "_".join(f[1:4]))
def test_applybasis_png_equal_at_f64_and_within_a_level_at_default(tmp_path, flags):
    src = _png(tmp_path)
    j, t = _both(tmp_path, japply, tapply, flags, src, "default")
    a, b = _levels(j), _levels(t)
    # -N invert jumps from white to black at 0, so where the two
    # precisions round a near-zero value to opposite signs a pel flips
    # whole; its levels are held at f64 only
    assert a.shape == b.shape and ("invert" in flags or np.max(np.abs(a - b)) <= 1)
    _f64()
    j, t = _both(tmp_path, japply, tapply, flags, src, "f64")
    assert open(j, "rb").read() == open(t, "rb").read()
    assert set(tapply.LAST_STAGE_TIMES) >= {"read", "plan", "h2d", "compute", "d2h", "values",
                                            "render", "write"}


def _coeff(path):
    data = open(path, "rb").read()
    return data[:16], np.frombuffer(data[16:], dtype=np.complex128)


def test_readme_loop_and_inverse_from_a_coeff_dump(tmp_path):
    """The applybasis README loop (tests/test_reference_examples.py):
    progressive sums, the full-sum dump and the inverse from it, through
    both packages at f64, and each package's dump read by the other."""
    src = _png(tmp_path, name="flower16.png")
    _f64()
    for i in (1, 4, 16):
        j, t = _both(tmp_path, japply, tapply, ["-f", "DCT2", "-u", f"{i}x{i}", "-S", str(i)], src,
                     f"fdct_{i}")
        assert open(j, "rb").read() == open(t, "rb").read()
    jc, tc = str(tmp_path / "j.coeff"), str(tmp_path / "t.coeff")
    assert japply.main(["-fDCT2", "-u", "16x16", "-S", "16", "-d", jc, src,
                        str(tmp_path / "j_full.png")]) == 0
    assert tapply.main(["--device", "cpu", "-fDCT2", "-u", "16x16", "-S", "16", "-d", tc, src,
                        str(tmp_path / "t_full.png")]) == 0
    assert open(tmp_path / "j_full.png", "rb").read() == open(tmp_path / "t_full.png", "rb").read()
    (jh, jv), (th, tv) = _coeff(jc), _coeff(tc)
    assert jh == th == struct.pack("<QQ", 16, 16) and jv.shape == tv.shape == (16 * 16 * 3,)
    assert np.max(np.abs(jv - tv)) <= 1e-12 * np.abs(jv).max()
    # the inverse, each package from each package's dump
    outs = {}
    for name, tool, dev in (("j", japply, []), ("t", tapply, ["--device", "cpu"])):
        for dump in (jc, tc):
            out = str(tmp_path / f"inv_{name}_{dump[-7]}.png")
            assert tool.main(dev + ["-f", "DCT3", "-I", "-u", "16x16", "-S", "16", dump, out]) == 0
            outs[(name, dump)] = open(out, "rb").read()
    assert outs[("j", jc)] == outs[("t", jc)] == outs[("t", tc)] == outs[("j", tc)]
    rec = timages.read_image(str(tmp_path / f"inv_t_{tc[-7]}.png")).pixels
    assert rec.shape[0] == 16 * 16 + 2
    img = timages.read_image(src).pixels
    small = rec[1:-1, 1:-1].reshape(16, 16, 16, 16, 3).mean((1, 3))
    assert np.sqrt(np.mean((small - img) ** 2)) < 0.1
    # -u 4x4 from the dump: 4x4 tiles, each one block's contribution
    j, t = _both(tmp_path, japply, tapply, ["-f", "DCT3", "-I", "-u", "4x4"], tc, "blocks")
    assert open(j, "rb").read() == open(t, "rb").read()


def test_applybasis_default_inverse_within_a_level(tmp_path):
    src = _png(tmp_path, 32, 24)
    tc = str(tmp_path / "t.coeff")
    assert tapply.main(["--device", "cpu", "-fDCT2", "-u", "24x32", "-d", tc, src,
                        str(tmp_path / "full.png")]) == 0
    j, t = _both(tmp_path, japply, tapply, ["-f", "DCT3", "-I", "-u", "24x32"], tc, "inv")
    assert np.max(np.abs(_levels(j) - _levels(t))) <= 1
    # the full inverse returns the input within a level
    back = _levels(t)[1:-1, 1:-1, :3]
    assert np.max(np.abs(back - _levels(src)[..., :3])) <= 1


GEN_FLAGS = [
    ["--function", "DFT", "--size", "16x16", "--padding", "2", "--natural", "--plane", "complex"],
    ["--function", "DCT2", "--size", "8x8", "--padding", "4", "--scale", "4"],
    ["-f", "WHT", "-s", "8x8", "-I", "-P", "phase", "-g", "--bg", "#fff"],
    ["-f", "iDFT", "-s", "16x8", "-t", "4x2", "-O", "1x1", "-P", "magnitude", "-p", "0"],
    ["-f", "DST3", "-s", "8x16", "-P", "imaginary", "--bg", "rgba(0,0,0,0.25)"],
    ["-f", "DHT", "-s", "8x8", "-P", "complex", "--bg", "green", "-n"],
]


@pytest.mark.parametrize("flags", GEN_FLAGS, ids=lambda f: "_".join(f[1:4]))
def test_genbasis_png_equal(tmp_path, flags):
    j, t = _both(tmp_path, jgen, tgen, flags, None, device=False)
    assert open(j, "rb").read() == open(t, "rb").read()
    _f64()
    j, t = _both(tmp_path, jgen, tgen, flags, None, "f64", device=False)
    assert open(j, "rb").read() == open(t, "rb").read()


def test_genbasis_realize_equal():
    grid = tb.gen_basis_grid("dft", (8, 8), natural=True)
    for plane in ("real", "imaginary", "magnitude", "phase", "complex"):
        assert jgen.genbasis_realize(grid, plane).tobytes() == \
            tgen.genbasis_realize(grid, plane).tobytes()
    with pytest.raises(ValueError):
        tgen.genbasis_realize(grid, "nonesuch")


@pytest.mark.parametrize("flags", [["-b", "64x64", "-f", "3x3:0.4", "-f", "2x5:0.2", "-f", "4x6:0.2"],
                                   ["-b", "48x32", "-f", "7x1", "-f", "0x5:0.3", "-f", "20x20"],
                                   ["-b", "16x24"]])
def test_draw_png_equal(tmp_path, flags):
    j, t = _both(tmp_path, jdraw, tdraw, flags, None, "default")
    assert open(j, "rb").read() == open(t, "rb").read()
    assert set(tdraw.LAST_STAGE_TIMES) == {"compute", "write"}
    _f64()
    j, t = _both(tmp_path, jdraw, tdraw, flags, None, "f64")
    assert open(j, "rb").read() == open(t, "rb").read()


def _run(tool, argv, capsys):
    rc = tool.main(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


def test_help_usage_and_exit_codes(tmp_path, capsys):
    src = _png(tmp_path)
    for jt, tt, dev in ((japply, tapply, True), (jgen, tgen, False), (jdraw, tdraw, True)):
        rj, oj, _ = _run(jt, ["-h"], capsys)
        rt, ot, _ = _run(tt, ["-h"], capsys)
        assert rj == rt == 0 and ot.startswith(oj.rstrip("\n"))
        assert ("--device" in ot) == dev
        assert tt.USAGE == jt.USAGE
        for argv in ([], ["-Z"], ["--nonesuch"]):
            rj, _, ej = _run(jt, argv, capsys)
            rt, _, et = _run(tt, argv, capsys)
            assert rj == rt == 1 and ej == et, (tt.__name__, argv)
    # applybasis: too many arguments, bad -R, bad pairs, bad --bg
    for argv in ([src, "a.png", "b.png"], ["-R", "nonesuch", src, "o.png"],
                 ["-u", "4", src, "o.png"], ["--bg", "#12", src, "o.png"],
                 ["-p", "x", src, "o.png"], [str(tmp_path / "missing.png"), str(tmp_path / "o.png")]):
        rj, _, ej = _run(japply, argv, capsys)
        rt, _, et = _run(tapply, ["--device", "cpu"] + argv, capsys)
        assert rj == rt == 1 and ej.splitlines()[0][:20] == et.splitlines()[0][:20], argv
    # applybasis: a bad -f is the pipeline's ValueError in both packages
    for tool, dev in ((japply, []), (tapply, ["--device", "cpu"])):
        with pytest.raises(ValueError, match="unknown basis family 'haar'"):
            tool.main(dev + ["-f", "haar", src, str(tmp_path / "o.png")])
    # genbasis: no size, a bad --bg, too many arguments
    for argv in (["o.png"], ["-s", "8x8", "--bg", "chartreuse", "o.png"], ["-s", "8x8", "a", "b"]):
        rj, _, ej = _run(jgen, argv, capsys)
        rt, _, et = _run(tgen, argv, capsys)
        assert rj == rt == 1 and ej == et, argv
    # draw: coefficients outside the canvas, a bad pair, a bad strength
    for argv in (["-b", "16x16", "-f", "16x0", "o.png"], ["-b", "16x16", "-f", "0x-1:0.5", "o.png"],
                 ["-b", "16", "o.png"], ["-b", "16x16", "-f", "1x1:x", "o.png"]):
        rj, _, ej = _run(jdraw, argv, capsys)
        rt, _, et = _run(tdraw, ["--device", "cpu"] + argv, capsys)
        assert rj == rt == 1 and ej == et, argv


def test_refusals_name_the_roadmap_item(tmp_path, capsys, monkeypatch):
    """The outputs the port once refused (ROADMAP items 8 and 21) are
    written as the JAX tools write them: the same exit code and files
    that decode within one 8-bit level on average; sixel on a terminal
    the JAX encoder's bytes of the image the same run writes to
    ``ppm:-``."""
    from dspfun_tpu.io import images as jimages
    from dspfun_tpu.io import sixel as jsixel

    src = _png(tmp_path)
    cases = ((japply, tapply, [src], True), (jgen, tgen, ["-s", "8x8"], False),
             (jdraw, tdraw, ["-b", "8x8"], True))
    for (jt, tt, argv, dev), ext in zip(cases, ("jpg", "bmp", "tiff")):
        rcs = []
        for name, tool in (("j", jt), ("t", tt)):
            rcs.append(tool.main((["--device", "cpu"] if dev and name == "t" else [])
                                 + argv + [str(tmp_path / f"{name}o.{ext}")]))
        errs = capsys.readouterr().err
        assert rcs[0] == rcs[1], errs
        made = [(tmp_path / f"{n}o.{ext}").exists() for n in "jt"]
        assert made[0] == made[1]
        if made[0]:
            a, b = (jimages.read_image(str(tmp_path / f"{n}o.{ext}")).pixels for n in "jt")
            assert np.abs(a - b).mean() <= 1 / 255 and np.abs(a - b).max() <= 0.1
    for jt, tt, argv, dev in cases:
        out = {}
        for name, tool, target in (("j", jt, None), ("t", tt, None), ("ref", tt, "ppm:-")):
            std = io.TextIOWrapper(io.BytesIO())
            monkeypatch.setattr(sys, "stdout", std)
            monkeypatch.setattr(std, "isatty", lambda: target is None)
            rc = tool.main((["--device", "cpu"] if dev and name != "j" else []) + argv
                           + ([target] if target else []))
            assert rc == 0
            std.flush()
            out[name] = std.buffer.getvalue()
        ppm = out["ref"]
        h, w = map(int, ppm.split(b"\n")[1].split())
        ref8 = np.frombuffer(ppm[ppm.index(b"255\n") + 4:], np.uint8).reshape(h, w, 3)
        assert out["j"].split(b"#", 1)[0] == out["t"].split(b"#", 1)[0]
        assert out["t"] == jsixel.encode_sixel(ref8)


def test_device_defaults_to_the_card(tmp_path, capsys):
    src = _png(tmp_path)
    if torch.cuda.is_available():
        return
    for tool, argv in ((tapply, [src, str(tmp_path / "o.png")]),
                       (tdraw, ["-b", "8x8", str(tmp_path / "o.png")])):
        assert tool.main(argv) == 1
        assert "Bad --device" in capsys.readouterr().err
        assert tool.main(["--device", "cuda"] + argv) == 1
    assert not (tmp_path / "o.png").exists()


def test_dispatcher_runs_the_basis_tools(tmp_path, capsys):
    src = _png(tmp_path)
    outs = [str(tmp_path / f"{n}.png") for n in ("a", "g", "d")]
    assert tmain.main(["applybasis", "--device", "cpu", "-f", "DCT2", "-u", "4x4", src, outs[0]]) == 0
    assert tmain.main(["genbasis", "-s", "8x8", outs[1]]) == 0
    assert tmain.main(["draw", "--device", "cpu", "-b", "32x16", "-f", "2x3:0.5", outs[2]]) == 0
    shapes = [timages.read_image(p).pixels.shape for p in outs]
    assert shapes == [(16 * 4 * 1 + 17, 16 * 4 + 17, 3), (8 * 9 + 1, 8 * 9 + 1, 3), (16, 32, 3)]
    for name in ("applybasis", "genbasis", "draw"):
        assert tmain.main([name, "-h"]) == 0
        assert f"Usage: {name}" in capsys.readouterr().out
