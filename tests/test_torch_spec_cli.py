"""The port's ``spec`` and ``ispec`` CLIs against the JAX package's, on the
CPU (``--device cpu``), through files.

The same PNG goes through ``dspfun_tpu.tools.spec.main`` and
``dspfun_tpu_torch.tools.spec.main``; then the JAX tool's spectrum goes
through both ``ispec``s.  Sizes 64x48 (the default policy stays ``hilo``)
and 300x260 (it becomes ``exact``).  Stated tolerances, port vs JAX:

* every chunk but ``IDAT`` is byte-equal where the DC floats are
  bit-equal; elsewhere ``IHDR`` is equal and DC agrees within 2^-22, two
  float32 ulps of a mean below 1 (the float32 sums run in another order
  in PyTorch than in XLA);
* spec's 16-bit levels: within ``ceil(tol * 65535) + 1`` with ``tol`` the
  float tolerance of tests/test_torch_spec.py (2e-5 for the log scale at
  ``hilo``, else 1e-6), and at most 1 % of the pels differ at all;
* ispec's levels (same spectrum file in): within 2 at 16 bits and 1 at 8;
  at most 3 % of the pels differ, 25 % where the ``shift`` sign type's
  ``(f * 255 / 254 - 0.5) * 2`` amplifies float32 rounding (``-t flat``,
  ``-S shift``), and 26 levels where ``-g`` encodes that to sRGB;
* ``spec -t flat`` then ``ispec -t flat`` returns the input within the
  noise the spectrum's 16-bit levels leave, sqrt(w*h) * 0.58 levels rms;
  ``-t copy`` loses its negative coefficients to the PNG in both packages
  and is held to a float64 inverse of the file, within one level.

Usage errors, ``-h``, a missing DC, the signmap warning and unreadable
input give the JAX tool's exit code and message (the port's usage line
adds ``--device cuda|cpu`` after ``-M mesh``, and its help a
``--device`` line).  What the port refuses exits 1 by ROADMAP item and
writes nothing: sixel, other formats, and ``cuda`` without a card; a
``-M``/``--mesh``/``DSPFUN_MESH`` request the JAX tool would run on one
device (a time axis, more slots than devices) exits 1 with its message.
"""

import io
import math
import os
import struct
import sys

import numpy as np
import pytest
import torch

from dspfun_tpu.core import precision as jprecision
from dspfun_tpu.tools import _speccli as jcli
from dspfun_tpu.tools import ispec as jispec
from dspfun_tpu.tools import spec as jspec
from dspfun_tpu_torch.core import precision as tprecision
from dspfun_tpu_torch.io import images, png
from dspfun_tpu_torch.tools import _speccli as tcli
from dspfun_tpu_torch.tools import ispec as tispec
from dspfun_tpu_torch.tools import spec as tspec

SIZES = {"64x48": (64, 48), "300x260": (300, 260)}
TEMPLATES = ["abs", "shift", "flat", "sign", "copy"]
CPU = ["--device", "cpu"]
DC_TOL = 2.0 ** -22


def _source(path, w, h, seed=0, depth=8):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    pix = np.stack([0.5 + 0.4 * np.sin(x / (9.0 + i) + y / 13.0) for i in range(3)], -1)
    images.write_image(str(path), pix + 0.08 * rng.standard_normal((h, w, 3)), depth=depth)
    return str(path)


@pytest.fixture(scope="module")
def sources(tmp_path_factory):
    d = tmp_path_factory.mktemp("spec_src")
    return {name: _source(d / f"{name}.png", w, h) for name, (w, h) in SIZES.items()}


def _template_args(t):
    # flat/sign/copy take a custom gain, as tests/test_torch_spec.py
    return ["-t", t] + (["-G", "1000"] if t in ("flat", "sign", "copy") else [])


def _chunks(path):
    data = open(path, "rb").read()
    pos, out = 8, []
    while pos < len(data):
        ln, typ = struct.unpack(">I4s", data[pos:pos + 8])
        out.append((typ, data[pos + 8:pos + 8 + ln]))
        pos += 12 + ln
    return [c for c in out if c[0] != b"IDAT"]


def _compare(got, ref, levels, share, channels=3):
    """Port's file ``got`` against the JAX tool's ``ref``."""
    a, pa, _ = png.decode_png(open(got, "rb").read())
    b, pb, _ = png.decode_png(open(ref, "rb").read())
    assert (a.shape, a.dtype) == (b.shape, b.dtype)
    if pa == pb:
        assert _chunks(got) == _chunks(ref)
    else:
        assert _chunks(got)[0] == _chunks(ref)[0] and pa.keys() == pb.keys() == {"DC"}
        dca, dcb = (images.decode_dc_property(p["DC"], channels) for p in (pa, pb))
        assert np.max(np.abs(dca - dcb)) <= DC_TOL
        # float64 of a float32 value: the same 8 bytes a channel
        assert np.array_equal(dca, dca.astype(np.float32).astype(np.float64))
    diff = np.abs(a.astype(np.int64) - b.astype(np.int64))
    assert diff.max() <= levels, diff.max()
    assert (diff > 0).mean() <= share, (diff > 0).mean()
    return a


def _spec_levels(size, args):
    log = "linear" not in args and not any(t in args for t in ("flat", "sign", "copy"))
    tol = 2e-5 if (log and min(SIZES[size]) < 256) else 1e-6
    return math.ceil(tol * 65535) + 1


def _both(tmp_path, src, spec_args, ispec_args=None, channels=3, amplified=False,
          levels=2):
    """spec through both tools, then both ispecs on the JAX spectrum."""
    ts, js, tb, jb = (str(tmp_path / n) for n in ("t.png", "j.png", "tb.png", "jb.png"))
    assert tspec.main(CPU + spec_args + [src, ts]) == 0
    assert jspec.main(spec_args + [src, js]) == 0
    size = next(n for n, (w, h) in SIZES.items() if f"{n}.png" in src)
    _compare(ts, js, _spec_levels(size, spec_args), 0.01, channels)
    ispec_args = spec_args if ispec_args is None else ispec_args
    assert tispec.main(CPU + ispec_args + [js, tb]) == 0
    assert jispec.main(ispec_args + [js, jb]) == 0
    _compare(tb, jb, levels, 0.25 if amplified else 0.03, channels)
    return ts, tb


@pytest.mark.parametrize("t", TEMPLATES)
@pytest.mark.parametrize("size", SIZES)
def test_templates_match_the_jax_tools(size, t, sources, tmp_path):
    _both(tmp_path, sources[size], _template_args(t), amplified=t in ("flat", "shift"))
    assert set(tspec.LAST_STAGE_TIMES) == {"read", "h2d", "compute", "d2h", "write"}
    assert set(tispec.LAST_STAGE_TIMES) == {"read", "h2d", "compute", "d2h", "write"}


OPTIONS = {
    "-g": (["-g"], 3, False),
    "-c I": (["-c", "I"], 1, False),
    "-c RGBA": (["-c", "RGBA"], 4, False),
    "-R dcs": (["-R", "dcs"], 3, False),
    "-R one": (["-R", "one"], 3, False),
    "-G 2.5": (["-G", "2.5"], 3, False),
    "-S shift -T linear": (["-S", "shift", "-T", "linear"], 3, True),
    "-S retain -T log": (["-S", "retain", "-T", "log", "-R", "one"], 3, False),
    "-S saturate -T linear": (["-S", "saturate", "-T", "linear", "-R", "one"], 3, False),
    "-t flat -g": (["-t", "flat", "-G", "1000", "-g"], 3, True),
}
# the reference gain (127.5 * 1024) steepens the log scale near zero far
# beyond the native gain's 2e-5 at hilo: it runs where the policy is exact
OPTIONS_EXACT = {"-G reference": (["-G", "reference"], 3, False),
                 "-c I -g": (["-c", "I", "-g"], 1, False)}


@pytest.mark.parametrize("name", [*OPTIONS, *OPTIONS_EXACT])
def test_options_match_the_jax_tools(name, sources, tmp_path):
    args, channels, amplified = {**OPTIONS, **OPTIONS_EXACT}[name]
    src = sources["300x260" if name in OPTIONS_EXACT else "64x48"]
    # -g: ispec's sRGB encode has slope 12.92 near black, which multiplies
    # the 2 levels of a flat spectrum's float32 rounding
    levels = 26 if name == "-t flat -g" else 2
    ts, _ = _both(tmp_path, src, args, channels=channels, amplified=amplified,
                  levels=levels)
    arr = png.decode_png(open(ts, "rb").read())[0]
    assert arr.dtype == np.uint16 and arr.shape[2] == {1: 1, 3: 3, 4: 4}[channels]


def test_preserve_dc_and_signmap_match_the_jax_tools(sources, tmp_path):
    src = sources["64x48"]
    sign = str(tmp_path / "sign.png")
    assert jspec.main(_template_args("sign") + [src, sign]) == 0
    _both(tmp_path, src, [], ["-p"])
    _both(tmp_path, src, [], ["-m", sign])
    _both(tmp_path, src, ["-R", "one"], ["-R", "one", "-m", sign, "-p"])


def test_signmap_warning_and_missing_dc(sources, tmp_path, capsys):
    src, out = sources["64x48"], str(tmp_path / "o.png")
    spectrum, sign = str(tmp_path / "s.png"), str(tmp_path / "sign.png")
    assert jspec.main(["-S", "shift"] + [src, spectrum]) == 0
    assert jspec.main(_template_args("sign") + [src, sign]) == 0
    capsys.readouterr()
    errs = []
    for main, extra in ((tispec.main, CPU), (jispec.main, [])):
        assert main(extra + ["-S", "shift", "-m", sign, spectrum, out]) == 0
        errs.append(capsys.readouterr().err)
    assert errs[0] == errs[1] == "warning: -m signmap is only used with -S abs; ignoring\n"
    # the source has no DC property: the default range (dc) needs one
    for args in ([], ["-p", "-R", "one"]):
        for main, extra in ((tispec.main, CPU), (jispec.main, [])):
            assert main(extra + args + [src, out]) == 1
            assert capsys.readouterr().err == "DC not found in header\n"
    # -R one needs none, and an 8-bit input gives an 8-bit output
    tb, jb = str(tmp_path / "tb.png"), str(tmp_path / "jb.png")
    args = ["-t", "copy", "-G", "100"]
    assert tispec.main(CPU + args + [src, tb]) == 0 and jispec.main(args + [src, jb]) == 0
    assert _compare(tb, jb, 1, 0.03).dtype == np.uint8


def test_round_trips_through_files(sources, tmp_path):
    """``spec`` then ``ispec`` of the port, through 16-bit files.

    ``-t flat`` returns the input as far as the spectrum's 16 bits allow:
    each coefficient is stored as ``(f / 2 + 0.5) * 254 / 255`` rounded to
    a level, an error of 2 * 255/254 / sqrt(12) levels rms in ``f``, and
    the inverse sums w*h of those with unit weights, so the image comes
    back with sqrt(w*h) * 0.5796 levels rms of noise (32 at 64x48, 162 at
    300x260); held to 5 % of that, the largest to 6 sigma.  ``-t copy``
    (sign type ``retain``) cannot return the input through a file in
    either package: a PNG stores no negative coefficient, so the writer's
    clip at 0 drops them.  Its output is held to a float64 inverse of the
    spectrum as the file holds it, within one level."""
    import scipy.fft

    for size, src in sources.items():
        w, h = SIZES[size]
        s, back = str(tmp_path / f"s{size}.png"), str(tmp_path / f"b{size}.png")
        a = png.decode_png(open(src, "rb").read())[0].astype(np.int64) * 257
        assert tspec.main(CPU + ["-t", "flat", src, s]) == 0
        assert tispec.main(CPU + ["-t", "flat", s, back]) == 0
        b = png.decode_png(open(back, "rb").read())[0].astype(np.int64)
        inside = (a > 6000) & (a < 59000)       # away from the writer's clip
        d = (a - b)[inside]
        sigma = math.sqrt(w * h) * 2 * 255 / 254 / math.sqrt(12)
        assert b.shape == a.shape and inside.mean() > 0.5
        assert abs(math.sqrt((d * d).mean()) / sigma - 1) <= 0.05
        assert np.abs(d).max() <= 6 * sigma

        assert tspec.main(CPU + ["-t", "copy", src, s]) == 0
        assert tispec.main(CPU + ["-t", "copy", s, back]) == 0
        f = png.decode_png(open(s, "rb").read())[0] / 65535.0
        assert (f == 0).mean() > 0.3            # the clipped negatives
        scale = [np.where(np.arange(n) > 0, math.sqrt(2.0), 1.0) for n in (h, w)]
        coeff = f / (scale[0][:, None, None] * scale[1][None, :, None]) * (4.0 * w * h)
        oracle = scipy.fft.dctn(coeff, type=3, axes=(0, 1)) / (4.0 * w * h)
        oracle = np.rint(np.clip(oracle, 0, 1) * 65535)
        b = png.decode_png(open(back, "rb").read())[0].astype(np.int64)
        assert np.abs(b - oracle).max() <= 1


@pytest.fixture
def i8_policy():
    """``DSPFUN_PRECISION=i8@1e-5`` in both packages (they read the
    variable when imported), undone afterwards."""
    saved = [(m, m._default, m._explicit) for m in (jprecision, tprecision)]
    jprecision.set_precision(jprecision.Precision.parse("i8@1e-5"))
    tprecision.set_precision(tprecision.Precision.parse("i8@1e-5"))
    yield
    for m, default, explicit in saved:
        m._default, m._explicit = default, explicit


def test_i8_policy_matches_the_jax_tools_in_interpret_mode(i8_policy, tmp_path, monkeypatch):
    """260x300: both contractions of each tool reach the int8 digit
    kernels (K >= 256): the port's plain version against the JAX
    package's Pallas kernels in interpret mode.  3-digit ``i8@1e-5``
    chains differ by up to 5e-6 between the packages
    (tests/test_torch_fused.py), hence 2 levels."""
    from dspfun_tpu_torch.ops import int8mm

    src = _source(tmp_path / "300x260.png", 260, 300, seed=4)
    calls = []
    groups = int8mm._i8_groups
    monkeypatch.setattr(int8mm, "_i8_groups",
                        lambda a, x, layout: calls.append(layout) or groups(a, x, layout))
    _both(tmp_path, src, _template_args("copy"))
    assert sorted(calls) == ["left", "left", "right", "right"]


def test_option_tables_help_and_io_rules_are_copies(monkeypatch):
    for name in ("SPECTYPES", "SIGNTYPES", "RANGETYPES", "SCALETYPES", "GAINTYPES",
                 "SPEC_HELP"):
        assert getattr(tcli, name) == getattr(jcli, name)
    flags = [("-g", ""), ("-c", "BGR"), ("-t", "flat"), ("-t", "nope"), ("-R", "dcs"),
             ("-R", "x"), ("-T", "linear"), ("-T", "x"), ("-S", "retain"), ("-S", "x"),
             ("-G", "reference"), ("-G", "3.5"), ("-G", "x"), ("-s", "1"), ("-t", "sign")]
    to, jo = tcli.SpecOpts(), jcli.SpecOpts()
    for flag, arg in flags:
        assert tcli.spec_opt_proc(to, flag, arg) == jcli.spec_opt_proc(jo, flag, arg)
        assert (to.gamma, to.csp, to.input, to.output) == (jo.gamma, jo.csp, jo.input, jo.output)
        assert vars(to.params) == vars(jo.params)
    for spec in (None, "-", "a.png", "a.PNG", "a.jpg", "png:-", "sixel:-", "noext", "jpeg:x.png"):
        for tty in (False, True):
            monkeypatch.setattr(sys.stdout, "isatty", lambda tty=tty: tty, raising=False)
            assert tspec._png_target(spec) == jspec._png_target(spec)
    for args in ([], ["i"], ["i", "o"]):
        for tty_in in (False, True):
            for tty_out in (False, True):
                monkeypatch.setattr(sys.stdin, "isatty", lambda t=tty_in: t, raising=False)
                monkeypatch.setattr(sys.stdout, "isatty", lambda t=tty_out: t, raising=False)
                to, jo = tcli.SpecOpts(), jcli.SpecOpts()
                assert tcli.resolve_io(args, to) == jcli.resolve_io(args, jo)
                assert (to.input, to.output) == (jo.input, jo.output)


USAGE_ERRORS = {
    "unknown option": ["-Z"],
    "unknown long option": ["--bogus"],
    "bad template": ["-t", "nope"],
    "bad range": ["-R", "x"],
    "bad scale": ["-T", "x"],
    "bad sign": ["-S", "x"],
    "bad gain": ["-G", "x"],
    "-s is not an option": ["-s", "1"],
    "missing argument": ["-t"],
}


@pytest.mark.parametrize("tool", ["spec", "ispec"])
@pytest.mark.parametrize("case", USAGE_ERRORS)
def test_usage_errors_match_the_jax_tools(case, tool, sources, tmp_path, capsys):
    tmain, jmain = (tspec.main, jspec.main) if tool == "spec" else (tispec.main, jispec.main)
    args = USAGE_ERRORS[case] + [sources["64x48"], str(tmp_path / "o.png")]
    assert tmain(CPU + args) == 1
    got = capsys.readouterr()
    assert jmain(args) == 1
    ref = capsys.readouterr()
    assert got.out == ref.out == ""
    assert got.err == ref.err.replace("-M mesh", "-M mesh --device cuda|cpu")
    assert "Usage: " + tool in got.err
    assert not (tmp_path / "o.png").exists()


@pytest.mark.parametrize("tool", ["spec", "ispec"])
def test_help_no_input_and_unreadable_input(tool, tmp_path, capsys, monkeypatch):
    tmain, jmain = (tspec.main, jspec.main) if tool == "spec" else (tispec.main, jispec.main)
    assert tmain(["-h"]) == 0
    got = capsys.readouterr()
    assert jmain(["-h"]) == 0
    ref = capsys.readouterr()
    assert got.err == ref.err == ""
    assert [ln for ln in got.out.splitlines() if "--device" not in ln] == ref.out.splitlines()
    assert "--device" in got.out and tcli.SPEC_HELP in got.out
    # no input named and stdin a terminal: usage, exit 1
    monkeypatch.setattr(sys.stdin, "isatty", lambda: True, raising=False)
    assert tmain(CPU) == 1 and jmain([]) == 1
    err = capsys.readouterr().err.splitlines()
    assert err[0] == err[1].replace("-M mesh", "-M mesh --device cuda|cpu")
    # a missing file: the OS error's text, exit 1
    missing, out = str(tmp_path / "missing.png"), str(tmp_path / "o.png")
    assert tmain(CPU + [missing, out]) == 1
    got = capsys.readouterr().err
    assert jmain([missing, out]) == 1
    assert got == capsys.readouterr().err and "No such file" in got


@pytest.mark.parametrize("tool", ["spec", "ispec"])
def test_what_the_port_refuses_exits_1_by_item(tool, sources, tmp_path, capsys, monkeypatch):
    main = tspec.main if tool == "spec" else tispec.main
    src, out = sources["64x48"], str(tmp_path / "o.png")
    monkeypatch.chdir(tmp_path)
    for args, msg in ((["-M", "space=2,time=2"], "spec mesh uses the space axis only"),
                      (["--mesh", "space=99"], "mesh unavailable (mesh needs 99 devices"),
                      (["--mesh=time=2"], "spec mesh uses the space axis only; pass -M N")):
        assert main(CPU + args + ["-R", "one", src, out]) == 1
        assert msg in capsys.readouterr().err
    monkeypatch.setenv("DSPFUN_MESH", "space=2,time=2")
    assert main(CPU + ["-R", "one", src, out]) == 1
    assert "spec mesh uses the space axis only" in capsys.readouterr().err
    monkeypatch.delenv("DSPFUN_MESH")
    # what the port once refused (ROADMAP items 21 and 8) is held to the
    # JAX tool: sixel (also the tty default) and GIF are its bytes, and the
    # other formats decode to its files within one level on average, from
    # the same spectrum

    jmain = jspec.main if tool == "spec" else jispec.main
    if tool == "ispec":
        src = str(tmp_path / "spectrum.png")
        assert jspec.main(["-R", "one", sources["64x48"], src]) == 0

    def both(args, target):
        got = []
        for name, run in (("j", lambda a: jmain(a)), ("t", lambda a: main(CPU + a))):
            std = _BinStd()
            monkeypatch.setattr(sys, "stdout", std)
            spec = target.replace("o", f"{name}o", 1) if target else None
            rc = run(args + ["-R", "one", src] + ([spec] if spec else []))
            path = (spec or "-").split(":", 1)[-1]
            got.append((rc, std.buffer.getvalue() if path == "-" else open(path, "rb").read()))
        monkeypatch.setattr(sys, "stdout", sys.__stdout__)
        assert got[0][0] == got[1][0] == 0
        return got[0][1], got[1][1]

    for target in ("sixel:-", "sixel:o.six", None):
        _BinStd.tty = target is None       # the tty default is sixel
        j, t = both([], target)
        assert j.startswith(b"\x1bPq") and j == t
    _BinStd.tty = False
    from dspfun_tpu.io import images as jimages

    for target in ("o.jpg", "tiff:o", "o.bmp", "ppm:-", "o.webp", "gif:o.png"):
        j, t = both([], target)
        dec = []
        for data in (j, t):
            (tmp_path / "dec.bin").write_bytes(data)
            dec.append(jimages.read_image(str(tmp_path / "dec.bin")).pixels)
        bound = (0.0, 0.0) if target.startswith("gif") else (1 / 255, 0.1)
        assert j == t or not target.startswith("gif")
        d = np.abs(dec[0] - dec[1])
        assert d.mean() <= bound[0] and d.max() <= bound[1], (target, d.mean(), d.max())
    from PIL import Image

    Image.new("RGB", (8, 8), (10, 200, 30)).save(str(tmp_path / "in.jpg"))
    assert main(CPU + ["-R", "one", "in.jpg", "tin.png"]) == 0
    assert jmain(["-R", "one", "in.jpg", "jin.png"]) == 0
    _compare("tin.png", "jin.png", 2, 0.05)


class _BinStd:
    """A stdout with a binary buffer and a settable ``isatty``."""

    tty = False

    def __init__(self):
        self.buffer = io.BytesIO()

    def isatty(self):
        return _BinStd.tty

    def write(self, s):
        self.buffer.write(s.encode())

    def flush(self):
        pass


@pytest.mark.parametrize("tool", ["spec", "ispec"])
def test_device_cuda_without_a_card_is_an_error(tool, sources, tmp_path, capsys, monkeypatch):
    """The default device is the card: without one, no ``--device`` and
    ``--device cuda`` fail alike, nothing runs on the CPU unasked and no
    file is written."""
    main = tspec.main if tool == "spec" else tispec.main
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "o.png"
    for extra in (["--device", "cuda"], ["--device=cuda"], []):
        assert main(extra + ["-R", "one", sources["64x48"], str(out)]) == 1
        assert "Bad --device" in capsys.readouterr().err
    assert main(["--device", "tpu", "-R", "one", sources["64x48"], str(out)]) == 1
    assert "Bad --device" in capsys.readouterr().err
    assert not out.exists()


def test_spec_through_pipes(sources, tmp_path, monkeypatch):
    """``-`` and a missing outfile are stdin/stdout, as in the JAX tool."""
    import io

    class Std:
        def __init__(self, data=b""):
            self.buffer = io.BytesIO(data)

        def isatty(self):
            return False

        def write(self, s):
            pass

        def flush(self):
            pass

    data = open(sources["64x48"], "rb").read()
    outs = []
    for main, extra, args in ((tspec.main, CPU, ["-t", "copy", "-G", "50"]),
                              (jspec.main, [], ["-t", "copy", "-G", "50"]),
                              (tspec.main, CPU, ["-t", "copy", "-G", "50", "-", "png:-"])):
        stdin, stdout = Std(data), Std()
        monkeypatch.setattr(sys, "stdin", stdin)
        monkeypatch.setattr(sys, "stdout", stdout)
        rc = main(extra + args)
        monkeypatch.undo()
        assert rc == 0
        outs.append(stdout.buffer.getvalue())
    assert outs[0] == outs[2] and outs[0][:4] == b"\x89PNG"
    a, b = (png.decode_png(o)[0].astype(np.int64) for o in outs[:2])
    assert a.dtype == b.dtype and np.abs(a - b).max() <= 2


def test_run_main_exits_with_the_code_and_times(capsys, monkeypatch):
    from dspfun_tpu_torch.tools import run_main

    monkeypatch.setenv("DSPFUN_TIMINGS", "1")
    with pytest.raises(SystemExit) as e:
        run_main(lambda: 3)
    assert e.value.code == 3
    assert "[dspfun] total:" in capsys.readouterr().err
    monkeypatch.delenv("DSPFUN_TIMINGS")
    with pytest.raises(SystemExit) as e:
        run_main(lambda: 0)
    assert e.value.code == 0 and capsys.readouterr().err == ""


def test_profile_hook_writes_a_trace(tmp_path, monkeypatch, capsys):
    """``DSPFUN_PROFILE=<dir>`` wraps the run in torch.profiler."""
    import json

    from dspfun_tpu_torch.utils import profiling

    monkeypatch.setenv("DSPFUN_PROFILE", str(tmp_path / "prof"))
    sink = {}
    with profiling.maybe_profile(), profiling.stage("work", sink):
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert "profile trace written" in capsys.readouterr().err
    trace = json.load(open(tmp_path / "prof" / "trace.json"))
    assert any("mm" in str(ev.get("name", "")) for ev in trace["traceEvents"])
    assert sink["work"] > 0 and not profiling.timings_enabled()
    monkeypatch.delenv("DSPFUN_PROFILE")
    with profiling.maybe_profile():
        pass
    assert capsys.readouterr().err == "" and os.listdir(tmp_path) == ["prof"]
