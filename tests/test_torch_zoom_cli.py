"""The port's ``zoom`` CLI against the JAX package's, on the CPU.

The same PNG goes through ``dspfun_tpu.tools.zoom`` and
``dspfun_tpu_torch.tools.zoom --device cpu`` with the same flags.
Tolerances: PNG and y4m outputs within one 8-bit level on < 0.5 % of the
pels; fvid streams within 2e-6 in linear light and 2e-6 times the OETF's
slope (12.92) with ``-g``, 5e-6 (times the slope) where a frame takes
the device-basis route, whose float32 cosines differ by an ulp between
the packages.
"""

import numpy as np
import pytest
import scipy.fft
import torch

from dspfun_tpu.core import precision as jprec
from dspfun_tpu.io import images as jimages
from dspfun_tpu.io import video as jvideo
from dspfun_tpu.tools import zoom as jzoom
from dspfun_tpu_torch.core import precision as tprec
from dspfun_tpu_torch.io import images as timages
from dspfun_tpu_torch.io import video as tvideo
from dspfun_tpu_torch.ops.int8mm import LAUNCHES
from dspfun_tpu_torch.tools import main as tmain
from dspfun_tpu_torch.tools import zoom as tzoom
from dspfun_tpu_torch.utils.checkpoint import load_state, save_state
from tests.torch_port_cases import assert_cli_parity, hide_ffmpeg, run_cli_both


@pytest.fixture(autouse=True)
def _policies(monkeypatch):
    monkeypatch.delenv("DSPFUN_PRECISION", raising=False)
    monkeypatch.delenv("DSPFUN_MESH", raising=False)
    saved = (jprec._default, jprec._explicit, tprec._default, tprec._explicit)
    jprec._default, jprec._explicit = jprec.Precision(), False
    tprec._default, tprec._explicit = tprec.Precision(), False
    yield
    jprec._default, jprec._explicit, tprec._default, tprec._explicit = saved


def _png(tmp_path, h=24, w=32, seed=7):
    rng = np.random.default_rng(seed)
    c = rng.standard_normal((h, w, 3)) / (1.0 + np.add.outer(np.arange(h), np.arange(w)))[..., None] ** 2
    x = scipy.fft.idctn(c, axes=(0, 1), norm="ortho")
    x = 0.1 + 0.8 * (x - x.min()) / (x.max() - x.min())
    path = str(tmp_path / "in.png")
    timages.write_image(path, x)
    return path


def _run_both(tmp_path, flags, src, ext):
    jout, tout = str(tmp_path / f"j.{ext}"), str(tmp_path / f"t.{ext}")
    assert jzoom.main(list(flags) + [src, jout]) == 0
    assert tzoom.main(["--device", "cpu", *flags, src, tout]) == 0
    return jout, tout


def _fvid_close(jout, tout, tol):
    a, b = open(jout, "rb").read(), open(tout, "rb").read()
    assert a[:a.index(b"\n")] == b[:b.index(b"\n")] and len(a) == len(b)
    jr, tr = jvideo.open_input(jout, native=False), tvideo.open_input(tout)
    assert jr.frames == tr.frames and tr.frames > 0
    worst = 0.0
    for _ in range(tr.frames):
        for p, q in zip(jr.read_frame(), tr.read_frame()):
            worst = max(worst, float(np.max(np.abs(p - q))))
    assert worst <= tol, worst
    return tr.frames


def _levels_close(a, b):
    d = np.abs(np.rint(a * 255) - np.rint(b * 255))
    assert a.shape == b.shape and d.max() <= 1 and np.mean(d > 0) < 0.005


@pytest.mark.parametrize("flags", [
    ["-s", "2"], ["-s", "3/2x2", "-g"], ["-r", "50.5x40", "-c", "-v", "40x30"],
    ["-s", "4", "-v", "48x40", "-p", "25x10", "-P"], ["-s", "1/2"], ["-s", "3", "-%", "-p", "50x25", "-v", "30x30"],
    ["-s", "2", "--basis", "native"], ["-s", "2", "--basis", "centered", "-g"],
    ["-s", "3", "--showsamples=grid"], ["-s", "3", "--showsamples=point", "-p", "7x5"],
])
def test_still_to_png_matches_jax(flags, tmp_path):
    jout, tout = _run_both(tmp_path, flags, _png(tmp_path), "png")
    _levels_close(jimages.read_image(jout).pixels, timages.read_image(tout).pixels)
    assert tzoom.LAST_STAGE_TIMES["routes"] == ["planned"]


@pytest.mark.parametrize("flags,scale", [
    (["-s", "2"], 1.0), (["-s", "5/2", "-g", "-v", "40x31", "-p", "3x4"], 12.92),
    (["-s", "2", "--basis", "native", "--ff-opts", "pixel_format=grayf32le"], 1.0),
    (["-s", "2", "--showsamples=point"], 1.0), (["-s", "1/3", "--basis", "centered"], 1.0),
])
def test_still_to_fvid_matches_jax(flags, scale, tmp_path):
    jout, tout = _run_both(tmp_path, flags, _png(tmp_path), "fvid")
    assert _fvid_close(jout, tout, 2e-6 * scale) == 1


PANS = [
    # the pan of the open cell: x walks across the scaled image
    (["-s", "4", "-v", "32x24", "-n", "6", "-x", "i/n*(w*xs-vw)", "-y", "(h*ys-vh)/2"], 1.0),
    (["-s", "2", "-v", "32x24", "-n", "5", "-x", "4*i", "-g"], 12.92),             # exact k: the device route
    (["-v", "40x30", "-n", "5", "-S", "1+i/2", "-c"], 1.0),                         # scale animation
    (["-s", "2", "-v", "30x20", "-n", "4", "-X", "2+i", "-Y", "3", "--basis", "native"], 1.0),
    (["-s", "2", "-v", "30x20", "-n", "7", "-x", "st(0, ld(0)+3)", "-y", "random(1)*10"], 1.0),  # stateful
    (["-s", "2", "-n", "3"], 1.0),                                                  # no expression: planned, cached
]


@pytest.mark.parametrize("flags,scale", PANS)
def test_animation_to_fvid_matches_jax(flags, scale, tmp_path):
    jout, tout = _run_both(tmp_path, flags + ["-q"], _png(tmp_path), "fvid")
    n = _fvid_close(jout, tout, 5e-6 * scale)
    t = tzoom.LAST_STAGE_TIMES
    assert t["frames"] == n == len(t["routes"]) and set(t["routes"]) <= {"planned", "device"}
    assert {"read", "forward", "expr", "dispatch", "wait", "write", "payload_bytes"} <= set(t)
    if "4*i" in flags:
        assert t["routes"] == ["device"] * 5 and "plan" not in t
    if flags[-1] == "3":
        assert t["routes"] == ["planned"] * 3


def test_pan_to_y4m_matches_jax_and_uses_the_packer(tmp_path):
    flags = ["-s", "3", "-v", "32x24", "-n", "5", "-x", "3*i", "-g", "-q"]
    jout, tout = _run_both(tmp_path, flags, _png(tmp_path), "y4m")
    a, b = open(jout, "rb").read(), open(tout, "rb").read()
    assert len(a) == len(b) and a[:a.index(b"\n")] == b[:b.index(b"\n")]
    d = np.abs(np.frombuffer(a, np.uint8).astype(int) - np.frombuffer(b, np.uint8).astype(int))
    assert d.max() <= 1 and np.mean(d > 0) < 0.005
    assert tzoom.LAST_STAGE_TIMES["payload_bytes"] == 32 * 24 * 3       # yuv444p, not 12 bytes a pel


def test_int8_policies_match_jax(tmp_path):
    """272x320 source: deep ``i8`` on the planned route and ``i8@1e-5``
    on the device route (``i8_contract_rt``), digits in both packages."""
    src = _png(tmp_path, 272, 320, 3)
    LAUNCHES.clear()
    for spec, flags, tol in [("i8", ["-s", "2", "-v", "96x80", "-p", "10x20"], 2e-6),
                             ("i8@1e-5", ["-s", "2", "-v", "96x80", "-n", "2", "-x", "8*i", "-q"], 5e-6)]:
        for mod in (jprec, tprec):
            mod.set_precision(mod.Precision.parse(spec))
        jout, tout = _run_both(tmp_path, flags, src, "fvid")
        _fvid_close(jout, tout, tol)
    assert tzoom.LAST_STAGE_TIMES["routes"] == ["device", "device"]
    assert not LAUNCHES


def test_resume_replays_the_expression_history(tmp_path, capsys):
    """A resumed run evaluates the stateful expressions of the finished
    frames again (their state belongs to this run's parse) and appends
    the rest: the file equals an uninterrupted run's."""
    src = _png(tmp_path)
    full, part, state = (str(tmp_path / n) for n in ("full.fvid", "part.fvid", "state.json"))
    flags = ["--device", "cpu", "-s", "2", "-v", "30x20", "-n", "6", "-x", "st(0, ld(0)+3)",
             "-y", "random(1)*8", "-q"]
    assert tzoom.main(flags + [src, full]) == 0
    assert tzoom.main(flags + ["--resume-file", state, src, part]) == 0
    assert open(part, "rb").read() == open(full, "rb").read()
    st = load_state(state)
    assert st["frame"] == 6
    data = open(full, "rb").read()
    hdr = data.index(b"\n") + 1
    fsize = (len(data) - hdr) // 6
    open(part, "wb").write(data[:hdr + 2 * fsize])
    save_state(state, {"cfg": st["cfg"], "frame": 2})
    assert tzoom.main(flags + ["--resume-file", state, src, part]) == 0
    assert open(part, "rb").read() == data
    assert tzoom.LAST_STAGE_TIMES["frames"] == 4
    # another camera position: the state does not apply
    assert tzoom.main(flags + ["-p", "1x1", "--resume-file", state, src, part]) == 0
    assert tzoom.LAST_STAGE_TIMES["frames"] == 6


def test_png_sequence_and_non_finite_frames(tmp_path, capsys):
    src = _png(tmp_path)
    pat = str(tmp_path / "z%02d.png")
    assert tzoom.main(["--device", "cpu", "-s", "2", "-v", "20x16", "-n", "4", "-x", "1/(i-1)", src, pat]) == 0
    err = capsys.readouterr().err
    assert "Skipping non-finite expression result at frame 1" in err
    assert sorted(p.name for p in tmp_path.glob("z*.png")) == ["z00.png", "z01.png", "z02.png"]
    assert timages.read_image(str(tmp_path / "z00.png")).pixels.shape == (16, 20, 3)


@pytest.mark.parametrize("argv,msg", [
    (["--device", "cpu", "--mesh", "space=2,time=2", "IN", "o.y4m"], "zoom --mesh shards space only"),
    (["--device", "cpu", "--ff-encoder", "libx264", "IN", "o.nut"], "queue 1, item 13"),
    (["--device", "cpu", "IN", "o.webm"], "queue 1, item 13"),
    (["--device", "cpu", "IN", "ffplay:"], "queue 1, item 13"),
    (["--device", "cpu", "IN", "o.jpg"], "queue 1, item 8"),
    (["--device", "cpu", "-x", "i+(", "IN", "o.png"], "Bad expression"),
    (["--device", "cpu", "-s", "two", "IN", "o.png"], "Usage: zoom"),
    (["--device", "cpu", "--basis", "nonesuch", "IN", "o.png"], "Usage: zoom"),
    (["--device", "cpu", "--showsamples=nonesuch", "IN", "o.png"], "Usage: zoom"),
    (["--device", "cpu", "--ff-opts", "nonesuch=1", "IN", "o.png"], "Bad --ff-opts"),
    (["--device", "cpu", "missing.png", "o.png"], "missing.png"),
    (["--device", "cpu", "IN"], "Usage: zoom"),
    (["--device", "tpu", "IN", "o.png"], "Bad --device"),
])
def test_refusals_and_errors_exit_1(argv, msg, tmp_path, capsys, monkeypatch):
    """Errors exit 1 with the message.  The rows that once named ROADMAP
    items 13 and 8 (the bridge's containers and encoders, ``ffplay:``, a
    JPEG still) are held to the JAX tool instead: the same exit code,
    last error line, shim argv and output within its tolerances, with
    ffmpeg hidden and under the shim binaries."""
    if msg.startswith("queue 1, item"):
        runs = []
        for shims in (False, True):
            got = run_cli_both(
                tmp_path, monkeypatch, capsys, {"jax": jzoom.main, "torch": tzoom.main},
                lambda d: [_png(d) if a == "IN" else a for a in argv
                           if a not in ("--device", "cpu") or d.name.startswith("torch")],
                shims)
            assert_cli_parity(got)
            runs.append(got["torch"])
        # the bridge needs the binary: exit 1 without it, a file with it
        if "ffplay:" not in argv and not argv[-1].endswith(".jpg"):
            assert runs[0]["rc"] == 1 and "ffmpeg binary" in runs[0]["err"]
            assert runs[1]["rc"] == 0 and runs[1]["files"]
        return
    monkeypatch.chdir(tmp_path)
    src = _png(tmp_path)
    assert tzoom.main([src if a == "IN" else a for a in argv]) == 1
    assert msg in capsys.readouterr().err
    assert not [p for p in tmp_path.iterdir() if p.name != "in.png"]


def test_device_defaults_to_the_card_and_the_tool_default_follows_it(tmp_path, capsys, monkeypatch):
    src = _png(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for extra in ([], ["--device", "cuda"]):
        assert tzoom.main(extra + ["-s", "2", src, str(tmp_path / "o.png")]) == 1
        assert "Bad --device" in capsys.readouterr().err
    assert not (tmp_path / "o.png").exists()
    # the default policy follows the device the tool resolved, not the host's cards
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert tprec.tool_default("zoom", "cpu") == tprec.Precision()
    deep = tprec.Precision(coeff="float32", intermediate="i8")
    assert tprec.tool_default("zoom") == tprec.tool_default("zoom", torch.device("cuda", 0)) == deep
    assert tprec.tool_default("scan", "cuda") == tprec.Precision()
    monkeypatch.setattr(tprec, "_default", deep)
    monkeypatch.setattr(tprec, "_explicit", False)
    assert tzoom.main(["--device", "cpu", "-s", "2", src, str(tmp_path / "o.png")]) == 0
    assert tprec.get_precision() == tprec.Precision()                # --device cpu: hilo
    monkeypatch.setenv("DSPFUN_MESH", "space=999")
    assert tzoom.main(["--device", "cpu", "-s", "2", src, str(tmp_path / "o.png")]) == 1
    assert "mesh unavailable (mesh needs 999 devices" in capsys.readouterr().err


def test_help_and_dispatcher(tmp_path, capsys):
    assert tzoom.main(["-h"]) == 0
    assert "--device <cuda|cpu>" in capsys.readouterr().err
    assert tzoom.SHORT == jzoom.SHORT and set(jzoom.LONG) | {"device="} == set(tzoom.LONG)
    assert tzoom.USAGE == jzoom.USAGE
    assert tzoom._parse_scale("3/2x5") == jzoom._parse_scale("3/2x5") == ((3.0, 2.0), (5.0, 1.0))
    src = _png(tmp_path)
    out = str(tmp_path / "d.png")
    assert tmain.main(["zoom", "--device", "cpu", "-s", "2", src, out]) == 0
    assert timages.read_image(out).pixels.shape == (48, 64, 3)


@pytest.mark.parametrize("ext,opts", [("nut", "pixel_format=yuv444p"), ("nut", "negotiate=1"),
                                      ("mkv", None), ("nut", None)])
def test_nut_and_mkv_targets_match_jax(ext, opts, tmp_path, monkeypatch):
    """A 2x pan of 6 frames to NUT and Matroska with the codec options
    ``--ff-opts`` carries: decoded within the fvid tests' 2e-6 where the
    frames are float, one 8-bit level on < 0.5 % where they are 8-bit,
    and one level where 16-bit FFV1 stores float frames."""
    from tests.test_torch_scan_cli import _decoded_close

    hide_ffmpeg(monkeypatch)  # both packages' native Matroska
    flags = ["-s", "2", "-v", "20x16", "-n", "6", "-x", "2*i", "-q"] + (
        ["--ff-opts", opts] if opts else [])
    jout, tout = _run_both(tmp_path, flags, _png(tmp_path), ext)
    _decoded_close(jout, tout, 2e-6, share=0.005 if opts == "pixel_format=yuv444p" else None)
