"""The port's ``scan`` CLI against the JAX package's, on the CPU.

The same PNG goes through ``dspfun_tpu.tools.scan`` and
``dspfun_tpu_torch.tools.scan --device cpu`` with the same flags.
Tolerances: y4m streams equal in header and length and within one 8-bit
level on < 0.5 % of the pels; fvid streams within 2e-6 (times the OETF's
slope 12.92 where ``-g`` encodes); the ``-f`` serialisation file and the
``-P`` message **equal**.  NUT and Matroska targets decode within the
same bounds (plus one 16-bit level where 16-bit FFV1 stores float
frames).
"""

import numpy as np
import pytest
import scipy.fft
import torch

from dspfun_tpu.core import precision as jprec
from dspfun_tpu.io import video as jvideo
from dspfun_tpu.tools import scan as jscan
from dspfun_tpu_torch.core import precision as tprec
from dspfun_tpu_torch.io import images as timages
from dspfun_tpu_torch.io import video as tvideo
from dspfun_tpu_torch.ops.int8mm import LAUNCHES
from dspfun_tpu_torch.tools import main as tmain
from dspfun_tpu_torch.tools import scan as tscan

from tests.torch_port_cases import assert_cli_parity, hide_ffmpeg, run_cli_both

@pytest.fixture(autouse=True)
def _policies(monkeypatch):
    """Each test starts from the packages' own defaults."""
    monkeypatch.delenv("DSPFUN_PRECISION", raising=False)
    monkeypatch.delenv("DSPFUN_MESH", raising=False)
    saved = (jprec._default, jprec._explicit, tprec._default, tprec._explicit)
    jprec._default, jprec._explicit = jprec.Precision(), False
    tprec._default, tprec._explicit = tprec.Precision(), False
    yield
    jprec._default, jprec._explicit, tprec._default, tprec._explicit = saved


def _png(tmp_path, h=24, w=32, seed=7, name="in.png"):
    rng = np.random.default_rng(seed)
    c = rng.standard_normal((h, w, 3)) / (1.0 + np.add.outer(np.arange(h), np.arange(w)))[..., None] ** 1.5
    x = scipy.fft.idctn(c, axes=(0, 1), norm="ortho")
    x = (x - x.min()) / (x.max() - x.min())
    path = str(tmp_path / name)
    timages.write_image(path, x)
    return path


def _run_both(tmp_path, capsys, flags, src, ext, extra_t=()):
    jout, tout = str(tmp_path / f"j.{ext}"), str(tmp_path / f"t.{ext}")
    assert jscan.main(list(flags) + [src, jout]) == 0
    jerr = capsys.readouterr().err
    assert tscan.main(["--device", "cpu", *extra_t, *flags, src, tout]) == 0
    terr = capsys.readouterr().err
    return jout, tout, jerr, terr


def _y4m_close(jout, tout):
    a, b = open(jout, "rb").read(), open(tout, "rb").read()
    assert len(a) == len(b) and a[:a.index(b"\n")] == b[:b.index(b"\n")]
    d = np.abs(np.frombuffer(a, np.uint8).astype(int) - np.frombuffer(b, np.uint8).astype(int))
    assert d.max() <= 1 and np.mean(d > 0) < 0.005
    return a.count(b"FRAME\n")


def _fvid_close(jout, tout, tol):
    a, b = open(jout, "rb").read(), open(tout, "rb").read()
    ha, hb = a.index(b"\n"), b.index(b"\n")
    assert a[:ha] == b[:hb] and len(a) == len(b)
    jr, tr = jvideo.open_input(jout, native=False), tvideo.open_input(tout)
    assert jr.frames == tr.frames and tr.frames > 0
    worst = 0.0
    for _ in range(tr.frames):
        for p, q in zip(jr.read_frame(), tr.read_frame()):
            worst = max(worst, float(np.max(np.abs(p - q))))
    assert worst <= tol, worst
    return tr.frames


@pytest.mark.parametrize("flags", [
    ["-m", "zigzag", "-S", "16", "-q"], ["-m", "horiz", "-S", "8", "-n", "5", "-q"],
    ["-m", "box", "-q", "-g"], ["-m", "diag", "-q", "-I", "-O", "3", "-S", "2"],
    ["-m", "random", "-o", "5", "-S", "40", "-q", "--ff-opts", "pixel_format=yuv420p:color_range=tv"],
    ["-m", "row", "-q", "-O", "4", "--skip", "--ff-rate", "30000/1001"],
])
def test_y4m_output_matches_jax(flags, tmp_path, capsys):
    jout, tout, _, _ = _run_both(tmp_path, capsys, flags, _png(tmp_path), "y4m")
    assert _y4m_close(jout, tout) >= 5
    assert tscan.LAST_STAGE_TIMES["frames"] == open(tout, "rb").read().count(b"FRAME\n")
    assert {"read", "forward", "order", "plan", "dispatch", "wait", "emit"} <= set(tscan.LAST_STAGE_TIMES)


@pytest.mark.parametrize("flags,scale", [
    (["-m", "zigzag", "-S", "16", "-q"], 1.0), (["-m", "mirror", "-q", "-g"], 12.92),
    (["-m", "diag", "-v", "-i", "-q", "-n", "9"], 1.0), (["-m", "diag", "-s", "-q", "-n", "6", "--spec-opts", "preset=shift"], 1.0),
    # -M divides each frame's delta by its own range, which scales the difference up
    (["-m", "zig", "-s", "-M", "-q", "-S", "30", "--spec-gain", "90"], 5.0), (["-m", "ibox", "-i", "-q", "-g"], 12.92),
    (["-m", "evalxy", "-o", "x*y+x", "-q", "-p", "true"], 1.0), (["-m", "column", "-q", "-p", "false"], 1.0),
    (["-m", "magnitude", "-o", "0.02", "-q", "--ff-opts", "pixel_format=grayf32le"], 1.0),
])
def test_fvid_output_matches_jax(flags, scale, tmp_path, capsys):
    jout, tout, _, _ = _run_both(tmp_path, capsys, flags, _png(tmp_path), "fvid")
    assert _fvid_close(jout, tout, 2e-6 * scale) >= 2


@pytest.mark.parametrize("fmt", ["index", "coordinate"])
def test_serialisation_file_equal(fmt, tmp_path, capsys):
    src = _png(tmp_path)
    jf, tf = str(tmp_path / "j.txt"), str(tmp_path / "t.txt")
    assert jscan.main(["-m", "magnitude", "-f", jf, "-t", fmt, src]) == 0
    assert tscan.main(["--device", "cpu", "-m", "magnitude", "-f", tf, "-t", fmt, src]) == 0
    assert open(jf).read() == open(tf).read() and len(open(tf).read()) > 100
    assert tscan.main(["--device", "cpu", "-t", "nonesuch", src]) == 1
    assert "Invalid serialization format" in capsys.readouterr().err


@pytest.mark.parametrize("flags", [["-m", "zigzag"], ["-m", "zigzag", "-S", "7"], ["-m", "row", "-I"],
                                   ["-m", "zigzag", "-n", "20"], ["-m", "box", "-g"]])
def test_measure_parity_message_equal(flags, tmp_path, capsys):
    _, _, jerr, terr = _run_both(tmp_path, capsys, flags + ["-P", "-q"], _png(tmp_path), "y4m")
    assert terr == jerr and ("parity" in terr)
    _, _, jerr, terr = _run_both(tmp_path, capsys, flags + ["-P"], _png(tmp_path), "fvid")
    assert terr == jerr and "\r" in terr          # the progress counter too


def test_int8_policy_runs_the_digit_path_and_matches_jax(tmp_path, capsys, monkeypatch):
    """``DSPFUN_PRECISION=i8@1e-5`` at 272x320: the forward transform and
    the dense chunk go through the int8 digits in both packages."""
    src = _png(tmp_path, 272, 320, 3)
    for mod in (jprec, tprec):
        mod.set_precision(mod.Precision.parse("i8@1e-5"))
    LAUNCHES.clear()
    jout, tout, _, _ = _run_both(tmp_path, capsys, ["-m", "zigzag", "-S", "30000", "-q"], src, "fvid")
    assert _fvid_close(jout, tout, 2e-6) == 3
    assert not LAUNCHES                            # CPU: the plain version, no kernel


def test_resume_appends_what_is_left(tmp_path, capsys):
    src = _png(tmp_path)
    full, part, state = (str(tmp_path / n) for n in ("full.fvid", "part.fvid", "state.json"))
    flags = ["--device", "cpu", "-m", "zigzag", "-S", "50", "-q"]
    assert tscan.main(flags + [src, full]) == 0
    assert tscan.main(flags + ["--resume-file", state, src, part]) == 0
    assert open(part, "rb").read() == open(full, "rb").read()
    # cut the stream after 5 frames, as an interrupted run leaves it
    from dspfun_tpu_torch.utils.checkpoint import load_state, save_state

    st = load_state(state)
    nfr = st["frame"]
    data = open(full, "rb").read()
    hdr = data.index(b"\n") + 1
    fsize = (len(data) - hdr) // nfr
    open(part, "wb").write(data[:hdr + 5 * fsize])
    save_state(state, {"cfg": st["cfg"], "frame": 5})
    assert tscan.main(flags[:-1] + ["--resume-file", state, src, part]) == 0
    assert "resuming at frame 5" in capsys.readouterr().err
    r1, r2 = tvideo.open_input(full), tvideo.open_input(part)
    assert r1.frames == r2.frames == nfr
    for _ in range(nfr):
        np.testing.assert_allclose(r2.read_frame_rgb(), r1.read_frame_rgb(), atol=2e-6)
    assert load_state(state)["frame"] == nfr
    # other flags: the state does not apply, the run starts over
    assert tscan.main(flags[:-1] + ["-I", "--resume-file", state, src, part]) == 0
    assert "resuming" not in capsys.readouterr().err


def test_png_sequence_output(tmp_path, capsys):
    src = _png(tmp_path)
    pat = str(tmp_path / "f%03d.png")
    assert tscan.main(["--device", "cpu", "-m", "zigzag", "-S", "200", "-q", src, pat]) == 0
    last = timages.read_image(str(tmp_path / "f003.png")).pixels
    assert np.max(np.abs(last - timages.read_image(src).pixels)) <= 1 / 255 + 1e-9
    assert not (tmp_path / "f004.png").exists()


@pytest.mark.parametrize("argv,msg", [
    (["--device", "cpu", "--mesh", "space=2,time=2", "IN", "o.y4m"], "scan --mesh shards space only"),
    (["--device", "cpu", "--ff-encoder", "libx264", "IN", "o.nut"], "queue 1, item 13"),
    (["--device", "cpu", "IN", "o.webm"], "queue 1, item 13"),
    (["--device", "cpu", "IN", "ffplay:"], "queue 1, item 13"),
    (["--device", "cpu", "--ff-format", "matroska", "IN", "o.y4m"], "queue 1, item 13"),
    (["--device", "cpu", "IN", "o%02d.jpg"], "queue 1, item 8"),
    (["--device", "cpu", "-p", "perhaps", "IN", "o.y4m"], "invalid --pruned-idct"),
    (["--device", "cpu", "--ff-opts", "nonesuch=1", "IN", "o.y4m"], "Bad --ff-opts"),
    (["--device", "cpu", "--spec-opts", "scale=nonesuch", "IN", "o.y4m"], "Couldn't parse spec option"),
    (["--device", "cpu", "-m", "evalxy", "-o", "x+(", "IN", "o.y4m"], "Error initializing scan"),
    (["--device", "cpu", str("missing.png"), "o.y4m"], "missing.png"),
    (["--device", "tpu", "IN", "o.y4m"], "Bad --device"),
    (["--nonesuch"], "not recognized"),
])
def test_refusals_and_errors_exit_1(argv, msg, tmp_path, capsys, monkeypatch):
    """Errors exit 1 with the message.  The rows that once named ROADMAP
    items 13 and 8 (the bridge's containers and encoders, ``ffplay:``, a
    JPEG sequence) are held to the JAX tool instead: the same exit code,
    last error line, shim argv and output within its tolerances, with
    ffmpeg hidden and under the shim binaries."""
    if msg.startswith("queue 1, item"):
        runs = []
        for shims in (False, True):
            got = run_cli_both(
                tmp_path, monkeypatch, capsys, {"jax": jscan.main, "torch": tscan.main},
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
    assert tscan.main([src if a == "IN" else a for a in argv]) == 1
    assert msg in capsys.readouterr().err
    assert not [p for p in tmp_path.iterdir() if p.name != "in.png"]


def test_device_defaults_to_the_card_and_mesh_env_is_refused(tmp_path, capsys, monkeypatch):
    src = _png(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for extra in ([], ["--device", "cuda"]):
        assert tscan.main(extra + ["-q", src, str(tmp_path / "o.y4m")]) == 1
        assert "Bad --device" in capsys.readouterr().err
    # DSPFUN_MESH is read as --mesh is: a time axis is refused (the JAX
    # tool falls back to one device; the port exits 1)
    monkeypatch.setenv("DSPFUN_MESH", "time=4")
    assert tscan.main(["--device", "cpu", src, str(tmp_path / "o.y4m")]) == 1
    assert "scan --mesh shards space only (time=1)" in capsys.readouterr().err
    assert not (tmp_path / "o.y4m").exists()


def test_help_texts_and_dispatcher(tmp_path, capsys):
    assert tscan.main(["-h"]) == 0
    assert "--device <cuda|cpu>" in capsys.readouterr().err
    assert tscan.main(["-H"]) == 0 and jscan.main(["-H"]) == 0
    text = capsys.readouterr().err
    assert text.count("   zigzag") == 2 and text.count("   coordinate") == 2
    assert tscan.main([]) == 1
    assert tscan.SHORT == jscan.SHORT and set(jscan.LONG) | {"device="} == set(tscan.LONG)
    assert tscan.main(["-m", "nonesuch", "x.png"]) == jscan.main(["-m", "nonesuch", "x.png"]) == 0
    src = _png(tmp_path)
    out = str(tmp_path / "d.y4m")
    assert tmain.main(["scan", "--device", "cpu", "-m", "zigzag", "-S", "100", "-q", src, out]) == 0
    assert open(out, "rb").read().count(b"FRAME\n") == 8


def _decoded_close(jout, tout, float_tol, share=None):
    """Both files decode to the same format and to frames within one
    stored level (integer pels; with ``share``, at most that share of
    the samples differ at all) or ``float_tol`` (float pels)."""
    worst, n, off = 0.0, 0, 0
    with jvideo.open_input(jout) as jr, tvideo.open_input(tout) as tr:
        assert type(tr).__name__ == type(jr).__name__ and tr.frames == jr.frames > 0
        assert tr.pix_fmt.name == jr.pix_fmt.name
        pf = tr.pix_fmt
        for _ in range(tr.frames):
            for p, q in zip(jr.read_frame(raw=True), tr.read_frame(raw=True)):
                d = np.abs(np.asarray(p, np.float64) - q)
                worst, n, off = max(worst, float(d.max())), n + d.size, off + int((d > 0).sum())
    assert worst <= (float_tol if pf.is_float else 1.0), worst
    if share is not None:
        assert off / n < share, off / n
    return pf


NATIVE_TARGETS = [("nut", "pixel_format=yuv420p:color_range=tv"), ("nut", "negotiate=1:level=3:slices=4"),
                  ("nut", None), ("mkv", None), ("mkv", "pixel_format=yuv444p:level=3")]


@pytest.mark.parametrize("ext,opts", NATIVE_TARGETS)
def test_nut_and_mkv_targets_match_jax(ext, opts, tmp_path, capsys, monkeypatch):
    """NUT and Matroska with the codec options ``--ff-opts`` carries (FFV1
    level and slices, ``negotiate=1``): decoded within the y4m test's one
    8-bit level on < 0.5 % where the pels are 8-bit, the fvid test's 2e-6
    where they are float, and one level where 16-bit FFV1 stores float
    frames."""
    hide_ffmpeg(monkeypatch)  # both packages' native Matroska
    flags = ["-m", "zigzag", "-S", "16", "-q"] + (["--ff-opts", opts] if opts else [])
    jout, tout, _, _ = _run_both(tmp_path, capsys, flags, _png(tmp_path), ext)
    pf = _decoded_close(jout, tout, 2e-6, share=0.005 if ext == "nut" and opts and "yuv" in opts
                        else None)
    assert {None: pf.is_float or ext == "mkv", "negotiate=1:level=3:slices=4": pf.name == "gbrp16le"
            }.get(opts, pf.depth == 8)
