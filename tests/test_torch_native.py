"""The port's host runtime (``dspfun_tpu_torch/io/native.py`` on its own
build of ``native/dspio.cpp``) against the JAX package's.

* Every case of ``tests/test_native.py`` runs on the port's modules
  (``tests/torch_port_cases.py``): the y4m and fvid demuxer, the
  prefetching reader, seeks, the indexed NUT reader, and the dither
  against the JAX package's ``lax.scan``.
* Both packages' native readers return equal frames from the same
  files; ``open_input`` reads files through ``NativeBackedReader`` by
  default, pipes through the Python readers.
* The port never loads a library built from the repo's ``native/``
  directory, and a failed build raises instead of falling back.
* A cold build works while a test hides ffmpeg
  (``torch_port_cases.hide_ffmpeg`` hides the ffmpeg binaries only, so
  ``g++`` is still found: a worker that reaches such a test before any
  library is built must build it).
"""

import shutil
import subprocess
import sys
from fractions import Fraction
from pathlib import Path

import numpy as np
import pytest

import tests.test_native as jnative_tests
from dspfun_tpu.io import native as jnative
from dspfun_tpu.io import video as jvideo
from dspfun_tpu_torch.io import native as tnative
from dspfun_tpu_torch.io import video as tvideo
from tests.torch_port_cases import hide_ffmpeg, port_cases, run_on_port

ROOT = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("case", port_cases(jnative_tests, {}))
def test_jax_native_case_on_the_port(case, request):
    run_on_port(request, jnative_tests, *case)


@pytest.mark.parametrize("pix_fmt,ext", [("yuv420p", "y4m"), ("yuv422p10le", "y4m"),
                                         ("gray", "y4m"), ("gbrpf32le", "fvid")])
def test_native_readers_agree(pix_fmt, ext, tmp_path):
    rng = np.random.default_rng(5)
    path = str(tmp_path / f"c.{ext}")
    with tvideo.open_output(path, 14, 10, Fraction(25), tvideo.ColorProps(pix_fmt=pix_fmt)) as w:
        for _ in range(6):
            w.write_frame_rgb(rng.random((10, 14, 3)))
    with jnative.NativeVideoReader(path) as a, tnative.NativeVideoReader(path, prefetch=2) as b:
        assert (b.width, b.height, b.nframes, b.rate, b.pixfmt, b.plane_dims) == \
            (a.width, a.height, a.nframes, a.rate, a.pixfmt, a.plane_dims)
        for _ in range(6):
            for x, y in zip(a.read_frame(), b.read_frame()):
                np.testing.assert_array_equal(x, y)
        assert b.read_frame() is None
    with tvideo.open_input(path) as r, jvideo.open_input(path, native=False) as p:
        assert isinstance(r, tvideo.NativeBackedReader) and r.frames == p.frames == 6
        assert vars(r.props) == vars(p.props)
        r.seek_frame(2)
        p.seek_frame(2)
        for _ in range(4):
            for x, y in zip(p.read_frame(), r.read_frame()):
                np.testing.assert_array_equal(x, y)


def test_pipes_use_the_python_reader(tmp_path):
    path = tmp_path / "c.y4m"
    with tvideo.open_output(str(path), 8, 6, Fraction(25), tvideo.ColorProps(pix_fmt="gray")) as w:
        for t in range(3):
            w.write_frame([np.full((6, 8), 10.0 * t)], raw=True)
    code = ("import sys; from dspfun_tpu_torch.io import video\n"
            "r = video.open_input('-')\n"
            "print(type(r).__name__, r.frames, [int(r.read_frame(raw=True)[0][0, 0]) for _ in range(3)])\n")
    res = subprocess.run([sys.executable, "-c", code], input=path.read_bytes(), cwd=ROOT,
                         capture_output=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.decode().split() == ["Y4MReader", "None", "[0,", "10,", "20]"]


def test_the_library_is_the_ports_own_build(monkeypatch, tmp_path):
    """libdspio loads from build/native/ (the package's copy of the
    source), never from the repo's native/ directory; a failed build
    raises with the compiler's message and open_input lets it through."""
    from dspfun_tpu_torch import _hostbuild

    lib = tnative._load()
    assert Path(lib._name).resolve() == _hostbuild.library_path("dspio")
    assert Path(lib._name).parent == ROOT / "build" / "native"
    assert (ROOT / "dspfun_tpu_torch" / "native" / "dspio.cpp").read_bytes() == \
        (ROOT / "native" / "dspio.cpp").read_bytes()
    path = str(tmp_path / "c.y4m")
    with tvideo.open_output(path, 8, 6, Fraction(25), tvideo.ColorProps(pix_fmt="gray")) as w:
        w.write_frame([np.zeros((6, 8))], raw=True)

    def broken():
        raise RuntimeError("g++ failed (1): cannot build dspio")

    monkeypatch.setattr(tnative, "_load", broken)
    with pytest.raises(RuntimeError, match="g.. failed"):
        tvideo.open_input(path)
    assert isinstance(tvideo.open_input(path, native=False), tvideo.Y4MReader)


def test_concurrent_builds_leave_one_whole_library(tmp_path, monkeypatch):
    """Processes that build the same library at once (xdist workers) each
    load a whole file: the compiler writes a temporary name that is
    renamed into place."""
    from dspfun_tpu_torch import _hostbuild

    monkeypatch.setattr(_hostbuild, "build_dir", lambda: tmp_path / "native")
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from pathlib import Path\n"
            "from dspfun_tpu_torch import _hostbuild\n"
            "_hostbuild.build_dir = lambda: Path(%r)\n"
            "lib = _hostbuild.load_library('dspio'); print(lib.dspio_open is not None)\n"
            % (str(ROOT), str(tmp_path / "native")))
    procs = [subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE) for _ in range(3)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 for p in procs), [o[1] for o in outs]
    assert [o[0].strip() for o in outs] == [b"True"] * 3
    assert [p.name for p in (tmp_path / "native").iterdir()] == \
        [_hostbuild.library_path("dspio").name]


def test_cold_build_while_ffmpeg_is_hidden(tmp_path, monkeypatch):
    from dspfun_tpu_torch import _hostbuild
    from dspfun_tpu_torch.io import ffmpeg_bridge

    hide_ffmpeg(monkeypatch)
    assert shutil.which("ffmpeg") is shutil.which("ffprobe") is shutil.which("ffplay") is None
    assert shutil.which("g++") is not None
    assert not ffmpeg_bridge.have_ffmpeg() and not ffmpeg_bridge.have_ffprobe()
    monkeypatch.setattr(_hostbuild, "build_dir", lambda: tmp_path)
    _hostbuild.load_library.cache_clear()
    try:
        assert list(tmp_path.iterdir()) == []
        lib = _hostbuild.load_library("dspio")
        assert Path(lib._name).parent == tmp_path
        assert [p.name for p in tmp_path.iterdir()] == [_hostbuild.library_path("dspio").name]
    finally:
        _hostbuild.load_library.cache_clear()
