"""Run a JAX test module's cases on the port's modules.

The container tests of the JAX package (``tests/test_nut.py``,
``test_ffv1.py``, ``test_native.py``, ``test_interop_cv2.py``) are
written against module-level names (``video``, ``ffv1``, ``NutReader``,
...) and a few imports inside their bodies.  :func:`port_cases` lists a
module's cases, parametrisations expanded, and :func:`run_on_port` runs
one of them with every such name bound to the port's module instead:
the test's globals (and those of the module's helper functions) are
rebound, and the imports inside its body find the port's modules in
``sys.modules`` for the duration of the test.  The same assertions then
hold the port as they hold the JAX package.

:func:`hide_ffmpeg` takes the ffmpeg binaries off ``PATH`` for one test
in both packages, and nothing else: the host libraries still find
``g++`` (they may be built by the test that hides ffmpeg).
"""

from __future__ import annotations

import functools
import importlib
import inspect
import itertools
import os
import shutil
import sys
import types

import pytest

from dspfun_tpu_torch.io import cv2_bridge, ffmpeg_bridge, ffv1, mkv, native, nut, video
from dspfun_tpu_torch.tools import rotate, transcode

PORT = {
    "dspfun_tpu.io.video": video, "dspfun_tpu.io.nut": nut, "dspfun_tpu.io.ffv1": ffv1,
    "dspfun_tpu.io.mkv": mkv, "dspfun_tpu.io.native": native,
    "dspfun_tpu.io.ffmpeg_bridge": ffmpeg_bridge, "dspfun_tpu.io.cv2_bridge": cv2_bridge,
    "dspfun_tpu.tools.rotate": rotate, "dspfun_tpu.tools.transcode": transcode,
}


def port_cases(module, skip: dict) -> list:
    """``pytest.param((name, kwargs), id=...)`` for every case of
    ``module`` whose test is not in ``skip`` (name -> why)."""
    out = []
    for name, fn in vars(module).items():
        if not (name.startswith("test_") and callable(fn)) or name in skip:
            continue
        grids = []
        for mark in getattr(fn, "pytestmark", []):
            if mark.name != "parametrize":
                continue
            names, values = mark.args[:2]
            names = [n.strip() for n in (names.split(",") if isinstance(names, str) else names)]
            rows = [getattr(v, "values", v) for v in values]
            rows = [r if len(names) > 1 else (r,) for r in rows]
            grids.append([dict(zip(names, r)) for r in rows])
        for i, combo in enumerate(itertools.product(*grids)):
            kwargs = {k: v for part in combo for k, v in part.items()}
            out.append(pytest.param((name, kwargs), id=f"{name}[{i}]" if grids else name))
    return out


def port_function(request, module, name: str, extra: dict | None = None):
    """The test ``name`` of ``module`` with every JAX module name bound to
    the port's (``PORT``, and ``extra``: module name -> stand-in), in its
    globals, its helpers' globals and ``sys.modules`` for the rest of the
    test."""
    monkeypatch = request.getfixturevalue("monkeypatch")
    port = dict(PORT, **(extra or {}))
    for modname, mod in port.items():
        monkeypatch.setitem(sys.modules, modname, mod)
        parent, _, child = modname.rpartition(".")
        monkeypatch.setattr(importlib.import_module(parent), child, mod, raising=False)
    g = dict(vars(module))
    for k, v in vars(module).items():
        if isinstance(v, types.ModuleType) and v.__name__ in port:
            g[k] = port[v.__name__]
        elif getattr(v, "__module__", None) in port and hasattr(port[v.__module__], k):
            g[k] = getattr(port[v.__module__], k)
    for k, v in list(g.items()):
        if isinstance(v, types.FunctionType) and v.__module__ == module.__name__:
            g[k] = types.FunctionType(v.__code__, g, v.__name__, v.__defaults__, v.__closure__)
    return g[name]


def run_on_port(request, module, name: str, kwargs: dict) -> None:
    fn = port_function(request, module, name)
    args = {p: kwargs[p] if p in kwargs else request.getfixturevalue(p)
            for p in inspect.signature(fn).parameters}
    fn(**args)


FF_BINARIES = ("ffmpeg", "ffprobe", "ffplay")


def _bridges() -> list:
    """The ffmpeg bridge modules loaded in this process: the port's, and
    the JAX package's when a test has imported it (never imported here,
    so this module stays free of JAX)."""
    mods = [ffmpeg_bridge]
    jax_bridge = sys.modules.get("dspfun_tpu.io.ffmpeg_bridge")
    if jax_bridge is not None and jax_bridge is not ffmpeg_bridge:
        mods.append(jax_bridge)
    return mods


def hide_ffmpeg(monkeypatch) -> None:
    """For the rest of the test, ``shutil.which`` finds no ``ffmpeg``,
    ``ffprobe`` or ``ffplay`` and every other binary as before, and both
    packages' ``have_ffmpeg`` and ``have_ffprobe`` answer from a cache that
    starts empty.  The caches of the real functions are cleared first, and
    the real functions are not called while the test runs, so they are as
    empty after it as before it: nothing this test saw leaks into the next
    test of the same worker."""
    real = shutil.which

    def which(cmd, *args, **kw):
        if os.path.basename(os.fspath(cmd)) in FF_BINARIES:
            return None
        return real(cmd, *args, **kw)

    monkeypatch.setattr(shutil, "which", which)
    for mod in _bridges():
        for name in ("have_ffmpeg", "have_ffprobe"):
            fn = getattr(mod, name)
            fn.cache_clear()
            monkeypatch.setattr(mod, name, functools.lru_cache(maxsize=1)(fn.__wrapped__))


def clear_ffmpeg_caches() -> None:
    for mod in _bridges():
        mod.have_ffmpeg.cache_clear()
        mod.have_ffprobe.cache_clear()


def use_shims(monkeypatch, d) -> str:
    """The JAX bridge test's ``shims`` fixture, in directory ``d``: the
    shim binaries (``tests/torch_ffmpeg_shims.py``) first on ``PATH`` and
    their argv log at ``d/shim.log`` (returned), for the rest of the
    test, with both packages' binary caches cleared."""
    from tests import torch_ffmpeg_shims  # noqa: PLC0415

    bindir = torch_ffmpeg_shims.install_shims(os.path.join(d, "bin"))
    monkeypatch.setenv("PATH", f"{bindir}{os.pathsep}{os.environ['PATH']}")
    log = os.path.join(d, "shim.log")
    monkeypatch.setenv("SHIM_LOG", log)
    clear_ffmpeg_caches()
    return log


def run_cli_both(tmp_path, monkeypatch, capsys, mains, argv_of, shims: bool) -> dict:
    """Run each of ``mains`` (name -> a CLI's ``main``) on ``argv_of(d)``
    in a directory ``d`` of its own (the working directory too), with
    ffmpeg hidden or under the shims; per name: the exit code, stderr
    and the shims' logged argv with ``d`` written ``D``, and the bytes of
    every file the run left in ``d`` whose name starts with ``o``."""
    import json  # noqa: PLC0415

    got = {}
    for name, main in mains.items():
        d = tmp_path / f"{name}{int(shims)}"
        d.mkdir()
        with monkeypatch.context() as mp:
            mp.chdir(d)
            log = use_shims(mp, str(d)) if shims else hide_ffmpeg(mp)
            try:
                rc = main(argv_of(d))
            finally:
                clear_ffmpeg_caches()
        err = capsys.readouterr().err.replace(str(d), "D")
        # the shims log as their processes start: a decoder and an encoder
        # may log in either order
        argvs = (sorted(json.loads(ln.replace(str(d), "D")) for ln in open(log))
                 if shims and os.path.exists(log) else [])
        files = {p.name: p.read_bytes() for p in sorted(d.iterdir())
                 if p.is_file() and p.name.startswith("o")}
        got[name] = {"rc": rc, "err": err, "argv": argvs, "files": files}
    return got


def assert_cli_parity(got: dict, float_tol: float = 2e-6) -> None:
    """What :func:`run_cli_both` gave the JAX tool and the port: the same
    exit code, the same last line on stderr when it failed, the same
    logged argv, the same files, each equal or within a stored level
    (integer pels, on at most 0.5 % of bytes) or ``float_tol`` (float32
    rawvideo transport) of the other."""
    import numpy as np  # noqa: PLC0415

    j, t = got["jax"], got["torch"]
    assert t["rc"] == j["rc"], (j["err"], t["err"])
    if j["rc"]:
        assert t["err"].strip().splitlines()[-1:] == j["err"].strip().splitlines()[-1:]
    assert t["argv"] == j["argv"]
    assert t["files"].keys() == j["files"].keys()
    floats = any("gbrpf32le" in a or "grayf32le" in a for a in j["argv"])
    for k, a in j["files"].items():
        b = t["files"][k]
        if a == b:
            continue
        assert len(a) == len(b), k
        if floats:
            d = np.abs(np.frombuffer(a, "<f4").astype(np.float64) - np.frombuffer(b, "<f4"))
            assert d.max() <= float_tol, (k, d.max())
        else:
            d = np.abs(np.frombuffer(a, np.uint8).astype(int) - np.frombuffer(b, np.uint8))
            assert d.max() <= 1 and np.mean(d > 0) < 0.005, (k, d.max())
