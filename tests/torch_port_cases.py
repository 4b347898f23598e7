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
"""

from __future__ import annotations

import importlib
import inspect
import itertools
import sys
import types

import pytest

from dspfun_tpu_torch.io import ffv1, mkv, native, nut, video
from dspfun_tpu_torch.tools import rotate, transcode

PORT = {
    "dspfun_tpu.io.video": video, "dspfun_tpu.io.nut": nut, "dspfun_tpu.io.ffv1": ffv1,
    "dspfun_tpu.io.mkv": mkv, "dspfun_tpu.io.native": native,
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


def run_on_port(request, module, name: str, kwargs: dict) -> None:
    monkeypatch = request.getfixturevalue("monkeypatch")
    for modname, mod in PORT.items():
        monkeypatch.setitem(sys.modules, modname, mod)
        parent, _, child = modname.rpartition(".")
        monkeypatch.setattr(importlib.import_module(parent), child, mod, raising=False)
    g = dict(vars(module))
    for k, v in vars(module).items():
        if isinstance(v, types.ModuleType) and v.__name__ in PORT:
            g[k] = PORT[v.__name__]
        elif getattr(v, "__module__", None) in PORT and hasattr(PORT[v.__module__], k):
            g[k] = getattr(PORT[v.__module__], k)
    for k, v in list(g.items()):
        if isinstance(v, types.FunctionType) and v.__module__ == module.__name__:
            g[k] = types.FunctionType(v.__code__, g, v.__name__, v.__defaults__, v.__closure__)
    fn = g[name]
    args = {p: kwargs[p] if p in kwargs else request.getfixturevalue(p)
            for p in inspect.signature(fn).parameters}
    fn(**args)
