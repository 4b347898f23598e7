"""The port's ffmpeg bridge (``dspfun_tpu_torch/io/ffmpeg_bridge.py`` and
the bridge half of ``io/video.py``) against the JAX package's, case by
case, under the same shim binaries.

Every test of ``tests/test_ffmpeg_bridge.py`` (the golden probes and
argv transcripts of ``tests/goldens/`` included) runs twice, in a
directory of its own: once as written, on the JAX package, and once with
every JAX module bound to the port's (``tests/torch_port_cases.py``;
motion runs with ``--device cpu``).  Both runs must pass the test's own
assertions, log the same ffmpeg/ffplay argv (paths made relative to the
run's directory) and leave the same bytes in every file they write.  The
no-binary cases hide ffmpeg with ``torch_port_cases.hide_ffmpeg``, which
keeps ``g++`` on PATH for the host libraries.
"""

import inspect
import json
import os
import types
from pathlib import Path

import pytest

import tests.test_ffmpeg_bridge as jbridge
from dspfun_tpu_torch.tools import motion as tmotion
from tests import torch_ffmpeg_shims
from tests.torch_port_cases import clear_ffmpeg_caches, hide_ffmpeg, port_function, use_shims

CASES = sorted(n for n, f in vars(jbridge).items()
               if n.startswith("test_") and callable(f))

# the JAX motion CLI runs on its default backend; the port's on the CPU
_MOTION_CPU = types.ModuleType("dspfun_tpu_torch.tools.motion_cpu")
_MOTION_CPU.main = lambda argv: tmotion.main(["--device", "cpu", *argv])


def _files(d):
    out = {}
    for root, _dirs, names in os.walk(d):
        for n in names:
            p = os.path.join(root, n)
            rel = os.path.relpath(p, d)
            if not rel.startswith("bin" + os.sep) and rel != "shim.log":
                out[rel] = open(p, "rb").read()
    return out


def test_case_count_and_shim_texts():
    assert len(CASES) == 21
    for name in ("FFMPEG_SHIM", "FFPROBE_SHIM", "FFPLAY_SHIM"):
        assert getattr(torch_ffmpeg_shims, name) == getattr(jbridge, name)


@pytest.mark.parametrize("name", CASES)
def test_bridge_case_on_both_packages(name, tmp_path, monkeypatch, request):
    logs, files = {}, {}
    for side in ("jax", "torch"):
        d = tmp_path / side
        d.mkdir()
        if side == "jax":
            fn = getattr(jbridge, name)
        else:
            fn = port_function(request, jbridge, name,
                               extra={"dspfun_tpu.tools.motion": _MOTION_CPU})
        log = d / "shim.log"
        with monkeypatch.context() as mp:
            args = {}
            for p in inspect.signature(fn).parameters:
                if p == "tmp_path":
                    args[p] = d
                elif p == "monkeypatch":
                    args[p] = mp
                elif p == "shims":
                    args[p] = Path(use_shims(mp, d))
                elif p == "no_ffmpeg":
                    hide_ffmpeg(mp)
                    args[p] = None
                else:
                    args[p] = request.getfixturevalue(p)
            try:
                fn(**args)
            finally:
                clear_ffmpeg_caches()
        lines = log.read_text().splitlines() if log.exists() else []
        # a decoder and an encoder shim log as they start, in either order
        logs[side] = sorted(json.loads(ln.replace(str(d), "TMP")) for ln in lines)
        files[side] = _files(d)
    assert logs["torch"] == logs["jax"]
    assert files["torch"].keys() == files["jax"].keys()
    for k in files["jax"]:
        assert files["torch"][k] == files["jax"][k], k
