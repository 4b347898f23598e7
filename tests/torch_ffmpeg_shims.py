"""The ffmpeg, ffprobe and ffplay shims of ``tests/test_ffmpeg_bridge.py``,
without JAX, for the port's tests and ``chip_smoke.py`` on machines that
have no ffmpeg binary.

The shims speak just enough of the command line: ``ffmpeg`` in demux
mode copies its input (a file or stdin) to stdout, dropping a leading
``FAKEMP4\\n`` header, and in encode mode copies stdin into its target;
``ffprobe`` prints a fixed probe (or the file ``$SHIM_PROBE``); ``ffplay``
reads stdin.  ``ffmpeg`` and ``ffplay`` append their arguments as one
JSON line to ``$SHIM_LOG``.  tests/test_torch_ffmpeg_bridge.py pins the
texts to the JAX test's.
"""

from __future__ import annotations

import os
import stat
from pathlib import Path

__all__ = ["FAKE_HEADER", "FFMPEG_SHIM", "FFPLAY_SHIM", "FFPROBE_SHIM", "install_shims",
           "shim_path"]

FAKE_HEADER = b"FAKEMP4\n"

FFMPEG_SHIM = """#!/usr/bin/env python3
import json, os, sys
args = sys.argv[1:]
log = os.environ.get("SHIM_LOG")
if log:
    with open(log, "a") as f:
        f.write(json.dumps(args) + "\\n")
i = args.index("-i")
src = args[i + 1]
out = args[-1]
if out == "-":      # demux mode: container (file or stdin) -> pipe
    if src == "-":
        data = sys.stdin.buffer.read()
    else:
        with open(src, "rb") as f:
            data = f.read()
    if data.startswith(b"FAKEMP4\\n"):
        data = data[8:]
    sys.stdout.buffer.write(data)
else:               # encode mode: pipe stdin -> container file
    data = sys.stdin.buffer.read()
    with open(out, "wb") as f:
        f.write(data)
"""

FFPROBE_SHIM = """#!/usr/bin/env python3
import json, os, sys
override = os.environ.get("SHIM_PROBE")
if override:
    with open(override) as f:
        sys.stdout.write(f.read())
    sys.exit(0)
print(json.dumps({"streams": [{
    "codec_type": "video", "pix_fmt": "yuv420p", "nb_frames": "4",
    "avg_frame_rate": "25/1", "color_range": "tv",
    "color_space": "bt709", "color_primaries": "bt709",
    "color_transfer": "bt709",
}], "format": {}}))
"""

FFPLAY_SHIM = """#!/usr/bin/env python3
import json, os, sys
log = os.environ.get("SHIM_LOG")
if log:
    with open(log, "a") as f:
        f.write(json.dumps(sys.argv[1:]) + "\\n")
sys.stdin.buffer.read()
"""


def install_shims(bindir) -> Path:
    """Write the three shims into ``bindir`` (made if missing) as
    executables and return it; the caller puts it first on ``PATH``."""
    bindir = Path(bindir)
    bindir.mkdir(parents=True, exist_ok=True)
    for name, text in (("ffmpeg", FFMPEG_SHIM), ("ffprobe", FFPROBE_SHIM),
                       ("ffplay", FFPLAY_SHIM)):
        p = bindir / name
        p.write_text(text)
        p.chmod(p.stat().st_mode | stat.S_IEXEC)
    return bindir


def shim_path(bindir) -> str:
    """``PATH`` with ``bindir`` first."""
    return f"{bindir}{os.pathsep}{os.environ.get('PATH', '')}"
