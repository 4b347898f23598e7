"""Build the hand-written CUDA kernels at first use and load them.

``csrc/*.cu`` compile with ``nvcc``, one process per source, all started
together, and link into one shared library with a plain C interface,
which ``ctypes`` loads.  Headers that pull in PyTorch take
minutes to compile; a plain C interface takes seconds.  The sources
share ``csrc/*.cuh`` headers, which nvcc finds beside them.  The library
lands in ``build/kernels/`` at the root of the checkout, named by a
hash of the sources, headers and flags, so an edited source or header
rebuilds and an unchanged tree loads the existing library.  ptxas reports each kernel's
registers, shared memory and spills (``-Xptxas -v``); the compile logs
are kept beside the library (:func:`build_log`).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

__all__ = ["NVCC_FLAGS", "build_dir", "build_inputs", "build_log", "library_path",
           "load_library"]

_CSRC = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def build_dir() -> Path:
    return Path(__file__).resolve().parent.parent / "build" / "kernels"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME or /usr/local/cuda); "
                       "the CUDA kernels cannot be built")


def _sources() -> list[Path]:
    srcs = sorted(_CSRC.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {_CSRC}")
    return srcs


def build_inputs() -> list[Path]:
    """Every file the build reads: the sources it compiles and the headers
    they include.  An installed copy must ship them all (the package data
    of pyproject.toml)."""
    return _sources() + sorted(_CSRC.glob("*.cuh"))


def library_path() -> Path:
    """Where the library of the current sources, headers and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in build_inputs():
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return build_dir() / f"libdspfun_kernels_{h.hexdigest()[:16]}.so"


def build_log() -> str:
    """The compile logs of the current library (ptxas's register, shared
    memory and spill lines), or "" before it is built."""
    log = library_path().with_suffix(".log")
    return log.read_text() if log.is_file() else ""


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Compile (when the sources changed) and load the kernel library."""
    srcs = _sources()
    lib = library_path()
    out_dir = lib.parent
    if not lib.is_file():
        nvcc = _nvcc()
        out_dir.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
            cmds = [[nvcc, *NVCC_FLAGS, "-c", str(s), "-o", f"{tmp}/{s.stem}.o"]
                    for s in srcs]
            procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True) for c in cmds]
            logs = [p.communicate()[0] for p in procs]
            link = [nvcc, *NVCC_FLAGS, "-shared", "-o", f"{tmp}/lib.so",
                    *(c[-1] for c in cmds)]
            for cmd, proc, log in zip(cmds, procs, logs):
                if proc.returncode != 0:
                    raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                                       f"{' '.join(cmd)}\n{log}")
            res = subprocess.run(link, capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(f"nvcc link failed ({res.returncode}): "
                                   f"{' '.join(link)}\n{res.stdout}{res.stderr}")
            Path(f"{tmp}/lib.log").write_text(
                "".join(f"== {s.name}\n{log}" for s, log in zip(srcs, logs)))
            os.replace(f"{tmp}/lib.log", lib.with_suffix(".log"))
            os.replace(f"{tmp}/lib.so", lib)  # atomic: a concurrent loader sees all or none
    return ctypes.CDLL(str(lib))
