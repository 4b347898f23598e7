"""Build the host libraries (``native/*.cpp``) at first use and load them.

``native/dspio.cpp`` (the y4m/fvid demuxer, the prefetching frame
reader, pel conversions, Floyd-Steinberg dither) and ``native/ffv1.cpp``
(the FFV1 codec) are copies of the JAX package's ``native/`` sources;
``native/jpeg.cpp``, ``tiff.cpp``, ``fax.cpp``, ``zstd.cpp``, ``gif.cpp``,
``webp.cpp``, ``rawimg.cpp``, ``bcn.cpp``, ``j2k.cpp`` and ``quant.cpp`` (the
codecs of ``io/jpeg.py``, ``io/imgcodecs.py`` (LZW, PackBits, CCITT and
Zstandard TIFF strips), ``io/gif.py``, ``io/webp.py``, ``io/rawimg.py``,
``io/ico.py``, ``io/psd.py``, ``io/dds.py`` and ``io/jpeg2000.py``, and the
quantiser of ``io/quant.py``) are the port's own.
Each compiles with ``g++`` and the flags of that package's Makefile (never ``-ffast-math``:
the dither, pel, JPEG and palette paths must round as specified) into ``build/native/`` at the root of the checkout, named by
a hash of its source and flags, so an edited source rebuilds and an
unchanged one loads the existing library.  The compiler writes a
temporary file that is renamed into place, so processes that ask for
the same library at once each see all of it or none.

A failed build raises with the compiler's message: nothing in the port
falls back to a slower path or another codec when a library is missing.
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

__all__ = ["CXX_FLAGS", "build_dir", "build_inputs", "library_path", "load_library"]

_NATIVE = Path(__file__).resolve().parent / "native"
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall", "-shared", "-pthread")


def build_dir() -> Path:
    return Path(__file__).resolve().parent.parent / "build" / "native"


def build_inputs() -> list[Path]:
    """The sources the host build compiles (an installed copy must ship
    them: the package data of pyproject.toml)."""
    return sorted(_NATIVE.glob("*.cpp"))


def library_path(name: str) -> Path:
    """Where the library of ``native/<name>.cpp`` at the current source
    and flags lives."""
    src = _NATIVE / f"{name}.cpp"
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(src.read_bytes())
    return build_dir() / f"lib{name}_{h.hexdigest()[:16]}.so"


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> ctypes.CDLL:
    """Compile ``native/<name>.cpp`` (when its source or the flags
    changed) and load it."""
    src = _NATIVE / f"{name}.cpp"
    if not src.is_file():
        raise RuntimeError(f"host library source {src} is missing")
    lib = library_path(name)
    if not lib.is_file():
        cxx = os.environ.get("CXX") or shutil.which("g++")
        if not cxx:
            raise RuntimeError(f"g++ not found: the host library {name} cannot be built")
        lib.parent.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=lib.parent) as tmp:
            out = Path(tmp) / lib.name
            cmd = [cxx, *CXX_FLAGS[:-2], str(src), *CXX_FLAGS[-2:], "-o", str(out)]
            res = subprocess.run(cmd, capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(f"{Path(cxx).name} failed ({res.returncode}): "
                                   f"{' '.join(cmd)}\n{res.stdout}{res.stderr}")
            os.replace(out, lib)  # atomic: a concurrent loader sees all or none
    return ctypes.CDLL(str(lib))
