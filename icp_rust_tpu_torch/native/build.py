"""Build and load the native C++ libraries (``native/src/*.cpp``).

Each source is compiled by ``g++`` at first use into a shared library
under ``icp_rust_tpu_torch/_build/native/`` (listed in ``.gitignore``):

    g++ -O3 -march=native -std=c++17 -fPIC -shared -o lib<name>-<hash>.so

These are the JAX package's ``native/build.sh`` flags: ``-march=native``
lets g++ contract multiply-adds into FMA instructions wherever the host
has them, and the same flags on the same host make this oracle bitwise
equal to the JAX package's.  The library name carries a hash of the
source and flags, so an edited source is rebuilt and a stale library
never loads; a build writes a temporary file and renames it, so
processes that build at once do not see half a library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

SRC = Path(__file__).resolve().parent / "src"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build" / "native"
FLAGS = ("-O3", "-march=native", "-std=c++17", "-fPIC", "-shared")

_libs: dict = {}


def lib_path(name: str) -> Path:
    h = hashlib.sha256((SRC / f"{name}.cpp").read_bytes())
    h.update(" ".join(FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile ``src/<name>.cpp`` unless it is built; returns the path."""
    out = lib_path(name)
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native libraries are built "
                           "from native/src at first use")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *FLAGS, "-o", str(tmp),
                           str(SRC / f"{name}.cpp")],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed on {name}.cpp:\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def load(name: str) -> ctypes.CDLL:
    """The library of ``src/<name>.cpp``, built and loaded once."""
    lib = _libs.get(name)
    if lib is None:
        lib = _libs[name] = ctypes.CDLL(str(build(name)))
    return lib
