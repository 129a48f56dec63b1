"""Build and load the port's host C++ library (``csrc/host/*.cpp``).

The image codec's serial work (``video/image.py``: JPEG Huffman coding, PNG
unfiltering) is plain C++ with a C interface, compiled with g++ at first
use into ``lameness_tpu_torch/_build/`` and loaded with ctypes, as
``_cuda.py`` builds and loads the kernels.  The file name carries a hash of
the source and flags, so an edited source is rebuilt.  Both the CPU path
and the card path use it; a failed build raises with the compiler's output.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

from ._cuda import BUILD_DIR, CSRC

HOST_SRC = CSRC / "host"
CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _cxx() -> str:
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the port's host library "
                           "(csrc/host/) is built with g++ at first use")
    return cxx


def library_path(name: str) -> Path:
    h = hashlib.sha256((HOST_SRC / f"{name}.cpp").read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile ``csrc/host/<name>.cpp`` unless it is built; raises with the
    compiler's output when the build fails."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [_cxx(), *CXX_FLAGS, "-o", str(tmp), str(HOST_SRC / f"{name}.cpp")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"host library build failed ({' '.join(cmd)}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def library(name: str) -> ctypes.CDLL:
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = _libs[name] = ctypes.CDLL(str(build(name)))
        return lib
