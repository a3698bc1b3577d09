"""Build and load the native C++ libraries (``native/*.cc``).

Port of ``paddle_lite_tpu/native/build.py``: each source is compiled with
``g++`` into a shared library with a plain C interface, bound with
``ctypes``.  Libraries go to ``paddle_lite_tpu_torch/_build/`` (listed in
``.gitignore``, beside the CUDA kernels' libraries) under a name that
carries the hash of the source, so an edited source is rebuilt and an
unchanged one reused.  Nothing is built at import time; the first use
builds.  A missing compiler or a failed build raises
:class:`NativeBuildError`: there is no pure-Python fallback.
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

NATIVE_DIR = Path(__file__).resolve().parent
BUILD_DIR = NATIVE_DIR.parent / "_build"

CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared", "-Wall"]


class NativeBuildError(RuntimeError):
    pass


def build_library(name: str) -> Path:
    """Compile ``native/<name>.cc`` into a cached .so; returns its path."""
    src = NATIVE_DIR / f"{name}.cc"
    if not src.exists():
        raise NativeBuildError(f"no such native source: {src}")
    out = BUILD_DIR / f"lib{name}-{hashlib.sha256(src.read_bytes()).hexdigest()[:16]}.so"
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise NativeBuildError(f"g++ not found: native/{name}.cc cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build under a private name, then rename: a reader never sees half a file
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [cxx, *CXX_FLAGS, str(src), "-o", str(tmp)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise NativeBuildError(f"g++ failed for {name}:\n{proc.stderr[-2000:]}")
    tmp.replace(out)
    for old in BUILD_DIR.glob(f"lib{name}-*.so"):
        if old != out:
            old.unlink(missing_ok=True)
    return out


_LOADED: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def load_library(name: str) -> ctypes.CDLL:
    with _LOCK:
        if name not in _LOADED:
            _LOADED[name] = ctypes.CDLL(str(build_library(name)))
        return _LOADED[name]
