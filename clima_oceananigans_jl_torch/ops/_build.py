"""Build and load the port's CUDA kernels.

Each kernel in ``csrc/`` has a plain C interface. It is compiled with
``nvcc`` into a shared library at first use and loaded with ``ctypes``.
The library lands in ``_build/`` inside the package (listed in
``.gitignore``) under a name that carries a hash of the flags, the
source and every ``csrc/`` header it includes, so an edited source,
header or flag rebuilds and an unchanged one loads the cached build.
Nothing here runs at import time.
"""
from __future__ import annotations

import concurrent.futures
import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

#: sm_90a for Hopper; --fmad=false keeps the kernels from contracting
#: a*b+c into FMAs that eager PyTorch does not form.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC")

_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def _nvcc():
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ((Path(home) / "bin" / "nvcc") if home else None,
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and Path(cand).is_file():
            return str(cand)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def sources(name):
    """``csrc/<name>.cu`` and the ``csrc/`` files it includes with
    ``#include "..."``, transitively, in first-seen order."""
    seen, todo = [], [CSRC / f"{name}.cu"]
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.append(path)
        for inc in _INCLUDE.findall(path.read_bytes()):
            todo.append(path.parent / inc.decode())
    return seen


def library_path(name):
    """Path of the built library for ``csrc/<name>.cu`` (not built here)."""
    h = hashlib.sha256("\0".join(NVCC_FLAGS).encode())
    for path in sources(name):
        h.update(b"\0" + path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


#: seconds this process spent compiling each kernel (0.0 when the cached
#: build was found)
build_seconds = {}


def _ensure_built(name):
    out = library_path(name)
    if out.exists():
        build_seconds.setdefault(name, 0.0)
        return out
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}) for {name}:\n"
                           f"{' '.join(cmd)}\n{res.stdout}{res.stderr}")
    os.replace(tmp, out)
    build_seconds[name] = time.perf_counter() - t0
    return out


def build(*names):
    """Compile the named kernels that have no build yet, one ``nvcc`` each,
    all at once; raises the first failure."""
    with concurrent.futures.ThreadPoolExecutor(max(1, len(names))) as ex:
        for fut in [ex.submit(_ensure_built, n) for n in names]:
            fut.result()


@functools.lru_cache(maxsize=None)
def load(name):
    """Compile ``csrc/<name>.cu`` if its build is missing, then load it."""
    return ctypes.CDLL(str(_ensure_built(name)))
