"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into a shared library with
a plain C interface (no PyTorch headers, so a build takes seconds) and
loaded with ``ctypes``.  Builds happen at first use, never at import, into
``downpore_tpu_torch/_build/`` (git-ignored), named by a hash of the
source and of every ``csrc`` header it includes (``source_tag``), so an
edited kernel or header is never served a stale binary.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_LIBS: dict = {}
_LOCK = threading.Lock()
_NAME_LOCKS: dict = {}
# seconds spent in nvcc per library built by this process
build_seconds: dict = {}


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path:
        return path
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin); the CUDA "
                       "kernels of downpore_tpu_torch build at first use")


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def source_tag(name: str, csrc: str = CSRC) -> str:
    """Build tag of ``csrc/<name>.cu``: a hash over the source and, in a
    fixed order, every header it reaches through ``#include "..."``
    (followed recursively; headers outside ``csrc`` are the toolkit's)."""
    h = hashlib.sha256()
    seen = set()
    todo = [name + ".cu"]
    while todo:
        rel = todo.pop()
        if rel in seen:
            continue
        seen.add(rel)
        path = os.path.join(csrc, rel)
        if not os.path.exists(path):
            continue
        with open(path, "rb") as f:
            data = f.read()
        todo.extend(m.decode() for m in _INCLUDE.findall(data))
    for rel in sorted(seen):
        path = os.path.join(csrc, rel)
        if os.path.exists(path):
            with open(path, "rb") as f:
                h.update(rel.encode() + b"\0" + f.read() + b"\0")
    return h.hexdigest()[:16]


def load(name: str) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` if no build of this exact source (and
    headers) exists, then load it (once per process).  Calls for different
    names may run in parallel threads, each with its own nvcc."""
    with _LOCK:
        lock = _NAME_LOCKS.setdefault(name, threading.Lock())
    with lock:
        lib = _LIBS.get(name)
        if lib is not None:
            return lib
        src = os.path.join(CSRC, name + ".cu")
        so = os.path.join(BUILD_DIR, f"{name}_{source_tag(name)}.so")
        if not os.path.exists(so):
            t0 = time.perf_counter()
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{so}.{os.getpid()}.tmp"
            proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {src}:\n{proc.stderr}")
            os.replace(tmp, so)
            build_seconds[name] = time.perf_counter() - t0
        lib = ctypes.CDLL(so)
        _LIBS[name] = lib
        return lib
