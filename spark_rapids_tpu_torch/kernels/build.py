"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into a shared library with a
plain C interface, loaded through ``ctypes``. The library's file name
carries a hash of the source and the flags, so a stale build never loads.
Builds go into ``_build/`` inside the package (ignored by git), at first
use; nothing is compiled when a module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, List, Tuple

CSRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)), "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
#: name → (seconds, nvcc/ptxas output) of the build made in this process
BUILD_LOG: Dict[str, Tuple[float, str]] = {}


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return found


def _lib_path(name: str) -> str:
    with open(os.path.join(CSRC, name + ".cu"), "rb") as f:
        src = f.read()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return os.path.join(BUILD_DIR, f"lib{name}_{digest[:16]}.so")


def build_all(names: List[str]) -> Dict[str, ctypes.CDLL]:
    """Build every named source not yet built, one ``nvcc`` each, all
    started together; then load them. Raises on a failed build."""
    with _LOCK:
        os.makedirs(BUILD_DIR, exist_ok=True)
        procs = {}
        for name in names:
            if name in _LIBS:
                continue
            path = _lib_path(name)
            if os.path.exists(path):
                continue
            tmp = f"{path}.{os.getpid()}.tmp"
            cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
                   os.path.join(CSRC, name + ".cu")]
            procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True),
                           time.perf_counter(), tmp, path)
        for name, (proc, t0, tmp, path) in procs.items():
            out, _ = proc.communicate()
            BUILD_LOG[name] = (time.perf_counter() - t0, out)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {name}.cu:\n{out}")
            os.replace(tmp, path)
        for name in names:
            if name not in _LIBS:
                _LIBS[name] = ctypes.CDLL(_lib_path(name))
        return {n: _LIBS[n] for n in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library (built at first use). Once loaded, a lookup with
    no file-system call: it sits on every kernel launch."""
    lib = _LIBS.get(name)
    return lib if lib is not None else build_all([name])[name]
