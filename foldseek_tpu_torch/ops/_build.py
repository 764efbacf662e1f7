"""Build the CUDA kernels in `csrc/` with nvcc and load them with ctypes.

Each `csrc/<name>.cu` exposes a plain C entry point, so it compiles in
seconds without PyTorch's headers. The shared library lands in
`foldseek_tpu_torch/build/lib<name>-<hash>.so`, where the hash covers the
source, every header in `csrc/` and the flags: an edited kernel or header is
rebuilt, an unchanged one is loaded as it is. A failed build or load raises;
nothing falls back.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from dataclasses import dataclass
from typing import Dict

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclass
class Built:
    lib: ctypes.CDLL
    path: str
    seconds: float   # nvcc wall time in this process, 0.0 when reused
    log: str         # nvcc/ptxas output (registers, spills per kernel)


_built: Dict[str, Built] = {}
_lock = threading.Lock()
_name_locks: Dict[str, threading.Lock] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in (os.path.join(home, "bin", "nvcc") if home else None,
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels in "
                       f"{CSRC_DIR} need the CUDA toolkit to build")


def library_path(name: str) -> str:
    """Where `csrc/<name>.cu` builds to: the hash in the file name covers the
    flags, the source and every header of `csrc/`."""
    digest = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    headers = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh")))
    for path in [os.path.join(CSRC_DIR, name + ".cu"), *headers]:
        with open(path, "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:12]}.so")


def _compile(name: str) -> Built:
    src = os.path.join(CSRC_DIR, name + ".cu")
    so = library_path(name)
    seconds, log = 0.0, ""
    if not os.path.isfile(so):
        os.makedirs(BUILD_DIR, exist_ok=True)
        fd, tmp = tempfile.mkstemp(prefix=f"lib{name}-", suffix=".so",
                                   dir=BUILD_DIR)
        os.close(fd)
        t0 = time.perf_counter()
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                              capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed on {src}:\n{log}")
        os.replace(tmp, so)   # atomic: no process loads half a file
    return Built(ctypes.CDLL(so), so, seconds, log)


def load(name: str) -> Built:
    """The built kernel library `csrc/<name>.cu`, compiled on first use.
    Threads asking for different libraries build them side by side."""
    with _lock:
        name_lock = _name_locks.setdefault(name, threading.Lock())
    with name_lock:
        built = _built.get(name)
        if built is None:
            built = _built[name] = _compile(name)
        return built
