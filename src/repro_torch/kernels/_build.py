"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` compiles on first use into its own shared library
with a plain C interface, under ``build/kernels/`` at the root of the
checkout. The file name carries a hash of the files its build reads (the
source, the ``.cu`` files it includes and the ``.cuh`` headers) and the
flags, so a changed source or flag rebuilds and an unchanged one is loaded
as it is.
``build_all`` starts one nvcc per source, all at once, and waits for them.
``load`` holds a lock while it builds and loads, so that threads (router
replicas) that first call a kernel together run one nvcc, not one each.
No CUDA toolkit is needed to import this module.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
SOURCES = ("bsr_spmm", "bsr_spmm_experts", "bsr_experts_bwd", "paged_attention",
           "bsr_sddmm", "prox_adam", "flash_attention")

_loaded: dict[str, ctypes.CDLL] = {}
_LOAD_LOCK = threading.Lock()


def nvcc_path() -> str:
    """nvcc from PATH, else from $CUDA_HOME (default /usr/local/cuda)."""
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError("nvcc not found on PATH or under $CUDA_HOME/bin; the "
                       "CUDA kernels of repro_torch need the CUDA toolkit")


def _inputs(name: str) -> list[Path]:
    """The files the build of ``name`` reads: its source, the ``.cu`` files
    that source includes (``bsr_spmm_experts.cu`` includes
    ``bsr_spmm.cu``), and the shared ``.cuh`` headers."""
    src = CSRC / f"{name}.cu"
    included = re.findall(r'^#include "([^"]+\.cu)"', src.read_text(), re.M)
    return sorted({src, *(CSRC / f for f in included), *CSRC.glob("*.cuh")})


def _digest(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _inputs(name):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"{name}-{_digest(name)}.so"


def log_path(name: str) -> Path:
    """The compiler's output (ptxas register / spill report) of the last
    build of ``name``."""
    return library_path(name).with_suffix(".log")


def build_all(names=SOURCES) -> list[Path]:
    """Compile every source whose library is missing, one nvcc per source,
    all started together. Raises with the compiler's output on failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = [n for n in names if not library_path(n).exists()]
    procs = []
    nvcc = nvcc_path() if todo else ""
    for n in todo:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{n}.cu")]
        procs.append((n, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for n, tmp, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode:
            os.unlink(tmp)
            failed.append(f"nvcc failed on {n}.cu (exit {proc.returncode}):\n{out}")
            continue
        log_path(n).write_text(out)
        os.replace(tmp, library_path(n))        # atomic publish
    if failed:
        raise RuntimeError("\n".join(failed))
    return [library_path(n) for n in names]


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _LOAD_LOCK:
        lib = _loaded.get(name)
        if lib is None:
            build_all((name,))
            lib = _loaded[name] = ctypes.CDLL(str(library_path(name)))
        return lib
