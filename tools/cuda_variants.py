"""Patched copies of one CUDA source, built and loaded beside the shipped
library: the machinery of the design tools (``tools/expert_spmm_design.py``,
``tools/expert_bwd_design.py``).

A variant is a list of patches to ``csrc/<source>.cu``, each a function of
the text or an ``(old, new)`` / ``(old, new, count)`` replacement whose old
text must occur exactly ``count`` times (1 where not given).
"""
from __future__ import annotations

import ctypes
import subprocess
from pathlib import Path

from repro_torch.kernels import _build


def patched(variants: dict, name: str, src: str) -> str:
    """The source of variant ``name`` of ``variants``: ``src`` with its
    patches."""
    for patch in variants[name]:
        if callable(patch):
            src = patch(src)
            continue
        old, new, count = (*patch, 1) if len(patch) == 2 else patch
        assert src.count(old) == count, (name, old)
        src = src.replace(old, new)
    return src


def build_variants(source: str, out: Path, variants: dict, names, shipped,
                   entries, includes=()) -> dict:
    """The library of each variant in ``names``: patched copies of
    ``csrc/<source>.cu`` built in ``out`` beside copies of the headers (and
    of the sources in ``includes``), one nvcc each, all at once, and the
    shipped library, which ``shipped()`` loads (and builds, while the
    copies compile). Each copy's ``entries`` take the shipped library's
    argument types. Returns name -> (library, ptxas report), "shipped"
    first."""
    out.mkdir(parents=True, exist_ok=True)
    src = (_build.CSRC / f"{source}.cu").read_text()
    for f in [*_build.CSRC.glob("*.cuh"),
              *(_build.CSRC / f"{i}.cu" for i in includes)]:
        (out / f.name).write_text(f.read_text())
    procs = {}
    for name in names:
        cu = out / f"{source}_{name}.cu"
        cu.write_text(patched(variants, name, src))
        so = cu.with_suffix(".so")
        procs[name] = (so, subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    lib0 = shipped()
    libs = {"shipped": (lib0, _build.log_path(source).read_text())}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed on the {name} copy:\n{log}")
        lib = ctypes.CDLL(str(so))
        for fn in entries:
            getattr(lib, fn).argtypes = getattr(lib0, fn).argtypes
            getattr(lib, fn).restype = getattr(lib0, fn).restype
        libs[name] = (lib, log)
    return libs
