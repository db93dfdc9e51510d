"""Build and load the port's CUDA kernels (one shared library, ctypes).

The sources in ``kernels/csrc/*.cu`` have a plain C interface.  On first
use each source is compiled by its own ``nvcc -c`` (all started
together), the objects are linked into one shared library under
``build/repro_torch/`` at the repository root, and the library is loaded
with ``ctypes``.  The library's name carries a hash of the sources and
flags, so an edited source is rebuilt and an unchanged one is reused.

Flags: ``sm_90a`` (Hopper), ``-O3``, no fast math, and ``-fmad=false`` so
that no multiply-add is contracted into an FMA the plain PyTorch
versions do not perform.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

__all__ = ["load", "build", "library_path", "BUILD_DIR", "CSRC"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_LIB: ctypes.CDLL | None = None
# What the last build printed (ptxas register / shared-memory report);
# empty when the library was already built.
last_build_log = ""


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libharp_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile every source in parallel and link the shared library."""
    global last_build_log
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in _sources():
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs = []
        for src, _, proc in procs:
            out, _ = proc.communicate()
            logs.append(f"== {src.name}\n{out}")
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src.name}:\n{out}")
        tmp_so = Path(tmp) / so.name
        link = [nvcc, "-shared", *NVCC_FLAGS[:2],
                *[str(o) for _, o, _ in procs], "-o", str(tmp_so)]
        res = subprocess.run(link, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{res.stdout}{res.stderr}")
        os.replace(tmp_so, so)
    last_build_log = "\n".join(logs)
    return so


def _declare(lib: ctypes.CDLL) -> None:
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    lib.harp_fwht_f32.argtypes = [p, p, ll, i, p]
    lib.harp_fwht_f32.restype = i
    lib.harp_wv_step.argtypes = (
        [p] * 13 + [ll, i, f, i, i, i, f, f, f, f, f, i, p]
    )
    lib.harp_wv_step.restype = i
    lib.harp_acim_vmm_tiled.argtypes = [p] * 6 + [i] * 7 + [f] * 4 + [p]
    lib.harp_acim_vmm_tiled.restype = i


def load() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        _declare(lib)
        _LIB = lib
    return _LIB
