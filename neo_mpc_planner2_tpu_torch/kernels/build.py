"""Build the CUDA kernels at first use and bind their C interface with ctypes.

`nvcc` compiles every source under `csrc/` into one shared library with a
plain C interface (no PyTorch headers, so a build takes seconds). The
library's file name carries a hash of the sources and flags, so an edited
source rebuilds and an unchanged one is loaded from `build/kernels/`.
A missing compiler or a failed build raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

__all__ = ["CSRC", "BUILD_DIR", "CUDA_HOME", "NVCC_FLAGS", "find_nvcc",
           "library_path", "build_library", "load_library", "last_build"]

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
CUDA_HOME = os.environ.get("CUDA_HOME", "/usr/local/cuda")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
SOURCES = ("qp_admm.cu", "spd_inv.cu")
HEADERS = ("spd_inverse.cuh",)

# What the last build_library call did: {"path", "built", "seconds", "log"}.
last_build: dict = {}
_lib = None


def find_nvcc() -> str:
    """nvcc from PATH, else from the CUDA toolkit at CUDA_HOME."""
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(CUDA_HOME) / "bin" / "nvcc"
    if cand.is_file() and os.access(cand, os.X_OK):
        return str(cand)
    raise RuntimeError(
        "nvcc not found on PATH nor at "
        f"{cand}: the CUDA kernels need the CUDA toolkit to build")


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libneo_mpc_kernels_{_source_hash()}.so"


def build_library() -> Path:
    """Compile the kernels unless a library built from the same sources and
    flags exists. Raises RuntimeError with the compiler's output on failure."""
    out = library_path()
    t0 = time.perf_counter()
    if out.exists():
        last_build.update(path=str(out), built=False, seconds=0.0,
                          log=_read_log(out))
        return out
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, *(str(CSRC / s) for s in SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
    os.replace(tmp, out)
    out.with_suffix(".log").write_text(log)
    last_build.update(path=str(out), built=True,
                      seconds=time.perf_counter() - t0, log=log)
    return out


def _read_log(lib: Path) -> str:
    p = lib.with_suffix(".log")
    return p.read_text() if p.exists() else ""


def load_library() -> ctypes.CDLL:
    """Build if needed, load once per process, declare the C signatures."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build_library()))
        vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.neo_qp_admm_f32.argtypes = [i, i, i, f, f, f, vp, vp, vp]
        lib.neo_qp_admm_f32.restype = i
        lib.neo_spd_inv_f32.argtypes = [i, i, vp, vp, vp]
        lib.neo_spd_inv_f32.restype = i
        _lib = lib
    return _lib
