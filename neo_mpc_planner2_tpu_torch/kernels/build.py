"""Build the CUDA kernels at first use and bind their C interface with ctypes.

`nvcc` compiles each source under `csrc/` to an object, all sources at once
in parallel processes, and links the objects into one shared library with a
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

__all__ = ["CSRC", "BUILD_DIR", "CUDA_HOME", "NVCC_FLAGS", "SIGNATURES",
           "find_nvcc", "library_path", "build_library", "load_library",
           "last_build"]

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
CUDA_HOME = os.environ.get("CUDA_HOME", "/usr/local/cuda")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")
SOURCES = ("qp_admm.cu", "spd_inv.cu", "footprint_cost.cu",
           "parity_line_search.cu")
HEADERS = ("spd_inverse.cuh",)

_vp, _i, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# The C interface of the library: name -> (restype, argtypes), in the order
# of the `extern "C"` declarations in csrc/.
SIGNATURES = {
    # m, B, warps_per_lane, iters, rho, sigma, sigma + rho; 12 operands,
    # 7 outputs; stream.
    "neo_qp_admm_f32": (_i, [_i] * 4 + [_f] * 3 + [_vp] * 20),
    # m, B, warps_per_block, matrices_per_block; A, X; stream.
    "neo_spd_inv_f32": (_i, [_i] * 4 + [_vp] * 3),
    # Bm, R, H, W, V, S, lanes_per_block, warps_per_lane, chunk; 9 arrays;
    # stream.
    "neo_footprint_cost_f32": (_i, [_i] * 9 + [_vp] * 10),
    # Bm, R, H, W, V, threads; 8 arrays; stream.
    "neo_footprint_walk_f32": (_i, [_i] * 6 + [_vp] * 9),
    # B, n, sum_width, quirks, max_backtracks, quad_interp, coarse_after, H,
    # W, map_lanes; dt, backtrack, coarse; 12 arrays, 3 outputs; stream.
    "neo_parity_line_search_f32": (_i, [_i] * 10 + [_f] * 3 + [_vp] * 16),
}

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


def _source_hash(csrc: Path, sources, headers) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in tuple(sources) + tuple(headers):
        h.update(name.encode())
        h.update((csrc / name).read_bytes())
    return h.hexdigest()[:16]


def library_path(csrc: Path | None = None, build_dir: Path | None = None,
                 sources=SOURCES, headers=HEADERS) -> Path:
    csrc = CSRC if csrc is None else Path(csrc)
    build_dir = BUILD_DIR if build_dir is None else Path(build_dir)
    return (build_dir
            / f"libneo_mpc_kernels_{_source_hash(csrc, sources, headers)}.so")


def build_library(csrc: Path | None = None, build_dir: Path | None = None,
                  sources=SOURCES, headers=HEADERS) -> Path:
    """Compile `sources` under `csrc` (default: the package's kernels) into
    one library under `build_dir`, unless a library built from the same
    sources and flags exists. Raises RuntimeError with the compiler's
    output on failure."""
    csrc = CSRC if csrc is None else Path(csrc)
    build_dir = BUILD_DIR if build_dir is None else Path(build_dir)
    out = library_path(csrc, build_dir, sources, headers)
    t0 = time.perf_counter()
    if out.exists():
        last_build.update(path=str(out), built=False, seconds=0.0,
                          log=_read_log(out))
        return out
    nvcc = find_nvcc()
    build_dir.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        objs = [os.path.join(tmp, s + ".o") for s in sources]
        procs = [subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(csrc / s), "-o", o],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for s, o in zip(sources, objs)]
        logs = [p.communicate()[0] for p in procs]
        log = "".join(logs)
        failed = [s for s, p in zip(sources, procs) if p.returncode != 0]
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
        lib = os.path.join(tmp, "lib.so")
        proc = subprocess.run([nvcc, "-shared", "-o", lib, *objs],
                              capture_output=True, text=True)
        log += proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{log}")
        os.replace(lib, out)
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
        for name, (restype, argtypes) in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.restype, fn.argtypes = restype, argtypes
        _lib = lib
    return _lib
