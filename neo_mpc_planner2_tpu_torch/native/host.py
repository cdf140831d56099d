"""ctypes bindings for the native host front-end (port of `native/host.py`).

The C++ library (`native/src/neo_mpc_host.cpp`, the port's own copy of the
JAX package's source) re-implements the reference plugin's per-tick
geometry (src/NeoMpcPlanner.cpp:66-246) for the single-robot deployment
path; this wrapper marshals numpy arrays across the C ABI. The library is
built at first use with g++ into `build/native/`, under a file name that
carries a hash of the sources and flags, so an edited source rebuilds and
an unchanged one is loaded as built. A missing compiler or a failed build
raises; nothing falls back to Python geometry.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np

__all__ = ["NativeHost", "HostRequest", "NMP_OK", "NMP_ERR_EMPTY_PLAN",
           "NMP_ERR_NO_WINDOW", "NMP_ERR_LETHAL", "NMP_ERR_BAD_ARG",
           "SRC", "BUILD_DIR", "CXX_FLAGS", "library_path", "build_library"]

NMP_OK = 0
NMP_ERR_EMPTY_PLAN = 1
NMP_ERR_NO_WINDOW = 2
NMP_ERR_LETHAL = 3
NMP_ERR_BAD_ARG = 4

SRC = Path(__file__).resolve().parent / "src"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ("-std=c++17", "-O3", "-shared", "-fPIC")
SOURCES = ("neo_mpc_host.cpp",)
HEADERS = ("neo_mpc_host.h",)


class _Pose(ctypes.Structure):
    _fields_ = [("x", ctypes.c_double), ("y", ctypes.c_double),
                ("yaw", ctypes.c_double)]


class _Params(ctypes.Structure):
    _fields_ = [("lookahead_dist_min", ctypes.c_double),
                ("lookahead_dist_max", ctypes.c_double),
                ("lookahead_dist_close_to_goal", ctypes.c_double),
                ("controller_frequency", ctypes.c_double)]


class _Costmap(ctypes.Structure):
    _fields_ = [("data", ctypes.POINTER(ctypes.c_float)),
                ("width", ctypes.c_int32), ("height", ctypes.c_int32),
                ("origin_x", ctypes.c_double), ("origin_y", ctypes.c_double),
                ("resolution", ctypes.c_double)]


class _Request(ctypes.Structure):
    _fields_ = [("current_pose", _Pose), ("carrot_pose", _Pose),
                ("goal_pose", _Pose), ("vel", ctypes.c_double * 3),
                ("switch_opt", ctypes.c_int32),
                ("control_interval", ctypes.c_double),
                ("slow_down", ctypes.c_int32),
                ("footprint_cost", ctypes.c_double),
                ("lookahead_dist", ctypes.c_double),
                ("window_begin", ctypes.c_int32),
                ("window_end", ctypes.c_int32)]


class HostRequest:
    """Python view of the marshalled Optimizer request (cpp:240-246 fields)."""

    def __init__(self, r: _Request):
        self.current_pose = np.array([r.current_pose.x, r.current_pose.y,
                                      r.current_pose.yaw])
        self.carrot_pose = np.array([r.carrot_pose.x, r.carrot_pose.y,
                                     r.carrot_pose.yaw])
        self.goal_pose = np.array([r.goal_pose.x, r.goal_pose.y, r.goal_pose.yaw])
        self.current_vel = np.array(list(r.vel))
        self.switch_opt = bool(r.switch_opt)
        self.control_interval = float(r.control_interval)
        self.slow_down = bool(r.slow_down)
        self.footprint_cost = float(r.footprint_cost)
        self.lookahead_dist = float(r.lookahead_dist)
        # Transformed-plan window [begin, end) plan indices — the
        # received_global_plan debug path (NeoMpcPlanner.cpp:119-128).
        self.window_begin = int(r.window_begin)
        self.window_end = int(r.window_end)


def library_path(src: Path | None = None,
                 build_dir: Path | None = None) -> Path:
    """Where the library built from `src` with CXX_FLAGS lives."""
    src = SRC if src is None else Path(src)
    build_dir = BUILD_DIR if build_dir is None else Path(build_dir)
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((src / name).read_bytes())
    return build_dir / f"libneo_mpc_host_{h.hexdigest()[:16]}.so"


def build_library(src: Path | None = None,
                  build_dir: Path | None = None) -> Path:
    """Compile the host library with g++ unless a library built from the
    same sources and flags exists. The library is written to a temporary
    name and moved into place, so processes building at once each find a
    whole file. Raises RuntimeError without g++ or when the build fails."""
    src = SRC if src is None else Path(src)
    build_dir = BUILD_DIR if build_dir is None else Path(build_dir)
    out = library_path(src, build_dir)
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found on PATH: the native host library "
                           "builds from its C++ source at first use")
    build_dir.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        lib = os.path.join(tmp, out.name)
        proc = subprocess.run(
            [cxx, *CXX_FLAGS, "-o", lib, *(str(src / s) for s in SOURCES)],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed ({proc.returncode}) on "
                               f"{src / SOURCES[0]}:\n{proc.stdout}"
                               f"{proc.stderr}")
        os.replace(lib, out)
    return out


_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build_library()))
        lib.nmp_host_create.restype = ctypes.c_void_p
        lib.nmp_host_create.argtypes = [ctypes.POINTER(_Params)]
        lib.nmp_host_destroy.argtypes = [ctypes.c_void_p]
        lib.nmp_host_set_params.argtypes = [ctypes.c_void_p, ctypes.POINTER(_Params)]
        lib.nmp_host_set_plan.restype = ctypes.c_int32
        lib.nmp_host_set_plan.argtypes = [ctypes.c_void_p, ctypes.POINTER(_Pose),
                                          ctypes.c_int32]
        lib.nmp_host_tick.restype = ctypes.c_int32
        lib.nmp_host_tick.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(_Pose),
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(_Costmap),
            ctypes.POINTER(ctypes.c_double), ctypes.c_int32,
            ctypes.POINTER(_Request)]
        lib.nmp_footprint_cost.restype = ctypes.c_double
        lib.nmp_footprint_cost.argtypes = [
            ctypes.POINTER(_Costmap), ctypes.POINTER(ctypes.c_double),
            ctypes.c_int32, ctypes.POINTER(_Pose)]
        _lib = lib
    return _lib


class NativeHost:
    """Single-robot host state machine (the NeoMpcPlanner plugin equivalent).
    Constructing one builds the library if needed."""

    @staticmethod
    def available() -> bool:
        """Whether a NativeHost can be made here: the library is built
        from the port's sources, or g++ is on PATH to build it at first
        use (the check _load makes before it raises)."""
        return library_path().exists() or shutil.which("g++") is not None

    def __init__(self, lookahead_dist_min=0.5, lookahead_dist_max=0.5,
                 lookahead_dist_close_to_goal=0.5, controller_frequency=30.0):
        lib = _load()
        self._lib = lib
        self._params = _Params(lookahead_dist_min, lookahead_dist_max,
                               lookahead_dist_close_to_goal, controller_frequency)
        self._h = lib.nmp_host_create(ctypes.byref(self._params))

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.nmp_host_destroy(self._h)
            self._h = None

    def set_params(self, **kw):
        for k, v in kw.items():
            setattr(self._params, k, float(v))
        self._lib.nmp_host_set_params(self._h, ctypes.byref(self._params))

    def set_plan(self, poses: np.ndarray) -> int:
        poses = np.ascontiguousarray(poses, dtype=np.float64)
        n = len(poses)
        arr = (_Pose * n)(*[_Pose(*p) for p in poses])
        return self._lib.nmp_host_set_plan(self._h, arr, n)

    def tick(self, robot_pose, speed, costmap_data: np.ndarray, origin,
             resolution, footprint: np.ndarray):
        """Returns (status, HostRequest)."""
        cm_data = np.ascontiguousarray(costmap_data, dtype=np.float32)
        h, w = cm_data.shape
        cm = _Costmap(cm_data.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                      w, h, float(origin[0]), float(origin[1]), float(resolution))
        pose = _Pose(*[float(v) for v in robot_pose])
        sp = (ctypes.c_double * 3)(*[float(v) for v in speed])
        fp = np.ascontiguousarray(footprint, dtype=np.float64)
        fpp = fp.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
        req = _Request()
        status = self._lib.nmp_host_tick(self._h, ctypes.byref(pose), sp,
                                         ctypes.byref(cm), fpp, len(fp),
                                         ctypes.byref(req))
        return status, HostRequest(req)

    def footprint_cost(self, costmap_data, origin, resolution, footprint,
                       pose) -> float:
        cm_data = np.ascontiguousarray(costmap_data, dtype=np.float32)
        h, w = cm_data.shape
        cm = _Costmap(cm_data.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                      w, h, float(origin[0]), float(origin[1]), float(resolution))
        fp = np.ascontiguousarray(footprint, dtype=np.float64)
        p = _Pose(*[float(v) for v in pose])
        return self._lib.nmp_footprint_cost(
            ctypes.byref(cm), fp.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            len(fp), ctypes.byref(p))
