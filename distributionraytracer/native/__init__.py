"""ctypes bindings for the native (C++) runtime components.

Builds ``native/libdrt_native.so`` on first use with ``make`` (g++ -O3) and
caches the handle.  Callers fall back to the NumPy implementations when the
toolchain is unavailable — check :func:`available`.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_NATIVE_DIR = os.path.join(_REPO, "native")
_SO = os.path.join(_NATIVE_DIR, "libdrt_native.so")

_lock = threading.Lock()
_lib = None
_tried = False


def _build():
    """Build the library from ``drt_native.cpp`` if it is missing or older
    than its source.  An exclusive file lock serializes concurrent builders
    (several test workers at once), and the library is written to a
    temporary name and renamed, so no process loads a half-written file."""
    src = os.path.join(_NATIVE_DIR, "drt_native.cpp")
    stale = lambda: (not os.path.exists(_SO)
                     or os.path.getmtime(_SO) < os.path.getmtime(src))
    if not stale():
        return
    with open(os.path.join(_NATIVE_DIR, ".build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if stale():
            tmp = f"{os.path.basename(_SO)}.{os.getpid()}.tmp"
            try:
                subprocess.run(["make", "-C", _NATIVE_DIR, f"TARGET={tmp}"],
                               check=True, capture_output=True)
                os.replace(os.path.join(_NATIVE_DIR, tmp), _SO)
            finally:
                if os.path.exists(os.path.join(_NATIVE_DIR, tmp)):
                    os.remove(os.path.join(_NATIVE_DIR, tmp))


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            _build()
            lib = ctypes.CDLL(_SO)
        except (OSError, subprocess.CalledProcessError):
            return None

        i64 = ctypes.c_int64
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")

        lib.drt_build_bvh.restype = i64
        lib.drt_build_bvh.argtypes = [i64, f32p, f32p, f32p, f32p, u8p,
                                      i32p, i32p, i32p]
        lib.drt_grid_insert.restype = i64
        lib.drt_grid_insert.argtypes = [
            i64, f32p, f32p, f64p, f64p,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_void_p, ctypes.c_void_p]
        lib.drt_chebyshev_dist.restype = None
        lib.drt_chebyshev_dist.argtypes = [
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, u8p, i32p,
            ctypes.c_int32]
        lib.drt_parse_floats.restype = i64
        lib.drt_parse_floats.argtypes = [
            ctypes.c_char_p, i64, ctypes.POINTER(i64), f64p, i64]
        lib.drt_traverse_closest.restype = None
        lib.drt_traverse_closest.argtypes = [
            i64, f32p, f32p, u8p, i32p, i32p, i32p, f32p, i32p,
            i64, f32p, f32p, f32p, ctypes.c_int32, ctypes.c_int32,
            f32p, i32p]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def build_bvh_native(bmin: np.ndarray, bmax: np.ndarray):
    """SAH BVH build; returns (node_min, node_max, leaf, index, nobjs, order)
    or None when the native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    n = len(bmin)
    cap = max(2 * n, 1)
    node_min = np.empty((cap, 3), np.float32)
    node_max = np.empty((cap, 3), np.float32)
    leaf = np.empty(cap, np.uint8)
    index = np.empty(cap, np.int32)
    nobjs = np.empty(cap, np.int32)
    order = np.empty(max(n, 1), np.int32)
    nn = lib.drt_build_bvh(
        n, np.ascontiguousarray(bmin, np.float32).reshape(-1, 3),
        np.ascontiguousarray(bmax, np.float32).reshape(-1, 3),
        node_min.reshape(-1), node_max.reshape(-1), leaf, index, nobjs,
        order)
    return (node_min[:nn], node_max[:nn], leaf[:nn].astype(bool),
            index[:nn], nobjs[:nn], order[:n])


def grid_insert_native(bmin, bmax, gmin, gmax, nx, ny, nz):
    """Grid cell insertion; returns (cell_ids, obj_ids) or None."""
    lib = _load()
    if lib is None:
        return None
    n = len(bmin)
    bmin = np.ascontiguousarray(bmin, np.float32).reshape(-1, 3)
    bmax = np.ascontiguousarray(bmax, np.float32).reshape(-1, 3)
    gmin = np.ascontiguousarray(gmin, np.float64)
    gmax = np.ascontiguousarray(gmax, np.float64)
    total = lib.drt_grid_insert(n, bmin, bmax, gmin, gmax, nx, ny, nz,
                                None, None)
    cells = np.empty(total, np.int64)
    objs = np.empty(total, np.int32)
    lib.drt_grid_insert(n, bmin, bmax, gmin, gmax, nx, ny, nz,
                        cells.ctypes.data, objs.ctypes.data)
    return cells, objs


def chebyshev_dist_native(occupied: np.ndarray, nx: int, ny: int, nz: int,
                          cap: int = 127):
    """Chessboard distance-to-occupied over the (flat, x-fastest) cell grid.

    Returns int32[nx*ny*nz] or None when the native library is unavailable.
    """
    lib = _load()
    if lib is None:
        return None
    occ = np.ascontiguousarray(occupied.reshape(-1), np.uint8)
    dist = np.empty(occ.size, np.int32)
    lib.drt_chebyshev_dist(nx, ny, nz, occ, dist, cap)
    return dist


def parse_floats_native(text: bytes, pos: int, count: int):
    """Parse `count` floats from text starting at pos.

    Returns (values float64[count], new_pos) or None if unavailable.
    """
    lib = _load()
    if lib is None:
        return None
    out = np.empty(count, np.float64)
    p = ctypes.c_int64(pos)
    got = lib.drt_parse_floats(text, len(text), ctypes.byref(p), out, count)
    if got != count:
        raise ValueError(f"expected {count} floats, got {got}")
    return out, p.value


def traverse_closest_native(nodes, order, obj12, obj_types, o, d,
                            time=None, motion: bool = False,
                            n_threads: int = 0):
    """Reference-semantics CPU closest-hit over flat BVH tables
    (bvh.cpp:231-311 under the OpenMP pixel loop, main.cpp:603) — an
    independent reference for the device traversals' primary winners.  ``nodes`` = (node_min, node_max, leaf, index, nobjs)
    from build_bvh_native.  Returns (t, obj_id) or None if unavailable.
    """
    lib = _load()
    if lib is None:
        return None
    node_min, node_max, leaf, index, nobjs = nodes
    n_rays = len(o)
    if n_threads <= 0:
        n_threads = os.cpu_count() or 1
    t_out = np.empty(n_rays, np.float32)
    id_out = np.empty(n_rays, np.int32)
    tm = (np.zeros(n_rays, np.float32) if time is None
          else np.ascontiguousarray(time, np.float32))
    lib.drt_traverse_closest(
        len(leaf), np.ascontiguousarray(node_min, np.float32),
        np.ascontiguousarray(node_max, np.float32),
        np.ascontiguousarray(leaf, np.uint8),
        np.ascontiguousarray(index, np.int32),
        np.ascontiguousarray(nobjs, np.int32),
        np.ascontiguousarray(order, np.int32),
        np.ascontiguousarray(obj12, np.float32),
        np.ascontiguousarray(obj_types, np.int32),
        n_rays, np.ascontiguousarray(o, np.float32),
        np.ascontiguousarray(d, np.float32), tm,
        1 if motion else 0, n_threads, t_out, id_out)
    return t_out, id_out
