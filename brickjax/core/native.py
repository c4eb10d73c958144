"""ctypes bindings for the native layout-planner core (csrc/).

Auto-builds ``libbrickplanner.so`` with the system g++ on first use and
falls back to the pure-numpy implementations when no toolchain is
available.  Semantics are identical (golden-tested in
tests/test_native.py).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_lock = threading.Lock()
_lib = None
_tried = False


def _root() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def load_library():
    """Return the loaded library, building it if needed, else None."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        # installed wheels carry the prebuilt lib in brickjax/_native
        # (setup.py build hook); source trees build csrc/ on demand
        pkg_so = os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "_native", "libbrickplanner.so")
        csrc = os.path.join(_root(), "csrc")
        so = pkg_so if os.path.exists(pkg_so) else os.path.join(
            csrc, "libbrickplanner.so")
        if not os.path.exists(so):
            try:
                subprocess.run(["make", "-C", csrc], check=True,
                               capture_output=True, timeout=120)
            except Exception:
                return None
        try:
            lib = ctypes.CDLL(so)
        except OSError:
            return None
        lib.adjacency_from_grid.argtypes = [
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int32, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32)]
        lib.check_involution.restype = ctypes.c_int64
        lib.check_involution.argtypes = [
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64]
        lib.zmort_ids.argtypes = [
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int64)]
        copy_sig = [
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64]
        lib.copy_to_bricks_f32.argtypes = copy_sig
        lib.copy_from_bricks_f32.argtypes = copy_sig
        _lib = lib
        return _lib


def _copy_ok(arr, grid, bdims, dat, offset) -> bool:
    """Validate what the C side cannot: shape agreement and bounds
    (the numpy fallback would raise cleanly; a foreign call would
    corrupt memory)."""
    if dat.ndim != 2 or arr.ndim != len(bdims) or grid.ndim != len(bdims):
        return False
    if len(bdims) > 8:          # C side indexes fixed int64_t [8] arrays
        return False
    if arr.shape != tuple(g * b for g, b in zip(grid.shape, bdims)):
        return False
    belems = int(np.prod(bdims))
    if offset < 0 or offset + belems > dat.shape[1]:
        return False
    if grid.size and (int(grid.max()) >= dat.shape[0]
                      or int(grid.min()) < 0):
        return False
    return True


def _copy_args(arr, grid, bdims, dat, offset):
    import ctypes as ct

    gshape = np.asarray(grid.shape, dtype=np.int64)
    bd = np.asarray(bdims, dtype=np.int64)
    return (arr.ctypes.data_as(ct.POINTER(ct.c_float)),
            grid.ctypes.data_as(ct.POINTER(ct.c_int32)),
            gshape.ctypes.data_as(ct.POINTER(ct.c_int64)),
            bd.ctypes.data_as(ct.POINTER(ct.c_int64)),
            len(bdims),
            dat.ctypes.data_as(ct.POINTER(ct.c_float)),
            dat.shape[1], offset, dat.shape[0]), (gshape, bd)


def copy_to_bricks_f32(arr, grid, bdims, dat, offset=0) -> bool:
    """Native copyToBrick (bricksetup.h:103-181); returns False when the
    native path is unavailable or the inputs don't qualify."""
    lib = load_library()
    if lib is None:
        return False
    if not (arr.dtype == np.float32 and dat.dtype == np.float32
            and arr.flags.c_contiguous and dat.flags.c_contiguous):
        return False
    grid = np.ascontiguousarray(grid, dtype=np.int32)
    if not _copy_ok(arr, grid, bdims, dat, offset):
        return False
    # `keep` holds the shape arrays the arg pointers alias — it must
    # stay alive across the foreign call
    args, keep = _copy_args(arr, grid, bdims, dat, offset)
    lib.copy_to_bricks_f32(*args)
    del keep
    return True


def copy_from_bricks_f32(arr, grid, bdims, dat, offset=0) -> bool:
    """Native copyFromBrick (bricksetup.h:183-221)."""
    lib = load_library()
    if lib is None:
        return False
    if not (arr.dtype == np.float32 and dat.dtype == np.float32
            and arr.flags.c_contiguous and dat.flags.c_contiguous):
        return False
    grid = np.ascontiguousarray(grid, dtype=np.int32)
    if not _copy_ok(arr, grid, bdims, dat, offset):
        return False
    args, keep = _copy_args(arr, grid, bdims, dat, offset)
    lib.copy_from_bricks_f32(*args)
    del keep
    return True


def _i32p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _i64p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def adjacency_from_grid_native(grid: np.ndarray,
                               nbricks: int | None = None):
    """Native adjacency builder; returns None if the library is
    unavailable (callers fall back to the numpy path)."""
    lib = load_library()
    if lib is None:
        return None
    grid = np.ascontiguousarray(grid, dtype=np.int32)
    if nbricks is None:
        nbricks = int(grid.max()) + 1
    dims = grid.ndim
    adj = np.zeros((nbricks, 3 ** dims), dtype=np.int32)
    gshape = np.asarray(grid.shape, dtype=np.int64)
    lib.adjacency_from_grid(_i32p(grid), _i64p(gshape), dims,
                            nbricks, _i32p(adj))
    return adj


def check_involution_native(adj: np.ndarray, bricks: np.ndarray):
    lib = load_library()
    if lib is None:
        return None
    adj = np.ascontiguousarray(adj, dtype=np.int32)
    bricks = np.ascontiguousarray(bricks.ravel(), dtype=np.int32)
    bad = lib.check_involution(_i32p(adj), adj.shape[1], _i32p(bricks),
                               len(bricks))
    return int(bad) == 0


def zmort_ids_native(shape):
    lib = load_library()
    if lib is None:
        return None
    shape = np.asarray(shape, dtype=np.int64)
    out = np.zeros(int(np.prod(shape)), dtype=np.int64)
    lib.zmort_ids(_i64p(shape), len(shape), _i64p(out))
    return out.reshape(tuple(shape))
