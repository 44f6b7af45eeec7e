"""ctypes bindings of the native scanlog and UART stream reader
(csrc/mqs_io.cpp, the port's copy of the JAX package's csrc/mqs_io.cpp;
counterpart of micro_quad_slam_tpu/io/native.py).

A host speed path, not a device kernel.  At first use the source is built
with g++ into build/native_io/ beside the package (build/ is listed in
.gitignore), under a name that carries a hash of the source and the
flags, and loaded with ctypes; nothing is built when the module is
imported.  Where no toolchain is found, or the build fails, every entry
point reads with the port's Python codecs (formats/scanlog.py,
formats/scanframe.py) instead, as the JAX package does; the results are
equal field for field (tests/test_torch_native_io.py).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from micro_quad_slam_tpu_torch.formats.scanframe import CTRL_BYTES, SCAN_BYTES
from micro_quad_slam_tpu_torch.formats.scanlog import ScanLog

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "mqs_io.cpp"
BUILD_DIR = SOURCE.parents[2] / "build" / "native_io"
# micro_quad_slam_tpu/io/native.py:64's flags
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False

_COLUMNS = (("host_ms", np.uint32), ("scan_ms", np.uint32),
            ("x_m", np.float32), ("y_m", np.float32), ("yaw_deg", np.float32),
            ("alt_m", np.float32), ("roll_rad", np.float32),
            ("pitch_rad", np.float32), ("rf_m", np.float32),
            ("of_rate_x", np.float32), ("of_rate_y", np.float32),
            ("of_q", np.uint8), ("state", np.uint8), ("kf_flags", np.uint8),
            ("sys_health", np.uint32))


class _ScanRecSoA(ctypes.Structure):
    """mqs_io.cpp's ScanRecSoA: one output column pointer per field."""
    _fields_ = [(name, ctypes.c_void_p) for name, _ in _COLUMNS] + [
        ("grid_mm", ctypes.c_void_p)]


def _library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"libmqs_io-{digest.hexdigest()[:16]}.so"


def _build_and_load() -> Optional[ctypes.CDLL]:
    """The loaded library, built first if needed; None where g++ is
    missing or the build fails (tried once per process)."""
    global _LIB, _TRIED
    with _LOCK:
        if _LIB is not None or _TRIED:
            return _LIB
        _TRIED = True
        gxx = shutil.which("g++")
        so = _library_path()
        try:
            if not so.exists():
                if gxx is None:
                    return None
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = so.with_suffix(f".{os.getpid()}.tmp")
                subprocess.run([gxx, *GXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                               check=True, capture_output=True, timeout=120)
                os.replace(tmp, so)
            lib = ctypes.CDLL(str(so))
        except (OSError, subprocess.SubprocessError):
            return None
        lib.mqs_scanlog_count.restype = ctypes.c_longlong
        lib.mqs_scanlog_count.argtypes = [ctypes.c_char_p, ctypes.c_longlong]
        lib.mqs_scanlog_decode.restype = ctypes.c_longlong
        lib.mqs_scanlog_decode.argtypes = [
            ctypes.c_char_p, ctypes.c_longlong, ctypes.POINTER(_ScanRecSoA)]
        lib.mqs_stream_decode.restype = ctypes.c_longlong
        lib.mqs_stream_decode.argtypes = [
            ctypes.c_char_p, ctypes.c_longlong,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
            ctypes.POINTER(ctypes.c_longlong)]
        _LIB = lib
        return _LIB


def native_available() -> bool:
    """True when the native library is built and loaded."""
    return _build_and_load() is not None


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def read_scanlog_native(src) -> ScanLog:
    """A scanlog (file path or bytes) -> the port's ScanLog, decoded
    natively.  Lenient, as read_scanlog(strict=False): records with a bad
    magic are skipped and a trailing partial record is dropped.  Reads
    with the Python codec where the library is not available."""
    if isinstance(src, (str, os.PathLike)):
        with open(src, "rb") as f:
            data = f.read()
    else:
        data = bytes(src)
    lib = _build_and_load()
    if lib is None:
        from micro_quad_slam_tpu_torch.formats.scanlog import read_scanlog
        return read_scanlog(data, strict=False)
    n = lib.mqs_scanlog_count(data, len(data))
    cols = {name: np.empty(n, dt) for name, dt in _COLUMNS}
    grid = np.empty((n, 256), np.uint16)
    soa = _ScanRecSoA(**{k: _ptr(v) for k, v in cols.items()},
                      grid_mm=_ptr(grid))
    got = lib.mqs_scanlog_decode(data, len(data), ctypes.byref(soa))
    if got != n:
        raise RuntimeError(f"native scanlog decode returned {got} of {n} "
                           f"records")
    return ScanLog(grid_mm=grid.reshape(n, 4, 8, 8), **cols)


def decode_stream_native(data) -> Tuple[np.ndarray, np.ndarray, list]:
    """A raw hub UART stream -> (t_ms [S], grid_mm [S, 4, 8, 8], ctrls
    [(cmd, seq)]), decoded natively with formats/scanframe.py's accept
    and reject rules; decode_stream_arrays where the library is not
    available."""
    data = bytes(data)
    lib = _build_and_load()
    if lib is None:
        from micro_quad_slam_tpu_torch.formats.scanframe import (
            decode_stream_arrays)
        return decode_stream_arrays(data)
    max_s = len(data) // SCAN_BYTES + 1
    max_c = len(data) // CTRL_BYTES + 1
    t_ms = np.empty(max_s, np.uint32)
    grids = np.empty((max_s, 256), np.uint16)
    cmd = np.empty(max_c, np.uint8)
    seq = np.empty(max_c, np.uint32)
    ncs = ctypes.c_longlong(0)
    ns = lib.mqs_stream_decode(data, len(data), _ptr(t_ms), _ptr(grids),
                               max_s, _ptr(cmd), _ptr(seq), max_c,
                               ctypes.byref(ncs))
    ctrls = [(int(cmd[i]), int(seq[i])) for i in range(ncs.value)]
    return t_ms[:ns].copy(), grids[:ns].reshape(ns, 4, 8, 8).copy(), ctrls
