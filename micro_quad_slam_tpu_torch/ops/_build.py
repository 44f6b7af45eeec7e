"""Build and load the port's CUDA kernels.

Each kernel is one CUDA C++ file under csrc/ with a plain C interface.  At
first use it is compiled with nvcc for sm_90a (Hopper) into
build/torch_kernels/ beside the package; build/ is listed in .gitignore,
so the shared libraries are never committed and every fresh checkout
builds its own.  The file name carries a hash of the source and the
flags, so an edited source is rebuilt.  The library is loaded with ctypes.
Nothing is built or loaded when a module is imported: the CPU path needs
no nvcc and no CUDA.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = CSRC.parents[1] / "build" / "torch_kernels"
# fma contraction stays at nvcc's default and --use_fast_math is never
# passed: the kernels do integer work only, and the float path (ray trig,
# origins, the EMA) stays in torch ops.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_libs: dict = {}      # kernel name -> loaded ctypes.CDLL
builds: dict = {}     # kernel name -> {"path", "seconds", "log"}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME): the "
                           "port's CUDA kernels are built with nvcc")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def build(name: str) -> dict:
    """Compile csrc/<name>.cu into a shared library unless an identical
    build exists.  Returns {"path", "seconds", "log"}: seconds is 0.0 and
    log empty when the library was already built."""
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    out = BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"
    if out.exists():
        return builds.setdefault(name, {"path": out, "seconds": 0.0, "log": ""})
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                          capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src} (exit {proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    builds[name] = {"path": out, "seconds": seconds,
                    "log": proc.stdout + proc.stderr}
    return builds[name]


def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load csrc/<name>.cu; cached per process."""
    if name not in _libs:
        _libs[name] = ctypes.CDLL(str(build(name)["path"]))
    return _libs[name]
