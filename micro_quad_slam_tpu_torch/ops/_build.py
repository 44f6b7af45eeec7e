"""Build and load the port's CUDA kernels.

Each kernel is one CUDA C++ file under csrc/ with a plain C interface.  At
first use it is compiled with nvcc for sm_90a (Hopper) into
build/torch_kernels/ beside the package; build/ is listed in .gitignore,
so the shared libraries are never committed and every fresh checkout
builds its own.  The file name carries a hash of the source, of every
shared header in csrc/ (*.cuh) and of the flags, so an edited source or
header is rebuilt.  `build_all` starts one nvcc per source at once.  The
library is loaded with ctypes.  Nothing is built or loaded when a module
is imported: the CPU path needs no nvcc and no CUDA.
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
# -fmad=false: no float multiply and add is contracted into an fma, and
# --use_fast_math is never passed.  replay_cone.cu classifies cells with
# float products and sums that must round on their own, as the plain
# torch version's do (a 1-ulp difference flips cells on a fan boundary,
# ops/conemode.py); it also spells each rounding out with __fmul_rn /
# __fadd_rn.  The carry kernel (carry.cuh, in both replay libraries) does
# the same for the ToF filter and the origins.  replay_exact.cu's own
# kernels do integer work only.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas=-v")

_libs: dict = {}      # kernel name -> loaded ctypes.CDLL
builds: dict = {}     # kernel name -> {"path", "seconds", "log"}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME): the "
                           "port's CUDA kernels are built with nvcc")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def _target(name: str):
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.name.encode() + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return src, BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build_all(names) -> dict:
    """Compile csrc/<name>.cu for each name into a shared library unless an
    identical build exists (the library and nvcc's output of its build,
    kept beside it), one nvcc process per source, all started together.
    Returns {name: {"path", "seconds", "log"}}: seconds is 0.0 for a
    library that was already built."""
    procs = {}
    for name in names:
        src, out = _target(name)
        log = out.with_suffix(".log")
        if out.exists() and log.exists():
            builds.setdefault(name, {"path": out, "seconds": 0.0,
                                     "log": log.read_text()})
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (src, out, tmp, time.perf_counter(), subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    failed = []
    for name, (src, out, tmp, t0, proc) in procs.items():
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {src} (exit {proc.returncode}):\n"
                          f"{stdout}{stderr}")
            continue
        os.replace(tmp, out)
        out.with_suffix(".log").write_text(stdout + stderr)
        builds[name] = {"path": out, "seconds": time.perf_counter() - t0,
                        "log": stdout + stderr}
    if failed:
        raise RuntimeError("\n".join(failed))
    return {name: builds[name] for name in names}


def build(name: str) -> dict:
    """build_all for one source."""
    return build_all([name])[name]


def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load csrc/<name>.cu; cached per process."""
    if name not in _libs:
        _libs[name] = ctypes.CDLL(str(build(name)["path"]))
    return _libs[name]
