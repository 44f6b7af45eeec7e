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

`ENTRIES` is the one seam between Python and the kernels: every C entry
the port calls, the libraries that export it, and its argument and return
types, set once when a library is loaded (tests/test_torch_seam.py holds
the table to the `extern "C"` prototypes in csrc/).  `launch` calls a
kernel entry on a device's current stream and counts it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time
from pathlib import Path
from typing import NamedTuple

import torch

from micro_quad_slam_tpu_torch.utils import obs

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = CSRC.parents[1] / "build" / "torch_kernels"
# -fmad=false: no float multiply and add is contracted into an fma, and
# --use_fast_math is never passed.  replay_cone.cu classifies cells with
# float products and sums that must round on their own, as the plain
# torch version's do (a 1-ulp difference flips cells on a fan boundary,
# ops/conemode.py); it also spells each rounding out with __fmul_rn /
# __fadd_rn.  The carry kernel (carry.cuh, in both replay libraries) does
# the same for the ToF filter and the origins, the EKF replay (ekf.cuh)
# and the flight state machines (behavior.cuh, behavior_cl.cuh) for all of
# their float work.
# replay_exact.cu's own kernels do integer work only.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas=-v")

_libs: dict = {}      # kernel name -> loaded ctypes.CDLL
builds: dict = {}     # kernel name -> {"path", "seconds", "log"}


class Entry(NamedTuple):
    """One C entry of the kernel libraries: the libraries (csrc/<name>.cu)
    that export it, its argument types in order, its return type."""

    libraries: tuple
    argtypes: tuple
    restype: type = ctypes.c_int


_P, _I, _F, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_double
_FLOATS, _INTS = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int)
_PTRS, _BLOCKS = ctypes.POINTER(ctypes.c_void_p), _INTS
# The launches take the stream last; each returns a CUDA error code (-1:
# the entry refuses its operands).  The *_blocks_per_sm queries write the
# occupancy calculator's blocks per SM through their last argument.  The
# carry (csrc/carry.cuh) is compiled into both replay libraries, so that a
# mapping replay builds one library; the EKF replay (csrc/ekf.cuh) and the
# flight state machines (csrc/behavior.cuh, csrc/behavior_cl.cuh) into
# replay_exact.  Host arrays
# (_FLOATS, _INTS, _PTRS) are copied into the kernel's parameters.
ENTRIES = {
    "mqs_carry": Entry(
        ("replay_exact", "replay_cone"),
        (_P,) * 8 + (_I,) + (_P,) * 16 + (_I,) * 2 + (_F,) * 4 + (_D,)
        + (_I,) * 6 + (_P,)),
    "mqs_replay_exact": Entry(
        ("replay_exact",), (_P,) * 3 + (_I,) * 12 + (_P,)),
    "mqs_replay_exact_snap": Entry(
        ("replay_exact",), (_P,) * 4 + (_I,) * 15 + (_P,)),
    "mqs_map_step": Entry(
        ("replay_exact",), (_P,) * 2 + (_I,) * 8 + (_P,)),
    "mqs_ekf_replay": Entry(
        ("replay_exact",),
        (_P,) * 19 + (_I,) * 3 + (_FLOATS,)
        + (_F,) * 5 + (_I,) + (_F,) * 4 + (_D, _I, _P)),
    "mqs_behavior_step": Entry(
        ("replay_exact",), (_PTRS, _INTS, _PTRS, _I, _FLOATS, _INTS, _P)),
    "mqs_behavior_step_cl": Entry(
        ("replay_exact",), (_PTRS, _INTS, _PTRS, _I, _FLOATS, _INTS, _P)),
    "mqs_replay_cone": Entry(
        ("replay_cone",), (_P,) * 3 + (_I,) * 15 + (_F,) * 5 + (_P,)),
    "mqs_match_lattice": Entry(
        ("match_lattice",), (_P,) * 4 + (_I,) * 6 + (_P,)),
    "mqs_carry_blocks_per_sm": Entry(
        ("replay_exact", "replay_cone"), (_BLOCKS,)),
    "mqs_replay_exact_blocks_per_sm": Entry(("replay_exact",), (_I, _BLOCKS)),
    "mqs_ekf_replay_blocks_per_sm": Entry(("replay_exact",), (_BLOCKS,)),
    "mqs_behavior_step_blocks_per_sm": Entry(("replay_exact",), (_BLOCKS,)),
    "mqs_behavior_step_cl_blocks_per_sm": Entry(
        ("replay_exact",), (_BLOCKS,)),
    "mqs_replay_cone_blocks_per_sm": Entry(("replay_cone",), (_I, _BLOCKS)),
    "mqs_match_lattice_blocks_per_sm": Entry(
        ("match_lattice",), (_I, _BLOCKS)),
}


class Refused(ValueError):
    """A kernel entry returned -1: it does not take these operands."""


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
    """Build (if needed) and load csrc/<name>.cu, with the types of every
    entry ENTRIES lists for it set; cached per process."""
    if name not in _libs:
        lib = ctypes.CDLL(str(build(name)["path"]))
        for entry, e in ENTRIES.items():
            if name in e.libraries:
                fn = getattr(lib, entry)
                fn.argtypes, fn.restype = list(e.argtypes), e.restype
        _libs[name] = lib
    return _libs[name]


def launch(library, entry: str, device, *args) -> None:
    """Call the kernel entry `entry` of `library` (None: the one library
    that exports it) on `device`, with `args` (tensors as their device
    pointers, None as a null pointer) and the device's current stream
    last.  Raises Refused when the entry returns -1 and RuntimeError on any
    other nonzero code; counts each launch in launches.<entry without its
    mqs_ prefix> (utils/obs.py)."""
    libraries = ENTRIES[entry].libraries
    if library is None and len(libraries) == 1:
        library = libraries[0]
    if library not in libraries:
        raise ValueError(f"{entry} is exported by {libraries}, not by "
                         f"{library!r}")
    fn = getattr(load_library(library), entry)
    # args keeps the tensors alive until the launch is queued
    ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    with torch.cuda.device(device):
        err = fn(*ptrs, torch.cuda.current_stream(device).cuda_stream)
    if err == -1:
        raise Refused(f"{entry} refuses its operands")
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: CUDA error {err}")
    obs.count("launches." + entry.removeprefix("mqs_"))
