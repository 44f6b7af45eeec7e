"""On-card smoke check of the PyTorch port (micro_quad_slam_tpu_torch).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

It drives the port's paths, the batched bit-exact mapping replay
(kernel="residentx"), the hybrid production replay (kernel="hybridx"),
the SLAM replay (slam_replay: EKF odometry, scan matching, pose graph,
re-raster) and the closed-loop swarm simulator (models/simulator.py), and
builds and checks their hand-written CUDA kernels (csrc/replay_exact.cu
with its snapshot and map-step entries, csrc/replay_cone.cu,
csrc/match_lattice.cu).  Each phase prints one line and raises on
failure; nothing falls back to the CPU.  Phases:

  1. the card (nvidia-smi name and power limit) and the torch/CUDA versions;
  2. the sm_90a build of the three sources, one nvcc per source started
     together, with their seconds and each kernel's registers, shared
     memory, spills (-Xptxas=-v), blocks per SM (the occupancy
     calculator; for the lattice kernel, at both SLAM lattices) and SASS
     opcode counts (cuobjdump);
  3. exact kernel == plain torch on the card, bit for bit (grid, origins,
     used, kf_flags, filt), on random flights with recenters, a saturating
     endpoint, a recenter inside a run of gated frames, short beams, and
     the resident-tile flights (testdata.tile_flights: a tile reload on
     every frame; recenters right after reloads);
     then the same for the cone kernel in both modes (conex == cone,
     hybridx == hybrid), and hybridx == the JAX package's hybrid grids
     of the random flights; then the lattice kernel == its plain version
     at the SLAM path's two slab shapes: random operands at the bench's
     match counts, N = 1 and N = 3, all -1, all valid, out-of-slab and
     extreme indices, unaligned tables, and the SLAM bench flights' real
     pass-1 and loop operands; and the
     snapshot and scheduled-chunk entries == theirs, with recenters and
     with every snapshot chunk starting right after a tile reload; then
     the map-step entry == its plain version at B=1024 (random grids,
     NaN beams, a disabled quad, poses at the grid edge; rays that end on
     the grid's edge; a saturating endpoint; the short beams), and
     mapping_step(kernel="pallas" and
     "pallas_db"), one map-step launch per frame, == kernel="xla";
  4. exact kernel == the golden C model on a hover, a recentering flight
     and very short beams;
  5. resume: a residentx and a hybridx replay split at T/2 equal the
     unbroken ones;
  6. slam_replay on the 4 distinct SLAM bench flights (both profiles)
     against the JAX package's CPU results: tracks, keyframe nodes and
     every flight's grid sums;
  7. the bench workloads: bench.py's flight, B=1024 x T=256, on the
     residentx and hybridx paths (end-to-end frames/s of the kernel path
     and of the plain torch path, the grid checksum, the schedule's own
     seconds, the device's busy time in one profiled replay
     (torch.profiler) and its idle share of the best end-to-end time, and
     each kernel's own time against its plain version and its bound; the
     cone kernel is also timed in cone mode, and in hybrid mode on the
     SLAM bench flights, whose hits need the column search); the SLAM
     bench, UL_PROFILE at
     B=128 and UL_RT_PROFILE at B=256, T=256 (frames/s, checksum, per-stage
     seconds, launches, device busy and idle share, and the lattice kernel
     and snapshot entry alone against their plain versions and bounds,
     with the lattice kernel's ratio to its bound and build facts);
     and the EKF bench at B=1024.  The hybridx grids' per-flight sums
     must equal the JAX package's hybrid replay's, and the SLAM checksums
     the JAX package's CPU results;
  8. the swarm: the committed JAX small swarm (bench.py's swarm at B=8,
     its start state and draws) reproduced on the card (behaviour-state
     and cmd_kind traces, grids and frontier scores equal, poses and EKF
     means within 1e-4), then bench.py's swarm line, B=1024 x T=1000 at
     1 kHz: control ticks/s, the checksum against the port's committed
     CPU result (every quad's grid sum), the map-step launches, the
     device's busy time and idle share in one profiled run, and the
     map-step kernel's device time per launch against its plain version
     and its bound on the run's own scan ticks;
  9. the live-topology path (run before the bench phases): the first
     SLAM bench flight as a T=256 dual-UART capture (scanlog_to_wirecap)
     through replay_wirecap with kernel="residentx" and "hybridx", each
     grid equal to the card's scanlog replay of the log as the wire
     carries it and to the JAX package's CPU grid (testdata wire_ref),
     and the capture's frames through slam_replay against the JAX
     package's CPU SLAM of them; the exact, cone, lattice and snapshot
     kernels must launch.  Then the residentx bench replay split at
     T=128 around a save_checkpoint/restore_checkpoint round trip
     (checksum -239317596), the B=1024 bench swarm run 100 + 100 ticks
     around a checkpoint against 200 unbroken ticks (every field, every
     quad), and `python -m micro_quad_slam_tpu_torch replay --wirecap`
     as a subprocess;
 10. pass 1's feedback formulations (slam/pipeline.py::_map_pass_fb):
     slam_chunked_vs_sequential, the port's chunked pass on the card on
     the recentering flight of tests/test_slam.py:593 against the JAX
     package's sequential pass (grids equal, poses within 1e-6); then
     slam_replay with match_feedback=True and with match_map_kf_only=False
     at full width (the 4 SLAM bench flights replicated to B=128, T=256):
     pass 1 alone equal to the JAX package's sequential pass, the
     launches counted against the pipeline's loops (match_lattice 29,
     replay_exact 22, the snapshot entry none), each run bit-equal to its
     twin with the kernels' plain versions on the card, and against the
     JAX package's CPU run (slam_fb_ref) within the SLAM tolerances on
     all 4 flights, grid sums equal, with frames/s and seconds per stage;
 11. the sharded entries (parallel/mesh.py) over ["cuda:0", "cuda:0"]
     (a repeated device, not a second card), each equal to the unsharded
     run: the bench replay through residentx and hybridx (checksums
     -239317596 and -401735680), the dry run's recentering case, the EKF
     at B=1024, the UL SLAM at B=128 and 100 ticks of the bench swarm;
 12. the CL behaviour machine (models/behavior_cl.py) at B=1024 on the
     committed fuzzed schedules, equal to its CPU run;
 13. the native scanlog reader (io/native.py): built with g++ and equal
     to the Python reader on the SLAM bench flight.

The bench phases take their end-to-end times from the port's bench entry
(micro_quad_slam_tpu_torch/bench.py), so each workload is timed once.

It imports the port and numpy only: the inputs and reference results are
committed files of the port (micro_quad_slam_tpu_torch/testdata).

The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.  Exits non-zero on any failure, without a
CUDA device, or outside the repository.
"""

from __future__ import annotations

import ctypes
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

import micro_quad_slam_tpu_torch as port
from micro_quad_slam_tpu_torch import bench, testdata
from micro_quad_slam_tpu_torch.ops import _build
from micro_quad_slam_tpu_torch.ops import conemode
from micro_quad_slam_tpu_torch.ops import conex as cx
from micro_quad_slam_tpu_torch.ops import matchlattice as ml
from micro_quad_slam_tpu_torch.ops import residentx as rx
from micro_quad_slam_tpu_torch.ops import scanmatch as sm
from micro_quad_slam_tpu_torch.models import simulator as sim
from micro_quad_slam_tpu_torch.replay import fusion as fu
from micro_quad_slam_tpu_torch.slam import pipeline as sp

UL_PROFILE = port.UL_PROFILE
GEOM = port.DEFAULT_GEOM
SLAM_PROFILES = {"ul": port.UL_PROFILE, "rt": port.UL_RT_PROFILE}

# the JAX package's bench lines on the TPU (BENCH_r05): checksum anchors
CHECKSUM_REF = {"residentx": -239317572, "hybridx": -401735680,
                "ul": -28317856, "rt": -56410560, "ekf": 1024,
                "swarm": -8944084,
                # the exact bench replay off the TPU (ROADMAP section C)
                "residentx_off_tpu": -239317596}
METRIC = {"residentx": "fused_sensor_frames_per_sec_per_chip",
          "hybridx": "fused_sensor_frames_per_sec_per_chip_hybridx",
          "ul": "slam_frames_per_sec_per_chip",
          "rt": "slam_rt_frames_per_sec_per_chip",
          "ekf": "ekf_frames_per_sec_per_chip",
          "swarm": "swarm_control_ticks_per_sec_per_chip"}
PLAIN = {"residentx": "xla", "hybridx": "hybrid"}
SOURCES = ("replay_exact", "replay_cone", "match_lattice")
KERNELS = {
    "replay_exact": {
        "source": "micro_quad_slam_tpu_torch/csrc/replay_exact.cu",
        "replaces": "micro_quad_slam_tpu/ops/pallas_residentx.py:667"},
    "replay_cone": {
        "source": "micro_quad_slam_tpu_torch/csrc/replay_cone.cu",
        # _hybridx_kernel; it also replaces _conex_kernel (:1439) and
        # pallas_resident.py:440 _resident_cone_kernel
        "replaces": "micro_quad_slam_tpu/ops/pallas_residentx.py:1447"},
    "match_lattice": {
        "source": "micro_quad_slam_tpu_torch/csrc/match_lattice.cu",
        "replaces": "micro_quad_slam_tpu/ops/pallas_scanmatch.py:49"},
    "replay_exact_snap": {
        # the snapshot entry (mqs_replay_exact_snap) of the exact kernel
        "source": "micro_quad_slam_tpu_torch/csrc/replay_exact.cu",
        "replaces": "micro_quad_slam_tpu/ops/pallas_residentx.py:845"},
    "map_step": {
        # the map-step entry (mqs_map_step) of the exact kernel; the
        # per-frame window kernels pallas_raycast.py:98 _window_kernel and
        # :212 _window_kernel_db (kernel names pallas, pallas_db) route to it
        "source": "micro_quad_slam_tpu_torch/csrc/replay_exact.cu",
        "replaces": "micro_quad_slam_tpu/ops/pallas_residentx.py:1662"},
}
# counters of the kernels' wrappers (one per launch)
WRAPPERS = {"replay_exact": rx.replay_exact, "replay_cone": cx.replay_cone,
            "match_lattice": ml.match_lattice,
            "replay_exact_snap": rx.replay_exact_snap,
            "map_step": rx.map_step}
# the card's peaks (H100 SXM datasheet at 700 W): HBM bytes/s, and the
# dispatch rates of the kernels' operations.  The datasheet's 67e12 float32
# FLOP/s counts an fma as two operations; the kernels are built with
# -fmad=false and do adds, multiplies, compares and selects, which dispatch
# at 128 per clock per SM at most, half that rate, as does every
# instruction together.  Int32 operations dispatch at 64 per clock per SM,
# a quarter of it.  Negation and abs are free operand modifiers.
HBM_BYTES_PER_S = 3.35e12
DISPATCH_OPS_PER_S = 67e12 / 2
INT32_OPS_PER_S = 67e12 / 4
# (float, int32) operations of replay_cone.cu, counted from its source by
# class of window cell; the products come from per-frame tables.  A lower
# bound: only the arithmetic, compares and selects the classification
# needs, not the addresses, table loads and sign flips around them.
#   beyond reach (and off the grid, and every cell of a frame that is not
#     enabled): the squared range's add and its compare against the
#     frame's reach = (2, 0);
#   in reach but outside every fan: + the 4 quadrant compares and the
#     fan-end compare; the 4 selects of the quadrant frame's tables and
#     signs = (7, 4);
#   fully classified: + the free carve's 3 compares; the sector index (4)
#     and the delta's 2 selects = (10, 10); cone mode adds the occupied
#     band's 2 compares = (12, 10); and one compare per column test, of
#     which a fan needs 0 to 3 (CONE_COLUMN_TEST_OPS; 0 where the fan's 8
#     sectors hold the same thresholds, as where every beam misses).
# Per grid word of 4 cells: the clip (saturating add, max, min) and the
# compare for the store = (0, 4).  Per frame, the tables: 96 rows and 136
# columns of (an add, 18 products, a square), and 32 sectors of 16 = 5152
# float.
CONE_CLASS_OPS = {"beyond_reach": (2, 0), "outside_fans": (7, 4),
                  "classified": {False: (12, 10), True: (10, 10)}}
CONE_COLUMN_TEST_OPS = (1, 0)
CONE_WORD_OPS = (0, 4)
CONE_FRAME_OPS = (5152, 0)
# int32 operations per cell of an exact ray (replay_exact.cu's walk): the
# step test, the numerator, the multiply-high for the minor offset, the
# offset (2), the endpoint test and select, and the clip (add, min, max)
# = 10; per valid ray, its lane's walk parameters once a frame (the major
# axis test, 4 selects of lengths and signs, 2 of the strides, the magic
# number's division, 2*dmin) = 10
EXACT_CELL_OPS = (0, 10)
EXACT_RAY_OPS = 10
# the first designs' counts, before the cone kernel's early exits and the
# exact kernel's multiply-high: every in-grid window cell of an enabled
# frame fully classified, (38 | 49 float, 7 int32); 14 int32 a ray cell
FIRST_CONE_CELL_OPS = {False: (49, 7), True: (38, 7)}
FIRST_EXACT_CELL_OPS = (0, 14)
# csrc/replay_exact.cu's resident tile: kTile, and how far left of the
# pose its column starts (kMaxReach)
EXACT_TILE = 128
EXACT_TILE_LEFT = 56
# int32 operations per lattice lookup (match_lattice.cu): the four bound
# compares, the slab address (multiply, add) and the accumulate = 7
MATCH_LOOKUP_OPS = 7


def check(ok, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def say(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def checksum(grid: torch.Tensor) -> int:
    """int32 (wrapping) sum of all grids, as bench.py computes it."""
    s = int(grid.to(torch.int64).sum())
    return (s + 2 ** 31) % 2 ** 32 - 2 ** 31


def replay(frames_np: dict, device, kernel: str, state0=None):
    return port.replay_mapping_batched(
        port.frames_to_torch(frames_np, device), UL_PROFILE, kernel=kernel,
        state0=state0)


def reset_launches() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0


def launches() -> dict:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def assert_same(a, b, what: str) -> None:
    """Bit-equality of two replays' (state, outs) pairs."""
    (sa, oa), (sb, ob) = a, b
    pairs = [(f, getattr(sa, f), getattr(sb, f)) for f in sa._fields]
    pairs += [(k, oa[k], ob[k]) for k in oa]
    for name, x, y in pairs:
        x, y = x.cpu().numpy(), y.cpu().numpy()
        same = (np.array_equal(x, y, equal_nan=True) if x.dtype.kind == "f"
                else np.array_equal(x, y))
        if not same:
            raise AssertionError(f"{what}: {name} differs")


# ---------------------------------------------------------------- inputs

def random_flights() -> dict:
    """8 x 64 seeded flights with noise and dropouts; flight 1 drifts 40 m
    so that it recenters, the last one never leaves the ground."""
    return testdata.load("random_flights")[0]


def _const_frames(grid_mm, x) -> dict:
    B, T = x.shape
    return {"grid_mm": grid_mm, "x_m": x,
            "y_m": np.zeros((B, T), np.float32),
            "yaw_deg": np.zeros((B, T), np.float32),
            "of_q": np.full((B, T), 200, np.int32),
            "of_rate_x": np.zeros((B, T), np.float32),
            "sys_health": np.zeros((B, T), np.int64),
            "state": np.full((B, T), 5, np.uint8)}


def saturating_endpoint() -> dict:
    """Hovering 7 cm from a wall: every front beam ends in the same one or
    two cells, 16 frames (quad 1 also hammers the right sensor)."""
    B, T = 2, 16
    grid_mm = np.full((B, T, 4, 8, 8), 0xFFFF, np.uint16)
    grid_mm[:, :, 0] = 70
    grid_mm[1, :, 1] = 90
    return _const_frames(grid_mm, np.zeros((B, T), np.float32))


def recenter_in_gated_run() -> dict:
    """A recenter at frame 10 inside frames 8-15 that are all gated out
    (flow quality 0)."""
    B, T = 1, 24
    x = np.zeros((B, T), np.float32)
    x[0, 8:10] = 10.0
    x[0, 10:] = 16.0
    f = _const_frames(np.full((B, T, 4, 8, 8), 1500, np.uint16), x)
    f["of_q"][0, 8:16] = 0
    return f


def short_beams() -> dict:
    """Every zone at 51 mm (flight 0) or 53 mm (flight 1): most rays of a
    scan end in the pose cell, which swings past the whole clamp range in
    one scan."""
    return testdata.load("golden_short_beams")[0]


# ---------------------------------------------------------------- phases

def phase_card() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    say("card", torch=torch.__version__, cuda=torch.version.cuda,
        device=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count())
    return smi


def _ptxas_resources(log: str) -> list:
    """Each compiled kernel's registers, shared memory and spills, from
    nvcc -Xptxas -v: [{function, registers, smem_bytes, spill_stores,
    spill_loads}], the function named by its kernel and template flag."""
    out, cur = [], None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            k = re.search(r"\d([a-z_]+_kernel)(?:ILb([01])E)?", m.group(1))
            flag = {"0": "<false>", "1": "<true>", None: ""}[k.group(2)]
            cur = {"function": k.group(1) + flag}
            out.append(cur)
        elif cur is not None:
            for key, pat in (("spill_stores", r"(\d+) bytes spill stores"),
                             ("spill_loads", r"(\d+) bytes spill loads"),
                             ("registers", r"Used (\d+) registers"),
                             ("smem_bytes", r"(\d+) bytes smem")):
                m = re.search(pat, ln)
                if m:
                    cur[key] = int(m.group(1))
    return out


def _sass_counts(path) -> dict:
    """{function: {"instructions": n, opcode: n for the most used}} of a
    built library, from cuobjdump -sass (static counts; None where the
    toolkit has no cuobjdump)."""
    tool = Path(_build._nvcc()).with_name("cuobjdump")
    if not tool.exists():
        return None
    sass = subprocess.run([str(tool), "-sass", str(path)], capture_output=True,
                          text=True, check=True).stdout
    out, ops = {}, None
    for ln in sass.splitlines():
        m = re.search(r"Function : (\w+)", ln)
        if m:
            k = re.search(r"\d([a-z_]+_kernel)(?:ILb([01])E)?", m.group(1))
            flag = {"0": "<false>", "1": "<true>", None: ""}[k.group(2)]
            ops = out.setdefault(k.group(1) + flag, {})
            continue
        m = re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9]+)", ln)
        if m and ops is not None:
            ops[m.group(1)] = ops.get(m.group(1), 0) + 1
    return {f: {"instructions": sum(c.values()),
                **dict(sorted(c.items(), key=lambda kv: -kv[1])[:8])}
            for f, c in out.items()}


# the redesigned kernels' occupancy queries: source -> (C entry, {function:
# its argument, or {label: argument} for a kernel launched at several
# shapes})
OCCUPANCY = {
    "replay_exact": ("mqs_replay_exact_blocks_per_sm",
                     {"replay_exact_kernel<false>": 0,
                      "replay_exact_kernel<true>": 1, "map_step_kernel": 2}),
    "replay_cone": ("mqs_replay_cone_blocks_per_sm",
                    {"replay_cone_kernel<false>": 0,
                     "replay_cone_kernel<true>": 1}),
    "match_lattice": ("mqs_match_lattice_blocks_per_sm",
                      {"match_lattice_kernel": {"pass1": 7, "loop": 5}})}
# the SLAM path's two lattices: stage -> (n_yaw, T), slab shape
LATTICES = {"pass1": (7, 7), "loop": (5, 5)}
SLAB_SHAPES = {"pass1": (104, 256), "loop": (96, 128)}
# each kernel's build facts, filled by phase_build: source -> {function:
# registers, shared memory, spills, blocks per SM, SASS counts}
BUILD_FACTS: dict = {}


def phase_build() -> None:
    t0 = time.perf_counter()
    built = _build.build_all(list(SOURCES))
    wall = time.perf_counter() - t0
    for name, info in built.items():
        res = _ptxas_resources(info["log"])
        check(res, f"no ptxas resources in {name}'s build log")
        if name in OCCUPANCY:
            entry, arg = OCCUPANCY[name]
            fn = getattr(_build.load_library(name), entry)
            fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
            fn.restype = ctypes.c_int

            def blocks(a, fname):
                n = ctypes.c_int(0)
                check(fn(a, ctypes.byref(n)) == 0,
                      f"occupancy query of {fname}")
                return n.value
            for r in res:
                a = arg[r["function"]]
                r["blocks_per_sm"] = (
                    {k: blocks(v, r["function"]) for k, v in a.items()}
                    if isinstance(a, dict) else blocks(a, r["function"]))
        sass = _sass_counts(info["path"])
        BUILD_FACTS[name] = {r["function"]: {
            **r, "sass": (sass or {}).get(r["function"])} for r in res}
        say("build", kernel=name, target="sm_90a",
            flags=" ".join(_build.NVCC_FLAGS), seconds=info["seconds"],
            resources=res, sass=sass)
    say("build_all", kernels=list(built), wall_seconds=wall)


def _cases() -> dict:
    """The replay kernels' card cases; the last two
    (testdata.tile_flights) drive the exact kernel's resident tile: a
    reload on every frame, and recenters right after reloads."""
    return {"random_recenter": random_flights(),
            "saturating_endpoint": saturating_endpoint(),
            "recenter_in_gated_run": recenter_in_gated_run(),
            "short_beams": short_beams(), **testdata.tile_flights()}


def _check_tile_case(name: str, sched) -> int:
    """The tile cases reach the paths they are for: every frame with rays
    loads the tile (tile_every_frame), every recenter comes right after a
    load (recenter_after_reload).  Returns the tile loads."""
    loads = _tile_loads(sched)
    live = sched[..., rx.H_ANY] != 0
    if name == "tile_every_frame":
        check(bool(live.any()) and torch.equal(loads, live),
              f"{name}: not every frame reloads the tile")
    if name == "recenter_after_reload":
        do = sched[..., rx.H_DO] != 0
        check(bool(do[:, 1:].any()), f"{name}: no recenter")
        check(bool(loads[:, :-1][do[:, 1:]].all()),
              f"{name}: a recenter not right after a reload")
    return int(loads.sum())


def phase_kernel_vs_plain(device) -> None:
    before = rx.replay_exact.launches
    cases = _cases()
    tile_loads = {}
    for name, f in cases.items():
        k = replay(f, device, "residentx")
        assert_same(k, replay(f, device, "xla"), name)
        (st, outs) = k
        if name in testdata.tile_flights():
            sched = rx.schedule(port.frames_to_torch(f, device),
                                UL_PROFILE)[0]
            tile_loads[name] = _check_tile_case(name, sched)
        if name == "random_recenter":
            check(int((outs["kf_flags"] != 0).sum()) >= 1, "no recenter")
        if name in ("saturating_endpoint", "short_beams"):
            check(int(st.grid.max()) >= UL_PROFILE.map.lo_max - 10,
                  f"{name}: no saturation")
        if name == "recenter_in_gated_run":
            kf, used = outs["kf_flags"][0].cpu(), outs["used"][0].cpu()
            check(kf[10] != 0 and not used[8:16].any(), "scenario missed")
    launches = rx.replay_exact.launches - before
    check(launches >= len(cases), f"kernel launched {launches} times")
    say("kernel_vs_plain", kernel="replay_exact", cases=list(cases),
        bit_equal=True, launches=launches, tile_loads=tile_loads)


def phase_cone_kernel_vs_plain(device) -> None:
    """The cone kernel in both modes against the per-frame plain path; in
    hybrid mode the short beams pile endpoint increments on the pose
    cell.  Then hybridx against the JAX package's hybrid grids."""
    before = cx.replay_cone.launches
    cases = _cases()
    for name, f in cases.items():
        for kernel, plain in (("conex", "cone"), ("hybridx", "hybrid")):
            k = replay(f, device, kernel)
            assert_same(k, replay(f, device, plain), f"{name} {kernel}")
            st, outs = k
            check(int((st.grid != 0).sum()) > 0, f"{name} {kernel}: no cell")
            if name == "random_recenter":
                check(int((outs["kf_flags"] != 0).sum()) >= 1, "no recenter")
            if name == "short_beams" and kernel == "hybridx":
                check(int(st.grid.max()) >= UL_PROFILE.map.lo_max - 10,
                      "short_beams: no endpoint pile-up")
    launches = cx.replay_cone.launches - before
    check(launches >= 2 * len(cases), f"kernel launched {launches} times")
    st, _ = replay(random_flights(), device, "hybridx")
    want = testdata.reference("hybrid_random_flights")["grid"]
    got = port.logical_grid(st.grid).cpu().numpy()
    check(np.array_equal(got, want),
          f"hybridx vs the JAX package: {int((got != want).sum())} cells "
          f"differ")
    say("kernel_vs_plain", kernel="replay_cone", modes=["cone", "hybrid"],
        cases=list(cases), bit_equal=True, launches=launches,
        jax_hybrid_random_flights_equal=True)


GOLDEN = ("golden_hover", "golden_line_recenter", "golden_short_beams")


def phase_golden(device) -> None:
    """Against the golden C model's grids and masks, stored with the
    flights in micro_quad_slam_tpu_torch/testdata."""
    for name in GOLDEN:
        frames, golden = testdata.load(name)
        st, outs = replay(frames, device, "residentx")
        grid = port.logical_grid(st.grid).cpu().numpy()
        if not np.array_equal(grid, golden["grid"]):
            raise AssertionError(f"{name}: grid differs in "
                                 f"{int((grid != golden['grid']).sum())} cells")
        if not np.array_equal(outs["used"].cpu().numpy(), golden["used"]):
            raise AssertionError(f"{name}: used differs")
        recentered = outs["kf_flags"].cpu().numpy().any(axis=1)
        check(np.array_equal(recentered, golden["recentered"]),
              f"{name}: recenters differ")
    check(bool(testdata.load("golden_line_recenter")[1]["recentered"].all()),
          "golden_line_recenter: no recenter")
    say("golden", flights=list(GOLDEN), bit_equal=True)


def phase_resume(device) -> None:
    f = random_flights()
    T = f["x_m"].shape[1]
    for kernel in ("residentx", "hybridx"):
        full = replay(f, device, kernel)
        head = replay({k: v[:, :T // 2] for k, v in f.items()}, device,
                      kernel)
        tail = replay({k: v[:, T // 2:] for k, v in f.items()}, device,
                      kernel, state0=head[0])
        assert_same((tail[0], {}), (full[0], {}), f"{kernel} resume")
        say("resume", kernel=kernel, split=T // 2, bit_equal=True)


def _time_call(fn, reps: int, setup=None) -> float:
    """ms per call of fn() by CUDA events, with setup() (outside the timed
    span) before every call."""
    total = 0.0
    for _ in range(reps):
        if setup is not None:
            setup()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        total += e0.elapsed_time(e1)
    return total / reps


def _time_kernel(grids, fn, reps: int) -> float:
    """ms per call of fn(grids), grids reset to zero before every call."""
    return _time_call(lambda: fn(grids), reps, grids.zero_)


def _schedule(frames, kernel: str):
    if kernel == "residentx":
        return rx.schedule(frames, UL_PROFILE)
    return cx.schedule(frames, UL_PROFILE, hybrid=True)


def _time_schedule(frames, kernel: str, reps: int) -> list:
    """Seconds of the schedule alone (the host-driven carry over T and the
    per-frame words), after one warm-up."""
    times = []
    for _ in range(reps + 1):
        t0 = time.perf_counter()
        _schedule(frames, kernel)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return times[1:]


def _device_busy(frames, kernel: str) -> dict:
    """_profiled_busy of one end-to-end replay, with the device time of
    the port's replay kernels summed."""
    busy = _profiled_busy(lambda: port.replay_mapping_batched(
        frames, UL_PROFILE, kernel=kernel), ("replay_",))
    busy["kernel_device_ms"] = sum(busy["kernel_device_ms"].values())
    return busy


def _launch_groups(prof, names) -> list:
    """The launches of each kernel whose name holds one of `names` in a
    finished profiler session, grouped by launch shape (grid, block,
    registers per thread, shared memory bytes): their count and device
    ms.  The raw events carry no launch shape, so this reads the
    session's chrome trace, written to build/ and deleted."""
    path = Path(__file__).resolve().parent / "build" / "launch_trace.json"
    path.parent.mkdir(exist_ok=True)
    prof.export_chrome_trace(str(path))
    try:
        events = json.loads(path.read_text())["traceEvents"]
    finally:
        path.unlink()
    groups = {}
    for ev in events:
        if ev.get("cat") != "kernel" or not any(n in ev.get("name", "")
                                                 for n in names):
            continue
        a = ev.get("args", {})
        key = (ev["name"], a.get("grid"), a.get("block"),
               a.get("registers per thread"), a.get("shared memory"))
        g = groups.setdefault(repr(key), [key, 0.0, 0])
        g[1] += ev["dur"] / 1e3
        g[2] += 1
    return [{"name": k[0], "grid": k[1], "block": k[2], "registers": k[3],
             "shared_memory": k[4], "launches": n, "device_ms": ms}
            for k, ms, n in groups.values()]


def _profiled_busy(fn, names, launch_groups: bool = False) -> dict:
    """One call of fn under torch.profiler (host and device): the summed
    device time of every kernel, copy and fill it ran and their count, the
    device ms and launches of each kernel whose name holds one of
    `names` (with launch_groups, also by launch shape: _launch_groups),
    the wall time of the profiled run, and the five host events
    with the most summed time (`host_total`: nested events included, so a
    caller's time holds its callees').  It reads the trace's raw events
    (the profiler's kineto results): key_averages() builds an event tree
    that takes many minutes for one 1,000-tick swarm run (~1.9 M kernels).
    busy_ms is None when the profiler saw no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev_ns, dev_n, host = 0, 0, {}
    kern_ns, kern_n = {}, {}
    for e in prof.profiler.kineto_results.events():
        name, ns = e.name(), e.duration_ns()
        if e.device_type() == DeviceType.CUDA:
            dev_ns += ns
            dev_n += 1
            if any(n in name for n in names):
                kern_ns[name] = kern_ns.get(name, 0) + ns
                kern_n[name] = kern_n.get(name, 0) + 1
        else:
            t, c = host.get(name, (0, 0))
            host[name] = (t + ns, c + 1)
    top = sorted(host.items(), key=lambda kv: kv[1][0], reverse=True)[:5]
    return {"busy_ms": dev_ns / 1e6 if dev_ns > 0 else None,
            "device_ops": dev_n,
            "kernel_device_ms": {k: v / 1e6 for k, v in kern_ns.items()},
            "kernel_launches": kern_n,
            "kernel_launch_groups": (_launch_groups(prof, names)
                                     if launch_groups else None),
            "host_total": [[k, t / 1e6, c] for k, (t, c) in top],
            "profiled_wall_s": wall}


# ---------------------------------------------------------------- bounds

def _recentering_quads(sched) -> torch.Tensor:
    """bool [B]: quads with a recenter, whose whole grid is read and
    written."""
    return sched[..., rx.H_DO].any(dim=1)


def _exact_touched(sched, slab=None) -> tuple:
    """(distinct 32-byte grid sectors, cells, valid rays) the exact kernel
    reads and writes for this schedule: the cells of every valid ray, and
    the whole grid of a quad that recenters; with slab = (rows, cols),
    also the snapshot slabs (header words H_R0S, H_C0S) the snapshot entry
    reads."""
    B, T, _ = sched.shape
    dev = sched.device
    n_sec = GEOM.prows * GEOM.pcols // 32
    mark = torch.zeros((B, n_sec), dtype=torch.bool, device=dev)
    mark[_recentering_quads(sched)] = True
    if slab is not None:
        rows, cols = slab
        per_row = GEOM.pcols // 32
        r = (sched[..., rx.H_R0S, None].long()
             + torch.arange(rows, device=dev))                  # [B, T, rows]
        c = (sched[..., rx.H_C0S, None].long() // 32
             + torch.arange(cols // 32, device=dev))            # [B, T, c32]
        sec = r[..., :, None] * per_row + c[..., None, :]
        quad = torch.arange(B, device=dev).view(B, 1, 1, 1).expand_as(sec)
        mark[quad.reshape(-1), sec.reshape(-1)] = True
    k = torch.arange(GEOM.win_r + 1, device=dev).view(1, 1, 1, -1)
    quad = torch.arange(B, device=dev).view(B, 1, 1, 1)
    cells = rays = 0
    for t0 in range(0, T, 16):
        w = sched[:, t0:t0 + 16].long()
        r = w[..., rx.HDR:].reshape(B, w.shape[1], 32, rx.RAY_WORDS)
        ex, ey, valid = r[..., 0:1], r[..., 1:2], r[..., 3:4] != 0
        dx, dy = ex.abs(), ey.abs()
        xmaj = dx >= dy
        dmaj, dmin = torch.maximum(dx, dy), torch.minimum(dx, dy)
        m = torch.div(2 * k * dmin + dmaj, (2 * dmaj).clamp_min(1),
                      rounding_mode="floor")
        u = torch.where(ex > 0, 1, -1) * torch.where(xmaj, k, m)
        v = torch.where(ey > 0, 1, -1) * torch.where(xmaj, m, k)
        ok = valid & (k <= dmaj)
        cell = ((w[..., rx.H_PCY, None, None] + v) * GEOM.pcols
                + w[..., rx.H_PCX, None, None] + u)
        cells += int(ok.sum())
        rays += int(valid.sum())
        mark[quad.expand_as(cell)[ok], (cell // 32)[ok]] = True
    return int(mark.sum()), cells, rays


def _exact_int_ops(cells: int, rays: int) -> int:
    return cells * EXACT_CELL_OPS[1] + rays * EXACT_RAY_OPS


def _tile_loads(sched) -> torch.Tensor:
    """bool [B, T]: the frames at which csrc/replay_exact.cu loads its
    resident tile for this schedule, by the kernel's own rule: a frame with
    rays whose box (its valid rays' endpoints and the pose) leaves the tile
    it holds, or that holds none (at the start, after a recenter); the
    tile is then placed around the pose."""
    B, T, _ = sched.shape
    w = sched.long()
    r = w[..., rx.HDR:].reshape(B, T, 32, rx.RAY_WORDS)
    valid = r[..., 3] != 0
    ex = torch.where(valid, r[..., 0], 0)
    ey = torch.where(valid, r[..., 1], 0)
    pcy, pcx = w[..., rx.H_PCY], w[..., rx.H_PCX]
    ylo, yhi = pcy + ey.amin(-1).clamp(max=0), pcy + ey.amax(-1).clamp(min=0)
    xlo, xhi = pcx + ex.amin(-1).clamp(max=0), pcx + ex.amax(-1).clamp(min=0)
    have = torch.zeros(B, dtype=torch.bool, device=sched.device)
    r0 = torch.zeros(B, dtype=torch.long, device=sched.device)
    c0 = torch.zeros_like(r0)
    loads = []
    for t in range(T):
        have &= w[:, t, rx.H_DO] == 0
        inside = (have & (ylo[:, t] >= r0) & (yhi[:, t] < r0 + EXACT_TILE)
                  & (xlo[:, t] >= c0) & (xhi[:, t] < c0 + EXACT_TILE))
        load = (w[:, t, rx.H_ANY] != 0) & ~inside
        r0 = torch.where(load, (pcy[:, t] - EXACT_TILE // 2).clamp(
            0, GEOM.prows - EXACT_TILE), r0)
        c0 = torch.where(load, (pcx[:, t] - EXACT_TILE_LEFT).clamp(
            0, GEOM.pcols - EXACT_TILE) // 16 * 16, c0)
        have |= load
        loads.append(load)
    return torch.stack(loads, dim=1)


def _cone_touched(sched) -> tuple:
    """(distinct 32-byte grid sectors, cells inside the logical grid of
    enabled frames) of the cone kernel for this schedule: every frame
    reads and writes its whole window; a recentering quad's whole grid is
    read and written."""
    B, T, _ = sched.shape
    dev = sched.device
    WR, WC, n_cs = GEOM.win_rows, GEOM.win_cols, GEOM.pcols // 32
    w = sched.long()
    r0, c0 = w[..., cx.H_R0], w[..., cx.H_C0]
    # the union of each quad's windows, in sector columns, by a 2-D
    # difference array
    diff = torch.zeros((B, GEOM.prows + 1, n_cs + 1), dtype=torch.int32,
                       device=dev)
    b = torch.arange(B, device=dev)[:, None].expand(B, T)
    s0, s1 = c0 // 32, (c0 + WC - 1) // 32 + 1
    one = torch.ones((B, T), dtype=torch.int32, device=dev)
    for rr, ss, sign in ((r0, s0, 1), (r0, s1, -1), (r0 + WR, s0, -1),
                         (r0 + WR, s1, 1)):
        diff.index_put_((b, rr, ss), sign * one, accumulate=True)
    cover = diff.cumsum(1).cumsum(2)[:, :GEOM.prows, :n_cs] > 0
    cover[_recentering_quads(sched)] = True
    rows = ((r0 + WR).clamp(max=GEOM.pad + GEOM.height)
            - r0.clamp(min=GEOM.pad)).clamp(min=0)
    cols = ((c0 + WC).clamp(max=GEOM.pad + GEOM.width)
            - c0.clamp(min=GEOM.pad)).clamp(min=0)
    cells = int((rows * cols * (w[..., cx.H_EN] != 0)).sum())
    return int(cover.sum()), cells


def _fan_depths(dfree2, olo2, ohi2, hybrid: bool) -> torch.Tensor:
    """int [N, 4]: the column tests replay_cone.cu gives each fan's cells,
    from its 8 sectors' thresholds [N, 32]: 0 where all 8 agree, 1 where
    each half does, 2 where each pair does, else 3."""
    thr = torch.stack([dfree2] if hybrid else [dfree2, olo2, ohi2], -1)
    fans = thr.view(thr.shape[0], 4, 8, -1)

    def uniform(n):
        groups = fans.view(fans.shape[0], 4, 8 // n, n, -1)
        return (groups == groups[:, :, :, :1]).flatten(2).all(-1)

    return torch.where(uniform(8), 0, torch.where(
        uniform(4), 1, torch.where(uniform(2), 2, 3)))


def _cone_classes(sched, hybrid: bool, chunk: int = 2048) -> dict:
    """The cone kernel's window cells for this schedule by class
    (CONE_CLASS_OPS), as replay_cone.cu classifies them: beyond the
    frame's reach (or off the grid, or in a frame not enabled), in reach
    but outside every fan, fully classified, with the column tests the
    classified ones take; and its frames and the grid words it clips (96
    rows of 32, or 33 when the window's corner column is not a multiple
    of 4)."""
    WR, WC, R = GEOM.win_rows, GEOM.win_cols, GEOM.win_r
    m = UL_PROFILE.map
    k = conemode.cone_constants(m.res_m, UL_PROFILE.tof, conemode.ConeConfig())
    flat = sched.reshape(-1, sched.shape[-1])
    dev = flat.device
    rows = torch.arange(WR, device=dev)
    cols = torch.arange(WC, device=dev)
    n = dict.fromkeys(("beyond_reach", "outside_fans", "classified",
                       "column_tests"), 0)
    for i in range(0, flat.shape[0], chunk):
        inp = cx._frame_inputs(flat[i:i + chunk], GEOM, hybrid)
        ay = rows.float() + inp["oyc"][:, None]                   # [N, WR]
        ax = cols.float() + inp["oxc"][:, None]                   # [N, WC]
        gy = rows + (inp["pcy"] - R)[:, None]
        gx = cols + (inp["pcx"] - R)[:, None]
        ayy = torch.where((gy >= 0) & (gy < m.height), ay * ay, math.inf)
        axx = torch.where((gx >= 0) & (gx < m.width), ax * ax, math.inf)
        p = inp["packed"]
        d = p.abs()
        valid = d > k["skip"]
        dfree = (d - k["free_margin"]).clamp_min(0.0) * k["inv_res"]
        ohi = (d + k["hit_band"]) * k["inv_res"]
        olo = (d - k["hit_band"]).clamp_min(0.0) * k["inv_res"]
        dfree2 = torch.where(valid, dfree * dfree, 0.0)
        ohi2 = torch.where(valid & (p > 0.0) & (not hybrid), ohi * ohi, -1.0)
        depth = _fan_depths(dfree2, olo * olo, ohi2, hybrid)
        reach2 = torch.where(inp["en"], torch.maximum(dfree2, ohi2).amax(1),
                             -1.0)
        near = axx[:, None, :] + ayy[:, :, None] <= reach2[:, None, None]
        b = inp["bounds"]
        on_col = lambda j: (b[:, j, None] * ax)[:, None, :]       # noqa: E731
        on_row = lambda j: (b[:, j, None] * ay)[:, :, None]       # noqa: E731
        pxx, pyx, pxy, pyy = on_col(0), on_col(1), on_row(0), on_row(1)
        m0 = (pxx > -pyy) & (pxy >= pyx)
        m1 = ~m0 & (pxy > pyx)
        d1 = ~m0 & ~m1
        d0 = m1 | (d1 & ~(pxx < -pyy))
        py = torch.where(d0, on_col(16), on_row(16))
        px = torch.where(d0, on_row(17), on_col(17))
        out = (torch.where(d0 != d1, -py, py) > torch.where(d1, -px, px))
        fan = (2 * d1.long() + d0.long()).flatten(1)
        tests = depth.gather(1, fan).view(out.shape)
        n["beyond_reach"] += int((~near).sum())
        n["outside_fans"] += int((near & out).sum())
        n["classified"] += int((near & ~out).sum())
        n["column_tests"] += int(tests[near & ~out].sum())
    words = WR * int((32 + (flat[:, cx.H_C0] % 4 != 0).long()).sum())
    return {**n, "frames": flat.shape[0], "words": words}


def _ops_bound(nbytes: int, f_ops: int, i_ops: int) -> tuple:
    """(ms, "bytes" or "operations"): the larger of nbytes over the HBM
    rate and the operations over their dispatch rates (all of them over
    the dispatch rate, the int32 ones alone over theirs)."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = max((f_ops + i_ops) / DISPATCH_OPS_PER_S, i_ops / INT32_OPS_PER_S)
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _bound(name: str, sched, hybrid: bool = False) -> dict:
    """The least time the card could take for the kernel's work on this
    schedule: the larger of its bytes (the schedule read once, each
    touched grid sector read once and written once) over the HBM rate
    and its operations, counted from the kernel's source by class of cell
    (CONE_CLASS_OPS, EXACT_CELL_OPS), over their dispatch rates.
    `first_count_bound_ms` is the bound by the first designs' counts
    (every in-grid cell fully classified; 14 int32 a ray cell)."""
    if name == "replay_exact":
        sectors, cells, rays = _exact_touched(sched)
        f_ops, i_ops = 0, _exact_int_ops(cells, rays)
        first = (0, cells * FIRST_EXACT_CELL_OPS[1])
        extra = {"cells": cells, "rays": rays,
                 "tile_loads": int(_tile_loads(sched).sum())}
    else:
        sectors, cells = _cone_touched(sched)
        cls = _cone_classes(sched, hybrid)
        per = {**CONE_CLASS_OPS,
               "classified": CONE_CLASS_OPS["classified"][hybrid]}
        f_ops = sum(cls[c] * per[c][0] for c in per) + \
            cls["column_tests"] * CONE_COLUMN_TEST_OPS[0] + \
            cls["frames"] * CONE_FRAME_OPS[0]
        i_ops = sum(cls[c] * per[c][1] for c in per) + \
            cls["column_tests"] * CONE_COLUMN_TEST_OPS[1] + \
            cls["words"] * CONE_WORD_OPS[1]
        first = tuple(cells * o for o in FIRST_CONE_CELL_OPS[hybrid])
        extra = {"cells_in_grid": cells, **cls}
    nbytes = sched.numel() * sched.element_size() + 2 * 32 * sectors
    ms, by = _ops_bound(nbytes, f_ops, i_ops)
    return {"bound_ms": ms, "bound_by": by, "bound_bytes": nbytes,
            "bound_float_ops": f_ops, "bound_int32_ops": i_ops,
            "first_count_bound_ms": _ops_bound(nbytes, *first)[0],
            "grid_sectors": sectors, **extra}


# ----------------------------------------------------------------- bench

def phase_bench(device, smi: str, kernel: str, B: int = 1024, T: int = 256,
                reps: int = 3, plain_reps: int = 3) -> dict:
    """bench.py's line for `kernel` ("residentx" or "hybridx") on the
    card, timed end to end by the port's bench entry (bench.bench_replay:
    a warm-up, then the best of the reps), then its CUDA kernel alone
    against its plain version.  Returns the kernel's entry of the kernels
    line."""
    name = "replay_exact" if kernel == "residentx" else "replay_cone"
    frames = port.frames_to_torch(testdata.bench_frames(B, T), device)
    check(frames["x_m"].shape == (B, T), "bench frames")
    torch.cuda.synchronize()

    reset_launches()                      # count this path's run only
    line, (st_k, outs_k) = bench.bench_replay(
        kernel, B, T, reps, device, first=kernel == "residentx",
        frames=frames)
    times_k = line["rep_seconds"]
    n_launch = launches()
    metrics = port.batch_metrics(outs_k)
    sched_s = _time_schedule(frames, kernel, reps)
    busy = _device_busy(frames, kernel)
    plain_line, (st_p, outs_p) = bench.bench_replay(
        PLAIN[kernel], B, T, plain_reps, device, frames=frames)
    times_p = plain_line["rep_seconds"]
    dt_k, dt_p = min(times_k), min(times_p)
    idle = None if busy["busy_ms"] is None else 1 - busy["busy_ms"] / (dt_k * 1e3)

    ck, cp = checksum(st_k.grid), checksum(st_p.grid)
    used, total = int(metrics["frames_used"]), int(metrics["frames_total"])
    check(ck == cp, f"checksum kernel {ck} != plain {cp}")
    assert_same((st_k, outs_k), (st_p, outs_p), f"{kernel} bench")
    check(used == total == B * T, f"frames_used {used}/{total}")
    check(n_launch[name] >= 1, f"the {kernel} path never launched {name}")
    extra = {}
    if kernel == "hybridx":
        grids = st_k.grid.cpu().numpy()
        parts = [testdata.grid_sums(grids[i:i + 128])
                 for i in range(0, B, 128)]
        for k, ref in testdata.reference("hybrid_bench_sums").items():
            got = np.concatenate([p[k] for p in parts])
            check(np.array_equal(got, ref),
                  f"hybridx per-flight {k} differ from the JAX package's in "
                  f"{int((got != ref).sum())} flights")
        extra["per_flight_sums_equal_jax_cpu"] = True
    check(line["checksum"] == ck, "the bench line's checksum")
    say("bench", metric=METRIC[kernel],
        value=B * T / dt_k, unit="frames/s", kernel=kernel,
        bench_line=line,
        checksum=ck, checksum_ref=CHECKSUM_REF[kernel],
        checksum_matches_ref=ck == CHECKSUM_REF[kernel], **extra,
        frames_used=used, frames_total=total,
        recenters=int(metrics["recenters"]), launches=n_launch,
        plain_value=B * T / dt_p, plain_kernel=PLAIN[kernel],
        rep_seconds=times_k, plain_rep_seconds=times_p,
        schedule_seconds=sched_s, device_busy_ms=busy["busy_ms"],
        device_ops=busy["device_ops"],
        kernel_device_ms=busy["kernel_device_ms"],
        host_total=busy["host_total"],
        profiled_wall_s=busy["profiled_wall_s"], device_idle_share=idle,
        B=B, T=T, reps=reps, card=smi)

    # the kernel alone against its plain version, on the bench schedule
    sched = _schedule(frames, kernel)[0]
    if kernel == "residentx":
        fn = lambda g: rx.replay_exact(g, sched, UL_PROFILE)      # noqa: E731
        plain_fn = lambda g: rx.replay_exact_plain(g, sched, UL_PROFILE)  # noqa: E731
    else:
        fn = lambda g: cx.replay_cone(g, sched, UL_PROFILE, True)  # noqa: E731
        plain_fn = lambda g: cx.replay_cone_plain(g, sched, UL_PROFILE,  # noqa: E731
                                                  True)
    grids = torch.zeros_like(st_k.grid)
    ms = _time_kernel(grids, fn, 5)
    plain = torch.zeros_like(grids)
    plain_ms = _time_kernel(plain, plain_fn, 1)
    err = int((grids.to(torch.int16) - plain.to(torch.int16)).abs().max())
    check(err == 0, f"{name} vs plain max abs err {err}")
    bound = _bound(name, sched, hybrid=kernel == "hybridx")
    say("kernel_bound", kernel=name, mode=kernel, **bound)
    if kernel == "hybridx":
        _cone_mode_alone(frames, st_k.grid, smi)
        _cone_on_walls(st_k.grid, smi)
    return {"name": name, "route": "cuda", **KERNELS[name],
            "launches": n_launch[name], "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound["bound_ms"],
            "bound_by": bound["bound_by"], "library_ms": None}


def _cone_mode_alone(frames, like, smi: str) -> None:
    """The cone kernel in cone mode (kernel names conex, resident_cone) on
    the bench schedule: its time against its plain version and its bound."""
    sched = cx.schedule(frames, UL_PROFILE, hybrid=False)[0]
    grids = torch.zeros_like(like)
    ms = _time_kernel(grids, lambda g: cx.replay_cone(g, sched, UL_PROFILE,
                                                      False), 5)
    plain = torch.zeros_like(grids)
    plain_ms = _time_kernel(
        plain, lambda g: cx.replay_cone_plain(g, sched, UL_PROFILE, False), 1)
    err = int((grids.to(torch.int16) - plain.to(torch.int16)).abs().max())
    check(err == 0, f"replay_cone (cone mode) vs plain max abs err {err}")
    say("kernel_cone_mode", kernel="replay_cone", mode="conex", ms=ms,
        plain_ms=plain_ms, max_abs_err=err,
        **_bound("replay_cone", sched, hybrid=False), card=smi)


def _cone_on_walls(like, smi: str, B: int = 1024) -> None:
    """The cone kernel in hybrid mode on the SLAM bench flights (circles in
    a walled room, testdata.slam_bench_frames) replicated to B=1024: hits
    at many ranges, where its fans need their column search, unlike the
    bench hover's misses.  Time, plain time and bound."""
    frames = testdata.slam_bench_frames(B, device=like.device)
    sched = cx.schedule(frames, UL_PROFILE, hybrid=True)[0]
    grids = torch.zeros_like(like)
    fn = lambda g: cx.replay_cone(g, sched, UL_PROFILE, True)   # noqa: E731
    fn(grids)                                                    # warm-up
    ms = _time_kernel(grids, fn, 5)
    plain = torch.zeros_like(grids)
    plain_ms = _time_kernel(
        plain, lambda g: cx.replay_cone_plain(g, sched, UL_PROFILE, True), 1)
    err = int((grids.to(torch.int16) - plain.to(torch.int16)).abs().max())
    check(err == 0, f"replay_cone (walls) vs plain max abs err {err}")
    say("kernel_cone_walls", kernel="replay_cone", mode="hybridx",
        flights="slam_bench_frames", ms=ms, plain_ms=plain_ms,
        max_abs_err=err, **_bound("replay_cone", sched, hybrid=True),
        card=smi)


# ------------------------------------------------------------------ SLAM

def _random_slots(device, K: int = 8, jump: bool = False):
    """The committed random flights' every 8th frame as K keyframe slots,
    with a chunk-start recenter (flight 0, slot 4) and a mid-chunk one
    (flight 1, slot 2), on grids of random log-odds.  With jump, the
    slots' poses jump 4.8 m east and back, so that every slot reloads the
    exact kernel's tile and every chunk starts right after a reload."""
    t = port.frames_to_torch(random_flights(), device)
    B = t["x_m"].shape[0]
    beams, _ = port.ops.extract_beams(t["grid_mm"], UL_PROFILE.tof)
    sel = slice(0, 8 * K, 8)
    x, y, yaw = t["x_m"][:, sel], t["y_m"][:, sel], t["yaw_deg"][:, sel]
    if jump:
        x = x + torch.where(torch.arange(K, device=device) % 2 == 0, -2.4,
                            2.4)
    ox, oy = x[:, :1].expand(B, K).clone(), y[:, :1].expand(B, K).clone()
    ox, oy = ox.nan_to_num(0.0), oy.nan_to_num(0.0)
    do = torch.zeros((B, K), dtype=torch.int32, device=device)
    rsy, rsx = do.clone(), do.clone()
    do[0, 4], rsy[0, 4], rsx[0, 4] = 1, 5, -3
    do[1, 2], rsy[1, 2], rsx[1, 2] = 1, -4, 7
    g = torch.randint(-60, 61, (B, GEOM.prows, GEOM.pcols), dtype=torch.int8,
                      device=device,
                      generator=torch.Generator(device=device).manual_seed(3))
    outside = torch.ones_like(g, dtype=torch.bool)
    outside[:, GEOM.pad:GEOM.pad + GEOM.height,
            GEOM.pad:GEOM.pad + GEOM.width] = False
    g[outside] = 0
    return [beams[:, sel].contiguous(), x, y, yaw, ox, oy, do, rsy, rsx], g


def _random_lattice(device, N: int, shape, n_yaw: int, T: int, seed: int):
    """Random slabs and indices with -1 masks and out-of-slab indices."""
    g = torch.Generator(device=device).manual_seed(seed)
    SR, SC = shape
    slabs = torch.randint(-128, 128, (N, SR, SC), dtype=torch.int8,
                          device=device, generator=g)
    ry = torch.randint(-1, SR + 2, (N, n_yaw * T, 32), dtype=torch.int32,
                       device=device, generator=g)
    rxi = torch.randint(-1, SC + 2, (N, n_yaw * T, 32), dtype=torch.int32,
                        device=device, generator=g)
    return slabs, ry, rxi


def _edge_lattice(device, N: int, stage: str, seed: int, kind: str):
    """Lattice operands at a SLAM stage's shape: "mixed" (-1 masks,
    out-of-slab and extreme int32 indices among in-slab ones), "all_valid",
    "all_minus_one", or "unaligned" (mixed, with ry and rx 4 bytes off a
    16-byte boundary: the kernel's word-by-word staging)."""
    n_yaw, T = LATTICES[stage]
    SR, SC = SLAB_SHAPES[stage]
    slabs, ry, rxi = _random_lattice(device, N, (SR, SC), n_yaw, T, seed)
    g = torch.Generator(device=device).manual_seed(seed + 1)
    ry, rxi = ry.clamp(0, SR - 1), rxi.clamp(0, SC - 1)
    if kind == "all_minus_one":
        ry.fill_(-1)
        rxi.fill_(-1)
    elif kind in ("mixed", "unaligned"):
        odd = torch.tensor([-1, -2, SR, SR + 1, SC, 2 ** 31 - 1, -2 ** 31,
                            1 << 30, -(1 << 30)], dtype=torch.int32,
                           device=device)
        for a in (ry, rxi):
            u = torch.rand(a.shape, device=device, generator=g)
            pick = torch.randint(0, len(odd), a.shape, device=device,
                                 generator=g)
            a.copy_(torch.where(u < 0.2, -1, torch.where(u < 0.3, odd[pick],
                                                          a)))
    if kind == "unaligned":
        def shifted(a):
            buf = torch.empty(a.numel() + 1, dtype=a.dtype, device=device)
            out = buf[1:].view(a.shape)
            out.copy_(a)
            return out
        ry, rxi = shifted(ry), shifted(rxi)
        check(ry.data_ptr() % 16 and rxi.data_ptr() % 16,
              "the unaligned case is aligned")
    return slabs, ry, rxi, n_yaw



def _lattice_cases(device) -> dict:
    """The lattice kernel's card cases: the random operands at the bench's
    match counts (every index in [-1, SR + 2), so every beam is live), N =
    1 and N = 3, all -1, all valid, out-of-slab and extreme indices,
    unaligned tables, and the 4 SLAM bench flights' real pass-1 and loop
    operands (testdata.slam_kernel_operands)."""
    cases = {}
    for N, stage in ((3584, "pass1"), (9984, "loop")):
        n_yaw, T = LATTICES[stage]
        cases[f"random_{stage}"] = _random_lattice(
            device, N, SLAB_SHAPES[stage], n_yaw, T, N) + (n_yaw,)
    for stage in LATTICES:
        for N, kind in ((1, "mixed"), (3, "mixed"), (3, "all_valid"),
                        (2, "all_minus_one"), (5, "unaligned")):
            cases[f"{kind}_n{N}_{stage}"] = _edge_lattice(
                device, N, stage, 100 * N + len(stage), kind)
    _, real = testdata.slam_kernel_operands(
        testdata.slam_bench_frames(4, device=device), UL_PROFILE)
    cases.update({f"bench_{k}": v for k, v in real.items()})
    return cases


def phase_slam_kernels_vs_plain(device) -> None:
    """The lattice kernel on its card cases (_lattice_cases), the snapshot
    entry and map_chunk_sched with recenters: each == its plain version,
    bit for bit."""
    before = launches()
    cases = _lattice_cases(device)
    for name, args in cases.items():
        got = ml.match_lattice(*args)
        check(torch.equal(got, ml.match_lattice_plain(*args)),
              f"match_lattice {name} differs from its plain version")
    args, g0 = _random_slots(device)
    pcx, pcy = port.ops.world_to_cell(args[1], args[2], args[4], args[5],
                                      UL_PROFILE.map.res_m, 250, 250)
    wy0, wx0 = sm.window_origin(pcx, pcy, GEOM)
    got = rx.map_snap(g0, *args, wy0, wx0, 4, UL_PROFILE)
    want = rx.map_snap_plain(g0, *args, wy0, wx0, 4, UL_PROFILE)
    check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
          "map_snap differs from its plain version")
    check(not torch.equal(got[1][0, 4], got[1][0, 3]), "no chunk-start roll")
    # every chunk start right after a tile reload
    args_j, _ = _random_slots(device, jump=True)
    pcx, pcy = port.ops.world_to_cell(args_j[1], args_j[2], args_j[4],
                                      args_j[5], UL_PROFILE.map.res_m, 250,
                                      250)
    wy0, wx0 = sm.window_origin(pcx, pcy, GEOM)
    got = rx.map_snap(g0, *args_j, wy0, wx0, 4, UL_PROFILE)
    want = rx.map_snap_plain(g0, *args_j, wy0, wx0, 4, UL_PROFILE)
    check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
          "map_snap (a reload before every chunk start) differs from its "
          "plain version")
    sched = rx._snap_operands(g0, *args_j, wy0, wx0, 4, UL_PROFILE, GEOM)[1]
    live = sched[..., rx.H_ANY] != 0
    check(bool(live[:, 3].any())
          and torch.equal(_tile_loads(sched), live),
          "the jumping slots do not reload the tile at every slot")
    # a whole flight's re-raster with the exact path's own recenters
    f = port.frames_to_torch(random_flights(), device)
    beams, so, _, _ = rx.carry(f, UL_PROFILE)
    check(int(so["do"].sum()) >= 2, "the random flights do not recenter")
    x = [beams, f["x_m"].nan_to_num(0.0), f["y_m"].nan_to_num(0.0),
         f["yaw_deg"].nan_to_num(0.0), so["ox"].nan_to_num(0.0),
         so["oy"].nan_to_num(0.0), so["do"], so["sy"], so["sx"]]
    got = rx.map_chunk_sched(g0, *x, UL_PROFILE)
    want = rx.replay_exact_plain(g0.clone(), rx.track_schedule(
        *x, UL_PROFILE), UL_PROFILE)
    check(torch.equal(got, want), "map_chunk_sched differs from plain")
    n = {k: v - before[k] for k, v in launches().items()}
    check(n["match_lattice"] >= len(cases) and n["replay_exact_snap"] >= 2
          and n["replay_exact"] >= 1, f"launches {n}")
    say("kernel_vs_plain", kernel=["match_lattice", "replay_exact_snap",
                                   "replay_exact (map_chunk_sched)"],
        lattice_cases={k: v[0].shape[0] for k, v in cases.items()},
        recenters=int(so["do"].sum()) + 2,
        snapshot_cases=["random_slots", "chunk_start_after_reload"],
        bit_equal=True, launches=n)


def _track_err(a: torch.Tensor, b: np.ndarray) -> list:
    """Per-flight max abs difference of [B, ...] float arrays."""
    d = np.abs(a.cpu().numpy().astype(np.float64) - b)
    return d.reshape(len(d), -1).max(axis=1).tolist()


def phase_slam_vs_jax(device) -> None:
    """slam_replay on the 4 SLAM bench flights against the JAX package's
    CPU results, in both profiles, within tests/test_torch_slam.py's
    tolerances: odometry 1e-5, nodes and track 1e-4, grid sums equal."""
    ref = testdata.reference("slam_bench_ref")
    frames = testdata.slam_bench_frames(4, device=device)
    for tag, cfg in SLAM_PROFILES.items():
        before = launches()
        res = sp.slam_replay(frames, cfg)
        n = {k: v - before[k] for k, v in launches().items()}
        errs = {k: _track_err(getattr(res, k), ref[f"{tag}_{k}"])
                for k in ("odo_track", "kf_nodes", "track")}
        sums = testdata.grid_sums(res.grid.cpu().numpy())
        say("slam_vs_jax", profile=tag, max_abs_err=errs,
            grid_sums=sums["sums"].tolist(),
            jax_grid_sums=ref[f"{tag}_sums"].tolist(),
            weighted_equal=bool(np.array_equal(sums["weighted"],
                                               ref[f"{tag}_weighted"])),
            launches=n)
        for k, tol in (("odo_track", 1e-5), ("kf_nodes", 1e-4),
                       ("track", 1e-4)):
            check(max(errs[k]) <= tol, f"slam {tag}: {k} off by "
                                       f"{max(errs[k])}")
        for k in ("sums", "weighted"):
            check(np.array_equal(sums[k], ref[f"{tag}_{k}"]),
                  f"slam {tag}: grid {k} differ from the JAX package's")
        check(all(n[k] >= 1 for k in ("match_lattice", "replay_exact_snap",
                                       "replay_exact")), f"launches {n}")


def _lattice_bound(slabs, ry, rxi, n_yaw: int) -> dict:
    """The lattice kernel's bound on these operands.  Bytes: the index
    rows and the scores, each once, and every distinct 32-byte slab
    sector that the in-slab (row, column) pair of some candidate and beam
    refers to.  Operations: MATCH_LOOKUP_OPS int32 ones per in-slab
    lookup (one off the slab adds nothing to its score)."""
    N, SR, SC = slabs.shape
    NB = ry.shape[2]
    T = ry.shape[1] // n_yaw
    check(SC % 32 == 0, f"slab width {SC}")
    per_row = SC // 32
    sectors = lookups = 0
    for n0 in range(0, N, 256):
        y = ry[n0:n0 + 256].reshape(-1, n_yaw, T, 1, NB).long()
        x = rxi[n0:n0 + 256].reshape(-1, n_yaw, 1, T, NB).long()
        n = y.shape[0]
        ok = (y >= 0) & (y < SR) & (x >= 0) & (x < SC)
        base = torch.arange(n, device=y.device).view(n, 1, 1, 1, 1) * SR
        sec = (base + y) * per_row + torch.div(x, 32, rounding_mode="floor")
        mark = torch.zeros(n * SR * per_row, dtype=torch.bool,
                           device=y.device)
        mark[sec.expand(ok.shape)[ok]] = True
        sectors += int(mark.sum())
        lookups += int(ok.sum())
    nbytes = 32 * sectors + 4 * (ry.numel() + rxi.numel()) + 4 * (
        N * n_yaw * T * T)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = lookups * MATCH_LOOKUP_OPS / INT32_OPS_PER_S
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_bytes": nbytes, "bound_ops": lookups * MATCH_LOOKUP_OPS,
            "lookups": lookups, "lookups_all": N * n_yaw * T * T * NB,
            "slab_sectors": sectors, "slab_sectors_all": N * SR * per_row}


def _lattice_times(args) -> dict:
    """The lattice kernel on one stage's operands: call_ms, a CUDA-event
    span around one call (host work included); plain_ms; and the max abs
    error against the plain version."""
    call_ms = _time_call(lambda: ml.match_lattice(*args), 5)
    plain_ms = _time_call(lambda: ml.match_lattice_plain(*args), 1)
    err = float((ml.match_lattice(*args) - ml.match_lattice_plain(*args))
                .abs().max())
    return {"call_ms": call_ms, "plain_ms": plain_ms, "max_abs_err": err}


def _stage_launches(busy: dict, kernel: str, N: int) -> dict:
    """The launches of `kernel` over N blocks in a profiled run (`busy`):
    one launch shape, its launches and the device ms per launch."""
    runs = [g for g in busy["kernel_launch_groups"]
            if kernel in g["name"] and (g["grid"] or (None,))[0] == N]
    check(len(runs) == 1, f"{kernel}'s launches over {N} blocks in the "
                          f"profiled run: {runs}")
    run = runs[0]
    return {"ms": run["device_ms"] / run["launches"],
            "ms_profiled_launches": run["launches"],
            "launch": {k: run[k] for k in ("grid", "block", "registers",
                                           "shared_memory")}}


def _slam_kernels_alone(frames, cfg, smi: str, busy: dict) -> dict:
    """The lattice kernel and the snapshot entry alone on this SLAM
    workload's operands (testdata.slam_kernel_operands): time against the
    plain version, error, bound.  ms is the card's time per launch, its
    device time per launch in `busy`, the profiled replay
    (_profiled_busy): for the lattice kernel by stage, its launches over
    that stage's match count; call_ms is a CUDA-event span around one
    call, host work included.  Returns their entries of the kernels line
    (without launches)."""
    snap_ops, lattice = testdata.slam_kernel_operands(frames, cfg)
    out = {}
    build = BUILD_FACTS["match_lattice"]["match_lattice_kernel"]
    for stage, args in lattice.items():
        t = {**_stage_launches(busy, "match_lattice", args[0].shape[0]),
             **_lattice_times(args)}
        check(t["max_abs_err"] == 0,
              f"match_lattice vs plain max abs err {t['max_abs_err']}")
        bound = _lattice_bound(*args)
        say("kernel_alone", kernel="match_lattice", stage=stage,
            N=args[0].shape[0], slab=list(args[0].shape[1:]), **t, **bound,
            bound_ratio=t["ms"] / bound["bound_ms"],
            build={**build, "blocks_per_sm": build["blocks_per_sm"][stage]},
            card=smi)
        if stage == "pass1":
            out["match_lattice"] = {**t, **bound}
    grids0, sched, snaps, n_kf = snap_ops
    snaps_k, snaps_p = torch.empty_like(snaps), torch.empty_like(snaps)
    g_k, g_p = grids0.clone(), grids0.clone()
    call_ms = _time_call(lambda: rx.replay_exact_snap(
        g_k, sched, snaps_k, n_kf, cfg), 5, lambda: g_k.copy_(grids0))
    # its wrapper waits on the card twice (the slab check, the recenter
    # test), so the card's own time comes from the profiled replay
    key = next(k for k in busy["kernel_device_ms"]
               if "replay_exact_kernel<true>" in k)
    profiled = busy["kernel_launches"][key]
    ms = busy["kernel_device_ms"][key] / profiled
    plain_ms = _time_call(lambda: rx.replay_exact_plain(
        g_p, sched, cfg, GEOM, snaps_p, n_kf), 1, lambda: g_p.copy_(grids0))
    err = max(int((g_k.to(torch.int16) - g_p.to(torch.int16)).abs().max()),
              int((snaps_k.to(torch.int16)
                   - snaps_p.to(torch.int16)).abs().max()))
    check(err == 0, f"replay_exact_snap vs plain max abs err {err}")
    sectors, cells, rays = _exact_touched(sched, snaps.shape[2:])
    nbytes = (sched.numel() * sched.element_size() + 2 * 32 * sectors
              + snaps.numel())
    ms_bound, by = _ops_bound(nbytes, 0, _exact_int_ops(cells, rays))
    bound = {"bound_ms": ms_bound, "bound_by": by, "bound_bytes": nbytes,
             "bound_int32_ops": _exact_int_ops(cells, rays),
             "first_count_bound_ms": _ops_bound(
                 nbytes, 0, cells * FIRST_EXACT_CELL_OPS[1])[0]}
    say("kernel_alone", kernel="replay_exact_snap", stage="pass1",
        B=sched.shape[0], slots=sched.shape[1], ms=ms,
        ms_profiled_launches=profiled, call_ms=call_ms,
        plain_ms=plain_ms, max_abs_err=err, grid_sectors=sectors,
        cells=cells, rays=rays,
        tile_loads=int(_tile_loads(sched).sum()), **bound, card=smi)
    out["replay_exact_snap"] = {"max_abs_err": err, "ms": ms,
                                "plain_ms": plain_ms, **bound}
    return out


# the SLAM stages' functions, timed by _stage_seconds
STAGES = {"pass0": sp._odo_and_schedule, "pass1": sp._map_pass_nofb,
          "pass1_fb": sp._map_pass_fb, "loop": sp._loop_stage,
          "gn": sp._build_and_solve, "pass3": rx.map_chunk_sched}


def _stage_seconds(frames, cfg, reps: int = 3) -> dict:
    """Seconds per SLAM stage in one slam_replay, each summed over its
    calls, and the rest ("other": the glue between the stages), from the
    fastest of `reps` replays.  Python's sys.monitoring reports each call
    of a STAGES function and its return, and the card is synchronised at
    both, so a stage's device work counts in it; the pipeline carries no
    timing hook.  A stage called inside another (the feedback pass 1
    lands its chunks through map_chunk_sched) counts in the outer one."""
    mon = sys.monitoring
    tool = mon.PROFILER_ID
    names = {fn.__code__: name for name, fn in STAGES.items()}
    active, secs = [], {}                 # stack of (code, start) | None

    def on_start(code, _offset):
        if active:
            active.append(None)
            return
        torch.cuda.synchronize()
        active.append((code, time.perf_counter()))

    def on_return(code, _offset, _value):
        entry = active.pop()
        if entry is None:
            return
        torch.cuda.synchronize()
        dt = time.perf_counter() - entry[1]
        secs[names[code]] = secs.get(names[code], 0.0) + dt

    mon.use_tool_id(tool, "chip_smoke")
    mon.register_callback(tool, mon.events.PY_START, on_start)
    mon.register_callback(tool, mon.events.PY_RETURN, on_return)
    for code in names:
        mon.set_local_events(tool, code,
                             mon.events.PY_START | mon.events.PY_RETURN)
    runs = []
    try:
        for _ in range(reps):
            secs.clear()
            active.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sp.slam_replay(frames, cfg)
            torch.cuda.synchronize()
            total = time.perf_counter() - t0
            runs.append({**secs, "other": total - sum(secs.values()),
                         "total": total})
    finally:
        for code in names:
            mon.set_local_events(tool, code, 0)
        mon.register_callback(tool, mon.events.PY_START, None)
        mon.register_callback(tool, mon.events.PY_RETURN, None)
        mon.free_tool_id(tool)
    return min(runs, key=lambda r: r["total"])


def phase_slam_bench(device, smi: str, tag: str, B: int, T: int = 256,
                     reps: int = 3) -> dict:
    """bench.py's slam line for profile `tag` ("ul": B=128, "rt": B=256):
    best of `reps` after a warm-up, the checksum beside the TPU record and
    the JAX package's CPU result, per-stage seconds, launches, device busy
    ms and idle share.  For "ul", also the SLAM kernels alone; returns
    their kernels-line entries."""
    cfg = SLAM_PROFILES[tag]
    frames = testdata.slam_bench_frames(B, T, device=device)
    torch.cuda.synchronize()
    reset_launches()                      # count this path's run only
    line, res = bench.bench_slam("acc" if tag == "ul" else "rt", B, T, reps,
                                 device, frames=frames)
    times = line["rep_seconds"]
    n_launch = launches()
    for k in ("match_lattice", "replay_exact_snap", "replay_exact"):
        check(n_launch[k] >= reps + 1, f"slam {tag} never launched {k}")
    ck = checksum(res.grid)
    ref = testdata.reference("slam_bench_ref")
    want = checksum(torch.from_numpy(np.concatenate(
        [ref[f"{tag}_sums"]] * (B // 4))))
    check(B % 4 == 0 and ck == want,
          f"slam {tag} checksum {ck} != the JAX package's CPU {want}")
    dt = min(times)
    stages = _stage_seconds(frames, cfg)
    busy = _profiled_busy(lambda: sp.slam_replay(frames, cfg),
                          ("replay_exact", "match_lattice"), tag == "ul")
    check(line["checksum"] == ck, "the bench line's checksum")
    say("bench", metric=METRIC[tag], value=B * T / dt, unit="frames/s",
        bench_line=line,
        profile=cfg.name, checksum=ck, checksum_ref=CHECKSUM_REF[tag],
        checksum_matches_ref=ck == CHECKSUM_REF[tag],
        checksum_jax_cpu=want, rep_seconds=times,
        stage_seconds=stages,
        launches={k: v for k, v in n_launch.items() if v},
        launches_per_replay={k: v / (reps + 1) for k, v in n_launch.items()
                             if v},
        device_busy_ms=busy["busy_ms"], device_ops=busy["device_ops"],
        kernel_device_ms=busy["kernel_device_ms"],
        kernel_launches=busy["kernel_launches"],
        host_total=busy["host_total"],
        profiled_wall_s=busy["profiled_wall_s"],
        device_idle_share=(None if busy["busy_ms"] is None
                           else 1 - busy["busy_ms"] / (dt * 1e3)),
        B=B, T=T, reps=reps, card=smi)
    if tag != "ul":
        return {}
    alone = _slam_kernels_alone(frames, cfg, smi, busy)
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")
    return {name: {"name": name, "route": "cuda", **KERNELS[name],
                   "launches": n_launch[name],
                   **{k: alone[name][k] for k in keys}, "library_ms": None}
            for name in ("match_lattice", "replay_exact_snap")}


def phase_ekf_bench(device, smi: str, B: int = 1024, T: int = 256,
                    reps: int = 3) -> None:
    """bench.py's ekf line: the fusion replay of the 4 SLAM bench flights
    replicated to B=1024; checksum = the int32 sum of the x track cast to
    int32, against the JAX package's CPU track."""
    frames = testdata.slam_bench_frames(B, T, device=device)
    line, track = bench.bench_ekf(B, T, reps, device, frames=frames)
    times = line["rep_seconds"]
    ck = checksum(track["x"].to(torch.int32))
    check(line["checksum"] == ck, "the bench line's checksum")
    x = testdata.reference("slam_bench_ref")["ekf_x"]
    want = checksum(torch.from_numpy(np.concatenate([x] * (B // 4))).to(
        torch.int32))
    err = float(np.abs(track["x"][:4].cpu().numpy() - x).max())
    check(ck == want and err <= 1e-5,
          f"ekf checksum {ck} (JAX CPU {want}), x off by {err}")
    busy = _profiled_busy(lambda: fu.replay_fusion_batched(frames,
                                                           UL_PROFILE), ())
    dt = min(times)
    say("bench", metric=METRIC["ekf"], value=B * T / dt, unit="frames/s",
        bench_line=line, checksum=ck, checksum_ref=CHECKSUM_REF["ekf"],
        checksum_matches_ref=ck == CHECKSUM_REF["ekf"], checksum_jax_cpu=want,
        max_abs_err_x_vs_jax_cpu=err, rep_seconds=times,
        device_busy_ms=busy["busy_ms"], device_ops=busy["device_ops"],
        host_total=busy["host_total"],
        device_idle_share=(None if busy["busy_ms"] is None
                           else 1 - busy["busy_ms"] / (dt * 1e3)),
        B=B, T=T, reps=reps, card=smi)


# ----------------------------------------------------------------- swarm

def _map_step_cases(device, B: int = 1024) -> dict:
    """name -> (grids, [per-frame map_step arguments]): tests/test_pallas.py
    :421-451's case at B=1024 (random grids in [-80, 80], beams up to 4.2 m
    with 15% NaN, poses in +/-20 m with the last two at or over the grid
    edge, quad 3 disabled); a saturating endpoint (grids at 120, every
    front beam 7 cm from the pose); rays that reach the logical grid's
    edge (testdata.edge_scans); the short-beam flights' 3 frames."""
    rng = np.random.default_rng(3)
    gen = torch.Generator(device=device).manual_seed(3)
    grids = torch.randint(-80, 81, (B, GEOM.prows, GEOM.pcols),
                          dtype=torch.int8, device=device, generator=gen)
    beams = rng.uniform(0.1, 4.2, (B, 4, 8)).astype(np.float32)
    beams[rng.random((B, 4, 8)) < 0.15] = np.nan
    x = rng.uniform(-20, 20, B).astype(np.float32)
    y = rng.uniform(-20, 20, B).astype(np.float32)
    x[-2:] = rng.uniform(24.0, 26.0, 2)
    yaw = rng.uniform(-180, 180, B).astype(np.float32)
    z = np.zeros(B, np.float32)
    en = np.ones(B, bool)
    en[3] = False
    ten = lambda *a: [torch.from_numpy(v).to(device) for v in a]   # noqa: E731
    cases = {"random_edge_disabled": (grids, [ten(beams, x, y, yaw, z, z,
                                                  en)])}
    sat = np.full((2, 4, 8), np.nan, np.float32)
    sat[:, 0] = 0.07
    z2 = np.zeros(2, np.float32)
    cases["saturating_endpoint"] = (
        torch.full((2, GEOM.prows, GEOM.pcols), 120, dtype=torch.int8,
                   device=device),
        [ten(sat, z2, z2, z2, z2, z2, np.ones(2, bool))] * 4)
    f = port.frames_to_torch(short_beams(), device)
    sb, _ = port.ops.extract_beams(f["grid_mm"], UL_PROFILE.tof)
    zt = torch.zeros(2, device=device)
    eb, ex, ey, eyaw = testdata.edge_scans()
    ze = np.zeros(len(ex), np.float32)
    cases["grid_edge_reach"] = (grids[:len(ex)].clone(), [
        ten(eb, ex, ey, eyaw, ze, ze, np.ones(len(ex), bool))])
    cases["short_beams"] = (
        torch.zeros((2, GEOM.prows, GEOM.pcols), dtype=torch.int8,
                    device=device),
        [[sb[:, t], f["x_m"][:, t], f["y_m"][:, t], f["yaw_deg"][:, t], zt,
          zt, torch.ones(2, dtype=torch.bool, device=device)]
         for t in range(sb.shape[1])])
    return cases


def _edge_endpoints(args) -> int:
    """Valid rays of one map step (map_step's arguments) that end on the
    logical grid's border row or column."""
    w = rx._step_words(*args, UL_PROFILE, GEOM).long()
    r = w[:, rx.HDR:].reshape(-1, 32, rx.RAY_WORDS)
    y = w[:, rx.H_PCY, None] + r[..., 1] - GEOM.pad
    x = w[:, rx.H_PCX, None] + r[..., 0] - GEOM.pad
    edge = ((y == 0) | (y == GEOM.height - 1) | (x == 0)
            | (x == GEOM.width - 1))
    return int((edge & (r[..., 3] != 0)).sum())


def phase_map_step_vs_plain(device) -> None:
    """The map-step entry against map_step_plain, bit for bit, then the
    per-frame kernel names "pallas" and "pallas_db" (one map-step launch
    per frame) against kernel="xla" on the random flights."""
    before = rx.map_step.launches
    n_frames = 0
    cases = _map_step_cases(device)
    for name, (g0, frames) in cases.items():
        got, want = g0.clone(), g0.clone()
        for a in frames:
            rx.map_step(got, *a, UL_PROFILE)
            rx.map_step_plain(want, *a, UL_PROFILE)
        n_frames += len(frames)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"map_step {name} differs from plain")
        check(not torch.equal(got, g0), f"map_step {name}: no cell moved")
        if name == "random_edge_disabled":
            check(torch.equal(got[3], g0[3]), "the disabled quad's grid moved")
        elif name == "grid_edge_reach":
            check(_edge_endpoints(frames[0]) > 0,
                  f"map_step {name}: no ray ends on the grid's edge")
        else:
            check(int(got.max()) >= UL_PROFILE.map.lo_max - 10,
                  f"map_step {name}: no saturation")
    launches = rx.map_step.launches - before
    check(launches == n_frames, f"map_step launched {launches} times for "
                                f"{n_frames} frames")
    f = random_flights()
    T = f["x_m"].shape[1]
    routes = {}
    for kernel in ("pallas", "pallas_db"):
        b = rx.map_step.launches
        k = replay(f, device, kernel)
        routes[kernel] = rx.map_step.launches - b
        check(routes[kernel] == T, f"{kernel}: {routes[kernel]} map-step "
                                   f"launches for {T} frames")
        assert_same(k, replay(f, device, "xla"), f"{kernel} vs xla")
    say("kernel_vs_plain", kernel="map_step", cases=list(cases),
        B=1024, bit_equal=True, launches=launches,
        per_frame_routes_equal_xla=list(routes), route_launches=routes)


SWARM_TOL = 1e-4      # tests/test_torch_simulator.py: poses and EKF means


def phase_swarm_vs_jax(device) -> None:
    """The committed JAX small swarm (bench.py's swarm at B=8, T=1000,
    its start state and its 10 scan ticks' draws) on the card: the
    behaviour-state and cmd_kind traces, grids and frontier scores equal,
    true poses and EKF means within SWARM_TOL."""
    world, st, draws, ref = testdata.swarm_small(device)
    before = rx.map_step.launches
    fin, diag = sim.sim_run(st, world, testdata.SWARM_T, UL_PROFILE,
                            record=True, draws=draws, **testdata.SWARM_RUN)
    n = rx.map_step.launches - before
    host = lambda v: v.cpu().numpy()                                 # noqa: E731
    equal = {
        "state": np.array_equal(host(diag["state"]), ref["state"]),
        "cmd_kind": np.array_equal(host(diag["cmd_kind"]), ref["cmd_kind"]),
        "grid": np.array_equal(host(fin.mapper.grid), ref["grid"]),
        "frontier": np.array_equal(host(fin.frontier), ref["frontier"]),
        "scan_count": fin.scan_count == int(ref["scan_count"])}
    errs = {k: float(np.abs(host(getattr(fin, k)) - ref[k]).max())
            for k in ("x", "y", "yaw")}
    errs["ekf_mean"] = float(np.abs(host(fin.ekf.mean)
                                    - ref["ekf_mean"]).max())
    say("swarm_vs_jax", B=st.x.shape[0], T=testdata.SWARM_T, equal=equal,
        max_abs_err=errs, tolerance=SWARM_TOL, map_step_launches=n)
    check(all(equal.values()), f"swarm vs the JAX package: {equal}")
    check(max(errs.values()) <= SWARM_TOL, f"swarm floats off: {errs}")
    check(n == fin.scan_count == 10, f"{n} map-step launches")


def _run_swarm(world, st):
    fin, diag = sim.sim_run(st, world, testdata.SWARM_T, UL_PROFILE,
                            **testdata.SWARM_RUN)
    torch.cuda.synchronize()
    return fin, diag


def _bench_swarm_keeping_map_steps(world, st0, reps: int):
    """bench.bench_swarm (a warm-up run, then `reps` timed runs) with the
    simulator's map_step wrapped to keep the first run's scan ticks'
    operands (the launches still count): (line, fin, diag, [(grids
    before, [beams .. enabled])]).  Only the warm-up clones."""
    ticks = []
    real = sim.map_step
    n_scans = (testdata.SWARM_T * testdata.SWARM_RUN["dt_ms"]
               // testdata.SWARM_RUN["scan_period_ms"])

    def keep(grids, *args):
        if len(ticks) < n_scans:
            ticks.append((grids.clone(), [a.clone() for a in args[:7]]))
        return real(grids, *args)

    sim.map_step = keep
    try:
        line, (fin, diag) = bench.bench_swarm(
            testdata.SWARM_B, testdata.SWARM_T, reps, st0.x.device,
            start=(world, st0))
    finally:
        sim.map_step = real
    return line, fin, diag, ticks


def _map_step_alone(ticks) -> dict:
    """The map-step kernel on the bench run's own scan ticks against its
    plain version (max abs error, plain ms per tick by CUDA events) and
    its bound per launch: the words read once, each touched 32-byte grid
    sector read and written once, and EXACT_CELL_OPS int32 operations per
    ray cell and EXACT_RAY_OPS per valid ray, averaged over the ticks."""
    err, plain, bounds, nbytes, ops = 0, [], [], 0, 0
    for g0, args in ticks:
        gk, gp = g0.clone(), g0.clone()
        rx.map_step(gk, *args, UL_PROFILE)
        plain.append(_time_call(lambda: rx.map_step_plain(gp, *args,
                                                          UL_PROFILE),
                                1, lambda: gp.copy_(g0)))
        err = max(err, int((gk.to(torch.int16) - gp.to(torch.int16))
                           .abs().max()))
        words = rx._step_words(*args, UL_PROFILE, GEOM)
        sectors, cells, rays = _exact_touched(words[:, None])
        b = words.numel() * words.element_size() + 2 * 32 * sectors
        o = _exact_int_ops(cells, rays)
        bounds.append(max(b / HBM_BYTES_PER_S, o / INT32_OPS_PER_S) * 1e3)
        nbytes += b
        ops += o
    by = ("bytes" if nbytes / HBM_BYTES_PER_S >= ops / INT32_OPS_PER_S
          else "operations")
    return {"max_abs_err": err, "plain_ms": sum(plain) / len(plain),
            "bound_ms": sum(bounds) / len(bounds), "bound_by": by,
            "bound_bytes_per_tick": nbytes / len(ticks),
            "bound_ops_per_tick": ops / len(ticks), "ticks": len(ticks)}


def phase_swarm_bench(device, smi: str, reps: int = 2) -> dict:
    """bench.py's swarm line (bench.py:45-81) on the card: B=1024 quads,
    T=1000 control ticks at 1 kHz, a scan every 100 ms, the airborne
    start; best of `reps` after a warm-up, timed by the port's bench
    entry (bench.bench_swarm).  The checksum and every quad's
    grid sum must equal the port's committed CPU run (swarm_bench_ref);
    the TPU record drew its noise from jax.random, another generator.
    Returns the map-step kernel's entry of the kernels line."""
    world, st0, _ = testdata.swarm_bench(device=device)
    B, T = testdata.SWARM_B, testdata.SWARM_T
    torch.cuda.synchronize()
    reset_launches()                      # count this path's runs only
    # the warm-up run also keeps the scan ticks' operands for the kernel's
    # own check, time and bound (_map_step_alone)
    line, fin, diag, ticks = _bench_swarm_keeping_map_steps(world, st0, reps)
    times = line["rep_seconds"]
    n_launch = launches()
    runs = reps + 1
    check(n_launch["map_step"] == 10 * runs,
          f"the swarm launched map_step {n_launch['map_step']} times in "
          f"{runs} runs")
    ref = testdata.reference("swarm_bench_ref")
    sums = testdata.grid_sums(fin.mapper.grid.cpu().numpy())["sums"]
    ck = testdata.int32_total(sums)
    check(np.array_equal(sums, ref["sums"]),
          f"swarm per-quad grid sums differ from the port's CPU run in "
          f"{int((sums != ref['sums']).sum())} quads")
    check(ck == int(ref["checksum"]) == line["checksum"],
          f"swarm checksum {ck}")
    check(int((fin.mapper.grid != 0).sum()) > 100 * B, "the swarm mapped "
                                                        "nothing")
    dt = min(times)
    busy = _profiled_busy(lambda: _run_swarm(world, st0), ("map_step",))
    key = next(k for k in busy["kernel_device_ms"] if "map_step" in k)
    profiled = busy["kernel_launches"][key]
    ms = busy["kernel_device_ms"][key] / profiled
    states = np.bincount(diag["state"][-1].cpu().numpy(), minlength=10)
    say("bench", metric=METRIC["swarm"], value=B * T / dt,
        unit="quad-ticks/s", bench_line=line, checksum=ck,
        checksum_port_cpu=int(ref["checksum"]),
        per_quad_sums_equal_port_cpu=True,
        checksum_tpu_record=CHECKSUM_REF["swarm"],
        checksum_tpu_record_note="drawn by jax.random, another generator",
        launches={k: v for k, v in n_launch.items() if v},
        launches_per_run=n_launch["map_step"] / runs, rep_seconds=times,
        device_busy_ms=busy["busy_ms"], device_ops=busy["device_ops"],
        kernel_device_ms=busy["kernel_device_ms"],
        kernel_launches=busy["kernel_launches"],
        host_total=busy["host_total"],
        profiled_wall_s=busy["profiled_wall_s"],
        device_idle_share=(None if busy["busy_ms"] is None
                           else 1 - busy["busy_ms"] / (dt * 1e3)),
        final_state_counts=states.tolist(), B=B, T=T, reps=reps,
        dt_ms=testdata.SWARM_RUN["dt_ms"], card=smi)
    alone = _map_step_alone(ticks)
    check(alone["max_abs_err"] == 0,
          f"map_step vs plain max abs err {alone['max_abs_err']}")
    say("kernel_alone", kernel="map_step", ms=ms,
        ms_profiled_launches=profiled, **alone, card=smi)
    return {"name": "map_step", "route": "cuda", **KERNELS["map_step"],
            "launches": n_launch["map_step"],
            "max_abs_err": alone["max_abs_err"], "ms": ms,
            "plain_ms": alone["plain_ms"], "bound_ms": alone["bound_ms"],
            "bound_by": alone["bound_by"], "library_ms": None,
            "also_serves": ["micro_quad_slam_tpu/ops/pallas_raycast.py:98",
                            "micro_quad_slam_tpu/ops/pallas_raycast.py:212"]}


# ------------------------------------------------------------------ wire

def _flat_state(d: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out.update(_flat_state(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _path_launches(expect: dict, what: str) -> dict:
    """The launch counts since the last reset_launches(): each kernel
    named in `expect` launched as often as its value says (None: at least
    once), every other kernel never."""
    torch.cuda.synchronize()
    n = launches()
    for k, v in n.items():
        want = expect.get(k, 0)
        check(v >= 1 if want is None else v == want,
              f"{what} launched {k} {v} times, not "
              f"{'at least once' if want is None else want}")
    return {k: v for k, v in n.items() if v}


def _wire_replays(device, cap, log) -> dict:
    """replay_wirecap of the capture through both whole-replay kernels,
    each launching its kernel once and no other (counted around that call
    alone), each grid against the card's scanlog replay of the log as the
    wire carries it, and against the JAX package's CPU grid (wire_ref)."""
    import dataclasses

    from micro_quad_slam_tpu_torch.replay import livestream as ls

    ref = testdata.reference("wire_ref")
    wire_log = port.scanlog_to_arrays(
        dataclasses.replace(log, grid_mm=ls.wire_mm(log.grid_mm)))
    plain_log = port.scanlog_to_arrays(log)
    out = {}
    for kernel, key, name in (("residentx", "exact_grid", "replay_exact"),
                              ("hybridx", "hybrid_grid", "replay_cone")):
        torch.cuda.synchronize()
        reset_launches()                  # count this replay_wirecap only
        t0 = time.perf_counter()
        st, outs, n = ls.replay_wirecap(cap, UL_PROFILE, kernel=kernel,
                                        device=device)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = _path_launches({name: 1}, f"replay_wirecap({kernel})")
        grid = port.logical_grid(st.grid).cpu().numpy()
        scan = {}
        for name, f in (("wire", wire_log), ("plain", plain_log)):
            sst, _ = replay({k: v[None] for k, v in f.items()}, device,
                            kernel)
            scan[name] = port.logical_grid(sst.grid[0]).cpu().numpy()
        jax_diff = int((grid != ref[key]).sum())
        log_diff = int((grid != scan["wire"]).sum())
        check(n == 256 and jax_diff == 0,
              f"wire {kernel}: {jax_diff} cells differ from the JAX "
              f"package's CPU grid")
        check(log_diff == 0, f"wire {kernel}: {log_diff} cells differ from "
                             f"the scanlog replay of the same log")
        check(int(outs["used"].sum()) > 200, f"wire {kernel}: frames used")
        out[kernel] = {"frames": n, "seconds": secs, "launches": counts,
                       "equal_jax_cpu_grid": True,
                       "equal_scanlog_replay": True,
                       "cells_differing_from_the_log_before_the_0xA6_nudge":
                           int((grid != scan["plain"]).sum()),
                       "occupied": int((grid > 10).sum()),
                       "free": int((grid < -10).sum())}
    return out


def _wire_slam(device, cap) -> dict:
    """slam_replay of the capture's frames against the JAX package's CPU
    SLAM of them (wire_ref), within phase_slam_vs_jax's tolerances; the
    SLAM kernels and the exact kernel's pass 3 must launch in that call."""
    from micro_quad_slam_tpu_torch.replay import livestream as ls

    ref = testdata.reference("wire_ref")
    frames = port.frames_to_torch(
        {k: v[None] for k, v in ls.wirecap_to_frames(cap).items()}, device)
    torch.cuda.synchronize()
    reset_launches()                      # count this slam_replay only
    t0 = time.perf_counter()
    res = sp.slam_replay(frames, UL_PROFILE)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = _path_launches({"match_lattice": None, "replay_exact_snap": None,
                             "replay_exact": 1}, "the wire slam_replay")
    errs = {k: max(_track_err(getattr(res, k), ref[f"slam_{k}"]))
            for k in ("odo_track", "kf_nodes", "track")}
    sums = testdata.grid_sums(res.grid.cpu().numpy())
    for k, tol in (("odo_track", 1e-5), ("kf_nodes", 1e-4), ("track", 1e-4)):
        check(errs[k] <= tol, f"wire slam: {k} off by {errs[k]}")
    for k in ("sums", "weighted"):
        check(np.array_equal(sums[k], ref[f"slam_{k}"]),
              f"wire slam: grid {k} differ from the JAX package's")
    return {"seconds": secs, "launches": counts, "max_abs_err": errs,
            "grid_sums": sums["sums"].tolist(), "grid_sums_equal_jax": True}


def _checkpoint_split(device, tmp: Path, B: int = 1024, T: int = 256) -> dict:
    """The residentx bench workload replayed as T/2 frames, a checkpoint
    written by save_checkpoint and read back, and the other T/2 frames."""
    from micro_quad_slam_tpu_torch.utils import checkpoint as ck

    frames = testdata.bench_frames(B)
    h = T // 2
    t0 = time.perf_counter()
    st, _ = replay({k: v[:, :h] for k, v in frames.items()}, device,
                   "residentx")
    path = ck.save_checkpoint(str(tmp / "replay"),
                              port.mapping_state_to_numpy(st), step=h)
    back = port.mapping_state_from_numpy(
        ck.restore_checkpoint(ck.latest_checkpoint(str(tmp / "replay"))),
        device)
    st, _ = replay({k: v[:, h:] for k, v in frames.items()}, device,
                   "residentx", state0=back)
    ck_sum = checksum(st.grid)
    secs = time.perf_counter() - t0
    want = CHECKSUM_REF["residentx_off_tpu"]
    check(ck_sum == want, f"split bench replay checksum {ck_sum} != {want}")
    return {"B": B, "T": T, "split": h, "checksum": ck_sum,
            "checkpoint_bytes": Path(path).stat().st_size, "seconds": secs}


def _swarm_resume(device, tmp: Path, half: int = 100) -> dict:
    """The bench swarm (B=1024) for 2 x `half` ticks unbroken, and as
    `half` ticks, a checkpoint (the state and its generator) written and
    read back, and `half` more: every field equal, on every quad."""
    from micro_quad_slam_tpu_torch.utils import checkpoint as ck

    world, st0, _ = testdata.swarm_bench(device=device)
    run = lambda st, n: sim.sim_run(st, world, n, UL_PROFILE,   # noqa: E731
                                    **testdata.SWARM_RUN)[0]
    t0 = time.perf_counter()
    full = run(st0, 2 * half)
    part = run(st0, half)
    ck.save_checkpoint(str(tmp / "sim"), {
        **sim.sim_state_to_numpy(part), "gen": part.gen.get_state().numpy()},
        step=half)
    back = sim.sim_state_from_numpy(
        ck.restore_checkpoint(ck.latest_checkpoint(str(tmp / "sim"))),
        device)
    resumed = run(back, half)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    a = _flat_state(sim.sim_state_to_numpy(resumed))
    b = _flat_state(sim.sim_state_to_numpy(full))
    differ = sorted(k for k in b if not np.array_equal(a[k], b[k],
                                                       equal_nan=True))
    quads = int(np.all(a["mapper.grid"] == b["mapper.grid"],
                       axis=(1, 2)).sum())
    B = testdata.SWARM_B
    check(not differ and quads == B and resumed.scan_count == 2
          and torch.equal(resumed.gen.get_state(), full.gen.get_state()),
          f"swarm resume differs in {differ}, {B - quads} quads' grids")
    return {"B": B, "ticks": [half, half], "scan_ticks": resumed.scan_count,
            "quads_equal": quads, "fields_equal": len(b), "seconds": secs}


def _cli_wire_replay(tmp: Path, cap) -> dict:
    """`python -m micro_quad_slam_tpu_torch replay --wirecap ... --kernel
    residentx --device cuda` as a subprocess."""
    from micro_quad_slam_tpu_torch.formats.wirecap import write_wirecap

    path = tmp / "wire.cap"
    write_wirecap(str(path), cap)
    root = Path(__file__).resolve().parent
    cmd = [sys.executable, "-m", "micro_quad_slam_tpu_torch", "replay",
           "--wirecap", str(path), "--kernel", "residentx", "--device",
           "cuda"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300,
                          cwd=root)
    secs = time.perf_counter() - t0
    check(proc.returncode == 0, f"the CLI's wire replay exited "
                                f"{proc.returncode}: {proc.stderr[-2000:]}")
    return {"rc": proc.returncode, "stdout": proc.stdout.strip(),
            "seconds": secs}


def phase_wire(device, smi: str) -> None:
    """The live-topology path at full width: the first SLAM bench flight
    as a T=256 dual-UART capture (scanlog_to_wirecap), replayed through
    replay_wirecap with the exact and the cone kernel, and its frames
    through slam_replay; the four kernels of the path must launch.  Then
    a checkpoint round trip inside the residentx bench replay, a swarm
    resumed from a checkpoint, and the CLI's wire replay."""
    import shutil
    import tempfile

    from micro_quad_slam_tpu_torch.replay import livestream as ls

    log = testdata.wire_flight()
    committed, _ = testdata.load("slam_bench_flights")
    flight = port.scanlog_to_arrays(log)
    check(all(np.array_equal(v, committed[k][0]) for k, v in flight.items()),
          "the wire flight is not the first SLAM bench flight")
    cap = ls.scanlog_to_wirecap(log)
    check(np.array_equal(ls.wirecap_to_frames(cap)["grid_mm"],
                         ls.wire_mm(log.grid_mm)),
          "the capture's millimetres")
    replays = _wire_replays(device, cap, log)
    slam = _wire_slam(device, cap)
    say("wire_replay", records=len(cap), kernels=replays, card=smi)
    say("wire_slam", **slam, card=smi)
    say("wire_launches", **{f"replay_wirecap_{k}": v["launches"]
                            for k, v in replays.items()},
        slam_replay=slam["launches"])
    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="wire_", dir=build))
    try:
        say("checkpoint_split", **_checkpoint_split(device, tmp), card=smi)
        say("swarm_resume", **_swarm_resume(device, tmp), card=smi)
        say("cli_wire_replay", **_cli_wire_replay(tmp, cap), card=smi)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# pass 1's feedback formulations (tests/test_torch_testdata.py FB_FORMS)
FB_FORMS = {"fb": {"match_feedback": True},
            "all": {"match_map_kf_only": False}}
FB_POSE_TOL = 1e-6    # the feedback pass on the recentering flight
# A feedback run carries each keyframe's correction into the map that
# later keyframes match, so an ulp apart can move a lattice peak or a ray's
# cell and part a flight by centimetres (ROADMAP section C).  Every float
# step of the SLAM path rounds on the card as on the CPU (division by a
# tensor, the pose graph's chained normal equations, correctly rounded
# sqrt), and the CPU run agrees with the JAX package's on every bench
# flight (tests/test_torch_slam_feedback.py), so the card's run must too.
SLAM_TOL = {"odo_track": 1e-5, "kf_nodes": 1e-4, "track": 1e-4}


def _formulation(cfg, form: str, **extra):
    import dataclasses

    return dataclasses.replace(cfg, slam=dataclasses.replace(
        cfg.slam, **FB_FORMS[form], **extra))


def _fb_launches(T: int, cfg) -> dict:
    """The feedback SLAM's kernel launches, from the pipeline's loops:
    pass 1 launches the lattice kernel and the exact kernel once per chunk
    of match_chunk_intervals keyframe intervals in each of slam_outer
    rounds, and pass 3 the exact kernel once; the loop stage launches the
    lattice kernel once, and once per refine round (loop_refine_early in
    the rounds before the last, loop_refine in the last)."""
    s = cfg.slam
    chunks = -(-T // (s.kf_every * max(int(s.match_chunk_intervals), 1)))
    rounds = max(int(s.slam_outer), 1)
    early = (s.loop_refine_early if int(s.loop_refine_early) >= 0
             else s.loop_refine)
    loop = (rounds - 1) * (1 + max(int(early), 0)) + 1 + max(
        int(s.loop_refine), 0)
    return {"match_lattice": chunks * rounds + loop,
            "replay_exact": chunks * rounds + 1}


class _PlainKernels:
    """Within the block, the SLAM path's kernel wrappers run their plain
    versions on the card (the pipeline reaches them through these module
    names): the twin run of phase_slam_feedback."""

    def __enter__(self):
        self.saved = (sm.match_lattice, rx.replay_exact)
        sm.match_lattice = ml.match_lattice_plain
        rx.replay_exact = rx.replay_exact_plain

    def __exit__(self, *exc):
        sm.match_lattice, rx.replay_exact = self.saved


def _fb_vs_ref(res, ref: dict, form: str) -> dict:
    """A feedback SLAM run of the 4 bench flights replicated to B against
    the JAX package's CPU run of them (slam_fb_ref): every replica within
    SLAM_TOL, every grid sum and weighted sum equal."""
    B = res.grid.shape[0]
    tile = lambda a: np.concatenate([a] * (B // 4))                  # noqa: E731
    errs = {k: float(np.abs(getattr(res, k).cpu().numpy().astype(np.float64)
                            - tile(ref[f"{form}_{k}"])).max())
            for k in SLAM_TOL}
    sums = testdata.grid_sums(res.grid.cpu().numpy())
    for k, tol in SLAM_TOL.items():
        check(errs[k] <= tol, f"slam {form}: {k} off the JAX package's by "
                              f"{errs[k]}")
    for k in ("sums", "weighted"):
        diff = np.nonzero(sums[k] != tile(ref[f"{form}_{k}"]))[0]
        check(diff.size == 0, f"slam {form}: grid {k} differ from the JAX "
                              f"package's in replicas {diff.tolist()}")
    return {"max_abs_err": errs, "grid_sums": sums["sums"][:4].tolist(),
            "grid_sums_equal_jax": True}


def _fb_pass1(frames: dict, ref: dict, form: str) -> dict:
    """slam_replay's first pass 1 alone at the frames' width, fed the JAX
    package's odometry and schedule of the 4 bench flights replicated
    (slam_fb_ref pass1_*): every grid equal to the JAX package's
    sequential pass, matched poses within FB_POSE_TOL; one lattice and
    one exact-kernel launch per chunk."""
    from micro_quad_slam_tpu_torch.ops.beams import extract_beams

    B, T = frames["x_m"].shape
    cfg = _formulation(UL_PROFILE, form)
    dev = frames["x_m"].device
    tile = lambda a: torch.from_numpy(                               # noqa: E731
        np.concatenate([a] * (B // 4))).to(dev)
    beams, _ = extract_beams(frames["grid_mm"], cfg.tof)
    sched = {k[12:]: tile(v) for k, v in ref.items()
             if k.startswith("pass1_sched_")}
    torch.cuda.synchronize()
    reset_launches()
    grid, matched = sp._map_pass_fb(beams, tile(ref["pass1_odo"]), cfg,
                                    GEOM, cfg.slam.kf_every, sched)
    chunks = -(-T // (cfg.slam.kf_every * cfg.slam.match_chunk_intervals))
    counts = _path_launches({"match_lattice": chunks,
                             "replay_exact": chunks}, f"the {form} pass 1")
    cells = int((grid != tile(ref[f"pass1_{form}_grid"])).sum())
    err = float((matched - tile(ref[f"pass1_{form}_matched"])).abs().max())
    check(cells == 0, f"pass 1 {form}: {cells} cells differ")
    check(err <= FB_POSE_TOL, f"pass 1 {form}: poses off by {err}")
    return {"cells_differing": cells, "max_abs_err": err,
            "launches": counts}


def phase_slam_feedback(device, smi: str, B: int = 128, T: int = 256,
                        reps: int = 2) -> None:
    """slam_replay with pass 1's feedback formulations at full width (the
    4 SLAM bench flights replicated to B=128, T=256, UL profile):
    match_feedback=True, then match_map_kf_only=False.  Its first pass 1
    alone equals the JAX package's sequential pass (_fb_pass1).  Each
    run's launches are counted (zeroed just before, read just after) and
    held to _fb_launches; each is bit-equal to the same run with the
    kernels' plain versions on the card, and agrees with the JAX
    package's CPU run on every flight (slam_fb_ref, _fb_vs_ref); then
    `reps` timed runs give frames/s, and one more the seconds per
    stage."""
    ref = testdata.reference("slam_fb_ref")
    frames = testdata.slam_bench_frames(B, T, device=device)
    for form in FB_FORMS:
        cfg = _formulation(UL_PROFILE, form)
        pass1 = _fb_pass1(frames, ref, form)
        want = _fb_launches(T, cfg)
        torch.cuda.synchronize()
        reset_launches()                  # count this slam_replay only
        res = sp.slam_replay(frames, cfg)
        counts = _path_launches(want, f"the {form} slam_replay")
        with _PlainKernels():
            plain = sp.slam_replay(frames, cfg)
        torch.cuda.synchronize()
        same = {k: bool(torch.equal(getattr(res, k), getattr(plain, k)))
                for k in ("grid", "track", "kf_nodes", "odo_track")}
        check(all(same.values()), f"slam {form}: kernels vs plain {same}")
        vs = _fb_vs_ref(res, ref, form)
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sp.slam_replay(frames, cfg)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        say("slam_feedback", formulation=form, B=B, T=T, pass1=pass1,
            launches=counts, launches_expected=want,
            kernels_equal_plain=same, **vs, rep_seconds=times,
            frames_per_s=B * T / min(times),
            stage_seconds=_stage_seconds(frames, cfg, reps=1), card=smi)


def phase_slam_chunked_vs_sequential(device) -> None:
    """TPUCHECK's slam_chunked_vs_sequential on the card: the port's
    feedback pass (one lattice and one exact-kernel launch per chunk) on
    the recentering flight of tests/test_slam.py:593 (B=4, T=64,
    kf_every 8, a -20 flow excursion; gate 0.05), fed the JAX package's
    odometry and schedule, against its sequential pass (slam_fb_ref
    rc_*): grids equal, matched poses within FB_POSE_TOL."""
    from micro_quad_slam_tpu_torch.ops.beams import extract_beams

    ref = testdata.reference("slam_fb_ref")
    frames = port.frames_to_torch({k[6:]: v for k, v in ref.items()
                                   if k.startswith("rc_in_")}, device)
    odo = torch.from_numpy(ref["rc_odo"]).to(device)
    sched = {k[9:]: torch.from_numpy(v).to(device) for k, v in ref.items()
             if k.startswith("rc_sched_")}
    check(int(sched["do"].sum()) >= 1, "the recentering flight recenters")
    out = {}
    for form in FB_FORMS:
        cfg = _formulation(UL_PROFILE, form, match_min_quality=0.05)
        beams, _ = extract_beams(frames["grid_mm"], cfg.tof)
        torch.cuda.synchronize()
        reset_launches()
        grid, matched = sp._map_pass_fb(beams, odo, cfg, GEOM, 8, sched)
        chunks = -(-odo.shape[1] // (8 * cfg.slam.match_chunk_intervals))
        counts = _path_launches({"match_lattice": chunks,
                                 "replay_exact": chunks},
                                f"the {form} feedback pass")
        cells = int((grid.cpu().numpy() != ref[f"rc_{form}_grid"]).sum())
        err = float(np.abs(matched.cpu().numpy()
                           - ref[f"rc_{form}_matched"]).max())
        check(cells == 0, f"chunked {form}: {cells} cells differ")
        check(err <= FB_POSE_TOL, f"chunked {form}: poses off by {err}")
        out[form] = {"cells_differing": cells, "max_abs_err": err,
                     "launches": counts}
    say("slam_chunked_vs_sequential", recenters=int(sched["do"].sum()),
        tolerance=FB_POSE_TOL, **out)


def phase_sharded(device, smi: str, swarm_ticks: int = 100, B: int = 1024,
                  slam_B: int = 128) -> None:
    """The sharded entries (parallel/mesh.py) over ["cuda:0", "cuda:0"]:
    one card shows the split only with a repeated device, not two cards
    at once.  Each against the unsharded run, bit for bit: the bench
    replay (B=1024 x T=256) through residentx and hybridx with their
    checksums, the dry run's recentering case, the EKF fusion at B=1024,
    the UL SLAM at B=128 and the bench swarm for `swarm_ticks` ticks
    (every quad, and the generator's state)."""
    from micro_quad_slam_tpu_torch.parallel import dryrun, mesh
    from micro_quad_slam_tpu_torch.replay.fusion import replay_fusion_batched

    devices = [device, device]
    out = {}
    frames = testdata.bench_frames(B, 256)
    for kernel in ("residentx", "hybridx"):
        t0 = time.perf_counter()
        st, outs, metrics = mesh.replay_mapping_sharded(
            frames, UL_PROFILE, devices, kernel=kernel)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        st_un, outs_un = replay(frames, device, kernel)
        dryrun._equal((st, outs), (st_un, outs_un), f"sharded {kernel}")
        ck = checksum(st.grid)
        want = CHECKSUM_REF["residentx_off_tpu" if kernel == "residentx"
                            else "hybridx"]
        check(ck == want or B != 1024,
              f"sharded {kernel} checksum {ck} != {want}")
        out[kernel] = {"checksum": ck, "seconds": secs,
                       "frames_used": int(metrics["frames_used"])}
    out["recentering"] = dryrun.recentering_case(devices)
    sb = testdata.slam_bench_frames(B, device="cpu")
    got = mesh.replay_fusion_sharded(sb, UL_PROFILE, devices)
    dryrun._equal(got, replay_fusion_batched(
        port.frames_to_torch({k: v.numpy() for k, v in sb.items()}, device),
        UL_PROFILE), "sharded fusion")
    s128 = {k: v[:slam_B] for k, v in sb.items()}
    got = mesh.slam_replay_sharded(s128, UL_PROFILE, devices)
    want = sp.slam_replay(port.frames_to_torch(
        {k: v.numpy() for k, v in s128.items()}, device), UL_PROFILE)
    dryrun._equal(got, want, "sharded slam")
    out["slam"] = {"B": slam_B, "bit_equal": True}
    world, st0, _ = testdata.swarm_bench(device=device, B=B)
    t0 = time.perf_counter()
    fin, diag = mesh.sim_run_sharded(st0, world, swarm_ticks, UL_PROFILE,
                                     devices, **testdata.SWARM_RUN)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    want, wdiag = sim.sim_run(st0, world, swarm_ticks, UL_PROFILE,
                              **testdata.SWARM_RUN)
    dryrun._equal((fin._replace(gen=None), diag),
                  (want._replace(gen=None), wdiag), "sharded swarm")
    check(torch.equal(fin.gen.get_state(), want.gen.get_state()),
          "sharded swarm: the generator's state")
    out["swarm"] = {"B": int(st0.x.shape[0]), "ticks": swarm_ticks,
                    "scan_ticks": fin.scan_count, "seconds": secs}
    say("sharded", devices=[str(d) for d in devices], fusion_B=B, **out,
        card=smi)


def phase_behavior_cl(device, B: int = 1024) -> None:
    """The CL machine (models/behavior_cl.py, no kernel) on the card: B
    quads on the committed fuzzed schedules (cl_fuzz_telemetry tiled),
    every output of every tick equal to the same run on the CPU."""
    from micro_quad_slam_tpu_torch.models import behavior_cl as bcl

    def run(dev):
        tm = testdata.cl_fuzz(B, dev)
        st = bcl.behavior_cl_init(B, dev)
        outs = []
        t0 = time.perf_counter()
        for i in range(tm["t_ms"].shape[0]):
            st, o = bcl.behavior_step_cl(st, {k: v[i] for k, v in
                                              tm.items()}, port.CL_PROFILE)
            outs.append(o)
        got = {k: torch.stack([o[k] for o in outs]).cpu().numpy()
               for k in outs[0]}
        return got, st, time.perf_counter() - t0

    got, st, secs = run(device)
    want, st_cpu, cpu_secs = run(torch.device("cpu"))
    differ = [k for k in want if not np.array_equal(got[k], want[k],
                                                     equal_nan=True)]
    differ += [f"state.{k}" for k, v in st_cpu._asdict().items()
               if not np.array_equal(getattr(st, k).cpu().numpy(),
                                     v.numpy(), equal_nan=True)]
    check(not differ, f"behavior_cl on the card differs from the CPU: "
                      f"{differ}")
    states = np.unique(got["state"]).tolist()
    check(len(states) >= 5, f"the fuzzed schedules reach {states}")
    say("behavior_cl", B=B, ticks=int(got["state"].shape[0]),
        equal_cpu=True, states_reached=states, card_seconds=secs,
        cpu_seconds=cpu_secs)


def phase_native_io(tmp_dir: Path) -> None:
    """The native scanlog reader (io/native.py) builds with this machine's
    g++ and reads the SLAM bench flight equal, field by field, to the
    Python reader; no give-way to the Python codec here."""
    import dataclasses

    from micro_quad_slam_tpu_torch.formats.scanlog import (
        read_scanlog, write_scanlog)
    from micro_quad_slam_tpu_torch.io import native

    t0 = time.perf_counter()
    ok = native.native_available()
    build_s = time.perf_counter() - t0
    check(ok, "the native scanlog reader did not build (g++)")
    log_path = tmp_dir / "bench_flight.bin"
    write_scanlog(str(log_path), testdata.wire_flight())
    t0 = time.perf_counter()
    got = native.read_scanlog_native(str(log_path))
    native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = read_scanlog(str(log_path))
    python_s = time.perf_counter() - t0
    fields = [f.name for f in dataclasses.fields(want)]
    differ = [k for k in fields
              if not np.array_equal(getattr(got, k), getattr(want, k))
              or getattr(got, k).dtype != getattr(want, k).dtype]
    check(not differ and len(got) == 256, f"native read differs: {differ}")
    say("native_io", native_available=True, library=str(
        native._library_path().name), build_s=build_s, records=len(got),
        equal_python=True, native_read_s=native_s, python_read_s=python_s)


def _jax_package_loaded() -> list:
    return sorted(m for m in sys.modules
                  if m == "jax" or m.startswith("jax.")
                  or m == "micro_quad_slam_tpu"
                  or m.startswith("micro_quad_slam_tpu."))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    smi = phase_card()
    phase_build()
    phase_kernel_vs_plain(device)
    phase_cone_kernel_vs_plain(device)
    phase_slam_kernels_vs_plain(device)
    phase_map_step_vs_plain(device)
    phase_golden(device)
    phase_resume(device)
    phase_slam_vs_jax(device)
    phase_swarm_vs_jax(device)
    phase_wire(device, smi)
    phase_slam_chunked_vs_sequential(device)
    phase_slam_feedback(device, smi)
    phase_sharded(device, smi)
    phase_behavior_cl(device)
    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    phase_native_io(build)
    kernels = [phase_bench(device, smi, "residentx"),
               phase_bench(device, smi, "hybridx", plain_reps=1)]
    slam = phase_slam_bench(device, smi, "ul", 128)
    phase_slam_bench(device, smi, "rt", 256)
    phase_ekf_bench(device, smi)
    kernels += [slam["match_lattice"], slam["replay_exact_snap"],
                phase_swarm_bench(device, smi)]
    loaded = _jax_package_loaded()
    check(not loaded, f"the port imported jax or the JAX package: {loaded}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
