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
     together, with their seconds;
  3. exact kernel == plain torch on the card, bit for bit (grid, origins,
     used, kf_flags, filt), on random flights with recenters, a saturating
     endpoint, a recenter inside a run of gated frames and short beams;
     then the same for the cone kernel in both modes (conex == cone,
     hybridx == hybrid), and hybridx == the JAX package's hybrid grids
     of the random flights; then the lattice kernel == its plain version
     at the SLAM path's two slab shapes and match counts, and the
     snapshot and scheduled-chunk entries == theirs, with recenters; then
     the map-step entry == its plain version at B=1024 (random grids,
     NaN beams, a disabled quad, poses at the grid edge; a saturating
     endpoint; the short beams), and mapping_step(kernel="pallas" and
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
     cone kernel is also timed in cone mode); the SLAM bench, UL_PROFILE at
     B=128 and UL_RT_PROFILE at B=256, T=256 (frames/s, checksum, per-stage
     seconds, launches, device busy and idle share, and the lattice kernel
     and snapshot entry alone against their plain versions and bounds);
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
     and its bound on the run's own scan ticks.

It imports the port and numpy only: the inputs and reference results are
committed files of the port (micro_quad_slam_tpu_torch/testdata).

The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.  Exits non-zero on any failure, without a
CUDA device, or outside the repository.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

import micro_quad_slam_tpu_torch as port
from micro_quad_slam_tpu_torch import testdata
from micro_quad_slam_tpu_torch.ops import _build
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
                "swarm": -8944084}
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
# (float, int32) operations per classified cell, counted from
# replay_cone.cu's cone_delta and the clip.  Float: the cell vector (2
# adds), the quadrant tests (4 products, 4 compares), the rotation into
# the quadrant (4 selects), the column search (4 x (2 products +
# compare)), the sector's return (compare), the squared radius (3), the
# free carve (sub, max, mul, square, 3 compares) and the delta's select
# = 38; cone mode adds the occupied band (sub, max, mul, add, mul, 2
# squares, 3 compares, select) = 49.  Int32: the sector index (4) and
# the clip (add, min, max) = 7.
CONE_CELL_OPS = {False: (49, 7), True: (38, 7)}
# int32 operations per cell of an exact ray (replay_exact.cu): the minor
# offset (2 products, add, divide), two selects, two signs, the address
# (2), the endpoint select, and the clip (add, min, max) = 14
EXACT_CELL_OPS = (0, 14)
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


def phase_build() -> None:
    t0 = time.perf_counter()
    built = _build.build_all(list(SOURCES))
    wall = time.perf_counter() - t0
    for name, info in built.items():
        ptxas = [ln.strip() for ln in info["log"].splitlines()
                 if "registers" in ln or "spill" in ln]
        say("build", kernel=name, target="sm_90a",
            flags=" ".join(_build.NVCC_FLAGS), seconds=info["seconds"],
            ptxas=ptxas)
    say("build_all", kernels=list(built), wall_seconds=wall)


def _cases() -> dict:
    return {"random_recenter": random_flights(),
            "saturating_endpoint": saturating_endpoint(),
            "recenter_in_gated_run": recenter_in_gated_run(),
            "short_beams": short_beams()}


def phase_kernel_vs_plain(device) -> None:
    before = rx.replay_exact.launches
    cases = _cases()
    for name, f in cases.items():
        k = replay(f, device, "residentx")
        assert_same(k, replay(f, device, "xla"), name)
        (st, outs) = k
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
        bit_equal=True, launches=launches)


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


def _time_replay(frames, kernel: str, reps: int):
    """End to end, schedule included, after one warm-up."""
    def run():
        st, outs = port.replay_mapping_batched(frames, UL_PROFILE,
                                               kernel=kernel)
        torch.cuda.synchronize()
        return st, outs
    state, outs = run()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        state, outs = run()
        times.append(time.perf_counter() - t0)
    return times, state, outs


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


def _time_queued(fn, n: int = 20) -> float:
    """ms per call of fn() over n calls queued back to back after one
    more, by CUDA events: the card's time per launch for a wrapper that
    does not wait for the card (its host work overlaps the kernels)."""
    fn()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(n):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / n


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


def _profiled_busy(fn, names) -> dict:
    """One call of fn under torch.profiler (host and device): the summed
    device time of every kernel, copy and fill it ran and their count, the
    device ms and launches of each kernel whose name holds one of
    `names`, the wall time of the profiled run, and the five host events
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
            "host_total": [[k, t / 1e6, c] for k, (t, c) in top],
            "profiled_wall_s": wall}


# ---------------------------------------------------------------- bounds

def _recentering_quads(sched) -> torch.Tensor:
    """bool [B]: quads with a recenter, whose whole grid is read and
    written."""
    return sched[..., rx.H_DO].any(dim=1)


def _exact_touched(sched, slab=None) -> tuple:
    """(distinct 32-byte grid sectors, cells) the exact kernel reads and
    writes for this schedule: the cells of every valid ray, and the whole
    grid of a quad that recenters; with slab = (rows, cols), also the
    snapshot slabs (header words H_R0S, H_C0S) the snapshot entry reads."""
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
    cells = 0
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
        mark[quad.expand_as(cell)[ok], (cell // 32)[ok]] = True
    return int(mark.sum()), cells


def _cone_touched(sched) -> tuple:
    """(distinct 32-byte grid sectors, classified cells) of the cone
    kernel for this schedule: every frame reads and writes its whole
    window, and classifies its cells inside the logical grid when it is
    enabled; a recentering quad's whole grid is read and written."""
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


def _bound(name: str, sched, hybrid: bool = False) -> dict:
    """The least time the card could take for the kernel's work on this
    schedule: the larger of its bytes (the schedule read once, each
    touched grid sector read once and written once) over the HBM rate
    and its operations over their dispatch rates: all of them over the
    dispatch rate, and the int32 ones alone over theirs."""
    if name == "replay_exact":
        sectors, cells = _exact_touched(sched)
        f_ops, i_ops = EXACT_CELL_OPS
    else:
        sectors, cells = _cone_touched(sched)
        f_ops, i_ops = CONE_CELL_OPS[hybrid]
    ops = cells * (f_ops + i_ops)
    nbytes = sched.numel() * sched.element_size() + 2 * 32 * sectors
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = max(ops / DISPATCH_OPS_PER_S, cells * i_ops / INT32_OPS_PER_S)
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_bytes": nbytes, "bound_ops": ops, "grid_sectors": sectors,
            "cells": cells}


# ----------------------------------------------------------------- bench

def phase_bench(device, smi: str, kernel: str, B: int = 1024, T: int = 256,
                reps: int = 3, plain_reps: int = 3) -> dict:
    """bench.py's line for `kernel` ("residentx" or "hybridx") on the
    card, then its CUDA kernel alone against its plain version.  Returns
    the kernel's entry of the kernels line."""
    name = "replay_exact" if kernel == "residentx" else "replay_cone"
    frames = port.frames_to_torch(testdata.bench_frames(B), device)
    check(frames["x_m"].shape == (B, T), "bench frames")
    torch.cuda.synchronize()

    reset_launches()                      # count this path's run only
    times_k, st_k, outs_k = _time_replay(frames, kernel, reps)
    n_launch = launches()
    metrics = port.batch_metrics(outs_k)
    sched_s = _time_schedule(frames, kernel, reps)
    busy = _device_busy(frames, kernel)
    times_p, st_p, outs_p = _time_replay(frames, PLAIN[kernel], plain_reps)
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
    say("bench", metric=METRIC[kernel],
        value=B * T / dt_k, unit="frames/s", kernel=kernel,
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


# ------------------------------------------------------------------ SLAM

def _random_slots(device, K: int = 8):
    """The committed random flights' every 8th frame as K keyframe slots,
    with a chunk-start recenter (flight 0, slot 4) and a mid-chunk one
    (flight 1, slot 2), on grids of random log-odds."""
    t = port.frames_to_torch(random_flights(), device)
    B = t["x_m"].shape[0]
    beams, _ = port.ops.extract_beams(t["grid_mm"], UL_PROFILE.tof)
    sel = slice(0, 8 * K, 8)
    x, y, yaw = t["x_m"][:, sel], t["y_m"][:, sel], t["yaw_deg"][:, sel]
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


def phase_slam_kernels_vs_plain(device) -> None:
    """The lattice kernel at both slab shapes and the bench's match counts,
    the snapshot entry and map_chunk_sched with recenters: each == its
    plain version, bit for bit."""
    before = launches()
    for N, shape, n_yaw, T in ((3584, (104, 256), 7, 7),
                               (9984, (96, 128), 5, 5)):
        args = _random_lattice(device, N, shape, n_yaw, T, N)
        got = ml.match_lattice(*args, n_yaw)
        check(torch.equal(got, ml.match_lattice_plain(*args, n_yaw)),
              f"match_lattice {shape} differs from its plain version")
    args, g0 = _random_slots(device)
    pcx, pcy = port.ops.world_to_cell(args[1], args[2], args[4], args[5],
                                      UL_PROFILE.map.res_m, 250, 250)
    wy0, wx0 = sm.window_origin(pcx, pcy, GEOM)
    got = rx.map_snap(g0, *args, wy0, wx0, 4, UL_PROFILE)
    want = rx.map_snap_plain(g0, *args, wy0, wx0, 4, UL_PROFILE)
    check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
          "map_snap differs from its plain version")
    check(not torch.equal(got[1][0, 4], got[1][0, 3]), "no chunk-start roll")
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
    check(n["match_lattice"] >= 2 and n["replay_exact_snap"] >= 1
          and n["replay_exact"] >= 1, f"launches {n}")
    say("kernel_vs_plain", kernel=["match_lattice", "replay_exact_snap",
                                   "replay_exact (map_chunk_sched)"],
        match_counts=[3584, 9984], slab_shapes=[[104, 256], [96, 128]],
        recenters=int(so["do"].sum()) + 2, bit_equal=True, launches=n)


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


def _lattice_operands(args, cfg, n_xy: int, n_yaw: int):
    """match_slabs' operands (slabs .. origin_y) -> the lattice kernel's
    (slabs, ry, rx, n_yaw), as match_slabs makes them."""
    slabs, r0s, c0s, *scan = args
    s = cfg.slam
    cells = sm._lattice_cells(*scan, cfg.map, cfg.tof, n_xy, n_yaw,
                              s.match_xy_step_m, s.match_yaw_step_deg)
    ry, rxi = sm.lattice_indices(cells, r0s, c0s, GEOM)
    return slabs, ry, rxi, n_yaw


def _slam_operands(frames, cfg):
    """The SLAM kernels' operands on this workload, made by the pipeline's
    own functions: the snapshot entry's (grids, sched, snaps, n_kf) and
    the lattice kernel's of the first pass-1 round (at the odometry), and
    the lattice kernel's of the last round's first loop stage (at its
    matched keyframes)."""
    s = cfg.slam
    B, T = frames["x_m"].shape
    odo, sched = sp._slam_impl(frames, cfg, GEOM, None, None, upto=0)
    beams, _ = port.ops.extract_beams(frames["grid_mm"], cfg.tof)
    sl = sp._kf_slots(beams, sched, s.kf_every, cfg)
    snap, match = sp._round_operands(sl, odo, s.kf_every, cfg, GEOM)
    zeros = torch.zeros((B, GEOM.prows, GEOM.pcols), dtype=torch.int8,
                        device=odo.device)
    snap_ops = rx._snap_operands(zeros, *snap, sl.n_kf, cfg, GEOM) + (
        sl.n_kf,)
    _, slabs = rx.map_snap(zeros, *snap, sl.n_kf, cfg, GEOM)
    pass1 = _lattice_operands([slabs.reshape((-1,) + slabs.shape[2:])]
                              + match, cfg, s.match_n_xy, s.match_n_yaw)
    kf = torch.arange(0, T, s.kf_every, device=odo.device)
    matched = sp._slam_impl(frames, cfg, GEOM, None, None, upto=1)
    *_, args = sp._loop_candidates(matched[:, kf], beams[:, kf],
                                   sched["ox"][:, kf], sched["oy"][:, kf],
                                   cfg, GEOM)
    loop = _lattice_operands(args, cfg, s.loop_n_xy, s.loop_n_yaw)
    return snap_ops, {"pass1": pass1, "loop": loop}


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


def _slam_kernels_alone(frames, cfg, smi: str, busy: dict) -> dict:
    """The lattice kernel and the snapshot entry alone on this SLAM
    workload's operands (_slam_operands): time against the plain version,
    error, bound.  ms is the card's time per launch: queued launches for
    the lattice kernel, and for the snapshot entry its device time per
    launch in `busy`, the profiled replay (_profiled_busy); call_ms is a
    CUDA-event span around one call, host work included.  Returns their
    entries of the kernels line (without launches)."""
    snap_ops, lattice = _slam_operands(frames, cfg)
    out = {}
    for stage, (slabs, ry, rxi, n_yaw) in lattice.items():
        ms = _time_queued(lambda: ml.match_lattice(slabs, ry, rxi, n_yaw))
        call_ms = _time_call(lambda: ml.match_lattice(slabs, ry, rxi, n_yaw),
                             5)
        plain_ms = _time_call(
            lambda: ml.match_lattice_plain(slabs, ry, rxi, n_yaw), 1)
        err = float((ml.match_lattice(slabs, ry, rxi, n_yaw)
                     - ml.match_lattice_plain(slabs, ry, rxi, n_yaw))
                    .abs().max())
        check(err == 0, f"match_lattice vs plain max abs err {err}")
        bound = _lattice_bound(slabs, ry, rxi, n_yaw)
        say("kernel_alone", kernel="match_lattice", stage=stage,
            N=slabs.shape[0], slab=list(slabs.shape[1:]), ms=ms,
            call_ms=call_ms, plain_ms=plain_ms, max_abs_err=err, **bound, card=smi)
        if stage == "pass1":
            out["match_lattice"] = {"max_abs_err": err, "ms": ms,
                                    "plain_ms": plain_ms, **bound}
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
    sectors, cells = _exact_touched(sched, snaps.shape[2:])
    nbytes = (sched.numel() * sched.element_size() + 2 * 32 * sectors
              + snaps.numel())
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = cells * EXACT_CELL_OPS[1] / INT32_OPS_PER_S
    bound = {"bound_ms": max(t_bytes, t_ops) * 1e3,
             "bound_by": "bytes" if t_bytes >= t_ops else "operations",
             "bound_bytes": nbytes, "bound_ops": cells * EXACT_CELL_OPS[1]}
    say("kernel_alone", kernel="replay_exact_snap", stage="pass1",
        B=sched.shape[0], slots=sched.shape[1], ms=ms,
        ms_profiled_launches=profiled, call_ms=call_ms,
        plain_ms=plain_ms,
        max_abs_err=err, grid_sectors=sectors, cells=cells, **bound,
        card=smi)
    out["replay_exact_snap"] = {"max_abs_err": err, "ms": ms,
                                "plain_ms": plain_ms, **bound}
    return out


# the SLAM stages' functions, timed by _stage_seconds
STAGES = {"pass0": sp._odo_and_schedule, "pass1": sp._map_pass_nofb,
          "loop": sp._loop_stage, "gn": sp._build_and_solve,
          "pass3": rx.map_chunk_sched}


def _stage_seconds(frames, cfg, reps: int = 3) -> dict:
    """Seconds per SLAM stage in one slam_replay, each summed over its
    calls, and the rest ("other": the glue between the stages), from the
    fastest of `reps` replays.  Python's sys.monitoring reports each call
    of a STAGES function and its return, and the card is synchronised at
    both, so a stage's device work counts in it; the pipeline carries no
    timing hook."""
    mon = sys.monitoring
    tool = mon.PROFILER_ID
    names = {fn.__code__: name for name, fn in STAGES.items()}
    started, secs = {}, {}

    def on_start(code, _offset):
        torch.cuda.synchronize()
        started[code] = time.perf_counter()

    def on_return(code, _offset, _value):
        torch.cuda.synchronize()
        dt = time.perf_counter() - started.pop(code)
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
    times = []
    for i in range(reps + 1):
        t0 = time.perf_counter()
        res = sp.slam_replay(frames, cfg)
        torch.cuda.synchronize()
        if i:
            times.append(time.perf_counter() - t0)
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
                          ("replay_exact", "match_lattice"))
    say("bench", metric=METRIC[tag], value=B * T / dt, unit="frames/s",
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
    times = []
    for i in range(reps + 1):
        t0 = time.perf_counter()
        _, track = fu.replay_fusion_batched(frames, UL_PROFILE)
        torch.cuda.synchronize()
        if i:
            times.append(time.perf_counter() - t0)
    ck = checksum(track["x"].to(torch.int32))
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
        checksum=ck, checksum_ref=CHECKSUM_REF["ekf"],
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
    front beam 7 cm from the pose); the short-beam flights' 3 frames."""
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
    cases["short_beams"] = (
        torch.zeros((2, GEOM.prows, GEOM.pcols), dtype=torch.int8,
                    device=device),
        [[sb[:, t], f["x_m"][:, t], f["y_m"][:, t], f["yaw_deg"][:, t], zt,
          zt, torch.ones(2, dtype=torch.bool, device=device)]
         for t in range(sb.shape[1])])
    return cases


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


def _run_swarm_keeping_map_steps(world, st0):
    """_run_swarm with the simulator's map_step wrapped to keep each scan
    tick's operands (the launches still count): (fin, diag, [(grids
    before, [beams .. enabled])])."""
    ticks = []
    real = sim.map_step

    def keep(grids, *args):
        ticks.append((grids.clone(), [a.clone() for a in args[:7]]))
        return real(grids, *args)

    sim.map_step = keep
    try:
        return (*_run_swarm(world, st0), ticks)
    finally:
        sim.map_step = real


def _map_step_alone(ticks) -> dict:
    """The map-step kernel on the bench run's own scan ticks against its
    plain version (max abs error, plain ms per tick by CUDA events) and
    its bound per launch: the words read once, each touched 32-byte grid
    sector read and written once, and EXACT_CELL_OPS int32 operations per
    ray cell, averaged over the ticks."""
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
        sectors, cells = _exact_touched(words[:, None])
        b = words.numel() * words.element_size() + 2 * 32 * sectors
        o = cells * EXACT_CELL_OPS[1]
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
    start; best of `reps` after a warm-up.  The checksum and every quad's
    grid sum must equal the port's committed CPU run (swarm_bench_ref);
    the TPU record drew its noise from jax.random, another generator.
    Returns the map-step kernel's entry of the kernels line."""
    world, st0, _ = testdata.swarm_bench(device=device)
    B, T = testdata.SWARM_B, testdata.SWARM_T
    torch.cuda.synchronize()
    reset_launches()                      # count this path's runs only
    # the warm-up run also keeps the scan ticks' operands for the kernel's
    # own check, time and bound (_map_step_alone)
    fin, diag, ticks = _run_swarm_keeping_map_steps(world, st0)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fin, diag = _run_swarm(world, st0)
        times.append(time.perf_counter() - t0)
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
    check(ck == int(ref["checksum"]), f"swarm checksum {ck}")
    check(int((fin.mapper.grid != 0).sum()) > 100 * B, "the swarm mapped "
                                                        "nothing")
    dt = min(times)
    busy = _profiled_busy(lambda: _run_swarm(world, st0), ("map_step",))
    key = next(k for k in busy["kernel_device_ms"] if "map_step" in k)
    profiled = busy["kernel_launches"][key]
    ms = busy["kernel_device_ms"][key] / profiled
    states = np.bincount(diag["state"][-1].cpu().numpy(), minlength=10)
    say("bench", metric=METRIC["swarm"], value=B * T / dt,
        unit="quad-ticks/s", checksum=ck,
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
