"""On-card smoke check of the PyTorch port (micro_quad_slam_tpu_torch).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

It drives the port's two replay paths, the batched bit-exact mapping
replay (kernel="residentx") and the hybrid production replay
(kernel="hybridx"), and builds and checks their hand-written CUDA kernels
(csrc/replay_exact.cu, csrc/replay_cone.cu).  Each phase prints one line
and raises on failure; nothing falls back to the CPU.  Phases:

  1. the card (nvidia-smi name and power limit) and the torch/CUDA versions;
  2. the sm_90a build of both kernels from the checkout's sources, one
     nvcc per source started together, with their seconds;
  3. exact kernel == plain torch on the card, bit for bit (grid, origins,
     used, kf_flags, filt), on random flights with recenters, a saturating
     endpoint, a recenter inside a run of gated frames and short beams;
     then the same for the cone kernel in both modes (conex == cone,
     hybridx == hybrid), and hybridx == the JAX package's hybrid grids
     of the random flights;
  4. exact kernel == the golden C model on a hover, a recentering flight
     and very short beams;
  5. resume: a residentx and a hybridx replay split at T/2 equal the
     unbroken ones;
  6. the bench workload (bench.py's flight, B=1024 x T=256) on each path:
     end-to-end frames/s of the kernel path and of the plain torch path,
     the grid checksum, the schedule's own seconds, the device's busy
     time in one profiled replay (torch.profiler) and its idle share of
     the best end-to-end time, and each kernel's own time against its
     plain version and its bound.  The hybridx grids' per-flight sums
     (plain and position-weighted) must equal the JAX package's hybrid
     replay's.

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
from micro_quad_slam_tpu_torch.ops import residentx as rx

UL_PROFILE = port.UL_PROFILE
GEOM = port.DEFAULT_GEOM

# the JAX package's bench lines on the TPU (BENCH_r05): checksum anchors
CHECKSUM_REF = {"residentx": -239317572, "hybridx": -401735680}
METRIC = {"residentx": "fused_sensor_frames_per_sec_per_chip",
          "hybridx": "fused_sensor_frames_per_sec_per_chip_hybridx"}
PLAIN = {"residentx": "xla", "hybridx": "hybrid"}
KERNELS = {
    "replay_exact": {
        "source": "micro_quad_slam_tpu_torch/csrc/replay_exact.cu",
        "replaces": "micro_quad_slam_tpu/ops/pallas_residentx.py:667"},
    "replay_cone": {
        "source": "micro_quad_slam_tpu_torch/csrc/replay_cone.cu",
        # _hybridx_kernel; it also replaces _conex_kernel (:1439) and
        # pallas_resident.py:440 _resident_cone_kernel
        "replaces": "micro_quad_slam_tpu/ops/pallas_residentx.py:1447"},
}
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
    rx.replay_exact.launches = 0
    cx.replay_cone.launches = 0


def launches() -> dict:
    return {"replay_exact": rx.replay_exact.launches,
            "replay_cone": cx.replay_cone.launches}


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
    built = _build.build_all(list(KERNELS))
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


def _time_kernel(grids, fn, reps: int) -> float:
    """ms per call of fn(grids) by CUDA events, grids reset to zero
    (outside the timed span) before every call."""
    total = 0.0
    for _ in range(reps):
        grids.zero_()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn(grids)
        e1.record()
        torch.cuda.synchronize()
        total += e0.elapsed_time(e1)
    return total / reps


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
    """One end-to-end replay under torch.profiler (host and device): the
    summed device time of every kernel, copy and fill it ran and their
    count, the device time of the port's own CUDA kernel (by name), the
    wall time of the profiled run, and the five host ops with the most
    self time.  busy_ms is None when the profiler saw no device
    activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        port.replay_mapping_batched(frames, UL_PROFILE, kernel=kernel)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    dev_us = lambda e: (getattr(e, "self_device_time_total", None)  # noqa: E731
                        or getattr(e, "self_cuda_time_total", 0))
    on_dev = [e for e in events if e.device_type == DeviceType.CUDA]
    us = sum(dev_us(e) for e in on_dev)
    host = sorted((e for e in events if e.device_type == DeviceType.CPU),
                  key=lambda e: e.self_cpu_time_total, reverse=True)
    return {"busy_ms": us / 1e3 if us > 0 else None,
            "device_ops": sum(e.count for e in on_dev),
            "kernel_device_ms": sum(dev_us(e) for e in on_dev
                                    if "replay_" in e.key) / 1e3,
            "host_top": [[e.key, e.self_cpu_time_total / 1e3, e.count]
                         for e in host[:5]],
            "profiled_wall_s": wall}


# ---------------------------------------------------------------- bounds

def _recentering_quads(sched) -> torch.Tensor:
    """bool [B]: quads with a recenter, whose whole grid is read and
    written."""
    return sched[..., rx.H_DO].any(dim=1)


def _exact_touched(sched) -> tuple:
    """(distinct 32-byte grid sectors, cells) the exact kernel reads and
    writes for this schedule: the cells of every valid ray, and the whole
    grid of a quad that recenters."""
    B, T, _ = sched.shape
    dev = sched.device
    n_sec = GEOM.prows * GEOM.pcols // 32
    mark = torch.zeros((B, n_sec), dtype=torch.bool, device=dev)
    mark[_recentering_quads(sched)] = True
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
        host_top=busy["host_top"],
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
    return {"name": name, "route": "cuda", **KERNELS[name],
            "launches": n_launch[name], "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound["bound_ms"],
            "bound_by": bound["bound_by"], "library_ms": None}


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
    phase_golden(device)
    phase_resume(device)
    kernels = [phase_bench(device, smi, "residentx"),
               phase_bench(device, smi, "hybridx", plain_reps=1)]
    loaded = _jax_package_loaded()
    check(not loaded, f"the port imported jax or the JAX package: {loaded}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
