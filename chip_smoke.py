"""On-card smoke check of the PyTorch port (micro_quad_slam_tpu_torch).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

It drives the port's main path, the batched bit-exact mapping replay, and
builds and checks its hand-written CUDA kernel (csrc/replay_exact.cu).
Each phase prints one line and raises on failure; nothing falls back to
the CPU.  Phases:

  1. the card (nvidia-smi name and power limit) and the torch/CUDA versions;
  2. the sm_90a kernel build from the checkout's sources, with its seconds;
  3. kernel == plain torch on the card, bit for bit (grid, origins, used,
     kf_flags, filt), on random flights with recenters, a saturating
     endpoint and a recenter inside a run of gated frames;
  4. kernel == the golden C model on a hover, a recentering flight and
     very short beams (the model's grids are stored with the flights in
     micro_quad_slam_tpu_torch/testdata);
  5. resume: a replay split at T/2 equals the unbroken one;
  6. the bench workload (bench.py's flight, B=1024 x T=256): end-to-end
     frames/s of the kernel path and of the plain torch path, the grid
     checksum, the schedule's own seconds, the device's busy time in one
     profiled replay (torch.profiler) and its idle share of the best
     end-to-end time, and the kernel's own time against its plain version.

It imports the port and numpy only: the inputs and reference results are
committed files of the port.

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
from micro_quad_slam_tpu_torch.ops import residentx as rx

UL_PROFILE = port.UL_PROFILE

CHECKSUM_REF = -239317572   # the JAX package's bench line (kernel=residentx)
KERNEL_SOURCE = "micro_quad_slam_tpu_torch/csrc/replay_exact.cu"
KERNEL_REPLACES = "micro_quad_slam_tpu/ops/pallas_residentx.py:667"


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
    info = _build.build("replay_exact")
    ptxas = [ln.strip() for ln in info["log"].splitlines()
             if "registers" in ln or "spill" in ln]
    say("build", target="sm_90a", flags=" ".join(_build.NVCC_FLAGS),
        seconds=info["seconds"], ptxas=ptxas)


def phase_kernel_vs_plain(device) -> None:
    before = rx.replay_exact.launches
    cases = {"random_recenter": random_flights(),
             "saturating_endpoint": saturating_endpoint(),
             "recenter_in_gated_run": recenter_in_gated_run(),
             "short_beams": short_beams()}
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
    say("kernel_vs_plain", cases=list(cases), bit_equal=True,
        launches=launches)


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
    full = replay(f, device, "residentx")
    head = replay({k: v[:, :T // 2] for k, v in f.items()}, device,
                  "residentx")
    tail = replay({k: v[:, T // 2:] for k, v in f.items()}, device,
                  "residentx", state0=head[0])
    assert_same((tail[0], {}), (full[0], {}), "resume")
    say("resume", split=T // 2, bit_equal=True)


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


def _time_kernel(grids, sched, fn, reps: int) -> float:
    """ms per call of fn(grids, sched) by CUDA events, grids reset to zero
    (outside the timed span) before every call."""
    total = 0.0
    for _ in range(reps):
        grids.zero_()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn(grids, sched, UL_PROFILE)
        e1.record()
        torch.cuda.synchronize()
        total += e0.elapsed_time(e1)
    return total / reps


def _time_schedule(frames, reps: int) -> list:
    """Seconds of the schedule alone (the host-driven carry over T and the
    ray words), after one warm-up."""
    times = []
    for _ in range(reps + 1):
        t0 = time.perf_counter()
        rx.schedule(frames, UL_PROFILE)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return times[1:]


def _device_busy(frames) -> dict:
    """One end-to-end residentx replay under torch.profiler: the summed
    device time of every kernel, copy and fill it ran, their count, and
    the wall time of the profiled run.  busy_ms is None when the profiler
    saw no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        port.replay_mapping_batched(frames, UL_PROFILE, kernel="residentx")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    us = sum(getattr(e, "self_device_time_total", None)
             or getattr(e, "self_cuda_time_total", 0) for e in events)
    return {"busy_ms": us / 1e3 if us > 0 else None,
            "device_ops": sum(e.count for e in events),
            "profiled_wall_s": wall}


def phase_bench(device, smi: str, B: int = 1024, T: int = 256,
                reps: int = 3) -> dict:
    frames = port.frames_to_torch(testdata.bench_frames(B), device)
    check(frames["x_m"].shape == (B, T), "bench frames")
    torch.cuda.synchronize()

    rx.replay_exact.launches = 0          # count the main path's run only
    times_k, st_k, outs_k = _time_replay(frames, "residentx", reps)
    launches = rx.replay_exact.launches
    metrics = port.batch_metrics(outs_k)
    sched_s = _time_schedule(frames, reps)
    busy = _device_busy(frames)
    times_p, st_p, outs_p = _time_replay(frames, "xla", reps)
    dt_k, dt_p = min(times_k), min(times_p)
    idle = None if busy["busy_ms"] is None else 1 - busy["busy_ms"] / (dt_k * 1e3)

    ck, cp = checksum(st_k.grid), checksum(st_p.grid)
    used, total = int(metrics["frames_used"]), int(metrics["frames_total"])
    check(ck == cp, f"checksum kernel {ck} != plain {cp}")
    assert_same((st_k, outs_k), (st_p, outs_p), "bench")
    check(used == total == B * T, f"frames_used {used}/{total}")
    check(launches >= 1, "the main path never launched the kernel")
    say("bench", metric="fused_sensor_frames_per_sec_per_chip",
        value=B * T / dt_k, unit="frames/s", kernel="residentx",
        checksum=ck, checksum_ref=CHECKSUM_REF,
        checksum_matches_ref=ck == CHECKSUM_REF,
        frames_used=used, frames_total=total,
        recenters=int(metrics["recenters"]),
        plain_value=B * T / dt_p, plain_kernel="xla",
        rep_seconds=times_k, plain_rep_seconds=times_p,
        schedule_seconds=sched_s, device_busy_ms=busy["busy_ms"],
        device_ops=busy["device_ops"],
        profiled_wall_s=busy["profiled_wall_s"], device_idle_share=idle,
        B=B, T=T, reps=reps, card=smi)

    # the kernel alone against its plain version, on the bench schedule
    sched = rx.schedule(frames, UL_PROFILE)[0]
    grids = torch.zeros_like(st_k.grid)
    ms = _time_kernel(grids, sched, rx.replay_exact, 5)
    plain = torch.zeros_like(grids)
    plain_ms = _time_kernel(plain, sched, rx.replay_exact_plain, 1)
    err = int((grids.to(torch.int16) - plain.to(torch.int16)).abs().max())
    check(err == 0, f"kernel vs plain max abs err {err}")
    return {"name": "replay_exact", "route": "cuda", "source": KERNEL_SOURCE,
            "replaces": KERNEL_REPLACES, "launches": launches,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    smi = phase_card()
    phase_build()
    phase_kernel_vs_plain(device)
    phase_golden(device)
    phase_resume(device)
    kernel = phase_bench(device, smi)
    check("jax" not in sys.modules, "the port imported jax")
    print(json.dumps({"kernels": [kernel]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
