"""The port's bench entry: bench.py's six JSON lines, measured on the port.

    python -m micro_quad_slam_tpu_torch.bench [--device cuda|cpu]
    python -m micro_quad_slam_tpu_torch bench [replay|slam|ekf|swarm]

It follows the repository's bench.py (the JAX package's) line for line:
the same workloads, knobs and defaults, and each line's `metric`,
`value`, `unit`, `vs_baseline` and `checksum` under the same names and
rules (bench.py:72-79, 106-113, 145-151, 245-256).  Each line adds
`device` (the card's name, or "cpu") and `rep_seconds`, every timed rep's
seconds, so that a bound can be set from their spread.

By default (MQS_BENCH_MODE=replay) it prints, in bench.py's order:
`residentx` and `hybridx` at B=1024 x T=256, `slam` (UL_PROFILE, B=128),
`slam_rt` (UL_RT_PROFILE, B=256), `ekf` (B=1024) and `swarm` (B=1024
quads x T=1,000 ticks at dt_ms=1).  Knobs, with bench.py's defaults:
MQS_BENCH_MODE=replay|slam|ekf|swarm, MQS_BENCH_B, MQS_BENCH_T,
MQS_BENCH_REPS, MQS_BENCH_KERNEL (one replay line for that kernel),
MQS_BENCH_FULL=0 (the two replay lines only), MQS_BENCH_SLAM_B,
MQS_BENCH_SLAM_RT_B, MQS_BENCH_EKF_B, MQS_BENCH_SWARM_B,
MQS_BENCH_SWARM_T.

Workloads: testdata.bench_frames, testdata.slam_bench_frames and
testdata.swarm_bench (the committed flights at T=256; at another T the
port's own synthio builds the same flights as bench.py does).  Each
workload runs once as a warm-up, then `reps` timed runs, each ending in
torch.cuda.synchronize() on the card; the value is the best rep.  The
same functions time the bench phases of chip_smoke.py.

Checksums on the card: residentx -239317596 (the JAX package off the
TPU), hybridx -401735680, slam -28317856, slam_rt -56410560, ekf 1024,
swarm -8942389 (the port's own generator; not jax.random's).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

from micro_quad_slam_tpu_torch import testdata
from micro_quad_slam_tpu_torch.replay.mapping import (
    KERNELS, frames_to_torch, replay_mapping_batched)
from micro_quad_slam_tpu_torch.utils.device import as_device

REF_FPS = 10.0            # the reference pipeline's fused-frame rate
SWARM_NORTH_STAR = 1.024e6   # 1024 quads at 1 kHz


def _env(name: str, default: int) -> int:
    return int(os.environ.get(name, str(default)))


def device_name(device: torch.device) -> str:
    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else device.type)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def int32_checksum(x: torch.Tensor) -> int:
    """The int32 (wrapping) sum of x cast to int32, as bench.py's
    sync_scalar computes it."""
    s = int(x.to(torch.int32).to(torch.int64).sum())
    return (s + 2 ** 31) % 2 ** 32 - 2 ** 31


def time_runs(run, reps: int, device: torch.device):
    """run() once as a warm-up, then `reps` times, each ending in a
    synchronize: (seconds of each timed rep, the last result)."""
    out = run()
    _sync(device)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = run()
        _sync(device)
        times.append(time.perf_counter() - t0)
    return times, out


# ---------------------------------------------------------------- lines

def bench_replay(kernel: str, B: int = 1024, T: int = 256, reps: int = 3,
                 device=None, first: bool = True, frames=None):
    """One replay line (bench.py:238-256): the whole batched replay
    through `kernel`.  Returns (line, (state, outs))."""
    from micro_quad_slam_tpu_torch.utils.config import UL_PROFILE

    device = as_device(device)
    if frames is None:
        frames = frames_to_torch(testdata.bench_frames(B, T), device)
    times, (state, outs) = time_runs(
        lambda: replay_mapping_batched(frames, UL_PROFILE, kernel=kernel),
        reps, device)
    fps = B * T / min(times)
    line = {
        "metric": ("fused_sensor_frames_per_sec_per_chip" if first
                   else f"fused_sensor_frames_per_sec_per_chip_{kernel}"),
        "value": round(fps, 1),
        "unit": "frames/s",
        "vs_baseline": round(fps / REF_FPS, 1),
        "kernel": kernel,
        "exact": KERNELS[kernel].mode == "exact",
        "checksum": int32_checksum(state.grid),
        "device": device_name(device),
        "rep_seconds": times,
    }
    return line, (state, outs)


def bench_slam(profile: str = "acc", B: int = 128, T: int = 256,
               reps: int = 2, device=None, frames=None):
    """The SLAM line (bench.py:84-115): "acc" is UL_PROFILE, "rt"
    UL_RT_PROFILE.  Returns (line, SlamResult)."""
    from micro_quad_slam_tpu_torch.slam.pipeline import slam_replay
    from micro_quad_slam_tpu_torch.utils.config import (UL_PROFILE,
                                                        UL_RT_PROFILE)

    device = as_device(device)
    cfg = UL_RT_PROFILE if profile == "rt" else UL_PROFILE
    if frames is None:
        frames = testdata.slam_bench_frames(B, T, device=device)
    times, res = time_runs(lambda: slam_replay(frames, cfg), reps, device)
    fps = B * T / min(times)
    line = {
        "metric": ("slam_frames_per_sec_per_chip" if profile == "acc"
                   else "slam_rt_frames_per_sec_per_chip"),
        "value": round(fps, 1),
        "unit": "frames/s",
        "vs_baseline": round(fps / REF_FPS, 1),
        "checksum": int32_checksum(res.grid),
        "device": device_name(device),
        "rep_seconds": times,
    }
    return line, res


def bench_ekf(B: int = 1024, T: int = 256, reps: int = 2, device=None,
              frames=None):
    """The EKF line (bench.py:118-152): the fusion replay's x track; the
    checksum is the int32 sum of the track cast to int32.  Returns (line,
    track)."""
    from micro_quad_slam_tpu_torch.replay.fusion import replay_fusion_batched
    from micro_quad_slam_tpu_torch.utils.config import UL_PROFILE

    device = as_device(device)
    if frames is None:
        frames = testdata.slam_bench_frames(B, T, device=device)
    times, (_, track) = time_runs(
        lambda: replay_fusion_batched(frames, UL_PROFILE), reps, device)
    fps = B * T / min(times)
    line = {
        "metric": "ekf_frames_per_sec_per_chip",
        "value": round(fps, 1),
        "unit": "frames/s",
        "vs_baseline": round(fps / REF_FPS, 1),
        "checksum": int32_checksum(track["x"]),
        "device": device_name(device),
        "rep_seconds": times,
    }
    return line, track


def bench_swarm(B: int = 1024, T: int = 1000, reps: int = 2, device=None,
                start=None):
    """The swarm line (bench.py:45-81): B quads from the airborne start
    (sim_init seed 0, spread 0.5 m), T ticks at dt_ms=1 with a scan every
    100 ms.  `start` = (world, state) overrides the start.  Returns (line,
    (final state, diag))."""
    from micro_quad_slam_tpu_torch.models.simulator import sim_run
    from micro_quad_slam_tpu_torch.utils.config import UL_PROFILE

    device = as_device(device)
    if start is None:
        world, st0, _ = testdata.swarm_bench(device=device, B=B)
    else:
        world, st0 = start
    times, (fin, diag) = time_runs(
        lambda: sim_run(st0, world, T, UL_PROFILE, **testdata.SWARM_RUN),
        reps, device)
    tps = B * T / min(times)
    line = {
        "metric": "swarm_control_ticks_per_sec_per_chip",
        "value": round(tps, 1),
        "unit": "quad-ticks/s",
        "vs_baseline": round(tps / SWARM_NORTH_STAR, 3),
        "checksum": int32_checksum(fin.mapper.grid),
        "device": device_name(device),
        "rep_seconds": times,
    }
    return line, (fin, diag)


def _emit(line: dict, what: str) -> None:
    print(json.dumps(line), flush=True)
    print(f"# {what} best={min(line['rep_seconds']) * 1e3:.1f} ms "
          f"device={line['device']} checksum={line['checksum']}",
          file=sys.stderr, flush=True)


def run(device) -> None:
    """bench.py's main(): the lines its environment knobs select."""
    mode = os.environ.get("MQS_BENCH_MODE", "replay")
    if mode == "swarm":
        B, T = _env("MQS_BENCH_B", 1024), _env("MQS_BENCH_T", 1000)
        _emit(bench_swarm(B, T, _env("MQS_BENCH_REPS", 2), device)[0],
              f"swarm B={B} T={T}")
        return
    if mode == "slam":
        B, T = _env("MQS_BENCH_B", 128), _env("MQS_BENCH_T", 256)
        _emit(bench_slam("acc", B, T, _env("MQS_BENCH_REPS", 3), device)[0],
              f"slam[acc] B={B} T={T}")
        return
    if mode == "ekf":
        B, T = _env("MQS_BENCH_B", 1024), _env("MQS_BENCH_T", 256)
        _emit(bench_ekf(B, T, _env("MQS_BENCH_REPS", 3), device)[0],
              f"ekf B={B} T={T}")
        return
    if mode != "replay":
        raise ValueError(f"MQS_BENCH_MODE={mode!r}: one of replay, slam, "
                         f"ekf, swarm")
    B, T = _env("MQS_BENCH_B", 1024), _env("MQS_BENCH_T", 256)
    reps = _env("MQS_BENCH_REPS", 3)
    pinned = os.environ.get("MQS_BENCH_KERNEL")
    kernels = [pinned] if pinned else ["residentx", "hybridx"]
    frames = frames_to_torch(testdata.bench_frames(B, T), device)
    for kernel in kernels:
        line, _ = bench_replay(kernel, B, T, reps, device,
                               first=kernel == kernels[0], frames=frames)
        _emit(line, f"kernel={kernel} B={B} T={T} reps={reps}")
    del frames
    if os.environ.get("MQS_BENCH_FULL", "1") != "1" or pinned:
        return
    later = max(reps - 1, 1)
    B = _env("MQS_BENCH_SLAM_B", 128)
    _emit(bench_slam("acc", B, T, later, device)[0], f"slam[acc] B={B}")
    B = _env("MQS_BENCH_SLAM_RT_B", 256)
    _emit(bench_slam("rt", B, T, later, device)[0], f"slam[rt] B={B}")
    B = _env("MQS_BENCH_EKF_B", 1024)
    _emit(bench_ekf(B, T, later, device)[0], f"ekf B={B}")
    B, Ts = _env("MQS_BENCH_SWARM_B", 1024), _env("MQS_BENCH_SWARM_T", 1000)
    _emit(bench_swarm(B, Ts, later, device)[0], f"swarm B={B} T={Ts}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m micro_quad_slam_tpu_torch.bench",
        description="bench.py's lines, measured on the PyTorch port "
                    "(environment knobs as bench.py's)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default: cuda; without a CUDA device "
                        "pass --device cpu)")
    args = p.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("error: no CUDA device found; pass --device cpu to bench the "
              "port's plain torch path on the CPU", file=sys.stderr)
        return 2
    run(device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
