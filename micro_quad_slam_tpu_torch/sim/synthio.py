"""Synthetic scanlog generation: a rectangular-room world with exact
ray-traced ToF returns, used by tests and benchmarks.

The reference has no simulator; flights were validated empirically
(README.md:4).  This module provides the ground-truth-world half of the
rebuild's test strategy (SURVEY.md §4 item 6): generate sensor streams whose
true geometry is known, so the mapping/SLAM pipelines can be validated
against ground truth instead of only against each other.

The full closed-loop swarm simulator lives in models/simulator.py; this file
is the lightweight host-side generator of reference-format logs.

The port's copy of micro_quad_slam_tpu/sim/synthio.py: the same numpy operations in
the same order on numpy's seeded generator, so the same arguments give the
JAX package's log byte for byte (tests/test_torch_synthio.py).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np

from micro_quad_slam_tpu_torch.formats.scanlog import ScanLog
from micro_quad_slam_tpu_torch.utils.config import TofConfig

ST_HOVER = 5  # the hover state byte (uav_local_nav.c:484-496)


def room_tof_distance(
    x: float, y: float, ang_rad: float,
    room: Tuple[float, float, float, float],
    obstacles: Sequence[Tuple[float, float, float, float]] = (),
) -> float:
    """Exact distance from (x, y) along ang to the nearest wall of an
    axis-aligned room (xmin, ymin, xmax, ymax), considering axis-aligned
    rectangular obstacles (each also (xmin, ymin, xmax, ymax))."""
    cx, sy_ = math.cos(ang_rad), math.sin(ang_rad)
    best = math.inf

    def ray_box_exit(bx0, by0, bx1, by1):
        """Distance to exit the box from inside (room walls)."""
        ts = []
        if cx > 1e-12:
            ts.append((bx1 - x) / cx)
        elif cx < -1e-12:
            ts.append((bx0 - x) / cx)
        if sy_ > 1e-12:
            ts.append((by1 - y) / sy_)
        elif sy_ < -1e-12:
            ts.append((by0 - y) / sy_)
        return min(t for t in ts if t > 0) if ts else math.inf

    def ray_box_enter(bx0, by0, bx1, by1):
        """Distance to enter the box from outside (obstacles); inf if missed."""
        tmin, tmax = 0.0, math.inf
        for lo, hi, o, d in ((bx0, bx1, x, cx), (by0, by1, y, sy_)):
            if abs(d) < 1e-12:
                if o < lo or o > hi:
                    return math.inf
            else:
                t0, t1 = (lo - o) / d, (hi - o) / d
                if t0 > t1:
                    t0, t1 = t1, t0
                tmin, tmax = max(tmin, t0), min(tmax, t1)
        return tmin if tmin <= tmax and tmin > 0 else math.inf

    best = ray_box_exit(*room)
    for ob in obstacles:
        best = min(best, ray_box_enter(*ob))
    return best


def synth_room_scanlog(
    n_frames: int = 64,
    room: Tuple[float, float, float, float] = (-4.0, -4.0, 4.0, 4.0),
    obstacles: Sequence[Tuple[float, float, float, float]] = (),
    path: str = "circle",
    path_radius_m: float = 1.0,
    yaw_rate_dps: float = 5.0,
    seed: int = 0,
    noise_mm: float = 0.0,
    dropout_p: float = 0.0,
    dt_ms: int = 100,
    tof: TofConfig = TofConfig(),
    state: int = ST_HOVER,
    with_flow: bool = False,
    rng: Optional[np.random.Generator] = None,
) -> ScanLog:
    """Generate a reference-format ScanLog of a flight inside a room.

    Each of the 4 directions' 8 columns gets the exact wall distance along
    its fan angle (the 2D world makes all 8 rows of a column identical up to
    injected noise/dropout — dropout exercises the second-min beam logic).
    Frame layout matches the hub serializer (tof_esp32.ino:192-216).
    """
    rng = rng or np.random.default_rng(seed)
    T = n_frames
    t_ms = (np.arange(T, dtype=np.uint64) * dt_ms).astype(np.uint32)

    # pose track
    if path == "circle":
        phi = np.linspace(0.0, 2 * math.pi * 0.75, T)
        xs = (path_radius_m * np.cos(phi)).astype(np.float32)
        ys = (path_radius_m * np.sin(phi)).astype(np.float32)
        yaws = ((np.degrees(phi) + 90.0 + 180.0) % 360.0 - 180.0).astype(np.float32)
    elif path == "hover":
        xs = np.zeros(T, np.float32)
        ys = np.zeros(T, np.float32)
        yaws = ((np.arange(T) * yaw_rate_dps * dt_ms * 1e-3 + 180.0) % 360.0
                - 180.0).astype(np.float32)
    elif path == "line":
        xs = np.linspace(0.0, path_radius_m, T).astype(np.float32)
        ys = np.zeros(T, np.float32)
        yaws = np.zeros(T, np.float32)
    elif path == "fig8":
        # lemniscate-like figure-8 with a genuine self-revisit at the
        # crossing (loop-closure test trajectory); yaw follows the
        # path tangent
        phi = np.linspace(0.0, 2 * math.pi, T)
        xs = (path_radius_m * np.sin(phi)).astype(np.float32)
        ys = (0.6 * path_radius_m * np.sin(2 * phi)).astype(np.float32)
        dx = np.gradient(xs.astype(np.float64))
        dy = np.gradient(ys.astype(np.float64))
        yaws = ((np.degrees(np.arctan2(dy, dx)) + 180.0) % 360.0
                - 180.0).astype(np.float32)
    else:
        raise ValueError(f"unknown path {path!r}")

    grid = np.zeros((T, 4, 8, 8), np.uint16)
    half_fov = tof.fov_deg * 0.5
    for t in range(T):
        for d in range(4):
            for c in range(8):
                u = (c - 3.5) / 3.5
                ang_deg = float(yaws[t]) + tof.dir_center_deg[d] + u * half_fov
                dist = room_tof_distance(
                    float(xs[t]), float(ys[t]), math.radians(ang_deg),
                    room, obstacles,
                )
                mm = dist * 1000.0
                for r in range(8):
                    v = mm
                    if noise_mm > 0:
                        v = v + rng.normal(0.0, noise_mm)
                    if dropout_p > 0 and rng.random() < dropout_p:
                        grid[t, d, r, c] = 0xFFFF
                        continue
                    # sensor saturates far returns to no-target (0xFFFF),
                    # like a dead/over-range VL53L5CX zone
                    grid[t, d, r, c] = (
                        0xFFFF if v > 60000 else max(1, int(round(v)))
                    )

    # flow rates consistent with the path: body velocity / height, in the
    # reference's displacement convention (v_body = rate * ground,
    # uav_local_nav.c:1159-1165).  Central-difference world velocity.
    alt = 0.5
    if with_flow:
        dt_s = dt_ms * 1e-3
        vx = np.gradient(xs.astype(np.float64), dt_s)
        vy = np.gradient(ys.astype(np.float64), dt_s)
        yaw_r = np.radians(yaws.astype(np.float64))
        vbx = np.cos(yaw_r) * vx + np.sin(yaw_r) * vy
        vby = -np.sin(yaw_r) * vx + np.cos(yaw_r) * vy
        of_rx = (vbx / alt).astype(np.float32)
        of_ry = (vby / alt).astype(np.float32)
        of_q = np.full(T, 90, np.uint8)
    else:
        of_rx = np.full(T, np.nan, np.float32)
        of_ry = np.full(T, np.nan, np.float32)
        of_q = np.zeros(T, np.uint8)

    return ScanLog(
        host_ms=t_ms.copy(),
        scan_ms=t_ms.copy(),
        x_m=xs,
        y_m=ys,
        yaw_deg=yaws,
        alt_m=np.full(T, alt, np.float32),
        roll_rad=np.zeros(T, np.float32),
        pitch_rad=np.zeros(T, np.float32),
        rf_m=np.full(T, alt, np.float32),
        of_rate_x=of_rx,
        of_rate_y=of_ry,
        of_q=of_q,
        state=np.full(T, state, np.uint8),
        kf_flags=np.zeros(T, np.uint8),
        sys_health=np.zeros(T, np.uint32),
        grid_mm=grid,
    )


def slam_bench_frames(B: int, T: int, device_put: bool = True,
                      device=None) -> dict:
    """bench.py's SLAM and EKF workload: 4 distinct drift-free circle
    flights with flow (6 mm noise), replicated to B with identical
    content, as the union of scanlog_to_arrays and fusion_arrays; numpy
    arrays, or with device_put tensors on `device` (the CUDA device unless
    told otherwise)."""
    from micro_quad_slam_tpu_torch.replay.fusion import fusion_arrays
    from micro_quad_slam_tpu_torch.replay.mapping import (
        frames_to_torch, scanlog_to_arrays)

    logs = [synth_room_scanlog(n_frames=T, seed=s, path="circle",
                               noise_mm=6.0, with_flow=True)
            for s in range(4)]
    fr = [{**scanlog_to_arrays(lg), **fusion_arrays(lg)} for lg in logs]
    nrep = -(-B // 4)
    b = {k: np.concatenate([np.stack([f[k] for f in fr])] * nrep)[:B]
         for k in fr[0]}
    return frames_to_torch(b, device) if device_put else b
