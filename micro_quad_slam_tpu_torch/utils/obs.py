"""Observability: the reference's logging subsystems re-expressed for the
batched replay world (SURVEY.md §2E / §5.5).

  E1 navlog.csv        -> formats/navlog.py writer + replay glue here
  E2 scanlog.bin       -> formats/scanlog.py writer + sim glue here
  E3 keyframe flags    -> carried in replay/sim outputs
  E4 console status    -> format_status_line (the reference's 2 Hz
                          mega-line, uav_local_nav.c:1885-1975)
  E5 printf tee        -> TeeLogger (clean:451-475)
  E6 snapshot ring     -> SnapshotRing with dump-on-failure
                          (clean:288-323, 2186-2336)
  E7 flight_data.csv   -> FlightDataWriter (clean:141-146, 2645-2659)

Plus the rebuild-native additions: per-run metrics counters and a
profiler trace context.

The port's copy of micro_quad_slam_tpu/utils/obs.py (numpy only), with
profile_trace on torch.profiler instead of jax.profiler;
tests/test_torch_obs.py holds every function's output equal to the
original's.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from collections import deque
from typing import Optional, TextIO

import numpy as np

STATE_NAMES_UL = (
    "WAIT_LINK", "IDLE", "ARMING", "TAKEOFF", "LIFTOFF_ASSIST",
    "HOVER", "EXPLORE", "TURNING", "LANDING", "DISARMING",
)
STATE_NAMES_CL = (
    "WAIT_LINK", "IDLE", "ARMING", "TAKEOFF", "LIFTOFF_ASSIST",
    "HOVER", "LANDING", "DISARMING",
)
ALT_SRC_NAMES = ("?", "LPOS", "RF", "GND")


def _f(v, fmt="%.2f", none="?"):
    try:
        if v is None or (isinstance(v, float) and np.isnan(v)):
            return none
        return fmt % v
    except TypeError:
        return none


def format_status_line(
    state: int, want_arm: bool, have_hb: bool, mode: int, armed: bool,
    alt_m: float, alt_src: int, ceiling: bool, landed: Optional[int],
    z_ok, xy_ok, gyr_ok, mot_ok, xy_stable: bool, lpos_alt: float,
    rf_m: float, yaw_deg: float, yaw_target: Optional[float],
    tof_frbl, of_q: Optional[int], batt_v: float, batt_cells: int,
    mot_avg: Optional[float], map_inited: bool,
    names=STATE_NAMES_UL,
) -> str:
    """The reference's status mega-line (uav_local_nav.c:1885-1975)."""
    parts = [
        f"st={names[state] if 0 <= state < len(names) else '?'}",
        f"want={int(want_arm)} HB={int(have_hb)} mode={mode} armed={int(armed)}",
        f"alt={_f(alt_m)}({ALT_SRC_NAMES[alt_src] if 0 <= alt_src < 4 else '?'})",
        f"CEIL={int(ceiling)}",
        f"landed={'?' if landed is None else landed}",
        ("sys=?" if z_ok is None else
         f"sys=Z={int(z_ok)} XY={int(xy_ok)} GYR={int(gyr_ok)} MOT={int(mot_ok)}"),
        f"xyOK={int(xy_stable)}",
        f"lpos={_f(lpos_alt)}",
        f"rf={_f(rf_m)}",
        f"yaw={_f(yaw_deg, '%.1f')}" + (
            f"->{yaw_target:.1f}" if yaw_target is not None else ""),
        "tof(F/R/B/L)=" + "/".join(_f(v, none="nan") for v in tof_frbl),
        f"of={'?' if of_q is None else 'q=%d' % of_q}",
    ]
    if batt_v is not None and not np.isnan(batt_v) and batt_cells:
        parts.append(f"V={batt_v:.2f} ({batt_cells}c) "
                     f"Vpc={batt_v / batt_cells:.2f}")
    if mot_avg is not None:
        parts.append(f"mot_avg={mot_avg:.1f}")
    parts.append("map=ON(500x500@0.10m)" if map_inited else "map=OFF")
    return " ".join(parts)


class TeeLogger:
    """printf tee: every line goes to the console AND a timestamped
    log.txt (clean_uav_fc_tof_nav.c:451-475)."""

    def __init__(self, path: str, console: Optional[TextIO] = None,
                 t0: Optional[float] = None):
        self._f = open(path, "a")
        self._console = console
        self._t0 = time.monotonic() if t0 is None else t0

    def log(self, msg: str) -> None:
        stamp = time.monotonic() - self._t0
        line = f"[{stamp:.3f}] {msg}"
        self._f.write(line + "\n")
        if self._console is not None:
            self._console.write(msg + "\n")

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        self._f.close()


@dataclasses.dataclass
class Snapshot:
    """One black-box record (snapshot_t, clean:291-317)."""

    t_ms: int = 0
    state: int = 0
    mode: int = 0
    armed: bool = False
    landed: int = 255
    roll: float = np.nan
    pitch: float = np.nan
    yaw: float = np.nan
    x: float = np.nan
    y: float = np.nan
    z: float = np.nan
    vx: float = np.nan
    vy: float = np.nan
    vz: float = np.nan
    alt_est: float = np.nan
    alt_src: int = 0
    rf_m: float = np.nan
    of_q: int = 0
    of_rx: float = np.nan
    of_ry: float = np.nan
    xy_ok: bool = False
    z_ok: bool = False
    gyr_ok: bool = False
    mot_ok: bool = False
    batt_v: float = np.nan
    batt_c: int = 0
    batt_vpc: float = np.nan
    mot: tuple = (0, 0, 0, 0)
    rc: tuple = (0, 0, 0, 0)
    rssi: int = 0

    def line(self, names=STATE_NAMES_CL) -> str:
        nm = names[self.state] if 0 <= self.state < len(names) else "?"
        return (f"[{self.t_ms}] {nm} m={self.mode} a={int(self.armed)} "
                f"alt={_f(self.alt_est)} xyz=({_f(self.x)},{_f(self.y)},"
                f"{_f(self.z)}) rf={_f(self.rf_m)} q={self.of_q} "
                f"vpc={_f(self.batt_vpc)} mot={self.mot}")


class SnapshotRing:
    """32-deep black box, dumped in full on failure transitions
    (clean:288-323, 2022-2028, 2350-2357)."""

    def __init__(self, depth: int = 32, sink=None):
        self._ring = deque(maxlen=depth)
        self._sink = sink or (lambda s: None)

    def add(self, snap: Snapshot) -> None:
        self._ring.append(snap)

    def dump(self, reason: str = "") -> list:
        out = list(self._ring)
        self._sink(f"--- snapshot ring dump ({reason}): "
                   f"{len(out)} records ---")
        for s in out:
            self._sink(s.line())
        return out


class FlightDataWriter:
    """flight_data.csv: per-tick vibration/clipping, motor PWM, ESC RPM
    (clean:141-146, 2645-2659)."""

    HEADER = ("t_ms,state,alt_m,roll_deg,pitch_deg,yaw_deg,"
              "m1,m2,m3,m4,vib_x,vib_y,vib_z,rpm1,rpm2,rpm3,rpm4")

    def __init__(self, path: str, flush_every: int = 50):
        self._f = open(path, "w")
        self._f.write(self.HEADER + "\n")
        self._n = 0
        self._flush_every = flush_every

    def write_row(self, t_ms, state_name, alt_m, roll_deg, pitch_deg,
                  yaw_deg, motors, vib, rpm) -> None:
        self._f.write(
            f"{int(t_ms)},{state_name},{alt_m:.2f},{roll_deg:.2f},"
            f"{pitch_deg:.2f},{yaw_deg:.2f},"
            + ",".join(str(int(m)) for m in motors) + ","
            + ",".join(f"{v:.2f}" for v in vib) + ","
            + ",".join(str(int(r)) for r in rpm) + "\n")
        self._n += 1
        if self._n % self._flush_every == 0:
            self._f.flush()

    def close(self) -> None:
        self._f.close()


class MetricsCounter:
    """Per-run throughput metrics (the rebuild's frames/sec counters)."""

    def __init__(self):
        self.t0 = time.perf_counter()
        self.frames = 0
        self.cells = 0

    def add(self, frames: int, cells_per_frame: int = 1280):
        self.frames += frames
        self.cells += frames * cells_per_frame

    def summary(self) -> dict:
        dt = max(time.perf_counter() - self.t0, 1e-9)
        return {
            "frames": self.frames,
            "wall_s": round(dt, 3),
            "frames_per_sec": round(self.frames / dt, 1),
            "cell_ops_per_sec": round(self.cells / dt, 1),
        }


@contextlib.contextmanager
def profile_trace(logdir: Optional[str]):
    """torch.profiler trace context (no-op when logdir is None): the host
    and, where a CUDA device is present, the device activity of the block,
    written as a Chrome trace to logdir/trace.json on exit."""
    if logdir is None:
        yield
        return
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def map_divergence(grid_a, grid_b, occ_thresh: int = 10,
                   free_thresh: int = -10) -> dict:
    """Quantify how two log-odds maps of the same flight differ — used to
    put a measured fidelity cost on the cone production path vs the
    bit-exact reference-semantics path (ops/conemode.py is bit-exact vs
    the XLA cone mode, NOT vs the reference's 32-ray update).

    Returns occupied/free-cell IoU (same >10 / <-10 classification the
    reference's frontier scorer uses, uav_local_nav.c:366-381), the
    signed per-cell difference histogram over cells either map touched,
    and summary stats."""
    import numpy as np

    a = np.asarray(grid_a, np.int32)
    b = np.asarray(grid_b, np.int32)
    occ_a, occ_b = a > occ_thresh, b > occ_thresh
    free_a, free_b = a < free_thresh, b < free_thresh

    def iou(x, y):
        union = (x | y).sum()
        return float((x & y).sum() / union) if union else 1.0

    def dilate(x):
        out = x.copy()
        out[1:] |= x[:-1]
        out[:-1] |= x[1:]
        out[:, 1:] |= x[:, :-1]
        out[:, :-1] |= x[:, 1:]
        return out

    def iou_tol(x, y):
        """Tolerant IoU: a cell counts as agreeing if the other map has
        the class within 1 cell (walls are 1 cell thick, so pure
        quantization offsets shouldn't read as total disagreement)."""
        union = (x | y).sum()
        if not union:
            return 1.0
        hits = (x & dilate(y)).sum() + (y & dilate(x)).sum()
        return float(min(hits / 2 / union, 1.0))

    touched = (a != 0) | (b != 0)
    diff = (a - b)[touched]
    hist_vals, hist_counts = np.unique(diff, return_counts=True)
    return {
        "iou_occupied": iou(occ_a, occ_b),
        "iou_occupied_tol1": iou_tol(occ_a, occ_b),
        "iou_free": iou(free_a, free_b),
        "touched_cells": int(touched.sum()),
        "equal_cells_frac": float((diff == 0).mean()) if diff.size else 1.0,
        "diff_hist": {int(v): int(c) for v, c in
                      zip(hist_vals, hist_counts)},
        "mean_abs_diff": float(np.abs(diff).mean()) if diff.size else 0.0,
    }


def map_iou_vs_walls(grid, origin_x: float, origin_y: float, room,
                     obstacles=(), res_m: float = 0.10,
                     occ_thresh: int = 10, tol_cells: int = 1) -> float:
    """Map-fidelity score against the simulator's ground-truth walls:
    IoU between the map's occupied cells (> occ_thresh, the reference's
    frontier classification) and the true wall cells of the synthetic
    room/obstacle rectangles, with a tol_cells dilation on each side so
    pure half-cell quantization offsets don't read as disagreement.

    grid: logical [H, W] int8 ([y, x]); origin at the grid center
    (uav_local_nav.c:205-214)."""
    import numpy as np

    g = np.asarray(grid)
    h, w = g.shape
    xs = origin_x + (np.arange(w) - w // 2) * res_m
    ys = origin_y + (np.arange(h) - h // 2) * res_m
    X, Y = np.meshgrid(xs, ys)

    def seg_dist(px, py, ax, ay, bx, by):
        abx, aby = bx - ax, by - ay
        ln2 = abx * abx + aby * aby
        t = np.clip(((px - ax) * abx + (py - ay) * aby)
                    / (ln2 if ln2 else 1.0), 0.0, 1.0)
        return np.hypot(px - (ax + t * abx), py - (ay + t * aby))

    def rect_segs(x0, y0, x1, y1):
        return [(x0, y0, x1, y0), (x1, y0, x1, y1),
                (x1, y1, x0, y1), (x0, y1, x0, y0)]

    segs = rect_segs(*room)
    for ob in obstacles:
        segs += rect_segs(*ob)
    dmin = np.full_like(X, np.inf)
    for sgm in segs:
        dmin = np.minimum(dmin, seg_dist(X, Y, *sgm))
    truth = dmin <= res_m * 0.5 + 1e-6

    pred = g > occ_thresh

    def dilate(x, n):
        out = x.copy()
        for _ in range(n):
            nx = out.copy()
            nx[1:] |= out[:-1]
            nx[:-1] |= out[1:]
            nx[:, 1:] |= out[:, :-1]
            nx[:, :-1] |= out[:, 1:]
            out = nx
        return out

    union = (pred | truth).sum()
    if not union:
        return 1.0
    hits = ((pred & dilate(truth, tol_cells)).sum()
            + (truth & dilate(pred, tol_cells)).sum())
    return float(min(hits / 2 / union, 1.0))


def save_map_pgm(path: str, grid, occ_thresh: int = 10,
                 free_thresh: int = -10, trinary: bool = True) -> str:
    """Write a log-odds occupancy grid as a binary PGM (P5) image.

    The reference's deliverable is the post-flight 2D map rebuilt from
    scanlog.bin (uav_local_nav.c:94, "offline mapping"); this renders it
    in the de-facto occupancy-map image convention (ROS map_saver):
    occupied -> 0 (black), free -> 254 (white), unknown -> 205 (gray),
    using the reference frontier scorer's own cell classification
    thresholds (uav_local_nav.c:366-381).  trinary=False instead maps
    the raw clamped log-odds value linearly (127 - v) so cell evidence
    strength survives into the image.

    Rows are written north-up (grid row 0 at the bottom of the image)
    so +x is right and +y is up, matching the world frame.  Pure
    stdlib + numpy — no image dependencies.
    """
    g = np.asarray(grid)
    if g.ndim != 2:
        raise ValueError(f"expected a 2-D grid, got shape {g.shape}")
    v = g.astype(np.int16)
    if trinary:
        img = np.full(v.shape, 205, np.uint8)
        img[v > occ_thresh] = 0
        img[v < free_thresh] = 254
    else:
        img = np.clip(127 - v, 0, 255).astype(np.uint8)
    img = img[::-1]  # row 0 (south) at the bottom of the image
    with open(path, "wb") as f:
        f.write(b"P5\n# micro-quad-slam occupancy map\n")
        f.write(f"{img.shape[1]} {img.shape[0]}\n255\n".encode())
        f.write(img.tobytes())
    return path
